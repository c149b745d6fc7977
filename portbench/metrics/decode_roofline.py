"""The decode stage's share of its memory roofline over the traced
stretch: stream and index read, plaintext written at 3.35 TB/s, over the
device time inside the decode spans, in %."""

from portbench import readers


def read(obs):
    return readers.stage_roofline(obs, readers.DECODE_SPANS)
