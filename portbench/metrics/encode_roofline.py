"""The encode stage's share of its memory roofline over the traced stretch:
plaintext read, stream written and index written at 3.35 TB/s, over the
device time inside the encode spans, in %."""

from portbench import readers


def read(obs):
    return readers.stage_roofline(obs, readers.ENCODE_SPANS)
