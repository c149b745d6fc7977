"""Launches of the self-sync kernel, all forms, per decode call of the
window (``ops.selfsync.launches``)."""

from portbench import readers


def read(obs):
    n = readers.calls(obs, readers.DECODE_SPANS)
    return readers.launches(obs, "ops.selfsync.launches.selfsync_decode") / n if n else None
