"""Host syncs (``torch.cuda.set_sync_debug_mode`` warnings) per public call
of the window."""

from portbench import readers


def read(obs):
    s, n = readers.syncs(obs), readers.calls(obs)
    return None if s is None or not n else s / n
