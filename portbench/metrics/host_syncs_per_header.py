"""Host syncs (``torch.cuda.set_sync_debug_mode`` warnings) per header
string of the window."""

from portbench import readers


def read(obs):
    s, n = readers.syncs(obs), obs["requests"]
    return None if s is None or not n else s / n
