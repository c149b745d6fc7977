"""Plaintext bytes of every request completed in the window, over the
window's seconds, in 10^9 bytes a second."""

from portbench import stats


def read(obs):
    return stats.rate(obs["plain_bytes"], obs["window_s"]) / 1e9
