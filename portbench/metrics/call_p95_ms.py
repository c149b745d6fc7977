"""The 95th percentile of every public call of the window, in ms."""

from portbench import stats


def read(obs):
    return stats.percentile(obs["call_s"], 95) * 1e3 if obs["call_s"].size else None
