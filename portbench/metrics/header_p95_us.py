"""The 95th percentile over every header string of the window (its
encode, its decode and the padding check), in us."""

from portbench import stats


def read(obs):
    return stats.percentile(obs["request_s"], 95) * 1e6 if obs["request_s"].size else None
