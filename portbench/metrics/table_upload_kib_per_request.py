"""Bytes the table set-ups uploaded to the device
(``ops.encode.outcomes.device_table_h2d_bytes``) per request of the window,
in KiB; None where the program keeps no such counter."""

KEY = "ops.encode.outcomes.device_table_h2d_bytes"


def read(obs):
    n = obs["requests"]
    return obs["counters"][KEY] / n / 1024 if KEY in obs["counters"] and n else None
