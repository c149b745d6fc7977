"""Host time of the table set-ups, from the read of each table's file to
its staged upload (``ops.encode.outcomes.device_table_ns``), per request of
the window, in ms; None where the program keeps no such counter."""

KEY = "ops.encode.outcomes.device_table_ns"


def read(obs):
    n = obs["requests"]
    return obs["counters"][KEY] / n / 1e6 if KEY in obs["counters"] and n else None
