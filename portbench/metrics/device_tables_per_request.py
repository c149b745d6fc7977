"""Tables set up on the device (``ops.encode.outcomes.device_tables``) per
request of the window; None where the program keeps no such counter."""

KEY = "ops.encode.outcomes.device_tables"


def read(obs):
    n = obs["requests"]
    return obs["counters"][KEY] / n if KEY in obs["counters"] and n else None
