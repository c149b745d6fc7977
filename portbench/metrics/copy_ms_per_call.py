"""Device time of the host-to-device and device-to-host copies in the
traced stretch, per public call made in it, in ms."""


def read(obs):
    tr, n = obs.get("trace"), sum(obs["trace_calls"].values())
    if not tr or not tr.get("device_events") or not n:
        return None
    return tr["copy_s"] / n * 1e3
