"""Launches of the stream walk (``ops.stream_decode.launches``, both
forms) per header string of the window."""

from portbench import readers


def read(obs):
    n = obs["requests"]
    walks = readers.launches(obs, "ops.stream_decode.launches.stream_decode",
                             "ops.stream_decode.launches.stream_decode_dev")
    return walks / n if n else None
