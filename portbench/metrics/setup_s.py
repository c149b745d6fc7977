"""Seconds from the process's start to the window's first call."""


def read(obs):
    return obs["setup_s"]
