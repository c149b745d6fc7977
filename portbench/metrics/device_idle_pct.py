"""The share of the traced stretch in which no kernel, copy or fill ran on
the device, in %."""

from portbench import readers


def read(obs):
    return readers.idle_pct(obs)
