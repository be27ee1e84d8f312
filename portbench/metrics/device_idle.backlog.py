"""device_idle.backlog: the share of the traced window in which no operation
ran on the card, in %."""

from portbench.metrics_common import device_idle


def read(run):
    return device_idle(run)
