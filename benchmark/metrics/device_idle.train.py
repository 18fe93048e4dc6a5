"""device_idle: the share of the traced slice's wall time in which the card
ran no kernel, copy or set (the union of their intervals), in percent."""

from benchmark.metrics._device import idle_percent


def read(run):
    return idle_percent(run)
