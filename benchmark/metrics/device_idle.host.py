"""device_idle.host: device_idle in a serving cell whose host sets the
pace: the share of the traced slice's wall time in which the card ran no
kernel, copy or set, in percent."""

from benchmark.metrics._device import idle_percent


def read(run):
    return idle_percent(run)
