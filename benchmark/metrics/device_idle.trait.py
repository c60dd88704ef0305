"""device_idle.trait: percent of the traced window of a per-trait cell
with nothing running on the device."""
from benchmark.trace import idle_share


def read(ctx):
    return idle_share(ctx)
