"""device_idle.exact: percent of the traced window of the whole-panel
exhaustive scan with nothing running on the device."""
from benchmark.trace import idle_share


def read(ctx):
    return idle_share(ctx)
