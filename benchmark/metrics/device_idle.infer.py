"""Share of the traced bulk-replay window with no device operation, %."""

from benchmark.metrics.common import device_idle


def read(run):
    return device_idle(run)
