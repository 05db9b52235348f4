"""Share of the profiled window in which no operation ran on the device (%)."""

from benchmark.readers import device_idle


def read(run):
    return 100.0 * device_idle(run)
