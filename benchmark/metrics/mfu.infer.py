"""A whole served step's share of the fp32 peak, FLOPs of the eval forward
counted on the plain reference, %."""

from benchmark.metrics.common import mfu


def read(run):
    return mfu(run)
