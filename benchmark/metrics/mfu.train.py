"""A whole training step's share of the fp32 peak, FLOPs counted on the
plain reference (synthesis, forward, loss, gradients), %."""

from benchmark.metrics.common import mfu


def read(run):
    return mfu(run)
