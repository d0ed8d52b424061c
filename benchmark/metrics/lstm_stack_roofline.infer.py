"""The inference stack's (``csrc/lstm_stack.cu``) least time over its traced
device time, %."""

from benchmark.metrics import roofline as R
from benchmark.metrics.common import roofline


def read(run):
    return roofline(run, "lstm_stack", ("lstm_stack_kernel",),
                    (lambda s: R.stack_s(s["F"], s["N"], s["H"], s["L"]),))
