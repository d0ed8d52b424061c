"""The LSTM training pair's (``csrc/lstm_train.cu``: forward and reverse
sweep of each direction-layer) least time over its traced device time, %."""

from benchmark.metrics import roofline as R
from benchmark.metrics.common import roofline


def read(run):
    return roofline(run, "lstm_train", ("lstm_train_fwd_kernel", "lstm_train_bwd_kernel"),
                    (lambda s: R.train_fwd_s(s["F"], s["N"], s["H"]),
                     lambda s: R.train_bwd_s(s["F"], s["N"], s["H"])))
