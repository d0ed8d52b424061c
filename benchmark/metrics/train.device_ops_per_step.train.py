"""Device operations launched in the program's ``train.step`` span, per step."""

from benchmark.metrics.spans import ops_per_step


def read(run):
    return ops_per_step(run, "train.step")
