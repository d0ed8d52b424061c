"""Device ms a training step spends on the operations launched in the
program's ``train.forward`` and ``train.loss`` spans."""

from benchmark.metrics.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("train.forward", "train.loss"), "train.step")
