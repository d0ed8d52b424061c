"""Device ms a training step spends on the operations launched in the
program's ``train.backward`` span."""

from benchmark.metrics.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("train.backward",), "train.step")
