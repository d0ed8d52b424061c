"""Device ms a training step spends on the LGD loop's FK + sensor blocks
(the operations launched in its ``lgd.fk`` spans: the forward's; their
gradients run in ``train.backward``)."""

from benchmark.metrics.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("lgd.fk",), "train.step")
