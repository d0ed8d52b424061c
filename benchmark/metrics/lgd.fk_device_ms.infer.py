"""Device ms a served step spends on the LGD loop's FK + sensor blocks (the
operations launched in its ``lgd.fk`` spans)."""

from benchmark.metrics.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ("lgd.fk",), "serve.step")
