"""Median host time of the program's ``serve.pack`` span (every stream's
buffer into the step's input), ms."""

from benchmark.metrics.spans import host_ms_p50


def read(run):
    return host_ms_p50(run, "serve.pack")
