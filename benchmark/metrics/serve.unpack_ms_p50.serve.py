"""Median host time of the program's ``serve.unpack`` span (the outputs
split by stream), ms."""

from benchmark.metrics.spans import host_ms_p50


def read(run):
    return host_ms_p50(run, "serve.unpack")
