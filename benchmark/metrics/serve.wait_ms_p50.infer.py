"""Median host time of the program's ``serve.download`` span (the outputs
to the host, waiting for the device), ms."""

from benchmark.metrics.spans import host_ms_p50


def read(run):
    return host_ms_p50(run, "serve.download")
