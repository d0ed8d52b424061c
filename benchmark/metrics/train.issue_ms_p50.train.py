"""Median host time of the program's ``train.step`` span: how long the host
takes to issue one step (the benchmark's ``train.step_ms_p50`` times the same
call synchronized), ms."""

from benchmark.metrics.spans import host_ms_p50


def read(run):
    return host_ms_p50(run, "train.step")
