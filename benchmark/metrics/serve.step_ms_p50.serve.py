"""Median host time of one ``MultiStreamPredictor.step`` of live serving, ms."""

from benchmark.metrics.common import step_ms_p50


def read(run):
    return step_ms_p50(run, "step")
