"""Median host time of one synchronized ``Trainer.train_step`` call, ms."""

from benchmark.metrics.common import step_ms_p50


def read(run):
    return step_ms_p50(run, "train_step")
