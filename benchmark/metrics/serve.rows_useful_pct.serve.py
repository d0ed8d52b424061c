"""Share of the rows the served forwards ran that belonged to a ready
stream: ``rows_ready`` over ``rows_run`` of the program's ``serve.step``
spans, %."""

from benchmark.metrics.spans import count_share


def read(run):
    return count_share(run, "serve.step", "rows_ready", "rows_run")
