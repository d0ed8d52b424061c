"""Host ms between two of the program's ``serve.step`` spans, the median:
in the replay cell, every stream's ``push`` of the next step's chunk, with
the replay loop's few lines of bookkeeping around them."""

from benchmark.metrics.spans import gap_ms_p50


def read(run):
    return gap_ms_p50(run, "serve.step")
