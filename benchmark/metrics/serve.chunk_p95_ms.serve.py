"""95th percentile of live serving's chunk latency, ms: from the due time
of a chunk's last frame to its poses on the host, over the chunks due once
the traced calls were over and no session held more than one chunk."""


def read(run):
    return run.counters.get("chunk_p95_settled_ms")
