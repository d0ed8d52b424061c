"""Mean count of streams one live ``MultiStreamPredictor.step`` serves."""


def read(run):
    served = run.counters.get("streams_served")
    steps = run.counters.get("steps")
    return served / steps if steps else None
