"""The 95th percentile of the window's step times, in ms: the host-clock
intervals between consecutive steps' returns, the traced steps left out.
In the host-bound loop a step's interval is its time; the percentile
catches periodic stalls (the loader, a sync a change adds) that the mean
hides."""


def read(run):
    return run.step_p95_ms
