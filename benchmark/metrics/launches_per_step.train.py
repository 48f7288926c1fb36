"""Device operations (kernels, copies, sets) a step, from the traced
stretch."""


def read(run):
    if run.stretch is None or not run.stretch_units:
        return None
    return run.stretch.launches() / run.stretch_units
