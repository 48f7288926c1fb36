"""The device's idle share, in percent: one less the union of the device
operations' spans per traced step over the host time an untraced one
takes in the same run (the profiler's host overhead is not counted as
idle)."""


def read(run):
    return run.idle()
