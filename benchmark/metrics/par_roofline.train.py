"""The par kernels' share of their roofline in the traced stretch: the
least time of the par work its calls need (benchmark/work.py, from the
shapes) over the device time of the kernels that benchmark/kernels/par/
names, in percent.  Nothing when none of them ran."""


def read(run):
    return run.roofline("par")
