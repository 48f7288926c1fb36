"""The whole step's share of the card's peak, in percent: the least time
of the model's products (benchmark/work.py, at the peak of each product's
stated precision) over the untraced part of the window."""


def read(run):
    return run.mfu()
