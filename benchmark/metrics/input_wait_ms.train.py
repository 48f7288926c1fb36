"""Mean host time a step of the window waits for its batch: ``next`` on the
loader and ``make_batcher``'s copy to the device (a span the benchmark puts
around both)."""


def read(run):
    waits = run.host.get("input_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
