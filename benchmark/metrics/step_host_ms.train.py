"""Mean host time of the step call (``make_train_step``'s step and the
trainer's metric sums), a span the benchmark puts around it; it includes
every wait the step forces on the device."""


def read(run):
    calls = run.host.get("step_call")
    return 1e3 * sum(calls) / len(calls) if calls else None
