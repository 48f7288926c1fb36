"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds or loads the port's kernels, makes
the cell's inputs and weights from the seed, warms the cell's own shapes,
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit.  Earlier lines on standard error give the
card and its power limit, set-up, the window and peak memory; the last lines
there repeat the checks.

It exits non-zero, printing no result, without a CUDA card (or fewer than
the cell asks for), and when JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmark import harness  # noqa: E402
from benchmark.spec import Spec  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_env(root: Path) -> None:
    """The run's environment, set before torch is imported: build and kernel
    caches at fixed paths inside the checkout; one OpenMP thread (the
    program's host work is Python, numpy and PIL, and idle OpenMP workers
    spinning on the card machine's 8 cores slowed the Python threads by a
    varying amount, spreading the host-bound cells' times); transformers
    kept from loading JAX."""
    cache = root / "benchmark_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_mix(spec: Spec, name: str):
    path = spec.folder / "mixes" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.mixes.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def measure(spec: Spec, cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None):
    """(Run, cell) of one run of ``cell_name`` on ``device``; the caller
    has checked the card."""
    cell = spec.workload(cell_name)
    ctx = harness.Context(
        spec=spec, cell_name=cell_name, cell=cell, config=spec.config(cell["config"]),
        traffic=spec.traffic(cell["traffic"]), seed=seed, seconds=seconds, trace=trace,
        device=device, t_start=T0 if t_start is None else t_start, log=log)
    mix = load_mix(spec, ctx.traffic["mix"])
    return mix.run(ctx), cell


def result_line(spec: Spec, cell_name: str, run, trace: bool, device: dict) -> dict:
    """The last line's object (``checks`` last)."""
    metrics = {}
    if trace:
        for m in spec.per_layer(cell_name):
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(cell_name):
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    correct = all(v <= lim for v, lim in run.checks.values())
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.stretch is not None:
        line["breakdown"] = run.stretch.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec()
    cell = spec.workload(args.workload)
    run_env(spec.folder.parent)
    try:
        import weclip_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the port is not in this checkout: {exc}")
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"[card] {harness.card_line()}")
    run, _ = measure(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    if args.trace and run.stretch is not None:
        device["busy_s"] = run.stretch.busy_s()
        device["window_s"] = run.stretch.wall_s
    line = result_line(spec, args.workload, run, bool(args.trace), device)
    log(f"[memory] peak {run.memory_peak_bytes} bytes on {device['kind']}")
    for k, (v, lim) in run.checks.items():
        log(f"check {k}: {v!r} (limit {lim!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
