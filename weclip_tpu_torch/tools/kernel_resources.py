"""Registers, stack and local memory (spills) of every CUDA kernel, as
``cuobjdump -res-usage`` reports them.

    python -m weclip_tpu_torch.tools.kernel_resources [--csrc DIR] [--json OUT]

Builds each ``csrc/*.cu`` with the package's ``nvcc`` flags (the package's
own sources by default, or those of ``DIR``, e.g. another commit unpacked
with ``git archive``, into a temporary directory) and prints one line per
kernel, its name demangled.  Comparing two checkouts' output shows whether
a change kept a kernel's compiled code's registers and spills.  Needs the
CUDA toolkit; no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

from weclip_tpu_torch import kernels


def _demangle(names):
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return [n.replace("(anonymous namespace)::", "") for n in out]


def resources(lib: Path) -> Dict[str, Dict[str, int]]:
    """{demangled kernel name: {"REG", "STACK", "LOCAL"}} of a built library."""
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(lib)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    found, fn = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            fn = line[len("Function "):].rstrip(":")
        elif fn and line.startswith("REG:"):
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            found[fn] = {k: int(fields[k]) for k in ("REG", "STACK", "LOCAL")
                         if fields.get(k, "").isdigit()}
            fn = None
    return dict(zip(_demangle(list(found)), found.values()))


def build_all(csrc: Path, out_dir: Path) -> Dict[str, Path]:
    """Every ``csrc/*.cu`` built at once (one nvcc each) into ``out_dir``."""
    procs = {}
    for src in sorted(csrc.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        procs[src.stem] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}.cu failed:\n{log}")
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(Path(kernels.__file__).parent / "csrc"),
                    help="a directory of .cu sources (default: this package's)")
    ap.add_argument("--json", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="weclip_resources_") as tmp:
        table = {name: resources(lib)
                 for name, lib in build_all(Path(args.csrc), Path(tmp)).items()}
    for name, kerns in table.items():
        for fn, res in sorted(kerns.items()):
            print(f"[resources] {name} {fn}: {res}", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(table, indent=1))
    return table


if __name__ == "__main__":
    main()
