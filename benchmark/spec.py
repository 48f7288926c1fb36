"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root names the configurations, cells and metrics.
Everything that belongs to one of them sits in a file of its own under this
folder, so a later change adds files and edits none:

- ``configs/<config>.json``: the configuration (its source, published sizes,
  ``assumed`` sizes, ``reduced`` keys, its vision ``tower``, and the overlay
  onto the port's ``Config()`` under ``config``);
- ``towers/<tower>.py`` and ``reference/towers/<tower>.py``: a vision
  tower, what the benchmark draws and counts of it and its plain math (see
  ``towers/__init__.py``);
- ``traffic/<traffic>.json``: a traffic mix, the parameters that the driver
  ``mixes/<mix>.py`` named by its ``mix`` key reads;
- ``workloads/<cell>.json``: a cell's configuration, traffic, ``why`` and
  the limits of its correctness check;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(run)`` returning a number or None;
- ``kernels/<layer>/*.txt``: kernel-name patterns (regular expressions, one
  a line, ``#`` comments) whose device time a roofline metric divides by.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List, Optional

from benchmark import towers

HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


class SpecError(ValueError):
    pass


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names under ``folder``."""

    def __init__(self, bench_path: Optional[Path] = None, folder: Optional[Path] = None):
        self.folder = Path(folder) if folder else HERE
        self.path = Path(bench_path) if bench_path else self.folder.parent / "BENCHMARK.json"
        self.bench = _load_json(self.path)

    # -- lookups -----------------------------------------------------------
    def workload(self, name: str) -> dict:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SpecError(f"no workload {name!r} in {self.path.name}")
        cell = _load_json(self.folder / "workloads" / f"{name}.json")
        cell["chips"] = entry["chips"]
        return cell

    def config(self, name: str) -> dict:
        return _load_json(self.folder / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self.folder / "traffic" / f"{name}.json")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])]

    def metric_reader(self, name: str):
        path = self.folder / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def kernel_patterns(self, layer: str) -> List[re.Pattern]:
        out = []
        for path in sorted((self.folder / "kernels" / layer).glob("*.txt")):
            for line in path.read_text().splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(re.compile(line))
        return out

    # -- validation ----------------------------------------------------------
    def _tower_errors(self, name: str, config: dict) -> List[str]:
        """A configuration file names its tower, whose two files exist, and
        has the ``published`` block the tower reads."""
        tower = config.get("tower")
        if not isinstance(tower, str) or not towers.NAME.match(tower):
            return [f"config {name}: tower {tower!r}"]
        errs = [f"config {name}: no {folder}/{tower}.py"
                for folder in ("towers", "reference/towers")
                if not (self.folder / folder / f"{tower}.py").exists()]
        if not isinstance(config.get("published"), dict):
            errs.append(f"config {name}: no published block")
        return errs

    def validate(self) -> List[str]:
        """Every problem found (empty when the benchmark is well formed)."""
        b, errs = self.bench, []
        want = {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"}
        if set(b) != want:
            errs.append(f"top-level keys {sorted(b)} != {sorted(want)}")
        names = []

        def name_ok(n, what):
            if not isinstance(n, str) or not NAME.match(n):
                errs.append(f"{what}: bad name {n!r}")

        def line_ok(s, what):
            if not isinstance(s, str) or not LINE.match(s):
                errs.append(f"{what}: bad text {s!r}")

        for c in b.get("configs", []):
            name_ok(c["name"], "config")
            names.append(("config", c["name"]))
            line_ok(c["source"], f"config {c['name']} source")
            line_ok(c["why"], f"config {c['name']} why")
            for k in c["reduced"]:
                name_ok(k, f"config {c['name']} reduced")
            if not (self.folder.parent / c["file"]).exists():
                errs.append(f"config {c['name']}: no file {c['file']}")
            else:
                errs += self._tower_errors(c["name"], _load_json(self.folder.parent / c["file"]))
            if set(c) != {"name", "source", "file", "reduced", "why"}:
                errs.append(f"config {c['name']}: keys {sorted(c)}")
        config_names = {c["name"] for c in b.get("configs", [])}
        traffics = set()
        for w in b.get("workloads", []):
            name_ok(w["name"], "workload")
            name_ok(w["config"], f"workload {w['name']} config")
            name_ok(w["traffic"], f"workload {w['name']} traffic")
            line_ok(w["why"], f"workload {w['name']} why")
            names.append(("workload", w["name"]))
            if w["config"] not in config_names:
                errs.append(f"workload {w['name']}: no config {w['config']}")
            if (w["config"], w["traffic"]) in traffics:
                errs.append(f"workload {w['name']}: pair repeated")
            traffics.add((w["config"], w["traffic"]))
            if w["chips"] not in (1, 4):
                errs.append(f"workload {w['name']}: chips {w['chips']}")
            if set(w) != {"name", "config", "traffic", "chips", "why"}:
                errs.append(f"workload {w['name']}: keys {sorted(w)}")
            cell_path = self.folder / "workloads" / f"{w['name']}.json"
            if not cell_path.exists():
                errs.append(f"workload {w['name']}: no file {cell_path.name}")
                continue
            cell = _load_json(cell_path)
            if cell.get("config") != w["config"] or cell.get("traffic") != w["traffic"]:
                errs.append(f"workload {w['name']}: file names another config or traffic")
            tpath = self.folder / "traffic" / f"{w['traffic']}.json"
            if not tpath.exists():
                errs.append(f"workload {w['name']}: no traffic file {tpath.name}")
            elif not (self.folder / "mixes" / f"{_load_json(tpath)['mix']}.py").exists():
                errs.append(f"traffic {w['traffic']}: no mix driver")
        cell_names = {w["name"] for w in b.get("workloads", [])}
        e2e_names = set()
        for m in b.get("end_to_end", []):
            name_ok(m["name"], "end_to_end")
            names.append(("metric", m["name"]))
            e2e_names.add(m["name"])
            if not UNIT.match(m["unit"]):
                errs.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                errs.append(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES_E2E:
                errs.append(f"metric {m['name']}: source {m['source']!r}")
            if not 0.01 <= m["bound"] <= 0.25:
                errs.append(f"metric {m['name']}: bound {m['bound']}")
            for c in m.get("workloads", []):
                if c not in cell_names:
                    errs.append(f"metric {m['name']}: no workload {c}")
        if "setup_s" not in e2e_names:
            errs.append("no setup_s")
        for m in b.get("per_layer", []):
            name_ok(m["name"], "per_layer")
            names.append(("metric", m["name"]))
            if not UNIT.match(m["unit"]):
                errs.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                errs.append(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES:
                errs.append(f"metric {m['name']}: source {m['source']!r}")
            line_ok(m["layer"], f"metric {m['name']} layer")
            if m["moves"] not in e2e_names:
                errs.append(f"metric {m['name']}: moves {m['moves']!r}")
            for c in m.get("workloads", []):
                if c not in cell_names:
                    errs.append(f"metric {m['name']}: no workload {c}")
                elif c not in [w for e in b["end_to_end"] if e["name"] == m["moves"]
                               for w in e.get("workloads", [c])]:
                    errs.append(f"metric {m['name']}: {c} does not report {m['moves']}")
            if not (self.folder / "metrics" / f"{m['name']}.py").exists():
                errs.append(f"metric {m['name']}: no reader")
        seen = set()
        for kind, n in names:
            if (kind, n) in seen:
                errs.append(f"{kind} {n!r} named twice")
            seen.add((kind, n))
        for c in config_names:
            if not any(w["config"] == c for w in b.get("workloads", [])):
                errs.append(f"config {c}: used by no cell")
        for w in cell_names:
            reports = [m["name"] for m in b.get("end_to_end", [])
                       if w in m.get("workloads", [w])]
            if "setup_s" not in reports or len(reports) < 2:
                errs.append(f"workload {w}: end-to-end metrics {reports}")
            if not any(w in m.get("workloads", [w]) for m in b.get("per_layer", [])):
                errs.append(f"workload {w}: no per-layer metric")
        return errs
