"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: the file its entry names (`configs/<name>.json`);
- a traffic mix: `mixes/<traffic>.json`, the parameters that the driver
  of its `kind` reads;
- the driver of a kind of traffic: `kinds/<kind>.py` (`benchmark.kinds`
  says what it exposes);
- a cell's limits of correctness: `workloads/<cell>.json` ("limits"; and
  "rehearsal", those of the CPU rehearsal at its tiny size);
- a per-layer metric: its reader `metrics/<name>.py`, a `read(record)`
  that returns a number or None where it finds nothing to read;
- the kernels of an operator: every `kernels/*.json`, each
  {"op": ..., "kernels": [name patterns]}, merged by op.

A later cell, mix, kind of traffic, metric or kernel name is a new file;
none of these needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict      # configs/<name>.json
    mix: dict         # mixes/<traffic>.json
    limits: dict      # workloads/<cell>.json "limits"
    rehearsal: dict   # and "rehearsal": the limits at the CPU's tiny size
    end_to_end: list  # the manifest's metrics this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, manifest: dict | None = None,
         root: Path = ROOT, here: Path = HERE) -> Cell:
    man = manifest if manifest is not None else load(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, e2e_names)]
    limits = _read_json(here / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]),
                config=_read_json(root / conf["file"]),
                mix=_read_json(here / "mixes" / f"{w['traffic']}.json"),
                limits=limits["limits"],
                rehearsal=limits.get("rehearsal", limits["limits"]),
                end_to_end=e2e, per_layer=per_layer)


def kind(name: str):
    """The module `kinds/<name>.py` that drives mixes of kind `name`."""
    if not re.fullmatch(r"[a-z_][a-z0-9_]*", name):
        raise ValueError(f"mix kind {name!r} names no module")
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(metric: str, here: Path = HERE):
    """The `read` function of `metrics/<metric>.py`."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_tables(here: Path = HERE) -> dict[str, list[str]]:
    """{op: [kernel name patterns]} from every `kernels/*.json`."""
    out: dict[str, list[str]] = {}
    for path in sorted((here / "kernels").glob("*.json")):
        t = _read_json(path)
        out.setdefault(t["op"], []).extend(t["kernels"])
    return out
