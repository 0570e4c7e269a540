"""The manifest and the files it names: characters and keys as the
benchmark's contract allows them, every file found by name, a new cell
picked up from new files alone, the command's refusals, and the imports
the benchmark may not make."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = manifest.load(ROOT)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_characters():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in
                                                  MAN["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in MAN[key]]
        assert len(got) == len(set(got))
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_every_file_is_named_from_allowed_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        assert PATH.match(str(path.relative_to(ROOT))), path


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = manifest.cell(cell)
    drive = manifest.kind(c.mix["kind"])
    assert callable(drive.execute) and callable(drive.readings)
    assert c.mix.get("world", 1) == c.chips
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_a_cell_added_as_new_files_alone_is_picked_up(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    here = tmp_path / "benchmark"
    mix = dict(manifest.cell("fbanet64-train-b16").mix, batch=8)
    (here / "mixes" / "train_b8.json").write_text(json.dumps(mix))
    (here / "workloads" / "fbanet32-train-b8.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (here / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    return rec.units\n")
    man["workloads"].append({"name": "fbanet32-train-b8", "config": "fbanet32",
                             "traffic": "train_b8", "chips": 1, "why": "x"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "fbanet32-train-b32" in m.get("workloads", ()):
            m["workloads"].append("fbanet32-train-b8")
    man["per_layer"].append({"name": "steps.train", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "model step",
                             "moves": "train_samples_per_s",
                             "workloads": ["fbanet32-train-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.cell("fbanet32-train-b8", root=tmp_path, here=here)
    assert c.mix["batch"] == 8 and c.model["embed_dim"] == 32
    assert {"steps.train", "mfu.train"} <= {m["name"] for m in c.per_layer}
    assert "train_samples_per_s" in [m["name"] for m in c.end_to_end]
    assert manifest.reader("steps.train", here=here)(
        type("R", (), {"units": 7})()) == 7
    (here / "kernels" / "swin_fwd.new.json").write_text(
        json.dumps({"op": "swin_fwd", "kernels": ["new_kernel"]}))
    assert "new_kernel" in manifest.kernel_tables(here)["swin_fwd"]


def test_a_kind_added_as_a_new_file_alone_is_picked_up(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "kinds" / "replay.py").write_text(
        "def execute(*args):\n    return 'replayed'\n\n\n"
        "def readings(*args):\n    return []\n")
    code = ("from benchmark import manifest, run\n"
            "print(run.execute(type('C', (), {'mix': {'kind': 'replay'}})(),"
            " 1, 1.0, False, 'cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "replayed"
    with pytest.raises(ValueError):
        manifest.kind("../train")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_the_command_refuses_a_run_without_a_card():
    out = _run(["--workload", "fbanet64-train-b16", "--seed", "1",
                "--seconds", "1", "--trace", "0"], ROOT,
               env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(["--workload", "fbanet64-train-b16", "--seed", "1",
                "--seconds", "1", "--trace", "0"], tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "fbanet_tpu"}, path
        text = path.read_text()
        for name in ("bench.py", "BENCH_r", "MULTICHIP_", "BASELINE."):
            assert name not in text or path.name.startswith("test_bench"), \
                (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert "fbanet_tpu_torch" not in tops, path
        assert tops <= {"__future__", "math", "dataclasses", "numpy", "torch",
                        "benchmark"}, (path, tops)
        mods = {n for n in _imports(path) if n.startswith("benchmark")}
        assert all(m.startswith("benchmark.reference") for m in mods), path
