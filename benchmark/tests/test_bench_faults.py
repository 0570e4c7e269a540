"""`correct` at a size the CPU holds: a sound run passes each cell's
limits, and each fault the cell can have, planted under the timed path,
fails them, as the control (the reference with float8 products in the
program's place) does. The run skips only the look for a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control, judge, manifest, rehearse, run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 101
ONE_CHIP = [w["name"] for w in manifest.load()["workloads"] if w["chips"] == 1]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _correct(cell, fault=None):
    c = rehearse.tiny(manifest.cell(cell))
    rec = run.execute(c, SEED, 1.0, False, "cpu", fault=fault)
    out = run.result(c, rec, False, "cpu")
    assert list(out)[-1] == "checks"
    return out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_sound_run_is_correct(cell):
    ok, checks = _correct(cell)
    assert ok, checks


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ONE_CHIP
    for f in (("frozen", "half") if manifest.cell(c).mix["kind"] == "train"
              else ("altered", "half"))])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    ok, checks = _correct(cell, fault)
    assert not ok, checks


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_control_is_not_correct(cell):
    c = rehearse.tiny(manifest.cell(cell))
    rows = control.readings(c, [], [SEED], [], dev="cpu")
    got = [r["numbers"] for r in rows if r["run"] == "control"]
    assert got and not judge.verdict(got[0], c.limits), got


DDP_MIX = {"kind": "train", "why": "train_b16 over 4 ranks", "batch": 16,
           "world": 4, "pool": 8, "shift_px": 0.5, "online_align": "none",
           "check_steps": 3, "profile_steps": 8, "ref_rows": 4}


@pytest.fixture(scope="module")
def ddp_checkout(tmp_path_factory):
    """A copy of the benchmark with a cell over four ranks added as files
    alone: its mix, its limits and its manifest entry."""
    root = tmp_path_factory.mktemp("ddp")
    here = root / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "mixes" / "train_ddp4_b16.json").write_text(json.dumps(DDP_MIX))
    limits = manifest.cell("fbanet64-train-b16").rehearsal
    (here / "workloads" / "fbanet64-train-ddp4.json").write_text(
        json.dumps({"limits": limits, "rehearsal": limits}))
    man = manifest.load()
    man["workloads"].append({"name": "fbanet64-train-ddp4",
                             "config": "fbanet64",
                             "traffic": "train_ddp4_b16", "chips": 4,
                             "why": "DDP over four cards"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.mark.parametrize("fault,correct", [(None, True),
                                           ("no_exchange", False)])
def test_ddp_without_its_exchange_is_not_correct(ddp_checkout, fault,
                                                 correct):
    args = [sys.executable, "-m", "benchmark.rehearse", "--workload",
            "fbanet64-train-ddp4", "--seed", str(SEED), "--seconds", "1"]
    out = subprocess.run(args + (["--fault", fault] if fault else []),
                         cwd=ddp_checkout, capture_output=True, text=True,
                         timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is correct, line
    assert line["steps_or_batches"] > 1, line
