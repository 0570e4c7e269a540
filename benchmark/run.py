"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (`fbanet_tpu_torch`).
The cell's configuration, traffic mix, the driver of the mix's kind,
limits and metric readers are found by name (`benchmark/manifest.py`). The run builds its inputs and weights on
the card from the seed, sets up and checks the program, measures for S
seconds, checks the program's outputs against the plain reference and
prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error).

It exits with another code than 0 and prints no result where no card (or
fewer than the cell's chips) is present, and where the process holds JAX
or the package the port was made from once the window has closed. A cell
on several chips starts one process a card (NCCL, a free localhost port);
rank 0 prints the line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import torch  # noqa: E402

from benchmark import device as hw  # noqa: E402
from benchmark import judge, manifest  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def execute(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
            dev, fault: str | None = None, t_start: float = T_START):
    """One run of `cell` on this rank, by the driver of its mix's kind
    (`benchmark/kinds/<kind>.py`). Returns the Record on rank 0 (None on
    the others)."""
    return manifest.kind(cell.mix["kind"]).execute(
        cell, seed, seconds, trace, dev, fault, t_start)


def metrics_of(rec: judge.Record, specs: list) -> dict:
    """{name: {"value", "unit"}} of the metrics whose readers find
    something to read."""
    out = {}
    for m in specs:
        v = manifest.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result(cell: manifest.Cell, rec: judge.Record, trace: bool,
           dev) -> dict:
    correct = (judge.verdict(rec.numbers, cell.limits) and rec.failed == 0
               and rec.units > 0)
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed,
           "metrics": metrics_of(rec, cell.per_layer if trace
                                 else cell.end_to_end),
           "device": {"platform": "gpu" if hw.is_cuda(dev) else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if hw.is_cuda(dev) else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": int(rec.peak_bytes)}}
    if trace:
        out["device"]["busy_s"] = (sum(rec.busy_s) / len(rec.busy_s)
                                   if rec.busy_s else 0.0)
        out["device"]["window_s"] = rec.span_s[0] if rec.span_s else 0.0
        if rec.trace is not None:
            out["breakdown"] = {"device_ops": rec.trace.device_ops(),
                                "idle_gaps": rec.trace.idle_gaps}
    out["checks"] = {k: {"value": rec.numbers.get(k, math.nan), "limit": v}
                     for k, v in cell.limits.items()}
    return out


def _spawn_ranks(module: str, argv: list[str],
                 world: int) -> list[subprocess.Popen]:
    """Ranks 1.. of a cell on `world` cards, one process each running
    `python -m module argv --rank r`; this process is rank 0. Sets
    torchrun's variables for all."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      RANK="0", LOCAL_RANK="0")
    procs = []
    for r in range(1, world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--rank", str(r)],
            env=env, stdout=subprocess.DEVNULL))
    return procs


def _watch(procs: list[subprocess.Popen]) -> None:
    """End this process when a rank fails (its collectives would wait)."""
    def watch():
        while True:
            for p in procs:
                rc = p.poll()
                if rc not in (None, 0):
                    print(f"rank process {p.args[-1]} exited {rc}",
                          file=sys.stderr, flush=True)
                    for q in procs:
                        q.kill()
                    os._exit(4)
            if all(p.poll() == 0 for p in procs):
                return
            time.sleep(0.5)
    threading.Thread(target=watch, daemon=True).start()


def _watch_parent() -> None:
    """A rank whose rank 0 is gone ends itself."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(5)
    threading.Thread(target=watch, daemon=True).start()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    world = cell.mix.get("world", 1)
    procs = []
    if args.rank > 0:
        _watch_parent()
    elif world > 1:
        procs = _spawn_ranks("benchmark.run", argv, world)
        _watch(procs)
    try:
        rec = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    finally:
        for proc in procs:
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if rec is None:
        return 0
    held = hw.forbidden_modules()
    if held:
        print(f"the process holds {held}: nothing of JAX or the package the "
              f"port was made from may run", file=sys.stderr)
        return 3
    out = result(cell, rec, bool(args.trace), "cuda")
    print(f"card: {hw.power_limit()}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']:.6g} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
