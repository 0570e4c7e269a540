"""The readings the limits of `correct` are set from, at a cell's own size
on the card (the benchmark's runs do not run this):

- the program's: its checked steps (or a short serving window) against
  the reference, on each of `--seeds`;
- the control's: the reference computed with float8 (e4m3) products put in
  the program's place, against the float32 reference, on each of
  `--control-seeds`;
- with `--witness bf16`, the reference with bfloat16 products, on the
  program's seeds: a second witness of how far that precision alone reads;
- each planted fault's (`--faults`), in the program, on the control seeds:
  `frozen` (a step that returns its state unchanged), `half` (half of the
  batch left out, the mean over the rest), `no_exchange` (DDP's all-reduce
  left out), `altered` (one answer altered where it is produced).

    python3 -m benchmark.control --workload CELL --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults half,altered] [--out FILE]

Prints one JSON line a reading and, last, the largest program (and
witness) reading and the smallest control and fault readings of each
number.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from benchmark import device as hw
from benchmark import manifest, run


def readings(cell, seeds, control_seeds, faults, dev="cuda", emit=None,
             witness=()):
    """Every reading as {seed, run, numbers}, in order (on rank 0)."""
    out = []

    def keep(seed, name, numbers, where=None):
        row = {"seed": seed, "run": name, "numbers": numbers,
               "where": where or {}}
        out.append(row)
        if emit is not None:
            emit(row)

    manifest.kind(cell.mix["kind"]).readings(
        cell, seeds, control_seeds, faults, dev, keep, witness)
    return out


def summary(rows: list) -> dict:
    """For each number: the largest reading of the program (and of a
    witness), and the smallest of the control and of each fault."""
    out = {}
    for row in rows:
        for k, v in row["numbers"].items():
            s = out.setdefault(k, {})
            if row["run"] == "program" or row["run"].startswith("reference"):
                key = f"{row['run']}_max"
                s[key] = max(s.get(key, 0.0), v)
            else:
                key = f"{row['run']}_min"
                s[key] = min(s.get(key, math.inf), v)
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--witness", default="",
                   help="precisions of the reference read on the program's "
                        "seeds beside it (bf16)")
    p.add_argument("--out", default="")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    cell = manifest.cell(args.workload)
    world = cell.mix.get("world", 1)
    procs = []
    if args.rank > 0:
        run._watch_parent()
    elif world > 1:
        procs = run._spawn_ranks("benchmark.control", argv, world)
        run._watch(procs)
    sink = open(args.out, "w") if args.out and args.rank == 0 else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    try:
        rows = readings(cell, ints(args.seeds), ints(args.control_seeds),
                        [f for f in args.faults.split(",") if f],
                        emit=emit if args.rank == 0 else None,
                        witness=[w for w in args.witness.split(",") if w])
    finally:
        for proc in procs:
            proc.wait(timeout=300)
        if sink is not None:
            sink.close()
    if args.rank == 0:
        print(json.dumps({"summary": summary(rows), "card": hw.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
