"""A rehearsal of a cell on the CPU at a tiny size, through the port's plain
versions: the same drivers, set-up, window, reference and comparison as
`benchmark.run`, none of the card's kernels. It checks control flow and
prints the compared numbers; it measures nothing.

    python3 -m benchmark.rehearse --workload CELL [--seed N] [--seconds S]
        [--fault frozen|half|no_exchange|altered]

A cell on several chips runs its ranks as processes over gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from benchmark import judge, manifest, run

TINY_MODEL = {"num_frames": 3, "img_size": 32, "embed_dim": 16,
              "heads": [1, 2, 4, 8, 8, 8, 4, 2, 1]}
TINY_MIX = {"pool": 3, "ref_rows": 2, "profile_steps": 2}


def tiny(cell: manifest.Cell) -> manifest.Cell:
    """`cell` at a size the CPU runs in seconds: 3 frames of 32 px, embed
    16, 2 rows a rank, a pool of 3 batches, and the limits set from
    readings at that size (the CPU's bf16 products at tiny widths round
    otherwise than the card's kernels at the published ones)."""
    config = dict(cell.config, model=dict(cell.model, **TINY_MODEL))
    world = cell.mix.get("world", 1)
    mix = dict(cell.mix, **TINY_MIX, batch=2 * world)
    return dataclasses.replace(cell, config=config, mix=mix,
                               limits=cell.rehearsal)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2 ** 33 + 7)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    cell = tiny(manifest.cell(args.workload))
    world = cell.mix.get("world", 1)
    procs = []
    if args.rank > 0:
        run._watch_parent()
    elif world > 1:
        procs = run._spawn_ranks("benchmark.rehearse", argv, world)
        run._watch(procs)
    try:
        rec = run.execute(cell, args.seed, args.seconds, False, "cpu",
                          fault=args.fault)
    finally:
        for proc in procs:
            proc.wait(timeout=300)
    if rec is None:
        return 0
    ok = judge.verdict(rec.numbers, cell.limits) and rec.failed == 0
    print(json.dumps({"correct": ok, "steps_or_batches": rec.units,
                      "checks": {k: {"value": rec.numbers.get(k),
                                     "limit": v}
                                 for k, v in cell.limits.items()},
                      "readings": rec.numbers}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
