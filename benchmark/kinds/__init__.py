"""The drivers of the traffic mixes, one module a kind: a mix
(`mixes/<traffic>.json`) names its `kind`, and `kinds/<kind>.py` drives
it (`manifest.kind`). Each such module exposes

- `execute(cell, seed, seconds, trace, dev, fault, t_start)`: one run of
  the cell on this rank (set-up, the window, the reference), returning
  the `judge.Record` on rank 0 and None on the others;
- `readings(cell, seeds, control_seeds, faults, dev, emit, witness)`:
  the program's, the control's and the planted faults' readings that
  `benchmark.control` sets the limits of `correct` from, each handed to
  `emit(seed, run, numbers, where)` on rank 0.

A new kind of traffic is a new file here; no other file needs an edit.
"""

from __future__ import annotations

from benchmark import judge, manifest


def record(cell, kind: str, local_batch: int) -> judge.Record:
    """The run's Record, before the window has filled it in."""
    return judge.Record(kind=kind, cell=cell.name, model=cell.model,
                        batch=cell.mix["batch"], local_batch=local_batch,
                        chips=cell.chips,
                        kernel_tables=manifest.kernel_tables())
