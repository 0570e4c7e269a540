"""Data parallelism over ranks: one process per card and a process group
between them (counterpart of fbanet_tpu/parallel/mesh.py).

The JAX package runs one process over a 1-D device mesh: each batch is
sharded on its leading axis, the parameters are replicated and XLA emits
the gradient all-reduce. The port runs one process per card, launched by
torchrun,

    torchrun --nproc_per_node W -m fbanet_tpu_torch.train --batch_size 16 ...

(`python -m torch.distributed.run` is the same launcher), with the same
meaning: `--batch_size` is the global batch, rank r takes rows
[r B/W, (r+1) B/W) of each one, and DDP averages the gradients over the
ranks.

- `init(device)`: this process's `World`, read from torchrun's environment
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
  `MASTER_PORT`), and its process group: `nccl` on a CUDA device, `gloo`
  on the CPU. `--device cuda` becomes `cuda:LOCAL_RANK`. Without that
  environment the world is one process with no group, and every path runs
  as it does without this module.
- `World.rows(n)`: the rank's block of a batch of n rows, the rows JAX's
  `batch_sharding` puts on device r of a W-device mesh. It raises, naming
  both numbers, when W does not divide n: JAX drops to fewer chips there,
  which a torchrun launch cannot do.
- `World.gather(t)`: every rank's rows of `t`, concatenated in rank order,
  on every rank (through the host under gloo: torch's backend table does
  not list gloo's all_gather for CUDA tensors). `World.mean`, `barrier`,
  `close`.
- `pad_to_multiple`: as in the JAX package; `free_port` for a launcher's
  `MASTER_PORT`.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of `m` that is >= `n` (for batch padding)."""
    return -(-n // m) * m


def row_block(n: int, rank: int, size: int) -> slice:
    """Rows [rank n / size, (rank + 1) n / size) of a batch of `n`."""
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over {size} "
                         f"ranks: the (global) batch size must be a "
                         f"multiple of the world size")
    b = n // size
    return slice(rank * b, (rank + 1) * b)


@dataclass(frozen=True)
class World:
    """The ranks of one data-parallel run; the default is one process with
    no process group. `local_size` is the number of ranks on this host,
    `device_index` the rank's card (NCCL's barrier names it); `owns_group`
    says whether `close` ends the group."""

    rank: int = 0
    size: int = 1
    local_size: int = 1
    backend: str | None = None
    device_index: int | None = None
    owns_group: bool = False

    @property
    def distributed(self) -> bool:
        """Whether a process group joins the ranks (even a group of one)."""
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        return row_block(n, self.rank, self.size)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size * n, ...]: every rank's [n, ...] rows in rank order."""
        if self.size == 1:
            return t
        host = self.backend == "gloo" and t.is_cuda
        src = (t.cpu() if host else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        out = torch.cat(parts)
        return out.to(t.device) if host else out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of `t` over the ranks (a sum, then one divide: gloo has
        no averaging all-reduce)."""
        if self.size == 1:
            return t
        out = t.clone()
        dist.all_reduce(out)
        return out / self.size

    def barrier(self) -> None:
        if not self.distributed:
            return
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device_index])
        else:
            dist.barrier()

    def close(self) -> None:
        """End the process group if `init` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def init(device: torch.device | str = "cuda", *,
         backend: str | None = None) -> tuple[World, torch.device]:
    """(this process's World, its device). Under torchrun's environment it
    joins (or starts) the process group: `backend` defaults to nccl for a
    CUDA device and gloo for the CPU; a CUDA device without an index becomes
    `cuda:LOCAL_RANK`. Without that environment: `World()` and `device`."""
    dev = torch.device(device)
    env = os.environ
    if "WORLD_SIZE" not in env:
        return World(), dev
    rank, size = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if owns:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=size)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, size):
        raise RuntimeError(f"a process group of rank {dist.get_rank()} / "
                           f"{dist.get_world_size()} exists; the environment "
                           f"says {rank} / {size}")
    return World(rank=rank, size=size, local_size=local_size,
                 backend=dist.get_backend(),
                 device_index=dev.index if dev.type == "cuda" else None,
                 owns_group=owns), dev


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
