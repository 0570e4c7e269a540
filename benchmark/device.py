"""The card the run is on: synchronisation, its memory peak, the
precision each side computes in, its name and power limit, and the
modules the process must not hold."""

from __future__ import annotations

import subprocess
import sys

import torch

# top-level names of JAX and of the package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "fbanet_tpu")


def is_cuda(dev) -> bool:
    return torch.device(dev).type == "cuda"


def sync(dev) -> None:
    if is_cuda(dev):
        torch.cuda.synchronize()


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if is_cuda(dev) else 0


def reset_peak(dev) -> None:
    if is_cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)


_TF32 = (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)


def program_precision() -> None:
    """The program runs under torch's settings as the process found them."""
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = _TF32


def reference_precision() -> None:
    """The reference computes in float32: no TF32 anywhere after this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that `sys.modules` holds, compared
    whole (`fbanet_tpu_torch` is not `fbanet_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().replace("\n", "; ")
