"""Checkpoint I/O: the reference's best / latest / periodic triad, resumable
(counterpart of fbanet_tpu/utils/checkpoint.py, in torch's format).

- `{path}.pt`: `{"params": model.state_dict(), "opt_state":
  optimizer.state_dict()}` through `torch.save`, written to `{path}.pt.tmp`
  and renamed, so a reader never sees half a file;
- `{path}.json`: the scalar metadata (`epoch`, `best_psnr`, and for a
  mid-epoch checkpoint `step_in_epoch` and `epoch_loss`), readable without
  torch.

Names as in the JAX package: `model_best`, `model_latest`,
`model_epoch_{n}`. `load_params` also reads the JAX package's
`{path}.msgpack` (flax serialization) through
`utils/weights.py::jax_params_to_state_dict`.

Over ranks (`parallel/mesh.py`) the triad writes on rank 0 only and every
rank waits at a barrier until the file is whole; the state_dicts are the
bare model's (no DDP `module.` prefix), so a checkpoint loads at any world
size. Loading takes `map_location`, the rank's device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fbanet_tpu_torch.utils.weights import jax_params_to_state_dict


def save_checkpoint(path: str | Path, *, params: dict, opt_state: dict | None,
                    epoch: int, best_psnr: float = 0.0,
                    extra: dict | None = None) -> None:
    """Write `{path}.pt` (model and optimizer state_dicts) + `{path}.json`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".pt.tmp")
    torch.save({"params": params, "opt_state": opt_state}, tmp)
    tmp.replace(path.with_suffix(".pt"))
    meta = {"epoch": int(epoch), "best_psnr": float(best_psnr)}
    if extra:
        meta.update(extra)
    path.with_suffix(".json").write_text(json.dumps(meta))


def load_checkpoint(path: str | Path, *, map_location="cpu") -> dict:
    """{'params': state_dict, 'opt_state': optimizer state_dict, 'epoch',
    'best_psnr', ...metadata} of `{path}.pt` + `{path}.json`."""
    path = Path(path)
    state = torch.load(path.with_suffix(".pt"), map_location=map_location,
                       weights_only=True)
    meta = json.loads(path.with_suffix(".json").read_text())
    return {**state, **meta}


def _flax_msgpack_restore(blob: bytes) -> dict:
    """flax.serialization.msgpack_restore without flax, for float32 trees:
    each array is msgpack ext type 1 holding (shape, dtype name, C-order
    bytes). Other ext types (numpy scalars of an optimizer state) come back
    as msgpack.ExtType; arrays over flax's 1 GiB chunk size (stored in
    pieces) are not read."""
    try:
        import msgpack
    except ImportError as exc:
        raise ImportError("reading a JAX .msgpack checkpoint needs the "
                          "msgpack package, which is not installed here; "
                          "save the weights as a .pt checkpoint instead"
                          ) from exc

    def ext_hook(code: int, data: bytes):
        if code != 1:
            return msgpack.ExtType(code, data)
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()

    return msgpack.unpackb(blob, ext_hook=ext_hook, raw=False,
                           strict_map_key=False)


def load_params(path: str | Path, map_location="cpu") -> dict[str, Any]:
    """The model's state_dict only (for evaluation): from `{path}.pt`, or,
    where there is none, from the JAX package's `{path}.msgpack` (a full
    checkpoint or a bare parameter tree)."""
    path = Path(path)
    pt = path.with_suffix(".pt")
    if pt.exists():
        return torch.load(pt, map_location=map_location,
                          weights_only=True)["params"]
    mp = path.with_suffix(".msgpack")
    if not mp.exists():
        raise FileNotFoundError(f"no checkpoint {pt} or {mp}")
    state = _flax_msgpack_restore(mp.read_bytes())
    return jax_params_to_state_dict(state.get("params", state))


class CheckpointTriad:
    """best / latest / periodic checkpoints with the reference's names,
    written by `world`'s rank 0 only, each followed by a barrier of all
    ranks (no world: one process, no barrier)."""

    def __init__(self, model_dir: str | Path, period: int = 50,
                 world=None) -> None:
        self.model_dir = Path(model_dir)
        self.period = period
        self.world = world

    def path(self, name: str) -> Path:
        return self.model_dir / name

    def _save(self, name: str, **kw) -> None:
        if self.world is None or self.world.is_main:
            save_checkpoint(self.path(name), **kw)
        if self.world is not None:
            self.world.barrier()

    def on_best(self, **kw) -> None:
        self._save("model_best", **kw)

    def on_epoch_end(self, epoch: int, **kw) -> None:
        self._save("model_latest", epoch=epoch, **kw)
        if self.period and epoch % self.period == 0:
            self._save(f"model_epoch_{epoch}", epoch=epoch, **kw)

    def on_step(self, epoch: int, step_in_epoch: int, epoch_loss: float,
                **kw) -> None:
        """Mid-epoch checkpoint: model_latest with the step position; resume
        continues the same epoch at this step."""
        extra = dict(kw.pop("extra", {}) or {})
        extra.update({"step_in_epoch": int(step_in_epoch),
                      "epoch_loss": float(epoch_loss)})
        self._save("model_latest", epoch=epoch, extra=extra, **kw)

    def latest(self) -> Path | None:
        p = self.path("model_latest")
        return p if p.with_suffix(".pt").exists() else None
