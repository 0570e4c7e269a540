"""Import a legacy torch FBANet checkpoint (.pth) into the port's format
(counterpart of scripts/import_torch_checkpoint.py).

    python -m fbanet_tpu_torch.tools.import_torch_checkpoint model_best.pth \\
        OUT [--embed_dim 64 --train_ps 160 --win_size 8 --burst_size 14 \\
        --in_channels 3] \\
        [--map_json rename.json] [--device cpu]

The published checkpoint is a torch state_dict saved by the legacy trainer
as {"epoch", "state_dict", "optimizer"} with DataParallel's "module."
prefix (fba_net/train.py.bak:199-246, fba_net/utils/model_utils.py:22-38);
a bare state_dict is read too. The prefix is stripped, `--map_json`
({"legacy.name": "our.name"}) renames keys, and the result loads into
`create_model` with `strict=True`. A load that does not cover the model
fails listing the missing names, the unexpected ones and any shape
mismatch side by side; nothing is matched by shape (dozens of this model's
convs share a shape). The model is written through
`utils/checkpoint.py::save_checkpoint` as OUT.pt / OUT.json, with
`imported_from` in the metadata; `evaluate --weights OUT` reads it.

The layout question: a legacy .pth holds torch layouts, and so does the
port, so no tensor is transposed here. The port's names and layouts are
the canonical torch ones of fbanet_tpu/utils/torch_io.py: its importer
transposes for flax only (Conv OIHW -> HWIO, ConvTranspose [I, O, kh, kw]
flipped, Linear [O, I] -> [I, O], PReLU [1] -> scalar), and the port's
`Conv`, `ConvTranspose` (torch's conv_transpose2d convention), `Linear`
and `PReLU` parameters keep the torch side of each rule
(`utils/weights.py`).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from fbanet_tpu_torch.config import ModelConfig
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.train import resolve_device
from fbanet_tpu_torch.utils.checkpoint import save_checkpoint


def legacy_state_dict(state: dict, rename: dict[str, str] | None = None
                      ) -> dict[str, torch.Tensor]:
    """The model tensors of a legacy checkpoint (`{"state_dict": ...}` or a
    bare state_dict), DataParallel's "module." stripped, then renamed."""
    sd = state.get("state_dict", state)
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")  # model_utils.py:28-38
        if rename and k in rename:
            k = rename[k]
        out[k] = torch.as_tensor(v)
    return out


def check_covers(model: torch.nn.Module, sd: dict[str, torch.Tensor]) -> None:
    """Raise KeyError unless `sd` has exactly the model's names at its
    shapes, listing the missing, the unexpected and the mismatched."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    shapes = sorted(k for k in set(want) & set(sd)
                    if tuple(want[k].shape) != tuple(sd[k].shape))
    if not (missing or unexpected or shapes):
        return
    lines = ["legacy checkpoint does not cover the model (map the names "
             "with --map_json):"]
    width = max((len(k) for k in missing), default=0)
    for i in range(max(len(missing), len(unexpected))):
        m = (f"{missing[i]} {tuple(want[missing[i]].shape)}"
             if i < len(missing) else "")
        u = (f"{unexpected[i]} {tuple(sd[unexpected[i]].shape)}"
             if i < len(unexpected) else "")
        lines.append(f"  MISSING {m:<{width + 16}}  UNEXPECTED {u}")
    lines += [f"  SHAPE   {k}: checkpoint {tuple(sd[k].shape)}, model "
              f"{tuple(want[k].shape)}" for k in shapes]
    raise KeyError("\n".join(lines))


def import_checkpoint(torch_ckpt: str | Path, out_path: str | Path,
                      cfg: ModelConfig, *, rename: dict[str, str] | None = None,
                      device: torch.device | str = "cuda") -> torch.nn.Module:
    """Read `torch_ckpt`, load it strictly into the port's model of `cfg`
    on `device`, write `out_path` and return the model."""
    device = resolve_device(device, "import_torch_checkpoint")
    state = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
    sd = legacy_state_dict(state, rename)
    model = create_model(cfg, device=device)
    check_covers(model, sd)
    model.load_state_dict(sd, strict=True)
    save_checkpoint(out_path, params=model.state_dict(), opt_state={},
                    epoch=int(state.get("epoch", 0)),
                    extra={"imported_from": str(torch_ckpt)})
    return model


def main(argv: list[str] | None = None) -> torch.nn.Module:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("torch_ckpt")
    p.add_argument("out_path")
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--train_ps", type=int, default=160)
    p.add_argument("--win_size", type=int, default=8)
    p.add_argument("--burst_size", type=int, default=14)
    p.add_argument("--in_channels", type=int, default=3, choices=[3, 4])
    p.add_argument("--map_json", type=str, default="",
                   help="JSON file mapping legacy keys to the port's names")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model is built and loaded (cuda or cpu)")
    args = p.parse_args(argv)
    cfg = ModelConfig(num_frames=args.burst_size, img_size=args.train_ps,
                      embed_dim=args.embed_dim, window_size=args.win_size,
                      in_channels=args.in_channels, dtype="float32")
    rename = (json.loads(Path(args.map_json).read_text())
              if args.map_json else None)
    model = import_checkpoint(args.torch_ckpt, args.out_path, cfg,
                              rename=rename, device=args.device)
    print(f"imported {len(model.state_dict())} tensors into "
          f"{args.out_path}.pt; check it with `python -m "
          f"fbanet_tpu_torch.evaluate --weights {args.out_path} ...`")
    return model


if __name__ == "__main__":
    main()
