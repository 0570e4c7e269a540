"""Synthetic-data convergence proof (counterpart of
scripts/convergence_proof.py): train the real FBANet topology on a
synthetic RealBSR tree and record the per-epoch PSNR climb above the
bilinear-base starting point.

    python -m fbanet_tpu_torch.tools.convergence_proof [--out DIR]
        [--bursts 96 --frames 14 --lr_size 64 --epochs 60 --embed_dim 32
         --batch_size 8 --grad_accum 1 --noise 0.05] [--device cuda|cpu]

The zero-init `tail_conv` (`models/fbanet.py::init_parameters`) makes an
untrained model output exactly its bilinear base, so the base PSNR of the
val split is where training starts, and every dB above it is
super-resolution learned by the whole stack under the published recipe
(Charbonnier + 3 GW loss, AdamW, 3-epoch warmup + cosine). `--batch_size 8
--grad_accum 2` is the published global batch of 16 on one card; under
torchrun `--batch_size` is the global batch over the ranks.

The JAX script's flags and defaults, plus `--device`.

Writes the tree (once) and the training logs under `--out` (default
`build/convergence` at the repository root), the per-epoch `history.json`
there, and prints the table, the base, epoch 1's gap to it, the best PSNR
with its gain and the wall time with the device's name.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]


@torch.no_grad()
def bilinear_base_psnr(root: Path, *, frames: int, lr_size: int,
                       batch_size: int, device) -> float:
    """The val split's PSNR (boundary 40, finite average over the images)
    of frame 0 upsampled x4 bilinearly (`F.interpolate`, half-pixel
    centres: `jax.image.resize(..., "bilinear")` when upsampling, and the
    model's own base) and clamped to [0, 1]."""
    from fbanet_tpu_torch.data.loader import BurstLoader
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset
    from fbanet_tpu_torch.metrics import finite_average, psnr, to_unit_f32

    val = RealBSRDataset(root, split="val", burst_size=frames,
                         crop_size=lr_size, cache_decoded=True)
    loader = BurstLoader(val, batch_size=batch_size, num_workers=4,
                         drop_last=False, device=device)
    vals = []
    for batch in loader.epoch(0):
        lr, hr = to_unit_f32(batch["LR"]), to_unit_f32(batch["HR"])
        _, _, h, w, _ = lr.shape
        base = F.interpolate(lr[:, 0].permute(0, 3, 1, 2), size=(4 * h, 4 * w),
                             mode="bilinear", align_corners=False)
        base = torch.clamp(base.permute(0, 2, 3, 1), 0.0, 1.0)
        vals.extend(psnr(base, hr, boundary_ignore=40).cpu().tolist())
    return finite_average(vals, len(vals))


def main(argv: list[str] | None = None) -> dict:
    """Returns {'base', 'history', 'best_psnr', 'best_epoch', 'seconds' (the
    training's wall time), 'device' (the card's name, or "cpu")}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str,
                   default=str(ROOT / "build" / "convergence"))
    p.add_argument("--bursts", type=int, default=96)
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--lr_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--embed_dim", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step; --batch_size 8 "
                        "--grad_accum 2 is the published global batch of 16 "
                        "on one card")
    p.add_argument("--noise", type=float, default=0.05,
                   help="per-frame noise sigma; higher gives the 14-frame "
                        "fusion more signal to recover")
    p.add_argument("--markdown", type=str, default="",
                   help="write the history table here")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from fbanet_tpu_torch.config import add_cli_args, from_cli
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr
    from fbanet_tpu_torch.train import resolve_device, train

    device = resolve_device(args.device, "convergence_proof")
    out = Path(args.out)
    ds = out / "ds"
    if not ds.exists():
        write_synthetic_realbsr(ds, num_bursts=args.bursts,
                                num_frames=args.frames, lr_size=args.lr_size,
                                seed=7, noise=args.noise)
        print(f"wrote synthetic tree: {ds}")
    base = bilinear_base_psnr(ds, frames=args.frames, lr_size=args.lr_size,
                              batch_size=args.batch_size, device=device)
    print(f"bilinear-base PSNR (val): {base:.4f} dB")

    cfg = from_cli(add_cli_args(argparse.ArgumentParser()).parse_args([
        "--dataroot", str(ds),
        "--train_ps", str(args.lr_size),
        "--embed_dim", str(args.embed_dim),
        "--batch_size", str(args.batch_size),
        "--grad_accum", str(args.grad_accum),
        "--burst_size", str(args.frames),
        "--nepoch", str(args.epochs),
        "--warmup", "--warmup_epochs", "3",
        "--warm_start",
        "--save_dir", str(out / "log"),
        "--env", "_convergence",
        "--train_workers", "4", "--eval_workers", "4",
    ]))
    t0 = time.perf_counter()
    result = train(cfg, device=device)
    seconds = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    hist = [{k: v for k, v in h.items() if k not in ("step_s", "data_wait_s")}
            for h in result["history"]]
    (out / "history.json").write_text(json.dumps(hist, indent=1))
    lines = ["| epoch | loss | PSNR (dB) | gain over base | lr |",
             "|---|---|---|---|---|"]
    for h in hist:
        if h.get("psnr") is None:
            lines.append(f"| {h['epoch']} | {h['loss']:.3f} | - | - "
                         f"| {h['lr']:.2e} |")
        else:
            lines.append(f"| {h['epoch']} | {h['loss']:.3f} | {h['psnr']:.3f} "
                         f"| {h['psnr'] - base:+.3f} | {h['lr']:.2e} |")
    table = "\n".join(lines)
    print(table)
    first = hist[0]["psnr"] if hist else None
    print(f"bilinear-base PSNR: {base:.4f} dB; epoch 1: "
          + ("-" if first is None else f"{first:.4f} dB "
             f"({first - base:+.2e} dB from the base)"))
    print(f"best PSNR {result['best_psnr']:.4f} dB at epoch "
          f"{result['best_epoch']} ({result['best_psnr'] - base:+.4f} dB over "
          f"the bilinear base); {args.epochs} epochs in {seconds:.1f} s on "
          f"{name}")
    if args.markdown:
        Path(args.markdown).write_text(table + "\n")
    return {"base": base, "history": hist, "best_psnr": result["best_psnr"],
            "best_epoch": result["best_epoch"], "seconds": seconds,
            "device": name}


if __name__ == "__main__":
    main()
