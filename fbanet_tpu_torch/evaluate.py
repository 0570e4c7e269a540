"""Fixed-resolution evaluation with the reference's metric protocol
(counterpart of fbanet_tpu/evaluate.py).

    python -m fbanet_tpu_torch.evaluate --dataroot DIR --weights CKPT
        [reference flags] [--save_images --result_dir DIR] [--device cpu]
    torchrun --nproc_per_node W -m fbanet_tpu_torch.evaluate ...

The validation split at the training patch size, batched forward, clamp
to [0, 1], per-image PSNR and SSIM with a 40-pixel boundary crop, each
averaged as finite sum over the image count (`metrics.finite_average`, the
convention `train.evaluate_psnr` uses too). `--weights` reads the port's
`.pt` checkpoints and the JAX package's `.msgpack` ones.

Over ranks (torchrun, `parallel/mesh.py`) each rank evaluates its rows of
every batch of `EvalConfig.batch_size`, the last batch padded to it (the
JAX package's sharded eval); the per-image PSNR and SSIM are gathered in
the single-process order before the averages, and `--save_images` has each
rank write its own real rows' images, so each image is written once.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from fbanet_tpu_torch.config import Config, add_cli_args, from_cli
from fbanet_tpu_torch.data.loader import BurstLoader
from fbanet_tpu_torch.data.realbsr import RealBSRDataset
from fbanet_tpu_torch.metrics import finite_average, psnr, ssim, to_unit_f32
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.parallel import mesh
from fbanet_tpu_torch.train import gather_valid, resolve_device
from fbanet_tpu_torch.utils.checkpoint import load_params

LPIPS_PENDING = ("LPIPS is not ported yet (models/lpips.py, ROADMAP Queue 1 "
                 "item 8)")
RAW_PENDING = ("writing RAW (4-channel) predictions as images needs the RAW "
               "post-processing, which is not ported yet (utils/raw.py, "
               "ROADMAP Queue 1 item 8)")


@torch.no_grad()
def eval_step(model: torch.nn.Module, lr: torch.Tensor, hr: torch.Tensor, *,
              online_align: str = "none", boundary_ignore: int = 40,
              plain: bool = False):
    """One evaluation batch: `lr` bursts [B, F, H, W, C] and `hr` targets
    [B, 4H, 4W, C] (storage integers or floats) -> (pred clamped to [0, 1],
    per-image PSNR [B], per-image SSIM [B], hr in f32). `online_align`
    ("none", "ecc" or "flow") registers the bursts first, as
    `DataConfig.online_align` does. `plain=True` runs the fused operators'
    plain versions (a comparison, not the serving path)."""
    lr, hr = to_unit_f32(lr), to_unit_f32(hr)
    if online_align != "none":
        from fbanet_tpu_torch.ops.registration import online_register

        lr = online_register(lr, online_align)
    pred = torch.clamp(model(lr, plain=plain), 0.0, 1.0)
    return (pred, psnr(pred, hr, boundary_ignore=boundary_ignore),
            ssim(pred, hr, boundary_ignore=boundary_ignore), hr)


def save_rgb(path: Path, img: np.ndarray) -> None:
    """uint8 [H, W, 3] RGB -> PNG, through PIL where it is installed, else
    `data/png.py`."""
    try:
        from PIL import Image
    except ImportError:
        from fbanet_tpu_torch.data import png

        png.write_png(path, img)
        return
    Image.fromarray(img).save(path)


def evaluate(cfg: Config, *, save_images: bool = False,
             result_dir: str = "./results", lpips_weights: str | None = None,
             device: torch.device | str = "cuda") -> dict:
    """Evaluate `cfg.eval.weights` (or `cfg.train.pretrain_weights`) on the
    validation split, on `device`, over the ranks of torchrun's environment
    where there is one. Returns {'psnr', 'ssim', 'num_images', 'seconds'
    (the batches' wall time)}, the same on every rank."""
    device = resolve_device(device, "evaluate")
    if lpips_weights:
        raise NotImplementedError(LPIPS_PENDING)
    if save_images and cfg.data.channels == 4:
        raise NotImplementedError(RAW_PENDING)
    world, device = mesh.init(device)
    try:
        return _evaluate(cfg, save_images, result_dir, device, world)
    finally:
        world.close()


def _evaluate(cfg: Config, save_images: bool, result_dir: str,
              device: torch.device, world: mesh.World) -> dict:
    mesh.row_block(cfg.eval.batch_size, world.rank, world.size)
    model = create_model(cfg.model, device=device, seed=0)
    weights = cfg.eval.weights or cfg.train.pretrain_weights
    if weights:
        model.load_state_dict(load_params(weights, map_location=device),
                              strict=True)

    bi = cfg.eval.boundary_ignore
    # the crop must leave pixels (and SSIM's 11 px window) on small images
    if cfg.data.crop_size and cfg.data.crop_size * cfg.data.scale <= 2 * bi + 11:
        bi = 0

    ds = RealBSRDataset(cfg.data.dataroot, split="val", layout=cfg.data.layout,
                        burst_size=cfg.data.burst_size,
                        crop_size=cfg.data.crop_size,
                        channels=cfg.data.channels,
                        cache_decoded=cfg.data.cache_decoded,
                        wire_dtype=cfg.data.wire_dtype,
                        augment=False)
    # the host's decode threads, shared by its ranks
    loader = BurstLoader(ds, batch_size=cfg.eval.batch_size,
                         num_workers=cfg.data.eval_workers // world.local_size,
                         drop_last=False, device=device,
                         pad_last=world.size > 1, rank=world.rank,
                         world=world.size)

    out_dir = Path(result_dir)
    if save_images:
        out_dir.mkdir(parents=True, exist_ok=True)

    psnrs, ssims, valid = [], [], []
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        pred, p, s, _ = eval_step(model, batch["LR"], batch["HR"],
                                  online_align=cfg.data.online_align,
                                  boundary_ignore=bi)
        if world.size > 1:  # gathered over the ranks at the end
            psnrs.append(p)
            ssims.append(s.reshape(-1))
            valid.append(batch["valid"])
        else:
            psnrs.extend(p.cpu().tolist())
            ssims.extend(s.reshape(-1).cpu().tolist())
        if save_images:
            arr = torch.clamp(pred * 255.0 + 0.5, 0, 255).to(torch.uint8)
            for img, name in zip(arr.cpu().numpy(), batch["burst_name"]):
                save_rgb(out_dir / f"{name}.png", img)
    if world.size > 1 and valid:
        psnrs = gather_valid(world, torch.stack(psnrs), valid)
        ssims = gather_valid(world, torch.stack(ssims), valid)
    seconds = time.perf_counter() - t0

    results = {"psnr": finite_average(psnrs), "ssim": finite_average(ssims),
               "num_images": len(psnrs), "seconds": seconds}
    if world.is_main:
        print(f"PSNR: {results['psnr']:.4f}  SSIM: {results['ssim']:.4f}"
              f"  ({results['num_images']} images)")
    return results


def main(argv: list[str] | None = None) -> dict:
    parser = add_cli_args(argparse.ArgumentParser(
        description="FBANet evaluation (PyTorch port)"))
    parser.add_argument("--result_dir", type=str, default="./results")
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="LPIPS weights (.npz); not ported yet: raises")
    args = parser.parse_args(argv)
    return evaluate(from_cli(args), save_images=args.save_images,
                    result_dir=args.result_dir,
                    lpips_weights=args.lpips_weights or None,
                    device=args.device)


if __name__ == "__main__":
    main()
