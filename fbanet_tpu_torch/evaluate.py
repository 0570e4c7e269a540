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

`--save_images` writes each prediction as a PNG through `display_uint8`
(RGB rounded to 8 bits; a RAW packed-Bayer prediction through the
reference's post-processing, `utils/raw.py`, collapsed to RGB).
`--lpips_weights FILE.npz` adds the per-image LPIPS of the prediction
against the target at the same boundary crop (`models/lpips.py`), averaged
and gathered as PSNR and SSIM are.
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
from fbanet_tpu_torch.utils.raw import postprocess_raw, to_uint8

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


def display_uint8(pred: torch.Tensor | np.ndarray) -> np.ndarray:
    """Predictions `[..., H, W, C]` in [0, 1] -> uint8 display images on
    the host: RGB as round(x 255); RAW (C = 4, packed Bayer) through the
    reference's post-processing with the greens averaged to RGB
    (`postprocess_raw(..., return_rgb=True)`, whose brightness
    normalisation reads the mean of everything passed in one call)."""
    pred = torch.as_tensor(pred)
    if pred.shape[-1] == 4:
        return to_uint8(postprocess_raw(pred, return_rgb=True))
    return torch.clamp(pred * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu(
    ).numpy()


def evaluate(cfg: Config, *, save_images: bool = False,
             result_dir: str = "./results", lpips_weights: str | None = None,
             device: torch.device | str = "cuda") -> dict:
    """Evaluate `cfg.eval.weights` (or `cfg.train.pretrain_weights`) on the
    validation split, on `device`, over the ranks of torchrun's environment
    where there is one. Returns {'psnr', 'ssim', 'num_images', 'seconds'
    (the batches' wall time)} and, with `lpips_weights`, 'lpips', the same
    on every rank."""
    device = resolve_device(device, "evaluate")
    world, device = mesh.init(device)
    try:
        return _evaluate(cfg, save_images, result_dir, lpips_weights, device,
                         world)
    finally:
        world.close()


def _evaluate(cfg: Config, save_images: bool, result_dir: str,
              lpips_weights: str | None, device: torch.device,
              world: mesh.World) -> dict:
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
    lpips_model = None
    if lpips_weights:
        from fbanet_tpu_torch.models.lpips import load_lpips

        lpips_model = load_lpips(lpips_weights).to(device)

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

    metrics = {"psnr": [], "ssim": []}
    if lpips_model is not None:
        metrics["lpips"] = []
    valid = []
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        pred, p, s, hr = eval_step(model, batch["LR"], batch["HR"],
                                   online_align=cfg.data.online_align,
                                   boundary_ignore=bi)
        per_image = {"psnr": p, "ssim": s.reshape(-1)}
        if lpips_model is not None:
            per_image["lpips"] = lpips_model(pred, hr, boundary_ignore=bi)
        for k, v in per_image.items():
            if world.size > 1:  # gathered over the ranks at the end
                metrics[k].append(v)
            else:
                metrics[k].extend(v.cpu().tolist())
        if world.size > 1:
            valid.append(batch["valid"])
        if save_images:
            names = batch["burst_name"]
            for img, name in zip(display_uint8(pred[:len(names)]), names):
                save_rgb(out_dir / f"{name}.png", img)
    if world.size > 1 and valid:
        metrics = {k: gather_valid(world, torch.stack(v), valid)
                   for k, v in metrics.items()}
    seconds = time.perf_counter() - t0

    results = {k: finite_average(v) for k, v in metrics.items()}
    results.update(num_images=len(metrics["psnr"]), seconds=seconds)
    if world.is_main:
        line = f"PSNR: {results['psnr']:.4f}  SSIM: {results['ssim']:.4f}"
        if "lpips" in results:
            line += f"  LPIPS: {results['lpips']:.4f}"
        print(line + f"  ({results['num_images']} images)")
    return results


def main(argv: list[str] | None = None) -> dict:
    parser = add_cli_args(argparse.ArgumentParser(
        description="FBANet evaluation (PyTorch port)"))
    parser.add_argument("--result_dir", type=str, default="./results")
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="LPIPS weights (.npz, the JAX package's "
                             "layout): adds per-image LPIPS")
    args = parser.parse_args(argv)
    return evaluate(from_cli(args), save_images=args.save_images,
                    result_dir=args.result_dir,
                    lpips_weights=args.lpips_weights or None,
                    device=args.device)


if __name__ == "__main__":
    main()
