"""Overlap-tile any-resolution inference (counterpart of fbanet_tpu/tiled.py).

    python -m fbanet_tpu_torch.tiled --dataroot DIR --weights CKPT
        [--psize 80 --overlap 40 --result_dir DIR] [--device cpu]
    torchrun --nproc_per_node W -m fbanet_tpu_torch.tiled ...

The reference's `test_in_any_resolution.py` semantics: reflect-pad each
burst to a multiple of `psize` (LR space), cut tiles of psize + 2 * overlap
with a reflected halo, super-resolve them, keep each tile's centre and
stitch at psize * scale. All tiles of an image go through the model as one
batch (or batches of `tile_batch`); with psize 80 and overlap 40 a tile is
160 px, the training patch size. Over ranks (torchrun, `parallel/mesh.py`;
JAX's `tiled_forward(..., mesh=...)`) each batch of tiles is padded to a
multiple of the world size and split into row blocks, the HR tiles are
gathered, and rank 0 alone merges and writes.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from fbanet_tpu_torch.config import add_cli_args, from_cli
from fbanet_tpu_torch.data.realbsr import RealBSRDataset
from fbanet_tpu_torch.evaluate import RAW_PENDING, save_rgb
from fbanet_tpu_torch.metrics import to_unit_f32
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.parallel import mesh
from fbanet_tpu_torch.train import resolve_device
from fbanet_tpu_torch.utils.checkpoint import load_params


def compute_tile_layout(h: int, w: int, psize: int) -> tuple[int, int, int, int]:
    """(h_pad, w_pad, n_tiles_h, n_tiles_w) of the reflect-padded grid."""
    h_pad = (psize - h % psize) % psize
    w_pad = (psize - w % psize) % psize
    return h_pad, w_pad, (h + h_pad) // psize, (w + w_pad) // psize


def divide_burst(burst: np.ndarray, psize: int, overlap: int) -> np.ndarray:
    """[F, H, W, C] -> [Nt, F, psize + 2 overlap, psize + 2 overlap, C]:
    reflect-pad to a multiple of `psize` (bottom / right), then an
    `overlap` halo on every side, tiles row-major."""
    f, h, w, c = burst.shape
    h_pad, w_pad, nh, nw = compute_tile_layout(h, w, psize)
    x = np.pad(burst, ((0, 0), (0, h_pad), (0, w_pad), (0, 0)), mode="reflect")
    x = np.pad(x, ((0, 0), (overlap, overlap), (overlap, overlap), (0, 0)),
               mode="reflect")
    t = psize + 2 * overlap
    tiles = [x[:, i * psize:i * psize + t, j * psize:j * psize + t]
             for i in range(nh) for j in range(nw)]
    return np.stack(tiles)


def merge_tiles(tiles: np.ndarray, out_h: int, out_w: int, psize: int,
                overlap: int) -> np.ndarray:
    """[Nt, T, T, C] tiles -> [out_h, out_w, C]: each tile's centre, laid
    row-major, the padding cropped. `psize` / `overlap` are in output
    space."""
    _, t, _, c = tiles.shape
    if t != psize + 2 * overlap:
        raise ValueError(f"tile size {t} != psize {psize} + 2 x overlap "
                         f"{overlap}")
    h_pad, w_pad, nh, nw = compute_tile_layout(out_h, out_w, psize)
    canvas = np.zeros((out_h + h_pad, out_w + w_pad, c), tiles.dtype)
    for idx in range(tiles.shape[0]):
        i, j = divmod(idx, nw)
        center = tiles[idx, overlap:overlap + psize, overlap:overlap + psize]
        canvas[i * psize:(i + 1) * psize, j * psize:(j + 1) * psize] = center
    return canvas[:out_h, :out_w]


def tiled_forward(apply_fn, burst: np.ndarray, *, psize: int = 80,
                  overlap: int = 40, scale: int = 4, tile_batch: int = 0,
                  device: torch.device | str = "cuda",
                  world: mesh.World | None = None) -> np.ndarray | None:
    """Run `apply_fn` ([B, F, t, t, C] tensor on `device` -> [B, t*scale,
    t*scale, C]) over every tile of one burst `[F, H, W, C]` and stitch the
    x`scale` result (numpy). `tile_batch` > 0 caps the batch; the last batch
    is then padded to it (and the padding dropped). With a `world` of W
    ranks each batch is padded to a multiple of W, every rank runs its row
    block and the HR tiles are gathered; rank 0 returns the stitched image,
    the other ranks None."""
    device = resolve_device(device, "tiled_forward")
    world = world or mesh.World()
    f, h, w, c = burst.shape
    tiles = divide_burst(burst, psize, overlap)
    nt = tiles.shape[0]
    bsz = tile_batch if tile_batch > 0 else nt
    outs = []
    for start in range(0, nt, bsz):
        chunk = tiles[start:start + bsz]
        target = mesh.pad_to_multiple(bsz if tile_batch > 0
                                      else chunk.shape[0], world.size)
        pad = target - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        with torch.no_grad():
            out = apply_fn(torch.from_numpy(chunk[world.rows(target)])
                           .to(device))
            out = world.gather(out.float())
        out = out.cpu().numpy()
        outs.append(out[:out.shape[0] - pad])
    if not world.is_main:
        return None
    hr_tiles = np.concatenate(outs)
    return merge_tiles(hr_tiles, h * scale, w * scale, psize * scale,
                       overlap * scale)


def main(argv: list[str] | None = None) -> list[Path]:
    """CLI parity with the reference's `test_in_any_resolution.py`: every
    burst of the test split (GT-free trees too), one PNG each, over the
    ranks of torchrun's environment where there is one. Returns the files
    written (none on ranks other than 0)."""
    parser = add_cli_args(argparse.ArgumentParser(
        description="tiled inference (PyTorch port)"))
    parser.add_argument("--psize", type=int, default=80)
    parser.add_argument("--overlap", type=int, default=40)
    parser.add_argument("--result_dir", type=str, default="./results_tiled")
    args = parser.parse_args(argv)
    cfg = from_cli(args)
    device = resolve_device(args.device, "tiled")
    if cfg.data.channels == 4:
        raise NotImplementedError(RAW_PENDING)
    world, device = mesh.init(device)
    try:
        return _tile_tree(args, cfg, device, world)
    finally:
        world.close()


def _tile_tree(args, cfg, device: torch.device,
               world: mesh.World) -> list[Path]:
    tile = args.psize + 2 * args.overlap
    model = create_model(cfg.model.replace(img_size=tile), device=device,
                         seed=0)
    weights = cfg.eval.weights or cfg.train.pretrain_weights
    if weights:
        model.load_state_dict(load_params(weights, map_location=device),
                              strict=True)

    def apply_fn(batch):
        return torch.clamp(model(to_unit_f32(batch)), 0.0, 1.0)

    online_align = cfg.data.online_align
    if online_align != "none":
        from fbanet_tpu_torch.ops.registration import online_register

    ds = RealBSRDataset(cfg.data.dataroot, split="test", layout=cfg.data.layout,
                        burst_size=cfg.data.burst_size, crop_size=0,
                        channels=cfg.data.channels, augment=False,
                        wire_dtype=cfg.data.wire_dtype)
    out_dir = Path(args.result_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i in range(len(ds)):
        sample = ds.load(i)
        lr = sample["LR"]
        if online_align != "none":
            # register the whole burst to frame 0 before tiling, so every
            # tile shares one transform per frame
            with torch.no_grad():
                full = to_unit_f32(torch.from_numpy(lr).to(device))[None]
                lr = online_register(full, online_align)[0].cpu().numpy()
        sr = tiled_forward(apply_fn, lr, psize=args.psize,
                           overlap=args.overlap, scale=cfg.data.scale,
                           device=device, world=world)
        if sr is None:  # rank 0 writes
            continue
        arr = np.clip(sr * 255.0 + 0.5, 0, 255).astype(np.uint8)
        path = out_dir / f"{sample['burst_name']}.png"
        save_rgb(path, arr)
        written.append(path)
        print(f"[{i + 1}/{len(ds)}] {sample['burst_name']} -> {arr.shape}")
    return written


if __name__ == "__main__":
    main()
