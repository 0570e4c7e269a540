"""The port's own configuration tree and command line (counterpart of
fbanet_tpu/config.py), with the same field names, flags and defaults, so a
configuration or a command line written for the JAX package reads the same
here. The port imports nothing of the JAX package.

Left out, because the port does not read them:

- `ModelConfig.attention_impl` ("auto" / "xla" / "pallas"): the JAX
  package's choice between its Pallas kernels and composed XLA ops. The
  port routes by JAX's own predicates instead: a SwinLayer whose options
  JAX fuses (`_use_fused_attention`) runs the fused operators, the CUDA
  kernels on the card and their plain versions on the CPU, and a window
  shape JAX's kernel does not take (`_supported`) runs the composed
  branch; every other configuration runs composed PyTorch ops
  (`models/layers.py`).
- `ModelConfig.remat`: jax.checkpoint per SwinLayer. The port's fused
  operators already save only their inputs for the backward.
- `TrainConfig.donate_state` (XLA buffer donation).

`TrainConfig.profile_dir` traces the first epoch with torch.profiler
(`utils/profiling.py::trace`, a Chrome trace in `<profile_dir>/trace.json`)
where the JAX package takes a jax.profiler trace.

The command line has two flags the JAX one lacks: `--device` (default
`cuda`), where the entry points run, and `--profile_dir`, which sets that
field (the JAX package's field has no flag). `--device` is not a field of
`Config`: the CLIs hand it to `train()`, `evaluate()` and
`tiled_forward()`.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Literal


@dataclass(frozen=True)
class ModelConfig:
    """FBANet model hyperparameters (fbanet_tpu/config.py:20-57)."""

    num_frames: int = 14
    img_size: int = 160
    in_channels: int = 3
    embed_dim: int = 32
    depths: tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2, 2, 2)
    heads: tuple[int, ...] = (1, 2, 4, 8, 16, 16, 8, 4, 2)
    window_size: int = 8
    mlp_ratio: float = 4.0
    use_qkv_bias: bool = True
    qk_scale: float | None = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    token_projection: Literal["linear", "conv"] = "linear"
    token_mlp: Literal["ffn", "leff"] = "leff"
    use_se_layer: bool = False
    dtype: str = "bfloat16"  # compute dtype inside the network
    param_dtype: str = "float32"  # parameter/optimizer dtype

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DataConfig:
    """RealBSR data pipeline (fbanet_tpu/config.py:60-112)."""

    dataroot: str = ""
    burst_size: int = 14
    crop_size: int = 160  # LR patch size (--train_ps)
    scale: int = 4
    # 3 = RealBSR-RGB (8-bit PNG / 255); 4 = RealBSR-RAW packed-Bayer RGGB
    # (16-bit 4-channel PNG / 16383)
    channels: int = 3
    # decode each burst once, then assemble samples from the RAM cache
    cache_decoded: bool = True
    cache_gb: float = 8.0
    # fill the decoded-frame cache before step 1 (when the cache is on)
    warm_start: bool = True
    # host -> device wire: "storage" ships the PNG integers and normalises
    # on the device (bit-identical to "float32", a quarter of the bytes)
    wire_dtype: Literal["storage", "float32"] = "storage"
    seed: int = 0
    num_workers: int = 16
    eval_workers: int = 8
    prefetch_depth: int = 2
    shard_id: int = 0
    num_shards: int = 1
    # registration inside the train / eval step; "none" expects the
    # pre-aligned LR_aligned tree
    online_align: Literal["none", "ecc", "flow"] = "none"
    # filename grammar: "aligned" (LR_aligned/ + HR/) or "warp" (one
    # directory per burst)
    layout: Literal["aligned", "warp"] = "aligned"

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training recipe (fbanet_tpu/config.py:115-171). The published run
    used batch_size=16, nepoch=200, embed_dim=64, warmup=True."""

    batch_size: int = 32
    nepoch: int = 250
    optimizer: Literal["adam", "adamw"] = "adamw"
    lr_initial: float = 1e-4
    weight_decay: float = 0.02
    warmup: bool = False
    warmup_epochs: int = 3
    cosine_eta_min: float = 1e-6
    step_lr_step: int = 50
    step_lr_gamma: float = 0.5
    checkpoint_every: int = 50
    save_every_steps: int = 0
    stop_after_steps: int = 0
    # each optimizer step averages the gradients of this many microbatches
    grad_accum: int = 1
    eval_every_epochs: int = 1
    gw_loss_weight: float = 3.0  # loss = charbonnier + 3 * GW loss
    charbonnier_eps: float = 1e-3
    mixup: bool = False
    mixup_alpha: float = 1.2
    seed: int = 1234
    save_dir: str = "./log"
    env: str = "_"
    arch: str = "BaseModel"
    resume: bool = False
    pretrain_weights: str = ""
    grad_clip_norm: float = 0.0  # 0 = off
    profile_dir: str = ""  # a torch.profiler trace of the first epoch here

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation settings (fbanet_tpu/config.py:174-189)."""

    weights: str = ""
    batch_size: int = 16
    save_images: bool = False
    result_dir: str = "./results"
    boundary_ignore: int = 40
    # overlap-tile inference (LR space); merge uses psize*scale / overlap*scale
    tile_psize: int = 80
    tile_overlap: int = 40

    def replace(self, **kw) -> "EvalConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def add_cli_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's flag names (fbanet_tpu/config.py:203-258), plus
    `--device`."""
    p = parser
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--nepoch", type=int, default=250)
    p.add_argument("--train_workers", type=int, default=16)
    p.add_argument("--eval_workers", type=int, default=8)
    p.add_argument("--dataroot", type=str, default="")
    p.add_argument("--pretrain_weights", type=str, default="")
    p.add_argument("--optimizer", type=str, default="adamw")
    p.add_argument("--lr_initial", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.02)
    p.add_argument("--arch", type=str, default="BaseModel")
    p.add_argument("--save_dir", type=str, default="./log")
    p.add_argument("--save_images", action="store_true", default=False)
    p.add_argument("--env", type=str, default="_")
    p.add_argument("--checkpoint", type=int, default=50)
    p.add_argument("--save_every_steps", type=int, default=0)
    p.add_argument("--embed_dim", type=int, default=32)
    p.add_argument("--win_size", type=int, default=8)
    p.add_argument("--token_projection", type=str, default="linear")
    p.add_argument("--token_mlp", type=str, default="leff")
    p.add_argument("--att_se", action="store_true", default=False)
    p.add_argument("--train_ps", type=int, default=160)
    p.add_argument("--burst_size", type=int, default=14)
    p.add_argument("--in_channels", type=int, default=3, choices=[3, 4],
                   help="3 = RealBSR-RGB; 4 = RealBSR-RAW packed Bayer "
                        "(16-bit PNGs, /16383)")
    p.add_argument("--no_cache_decoded", action="store_true", default=False,
                   help="disable the decoded-frame RAM cache")
    p.add_argument("--cache_gb", type=float, default=8.0)
    p.add_argument("--warm_start", action="store_true", default=True,
                   help="pre-fill the decoded-frame cache before step 1 "
                        "(default on when the cache is on)")
    p.add_argument("--no_warm_start", action="store_true", default=False,
                   help="skip the pre-training cache warm pass")
    p.add_argument("--wire_f32", action="store_true", default=False,
                   help="ship normalized f32 batches to the device instead "
                        "of the storage integers (4x the transfer bytes; "
                        "bit-identical results)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="average grads over N consecutive batches per "
                        "optimizer step (global batch = N * batch_size)")
    p.add_argument("--online_align", type=str, default="none",
                   choices=["none", "ecc", "flow"])
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--mixup", action="store_true", default=False)
    p.add_argument("--warmup", action="store_true", default=False)
    p.add_argument("--warmup_epochs", type=int, default=3)
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch "
                        "(trace.json) to this directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: cuda (the default; raises without a "
                        "CUDA device) or cpu")
    return p


def from_cli(args: argparse.Namespace) -> Config:
    """The typed config from parsed reference-style flags
    (fbanet_tpu/config.py:261-307). `args.device` is not part of it."""
    model = ModelConfig(
        num_frames=args.burst_size,
        img_size=args.train_ps,
        in_channels=args.in_channels,
        embed_dim=args.embed_dim,
        window_size=args.win_size,
        token_projection=args.token_projection,
        token_mlp=args.token_mlp,
        use_se_layer=args.att_se,
        dtype=args.dtype,
    )
    data = DataConfig(
        dataroot=args.dataroot,
        online_align=args.online_align,
        burst_size=args.burst_size,
        crop_size=args.train_ps,
        channels=args.in_channels,
        cache_decoded=not args.no_cache_decoded,
        cache_gb=args.cache_gb,
        warm_start=args.warm_start and not args.no_warm_start,
        wire_dtype="float32" if args.wire_f32 else "storage",
        num_workers=args.train_workers,
        eval_workers=args.eval_workers,
    )
    train = TrainConfig(
        batch_size=args.batch_size,
        nepoch=args.nepoch,
        optimizer=args.optimizer,
        lr_initial=args.lr_initial,
        weight_decay=args.weight_decay,
        warmup=args.warmup,
        warmup_epochs=args.warmup_epochs,
        checkpoint_every=args.checkpoint,
        save_every_steps=args.save_every_steps,
        grad_accum=args.grad_accum,
        save_dir=args.save_dir,
        env=args.env,
        arch=args.arch,
        resume=args.resume,
        mixup=args.mixup,
        pretrain_weights=args.pretrain_weights,
        seed=args.seed,
        profile_dir=args.profile_dir,
    )
    ev = EvalConfig(weights=args.weights, save_images=args.save_images)
    return Config(model=model, data=data, train=train, eval=ev)
