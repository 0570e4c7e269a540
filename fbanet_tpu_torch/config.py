"""The port's own configuration dataclasses (counterpart of the model and
training parts of fbanet_tpu/config.py), with the same field names and
defaults, so a configuration written for the JAX package reads the same
here. The port imports nothing of the JAX package.

Left out, because the port does not read them:

- `ModelConfig.attention_impl` ("auto" / "xla" / "pallas"): the JAX
  package's choice between its Pallas kernel and composed XLA ops. The port
  has one path per device: the CUDA kernels on the card, their plain
  versions on the CPU.
- `ModelConfig.remat`: jax.checkpoint per SwinLayer. The port's fused
  operators already save only their inputs for the backward.
- `TrainConfig.donate_state` (XLA buffer donation) and
  `TrainConfig.profile_dir` (a jax.profiler trace).

`DataConfig`, `EvalConfig` and the command line (`add_cli_args`,
`from_cli`) come with the port's loader and CLIs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
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

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
