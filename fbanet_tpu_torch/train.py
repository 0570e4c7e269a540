"""The training step of the port (counterpart of fbanet_tpu/train.py:54-238).

- `lr_for_epoch`: the reference's warmup -> cosine / StepLR / resumed-cosine
  schedules as executed, exactly as in the JAX package.
- `make_optimizer`: AdamW (or Adam) with betas 0.9 / 0.999, eps 1e-8 and
  decoupled weight decay, the torch form of `optax.adamw` / `optax.adam`.
- `clip_by_global_norm_`: `optax.clip_by_global_norm` (no epsilon added to
  the norm, unlike `torch.nn.utils.clip_grad_norm_`).
- `set_lr`: the learning rate of the next step, through `param_groups` (the
  JAX package injects it into the optimizer state).
- `mixup` and `make_train_step`: the loss (clamp, Charbonnier + 3 x GW),
  optional online registration and mixup, stochastic depth drawn from an
  explicit generator, gradient accumulation as the mean of microbatch
  gradients, clipping and the optimizer update.

The epoch loop `train()`, the RealBSR loader and the checkpoint triad are
not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fbanet_tpu_torch.config import TrainConfig
from fbanet_tpu_torch.losses import fbanet_training_loss
from fbanet_tpu_torch.metrics import to_unit_f32


def lr_for_epoch(epoch: int, cfg: TrainConfig, *, start_epoch: int = 1,
                 resumed: bool = False,
                 resumed_base: float | None = None) -> float:
    """Learning rate for 1-indexed `epoch` (fbanet_tpu/train.py:54-97, which
    explains the realized, not textbook, cosine after warmup)."""
    base, emin = cfg.lr_initial, cfg.cosine_eta_min
    if resumed:
        if resumed_base is not None:
            base = resumed_base
        t_max = max(1, cfg.nepoch - start_epoch + 1)
        t = epoch - start_epoch  # first resumed epoch trains at the restored LR
        return emin + (base - emin) * (1 + math.cos(math.pi * t / t_max)) / 2
    if cfg.warmup:
        if epoch <= cfg.warmup_epochs:
            return base * epoch / cfg.warmup_epochs
        t = epoch - cfg.warmup_epochs - 1
        t_max = max(1, cfg.nepoch - cfg.warmup_epochs)
        if t_max == 1:  # single post-warmup epoch: 1+cos(pi/T) degenerates
            return base
        return emin + (base - emin) * ((1 + math.cos(math.pi * t / t_max))
                                       / (1 + math.cos(math.pi / t_max)))
    return base * (cfg.step_lr_gamma ** (epoch // cfg.step_lr_step))


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Optimizer:
    """AdamW (decoupled weight decay `cfg.weight_decay`) or Adam, betas
    0.9 / 0.999, eps 1e-8, at `cfg.lr_initial` (train.py:100-109)."""
    kind = cfg.optimizer.lower()
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr_initial, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if kind == "adam":
        return torch.optim.Adam(params, lr=cfg.lr_initial, betas=(0.9, 0.999),
                                eps=1e-8)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next step (train.py:112-133)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the `.grad` of `params`, in place: when
    the global norm sqrt(sum g^2) is at least `max_norm`, every gradient
    becomes g / norm * max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm.to(g.dtype) * max_norm, g))


def mixup(hr: torch.Tensor, lr_burst: torch.Tensor, lam: torch.Tensor,
          indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mix each sample with a permuted partner, one lambda per sample, the
    same for the HR target and the LR burst (train.py:152-161)."""
    lam_hr = lam.reshape((-1,) + (1,) * (hr.dim() - 1))
    lam_lr = lam.reshape((-1,) + (1,) * (lr_burst.dim() - 1))
    hr_mix = lam_hr * hr + (1.0 - lam_hr) * hr[indices]
    lr_mix = lam_lr * lr_burst + (1.0 - lam_lr) * lr_burst[indices]
    return hr_mix, lr_mix


def _mixup_draws(b: int, alpha: float, generator: torch.Generator,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample lambda ~ Beta(alpha, alpha) and a permutation, both from
    `generator`. torch draws no Beta variates from a generator, so lambda
    comes from numpy seeded by one draw of the generator."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    lam = np.random.default_rng(seed).beta(alpha, alpha, b).astype(np.float32)
    idx = torch.randperm(b, generator=generator, device=generator.device)
    return torch.from_numpy(lam).to(device), idx.to(device)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: TrainConfig, online_align: str = "none",
                    plain: bool = False):
    """(lr_burst, hr, generator, lr) -> loss, one optimizer step
    (train.py:179-238). With `cfg.grad_accum` > 1, `lr_burst` and `hr` are
    tuples of that many microbatches and the step uses the mean of their
    gradients (and returns the mean of their losses). `generator` draws the
    stochastic-depth masks (and mixup's lambda and permutation). `plain=True`
    runs the fused operators' plain versions (the kernel-vs-plain
    comparison). The step's `loss_fn(lr_burst, hr, generator)` is the
    differentiable loss of one microbatch."""
    if online_align != "none":
        from fbanet_tpu_torch.ops.registration import online_register

    params = [p for p in model.parameters() if p.requires_grad]
    ga = max(1, int(cfg.grad_accum))

    def loss_fn(lr_burst, hr, generator):
        lr_burst, hr = to_unit_f32(lr_burst), to_unit_f32(hr)
        if cfg.mixup:
            lam, idx = _mixup_draws(lr_burst.shape[0], cfg.mixup_alpha,
                                    generator, lr_burst.device)
            hr, lr_burst = mixup(hr, lr_burst, lam, idx)
        if online_align != "none":
            lr_burst = online_register(lr_burst, online_align)
        pred = model(lr_burst, plain=plain, train=True, generator=generator)
        return fbanet_training_loss(pred, hr,
                                    charbonnier_eps=cfg.charbonnier_eps,
                                    gw_weight=cfg.gw_loss_weight)

    def step(lr_burst, hr, generator: torch.Generator, lr: float):
        optimizer.zero_grad(set_to_none=True)
        if ga == 1:
            loss = loss_fn(lr_burst, hr, generator)
            loss.backward()
            loss = loss.detach()
        else:
            if len(lr_burst) != ga or len(hr) != ga:
                raise ValueError(f"grad_accum={ga} needs {ga} microbatches")
            loss = 0.0
            for lb, h in zip(lr_burst, hr):
                micro = loss_fn(lb, h, generator)
                (micro / ga).backward()
                loss = loss + micro.detach()
            loss = loss / ga
        for p in params:  # unused parameters: a zero gradient, as jax.grad
            if p.grad is None:  # gives (so weight decay still applies)
                p.grad = torch.zeros_like(p)
        if cfg.grad_clip_norm > 0:
            clip_by_global_norm_(params, cfg.grad_clip_norm)
        set_lr(optimizer, lr)
        optimizer.step()
        return loss

    step.loss_fn = loss_fn
    return step
