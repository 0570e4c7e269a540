"""Training (counterpart of fbanet_tpu/train.py): the step, the per-epoch
evaluation, the epoch loop and the command line.

    python -m fbanet_tpu_torch.train --dataroot DIR [reference flags]
        [--device cuda|cpu]
    torchrun --nproc_per_node W -m fbanet_tpu_torch.train ...

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
- `make_eval_step` / `evaluate_psnr`: per-image boundary-cropped PSNR of
  the clamped prediction, averaged as the reference does (finite sum over
  the image count).
- `train`: the epoch loop. RealBSR tree -> `BurstLoader` (pinned,
  non-blocking copies to the card) -> the step, with a one-step-deep loss
  pipeline (step N's loss is read after step N+1 is queued), per-epoch
  evaluation, the best / latest / periodic checkpoints, and resume, both
  at an epoch boundary (cosine annealed from the stored learning rate) and
  mid-epoch (`save_every_steps`, `stop_after_steps`: the same samples and
  the same stochastic depth as the uninterrupted run). Each step draws its
  stochastic depth from a generator seeded by (seed, epoch, step).
  `--profile_dir` traces the first epoch's steps with torch.profiler
  (`utils/profiling.py::trace`: `<profile_dir>/trace.json`).

Data parallelism (`parallel/mesh.py`, the JAX package's single-host mesh
semantics): under torchrun each rank runs this loop on its own card
(`cuda:LOCAL_RANK`, NCCL; gloo with `--device cpu`). `--batch_size` is the
global batch; each rank loads its B / W rows of it; the model runs under
DistributedDataParallel, whose mean of the ranks' gradients (each the
gradient of its rows' mean loss) is the global batch's, and clipping reads
it after the all-reduce. Mixup pairs across the global batch, with draws
that are the same on every rank; stochastic depth adds the rank to its
generator's key. Rank 0 alone prints, writes the log and the checkpoints
(state_dicts without DDP's `module.` prefix, so they load at any world
size); every rank resumes from the same file. The per-epoch PSNR is
gathered over the ranks, so all pick the same best epoch. `num_workers`,
`eval_workers` and `cache_gb` are per host, as in the JAX package's one
process: each of the host's ranks takes its share (LOCAL_WORLD_SIZE).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import inspect
import itertools
import math
import time
from pathlib import Path

import numpy as np
import torch

from fbanet_tpu_torch.config import (
    Config,
    TrainConfig,
    add_cli_args,
    from_cli,
)
from fbanet_tpu_torch.data import native_io
from fbanet_tpu_torch.data.loader import BurstLoader
from fbanet_tpu_torch.data.realbsr import RealBSRDataset
from fbanet_tpu_torch.losses import fbanet_training_loss
from fbanet_tpu_torch.metrics import finite_average, psnr, to_unit_f32
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.parallel import mesh
from fbanet_tpu_torch.parallel.mesh import World
from fbanet_tpu_torch.utils.checkpoint import CheckpointTriad, load_checkpoint
from fbanet_tpu_torch.utils.profiling import StepTimer, trace


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
                    plain: bool = False, world: World | None = None):
    """(lr_burst, hr, generator, lr, mix_generator=None) -> loss, one
    optimizer step (train.py:179-238). With `cfg.grad_accum` > 1, `lr_burst`
    and `hr` are tuples of that many microbatches and the step uses the mean
    of their gradients (and returns the mean of their losses). `generator`
    draws the stochastic-depth masks (and mixup's lambda and permutation).
    `plain=True` runs the fused operators' plain versions (the
    kernel-vs-plain comparison). The step's `loss_fn(lr_burst, hr,
    generator, mix_generator=None)` is the differentiable loss of one
    microbatch.

    With a `world` whose ranks a process group joins (`parallel/mesh.py`),
    the model runs under DistributedDataParallel (`step.ddp`) on this
    rank's rows: the ranks' gradients are averaged in the backward (every
    microbatch but the last under `no_sync()`), before the clipping, and the
    returned loss is the mean over the ranks. The FAF gate's
    `temporal_attn0` and embedding biases never get a gradient (they cancel,
    `models/blocks.py`), which DDP must be told. With `static_graph=True` it
    learns them in the first step; `find_unused_parameters=True` searches
    the autograd graph at every step and then reads the used-parameter map
    back with a blocking copy: +15.9 ms a B=8 step on an H100 against
    +1.3 ms for the static graph with bucket views
    (`tools/measure_ddp.py`). The static graph cannot start under
    `no_sync()` (its first step must reduce; the reducer fails an internal
    assert), so `grad_accum` > 1 takes the search. Their gradient stays
    None through the all-reduce and is zero-filled below, as on one
    process. The gradients are views of DDP's buckets (no copy back after
    the all-reduce). Over more than one rank, mixup gathers the global
    batch, draws lambda and the permutation from `mix_generator` (which
    must be the same on every rank) and keeps this rank's rows."""
    if online_align != "none":
        from fbanet_tpu_torch.ops.registration import online_register

    params = [p for p in model.parameters() if p.requires_grad]
    ga = max(1, int(cfg.grad_accum))
    wide = world is not None and world.size > 1
    ddp = None
    if world is not None and world.distributed:
        from torch.nn.parallel import DistributedDataParallel

        dev = params[0].device
        # the buffers (window masks, position indices) are constants of
        # the shapes, the same on every rank: no broadcast per forward
        # (`forward_sync_buffers` in newer torch, `broadcast_buffers` before)
        sync = ("forward_sync_buffers" if "forward_sync_buffers" in
                inspect.signature(DistributedDataParallel).parameters
                else "broadcast_buffers")
        ddp = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            static_graph=ga == 1, find_unused_parameters=ga > 1,
            gradient_as_bucket_view=True, **{sync: False})
    forward = model if ddp is None else ddp

    def loss_fn(lr_burst, hr, generator, mix_generator=None):
        if cfg.mixup and wide:
            if mix_generator is None:
                raise ValueError("mixup over ranks needs a mix_generator "
                                 "that is the same on every rank")
            rows = world.rows(world.size * lr_burst.shape[0])
            lr_burst, hr = world.gather(lr_burst), world.gather(hr)
        lr_burst, hr = to_unit_f32(lr_burst), to_unit_f32(hr)
        if cfg.mixup:
            lam, idx = _mixup_draws(lr_burst.shape[0], cfg.mixup_alpha,
                                    generator if mix_generator is None
                                    else mix_generator,
                                    lr_burst.device)
            hr, lr_burst = mixup(hr, lr_burst, lam, idx)
            if wide:
                hr, lr_burst = hr[rows], lr_burst[rows]
        if online_align != "none":
            lr_burst = online_register(lr_burst, online_align)
        pred = forward(lr_burst, plain=plain, train=True, generator=generator)
        return fbanet_training_loss(pred, hr,
                                    charbonnier_eps=cfg.charbonnier_eps,
                                    gw_weight=cfg.gw_loss_weight)

    def step(lr_burst, hr, generator: torch.Generator, lr: float,
             mix_generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        if ga == 1:
            loss = loss_fn(lr_burst, hr, generator, mix_generator)
            loss.backward()
            loss = loss.detach()
        else:
            if len(lr_burst) != ga or len(hr) != ga:
                raise ValueError(f"grad_accum={ga} needs {ga} microbatches")
            loss = 0.0
            for i, (lb, h) in enumerate(zip(lr_burst, hr)):
                sync = ddp is None or i == ga - 1
                with contextlib.nullcontext() if sync else ddp.no_sync():
                    micro = loss_fn(lb, h, generator, mix_generator)
                    (micro / ga).backward()
                loss = loss + micro.detach()
            loss = loss / ga
        if wide:
            loss = world.mean(loss)
        for p in params:  # unused parameters: a zero gradient, as jax.grad
            if p.grad is None:  # gives (so weight decay still applies)
                p.grad = torch.zeros_like(p)
        if cfg.grad_clip_norm > 0:
            clip_by_global_norm_(params, cfg.grad_clip_norm)
        set_lr(optimizer, lr)
        optimizer.step()
        return loss

    step.loss_fn = loss_fn
    step.ddp = ddp
    return step


def resolve_device(device: torch.device | str, who: str) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device where there is
    none (the entry points run on the card unless told otherwise)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                           f"(--device cpu) to run on the CPU")
    return dev


def step_generator(seed: int, epoch: int, step: int,
                   device: torch.device | str, rank: int = 0,
                   world: int = 1) -> torch.Generator:
    """The generator of one train step, keyed by (seed, epoch, step), so a
    resumed epoch redraws the stochastic depth of the uninterrupted run.
    Over more than one rank the rank joins the key, so each rank draws its
    own rows' masks; at one rank the key is the single-process one."""
    entropy = [seed, epoch, step] + ([rank] if world > 1 else [])
    key = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def make_eval_step(model: torch.nn.Module, boundary_ignore: int = 40,
                   online_align: str = "none"):
    """(lr_burst, hr) -> per-image boundary-cropped PSNR [B] of the clamped
    prediction (train.py:241-259)."""
    if online_align != "none":
        from fbanet_tpu_torch.ops.registration import online_register

    @torch.no_grad()
    def step(lr_burst, hr):
        lr_burst, hr = to_unit_f32(lr_burst), to_unit_f32(hr)
        if online_align != "none":
            lr_burst = online_register(lr_burst, online_align)
        pred = torch.clamp(model(lr_burst), 0.0, 1.0)
        return psnr(pred, hr, boundary_ignore=boundary_ignore)

    return step


def evaluate_psnr(eval_step, loader, epoch: int,
                  world: World | None = None) -> float:
    """Sum of the finite per-image PSNRs over the dataset size
    (train.py:262-283). Results stay on the device until the end: the host
    prepares batch N+1 while the card evaluates batch N. Padded entries
    (`batch["valid"]`) are dropped. Over ranks (each loader yields its rows
    of the same global batches) the per-image PSNRs and valid counts are
    gathered and put back in the single-process order, so every rank
    returns the same value."""
    if world is not None and world.size > 1:
        return _evaluate_psnr_ranks(eval_step, loader, epoch, world)
    vals_all, count = [], 0
    for batch in loader.epoch(epoch):
        vals = eval_step(batch["LR"], batch["HR"])
        valid = batch.get("valid", vals.shape[0])
        vals_all.append(vals[:valid])
        count += valid
    vals = torch.cat(vals_all).cpu().numpy() if vals_all else []
    return finite_average(vals, count)


def gather_valid(world: World, vals: torch.Tensor,
                 valid: list[int]) -> np.ndarray:
    """The valid per-image values of every rank in the single-process
    order: `vals` [batches, b, ...] holds this rank's rows of each global
    batch, `valid` the count of real rows in each."""
    counts = torch.tensor(valid, dtype=torch.int64, device=vals.device)
    v = world.gather(vals[None]).cpu().numpy()
    n = world.gather(counts[None]).cpu().numpy()
    return np.concatenate([v[r, i, :n[r, i]] for i in range(len(valid))
                           for r in range(world.size)])


def _evaluate_psnr_ranks(eval_step, loader, epoch: int, world: World) -> float:
    vals_all, valid = [], []
    for batch in loader.epoch(epoch):
        vals = eval_step(batch["LR"], batch["HR"])
        vals_all.append(vals)
        valid.append(batch.get("valid", vals.shape[0]))
    if not vals_all:
        return finite_average([], 0)
    vals = gather_valid(world, torch.stack(vals_all), valid)
    return finite_average(vals, len(vals))


def train(cfg: Config, device: torch.device | str = "cuda") -> dict:
    """Train `cfg` on `device` (train.py:286-503), over the ranks of
    torchrun's environment where there is one (`parallel/mesh.py`; the
    module docstring). Returns {'params' (the model's state_dict),
    'best_psnr', 'best_epoch', 'history' (per epoch: loss, PSNR, learning
    rate, steps, each step's host seconds under 'step_s' and each wait for
    a batch under 'data_wait_s'), 'model_dir', 'decoder'}, the same on every
    rank."""
    world, device = mesh.init(resolve_device(device, "train"))
    try:
        return _train(cfg, device, world)
    finally:
        world.close()


def _train(cfg: Config, device: torch.device, world: World) -> dict:
    tcfg = cfg.train
    # fail before any work when the ranks cannot split the batch
    mesh.row_block(tcfg.batch_size, world.rank, world.size)

    log_dir = Path(tcfg.save_dir) / "log" / f"{tcfg.arch}{tcfg.env}"
    model_dir = log_dir / "models"
    model_dir.mkdir(parents=True, exist_ok=True)
    logname = log_dir / (datetime.datetime.now().isoformat() + ".txt")

    def log(msg: str) -> None:
        if not world.is_main:
            return
        print(msg, flush=True)
        with open(logname, "a") as f:
            f.write(msg + "\n")

    model = create_model(cfg.model, device=device, seed=tcfg.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"FBANet created, parameters: {n_params}")
    optimizer = make_optimizer(model.parameters(), tcfg)

    start_epoch, best_psnr, resumed = 1, 0.0, False
    resume_step, resume_loss, resumed_lr = 0, 0.0, None
    triad = CheckpointTriad(model_dir, period=tcfg.checkpoint_every,
                            world=world)
    if tcfg.resume:
        src = Path(tcfg.pretrain_weights) if tcfg.pretrain_weights else None
        if src is None or not src.with_suffix(".pt").exists():
            src = triad.latest()
        if src is not None:
            state = load_checkpoint(src, map_location=device)
            model.load_state_dict(state["params"], strict=True)
            optimizer.load_state_dict(state["opt_state"])
            best_psnr = state.get("best_psnr", 0.0)
            resume_step = int(state.get("step_in_epoch", 0))
            if resume_step > 0:
                start_epoch = state["epoch"]
                resume_loss = float(state.get("epoch_loss", 0.0))
                log(f"==> Resuming from {src} mid-epoch {start_epoch} "
                    f"at step {resume_step}")
            else:
                start_epoch = state["epoch"] + 1
                log(f"==> Resuming from {src} at epoch {start_epoch}")
            # an epoch-boundary resume anneals a cosine from the stored
            # learning rate; a mid-epoch one keeps the original schedule
            resumed = resume_step == 0
            if resumed:
                resumed_lr = optimizer.param_groups[0]["lr"]

    # the host's loader threads and frame cache, shared by its ranks
    per_host = world.local_size
    ds_kw = dict(layout=cfg.data.layout, burst_size=cfg.data.burst_size,
                 crop_size=cfg.data.crop_size, scale=cfg.data.scale,
                 channels=cfg.data.channels, seed=cfg.data.seed,
                 cache_decoded=cfg.data.cache_decoded,
                 cache_limit_bytes=int(cfg.data.cache_gb * (1 << 30))
                 // per_host,
                 wire_dtype=cfg.data.wire_dtype)
    train_ds = RealBSRDataset(cfg.data.dataroot, split="train",
                              shard_id=cfg.data.shard_id,
                              num_shards=cfg.data.num_shards, **ds_kw)
    val_ds = RealBSRDataset(cfg.data.dataroot, split="val", **ds_kw)
    rank_kw = dict(device=device, seed=tcfg.seed, rank=world.rank,
                   world=world.size)
    train_loader = BurstLoader(train_ds, batch_size=tcfg.batch_size,
                               num_workers=cfg.data.num_workers // per_host,
                               prefetch_depth=cfg.data.prefetch_depth,
                               **rank_kw)
    val_loader = BurstLoader(val_ds, batch_size=tcfg.batch_size,
                             num_workers=cfg.data.eval_workers // per_host,
                             drop_last=False, pad_last=True, **rank_kw)
    log(f"Sizeof training set: {len(train_ds)}, sizeof validation set: "
        f"{len(val_ds)}; device {device}"
        + (f", {world.size} ranks ({world.backend}), global batch "
           f"{tcfg.batch_size}" if world.distributed else ""))
    why = native_io.unavailable_reason()
    log(f"decoder: {train_ds.decoder}"
        + (f" (native pool unavailable: {why})" if why else ""))

    if cfg.data.warm_start and cfg.data.cache_decoded:
        t0 = time.time()
        n_warm = train_ds.warm_cache() + val_ds.warm_cache()
        log(f"warm_start: pre-decoded {n_warm} bursts into the frame cache "
            f"in {time.time() - t0:.1f}s")

    train_step = make_train_step(model, optimizer, tcfg,
                                 online_align=cfg.data.online_align,
                                 world=world)
    # the boundary crop must leave pixels on the eval images
    bi = cfg.eval.boundary_ignore
    if cfg.data.crop_size and cfg.data.crop_size * cfg.data.scale <= 2 * bi:
        bi = 0
    eval_step = make_eval_step(model, boundary_ignore=bi,
                               online_align=cfg.data.online_align)

    best_epoch, history = 0, []
    ga = max(1, tcfg.grad_accum)

    def result() -> dict:
        return {"params": model.state_dict(),
                "best_psnr": best_psnr, "best_epoch": best_epoch,
                "history": history, "model_dir": str(model_dir),
                "decoder": train_ds.decoder}

    for epoch in range(start_epoch, tcfg.nepoch + 1):
        t0 = time.time()
        lr = lr_for_epoch(epoch, tcfg, start_epoch=start_epoch,
                          resumed=resumed, resumed_base=resumed_lr)
        start_step = resume_step if epoch == start_epoch else 0
        epoch_loss = resume_loss if epoch == start_epoch else 0.0
        steps = start_step
        timer = StepTimer(skip_first=1 if epoch == start_epoch else 0)
        stopped_early = False
        # the first epoch's steps traced (rank 0's), as the JAX package
        # traces its first epoch with jax.profiler
        profile_ctx = (trace(tcfg.profile_dir)
                       if tcfg.profile_dir and epoch == start_epoch
                       and world.is_main else contextlib.nullcontext())
        with profile_ctx:
            # `steps` counts optimizer steps; with grad_accum each takes ga
            # loader batches, so the loader resumes at the microbatch
            # position
            batches = iter(train_loader.epoch(epoch,
                                              start_step=start_step * ga))
            # one-step-deep loss pipeline: step N's loss is read after step
            # N+1 is queued, so the host's wait overlaps the card's work;
            # epoch_loss is flushed before every checkpoint
            pending_loss = None
            while True:
                with timer.data_wait():
                    if ga == 1:
                        batch = next(batches, None)
                    else:  # a trailing partial group is dropped
                        group = list(itertools.islice(batches, ga))
                        batch = (None if len(group) < ga else
                                 {"LR": tuple(b["LR"] for b in group),
                                  "HR": tuple(b["HR"] for b in group)})
                if batch is None:
                    break
                gen = step_generator(tcfg.seed, epoch, steps, device,
                                     world.rank, world.size)
                # mixup's draws: the same on every rank
                mix_gen = (step_generator(tcfg.seed, epoch, steps, device)
                           if world.size > 1 and tcfg.mixup else None)
                with timer.step():
                    loss = train_step(batch["LR"], batch["HR"], gen, lr,
                                      mix_gen)
                    if pending_loss is not None:
                        epoch_loss += float(pending_loss)
                pending_loss = loss
                steps += 1
                if (tcfg.save_every_steps
                        and steps % tcfg.save_every_steps == 0):
                    epoch_loss += float(pending_loss)
                    pending_loss = None
                    triad.on_step(epoch, steps, epoch_loss,
                                  params=model.state_dict(),
                                  opt_state=optimizer.state_dict(),
                                  best_psnr=best_psnr)
                if tcfg.stop_after_steps and steps >= tcfg.stop_after_steps:
                    batches.close()  # stops the loader's producer thread
                    stopped_early = True
                    break
        if pending_loss is not None:
            epoch_loss += float(pending_loss)
        timing = {"step_s": timer.times, "data_wait_s": timer.waits}
        if stopped_early:
            triad.on_step(epoch, steps, epoch_loss, params=model.state_dict(),
                          opt_state=optimizer.state_dict(),
                          best_psnr=best_psnr)
            log(f"==> Stopped after {steps} steps of epoch {epoch} "
                f"(interrupt checkpoint written)")
            history.append({"epoch": epoch, "loss": epoch_loss, "psnr": None,
                            "lr": lr, "steps": steps, "interrupted": True,
                            **timing})
            return result()

        psnr_val = evaluate_psnr(eval_step, val_loader, epoch, world)
        if psnr_val > best_psnr:
            best_psnr, best_epoch = psnr_val, epoch
            triad.on_best(params=model.state_dict(),
                          opt_state=optimizer.state_dict(), epoch=epoch,
                          best_psnr=best_psnr)
        log(f"[Ep {epoch} PSNR: {psnr_val:.4f}] ---- "
            f"[best_Ep {best_epoch} Best_PSNR {best_psnr:.4f}]")
        log(f"Epoch: {epoch}\tTime: {time.time() - t0:.4f}\t"
            f"Loss: {epoch_loss:.4f}\tLearningRate {lr:.6f}\t"
            + (timer.report() if timer.times else "steps=0"))
        triad.on_epoch_end(epoch, params=model.state_dict(),
                           opt_state=optimizer.state_dict(),
                           best_psnr=best_psnr)
        history.append({"epoch": epoch, "loss": epoch_loss, "psnr": psnr_val,
                        "lr": lr, "steps": steps, **timing})
    return result()


def main(argv: list[str] | None = None) -> dict:
    parser = add_cli_args(argparse.ArgumentParser(
        description="FBANet training (PyTorch port)"))
    args = parser.parse_args(argv)
    return train(from_cli(args), device=args.device)


if __name__ == "__main__":
    main()
