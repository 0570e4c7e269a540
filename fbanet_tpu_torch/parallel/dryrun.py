"""Dry runs of the data-parallel paths over W ranks, for the CPU tests
(tests/test_torch_ddp.py, gloo) and chip_smoke.py's ddp phase (two ranks
on one card over gloo):

    torchrun --nproc_per_node W -m fbanet_tpu_torch.parallel.dryrun DIR CASE...

Each rank reads `DIR/inputs.pt` (the caller's `torch.save` of a dict of
tensors and plain values, one entry per case, plus "device" and "backend"),
runs the named cases on its rows and writes `DIR/{case}.rank{r}.pt`:

- `steps`: for each entry of inputs["steps"]["cases"], one
  `train.make_train_step` step under DDP on this rank's rows of each global
  (micro)batch: the loss (the mean over the ranks), every parameter's
  gradient after the all-reduce (None where the model never reads it) and
  the parameters after the step. The step's generator is seeded by the
  case's "seed"; so is mixup's, which is the same on every rank.
- `eval`: `train.evaluate_psnr` over a val tree whose last global batch is
  padded, and `evaluate.main` with `--save_images`.
- `tiles`: `tiled.tiled_forward` of a burst with `nearest_x4` as the model,
  at each `tile_batch` given.
- `resume`: `train.train` stopped after one step (the config's
  `stop_after_steps`, which no flag sets), then `train.main --resume`; the
  checkpoints are its results.

The ranks import neither JAX nor the JAX package: each result records the
top-level modules it found loaded.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def nearest_x4(batch: torch.Tensor) -> torch.Tensor:
    """The tiles' stand-in model: frame 0 of [B, F, t, t, C], upsampled x4
    by repetition."""
    return batch[:, 0].repeat_interleave(4, 1).repeat_interleave(4, 2)


def _model(spec: dict, device):
    from fbanet_tpu_torch.models import ModelConfig, create_model

    model = create_model(ModelConfig(**spec["model"]), device=device, seed=0)
    model.load_state_dict(spec["state"], strict=True)
    return model


def run_steps(spec: dict, world, device) -> dict:
    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.train import make_optimizer, make_train_step

    out = {}
    for case in spec["cases"]:
        tcfg = TrainConfig(**case["train"])
        model = _model(spec, device)
        step = make_train_step(model, make_optimizer(model.parameters(), tcfg),
                               tcfg, world=world)
        rows = world.rows(case["lr"][0].shape[0])
        lr = [x[rows].to(device) for x in case["lr"]]
        hr = [x[rows].to(device) for x in case["hr"]]
        if tcfg.grad_accum == 1:
            lr, hr = lr[0], hr[0]
        gen = torch.Generator(device).manual_seed(case["seed"])
        mix = torch.Generator(device).manual_seed(case["seed"])
        loss = step(lr, hr, gen, tcfg.lr_initial, mix if tcfg.mixup else None)
        out[case["name"]] = {
            "loss": float(loss),
            "grads": {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in
                       model.named_parameters()}}
    return out


def run_eval(spec: dict, world, device) -> dict:
    from fbanet_tpu_torch import evaluate
    from fbanet_tpu_torch.data.loader import BurstLoader
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset
    from fbanet_tpu_torch.train import evaluate_psnr, make_eval_step

    model = _model(spec, device)
    ds = RealBSRDataset(spec["root"], split="val", burst_size=spec["frames"],
                        crop_size=spec["crop"], cache_decoded=True)
    loader = BurstLoader(ds, batch_size=spec["batch_size"], num_workers=1,
                         drop_last=False, pad_last=True, device=device,
                         rank=world.rank, world=world.size)
    valid = [b["valid"] for b in loader.epoch(0)]
    psnr = evaluate_psnr(make_eval_step(model, boundary_ignore=0), loader, 0,
                         world)
    res = evaluate.main(spec["argv"] + ["--device", str(device)])
    return {"evaluate_psnr": psnr, "valid": valid, "evaluate": res}


def run_tiles(spec: dict, world, device) -> dict:
    from fbanet_tpu_torch.tiled import tiled_forward

    out = {}
    for tb in spec["tile_batch"]:
        sr = tiled_forward(nearest_x4, spec["burst"].numpy(),
                           psize=spec["psize"], overlap=spec["overlap"],
                           scale=4, tile_batch=tb, device=device, world=world)
        out[tb] = None if sr is None else torch.from_numpy(sr)
    return out


def run_resume(spec: dict, world, device) -> dict:
    from fbanet_tpu_torch import train
    from fbanet_tpu_torch.config import add_cli_args, from_cli

    argv = spec["argv"] + ["--device", str(device)]
    cfg = from_cli(add_cli_args(argparse.ArgumentParser()).parse_args(argv))
    stop = train.train(cfg.replace(train=cfg.train.replace(
        stop_after_steps=1)), device=device)
    done = train.main(argv + ["--resume"])
    return {"stop": stop["history"], "history": done["history"]}


CASES = {"steps": run_steps, "eval": run_eval, "tiles": run_tiles,
         "resume": run_resume}


def main(argv: list[str] | None = None) -> None:
    from fbanet_tpu_torch.parallel import mesh

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dir")
    parser.add_argument("cases", nargs="+", choices=sorted(CASES))
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    # f32 means f32 here, as in chip_smoke.py: no TF32 convolutions or
    # matmuls (torch's default lets cuDNN use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = Path(args.dir)
    spec = torch.load(d / "inputs.pt", weights_only=True)
    world, device = mesh.init(spec.get("device", "cpu"),
                              backend=spec.get("backend"))
    try:
        for name in args.cases:
            res = CASES[name](spec[name], world, device)
            res["modules"] = sorted({m.split(".")[0] for m in sys.modules})
            torch.save(res, d / f"{name}.rank{world.rank}.pt")
            world.barrier()
    finally:
        world.close()


if __name__ == "__main__":
    main()
