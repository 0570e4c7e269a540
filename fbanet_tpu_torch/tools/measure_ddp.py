"""What DistributedDataParallel costs the train step at world 1, by setting.

    python -m fbanet_tpu_torch.tools.measure_ddp [--steps 8]

On one card, in a NCCL process group of world 1 (torchrun's environment
set in the process), FBANet-64 at B=8 (14 frames, 160 px, bf16,
drop_path 0.1, AdamW) takes `train.make_train_step` steps with no DDP and
under DDP with each setting below, the settings' steps alternating. For
each setting it prints the median host ms of a synchronised step (the
first left out) and the device ms of one profiled step. DDP's constructor
gets the setting's keyword arguments on top of the step's own:

- `find_unused_parameters`: a search of the autograd graph at every step,
  then a blocking read of the used-parameter map;
- `static_graph`: the unused parameters learnt in the first step (what
  the step runs at `grad_accum` 1);
- `static_graph` with `gradient_as_bucket_view` (the step's setting);
- `find_unused_parameters` with `gradient_as_bucket_view` (the step's
  setting at `grad_accum` > 1).

A first block runs 3 steps of each under deterministic algorithms and
prints whether each setting's parameters are bit-equal to the plain
steps'.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import time

import torch
import torch.nn.parallel

SETTINGS = {
    "plain": None,
    "find_unused": {"static_graph": False, "find_unused_parameters": True,
                    "gradient_as_bucket_view": False},
    "static": {"static_graph": True, "find_unused_parameters": False,
               "gradient_as_bucket_view": False},
    "static_view": {"static_graph": True, "find_unused_parameters": False,
                    "gradient_as_bucket_view": True},
    "find_unused_view": {"static_graph": False,
                         "find_unused_parameters": True,
                         "gradient_as_bucket_view": True},
}


@contextlib.contextmanager
def ddp_setting(over: dict):
    """`torch.nn.parallel.DistributedDataParallel` with `over` on top of
    its caller's keyword arguments, while the block runs (the step looks
    the class up when it is built)."""
    real = torch.nn.parallel.DistributedDataParallel

    def make(module, **kw):
        return real(module, **{**kw, **over})

    torch.nn.parallel.DistributedDataParallel = make
    try:
        yield
    finally:
        torch.nn.parallel.DistributedDataParallel = real


@contextlib.contextmanager
def _deterministic():
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=True)
        cudnn.deterministic, cudnn.benchmark = saved[1], saved[2]


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    args = p.parse_args(argv)
    # cuBLAS's deterministic workspace, read when torch first calls cuBLAS
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        raise SystemExit("measure_ddp: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.parallel import mesh
    from fbanet_tpu_torch.train import (
        make_optimizer,
        make_train_step,
        step_generator,
    )
    from fbanet_tpu_torch.utils.weights import random_state_dict

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(mesh.free_port())})
    world, dev = mesh.init("cuda")
    cfg = ModelConfig(num_frames=14, img_size=160, embed_dim=64,
                      window_size=8, dtype="bfloat16", drop_path_rate=0.1)
    tcfg = TrainConfig(batch_size=8, lr_initial=1e-4)
    state = random_state_dict(create_model(cfg, device="cpu", seed=0),
                              seed=2)
    rng = np.random.default_rng(30)
    lr8 = torch.from_numpy(rng.uniform(0, 1, (8, 14, 160, 160, 3))
                           .astype(np.float32)).to(dev)
    hr8 = torch.from_numpy(rng.uniform(0, 1, (8, 640, 640, 3))
                           .astype(np.float32)).to(dev)

    def build(name):
        model = create_model(cfg, device=dev, seed=0)
        model.load_state_dict(state, strict=True)
        opt = make_optimizer(model.parameters(), tcfg)
        if SETTINGS[name] is None:
            return model, make_train_step(model, opt, tcfg)
        with ddp_setting(SETTINGS[name]):
            return model, make_train_step(model, opt, tcfg, world=world)

    def step(run, i):
        gen = step_generator(tcfg.seed, 1, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(run[1](lr8, hr8, gen, tcfg.lr_initial))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    res = {}
    try:
        runs = {name: build(name) for name in SETTINGS}
        with _deterministic():
            for i in range(3):
                for run in runs.values():
                    step(run, i)
        ref = dict(runs["plain"][0].named_parameters())
        for name, run in runs.items():
            equal = sum(torch.equal(q, ref[n])
                        for n, q in run[0].named_parameters())
            res[name] = {"bit_equal": f"{equal} of {len(ref)}"}
        times = {name: [] for name in runs}
        for i in range(3, 3 + args.steps):
            order = list(runs) if i % 2 else list(runs)[::-1]
            for name in order:
                times[name].append(step(runs[name], i))
        for name, run in runs.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(run, 3 + args.steps)
            device = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in prof.key_averages()
                         if "CUDA" in str(e.device_type)
                         and not getattr(e, "is_user_annotation", False))
            res[name].update(ms=statistics.median(times[name][1:]),
                             steps_ms=[round(t, 2) for t in times[name]],
                             device_ms=device / 1e3)
    finally:
        world.close()
    plain = res["plain"]["ms"]
    for name, r in res.items():
        print(f"measure_ddp on {card}: {name}: {r['ms']:.2f} ms/step "
              f"({r['ms'] - plain:+.2f} vs plain), device {r['device_ms']:.3f}"
              f" ms, parameters after 3 deterministic steps bit-equal to "
              f"plain: {r['bit_equal']}; steps {r['steps_ms']}", flush=True)
    return res


if __name__ == "__main__":
    main()
