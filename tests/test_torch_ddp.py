"""The port's data parallelism (fbanet_tpu_torch/parallel/) against the
JAX package's single-host mesh and the single-process port, on the CPU.

Ranks are processes over gloo with one torch thread each, started by
`python -m torch.distributed.run` three times, side by side, for the whole
file (the module fixture `two_ranks`): as `-m fbanet_tpu_torch.train` (two
epochs) and twice as `-m fbanet_tpu_torch.parallel.dryrun` (the train
steps, the evaluation and the tiles; a stop-and-resume). The JAX references run here,
in the parent, on the conftest's virtual CPU devices; the ranks get numpy
data through files and never import JAX (each result lists the modules
its rank loaded).

Sizes: `test_sharding.py`'s TINY (embed 8, 2 frames, 16 px, window 4,
f32, drop_path 0) for the steps; `test_eval_sharded.py`'s tree (5 val
bursts of 3 frames, global batch 4, so the last batch is padded and rank 1
gets `valid = 0`); `test_tiled_sharded.py`'s 9-tile burst and x4 stand-in
model. Tolerances, each with its reason, in the tests' docstrings.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import flax_params_like

from fbanet_tpu.config import ModelConfig as JaxModelConfig
from fbanet_tpu.parallel import mesh as jmesh
from fbanet_tpu_torch.config import ModelConfig, TrainConfig
from fbanet_tpu_torch.data.loader import BurstLoader
from fbanet_tpu_torch.data.realbsr import RealBSRDataset
from fbanet_tpu_torch.models import create_model
from fbanet_tpu_torch.parallel import dryrun, mesh
from fbanet_tpu_torch.utils.weights import (
    jax_params_to_state_dict,
    random_state_dict,
)

ROOT = Path(__file__).resolve().parents[1]
W = 2
STEP_MODEL = dict(num_frames=2, img_size=16, embed_dim=8, window_size=4,
                  heads=(1, 2, 4, 8, 4, 4, 2, 2, 2), dtype="float32",
                  drop_path_rate=0.0)
# the CLI's model at these flags (default heads), for the eval and train runs
CLI_MODEL = dict(num_frames=3, img_size=16, embed_dim=8, window_size=4,
                 dtype="float32")
CLI = ["--train_ps", "16", "--embed_dim", "8", "--win_size", "4",
       "--burst_size", "3", "--dtype", "float32"]
STEP_LR = 1e-3
# Two runs whose gradients differ only in sum order, after AdamW steps: an
# AdamW step moves an element by at most about lr (|m_hat / sqrt(v_hat)| <=
# 1, with 10 % margin), and where a gradient is sum-order noise the two
# runs may step it in opposite directions, so they part by at most
# 2 x 1.1 x the sum of the learning rates.
ADAM_GAP = 2.2


def _torchrun(*args: str) -> subprocess.Popen:
    """`python -m torch.distributed.run` at W ranks on this host, started."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(W), *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _train_argv(tree, save, *extra):
    return ["--dataroot", str(tree), "--batch_size", "4", "--nepoch", "2",
            "--save_dir", str(save), "--train_workers", "2",
            "--eval_workers", "2", *CLI, *extra]


def _step_inputs():
    """The state_dict and three cases on a global batch of 4: a plain
    step, grad_accum 2 (two global microbatches) and mixup."""
    sd = random_state_dict(create_model(ModelConfig(**STEP_MODEL),
                                        device="cpu", seed=0), seed=5)
    r = np.random.default_rng(0)
    lr = [torch.from_numpy(r.uniform(size=(4, 2, 16, 16, 3))
                           .astype(np.float32)) for _ in range(2)]
    hr = [torch.from_numpy(r.uniform(size=(4, 64, 64, 3)).astype(np.float32))
          for _ in range(2)]
    one = dict(lr=lr[:1], hr=hr[:1], seed=3)
    cases = [dict(name="plain", train=dict(lr_initial=STEP_LR), **one),
             dict(name="accum", train=dict(lr_initial=STEP_LR, grad_accum=2),
                  lr=lr, hr=hr, seed=3),
             dict(name="mixup", train=dict(lr_initial=STEP_LR, mixup=True),
                  **one)]
    return {"model": STEP_MODEL, "state": sd, "cases": cases}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The three launches at W = 2 ranks, and their inputs."""
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr
    from fbanet_tpu_torch.utils.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("ddp")
    tree = tmp / "tree"
    write_synthetic_realbsr(tree, num_bursts=8, num_frames=3, lr_size=16,
                            splits=("train",), level=1)
    write_synthetic_realbsr(tree, num_bursts=5, num_frames=3, lr_size=16,
                            splits=("test",), seed=1, level=1)
    eval_sd = random_state_dict(create_model(ModelConfig(**CLI_MODEL),
                                             device="cpu", seed=0), seed=6)
    save_checkpoint(tmp / "weights", params=eval_sd, opt_state=None, epoch=0)
    eval_argv = ["--dataroot", str(tree), "--weights", str(tmp / "weights"),
                 *CLI, "--eval_workers", "1", "--save_images"]
    burst = np.random.default_rng(1).uniform(size=(2, 48, 48, 1)).astype(
        np.float32)  # 9 tiles of 16 px
    spec = {"device": "cpu",
            "steps": _step_inputs(),
            "eval": {"model": CLI_MODEL, "state": eval_sd, "root": str(tree),
                     "frames": 3, "crop": 16, "batch_size": 4,
                     "argv": eval_argv + ["--result_dir", str(tmp / "png2")]},
            "tiles": {"burst": torch.from_numpy(burst), "psize": 16,
                      "overlap": 8, "tile_batch": [0, 4]},
            "resume": {"argv": _train_argv(tree, tmp / "b")}}
    torch.save(spec, tmp / "inputs.pt")
    # the launches share no file they write, and run side by side
    procs = [_torchrun("-m", "fbanet_tpu_torch.train",
                       *_train_argv(tree, tmp / "a", "--device", "cpu")),
             _torchrun("-m", "fbanet_tpu_torch.parallel.dryrun", str(tmp),
                       "steps", "eval", "tiles"),
             _torchrun("-m", "fbanet_tpu_torch.parallel.dryrun", str(tmp),
                       "resume")]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-4000:]
    finally:  # a stuck launch: torchrun stops its ranks on SIGTERM
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                proc.wait(30)
    out = {case: [torch.load(tmp / f"{case}.rank{r}.pt", weights_only=False)
                  for r in range(W)]
           for case in ("steps", "eval", "tiles", "resume")}
    return {"tmp": tmp, "tree": tree, "spec": spec, "eval_sd": eval_sd,
            "eval_argv": eval_argv, "burst": burst, **out}


# ------------------------------------------------------------- row blocks ----

@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 5, 8, 9, 16])
def test_row_blocks_match_jax_batch_sharding(w, n):
    """Exact: the rows `World.rows` gives rank r of a batch padded by
    `pad_to_multiple` are those of JAX's `batch_sharding` on device r of a
    W-device mesh (`addressable_shards` indices), and both packages pad to
    the same count."""
    padded = mesh.pad_to_multiple(n, w)
    assert padded == jmesh.pad_to_multiple(n, w)
    jm = jmesh.make_mesh(jax.devices()[:w])
    arr = jax.device_put(np.arange(padded), jmesh.batch_sharding(jm))
    order = list(jm.devices.reshape(-1))
    jax_rows = {order.index(s.device): s.index[0] for s in
                arr.addressable_shards}
    for r in range(w):
        got = mesh.World(rank=r, size=w).rows(padded)
        want = jax_rows[r]
        assert (got.start, got.stop) == (want.start or 0, want.stop or padded)


@pytest.mark.parametrize("batch,world", [(6, 4), (5, 2), (3, 8)])
def test_indivisible_batch_raises(batch, world, tree_small):
    """A global batch that the world size does not divide raises, naming
    both numbers, from the row split and from the loader (the train,
    evaluate and tiled paths go through both)."""
    with pytest.raises(ValueError, match=rf"{batch} rows .* {world} ranks"):
        mesh.World(rank=0, size=world).rows(batch)
    ds = RealBSRDataset(tree_small, split="val", burst_size=3, crop_size=16)
    with pytest.raises(ValueError, match=rf"{batch} rows .* {world} ranks"):
        BurstLoader(ds, batch_size=batch, rank=0, world=world, pad_last=True)


@pytest.fixture(scope="module")
def tree_small(tmp_path_factory):
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    root = tmp_path_factory.mktemp("ddp_small")
    write_synthetic_realbsr(root, num_bursts=2, num_frames=3, lr_size=16,
                            splits=("test",), level=1)
    return root


def test_no_rank_imports_jax(two_ranks):
    """The ranks ran the port alone: no JAX, flax or `fbanet_tpu` module
    was loaded in any rank of the dry run."""
    for case in ("steps", "eval", "tiles", "resume"):
        for res in two_ranks[case]:
            loaded = set(res["modules"])
            assert not loaded & {"jax", "jaxlib", "flax", "optax",
                                 "fbanet_tpu"}, (case, loaded)


# ------------------------------------------------------------------ steps ----

def _port_step(case, state):
    """The single-process port's step on the whole global batch, with the
    same generator seed: (loss, grads, params)."""
    from fbanet_tpu_torch.train import make_optimizer, make_train_step

    tcfg = TrainConfig(**case["train"])
    model = create_model(ModelConfig(**STEP_MODEL), device="cpu", seed=0)
    model.load_state_dict(state, strict=True)
    step = make_train_step(model, make_optimizer(model.parameters(), tcfg),
                           tcfg)
    lr, hr = case["lr"], case["hr"]
    if tcfg.grad_accum == 1:
        lr, hr = lr[0], hr[0]
    else:
        lr, hr = tuple(lr), tuple(hr)
    loss = step(lr, hr, torch.Generator().manual_seed(case["seed"]),
                tcfg.lr_initial)
    return (float(loss), {n: p.grad.clone() for n, p in
                          model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _close(got: dict, ref: dict, rel: float, what: str):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        scale = float(np.abs(r).max())
        err = float(np.abs(np.asarray(got[k], np.float64) - r).max())
        assert err <= rel * scale or (scale == 0 and err == 0), \
            f"{what} {k}: err {err:.3e}, max {scale:.3e}"


def test_ddp_step_matches_jax_sharded_gradients(two_ranks):
    """A 2-rank DDP step on a global batch of 4 against
    jax.value_and_grad(fbanet_training_loss . model.apply) with the batch
    sharded over a 2-device mesh and the parameters replicated
    (test_sharding.py:35-60): the loss within 1e-5 relative, every
    gradient within 1e-4 of its tensor's max |grad| (the same f32 math in
    another sum order through 20 layers, as test_torch_train.py holds the
    single-process gradients). Gradients, not post-Adam parameters, for
    that test's reason. Then the full step against the single-process port
    step: gradients within 1e-5 of each tensor's max (only the mean over
    the two halves is summed in another order), parameters within ADAM_GAP
    x lr, and both ranks' parameters bit-equal."""
    from fbanet_tpu.losses import fbanet_training_loss
    from fbanet_tpu.models import create_model as jax_create_model

    spec = two_ranks["spec"]["steps"]
    case = spec["cases"][0]
    res = [r["plain"] for r in two_ranks["steps"]]
    jmodel = jax_create_model(JaxModelConfig(**STEP_MODEL))
    params = flax_params_like(jmodel, jnp.zeros((1, 2, 16, 16, 3)),
                              state_dict=spec["state"])

    @jax.jit
    def loss_and_grad(p, lr_burst, hr):
        def f(p):
            pred = jmodel.apply({"params": p}, lr_burst, deterministic=True)
            return fbanet_training_loss(pred, hr)
        return jax.value_and_grad(f)(p)

    jm = jmesh.make_mesh(jax.devices()[:W])
    sh = jmesh.batch_sharding(jm)
    jloss, jgrad = loss_and_grad(
        jax.device_put(params, jmesh.replicated_sharding(jm)),
        jax.device_put(case["lr"][0].numpy(), sh),
        jax.device_put(case["hr"][0].numpy(), sh))
    ref = {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, jgrad)).items()}
    np.testing.assert_allclose(res[0]["loss"], float(jloss), rtol=1e-5)
    _close({k: v.numpy() for k, v in res[0]["grads"].items()}, ref, 1e-4,
           "grad vs JAX")

    loss, grads, params_1 = _port_step(case, spec["state"])
    np.testing.assert_allclose(res[0]["loss"], loss, rtol=1e-6)
    _close(res[0]["grads"], grads, 1e-5, "grad vs one process")
    for k, v in params_1.items():
        assert float((res[0]["params"][k] - v).abs().max()) <= \
            ADAM_GAP * STEP_LR, k
        assert torch.equal(res[0]["params"][k], res[1]["params"][k]), k


@pytest.mark.parametrize("name", ["accum", "mixup"])
def test_accum_and_mixup_match_one_process(two_ranks, name):
    """grad_accum = 2 (the first microbatch under `no_sync()`) and mixup
    (the global batch gathered, lambda and the permutation drawn from a
    generator that is the same on both ranks) at 2 ranks against the
    single-process step on the same global batches with the same draws:
    the loss within 1e-6 relative, gradients within 1e-5 of each tensor's
    max |grad| (the mean over the halves summed in another order),
    parameters within ADAM_GAP x lr and bit-equal on both ranks."""
    spec = two_ranks["spec"]["steps"]
    case = next(c for c in spec["cases"] if c["name"] == name)
    res = [r[name] for r in two_ranks["steps"]]
    loss, grads, params = _port_step(case, spec["state"])
    np.testing.assert_allclose(res[0]["loss"], loss, rtol=1e-6)
    _close(res[0]["grads"], grads, 1e-5, f"{name} grad")
    for k, v in params.items():
        assert float((res[0]["params"][k] - v).abs().max()) <= \
            ADAM_GAP * STEP_LR, k
        assert torch.equal(res[0]["params"][k], res[1]["params"][k]), k


# -------------------------------------------------------------- train.main ----

def test_train_main_two_ranks(two_ranks, tmp_path):
    """`torchrun --nproc_per_node 2 -m fbanet_tpu_torch.train --device cpu`
    (2 epochs of 2 steps at global batch 4) against `train.main` in one
    process on the same flags: the final parameters within ADAM_GAP x the
    sum of the 4 steps' learning rates (the gradients differ in sum order
    only) and the best PSNR within 1e-2 dB. Rank 0 alone wrote the
    log (one file) and the checkpoints, whose names have no DDP `module.`
    prefix and which load strictly into a plain model. The dry run's stop
    after 1 step and `--resume` at 2 ranks is bit-equal to the
    uninterrupted 2-rank run: every parameter, the best PSNR and epoch."""
    from fbanet_tpu_torch import train as PT
    from fbanet_tpu_torch.utils.checkpoint import load_checkpoint

    tmp = two_ranks["tmp"]
    one = PT.main(_train_argv(two_ranks["tree"], tmp_path, "--device", "cpu"))
    run_dir = tmp / "a" / "log" / "BaseModel_"
    assert len(list(run_dir.glob("*.txt"))) == 1
    a = load_checkpoint(run_dir / "models" / "model_latest")
    b = load_checkpoint(tmp / "b" / "log" / "BaseModel_" / "models"
                        / "model_latest")
    assert not any(k.startswith("module.") for k in a["params"])
    create_model(ModelConfig(**CLI_MODEL), device="cpu").load_state_dict(
        a["params"], strict=True)
    lrs = sum(h["lr"] * h["steps"] for h in one["history"])
    for k, v in one["params"].items():
        assert float((a["params"][k] - v).abs().max()) <= ADAM_GAP * lrs, k
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert abs(a["best_psnr"] - one["best_psnr"]) <= 1e-2
    assert (a["best_psnr"], a["epoch"]) == (b["best_psnr"], b["epoch"])
    resumed = two_ranks["resume"][0]
    assert resumed["stop"][-1]["interrupted"]
    assert [h["epoch"] for h in resumed["history"]] == [1, 2]


# ------------------------------------------------------------------- eval ----

def test_eval_two_ranks_with_padding(two_ranks, tmp_path):
    """5 val bursts at global batch 4 over 2 ranks: the last batch is
    padded and rank 1's half of it has `valid = 0`. `evaluate_psnr` equals
    the 1-rank port's (unpadded batches) and JAX's `evaluate_psnr` over a
    2-device mesh with its padded loader (test_eval_sharded.py's set-up)
    within 1e-4 dB (the f32 forward in another sum order); `evaluate.main`
    at 2 ranks (eval batch 16: rank 1 holds no image at all) gives the
    1-rank PSNR and SSIM within 1e-4 and writes each of the 5 images once,
    equal to the 1-rank PNGs."""
    from fbanet_tpu import train as jtrain
    from fbanet_tpu.data.loader import BurstLoader as JaxLoader
    from fbanet_tpu.data.realbsr import RealBSRDataset as JaxDataset
    from fbanet_tpu.models import create_model as jax_create_model
    import cv2

    from fbanet_tpu_torch import evaluate as PE
    from fbanet_tpu_torch.train import evaluate_psnr, make_eval_step

    res = two_ranks["eval"]
    assert res[0]["valid"] == [2, 1] and res[1]["valid"] == [2, 0]
    assert res[0]["evaluate_psnr"] == res[1]["evaluate_psnr"]

    tree = two_ranks["tree"]
    model = create_model(ModelConfig(**CLI_MODEL), device="cpu")
    model.load_state_dict(two_ranks["eval_sd"], strict=True)
    ds = RealBSRDataset(tree, split="val", burst_size=3, crop_size=16,
                        cache_decoded=True)
    single = evaluate_psnr(make_eval_step(model, boundary_ignore=0),
                           BurstLoader(ds, batch_size=4, num_workers=1,
                                       drop_last=False, device="cpu"), 0)
    assert res[0]["evaluate_psnr"] == pytest.approx(single, abs=1e-4)

    jmodel = jax_create_model(JaxModelConfig(**CLI_MODEL))
    params = flax_params_like(jmodel, jnp.zeros((1, 3, 16, 16, 3)),
                              state_dict=two_ranks["eval_sd"])
    jds = JaxDataset(tree, split="val", burst_size=3, crop_size=16,
                     cache_decoded=True)
    jm = jmesh.make_mesh(jax.devices()[:W])
    jloader = JaxLoader(jds, batch_size=4, num_workers=1, drop_last=False,
                        sharding=jmesh.batch_sharding(jm), pad_last=True)
    jpsnr = jtrain.evaluate_psnr(jtrain.make_eval_step(jmodel,
                                                       boundary_ignore=0),
                                 {"params": params}, jloader, epoch=0)
    assert res[0]["evaluate_psnr"] == pytest.approx(jpsnr, abs=1e-4)

    one = PE.main(two_ranks["eval_argv"] + ["--result_dir", str(tmp_path),
                                            "--device", "cpu"])
    for r in res:
        assert r["evaluate"]["num_images"] == 5
        assert r["evaluate"]["psnr"] == pytest.approx(one["psnr"], abs=1e-4)
        assert r["evaluate"]["ssim"] == pytest.approx(one["ssim"], abs=1e-4)
    written = sorted(p.name for p in (two_ranks["tmp"] / "png2").iterdir())
    assert written == sorted(p.name for p in tmp_path.iterdir())
    assert len(written) == 5
    for name in written:
        a = cv2.imread(str(two_ranks["tmp"] / "png2" / name)).astype(int)
        b = cv2.imread(str(tmp_path / name)).astype(int)
        assert np.abs(a - b).max() <= 1


# ------------------------------------------------------------------ tiles ----

def test_tiles_two_ranks_with_padding(two_ranks):
    """9 tiles over 2 ranks (padded to 10; with tile_batch 4, batches of
    4, 4 and 1 + 3 padded): rank 0's stitched image is bit-equal to the
    1-rank port's and to JAX's `tiled_forward(..., mesh=make_mesh())` on
    its 8 devices with the same x4 stand-in model (test_tiled_sharded.py);
    rank 1 returns nothing."""
    from fbanet_tpu.tiled import tiled_forward as jax_tiled
    from fbanet_tpu_torch.tiled import tiled_forward

    burst = two_ranks["burst"]

    def fake(batch):
        return jnp.repeat(jnp.repeat(batch[:, 0], 4, axis=1), 4, axis=2)

    ref = jax_tiled(fake, burst, psize=16, overlap=8, scale=4,
                    mesh=jmesh.make_mesh())
    r0, r1 = two_ranks["tiles"]
    for tb in (0, 4):
        one = tiled_forward(dryrun.nearest_x4, burst, psize=16, overlap=8,
                            scale=4, tile_batch=tb, device="cpu")
        assert r1[tb] is None
        np.testing.assert_array_equal(r0[tb].numpy(), one)
        np.testing.assert_array_equal(r0[tb].numpy(), np.asarray(ref))


def test_one_process_world_is_inert():
    """Without torchrun's environment `init` makes no process group and
    the world is one rank: the paths run as before this module."""
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")
           if k in os.environ}
    try:
        world, dev = mesh.init("cpu")
    finally:
        os.environ.update(env)
    assert world == mesh.World() and dev == torch.device("cpu")
    assert not world.distributed and world.is_main
    t = torch.arange(6.0)
    assert world.gather(t) is t and world.mean(t) is t
    assert world.rows(6) == slice(0, 6)
    world.barrier()
    world.close()
    assert not torch.distributed.is_initialized()
