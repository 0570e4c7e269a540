"""The port's entry points against the JAX package's, end to end on the CPU:
config CLI, checkpoints (the JAX `.msgpack` read into the port), metrics,
evaluation, tiled inference and the epoch loop with resume.

Sizes as in tests/test_cli.py: 3 frames, 16 px LR, embed 8, window 4, f32.
Tolerances:
- `from_cli`, `divide_burst` / `merge_tiles`, `load_params`, the resumed
  training run: exact (the same values, or bit-identical parameters).
- metrics: 1e-5 absolute for PSNR in dB and 1e-6 for SSIM and the
  pixel-wise errors (the same f32 math; SSIM blurs by shifted sums in the
  port and by a convolution in JAX, so sums run in another order).
- `evaluate` on the same weights: PSNR and SSIM within 1e-4 (the whole
  forward in f32, sums in another order); its PNGs within one level.
One JAX compile of the tiny eval forward (JAX's `evaluate`), shared by the
module fixture `jax_eval`.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

COMMON = ["--train_ps", "16", "--embed_dim", "8", "--win_size", "4",
          "--burst_size", "3", "--dtype", "float32"]
CPU = ["--device", "cpu"]


def _parse(mod, argv):
    return mod.from_cli(mod.add_cli_args(argparse.ArgumentParser())
                        .parse_args(argv))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    root = tmp_path_factory.mktemp("cli_tree")
    write_synthetic_realbsr(root, num_bursts=4, num_frames=3, lr_size=16)
    return root


def _jax_template(cfg):
    """The parameter tree `init_model(cfg)` gives, from an abstract init (no
    compile), as numpy zeros."""
    from fbanet_tpu.models import create_model

    model = create_model(cfg)
    dummy = jax.numpy.zeros((1, cfg.num_frames, cfg.img_size, cfg.img_size,
                             cfg.in_channels))
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), dummy))
    return model, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX checkpoint written by the JAX package's `save_checkpoint`: the
    tree of `init_model`, every leaf drawn from a seeded random state_dict
    (the init's zero tail would hide the network)."""
    import fbanet_tpu.config as JC
    import fbanet_tpu_torch.config as PC
    from fbanet_tpu.utils.checkpoint import save_checkpoint
    from fbanet_tpu.utils.torch_io import torch_to_flax_params
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.weights import random_state_dict

    _, template = _jax_template(_parse(JC, COMMON).model)
    port = create_model(_parse(PC, COMMON).model, device="cpu")
    sd = random_state_dict(port, seed=3)
    params, _ = torch_to_flax_params({k: v.numpy() for k, v in sd.items()},
                                     template)
    path = tmp_path_factory.mktemp("jax_ckpt") / "model_best"
    save_checkpoint(path, params=params, opt_state={}, epoch=1)
    return path, params, sd


@pytest.fixture(scope="module")
def jax_eval(tree, jax_ckpt, tmp_path_factory):
    """JAX `evaluate` on the checkpoint. Its `init_model` (a compile whose
    parameters `--weights` replaces at once) is swapped for the abstract
    init; the eval step is JAX's own, compiled once."""
    import fbanet_tpu.config as JC
    import fbanet_tpu.evaluate as JE

    out = tmp_path_factory.mktemp("jax_eval")
    cfg = _parse(JC, ["--dataroot", str(tree), "--weights", str(jax_ckpt[0]),
                      *COMMON])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "init_model", lambda mcfg, key: _jax_template(mcfg))
        return JE.evaluate(cfg, save_images=True, result_dir=str(out)), out


ARGVS = [
    [],
    COMMON,
    ["--batch_size", "16", "--nepoch", "200", "--embed_dim", "64", "--warmup",
     "--arch", "BaseModel", "--env", "_x", "--wire_f32", "--no_warm_start",
     "--online_align", "ecc", "--grad_accum", "2", "--in_channels", "4",
     "--no_cache_decoded", "--cache_gb", "2.5", "--resume", "--mixup",
     "--save_every_steps", "7", "--checkpoint", "3", "--optimizer", "adam",
     "--att_se", "--token_mlp", "ffn", "--weights", "w", "--save_images"],
]
# fields the port leaves out on purpose (fbanet_tpu_torch/config.py)
OMITTED = {"model": {"attention_impl", "remat"},
           "train": {"donate_state", "profile_dir"}, "data": set(),
           "eval": set()}


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "tiny", "many"])
def test_from_cli_matches_jax(argv):
    import fbanet_tpu.config as JC
    import fbanet_tpu_torch.config as PC

    port, ref = _parse(PC, argv), _parse(JC, argv)
    for part in ("model", "data", "train", "eval"):
        p, r = getattr(port, part), getattr(ref, part)
        names = {f.name for f in dataclasses.fields(p)}
        assert names == {f.name for f in dataclasses.fields(r)} - OMITTED[part]
        for name in sorted(names):
            assert getattr(p, name) == getattr(r, name), (part, name)
    args = PC.add_cli_args(argparse.ArgumentParser()).parse_args(argv)
    assert args.device == "cuda"


def test_online_align_defaults_agree():
    import fbanet_tpu.config as JC
    import fbanet_tpu.train as JT
    import fbanet_tpu_torch.config as PC
    import fbanet_tpu_torch.evaluate as PE
    import fbanet_tpu_torch.train as PT

    def default(fn):
        return inspect.signature(fn).parameters["online_align"].default

    assert default(JT.make_eval_step) == "none"
    assert JC.DataConfig().online_align == "none"
    assert default(PE.eval_step) == default(PT.make_eval_step) == "none"
    assert PC.DataConfig().online_align == "none"


@pytest.mark.parametrize("boundary", [0, 3])
def test_metrics_match_jax(boundary):
    import jax.numpy as jnp

    from fbanet_tpu import metrics as JM
    from fbanet_tpu_torch import metrics as PM

    rng = np.random.default_rng(boundary)
    pred = rng.uniform(size=(3, 24, 20, 3)).astype(np.float32)
    gt = np.clip(pred + 0.05 * rng.standard_normal(pred.shape), 0, 1
                 ).astype(np.float32)
    mask = (rng.uniform(size=(3, 24, 20, 1)) > 0.3).astype(np.float32)
    tp, tg, tm = map(torch.from_numpy, (pred, gt, mask))
    jp, jg, jm = map(jnp.asarray, (pred, gt, mask))
    kw = dict(boundary_ignore=boundary)
    for average in (True, False):
        np.testing.assert_allclose(
            PM.batch_psnr(tp, tg, average=average, **kw).numpy(),
            np.asarray(JM.batch_psnr(jp, jg, average=average, **kw)),
            rtol=0, atol=1e-5 * (1 if average else 3))
    np.testing.assert_allclose(PM.batch_ssim(tp, tg, **kw).numpy(),
                               np.asarray(JM.batch_ssim(jp, jg, **kw)),
                               rtol=0, atol=1e-6)
    for metric in ("l1", "l2", "l2_sqrt", "charbonnier"):
        for valid in (None, "mask"):
            got = PM.pixelwise_error(tp, tg, metric=metric,
                                     valid=tm if valid else None, **kw)
            want = JM.pixelwise_error(jp, jg, metric=metric,
                                      valid=jm if valid else None, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,psize,overlap",
                         [((2, 16, 16, 3), 8, 4), ((3, 21, 13, 3), 8, 3),
                          ((1, 12, 30, 4), 5, 2)])
def test_divide_merge_match_jax(shape, psize, overlap):
    from fbanet_tpu import tiled as JTL
    from fbanet_tpu_torch import tiled as PTL

    burst = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    tiles = PTL.divide_burst(burst, psize, overlap)
    np.testing.assert_array_equal(tiles, JTL.divide_burst(burst, psize,
                                                           overlap))
    assert PTL.compute_tile_layout(*shape[1:3], psize) == \
        JTL.compute_tile_layout(*shape[1:3], psize)
    hr = np.repeat(np.repeat(tiles[:, 0], 2, 1), 2, 2)  # a x2 "model"
    np.testing.assert_array_equal(
        PTL.merge_tiles(hr, 2 * shape[1], 2 * shape[2], 2 * psize,
                        2 * overlap),
        JTL.merge_tiles(hr, 2 * shape[1], 2 * shape[2], 2 * psize,
                        2 * overlap))


def test_load_params_reads_jax_msgpack(jax_ckpt):
    """The JAX checkpoint read by the port equals the JAX package's own
    export, loads strictly, and gives the forward of the weights drawn."""
    from fbanet_tpu.utils.torch_io import flax_to_torch_state_dict
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.checkpoint import load_params

    import fbanet_tpu_torch.config as PC

    path, params, sd = jax_ckpt
    got = load_params(path)
    want = flax_to_torch_state_dict(params)
    assert got.keys() == want.keys() == sd.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy())
    cfg = _parse(PC, COMMON).model
    a, b = create_model(cfg, device="cpu"), create_model(cfg, device="cpu")
    a.load_state_dict(got, strict=True)
    b.load_state_dict(sd, strict=True)
    x = torch.rand(2, 3, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


def test_evaluate_matches_jax(tree, jax_ckpt, jax_eval, tmp_path, capsys):
    from fbanet_tpu_torch import evaluate as PE

    ref, ref_dir = jax_eval
    got = PE.main(["--dataroot", str(tree), "--weights", str(jax_ckpt[0]),
                   "--save_images", "--result_dir", str(tmp_path), *COMMON,
                   *CPU])
    assert got["num_images"] == ref["num_images"] == 4
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-4, (got, ref)
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-4, (got, ref)
    assert "PSNR:" in capsys.readouterr().out
    from PIL import Image

    names = sorted(p.name for p in ref_dir.glob("*.png"))
    assert names == sorted(p.name for p in tmp_path.glob("*.png"))
    for name in names:
        a = np.asarray(Image.open(tmp_path / name), np.int32)
        b = np.asarray(Image.open(ref_dir / name), np.int32)
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1


def test_lpips_flag_raises_naming_the_roadmap(tree):
    from fbanet_tpu_torch import evaluate as PE

    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        PE.main(["--dataroot", str(tree), "--lpips_weights", "x.npz",
                 *COMMON, *CPU])


def test_tiled_cli(tree, jax_ckpt, tmp_path):
    from PIL import Image

    from fbanet_tpu_torch import tiled as PTL

    out = PTL.main(["--dataroot", str(tree), "--weights", str(jax_ckpt[0]),
                    "--psize", "8", "--overlap", "4",
                    "--result_dir", str(tmp_path), *COMMON, *CPU])
    assert len(out) == 4
    for p in out:
        assert np.asarray(Image.open(p)).shape == (64, 64, 3)


@pytest.mark.parametrize("entry", ["train", "evaluate", "tiled"])
def test_entry_points_need_a_device_named(entry, tree, monkeypatch):
    """Without --device the entry points run on the card, and raise where
    there is none."""
    import importlib

    mod = importlib.import_module(f"fbanet_tpu_torch.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--dataroot", str(tree), *COMMON])


def _train_argv(tree, save, *extra):
    return ["--dataroot", str(tree), "--batch_size", "2", "--nepoch", "2",
            "--save_dir", str(save), "--train_workers", "2",
            "--eval_workers", "2", *COMMON, *CPU, *extra]


def test_train_resume_is_bitwise(tree, tmp_path):
    """Two epochs of 2 steps, uninterrupted and as stop after 1 step (the
    config's `stop_after_steps`, which has no flag in either CLI), then
    --resume: the same parameters, bit for bit, the same per-epoch PSNRs
    and losses, and checkpoints under the reference's names."""
    import fbanet_tpu_torch.config as PC
    from fbanet_tpu_torch import train as PT
    from fbanet_tpu_torch.utils.checkpoint import load_checkpoint

    a = PT.main(_train_argv(tree, tmp_path / "a"))
    cfg = _parse(PC, _train_argv(tree, tmp_path / "b"))
    stop = PT.train(cfg.replace(train=cfg.train.replace(stop_after_steps=1)),
                    device="cpu")
    assert stop["history"][-1]["interrupted"]
    models = tmp_path / "b" / "log" / "BaseModel_" / "models"
    meta = load_checkpoint(models / "model_latest")
    assert (meta["epoch"], meta["step_in_epoch"]) == (1, 1)
    b = PT.main(_train_argv(tree, tmp_path / "b", "--resume"))
    assert [h["epoch"] for h in a["history"]] == [1, 2]
    assert [h["psnr"] for h in a["history"]] == [h["psnr"] for h in b["history"]]
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]
    assert a["params"].keys() == b["params"].keys()
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    names = {p.name for p in models.iterdir()}
    assert {"model_best.pt", "model_best.json", "model_latest.pt",
            "model_latest.json"} <= names
