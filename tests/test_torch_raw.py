"""The RAW (4-channel packed-Bayer) path of the port against the JAX
package, on the CPU at a tiny size.

- (`utils/raw.py` itself against JAX's: tests/test_torch_formats.py.)
- A tiny 4-channel FBANet (2 frames, 16 px, embed 8, window 4, one layer
  a group) forward in
  f32 against JAX's, within 1e-4 of its output and HG2 features
  (test_torch_model's limit); one JAX compile.
- One AdamW step of that model (drop_path 0, B = 2, one microbatch of 2:
  ROADMAP's known behaviour 6) through both `make_train_step`s, sharing
  one JAX compile: the loss within 1e-5 relative, AdamW's first moment (a
  tenth of the gradient) within 1e-4 of each tensor's max, the parameters
  within 5e-6 where sqrt(v_hat) >= 1e-6 (test_torch_train's limits).
- The port's entry points on a 3-burst RAW tree: `train.main` one epoch
  with `--profile_dir` (the trace names the train step's ops), then
  `evaluate --save_images` and `tiled` on its checkpoint. Each PNG is
  `to_uint8(postprocess_raw(prediction, return_rgb=True))`, exactly: the
  evaluate batch recomputed through `eval_step`, tiled's from the `.npy`
  of the packed prediction it writes beside the PNG.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY, flax_params_like, jax_forward, max_err, n, rng, t

from fbanet_tpu_torch.utils import raw

# 2 frames of 16 px, embed 8, window 4, one layer a group: head size 8 in
# every group (the 4 channels touch only the head, the tail and the base)
RAW_TINY = TINY.replace(in_channels=4, num_frames=2, img_size=16,
                        embed_dim=8, window_size=4, depths=(1,) * 9)

def test_raw_forward_matches_jax():
    tmodel, _params, burst, outs = jax_forward(RAW_TINY)
    out_j, feats_j = outs["float32"]
    assert burst.shape == (1, 2, 16, 16, 4)
    with torch.no_grad():
        out, feats = tmodel.forward_with_features(t(burst))
    assert out.shape == (1, 64, 64, 4)
    assert max_err(feats, feats_j) <= 1e-4
    assert max_err(out, out_j) <= 1e-4


@pytest.fixture(scope="module")
def raw_step():
    """One AdamW step at B = 2 (one microbatch of 2) through the JAX
    `make_train_step` (its only compile here) and the port's, from the
    same parameters and data: (port model, optimizer, port loss, JAX
    params, JAX optimizer state, JAX loss)."""
    import dataclasses

    from fbanet_tpu import train as jtrain
    from fbanet_tpu.config import TrainConfig as JaxTrainConfig
    from fbanet_tpu.models import create_model as jax_create_model
    from fbanet_tpu_torch import train
    from fbanet_tpu_torch.config import TrainConfig
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.weights import random_state_dict

    tmodel = create_model(RAW_TINY, device="cpu", seed=3)
    tmodel.load_state_dict(random_state_dict(tmodel, seed=21), strict=True)
    r = rng(7)
    size = RAW_TINY.img_size
    burst = r.uniform(0, 1, (2, 2, size, size, 4)).astype(np.float32)
    hr = r.uniform(0, 1, (2, 4 * size, 4 * size, 4)).astype(np.float32)
    jmodel = jax_create_model(RAW_TINY)
    params = {"params": flax_params_like(jmodel, jnp.asarray(burst),
                                         state_dict=tmodel.state_dict())}
    cfg = TrainConfig(lr_initial=1e-4)
    jcfg = JaxTrainConfig(**dataclasses.asdict(cfg), donate_state=False)
    tx = jtrain.make_optimizer(jcfg)
    jp, state, jloss = jtrain.make_train_step(jmodel, tx, jcfg)(
        params, tx.init(params), jnp.asarray(burst), jnp.asarray(hr),
        jax.random.key(0), cfg.lr_initial)
    opt = train.make_optimizer(tmodel.parameters(), cfg)
    tloss = train.make_train_step(tmodel, opt, cfg)(
        t(burst), t(hr), torch.Generator().manual_seed(0), cfg.lr_initial)
    return tmodel, opt, tloss, jp, state, jloss


def _as_torch(tree) -> dict:
    from fbanet_tpu_torch.utils.weights import jax_params_to_state_dict

    return {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, tree)).items()}


def test_raw_train_step_loss_and_gradient_match_jax(raw_step):
    from test_torch_train import _adam_moments, _assert_tensors_close

    tmodel, opt, tloss, _jp, state, jloss = raw_step
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    moments = {k: n(opt.state[p]["exp_avg"])
               for k, p in tmodel.named_parameters()}
    _assert_tensors_close(moments, _as_torch(_adam_moments(state).mu), 1e-4,
                          "first moment")


def test_raw_train_step_parameters_match_jax(raw_step):
    import math

    tmodel, opt, _tloss, jp, _state, _jloss = raw_step
    ref = _as_torch(jp)
    assert sorted(ref) == sorted(k for k, _ in tmodel.named_parameters())
    for k, p in tmodel.named_parameters():
        err = np.abs(n(p) - ref[k])
        assert err.max() <= 1.1e-4, k  # the most one AdamW step moves
        stable = n(opt.state[p]["exp_avg_sq"].sqrt()
                   >= 1e-6 * math.sqrt(1 - 0.999)).astype(bool)
        assert err[stable].max(initial=0) <= 5e-6, k


RAW_COMMON = ["--train_ps", "16", "--embed_dim", "8", "--win_size", "4",
              "--burst_size", "2", "--dtype", "float32", "--in_channels", "4",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def raw_trained(tmp_path_factory):
    """A 3-burst RAW tree (train and test splits) and one epoch of
    `train.main` on it with `--profile_dir`: (tree, checkpoint, trace)."""
    from fbanet_tpu_torch import train as T
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    root = tmp_path_factory.mktemp("raw_tree")
    write_synthetic_realbsr(root, num_bursts=3, num_frames=2, lr_size=16,
                            channels=4, level=1)
    save = tmp_path_factory.mktemp("raw_log")
    res = T.main(["--dataroot", str(root), "--batch_size", "2", "--nepoch",
                  "1", "--save_dir", str(save), "--train_workers", "1",
                  "--eval_workers", "1", "--profile_dir", str(save / "prof"),
                  *RAW_COMMON])
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0]["loss"])
    return root, res["model_dir"] + "/model_best", save / "prof" / "trace.json"


def test_raw_train_writes_first_epoch_trace(raw_trained):
    trace = json.loads(raw_trained[2].read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in name for name in names), sorted(names)[:20]


def _png(path) -> np.ndarray:
    from fbanet_tpu_torch.data.realbsr import decode_png

    return decode_png(path)


def test_raw_evaluate_saves_postprocessed_pngs(raw_trained, tmp_path):
    from fbanet_tpu_torch import evaluate as E
    from fbanet_tpu_torch.config import add_cli_args, from_cli
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.checkpoint import load_params

    root, ckpt, _ = raw_trained
    res = E.main(["--dataroot", str(root), "--weights", ckpt, "--save_images",
                  "--result_dir", str(tmp_path), *RAW_COMMON])
    assert res["num_images"] == 3 and np.isfinite(res["psnr"])
    ds = RealBSRDataset(root, split="val", burst_size=2, crop_size=16,
                        channels=4, augment=False)
    samples = [ds.load(i) for i in range(len(ds))]
    cfg = from_cli(add_cli_args(argparse.ArgumentParser())
                   .parse_args(RAW_COMMON))
    model = create_model(cfg.model, device="cpu")
    model.load_state_dict(load_params(ckpt), strict=True)
    lr = torch.from_numpy(np.stack([s["LR"] for s in samples]))
    hr = torch.from_numpy(np.stack([s["HR"] for s in samples]))
    pred = E.eval_step(model, lr, hr, boundary_ignore=0)[0]
    want = raw.to_uint8(raw.postprocess_raw(pred, return_rgb=True))
    for img, s in zip(want, samples):
        got = _png(tmp_path / f"{s['burst_name']}.png")
        assert got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, img)


def test_raw_tiled_writes_npy_and_png(raw_trained, tmp_path):
    from fbanet_tpu_torch import tiled as TL

    root, ckpt, _ = raw_trained
    written = TL.main(["--dataroot", str(root), "--weights", ckpt,
                       "--psize", "8", "--overlap", "4",
                       "--result_dir", str(tmp_path), *RAW_COMMON])
    assert len(written) == 3
    for path in written:
        sr = np.load(path.with_suffix(".npy"))
        assert sr.shape == (64, 64, 4) and np.isfinite(sr).all()
        want = raw.to_uint8(raw.postprocess_raw(t(sr), return_rgb=True))
        np.testing.assert_array_equal(_png(path), want)
