"""The port's convergence proof (fbanet_tpu_torch/tools/convergence_proof.py)
at a tiny size on the CPU: 2 bursts of 2 frames at 32 px LR (HR 128, so the
40 px boundary crop leaves pixels), embed 8, batch 2, one epoch of one step.

- The bilinear-base PSNR of the val split equals the JAX script's way of
  computing it (scripts/convergence_proof.py:71-87: the JAX dataset and
  loader, `jax.image.resize(..., "bilinear")`, the JAX `psnr` and
  `finite_average`) within 1e-4 dB: the same f32 interpolation weights and
  squared errors, summed in another order.
- The untrained model's eval PSNR (`train.evaluate_psnr` of a fresh
  `create_model`) equals the base within 1e-6 dB: its zero `tail_conv`
  makes its output exactly the bilinear base.
- Epoch 1's eval PSNR is the base within 1e-3 dB: one warmup step of
  AdamW at lr 1e-4 / 3 moves each weight by about 3.3e-5 (AdamW's first
  step moves an element by lr whatever its gradient), `tail_conv`'s too,
  which moves the output, and so the PSNR by up to a few 1e-4 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

FRAMES, LR_SIZE, BATCH = 2, 32, 2


def _jax_base_psnr(ds_root) -> float:
    from fbanet_tpu.data.loader import BurstLoader
    from fbanet_tpu.data.realbsr import RealBSRDataset
    from fbanet_tpu.metrics import finite_average, psnr

    val = RealBSRDataset(ds_root, split="val", burst_size=FRAMES,
                         crop_size=LR_SIZE, cache_decoded=True)
    loader = BurstLoader(val, batch_size=BATCH, num_workers=4,
                         drop_last=False)

    @jax.jit
    def base_psnr(lr, hr):
        b, f, h, w, c = lr.shape
        base = jax.image.resize(lr[:, 0], (b, 4 * h, 4 * w, c), "bilinear")
        return psnr(jnp.clip(base, 0, 1), hr, boundary_ignore=40)

    vals, count = [], 0
    for batch in loader.epoch(0):
        v = np.asarray(base_psnr(jnp.asarray(batch["LR"]),
                                 jnp.asarray(batch["HR"])))
        vals.extend(v.tolist())
        count += len(v)
    return finite_average(vals, count)


def test_convergence_proof_tiny(tmp_path):
    from fbanet_tpu_torch.tools import convergence_proof as cp

    res = cp.main(["--out", str(tmp_path), "--bursts", "2", "--frames",
                   str(FRAMES), "--lr_size", str(LR_SIZE), "--epochs", "1",
                   "--embed_dim", "8", "--batch_size", str(BATCH),
                   "--device", "cpu"])
    assert np.isfinite(res["base"])
    assert abs(res["base"] - _jax_base_psnr(tmp_path / "ds")) <= 1e-4
    assert [h["epoch"] for h in res["history"]] == [1]
    assert res["history"][0]["steps"] == 1
    assert abs(res["history"][0]["psnr"] - res["base"]) <= 1e-3

    from fbanet_tpu_torch.data.loader import BurstLoader
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset
    from fbanet_tpu_torch.models import ModelConfig, create_model
    from fbanet_tpu_torch.train import evaluate_psnr, make_eval_step

    fresh = create_model(ModelConfig(num_frames=FRAMES, img_size=LR_SIZE,
                                     embed_dim=8, dtype="float32"),
                         device="cpu", seed=1)
    val = RealBSRDataset(tmp_path / "ds", split="val", burst_size=FRAMES,
                         crop_size=LR_SIZE, cache_decoded=True)
    untrained = evaluate_psnr(make_eval_step(fresh), BurstLoader(
        val, batch_size=BATCH, num_workers=1, drop_last=False, device="cpu",
        pad_last=True), 0)
    assert abs(untrained - res["base"]) <= 1e-6
    assert (tmp_path / "history.json").exists() and res["device"] == "cpu"
