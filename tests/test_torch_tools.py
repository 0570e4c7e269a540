"""The port's measurement tools and the composed x4 tail against the JAX
package:

- `tools.flops_accounting.forward_flops` equal to scripts/flops_accounting.py
  (loaded by path: it imports no JAX) at three configurations, and
  `mfu_fields` on times chosen to give round fractions of the H100 peak;
- `models.blocks.fused_tail_x4` against the JAX `fused_tail_x4` in f32
  (1e-4 of max(1, max |out|): the same linear map, composed in another
  order, float64 here against f32 there), and against the port's
  `tail_x4_direct` (the same function: 1e-5 of the scale on the repaired
  border ring, which both compute directly, 1e-4 inside);
- the variant wrappers refusing what they do not take;
- `tools.profile_components.main` and `tools.measure_swin_variants.main`
  on the CPU at a tiny size (finite, positive numbers).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, normal, t

from fbanet_tpu.models.blocks import fused_tail_x4 as jax_fused_tail_x4
from fbanet_tpu_torch.models.blocks import fused_tail_x4, tail_x4_direct
from fbanet_tpu_torch.tools import flops_accounting, measure_swin_rates
from fbanet_tpu_torch.tools import measure_swin_variants as mv
from fbanet_tpu_torch.tools import profile_components

ROOT = Path(__file__).resolve().parents[1]


def _script_flops():
    spec = importlib.util.spec_from_file_location(
        "_script_flops_accounting", ROOT / "scripts" / "flops_accounting.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("batch,size,frames,embed",
                         [(4, 160, 14, 64), (8, 160, 14, 64),
                          (1, 64, 5, 32)])
def test_forward_flops_match_script(batch, size, frames, embed):
    mine = flops_accounting.forward_flops(batch, size, frames, embed)
    theirs = _script_flops().forward_flops(batch, size, frames, embed)
    assert mine == theirs


def test_mfu_fields_by_hand():
    b, f, s, d = 8, 14, 160, 64
    fwd = sum(flops_accounting.forward_flops(b, s, f, d).values())
    # a forward at 98.9 TFLOP/s is 10 % of 989; a train step at 3 x the
    # forward's flops in fwd * 3 / 494.5e12 s is 50 %
    t_fwd = fwd / 98.9e12
    rate = b / (3 * fwd / 494.5e12)
    got = flops_accounting.mfu_fields(b, f, s, d, t_fwd, rate, b)
    assert got == {"tflops_forward": 98.9, "mfu_forward": 0.1,
                   "tflops_train": 494.5, "mfu_train": 0.5}
    assert flops_accounting.mfu_fields(b, f, s, d, t_fwd, None, b) == {
        "tflops_forward": 98.9, "mfu_forward": 0.1}


def _tail_params(c: int, seed: int = 0):
    """JAX-layout tail parameters: w0, w1 [3, 3, C, 4C], wt [3, 3, C, 3]."""
    return (normal(seed, (3, 3, c, 4 * c), 0.2), normal(seed + 1, (4 * c,), 0.1),
            normal(seed + 2, (3, 3, c, 4 * c), 0.2),
            normal(seed + 3, (4 * c,), 0.1), normal(seed + 4, (3, 3, c, 3), 0.2),
            normal(seed + 5, (3,), 0.1))


def _torch_tail(params):
    w0, b0, w1, b1, wt, bt = params

    def conv(w):
        return t(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))

    return conv(w0), t(b0), conv(w1), t(b1), conv(wt), t(bt)


def test_fused_tail_matches_jax_and_the_direct_tail():
    c, h = 8, 16
    x = normal(10, (2, h, h, c))
    params = _tail_params(c)
    ref = n(jax_fused_tail_x4(jnp.asarray(x), *params, jnp.float32))
    tp = _torch_tail(params)
    got = fused_tail_x4(t(x), *tp, torch.float32)
    assert got.shape == (2, 4 * h, 4 * h, 3)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(n(got) - ref).max() <= 1e-4 * scale
    direct = n(tail_x4_direct(t(x), *tp, torch.float32))
    diff = np.abs(n(got) - direct)
    ring = np.ones(diff.shape[1:3], bool)
    ring[8:-8, 8:-8] = False
    assert diff[:, ring].max() <= 1e-5 * scale
    assert diff.max() <= 1e-4 * scale


def test_variant_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(1, 16, 16, 32)
    with pytest.raises(ValueError, match="qkv1"):
        mv.attention_variant(x, *[None] * 9, heads=2, core="loop", qkv1=True)
    with pytest.raises(ValueError, match="odd"):
        mv._core_lanepack(torch.zeros(1, 64, 48), torch.zeros(1, 64, 96),
                          torch.zeros(1, 64, 128), heads=3,
                          cdtype=torch.float32)
    with pytest.raises(ValueError, match="got x"):
        mv.variant_leff(32, 16)(torch.zeros(1, 8, 8, 32))


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(measure_swin_rates, "B", 1)
    monkeypatch.setattr(mv, "GROUPS", [("enc0", 32, 16, 2), ("dec0", 32, 16, 2)])
    monkeypatch.setattr(measure_swin_rates, "WARMUP", 1)
    monkeypatch.setattr(measure_swin_rates, "ITERS", 2)
    monkeypatch.setattr(profile_components, "WARMUP", 1)
    monkeypatch.setattr(profile_components, "ITERS", 2)


def test_profile_components_runs_on_the_cpu(tiny, capsys):
    ms = profile_components.main(["--batch", "1", "--frames", "3", "--size",
                                  "16", "--embed", "8", "--device", "cpu"])
    assert sorted(ms) == sorted(
        ["loss", "heads", "faf", "enc0_d8@16", "enc1_d16@8", "bott_d32@4",
         "dec0_d32@8", "dec1_d16@16", "tail_fused", "tail_direct",
         "model_fwd", "train", "align"])
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    out = capsys.readouterr().out
    assert out.startswith("device: cpu (cpu) B=1 F=3 16px embed 8 bf16")
    assert " GF " in out and "TF/s" in out


def test_variants_tool_runs_on_the_cpu(tiny, capsys):
    ms = mv.main(["check", "time", "--device", "cpu", "--only=dec0"])
    out = capsys.readouterr().out
    assert out.startswith("backend=cpu B=1 dtype=bfloat16")
    assert "check dec0 loop_ln   : OK" in out and "bitwise=" in out
    timed = {k for k in ms if k.startswith(("var/", "leffvar/"))}
    assert timed == {"var/dec0 prod"} | {
        f"var/dec0 {v}" for v, _ in mv.attention_cases("dec0", 32, 16, 2)} | {
        f"leffvar/dec0 {v}" for v in ["prod", *mv.LEFF_VARIANTS]}
    assert all(np.isfinite(v) and v >= 0 for v in ms.values())
    assert mv.attention_variant.launches == mv.leff_variant.launches == 0
