"""The kernel-variant slice of the port against the JAX script: the plain
versions of K7 (fbanet_tpu_torch.tools.measure_swin_variants.
variant_attention: every core, ln+qkv1 and ln+nr2) and K8 (variant_leff:
no flag and every LEFF_VARIANTS entry) against the script's Pallas kernels
`variant_attention` / `variant_leff` in interpret mode
(scripts/measure_swin_variants.py, which imports measure_swin_rates by its
top-level name, so scripts/ goes on sys.path; B = 1), at C = 32, 16 px,
2 heads (4 windows of 64 tokens).

Each case runs twice: with both scripts' compute dtype set to f32 (the same
math: 1e-5 absolute) and in bf16 (3e-2 of max(1, max |out|): both versions
round at the same points, and a sum in another order can flip a rounded
intermediate by one ulp; XLA's CPU backend may also keep excess precision
across a chain of bf16 elementwise ops, so K8's bf16 variants are never
compared bitwise).
"""

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t

from fbanet_tpu_torch.tools import measure_swin_variants as mv

ROOT = Path(__file__).resolve().parents[1]
C, RES, HEADS = 32, 16, 2
TOL = {"float32": 1e-5, "bfloat16": 3e-2}

K7_CASES = {
    "loop": dict(core="loop"),
    "stack3d": dict(core="stack3d"),
    "loop_ln": dict(core="loop_ln"),
    "stack3d_ln": dict(core="stack3d_ln"),
    "lanepack": dict(core="lanepack"),
    "ln+qkv1": dict(core="stack3d_ln", qkv1=True),
    "ln+nr2": dict(core="stack3d_ln", nr_override=2),
}


@pytest.fixture(scope="module")
def script():
    """(scripts/measure_swin_variants.py, the measure_swin_rates it
    imported), with B = 1; both leave sys.modules afterwards."""
    names = ("measure_swin_rates", "measure_swin_variants")
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT / "scripts"))
        for name in names:
            sys.modules.pop(name, None)
        variants = importlib.import_module("measure_swin_variants")
        rates = sys.modules["measure_swin_rates"]
        mp.setattr(rates, "B", 1)
        yield variants, rates
        for name in names:
            sys.modules.pop(name, None)


def _set_dtype(script, dtype: str):
    variants, rates = script
    variants.CDTYPE = rates.CDTYPE = jnp.dtype(dtype)


def _to_torch(arrays, linear=(), conv=()):
    """JAX-layout arrays -> torch: [in, out] dense kernels transposed to
    Linear layouts, HWIO depthwise kernels to [ch, 1, 3, 3]."""
    out = []
    for i, a in enumerate(arrays):
        a = np.asarray(jnp.asarray(a, jnp.float32))
        if i in linear:
            a = a.T
        elif i in conv:
            a = a.transpose(3, 2, 0, 1)
        out.append(t(np.ascontiguousarray(a)))
    return out


def _close(got, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(n(got) - ref).max()
    assert err <= TOL[dtype] * (1.0 if dtype == "float32"
                                else max(1.0, np.abs(ref).max())), err


def test_k7_cases_are_the_tools():
    """The cases below are the ones the tool times at an even-headed group
    (plus ln+nr2, which it runs at enc0's shape)."""
    assert [v for v, _ in mv.attention_cases("x", C, RES, HEADS)] + \
        ["ln+nr2"] == list(K7_CASES)
    assert [v for v, _ in mv.attention_cases("enc0", 64, 160, 1)] == [
        "loop", "stack3d", "loop_ln", "stack3d_ln", "ln+qkv1", "ln+nr2"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(K7_CASES))
def test_k7_plain_matches_script_kernel(script, variant, dtype):
    _set_dtype(script, dtype)
    variants, rates = script
    kw = K7_CASES[variant]
    args = rates._attn_args(C, RES, HEADS)
    ref = variants.variant_attention(C, RES, HEADS, **kw)(*args)
    x, *params = _to_torch(args, linear=(3, 5, 7))
    got = mv.variant_attention(C, RES, HEADS, **kw)(
        x.to(getattr(torch, dtype)), *params)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["prod"] + list(mv.LEFF_VARIANTS))
def test_k8_plain_matches_script_kernel(script, variant, dtype):
    _set_dtype(script, dtype)
    variants, rates = script
    kw = mv.LEFF_VARIANTS.get(variant, {})
    assert kw == variants.LEFF_VARIANTS.get(variant, {})
    args = rates._leff_args(C, RES)
    ref = variants.variant_leff(C, RES, **kw)(*args)
    x, *params = _to_torch(args, linear=(3, 7), conv=(5,))
    got = mv.variant_leff(C, RES, **kw)(x.to(getattr(torch, dtype)), *params)
    _close(got, ref, dtype)
