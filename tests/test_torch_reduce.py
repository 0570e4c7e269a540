"""ops/reduce.py on the CPU: the kernels' plans, the plain versions against
numpy float64, and what the wrappers refuse.

The kernels themselves (`csrc/reduce.cu`) run only on the card, where
`chip_smoke.py` (through `tools/measure_reduce.py`) holds them against
these plain versions at every shape of the B=8 train step. What they share
with the CPU is here: the plans that fix each kernel's tiles and slices,
and so the order of every sum, from the shapes alone.
"""

import numpy as np
import pytest
import torch

from fbanet_tpu_torch.ops import reduce
from fbanet_tpu_torch.tools import measure_reduce

SMS = 132
# shapes the main path gives the kernels: the B=8 train step's, B=2's (the
# f32 gradient check) and ragged token counts
R1_MAIN = sorted({(t, m, n) for batch in (8, 2)
                  for _g, _p, t, m, n in measure_reduce.r1_shapes(batch)})
R1_RAGGED = [(t, m, n) for t in (1, 63, 64, 65, 511, 513, 12_799, 204_801)
             for m, n in ((64, 64), (128, 64), (64, 256), (512, 128),
                          (1024, 256), (256, 1024))]
R2_MAIN = sorted({(r, m) for batch in (8, 2)
                  for *_x, r, m in measure_reduce.r2_shapes(batch)}
                 # K4's WMMA form (the f32 gradient check): 8 x 8 tiles
                 | {(batch * (h // 8) ** 2, 47 * c) for batch in (8, 2)
                    for _g, h, c, _heads in measure_reduce.GROUPS})
R2_RAGGED = [(r, m) for r in (1, 7, 63, 64, 65, 800, 3201)
             for m in (1, 3, 64, 130, 6016, 67_072)]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("t,m,n", R1_MAIN + R1_RAGGED)
def test_token_matmul_plan(t, m, n, bf16):
    tile_m, tile_n, chunk, splits = reduce._token_matmul_plan(t, m, n, bf16)
    stage = 64 if bf16 else 32
    if bf16:
        # 128 x 128 from 2^18 outputs, 128 x 64 (else 64 x 128) from 2^16,
        # else 64 x 64
        if m * n >= 1 << 18 and not m % 128 and not n % 128:
            assert (tile_m, tile_n) == (128, 128)
        elif m * n >= 1 << 16 and not m % 128:
            assert (tile_m, tile_n) == (128, 64)
        elif m * n >= 1 << 16 and not n % 128:
            assert (tile_m, tile_n) == (64, 128)
        else:
            assert (tile_m, tile_n) == (64, 64)
    else:
        assert tile_m == tile_n == 64
    assert m % tile_m == 0 and n % tile_n == 0
    # slices [s chunk, min(T, (s + 1) chunk)) cover [0, T) exactly, in
    # order, each a whole number of stages and none empty
    assert chunk > 0 and chunk % stage == 0 and splits >= 1
    assert (splits - 1) * chunk < t <= splits * chunk
    tiles = (m // tile_m) * (n // tile_n)
    if bf16:
        # one wave of one block per SM (the slices' f32 partials are then at
        # most one output tile per SM), and no slice shorter than the
        # minimum unless the tokens run out
        assert splits == 1 or tiles * splits <= SMS
        assert splits == 1 or chunk >= 64 * reduce._MIN_SLICE_STAGES
    else:
        # about two waves of blocks
        assert splits == 1 or tiles * splits <= 2 * SMS + tiles


@pytest.mark.parametrize("r,m", R2_MAIN + R2_RAGGED)
def test_column_sum_plan(r, m):
    rows, slices = reduce._column_sum_plan(r, m)
    assert rows >= 1 and slices >= 1
    assert (slices - 1) * rows < r <= slices * rows
    assert slices == 1 or rows >= reduce._MIN_SLICE_ROWS
    bands = reduce._column_bands(m)
    assert bands * (128 if m % 4 == 0 else 32) >= m
    # enough blocks to fill the card where the rows allow it
    if r >= reduce._MIN_SLICE_ROWS * 4 * SMS:
        assert bands * slices >= 4 * SMS


def _bits(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("t,m,n", [(1, 64, 64), (65, 64, 128),
                                   (300, 128, 64), (512, 64, 256)])
def test_token_matmul_plain_matches_float64(t, m, n, dtype):
    r = np.random.default_rng(t + m + n)
    a = _bits(r.standard_normal((t, m), dtype=np.float32), dtype)
    b = _bits(r.standard_normal((t, n), dtype=np.float32), dtype)
    got = reduce.token_matmul(a, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    a64, b64 = a.double().numpy(), b.double().numpy()
    ref = a64.T @ b64
    # f32 products and an f32 sum of T terms err by at most
    # gamma_T * sum |terms| ~ T * 2^-24 * sum |terms| (the worst-case bound
    # of a dot product; bf16 products are exact in f32)
    tol = (t + 1) * 2.0 ** -24 * (np.abs(a64).T @ np.abs(b64))
    assert np.all(np.abs(got.double().numpy() - ref) <= tol)


@pytest.mark.parametrize("r,m", [(1, 5), (64, 128), (800, 1504),
                                 (333, 130)])
def test_column_sum_plain_matches_float64(r, m):
    p = np.random.default_rng(r * m).standard_normal((r, m),
                                                     dtype=np.float32)
    got = reduce.column_sum(torch.from_numpy(p))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m,)
    p64 = p.astype(np.float64)
    tol = r * 2.0 ** -24 * np.abs(p64).sum(0)
    assert np.all(np.abs(got.double().numpy() - p64.sum(0)) <= tol)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("a,b,why", [
    (_meta(128, 64), _meta(128, 64), "one CUDA device"),
    (_meta(128, 64), _meta(128, 64, dtype=torch.float32), "one dtype"),
    (_meta(128, 64, dtype=torch.float16), _meta(128, 64, dtype=torch.float16),
     "one dtype"),
    (_meta(64, 128).t(), _meta(128, 64), "contiguous"),
    (_meta(128, 64), _meta(64, 128).t(), "contiguous"),
    (_meta(128, 96), _meta(128, 64), "multiples of the 64-wide"),
    (_meta(128, 64), _meta(128, 32), "multiples of the 64-wide"),
    (_meta(128, 64), _meta(127, 64), "the same T"),
    (_meta(0, 64), _meta(0, 64), "the same T > 0"),
    (_meta(128), _meta(128, 64), r"a \[T, M\]"),
], ids=["meta", "mixed-dtype", "float16", "a-strided", "b-strided", "M-96",
        "N-32", "T-mismatch", "T-0", "1-D"])
def test_token_matmul_refuses(a, b, why):
    with pytest.raises(ValueError, match=why) as info:
        reduce.token_matmul(a, b)
    assert "token_matmul kernel does not take" in str(info.value)
    assert str(tuple(a.shape)) in str(info.value)


@pytest.mark.parametrize("p,why", [
    (_meta(800, 6016, dtype=torch.float32), "a CUDA tensor"),
    (_meta(800, 6016), "float32"),
    (_meta(800, 6016, dtype=torch.float64), "float32"),
    (_meta(6016, 800, dtype=torch.float32).t(), "contiguous"),
    (_meta(6016, dtype=torch.float32), r"2-D \[R, M\]"),
    (_meta(0, 64, dtype=torch.float32), "R, M > 0"),
], ids=["meta", "bf16", "f64", "strided", "1-D", "R-0"])
def test_column_sum_refuses(p, why):
    with pytest.raises(ValueError, match=why) as info:
        reduce.column_sum(p)
    assert "column_sum kernel does not take" in str(info.value)


def test_measure_reduce_main_on_cpu():
    """The tool's shapes mode end to end on the plain versions, at a tiny
    size: every R1 and R2 shape, sums over each kernel's shapes."""
    res = measure_reduce.main(["shapes", "--device", "cpu", "--batch", "1",
                               "--size", "32"])["shapes"]
    assert len(res["R1"]) == 25 and len(res["R2"]) == 12
    assert all(r["rel_err"] == 0.0 and r["bitwise_repeat"]
               for k in ("R1", "R2") for r in res[k])
    assert res["sums"]["R1"]["bound_by"] == "bytes"
    assert res["sums"]["R2"]["ms"] > 0
