"""The cross-block sums of the backward kernels K3 and K4, as two CUDA
kernels (`csrc/reduce.cu`).

On the TPU, `_attention_bwd_kernel` (attention_pallas.py:456-473) and
`_leff_bwd_kernel` (leff_pallas.py:379-401) add each grid step's parameter
gradients into output blocks whose index never changes, which works because
that grid runs in order on one core. Hopper's blocks run in no order, so the
port's backward kernels write what those sums need per token (or per block)
to scratch, and these kernels reduce it in a fixed order, with no float
atomics: the same inputs give bitwise the same gradients.

- `token_matmul(a, b)`: `a^T b` over the token axis, `a` [T, M] and `b`
  [T, N] in the compute dtype, f32 out [M, N]: the weight gradients
  (dW = cotangent^T . input). In bf16 each block owns one output tile of up
  to 128 x 256 and a fixed slice of the tokens, streamed through a TMA ring
  into wgmma; after a grid barrier the blocks add the slices' partial tiles
  in a fixed order. `_token_matmul_plan` fixes tiles and slices from the
  shapes alone. M and N are multiples of 32: a width of 32 (FBANet-32's
  enc0) is the masked half of a 64-wide edge tile.
- `column_sum(p)`: the column sums of an f32 [R, M] matrix: the bias,
  LayerNorm, depthwise and relative-position gradients from per-block
  partials. Blocks sum fixed row slices of 128-column bands in a fixed
  order; the last block of a band adds the slices in slice order
  (`_column_sum_plan`).

Launch or raise on CUDA; on the CPU the plain versions below. Each wrapper
counts its calls that launch in `.launches`. The kernels' scratch (slice
partials, barrier and band counters) is kept per device and reused by every
call: the port launches all its work on the current stream, which orders
those calls.
"""

from __future__ import annotations

import functools

import torch

from fbanet_tpu_torch.ops import _build

_SMS = 132  # streaming multiprocessors of an H100 SXM (the plans' default)
_STAGE = 64  # tokens per ring stage of the bf16 kernel
_F32_TILE, _F32_STAGE = 64, 32  # the f32 kernel's tile and token stage
# bf16 output tiles (tile_m, tile_n, fewest M N outputs), largest first;
# 64 x 64 below them all. With one block per SM, every slice writes an f32
# partial of the whole output, about SMs x tile_m x tile_n floats, read back
# for the slices' sum; on the card that costs more than reading the inputs
# from L2 once per tile row or column, so a larger tile must come with
# proportionally more tiles (fewer slices) to pay (tools/measure_reduce.py
# `plans`).
_TILES = ((128, 128, 1 << 18), (128, 64, 1 << 16), (64, 128, 1 << 16))
# fewest ring stages per token slice: a slice's partial tile stays small
# beside the inputs it sums
_MIN_SLICE_STAGES = 8
_BAND = 128  # columns per column_sum block: 32 lanes x float4 (x 1 where
#              M % 4 != 0)
_COLUMN_BLOCKS_PER_SM = 4  # column_sum blocks that fill the card
_MIN_SLICE_ROWS = 64  # fewest rows per column_sum slice (8 per warp)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def _token_matmul_plan(t: int, m: int, n: int, bf16: bool = True,
                       sms: int = _SMS) -> tuple[int, int, int, int]:
    """(tile_m, tile_n, chunk, splits) of `token_matmul`'s kernel for a
    [T, M] x [T, N] product: the output tile of one block, and the token
    slices [s chunk, min(T, (s + 1) chunk)) for s < splits, each summed by
    its own blocks. bf16: the first tile of `_TILES` that divides the
    output and whose least output size it reaches, else 64 x 64 (with
    masked edge tiles where M or N is an odd multiple of 32); slices of
    whole 64-token stages, as many as fill the card's `sms` SMs once (one
    block per SM, all resident for the grid barrier before the slices'
    sum) but at least `_MIN_SLICE_STAGES` stages each. f32: 64 x 64 tiles,
    about two waves of blocks, 32-token stages."""
    if bf16:
        tile_m, tile_n = next(((bm, bn) for bm, bn, least in _TILES
                               if m * n >= least and not m % bm
                               and not n % bn), (64, 64))
        stage = _STAGE
        stages = _cdiv(t, stage)
        tiles = _cdiv(m, tile_m) * _cdiv(n, tile_n)
        splits = max(1, min(sms // tiles, stages // _MIN_SLICE_STAGES))
    else:
        tile_m = tile_n = _F32_TILE
        stage = _F32_STAGE
        stages = _cdiv(t, stage)
        tiles = _cdiv(m, tile_m) * _cdiv(n, tile_n)
        splits = max(1, min(_cdiv(t, 256), _cdiv(2 * sms, tiles)))
    chunk = _cdiv(stages, splits) * stage
    return tile_m, tile_n, chunk, _cdiv(t, chunk)


def _column_bands(m: int) -> int:
    return _cdiv(m, _BAND if m % 4 == 0 else _BAND // 4)


@functools.lru_cache(maxsize=1024)
def _column_sum_plan(r: int, m: int, sms: int = _SMS) -> tuple[int, int]:
    """(rows_per_slice, slices) of `column_sum`'s kernel for an [R, M]
    matrix: bands of 128 columns (32 where M % 4 != 0) times row slices of
    at least `_MIN_SLICE_ROWS` rows, about `_COLUMN_BLOCKS_PER_SM` blocks
    per SM in all."""
    bands = _column_bands(m)
    slices = max(1, min(_cdiv(_COLUMN_BLOCKS_PER_SM * sms, bands),
                        r // _MIN_SLICE_ROWS))
    rows = _cdiv(r, slices)
    return rows, _cdiv(r, rows)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_buffers: dict[tuple[int, str], torch.Tensor] = {}


def _buffer(index: int, name: str, numel: int, dtype: torch.dtype
            ) -> torch.Tensor:
    """Device `index`'s scratch `name`, at least `numel` long: int32
    counters start zeroed, and the kernels leave them zeroed."""
    have = _buffers.get((index, name))
    if have is None or have.numel() < numel:
        have = torch.zeros(max(numel, 1024), device=f"cuda:{index}",
                           dtype=dtype)
        _buffers[(index, name)] = have
    return have


_R1_DTYPES = (torch.float32, torch.bfloat16)


def _refuse(what: str, tensors: str, why: str):
    raise ValueError(f"{what} kernel does not take {tensors}: {why}")


def _describe(**named: torch.Tensor) -> str:
    return ", ".join(f"{k} {tuple(v.shape)} {v.dtype} {v.device}"
                     for k, v in named.items())


def _check_token_matmul(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise ValueError naming the shapes if the kernel does not take
    (a, b): both 2-D [T, M] and [T, N] with T > 0, one dtype (float32 or
    bfloat16), contiguous, M and N multiples of 32, on one CUDA device,
    16-byte aligned."""
    def no(why):
        _refuse("token_matmul", _describe(a=a, b=b), why)

    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
            or a.shape[0] == 0:
        no("a [T, M] and b [T, N] with the same T > 0")
    if a.dtype != b.dtype or a.dtype not in _R1_DTYPES:
        no("a and b of one dtype, float32 or bfloat16")
    if not (a.is_contiguous() and b.is_contiguous()):
        no("contiguous a and b")
    if a.shape[1] % 32 or b.shape[1] % 32:
        no("M and N multiples of 32 (half the 64-wide output tile)")
    if a.device.type != "cuda" or b.device != a.device:
        no("a and b on one CUDA device")
    if (a.data_ptr() | b.data_ptr()) % 16:
        no("a and b 16-byte aligned (TMA)")


def token_matmul(a: torch.Tensor, b: torch.Tensor,
                 plan: tuple[int, int, int, int] | None = None
                 ) -> torch.Tensor:
    """f32 [M, N] = sum over t of a[t, :]^T b[t, :] (f32 accumulation of the
    products of the stored values). `plan` replaces `_token_matmul_plan`'s
    (tile_m, tile_n, chunk, splits) on CUDA, for comparing plans
    (tools/measure_reduce.py `plans`)."""
    if a.device.type == "cpu":
        return a.float().t() @ b.float()
    _check_token_matmul(a, b)
    t, m = a.shape
    n = b.shape[1]
    bf16 = a.dtype == torch.bfloat16
    index = a.get_device()
    tile_m, tile_n, chunk, splits = plan or _token_matmul_plan(
        t, m, n, bf16, _sms(index))
    out = a.new_empty((m, n), dtype=torch.float32)
    part = out if splits == 1 else _buffer(index, "token_matmul",
                                           splits * m * n, torch.float32)
    err = _build.library().fbanet_token_matmul(
        a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(),
        _buffer(index, "barrier", 2, torch.int32).data_ptr(), t, m, n, chunk,
        tile_m, tile_n, int(bf16), _build.stream(a))
    _build.check(err, "token_matmul")
    token_matmul.launches += 1
    if bf16 or splits == 1:
        return out
    # f32: the slices' partials, summed in a fixed order
    return column_sum(part[:splits * m * n].view(splits, m * n)).view(m, n)


token_matmul.launches = 0


def _check_column_sum(p: torch.Tensor) -> None:
    """Raise ValueError naming the shape if the kernel does not take p:
    a contiguous 2-D float32 [R, M] with R, M > 0 on a CUDA device,
    16-byte aligned."""
    def no(why):
        _refuse("column_sum", _describe(p=p), why)

    if p.dim() != 2 or p.shape[0] == 0 or p.shape[1] == 0:
        no("a 2-D [R, M] matrix with R, M > 0")
    if p.dtype != torch.float32:
        no("float32")
    if not p.is_contiguous():
        no("a contiguous matrix")
    if p.device.type != "cuda":
        no("a CUDA tensor")
    if p.data_ptr() % 16:
        no("16-byte aligned")


def column_sum(p: torch.Tensor) -> torch.Tensor:
    """f32 [M] = p.sum(0) for an f32 [R, M] matrix, in an order fixed by
    the shape."""
    if p.device.type == "cpu":
        return p.sum(0)
    _check_column_sum(p)
    r, m = p.shape
    index = p.get_device()
    rows, slices = _column_sum_plan(r, m, _sms(index))
    out = p.new_empty(m)
    part = counters = None
    if slices > 1:
        part = _buffer(index, "column_sum", slices * m, torch.float32)
        counters = _buffer(index, "bands", _column_bands(m), torch.int32)
    err = _build.library().fbanet_column_sum(
        p.data_ptr(), None if part is None else part.data_ptr(),
        out.data_ptr(), None if counters is None else counters.data_ptr(),
        r, m, rows, _build.stream(p))
    _build.check(err, "column_sum")
    column_sum.launches += 1
    return out


column_sum.launches = 0
