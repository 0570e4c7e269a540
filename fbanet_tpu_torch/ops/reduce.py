"""The cross-block sums of the backward kernels K3 and K4, as two small
CUDA kernels (`csrc/reduce.cu`).

On the TPU, `_attention_bwd_kernel` (attention_pallas.py:456-473) and
`_leff_bwd_kernel` (leff_pallas.py:379-401) add each grid step's parameter
gradients into output blocks whose index never changes, which works because
that grid runs in order on one core. Hopper's blocks run in no order, so the
port's backward kernels write what those sums need per token (or per block)
to scratch, and these kernels reduce it in a fixed order, with no atomics:
the same inputs give bitwise the same gradients.

- `token_matmul(a, b)`: `a^T b` over the token axis, `a` [T, M] and `b`
  [T, N] in the compute dtype, f32 out [M, N]: the weight gradients
  (dW = cotangent^T . input). Each block owns one 64 x 64 output tile and a
  fixed slice of the tokens; the slices' partial tiles are then summed in
  slice order by `column_sum`.
- `column_sum(p)`: the column sums of an f32 [R, M] matrix, each column
  summed in row order: the bias, LayerNorm, depthwise and relative-position
  gradients from per-block partials, and the split-token partials above.

Launch or raise on CUDA; on the CPU the plain versions below. Each wrapper
counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import torch

from fbanet_tpu_torch.ops import _build

_TILE = 64  # output tile of the token product kernel
_SMS = 132  # streaming multiprocessors of an H100 SXM


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def token_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 [M, N] = sum over t of a[t, :]^T b[t, :] (f32 accumulation of the
    products of the stored values)."""
    if a.device.type == "cpu":
        return a.float().t() @ b.float()
    t, m = a.shape
    n = b.shape[1]
    if (a.device.type != "cuda" or b.device != a.device or a.dtype != b.dtype
            or a.dtype not in (torch.float32, torch.bfloat16)
            or b.shape[0] != t or m % _TILE or n % _TILE
            or not (a.is_contiguous() and b.is_contiguous())):
        raise ValueError(
            f"token_matmul kernel does not take a {tuple(a.shape)} {a.dtype} "
            f"{a.device}, b {tuple(b.shape)} {b.dtype} {b.device}: both "
            f"contiguous on one CUDA device, float32 or bfloat16, and M, N "
            f"multiples of {_TILE}")
    tiles = (m // _TILE) * (n // _TILE)
    # split the tokens so that ~2 waves of blocks fill the card
    splits = max(1, min(-(-t // 256), -(-2 * _SMS // tiles)))
    chunk = -(-t // splits)
    chunk = -(-chunk // 32) * 32
    splits = -(-t // chunk)
    part = torch.empty(splits, m, n, device=a.device, dtype=torch.float32)
    err = _build.library().fbanet_token_matmul(
        a.data_ptr(), b.data_ptr(), part.data_ptr(), t, m, n, chunk,
        int(a.dtype == torch.bfloat16), _stream(a))
    _build.check(err, "token_matmul")
    token_matmul.launches += 1
    if splits == 1:
        return part[0]
    return column_sum(part.reshape(splits, m * n)).reshape(m, n)


token_matmul.launches = 0


def column_sum(p: torch.Tensor) -> torch.Tensor:
    """f32 [M] = p.sum(0) for an f32 [R, M] matrix, each column summed in
    row order."""
    if p.device.type == "cpu":
        return p.sum(0)
    if p.device.type != "cuda" or p.dtype != torch.float32 or p.dim() != 2 \
            or not p.is_contiguous():
        raise ValueError(f"column_sum kernel does not take {tuple(p.shape)} "
                         f"{p.dtype} {p.device}: a contiguous 2-D float32 "
                         f"CUDA tensor")
    r, m = p.shape
    out = torch.empty(m, device=p.device, dtype=torch.float32)
    err = _build.library().fbanet_column_sum(p.data_ptr(), out.data_ptr(), r,
                                             m, _stream(p))
    _build.check(err, "column_sum")
    column_sum.launches += 1
    return out


column_sum.launches = 0
