"""Online burst registration in plain PyTorch, float32: the reference of
the serving path's translation ECC.

Each frame f > 0 is aligned to frame 0 by the enhanced correlation
coefficient (Evangelidis & Psarakis 2008), translation only, on Rec.601
gray over a 3-level binomial pyramid, 25 iterations a level; a frame stops
once its correlation moves by at most 1e-5, the loop once all have
stopped. Frames are then warped by clamped bilinear sampling, rows first.
"""

from __future__ import annotations

import torch

_LUMA = (0.299, 0.587, 0.114)
_BINOMIAL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _separable(img, taps):
    r = len(taps) // 2
    h, w = img.shape[-2:]
    xp = torch.nn.functional.pad(img, (0, 0, r, r))
    x = sum(k * xp[:, i:i + h] for i, k in enumerate(taps))
    xp = torch.nn.functional.pad(x, (r, r))
    return sum(k * xp[:, :, i:i + w] for i, k in enumerate(taps))


def _gradients(img):
    xp = torch.cat([img[:, :, :1], img, img[:, :, -1:]], 2)
    yp = torch.cat([img[:, :1], img, img[:, -1:]], 1)
    return (xp[:, :, 2:] - xp[:, :, :-2]) * 0.5, (yp[:, 2:] - yp[:, :-2]) * 0.5


def _shift(x, t, dim):
    """Sample x [N, ..., L, ...] at i + t[n] along `dim`, linear, clamped."""
    n, length = x.shape[0], x.shape[dim]
    i0 = torch.floor(t)
    f = t - i0
    idx = torch.arange(length, device=x.device, dtype=torch.float32)[None] \
        + i0[:, None]
    j0 = torch.clamp(idx, 0, length - 1).long()
    j1 = torch.clamp(idx + 1, 0, length - 1).long()
    shape = [n] + [1] * (x.dim() - 1)
    shape[dim] = length
    j0, j1 = j0.reshape(shape).expand_as(x), j1.reshape(shape).expand_as(x)
    fs = f.reshape([n] + [1] * (x.dim() - 1))
    return (1 - fs) * torch.gather(x, dim, j0) + fs * torch.gather(x, dim, j1)


def warp(stack, p):
    """[N, C, H, W] sampled at (y + p[:, 1], x + p[:, 0])."""
    return _shift(_shift(stack, p[:, 1], 2), p[:, 0], 3)


def _level(template, image, p, iters, eps):
    n = template.shape[0]
    tbar = template.reshape(n, -1)
    tbar = tbar - tbar.mean(-1, keepdim=True)
    t_norm = torch.sqrt((tbar * tbar).sum(-1)) + 1e-12
    gx, gy = _gradients(image)
    stack = torch.stack([image, gx, gy], 1)
    rho = torch.zeros(n, device=p.device)
    drho = torch.full((n,), float("inf"), device=p.device)
    for _ in range(iters):
        active = drho > eps
        if not bool(active.any()):
            break
        wp = warp(stack, p).reshape(n, 3, -1)
        iw, ix, iy = wp[:, 0], wp[:, 1], wp[:, 2]
        ibar = iw - iw.mean(-1, keepdim=True)
        i_norm2 = (ibar * ibar).sum(-1) + 1e-12
        c00 = (ix * ix).sum(-1) + 1e-8
        c01 = (ix * iy).sum(-1)
        c11 = (iy * iy).sum(-1) + 1e-8
        det = c00 * c11 - c01 * c01

        def solve(b0, b1):
            return (c11 * b0 - c01 * b1) / det, (c00 * b1 - c01 * b0) / det

        gi0, gi1 = (ix * ibar).sum(-1), (iy * ibar).sum(-1)
        gt0, gt1 = (ix * tbar).sum(-1), (iy * tbar).sum(-1)
        ci0, ci1 = solve(gi0, gi1)
        corr = (tbar * ibar).sum(-1)
        lam_num = i_norm2 - (gi0 * ci0 + gi1 * ci1)
        lam_den = corr - (gt0 * ci0 + gt1 * ci1)
        lam = torch.where(lam_den.abs() < 1e-12, torch.ones_like(lam_den),
                          lam_num / lam_den)
        dp = torch.stack(solve(lam * gt0 - gi0, lam * gt1 - gi1), -1)
        dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
        rho2 = corr / (t_norm * torch.sqrt(i_norm2))
        p = torch.where(active[:, None], p + dp, p)
        drho = torch.where(active, (rho2 - rho).abs(), drho)
        rho = torch.where(active, rho2, rho)
    return p, rho


@torch.no_grad()
def register(burst: torch.Tensor, levels: int = 3, iters: int = 25,
             eps: float = 1e-5) -> torch.Tensor:
    """`[B, F, H, W, C]` float32 -> the burst with frames 1.. aligned to 0."""
    b, f, h, w, c = burst.shape
    luma = torch.tensor(_LUMA, device=burst.device)
    gray = (burst * luma).sum(-1)
    tpl = gray[:, :1].expand(b, f - 1, h, w).reshape(-1, h, w)
    img = gray[:, 1:].reshape(-1, h, w)
    pyr_t, pyr_i = [tpl], [img]
    for _ in range(levels - 1):
        pyr_t.append(_separable(pyr_t[-1], _BINOMIAL)[:, ::2, ::2])
        pyr_i.append(_separable(pyr_i[-1], _BINOMIAL)[:, ::2, ::2])
    n = tpl.shape[0]
    p = torch.zeros(n, 2, device=burst.device)
    rho = torch.zeros(n, device=burst.device)
    for lvl in reversed(range(levels)):
        p, rho = _level(pyr_t[lvl], pyr_i[lvl], p, iters, eps)
        if lvl > 0:
            p = p * 2.0
    ok = torch.isfinite(rho) & torch.isfinite(p).all(-1)
    p = torch.where(ok[:, None], p, torch.zeros_like(p))
    frames = burst[:, 1:].reshape(-1, h, w, c).permute(0, 3, 1, 2)
    warped = warp(frames, p).permute(0, 2, 3, 1).reshape(b, f - 1, h, w, c)
    return torch.cat([burst[:, :1], warped], 1)
