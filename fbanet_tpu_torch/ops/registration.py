"""Burst registration by pyramidal ECC, translation model (counterpart of
fbanet_tpu/ops/registration.py, translation path).

Everything runs in f32, batched over all B x (F-1) non-reference frames at
once. JAX runs each frame's `while_loop` under `vmap`, so every frame stops
on its own when its correlation increment |rho - rho_prev| drops to eps;
here a per-frame `active` mask freezes finished frames with `torch.where`,
which gives the same per-frame results. The loop leaves early once no frame
is active: one host read per iteration (a known device sync).

The warp is a clamped bilinear gather. The JAX package applies the same
interpolation as two one-hot matrix products, a TPU workaround for slow
gathers. No convolution library is used (its f32 path may run in TF32 on
the GPU): the pyramid blur and the gradients are shifted sums.

Motion models other than translation raise NotImplementedError for now.
"""

from __future__ import annotations

import torch

_LUMA = (0.299, 0.587, 0.114)  # Rec.601, as cv2.cvtColor(RGB2GRAY)
_BINOMIAL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H, W] f32 via Rec.601 luma (C == 1 squeezes)."""
    if image.shape[-1] == 1:
        return image[..., 0].float()
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=image.device)
    return (image[..., :3].float() * luma).sum(-1)


def _blur_and_halve(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur with zero padding (2, 2), then [::2, ::2]
    (registration.py:112-121). img: [N, H, W]."""
    h, w = img.shape[-2:]
    xp = torch.nn.functional.pad(img, (0, 0, 2, 2))
    x = sum(k * xp[:, i:i + h] for i, k in enumerate(_BINOMIAL))
    xp = torch.nn.functional.pad(x, (2, 2))
    x = sum(k * xp[:, :, i:i + w] for i, k in enumerate(_BINOMIAL))
    return x[:, ::2, ::2]


def _image_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences with edge replication (registration.py:124-129).
    img: [N, H, W] -> (gx, gy)."""
    h, w = img.shape[-2:]
    dev = img.device
    xr = torch.clamp(torch.arange(w, device=dev) + 1, max=w - 1)
    xl = torch.clamp(torch.arange(w, device=dev) - 1, min=0)
    yd = torch.clamp(torch.arange(h, device=dev) + 1, max=h - 1)
    yu = torch.clamp(torch.arange(h, device=dev) - 1, min=0)
    gx = (img[:, :, xr] - img[:, :, xl]) * 0.5
    gy = (img[:, yd] - img[:, yu]) * 0.5
    return gx, gy


def _shift_axis(x: torch.Tensor, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sample `x` [N, ..., L, ...] at `i + t[n]` along `dim` with linear
    interpolation and edge clamping: (1-f) x[clamp(i+i0)] + f x[clamp(i+i0+1)]
    with i0 = floor(t), f = t - i0 (registration.py:140-164)."""
    n, length = x.shape[0], x.shape[dim]
    i0 = torch.floor(t)
    f = t - i0
    idx = torch.arange(length, device=x.device, dtype=torch.float32)[None] + i0[:, None]
    j0 = torch.clamp(idx, 0, length - 1).long()
    j1 = torch.clamp(idx + 1, 0, length - 1).long()
    shape = [n] + [1] * (x.dim() - 1)
    shape[dim] = length
    j0, j1 = j0.reshape(shape).expand_as(x), j1.reshape(shape).expand_as(x)
    fs = f.reshape([n] + [1] * (x.dim() - 1))
    return (1.0 - fs) * torch.gather(x, dim, j0) + fs * torch.gather(x, dim, j1)


def warp_translation(stack: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Warp `[N, C, H, W]` by per-frame translations `p` [N, 2] = (tx, ty):
    output (y, x) samples input (y + ty, x + tx), rows first, then columns,
    as the JAX matrix form does."""
    rows = _shift_axis(stack, p[:, 1], 2)
    return _shift_axis(rows, p[:, 0], 3)


def _solve2(c00, c01, c11, det, b0, b1):
    return (c11 * b0 - c01 * b1) / det, (c00 * b1 - c01 * b0) / det


def _ecc_translation_level(template: torch.Tensor, image: torch.Tensor,
                           p0: torch.Tensor, num_iters: int, eps: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Translation ECC at one pyramid level for N frames at once
    (registration.py:208-261 with _run_ecc_iters' termination, :178-205).
    template, image: [N, h, w]; p0: [N, 2]. Returns (p [N, 2], rho [N])."""
    n = template.shape[0]
    tbar = template.reshape(n, -1)
    tbar = tbar - tbar.mean(-1, keepdim=True)
    t_norm = torch.sqrt((tbar * tbar).sum(-1)) + 1e-12
    gx, gy = _image_gradients(image)
    stack = torch.stack([image, gx, gy], 1)  # [N, 3, h, w]

    p = p0
    rho = torch.zeros(n, device=p0.device)
    drho = torch.full((n,), float("inf"), device=p0.device)
    for _ in range(num_iters):
        active = drho > eps if eps > 0.0 else torch.ones_like(drho, dtype=torch.bool)
        if eps > 0.0 and not bool(active.any()):  # the per-iteration host sync
            break
        warped = warp_translation(stack, p).reshape(n, 3, -1)
        iw, ixw, iyw = warped[:, 0], warped[:, 1], warped[:, 2]
        ibar = iw - iw.mean(-1, keepdim=True)
        i_norm2 = (ibar * ibar).sum(-1) + 1e-12
        c00 = (ixw * ixw).sum(-1) + 1e-8
        c01 = (ixw * iyw).sum(-1)
        c11 = (iyw * iyw).sum(-1) + 1e-8
        det = c00 * c11 - c01 * c01
        gi0, gi1 = (ixw * ibar).sum(-1), (iyw * ibar).sum(-1)
        gt0, gt1 = (ixw * tbar).sum(-1), (iyw * tbar).sum(-1)
        ci0, ci1 = _solve2(c00, c01, c11, det, gi0, gi1)
        corr = (tbar * ibar).sum(-1)
        lam_num = i_norm2 - (gi0 * ci0 + gi1 * ci1)
        lam_den = corr - (gt0 * ci0 + gt1 * ci1)
        lam = torch.where(lam_den.abs() < 1e-12, torch.ones_like(lam_den),
                          lam_num / lam_den)
        dp = torch.stack(_solve2(c00, c01, c11, det, lam * gt0 - gi0,
                                 lam * gt1 - gi1), -1)
        dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
        rho2 = corr / (t_norm * torch.sqrt(i_norm2))
        p = torch.where(active[:, None], p + dp, p)
        drho = torch.where(active, (rho2 - rho).abs(), drho)
        rho = torch.where(active, rho2, rho)
    return p, rho


def ecc_translation(template: torch.Tensor, image: torch.Tensor, *,
                    levels: int = 3, iters_per_level: int = 25,
                    eps: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Translation that aligns each `image` [N, H, W] to its `template`
    [N, H, W] (ecc_align, registration.py:339-390): coarse-to-fine over a
    binomial pyramid; a non-finite result falls back to identity with
    rho = -1. Returns (p [N, 2] = (tx, ty) mapping template to image
    coordinates, rho [N])."""
    pyr_t, pyr_i = [template.float()], [image.float()]
    for _ in range(levels - 1):
        pyr_t.append(_blur_and_halve(pyr_t[-1]))
        pyr_i.append(_blur_and_halve(pyr_i[-1]))
    n = template.shape[0]
    # the JAX S M S^-1 level rescaling is exact for a translation: p * s
    p = torch.zeros(n, 2, device=template.device)
    rho = torch.zeros(n, device=template.device)
    for lvl in reversed(range(levels)):
        p, rho = _ecc_translation_level(pyr_t[lvl], pyr_i[lvl], p,
                                        iters_per_level, eps)
        if lvl > 0:
            p = p * 2.0
    ok = torch.isfinite(rho) & torch.isfinite(p).all(-1)
    p = torch.where(ok[:, None], p, torch.zeros_like(p))
    rho = torch.where(ok, rho, torch.full_like(rho, -1.0))
    return p, rho


def align_burst(burst: torch.Tensor, *, motion: str = "translation",
                levels: int = 3, iters_per_level: int = 25, eps: float = 0.0
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align every frame of `[B, F, H, W, C]` (or `[F, H, W, C]`) to frame 0
    with bilinear warps (registration.py:431-484). Returns (aligned,
    matrices [.., F, 3, 3], rhos [.., F]); frame 0 keeps the identity and
    stays bit-identical."""
    if motion != "translation":
        raise NotImplementedError(
            f"align_burst: only translation motion is ported (got "
            f"motion={motion!r})")
    if burst.dim() == 4:
        a, m, r = align_burst(burst[None], motion=motion, levels=levels,
                              iters_per_level=iters_per_level, eps=eps)
        return a[0], m[0], r[0]
    b, f, h, w, c = burst.shape
    gray = rgb_to_gray(burst)  # [B, F, H, W]
    template = gray[:, :1].expand(b, f - 1, h, w).reshape(-1, h, w)
    p, rho = ecc_translation(template, gray[:, 1:].reshape(-1, h, w),
                             levels=levels, iters_per_level=iters_per_level,
                             eps=eps)
    mats = torch.eye(3, device=burst.device).repeat(b, f, 1, 1)
    mats[:, 1:, 0, 2] = p[:, 0].reshape(b, f - 1)
    mats[:, 1:, 1, 2] = p[:, 1].reshape(b, f - 1)
    rhos = torch.ones(b, f, device=burst.device)
    rhos[:, 1:] = rho.reshape(b, f - 1)

    frames = burst[:, 1:].float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    warped = warp_translation(frames, p).permute(0, 2, 3, 1)
    warped = warped.reshape(b, f - 1, h, w, c).to(burst.dtype)
    return torch.cat([burst[:, :1], warped], 1), mats, rhos


@torch.no_grad()
def online_register(batch: torch.Tensor, method: str = "ecc") -> torch.Tensor:
    """Register `[B, F, H, W, C]` to frame 0 in an eval step
    (registration.py:394-420): translation ECC, 3 levels x 25 iterations,
    eps 1e-5. The "flow" method is not ported yet."""
    if method == "ecc":
        return align_burst(batch, motion="translation", levels=3,
                           iters_per_level=25, eps=1e-5)[0]
    if method == "flow":
        raise NotImplementedError("online_register: 'flow' is not ported yet")
    raise ValueError(f"unknown online registration method {method}")
