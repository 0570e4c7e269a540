"""Burst registration by pyramidal ECC, every motion model (counterpart of
fbanet_tpu/ops/registration.py).

Everything runs in f32, batched over all B x (F-1) non-reference frames at
once. JAX runs each frame's `while_loop` under `vmap`, so every frame stops
on its own when its correlation increment |rho - rho_prev| drops to eps.

Translation ECC on a CUDA tensor is one kernel launch, `ecc_translation`
(`csrc/ecc.cu`): one block a frame builds the pyramid and iterates every
level on the card, each frame stopping on its own, with no host read. On
the CPU, or with `plain=True`, its plain version runs the frames together:
a per-frame `active` mask freezes finished frames with `torch.where`, which
gives the same per-frame results, and the loop leaves early once no frame
is active, one host read per iteration (a device sync on a card).

Translation warps are clamped bilinear gathers along each axis (the JAX
package applies them as one-hot matrix products, a TPU workaround for slow
gathers). The other motions (euclidean, similarity, affine, homography)
warp the `[image, gx, gy]` stack at the motion's dense source positions
through K6 (`warp_kernels.warp_burst_coords`) in every iteration, and
`align_burst` warps their frames through K5 (`warp_burst_bilinear`). The
Jacobian of the source positions is closed-form, d(position)/dp through
dM/dp per motion (JAX takes `jax.jacfwd` of the same map), and the P x P
normal equations go to `torch.linalg.solve_ex`, which never reads its status
back to the host. No convolution library is used (its f32 path may run in
TF32 on the GPU): the pyramid blur and the gradients are shifted sums. The
normal equations need full f32 matrix products (bf16 and TF32 are unusable
there), PyTorch's default on the GPU.
"""

from __future__ import annotations

import torch

from fbanet_tpu_torch.ops import _build
from fbanet_tpu_torch.ops.warp import warp_burst_homography, warp_flow
from fbanet_tpu_torch.ops.warp_kernels import warp_burst_bilinear, warp_burst_coords
from fbanet_tpu_torch.utils.profiling import annotate

_LUMA = (0.299, 0.587, 0.114)  # Rec.601, as cv2.cvtColor(RGB2GRAY)
_BINOMIAL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
_NUM_PARAMS = {"translation": 2, "euclidean": 3, "similarity": 4,
               "affine": 6, "homography": 8}
# dM/dp of the motions whose matrix is linear in p: per parameter, the
# (row, column, value) entries of the derivative
_LINEAR_DM = {
    "similarity": [[(0, 0, 1.0), (1, 1, 1.0)], [(0, 1, -1.0), (1, 0, 1.0)],
                   [(0, 2, 1.0)], [(1, 2, 1.0)]],
    "affine": [[(k // 3, k % 3, 1.0)] for k in range(6)],
    "homography": [[(k // 3, k % 3, 1.0)] for k in range(8)],
}


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H, W] f32 via Rec.601 luma (C == 1 squeezes)."""
    if image.shape[-1] == 1:
        return image[..., 0].float()
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=image.device)
    return (image[..., :3].float() * luma).sum(-1)


def _motion_check(motion: str) -> None:
    if motion not in _NUM_PARAMS:
        raise ValueError(f"unknown motion model {motion}")


def params_to_matrix(p: torch.Tensor, motion: str) -> torch.Tensor:
    """Motion parameters [..., P] -> warp matrices [..., 3, 3] in (x, y, 1)
    coordinates (registration.py:57-82)."""
    _motion_check(motion)
    one, zero = torch.ones_like(p[..., 0]), torch.zeros_like(p[..., 0])
    if motion == "translation":
        rows = [one, zero, p[..., 0], zero, one, p[..., 1]]
    elif motion == "euclidean":
        c, s = torch.cos(p[..., 0]), torch.sin(p[..., 0])
        rows = [c, -s, p[..., 1], s, c, p[..., 2]]
    elif motion == "similarity":  # p = (a, b, tx, ty), a = s cos, b = s sin
        a, b = p[..., 0], p[..., 1]
        rows = [a, -b, p[..., 2], b, a, p[..., 3]]
    elif motion == "affine":
        rows = list(p.unbind(-1))
    else:
        return torch.cat([p, one[..., None]], -1).reshape(*p.shape[:-1], 3, 3)
    return torch.stack(rows + [zero, zero, one], -1).reshape(
        *p.shape[:-1], 3, 3)


def matrix_to_params(m: torch.Tensor, motion: str) -> torch.Tensor:
    """Warp matrices [..., 3, 3] -> motion parameters [..., P], the inverse
    of `params_to_matrix` (euclidean through arctan2)."""
    _motion_check(motion)
    m = m / m[..., 2:3, 2:3]
    if motion == "translation":
        return torch.stack([m[..., 0, 2], m[..., 1, 2]], -1)
    if motion == "euclidean":
        return torch.stack([torch.atan2(m[..., 1, 0], m[..., 0, 0]),
                            m[..., 0, 2], m[..., 1, 2]], -1)
    if motion == "similarity":
        return torch.stack([m[..., 0, 0], m[..., 1, 0], m[..., 0, 2],
                            m[..., 1, 2]], -1)
    if motion == "affine":
        return m[..., :2, :].reshape(*m.shape[:-2], 6)
    return m.reshape(*m.shape[:-2], 9)[..., :8]


def identity_params(motion: str) -> torch.Tensor:
    return matrix_to_params(torch.eye(3), motion)


def _scale_matrix(m: torch.Tensor, s: float) -> torch.Tensor:
    """Rescale warp matrices between pyramid levels: S M S^-1 with
    S = diag(s, s, 1), entry by entry (s_i m_ij) / s_j."""
    sv = torch.tensor([s, s, 1.0], device=m.device)
    return m * sv[:, None] * (1.0 / sv)[None, :]


def _separable_sum(img: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded correlation of `[N, H, W]` with `taps` along H, then W,
    as shifted sums (no convolution call, so no TF32)."""
    r = len(taps) // 2
    h, w = img.shape[-2:]
    xp = torch.nn.functional.pad(img, (0, 0, r, r))
    x = sum(k * xp[:, i:i + h] for i, k in enumerate(taps))
    xp = torch.nn.functional.pad(x, (r, r))
    return sum(k * xp[:, :, i:i + w] for i, k in enumerate(taps))


def _blur_and_halve(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur with zero padding (2, 2), then [::2, ::2]
    (registration.py:112-121). img: [N, H, W]."""
    return _separable_sum(img, _BINOMIAL)[:, ::2, ::2]


def _image_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences with edge replication (registration.py:124-129).
    img: [N, H, W] -> (gx, gy)."""
    xp = torch.cat([img[:, :, :1], img, img[:, :, -1:]], 2)
    yp = torch.cat([img[:, :1], img, img[:, -1:]], 1)
    return (xp[:, :, 2:] - xp[:, :, :-2]) * 0.5, (yp[:, 2:] - yp[:, :-2]) * 0.5


def _matrix_jacobian(p: torch.Tensor, motion: str) -> torch.Tensor:
    """dM/dp [N, P, 3, 3] of `params_to_matrix` at p [N, P] (a motion
    other than translation)."""
    n = p.shape[0]
    d = torch.zeros(n, _NUM_PARAMS[motion], 3, 3, device=p.device)
    if motion == "euclidean":
        c, s = torch.cos(p[:, 0]), torch.sin(p[:, 0])
        d[:, 0, 0, 0], d[:, 0, 0, 1] = -s, -c
        d[:, 0, 1, 0], d[:, 0, 1, 1] = c, -s
        d[:, 1, 0, 2] = d[:, 2, 1, 2] = 1.0
        return d
    for k, entries in enumerate(_LINEAR_DM[motion]):
        for i, j, v in entries:
            d[:, k, i, j] = v
    return d


def _warp_coords(p: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 motion: str) -> tuple[torch.Tensor, ...]:
    """Source positions of the template pixels (xs, ys) [M] under p [N, P]
    (registration.py:132-137), with their Jacobian: (cx, cy) [N, M] and
    (jx, jy) [N, M, P] = d(cx, cy)/dp. Like the JAX map, a projective
    divisor |w| < 1e-12 becomes the constant 1e-12 (no derivative)."""
    x, y = xs[:, None], ys[:, None]  # [M, 1]: the parameter axis last
    m = params_to_matrix(p, motion)[:, None, None]  # [N, 1, 1, 3, 3]
    dm = _matrix_jacobian(p, motion)[:, None]  # [N, 1, P, 3, 3]

    def row(a, i):  # row i of a applied to (x, y, 1)
        return a[..., i, 0] * x + a[..., i, 1] * y + a[..., i, 2]

    sw = row(m, 2)  # [N, M, 1]
    small = sw.abs() < 1e-12
    den = torch.where(small, torch.full_like(sw, 1e-12), sw)
    cx, cy = row(m, 0) / den, row(m, 1) / den
    dw = torch.where(small, 0.0, row(dm, 2))  # [N, M, P]
    jx = (row(dm, 0) - cx * dw) / den
    jy = (row(dm, 1) - cy * dw) / den
    return cx[..., 0], cy[..., 0], jx, jy


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


def _run_ecc_iters(step, p0: torch.Tensor, num_iters: int, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Drive `step(p) -> (p + dp, rho)` for N frames (registration.py:
    178-205): a fixed count when eps == 0, else each frame stops once its
    |rho - rho_prev| <= eps and the loop once every frame has stopped.
    Each iteration run raises `ecc_align.iterations`."""
    n = p0.shape[0]
    p = p0
    rho = torch.zeros(n, device=p0.device)
    drho = torch.full((n,), float("inf"), device=p0.device)
    for _ in range(num_iters):
        active = drho > eps if eps > 0.0 else torch.ones_like(drho, dtype=torch.bool)
        if eps > 0.0:
            with annotate("fbanet.ecc.host_read"):  # the per-iteration sync
                done = not bool(active.any())
            if done:
                break
        ecc_align.iterations += 1
        p2, rho2 = step(p)
        p = torch.where(active[:, None], p2, p)
        drho = torch.where(active, (rho2 - rho).abs(), drho)
        rho = torch.where(active, rho2, rho)
    return p, rho


def _zero_mean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(-1, keepdim=True)


def _ecc_translation_level(template: torch.Tensor, image: torch.Tensor,
                           p0: torch.Tensor, num_iters: int, eps: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Translation ECC at one pyramid level for N frames at once
    (registration.py:208-261). template, image: [N, h, w]; p0: [N, 2].
    Returns (p [N, 2], rho [N])."""
    n = template.shape[0]
    tbar = _zero_mean(template.reshape(n, -1))
    t_norm = torch.sqrt((tbar * tbar).sum(-1)) + 1e-12
    gx, gy = _image_gradients(image)
    stack = torch.stack([image, gx, gy], 1)  # [N, 3, h, w]

    def step(p):
        warped = warp_translation(stack, p).reshape(n, 3, -1)
        iw, ixw, iyw = warped[:, 0], warped[:, 1], warped[:, 2]
        ibar = _zero_mean(iw)
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
        return p + dp, corr / (t_norm * torch.sqrt(i_norm2))

    return _run_ecc_iters(step, p0, num_iters, eps)


def _pyramid_floats(h: int, w: int, levels: int) -> int:
    """Floats of pyramid levels 1.. of one [h, w] image (`_blur_and_halve`
    keeps ceil(h / 2) x ceil(w / 2))."""
    total = 0
    for _ in range(levels - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        total += h * w
    return total


def ecc_translation(template: torch.Tensor, image: torch.Tensor,
                    p0: torch.Tensor | None, levels: int, num_iters: int,
                    eps: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Translation ECC of each frame `image` [N, H, W] to its `template`
    [N, H, W] over a `levels`-level pyramid, from `p0` [N, 2] at the
    coarsest level (None: zero), by the kernel `csrc/ecc.cu`: one block a
    frame builds both pyramids and runs `_ecc_translation_level` level after
    level, stopping as `_run_ecc_iters` does, with no host read. CUDA
    tensors only (the plain version is `ecc_align`'s loop). Returns (p
    [N, 2] at the finest level, rho [N], the iterations run [levels, N]
    int32, level 0 the finest); a non-finite result is already `ecc_align`'s
    fallback, p 0 and rho -1.

    Raises `.launches`. `ecc_align.iterations` takes the batched
    iterations (each level's most over the frames) from a copy into pinned
    memory that does not block: a later call adds them once the launch has
    finished (`_add_ecc_iterations`)."""
    _add_ecc_iterations()
    if (template.dim() != 3 or template.shape != image.shape
            or not 1 <= levels <= 16 or num_iters < 0 or (
                p0 is not None and p0.shape != (template.shape[0], 2))):
        raise ValueError(
            f"ecc_translation does not take template {tuple(template.shape)}"
            f" and image {tuple(image.shape)} at {levels} levels x "
            f"{num_iters} iterations: [N, H, W] both, 1 to 16 levels, p0 "
            f"[N, 2] or None")
    dev = template.device
    if not template.is_cuda or any(t is not None and t.device != dev
                                   for t in (image, p0)):
        raise ValueError(f"ecc_translation kernel takes CUDA tensors on one "
                         f"device, got {template.device} and {image.device}")
    n, h, w = template.shape
    tpl, img = template.float().contiguous(), image.float().contiguous()
    p = torch.empty(n, 2, device=dev)
    rho = torch.empty(n, device=dev)
    iters = torch.empty(levels, n, dtype=torch.int32, device=dev)
    if n:
        scratch = torch.empty(n * 2 * _pyramid_floats(h, w, levels),
                              device=dev)
        start = None if p0 is None else p0.float().contiguous()
        err = _build.library().fbanet_ecc_translation(
            tpl.data_ptr(), img.data_ptr(),
            None if start is None else start.data_ptr(), p.data_ptr(),
            rho.data_ptr(), iters.data_ptr(), scratch.data_ptr(), n, h, w,
            levels, num_iters, eps, _build.stream(tpl))
        if err:
            _build.check(err, f"ecc_translation {tuple(template.shape)}")
        ecc_translation.launches += 1
    if eps <= 0.0:
        ecc_align.iterations += levels * num_iters
    elif n:
        counts = torch.empty(levels, n, dtype=torch.int32, pin_memory=True)
        counts.copy_(iters, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        ecc_translation.pending.append((done, counts))
    return p, rho, iters


ecc_translation.launches = 0
# (event, pinned per-frame counts) of launches not yet added to
# ecc_align.iterations, oldest first
ecc_translation.pending = []


def _add_ecc_iterations(wait: bool = False) -> None:
    """Add the batched iterations of `ecc_translation`'s finished launches
    to `ecc_align.iterations`; with `wait`, of every launch, waiting for
    them to finish."""
    pending = ecc_translation.pending
    while pending and (wait or pending[0][0].query()):
        done, counts = pending.pop(0)
        done.synchronize()
        ecc_align.iterations += int(counts.amax(1).sum())


def _solve(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c^-1 b for c [N, P, P], b [N, P], without a host read of the
    factorisation's status (a singular c gives non-finite values)."""
    return torch.linalg.solve_ex(c, b[..., None])[0][..., 0]


def _ecc_single_level(template: torch.Tensor, image: torch.Tensor,
                      p0: torch.Tensor, motion: str, num_iters: int,
                      eps: float, plain: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """ECC of a non-translation motion at one pyramid level for N frames at
    once (registration.py:264-336): each iteration warps the [image, gx, gy]
    stack to the template through K6 and solves the P x P normal
    equations. template, image: [N, h, w]; p0: [N, P]."""
    n, h, w = template.shape
    dev = template.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    tbar = _zero_mean(template.reshape(n, -1))
    t_norm = torch.sqrt((tbar * tbar).sum(-1)) + 1e-12
    gx, gy = _image_gradients(image)
    stacked = torch.stack([image, gx, gy], -1)  # [N, h, w, 3]: one warp
    eye = 1e-8 * torch.eye(_NUM_PARAMS[motion], device=dev)

    def step(p):
        cx, cy, jx, jy = _warp_coords(p, xs, ys, motion)
        cyx = torch.stack([cy, cx], -1).reshape(n, h, w, 2)
        warped = warp_burst_coords(stacked, cyx, plain=plain).reshape(n, -1, 3)
        iw, ixw, iyw = warped[..., 0], warped[..., 1], warped[..., 2]
        ibar = _zero_mean(iw)
        i_norm2 = (ibar * ibar).sum(-1) + 1e-12
        g = ixw[..., None] * jx + iyw[..., None] * jy  # [N, hw, P]
        g_tr = g.transpose(1, 2)
        c = g_tr @ g + eye
        gt = (g_tr @ tbar[..., None])[..., 0]
        gi = (g_tr @ ibar[..., None])[..., 0]
        c_inv_gi = _solve(c, gi)
        corr = (tbar * ibar).sum(-1)
        lam_num = i_norm2 - (gi * c_inv_gi).sum(-1)
        lam_den = corr - (gt * c_inv_gi).sum(-1)
        # uncorrelated images: freeze the update (OpenCV raises instead)
        lam = torch.where(lam_den.abs() < 1e-12, torch.ones_like(lam_den),
                          lam_num / lam_den)
        err = lam[:, None] * tbar - ibar
        dp = _solve(c, (g_tr @ err[..., None])[..., 0])
        dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
        return p + dp, corr / (t_norm * torch.sqrt(i_norm2))

    return _run_ecc_iters(step, p0, num_iters, eps)


def ecc_align(template: torch.Tensor, image: torch.Tensor, *,
              motion: str = "translation", levels: int = 3,
              iters_per_level: int = 25, eps: float = 0.0,
              init_matrix: torch.Tensor | None = None, plain: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The warps that align each `image` to its `template`, both `[H, W]`
    or `[N, H, W]` grayscale (registration.py:339-390): coarse-to-fine over
    a binomial pyramid, the level loop carried through 3x3 matrices. Returns
    (matrices [..., 3, 3] mapping template to image coordinates, rho [...]);
    a non-finite result falls back to the identity with rho = -1.
    Translation on a CUDA tensor runs the kernel `ecc_translation`;
    `plain=True` takes the plain versions on CUDA (a comparison)."""
    _motion_check(motion)
    if template.dim() == 2:
        m, rho = ecc_align(template[None], image[None], motion=motion,
                           levels=levels, iters_per_level=iters_per_level,
                           eps=eps, init_matrix=init_matrix, plain=plain)
        return m[0], rho[0]
    n, dev = template.shape[0], template.device
    if motion == "translation" and not (plain or template.is_cpu):
        p0 = None if init_matrix is None else matrix_to_params(
            _scale_matrix(init_matrix.float().expand(n, 3, 3),
                          0.5 ** (levels - 1)), motion)
        p, rho, _ = ecc_translation(template, image, p0, levels,
                                    iters_per_level, eps)
        return params_to_matrix(p, motion), rho  # the fallback is in p, rho
    pyr_t, pyr_i = [template.float()], [image.float()]
    for _ in range(levels - 1):
        pyr_t.append(_blur_and_halve(pyr_t[-1]))
        pyr_i.append(_blur_and_halve(pyr_i[-1]))
    eye = torch.eye(3, device=dev).expand(n, 3, 3)
    m = eye if init_matrix is None else init_matrix.float().expand(n, 3, 3)
    m = _scale_matrix(m, 0.5 ** (levels - 1))
    rho = torch.zeros(n, device=dev)
    for lvl in reversed(range(levels)):
        p = matrix_to_params(m, motion)
        if motion == "translation":
            p, rho = _ecc_translation_level(pyr_t[lvl], pyr_i[lvl], p,
                                            iters_per_level, eps)
        else:
            p, rho = _ecc_single_level(pyr_t[lvl], pyr_i[lvl], p, motion,
                                       iters_per_level, eps, plain)
        m = params_to_matrix(p, motion)
        if lvl > 0:
            m = _scale_matrix(m, 2.0)
    ok = torch.isfinite(rho) & torch.isfinite(m).all(-1).all(-1)
    m = torch.where(ok[:, None, None], m, eye)
    rho = torch.where(ok, rho, torch.full_like(rho, -1.0))
    return m, rho


ecc_align.iterations = 0  # batched iterations run, all levels and motions


def align_burst(burst: torch.Tensor, *, motion: str = "translation",
                levels: int = 3, iters_per_level: int = 25, eps: float = 0.0,
                interp: str = "bilinear", plain: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align every frame of `[B, F, H, W, C]` (or `[F, H, W, C]`) to frame 0
    (registration.py:431-484). Returns (aligned, matrices [.., F, 3, 3],
    rhos [.., F]); frame 0 keeps the identity and stays bit-identical.

    Bilinear warps of a translation are the axis-wise gathers; of another
    motion, K5 in nearest mode. Nearest and bicubic warps take the plain
    `warp_burst_homography`. `plain=True` takes the plain versions of the
    ECC kernel, K5 and K6 on CUDA (a comparison, not the serving path)."""
    if burst.dim() == 4:
        a, m, r = align_burst(burst[None], motion=motion, levels=levels,
                              iters_per_level=iters_per_level, eps=eps,
                              interp=interp, plain=plain)
        return a[0], m[0], r[0]
    b, f, h, w, c = burst.shape
    gray = rgb_to_gray(burst)  # [B, F, H, W]
    template = gray[:, :1].expand(b, f - 1, h, w).reshape(-1, h, w)
    m, rho = ecc_align(template, gray[:, 1:].reshape(-1, h, w),
                       motion=motion, levels=levels,
                       iters_per_level=iters_per_level, eps=eps, plain=plain)
    mats = torch.eye(3, device=burst.device).repeat(b, f, 1, 1)
    mats[:, 1:] = m.reshape(b, f - 1, 3, 3)
    rhos = torch.ones(b, f, device=burst.device)
    rhos[:, 1:] = rho.reshape(b, f - 1)

    frames = burst[:, 1:].reshape(-1, h, w, c)
    if motion == "translation" and interp == "bilinear":
        warped = warp_translation(frames.float().permute(0, 3, 1, 2),
                                  m[:, :2, 2]).permute(0, 2, 3, 1)
    elif interp == "bilinear":
        warped = warp_burst_bilinear(frames, m, plain=plain)
    else:
        warped = warp_burst_homography(frames, m, interp=interp)
    warped = warped.reshape(b, f - 1, h, w, c).to(burst.dtype)
    return torch.cat([burst[:, :1], warped], 1), mats, rhos


@torch.no_grad()
def online_register(batch: torch.Tensor, method: str = "ecc") -> torch.Tensor:
    """Register `[B, F, H, W, C]` to frame 0 in an eval or train step
    (registration.py:394-428): "ecc" is translation ECC, 3 levels x 25
    iterations, eps 1e-5; "flow" is pyramidal Lucas-Kanade (3 levels x 5
    iterations) and a backward warp by the flow. Raises
    `online_register.calls`."""
    online_register.calls += 1
    with annotate("fbanet.register"):
        if method == "ecc":
            return align_burst(batch, motion="translation", levels=3,
                               iters_per_level=25, eps=1e-5)[0]
        if method == "flow":
            # imported here: flow imports this module
            from fbanet_tpu_torch.ops.flow import burst_optical_flow

            flows = burst_optical_flow(batch, levels=3, iters_per_level=5)
            warped = warp_flow(batch[:, 1:], flows)
            return torch.cat([batch[:, :1], warped], 1)
    raise ValueError(f"unknown online registration method {method}")


online_register.calls = 0  # batches registered
