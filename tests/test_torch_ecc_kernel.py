"""Translation ECC's kernel (`ops/registration.py::ecc_translation`,
`csrc/ecc.cu`) and the plain loop it stands beside. No JAX here: on the card
this file runs alone (`python -m pytest --noconftest
tests/test_torch_ecc_kernel.py`, the card has no JAX);
`test_torch_registration.py` holds the plain loop against JAX.

On the CPU: what the kernel relies on, that each frame of the plain batched
loop runs as if registered alone (the `where` mask stops it on its own), the
scratch its pyramid takes, that a CPU tensor never reaches it, and how its
iteration counts reach `ecc_align.iterations`. On the card (skipped
elsewhere): the kernel against the plain loop at the serving burst (16 x 14
frames of 160 px, shifts in [-3, 3) px) at eps 1e-5 and 0, at an odd size,
at a size too large to stage in shared memory, on a flat frame (the
`lam_den` branch: the identity, rho 0) and on a frame that never converges
(25 iterations). Matrices within 2e-3 px at the frame corners (a translation
moves every corner by its shift), rho within 1e-5: the same f32 arithmetic
with the sums in another order, so a frame whose |drho| lands near eps may
stop one iteration earlier or later.
"""

import numpy as np
import pytest
import torch

from fbanet_tpu_torch.data.synthetic import realistic_bursts
from fbanet_tpu_torch.ops import registration as reg

PX, RHO = 2e-3, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the plain loop's small ops cost more in thread
    hand-offs than in arithmetic, and the suite runs six workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gray_pairs(batch, frames, size, seed):
    """(templates, images) [B (F - 1), size, size] f32: the gray frames of
    realistic bursts (shifts in [-3, 3) px) and their frame 0."""
    lr = torch.from_numpy(realistic_bursts(batch, frames, size,
                                           seed=seed)["LR"])
    gray = reg.rgb_to_gray(lr)
    tpl = gray[:, :1].expand(-1, frames - 1, -1, -1)
    return (tpl.reshape(-1, size, size).contiguous(),
            gray[:, 1:].reshape(-1, size, size).contiguous())


def _blob(size, cy, cx, sigma):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    return np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def _special_pairs(size):
    """A flat frame against a textured template (no gradient: lam_den 0,
    so lam 1 and dp 0: the identity at rho 0, one iteration), and a blob
    of sigma 4 against the same blob 18 px lower and 8 px right at 48 px
    (ECC creeps along the far tail, |drho| >= 1.5e-4 each iteration, so
    eps 1e-5 never stops it; in float64 it ends within 2e-7 px of f32's
    end)."""
    tpl, _ = _gray_pairs(1, 2, size, seed=11)
    c = size / 2
    t = np.stack([tpl[0].numpy(), _blob(size, c, c, 4.0)])
    i = np.stack([np.full((size, size), 0.5),
                  _blob(size, c + 18, c + 8, 4.0)])
    return (torch.from_numpy(t.astype(np.float32)),
            torch.from_numpy(i.astype(np.float32)))


def _count(fn):
    """fn()'s result and the batched iterations it added."""
    before = reg.ecc_align.iterations
    out = fn()
    return out, reg.ecc_align.iterations - before


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_plain_frames_run_as_if_alone(eps):
    """Each frame registered alone through the plain `_ecc_translation_level`
    gives what the batched call gives it, and the batched call runs as many
    iterations as its slowest frame: the per-frame independence the kernel
    (a block a frame, each stopping on its own) relies on."""
    tpl, img = _gray_pairs(1, 5, 48, seed=3)
    st, si = _special_pairs(48)
    tpl, img = torch.cat([tpl, st]), torch.cat([img, si])
    p0 = torch.zeros(len(tpl), 2)
    (p, rho), batched = _count(lambda: reg._ecc_translation_level(
        tpl, img, p0, 25, eps))
    alone = []
    for k in range(len(tpl)):
        (pk, rk), its = _count(lambda: reg._ecc_translation_level(
            tpl[k:k + 1], img[k:k + 1], p0[k:k + 1], 25, eps))
        np.testing.assert_allclose(pk[0].numpy(), p[k].numpy(), atol=1e-5)
        np.testing.assert_allclose(float(rk[0]), float(rho[k]), atol=1e-6)
        alone.append(its)
    assert batched == max(alone)
    if eps == 0.0:
        assert alone == [25] * len(tpl)
    else:  # the flat frame stops at once, the creeping one never
        assert alone[-2] == 1 and alone[-1] == 25 and min(alone[:-2]) < 25
        np.testing.assert_array_equal(p[-2].numpy(), [0.0, 0.0])
        assert float(rho[-2]) == 0.0


def test_plain_pyramid_frames_run_as_if_alone():
    """The same through `ecc_align` on the CPU (3 levels x 25, eps 1e-5):
    each frame's matrix and rho alone and in the batch."""
    tpl, img = _gray_pairs(1, 4, 40, seed=5)
    m, rho = reg.ecc_align(tpl, img, levels=3, iters_per_level=25, eps=1e-5)
    for k in range(len(tpl)):
        mk, rk = reg.ecc_align(tpl[k], img[k], levels=3, iters_per_level=25,
                               eps=1e-5)
        np.testing.assert_allclose(mk.numpy(), m[k].numpy(), atol=1e-5)
        np.testing.assert_allclose(float(rk), float(rho[k]), atol=1e-6)


def test_cpu_takes_the_plain_path():
    """Translation on a CPU tensor runs the plain loop (its iterations
    counted as they run) and never the kernel, whose wrapper refuses a CPU
    tensor rather than fall back."""
    tpl, img = _gray_pairs(1, 3, 24, seed=9)
    launches = reg.ecc_translation.launches
    _, grew = _count(lambda: reg.ecc_align(tpl, img, levels=2,
                                           iters_per_level=5, eps=0.0))
    assert grew == 10 and reg.ecc_translation.launches == launches
    aligned, _, _ = reg.align_burst(torch.rand(1, 3, 24, 24, 3), eps=1e-5)
    assert aligned.shape == (1, 3, 24, 24, 3)
    assert reg.ecc_translation.launches == launches
    if not torch.cuda.is_available():
        assert launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        reg.ecc_translation(tpl, img, None, 2, 5, 1e-5)


@pytest.mark.parametrize("h,w,levels", [(160, 160, 3), (37, 53, 3),
                                        (480, 480, 3), (1, 1, 4),
                                        (9, 2, 5)])
def test_pyramid_scratch_holds_the_plain_levels(h, w, levels):
    """The kernel's scratch for one image holds exactly the plain pyramid's
    levels 1.. (`_blur_and_halve` keeps ceil(h / 2) x ceil(w / 2))."""
    level = torch.zeros(1, h, w)
    total = 0
    for _ in range(levels - 1):
        level = reg._blur_and_halve(level)
        total += level.shape[1] * level.shape[2]
    assert reg._pyramid_floats(h, w, levels) == total


class _Done:
    """An event that has (or has not) finished."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True


def test_kernel_counts_reach_the_counter(monkeypatch):
    """A launch's per-frame counts [levels, N] add each level's most to
    `ecc_align.iterations` once its event has finished, in launch order;
    `wait` takes the unfinished ones too."""
    pending = []
    monkeypatch.setattr(reg.ecc_translation, "pending", pending)
    first, second = _Done(True), _Done(False)
    pending += [(first, torch.tensor([[3, 7], [2, 1]], dtype=torch.int32)),
                (second, torch.tensor([[5, 5], [0, 4]], dtype=torch.int32))]
    _, grew = _count(reg._add_ecc_iterations)
    assert grew == 7 + 2 and pending == [(second, pending[0][1])]
    _, grew = _count(lambda: reg._add_ecc_iterations(wait=True))
    assert grew == 5 + 4 and not pending and second.waited


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _compare(tpl, img, levels, iters, eps):
    """Kernel and plain loop on the card: (kernel p, rho, per-frame counts;
    the counter's growth under each)."""
    dev = _card()
    tpl, img = tpl.to(dev), img.to(dev)
    reg._add_ecc_iterations(wait=True)
    launches = reg.ecc_translation.launches

    def kernel():
        out = reg.ecc_translation(tpl, img, None, levels, iters, eps)
        reg._add_ecc_iterations(wait=True)
        return out

    (p, rho, its), grew = _count(kernel)
    assert reg.ecc_translation.launches == launches + 1
    (m_p, rho_p), grew_p = _count(lambda: reg.ecc_align(
        tpl, img, levels=levels, iters_per_level=iters, eps=eps, plain=True))
    assert reg.ecc_translation.launches == launches + 1
    px = float((p - m_p[:, :2, 2]).abs().max())
    drho = float((rho - rho_p).abs().max())
    assert px <= PX and drho <= RHO, (px, drho)
    if eps == 0.0:
        assert grew == grew_p == levels * iters
        assert bool((its == iters).all())
    else:  # known difference: a level may stop one iteration apart
        assert abs(grew - grew_p) <= levels, (grew, grew_p)
        assert grew == int(its.amax(1).sum())
    return p, rho, its


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_kernel_matches_plain_on_serving_bursts(eps):
    _card()
    tpl, img = _gray_pairs(16, 14, 160, seed=21)
    p, _, its = _compare(tpl, img, 3, 25, eps)
    # the shifts are real: the kernel moved the frames
    assert float(p.abs().max()) > 1.0 and its.shape == (3, 208)


@pytest.mark.parametrize("h,w", [(37, 53), (480, 480)])
def test_kernel_matches_plain_at_other_sizes(h, w):
    """An odd size; and 480 px, whose finest level (900 KB) exceeds a
    block's shared memory and is read through L2 (the next, 225 KB, is
    staged)."""
    _card()
    lr = torch.from_numpy(realistic_bursts(1, 5, max(h, w), seed=31)["LR"])
    gray = reg.rgb_to_gray(lr)[0, :, :h, :w]
    tpl = gray[:1].expand(4, -1, -1).contiguous()
    _compare(tpl, gray[1:].contiguous(), 3, 25, 1e-5)


def test_kernel_starts_from_init_matrix():
    """`ecc_align`'s `init_matrix` reaches the kernel as the coarsest
    level's start: the same matrices and rho as the plain loop's."""
    dev = _card()
    tpl, img = _gray_pairs(1, 5, 40, seed=41)
    tpl, img = tpl.to(dev), img.to(dev)
    init = torch.tensor([[1.0, 0.0, 1.5], [0.0, 1.0, -2.0], [0.0, 0.0, 1.0]],
                        device=dev)
    got = [reg.ecc_align(tpl, img, levels=3, iters_per_level=25, eps=1e-5,
                         init_matrix=init, plain=plain)
           for plain in (False, True)]
    assert float((got[0][0] - got[1][0]).abs().max()) <= PX
    assert float((got[0][1] - got[1][1]).abs().max()) <= RHO


def test_kernel_flat_and_never_converging_frames():
    """The flat frame takes the lam_den branch (one iteration, the
    identity, rho 0); the creeping blob runs all 25 iterations, in the same
    launch as frames that stop early; a frame of NaNs stops at once and
    falls back to the identity with rho -1, as `ecc_align`'s does."""
    _card()
    tpl, img = _gray_pairs(1, 5, 48, seed=3)
    st, si = _special_pairs(48)
    nan = torch.full((1, 48, 48), float("nan"))
    p, rho, its = _compare(torch.cat([tpl, st, tpl[:1]]),
                           torch.cat([img, si, nan]), 1, 25, 1e-5)
    assert its[0, -3] == 1 and its[0, -2] == 25 and its[0, -1] == 1
    assert int(its[0, :-3].min()) < 25
    assert p[-3].abs().max() == 0 and rho[-3] == 0
    assert p[-1].abs().max() == 0 and rho[-1] == -1
