"""The plans of K1's, K2's and K3's wgmma forms on the CPU, without JAX:
which form and blocks each shape gets (FBANet-64's five groups, and
FBANet-32's: K1 and K3 at head sizes 8 and 32), the shared memory each plan
needs
(from the Python models of the kernels' own `*_smem` functions, which
chip_smoke.py holds equal to the kernels'), the window-to-block assignment
of K1's and K3's forms, the order of K3's per-block bias partial's sums,
the forms K11, K8, K10, K7 and K9 take (K3's, K2's and K1's own plans, the
first kernels where their wgmma forms are not built), which count each
launch lands in, and what the new wrappers refuse.

The kernels run only on the card, where chip_smoke.py and
tools/measure_attention.py / tools/measure_leff.py /
tools/measure_attention_bwd.py hold them against the plain versions at
every shape of the main path.
"""

import numpy as np
import pytest
import torch

from fbanet_tpu_torch.ops import attention, leff
from fbanet_tpu_torch.ops.reduce import column_sum
from fbanet_tpu_torch.tools import (
    measure_bwd,
    measure_swin_rates,
    measure_swin_variants,
)

SMEM_LIMIT, SMS, WS = 232448, 132, 8
# (H, C, heads) of the five SwinGroups at 160 px: enc0, enc1, bott, dec0,
# dec1
GROUPS = [(160, 64, 1), (80, 128, 2), (40, 256, 16), (80, 256, 16),
          (160, 128, 8)]
IDS = ["enc0", "enc1", "bott", "dec0", "dec1"]


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_leff_plan_at_the_group_shapes(h, c, heads, batch):
    """bf16 takes the wgmma form at every group: a tile that divides the
    map, a chunk that divides the hidden width, at most four 64 x 64 pieces
    of the output per tile, shared memory within the H100's 227 KB; 16 x 8
    tiles where they fit (C <= 128), 8 x 8 at C = 256, 64-wide chunks."""
    ch = 4 * c
    th, tw, kc = leff._leff_plan(batch, h, h, c, ch)
    assert (th, tw, kc) in leff._K2_FORMS
    assert h % th == 0 and h % tw == 0 and ch % kc == 0
    assert (c // 64) * (th * tw // 64) <= 4
    assert 0 < leff._leff_smem(c, th, tw, kc) <= SMEM_LIMIT
    assert (th, tw, kc) == ((16, 8, 64) if c <= 128 else (8, 8, 64))


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_attention_bwd_plan_at_the_group_shapes(h, c, heads, batch):
    """bf16 takes the wgmma form at every group: two warpgroups where two
    blocks share an SM (C <= 128), else four; the windows dealt to at most
    as many blocks as the card holds at once, in as few windows per block
    as that allows."""
    nwg, wpb = attention._attention_bwd_plan(batch, h, h, c, heads)
    size = attention._attention_bwd_smem(WS * WS, c, heads, nwg)
    assert 0 < size <= SMEM_LIMIT
    assert nwg == (2 if c <= 128 else 4)
    resident = 4 // nwg
    assert resident * (size + 1024) <= attention._SM_SMEM
    windows = batch * (h // WS) ** 2
    blocks = -(-windows // wpb)
    assert blocks <= resident * SMS
    assert wpb == 1 or -(-windows // (wpb - 1)) > resident * SMS
    assert attention._partial_rows(windows, (nwg, wpb)) == blocks


def test_plans_keep_the_first_kernels_for_what_the_wgmma_forms_refuse():
    """f32, and bf16 shapes the wgmma forms do not take, get the first
    kernels by an explicit rule."""
    base2, base3 = leff._K2_BASE_PLAN, attention._K3_BASE_PLAN
    assert leff._leff_plan(2, 80, 80, 128, 512, False) == base2
    assert leff._leff_plan(2, 12, 12, 64, 256) == base2  # no tile divides 12
    assert leff._leff_plan(2, 16, 16, 96, 384) == base2  # C not 64k
    assert leff._leff_plan(2, 16, 16, 320, 1280) == base2  # C > 256
    assert leff._leff_plan(2, 24, 16, 64, 256) == (8, 8, 64)  # H % 16 != 0
    assert attention._attention_bwd_plan(2, 80, 80, 128, 2,
                                         bf16=False) == base3
    assert attention._attention_bwd_plan(2, 16, 16, 192, 8) == base3  # dh 24
    assert attention._attention_bwd_plan(2, 16, 16, 96, 6) == base3  # C 96
    assert attention._attention_bwd_plan(2, 28, 28, 64, 1, ws=7) == base3
    assert attention._attention_bwd_plan(2, 12, 16, 64, 1) == base3  # H % 8
    assert attention._partial_rows(200, base3) == 200


def test_plans_size_with_the_given_smem():
    """The plans take their shared-memory sizes from the function they are
    given (the wrappers pass the kernels' own on the card): a form that
    function refuses is passed over, and with none left the first kernel
    runs."""
    def no_two_warpgroups(n, c, heads, nwg):
        return attention._attention_bwd_smem(n, c, heads, nwg) if nwg == 4 \
            else 0

    def none(*_args):
        return 0

    assert attention._attention_bwd_plan(
        8, 160, 160, 128, 8, smem=no_two_warpgroups) == (4, 25)
    assert attention._attention_bwd_plan(
        8, 160, 160, 128, 8, smem=none) == attention._K3_BASE_PLAN

    def only_32(c, th, tw, kc):
        return leff._leff_smem(c, th, tw, kc) if kc == 32 else 0

    assert leff._leff_plan(8, 160, 160, 64, 256, smem=only_32) == (16, 8, 32)
    assert leff._leff_plan(8, 160, 160, 64, 256,
                           smem=none) == leff._K2_BASE_PLAN


def test_smem_models_refuse_what_the_kernels_do_not_take():
    """The layouts' limits: K2 at most four 64 x 64 output pieces a tile
    (16 x 8 tiles at C = 256 need 8), only the instantiated forms; K3 only
    64-token windows, C 64, 128 or 256, head size 8, 16, 32 or 64, two
    warpgroups only up to C = 128 (one 64-column piece of dy each), and
    C = 32 only with one head on one or two warpgroups, never four."""
    assert leff._leff_smem(256, 16, 8, 64) == 0
    assert leff._leff_smem(128, 16, 16, 64) == 0  # not a form
    assert leff._leff_smem(128, 8, 8, 16) == 0  # not a form
    assert leff._leff_smem(96, 8, 8, 64) == 0
    for c in (64, 128, 256):
        for form in leff._K2_FORMS:
            assert leff._leff_smem(c, *form) <= SMEM_LIMIT
        for heads in (1, 2, 4, 8, 16):
            for nwg in (2, 4):
                assert attention._attention_bwd_smem(64, c, heads,
                                                     nwg) <= SMEM_LIMIT
    assert attention._attention_bwd_smem(49, 64, 1, 4) == 0
    assert attention._attention_bwd_smem(64, 192, 8, 4) == 0  # dh 24
    assert attention._attention_bwd_smem(64, 32, 1, 4) == 0  # C 32
    assert attention._attention_bwd_smem(64, 256, 16, 2) == 0
    assert attention._attention_bwd_smem(64, 256, 16, 3) == 0


@pytest.mark.parametrize("batch", [1, 2, 3, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_window_blocks_cover_each_window_once_in_order(h, c, heads, batch):
    """K3's wgmma form: block i walks windows i wpb .. (i + 1) wpb - 1, so
    the blocks' lists, in block order, are the windows 0 .. G - 1 in order,
    each once, and no block is empty."""
    nwg, wpb = attention._attention_bwd_plan(batch, h, h, c, heads)
    windows = batch * (h // WS) ** 2
    blocks = attention._window_blocks(windows, wpb)
    assert [w for blk in blocks for w in blk] == list(range(windows))
    assert all(len(blk) >= 1 for blk in blocks)
    assert all(len(blk) == wpb for blk in blocks[:-1])


@pytest.mark.parametrize("windows,wpb", [(50, 1), (115, 7), (247, 13),
                                         (3200, 13), (7, 3)])
def test_block_bias_partials_sum_like_float64(windows, wpb):
    """The bias gradient of the wgmma form: each block adds its windows'
    f32 dlogits [heads, 64, 64] in window order into one partial row, and
    column_sum (its plain version here) adds the rows: within f32 rounding
    of the float64 sum over all windows."""
    rng = np.random.default_rng(windows)
    heads = 2
    dl = rng.standard_normal((windows, heads * 64 * 64)).astype(np.float32)
    dlt = torch.from_numpy(dl)
    rows = []
    for blk in attention._window_blocks(windows, wpb):
        acc = dlt[blk[0]].clone()
        for w in blk[1:]:
            acc += dlt[w]
        rows.append(acc)
    got = column_sum(torch.stack(rows)).numpy()
    ref = dl.astype(np.float64).sum(0)
    scale = np.abs(dl).astype(np.float64).sum(0).max()
    assert np.abs(got - ref).max() <= 4 * windows * 2.0 ** -24 * scale


def test_new_wrappers_refuse_off_the_card():
    """K2's and K3's launches under an explicit plan take CUDA tensors
    only, whatever the plan: any other device gets an error naming the
    shape, never the plain version."""
    c, ch = 64, 256
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    lp = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (ch, c), (ch,), (ch, 1, 3, 3), (ch,), (c, ch), (c,))]
    for plan in (leff._K2_FORMS[0], leff._K2_BASE_PLAN):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            leff._leff_launch(x, *lp, True, plan)
    ap = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (1, 64, 64))]
    for plan in ((2, 1), attention._K3_BASE_PLAN):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            attention._attention_bwd_launch(x, x, *ap, None, 1, WS, False,
                                            plan)
    xw = torch.empty(4, 64, c, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(4, 64, 64\)"):
        attention.window_attention_bwd_windows(xw, xw, *ap, None, heads=1,
                                               windows_per_image=4)
    with pytest.raises(ValueError, match=r"\(4, 64, 64\)"):
        attention.launch_bwd_windows(xw, xw, *ap, None, heads=1,
                                     windows_per_image=4, plan=(2, 1))


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_attention_plan_at_the_group_shapes(h, c, heads, batch):
    """bf16 takes K1's wgmma form at every group: the weights staged once
    per block by two warpgroups at C = 64 and by four at C = 128, streamed
    by four at C = 256, each with as many resident blocks per SM as its
    launch bounds allow (4 // warpgroups); the windows dealt to at most as
    many blocks as the card holds at once, in as few windows per block as
    that allows."""
    nwg, wpb, staged = attention._attention_plan(batch, h, h, c, heads)
    assert (nwg, staged) in attention._K1_FORMS
    assert (nwg, staged) == {64: (2, 1), 128: (4, 1), 256: (4, 0)}[c]
    size = attention._attention_smem(WS * WS, c, heads, nwg, staged)
    assert 0 < size <= SMEM_LIMIT
    resident = 4 // nwg
    assert resident * (size + 1024) <= attention._SM_SMEM
    windows = batch * (h // WS) ** 2
    blocks = len(attention._window_blocks(windows, wpb))
    assert blocks <= resident * SMS
    assert wpb == 1 or -(-windows // (wpb - 1)) > resident * SMS


@pytest.mark.parametrize("args,kw", [
    ((2, 80, 80, 128, 2), dict(bf16=False)),  # f32
    ((2, 16, 16, 32, 1), {}),  # head size 32 at C = 32 (embed 32's enc0)
    ((2, 16, 16, 96, 6), {}),  # C not a multiple of 64
    ((2, 28, 28, 64, 1), dict(ws=7)),  # 49-token windows
    ((2, 12, 16, 64, 1), {}),  # H not a multiple of the window
], ids=["f32", "dh32", "c96", "ws7", "h12"])
def test_attention_plan_keeps_the_first_kernel(args, kw):
    """f32, and bf16 shapes K1's wgmma form does not take, get the first
    kernel by an explicit rule (the wrapper launches it or raises)."""
    assert attention._attention_plan(*args, **kw) == attention._K1_BASE_PLAN


def test_attention_plan_sizes_with_the_given_smem():
    """K1's plan takes its shared-memory sizes from the function it is
    given (the wrapper passes the kernel's own on the card): a form that
    function refuses is passed over, and with none left the first kernel
    runs."""
    def streamed_only(n, c, heads, nwg, staged):
        return 0 if staged else attention._attention_smem(n, c, heads, nwg,
                                                          staged)

    def four_only(n, c, heads, nwg, staged):
        return attention._attention_smem(n, c, heads, nwg, staged) \
            if nwg == 4 else 0

    assert attention._attention_plan(8, 160, 160, 64, 1,
                                     smem=streamed_only) == (4, 25, 0)
    assert attention._attention_plan(8, 160, 160, 64, 1,
                                     smem=four_only) == (4, 25, 1)
    assert attention._attention_plan(
        8, 160, 160, 64, 1, smem=lambda *_a: 0) == attention._K1_BASE_PLAN


def test_attention_smem_refuses_what_the_kernel_does_not_take():
    """K1's wgmma form: only 64-token windows, C 64, 128 or 256, head size
    8, 16, 32 or 64, two or four warpgroups, weights staged or streamed,
    and at most the H100's 227 KB a block (staged weights fit up to
    C = 128)."""
    assert attention._attention_smem(49, 64, 1, 2, 0) == 0
    assert attention._attention_smem(64, 96, 6, 2, 0) == 0
    assert attention._attention_smem(64, 320, 20, 4, 0) == 0
    assert attention._attention_smem(64, 32, 1, 2, 0) == 0  # C 32
    assert attention._attention_smem(64, 192, 8, 2, 0) == 0  # dh 24
    assert attention._attention_smem(64, 128, 2, 3, 0) == 0
    assert attention._attention_smem(64, 128, 2, 2, 2) == 0
    assert attention._attention_smem(64, 256, 16, 4, 1) == 0  # 512 KB
    assert attention._attention_smem(64, 256, 4, 2, 1) == 0
    for c in (64, 128, 256):
        for heads in (c // 64, c // 16):
            for nwg in (2, 4):
                assert 0 < attention._attention_smem(64, c, heads, nwg,
                                                     0) <= SMEM_LIMIT
    # the layout byte for byte: y, q, k, v, the mask, weights, barriers,
    # alignment
    assert attention._attention_smem(64, 64, 1, 2, 1) == \
        4 * 8192 + 16384 + 8 * 64 * 64 + 8 + 1024
    assert attention._attention_smem(64, 256, 16, 4, 0) == \
        4 * 32768 + 16384 + 4 * 4 * 4096 + 16 * 8 + 1024


def test_attention_bwd_smem_at_c32_byte_for_byte():
    """K3's layout at C = 32 (FBANet-32's enc0, one head of 32), byte for
    byte: one warpgroup holds y | g, do, q, k, v (64 x 32 bf16 each,
    64-byte rows), its two-slot ring (4096 bytes a slot, a 32-column box
    fills half), its p tile (y | g is too small to hold it), the column
    scratch, the 6 C partials, the LN statistics, two barriers and the
    alignment slack. C = 32 takes one head on one warpgroup only, and one
    warpgroup serves C = 32 only."""
    one = 4096 + 4 * 4096 + 2 * 4096 + 8192 + 1024 + 768 + 2 * 256 + 16
    assert attention._attention_bwd_smem(64, 32, 1, 1) == one + 1024 == 40208
    for nwg in (2, 4):
        assert attention._attention_bwd_smem(64, 32, 1, nwg) == 0
    for heads in (2, 4):  # head sizes 16, 8 at C = 32: not built
        assert attention._attention_bwd_smem(64, 32, heads, 1) == 0
    for c in (64, 128, 256):
        assert attention._attention_bwd_smem(64, c, c // 32, 1) == 0


def test_wrappers_refuse_off_the_card_at_c32():
    """K3's launch under an explicit plan, and its windowed entry, take
    CUDA tensors only at C = 32 too, under either design and the first
    kernel: any other device gets an error naming the shape, never the
    plain version."""
    c = 32
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    ap = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (1, 64, 64))]
    for plan in ((1, 1), (2, 1), attention._K3_BASE_PLAN):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 32\)"):
            attention._attention_bwd_launch(x, x, *ap, None, 1, WS, False,
                                            plan)
    xw = torch.empty(4, 64, c, device="meta", dtype=torch.bfloat16)
    for plan in ((1, 1), (2, 2)):
        with pytest.raises(ValueError, match=r"\(4, 64, 32\)"):
            attention.launch_bwd_windows(xw, xw, *ap, None, heads=1,
                                         windows_per_image=4, plan=plan)


# FBANet-32 (embed 32, the configuration's default): (H, C, heads) of its
# five groups at 160 px, head sizes 32, 32, 8, 8 and 8
GROUPS32 = [(160, 32, 1), (80, 64, 2), (40, 128, 16), (80, 128, 16),
            (160, 64, 8)]


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS32, ids=IDS)
def test_attention_plans_at_embed32(h, c, heads, batch):
    """K1's and K3's plans at FBANet-32's groups: in bf16 K1's wgmma form
    at enc1 to dec1 (head sizes 32 and 8; staged by two warpgroups at
    C = 64, streamed by four at C = 128, where head size 8's padded tiles
    leave the staged weights no room) and K3's at all five (one warpgroup
    at enc0, C = 32; two at C = 64, four at C = 128), within the H100's
    shared memory at their residency, the windows dealt to at most as many
    blocks as the card holds at once; K1's first kernel at enc0, and both
    first kernels in f32."""
    base1, base3 = attention._K1_BASE_PLAN, attention._K3_BASE_PLAN
    assert attention._attention_plan(batch, h, h, c, heads,
                                     bf16=False) == base1
    assert attention._attention_bwd_plan(batch, h, h, c, heads,
                                         bf16=False) == base3
    k1 = attention._attention_plan(batch, h, h, c, heads)
    k3 = attention._attention_bwd_plan(batch, h, h, c, heads)
    assert k3[0] == {32: 1, 64: 2, 128: 4}[c]
    plans = [(k3, attention._attention_bwd_smem(WS * WS, c, heads, k3[0]))]
    if c == 32:
        assert k1 == base1
    else:
        assert (k1[0], k1[2]) == {64: (2, 1), 128: (4, 0)}[c]
        plans.append((k1[:2], attention._attention_smem(
            WS * WS, c, heads, k1[0], k1[2])))
    windows = batch * (h // WS) ** 2
    for (nwg, wpb), size in plans:
        resident = 4 // nwg
        assert 0 < size <= SMEM_LIMIT
        assert resident * (size + 1024) <= attention._SM_SMEM
        assert len(attention._window_blocks(windows, wpb)) <= resident * SMS
        assert wpb == 1 or -(-windows // (wpb - 1)) > resident * SMS


@pytest.mark.parametrize("batch", [2, 8])
def test_backward_plans_at_embed32_enc0(batch):
    """FBANet-32's enc0 (160 px, C = 32, one head of 32) in bf16: K3 on its
    wgmma form with one warpgroup, four blocks an SM within the SM's
    shared memory, the windows dealt to as many blocks as the card holds
    at once (2 windows a block at B=2, 7 at B=8), each block writing one
    partial row; K4 on its wgmma form with 16 x 16 tiles, unsplit. K1's
    and K2's plans keep their first kernels there."""
    windows = batch * (160 // WS) ** 2
    nwg, wpb = attention._attention_bwd_plan(batch, 160, 160, 32, 1)
    assert (nwg, wpb) == (1, {2: 2, 8: 7}[batch])
    size = attention._attention_bwd_smem(WS * WS, 32, 1, nwg)
    assert 4 * (size + 1024) <= attention._SM_SMEM
    assert attention._partial_rows(windows, (nwg, wpb)) == \
        len(attention._window_blocks(windows, wpb)) <= 4 * SMS
    assert leff._leff_bwd_plan(batch, 160, 160, 32, 128) == (16, 16, 32, 1)
    assert attention._attention_plan(batch, 160, 160, 32,
                                     1) == attention._K1_BASE_PLAN
    assert leff._leff_plan(batch, 160, 160, 32, 128) == leff._K2_BASE_PLAN


def test_form_counts_split_the_head_sizes():
    """A launch counts in its form's count: the first kernel in `.base`,
    the wgmma form at head sizes 8 and 32 (embed 32's, K3's enc0 at C = 32
    among them) in `.narrow`, at 16 and 64 in `.wgmma`, for K1 and K3
    alike."""
    for counted in (attention.fused_window_attention_2d,
                    attention._attention_bwd_launch):
        for nwg, c, heads, want in ((0, 64, 2, "base"), (0, 64, 1, "base"),
                                    (1, 32, 1, "narrow"), (0, 32, 1, "base"),
                                    (2, 64, 2, "narrow"),
                                    (4, 128, 16, "narrow"),
                                    (2, 64, 8, "narrow"), (2, 64, 1, "wgmma"),
                                    (4, 256, 16, "wgmma")):
            assert attention._form_count(counted, nwg, c, heads) is \
                getattr(counted, want)


def test_smem_models_at_head_sizes_8_and_32():
    """The layouts of K1's and K3's wgmma forms at embed 32's head sizes,
    byte for byte: head size 32 holds q, k, v (and K3's do) as C columns,
    as 16 and 64 do; head size 8 as 2 C, each head zero-padded to 16
    columns, so K1's staged weights fit at C = 64 only. Every size within
    the H100's 227 KB a block, or refused."""
    for c in (64, 128, 256):
        for heads in (c // 8, c // 32):
            for nwg in (2, 4):
                for staged in (0, 1):
                    assert attention._attention_smem(
                        64, c, heads, nwg, staged) <= SMEM_LIMIT
                assert attention._attention_bwd_smem(64, c, heads,
                                                     nwg) <= SMEM_LIMIT
    for nwg in (2, 4):
        assert attention._attention_smem(64, 64, 2, nwg, 1) == \
            attention._attention_smem(64, 64, 1, nwg, 1)
        assert attention._attention_bwd_smem(64, 64, 2, nwg) == \
            attention._attention_bwd_smem(64, 64, 1, nwg)
    # K1: y, q, k, v (2 C each), the mask, weights, barriers, alignment
    assert attention._attention_smem(64, 64, 8, 2, 1) == \
        8192 + 3 * 16384 + 16384 + 8 * 64 * 64 + 8 + 1024
    assert attention._attention_smem(64, 128, 16, 4, 0) == \
        16384 + 3 * 32768 + 16384 + 4 * 4 * 4096 + 16 * 8 + 1024
    assert attention._attention_smem(64, 128, 16, 4, 1) == 0  # 278 KB
    # K3: y | g, do, q, k, v (2 C each), the rings, the p tiles (over
    # y | g where it holds them), column scratch and partials, LN
    # statistics, barriers, alignment
    assert attention._attention_bwd_smem(64, 128, 16, 4) == \
        16384 + 4 * 32768 + 4 * 2 * 4096 + 4 * 8192 + 4 * 1024 + 3072 \
        + 2 * 256 + 4 * 16 + 1024
    assert attention._attention_bwd_smem(64, 64, 8, 2) == \
        8192 + 4 * 16384 + 2 * 2 * 4096 + 2 * 8192 + 2 * 1024 + 1536 \
        + 2 * 256 + 2 * 16 + 1024


@pytest.mark.parametrize("h,c,heads", GROUPS32, ids=IDS)
def test_measurement_forms_at_embed32(h, c, heads):
    """K7, K9 and K11 at FBANet-32's groups name no instantiation their
    wgmma forms are not built for: head sizes 8 and 32 (and enc0's C = 32)
    keep the first kernels there, while K1 takes its wgmma form at enc1 to
    dec1 and K3 at all five groups (K11 keeps its own rule,
    `_K11_HEAD_SIZES`: its ablations are of FBANet-64)."""
    x = torch.empty(8, h, h, c, device="meta", dtype=torch.bfloat16)
    xw = torch.empty(8 * (h // WS) ** 2, WS * WS, c, device="meta",
                     dtype=torch.bfloat16)
    assert (attention._attention_plan(8, h, h, c, heads)[0] > 0) == (c > 32)
    assert attention._attention_bwd_plan(8, h, h, c, heads)[0] > 0
    for core in measure_swin_variants.CORES:
        assert _k7_plan(x, heads, core) == attention._K1_BASE_PLAN
    assert _k9_plan(x, heads) == attention._K1_BASE_PLAN
    assert measure_bwd.ablation_plan(
        xw, heads, smem=attention._attention_bwd_smem) == \
        attention._K3_BASE_PLAN
    for triples in (measure_swin_variants._K7_TRIPLES,
                    measure_swin_rates._K9_TRIPLES):
        assert all(dh in (16, 64) for dh, _nwg, _staged in triples)
    assert c // heads not in measure_bwd._K11_HEAD_SIZES


def test_attention_wrappers_refuse_off_the_card():
    """K1's launches under an explicit plan, and K1b's, take CUDA tensors
    only, whatever the plan: any other device gets an error naming the
    shape, never the plain version."""
    c = 64
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    ap = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (c,),
        (1, 64, 64))]
    for plan in ((2, 1, 1), (4, 2, 0), attention._K1_BASE_PLAN):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            attention._attention_launch(x, *ap, None, 1, WS, True, plan)
    xw = torch.empty(4, 64, c, device="meta", dtype=torch.bfloat16)
    for plan in (None, (2, 1, 0), attention._K1_BASE_PLAN):
        with pytest.raises(ValueError, match=r"\(4, 64, 64\)"):
            attention._launch_windows(xw, *ap, None, 1, 4, plan=plan)


@pytest.mark.parametrize("plan", [(4, 2, 1), (0, 1, 0)], ids=["wgmma", "base"])
def test_attention_operands_follow_the_form(plan):
    """K1's pointer arguments after x and out: the wgmma form takes
    [Wq; Wkv] as one [3C, C] compute-dtype weight in wq's place and no wkv
    (9 pointers), the first kernel wq and wkv apart (10); f32 vectors, a
    missing mask as a null pointer."""
    c = 64
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x = t(1, 8, 8, c).to(torch.bfloat16)
    wq, wkv = t(c, c), t(2 * c, c)
    args = (t(c), t(c), wq, t(c), wkv, t(2 * c), t(c, c), t(c), t(1, 64, 64),
            None)
    ptrs, kept = attention._forward_operands(x, *args, plan)
    assert len(ptrs) == (9 if plan[0] else 10) and ptrs[-1] is None
    assert ptrs[2] == kept[2].data_ptr() and kept[2].dtype == torch.bfloat16
    if plan[0]:
        assert torch.equal(kept[2], torch.cat([wq, wkv]).bfloat16())
        assert kept[4] is None
    else:
        assert torch.equal(kept[2], wq.bfloat16())
        assert ptrs[4] == kept[4].data_ptr()
    assert all(k.dtype == torch.float32 for i, k in enumerate(kept)
               if k is not None and i not in (2, 4, 6))


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_k11_takes_k3s_form(h, c, heads, batch):
    """K11 runs each variant on the form K3's own plan gives its windows:
    the wgmma form at every group, with K3's warpgroups and windows per
    block."""
    xw = torch.empty(batch * (h // WS) ** 2, WS * WS, c, device="meta",
                     dtype=torch.bfloat16)
    plan = measure_bwd.ablation_plan(xw, heads,
                                     smem=attention._attention_bwd_smem)
    assert plan == attention._attention_bwd_plan(xw.shape[0], WS, WS, c,
                                                 heads)
    assert plan[0] == (2 if c <= 128 else 4)


def test_k11_keeps_the_first_kernel_where_k3_does():
    """The tool's `check` shape (C 64, 2 heads: head size 32, which K11's
    wgmma form is not built for, though K3's own takes it) and windows of
    49 tokens stay on K3's first kernel."""
    smem = attention._attention_bwd_smem
    for n, c, heads in ((64, 64, 2), (49, 64, 1), (64, 96, 6)):
        xw = torch.empty(16, n, c, device="meta", dtype=torch.bfloat16)
        assert measure_bwd.ablation_plan(xw, heads, smem=smem) == \
            attention._K3_BASE_PLAN


@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_k8_takes_k2s_form(h, c, heads):
    """K8 runs each variant on the form K2's own plan gives the map: the
    wgmma form at every group; the first kernel at C = 32, which the wgmma
    form does not take."""
    ch = 4 * c
    x = torch.empty(8, h, h, c, device="meta", dtype=torch.bfloat16)
    plan = measure_swin_variants.variant_plan(x, ch, smem=leff._leff_smem)
    assert plan == leff._leff_plan(8, h, h, c, ch) and plan[0] > 0
    x32 = torch.empty(8, 16, 16, 32, device="meta", dtype=torch.bfloat16)
    assert measure_swin_variants.variant_plan(
        x32, 128, smem=leff._leff_smem) == leff._K2_BASE_PLAN


def test_k11_and_k8_refuse_off_the_card():
    """K11's and K8's wrappers take CUDA tensors only, on either form: any
    other device gets an error naming the shape, never the plain version;
    K11 takes one stage off at a time."""
    c, ch = 64, 256
    xw = torch.empty(4, 64, c, device="meta", dtype=torch.bfloat16)
    ap = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (1, 64, 64))]
    for plan in ((2, 1), attention._K3_BASE_PLAN, None):
        with pytest.raises(ValueError, match=r"\(4, 64, 64\)"):
            measure_bwd.ablation_backward(xw, xw, *ap, heads=1, plan=plan,
                                          core=False)
    with pytest.raises(ValueError, match=r"\(4, 64, 64\)"):
        attention.launch_bwd_windows(xw, xw, *ap, None, heads=1,
                                     windows_per_image=4, plan=(2, 1),
                                     skip=16)
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    lp = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (ch, c), (ch,), (ch, 1, 3, 3), (ch,), (c, ch), (c,))]
    for plan in (leff._K2_FORMS[0], leff._K2_BASE_PLAN, None):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            measure_swin_variants.leff_variant(x, *lp, dw_bf16=True,
                                               plan=plan)


# K2's form per group: 16 x 8 tiles where the pieces fit (C <= 128), 8 x 8
# at C = 256, 64-wide hidden chunks
K2_FORM = {"enc0": (16, 8, 64), "enc1": (16, 8, 64), "bott": (8, 8, 64),
           "dec0": (8, 8, 64), "dec1": (16, 8, 64)}


@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_k10_takes_k2s_form(h, c, heads, request):
    """K10 runs each ablation on the form K2's own plan gives the map: the
    wgmma form at every group (16 x 8 x 64 at enc0, enc1, dec1; 8 x 8 x 64
    at bott, dec0); the first kernel at C = 32, which it does not take."""
    ch = 4 * c
    x = torch.empty(8, h, h, c, device="meta", dtype=torch.bfloat16)
    plan = measure_swin_rates.leff_plan(x, ch, smem=leff._leff_smem)
    assert plan == leff._leff_plan(8, h, h, c, ch)
    assert plan == K2_FORM[request.node.callspec.id.split("-")[-1]]
    x32 = torch.empty(8, 16, 16, 32, device="meta", dtype=torch.bfloat16)
    assert measure_swin_rates.leff_plan(
        x32, 128, smem=leff._leff_smem) == leff._K2_BASE_PLAN


def _k7_plan(x, heads, core):
    return measure_swin_variants.attention_plan(
        x, heads, core, smem=attention._attention_smem,
        vsmem=measure_swin_variants._variant_smem)


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_k7_takes_k1s_form(h, c, heads, batch):
    """K7 runs every core on the form K1's own plan gives the map (the
    wgmma form, with its windows per block, at every group; lanepack where
    the heads pair up, its layout within the H100's 227 KB); ln+nr2 is
    that plan with 2 windows per block."""
    mv = measure_swin_variants
    x = torch.empty(batch, h, h, c, device="meta", dtype=torch.bfloat16)
    k1 = attention._attention_plan(batch, h, h, c, heads)
    assert k1[0] > 0
    for core, cid in mv._CORE_IDS.items():
        if core == "lanepack" and heads % 2:
            assert _k7_plan(x, heads, core) == attention._K1_BASE_PLAN
            continue
        assert _k7_plan(x, heads, core) == k1
        smem = mv._variant_smem(64, c, heads, cid, k1[0], k1[2])
        assert 0 < smem <= SMEM_LIMIT
        if core != "lanepack":
            assert smem == attention._attention_smem(64, c, heads, k1[0],
                                                     k1[2])
    nwg, _wpb, staged = k1
    assert mv.variant_launch("stack3d_ln", False, 2, c, heads, k1)[2] == 2
    assert mv.variant_launch("loop", False, None, c, heads, k1)[2] == k1[1]
    assert (c // heads, nwg, staged) in mv._K7_TRIPLES


def test_k7_lanepack_layout_adds_half_a_tensor_to_k_and_v():
    """lanepack's layout on the wgmma form: K1's less the mask, plus a zero
    head tile per pair in k and in v (half a 64 x C bf16 tensor each):
    230,528 bytes at C = 256 streamed, 214,024 at C = 128 staged."""
    mv = measure_swin_variants
    lp = mv._CORE_IDS["lanepack"]
    assert mv._variant_smem(64, 256, 16, lp, 4, 0) == 230528
    assert mv._variant_smem(64, 128, 8, lp, 4, 1) == 214024
    assert mv._variant_smem(64, 128, 2, lp, 4, 1) == 214024
    assert mv._variant_smem(64, 128, 3, lp, 4, 1) == 0  # odd heads


def test_k7_keeps_the_first_kernel_where_k1_does():
    """Head size 32 (which K1's plan sends to the wgmma form), C = 96 and
    49-token windows stay on K1's first kernel (K7's wgmma form builds
    none of them), and a triple K7 does not build (head size 16, two
    warpgroups) too."""
    mv = measure_swin_variants
    for c, heads in ((64, 2), (96, 6), (96, 3)):
        x = torch.empty(8, 80, 80, c, device="meta", dtype=torch.bfloat16)
        for core in mv.CORES:
            assert _k7_plan(x, heads, core) == attention._K1_BASE_PLAN
    for cid in mv._CORE_IDS.values():
        assert mv._variant_smem(49, 64, 1, cid, 2, 1) == 0
        assert mv._variant_smem(64, 64, 4, cid, 2, 1) == 0
    x = torch.empty(8, 80, 80, 64, device="meta", dtype=torch.bfloat16)
    assert attention._attention_plan(8, 80, 80, 64, 4)[0] == 2
    assert _k7_plan(x, 4, "loop") == attention._K1_BASE_PLAN


def test_k7_core_to_instantiation():
    """ln+qkv1 is stack3d_ln on the wgmma form (one q | k | v product
    already) and keeps its flag on the first kernel; stack3d(_ln) is
    loop(_ln) where a warpgroup holds one head (enc0, enc1: head size 64),
    and stacks two heads per stage at head size 16 (bott, dec0: four heads
    per warpgroup; dec1: two)."""
    mv = measure_swin_variants
    base = attention._K1_BASE_PLAN
    assert mv.variant_launch("stack3d_ln", True, None, 256, 16,
                             (4, 2, 0)) == ("stack3d_ln", False, 2)
    assert mv.variant_launch("stack3d_ln", True, None, 256, 16,
                             base) == ("stack3d_ln", True, 1)
    for c, heads, nwg, one in ((64, 1, 2, True), (128, 2, 4, True),
                               (256, 16, 4, False), (128, 8, 4, False),
                               (64, 4, 4, True)):
        for core in ("stack3d", "stack3d_ln"):
            want = core.replace("stack3d", "loop") if one else core
            assert mv.wgmma_core(core, c, heads, nwg) == want
            assert mv.heads_per_stage(core, c, heads, nwg) == (1 if one
                                                               else 2)
        assert mv.heads_per_stage("loop", c, heads, nwg) == 1
        assert mv.wgmma_core("lanepack", c, heads, nwg) == "lanepack"


def test_k10_and_k7_refuse_off_the_card():
    """K10's and K7's wrappers take CUDA tensors only, on either form and
    with the default plan: any other device gets an error naming the
    shape, never the plain version."""
    c, ch = 64, 256
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    lp = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (ch, c), (ch,), (ch, 1, 3, 3), (ch,), (c, ch), (c,))]
    for plan in (leff._K2_FORMS[0], leff._K2_BASE_PLAN, None):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            measure_swin_rates.ablation_leff(x, *lp, dw=False, plan=plan)
    ap = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (c,),
        (1, 64, 64))]
    for plan in ((2, 1, 1), attention._K1_BASE_PLAN, None):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            measure_swin_variants.attention_variant(
                x, *ap, heads=1, core="stack3d", plan=plan)


def _k9_plan(x, heads):
    return measure_swin_rates.ablation_plan(
        x, heads, smem=attention._attention_smem,
        asmem=measure_swin_rates._ablation_smem)


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("h,c,heads", GROUPS, ids=IDS)
def test_k9_takes_k1s_form(h, c, heads, batch):
    """K9 runs on the form K1's own plan gives the map (the wgmma form, with
    its windows per block, at every group), every variant in K1's own
    shared memory, at a triple its wgmma form is built for."""
    mr = measure_swin_rates
    x = torch.empty(batch, h, h, c, device="meta", dtype=torch.bfloat16)
    k1 = attention._attention_plan(batch, h, h, c, heads)
    assert k1[0] > 0
    assert _k9_plan(x, heads) == k1
    for variant in mr._ATTN_VARIANTS.values():
        smem = mr._ablation_smem(64, c, heads, variant, k1[0], k1[2])
        assert 0 < smem <= SMEM_LIMIT
        assert smem == attention._attention_smem(64, c, heads, k1[0], k1[2])
    assert (c // heads, k1[0], k1[2]) in mr._K9_TRIPLES


def test_k9_keeps_the_first_kernel_where_k1_does():
    """Head size 32 and C = 96 stay on K1's first kernel (K9's wgmma form
    is built for neither; K1 itself takes head size 32 there), and so does
    a triple K9's wgmma form is not built for (head size 16 with two
    warpgroups), where K1 itself takes the form."""
    for c, heads in ((64, 2), (96, 6), (96, 3)):
        x = torch.empty(8, 80, 80, c, device="meta", dtype=torch.bfloat16)
        assert _k9_plan(x, heads) == attention._K1_BASE_PLAN
    x = torch.empty(8, 80, 80, 64, device="meta", dtype=torch.bfloat16)
    assert attention._attention_plan(8, 80, 80, 64, 4)[0] == 2
    assert _k9_plan(x, 4) == attention._K1_BASE_PLAN


def test_k9_smem_refuses_what_the_kernel_does_not_take():
    """The model of `fbanet_attention_ablation_wgmma_smem`: K1's layout at
    the four built triples and variants 0-3, else 0."""
    mr = measure_swin_rates
    assert mr._ablation_smem(64, 64, 1, 2, 2, 1) == \
        attention._attention_smem(64, 64, 1, 2, 1) > 0
    for args in ((49, 64, 1, 0, 2, 1),   # 7 x 7 windows
                 (64, 64, 1, 4, 2, 1),   # no variant 4
                 (64, 64, 1, -1, 2, 1),
                 (64, 64, 4, 1, 2, 1),   # (16, 2, 1) is not built
                 (64, 64, 1, 1, 2, 0),   # (64, 2, 0) is not built
                 (64, 96, 3, 1, 4, 1),   # head size 32
                 (64, 64, 3, 1, 4, 1),   # C % heads
                 (64, 64, 0, 1, 4, 1),   # no heads
                 (64, 512, 8, 1, 4, 0)):  # C > 256
        assert mr._ablation_smem(*args) == 0, args


def test_k9_refuses_off_the_card():
    """K9's wrapper takes CUDA tensors only, on either form and with the
    default plan: any other device gets an error naming the shape, never
    the plain version, and nothing is counted."""
    mr = measure_swin_rates
    c = 64
    x = torch.empty(1, 16, 16, c, device="meta", dtype=torch.bfloat16)
    ap = [torch.empty(s, device="meta") for s in (
        (c,), (c,), (c, c), (c,), (2 * c, c), (2 * c,), (c, c), (c,),
        (1, 64, 64))]
    before = (mr.ablation_attention.wgmma.launches,
              mr.ablation_attention.base.launches)
    for plan in ((2, 1, 1), attention._K1_BASE_PLAN, None):
        with pytest.raises(ValueError, match=r"\(1, 16, 16, 64\)"):
            mr.ablation_attention(x, *ap, heads=1, softmax=False, plan=plan)
    assert (mr.ablation_attention.wgmma.launches,
            mr.ablation_attention.base.launches) == before
