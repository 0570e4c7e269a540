"""The port's data path against the JAX package's: `png.py`, the synthetic
tree writer, `RealBSRDataset.load` and `BurstLoader`, and the native pool's
binding. CPU only, tiny trees (3-6 frames of 16-24 px).

Tolerance: none. Samples, batches and decoded pixels must be equal bit for
bit: both packages draw from the same (seed, epoch, position) generators,
crop and flip without interpolating, and normalise with the same f32
operation on the same decoder path.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _write(writer, root, **kw):
    writer(root, num_frames=4, lr_size=16, **kw)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Trees written by the JAX package's writer (PIL and cv2 files), one per
    (layout, channels)."""
    from fbanet_tpu.data.synthetic import write_synthetic_realbsr

    mk = tmp_path_factory.mktemp
    return {
        ("aligned", 3): _write(write_synthetic_realbsr, mk("al3"),
                               num_bursts=5),
        ("warp", 3): _write(write_synthetic_realbsr, mk("wa3"), num_bursts=3,
                            layout="warp"),
        ("aligned", 4): _write(write_synthetic_realbsr, mk("al4"),
                               num_bursts=3, channels=4),
    }


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """A tree written by the port's writer (png.py, filter 0 files)."""
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    return _write(write_synthetic_realbsr, tmp_path_factory.mktemp("port"),
                  num_bursts=3)


# ---------------------------------------------------------------- png.py


def test_png_round_trip(tmp_path):
    import cv2
    from PIL import Image

    from fbanet_tpu_torch.data import png

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (13, 9, 3), dtype=np.uint8)
    png.write_png(tmp_path / "a.png", rgb)
    np.testing.assert_array_equal(png.decode_rgb(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  rgb)
    raw = rng.integers(0, 65536, (7, 11, 4), dtype=np.uint16)
    png.write_png(tmp_path / "r.png", raw)
    np.testing.assert_array_equal(png.decode(tmp_path / "r.png"), raw)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "r.png"), cv2.IMREAD_UNCHANGED), raw)
    assert png.read_header(tmp_path / "r.png") == (7, 11, 16, 6)
    with pytest.raises(ValueError):
        png.encode(rgb.astype(np.uint16))


@pytest.mark.parametrize("filt", ["default", "NONE", "SUB", "UP"])
def test_png_decodes_cv2_files(tmp_path, filt):
    """cv2's files (filter Sub by default, or the one asked for), 8-bit
    RGB and 16-bit BGRA, decode to what cv2 reads back."""
    import cv2

    from fbanet_tpu_torch.data import png

    params = [] if filt == "default" else [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")]
    rng = np.random.default_rng(1)
    images = {"bgr": rng.integers(0, 256, (17, 23, 3), dtype=np.uint8),
              "bgra16": rng.integers(0, 65536, (6, 10, 4), dtype=np.uint16)}
    for name, img in images.items():
        path = tmp_path / f"{name}.png"
        assert cv2.imwrite(str(path), img, params)
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(png.decode(path), want)
        if img.dtype == np.uint8:
            np.testing.assert_array_equal(
                png.decode_rgb(path),
                cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                             cv2.COLOR_BGR2RGB))


def test_png_decodes_pil_files_or_names_the_filter(tmp_path):
    """PIL picks a filter per row: files it writes with filters 0-2 decode
    to PIL's pixels; a file with Paeth raises, naming the file and the
    filter."""
    from PIL import Image

    from fbanet_tpu_torch.data import png

    ramp = np.arange(0, 250, 7, dtype=np.uint8)
    easy = {"colgrad": np.repeat(np.repeat(ramp[None, :, None], 30, 0), 3, 2),
            "const": np.full((20, 20, 3), 77, np.uint8)}
    for name, img in easy.items():
        Image.fromarray(img).save(tmp_path / f"{name}.png")
        np.testing.assert_array_equal(png.decode_rgb(tmp_path / f"{name}.png"),
                                      np.asarray(Image.open(
                                          tmp_path / f"{name}.png")))
    noise = np.random.default_rng(2).integers(0, 256, (32, 32, 3), np.uint8)
    Image.fromarray(noise).save(tmp_path / "noise.png")
    with pytest.raises(OSError, match=r"noise\.png: row \d+ uses PNG filter "
                                      r"[34] \((Average|Paeth)\)"):
        png.decode(tmp_path / "noise.png")


# ------------------------------------------------------- synthetic writer


@pytest.mark.parametrize("layout,channels",
                         [("aligned", 3), ("warp", 3), ("aligned", 4)])
def test_synthetic_tree_matches_jax(tmp_path, layout, channels):
    """The port's writer (png.py) and the JAX package's (PIL, cv2) write
    the same files, pixel for pixel."""
    import cv2

    from fbanet_tpu.data.synthetic import write_synthetic_realbsr as jw
    from fbanet_tpu_torch.data import synthetic as ps

    kw = dict(num_bursts=2, num_frames=3, lr_size=8, layout=layout,
              channels=channels)
    jw(tmp_path / "jax", **kw)
    ps.write_synthetic_realbsr(tmp_path / "port", level=1, **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == 2 * (3 + 1) * (2 if layout == "aligned" else 1)
    for f in files:
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "port" / f), cv2.IMREAD_UNCHANGED),
            cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED))
    b = ps.synthetic_batch(5, 2, num_frames=3, lr_size=8)
    from fbanet_tpu.data.synthetic import synthetic_batch

    ref = synthetic_batch(5, 2, num_frames=3, lr_size=8)
    for k in ("LR", "HR"):
        np.testing.assert_array_equal(b[k], ref[k])


# ------------------------------------------------------------ the dataset


def _pair(root, layout, channels, **kw):
    from fbanet_tpu.data.realbsr import RealBSRDataset as J
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset as P

    kw = dict(layout=layout, channels=channels, burst_size=3, seed=4, **kw)
    return J(root, **kw), P(root, **kw)


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    assert a["burst_name"] == b["burst_name"]
    for k in ("LR", "HR"):
        if k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


CASES = [(layout, channels, split, cached, wire)
         for layout, channels in [("aligned", 3), ("warp", 3), ("aligned", 4)]
         for split in ("train", "val")
         for cached in (False, True)
         for wire in ("storage", "float32")
         if not (layout == "warp" and split == "val")]


@pytest.mark.parametrize("layout,channels,split,cached,wire", CASES)
def test_samples_match_jax(trees, layout, channels, split, cached, wire):
    """`load` under the same (seed, epoch, position) generators gives JAX's
    samples bit for bit: frame subset, crop, dihedral, wire dtype."""
    root = trees[(layout, channels)]
    crop = 0 if layout == "warp" and split == "train" else 8
    ref, port = _pair(root, layout, channels, split=split, crop_size=crop,
                      cache_decoded=cached, wire_dtype=wire)
    assert len(port) == len(ref) and port.shard_size == ref.shard_size
    for epoch in (0, 1):
        np.testing.assert_array_equal(port.epoch_indices(epoch),
                                      ref.epoch_indices(epoch))
    for pos, index in enumerate(port.epoch_indices(1)[:3]):
        for _ in range(2):  # the second pass reads the cache
            rng = (1, 1, pos)
            _assert_same(ref.load(int(index), np.random.default_rng(rng)),
                         port.load(int(index), np.random.default_rng(rng)))
    if cached:
        assert port.warm_cache() == ref.warm_cache() == len(port)
    assert port.decoder == ("native" if channels == 3 else "cv2")


@pytest.mark.parametrize("cached", [False, True])
def test_per_file_decoders_match_jax(port_tree, monkeypatch, cached):
    """With the native pool off in both packages, the port's per-file
    decoders (cv2, then PIL, then png.py with cv2 and PIL unimportable)
    give JAX's cv2 samples."""
    import fbanet_tpu.data.native_io as jn
    from fbanet_tpu_torch.data import realbsr

    monkeypatch.setattr(jn, "available", lambda: False)
    refs = {}
    for wire in ("storage", "float32"):
        ref, _ = _pair(port_tree, "aligned", 3, crop_size=8,
                       cache_decoded=cached, wire_dtype=wire)
        refs[wire] = [ref.load(i, np.random.default_rng((2, 0, i)))
                      for i in range(len(ref))]
    for blocked, name in [((), "cv2"), (("cv2",), "pil"),
                          (("cv2", "PIL", "PIL.Image"), "png.py")]:
        for mod in blocked:
            monkeypatch.setitem(sys.modules, mod, None)
        realbsr.file_decoder.cache_clear()
        try:
            for wire, want in refs.items():
                _, port = _pair(port_tree, "aligned", 3, crop_size=8,
                                cache_decoded=cached, wire_dtype=wire)
                port._decoder = realbsr.file_decoder(3)
                assert port.decoder == name
                for i, ref_sample in enumerate(want):
                    _assert_same(ref_sample, port.load(
                        i, np.random.default_rng((2, 0, i))))
        finally:
            for mod in blocked:
                monkeypatch.delitem(sys.modules, mod)
            realbsr.file_decoder.cache_clear()


def test_gtfree_test_split(tmp_path):
    from fbanet_tpu_torch.data.realbsr import RealBSRDataset
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    write_synthetic_realbsr(tmp_path, num_bursts=2, num_frames=3, lr_size=8,
                            splits=("test",), write_hr=False)
    ds = RealBSRDataset(tmp_path, split="test", burst_size=3, crop_size=0)
    s = ds.load(0)
    assert "HR" not in s and s["LR"].shape == (3, 8, 8, 3)
    with pytest.raises(FileNotFoundError, match="GT-free"):
        RealBSRDataset(tmp_path, split="val", burst_size=3)


# ------------------------------------------------------------- the loader


@pytest.mark.parametrize("split,start_step,pad_last",
                         [("train", 0, False), ("train", 1, False),
                          ("val", 0, True), ("val", 1, False)])
def test_loader_matches_jax(trees, split, start_step, pad_last):
    """The port's `BurstLoader` gives JAX's `BurstLoader(sharding=None)`
    batches, batch for batch, for two epochs."""
    from fbanet_tpu.data.loader import BurstLoader as JL
    from fbanet_tpu_torch.data.loader import BurstLoader as PL

    ref_ds, port_ds = _pair(trees[("aligned", 3)], "aligned", 3, split=split,
                            crop_size=8, cache_decoded=True,
                            wire_dtype="storage")
    kw = dict(batch_size=2, num_workers=2, seed=9, pad_last=pad_last)
    if split == "val":
        kw["drop_last"] = False
    ref, port = JL(ref_ds, **kw), PL(port_ds, **kw)
    assert len(port) == len(ref)
    for epoch in (0, 1):
        a = list(ref.epoch(epoch, start_step=start_step))
        b = list(port.epoch(epoch, start_step=start_step))
        assert len(a) == len(b) == len(ref) - start_step
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            assert x["burst_name"] == y["burst_name"]
            assert x.get("valid") == y.get("valid")
            for k in ("LR", "HR"):
                np.testing.assert_array_equal(x[k], y[k])
    if pad_last:
        assert b[-1]["valid"] == 1 and b[-1]["LR"].shape[0] == 2


def test_loader_device_tensors_and_early_close(trees):
    """With a device the batches are tensors there, equal to the numpy
    ones; closing an epoch early stops its producer."""
    from fbanet_tpu_torch.data.loader import BurstLoader

    _, ds = _pair(trees[("aligned", 3)], "aligned", 3, split="train",
                  crop_size=8, cache_decoded=True, wire_dtype="storage")
    host = list(BurstLoader(ds, batch_size=2, seed=1).epoch(0))
    dev = list(BurstLoader(ds, batch_size=2, seed=1, device="cpu").epoch(0))
    for x, y in zip(host, dev):
        assert isinstance(y["LR"], torch.Tensor) and y["LR"].dtype == torch.uint8
        np.testing.assert_array_equal(x["LR"], y["LR"].numpy())
        np.testing.assert_array_equal(x["HR"], y["HR"].numpy())
    it = BurstLoader(ds, batch_size=1, prefetch_depth=1, seed=1).epoch(0)
    next(it)
    it.close()


# -------------------------------------------------------- the native pool


def test_native_pool_matches_jax(trees):
    """The port's own build of native/burstio.cc decodes and transforms as
    the JAX package's binding does."""
    import fbanet_tpu.data.native_io as jn
    from fbanet_tpu_torch.data import native_io as pn

    assert pn.available() and pn.unavailable_reason() is None
    assert pn.library_path().parent.parent.name == "burstio"
    files = sorted((trees[("aligned", 3)] / "train" / "LR_aligned")
                   .rglob("*.png"))[:4]
    for as_float in (False, True):
        np.testing.assert_array_equal(
            pn.decode_files(files, 16, 16, as_float=as_float),
            jn.decode_files(files, 16, 16, as_float=as_float))
    src = pn.decode_files(files, 16, 16, as_float=False)
    for t in range(8):
        np.testing.assert_array_equal(
            pn.transform_f32(src, [3, 0, 2], 2, 5, 9, t),
            jn.transform_f32(src, [3, 0, 2], 2, 5, 9, t))
    with pytest.raises(OSError, match="burstio decode failed"):
        pn.decode_files(files, 15, 16)


def test_native_unavailable_says_why(tmp_path, monkeypatch):
    """Where g++ or libpng is missing the pool is unavailable, with the
    reason, and the dataset names the per-file decoder it falls to."""
    from fbanet_tpu_torch.data import native_io as pn
    from fbanet_tpu_torch.data import realbsr

    bad = tmp_path / "burstio.cc"
    bad.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(pn, "_SOURCE", bad)
    monkeypatch.setattr(pn, "_ROOT", tmp_path)
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_unavailable_reason", None)
    assert not pn.available()
    assert "g++ exited" in pn.unavailable_reason()
    from fbanet_tpu_torch.data.synthetic import write_synthetic_realbsr

    write_synthetic_realbsr(tmp_path / "t", num_bursts=1, num_frames=3,
                            lr_size=8, splits=("train",))
    ds = realbsr.RealBSRDataset(tmp_path / "t", burst_size=3, crop_size=0)
    assert ds.decoder == realbsr.file_decoder(3) == "cv2"
