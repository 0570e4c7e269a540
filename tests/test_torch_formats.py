"""The port's data formats and conversions against the JAX package, on
the CPU (each test well under a second): the RAW post-processing, the
LPIPS weight layouts, the legacy-checkpoint importer, MAT files and the
single-image data path, and the space-to-depth Downsample of
`tools/measure_downsample_b16.py`.

Tolerances:
- `utils/raw.py`: `pack_bayer` / `unpack_bayer` / `to_uint8` exact;
  `postprocess_raw` within 1e-6 absolute over every flag (the same f32 ops
  on values in [0, 1]; the mean over the image and `pow` may round
  differently).
- LPIPS: the `.npz` round trip and `convert_state_dict` exact.
- The importer: the imported model's forward bit-equal to the source
  model's (the same tensors, loaded strictly).
- MAT files: the port's `savemat` byte-equal to JAX's past the 116-byte
  header text (which names the writing module); loads exact.
- Single-image data: the same draws, so the same crops, bit for bit.
- The space-to-depth Downsample within 1e-5 of the strided conv in f32.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TINY, max_err, n, rng, t

from fbanet_tpu.utils import raw as jraw
from fbanet_tpu_torch.utils import raw

ROOT = Path(__file__).resolve().parents[1]

# ------------------------------------------------------------------- RAW --

META = {"norm_factor": 1000.0, "black_level": [2.0, 1.0, 3.0, 1.5],
        "cam_wb": [2.0, 1.0, 1.2, 1.5]}
POSTPROCESS = {
    "default": ({}, {}),
    "return_rgb": ({}, dict(return_rgb=True)),
    "black_level": (META, dict(black_level_subtracted=False)),
    "meta_black_level_done": ({**META, "black_level_subtracted": True},
                              dict(black_level_subtracted=False)),
    "white_balance": (META, {}),
    "while_balance_applied": ({**META, "while_balance_applied": True}, {}),
    "no_white_balance": (META, dict(no_white_balance=True)),
    "external_norm": (META, dict(external_norm_factor=40.0)),
    "no_gamma": ({}, dict(gamma=False)),
    "no_smoothstep": ({}, dict(smoothstep=False)),
    "all_off_rgb": (META, dict(black_level_subtracted=False, gamma=False,
                               smoothstep=False, external_norm_factor=20.0,
                               return_rgb=True)),
}


@pytest.mark.parametrize("channels", [4, 3])
@pytest.mark.parametrize("case", list(POSTPROCESS))
def test_postprocess_raw_matches_jax(case, channels):
    """Every branch, on packed Bayer and on 3-channel images (where 4
    black levels / gains collapse to 3)."""
    meta, kw = POSTPROCESS[case]
    im = rng(1).uniform(0, 0.05, (2, 6, 5, channels)).astype(np.float32)
    got = raw.postprocess_raw(t(im), meta, **kw)
    ref = jraw.postprocess_raw(jnp.asarray(im), meta, **kw)
    assert got.shape == ref.shape
    assert max_err(got, ref) <= 1e-6


def test_pack_unpack_match_jax():
    mosaic = rng(2).uniform(size=(3, 8, 10)).astype(np.float32)
    packed = raw.pack_bayer(t(mosaic))
    np.testing.assert_array_equal(n(packed),
                                  np.asarray(jraw.pack_bayer(mosaic)))
    assert packed.shape == (3, 4, 5, 4)
    np.testing.assert_array_equal(n(raw.unpack_bayer(packed)), mosaic)
    np.testing.assert_array_equal(
        n(raw.unpack_bayer(packed)),
        np.asarray(jraw.unpack_bayer(jnp.asarray(n(packed)))))


def test_to_uint8_matches_jax():
    im = rng(3).uniform(-0.1, 1.1, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(raw.to_uint8(t(im)), jraw.to_uint8(im))
    np.testing.assert_array_equal(raw.to_uint8(im), jraw.to_uint8(im))


# ------------------------------------------------------------------ LPIPS --

def _image_pair(size=72):
    r = rng(4)
    return (r.uniform(0, 1, (2, size, size, 3)).astype(np.float32),
            r.uniform(0, 1, (2, size, size, 3)).astype(np.float32))


def test_lpips_npz_round_trip(tmp_path):
    from fbanet_tpu_torch.models import lpips

    np.savez(tmp_path / "w.npz", **lpips.random_lpips_weights(5))
    a, b = _image_pair(64)
    loaded = lpips.load_lpips(tmp_path / "w.npz")
    assert torch.equal(loaded(t(a), t(b)),
                       lpips.random_initialized_lpips(5)(t(a), t(b)))


def test_convert_state_dict_matches_the_export_script():
    """An lpips.LPIPS(net="alex")-shaped state_dict (torchvision AlexNet
    conv indices 0, 3, 6, 8, 10 in the slices, 1x1 heads) converts as
    scripts/export_lpips_weights.py converts it, and loads."""
    from fbanet_tpu_torch.models import lpips

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from export_lpips_weights import convert_state_dict
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    r = rng(6)
    sd = {"scaling_layer.shift": r.normal(size=(1, 3, 1, 1)),
          "scaling_layer.scale": r.uniform(0.4, 0.5, (1, 3, 1, 1))}
    cin = 3
    for i, (idx, (cout, k, *_)) in enumerate(zip((0, 3, 6, 8, 10),
                                                 lpips._ALEX_LAYERS)):
        sd[f"net.slice{i + 1}.{idx}.weight"] = r.normal(size=(cout, cin, k, k))
        sd[f"net.slice{i + 1}.{idx}.bias"] = r.normal(size=(cout,))
        sd[f"lin{i}.model.1.weight"] = r.uniform(size=(1, cout, 1, 1))
        cin = cout
    got, want = lpips.convert_state_dict(sd), convert_state_dict(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lpips.LPIPS(got)


# ------------------------------------------------------- legacy importer --

# the importer's model: its flags' configuration (the default heads)
IMPORTED = TINY.replace(heads=(1, 2, 4, 8, 16, 16, 8, 4, 2))


def _legacy(tmp_path, rename_to=None):
    """A legacy-format .pth of a random tiny model: {"epoch", "state_dict"
    with DataParallel's "module." prefix, "optimizer"}, one key renamed to
    `rename_to` (the legacy name a --map_json maps back)."""
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.utils.weights import random_state_dict

    model = create_model(IMPORTED, device="cpu", seed=1)
    model.load_state_dict(random_state_dict(model, seed=9), strict=True)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    if rename_to:
        sd[f"module.{rename_to}"] = sd.pop("module.head.weight")
    path = tmp_path / "legacy.pth"
    torch.save({"epoch": 7, "state_dict": sd,
                "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]}},
               path)
    return model, path


def _import_argv(path, out, *extra):
    return [str(path), str(out), "--embed_dim", "16", "--train_ps", "32",
            "--win_size", "8", "--burst_size", "3", "--device", "cpu", *extra]


def test_import_legacy_checkpoint_is_bit_equal(tmp_path):
    from fbanet_tpu_torch.models import create_model
    from fbanet_tpu_torch.tools import import_torch_checkpoint as imp
    from fbanet_tpu_torch.utils.checkpoint import load_checkpoint, load_params

    src, path = _legacy(tmp_path, rename_to="first_conv.kernel")
    (tmp_path / "map.json").write_text(json.dumps(
        {"first_conv.kernel": "head.weight"}))
    imp.main(_import_argv(path, tmp_path / "out", "--map_json",
                          str(tmp_path / "map.json")))
    meta = load_checkpoint(tmp_path / "out")
    assert meta["epoch"] == 7 and meta["imported_from"] == str(path)
    model = create_model(IMPORTED, device="cpu")
    model.load_state_dict(load_params(tmp_path / "out"), strict=True)
    burst = t(rng(8).uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model(burst), src(burst))


def test_import_refuses_a_shape_matched_wrong_name(tmp_path):
    """A key under another name of the same shape is never matched by
    shape: the error lists it as unexpected beside the missing one."""
    from fbanet_tpu_torch.tools import import_torch_checkpoint as imp

    _, path = _legacy(tmp_path, rename_to="body0.Conv_9.weight")
    with pytest.raises(KeyError) as err:
        imp.main(_import_argv(path, tmp_path / "out"))
    text = str(err.value)
    assert "MISSING head.weight" in text
    assert "UNEXPECTED body0.Conv_9.weight" in text
    assert not (tmp_path / "out.pt").exists()


# ---------------------------------------------------- mat5 / single image --

def test_mat5_bytes_match_jax(tmp_path):
    from fbanet_tpu.utils import mat5 as jmat5
    from fbanet_tpu_torch.utils import mat5

    r = rng(0)
    cells = np.empty((1, 2), dtype=object)
    cells[0, 0] = r.integers(0, 256, (3, 4, 3), dtype=np.uint8)
    cells[0, 1] = r.integers(0, 256, (2, 5, 3), dtype=np.uint8)
    arrs = {"u8": r.integers(0, 256, (5, 7, 3), dtype=np.uint8),
            "f32": r.normal(size=(4, 6)).astype(np.float32),
            "f64": r.normal(size=(3,)), "u16": r.integers(0, 9, (2, 3),
                                                          dtype=np.uint16),
            "results": cells}
    mat5.savemat(tmp_path / "port.mat", arrs)
    jmat5.savemat(tmp_path / "jax.mat", arrs)
    got = (tmp_path / "port.mat").read_bytes()
    want = (tmp_path / "jax.mat").read_bytes()
    assert got[:116].startswith(b"MATLAB 5.0 MAT-file")
    assert got[116:] == want[116:]
    back = mat5.loadmat(tmp_path / "port.mat")
    np.testing.assert_array_equal(back["u8"], arrs["u8"])
    np.testing.assert_array_equal(back["f32"], arrs["f32"])
    np.testing.assert_array_equal(back["f64"], arrs["f64"].reshape(1, -1))
    np.testing.assert_array_equal(back["results"][0, 1], cells[0, 1])
    np.testing.assert_array_equal(jmat5.loadmat(tmp_path / "port.mat")["u16"],
                                  arrs["u16"])


@pytest.fixture(scope="module")
def paired_root(tmp_path_factory):
    from fbanet_tpu_torch.data import png

    root = tmp_path_factory.mktemp("paired")
    (root / "groundtruth").mkdir()
    (root / "input").mkdir()
    r = rng(2)
    for i in range(3):
        clean = r.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        noisy = np.clip(clean + r.integers(-9, 9, clean.shape), 0,
                        255).astype(np.uint8)
        png.write_png(root / "groundtruth" / f"{i:03d}.png", clean)
        png.write_png(root / "input" / f"{i:03d}.png", noisy)
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_paired_dataset_matches_jax(paired_root, split):
    from fbanet_tpu.data.single_image import PairedImageDataset as J
    from fbanet_tpu_torch.data.single_image import PairedImageDataset as P

    port, ref = (cls(paired_root, split=split, patch_size=32) for cls in (P, J))
    assert len(port) == len(ref) == 3
    for i in range(3):
        a = port.load(i, np.random.default_rng(i))
        b = ref.load(i, np.random.default_rng(i))
        assert a["name"] == b["name"] and a["gt"].shape == (32, 32, 3)
        np.testing.assert_array_equal(a["gt"], b["gt"])
        np.testing.assert_array_equal(a["input"], b["input"])


def test_generate_patches_matches_jax(paired_root, tmp_path):
    from fbanet_tpu.data.single_image import generate_patches as jgen
    from fbanet_tpu_torch.data.realbsr import decode_png
    from fbanet_tpu_torch.data.single_image import generate_patches

    src = paired_root / "groundtruth"
    n = generate_patches(src, tmp_path / "p", patch_size=16,
                         patches_per_image=2, workers=2)
    assert n == jgen(src, tmp_path / "j", patch_size=16, patches_per_image=2,
                     workers=2) == 6
    names = sorted(q.name for q in (tmp_path / "p").glob("*.png"))
    assert names == sorted(q.name for q in (tmp_path / "j").glob("*.png"))
    for name in names:
        np.testing.assert_array_equal(decode_png(tmp_path / "p" / name),
                                      decode_png(tmp_path / "j" / name))


def test_bundle_submission(tmp_path):
    from fbanet_tpu.utils.mat5 import loadmat as jloadmat
    from fbanet_tpu_torch.data import png
    from fbanet_tpu_torch.data.single_image import bundle_submission
    from fbanet_tpu_torch.utils.mat5 import loadmat

    res = tmp_path / "res"
    res.mkdir()
    r = rng(5)
    written = {}
    for img in range(2):
        for block in range(3):
            a = r.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            written[(img, block)] = a
            png.write_png(res / f"{img:04d}_{block:02d}.png", a)
    out = bundle_submission(res, tmp_path / "mat")
    mats = sorted(out.glob("*.mat"))
    assert [m.name for m in mats] == ["0000.mat", "0001.mat"]
    for i, m in enumerate(mats):
        for reader in (loadmat, jloadmat):
            cells = reader(m)["results"]
            assert cells.shape == (1, 3)
            for block in range(3):
                np.testing.assert_array_equal(cells[0, block],
                                              written[(i, block)])


def test_downsample_s2d_equals_the_strided_conv():
    from fbanet_tpu_torch.models.layers import Downsample
    from fbanet_tpu_torch.tools.measure_downsample_b16 import DownsampleS2D
    from fbanet_tpu_torch.utils.weights import random_state_dict

    conv = Downsample(8, 16)
    conv.load_state_dict(random_state_dict(conv, seed=2))
    s2d = DownsampleS2D(8, 16)
    s2d.load_state_dict(conv.state_dict())
    x = t(rng(3).standard_normal((2, 12, 12, 8)).astype(np.float32))
    with torch.no_grad():
        want = conv(x, torch.float32)
        got = s2d(x, torch.float32)
    assert got.shape == want.shape == (2, 6, 6, 16)
    assert max_err(got, want) <= 1e-5
