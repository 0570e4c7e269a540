"""RealBSR burst dataset: filename grammar, sharding, cropping, augmentation
(counterpart of fbanet_tpu/data/realbsr.py, sample for sample).

- Layouts: "aligned" (`{split}/LR_aligned/{burst}/{scene}_MFSR_Sony_
  {patch:04d}_x1_{frame:02d}.png` + `{split}/HR/{burst}/..._x4.png`) and
  "warp" (one directory per burst holding `..._x{s}_{f:02d}.png` and
  `..._x{s}warp.png`).
- Per-epoch permutation keyed by `seed + epoch`, drop-remainder shards.
- Train-time random frame subset that keeps frame 0, coupled LR/HR random
  crop, one of 8 burst-consistent dihedral transforms.
- `cache_decoded`: decode each burst once into RAM, then assemble samples
  from the cache (the same rng draws, so the same samples).
- `wire_dtype="storage"` hands out the PNG integers (uint8 / 255, RAW
  uint16 / 16383) for the device to normalise.

Decoders, in the JAX package's order: the native libpng pool
(`native_io`) for 8-bit RGB where it builds and loads, else per file cv2,
then PIL, then `png.py` (zlib and numpy only) where neither cv2 nor PIL
imports. RAW (16-bit, 4 channels) decodes per file through cv2, else
`png.py`. `dataset.decoder` names the one in use. Where the native pool
refuses a burst (an odd-sized or corrupt file), that burst decodes per file,
which gives the same pixels, and a warning says so.
"""

from __future__ import annotations

import functools
import logging
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from fbanet_tpu_torch.data import native_io, png

log = logging.getLogger(__name__)

# The DALI-tree grammar (reference: fba_net/pipeline/real_bsr_dataset.py:40-55).
WARP_PATTERN = re.compile(
    r"^(?P<scene>\d{3})_MFSR_Sony_(?P<patch>\d{4})_x(?P<scale>\d)"
    r"(?:_(?P<frame>\d{2})|warp)\.png$"
)


@functools.cache
def file_decoder(channels: int = 3) -> str:
    """The per-file decoder this host has: "cv2", "pil" (8-bit RGB only) or
    "png.py"."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    if channels == 3:
        try:
            import PIL.Image  # noqa: F401

            return "pil"
        except ImportError:
            pass
    return "png.py"


def decode_png(path: Path) -> np.ndarray:
    """PNG -> uint8 HWC RGB through `file_decoder()`."""
    kind = file_decoder(3)
    if kind == "cv2":
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise OSError(f"failed to decode {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if kind == "pil":
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    return png.decode_rgb(path)


def decode_png_raw(path: Path) -> np.ndarray:
    """16-bit packed-Bayer PNG -> f32 [H, W, 4] in [0, 1] (/ 16383), in
    cv2's IMREAD_UNCHANGED channel order (fbanet_tpu/data/realbsr.py:55-70)."""
    if file_decoder(4) == "cv2":
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise OSError(f"failed to decode {path}")
    else:
        img = png.decode(path)
    if img.ndim != 3 or img.shape[-1] != 4:
        raise OSError(f"expected a 4-channel packed-Bayer PNG, got "
                      f"{img.shape} in {path}")
    return img.astype(np.float32) / 16383.0


def dihedral_transform(img: np.ndarray, idx: int) -> np.ndarray:
    """One of the 8 rotation/flip augmentations on [..., H, W, C]: idx % 4
    rot90s, idx >= 4 adds a flip (the reference's Augment_RGB_torch
    numbering)."""
    k = idx % 4
    out = np.rot90(img, k=k, axes=(-2, -3)) if k else img
    if idx >= 4:
        out = np.flip(out, axis=-3)
    return np.ascontiguousarray(out)


@dataclass
class BurstRecord:
    name: str
    lr_paths: list[Path]
    hr_path: Path | None  # None for GT-free test bursts


@dataclass
class RealBSRDataset:
    """Index over a RealBSR tree plus sample assembly (decode / crop /
    augment). `load(index, rng)` gives one sample; ordering, epochs and
    shards come from `epoch_indices`."""

    root: str | Path
    split: str = "train"  # train | val | test ("val" reads the test split)
    layout: str = "aligned"  # aligned | warp
    burst_size: int = 14
    crop_size: int = 160  # LR-space patch (--train_ps); 0 = no crop
    scale: int = 4
    channels: int = 3  # 3 = 8-bit RGB (/255); 4 = 16-bit RAW (/16383)
    augment: bool = True
    random_frame_subset: bool = True
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    cache_decoded: bool = False
    cache_limit_bytes: int = 8 << 30
    wire_dtype: str = "float32"  # float32 | storage

    records: list[BurstRecord] = field(init=False)

    def __post_init__(self) -> None:
        self._cache: dict[int, tuple] = {}
        self._cache_lock = threading.Lock()
        self._cache_bytes = 0
        self._decoder: str | None = None
        root = Path(self.root)
        self.records = []
        if self.layout == "aligned":
            split_dir = root / ("test" if self.split in ("val", "test") else "train")
            lr_root, hr_root = split_dir / "LR_aligned", split_dir / "HR"
            for burst_dir in sorted(p for p in lr_root.iterdir() if p.is_dir()):
                scene = burst_dir.name.split("_")[0]
                patch = int(burst_dir.name.split("_")[-1])
                lr_paths = sorted(burst_dir.glob("*_x1_*.png"))
                if not lr_paths:  # any frame-numbered grammar
                    lr_paths = sorted(
                        f for f in burst_dir.glob("*.png")
                        if WARP_PATTERN.match(f.name)
                        and WARP_PATTERN.match(f.name)["frame"] is not None)
                if not lr_paths:
                    raise FileNotFoundError(f"no LR frames in {burst_dir}")
                hr_path = (hr_root / burst_dir.name
                           / f"{scene}_MFSR_Sony_{patch:04d}_x4.png")
                if not hr_path.exists():
                    if self.split != "test":
                        raise FileNotFoundError(
                            f"missing HR frame {hr_path} (split={self.split}; "
                            f"GT-free trees are only valid with split='test')")
                    hr_path = None
                self.records.append(BurstRecord(burst_dir.name, lr_paths, hr_path))
        elif self.layout == "warp":
            for burst_dir in sorted(p for p in root.iterdir() if p.is_dir()):
                lr_paths: list[Path] = []
                hr_path: Path | None = None
                for f in sorted(burst_dir.iterdir()):
                    m = WARP_PATTERN.match(f.name)
                    if m is None:
                        continue
                    if m["frame"] is None:
                        hr_path = f
                    elif len(lr_paths) < self.burst_size:
                        lr_paths.append(f)
                if hr_path is None and self.split != "test":
                    raise FileNotFoundError(f"no HR frame in {burst_dir}")
                self.records.append(BurstRecord(burst_dir.name, lr_paths, hr_path))
        else:
            raise ValueError(f"unknown layout {self.layout}")
        if not self.records:
            raise FileNotFoundError(f"no bursts found under {root}")

    @property
    def decoder(self) -> str:
        """"native", "cv2", "pil" or "png.py": the decoder this dataset
        reads with (the native pool is built and loaded on first asking)."""
        if self._decoder is None:
            self._decoder = ("native" if self.channels == 3
                             and native_io.available()
                             else file_decoder(self.channels))
        return self._decoder

    # --- ordering / sharding -------------------------------------------------

    def __len__(self) -> int:
        return len(self.records)

    @property
    def shard_size(self) -> int:
        return len(self.records) // self.num_shards

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Permutation for `epoch` (rng(seed + epoch); identity off the
        train split), sliced to this shard."""
        perm = np.random.default_rng(self.seed + epoch).permutation(
            len(self.records))
        if self.split != "train":
            perm = np.arange(len(self.records))
        start = self.shard_size * self.shard_id
        return perm[start:start + self.shard_size]

    # --- sample assembly -----------------------------------------------------

    def _dims(self, lr_path: Path, hr_path: Path | None):
        """(LR (h, w), HR (h, w) or None), read once from the PNG headers."""
        if not hasattr(self, "_probe_dims"):
            self._probe_dims = (png.read_header(lr_path)[:2],
                                png.read_header(hr_path)[:2] if hr_path
                                else None)
        (lh, lw), hr_dims = self._probe_dims
        if hr_path is not None and hr_dims is None:  # mixed GT-free tree
            hr_dims = png.read_header(hr_path)[:2]
            self._probe_dims = ((lh, lw), hr_dims)
        return (lh, lw), hr_dims

    def _native_refused(self, paths, exc: OSError) -> None:
        log.warning("native PNG decode refused a burst (%s); decoding it "
                    "per file with %s: %s", paths[0].parent, file_decoder(3),
                    exc)

    def _decode_burst(self, lr_paths: list[Path], hr_path: Path | None
                      ) -> tuple[np.ndarray, np.ndarray | None]:
        """One burst's LR frames (+ HR if present) as f32 in [0, 1]."""
        if self.channels == 4:
            lr = np.stack([decode_png_raw(p) for p in lr_paths])
            hr = decode_png_raw(hr_path) if hr_path is not None else None
            return lr, hr
        if self.decoder == "native":
            (lh, lw), hr_dims = self._dims(lr_paths[0], hr_path)
            try:
                lr = native_io.decode_files(lr_paths, lh, lw, as_float=True)
                hr = None
                if hr_path is not None:
                    hr = native_io.decode_files([hr_path], *hr_dims,
                                                as_float=True)[0]
                return lr, hr
            except OSError as exc:
                self._native_refused(lr_paths, exc)
        lr = np.stack([decode_png(p) for p in lr_paths]).astype(np.float32) / 255.0
        hr = (decode_png(hr_path).astype(np.float32) / 255.0
              if hr_path is not None else None)
        return lr, hr

    def _cached_frames(self, index: int) -> tuple[np.ndarray, np.ndarray | None]:
        """All frames of record `index` in the storage dtype, kept in RAM
        (up to `cache_limit_bytes`). Two threads missing at once may both
        decode; one result takes the slot, both are identical."""
        hit = self._cache.get(index)
        if hit is not None:
            return hit
        rec = self.records[index]
        if self.channels == 4:
            lr = np.stack([np.asarray(
                decode_png_raw(p) * 16383.0 + 0.5, np.uint16)
                for p in rec.lr_paths])
            hr = (np.asarray(decode_png_raw(rec.hr_path) * 16383.0 + 0.5,
                             np.uint16) if rec.hr_path is not None else None)
        else:
            lr = hr = None
            if self.decoder == "native":
                (lh, lw), hr_dims = self._dims(rec.lr_paths[0], rec.hr_path)
                try:
                    lr = native_io.decode_files(rec.lr_paths, lh, lw,
                                                as_float=False)
                    if rec.hr_path is not None:
                        hr = native_io.decode_files(
                            [rec.hr_path], *hr_dims, as_float=False)[0]
                except OSError as exc:
                    self._native_refused(rec.lr_paths, exc)
                    lr = None
            if lr is None:
                lr = np.stack([decode_png(p) for p in rec.lr_paths])
                hr = (decode_png(rec.hr_path)
                      if rec.hr_path is not None else None)
        entry = (lr, hr)
        nbytes = lr.nbytes + (hr.nbytes if hr is not None else 0)
        with self._cache_lock:
            if self._cache_bytes + nbytes <= self.cache_limit_bytes:
                if index not in self._cache:
                    self._cache[index] = entry
                    self._cache_bytes += nbytes
        return entry

    def warm_cache(self) -> int:
        """Decode every record into the RAM cache up front (`--warm_start`);
        returns the number of cached bursts (records past the limit stay
        decode-on-load)."""
        if not self.cache_decoded:
            return 0
        for i in range(len(self.records)):
            self._cached_frames(i)
        return len(self._cache)

    def _storage_to_f32(self, arr: np.ndarray) -> np.ndarray:
        scale = np.float32(1.0 / 16383.0 if self.channels == 4
                           else 1.0 / 255.0)
        return arr.astype(np.float32) * scale

    def load(self, index: int, rng: np.random.Generator | None = None
             ) -> dict[str, np.ndarray | str]:
        """Decode, frame-subset, crop and augment one burst.

        Returns {'LR': [F, h, w, C], 'HR': [H, W, C], 'burst_name'}: f32 in
        [0, 1] under wire_dtype="float32", the storage integers under
        "storage"; GT-free bursts have no 'HR'. The cached and uncached
        paths draw from `rng` in the same order and give the same sample.
        """
        rec = self.records[index]
        rng = rng or np.random.default_rng(self.seed)

        frame_ids = list(range(len(rec.lr_paths)))
        if self.random_frame_subset and self.split == "train" and \
                self.burst_size < len(rec.lr_paths):
            rest = rng.choice(np.arange(1, len(rec.lr_paths)),
                              size=self.burst_size - 1, replace=False)
            frame_ids = [0, *sorted(int(i) for i in rest)]
        else:
            frame_ids = frame_ids[: self.burst_size]

        if self.cache_decoded:
            lr_all, hr_st = self._cached_frames(index)
            lr_h, lr_w = lr_all.shape[1:3]
            cs = self.crop_size
            crop = bool(cs) and lr_h != cs
            if crop and self.split == "train":
                r1 = int(rng.integers(0, lr_h - cs + 1))
                c1 = int(rng.integers(0, lr_w - cs + 1))
            else:
                r1 = c1 = 0
            cs_eff = cs if crop else lr_h
            t = (int(rng.integers(0, 8))
                 if self.augment and self.split == "train" else 0)
            # the native pass takes a square in-bounds window
            native_ok = (self.channels == 3
                         and r1 + cs_eff <= lr_h and c1 + cs_eff <= lr_w
                         and (crop or lr_h == lr_w)
                         and self.decoder == "native")
            if self.wire_dtype == "storage":
                lr = lr_all[frame_ids]
                hr = hr_st
                if crop:
                    lr = lr[:, r1:r1 + cs, c1:c1 + cs]
                    if hr is not None:
                        s = hr.shape[0] // lr_h
                        hr = hr[s * r1:s * (r1 + cs), s * c1:s * (c1 + cs)]
                if t:
                    lr = dihedral_transform(lr, t)
                    if hr is not None:
                        hr = dihedral_transform(hr, t)
            elif native_ok:
                lr = native_io.transform_f32(lr_all, frame_ids, r1, c1,
                                             cs_eff, t)
                hr = None
                if hr_st is not None:
                    s = hr_st.shape[0] // lr_h
                    hr = native_io.transform_f32(
                        hr_st[None], [0], s * r1, s * c1, s * cs_eff, t)[0]
            else:  # RAW u16, non-square frames, or no native pool
                lr = self._storage_to_f32(lr_all[frame_ids])
                hr = (self._storage_to_f32(hr_st)
                      if hr_st is not None else None)
                if crop:
                    lr = lr[:, r1:r1 + cs, c1:c1 + cs]
                    if hr is not None:
                        s = hr.shape[0] // lr_h
                        hr = hr[s * r1:s * (r1 + cs), s * c1:s * (c1 + cs)]
                if t:
                    lr = dihedral_transform(lr, t)
                    if hr is not None:
                        hr = dihedral_transform(hr, t)
        else:
            lr, hr = self._decode_burst([rec.lr_paths[i] for i in frame_ids],
                                        rec.hr_path)
            cs = self.crop_size
            if cs and lr.shape[1] != cs:
                if self.split == "train":
                    r1 = int(rng.integers(0, lr.shape[1] - cs + 1))
                    c1 = int(rng.integers(0, lr.shape[2] - cs + 1))
                else:  # deterministic top-left off the train split
                    r1 = c1 = 0
                lr_h = lr.shape[1]
                lr = lr[:, r1:r1 + cs, c1:c1 + cs]
                if hr is not None:
                    s = hr.shape[0] // lr_h
                    hr = hr[s * r1:s * (r1 + cs), s * c1:s * (c1 + cs)]
            if self.augment and self.split == "train":
                t = int(rng.integers(0, 8))
                lr = dihedral_transform(lr, t)
                if hr is not None:
                    hr = dihedral_transform(hr, t)
            if self.wire_dtype == "storage":
                # every value is k / scale and crops and flips do not
                # interpolate, so rounding back is exact
                scale = 16383.0 if self.channels == 4 else 255.0
                idt = np.uint16 if self.channels == 4 else np.uint8
                lr = np.asarray(np.rint(lr * scale), idt)
                if hr is not None:
                    hr = np.asarray(np.rint(hr * scale), idt)

        out: dict[str, np.ndarray | str] = {"LR": lr, "burst_name": rec.name}
        if hr is not None:
            out["HR"] = hr
        return out
