"""Single-image restoration data (SIDD-style): paired clean / noisy images,
random patch extraction and submission bundling (counterpart of
fbanet_tpu/data/single_image.py).

The reference inherited a single-image denoising data path from the
Uformer codebase (fba_net/dataset.py DataLoaderTrain / Val / Test,
fba_net/generate_patches_SIDD.py, fba_net/utils/bundle_submissions.py).
It is vestigial for burst SR but part of the component inventory; here it
runs on the port's own decoders (`data/realbsr.py::decode_png`: cv2, PIL,
then `png.py`), writer (`png.py`) and MAT-file writer (`utils/mat5.py`,
where scipy is missing).

Directory layout (the reference's SIDD convention), paired by sorted order:
    root/groundtruth/*.png   (clean)
    root/input/*.png         (noisy / degraded)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from fbanet_tpu_torch.data import png
from fbanet_tpu_torch.data.realbsr import decode_png, dihedral_transform


@dataclass
class PairedImageDataset:
    """Clean / noisy image pairs with random crop + dihedral augmentation
    (fba_net/dataset.py DataLoaderTrain / DataLoaderVal)."""

    root: str | Path
    split: str = "train"  # train: random crop + augment; val/test: centre
    patch_size: int = 128  # 0 = full images
    gt_dir: str = "groundtruth"
    input_dir: str = "input"
    seed: int = 0

    pairs: list[tuple[Path, Path]] = field(init=False)

    def __post_init__(self) -> None:
        root = Path(self.root)
        gts = sorted((root / self.gt_dir).glob("*.png"))
        ins = sorted((root / self.input_dir).glob("*.png"))
        if len(gts) != len(ins) or not gts:
            raise ValueError(f"unpaired or empty dataset under {root}: "
                             f"{len(gts)} clean, {len(ins)} noisy images")
        self.pairs = list(zip(gts, ins))

    def __len__(self) -> int:
        return len(self.pairs)

    def load(self, index: int, rng: np.random.Generator | None = None) -> dict:
        """{'gt', 'input': f32 [h, w, 3] in [0, 1], 'name'}: the same draws
        from `rng`, in the same order, as the JAX package's."""
        rng = rng or np.random.default_rng(self.seed)
        gt_path, in_path = self.pairs[index]
        gt = decode_png(gt_path).astype(np.float32) / 255.0
        noisy = decode_png(in_path).astype(np.float32) / 255.0
        ps = self.patch_size
        if ps and gt.shape[0] >= ps and gt.shape[1] >= ps:
            if self.split == "train":
                r = int(rng.integers(0, gt.shape[0] - ps + 1))
                c = int(rng.integers(0, gt.shape[1] - ps + 1))
            else:
                r = (gt.shape[0] - ps) // 2
                c = (gt.shape[1] - ps) // 2
            gt = gt[r:r + ps, c:c + ps]
            noisy = noisy[r:r + ps, c:c + ps]
        if self.split == "train":
            t = int(rng.integers(0, 8))
            gt = dihedral_transform(gt, t)
            noisy = dihedral_transform(noisy, t)
        return {"gt": gt, "input": noisy, "name": gt_path.stem}


def generate_patches(src_dir: str | Path, dst_dir: str | Path, *,
                     patch_size: int = 256, patches_per_image: int = 8,
                     seed: int = 0, workers: int = 8) -> int:
    """Random `patch_size` patches of every PNG under `src_dir`, written to
    `dst_dir` as `<stem>_<k:02d>.png` (fba_net/generate_patches_SIDD.py);
    image i draws from `default_rng((seed, i))`. Returns the count
    written."""
    src, dst = Path(src_dir), Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    files = sorted(src.glob("*.png"))

    def one(args: tuple[int, Path]) -> int:
        idx, path = args
        rng = np.random.default_rng((seed, idx))
        img = decode_png(path)
        h, w = img.shape[:2]
        n = 0
        for k in range(patches_per_image):
            if h < patch_size or w < patch_size:
                break
            r = int(rng.integers(0, h - patch_size + 1))
            c = int(rng.integers(0, w - patch_size + 1))
            png.write_png(dst / f"{path.stem}_{k:02d}.png",
                          np.ascontiguousarray(
                              img[r:r + patch_size, c:c + patch_size]))
            n += 1
        return n

    with ThreadPoolExecutor(workers) as pool:
        return sum(pool.map(one, enumerate(files)))


def bundle_submission(result_dir: str | Path, out_dir: str | Path) -> Path:
    """Per-block results `{image:04d}_{block:02d}.png` -> one
    `{image:04d}.mat` per image holding `results`, a [1, blocks] cell array
    of the uint8 blocks (fba_net/utils/bundle_submissions.py, SIDD
    packaging). Written with scipy where it imports, else `utils/mat5.py`,
    which writes the same cells."""
    try:
        from scipy import io as sio

        savemat = sio.savemat
    except ImportError:
        from fbanet_tpu_torch.utils.mat5 import savemat

    result_dir, out_dir = Path(result_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    by_image: dict[str, list[Path]] = {}
    for f in sorted(result_dir.glob("*.png")):
        by_image.setdefault(f.stem.split("_")[0], []).append(f)
    for img_id, paths in sorted(by_image.items()):
        blocks = np.empty((1, len(paths)), dtype=object)
        for i, p in enumerate(sorted(paths)):
            blocks[0, i] = decode_png(p)
        savemat(out_dir / f"{img_id}.mat", {"results": blocks})
    return out_dir
