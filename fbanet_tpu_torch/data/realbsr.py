"""The RealBSR filename grammar and PNG decoding (the numpy-only part of
fbanet_tpu/data/realbsr.py:33-52 that the alignment CLI needs).

The dataset class, sharding, cropping and augmentation are not ported yet.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

# The DALI-tree grammar (reference: fba_net/pipeline/real_bsr_dataset.py:40-55).
WARP_PATTERN = re.compile(
    r"^(?P<scene>\d{3})_MFSR_Sony_(?P<patch>\d{4})_x(?P<scale>\d)"
    r"(?:_(?P<frame>\d{2})|warp)\.png$"
)


def decode_png(path: Path) -> np.ndarray:
    """PNG -> uint8 HWC RGB, through cv2 where it is installed (C++, releases
    the GIL), else PIL."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise OSError(f"failed to decode {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
