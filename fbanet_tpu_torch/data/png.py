"""A PNG codec on `zlib` and `struct` alone, for hosts that have neither cv2
nor PIL.

- `write_png` / `encode`: 8-bit RGB (`[H, W, 3]` uint8 in RGB order, as
  PIL's `Image.fromarray` takes it) and 16-bit 4-channel (`[H, W, 4]`
  uint16 in BGRA order, as `cv2.imwrite` takes it: the file holds RGBA),
  every row with filter type 0 (None).
- `decode` reads 8- and 16-bit RGB and RGBA, not interlaced, as
  `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns them: channels in
  BGR(A) order, 16-bit samples as native uint16. `decode_rgb` gives what
  `cv2.imread(path, cv2.IMREAD_COLOR)` followed by BGR -> RGB gives for
  8-bit files: `[H, W, 3]` uint8 RGB, alpha dropped.
- Row filters 0 (None), 1 (Sub) and 2 (Up) are undone with numpy, a whole
  block of rows at a time: Sub is a running sum along a row, Up a running
  sum down a run of Up rows, both modulo 256 per byte. Filters 3 (Average)
  and 4 (Paeth) depend on the reconstructed left neighbour non-linearly,
  one byte after another, and raise `OSError` naming the file, the row and
  the filter. cv2 writes filter 1 by default; PIL picks a filter per row
  and often Paeth.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> samples per pixel
_FILTERS = {0: "None", 1: "Sub", 2: "Up", 3: "Average", 4: "Paeth"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(arr: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of `arr`: uint8 [H, W, 3] RGB, or uint16 [H, W, 4] BGRA
    (cv2's order; the file stores RGBA). Filter 0 on every row."""
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError(f"expected [H, W, C], got {arr.shape}")
    h, w, c = arr.shape
    if arr.dtype == np.uint8 and c == 3:
        depth, colour, rows = 8, 2, arr
    elif arr.dtype == np.uint16 and c == 4:
        depth, colour = 16, 6
        rows = arr[..., [2, 1, 0, 3]].astype(">u2")
    else:
        raise ValueError(f"png.py writes uint8 RGB or uint16 4-channel "
                         f"images, got {arr.dtype} {arr.shape}")
    data = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    raw = np.zeros((h, data.shape[1] + 1), np.uint8)  # filter byte 0
    raw[:, 1:] = data
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, arr: np.ndarray, level: int = 6) -> None:
    """Write `arr` (see `encode`) to `path`."""
    Path(path).write_bytes(encode(arr, level))


def _chunks(blob: bytes, path):
    if blob[:8] != SIGNATURE:
        raise OSError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        if len(data) != n:
            raise OSError(f"{path}: truncated {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + n
    raise OSError(f"{path}: no IEND chunk")


def read_header(path: str | Path) -> tuple[int, int, int, int]:
    """(height, width, bit depth, colour type) from the IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise OSError(f"{path}: not a PNG file")
    w, h, depth, colour = struct.unpack(">IIBB", head[16:26])
    return h, w, depth, colour


def _unfilter(rows: np.ndarray, bpp: int, path) -> np.ndarray:
    """Undo the row filters of `rows` [H, 1 + stride] (filter byte first)."""
    kinds = rows[:, 0]
    data = rows[:, 1:].copy()
    h, stride = data.shape
    bad = np.flatnonzero(kinds > 2)
    if bad.size:
        r = int(bad[0])
        k = int(kinds[r])
        raise OSError(f"{path}: row {r} uses PNG filter {k} "
                      f"({_FILTERS.get(k, 'unknown')}), which png.py does "
                      f"not decode (it reads filters 0-2); decode this file "
                      f"with cv2 or PIL")
    sub = np.flatnonzero(kinds == 1)
    if sub.size:  # Sub: each byte adds the byte one pixel to its left
        block = data[sub].reshape(sub.size, stride // bpp, bpp)
        data[sub] = np.cumsum(block, axis=1, dtype=np.uint8).reshape(
            sub.size, stride)
    up = kinds == 2
    r = 0
    while r < h:  # Up: each byte adds the byte above; runs of Up rows
        if not up[r]:
            r += 1
            continue
        end = r
        while end < h and up[end]:
            end += 1
        run = np.cumsum(data[r:end], axis=0, dtype=np.uint8)
        if r:
            run += data[r - 1]
        data[r:end] = run
        r = end
    return data


def decode(path: str | Path) -> np.ndarray:
    """`[H, W, C]` as cv2's IMREAD_UNCHANGED gives it: uint8 or uint16,
    channels in BGR(A) order."""
    blob = Path(path).read_bytes()
    header, idat = None, []
    for kind, data in _chunks(blob, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise OSError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise OSError(f"{path}: png.py reads 8/16-bit RGB and RGBA "
                      f"without interlace; this file has bit depth "
                      f"{depth}, colour type {colour}, interlace {interlace}")
    c = _CHANNELS[colour]
    bpp = c * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise OSError(f"{path}: corrupt image data ({exc})") from exc
    if len(raw) != h * (w * bpp + 1):
        raise OSError(f"{path}: {len(raw)} bytes of image data, expected "
                      f"{h * (w * bpp + 1)}")
    data = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, -1), bpp, path)
    if depth == 16:
        img = data.view(">u2").astype(np.uint16).reshape(h, w, c)
    else:
        img = data.reshape(h, w, c)
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:c]])


def decode_rgb(path: str | Path) -> np.ndarray:
    """8-bit file -> `[H, W, 3]` uint8 RGB (cv2's IMREAD_COLOR, then
    BGR -> RGB): alpha dropped."""
    img = decode(path)
    if img.dtype != np.uint8:
        raise OSError(f"{path}: decode_rgb reads 8-bit files; this one is "
                      f"16-bit")
    return np.ascontiguousarray(img[..., 2::-1])
