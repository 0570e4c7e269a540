"""Minimal MAT-file (Level 5) writer/reader, the subset SIDD bundling needs
(a copy of fbanet_tpu/utils/mat5.py; pure numpy, so the port needs no
scipy for it).

The reference packages benchmark submissions as `.mat` files via
`scipy.io.savemat` (fba_net/utils/bundle_submissions.py:48-105: a
[1, blocks] object cell array of uint8 image blocks per file). This module
writes little-endian MAT 5.0 files holding numeric ndarrays and object
(cell) arrays of numeric ndarrays, column-major as MATLAB expects;
`savemat` output loads with `scipy.io.loadmat`, and `loadmat` reads these
files and scipy's uncompressed or zlib-compressed ones.

Format reference: "MAT-File Format" (MathWorks, public spec): 128-byte header
(116 text + 8 subsys + version 0x0100 + endian 'IM'), then tagged data
elements; each array is a miMATRIX element of [flags, dims, name, data],
cells nest full miMATRIX elements per cell.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# MAT5 data-element types (mi*) and array classes (mx*) used here
_MI_MATRIX = 14
_MI_FOR_DTYPE = {
    np.dtype("int8"): 1, np.dtype("uint8"): 2, np.dtype("int16"): 3,
    np.dtype("uint16"): 4, np.dtype("int32"): 5, np.dtype("uint32"): 6,
    np.dtype("float32"): 7, np.dtype("float64"): 9,
}
_MX_FOR_DTYPE = {
    np.dtype("float64"): 6, np.dtype("float32"): 7, np.dtype("int8"): 8,
    np.dtype("uint8"): 9, np.dtype("int16"): 10, np.dtype("uint16"): 11,
    np.dtype("int32"): 12, np.dtype("uint32"): 13,
}
_MX_CELL = 1
_DTYPE_FOR_MX = {v: k for k, v in _MX_FOR_DTYPE.items()}
_DTYPE_FOR_MI = {v: k for k, v in _MI_FOR_DTYPE.items()}


def _element(mi_type: int, data: bytes) -> bytes:
    """One full-format data element: 8-byte tag + payload padded to 8."""
    pad = (-len(data)) % 8
    return struct.pack("<II", mi_type, len(data)) + data + b"\0" * pad


def _matrix(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.ndim == 0:
        arr = arr.reshape(1, 1)
    elif arr.ndim == 1:  # MATLAB arrays are >= 2-D; row vector like scipy
        arr = arr.reshape(1, -1)
    dims = np.asarray(arr.shape, dtype="<i4").tobytes()
    if arr.dtype == object:
        cls = _MX_CELL
        payload = b"".join(_matrix("", np.asarray(c))
                           for c in arr.reshape(-1, order="F"))
    else:
        if arr.dtype not in _MX_FOR_DTYPE:
            raise TypeError(f"unsupported dtype for MAT5 write: {arr.dtype}")
        cls = _MX_FOR_DTYPE[arr.dtype]
        payload = _element(_MI_FOR_DTYPE[arr.dtype],
                           np.ascontiguousarray(arr).tobytes(order="F"))
    flags = struct.pack("<II", cls, 0)  # low byte of word 1 = array class
    body = (_element(6, flags)          # array flags: miUINT32 x2
            + _element(5, dims)         # dimensions: miINT32
            + _element(1, name.encode())  # name: miINT8
            + payload)
    return _element(_MI_MATRIX, body)


def savemat(path: str | Path, mdict: dict[str, np.ndarray]) -> None:
    """Write `{name: array}` as a MAT 5.0 file (numeric or object arrays)."""
    desc = b"MATLAB 5.0 MAT-file, written by fbanet_tpu_torch.utils.mat5"
    header = desc + b" " * (116 - len(desc)) + b"\0" * 8
    header += struct.pack("<H", 0x0100) + b"IM"
    with open(path, "wb") as f:
        f.write(header)
        for name, arr in mdict.items():
            f.write(_matrix(name, np.asarray(arr)))


def _read_tag(buf: bytes, off: int) -> tuple[int, bytes, int]:
    """Read one data element (handles the small-data packed format)."""
    (word1,) = struct.unpack_from("<I", buf, off)
    if word1 >> 16:  # small data element: size in the upper 16 bits
        nbytes, mi = word1 >> 16, word1 & 0xFFFF
        return mi, buf[off + 4:off + 4 + nbytes], off + 8
    (nbytes,) = struct.unpack_from("<I", buf, off + 4)
    data = buf[off + 8:off + 8 + nbytes]
    return word1, data, off + 8 + nbytes + ((-nbytes) % 8)


def _parse_matrix(data: bytes) -> tuple[str, np.ndarray]:
    off = 0
    _, flags, off = _read_tag(data, off)
    cls = struct.unpack_from("<I", flags, 0)[0] & 0xFF
    _, dims_b, off = _read_tag(data, off)
    dims = tuple(np.frombuffer(dims_b, "<i4").tolist())
    _, name_b, off = _read_tag(data, off)
    name = name_b.rstrip(b"\0").decode()
    if cls == _MX_CELL:
        cells = []
        while off < len(data):
            mi, sub, off = _read_tag(data, off)
            assert mi == _MI_MATRIX, f"unexpected element {mi} in cell array"
            cells.append(_parse_matrix(sub)[1])
        arr = np.empty(len(cells), dtype=object)
        for i, c in enumerate(cells):
            arr[i] = c
        return name, arr.reshape(dims, order="F")
    if cls not in _DTYPE_FOR_MX:
        raise TypeError(f"unsupported MAT5 array class: {cls}")
    mi, raw, off = _read_tag(data, off)
    stored = np.frombuffer(raw, _DTYPE_FOR_MI[mi].newbyteorder("<"))
    # writers may compress (store a smaller int type); cast to the class dtype
    arr = stored.astype(_DTYPE_FOR_MX[cls]).reshape(dims, order="F")
    return name, arr


def loadmat(path: str | Path) -> dict[str, np.ndarray]:
    """Read a MAT 5.0 file written by `savemat` (or scipy, uncompressed)."""
    buf = Path(path).read_bytes()
    version, endian = struct.unpack_from("<H2s", buf, 124)
    if endian != b"IM":
        raise ValueError(f"not a little-endian MAT5 file: {endian!r}")
    out: dict[str, np.ndarray] = {}
    off = 128
    while off < len(buf):
        mi, data, off = _read_tag(buf, off)
        if mi == 15:  # miCOMPRESSED (scipy default do_compression=False skips)
            import zlib

            sub = zlib.decompress(data)
            mi2, inner, _ = _read_tag(sub, 0)
            assert mi2 == _MI_MATRIX
            name, arr = _parse_matrix(inner)
        elif mi == _MI_MATRIX:
            name, arr = _parse_matrix(data)
        else:
            continue  # skip non-matrix top-level elements
        out[name] = arr
    return out
