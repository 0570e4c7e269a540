"""The port's ctypes binding of the repo's native burst-IO core
(`native/burstio.cc`; counterpart of fbanet_tpu/data/native_io.py): a
persistent std::thread pool that decodes PNG files with libpng straight
into contiguous burst buffers, outside the GIL, and a gather + crop +
dihedral + /255 pass over a decoded uint8 cache.

The library is compiled from the checkout's source at first use,

    g++ -O3 -fPIC -std=c++17 -shared native/burstio.cc -lpng -lz -lpthread

into `build/burstio/<hash of the source>/libburstio.so` (gitignored). A
prebuilt `native/libburstio.so` is never loaded: it may come from another
machine. Where g++ or libpng is missing the library is unavailable,
`available()` is False and `unavailable_reason()` says why; the dataset
then decodes per file (cv2, PIL or `png.py`) and names the decoder it used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "burstio.cc"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_pool: ctypes.c_void_p | None = None
_unavailable_reason: str | None = None


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return _ROOT / "build" / "burstio" / digest / "libburstio.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run(
        ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp),
         str(_SOURCE), "-lpng", "-lz", "-lpthread"],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        first = (proc.stderr.strip().splitlines() or ["no output"])[0]
        raise OSError(f"g++ exited {proc.returncode}: {first}")
    tmp.replace(out)  # atomic: concurrent compiles each rename a whole file


def ensure_built() -> bool:
    """Build (if needed) and load the library. Returns availability."""
    global _lib, _unavailable_reason
    with _lock:
        if _lib is not None:
            return True
        if _unavailable_reason is not None:
            return False
        try:
            path = library_path()
            if not path.exists():
                _compile(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:  # a build from another host: build it here
                _compile(path)
                lib = ctypes.CDLL(str(path))
            lib.burstio_version.restype = ctypes.c_int
            lib.burstio_pool_create.restype = ctypes.c_void_p
            lib.burstio_pool_create.argtypes = [ctypes.c_int]
            lib.burstio_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.burstio_decode_files.restype = ctypes.c_int
            lib.burstio_decode_files.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.burstio_decode_files_f32.restype = ctypes.c_int
            lib.burstio_decode_files_f32.argtypes = (
                lib.burstio_decode_files.argtypes)
            lib.burstio_transform_f32.restype = ctypes.c_int
            lib.burstio_transform_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            if lib.burstio_version() < 11:
                raise OSError(f"burstio version {lib.burstio_version()} < 11")
            _lib = lib
            return True
        except Exception as exc:  # no toolchain or libpng: decode per file
            _unavailable_reason = f"{type(exc).__name__}: {exc}"
            return False


def available() -> bool:
    return ensure_built()


def unavailable_reason() -> str | None:
    """Why the library could not be built or loaded (None if it was, or if
    nobody has asked yet)."""
    return _unavailable_reason


def _get_pool(threads: int = 16) -> ctypes.c_void_p:
    global _pool
    with _lock:
        if _pool is None:
            _pool = ctypes.c_void_p(_lib.burstio_pool_create(threads))
    return _pool


def _require() -> None:
    if not ensure_built():
        raise RuntimeError(f"native burstio unavailable: {_unavailable_reason}")


def decode_files(paths: list[str | Path], height: int, width: int,
                 *, channels: int = 3, as_float: bool = True) -> np.ndarray:
    """Decode `paths` in parallel into one [N, H, W, C] array: float32 in
    [0, 1] (`x * (1.0f / 255.0f)`) with `as_float`, else uint8. Every image
    must be (height, width); raises OSError on a mismatch or a corrupt
    file."""
    _require()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    pool = _get_pool()
    dtype = np.float32 if as_float else np.uint8
    out = np.empty((n, height, width, channels), dtype)
    fn = _lib.burstio_decode_files_f32 if as_float else _lib.burstio_decode_files
    rc = fn(pool, n, c_paths, out.ctypes.data_as(ctypes.c_void_p), height,
            width, channels)
    if rc != 0:
        idx, code = divmod(rc, 100)
        raise OSError(f"burstio decode failed (file #{idx}, code {code}): "
                      f"{paths[min(idx, n - 1)]}")
    return out


def transform_f32(src: np.ndarray, sel: list[int], r0: int, c0: int, cs: int,
                  dihedral: int) -> np.ndarray:
    """Gather + crop + dihedral + /255 of a decoded uint8 cache in one
    native pass: src [N, H, W, C] uint8 (C-contiguous) -> [len(sel), cs, cs,
    C] float32, the window at (r0, c0), then the transform numbered as
    `realbsr.dihedral_transform`."""
    _require()
    if src.dtype != np.uint8 or src.ndim != 4 or not src.flags.c_contiguous:
        raise ValueError(f"transform_f32 takes a C-contiguous uint8 [N, H, W, "
                         f"C] array, got {src.dtype} {src.shape}")
    n_src, h, w, c = src.shape
    n_sel = len(sel)
    c_sel = (ctypes.c_int * n_sel)(*[int(s) for s in sel])
    out = np.empty((n_sel, cs, cs, c), np.float32)
    rc = _lib.burstio_transform_f32(
        _get_pool(), src.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), c_sel, n_sel, n_src, h, w, c,
        r0, c0, cs, dihedral)
    if rc != 0:
        raise OSError(f"burstio transform failed (code {rc}): "
                      f"crop ({r0},{c0})+{cs} of {src.shape}, t={dihedral}")
    return out
