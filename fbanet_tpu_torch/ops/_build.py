"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources in `fbanet_tpu_torch/csrc/*.cu` compile with nvcc for `sm_90a`,
one process per source in parallel, into one shared library with a plain C
interface. The build happens at first use, into
`build/fbanet_tpu_torch/<hash>/` at the repository root (listed in
`.gitignore`), keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads in milliseconds. Nothing here runs at
import: the CPU tests import every module on a machine without nvcc.

Every C entry point takes device pointers and the CUDA stream as
`c_void_p`, ints as `c_int` and floats as `c_float`, launches on that stream
without synchronising, and returns `cudaGetLastError()` as an int; `check`
turns a non-zero return into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "fbanet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> argtypes (every function returns int, a cudaError_t)
SIGNATURES = {
    # x, out, ln_s, ln_b, wq, bq, wkv, bkv, wproj, bproj, bias, mask,
    # B, H, W, C, heads, ws, residual, bf16, stream
    "fbanet_window_attention": [_P] * 12 + [_I] * 8 + [_P],
    # K1b: the same pointers, then G, tokens per window, C, heads, mask
    # windows, bf16, stream; K9: the same pointers (mask ignored), then B, H,
    # W, C, heads, ws, variant, stream
    "fbanet_window_attention_windows": [_P] * 12 + [_I] * 6 + [_P],
    "fbanet_window_attention_ablation": [_P] * 12 + [_I] * 7 + [_P],
    # x, out, ln_s, ln_b, w1, b1, wdw, bdw, w2, b2,
    # B, H, W, C, Ch, residual, bf16, stream
    "fbanet_leff": [_P] * 10 + [_I] * 7 + [_P],
    # K10: the same pointers, then B, H, W, C, Ch, variant, stream
    "fbanet_leff_ablation": [_P] * 10 + [_I] * 6 + [_P],
    # dynamic shared-memory bytes of one block, 0 for a shape the kernel
    # does not take (host functions): (tokens per window, C, heads, bf16)
    # and (C, Ch, bf16)
    "fbanet_window_attention_smem": [_I, _I, _I, _I],
    "fbanet_leff_smem": [_I, _I, _I],
    # K7: x, out, ln_s, ln_b, wq, bq, wkv, bkv, wproj, bproj, bias,
    # B, H, W, C, heads, ws, core, qkv1, windows per block, stream; its
    # shared memory and heads per stage, 0 for a shape it does not take:
    # (tokens per window, C, heads, core)
    "fbanet_attention_variant": [_P] * 11 + [_I] * 9 + [_P],
    "fbanet_attention_variant_smem": [_I] * 4,
    "fbanet_attention_variant_chunk": [_I] * 4,
    # K8: K2's pointers, then B, H, W, C, Ch, variant, stream
    "fbanet_leff_variant": [_P] * 10 + [_I] * 6 + [_P],
    # K3: x, g, dx, y/o/dq/dkv scratch, partial sums, ln_s, ln_b, wq, bq,
    # wkv, bkv, wproj, bias, mask, B, H, W, C, heads, ws, residual, bf16,
    # stream; and its head-group width, 0 for a shape it does not take:
    # (tokens per window, C, heads, bf16, stages skipped)
    "fbanet_window_attention_bwd": [_P] * 17 + [_I] * 8 + [_P],
    "fbanet_window_attention_bwd_group": [_I] * 5,
    # K3 on windows: the same pointers, then G, tokens per window, C, heads,
    # mask windows, bf16, stream; K11: the same pointers (mask ignored),
    # then G, tokens per window, C, heads, stages skipped, stream
    "fbanet_window_attention_bwd_windows": [_P] * 17 + [_I] * 6 + [_P],
    "fbanet_window_attention_bwd_ablation": [_P] * 17 + [_I] * 5 + [_P],
    # K4: x, g, dx, y/h2/dz1 scratch, partial sums, dy partials, ln_s,
    # ln_b, w1, b1, wdw, bdw, w2, w2^T, B, H, W, C, Ch, residual, bf16, and
    # the plan: tile rows, tile columns (0: the WMMA form), hidden chunk,
    # splits; stream. The WMMA form's hidden chunk, 0 for a shape it does
    # not take: (C, Ch, bf16); the wgmma form's shared memory, 0 for a plan
    # it does not take: (C, tile rows, tile columns, chunk)
    "fbanet_leff_bwd": [_P] * 16 + [_I] * 11 + [_P],
    "fbanet_leff_bwd_chunk": [_I, _I, _I],
    "fbanet_leff_bwd_smem": [_I] * 4,
    # the backward kernels' fixed-order sums: a, b, slice partials, out,
    # grid-barrier words, T, M, N, tokens per slice, tile_m, tile_n, bf16,
    # stream; and p, slice partials, out, band counters, R, M, rows per
    # slice, stream
    "fbanet_token_matmul": [_P] * 5 + [_I] * 7 + [_P],
    "fbanet_column_sum": [_P] * 4 + [_I] * 3 + [_P],
    # K5, K6: frames, matrices [F, 3, 3] or coords [F, H, W, 2], out,
    # F, H, W, C, constant mode, cval, stream
    "fbanet_warp_homography": [_P] * 3 + [_I] * 5 + [ctypes.c_float, _P],
    "fbanet_warp_coords": [_P] * 3 + [_I] * 5 + [ctypes.c_float, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of fbanet_tpu_torch cannot be built")


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. Each source compiles in its own nvcc process, all
    started together, then one nvcc links the objects. Raises with nvcc's
    output when a step fails."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _source_hash(sources)
    lib = out_dir / "libfbanet_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    t0 = time.perf_counter()
    for src in (s for s in sources if s.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [_nvcc(), *compile_flags, "-Xptxas", "-v", "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))

    def finish(job):
        out, _ = job[2].communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        done = list(pool.map(finish, jobs))
    log, failed = [], []
    for (cmd, _obj, proc), (out, seconds) in zip(jobs, done):
        log.append(f"{' '.join(cmd)}\n({seconds:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
    tmp = out_dir / f"libfbanet_kernels.{pid}.so"
    if not failed:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(obj) for _c, obj, _p in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}"
                          f"{proc.stderr}")
    (out_dir / "build.log").write_text("\n".join(log))
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp.replace(lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fbanet_error_string.argtypes = [ctypes.c_int]
    lib.fbanet_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        name = library().fbanet_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
