"""fbanet_tpu_torch — FBANet burst super-resolution in PyTorch for NVIDIA Hopper.

The PyTorch + CUDA counterpart of `fbanet_tpu`, module for module. The JAX
package stays the reference: every module here is tested against its JAX
counterpart (tests/test_torch_*.py), and the fused Pallas kernels of the
serving and training paths (the attention and LeFF forwards and their
backwards) are hand-written CUDA C++ kernels for `sm_90a` here
(`ops/attention.py`, `ops/leff.py`, sources in `csrc/`).

Layouts follow the JAX package at the public functions: bursts
`[B, F, H, W, 3]` in, `[B, 4H, 4W, 3]` out, the Swin stream `[B, H, W, C]`.
Parameters use torch layouts under the names `fbanet_tpu.utils.torch_io`
produces, so a converted JAX checkpoint loads with `strict=True`.

This package imports torch and numpy only, and nothing of `fbanet_tpu`: it
keeps its own copy of the configuration (`config.py`).
"""

__version__ = "0.1.0"
