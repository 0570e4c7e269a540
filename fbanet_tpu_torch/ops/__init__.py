"""The port's operators: the attention and LeFF kernels with their
backwards (`attention`, `leff`, `reduce`), the FAF gate, warping (`warp`,
with the K5/K6 kernels in `warp_kernels`), ECC registration and optical
flow."""
