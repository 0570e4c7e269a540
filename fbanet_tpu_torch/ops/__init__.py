"""The port's operators: the two CUDA kernels of the inference path
(`attention`, `leff`), the FAF gate and translation ECC registration."""
