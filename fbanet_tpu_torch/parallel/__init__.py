"""Data parallelism over ranks (counterpart of fbanet_tpu/parallel/):
`mesh.py`'s `World` and `init`."""
