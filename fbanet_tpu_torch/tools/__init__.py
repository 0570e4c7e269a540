"""Kernel-measurement tools: the counterparts of the JAX package's
`scripts/measure_swin_rates.py` (`measure_swin_rates`: K1/K2 rates and the
K9/K10 ablation kernels) and `scripts/measure_bwd.py` (`measure_bwd`: the
backward rates and the K11 ablation kernel). Run each as a module, e.g.
`python -m fbanet_tpu_torch.tools.measure_swin_rates attn leff ablate`."""
