"""The benchmark of `repro_torch`, the PyTorch and CUDA port: one cell
(a CapsNet configuration under one traffic mix) a run, driven by data.

`run.py` is the command; `BENCHMARK.json` at the root of the checkout
names the cells and metrics, and each of them is a file of its own here:
`configs/<config>.json`, `workloads/<cell>.json`, `metrics/<metric>.py`.
Nothing in this package imports `jax` or the JAX package `repro`.
"""
