"""PyTorch / CUDA port of the int8 CapsNet system in `repro`.

Same subpackage and module names as `repro` where a counterpart exists;
imports torch and NumPy, never JAX or anything of `repro`.  Entry points
run on CUDA unless the caller passes `device="cpu"`.
"""
