"""PyTorch + CUDA port of the niagara_tpu meshlet renderer.

The JAX package `niagara_tpu` is the reference; this package renders the
same frames from the same cooked scene on an NVIDIA Hopper GPU.  It imports
`torch`, numpy and the standard library, and nothing of `jax`, `ml_dtypes`
or `niagara_tpu`: what it needs of the reference's JAX-free host modules it
keeps as its own copy (`config.py`, `utils/`, the C++ cooker in
`cooker/native/` with its ctypes binding), and every other host module has
a mirror here, held equal to its original by tests/test_torch_*.py
(tests/test_torch_imports.py enforces the import rule).

Layout mirrors the JAX package so each counterpart is found by name:
`scene.py`, `cooker/`, `ops/`, `render/`; the hand-written CUDA kernels
(setup and tile raster, each with an alpha variant, and shade) live in
`csrc/` and are built by `_build.py`.
"""
