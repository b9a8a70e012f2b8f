"""PyTorch/CUDA port of `nvsr_tpu` for one NVIDIA H100.

The JAX package `nvsr_tpu` stays the reference; every module here keeps
its counterpart's module name and is held against it by the
`tests/test_torch_*.py` suite. This package imports `torch` and never
`jax` or `nvsr_tpu` (importing `nvsr_tpu` imports JAX).

Ported so far: the eval render of a super-resolved scene
(`render.render_image` with triplane point functions, EDSR plane SR), and
the TPU gather+decode megakernel as the hand-written Hopper kernel
`csrc/triplane_render.cu` (host side in `ops/fused_render.py`).
"""
