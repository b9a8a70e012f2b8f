"""PyTorch/CUDA port of `nvsr_tpu` for one NVIDIA H100.

The JAX package `nvsr_tpu` stays the reference; every module here keeps
its counterpart's module name and is held against it by the
`tests/test_torch_*.py` suite. This package imports `torch` and never
`jax` or `nvsr_tpu` (importing `nvsr_tpu` imports JAX).

Ported so far: the eval render of a super-resolved scene
(`render.render_image` with triplane point functions, EDSR plane SR), with
the TPU gather+decode megakernel as the hand-written Hopper kernel
`csrc/triplane_render.cu` (host side in `ops/fused_render.py`); and the
TrainModels training step (`train.train_step`, its optimizers, the
plane-SR backward with remat), with the trainable plane sampler's forward
and backward as the Hopper kernels `csrc/plane_sample.cu` (host side in
`ops/plane_sample.py`); bicubic planes, the tiled points entry and the
standalone decoder and row gather; and the Experiment's eval half
(`experiment.Experiment`, `cli.py`, with copies of the JAX package's
host modules in `utils/`, `data/` and `scenes.py`), which loads a logdir
that the JAX package wrote and evaluates it through those kernels; its
training half; and the rest of what the JAX package does on one device:
the Mip-NeRF / PE-NeRF baseline (`ops/encoding.py`,
`models/nerf_mlp.py`, the mip render, and `train.train_step_baseline`,
whose MLPs train through the planes model's step body),
reference-checkpoint conversion (`convert.py`), SRResNet and tiled EDSR;
and data- and tensor-parallel training and eval across ranks on
torch.distributed (`parallel/`: the ('data', 'model') mesh, the row
split, the bucketed reductions, the decoders' and the plane SR's
tensor-parallel layouts with the model group's collectives in autograd,
the crc32 scene-owner plane pool and the device-resident scene pool, and
a multi-rank dry run), which the Experiment and `cli.py` take under
`experiment.data_parallel`, `experiment.model_parallel`,
`nerf.train.store_planes.device_pool` and torchrun.
"""
