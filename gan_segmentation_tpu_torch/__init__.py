"""gan_segmentation_tpu_torch — the PyTorch / CUDA port of
``gan_segmentation_tpu`` for one NVIDIA H100.

It imports torch and never the JAX stack; the JAX package stays the reference
that the tests hold every ported module to.  Ported so far: the ``generate``
path (z -> 8-layer mapping -> synthesis blocks -> segmentation decoder ->
class mask -> uint8 image and bit-packed mask -> host writer).

Subpackages mirror the JAX package's module names:

core     configs, dtype policy and device, JAX-parameter bridge
ops      plain PyTorch ops on NHWC tensors (conv, blur, norm, resize, wscale)
kernels  hand-written CUDA kernels (``csrc/``) with their plain versions
models   StyleGAN generator, segmentation decoder
train    SegSolver (checkpoints, prediction), ImageGenerator, FusedPipeline
apps     ``python -m gan_segmentation_tpu_torch.apps.main generate``
"""

__version__ = "0.1.0"
