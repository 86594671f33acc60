"""gan_segmentation_tpu_torch — the PyTorch / CUDA port of
``gan_segmentation_tpu`` for one NVIDIA H100.

It imports torch and never the JAX stack; the JAX package stays the reference
that the tests hold every ported module to.  Ported so far: the ``generate``
path (z -> 8-layer mapping -> synthesis blocks -> segmentation decoder ->
class mask -> uint8 image and bit-packed mask -> host writer), and decoder
``train`` and ``evaluate`` on the annotated collection.

Subpackages mirror the JAX package's module names:

core     configs, dtype policy and device, JAX-parameter bridge
ops      plain PyTorch ops on NHWC tensors (conv, blur, norm, resize, wscale,
         losses)
kernels  hand-written CUDA kernels (``csrc/``) with their plain versions, and
         the train-mode conv with its gradients
models   StyleGAN generator, segmentation decoder (eval and train mode)
data     the annotated collection (feature pyramid, image, trimap mask)
metrics  pixel accuracy and mean IoU of ``evaluate``
train    SegSolver (fit, evaluate, predict, checkpoints), ImageGenerator,
         FusedPipeline
apps     ``python -m gan_segmentation_tpu_torch.apps.main
         train|evaluate|generate``
utils    file listing
"""

__version__ = "0.1.0"
