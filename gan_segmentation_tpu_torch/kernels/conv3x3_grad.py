"""The decoder's train-mode 3x3 conv with its gradients, over the kernels.

``Conv3x3.apply(x, w, b)``: x NHWC, w HWIO in x's dtype, b (Cout,) f32 or
None; stride 1, pad 1; BN and the activation follow it outside.

- Forward: ``conv3x3_bil`` (kernel 3) when (B, Cin, Cout) is inside its
  contract, else ``conv3x3_small`` (kernel 2).
- dX, only when x needs a gradient: the same 3x3 conv of dY with the kernel
  flipped in space and its channel axes swapped (``w[::-1, ::-1]
  .swapaxes(2, 3)``, Cout -> Cin), dispatched the same way; the contract
  is symmetric in Cin and Cout.
- dW and db stay plain PyTorch (``torch.nn.grad.conv2d_weight``, cuDNN on
  the card, and ``dY.sum``).  No Pallas kernel computed them: the JAX
  package let XLA differentiate its convs, so there is no TPU kernel to
  port; a hand-written wgrad kernel is later work.

"""

import torch

from .bil_conv import conv3x3_bil, fits
from .small_conv import conv3x3_small


def conv3x3(x, w, b=None):
    """conv3x3(x, w) [+ b] through kernel 3 where it fits, else kernel 2."""
    n, cin, cout = x.shape[0], x.shape[3], w.shape[3]
    if fits(n, cin, cout):
        return conv3x3_bil(x, w, b)
    return conv3x3_small(x, w, b)


class Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b=None):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.b_dtype = None if b is None else b.dtype
        return conv3x3(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w_t = w.flip(0, 1).transpose(2, 3).contiguous()
            dx = conv3x3(dy, w_t)
        if ctx.needs_input_grad[1]:
            cin, cout = w.shape[2], w.shape[3]
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (cout, cin, 3, 3),
                dy.permute(0, 3, 1, 2), padding=1)
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)  # OIHW -> HWIO
        if ctx.needs_input_grad[2]:
            acc = torch.promote_types(dy.dtype, torch.float32)
            db = dy.sum(dim=(0, 1, 2), dtype=acc).to(ctx.b_dtype)
        return dx, dw, db
