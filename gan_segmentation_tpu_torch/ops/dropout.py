"""Dropout with its bits drawn from an explicit ``torch.Generator``, or
given as a uniform draw made before (a CUDA graph's static input)."""

from typing import Optional

import torch

DROPOUT_RATE = 0.5


def dropout(x, generator: Optional[torch.Generator] = None,
            rate: float = DROPOUT_RATE, uniform=None):
    """The JAX package's ``Dropout``: keep where uniform < 1 - rate, scaled
    by 1 / (1 - rate).  The uniform draw is ``uniform`` (f32, x's shape)
    when given, else drawn from ``generator`` (PyTorch's stream, not
    JAX's): ``torch.rand`` of x's shape, the same bits either way."""
    keep_prob = 1.0 - rate
    if uniform is None:
        uniform = torch.rand(x.shape, generator=generator, device=x.device)
    keep = uniform < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
