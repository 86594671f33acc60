"""Dropout with its bits drawn from an explicit ``torch.Generator``."""

import torch

DROPOUT_RATE = 0.5


def dropout(x, generator: torch.Generator, rate: float = DROPOUT_RATE):
    """The JAX package's ``Dropout``: keep where uniform < 1 - rate, scaled
    by 1 / (1 - rate).  The bits come from ``generator`` (PyTorch's stream,
    not JAX's)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
