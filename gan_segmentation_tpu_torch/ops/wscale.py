"""Runtime weight scaling ("wscale" / equalized learning rate).

Stored weights are unit scale; the forward pass multiplies them by
``gain / sqrt(fan_in)`` and by ``lr_mult`` (`networks_stylegan.py:399-404`).
Shapes are given in the JAX package's layout (HWIO or (in, out)), so the
two packages share one definition of fan-in.  A transposed conv counts its
INPUT channels (`networks_stylegan.py:400-402`).
"""

import math


def he_fan_in(shape_hwio) -> int:
    """fan_in = kh*kw*Cin for conv HWIO, or in_features for dense (in, out)."""
    if len(shape_hwio) == 4:
        kh, kw, cin, _ = shape_hwio
        return kh * kw * cin
    if len(shape_hwio) == 2:
        return shape_hwio[0]
    raise ValueError(f"unsupported weight shape {shape_hwio}")


def wscale_std(shape_hwio, gain: float = math.sqrt(2), fan_in=None) -> float:
    if fan_in is None:
        fan_in = he_fan_in(shape_hwio)
    return float(gain / math.sqrt(fan_in))
