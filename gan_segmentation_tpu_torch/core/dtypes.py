"""Dtype policy and the device of the main path.

As in the JAX package (``gan_segmentation_tpu/core/dtypes.py``): parameters
stay float32, activations are computed in the policy's compute dtype
(bfloat16 by default), and normalization statistics are always float32.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # dtype of reductions (norm statistics, losses, metrics)
    reduce_dtype: torch.dtype = torch.float32


def default_policy(dtype: str = "bf16") -> DTypePolicy:
    """'fp32' -> all f32; 'bf16' -> f32 params, bf16 compute; 'fp16' -> f32
    params, f16 compute."""
    if dtype in ("fp32", "float32"):
        return DTypePolicy(compute_dtype=torch.float32)
    if dtype in ("bf16", "bfloat16"):
        return DTypePolicy(compute_dtype=torch.bfloat16)
    if dtype in ("fp16", "float16"):
        return DTypePolicy(compute_dtype=torch.float16)
    raise ValueError(f"unknown dtype policy: {dtype}")


def cuda_device() -> torch.device:
    """The one device the main path runs on.  Raises without a CUDA card:
    the port has no CPU fallback for its entry points."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: gan_segmentation_tpu_torch runs "
                           "its entry points on an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())
