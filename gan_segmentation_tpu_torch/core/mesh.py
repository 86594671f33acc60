"""The devices of a run (PyTorch counterpart of
``gan_segmentation_tpu/core/mesh.py``).  The JAX package builds a ``Mesh``;
the port's data parallelism is a list of devices: one process per card for
training (``core/distributed.py``), and one replica of the generate program
per card inside one process for ``generate --dp``.

- ``kvstore_devices``: the reference's ``--kvstore`` / ``--gpus`` /
  ``--ngpus`` / ``--no-cuda`` flags -> the cards of a training run
  (``kvstore_to_mesh``).
- ``generate_devices``: ``generate --spatial N --dp D`` -> the cards of one
  generating process, or None for one device (``spatial_mesh``): a list of
  cards (``--dp``), or with N > 1 the ``(data, space)`` grid, a list of D
  rows of N cards each, whose rows split each image's height into bands
  (``core/spatial.py``).
"""

from typing import List, Optional, Sequence, Union

import torch

def kvstore_devices(kvstore: str = "device", gpus: str = "",
                    ngpus: Optional[int] = None,
                    no_cuda: bool = False) -> List[torch.device]:
    """The devices of a training run, one process each.  ``--no-cuda`` or
    ``--kvstore local`` gives one device (the reference forces ``local`` on
    the CPU); ``--gpus a,b,...`` lists cards, ``--ngpus N`` takes the first
    N, and neither takes every card.  No card without ``--no-cuda`` raises,
    and so does a listed card the machine does not have."""
    if no_cuda:
        return [torch.device("cpu")]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device: gan_segmentation_tpu_torch runs "
                           "its entry points on an NVIDIA GPU; pass "
                           "--no-cuda to run on the CPU")
    if gpus and gpus.strip():
        ids = [int(i) for i in gpus.split(",") if i.strip()]
    elif ngpus is not None:
        if ngpus < 1:
            raise ValueError(f"--ngpus {ngpus}: needs at least one card")
        ids = list(range(min(ngpus, count)))
    else:
        ids = list(range(count))
    bad = [i for i in ids if not 0 <= i < count]
    if bad:
        raise ValueError(f"--gpus {gpus}: this machine has {count} CUDA "
                         f"device(s)")
    if kvstore == "local":
        ids = ids[:1]
    return [torch.device("cuda", i) for i in ids]


def generate_devices(spatial: int = 1, dp: Optional[int] = None,
                     devices: Optional[Sequence[torch.device]] = None
                     ) -> Union[None, List[torch.device],
                                List[List[torch.device]]]:
    """The cards of one generating process, by the JAX package's
    ``spatial_mesh`` rules, rule by rule:

    - ``spatial <= 1`` and ``dp`` None or 1: None (one device);
    - ``spatial > 1``, ``dp`` None: every card, in ``ndev / N`` rows of N
      (``ValueError`` unless N divides the card count);
    - ``dp == 0``: ``ndev // N`` rows (``--dp 0`` alone: every card);
    - an explicit ``dp``: the first ``dp * N`` cards; a grid larger than
      the cards, or ``dp < 1``, raises ``ValueError``.

    With N = 1 the result is today's ``--dp`` list of cards (one graphed
    replica each); with N > 1 it is the ``(data, space)`` grid as a list of
    ``dp`` rows of N cards.  ``devices`` defaults to every CUDA card; a
    grid may repeat a device (the tests' CPU grids, or one card)."""
    if spatial <= 1 and (dp is None or dp == 1):
        return None
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if dp is None:
        if len(devices) % spatial:
            raise ValueError(f"--spatial {spatial} must divide the device "
                             f"count ({len(devices)})")
        dp = len(devices) // spatial
    elif dp == 0:
        dp = len(devices) // max(1, spatial)
        if spatial <= 1:
            dp = max(dp, 1)  # no card at all: one device, as on one card
    spatial = max(1, spatial)
    if dp == 1 and spatial == 1:
        return None  # e.g. --dp 0 on a single-device host
    if dp < 1 or dp * spatial > len(devices):
        raise ValueError(f"--dp {dp} x --spatial {spatial} needs "
                         f"{dp * spatial} devices, but only {len(devices)} "
                         f"are available")
    if spatial == 1:
        return devices[:dp]
    return [devices[r * spatial:(r + 1) * spatial] for r in range(dp)]
