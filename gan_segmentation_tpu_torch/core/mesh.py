"""The devices of a run (PyTorch counterpart of
``gan_segmentation_tpu/core/mesh.py``).  The JAX package builds a ``Mesh``;
the port's data parallelism is a list of devices: one process per card for
training (``core/distributed.py``), and one replica of the generate program
per card inside one process for ``generate --dp``.

- ``kvstore_devices``: the reference's ``--kvstore`` / ``--gpus`` /
  ``--ngpus`` / ``--no-cuda`` flags -> the cards of a training run
  (``kvstore_to_mesh``).
- ``generate_devices``: ``generate --spatial N --dp D`` -> the cards of one
  generating process, or None for one device (``spatial_mesh``).  Spatial
  (image-height) sharding is not ported.
"""

from typing import List, Optional, Sequence

import torch

SPATIAL_NOT_PORTED = ("--spatial > 1 (image-height sharding over several "
                      "cards) is not ported: ROADMAP.md, Queue 1, item 4 "
                      "keeps it queued until one 80 GB card is shown to "
                      "need it")


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
                     ) -> Optional[List[torch.device]]:
    """The cards over which one process splits each generate batch, or
    None for one device.  ``dp`` None or 1: one device; ``0``: every card
    (None when that is one); ``D``: the first D cards.  ``spatial > 1``
    raises ``NotImplementedError``; a ``dp`` beyond the cards, or below 0,
    ``ValueError``."""
    if spatial > 1:
        raise NotImplementedError(SPATIAL_NOT_PORTED)
    if dp is None or dp == 1:
        return None
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if dp == 0:
        dp = len(devices)
        if dp <= 1:
            return None
    if dp < 1 or dp > len(devices):
        raise ValueError(f"--dp {dp} needs {dp} devices, but only "
                         f"{len(devices)} are available")
    return devices[:dp]
