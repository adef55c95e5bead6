"""Device choice for the port's entry points.

``PandaDB`` and ``IVFIndex.build`` run on the CUDA card unless the caller
names another device, and ``QueryServer`` runs on its db's device.  With no
device named and no card present they raise: nothing drops to the CPU on its
own."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    CUDA card.  Float32 products stay float32 on the card (no TF32): TF32
    changes scores, and changed scores change ids."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

