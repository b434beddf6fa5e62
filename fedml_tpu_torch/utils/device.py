"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else raise.

    The port never carries on quietly on the CPU; a caller that wants the
    CPU (the tests) asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fedml_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def driver_device(device: DeviceLike, *bundles) -> torch.device:
    """``resolve_device(device)``, on which every model bundle of a driver
    must keep its variables."""
    dev = resolve_device(device)
    for b in bundles:
        if b.device != dev:
            raise ValueError(f"model variables live on {b.device}, driver on {dev}")
    return dev
