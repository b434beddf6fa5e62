"""Image augmentation on the device (port of ``fedml_tpu/data/augment.py``).

The reference applies torchvision transforms per sample on the host
(RandomCrop(32, padding=4), RandomHorizontalFlip, Cutout(16)).  Here the
same transforms are batched tensor ops applied once per epoch to the whole
shuffled epoch tensor inside the local update (``core/client.py``), on the
device that tensor lives on.  The draws are the JAX package's threefry
draws under the same key layout, so the output is bit-identical to
``make_image_augment``'s for the same key.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fedml_tpu_torch.core import rng as rnglib


def make_image_augment(pad: int = 4, flip: bool = True,
                       cutout: Optional[int] = 16) -> Callable:
    """Returns ``augment(key, x)`` for x [B, H, W, C] (already normalized).

    Keys: ``split(key, 3)`` into crop, flip and Cutout keys.  Random crop:
    zero-pad by ``pad``, offsets ``randint((B, 2), 0, 2·pad + 1)``, an
    index gather of each image's window (the JAX package writes the same
    selection as two one-hot einsums, a TPU tiling choice).  Flip:
    ``bernoulli(0.5, (B, 1, 1, 1))`` over W.  Cutout: centres
    ``randint((B,), 0, H)`` under the Cutout key and ``randint((B,), 0, W)``
    under ``fold_in(it, 1)``, the square ``[c - size/2, c + size/2)``
    multiplied by zero."""

    def augment(key, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        dev = x.device
        k_crop, k_flip, k_cut = rnglib.split(key, 3)

        if pad:
            xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
            offs = rnglib.randint(k_crop, (b, 2), 0, 2 * pad + 1, dev).long()
            rows = offs[:, 0, None] + torch.arange(h, device=dev)
            cols = offs[:, 1, None] + torch.arange(w, device=dev)
            batch = torch.arange(b, device=dev)[:, None, None]
            x = xp[batch, rows[:, :, None], cols[:, None, :]]

        if flip:
            do = rnglib.bernoulli(k_flip, 0.5, (b, 1, 1, 1), dev)
            x = torch.where(do, x.flip(2), x)

        if cutout:
            cy = rnglib.randint(k_cut, (b,), 0, h, dev)[:, None, None]
            cx = rnglib.randint(rnglib.fold_in(k_cut, 1), (b,), 0, w,
                                dev)[:, None, None]
            ys = torch.arange(h, device=dev)[None, :, None]
            xs = torch.arange(w, device=dev)[None, None, :]
            half = cutout // 2
            inside = ((ys >= cy - half) & (ys < cy + half)
                      & (xs >= cx - half) & (xs < cx + half))
            # a multiply, as the JAX package's, so zeros keep their sign
            x = x * (1.0 - inside[..., None].to(x.dtype))

        return x

    return augment


def cifar_augment() -> Callable:
    """The reference CIFAR recipe: crop (pad 4) + flip + Cutout(16)."""
    return make_image_augment(pad=4, flip=True, cutout=16)
