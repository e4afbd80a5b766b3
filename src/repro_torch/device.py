"""The one rule for where the port's entry points run: on the card unless
the caller names another device."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` means the card, ``cuda:0``; with no CUDA device that raises
    rather than running on the CPU. Anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        return torch.device("cuda:0")
    return torch.device(device)
