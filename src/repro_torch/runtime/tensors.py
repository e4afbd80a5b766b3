"""The tensor boundary of the result codecs (the npz spill codec in
``storage`` and the shared-memory codec in ``transport``): a torch tensor of
any dtype and device crosses as a host ndarray plus a tag, and comes back
as a tensor of that dtype on that device type."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["tensor_to_host", "tensor_from_host"]

# dtypes numpy lacks, carried bit for bit as an integer view of their size
_VIEWS = {torch.bfloat16: torch.int16}


def tensor_to_host(t: torch.Tensor) -> Tuple[np.ndarray, str, str]:
    """``(host array, dtype name, device type)``. For a CPU tensor the array
    may share its memory; the codecs copy it out. Raises ``TypeError`` for
    a dtype neither numpy nor a view can carry."""
    host = t.detach().to("cpu").contiguous()
    view = _VIEWS.get(host.dtype)
    try:
        arr = (host.view(view) if view is not None else host).numpy()
    except TypeError as e:
        raise TypeError(f"no host codec for tensors of {t.dtype}") from e
    return arr, str(host.dtype).removeprefix("torch."), t.device.type


def tensor_from_host(arr: np.ndarray, dtype: str, device: str) -> torch.Tensor:
    """The inverse of :func:`tensor_to_host`, on ``device`` (a device type:
    ``"cuda"`` means the current card). ``arr`` must be writable and
    C-contiguous, as the codecs' decoded arrays are."""
    t = torch.from_numpy(arr)
    want = getattr(torch, dtype)
    if t.dtype != want:
        t = t.view(want)
    return t.to(device)
