"""Where the port's entry points run (on the card unless told otherwise),
and the small constants they keep there."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]],
                   who: str) -> torch.device:
    """``device`` as given, or ``cuda`` when it is None. Raises when no
    device is given and no card is there: an entry point never falls back
    to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; pass "
                           f"device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype)`` on ``device``, built once per
    values, dtype and device and shared (read-only): each ``torch.tensor``
    made on a card is a host synchronisation, and the matcher and the
    ground estimator run on every query. A constant made while
    ``torch.export`` traces (a fake tensor) is not kept."""
    key = (values if isinstance(values, (int, float)) else tuple(values),
           dtype, torch.device(device))
    out = _CONSTANTS.get(key)
    if out is None:
        out = torch.tensor(values, dtype=dtype).to(key[2])
        if type(out) is torch.Tensor:
            _CONSTANTS[key] = out
    return out


_CONSTANTS: dict = {}
