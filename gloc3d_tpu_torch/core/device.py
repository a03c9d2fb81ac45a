"""Where the port's entry points run: on the card unless told otherwise."""

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
