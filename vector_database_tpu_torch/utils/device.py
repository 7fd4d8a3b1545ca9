"""Where an entry point puts its tensors.

The package runs on the card by default, as the JAX package runs on its
default device: an explicit ``device`` wins, then the device of a tensor
argument, then ``cuda``. Nothing here asks whether a card exists, so host
data with no ``device`` on a machine without one fails with PyTorch's own
error instead of moving to the CPU behind the caller's back; CPU callers
(the tests among them) pass ``device="cpu"`` or CPU tensors.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given; else the device of ``like`` when it is a
    tensor; else ``torch.device("cuda")``."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return torch.device("cuda")
