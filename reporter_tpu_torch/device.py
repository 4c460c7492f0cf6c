"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device.  A CUDA device without a usable CUDA
    runtime raises: nothing falls back to the CPU on its own, the caller
    asks for ``"cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions" % (str(dev),))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (str(dev),))
    return dev
