"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import numpy as np
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


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  For CUDA the copy goes
    through pinned memory and is queued on the current stream without
    blocking the host (a copy from pageable memory would wait for the
    stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t
