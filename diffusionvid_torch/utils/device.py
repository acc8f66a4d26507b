"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from ..parallel import dist


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda:LOCAL_RANK`` under an initialized
    process group, else the current one.  With no CUDA device this raises
    instead of carrying on on the CPU; the CPU is used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dist.is_initialized():
            return torch.device("cuda", dist.local_rank())
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
