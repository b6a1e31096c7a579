"""Device resolution shared by the entry points.

Every entry point takes ``device=None``, which means the CUDA card. The
CPU runs only when a caller asks for it (the tests do); there is no
silent fallback.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "littlemcmc_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path.")
    return dev
