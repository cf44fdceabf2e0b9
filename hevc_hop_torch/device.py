"""Device choice for the entry points.

The encoder and decoder run on the card unless the caller asks for the CPU.
Every kernel wrapper dispatches on the device of the tensor it is given: a
CUDA tensor goes to the hand-written kernel (or the call raises), a CPU
tensor goes to the plain PyTorch version. There is no fallback between them.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is absent and the caller
    did not ask for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
