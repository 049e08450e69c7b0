"""Device resolution shared by every entry point of the port.

Entry points take an explicit ``device`` and default to ``"cuda"``. With no
card present a CUDA request raises: the port never moves work to the CPU
behind the caller's back. Tests and host-side tools pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` (a CPU tensor) on ``device``. To the card it goes through pinned
    memory without blocking, so the copy is queued on the current stream
    behind the work already there instead of waiting for it."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
