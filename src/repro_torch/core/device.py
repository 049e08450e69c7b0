"""Device resolution shared by every entry point of the port.

Entry points take an explicit ``device`` and default to ``"cuda"``. With no
card present a CUDA request raises: the port never moves work to the CPU
behind the caller's back. Tests and host-side tools pass ``device="cpu"``.

:func:`upload` is the port's host-to-card copy.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import torch

DEFAULT_DEVICE = "cuda"
#: Per card, the page-locked buffer :func:`upload` copies through and the
#: event that marks the last copy out of it finished.
_KEPT: Dict[torch.device, Tuple[torch.Tensor, Any]] = {}
_LOCK = threading.Lock()


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
    """``t`` (a CPU tensor) on ``device``: the port's one host-to-card copy.
    To a card it goes through a page-locked buffer kept for that card, and
    without blocking, so the copy is queued on the current stream behind
    the work already there instead of waiting for it. The buffer is written
    again only once the last copy out of it has finished; while that copy
    is still queued, the upload takes a fresh page-locked block and keeps
    it, so no upload waits for the card. A fresh block costs milliseconds
    of host time at a megabyte (a median of 2.4 ms for 0.9 MB after a wait
    for the card, measured on an H100 host), a write into the kept one a
    tenth of a millisecond. ``params.pack_params`` alone keeps a pageable
    ``.to(device)`` (the env's params, a swap's rows)."""
    if device.type == "cpu":
        return t
    nbytes = t.numel() * t.element_size()
    with _LOCK:
        buf, done = _KEPT.get(device, (None, None))
        if buf is None or buf.numel() < nbytes or not done.query():
            buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                              pin_memory=True)
        host = buf[:nbytes].view(t.dtype).view(t.shape)
        # numpy's copy runs on this thread: torch's own wakes its pool of
        # threads, which cost milliseconds now and then after a wait for
        # the card.
        host.numpy()[...] = t.numpy()
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        out.copy_(host, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        _KEPT[device] = (buf, done)
    return out
