"""The market-axis device mesh of the port.

The counterpart of ``repro.launch.mesh``: a 1-D ``("markets",)`` mesh is the
whole topology, because markets are independent and the only cross-market
read (an arbitrageur's peer mid) is a column gathered at chunk entry. Here
a mesh is an ordered tuple of ``torch.device``s, driven by one controller
(the calling process) as JAX drives a mesh: the runner cuts each chunk's
rows over the devices and launches one kernel on each
(:mod:`repro_torch.kernels.ops`).

:func:`make_markets_mesh` spans the cards (``torch.cuda.device_count()``)
or, on the CPU, :func:`set_host_device_count` host devices, the
counterpart of ``--xla_force_host_platform_device_count``: every CPU
"device" of a mesh is ``torch.device("cpu")``, and the count only says how
many shards a CPU mesh cuts. ``MarketsMesh((d, d))`` names one device
twice, which shards over one card (two launches a chunk on the same card),
the way a forced host-device count shards over one CPU.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import torch


def _resolve_device(device) -> torch.device:
    """``repro_torch.core.device.resolve_device``, imported at the call:
    the ``repro_torch.core`` package imports the session, which imports
    this one."""
    from repro_torch.core.device import resolve_device

    return resolve_device(device)


#: Host devices a CPU mesh may span (see set_host_device_count).
_HOST_DEVICES = [1]

# The card the roofline (repro_torch.launch.roofline) is held to: NVIDIA's
# data sheet for the H100 SXM (80 GB HBM3) at its 700 W power limit, dense
# rates. 67 TFLOP/s in f32 counts an FMA as two operations; one instruction
# per FP32 lane per clock (132 SMs x 128 lanes x 1.98 GHz) is half that.
# kinetic_clearing.op_count counts FP32-lane issue slots: each instruction
# class weighted by 128 over its per-SM rate on compute capability 9.0
# (FP32 x1, 32-bit integer x2, conversion x8, shuffle x4). NVLink 4 moves
# 900 GB/s both ways, 450 GB/s each way.
HW = {
    "peak_flops_bf16": 989e12,   # tensor cores, per card
    "peak_flops_fp32": 67e12,    # outside the tensor cores
    "peak_lane_ops": 67e12 / 2,  # FP32-lane issue slots per second
    "hbm_bw": 3.35e12,           # bytes/s per card
    "nvlink_bw": 450e9,          # bytes/s per direction
    "hbm_per_chip": 80e9,
}


class MarketsMesh(NamedTuple):
    """An ordered tuple of devices over the market axis."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("markets",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @classmethod
    def of(cls, devices: Iterable, axis_names=("markets",)) -> "MarketsMesh":
        """A mesh over an explicit device list, which may repeat a device;
        every device must be of one type (``cuda`` or ``cpu``)."""
        devs = tuple(_resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh spans one device type, got "
                             f"{[str(d) for d in devs]}")
        return cls(devs, tuple(axis_names))


def set_host_device_count(n: int) -> int:
    """Set how many host devices a CPU mesh may span (default 1); returns
    the previous count, so a test can restore it. It applies to the CPU
    only: a CUDA mesh spans the cards there are."""
    n = int(n)
    if n < 1:
        raise ValueError(f"host device count must be >= 1, got {n}")
    prev, _HOST_DEVICES[0] = _HOST_DEVICES[0], n
    return prev


def local_devices(device="cuda") -> Tuple[torch.device, ...]:
    """The local devices of ``device``'s type: every card, or the host
    devices of :func:`set_host_device_count`."""
    kind = _resolve_device(device).type
    if kind == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),) * _HOST_DEVICES[0]


def make_markets_mesh(devices=None, skip=(), device="cuda") -> MarketsMesh:
    """1-D ``("markets",)`` mesh over ``devices`` local devices of
    ``device``'s type (default: all of them).

    ``skip`` excludes local device *indices* before selection: the rebuild
    after a device loss, ``make_markets_mesh(skip=(2,))``, spans every
    survivor, and a snapshot restored onto it resumes the stream bit for
    bit (snapshots keep the canonical layout). Raises ``ValueError`` when
    ``skip`` excludes every device or ``devices`` is out of range.
    """
    skip = frozenset(int(i) for i in skip)
    kind = _resolve_device(device).type
    avail = [d for i, d in enumerate(local_devices(kind)) if i not in skip]
    if not avail:
        raise ValueError(f"skip={sorted(skip)} excludes every local {kind} "
                         "device")
    n = len(avail) if devices is None else int(devices)
    if not 1 <= n <= len(avail):
        hint = ("set_host_device_count(N) gives a CPU mesh N host devices"
                if kind == "cpu" else
                "MarketsMesh.of([...]) may name one card more than once")
        raise ValueError(f"requested {n} devices; have {len(avail)} local "
                         f"{kind} devices (hint: {hint})")
    return MarketsMesh(tuple(avail[:n]))
