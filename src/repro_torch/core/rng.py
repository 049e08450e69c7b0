"""Stateless counter-based RNG: ``kinetic_hash32`` and ``uniform32``.

A pure function of (seed, global agent id, absolute step, channel), built
from chained 32-bit avalanche mixers (lowbias32 / murmur3-style
finalizers). It gives the same uint32 stream as the JAX package and as the
CUDA kernel (``kernels/csrc/kinetic_clearing.cu``), which computes it in
``uint32_t``.

PyTorch on the CPU has no ``>>`` on uint32, so the plain version holds each
uint32 value in an int64 tensor and masks to 32 bits. Products are split
into 16-bit halves of the constant so no intermediate leaves int64's range.

SplitMix64 (the paper's generator) is kept in numpy uint64 for the
``numpy-splitmix64`` reference backend: it wraps modulo 2**64, and torch's
int64 right shift is signed.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_K_GID = 0x85EBCA6B
_K_STEP = 0xC2B2AE35
_K_CHAN = 0x27D4EB2F


def _u32(x) -> torch.Tensor:
    """int64 tensor holding ``x`` modulo 2**32."""
    if isinstance(x, int):
        return torch.tensor(x & _MASK, dtype=torch.int64)
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mul(x: torch.Tensor, const: int) -> torch.Tensor:
    """``(x * const) mod 2**32`` for uint32 values held in int64."""
    lo, hi = const & 0xFFFF, const >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche finalizer over uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 15)
    x = _mul(x, _M2)
    x = x ^ (x >> 16)
    return x


def kinetic_hash32(seed, gid, step, channel) -> torch.Tensor:
    """Pure function of (seed, gid, step, channel) -> uint32 (as int64).

    ``gid`` wraps modulo 2**32 like the JAX package's int32 product.
    """
    # 0-dim host tensors combine with tensors on any device.
    seed, gid, step, channel = (_u32(v) for v in (seed, gid, step, channel))
    x = seed ^ _GOLDEN
    x = mix32((x + _mul(gid, _K_GID)) & _MASK)
    x = mix32((x + _mul(step, _K_STEP)) & _MASK)
    x = mix32((x + _mul(channel, _K_CHAN)) & _MASK)
    return x


def uniform32(seed, gid, step, channel) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the top 24 bits of the hash."""
    bits = kinetic_hash32(seed, gid, step, channel)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


# ---------------------------------------------------------------------------
# SplitMix64 (paper Eq. 8-10), numpy uint64 only: the stream of the
# ``numpy-splitmix64`` reference backend.
# ---------------------------------------------------------------------------
_SM64_1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_2 = np.uint64(0x94D049BB133111EB)
_SM64_G = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(coord: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer of a uint64 counter coordinate (paper Eq. 8-10)."""
    z = np.asarray(coord, dtype=np.uint64)
    with np.errstate(over="ignore"):  # modular uint64 arithmetic by design
        z = (z ^ (z >> np.uint64(30))) * _SM64_1
        z = (z ^ (z >> np.uint64(27))) * _SM64_2
        return z ^ (z >> np.uint64(31))


def splitmix64_coord(seed, gid, step, channel) -> np.ndarray:
    """Counter coordinate hash(gid, step, channel, seed) (paper Eq. 7)."""
    gid = np.asarray(gid, dtype=np.uint64)
    step = np.asarray(step, dtype=np.uint64)
    channel = np.asarray(channel, dtype=np.uint64)
    seed = np.asarray(seed, dtype=np.uint64)
    with np.errstate(over="ignore"):  # modular uint64 arithmetic by design
        coord = seed * _SM64_G + gid
        coord = splitmix64(coord + step * _SM64_1)
        coord = coord + channel * _SM64_2
    return coord


def splitmix64_uniform(seed, gid, step, channel) -> torch.Tensor:
    """Uniform float32 in [0, 1) from SplitMix64 (top 24 bits), as a CPU
    tensor. ``gid`` and ``step`` are taken modulo 2**32, as the JAX
    package's uint32 coordinates are."""
    gid = np.asarray(_u32(gid).cpu().numpy(), dtype=np.uint64)
    step = np.uint64(int(step) & _MASK)
    bits = splitmix64(splitmix64_coord(seed, gid, step, channel))
    hi24 = (bits >> np.uint64(40)).astype(np.float32)
    return torch.from_numpy(hi24 * np.float32(2.0 ** -24))
