"""Stateless counter-based RNG in NumPy: ``kinetic_hash32`` in ``uint32``
and SplitMix64 in ``uint64``.

``kinetic_hash32`` is a pure function of (seed, gid, step, channel) built
from chained 32-bit avalanche mixers (lowbias32 / murmur3-style
finalizers); it gives the same uint32 stream as the CUDA kernel and the
port's torch step. Products wrap modulo 2**32 in ``uint32`` arrays.
SplitMix64 (the paper's generator, paper Eq. 7-10) is the stream of the
``numpy-splitmix64`` backend.
"""
from __future__ import annotations

import numpy as np

# uint32 constants (lowbias32 by C. Wellons + murmur3/xxhash primes)
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_K_GID = 0x85EBCA6B
_K_STEP = 0xC2B2AE35
_K_CHAN = 0x27D4EB2F


def _u32(value):
    if isinstance(value, int):
        value = np.uint32(value & 0xFFFFFFFF)  # pre-wrap Python ints
    return np.asarray(value).astype(np.uint32)


def mix32(x):
    """lowbias32 avalanche finalizer over uint32 arrays."""
    c1 = _u32(_M1)
    c2 = _u32(_M2)
    x = x ^ (x >> 16)
    x = x * c1
    x = x ^ (x >> 15)
    x = x * c2
    x = x ^ (x >> 16)
    return x


def kinetic_hash32(seed, gid, step, channel):
    """Pure function of (seed, gid, step, channel) -> uint32.

    Absorbs each key coordinate with a distinct odd multiplier, with a full
    avalanche between absorptions.
    """
    seed = _u32(seed)
    gid = _u32(gid)
    step = _u32(step)
    channel = _u32(channel)
    x = seed ^ _u32(_GOLDEN)
    x = mix32(x + gid * _u32(_K_GID))
    x = mix32(x + step * _u32(_K_STEP))
    x = mix32(x + channel * _u32(_K_CHAN))
    return x


def uniform32(seed, gid, step, channel):
    """Uniform float32 in [0, 1) with exactly 24 random mantissa bits (the
    top 24 bits keep the conversion exact and the result below 1.0)."""
    bits = kinetic_hash32(seed, gid, step, channel)
    hi24 = (bits >> 8).astype(np.float32)
    return hi24 * np.float32(2.0 ** -24)


# ---------------------------------------------------------------------------
# SplitMix64 (paper Eq. 8-10): the ``numpy-splitmix64`` stream.
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


def splitmix64_uniform(seed, gid, step, channel) -> np.ndarray:
    """Uniform float32 in [0,1) from SplitMix64 (top 24 bits)."""
    bits = splitmix64(splitmix64_coord(seed, gid, step, channel))
    hi24 = (bits >> np.uint64(40)).astype(np.float32)
    return hi24 * np.float32(2.0 ** -24)
