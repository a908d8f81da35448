"""Packed bit-plane <-> dense conversions on device.

The k-mer presence/absence matrix lives in HBM as uint32 bit-planes
(rows = k-mers, 32 samples per word, LSB-first — see core/table.py). These
helpers unpack lanes right before feeding the matrix units, so HBM traffic
stays at 1 bit/sample instead of 8-32 bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def unpack_bits(packed: jax.Array, dtype=jnp.float32) -> jax.Array:
    """(..., W) uint32 -> (..., W*32) 0/1 in `dtype`, LSB-first per word."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., None] >> shifts) & jnp.uint32(1)
    return bits.astype(dtype).reshape(*packed.shape[:-1], packed.shape[-1] * 32)


def unpack_bits_pm1(packed: jax.Array) -> jax.Array:
    """(..., W) uint32 -> (..., W*32) int8 in {-1, +1} (bit b -> 2b-1).

    Feeds the int8 GEMM path for exact XNOR/kinship accumulation.
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((packed[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int8)
    pm1 = (bits << 1) - jnp.int8(1)
    return pm1.reshape(*packed.shape[:-1], packed.shape[-1] * 32)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host-side inverse for tests: (..., M) 0/1 -> (..., M/32) uint32."""
    assert bits.shape[-1] % 32 == 0
    by = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(by).view("<u4").reshape(*bits.shape[:-1], bits.shape[-1] // 32)


def popcount_rows(packed: jax.Array) -> jax.Array:
    """Per-row popcount of packed uint32 planes -> float32."""
    cnt = jax.lax.population_count(packed)
    return jnp.sum(cnt, axis=-1).astype(jnp.float32)
