"""GRAMMAR-Gamma correction factor from genotype data.

Equivalent of update_gamma_precalculations + calc_gamma
(src/kmers_multiple_databases.cpp:390-416, 468-497): accumulate

    R = (1/M) * sum over k-mers of g g^T,
    g_i = (bit_i - Egm) / sqrt(n (Egm - Egm^2)),  Egm = N1 / n

over (by default) the first ~100k MAC-passing k-mers, then
gamma = sum_ij Vinv_ij R_ij. The per-row centering + scaling feeds one
standardized GEMM per batch on the device instead of the reference's O(rows*N^2)
scalar loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.table import KmersTableReader
from ..ops.bitplanes import unpack_bits


@jax.jit
def gamma_accumulate(acc, packed, popcnt, n_used_f):
    """acc (N_pad, N_pad) f32 += A^T A of standardized genotypes."""
    g = unpack_bits(packed, jnp.float32)          # (R, N_pad)
    mu = (popcnt / n_used_f)[:, None]
    denom = jax.lax.rsqrt(n_used_f * (mu - mu * mu))
    a = (g - mu) * denom                          # pads become -mu*denom
    # zero the padding columns so they don't pollute real entries
    n_pad = g.shape[1]
    col_ok = (jnp.arange(n_pad) < n_used_f)[None, :]
    a = jnp.where(col_ok, a, 0.0)
    return acc + jax.lax.dot_general(a, a, (((0,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32)


def calc_gamma(table_base: str, inv_cov: np.ndarray, *, min_count: int,
               max_variants: int = 100_000, batch_size: int = 10_000,
               names_to_use=None) -> float:
    """gamma = <Vinv, R> over up to max_variants MAC-passing k-mers."""
    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    n = reader.n_used
    if inv_cov.shape != (n, n):
        raise ValueError("inverse covariance shape mismatch")
    acc = jnp.zeros((reader.w32 * 32, reader.w32 * 32), jnp.float32)
    m = 0
    for batch in reader.iter_batches(batch_size, min_count):
        acc = gamma_accumulate(acc, jnp.asarray(batch.packed),
                               jnp.asarray(batch.popcnt), jnp.float32(n))
        m += batch.n_rows
        if m >= max_variants:
            break
    if m == 0:
        raise ValueError("no k-mers passed the MAC filter")
    R = np.asarray(acc, dtype=np.float64)[:n, :n] / m
    return float(np.sum(inv_cov * R))
