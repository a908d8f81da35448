"""EMMA kinship from the k-mers table, as exact integer GEMMs.

Reference (src/kmers_multiple_databases.cpp:418-438 + emma_kinship_kmers.cpp):
for every MAC-passing k-mer row g, K[i][j] += 1 ^ g_i ^ g_j (an XNOR count),
then normalize by the number of k-mers used and set the diagonal to 1.

Device formulation: encode bits as A in {-1,+1} int8. Then
    (A^T A)[i,j] = sum_rows (2g_i-1)(2g_j-1) = #match - #mismatch
    xnor_count   = (n_rows + A^T A) / 2
int8 x int8 -> int32 accumulation is exact, so the result matches the
reference's integer arithmetic bit-for-bit before the final float divide.

Padded sample lanes contribute only to padded rows/cols of K and are sliced
away at the end.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .bitplanes import unpack_bits_pm1


@jax.jit
def kinship_accumulate(acc: jax.Array, packed: jax.Array) -> jax.Array:
    """acc (N_pad, N_pad) int32 += A^T A for this batch's packed rows."""
    a = unpack_bits_pm1(packed)          # (R, N_pad) int8
    return acc + jax.lax.dot_general(
        a, a, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)


@jax.jit
def kinship_accumulate_masked(acc: jax.Array, packed: jax.Array,
                              valid: jax.Array) -> jax.Array:
    """Like kinship_accumulate, but rows with valid == 0 contribute nothing.

    The plain ±1 encoding makes an all-zero padding row NON-neutral (it adds
    +1 to every pair); zeroing invalid rows (0 * anything = 0 in the GEMM)
    restores exactness, so batches may be padded to any fixed shape —
    required for equal-size device shards."""
    a = unpack_bits_pm1(packed) * valid[:, None].astype(jnp.int8)
    return acc + jax.lax.dot_general(
        a, a, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)


def kinship_init(n_pad: int) -> jax.Array:
    return jnp.zeros((n_pad, n_pad), jnp.int32)


class KinshipAccumulator:
    """Streaming accumulator with int64 host spill to avoid int32 overflow.

    Each batch adds at most `rows` to any entry; the device int32 partial is
    flushed into a host int64 total before it can overflow (~2^31 rows).
    """

    def __init__(self, n_used: int, n_pad: int):
        self.n_used = n_used
        self.n_pad = n_pad
        self.total = np.zeros((n_used, n_used), dtype=np.int64)
        self.device_acc = kinship_init(n_pad)
        self.rows_in_acc = 0
        self.n_rows = 0

    def add(self, packed_dev) -> None:
        rows = int(packed_dev.shape[0])
        if self.rows_in_acc + rows > (1 << 30):
            self.flush()
        self.device_acc = kinship_accumulate(self.device_acc, packed_dev)
        self.rows_in_acc += rows
        self.n_rows += rows

    def flush(self) -> None:
        if self.rows_in_acc:
            part = np.asarray(self.device_acc, dtype=np.int64)
            self.total += part[: self.n_used, : self.n_used]
            self.device_acc = kinship_init(self.n_pad)
            self.rows_in_acc = 0

    def finalize(self) -> np.ndarray:
        """Normalized kinship (N, N) float64, diagonal forced to 1
        (emma_kinship_kmers.cpp:95-102)."""
        self.flush()
        if self.n_rows == 0:
            raise ValueError("no k-mers accumulated into kinship")
        xnor = (self.n_rows + self.total) / 2.0
        k = xnor / float(self.n_rows)
        np.fill_diagonal(k, 1.0)
        return k
