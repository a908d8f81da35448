"""Streaming device-resident top-k over the k-mer axis.

Replaces BestAssociationsHeap (src/best_associations_heap.cpp): instead of a
per-phenotype CPU heap fed row-by-row, each device batch contributes a
`lax.top_k` and is merged into a carried (P, K) state entirely on device.
Only the final (scores, row ids) ever reach the host; winner k-mer codes and
presence rows are then gathered from the table by random access (no second
full pass, unlike associate_kmers.cpp:178-191).

Tie semantics match the heap: an incumbent is only displaced by a STRICTLY
greater score (best_associations_heap.cpp:50) — `lax.top_k` is stable and the
carried state is concatenated before the new batch, so on equal scores the
earlier (lower-row) entry wins, like the reference.

Row indices can exceed int32 (2B-row tables), so they ride as two int32
planes (lo 30 bits / hi bits).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_ROW_SPLIT = 1 << 30


class TopKState(NamedTuple):
    scores: jax.Array   # (P, K) f32, descending
    row_lo: jax.Array   # (P, K) int32
    row_hi: jax.Array   # (P, K) int32


def init_state(n_phenotypes: int, k: int) -> TopKState:
    return TopKState(
        scores=jnp.full((n_phenotypes, k), -jnp.inf, jnp.float32),
        row_lo=jnp.zeros((n_phenotypes, k), jnp.int32),
        row_hi=jnp.zeros((n_phenotypes, k), jnp.int32),
    )


def encode_rows(rows: np.ndarray):
    """Split NON-NEGATIVE row ids into (lo, hi) int32 halves. Bitwise ops
    (not %//) — this runs per-row on the feed path's hot thread (3x faster;
    identical results for rows >= 0, the only values row ids take)."""
    rows = np.asarray(rows, dtype=np.int64)
    lo = np.bitwise_and(rows, _ROW_SPLIT - 1).astype(np.int32)
    hi = np.right_shift(rows, _ROW_SPLIT.bit_length() - 1).astype(np.int32)
    return lo, hi


def decode_rows(row_lo: np.ndarray, row_hi: np.ndarray) -> np.ndarray:
    return row_hi.astype(np.int64) * _ROW_SPLIT + row_lo.astype(np.int64)


def blocked_top_k(sc: jax.Array, k: int, block: int = 16):
    """Exact top-k over the last axis via block-max pre-reduction.

    `lax.top_k` over millions of lanes dominates the scan wall-clock (a full
    sort under the hood); this reduces it to a top-k over R/block block
    maxima plus a top-k over k*block gathered candidates. Exactness argument
    (incl. the stable earliest-index tie preference `lax.top_k` guarantees):
    every element >= the k-th value lives in a block whose max >= it, and at
    most k blocks can hold the k kept elements, so the k highest-max blocks
    (stable, earliest-first, re-sorted to ascending index before the final
    stable top-k) contain exactly the elements a flat stable top-k keeps.

    sc: (P, R) with R % block == 0. Returns (values (P,k), indices (P,k)).
    """
    p, r = sc.shape
    k = min(k, r)
    if (r + block - 1) // block <= k:
        return jax.lax.top_k(sc, k)
    if r % block:
        pad = block - r % block
        sc = jnp.pad(sc, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        r += pad
    nb = r // block
    blocks = sc.reshape(p, nb, block)
    bmax = jnp.max(blocks, axis=-1)                       # (P, nb)
    # recurse: selecting the k highest-max blocks is itself a top-k over nb
    # lanes, which the same argument shrinks again when nb >> k
    _, bi = blocked_top_k(bmax, k, block)                 # (P, k) block ids
    bi = jnp.sort(bi, axis=-1)                            # ascending rows
    cand = jnp.take_along_axis(blocks, bi[:, :, None], axis=1)
    cand = cand.reshape(p, k * block)
    cand_idx = (bi[:, :, None] * block
                + jnp.arange(block, dtype=bi.dtype)).reshape(p, k * block)
    v, j = jax.lax.top_k(cand, k)
    return v, jnp.take_along_axis(cand_idx, j, axis=1)


def strided_top_k_from_bmax(sc: jax.Array, bmax: jax.Array, k: int, *,
                            tile_rows: int):
    """Top-k given precomputed STRIDED block maxima (fused into the score
    kernel, score.score_batch_t_pallas_bmax) — extraction never re-reads the
    (P, R) score matrix, only k gathered blocks per column.

    Layout: within each tile of `tile_rows` lanes, block g holds lanes
    {tile*tile_rows + (g % nb) + nb*j}, nb = tile_rows/block. Strided blocks
    break the contiguous-block ordering that made blocked_top_k tie-exact, so
    this returns (values, indices, exact): `exact` is True iff the k-th kept
    value STRICTLY exceeds everything excluded (the (k+1)-th gathered
    candidate and the (k+1)-th block maximum) — then the selection equals the
    stable flat top-k, and a final 2-key lex sort (value desc, index asc)
    restores the heap's earliest-row order among kept equal values. Callers
    must branch to an exact path when `exact` is False.

    sc: (P, R), bmax: (P, R/block), R % tile_rows == 0.
    """
    p, r = sc.shape
    nbt = bmax.shape[1]
    assert r % nbt == 0
    block = r // nbt
    assert tile_rows % block == 0 and r % tile_rows == 0
    nb_tile = tile_rows // block
    k = min(k, r)
    if nbt <= k + 1 or k + 1 >= r:
        v, i = jax.lax.top_k(sc, k)
        return v, i, jnp.bool_(True)
    # k+1 blocks: the extra one bounds everything unselected
    _, bi = blocked_top_k(bmax, k + 1, block=16)          # (P, k+1) block ids
    bsel, bnext = bi[:, :k], bi[:, k]
    m_next = jnp.take_along_axis(bmax, bnext[:, None], axis=1)[:, 0]  # (P,)
    tile = bsel // nb_tile
    b_in = bsel % nb_tile
    lanes = (tile[:, :, None] * tile_rows + b_in[:, :, None]
             + nb_tile * jnp.arange(block, dtype=bsel.dtype))  # (P, k, block)
    cand_idx = lanes.reshape(p, k * block)
    # gather candidate scores at BLOCK granularity: P*k*block scattered
    # 4-byte per-lane gathers would dominate the whole scan step. Viewing sc as
    # (P, tiles, block, nb_tile), block (t, b) is the 16-element slice
    # [p, t, :, b] — one gather index per BLOCK (16x fewer), each pulling a
    # strided 16-element slice.
    sc4 = sc.reshape(p, r // tile_rows, block, nb_tile)
    cand = sc4[jnp.arange(p, dtype=bsel.dtype)[:, None], tile, :, b_in]
    cand = cand.reshape(p, k * block)
    vv, jj = jax.lax.top_k(cand, k + 1)                   # +1: boundary probe
    v, j = vv[:, :k], jj[:, :k]
    idx = jnp.take_along_axis(cand_idx, j, axis=1)
    # exact iff a strict gap separates kept from all excluded
    exact = jnp.all((v[:, -1] > vv[:, k]) & (v[:, -1] > m_next))
    # restore earliest-index order among kept equal values
    neg_s, idx_s = jax.lax.sort((-v, idx), dimension=1, num_keys=2)
    return -neg_s, idx_s, exact


@jax.jit
def update(state: TopKState, batch_scores: jax.Array,
           row_lo: jax.Array, row_hi: jax.Array) -> TopKState:
    """Merge a batch: batch_scores (R, P), row_lo/hi (R,) -> new state."""
    k = state.scores.shape[1]
    sc = batch_scores.T                                  # (P, R)
    r = sc.shape[1]
    if r > k:
        v, i = blocked_top_k(sc, k)                      # (P, K)
        blo, bhi = row_lo[i], row_hi[i]
    else:
        v, blo, bhi = sc, jnp.broadcast_to(row_lo, sc.shape), jnp.broadcast_to(row_hi, sc.shape)
    cat_v = jnp.concatenate([state.scores, v], axis=1)
    cat_lo = jnp.concatenate([state.row_lo, blo], axis=1)
    cat_hi = jnp.concatenate([state.row_hi, bhi], axis=1)
    nv, j = jax.lax.top_k(cat_v, k)
    return TopKState(scores=nv,
                     row_lo=jnp.take_along_axis(cat_lo, j, axis=1),
                     row_hi=jnp.take_along_axis(cat_hi, j, axis=1))


def finalize(state: TopKState):
    """-> (scores (P, K) f64, rows (P, K) int64) on host, -inf rows dropped
    per phenotype as ragged lists."""
    scores = np.asarray(state.scores, dtype=np.float64)
    rows = decode_rows(np.asarray(state.row_lo), np.asarray(state.row_hi))
    out = []
    for p in range(scores.shape[0]):
        valid = np.isfinite(scores[p])
        out.append((scores[p][valid], rows[p][valid]))
    return out
