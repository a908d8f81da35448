"""Fused association-scan step: score + blocked top-k + state merge, one jit.

The production inner loop of the scan driver. Two implementations of the
compact step's scoring stage share the surrounding top-k logic:

  kernel="xla"      — unpack + dot + tile top-3 via XLA (CPU; the reference)
  kernel="triton"   — the fused Pallas/Triton kernel (ops/score.py; GPU)

Scores arrive transposed (P, R) with padding rows at -inf, feed the exact
blocked top-k, and merge into the carried TopKState without leaving the
device. utils.pick_kernel chooses the kernel from the platform.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import topk as topk_ops
from .bitplanes import unpack_bits


_PRECISION = {"default": None, "highest": jax.lax.Precision.HIGHEST}


def _scores_t_xla(packed, popcnt, y_padded, y_sum, n_used, min_count,
                  precision="default"):
    g = unpack_bits(packed, jnp.float32)                  # (R, N_pad)
    yigi = jnp.dot(g, y_padded, preferred_element_type=jnp.float32,
                   precision=_PRECISION[precision])
    n = jnp.float32(n_used)
    n1 = popcnt[:, None]
    r = n * yigi - n1 * y_sum[None, :]
    denom = n * n1 - n1 * n1
    score = jnp.where(denom > 0, (r * r) / denom, 0.0)
    ok = (n1 >= min_count) & ((n - n1) >= min_count)
    score = jnp.where(ok, score, 0.0)
    return jnp.where(n1 > 0, score, -jnp.inf).T           # (P, R)


def _merge(state: topk_ops.TopKState, v, blo, bhi) -> topk_ops.TopKState:
    k = state.scores.shape[1]
    cat_v = jnp.concatenate([state.scores, v], axis=1)
    cat_lo = jnp.concatenate([state.row_lo, blo], axis=1)
    cat_hi = jnp.concatenate([state.row_hi, bhi], axis=1)
    nv, j = jax.lax.top_k(cat_v, k)
    return topk_ops.TopKState(scores=nv,
                              row_lo=jnp.take_along_axis(cat_lo, j, axis=1),
                              row_hi=jnp.take_along_axis(cat_hi, j, axis=1))


@functools.partial(jax.jit,
                   static_argnames=("n_used", "min_count", "block",
                                    "cand_k"))
def scan_step(state: topk_ops.TopKState, packed, popcnt, row_lo, row_hi,
              y_padded, y_sum, *, n_used: int, min_count: int,
              block: int = 16,
              cand_k: int | None = None) -> topk_ops.TopKState:
    """One streamed batch -> merged top-k state: the plain XLA reference of
    the scan (full score matrix, exact blocked top-k, merge).

    packed (R, W32) uint32, popcnt (R,) f32 with 0 marking padding rows,
    row_lo/row_hi (R,) int32 encoded row ids, y_padded (N_pad, P) f32.

    cand_k: optional candidate cap. Extracting only the batch's top-cand_k
    (cand_k << K) makes the dominant top-k phases much smaller; the merge is
    exact whenever the post-merge k-th score strictly exceeds the cand_k-th
    batch score (then every batch element that could displace the state was
    among the candidates; equal scores never displace, matching the heap's
    strict-> rule, best_associations_heap.cpp:50). A `lax.cond` falls back
    to the full extraction on the rare batches (state not yet full, or a
    candidate tie at the boundary) where that check fails.
    """
    sc = _scores_t_xla(packed, popcnt, y_padded, y_sum, n_used, min_count)

    k = state.scores.shape[1]

    def full_merge(_):
        v, i = topk_ops.blocked_top_k(sc, k, block=block)
        return _merge(state, v, row_lo[i], row_hi[i])

    if not cand_k or cand_k >= k:
        return full_merge(None)

    v, i = topk_ops.blocked_top_k(sc, cand_k, block=block)
    merged = _merge(state, v, row_lo[i], row_hi[i])
    c_min = v[:, -1]
    new_kth = merged.scores[:, -1]
    exact = jnp.all(new_kth > c_min)
    return jax.lax.cond(exact, lambda _: merged, full_merge, None)


# ---------------------------------------------------------------------------
# Buffered scan step: deferred merges
# ---------------------------------------------------------------------------
#
# The per-batch state merge (a stable top-k over (P, K + cand_k), K = 10001)
# costs as much as the score GEMM itself. But after the state saturates,
# almost no batch entries can displace it: any displacer must STRICTLY beat
# the carried k-th score (the heap rule, best_associations_heap.cpp:50).
# So: carry `thresh` = per-column k-th score as of the last merge, extract a
# small top-c per batch, and — whenever the c-th extracted score is already
# below thresh (so every unextracted element, being <= it, can never
# displace) — just append the c candidates to a side buffer and skip the
# merge. The expensive (P, K + C + cand_k) merge runs only when the buffer
# fills or a batch is too hot for the small extraction, amortizing it over
# ~C/c batches. Exact by construction; `lax.cond` falls back to the full
# extraction on the rare non-exact wide merges.


class BufferedTopKState(NamedTuple):
    scores: jax.Array    # (P, K) f32 descending (as of last flush)
    row_lo: jax.Array    # (P, K) int32
    row_hi: jax.Array    # (P, K) int32
    buf_v: jax.Array     # (P, C) f32 pending candidates
    buf_lo: jax.Array    # (P, C) int32
    buf_hi: jax.Array    # (P, C) int32
    buf_n: jax.Array     # () int32 filled slots (multiple of c)
    thresh: jax.Array    # (P,) f32 k-th score at last flush


def init_buffered_state(n_phenotypes: int, k: int, buf_cap: int
                        ) -> BufferedTopKState:
    z = jnp.zeros((n_phenotypes, k), jnp.int32)
    zb = jnp.zeros((n_phenotypes, buf_cap), jnp.int32)
    return BufferedTopKState(
        scores=jnp.full((n_phenotypes, k), -jnp.inf, jnp.float32),
        row_lo=z, row_hi=z,
        buf_v=jnp.full((n_phenotypes, buf_cap), -jnp.inf, jnp.float32),
        buf_lo=zb, buf_hi=zb,
        buf_n=jnp.int32(0),
        thresh=jnp.full((n_phenotypes,), -jnp.inf, jnp.float32),
    )


def _scores_and_bmax(packed, popcnt, y_padded, y_sum, n_used, min_count,
                     block, precision="default", kernel="xla", tile_rows=64):
    """-> (scores (P,R), strided block maxima (P,R/block), tile_rows).
    Runs on the hot batches of the buffered step and in the compact step's
    exact fallback. kernel "triton" scores with the compact kernel's own
    arithmetic (score.score_t_triton), so the step keeps one score per row
    whichever branch scored it; the block maxima are plain XLA."""
    if kernel == "triton":
        from .score import score_t_triton
        sc = score_t_triton(packed, popcnt, y_padded, n_used=n_used,
                            min_count=min_count, tile_rows=tile_rows,
                            precision=precision)
    else:
        sc = _scores_t_xla(packed, popcnt, y_padded, y_sum, n_used,
                           min_count, precision)
    p, r = sc.shape
    if r % block:                       # pad -inf (gather of a padded lane is
        sc = jnp.pad(sc, ((0, 0), (0, block - r % block)),  # dropped as
                     constant_values=-jnp.inf)              # non-finite later)
        r = sc.shape[1]
    nb = r // block                     # single tile: group b = {b + nb*j}
    bmax = jnp.max(sc.reshape(p, block, nb), axis=1)
    return sc, bmax, r


@functools.partial(jax.jit,
                   static_argnames=("n_used", "min_count", "block",
                                    "cand_c", "cand_k"))
def scan_step_buffered(state: BufferedTopKState, packed, popcnt,
                       row_lo, row_hi, y_padded, y_sum, *, n_used: int,
                       min_count: int, block: int = 16,
                       cand_c: int = 512, cand_k: int = 2048
                       ) -> BufferedTopKState:
    """One streamed batch -> buffered top-k state. Args as scan_step; the
    buffer capacity C (state.buf_v.shape[1]) must be a multiple of cand_c."""
    k = state.scores.shape[1]
    cap = state.buf_v.shape[1]
    assert cap % cand_c == 0
    sc, bmax, tile_rows = _scores_and_bmax(packed, popcnt, y_padded, y_sum,
                                           n_used, min_count, block)

    v, i, v_exact = topk_ops.strided_top_k_from_bmax(sc, bmax, cand_c,
                                                     tile_rows=tile_rows)
    blo, bhi = row_lo[i], row_hi[i]
    # unextracted elements are <= v[:,-1]; if that's already < thresh they
    # can never strictly beat the (monotone nondecreasing) k-th score
    can_buffer = (v_exact & jnp.all(v[:, -1] < state.thresh)
                  & (state.buf_n + cand_c <= cap))

    def do_buffer(st: BufferedTopKState) -> BufferedTopKState:
        at = (jnp.int32(0), st.buf_n)
        return st._replace(
            buf_v=jax.lax.dynamic_update_slice(st.buf_v, v, at),
            buf_lo=jax.lax.dynamic_update_slice(st.buf_lo, blo, at),
            buf_hi=jax.lax.dynamic_update_slice(st.buf_hi, bhi, at),
            buf_n=st.buf_n + cand_c)

    def do_flush(st: BufferedTopKState) -> BufferedTopKState:
        return _flush_merge(st, sc, bmax, tile_rows, row_lo, row_hi, cand_k,
                            block)

    return jax.lax.cond(can_buffer, do_buffer, do_flush, state)


# ---------------------------------------------------------------------------
# Compact scan step: tile-max extraction, no score-matrix materialization
# ---------------------------------------------------------------------------
#
# The buffered step still pays for a full (P, R) score write plus a
# hierarchical extraction every batch (~3x the GEMM itself). At steady state
# almost nothing in a batch can displace the carried top-k, so the common
# case needs far less: the kernel keeps scores on chip and emits only, per
# tile of `tile_rows` k-mers and per column, the TOP-3 (score, lane) pairs
# and the count of lanes scoring > thresh. The step then takes a top-c over
# the n_tiles = R/tile_rows tile maxima — thousands of lanes, not millions —
# and appends those tiles' 3c (value, row) candidates to the side buffer.
#
# Exactness: any element that can ever displace the state must STRICTLY beat
# the final k-th score, which is >= thresh (monotone). The append is a
# superset of all such elements when, per column,
#   (a) every NON-kept tile's max <= thresh  (checked via the (c+1)-th kept
#       tile max), so elements outside the kept tiles are all <= thresh; and
#   (b) no tile holds >= 4 lanes scoring > thresh (cnt <= 3): the hot lanes
#       of a tile are a prefix of its sorted order, so <= 3 hot lanes are
#       always inside the captured top-3; and
#   (c) the 2nd/3rd values are unique among the remaining lanes wherever
#       they are hot (n2/n3 == 1) — a hot tie there forces the fallback.
#       Lanes are first-occurrence argmaxes (score.tile_top3), so this guard
#       is conservative; candidates <= thresh are dead weight the flush
#       merge always drops.
# Equal-to-thresh elements can never strictly beat a final k-th >= thresh,
# and the heap's earliest-row preference among kept equals is preserved:
# hot candidates are buffered in stream order (older batches first; within a
# batch the 3c candidates are sorted by (value desc, in-batch row asc)), and
# the flush concat puts the carried state (oldest rows) first. Any violation
# of (a)-(c) falls back to recomputing full scores through the exact
# wide-merge path — rare once thresh saturates (~K rows seen).


def _tilemax(packed, popcnt, y_padded, y_sum, thresh, n_used, min_count,
             kernel, tile_rows, precision="default"):
    """-> per-tile top-3 (tmax, targ, tmax2, targ2, tmax3, targ3, n2, n3,
    cnt), each (P, T); targ* int32 lanes within the tile, n2/n3 the
    multiplicities of the 2nd/3rd values, cnt int32 lanes > thresh.
    R % tile_rows == 0. kernel "triton" runs the fused GPU kernel (it
    sums its own rounded phenotype operand in place of y_sum), "xla" the
    same per-tile reduction (score.tile_top3) over the full scores."""
    if kernel == "triton":
        from .score import score_tilemax_triton
        return score_tilemax_triton(
            packed, popcnt, y_padded, thresh, n_used=n_used,
            min_count=min_count, tile_rows=tile_rows, precision=precision)
    from .score import tile_top3
    sc = _scores_t_xla(packed, popcnt, y_padded, y_sum, n_used, min_count,
                       precision)
    p, r = sc.shape
    assert r % tile_rows == 0
    s3 = sc.reshape(p, r // tile_rows, tile_rows)
    return tile_top3(s3, thresh[:, None, None], axis=2)


def _flush_merge(st: BufferedTopKState, sc, bmax, tile_rows, row_lo, row_hi,
                 cand_k: int, block: int = 16) -> BufferedTopKState:
    """Exact wide merge of (state + buffer + this batch's scores) -> flushed
    state with an updated thresh. Shared by the buffered step's flush and
    the compact step's fallback.

    Three extraction tiers, each guarded by an exactness check (post-merge
    k-th strictly beats everything the extraction left behind): cand_k wide
    (the common fallback), 4*cand_k wide (early stream, where the carried
    k-th is still low), and a full exact blocked top-k (the first batch or
    pathological ties; ~20x the cost of tier 1 — the tiering exists so it
    runs a couple of times per scan, not tens)."""
    k = st.scores.shape[1]
    r = sc.shape[1]

    def merge_with(wv, wlo, whi):
        # concat order fixes tie preference: state (oldest) < buffer (older
        # batches first) < this batch — stable top_k then matches the heap's
        # earliest-wins-on-equal rule
        cat_v = jnp.concatenate([st.scores, st.buf_v, wv], axis=1)
        cat_lo = jnp.concatenate([st.row_lo, st.buf_lo, wlo], axis=1)
        cat_hi = jnp.concatenate([st.row_hi, st.buf_hi, whi], axis=1)
        nv, j = jax.lax.top_k(cat_v, k)
        return (nv, jnp.take_along_axis(cat_lo, j, axis=1),
                jnp.take_along_axis(cat_hi, j, axis=1))

    def tiered(width, deeper):
        wv, wi, w_exact = topk_ops.strided_top_k_from_bmax(
            sc, bmax, width, tile_rows=tile_rows)
        nv, nlo, nhi = merge_with(wv, row_lo[wi], row_hi[wi])
        exact = (w_exact & jnp.all(nv[:, -1] > wv[:, -1])) | (width >= r)
        return jax.lax.cond(exact, lambda _: (nv, nlo, nhi), deeper, None)

    def full(_):
        # contiguous blocked top-k re-reads sc but is tie-exact always
        fv, fi = topk_ops.blocked_top_k(sc, k, block=block)
        return merge_with(fv, row_lo[fi], row_hi[fi])

    k2 = min(max(4 * cand_k, 8192), r)
    nv, nlo, nhi = tiered(min(cand_k, r), lambda _: tiered(k2, full))
    return BufferedTopKState(
        scores=nv, row_lo=nlo, row_hi=nhi,
        buf_v=jnp.full_like(st.buf_v, -jnp.inf),
        buf_lo=jnp.zeros_like(st.buf_lo),
        buf_hi=jnp.zeros_like(st.buf_hi),
        buf_n=jnp.int32(0), thresh=nv[:, -1])


def _flush_state_only(st: BufferedTopKState) -> BufferedTopKState:
    """Merge the candidate buffer into the carried top-k (no batch involved)
    and raise thresh to the new k-th score."""
    k = st.scores.shape[1]
    cat_v = jnp.concatenate([st.scores, st.buf_v], axis=1)
    cat_lo = jnp.concatenate([st.row_lo, st.buf_lo], axis=1)
    cat_hi = jnp.concatenate([st.row_hi, st.buf_hi], axis=1)
    nv, j = jax.lax.top_k(cat_v, k)
    return BufferedTopKState(
        scores=nv,
        row_lo=jnp.take_along_axis(cat_lo, j, axis=1),
        row_hi=jnp.take_along_axis(cat_hi, j, axis=1),
        buf_v=jnp.full_like(st.buf_v, -jnp.inf),
        buf_lo=jnp.zeros_like(st.buf_lo),
        buf_hi=jnp.zeros_like(st.buf_hi),
        buf_n=jnp.int32(0), thresh=nv[:, -1])


TILE_ROWS = 64         # k-mers per tile of the compact step (both kernels)


class CompactParams(NamedTuple):
    """Static compact-step parameters for one device shard."""
    tile_rows: int
    shard_rows: int      # padded rows per device shard per step
    cand_c: int          # tiles kept per column per batch
    cand_c2: int | None  # tiles whose full top-3 is kept (None: all)
    cand_q: int          # narrow-append width
    cand_k: int          # first extraction width of the exact fallback
    buf_cap: int         # candidate buffer slots (a multiple of the widths)


def compact_params(rows_per_shard: int, k: int) -> CompactParams:
    """The compact-step parameters for shards of at least `rows_per_shard`
    rows and a top-k of `k` — the one derivation the single- and
    multi-process scan drivers share. shard_rows rounds rows_per_shard up
    to whole tiles; the buffer holds 16 wide appends."""
    tile = TILE_ROWS
    shard_rows = -(-max(rows_per_shard, 1) // tile) * tile
    cand_c = min(256, k, shard_rows // tile)
    cand_c2 = 64 if cand_c >= 64 else None   # full top-3 only for the
    # hottest 64 tiles (append width c + 2*c2, not 3c)
    width = cand_c + 2 * (cand_c2 or cand_c)
    return CompactParams(
        tile_rows=tile, shard_rows=shard_rows, cand_c=cand_c,
        cand_c2=cand_c2, cand_q=64,
        cand_k=min(max(256, k // 8), k, shard_rows), buf_cap=width * 16)


@functools.partial(jax.jit,
                   static_argnames=("n_used", "min_count", "kernel", "block",
                                    "cand_c", "cand_k", "tile_rows",
                                    "cand_q", "cand_c2", "precision",
                                    "col_group"))
def scan_step_compact(state: BufferedTopKState, packed, popcnt,
                      row_lo, row_hi, y_padded, y_sum, *, n_used: int,
                      min_count: int, kernel: str = "xla", block: int = 16,
                      cand_c: int = 128, cand_k: int = 2048,
                      tile_rows: int = 64, cand_q: int | None = None,
                      cand_c2: int | None = None,
                      precision: str = "default",
                      col_group: int = 128) -> BufferedTopKState:
    """One streamed batch -> buffered top-k state via the compact tile-max
    path (see block comment above). Args as scan_step_buffered, plus
    kernel ("xla" | "triton", see _tilemax) and tile_rows (must divide the
    padded batch rows). The buffer capacity must be a multiple of
    min(cand_c, n_tiles) + 2 * cand_c2. Semantically identical to
    scan_step_buffered: same final top-k, same tie handling.

    precision: precision of the score GEMM. "default": the Triton kernel
    multiplies 0/1 genotypes by bf16-rounded phenotypes with f32
    accumulation, and its scores are exactly the f32 scores of that
    rounded phenotype; the XLA path uses the platform's default f32 matmul
    (TF32 products on the GPU). Selection wobbles only at the top-k
    boundary, and every candidate is exactly re-scored by the LMM stage.
    "highest" is f32-faithful on both (three bf16 phenotype terms in the
    kernel, Precision.HIGHEST in XLA).

    cand_q: optional NARROW append width. The per-batch candidates come
    out sorted descending; whenever the (q+1)-th is already <= thresh, only
    the top q are appended — the dropped tail is <= thresh, so (strict
    displacement rule) it can never enter the final top-k: exact. At steady
    state nearly every batch qualifies, so the buffer fills width/q times
    slower and the expensive flush merge (a (P, K + cap) top_k) amortizes
    over that many more batches. Ignored unless cand_q < width and cand_q
    divides the buffer capacity.

    cand_c2: tiles whose FULL top-3 is captured (<= cand_c; default = all
    kept tiles). 2nd/3rd lanes of kept tiles ranked past c2 are captured
    only if hot — a new exactness condition (their tile's 2nd max <=
    thresh; the 3rd is <= the 2nd) forces the fallback otherwise, which at
    steady state means "> c2 tiles hold multiple hot lanes" — an extreme
    batch. Shrinks the candidate width from 3c to c + 2*c2 (the two-key
    sort is a major share of the post-kernel cost).

    col_group: the exactness guards and the append/fallback decision run
    PER GROUP of <= col_group phenotype columns. With hundreds of
    permutation columns an all-columns AND trips the exact fallback for
    every column whenever ONE column is hot; per-group decisions confine
    the fallback to the offending <= col_group columns (its score
    recompute is chunked to just those columns), so P ~ 1000 scans keep
    the compact fast path for the rest. Groups share the scalar buf_n
    (appends stay lockstep; a falling-back group's slot is filled with
    -inf and its buffer rows are cleared after its merge — dead weight the
    next flush drops), so the state layout, checkpoints, and the sharded
    wrapper are unchanged. col_group >= P reproduces the single-decision
    behavior except that a fallback no longer resets the shared buffer."""
    k = state.scores.shape[1]
    cap = state.buf_v.shape[1]
    rows = packed.shape[0]
    assert rows % tile_rows == 0
    n_tiles = rows // tile_rows
    p = state.scores.shape[0]
    c = min(cand_c, n_tiles)
    c2 = min(cand_c2, c) if cand_c2 else c
    width = c + 2 * c2
    assert cap % width == 0
    q = (cand_q if cand_q and cand_q < width and cap % cand_q == 0
         else None)
    tmax, targ, tmax2, targ2, tmax3, targ3, n2, n3, cnt = _tilemax(
        packed, popcnt, y_padded, y_sum, state.thresh,
        n_used, min_count, kernel, tile_rows, precision)
    if c < n_tiles:
        v_all, ti = jax.lax.top_k(tmax, c + 1)
        v1, ti_c = v_all[:, :c], ti[:, :c]
        excl_ok_c = v_all[:, c] <= state.thresh            # per column
    else:                       # every tile kept: nothing excluded
        v1, ti_c = jax.lax.top_k(tmax, c)
        excl_ok_c = jnp.ones((p,), jnp.bool_)
    v2_full = jnp.take_along_axis(tmax2, ti_c, axis=1)
    v2, v3 = v2_full[:, :c2], jnp.take_along_axis(
        tmax3, ti_c[:, :c2], axis=1)
    g1 = ti_c * tile_rows + jnp.take_along_axis(targ, ti_c, axis=1)
    g2 = ti_c[:, :c2] * tile_rows + jnp.take_along_axis(
        targ2, ti_c[:, :c2], axis=1)
    g3 = ti_c[:, :c2] * tile_rows + jnp.take_along_axis(
        targ3, ti_c[:, :c2], axis=1)
    # c + 2*c2 candidates per batch (top-c2 tiles' top-3, the rest's
    # top-1); sort by (value desc, in-batch lane asc) so equal values keep
    # ascending-row order in the buffer — the heap's earliest-wins tie rule
    cat_v = jnp.concatenate([v1, v2, v3], axis=1)
    cat_g = jnp.minimum(jnp.concatenate([g1, g2, g3], axis=1), rows - 1)
    neg_v, g_s = jax.lax.sort((-cat_v, cat_g), dimension=1, num_keys=2)
    v = -neg_v
    # exact iff: excluded tiles are cold, no tile has > 3 hot lanes, the
    # 2nd/3rd values are unique wherever they are hot, and kept tiles past
    # rank c2 hold no hot 2nd lane (their 2nd/3rd are not captured; a hot
    # one forces the fallback) — all PER COLUMN
    th2 = state.thresh[:, None]
    okc = (excl_ok_c & jnp.all(cnt <= 3, axis=1)
           & jnp.all((tmax2 <= th2) | (n2 == 1), axis=1)
           & jnp.all((tmax3 <= th2) | (n3 == 1), axis=1))
    if c2 < c:
        okc = okc & jnp.all(v2_full[:, c2:] <= th2, axis=1)

    if p <= col_group:
        # single decision group: the r4 path, bit-exact (incl. the
        # buffer-resetting batch fallback)
        ok = jnp.all(okc)
        narrow = (ok & jnp.all(v[:, q] <= state.thresh)) if q \
            else jnp.bool_(False)

        # flush BEFORE appending if the incoming width won't fit; thresh
        # only rises, so the `ok` decision made against the older (lower)
        # thresh stays conservative
        incoming = jnp.where(narrow, q, width) if q else width
        state = jax.lax.cond(state.buf_n + incoming > cap,
                             _flush_state_only, lambda s: s, state)

        # row-id resolution is DEFERRED into the branches: the
        # steady-state narrow append needs only the top q rows, a gather
        # width/q times smaller than the wide append's
        def do_append(st: BufferedTopKState) -> BufferedTopKState:
            at = (jnp.int32(0), st.buf_n)
            return st._replace(
                buf_v=jax.lax.dynamic_update_slice(st.buf_v, v, at),
                buf_lo=jax.lax.dynamic_update_slice(
                    st.buf_lo, row_lo[g_s], at),
                buf_hi=jax.lax.dynamic_update_slice(
                    st.buf_hi, row_hi[g_s], at),
                buf_n=st.buf_n + width)

        def do_append_narrow(st: BufferedTopKState) -> BufferedTopKState:
            at = (jnp.int32(0), st.buf_n)
            g_q = g_s[:, :q]
            return st._replace(
                buf_v=jax.lax.dynamic_update_slice(st.buf_v, v[:, :q], at),
                buf_lo=jax.lax.dynamic_update_slice(
                    st.buf_lo, row_lo[g_q], at),
                buf_hi=jax.lax.dynamic_update_slice(
                    st.buf_hi, row_hi[g_q], at),
                buf_n=st.buf_n + q)

        def do_fallback(st: BufferedTopKState) -> BufferedTopKState:
            # hot batch: recompute full scores and run the exact wide merge
            sc, bmax, tr = _scores_and_bmax(packed, popcnt, y_padded,
                                            y_sum, n_used, min_count,
                                            block, precision, kernel,
                                            tile_rows)
            return _flush_merge(st, sc, bmax, tr, row_lo, row_hi,
                                min(cand_k, sc.shape[1]), block)

        if q:
            return jax.lax.cond(
                ok,
                lambda s: jax.lax.cond(narrow, do_append_narrow,
                                       do_append, s),
                do_fallback, state)
        return jax.lax.cond(ok, do_append, do_fallback, state)

    # ---- per-group decisions (P > col_group; round 5) ----
    groups = [(g0, min(g0 + col_group, p))
              for g0 in range(0, p, col_group)]
    qual = [jnp.all(okc[g0:g1]) for g0, g1 in groups]
    # the narrow decision is SHARED (appends advance buf_n in lockstep);
    # falling-back groups' candidates are merged directly, so only
    # qualifying columns constrain it
    if q:
        nar_c = v[:, q] <= state.thresh                       # (P,)
        narrow = jnp.all(jnp.concatenate(
            [jnp.where(qg, jnp.all(nar_c[g0:g1]), True)[None]
             for qg, (g0, g1) in zip(qual, groups)]))
    else:
        narrow = jnp.bool_(False)
    incoming = jnp.where(narrow, q, width) if q else width
    state = jax.lax.cond(state.buf_n + incoming > cap,
                         _flush_state_only, lambda s: s, state)

    neg_inf_slot = jnp.full((1, width), -jnp.inf, jnp.float32)

    def group_branches(g0, g1):
        gw = g1 - g0

        def sub(arr):
            return jax.lax.dynamic_slice_in_dim(arr, g0, gw, axis=0)

        def writeback(st, g_scores, g_lo, g_hi, g_bv, g_blo, g_bhi, g_th):
            at2 = (jnp.int32(g0), jnp.int32(0))
            return st._replace(
                scores=jax.lax.dynamic_update_slice(st.scores, g_scores, at2),
                row_lo=jax.lax.dynamic_update_slice(st.row_lo, g_lo, at2),
                row_hi=jax.lax.dynamic_update_slice(st.row_hi, g_hi, at2),
                buf_v=jax.lax.dynamic_update_slice(st.buf_v, g_bv, at2),
                buf_lo=jax.lax.dynamic_update_slice(st.buf_lo, g_blo, at2),
                buf_hi=jax.lax.dynamic_update_slice(st.buf_hi, g_bhi, at2),
                thresh=jax.lax.dynamic_update_slice(st.thresh, g_th,
                                                    (jnp.int32(g0),)))

        def append_g(st: BufferedTopKState, w_app) -> BufferedTopKState:
            at = (jnp.int32(g0), st.buf_n)
            g_w = g_s[g0:g1, :w_app]
            return st._replace(
                buf_v=jax.lax.dynamic_update_slice(
                    st.buf_v, v[g0:g1, :w_app], at),
                buf_lo=jax.lax.dynamic_update_slice(
                    st.buf_lo, row_lo[g_w], at),
                buf_hi=jax.lax.dynamic_update_slice(
                    st.buf_hi, row_hi[g_w], at))

        def fallback_g(st: BufferedTopKState) -> BufferedTopKState:
            # recompute ONLY this group's columns' scores, merge
            # state+buffer+batch for the group, clear the group's buffer
            # rows (its pending candidates were consumed; stale slots would
            # double-count)
            sc_g, bmax_g, tr = _scores_and_bmax(
                packed, popcnt, y_padded[:, g0:g1], y_sum[g0:g1],
                n_used, min_count, block, precision, kernel, tile_rows)
            st_g = BufferedTopKState(
                scores=sub(st.scores), row_lo=sub(st.row_lo),
                row_hi=sub(st.row_hi), buf_v=sub(st.buf_v),
                buf_lo=sub(st.buf_lo), buf_hi=sub(st.buf_hi),
                buf_n=st.buf_n, thresh=jax.lax.dynamic_slice_in_dim(
                    st.thresh, g0, gw, axis=0))
            m = _flush_merge(st_g, sc_g, bmax_g, tr, row_lo, row_hi,
                             min(cand_k, sc_g.shape[1]), block)
            return writeback(st, m.scores, m.row_lo, m.row_hi,
                             m.buf_v, m.buf_lo, m.buf_hi, m.thresh)

        return append_g, fallback_g

    for qg, (g0, g1) in zip(qual, groups):
        append_g, fallback_g = group_branches(g0, g1)
        if q:
            state = jax.lax.cond(
                qg,
                lambda s, a=append_g: jax.lax.cond(
                    narrow, lambda s2: a(s2, q), lambda s2: a(s2, width), s),
                fallback_g, state)
        else:
            state = jax.lax.cond(
                qg, lambda s, a=append_g: a(s, width), fallback_g, state)
    # lockstep advance; a fallen-back group's fresh slot is already -inf
    # (its whole buffer rows were cleared by the merge)
    return state._replace(buf_n=state.buf_n + incoming)


@functools.partial(jax.jit,
                   static_argnames=("n_used", "min_count", "block",
                                    "cand_c", "cand_k"))
def scan_step_buffered_multi(state: BufferedTopKState, packed, popcnt,
                             row_lo, row_hi, y_padded, y_sum, *, n_used: int,
                             min_count: int, block: int = 16,
                             cand_c: int = 512,
                             cand_k: int = 2048) -> BufferedTopKState:
    """Chained variant: process B batches in ONE dispatch via lax.scan.

    packed (B, R, W32), popcnt/row_lo/row_hi (B, R). Chaining batches
    amortizes the per-dispatch cost without changing per-batch semantics
    (bitwise-identical state evolution to B sequential scan_step_buffered
    calls)."""

    def body(st, batch):
        pk, pc, lo, hi = batch
        st = scan_step_buffered.__wrapped__(
            st, pk, pc, lo, hi, y_padded, y_sum, n_used=n_used,
            min_count=min_count, block=block,
            cand_c=cand_c, cand_k=cand_k)
        return st, None

    state, _ = jax.lax.scan(body, state, (packed, popcnt, row_lo, row_hi))
    return state


@jax.jit
def flush_buffered(state: BufferedTopKState) -> topk_ops.TopKState:
    """Drain the candidate buffer -> plain TopKState (for finalize/checkpoint)."""
    k = state.scores.shape[1]
    cat_v = jnp.concatenate([state.scores, state.buf_v], axis=1)
    cat_lo = jnp.concatenate([state.row_lo, state.buf_lo], axis=1)
    cat_hi = jnp.concatenate([state.row_hi, state.buf_hi], axis=1)
    nv, j = jax.lax.top_k(cat_v, k)
    return topk_ops.TopKState(scores=nv,
                              row_lo=jnp.take_along_axis(cat_lo, j, axis=1),
                              row_hi=jnp.take_along_axis(cat_hi, j, axis=1))
