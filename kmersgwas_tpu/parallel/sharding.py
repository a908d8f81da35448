"""Multi-device/multi-host scaling of the scan and kinship.

The reference is single-node and file-bound (SURVEY.md §2.5: no MPI/NCCL).
Here the *k-mer axis* — billions of table rows — is the sharding axis:

  * within a host: a 1-D device mesh ("kmers",) — every card reaches
    every other at the same rate, so the mesh follows the algorithm alone.
    Each device scores its row shard and reduces it to K candidates; only
    (P, K) candidates cross the interconnect (all_gather), then every
    device merges identically so the carried top-k state stays replicated.
    Kinship is a shard-local int8 GEMM + `psum`.
  * across hosts: the k-mer space is range-partitioned with the same
    slice boundaries the reference uses (core/codec.py step_bounds); each
    host streams only its contiguous uint62 range of the table, so counts
    and rows never need to move between hosts until the final top-k merge.

The samples axis (N <= a few thousand) is replicated everywhere.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import topk as topk_ops
from ..ops.bitplanes import unpack_bits, unpack_bits_pm1

AXIS = "kmers"


def make_mesh(devices=None) -> Mesh:
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices).reshape(-1), (AXIS,))


def _local_scores(packed, popcnt, y_padded, y_sum, n_used, min_count):
    g = unpack_bits(packed, jnp.float32)
    yigi = jnp.dot(g, y_padded, preferred_element_type=jnp.float32)
    n = jnp.float32(n_used)
    n1 = popcnt[:, None]
    r = n * yigi - n1 * y_sum[None, :]
    denom = n * n1 - n1 * n1
    score = jnp.where(denom > 0, (r * r) / denom, 0.0)
    ok = (n1 >= min_count) & ((n - n1) >= min_count) & (n1 > 0)
    return jnp.where(ok, score, -jnp.inf)


def build_sharded_scan_step(mesh: Mesh, *, n_used: int, min_count: int, k: int):
    """-> jitted (state, packed, popcnt, row_lo, row_hi, yp, ysum) -> state.

    `packed`/`popcnt`/rows are sharded over the k-mer axis; the top-k state
    and phenotypes are replicated. Rows with popcnt == 0 are treated as
    padding (scored -inf), so hosts can pad shards to equal size.
    """

    def local_step(state_sc, state_lo, state_hi, packed, popcnt, lo, hi, yp, ysum):
        scores = _local_scores(packed, popcnt, yp, ysum, n_used, min_count)
        sc = scores.T                                     # (Pph, R_loc)
        kk = min(k, sc.shape[1])
        v, i = topk_ops.blocked_top_k(sc, kk)
        blo, bhi = lo[i], hi[i]
        # ship only candidates across the interconnect
        gv = jax.lax.all_gather(v, AXIS, axis=1, tiled=True)    # (Pph, D*kk)
        glo = jax.lax.all_gather(blo, AXIS, axis=1, tiled=True)
        ghi = jax.lax.all_gather(bhi, AXIS, axis=1, tiled=True)
        cat_v = jnp.concatenate([state_sc, gv], axis=1)
        cat_lo = jnp.concatenate([state_lo, glo], axis=1)
        cat_hi = jnp.concatenate([state_hi, ghi], axis=1)
        nv, j = jax.lax.top_k(cat_v, k)
        return (nv, jnp.take_along_axis(cat_lo, j, axis=1),
                jnp.take_along_axis(cat_hi, j, axis=1))

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(state: topk_ops.TopKState, packed, popcnt, lo, hi, yp, ysum):
        sc, rlo, rhi = sharded(state.scores, state.row_lo, state.row_hi,
                               packed, popcnt, lo, hi, yp, ysum)
        return topk_ops.TopKState(sc, rlo, rhi)

    return step


def init_sharded_buffered_state(mesh: Mesh, n_phenotypes: int, k: int,
                                buf_cap: int, seed_state=None):
    """Per-device BufferedTopKState with a leading device axis (D, ...),
    sharded over the k-mer mesh axis. Each device carries its OWN top-k
    over its row shard; states only meet at finalize_sharded_buffered.

    seed_state: optional resumed TopKState (P, K) merged into device 0 ONLY
    (other devices start empty) so the final cross-device merge stays exact
    without deduplication.
    """
    import numpy as np
    from ..ops import scanstep as ss
    d = mesh.devices.size
    z = np.zeros((d, n_phenotypes, k), np.int32)
    zb = np.zeros((d, n_phenotypes, buf_cap), np.int32)
    scores = np.full((d, n_phenotypes, k), -np.inf, np.float32)
    row_lo, row_hi = z.copy(), z.copy()
    thresh = np.full((d, n_phenotypes), -np.inf, np.float32)
    if seed_state is not None:
        scores[0] = np.asarray(seed_state.scores)
        row_lo[0] = np.asarray(seed_state.row_lo)
        row_hi[0] = np.asarray(seed_state.row_hi)
        thresh[0] = scores[0][:, -1]
    sh = NamedSharding(mesh, P(AXIS))
    put = lambda a: jax.device_put(a, sh)
    return ss.BufferedTopKState(
        scores=put(scores), row_lo=put(row_lo), row_hi=put(row_hi),
        buf_v=put(np.full((d, n_phenotypes, buf_cap), -np.inf, np.float32)),
        buf_lo=put(zb), buf_hi=put(zb.copy()),
        buf_n=put(np.zeros(d, np.int32)),
        thresh=put(thresh))


def build_sharded_scan_step_buffered(mesh: Mesh, *, n_used: int,
                                     min_count: int, block: int = 16,
                                     cand_c: int = 512, cand_k: int = 2048):
    """Multi-device buffered scan step: the XLA score +
    buffered deferred top-k merge (ops/scanstep.scan_step_buffered) running
    independently on every device's row shard under `shard_map`.

    No collectives per step — each device's BufferedTopKState competes only
    within its shard; the exact global top-k emerges at
    `finalize_sharded_buffered` (selection under the total order
    (-score, row) is mergeable, reproducing the reference heap's
    strictly-greater displacement + earliest-row tie rule,
    best_associations_heap.cpp:43-59).

    Inputs per call: state (leading device axis, from
    init_sharded_buffered_state), packed (D*R_loc, W32) / popcnt / row_lo /
    row_hi sharded over the k-mer axis, yp/ysum replicated.
    """
    from ..ops import scanstep as ss

    def local_step(sc, rlo, rhi, bv, blo, bhi, bn, th,
                   packed, popcnt, lo, hi, yp, ysum):
        state = ss.BufferedTopKState(sc[0], rlo[0], rhi[0], bv[0], blo[0],
                                     bhi[0], bn[0], th[0])
        new = ss.scan_step_buffered.__wrapped__(
            state, packed, popcnt, lo, hi, yp, ysum, n_used=n_used,
            min_count=min_count, block=block,
            cand_c=cand_c, cand_k=cand_k)
        return tuple(x[None] for x in new)

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(AXIS),) * 8 + (P(AXIS),) * 4 + (P(), P()),
        out_specs=(P(AXIS),) * 8,
        check_vma=False,
    )

    @jax.jit
    def step(state, packed, popcnt, lo, hi, yp, ysum):
        out = sharded(*state, packed, popcnt, lo, hi, yp, ysum)
        return ss.BufferedTopKState(*out)

    return step


def build_sharded_scan_step_compact(mesh: Mesh, *, n_used: int,
                                    min_count: int, kernel: str = "xla",
                                    block: int = 16, cand_c: int = 256,
                                    cand_k: int = 2048, tile_rows: int = 64,
                                    cand_q: int | None = None,
                                    cand_c2: int | None = None,
                                    precision: str = "default"):
    """THE production multi-device scan step: the compact tile-max kernel +
    deferred top-k buffering (ops/scanstep.scan_step_compact) running
    independently on every device's row shard under `shard_map`. Same
    state/finalize contract as build_sharded_scan_step_buffered: no
    per-step collectives; the exact global top-k emerges at
    `finalize_sharded_buffered`."""
    from ..ops import scanstep as ss

    def local_step(sc, rlo, rhi, bv, blo, bhi, bn, th,
                   packed, popcnt, lo, hi, yp, ysum):
        state = ss.BufferedTopKState(sc[0], rlo[0], rhi[0], bv[0], blo[0],
                                     bhi[0], bn[0], th[0])
        new = ss.scan_step_compact.__wrapped__(
            state, packed, popcnt, lo, hi, yp, ysum, n_used=n_used,
            min_count=min_count, kernel=kernel, block=block,
            cand_c=cand_c, cand_k=cand_k, tile_rows=tile_rows,
            cand_q=cand_q, cand_c2=cand_c2, precision=precision)
        return tuple(x[None] for x in new)

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(AXIS),) * 8 + (P(AXIS),) * 4 + (P(), P()),
        out_specs=(P(AXIS),) * 8,
        check_vma=False,
    )

    @jax.jit
    def step(state, packed, popcnt, lo, hi, yp, ysum):
        out = sharded(*state, packed, popcnt, lo, hi, yp, ysum)
        return ss.BufferedTopKState(*out)

    return step


def _merge_candidates(all_v, all_lo, all_hi, k: int) -> list:
    """(P, D, K+C) candidate planes -> per-phenotype exact top-k under the
    total order (-score, row asc) — the reference heap's effective order
    (strictly-greater displacement + earliest-row ties,
    best_associations_heap.cpp:43-59)."""
    import numpy as np
    from ..ops import topk as topk_ops
    p = all_v.shape[0]
    v_flat = all_v.reshape(p, -1).astype(np.float64)
    rows = topk_ops.decode_rows(all_lo.reshape(p, -1), all_hi.reshape(p, -1))
    out = []
    for j in range(p):
        finite = np.isfinite(v_flat[j])
        v, r = v_flat[j][finite], rows[j][finite]
        order = np.lexsort((r, -v))[:k]
        out.append((v[order], r[order]))
    return out


def finalize_sharded_buffered(state, mesh: Mesh | None = None) -> list:
    """Sharded per-device states -> exact global per-phenotype top-k.

    Flushes every device's candidate buffer into its carried top-k, then
    merges across devices under the heap's total order. Returns the same
    structure as ops.topk.finalize: per phenotype (scores f64 desc,
    rows int64), -inf entries dropped.

    Single-process meshes fetch all shards directly. For MULTI-process
    meshes pass `mesh`: per-device candidates are all_gathered across processes
    so every process holds the full candidate set (the only collective the
    scan ever issues — once, at the end).
    """
    import numpy as np
    if mesh is not None and jax.process_count() > 1:
        import jax.numpy as jnp

        def local(sc, rlo, rhi, bv, blo, bhi, bn, th):
            cat_v = jnp.concatenate([sc[0], bv[0]], axis=1)      # (P, K+C)
            cat_lo = jnp.concatenate([rlo[0], blo[0]], axis=1)
            cat_hi = jnp.concatenate([rhi[0], bhi[0]], axis=1)
            return (jax.lax.all_gather(cat_v, AXIS),             # (D, P, K+C)
                    jax.lax.all_gather(cat_lo, AXIS),
                    jax.lax.all_gather(cat_hi, AXIS))

        gathered = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(P(AXIS),) * 8,
            out_specs=(P(),) * 3, check_vma=False))(*state)
        gv, glo, ghi = (np.asarray(x.addressable_shards[0].data)
                        for x in gathered)
        k = state.scores.shape[2]
        return _merge_candidates(gv.transpose(1, 0, 2), glo.transpose(1, 0, 2),
                                 ghi.transpose(1, 0, 2), k)

    sc = np.asarray(state.scores, np.float64)        # (D, P, K)
    lo = np.asarray(state.row_lo)
    hi = np.asarray(state.row_hi)
    bv = np.asarray(state.buf_v, np.float64)         # (D, P, C)
    blo = np.asarray(state.buf_lo)
    bhi = np.asarray(state.buf_hi)
    d, p, k = sc.shape
    return _merge_candidates(
        np.concatenate([sc, bv], axis=2).transpose(1, 0, 2),
        np.concatenate([lo, blo], axis=2).transpose(1, 0, 2),
        np.concatenate([hi, bhi], axis=2).transpose(1, 0, 2), k)


def build_sharded_kinship_accumulate(mesh: Mesh):
    """PRODUCTION sharded kinship accumulate: -> jitted
    (accs (D, Npad, Npad) int32 sharded, packed (R, W32) sharded,
    valid (R,) int8 sharded) -> accs.

    No per-step collectives: each device owns a partial A^T A over its row
    shard (invalid/padding rows zeroed — exact, see
    ops.kinship.kinship_accumulate_masked); the partials are summed on the
    host at flush time (pipeline/kinship.ShardedKinshipAccumulator), where
    the int64 spill lives anyway. Reference semantics:
    src/kmers_multiple_databases.cpp:418-438."""
    from ..ops.kinship import kinship_accumulate_masked

    def local(acc, packed, valid):
        return kinship_accumulate_masked.__wrapped__(acc[0], packed,
                                                     valid)[None]

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P(AXIS), check_vma=False))


def build_sharded_kinship_step(mesh: Mesh):
    """-> jitted (acc (Npad,Npad) int32 replicated, packed sharded) -> acc.

    Each device computes its shard's A^T A as an int8 GEMM; `psum` over the
    k-mer axis keeps the accumulator replicated. All-zero padding rows must
    be EXCLUDED upstream (they are not neutral under the ±1 encoding) —
    shards must carry exact row counts.
    """

    def local(acc, packed):
        a = unpack_bits_pm1(packed)
        part = jax.lax.dot_general(a, a, (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        return acc + jax.lax.psum(part, AXIS)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(AXIS)), out_specs=P(),
        check_vma=False))


def shard_batch(mesh: Mesh, arrays, pad_value=0):
    """Place host arrays onto the mesh, sharded over the leading axis
    (padded to a multiple of the mesh size with `pad_value`)."""
    import numpy as np
    d = mesh.devices.size
    out = []
    for a in arrays:
        a = np.asarray(a)
        r = a.shape[0]
        rp = ((r + d - 1) // d) * d
        if rp != r:
            pad = np.full((rp - r, *a.shape[1:]), pad_value, dtype=a.dtype)
            a = np.concatenate([a, pad], axis=0)
        out.append(jax.device_put(a, NamedSharding(mesh, P(AXIS))))
    return out


def replicate(mesh: Mesh, *arrays):
    return [jax.device_put(a, NamedSharding(mesh, P())) for a in arrays]


def host_range_of_kmer_space(host_id: int, n_hosts: int, kmer_len: int):
    """Contiguous uint62 k-mer range owned by `host_id` for cross-host sharding,
    cut at the reference's slice boundaries so per-host table shards can be
    built independently and byte-identically."""
    from ..core.codec import step_bounds
    bounds = step_bounds(n_hosts, kmer_len)
    lo = 0 if host_id == 0 else int(bounds[host_id - 1])
    hi = int(bounds[host_id])
    return lo, hi
