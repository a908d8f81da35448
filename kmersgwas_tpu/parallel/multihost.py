"""Multi-process orchestration of the scan and kinship.

Topology (SURVEY.md §2.5 mapping): the k-mer axis is range-partitioned
across PROCESSES at the reference's slice boundaries (the network never
carries table rows), and within each global batch the rows are sharded
across every DEVICE of the global mesh (the interconnect carries only top-k
candidates / kinship totals).

Each process:
  1. `init_distributed(...)` — jax.distributed handshake. Processes that
     share a host each see only their own card through
     CUDA_VISIBLE_DEVICES (a JAX process reserves most of every card it
     opens)
  2. finds its contiguous row span of the sorted `.table` via
     `host_row_span` (binary search on the memory-mapped k-mer column)
  3. streams its span; `make_global_batch` assembles the per-process
     arrays into one globally-sharded array per step (every process must
     call in lockstep, SPMD-style)
  4. the sharded scan step (parallel/sharding.py) merges candidates across
     all devices; the final state is replicated, so any host can export.

Single-host multi-device works identically (the span is the whole table).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import formats
from ..core.table import KmersTableReader
from ..utils import drain as utils_drain
from .sharding import AXIS


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()).reshape(-1), (AXIS,))


def _bisect_col0_right(mm: np.ndarray, stride: int, n_rows: int,
                       value: int) -> int:
    """searchsorted(..., side="right") on the k-mer column of a memmapped
    row-major table WITHOUT materializing the column: numpy's searchsorted on
    a strided memmap view makes a contiguous copy (the whole file read into
    RAM); element-wise bisection touches only O(log n) pages."""
    value = np.uint64(value)
    lo, hi = 0, n_rows
    while lo < hi:
        mid = (lo + hi) // 2
        if mm[mid * stride] <= value:
            lo = mid + 1
        else:
            hi = mid
    return lo


def host_row_span(table_base: str, host_id: int, n_hosts: int):
    """-> (start_row, end_row) of this host's contiguous k-mer range.

    The table is sorted by k-mer code, so the reference's range-partition
    boundaries (core/codec.step_bounds) become contiguous row spans found by
    binary search over the memory-mapped k-mer column (O(log n) element
    reads — a 10^10-row table costs ~35 page touches, not an 80 GB copy).
    """
    reader = KmersTableReader(table_base)
    if n_hosts <= 1:
        return 0, reader.n_rows_total
    from .sharding import host_range_of_kmer_space
    lo_k, hi_k = host_range_of_kmer_space(host_id, n_hosts,
                                          reader.header.kmer_len)
    wf = reader.header.row_words()
    mm = np.memmap(reader.base + ".table", dtype="<u8", mode="r",
                   offset=formats.TableHeader.HEADER_BYTES)
    stride = 1 + wf
    n_rows = reader.n_rows_total
    start = (_bisect_col0_right(mm, stride, n_rows, lo_k) if host_id else 0)
    end = _bisect_col0_right(mm, stride, n_rows, hi_k)
    return start, end


def make_global_batch(mesh: Mesh, local_arrays, pad_value=0):
    """Per-process host arrays -> globally sharded device arrays.

    Every process contributes its local rows; the global array is the
    concatenation over processes, sharded over the k-mer axis. Rows are
    padded per-process to a common multiple of the local device count.
    All processes must call this in lockstep with equal local row counts
    (pad upstream to the fixed global batch size / n_processes).
    """
    out = []
    sharding = NamedSharding(mesh, P(AXIS))
    for a in local_arrays:
        a = np.asarray(a)
        out.append(jax.make_array_from_process_local_data(sharding, a))
    return out


def replicated(mesh: Mesh, *arrays):
    sharding = NamedSharding(mesh, P())
    return [jax.make_array_from_process_local_data(sharding, np.asarray(a))
            for a in arrays]


def init_global_buffered_state(mesh: Mesh, n_phenotypes: int, k: int,
                               buf_cap: int):
    """Multi-process variant of sharding.init_sharded_buffered_state: each
    process materializes only its local device shards and assembles the
    global (D, ...) arrays with make_array_from_process_local_data."""
    from ..ops import scanstep as ss
    d_loc = len([d for d in mesh.devices.ravel()
                 if d.process_index == jax.process_index()])
    sharding = NamedSharding(mesh, P(AXIS))

    def put(local):
        return jax.make_array_from_process_local_data(sharding, local)

    z = np.zeros((d_loc, n_phenotypes, k), np.int32)
    zb = np.zeros((d_loc, n_phenotypes, buf_cap), np.int32)
    return ss.BufferedTopKState(
        scores=put(np.full((d_loc, n_phenotypes, k), -np.inf, np.float32)),
        row_lo=put(z), row_hi=put(z.copy()),
        buf_v=put(np.full((d_loc, n_phenotypes, buf_cap), -np.inf,
                          np.float32)),
        buf_lo=put(zb), buf_hi=put(zb.copy()),
        buf_n=put(np.zeros(d_loc, np.int32)),
        thresh=put(np.full((d_loc, n_phenotypes), -np.inf, np.float32)))


def _local_state_blocks(state):
    """Sharded BufferedTopKState -> dict of this process's local shard
    arrays (concatenated over local devices along the leading axis)."""
    out = {}
    for f in state._fields:
        arr = getattr(state, f)
        blocks = [np.asarray(sh.data) for sh in arr.addressable_shards]
        out[f] = np.concatenate(blocks, axis=0)
    return out


def _span_dtable(table_base: str, cache_base: str, names_to_use,
                 min_count: int, n_used: int, pid: int, n_proc: int,
                 span_lo: int, span_hi: int, rebuild_stale: bool = True):
    """Per-process device-native cache of this host's k-mer span, built on
    first use. Multi-process caches carry the filter AND the topology in
    the filename (`<base>.mc<min_count>.p<pid>of<nproc>`) so the kinship
    stage (MAF-only filter) and the scan stage (MAC filter) of one
    `gwas-mp` run never clobber each other's caches, and a resized cluster
    gets fresh span caches instead of silently mis-spanned ones."""
    import os as _os
    from ..core import dtable as dt_mod
    my_cache = (f"{cache_base}.mc{min_count}.n{n_used}.p{pid}of{n_proc}"
                if n_proc > 1 else str(cache_base))
    used_names = (list(names_to_use) if names_to_use is not None
                  else formats.read_names(table_base))
    nhash = dt_mod.names_hash_of(used_names)
    dt = dt_mod.open_cache(my_cache, min_count=min_count, n_used=n_used,
                           names_hash=nhash)
    if dt is not None:
        return dt
    if _os.path.exists(my_cache) and not rebuild_stale:
        # stale cache (different filter/subset/legacy header): the
        # plain-named (single-process) cache may belong to another stage —
        # leave it alone unless the caller owns it (kinship_from_table
        # semantics)
        return None
    dt_mod.build_dtable(table_base, my_cache, names_to_use=names_to_use,
                        min_count=min_count,
                        start_row=span_lo, end_row=span_hi)
    return dt_mod.DTableReader(my_cache)


def _union_patterns_across_processes(patterns, chunk: int = 1 << 22) -> int:
    """Cross-process union of per-process distinct pattern-hash sets.

    Pattern hashes are shard-local (each table row lives on exactly one
    process), but the SAME presence/absence pattern can occur in several
    spans, so the global distinct count needs a set union. The union runs in
    BOUNDED fixed-size rounds: each round allgathers one `chunk`-hash slice
    of every process's sorted array and merges it into a running sorted
    union, so peak extra host memory is O(n_proc * chunk * 8B) + the union
    itself — never the O(n_proc * max_set) full padded matrix, which at
    1e8-1e9 distinct patterns would be multi-GB per host at the very end of
    a long scan (ADVICE r4). Collectives happen at the very end only
    (reference semantics: src/kmers_multiple_databases.cpp:377-380)."""
    from jax.experimental import multihost_utils
    local = patterns.sorted_hashes()      # chunk: 32 MB/process/round
    lens = np.asarray(multihost_utils.process_allgather(
        np.int64(len(local)))).ravel()
    mx = int(lens.max())
    if mx == 0:
        return 0
    merged = np.empty(0, np.uint64)
    for s in range(0, mx, chunk):
        width = min(chunk, mx - s)
        padded = np.zeros(width, np.uint64)
        take = local[s:s + width]
        padded[:len(take)] = take
        gathered = np.asarray(multihost_utils.process_allgather(padded))
        gathered = gathered.reshape(len(lens), width)
        pieces = [gathered[i, :max(0, min(int(n) - s, width))]
                  for i, n in enumerate(lens)]
        merged = np.union1d(merged, np.concatenate(pieces)) \
            if any(len(p) for p in pieces) else merged
    return len(merged)


def run_distributed_scan(table_base: str, pheno_accessions, pheno_values,
                         pheno_names, *, kmer_len: int, n_top: int = 10001,
                         maf: float = 0.05, mac: int = 5,
                         batch_size: int = 2_000_000,
                         first_phenotype_top: int | None = None,
                         count_patterns: bool = False,
                         dtable_cache: str | None = None,
                         score_precision: str = "default",
                         checkpoint_path: str | None = None,
                         checkpoint_every: int = 20, progress=None):
    """PRODUCT multi-process scan driver: every participating process calls
    this in lockstep AFTER init_distributed(). Returns (per_pheno,
    n_tested, n_patterns) — per-phenotype merged (scores, rows) lists (the
    finalize all_gather replicates candidates on every process), the global
    MAC-passing count, and the global distinct-pattern count (None unless
    count_patterns).

    Full feature parity with the single-process `associate`
    (src/associate_kmers.cpp:92-96,130-132):
      first_phenotype_top — larger top-k for column 0 (--first_phenotype_best)
      count_patterns      — global distinct presence/absence patterns
      dtable_cache        — per-process device-native cache of this host's
                            span (`<cache>.mc<minc>.n<nused>.p<pid>of<nproc>`,
                            see _span_dtable), built on first use;
                            subsequent runs stream memmap slices with no
                            host-side squeeze work
      score_precision     — "default" | "highest" score GEMM precision

    Topology: this process streams ONLY its contiguous k-mer range of the
    sorted table (host_row_span — the network never carries table rows);
    within a
    global step the rows shard across all devices of the global mesh and
    the compact per-device top-k state never communicates until finalize.
    The step count is DYNAMIC: before each dispatch the processes allgather
    a had-data byte and stop as soon as every stream is exhausted — no dead
    lockstep steps when MAC filtering (or skewed spans) shrink some spans
    (the device path stays collective-free; this is one host-side scalar
    sync per step). The table must be visible on every host's filesystem
    (the reference's shared-FS model, SURVEY.md §2.5).

    checkpoint_path: per-process checkpoints (`<path>.p<pid>`) of the raw
    local top-k state shards + span position, stamped with a topology
    fingerprint (n_proc, span bounds, table rows, state shape) — resuming
    under a DIFFERENT topology is refused rather than silently mis-scanning.
    Per-process states never interact until finalize, so each process
    resumes its own span exactly."""
    import math as _math
    from ..core.table import KmersTableReader
    from ..ops import score as score_ops
    from ..ops import topk as topk_ops
    from ..pipeline import checkpoint as ckpt
    from ..ops import scanstep as ss
    from ..pipeline.scan import _PatternCounter
    from ..utils import pick_kernel
    from . import sharding as shard_mod

    mesh = global_mesh()
    n_proc = jax.process_count()
    pid = jax.process_index()
    n_dev = mesh.devices.size

    reader = KmersTableReader(table_base, names_to_use=pheno_accessions)
    n_used = reader.n_used
    min_count = max(int(mac), _math.ceil(n_used * maf))
    n_pad = reader.w32 * 32
    pheno_values = np.asarray(pheno_values)
    p = pheno_values.shape[1]
    k_eff = max(n_top, first_phenotype_top or 0)
    patterns = _PatternCounter() if count_patterns else None

    # per-process slice of each global batch, padded so every DEVICE shard
    # is a whole number of kernel tiles
    d_loc = max(1, n_dev // n_proc)
    cp = ss.compact_params(-(-max(batch_size // n_proc, 1) // d_loc), k_eff)
    local_rows = cp.shard_rows * d_loc

    my_lo, my_hi = host_row_span(table_base, pid, n_proc)
    stream_tag = "dtable" if dtable_cache else "table"
    meta = {"n_proc": n_proc, "span_lo": my_lo, "span_hi": my_hi,
            "table_rows": reader.n_rows_total, "k_eff": k_eff,
            "n_pheno": p, "n_used": n_used}

    dt = None
    if dtable_cache:
        dt = _span_dtable(table_base, dtable_cache, pheno_accessions,
                          min_count, n_used, pid, n_proc, my_lo, my_hi)

    my_ckpt = f"{checkpoint_path}.p{pid}.npz" if checkpoint_path else None
    resumed = None
    if my_ckpt:
        import os as _os
        if _os.path.exists(my_ckpt):
            z = np.load(my_ckpt)
            if bytes(z["stream"]).decode() == stream_tag:
                ckpt.check_meta(z, meta, my_ckpt)
                resumed = z
    span_start = 0 if dt is not None else my_lo
    start_row = int(resumed["next_row"]) if resumed is not None else span_start
    start_row = max(start_row, span_start)
    n_tested_local = int(resumed["n_tested"]) if resumed is not None else 0

    yp, ysum = score_ops.prepare_phenotypes(
        np.asarray(pheno_values, np.float32), n_pad)
    ypr, ysr = replicated(mesh, np.asarray(yp), np.asarray(ysum))
    state = init_global_buffered_state(mesh, p, k_eff, buf_cap=cp.buf_cap)
    if resumed is not None:
        from ..ops import scanstep as _ss
        sh = NamedSharding(mesh, P(AXIS))
        state = _ss.BufferedTopKState(*[
            jax.make_array_from_process_local_data(sh, resumed[f])
            for f in _ss.BufferedTopKState._fields])
    step = shard_mod.build_sharded_scan_step_compact(
        mesh, n_used=n_used, min_count=min_count, kernel=pick_kernel(),
        cand_c=cp.cand_c, cand_k=cp.cand_k, tile_rows=cp.tile_rows,
        cand_q=cp.cand_q, cand_c2=cp.cand_c2, precision=score_precision)

    if dt is not None:
        batches = ((pl_, pc_, rw_, s_ + len(rw_)) for s_, pl_, pc_, rw_
                   in dt.iter_batches(local_rows, start_row=start_row))
    else:
        batches = ((b.packed, b.popcnt, b.row_index,
                    int(b.row_index[-1]) + 1) for b
                   in reader.iter_batches(local_rows, min_count,
                                          start_row=start_row,
                                          end_row=my_hi))

    if n_proc > 1:
        from jax.experimental import multihost_utils

        def any_has_data(flag: bool) -> bool:
            return bool(np.asarray(multihost_utils.process_allgather(
                np.int8(flag))).any())
    else:
        def any_has_data(flag: bool) -> bool:
            return flag

    from collections import deque
    _inflight: deque = deque()
    next_pos = start_row
    step_i = 0
    exhausted = False
    while True:
        if exhausted:
            bp = np.zeros((0, reader.w32), np.uint32)
            bpc = np.zeros(0, np.float32)
            brows = np.zeros(0, np.int64)
        else:
            try:
                bp, bpc, brows, bnext = next(batches)
            except StopIteration:
                exhausted = True
                bp = np.zeros((0, reader.w32), np.uint32)
                bpc = np.zeros(0, np.float32)
                brows = np.zeros(0, np.int64)
        r = len(brows)
        # dynamic lockstep termination: stop once EVERY process's stream is
        # exhausted; processes that finish early keep dispatching padded
        # empty shards so the SPMD step count stays identical everywhere
        if not any_has_data(r > 0):
            break
        n_tested_local += r
        if r and patterns is not None:
            patterns.add(np.ascontiguousarray(bp))
        packed = np.zeros((local_rows, reader.w32), np.uint32)
        packed[:r] = bp
        popcnt = np.zeros(local_rows, np.float32)
        popcnt[:r] = bpc
        rows = np.zeros(local_rows, np.int64)
        rows[:r] = brows
        lo, hi = topk_ops.encode_rows(rows)
        gp, gpc, glo, ghi = make_global_batch(mesh,
                                              [packed, popcnt, lo, hi])
        state = step(state, gp, gpc, glo, ghi, ypr, ysr)
        # bounded dispatch pipeline (see pipeline/scan.py): draining to the
        # state from a few steps back releases all older batches' buffers —
        # an unthrottled async backend otherwise accumulates every queued
        # batch host-side (OOM at 400M rows, single-process scan).
        # utils.drain = one-element local-shard fetch
        _inflight.append(state.buf_n)
        if len(_inflight) > 4:
            utils_drain(_inflight.popleft())
        if r:
            next_pos = bnext
        step_i += 1
        if my_ckpt and step_i % checkpoint_every == 0:
            blocks = _local_state_blocks(state)
            blocks.update(next_row=np.int64(next_pos),
                          n_tested=np.int64(n_tested_local),
                          stream=np.bytes_(stream_tag.encode()),
                          **ckpt.meta_arrays(meta))
            tmp = my_ckpt + ".tmp.npz"
            np.savez(tmp, **blocks)
            import os as _os
            _os.replace(tmp, my_ckpt)
        if progress is not None:
            progress(r)

    per_pheno = shard_mod.finalize_sharded_buffered(state, mesh)
    per_pheno = [(sc[:first_phenotype_top if (j == 0 and first_phenotype_top)
                     else n_top],
                  rw[:first_phenotype_top if (j == 0 and first_phenotype_top)
                     else n_top])
                 for j, (sc, rw) in enumerate(per_pheno)]
    n_patterns = None
    if patterns is not None:
        n_patterns = (_union_patterns_across_processes(patterns)
                      if n_proc > 1 else patterns.count)
    if n_proc > 1:      # global MAC-passing count: one scalar allgather
        from jax.experimental import multihost_utils
        n_tested = int(multihost_utils.process_allgather(
            np.int64(n_tested_local)).sum())
    else:
        n_tested = n_tested_local
    return per_pheno, n_tested, n_patterns


def run_distributed_kinship(table_base: str, *, maf: float = 0.05,
                            batch_size: int = 1 << 20, names_to_use=None,
                            dtable_cache: str | None = None,
                            checkpoint_path: str | None = None,
                            checkpoint_every: int = 50, progress=None):
    """PRODUCT multi-process kinship: every participating process calls this
    in lockstep after init_distributed(). Each process streams ONLY its
    contiguous k-mer range (host_row_span) and accumulates per-DEVICE int32
    partials over its local devices (the same masked-padding accumulate as
    the single-process mesh path); the (n, n) int64 totals — the only data
    that ever crosses the network — are summed across processes at the end. Returns
    the normalized kinship, identical on every process.

    checkpoint_path: per-process checkpoints (`<path>.p<pid>`) let a
    crashed host resume from its last saved span position while the others
    rerun independently — totals only combine at the end, so per-process
    restartability is exact.

    Reference: src/emma_kinship_kmers.cpp:77-111 (the ~5-day stage)."""
    import math as _math
    from ..core.table import KmersTableReader
    from . import sharding as shard_mod

    mesh = global_mesh()
    n_proc = jax.process_count()
    pid = jax.process_index()

    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    n_used = reader.n_used
    n_pad = reader.w32 * 32
    min_count = _math.ceil(n_used * maf)
    my_lo, my_hi = host_row_span(table_base, pid, n_proc)

    d_loc = len(jax.local_devices())
    local_mesh = Mesh(np.array(jax.local_devices()).reshape(-1), (AXIS,))
    from ..pipeline.kinship import (KinshipAccumulator,
                                   ShardedKinshipAccumulator)
    if d_loc > 1:
        acc = ShardedKinshipAccumulator(n_used=n_used, n_pad=n_pad,
                                        mesh=local_mesh)
    else:
        acc = KinshipAccumulator(n_used=n_used, n_pad=n_pad)

    dt = None
    if dtable_cache:
        dt = _span_dtable(table_base, dtable_cache, names_to_use,
                          min_count, n_used, pid, n_proc, my_lo, my_hi,
                          rebuild_stale=n_proc > 1)
    stream_tag = "dtable" if dt is not None else "table"

    from ..pipeline import checkpoint as ckpt
    my_ckpt = f"{checkpoint_path}.p{pid}" if checkpoint_path else None
    # topology fingerprint: resuming a span checkpoint under a different
    # partitioning (or table) would double- or under-count rows silently —
    # load_kinship_state refuses on mismatch (ADVICE r3)
    meta = {"n_proc": n_proc, "span_lo": my_lo, "span_hi": my_hi,
            "table_rows": reader.n_rows_total, "n_used": n_used}
    start_row = 0 if dt is not None else my_lo
    if my_ckpt:
        resumed = ckpt.load_kinship_state(my_ckpt, stream=stream_tag,
                                          meta=meta)
        if resumed is not None:
            acc.total, acc.n_rows, start_row = resumed
            start_row = max(start_row, 0 if dt is not None else my_lo)

    import jax.numpy as jnp
    if dt is not None:
        # span dtable: rows already MAC-filtered + packed; checkpoint
        # positions are DTABLE row indices (stream-tagged)
        batches = ((np.ascontiguousarray(pl_), s_ + len(rw_), len(rw_))
                   for s_, pl_, pc_, rw_ in
                   dt.iter_batches(batch_size, start_row=start_row))
    else:
        batches = ((batch.packed, int(batch.row_index[-1]) + 1,
                    batch.n_rows)
                   for batch in reader.iter_batches(
                       batch_size, min_count, start_row=start_row,
                       end_row=my_hi))
    from collections import deque
    _inflight: deque = deque()
    batch_i = 0
    for packed, next_pos, r in batches:
        if r == 0:
            continue
        acc.add(np.asarray(packed) if d_loc > 1 else jnp.asarray(packed))
        # bounded dispatch pipeline (see pipeline/scan.py): one-element
        # local-shard fetch
        _inflight.append(acc.device_acc)
        if len(_inflight) > 4:
            utils_drain(_inflight.popleft())
        batch_i += 1
        if my_ckpt and batch_i % checkpoint_every == 0:
            acc.flush()
            ckpt.save_kinship_state(my_ckpt, acc.total, acc.n_rows,
                                    next_pos, stream=stream_tag, meta=meta)
        if progress is not None:
            progress(r)
    acc.flush()

    total, n_rows = acc.total, acc.n_rows
    if n_proc > 1:
        from jax.experimental import multihost_utils
        total = np.asarray(multihost_utils.process_allgather(
            total.astype(np.float64))).sum(axis=0).astype(np.int64)
        n_rows = int(multihost_utils.process_allgather(
            np.int64(n_rows)).sum())
    if n_rows == 0:
        raise ValueError("no k-mers accumulated into kinship")
    xnor = (n_rows + total) / 2.0
    K = xnor / float(n_rows)
    np.fill_diagonal(K, 1.0)
    return K
