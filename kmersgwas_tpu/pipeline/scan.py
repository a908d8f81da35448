"""Association scan driver: stream the k-mers table through the device.

End-to-end equivalent of the `associate_kmers` binary (src/associate_kmers.cpp):

  PASS 1 (reference): batch-load table -> thread pool scores each phenotype
          column -> per-phenotype CPU heaps.
  HERE:   batch-load table -> one (R,N)x(N,P) GEMM scores ALL phenotype
          columns -> device-resident streaming top-k (ops/topk.py).

  PASS 2 (reference): re-stream the whole table to export winners' rows.
  HERE:   winners' absolute row indices are known, so their rows are fetched
          by random access into the memory-mapped .table — no second pass.

Winner naming matches the reference bim convention: `<kmer>_<rank>` where
rank 1 = best score (best_associations_heap.cpp:110-127 pops ascending and
labels with the remaining heap size), and bed rows are written in table-row
order like the reference's sequential pass 2.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


def _merged_to_topk(per_pheno, p: int, k: int):
    """Merged per-phenotype (scores, rows) lists -> a padded TopKState
    (host arrays) usable as a resume seed / checkpoint payload."""
    from ..ops import topk as topk_ops
    scores = np.full((p, k), -np.inf, np.float32)
    rows = np.zeros((p, k), np.int64)
    for j, (v, r) in enumerate(per_pheno):
        n = min(k, len(v))
        scores[j, :n] = v[:n]
        rows[j, :n] = r[:n]
    lo, hi = topk_ops.encode_rows(rows.ravel())
    return topk_ops.TopKState(scores=scores,
                              row_lo=lo.reshape(p, k),
                              row_hi=hi.reshape(p, k))

from ..core import codec, formats
from ..core.table import KmersTableReader
from ..ops import score as score_ops
from ..ops import topk as topk_ops


@dataclass
class ScanResult:
    names: list                     # phenotype column names
    scores: list                    # per phenotype: (K,) float64 descending
    rows: list                      # per phenotype: (K,) int64 table rows
    kmers: list                     # per phenotype: (K,) uint64 codes
    n_tested: int                   # MAC-passing k-mers scored
    n_patterns: int | None = None   # unique presence/absence patterns
    pa_rows: object = field(default_factory=dict)  # RowLookup: row -> packed
                                    # uint64 PA words over the used columns
    timings: dict = field(default_factory=dict)  # sub-stage seconds: stream
                                    # (feed+dispatch loop), finalize (state
                                    # fetch + merge), fetch (winner rows)
    certified: list | None = None   # certify_topk: per-column bool — True
                                    # = the selected set is PROVEN equal to
                                    # the exact-score top-k (see
                                    # certify_column)


CERTIFY_BAND = 1024      # extra top-k slots carried for certify_topk: must
                         # out-span the boundary rank-width of the assumed
                         # error (tools/prof_r5_certify.py measures the
                         # boundary crossings at flagship shape)
CERTIFY_SIGMAS = 6.0     # standard deviations of the default precision's
                         # score error that certify_eps allows for
CERTIFY_EPS_FLOOR = 1e-4  # f32 rounding of the scores themselves (the
                          # cancellation in N*yigi - N1*sum(y))


def certify_eps(y_col, n_used: int, t: float, precision: str = "default"
                ) -> float:
    """Relative score-error bound assumed at score t of one phenotype
    column: CERTIFY_SIGMAS standard deviations of the scan's score error
    there, at least CERTIFY_EPS_FLOOR.

    At the default precision a row's score is the exact score of the
    phenotype rounded to bf16 (ops/score.py), so with e = bf16(y) - y its
    r = N*yigi - N1*sum(y) moves by N * sum_i (e_i - mean(e)) g_i. Over the
    rows carrying N1 of the N samples that sum has variance
    N1 (N - N1) / (N (N - 1)) * sum_i (e_i - mean(e))^2, and a row scoring t
    has r^2 = t N1 (N - N1), so the relative score error 2 dr/r has
    standard deviation 2 sqrt(N sum_i (e_i - mean(e))^2 / ((N - 1) t)),
    whatever N1. "highest" leaves only the floor."""
    if t <= 0:
        return CERTIFY_EPS_FLOOR
    y = np.asarray(y_col, np.float32)
    if precision == "default":
        e = y.astype(jnp.bfloat16).astype(np.float64) - y.astype(np.float64)
    else:
        e = np.zeros(len(y))
    ss = float(np.sum((e - e.mean()) ** 2))
    sigma = 2.0 * math.sqrt(n_used * ss / ((n_used - 1) * t))
    return max(CERTIFY_SIGMAS * sigma, CERTIFY_EPS_FLOOR)


def certify_column(def_scores, rows, exact_scores, cap: int, eps: float):
    """Exact-selection certificate for one phenotype column.

    The scan selected `rows` (top-(cap+B) by DEFAULT-precision scores,
    descending `def_scores`); `exact_scores` are their f64 re-scores from
    raw genotype bits. Returns (order, certified):

      order     — indices selecting the exact top-`cap` among the carried
                  candidates, ranked by (exact score desc, row asc) — the
                  reference heap's tie rule with its double-precision
                  epilogue (src/kmers_multiple_databases.cpp:358-362);
      certified — True iff this set is certified equal to the global
                  exact-score top-cap: any row NOT carried has default
                  score <= t = def_scores[-1], hence exact score
                  <= t*(1+eps) (eps from certify_eps: six standard
                  deviations of the score error at t); if the cap-th exact
                  score inside the carried set strictly exceeds that bound,
                  no dropped row can displace — the set is exact. False
                  means the band was too narrow (widen or rerun
                  --score_precision highest), NOT that the set is wrong.
    """
    m = len(rows)
    order = np.lexsort((np.asarray(rows), -np.asarray(exact_scores)))
    if m <= cap:
        return order, True          # everything the scan saw is carried
    t = float(def_scores[-1])
    s_star = float(exact_scores[order[cap - 1]])
    return order[:cap], s_star > t * (1.0 + eps)


def effective_min_count(n_accessions: int, maf: float, mac: int) -> int:
    """max(mac, ceil(maf * n)) — associate_kmers.cpp:98-102."""
    return max(int(mac), math.ceil(n_accessions * maf))


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` on a background thread, buffering `depth` items, so
    host-side batch prep (read + squeeze + pad) overlaps device compute."""
    import queue
    import threading
    q = queue.Queue(maxsize=depth)
    _END = object()
    err = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:   # propagate into the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    t.join()
    if err:
        raise err[0]


class _PatternCounter:
    """Streaming distinct-pattern counter (pattern hash per row, merged sets),
    equivalent of update_presence_absence_pattern_counter
    (kmers_multiple_databases.cpp:377-380).

    Per-batch cost is one hash + sort of the batch (the reference's hash-set
    insert is O(rows) amortized); merging into the global set is DEFERRED:
    batch uniques collect in a pending list that is compacted into the
    sorted master only when it reaches a fraction of the master's size, so
    the total merge work over a stream with U uniques is O(U log U), not
    O(batches * U) as a per-batch union1d would be."""

    def __init__(self):
        self._sorted = np.empty(0, dtype=np.uint64)
        self._pending: list = []
        self._pending_n = 0

    def add(self, packed_u32: np.ndarray) -> None:
        w64 = np.ascontiguousarray(packed_u32).view("<u8")
        h = np.unique(codec.pattern_hash(w64))
        self._pending.append(h)
        self._pending_n += len(h)
        if self._pending_n >= max(1 << 20, len(self._sorted) >> 2):
            self._compact()

    def _compact(self) -> None:
        if self._pending:
            self._sorted = np.unique(
                np.concatenate([self._sorted, *self._pending]))
            self._pending = []
            self._pending_n = 0

    @property
    def count(self) -> int:
        self._compact()
        return len(self._sorted)

    def sorted_hashes(self) -> np.ndarray:
        """The full sorted distinct-hash array — the multi-process driver
        allgathers these for the cross-span set union
        (parallel/multihost._union_patterns_across_processes)."""
        self._compact()
        return self._sorted


def associate(table_base: str, pheno_accessions, pheno_values: np.ndarray,
              pheno_names, *, kmer_len: int, n_top: int = 10001,
              maf: float = 0.05, mac: int = 5, batch_size: int = 2_000_000,
              first_phenotype_top: int | None = None,
              count_patterns: bool = False,
              checkpoint_path: str | None = None, checkpoint_every: int = 20,
              dtable_cache: str | None = None, mesh=None,
              score_precision: str = "default",
              certify_topk: bool = False,
              progress=None) -> ScanResult:
    """Scan the full table; returns per-phenotype top-k with k-mer codes.

    pheno_values: (n_accessions, P) TRANSFORMED phenotype columns.
    first_phenotype_top: like --first_phenotype_best, a larger k for column 0.
    dtable_cache: path to a device-native pre-packed table (core/dtable.py);
    built on first use, then batches stream as raw memmap slices with no
    host-side squeeze/pack work.
    score_precision: "default" (the GPU kernel scores the phenotype
    rounded to bf16: relative score errors of a few 1e-3, see certify_eps —
    candidates are exactly re-scored by the LMM) or "highest"
    (f32-faithful, slower); see ops/scanstep.scan_step_compact.
    certify_topk: carry CERTIFY_BAND extra top-k slots through the scan,
    exactly re-score every carried candidate in f64 at finalize, re-rank
    by (exact score desc, row asc), and PROVE per column that the selected
    set equals the exact-score top-k (certify_column). Output scores are
    then the f64 re-scores — the reference's double-precision epilogue
    (src/kmers_multiple_databases.cpp:358-362) — at a small fetch/finalize
    cost instead of the 3-6x GEMM cost of score_precision="highest".
    mesh: optional jax.sharding.Mesh. With >1 device the PRODUCTION step
    (fused kernel + buffered deferred merge) runs per device shard under
    shard_map, batches sharded over the k-mer axis, and the exact global
    top-k is merged at finalize (parallel/sharding.py). Single-device
    semantics and output are reproduced exactly.
    """
    reader = KmersTableReader(table_base, names_to_use=pheno_accessions)
    n_used = reader.n_used
    min_count = effective_min_count(n_used, maf, mac)
    n_pad = reader.w32 * 32
    p = pheno_values.shape[1]
    k_eff = max(n_top, first_phenotype_top or 0) \
        + (CERTIFY_BAND if certify_topk else 0)

    if min_count < 1:
        raise ValueError("min_count must be >= 1 (zero-popcount marks padding)")
    yp, ysum = score_ops.prepare_phenotypes(np.asarray(pheno_values, np.float32), n_pad)
    patterns = _PatternCounter() if count_patterns else None

    from ..ops import scanstep as ss
    from ..utils import StageTimer, drain, pick_kernel
    from . import checkpoint as ckpt
    kernel = pick_kernel()
    n_devices = mesh.devices.size if mesh is not None else 1
    use_sharded = n_devices > 1
    stream_tag = "dtable" if dtable_cache else "table"
    ckpt_meta = {"table_rows": reader.n_rows_total, "n_used": n_used,
                 "min_count": min_count, "k_eff": k_eff, "n_pheno": p}
    n_tested = 0
    start_row = 0
    resumed_plain = None
    if checkpoint_path:
        resumed = ckpt.load_scan_state(checkpoint_path, meta=ckpt_meta)
        if resumed is not None and resumed[3] == stream_tag:
            resumed_plain, start_row, n_tested = resumed[:3]
    # fixed device shape: pad every batch to batch_size (rounded up to
    # whole compact-step tiles per device) so jit compiles exactly one
    # program; padding rows carry popcnt == 0 and score -inf inside the step
    cp = ss.compact_params(-(-batch_size // n_devices), k_eff)
    pad_to = cp.shard_rows * n_devices
    step_kw = dict(n_used=n_used, min_count=min_count, kernel=kernel,
                   cand_c=cp.cand_c, cand_k=cp.cand_k, tile_rows=cp.tile_rows,
                   cand_q=cp.cand_q, cand_c2=cp.cand_c2,
                   precision=score_precision)
    if use_sharded:
        from ..parallel import sharding as shard_mod
        from jax.sharding import NamedSharding, PartitionSpec as _P
        state = shard_mod.init_sharded_buffered_state(
            mesh, p, k_eff, buf_cap=cp.buf_cap, seed_state=resumed_plain)
        step_fn = shard_mod.build_sharded_scan_step_compact(mesh, **step_kw)
        batch_sharding = NamedSharding(mesh, _P(shard_mod.AXIS))
        rep = NamedSharding(mesh, _P())
        yp = jax.device_put(np.asarray(yp), rep)
        ysum = jax.device_put(np.asarray(ysum), rep)
        put = lambda a: jax.device_put(a, batch_sharding)
    else:
        state = ss.init_buffered_state(p, k_eff, buf_cap=cp.buf_cap)
        if resumed_plain is not None:
            state = state._replace(scores=resumed_plain.scores,
                                   row_lo=resumed_plain.row_lo,
                                   row_hi=resumed_plain.row_hi,
                                   thresh=resumed_plain.scores[:, -1])
        put = jnp.asarray

    dt = None
    if dtable_cache:
        from ..core import dtable as dt_mod
        from . import feed as feed_mod
        nhash = dt_mod.names_hash_of(reader.names)
        dt = dt_mod.open_cache(dtable_cache, min_count=min_count,
                               n_used=n_used, names_hash=nhash)
        if dt is None:   # absent, legacy, or a different filter/subset
            dt_mod.build_dtable(table_base, dtable_cache,
                                names_to_use=pheno_accessions,
                                min_count=min_count)
            dt = dt_mod.DTableReader(dtable_cache)
        # stream at the device-batch quantum so full batches pass as raw
        # zero-copy memmap slices (pipeline/feed.py — single-touch feed).
        # Checkpoint positions are EXACT dtable row indices and the feed can
        # start at any offset, so a resume re-tests nothing (re-appending
        # already-counted rows would duplicate them in the top-k state).
        prepared = feed_mod.dtable_feed(dt, pad_to, start_row=start_row,
                                        want_patterns=patterns is not None)
        next_pos = start_row
    else:
        batches = ((b.packed, b.popcnt, b.row_index) for b
                   in reader.iter_batches(batch_size, min_count,
                                          start_row=start_row))
        next_pos = start_row

        def prepare(args):
            """Host-side batch prep (runs on the prefetch thread): pad to
            the fixed device shape and pre-encode row ids."""
            b_packed, b_popcnt, b_rows = args
            r = len(b_rows)
            packed = np.zeros((pad_to, reader.w32), np.uint32)
            packed[:r] = b_packed
            popcnt = np.zeros(pad_to, np.float32)
            popcnt[:r] = b_popcnt
            rows = np.zeros(pad_to, np.int64)
            rows[:r] = b_rows
            lo, hi = topk_ops.encode_rows(rows)
            pats = np.asarray(b_packed) if patterns is not None else None
            pos_after = int(b_rows[-1]) + 1 if r else -1   # -1: keep prior
            return r, packed, popcnt, lo, hi, pos_after, pats

        prepared = map(prepare, batches)

    def step(st, packed, popcnt, lo, hi):
        if use_sharded:
            return step_fn(st, put(packed), put(popcnt), put(lo), put(hi),
                           yp, ysum)
        return ss.scan_step_compact(
            st, put(packed), put(popcnt), put(lo), put(hi), yp, ysum,
            **step_kw)

    def plain_state(st):
        if use_sharded:
            from ..parallel import sharding as shard_mod
            return _merged_to_topk(
                shard_mod.finalize_sharded_buffered(st, mesh), p, k_eff)
        return ss.flush_buffered(st)

    import time as _time
    from collections import deque
    timings = {}
    timer = StageTimer("scan", "kmers", quiet=progress is not None)
    t_stream = _time.perf_counter()
    batch_i = 0
    # BOUNDED dispatch pipeline: without backpressure an async backend can
    # queue hundreds of steps ahead, keeping every queued batch's
    # host/transfer buffers alive — a 400M-row scan was OOM-killed at ~160
    # in-flight 2M-row batches (~130 GB anon RSS). Draining to the state
    # from `_INFLIGHT` steps ago releases all older inputs while keeping the
    # device fed (utils.drain: a one-element host fetch).
    inflight: deque = deque()
    _INFLIGHT = 4
    for r, packed, popcnt, lo, hi, pos_after, pats in _prefetch(
            prepared, depth=2):
        n_tested += r
        if pats is not None:
            patterns.add(pats)
        state = step(state, packed, popcnt, lo, hi)
        inflight.append(state.buf_n)
        if len(inflight) > _INFLIGHT:
            drain(inflight.popleft())
        batch_i += 1
        # stream position after this batch: dtable row index past the slice,
        # or the last absolute .table row consumed + 1
        if pos_after >= 0:
            next_pos = pos_after
        if checkpoint_path and batch_i % checkpoint_every == 0:
            ckpt.save_scan_state(checkpoint_path, plain_state(state),
                                 next_pos, n_tested, stream=stream_tag,
                                 meta=ckpt_meta)
        timer.add(r)
        if progress is not None:
            progress(r)
    timer.done()
    timings["stream"] = _time.perf_counter() - t_stream

    t_fin = _time.perf_counter()
    if use_sharded:
        from ..parallel import sharding as shard_mod
        per_pheno = shard_mod.finalize_sharded_buffered(state, mesh)
    else:
        per_pheno = topk_ops.finalize(ss.flush_buffered(state))
    timings["finalize"] = _time.perf_counter() - t_fin

    # resolve winner rows -> k-mer codes + packed PA: chunked-run reads from
    # the dtable (pre-squeezed) when present, else the raw table (pass 2)
    t_fetch = _time.perf_counter()
    all_rows = np.unique(np.concatenate([rw for _, rw in per_pheno])
                         ) if per_pheno and any(len(rw) for _, rw in per_pheno) else np.empty(0, np.int64)
    kmer_of_row, pa_of_row = fetch_rows(reader, all_rows.astype(np.int64),
                                        dt=dt)
    timings["fetch"] = _time.perf_counter() - t_fetch

    names = list(pheno_names)
    scores_out, rows_out, kmers_out = [], [], []
    certified = [] if certify_topk else None
    if certify_topk:
        t_cert = _time.perf_counter()
        # the oracle scores what the scan scored: the f32-cast phenotypes,
        # re-accumulated in f64
        yv = np.asarray(pheno_values, np.float32).astype(np.float64)
        ysums = yv.sum(axis=0)
    for j, (sc, rw) in enumerate(per_pheno):
        cap = first_phenotype_top if (j == 0 and first_phenotype_top) else n_top
        if certify_topk:
            pa = np.asarray(pa_of_row.take(rw))
            bits = np.unpackbits(np.ascontiguousarray(pa).view(np.uint8),
                                 axis=1, bitorder="little"
                                 )[:, :n_used].astype(np.float64)
            n_f = float(n_used)
            n1 = bits.sum(axis=1)
            r_ = n_f * (bits @ yv[:, j]) - n1 * ysums[j]
            denom = n_f * n1 - n1 * n1
            with np.errstate(divide="ignore", invalid="ignore"):
                s_ex = np.where(denom > 0, r_ * r_ / denom, 0.0)
            eps = certify_eps(yv[:, j], n_used, float(sc[-1]),
                              score_precision)
            order, cert = certify_column(sc, rw, s_ex, cap, eps)
            certified.append(bool(cert))
            sc, rw = s_ex[order], np.asarray(rw)[order]
        else:
            sc, rw = sc[:cap], rw[:cap]
        scores_out.append(sc)
        rows_out.append(rw)
        kmers_out.append(np.asarray(kmer_of_row.take(rw), dtype=np.uint64))
    if certify_topk:
        timings["certify"] = _time.perf_counter() - t_cert

    return ScanResult(names=names, scores=scores_out, rows=rows_out,
                      kmers=kmers_out, n_tested=n_tested,
                      n_patterns=(patterns.count if patterns else None),
                      pa_rows=pa_of_row, timings=timings,
                      certified=certified)


class RowLookup:
    """Vectorized row -> value map over SORTED row keys.

    Replaces the per-row Python dict build (and per-item lookups) of the
    winner-fetch stage: construction is O(1) (the arrays are stored as-is),
    bulk access is one searchsorted + gather (`take`), and scalar
    `lookup[row]` stays dict-compatible for stragglers."""

    __slots__ = ("rows", "values")

    def __init__(self, rows: np.ndarray, values: np.ndarray):
        self.rows = np.asarray(rows, np.int64)      # sorted ascending
        self.values = values

    def take(self, rows) -> np.ndarray:
        """Values for an array of row ids (each must be present)."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return self.values[:0]
        i = np.searchsorted(self.rows, rows)
        if (i >= len(self.rows)).any() or (self.rows[np.minimum(
                i, len(self.rows) - 1)] != rows).any():
            missing = rows[(i >= len(self.rows))
                           | (self.rows[np.minimum(i, len(self.rows) - 1)]
                              != rows)]
            raise KeyError(int(missing[0]))
        return self.values[i]

    def __getitem__(self, row):
        return self.take(np.asarray([row]))[0]

    def __len__(self):
        return len(self.rows)

    def __contains__(self, row):
        i = np.searchsorted(self.rows, int(row))
        return i < len(self.rows) and int(self.rows[i]) == int(row)


def _pread_gather(path: str, base_offset: int, row_bytes: int,
                  rows: np.ndarray, workers: int = 32) -> np.ndarray:
    """Gather `rows` (sorted unique) of a fixed-record file as a
    (len(rows), row_bytes) uint8 array.

    Two regimes, chosen by measured disk economics (vs the round-3 single
    memmap fancy-index, which page-faults inside numpy's copy loop WITH the
    GIL held — queue depth 1, ~12k IOPS on this host):
      * DENSE (covering span < ~5 KB/requested row): bounded-chunk
        sequential streaming of the span + in-memory gather — the
        reference's pass-2 pattern (src/associate_kmers.cpp:178-191);
      * SPARSE: one positioned read per row across `workers` threads
        (os.preadv releases the GIL; measured ~33k IOPS at 32 threads,
        ~2.8x the fancy-index)."""
    rows = np.asarray(rows, np.int64)
    out = np.empty((len(rows), row_bytes), np.uint8)
    if len(rows) == 0:
        return out
    fd = os.open(str(path), os.O_RDONLY)

    def pread_into(mv, off: int) -> None:
        got = 0
        while got < len(mv):                  # pread may return short
            r = os.preadv(fd, [mv[got:]], off + got)
            if r <= 0:
                raise EOFError(f"short read at offset {off}")
            got += r

    try:
        span_bytes = (int(rows[-1]) + 1 - int(rows[0])) * row_bytes
        # regime choice by measured disk economics: one random row costs one
        # ~4K IO (this host: ~33k IOPS with parallel preads), sequential
        # streaming runs at full bandwidth — so bulk-read the covering span
        # whenever it is smaller than ~5 KB per requested row, else issue
        # per-row parallel reads
        if span_bytes <= len(rows) * 5000:
            # DENSE: stream the covering span in bounded chunks (the
            # reference's sequential pass-2 pattern,
            # src/associate_kmers.cpp:178-191) and gather in memory
            chunk_rows = max(1, (64 << 20) // row_bytes)
            pos = 0
            scratch = np.empty((chunk_rows, row_bytes), np.uint8)
            while pos < len(rows):
                c_lo = int(rows[pos])
                c_hi = min(c_lo + chunk_rows, int(rows[-1]) + 1)
                pos2 = int(np.searchsorted(rows, c_hi))
                take = pos2 - pos
                blk = scratch[: c_hi - c_lo]
                pread_into(memoryview(blk).cast("B"),
                           base_offset + c_lo * row_bytes)
                out[pos:pos2] = blk[rows[pos:pos2] - c_lo]
                pos = pos2
        else:
            # SPARSE: one positioned read per row, straight into the output
            # row, fanned across threads (os.preadv releases the GIL, so
            # `workers` IOs stay in flight; a memmap fancy-index faults at
            # queue depth 1)
            off0 = base_offset
            rb = row_bytes

            def work(t: int) -> None:
                for i in range(t, len(rows), workers):
                    pread_into(memoryview(out[i]).cast("B"),
                               off0 + int(rows[i]) * rb)

            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(workers) as ex:
                list(ex.map(work, range(workers)))
    finally:
        os.close(fd)
    return out


def fetch_rows(reader: KmersTableReader, rows: np.ndarray, dt=None):
    """Fetch winner table rows -> (RowLookup kmers, RowLookup packed-PA).

    PA values are squeezed used-column uint64 words (ceil(n_used/64)),
    ready for PLINK export. `rows` must be sorted unique absolute .table
    row indices.

    dt: optional core.dtable.DTableReader already holding the same
    accession subset — winners are then resolved from the dtable's
    pre-squeezed planes (no raw-table reads, no squeeze work), keyed back
    through its src_rows section."""
    rows = np.asarray(rows, np.int64)
    n64 = (reader.n_used + 63) // 64
    if len(rows) == 0:
        empty = RowLookup(rows, np.empty((0, n64), "<u8"))
        return RowLookup(rows, np.empty(0, np.uint64)), empty
    from ..core import table as table_mod
    if dt is not None and table_mod._native_squeeze_available():
        # raw route wins with the native squeeze: 1 IO/row + a C pass vs
        # the dtable's 2 sections (planes + kmers) at 2 IOs/row — measured
        # 31 s vs 42 s per 1M sparse winners over a 100M-row table
        dt = None
    if dt is not None:
        src = dt.src_rows
        idx = np.searchsorted(src, rows)
        if (idx < len(src)).all() and \
                (np.asarray(src[np.minimum(idx, len(src) - 1)]) == rows).all():
            kmers = _pread_gather(dt.path, dt.kmers.offset, 8,
                                  idx).view("<u8")[:, 0]
            w32 = dt.hdr.w32
            planes = _pread_gather(dt.path, dt.planes.offset, w32 * 4, idx)
            pa = planes.view("<u8")[:, :n64]
            return (RowLookup(rows, kmers.astype(np.uint64)),
                    RowLookup(rows, np.ascontiguousarray(pa)))
        # else: dtable doesn't cover these rows (stale) — fall through
    wf = reader.header.row_words()
    raw = _pread_gather(reader.base + ".table",
                        formats.TableHeader.HEADER_BYTES, (1 + wf) * 8,
                        rows).view("<u8")
    from ..core import table as table_mod
    if table_mod._native_squeeze_available():
        from .. import native
        _, packed_all, _, _ = native.squeeze_pack(
            raw, reader.file_col, reader.n_used, reader.w32, 0)
        pa = np.ascontiguousarray(packed_all).view("<u8")[:, :n64].copy()
    else:
        # chunked squeeze: the one-shot bit-extract materializes an
        # (n, n_used) uint64 intermediate (~8 GB per 1M winners at 1008
        # accessions) — bound it
        pa = np.empty((len(rows), n64), "<u8")
        step = 1 << 15
        for s in range(0, len(rows), step):
            bits = reader.squeeze_bits(raw[s:s + step])
            padded = np.zeros((len(bits), n64 * 64), dtype=np.uint8)
            padded[:, : reader.n_used] = bits
            pa[s:s + step] = np.packbits(padded, axis=1,
                                         bitorder="little").view("<u8")
    return (RowLookup(rows, raw[:, 0].astype(np.uint64)),
            RowLookup(rows, pa))


def export_plink(result: ScanResult, reader_n_used: int, kmer_len: int,
                 base_names: list) -> None:
    """Write per-phenotype bed/bim winner exports, reference-compatible:
    rows in table order, names `<kmer>_<rank>` with rank 1 = best.
    Vectorized per column: one decode + one stacked bed write (the
    per-variant Python loop cost ~80 s at the default 101 x 10001 shape)."""
    for j, base in enumerate(base_names):
        rows = result.rows[j]
        scores = result.scores[j]
        # rank by descending score (stable), 1-based
        rank = np.empty(len(rows), dtype=np.int64)
        rank[np.argsort(-scores, kind="stable")] = np.arange(1, len(rows) + 1)
        order = np.argsort(rows, kind="stable")       # table-row output order
        with formats.BedBimWriter(base) as w:
            if len(order) == 0:
                continue
            kstrs = codec.decode_kmers(
                np.asarray(result.kmers[j], np.uint64)[order], kmer_len)
            names = [f"{ks}_{rank[idx]}" for ks, idx in zip(kstrs, order)]
            pa = np.asarray(result.pa_rows.take(
                np.asarray(rows)[order]))
            w.write_variants(names, pa, reader_n_used)
