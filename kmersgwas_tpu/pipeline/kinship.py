"""Kinship-from-table driver (emma_kinship_kmers equivalent).

Streams MAC-filtered table batches into the exact int8-GEMM XNOR accumulator
(ops/kinship.py). Reference: src/emma_kinship_kmers.cpp:77-111 — batches of
2^20 rows, min_count = ceil(n * maf), normalize by #used k-mers, diagonal 1.

With `mesh=`, the reference's worst wall-clock stage (~5 days for ~1000
accessions on its cluster, manual.pdf) scales over devices: each device
accumulates its k-mer row shard's partial A^T A with NO per-step
collectives (padding rows zeroed exactly); partials meet on the host at
flush, where the int64 overflow spill lives anyway. The result is
bit-identical to the single-device accumulator for any device count.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..core.table import KmersTableReader
from ..ops.kinship import KinshipAccumulator


class ShardedKinshipAccumulator:
    """KinshipAccumulator over a device mesh: per-device int32 partials
    sharded on the k-mer axis, summed into the host int64 total at flush."""

    def __init__(self, n_used: int, n_pad: int, mesh):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel import sharding as shard_mod
        self.n_used = n_used
        self.n_pad = n_pad
        self.mesh = mesh
        self._shard = shard_mod
        self._d = mesh.devices.size
        self._step = shard_mod.build_sharded_kinship_accumulate(mesh)
        self._sharding = NamedSharding(mesh, P(shard_mod.AXIS))
        self._put = lambda a: jax.device_put(a, self._sharding)
        self.total = np.zeros((n_used, n_used), dtype=np.int64)
        self.device_acc = self._zero()
        self.rows_in_acc = 0
        self.n_rows = 0

    def _zero(self):
        return self._put(np.zeros((self._d, self.n_pad, self.n_pad),
                                  np.int32))

    def add(self, packed_host: np.ndarray) -> None:
        rows = int(packed_host.shape[0])
        if self.rows_in_acc + rows > (1 << 30):
            self.flush()
        valid = np.ones(rows, np.int8)
        packed, valid = self._shard.shard_batch(
            self.mesh, [np.asarray(packed_host), valid])
        self.device_acc = self._step(self.device_acc, packed, valid)
        self.rows_in_acc += rows
        self.n_rows += rows

    def flush(self) -> None:
        if self.rows_in_acc:
            part = np.asarray(self.device_acc, dtype=np.int64).sum(axis=0)
            self.total += part[: self.n_used, : self.n_used]
            self.device_acc = self._zero()
            self.rows_in_acc = 0

    def finalize(self) -> np.ndarray:
        self.flush()
        if self.n_rows == 0:
            raise ValueError("no k-mers accumulated into kinship")
        xnor = (self.n_rows + self.total) / 2.0
        k = xnor / float(self.n_rows)
        np.fill_diagonal(k, 1.0)
        return k


def kinship_from_table(table_base: str, *, maf: float = 0.05,
                       batch_size: int = 1 << 20, names_to_use=None,
                       checkpoint_path: str | None = None,
                       checkpoint_every: int = 50, mesh=None,
                       dtable_cache: str | None = None,
                       progress=None) -> np.ndarray:
    """dtable_cache: optional device-native pre-packed table (core/dtable);
    used only when its stored min_count/n_used match this call's filter, so
    the accumulated row set is identical to the raw-table route."""
    from . import checkpoint as ckpt
    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    min_count = math.ceil(reader.n_used * maf)
    if mesh is not None and mesh.devices.size > 1:
        acc = ShardedKinshipAccumulator(n_used=reader.n_used,
                                        n_pad=reader.w32 * 32, mesh=mesh)
        to_dev = lambda packed: np.asarray(packed)
    else:
        acc = KinshipAccumulator(n_used=reader.n_used, n_pad=reader.w32 * 32)
        to_dev = jnp.asarray
    dt = None
    if dtable_cache:
        import os
        from ..core import dtable as dt_mod
        nhash = dt_mod.names_hash_of(reader.names)
        if not os.path.exists(dtable_cache):
            dt_mod.build_dtable(table_base, dtable_cache,
                                names_to_use=names_to_use,
                                min_count=min_count)
        dt = dt_mod.open_cache(dtable_cache, min_count=min_count,
                               n_used=reader.n_used, names_hash=nhash)
        # None: stale cache for a different filter/subset (or legacy v1) —
        # fall back to the raw-table route rather than clobbering a cache
        # another stage may own

    stream_tag = "dtable" if dt is not None else "table"
    ckpt_meta = {"table_rows": reader.n_rows_total, "n_used": reader.n_used,
                 "min_count": min_count}
    start_row = 0
    if checkpoint_path:
        resumed = ckpt.load_kinship_state(checkpoint_path, stream=stream_tag,
                                          meta=ckpt_meta)
        if resumed is not None:
            acc.total, acc.n_rows, start_row = resumed

    from collections import deque
    inflight: deque = deque()

    def throttle():
        # bounded dispatch pipeline (see pipeline/scan.py): without this an
        # async backend queues every batch's buffers — OOM at scale
        # (utils.drain: one-element host fetch)
        inflight.append(getattr(acc, "device_acc", None))
        if len(inflight) > 4:
            h = inflight.popleft()
            if h is not None:
                from ..utils import drain
                drain(h)

    if dt is not None:
        # dtable rows are already MAC-filtered and packed: zero-copy memmap
        # slices with readahead on a prefetch thread (pipeline/feed.py), so
        # cold-cache page-in overlaps the device GEMM; checkpoint positions
        # are DTABLE row indices (stream-tagged)
        from .feed import kinship_feed
        from .scan import _prefetch
        batch_i = 0
        for s_, r, planes in _prefetch(
                kinship_feed(dt, batch_size, start_row=start_row), depth=2):
            if r == 0:
                continue
            acc.add(to_dev(planes))
            throttle()
            batch_i += 1
            if checkpoint_path and batch_i % checkpoint_every == 0:
                acc.flush()
                ckpt.save_kinship_state(checkpoint_path, acc.total,
                                        acc.n_rows, s_ + r,
                                        stream=stream_tag, meta=ckpt_meta)
            if progress is not None:
                progress(r)
        return acc.finalize()

    batch_i = 0
    for batch in reader.iter_batches(batch_size, min_count, start_row=start_row):
        if batch.n_rows == 0:
            continue
        # single-device path runs batches at their true size (an all-zero
        # padded row is not neutral under the ±1 encoding); the sharded path
        # pads to the device count but zeroes padding rows in the GEMM
        acc.add(to_dev(batch.packed))
        throttle()
        batch_i += 1
        if checkpoint_path and batch_i % checkpoint_every == 0:
            acc.flush()
            ckpt.save_kinship_state(checkpoint_path, acc.total, acc.n_rows,
                                    int(batch.row_index[-1]) + 1,
                                    meta=ckpt_meta)
        if progress is not None:
            progress(batch.n_rows)
    return acc.finalize()


def write_kinship(path, K: np.ndarray) -> None:
    """Tab-separated kinship matrix, like emma_kinship_kmers' stdout TSV
    (src/emma_kinship_kmers.cpp:104-111)."""
    with open(str(path), "w") as f:
        for row in K:
            f.write("\t".join(repr(float(v)) if v != int(v) else str(int(v))
                              for v in row) + "\n")


def read_kinship(path) -> np.ndarray:
    return np.loadtxt(str(path), delimiter="\t", dtype=np.float64, ndmin=2)
