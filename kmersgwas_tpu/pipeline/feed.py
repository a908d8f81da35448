"""Overlapped host->HBM feed over a device-native .dtable.

The round-4 measurement showed the production scan feed-bound: the device
kernel consumes ~315M rows/s but the host feed delivered ~8.4M rows/s. The
cost was structural, not essential — per 1M-row batch the old `prepare`
zero-filled a fresh 128 MB pad buffer (4.6 GB/s), copied the memmap slice
into it (another 128 MB), and re-allocated popcnt/row arrays, touching
~280 B per 128 B row. This module enforces SINGLE-TOUCH discipline:

  * batches stream at exactly the device-batch quantum (`pad_to` rows), so
    every full batch is handed to `device_put` as the raw contiguous memmap
    slice — ZERO host copies; the transfer engine's staging copy is the one
    and only byte-touch. Only the final partial batch is padded, into one
    reusable scratch buffer.
  * the prefetch thread fadvises (POSIX_FADV_WILLNEED) the slice about to
    be prepared AND the one after it, then touches one byte per 4 KB page,
    so cold-cache page-in runs at full disk bandwidth and OVERLAPS the main
    thread's dispatch of earlier batches; the main thread's staging copy
    then reads warm pages at memory speed.
  * popcnt f32 conversion and row-id lo/hi encoding (the only per-row host
    arithmetic, ~24 B/row of small arrays) also run on the prefetch thread.

Reference hot-loop analogue: the Load/Associations split of
src/associate_kmers.cpp:123-148 — Load is the bottleneck there too; this is
its device-native answer.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops import topk as topk_ops


class _Scratch:
    """Lazily-allocated, reused pad buffers for the (single) tail batch."""

    def __init__(self, pad_to: int, w32: int):
        self.pad_to = pad_to
        self.w32 = w32
        self.packed = None
        self.popcnt = None
        self.rows = None

    def pad(self, planes, pc, rows):
        if self.packed is None:
            self.packed = np.zeros((self.pad_to, self.w32), np.uint32)
            self.popcnt = np.zeros(self.pad_to, np.float32)
            self.rows = np.zeros(self.pad_to, np.int64)
        r = len(rows)
        self.packed[:r] = planes
        self.packed[r:] = 0          # stays zero unless reused for a larger
        self.popcnt[:r] = pc         # tail — cheap either way (runs once)
        self.popcnt[r:] = 0.0
        self.rows[:r] = rows
        self.rows[r:] = 0
        return self.packed, self.popcnt, self.rows


def dtable_feed(dt, pad_to: int, *, start_row: int = 0,
                readahead: bool = True, want_patterns: bool = False):
    """Yield transfer-ready batches from a core.dtable.DTableReader.

    Yields (r, packed, popcnt_f32, row_lo, row_hi, pos_after, pats) where
    `packed` is (pad_to, w32) uint32 — the raw memmap slice for full batches
    (zero-copy) or the padded scratch for the final partial one — r is the
    number of valid rows, and pos_after is the dtable row index right after
    this batch (the checkpoint resume position). `pats` is the unpadded
    planes slice when `want_patterns`.

    Designed to run on a prefetch thread (see pipeline.scan._prefetch): all
    page-touch and per-row encode work happens HERE, off the dispatch
    thread.
    """
    hdr = dt.hdr
    scratch = _Scratch(pad_to, hdr.w32)
    plane_bytes = hdr.w32 * 4
    fd = os.open(dt.path, os.O_RDONLY) if readahead else None
    planes_off = dt.planes.offset

    def advise(row0: int) -> None:
        if fd is None or row0 >= hdr.n_rows:
            return
        n = min(pad_to, hdr.n_rows - row0)
        try:
            os.posix_fadvise(fd, planes_off + row0 * plane_bytes,
                             n * plane_bytes, os.POSIX_FADV_WILLNEED)
        except OSError:
            pass

    v3 = dt.pop32 is not None           # zero-prep sections present
    try:
        advise(start_row)
        for s in range(start_row, hdr.n_rows, pad_to):
            e = min(s + pad_to, hdr.n_rows)
            r = e - s
            advise(e)                       # kernel readahead for the NEXT
            planes = dt.planes[s:e]         # slice while we prepare this one
            if r == pad_to:
                if v3:                      # v3: EVERY array is a raw slice
                    pc = dt.pop32[s:e]
                    lo, hi = dt.row_lo[s:e], dt.row_hi[s:e]
                else:                       # v2: compute per batch
                    pc = dt.popcnt[s:e].astype(np.float32)
                    lo, hi = topk_ops.encode_rows(np.asarray(dt.src_rows[s:e]))
                # zero-copy: touch one byte per 4 KB page so the dispatch
                # thread's staging copy reads warm cache (rows are 128 B at
                # N=1008 -> every 32nd row starts a new page; stride by the
                # exact page-per-row ratio, min 1)
                stride = max(1, 4096 // plane_bytes)
                np.add.reduce(planes[::stride, 0], dtype=np.uint64)
                packed, popcnt = planes, pc
            else:
                pc = (dt.pop32[s:e] if v3
                      else dt.popcnt[s:e].astype(np.float32))
                rows = np.asarray(dt.src_rows[s:e])
                packed, popcnt, rows_p = scratch.pad(planes, pc, rows)
                lo, hi = topk_ops.encode_rows(rows_p)
            pats = np.asarray(planes) if want_patterns else None
            yield r, packed, popcnt, lo, hi, e, pats
    finally:
        if fd is not None:
            os.close(fd)


def kinship_feed(dt, batch_size: int, *, start_row: int = 0,
                 readahead: bool = True):
    """Yield (batch_start, n_rows, planes) memmap slices with readahead for
    the kinship accumulator — zero-copy (the accumulator's device_put is the
    single byte-touch); pair with pipeline.scan._prefetch so page-in
    overlaps the device GEMM."""
    hdr = dt.hdr
    plane_bytes = hdr.w32 * 4
    fd = os.open(dt.path, os.O_RDONLY) if readahead else None
    planes_off = dt.planes.offset

    def advise(row0: int) -> None:
        if fd is None or row0 >= hdr.n_rows:
            return
        n = min(batch_size, hdr.n_rows - row0)
        try:
            os.posix_fadvise(fd, planes_off + row0 * plane_bytes,
                             n * plane_bytes, os.POSIX_FADV_WILLNEED)
        except OSError:
            pass

    try:
        advise(start_row)
        for s in range(start_row, hdr.n_rows, batch_size):
            e = min(s + batch_size, hdr.n_rows)
            advise(e)
            planes = dt.planes[s:e]
            stride = max(1, 4096 // plane_bytes)
            np.add.reduce(planes[::stride, 0], dtype=np.uint64)  # warm pages
            yield s, e - s, planes
    finally:
        if fd is not None:
            os.close(fd)
