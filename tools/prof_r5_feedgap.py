"""Round-5-final probe: where the warm 2M-batch feed loses bandwidth.

A plain anon->anon np.copyto of one 2M-row batch (244 MB) runs at
~8.4 GB/s = ~65M rows/s on this host, but bench.measure_host_feed reports
only ~39.5M rows/s warm at the same batch size. This probe decomposes the
warm-pass cost:

  A  production feed (dtable_feed + _prefetch + copyto)   [bench number]
  B  as A but no _prefetch thread (inline generator)
  C  memmap slices + copyto only (no advise / page-touch / v3 slices)
  D  copyto from a warm ANON copy of the planes (no memmap at all)
  E  pread() into the staging buffer (no memmap mapping cost)

D vs C isolates the file-backed-mapping cost (4 KB page-cache PTEs vs THP
anon pages); B vs A isolates prefetch-thread contention; C vs B isolates
the per-batch extras (advise + page-touch + v3 section slicing).

MEASURED (2026-08-22, quiet 2-core host):
    A 65.1M  B 64.2M  C 66.1M  D 67.7M  E 40.2M   (rows/s, warm)
so the production feed runs AT the host memcpy bound (A ~= D) and memmap
beats pread (E) — none of the feed machinery costs anything. The r4/r5
"39.5M warm at 2M batches" came from measure_host_feed itself: its 8M-row
table split as 3 full batches + one ~2M-row TAIL at the 2,000,896-row
production quantum, and the tail's scratch-pad path (extra 256 MB copy +
encode_rows) ran on 25% of the rows — a per-scan one-off cost that a
200-batch production scan amortizes to ~0.2%. Follow-up subprocess
bisection (eviction method x population method x stage allocation) showed
every configuration reaches ~64M once the tail is excluded; the old
"cache/TLB at 2M staging buffers" explanation was wrong. bench.py now
reports the steady-state full-batch rate (see measure_host_feed).

Run: python tools/prof_r5_feedgap.py [n_rows] (default 8M; builds/reuses
the bench's synthetic pop in .work/stream_bench)
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from kmersgwas_tpu.core.dtable import DTableReader  # noqa: E402
from kmersgwas_tpu.pipeline import feed as feed_mod  # noqa: E402
from kmersgwas_tpu.pipeline.scan import _prefetch  # noqa: E402


def timed(label, fn, n_rows, reps=3):
    fn()                                   # warm
    best = min(min((lambda t0=time.perf_counter(): (fn(), time.perf_counter() - t0)[1])()
                   for _ in range(reps)), float("inf"))
    print(f"{label:52s} {n_rows/best/1e6:7.1f}M rows/s "
          f"({n_rows*128/best/1e9:5.2f} GB/s)")
    return n_rows / best


def main(n_rows=8_000_000, batch=2_000_000):
    base, dtable, *_ = bench._synthetic_pop(n_rows, ".work/stream_bench")
    dt = DTableReader(dtable)
    pad_to = batch
    stage = np.empty((pad_to, dt.hdr.w32), np.uint32)
    nb = dt.hdr.n_rows

    def pass_A():
        for r, packed, pc, lo, hi, pos, pats in _prefetch(
                feed_mod.dtable_feed(dt, pad_to), depth=2):
            np.copyto(stage[: len(packed)], packed)

    def pass_B():
        for r, packed, pc, lo, hi, pos, pats in feed_mod.dtable_feed(
                dt, pad_to):
            np.copyto(stage[: len(packed)], packed)

    def pass_C():
        for s in range(0, nb, pad_to):
            e = min(s + pad_to, nb)
            np.copyto(stage[: e - s], dt.planes[s:e])

    anon = np.array(dt.planes[:pad_to])    # one warm anon batch

    def pass_D():
        for s in range(0, nb, pad_to):
            e = min(s + pad_to, nb)
            np.copyto(stage[: e - s], anon[: e - s])

    fd = os.open(dt.path, os.O_RDONLY)
    plane_bytes = dt.hdr.w32 * 4
    off0 = dt.planes.offset

    def pass_E():
        mv = memoryview(stage).cast("B")
        for s in range(0, nb, pad_to):
            e = min(s + pad_to, nb)
            want = (e - s) * plane_bytes
            got = 0
            while got < want:
                got += os.preadv(fd, [mv[got:want]], off0 + s * plane_bytes + got)

    timed("A production feed (prefetch thread)", pass_A, nb)
    timed("B production feed, inline (no thread)", pass_B, nb)
    timed("C memmap slice -> copyto only", pass_C, nb)
    timed("D anon -> copyto (no memmap)", pass_D, nb)
    timed("E pread -> staging (no mapping)", pass_E, nb)
    os.close(fd)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8_000_000)
