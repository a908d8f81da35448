"""Association-scan throughput benchmark (GPU).

Metric: k-mers/second scored through the full production scan step — packed
bit-plane score GEMM over 101 phenotype columns (1 real + 100 permutations,
the reference's default shape, pipeline_parser.py:35-44) at N=1008 samples
(the 1001G A. thaliana panel), plus the per-column top-k bookkeeping
(compact tile-max extraction + deferred buffered merges).

Method: S=16 scan steps are chained into ONE dispatch with lax.scan; each
step scores a fresh 2M-row batch generated on the device (jax.random bits
+ population_count inside the jitted window — real displacement
statistics, not recycled batches). Windows are synced with a host scalar
fetch and the MEDIAN window throughput is reported, with the distribution
on stderr. Every JSON line names the device it ran on.

vs_baseline: the reference C++ SSE4.1 kernel (kmers_multiple_databases.cpp:
327-363) does ~256 4-wide SSE masked-accumulate ops per k-mer per phenotype
at N_pad=1024 (~130 ns/kmer/phenotype on a ~3 GHz core). On the 32-core
server of BASELINE.md that bounds the scan at ~2.4M k-mers/s with perfect
scaling and free I/O; we use 2.5e6 k-mers/s as the baseline denominator.
"""
import json
import os
import time

import numpy as np

BASELINE_KMERS_PER_SEC = 2.5e6
WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".work",
                       "stream_bench")


def device_info() -> dict:
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _synthetic_pop(n_rows: int, workdir: str):
    """Synthetic .table + matched .dtable cache (built once, reused)."""
    import os
    import sys
    from kmersgwas_tpu.core import formats

    os.makedirs(workdir, exist_ok=True)
    base = os.path.join(workdir, f"pop{n_rows}")
    n, kmer_len = 1008, 31
    names = [f"acc{i}" for i in range(n)]
    wf = (n + 63) // 64
    if not os.path.exists(base + ".table"):
        print("generating synthetic table...", file=sys.stderr, flush=True)
        rng = np.random.default_rng(0)
        with open(base + ".table", "wb") as f:
            formats.write_table_header(f, n, kmer_len)
            chunk = 1 << 20
            for s in range(0, n_rows, chunk):
                m = min(chunk, n_rows - s)
                rows = np.empty((m, 1 + wf), dtype="<u8")
                rows[:, 0] = np.arange(s, s + m, dtype=np.uint64) * np.uint64(97)
                rows[:, 1:] = rng.integers(0, 1 << 63, size=(m, wf),
                                           dtype=np.uint64)
                rows.tofile(f)
        formats.write_names(base, names)
    dtable = base + ".dtable"
    if not os.path.exists(dtable):
        print("building dtable cache...", file=sys.stderr, flush=True)
        from kmersgwas_tpu.core import dtable as dt_mod
        dt_mod.build_dtable(base, dtable, names_to_use=names, min_count=51)
    return base, dtable, names, n, kmer_len


def measure_host_feed(dtable: str, batch_size: int = 2_000_000,
                      tile: int = 2048):
    """Host-side feed throughput through the PRODUCTION feed pipeline
    (pipeline/feed.py): zero-copy memmap slices + prefetch-thread prep
    (readahead/page-touch/popcnt/row-encode), consumed by a staging memcpy
    standing in for device_put's one host copy (on co-located hardware the
    DMA from the staging buffer is free for the host CPU).

    Returns (warm_rows_per_sec, cold_rows_per_sec, disk_gb_per_sec,
             warm_small_batch_rows_per_sec):
      warm  — table resident in page cache (the steady state of a scan on a
              RAM-sized host, and of every pass after the first), at the
              production batch size;
      cold  — first-touch from disk, overlap ON: prep+page-in on the
              prefetch thread while the main thread copies — the measured
              floor is this host's disk, reported alongside;
      disk  — raw sequential read bandwidth for context;
      warm_small_batch — warm rate at a 512k-row quantum (smaller staging
              buffers copy ~1.7x faster on this host; the feed-optimal
              configuration when the step rate allows it).
    """
    import os
    from kmersgwas_tpu.core.dtable import DTableReader
    from kmersgwas_tpu.pipeline import feed as feed_mod
    from kmersgwas_tpu.pipeline.scan import _prefetch

    dt = DTableReader(dtable)

    def drop_cache():
        fd = os.open(dtable, os.O_RDONLY)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        os.close(fd)

    def make_pass(bs: int):
        pad_to = ((bs + tile - 1) // tile) * tile
        stage = np.empty((pad_to, dt.hdr.w32), np.uint32)

        def one_pass():
            t0 = time.perf_counter()
            fed = 0
            full_rows, full_t = 0, None
            for r, packed, pc, lo, hi, pos, pats in _prefetch(
                    feed_mod.dtable_feed(dt, pad_to), depth=2):
                np.copyto(stage[: len(packed)], packed)  # device_put stand-in
                fed += r
                if r == pad_to:
                    full_rows, full_t = fed, time.perf_counter()
            # STEADY-STATE rate: full production-quantum batches only. The
            # final partial batch takes the one-off scratch-pad path (an
            # extra staging copy + row-id encode, pipeline/feed.py _Scratch)
            # that a long scan pays once per scan — but on this 8M-row
            # bench table a 2M-quantum tail held ~25% of the rows and
            # depressed the whole-pass rate ~40% (the r4/r5 "39.5M warm,
            # cache/TLB" reading was THIS artifact — tools/prof_r5_feedgap
            # decomposition: full-batch copy runs at the host's ~8.3 GB/s
            # memcpy bound at BOTH 512k and 2M quanta).
            if full_t is not None and full_rows:
                return full_rows / (full_t - t0)
            return fed / (time.perf_counter() - t0)
        return one_pass

    one_pass = make_pass(batch_size)

    # raw disk bandwidth (cold sequential read of the planes section)
    drop_cache()
    fd = os.open(dtable, os.O_RDONLY)
    t0 = time.perf_counter()
    got = 0
    while got < min(dt.hdr.n_rows * dt.hdr.w32 * 4, 1 << 30):
        b = os.read(fd, 1 << 24)
        if not b:
            break
        got += len(b)
    disk_gbps = got / (time.perf_counter() - t0) / 1e9
    os.close(fd)

    drop_cache()
    cold = one_pass()
    one_pass()                      # settle the cache
    warm = max(one_pass(), one_pass())
    small = make_pass(1 << 19)
    small()
    warm_small = max(small(), small())
    return warm, cold, disk_gbps, warm_small


def streaming(n_rows: int = 8_000_000, batch_size: int = 2_000_000,
              workdir: str = WORKDIR):
    """Measured end-to-end STREAMING scan: synthetic .table -> .dtable cache
    -> pipeline.scan.associate() (zero-copy memmap slices -> prefetch
    thread -> device_put -> fused step), PLUS the host-feed-only rates
    through the same production feed (measure_host_feed). The end-to-end
    per-device rate is bounded by min(device step rate, host feed rate)."""
    import sys
    from kmersgwas_tpu.pipeline import scan as scan_mod

    base, dtable, names, n, kmer_len = _synthetic_pop(n_rows, workdir)
    rng = np.random.default_rng(1)
    y = rng.normal(size=(n, 101))

    warm, cold, disk_gbps, warm_small = measure_host_feed(dtable, batch_size)
    print(f"host feed: warm {warm/1e6:.1f}M rows/s (512k-batch "
          f"{warm_small/1e6:.1f}M), cold {cold/1e6:.1f}M rows/s "
          f"(disk {disk_gbps:.2f} GB/s)", file=sys.stderr, flush=True)

    counted = [0]
    t0 = time.perf_counter()
    res = scan_mod.associate(base, names, y, [f"c{j}" for j in range(101)],
                             kmer_len=kmer_len, n_top=10001, maf=0.05, mac=5,
                             batch_size=batch_size, dtable_cache=dtable,
                             progress=lambda r: counted.__setitem__(0, counted[0] + r))
    dt_scan = time.perf_counter() - t0
    kmers_per_sec = res.n_tested / dt_scan
    print(json.dumps({
        "metric": "assoc_scan_streaming_kmers_per_sec",
        "value": round(kmers_per_sec, 1),
        "unit": f"kmers/s end-to-end (N=1008, P=101, "
                f"{res.n_tested} rows, memmap->prefetch->device_put->step)",
        "device": device_info(),
        "vs_baseline": round(kmers_per_sec / BASELINE_KMERS_PER_SEC, 3),
        "host_feed_rows_per_sec_warm": round(warm, 1),
        "host_feed_rows_per_sec_warm_512k_batch": round(warm_small, 1),
        "host_feed_rows_per_sec_cold": round(cold, 1),
        "disk_seq_read_gb_per_sec": round(disk_gbps, 3),
        "sub_stage_seconds": {k: round(v, 2) for k, v in res.timings.items()},
    }))


def kinship_streaming(n_rows: int = 8_000_000, batch_size: int = 1 << 20,
                      workdir: str = WORKDIR):
    """Measured kinship feed bound: PRODUCTION feed
    (pipeline/feed.kinship_feed — zero-copy slices + readahead on a
    prefetch thread) -> staging memcpy (device_put stand-in), then the
    end-to-end rate through the device. Reference: the reference's kinship
    is the ~5-day stage (src/emma_kinship_kmers.cpp:85-102)."""
    import os
    import sys
    import jax.numpy as jnp
    from kmersgwas_tpu.core.dtable import DTableReader
    from kmersgwas_tpu.pipeline import feed as feed_mod
    from kmersgwas_tpu.pipeline.kinship import KinshipAccumulator
    from kmersgwas_tpu.pipeline.scan import _prefetch

    base, _, names, n, kmer_len = _synthetic_pop(n_rows, workdir)
    dtable = base + ".kin.dtable"
    min_count = 51                      # ceil(0.05 * 1008), the kinship MAF
    if not os.path.exists(dtable):
        print("building dtable cache...", file=sys.stderr, flush=True)
        from kmersgwas_tpu.core.dtable import build_dtable
        build_dtable(base, dtable, names_to_use=names, min_count=min_count)
    dt = DTableReader(dtable)
    stage = np.empty((batch_size, dt.hdr.w32), np.uint32)

    def feed_pass():
        t0 = time.perf_counter()
        fed = 0
        for s, r, planes in _prefetch(
                feed_mod.kinship_feed(dt, batch_size), depth=2):
            np.copyto(stage[:r], planes)    # device_put stand-in
            fed += r
        return fed / (time.perf_counter() - t0)

    fdd = os.open(dtable, os.O_RDONLY)
    os.posix_fadvise(fdd, 0, 0, os.POSIX_FADV_DONTNEED)
    os.close(fdd)
    host_feed_cold = feed_pass()
    feed_pass()
    host_feed = max(feed_pass(), feed_pass())
    print(f"kinship feed: warm {host_feed/1e6:.1f}M rows/s, cold "
          f"{host_feed_cold/1e6:.1f}M rows/s", file=sys.stderr, flush=True)

    # end-to-end through the device (bounded by min(host_feed, device GEMM
    # rate))
    acc = KinshipAccumulator(n_used=dt.hdr.n_used, n_pad=dt.hdr.w32 * 32)
    t0 = time.perf_counter()
    done = 0
    for s, r, planes in _prefetch(
            feed_mod.kinship_feed(dt, batch_size), depth=2):
        acc.add(jnp.asarray(planes))
        done += r
    acc.flush()
    e2e = done / (time.perf_counter() - t0)
    assert acc.n_rows == done
    print(json.dumps({
        "metric": "kinship_feed_rows_per_sec",
        "value": round(host_feed, 1),
        "unit": f"rows/s host-feed bound, warm cache (N=1008, production "
                f"zero-copy feed, {done} rows)",
        "device": device_info(),
        "host_feed_cold_cache_rows_per_sec": round(host_feed_cold, 1),
        "end_to_end_rows_per_sec": round(e2e, 1),
    }))


def main(n_windows: int = 30, steps_per_window: int = 16,
         n_ramp: int = 6):
    """Device-side scan throughput over a SIMULATED GENUINE STREAM.

    Every step scores a fresh random 2M-row batch generated on the device —
    unlike recycling a few device-resident batches, this reproduces the
    real displacement statistics of a long scan: early batches are hot
    (wide appends / exact wide-merge fallbacks), later ones take the narrow
    compact append. Steps are chained S per dispatch (lax.scan) and timed
    in synced windows; the first n_ramp windows (the early-stream
    transient) are reported apart from the MEDIAN steady-state window.
    """
    import functools
    import sys

    import jax
    import jax.numpy as jnp
    from kmersgwas_tpu.ops import scanstep as ss
    from kmersgwas_tpu.ops import score as score_ops
    from kmersgwas_tpu.utils import enable_compile_cache, pick_kernel

    n_used, n_pad, p, k = 1008, 1024, 101, 10001
    cp = ss.compact_params(2_000_000, k)
    rows = cp.shard_rows    # ~2M k-mers per scan step
    min_count = 51
    w32 = n_pad // 32
    S = steps_per_window

    # host-feed side of the end-to-end story: the production zero-copy
    # feed (pipeline/feed.py) measured on a synthetic dtable, FIRST, before
    # the first device touch; end-to-end per device = min(step rate, feed
    # rate), reported side by side in the same JSON line.
    _, dtable, *_ = _synthetic_pop(8_000_000, WORKDIR)
    feed_warm, feed_cold, disk_gbps, feed_small = measure_host_feed(dtable)
    print(f"host feed: warm {feed_warm/1e6:.1f}M rows/s (512k-batch "
          f"{feed_small/1e6:.1f}M), cold {feed_cold/1e6:.1f}M rows/s "
          f"(disk {disk_gbps:.2f} GB/s)", file=sys.stderr, flush=True)

    enable_compile_cache()
    device = device_info()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {device}")
    kernel = pick_kernel()
    rng = np.random.default_rng(0)
    y = rng.normal(size=(n_used, p)).astype(np.float32)
    yp, ysum = score_ops.prepare_phenotypes(y, n_pad)
    yp, ysum = jax.device_put(yp), jax.device_put(ysum)
    hi0 = jax.device_put(np.zeros(rows, np.int32))
    iota = jax.device_put(np.arange(rows, dtype=np.int32))
    last_mask = jnp.uint32((1 << (n_used % 32)) - 1)

    def gen(key):
        packed = jax.random.bits(key, (rows, w32), jnp.uint32)
        packed = packed.at[:, -1].set(packed[:, -1] & last_mask)
        pc = jnp.sum(jax.lax.population_count(packed), axis=1)
        return packed, pc.astype(jnp.float32)

    step = functools.partial(
        ss.scan_step_compact.__wrapped__, y_padded=yp, y_sum=ysum,
        n_used=n_used, min_count=min_count, kernel=kernel,
        cand_c=cp.cand_c, cand_k=cp.cand_k, tile_rows=cp.tile_rows,
        cand_q=cp.cand_q, cand_c2=cp.cand_c2)

    @jax.jit
    def window(state, key, base):
        def body(carry, _):
            st, ky, bs = carry
            ky, sub = jax.random.split(ky)
            packed, pc = gen(sub)
            st = step(st, packed, pc, bs + iota, hi0)
            return (st, ky, bs + rows), None
        (state, key, base), _ = jax.lax.scan(body, (state, key, base),
                                             length=S)
        return state, key, base

    print("compiling...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    state = ss.init_buffered_state(p, k, buf_cap=cp.buf_cap)
    key = jax.random.PRNGKey(1)
    base = jax.device_put(jnp.int32(0))
    state, key, base = window(state, key, base)
    np.asarray(state.buf_n)
    print(f"compiled+warm window in {time.perf_counter()-t0:.0f}s",
          file=sys.stderr, flush=True)

    def timed_window(st, ky, bs):
        t0 = time.perf_counter()
        st, ky, bs = window(st, ky, bs)
        np.asarray(st.buf_n)            # host fetch: the window has ended
        return st, ky, bs, time.perf_counter() - t0

    ramp_s, win_s = [], []
    for _ in range(n_ramp):
        state, key, base, dt = timed_window(state, key, base)
        ramp_s.append(dt)
    for _ in range(n_windows):
        state, key, base, dt = timed_window(state, key, base)
        win_s.append(dt)
    checksum = float(np.asarray(state.scores[:, 0]).sum())
    assert np.isfinite(checksum)

    win_s = np.array(win_s)
    rates = S * rows / win_s
    med = float(np.median(rates))
    p10, p90 = float(np.percentile(rates, 10)), float(np.percentile(rates, 90))
    spread = (p90 - p10) / med
    med_step_ms = float(np.median(win_s)) / S * 1e3
    print("ramp ms:   " + " ".join(f"{t*1e3:.0f}" for t in ramp_s),
          file=sys.stderr)
    print("window ms: " + " ".join(f"{t*1e3:.0f}" for t in win_s),
          file=sys.stderr)
    print(f"median {med/1e6:.1f}M/s  p10 {p10/1e6:.1f}M  p90 {p90/1e6:.1f}M  "
          f"spread {spread:.2f}  step {med_step_ms:.2f} ms",
          file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": "assoc_scan_kmers_per_sec_per_chip",
        "value": round(med, 1),
        "unit": "kmers/s (N=1008, P=101, top-10001; median of "
                f"{n_windows} synced {S}-step steady-state windows over a "
                "fresh-random on-device 2M-row/step stream; "
                f"{len(ramp_s)} ramp windows reported separately)",
        "device": device,
        "kernel": kernel,
        "vs_baseline": round(med / BASELINE_KMERS_PER_SEC, 3),
        "window_spread_p10_p90": round(spread, 3),
        "median_step_ms": round(med_step_ms, 3),
        "ramp_window_ms": [round(t * 1e3) for t in ramp_s],
        # the other half of the end-to-end story: what THIS host's feed
        # sustains through the production zero-copy pipeline
        "host_feed_rows_per_sec_warm": round(feed_warm, 1),
        "host_feed_rows_per_sec_warm_512k_batch": round(feed_small, 1),
        "host_feed_rows_per_sec_cold": round(feed_cold, 1),
        "disk_seq_read_gb_per_sec": round(disk_gbps, 3),
        # min(step, feed) at the SAME 2M-row batch size — both rates are
        # steady-state (the feed's one-off tail batch is excluded; see
        # measure_host_feed / tools/prof_r5_feedgap.py)
        "end_to_end_kmers_per_sec_bound": round(min(med, feed_warm), 1),
    }))


if __name__ == "__main__":
    import sys
    if "--streaming" in sys.argv:
        streaming()
    elif "--kinship-streaming" in sys.argv:
        kinship_streaming()
    else:
        main()
