#!/usr/bin/env python3
"""Proof that the k-mer GWAS main path runs on an NVIDIA GPU.

    python chip_smoke.py [--seed 0] [--rows 16000000]     one card
    python chip_smoke.py --four-cards [--rows 4000000]    four cards

One card, five phases at the 1001G flagship widths (N = 1,008 accessions,
P = 101 phenotype columns = 1 + 100 permutations, top-10,001 per column):

  1 device     platform, device kind and count; card name and power limit
  2 scan step  the production compact step (R = 2M rows) compiled and its
               memory analysis; over fresh batches against the plain XLA
               scan_step at HIGHEST precision, and the Triton kernel's tile
               planes against the XLA tile reduction; per-step times
  3 kinship    int8 GEMM kinship on the card, bit-exact against the NumPy
               integer XNOR count on a 64k-row slice
  4 lmm        the f32 packed-bit device LMM against the f64 host LMM
  5 end to end `run_gwas` on a synthetic 1001G-shaped table with 8 planted
               causal k-mers: 8/8 recovered, 0 false positives

--four-cards runs only the multi-card paths, each against one card:
sharded `associate` (same rows, same scores), sharded kinship (bit-exact),
and `gwas-mp` as four processes with one card each (artifacts byte-equal
to single-process `gwas`). The parent process stays off JAX there.

Data is made from --seed; nothing is downloaded. Every phase prints one
line; a failed phase exits non-zero without the result line. The last
stdout line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""
import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_USED, N_PAD, N_PERM, TOP_K, KMER_LEN = 1008, 1024, 100, 10001, 31
SCAN_ROWS, KIN_ROWS, LMM_SHAPE = 2_000_000, 1 << 16, (4, 1000)
STUDY_ROWS = 2_000_000_000     # k-mers of the 1001G flowering-time study
LMM_LRT_TOL = 5e-2            # device32 vs host64 LRT (phase_lmm)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_lines():
    """nvidia-smi's name and power limit per card, read by a child process
    that never touches JAX."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()] or [
        f"nvidia-smi: {r.stderr.strip()}"]


def workdir(name):
    path = os.path.join(REPO, ".work", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def device_batch(key, rows):
    """A fresh random batch on the device: packed bits over N_USED samples,
    popcounts, row ids starting at `base`."""
    import jax
    import jax.numpy as jnp
    pk = jax.random.bits(key, (rows, N_PAD // 32), jnp.uint32)
    pk = pk.at[:, -1].set(pk[:, -1] & jnp.uint32((1 << (N_USED % 32)) - 1))
    pc = jnp.sum(jax.lax.population_count(pk), axis=1).astype(jnp.float32)
    return pk, pc


def exact_scores(packed_rows, y_col):
    """f64 scores of packed (m, W32) rows for one phenotype column — the
    reference's double-precision epilogue."""
    import numpy as np
    bits = np.unpackbits(np.ascontiguousarray(packed_rows).view(np.uint8),
                         axis=1, bitorder="little")[:, :N_USED]
    bits = bits.astype(np.float64)
    n = float(N_USED)
    n1 = bits.sum(axis=1)
    r = n * (bits @ y_col) - n1 * y_col.sum()
    denom = n * n1 - n1 * n1
    ok = (n1 >= 51) & (n - n1 >= 51) & (denom > 0)
    return np.where(ok, r * r / np.where(denom > 0, denom, 1.0), 0.0)


def phase_scan_step(seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kmersgwas_tpu.ops import scanstep as ss
    from kmersgwas_tpu.ops import score, topk
    from kmersgwas_tpu.pipeline.scan import certify_eps
    from kmersgwas_tpu.utils import pick_kernel

    kernel = pick_kernel()
    p = N_PERM + 1
    cp = ss.compact_params(SCAN_ROWS, TOP_K)
    rows = cp.shard_rows
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(N_USED, p)).astype(np.float32)
    yp, ysum = score.prepare_phenotypes(y, N_PAD)
    kw = dict(n_used=N_USED, min_count=51, cand_c=cp.cand_c,
              cand_k=cp.cand_k, tile_rows=cp.tile_rows, cand_q=cp.cand_q,
              cand_c2=cp.cand_c2)
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    batches = []
    for b, key in enumerate(keys):
        pk, pc = device_batch(key, rows)
        lo = jnp.arange(rows, dtype=jnp.int32) + b * rows
        batches.append((pk, pc, lo, jnp.zeros(rows, jnp.int32)))

    init = ss.init_buffered_state(p, TOP_K, buf_cap=cp.buf_cap)
    t0 = time.perf_counter()
    compiled = ss.scan_step_compact.lower(
        init, *batches[0], yp, ysum, kernel=kernel, **kw).compile()
    ma = compiled.memory_analysis()
    say("scan", f"compact step kernel={kernel} R={rows} N={N_USED} P={p} "
        f"K={TOP_K} compiled in {time.perf_counter() - t0:.1f}s; memory: "
        f"arguments {ma.argument_size_in_bytes / 2**30:.2f} GiB, temp "
        f"{ma.temp_size_in_bytes / 2**30:.2f} GiB, output "
        f"{ma.output_size_in_bytes / 2**30:.2f} GiB")

    def run(st, **extra):
        for bt in batches:
            st = ss.scan_step_compact(st, *bt, yp, ysum, **kw, **extra)
        return ss.flush_buffered(st)

    got_d = run(init, kernel=kernel)                    # production
    got_h = run(init, kernel=kernel, precision="highest")
    ref = topk.init_state(p, TOP_K)
    with jax.default_matmul_precision("highest"):
        for bt in batches:
            ref = ss.scan_step(ref, *bt, yp, ysum, n_used=N_USED,
                               min_count=51)

    # f64 re-scores of every selected row, from the batches' raw bits
    host_batches = [np.asarray(bt[0]) for bt in batches]

    def rows_of(st):
        return topk.decode_rows(np.asarray(st.row_lo), np.asarray(st.row_hi))

    r_d, r_h, r_p = rows_of(got_d), rows_of(got_h), rows_of(ref)
    s_d, s_h, s_p = (np.asarray(s.scores, np.float64)
                     for s in (got_d, got_h, ref))
    y64 = y.astype(np.float64)
    err_d = err_h = 0.0
    swaps_d = swaps_h = 0
    wobble = 0.0            # swapped rows' distance from the k-th score
    ratio = 0.0             # largest error / certify_eps, 1 at the bound
    eps_all = []
    for j in range(p):
        union = np.union1d(np.union1d(r_d[j], r_h[j]), r_p[j])
        packed = np.stack([host_batches[r // rows][r % rows] for r in union])
        ex = dict(zip(union, exact_scores(packed, y64[:, j])))
        e_d = np.array([ex[r] for r in r_d[j]])
        e_h = np.array([ex[r] for r in r_h[j]])
        kth = ex[r_p[j][-1]]
        eps = certify_eps(y[:, j], N_USED, float(s_d[j][-1]))
        eps_all.append(eps)
        rel_d = float(np.max(np.abs(s_d[j] - e_d) / e_d))
        err_d = max(err_d, rel_d)
        err_h = max(err_h, float(np.max(np.abs(s_h[j] - e_h) / e_h)))
        sw = np.setxor1d(r_d[j], r_p[j])
        swaps_d += len(sw) // 2
        swaps_h += len(np.setxor1d(r_h[j], r_p[j])) // 2
        if len(sw):
            rel_w = float(np.max(np.abs(np.array([ex[r] for r in sw]) - kth)
                                 / kth))
            wobble = max(wobble, rel_w)
            ratio = max(ratio, rel_w / (2 * eps))
        ratio = max(ratio, rel_d / eps)
    say("scan", f"vs plain scan_step (XLA, HIGHEST) over {len(batches)} "
        f"fresh batches: max relative score error against f64 re-scores "
        f"default {err_d:.2e} (bound certify_eps, per column "
        f"{min(eps_all):.2e}..{max(eps_all):.2e}), highest {err_h:.2e} "
        f"(bound 1e-4); selection swaps default {swaps_d}, highest "
        f"{swaps_h} of {p * TOP_K}; swapped rows lie within {wobble:.2e} of "
        f"the k-th score (bound 2 certify_eps); largest error / bound "
        f"{ratio:.3f}")
    check(ratio <= 1.0, f"default score error {ratio:.3f} x certify_eps")
    # "highest" sums exact products in f32; the cancellation in
    # N*yigi - N1*sum(y) lifts that rounding to ~1e-5 of the score
    check(err_h <= 1e-4, f"highest score error {err_h:.3e}")

    # the kernel's tile planes against the XLA tile reduction fed the same
    # operand: bf16-rounded phenotypes for "default", f32 for "highest"
    pk, pc = batches[-1][:2]
    th = got_d.scores[:, -1]
    failures = []
    if kernel != "xla":
        y_bf16 = yp.astype(jnp.bfloat16).astype(jnp.float32)
        xla_hi = jax.jit(functools.partial(
            ss._tilemax, n_used=N_USED, min_count=51, kernel="xla",
            tile_rows=cp.tile_rows, precision="highest"))
        # bounds: the same bf16 operand (and its own column sums) differs
        # only in f32 summation order (1e-5); the three-term split against
        # XLA's f32 dot also in its rounding, amplified by the cancellation
        # N*yigi - N1*sum(y)
        for prec, y_ref, tol in (("default", y_bf16, 1e-5),
                                 ("highest", yp, 1e-4)):
            a = ss._tilemax(pk, pc, yp, ysum, th, N_USED, 51, kernel,
                            cp.tile_rows, prec)
            b = xla_hi(pk, pc, y_ref, jnp.sum(y_ref, axis=0), th)
            a0, b0 = np.asarray(a[0], np.float64), np.asarray(b[0], np.float64)
            hot = b0 >= np.quantile(b0, 0.99, axis=1, keepdims=True)
            rel = float(np.max(np.abs(a0 - b0)[hot] / b0[hot]))
            lanes = float(np.mean(np.asarray(a[1]) == np.asarray(b[1])))
            cnt = float(np.mean(np.asarray(a[8]) == np.asarray(b[8])))
            say("scan", f"kernel planes ({prec}) vs XLA tile reduction on "
                f"the same operand (HIGHEST): tile-max rel err over each "
                f"column's hottest 1% of tiles {rel:.2e} (bound {tol:g}), lane "
                f"agreement {lanes:.5f}, hot-count agreement {cnt:.5f}")
            if rel > tol:
                failures.append(f"tile-max error {rel:.3e} ({prec})")

    # per-step time, kernel against the plain XLA tile reduction, over
    # fresh batches (re-fed rows would tie the buffered ones and keep the
    # step on its fallback)
    fresh = []
    for b, key in enumerate(jax.random.split(jax.random.PRNGKey(seed + 7),
                                             10)):
        fpk, fpc = device_batch(key, rows)
        flo = jnp.arange(rows, dtype=jnp.int32) + (len(batches) + b) * rows
        fresh.append((fpk, fpc, flo, jnp.zeros(rows, jnp.int32)))

    def step_ms(knl):
        st = init
        for bt in batches:
            st = ss.scan_step_compact(st, *bt, yp, ysum, kernel=knl, **kw)
        jax.block_until_ready(st)
        t = time.perf_counter()
        for bt in fresh:
            st = ss.scan_step_compact(st, *bt, yp, ysum, kernel=knl, **kw)
        jax.block_until_ready(st)
        return (time.perf_counter() - t) / len(fresh) * 1e3

    def tilemax_ms(knl, n=10):
        f = jax.jit(functools.partial(
            ss._tilemax, n_used=N_USED, min_count=51, kernel=knl,
            tile_rows=cp.tile_rows))
        jax.block_until_ready(f(pk, pc, yp, ysum, th))
        t = time.perf_counter()
        for _ in range(n):
            out = f(pk, pc, yp, ysum, th)
        jax.block_until_ready(out)
        return (time.perf_counter() - t) / n * 1e3

    times = {k: (tilemax_ms(k), step_ms(k))
             for k in dict.fromkeys([kernel, "xla"])}
    say("scan", "ms per 2M-row batch (score + tile top-3 | whole compact "
        "step): " + ", ".join(f"{k} {a:.3f} | {b:.3f}"
                              for k, (a, b) in times.items()))
    check(not failures, "; ".join(failures))


def phase_kinship(seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kmersgwas_tpu.ops import bitplanes, kinship

    rows = KIN_ROWS
    rng = np.random.default_rng(seed + 1)
    bits = (rng.random((rows, N_USED)) < 0.4).astype(np.uint8)
    padded = np.zeros((rows, N_PAD), np.uint8)
    padded[:, :N_USED] = bits
    packed = bitplanes.pack_bits_np(padded)
    acc = kinship.KinshipAccumulator(n_used=N_USED, n_pad=N_PAD)
    acc.add(jnp.asarray(packed))
    acc.flush()
    a = 2.0 * bits - 1.0                     # exact in f64: |sums| <= 2^16
    ref = (a.T @ a).astype(np.int64)
    same = bool(np.array_equal(acc.total, ref))
    ma = kinship.kinship_accumulate.lower(
        jax.ShapeDtypeStruct((N_PAD, N_PAD), jnp.int32),
        jax.ShapeDtypeStruct((1 << 20, N_PAD // 32), jnp.uint32)
    ).compile().memory_analysis()
    say("kinship", f"{rows} rows x {N_USED}: bit-exact vs NumPy integer "
        f"XNOR count: {same}; kinship_accumulate at 1M rows: temp "
        f"{ma.temp_size_in_bytes / 2**30:.2f} GiB, arguments "
        f"{ma.argument_size_in_bytes / 2**30:.2f} GiB")
    check(same, "kinship differs from the integer reference")


def phase_lmm(seed):
    import jax
    import numpy as np
    from kmersgwas_tpu.ops import bitplanes
    from kmersgwas_tpu.pipeline.gwas import _stats_device
    from kmersgwas_tpu.stats import lmm

    rng = np.random.default_rng(seed + 2)
    cols, m = LMM_SHAPE
    g = rng.normal(size=(N_USED, N_USED // 4))
    w, U = np.linalg.eigh(g @ g.T / g.shape[1])
    bits = (rng.random((cols, m, N_USED)) < 0.3).astype(np.uint8)
    ys = rng.normal(size=(cols, N_USED)) + 0.3 * bits[:, :8, :].sum(axis=1)
    ys -= ys.mean(axis=1, keepdims=True)
    padded = np.zeros((cols, m, N_PAD), np.uint8)
    padded[..., :N_USED] = bits
    packed = bitplanes.pack_bits_np(padded)
    t = time.perf_counter()
    got = lmm.lmm_scan_columns_packed(packed, ys, w, U, n=N_USED)
    p_got = np.asarray(got.p_lrt, np.float64)
    t_dev = time.perf_counter() - t
    t = time.perf_counter()
    with _stats_device(), jax.default_matmul_precision("highest"):
        ref = lmm.lmm_scan_columns(bits.astype(np.float64), ys, w, U)
        p_ref = np.asarray(ref.p_lrt, np.float64)
    t_host = time.perf_counter() - t
    # compare on the statistic's scale: LRT = 2 erfcinv(p)^2 (chi2, 1 df)
    from scipy.special import erfcinv
    lrt_got = 2.0 * erfcinv(p_got) ** 2
    lrt_ref = 2.0 * erfcinv(p_ref) ** 2
    d_lrt = float(np.max(np.abs(lrt_got - lrt_ref)))
    d_abs = float(np.max(np.abs(p_got - p_ref)))
    small = p_ref < 1e-3
    d_log = float(np.max(np.abs(np.log10(p_got[small])
                                - np.log10(p_ref[small])))) if small.any() \
        else 0.0
    # bounds from the f32 arithmetic: each log-likelihood (|ll| ~ 1.6e3 at
    # n = 1,008) carries f32 rounding of its n-term sums (sum log v up to
    # ~1.6e4, n log rss) of ~log2(n) 2^-24 relative, ~1.3e-2 in all, so
    # LRT = 2 (ll1 - ll0) is good to LRT_TOL. p = erfc(sqrt(LRT / 2)) moves
    # by at most sqrt(2 |dLRT| / pi) (its slope is unbounded as LRT -> 0,
    # which is where the weak signals' |dp| comes from), and -log10 p by
    # at most 0.24 |dLRT| where p < 1e-3 (LRT > 10.8)
    lrt_tol = LMM_LRT_TOL
    p_tol, log_tol = float(np.sqrt(2 * lrt_tol / np.pi)), 0.24 * lrt_tol
    say("lmm", f"device32 vs host64 on {cols} x {m} x n={N_USED}: max "
        f"|dLRT| {d_lrt:.2e} (bound {lrt_tol:g}), max |d log10 p| over "
        f"{small.sum()} p<1e-3 {d_log:.2e} (bound {log_tol:.3g}), max |dp| "
        f"{d_abs:.2e} (bound {p_tol:.3g}); device {t_dev:.1f}s incl. "
        f"compile, host {t_host:.1f}s")
    check(d_lrt <= lrt_tol and d_log <= log_tol and d_abs <= p_tol,
          "device32 p-values off")


def planted_gwas_inputs(work, rows, seed):
    """Synthetic 1001G-shaped table with 8 planted causal k-mers
    (tools/at_scale_run.gen_table) and a phenotype they drive."""
    import importlib.util

    import numpy as np
    from kmersgwas_tpu.core import codec, formats
    spec = importlib.util.spec_from_file_location(
        "at_scale_run", os.path.join(REPO, "tools", "at_scale_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    base = os.path.join(work, "pop")
    causal, carriers = mod.gen_table(base, rows, N_USED, KMER_LEN, seed=seed)
    g = carriers.astype(np.float64)
    rng = np.random.default_rng(seed + 42)
    y = (0.6 * ((g - g.mean(axis=1, keepdims=True))
                / g.std(axis=1, keepdims=True)).sum(axis=0)
         + rng.normal(size=N_USED))
    pheno = os.path.join(work, "pheno.pheno")
    formats.write_phenotypes(pheno, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=[f"acc{i}" for i in
                                               range(N_USED)],
        values=y[:, None]))
    truth = set(codec.decode_kmers(np.asarray(causal, np.uint64), KMER_LEN))
    return base, pheno, truth


def phase_end_to_end(seed, rows):
    from kmersgwas_tpu.pipeline.gwas import GWASConfig, run_gwas

    work = workdir("smoke")
    try:
        t = time.perf_counter()
        base, pheno, truth = planted_gwas_inputs(work, rows, seed)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        res = run_gwas(GWASConfig(
            pheno_path=pheno, kmers_table=base,
            outdir=os.path.join(work, "out"), kmer_len=KMER_LEN,
            n_kmers=TOP_K, n_permutations=N_PERM, maf=0.05,
            batch_size=2_000_000, dtable_cache=base + ".dtable", seed=1))
        total = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    passed = {s for s, _ in res.pass_5per}
    hit, fp = len(passed & truth), len(passed - truth)
    stages = ", ".join(f"{k} {v:.1f}" for k, v in res.stage_seconds.items())
    say("e2e", f"run_gwas on {rows:,} rows x {N_USED} accessions (cut from "
        f"the study's ~{STUDY_ROWS:.0e} rows), k={KMER_LEN}, {N_PERM} "
        f"permutations, top-{TOP_K}, MAF 0.05, dtable cache, 2M-row batches: "
        f"recovered {hit}/{len(truth)} planted, {fp} false positives, "
        f"tested {res.n_tested:,}; seconds: generate {t_gen:.1f}, pipeline "
        f"{total:.1f} ({stages})")
    check(hit == len(truth) and fp == 0, f"recovered {hit}, {fp} false pos")


def one_card(args):
    import jax
    from kmersgwas_tpu.utils import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu", f"no GPU: JAX found {dev.platform}")
    cards = card_lines()
    say("device", f"platform {dev.platform}, kind {dev.device_kind}, count "
        f"{len(devs)}; nvidia-smi: {'; '.join(cards)}")
    failed = []
    for name, fn in (("scan", lambda: phase_scan_step(args.seed)),
                     ("kinship", lambda: phase_kinship(args.seed)),
                     ("lmm", lambda: phase_lmm(args.seed)),
                     ("e2e", lambda: phase_end_to_end(args.seed, args.rows))):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:                   # report, then fail below
            failed.append(name)
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
        say(name, f"phase seconds {time.perf_counter() - t:.1f}")
    check(not failed, f"failed phases: {', '.join(failed)}")
    return cards, {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def four_card_jax_checks(work, rows, seed, n_dev=4, require_gpu=True):
    """In a JAX process that sees the cards: sharded associate and sharded
    kinship against one card. Returns the device description."""
    import jax
    import numpy as np
    from kmersgwas_tpu.parallel import sharding
    from kmersgwas_tpu.pipeline import kinship as km
    from kmersgwas_tpu.pipeline import scan as scan_mod
    from kmersgwas_tpu.utils import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    check(not require_gpu or devs[0].platform == "gpu",
          f"no GPU: JAX found {devs[0].platform}")
    check(len(devs) >= n_dev, f"{len(devs)} devices, need {n_dev}")
    mesh = sharding.make_mesh(devs[:n_dev])
    base, _, _ = planted_gwas_inputs(work, rows, seed)
    names = [f"acc{i}" for i in range(N_USED)]
    y = np.random.default_rng(seed).normal(size=(N_USED, N_PERM + 1))
    cols = [f"c{j}" for j in range(N_PERM + 1)]
    kw = dict(kmer_len=KMER_LEN, n_top=TOP_K, maf=0.05, mac=5,
              batch_size=2_000_000)
    t = time.perf_counter()
    one = scan_mod.associate(base, names, y, cols, **kw)
    t_one = time.perf_counter() - t
    t = time.perf_counter()
    four = scan_mod.associate(base, names, y, cols, mesh=mesh, **kw)
    t_four = time.perf_counter() - t
    same_rows = all(np.array_equal(a, b) for a, b in zip(one.rows, four.rows))
    d_sc = max(float(np.max(np.abs(a - b) / np.abs(b)))
               for a, b in zip(four.scores, one.scores))
    say("4-card", f"sharded associate over {n_dev} devices, {rows:,} rows x "
        f"{N_PERM + 1} columns, top-{TOP_K}: rows equal {same_rows}, max "
        f"relative score difference {d_sc:.1e} (bound 1e-6); seconds one "
        f"{t_one:.1f}, sharded {t_four:.1f}")
    check(same_rows and d_sc <= 1e-6, "sharded associate differs")
    K1 = km.kinship_from_table(base, maf=0.05)
    K4 = km.kinship_from_table(base, maf=0.05, mesh=mesh)
    say("4-card", f"sharded kinship bit-exact: {np.array_equal(K1, K4)}")
    check(np.array_equal(K1, K4), "sharded kinship differs")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": n_dev}


def four_card_gwas_mp(work, rows, seed, n_proc=4):
    """Single-process `gwas` on one card, then `gwas-mp` as n_proc
    processes with one card each (CUDA_VISIBLE_DEVICES); their artifacts
    must be byte-equal. Runs the CLI in child processes only."""
    import socket
    if not os.path.exists(os.path.join(work, "pop.table")):
        subprocess.run([sys.executable, "-c",
                        "import chip_smoke as c; c.planted_gwas_inputs("
                        f"{work!r}, {rows}, {seed})"],
                       cwd=REPO, check=True, env=dict(
                           os.environ, JAX_PLATFORMS="cpu"))
    base, pheno = os.path.join(work, "pop"), os.path.join(work, "pheno.pheno")
    common = ["--pheno", pheno, "--kmers_table", base, "-l", str(KMER_LEN),
              "-k", str(TOP_K), "--permutations", str(N_PERM),
              "--batch_size", "2000000", "--seed", "1"]
    out1 = os.path.join(work, "gwas_one")
    t = time.perf_counter()
    subprocess.run([sys.executable, "-m", "kmersgwas_tpu.cli", "gwas",
                    "--outdir", out1, *common], cwd=REPO,
                   env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"),
                   check=True, timeout=900)
    t_one = time.perf_counter() - t
    # the single run cached the kinship beside the table; the mp run must
    # compute its own (distributed) kinship
    os.remove(base + ".kinship")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outm = os.path.join(work, "gwas_mp")
    t = time.perf_counter()
    procs = []
    for i in range(n_proc):
        cmd = [sys.executable, "-m", "kmersgwas_tpu.cli", "gwas-mp",
               "--outdir", outm, *common, "--coordinator", f"localhost:{port}",
               "--num_processes", str(n_proc), "--process_id", str(i)]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=dict(
            os.environ, CUDA_VISIBLE_DEVICES=str(i))))
    try:
        rcs = [pr.wait(timeout=900) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    t_mp = time.perf_counter() - t
    check(rcs == [0] * n_proc, f"gwas-mp exit codes {rcs}")
    differ, n_files = [], 0
    for root, _, files in os.walk(out1):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), out1)
            if rel in ("summary.json", "log_file"):   # timings, topology
                continue
            n_files += 1
            other = os.path.join(outm, rel)
            if not os.path.exists(other) or open(
                    os.path.join(root, f), "rb").read() != open(
                        other, "rb").read():
                differ.append(rel)
    say("4-card", f"gwas-mp as {n_proc} processes (one card each) vs "
        f"single-process gwas, {rows:,} rows: {n_files - len(differ)}/"
        f"{n_files} artifacts byte-equal; seconds single {t_one:.1f}, "
        f"mp {t_mp:.1f}")
    check(not differ and n_files > 0, f"artifacts differ: {differ[:5]}")


def four_cards(args):
    """Parent of the four-card run: stays off JAX; one child holds all four
    cards for the sharded checks, then the CLI children run one card each."""
    work = workdir("four")
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--four-cards-child",
             "--rows", str(args.rows), "--seed", str(args.seed)],
            cwd=REPO, capture_output=True, text=True, timeout=1200)
        sys.stderr.write(r.stderr)
        lines = r.stdout.splitlines()
        print("\n".join(lines[:-1]), flush=True)
        check(r.returncode == 0 and lines, "sharded checks failed")
        device = json.loads(lines[-1])
        four_card_gwas_mp(work, args.rows, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return card_lines(), device


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None,
                    help="synthetic table rows (default 16M; 4M with "
                         "--four-cards)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--four-cards-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rows is None:
        args.rows = 4_000_000 if args.four_cards or args.four_cards_child \
            else 16_000_000
    if not os.path.isdir(os.path.join(REPO, "kmersgwas_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        if args.four_cards_child:
            work = os.path.join(REPO, ".work", "four")
            print(json.dumps(four_card_jax_checks(work, args.rows,
                                                  args.seed)))
            return 0
        cards, device = (four_cards if args.four_cards else one_card)(args)
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    for line in cards:
        print(line)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
