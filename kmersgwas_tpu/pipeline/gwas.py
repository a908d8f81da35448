"""End-to-end k-mer GWAS pipeline (kmers_gwas.py equivalent, single process).

Stages, mirroring the reference orchestration (/root/reference/kmers_gwas.py:50-274)
with the external R/GEMMA processes replaced by in-framework JAX stages:

  1. phenotype load + per-accession averaging        (average_phenotypes.awk)
  2. intersect phenotype x kinship x table accessions (align_kinship_phenotype.py)
  3. REML variance components, covariance-preserving permutations,
     GRAMMAR transform                                (transform_and_permute_phenotypes.R)
  4. device association scan, top-k per column        (associate_kmers)
  5. exact ML-LRT mixed model on the candidates       (GEMMA -lmm 2 farm)
  6. permutation thresholds + pass_threshold files    (functions.py awk post-processing)

Artifacts are written with reference-compatible names under `outdir` so
downstream tooling built for the original can consume them.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core import codec, formats
from ..stats import lmm as lmm_mod
from ..stats import transform as transform_mod
from . import kinship as kinship_mod
from . import scan as scan_mod
from .align import average_phenotypes, intersect_accessions


@dataclass
class GWASConfig:
    pheno_path: str
    kmers_table: str
    outdir: str
    kmer_len: int
    n_kmers: int = 10001
    n_permutations: int = 100
    maf: float = 0.05
    mac: int = 5
    min_data_points: int = 30
    batch_size: int = 2_000_000
    pattern_counter: bool = False
    kinship_maf: float = 0.05
    kinship_path: str | None = None     # precomputed kinship (else from table)
    seed: int = 0
    lmm_grid: int = 64
    lmm_refine: int = 40
    lmm_backend: str = "auto"           # "auto" | "host64" | "device32":
                                        # host64 = CPU float64 (R/GEMMA
                                        # precision); device32 = packed bits
                                        # + f32 profile-LL on the accelerator
                                        # (the GEMMA farm as one device jit);
                                        # auto picks device32 for large
                                        # candidate sets when an accelerator
                                        # is present
    run_kmers: bool = True
    snps_matrix: str | None = None      # PLINK base for the SNP arm
    run_snps: str | None = None         # None | "one_step" | "two_steps"
    n_snps: int = 10001
    dtable_cache: str | None = None
    kinship_snps: bool = False          # kinship from the SNP matrix instead
                                        # of the k-mers table (--kinship_snps,
                                        # pipeline_parser.py:86)
    n_extra_phenotype_kmers: int | None = None  # heap size override for the
                                        # real phenotype column
                                        # (--kmers_for_no_perm_phenotype ->
                                        # associate_kmers --first_phenotype_best)
    remove_intermediates: bool = True   # reference default: delete permutation
                                        # PLINK artifacts + gzip assoc.txt
                                        # (kmers_gwas.py:259-271);
                                        # --dont_remove_intermediates disables
    n_devices: int | None = None        # >1: shard the scan AND kinship over
                                        # a k-mer-axis device mesh
                                        # (parallel/sharding.py)
    checkpoint_base: str | None = None  # base path for resumable kinship/scan
                                        # checkpoints (<base>.kin / <base>.scan;
                                        # per-process suffixes in gwas-mp)
    checkpoint_every: int = 20          # batches between checkpoint writes
                                        # (both stages)
    score_precision: str = "default"    # scan score-GEMM precision:
                                        # "default" (bf16 phenotype operand,
                                        # up to ~7e-3 relative — candidates
                                        # are exactly re-scored by the LMM) |
                                        # "highest" (f32-faithful); same
                                        # knob as associate --score_precision


@dataclass
class GWASResult:
    thresholds: dict                    # {"5per": x, "10per": y} in -log10(p)
    best_pvals: dict                    # column name -> -log10(best p)
    pass_5per: list = field(default_factory=list)   # (kmer_str, p) passing 5%
    pass_10per: list = field(default_factory=list)
    heritability: float = 0.0
    n_tested: int = 0
    stage_seconds: dict = field(default_factory=dict)  # per-stage wall-clock


def _stats_device():
    """Context running the statistical layer on the host CPU backend in
    float64 (REML/eigh/LMM are tiny next to the scan; the R/GEMMA stack they
    replace was double precision). The scan kernels pin their own dtypes and
    devices, so the global x64 switch does not affect them.

    Fallback: sessions whose JAX_PLATFORMS leaves out the CPU expose no CPU
    backend — there the stats run in f32 on the default device (REMLE delta
    still ~1e-3 relative; p-values are computed in log space, so ranking
    and threshold decisions are unaffected) and a warning says so."""
    import contextlib
    import jax
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        import warnings
        warnings.warn("no CPU backend (JAX_PLATFORMS); REML/LMM statistics "
                      "run in float32 on the default device", RuntimeWarning)
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    # scoped x64: a GLOBAL jax_enable_x64 flip would leak i64 into the
    # scan kernel's index maps and argmax lanes.
    # jax.enable_x64 is the public scoped context (jax >= 0.9); older
    # versions had it under jax.experimental.
    enable_x64 = getattr(jax, "enable_x64", None)
    if enable_x64 is None:
        try:
            from jax.experimental import enable_x64
        except ImportError:
            enable_x64 = None
    if enable_x64 is not None:
        stack.enter_context(enable_x64(True))
    else:
        import warnings
        warnings.warn("scoped x64 unavailable in this jax version; "
                      "REML/LMM statistics will run in float32",
                      RuntimeWarning)
    stack.enter_context(jax.default_device(cpu))
    return stack


def _persist_kinship(cfg: GWASConfig, out: Path, K_full, log) -> None:
    """Cache the computed kinship beside the table (so reruns and the
    other stages find it) — falling back into `outdir` when the table's
    directory is read-only (a common shared-FS deployment): the ~5-day
    reference stage must never be lost to a permissions error."""
    try:
        kinship_mod.write_kinship(cfg.kmers_table + ".kinship", K_full)
    except OSError as e:
        alt = out / "full_table.kinship"
        kinship_mod.write_kinship(alt, K_full)
        log(f"kinship cache beside the table failed ({e}); wrote {alt} — "
            "pass it via --kinship on reruns")


def run_gwas(cfg: GWASConfig) -> GWASResult:
    import time as _time
    out = Path(cfg.outdir)
    out.mkdir(parents=True, exist_ok=True)
    log_lines = []
    stage_seconds = {}

    def log(msg):
        log_lines.append(str(msg))

    import contextlib

    @contextlib.contextmanager
    def stage(name):
        t0 = _time.perf_counter()
        yield
        dt = _time.perf_counter() - t0
        stage_seconds[name] = stage_seconds.get(name, 0.0) + dt
        log(f"[stage] {name}: {dt:.2f}s")

    # 1. phenotype: load + average duplicate accessions
    pheno = formats.read_phenotypes(cfg.pheno_path)
    accs, vals = average_phenotypes(pheno.accessions, pheno.values[:, 0])
    table_names = formats.read_names(cfg.kmers_table)

    mesh = None
    if cfg.n_devices and cfg.n_devices > 1:
        import jax
        from ..parallel import sharding as shard_mod
        mesh = shard_mod.make_mesh(jax.devices()[:cfg.n_devices])

    # 2. kinship + intersection. --kinship_snps selects the SNP-matrix
    # kinship over the k-mers one (kmers_gwas.py:80-87); accession order then
    # follows the SNP .fam, like the reference's snps_fam handling (:68-77)
    if cfg.kinship_path:
        K_full = kinship_mod.read_kinship(cfg.kinship_path)
        kin_names = table_names
    elif cfg.kinship_snps and cfg.snps_matrix:
        kin_names = formats.read_fam_names(cfg.snps_matrix + ".fam")
        if os.path.exists(cfg.snps_matrix + ".kinship"):
            K_full = kinship_mod.read_kinship(cfg.snps_matrix + ".kinship")
            log("Using kinship calculated on SNPs")
        else:
            log("computing kinship from SNP matrix")
            from ..snps.kinship import emma_kinship_from_bed
            K_full = emma_kinship_from_bed(cfg.snps_matrix)
            kinship_mod.write_kinship(cfg.snps_matrix + ".kinship", K_full)
    elif os.path.exists(cfg.kmers_table + ".kinship"):
        K_full = kinship_mod.read_kinship(cfg.kmers_table + ".kinship")
        kin_names = table_names
    else:
        log("computing kinship from k-mers table")
        with stage("kinship"):
            # the scan's dtable cache feeds kinship too when its stored
            # filter matches (kinship_from_table validates and falls back)
            K_full = kinship_mod.kinship_from_table(
                cfg.kmers_table, maf=cfg.kinship_maf,
                dtable_cache=cfg.dtable_cache, mesh=mesh,
                checkpoint_path=(cfg.checkpoint_base + ".kin"
                                 if cfg.checkpoint_base else None),
                checkpoint_every=cfg.checkpoint_every)
        kin_names = table_names
        _persist_kinship(cfg, out, K_full, log)

    used, y, K = intersect_accessions(accs, vals, kin_names, K_full, table_names)
    n = len(used)
    if n < cfg.min_data_points:
        (out / "NOT_ENOUGH_DATA").touch()
        raise ValueError(f"only {n} phenotyped accessions (< {cfg.min_data_points})")
    np.savetxt(out / "pheno.kinship", K, delimiter="\t")
    formats.write_phenotypes(out / "pheno.phenotypes", formats.PhenotypeTable(
        names=["phenotype_value"], accessions=used, values=y[:, None]))

    # 3. transform + permutations
    with stage("transform"), _stats_device():
        tr = transform_mod.transform_and_permute(y, K, cfg.n_permutations, seed=cfg.seed)
    log(f"EMMA vg={tr.vg} ve={tr.ve} herit={tr.heritability}")
    formats.write_phenotypes(out / "pheno.phenotypes_and_permutations",
                             formats.PhenotypeTable(tr.names, used, tr.phenotypes))
    formats.write_phenotypes(out / "pheno.phenotypes_permuted_transformed",
                             formats.PhenotypeTable(tr.names, used, tr.transformed))

    # 3b. optional SNP arm (kmers_gwas.py:179-223)
    snp_summary = None
    if cfg.run_snps:
        if cfg.snps_matrix is None:
            raise ValueError("run_snps requires snps_matrix")
        w_eig_s, U_eig_s = np.linalg.eigh(K)
        from .snp_gwas import run_snp_arm
        with _stats_device():
            snp_summary = run_snp_arm(
                cfg.snps_matrix, cfg.outdir, used, tr.phenotypes,
                tr.transformed, tr.names, w_eig_s, U_eig_s, mode=cfg.run_snps,
                n_snps=cfg.n_snps, maf=cfg.maf, mac=cfg.mac,
                n_permutations=cfg.n_permutations, lmm_grid=cfg.lmm_grid,
                lmm_refine=cfg.lmm_refine)

    if not cfg.run_kmers:
        (out / "log_file").write_text("\n".join(log_lines) + "\n")
        return GWASResult(thresholds=(snp_summary or {}).get("thresholds", {}),
                          best_pvals=(snp_summary or {}).get("best_pvals", {}),
                          heritability=tr.heritability)

    # 4. association scan -> top-k per column
    kmers_dir = out / "kmers"
    kmers_dir.mkdir(exist_ok=True)
    mesh = None
    if cfg.n_devices and cfg.n_devices > 1:
        import jax
        from ..parallel import sharding as shard_mod
        mesh = shard_mod.make_mesh(jax.devices()[:cfg.n_devices])
    with stage("scan"):
        result = scan_mod.associate(
            cfg.kmers_table, used, tr.transformed, tr.names,
            kmer_len=cfg.kmer_len, n_top=cfg.n_kmers, maf=cfg.maf, mac=cfg.mac,
            batch_size=cfg.batch_size, count_patterns=cfg.pattern_counter,
            dtable_cache=cfg.dtable_cache,
            first_phenotype_top=cfg.n_extra_phenotype_kmers, mesh=mesh,
            score_precision=cfg.score_precision,
            checkpoint_path=(cfg.checkpoint_base + ".scan"
                             if cfg.checkpoint_base else None),
            checkpoint_every=cfg.checkpoint_every)
    return _post_scan_stages(cfg, out, kmers_dir, result, tr, used, K, n,
                             log, log_lines, stage_seconds)


def _post_scan_stages(cfg: GWASConfig, out: Path, kmers_dir: Path, result,
                      tr, used, K, n: int, log, log_lines,
                      stage_seconds) -> GWASResult:
    """Stages 5-6 of the pipeline (exact LMM on candidates, permutation
    thresholds, pass files, cleanup, summary) — shared verbatim between the
    single-process `run_gwas` and the multi-host `run_distributed_gwas`
    (process 0 runs this on the merged candidates), so the two products
    write byte-identical artifacts from identical candidates."""
    (kmers_dir / "pheno.tested_kmers").write_text(f"{result.n_tested}\n")
    for sub, v in result.timings.items():
        stage_seconds[f"scan.{sub}"] = v
        log(f"[stage] scan.{sub}: {v:.2f}s")
    if result.n_patterns is not None:
        (kmers_dir / "pheno.pattern_counter").write_text(f"{result.n_patterns}\n")

    # winners' PLINK artifacts per column, reference-named pheno.<j>.<name>.*
    # (associate_kmers' pass-2 export + the fam rewrite with UNtransformed
    # values, kmers_gwas.py:152-160)
    plink_bases = [str(kmers_dir / f"pheno.{j}.{name}")
                   for j, name in enumerate(tr.names)]
    scan_mod.export_plink(result, n, cfg.kmer_len, plink_bases)
    for j, base in enumerate(plink_bases):
        formats.write_fam(base + ".fam", used, tr.phenotypes[:, j])

    # 5. exact LMM on candidates — columns batched into chunked vmapped
    # dispatches (the reference's ~101-process GEMMA farm, functions.py:61-66,
    # becomes a handful of (chunk, M, n) kernels)
    from ..utils import StageTimer
    w_eig, U_eig = np.linalg.eigh(K)
    min_count = scan_mod.effective_min_count(n, cfg.maf, cfg.mac)
    output_dir = kmers_dir / "output"
    output_dir.mkdir(exist_ok=True)
    best_pvals = {}
    first_assoc = None
    lmm_timer = StageTimer("lmm", "variants")
    lmm_t0 = __import__("time").perf_counter()
    results_by_col = {}
    # group columns by candidate count so stacks are rectangular (column 0
    # may use a different heap size via n_extra_phenotype_kmers)
    by_m = {}
    for j in range(len(tr.names)):
        by_m.setdefault(len(result.rows[j]), []).append(j)
    max_m = max(by_m) if by_m else 1
    m_total = sum(m * len(cs) for m, cs in by_m.items())
    backend = cfg.lmm_backend
    if backend == "auto":
        import jax as _jax
        backend = ("device32" if m_total * n > 2e8
                   and _jax.default_backend() != "cpu" else "host64")
    log(f"lmm backend: {backend} ({m_total} variant-tests, n={n})")
    if backend == "device32":
        # packed bits + f32 on the accelerator: ~n/8 bytes per genotype
        # shipped instead of 8, and the profile-LL grid runs as one kernel
        chunk_cols = max(1, int(1e9 // max(1, 4 * n * max_m)))
    else:
        # ~800 MB of f64 genotype stack per dispatch
        chunk_cols = max(1, int(8e8 // max(1, 8 * n * max_m)))
    n64 = (n + 63) // 64
    for m, cols in sorted(by_m.items()):
        if m == 0:
            for j in cols:
                results_by_col[j] = (np.empty(0), np.empty(0), np.empty(0))
            continue
        for s in range(0, len(cols), chunk_cols):
            grp = cols[s:s + chunk_cols]
            ys = np.stack([tr.phenotypes[:, j] - tr.phenotypes[:, j].mean()
                           for j in grp])   # UNtransformed (kmers_gwas.py:152-160)
            if backend == "device32":
                gp = np.stack([
                    np.asarray(result.pa_rows.take(result.rows[j]))
                    for j in grp]).reshape(len(grp), m, n64).view("<u4")
                res = lmm_mod.lmm_scan_columns_packed(
                    gp, ys, w_eig, U_eig, n=n,
                    n_grid=cfg.lmm_grid, n_refine=cfg.lmm_refine)
            else:
                genos = np.stack([
                    _pa_bits_batch(np.asarray(result.pa_rows.take(
                        result.rows[j])), n) for j in grp])
                with _stats_device():
                    res = lmm_mod.lmm_scan_columns(genos, ys, w_eig, U_eig,
                                                   n_grid=cfg.lmm_grid,
                                                   n_refine=cfg.lmm_refine)
            for gi, j in enumerate(grp):
                results_by_col[j] = (
                    np.asarray(res.p_lrt[gi], dtype=np.float64),
                    np.asarray(res.log10_lambda[gi], dtype=np.float64),
                    np.asarray(res.beta[gi], dtype=np.float64))
            lmm_timer.add(m * len(grp))
    lmm_timer.done()
    stage_seconds["lmm"] = __import__("time").perf_counter() - lmm_t0
    log(f"[stage] lmm: {stage_seconds['lmm']:.2f}s")

    for j, cname in enumerate(tr.names):
        pvals, lam, beta = results_by_col[j]
        _write_assoc_txt(output_dir / f"{cname}.assoc.txt", result, j,
                         cfg.kmer_len, n, pvals, lam, beta)
        best = float(pvals.min()) if len(pvals) else 1.0
        best_pvals[cname] = -math.log10(max(best, 1e-300))
        if j == 0:
            first_assoc = (result.kmers[j], pvals)

    # 6. permutation thresholds + pass files
    th5 = transform_mod.permutation_threshold(best_pvals, cfg.n_permutations, 0.05) \
        if cfg.n_permutations else float("inf")
    th10 = transform_mod.permutation_threshold(best_pvals, cfg.n_permutations, 0.10) \
        if cfg.n_permutations else float("inf")
    (kmers_dir / "threshold_5per").write_text(f"{th5:f}\n")
    (kmers_dir / "threshold_10per").write_text(f"{th10:f}\n")
    with open(kmers_dir / "best_pvals", "w") as f:
        for name, v in best_pvals.items():
            f.write(f"{name}\t{v}\n")

    pass5, pass10 = [], []
    if first_assoc is not None and len(first_assoc[1]):
        kk, pp = first_assoc
        strs = codec.decode_kmers(kk, cfg.kmer_len)
        for s, p in zip(strs, pp):
            mlp = -math.log10(max(p, 1e-300))
            if mlp > th5:
                pass5.append((s, float(p)))
            if mlp > th10:
                pass10.append((s, float(p)))
    for fname, rows_ in (("pass_threshold_5per", pass5), ("pass_threshold_10per", pass10)):
        with open(kmers_dir / fname, "w") as f:
            for s, p in rows_:
                f.write(f"{s}\t{p:.6e}\n")

    # clean intermediates: drop permutation-column PLINK + assoc artifacts,
    # gzip the real phenotype's assoc table (kmers_gwas.py:259-271; disabled
    # by --dont_remove_intermediates)
    if cfg.remove_intermediates:
        import gzip
        import shutil
        for j, name in enumerate(tr.names):
            if name == "phenotype_value":
                continue
            for ext in (".bed", ".bim", ".fam"):
                Path(plink_bases[j] + ext).unlink(missing_ok=True)
            (output_dir / f"{name}.assoc.txt").unlink(missing_ok=True)
        src = output_dir / "phenotype_value.assoc.txt"
        if src.exists():
            # mtime=0: identical content -> identical .gz bytes (runs are
            # reproducible and mp/single artifacts byte-comparable)
            with open(src, "rb") as fi, open(str(src) + ".gz", "wb") as fz, \
                    gzip.GzipFile(fileobj=fz, mode="wb", mtime=0) as fo:
                shutil.copyfileobj(fi, fo)
            src.unlink()

    (out / "log_file").write_text("\n".join(log_lines) + "\n")
    (out / "summary.json").write_text(json.dumps({
        "n_accessions": n, "heritability": tr.heritability,
        "threshold_5per": th5, "threshold_10per": th10,
        "n_tested": result.n_tested,
        # result provenance: which exact-LMM backend produced the p-values
        # ("auto" cuts over to the f32 device path above 2e8 variant-tests
        # x samples; -log10 p within ~1e-2 of the f64 route where p < 1e-3
        # — see PARITY.md)
        "lmm_backend": backend,
        "score_precision": cfg.score_precision,
        "n_pass_5per": len(pass5), "n_pass_10per": len(pass10),
        "stage_seconds": {k: round(v, 3) for k, v in stage_seconds.items()},
    }, indent=2))
    return GWASResult(thresholds={"5per": th5, "10per": th10},
                      best_pvals=best_pvals, pass_5per=pass5, pass_10per=pass10,
                      heritability=tr.heritability, n_tested=result.n_tested,
                      stage_seconds=stage_seconds)


def _pa_bits(pa_words: np.ndarray, n: int) -> np.ndarray:
    bits = np.unpackbits(pa_words.view(np.uint8), bitorder="little")
    return bits[:n].astype(np.float64)


def _pa_bits_batch(pa_words: np.ndarray, n: int) -> np.ndarray:
    """(m, n64) packed uint64 -> (m, n) float64 bit matrix, one unpack."""
    if pa_words.size == 0:
        # zeros, not empty: a zero-row caller must never consume
        # uninitialized allele frequencies (ADVICE r4)
        return np.zeros((pa_words.shape[0], n))
    bits = np.unpackbits(np.ascontiguousarray(pa_words).view(np.uint8),
                         axis=1, bitorder="little")
    return bits[:, :n].astype(np.float64)


def _write_assoc_txt(path, result, j, kmer_len, n, pvals, lam, beta):
    """GEMMA-compatible assoc.txt: 9 columns, p_lrt in column 9 — the layout
    the reference's awk post-processing consumes (functions.py:93-105)."""
    kk = result.kmers[j]
    strs = codec.decode_kmers(kk, kmer_len) if len(kk) else []
    pa = np.asarray(result.pa_rows.take(result.rows[j][:len(strs)])) \
        if len(strs) else np.empty((0, 0), "<u8")
    afs = _pa_bits_batch(pa, n).mean(axis=1) if pa.size else np.zeros(len(strs))
    with open(path, "w") as f:
        f.write("chr\trs\tps\tn_miss\tallele1\tallele0\taf\tl_mle\tp_lrt\n")
        for i, s in enumerate(strs):
            f.write(f"0\t{s}_{i+1}\t0\t0\t1\t0\t{afs[i]:.6f}\t"
                    f"{10**lam[i]:.6e}\t{pvals[i]:.6e}\n")


def run_distributed_gwas(cfg: GWASConfig):
    """ONE-COMMAND multi-host GWAS (the distributed `kmers_gwas.py`):
    every participating process calls this in lockstep AFTER
    `parallel.multihost.init_distributed()`. Composition, matching the
    reference orchestrator stage for stage (/root/reference/kmers_gwas.py:50-274):

      1-2. phenotype load/averaging + accession intersection (all processes,
           deterministic host work)
      2b.  kinship: precomputed if available, else the DISTRIBUTED kinship
           (each process accumulates its k-mer span; process 0 persists it)
      3.   REML + covariance-preserving permutations + GRAMMAR transform on
           process 0, broadcast to all (bitwise-identical scan inputs
           everywhere — CPUs may differ across hosts, so nothing numeric is
           recomputed per host)
      4.   DISTRIBUTED association scan (full feature set: dtable caches,
           pattern counter, first_phenotype_top, score precision)
      5-6. exact LMM + permutation thresholds + pass/summary artifacts on
           process 0 via the SAME `_post_scan_stages` as single-process
           `run_gwas` — identical candidates produce identical artifacts.

    Returns the GWASResult on process 0, None on the others (they return
    right after the scan's finalize collective; no further collectives run).

    `cfg.checkpoint_base` makes both long stages resumable per process
    (`<base>.kin.p<pid>` / `<base>.scan.p<pid>`), fingerprint-guarded
    against topology changes.

    SNP-arm options are single-process only (run them with `run_gwas`)."""
    import time as _time
    import contextlib

    import jax
    from jax.experimental import multihost_utils

    from ..parallel import multihost
    from .scan import ScanResult, fetch_rows
    from ..core.table import KmersTableReader

    if cfg.run_snps or cfg.kinship_snps or not cfg.run_kmers:
        raise ValueError("the SNP arm is single-process only; use run_gwas")

    n_proc = jax.process_count()
    pid = jax.process_index()
    out = Path(cfg.outdir)
    out.mkdir(parents=True, exist_ok=True)
    log_lines = []
    stage_seconds = {}

    def log(msg):
        log_lines.append(str(msg))

    @contextlib.contextmanager
    def stage(name):
        t0 = _time.perf_counter()
        yield
        dt = _time.perf_counter() - t0
        stage_seconds[name] = stage_seconds.get(name, 0.0) + dt
        log(f"[stage] {name}: {dt:.2f}s")

    # 1. phenotype: load + average duplicate accessions (deterministic)
    pheno = formats.read_phenotypes(cfg.pheno_path)
    accs, vals = average_phenotypes(pheno.accessions, pheno.values[:, 0])
    table_names = formats.read_names(cfg.kmers_table)

    # 2. kinship: precomputed > cached beside the table > distributed
    if cfg.kinship_path:
        K_full = kinship_mod.read_kinship(cfg.kinship_path)
    elif os.path.exists(cfg.kmers_table + ".kinship"):
        K_full = kinship_mod.read_kinship(cfg.kmers_table + ".kinship")
    else:
        log("computing kinship from k-mers table (distributed)")
        with stage("kinship"):
            K_full = multihost.run_distributed_kinship(
                cfg.kmers_table, maf=cfg.kinship_maf,
                dtable_cache=cfg.dtable_cache,
                checkpoint_path=(cfg.checkpoint_base + ".kin"
                                 if cfg.checkpoint_base else None),
                checkpoint_every=cfg.checkpoint_every)
        if pid == 0:
            _persist_kinship(cfg, out, K_full, log)
    kin_names = table_names

    used, y, K = intersect_accessions(accs, vals, kin_names, K_full,
                                      table_names)
    n = len(used)
    if n < cfg.min_data_points:
        if pid == 0:
            (out / "NOT_ENOUGH_DATA").touch()
        raise ValueError(
            f"only {n} phenotyped accessions (< {cfg.min_data_points})")
    if pid == 0:
        np.savetxt(out / "pheno.kinship", K, delimiter="\t")
        formats.write_phenotypes(
            out / "pheno.phenotypes", formats.PhenotypeTable(
                names=["phenotype_value"], accessions=used, values=y[:, None]))

    # 3. transform + permutations on process 0, broadcast: hosts with
    # different CPUs/BLAS must still feed bitwise-identical columns to the
    # scan, so the numeric stage runs exactly once
    with stage("transform"):
        if pid == 0:
            with _stats_device():
                tr0 = transform_mod.transform_and_permute(
                    y, K, cfg.n_permutations, seed=cfg.seed)
            payload = (tr0.phenotypes, tr0.transformed,
                       np.array([tr0.vg, tr0.ve, tr0.heritability]))
        else:
            z = np.zeros((n, 1 + cfg.n_permutations))
            payload = (z, z.copy(), np.zeros(3))
        if n_proc > 1:
            # bit-cast f64 -> uint32 for the broadcast: without jax_enable_x64
            # the device round-trip would silently truncate to f32, and the
            # scan inputs/artifacts must be bitwise process-0 values
            u32 = tuple(np.ascontiguousarray(a).view(np.uint32)
                        for a in payload)
            wire = multihost_utils.broadcast_one_to_all(u32)
            payload = tuple(np.ascontiguousarray(np.asarray(o)).view(
                np.float64) for o in wire)
        phen, transf, vvh = (np.asarray(a) for a in payload)
        names = ["phenotype_value"] + [f"P{i}"
                                       for i in range(1, cfg.n_permutations + 1)]
        tr = transform_mod.TransformResult(
            vg=float(vvh[0]), ve=float(vvh[1]), heritability=float(vvh[2]),
            names=names, phenotypes=phen, transformed=transf)
    log(f"EMMA vg={tr.vg} ve={tr.ve} herit={tr.heritability}")
    if pid == 0:
        formats.write_phenotypes(out / "pheno.phenotypes_and_permutations",
                                 formats.PhenotypeTable(tr.names, used,
                                                        tr.phenotypes))
        formats.write_phenotypes(
            out / "pheno.phenotypes_permuted_transformed",
            formats.PhenotypeTable(tr.names, used, tr.transformed))

    # 4. distributed association scan
    kmers_dir = out / "kmers"
    kmers_dir.mkdir(exist_ok=True)
    with stage("scan"):
        per_pheno, n_tested, n_patterns = multihost.run_distributed_scan(
            cfg.kmers_table, used, tr.transformed, tr.names,
            kmer_len=cfg.kmer_len, n_top=cfg.n_kmers, maf=cfg.maf,
            mac=cfg.mac, batch_size=cfg.batch_size,
            first_phenotype_top=cfg.n_extra_phenotype_kmers,
            count_patterns=cfg.pattern_counter,
            dtable_cache=cfg.dtable_cache,
            score_precision=cfg.score_precision,
            checkpoint_path=(cfg.checkpoint_base + ".scan"
                             if cfg.checkpoint_base else None),
            checkpoint_every=cfg.checkpoint_every)
    if pid != 0:
        return None     # candidates are replicated; one writer is enough

    # 5-6. winners + exact LMM + thresholds on process 0 — identical code
    # path to single-process run_gwas
    reader = KmersTableReader(cfg.kmers_table, names_to_use=used)
    all_rows = (np.unique(np.concatenate([rw for _, rw in per_pheno]))
                if any(len(rw) for _, rw in per_pheno)
                else np.empty(0, np.int64))
    kmer_of_row, pa_of_row = fetch_rows(reader, all_rows.astype(np.int64))
    result = ScanResult(
        names=list(tr.names),
        scores=[np.asarray(sc, np.float64) for sc, _ in per_pheno],
        rows=[np.asarray(rw, np.int64) for _, rw in per_pheno],
        kmers=[np.asarray(kmer_of_row.take(rw), np.uint64)
               for _, rw in per_pheno],
        n_tested=n_tested, n_patterns=n_patterns, pa_rows=pa_of_row)
    res = _post_scan_stages(cfg, out, kmers_dir, result, tr, used, K, n,
                            log, log_lines, stage_seconds)
    # provenance: record the distributed topology in the summary
    summary_path = out / "summary.json"
    summary = json.loads(summary_path.read_text())
    summary["n_processes"] = n_proc
    summary_path.write_text(json.dumps(summary, indent=2))
    return res
