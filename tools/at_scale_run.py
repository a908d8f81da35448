"""At-scale end-to-end GWAS run: synthetic 1008-accession table, >=100M rows.

Converts BENCHMARKS.md's per-stage claims into a measured artifact
(VERDICT r2 item 2): generates a reference-format `.table` at the 1001G
panel width, plants causal k-mers, then runs the PRODUCT pipeline
(pipeline.gwas.run_gwas): kinship -> REML transform + 100 permutations ->
association scan (dtable cache) -> exact LMM on candidates -> permutation
thresholds. Prints per-stage wall-clock and writes at_scale_result.json.

Usage:  python tools/at_scale_run.py [--rows 100000000] [--workdir DIR]

Evidence standard mirrored from the reference's runnable examples
(/root/reference/examples/flowering_time_arabidopsis/run_example.sh).
"""
import argparse
import json
import os
import sys
import time

import numpy as np


def gen_table(base: str, n_rows: int, n: int, kmer_len: int, seed: int = 0,
              n_causal: int = 8):
    """Reference-format .table + .names + planted causal carrier patterns.
    Returns (causal_kmer_codes, carrier_masks (n_causal, n))."""
    from kmersgwas_tpu.core import formats
    names = [f"acc{i}" for i in range(n)]
    wf = (n + 63) // 64
    used_last = n - (wf - 1) * 64
    last_mask = np.uint64((1 << used_last) - 1) if used_last < 64 else np.uint64(~np.uint64(0))
    rng = np.random.default_rng(seed)

    causal_rows = np.linspace(n_rows // 10, n_rows - n_rows // 10, n_causal,
                              dtype=np.int64)
    carriers = rng.random((n_causal, n)) < 0.35
    carrier_words = np.zeros((n_causal, wf * 64), np.uint8)
    carrier_words[:, :n] = carriers
    carrier_pa = np.packbits(carrier_words, axis=1, bitorder="little"
                             ).view("<u8")
    causal_kmers = (causal_rows.astype(np.uint64) * np.uint64(97))

    t0 = time.perf_counter()
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, kmer_len)
        chunk = 1 << 20
        for s in range(0, n_rows, chunk):
            m = min(chunk, n_rows - s)
            rows = np.empty((m, 1 + wf), dtype="<u8")
            rows[:, 0] = np.arange(s, s + m, dtype=np.uint64) * np.uint64(97)
            rows[:, 1:] = rng.integers(0, 1 << 63, size=(m, wf),
                                       dtype=np.uint64)
            rows[:, wf] &= last_mask
            sel = (causal_rows >= s) & (causal_rows < s + m)
            for ci in np.flatnonzero(sel):
                rows[causal_rows[ci] - s, 1:] = carrier_pa[ci]
            rows.tofile(f)
    formats.write_names(base, names)
    print(f"[gen] {n_rows:,} rows x {n} accessions in "
          f"{time.perf_counter()-t0:.1f}s "
          f"({os.path.getsize(base + '.table')/1e9:.1f} GB)", flush=True)
    return causal_kmers, carriers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--n", type=int, default=1008)
    ap.add_argument("--workdir", default=".work/at_scale")
    ap.add_argument("--permutations", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=2_000_000)
    ap.add_argument("--no_dtable", action="store_true",
                    help="skip the .dtable cache and stream the raw .table "
                         "(native threaded squeeze) — required when disk "
                         "cannot hold table + cache (e.g. the 400M-row / "
                         "54 GB configuration on this 69 GB-free host)")
    a = ap.parse_args()

    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.pipeline.gwas import GWASConfig, run_gwas

    os.makedirs(a.workdir, exist_ok=True)
    base = os.path.join(a.workdir, f"pop{a.rows}")
    kmer_len = 31
    rng = np.random.default_rng(42)

    if not os.path.exists(base + ".table"):
        causal_kmers, carriers = gen_table(base, a.rows, a.n, kmer_len)
        np.savez(base + "_truth.npz", causal_kmers=causal_kmers,
                 carriers=carriers)
    else:
        tr = np.load(base + "_truth.npz")
        causal_kmers, carriers = tr["causal_kmers"], tr["carriers"]
        print(f"[gen] reusing {base}.table", flush=True)

    # phenotype: causal carrier effects + noise
    g = carriers.astype(np.float64)
    beta = 0.6
    y = (beta * ((g - g.mean(axis=1, keepdims=True))
                 / g.std(axis=1, keepdims=True)).sum(axis=0)
         + rng.normal(size=a.n))
    names = [f"acc{i}" for i in range(a.n)]
    pheno_path = os.path.join(a.workdir, "pheno.pheno")
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=names, values=y[:, None]))

    # time the dtable build separately from the scan that consumes it
    stage_seconds = {}
    dtable = None
    if not a.no_dtable:
        dtable = base + ".dtable"
        if not os.path.exists(dtable):
            from kmersgwas_tpu.core import dtable as dt_mod
            import math
            t0 = time.perf_counter()
            dt_mod.build_dtable(base, dtable, names_to_use=names,
                                min_count=max(5, math.ceil(a.n * 0.05)))
            stage_seconds["dtable_build"] = time.perf_counter() - t0
            print(f"[dtable] built in {stage_seconds['dtable_build']:.1f}s",
                  flush=True)

    outdir = os.path.join(a.workdir, "gwas_out")
    t_all = time.perf_counter()
    res = run_gwas(GWASConfig(
        pheno_path=pheno_path, kmers_table=base, outdir=outdir,
        kmer_len=kmer_len, n_permutations=a.permutations,
        batch_size=a.batch_size, dtable_cache=dtable, seed=1))
    total = time.perf_counter() - t_all
    stage_seconds.update(res.stage_seconds)

    # causal recovery: the planted k-mers must surface among the passing set
    pass_kmers = {s for s, _ in res.pass_5per}
    from kmersgwas_tpu.core import codec
    causal_strs = set(codec.decode_kmers(np.asarray(causal_kmers,
                                                    np.uint64), kmer_len))
    n_recovered = len(pass_kmers & causal_strs)

    out = {
        "rows": a.rows, "n_accessions": a.n, "permutations": a.permutations,
        "stage_seconds": {k: round(v, 2) for k, v in stage_seconds.items()},
        "pipeline_total_seconds": round(total, 2),
        "scan_kmers_per_sec": round(a.rows * 0
                                    + res.n_tested / stage_seconds["scan"], 1)
        if stage_seconds.get("scan") else None,
        "kinship_kmers_per_sec": round(a.rows / stage_seconds["kinship"], 1)
        if stage_seconds.get("kinship") else None,
        "n_tested": res.n_tested,
        "threshold_5per": res.thresholds.get("5per"),
        "heritability": res.heritability,
        "causal_planted": len(causal_strs),
        "causal_recovered_5per": n_recovered,
    }
    path = os.path.join(a.workdir, "at_scale_result.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    print(f"artifact: {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
