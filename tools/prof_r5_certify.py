"""Default-precision top-k selection vs the f32-faithful oracle, the
default scores' relative error, and the certify_topk certificate, at a
realistic shape.

It measures (a) the boundary swap rate between the default-precision
(bf16 phenotype operand) score GEMM's top-10001 selection and a
score_precision="highest" oracle, and (b) a cheap exactness option —
both at a realistic shape, several seeds.

Method: the 8M-row synthetic population (the streaming-bench table,
N=1008) scanned end-to-end through pipeline.scan.associate three ways per
seed — default, highest (oracle), default+certify_topk — with top-10001
over P=101 transformed-like normal columns. Per column we report
  swaps    = |oracle_set \\ default_set| (rows selected by the oracle that
             default precision missed; symmetric by construction)
  certified, and whether the certified set equals the oracle set.

Run: python tools/prof_r5_certify.py [n_seeds [n_rows]]  (on the GPU;
builds or reuses the bench's synthetic population under .work/ in the
checkout).
"""
import sys
import time

import numpy as np

from kmersgwas_tpu.pipeline import scan as scan_mod


def main(n_seeds: int = 2, n_rows: int = 8_000_000,
         workdir: str = ".work/stream_bench"):
    sys.path.insert(0, ".")
    from bench import _synthetic_pop
    base, dtable, names, n, kmer_len = _synthetic_pop(n_rows, workdir)
    k = 10001

    for seed in range(1, n_seeds + 1):
        rng = np.random.default_rng(seed)
        y = rng.normal(size=(n, 101))
        kw = dict(kmer_len=kmer_len, n_top=k, maf=0.05, mac=5,
                  batch_size=2_000_000, dtable_cache=dtable)
        t0 = time.perf_counter()
        res_d = scan_mod.associate(base, names, y,
                                   [f"c{j}" for j in range(101)], **kw)
        t_d = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_h = scan_mod.associate(base, names, y,
                                   [f"c{j}" for j in range(101)],
                                   score_precision="highest", **kw)
        t_h = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_c = scan_mod.associate(base, names, y,
                                   [f"c{j}" for j in range(101)],
                                   certify_topk=True, **kw)
        t_c = time.perf_counter() - t0

        swaps_d, swaps_c, rel, ratio = [], [], 0.0, 0.0
        for j in range(101):
            oracle = set(res_h.rows[j].tolist())
            swaps_d.append(len(oracle - set(res_d.rows[j].tolist())))
            swaps_c.append(len(oracle - set(res_c.rows[j].tolist())))
            # default-precision score error against the f32-faithful
            # score of the same row
            hi = dict(zip(res_h.rows[j].tolist(), res_h.scores[j]))
            both = [(s_, hi[r_]) for r_, s_ in
                    zip(res_d.rows[j].tolist(), res_d.scores[j]) if r_ in hi]
            if both:
                a, b = np.asarray(both, np.float64).T
                err = float(np.max(np.abs(a - b) / b))
                eps = scan_mod.certify_eps(y[:, j], n,
                                           float(res_d.scores[j][-1]))
                rel, ratio = max(rel, err), max(ratio, err / eps)
        swaps_d, swaps_c = np.array(swaps_d), np.array(swaps_c)
        n_cert = sum(res_c.certified)
        print(f"seed {seed}: max relative score error, default vs highest "
              f"on the rows both selected: {rel:.3e}; largest ratio to the "
              f"column's certify_eps {ratio:.3f} (must stay < 1)",
              flush=True)
        print(f"seed {seed}: DEFAULT vs oracle: total swaps "
              f"{swaps_d.sum()} / {101 * k} selections "
              f"({swaps_d.sum() / (101 * k):.2e}), max/column "
              f"{swaps_d.max()}, columns with any swap "
              f"{(swaps_d > 0).sum()}/101", flush=True)
        print(f"seed {seed}: CERTIFIED vs oracle: total swaps "
              f"{swaps_c.sum()}, certified {n_cert}/101; wall "
              f"default {t_d:.0f}s / highest {t_h:.0f}s / "
              f"certify {t_c:.0f}s", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
