"""GRAMMAR-Gamma approximate SNP association (associate_snps equivalent).

Reference score (src/snps_multiple_databases.cpp:157-172), handling
heterozygous (+1/2 dose) and missing genotypes:

  yigi  = sum y_i g_i          (g = presence + het/2)
  ysum  = sum over OBSERVED samples of y_i
  score = (N*yigi - S_gi*ysum)^2 / (N*(N*S_gi2 - S_gi^2)),  N = #observed
  score = 0 when S_gi < mac or (N - S_gi) < mac

The three bit-planes become three rows of one batched GEMM; the
per-phenotype loop (associate_snps.cpp:55-60) is the GEMM's P axis. The top-N
selection returns ROW-SORTED indices like get_rows_sorted_indices
(best_associations_heap.cpp:135-147), and selected SNPs are re-exported by
streaming the original bed/bim (snps_multiple_databases.cpp:246-286).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core import formats
from ..ops.bitplanes import unpack_bits
from .bed import SNPPlanes, load_bed_planes


@functools.partial(jax.jit, static_argnames=("min_count",))
def snp_scores(presence, het, nonmiss, s_gi, s_gi2, total, y_padded, *,
               min_count: float):
    """(M, W32) planes + (N_pad, P) phenotypes -> (M, P) scores."""
    g = unpack_bits(presence, jnp.float32) + 0.5 * unpack_bits(het, jnp.float32)
    m = unpack_bits(nonmiss, jnp.float32)
    yigi = jnp.dot(g, y_padded, preferred_element_type=jnp.float32)
    ysum = jnp.dot(m, y_padded, preferred_element_type=jnp.float32)
    n = total[:, None]
    sg = s_gi[:, None]
    sg2 = s_gi2[:, None]
    r = n * yigi - sg * ysum
    denom = n * (n * sg2 - sg * sg)
    score = jnp.where(denom > 0, r * r / denom, 0.0)
    ok = (sg >= min_count) & ((n - sg) >= min_count)
    return jnp.where(ok, score, 0.0)


def most_associated_snps(planes: SNPPlanes, phenotypes: np.ndarray,
                         n_best: int, maf: float, mac: float):
    """-> list per phenotype of row-sorted SNP indices (top-n_best scores)."""
    n = planes.n_samples
    min_count = max(float(mac), math.ceil(maf * n))
    y = np.zeros((planes.n_pad, phenotypes.shape[1]), np.float32)
    y[:n] = phenotypes
    scores = np.asarray(snp_scores(
        jnp.asarray(planes.presence), jnp.asarray(planes.het),
        jnp.asarray(planes.nonmiss), jnp.asarray(planes.s_gi),
        jnp.asarray(planes.s_gi2), jnp.asarray(planes.total),
        jnp.asarray(y), min_count=min_count))
    out = []
    for j in range(scores.shape[1]):
        k = min(n_best, scores.shape[0])
        idx = np.argsort(-scores[:, j], kind="stable")[:k]
        out.append(np.sort(idx))
    return out, scores


def export_selected_snps(base_name: str, out_bases, snp_indices) -> None:
    """Copy selected rows of the original bed/bim into per-phenotype files,
    preserving the source's genotype bytes and bim lines."""
    fam_names = formats.read_fam_names(base_name + ".fam")
    bpr = (len(fam_names) + 3) // 4
    with open(base_name + ".bed", "rb") as f:
        if f.read(3) != formats.PLINK_BED_MAGIC:
            raise ValueError("bad bed magic")
        body = np.fromfile(f, dtype=np.uint8).reshape(-1, bpr)
    bim_lines = open(base_name + ".bim").read().splitlines()
    for out_base, idx in zip(out_bases, snp_indices):
        with open(out_base + ".bed", "wb") as f:
            f.write(formats.PLINK_BED_MAGIC)
            body[idx].tofile(f)
        with open(out_base + ".bim", "w") as f:
            for i in idx:
                f.write(bim_lines[int(i)] + "\n")


def associate_snps(base_bedbim: str, pheno_accessions, pheno_values,
                   pheno_names, out_base: str, n_best: int,
                   maf: float, mac: float):
    """Full associate_snps flow: load planes, score all phenotype columns,
    export per-phenotype top-N bed/bim. Returns the per-column indices."""
    planes = load_bed_planes(base_bedbim, pheno_accessions)
    idx, _ = most_associated_snps(planes, np.asarray(pheno_values, np.float32),
                                  n_best, maf, mac)
    out_bases = [f"{out_base}.{n}" for n in pheno_names]
    export_selected_snps(base_bedbim, out_bases, idx)
    return idx
