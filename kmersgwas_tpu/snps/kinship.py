"""EMMA kinship from a PLINK bed (emma_kinship equivalent).

Reference (src/emma_kinship.cpp:67-152): per SNP, two accumulation passes
into K += g g' + (1-g)(1-g)':

  pass 1: het treated as 0; missing imputed with maf = #hom_alt / #observed
  pass 2: het treated as 1; missing imputed with maf = (#hom_alt + #het)/#observed

then off-diagonals divided by 2 * n_snps_with_any_observed_genotype and the
diagonal fixed at 1. Implemented as chunked float64 GEMMs (this runs once per
dataset and is not on the hot path; exactness over the reference's double
arithmetic is preferred to matrix-unit speed here).
"""
from __future__ import annotations

import numpy as np

from ..core import formats


def emma_kinship_from_bed(base_name: str, chunk: int = 4096) -> np.ndarray:
    names, dubits = formats.read_bed(base_name)
    n = len(names)
    K = np.zeros((n, n), dtype=np.float64)
    n_used = 0
    for start in range(0, dubits.shape[0], chunk):
        d = dubits[start:start + chunk]
        hom = (d == 3).astype(np.float64)
        het = (d == 2).astype(np.float64)
        miss = (d == 1)
        total = (~miss).sum(axis=1).astype(np.float64)
        any_obs = total > 0
        d, hom, het, miss = d[any_obs], hom[any_obs], het[any_obs], miss[any_obs]
        total = total[any_obs]
        n_used += int(any_obs.sum())
        if not len(total):
            continue
        maf1 = hom.sum(axis=1) / total
        g1 = np.where(miss, maf1[:, None], hom)
        maf2 = (hom.sum(axis=1) + het.sum(axis=1)) / total
        g2 = np.where(miss, maf2[:, None], np.where(het > 0, 1.0, hom))
        for g in (g1, g2):
            K += g.T @ g + (1.0 - g).T @ (1.0 - g)
    if n_used == 0:
        raise ValueError("no SNPs with observed genotypes")
    K /= 2.0 * n_used
    np.fill_diagonal(K, 1.0)
    return K
