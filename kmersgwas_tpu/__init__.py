"""kmersgwas_tpu: k-mer GWAS engine in JAX (GPU scan kernels).

A from-scratch JAX/XLA/Pallas framework with the capabilities of
voichek/kmersGWAS (reference-genome-free k-mer association studies):
host-side ingest (k-mer counting, strand merging, table construction),
device-side packed bit-plane association scans, EMMA kinship, REML variance
components, covariance-preserving permutations, and an exact mixed-model
likelihood-ratio test — no external KMC/R/GEMMA dependencies.
"""
__version__ = "0.1.0"

__all__ = ["run_gwas", "GWASConfig"]


def __getattr__(name):
    # lazy top-level API (avoids importing jax at package import time)
    if name == "run_gwas":
        from .pipeline.gwas import run_gwas
        return run_gwas
    if name == "GWASConfig":
        from .pipeline.gwas import GWASConfig
        return GWASConfig
    raise AttributeError(name)
