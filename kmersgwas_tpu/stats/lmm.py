"""Exact mixed-model association: ML likelihood-ratio test per variant.

In-framework replacement for GEMMA 0.96 `-lmm 2` (invoked by the reference
at kmers_gwas.py:162-165 on the top-k candidate k-mers; the binary itself is
stripped from the checkout). The model per variant x:

    y = W a + x b + u + e,   u ~ N(0, vg K),  e ~ N(0, ve I),  lambda = vg/ve

With K = U D U' eigendecomposed once, rotate everything by U'. For a fixed
lambda the ML profile likelihood (over a, b and the scale tau) is

    l(lambda) = n/2 log(n/(2 pi)) - n/2 - 1/2 sum log(v_i) - n/2 log RSS
    v_i = lambda d_i + 1,  RSS = min_b sum (y_i - X_i b)^2 / v_i

lambda is optimized on a log grid + fixed-iteration golden-section refine
(GEMMA: Brent in [1e-5, 1e5]); the null model (W only) is optimized once.
p_lrt = chi2_sf(2 (l1 - l0), df=1). Everything is vmapped over variants and
runs as one jit on the device — the reference's farm of GEMMA processes
(functions.py:61-66) becomes a single batched kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

LOG_LMIN, LOG_LMAX = -5.0, 5.0   # log10 lambda bounds, as GEMMA's defaults
# plain Python float: a jnp op here would initialize the XLA backend
# at import time, breaking jax.distributed.initialize() in mp drivers
_GOLD = 0.5 * (3.0 - 5.0 ** 0.5)


class LMMResult(NamedTuple):
    log10_lambda: jax.Array   # per-variant ML lambda (log10)
    logl_alt: jax.Array
    beta: jax.Array
    p_lrt: jax.Array


def _profile_ll(log10_lam, d, Xt, yt):
    """ML profile log-likelihood at one lambda; Xt (n, c) rotated covariates
    (last column = the variant), yt (n,) rotated phenotype."""
    n = yt.shape[0]
    lam = jnp.power(10.0, log10_lam)
    v = lam * d + 1.0
    w = 1.0 / v
    Xw = Xt * w[:, None]
    G = Xt.T @ Xw                       # (c, c)
    r = Xw.T @ yt                       # (c,)
    beta = jnp.linalg.solve(G, r)
    rss = jnp.sum(w * yt * yt) - r @ beta
    rss = jnp.maximum(rss, 1e-300)
    ll = 0.5 * (n * (jnp.log(n / (2 * jnp.pi)) - 1.0 - jnp.log(rss))
                - jnp.sum(jnp.log(v)))
    return ll, beta


def _profile_ll2(log10_lam, d, w1t, xt, yt):
    """Closed-form c==2 specialization (intercept w1t + variant xt, both
    rotated): identical math to _profile_ll with Xt = [w1t, xt], but every
    intermediate is a scalar per lambda — no (c, c) matrices. Under a huge
    vmap over (columns, variants, grid) the tiny Gram matrices pad out to
    hardware tiles and blow up the compiled temporaries at production
    candidate counts; this form keeps temps at (batch, grid) width.
    Returns (ll, beta_variant)."""
    n = yt.shape[0]
    lam = jnp.power(10.0, log10_lam)
    v = lam * d + 1.0
    w = 1.0 / v
    a = jnp.sum(w * w1t * w1t)
    b = jnp.sum(w * w1t * xt)
    dd = jnp.sum(w * xt * xt)
    r1 = jnp.sum(w * w1t * yt)
    r2 = jnp.sum(w * xt * yt)
    yy = jnp.sum(w * yt * yt)
    det = a * dd - b * b
    beta1 = (dd * r1 - b * r2) / det
    beta2 = (a * r2 - b * r1) / det
    rss = jnp.maximum(yy - (r1 * beta1 + r2 * beta2), 1e-300)
    ll = 0.5 * (n * (jnp.log(n / (2 * jnp.pi)) - 1.0 - jnp.log(rss))
                - jnp.sum(jnp.log(v)))
    return ll, beta2


def _profile_ll1(log10_lam, d, w1t, yt):
    """Closed-form c==1 (intercept-only null model)."""
    n = yt.shape[0]
    lam = jnp.power(10.0, log10_lam)
    v = lam * d + 1.0
    w = 1.0 / v
    a = jnp.sum(w * w1t * w1t)
    r1 = jnp.sum(w * w1t * yt)
    yy = jnp.sum(w * yt * yt)
    rss = jnp.maximum(yy - r1 * r1 / a, 1e-300)
    return 0.5 * (n * (jnp.log(n / (2 * jnp.pi)) - 1.0 - jnp.log(rss))
                  - jnp.sum(jnp.log(v)))


def _optimize(ll_fn, n_grid: int, n_refine: int):
    """Grid + golden-section maximizer of ll_fn(log10_lam) -> (ll, beta)."""
    grid = jnp.linspace(LOG_LMIN, LOG_LMAX, n_grid)
    lls = jax.vmap(lambda g: ll_fn(g)[0])(grid)
    i = jnp.argmax(lls)
    lo = grid[jnp.maximum(i - 1, 0)]
    hi = grid[jnp.minimum(i + 1, n_grid - 1)]

    def body(_, carry):
        lo, hi = carry
        m1 = lo + _GOLD * (hi - lo)
        m2 = hi - _GOLD * (hi - lo)
        f1 = ll_fn(m1)[0]
        f2 = ll_fn(m2)[0]
        return (jnp.where(f1 < f2, m1, lo), jnp.where(f1 < f2, hi, m2))

    lo, hi = jax.lax.fori_loop(0, n_refine, body, (lo, hi))
    best = 0.5 * (lo + hi)
    ll, beta = ll_fn(best)
    return best, ll, beta


def _optimize_lambda(d, Xt, yt, n_grid: int, n_refine: int):
    return _optimize(lambda g: _profile_ll(g, d, Xt, yt), n_grid, n_refine)


def chi2_sf_df1(x):
    """Survival function of chi-squared with 1 df: erfc(sqrt(x/2))."""
    return jax.scipy.special.erfc(jnp.sqrt(jnp.maximum(x, 0.0) / 2.0))


@functools.partial(jax.jit, static_argnames=("n_grid", "n_refine"))
def lmm_scan(genotypes, y, K_eigvals, K_eigvecs, covariates=None,
             n_grid: int = 64, n_refine: int = 40) -> LMMResult:
    """Exact ML-LRT over variants.

    genotypes: (M, n) per-variant genotype rows (0/1 presence for k-mers).
    y: (n,) phenotype. K_eigvals (n,), K_eigvecs (n, n) from eigh(K).
    covariates: (n, c) fixed effects, defaults to the intercept.
    """
    y = jnp.asarray(y)
    n = y.shape[0]
    U = K_eigvecs
    d = K_eigvals
    yt = U.T @ y

    if covariates is None:
        # intercept-only: closed-form c==1/c==2 scalar path (no (c, c)
        # Gram matrices — see _profile_ll2 for why this matters)
        w1t = jnp.sum(U, axis=0)                          # U' 1
        _, ll_null, _ = _optimize(
            lambda g: (_profile_ll1(g, d, w1t, yt), jnp.float32(0)),
            n_grid, n_refine)

        def per_variant(x):
            xt = U.T @ x
            log10_lam, ll, beta = _optimize(
                lambda g: _profile_ll2(g, d, w1t, xt, yt), n_grid, n_refine)
            lrt = 2.0 * (ll - ll_null)
            return log10_lam, ll, beta, chi2_sf_df1(lrt)

        log10_lam, ll_alt, beta, p = jax.vmap(per_variant)(
            jnp.asarray(genotypes, y.dtype))
        return LMMResult(log10_lambda=log10_lam, logl_alt=ll_alt, beta=beta,
                         p_lrt=p)

    W = jnp.asarray(covariates, y.dtype)
    Wt = U.T @ W

    # Null model, once
    _, ll_null, _ = _optimize_lambda(d, Wt, yt, n_grid, n_refine)

    def per_variant(x):
        xt = U.T @ x
        Xt = jnp.concatenate([Wt, xt[:, None]], axis=1)
        log10_lam, ll, beta = _optimize_lambda(d, Xt, yt, n_grid, n_refine)
        lrt = 2.0 * (ll - ll_null)
        return log10_lam, ll, beta[-1], chi2_sf_df1(lrt)

    log10_lam, ll_alt, beta, p = jax.vmap(per_variant)(jnp.asarray(genotypes, y.dtype))
    return LMMResult(log10_lambda=log10_lam, logl_alt=ll_alt, beta=beta, p_lrt=p)


@functools.partial(jax.jit, static_argnames=("n_grid", "n_refine"))
def lmm_scan_columns(genotypes, ys, K_eigvals, K_eigvecs,
                     n_grid: int = 64, n_refine: int = 40) -> LMMResult:
    """ML-LRT over variants for SEVERAL phenotype columns in one dispatch.

    genotypes (P, M, n) per-column candidate variants, ys (P, n) phenotype
    columns. The reference farms one GEMMA process per column
    (functions.py:61-66, ~101 of them); here the column axis is one more
    vmap dimension over the same rotated-profile optimizer. Returns
    LMMResult with (P, M)-shaped fields."""
    return jax.vmap(
        lambda g, y: lmm_scan.__wrapped__(g, y, K_eigvals, K_eigvecs, None,
                                          n_grid, n_refine)
    )(jnp.asarray(genotypes), jnp.asarray(ys))


# XLA's GPU autotuner times candidate GEMM algorithms at compile time and
# keeps the fastest, so two compilations of the same program can round
# differently: p-values then differ in their last bits between a run that
# compiled afresh and one that loaded the cache (or another process).
# Deterministic ops turn the autotuner off; every compilation of the device
# LMM then gives the same bits.
@functools.partial(jax.jit, static_argnames=("n", "n_grid", "n_refine"),
                   compiler_options={"xla_gpu_deterministic_ops": True})
def lmm_scan_columns_packed(packed_genos, ys, K_eigvals, K_eigvecs, *,
                            n: int, n_grid: int = 64,
                            n_refine: int = 40) -> LMMResult:
    """lmm_scan_columns fed PACKED presence bits, unpacked on-device.

    packed_genos (P, M, W32) uint32 bit-planes (LSB-first lanes, >= n bits),
    ys (P, n). This is the accelerator path of the GEMMA-farm replacement: the
    host ships ~n/8 bytes per genotype instead of 8-byte floats (the f64
    stack for 101 x 10001 x 1008 is ~800 MB/dispatch; the packed planes are
    ~13 MB), and the ~10^12 flops of profile-likelihood optimization run on
    the accelerator instead of the host. Accumulation is f32 on device:
    the likelihood-ratio statistic agrees with the f64 host route to a few
    1e-2 (f32 rounding of log-likelihoods ~1e3), so -log10 p agrees to
    ~1e-2 where p < 1e-3, inside the permutation-threshold resolution;
    chip_smoke.phase_lmm derives the bounds.
    """
    from ..ops.bitplanes import unpack_bits
    w = jnp.asarray(K_eigvals, jnp.float32)
    U = jnp.asarray(K_eigvecs, jnp.float32)

    def per_col(pg, y):
        g = unpack_bits(pg, jnp.float32)[:, :n]          # (M, n)
        return lmm_scan.__wrapped__(g, y, w, U, None, n_grid, n_refine)

    return jax.vmap(per_col)(jnp.asarray(packed_genos),
                             jnp.asarray(ys, jnp.float32))


def grammar_gamma_score(genotypes, y_transformed, n_used, min_count):
    """GRAMMAR-Gamma approximate score used by the fast scan — see ops/score.py
    for the production packed-bit kernel; this dense version exists for tests."""
    g = jnp.asarray(genotypes, jnp.float32)
    y = jnp.asarray(y_transformed, jnp.float32)
    n1 = jnp.sum(g, axis=1)
    yigi = g @ y
    ysum = jnp.sum(y)
    r = n_used * yigi - n1 * ysum
    denom = n_used * n1 - n1 * n1
    ok = (n1 >= min_count) & ((n_used - n1) >= min_count) & (denom > 0)
    return jnp.where(ok, r * r / denom, 0.0)
