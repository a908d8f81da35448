"""Tests that need the card: the compact scan step with the Triton kernel
against the plain XLA reference, kinship bit-exact against the integer
XNOR count, and the f32 device LMM against the f64 host LMM. They skip on
the CPU (the `gpu` fixture); run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmersgwas_tpu.ops import bitplanes, kinship, score, scanstep, topk

pytestmark = pytest.mark.gpu


def _random_batch(rng, rows, n, n_pad):
    bits = (rng.random((rows, n)) < 0.3).astype(np.uint8)
    padded = np.zeros((rows, n_pad), np.uint8)
    padded[:, :n] = bits
    return bitplanes.pack_bits_np(padded), bits.sum(axis=1).astype(np.float32)


def test_scan_step_triton_matches_plain(gpu):
    """Several batches through the production compact step (Triton kernel,
    default precision) select the plain XLA step's top-k at HIGHEST fed
    the same bf16-rounded phenotypes and their sums: same scores to rtol
    1e-5, rows equal except for swaps of scores tied within that tolerance
    at the boundary."""
    rng = np.random.default_rng(0)
    n, n_pad, p, k, rows = 1008, 1024, 101, 1001, 1 << 16
    y = rng.normal(size=(n, p))
    yp, ysum = score.prepare_phenotypes(y, n_pad)
    yp_bf16 = yp.astype(jnp.bfloat16).astype(jnp.float32)
    cp = scanstep.compact_params(rows, k)
    st_c = scanstep.init_buffered_state(p, k, buf_cap=cp.buf_cap)
    st_p = topk.init_state(p, k)
    for b in range(4):
        packed, pc = _random_batch(rng, rows, n, n_pad)
        lo, hi = topk.encode_rows(np.arange(b * rows, (b + 1) * rows))
        args = (jnp.asarray(packed), jnp.asarray(pc), jnp.asarray(lo),
                jnp.asarray(hi), yp, ysum)
        st_c = scanstep.scan_step_compact(
            st_c, *args, n_used=n, min_count=51, kernel="triton",
            cand_c=cp.cand_c, cand_k=cp.cand_k, tile_rows=cp.tile_rows,
            cand_q=cp.cand_q, cand_c2=cp.cand_c2)
        with jax.default_matmul_precision("highest"):
            st_p = scanstep.scan_step(st_p, *args[:4], yp_bf16,
                                      jnp.sum(yp_bf16, axis=0),
                                      n_used=n, min_count=51)
    got = scanstep.flush_buffered(st_c)
    np.testing.assert_allclose(np.asarray(got.scores),
                               np.asarray(st_p.scores), rtol=1e-5)
    rows_g = topk.decode_rows(np.asarray(got.row_lo), np.asarray(got.row_hi))
    rows_p = topk.decode_rows(np.asarray(st_p.row_lo),
                              np.asarray(st_p.row_hi))
    kth = np.asarray(st_p.scores)[:, -1]
    for j in range(p):
        swapped = set(rows_g[j]) ^ set(rows_p[j])
        sc_of = dict(zip(rows_g[j], np.asarray(got.scores)[j]))
        sc_of.update(zip(rows_p[j], np.asarray(st_p.scores)[j]))
        for r_ in swapped:
            assert abs(sc_of[r_] - kth[j]) <= 1e-5 * kth[j], (j, r_)


def test_kinship_bit_exact(gpu):
    """The int8 GEMM kinship on the card equals the integer XNOR count
    (computed in f64, exact: every sum is an integer below 2^53)."""
    rng = np.random.default_rng(1)
    n, n_pad, rows = 1008, 1024, 1 << 14
    bits = (rng.random((rows, n)) < 0.3).astype(np.uint8)
    padded = np.zeros((rows, n_pad), np.uint8)
    padded[:, :n] = bits
    acc = kinship.KinshipAccumulator(n_used=n, n_pad=n_pad)
    acc.add(jnp.asarray(bitplanes.pack_bits_np(padded)))
    acc.flush()
    a = 2.0 * bits - 1.0
    np.testing.assert_array_equal(acc.total, (a.T @ a).astype(np.int64))


def test_lmm_device32_matches_host64(gpu):
    """Packed-bit f32 LMM on the card against the f64 host route, on the
    statistic's scale (chip_smoke.phase_lmm derives the bounds from the f32
    arithmetic): |dLRT| <= 5e-2, hence -log10 p within 0.24 * 5e-2 where
    p < 1e-3; p itself within 5e-2."""
    from scipy.special import erfcinv
    from kmersgwas_tpu.pipeline.gwas import _stats_device
    from kmersgwas_tpu.stats import lmm
    rng = np.random.default_rng(2)
    n, m, cols = 1008, 200, 2
    g = rng.normal(size=(n, n // 4))
    K = g @ g.T / g.shape[1]
    w, U = np.linalg.eigh(K)
    bits = (rng.random((cols, m, n)) < 0.3).astype(np.uint8)
    ys = rng.normal(size=(cols, n)) + 0.5 * bits[:, 0, :]
    ys -= ys.mean(axis=1, keepdims=True)
    padded = np.zeros((cols, m, 1024), np.uint8)
    padded[..., :n] = bits
    packed = bitplanes.pack_bits_np(padded)
    got = lmm.lmm_scan_columns_packed(packed, ys, w, U, n=n)
    with _stats_device(), jax.default_matmul_precision("highest"):
        ref = lmm.lmm_scan_columns(bits.astype(np.float64), ys, w, U)
    p_got = np.asarray(got.p_lrt, np.float64)
    p_ref = np.asarray(ref.p_lrt, np.float64)
    lrt_tol = 5e-2
    np.testing.assert_allclose(2 * erfcinv(p_got) ** 2,
                               2 * erfcinv(p_ref) ** 2, atol=lrt_tol, rtol=0)
    np.testing.assert_allclose(p_got, p_ref, atol=5e-2)
    small = p_ref < 1e-3
    np.testing.assert_allclose(np.log10(p_got[small]), np.log10(p_ref[small]),
                               atol=0.24 * lrt_tol, rtol=0)
