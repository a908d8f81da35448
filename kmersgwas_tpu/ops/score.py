"""Association score scan: the hot kernel of the framework.

Reference semantics (src/kmers_multiple_databases.cpp:327-363
`calculate_kmer_score`): for phenotype vector y (padded with zeros to the
lane width) and a k-mer's presence bits g over N used samples with
N1 = popcount(g),

    yigi  = sum_i y_i * g_i
    score = (N*yigi - N1*sum(y))^2 / (N*N1 - N1^2)       (0 if N1 or N0 < mac)

The reference computes yigi row-at-a-time with an SSE4.1 masked accumulate;
here the whole batch is one bit-matrix x phenotype-matrix product on the
tensor cores: scores for R k-mers x P phenotype columns = G(R,N) @ Y(N,P)
followed by an elementwise epilogue. The CTPL thread pool over phenotype
columns (associate_kmers.cpp:134-137) collapses into the P axis of the GEMM.

Two implementations:
  * `score_batch` — pure-XLA (unpack + dot); runs anywhere, the reference.
  * `score_tilemax_triton` — the GPU scan kernel (Pallas through Triton):
    packed words are unpacked bit-plane by bit-plane in registers and fed
    to bf16 tensor-core dots, and only per-tile top-3 summaries leave the
    kernel; neither the dense (R, N) genotype matrix nor the (P, R) score
    matrix is ever written to device memory.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .bitplanes import unpack_bits


def prepare_phenotypes(values, n_lanes: int):
    """Phenotype columns (N, P) -> zero-padded (n_lanes, P) f32 + column sums.

    Zero padding reproduces update_scores_and_sum's resize-with-zeros
    (kmers_multiple_databases.cpp:288-295); the SSE lane permutation
    (kmer_general.cpp:155-167 permute_scores) is unnecessary here because the
    GEMM is order-invariant.
    """
    y = jnp.asarray(values, dtype=jnp.float32)
    if y.ndim == 1:
        y = y[:, None]
    n, p = y.shape
    yp = jnp.zeros((n_lanes, p), jnp.float32).at[:n, :].set(y)
    return yp, jnp.sum(y, axis=0)


def _score_epilogue(yigi, popcnt, y_sum, n_used, min_count):
    n = jnp.float32(n_used)
    n1 = popcnt[:, None]
    r = n * yigi - n1 * y_sum[None, :]
    denom = n * n1 - n1 * n1
    score = jnp.where(denom > 0, (r * r) / denom, 0.0)
    ok = (n1 >= min_count) & ((n - n1) >= min_count)
    return jnp.where(ok, score, 0.0)


@functools.partial(jax.jit, static_argnames=("n_used", "min_count"))
def score_batch(packed, popcnt, y_padded, y_sum, *, n_used: int, min_count: int):
    """XLA path: (R, W32) packed bits -> (R, P) scores."""
    g = unpack_bits(packed, jnp.float32)          # (R, N_pad)
    yigi = jnp.dot(g, y_padded, preferred_element_type=jnp.float32)
    return _score_epilogue(yigi, popcnt, y_sum, n_used, min_count)


def tile_top3(score, thresh, axis: int):
    """Per-column top-3 of a tile's scores, reduced over `axis`.

    score holds -inf on padding rows; thresh broadcasts against score.
    Returns (m1, a1, m2, a2, m3, a3, n2, n3, cnt) with `axis` reduced away:
    the three largest values with their lanes along `axis` (first occurrence
    on ties, so every lane is exact), the multiplicities n2/n3 of the
    2nd/3rd values among the lanes left after masking the earlier picks,
    and the count of lanes scoring > thresh. Shared verbatim by the Triton
    kernel and the XLA path, so both satisfy the same exactness conditions
    (see ops/scanstep.py)."""
    idx = jax.lax.broadcasted_iota(jnp.int32, score.shape, axis)
    m1 = jnp.max(score, axis=axis)
    a1 = jax.lax.argmax(score, axis, jnp.int32)
    s2 = jnp.where(idx == jnp.expand_dims(a1, axis), -jnp.inf, score)
    m2 = jnp.max(s2, axis=axis)
    n2 = jnp.sum((s2 == jnp.expand_dims(m2, axis)).astype(jnp.int32),
                 axis=axis)
    a2 = jax.lax.argmax(s2, axis, jnp.int32)
    s3 = jnp.where(idx == jnp.expand_dims(a2, axis), -jnp.inf, s2)
    m3 = jnp.max(s3, axis=axis)
    n3 = jnp.sum((s3 == jnp.expand_dims(m3, axis)).astype(jnp.int32),
                 axis=axis)
    a3 = jax.lax.argmax(s3, axis, jnp.int32)
    cnt = jnp.sum((score > thresh).astype(jnp.int32), axis=axis)
    return m1, a1, m2, a2, m3, a3, n2, n3, cnt


# ---------------------------------------------------------------------------
# Triton scan kernel: unpack + score + tile top-3, one program per
# (row tile, 128-column phenotype chunk)
# ---------------------------------------------------------------------------
#
# Bit-plane-major contraction: word w of a row holds samples 32w..32w+31, so
# for each bit position b the (TR, W) matrix of bit b of every word is a 0/1
# genotype slice over samples {32w + b}, and yigi = sum_b bits_b @ Y_b with
# Y_b[w, p] = y[32w + b, p]. The kernel needs no reshape: 32 small dots
# (K = W words each) accumulate in f32. 0/1 is exact in bf16; the phenotype
# operand is split into `n_split` bf16 terms (1: bf16 rounding, at most
# 2^-8 relative per element; 3: f32-faithful). The epilogue's sum(y) is the
# sum of those same terms, so every score is the f32 score of one phenotype
# vector, the rounded one: with the sum of the unrounded y, r = N*yigi -
# N1*sum(y) would also carry the rounding of the samples a row lacks, which
# for rows present in most samples more than doubles the score error.

_PC = 128                       # phenotype columns per program
_SPLITS = {"default": 1, "highest": 3}


def split_phenotypes(y_padded, n_split: int):
    """(N_pad, P) f32 -> (n_split*32, W, P_pad) bf16 bit-plane-major terms
    whose sum reproduces y (W = N_pad/32 padded to a power of two >= 16,
    P_pad a multiple of _PC; padding is zero)."""
    n_pad, p = y_padded.shape
    w32 = n_pad // 32
    wp = max(16, pl.next_power_of_2(w32))
    p_pad = -(-p // _PC) * _PC
    # yr[b, w, p] = y[32w + b, p]
    yr = jnp.zeros((32, wp, p_pad), jnp.float32).at[:, :w32, :p].set(
        y_padded.reshape(w32, 32, p).transpose(1, 0, 2))
    terms, rest = [], yr
    for _ in range(n_split):
        t = rest.astype(jnp.bfloat16)
        terms.append(t)
        rest = rest - _bf16_as_f32(t)
    return jnp.concatenate(terms, axis=0)


def _bf16_as_f32(t):
    """Exact bf16 -> f32 widening through the bit pattern: XLA may treat a
    plain f32 -> bf16 -> f32 round trip as the identity (excess precision),
    which would zero every term after the first."""
    u = jax.lax.bitcast_convert_type(t, jnp.uint16).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(u << 16, jnp.float32)


def _tile_scores(packed_ref, pop_ref, yr_ref, ysum_ref, n_used, min_count,
                 n_split):
    """One program's (TR, PC) score tile; padding rows (popcnt 0) -inf."""
    w = packed_ref[...]                                   # (TR, W) uint32
    acc = jnp.zeros((w.shape[0], ysum_ref.shape[0]), jnp.float32)
    for b in range(32):
        g = ((w >> b) & 1).astype(jnp.int32).astype(jnp.float32).astype(
            jnp.bfloat16)                                 # samples {32w + b}
        for s in range(n_split):
            acc += pl.dot(g, yr_ref[s * 32 + b])
    n = jnp.float32(n_used)
    n1 = pop_ref[...][:, None]                            # (TR, 1)
    r = n * acc - n1 * ysum_ref[...][None, :]
    denom = n * n1 - n1 * n1
    score = jnp.where(denom > 0, (r * r) / denom, 0.0)
    ok = (n1 >= jnp.float32(min_count)) & ((n - n1) >= jnp.float32(min_count))
    score = jnp.where(ok, score, 0.0)
    return jnp.where(n1 > 0, score, -jnp.inf)


def _tilemax_kernel(packed_ref, pop_ref, yr_ref, ysum_ref, th_ref,
                    *out_refs, n_used: int, min_count: int, n_split: int):
    score = _tile_scores(packed_ref, pop_ref, yr_ref, ysum_ref, n_used,
                         min_count, n_split)
    outs = tile_top3(score, th_ref[...][None, :], axis=0)
    for ref, val in zip(out_refs, outs):
        ref[...] = val


def _scores_kernel(packed_ref, pop_ref, yr_ref, ysum_ref, out_ref, *,
                   n_used: int, min_count: int, n_split: int):
    out_ref[...] = _tile_scores(packed_ref, pop_ref, yr_ref, ysum_ref,
                                n_used, min_count, n_split)


def _triton_call(kernel, packed, popcnt, y_padded, extra, out_spec,
                 out_shapes, *, n_used, min_count, tile_rows, precision,
                 interpret):
    """Shared launch of the two Triton kernels: one program per (row tile,
    128-column chunk); returns the kernel outputs and the column count."""
    rows, w32 = packed.shape
    n_pad, p = y_padded.shape
    assert n_pad == w32 * 32 and rows % tile_rows == 0
    n_split = _SPLITS[precision]
    yr = split_phenotypes(y_padded, n_split)              # (S*32, W, P_pad)
    wp, p_pad = yr.shape[1], yr.shape[2]
    if wp != w32:
        packed = jnp.pad(packed, ((0, 0), (0, wp - w32)))
    ysum = jnp.sum(_bf16_as_f32(yr), axis=(0, 1))      # of the terms
    extra = [jnp.full((p_pad,), jnp.inf, jnp.float32).at[:p].set(e)
             for e in extra]
    n_tiles = rows // tile_rows
    outs = pl.pallas_call(
        functools.partial(kernel, n_used=n_used, min_count=min_count,
                          n_split=n_split),
        grid=(n_tiles, p_pad // _PC),
        in_specs=[
            pl.BlockSpec((tile_rows, wp), lambda t, c: (t, 0)),
            pl.BlockSpec((tile_rows,), lambda t, c: (t,)),
            pl.BlockSpec((n_split * 32, wp, _PC), lambda t, c: (0, 0, c)),
            pl.BlockSpec((_PC,), lambda t, c: (c,)),
        ] + [pl.BlockSpec((_PC,), lambda t, c: (c,))] * len(extra),
        out_specs=out_spec,
        out_shape=out_shapes(n_tiles, p_pad),
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(packed, popcnt, yr, ysum, *extra)
    return outs, p


@functools.partial(jax.jit, static_argnames=("n_used", "min_count",
                                             "tile_rows", "precision",
                                             "interpret"))
def score_tilemax_triton(packed, popcnt, y_padded, thresh, *,
                         n_used: int, min_count: int, tile_rows: int = 64,
                         precision: str = "default",
                         interpret: bool = False):
    """Compact scan kernel: per tile of `tile_rows` k-mers and per column,
    the top-3 (score, lane) pairs, the multiplicities n2/n3 and the count of
    lanes scoring > thresh — the same nine (P, T) planes as the XLA path
    (ops/scanstep._tilemax), T = R / tile_rows.

    packed (R, W32) uint32, popcnt (R,) f32 (0 marks padding rows),
    y_padded (N_pad, P) f32, thresh (P,) f32. R % tile_rows == 0 and
    tile_rows is a power of two >= 16. precision "default" runs one bf16
    phenotype term, "highest" three (f32-faithful); either way the scores
    are those of the phenotype the terms sum to, column sums included.
    interpret=True runs the kernel on the CPU (tests only)."""
    dtypes = [jnp.float32, jnp.int32, jnp.float32, jnp.int32,
              jnp.float32, jnp.int32, jnp.int32, jnp.int32, jnp.int32]
    outs, p = _triton_call(
        _tilemax_kernel, packed, popcnt, y_padded, [thresh],
        [pl.BlockSpec((None, _PC), lambda t, c: (t, c))] * 9,
        lambda nt, pp: [jax.ShapeDtypeStruct((nt, pp), d) for d in dtypes],
        n_used=n_used, min_count=min_count, tile_rows=tile_rows,
        precision=precision, interpret=interpret)
    return tuple(o[:, :p].T for o in outs)


@functools.partial(jax.jit, static_argnames=("n_used", "min_count",
                                             "tile_rows", "precision",
                                             "interpret"))
def score_t_triton(packed, popcnt, y_padded, *, n_used: int,
                   min_count: int, tile_rows: int = 64,
                   precision: str = "default", interpret: bool = False):
    """The full transposed (P, R) score matrix from the scan kernel's own
    arithmetic (padding rows -inf): the GPU step's exact fallback scores
    rows with it, so every score the step keeps is the kernel's, whichever
    branch produced it. Args as score_tilemax_triton."""
    (sc,), p = _triton_call(
        _scores_kernel, packed, popcnt, y_padded, [],
        [pl.BlockSpec((tile_rows, _PC), lambda t, c: (t, c))],
        lambda nt, pp: [jax.ShapeDtypeStruct((nt * tile_rows, pp),
                                             jnp.float32)],
        n_used=n_used, min_count=min_count, tile_rows=tile_rows,
        precision=precision, interpret=interpret)
    return sc[:, :p].T
