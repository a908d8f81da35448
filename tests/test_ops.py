"""Device-op tests (CPU backend): score kernel, streaming top-k, kinship."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmersgwas_tpu.ops import bitplanes, kinship, score, topk


def rand_problem(rng, r=300, n=70, p=5, w_pad=128):
    n_pad = ((n + w_pad - 1) // w_pad) * w_pad
    bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
    padded = np.zeros((r, n_pad), dtype=np.uint8)
    padded[:, :n] = bits
    packed = bitplanes.pack_bits_np(padded)
    y = rng.normal(size=(n, p))
    return bits, packed, y, n_pad


def reference_scores(bits, y, min_count):
    """Direct NumPy transcription of calculate_kmer_score
    (kmers_multiple_databases.cpp:327-363)."""
    n = bits.shape[1]
    n1 = bits.sum(axis=1).astype(np.float64)
    out = np.zeros((bits.shape[0], y.shape[1]))
    for j in range(y.shape[1]):
        yigi = bits @ y[:, j]
        ysum = y[:, j].sum()
        r = n * yigi - n1 * ysum
        denom = n * n1 - n1 * n1
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.where(denom > 0, r * r / denom, 0.0)
        ok = (n1 >= min_count) & ((n - n1) >= min_count)
        out[:, j] = np.where(ok, s, 0.0)
    return out


def test_unpack_roundtrip():
    rng = np.random.default_rng(0)
    bits, packed, _, n_pad = rand_problem(rng)
    up = np.asarray(bitplanes.unpack_bits(jnp.asarray(packed)))
    assert np.array_equal(up[:, : bits.shape[1]], bits)
    assert np.all(up[:, bits.shape[1]:] == 0)
    pm1 = np.asarray(bitplanes.unpack_bits_pm1(jnp.asarray(packed)))
    assert np.array_equal(pm1[:, : bits.shape[1]], bits.astype(np.int8) * 2 - 1)


def test_popcount_rows():
    rng = np.random.default_rng(1)
    bits, packed, _, _ = rand_problem(rng)
    pc = np.asarray(bitplanes.popcount_rows(jnp.asarray(packed)))
    assert np.array_equal(pc, bits.sum(axis=1))


@pytest.mark.parametrize("min_count", [1, 5])
def test_score_batch_matches_reference(min_count):
    rng = np.random.default_rng(2)
    bits, packed, y, n_pad = rand_problem(rng)
    n = bits.shape[1]
    yp, ysum = score.prepare_phenotypes(y, n_pad)
    got = np.asarray(score.score_batch(
        jnp.asarray(packed), jnp.asarray(bits.sum(axis=1), jnp.float32),
        yp, ysum, n_used=n, min_count=min_count))
    expect = reference_scores(bits, y, min_count)
    np.testing.assert_allclose(got, expect, rtol=2e-5, atol=1e-4)


def test_topk_streaming_matches_global_sort():
    rng = np.random.default_rng(4)
    total, p, k = 1000, 3, 50
    scores_all = rng.normal(size=(total, p)).astype(np.float32)
    state = topk.init_state(p, k)
    for start in range(0, total, 128):
        chunk = scores_all[start:start + 128]
        rows = np.arange(start, start + len(chunk), dtype=np.int64)
        lo, hi = topk.encode_rows(rows)
        state = topk.update(state, jnp.asarray(chunk), jnp.asarray(lo), jnp.asarray(hi))
    result = topk.finalize(state)
    for j in range(p):
        got_scores, got_rows = result[j]
        order = np.argsort(-scores_all[:, j], kind="stable")[:k]
        np.testing.assert_allclose(np.sort(got_scores), np.sort(scores_all[order, j]), rtol=1e-6)
        assert set(got_rows.tolist()) == set(order.tolist())


def test_topk_tie_keeps_earliest_row():
    p, k = 1, 2
    state = topk.init_state(p, k)
    sc = np.array([[1.0], [1.0], [1.0], [2.0]], dtype=np.float32)
    lo, hi = topk.encode_rows(np.arange(4))
    state = topk.update(state, jnp.asarray(sc), jnp.asarray(lo), jnp.asarray(hi))
    _, rows = topk.finalize(state)[0]
    # heap semantics: score-2 row plus the EARLIEST of the tied score-1 rows
    assert set(rows.tolist()) == {3, 0}


def test_topk_row_encoding_large():
    rows = np.array([0, 2**31 + 5, 2**33, 123456789012], dtype=np.int64)
    lo, hi = topk.encode_rows(rows)
    assert np.array_equal(topk.decode_rows(lo, hi), rows)


def test_kinship_matches_reference_xnor():
    rng = np.random.default_rng(5)
    r, n = 500, 37
    bits, packed, _, n_pad = rand_problem(rng, r=r, n=n)
    acc = kinship.KinshipAccumulator(n_used=n, n_pad=n_pad)
    for start in range(0, r, 200):
        acc.add(jnp.asarray(packed[start:start + 200]))
    K = acc.finalize()
    # reference: K[i][j] = mean over rows of (1 ^ g_i ^ g_j); diag = 1
    g = bits.astype(np.int64)
    expect = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            expect[i, j] = np.mean(1 ^ g[:, i] ^ g[:, j])
    np.fill_diagonal(expect, 1.0)
    np.testing.assert_allclose(K, expect, atol=1e-12)


def test_blocked_top_k_exactly_matches_flat():
    rng = np.random.default_rng(10)
    for trial in range(8):
        p, r, k = 3, 512, rng.integers(2, 40)
        # heavy ties: quantized scores force boundary-tie handling
        sc = np.round(rng.normal(size=(p, r)) * 3) / 3
        sc = sc.astype(np.float32)
        v1, i1 = jax.lax.top_k(jnp.asarray(sc), int(k))
        v2, i2 = topk.blocked_top_k(jnp.asarray(sc), int(k), block=16)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_blocked_top_k_unaligned_and_small():
    rng = np.random.default_rng(11)
    sc = rng.normal(size=(2, 100)).astype(np.float32)  # 100 % 16 != 0
    v1, i1 = jax.lax.top_k(jnp.asarray(sc), 7)
    v2, i2 = topk.blocked_top_k(jnp.asarray(sc), 7, block=16)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    # k >= r falls back to flat
    v3, i3 = topk.blocked_top_k(jnp.asarray(sc), 200, block=16)
    assert v3.shape == (2, 100)


def _strided_bmax(sc, block, tile_rows):
    p, r = sc.shape
    nb = tile_rows // block
    t = sc.reshape(p, r // tile_rows, block, nb)
    return t.max(axis=2).reshape(p, -1)


def test_strided_top_k_from_bmax_matches_flat():
    rng = np.random.default_rng(12)
    n_exact = 0
    for trial in range(10):
        p, r, k = 3, 512, int(rng.integers(2, 40))
        if trial % 2:   # distinct values: extraction must be exact
            sc = rng.permutation(r * p).reshape(p, r).astype(np.float32)
        else:           # heavy ties: flag must guard correctness
            sc = (np.round(rng.normal(size=(p, r)) * 3) / 3).astype(np.float32)
        for tile_rows in (r, 128):
            bmax = _strided_bmax(sc, 16, tile_rows)
            v1, i1 = jax.lax.top_k(jnp.asarray(sc), k)
            v2, i2, exact = topk.strided_top_k_from_bmax(
                jnp.asarray(sc), jnp.asarray(bmax), k, tile_rows=tile_rows)
            if bool(exact):
                n_exact += 1
                np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
                np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
            if trial % 2:
                assert bool(exact), "distinct values must extract exactly"
    assert n_exact >= 10


def test_scan_step_buffered_matches_plain():
    """Buffered deferred-merge scan must produce exactly the plain path's
    final top-k (values AND rows) across a long tie-heavy stream, exercising
    both the buffer-append and the flush/fallback branches."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(14)
    n, p, k = 40, 3, 16
    n_pad, w32 = 128, 4
    rows_per, n_batches = 256, 24
    min_count = 2
    y = rng.normal(size=(n, p))
    yp, ysum = score.prepare_phenotypes(y, n_pad)

    state_p = topk.init_state(p, k)
    state_b = scanstep.init_buffered_state(p, k, buf_cap=32)
    n_buffered = 0
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(rows_per, n)).astype(np.uint8)
        padded = np.zeros((rows_per, n_pad), dtype=np.uint8)
        padded[:, :n] = bits
        packed = jnp.asarray(bitplanes.pack_bits_np(padded))
        # quantize popcount-driven scores into heavy ties
        pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
        lo, hi = topk.encode_rows(np.arange(b * rows_per, (b + 1) * rows_per))
        lo, hi = jnp.asarray(lo), jnp.asarray(hi)
        state_p = scanstep.scan_step(state_p, packed, pc, lo, hi, yp, ysum,
                                     n_used=n, min_count=min_count,
                                     cand_k=8)
        prev_n = int(state_b.buf_n)
        state_b = scanstep.scan_step_buffered(
            state_b, packed, pc, lo, hi, yp, ysum, n_used=n,
            min_count=min_count, cand_c=8, cand_k=12)
        if int(state_b.buf_n) > prev_n:
            n_buffered += 1
    assert n_buffered >= 5, "buffer path never engaged; test is vacuous"
    final_b = scanstep.flush_buffered(state_b)
    np.testing.assert_array_equal(np.asarray(state_p.scores),
                                  np.asarray(final_b.scores))
    np.testing.assert_array_equal(
        topk.decode_rows(np.asarray(state_p.row_lo), np.asarray(state_p.row_hi)),
        topk.decode_rows(np.asarray(final_b.row_lo), np.asarray(final_b.row_hi)))


def test_scan_step_buffered_multi_matches_sequential():
    """Chained multi-batch step == B sequential buffered steps, bitwise."""
    import functools
    from kmersgwas_tpu.ops import scanstep as ss
    from kmersgwas_tpu.ops import score as score_ops
    rng = np.random.default_rng(12)
    n, p, k, r, B = 40, 3, 24, 256, 4
    n_pad = 128
    w32 = n_pad // 32
    y = rng.normal(size=(n, p)).astype(np.float32)
    yp, ysum = score_ops.prepare_phenotypes(y, n_pad)
    kw = dict(y_padded=yp, y_sum=ysum, n_used=n, min_count=2,
              cand_c=8, cand_k=8)
    packed = np.zeros((B, r, w32), np.uint32)
    popcnt = np.zeros((B, r), np.float32)
    los = np.zeros((B, r), np.int32)
    his = np.zeros((B, r), np.int32)
    for b in range(B):
        bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
        padded = np.zeros((r, n_pad), np.uint8)
        padded[:, :n] = bits
        packed[b] = bitplanes.pack_bits_np(padded)
        popcnt[b] = bits.sum(axis=1)
        lo, hi = topk.encode_rows(np.arange(b * r, (b + 1) * r))
        los[b], his[b] = lo, hi
    s_seq = ss.init_buffered_state(p, k, buf_cap=8 * 4)
    for b in range(B):
        s_seq = ss.scan_step_buffered(s_seq, jnp.asarray(packed[b]),
                                      jnp.asarray(popcnt[b]),
                                      jnp.asarray(los[b]),
                                      jnp.asarray(his[b]), **kw)
    s_multi = ss.scan_step_buffered_multi(
        ss.init_buffered_state(p, k, buf_cap=8 * 4), jnp.asarray(packed),
        jnp.asarray(popcnt), jnp.asarray(los), jnp.asarray(his), **kw)
    for a, b_ in zip(s_seq, s_multi):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_scan_step_compact_matches_plain():
    """Compact tile-max scan must produce exactly the plain path's final
    top-k (values AND rows) across a long tie-heavy stream, exercising the
    append, buffer-full-flush, and hot-batch-fallback branches, at both
    c == n_tiles and c < n_tiles."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(15)
    n, p, k = 40, 3, 16
    n_pad = 128
    rows_per, n_batches = 256, 24
    min_count = 2
    y = rng.normal(size=(n, p))
    yp, ysum = score.prepare_phenotypes(y, n_pad)

    batches = []
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(rows_per, n)).astype(np.uint8)
        padded = np.zeros((rows_per, n_pad), dtype=np.uint8)
        padded[:, :n] = bits
        packed = jnp.asarray(bitplanes.pack_bits_np(padded))
        pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
        lo, hi = topk.encode_rows(np.arange(b * rows_per, (b + 1) * rows_per))
        batches.append((packed, pc, jnp.asarray(lo), jnp.asarray(hi)))

    state_p = topk.init_state(p, k)
    for packed, pc, lo, hi in batches:
        state_p = scanstep.scan_step(state_p, packed, pc, lo, hi, yp, ysum,
                                     n_used=n, min_count=min_count,
                                     cand_k=8)

    for tile_rows in (64, 16):      # c == n_tiles and c < n_tiles
        state_c = scanstep.init_buffered_state(p, k, buf_cap=24)
        n_append = 0
        for packed, pc, lo, hi in batches:
            prev_n = int(state_c.buf_n)
            state_c = scanstep.scan_step_compact(
                state_c, packed, pc, lo, hi, yp, ysum, n_used=n,
                min_count=min_count, kernel="xla", cand_c=4, cand_k=12,
                tile_rows=tile_rows)
            if int(state_c.buf_n) > prev_n:
                n_append += 1
        assert n_append >= 5, "compact append path never engaged"
        assert n_append < n_batches, "fallback path never engaged"
        final_c = scanstep.flush_buffered(state_c)
        np.testing.assert_array_equal(np.asarray(state_p.scores),
                                      np.asarray(final_c.scores))
        np.testing.assert_array_equal(
            topk.decode_rows(np.asarray(state_p.row_lo),
                             np.asarray(state_p.row_hi)),
            topk.decode_rows(np.asarray(final_c.row_lo),
                             np.asarray(final_c.row_hi)))


def test_scan_step_compact_narrow_append_exact():
    """cand_q narrow appends (only the top-q sorted candidates kept when the
    (q+1)-th is provably <= thresh) must leave the final top-k bit-identical
    to the plain path; the narrow branch must actually engage."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(21)
    n, p, k = 40, 3, 16
    n_pad = 128
    rows_per, n_batches = 256, 30
    min_count = 2
    y = rng.normal(size=(n, p))
    yp, ysum = score.prepare_phenotypes(y, n_pad)

    batches = []
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(rows_per, n)).astype(np.uint8)
        padded = np.zeros((rows_per, n_pad), dtype=np.uint8)
        padded[:, :n] = bits
        packed = jnp.asarray(bitplanes.pack_bits_np(padded))
        pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
        lo, hi = topk.encode_rows(np.arange(b * rows_per, (b + 1) * rows_per))
        batches.append((packed, pc, jnp.asarray(lo), jnp.asarray(hi)))

    state_p = topk.init_state(p, k)
    for packed, pc, lo, hi in batches:
        state_p = scanstep.scan_step(state_p, packed, pc, lo, hi, yp, ysum,
                                     n_used=n, min_count=min_count,
                                     cand_k=8)

    state_c = scanstep.init_buffered_state(p, k, buf_cap=96)
    n_narrow = n_wide = 0
    for packed, pc, lo, hi in batches:
        prev_n = int(state_c.buf_n)
        state_c = scanstep.scan_step_compact(
            state_c, packed, pc, lo, hi, yp, ysum, n_used=n,
            min_count=min_count, kernel="xla", cand_c=16, cand_k=12,
            tile_rows=16, cand_q=8)
        d = int(state_c.buf_n) - prev_n
        if d == 8:
            n_narrow += 1
        elif d == 48:
            n_wide += 1
    assert n_narrow >= 3, f"narrow append never engaged ({n_narrow})"
    final_c = scanstep.flush_buffered(state_c)
    np.testing.assert_array_equal(np.asarray(state_p.scores),
                                  np.asarray(final_c.scores))
    np.testing.assert_array_equal(
        topk.decode_rows(np.asarray(state_p.row_lo),
                         np.asarray(state_p.row_hi)),
        topk.decode_rows(np.asarray(final_c.row_lo),
                         np.asarray(final_c.row_hi)))


def test_scan_step_compact_c2_matches_plain():
    """cand_c2 < cand_c (top-3 capture limited to the hottest c2 tiles,
    top-1 elsewhere, guarded by the v2-cold condition): final top-k must
    still equal the plain path exactly, with both append and fallback
    branches engaged."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(17)
    n, p, k = 40, 3, 16
    n_pad = 128
    rows_per, n_batches = 256, 24
    min_count = 2
    y = rng.normal(size=(n, p))
    yp, ysum = score.prepare_phenotypes(y, n_pad)

    batches = []
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(rows_per, n)).astype(np.uint8)
        padded = np.zeros((rows_per, n_pad), dtype=np.uint8)
        padded[:, :n] = bits
        packed = jnp.asarray(bitplanes.pack_bits_np(padded))
        pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
        lo, hi = topk.encode_rows(np.arange(b * rows_per, (b + 1) * rows_per))
        batches.append((packed, pc, jnp.asarray(lo), jnp.asarray(hi)))

    state_p = topk.init_state(p, k)
    for packed, pc, lo, hi in batches:
        state_p = scanstep.scan_step(state_p, packed, pc, lo, hi, yp, ysum,
                                     n_used=n, min_count=min_count,
                                     cand_k=8)

    # tile_rows=16 -> n_tiles=16, c=8, c2=2: width = 8 + 4 = 12 | buf 24
    state_c = scanstep.init_buffered_state(p, k, buf_cap=24)
    n_append = 0
    for packed, pc, lo, hi in batches:
        prev_n = int(state_c.buf_n)
        state_c = scanstep.scan_step_compact(
            state_c, packed, pc, lo, hi, yp, ysum, n_used=n,
            min_count=min_count, kernel="xla", cand_c=8, cand_k=12,
            tile_rows=16, cand_c2=2)
        if int(state_c.buf_n) > prev_n:
            n_append += 1
    assert n_append >= 3, "compact append path never engaged"
    assert n_append < n_batches, "fallback path never engaged"
    final_c = scanstep.flush_buffered(state_c)
    np.testing.assert_array_equal(np.asarray(state_p.scores),
                                  np.asarray(final_c.scores))
    np.testing.assert_array_equal(
        topk.decode_rows(np.asarray(state_p.row_lo),
                         np.asarray(state_p.row_hi)),
        topk.decode_rows(np.asarray(final_c.row_lo),
                         np.asarray(final_c.row_hi)))


def test_scan_step_compact_colgroup_matches_plain():
    """Per-column-group decisions (col_group < P): the final top-k must be
    exactly the plain path's even when one column group is persistently
    hot/tie-heavy (forcing ITS fallback while other groups keep appending),
    with and without the narrow append."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(35)
    n, p, k = 40, 10, 12
    n_pad = 128
    rows_per, n_batches = 256, 24
    min_count = 2
    y = rng.normal(size=(n, p))
    y[:, 2] = np.sign(y[:, 2])       # quantized column -> heavy score ties
    yp, ysum = score.prepare_phenotypes(y, n_pad)

    batches = []
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(rows_per, n)).astype(np.uint8)
        bits[:, 1] = bits[:, 0]      # duplicated accessions -> more ties
        padded = np.zeros((rows_per, n_pad), dtype=np.uint8)
        padded[:, :n] = bits
        packed = jnp.asarray(bitplanes.pack_bits_np(padded))
        pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
        lo, hi = topk.encode_rows(np.arange(b * rows_per, (b + 1) * rows_per))
        batches.append((packed, pc, jnp.asarray(lo), jnp.asarray(hi)))

    state_p = topk.init_state(p, k)
    for packed, pc, lo, hi in batches:
        state_p = scanstep.scan_step(state_p, packed, pc, lo, hi, yp, ysum,
                                     n_used=n, min_count=min_count,
                                     cand_k=8)

    for mode_kw in (dict(cand_c=4, cand_q=4), dict(cand_c=4)):
        # col_group=4 -> groups [0:4) [4:8) [8:10): decisions cross a
        # group boundary and the last group is ragged
        state_c = scanstep.init_buffered_state(p, k, buf_cap=24)
        appended = 0
        for packed, pc, lo, hi in batches:
            prev = int(state_c.buf_n)
            state_c = scanstep.scan_step_compact(
                state_c, packed, pc, lo, hi, yp, ysum, n_used=n,
                min_count=min_count, kernel="xla", cand_k=12,
                tile_rows=16, col_group=4, **mode_kw)
            if int(state_c.buf_n) != prev:
                appended += 1
        assert appended >= 5, f"group append path never engaged ({mode_kw})"
        final_c = scanstep.flush_buffered(state_c)
        np.testing.assert_array_equal(np.asarray(state_p.scores),
                                      np.asarray(final_c.scores))
        np.testing.assert_array_equal(
            topk.decode_rows(np.asarray(state_p.row_lo),
                             np.asarray(state_p.row_hi)),
            topk.decode_rows(np.asarray(final_c.row_lo),
                             np.asarray(final_c.row_hi)))


def _numpy_tile_top3(sc, thresh, tile_rows):
    """Literal NumPy transcription of the per-tile top-3 (score.tile_top3)
    over a (P, R) score matrix: first-occurrence argmax picks, each pick
    masked to -inf before the next, multiplicities counted over the lanes
    left after masking."""
    p, r = sc.shape
    t = r // tile_rows
    out = [np.zeros((p, t), d) for d in (np.float32, np.int32) * 3]
    out += [np.zeros((p, t), np.int32) for _ in range(3)]
    for j in range(p):
        for i in range(t):
            s = sc[j, i * tile_rows:(i + 1) * tile_rows].astype(np.float32)
            m1, a1 = s.max(), int(np.argmax(s))
            s2 = s.copy()
            s2[a1] = -np.inf
            m2, a2 = s2.max(), int(np.argmax(s2))
            s3 = s2.copy()
            s3[a2] = -np.inf
            m3, a3 = s3.max(), int(np.argmax(s3))
            vals = (m1, a1, m2, a2, m3, a3, (s2 == m2).sum(),
                    (s3 == m3).sum(), (s > thresh[j]).sum())
            for o, v in zip(out, vals):
                o[j, i] = v
    return out


def _tilemax_case(case):
    """(packed, popcnt, y, n, thresh, tile_rows) for one edge case; y holds
    small integers so every score is exact in f32 whatever the dot order
    (kernel and XLA path then agree bit for bit)."""
    rng = np.random.default_rng(40)
    r, n, p, tile_rows = 256, 70, 3, 64
    if case == "p_gt_128":
        p = 130
    bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
    if case == "min_count_edge":
        # popcounts at and around min_count=5 from both ends
        for i, c in enumerate((4, 5, 6, n - 6, n - 5, n - 4) * 8):
            bits[i] = 0
            bits[i, :c] = 1
    if case == "ties":
        bits[1::2] = bits[0::2]          # every pattern twice per tile
        bits[64:128] = bits[0]           # a whole tile of one pattern
    y = rng.integers(-4, 5, size=(n, p)).astype(np.float64)
    n_pad = 128
    padded = np.zeros((r, n_pad), np.uint8)
    padded[:, :n] = bits
    packed = bitplanes.pack_bits_np(padded)
    popcnt = bits.sum(axis=1).astype(np.float32)
    if case == "padding":
        popcnt[100:] = 0                 # padding rows, incl. whole tiles
        packed[100:] = 0
    thresh = np.full(p, 20.0, np.float32)
    thresh[0] = -np.inf
    return packed, popcnt, y, n, thresh, tile_rows


TILEMAX_CASES = ["p_le_128", "p_gt_128", "padding", "min_count_edge", "ties"]


@pytest.mark.parametrize("case", TILEMAX_CASES)
def test_tilemax_xla_matches_numpy(case):
    """The XLA per-tile top-3 (scanstep._tilemax) equals the NumPy
    transcription on the same scores, plane for plane."""
    from kmersgwas_tpu.ops import scanstep
    packed, popcnt, y, n, thresh, tile_rows = _tilemax_case(case)
    yp, ysum = score.prepare_phenotypes(y, 128)
    args = (jnp.asarray(packed), jnp.asarray(popcnt), yp, ysum)
    sc = np.asarray(scanstep._scores_t_xla(*args, n, 5))
    got = scanstep._tilemax(*args, jnp.asarray(thresh), n, 5, "xla",
                            tile_rows)
    expect = _numpy_tile_top3(sc, thresh, tile_rows)
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(np.asarray(g), e)


@pytest.mark.parametrize("case", TILEMAX_CASES)
def test_tilemax_triton_interpret_matches_xla(case):
    """The Triton scan kernel (interpret mode) reproduces the XLA path's
    nine planes exactly, in both precisions."""
    from kmersgwas_tpu.ops import scanstep
    packed, popcnt, y, n, thresh, tile_rows = _tilemax_case(case)
    yp, ysum = score.prepare_phenotypes(y, 128)
    args = (jnp.asarray(packed), jnp.asarray(popcnt), yp)
    ref = scanstep._tilemax(*args, ysum, jnp.asarray(thresh), n, 5, "xla",
                            tile_rows)
    for precision in ("default", "highest"):
        got = score.score_tilemax_triton(
            *args, jnp.asarray(thresh), n_used=n, min_count=5,
            tile_rows=tile_rows, precision=precision, interpret=True)
        for g, e in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(e))


def test_split_phenotypes_reconstructs():
    """The bit-plane-major bf16 terms sum back to y (three terms: f32
    faithful; one term: bf16 rounding) at the (32w + b) sample order."""
    rng = np.random.default_rng(41)
    y = rng.normal(size=(70, 5))
    yp, _ = score.prepare_phenotypes(y, 128)
    for n_split, tol in ((1, 4e-3), (3, 1e-7)):
        yr = np.asarray(score.split_phenotypes(yp, n_split), np.float64)
        assert yr.shape == (32 * n_split, 16, 128)
        back = yr.reshape(n_split, 32, 16, 128).sum(axis=0)
        back = back[:, :4, :5].transpose(1, 0, 2).reshape(128, 5)
        np.testing.assert_allclose(back, np.asarray(yp), rtol=tol, atol=tol)


def test_scan_step_compact_precision_highest_matches_default():
    """precision="highest" plumbs through the compact step's XLA scores
    (the CPU computes f32 either way, so the state is identical)."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(29)
    bits, packed, y, n_pad = rand_problem(rng, r=128, n=60, p=3)
    n = bits.shape[1]
    yp, ysum = score.prepare_phenotypes(y, n_pad)
    pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
    lo, hi = topk.encode_rows(np.arange(128))
    states = []
    for precision in ("default", "highest"):
        st = scanstep.init_buffered_state(3, 8, buf_cap=24)
        states.append(scanstep.scan_step_compact(
            st, jnp.asarray(packed), pc, jnp.asarray(lo), jnp.asarray(hi),
            yp, ysum, n_used=n, min_count=2, kernel="xla", cand_c=2,
            cand_k=6, tile_rows=64, precision=precision))
    for a, b in zip(*states):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.isfinite(float(np.asarray(states[0].thresh)[0]))


@pytest.mark.parametrize("case", TILEMAX_CASES)
def test_scores_triton_interpret_matches_xla(case):
    """The full-score Triton kernel (the GPU step's fallback scores) equals
    the XLA scores exactly, padding rows at -inf."""
    from kmersgwas_tpu.ops import scanstep
    packed, popcnt, y, n, _, tile_rows = _tilemax_case(case)
    yp, ysum = score.prepare_phenotypes(y, 128)
    args = (jnp.asarray(packed), jnp.asarray(popcnt), yp)
    ref = np.asarray(scanstep._scores_t_xla(*args, ysum, n, 5))
    got = score.score_t_triton(*args, n_used=n, min_count=5,
                               tile_rows=tile_rows, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_scores_triton_are_scores_of_rounded_phenotype(precision):
    """With real-valued phenotypes the kernel's scores are the f32 scores of
    the phenotype its bf16 terms sum to, column sums included: y rounded
    to bf16 ("default") or y itself ("highest"). Rows present in most
    samples are where a sum of the unrounded y would show."""
    from kmersgwas_tpu.ops import scanstep
    rng = np.random.default_rng(43)
    r, n, p = 256, 70, 5
    bits = (rng.random((r, n)) < np.linspace(0.1, 0.95, r)[:, None])
    padded = np.zeros((r, 128), np.uint8)
    padded[:, :n] = bits
    packed = jnp.asarray(bitplanes.pack_bits_np(padded))
    popcnt = jnp.asarray(bits.sum(axis=1), jnp.float32)
    yp, _ = score.prepare_phenotypes(rng.normal(size=(n, p)), 128)
    y_ref = yp.astype(jnp.bfloat16).astype(jnp.float32) \
        if precision == "default" else yp
    ref = np.asarray(scanstep._scores_t_xla(
        packed, popcnt, y_ref, jnp.sum(y_ref, axis=0), n, 5, "highest"))
    got = np.asarray(score.score_t_triton(
        packed, popcnt, yp, n_used=n, min_count=5, tile_rows=64,
        precision=precision, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.max()))


def test_scan_step_compact_triton_interpret_matches_plain(monkeypatch):
    """The compact step with kernel="triton" (kernels in interpret mode,
    fallback scores from score_t_triton) selects exactly the plain step's
    top-k over a stream that engages the append and fallback branches."""
    import functools
    from kmersgwas_tpu.ops import scanstep
    for name in ("score_tilemax_triton", "score_t_triton"):
        monkeypatch.setattr(score, name, functools.partial(
            getattr(score, name), interpret=True))
    rng = np.random.default_rng(42)
    n, p, k, n_pad, rows_per = 40, 3, 16, 128, 256
    y = rng.integers(-4, 5, size=(n, p)).astype(np.float64)
    yp, ysum = score.prepare_phenotypes(y, n_pad)
    state_p = topk.init_state(p, k)
    state_c = scanstep.init_buffered_state(p, k, buf_cap=24)
    n_append = 0
    for b in range(12):
        bits = rng.integers(0, 2, size=(rows_per, n)).astype(np.uint8)
        padded = np.zeros((rows_per, n_pad), np.uint8)
        padded[:, :n] = bits
        packed = jnp.asarray(bitplanes.pack_bits_np(padded))
        pc = jnp.asarray(bits.sum(axis=1), jnp.float32)
        lo, hi = topk.encode_rows(np.arange(b * rows_per, (b + 1) * rows_per))
        lo, hi = jnp.asarray(lo), jnp.asarray(hi)
        state_p = scanstep.scan_step(state_p, packed, pc, lo, hi, yp, ysum,
                                     n_used=n, min_count=2, cand_k=8)
        prev = int(state_c.buf_n)
        state_c = scanstep.scan_step_compact(
            state_c, packed, pc, lo, hi, yp, ysum, n_used=n, min_count=2,
            kernel="triton", cand_c=4, cand_k=12, tile_rows=64)
        n_append += int(state_c.buf_n) > prev
    assert 0 < n_append < 12, "append or fallback branch never engaged"
    final_c = scanstep.flush_buffered(state_c)
    np.testing.assert_array_equal(np.asarray(state_p.scores),
                                  np.asarray(final_c.scores))
    np.testing.assert_array_equal(
        topk.decode_rows(np.asarray(state_p.row_lo),
                         np.asarray(state_p.row_hi)),
        topk.decode_rows(np.asarray(final_c.row_lo),
                         np.asarray(final_c.row_hi)))
