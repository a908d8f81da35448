"""Integration tests: scan driver vs brute force, kinship driver, full GWAS."""
import numpy as np
import pytest

from kmersgwas_tpu.core import codec, formats
from kmersgwas_tpu.core.table import KmersTableReader
from kmersgwas_tpu.ingest import tablebuild, union
from kmersgwas_tpu.pipeline import kinship as kinship_mod
from kmersgwas_tpu.pipeline import scan as scan_mod
from kmersgwas_tpu.pipeline.align import average_phenotypes, intersect_accessions
from kmersgwas_tpu.pipeline.gwas import GWASConfig, run_gwas

K = 15


def build_population(tmp_path, n_samples=24, n_kmers=600, seed=11,
                     causal_effect=0.0):
    """Synthetic population with per-sample strand lists, master list, table,
    a phenotype and (optionally) one causal k-mer."""
    rng = np.random.default_rng(seed)
    pool = np.unique(codec.canonize(
        rng.integers(0, 1 << (2 * K), size=n_kmers * 2, dtype=np.uint64), K))
    presence = rng.random((len(pool), n_samples)) < rng.uniform(0.15, 0.85, size=(len(pool), 1))
    causal_idx = len(pool) // 2
    # give the causal k-mer a balanced pattern
    presence[causal_idx] = rng.random(n_samples) < 0.5

    paths = []
    for s in range(n_samples):
        kk = pool[presence[:, s]]
        ff = rng.integers(1, 4, size=len(kk)).astype(np.uint64)
        p = tmp_path / f"s{s}.kmers"
        formats.write_strand_kmer_list(p, kk, ff)
        paths.append(p)
    master = tmp_path / "master.kmers"
    union.build_master_list(paths, master, K, mac=1, min_strand_frac=0.0)
    names = [f"acc{s:03d}" for s in range(n_samples)]
    base = str(tmp_path / "pop")
    tablebuild.build_table(paths, names, master, base, K)

    g_causal = presence[causal_idx].astype(np.float64)
    y = rng.normal(size=n_samples) + causal_effect * g_causal
    pheno_path = tmp_path / "pheno.tsv"
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=names, values=y[:, None]))
    return dict(base=base, names=names, y=y, pool=pool, presence=presence,
                causal=pool[causal_idx], causal_idx=causal_idx,
                pheno_path=pheno_path)


def brute_force_scores(pop, y_cols, min_count):
    """Direct reference-formula scores over ALL table rows."""
    hdr, kmers, pa = formats.read_table(pop["base"])
    n = hdr.n_accessions
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((pa[:, :, None] >> shifts) & np.uint64(1)).reshape(len(kmers), -1)[:, :n]
    n1 = bits.sum(axis=1).astype(np.float64)
    keep = (n1 >= min_count) & (n1 <= n - min_count)
    out = {}
    for j in range(y_cols.shape[1]):
        yj = y_cols[:, j]
        yigi = bits @ yj
        r = n * yigi - n1 * yj.sum()
        denom = n * n1 - n1**2
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.where(denom > 0, r * r / denom, 0.0)
        out[j] = np.where(keep, s, np.nan)
    return kmers, out, keep


def test_scan_matches_brute_force(tmp_path):
    pop = build_population(tmp_path)
    n = len(pop["names"])
    rng = np.random.default_rng(1)
    y_cols = rng.normal(size=(n, 4))
    res = scan_mod.associate(pop["base"], pop["names"], y_cols,
                             [f"c{j}" for j in range(4)],
                             kmer_len=K, n_top=25, maf=0.05, mac=2,
                             batch_size=97)
    min_count = scan_mod.effective_min_count(n, 0.05, 2)
    kmers, ref_scores, keep = brute_force_scores(pop, y_cols, min_count)
    assert res.n_tested == int(keep.sum())
    for j in range(4):
        sc = ref_scores[j][keep]
        kk = kmers[keep]
        order = np.argsort(-sc, kind="stable")[:25]
        expect = dict(zip(kk[order].tolist(), sc[order].tolist()))
        got = dict(zip(res.kmers[j].tolist(), res.scores[j].tolist()))
        assert set(got) == set(expect)
        for kmer, s in expect.items():
            assert np.isclose(got[kmer], s, rtol=1e-4), (j, kmer)


def test_scan_pattern_counter(tmp_path):
    pop = build_population(tmp_path, n_samples=10, n_kmers=120)
    n = len(pop["names"])
    y = np.random.default_rng(0).normal(size=(n, 1))
    res = scan_mod.associate(pop["base"], pop["names"], y, ["p"], kmer_len=K,
                             n_top=10, maf=0.0, mac=1, batch_size=50,
                             count_patterns=True)
    # expected: distinct presence patterns among MAC-passing rows
    hdr, kmers, pa = formats.read_table(pop["base"])
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((pa[:, :, None] >> shifts) & np.uint64(1)).reshape(len(kmers), -1)[:, :n]
    n1 = bits.sum(axis=1)
    keep = (n1 >= 1) & (n1 <= n - 1)
    uniq = len(set(map(tuple, bits[keep].tolist())))
    assert res.n_patterns == uniq


def test_kinship_driver_matches_brute_force(tmp_path):
    pop = build_population(tmp_path, n_samples=16, n_kmers=200)
    Kmat = kinship_mod.kinship_from_table(pop["base"], maf=0.1, batch_size=64)
    hdr, kmers, pa = formats.read_table(pop["base"])
    n = hdr.n_accessions
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((pa[:, :, None] >> shifts) & np.uint64(1)).reshape(len(kmers), -1)[:, :n]
    n1 = bits.sum(axis=1)
    import math
    mc = math.ceil(n * 0.1)
    keep = (n1 >= mc) & (n1 <= n - mc)
    g = bits[keep].astype(np.int64)
    expect = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            expect[i, j] = np.mean(1 ^ g[:, i] ^ g[:, j])
    np.fill_diagonal(expect, 1.0)
    np.testing.assert_allclose(Kmat, expect, atol=1e-12)
    # round-trip through the TSV writer
    kinship_mod.write_kinship(tmp_path / "k.tsv", Kmat)
    back = kinship_mod.read_kinship(tmp_path / "k.tsv")
    np.testing.assert_allclose(back, Kmat, atol=1e-12)


def test_plink_export_roundtrip(tmp_path):
    pop = build_population(tmp_path, n_samples=9, n_kmers=100)
    n = len(pop["names"])
    y = np.random.default_rng(3).normal(size=(n, 1))
    res = scan_mod.associate(pop["base"], pop["names"], y, ["p"], kmer_len=K,
                             n_top=12, maf=0.0, mac=1, batch_size=1000)
    base = str(tmp_path / "winners")
    scan_mod.export_plink(res, n, K, [base])
    formats.write_fam(base + ".fam", pop["names"], y[:, 0])
    names, dubits = formats.read_bed(base)
    bim = [ln.split("\t") for ln in open(base + ".bim").read().splitlines()]
    assert len(bim) == len(res.kmers[0])
    # rows in table order; each genotype row reproduces the table's pattern
    hdr, kmers, pa = formats.read_table(pop["base"])
    kmer_by_row = dict(zip(range(len(kmers)), kmers))
    rows_sorted = np.sort(res.rows[0])
    for i, (line, r) in enumerate(zip(bim, rows_sorted)):
        kstr, rank = line[1].rsplit("_", 1)
        assert codec.encode_kmers([kstr])[0] == kmer_by_row[int(r)]
        shifts = np.arange(64, dtype=np.uint64)
        expect_bits = ((pa[int(r), :, None] >> shifts) & np.uint64(1)).reshape(-1)[:n]
        assert np.array_equal((dubits[i] == 3).astype(np.uint64), expect_bits)
    # ranks 1..12 each appear exactly once, rank 1 = max score
    ranks = sorted(int(l[1].rsplit("_", 1)[1]) for l in bim)
    assert ranks == list(range(1, len(bim) + 1))


def test_align_helpers():
    accs = ["a", "b", "a", "c"]
    vals = [1.0, 2.0, 3.0, 4.0]
    u_accs, u_vals = average_phenotypes(accs, vals)
    assert u_accs == ["a", "b", "c"]
    np.testing.assert_allclose(u_vals, [2.0, 2.0, 4.0])

    kin_names = ["c", "a", "x", "b"]
    Kf = np.arange(16, dtype=np.float64).reshape(4, 4)
    used, y, Ksub = intersect_accessions(u_accs, u_vals, kin_names, Kf,
                                         ["a", "b", "c", "zzz"])
    assert used == ["a", "b", "c"]
    np.testing.assert_allclose(Ksub, Kf[np.ix_([1, 3, 0], [1, 3, 0])])


@pytest.mark.slow
def test_full_gwas_finds_causal_kmer(tmp_path):
    pop = build_population(tmp_path, n_samples=60, n_kmers=500, seed=5,
                           causal_effect=3.0)
    cfg = GWASConfig(pheno_path=str(pop["pheno_path"]),
                     kmers_table=pop["base"], outdir=str(tmp_path / "out"),
                     kmer_len=K, n_kmers=30, n_permutations=20,
                     maf=0.05, mac=2, batch_size=500, min_data_points=10,
                     lmm_grid=32, lmm_refine=25)
    res = run_gwas(cfg)
    assert res.n_tested > 0
    causal_str = codec.decode_kmers(np.array([pop["causal"]], np.uint64), K)[0]
    # the causal k-mer must clear the 5% permutation threshold
    assert any(s == causal_str for s, _ in res.pass_5per), (
        causal_str, res.pass_5per[:5], res.thresholds)
    # and its p-value should be the best among the passers
    best = min(res.pass_5per, key=lambda t: t[1])
    assert best[0] == causal_str
    # artifacts exist
    out = tmp_path / "out"
    for f in ["kmers/threshold_5per", "kmers/best_pvals", "summary.json",
              "pheno.phenotypes_permuted_transformed", "kmers/pheno.tested_kmers"]:
        assert (out / f).exists(), f


def test_gamma_factor_matches_reference(tmp_path):
    from kmersgwas_tpu.stats.gamma import calc_gamma
    pop = build_population(tmp_path, n_samples=14, n_kmers=150)
    hdr, kmers, pa = formats.read_table(pop["base"])
    n = hdr.n_accessions
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((pa[:, :, None] >> shifts) & np.uint64(1)).reshape(len(kmers), -1)[:, :n]
    n1 = bits.sum(axis=1).astype(np.float64)
    keep = (n1 >= 2) & (n1 <= n - 2)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n))
    Vinv = A @ A.T / n
    got = calc_gamma(pop["base"], Vinv, min_count=2)
    # literal reference transcription (kmers_multiple_databases.cpp:390-416)
    R = np.zeros((n, n))
    M = 0
    for row in np.nonzero(keep)[0]:
        egm = n1[row] / n
        fac = np.sqrt(1.0 / (n * (egm - egm * egm)))
        g = (bits[row].astype(np.float64) - egm) * fac
        R += np.outer(g, g)
        M += 1
    expect = float(np.sum(Vinv * (R / M)))
    assert np.isclose(got, expect, rtol=1e-4)


def test_scan_checkpoint_resume(tmp_path):
    pop = build_population(tmp_path, n_samples=16, n_kmers=300)
    n = len(pop["names"])
    rng = np.random.default_rng(2)
    y = rng.normal(size=(n, 2))
    kw = dict(kmer_len=K, n_top=20, maf=0.05, mac=2, batch_size=50)
    full = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"], **kw)

    # run with checkpointing every batch, then simulate a crash by resuming
    # from a checkpoint captured mid-stream
    ck = str(tmp_path / "scan_ck")
    from kmersgwas_tpu.pipeline import checkpoint as ckpt
    partial_rows = 0
    reader = scan_mod.KmersTableReader(pop["base"], names_to_use=pop["names"])
    # first run: stop after 2 batches worth by driving associate with a
    # checkpoint and then deleting nothing — emulate by calling associate
    # twice; second call must resume and produce identical results
    res1 = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                              checkpoint_path=ck, checkpoint_every=1, **kw)
    # checkpoint exists and holds the final stream position
    st = ckpt.load_scan_state(ck)
    assert st is not None
    res2 = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                              checkpoint_path=ck, checkpoint_every=1, **kw)
    for j in range(2):
        assert set(res1.kmers[j].tolist()) == set(full.kmers[j].tolist())
        assert set(res2.kmers[j].tolist()) == set(full.kmers[j].tolist())
        np.testing.assert_allclose(np.sort(res1.scores[j]), np.sort(full.scores[j]), rtol=1e-6)


def test_kinship_checkpoint_resume(tmp_path):
    pop = build_population(tmp_path, n_samples=12, n_kmers=200)
    full = kinship_mod.kinship_from_table(pop["base"], maf=0.1, batch_size=64)
    ck = str(tmp_path / "kin_ck")
    r1 = kinship_mod.kinship_from_table(pop["base"], maf=0.1, batch_size=64,
                                        checkpoint_path=ck, checkpoint_every=1)
    np.testing.assert_allclose(r1, full, atol=1e-12)
    # resume from the mid-stream checkpoint: must complete to the same matrix
    r2 = kinship_mod.kinship_from_table(pop["base"], maf=0.1, batch_size=64,
                                        checkpoint_path=ck, checkpoint_every=1)
    np.testing.assert_allclose(r2, full, atol=1e-12)


def test_dtable_roundtrip_and_scan_equivalence(tmp_path):
    from kmersgwas_tpu.core import dtable as dt_mod
    pop = build_population(tmp_path, n_samples=16, n_kmers=300)
    n = len(pop["names"])
    # build dtable and verify sections against the reader
    rd = KmersTableReader(pop["base"])
    dt_path = str(tmp_path / "pop.dtable")
    hdr = dt_mod.build_dtable(pop["base"], dt_path, min_count=2, batch_rows=64)
    dt = dt_mod.DTableReader(dt_path)
    whole = rd.load_all(min_count=2)
    assert dt.hdr.n_rows == whole.n_rows
    assert np.array_equal(np.asarray(dt.kmers), whole.kmers)
    assert np.array_equal(np.asarray(dt.planes), whole.packed)
    assert np.array_equal(np.asarray(dt.popcnt), whole.popcnt.astype(np.uint16))
    assert np.array_equal(np.asarray(dt.src_rows), whole.row_index)

    # scan via dtable must equal direct scan
    rng = np.random.default_rng(4)
    y = rng.normal(size=(n, 3))
    kw = dict(kmer_len=K, n_top=30, maf=0.1, mac=1, batch_size=128)
    direct = scan_mod.associate(pop["base"], pop["names"], y, list("abc"), **kw)
    cached = scan_mod.associate(pop["base"], pop["names"], y, list("abc"),
                                dtable_cache=str(tmp_path / "cache.dtable"), **kw)
    # second call hits the cache
    cached2 = scan_mod.associate(pop["base"], pop["names"], y, list("abc"),
                                 dtable_cache=str(tmp_path / "cache.dtable"), **kw)
    for j in range(3):
        assert set(direct.kmers[j].tolist()) == set(cached.kmers[j].tolist())
        assert set(direct.kmers[j].tolist()) == set(cached2.kmers[j].tolist())
        np.testing.assert_allclose(np.sort(direct.scores[j]),
                                   np.sort(cached.scores[j]), rtol=1e-6)
    assert cached.n_tested == direct.n_tested


def test_dtable_cache_refused_for_different_subset(tmp_path):
    """Two DIFFERENT same-size accession subsets must never share a dtable
    cache: (min_count, n_used) alone cannot tell them apart, and reusing the
    cache would silently score the wrong accessions' genotype columns
    (ADVICE r4, medium). The cache header's names_hash forces a rebuild."""
    from kmersgwas_tpu.core import dtable as dt_mod
    pop = build_population(tmp_path, n_samples=20, n_kmers=300)
    names = pop["names"]
    sub_a, sub_b = names[:12], names[4:16]          # same size, different
    rng = np.random.default_rng(7)
    y = rng.normal(size=(12, 2))
    cache = str(tmp_path / "c.dtable")
    kw = dict(kmer_len=K, n_top=15, maf=0.05, mac=2, batch_size=64)
    scan_mod.associate(pop["base"], sub_a, y, ["a", "b"],
                       dtable_cache=cache, **kw)
    assert dt_mod.DTableReader(cache).hdr.names_hash == \
        dt_mod.names_hash_of(sub_a)
    direct_b = scan_mod.associate(pop["base"], sub_b, y, ["a", "b"], **kw)
    cached_b = scan_mod.associate(pop["base"], sub_b, y, ["a", "b"],
                                  dtable_cache=cache, **kw)
    assert cached_b.n_tested == direct_b.n_tested
    for j in range(2):
        assert set(cached_b.kmers[j].tolist()) == \
            set(direct_b.kmers[j].tolist())
        np.testing.assert_allclose(np.sort(cached_b.scores[j]),
                                   np.sort(direct_b.scores[j]), rtol=1e-6)
    # the cache now carries sub_b's identity (it was rebuilt, not reused)
    assert dt_mod.DTableReader(cache).hdr.names_hash == \
        dt_mod.names_hash_of(sub_b)
    # a REORDERED identical subset is also a different bit layout
    assert dt_mod.names_hash_of(list(reversed(sub_b))) != \
        dt_mod.names_hash_of(sub_b)


def test_dtable_legacy_v1_cache_is_stale(tmp_path):
    """A v1 cache (no stored subset identity) reads fine via DTableReader
    but is refused by open_cache, so production paths rebuild it."""
    from kmersgwas_tpu.core import dtable as dt_mod
    pop = build_population(tmp_path, n_samples=12, n_kmers=150)
    p2 = str(tmp_path / "v2.dtable")
    dt_mod.build_dtable(pop["base"], p2, min_count=2, batch_rows=64)
    v2 = dt_mod.DTableReader(p2)
    assert v2.matches(min_count=2, n_used=12,
                      names_hash=dt_mod.names_hash_of(pop["names"]))
    # rewrite as v1: old header layout + identical body
    with open(p2, "rb") as f:
        f.seek(dt_mod._HDR.size)
        body = f.read()
    p1 = str(tmp_path / "v1.dtable")
    with open(p1, "wb") as f:
        f.write(dt_mod._HDR_V1.pack(dt_mod.MAGIC, 1, v2.hdr.n_rows,
                                    v2.hdr.n_used, v2.hdr.w32,
                                    v2.hdr.kmer_len, v2.hdr.min_count))
        f.write(body)
    legacy = dt_mod.DTableReader(p1)
    assert legacy.hdr.names_hash is None
    assert np.array_equal(np.asarray(legacy.kmers), np.asarray(v2.kmers))
    assert dt_mod.open_cache(p1, min_count=2, n_used=12,
                             names_hash=dt_mod.names_hash_of(pop["names"])
                             ) is None


def test_checkpoint_missing_fingerprint_refused(tmp_path):
    """A checkpoint carrying NO topology fingerprint must be refused by a
    load that expects one (ADVICE r4): a pre-fingerprint file from another
    topology could otherwise resume silently mis-spanned."""
    from kmersgwas_tpu.ops import topk as topk_ops
    from kmersgwas_tpu.pipeline import checkpoint as ckpt
    st = topk_ops.TopKState(scores=np.zeros((1, 2), np.float32),
                            row_lo=np.zeros((1, 2), np.int32),
                            row_hi=np.zeros((1, 2), np.int32))
    p = str(tmp_path / "ck")
    ckpt.save_scan_state(p, st, 10, 10, meta=None)
    with pytest.raises(ValueError, match="no topology fingerprint"):
        ckpt.load_scan_state(p, meta={"table_rows": 5})
    assert ckpt.load_scan_state(p) is not None      # meta-less load still ok
    ckpt.save_kinship_state(p, np.zeros((2, 2), np.int64), 1, 1, meta=None)
    with pytest.raises(ValueError, match="no topology fingerprint"):
        ckpt.load_kinship_state(p, meta={"n_proc": 2})


def test_gwas_score_precision_plumbed(tmp_path, monkeypatch):
    """GWASConfig.score_precision reaches the scan and is recorded in
    summary.json (VERDICT r4 #6)."""
    import json
    pop = build_population(tmp_path, n_samples=30, n_kmers=200, seed=9,
                           causal_effect=3.0)
    captured = {}
    orig = scan_mod.associate

    def spy(*args, **kwargs):
        captured["score_precision"] = kwargs.get("score_precision")
        return orig(*args, **kwargs)

    monkeypatch.setattr(scan_mod, "associate", spy)
    run_gwas(GWASConfig(
        pheno_path=str(pop["pheno_path"]), kmers_table=pop["base"],
        outdir=str(tmp_path / "o"), kmer_len=K, n_kmers=15,
        n_permutations=5, maf=0.05, mac=2, batch_size=100,
        min_data_points=10, lmm_grid=16, lmm_refine=10,
        score_precision="highest"))
    assert captured["score_precision"] == "highest"
    summary = json.loads((tmp_path / "o" / "summary.json").read_text())
    assert summary["score_precision"] == "highest"


def test_scan_checkpoint_resume_dtable(tmp_path):
    """Resume on the dtable fast path: checkpoints store the dtable stream
    position (VERDICT weak #4) and a checkpoint from the wrong stream kind
    is ignored rather than misapplied."""
    pop = build_population(tmp_path, n_samples=16, n_kmers=300)
    n = len(pop["names"])
    rng = np.random.default_rng(5)
    y = rng.normal(size=(n, 2))
    dt = str(tmp_path / "pop.dtable")
    kw = dict(kmer_len=K, n_top=20, maf=0.05, mac=2, batch_size=50,
              dtable_cache=dt)
    full = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"], **kw)
    ck = str(tmp_path / "dt_ck")
    r1 = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                            checkpoint_path=ck, checkpoint_every=1, **kw)
    from kmersgwas_tpu.pipeline import checkpoint as ckpt
    st = ckpt.load_scan_state(ck)
    assert st is not None and st[3] == "dtable"
    r2 = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                            checkpoint_path=ck, checkpoint_every=1, **kw)
    for j in range(2):
        assert set(r1.kmers[j].tolist()) == set(full.kmers[j].tolist())
        assert set(r2.kmers[j].tolist()) == set(full.kmers[j].tolist())
        np.testing.assert_allclose(np.sort(r2.scores[j]),
                                   np.sort(full.scores[j]), rtol=1e-6)
    # a "table"-stream checkpoint must NOT seed a dtable-stream run
    kw_nodt = dict(kmer_len=K, n_top=20, maf=0.05, mac=2, batch_size=50)
    ck2 = str(tmp_path / "tab_ck")
    scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                       checkpoint_path=ck2, checkpoint_every=1, **kw_nodt)
    r3 = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                            checkpoint_path=ck2, checkpoint_every=10**6, **kw)
    for j in range(2):
        assert set(r3.kmers[j].tolist()) == set(full.kmers[j].tolist())


def test_scan_midstream_crash_resume_dtable_no_duplicates(tmp_path):
    """A crash BETWEEN batches resumes from the exact dtable row position —
    no row is ever re-appended into the carried top-k state (a duplicate
    would occupy two slots and evict a genuine candidate)."""
    pop = build_population(tmp_path, n_samples=16, n_kmers=400)
    n = len(pop["names"])
    rng = np.random.default_rng(8)
    y = rng.normal(size=(n, 2))
    dtc = str(tmp_path / "pop.dtable")
    kw = dict(kmer_len=K, n_top=20, maf=0.05, mac=2, batch_size=50,
              dtable_cache=dtc)
    full = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"], **kw)
    ck = str(tmp_path / "mid_ck")

    class Boom(RuntimeError):
        pass

    calls = [0]

    def crash_after_3(r):
        calls[0] += 1
        if calls[0] == 3:
            raise Boom()

    with pytest.raises(Boom):
        scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                           checkpoint_path=ck, checkpoint_every=1,
                           progress=crash_after_3, **kw)
    from kmersgwas_tpu.pipeline import checkpoint as ckpt
    st = ckpt.load_scan_state(ck)
    assert st is not None and st[3] == "dtable"
    assert 0 < st[1] < full.n_tested          # genuinely mid-stream
    res = scan_mod.associate(pop["base"], pop["names"], y, ["a", "b"],
                             checkpoint_path=ck, checkpoint_every=1, **kw)
    assert res.n_tested == full.n_tested
    for j in range(2):
        assert set(res.kmers[j].tolist()) == set(full.kmers[j].tolist())
        np.testing.assert_allclose(np.sort(res.scores[j]),
                                   np.sort(full.scores[j]), rtol=1e-6)


def test_certify_column_unit():
    """certify_column: (a) repairs a boundary swap introduced by perturbed
    default-precision scores, (b) refuses the certificate when the carried
    band cannot exclude dropped rows."""
    from kmersgwas_tpu.pipeline.scan import certify_column
    rng = np.random.default_rng(11)
    m, cap = 30, 20
    exact = np.sort(rng.uniform(1.0, 2.0, size=m))[::-1].copy()
    rows = np.arange(100, 100 + m)
    # default scores: exact +- small wobble that swaps ranks at the
    # boundary; the scan carried the top-m by DEFAULT order
    wobble = exact * rng.uniform(-2e-3, 2e-3, size=m)
    default = exact + wobble
    order_def = np.argsort(-default, kind="stable")
    d_sorted, r_sorted, e_sorted = (default[order_def], rows[order_def],
                                    exact[order_def])
    order, cert = certify_column(d_sorted, r_sorted, e_sorted, cap,
                                 eps=6e-3)
    # selected set must be the exact top-cap regardless of the wobble
    sel = set(np.asarray(r_sorted)[order].tolist())
    assert sel == set(rows[np.argsort(-exact)][:cap].tolist())
    # certificate holds iff the cap-th exact beats the worst-carried bound
    assert cert == (np.sort(e_sorted)[::-1][cap - 1]
                    > d_sorted[-1] * (1 + 6e-3))
    # (b) band too narrow: make the carried minimum close to the cap-th
    tight = e_sorted.copy()
    d_tight = d_sorted.copy()
    d_tight[-1] = tight[np.argsort(-tight)[cap - 1]]   # t ~ s_star
    _, cert2 = certify_column(d_tight, r_sorted, tight, cap, eps=6e-3)
    assert not cert2
    # ties break by row ascending (the heap rule)
    e_tie = np.full(6, 5.0)
    r_tie = np.array([9, 3, 7, 1, 5, 2])
    o3, c3 = certify_column(e_tie, r_tie, e_tie, 4, eps=6e-3)
    assert list(r_tie[o3]) == [1, 2, 3, 5]
    assert not c3         # all equal: t == s_star, cannot certify


@pytest.mark.parametrize("freq", [0.1, 0.5, 0.9])
def test_certify_eps_matches_error_model(freq):
    """certify_eps's error model: scoring with the bf16-rounded phenotype
    (and its own sum) moves a row's score by a relative error whose
    standard deviation is certify_eps / CERTIFY_SIGMAS at that score,
    whatever the row's carrier frequency."""
    import jax.numpy as jnp
    from kmersgwas_tpu.pipeline.scan import CERTIFY_SIGMAS, certify_eps
    rng = np.random.default_rng(17)
    n, r = 200, 20000
    g = (rng.random((r, n)) < freq).astype(np.float64)
    n1 = g.sum(axis=1)
    den = n * n1 - n1 * n1
    y = rng.normal(size=n).astype(np.float32)
    yb = y.astype(jnp.bfloat16).astype(np.float64)

    def scores(yy):
        rr = n * (g @ yy) - n1 * yy.sum()
        return rr * rr / np.where(den > 0, den, 1.0)

    exact, rounded = scores(y.astype(np.float64)), scores(yb)
    keep = (den > 0) & (exact > np.median(exact))
    sigma = np.array([certify_eps(y, n, t) for t in exact[keep]]) \
        / CERTIFY_SIGMAS
    z = (rounded[keep] - exact[keep]) / exact[keep] / sigma
    assert 0.9 < z.std() < 1.1, z.std()


def test_associate_certify_topk_matches_oracle(tmp_path):
    """certify_topk on a real scan: the selected sets equal the
    score_precision='highest' oracle run, all columns certified, and the
    reported scores are the f64 re-scores."""
    pop = build_population(tmp_path, n_samples=24, n_kmers=500, seed=13)
    n = len(pop["names"])
    rng = np.random.default_rng(3)
    y = rng.normal(size=(n, 3))
    kw = dict(kmer_len=K, n_top=25, maf=0.05, mac=2, batch_size=128)
    oracle = scan_mod.associate(pop["base"], pop["names"], y, list("abc"),
                                score_precision="highest", **kw)
    cert = scan_mod.associate(pop["base"], pop["names"], y, list("abc"),
                              certify_topk=True, **kw)
    assert cert.certified == [True, True, True]
    min_count = scan_mod.effective_min_count(n, 0.05, 2)
    kmers, ref_scores, keep = brute_force_scores(pop, y, min_count)
    for j in range(3):
        assert set(cert.kmers[j].tolist()) == set(oracle.kmers[j].tolist())
        # certified scores are f64 re-scores of the f32-cast phenotypes:
        # agree with the raw-f64 brute force to input-cast precision
        by_kmer = dict(zip(kmers.tolist(), ref_scores[j].tolist()))
        want = np.array([by_kmer[kk] for kk in cert.kmers[j].tolist()])
        np.testing.assert_allclose(cert.scores[j], want, rtol=1e-6)
        # descending, ties by row ascending
        assert (np.diff(cert.scores[j]) <= 1e-12).all()


def test_pattern_counter_amortized_equals_union():
    """_PatternCounter's deferred compaction gives identical counts to a
    naive per-batch set-union across many small batches (property test for
    the union1d replacement)."""
    from kmersgwas_tpu.pipeline.scan import _PatternCounter
    rng = np.random.default_rng(5)
    pc = _PatternCounter()
    naive = set()
    for _ in range(30):
        r = int(rng.integers(1, 60))
        packed = rng.integers(0, 1 << 8, size=(r, 2), dtype=np.uint64
                              ).astype(np.uint32)   # few distinct patterns
        w64 = np.ascontiguousarray(packed).view("<u8")
        from kmersgwas_tpu.core import codec
        naive.update(codec.pattern_hash(w64).tolist())
        pc.add(packed)
        assert pc.count == len(naive)


def test_kinship_dtable_route_matches_raw(tmp_path):
    """kinship_from_table(dtable_cache=...) accumulates exactly the raw
    route's row set (stale caches with a different filter are ignored), and
    the stream-tagged checkpoint resumes on the right row numbering."""
    from kmersgwas_tpu.pipeline import kinship as km
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    dtc = str(tmp_path / "k.dtable")
    K_raw = km.kinship_from_table(pop["base"], maf=0.1, batch_size=64)
    K_dt = km.kinship_from_table(pop["base"], maf=0.1, batch_size=64,
                                 dtable_cache=dtc)
    np.testing.assert_array_equal(K_dt, K_raw)
    # stale cache (built for maf=0.1) must be ignored for maf=0.3
    K_raw2 = km.kinship_from_table(pop["base"], maf=0.3, batch_size=64)
    K_dt2 = km.kinship_from_table(pop["base"], maf=0.3, batch_size=64,
                                  dtable_cache=dtc)
    np.testing.assert_array_equal(K_dt2, K_raw2)
    # checkpointed dtable run
    ck = str(tmp_path / "kc")
    K_c = km.kinship_from_table(pop["base"], maf=0.1, batch_size=64,
                                dtable_cache=dtc, checkpoint_path=ck,
                                checkpoint_every=2)
    np.testing.assert_array_equal(K_c, K_raw)


def test_full_gwas_n_devices_matches_single(tmp_path):
    """run_gwas(n_devices=2): kinship and scan both run on the mesh; the
    thresholds and passing set must match the single-device run exactly."""
    pop = build_population(tmp_path, n_samples=40, n_kmers=400, seed=6,
                           causal_effect=3.0)
    kw = dict(pheno_path=str(pop["pheno_path"]), kmers_table=pop["base"],
              kmer_len=K, n_kmers=20, n_permutations=10, maf=0.05, mac=2,
              batch_size=200, min_data_points=10, lmm_grid=32, lmm_refine=20)
    r1 = run_gwas(GWASConfig(outdir=str(tmp_path / "o1"), **kw))
    (tmp_path / "pop.kinship").unlink()          # force kinship recompute
    r2 = run_gwas(GWASConfig(outdir=str(tmp_path / "o2"), n_devices=2, **kw))
    assert r1.thresholds == r2.thresholds
    assert sorted(s for s, _ in r1.pass_5per) == sorted(
        s for s, _ in r2.pass_5per)
    assert r2.stage_seconds.get("kinship") is not None


def test_pread_gather_regimes(tmp_path):
    """_pread_gather must return exactly the requested records in both
    regimes: DENSE (covering-span streaming, forced by clustered rows) and
    SPARSE (per-row parallel preads, forced by a wide row spread)."""
    from kmersgwas_tpu.pipeline.scan import _pread_gather

    rng = np.random.default_rng(5)
    n_rows, row_bytes, base_off = 200_000, 24, 17
    data = rng.integers(0, 256, size=(n_rows, row_bytes), dtype=np.uint8)
    path = tmp_path / "records.bin"
    with open(path, "wb") as f:
        f.write(b"\x00" * base_off)
        f.write(data.tobytes())

    # dense: 5000 of the first 10000 rows -> span 240 KB << 5 KB/row budget
    dense = np.unique(rng.choice(10_000, size=5_000, replace=False))
    got = _pread_gather(str(path), base_off, row_bytes, dense)
    np.testing.assert_array_equal(got, data[dense])

    # sparse: 300 rows over the full range -> > 5 KB/row, per-row preads
    sparse = np.unique(rng.choice(n_rows, size=300, replace=False))
    got = _pread_gather(str(path), base_off, row_bytes, sparse)
    np.testing.assert_array_equal(got, data[sparse])

    # single row, first row, last row
    for rows in ([0], [n_rows - 1], [123]):
        got = _pread_gather(str(path), base_off, row_bytes,
                            np.array(rows, np.int64))
        np.testing.assert_array_equal(got, data[np.array(rows)])

    # empty
    assert _pread_gather(str(path), base_off, row_bytes,
                         np.empty(0, np.int64)).shape == (0, row_bytes)


def test_run_distributed_gwas_single_process(tmp_path):
    """run_distributed_gwas in the single-process degenerate case (no
    jax.distributed, no broadcast wire) must write byte-identical artifacts
    to run_gwas, with checkpoint_base and dtable_cache plumbed through."""
    import os
    from kmersgwas_tpu.pipeline.gwas import run_distributed_gwas

    pop = build_population(tmp_path, n_samples=40, n_kmers=400, seed=9,
                           causal_effect=3.0)
    kw = dict(pheno_path=str(pop["pheno_path"]), kmers_table=pop["base"],
              kmer_len=K, n_kmers=20, n_permutations=10, maf=0.05, mac=2,
              batch_size=200, min_data_points=10, lmm_grid=32, lmm_refine=20,
              pattern_counter=True)
    r1 = run_gwas(GWASConfig(outdir=str(tmp_path / "sp"), **kw))
    r2 = run_distributed_gwas(GWASConfig(
        outdir=str(tmp_path / "mp"), checkpoint_base=str(tmp_path / "ck"),
        dtable_cache=str(tmp_path / "c.dtable"), **kw))
    assert r2 is not None
    assert r1.thresholds == r2.thresholds
    assert r1.n_tested == r2.n_tested
    for rel in ("kmers/pass_threshold_5per", "kmers/threshold_5per",
                "kmers/best_pvals", "kmers/pheno.pattern_counter",
                "kmers/output/phenotype_value.assoc.txt.gz"):
        a = (tmp_path / "sp" / rel).read_bytes()
        b = (tmp_path / "mp" / rel).read_bytes()
        assert a == b, f"artifact differs: {rel}"
    assert os.path.exists(str(tmp_path / "c.dtable"))

    # unsupported-in-mp options are refused, not silently ignored
    import pytest as _pytest
    with _pytest.raises(ValueError, match="single-process"):
        run_distributed_gwas(GWASConfig(
            outdir=str(tmp_path / "x"), run_snps="one_step", **kw))


def test_associate_midsize_n_top_width_divisibility(tmp_path):
    """n_top between ~65 and 255 makes cand_c a non-power-of-two while
    cand_c2 stays 64: the buffer capacity must still be a multiple of the
    append width (regression: a cand_c*24 cap asserted out for
    cand_c=100, width=228)."""
    from kmersgwas_tpu.core import formats

    rng = np.random.default_rng(33)
    rows, n, kmer_len = 2000, 24, 15
    names = [f"a{i}" for i in range(n)]
    kmers = np.sort(rng.choice(1 << (2 * kmer_len), size=rows, replace=False)
                    ).astype(np.uint64)
    bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
    padded = np.zeros((rows, 64), dtype=np.uint8)
    padded[:, :n] = bits
    pa = np.packbits(padded, axis=1, bitorder="little").view("<u8")
    base = str(tmp_path / "pop")
    formats.write_names(base, names)
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, kmer_len)
        formats.write_table_rows(f, kmers, pa)
    y = rng.normal(size=(n, 2))

    res = scan_mod.associate(base, names, y, ["a", "b"], kmer_len=kmer_len,
                             n_top=100, maf=0.05, mac=2, batch_size=12800)
    # brute-force check of column 0's top-100
    from kmersgwas_tpu.ops import score as so
    import jax.numpy as jnp
    reader = KmersTableReader(base, names_to_use=names)
    b = next(reader.iter_batches(rows, scan_mod.effective_min_count(n, 0.05, 2)))
    yp, ysum = so.prepare_phenotypes(np.asarray(y, np.float32), reader.w32 * 32)
    sc = np.asarray(so.score_batch(jnp.asarray(b.packed),
                                   jnp.asarray(b.popcnt), yp, ysum,
                                   n_used=n, min_count=scan_mod.effective_min_count(n, 0.05, 2)))
    order = np.argsort(-sc[:, 0], kind="stable")[:100]
    assert set(res.rows[0].tolist()) == set(b.row_index[order].tolist())


def test_gwas_readonly_table_dir_kinship_fallback(tmp_path, monkeypatch):
    """A read-only table directory (shared-FS deployment) must not crash
    the kinship persist: the computed matrix falls back into outdir and
    the pipeline completes. (Simulated via a write_kinship that refuses
    the beside-the-table path — the suite runs as root, so permission
    bits alone cannot block the write.)"""
    import os
    import kmersgwas_tpu.pipeline.gwas as gwas_mod

    pop = build_population(tmp_path, n_samples=40, n_kmers=300, seed=12,
                           causal_effect=3.0)
    orig = gwas_mod.kinship_mod.write_kinship

    def deny_beside_table(path, Kmat):
        if str(path) == pop["base"] + ".kinship":
            raise OSError(30, "Read-only file system")
        return orig(path, Kmat)

    monkeypatch.setattr(gwas_mod.kinship_mod, "write_kinship",
                        deny_beside_table)
    res = run_gwas(GWASConfig(
        pheno_path=str(pop["pheno_path"]), kmers_table=pop["base"],
        outdir=str(tmp_path / "out"), kmer_len=K, n_kmers=15,
        n_permutations=8, maf=0.05, mac=2, batch_size=200,
        min_data_points=10, lmm_grid=32, lmm_refine=20))
    assert res.n_tested > 0
    assert (tmp_path / "out" / "full_table.kinship").exists()
    assert not os.path.exists(pop["base"] + ".kinship")
    assert "kinship cache beside the table failed" in \
        (tmp_path / "out" / "log_file").read_text()
