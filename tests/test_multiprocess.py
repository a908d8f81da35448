"""True multi-process distributed test: two jax.distributed processes, each
owning half the k-mer rows, must reproduce the single-process scan."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_scan(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multiproc_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(worker))
    procs = [subprocess.Popen([sys.executable, worker, str(pid), str(port),
                               str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    z = np.load(tmp_path / "result.npz")
    got_scores, got_rows = z["scores"], z["rows"]

    # single-process reference
    import jax.numpy as jnp
    from kmersgwas_tpu.ops import bitplanes, score, topk
    rng = np.random.default_rng(0)
    r, n, p_, k = 1024, 30, 3, 16
    n_pad = 128
    bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
    padded = np.zeros((r, n_pad), dtype=np.uint8)
    padded[:, :n] = bits
    packed = bitplanes.pack_bits_np(padded)
    popcnt = bits.sum(axis=1).astype(np.float32)
    y = rng.normal(size=(n, p_)).astype(np.float32)
    yp, ysum = score.prepare_phenotypes(y, n_pad)
    scores = score.score_batch(jnp.asarray(packed), jnp.asarray(popcnt), yp,
                               ysum, n_used=n, min_count=1)
    scores = jnp.where(jnp.asarray(popcnt)[:, None] > 0, scores, -jnp.inf)
    lo, hi = topk.encode_rows(np.arange(r))
    st = topk.update(topk.init_state(p_, k), scores, jnp.asarray(lo),
                     jnp.asarray(hi))
    ref = topk.finalize(st)
    for j in range(p_):
        np.testing.assert_allclose(np.sort(got_scores[j]), np.sort(ref[j][0]),
                                   rtol=1e-5)
        assert set(got_rows[j].tolist()) == set(ref[j][1].tolist())

    # PRODUCTION buffered path: 2 processes x 2 devices over 2 streamed
    # batches must reproduce the single-device buffered scan exactly
    zb = np.load(tmp_path / "result_buffered.npz")
    from kmersgwas_tpu.ops import scanstep as ss
    bstate = ss.init_buffered_state(p_, k, buf_cap=8 * 4)
    half = r // 2
    for b in range(2):
        sl = slice(b * half, (b + 1) * half)
        bstate = ss.scan_step_buffered(
            bstate, jnp.asarray(packed[sl]), jnp.asarray(popcnt[sl]),
            jnp.asarray(lo[sl]), jnp.asarray(hi[sl]), yp, ysum,
            n_used=n, min_count=1, cand_c=8, cand_k=8)
    bref = topk.finalize(ss.flush_buffered(bstate))
    for j in range(p_):
        nv = len(bref[j][0])
        np.testing.assert_allclose(zb["scores"][j][:nv], bref[j][0], rtol=1e-5)
        np.testing.assert_array_equal(zb["rows"][j][:nv], bref[j][1])


@pytest.mark.slow
def test_two_process_product_driver_cli(tmp_path):
    """The PRODUCT multi-process driver (CLI `associate-mp` ->
    multihost.run_distributed_scan): two jax.distributed processes each
    stream their own host_row_span of a real table; the merged top-k written
    by process 0 must equal the single-process associate() result."""
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.ops import bitplanes

    rng = np.random.default_rng(44)
    rows, n, p, k, kmer_len = 600, 24, 3, 25, 15
    names = [f"acc{i}" for i in range(n)]
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
    y = rng.normal(size=(n, p))
    pheno_path = str(tmp_path / "t.pheno")
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=list("abc"), accessions=names, values=y))

    port = _free_port()
    env = {k_: v for k_, v in os.environ.items()
           if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__)) \
        if "__file__" in globals() else os.getcwd()
    import kmersgwas_tpu
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        kmersgwas_tpu.__file__))
    env["JAX_PLATFORMS"] = "cpu"
    args = ["-p", pheno_path, "-t", base, "-k", str(kmer_len),
            "-o", str(tmp_path), "-b", str(k), "--maf", "0.05", "--mac", "2",
            "--batch_size", "128",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu.cli", "associate-mp",
         *args, "--process_id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out.decode(errors="replace"))
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-3000:]

    from kmersgwas_tpu.pipeline import scan as scan_mod
    ref = scan_mod.associate(base, names, y, list("abc"), kmer_len=kmer_len,
                             n_top=k, maf=0.05, mac=2, batch_size=128)
    for j in range(p):
        # dump format is ascending-score heap-pop order (formats.
        # write_best_kmers_scores); compare as sorted multisets
        got_k, got_s = formats.read_best_kmers_scores(
            str(tmp_path / f"pheno.{j}.best_kmers.scores"))
        np.testing.assert_array_equal(np.sort(got_k), np.sort(ref.kmers[j]))
        # separately-compiled processes order f32 reductions differently
        np.testing.assert_allclose(np.sort(got_s), np.sort(ref.scores[j]),
                                   rtol=1e-4)
    n_tested = int(open(tmp_path / "pheno.tested_kmers").read())
    assert n_tested == ref.n_tested
    # full PLINK artifact parity with single-process associate
    from kmersgwas_tpu.pipeline import scan as sm
    d2 = tmp_path / "single"
    d2.mkdir()
    bases_ref = [str(d2 / f"s.{j}") for j in range(p)]
    sm.export_plink(ref, n, kmer_len, bases_ref)
    for j in range(p):
        mp_bed = open(tmp_path / f"pheno.{j}.{['a','b','c'][j]}.bed",
                      "rb").read()
        assert mp_bed == open(bases_ref[j] + ".bed", "rb").read()


@pytest.mark.slow
def test_three_process_skewed_spans(tmp_path):
    """Uneven k-mer ranges: most rows land in one host's span, so the other
    processes exhaust early and must keep lockstep with empty padded batches
    until the slowest host finishes (multihost.run_distributed_scan)."""
    from kmersgwas_tpu.core import formats

    rng = np.random.default_rng(55)
    n, p, k, kmer_len = 20, 2, 15, 15
    names = [f"acc{i}" for i in range(n)]
    space = 1 << (2 * kmer_len)
    # 500 k-mers crammed into the lowest eighth of the space + 40 spread out
    low = rng.choice(space // 8, size=500, replace=False)
    high = space // 8 + rng.choice(space - space // 8, size=40, replace=False)
    kmers = np.sort(np.concatenate([low, high])).astype(np.uint64)
    rows = len(kmers)
    bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
    padded = np.zeros((rows, 64), dtype=np.uint8)
    padded[:, :n] = bits
    pa = np.packbits(padded, axis=1, bitorder="little").view("<u8")
    base = str(tmp_path / "skew")
    formats.write_names(base, names)
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, kmer_len)
        formats.write_table_rows(f, kmers, pa)
    y = rng.normal(size=(n, p))
    pheno_path = str(tmp_path / "t.pheno")
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=["a", "b"], accessions=names, values=y))

    port = _free_port()
    import kmersgwas_tpu
    env = {k_: v for k_, v in os.environ.items()
           if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        kmersgwas_tpu.__file__))
    env["JAX_PLATFORMS"] = "cpu"
    args = ["-p", pheno_path, "-t", base, "-k", str(kmer_len),
            "-o", str(tmp_path), "-b", str(k), "--maf", "0.05", "--mac", "2",
            "--batch_size", "96",
            # per-process span dtable caches (one host's span holds almost
            # all rows, another's is nearly empty)
            "--dtable_cache", str(tmp_path / "span.dtable"),
            "--pattern_counter",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", "3"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu.cli", "associate-mp",
         *args, "--process_id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1, 2)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out.decode(errors="replace"))
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-3000:]

    from kmersgwas_tpu.pipeline import scan as scan_mod
    ref = scan_mod.associate(base, names, y, ["a", "b"], kmer_len=kmer_len,
                             n_top=k, maf=0.05, mac=2, batch_size=96,
                             count_patterns=True)
    from kmersgwas_tpu.core import formats as fm
    for j in range(p):
        got_k, got_s = fm.read_best_kmers_scores(
            str(tmp_path / f"pheno.{j}.best_kmers.scores"))
        np.testing.assert_array_equal(np.sort(got_k), np.sort(ref.kmers[j]))
        np.testing.assert_allclose(np.sort(got_s), np.sort(ref.scores[j]),
                                   rtol=1e-4)
    assert int(open(tmp_path / "pheno.tested_kmers").read()) == ref.n_tested
    # cross-process pattern-set union over skewed spans
    assert int(open(tmp_path / "pheno.pattern_counter").read()) \
        == ref.n_patterns


@pytest.mark.slow
def test_two_process_kinship_cli(tmp_path):
    """CLI kinship-mp: two jax.distributed processes each accumulate their
    k-mer range; process 0's TSV must equal the single-process kinship."""
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.pipeline import kinship as km

    rng = np.random.default_rng(66)
    rows, n, kmer_len = 500, 18, 15
    names = [f"acc{i}" for i in range(n)]
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

    port = _free_port()
    import kmersgwas_tpu
    env = {k_: v for k_, v in os.environ.items()
           if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        kmersgwas_tpu.__file__))
    env["JAX_PLATFORMS"] = "cpu"
    out_tsv = str(tmp_path / "K.tsv")
    args = ["-t", base, "--maf", "0.1", "--batch_size", "64",
            "-o", out_tsv, "--coordinator", f"127.0.0.1:{port}",
            "--num_processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu.cli", "kinship-mp",
         *args, "--process_id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        assert pr.returncode == 0, out.decode(errors="replace")[-3000:]

    K_ref = km.kinship_from_table(base, maf=0.1, batch_size=64)
    K_got = km.read_kinship(out_tsv)
    np.testing.assert_allclose(K_got, K_ref, rtol=0, atol=1e-12)


def test_distributed_kinship_single_process_checkpoint(tmp_path):
    """run_distributed_kinship degenerate single-process case with
    per-process checkpoint: resumed run equals the uninterrupted one."""
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.parallel import multihost
    from kmersgwas_tpu.pipeline import kinship as km

    rng = np.random.default_rng(71)
    rows, n, kmer_len = 300, 16, 15
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

    K_ref = km.kinship_from_table(base, maf=0.1, batch_size=50)
    ck = str(tmp_path / "kc")
    K1 = multihost.run_distributed_kinship(base, maf=0.1, batch_size=50,
                                           checkpoint_path=ck,
                                           checkpoint_every=2)
    np.testing.assert_array_equal(K1, K_ref)
    assert os.path.exists(ck + ".p0.npz")
    # resume from the saved checkpoint (simulates a restarted host)
    K2 = multihost.run_distributed_kinship(base, maf=0.1, batch_size=50,
                                           checkpoint_path=ck,
                                           checkpoint_every=2)
    np.testing.assert_array_equal(K2, K_ref)


def test_distributed_scan_single_process_checkpoint(tmp_path):
    """run_distributed_scan checkpoint/resume (single-process degenerate
    case): resumed run reproduces the uninterrupted result exactly."""
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.parallel import multihost
    from kmersgwas_tpu.pipeline import scan as scan_mod

    rng = np.random.default_rng(81)
    # >= 3 global steps even on the 8-virtual-device mesh (quantum 1024)
    rows, n, p, k, kmer_len = 3000, 20, 2, 15, 15
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
    y = rng.normal(size=(n, p))

    ref = scan_mod.associate(base, names, y, ["a", "b"], kmer_len=kmer_len,
                             n_top=k, maf=0.05, mac=2, batch_size=64)
    ck = str(tmp_path / "sck")
    kw = dict(kmer_len=kmer_len, n_top=k, maf=0.05, mac=2, batch_size=64,
              checkpoint_path=ck, checkpoint_every=1)
    per1, n1, _ = multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                                 **kw)
    assert os.path.exists(ck + ".p0.npz")

    # MID-STREAM interruption: a fresh run killed (via the progress hook)
    # after 3 of ~7 batches leaves a mid-stream checkpoint; the resumed run
    # must re-stream only the tail and reproduce both the top-k AND the
    # exact n_tested (no double-counting in the n_tested accumulation)
    ck2 = str(tmp_path / "sck2")
    kw2 = dict(kw, checkpoint_path=ck2)
    calls = [0]

    class _Interrupt(Exception):
        pass

    def bomb(r):
        calls[0] += 1
        if calls[0] == 2:
            raise _Interrupt

    try:
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       progress=bomb, **kw2)
        raise AssertionError("interruption did not fire")
    except _Interrupt:
        pass
    assert os.path.exists(ck2 + ".p0.npz")
    mid = np.load(ck2 + ".p0.npz")
    assert int(mid["next_row"]) < rows       # genuinely mid-stream
    per2, n2, _ = multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                                 **kw2)
    for per, nt in ((per1, n1), (per2, n2)):
        assert nt == ref.n_tested          # no double-counting on resume
        for j in range(p):
            np.testing.assert_array_equal(per[j][1], ref.rows[j])
            np.testing.assert_allclose(per[j][0], ref.scores[j], rtol=1e-6)


def test_distributed_scan_checkpoint_topology_mismatch(tmp_path):
    """A checkpoint written under one topology/config must be REFUSED when
    resumed under another (different n_top changes the state shape and
    different n_proc changes the span): silent clamping would skip rows."""
    import pytest
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.parallel import multihost

    rng = np.random.default_rng(91)
    rows, n, p, kmer_len = 200, 16, 2, 15
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
    y = rng.normal(size=(n, p))

    ck = str(tmp_path / "tck")
    multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                   kmer_len=kmer_len, n_top=10, maf=0.05,
                                   mac=2, batch_size=64, checkpoint_path=ck,
                                   checkpoint_every=1)
    with pytest.raises(ValueError, match="refusing to resume"):
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       kmer_len=kmer_len, n_top=12, maf=0.05,
                                       mac=2, batch_size=64,
                                       checkpoint_path=ck)


@pytest.mark.slow
def test_two_process_gwas_mp_cli(tmp_path):
    """The ONE-COMMAND multi-host GWAS (CLI `gwas-mp` ->
    pipeline.gwas.run_distributed_gwas): two jax.distributed processes run
    the full pipeline (distributed kinship -> process-0 transform broadcast
    -> distributed scan -> exact LMM + thresholds on process 0); every
    result artifact written by process 0 must be BYTE-IDENTICAL to a
    single-process `run_gwas` over the same table and phenotype."""
    from kmersgwas_tpu.core import formats

    rng = np.random.default_rng(77)
    rows, n, kmer_len = 800, 32, 15
    names = [f"acc{i}" for i in range(n)]
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
    y = rng.normal(size=n)
    pheno_path = str(tmp_path / "t.pheno")
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=names, values=y[:, None]))

    port = _free_port()
    import kmersgwas_tpu
    env = {k_: v for k_, v in os.environ.items()
           if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        kmersgwas_tpu.__file__))
    env["JAX_PLATFORMS"] = "cpu"
    mp_out = tmp_path / "mp_out"
    args = ["--pheno", pheno_path, "--kmers_table", base,
            "--outdir", str(mp_out), "-l", str(kmer_len), "-k", "12",
            "--permutations", "16", "--maf", "0.05", "--mac", "2",
            "--batch_size", "128", "--min_data_points", "10",
            "--pattern_counter", "--seed", "0",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu.cli", "gwas-mp",
         *args, "--process_id", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out.decode(errors="replace"))
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-4000:]
    # the distributed kinship stage persisted its result beside the table
    assert os.path.exists(base + ".kinship")

    # single-process reference over the SAME table via the same CLI in a
    # subprocess with the SAME backend env (the pytest process's forced
    # 8-virtual-device CPU backend partitions eigh differently at the last
    # ulp); it picks up the (losslessly round-tripping) kinship TSV the mp
    # run wrote
    sp_out = tmp_path / "sp_out"
    sp = subprocess.run(
        [sys.executable, "-m", "kmersgwas_tpu.cli", "gwas",
         "--pheno", pheno_path, "--kmers_table", base,
         "--outdir", str(sp_out), "-l", str(kmer_len), "-k", "12",
         "--permutations", "16", "--maf", "0.05", "--mac", "2",
         "--batch_size", "128", "--min_data_points", "10",
         "--pattern_counter", "--seed", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=420)
    assert sp.returncode == 0, sp.stdout.decode(errors="replace")[-4000:]

    identical = [
        "pheno.kinship", "pheno.phenotypes",
        "pheno.phenotypes_and_permutations",
        "pheno.phenotypes_permuted_transformed",
        "kmers/pheno.tested_kmers", "kmers/pheno.pattern_counter",
        "kmers/threshold_5per", "kmers/threshold_10per",
        "kmers/best_pvals", "kmers/pass_threshold_5per",
        "kmers/pass_threshold_10per",
        "kmers/pheno.0.phenotype_value.bed",
        "kmers/pheno.0.phenotype_value.bim",
        "kmers/pheno.0.phenotype_value.fam",
        "kmers/output/phenotype_value.assoc.txt.gz",
    ]
    for rel in identical:
        a = (mp_out / rel).read_bytes()
        b = (sp_out / rel).read_bytes()
        assert a == b, f"artifact differs between gwas-mp and gwas: {rel}"


def test_distributed_kinship_dtable_route(tmp_path):
    """run_distributed_kinship(dtable_cache=...) (single-process degenerate
    case) must equal the raw-table route exactly, including checkpoint
    resume on the dtable stream."""
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.parallel import multihost
    from kmersgwas_tpu.pipeline import kinship as km

    rng = np.random.default_rng(101)
    rows, n, kmer_len = 300, 16, 15
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

    K_ref = km.kinship_from_table(base, maf=0.1, batch_size=50)
    dtc = str(tmp_path / "kc.dtable")
    K1 = multihost.run_distributed_kinship(base, maf=0.1, batch_size=50,
                                           dtable_cache=dtc)
    np.testing.assert_array_equal(K1, K_ref)
    assert os.path.exists(dtc)
    ck = str(tmp_path / "kk")
    K2 = multihost.run_distributed_kinship(base, maf=0.1, batch_size=50,
                                           dtable_cache=dtc,
                                           checkpoint_path=ck,
                                           checkpoint_every=2)
    np.testing.assert_array_equal(K2, K_ref)
    K3 = multihost.run_distributed_kinship(base, maf=0.1, batch_size=50,
                                           dtable_cache=dtc,
                                           checkpoint_path=ck,
                                           checkpoint_every=2)
    np.testing.assert_array_equal(K3, K_ref)


@pytest.mark.slow
def test_gwas_mp_crash_resume(tmp_path):
    """Elastic recovery of the ONE-COMMAND pipeline: both gwas-mp processes
    are SIGKILLed mid-scan (after per-process scan checkpoints appear);
    rerunning the identical command must resume from the checkpoints and
    produce artifacts byte-identical to an uninterrupted single-process
    `gwas` run."""
    import signal
    import time
    from kmersgwas_tpu.core import formats

    rng = np.random.default_rng(88)
    rows, n, kmer_len = 3000, 32, 15
    names = [f"acc{i}" for i in range(n)]
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
    y = rng.normal(size=n)
    pheno_path = str(tmp_path / "t.pheno")
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=names, values=y[:, None]))

    import kmersgwas_tpu
    env = {k_: v for k_, v in os.environ.items()
           if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        kmersgwas_tpu.__file__))
    env["JAX_PLATFORMS"] = "cpu"
    mp_out = tmp_path / "mp_out"
    ck = tmp_path / "ck"

    def launch():
        port = _free_port()
        args = ["--pheno", pheno_path, "--kmers_table", base,
                "--outdir", str(mp_out), "-l", str(kmer_len), "-k", "12",
                "--permutations", "12", "--maf", "0.05", "--mac", "2",
                "--batch_size", "256", "--min_data_points", "10",
                "--seed", "0", "--checkpoint", str(ck),
                "--checkpoint_every", "1",
                "--coordinator", f"127.0.0.1:{port}",
                "--num_processes", "2"]
        return [subprocess.Popen(
            [sys.executable, "-m", "kmersgwas_tpu.cli", "gwas-mp",
             *args, "--process_id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in (0, 1)]

    # attempt 1: kill both processes once scan checkpoints exist
    procs = launch()
    deadline = time.time() + 300
    scan_cks = [f"{ck}.scan.p{pid}.npz" for pid in (0, 1)]
    while time.time() < deadline:
        if all(os.path.exists(p) for p in scan_cks):
            break
        if any(pr.poll() is not None for pr in procs):
            break       # finished before we could kill — still a valid run
        time.sleep(0.2)
    interrupted = False
    if all(os.path.exists(p) for p in scan_cks) and \
            all(pr.poll() is None for pr in procs):
        for pr in procs:
            pr.send_signal(signal.SIGKILL)
        interrupted = True
    for pr in procs:
        try:
            pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            pr.kill()
            pr.communicate()
    assert interrupted, "scan checkpoints never appeared (or run finished early)"
    assert not (mp_out / "kmers" / "threshold_5per").exists()

    # attempt 2: identical command resumes from the per-process checkpoints
    procs = launch()
    for pr in procs:
        out, _ = pr.communicate(timeout=420)
        assert pr.returncode == 0, out.decode(errors="replace")[-4000:]

    # uninterrupted single-process reference in a subprocess (same backend)
    sp_out = tmp_path / "sp_out"
    sp = subprocess.run(
        [sys.executable, "-m", "kmersgwas_tpu.cli", "gwas",
         "--pheno", pheno_path, "--kmers_table", base,
         "--outdir", str(sp_out), "-l", str(kmer_len), "-k", "12",
         "--permutations", "12", "--maf", "0.05", "--mac", "2",
         "--batch_size", "256", "--min_data_points", "10", "--seed", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=420)
    assert sp.returncode == 0, sp.stdout.decode(errors="replace")[-4000:]

    for rel in ("kmers/pheno.tested_kmers", "kmers/threshold_5per",
                "kmers/best_pvals", "kmers/pass_threshold_5per",
                "kmers/output/phenotype_value.assoc.txt.gz"):
        a = (mp_out / rel).read_bytes()
        b = (sp_out / rel).read_bytes()
        assert a == b, f"artifact differs after crash-resume: {rel}"


def test_distributed_scan_dtable_checkpoint_resume(tmp_path):
    """run_distributed_scan on the dtable stream with checkpointing:
    interrupted mid-stream and resumed, must equal the raw-route result
    exactly (dtable-row checkpoint positions, stream-tagged)."""
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu.parallel import multihost
    from kmersgwas_tpu.pipeline import scan as scan_mod

    rng = np.random.default_rng(121)
    rows, n, p, k, kmer_len = 3000, 20, 2, 15, 15
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
    y = rng.normal(size=(n, p))

    ref = scan_mod.associate(base, names, y, ["a", "b"], kmer_len=kmer_len,
                             n_top=k, maf=0.05, mac=2, batch_size=64)
    dtc = str(tmp_path / "c.dtable")
    ck = str(tmp_path / "dck")
    kw = dict(kmer_len=kmer_len, n_top=k, maf=0.05, mac=2, batch_size=64,
              dtable_cache=dtc, checkpoint_path=ck, checkpoint_every=1)

    class _Interrupt(Exception):
        pass

    calls = [0]

    def bomb(r):
        calls[0] += 1
        if calls[0] == 2:
            raise _Interrupt

    try:
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       progress=bomb, **kw)
        raise AssertionError("interruption did not fire")
    except _Interrupt:
        pass
    z = np.load(ck + ".p0.npz")
    assert bytes(z["stream"]).decode() == "dtable"
    per, nt, _ = multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                                **kw)
    assert nt == ref.n_tested
    for j in range(p):
        np.testing.assert_array_equal(per[j][1], ref.rows[j])
        np.testing.assert_allclose(per[j][0], ref.scores[j], rtol=1e-6)


def test_union_patterns_chunked_rounds(monkeypatch):
    """The bounded-round pattern-set union (ADVICE r4: the padded full-set
    allgather could OOM at 1e8+ distinct patterns) must produce the exact
    global distinct count across multiple chunk rounds and skewed set
    sizes — simulated 3-process allgather."""
    import numpy as np
    from kmersgwas_tpu.parallel import multihost
    from kmersgwas_tpu.pipeline.scan import _PatternCounter

    rng = np.random.default_rng(3)
    locals_ = []
    for size in (3500, 1200, 0):        # skew + one empty process
        h = np.unique(rng.integers(0, 1 << 40, size=size).astype(np.uint64))
        locals_.append(np.sort(h))
    expect = len(np.unique(np.concatenate(locals_)))

    class FakeCounter:
        def __init__(self, arr):
            self._arr = arr

        def sorted_hashes(self):
            return self._arr

    calls = {"n": 0, "pos": 0}

    def fake_allgather(x):
        x = np.asarray(x)
        if x.ndim == 0:                  # the lens round
            return np.array([len(a) for a in locals_], np.int64)
        # a chunk round: processes send locals_[i][s:s+width] padded; the
        # chunk start advances by each round's width (last round ragged)
        width = len(x)
        s = calls["pos"]
        calls["n"] += 1
        calls["pos"] += width
        out = np.zeros((3, width), np.uint64)
        for i, a in enumerate(locals_):
            take = a[s:s + width]
            out[i, :len(take)] = take
        return out

    from jax.experimental import multihost_utils
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        fake_allgather)
    got = multihost._union_patterns_across_processes(
        FakeCounter(locals_[0]), chunk=1000)    # 4 rounds for size 3500
    assert calls["n"] >= 4                       # genuinely multi-round
    assert got == expect
