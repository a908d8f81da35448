"""Worker for the two-process distributed scan test (see test_multiprocess.py).

Each process owns half the k-mer rows (as a host shard would), builds the
global 1-D mesh over both processes' CPU devices, and runs the sharded scan
step; process 0 writes the final replicated top-k to disk.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    outdir = sys.argv[3]

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp  # noqa: F401
    from kmersgwas_tpu.ops import bitplanes, score, topk
    from kmersgwas_tpu.parallel import multihost, sharding

    assert len(jax.devices()) == 4, jax.devices()

    rng = np.random.default_rng(0)          # same seed: both build full data
    r, n, p, k = 1024, 30, 3, 16
    n_pad = 128
    bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
    padded = np.zeros((r, n_pad), dtype=np.uint8)
    padded[:, :n] = bits
    packed = bitplanes.pack_bits_np(padded)
    popcnt = bits.sum(axis=1).astype(np.float32)
    y = rng.normal(size=(n, p)).astype(np.float32)
    yp, ysum = score.prepare_phenotypes(y, n_pad)
    lo, hi = topk.encode_rows(np.arange(r))

    # each process contributes its half of the rows
    half = r // 2
    sl = slice(pid * half, (pid + 1) * half)
    mesh = multihost.global_mesh()
    sp, spc, slo, shi = multihost.make_global_batch(
        mesh, [packed[sl], popcnt[sl], lo[sl], hi[sl]])
    ypr, ysr = multihost.replicated(mesh, np.asarray(yp), np.asarray(ysum))
    st0 = topk.init_state(p, k)
    state = topk.TopKState(*multihost.replicated(mesh, *st0))

    step = sharding.build_sharded_scan_step(mesh, n_used=n, min_count=1, k=k)
    state = step(state, sp, spc, slo, shi, ypr, ysr)

    # the state is replicated: every process' local shard holds the full value
    def fetch(a):
        return np.asarray(a.addressable_shards[0].data)

    scores = fetch(state.scores)
    rows = topk.decode_rows(fetch(state.row_lo), fetch(state.row_hi))
    if pid == 0:
        np.savez(os.path.join(outdir, "result.npz"),
                 scores=scores, rows=rows)

    # --- PRODUCTION path: buffered per-device step over 2 streamed batches,
    # all_gather finalize (the only collective) ---
    d = mesh.devices.size
    bstate = sharding.init_sharded_buffered_state(mesh, p, k, buf_cap=8 * 4)
    bstep = sharding.build_sharded_scan_step_buffered(
        mesh, n_used=n, min_count=1, cand_c=8, cand_k=8)
    half_rows = r // 2
    for b in range(2):                        # rows [0,512) then [512,1024)
        gsl = slice(b * half_rows, (b + 1) * half_rows)
        # this process contributes its half of the global batch
        quarter = half_rows // 2
        psl = slice(b * half_rows + pid * quarter,
                    b * half_rows + (pid + 1) * quarter)
        bp, bpc, blo, bhi = multihost.make_global_batch(
            mesh, [packed[psl], popcnt[psl], lo[psl], hi[psl]])
        bstate = bstep(bstate, bp, bpc, blo, bhi, ypr, ysr)
    per = sharding.finalize_sharded_buffered(bstate, mesh)
    if pid == 0:
        np.savez(os.path.join(outdir, "result_buffered.npz"),
                 scores=np.stack([np.pad(v, (0, k - len(v)),
                                         constant_values=-np.inf)
                                  for v, _ in per]),
                 rows=np.stack([np.pad(rw, (0, k - len(rw)))
                                for _, rw in per]))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
