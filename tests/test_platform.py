"""Platform plumbing on the CPU: the kernel choice, the shared compact-step
parameters, the compile-cache placement, and chip_smoke.py refusing to run
without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from kmersgwas_tpu import utils
from kmersgwas_tpu.ops import scanstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,kernel", [("gpu", "triton"),
                                             ("cpu", "xla")])
def test_pick_kernel_by_platform(platform, kernel):
    assert utils.pick_kernel(platform) == kernel


def test_pick_kernel_refuses_other_platforms():
    with pytest.raises(ValueError):
        utils.pick_kernel("metal")
    assert utils.pick_kernel() == "xla"      # the test session's CPU


@pytest.mark.parametrize("rows,k", [(2_000_000, 10001), (500_000, 11025),
                                    (1000, 8), (96, 3), (1, 1)])
def test_compact_params_consistent(rows, k):
    cp = scanstep.compact_params(rows, k)
    assert cp.shard_rows % cp.tile_rows == 0
    assert cp.shard_rows >= rows and cp.shard_rows - rows < cp.tile_rows
    n_tiles = cp.shard_rows // cp.tile_rows
    assert 1 <= cp.cand_c <= min(k, n_tiles)
    width = cp.cand_c + 2 * (cp.cand_c2 or cp.cand_c)
    assert cp.buf_cap % width == 0
    if cp.cand_q < width:                    # the narrow append engages
        assert cp.buf_cap % cp.cand_q == 0
    assert 1 <= cp.cand_k <= min(k, cp.shard_rows)


def test_compact_params_flagship():
    cp = scanstep.compact_params(2_000_000, 10001)
    assert cp == scanstep.CompactParams(
        tile_rows=64, shard_rows=2_000_000, cand_c=256, cand_c2=64,
        cand_q=64, cand_k=1250, buf_cap=6144)


def test_compile_cache_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert utils.compile_cache_dir() == "/elsewhere/cache"


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU (the CPU platform), or no repository beside the script:
    non-zero exit and no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
