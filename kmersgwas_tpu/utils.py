"""Small shared utilities: scan-kernel choice, compile cache, stage timing.

The reference's observability is wall-clock prints per batch
(associate_kmers.cpp:127-146); here every driver reports stage durations and
k-mers/s through a StageTimer, and the scan kernel is chosen from the
platform JAX runs on.
"""
from __future__ import annotations

import os
import sys
import time

# the compile cache's place in the checkout when JAX_COMPILATION_CACHE_DIR
# is unset (listed in .gitignore; a fixed path, so runs find each other's
# compiled programs)
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def pick_kernel(platform: str | None = None) -> str:
    """Compact-step scoring kernel for `platform` (default: the platform of
    jax.devices()[0]): the fused Triton kernel on a GPU, plain XLA on the
    CPU. Any other platform is an error, not a fallback."""
    if platform is None:
        import jax
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no scan kernel for platform {platform!r}")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's .jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() (an
    explicit JAX_COMPILATION_CACHE_DIR is left to JAX itself, which reads
    it) and return the directory. Call before the first compilation."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def drain(handle) -> None:
    """Backpressure point of the bounded dispatch pipelines: force the
    device queue to have COMPLETED `handle` (an output of the step a few
    batches back) before returning, releasing every older batch's
    host/transfer buffers.

    Fetches ONE element to the host: an in-order device queue cannot serve
    the fetch before finishing every earlier step, and the scalar copy
    costs microseconds. For multi-process global arrays the fetch targets
    the process-LOCAL shard (a global fetch would need a collective)."""
    import numpy as np
    shards = getattr(handle, "addressable_shards", None)
    if shards is not None:
        handle = shards[0].data
    if handle.ndim:
        handle = handle.ravel()[:1]
    np.asarray(handle)


class StageTimer:
    """Accumulates per-stage wall time + item counts; prints to stderr."""

    def __init__(self, name: str, unit: str = "items", quiet: bool = False):
        self.name = name
        self.unit = unit
        self.quiet = quiet
        self.t0 = time.perf_counter()
        self.items = 0
        self._last_report = self.t0

    def add(self, n: int) -> None:
        self.items += n
        now = time.perf_counter()
        if not self.quiet and now - self._last_report > 10.0:
            self._last_report = now
            rate = self.items / max(now - self.t0, 1e-9)
            print(f"[{self.name}] {self.items:,} {self.unit} "
                  f"({rate:,.0f}/s)", file=sys.stderr, flush=True)

    def done(self) -> float:
        dt = time.perf_counter() - self.t0
        if not self.quiet:
            rate = self.items / max(dt, 1e-9)
            print(f"[{self.name}] done: {self.items:,} {self.unit} in "
                  f"{dt:.1f}s ({rate:,.0f}/s)", file=sys.stderr, flush=True)
        return dt


class profile_trace:
    """Context manager around jax.profiler.trace: writes a TensorBoard-
    loadable device trace (the reference's only profiling was wall-clock
    prints; SURVEY.md §5)."""

    def __init__(self, logdir: str):
        self.logdir = logdir

    def __enter__(self):
        import jax
        jax.profiler.start_trace(self.logdir)
        return self

    def __exit__(self, *exc):
        import jax
        jax.profiler.stop_trace()
