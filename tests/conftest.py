import os

# Force CPU with 8 virtual devices so sharding tests exercise a real mesh
# without accelerator hardware, and enable x64 for numerical-parity
# tolerances. The platform is pinned through jax.config as well as the
# environment, in case something imported JAX first. Card-only tests
# (marker ``gpu``) run without this file, through chip_smoke.py.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.default_backend() == "cpu", jax.default_backend()

# --- vm.max_map_count guard -------------------------------------------------
# XLA:CPU leaks memory mappings as programs accumulate (each compiled
# executable holds JIT code mappings; this suite compiles hundreds of
# programs and crosses ~46k maps by its midpoint). On a default Linux
# vm.max_map_count of 65530 the process hits the ceiling ~280 tests in,
# mmap starts failing, and XLA SIGSEGVs — observed as three *different*
# crash frames (backend_compile_and_load, executable.serialize,
# deserialize_executable) at the same deterministic suite position,
# reproducible with the compilation cache on, off, and write-isolated.
# Bisection chased ghosts for hours because any ~half-suite prefix stays
# under the ceiling. Fix: raise the limit when we can (root containers);
# otherwise shed compiled programs whenever we approach it.


def _read_max_map_count() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except OSError:
        return 1 << 30


def _try_raise_max_map_count() -> None:
    if _read_max_map_count() >= 1 << 20:
        return
    try:
        with open("/proc/sys/vm/max_map_count", "w") as f:
            f.write(str(1 << 20))
    except OSError:
        pass


_try_raise_max_map_count()


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def pytest_runtest_setup(item):
    # Headroom check before every test: if within ~15% of the ceiling,
    # drop all live compiled executables (they re-JIT on demand; with the
    # persistent cache enabled the refill is a disk read).
    limit = _read_max_map_count()
    if _map_count() > 0.85 * limit:
        import warnings

        warnings.warn(
            f"approaching vm.max_map_count={limit}; clearing JAX caches"
        )
        jax.clear_caches()


# Persistent XLA compilation cache: the suite is compile-bound (every
# (problem-shape x options) pair is one XLA program), so repeated runs and
# re-runs after edits skip unchanged compiles entirely. Where
# JAX_COMPILATION_CACHE_DIR is set, JAX uses it and nothing is set here;
# otherwise the cache is <checkout>/.jax_cache/cpu-<fingerprint>.
# Defenses, each earned the hard way:
#
# - the dir is suffixed with a host-CPU-feature fingerprint: XLA:CPU
#   stores AOT machine code whose cache key does NOT include the host ISA,
#   so an entry written on one machine SIGSEGVs on load after a VM
#   migration;
# - writes are fork-isolated below: a serializer crash (e.g. under mmap
#   pressure, see the map-count guard above) loses one cache entry
#   instead of the run;
# - CDDP_TPU_NO_XLA_CACHE=1 disables the cache outright.
import hashlib
from pathlib import Path


def _host_cpu_fingerprint() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha256(feats.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return hashlib.sha256(platform.processor().encode()).hexdigest()[:12]


if not os.environ.get("CDDP_TPU_NO_XLA_CACHE"):
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _cache = (Path(__file__).resolve().parent.parent / ".jax_cache"
                  / f"cpu-{_host_cpu_fingerprint()}")
        _cache.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(_cache))
    # 0.35s write threshold: sub-threshold programs recompile in well under
    # the time their cache round-trip costs, and every serialize() call is
    # crash surface (see above).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.35)

    import multiprocessing as _mp
    import sys as _sys

    from jax._src import compilation_cache as _cc

    _orig_put_executable_and_time = _cc.put_executable_and_time

    def _forked_put_executable_and_time(cache_key, module_name, executable,
                                        backend, compile_time):
        proc = _mp.get_context("fork").Process(
            target=_orig_put_executable_and_time,
            args=(cache_key, module_name, executable, backend, compile_time),
            daemon=True,
        )
        proc.start()
        proc.join(120)
        if proc.is_alive():
            proc.terminate()
            proc.join()
        if proc.exitcode != 0:
            print(
                f"[conftest] persistent-cache write skipped for "
                f"{module_name}: writer child exited {proc.exitcode}",
                file=_sys.stderr,
            )

    # compiler.py binds the name at call time through the module, so
    # patching the module attribute is sufficient.
    _cc.put_executable_and_time = _forked_put_executable_and_time
