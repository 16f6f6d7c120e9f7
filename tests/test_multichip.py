"""Multi-chip dryrun: sharded tile-per-device DBF with real halo exchange.

Runs in a subprocess pinned to JAX_PLATFORMS=cpu with 8 forced host
devices, so the virtual 8-device CPU mesh materializes."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpumesh_cache_dir():
    """Cache dir keyed by the host CPU feature set: /tmp persists across
    host migrations here, and XLA:CPU AOT artifacts compiled for another
    machine's features mis-execute (observed as flaky wrong results)."""
    import hashlib
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    h = hashlib.md5(line.encode()).hexdigest()[:10]
                    break
            else:
                h = "nofeat"
    except OSError:
        h = "nofeat"
    return f"/tmp/jax_comp_cache_cpumesh_{h}"


def _run(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    # the shared persistent compile cache may hold artifacts compiled for a
    # different machine's CPU features (observed: wrong results, not just
    # SIGILL risk) — give the CPU-mesh subprocess its own cache
    env["JAX_COMPILATION_CACHE_DIR"] = _cpumesh_cache_dir()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=560, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_dryrun_8_devices():
    out = _run("from __graft_entry__ import dryrun_multichip;"
               "dryrun_multichip(8); print('OK')")
    assert "OK" in out


def test_dryrun_fails_without_halo():
    """The parity assert must fail if the ppermute halo exchange is
    dropped — proving the exchanged data feeds the computation."""
    out = _run(
        "from openvvc_tpu.parallel.dryrun import halo_selftest\n"
        "halo_selftest(8, kill_halo=False)\n"
        "try:\n"
        "    halo_selftest(8, kill_halo=True)\n"
        "    print('BAD-PASS')\n"
        "except AssertionError:\n"
        "    print('GOOD-FAIL')\n")
    assert "GOOD-FAIL" in out
