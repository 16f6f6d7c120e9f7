"""Multi-chip frame pipeline: the full fused reconstruction (MC + intra
waves + DBF + SAO + ALF) sharded tile-per-device over the virtual CPU mesh
must produce BITWISE the same frames as the single-device program, across
a multi-frame inter GOP (openvvc_tpu/parallel/frame_shard.py).

Runs in a subprocess pinned to JAX_PLATFORMS=cpu with 8 forced host
devices, so the virtual 8-device CPU mesh materializes."""

import os
import subprocess
import sys

import pytest

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


def _run(code: str, timeout=560) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    # the shared persistent compile cache may hold artifacts compiled for a
    # different machine's CPU features (observed: wrong results, not just
    # SIGILL risk) — give the CPU-mesh subprocess its own cache
    env["JAX_COMPILATION_CACHE_DIR"] = _cpumesh_cache_dir()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=timeout, env=env)
    assert r.returncode == 0, (r.stderr[-3000:], r.stdout[-500:])
    return r.stdout


@pytest.mark.parametrize("gop,alf,n", [("lowdelay", False, 2),
                                       ("ra", True, 2)])
def test_sharded_frame_bitwise(gop, alf, n):
    out = _run(
        "from openvvc_tpu.parallel.dryrun import dryrun_frame_pipeline\n"
        f"nf = dryrun_frame_pipeline({n}, gop={gop!r}, alf={alf})\n"
        "print('OK', nf)\n")
    assert "OK" in out


def test_sharded_frame_bitwise_all_tools():
    # the hostile device toolset (ALF + CC-ALF + LFNST + MIP + LMCS
    # reshaper/chroma-scaling + CCLM) through the sharded band program
    out = _run(
        "from openvvc_tpu.parallel.dryrun import dryrun_frame_pipeline\n"
        "nf = dryrun_frame_pipeline(2, gop='lowdelay', alf=True,"
        " all_tools=True)\n"
        "print('OK', nf)\n", timeout=900)
    assert "OK" in out


def test_sharded_halo_matters():
    """Cross-boundary deblocking (loop filters across tiles): the sharded
    vertical pass with ppermute halos must match the single-device dense
    pass bitwise on content whose edges straddle the band boundary — and
    must diverge when the halo exchange is nulled."""
    out = _run(
        "from openvvc_tpu.parallel.dryrun import halo_selftest\n"
        "halo_selftest(4, kill_halo=False)\n"
        "try:\n"
        "    halo_selftest(4, kill_halo=True)\n"
        "    print('BAD-PASS')\n"
        "except AssertionError:\n"
        "    print('HALO-REQUIRED')\n")
    assert "HALO-REQUIRED" in out
