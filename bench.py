"""End-to-end decode benchmark: frames/s vs the measured reference baseline.

Decodes a generated 1080p inter-GOP stream (IDR + P frames, fractional-MV
mix, DBF+SAO) end-to-end — host CABAC parse -> batched reconstruction ->
batched in-loop filters — and reports frames/s against the SIMD reference
binary at the 8-thread config (BASELINE_MEASURED.json; re-measured here if
missing). Output bit-exactness against the reference binary is asserted
before timing counts: a fast wrong decoder scores zero.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

STREAM = "/tmp/bench_1080p_r2.266"
REF_YUV = "/tmp/bench_1080p_r2.yuv"
STREAM_RA = "/tmp/bench_1080p_ra.266"
REF_YUV_RA = "/tmp/bench_1080p_ra.yuv"
STREAM_AT = "/tmp/bench_1080p_alltools.266"
REF_YUV_AT = "/tmp/bench_1080p_alltools.yuv"
STREAM_ATRA = "/tmp/bench_1080p_alltools_ra.266"
REF_YUV_ATRA = "/tmp/bench_1080p_alltools_ra.yuv"
STREAM_IT = "/tmp/bench_1080p_intertools.266"
REF_YUV_IT = "/tmp/bench_1080p_intertools.yuv"
STREAM_10B = "/tmp/bench_1080p_10bit.266"
REF_YUV_10B = "/tmp/bench_1080p_10bit.yuv"
STREAM_FI = "/tmp/bench_1080p_fullinter.266"
REF_YUV_FI = "/tmp/bench_1080p_fullinter.yuv"
NB_FRAMES = 9
PERF_BIN = "/tmp/refperf/dectest"


def ensure_assets():
    if not os.path.exists(PERF_BIN):
        subprocess.run(["bash", os.path.join(REPO, "tools/build_reference_perf.sh")],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2", "--out", STREAM],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV):
        subprocess.run([PERF_BIN, "-i", STREAM, "-o", REF_YUV, "-t", "1", "-e", "1"],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM_RA):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2",
                        "--gop", "ra", "--out", STREAM_RA],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV_RA):
        subprocess.run([PERF_BIN, "-i", STREAM_RA, "-o", REF_YUV_RA,
                        "-t", "1", "-e", "1"],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM_AT):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2",
                        "--all-tools", "--out", STREAM_AT],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV_AT):
        subprocess.run([PERF_BIN, "-i", STREAM_AT, "-o", REF_YUV_AT,
                        "-t", "1", "-e", "1"],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM_ATRA):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2",
                        "--all-tools", "--gop", "ra", "--out", STREAM_ATRA],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV_ATRA):
        subprocess.run([PERF_BIN, "-i", STREAM_ATRA, "-o", REF_YUV_ATRA,
                        "-t", "1", "-e", "1"],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM_IT):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2",
                        "--inter-tools", "--gop", "ra", "--out", STREAM_IT],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV_IT):
        subprocess.run([PERF_BIN, "-i", STREAM_IT, "-o", REF_YUV_IT,
                        "-t", "1", "-e", "1"],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM_10B):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2",
                        "--bitdepth", "10", "--out", STREAM_10B],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV_10B):
        subprocess.run([PERF_BIN, "-i", STREAM_10B, "-o", REF_YUV_10B,
                        "-t", "1", "-e", "1"],
                       check=True, capture_output=True)
    if not os.path.exists(STREAM_FI):
        subprocess.run([sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
                        "--frames", str(NB_FRAMES), "--tiles", "2",
                        "--full-inter", "--gop", "ra", "--out", STREAM_FI],
                       check=True, capture_output=True, timeout=1200)
    if not os.path.exists(REF_YUV_FI):
        subprocess.run([PERF_BIN, "-i", STREAM_FI, "-o", REF_YUV_FI,
                        "-t", "1", "-e", "1"],
                       check=True, capture_output=True)


def bench_ra():
    """RA B-pyramid (TMVP + AMVR + bi-pred) fps, bit-exactness gated."""
    from openvvc_tpu.decoder import Decoder

    with open(STREAM_RA, "rb") as f:
        stream = f.read()
    with open(REF_YUV_RA, "rb") as f:
        ref = f.read()
    dec = Decoder()
    t0 = time.monotonic()
    frames = dec.decode(stream)
    dt = time.monotonic() - t0
    mine = b"".join(fr.to_yuv_bytes() for fr in dec.output_order(frames))
    assert mine == ref, "RA decode is not bit-exact vs the reference binary"
    for _ in range(2):
        d2 = Decoder()
        t0 = time.monotonic()
        d2.decode(stream)
        dt = min(dt, time.monotonic() - t0)
    best = None
    for _ in range(3):
        t0 = time.monotonic()
        subprocess.run([PERF_BIN, "-i", STREAM_RA, "-o", "/dev/null",
                        "-t", "8", "-e", "8"], check=True,
                       capture_output=True)
        d = time.monotonic() - t0
        best = d if best is None else min(best, d)
    return {"ra_fps": round(len(frames) / dt, 3),
            "ra_ref_fps_8thread": round(len(frames) / best, 2)}


def bench_fullinter():
    """Host/hybrid lanes on the full inter toolset, bit-exactness gated."""
    from openvvc_tpu.decoder import Decoder

    with open(STREAM_FI, "rb") as f:
        stream = f.read()
    with open(REF_YUV_FI, "rb") as f:
        ref = f.read()
    dec = Decoder()
    t0 = time.monotonic()
    frames = dec.decode(stream)
    dt = time.monotonic() - t0
    mine = b"".join(fr.to_yuv_bytes() for fr in dec.output_order(frames))
    assert mine == ref, "full-inter decode not bit-exact vs the reference"
    for _ in range(2):
        d2 = Decoder()
        t0 = time.monotonic()
        d2.decode(stream)
        dt = min(dt, time.monotonic() - t0)
    out = {"cpu_fullinter_fps": round(len(frames) / dt, 3)}
    try:
        dtpu = Decoder(use_tpu=True)
        t0 = time.monotonic()
        tf = dtpu.decode(stream)
        dt2 = time.monotonic() - t0
        got = b"".join(fr.to_yuv_bytes() for fr in dtpu.output_order(tf))
        assert got == ref
        out["hybrid_fullinter_fps"] = round(len(tf) / dt2, 3)
        out["fullinter_tpu_frames"] = dtpu.stats.get("tpu_frames", 0)
        out["fullinter_fallbacks"] = dtpu.stats.get(
            "tpu_fallback_reasons", {})
    except Exception as e:  # pragma: no cover
        out["hybrid_fullinter_error"] = str(e)[:120]
    return out


def measure_ref_fps():
    base = os.path.join(REPO, "BASELINE_MEASURED.json")
    if os.path.exists(base):
        with open(base) as f:
            d = json.load(f)
        if d.get("nb_frames") and d.get("ref_fps_8thread"):
            # baseline json was measured on the 17-frame stream; fps is
            # stream-length independent enough for the ratio
            return d["ref_fps_8thread"]
    best = None
    for _ in range(3):
        t0 = time.monotonic()
        subprocess.run([PERF_BIN, "-i", STREAM, "-o", "/dev/null", "-t", "8", "-e", "8"],
                       check=True, capture_output=True)
        dt = time.monotonic() - t0
        best = dt if best is None else min(best, dt)
    return NB_FRAMES / best


def bench_tpu(stream_path, ref_path, breakdown=False):
    """Device-resident frame pipeline fps (device does MC + intra + DBF + SAO;
    host does CABAC parse + dequant/itx into the IR). Bit-exactness against
    the reference binary is asserted and EVERY picture must take the device
    path — a fallback frame fails the lane.  With breakdown=True also
    returns the per-stage wall-clock dict (ms per frame) of the best run."""
    from openvvc_tpu.decoder import Decoder
    from openvvc_tpu.utils import trace

    with open(stream_path, "rb") as f:
        stream = f.read()
    with open(ref_path, "rb") as f:
        ref = f.read()
    dec = Decoder(use_tpu=True)
    t0 = time.monotonic()
    frames = dec.decode(stream)
    dt = time.monotonic() - t0
    mine = b"".join(fr.to_yuv_bytes() for fr in dec.output_order(frames))
    assert mine == ref, "device decode is not bit-exact vs the reference"
    n = len(frames)
    assert dec.stats.get("tpu_frames", 0) == n, \
        f"host fallback occurred: {dec.stats}"
    if breakdown:
        trace.enable()
    stages = None
    for _ in range(3):  # best-of-4, warm compile cache
        trace.reset()
        d2 = Decoder(use_tpu=True)
        t0 = time.monotonic()
        d2.decode(stream)
        dt2 = time.monotonic() - t0
        if dt2 < dt:
            dt = dt2
            if breakdown:
                stages = {k: round(v * 1e3 / n, 1)
                          for k, (v, _c) in trace.stats().items()}
    if breakdown:
        return n / dt, stages
    return n / dt


def main():
    ensure_assets()
    from openvvc_tpu.decoder import Decoder

    with open(STREAM, "rb") as f:
        stream = f.read()
    with open(REF_YUV, "rb") as f:
        ref = f.read()

    # correctness gate: output must be byte-identical to the reference
    dec = Decoder()
    t0 = time.monotonic()
    frames = dec.decode(stream)
    dt = time.monotonic() - t0
    mine = b"".join(fr.to_yuv_bytes() for fr in dec.output_order(frames))
    assert mine == ref, "decode is not bit-exact vs the reference binary"
    for _ in range(2):  # best-of-3 (the ref denominator is best-of-3 too)
        d2 = Decoder()
        t0 = time.monotonic()
        d2.decode(stream)
        dt = min(dt, time.monotonic() - t0)

    cpu_fps = len(frames) / dt
    ref_fps = measure_ref_fps()
    extra = {"cpu_fps": round(cpu_fps, 3)}
    tpu_fps = None
    try:
        tpu_fps, stages = bench_tpu(STREAM, REF_YUV, breakdown=True)
        extra["tpu_fps"] = round(tpu_fps, 3)
        if stages:
            extra["tpu_stage_ms_per_frame"] = stages
        extra["tpu_ra_fps"] = round(bench_tpu(STREAM_RA, REF_YUV_RA), 3)
    except Exception as e:  # pragma: no cover - device-dependent
        extra["tpu_error"] = str(e)[:160]
    try:
        # hostile profile: ALF + CC-ALF + LFNST intra mix; a fallback
        # frame fails the lane (bench_tpu asserts tpu_frames == n)
        extra["tpu_alltools_fps"] = round(bench_tpu(STREAM_AT, REF_YUV_AT),
                                          3)
    except Exception as e:  # pragma: no cover - device-dependent
        extra["tpu_alltools_error"] = str(e)[:160]
    try:
        # the round-4 regression lane: RA GOP x 2 tiles x hostile intra
        # toolset, device path required for every picture
        extra["tpu_alltools_ra_fps"] = round(
            bench_tpu(STREAM_ATRA, REF_YUV_ATRA), 3)
    except Exception as e:  # pragma: no cover - device-dependent
        extra["tpu_alltools_ra_error"] = str(e)[:160]
    try:
        # hostile inter toolset (MMVD + BCW + SMVD + CIIP + GPM, RA GOP):
        # every picture must take the device path
        extra["tpu_intertools_fps"] = round(
            bench_tpu(STREAM_IT, REF_YUV_IT), 3)
    except Exception as e:  # pragma: no cover - device-dependent
        extra["tpu_intertools_error"] = str(e)[:160]
    try:
        # main-10 lane (CTC bit depth), device path required
        extra["tpu_fps_10bit"] = round(bench_tpu(STREAM_10B, REF_YUV_10B),
                                       3)
    except Exception as e:  # pragma: no cover - device-dependent
        extra["tpu_10bit_error"] = str(e)[:160]
    try:
        # EVERYTHING inter (affine/SbTMVP/PROF + BDOF/DMVR + the merge
        # toolset): decoded on the default lanes — sub-block/BDOF/DMVR
        # pictures take the host C recon, so this measures the real
        # fallback cost on a CTC-like stream (was ~0.25 fps on the Python
        # lane through round 4); fallback reasons are reported alongside
        extra.update(bench_fullinter())
    except Exception as e:
        extra["fullinter_error"] = str(e)[:160]
    try:
        extra.update(bench_ra())
    except Exception as e:
        extra["ra_error"] = str(e)[:120]
    try:
        extra.update(bench_d2h())
    except Exception as e:  # pragma: no cover - device-dependent
        extra["d2h_error"] = str(e)[:120]
    # headline: fastest bit-exact path; both lanes are reported so the
    # device pipeline's progress stays visible.
    headline = max(x for x in (tpu_fps, cpu_fps) if x is not None)
    print(json.dumps({
        "metric": ("end-to-end 1080p decode, best bit-exact lane "
                   "(device lane: MC+intra+DBF+SAO+ALF; host lane: "
                   "C parse+recon)"),
        "value": round(headline, 3),
        "unit": "fps",
        "vs_baseline": round(headline / ref_fps, 4),
        "device_stages": "inter-MC, intra pred (wave scan), DBF, SAO, ALF",
        "host_stages": "demux, CABAC parse, dequant+itx, IR build",
        **extra,
    }))


def bench_d2h():
    """D2H diagnostics: ms to fetch one packed 1080p output frame (the
    device lane pays this per picture)."""
    import numpy as np
    import jax.numpy as jnp

    n = 2949120  # 1920x1024 + 2x(960x512) uint8
    a = (jnp.arange(n, dtype=jnp.int32) % 251).astype(jnp.uint8)
    a.block_until_ready()
    np.asarray(a)
    best = None
    for i in range(3):
        b = ((jnp.arange(n, dtype=jnp.int32) + i + 1) % 251).astype(jnp.uint8)
        b.block_until_ready()
        t0 = time.monotonic()
        np.asarray(b)
        d = time.monotonic() - t0
        best = d if best is None else min(best, d)
    return {"d2h_frame_ms": round(best * 1e3, 1)}


if __name__ == "__main__":
    main()
