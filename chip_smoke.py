#!/usr/bin/env python3
"""Smoke test of the device lane on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py

Phases; any failure raises, the process exits non-zero and the last line
is never printed:

1. device: JAX must find a GPU, the native host library must load, and
   the card's name and power limit are printed (nvidia-smi).
2. streams: four seeded 1920x1080 streams (two tile columns, 9 frames,
   seed 7; the generator rounds the height down to whole 64-px CTUs) are
   generated by tools/gen_bench_stream.py and cached in .streams/ inside
   the checkout.
3. decode: each profile decodes on the device lane (Decoder(use_tpu=True))
   and on the host lane (Decoder(): C parse and C recon); the outputs must
   be byte-identical and every picture must run the device program
   (tpu_frames == n, no fallback reasons).  Profile ld8 is also compared
   with the Python lane, the in-repo plain reference.  The host-side
   decodes run as subprocesses beside the device lane.  Every subprocess
   is pinned to JAX's CPU platform, so this process alone opens the card.
4. informational lines: cold and warm wall time and fps, compiles in the
   warm run, the trace span breakdown, the warm device time of every
   picture's frame program and of mc_dense alone on each inter picture,
   the residual stage alone, the program without its intra-wave scans on
   the picture with the most scan steps, and the scan steps per picture.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM_DIR = os.path.join(ROOT, ".streams")
GEN = os.path.join(ROOT, "tools", "gen_bench_stream.py")
WIDTH, HEIGHT, FRAMES, TILES, SEED = 1920, 1080, 9, 2, 7

# (name, generator flags); ld8 is the bench's base stream.  ra_alltools
# comes last: its host lane (the Python recon, for LMCS) is the slowest
# reference, and it runs while the other profiles are measured
PROFILES = (
    ("ld8", ("--gop", "lowdelay")),
    ("ld10", ("--gop", "lowdelay", "--bitdepth", "10")),
    ("ra_intertools", ("--gop", "ra", "--inter-tools")),
    ("ra_alltools", ("--gop", "ra", "--all-tools")),
)
PYTHON_LANE = ("ld8",)

# subprocesses run on the CPU platform: only this process opens the card
_CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def check_device():
    """Phase 1: the GPU, the card's name and power limit, the native lib."""
    import jax

    backend = jax.default_backend()
    dev = jax.devices()[0]
    check(backend == "gpu" and dev.platform == "gpu",
          f"no GPU: backend {backend!r}, device {dev.platform!r}")
    from openvvc_tpu import native

    # without it every picture silently takes the Python lane
    check(native.load_cabac_lib() is not None,
          "native host library failed to build or load")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    return dev


def stream_path(name):
    return os.path.join(STREAM_DIR, f"{name}_{WIDTH}x{HEIGHT}x{FRAMES}"
                                    f"_t{TILES}_s{SEED}.266")


def gen_streams(profiles):
    """Phase 2: generate the missing streams in parallel subprocesses."""
    os.makedirs(STREAM_DIR, exist_ok=True)
    procs = []
    for name, flags in profiles:
        path = stream_path(name)
        if os.path.exists(path):
            continue
        tmp = path + ".part"
        args = [sys.executable, GEN, "--width", str(WIDTH),
                "--height", str(HEIGHT), "--frames", str(FRAMES),
                "--tiles", str(TILES), "--seed", str(SEED), "--out", tmp,
                *flags]
        procs.append((name, path, tmp, subprocess.Popen(
            args, env=_CPU_ENV, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    t0 = time.perf_counter()
    for name, path, tmp, p in procs:
        out, _ = p.communicate(timeout=900)
        check(p.returncode == 0, f"stream {name}: generator failed:\n{out}")
        os.replace(tmp, path)
    if procs:
        print(f"streams: generated {len(procs)} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def _yuv(dec, frames):
    return b"".join(f.to_yuv_bytes() for f in dec.output_order(frames))


def _decode(stream, **kw):
    from openvvc_tpu.decoder import Decoder

    dec = Decoder(**kw)
    t0 = time.perf_counter()
    frames = dec.decode(stream)
    out = _yuv(dec, frames)
    return dec, len(frames), out, time.perf_counter() - t0


class _Capture:
    """Wraps frame_program.run_frame: keeps a host copy of every picture's
    (slot, arguments, config)."""

    def __init__(self):
        from openvvc_tpu.tpu import frame_program as fp

        self.fp = fp
        self.orig = fp.run_frame
        self.pictures = []

    def __enter__(self):
        import jax
        import numpy as np

        def spy(ddpb, slot, arrs, cfg):
            # the bundle's leaves live in recycled pools: copy
            self.pictures.append((slot, jax.tree.map(np.array, arrs), cfg))
            return self.orig(ddpb, slot, arrs, cfg)

        self.fp.run_frame = spy
        return self

    def __exit__(self, *exc):
        self.fp.run_frame = self.orig
        return False


def _scan_steps(arrs):
    jc = arrs.get("jobs_c")
    return (int(arrs["jobs_l"].shape[0]), 0 if jc is None else
            int(jc.shape[0]))


def _median_time(fn, reps=10):
    """Median wall time of fn() (which blocks on its result), after one
    warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def device_times(ddpb, pictures):
    """Warm device times (ms) of a decode's pictures, each timed alone with
    device-resident arguments: the whole frame program per picture,
    mc_dense alone per inter picture, run_frame as the decoder calls it
    (host packing and upload included) and the residual stage alone on the
    last inter picture, and the program without its intra-wave jobs on the
    picture with the most scan steps."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from openvvc_tpu.tpu import frame_program as fp
    from openvvc_tpu.tpu.mc_dense import mc_dense

    mc_fn = jax.jit(functools.partial(mc_dense, jnp),
                    static_argnames=("bd", "uw", "uh", "chroma"))

    def step(slot, arrs, cfg):
        blob, bigs, metas, treedef = fp.pack_arrs(arrs)
        blob, bigs = jax.device_put((blob, bigs))

        def run():
            # the step donates the DPB stacks: thread them through ddpb
            ddpb.y, ddpb.cb, ddpb.cr, packed = fp._JITTED(
                ddpb.y, ddpb.cb, ddpb.cr, slot, blob, bigs, metas, treedef,
                cfg)
            packed.block_until_ready()
        return 1e3 * _median_time(run)

    def mc(arrs, cfg):
        margs = jax.device_put(arrs["margs"])
        return 1e3 * _median_time(lambda: jax.block_until_ready(mc_fn(
            ddpb.y, ddpb.cb, ddpb.cr, margs, bd=cfg.bd, uw=cfg.uw,
            uh=cfg.uh, chroma=cfg.chroma)))

    out = {"frame_step_ms": [step(*p) for p in pictures],
           "mc_dense_ms": [mc(a, c) if c.has_inter else None
                           for _s, a, c in pictures]}
    slot, arrs, cfg = [p for p in pictures if p[2].has_inter][-1]
    out["run_frame_ms"] = 1e3 * _median_time(
        lambda: fp.run_frame(ddpb, slot, arrs, cfg).block_until_ready())
    out["resid_ms"] = None
    if cfg.dtu_sig:
        # dequant + LFNST + inverse transform: the int32 einsums
        from openvvc_tpu.tpu import resid_dense

        rin = jax.device_put({k: arrs.get(k) for k in
                              ("dtu", "res_y", "res_cb", "res_cr")})
        resid = jax.jit(lambda r: resid_dense.apply_dtu(
            jnp, r["dtu"], r["res_y"], r["res_cb"], r["res_cr"], cfg.bd,
            cfg.chroma))
        out["resid_ms"] = 1e3 * _median_time(
            lambda: jax.block_until_ready(resid(rin)))

    i = max(range(len(pictures)), key=lambda k: sum(_scan_steps(
        pictures[k][1])))
    slot, arrs, cfg = pictures[i]
    no_scan = dict(arrs)
    for k in ("jobs_l", "jobs_c"):
        if k in no_scan:
            no_scan[k] = np.zeros((0,) + no_scan[k].shape[1:], np.int32)
    out["scan_picture"] = i
    out["no_scan_step_ms"] = step(slot, no_scan, cfg)
    return out


class _CompileCounter:
    def __init__(self):
        import jax

        self.n = 0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **kw):
        if (self.active
                and event == "/jax/core/compile/backend_compile_duration"):
            self.n += 1

    def _event(self, event, **kw):
        if self.active and event == "/jax/compilation_cache/cache_hits":
            self.n += 1


def run_profile(name, compiles):
    """Phase 3 (device side) and 4 for one profile: returns the device
    lane's output bytes and the profile's informational dict."""
    from openvvc_tpu.utils import trace

    with open(stream_path(name), "rb") as f:
        stream = f.read()
    info = {"profile": name, "stream_bytes": len(stream)}

    trace.enable()
    with _Capture() as cap:
        dec, n, dev_out, t_cold = _decode(stream, use_tpu=True)
    info["frames"] = n
    check(dec.stats.get("tpu_frames", 0) == n
          and not dec.stats.get("tpu_fallback_reasons"),
          f"{name}: pictures left the device path: {dec.stats}")
    check(any(c.has_inter for _s, _a, c in cap.pictures),
          f"{name}: no inter picture")

    trace.reset()
    compiles.n, compiles.active = 0, True
    wdec, n_w, warm_out, t_warm = _decode(stream, use_tpu=True)
    compiles.active = False
    check(warm_out == dev_out and wdec.stats.get("tpu_frames", 0) == n_w,
          f"{name}: warm device run differs from the cold run")
    spans = {k: v * 1e3 / n for k, (v, _c) in trace.stats().items()}
    info.update(cold_s=t_cold, cold_fps=n / t_cold, warm_s=t_warm,
                warm_fps=n / t_warm, warm_compiles=compiles.n,
                span_ms_per_frame=spans,
                scan_steps=[_scan_steps(a) for _s, a, _c in cap.pictures])
    info.update(device_times(wdec._ddpb, cap.pictures))
    return dev_out, info


def reference_decode(stream_file, lane, out_file):
    """Decode on a host lane, write the YUV to out_file and print the
    frame count and seconds as JSON.  lane "host" is Decoder() (C parse +
    C recon; the Python recon takes pictures with a tool the C recon
    lacks, such as LMCS); lane "python" is the Python parse + Python recon,
    the in-repo plain reference."""
    from openvvc_tpu.decoder import Decoder

    if lane == "python":
        os.environ["OPENVVC_NATIVE_ENTRY"] = "0"
    with open(stream_file, "rb") as f:
        stream = f.read()
    dec = Decoder(use_native_recon=lane != "python")
    t0 = time.perf_counter()
    frames = dec.decode(stream)
    out = _yuv(dec, frames)
    dt = time.perf_counter() - t0
    with open(out_file, "wb") as f:
        f.write(out)
    print(json.dumps({"frames": len(frames), "seconds": dt}))


def start_references(tmp):
    """Phase 3 (host side): every profile's host-lane decode, and the
    Python lane where asked, as CPU-only subprocesses that run while the
    device lane is measured.  Returns {(profile, lane): (proc, yuv)}."""
    refs = {}
    for name, _flags in PROFILES:
        for lane in ("host", "python") if name in PYTHON_LANE else ("host",):
            yuv = os.path.join(tmp, f"{name}.{lane}.yuv")
            code = ("import chip_smoke; chip_smoke.reference_decode"
                    f"({stream_path(name)!r}, {lane!r}, {yuv!r})")
            refs[name, lane] = (subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=_CPU_ENV,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                yuv)
    return refs


def compare_reference(name, lane, ref, dev_out, info):
    proc, yuv = ref
    out, err = proc.communicate(timeout=1100)
    check(proc.returncode == 0,
          f"{name}: {lane} lane decode failed:\n{err[-4000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    with open(yuv, "rb") as f:
        ref_out = f.read()
    check(res["frames"] == info["frames"] and ref_out == dev_out,
          f"{name}: device lane differs from the {lane} lane")
    info[f"{lane}_lane_fps"] = res["frames"] / res["seconds"]


def report(info):
    p, n = info["profile"], info["frames"]
    print(f"[{p}] bit-exact vs the host lane"
          + (" and the Python lane" if "python_lane_fps" in info else "")
          + f"; tpu_frames == {n}, no fallbacks")
    print(f"[{p}] cold: {info['cold_s']:.3f} s = {info['cold_fps']:.3f} fps "
          f"(compiles included)")
    print(f"[{p}] warm: {info['warm_s']:.3f} s = {info['warm_fps']:.3f} fps; "
          f"compiles in the warm run: {info['warm_compiles']}")
    print(f"[{p}] host lane: {info['host_lane_fps']:.3f} fps"
          + (f"; Python lane: {info['python_lane_fps']:.3f} fps"
             if "python_lane_fps" in info else "")
          + " (CPU subprocesses, run beside the device lane)")
    spans = ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(info["span_ms_per_frame"].items(),
                             key=lambda kv: -kv[1]))
    print(f"[{p}] spans, ms per frame (warm): {spans}")
    steps = info["frame_step_ms"]
    dev_per_frame = sum(steps) / n
    print(f"[{p}] device: frame step per picture (ms) "
          f"{[round(t, 3) for t in steps]}; {dev_per_frame:.3f} ms per frame "
          f"= {100 * dev_per_frame * n / (1e3 * info['warm_s']):.1f}% of "
          f"the warm wall time")
    mc = [(m, t) for m, t in zip(info["mc_dense_ms"], steps) if m is not None]
    print(f"[{p}] device: mc_dense {sum(m for m, _t in mc):.3f} ms over "
          f"{len(mc)} inter pictures = "
          f"{100 * sum(m for m, _t in mc) / sum(t for _m, t in mc):.1f}% of "
          f"their frame steps")
    print(f"[{p}] device: run_frame with host packing and upload "
          f"{info['run_frame_ms']:.3f} ms (last inter picture)")
    if info["resid_ms"] is not None:
        print(f"[{p}] device: residual stage (int32 einsums) "
              f"{info['resid_ms']:.3f} ms (last inter picture)")
    i = info["scan_picture"]
    print(f"[{p}] device: picture {i} ({info['scan_steps'][i]} luma/chroma "
          f"scan steps) {steps[i]:.3f} ms, without its intra-wave scans "
          f"{info['no_scan_step_ms']:.3f} ms")
    print(f"[{p}] intra-wave scan steps (luma, chroma) per picture: "
          f"{info['scan_steps']}")
    print(f"[{p}] json: {json.dumps(info)}", flush=True)


def main():
    check(os.path.isdir(os.path.join(ROOT, "openvvc_tpu"))
          and os.path.exists(GEN),
          f"{ROOT} is not a checkout of the decoder")
    sys.path.insert(0, ROOT)
    dev = check_device()
    gen_streams(PROFILES)
    with tempfile.TemporaryDirectory() as tmp:
        refs = start_references(tmp)
        try:
            compiles = _CompileCounter()
            for name, _flags in PROFILES:
                dev_out, info = run_profile(name, compiles)
                for (rname, lane), ref in refs.items():
                    if rname == name:
                        compare_reference(name, lane, ref, dev_out, info)
                report(info)
        finally:
            for proc, _yuv in refs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    import jax

    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    print(f"device peak bytes in use: {peak}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
