"""Multi-chip dryrun driver: decode a generated tile-column stream with
the single-device fused frame program, then replay every picture through
the sharded pipeline (parallel/frame_shard.py) on an n-device mesh and
assert bitwise equality.

Used by __graft_entry__.dryrun_multichip (driver validation on N virtual
CPU devices) and tests/test_multichip_frame.py."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _gen_stream(path, n_tiles, gop, alf, frames, width, height, leaf=4,
                all_tools=False):
    if os.path.exists(path):
        return
    args = [sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
            "--out", path, "--width", str(width), "--height", str(height),
            "--frames", str(frames), "--tiles", str(n_tiles),
            "--gop", gop, "--leaf-intra", str(leaf), "--leaf-inter",
            str(max(leaf, 4))]
    if all_tools:
        args.append("--all-tools")
    elif alf:
        args.append("--alf")
    subprocess.run(args, check=True, capture_output=True, timeout=600)


def dryrun_frame_pipeline(n_devices, gop="lowdelay", alf=False, frames=3,
                          width=None, height=192, leaf=4, all_tools=False,
                          timing=None):
    """Full sharded pipeline vs single device, bitwise. Tiles == devices.

    timing: optional dict — receives per-frame sharded wall-clock stats
    for the scaling artifact (MULTICHIP_SCALING.json)."""
    import jax

    assert len(jax.devices()) >= n_devices, \
        f"need {n_devices} devices, have {len(jax.devices())}"
    from openvvc_tpu.decoder import Decoder
    from openvvc_tpu.parallel.frame_shard import (band_chroma_segments,
                                                  band_jobs, make_mesh,
                                                  pad_luma_grids,
                                                  run_frame_sharded)
    from openvvc_tpu.tpu import frame_program as fp
    from openvvc_tpu.tpu.device_dpb import DeviceDpb

    if width is None:
        width = 128 * n_devices
    path = (f"/tmp/mc_shard_{n_devices}_{gop}_{int(alf)}{int(all_tools)}_"
            f"{width}x{height}x{frames}_l{leaf}.266")
    _gen_stream(path, n_devices, gop, alf, frames, width, height, leaf,
                all_tools)
    with open(path, "rb") as f:
        stream = f.read()

    captured = []
    job_lists = []
    orig_run = fp.run_frame
    orig_pack = fp.pack_jobs

    def spy_pack(arrays, B=fp.WAVE_B):
        job_lists.append([np.array(a) for a in (arrays or [])])
        return orig_pack(arrays, B)

    def spy_run(ddpb, slot, arrs, cfg):
        import jax

        # deep-copy: several arrs leaves live in recycled buffer pools and
        # would be overwritten by later frames before the replay runs
        snap = jax.tree.map(np.array, arrs)
        captured.append((slot, snap, cfg, job_lists[-2], job_lists[-1]))
        return orig_run(ddpb, slot, arrs, cfg)

    fp.pack_jobs = spy_pack
    fp.run_frame = spy_run
    # the sharded band program consumes dense residual planes; force the
    # capture decode off the device-residual TU records
    prev_dr = os.environ.get("OPENVVC_DEVICE_RESID")
    os.environ["OPENVVC_DEVICE_RESID"] = "0"
    try:
        dec = Decoder(use_tpu=True)
        out_frames = dec.decode(stream)
    finally:
        fp.run_frame = orig_run
        fp.pack_jobs = orig_pack
        if prev_dr is None:
            os.environ.pop("OPENVVC_DEVICE_RESID", None)
        else:
            os.environ["OPENVVC_DEVICE_RESID"] = prev_dr
    n = len(out_frames)
    assert dec.stats.get("tpu_frames", 0) == n, \
        f"device path fell back: {dec.stats}"
    singles = []
    for f in out_frames:
        f.sync_host()
        parts = [np.asarray(f.y).ravel()]
        if f.cb is not None:
            parts += [np.asarray(f.cb).ravel(), np.asarray(f.cr).ravel()]
        singles.append(np.concatenate([p.astype(np.uint8) for p in parts]))

    mesh = make_mesh(n_devices)
    cfg0 = captured[0][2]
    ddpb = DeviceDpb(cfg0.pic_w, cfg0.pic_h, cfg0.chroma)
    for i, (slot, arrs, cfg, jl, jc) in enumerate(captured):
        arrs2 = dict(arrs)
        if "dbf" in arrs2:
            d = dict(arrs2["dbf"])
            d["lv"] = pad_luma_grids(d["lv"])
            d["lh"] = pad_luma_grids(d["lh"])
            for k in ("cbv", "crv"):
                if k in d:
                    d[k] = band_chroma_segments(d[k], n_devices, cfg.pic_w,
                                                True)
            for k in ("cbh", "crh"):
                if k in d:
                    d[k] = band_chroma_segments(d[k], n_devices, cfg.pic_w,
                                                False)
            arrs2["dbf"] = d
        arrs2.pop("jobs_l", None)
        arrs2.pop("jobs_c", None)
        jlb = band_jobs(jl, cfg.entries, n_devices, cfg.pic_w, True)
        jcb = band_jobs(jc, cfg.entries, n_devices, cfg.pic_w, False)
        import time as _time

        t0 = _time.monotonic()
        packed = run_frame_sharded(mesh, ddpb, slot, arrs2, jlb, jcb, cfg)
        got = np.asarray(packed)
        dt = _time.monotonic() - t0
        if timing is not None:
            timing.setdefault("frame_s", []).append(round(dt, 4))
        if not np.array_equal(got, singles[i]):
            nbad = int(np.count_nonzero(got != singles[i]))
            raise AssertionError(
                f"frame {i}: sharded != single-device ({nbad} bytes)")
    return n


def halo_selftest(n_devices, kill_halo=False):
    """Cross-boundary DBF halo validation on synthetic content.

    Builds a plane with strong edges straddling every band boundary and
    loop-filtering ACROSS the boundaries enabled (no tile gating), runs
    the sharded band_dbf_luma over the mesh, and asserts bitwise equality
    with the single-device dense pass.  kill_halo=True nulls the ppermute
    payload first — the assert must then fail, proving the exchanged
    columns feed the computation."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from openvvc_tpu.parallel.frame_shard import (band_dbf_luma, make_mesh,
                                                  pad_luma_grids)
    from openvvc_tpu.rcn.jax_dbf import _apply_pass_dense
    from openvvc_tpu.rcn.ref_dbf import DbfMaps

    rng = np.random.RandomState(3)
    T = n_devices
    W, H = 128 * T, 128
    uw, uh = W // 4, H // 4
    bd = 8
    bd_max = (1 << bd) - 1
    plane = rng.randint(0, 256, (H, W)).astype(np.int32)

    maps = DbfMaps(W, H, chroma=False)
    # 8x8 CU grid everywhere, all edges bs2 (intra), qp mid — edges at
    # every band boundary AND 8 px to each side read/write across
    for y0 in range(0, H, 8):
        for x0 in range(0, W, 8):
            maps.add_cu_luma(x0, y0, 8, 8, 32, intra=True)
    from openvvc_tpu.rcn.jax_dbf import luma_segment_params

    vp, hp = luma_segment_params(maps, 0, 0, bd, W, H, dense=True)

    want = _apply_pass_dense(np, plane.copy(), vp, bd_max, horizontal=False)
    want = _apply_pass_dense(np, want, hp, bd_max, horizontal=True)

    if kill_halo:
        orig = lax.ppermute
        lax.ppermute = lambda x, a, p: x * 0
    try:
        mesh = make_mesh(T)
        lvp = pad_luma_grids(vp)
        lhp = pad_luma_grids(hp)
        uwb = uw // T

        def band(plane_b, lv, lh):
            b = lax.axis_index("t")
            return band_dbf_luma(jnp, plane_b, lv, lh, b, b * uwb, uwb, T,
                                 bd_max)

        fn = jax.shard_map(band, mesh=mesh,
                           in_specs=(P(None, "t"), P(), P()),
                           out_specs=P(None, "t"), check_vma=False)
        got = np.asarray(jax.jit(fn)(jnp.asarray(plane), lvp, lhp))
    finally:
        if kill_halo:
            lax.ppermute = orig
    assert np.array_equal(got, want), \
        f"sharded DBF != single-device ({np.count_nonzero(got != want)} px)"
