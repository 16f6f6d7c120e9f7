"""Batched device reconstruction pipeline stages.

Host parse emits the CU/TU IR; these passes sweep the IR and run the heavy
sample math as a handful of batched XLA launches per frame, attaching
results to the IR nodes. The sequential reconstruction loop then consumes
the precomputed tensors instead of recomputing them per CU — keeping
bit-exactness trivially (same math, batched) while the FIR work runs on
device. Equivalent of the reference's per-CU SIMD dispatch
(/root/reference/libovvc/rcn_inter.c:430-720 + x86/rcn_mc_sse.c), re-shaped
as frame-level batches for the device.
"""

from __future__ import annotations

import numpy as np

from openvvc_tpu.drv.inter_mvp import MV_PRECISION_HALF


def _clip_mv(pos_x, pos_y, pic_w, pic_h, pb_w, pb_h, mvx, mvy):
    x_max = (pic_w + 2 - pos_x) << 4
    y_max = (pic_h + 2 - pos_y) << 4
    x_min = -((pb_w + 3 + pos_x) << 4)
    y_min = -((pb_h + 3 + pos_y) << 4)
    return max(x_min, min(x_max, mvx)), max(y_min, min(y_max, mvy))


def _dev_plane(frame, name):
    """Device copy of a reference plane, cached on the Frame object."""
    import jax.numpy as jnp

    cache = getattr(frame, "_dev_planes", None)
    if cache is None:
        cache = frame._dev_planes = {}
    if name not in cache:
        cache[name] = jnp.asarray(getattr(frame, name), jnp.int32)
    return cache[name]


def _device_interp(frame_ref, pname, xs, ys, fxs, fys, bw, bh, bitdepth,
                   luma, hpel):
    """Device MC FIR: the XLA gather formulation of rcn/jax_mc.py."""
    from openvvc_tpu.rcn import jax_mc

    plane = _dev_plane(frame_ref, pname)
    return jax_mc.interp_14bit_jit(plane, xs, ys, fxs, fys, bw, bh,
                                   bitdepth, luma=luma, hpel=hpel)


def precompute_inter_mc(parsed, params, tools, refs, bitdepth, device=True):
    """Batch the plain uni/bi MC of every eligible inter CU.

    device=True runs the FIR stage as XLA launches; device=False runs the
    identical math as vectorized numpy (the fast host path).
    Eligible: non-GPM, non-DMVR CUs (BDOF CUs get chroma only — their luma
    takes the optical-flow path). Results are attached as cu.mc_pre
    {"y"|"cb"|"cr": np.ndarray} in the bd domain (pre-LMCS, pre-CIIP blend),
    exactly what the scalar path computes before those steps.
    """
    from openvvc_tpu.decoder import inter_tool_flags
    from openvvc_tpu.rcn import jax_mc

    refs0, refs1 = refs[0], refs[1]
    pic_w, pic_h = params.pps.pic_w, params.pps.pic_h
    chroma = params.sps.sps_chroma_format_idc != 0
    _BCW_W = (-2, 3, 4, 5, 10)

    # jobs[key] -> list of (cu, plane_name, lst) with per-job gather args
    # key = (plane_id, w, h, luma, hpel) for the interp stage
    interp_jobs: dict = {}

    def add_job(plane_frame, plane_name, cu, lst, mv, cx, cy, bw, bh, luma, hpel):
        mvx, mvy = _clip_mv(cu.x0, cu.y0, pic_w, pic_h,
                            1 << cu.log2_w, 1 << cu.log2_h, mv.x, mv.y)
        sh = 4 if luma else 5
        msk = 0xF if luma else 0x1F
        key = (id(plane_frame), plane_name, bw, bh, luma, hpel)
        lst_jobs = interp_jobs.setdefault(key, ([], plane_frame))
        lst_jobs[0].append((cu, lst, cx + (mvx >> sh), cy + (mvy >> sh),
                            mvx & msk, mvy & msk))

    eligible = []
    for _, ectx in parsed:
        for ctu in ectx.ctus:
            for cu in ctu.cus:
                if cu.pred_mode != 1 or cu.gpm_flag \
                        or getattr(cu, "sb_info", None) is not None:
                    continue
                bdof_en, dmvr_en = inter_tool_flags(cu, tools, refs)
                if dmvr_en:
                    continue
                inter_dir = cu.inter_dir if cu.mv1 is not None else 1
                hpel = cu.prec_amvr_eff == MV_PRECISION_HALF
                w, h = 1 << cu.log2_w, 1 << cu.log2_h
                lists = ((0, 1) if inter_dir == 3 else
                         ((0,) if inter_dir & 1 else (1,)))
                do_luma = not bdof_en
                eligible.append((cu, inter_dir, lists, do_luma))
                for lst in lists:
                    mv = cu.mv0 if lst == 0 else cu.mv1
                    ref = (refs0 if lst == 0 else refs1)[mv.ref_idx]
                    if do_luma:
                        add_job(ref, "y", cu, lst, mv, cu.x0, cu.y0, w, h,
                                True, hpel)
                    if chroma:
                        add_job(ref, "cb", cu, lst, mv, cu.x0 >> 1, cu.y0 >> 1,
                                w >> 1, h >> 1, False, False)
                        add_job(ref, "cr", cu, lst, mv, cu.x0 >> 1, cu.y0 >> 1,
                                w >> 1, h >> 1, False, False)

    if not eligible:
        return

    # stage 1: batched 14-bit interp per (plane, size) class; interp outputs
    # of one (pname, w, h) class are concatenated so stage 2 can combine the
    # whole class with a single vectorized expression
    cls_out: dict = {}   # (pname, bw, bh) -> list of arrays
    cls_row: dict = {}   # (id(cu), pname, lst) -> (class_key, global_row)
    for (pid, pname, bw, bh, luma, hpel), (jobs, frame_ref) in interp_jobs.items():
        xs = np.asarray([j[2] for j in jobs], np.int32)
        ys = np.asarray([j[3] for j in jobs], np.int32)
        fxs = np.asarray([j[4] for j in jobs], np.int32)
        fys = np.asarray([j[5] for j in jobs], np.int32)
        if device:
            out = np.asarray(_device_interp(
                frame_ref, pname, xs, ys, fxs, fys, bw, bh, bitdepth,
                luma, hpel))
        else:
            out = jax_mc.interp_14bit_np(
                getattr(frame_ref, pname), xs, ys, fxs, fys, bw, bh, bitdepth,
                luma=luma, hpel=hpel)
        ckey = (pname, bw, bh)
        arrs = cls_out.setdefault(ckey, [])
        base = sum(a.shape[0] for a in arrs)
        arrs.append(out)
        for i, (cu, lst, *_rest) in enumerate(jobs):
            cls_row[(id(cu), pname, lst)] = (ckey, base + i)

    # stage 2: vectorized combine per class (uni/bi/BCW as one weighted form:
    # uni = w0=8,w1=0; plain bi = 4/4; BCW = (8-w)/w — all exact under
    # shift = 14-bd+3, matching ref_mc.mc_uni/mc_bi/mc_bi_weighted)
    shift = 14 - bitdepth + 3
    off = 1 << (shift - 1)
    bd_max = (1 << bitdepth) - 1
    combine: dict = {}  # ckey -> (rows0, rows1, w0s, w1s, dests)
    for cu, inter_dir, lists, do_luma in eligible:
        planes = (("y",) if do_luma else ()) + (("cb", "cr") if chroma else ())
        bcw_p1 = cu.mv0.bcw_idx_plus1 if cu.mv0 is not None else 0
        if inter_dir == 3:
            w1 = _BCW_W[bcw_p1 - 1] if bcw_p1 not in (0, 3) else 4
            w0 = 8 - w1
        else:
            w0, w1 = 8, 0
        for pname in planes:
            ckey, r0 = cls_row[(id(cu), pname, lists[0])]
            r1 = cls_row[(id(cu), pname, lists[1])][1] if inter_dir == 3 else r0
            ent = combine.setdefault(ckey, ([], [], [], [], []))
            ent[0].append(r0)
            ent[1].append(r1)
            ent[2].append(w0)
            ent[3].append(w1)
            ent[4].append((cu, pname))

    for ckey, (rows0, rows1, w0s, w1s, dests) in combine.items():
        allout = np.concatenate(cls_out[ckey]) if len(cls_out[ckey]) > 1 \
            else cls_out[ckey][0]
        p0 = allout[np.asarray(rows0)]
        p1 = allout[np.asarray(rows1)]
        w0a = np.asarray(w0s, np.int32)[:, None, None]
        w1a = np.asarray(w1s, np.int32)[:, None, None]
        v = np.clip((p0 * w0a + p1 * w1a + off) >> shift, 0, bd_max).astype(np.int32)
        for i, (cu, pname) in enumerate(dests):
            if not hasattr(cu, "mc_pre") or cu.mc_pre is None:
                cu.mc_pre = {}
            cu.mc_pre[pname] = v[i]
