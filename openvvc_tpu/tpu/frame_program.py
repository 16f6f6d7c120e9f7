"""The fused per-frame device program: inter MC -> residual add -> intra
wave scans -> deblocking -> SAO -> DPB update, as ONE jitted computation
per picture with no intermediate host transfers.

Host side (build_bundle) packs the dense IR produced by ov_build_ir plus
deblocking segment tables and SAO CTU tables into fixed-shape (pow2-
bucketed) arrays so the whole stream reuses a handful of compiled
programs. Device side (frame_step) is pure functional: takes the DPB
stacks, returns the updated stacks and the output planes. This is the
"one fused jitted program per stage group, output transfers once per
displayed frame" design of SURVEY.md §7.1 (vs the reference's per-CU
dispatch, rcn.c:147-300).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from openvvc_tpu.tpu import intra_wave as iw
from openvvc_tpu.tpu import sao_dense
from openvvc_tpu.tpu.mc_dense import PAD_C, PAD_L, mc_dense

WAVE_B = 32  # jobs per scan step


class Cfg(NamedTuple):
    pic_w: int
    pic_h: int
    uw: int
    uh: int
    bd: int
    chroma: bool
    has_inter: bool
    dbf_on: bool
    sao_on: bool
    ctb_log2: int
    alf_on: bool = False
    entries: tuple = ()   # ((ctu_x, ctu_y, nb_w, nb_h), ...) for ALF
    mip_on: bool = False  # any KIND_MIP job in this picture
    lmcs_on: bool = False
    cclm_on: bool = False  # any KIND_CCLM chroma job
    cclm_colloc: bool = False
    ciip_on: bool = False  # any KIND_CIIP job (deferred-residual units)
    dtu_sig: tuple = ()   # device-residual buckets ((l2w, l2h, N), ...)


def _bucket_pow2(n, lo=0):
    if n <= lo:
        return max(n, lo)
    return 1 << (n - 1).bit_length()


def pack_jobs(arrays, B=WAVE_B):
    """Wave-ordered job tensor (nsteps, J_NFIELDS, B); each wave padded to
    a multiple of B with no-op jobs (mode -1), steps bucketed to pow2."""
    arrays = [a for a in (arrays or []) if a is not None and len(a)]
    if not arrays:
        return np.zeros((0, iw.J_NFIELDS, B), np.int32)
    jobs = np.concatenate(arrays)
    order = np.argsort(jobs[:, iw.J_LEVEL], kind="stable")
    jobs = jobs[order]
    lv = jobs[:, iw.J_LEVEL]
    counts = np.bincount(lv, minlength=int(lv[-1]) + 1)[1:]
    caps = ((counts + B - 1) // B) * B
    total = int(caps.sum())
    nsteps = _bucket_pow2((total + B - 1) // B)
    out = np.zeros((nsteps * B, iw.J_NFIELDS), np.int32)
    out[:, iw.J_MODE] = -1
    offs = np.concatenate([[0], np.cumsum(caps)[:-1]])
    src = 0
    for i, c in enumerate(counts):
        c = int(c)
        if c == 0:
            continue
        out[int(offs[i]):int(offs[i]) + c] = jobs[src:src + c]
        src += c
    return out.reshape(nsteps, B, iw.J_NFIELDS).transpose(0, 2, 1).copy()


def _pad_segments(params):
    from openvvc_tpu.rcn.jax_dbf import _pad_pow2

    p, _ = _pad_pow2(params)
    return dict(p)


def build_dbf_params(maps, offsets, bd, pic_w, pic_h, log2_ctb, chroma,
                     no_x=(), no_y=()):
    """Host: finalized + padded segment tables for all six DBF passes."""
    from openvvc_tpu.rcn.jax_dbf import (chroma_segment_params,
                                         luma_segment_params)

    maps.finalize_inter_bs()
    b_l, t_l, b_cb, t_cb, b_cr, t_cr = offsets
    vp, hp = luma_segment_params(maps, b_l, t_l, bd, pic_w, pic_h, no_x,
                                 no_y, dense=True, log2_ctb=log2_ctb)
    out = {"lv": vp, "lh": hp}
    if chroma:
        for sel, bo, to in (("cb", b_cb, t_cb), ("cr", b_cr, t_cr)):
            vpc, hpc = chroma_segment_params(maps, sel, bo, to, bd, pic_w,
                                             pic_h, log2_ctb, no_x, no_y)
            out[f"{sel}v"] = _pad_segments(vpc)
            out[f"{sel}h"] = _pad_segments(hpc)
    return out


def frame_step(dpb_y, dpb_cb, dpb_cr, slot, arrs, cfg: Cfg):
    """One picture on device. arrs: dict of device arrays (see build_bundle).
    Returns (dpb_y', dpb_cb', dpb_cr', out_y, out_cb, out_cr)."""
    import jax
    import jax.numpy as jnp

    H, W = cfg.pic_h, cfg.pic_w
    uh, uw = cfg.uh, cfg.uw
    H4, W4 = uh * 4, uw * 4
    bd = cfg.bd
    bd_max = (1 << bd) - 1

    if cfg.dtu_sig:
        # device residuals: dequant + LFNST + inverse transform of the
        # shipped raw levels, scattered over the host remainder planes
        # BEFORE any consumer (MC residual add, waves, LMCS deferred add)
        from openvvc_tpu.tpu import resid_dense

        ry, rcb, rcr = resid_dense.apply_dtu(
            jnp, arrs["dtu"], arrs["res_y"],
            arrs.get("res_cb"), arrs.get("res_cr"), bd, cfg.chroma)
        arrs = dict(arrs)
        arrs["res_y"] = ry
        if cfg.chroma:
            arrs["res_cb"] = rcb
            arrs["res_cr"] = rcr

    lmcs = arrs.get("lmcs") if cfg.lmcs_on else None
    pred_cb_d = pred_cr_d = None  # LMCS: chroma residual add deferred
    m2 = None
    if cfg.has_inter:
        pred_y, pred_cb, pred_cr = mc_dense(
            jnp, dpb_y, dpb_cb, dpb_cr, arrs["margs"], bd, uw, uh,
            cfg.chroma)
        if lmcs is not None:
            # inter luma prediction is forward-reshaped before the
            # residual add (rcn_lmcs.c:173; refs live unmapped in the DPB)
            from openvvc_tpu.tpu import lmcs_dense

            pred_y = lmcs_dense.fwd_map(jnp, pred_y, lmcs, bd)
        m = arrs["gmask"] != 0
        m4 = jnp.repeat(jnp.repeat(m, 4, axis=0), 4, axis=1)
        res_y_mc = arrs["res_y"]
        if cfg.ciip_on:
            # CIIP units (gmask bit 1) blend planar intra into the MC
            # result in a wave job BEFORE the residual add: suppress the
            # residual here, the KIND_CIIP job adds it after the blend
            dl = (arrs["gmask"] & 2) != 0
            dl4 = jnp.repeat(jnp.repeat(dl, 4, axis=0), 4, axis=1)
            res_y_mc = jnp.where(dl4, 0, res_y_mc)
        rec_y = jnp.where(
            m4, jnp.clip(pred_y + res_y_mc, 0, bd_max), 0
        ).astype(jnp.int16)
        if cfg.chroma:
            m2 = jnp.repeat(jnp.repeat(m, 2, axis=0), 2, axis=1)
            dc2 = None
            if cfg.ciip_on:
                dc = (arrs["gmask"] & 4) != 0
                dc2 = jnp.repeat(jnp.repeat(dc, 2, axis=0), 2, axis=1)
            if lmcs is not None:
                # chroma residual scaling needs the completed mapped luma:
                # keep the prediction, add after the luma waves
                pred_cb_d, pred_cr_d = pred_cb, pred_cr
                rec_cb = jnp.where(m2, jnp.clip(pred_cb, 0, bd_max), 0) \
                    .astype(jnp.int16)
                rec_cr = jnp.where(m2, jnp.clip(pred_cr, 0, bd_max), 0) \
                    .astype(jnp.int16)
            else:
                res_cb_mc, res_cr_mc = arrs["res_cb"], arrs["res_cr"]
                if dc2 is not None:
                    res_cb_mc = jnp.where(dc2, 0, res_cb_mc)
                    res_cr_mc = jnp.where(dc2, 0, res_cr_mc)
                rec_cb = jnp.where(
                    m2, jnp.clip(pred_cb + res_cb_mc, 0, bd_max), 0
                ).astype(jnp.int16)
                rec_cr = jnp.where(
                    m2, jnp.clip(pred_cr + res_cr_mc, 0, bd_max), 0
                ).astype(jnp.int16)
    else:
        rec_y = jnp.zeros((H4, W4), jnp.int16)
        if cfg.chroma:
            rec_cb = jnp.zeros((uh * 2, uw * 2), jnp.int16)
            rec_cr = jnp.zeros((uh * 2, uw * 2), jnp.int16)

    # intra waves (luma then chroma; chroma depends on chroma only — no
    # CCLM in the device set).  Carries/residuals get a TILE margin so the
    # wave kernel's window fetch/scatter never clamps at the frame edge.
    T = iw.TILE
    mpad = lambda a: jnp.pad(a, ((0, T), (0, T)))
    jobs_l = arrs["jobs_l"]
    if jobs_l.shape[0]:
        res_y = mpad(arrs["res_y"])

        def lbody(plane, jf):
            return iw.predict_wave_step(jnp, plane, res_y, jf, bd, True,
                                        with_mip=cfg.mip_on,
                                        with_ciip=cfg.ciip_on), None

        rec_y, _ = jax.lax.scan(lbody, mpad(rec_y), jobs_l)
    res_cb_eff, res_cr_eff = None, None
    if cfg.chroma:
        res_cb_eff, res_cr_eff = arrs["res_cb"], arrs["res_cr"]
        if lmcs is not None:
            # derive the per-64-block chroma scale from the completed
            # mapped luma, scale the chroma residual planes, and apply
            # the deferred inter residual add
            from openvvc_tpu.tpu import lmcs_dense

            su = lmcs_dense.chroma_scale_units(
                jnp, rec_y[:H, :W].astype(jnp.int32), lmcs, uh, uw, bd)
            res_cb_eff = lmcs_dense.scale_chroma_res(
                jnp, res_cb_eff, su, lmcs["csc"], bd).astype(jnp.int32)
            res_cr_eff = lmcs_dense.scale_chroma_res(
                jnp, res_cr_eff, su, lmcs["csc"], bd).astype(jnp.int32)
            if pred_cb_d is not None:
                res_cb_mc2, res_cr_mc2 = res_cb_eff, res_cr_eff
                if cfg.ciip_on:
                    dc = (arrs["gmask"] & 4) != 0
                    dc2l = jnp.repeat(jnp.repeat(dc, 2, axis=0), 2, axis=1)
                    res_cb_mc2 = jnp.where(dc2l, 0, res_cb_mc2)
                    res_cr_mc2 = jnp.where(dc2l, 0, res_cr_mc2)
                rec_cb = jnp.where(
                    m2, jnp.clip(pred_cb_d + res_cb_mc2, 0, bd_max), 0
                ).astype(jnp.int16)
                rec_cr = jnp.where(
                    m2, jnp.clip(pred_cr_d + res_cr_mc2, 0, bd_max), 0
                ).astype(jnp.int16)
        jobs_c = arrs["jobs_c"]
        if jobs_c.shape[0]:
            res_cb, res_cr = mpad(res_cb_eff), mpad(res_cr_eff)
            luma4 = None
            if cfg.cclm_on:
                # chroma-from-luma reads the completed luma; +4 top/left
                # margin, window-sized bottom/right margin
                luma4 = jnp.pad(rec_y[:H, :W],
                                ((4, 4 * iw.TILE + 16),
                                 (4, 4 * iw.TILE + 16)))

            def cbody(carry, jf):
                cb, cr = carry
                cb = iw.predict_wave_step(jnp, cb, res_cb, jf, bd, False,
                                          with_cclm=cfg.cclm_on,
                                          luma4=luma4,
                                          colloc=cfg.cclm_colloc,
                                          ctb_log2=cfg.ctb_log2,
                                          with_ciip=cfg.ciip_on)
                cr = iw.predict_wave_step(jnp, cr, res_cr, jf, bd, False,
                                          with_cclm=cfg.cclm_on,
                                          luma4=luma4,
                                          colloc=cfg.cclm_colloc,
                                          ctb_log2=cfg.ctb_log2,
                                          with_ciip=cfg.ciip_on)
                return (cb, cr), None

            (rec_cb, rec_cr), _ = jax.lax.scan(cbody,
                                               (mpad(rec_cb), mpad(rec_cr)),
                                               jobs_c)

    y = rec_y[:H, :W].astype(jnp.int32)
    cb = rec_cb[:H >> 1, :W >> 1].astype(jnp.int32) if cfg.chroma else None
    cr = rec_cr[:H >> 1, :W >> 1].astype(jnp.int32) if cfg.chroma else None

    if lmcs is not None:
        # backward reshape before the loop filters (slicedec.c:745-750)
        from openvvc_tpu.tpu import lmcs_dense

        y = lmcs_dense.bwd_map(jnp, y, lmcs, bd)

    if cfg.dbf_on:
        from openvvc_tpu.rcn.jax_dbf import (_apply_pass_chroma,
                                             _apply_pass_dense)

        d = {k: (dict(v, _padded=True) if "xs" in v else v)
             for k, v in arrs["dbf"].items()}
        y = _apply_pass_dense(jnp, y, d["lv"], bd_max, horizontal=False)
        y = _apply_pass_dense(jnp, y, d["lh"], bd_max, horizontal=True)
        if cfg.chroma:
            cb = _apply_pass_chroma(jnp, cb, d["cbv"], bd_max, False)
            cb = _apply_pass_chroma(jnp, cb, d["cbh"], bd_max, True)
            cr = _apply_pass_chroma(jnp, cr, d["crv"], bd_max, False)
            cr = _apply_pass_chroma(jnp, cr, d["crh"], bd_max, True)

    if cfg.sao_on:
        tabs = arrs["sao"]
        y = sao_dense.sao_plane(jnp, y, 0, tabs, cfg.ctb_log2, bd)
        if cfg.chroma:
            cb = sao_dense.sao_plane(jnp, cb, 1, tabs, cfg.ctb_log2, bd)
            cr = sao_dense.sao_plane(jnp, cr, 2, tabs, cfg.ctb_log2, bd)

    if cfg.alf_on:
        from openvvc_tpu.tpu import alf_dense

        atabs = dict(alf_dense.static_row_tabs(H, 1 << cfg.ctb_log2,
                                               cfg.chroma))
        atabs.update(arrs["alf"])
        y, cb, cr = alf_dense.alf_frame(jnp, y, cb, cr, atabs,
                                        cfg.entries, cfg.ctb_log2, bd, W, H)

    out_y = y.astype(jnp.int16)
    pad_y = jnp.pad(out_y, ((PAD_L, PAD_L + H4 - H), (PAD_L, PAD_L + W4 - W)),
                    mode="edge")
    dpb_y = jax.lax.dynamic_update_slice(dpb_y, pad_y[None], (slot, 0, 0))
    # 8-bit output halves the per-frame D2H fetch
    out_t = jnp.uint8 if bd == 8 else jnp.int16
    parts = [out_y.astype(out_t).reshape(-1)]
    if cfg.chroma:
        out_cb = cb.astype(jnp.int16)
        out_cr = cr.astype(jnp.int16)
        H2, W2 = H >> 1, W >> 1
        padc = ((PAD_C, PAD_C + uh * 2 - H2), (PAD_C, PAD_C + uw * 2 - W2))
        dpb_cb = jax.lax.dynamic_update_slice(
            dpb_cb, jnp.pad(out_cb, padc, mode="edge")[None], (slot, 0, 0))
        dpb_cr = jax.lax.dynamic_update_slice(
            dpb_cr, jnp.pad(out_cr, padc, mode="edge")[None], (slot, 0, 0))
        parts += [out_cb.astype(out_t).reshape(-1),
                  out_cr.astype(out_t).reshape(-1)]
    # one packed output buffer -> ONE device-to-host fetch per picture
    return dpb_y, dpb_cb, dpb_cr, jnp.concatenate(parts)


# ---------------------------------------------------------------------------
# argument packing: the arrs tree holds dozens of small numpy leaves, each
# of which would otherwise be its own host-to-device transfer.  Small leaves
# are packed into ONE uint8 blob on the host and unpacked with static
# slices + bitcasts inside the jitted program.
# ---------------------------------------------------------------------------

_BIG = 1 << 18  # leaves >= 256 KiB ship as-is


def pack_arrs(arrs):
    """(blob uint8[1d], bigs tuple, metas static, treedef static)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(arrs)
    metas = []
    parts = []
    bigs = []
    off = 0
    for leaf in leaves:
        leaf = np.ascontiguousarray(leaf)
        if leaf.dtype == np.int64:
            leaf = leaf.astype(np.int32)  # jax x64 is disabled
        if leaf.nbytes >= _BIG:
            metas.append(("big", len(bigs), leaf.shape, leaf.dtype.name))
            bigs.append(leaf)
            continue
        pad = (-off) % 4
        if pad:
            parts.append(np.zeros(pad, np.uint8))
            off += pad
        metas.append(("blob", off, leaf.shape, leaf.dtype.name))
        parts.append(leaf.view(np.uint8).ravel())
        off += leaf.nbytes
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return blob, tuple(bigs), tuple(metas), treedef


def unpack_arrs(blob, bigs, metas, treedef):
    """Device-side inverse of pack_arrs (runs under jit; static offsets)."""
    import jax
    import jax.numpy as jnp

    leaves = []
    for kind, idx, shape, dtype in metas:
        if kind == "big":
            leaves.append(bigs[idx])
            continue
        dt = np.dtype(dtype)
        size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        raw = jax.lax.slice(blob, (idx,), (idx + size,))
        if dtype == "bool":
            arr = raw != 0
        elif dt.itemsize == 1:
            arr = jax.lax.bitcast_convert_type(raw, jnp.dtype(dtype))
        else:
            arr = jax.lax.bitcast_convert_type(
                raw.reshape(-1, dt.itemsize), jnp.dtype(dtype))
        leaves.append(arr.reshape(shape))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _frame_step_packed(dpb_y, dpb_cb, dpb_cr, slot, blob, bigs, metas,
                       treedef, cfg: Cfg):
    arrs = unpack_arrs(blob, bigs, metas, treedef)
    return frame_step(dpb_y, dpb_cb, dpb_cr, slot, arrs, cfg)


_JITTED = None


def run_frame(ddpb, slot, arrs, cfg: Cfg):
    """Dispatch one frame asynchronously; updates ddpb stacks in place.
    Returns the packed output device array."""
    import jax

    global _JITTED
    if _JITTED is None:
        _JITTED = jax.jit(_frame_step_packed,
                          static_argnames=("metas", "treedef", "cfg"),
                          donate_argnums=(0, 1, 2))
    blob, bigs, metas, treedef = pack_arrs(arrs)
    ny, ncb, ncr, packed = _JITTED(ddpb.y, ddpb.cb, ddpb.cr, slot, blob,
                                   bigs, metas, treedef, cfg)
    ddpb.y, ddpb.cb, ddpb.cr = ny, ncb, ncr
    return packed
