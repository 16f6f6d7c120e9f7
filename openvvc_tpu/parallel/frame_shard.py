"""Multi-chip frame reconstruction: the fused per-frame device program
sharded tile-column-per-device over a jax.sharding.Mesh.

Sharding design (SURVEY.md §5.8, the device-side replacement for the
reference's pthread entry parallelism + decoded-CTU condvar bitmask,
ovthreads.c / dpb.c:1222-1361):

- **Reference planes replicated.** MC reads the DPB stacks at MV-dependent
  offsets anywhere in the picture; random-access operands are replicated,
  compute is sharded (the scaling-book recipe).  The per-frame cost is one
  all-gather of the reconstructed bands when the DPB slot is updated.
- **Compute bands = tile columns.**  Each device reconstructs one tile's
  band: inter MC over its unit columns, intra waves over its OWN tile's
  jobs (intra never crosses a tile edge, so bands are dependency-free),
  then the in-loop filters.
- **DBF via ppermute halos.**  Deblocking reads and writes up to 7 samples
  across a vertical band edge; each device exchanges 16-px (8-px chroma)
  recon halos with its neighbours over the mesh axis and *recomputes* the
  boundary edges on the extended band — both owners derive identical
  filtered values from identical inputs, so each keeps its own columns and
  the result is bitwise equal to the single-device pass (no write
  exchange needed).
- **SAO / ALF band-local.**  SAO's entry-border trim (rcn_sao.c:191-239
  seam rules) means edge offsets never read across a tile boundary, and
  ALF is defined per entry with border padding — both shard cleanly with
  per-band table slices.

Bitwise equality with the single-device program is asserted by
tests/test_multichip_frame.py over a multi-frame inter GOP on the virtual
CPU mesh.
"""

from __future__ import annotations

import functools

import numpy as np

from openvvc_tpu.tpu import intra_wave as iw
from openvvc_tpu.tpu import sao_dense
from openvvc_tpu.tpu.mc_dense import PAD_C, PAD_L, mc_dense

HALO_L = 16   # luma px exchanged per side for DBF (edge writes 7, reads 8)
HALO_C = 8    # chroma px
HALO_U = HALO_L // 4   # in 4x4 units


def make_mesh(n_devices):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()[:n_devices]
    return Mesh(np.array(devs), ("t",))


# ----------------------------------------------------------------------
# host-side band input builders
# ----------------------------------------------------------------------


def band_jobs(ir_jobs, entries, n_bands, pic_w, luma):
    """Per-entry wave job arrays -> (T, nsteps, J_NFIELDS, B) with
    band-local x coordinates; entries must be n_bands equal tile columns
    in left-to-right order."""
    from openvvc_tpu.tpu.frame_program import pack_jobs

    assert len(ir_jobs) == n_bands, (len(ir_jobs), n_bands)
    wb = pic_w // n_bands
    packs = []
    for b, jobs in enumerate(ir_jobs):
        a = np.array(jobs)
        off = b * (wb if luma else wb // 2)
        if a.ndim == 2 and len(a):
            a[:, iw.J_X0] -= off
        packs.append(pack_jobs([a]))
    steps = max((p.shape[0] for p in packs), default=0)
    out = np.zeros((n_bands, steps) + packs[0].shape[1:], np.int32)
    out[:, :, iw.J_MODE, :] = -1
    for b, p in enumerate(packs):
        out[b, :p.shape[0]] = p
    return out


def band_chroma_segments(params, n_bands, pic_w, vertical):
    """Split one chroma DBF segment dict by band with band-local xs.

    Vertical-edge segments keep halo edges on both owners (duplicated
    compute => bitwise-equal cross-band writes) and get a +HALO_C offset
    for the extended band; horizontal-edge segments are strictly owned.
    Returns dict of (T, S, ...) arrays."""
    wbc = pic_w // 2 // n_bands
    keys = list(params.keys())
    per = []
    for b in range(n_bands):
        x0 = b * wbc
        if vertical:
            sel = (params["xs"] >= x0 - HALO_C // 2) \
                & (params["xs"] < x0 + wbc + HALO_C // 2)
            off = -x0 + HALO_C
        else:
            sel = (params["xs"] >= x0) & (params["xs"] < x0 + wbc)
            off = -x0
        d = {k: params[k][sel].copy() for k in keys}
        d["xs"] = d["xs"] + off
        per.append(d)
    cap = 1
    nmax = max((len(d["xs"]) for d in per), default=0)
    while cap < max(nmax, 1):
        cap *= 2
    out = {}
    for k in keys:
        shp = (n_bands, cap) + per[0][k].shape[1:]
        arr = np.zeros(shp, per[0][k].dtype)
        for b, d in enumerate(per):
            n = len(d[k])
            arr[b, :n] = d[k]
        out[k] = arr
    return out


def pad_luma_grids(dp, uw_pad=HALO_U):
    """Pre-pad dense luma DBF grids with zero unit-columns so devices can
    dynamic-slice an extended window without bounds games."""
    out = {}
    for k, v in dp.items():
        out[k] = np.pad(v, ((0, 0), (uw_pad, uw_pad)))
    return out


# ----------------------------------------------------------------------
# the sharded device program
# ----------------------------------------------------------------------


def _band_halo(jnp, band, h, T):
    """Extended band [from_left | band | from_right] along axis 1; frame
    borders replicate the band's own edge column (np.pad 'edge' parity)."""
    import jax
    from jax import lax

    b = lax.axis_index("t")
    if T == 1:
        eL = jnp.repeat(band[:, :1], h, axis=1)
        eR = jnp.repeat(band[:, -1:], h, axis=1)
        return jnp.concatenate([eL, band, eR], axis=1)
    right = band[:, -h:]
    left = band[:, :h]
    from_left = lax.ppermute(right, "t", [(i, i + 1) for i in range(T - 1)])
    from_right = lax.ppermute(left, "t", [(i + 1, i) for i in range(T - 1)])
    eL = jnp.repeat(band[:, :1], h, axis=1)
    eR = jnp.repeat(band[:, -1:], h, axis=1)
    from_left = jnp.where(b == 0, eL, from_left)
    from_right = jnp.where(b == T - 1, eR, from_right)
    return jnp.concatenate([from_left, band, from_right], axis=1)


def _slice_cols(jnp, arr, start, width, axis=1):
    import jax

    sizes = list(arr.shape)
    starts = [0] * arr.ndim
    starts[axis] = start
    sizes[axis] = width
    return jax.lax.dynamic_slice(arr, starts, sizes)


def band_dbf_luma(jnp, y, lv_grids, lh_grids, b, ux0, uwb, T, bd_max):
    """Both luma DBF passes on one band.  lv/lh grids are the full-frame
    dense param grids pre-padded by pad_luma_grids; the vertical pass runs
    on the halo-extended band so boundary edges are computed identically
    by both owners."""
    from openvvc_tpu.rcn.jax_dbf import _apply_pass_dense

    ext = _band_halo(jnp, y, HALO_L, T)
    dv = {k: _slice_cols(jnp, v, ux0, uwb + 2 * HALO_U + 1)
          for k, v in lv_grids.items()}
    ext = _apply_pass_dense(jnp, ext, dv, bd_max, horizontal=False)
    y = ext[:, HALO_L:HALO_L + uwb * 4]
    dh = {k: _slice_cols(jnp, v, HALO_U + ux0, uwb)
          for k, v in lh_grids.items()}
    return _apply_pass_dense(jnp, y, dh, bd_max, horizontal=True)


def band_frame_step(dpb_y, dpb_cb, dpb_cr, slot, arrs, jobs_l, jobs_c,
                    cfg, T):
    """One band of one picture (runs under shard_map over mesh axis 't').

    arrs: replicated full-frame numpy-tree (same layout as
    frame_program.frame_step) with DBF luma grids pre-padded by
    pad_luma_grids and chroma segments banded by band_chroma_segments.
    jobs_l/jobs_c: this band's wave tensors.  Returns the band's
    (y, cb, cr) int32 planes."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    b = lax.axis_index("t")
    # shard_map delivers the sharded leading axis as size 1 — squeeze
    jobs_l = jobs_l.reshape(jobs_l.shape[1:])
    jobs_c = jobs_c.reshape(jobs_c.shape[1:])
    H, W = cfg.pic_h, cfg.pic_w
    uh, uw = cfg.uh, cfg.uw
    bd = cfg.bd
    bd_max = (1 << bd) - 1
    uwb = uw // T
    Wb = uwb * 4
    Wbc = uwb * 2
    ux0 = b * uwb

    # ---- LMCS tables for this band (tile-restricted availability keeps
    # the per-64-block chroma-scale derivation band-local) ---------------
    lmcs = arrs.get("lmcs") if getattr(cfg, "lmcs_on", False) else None
    lmcs_b = None
    if lmcs is not None:
        nbx = lmcs["top_abv"].shape[1]
        nbxb = nbx // T
        lmcs_b = dict(lmcs)
        for k in ("top_abv", "top_lft", "nb_zero", "log2_nb"):
            lmcs_b[k] = _slice_cols(jnp, lmcs[k], b * nbxb, nbxb)
        lmcs_b["csc"] = _slice_cols(jnp, lmcs["csc"], b * (Wbc >> 1),
                                    Wbc >> 1)
    ciip_on = getattr(cfg, "ciip_on", False)

    # ---- inter MC + residual add over this band's units ---------------
    pred_cb_d = pred_cr_d = None
    m2 = None
    if cfg.has_inter:
        margs = {}
        for k, v in arrs["margs"].items():
            va = jnp.asarray(v)
            if va.ndim == 3:  # per-sample weight plane (N, 4, 4)
                margs[k] = _slice_cols(
                    jnp, va.reshape(uh, uw, 4, 4), ux0, uwb
                ).reshape(uh * uwb, 4, 4)
            else:
                margs[k] = _slice_cols(jnp, va.reshape(uh, uw),
                                       ux0, uwb).reshape(uh * uwb)
        pred_y, pred_cb, pred_cr = mc_dense(
            jnp, dpb_y, dpb_cb, dpb_cr, margs, bd, uwb, uh, cfg.chroma)
        if lmcs is not None:
            from openvvc_tpu.tpu import lmcs_dense

            pred_y = lmcs_dense.fwd_map(jnp, pred_y, lmcs_b, bd)
        gm = _slice_cols(jnp, arrs["gmask"], ux0, uwb)
        m = gm != 0
        res_y = _slice_cols(jnp, arrs["res_y"], b * Wb, Wb)
        res_y_mc = res_y
        if ciip_on:
            dl4 = jnp.repeat(jnp.repeat((gm & 2) != 0, 4, axis=0), 4,
                             axis=1)
            res_y_mc = jnp.where(dl4, 0, res_y_mc)
        m4 = jnp.repeat(jnp.repeat(m, 4, axis=0), 4, axis=1)
        rec_y = jnp.where(m4, jnp.clip(pred_y + res_y_mc, 0, bd_max), 0) \
            .astype(jnp.int16)
        if cfg.chroma:
            res_cb = _slice_cols(jnp, arrs["res_cb"], b * Wbc, Wbc)
            res_cr = _slice_cols(jnp, arrs["res_cr"], b * Wbc, Wbc)
            m2 = jnp.repeat(jnp.repeat(m, 2, axis=0), 2, axis=1)
            dc2 = None
            if ciip_on:
                dc2 = jnp.repeat(jnp.repeat((gm & 4) != 0, 2, axis=0), 2,
                                 axis=1)
            if lmcs is not None:
                # chroma residual add deferred until the mapped luma band
                # completes (frame_program.frame_step order)
                pred_cb_d, pred_cr_d = pred_cb, pred_cr
                rec_cb = jnp.where(m2, jnp.clip(pred_cb, 0, bd_max), 0) \
                    .astype(jnp.int16)
                rec_cr = jnp.where(m2, jnp.clip(pred_cr, 0, bd_max), 0) \
                    .astype(jnp.int16)
            else:
                res_cb_mc, res_cr_mc = res_cb, res_cr
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
        res_y = _slice_cols(jnp, arrs["res_y"], b * Wb, Wb)
        rec_y = jnp.zeros((uh * 4, Wb), jnp.int16)
        if cfg.chroma:
            res_cb = _slice_cols(jnp, arrs["res_cb"], b * Wbc, Wbc)
            res_cr = _slice_cols(jnp, arrs["res_cr"], b * Wbc, Wbc)
            rec_cb = jnp.zeros((uh * 2, Wbc), jnp.int16)
            rec_cr = jnp.zeros((uh * 2, Wbc), jnp.int16)

    # ---- intra waves over this band's tile -----------------------------
    Tm = iw.TILE
    mpad = lambda a: jnp.pad(a, ((0, Tm), (0, Tm)))
    if jobs_l.shape[0]:
        res_yp = mpad(res_y)

        def lbody(plane, jf):
            return iw.predict_wave_step(jnp, plane, res_yp, jf, bd, True,
                                        with_mip=getattr(cfg, "mip_on",
                                                         False),
                                        with_ciip=ciip_on), None

        rec_y, _ = lax.scan(lbody, mpad(rec_y), jobs_l)
        rec_y = rec_y[:uh * 4, :Wb]
    res_cb_eff = res_cr_eff = None
    if cfg.chroma:
        res_cb_eff, res_cr_eff = res_cb, res_cr
        if lmcs is not None:
            from openvvc_tpu.tpu import lmcs_dense

            su = lmcs_dense.chroma_scale_units(
                jnp, rec_y[:H, :].astype(jnp.int32), lmcs_b, uh, uwb, bd)
            res_cb_eff = lmcs_dense.scale_chroma_res(
                jnp, res_cb_eff, su, lmcs_b["csc"], bd).astype(jnp.int32)
            res_cr_eff = lmcs_dense.scale_chroma_res(
                jnp, res_cr_eff, su, lmcs_b["csc"], bd).astype(jnp.int32)
            if pred_cb_d is not None:
                res_cb_mc2, res_cr_mc2 = res_cb_eff, res_cr_eff
                if ciip_on:
                    dc2l = jnp.repeat(jnp.repeat((gm & 4) != 0, 2, axis=0),
                                      2, axis=1)
                    res_cb_mc2 = jnp.where(dc2l, 0, res_cb_mc2)
                    res_cr_mc2 = jnp.where(dc2l, 0, res_cr_mc2)
                rec_cb = jnp.where(
                    m2, jnp.clip(pred_cb_d + res_cb_mc2, 0, bd_max), 0
                ).astype(jnp.int16)
                rec_cr = jnp.where(
                    m2, jnp.clip(pred_cr_d + res_cr_mc2, 0, bd_max), 0
                ).astype(jnp.int16)
        if jobs_c.shape[0]:
            res_cbp, res_crp = mpad(res_cb_eff), mpad(res_cr_eff)
            luma4 = None
            cclm_on = getattr(cfg, "cclm_on", False)
            if cclm_on:
                luma4 = jnp.pad(rec_y[:H, :],
                                ((4, 4 * iw.TILE + 16),
                                 (4, 4 * iw.TILE + 16)))

            def cbody(carry, jf):
                cb_, cr_ = carry
                cb_ = iw.predict_wave_step(
                    jnp, cb_, res_cbp, jf, bd, False, with_cclm=cclm_on,
                    luma4=luma4, colloc=getattr(cfg, "cclm_colloc", False),
                    ctb_log2=cfg.ctb_log2, with_ciip=ciip_on)
                cr_ = iw.predict_wave_step(
                    jnp, cr_, res_crp, jf, bd, False, with_cclm=cclm_on,
                    luma4=luma4, colloc=getattr(cfg, "cclm_colloc", False),
                    ctb_log2=cfg.ctb_log2, with_ciip=ciip_on)
                return (cb_, cr_), None

            (rec_cb, rec_cr), _ = lax.scan(
                cbody, (mpad(rec_cb), mpad(rec_cr)), jobs_c)
            rec_cb = rec_cb[:uh * 2, :Wbc]
            rec_cr = rec_cr[:uh * 2, :Wbc]

    y = rec_y[:H, :].astype(jnp.int32)
    cb = rec_cb[:H >> 1, :].astype(jnp.int32) if cfg.chroma else None
    cr = rec_cr[:H >> 1, :].astype(jnp.int32) if cfg.chroma else None

    if lmcs is not None:
        from openvvc_tpu.tpu import lmcs_dense

        y = lmcs_dense.bwd_map(jnp, y, lmcs_b, bd)

    # ---- DBF with ppermute halos ---------------------------------------
    if cfg.dbf_on:
        d = arrs["dbf"]
        y = band_dbf_luma(jnp, y, d["lv"], d["lh"], b, ux0, uwb, T, bd_max)
        if cfg.chroma:
            from openvvc_tpu.rcn.jax_dbf import _apply_pass_chroma

            for sel, pl in (("cb", "cb"), ("cr", "cr")):
                plane = cb if sel == "cb" else cr
                extc = _band_halo(jnp, plane, HALO_C, T)
                pv = {k: v[b] for k, v in d[f"{sel}v"].items()}
                extc = _apply_pass_chroma(jnp, extc, dict(pv, _padded=True),
                                          bd_max, False)
                plane = extc[:, HALO_C:HALO_C + Wbc]
                ph = {k: v[b] for k, v in d[f"{sel}h"].items()}
                # horizontal chroma edges never cross a vertical band
                # boundary; xs are band-local already
                plane = _apply_pass_chroma(jnp, plane,
                                           dict(ph, _padded=True),
                                           bd_max, True)
                if sel == "cb":
                    cb = plane
                else:
                    cr = plane

    # ---- SAO (band-local: entry-border trim kills cross-tile reads) ----
    if cfg.sao_on:
        tabs = arrs["sao"]
        ncw = tabs["typ"].shape[2]
        ncb = ncw // T
        bt = {}
        for k in ("typ", "band4", "bandpos", "edge", "eo"):
            bt[k] = _slice_cols(jnp, tabs[k], b * ncb, ncb, axis=2)
        for c in range(3 if cfg.chroma else 1):
            sh = 0 if c == 0 else 1
            bt[f"colm{c}"] = _slice_cols(
                jnp, tabs[f"colm{c}"][None], b * (Wb >> sh), Wb >> sh)[0]
            bt[f"rowm{c}"] = tabs[f"rowm{c}"]
        y = sao_dense.sao_plane(jnp, y, 0, bt, cfg.ctb_log2, bd)
        if cfg.chroma:
            cb = sao_dense.sao_plane(jnp, cb, 1, bt, cfg.ctb_log2, bd)
            cr = sao_dense.sao_plane(jnp, cr, 2, bt, cfg.ctb_log2, bd)

    # ---- ALF (per-entry == per-band) -----------------------------------
    if cfg.alf_on:
        from openvvc_tpu.tpu import alf_dense

        atabs = dict(alf_dense.static_row_tabs(H, 1 << cfg.ctb_log2,
                                               cfg.chroma))
        tr = arrs["alf"]
        ncw = tr["luma_on"].shape[1]
        ncb = ncw // T
        atabs["luma_on"] = _slice_cols(jnp, tr["luma_on"], b * ncb, ncb)
        atabs["slot"] = _slice_cols(jnp, tr["slot"], b * ncb, ncb)
        atabs["sets"] = tr["sets"]
        atabs["c_on"] = _slice_cols(jnp, tr["c_on"], b * ncb, ncb, axis=2)
        atabs["c_coef"] = _slice_cols(jnp, tr["c_coef"], b * ncb, ncb,
                                      axis=2)
        atabs["cc_coef"] = _slice_cols(jnp, tr["cc_coef"], b * ncb, ncb,
                                       axis=2)
        nbh = -(-H // (1 << cfg.ctb_log2))
        y, cb, cr = alf_dense.alf_frame(jnp, y, cb, cr, atabs,
                                        ((0, 0, ncb, nbh),),
                                        cfg.ctb_log2, bd, Wb, H)

    if not cfg.chroma:
        cb = cr = jnp.zeros((1, 1), jnp.int32)
    return y, cb, cr


def run_frame_sharded(mesh, ddpb, slot, arrs, jobs_l_bands, jobs_c_bands,
                      cfg):
    """Sharded analog of frame_program.run_frame.  Returns the packed
    output (full frame, replicated) and updates the replicated DPB stacks
    in place."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    T = mesh.devices.size
    H, W = cfg.pic_h, cfg.pic_w
    uh, uw = cfg.uh, cfg.uw

    @functools.partial(jax.jit, static_argnames=("cfg",),
                       donate_argnums=(0, 1, 2))
    def step(dpb_y, dpb_cb, dpb_cr, slot, arrs, jobs_l, jobs_c, cfg):
        fn = functools.partial(band_frame_step, cfg=cfg, T=T)
        rep = P()
        y, cb, cr = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(rep, rep, rep, rep, rep, P("t"), P("t")),
            out_specs=(P(None, "t"), P(None, "t"), P(None, "t")),
            check_vma=False,
        )(dpb_y, dpb_cb, dpb_cr, slot, arrs, jobs_l, jobs_c)
        # gather bands (XLA inserts the all-gather) and update the
        # replicated DPB slot
        y = jax.lax.with_sharding_constraint(
            y, NamedSharding(mesh, P()))
        out_y = y.astype(jnp.int16)
        H4, W4 = uh * 4, uw * 4
        pad_y = jnp.pad(out_y,
                        ((PAD_L, PAD_L + H4 - H), (PAD_L, PAD_L + W4 - W)),
                        mode="edge")
        dpb_y = jax.lax.dynamic_update_slice(dpb_y, pad_y[None],
                                             (slot, 0, 0))
        out_t = jnp.uint8 if cfg.bd == 8 else jnp.int16
        parts = [out_y.astype(out_t).reshape(-1)]
        if cfg.chroma:
            cb2 = jax.lax.with_sharding_constraint(
                cb, NamedSharding(mesh, P()))
            cr2 = jax.lax.with_sharding_constraint(
                cr, NamedSharding(mesh, P()))
            out_cb = cb2.astype(jnp.int16)
            out_cr = cr2.astype(jnp.int16)
            H2, W2 = H >> 1, W >> 1
            padc = ((PAD_C, PAD_C + uh * 2 - H2),
                    (PAD_C, PAD_C + uw * 2 - W2))
            dpb_cb = jax.lax.dynamic_update_slice(
                dpb_cb, jnp.pad(out_cb, padc, mode="edge")[None],
                (slot, 0, 0))
            dpb_cr = jax.lax.dynamic_update_slice(
                dpb_cr, jnp.pad(out_cr, padc, mode="edge")[None],
                (slot, 0, 0))
            parts += [out_cb.astype(out_t).reshape(-1),
                      out_cr.astype(out_t).reshape(-1)]
        return dpb_y, dpb_cb, dpb_cr, jnp.concatenate(parts)

    ny, ncb, ncr, packed = step(ddpb.y, ddpb.cb, ddpb.cr, slot, arrs,
                                jobs_l_bands, jobs_c_bands, cfg)
    ddpb.y, ddpb.cb, ddpb.cr = ny, ncb, ncr
    return packed
