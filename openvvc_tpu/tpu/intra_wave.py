"""Branchless on-device intra prediction for wave-scheduled job batches.

One "job" is an intra TU unit (or a 32x32 sub-tile of a larger one): the
host IR builder (native/recon.c ov_build_ir) emits per-job geometry, the
intra mode, and availability extents captured at decode order; jobs are
grouped into dependency waves. The kernel below predicts a whole batch of
jobs from the in-progress reconstruction plane — reference construction
(availability substitution + padding), [1 2 1] smoothing, negative-mode
projection, planar/DC/angular cores, and every PDPC variant — as masked
integer math with no per-job control flow, then adds the residual plane
and scatters the clipped samples back. Bit-exact vs rcn/ref_intra.py
(itself oracle-validated against /root/reference/libovvc/rcn_intra.c:484,
rcn_fill_ref.c:71-592, rcn_intra_angular.c, rcn_intra_dc_planar.c).

Why this shape: intra has a serial neighbour dependency, so the frame
program runs lax.scan over waves with the picture plane as carry; each
scan step calls predict_wave_step on a fixed-size job batch. All shapes
are static; per-job sizes/modes are data.
"""

from __future__ import annotations

import numpy as np

# job record layout (must match ov_build_ir in native/recon.c)
(J_X0, J_Y0, J_L2W, J_L2H, J_OX, J_OY, J_MODE, J_CORNER, J_ABOVE, J_LEFT,
 J_NAVA, J_NAVL, J_LEVEL, J_KIND, J_AUX0, J_AUX1) = range(16)
J_NFIELDS = 16

KIND_INTRA = 0
KIND_IBC = 1
KIND_CIIP = 2
KIND_MIP = 3
KIND_CCLM = 4

# lane budgets: luma TUs are <= 64 wide so the reference line holds
# indices 0..2*64+8 (=136) plus 3 tap lookahead; negative projections
# reach -(n_proj) >= -64. Chroma TBs are <= 32.
LT_L, NEG_L = 140, 72
LT_C, NEG_C = 76, 40
TILE = 32

_THR = (24, 24, 24, 14, 2, 0, 0, 0)


def _tables(jnp):
    from openvvc_tpu.rcn.data_angular import (ANGLE_TABLE, CUBIC_FILTER,
                                              INVERSE_ANGLE_TABLE)

    return (jnp.asarray(np.asarray(ANGLE_TABLE, np.int32)),
            jnp.asarray(np.asarray(INVERSE_ANGLE_TABLE, np.int32)),
            jnp.asarray(np.asarray(CUBIC_FILTER, np.int32)),
            jnp.asarray(np.asarray(_THR, np.int32)))


def _gat(plane, y, x):
    """plane[y, x] with edge clamp (values of clamped lanes are masked)."""
    H, W = plane.shape
    import jax.numpy as jnp

    return plane[jnp.clip(y, 0, H - 1), jnp.clip(x, 0, W - 1)].astype(jnp.int32)


def _fill_sides(jnp, plane, x0, y0, corner_ok, above_ok, left_ok,
                nava, navl, avg, LT):
    """(ref_above, ref_left) lanes [B, LT]; lane k == ref[k] of RefArrays.

    Mirrors ref_intra.fill_side_refs: available run copied, clamped-index
    gather reproduces the trailing pad (pad value == ref[n_avail]) and the
    +8 wide-angle extension in one expression.
    """
    k = jnp.arange(LT, dtype=jnp.int32)[None, :]
    c = lambda v: v[:, None]

    corner_a = jnp.where(c(corner_ok) > 0,
                         _gat(plane, c(y0 - 1), c(x0 - 1)),
                         _gat(plane, c(y0 - 1), c(x0)))
    kk_a = jnp.clip(k, 1, jnp.maximum(c(nava), 1))
    run_a = _gat(plane, c(y0 - 1), c(x0 - 1) + kk_a)
    ok_a = jnp.where(k == 0, corner_a, run_a)
    fb_a = jnp.where(c(left_ok) > 0, _gat(plane, c(y0), c(x0 - 1)), avg)
    ra = jnp.where(c(above_ok) > 0, ok_a, fb_a)

    corner_l = jnp.where(c(corner_ok) > 0,
                         _gat(plane, c(y0 - 1), c(x0 - 1)),
                         _gat(plane, c(y0), c(x0 - 1)))
    kk_l = jnp.clip(k, 1, jnp.maximum(c(navl), 1))
    run_l = _gat(plane, c(y0 - 1) + kk_l, c(x0 - 1))
    ok_l = jnp.where(k == 0, corner_l, run_l)
    fb_l = jnp.where(c(above_ok) > 0, _gat(plane, c(y0 - 1), c(x0)), avg)
    rl = jnp.where(c(left_ok) > 0, ok_l, fb_l)
    return ra, rl


def _smooth(jnp, ref, other, length):
    """[1 2 1] smoothing (ref_intra.filter_ref_array parity), length per job."""
    k = jnp.arange(ref.shape[1], dtype=jnp.int32)[None, :]
    r_m1 = jnp.concatenate([ref[:, :1], ref[:, :-1]], axis=1)
    r_p1 = jnp.concatenate([ref[:, 1:], ref[:, -1:]], axis=1)
    mid = (r_m1 + 2 * ref + r_p1 + 2) >> 2
    at0 = (other[:, 1:2] + 2 * ref[:, 0:1] + ref[:, 1:2] + 2) >> 2
    out = jnp.where(k == 0, at0, jnp.where(k < length[:, None], mid, ref))
    return out


_MIP_ROM = None


def _mip_rom():
    """Stacked zero-padded MIP weight ROM (30, 64, 8) int32: rows 0-15 =
    4x4 class, 16-23 = small class, 24-29 = large class."""
    global _MIP_ROM
    if _MIP_ROM is None:
        from openvvc_tpu.rcn.data_mip import MIP_W4, MIP_W8, MIP_W16

        rom = np.zeros((30, 64, 8), np.int32)
        w4 = np.frombuffer(MIP_W4, np.uint8).reshape(16, 16, 4)
        w8 = np.frombuffer(MIP_W8, np.uint8).reshape(8, 16, 8)
        w16 = np.frombuffer(MIP_W16, np.uint8).reshape(6, 64, 8)
        rom[0:16, :16, :4] = w4
        rom[16:24, :16, :] = w8
        rom[24:30, :, :] = w16
        _MIP_ROM = rom
    return _MIP_ROM


def _predict_mip_batch(jnp, ra, rl, l2w, l2h, mip_mode, transpose, w, h,
                       bitdepth, bd_max, T):
    """Batched MIP prediction (ref_mip.predict_mip parity) over (B, T, T)
    tiles; rcn_intra_mip.c:63-330.  ra/rl: the UNFILTERED reference lanes
    from _fill_sides (lane k == ref[k])."""
    B = ra.shape[0]
    rom = jnp.asarray(_mip_rom())
    kk = jnp.arange(ra.shape[1], dtype=jnp.int32)[None, :]

    # boundary segment averages via masked cumsum + 2 gathers per slot
    log2_bndy = 1 + ((l2w > 2) | (l2h > 2)).astype(jnp.int32)
    n_bndy = 1 << log2_bndy
    sh_a = l2w - log2_bndy          # log2 segment length (above)
    sh_l = l2h - log2_bndy
    cs_a = jnp.cumsum(jnp.where((kk >= 1) & (kk <= w[:, None]), ra, 0),
                      axis=1)
    cs_l = jnp.cumsum(jnp.where((kk >= 1) & (kk <= h[:, None]), rl, 0),
                      axis=1)
    i4 = jnp.arange(4, dtype=jnp.int32)[None, :]
    seg_a = (w >> jnp.maximum(log2_bndy, 0))[:, None]
    seg_l = (h >> jnp.maximum(log2_bndy, 0))[:, None]
    hi_a = jnp.clip((i4 + 1) * seg_a, 0, ra.shape[1] - 1)
    lo_a = jnp.clip(i4 * seg_a, 0, ra.shape[1] - 1)
    sum_a = (jnp.take_along_axis(cs_a, hi_a, 1)
             - jnp.take_along_axis(cs_a, lo_a, 1))
    a_avg = (sum_a + (seg_a >> 1)) >> jnp.maximum(sh_a, 0)[:, None]
    hi_l = jnp.clip((i4 + 1) * seg_l, 0, rl.shape[1] - 1)
    lo_l = jnp.clip(i4 * seg_l, 0, rl.shape[1] - 1)
    sum_l = (jnp.take_along_axis(cs_l, hi_l, 1)
             - jnp.take_along_axis(cs_l, lo_l, 1))
    l_avg = (sum_l + (seg_l >> 1)) >> jnp.maximum(sh_l, 0)[:, None]

    first = jnp.where(transpose[:, None] > 0, l_avg, a_avg)   # (B, 4)
    second = jnp.where(transpose[:, None] > 0, a_avg, l_avg)
    # layout [first(n_bndy), second(n_bndy)] in an 8-lane vector
    i8 = jnp.arange(8, dtype=jnp.int32)[None, :]
    nb = n_bndy[:, None]
    from_first = i8 < nb
    idx_f = jnp.clip(i8, 0, 3)
    idx_s = jnp.clip(i8 - nb, 0, 3)
    bndy = jnp.where(from_first,
                     jnp.take_along_axis(first, idx_f, 1),
                     jnp.take_along_axis(second, idx_s, 1))
    lane_ok = i8 < 2 * nb
    bndy = jnp.where(lane_ok, bndy, 0)

    size_cls = jnp.where((l2w == 2) & (l2h == 2), 0,
                         jnp.where((l2w == 2) | (l2h == 2)
                                   | ((l2w <= 3) & (l2h <= 3)), 1, 2))
    input_offset = bndy[:, 0:1]
    bndy = jnp.where((i8 == 0) & (size_cls[:, None] < 2),
                     1 << (bitdepth - 1), bndy)
    bndy = jnp.where(lane_ok, bndy - input_offset, 0)
    rnd_mip = 32 - 32 * jnp.sum(bndy, axis=1)                 # (B,)

    cls_off = jnp.asarray(np.asarray([0, 16, 24], np.int32))[size_cls]
    mat = jnp.take(rom, cls_off + mip_mode, axis=0)           # (B, 64, 8)
    acc = jnp.sum(mat * bndy[:, None, :], axis=2)             # (B, 64)
    vals = jnp.clip(((acc + rnd_mip[:, None]) >> 6)
                    + input_offset, 0, bd_max)

    log2_red = jnp.where(size_cls < 2, 2, 3)
    n_red = 1 << log2_red
    r8 = jnp.arange(8, dtype=jnp.int32)
    rr = r8[None, :, None]
    cc = r8[None, None, :]
    ridx = (rr * n_red[:, None, None] + cc).reshape(B, 64)
    red = jnp.take_along_axis(vals, jnp.clip(ridx, 0, 63), 1) \
        .reshape(B, 8, 8)
    red = jnp.where(transpose[:, None, None] > 0,
                    red.transpose(0, 2, 1), red)

    # upsampling (up_sample parity); scale 0 reduces to a copy
    sx = jnp.maximum(l2w - log2_red, 0)
    sy = jnp.maximum(l2h - log2_red, 0)
    xg = jnp.arange(T, dtype=jnp.int32)[None, None, :]        # (1, 1, T)
    n_x = (1 << sx)[:, None, None]
    i_x = xg >> sx[:, None, None]
    p_x = (xg & (n_x - 1)) + 1
    cur_x = jnp.take_along_axis(
        red, jnp.broadcast_to(jnp.clip(i_x, 0, 7), (B, 8, T)), 2)
    prev_x = jnp.take_along_axis(
        red, jnp.broadcast_to(jnp.clip(i_x - 1, 0, 7), (B, 8, T)), 2)
    # before for i==0: left sample of the FINAL row of reduced row j
    j8 = jnp.arange(8, dtype=jnp.int32)[None, :]
    lidx = jnp.clip((j8 + 1) << sy[:, None], 0, rl.shape[1] - 1)
    before_row = jnp.take_along_axis(rl, lidx, 1)[:, :, None]  # (B, 8, 1)
    before_x = jnp.where(i_x == 0, before_row, prev_x)
    rows = (before_x * (n_x - p_x) + cur_x * p_x
            + (n_x >> 1)) >> sx[:, None, None]                # (B, 8, T)

    yg = jnp.arange(T, dtype=jnp.int32)[None, :, None]        # (1, T, 1)
    n_y = (1 << sy)[:, None, None]
    j_y = yg >> sy[:, None, None]
    p_y = (yg & (n_y - 1)) + 1
    cur_y = jnp.take_along_axis(
        rows, jnp.broadcast_to(jnp.clip(j_y, 0, 7), (B, T, T)), 1)
    prev_y = jnp.take_along_axis(
        rows, jnp.broadcast_to(jnp.clip(j_y - 1, 0, 7), (B, T, T)), 1)
    aidx = jnp.clip(1 + jnp.arange(T, dtype=jnp.int32)[None, :], 0,
                    ra.shape[1] - 1)
    before_col = jnp.take_along_axis(ra, aidx, 1)[:, None, :]  # (B, 1, T)
    before_y = jnp.where(j_y == 0, before_col, prev_y)
    out = (before_y * (n_y - p_y) + cur_y * p_y
           + (n_y >> 1)) >> sy[:, None, None]                 # (B, T, T)
    return out


_CCLM_DIV = (0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0)


def _predict_cclm_batch(jnp, plane, luma4, jf, bitdepth, bd_max, T,
                        colloc, ctb_log2):
    """Batched CCLM/MDLM chroma prediction (ref_cclm.predict_cclm parity;
    rcn_intra_cclm.c:71-520) over (B, T, T) tiles.

    plane: the chroma carry (for boundary chroma samples).  luma4: the
    COMPLETED luma plane padded by 4 on top/left (so luma coord (lx, ly)
    relative to the block maps to luma4[2*cy0 + ly + 4, 2*cx0 + lx + 4])
    and by >= 4*T + 8 on bottom/right.  Per-job fields: J_AUX0 = mode
    (81..83), J_AUX1 = probed available run (T/L modes)."""
    import jax
    from jax import lax

    B = jf.shape[1]
    cx0, cy0 = jf[J_X0], jf[J_Y0]
    l2w, l2h = jf[J_L2W], jf[J_L2H]
    pw, ph = 1 << l2w, 1 << l2h
    mode = jf[J_AUX0]
    nav = jf[J_AUX1]
    abv = jf[J_ABOVE] > 0
    lft = jf[J_LEFT] > 0
    avg = 1 << (bitdepth - 1)
    first_line = ((cy0 << 1) & ((1 << ctb_log2) - 1)) == 0

    # per-job windows: luma (2T+12, 4T+12) from (2*cy0-4, 2*cx0-4) in
    # padded coords = (2*cy0, 2*cx0); chroma (T+6, 2T+6) from
    # (cy0-4, cx0-4) on a 4-padded copy of the chroma plane
    LWH, LWW = 2 * T + 12, 4 * T + 12
    CWH, CWW = T + 6, 2 * T + 6

    def lwin(y, x):
        return lax.dynamic_slice(luma4, (y, x), (LWH, LWW))

    LW = jax.vmap(lwin)(2 * cy0, 2 * cx0).astype(jnp.int32)
    cpad = jnp.pad(plane, ((4, CWH), (4, CWW)))

    def cwin(y, x):
        return lax.dynamic_slice(cpad, (y, x), (CWH, CWW))

    CW = jax.vmap(cwin)(cy0, cx0).astype(jnp.int32)

    def ly(lx_, ly_):
        # LW[b, 4 + ly, 4 + lx] with per-slot vectors (B, S)
        idx = (4 + ly_) * LWW + (4 + lx_)
        return jnp.take_along_axis(LW.reshape(B, -1),
                                   jnp.clip(idx, 0, LWH * LWW - 1), 1)

    def cv(cx_, cy_):
        idx = (4 + cy_) * CWW + (4 + cx_)
        return jnp.take_along_axis(CW.reshape(B, -1),
                                   jnp.clip(idx, 0, CWH * CWW - 1), 1)

    i4 = jnp.arange(4, dtype=jnp.int32)[None, :]

    # ---- boundary candidate samples (4 above + 4 left slots) ------------
    l2_abv = jnp.where(abv, 1, 0) + jnp.where(lft, 0, 1)
    l2_lft = jnp.where(lft, 1, 0) + jnp.where(abv, 0, 1)
    is_t = mode == 83
    is_l = mode == 82
    alen = nav << 1
    n_abv = jnp.where(is_t, jnp.minimum(alen, 4),
                      jnp.where(is_l, 0,
                                jnp.where(abv, jnp.minimum(pw, l2_abv << 1),
                                          0)))
    n_lft = jnp.where(is_l, jnp.minimum(alen, 4),
                      jnp.where(is_t, 0,
                                jnp.where(lft, jnp.minimum(ph, l2_lft << 1),
                                          0)))
    step_a = jnp.where(is_t, jnp.maximum(1, alen >> 2),
                       jnp.maximum(1, pw >> l2_abv))
    step_l = jnp.where(is_l, jnp.maximum(1, alen >> 2),
                       jnp.maximum(1, ph >> l2_lft))

    sa = (step_a[:, None] >> 1) + i4 * step_a[:, None]   # chroma x slots
    sl = (step_l[:, None] >> 1) + i4 * step_l[:, None]
    lxa = sa << 1
    lya = sl << 1
    pad_a = jnp.where(((step_a[:, None] >> 1) == 0) & (i4 == 0)
                      & ~lft[:, None], 0, 1)
    pad_l0 = jnp.where(((step_l[:, None] >> 1) == 0) & (i4 == 0)
                       & ~abv[:, None], 0, 1)

    if colloc:
        abv_y_in = (4 + ly(lxa, jnp.full_like(lxa, -3))
                    + ly(lxa - pad_a, jnp.full_like(lxa, -2))
                    + 4 * ly(lxa, jnp.full_like(lxa, -2))
                    + ly(lxa + 1, jnp.full_like(lxa, -2))
                    + ly(lxa, jnp.full_like(lxa, -1))) >> 3
        lft_y = (4 + ly(jnp.full_like(lya, -2), lya - pad_l0)
                 + 4 * ly(jnp.full_like(lya, -2), lya)
                 + ly(jnp.full_like(lya, -3), lya)
                 + ly(jnp.full_like(lya, -1), lya)
                 + ly(jnp.full_like(lya, -2), lya + 1)) >> 3
    else:
        abv_y_in = (4 + ly(lxa - pad_a, jnp.full_like(lxa, -2))
                    + 2 * ly(lxa, jnp.full_like(lxa, -2))
                    + ly(lxa + 1, jnp.full_like(lxa, -2))
                    + ly(lxa - pad_a, jnp.full_like(lxa, -1))
                    + 2 * ly(lxa, jnp.full_like(lxa, -1))
                    + ly(lxa + 1, jnp.full_like(lxa, -1))) >> 3
        lft_y = (4 + 2 * ly(jnp.full_like(lya, -2), lya)
                 + ly(jnp.full_like(lya, -1), lya)
                 + ly(jnp.full_like(lya, -3), lya)
                 + 2 * ly(jnp.full_like(lya, -2), lya + 1)
                 + ly(jnp.full_like(lya, -1), lya + 1)
                 + ly(jnp.full_like(lya, -3), lya + 1)) >> 3
    # CTU first line above: single-row (1,2,1) filter
    abv_y_fl = (2 + ly(lxa - pad_a, jnp.full_like(lxa, -1))
                + 2 * ly(lxa, jnp.full_like(lxa, -1))
                + ly(lxa + 1, jnp.full_like(lxa, -1))) >> 2
    abv_y = jnp.where(first_line[:, None], abv_y_fl, abv_y_in)
    abv_c = cv(sa, jnp.full_like(sa, -1))
    lft_c = cv(jnp.full_like(sl, -1), sl)

    # ---- pack into 4 lanes: above run then left run ---------------------
    na = n_abv[:, None]
    from_abv = i4 < na
    idx_a = jnp.clip(i4, 0, 3)
    idx_l = jnp.clip(i4 - na, 0, 3)
    smp_y = jnp.where(from_abv,
                      jnp.take_along_axis(abv_y, idx_a, 1),
                      jnp.take_along_axis(lft_y, idx_l, 1))
    smp_c = jnp.where(from_abv,
                      jnp.take_along_axis(abv_c, idx_a, 1),
                      jnp.take_along_axis(lft_c, idx_l, 1))
    nsmp = n_abv + n_lft

    # ---- min/max (2- or 4-sample forms, _sort_average parity) -----------
    y0_, y1_, y2_, y3_ = (smp_y[:, k] for k in range(4))
    c0_, c1_, c2_, c3_ = (smp_c[:, k] for k in range(4))
    # n == 2
    swap2 = y0_ >= y1_
    mn_l2 = jnp.where(swap2, y1_, y0_)
    mx_l2 = jnp.where(swap2, y0_, y1_)
    mn_c2 = jnp.where(swap2, c1_, c0_)
    mx_c2 = jnp.where(swap2, c0_, c1_)
    # n == 4 sorting network on indices {0,2},{1,3} then cross
    sw_a = y0_ > y2_
    lo0 = jnp.where(sw_a, 2, 0)
    lo1 = jnp.where(sw_a, 0, 2)
    sw_b = y1_ > y3_
    hi0 = jnp.where(sw_b, 3, 1)
    hi1 = jnp.where(sw_b, 1, 3)
    gy = lambda ii: jnp.take_along_axis(smp_y, ii[:, None], 1)[:, 0]
    gc = lambda ii: jnp.take_along_axis(smp_c, ii[:, None], 1)[:, 0]
    sw_c = gy(lo0) > gy(hi1)
    lo0b = jnp.where(sw_c, hi0, lo0)
    lo1b = jnp.where(sw_c, hi1, lo1)
    hi0b = jnp.where(sw_c, lo0, hi0)
    hi1b = jnp.where(sw_c, lo1, hi1)
    sw_d = gy(lo1b) > gy(hi0b)
    lo1c = jnp.where(sw_d, hi0b, lo1b)
    hi0c = jnp.where(sw_d, lo1b, hi0b)
    mn_l4 = (gy(lo0b) + gy(lo1c) + 1) >> 1
    mx_l4 = (gy(hi0c) + gy(hi1b) + 1) >> 1
    mn_c4 = (gc(lo0b) + gc(lo1c) + 1) >> 1
    mx_c4 = (gc(hi0c) + gc(hi1b) + 1) >> 1
    two = nsmp == 2
    mn_l = jnp.where(two, mn_l2, mn_l4)
    mx_l = jnp.where(two, mx_l2, mx_l4)
    mn_c = jnp.where(two, mn_c2, mn_c4)
    mx_c = jnp.where(two, mx_c2, mx_c4)

    # ---- model (a, b, shift) --------------------------------------------
    range_l = mx_l - mn_l
    lrl0 = _floor_log2(jnp, range_l)
    norm = ((range_l << 4) >> jnp.maximum(lrl0, 0)) & 0xF
    div = jnp.asarray(np.asarray(_CCLM_DIV, np.int32))
    v = jnp.zeros_like(norm)
    for k in range(16):
        v = v + jnp.where(norm == k, int(_CCLM_DIV[k]), 0)
    v = v | 8
    lrl = lrl0 + jnp.where(norm != 0, 1, 0)
    range_c = mx_c - mn_c
    lrc = jnp.where(range_c != 0,
                    _floor_log2(jnp, jnp.abs(range_c)) + 1, 0)
    add = (1 << lrc) >> 1
    a = (range_c * v + add) >> lrc
    shift = 3 + lrl - lrc
    a = jnp.where(shift < 1, jnp.sign(a) * 15, a)
    shift = jnp.maximum(shift, 1)
    b = mn_c - ((a * mn_l) >> shift)
    # degenerate cases: flat luma range, or no samples at all
    a = jnp.where(range_l == 0, 0, a)
    b = jnp.where(range_l == 0, mn_c, b)
    shift = jnp.where(range_l == 0, 0, shift)
    a = jnp.where(nsmp == 0, 0, a)
    b = jnp.where(nsmp == 0, avg, b)
    shift = jnp.where(nsmp == 0, 0, shift)

    # ---- block luma downsample + model apply ----------------------------
    r = jnp.arange(T, dtype=jnp.int32)
    # strided views of the luma window: L(dx, dy)[b, j, i] =
    # LW[b, 4 + 2j + dy, 4 + 2i + dx]
    def L(dx, dy):
        return LW[:, 4 + dy:4 + dy + 2 * T:2, 4 + dx:4 + dx + 2 * T:2]

    if colloc:
        pa = (abv[:, None, None] | (r[None, :, None] > 0)).astype(jnp.int32)
        up = jnp.where(pa > 0, L(0, -1), L(0, 0))
        v0 = (4 + up + 4 * L(0, 0) + L(-1, 0) + L(1, 0) + L(0, 1)) >> 3
        v0_nl = (4 + up + 4 * L(0, 0) + L(0, 0) + L(1, 0) + L(0, 1)) >> 3
    else:
        v0 = (4 + L(1, 0) + L(-1, 0) + 2 * L(0, 0) + 2 * L(0, 1)
              + L(1, 1) + L(-1, 1)) >> 3
        v0_nl = (4 + L(1, 0) + L(0, 0) + 2 * L(0, 0) + 2 * L(0, 1)
                 + L(1, 1) + L(0, 1)) >> 3
    no_left0 = (~lft)[:, None, None] & (r[None, None, :] == 0)
    vds = jnp.where(no_left0, v0_nl, v0)
    pred = jnp.clip(((vds * a[:, None, None]) >> shift[:, None, None])
                    + b[:, None, None], 0, bd_max)
    return pred


def _pdpc_w(jnp, scale, pos):
    sh = jnp.minimum(31, (pos << 1) >> scale)
    return jnp.where(sh < 6, 32 >> jnp.minimum(sh, 5), 0)


def _floor_log2(jnp, v):
    import jax

    return 31 - jax.lax.clz(jnp.maximum(v, 1).astype(jnp.int32))


def _slice1(jnp, arr, starts, n):
    """vmap 1-D dynamic_slice: out[b] = arr[b, starts[b] : starts[b]+n]."""
    import jax

    def one(a, s):
        return jax.lax.dynamic_slice(a, (s,), (n,))

    return jax.vmap(one)(arr, starts.astype(jnp.int32))


def predict_wave_step(jnp, plane, resid, jf, bitdepth, luma, tile=TILE,
                      with_mip=False, with_cclm=False, luma4=None,
                      colloc=False, ctb_log2=6, with_ciip=False):
    """Predict + residual-add + scatter one wave batch into `plane`.

    plane/resid: [H, W] int16/int32 (plane is the scan carry); BOTH must
    extend at least `tile` beyond the bottom/right of any job's tile
    origin (the window fetch/scatter must never clamp).  jf: job fields
    [J_NFIELDS, B] int32 (mode < 0 lanes are no-ops). Returns the updated
    plane. All reference math in int32.

    Formulation notes: in "oriented" space (line L along the
    prediction direction, position P across it) the angular read index is
    main[s(L) + P] — slope exactly 1 in P — so the 2-D gather becomes a
    one-hot (B,T,K) matmul against a Hankel stack of the main line (built
    from static shifts); same for the positive-PDPC side read (slope 1 in
    L).  Every other per-tile reference read is a contiguous window =
    vmapped dynamic_slice.  The tile write is a masked-delta window
    scatter-add.  Element gathers never touch the big planes.
    """
    import jax
    from jax import lax

    LT = LT_L if luma else LT_C
    NEG = NEG_L if luma else NEG_C
    ANGLE, INV, CUBIC, THR = _tables(jnp)
    bd_max = (1 << bitdepth) - 1
    avg = 1 << (bitdepth - 1)
    T = tile

    x0, y0 = jf[J_X0], jf[J_Y0]
    l2w, l2h = jf[J_L2W], jf[J_L2H]
    ox, oy = jf[J_OX], jf[J_OY]
    mode = jf[J_MODE]
    valid = mode >= 0
    mode = jnp.maximum(mode, 0)
    w, h = 1 << l2w, 1 << l2h

    ra, rl = _fill_sides(jnp, plane, x0, y0, jf[J_CORNER], jf[J_ABOVE],
                         jf[J_LEFT], jf[J_NAVA], jf[J_NAVL], avg, LT)

    # ---- mode geometry -------------------------------------------------
    shift_tab = jnp.asarray(np.asarray([0, 6, 10, 12, 14, 15], np.int32))
    wshift = shift_tab[jnp.abs(l2w - l2h)]
    pm = jnp.where((l2w > l2h) & (mode < 2 + wshift) & (mode >= 2),
                   mode + 65,
                   jnp.where((l2h > l2w) & (mode > 66 - wshift),
                             mode - 65, mode))
    vert = pm >= 34
    mode_idx = jnp.where(vert, pm - 50, -(pm - 18))
    n_lines = jnp.where(vert, h, w)
    line_len = jnp.where(vert, w, h)
    side_l2 = jnp.where(vert, l2h, l2w)

    aa = ANGLE[jnp.clip(jnp.abs(mode_idx), 0, 31)]
    inv = INV[jnp.clip(jnp.abs(mode_idx), 0, 31)]
    req_frac = (aa & 0x1F) != 0
    sum_l2 = l2w + l2h
    use_gauss = (bool(luma) & (sum_l2 > 5)
                 & (jnp.abs(mode_idx) > THR[jnp.clip(sum_l2 >> 1, 0, 7)]))
    is_flat = mode < 2
    use_filt = use_gauss & ~req_frac & ~is_flat

    rm = jnp.where(vert[:, None], ra, rl)
    rs = jnp.where(vert[:, None], rl, ra)
    frm = _smooth(jnp, rm, rs, 2 * line_len)
    frs = _smooth(jnp, rs, rm, 2 * n_lines)
    rm_eff = jnp.where(use_filt[:, None], frm, rm)
    rs_eff = jnp.where(use_filt[:, None], frs, rs)

    # negative projection lanes (ref_intra._project_negative): lane i of the
    # assembled main line holds index i - NEG
    n_proj = 1 << side_l2
    i_neg = jnp.arange(NEG, dtype=jnp.int32)[None, :]
    k_neg = NEG - i_neg                       # 1..NEG
    s = 256 + inv[:, None] * k_neg
    proj_idx = jnp.minimum(s >> 9, n_proj[:, None])
    proj = jnp.take_along_axis(rs_eff, jnp.clip(proj_idx, 0, LT - 1), axis=1)
    main = jnp.concatenate([proj, rm_eff], axis=1)   # [B, NEG+LT]
    B = main.shape[0]
    K = NEG + LT

    # ---- oriented angular core: L = line, P = position ------------------
    r = jnp.arange(T, dtype=jnp.int32)
    l_origin = jnp.where(vert, oy, ox)
    p_origin = jnp.where(vert, ox, oy)
    Lg = l_origin[:, None] + r[None, :]       # (B, T) line coords
    Pg = p_origin[:, None] + r[None, :]       # (B, T) position coords

    angle = jnp.where(mode_idx < 0, -aa, aa)
    delta = angle[:, None] * (Lg + 1)         # (B, T)
    d_int = delta >> 5
    d_frac = delta & 0x1F

    f = d_frac
    t_copy = (jnp.zeros_like(f), jnp.full_like(f, 64), jnp.zeros_like(f),
              jnp.zeros_like(f))
    t_lin = (jnp.zeros_like(f), 64 - 2 * f, 2 * f, jnp.zeros_like(f))
    half = f >> 1
    t_gauss = (16 - half, 32 - half, 16 + half, half)
    cub = CUBIC[f]
    t_cub = (cub[..., 0], cub[..., 1], cub[..., 2], cub[..., 3])
    gauss_m = (use_gauss & req_frac)[:, None]
    frac_m = req_frac[:, None]
    taps = []
    for i in range(4):
        frac_t = jnp.where(gauss_m, t_gauss[i],
                           t_cub[i] if luma else t_lin[i])
        taps.append(jnp.where(frac_m, frac_t, t_copy[i])[:, :, None])

    # O[b, L, j] = main[b, s(L) + j] via one-hot matmul x Hankel stack
    sL = jnp.clip(NEG + d_int + p_origin[:, None], 0, K - 4)   # (B, T)
    kk = jnp.arange(K, dtype=jnp.int32)
    S1 = (sL[:, :, None] == kk[None, None, :]).astype(jnp.float32)
    mainp = jnp.concatenate(
        [main, jnp.zeros((B, T + 4), jnp.int32)], axis=1)
    Hk = jnp.stack([mainp[:, j:j + K] for j in range(T + 3)],
                   axis=2).astype(jnp.float32)                  # (B, K, T+3)
    import jax as _jax

    O = jnp.einsum("btk,bkj->btj", S1, Hk,
                   precision=_jax.lax.Precision.HIGHEST).astype(jnp.int32)
    g0, g1 = O[:, :, 0:T], O[:, :, 1:T + 1]
    g2, g3 = O[:, :, 2:T + 2], O[:, :, 3:T + 3]
    acc = taps[0] * g0 + taps[1] * g1 + taps[2] * g2 + taps[3] * g3
    ang = jnp.clip((acc + 32) >> 6, 0, bd_max)    # (B, L, P)

    # ---- PDPC for positive angular modes (oriented) ---------------------
    pdpc_dim_ok = (l2h > 1) if luma else ((l2h > 1) & (l2w > 1))
    pdpc_scale = jnp.minimum(
        2, side_l2 - (_floor_log2(jnp, 3 * inv - 2) - 8))
    lim = jnp.minimum(3 << jnp.maximum(pdpc_scale, 0), line_len)
    pdpc_pos = ((mode_idx > 0) & (pdpc_scale >= 0)
                & (use_gauss | pdpc_dim_ok))
    side_pdpc = jnp.where(use_filt[:, None], frs, rs)
    # p_s[b, L, P] = side[clip(l_origin + L + (inv_sum(P) >> 9) + 1)]:
    # slope 1 in L; upper clip via replicate-padded side line
    inv_sum = 256 + (Pg + 1) * inv[:, None]
    s2 = jnp.clip(l_origin[:, None] + (inv_sum >> 9) + 1, 0, LT - 1)
    kk2 = jnp.arange(LT, dtype=jnp.int32)
    S2 = (s2[:, :, None] == kk2[None, None, :]).astype(jnp.float32)
    sidep = jnp.concatenate(
        [side_pdpc, jnp.repeat(side_pdpc[:, -1:], T, axis=1)], axis=1)
    H2 = jnp.stack([sidep[:, j:j + LT] for j in range(T)],
                   axis=2).astype(jnp.float32)                  # (B, LT, T)
    p_s = jnp.einsum("bpk,bkl->blp", S2, H2,
                     precision=_jax.lax.Precision.HIGHEST).astype(jnp.int32)
    w_l = _pdpc_w(jnp, jnp.maximum(pdpc_scale, 0)[:, None], Pg)[:, None, :]
    ang_p = jnp.clip(ang + ((w_l * (p_s - ang) + 32) >> 6), 0, bd_max)
    ang = jnp.where(pdpc_pos[:, None, None]
                    & (Pg[:, None, :] < lim[:, None, None]), ang_p, ang)

    # ---- pure horizontal/vertical PDPC (oriented) -----------------------
    scale_f = (sum_l2 - 2) >> 2
    tl = ra[:, 0][:, None, None]
    rm_1l = _slice1(jnp, rm, 1 + p_origin, T)[:, None, :]     # over P
    rs_1j = _slice1(jnp, rs, 1 + l_origin, T)[:, :, None]     # over L
    pw = _pdpc_w(jnp, scale_f[:, None], Pg)[:, None, :]
    pure_val = jnp.clip((pw * (rs_1j - tl) + (rm_1l << 6) + 32) >> 6,
                        0, bd_max)
    pure_m = (mode_idx == 0) & pdpc_dim_ok & ~is_flat
    ang = jnp.where(pure_m[:, None, None], pure_val, ang)

    # reorient (L, P) -> tile (row, col)
    ang = jnp.where(vert[:, None, None], ang, ang.transpose(0, 2, 1))

    # ---- planar / DC (tile coords) --------------------------------------
    rg = r[None, :, None]
    cg = r[None, None, :]
    ty = oy[:, None, None] + rg
    tx = ox[:, None, None] + cg
    pl_filt = is_flat & (mode == 0) & bool(luma) & (sum_l2 > 5)
    fa_p = _smooth(jnp, ra, rl, w + 4)
    fl_p = _smooth(jnp, rl, ra, h + 4)
    pa = jnp.where(pl_filt[:, None], fa_p, ra)
    pl = jnp.where(pl_filt[:, None], fl_p, rl)
    topv = _slice1(jnp, pa, 1 + ox, T)[:, None, :]            # (B, 1, P)
    leftv = _slice1(jnp, pl, 1 + oy, T)[:, :, None]           # (B, L, 1)
    tr = jnp.take_along_axis(pa, jnp.clip(w + 1, 0, LT - 1)[:, None],
                             axis=1)[:, :, None]
    bl = jnp.take_along_axis(pl, jnp.clip(h + 1, 0, LT - 1)[:, None],
                             axis=1)[:, :, None]
    l2w3, l2h3 = l2w[:, None, None], l2h[:, None, None]
    hor = (leftv << l2w3) + (tx + 1) * (tr - leftv)
    ver = (topv << l2h3) + (ty + 1) * (bl - topv)
    planar = ((hor << l2h3) + (ver << l2w3) + (1 << (l2w3 + l2h3))) \
        >> (1 + l2w3 + l2h3)

    kk = jnp.arange(LT, dtype=jnp.int32)[None, :]
    sum_a = jnp.sum(jnp.where((kk >= 1) & (kk <= w[:, None]), pa, 0), axis=1)
    sum_l = jnp.sum(jnp.where((kk >= 1) & (kk <= h[:, None]), pl, 0), axis=1)
    dc_shift = jnp.maximum(l2w, l2h) + jnp.where(l2w == l2h, 1, 0)
    dc_acc = (jnp.where(l2w >= l2h, sum_a, 0)
              + jnp.where(l2w <= l2h, sum_l, 0))
    dc = ((dc_acc + ((1 << dc_shift) >> 1)) >> dc_shift)[:, None, None]

    flat = jnp.where((mode == 0)[:, None, None], planar, dc)
    # PDPC for planar/DC
    w_x = _pdpc_w(jnp, scale_f[:, None, None], tx)
    w_y = _pdpc_w(jnp, scale_f[:, None, None], ty)
    flat_p = jnp.clip(
        (w_x * leftv + w_y * topv + (64 - w_x - w_y) * flat + 32) >> 6,
        0, bd_max)
    pdpc_flat_ok = bool(luma) | ((l2w > 1) & (l2h > 1))
    flat = jnp.where(pdpc_flat_ok[:, None, None], flat_p, flat)

    pred = jnp.where(is_flat[:, None, None], flat, ang)

    # ---- MIP jobs (KIND_MIP; whole-CU, so ox == oy == 0) ----------------
    # statically gated: the MIP math compiles into the wave step only for
    # pictures that actually carry MIP jobs (Cfg.mip_on)
    if luma and with_mip:
        is_mip = jf[J_KIND] == KIND_MIP
        mip = _predict_mip_batch(jnp, ra, rl, l2w, l2h, jf[J_AUX0],
                                 jf[J_AUX1], w, h, bitdepth, bd_max, T)
        pred = jnp.where(is_mip[:, None, None], mip, pred)

    # ---- CCLM jobs (KIND_CCLM; chroma pass only, luma plane complete) ---
    if (not luma) and with_cclm:
        is_cclm = jf[J_KIND] == KIND_CCLM
        cclm = _predict_cclm_batch(jnp, plane, luma4, jf, bitdepth,
                                   bd_max, T, colloc, ctb_log2)
        pred = jnp.where(is_cclm[:, None, None], cclm, pred)

    # ---- residual add + masked window scatter-add -----------------------
    wy = (y0 + oy).astype(jnp.int32)
    wx = (x0 + ox).astype(jnp.int32)

    def win(a, oy_, ox_):
        return lax.dynamic_slice(a, (oy_, ox_), (T, T))

    old = jax.vmap(win, in_axes=(None, 0, 0))(plane, wy, wx).astype(jnp.int32)
    rv = jax.vmap(win, in_axes=(None, 0, 0))(resid, wy, wx).astype(jnp.int32)
    if with_ciip:
        # KIND_CIIP (statically gated): the rect currently holds the
        # clipped inter MC prediction (residual deferred via GMASK_DEFER);
        # blend the planar intra pred in (ref_mc.ciip_blend parity:
        # (intra*wt + inter*(4-wt) + 2) >> 2), the shared residual-add
        # below then completes the reconstruction in host order
        is_ciip = (jf[J_KIND] == KIND_CIIP)[:, None, None]
        wt = jf[J_AUX0][:, None, None]
        pred = jnp.where(is_ciip,
                         (pred * wt + old * (4 - wt) + 2) >> 2, pred)
    out = jnp.clip(pred + rv, 0, bd_max)
    msk = (valid[:, None, None] & (ty < h[:, None, None])
           & (tx < w[:, None, None]))
    delta = ((out - old) * msk).astype(plane.dtype)
    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0, 1))
    return lax.scatter_add(plane, jnp.stack([wy, wx], axis=1), delta, dnums)
