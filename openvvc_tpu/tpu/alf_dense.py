"""Dense whole-frame ALF / CC-ALF for the device frame program.

The reference applies ALF per CTU with scalar gradient classification and
per-4x4 filter dispatch (rcn_alf.c:283-690 classification, :806-1290
filters, :740-806 CC-ALF).  Here the whole entry region runs as one dense
program: gradients are computed for every sample with the virtual-boundary
row clamps expressed as per-row plane selects (host-precomputed masks, no
gathers), 4x4-block laplacian sums are strided window reductions, the
branchy direction/activity classifier is branchless integer math (the one
cross product compare that needs 35 bits runs as a 15-bit-limb double-word
compare), and per-block filter coefficients resolve by direct indexing
into the stacked (transpose x class) tables.
Filtering itself is 12 (luma) / 6 (chroma) clipped-difference taps over
VB-row-resolved shifted planes.  Bit-exact vs rcn/ref_alf.py (itself
oracle-validated against the reference binary).

Everything is xp-generic: xp=numpy for host tests, xp=jax.numpy inside the
jitted frame program."""

from __future__ import annotations

import numpy as np

from openvvc_tpu.rcn.ref_alf import VB_ABOVE

NUM_BITS = 8
PAD = 8


def _bucket_pow2(n):
    return 1 << max(0, (n - 1)).bit_length() if n > 1 else 1


# ----------------------------------------------------------------------
# host: per-sequence row tables (virtual-boundary geometry)
# ----------------------------------------------------------------------


def _vb_enabled_rows(pic_h, ctu_s):
    """Per luma row: does its CTU row carry a virtual boundary?  Mirrors
    apply_alf_entry: vb iff ctu_y0 + ctu_s <= pic_h (bottom partial CTU
    rows never clamp)."""
    y = np.arange(pic_h, dtype=np.int32)
    ctu_y0 = y & ~np.int32(ctu_s - 1)
    return (ctu_y0 + ctu_s) <= pic_h


def luma_row_tabs(pic_h, ctu_s):
    """(roff [6, H] int32, near_vb [H] bool, cls_up [H] bool, cls_dn [H]
    bool): per-row tap row-offsets r1..r6 (filter_luma_ctu's r[1..6]) with
    the VB clamps resolved, the near-VB rounding rows, and the
    classification up/down row clamps."""
    H = pic_h
    en = _vb_enabled_rows(H, ctu_s)
    yv = np.arange(H, dtype=np.int32) & (ctu_s - 1)
    vb = ctu_s - VB_ABOVE
    r = np.empty((6, H), np.int32)
    r[0], r[1], r[2], r[3], r[4], r[5] = 1, -1, 2, -2, 3, -3
    d = {}
    for k in range(5):
        d[f"a{k}"] = en & (yv == vb - 1 - k)   # above VB, distance k+1
        d[f"b{k}"] = en & (yv == vb + k)       # below VB, distance k
    r1, r2, r3, r4, r5, r6 = (np.full(H, v, np.int32)
                              for v in (1, -1, 2, -2, 3, -3))
    r1[d["a0"] | d["b0"]] = 0
    r3[d["a1"] | d["b1"]] = 1
    r3[d["a0"] | d["b0"]] = 0
    r5[d["a2"] | d["b2"]] = 2
    r5[d["a1"] | d["b1"]] = 1
    r5[d["a0"] | d["b0"]] = 0
    r2[d["a0"] | d["b0"]] = 0
    r4[d["a1"] | d["b1"]] = -1
    r4[d["a0"] | d["b0"]] = 0
    r6[d["a2"] | d["b2"]] = -2
    r6[d["a1"] | d["b1"]] = -1
    r6[d["a0"] | d["b0"]] = 0
    roff = np.stack([r1, r2, r3, r4, r5, r6])
    near = d["a0"] | d["b0"]
    cls_up = d["b0"].copy()     # gradient at row == vb: up read clamps
    cls_dn = d["a0"].copy()     # gradient at row == vb-1: down read clamps
    return roff, near, cls_up, cls_dn


def chroma_row_tabs(pic_h, ctu_s):
    """Chroma 5x5 variant: (roff [4, Hc], near_vb [Hc]).  The reference's
    is_vb_c gate is True for every CTU (full CTUs land in the
    yVb >= virbnd window, partial CTUs force it), so the rules apply
    frame-wide with virbnd = ctu_s_c - 2 on VB rows."""
    Hc = pic_h >> 1
    cs = ctu_s >> 1
    en = _vb_enabled_rows(pic_h, ctu_s)[::2][:Hc]
    yv = np.arange(Hc, dtype=np.int32) & (cs - 1)
    vb = (ctu_s - VB_ABOVE) >> 1
    a0 = en & (yv == vb - 1)
    a1 = en & (yv == vb - 2)
    b0 = en & (yv == vb)
    b1 = en & (yv == vb + 1)
    r1, r2, r3, r4 = (np.full(Hc, v, np.int32) for v in (1, -1, 2, -2))
    r1[a0 | b0] = 0
    r3[a1 | b1] = 1
    r3[a0 | b0] = 0
    r2[a0 | b0] = 0
    r4[a1 | b1] = -1
    r4[a0 | b0] = 0
    return np.stack([r1, r2, r3, r4]), (a0 | b0)


def cc_row_tabs(pic_h, ctu_s):
    """CC-ALF per chroma row: luma row offsets (o1, o2, o3) with the VB
    clamps of filter_cc_alf_ctu (pos = luma row & (ctu_s-1); bottom
    partial CTU rows compare against pic_h>>1 instead — reference quirk
    kept)."""
    Hc = pic_h >> 1
    ly = np.arange(Hc, dtype=np.int32) * 2
    en = _vb_enabled_rows(pic_h, ctu_s)[ly]
    pos = ly & (ctu_s - 1)
    vb = np.where(en, ctu_s - VB_ABOVE, np.int32(pic_h >> 1))
    o1 = np.full(Hc, 1, np.int32)
    o2 = np.full(Hc, -1, np.int32)
    o3 = np.full(Hc, 2, np.int32)
    m_o3 = (pos == vb - 2) | (pos == vb + 1)
    o3[m_o3] = 1
    m_z = (pos == vb - 1) | (pos == vb)
    o1[m_z] = 0
    o2[m_z] = 0
    o3[m_z] = 0
    return np.stack([o1, o2, o3])


def block_row_tabs(pic_h, ctu_s):
    """Per 4x4 block row: (variant [nBY] int32: 0 full 8-row window,
    1 bottom-trimmed, 2 top-trimmed; is_vb [nBY] bool)."""
    nby = (pic_h + 3) >> 2
    yb = np.arange(nby, dtype=np.int32) * 4
    en = _vb_enabled_rows(pic_h, ctu_s)[np.minimum(yb, pic_h - 1)]
    yv = yb & (ctu_s - 1)
    vb = ctu_s - VB_ABOVE
    var = np.zeros(nby, np.int32)
    var[en & (yv == vb - 4)] = 1
    var[en & (yv == vb)] = 2
    return var, var != 0


# ----------------------------------------------------------------------
# host: per-frame CTU tables
# ----------------------------------------------------------------------


# keys that vary per frame (traced device args in the frame program); the
# row/block tables depend only on (pic_h, ctu_s) and stay static constants
TRACED_KEYS = ("luma_on", "slot", "sets", "c_on", "c_coef", "cc_coef")

_ROW_CACHE: dict = {}


def static_row_tabs(pic_h, ctu_s, chroma):
    """Cached per-sequence row/block tables (VB geometry)."""
    key = (pic_h, ctu_s, bool(chroma))
    hit = _ROW_CACHE.get(key)
    if hit is None:
        roff, near, cls_up, cls_dn = luma_row_tabs(pic_h, ctu_s)
        hit = dict(roff_l=roff, near_l=near.astype(np.int32),
                   cls_up=cls_up, cls_dn=cls_dn)
        var, isvb = block_row_tabs(pic_h, ctu_s)
        hit.update(blk_var=var, blk_isvb=isvb.astype(np.int32))
        if chroma:
            roff_c, near_c = chroma_row_tabs(pic_h, ctu_s)
            hit.update(roff_c=roff_c, near_c=near_c.astype(np.int32),
                       cc_off=cc_row_tabs(pic_h, ctu_s))
        _ROW_CACHE[key] = hit
    return hit


def build_alf_tables(alf_params, filters, cc_data, ctb_log2, pic_w, pic_h,
                     chroma):
    """Per-CTU maps + stacked filter tables for the dense kernel.

    alf_params: {(cx, cy): CtuAlfParams} (fields ctb_alf_flag,
    ctb_alf_idx, cb_alternative, cr_alternative, cc_alf_idx).
    filters: rcn.ref_alf.AlfFilters.  cc_data: (aps_cb, aps_cr) or None.
    Returns dict of numpy arrays, or None when every CTU is off."""
    ctu_s = 1 << ctb_log2
    ncw = (pic_w + ctu_s - 1) >> ctb_log2
    nch = (pic_h + ctu_s - 1) >> ctb_log2
    luma_on = np.zeros((nch, ncw), np.int32)
    slot = np.zeros((nch, ncw), np.int32)
    con = np.zeros((2, nch, ncw), np.int32)
    ccoef = np.zeros((2, nch, ncw, 14), np.int32)
    cccoef = np.zeros((2, nch, ncw, 7), np.int32)
    fsets: list[int] = []
    any_on = False
    for (cx, cy), p in alf_params.items():
        if p is None or cy >= nch or cx >= ncw:
            continue
        if p.ctb_alf_flag & 4:
            any_on = True
            luma_on[cy, cx] = 1
            fs = int(p.ctb_alf_idx)
            if fs not in fsets:
                fsets.append(fs)
            slot[cy, cx] = fsets.index(fs)
        if chroma:
            for ci, bit in ((0, 2), (1, 1)):
                if p.ctb_alf_flag & bit:
                    any_on = True
                    con[ci, cy, cx] = 1
                    alt = p.cb_alternative if ci == 0 else p.cr_alternative
                    ccoef[ci, cy, cx, :7] = filters.chroma_coeff[alt]
                    ccoef[ci, cy, cx, 7:] = filters.chroma_clip[alt]
                idx = p.cc_alf_idx[ci]
                if idx and cc_data is not None and cc_data[ci] is not None:
                    any_on = True
                    ad = cc_data[ci]
                    cf = (ad.alf_cc_cb_coeff if ci == 0
                          else ad.alf_cc_cr_coeff)[idx - 1]
                    cccoef[ci, cy, cx] = [int(cf[j]) for j in range(7)]
    if not any_on:
        return None
    S = _bucket_pow2(max(1, len(fsets)))
    sets = np.zeros((S, 100, 26), np.int32)
    for si, fs in enumerate(fsets):
        sets[si, :, :13] = filters.coeff[fs].reshape(100, 13)
        sets[si, :, 13:] = filters.clip[fs].reshape(100, 13)
    tabs = {"luma_on": luma_on, "slot": slot, "sets": sets,
            "c_on": con, "c_coef": ccoef, "cc_coef": cccoef}
    tabs.update(static_row_tabs(pic_h, ctu_s, chroma))
    return tabs


# ----------------------------------------------------------------------
# device: classification
# ----------------------------------------------------------------------


def _pad_edge(xp, a, pad):
    if xp is np:
        return np.pad(a, pad, mode="edge")
    import jax.numpy as jnp

    return jnp.pad(a, pad, mode="edge")


def _rowsel(xp, P, off_col, choices):
    """P row-remapped: out[y] = P[y + off[y]] as select over shifted
    planes.  off_col: (Hp, 1) int32; choices: iterable of offsets."""
    Hp = P.shape[0]
    out = xp.zeros_like(P)
    for o in choices:
        if o >= 0:
            sh = xp.concatenate([P[o:], xp.repeat(P[-1:], o, axis=0)]) \
                if o else P
        else:
            sh = xp.concatenate([xp.repeat(P[:1], -o, axis=0), P[:o]])
        out = out + xp.where(off_col == o, sh, 0)
    return out


def _mulcmp_gt(xp, a, d, b, c):
    """a*d > b*c for 0 <= values < 2^18, exact, int32-only (15-bit limbs)."""
    def limbs(u, v):
        uh, ul = u >> 15, u & 0x7FFF
        vh, vl = v >> 15, v & 0x7FFF
        lo = ul * vl
        mid = uh * vl + ul * vh + (lo >> 15)
        hi = uh * vh + (mid >> 15)
        return hi, mid & 0x7FFF, lo & 0x7FFF

    h1, m1, l1 = limbs(a, d)
    h2, m2, l2 = limbs(b, c)
    return (h1 > h2) | ((h1 == h2) & ((m1 > m2) | ((m1 == m2) & (l1 > l2))))


def classify(xp, reg_pad, y0_abs, tabs, H, W, bitdepth):
    """4x4-block (class_idx, transpose_idx) for one entry region.

    reg_pad: (H + 2*PAD, W + 2*PAD) padded pre-ALF luma; y0_abs: absolute
    picture row of region row 0 (CTU aligned).  Returns int32 arrays of
    shape (ceil(H/4), ceil(W/4))."""
    nby, nbx = (H + 3) >> 2, (W + 3) >> 2
    Hp = reg_pad.shape[0]
    P = reg_pad.astype(xp.int32)

    # per-padded-row classification clamps (absolute rows, edge-extended)
    yy = np.clip(np.arange(Hp) - PAD + y0_abs, 0, len(tabs["cls_up"]) - 1)
    up_c = xp.asarray(tabs["cls_up"][yy][:, None]) if xp is not np \
        else tabs["cls_up"][yy][:, None]
    dn_c = xp.asarray(tabs["cls_dn"][yy][:, None]) if xp is not np \
        else tabs["cls_dn"][yy][:, None]

    up = xp.concatenate([P[:1], P[:-1]])        # row y-1
    dn = xp.concatenate([P[1:], P[-1:]])        # row y+1
    U = xp.where(up_c, P, up)
    D = xp.where(dn_c, P, dn)

    def shx(A, dx):
        if dx == 0:
            return A
        if dx > 0:
            return xp.concatenate([A[:, dx:], A[:, -1:].repeat(dx, axis=1)],
                                  axis=1)
        return xp.concatenate([A[:, :1].repeat(-dx, axis=1), A[:, :dx]],
                              axis=1)

    two = 2 * P
    gv = xp.abs(two - U - D)
    gh = xp.abs(two - shx(P, -1) - shx(P, 1))
    gd = xp.abs(two - shx(U, -1) - shx(D, 1))
    gb = xp.abs(two - shx(D, -1) - shx(U, 1))

    # checkerboard: gradients live at even (row+col) parity in absolute
    # coords; region origin is CTU aligned so region parity == abs parity
    ygrid = xp.arange(Hp, dtype=xp.int32)[:, None]
    xgrid = xp.arange(reg_pad.shape[1], dtype=xp.int32)[None, :]
    cb_m = ((ygrid + xgrid) & 1) == 0   # PAD is even: parity preserved

    sums = []
    for g in (gh, gv, gd, gb):
        g = xp.where(cb_m, g, 0)
        # window cols [4X-2, 4X+5] -> G col coords: crop so index 0 is
        # region col -2 (= padded col PAD-2)
        need_w = 4 * nbx + 8
        Gc = g[:, PAD - 2:PAD - 2 + need_w]
        if Gc.shape[1] < need_w:
            Gc = xp.concatenate(
                [Gc, xp.zeros((Hp, need_w - Gc.shape[1]), xp.int32)], axis=1)
        sc = Gc[:, 0::4][:, :nbx]
        for j in range(1, 8):
            sc = sc + Gc[:, j::4][:, :nbx]
        # window rows: crop so row 0 is region row -2
        need_h = 4 * nby + 8
        Gr = sc[PAD - 2:PAD - 2 + need_h]
        if Gr.shape[0] < need_h:
            Gr = xp.concatenate(
                [Gr, xp.zeros((need_h - Gr.shape[0], nbx), xp.int32)])
        rows = [Gr[j::4][:nby] for j in range(8)]
        full = rows[0]
        for j in range(1, 8):
            full = full + rows[j]
        head = rows[0]
        for j in range(1, 6):
            head = head + rows[j]          # dy -2..3 (bottom-trimmed)
        tail = rows[2]
        for j in range(3, 8):
            tail = tail + rows[j]          # dy 0..5 (top-trimmed)
        yb = np.clip((np.arange(nby) * 4 + y0_abs) >> 2, 0,
                     len(tabs["blk_var"]) - 1)
        var = tabs["blk_var"][yb][:, None]
        var = xp.asarray(var) if xp is not np else var
        s = xp.where(var == 1, head, xp.where(var == 2, tail, full))
        sums.append(s)
    sum_h, sum_v, sum_d, sum_b = sums

    ybk = np.clip((np.arange(nby) * 4 + y0_abs) >> 2, 0,
                  len(tabs["blk_isvb"]) - 1)
    isvb = tabs["blk_isvb"][ybk][:, None]
    isvb = xp.asarray(isvb) if xp is not np else isvb
    shift = bitdepth + 4

    scale = xp.where(isvb != 0, 96, 64)
    act = ((sum_h + sum_v) * scale) >> shift
    act = xp.clip(act, 0, 15)
    # ACT_TH thresholds: >=1 ->1, >=2 ->2, >=7 ->3, >=15 ->4
    cls = ((act >= 1).astype(xp.int32) + (act >= 2) + (act >= 7)
           + (act >= 15))

    hv_v = sum_v > sum_h
    max_hv = xp.where(hv_v, sum_v, sum_h)
    min_hv = xp.where(hv_v, sum_h, sum_v)
    dir_hv = xp.where(hv_v, 1, 3)
    db_d = sum_d > sum_b
    max_db = xp.where(db_d, sum_d, sum_b)
    min_db = xp.where(db_d, sum_b, sum_d)
    dir_db = xp.where(db_d, 0, 2)

    db_wins = _mulcmp_gt(xp, max_db, min_hv, max_hv, min_db)
    max_dir = xp.where(db_wins, max_db, max_hv)
    min_dir = xp.where(db_wins, min_db, min_hv)
    main_dir = xp.where(db_wins, dir_db, dir_hv)
    sec_dir = xp.where(db_wins, dir_hv, dir_db)

    strong = max_dir * 2 > 9 * min_dir
    mild = max_dir > 2 * min_dir
    dstep = (((main_dir & 1) << 1) + 2) * 5
    dstep1 = (((main_dir & 1) << 1) + 1) * 5
    cls = cls + xp.where(strong, dstep, xp.where(mild, dstep1, 0))

    tr_lut = (0, 1, 0, 2, 2, 3, 1, 3)
    tidx = (main_dir << 1) + (sec_dir >> 1)
    tr = xp.zeros_like(tidx)
    for i, v in enumerate(tr_lut):
        if v:
            tr = tr + xp.where(tidx == i, v, 0)
    return cls, tr


# ----------------------------------------------------------------------
# device: per-block coefficient resolution
# ----------------------------------------------------------------------


def _resolve_coeffs(xp, cls, tr, slot_blk, sets):
    """Per-4x4-block (26,) coeff+clip rows from the stacked set tables.

    A direct integer index on both paths: no float arithmetic touches the
    coefficients or clips (a float matmul lookup may run in TF32)."""
    S = sets.shape[0]
    idx = slot_blk * 100 + tr * 25 + cls
    flat = sets.reshape(S * 100, 26)
    if xp is np:
        return flat[idx].astype(np.int64)
    return xp.asarray(flat)[idx].astype(xp.int32)


# ----------------------------------------------------------------------
# device: filters
# ----------------------------------------------------------------------


def _clip2(xp, clip, ref, v0, v1):
    return (xp.clip(v0 - ref, -clip, clip) + xp.clip(v1 - ref, -clip, clip))


def _up4(xp, blk, H, W, lg=2):
    t = xp.repeat(xp.repeat(blk, 1 << lg, axis=0), 1 << lg, axis=1)
    return t[:H, :W]


def filter_luma(xp, reg_pad, y0_abs, tabs, cls, tr, slot_blk, on_blk,
                H, W, bitdepth):
    """Dense 7x7 clipped diamond over one region; returns the filtered
    interior (H, W) with off blocks passed through."""
    P = reg_pad.astype(xp.int32)
    Hp = reg_pad.shape[0]
    yy = np.clip(np.arange(Hp) - PAD + y0_abs, 0, tabs["roff_l"].shape[1] - 1)
    roff = tabs["roff_l"][:, yy]          # (6, Hp)
    near = tabs["near_l"][yy]

    planes = {0: P}
    for t in range(6):
        col = roff[t][:, None]
        col = xp.asarray(col) if xp is not np else col
        choices = sorted(set(int(v) for v in np.unique(roff[t])))
        planes[t + 1] = _rowsel(xp, P, col, choices)

    def sv(t, dy_unused, dx):
        A = planes[t]
        return A[PAD:PAD + H, PAD + dx:PAD + dx + W]

    cur = sv(0, 0, 0)
    cf = _resolve_coeffs(xp, cls, tr, slot_blk, tabs["sets"])
    if xp is np:
        c = lambda k: _up4(np, cf[..., k], H, W)
        cl = lambda k: _up4(np, cf[..., 13 + k], H, W)
        curl = cur.astype(np.int64)
    else:
        c = lambda k: _up4(xp, cf[..., k], H, W)
        cl = lambda k: _up4(xp, cf[..., 13 + k], H, W)
        curl = cur

    # tap geometry: (plane_a, dx_a, plane_b, dx_b) for k = 0..11
    taps = (
        (5, 0, 6, 0),      # rows +-3
        (3, 1, 4, -1),     # rows +-2
        (3, 0, 4, 0),
        (3, -1, 4, 1),
        (1, 2, 2, -2),     # rows +-1
        (1, 1, 2, -1),
        (1, 0, 2, 0),
        (1, -1, 2, 1),
        (1, -2, 2, 2),
        (0, 3, 0, -3),     # same row
        (0, 2, 0, -2),
        (0, 1, 0, -1),
    )
    s = xp.zeros_like(curl)
    for k, (pa, dxa, pb, dxb) in enumerate(taps):
        s = s + c(k) * _clip2(xp, cl(k), curl, sv(pa, 0, dxa), sv(pb, 0, dxb))
    shift = NUM_BITS - 1
    nearc = near[PAD:PAD + H][:, None]
    nearc = xp.asarray(nearc) if xp is not np else nearc
    val = xp.where(nearc != 0, (s + (1 << (shift + 2))) >> (shift + 3),
                   (s + (1 << (shift - 1))) >> shift)
    out = xp.clip(val + curl, 0, (1 << bitdepth) - 1)
    on_pix = _up4(xp, on_blk, H, W)
    return xp.where(on_pix != 0, out.astype(xp.int32), cur)


def filter_chroma(xp, reg_pad, y0_abs, tabs, coef_pix, on_pix, H, W,
                  bitdepth):
    """Dense 5x5 clipped diamond; coef_pix: (H, W, 14) per-pixel coeff+clip
    (upsampled per-CTU tables); on_pix: (H, W) mask."""
    P = reg_pad.astype(xp.int32)
    Hp = reg_pad.shape[0]
    yy = np.clip(np.arange(Hp) - PAD + y0_abs, 0, tabs["roff_c"].shape[1] - 1)
    roff = tabs["roff_c"][:, yy]
    near = tabs["near_c"][yy]

    planes = {0: P}
    for t in range(4):
        col = roff[t][:, None]
        col = xp.asarray(col) if xp is not np else col
        choices = sorted(set(int(v) for v in np.unique(roff[t])))
        planes[t + 1] = _rowsel(xp, P, col, choices)

    def sv(t, dx):
        return planes[t][PAD:PAD + H, PAD + dx:PAD + dx + W]

    cur = sv(0, 0)
    taps = (
        (3, 0, 4, 0),      # rows +-2
        (1, 1, 2, -1),     # rows +-1
        (1, 0, 2, 0),
        (1, -1, 2, 1),
        (0, 2, 0, -2),     # same row
        (0, 1, 0, -1),
    )
    s = xp.zeros_like(cur)
    for k, (pa, dxa, pb, dxb) in enumerate(taps):
        s = s + coef_pix[..., k] * _clip2(xp, coef_pix[..., 7 + k], cur,
                                          sv(pa, dxa), sv(pb, dxb))
    shift = NUM_BITS - 1
    nearc = near[PAD:PAD + H][:, None]
    nearc = xp.asarray(nearc) if xp is not np else nearc
    val = xp.where(nearc != 0, (s + (1 << (shift + 2))) >> (shift + 3),
                   (s + (1 << (shift - 1))) >> shift)
    out = xp.clip(val + cur, 0, (1 << bitdepth) - 1)
    return xp.where(on_pix != 0, out, cur)


def filter_cc(xp, luma_pad, y0_abs, tabs, dst, coef_pix, H, W, bitdepth):
    """CC-ALF: correction from pre-ALF luma applied onto the post-ALF
    chroma plane dst (H, W).  coef_pix: (H, W, 7); rows where all coeffs
    are zero pass through unchanged (c6 never fires on cur-cur)."""
    L = luma_pad.astype(xp.int32)
    Hp = luma_pad.shape[0]
    # per chroma row luma offsets o1..o3
    yyc = np.clip(np.arange(H) + (y0_abs >> 1), 0, tabs["cc_off"].shape[1] - 1)
    off = tabs["cc_off"][:, yyc]          # (3, H)

    def lsub(rowplane, dx):
        # luma plane -> chroma grid: rows 2i, cols 2j+dx
        return rowplane[PAD:PAD + 2 * H:2, PAD + dx:PAD + dx + 2 * W:2]

    planes = {}
    for t in range(3):
        col = np.repeat(off[t], 2)[:, None]  # chroma row -> 2 luma rows
        full = np.full((Hp, 1), {0: 1, 1: -1, 2: 2}[t], np.int32)
        full[PAD:PAD + 2 * H] = col[:2 * H]
        fcol = xp.asarray(full) if xp is not np else full
        choices = sorted(set(int(v) for v in np.unique(full)))
        planes[t] = _rowsel(xp, L, fcol, choices)

    cur = lsub(L, 0)
    s = (coef_pix[..., 0] * (lsub(planes[1], 0) - cur)
         + coef_pix[..., 1] * (lsub(L, -1) - cur)
         + coef_pix[..., 2] * (lsub(L, 1) - cur)
         + coef_pix[..., 3] * (lsub(planes[0], -1) - cur)
         + coef_pix[..., 4] * (lsub(planes[0], 0) - cur)
         + coef_pix[..., 5] * (lsub(planes[0], 1) - cur)
         + coef_pix[..., 6] * (lsub(planes[2], 0) - cur))
    s = (s + 64) >> 7
    mx = (1 << bitdepth) - 1
    half = (1 << bitdepth) >> 1
    s = xp.clip(s + half, 0, mx)
    on = xp.sum(xp.abs(coef_pix), axis=-1) != 0
    return xp.where(on, xp.clip(s + dst - half, 0, mx), dst)


# ----------------------------------------------------------------------
# entry-region driver (mirrors rcn/ref_alf.apply_alf_entry)
# ----------------------------------------------------------------------


def alf_entry(xp, y, cb, cr, tabs, entry_bounds, ctb_log2, bitdepth,
              pic_w, pic_h):
    """Filter one rectangular entry; returns updated (y, cb, cr).

    y/cb/cr: full int32 planes (post SAO).  Reads are from the pre-ALF
    state of this entry's own region (pads replicate at entry borders,
    exactly the host reference)."""
    ex0, ey0, nw, nh = entry_bounds
    ctu_s = 1 << ctb_log2
    x0, y0 = ex0 << ctb_log2, ey0 << ctb_log2
    x1 = min(pic_w, (ex0 + nw) << ctb_log2)
    y1 = min(pic_h, (ey0 + nh) << ctb_log2)
    H, W = y1 - y0, x1 - x0

    reg_y = y[y0:y1, x0:x1]
    pad_y = _pad_edge(xp, reg_y, PAD)

    # per-CTU maps for this entry
    csl = slice(ex0, ex0 + nw)
    rsl = slice(ey0, ey0 + nh)
    nb_blk = ctu_s >> 2
    lg_blk = ctb_log2 - 2

    def upctu(tab, Hn, Wn, lg):
        t = xp.repeat(xp.repeat(tab, 1 << lg, axis=0), 1 << lg, axis=1)
        return t[:Hn, :Wn]

    luma_on = tabs["luma_on"][rsl, csl]
    new_y = y
    if luma_on.any() if xp is np else True:
        cls, tr = classify(xp, pad_y, y0, tabs, H, W, bitdepth)
        on_blk = upctu(xp.asarray(luma_on) if xp is not np else luma_on,
                       (H + 3) >> 2, (W + 3) >> 2, lg_blk)
        sl = tabs["slot"][rsl, csl]
        slot_blk = upctu(xp.asarray(sl) if xp is not np else sl,
                         (H + 3) >> 2, (W + 3) >> 2, lg_blk)
        fy = filter_luma(xp, pad_y, y0, tabs, cls, tr, slot_blk, on_blk,
                         H, W, bitdepth)
        if xp is np:
            new_y = y.copy()
            new_y[y0:y1, x0:x1] = fy
        else:
            new_y = y.at[y0:y1, x0:x1].set(fy)

    if cb is None:
        return new_y, None, None

    Hc, Wc = H >> 1, W >> 1
    outs = []
    for ci, plane in ((0, cb), (1, cr)):
        regc = plane[y0 >> 1:y1 >> 1, x0 >> 1:x1 >> 1]
        pad_c = _pad_edge(xp, regc, PAD)
        con = tabs["c_on"][ci][rsl, csl]
        ccf = tabs["c_coef"][ci][rsl, csl]
        cccf = tabs["cc_coef"][ci][rsl, csl]
        any_c = (con.any() or cccf.any()) if xp is np else True
        if not any_c:
            outs.append(plane)
            continue
        conx = xp.asarray(con) if xp is not np else con
        ccfx = xp.asarray(ccf) if xp is not np else ccf
        cccfx = xp.asarray(cccf) if xp is not np else cccf
        on_pix = upctu(conx, Hc, Wc, ctb_log2 - 1)
        coef_pix = upctu(ccfx, Hc, Wc, ctb_log2 - 1)
        fc = filter_chroma(xp, pad_c, y0 >> 1, tabs, coef_pix, on_pix,
                           Hc, Wc, bitdepth)
        cc_pix = upctu(cccfx, Hc, Wc, ctb_log2 - 1)
        fc = filter_cc(xp, pad_y, y0, tabs, fc, cc_pix, Hc, Wc, bitdepth)
        if xp is np:
            npl = plane.copy()
            npl[y0 >> 1:y1 >> 1, x0 >> 1:x1 >> 1] = fc
            outs.append(npl)
        else:
            outs.append(plane.at[y0 >> 1:y1 >> 1, x0 >> 1:x1 >> 1].set(fc))
    return new_y, outs[0], outs[1]


def alf_frame(xp, y, cb, cr, tabs, entries, ctb_log2, bitdepth, pic_w,
              pic_h):
    """Apply ALF/CC-ALF over every entry region (reads per-entry pre-ALF
    state; entries are disjoint so sequential update is exact)."""
    for eb in entries:
        y, cb, cr = alf_entry(xp, y, cb, cr, tabs, eb, ctb_log2, bitdepth,
                              pic_w, pic_h)
    return y, cb, cr
