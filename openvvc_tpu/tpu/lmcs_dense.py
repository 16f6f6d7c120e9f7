"""Dense whole-frame LMCS for the device program (luma mapping with
chroma scaling).

Parity: rcn/ref_lmcs.py (itself bit-exact vs /root/reference/libovvc/
rcn_lmcs.c:96-377 and rcn_residuals.c scale_add_residual:46).

Formulation: both reshaper LUTs are piecewise linear over 16 uniform
(forward) / data-driven (backward) windows, so the per-sample LUT gather
becomes 16 compare/select terms — no element gathers.  The
per-64x64-block chroma scale needs the RECONSTRUCTED mapped luma
neighbours, so it is derived on device after the luma waves complete:
the above/left neighbour lines of every block are strided slices of the
luma plane, the availability masks are purely geometric (above/left CTU
rows always precede in decode order), and the final integer division
collapses to a 16-entry table selected by window index (host-computed
scale_by_idx).
"""

from __future__ import annotations

import numpy as np

LMCS_PREC = 11
LMCS_RND = 1 << (LMCS_PREC - 1)
BLK = 64  # chroma-scale derivation granule (luma px)


def build_lmcs_tables(st, tile_info, ctb_log2, pic_w, pic_h, raw_tu_bufs,
                      chroma):
    """Host: device tables for one picture.

    st: rcn.ref_lmcs.LmcsState.  raw_tu_bufs: list of (tu_buf, ntu) per
    entry, for the chroma-TU "scaling applies" unit mask.  Returns a dict
    of numpy arrays plus static ints under '_static'."""
    bd = st.bitdepth
    nbx = -(-pic_w // BLK)
    nby = -(-pic_h // BLK)
    wnd = np.asarray(st.wnd_bnd, np.int32)           # (17,)
    # recompute the forward/backward steps from the LUTs' source data:
    # derive from wnd_bnd (sizes) exactly as build_lmcs did
    l2wr = bd - 4
    nsw = (1 << bd) >> 4
    fwd_step = np.zeros(16, np.int32)
    bwd_step = np.zeros(16, np.int32)
    scale_by_idx = np.full(16, 1 << LMCS_PREC, np.int32)
    for i in range(16):
        sz = int(wnd[i + 1] - wnd[i])
        if sz:
            fwd_step[i] = ((sz << LMCS_PREC) + (1 << (l2wr - 1))) >> l2wr
            bwd_step[i] = (nsw << LMCS_PREC) // sz
            d = sz + st.crs_offset
            if d:
                scale_by_idx[i] = (1 << (bd - 4 + LMCS_PREC)) // d

    # geometric availability per block: above/left neighbour unit runs
    # exist iff inside the same tile (raster decode order guarantees the
    # above CTU row / left CTU column are complete)
    col_x = [x << ctb_log2 for x in tile_info.col_x()] if tile_info \
        else [0, 10**9]
    row_y = [y << ctb_log2 for y in tile_info.row_y()] if tile_info \
        else [0, 10**9]

    def tile_of(x, y):
        tx = sum(1 for c in col_x[1:-1] if x >= c)
        ty = sum(1 for r in row_y[1:-1] if y >= r)
        return tx, ty

    top_abv = np.zeros((nby, nbx), np.int32)
    top_lft = np.zeros((nby, nbx), np.int32)
    for by in range(nby):
        for bx in range(nbx):
            x0, y0 = bx * BLK, by * BLK
            t0 = tile_of(x0, y0)
            ta = 0
            if y0 > 0:
                for u in range(16):
                    x = x0 + 4 * u
                    if x < pic_w and tile_of(x, y0 - 1) == t0:
                        ta = u + 1
            tl = 0
            if x0 > 0:
                for u in range(16):
                    y = y0 + 4 * u
                    if y < pic_h and tile_of(x0 - 1, y) == t0:
                        tl = u + 1
            top_abv[by, bx] = ta
            top_lft[by, bx] = tl
    nb = (np.where(top_abv > 0, 16, 0)
          + np.where(top_lft > 0, 16, 0)).astype(np.int32)
    log2_nb = np.zeros_like(nb)
    log2_nb[nb == 16] = 5
    log2_nb[nb == 32] = 6

    out = {"wnd": wnd, "fwd_step": fwd_step, "bwd_step": bwd_step,
           "scale_by_idx": scale_by_idx,
           "top_abv": top_abv, "top_lft": top_lft,
           "nb_zero": (nb == 0).astype(np.int32),
           "log2_nb": log2_nb,
           "min_idx": np.int32(st.min_idx),
           "max_idx": np.int32(st.max_idx)}

    if chroma:
        # TU record layout (ov_shared.h): COMP, X0, Y0, LOG2W, LOG2H, ...
        TU_NF = 17
        F_COMP, F_X0, F_Y0, F_L2W, F_L2H = 0, 1, 2, 3, 4
        uh, uw = -(-pic_h // 4), -(-pic_w // 4)
        csc = np.zeros((uh, uw), np.uint8)
        for tu_buf, ntu in raw_tu_bufs:
            t = tu_buf[:ntu * TU_NF].reshape(ntu, TU_NF)
            sel = (t[:, F_COMP] > 0) & (t[:, F_L2W] + t[:, F_L2H] > 2)
            for r in t[sel]:
                ux, uy = int(r[F_X0]) >> 1, int(r[F_Y0]) >> 1
                wu = max(1, (1 << int(r[F_L2W])) >> 1)
                hu = max(1, (1 << int(r[F_L2H])) >> 1)
                csc[uy:uy + hu, ux:ux + wu] = 1
        out["csc"] = csc
    return out


def _sel16(jnp, idx, tab):
    """tab[idx] for a 16-entry device array via compare/select sum."""
    acc = jnp.zeros_like(idx)
    for k in range(16):
        acc = acc + jnp.where(idx == k, tab[k], 0)
    return acc


def _sel17(jnp, idx, tab):
    acc = jnp.zeros_like(idx)
    for k in range(17):
        acc = acc + jnp.where(idx == k, tab[k], 0)
    return acc


def fwd_map(jnp, v, tabs, bd):
    """Forward reshape of a luma plane (derive_forward_lut applied
    pointwise, piecewise-linear form)."""
    l2wr = bd - 4
    idx = jnp.clip(v >> l2wr, 0, 15)
    wb = _sel16(jnp, idx, tabs["wnd"])
    fs = _sel16(jnp, idx, tabs["fwd_step"])
    f = wb + ((fs * (v - (idx << l2wr)) + LMCS_RND) >> LMCS_PREC)
    return jnp.clip(f, 0, (1 << bd) - 1)


def _bwd_idx(jnp, v, tabs):
    mn = tabs["min_idx"]
    mx = tabs["max_idx"]
    idx = jnp.full(v.shape, 0, jnp.int32) + mn
    for i in range(16):
        on = (i >= mn) & (i < mx)
        idx = idx + jnp.where(on & (v >= tabs["wnd"][i + 1]), 1, 0)
    return jnp.minimum(idx, 15)


def bwd_map(jnp, v, tabs, bd):
    """Backward reshape (derive_backward_lut pointwise)."""
    l2wr = bd - 4
    idx = _bwd_idx(jnp, v, tabs)
    wb = _sel16(jnp, idx, tabs["wnd"])
    bs = _sel16(jnp, idx, tabs["bwd_step"])
    b = (idx << l2wr) + ((bs * (v - wb) + LMCS_RND) >> LMCS_PREC)
    return jnp.clip(b, 0, (1 << bd) - 1)


def chroma_scale_units(jnp, luma, tabs, uh, uw, bd):
    """(uh, uw) int32 chroma-scale plane from the completed mapped luma
    (lmcs_compute_luma_average + scale derivation per 64x64 block)."""
    H, W = luma.shape
    nby, nbx = tabs["top_abv"].shape
    Hp = nby * BLK
    Wp = nbx * BLK
    lp = jnp.pad(luma, ((0, Hp - H), (0, Wp - W)), mode="edge")

    # above rows: last row of the previous block row (block row 0 unused)
    rows = lp[BLK - 1::BLK, :]                       # (nby, Wp) rows 63,127..
    abv = jnp.concatenate([jnp.zeros((1, Wp), lp.dtype), rows[:-1]], axis=0)
    abv = abv.reshape(nby, nbx, BLK)                 # (nby, nbx, 64)
    cols = lp[:, BLK - 1::BLK]                       # (Hp, nbx)
    lft = jnp.concatenate([jnp.zeros((Hp, 1), lp.dtype), cols[:, :-1]],
                          axis=1)
    lft = lft.reshape(nby, BLK, nbx).transpose(0, 2, 1)  # (nby, nbx, 64)

    k = jnp.arange(BLK, dtype=jnp.int32)[None, None, :]

    def side_total(vals, top):
        t4 = (top * 4)[:, :, None]
        run = jnp.sum(jnp.where(k < t4, vals, 0), axis=2)
        pad = jnp.take_along_axis(vals, jnp.clip(t4 - 1, 0, BLK - 1),
                                 axis=2)[:, :, 0]
        n_pad = BLK - top * 4
        return jnp.where(top > 0, run + pad * n_pad, 0)

    total = side_total(abv, tabs["top_abv"]) \
        + side_total(lft, tabs["top_lft"])
    log2nb = tabs["log2_nb"]
    avg = (total + (1 << log2nb)) >> (log2nb + 1)
    avg = jnp.where(tabs["nb_zero"] > 0, 1 << (bd - 1), avg)
    idx = _bwd_idx(jnp, avg, tabs)
    scale = _sel16(jnp, idx, tabs["scale_by_idx"])   # (nby, nbx)

    # blocks -> 4x4 units (16 units per block side), crop to (uh, uw)
    su = jnp.repeat(jnp.repeat(scale, 16, axis=0), 16, axis=1)
    return su[:uh, :uw]


def scale_chroma_res(jnp, res, scale_u, csc_u, bd):
    """Apply the chroma residual scale (scale_add_residual parity) to a
    chroma residual plane (uh*2, uw*2); csc_u masks TUs > 2x2."""
    v = res.astype(jnp.int32)
    s2 = jnp.repeat(jnp.repeat(scale_u, 2, axis=0), 2, axis=1)
    m2 = jnp.repeat(jnp.repeat(csc_u, 2, axis=0), 2, axis=1) != 0
    mag = jnp.clip(jnp.abs(v), 0, (1 << bd) - 1)
    mag = (mag * s2 + LMCS_RND) >> LMCS_PREC
    out = jnp.clip(jnp.where(v < 0, -mag, mag), -(1 << 15), 1 << 15)
    return jnp.where(m2, out, v)
