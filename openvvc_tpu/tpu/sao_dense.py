"""Dense whole-frame SAO: per-CTU band/edge tables applied as masked
gathers — one launch per plane instead of the reference's per-CTU-line
loops (rcn_sao.c:47-239; bit-exact vs rcn/ref_sao.py incl. the
single-CTU-row entry seam quirk).

Host side builds small per-CTU tables (type map, 32-entry band LUT,
5-entry edge LUT, EO class, border masks); the device side is pure
elementwise math + two table gathers.
"""

from __future__ import annotations

import numpy as np

from openvvc_tpu.vcl.sao import SAO_BAND, SAO_EDGE

_EO_POS = (
    ((-1, 0), (1, 0)),
    ((0, -1), (0, 1)),
    ((-1, -1), (1, 1)),
    ((1, -1), (-1, 1)),
)


def build_sao_tables(sao_maps, entries, ctb_log2, pic_w, pic_h, chroma):
    """Host: per-CTU tables for the dense kernel.

    sao_maps: {(cx, cy): SaoParams} merged over entries; entries: list of
    (ctu_x0, ctu_y0, nb_w, nb_h). Returns dict of numpy arrays or None if
    SAO is entirely off.
    """
    ncw = (pic_w + (1 << ctb_log2) - 1) >> ctb_log2
    nch = (pic_h + (1 << ctb_log2) - 1) >> ctb_log2
    ncomp = 3 if chroma else 1
    typ = np.zeros((ncomp, nch, ncw), np.int32)
    band4 = np.zeros((ncomp, nch, ncw, 4), np.int32)
    bandpos = np.zeros((ncomp, nch, ncw), np.int32)
    edge = np.zeros((ncomp, nch, ncw, 5), np.int32)
    eo = np.zeros((ncomp, nch, ncw), np.int32)
    any_on = False
    for (cx, cy), sao in sao_maps.items():
        for c in range(ncomp):
            t = sao.type_idx[c]
            if t == 0:
                continue
            any_on = True
            typ[c, cy, cx] = t
            if t == SAO_BAND:
                band4[c, cy, cx] = sao.offset_val[c][:4]
                bandpos[c, cy, cx] = sao.band_position[c]
            else:
                edge[c, cy, cx] = sao.offset_val[c][:5]
                eo[c, cy, cx] = sao.eo_class[c]
    if not any_on:
        return None
    out = {"typ": typ, "band4": band4, "bandpos": bandpos, "edge": edge,
           "eo": eo}
    _add_border_masks(out, entries, ctb_log2, pic_w, pic_h, ncomp)
    return out


def build_sao_tables_recs(recs_list, entries, ctb_log2, pic_w, pic_h,
                          chroma):
    """Vectorized table build straight from the native parse's flat SAO
    records: recs_list = [(ctu_meta (n,3), sao_buf (n,24) int32), ...]."""
    ncw = (pic_w + (1 << ctb_log2) - 1) >> ctb_log2
    nch = (pic_h + (1 << ctb_log2) - 1) >> ctb_log2
    ncomp = 3 if chroma else 1
    typ = np.zeros((ncomp, nch, ncw), np.int32)
    band4 = np.zeros((ncomp, nch, ncw, 4), np.int32)
    bandpos = np.zeros((ncomp, nch, ncw), np.int32)
    edge = np.zeros((ncomp, nch, ncw, 5), np.int32)
    eo = np.zeros((ncomp, nch, ncw), np.int32)
    any_on = False
    for meta, sao in recs_list:
        if len(meta) == 0:
            continue
        cx, cy = meta[:, 0], meta[:, 1]
        for c in range(ncomp):
            t = sao[:, c]
            any_on = any_on or bool((t != 0).any())
            typ[c, cy, cx] = t
            off = sao[:, 3 + 5 * c:8 + 5 * c]
            band4[c, cy, cx] = off[:, :4]
            bandpos[c, cy, cx] = sao[:, 18 + c]
            edge[c, cy, cx, :] = off
            eo[c, cy, cx] = sao[:, 21 + c]
    if not any_on:
        return None
    out = {"typ": typ, "band4": band4, "bandpos": bandpos, "edge": edge,
           "eo": eo}
    _add_border_masks(out, entries, ctb_log2, pic_w, pic_h, ncomp)
    return out


def _add_border_masks(out, entries, ctb_log2, pic_w, pic_h, ncomp):
    # entry-border masks per component resolution: rows/cols whose edge
    # filtering is trimmed (ref_sao._edge border rules + nh==1 seam quirk)
    for c in range(ncomp):
        sh = 0 if c == 0 else 1
        W, H = pic_w >> sh, pic_h >> sh
        colm = np.zeros(W, bool)
        rowm = np.zeros(H, bool)
        seam = np.zeros(H, bool)
        for (ex0, ey0, nw, nh) in entries:
            x0 = (ex0 << ctb_log2) >> sh
            x1 = min((((ex0 + nw) << ctb_log2) >> sh), W) - 1
            y0 = (ey0 << ctb_log2) >> sh
            y1 = min((((ey0 + nh) << ctb_log2) >> sh), H) - 1
            colm[x0] = True
            colm[x1] = True
            rowm[y0] = True
            rowm[y1] = True
            if nh == 1:
                m = 6 >> sh
                ys = y0 + min(m, y1 - y0 + 1) - 1
                seam[ys] = True
        colm[W - 1] = True
        rowm[H - 1] = True
        out[f"colm{c}"] = colm
        out[f"rowm{c}"] = rowm | seam
    return out


def sao_plane(xp, plane, c, tabs, ctb_log2, bitdepth):
    """Apply SAO to one plane (int32 in, int32 out).

    Gather-free formulation: per-CTU tables are upsampled to per-sample
    planes by broadcast (repeat), data-dependent table lookups become
    compare/select sums, and neighbour reads are static pad+slice
    shifts."""
    sh = 0 if c == 0 else 1
    H, W = plane.shape
    lg = ctb_log2 - sh
    bd_max = (1 << bitdepth) - 1

    def up(tab):
        # (nch, ncw) per-CTU -> (H, W) per-sample
        t = xp.repeat(xp.repeat(tab, 1 << lg, axis=0), 1 << lg, axis=1)
        return t[:H, :W]

    typ = up(tabs["typ"][c])

    # band: offset = sum_k off_k * (bidx == (band_pos + k) & 31)
    bidx = plane >> (bitdepth - 5)
    boff = xp.zeros_like(plane)
    bp = tabs["bandpos"][c]
    for k in range(4):
        boff = boff + up(tabs["band4"][c][:, :, k]) \
            * (bidx == up((bp + k) & 31))

    # edge: neighbours by static shifts of a 1-padded plane, class select
    if xp is np:
        padded = np.pad(plane, 1, mode="edge")
    else:
        import jax.numpy as jnp

        padded = jnp.pad(plane, 1, mode="edge")

    def shifted(dy, dx):
        return padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    eocl = up(tabs["eo"][c])
    na = xp.zeros_like(plane)
    nb = xp.zeros_like(plane)
    for k, ((ax, ay), (bx, by)) in enumerate(_EO_POS):
        na = na + xp.where(eocl == k, shifted(ay, ax), 0)
        nb = nb + xp.where(eocl == k, shifted(by, bx), 0)
    eidx = 2 + xp.sign(plane - na) + xp.sign(plane - nb)
    eoff = xp.zeros_like(plane)
    for j in range(5):
        eoff = eoff + up(tabs["edge"][c][:, :, j]) * (eidx == j)
    colm = tabs[f"colm{c}"]
    rowm = tabs[f"rowm{c}"]
    trim = (colm[None, :] & (eocl != 1)) | (rowm[:, None] & (eocl != 0))

    out = xp.where(typ == SAO_BAND, plane + boff,
                   xp.where((typ == SAO_EDGE) & ~trim, plane + eoff, plane))
    return xp.clip(out, 0, bd_max)
