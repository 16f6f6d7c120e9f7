"""Bit-exact numpy reference for VVC intra prediction (luma + chroma).

Implements ITU-T H.266 8.4.5.2: reference-sample generation with
availability substitution, [1 2 1] reference smoothing, planar, DC,
angular prediction (cubic/gauss 4-tap for luma, 2-tap linear for chroma),
wide-angle remapping, and PDPC.

Behavior parity: /root/reference/libovvc/rcn_fill_ref.c (fill_ref_left_0 :71,
fill_ref_above_0 :320, filter_ref_samples :48), rcn_intra_dc_planar.c,
rcn_intra_angular.c, rcn_intra.c (vvc_intra_pred :484, chroma :931-1130,
derive_wide_angular_mode :55).

This module is the test oracle for the JAX kernels and the engine of
the numpy decode path used for MD5 verification against the reference binary.
"""

from __future__ import annotations

import numpy as np

from openvvc_tpu.rcn.data_angular import (
    ANGLE_TABLE,
    CUBIC_FILTER,
    GAUSS_FILTER,
    INTRA_FILTER_THR,
    INVERSE_ANGLE_TABLE,
)

OVINTRA_PLANAR = 0
OVINTRA_DC = 1
OVINTRA_HOR = 18
OVINTRA_DIA = 34
OVINTRA_VER = 50
OVINTRA_VDIA = 66

_MODE_SHIFT_TAB = (0, 6, 10, 12, 14, 15)


def derive_wide_angular_mode(log2_w: int, log2_h: int, pred_mode: int) -> int:
    shift = _MODE_SHIFT_TAB[abs(log2_w - log2_h)]
    if log2_w > log2_h and pred_mode < 2 + shift:
        pred_mode += OVINTRA_VDIA - 1
    elif log2_h > log2_w and pred_mode > OVINTRA_VDIA - shift:
        pred_mode -= OVINTRA_VDIA - 1
    return pred_mode


def pdpc_weight(scale: int, pos) -> np.ndarray:
    pos = np.asarray(pos)
    sh = np.minimum(31, (pos << 1) >> scale)
    return np.where(sh < 6, 32 >> np.minimum(sh, 5), 0)


class RefArrays:
    """ref[0]=corner, ref[1..2N]=side samples, with padding both directions."""

    def __init__(self, max_side: int):
        self.off = max_side + 8
        self.buf = np.zeros(3 * max_side + 32, np.int32)

    def __getitem__(self, i):
        return self.buf[self.off + i]

    def __setitem__(self, i, v):
        self.buf[self.off + i] = v

    def view(self, lo, hi):
        return self.buf[self.off + lo : self.off + hi]


def fill_side_refs(
    plane: np.ndarray,
    x0: int,
    y0: int,
    log2_w: int,
    log2_h: int,
    avail_fn,
    bitdepth: int,
    unit: int = 4,
):
    """Build (ref_above, ref_left) with availability substitution.

    avail_fn(x, y) -> bool: sample availability (reconstructed + in tile).
    Parity with fill_ref_left_0 / fill_ref_above_0: sides copied up to the
    last available unit then padded; fully-unavailable side padded from the
    first sample of the other side, or the mid-value.
    """
    w, h = 1 << log2_w, 1 << log2_h
    avg = 1 << (bitdepth - 1)
    ref_a = RefArrays(max(w, h) * 2)
    ref_l = RefArrays(max(w, h) * 2)

    corner_ok = avail_fn(x0 - 1, y0 - 1)
    above_ok = avail_fn(x0, y0 - 1)
    left_ok = avail_fn(x0 - 1, y0)

    len_a = 2 * w  # samples right of corner
    len_l = 2 * h

    # --- left ----------------------------------------------------------
    if left_ok:
        # corner sample
        ref_l[0] = plane[y0 - 1, x0 - 1] if corner_ok else plane[y0, x0 - 1]
        nb_units = (len_l + unit - 1) // unit
        nav = 0
        while nav < nb_units and avail_fn(x0 - 1, y0 + nav * unit):
            nav += 1
        n_avail = nav * unit
        ys = y0 + np.arange(n_avail)
        ref_l.view(1, 1 + n_avail)[:] = plane[ys, x0 - 1]
        pad = ref_l[n_avail] if n_avail else ref_l[0]
        if n_avail < len_l:
            ref_l.view(1 + n_avail, 1 + len_l)[:] = pad
    elif above_ok:
        ref_l.view(0, 1 + len_l)[:] = plane[y0 - 1, x0]
    else:
        ref_l.view(0, 1 + len_l)[:] = avg

    # --- above ---------------------------------------------------------
    if above_ok:
        ref_a[0] = plane[y0 - 1, x0 - 1] if corner_ok else plane[y0 - 1, x0]
        nb_units = (len_a + unit - 1) // unit
        nav = 0
        while nav < nb_units and avail_fn(x0 + nav * unit, y0 - 1):
            nav += 1
        n_avail = nav * unit
        xs = x0 + np.arange(n_avail)
        ref_a.view(1, 1 + n_avail)[:] = plane[y0 - 1, xs]
        pad = ref_a[n_avail] if n_avail else ref_a[0]
        if n_avail < len_a:
            ref_a.view(1 + n_avail, 1 + len_a)[:] = pad
    elif left_ok:
        ref_a.view(0, 1 + len_a)[:] = plane[y0, x0 - 1]
    else:
        ref_a.view(0, 1 + len_a)[:] = avg

    # wide-angle padding beyond 2N (reference pads 4+ extra with last value)
    ref_l.view(1 + len_l, 1 + len_l + 8)[:] = ref_l[len_l]
    ref_a.view(1 + len_a, 1 + len_a + 8)[:] = ref_a[len_a]
    return ref_a, ref_l


def filter_ref_array(ref: RefArrays, other: RefArrays, length: int) -> RefArrays:
    """[1 2 1] reference smoothing (filter_ref_samples parity).

    out[0] uses other[1] across the corner; out[length] copied unfiltered.
    """
    out = RefArrays((len(ref.buf) - 32) // 3)
    src = ref.view(0, length + 1).astype(np.int64)  # ref[0..length]
    # out[i] = (ref[i-1] + 2*ref[i] + ref[i+1] + 2) >> 2 for i in 1..length-1
    out.view(1, length)[:] = (src[:-2] + 2 * src[1:-1] + src[2:] + 2) >> 2
    out[0] = (other[1] + 2 * ref[0] + ref[1] + 2) >> 2
    out[length] = ref[length]
    # keep wide-angle padding
    out.view(length + 1, length + 8)[:] = ref.view(length + 1, length + 8)
    return out


def _bdclip(v, bitdepth):
    return np.clip(v, 0, (1 << bitdepth) - 1)


def intra_planar(ref_a, ref_l, log2_w, log2_h):
    w, h = 1 << log2_w, 1 << log2_h
    top = ref_a.view(1, 1 + w).astype(np.int64)
    left = ref_l.view(1, 1 + h).astype(np.int64)
    top_right = int(ref_a[w + 1])
    bot_left = int(ref_l[h + 1])
    x = np.arange(w)
    y = np.arange(h)[:, None]
    hor = (left[:, None] << log2_w) + (x + 1) * (top_right - left[:, None])
    ver = (top[None, :] << log2_h) + (y + 1) * (bot_left - top[None, :])
    return (
        (hor << log2_h) + (ver << log2_w) + (1 << (log2_w + log2_h))
    ) >> (1 + log2_w + log2_h)


def intra_dc(ref_a, ref_l, log2_w, log2_h):
    w, h = 1 << log2_w, 1 << log2_h
    shift = max(log2_w, log2_h) + (1 if log2_w == log2_h else 0)
    dc = 0
    if log2_w >= log2_h:
        dc += int(ref_a.view(1, 1 + w).sum())
    if log2_w <= log2_h:
        dc += int(ref_l.view(1, 1 + h).sum())
    dc = (dc + ((1 << shift) >> 1)) >> shift
    return np.full((h, w), dc, np.int64)


def pdpc_dc_planar(pred, ref_a, ref_l, log2_w, log2_h, bitdepth):
    w, h = 1 << log2_w, 1 << log2_h
    scale = (log2_w + log2_h - 2) >> 2
    x = np.arange(w)
    y = np.arange(h)
    w_x = pdpc_weight(scale, x)[None, :]
    w_y = pdpc_weight(scale, y)[:, None]
    top = ref_a.view(1, 1 + w).astype(np.int64)[None, :]
    left = ref_l.view(1, 1 + h).astype(np.int64)[:, None]
    val = (w_x * left + w_y * top + (64 - w_x - w_y) * pred + 32) >> 6
    return _bdclip(val, bitdepth)


def _project_negative(ref_main, ref_side, n_proj: int, inv_angle: int, side_len: int):
    """Extend ref_main to negative indices from ref_side via inverse angle."""
    s = 256
    for k in range(-1, -n_proj - 1, -1):
        s += inv_angle
        ref_main[k] = ref_side[min(s >> 9, side_len)]


def intra_angular_core(
    ref_main: RefArrays,
    main_len: int,
    angle_val: int,
    n_lines: int,
    line_len: int,
    filt: str,
    bitdepth: int,
):
    """Directional prediction along the main reference.

    Returns [n_lines, line_len] (line = prediction row for vertical modes,
    column for horizontal modes).  filt: 'cubic' | 'gauss' | 'linear' | 'copy'.
    """
    jj = np.arange(1, n_lines + 1, dtype=np.int64)
    delta = angle_val * jj
    d_int = delta >> 5
    d_frac = delta & 0x1F
    buf = ref_main.buf.astype(np.int64)
    base = ref_main.off
    xs = np.arange(line_len, dtype=np.int64)[None, :]
    if filt == "copy":
        return buf[base + d_int[:, None] + 1 + xs]
    if filt == "linear":
        a = buf[base + d_int[:, None] + 1 + xs]
        b = buf[base + d_int[:, None] + 2 + xs]
        return a + ((d_frac[:, None] * (b - a) + 16) >> 5)
    if filt == "gauss":
        half = d_frac >> 1
        taps = np.stack([16 - half, 32 - half, 16 + half, half], axis=1)
    else:
        taps = np.asarray(CUBIC_FILTER, np.int64)[d_frac]
    idx = base + d_int[:, None] + xs
    acc = (taps[:, 0:1] * buf[idx] + taps[:, 1:2] * buf[idx + 1]
           + taps[:, 2:3] * buf[idx + 2] + taps[:, 3:4] * buf[idx + 3])
    val = (acc + 32) >> 6
    if filt == "cubic":
        val = _bdclip(val, bitdepth)
    return val


def _pdpc_angular(pred, ref_side, inv_angle: int, scale: int, n_lines: int, line_len: int, bitdepth: int):
    """PDPC for positive angular modes (applied along each line)."""
    lim = min(3 << scale, line_len)
    if lim <= 0 or n_lines <= 0:
        return pred
    xs = np.arange(lim, dtype=np.int64)
    w_l = 32 >> np.minimum(31, (xs << 1) >> scale)
    inv_sum = 256 + (xs + 1) * inv_angle
    jj = np.arange(n_lines, dtype=np.int64)[:, None]
    p = ref_side.buf.astype(np.int64)[ref_side.off + jj + (inv_sum >> 9)[None, :] + 1]
    sub = pred[:, :lim]
    pred[:, :lim] = _bdclip(sub + ((w_l[None, :] * (p - sub) + 32) >> 6), bitdepth)
    return pred


def _pdpc_pure(pred, ref_a, ref_l, log2_w, log2_h, vertical: bool, bitdepth: int):
    """PDPC for exactly-horizontal/vertical modes."""
    w, h = 1 << log2_w, 1 << log2_h
    scale = (log2_w + log2_h - 2) >> 2
    tl = int(ref_a[0])
    if vertical:
        wx = pdpc_weight(scale, np.arange(w))[None, :]
        left = ref_l.view(1, 1 + h).astype(np.int64)[:, None]
        top = ref_a.view(1, 1 + w).astype(np.int64)[None, :]
        val = (wx * (left - tl) + (top << 6) + 32) >> 6
    else:
        wy = pdpc_weight(scale, np.arange(h))[:, None]
        left = ref_l.view(1, 1 + h).astype(np.int64)[:, None]
        top = ref_a.view(1, 1 + w).astype(np.int64)[None, :]
        val = (wy * (top - tl) + (left << 6) + 32) >> 6
    return _bdclip(val, bitdepth)


def _pdpc_diagonal(pred, ref_a, ref_l, log2_w, log2_h, vertical: bool, bitdepth: int):
    """PDPC for the exact diagonal modes (2 and 66): inv_angle = 512."""
    n_lines, line_len = pred.shape
    ref_side = ref_l if vertical else ref_a
    scale = min(2, (log2_h if vertical else log2_w) - (_floor_log2(3 * 512 - 2) - 8))
    # note: mode 2/66 have angle 32 -> inverse angle 512
    return _pdpc_angular(pred, ref_side, 512, scale, n_lines, line_len, bitdepth)


def _floor_log2(v: int) -> int:
    return v.bit_length() - 1


def predict_intra(
    plane: np.ndarray,
    x0: int,
    y0: int,
    log2_w: int,
    log2_h: int,
    mode: int,
    avail_fn,
    bitdepth: int,
    luma: bool = True,
) -> np.ndarray:
    """Full intra prediction for one block; returns [h, w] samples."""
    w, h = 1 << log2_w, 1 << log2_h
    unit = 4 if luma else 2
    ref_a, ref_l = fill_side_refs(plane, x0, y0, log2_w, log2_h, avail_fn, bitdepth, unit)

    # chroma planar/DC skip PDPC on 2-wide/2-high blocks (vvc_intra_pred_chroma
    # gates on log2_pb_h > 1 && log2_pb_w > 1; luma blocks are always >= 4)
    pdpc_flat_ok = luma or (log2_w > 1 and log2_h > 1)

    if mode == OVINTRA_PLANAR:
        if luma and (log2_w + log2_h) > 5:
            fa = filter_ref_array(ref_a, ref_l, w + 4)
            fl = filter_ref_array(ref_l, ref_a, h + 4)
            ref_a, ref_l = fa, fl
        pred = intra_planar(ref_a, ref_l, log2_w, log2_h)
        if pdpc_flat_ok:
            return pdpc_dc_planar(pred, ref_a, ref_l, log2_w, log2_h, bitdepth)
        return pred

    if mode == OVINTRA_DC:
        pred = intra_dc(ref_a, ref_l, log2_w, log2_h)
        if pdpc_flat_ok:
            return pdpc_dc_planar(pred, ref_a, ref_l, log2_w, log2_h, bitdepth)
        return pred

    pred_mode = derive_wide_angular_mode(log2_w, log2_h, mode)
    vertical = pred_mode >= OVINTRA_DIA
    if vertical:
        mode_idx = pred_mode - OVINTRA_VER
        ref_main, ref_side = ref_a, ref_l
        n_lines, line_len = h, w
        main_log2, side_log2 = log2_w, log2_h
    else:
        mode_idx = -(pred_mode - OVINTRA_HOR)
        ref_main, ref_side = ref_l, ref_a
        n_lines, line_len = w, h
        main_log2, side_log2 = log2_h, log2_w

    pdpc_dim_ok = log2_h > 1 if luma else (log2_h > 1 and log2_w > 1)
    if luma:
        use_gauss = (log2_w + log2_h) > 5 and abs(mode_idx) > INTRA_FILTER_THR[(log2_w + log2_h) >> 1]
    else:
        use_gauss = False

    def oriented(p):
        return p if vertical else p.T

    if mode_idx == 0:  # pure vertical / horizontal
        pred = np.tile(ref_main.view(1, 1 + line_len), (n_lines, 1))
        if pdpc_dim_ok:
            return _pdpc_pure(pred, ref_a, ref_l, log2_w, log2_h, vertical, bitdepth)
        return oriented(pred)

    if mode_idx == 16:  # exact diagonal (modes 2 / 66)
        rm, rs = ref_main, ref_side
        if use_gauss:
            rm = filter_ref_array(ref_main, ref_side, 2 * line_len)
            rs = filter_ref_array(ref_side, ref_main, 2 * n_lines)
        pred = intra_angular_core(rm, 2 * line_len, 32, n_lines, line_len, "copy", bitdepth)
        if pdpc_dim_ok or use_gauss:
            scale = min(2, (log2_h if vertical else log2_w) - 2)
            pred = _pdpc_angular(pred, rs, 512, scale, n_lines, line_len, bitdepth)
        return oriented(pred)

    abs_angle = ANGLE_TABLE[abs(mode_idx)]
    inv_angle = INVERSE_ANGLE_TABLE[abs(mode_idx)]
    req_frac = bool(abs_angle & 0x1F)
    n_proj = 1 << (log2_h if vertical else log2_w)  # negative-mode projection span
    pdpc_scale = min(2, (log2_h if vertical else log2_w) - (_floor_log2(3 * inv_angle - 2) - 8))

    if use_gauss and not req_frac:
        # integer-slope with smoothing: filtered refs, plain copy
        if mode_idx < 0:
            fm = filter_ref_array(ref_main, ref_side, 2 * line_len)
            fs = filter_ref_array(ref_side, ref_main, 2 * n_lines)
            _project_negative(fm, fs, n_proj, inv_angle, n_proj)
            pred = intra_angular_core(fm, 2 * line_len, -abs_angle, n_lines, line_len, "copy", bitdepth)
        elif pdpc_scale < 0:
            fm = filter_ref_array(ref_main, ref_side, 2 * line_len)
            pred = intra_angular_core(fm, 2 * line_len, abs_angle, n_lines, line_len, "copy", bitdepth)
        else:
            fm = filter_ref_array(ref_main, ref_side, 2 * line_len)
            fs = filter_ref_array(ref_side, ref_main, 2 * n_lines)
            pred = intra_angular_core(fm, 2 * line_len, abs_angle, n_lines, line_len, "copy", bitdepth)
            pred = _pdpc_angular(pred, fs, inv_angle, pdpc_scale, n_lines, line_len, bitdepth)
        return oriented(pred)

    if use_gauss:
        filt = "gauss"
    elif not req_frac:
        filt = "copy"
    else:
        filt = "cubic" if luma else "linear"

    if mode_idx < 0:
        _project_negative(ref_main, ref_side, n_proj, inv_angle, n_proj)
        pred = intra_angular_core(ref_main, 2 * line_len, -abs_angle, n_lines, line_len, filt, bitdepth)
        return oriented(pred)

    pred = intra_angular_core(ref_main, 2 * line_len, abs_angle, n_lines, line_len, filt, bitdepth)
    if pdpc_scale >= 0 and (pdpc_dim_ok if not use_gauss else True):
        pred = _pdpc_angular(pred, ref_side, inv_angle, pdpc_scale, n_lines, line_len, bitdepth)
    return oriented(pred)


def predict_bdpcm(plane, x0, y0, log2_w, log2_h, direction, avail_fn, bitdepth, unit):
    """BDPCM prediction: pure horizontal/vertical copy from unfiltered refs,
    no PDPC (rcn_intra.c vvc_intra_pred :513-523 bdpcm branch)."""
    w, h = 1 << log2_w, 1 << log2_h
    ref_a, ref_l = fill_side_refs(plane, x0, y0, log2_w, log2_h, avail_fn, bitdepth, unit)
    if direction:  # vertical
        return np.tile(ref_a.view(1, 1 + w), (h, 1))
    return np.tile(ref_l.view(1, 1 + h), (w, 1)).T
