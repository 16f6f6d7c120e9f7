"""Film grain synthesis (SMPTE RDD-5 model) — output post-processing.

Behavioral parity with the reference's fg_grain_apply_pic
(/root/reference/libovvc/pp_film_grain.c:666-978) as invoked from its
output path (post_proc.c:107: isIdrPic=0, deblocking enabled, per-picture
copy of the SEI struct so the in-place 4:2:0 model-value conversion never
compounds across pictures). Notable reference behaviors mirrored exactly:

- bitDepth is hardcoded to 10 in the apply loop regardless of the coded
  bit depth (pp_film_grain.c:834 "BITDEPTH: only for 10-bits");
- the intensity-interval table is built over all 8 slots whether parsed
  or not (zero-filled slots map intensity 0 to the LAST zero slot);
- colour offsets follow the code (comp1 -> 85, comp2 -> 170);
- the per-picture PRNG advances once per 16x16 block, per component,
  continuing across stripes.

The grain databases (13x13 cutoff pairs of 64x64 int8 fields) are
generated once from the RDD-5 constant tables (data_fg.npz, see
tools/extract_fg_tables.py) via two exact integer 64x64 matrix products —
pure matrix work, done here in numpy at init (a few ms total).
"""

from __future__ import annotations

import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "data_fg.npz")

_GRAIN_SCALE = 6
_COLOR_OFFSET = (0, 85, 170)
_NUM_FREQ = 13
_DB_SIZE = 64

_db_cache: dict[bool, np.ndarray] = {}


def _prng(x: int) -> int:
    add = (1 + (1 if x & 4 else 0) + (1 if x & (1 << 30) else 0)) % 2
    return ((x << 1) + add) & 0xFFFFFFFF


def _clip_intp2_8(v: np.ndarray) -> np.ndarray:
    return np.clip(v, -127, 127)


def _gen_database(deblock: bool) -> np.ndarray:
    """[13, 13, 64, 64] int32 grain fields, index [h][v][y][x]
    (pp_film_grain.c fg_data_base_generation :666)."""
    if deblock in _db_cache:
        return _db_cache[deblock]
    d = np.load(_NPZ)
    gauss = d["gaussian"].astype(np.int32)
    seed = d["seed"]
    r64 = d["r64_idct"].astype(np.int64)
    debl = d["deblock_factor"].astype(np.int32)

    db = np.zeros((_NUM_FREQ, _NUM_FREQ, _DB_SIZE, _DB_SIZE), np.int32)
    for h in range(_NUM_FREQ):
        for v in range(_NUM_FREQ):
            fh = ((h + 3) << 2) - 1
            fv = ((v + 3) << 2) - 1
            b = np.zeros((_DB_SIZE, _DB_SIZE), np.int64)
            ehv = int(seed[h + v * 13])
            for l in range(fv + 1):
                for k in range(0, fh + 1, 4):
                    b[k, l] = gauss[ehv % 2048]
                    b[k + 1, l] = gauss[(ehv + 1) % 2048]
                    b[k + 2, l] = gauss[(ehv + 2) % 2048]
                    b[k + 3, l] = gauss[(ehv + 3) % 2048]
                    ehv = _prng(ehv)
            b[0, 0] = 0
            bidct = (r64.T @ b + 128) >> 8
            grain = (bidct @ r64 + 128) >> 8
            # stored transposed: fg_data_base[h][v][j][i] = grain[i][j]
            db[h, v] = _clip_intp2_8(grain.T).astype(np.int32)
    if deblock:
        # horizontal 8x8 edge rows (l and l+7) scaled by deblockFactor[v]
        rows = np.asarray([r for base in range(0, _DB_SIZE, 8)
                           for r in (base, base + 7)])
        fac = debl[None, :, None, None]  # per v
        scaled = (db[:, :, rows, :].astype(np.int8).astype(np.int32)
                  * fac) >> 7
        db[:, :, rows, :] = scaled
    _db_cache[deblock] = db
    return db


def _model_tables(fg):
    """Intensity-interval map + converted model values, from a fresh copy
    (fg_compute_model_values :771 — mutation stays picture-local)."""
    interval = np.full((3, 256), -1, np.int16)
    values = np.zeros((3, 8, 3), np.int32)
    for c in range(3):
        if not fg.fg_comp_model_present_flag[c]:
            continue
        n_vals = fg.fg_num_model_values_minus1[c] + 1
        lowers = fg.fg_intensity_interval_lower_bound[c]
        uppers = fg.fg_intensity_interval_upper_bound[c]
        for it in range(8):
            lo = int(lowers[it]) if it < len(lowers) else 0
            up = int(uppers[it]) if it < len(uppers) else 0
            interval[c, lo : up + 1] = it
            row = fg.fg_comp_model_value[c][it] \
                if it < len(fg.fg_comp_model_value[c]) else []
            vals = [int(row[j]) if j < len(row) else 0 for j in range(3)]
            if n_vals == 1:
                vals[1] = 8
                vals[2] = vals[1]
            elif n_vals == 2:
                vals[2] = vals[1]
            if c > 0:  # 4:2:0 down-conversion
                vals[0] >>= 1
                vals[1] = min(max(2, vals[1] << 1), 14)
                vals[2] = min(max(2, vals[2] << 1), 14)
            values[c, it] = vals
    return interval, values


def apply_film_grain(planes, fg, poc: int, deblock: bool = True):
    """Return post-processed (y, cb, cr) int32 planes; inputs unmodified.

    planes: (y, cb, cr) numpy int32 (cb/cr may be None for mono).
    fg: parsed FilmGrainSEI. poc: picture order count.
    """
    y, cb, cr = planes
    if fg.fg_characteristics_cancel_flag:
        return y.copy(), (cb.copy() if cb is not None else None), \
            (cr.copy() if cr is not None else None)
    db = _gen_database(deblock)
    seed_lut = np.load(_NPZ)["seed"]
    interval, values = _model_tables(fg)
    bit_depth = 10  # reference hardcodes 10 regardless of coded depth
    log2_scale = fg.fg_log2_scale_factor
    out = []
    for c, src in enumerate((y, cb, cr)):
        if src is None:
            out.append(None)
            continue
        if not fg.fg_comp_model_present_flag[c]:
            out.append(src.copy())
            continue
        hgt, wdt = src.shape
        dst = src.copy()
        ec = int(seed_lut[(poc + _COLOR_OFFSET[c]) % 256])
        for y0 in range(0, hgt, 16):
            stripe = np.zeros((16, wdt), np.int64)
            for x0 in range(0, wdt, 16):
                for blk in range(4):
                    by = (blk >> 1) * 8
                    bx = (blk & 1) * 8
                    ys = min(8, hgt - y0 - by)
                    xs = min(8, wdt - x0 - bx)
                    if ys <= 0 or xs <= 0:
                        continue
                    blk_src = src[y0 + by : y0 + by + ys,
                                  x0 + bx : x0 + bx + xs]
                    avg = min(int(blk_src.sum()) // (ys * xs)
                              >> (bit_depth - 8), 255)
                    avg = max(avg, 0)
                    it = int(interval[c, avg])
                    if it == -1:
                        continue
                    k_off = ((ec >> 16) % 52) & 0xFFFC
                    k_off += (x0 + bx) & 8
                    l_off = ((ec & 0xFFFF) % 56) & 0xFFF8
                    l_off += (y0 + by) & 8
                    scale = -values[c, it, 0] if ec & 1 else values[c, it, 0]
                    h = values[c, it, 1] - 2
                    v = values[c, it, 2] - 2
                    g = db[h, v, l_off : l_off + ys, k_off : k_off + xs]
                    stripe[by : by + ys, x0 + bx : x0 + bx + xs] = \
                        (int(scale) * g.astype(np.int64)) \
                        >> (log2_scale + _GRAIN_SCALE)
                ec = _prng(ec)
            if deblock and wdt > 8:
                # vertical 8x8 edges across the stripe
                # (fg_deblock_grain_stripe :598)
                for p in range(0, wdt - 8, 8):
                    l1 = stripe[:, p + 6].copy()
                    l0 = stripe[:, p + 7].copy()
                    r0 = stripe[:, p + 8].copy()
                    r1 = stripe[:, p + 9].copy()
                    stripe[:, p + 8] = (l0 + (r0 << 1) + r1) >> 2
                    stripe[:, p + 7] = (l1 + (l0 << 1) + r0) >> 2
            rows = min(16, hgt - y0)
            blend = (stripe[:rows] << (bit_depth - 8)) + src[y0 : y0 + rows]
            dst[y0 : y0 + rows] = np.clip(blend, 0, (1 << bit_depth) - 1)
        out.append(dst)
    return tuple(out)
