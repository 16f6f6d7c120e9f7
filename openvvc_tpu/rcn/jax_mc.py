"""Batched JAX motion-compensation kernels (bit-exact vs rcn/ref_mc.py).

One unified separable-FIR kernel covers pel/h/v/hv: frac 0 maps to an
identity filter row (64 at the centre tap), which reproduces the scalar
copy/one-pass paths exactly under the reference's shift structure
(rcn_mc.c :380-1360):  h pass >> (bd-8), int16 wrap, v pass >> 6.
A batch shares (w, h, plane-type); per-block (x, y, frac_x, frac_y) are
data, so one compiled kernel serves every MV in a frame — the gather +
two tensor contractions run with no per-block control flow.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from openvvc_tpu.rcn.data_mc import (
    BILINEAR_FILTERS,
    MC_FILTERS_4,
    MC_FILTERS_C,
    MC_FILTERS_L,
)


def _with_identity(table: np.ndarray, centre: int) -> np.ndarray:
    """Prepend the frac-0 identity row (64 at `centre`)."""
    ident = np.zeros((1, table.shape[1]), np.int32)
    ident[0, centre] = 64
    return np.concatenate([ident, table], axis=0)


# luma rows: 0=identity, 1..15=qpel fracs, 16=half-pel AMVR 6-tap
_NP_FILT_L = _with_identity(MC_FILTERS_L, 3)
_NP_FILT_4 = _with_identity(MC_FILTERS_4, 3)
_NP_FILT_C = _with_identity(MC_FILTERS_C, 1)
_NP_FILT_BLN = _with_identity(BILINEAR_FILTERS * 4, 0)  # 16*4=64 at tap 0

# device copies are materialized per use: a module-level jnp.asarray would
# spin up the device client at import for numpy-only callers, and caching the
# result would leak tracers when first touched inside a jit trace


class _LazyTable:
    def __init__(self, name):
        self._name = name

    def __getitem__(self, idx):
        return jnp.asarray(globals()["_NP" + self._name])[idx]


_FILT_L = _LazyTable("_FILT_L")
_FILT_4 = _LazyTable("_FILT_4")
_FILT_C = _LazyTable("_FILT_C")
_FILT_BLN = _LazyTable("_FILT_BLN")


def interp_14bit_np(plane, xs, ys, fxs, fys, w, h, bitdepth, luma=True,
                    hpel=False):
    """Numpy twin of interp_14bit_batch (same math, vectorized host path)."""
    if luma:
        table = _NP_FILT_4 if (w == 4 and h == 4) else _NP_FILT_L
        taps, before = 8, 3
        if hpel:
            fxs = np.where(fxs == 8, 16, fxs)
            fys = np.where(fys == 8, 16, fys)
    else:
        table, taps, before = _NP_FILT_C, 4, 1
    fh = table[fxs]
    fv = table[fys]
    H, W = plane.shape
    yy = np.clip(ys[:, None] - before + np.arange(h + taps - 1)[None, :], 0, H - 1)
    xx = np.clip(xs[:, None] - before + np.arange(w + taps - 1)[None, :], 0, W - 1)
    p = plane[yy[:, :, None], xx[:, None, :]].astype(np.int32)
    sh1 = bitdepth - 8
    tmp = fh[:, 0, None, None] * p[:, :, 0:w]
    for i in range(1, taps):
        tmp += fh[:, i, None, None] * p[:, :, i : i + w]
    tmp >>= sh1
    tmp = tmp.astype(np.int16).astype(np.int32)
    out = fv[:, 0, None, None] * tmp[:, 0:h, :]
    for i in range(1, taps):
        out += fv[:, i, None, None] * tmp[:, i : i + h, :]
    return out >> 6


def _bd_clip(v, bitdepth):
    return jnp.clip(v, 0, (1 << bitdepth) - 1)


def _patches(plane, xs, ys, w, h, before, ext):
    """[N, h+ext, w+ext] gather with edge clamp (border extension parity)."""
    H, W = plane.shape
    yy = jnp.clip(ys[:, None] - before + jnp.arange(h + ext)[None, :], 0, H - 1)
    xx = jnp.clip(xs[:, None] - before + jnp.arange(w + ext)[None, :], 0, W - 1)
    return plane[yy[:, :, None], xx[:, None, :]]


def _sep_fir(patch, fh, fv, taps, w, h, sh1):
    """Separable FIR with the reference's shift/int16 structure."""
    p = patch.astype(jnp.int32)
    tmp = sum(fh[:, i, None, None] * p[:, :, i : i + w] for i in range(taps)) >> sh1
    tmp = tmp.astype(jnp.int16).astype(jnp.int32)
    return sum(fv[:, i, None, None] * tmp[:, i : i + h, :] for i in range(taps)) >> 6


def interp_14bit_jit(plane, xs, ys, fxs, fys, w, h, bitdepth, luma=True,
                     hpel=False):
    """Jitted interp_14bit_batch (one compile per (w, h, luma, hpel) class)."""
    import jax

    global _INTERP_JIT
    if _INTERP_JIT is None:
        _INTERP_JIT = jax.jit(
            interp_14bit_batch,
            static_argnames=("w", "h", "bitdepth", "luma", "hpel"))
    return _INTERP_JIT(plane, xs, ys, fxs, fys, w=w, h=h, bitdepth=bitdepth,
                       luma=luma, hpel=hpel)


_INTERP_JIT = None


def interp_14bit_batch(plane, xs, ys, fxs, fys, w, h, bitdepth, luma=True,
                       hpel=False):
    """14-bit MC intermediates for N blocks: [N, h, w] int32.

    plane [H, W]; xs/ys/fxs/fys [N] int32. For luma, frac in 1/16 units;
    hpel remaps frac 8 to the 6-tap AMVR filter. Blocks of the batch share
    (w, h); the 4x4 affine filter variant is selected statically.
    """
    if luma:
        table = _FILT_4 if (w == 4 and h == 4) else _FILT_L
        taps, before = 8, 3
        if hpel:
            fxs = jnp.where(fxs == 8, 16, fxs)
            fys = jnp.where(fys == 8, 16, fys)
    else:
        table, taps, before = _FILT_C, 4, 1
    fh = table[fxs]
    fv = table[fys]
    patch = _patches(plane, xs, ys, w, h, before, taps - 1)
    return _sep_fir(patch, fh, fv, taps, w, h, bitdepth - 8)


def mc_uni_batch(plane, xs, ys, fxs, fys, w, h, bitdepth, luma=True, hpel=False):
    """Uni-pred samples [N, h, w] (put_vvc_*_uni_* parity)."""
    p = interp_14bit_batch(plane, xs, ys, fxs, fys, w, h, bitdepth, luma, hpel)
    shift = 14 - bitdepth
    return _bd_clip((p + (1 << (shift - 1))) >> shift, bitdepth).astype(jnp.int32)


def mc_bi_batch(p0, p1, bitdepth):
    shift = 15 - bitdepth
    return _bd_clip((p0 + p1 + (1 << (shift - 1))) >> shift, bitdepth).astype(jnp.int32)


def mc_bi_weighted_batch(p0, p1, bitdepth, denom, w0, w1):
    """BCW weights per block: denom scalar, w0/w1 [N] (or scalars)."""
    shift = 14 - bitdepth + denom
    off = 1 << (shift - 1)
    w0 = jnp.asarray(w0).reshape(-1, 1, 1)
    w1 = jnp.asarray(w1).reshape(-1, 1, 1)
    return _bd_clip((p0 * w0 + p1 * w1 + off) >> shift, bitdepth).astype(jnp.int32)


def dmvr_bilinear_batch(plane, xs, ys, fxs, fys, w, h, bitdepth):
    """DMVR 2-tap search predictor, 10-bit domain [N, h, w].

    Uses the same identity-row trick: taps are scaled x4 so the frac-0 row
    is 64 and every pass carries the uniform >>-structure of the scalar
    path (ref_mc.dmvr_bilinear parity, verified elementwise)."""
    # scalar: pass1 (2-tap + off1) >> shift1 with taps summing 16;
    # here taps are x4 (sum 64): (sum*4 + 4*off1) >> (shift1+2) is exact.
    shift1 = (4 - (10 - bitdepth)) + 2
    fh = _FILT_BLN[fxs]
    fv = _FILT_BLN[fys]
    H, W = plane.shape
    yy = jnp.clip(ys[:, None] + jnp.arange(h + 1)[None, :], 0, H - 1)
    xx = jnp.clip(xs[:, None] + jnp.arange(w + 1)[None, :], 0, W - 1)
    p = plane[yy[:, :, None], xx[:, None, :]].astype(jnp.int32)
    off1 = 1 << (shift1 - 1)
    tmp = (sum(fh[:, i, None, None] * p[:, :, i : i + w] for i in range(2)) + off1) >> shift1
    off2 = 1 << 5
    out = (sum(fv[:, i, None, None] * tmp[:, i : i + h, :] for i in range(2)) + off2) >> 6
    return out.astype(jnp.int32)
