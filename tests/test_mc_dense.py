"""Dense whole-frame MC (tpu/mc_dense.py) == the per-block numpy
reference (rcn/ref_mc.py) for uni-prediction from either list, plain
bi-prediction, BCW weights and AMVR half-pel, luma and chroma."""

import numpy as np
import pytest

from openvvc_tpu.rcn import ref_mc
from openvvc_tpu.tpu.mc_dense import PAD_C, PAD_L, mc_dense, prepare_mc_args

# (w0, w1): uni L0, uni L1, plain bi, the four BCW pairs
WEIGHTS = ((8, 0), (0, 8), (4, 4), (-2, 10), (3, 5), (5, 3), (10, -2))


def _pred(refs, lst_args, w, bd, luma, hpel):
    """Reference prediction of one block from its two lists' args."""
    p14 = [ref_mc.interp_14bit(refs[r], x, y, fx, fy, bw, bh, bd, luma,
                               hpel and luma)
           for r, x, y, fx, fy, bw, bh in lst_args]
    if w == (8, 0) or w == (0, 8):
        r, x, y, fx, fy, bw, bh = lst_args[0 if w[0] else 1]
        return ref_mc.mc_uni(refs[r], x, y, fx, fy, bw, bh, bd, luma,
                             hpel and luma)
    if w == (4, 4):
        return ref_mc.mc_bi(p14[0], p14[1], bd)
    return ref_mc.mc_bi_weighted(p14[0], p14[1], bd, 3, w[0], w[1])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("xp_name", ["np", "jnp"])
def test_mc_dense_matches_ref_mc(bd, xp_name):
    rng = np.random.RandomState(bd)
    uw, uh, nref = 12, 8, 2
    H, W = uh * 4, uw * 4
    ry = [rng.randint(0, 1 << bd, (H, W)) for _ in range(nref)]
    rcb = [rng.randint(0, 1 << bd, (H // 2, W // 2)) for _ in range(nref)]
    rcr = [rng.randint(0, 1 << bd, (H // 2, W // 2)) for _ in range(nref)]

    gmv = np.zeros((uh, uw, 2, 2), np.int32)
    gref = np.zeros((uh, uw, 2), np.int8)
    gw = np.zeros((uh, uw, 2), np.int8)
    ghpel = np.zeros((uh, uw), np.int8)
    want_y = np.zeros((H, W), np.int64)
    want_cb = np.zeros((H // 2, W // 2), np.int64)
    want_cr = np.zeros((H // 2, W // 2), np.int64)
    # 8x8 prediction blocks (2x2 units) with their own motion; MVs reach
    # 16 px past the picture so the edge replication is exercised
    for i, (py, px) in enumerate((py, px) for py in range(0, uh, 2)
                                 for px in range(0, uw, 2)):
        w = WEIGHTS[i % len(WEIGHTS)]
        hpel = i % 5 == 4
        mv = rng.randint(-256, 257, (2, 2))
        if hpel:
            mv = mv & ~7  # AMVR half-pel MVs sit on the 1/2 grid
        rf = rng.randint(0, nref, 2)
        sl = np.s_[py:py + 2, px:px + 2]
        gmv[sl] = mv
        gref[sl] = rf
        gw[sl] = w
        ghpel[sl] = hpel
        x0, y0 = px * 4, py * 4
        lum = [(rf[l], x0 + (mv[l, 0] >> 4), y0 + (mv[l, 1] >> 4),
                mv[l, 0] & 15, mv[l, 1] & 15, 8, 8) for l in (0, 1)]
        chr_ = [(rf[l], (x0 >> 1) + (mv[l, 0] >> 5),
                 (y0 >> 1) + (mv[l, 1] >> 5), mv[l, 0] & 31,
                 mv[l, 1] & 31, 4, 4) for l in (0, 1)]
        want_y[y0:y0 + 8, x0:x0 + 8] = _pred(ry, lum, w, bd, True, hpel)
        cs = np.s_[y0 >> 1:(y0 >> 1) + 4, x0 >> 1:(x0 >> 1) + 4]
        want_cb[cs] = _pred(rcb, chr_, w, bd, False, hpel)
        want_cr[cs] = _pred(rcr, chr_, w, bd, False, hpel)

    lut = np.arange(16, dtype=np.int32) % nref
    margs = prepare_mc_args(gmv, gref, gw, ghpel, lut, lut, uw, uh)
    stack = lambda planes, pad: np.stack(
        [np.pad(p, pad, mode="edge") for p in planes]).astype(np.int16)
    sy, scb, scr = stack(ry, PAD_L), stack(rcb, PAD_C), stack(rcr, PAD_C)
    if xp_name == "np":
        xp = np
    else:
        import jax
        import jax.numpy as jnp

        xp = jnp
        sy, scb, scr, margs = jax.device_put((sy, scb, scr, margs))
    py_, pcb, pcr = mc_dense(xp, sy, scb, scr, margs, bd, uw, uh)
    np.testing.assert_array_equal(np.asarray(py_), want_y)
    np.testing.assert_array_equal(np.asarray(pcb), want_cb)
    np.testing.assert_array_equal(np.asarray(pcr), want_cr)
