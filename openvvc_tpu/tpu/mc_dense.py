"""Dense whole-frame inter prediction over the per-4x4-unit motion grid.

Every 4x4 luma unit (and its collocated 2x2 chroma unit) carries the
PU-clipped MV, reference indices, and BCW/uni/bi weights emitted by
ov_build_ir. The host turns the grid into flat per-unit window origins +
fraction codes (prepare_mc_args, cheap numpy); the device side is pure
slice-gathers — jax.vmap(lax.dynamic_slice) windows from the edge-padded
reference stack in device memory — separable 8/4-tap FIRs with inline tap
selection, and one weighted combine. No element-indexed gathers: indices
are host-side args and the windows are dynamic-slices.

Parity: put_vvc_qpel/epel_* via rcn/ref_mc.py (ref anchor
/root/reference/libovvc/rcn_mc.c:448-720, rcn_inter.c:521-760). The
unified weight form is exact: uni == (8,0) under shift 17-bd, plain
bi == (4,4), BCW == (8-w, w) — each reduces to the reference's rounding.
"""

from __future__ import annotations

import numpy as np

from openvvc_tpu.rcn.jax_mc import _NP_FILT_C, _NP_FILT_L

# padding margins for the reference stacks: luma window start is bounded by
# clip_mv to [-(pb_w + 6), pic_w - 1 + pb_w] with pb <= 128 (rcn/pipeline.py
# _clip_mv); 144 covers both sides incl. the 8-tap lookahead
PAD_L = 144
PAD_C = 80


def prepare_mc_args(gmv, gref, gw, ghpel, lut0, lut1, uw, uh, glist=None):
    """Host: dense grids -> flat per-unit slice origins and fraction codes.

    Returns dict of numpy arrays (all length N = uh*uw):
      sl{l}, yb{l}, xb{l} (int32/int16): luma window origin per list l;
      f{l} (uint8): fx | fy<<4 luma fraction code (after hpel remap 8->16
          is NOT applied here — code 16 needs 5 bits, so hpel rides bit 7
          of fx/fy nibbles... instead fractions are sent as two uint8);
      plus chroma origins/fractions. Weights w0/w1 int8.
    """
    N = uh * uw
    uy, ux = np.divmod(np.arange(N, dtype=np.int32), uw)
    hp = ghpel.reshape(N).astype(np.int32)
    out = {"w0": gw[:, :, 0].reshape(N).astype(np.int8),
           "w1": gw[:, :, 1].reshape(N).astype(np.int8)}
    for lst, lut in ((0, lut0), (1, lut1)):
        mvx = gmv[:, :, lst, 0].reshape(N).astype(np.int32)
        mvy = gmv[:, :, lst, 1].reshape(N).astype(np.int32)
        ref = gref[:, :, lst].reshape(N).astype(np.int32)
        refc = np.clip(ref, 0, 15)
        if glist is None:
            slot = lut[refc]
        else:
            # per-unit list for each MC slot (GPM: both partitions may
            # resolve through the same list with different refs)
            gl = glist[:, :, lst].reshape(N)
            slot = np.where(gl == 0, lut0[refc], lut1[refc])
        fx = mvx & 15
        fy = mvy & 15
        fx = np.where((hp != 0) & (fx == 8), 16, fx)
        fy = np.where((hp != 0) & (fy == 8), 16, fy)
        out[f"sl{lst}"] = slot.astype(np.int16)
        out[f"yb{lst}"] = (uy * 4 + (mvy >> 4) - 3 + PAD_L).astype(np.int16)
        out[f"xb{lst}"] = (ux * 4 + (mvx >> 4) - 3 + PAD_L).astype(np.int16)
        out[f"fx{lst}"] = fx.astype(np.uint8)
        out[f"fy{lst}"] = fy.astype(np.uint8)
        out[f"cyb{lst}"] = (uy * 2 + (mvy >> 5) - 1 + PAD_C).astype(np.int16)
        out[f"cxb{lst}"] = (ux * 2 + (mvx >> 5) - 1 + PAD_C).astype(np.int16)
        out[f"cfx{lst}"] = (mvx & 31).astype(np.uint8)
        out[f"cfy{lst}"] = (mvy & 31).astype(np.uint8)
    return out


def _taps(xp, table, frac, k):
    """Tap k for each unit: select-sum over the (nfrac, ntap) table —
    avoids an element gather; nfrac * N compares."""
    acc = xp.zeros(frac.shape, xp.int32)
    for j in range(table.shape[0]):
        t = int(table[j, k])
        if t:
            acc = acc + xp.where(frac == j, t, 0)
    return acc


def _interp_list(xp, stack, sl, yb, xb, fx, fy, bw, taps, bd, table):
    """14-bit separable FIR for N bw x bw blocks via slice-gather windows."""
    ext = bw + taps - 1
    if xp is np:
        S, Hp, Wp = stack.shape
        rr = np.arange(ext)
        yy = np.clip(yb.astype(np.int32)[:, None] + rr[None, :], 0, Hp - 1)
        xx = np.clip(xb.astype(np.int32)[:, None] + rr[None, :], 0, Wp - 1)
        patch = stack[sl.astype(np.int32)[:, None, None], yy[:, :, None],
                      xx[:, None, :]].astype(np.int32)
    else:
        import jax

        def one(s, y, x):
            return jax.lax.dynamic_slice(
                stack, (s.astype(xp.int32), y.astype(xp.int32),
                        x.astype(xp.int32)), (1, ext, ext))

        patch = jax.vmap(one)(sl, yb, xb)[:, 0].astype(xp.int32)
    fx = fx.astype(xp.int32)
    fy = fy.astype(xp.int32)
    sh1 = bd - 8
    tmp = _taps(xp, table, fx, 0)[:, None, None] * patch[:, :, 0:bw]
    for k in range(1, taps):
        tmp = tmp + _taps(xp, table, fx, k)[:, None, None] \
            * patch[:, :, k:k + bw]
    tmp = (tmp >> sh1).astype(xp.int16).astype(xp.int32)
    out = _taps(xp, table, fy, 0)[:, None, None] * tmp[:, 0:bw, :]
    for k in range(1, taps):
        out = out + _taps(xp, table, fy, k)[:, None, None] \
            * tmp[:, k:k + bw, :]
    return out >> 6


def mc_dense(xp, stack_y, stack_cb, stack_cr, margs, bd, uw, uh,
             chroma=True):
    """Whole-frame prediction planes from host-prepared MC args.

    stack_*: (S, Hp, Wp) int16 edge-padded reference stacks. margs: output
    of prepare_mc_args (device arrays under jit). Returns (pred_y, pred_cb,
    pred_cr) int32, valid where the unit is inter-coded.
    """
    w0 = margs["w0"].astype(xp.int32)
    w1 = margs["w1"].astype(xp.int32)

    p14 = []
    pc14 = []
    for lst in (0, 1):
        p14.append(_interp_list(
            xp, stack_y, margs[f"sl{lst}"], margs[f"yb{lst}"],
            margs[f"xb{lst}"], margs[f"fx{lst}"], margs[f"fy{lst}"],
            4, 8, bd, _NP_FILT_L))
        if chroma:
            pcs = []
            for st in (stack_cb, stack_cr):
                pcs.append(_interp_list(
                    xp, st, margs[f"sl{lst}"], margs[f"cyb{lst}"],
                    margs[f"cxb{lst}"], margs[f"cfx{lst}"],
                    margs[f"cfy{lst}"], 2, 4, bd, _NP_FILT_C))
            pc14.append(pcs)

    shift = 17 - bd
    off = 1 << (shift - 1)
    bd_max = (1 << bd) - 1

    wp = margs.get("wp")
    if wp is not None:
        # per-sample weights (GPM ramps; broadcast w0 elsewhere): w1 is
        # always 8 - w0 in the unified form (uni (8,0)/(0,8), bi (4,4),
        # BCW 8-w/w, GPM ramp w/(8-w))
        wpl = wp.astype(xp.int32)           # (N, 4, 4)
        wpc = wpl[:, ::2, ::2]              # (N, 2, 2): luma even samples

        def comb_w(a, b, we):
            v = (a * we + b * (8 - we) + off) >> shift
            return xp.clip(v, 0, bd_max)

        comb_l = lambda a, b: comb_w(a, b, wpl)
        comb_c = lambda a, b: comb_w(a, b, wpc)
    else:
        def comb(a, b):
            v = (a * w0[:, None, None] + b * w1[:, None, None] + off) \
                >> shift
            return xp.clip(v, 0, bd_max)

        comb_l = comb_c = comb

    py = comb_l(p14[0], p14[1]).reshape(uh, uw, 4, 4)
    pred_y = py.transpose(0, 2, 1, 3).reshape(uh * 4, uw * 4)
    if not chroma:
        return pred_y, None, None
    pcb = comb_c(pc14[0][0], pc14[1][0]).reshape(uh, uw, 2, 2)
    pcr = comb_c(pc14[0][1], pc14[1][1]).reshape(uh, uw, 2, 2)
    pred_cb = pcb.transpose(0, 2, 1, 3).reshape(uh * 2, uw * 2)
    pred_cr = pcr.transpose(0, 2, 1, 3).reshape(uh * 2, uw * 2)
    return pred_y, pred_cb, pred_cr


def pad_plane(xp, plane, pad):
    """Edge-replicated padding (emulate_block_border parity by clamp)."""
    if xp is np:
        return np.pad(plane, pad, mode="edge")
    import jax.numpy as jnp

    return jnp.pad(plane, pad, mode="edge")
