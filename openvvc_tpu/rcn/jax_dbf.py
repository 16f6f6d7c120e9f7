"""Whole-frame deblocking as batched segment kernels (device or vectorized host).

The scalar reference (rcn/ref_dbf.py, itself oracle bit-exact vs
/root/reference/libovvc/rcn_df.c) processes 4-line edge segments one by one.
This module re-expresses each pass as ONE batched computation over all
active segments: the spec guarantees that within a pass (all vertical
edges, then all horizontal edges) every segment reads pre-pass samples and
writes a sample set disjoint from every other segment's (filter lengths are
capped by edge spacing), so a gather -> filter -> masked scatter-add is
exactly equivalent to the sequential loop.

Segment parameters (beta/tc/max filter lengths) depend only on the edge/bs/
qp maps — derived host-side with numpy; the sample math runs as one
batched kernel per direction (jnp on device, np on host — same code).
"""

from __future__ import annotations

import numpy as np

from openvvc_tpu.rcn.ref_dbf import _BETA_LUT, _TC_LUT, DbfMaps, _beta_tc_offsets

# mid-sample weight vectors for the long filter, col layout [p7..p0,q0..q7],
# mid = (dot(win, W) + 8) >> 4; rows indexed by 3*mp+mq with m=(len-3)//2
_MIDW = np.zeros((9, 16), np.int32)


def _set_midw(lp, lq, pw, qw):
    row = ((lp - 3) >> 1) * 3 + ((lq - 3) >> 1)
    _MIDW[row, :8] = pw[::-1]  # p7..p0
    _MIDW[row, 8:] = qw


_set_midw(7, 7, [2, 1, 1, 1, 1, 1, 1, 0], [2, 1, 1, 1, 1, 1, 1, 0])
_set_midw(7, 5, [2, 2, 1, 1, 1, 1, 0, 0], [2, 2, 1, 1, 1, 1, 0, 0])
_set_midw(5, 7, [2, 2, 1, 1, 1, 1, 0, 0], [2, 2, 1, 1, 1, 1, 0, 0])
_set_midw(5, 5, [2, 2, 2, 1, 1, 0, 0, 0], [2, 2, 2, 1, 1, 0, 0, 0])
_set_midw(7, 3, [2, 1, 1, 1, 1, 1, 1, 0], [3, 3, 2, 0, 0, 0, 0, 0])
_set_midw(3, 7, [3, 3, 2, 0, 0, 0, 0, 0], [2, 1, 1, 1, 1, 1, 1, 0])
_set_midw(5, 3, [2, 2, 2, 2, 0, 0, 0, 0], [2, 2, 2, 2, 0, 0, 0, 0])
_set_midw(3, 5, [2, 2, 2, 2, 0, 0, 0, 0], [2, 2, 2, 2, 0, 0, 0, 0])

# long-filter position weights / tc weights, rows by (len-3)//2
_WPL = np.array([[53, 32, 11, 0, 0, 0, 0],
                 [58, 45, 32, 19, 6, 0, 0],
                 [59, 50, 41, 32, 23, 14, 5]], np.int32)
_TPL = np.array([[6, 4, 2, 0, 0, 0, 0],
                 [6, 5, 4, 3, 2, 0, 0],
                 [6, 5, 4, 3, 2, 1, 1]], np.int32)

_BETA_ARR = np.asarray(_BETA_LUT, np.int32)
_TC_ARR = np.asarray(_TC_LUT, np.int32)


def _limits_vec(qp, bs, beta_off, tc_off, bitdepth):
    """Vectorized _limits (ref_dbf._limits parity)."""
    b_idx = np.clip(qp + beta_off, 0, 63)
    t_idx = np.clip(qp + 2 * (bs - 1) + tc_off, 0, 65)
    beta = _BETA_ARR[b_idx] << (bitdepth - 8)
    tc_v = _TC_ARR[t_idx]
    if bitdepth < 10:
        tc_v = (tc_v + (1 << (9 - bitdepth))) >> (10 - bitdepth)
    else:
        tc_v = tc_v << (bitdepth - 10)
    return beta, tc_v


def _window_any(edge, lo_off, hi_off, axis):
    """any(edge[.., u+lo_off : u+hi_off]) per position u along axis."""
    e = edge.astype(np.int32)
    c = np.cumsum(e, axis=axis)
    c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c], axis=axis)
    n = edge.shape[axis]
    idx = np.arange(n)
    lo = np.clip(idx + lo_off, 0, n)
    hi = np.clip(idx + hi_off, 0, n)
    return (np.take(c, hi, axis=axis) - np.take(c, lo, axis=axis)) > 0


def luma_segment_params(maps: DbfMaps, beta_off, tc_off, bitdepth,
                        pic_w, pic_h, no_x=(), no_y=(), dense=False,
                        log2_ctb=6):
    """(vertical, horizontal) segment param dicts from the edge maps.

    Mirrors ref_dbf.deblock_plane_luma's per-segment derivation, vectorized.
    Each dict: xs, ys (sample coords of the edge), beta, tc, mlp, mlq.
    With dense=True, returns full boundary-grid param arrays instead
    (beta/tc zeroed where inactive) for the gather-free device pass.
    """
    uw, uh = pic_w // 4, pic_h // 4
    out = []
    for direction in ("ver", "hor"):
        if direction == "ver":
            edge = maps.edge_ver[:uh, : uw + 1]
            sbe = maps.sb_edge_ver[:uh, : uw + 1]
            bs2 = maps.bs2_ver[:uh, : uw + 1]
            bs1 = maps.bs1_ver[:uh, : uw + 1]
            qp_pair = np.zeros((uh, uw + 1), np.int32)
            qp_pair[:, 1:uw] = (maps.qp_l[:, : uw - 1] + maps.qp_l[:, 1:uw] + 1) >> 1
            comb = edge | sbe
            small = np.zeros_like(edge)
            small[:, 1:uw] = comb[:, 0 : uw - 1] | comb[:, 2 : uw + 1]
            e2 = np.zeros_like(edge)
            e2[:, 2:] |= edge[:, : uw - 1]
            e2[:, : uw - 1] |= edge[:, 2:]
            clear_p = ~_window_any(edge, -7, 0, axis=1)
            clear_q = ~_window_any(edge, 1, 8, axis=1)
            aff_p = np.zeros_like(edge)
            aff_p[:, 1 : uw + 1] = maps.aff_unit[:uh, :uw]
            aff_q = np.zeros_like(edge)
            aff_q[:, :uw] = maps.aff_unit[:uh, :uw]
            pos = np.arange(uw + 1)[None, :]
            on4_p = (pos % 4) == 0
            on4_q = on4_p
            active = comb & (bs2 | bs1)
            active[:, 0] = False
            active[:, uw:] = False
            if no_x:
                for x in no_x:
                    active[:, x // 4] = False
        else:
            edge = maps.edge_hor[: uh + 1, :uw]
            sbe = maps.sb_edge_hor[: uh + 1, :uw]
            bs2 = maps.bs2_hor[: uh + 1, :uw]
            bs1 = maps.bs1_hor[: uh + 1, :uw]
            qp_pair = np.zeros((uh + 1, uw), np.int32)
            qp_pair[1:uh, :] = (maps.qp_l[: uh - 1, :] + maps.qp_l[1:uh, :] + 1) >> 1
            comb = edge | sbe
            small = np.zeros_like(edge)
            small[1:uh, :] = comb[0 : uh - 1, :] | comb[2 : uh + 1, :]
            e2 = np.zeros_like(edge)
            e2[2:, :] |= edge[: uh - 1, :]
            e2[: uh - 1, :] |= edge[2:, :]
            clear_p = ~_window_any(edge, -7, 0, axis=0)
            clear_q = ~_window_any(edge, 1, 8, axis=0)
            aff_p = np.zeros_like(edge)
            aff_p[1 : uh + 1, :] = maps.aff_unit[:uh, :uw]
            aff_q = np.zeros_like(edge)
            aff_q[:uh, :] = maps.aff_unit[:uh, :uw]
            pos = np.arange(uh + 1)[:, None]
            # p side (above) carries the CTU line-buffer restriction —
            # long-P suppressed in the first 7 unit rows of each CTU
            # (rcn_df.c:2146 `i % 4 || i < 7`, i CTU-local); the q side
            # does not (ref_dbf horizontal mlq derivation)
            ucb = (1 << log2_ctb) >> 2
            on4_p = ((pos % 4) == 0) & ((pos % ucb) >= 7)
            on4_q = (pos % 4) == 0
            active = comb & (bs2 | bs1)
            active[0, :] = False
            active[uh:, :] = False
            if no_y:
                for y in no_y:
                    active[y // 4, :] = False

        bs = np.where(bs2, 2, 1)
        beta, tc = _limits_vec(qp_pair, bs, beta_off, tc_off, bitdepth)
        active = active & ((beta > 0) | (tc > 0))
        # filter lengths (rcn_df.c set_edge_context/derive_filter_length):
        # small -> 1; pure sub-block edge next to a real edge 2 units away
        # -> 2; else 3, upgraded to 7 (or 5 on an affine side) only at real
        # edges on the 16-sample grid with a clear window
        pure_sb = sbe & ~edge
        aff1 = pure_sb & e2
        long_p = on4_p & clear_p & ~pure_sb
        long_q = on4_q & clear_q & ~pure_sb
        mlp = np.where(small, 1,
                       np.where(aff1, 2,
                                np.where(long_p, np.where(aff_p, 5, 7), 3))
                       ).astype(np.int32)
        mlq = np.where(small, 1,
                       np.where(aff1, 2,
                                np.where(long_q, np.where(aff_q, 5, 7), 3))
                       ).astype(np.int32)

        if dense:
            out.append({
                "beta": np.where(active, beta, 0).astype(np.int16),
                "tc": np.where(active, tc, 0).astype(np.int16),
                "mlp": mlp.astype(np.int8), "mlq": mlq.astype(np.int8),
            })
            continue
        yy, xx = np.nonzero(active)
        out.append({
            "xs": (xx * 4).astype(np.int32),
            "ys": (yy * 4).astype(np.int32),
            "beta": beta[yy, xx].astype(np.int32),
            "tc": tc[yy, xx].astype(np.int32),
            "mlp": mlp[yy, xx],
            "mlq": mlq[yy, xx],
        })
    return out[0], out[1]


def _pad_pow2(params):
    """Pad segment count to a power of two (bounded compile-shape set);
    padding repeats segment 0 with tc=beta=0 (filters nothing)."""
    n = len(params["xs"])
    if n == 0:
        return params, 0
    cap = 1 << max(0, (n - 1).bit_length())
    if cap == n:
        return params, n
    out = {}
    for k, v in params.items():
        pad = np.repeat(v[:1], cap - n, axis=0)
        if k in ("beta", "tc"):
            pad = np.zeros_like(pad)
        out[k] = np.concatenate([v, pad])
    return out, n


def _luma_core(xp, win, beta, tc, mlp, mlq, bd_max):
    """Filter all [S, 4, 16] luma segments; returns (new, wmask).

    Layout: col c holds sample x+c-8; p(k) = col 7-k, q(k) = col 8+k.
    Math is a transliteration of ref_dbf._filter_luma_segment over masks.
    """
    S = win.shape[0]
    w32 = win.astype(xp.int32)
    p = lambda k: w32[:, :, 7 - k]
    q = lambda k: w32[:, :, 8 + k]
    beta = beta[:, None]
    tc = tc[:, None]
    mlp = mlp[:, None]
    mlq = mlq[:, None]

    dp_l = abs(p(2) - 2 * p(1) + p(0))   # [S, 4]
    dq_l = abs(q(0) - 2 * q(1) + q(2))
    dp_ls = abs(p(5) - 2 * p(4) + p(3))  # shift-3 variants
    dq_ls = abs(q(3) - 2 * q(4) + q(5))
    dp0, dp3 = dp_l[:, 0:1], dp_l[:, 3:4]
    dq0, dq3 = dq_l[:, 0:1], dq_l[:, 3:4]
    d0, d3 = dp0 + dq0, dp3 + dq3
    filt_any = (d0 + d3) < beta  # [S, 1]

    # ---- strong-large decision ---------------------------------------
    dpL = lambda i: xp.where(mlp > 3, (dp_l[:, i : i + 1] + dp_ls[:, i : i + 1] + 1) >> 1,
                             dp_l[:, i : i + 1])
    dqL = lambda i: xp.where(mlq > 3, (dq_l[:, i : i + 1] + dq_ls[:, i : i + 1] + 1) >> 1,
                             dq_l[:, i : i + 1])
    d0L = dpL(0) + dqL(0)
    d3L = dpL(3) + dqL(3)

    def strong_l0(i):
        pi = lambda k: w32[:, i, 7 - k][:, None]
        qi = lambda k: w32[:, i, 8 + k][:, None]
        sp3 = abs(pi(3) - pi(0))
        sp3_7 = (sp3 + abs(pi(4) - pi(5) - pi(6) + pi(7)) + abs(pi(3) - pi(7)) + 1) >> 1
        sp3_5 = (sp3 + abs(pi(3) - pi(5)) + 1) >> 1
        sp3 = xp.where(mlp == 7, sp3_7, xp.where(mlp == 5, sp3_5, sp3))
        sq3 = abs(qi(3) - qi(0))
        sq3_7 = (sq3 + abs(qi(4) - qi(5) - qi(6) + qi(7)) + abs(qi(7) - qi(3)) + 1) >> 1
        sq3_5 = (sq3 + abs(qi(5) - qi(3)) + 1) >> 1
        sq3 = xp.where(mlq == 7, sq3_7, xp.where(mlq == 5, sq3_5, sq3))
        return ((sp3 + sq3) < ((beta * 3) >> 5)) & (abs(pi(0) - qi(0)) < ((tc * 5 + 1) >> 1))

    use_long = (((mlp > 3) | (mlq > 3))
                & ((d0L + d3L) < beta)
                & (d0L < ((beta + 0x10) >> 5))
                & (d3L < ((beta + 0x10) >> 5))
                & strong_l0(0) & strong_l0(3) & filt_any)  # [S, 1]

    # ---- long filter ---------------------------------------------------
    # all per-segment table rows resolve by select-sum over the few
    # possible filter lengths (no element gathers)
    mlp_f = xp.maximum(mlp, 3)
    mlq_f = xp.maximum(mlq, 3)
    combo = ((mlp_f - 3) >> 1) * 3 + ((mlq_f - 3) >> 1)  # [S, 1]
    midw = xp.zeros(w32.shape[:1] + (16,), xp.int32)
    for j in range(9):
        if _MIDW[j].any():
            midw = midw + xp.where(combo == j, _MIDW[j][None, :], 0)
    mid = (xp.sum(w32 * midw[:, None, :], axis=2) + 8) >> 4  # [S, 4]

    def _refsel(side_len, base, sign):
        # (w[base + sign*(m-1)] + w[base + sign*m] + 1) >> 1, m in {3,5,7}
        acc = xp.zeros_like(w32[:, :, 0])
        for m in (3, 5, 7):
            v = (w32[:, :, base + sign * (m - 1)]
                 + w32[:, :, min(max(base + sign * m, 0), 15)] + 1) >> 1
            acc = acc + xp.where(side_len == m, v, 0)
        return acc

    ref_p = _refsel(mlp_f, 7, -1)
    ref_q = _refsel(mlq_f, 8, 1)

    def _rowsel3(table, side_len):
        acc = xp.zeros(w32.shape[:1] + (7,), xp.int32)
        for j in range(3):
            acc = acc + xp.where(((side_len - 3) >> 1) == j,
                                 table[j][None, :], 0)
        return acc

    wp = _rowsel3(_WPL, mlp_f)
    tp = _rowsel3(_TPL, mlp_f)
    wq = _rowsel3(_WPL, mlq_f)
    tq = _rowsel3(_TPL, mlq_f)
    new_long = _fresh(xp, w32)
    mask_long = xp.zeros(win.shape, bool)
    for k in range(7):
        c_p = (tc * tp[:, k : k + 1]) >> 1  # [S, 1]
        old = p(k)
        v = (mid * wp[:, k : k + 1] + ref_p * (64 - wp[:, k : k + 1]) + 32) >> 6
        v = xp.clip(v, old - c_p, old + c_p)
        on = (k < mlp_f)  # [S, 1]
        col = 7 - k
        new_long = _setcol(xp, new_long, col, xp.where(on, v, old))
        mask_long = _setcol(xp, mask_long, col, on & xp.ones_like(old, bool))
        c_q = (tc * tq[:, k : k + 1]) >> 1
        oldq = q(k)
        vq = (mid * wq[:, k : k + 1] + ref_q * (64 - wq[:, k : k + 1]) + 32) >> 6
        vq = xp.clip(vq, oldq - c_q, oldq + c_q)
        onq = (k < mlq_f)
        new_long = _setcol(xp, new_long, 8 + k, xp.where(onq, vq, oldq))
        mask_long = _setcol(xp, mask_long, 8 + k, onq & xp.ones_like(oldq, bool))

    # ---- strong small --------------------------------------------------
    def strong_l1(i):
        pi = lambda k: w32[:, i, 7 - k][:, None]
        qi = lambda k: w32[:, i, 8 + k][:, None]
        dd = abs(pi(3) - pi(0)) + abs(qi(3) - qi(0))
        return (dd < (beta >> 3)) & (abs(pi(0) - qi(0)) < ((tc * 5 + 1) >> 1))

    use_ss = ((~use_long) & filt_any & (mlp > 2)
              & (d0 < ((beta + 4) >> 3)) & (d3 < ((beta + 4) >> 3))
              & strong_l1(0) & strong_l1(3))

    tc1, tc2, tc3 = tc, 2 * tc, 3 * tc
    p3_, p2_, p1_, p0_ = p(3), p(2), p(1), p(0)
    q0_, q1_, q2_, q3_ = q(0), q(1), q(2), q(3)
    ss_p2 = xp.clip((2 * p3_ + 3 * p2_ + p1_ + p0_ + q0_ + 4) >> 3, p2_ - tc1, p2_ + tc1)
    ss_p1 = xp.clip((p2_ + p1_ + p0_ + q0_ + 2) >> 2, p1_ - tc2, p1_ + tc2)
    ss_p0 = xp.clip((p2_ + 2 * p1_ + 2 * p0_ + 2 * q0_ + q1_ + 4) >> 3, p0_ - tc3, p0_ + tc3)
    ss_q0 = xp.clip((p1_ + 2 * p0_ + 2 * q0_ + 2 * q1_ + q2_ + 4) >> 3, q0_ - tc3, q0_ + tc3)
    ss_q1 = xp.clip((p0_ + q0_ + q1_ + q2_ + 2) >> 2, q1_ - tc2, q1_ + tc2)
    ss_q2 = xp.clip((p0_ + q0_ + q1_ + 3 * q2_ + 2 * q3_ + 4) >> 3, q2_ - tc1, q2_ + tc1)

    # ---- weak ----------------------------------------------------------
    use_weak = (~use_long) & (~use_ss) & filt_any
    dp_sum = dp0 + dp3
    dq_sum = dq0 + dq3
    side_thd = (beta + (beta >> 1)) >> 3
    extend_p = (dp_sum < side_thd) & (mlp > 1)
    extend_q = (dq_sum < side_thd) & (mlp > 1)  # ref uses max_l_p for both
    tc2_p = xp.where(extend_p, tc >> 1, 0)
    tc2_q = xp.where(extend_q, tc >> 1, 0)
    delta_raw = (9 * (q0_ - p0_) - 3 * (q1_ - p1_) + 8) >> 4  # [S, 4]
    weak_on = abs(delta_raw) < (tc * 10)
    delta = xp.clip(delta_raw, -tc, tc)
    d1 = xp.clip((((p2_ + p0_ + 1) >> 1) - p1_ + delta) >> 1, -tc2_p, tc2_p)
    d2 = xp.clip((((q2_ + q0_ + 1) >> 1) - q1_ - delta) >> 1, -tc2_q, tc2_q)
    wk_p1 = xp.clip(p1_ + d1, 0, bd_max)
    wk_p0 = xp.clip(p0_ + delta, 0, bd_max)
    wk_q0 = xp.clip(q0_ - delta, 0, bd_max)
    wk_q1 = xp.clip(q1_ + d2, 0, bd_max)

    # ---- compose -------------------------------------------------------
    new = xp.where(use_long[:, :, None] & mask_long, new_long, w32)
    wmask = use_long[:, :, None] & mask_long
    for col, val in ((5, ss_p2), (6, ss_p1), (7, ss_p0), (8, ss_q0),
                     (9, ss_q1), (10, ss_q2)):
        sel = use_ss & xp.ones_like(val, bool)
        new = _setcol(xp, new, col, xp.where(sel, val, _getcol(new, col)))
        wmask = _setcol(xp, wmask, col, _getcol(wmask, col) | sel)
    for col, val in ((6, wk_p1), (7, wk_p0), (8, wk_q0), (9, wk_q1)):
        sel = use_weak & weak_on
        new = _setcol(xp, new, col, xp.where(sel, val, _getcol(new, col)))
        wmask = _setcol(xp, wmask, col, _getcol(wmask, col) | sel)
    return new, wmask


def _getcol(a, c):
    return a[:, :, c]


def _setcol(xp, a, c, v):
    """Column write; numpy mutates in place (callers pass fresh arrays)."""
    if xp is np:
        a[:, :, c] = v
        return a
    return a.at[:, :, c].set(v)


def _fresh(xp, a):
    """A safely-mutable value copy (numpy); jnp arrays are functional."""
    return a.copy() if xp is np else a


_DBF_PAD = 16


def _win_slice(plane, ys, xs, h, w):
    """Slice-gather S windows of (h, w) — vmapped dynamic_slice lowers to
    one XLA gather with slice sizes."""
    import jax

    def one(y, x):
        return jax.lax.dynamic_slice(plane, (y, x), (h, w))

    return jax.vmap(one)(ys, xs)


def _win_scatter_add(plane, ys, xs, delta):
    """Window scatter-add of (h, w) deltas at S origins (duplicate-safe)."""
    import jax.numpy as jnp
    from jax import lax

    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0, 1))
    return lax.scatter_add(plane, jnp.stack([ys, xs], axis=1), delta, dnums)


def _apply_pass_dense(xp, plane, dp, bd_max, horizontal):
    """Gather-free luma pass over the full boundary grid.

    dp: dense param grids from luma_segment_params(dense=True) — ver
    (uh, uw+1), hor (uh+1, uw); inactive boundaries carry beta=tc=0 so
    _luma_core filters nothing there.  Windows are built by reshape +
    static shifts and deltas written back the same way: zero gathers or
    scatters, all traffic at memory speed."""
    if horizontal:
        dpt = {k: v.T for k, v in dp.items()}
        return _apply_pass_dense(xp, plane.T, dpt, bd_max, False).T

    H, W = plane.shape
    uh, nbx = dp["beta"].shape          # nbx == uw + 1
    if xp is np:
        pp = np.pad(plane, ((0, 0), (8, 4 * (nbx + 3) - W - 8 + 4)),
                    mode="edge")
    else:
        pp = xp.pad(plane, ((0, 0), (8, 4 * (nbx + 3) - W - 8 + 4)),
                    mode="edge")
    Wp = pp.shape[1]
    R = pp.reshape(H, Wp // 4, 4)
    parts = [R[:, c:c + nbx, :] for c in range(4)]
    win = xp.concatenate(parts, axis=2)                 # (H, nbx, 16)
    win = win.reshape(uh, 4, nbx, 16).transpose(0, 2, 1, 3) \
        .reshape(uh * nbx, 4, 16)
    flat = lambda k: dp[k].reshape(uh * nbx).astype(xp.int32)
    new, wmask = _luma_core(xp, win, flat("beta"), flat("tc"),
                            flat("mlp"), flat("mlq"), bd_max)
    delta = ((new - win) * wmask).reshape(uh, nbx, 4, 16) \
        .transpose(0, 2, 1, 3).reshape(H, nbx, 16)
    accR = xp.zeros((H, Wp // 4, 4), xp.int32)
    for c in range(4):
        chunk = delta[:, :, 4 * c:4 * c + 4]
        if xp is np:
            accR[:, c:c + nbx, :] += chunk
        else:
            accR = accR.at[:, c:c + nbx, :].add(chunk)
    pp = pp + accR.reshape(H, Wp)
    return pp[:, 8:8 + W]


def _apply_pass(xp, plane, params, bd_max, horizontal):
    """Gather -> filter -> masked scatter for one direction."""
    if len(params["xs"]) == 0:
        return plane
    if not params.get("_padded"):
        params, _n = _pad_pow2(params)
    xs = xp.asarray(params["xs"])
    ys = xp.asarray(params["ys"])
    H, W = plane.shape
    if xp is not np:
        # device path: replicate-pad once, then pure slice windows (the
        # edge replication reproduces the host path's index clipping)
        P = _DBF_PAD
        pp = xp.pad(plane, P, mode="edge")
        if not horizontal:
            oy, ox, wh, ww = ys + P, xs - 8 + P, 4, 16
        else:
            oy, ox, wh, ww = ys - 8 + P, xs + P, 16, 4
        win = _win_slice(pp, oy, ox, wh, ww)
        if horizontal:
            win = xp.swapaxes(win, 1, 2)
        new, wmask = _luma_core(xp, win, params["beta"], params["tc"],
                                params["mlp"], params["mlq"], bd_max)
        delta = (new - win) * wmask
        if horizontal:
            delta = xp.swapaxes(delta, 1, 2)
        pp = _win_scatter_add(pp, oy, ox, delta)
        return pp[P:P + H, P:P + W]
    rows = ys[:, None, None] + xp.arange(4)[None, :, None] if not horizontal \
        else xp.clip(ys[:, None, None] + (xp.arange(16) - 8)[None, :, None], 0, H - 1)
    cols = xp.clip(xs[:, None, None] + (xp.arange(16) - 8)[None, None, :], 0, W - 1) \
        if not horizontal else xs[:, None, None] + xp.arange(4)[None, None, :]
    rows_b, cols_b = xp.broadcast_arrays(rows, cols)
    win = plane[rows_b, cols_b]
    if horizontal:
        win = xp.swapaxes(win, 1, 2)  # -> [S, lines(4), cross(16)]
    new, wmask = _luma_core(xp, win,
                            xp.asarray(params["beta"]), xp.asarray(params["tc"]),
                            xp.asarray(params["mlp"]), xp.asarray(params["mlq"]),
                            bd_max)
    delta = (new - win) * wmask
    if horizontal:
        delta = xp.swapaxes(delta, 1, 2)
    out = plane.copy()
    np.add.at(out, (rows_b, cols_b), delta)
    return out


def deblock_luma_batched(xp, plane, maps: DbfMaps, beta_off, tc_off, bitdepth,
                         pic_w, pic_h, no_x=(), no_y=(), log2_ctb=6):
    """Both passes over one luma plane; xp is np (host) or jnp (device)."""
    vp, hp = luma_segment_params(maps, beta_off, tc_off, bitdepth,
                                 pic_w, pic_h, no_x, no_y,
                                 log2_ctb=log2_ctb)
    bd_max = (1 << bitdepth) - 1
    plane = _apply_pass(xp, plane, vp, bd_max, horizontal=False)
    plane = _apply_pass(xp, plane, hp, bd_max, horizontal=True)
    return plane


# ---------------------------------------------------------------------------
# chroma
# ---------------------------------------------------------------------------

def chroma_segment_params(maps: DbfMaps, plane_sel: str, beta_off, tc_off,
                          bitdepth, pic_w, pic_h, log2_ctb, no_x=(), no_y=()):
    """(vertical, horizontal) chroma segment params for one plane ('cb'|'cr').

    Mirrors ref_dbf.deblock_chroma: edges on the 8-chroma-sample grid,
    `large` when no chroma edge within 3 units either side, activation
    bs2 | (bs1 & large), CTU-boundary flag on horizontal edges.
    """
    uw, uh = pic_w // 4, pic_h // 4
    bs1v = maps.cbs1_cb_ver if plane_sel == "cb" else maps.cbs1_cr_ver
    bs1h = maps.cbs1_cb_hor if plane_sel == "cb" else maps.cbs1_cr_hor
    qpm = maps.qp_cb if plane_sel == "cb" else maps.qp_cr
    out = []
    for direction in ("ver", "hor"):
        if direction == "ver":
            edge = maps.cedge_ver[:uh, : uw + 1]
            bs2 = maps.cbs2_ver[:uh, : uw + 1]
            bs1 = bs1v[:uh, : uw + 1]
            qp_pair = np.zeros((uh, uw + 1), np.int32)
            qp_pair[:, 1:uw] = (qpm[:, : uw - 1] + qpm[:, 1:uw] + 1) >> 1
            large = ~(_window_any(edge, -3, 0, axis=1) | _window_any(edge, 1, 4, axis=1))
            pos = np.arange(uw + 1)[None, :]
            on_grid = (pos % 4 == 0) & (pos > 0) & (pos < uw)
            active = edge & on_grid & (bs2 | (bs1 & large))
            if no_x:
                for x in no_x:
                    active[:, x // 4] = False
            ctb_b = np.zeros_like(active)
        else:
            edge = maps.cedge_hor[: uh + 1, :uw]
            bs2 = maps.cbs2_hor[: uh + 1, :uw]
            bs1 = bs1h[: uh + 1, :uw]
            qp_pair = np.zeros((uh + 1, uw), np.int32)
            qp_pair[1:uh, :] = (qpm[: uh - 1, :] + qpm[1:uh, :] + 1) >> 1
            large = ~(_window_any(edge, -3, 0, axis=0) | _window_any(edge, 1, 4, axis=0))
            pos = np.arange(uh + 1)[:, None]
            on_grid = (pos % 4 == 0) & (pos > 0) & (pos < uh)
            active = edge & on_grid & (bs2 | (bs1 & large))
            if no_y:
                for y in no_y:
                    active[y // 4, :] = False
            # luma y of the edge = yu*4; CTU boundary when it divides ctb size
            ctb_b = np.zeros_like(active)
            ctb_b[:] = (pos * 4) % (1 << log2_ctb) == 0

        bs = np.where(bs2, 2, 1)
        beta, tc = _limits_vec(qp_pair, bs, beta_off, tc_off, bitdepth)
        yy, xx = np.nonzero(active)
        out.append({
            "xs": (xx * 2).astype(np.int32),   # chroma sample coords
            "ys": (yy * 2).astype(np.int32),
            "beta": beta[yy, xx].astype(np.int32),
            "tc": tc[yy, xx].astype(np.int32),
            "bs2": bs2[yy, xx].astype(np.int32),
            "large": large[yy, xx].astype(np.int32),
            "ctb_b": ctb_b[yy, xx].astype(np.int32),
        })
    return out[0], out[1]


def _chroma_core(xp, win, beta, tc, bs2, large, ctb_b, bd_max):
    """Filter [S, 2, 8] chroma segments (col c = sample x+c-4; p(k)=3-k,
    q(k)=4+k). Transliteration of ref_dbf._filter_chroma_edge."""
    w32 = win.astype(xp.int32)
    p = lambda k: w32[:, :, 3 - k]
    q = lambda k: w32[:, :, 4 + k]
    beta = beta[:, None]
    tc = tc[:, None]
    ctb = ctb_b[:, None].astype(bool)
    act = ((tc > 0) & (beta > 0))

    # decision (only for `large` segments)
    def line(i, k, side):
        return w32[:, i, 3 - k][:, None] if side == "p" else w32[:, i, 4 + k][:, None]

    def dpc(i):
        sh = xp.where(ctb, 1, 2)
        pa = xp.where(ctb, line(i, 1, "p"), line(i, 2, "p"))
        return abs(pa - 2 * line(i, 1, "p") + line(i, 0, "p"))

    def dqc(i):
        return abs(line(i, 0, "q") - 2 * line(i, 1, "q") + line(i, 2, "q"))

    d0 = dpc(0) + dqc(0)
    d3 = dpc(1) + dqc(1)
    d = d0 + d3

    def strong_c(i):
        p3 = xp.where(ctb, line(i, 1, "p"), line(i, 3, "p"))
        dd = abs(p3 - line(i, 0, "p")) + abs(line(i, 3, "q") - line(i, 0, "q"))
        return (dd < (beta >> 3)) & (abs(line(i, 0, "p") - line(i, 0, "q")) < ((tc * 5 + 1) >> 1))

    strong = ((large[:, None] > 0)
              & (d < beta)
              & (2 * d0 < (beta >> 2))
              & (2 * d3 < (beta >> 2))
              & strong_c(0) & strong_c(1) & act)

    p0_, p1_, p2_, p3_ = p(0), p(1), p(2), p(3)
    q0_, q1_, q2_, q3_ = q(0), q(1), q(2), q(3)

    # strong, non-CTU-boundary form
    s_p2 = xp.clip((3 * p3_ + 2 * p2_ + p1_ + p0_ + q0_ + 4) >> 3, p2_ - tc, p2_ + tc)
    s_p1 = xp.clip((2 * p3_ + p2_ + 2 * p1_ + p0_ + q0_ + q1_ + 4) >> 3, p1_ - tc, p1_ + tc)
    s_p0 = xp.clip((p3_ + p2_ + p1_ + 2 * p0_ + q0_ + q1_ + q2_ + 4) >> 3, p0_ - tc, p0_ + tc)
    s_q0 = xp.clip((p2_ + p1_ + p0_ + 2 * q0_ + q1_ + q2_ + q3_ + 4) >> 3, q0_ - tc, q0_ + tc)
    s_q1 = xp.clip((p1_ + p0_ + q0_ + 2 * q1_ + q2_ + 2 * q3_ + 4) >> 3, q1_ - tc, q1_ + tc)
    s_q2 = xp.clip((p0_ + q0_ + q1_ + 2 * q2_ + 3 * q3_ + 4) >> 3, q2_ - tc, q2_ + tc)
    # strong, CTU-boundary form (p access restricted to p0/p1)
    b_p0 = xp.clip((3 * p1_ + 2 * p0_ + q0_ + q1_ + q2_ + 4) >> 3, p0_ - tc, p0_ + tc)
    b_q0 = xp.clip((2 * p1_ + p0_ + 2 * q0_ + q1_ + q2_ + q3_ + 4) >> 3, q0_ - tc, q0_ + tc)
    b_q1 = xp.clip((p1_ + p0_ + q0_ + 2 * q1_ + q2_ + 2 * q3_ + 4) >> 3, q1_ - tc, q1_ + tc)
    b_q2 = xp.clip((p0_ + q0_ + q1_ + 2 * q2_ + 3 * q3_ + 4) >> 3, q2_ - tc, q2_ + tc)

    # weak
    delta = xp.clip(((q0_ << 2) - (p0_ << 2) + p1_ - q1_ + 4) >> 3, -tc, tc)
    w_p0 = xp.clip(p0_ + delta, 0, bd_max)
    w_q0 = xp.clip(q0_ - delta, 0, bd_max)

    weak = (~strong) & act
    new = _fresh(xp, w32)
    wmask = xp.zeros(win.shape, bool)
    strong_nb = strong & ~ctb
    strong_b = strong & ctb
    ones = xp.ones_like(p0_, bool)
    for col, val, sel in (
            (1, s_p2, strong_nb), (2, s_p1, strong_nb),
            (3, s_p0, strong_nb), (4, s_q0, strong_nb),
            (5, s_q1, strong_nb), (6, s_q2, strong_nb),
            (3, b_p0, strong_b), (4, b_q0, strong_b),
            (5, b_q1, strong_b), (6, b_q2, strong_b),
            (3, w_p0, weak), (4, w_q0, weak)):
        m = sel & ones
        new = _setcol(xp, new, col, xp.where(m, val, _getcol(new, col)))
        wmask = _setcol(xp, wmask, col, _getcol(wmask, col) | m)
    return new, wmask


def _apply_pass_chroma(xp, plane, params, bd_max, horizontal):
    if len(params["xs"]) == 0:
        return plane
    if not params.get("_padded"):
        params, _n = _pad_pow2(params)
    xs = xp.asarray(params["xs"])
    ys = xp.asarray(params["ys"])
    H, W = plane.shape
    if xp is not np:
        P = _DBF_PAD
        pp = xp.pad(plane, P, mode="edge")
        if not horizontal:
            oy, ox, wh, ww = ys + P, xs - 4 + P, 2, 8
        else:
            oy, ox, wh, ww = ys - 4 + P, xs + P, 8, 2
        win = _win_slice(pp, oy, ox, wh, ww)
        if horizontal:
            win = xp.swapaxes(win, 1, 2)
        new, wmask = _chroma_core(xp, win, params["beta"], params["tc"],
                                  params["bs2"], params["large"],
                                  params["ctb_b"], bd_max)
        delta = (new - win) * wmask
        if horizontal:
            delta = xp.swapaxes(delta, 1, 2)
        pp = _win_scatter_add(pp, oy, ox, delta)
        return pp[P:P + H, P:P + W]
    if not horizontal:
        rows = ys[:, None, None] + xp.arange(2)[None, :, None]
        cols = xp.clip(xs[:, None, None] + (xp.arange(8) - 4)[None, None, :], 0, W - 1)
    else:
        rows = xp.clip(ys[:, None, None] + (xp.arange(8) - 4)[None, :, None], 0, H - 1)
        cols = xs[:, None, None] + xp.arange(2)[None, None, :]
    rows_b, cols_b = xp.broadcast_arrays(rows, cols)
    win = plane[rows_b, cols_b]
    if horizontal:
        win = xp.swapaxes(win, 1, 2)
    new, wmask = _chroma_core(xp, win,
                              xp.asarray(params["beta"]), xp.asarray(params["tc"]),
                              xp.asarray(params["bs2"]), xp.asarray(params["large"]),
                              xp.asarray(params["ctb_b"]), bd_max)
    delta = (new - win) * wmask
    if horizontal:
        delta = xp.swapaxes(delta, 1, 2)
    out = plane.copy()
    np.add.at(out, (rows_b, cols_b), delta)
    return out


def deblock_chroma_batched(xp, cb, cr, maps: DbfMaps, params, bitdepth,
                           pic_w, pic_h, log2_ctb, no_x=(), no_y=()):
    """Both chroma planes, both passes (ref_dbf.deblock_chroma parity)."""
    bd_max = (1 << bitdepth) - 1
    for plane_sel, plane in (("cb", cb), ("cr", cr)):
        beta_off, tc_off = _beta_tc_offsets(params, plane_sel)
        vp, hp = chroma_segment_params(maps, plane_sel, beta_off, tc_off,
                                       bitdepth, pic_w, pic_h, log2_ctb,
                                       no_x, no_y)
        plane = _apply_pass_chroma(xp, plane, vp, bd_max, horizontal=False)
        plane = _apply_pass_chroma(xp, plane, hp, bd_max, horizontal=True)
        if plane_sel == "cb":
            cb = plane
        else:
            cr = plane
    return cb, cr


def deblock_frame_batched(xp, y, cb, cr, maps: DbfMaps, params, log2_ctb,
                          bitdepth):
    """Whole-frame DBF (ref_dbf.deblock_frame parity), batched backend xp."""
    pic_h, pic_w = (y.shape[0], y.shape[1])
    no_x, no_y = [], []
    ti = params.tile_info
    if ti.nb_tiles > 1 and not params.pps.pps_loop_filter_across_tiles_enabled_flag:
        no_x = [x << log2_ctb for x in ti.col_x()[1:-1]]
        no_y = [yy << log2_ctb for yy in ti.row_y()[1:-1]]
    b_l, t_l = _beta_tc_offsets(params, "luma")
    y = deblock_luma_batched(xp, y, maps, b_l, t_l, bitdepth, pic_w, pic_h,
                             no_x, no_y)
    if cb is not None:
        cb, cr = deblock_chroma_batched(xp, cb, cr, maps, params, bitdepth,
                                        pic_w, pic_h, log2_ctb, no_x, no_y)
    return y, cb, cr
