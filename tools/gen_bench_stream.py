"""Generate benchmark bitstreams (1080p inter GOP) for the fps baseline.

The JVET CTC corpus is unreachable in this environment (zero egress), so the
fps denominator is measured on self-generated conformant streams: an IDR
followed by P frames with a realistic CU mix (skip / merge / AMVP with
fractional MVs, sparse residuals) and DBF enabled. The same stream feeds
both the reference binary (tools/build_reference_perf.sh) and our decoder,
so the ratio is apples-to-apples.

Usage: python tools/gen_bench_stream.py [--width 1920 --height 1080
        --frames 9 --tiles 1 --out /tmp/bench_1080p.266]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openvvc_tpu.testing.generator import (  # noqa: E402
    StreamConfig,
    build_stream_frames,
    rect_tree_builder,
)
from openvvc_tpu.vcl.coding_tree import NO_SPLIT, QT_SPLIT, TreeNode  # noqa: E402
from openvvc_tpu.vcl.ctu import CU  # noqa: E402


def _sparse(rng, log2_w, log2_h, p=0.08, mag=8):
    lv = np.zeros((1 << log2_h, 1 << log2_w), np.int32)
    mask = rng.rand(*lv.shape) < p
    lv[mask] = rng.randint(-mag, mag + 1, int(mask.sum()))
    return lv


def _find_last(levels, log2_w, log2_h):
    from openvvc_tpu.testing.generator import _find_last_pos_diag

    return _find_last_pos_diag(levels, log2_w, log2_h)


def _lfnst_levels(rng, log2_w, log2_h):
    """Levels valid for LFNST: confined to the first 8/16 diagonal
    positions of the top-left 4x4 sub-block, not DC-only."""
    from openvvc_tpu.vcl.residual import diag_scan

    lv = np.zeros((1 << log2_h, 1 << log2_w), np.int32)
    nmax = 8 if (log2_w == log2_h and log2_w in (2, 3)) else 16
    for i in range(rng.randint(2, nmax + 1)):
        x, y = diag_scan(4, 4)[i]
        lv[y, x] = rng.randint(-20, 21)
    if abs(lv).sum() == abs(lv[0, 0]):
        lv[1, 0] = 4
    return lv


def _intra_cu(rng, x, y, log2, lfnst=False, mip=False, ts=False):
    from openvvc_tpu.vcl.ctu import TU

    cu = CU(x, y, log2, log2, intra_mode_l=int(rng.randint(0, 67)),
            intra_mode_c=int(rng.randint(0, 2)))
    if ts and log2 <= 4 and rng.rand() < 0.4:
        # transform-skip TB (forward-scan residual, TS dequant); BDPCM
        # stays off this profile so every picture keeps the device path
        # (the IR routes BDPCM pure-copy CUs to the host C recon lane)
        lv = _sparse(rng, log2, log2, p=0.25, mag=6)
        if not lv.any():
            lv[0, 0] = 2
        tu = TU(x, y, log2, log2, 0, cbf=1, levels=lv)
        tu.transform_skip = 1
        cu.tus.append(tu)
        if rng.rand() < 0.5:
            clv = _sparse(rng, log2 - 1, log2 - 1, p=0.2, mag=5)
            if clv.any():
                ctu = TU(x >> 1, y >> 1, log2 - 1, log2 - 1, 1, cbf=1,
                         levels=clv)
                ctu.transform_skip = 1
                cu.tus.append(ctu)
        return cu
    if mip and rng.rand() < 0.4:
        from openvvc_tpu.rcn.ref_mip import nb_mip_modes

        cu.mip_flag = 1
        cu.mip_transpose = int(rng.randint(0, 2))
        cu.mip_mode = int(rng.randint(0, nb_mip_modes(log2, log2)))
        cu.intra_mode_l = 0
        lv = _sparse(rng, log2, log2, p=0.10, mag=10)
        if lv.any():
            cu.tus.append(TU(x, y, log2, log2, 0, cbf=1, levels=lv,
                             last_pos=_find_last(lv, log2, log2)))
        return cu
    if lfnst and rng.rand() < 0.6:
        idx = int(rng.randint(1, 3))
        lv = _lfnst_levels(rng, log2, log2)
        tu = TU(x, y, log2, log2, 0, cbf=1, levels=lv,
                last_pos=_find_last(lv, log2, log2))
        tu.lfnst_idx = idx
        cu.tus.append(tu)
        cu.lfnst_idx = idx
        return cu
    lv = _sparse(rng, log2, log2, p=0.10, mag=10)
    if lv.any():
        cu.tus.append(TU(x, y, log2, log2, 0, cbf=1, levels=lv,
                         last_pos=_find_last(lv, log2, log2)))
    for comp in (1, 2):
        lv = _sparse(rng, log2 - 1, log2 - 1, p=0.06, mag=6)
        if lv.any():
            cu.tus.append(TU(x >> 1, y >> 1, log2 - 1, log2 - 1, comp, cbf=1,
                             levels=lv, last_pos=_find_last(lv, log2 - 1, log2 - 1)))
    return cu


def _inter_cu(rng, x, y, log2, nb_ref0=1, nb_ref1=0, tools=False,
              affine=False):
    from openvvc_tpu.vcl.ctu import TU

    cu = CU(x, y, log2, log2)
    cu.pred_mode = 1
    if affine and rng.rand() < 0.3:
        # affine AMVP / sb-merge mix (6-param, PROF-active deltas)
        if rng.rand() < 0.5 and log2 > 3:
            cu.merge_flag = 0
            cu.affine_flag = 1
            cu.affine_type = int(rng.randint(0, 2))
            n = 3 if cu.affine_type else 2
            cu.affine_mvd0 = tuple(
                (int(rng.randint(-8, 9)), int(rng.randint(-8, 9)))
                for _ in range(n))
            cu.ref_idx = 0
            cu.mvp_idx = int(rng.randint(0, 2))
            if nb_ref1:
                cu.inter_dir = int(rng.choice([1, 2, 3]))
                cu.ref_idx1 = 0
                cu.affine_mvd1 = tuple(
                    (int(rng.randint(-8, 9)), int(rng.randint(-8, 9)))
                    for _ in range(n))
                cu.mvp_idx1 = int(rng.randint(0, 2))
            lv = _sparse(rng, log2, log2, p=0.05, mag=8)
            if lv.any():
                cu.tus.append(TU(x, y, log2, log2, 0, cbf=1, levels=lv,
                                 last_pos=_find_last(lv, log2, log2)))
            return cu
        cu.skip_flag = 1
        cu.merge_flag = 1
        cu.sb_merge_flag = 1
        cu.merge_idx = int(rng.randint(0, 5))
        return cu
    kind = rng.rand()
    if kind < 0.45:
        cu.skip_flag = 1
        cu.merge_flag = 1
        if tools and rng.rand() < 0.35:
            cu.mmvd_flag = 1
            cu.merge_idx = int(rng.randint(0, 64))
        elif tools and nb_ref1 and rng.rand() < 0.3:
            cu.gpm_flag = 1
            cu.gpm_split_dir = int(rng.randint(0, 64))
            cu.gpm_idx0 = int(rng.randint(0, 5))
            cu.gpm_idx1 = int(rng.choice(
                [i for i in range(5) if i != cu.gpm_idx0]))
        else:
            cu.merge_idx = int(rng.randint(0, 5))
        return cu
    if kind < 0.7:
        cu.merge_flag = 1
        r2 = rng.rand()
        if tools and r2 < 0.25 and 2 * log2 >= 6:
            cu.ciip_flag = 1
            cu.merge_idx = int(rng.randint(0, 5))
        elif tools and r2 < 0.45:
            cu.mmvd_flag = 1
            cu.merge_idx = int(rng.randint(0, 64))
        elif tools and nb_ref1 and r2 < 0.65:
            cu.gpm_flag = 1
            cu.gpm_split_dir = int(rng.randint(0, 64))
            cu.gpm_idx0 = int(rng.randint(0, 5))
            cu.gpm_idx1 = int(rng.choice(
                [i for i in range(5) if i != cu.gpm_idx0]))
        else:
            cu.merge_idx = int(rng.randint(0, 5))
    elif tools and nb_ref1 and rng.rand() < 0.25:
        # SMVD (signaled only when the writer's slice has a fw/bw ref
        # pair; the writer skips the flag otherwise)
        cu.merge_flag = 0
        cu.inter_dir = 3
        cu.smvd_flag = 1
        cu.mvd = (int(rng.randint(-20, 21)), int(rng.randint(-20, 21)))
        cu.mvp_idx = int(rng.randint(0, 2))
        cu.mvp_idx1 = int(rng.randint(0, 2))
        if 2 * log2 >= 8:
            # non-low-delay B: only 3 BCW weights are signalable
            cu.bcw_idx = int(rng.choice([1, 2, 3]))
    else:
        cu.merge_flag = 0
        cu.ref_idx = int(rng.randint(0, nb_ref0))
        cu.mvd = (int(rng.randint(-24, 25)), int(rng.randint(-24, 25)))
        cu.mvp_idx = int(rng.randint(0, 2))
        if nb_ref1:
            cu.inter_dir = int(rng.choice([1, 2, 3]))
            cu.ref_idx1 = int(rng.randint(0, nb_ref1))
            cu.mvd1 = (int(rng.randint(-24, 25)), int(rng.randint(-24, 25)))
            cu.mvp_idx1 = int(rng.randint(0, 2))
            if tools and cu.inter_dir == 3 and 2 * log2 >= 8:
                # non-low-delay B: only 3 BCW weights are signalable
                cu.bcw_idx = int(rng.choice([1, 2, 3]))
    lv = _sparse(rng, log2, log2, p=0.05, mag=8)
    if lv.any():
        cu.tus.append(TU(x, y, log2, log2, 0, cbf=1, levels=lv,
                         last_pos=_find_last(lv, log2, log2)))
    return cu


def ra_frame_specs(nb_frames, rng, leaf_inter, qt_tree, tools=False,
                   affine=False):
    """Random-access GOP-4 B-pyramid frame specs with decode != display
    order (the JVET CTC RA structure scaled down): per GOP
    P(poc+4) <- B(poc+2) <- B(poc+1), B(poc+3)."""
    def inter(nb0, nb1):
        return qt_tree(lambda x, y, l: _inter_cu(rng, x, y, l, nb0, nb1,
                                                 tools=tools,
                                                 affine=affine),
                       leaf_inter)

    specs = []
    poc = 0
    while len(specs) + 1 < nb_frames:
        base = poc
        gop = [
            ({"slice_type": 1, "poc": base + 4,
              "ref_deltas": [4, 8] if base else [4]},
             (2 if base else 1, 0)),
            ({"slice_type": 0, "poc": base + 2, "ref_deltas": [2],
              "ref_deltas1": [-2]}, (1, 1)),
            ({"slice_type": 0, "poc": base + 1, "ref_deltas": [1],
              "ref_deltas1": [-1, -3]}, (1, 2)),
            ({"slice_type": 0, "poc": base + 3, "ref_deltas": [1, 3],
              "ref_deltas1": [-1]}, (2, 1)),
        ]
        for spec, (n0, n1) in gop:
            if len(specs) + 1 >= nb_frames:
                break
            spec["tree_builder"] = inter(n0, n1)
            specs.append(spec)
        poc += 4
    return specs


def _qt_tree(cu_factory, leaf_log2):
    def qt(x, y, l2):
        if l2 > leaf_log2:
            h = 1 << (l2 - 1)
            return TreeNode(QT_SPLIT, children=[
                qt(x, y, l2 - 1), qt(x + h, y, l2 - 1),
                qt(x, y + h, l2 - 1), qt(x + h, y + h, l2 - 1)])
        return TreeNode(NO_SPLIT, cu=cu_factory(x, y, l2))

    def tb(params, entry):
        clg = params.sps.ctb_log2
        return {(entry.ctu_x + c, entry.ctu_y + r):
                qt((entry.ctu_x + c) << clg, (entry.ctu_y + r) << clg, clg)
                for r in range(entry.nb_ctu_h) for c in range(entry.nb_ctu_w)}
    return tb


def _with_alf(tb, rng):
    """Wrap a tree builder: attach random per-CTU ALF/CC-ALF params
    (1 luma APS set + fixed sets, 2 chroma alternatives, 1 CC filter)."""
    from openvvc_tpu.vcl.alf import AlfCtuParams

    def tb2(params, entry):
        trees = tb(params, entry)
        for node in trees.values():
            p = AlfCtuParams()
            luma_on = rng.rand() < 0.9
            p.ctb_alf_flag = int(luma_on) << 2
            if luma_on:
                p.ctb_alf_idx = int(rng.randint(0, 17))
            cbf, crf = rng.rand() < 0.7, rng.rand() < 0.7
            p.ctb_alf_flag |= (int(cbf) << 1) | int(crf)
            if cbf:
                p.cb_alternative = int(rng.randint(0, 2))
            if crf:
                p.cr_alternative = int(rng.randint(0, 2))
            p.cc_alf_idx = (int(rng.randint(0, 2)), int(rng.randint(0, 2)))
            node.alf = p
        return trees
    return tb2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--tiles", type=int, default=1,
                    help="number of tile columns (entry parallelism units)")
    ap.add_argument("--leaf-intra", type=int, default=5)
    ap.add_argument("--leaf-inter", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--gop", choices=["lowdelay", "ra"], default="lowdelay",
                    help="ra = GOP-4 B pyramid with TMVP + AMVR")
    ap.add_argument("--alf", action="store_true",
                    help="enable ALF + CC-ALF with per-CTU random params")
    ap.add_argument("--all-tools", action="store_true",
                    help="hostile profile: ALF + CC-ALF + LFNST + MIP + "
                         "LMCS (reshaper + chroma scaling) mix")
    ap.add_argument("--inter-tools", action="store_true",
                    help="hostile inter profile: MMVD + BCW + SMVD + CIIP "
                         "+ GPM mix in the inter frames")
    ap.add_argument("--full-inter", action="store_true",
                    help="everything --inter-tools has PLUS affine/SbTMVP "
                         "(PROF) and BDOF/DMVR — exercises the host C "
                         "recon fallback for the sub-block tools")
    ap.add_argument("--bitdepth", type=int, default=8, choices=(8, 10))
    ap.add_argument("--out", default="/tmp/bench_1080p.266")
    args = ap.parse_args()

    rng = np.random.RandomState(args.seed)
    if args.all_tools:
        args.alf = True
    # round picture to whole CTUs so uniform trees tile it exactly
    w = (args.width // 64) * 64
    h = (args.height // 64) * 64
    tile_cols = None
    if args.tiles > 1:
        nctu_w = w // 64
        per = nctu_w // args.tiles
        tile_cols = [per] * (args.tiles - 1) + [nctu_w - per * (args.tiles - 1)]
    it = args.inter_tools or args.full_inter
    fi = args.full_inter
    cfg = StreamConfig(width=w, height=h, bitdepth=args.bitdepth,
                       deblocking=True, sao=True,
                       tile_cols=tile_cols,
                       alf=args.alf, alf_chroma=args.alf, cc_alf=args.alf,
                       lfnst=args.all_tools, mip=args.all_tools,
                       transform_skip=args.all_tools,

                       lmcs=args.all_tools,
                       lmcs_params=(dict(cw_deltas={2: 10, 8: -8, 12: 12},
                                         crs=2)
                                    if args.all_tools else None),
                       lmcs_chroma_scaling=args.all_tools,
                       mmvd=it, bcw=it, smvd=it, ciip=it, gpm=it,
                       affine=fi, affine_6param=fi, prof=fi, sbtmvp=fi,
                       bdof=fi, dmvr=fi,
                       tmvp=args.gop == "ra" or fi,
                       amvr=args.gop == "ra")

    lf = args.all_tools
    frames = [{"tree_builder": _qt_tree(
        lambda x, y, l: _intra_cu(rng, x, y, l, lfnst=lf, mip=lf, ts=lf),
        args.leaf_intra)}]
    if args.gop == "ra":
        frames += ra_frame_specs(args.frames, rng, args.leaf_inter, _qt_tree,
                                 tools=it, affine=fi)
    else:
        for i in range(1, args.frames):
            frames.append({
                "tree_builder": _qt_tree(
                    lambda x, y, l: _inter_cu(rng, x, y, l, tools=it,
                                              affine=fi),
                    args.leaf_inter),
                "slice_type": 1,
                "ref_deltas": [1],
            })
    if args.alf:
        for spec in frames:
            spec["tree_builder"] = _with_alf(spec["tree_builder"], rng)
    stream = build_stream_frames(cfg, frames)
    with open(args.out, "wb") as f:
        f.write(stream)
    print(f"wrote {args.out}: {len(stream)} bytes, {args.frames} frames "
          f"{w}x{h}, tiles={args.tiles}")


if __name__ == "__main__":
    main()
