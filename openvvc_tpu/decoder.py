"""Top-level decoder: Annex-B stream -> YUV frames (numpy reference path).

This is the functional reference decode path: demux -> HLS activation ->
per-entry CABAC parse into CTU IR -> per-CU reconstruction in decode order.
It is the bit-exactness oracle for the batched device path (which consumes the
same IR wavefront-batched). Equivalent of the reference's ovdec + slicedec +
rcn stack for the currently supported toolset (all-intra).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from openvvc_tpu.hls.nal import NalType, demux_annexb, is_vcl
from openvvc_tpu.hls.params import ActiveParams, NvclContext
from openvvc_tpu.rcn.ref_dbf import DbfMaps, deblock_frame
from openvvc_tpu.rcn.ref_lmcs import build_lmcs, compute_chroma_scale, scale_residual
from openvvc_tpu.rcn.ref_alf import AlfFilters, apply_alf_entry
from openvvc_tpu.rcn.ref_sao import apply_sao_entry
from openvvc_tpu.rcn.ref_intra import predict_bdpcm, predict_intra
from openvvc_tpu.rcn.ref_cclm import predict_cclm
from openvvc_tpu.rcn.ref_mip import predict_mip
from openvvc_tpu.rcn.ref_isp import isp_transform_types, predict_isp_chunk, reconstruct_isp_tb
from openvvc_tpu.rcn.ref_mrl import predict_intra_mrl
from openvvc_tpu.rcn.ref_transform import (
    dequant,
    inverse_transform_2d,
    lfnst_intra_mode,
    reconstruct_tu_residual,
)
from openvvc_tpu.vcl.transform_unit import chroma_qp as _derive_chroma_qp
from openvvc_tpu.vcl.transform_unit import isp_part_dims
from openvvc_tpu.vcl.ctu import CU, TREE_DUAL_CHROMA, TREE_DUAL_LUMA, TREE_SINGLE, UNAVAIL
from openvvc_tpu.vcl.slice_data import parse_entry
from openvvc_tpu.dpb import DPB
from openvvc_tpu.utils import trace
from openvvc_tpu.rcn import ref_mc
from openvvc_tpu.drv.inter_mvp import MV_PRECISION_HALF
from openvvc_tpu.hls.ph import SLICE_I

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Directory of JAX's persistent compilation cache for the device lane:
    JAX_COMPILATION_CACHE_DIR when set, else the fixed <checkout>/.jax_cache
    (a fixed path is part of the cache key, so repeat runs hit)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


@dataclass
class Frame:
    poc: int
    y: np.ndarray
    cb: np.ndarray | None
    cr: np.ndarray | None
    bitdepth: int = 8

    def to_yuv_bytes(self) -> bytes:
        """Raw planar YUV as the reference dectest writes it."""
        self.sync_host()
        planes = [self.y] + ([self.cb, self.cr] if self.cb is not None else [])
        if self.bitdepth == 8:
            return b"".join(
                (p if p.dtype == np.uint8 else p.astype(np.uint8)).tobytes()
                for p in planes)
        return b"".join(p.astype("<u2").tobytes() for p in planes)

    def sync_host(self) -> None:
        """Fetch device-resident output planes (device frame path) to host.
        The packed buffer is fetched once (or taken from the prefetch
        thread's future) and split into the three planes. Planes keep the
        packed dtype (uint8/int16) — cheap for YUV output; host/native
        consumers that need int32 call ensure_int32()."""
        dev = getattr(self, "_dev_out", None)
        if dev is None:
            return
        flush = getattr(self, "_flush_cb", None)
        if flush is not None:
            flush()  # batched-fetch window still open: submit it now
        bf = getattr(self, "_batch_fetch", None)
        if bf is not None:
            fut, off, n = bf
            packed = fut.result()[off:off + n]
            self._batch_fetch = None
        else:
            fut = getattr(self, "_fetch_future", None)
            packed = fut.result() if fut is not None else np.asarray(dev)
            self._fetch_future = None
        H, W = self.y.shape
        n = H * W
        self.y = packed[:n].reshape(H, W)
        if self.cb is not None:
            m = (H // 2) * (W // 2)
            self.cb = packed[n:n + m].reshape(H // 2, W // 2)
            self.cr = packed[n + m:n + 2 * m].reshape(H // 2, W // 2)
        self._dev_out = None

    def ensure_int32(self) -> None:
        """Host-path contract: C recon and the numpy kernels read planes
        as contiguous int32."""
        self.sync_host()
        if self.y.dtype != np.int32:
            self.y = np.ascontiguousarray(self.y, np.int32)
            if self.cb is not None:
                self.cb = np.ascontiguousarray(self.cb, np.int32)
                self.cr = np.ascontiguousarray(self.cr, np.int32)


class ReconCtx:
    """Per-tile reconstruction state: planes + availability maps."""

    def __init__(self, frame: Frame, params: ActiveParams, entry):
        self.frame = frame
        self.params = params
        self.entry = entry
        sps = params.sps
        self.bitdepth = sps.bitdepth
        self.log2_ctb = sps.ctb_log2
        self.tile_x0 = entry.ctu_x << self.log2_ctb
        self.tile_y0 = entry.ctu_y << self.log2_ctb
        self.tile_w = min(entry.nb_ctu_w << self.log2_ctb, params.pps.pic_w - self.tile_x0)
        self.tile_h = min(entry.nb_ctu_h << self.log2_ctb, params.pps.pic_h - self.tile_y0)
        # availability maps (4-sample luma units / 2-sample chroma units)
        self.avail_l = np.zeros(((self.tile_h + 3) // 4, (self.tile_w + 3) // 4), bool)
        self.avail_c = np.zeros(((self.tile_h // 2 + 1) // 2 + 1, (self.tile_w // 2 + 1) // 2 + 1), bool)

    def luma_avail(self, x: int, y: int) -> bool:
        if not (self.tile_x0 <= x < self.tile_x0 + self.tile_w and self.tile_y0 <= y < self.tile_y0 + self.tile_h):
            return False
        return bool(self.avail_l[(y - self.tile_y0) >> 2, (x - self.tile_x0) >> 2])

    def chroma_avail(self, cx: int, cy: int) -> bool:
        tx, ty = self.tile_x0 >> 1, self.tile_y0 >> 1
        if not (tx <= cx < tx + (self.tile_w >> 1) and ty <= cy < ty + (self.tile_h >> 1)):
            return False
        return bool(self.avail_c[(cy - ty) >> 1, (cx - tx) >> 1])

    def mark_luma(self, x0, y0, log2_w, log2_h):
        ux, uy = (x0 - self.tile_x0) >> 2, (y0 - self.tile_y0) >> 2
        self.avail_l[uy : uy + max(1, (1 << log2_h) >> 2), ux : ux + max(1, (1 << log2_w) >> 2)] = True

    def mark_chroma(self, cx0, cy0, log2_w, log2_h):
        ux, uy = (cx0 - (self.tile_x0 >> 1)) >> 1, (cy0 - (self.tile_y0 >> 1)) >> 1
        self.avail_c[uy : uy + max(1, (1 << log2_h) >> 1), ux : ux + max(1, (1 << log2_w) >> 1)] = True


def _tu_units(x0, y0, log2_w, log2_h, max_tb):
    """TU-unit geometry of a CU (same splitting as transform_tree_intra)."""
    split_v = log2_w > max_tb
    split_h = log2_h > max_tb
    if not (split_v or split_h):
        return [(x0, y0, log2_w, log2_h)]
    l2w = log2_w - (1 if split_v else 0)
    l2h = log2_h - (1 if split_h else 0)
    coords = [(x0, y0)]
    if split_v:
        coords.append((x0 + (1 << l2w), y0))
    if split_h:
        coords.append((x0, y0 + (1 << l2h)))
    if split_v and split_h:
        coords.append((x0 + (1 << l2w), y0 + (1 << l2h)))
    out = []
    for cx, cy in coords:
        out.extend(_tu_units(cx, cy, l2w, l2h, max_tb))
    return out


class _TrCtx:
    def __init__(self, dep_quant, mts_implicit, mts_enabled=False, scale_c=False, lmcs=None):
        self.dep_quant = dep_quant
        self.mts_implicit = mts_implicit
        self.mts_enabled = mts_enabled
        self.scale_c = scale_c
        self.lmcs = lmcs


def _clip(v, bitdepth):
    return np.clip(v, 0, (1 << bitdepth) - 1)


class _QpCtx:
    """Adapter exposing what transform_unit.chroma_qp needs."""

    def __init__(self, params):
        self.params = params
        self.pps = params.pps
        self.sh = params.sh


def reconstruct_cu(rc: ReconCtx, cu: CU, params: ActiveParams, tools,
                   dbf: DbfMaps | None = None, refs=None):
    """Reconstruct one CU (all components it carries) in decode order."""
    bd = rc.bitdepth
    frame = rc.frame
    tree = cu.tree_type
    trc = _TrCtx(tools["dep_quant"], tools["mts_implicit"], tools.get("mts_enabled", False),
                 tools.get("scale_c", False), tools.get("lmcs"))

    lmcs = tools.get("lmcs")
    if lmcs is not None and tree != TREE_DUAL_CHROMA and (cu.x0 & 0x3F) == 0 and (cu.y0 & 0x3F) == 0:
        compute_chroma_scale(lmcs, frame.y, cu.x0, cu.y0, rc.luma_avail)

    if dbf is not None and tree in (TREE_SINGLE, TREE_DUAL_LUMA):
        # luma bs2 covers BDPCM too (drv_intra_cu fills the CU rect
        # unconditionally, drv_intra.c:369); chroma bs2 skips BDPCM
        # (rcn_tu_c, rcn_transform_tree.c:1368-1371)
        dbf.add_cu_luma(cu.x0, cu.y0, 1 << cu.log2_w, 1 << cu.log2_h, cu.qp,
                        cu.pred_mode == 0 or bool(cu.ciip_flag))
        if cu.pred_mode == 2 and cu.ibc_dbf is not None:
            # IBC neighbour-MV bs1 edges (drv_ibc.c set_ibc_df_map :271)
            xu, yu = cu.x0 >> 2, cu.y0 >> 2
            top_edges, lft_edges = cu.ibc_dbf
            for i in top_edges:
                dbf.bs1_hor[yu, xu + i] = True
            for i in lft_edges:
                dbf.bs1_ver[yu + i, xu] = True
        if cu.pred_mode == 1 and refs is not None:
            if cu.gpm_flag:
                for (ox, oy, idir, m0, m1) in cu.gpm_units:
                    d0 = refs[2][m0.ref_idx] if idir & 1 else 0
                    d1 = refs[3][m1.ref_idx] if idir & 2 else 0
                    dbf.add_cu_motion(cu.x0 + 4 * ox, cu.y0 + 4 * oy, 4, 4,
                                      idir, m0, m1, d0, d1)
            elif cu.sb_info is not None:
                dbf.add_sb_edges(cu.x0, cu.y0, 1 << cu.log2_w,
                                 1 << cu.log2_h, True)
                _dbf_sb_motion(dbf, cu, refs)
            else:
                inter_dir = cu.inter_dir if cu.mv1 is not None else 1
                d0 = refs[2][cu.mv0.ref_idx] if inter_dir & 1 else 0
                d1 = refs[3][cu.mv1.ref_idx] if (inter_dir & 2 and cu.mv1 is not None) else 0
                dbf.add_cu_motion(cu.x0, cu.y0, 1 << cu.log2_w, 1 << cu.log2_h,
                                  inter_dir, cu.mv0, cu.mv1, d0, d1)
        if cu.isp_mode:
            # ISP: edges at prediction chunks (>=4 wide/high), recon_isp_subtree
            l2pw, l2ph, nb_pb = isp_part_dims(cu.log2_w, cu.log2_h, cu.isp_mode)
            l2pw, l2ph = max(2, l2pw), max(2, l2ph)
            if cu.isp_mode == 2:
                for px in range(cu.x0, cu.x0 + (1 << cu.log2_w), 1 << l2pw):
                    dbf.add_tb_luma(px, cu.y0, 1 << l2pw, 1 << cu.log2_h)
            else:
                for py in range(cu.y0, cu.y0 + (1 << cu.log2_h), 1 << l2ph):
                    dbf.add_tb_luma(cu.x0, py, 1 << cu.log2_w, 1 << l2ph)
        else:
            for tu in cu.tus:
                if tu.comp == 0 and tu.cbf:
                    dbf.add_tb_luma(tu.x0, tu.y0, 1 << tu.log2_w, 1 << tu.log2_h)
    if dbf is not None and tree != TREE_DUAL_LUMA and rc.params.sps.sps_chroma_format_idc:
        qctx = _QpCtx(params)
        qp_bd = params.qp_bd_offset
        qp_cb = _derive_chroma_qp(qctx, 1, cu.qp) - qp_bd
        qp_cr = _derive_chroma_qp(qctx, 2, cu.qp) - qp_bd
        if tree == TREE_DUAL_CHROMA:
            cx0, cy0, cw, ch = cu.x0, cu.y0, 1 << cu.log2_w, 1 << cu.log2_h
        else:
            cx0, cy0, cw, ch = cu.x0 >> 1, cu.y0 >> 1, 1 << (cu.log2_w - 1), 1 << (cu.log2_h - 1)
        dbf.add_cu_chroma(cx0, cy0, cw, ch, qp_cb, qp_cr,
                          (cu.pred_mode == 0 and not cu.bdpcm_c)
                          or bool(cu.ciip_flag))
        for tu in cu.tus:
            # BDPCM-chroma TBs raise neither bs1 nor bs2 (the reference
            # gates both fills on !intra_bdpcm_chroma_flag,
            # rcn_transform_tree.c:755/789/836)
            if tu.comp in (1, 2, 3) and tu.cbf and not cu.bdpcm_c:
                comps = (1, 2) if tu.comp == 3 else (tu.comp,)
                for comp in comps:
                    dbf.add_tb_chroma(comp, tu.x0, tu.y0, 1 << tu.log2_w, 1 << tu.log2_h)

    def find_tu(comp, x, y):
        for tu in cu.tus:
            if tu.comp == comp and tu.x0 == x and tu.y0 == y:
                return tu
        return None

    if cu.pred_mode == 1:  # MODE_INTER
        if cu.sb_info is not None:
            _reconstruct_sb(rc, cu, params, trc, refs, find_tu)
        else:
            _reconstruct_inter(rc, cu, params, trc, refs, find_tu)
        return
    if cu.pred_mode == 2:  # MODE_IBC
        _reconstruct_ibc(rc, cu, params, trc)
        return

    if cu.isp_mode and tree in (TREE_SINGLE, TREE_DUAL_LUMA):
        _reconstruct_isp_luma(rc, cu, trc, find_tu)
    elif tree in (TREE_SINGLE, TREE_DUAL_LUMA):
        part = params.part_info["intra_luma"]
        for ux, uy, l2w, l2h in _tu_units(cu.x0, cu.y0, cu.log2_w, cu.log2_h, part.log2_max_tb_s):
            if cu.bdpcm_l:
                pred = predict_bdpcm(frame.y, ux, uy, l2w, l2h, cu.bdpcm_dir_l,
                                     rc.luma_avail, bd, 4)
            elif cu.mip_flag:
                pred = predict_mip(frame.y, ux, uy, l2w, l2h, cu.mip_mode,
                                   cu.mip_transpose, rc.luma_avail, bd)
            elif cu.mrl_idx:
                pred = predict_intra_mrl(frame.y, ux, uy, l2w, l2h, cu.intra_mode_l,
                                         cu.mrl_idx, rc.luma_avail, bd)
            else:
                pred = predict_intra(frame.y, ux, uy, l2w, l2h, cu.intra_mode_l, rc.luma_avail, bd, luma=True)
            tu = find_tu(0, ux, uy)
            if tu is not None:
                lmode = None
                if tu.lfnst_idx:
                    base_mode = 0 if cu.mip_flag else cu.intra_mode_l
                    lmode = lfnst_intra_mode(min(5, l2w), min(5, l2h), base_mode)
                res = reconstruct_tu_residual(tu, trc, bd, lfnst_mode=lmode, is_mip=bool(cu.mip_flag))
                pred = pred + res
            frame.y[uy : uy + (1 << l2h), ux : ux + (1 << l2w)] = _clip(pred, bd)
            rc.mark_luma(ux, uy, l2w, l2h)

    if tree == TREE_SINGLE and rc.params.sps.sps_chroma_format_idc and cu.tree_type == TREE_SINGLE:
        _reconstruct_chroma(rc, cu, params, trc, cu.x0 >> 1, cu.y0 >> 1, cu.log2_w - 1, cu.log2_h - 1)
    elif tree == TREE_DUAL_CHROMA:
        _reconstruct_chroma(rc, cu, params, trc, cu.x0, cu.y0, cu.log2_w, cu.log2_h)


def _reconstruct_ibc(rc: ReconCtx, cu: CU, params, trc):
    """IBC block copy (rcn_ibc.c parity) + inter-style residual add."""
    from openvvc_tpu.drv.ibc import ibc_copy

    bd = rc.bitdepth
    frame = rc.frame
    log2_ctb = rc.log2_ctb
    ctb_x, ctb_y = cu.x0 >> log2_ctb, cu.y0 >> log2_ctb
    w, h = 1 << cu.log2_w, 1 << cu.log2_h
    mvx, mvy = cu.ibc_mv
    ibc_copy(frame.y, cu.x0, cu.y0, w, h, mvx, mvy, ctb_x, ctb_y,
             log2_ctb, chroma=False)
    _add_luma_residuals(rc, cu, trc, bd)
    rc.mark_luma(cu.x0, cu.y0, cu.log2_w, cu.log2_h)
    if params.sps.sps_chroma_format_idc:
        ibc_copy(frame.cb, cu.x0, cu.y0, w, h, mvx, mvy, ctb_x, ctb_y,
                 log2_ctb, chroma=True)
        ibc_copy(frame.cr, cu.x0, cu.y0, w, h, mvx, mvy, ctb_x, ctb_y,
                 log2_ctb, chroma=True)
        _add_chroma_residuals(rc, cu, params, trc, bd)


def _wave_eligible(cu, params) -> bool:
    """Regular intra luma CU batchable by predict_intra_group."""
    if cu.pred_mode != 0 or cu.tree_type != TREE_SINGLE:
        return False
    if cu.mip_flag or cu.mrl_idx or cu.isp_mode or cu.bdpcm_l:
        return False
    part = params.part_info["intra_luma"]
    return cu.log2_w <= part.log2_max_tb_s and cu.log2_h <= part.log2_max_tb_s


def _recon_entry_waves(rc: ReconCtx, ectx, params, tools, dbf, refs):
    """Wavefront-batched intra reconstruction for one entry (device path).

    CUs are grouped into dependency waves over the 4x4 unit grid using a
    conservative reference span (everything an intra prediction may probe);
    CUs within a wave are independent by construction, so all regular luma
    predictions of a wave run as batched device launches
    (jax_intra.predict_intra_group) while the rest fall back to the scalar
    path at their wave position. This is SURVEY §7.1's anti-diagonal CTU
    batching generalized to exact CU-level dependencies.
    """
    from openvvc_tpu.rcn.jax_intra import predict_intra_group

    bd = rc.bitdepth
    frame = rc.frame
    trc = _TrCtx(tools["dep_quant"], tools["mts_implicit"],
                 tools.get("mts_enabled", False), tools.get("scale_c", False),
                 tools.get("lmcs"))
    cus = [cu for ctu in ectx.ctus for cu in ctu.cus]
    uh, uw = rc.avail_l.shape
    wave_map = np.zeros((uh, uw), np.int32)
    tx, ty = rc.tile_x0, rc.tile_y0
    waves: dict[int, list] = {}
    for cu in cus:
        ux, uy = (cu.x0 - tx) >> 2, (cu.y0 - ty) >> 2
        w_u = max(1, (1 << cu.log2_w) >> 2)
        h_u = max(1, (1 << cu.log2_h) >> 2)
        x_lo, y_lo = max(0, ux - 1), max(0, uy - 1)
        x_hi = min(uw, ux + 2 * w_u + 2)
        y_hi = min(uh, uy + 2 * h_u + 2)
        wv = 0
        if uy > 0:
            wv = max(wv, int(wave_map[y_lo:uy, x_lo:x_hi].max(initial=0)))
        if ux > 0:
            wv = max(wv, int(wave_map[y_lo:y_hi, x_lo:ux].max(initial=0)))
        wv += 1
        wave_map[uy : uy + h_u, ux : ux + w_u] = wv
        waves.setdefault(wv, []).append(cu)

    # below this group size the fixed device launch+fetch latency beats the
    # batched win; those CUs run scalar at their wave position
    min_batch = int(os.environ.get("OPENVVC_WAVE_MIN_BATCH", "8"))
    for wv in sorted(waves):
        groups: dict = {}
        scalar = []
        for cu in waves[wv]:
            if _wave_eligible(cu, params):
                groups.setdefault((cu.log2_w, cu.log2_h, cu.intra_mode_l),
                                  []).append(cu)
            else:
                scalar.append(cu)
        for key in [k for k, g in groups.items() if len(g) < min_batch]:
            scalar.extend(groups.pop(key))
        for (l2w, l2h, mode), grp in groups.items():
            preds = predict_intra_group(frame.y, [(c.x0, c.y0) for c in grp],
                                        l2w, l2h, mode, rc.luma_avail, bd,
                                        luma=True)
            for i, cu in enumerate(grp):
                if dbf is not None:
                    dbf.add_cu_luma(cu.x0, cu.y0, 1 << l2w, 1 << l2h,
                                    cu.qp, True)
                pred = preds[i]
                tu = next((t for t in cu.tus
                           if t.comp == 0 and t.x0 == cu.x0 and t.y0 == cu.y0), None)
                if tu is not None:
                    lmode = None
                    if tu.lfnst_idx:
                        lmode = lfnst_intra_mode(min(5, l2w), min(5, l2h),
                                                 cu.intra_mode_l)
                    pred = pred + reconstruct_tu_residual(tu, trc, bd,
                                                          lfnst_mode=lmode)
                    if dbf is not None and tu.cbf:
                        dbf.add_tb_luma(tu.x0, tu.y0, 1 << l2w, 1 << l2h)
                frame.y[cu.y0 : cu.y0 + (1 << l2h),
                        cu.x0 : cu.x0 + (1 << l2w)] = _clip(pred, bd)
                rc.mark_luma(cu.x0, cu.y0, l2w, l2h)
                if rc.params.sps.sps_chroma_format_idc:
                    if dbf is not None:
                        qctx = _QpCtx(params)
                        qp_bd = params.qp_bd_offset
                        qp_cb = _derive_chroma_qp(qctx, 1, cu.qp) - qp_bd
                        qp_cr = _derive_chroma_qp(qctx, 2, cu.qp) - qp_bd
                        dbf.add_cu_chroma(cu.x0 >> 1, cu.y0 >> 1,
                                          1 << (l2w - 1), 1 << (l2h - 1),
                                          qp_cb, qp_cr, True)
                        for t in cu.tus:
                            if t.comp in (1, 2, 3) and t.cbf:
                                comps = (1, 2) if t.comp == 3 else (t.comp,)
                                for comp in comps:
                                    dbf.add_tb_chroma(comp, t.x0, t.y0,
                                                      1 << t.log2_w,
                                                      1 << t.log2_h)
                    _reconstruct_chroma(rc, cu, params, trc, cu.x0 >> 1,
                                        cu.y0 >> 1, l2w - 1, l2h - 1)
        for cu in scalar:
            reconstruct_cu(rc, cu, params, tools, dbf, refs)


def _dbf_sb_motion(dbf: DbfMaps, cu, refs):
    """Per-4x4-unit motion info for affine/SbTMVP CUs (the inter BS rule
    compares sub-block MVs across sub-block edges)."""
    if cu.sb_info[0] == "sbtmvp":
        for (ox, oy, idir, m0, m1, l2w, l2h) in cu.sb_info[1]:
            d0 = refs[2][m0.ref_idx] if idir & 1 else 0
            d1 = refs[3][m1.ref_idx] if (idir & 2 and m1 is not None) else 0
            dbf.add_cu_motion(cu.x0 + ox, cu.y0 + oy, 1 << l2w, 1 << l2h,
                              idir, m0, m1, d0, d1)
        return
    _, sub0, sub1, inter_dir, *_rest = cu.sb_info
    nw = (1 << cu.log2_w) >> 2
    nh = (1 << cu.log2_h) >> 2
    for i in range(nh):
        for j in range(nw):
            m0 = sub0[i][j] if sub0 is not None else None
            m1 = sub1[i][j] if sub1 is not None else None
            d0 = refs[2][m0.ref_idx] if inter_dir & 1 else 0
            d1 = refs[3][m1.ref_idx] if inter_dir & 2 else 0
            dbf.add_cu_motion(cu.x0 + 4 * j, cu.y0 + 4 * i, 4, 4,
                              inter_dir, m0, m1, d0, d1)


def _reconstruct_gpm(rc: ReconCtx, cu, params, trc, refs, find_tu):
    """GPM: two uni 14-bit predictions blended with the geometric weight
    mask (rcn_inter.c :2560-2615), then the regular residual path."""
    from openvvc_tpu.drv.gpm import gpm_weights

    bd = rc.bitdepth
    frame = rc.frame
    refs0, refs1 = refs[0], refs[1]
    pic_w, pic_h = params.pps.pic_w, params.pps.pic_h
    w, h = 1 << cu.log2_w, 1 << cu.log2_h
    (d0, d1), (m0, m1) = cu.gpm_dirs, cu.gpm_mvs

    def uni14(mv, lst, plane_sel, cx, cy, bw, bh, luma):
        ref = (refs0 if lst == 1 else refs1)[mv.ref_idx]
        plane = getattr(ref, plane_sel)
        mvx, mvy = _clip_mv(cu.x0, cu.y0, pic_w, pic_h, w, h, mv.x, mv.y)
        sh = 4 if luma else 5
        msk = 0xF if luma else 0x1F
        return ref_mc.interp_14bit(plane, cx + (mvx >> sh), cy + (mvy >> sh),
                                   mvx & msk, mvy & msk, bw, bh, bd, luma=luma)

    w0 = gpm_weights(cu.gpm_split_dir, cu.log2_w, cu.log2_h)
    p0 = uni14(m0, d0, "y", cu.x0, cu.y0, w, h, True)
    p1 = uni14(m1, d1, "y", cu.x0, cu.y0, w, h, True)
    pred_y = ref_mc.gpm_blend(p0, p1, w0, bd)
    if trc.lmcs is not None:
        pred_y = trc.lmcs.fwd_lut[np.asarray(pred_y)].astype(np.int32)

    part = params.part_info["inter_luma"]
    for ux, uy, l2w, l2h in _tu_units(cu.x0, cu.y0, cu.log2_w, cu.log2_h,
                                      part.log2_max_tb_s):
        blk = pred_y[uy - cu.y0 : uy - cu.y0 + (1 << l2h),
                     ux - cu.x0 : ux - cu.x0 + (1 << l2w)]
        tu = find_tu(0, ux, uy)
        if tu is not None:
            blk = blk + reconstruct_tu_residual(tu, trc, bd, intra=False)
        frame.y[uy : uy + (1 << l2h), ux : ux + (1 << l2w)] = _clip(blk, bd)
    rc.mark_luma(cu.x0, cu.y0, cu.log2_w, cu.log2_h)

    if not params.sps.sps_chroma_format_idc:
        return
    cx0, cy0 = cu.x0 >> 1, cu.y0 >> 1
    cw, ch = w >> 1, h >> 1
    w0c = w0[::2, ::2]
    pcb0 = uni14(m0, d0, "cb", cx0, cy0, cw, ch, False)
    pcb1 = uni14(m1, d1, "cb", cx0, cy0, cw, ch, False)
    pcr0 = uni14(m0, d0, "cr", cx0, cy0, cw, ch, False)
    pcr1 = uni14(m1, d1, "cr", cx0, cy0, cw, ch, False)
    pred_cb = ref_mc.gpm_blend(pcb0, pcb1, w0c, bd)
    pred_cr = ref_mc.gpm_blend(pcr0, pcr1, w0c, bd)
    frame.cb[cy0 : cy0 + ch, cx0 : cx0 + cw] = _clip(pred_cb, bd)
    frame.cr[cy0 : cy0 + ch, cx0 : cx0 + cw] = _clip(pred_cr, bd)
    _add_chroma_residuals(rc, cu, params, trc, bd)


def _add_luma_residuals(rc: ReconCtx, cu, trc, bd):
    frame = rc.frame
    for tu in cu.tus:
        if tu.comp == 0 and tu.cbf:
            res = reconstruct_tu_residual(tu, trc, bd, intra=False)
            th, tw = 1 << tu.log2_h, 1 << tu.log2_w
            region = frame.y[tu.y0 : tu.y0 + th, tu.x0 : tu.x0 + tw].astype(np.int64)
            frame.y[tu.y0 : tu.y0 + th, tu.x0 : tu.x0 + tw] = _clip(region + res, bd)


def _reconstruct_dmvr(rc: ReconCtx, cu, params, trc, refs, hpel, apply_bdof):
    """DMVR sub-PU refinement + final MC (rcn_dmvr_mv_refine parity)."""
    from openvvc_tpu.drv.inter_mvp import MV
    from openvvc_tpu.rcn.ref_bdof import (bdof_from_positions, dmvr_padded_patch,
                                          dmvr_refine)

    bd = rc.bitdepth
    frame = rc.frame
    refs0, refs1 = refs[0], refs[1]
    pic_w, pic_h = params.pps.pic_w, params.pps.pic_h
    r0 = refs0[cu.mv0.ref_idx]
    r1 = refs1[cu.mv1.ref_idx]
    w, h = 1 << cu.log2_w, 1 << cu.log2_h
    sb_w, sb_h = min(16, w), min(16, h)

    def clip_fn(px, py, bw, bh, mx, my):
        return _clip_mv(px, py, pic_w, pic_h, bw, bh, mx, my)

    for sy in range(0, h, sb_h):
        for sx in range(0, w, sb_w):
            pos_x, pos_y = cu.x0 + sx, cu.y0 + sy
            mv0, mv1 = cu.mv0, cu.mv1
            (n0x, n0y), (n1x, n1y), min_cost = dmvr_refine(
                r0.y, r1.y, pos_x, pos_y, mv0, mv1, sb_w, sb_h, bd, clip_fn)
            nmv0 = MV(n0x, n0y, mv0.ref_idx, mv0.bcw_idx_plus1, mv0.prec_amvr)
            nmv1 = MV(n1x, n1y, mv1.ref_idx, mv1.bcw_idx_plus1, mv1.prec_amvr)

            # TMVP field override on the 8x8 grid (reference hack)
            gx = (pos_x + 7) >> 3
            gy = (pos_y + 7) >> 3
            tm0 = MV(n0x, n0y, mv0.ref_idx)
            tm1 = MV(n1x, n1y, mv1.ref_idx)
            ov = rc.dmvr_overrides
            ov.append((gx, gy, tm0, tm1))
            if sb_w > 8:
                ov.append((gx + 1, gy, tm0, tm1))
            if sb_h > 8:
                ov.append((gx, gy + 1, tm0, tm1))
                if sb_w > 8:
                    ov.append((gx + 1, gy + 1, tm0, tm1))

            # final MC from the original-position padded patches
            mvx0, mvy0 = clip_fn(pos_x, pos_y, sb_w, sb_h, mv0.x, mv0.y)
            mvx1, mvy1 = clip_fn(pos_x, pos_y, sb_w, sb_h, mv1.x, mv1.y)
            p0patch, (o0x, o0y) = dmvr_padded_patch(
                r0.y, pos_x + (mvx0 >> 4), pos_y + (mvy0 >> 4), sb_w, sb_h)
            p1patch, (o1x, o1y) = dmvr_padded_patch(
                r1.y, pos_x + (mvx1 >> 4), pos_y + (mvy1 >> 4), sb_w, sb_h)
            d0x = (n0x >> 4) - (mvx0 >> 4)
            d0y = (n0y >> 4) - (mvy0 >> 4)
            d1x = (n1x >> 4) - (mvx1 >> 4)
            d1y = (n1y >> 4) - (mvy1 >> 4)
            px0, py0 = 5 + d0x, 5 + d0y
            px1, py1 = 5 + d1x, 5 + d1y
            f0x, f0y = n0x & 15, n0y & 15
            f1x, f1y = n1x & 15, n1y & 15
            if hpel:
                f0x += 8 if f0x == 8 else 0
                f0y += 8 if f0y == 8 else 0
                f1x += 8 if f1x == 8 else 0
                f1y += 8 if f1y == 8 else 0
            disable_bdof = (min_cost < 2 * sb_w * sb_h) if apply_bdof else True
            if disable_bdof:
                q0 = ref_mc.interp_14bit(p0patch, px0, py0, f0x, f0y, sb_w, sb_h,
                                         bd, luma=True, hpel=False)
                q1 = ref_mc.interp_14bit(p1patch, px1, py1, f1x, f1y, sb_w, sb_h,
                                         bd, luma=True, hpel=False)
                blk = ref_mc.mc_bi(q0, q1, bd)
            else:
                blk = bdof_from_positions(p0patch, px0, py0, f0x, f0y,
                                          p1patch, px1, py1, f1x, f1y,
                                          sb_w, sb_h, bd, False)
            blk = np.asarray(blk)
            if trc.lmcs is not None:
                blk = trc.lmcs.fwd_lut[_clip(blk, bd)].astype(np.int32)
            frame.y[pos_y : pos_y + sb_h, pos_x : pos_x + sb_w] = _clip(blk, bd)

            # chroma: original-position patches, refined frac + int delta
            cxp, cyp = pos_x >> 1, pos_y >> 1
            cw, ch = sb_w >> 1, sb_h >> 1
            for (plane_name, dst) in (("cb", frame.cb), ("cr", frame.cr)):
                pl0 = getattr(r0, plane_name)
                pl1 = getattr(r1, plane_name)
                # chroma int position from the ORIGINAL clipped mv (>>5)
                cx0i = cxp + (mvx0 >> 5)
                cy0i = cyp + (mvy0 >> 5)
                cx1i = cxp + (mvx1 >> 5)
                cy1i = cyp + (mvy1 >> 5)
                # padded chroma patch: EPEL margins (1 before, 2 after) + 2
                pat0 = _chroma_patch(pl0, cx0i, cy0i, cw, ch)
                pat1 = _chroma_patch(pl1, cx1i, cy1i, cw, ch)
                dc0x = (n0x >> 5) - (mvx0 >> 5)
                dc0y = (n0y >> 5) - (mvy0 >> 5)
                dc1x = (n1x >> 5) - (mvx1 >> 5)
                dc1y = (n1y >> 5) - (mvy1 >> 5)
                q0 = ref_mc.interp_14bit(pat0, 3 + dc0x, 3 + dc0y,
                                         n0x & 31, n0y & 31, cw, ch, bd, luma=False)
                q1 = ref_mc.interp_14bit(pat1, 3 + dc1x, 3 + dc1y,
                                         n1x & 31, n1y & 31, cw, ch, bd, luma=False)
                dst[cyp : cyp + ch, cxp : cxp + cw] = _clip(
                    np.asarray(ref_mc.mc_bi(q0, q1, bd)), bd)
    rc.mark_chroma(cu.x0 >> 1, cu.y0 >> 1, cu.log2_w - 1, cu.log2_h - 1)


def _chroma_patch(plane, ref_x, ref_y, w, h):
    """EPEL margins + 2-sample REPLICATED pad (padd_dmvr_c parity)."""
    from openvvc_tpu.rcn.ref_bdof import _int_patch

    core = _int_patch(plane, ref_x - 1, ref_y - 1, w + 3, h + 3)
    return np.pad(core, 2, mode="edge").astype(np.int32)


def _add_chroma_residuals(rc: ReconCtx, cu, params, trc, bd):
    """Add inter chroma TU residuals at their own rects (jcbcr aware)."""
    frame = rc.frame
    csign = -1 if params.ph.ph_joint_cbcr_sign_flag else 1
    for tu in cu.tus:
        if tu.comp == 0 or not tu.cbf:
            continue
        res = reconstruct_tu_residual(tu, trc, bd, intra=False)
        if tu.comp == 3:
            if tu.joint_cbcr == 3:
                pairs = ((frame.cb, res), (frame.cr, csign * res))
            elif tu.joint_cbcr == 2:
                pairs = ((frame.cb, res), (frame.cr, (csign * res) >> 1))
            else:
                pairs = ((frame.cr, res), (frame.cb, (csign * res) >> 1))
        else:
            pairs = ((frame.cb if tu.comp == 1 else frame.cr, res),)
        th, tw = 1 << tu.log2_h, 1 << tu.log2_w
        for plane, r in pairs:
            if trc.scale_c and tu.log2_w + tu.log2_h > 2 and trc.lmcs is not None:
                r = scale_residual(r, trc.lmcs.chroma_scale, bd)
            region = plane[tu.y0 : tu.y0 + th, tu.x0 : tu.x0 + tw].astype(np.int64)
            plane[tu.y0 : tu.y0 + th, tu.x0 : tu.x0 + tw] = _clip(region + r, bd)
    rc.mark_chroma(cu.x0 >> 1, cu.y0 >> 1, cu.log2_w - 1, cu.log2_h - 1)


def _rpr_scale(params, lst, ref_idx):
    """Non-unit (scale_hor, scale_ver) for a ref, or None (normal MC)."""
    sc = getattr(params, "_rpr_scales", None)
    if sc is None:
        return None
    from openvvc_tpu.rcn.ref_rpr import NO_SCALE

    s = sc[lst][ref_idx]
    return None if s == (NO_SCALE, NO_SCALE) else s


def _clip_mv(pos_x, pos_y, pic_w, pic_h, pb_w, pb_h, mvx, mvy):
    """rcn_inter.c clip_mv parity (:97)."""
    x_max = (pic_w + 2 - pos_x) << 4
    y_max = (pic_h + 2 - pos_y) << 4
    x_min = -((pb_w + 3 + pos_x) << 4)
    y_min = -((pb_h + 3 + pos_y) << 4)
    return max(x_min, min(x_max, mvx)), max(y_min, min(y_max, mvy))


def _bcw_weighted(cu, inter_dir) -> tuple[int, bool]:
    bcw_p1 = cu.mv0.bcw_idx_plus1 if cu.mv0 is not None else 0
    return bcw_p1, inter_dir == 3 and bcw_p1 not in (0, 3)


def inter_tool_flags(cu, tools, refs):
    """(bdof_en, dmvr_en) for one inter CU — the single source of truth
    shared by the scalar path and the batched device pipeline.

    BDOF applies to both merge and AMVP bi CUs (read_bidir_mvp :2447);
    DMVR only to regular merge (prediction_unit_inter_b :2585)."""
    inter_dir = cu.inter_dir if cu.mv1 is not None else 1
    _, bcw_weighted = _bcw_weighted(cu, inter_dir)
    dist_sym = False
    if inter_dir == 3 and not cu.ciip_flag:
        dist_sym = refs[2][cu.mv0.ref_idx] == -refs[3][cu.mv1.ref_idx]
    size_ok = cu.log2_w >= 3 and cu.log2_h >= 3 and cu.log2_w + cu.log2_h >= 7
    bdof_en = (tools.get("bdof") and inter_dir == 3
               and not cu.ciip_flag and size_ok and not bcw_weighted
               and not cu.smvd_flag and dist_sym)
    dmvr_en = (tools.get("dmvr") and inter_dir == 3 and cu.merge_flag
               and not cu.ciip_flag and size_ok and not bcw_weighted
               and not cu.mmvd_flag and dist_sym)
    return bdof_en, dmvr_en


def _mcp_block(rc: ReconCtx, params, trc, refs, pos_x, pos_y, log2_w, log2_h,
               inter_dir, mv0, mv1, luma=True, chroma=True):
    """Plain MC for one block (rcn_mcp_b / rcn_mcp_b_c parity incl. the
    identical-motion reduction to list-1 uni, rcn_inter.c :256-267)."""
    bd = rc.bitdepth
    frame = rc.frame
    refs0, refs1 = refs[0], refs[1]
    pic_w, pic_h = params.pps.pic_w, params.pps.pic_h
    w, h = 1 << log2_w, 1 << log2_h

    if inter_dir == 3:
        ident = (refs0[mv0.ref_idx] is refs1[mv1.ref_idx]
                 and mv0.x == mv1.x and mv0.y == mv1.y)
        if ident:
            inter_dir = 2

    def clipped(mv):
        return _clip_mv(pos_x, pos_y, pic_w, pic_h, w, h, mv.x, mv.y)

    bcw_p1 = mv0.bcw_idx_plus1 if (inter_dir & 1) and mv0 is not None else 0
    weighted = inter_dir == 3 and bcw_p1 not in (0, 3)
    _BCW_W = (-2, 3, 4, 5, 10)

    if luma:
        if inter_dir == 3:
            x0v, y0v = clipped(mv0)
            x1v, y1v = clipped(mv1)
            p0 = ref_mc.interp_14bit(refs0[mv0.ref_idx].y, pos_x + (x0v >> 4),
                                     pos_y + (y0v >> 4), x0v & 15, y0v & 15,
                                     w, h, bd, luma=True)
            p1 = ref_mc.interp_14bit(refs1[mv1.ref_idx].y, pos_x + (x1v >> 4),
                                     pos_y + (y1v >> 4), x1v & 15, y1v & 15,
                                     w, h, bd, luma=True)
            if weighted:
                w1 = _BCW_W[bcw_p1 - 1]
                pred = ref_mc.mc_bi_weighted(p0, p1, bd, 3, 8 - w1, w1)
            else:
                pred = ref_mc.mc_bi(p0, p1, bd)
        else:
            mv = mv0 if inter_dir & 1 else mv1
            ref = (refs0 if inter_dir & 1 else refs1)[mv.ref_idx]
            mvx, mvy = clipped(mv)
            pred = ref_mc.mc_uni(ref.y, pos_x + (mvx >> 4), pos_y + (mvy >> 4),
                                 mvx & 15, mvy & 15, w, h, bd, luma=True)
        pred = np.asarray(pred)
        if trc.lmcs is not None:
            pred = trc.lmcs.fwd_lut[pred].astype(np.int32)
        frame.y[pos_y : pos_y + h, pos_x : pos_x + w] = _clip(pred, bd)

    if chroma and params.sps.sps_chroma_format_idc:
        cx, cy = pos_x >> 1, pos_y >> 1
        cw, ch = w >> 1, h >> 1
        for pname, dst in (("cb", frame.cb), ("cr", frame.cr)):
            if inter_dir == 3:
                ps = []
                for lst, mv in ((0, mv0), (1, mv1)):
                    ref = (refs0 if lst == 0 else refs1)[mv.ref_idx]
                    mvx, mvy = clipped(mv)
                    ps.append(ref_mc.interp_14bit(
                        getattr(ref, pname), cx + (mvx >> 5), cy + (mvy >> 5),
                        mvx & 31, mvy & 31, cw, ch, bd, luma=False))
                if weighted:
                    w1 = _BCW_W[bcw_p1 - 1]
                    pred = ref_mc.mc_bi_weighted(ps[0], ps[1], bd, 3, 8 - w1, w1)
                else:
                    pred = ref_mc.mc_bi(ps[0], ps[1], bd)
            else:
                mv = mv0 if inter_dir & 1 else mv1
                ref = (refs0 if inter_dir & 1 else refs1)[mv.ref_idx]
                mvx, mvy = clipped(mv)
                pred = ref_mc.mc_uni(getattr(ref, pname), cx + (mvx >> 5),
                                     cy + (mvy >> 5), mvx & 31, mvy & 31,
                                     cw, ch, bd, luma=False)
            dst[cy : cy + ch, cx : cx + cw] = _clip(np.asarray(pred), bd)


def _reconstruct_sb(rc: ReconCtx, cu: CU, params, trc, refs, find_tu):
    """Affine / SbTMVP sub-block reconstruction.

    Parity: drv_affine_mvp.c rcn_affine_mcp_b_l (:3265, per-4x4 luma MC),
    rcn_affine_prof_mcp_b_l (:3314, PROF), rcn_affine_mcp_b_c (:3368,
    per-8x8 chroma with averaged MVs), derive_sub_block_mvs MC (:2165).
    """
    from openvvc_tpu.drv.affine import compute_prof_dmv_scale
    from openvvc_tpu.rcn.ref_prof import prof_mrg, prof_mrg_w, prof_sb

    bd = rc.bitdepth
    frame = rc.frame
    refs0, refs1 = refs[0], refs[1]
    pic_w, pic_h = params.pps.pic_w, params.pps.pic_h
    kind = cu.sb_info[0]

    if kind == "sbtmvp":
        for (ox, oy, idir, m0, m1, l2w, l2h) in cu.sb_info[1]:
            _mcp_block(rc, params, trc, refs, cu.x0 + ox, cu.y0 + oy,
                       l2w, l2h, idir, m0, m1)
    else:
        _, sub0, sub1, inter_dir, prof_dir, dmv0, dmv1 = cu.sb_info
        nw = (1 << cu.log2_w) >> 2
        nh = (1 << cu.log2_h) >> 2
        pdh0 = pdv0 = pdh1 = pdv1 = None
        if prof_dir & 1:
            pdh0, pdv0 = compute_prof_dmv_scale(dmv0)
        if prof_dir & 2:
            pdh1, pdv1 = compute_prof_dmv_scale(dmv1)
        _BCW_W = (-2, 3, 4, 5, 10)

        for i in range(nh):
            for j in range(nw):
                px, py = cu.x0 + 4 * j, cu.y0 + 4 * i
                mv0 = sub0[i][j] if sub0 is not None else None
                mv1 = sub1[i][j] if sub1 is not None else None
                if not prof_dir:
                    _mcp_block(rc, params, trc, refs, px, py, 2, 2,
                               inter_dir, mv0, mv1, chroma=False)
                    continue
                # PROF luma (rcn_prof_mcp_b_l / rcn_prof_motion_compensation)
                def interp14(lst, mv):
                    ref = (refs0 if lst == 0 else refs1)[mv.ref_idx]
                    mvx, mvy = _clip_mv(px, py, pic_w, pic_h, 4, 4, mv.x, mv.y)
                    return ref_mc.interp_14bit(
                        ref.y, px + (mvx >> 4), py + (mvy >> 4),
                        mvx & 15, mvy & 15, 4, 4, bd, luma=True)

                def profd(lst, mv, dh, dv, bidir):
                    ref = (refs0 if lst == 0 else refs1)[mv.ref_idx]
                    mvx, mvy = _clip_mv(px, py, pic_w, pic_h, 4, 4, mv.x, mv.y)
                    return prof_sb(ref.y, px + (mvx >> 4), py + (mvy >> 4),
                                   mvx & 15, mvy & 15, bd, dh, dv, bidir)

                def uni(lst, mv):
                    ref = (refs0 if lst == 0 else refs1)[mv.ref_idx]
                    mvx, mvy = _clip_mv(px, py, pic_w, pic_h, 4, 4, mv.x, mv.y)
                    return ref_mc.mc_uni(ref.y, px + (mvx >> 4), py + (mvy >> 4),
                                         mvx & 15, mvy & 15, 4, 4, bd, luma=True)

                if inter_dir == 3:
                    v0 = profd(0, mv0, pdh0, pdv0, True) if prof_dir & 1 \
                        else np.asarray(interp14(0, mv0))
                    v1 = profd(1, mv1, pdh1, pdv1, True) if prof_dir & 2 \
                        else np.asarray(interp14(1, mv1))
                    bcw_p1 = mv0.bcw_idx_plus1
                    if bcw_p1 not in (0, 3):
                        w1 = _BCW_W[bcw_p1 - 1]
                        blk = prof_mrg_w(v0, v1, 8 - w1, w1, bd)
                    else:
                        blk = prof_mrg(v0, v1, bd)
                elif inter_dir & 2:
                    blk = profd(1, mv1, pdh1, pdv1, False) if prof_dir & 2 \
                        else np.asarray(uni(1, mv1))
                else:
                    blk = profd(0, mv0, pdh0, pdv0, False) if prof_dir & 1 \
                        else np.asarray(uni(0, mv0))
                blk = np.asarray(blk)
                if trc.lmcs is not None:
                    blk = trc.lmcs.fwd_lut[_clip(blk, bd)].astype(np.int32)
                frame.y[py : py + 4, px : px + 4] = _clip(blk, bd)

        # chroma: 2x2 sub-block MV average (rcn_affine_mcp_b_c :3368)
        if params.sps.sps_chroma_format_idc:
            from dataclasses import replace as _rep

            def avg_mv(sub, i, j):
                a, b = sub[i][j], sub[i + 1][j + 1]
                x = a.x + b.x
                y = a.y + b.y
                x += 1 if x < 0 else 0
                y += 1 if y < 0 else 0
                return _rep(a, x=x >> 1, y=y >> 1)

            for i in range(0, nh, 2):
                for j in range(0, nw, 2):
                    m0 = avg_mv(sub0, i, j) if sub0 is not None else None
                    m1 = avg_mv(sub1, i, j) if sub1 is not None else None
                    _mcp_block(rc, params, trc, refs, cu.x0 + 4 * j,
                               cu.y0 + 4 * i, 3, 3, inter_dir, m0, m1,
                               luma=False)

    _add_luma_residuals(rc, cu, trc, bd)
    rc.mark_luma(cu.x0, cu.y0, cu.log2_w, cu.log2_h)
    if params.sps.sps_chroma_format_idc:
        _add_chroma_residuals(rc, cu, params, trc, bd)


def _reconstruct_inter(rc: ReconCtx, cu: CU, params, trc, refs, find_tu):
    """Inter reconstruction: uni (P or B dir 1/2) or bi MC + residual add.

    Parity: rcn_inter.c rcn_mcp_l/rcn_mcp_c (:430-530, uni) and
    rcn_motion_compensation_b (:540+, bi 14-bit + average), with the hpel
    AMVR filter switch, then the regular transform-tree residual path.
    """
    bd = rc.bitdepth
    frame = rc.frame
    refs0, refs1 = refs[0], refs[1]
    pic_w, pic_h = params.pps.pic_w, params.pps.pic_h
    w, h = 1 << cu.log2_w, 1 << cu.log2_h
    hpel = cu.prec_amvr_eff == MV_PRECISION_HALF
    inter_dir = cu.inter_dir if cu.mv1 is not None else 1

    def mv_for(lst):
        mv = cu.mv0 if lst == 0 else cu.mv1
        ref = (refs0 if lst == 0 else refs1)[mv.ref_idx]
        mvx, mvy = _clip_mv(cu.x0, cu.y0, pic_w, pic_h, w, h, mv.x, mv.y)
        return ref, mvx, mvy

    if cu.gpm_flag:
        _reconstruct_gpm(rc, cu, params, trc, refs, find_tu)
        return

    bcw_p1, bcw_weighted = _bcw_weighted(cu, inter_dir)
    _BCW_W = (-2, 3, 4, 5, 10)

    def bi_comb(p0, p1):
        if bcw_weighted:
            w1 = _BCW_W[bcw_p1 - 1]
            return ref_mc.mc_bi_weighted(p0, p1, bd, 3, 8 - w1, w1)
        return ref_mc.mc_bi(p0, p1, bd)

    tools = getattr(rc, "tools", {})
    bdof_en, dmvr_en = inter_tool_flags(cu, tools, refs)

    if dmvr_en:
        _reconstruct_dmvr(rc, cu, params, trc, refs, hpel, bdof_en)
        _add_luma_residuals(rc, cu, trc, bd)
        _add_chroma_residuals(rc, cu, params, trc, bd)
        rc.mark_luma(cu.x0, cu.y0, cu.log2_w, cu.log2_h)
        return

    pre = getattr(cu, "mc_pre", None)
    if pre is not None and "y" in pre:
        pred_y = pre["y"]
    elif inter_dir == 3:
        r0, x0v, y0v = mv_for(0)
        r1, x1v, y1v = mv_for(1)
        if bdof_en:
            from openvvc_tpu.rcn.ref_bdof import bdof_block

            pred_y = np.zeros((h, w), np.int32)
            clip_fn = lambda px, py, bw, bh, mx, my: _clip_mv(px, py, pic_w, pic_h, bw, bh, mx, my)
            for sy in range(0, h, 16):
                for sx in range(0, w, 16):
                    bw, bh = min(16, w - sx), min(16, h - sy)
                    pred_y[sy : sy + bh, sx : sx + bw] = bdof_block(
                        r0.y, r1.y, cu.x0 + sx, cu.y0 + sy, cu.mv0, cu.mv1,
                        bw, bh, bd, hpel, clip_fn)
        else:
            s0 = _rpr_scale(params, 0, cu.mv0.ref_idx)
            s1 = _rpr_scale(params, 1, cu.mv1.ref_idx)
            if s0 is not None:
                from openvvc_tpu.rcn.ref_rpr import mc_rpr_14bit
                p0 = mc_rpr_14bit(r0.y, cu.x0, cu.y0, w, h, cu.mv0.x,
                                  cu.mv0.y, s0[0], s0[1], bd, luma=True)
            else:
                p0 = ref_mc.interp_14bit(r0.y, cu.x0 + (x0v >> 4), cu.y0 + (y0v >> 4),
                                         x0v & 0xF, y0v & 0xF, w, h, bd, luma=True,
                                         hpel=hpel)
            if s1 is not None:
                from openvvc_tpu.rcn.ref_rpr import mc_rpr_14bit
                p1 = mc_rpr_14bit(r1.y, cu.x0, cu.y0, w, h, cu.mv1.x,
                                  cu.mv1.y, s1[0], s1[1], bd, luma=True)
            else:
                p1 = ref_mc.interp_14bit(r1.y, cu.x0 + (x1v >> 4), cu.y0 + (y1v >> 4),
                                         x1v & 0xF, y1v & 0xF, w, h, bd, luma=True,
                                         hpel=hpel)
            pred_y = bi_comb(p0, p1)
    else:
        lst = 0 if inter_dir & 0x1 else 1
        mv_u = cu.mv0 if lst == 0 else cu.mv1
        s_u = _rpr_scale(params, lst, mv_u.ref_idx)
        ref, mvx, mvy = mv_for(lst)
        if s_u is not None:
            from openvvc_tpu.rcn.ref_rpr import mc_rpr_uni
            pred_y = mc_rpr_uni(ref.y, cu.x0, cu.y0, w, h, mv_u.x, mv_u.y,
                                s_u[0], s_u[1], bd, luma=True)
        else:
            pred_y = ref_mc.mc_uni(ref.y, cu.x0 + (mvx >> 4), cu.y0 + (mvy >> 4),
                                   mvx & 0xF, mvy & 0xF, w, h, bd, luma=True,
                                   hpel=hpel)

    if trc.lmcs is not None:
        pred_y = trc.lmcs.fwd_lut[np.asarray(pred_y)].astype(np.int32)

    if cu.ciip_flag:
        intra_y = predict_intra(frame.y, cu.x0, cu.y0, cu.log2_w, cu.log2_h,
                                0, rc.luma_avail, bd, luma=True)
        pred_y = ref_mc.ciip_blend(np.asarray(intra_y), pred_y, cu.ciip_wt, bd)

    frame.y[cu.y0 : cu.y0 + h, cu.x0 : cu.x0 + w] = _clip(pred_y, bd)
    _add_luma_residuals(rc, cu, trc, bd)
    rc.mark_luma(cu.x0, cu.y0, cu.log2_w, cu.log2_h)

    if not params.sps.sps_chroma_format_idc:
        return
    cx0, cy0 = cu.x0 >> 1, cu.y0 >> 1
    cw, ch = w >> 1, h >> 1
    if pre is not None and "cb" in pre:
        pred_cb, pred_cr = pre["cb"], pre["cr"]
    elif inter_dir == 3:
        flag44 = cu.log2_w == 2 and cu.log2_h == 2
        cbs, crs = [], []
        for lst in (0, 1):
            mv_u = cu.mv0 if lst == 0 else cu.mv1
            ref, mvx, mvy = mv_for(lst)
            s_u = _rpr_scale(params, lst, mv_u.ref_idx)
            if s_u is not None:
                from openvvc_tpu.rcn.ref_rpr import chroma_add_xy, mc_rpr_14bit
                ccol = getattr(ref, "rpr_info", (None, (0, 0)))[1]
                ax, ay = chroma_add_xy(s_u[0], s_u[1], ccol[0], ccol[1])
                cbs.append(mc_rpr_14bit(ref.cb, cx0, cy0, cw, ch, mv_u.x,
                                        mv_u.y, s_u[0], s_u[1], bd,
                                        luma=False, flag_4x4=flag44,
                                        add_x=ax, add_y=ay))
                crs.append(mc_rpr_14bit(ref.cr, cx0, cy0, cw, ch, mv_u.x,
                                        mv_u.y, s_u[0], s_u[1], bd,
                                        luma=False, flag_4x4=flag44,
                                        add_x=ax, add_y=ay))
                continue
            cbs.append(ref_mc.interp_14bit(ref.cb, cx0 + (mvx >> 5), cy0 + (mvy >> 5),
                                           mvx & 0x1F, mvy & 0x1F, cw, ch, bd, luma=False))
            crs.append(ref_mc.interp_14bit(ref.cr, cx0 + (mvx >> 5), cy0 + (mvy >> 5),
                                           mvx & 0x1F, mvy & 0x1F, cw, ch, bd, luma=False))
        pred_cb = bi_comb(cbs[0], cbs[1])
        pred_cr = bi_comb(crs[0], crs[1])
    elif _rpr_scale(params, 0 if inter_dir & 0x1 else 1,
                    (cu.mv0 if inter_dir & 0x1 else cu.mv1).ref_idx) is not None:
        from openvvc_tpu.rcn.ref_rpr import chroma_add_xy, mc_rpr_uni
        lst = 0 if inter_dir & 0x1 else 1
        mv_u = cu.mv0 if lst == 0 else cu.mv1
        s_u = _rpr_scale(params, lst, mv_u.ref_idx)
        ref = (refs0 if lst == 0 else refs1)[mv_u.ref_idx]
        ccol = getattr(ref, "rpr_info", (None, (0, 0)))[1]
        ax, ay = chroma_add_xy(s_u[0], s_u[1], ccol[0], ccol[1])
        flag44 = cu.log2_w == 2 and cu.log2_h == 2
        pred_cb = mc_rpr_uni(ref.cb, cx0, cy0, cw, ch, mv_u.x, mv_u.y,
                             s_u[0], s_u[1], bd, luma=False,
                             flag_4x4=flag44, add_x=ax, add_y=ay)
        pred_cr = mc_rpr_uni(ref.cr, cx0, cy0, cw, ch, mv_u.x, mv_u.y,
                             s_u[0], s_u[1], bd, luma=False,
                             flag_4x4=flag44, add_x=ax, add_y=ay)
    else:
        pred_cb = ref_mc.mc_uni(ref.cb, cx0 + (mvx >> 5), cy0 + (mvy >> 5),
                                mvx & 0x1F, mvy & 0x1F, cw, ch, bd, luma=False)
        pred_cr = ref_mc.mc_uni(ref.cr, cx0 + (mvx >> 5), cy0 + (mvy >> 5),
                                mvx & 0x1F, mvy & 0x1F, cw, ch, bd, luma=False)

    if cu.ciip_flag and cu.log2_w > 2:
        icb = predict_intra(frame.cb, cx0, cy0, cu.log2_w - 1, cu.log2_h - 1,
                            0, rc.chroma_avail, bd, luma=False)
        icr = predict_intra(frame.cr, cx0, cy0, cu.log2_w - 1, cu.log2_h - 1,
                            0, rc.chroma_avail, bd, luma=False)
        pred_cb = ref_mc.ciip_blend(np.asarray(icb), pred_cb, cu.ciip_wt, bd)
        pred_cr = ref_mc.ciip_blend(np.asarray(icr), pred_cr, cu.ciip_wt, bd)

    frame.cb[cy0 : cy0 + ch, cx0 : cx0 + cw] = _clip(pred_cb, bd)
    frame.cr[cy0 : cy0 + ch, cx0 : cx0 + cw] = _clip(pred_cr, bd)
    _add_chroma_residuals(rc, cu, params, trc, bd)


def _reconstruct_isp_luma(rc: ReconCtx, cu: CU, trc, find_tu):
    """Sequential ISP sub-partition reconstruction (recon_isp_subtree_v/h)."""
    bd = rc.bitdepth
    frame = rc.frame
    vertical = cu.isp_mode == 2
    l2pw, l2ph, nb_pb = isp_part_dims(cu.log2_w, cu.log2_h, cu.isp_mode)
    tr_h, tr_v = isp_transform_types(cu.log2_w, cu.log2_h, l2pw, l2ph,
                                     vertical, trc.mts_enabled)
    lmode = lfnst_intra_mode(cu.log2_w, cu.log2_h, cu.intra_mode_l) if cu.lfnst_idx else None

    # vertical split: prediction in >=4-wide chunks (recon_isp_subtree_v);
    # horizontal split: prediction per partition at its real height
    pred_l2w = max(2, l2pw) if vertical else cu.log2_w
    pred_l2h = cu.log2_h if vertical else l2ph

    # the reference marks the full CU rect in the progress field before
    # reconstruction (vcl_coding_unit.c :953); ISP chunk fills rely on it
    rc.mark_luma(cu.x0, cu.y0, cu.log2_w, cu.log2_h)

    for i in range(nb_pb):
        sx = cu.x0 + ((i << l2pw) if vertical else 0)
        sy = cu.y0 + (0 if vertical else (i << l2ph))
        off = (sx - cu.x0) if vertical else (sy - cu.y0)
        if not vertical or off % 4 == 0:
            pred = predict_isp_chunk(frame.y, cu.x0, cu.y0, cu.log2_w, cu.log2_h,
                                     sx, sy, pred_l2w, pred_l2h,
                                     cu.intra_mode_l, rc.luma_avail, bd)
            frame.y[sy : sy + (1 << pred_l2h), sx : sx + (1 << pred_l2w)] = _clip(pred, bd)
        tu = find_tu(0, sx, sy)
        if tu is not None:
            res = reconstruct_isp_tb(tu, trc.dep_quant, bd, tr_h, tr_v, lmode)
            h, w = 1 << l2ph, 1 << l2pw
            region = frame.y[sy : sy + h, sx : sx + w].astype(np.int64)
            frame.y[sy : sy + h, sx : sx + w] = _clip(region + res, bd)


def _reconstruct_chroma(rc: ReconCtx, cu: CU, params, trc, cx0, cy0, clog2_w, clog2_h):
    bd = rc.bitdepth
    frame = rc.frame
    part = params.part_info["intra_chroma" if cu.tree_type == TREE_DUAL_CHROMA else "intra_luma"]
    max_tb_c = part.log2_max_tb_s if cu.tree_type == TREE_DUAL_CHROMA else part.log2_max_tb_s - 1
    mode = cu.intra_mode_c
    csign = -1 if params.ph.ph_joint_cbcr_sign_flag else 1

    def find_tu(comp, x, y):
        for tu in cu.tus:
            if tu.comp == comp and tu.x0 == x and tu.y0 == y:
                return tu
        return None

    for ux, uy, l2w, l2h in _tu_units(cx0, cy0, clog2_w, clog2_h, max_tb_c):
        def lmode_for(tu):
            if not tu.lfnst_idx:
                return None
            m = mode
            if m in (81, 82, 83):
                # CCLM: center collocated luma mode (drv_lfnst.c derive_lfnst_mode_c)
                m = getattr(cu, "col_luma_mode", 0)
            return lfnst_intra_mode(min(5, tu.log2_w), min(5, tu.log2_h), m)

        jtu = find_tu(3, ux, uy)
        res_cb = res_cr = None
        if jtu is not None:
            res = reconstruct_tu_residual(jtu, trc, bd, lfnst_mode=lmode_for(jtu))
            if jtu.joint_cbcr == 3:
                res_cb = res
                res_cr = csign * res
            elif jtu.joint_cbcr == 2:
                res_cb = res
                res_cr = (csign * res) >> 1
            else:
                res_cr = res
                res_cb = (csign * res) >> 1
        else:
            tb = find_tu(1, ux, uy)
            tr = find_tu(2, ux, uy)
            if tb is not None:
                res_cb = reconstruct_tu_residual(tb, trc, bd, lfnst_mode=lmode_for(tb))
            if tr is not None:
                res_cr = reconstruct_tu_residual(tr, trc, bd, lfnst_mode=lmode_for(tr))

        if cu.bdpcm_c:
            preds = tuple(
                (plane, predict_bdpcm(plane, ux, uy, l2w, l2h, cu.bdpcm_dir_c,
                                      rc.chroma_avail, bd, 2), res)
                for plane, res in ((frame.cb, res_cb), (frame.cr, res_cr)))
        elif mode in (81, 82, 83):
            collocated = bool(params.sps.sps_chroma_vertical_collocated_flag)
            pred_cb, pred_cr = predict_cclm(
                frame.y, frame.cb, frame.cr, ux, uy, l2w, l2h, mode,
                rc.chroma_avail, params.sps.ctb_log2, collocated, bd)
            preds = ((frame.cb, pred_cb, res_cb), (frame.cr, pred_cr, res_cr))
        else:
            preds = tuple(
                (plane, predict_intra(plane, ux, uy, l2w, l2h, mode, rc.chroma_avail, bd, luma=False), res)
                for plane, res in ((frame.cb, res_cb), (frame.cr, res_cr)))
        for plane, pred, res in preds:
            if res is not None:
                if trc.scale_c and l2w + l2h > 2:
                    if trc.lmcs is not None:
                        res = scale_residual(res, trc.lmcs.chroma_scale, bd)
                pred = pred + res
            plane[uy : uy + (1 << l2h), ux : ux + (1 << l2w)] = _clip(pred, bd)
        rc.mark_chroma(ux, uy, l2w, l2h)


def _sd(params, lst):
    from openvvc_tpu.vcl.ctu import _signed_rpl_deltas
    hr0, hr1 = params.sh.resolved_rpls(params.pps, params.ph)
    nra = getattr(params.sh, "_num_ref_idx_active", [1, 0])
    cur_poc = getattr(params, "_cur_poc", params.ph.ph_pic_order_cnt_lsb)
    return _signed_rpl_deltas(hr0.rpl if lst == 0 else hr1.rpl, nra[lst], cur_poc)


def _merge_tmvp_export(acc, ectx, pps):
    """Assemble picture-level TMVP field from per-tile InterCtx state."""
    uw, uh = (pps.pic_w + 3) >> 2, (pps.pic_h + 3) >> 2
    if acc is None:
        acc = (np.zeros((uh, uw), np.uint8), np.zeros((uh, uw), np.uint8),
               {}, {}, None, None)
    ictx = ectx.inter_ctx
    ox, oy = ectx.tile_x0 >> 2, ectx.tile_y0 >> 2
    jh, iw = min(ictx.uh, uh - oy), min(ictx.uw, uw - ox)
    acc[0][oy:oy + jh, ox:ox + iw] = np.asarray(ictx.dir0)[:jh, :iw]
    acc[1][oy:oy + jh, ox:ox + iw] = np.asarray(ictx.dir1)[:jh, :iw]
    for (x, y), mv in ictx.tmvp_mv0.items():
        acc[2][(x + (ox >> 1), y + (oy >> 1))] = mv
    for (x, y), mv in ictx.tmvp_mv1.items():
        acc[3][(x + (ox >> 1), y + (oy >> 1))] = mv
    return acc


class _LazyTmvp:
    """Deferred picture-level TMVP field.

    Building the dict/plane form costs ~100 ms/frame at 1080p and is only
    consumed when a LATER picture enables TMVP and selects this frame as
    collocated ref, so it materializes on first use — the analog of the
    reference allocating MV planes on demand (dpb.c tmvp_request_mv_plane
    :931)."""

    __slots__ = ("_ectxs", "_pps", "_sd0", "_sd1", "_dmvr", "_val",
                 "_dense")

    def __init__(self, ectxs, pps, sd0, sd1, dmvr_overrides):
        self._ectxs, self._pps = ectxs, pps
        self._sd0, self._sd1, self._dmvr = sd0, sd1, dmvr_overrides
        self._val = None
        self._dense = None

    def resolve_dense(self):
        """(dir0, dir1, mv0, mv1) with dense (uh8, uw8, 3) int32 MV grids
        — the C parser's collocated-field form. Built straight from the
        per-entry raw tile arrays (no dict round-trip) when the source
        entries were natively parsed."""
        if self._dense is None:
            pps = self._pps
            uw, uh = (pps.pic_w + 3) >> 2, (pps.pic_h + 3) >> 2
            uw8, uh8 = (uw + 1) >> 1, (uh + 1) >> 1
            dir0 = np.zeros((uh, uw), np.uint8)
            dir1 = np.zeros((uh, uw), np.uint8)
            a0 = np.zeros((uh8, uw8, 3), np.int32)
            a1 = np.zeros_like(a0)
            for ectx in self._ectxs:
                ictx = ectx.inter_ctx
                ox, oy = ectx.tile_x0 >> 2, ectx.tile_y0 >> 2
                jh, iw = min(ictx.uh, uh - oy), min(ictx.uw, uw - ox)
                dir0[oy:oy + jh, ox:ox + iw] = np.asarray(ictx.dir0)[:jh, :iw]
                dir1[oy:oy + jh, ox:ox + iw] = np.asarray(ictx.dir1)[:jh, :iw]
                ox8, oy8 = ox >> 1, oy >> 1
                raw0 = getattr(ictx, "_mv0_raw", None)
                if raw0 is not None:  # native tile: dense already
                    raw1 = ictx._mv1_raw
                    j8 = min(raw0.shape[0], uh8 - oy8)
                    i8 = min(raw0.shape[1], uw8 - ox8)
                    a0[oy8:oy8 + j8, ox8:ox8 + i8] = raw0[:j8, :i8]
                    if raw1 is not None:
                        a1[oy8:oy8 + j8, ox8:ox8 + i8] = raw1[:j8, :i8]
                else:  # Python-parsed tile: dict form
                    for (x, y), mv in ictx.tmvp_mv0.items():
                        if 0 <= oy8 + y < uh8 and 0 <= ox8 + x < uw8:
                            a0[oy8 + y, ox8 + x] = (mv.x, mv.y, mv.ref_idx)
                    for (x, y), mv in ictx.tmvp_mv1.items():
                        if 0 <= oy8 + y < uh8 and 0 <= ox8 + x < uw8:
                            a1[oy8 + y, ox8 + x] = (mv.x, mv.y, mv.ref_idx)
            # DMVR-refined MV overrides (prediction_unit_inter_b :2610)
            for (gx, gy, m0, m1) in self._dmvr:
                if 0 <= gy < uh8 and 0 <= gx < uw8:
                    a0[gy, gx] = (m0.x, m0.y, m0.ref_idx)
                    a1[gy, gx] = (m1.x, m1.y, m1.ref_idx)
            self._dense = (dir0, dir1, a0, a1)
        return self._dense

    @property
    def sd(self):
        return self._sd0, self._sd1

    def resolve(self):
        if self._val is None:
            acc = None
            for ectx in self._ectxs:
                acc = _merge_tmvp_export(acc, ectx, self._pps)
            # DMVR-refined MVs override the TMVP field at select 8x8 cells
            # (prediction_unit_inter_b :2610 "temporary hack")
            for (gx, gy, m0, m1) in self._dmvr:
                acc[2][(gx, gy)] = m0
                acc[3][(gx, gy)] = m1
            self._val = acc[:4] + (self._sd0, self._sd1)
        return self._val


class _PicCtx:
    """Per-picture decode state across the parse→reconstruct pipeline."""

    __slots__ = ("params", "frame", "poc", "refs0", "refs1", "dist0",
                 "dist1", "tools", "lmcs", "dbf", "csign", "native_recon",
                 "native_parse", "dmvr_overrides", "futures", "results",
                 "ectxs", "recon_futures", "native_items", "tpu_state")

    def __init__(self):
        self.futures = None
        self.results = None
        self.ectxs = None
        self.recon_futures = None
        self.native_items = None
        self.tpu_state = None


class Decoder:
    """Frame decoder over the currently supported toolset.

    use_tpu_residuals: batch all eligible TU residual reconstructions
    through the JAX/XLA path (one launch per TB class) before the
    sequential prediction loop — the host/device split of the design.
    """

    def __init__(self, use_tpu_residuals: bool = False, use_tpu: bool = False,
                 nb_entry_threads: int = 0, use_native_recon: bool = True,
                 upscale: bool = False, nb_frame_threads: int = 4):
        self.nvcl = NvclContext()
        # Frame pipeline depth (the reference's -t frame threads,
        # ovdec.c:189-248).  The device path pipelines pictures by
        # construction: every frame program is dispatched asynchronously
        # and CHAINS on the donated device DPB stacks, so cross-frame
        # reference dependencies are enforced by XLA data flow — the
        # tensor-native equivalent of the reference's decoded-CTU-line
        # watermark bitmask (dpb.c:1222-1361; our whole-frame fused
        # filters make the frame the natural sync granule).  This knob
        # bounds how many dispatched-but-unfetched pictures may be in
        # flight (host output backlog / device working set), like the
        # reference's sub-decoder count bounds its frame lookahead.
        self.nb_frame_threads = max(1, nb_frame_threads)
        self._inflight = []  # frames dispatched, fetch not yet awaited
        self._tpu_batch = []  # dispatched frames awaiting the batched D2H
        # RPR output upscale to the SPS max size (dectest -u /
        # OVDEC_RPR_UPSCALE, ovdec.c:557-562)
        self.upscale = upscale
        # use_tpu: the device-resident frame pipeline (tpu/frame_program.py)
        # — host C parse + IR build, ONE fused jitted program per picture
        # (MC + intra waves + DBF + SAO) with the DPB in device memory.
        # Falls back to the host path per picture outside the device
        # toolset.
        self.tpu_frames = use_tpu
        self.use_tpu_residuals = use_tpu_residuals
        self._ddpb = None
        self.stats: dict = {}
        # full C entry path: parse + reconstruction both native, Python
        # only sees the SAO/TMVP side tables (falls back per entry when a
        # tool outside the C toolset appears)
        self.use_native_recon = use_native_recon and not bool(
            int(os.environ.get("OPENVVC_NO_NATIVE_RECON", "0")))
        if self.use_tpu_residuals or self.tpu_frames:
            # per-shape XLA compiles dominate a cold run; persist them so
            # repeat invocations hit the cache instead of recompiling
            import jax

            jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
            jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        self.dpb = DPB()
        self.last_pps = None
        # entry-level parallel runtime (the reference's -e threads,
        # ovthreads.c entry jobs). Parse/recon are thread-safe per entry
        # (tests/test_entry_threads.py); the C entry path releases the GIL,
        # so 0 derives #cores like the reference's `-e 0`
        # (get_number_of_cores, ovutils.c:47).
        if nb_entry_threads <= 0:
            nb_entry_threads = os.cpu_count() or 1
        self.nb_entry_threads = nb_entry_threads
        # streaming state (submit_nal / receive_frame / drain)
        self._pending = None
        self._out_ready: list[Frame] = []
        self.last_sps = None

    def decode(self, stream: bytes) -> list[Frame]:
        """Decode all pictures. Frame-pipelined (the reference's frame
        threads, ovdec.c:189-248): while picture N runs reconstruction and
        in-loop filters, picture N+1's entries parse on the thread pool —
        parse needs only the collocated TMVP field (a parse product),
        never reference pixels, so one picture of lookahead is safe.
        Gated off for tools whose TMVP export depends on reconstruction
        (DMVR refined-MV overrides, prediction_unit_inter_b :2610)."""
        frames = []
        for nal in demux_annexb(stream):
            self.submit_nal(nal, frames.append)
        self.flush_pending(frames.append)
        if self.tpu_frames:
            # materialize device outputs: decode() returns host-complete
            # frames (and timing of this call covers all device work)
            with trace.span("final_sync"):
                for f in frames:
                    f.sync_host()
        return frames

    def submit_nal(self, nal, emit=None) -> None:
        """Feed one NAL unit (the reference's ovdec_submit_picture_unit /
        decode_nal_unit path, ovdec.c:358-455).  Completed pictures go to
        `emit` (default: the streaming output queue read by
        receive_frame)."""
        if emit is None:
            emit = self._emit_output
        if is_vcl(nal.type):
            pending = self._pending
            if pending is not None:
                # previous picture: parse done (its TMVP export must exist
                # before the next picture's parse), then queue its
                # reconstruction AHEAD of the next parse jobs so the pool
                # drains in dependency order
                self._join_parse(pending)
                if not self.tpu_frames:
                    self._start_recon(pending)
            ctx = self._start_picture(nal)
            pipe = self._can_pipeline(ctx)
            self._submit_parse(ctx, async_=pipe or pending is not None)
            if pending is not None and self.tpu_frames:
                # device lane: N+1's parse rides the entry pool while N's
                # IR build (separate pool) + host bundle packing run — the
                # ~100 ms/frame of numpy table building was the single-
                # threaded gap in the frame pipeline
                self._start_recon(pending)
            self.flush_pending(emit)  # filters of N while N+1 parses
            if pipe:
                self._pending = ctx
            else:
                self._join_parse(ctx)
                emit(self._post_process(self._finish_picture(ctx)))
        else:
            # NVCL readers REPLACE parameter-set objects (never mutate,
            # params.py decode_nalu), so a pending picture's captured
            # params stay valid; finish-time SEI state is snapshotted
            # at _start_picture. No pipeline flush needed.
            self.nvcl.decode_nalu(nal)

    def flush_pending(self, emit=None) -> None:
        if emit is None:
            emit = self._emit_output
        pending = self._pending
        if pending is not None:
            self._pending = None
            self._join_parse(pending)
            emit(self._post_process(self._finish_picture(pending)))

    # -- incremental output (ovdec_receive_picture / ovdpb_output_pic,
    #    dpb.c:691-824) ---------------------------------------------------

    def _emit_output(self, frame: Frame) -> None:
        self._out_ready.append(frame)

    def _max_reorder(self) -> int:
        """max_nb_reorder_pic from the active SPS dpb_parameters (highest
        sublayer), dpb.c:745."""
        sps = self.last_sps
        if sps is None:
            lst = getattr(self.nvcl, "sps_list", {})
            sps = next(iter(lst.values()), None)
        dpb = getattr(sps, "dpb", None) if sps is not None else None
        vals = getattr(dpb, "dpb_max_num_reorder_pics", None) \
            if dpb is not None else None
        if isinstance(vals, (list, tuple, dict)) and len(vals):
            if isinstance(vals, dict):
                return int(vals[max(vals)])
            return int(vals[-1])
        if isinstance(vals, int):
            return vals
        return 7  # conservative default when dpb params are absent

    def receive_frame(self) -> Frame | None:
        """One display-ready picture, or None while the reorder rules hold
        pictures back.

        ovdpb_output_pic parity (dpb.c:691-767): the min-POC candidate of
        the oldest CVS is withheld while (a) no more than max_nb_reorder
        pictures wait, or (b) a smaller-POC picture of the same CVS is
        still in the decode pipeline (the reference's
        OV_IN_DECODING_PIC_FLAG check at :732-739 — there the race with
        the frame threads, here the pipelined pending picture)."""
        if len(self._out_ready) <= self._max_reorder():
            return None
        f = min(self._out_ready, key=lambda f: (getattr(f, "cvs_id", 0),
                                                f.poc))
        p = self._pending
        if p is not None and getattr(p, "poc", None) is not None \
                and p.poc <= f.poc:
            return None  # a smaller-POC picture is still decoding
        self._out_ready.remove(f)
        f.sync_host()
        return f

    def drain(self):
        """Finish the pipeline and yield every remaining picture in display
        order (ovdec_drain_picture + ovdpb_drain_frame, dpb.c:620)."""
        self.flush_pending()
        while self._out_ready:
            f = min(self._out_ready, key=lambda f: (getattr(f, "cvs_id", 0),
                                                    f.poc))
            self._out_ready.remove(f)
            f.sync_host()
            yield f

    def decode_stream(self, io_obj, chunk=None):
        """Constant-memory streaming decode: read Annex-B chunks from an
        OVIO source, yield pictures in display order as soon as the
        reorder rule allows, dropping them from decoder memory."""
        from openvvc_tpu.io import CHUNK, demux_nals

        for nal in demux_nals(io_obj, chunk or CHUNK):
            self.submit_nal(nal)
            while True:
                f = self.receive_frame()
                if f is None:
                    break
                yield f
        yield from self.drain()

    def _can_pipeline(self, ctx) -> bool:
        return (ctx.native_recon and not ctx.tools["dmvr"]
                and getattr(self, "_pre_dbf_hook", None) is None)

    def _post_process(self, frame: Frame) -> Frame:
        """Output-side post-processing (reference post_proc.c:75-137): film
        grain is synthesized onto a writable output copy (the DPB keeps the
        un-grained picture for inter prediction), then the optional RPR
        upscale resamples the output to the SPS max size
        (pp_sample_rate_conv, pp_pic_scale.c:250). The film-grain SEI is
        the one active when the picture STARTED (captured per access unit
        in _start_picture) — a later SEI must not retro-apply under the
        frame pipeline."""
        fg = getattr(frame, "_fg_sei", None)
        if fg is not None or self.upscale:
            frame.ensure_int32()
        out = frame
        if fg is not None:
            from openvvc_tpu.rcn.ref_fg import apply_film_grain

            y, cb, cr = apply_film_grain((frame.y, frame.cb, frame.cr), fg,
                                         frame.poc)
            out = Frame(frame.poc, y, cb, cr, frame.bitdepth)
            out.cvs_id = getattr(frame, "cvs_id", 0)
            out.output_window = getattr(frame, "output_window", None)
        if self.upscale:
            from openvvc_tpu.rcn.ref_rpr import pp_upscale_plane

            max_w, max_h = getattr(frame, "max_dims",
                                   (frame.y.shape[1], frame.y.shape[0]))
            win, ccol = getattr(frame, "rpr_info", ((0, 0, 0, 0), (0, 0)))
            y = pp_upscale_plane(out.y, max_w, max_h, win, ccol, luma=True)
            cb = cr = None
            if out.cb is not None:
                cb = pp_upscale_plane(out.cb, max_w >> 1, max_h >> 1, win,
                                      ccol, luma=False)
                cr = pp_upscale_plane(out.cr, max_w >> 1, max_h >> 1, win,
                                      ccol, luma=False)
            up = Frame(out.poc, y, cb, cr, out.bitdepth)
            up.cvs_id = getattr(frame, "cvs_id", 0)
            up.output_window = getattr(frame, "output_window", None)
            out = up
        return out

    @staticmethod
    def output_order(frames: list[Frame]) -> list[Frame]:
        """Frames in display order (the reference's DPB output order,
        dpb.c:691-824): CVSs in decode order, ascending POC within each."""
        return sorted(frames, key=lambda f: (getattr(f, "cvs_id", 0), f.poc))

    def _decode_picture(self, nal) -> Frame:
        ctx = self._start_picture(nal)
        self._submit_parse(ctx, async_=False)
        self._join_parse(ctx)
        return self._finish_picture(ctx)

    def _get_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        if getattr(self, "_pool", None) is None:
            self._pool = ThreadPoolExecutor(max(2, self.nb_entry_threads))
        return self._pool

    def _get_fetch_pool(self):
        from concurrent.futures import ThreadPoolExecutor

        if getattr(self, "_fetch_pool", None) is None:
            self._fetch_pool = ThreadPoolExecutor(1)
        return self._fetch_pool

    def _get_ir_pool(self):
        """Separate pool for the per-entry IR builds: keeps them off the
        entry-parse pool so picture N's IR does not queue behind picture
        N+1's parse jobs (submit_nal submits the parse first)."""
        from concurrent.futures import ThreadPoolExecutor

        if getattr(self, "_ir_pool", None) is None:
            self._ir_pool = ThreadPoolExecutor(max(2, self.nb_entry_threads))
        return self._ir_pool

    def _start_picture(self, nal) -> "_PicCtx":
        with trace.span("start_picture"):
            return self._start_picture_inner(nal)

    def _start_picture_inner(self, nal) -> "_PicCtx":
        params = self.nvcl.parse_slice(nal)
        sps, pps = params.sps, params.pps
        self.last_pps = pps
        self.last_sps = sps
        bd = sps.bitdepth
        chroma = sps.sps_chroma_format_idc != 0
        # plane pool: faulting fresh pages costs ~10x a warm re-zero here;
        # planes return to the pool when the Frame is collected (the
        # reference's picture pool, ovdpb.c). Contents stay UNINITIALIZED —
        # reconstruction writes prediction into every sample of every CU,
        # and entries tile the picture (the reference's pool frames are
        # likewise not zeroed, ovframepool.c:194)
        from openvvc_tpu.utils.pool import GLOBAL as _pool
        y = _pool.take((pps.pic_h, pps.pic_w), np.int32)
        cb = (_pool.take((pps.pic_h // 2, pps.pic_w // 2), np.int32)
              if chroma else None)
        cr = (_pool.take((pps.pic_h // 2, pps.pic_w // 2), np.int32)
              if chroma else None)
        poc = self.dpb.picture_poc(params, int(nal.type))
        params._cur_poc = poc
        frame = Frame(poc, y, cb, cr, bd)
        _pool.adopt(frame, (y, cb, cr))
        # snapshot the access unit's film-grain SEI for output-side post
        # processing (a later AU's SEI must not retro-apply, post_proc.c:75)
        frame._fg_sei = getattr(self.nvcl, "sei_film_grain", None)

        refs0 = refs1 = None
        dist0 = dist1 = None
        cur_win = (int(getattr(pps, "pps_scaling_win_left_offset", 0) or 0),
                   int(getattr(pps, "pps_scaling_win_right_offset", 0) or 0),
                   int(getattr(pps, "pps_scaling_win_top_offset", 0) or 0),
                   int(getattr(pps, "pps_scaling_win_bottom_offset", 0) or 0))
        chroma_col = (int(getattr(sps, "sps_chroma_horizontal_collocated_flag", 0) or 0),
                      int(getattr(sps, "sps_chroma_vertical_collocated_flag", 0) or 0))
        frame.rpr_info = (cur_win, chroma_col)
        # per-frame output (conformance) window: PPS window when flagged,
        # else the SPS window (dpb.c:1151-1161)
        if getattr(pps, "pps_conformance_window_flag", 0):
            frame.output_window = tuple(
                int(getattr(pps, f"pps_conf_win_{k}_offset", 0) or 0)
                for k in ("left", "right", "top", "bottom"))
        else:
            frame.output_window = tuple(
                int(getattr(sps, f"sps_conf_win_{k}_offset", 0) or 0)
                for k in ("left", "right", "top", "bottom"))
        frame.max_dims = (
            int(getattr(sps, "sps_pic_width_max_in_luma_samples", pps.pic_w)),
            int(getattr(sps, "sps_pic_height_max_in_luma_samples", pps.pic_h)))
        if params.slice_type != SLICE_I:
            hrpl0, hrpl1 = params.sh.resolved_rpls(pps, params.ph)
            nra = getattr(params.sh, "_num_ref_idx_active", [1, 0])
            refs0, dist0 = self.dpb.resolve_rpl(hrpl0, sps, poc, nra[0])
            dist1 = []
            if params.slice_type == 0:  # B
                refs1, dist1 = self.dpb.resolve_rpl(hrpl1, sps, poc, nra[1])
            # RPR: per-ref scale factors (ctudec_compute_refs_scaling,
            # ctudec.c:43-88); unit scale keeps the normal MC path
            params._rpr_scales = None
            if getattr(sps, "sps_ref_pic_resampling_enabled_flag", 0):
                from openvvc_tpu.rcn.ref_rpr import rpr_scale_factors

                def _scales(rl):
                    out = []
                    for f in (rl or []):
                        rw_, rh_ = f.y.shape[1], f.y.shape[0]
                        rwin = getattr(f, "rpr_info", ((0, 0, 0, 0), (0, 0)))[0]
                        out.append(rpr_scale_factors(
                            pps.pic_w, pps.pic_h, cur_win, rw_, rh_, rwin))
                    return out
                params._rpr_scales = (_scales(refs0), _scales(refs1))
            if getattr(params.ph, "ph_temporal_mvp_enabled_flag", 0):
                # collocated ref selection (dpb.c init_tmvp_info :1016)
                from_l0 = bool(getattr(params.sh, "sh_collocated_from_l0_flag", 1)) \
                    or params.slice_type == 1
                cidx = int(getattr(params.sh, "sh_collocated_ref_idx", 0))
                col_f = (refs0 if from_l0 else refs1)[cidx]
                col = getattr(col_f, "tmvp", None)
                if col is not None:
                    if hasattr(col, "resolve"):
                        # dict form resolves lazily in CTUParseCtx (Python
                        # parse fallback); the C parse uses resolve_dense
                        params._tmvp_col_obj = col
                    else:
                        params._tmvp_col = col

        tools = {
            "bdof": bool(getattr(sps, "sps_bdof_enabled_flag", 0))
            and not getattr(params.ph, "ph_bdof_disabled_flag", 0),
            "dmvr": bool(getattr(sps, "sps_dmvr_enabled_flag", 0))
            and not getattr(params.ph, "ph_dmvr_disabled_flag", 0),
            "dep_quant": bool(params.sh.sh_dep_quant_used_flag),
            "mts_implicit": bool(sps.sps_mts_enabled_flag) and not sps.sps_explicit_mts_intra_enabled_flag,
            "mts_enabled": bool(sps.sps_mts_enabled_flag),
            "scale_c": bool(params.ph.ph_chroma_residual_scale_flag),
        }
        # gating per the reference: luma reshape + chroma-scale state follow
        # ph_lmcs_enabled_flag (slicedec.c :1462, ctudec.c :159)
        lmcs = None
        if params.ph.ph_lmcs_enabled_flag and getattr(params, "lmcs_data", None) is not None:
            lmcs = build_lmcs(params.lmcs_data, bd)
        tools["lmcs"] = lmcs

        dbf_disabled = self._dbf_disabled(params)
        dbf = None if dbf_disabled else DbfMaps(pps.pic_w, pps.pic_h, chroma)

        # Full-native fast path: parse AND reconstruct the entry in C,
        # writing the frame planes + DBF maps directly (no Python CU/TU
        # objects). Falls back per entry when the C recon's support scan
        # hits a tool outside its set (returns with outputs untouched).
        native_recon = (self.use_native_recon and lmcs is None
                        and not self.use_tpu_residuals)
        # the device path needs the raw native parse even when the host C
        # recon can't take the stream (e.g. LMCS, reconstructed on device)
        native_parse = native_recon or (self.tpu_frames
                                        and self.use_native_recon)
        csign = -1 if params.ph.ph_joint_cbcr_sign_flag else 1

        ctx = _PicCtx()
        ctx.params, ctx.frame, ctx.poc = params, frame, poc
        ctx.refs0, ctx.refs1 = refs0, refs1
        ctx.dist0, ctx.dist1 = dist0, dist1
        ctx.tools, ctx.lmcs, ctx.dbf, ctx.csign = tools, lmcs, dbf, csign
        ctx.native_recon = native_recon
        ctx.native_parse = native_parse
        ctx.dmvr_overrides = []
        # register in the DPB now: later pictures resolve their RPLs (and
        # read the parse-level TMVP export) before this one reconstructs
        self.dpb.store(poc, frame)
        return ctx

    def _parse_entry_job(self, ctx, entry):
        """Parse one entry (no pixel access — safe ahead of refs).
        Returns (entry, raw, ectx): raw for natively-parsed entries,
        ectx for Python-parsed ones."""
        with trace.span("parse_entry"):
            if ctx.native_parse:
                from openvvc_tpu.native import parse_entry_native_raw

                raw = parse_entry_native_raw(ctx.params, entry)
                if raw is not None:
                    return entry, raw, None
            ectx, trees, dec = parse_entry(ctx.params, entry)
            if dec.overread():
                raise ValueError("CABAC overread in entry")
            return entry, None, ectx

    def _submit_parse(self, ctx, async_: bool) -> None:
        # entry-level parallelism (the reference's -e entry threads,
        # ovthreads.c entry jobs): tiles parse independently
        entries = ctx.params.entries
        nb_workers = min(len(entries), self.nb_entry_threads)
        if async_ or nb_workers > 1:
            pool = self._get_pool()
            ctx.futures = [pool.submit(self._parse_entry_job, ctx, e)
                           for e in entries]
        else:
            ctx.results = [self._parse_entry_job(ctx, e) for e in entries]

    def _join_parse(self, ctx) -> None:
        if ctx.results is None:
            with trace.span("parse_wait"):
                ctx.results = [f.result() for f in ctx.futures]
        if ctx.ectxs is not None:
            return
        from openvvc_tpu.native import native_entry_ctx_from_raw

        ectxs = []
        for entry, raw, ectx in ctx.results:
            if raw is not None:
                ectx = native_entry_ctx_from_raw(raw)
            ectxs.append((entry, ectx))
        ctx.ectxs = ectxs
        # picture-level TMVP export is a pure parse product — publish it
        # now so the next picture's parse can collocate against this frame
        # (dmvr_overrides is shared and still empty; DMVR streams are not
        # pipelined, so recon-time refinements land before any reader)
        params = ctx.params
        tmvp_ectxs = [e for (_, e) in ectxs if e.inter_ctx is not None]
        ctx.frame.tmvp = None
        if tmvp_ectxs:
            ctx.frame.tmvp = _LazyTmvp(tmvp_ectxs, params.pps,
                                       [-d for d in _sd(params, 0)],
                                       [-d for d in _sd(params, 1)],
                                       ctx.dmvr_overrides)

    def _start_recon(self, ctx) -> None:
        """Queue reconstruction: device frame program with use_tpu (falls
        back to host C on unsupported tools), host C entries otherwise."""
        if self.tpu_frames:
            self._start_recon_tpu(ctx)
            if ctx.tpu_state == "done":
                return
            for f in (ctx.refs0 or []) + (ctx.refs1 or []):
                f.ensure_int32()
        self._start_recon_host(ctx)

    def _get_ddpb(self, pic_w, pic_h, chroma):
        from openvvc_tpu.tpu.device_dpb import DeviceDpb

        d = self._ddpb
        if d is None or d.pic_w != pic_w or d.pic_h != pic_h \
                or d.chroma != chroma:
            d = self._ddpb = DeviceDpb(pic_w, pic_h, chroma)
        return d

    def _tpu_fallback(self, ctx, reason: str) -> None:
        """Per-picture device-path rejection observability: one INFO line
        naming the gate + a counter surfaced through Decoder.stats (the
        reference logs tool activations via ov_log, ovutils.h)."""
        from openvvc_tpu.utils.log import ov_log

        poc = getattr(ctx.frame, "poc", "?")
        ov_log("info", f"picture poc={poc} left the device path: {reason}")
        fb = self.stats.setdefault("tpu_fallback_reasons", {})
        fb[reason] = fb.get(reason, 0) + 1

    def _start_recon_tpu(self, ctx) -> None:
        """Build the dense frame IR in C and dispatch the fused device
        program asynchronously (SURVEY §7.1: parse/IR on host, all sample
        math on chip). Sets ctx.tpu_state to "done" or "failed"."""
        if ctx.tpu_state is not None:
            return
        ctx.tpu_state = "failed"
        params, frame = ctx.params, ctx.frame
        sps, pps = params.sps, params.pps
        if getattr(self, "_pre_dbf_hook", None):
            return
        if ctx.lmcs is not None and sps.ctb_log2 != 6:
            self._tpu_fallback(ctx, "lmcs_ctb_not_64")
            return  # device chroma-scale granule assumes 64-px CTUs
        sc = getattr(params, "_rpr_scales", None)
        if sc is not None:
            from openvvc_tpu.rcn.ref_rpr import NO_SCALE
            if any(s != (NO_SCALE, NO_SCALE) for sl in sc for s in sl):
                self._tpu_fallback(ctx, "rpr_scaled_ref")
                return
        raws = []
        for entry, raw, _ectx in ctx.results:
            if raw is None:
                # Python-parsed entry: outside the native toolset
                from openvvc_tpu.native import native_parse_reject_reason

                why = native_parse_reject_reason(params) or "parse_bail"
                self._tpu_fallback(ctx, f"native_parse:{why}")
                return
            raws.append((entry, raw))

        from openvvc_tpu.native import FrameIR, build_ir_entry_native
        from openvvc_tpu.tpu import sao_dense
        from openvvc_tpu.tpu.frame_program import (Cfg, build_dbf_params,
                                                   pack_jobs, run_frame)

        chroma = sps.sps_chroma_format_idc != 0
        bd = sps.bitdepth
        ir = FrameIR(pps.pic_w, pps.pic_h, chroma)
        nb0 = len(ctx.refs0) if ctx.refs0 else 0
        nb1 = len(ctx.refs1) if ctx.refs1 else 0

        # pre-size the per-entry job lists: entries build concurrently and
        # the multichip banding indexes them by tile position
        ir.jobs_l = [None] * len(raws)
        ir.jobs_c = [None] * len(raws)
        ir.dtu = [None] * len(raws)
        ir.dtu_coef = [None] * len(raws)

        def _bir(idx_raw):
            idx, raw = idx_raw
            with trace.span("build_ir_c"):
                return build_ir_entry_native(raw, ir, ctx.dbf, ctx.csign,
                                             nb0, nb1, ctx.dist0, ctx.dist1,
                                             entry_idx=idx)

        items = [(i, raw) for i, (_, raw) in enumerate(raws)]
        if len(raws) > 1 and self.nb_entry_threads > 1:
            oks = list(self._get_ir_pool().map(_bir, items))
        else:
            oks = [_bir(it) for it in items]
        if not all(oks):
            self._tpu_fallback(ctx, "ir_unsupported_tool")
            ir.release()
            return

        with trace.span("bundle_build"):
            entries_bounds = [(e.ctu_x, e.ctu_y, e.nb_ctu_w, e.nb_ctu_h)
                              for e, _ in raws]
            sao_tabs = None
            if any(r.ep.sao_luma or r.ep.sao_chroma for _, r in raws):
                from openvvc_tpu.native import _CTU_NFIELDS as _CNF
                from openvvc_tpu.native import _SAO_NFIELDS as _SNF
                recs = [(r.ctu_meta[:int(r.counts[3]) * 3].reshape(-1, 3),
                         r.sao_buf[:int(r.counts[3]) * _CNF]
                         .reshape(-1, _CNF)[:, :_SNF]) for _, r in raws]
                sao_tabs = sao_dense.build_sao_tables_recs(
                    recs, entries_bounds, sps.ctb_log2, pps.pic_w, pps.pic_h,
                    chroma)

            alf_tabs = None
            entries_t = tuple(entries_bounds)
            gs = lambda n: int(getattr(params.sh, n, 0) or 0)
            if any(gs(n) for n in ("sh_alf_enabled_flag",
                                   "sh_alf_cb_enabled_flag",
                                   "sh_alf_cr_enabled_flag",
                                   "sh_alf_cc_cb_enabled_flag",
                                   "sh_alf_cc_cr_enabled_flag")):
                from openvvc_tpu.native import _alf_params_from_raw
                from openvvc_tpu.tpu import alf_dense

                alf_params = {}
                for _e, r in raws:
                    nctu = int(r.counts[3])
                    meta = r.ctu_meta[:nctu * 3].reshape(nctu, 3)
                    alf_params.update(_alf_params_from_raw(
                        r.ep, r.sao_buf, meta, nctu))
                aps_luma = [a.alf_data for a in
                            getattr(params, "alf_aps_luma", [])
                            if a is not None]
                aps_c = getattr(params, "alf_aps_chroma", None)
                filters = AlfFilters(
                    aps_luma, aps_c.alf_data if aps_c is not None else None,
                    bd)
                cc = getattr(params, "alf_aps_cc", (None, None))
                cc_data = (cc[0].alf_data if cc[0] is not None else None,
                           cc[1].alf_data if cc[1] is not None else None)
                full = alf_dense.build_alf_tables(
                    alf_params, filters, cc_data, sps.ctb_log2, pps.pic_w,
                    pps.pic_h, chroma)
                if full is not None:
                    alf_tabs = {k: full[k] for k in alf_dense.TRACED_KEYS}

            dbf_params = None
            if ctx.dbf is not None:
                from openvvc_tpu.rcn.ref_dbf import _beta_tc_offsets
                no_x, no_y = [], []
                ti = params.tile_info
                if (ti.nb_tiles > 1 and not
                        pps.pps_loop_filter_across_tiles_enabled_flag):
                    no_x = [x << sps.ctb_log2 for x in ti.col_x()[1:-1]]
                    no_y = [y << sps.ctb_log2 for y in ti.row_y()[1:-1]]
                offs = (_beta_tc_offsets(params, "luma")
                        + _beta_tc_offsets(params, "cb")
                        + _beta_tc_offsets(params, "cr"))
                with trace.span("dbf_params"):
                    dbf_params = build_dbf_params(
                        ctx.dbf, offs, bd, pps.pic_w, pps.pic_h,
                        sps.ctb_log2, chroma, no_x, no_y)

            has_inter = ctx.refs0 is not None
            arrs = {"res_y": ir.res_y, "jobs_l": pack_jobs(ir.jobs_l)}
            if chroma:
                arrs["res_cb"] = ir.res_cb
                arrs["res_cr"] = ir.res_cr
                arrs["jobs_c"] = pack_jobs(ir.jobs_c)
            if has_inter:
                from openvvc_tpu.tpu.mc_dense import prepare_mc_args

                lut0 = np.zeros(16, np.int32)
                lut1 = np.zeros(16, np.int32)
                ddpb = self._get_ddpb(pps.pic_w, pps.pic_h, chroma)
                refs_all = (ctx.refs0 or []) + (ctx.refs1 or [])
                pinned = refs_all + [frame]
                ddpb.ensure_refs(refs_all, pinned)
                for i, f in enumerate(ctx.refs0 or []):
                    lut0[i] = ddpb.slot_of(f)
                for i, f in enumerate(ctx.refs1 or []):
                    lut1[i] = ddpb.slot_of(f)
                arrs["gmask"] = ir.gmask
                margs = prepare_mc_args(ir.gmv, ir.gref, ir.gw, ir.ghpel,
                                        lut0, lut1, ir.uw, ir.uh,
                                        glist=ir.glist)
                if ir.has_gpm:
                    # per-sample GPM blend weights in unit-block layout;
                    # the combine uses w0/8-w0 from this plane
                    margs["wp"] = (ir.gwp
                                   .reshape(ir.uh, 4, ir.uw, 4)
                                   .transpose(0, 2, 1, 3)
                                   .reshape(ir.uh * ir.uw, 4, 4)
                                   .copy())
                arrs["margs"] = margs
            else:
                ddpb = self._get_ddpb(pps.pic_w, pps.pic_h, chroma)
            if dbf_params is not None:
                arrs["dbf"] = dbf_params
            if sao_tabs is not None:
                arrs["sao"] = sao_tabs
            if alf_tabs is not None:
                arrs["alf"] = alf_tabs
            lmcs_on = ctx.lmcs is not None
            if lmcs_on:
                from openvvc_tpu.tpu.lmcs_dense import build_lmcs_tables

                tu_bufs = [(r.tu_buf, int(r.counts[1])) for _, r in raws]
                arrs["lmcs"] = build_lmcs_tables(
                    ctx.lmcs, params.tile_info, sps.ctb_log2, pps.pic_w,
                    pps.pic_h, tu_bufs, chroma)
                if chroma and not ctx.tools.get("scale_c", False):
                    # ph_chroma_residual_scale_flag off: no scaling
                    arrs["lmcs"]["csc"][:] = 0
            dtu_sig = ()
            if any(d is not None and len(d) for d in ir.dtu):
                # device residuals: raw levels + resolved selectors ride
                # the bundle; dequant+LFNST+itx run in the frame program
                from openvvc_tpu.tpu import resid_dense

                if not hasattr(self, "_dtu_caps"):
                    self._dtu_caps = {}
                with trace.span("dtu_pack"):
                    dtu_buckets, dtu_sig = resid_dense.pack_dtu(
                        ir.dtu, ir.dtu_coef, self._dtu_caps)
                if dtu_buckets is not None:
                    arrs["dtu"] = dtu_buckets
                    n = sum(len(d) for d in ir.dtu if d is not None)
                    self.stats["dtu_tbs"] = self.stats.get("dtu_tbs", 0) + n
            slot = ddpb.alloc(frame, (ctx.refs0 or []) + (ctx.refs1 or [])
                              + [frame])
            from openvvc_tpu.tpu import intra_wave as _iw

            jl = arrs["jobs_l"]
            mip_on = bool(jl.size) and bool(
                (jl[:, _iw.J_KIND, :] == _iw.KIND_MIP).any())
            ciip_on = bool(jl.size) and bool(
                (jl[:, _iw.J_KIND, :] == _iw.KIND_CIIP).any())
            jc = arrs.get("jobs_c")
            cclm_on = (jc is not None and bool(jc.size) and bool(
                (jc[:, _iw.J_KIND, :] == _iw.KIND_CCLM).any()))
            colloc = bool(getattr(
                sps, "sps_chroma_vertical_collocated_flag", 0) or 0)
            cfg = Cfg(pps.pic_w, pps.pic_h, ir.uw, ir.uh, bd, chroma,
                      has_inter, dbf_params is not None,
                      sao_tabs is not None, sps.ctb_log2,
                      alf_tabs is not None, entries_t,
                      mip_on, lmcs_on, cclm_on, colloc, ciip_on, dtu_sig)
        with trace.span("device_dispatch"):
            frame._dev_out = run_frame(ddpb, slot, arrs, cfg)
        # the packed outputs of the in-flight window are fetched as ONE
        # device concat + ONE transfer, prefetched on a dedicated thread
        # so the copy rides alongside the next pictures' parse/dispatch
        frame._flush_cb = self._flush_tpu_fetch
        self._tpu_batch.append(frame)
        # the batch must SUBMIT before the backpressure pop below can
        # reach any frame in it — otherwise the pop force-flushes a batch
        # containing the frame dispatched THIS call and the wait
        # serializes against its own device compute.  depth-k pipeline ->
        # batch at most k-1 frames.  Default 1 (per-frame prefetch);
        # OPENVVC_D2H_BATCH sets k
        batch_k = int(os.environ.get("OPENVVC_D2H_BATCH", "1"))
        if len(self._tpu_batch) >= max(1, min(batch_k,
                                              self.nb_frame_threads - 1)):
            self._flush_tpu_fetch()
        # frame-pipeline backpressure (-t): allow nb_frame_threads
        # pictures in flight (dispatched, fetch pending) before blocking
        # on the oldest — bounds the output backlog and device working set
        self._inflight.append(frame)
        while len(self._inflight) > self.nb_frame_threads:
            self._inflight.pop(0).sync_host()
        for _e, raw in raws:
            raw.release()
        self.stats["tpu_frames"] = self.stats.get("tpu_frames", 0) + 1
        ctx.tpu_state = "done"

    def _flush_tpu_fetch(self) -> None:
        """Submit one batched D2H for every dispatched-but-unfetched
        picture: device-side concat of the packed uint8/int16 outputs,
        one transfer, per-frame views by offset."""
        batch = self._tpu_batch
        if not batch:
            return
        self._tpu_batch = []
        import jax.numpy as jnp

        outs = [f._dev_out for f in batch]
        dev = outs[0] if len(outs) == 1 else jnp.concatenate(outs)

        def _fetch(a=dev):
            with trace.span("d2h_fetch"):
                return np.asarray(a)

        fut = self._get_fetch_pool().submit(_fetch)
        off = 0
        for f, o in zip(batch, outs):
            f._batch_fetch = (fut, off, o.shape[0])
            f._flush_cb = None
            off += o.shape[0]

    def _start_recon_host(self, ctx) -> None:
        """Queue native entry reconstruction on the pool. Caller must
        guarantee the reference pictures are pixel-complete (the decode
        loop only reaches here after finishing every earlier picture)."""
        if ctx.recon_futures is not None:
            return
        from openvvc_tpu.native import recon_entry_native

        frame = ctx.frame
        refs0, refs1 = ctx.refs0, ctx.refs1
        dist0, dist1, dbf, csign = ctx.dist0, ctx.dist1, ctx.dbf, ctx.csign

        def _nrecon(item):
            with trace.span("recon_entry_c"):
                _entry, raw = item
                ok = recon_entry_native(raw, frame, refs0, dist0, dbf,
                                        csign, refs1, dist1)
                return None if ok else item

        items = [(e, raw) for (e, raw, _ectx) in ctx.results
                 if raw is not None] if ctx.native_recon else []
        ctx.native_items = items
        if items:
            pool = self._get_pool()
            ctx.recon_futures = [pool.submit(_nrecon, it) for it in items]
        else:
            ctx.recon_futures = []

    def _finish_picture(self, ctx) -> Frame:
        if self.tpu_frames:
            self._start_recon_tpu(ctx)
            if ctx.tpu_state == "done":
                return ctx.frame
            # host fallback needs reference pixels on host
            for f in (ctx.refs0 or []) + (ctx.refs1 or []):
                f.ensure_int32()
        params, frame, poc = ctx.params, ctx.frame, ctx.poc
        sps, pps = params.sps, params.pps
        bd = sps.bitdepth
        refs0, refs1 = ctx.refs0, ctx.refs1
        dist0, dist1 = ctx.dist0, ctx.dist1
        tools, lmcs, dbf, csign = ctx.tools, ctx.lmcs, ctx.dbf, ctx.csign
        dmvr_overrides = ctx.dmvr_overrides

        sao_entries = []
        alf_entries = []

        # reconstruction: native entries write the frame planes + DBF maps
        # in C; tiles write disjoint rects so entries run in parallel
        pending = [(e, ectx) for (e, raw, ectx) in ctx.results
                   if raw is None]  # entries needing the Python recon path
        self._start_recon(ctx)  # no-op when the pipeline queued it already
        with trace.span("recon_wait"):
            fallbacks = [r for r in (f.result() for f in ctx.recon_futures)
                         if r is not None]
        if fallbacks:
            from openvvc_tpu.native import _convert_native_entry

            for entry, raw in fallbacks:
                ectx, _, _ = _convert_native_entry(params, entry, raw)
                pending.append((entry, ectx))
        # natively-reconstructed entries are done with their SoA buffers;
        # recycle them (fallback items keep theirs — the converted CU/TU
        # objects may hold views into coef_buf)
        fb = {id(r[1]) for r in fallbacks}
        for _e, raw in (ctx.native_items or ()):
            if id(raw) not in fb:
                raw.release()

        precompute_residuals_batched(pending, tools, bd,
                                     device=self.use_tpu_residuals)
        rpr_active = False
        sc = getattr(params, "_rpr_scales", None)
        if sc is not None:
            from openvvc_tpu.rcn.ref_rpr import NO_SCALE
            rpr_active = any(s != (NO_SCALE, NO_SCALE)
                             for sl in sc for s in sl)
        if refs0 is not None and not rpr_active:
            from openvvc_tpu.rcn.pipeline import precompute_inter_mc

            precompute_inter_mc(pending, params, tools,
                                (refs0, refs1, dist0, dist1), bd,
                                device=self.use_tpu_residuals)

        def _recon_one(item):
            entry, ectx = item
            rc = ReconCtx(frame, params, entry)
            etools = tools
            if lmcs is not None:
                # chroma_scale is running state mutated per 64-block in
                # decode order; entries reconstruct concurrently on the
                # pool, so each needs its own scale state (the reference
                # keeps it in the per-entry ctudec, rcn_lmcs.c:321 —
                # sharing one across tiles let a tile's TUs consume the
                # other tile's most recent scale)
                import copy as _copy

                etools = dict(tools)
                etools["lmcs"] = _copy.copy(lmcs)
            rc.tools = etools
            rc.dmvr_overrides = dmvr_overrides
            erefs = (refs0, refs1, dist0, dist1) if refs0 is not None else None
            # Wavefront-batched intra: safe when every CU's cross-CU reads
            # are bounded by the intra reference span (no IBC far-reads, no
            # dual-tree chroma coordinates, no LMCS running scale state).
            if self.use_tpu_residuals and lmcs is None and all(
                    cu.tree_type == TREE_SINGLE and cu.pred_mode != 2
                    for ctu in ectx.ctus for cu in ctu.cus):
                _recon_entry_waves(rc, ectx, params, etools, dbf, erefs)
                return
            for ctu in ectx.ctus:
                for cu in ctu.cus:
                    reconstruct_cu(rc, cu, params, etools, dbf, erefs)

        with trace.span("recon_py"):
            if min(len(pending), self.nb_entry_threads) > 1:
                list(self._get_pool().map(_recon_one, pending))
            else:
                for item in pending:
                    _recon_one(item)

        for entry, ectx in ctx.ectxs:
            if ectx.sao_params or getattr(ectx, "sao_recs", None) is not None:
                sao_entries.append((entry, ectx))
            if ectx.alf_params:
                alf_entries.append((entry, ectx.alf_params))

        if lmcs is not None:
            frame.y = lmcs.bwd_lut[np.clip(frame.y, 0, (1 << bd) - 1)].astype(np.int32)
        dbf_span = trace.span("dbf_frame")
        dbf_span.__enter__()
        if dbf is not None:
            hook = getattr(self, "_pre_dbf_hook", None)
            native_dbf = None
            if not self.use_tpu_residuals and self.use_native_recon:
                from openvvc_tpu.native import dbf_frame_native
                native_dbf = dbf_frame_native
            if native_dbf is not None:
                from openvvc_tpu.rcn.ref_dbf import _beta_tc_offsets

                no_x, no_y = [], []
                ti = params.tile_info
                if (ti.nb_tiles > 1 and not
                        pps.pps_loop_filter_across_tiles_enabled_flag):
                    no_x = [x << sps.ctb_log2 for x in ti.col_x()[1:-1]]
                    no_y = [y << sps.ctb_log2 for y in ti.row_y()[1:-1]]
                offs = (_beta_tc_offsets(params, "luma")
                        + _beta_tc_offsets(params, "cb")
                        + _beta_tc_offsets(params, "cr"))
                finalize = True
                if hook is not None:  # tests inspect finalized maps
                    dbf.finalize_inter_bs()
                    hook(frame, dbf, params)
                    finalize = False
                if frame.cb is not None:
                    # luma (incl. the inter-bs finalize pass) and chroma
                    # touch disjoint maps/planes: run them on two threads
                    # (the C call releases the GIL)
                    fut = self._get_pool().submit(
                        native_dbf, frame, dbf, offs, sps.ctb_log2,
                        no_x, no_y, finalize, 1)
                    okc = native_dbf(frame, dbf, offs, sps.ctb_log2,
                                     no_x, no_y, False, 2)
                    if not (fut.result() and okc):
                        native_dbf = None
                elif not native_dbf(frame, dbf, offs, sps.ctb_log2, no_x,
                                    no_y, finalize=finalize):
                    native_dbf = None  # lib unavailable: numpy fallback
            if native_dbf is None:  # numpy / device fallback
                dbf.finalize_inter_bs()
                if hook is not None:
                    hook(frame, dbf, params)
                from openvvc_tpu.rcn.jax_dbf import deblock_frame_batched

                if self.use_tpu_residuals:
                    import jax.numpy as jnp

                    dy, dcb, dcr = deblock_frame_batched(
                        jnp, jnp.asarray(frame.y),
                        jnp.asarray(frame.cb) if frame.cb is not None else None,
                        jnp.asarray(frame.cr) if frame.cr is not None else None,
                        dbf, params, sps.ctb_log2, bd)
                    # np.array (not asarray): device->host views are read-only
                    # and SAO/ALF mutate the planes in place
                    frame.y = np.array(dy)
                    if dcb is not None:
                        frame.cb, frame.cr = np.array(dcb), np.array(dcr)
                else:
                    frame.y, frame.cb, frame.cr = deblock_frame_batched(
                        np, frame.y, frame.cb, frame.cr, dbf, params,
                        sps.ctb_log2, bd)
        dbf_span.__exit__()
        sao_span = trace.span("sao_frame")
        sao_span.__enter__()
        for entry, ectx in sao_entries:
            bounds = (entry.ctu_x, entry.ctu_y, entry.nb_ctu_w, entry.nb_ctu_h)
            if self.use_native_recon and not self.use_tpu_residuals:
                from openvvc_tpu.native import (sao_apply_native,
                                                sao_recs_from_params)

                recs = getattr(ectx, "sao_recs", None)
                if recs is None:
                    recs = sao_recs_from_params(ectx.sao_params)
                if sao_apply_native(frame, bounds, sps.ctb_log2, recs):
                    continue
            apply_sao_entry(frame, bounds, sps.ctb_log2, ectx.sao_params,
                            bd, pps.pic_w, pps.pic_h)
        sao_span.__exit__()
        if alf_entries:
            aps_luma = [a.alf_data for a in getattr(params, "alf_aps_luma", []) if a is not None]
            aps_c = getattr(params, "alf_aps_chroma", None)
            filters = AlfFilters(aps_luma, aps_c.alf_data if aps_c is not None else None, bd)
            cc = getattr(params, "alf_aps_cc", (None, None))
            cc_data = (cc[0].alf_data if cc[0] is not None else None,
                       cc[1].alf_data if cc[1] is not None else None)
            for entry, alf_params in alf_entries:
                apply_alf_entry(frame, (entry.ctu_x, entry.ctu_y, entry.nb_ctu_w, entry.nb_ctu_h),
                                sps.ctb_log2, alf_params, filters, cc_data, bd,
                                pps.pic_w, pps.pic_h)
        # frame.tmvp was published at _join_parse (parse product); the
        # frame itself was registered in the DPB at _start_picture
        return frame

    @staticmethod
    def _dbf_disabled(params) -> bool:
        pps, ph, sh = params.pps, params.ph, params.sh
        if sh.sh_deblocking_params_present_flag:
            return bool(sh.sh_deblocking_filter_disabled_flag)
        if ph.ph_deblocking_params_present_flag:
            return bool(ph.ph_deblocking_filter_disabled_flag)
        return bool(pps.pps_deblocking_filter_disabled_flag)


def precompute_residuals_batched(parsed, tools, bitdepth, device=True):
    """Group eligible TUs by (comp-class, size, transform pair) and run their
    dequant + inverse transform as batched launches (XLA when device=True,
    vectorized numpy otherwise); results are attached as
    tu.residual_precomputed and consumed by reconstruct_cu.

    Eligible: non-transform-skip, non-LFNST, non-ISP TUs (the rest fall back
    to the scalar reference path)."""
    import numpy as np

    from openvvc_tpu.rcn.jax_transform import (
        reconstruct_residual_batch,
        reconstruct_residual_batch_np,
    )
    from openvvc_tpu.rcn.ref_transform import transform_pair

    trc = _TrCtx(tools["dep_quant"], tools["mts_implicit"], tools.get("mts_enabled", False))
    groups = {}
    for _, ectx in parsed:
        for ctu in ectx.ctus:
            for cu in ctu.cus:
                if cu.isp_mode or cu.sbt_flag:
                    continue
                intra = cu.pred_mode == 0
                for tu in cu.tus:
                    if not tu.cbf or tu.transform_skip or tu.lfnst_idx:
                        continue
                    tr_h, tr_v = transform_pair(tu, trc, intra, bool(cu.mip_flag))
                    key = (tu.log2_w, tu.log2_h, tr_h, tr_v)
                    groups.setdefault(key, []).append(tu)

    for (l2w, l2h, tr_h, tr_v), tus in groups.items():
        levels = np.stack([tu.coeffs for tu in tus]).astype(np.int32)
        qps = np.asarray([tu.qp for tu in tus], np.int32)
        if device:
            res = np.asarray(reconstruct_residual_batch(
                levels, qps, tr_h, tr_v, l2w, l2h, tools["dep_quant"], bitdepth))
        else:
            res = reconstruct_residual_batch_np(
                levels, qps, tr_h, tr_v, l2w, l2h, tools["dep_quant"], bitdepth)
        for i, tu in enumerate(tus):
            tu.residual_precomputed = res[i]


def decode_to_yuv(stream: bytes) -> bytes:
    return b"".join(f.to_yuv_bytes() for f in Decoder().decode(stream))
