"""CTU parse context: neighbor maps, tool flags, and the CTU tensor IR.

This replaces the reference's per-thread OVCTUDec + CABAC line buffers
(/root/reference/libovvc/ctudec.h:570-808, slicedec.h:81-156). Instead of
1-D rotating line buffers we keep full-tile 2-D neighbor maps at 4x4
granularity — simpler, bit-identical in effect, and the natural layout to
hand to batched device kernels later.

The parse produces a list of `CU` IR nodes per CTU (the "CTU tensor IR" from
SURVEY.md section 7.1): reconstruction consumes these without touching CABAC
state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from openvvc_tpu.hls.ph import SLICE_I
from openvvc_tpu.hls.syntax import SyntaxStruct

UNAVAIL = 0xFF

# intra prediction modes
INTRA_PLANAR = 0
INTRA_DC = 1
INTRA_ANGULAR_MIN = 2
INTRA_ANGULAR_MAX = 66
INTRA_LT_CCLM = 81
INTRA_L_CCLM = 82
INTRA_T_CCLM = 83
INTRA_DM = 67  # marker used during parse before DM resolution

MODE_INTRA = 0
MODE_INTER = 1
MODE_IBC = 2
MODE_PLT = 3

TREE_SINGLE = 0
TREE_DUAL_LUMA = 1
TREE_DUAL_CHROMA = 2

MODE_TYPE_ALL = 0
MODE_TYPE_INTER = 1
MODE_TYPE_INTRA = 2


class Node(SyntaxStruct):
    """Generic syntax node with default-0 fields."""


@dataclass
class TU:
    """One transform unit of one component in the IR."""

    x0: int  # component-space coordinates
    y0: int
    log2_w: int
    log2_h: int
    comp: int  # 0=Y, 1=Cb, 2=Cr
    cbf: int = 0
    coeffs: np.ndarray | None = None  # int32 [h, w] when cbf
    joint_cbcr: int = 0
    lfnst_idx: int = 0
    mts_idx: int = 0  # resolved transform pair index
    transform_skip: int = 0
    qp: int = 0
    bdpcm: int = 0
    levels: np.ndarray | None = None  # transmitted levels
    last_pos: tuple | None = None
    sig_sb_map: int = 0


@dataclass
class CU:
    """One coding unit in the IR (modes + its TUs)."""

    x0: int  # luma coordinates relative to picture
    y0: int
    log2_w: int
    log2_h: int
    tree_type: int = TREE_SINGLE
    pred_mode: int = MODE_INTRA
    # intra
    intra_mode_l: int = INTRA_PLANAR
    intra_mode_c: int = INTRA_PLANAR
    mip_flag: int = 0
    mip_transpose: int = 0
    mip_mode: int = 0
    mrl_idx: int = 0
    isp_mode: int = 0  # 0 none, 1 horizontal, 2 vertical
    bdpcm_l: int = 0
    bdpcm_dir_l: int = 0
    bdpcm_c: int = 0
    bdpcm_dir_c: int = 0
    lfnst_idx: int = 0
    # inter
    skip_flag: int = 0
    merge_flag: int = 0
    merge_idx: int = 0
    ref_idx: int = 0
    mvd: tuple = (0, 0)
    mvp_idx: int = 0
    inter_dir: int = 1
    ref_idx1: int = 0
    mvd1: tuple = (0, 0)
    mvp_idx1: int = 0
    mv1: object = None
    mmvd_flag: int = 0
    ciip_flag: int = 0
    ciip_wt: int = 1
    bcw_idx: int = 2
    smvd_flag: int = 0
    gpm_flag: int = 0
    gpm_split_dir: int = 0
    gpm_idx0: int = 0
    gpm_idx1: int = 1
    gpm_dirs: tuple = None
    gpm_mvs: tuple = None
    gpm_units: list = None
    sbt_flag: int = 0
    sbt_quad: int = 0
    sbt_hor: int = 0
    sbt_pos: int = 0
    # affine / subblock merge
    sb_merge_flag: int = 0
    affine_flag: int = 0
    affine_type: int = 0
    affine_mvd0: tuple = None  # ((lt.x,lt.y),(rt.x,rt.y)[,(lb.x,lb.y)])
    affine_mvd1: tuple = None
    sb_info: object = None     # recon payload (sub-block MVs / sbtmvp units)
    ibc_flag: int = 0
    ibc_mv: tuple = None       # integer-pel (x, y) for the block copy
    ibc_dbf: tuple = None      # (top_edge_units, left_edge_units) bs1 masks
    amvr_prec: int = 4  # MV_PRECISION_QUARTER
    mv0: object = None  # drv result (drv.inter_mvp.MV)
    prec_amvr_eff: int = 4  # slice-running prec after this CU (hpel MC select)
    root_cbf: int = 1
    qp: int = 0
    tus: list = field(default_factory=list)


@dataclass
class CtuIR:
    """Parsed contents of one CTU."""

    ctb_x: int  # in CTU units, picture coords
    ctb_y: int
    cus: list = field(default_factory=list)
    sao: object = None
    alf: object = None


def _signed_rpl_deltas(rpl, nb_active, cur_poc=0):
    """Signed ref-POC offsets (ref_poc - cur_poc) per active entry
    (dpb.c compute_ref_poc :459-486: chained, sign 0 = future step;
    long-term entries resolve to rpls_poc_lsb_lt and re-base the chain)."""
    out = []
    base = 0
    for i in range(min(nb_active, getattr(rpl, "num_ref_entries", 0))):
        if not rpl.st_ref_pic_flag[i]:
            base = rpl.rpls_poc_lsb_lt[i] - cur_poc
        else:
            a = rpl.abs_delta_poc_st[i] + 1
            base = base - a if rpl.strp_entry_sign_flag[i] else base + a
        out.append(base)
    return out


class CTUParseCtx:
    """Mutable state for parsing one rectangular entry (tile)."""

    def __init__(self, io, params, entry):
        self.io = io
        self.params = params
        self.entry = entry
        sps, pps, ph, sh = params.sps, params.pps, params.ph, params.sh
        self.sps, self.pps, self.ph, self.sh = sps, pps, ph, sh

        self.slice_type = params.slice_type
        self.slice_qp = params.slice_qp
        self.qp = self.slice_qp
        self.bitdepth = sps.bitdepth

        self.log2_ctb = sps.ctb_log2
        self.ctb_size = 1 << self.log2_ctb

        if self.slice_type == SLICE_I:
            self.part_luma = params.part_info["intra_luma"]
            self.part_chroma = params.part_info["intra_chroma"]
        else:
            self.part_luma = params.part_info["inter_luma"]
            self.part_chroma = params.part_info["inter_chroma"]

        # tool enables resolved once per slice (slicedec_init_slice_tools analog)
        self.dual_tree_intra = bool(sps.sps_qtbtt_dual_tree_intra_flag) and self.slice_type == SLICE_I
        self.chroma_enabled = sps.sps_chroma_format_idc != 0
        self.cclm_enabled = bool(sps.sps_cclm_enabled_flag)
        self.mip_enabled = bool(sps.sps_mip_enabled_flag)
        self.mrl_enabled = bool(sps.sps_mrl_enabled_flag)
        self.isp_enabled = bool(sps.sps_isp_enabled_flag)
        self.bdpcm_enabled = bool(sps.sps_bdpcm_enabled_flag)
        self.lfnst_enabled = bool(sps.sps_lfnst_enabled_flag)
        self.mts_enabled = bool(sps.sps_mts_enabled_flag)
        self.mts_implicit = bool(sps.sps_mts_enabled_flag) and not sps.sps_explicit_mts_intra_enabled_flag
        self.explicit_mts_intra = bool(sps.sps_explicit_mts_intra_enabled_flag)
        self.explicit_mts_inter = bool(sps.sps_explicit_mts_inter_enabled_flag)
        self.transform_skip_enabled = bool(sps.sps_transform_skip_enabled_flag)
        self.log2_ts_max = sps.sps_log2_transform_skip_max_size_minus2 + 2
        self.joint_cbcr_enabled = bool(sps.sps_joint_cbcr_enabled_flag)
        self.sbt_enabled = bool(sps.sps_sbt_enabled_flag)
        self.ibc_enabled = bool(sps.sps_ibc_enabled_flag)
        self.plt_enabled = bool(sps.sps_palette_enabled_flag)
        self.dep_quant = bool(sh.sh_dep_quant_used_flag)
        self.sign_hiding = bool(sh.sh_sign_data_hiding_used_flag)
        self.sao_luma = bool(sh.sh_sao_luma_used_flag)
        self.sao_chroma = bool(sh.sh_sao_chroma_used_flag)
        self.cu_qp_delta_enabled = bool(pps.pps_cu_qp_delta_enabled_flag)
        self.max_num_merge_cand = 6 - sps.sps_six_minus_max_num_merge_cand

        # inter tool enables (slicedec.c :1399-1440)
        self.sbtmvp_enabled = bool(sps.sps_sbtmvp_enabled_flag) and bool(
            getattr(ph, "ph_temporal_mvp_enabled_flag", 0))
        self.affine_enabled = bool(sps.sps_affine_enabled_flag)
        self.mmvd_enabled = bool(sps.sps_mmvd_enabled_flag)
        self.ciip_enabled = bool(sps.sps_ciip_enabled_flag)
        self.gpm_enabled = bool(getattr(sps, "sps_gpm_enabled_flag", 0))
        # slicedec.c :1447-1456
        if self.gpm_enabled and self.max_num_merge_cand >= 3:
            self.max_gpm_cand = self.max_num_merge_cand - int(
                getattr(sps, "sps_max_num_merge_cand_minus_max_num_gpm_cand", 0))
        elif self.gpm_enabled and self.max_num_merge_cand == 2:
            self.max_gpm_cand = 2
        else:
            self.max_gpm_cand = 0
        self.amvr_enabled = bool(sps.sps_amvr_enabled_flag)
        self.bcw_enabled = bool(getattr(sps, "sps_bcw_enabled_flag", 0))
        self.smvd_sps = bool(getattr(sps, "sps_smvd_enabled_flag", 0))
        self.mmvd_shift = int(getattr(ph, "ph_mmvd_fullpel_only_flag", 0)) << 1
        self.ref_smvd_idx0 = -1
        self.ref_smvd_idx1 = -1
        self.tmvp_enabled = bool(getattr(ph, "ph_temporal_mvp_enabled_flag", 0))

        # tile geometry in luma samples
        self.tile_x0 = entry.ctu_x << self.log2_ctb
        self.tile_y0 = entry.ctu_y << self.log2_ctb
        self.tile_w = min(entry.nb_ctu_w << self.log2_ctb, pps.pic_w - self.tile_x0)
        self.tile_h = min(entry.nb_ctu_h << self.log2_ctb, pps.pic_h - self.tile_y0)
        self.pic_w = pps.pic_w
        self.pic_h = pps.pic_h

        self.inter_ctx = None
        self.mvd1_zero = bool(getattr(ph, "ph_mvd_l1_zero_flag", 0))
        self.smvd_enabled = False  # resolved below (slicedec_smvd_params)
        if self.slice_type != SLICE_I:
            from openvvc_tpu.drv.inter_mvp import InterCtx

            uw_i = (self.tile_w + 3) >> 2
            uh_i = (self.tile_h + 3) >> 2
            nra = getattr(sh, "_num_ref_idx_active", [1, 0])
            self.inter_ctx = InterCtx(uw_i, uh_i, nra[0], nra[1],
                                      self.max_num_merge_cand)
            # rpl0_opp / rpl1_opp: index of the same picture in the other
            # list (slicedec.c :1261-1293); POC equality == signed-delta
            # equality, derivable straight from the RPL entries
            hr0, hr1 = sh.resolved_rpls(pps, ph)
            cur_poc = getattr(params, "_cur_poc", ph.ph_pic_order_cnt_lsb)
            d0 = _signed_rpl_deltas(hr0.rpl, nra[0], cur_poc)
            d1 = _signed_rpl_deltas(hr1.rpl, nra[1], cur_poc)
            for i, d in enumerate(d0):
                self.inter_ctx.rpl0_opp[i] = d1.index(d) if d in d1 else 0xFF
            for i, d in enumerate(d1):
                self.inter_ctx.rpl1_opp[i] = d0.index(d) if d in d0 else 0xFF
            self.inter_ctx.dist_ref0 = [-d for d in d0]
            self.inter_ctx.dist_ref1 = [-d for d in d1]
            # SMVD ref pair (slicedec_smvd_params :1140): nearest past in
            # L0, nearest future in L1; both must exist and tmvp ldc == 0
            ldc_all = not any(d > 0 for d in d0 + d1)
            if self.smvd_sps and not ldc_all and not self.mvd1_zero:
                fw = [(d, i) for i, d in enumerate(d0) if d < 0]
                bw = [(d, i) for i, d in enumerate(d1) if d > 0]
                if fw and bw:
                    self.ref_smvd_idx0 = max(fw)[1]
                    self.ref_smvd_idx1 = min(bw)[1]
                    self.smvd_enabled = True
            # TMVP: collocated data is attached by the decoder before parse
            # (params._tmvp_col); the writer runs without it, which matches
            # the reference's NULL col planes (no TMVP candidates, same bins)
            if self.tmvp_enabled:
                ldc = not any(d > 0 for d in d0 + d1)
                col = getattr(params, "_tmvp_col", None)
                if col is None:
                    obj = getattr(params, "_tmvp_col_obj", None)
                    if obj is not None:
                        col = obj.resolve()
                self.inter_ctx.tmvp_enabled = True
                self.inter_ctx.ldc = ldc
                # slicedec.c :1441-1443
                self.inter_ctx.col_ref_l0 = bool(
                    getattr(ph, "ph_collocated_from_l0_flag", 0)
                    or getattr(sh, "sh_collocated_from_l0_flag", 0)
                    or self.slice_type == 1)
                self.inter_ctx.log2_ctb_units = self.log2_ctb - 2
                self.inter_ctx.col = col
                self.inter_ctx.tile_uoff = (self.tile_x0 >> 2, self.tile_y0 >> 2)

        # IBC derivation context (drv_ibc.c; slicedec.c :1401)
        self.ibc_ctx = None
        self.nb_ibc_cand = 0
        if self.ibc_enabled:
            from openvvc_tpu.drv.ibc import IbcCtx

            self.nb_ibc_cand = 6 - int(
                getattr(sps, "sps_six_minus_max_num_ibc_merge_cand", 0) or 0)
            uw_i = (self.tile_w + 3) >> 2
            uh_i = (self.tile_h + 3) >> 2
            self.ibc_ctx = IbcCtx(uw_i, uh_i, self.nb_ibc_cand)

        # affine / SbTMVP derivation contexts (slicedec.c init_affine_status
        # :1362 + dpb.c init_tmvp_info col ref indices :1016-1027)
        self.affine_ctx = None
        self.sbtmvp_ctx = None
        self.affine_6param = bool(getattr(sps, "sps_6param_affine_enabled_flag", 0))
        self.affine_amvr_enabled = bool(getattr(sps, "sps_affine_amvr_enabled_flag", 0))
        self.affine_nb_merge_cand = 5 - int(
            getattr(sps, "sps_five_minus_max_num_subblock_merge_cand", 0) or 0)
        if self.inter_ctx is not None and (self.affine_enabled or self.sbtmvp_enabled):
            from openvvc_tpu.drv.affine import AffineCtx, SbTmvpCtx

            prof_en = bool(getattr(sps, "sps_affine_prof_enabled_flag", 0)) \
                and not getattr(ph, "ph_prof_disabled_flag", 0)
            self.affine_ctx = AffineCtx(self.inter_ctx, self.log2_ctb,
                                        self.affine_6param, prof_en,
                                        self.affine_nb_merge_cand,
                                        self.affine_amvr_enabled)
            if self.sbtmvp_enabled:
                from_l0 = bool(getattr(sh, "sh_collocated_from_l0_flag", 1)) \
                    or self.slice_type == 1
                cidx = int(getattr(sh, "sh_collocated_ref_idx", 0) or 0)
                if from_l0:
                    cr0 = cidx
                    dcol = d0[cidx] if cidx < len(d0) else None
                    cr1 = max((i for i, d in enumerate(d1) if d == dcol),
                              default=-1)
                else:
                    cr1 = cidx
                    dcol = d1[cidx] if cidx < len(d1) else None
                    cr0 = max((i for i, d in enumerate(d0) if d == dcol),
                              default=-1)
                nb_ctb_pic_w = (pps.pic_w + self.ctb_size - 1) >> self.log2_ctb
                self.sbtmvp_ctx = SbTmvpCtx(self.inter_ctx, self.log2_ctb,
                                            nb_ctb_pic_w, cr0, cr1)

        # 2-D neighbor maps at 4x4 luma granularity over the tile
        uw = (self.tile_w + 3) >> 2
        uh = (self.tile_h + 3) >> 2
        self.map_log2_w = np.full((uh, uw), UNAVAIL, np.uint8)
        self.map_log2_h = np.full((uh, uw), UNAVAIL, np.uint8)
        self.map_qt_depth = np.zeros((uh, uw), np.uint8)
        self.map_intra_mode = np.full((uh, uw), UNAVAIL, np.uint8)
        self.map_pred_mode = np.full((uh, uw), UNAVAIL, np.uint8)  # MODE_*
        self.map_cu_type = np.full((uh, uw), UNAVAIL, np.uint8)  # CU_* ctx values
        self.map_skip = np.zeros((uh, uw), np.uint8)
        self.map_qp = np.full((uh, uw), self.slice_qp, np.int16)
        # chroma-tree maps (chroma-sample 4x4 granularity)
        cw = (self.tile_w // 2 + 3) >> 2 if self.chroma_enabled else 1
        ch = (self.tile_h // 2 + 3) >> 2 if self.chroma_enabled else 1
        self.cmap_log2_w = np.full((ch, cw), UNAVAIL, np.uint8)
        self.cmap_log2_h = np.full((ch, cw), UNAVAIL, np.uint8)
        self.cmap_qt_depth = np.zeros((ch, cw), np.uint8)

        # per-CTU state
        self.ctu_ir: CtuIR | None = None
        self.tree_type = TREE_SINGLE
        self.mode_type = MODE_TYPE_ALL
        self.share = 0  # SCIPU state: 1 = intra local dual tree, 2 = inter-only
        # CCLM availability state machine (dual-tree 64x64 rule); True outside
        # dual tree. Managed by the tree walker when dual tree is active.
        self._cclm_allowed = True

        # delta-QP bookkeeping (vcl_coding_unit.c :732-751, rcn_dequant.c
        # derive_dequant_ctx): ctx.qp is the running current_qp; qp_map_x/y
        # hold the last coded qp per min-cb column/row of the current CTU
        self.cu_qp_delta = 0
        self.is_cu_qp_delta_coded = False
        self.cu_qp_delta_subdiv = (ph.ph_cu_qp_delta_subdiv_intra_slice
                                   if params.slice_type == 2 else
                                   ph.ph_cu_qp_delta_subdiv_inter_slice)
        nb_units = self.ctb_size >> self.part_luma.log2_min_cb_s
        self.qp_map_x = [self.slice_qp] * nb_units
        self.qp_map_y = [self.slice_qp] * nb_units

        # per-CTU SAO parameters (filled by code_sao_ctu)
        self.sao_params = {}
        self.writer_node = None

        # ALF / CC-ALF state (vcl_alf.c parity); SH carries the slice flags
        self.alf_luma_enabled = bool(sh.sh_alf_enabled_flag)
        self.alf_cb_enabled = bool(sh.sh_alf_cb_enabled_flag)
        self.alf_cr_enabled = bool(sh.sh_alf_cr_enabled_flag)
        self.num_alf_aps_luma = int(sh.sh_num_alf_aps_ids_luma)
        self.alf_chroma_num_alts = 1
        aps_c = getattr(params, "alf_aps_chroma", None)
        if aps_c is not None:
            self.alf_chroma_num_alts = aps_c.alf_data.alf_chroma_num_alt_filters_minus1 + 1
        self.cc_alf_cb_enabled = bool(sh.sh_alf_cc_cb_enabled_flag)
        self.cc_alf_cr_enabled = bool(sh.sh_alf_cc_cr_enabled_flag)
        cc = getattr(params, "alf_aps_cc", (None, None))
        self.cc_alf_nb_filters = [
            (cc[0].alf_data.alf_cc_cb_filters_signalled_minus1 + 1) if cc[0] is not None else 0,
            (cc[1].alf_data.alf_cc_cr_filters_signalled_minus1 + 1) if cc[1] is not None else 0,
        ]
        self.alf_left_flag = 0
        self.alf_line_flags = {}
        self.cc_alf_left_flag = [0, 0]
        self.cc_alf_line_flags = [{}, {}]
        self.alf_params = {}

        # output
        self.ctus: list[CtuIR] = []

    @property
    def slice_is_intra(self) -> bool:
        return self.slice_type == SLICE_I

    def cclm_allowed(self) -> bool:
        if self.tree_type != TREE_DUAL_CHROMA:
            return True
        if self.log2_ctb == 5:
            return True
        return self._cclm_allowed

    # -- coordinate helpers (tile-relative 4x4 units) -------------------
    def _lu(self, x: int, y: int) -> tuple[int, int]:
        return (x - self.tile_x0) >> 2, (y - self.tile_y0) >> 2

    def in_tile(self, x: int, y: int) -> bool:
        return (
            self.tile_x0 <= x < self.tile_x0 + self.tile_w
            and self.tile_y0 <= y < self.tile_y0 + self.tile_h
        )

    # -- luma neighbor queries -----------------------------------------
    def nbr_log2_w_above(self, x: int, y: int) -> int:
        if not self.in_tile(x, y - 1):
            return UNAVAIL
        ux, uy = self._lu(x, y - 1)
        return int(self.map_log2_w[uy, ux])

    def nbr_log2_h_left(self, x: int, y: int) -> int:
        if not self.in_tile(x - 1, y):
            return UNAVAIL
        ux, uy = self._lu(x - 1, y)
        return int(self.map_log2_h[uy, ux])

    def nbr_qt_depth_above(self, x: int, y: int) -> int:
        if not self.in_tile(x, y - 1):
            return 0
        ux, uy = self._lu(x, y - 1)
        return int(self.map_qt_depth[uy, ux])

    def nbr_qt_depth_left(self, x: int, y: int) -> int:
        if not self.in_tile(x - 1, y):
            return 0
        ux, uy = self._lu(x - 1, y)
        return int(self.map_qt_depth[uy, ux])

    def nbr_intra_mode(self, x: int, y: int) -> int:
        """Intra mode at (x,y); UNAVAIL if outside tile or not intra."""
        if not self.in_tile(x, y):
            return UNAVAIL
        ux, uy = self._lu(x, y)
        return int(self.map_intra_mode[uy, ux])

    # -- chroma neighbor queries (chroma coords) ------------------------
    def _cu_idx(self, cx: int, cy: int) -> tuple[int, int]:
        return (cx - (self.tile_x0 >> 1)) >> 2, (cy - (self.tile_y0 >> 1)) >> 2

    def in_tile_c(self, cx: int, cy: int) -> bool:
        return (
            (self.tile_x0 >> 1) <= cx < (self.tile_x0 + self.tile_w) >> 1
            and (self.tile_y0 >> 1) <= cy < (self.tile_y0 + self.tile_h) >> 1
        )

    def cnbr_log2_w_above(self, cx: int, cy: int) -> int:
        if not self.in_tile_c(cx, cy - 1):
            return UNAVAIL
        ux, uy = self._cu_idx(cx, cy - 1)
        return int(self.cmap_log2_w[uy, ux])

    def cnbr_log2_h_left(self, cx: int, cy: int) -> int:
        if not self.in_tile_c(cx - 1, cy):
            return UNAVAIL
        ux, uy = self._cu_idx(cx - 1, cy)
        return int(self.cmap_log2_h[uy, ux])

    def cnbr_qt_depth_above(self, cx: int, cy: int) -> int:
        if not self.in_tile_c(cx, cy - 1):
            return 0
        ux, uy = self._cu_idx(cx, cy - 1)
        return int(self.cmap_qt_depth[uy, ux])

    def cnbr_qt_depth_left(self, cx: int, cy: int) -> int:
        if not self.in_tile_c(cx - 1, cy):
            return 0
        ux, uy = self._cu_idx(cx - 1, cy)
        return int(self.cmap_qt_depth[uy, ux])

    # -- map updates ----------------------------------------------------
    def store_cu_luma(self, cu: CU) -> None:
        ux, uy = self._lu(cu.x0, cu.y0)
        w_u = max(1, (1 << cu.log2_w) >> 2)
        h_u = max(1, (1 << cu.log2_h) >> 2)
        self.map_log2_w[uy : uy + h_u, ux : ux + w_u] = cu.log2_w
        self.map_log2_h[uy : uy + h_u, ux : ux + w_u] = cu.log2_h
        if cu.pred_mode == MODE_INTRA and not cu.mip_flag:
            self.map_intra_mode[uy : uy + h_u, ux : ux + w_u] = cu.intra_mode_l
        elif cu.pred_mode == MODE_INTRA and cu.mip_flag:
            self.map_intra_mode[uy : uy + h_u, ux : ux + w_u] = INTRA_PLANAR
        else:
            self.map_intra_mode[uy : uy + h_u, ux : ux + w_u] = UNAVAIL
        self.map_pred_mode[uy : uy + h_u, ux : ux + w_u] = cu.pred_mode
        self.map_skip[uy : uy + h_u, ux : ux + w_u] = cu.skip_flag

    def store_qt_depth_luma(self, x0: int, y0: int, log2_s: int, qt_depth: int) -> None:
        ux, uy = self._lu(x0, y0)
        n = max(1, (1 << log2_s) >> 2)
        self.map_qt_depth[uy : uy + n, ux : ux + n] = qt_depth

    def store_cu_chroma(self, cx0: int, cy0: int, log2_w: int, log2_h: int) -> None:
        ux, uy = self._cu_idx(cx0, cy0)
        w_u = max(1, (1 << log2_w) >> 2)
        h_u = max(1, (1 << log2_h) >> 2)
        self.cmap_log2_w[uy : uy + h_u, ux : ux + w_u] = log2_w
        self.cmap_log2_h[uy : uy + h_u, ux : ux + w_u] = log2_h

    def store_qt_depth_chroma(self, cx0: int, cy0: int, log2_s: int, qt_depth: int) -> None:
        ux, uy = self._cu_idx(cx0, cy0)
        n = max(1, (1 << log2_s) >> 2)
        self.cmap_qt_depth[uy : uy + n, ux : ux + n] = qt_depth
