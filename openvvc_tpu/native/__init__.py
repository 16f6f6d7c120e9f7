"""Native (C) host-runtime components, loaded via ctypes.

The shared library is rebuilt automatically from source when missing or
stale (gcc is part of the toolchain). Python fallbacks exist for every
native component; the natives are drop-in accelerators for the host parse
path (CABAC entry decode), keeping the device compute path in JAX/XLA.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cabac.c")
_LIB = os.path.join(_DIR, "libcabac.so")


_SRC_RES = os.path.join(_DIR, "residual.c")


_SRC_PARSE = os.path.join(_DIR, "parse.c")

_SRC_RECON = os.path.join(_DIR, "recon.c")

_SRC_DBF = os.path.join(_DIR, "dbf.c")

_SRC_SAO = os.path.join(_DIR, "sao.c")

_HDRS = (os.path.join(_DIR, "ov_shared.h"), os.path.join(_DIR, "tables.h"),
         os.path.join(_DIR, "cabac_inl.h"), os.path.join(_DIR, "gpm_inl.h"))


def _build():
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-fno-math-errno", "-shared",
         "-fPIC", "-o", _LIB, _SRC, _SRC_RES,
         _SRC_PARSE, _SRC_RECON, _SRC_DBF, _SRC_SAO],
        check=True,
        capture_output=True,
    )


_LIB_HANDLE = None


def load_cabac_lib():
    """Returns the ctypes handle for the native CABAC library (or None).

    Memoized: ctypes.CDLL() returns a NEW instance per call with its own
    _FuncPtr cache, so prototypes (argtypes/restype) set on one instance
    don't transfer to the next. Handing out fresh instances while guarding
    prototype setup with a global flag means later instances call into C
    with default 32-bit int conversions — int64 parameters then carry
    garbage upper bits (sporadic, register-content-dependent). One shared
    handle keeps the prototypes attached to the functions actually called.
    """
    global _LIB_HANDLE
    if _LIB_HANDLE is not None:
        return _LIB_HANDLE
    try:
        srcs = (_SRC, _SRC_RES, _SRC_PARSE, _SRC_RECON, _SRC_DBF,
                _SRC_SAO) + _HDRS
        if (not os.path.exists(_LIB)
                or any(os.path.getmtime(_LIB) < os.path.getmtime(s)
                       for s in srcs)):
            _build()
        lib = ctypes.CDLL(_LIB)
    except Exception:
        return None
    lib.cabac_new.restype = ctypes.c_void_p
    lib.cabac_new.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.cabac_free.argtypes = [ctypes.c_void_p]
    lib.cabac_decode_bin.restype = ctypes.c_int
    lib.cabac_decode_bin.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cabac_decode_bypass.restype = ctypes.c_int
    lib.cabac_decode_bypass.argtypes = [ctypes.c_void_p]
    lib.cabac_decode_bypass_bits.restype = ctypes.c_uint32
    lib.cabac_decode_bypass_bits.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cabac_decode_terminate.restype = ctypes.c_int
    lib.cabac_decode_terminate.argtypes = [ctypes.c_void_p]
    lib.cabac_overread.restype = ctypes.c_int
    lib.cabac_overread.argtypes = [ctypes.c_void_p]
    lib.cabac_bitpos.restype = ctypes.c_int64
    lib.cabac_bitpos.argtypes = [ctypes.c_void_p]
    lib.rc_decode_tb.restype = ctypes.c_int64
    lib.rc_decode_tb.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,  # levels int32*
        ctypes.c_void_p,  # decoded int32*
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    _LIB_HANDLE = lib
    return lib


class NativeCabacDecoder:
    """ctypes wrapper with the same interface as cabac.engine.CabacDecoder."""

    _lib = None

    def __init__(self, data: bytes, slice_type: int, slice_qp: int):
        from openvvc_tpu.cabac.ctx import init_context_states

        if NativeCabacDecoder._lib is None:
            NativeCabacDecoder._lib = load_cabac_lib()
        lib = NativeCabacDecoder._lib
        if lib is None:
            raise RuntimeError("native cabac library unavailable")
        s0, s1, r0, r1 = init_context_states(slice_type, slice_qp)
        n = len(s0)
        self._data = data  # keep alive: C side borrows the buffer
        a_s0 = (ctypes.c_uint16 * n)(*s0)
        a_s1 = (ctypes.c_uint16 * n)(*s1)
        a_r0 = (ctypes.c_uint8 * n)(*r0)
        a_r1 = (ctypes.c_uint8 * n)(*r1)
        self._h = lib.cabac_new(data, len(data), a_s0, a_s1, a_r0, a_r1)
        self._lib_ref = lib

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib_ref.cabac_free(h)
            self._h = None

    def decode_bin(self, ctx_idx: int) -> int:
        return self._lib_ref.cabac_decode_bin(self._h, ctx_idx)

    def decode_bypass(self) -> int:
        return self._lib_ref.cabac_decode_bypass(self._h)

    def decode_bypass_bits(self, n: int) -> int:
        return self._lib_ref.cabac_decode_bypass_bits(self._h, n)

    def decode_terminate(self) -> int:
        return self._lib_ref.cabac_decode_terminate(self._h)

    def overread(self) -> bool:
        return bool(self._lib_ref.cabac_overread(self._h))

    def decode_tb(self, log2_w, log2_h, luma, dep_quant, sdh, mts_reduced=False):
        """Native residual_coding: returns (levels, decoded, (lx,ly), sig_map)."""
        import numpy as np

        w, h = 1 << log2_w, 1 << log2_h
        levels = np.zeros((h, w), np.int32)
        decoded = np.zeros((h, w), np.int32)
        sig = ctypes.c_uint64(0)
        packed = self._lib_ref.rc_decode_tb(
            self._h,
            levels.ctypes.data_as(ctypes.c_void_p),
            decoded.ctypes.data_as(ctypes.c_void_p),
            log2_w, log2_h, int(luma), int(dep_quant), int(sdh),
            int(mts_reduced), ctypes.byref(sig))
        return levels, decoded, (packed & 0xFF, (packed >> 8) & 0xFF), sig.value


# ---------------------------------------------------------------------------
# Native full-entry parse (parse.c): feature-gated drop-in for
# vcl.slice_data.parse_entry. Emits flat SoA record buffers that are
# converted into the same CTU IR the Python parser produces; any stream
# construct outside the supported subset returns None and the caller falls
# back to the Python parser.
# ---------------------------------------------------------------------------

import numpy as np


class _EntryParamsC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "pic_w", "pic_h", "log2_ctb",
        "tile_x0", "tile_y0", "tile_w", "tile_h",
        "ctu_x", "ctu_y", "nb_ctu_w", "nb_ctu_h",
        "slice_type", "slice_qp", "qp_bd_offset", "bitdepth",
        "l_min_qt", "l_max_bt", "l_max_tt", "l_mtt_depth", "l_min_cb", "l_max_tb",
        "c_min_qt", "c_max_bt", "c_max_tt", "c_mtt_depth", "c_min_cb", "c_max_tb",
        "chroma_enabled", "cclm", "cclm_colloc", "mip", "mrl", "amvr",
        "dep_quant", "sign_hiding", "sao_luma", "sao_chroma",
        "joint_cbcr", "lfnst", "mts", "mts_implicit",
        "expl_mts_intra", "expl_mts_inter",
        "cu_qp_delta_enabled", "cu_qp_delta_subdiv",
        "max_num_merge_cand", "nb_active_ref0",
        "cqp_tab_len", "cb_qp_off", "cr_qp_off", "jcbcr_qp_off",
        "nb_active_ref1", "mvd1_zero",
    )] + [("rpl0_opp", ctypes.c_int32 * 16), ("rpl1_opp", ctypes.c_int32 * 16)] \
      + [(n, ctypes.c_int32) for n in (
          "tmvp_enabled", "tmvp_ldc", "col_ref_l0", "col_uw", "col_uh",
          "col_uw8", "col_uh8",
      )] + [(n, ctypes.c_int32 * 16) for n in (
          "dist_ref0", "dist_ref1", "dist_col0", "dist_col1")] \
      + [(n, ctypes.c_int32) for n in (
          "alf_luma", "alf_cb", "alf_cr",
          "num_alf_aps_luma", "alf_chroma_num_alts",
          "cc_cb_enabled", "cc_cr_enabled", "cc_nb_cb", "cc_nb_cr",
          "mmvd_enabled", "mmvd_shift", "smvd_enabled",
          "ref_smvd_idx0", "ref_smvd_idx1", "bcw_enabled", "ldc",
          "ciip_enabled", "gpm_enabled", "max_gpm_cand",
          "affine_enabled", "sbtmvp_on", "affine_6param", "affine_prof",
          "affine_amvr", "affine_nb_merge_cand",
          "col_ref_idx0", "col_ref_idx1", "nb_ctb_pic_w",
          "bdof_on", "dmvr_on",
          "ts_enabled", "log2_ts_max", "min_qp_prime_ts",
          "bdpcm_enabled")]


_CU_NFIELDS = 48
_TU_NFIELDS = 17
_SAO_NFIELDS = 24
_ALF_NFIELDS = 6
_CTU_NFIELDS = _SAO_NFIELDS + _ALF_NFIELDS

_parse_proto_done = False


def _setup_parse_proto(lib):
    global _parse_proto_done
    if _parse_proto_done:
        return
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    lib.ov_parse_entry.restype = i64
    lib.ov_parse_entry.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(_EntryParamsC),
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        vp,                              # cqp_tab
        vp, i64, vp, i64, vp, i64,       # cu/tu/coef bufs
        vp, vp, vp, vp, vp, vp,          # sao, meta, tdir0, tmv0, tdir1, tmv1
        vp, vp, vp, vp,                  # collocated dir0/dir1/mv0/mv1
        vp,                              # sub_mv per-unit export (nullable)
        ctypes.POINTER(i64),             # out_counts
    ]
    _parse_proto_done = True


def native_parse_reject_reason(params) -> str | None:
    """Name of the first gate that puts the active parameter set outside
    parse.c's toolset, or None when the native parse supports it.  Feeds
    the per-picture fallback observability (ov_log + Decoder.stats)."""
    sps, pps, ph, sh = params.sps, params.pps, params.ph, params.sh
    g = lambda o, n: int(getattr(o, n, 0) or 0)
    if params.slice_type == 2 and g(sps, "sps_qtbtt_dual_tree_intra_flag"):
        return "dual_tree_intra"
    if g(sps, "sps_chroma_format_idc") > 1:
        return "chroma_format_422_444"
    if g(sps, "sps_ref_pic_resampling_enabled_flag"):
        return "rpr"  # scaled-ref MC not in C; refs may differ in size
    bad_sps = (
        "sps_isp_enabled_flag",
        "sps_sbt_enabled_flag",
        "sps_ibc_enabled_flag", "sps_palette_enabled_flag",
    )
    for n in bad_sps:
        if g(sps, n):
            return n[4:-13]  # strip sps_ / _enabled_flag
    return None


def native_parse_supported(params) -> bool:
    """True when the active parameter set stays inside parse.c's toolset."""
    return native_parse_reject_reason(params) is None


class _NativeInterCtx:
    """Just enough InterCtx surface for decoder._merge_tmvp_export.

    The MV dict form costs ~40ms/frame at 1080p and is only consumed when
    a LATER picture enables TMVP, so it materializes lazily (the analog of
    the reference allocating MV planes on demand, dpb.c:931)."""

    def __init__(self, uw, uh, dir0, mv0_raw, uw8, uh8, dir1=None,
                 mv1_raw=None):
        self.uw, self.uh = uw, uh
        self.dir0 = dir0
        self.dir1 = dir1 if dir1 is not None else np.zeros_like(dir0)
        self._mv0_raw = mv0_raw  # (uh8, uw8, 3) int32
        self._mv1_raw = mv1_raw
        self._uw8, self._uh8 = uw8, uh8
        self._mv0_dict = None
        self._mv1_dict = None

    def _mat(self, dirm, raw_mv):
        from openvvc_tpu.drv.inter_mvp import MV

        d = {}
        if raw_mv is None:
            return d
        dir8 = dirm[::2, ::2]
        ys, xs = np.nonzero(dir8[:self._uh8, :self._uw8])
        for y, x in zip(ys.tolist(), xs.tolist()):
            c = raw_mv[y, x]
            d[(x, y)] = MV(int(c[0]), int(c[1]), int(c[2]))
        return d

    @property
    def tmvp_mv0(self):
        if self._mv0_dict is None:
            self._mv0_dict = self._mat(self.dir0, self._mv0_raw)
        return self._mv0_dict

    @property
    def tmvp_mv1(self):
        if self._mv1_dict is None:
            self._mv1_dict = self._mat(self.dir1, self._mv1_raw)
        return self._mv1_dict


class NativeEntryCtx:
    """Parse result adapter matching the CTUParseCtx surface recon uses."""

    def __init__(self, entry, ctus, sao_params, inter_ctx, tile_x0, tile_y0):
        self.entry = entry
        self.ctus = ctus
        self.sao_params = sao_params
        self.sao_recs = None  # flat SAO records for the C SAO path
        self.alf_params = {}
        self.inter_ctx = inter_ctx
        self.tile_x0 = tile_x0
        self.tile_y0 = tile_y0


class _NoOverread:
    @staticmethod
    def overread():
        return False


class RawNativeEntry:
    """Holds the SoA buffers of one natively-parsed entry (pre-conversion)."""

    __slots__ = ("params", "entry", "ep", "cu_buf", "tu_buf", "coef_buf",
                 "sao_buf", "ctu_meta", "tmvp_dir0", "tmvp_mv0",
                 "tmvp_dir1", "tmvp_mv1", "sub_mv", "counts",
                 "uw", "uh", "uw8", "uh8", "cqp")

    def release(self):
        """Return the big SoA buffers to the pool. Only safe once native
        reconstruction has consumed them (TMVP exports are excluded — the
        DPB keeps those for later pictures' collocated field)."""
        from openvvc_tpu.utils.pool import GLOBAL as _pool

        _pool.give(self.cu_buf, self.tu_buf, self.coef_buf,
                   self.sao_buf, self.ctu_meta)
        self.cu_buf = self.tu_buf = self.coef_buf = None
        self.sao_buf = self.ctu_meta = None


def parse_entry_native_raw(params, entry):
    """Native full-entry parse; returns RawNativeEntry or None."""
    lib = load_cabac_lib()
    if lib is None or not native_parse_supported(params):
        return None
    _setup_parse_proto(lib)

    from openvvc_tpu.cabac.ctx import init_context_states
    from openvvc_tpu.hls.ph import SLICE_I

    sps, pps, ph, sh = params.sps, params.pps, params.ph, params.sh
    g = lambda o, n: int(getattr(o, n, 0) or 0)
    ep = _EntryParamsC()
    log2_ctb = sps.ctb_log2
    ep.pic_w, ep.pic_h, ep.log2_ctb = pps.pic_w, pps.pic_h, log2_ctb
    ep.ctu_x, ep.ctu_y = entry.ctu_x, entry.ctu_y
    ep.nb_ctu_w, ep.nb_ctu_h = entry.nb_ctu_w, entry.nb_ctu_h
    ep.tile_x0 = entry.ctu_x << log2_ctb
    ep.tile_y0 = entry.ctu_y << log2_ctb
    ep.tile_w = min(entry.nb_ctu_w << log2_ctb, pps.pic_w - ep.tile_x0)
    ep.tile_h = min(entry.nb_ctu_h << log2_ctb, pps.pic_h - ep.tile_y0)
    ep.slice_type = params.slice_type
    ep.slice_qp = params.slice_qp
    ep.qp_bd_offset = params.qp_bd_offset
    ep.bitdepth = sps.bitdepth
    key = "intra" if params.slice_type == SLICE_I else "inter"
    pl = params.part_info[f"{key}_luma"]
    pc = params.part_info[f"{key}_chroma"]
    ep.l_min_qt, ep.l_max_bt, ep.l_max_tt = pl.log2_min_qt_s, pl.log2_max_bt_s, pl.log2_max_tt_s
    ep.l_mtt_depth, ep.l_min_cb, ep.l_max_tb = pl.max_mtt_depth, pl.log2_min_cb_s, pl.log2_max_tb_s
    ep.c_min_qt, ep.c_max_bt, ep.c_max_tt = pc.log2_min_qt_s, pc.log2_max_bt_s, pc.log2_max_tt_s
    ep.c_mtt_depth, ep.c_min_cb, ep.c_max_tb = pc.max_mtt_depth, pc.log2_min_cb_s, pc.log2_max_tb_s
    ep.chroma_enabled = int(sps.sps_chroma_format_idc != 0)
    ep.cclm = g(sps, "sps_cclm_enabled_flag")
    ep.cclm_colloc = g(sps, "sps_chroma_vertical_collocated_flag")
    ep.mip = g(sps, "sps_mip_enabled_flag")
    ep.mrl = g(sps, "sps_mrl_enabled_flag")
    ep.amvr = g(sps, "sps_amvr_enabled_flag")
    ep.dep_quant = g(sh, "sh_dep_quant_used_flag")
    ep.sign_hiding = g(sh, "sh_sign_data_hiding_used_flag")
    ep.sao_luma = g(sh, "sh_sao_luma_used_flag")
    ep.sao_chroma = g(sh, "sh_sao_chroma_used_flag")
    ep.alf_luma = g(sh, "sh_alf_enabled_flag")
    ep.alf_cb = g(sh, "sh_alf_cb_enabled_flag")
    ep.alf_cr = g(sh, "sh_alf_cr_enabled_flag")
    ep.num_alf_aps_luma = g(sh, "sh_num_alf_aps_ids_luma")
    ep.alf_chroma_num_alts = 1
    _aps_c = getattr(params, "alf_aps_chroma", None)
    if _aps_c is not None:
        ep.alf_chroma_num_alts = \
            _aps_c.alf_data.alf_chroma_num_alt_filters_minus1 + 1
    ep.cc_cb_enabled = g(sh, "sh_alf_cc_cb_enabled_flag")
    ep.cc_cr_enabled = g(sh, "sh_alf_cc_cr_enabled_flag")
    _cc = getattr(params, "alf_aps_cc", (None, None))
    ep.cc_nb_cb = (_cc[0].alf_data.alf_cc_cb_filters_signalled_minus1 + 1
                   if _cc[0] is not None else 0)
    ep.cc_nb_cr = (_cc[1].alf_data.alf_cc_cr_filters_signalled_minus1 + 1
                   if _cc[1] is not None else 0)
    ep.joint_cbcr = g(sps, "sps_joint_cbcr_enabled_flag")
    ep.lfnst = g(sps, "sps_lfnst_enabled_flag")
    ep.mts = g(sps, "sps_mts_enabled_flag")
    ep.mts_implicit = int(ep.mts and not g(sps, "sps_explicit_mts_intra_enabled_flag"))
    ep.expl_mts_intra = g(sps, "sps_explicit_mts_intra_enabled_flag")
    ep.expl_mts_inter = g(sps, "sps_explicit_mts_inter_enabled_flag")
    ep.cu_qp_delta_enabled = g(pps, "pps_cu_qp_delta_enabled_flag")
    ep.cu_qp_delta_subdiv = (g(ph, "ph_cu_qp_delta_subdiv_intra_slice")
                             if params.slice_type == SLICE_I else
                             g(ph, "ph_cu_qp_delta_subdiv_inter_slice"))
    ep.max_num_merge_cand = 6 - g(sps, "sps_six_minus_max_num_merge_cand")
    nra = getattr(sh, "_num_ref_idx_active", [1, 0])
    ep.nb_active_ref0 = nra[0]
    ep.nb_active_ref1 = nra[1] if params.slice_type == 0 else 0
    ep.mvd1_zero = g(ph, "ph_mvd_l1_zero_flag")
    ep.mmvd_enabled = g(sps, "sps_mmvd_enabled_flag")
    ep.mmvd_shift = g(ph, "ph_mmvd_fullpel_only_flag") << 1
    ep.bcw_enabled = g(sps, "sps_bcw_enabled_flag")
    ep.ciip_enabled = g(sps, "sps_ciip_enabled_flag")
    ep.gpm_enabled = g(sps, "sps_gpm_enabled_flag")
    mmc = 6 - g(sps, "sps_six_minus_max_num_merge_cand")
    if ep.gpm_enabled and mmc >= 3:
        ep.max_gpm_cand = mmc - g(
            sps, "sps_max_num_merge_cand_minus_max_num_gpm_cand")
    elif ep.gpm_enabled and mmc == 2:
        ep.max_gpm_cand = 2
    else:
        ep.max_gpm_cand = 0
    # affine / SbTMVP (vcl/ctu.py :320-353)
    ep.affine_enabled = g(sps, "sps_affine_enabled_flag")
    ep.sbtmvp_on = int(bool(g(sps, "sps_sbtmvp_enabled_flag"))
                       and bool(g(ph, "ph_temporal_mvp_enabled_flag")))
    ep.affine_6param = g(sps, "sps_6param_affine_enabled_flag")
    ep.affine_prof = int(bool(g(sps, "sps_affine_prof_enabled_flag"))
                         and not g(ph, "ph_prof_disabled_flag"))
    ep.affine_amvr = g(sps, "sps_affine_amvr_enabled_flag")
    ep.affine_nb_merge_cand = 5 - g(
        sps, "sps_five_minus_max_num_subblock_merge_cand")
    ep.col_ref_idx0 = -1
    ep.col_ref_idx1 = -1
    ep.nb_ctb_pic_w = (pps.pic_w + (1 << log2_ctb) - 1) >> log2_ctb
    ep.bdof_on = int(bool(g(sps, "sps_bdof_enabled_flag"))
                     and not g(ph, "ph_bdof_disabled_flag"))
    ep.dmvr_on = int(bool(g(sps, "sps_dmvr_enabled_flag"))
                     and not g(ph, "ph_dmvr_disabled_flag"))
    ep.ts_enabled = g(sps, "sps_transform_skip_enabled_flag")
    ep.log2_ts_max = g(sps, "sps_log2_transform_skip_max_size_minus2") + 2
    ep.min_qp_prime_ts = g(sps, "sps_min_qp_prime_ts")
    ep.bdpcm_enabled = g(sps, "sps_bdpcm_enabled_flag")
    ep.ldc = 1  # InterCtx.ldc default; refined below when TMVP is on
    ep.smvd_enabled = 0
    ep.ref_smvd_idx0 = -1
    ep.ref_smvd_idx1 = -1
    for i in range(16):
        ep.rpl0_opp[i] = 0xFF
        ep.rpl1_opp[i] = 0xFF
    col_planes = None
    if params.slice_type != SLICE_I:
        from openvvc_tpu.vcl.ctu import _signed_rpl_deltas

        hr0, hr1 = sh.resolved_rpls(pps, ph)
        cur_poc = getattr(params, "_cur_poc", ph.ph_pic_order_cnt_lsb)
        d0 = _signed_rpl_deltas(hr0.rpl, nra[0], cur_poc)
        d1 = _signed_rpl_deltas(hr1.rpl, nra[1] if params.slice_type == 0
                                else 0, cur_poc)
        if params.slice_type == 0:
            for i, d in enumerate(d0):
                ep.rpl0_opp[i] = d1.index(d) if d in d1 else 0xFF
            for i, d in enumerate(d1):
                ep.rpl1_opp[i] = d0.index(d) if d in d0 else 0xFF
        # ref distances (InterCtx.dist_ref0/1, ctu.py :275-276): needed by
        # MMVD offset scaling and TMVP regardless of the collocated field
        for i, dd in enumerate(d0[:16]):
            ep.dist_ref0[i] = -dd
        for i, dd in enumerate(d1[:16]):
            ep.dist_ref1[i] = -dd
        # SbTMVP collocated ref pair (vcl/ctu.py :337-352)
        if ep.sbtmvp_on:
            from_l0 = bool(g(sh, "sh_collocated_from_l0_flag")
                           or params.slice_type == 1)
            cidx = g(sh, "sh_collocated_ref_idx")
            if from_l0:
                ep.col_ref_idx0 = cidx
                dcol = d0[cidx] if cidx < len(d0) else None
                ep.col_ref_idx1 = max(
                    (i for i, d in enumerate(d1) if d == dcol), default=-1)
            else:
                ep.col_ref_idx1 = cidx
                dcol = d1[cidx] if cidx < len(d1) else None
                ep.col_ref_idx0 = max(
                    (i for i, d in enumerate(d0) if d == dcol), default=-1)
        # ldc + SMVD ref pair (vcl/ctu.py :279-286, slicedec_smvd_params)
        ldc_all = not any(d > 0 for d in d0 + d1)
        if g(ph, "ph_temporal_mvp_enabled_flag"):
            ep.ldc = int(ldc_all)
        if (params.slice_type == 0 and g(sps, "sps_smvd_enabled_flag")
                and not ldc_all and not ep.mvd1_zero):
            fw = [(d, i) for i, d in enumerate(d0) if d < 0]
            bw = [(d, i) for i, d in enumerate(d1) if d > 0]
            if fw and bw:
                ep.ref_smvd_idx0 = max(fw)[1]
                ep.ref_smvd_idx1 = min(bw)[1]
                ep.smvd_enabled = 1
        # TMVP collocated field (ctu.py CTUParseCtx set_tmvp parity)
        col_obj = getattr(params, "_tmvp_col_obj", None)
        if (g(ph, "ph_temporal_mvp_enabled_flag") and col_obj is not None
                and hasattr(col_obj, "resolve_dense")):
            colv = (None, None, None, None) + col_obj.sd
            dense = col_obj.resolve_dense()
            ep.tmvp_enabled = 1
            ep.tmvp_ldc = int(not any(dd > 0 for dd in d0 + d1))
            ep.col_ref_l0 = int(bool(
                g(ph, "ph_collocated_from_l0_flag")
                or g(sh, "sh_collocated_from_l0_flag")
                or params.slice_type == 1))
            ep.col_uh, ep.col_uw = dense[0].shape
            ep.col_uh8, ep.col_uw8 = dense[2].shape[:2]
            for i, dd in enumerate(d0[:16]):
                ep.dist_ref0[i] = -dd
            for i, dd in enumerate(d1[:16]):
                ep.dist_ref1[i] = -dd
            for i, dd in enumerate((colv[4] or [])[:16]):
                ep.dist_col0[i] = dd
            for i, dd in enumerate((colv[5] or [])[:16]):
                ep.dist_col1[i] = dd
            col_planes = dense
        elif g(ph, "ph_temporal_mvp_enabled_flag") and col_obj is None \
                and getattr(params, "_tmvp_col", None) is not None:
            return None  # non-lazy collocated form: Python path only
    qp_bd = params.qp_bd_offset
    ep.cqp_tab_len = 64 + qp_bd
    ep.cb_qp_off = g(pps, "pps_cb_qp_offset") + g(sh, "sh_cb_qp_offset")
    ep.cr_qp_off = g(pps, "pps_cr_qp_offset") + g(sh, "sh_cr_qp_offset")
    ep.jcbcr_qp_off = (g(pps, "pps_joint_cbcr_qp_offset_value")
                       + g(sh, "sh_joint_cbcr_qp_offset"))

    cqp = np.zeros((3, ep.cqp_tab_len), np.int8)
    for i, tab in enumerate(params.chroma_qp_tables):
        t = np.asarray(tab, np.int32)[:ep.cqp_tab_len]
        cqp[i, :len(t)] = t.astype(np.int8)

    s0, s1, r0, r1 = init_context_states(params.slice_type, params.slice_qp)
    n = len(s0)
    a_s0 = (ctypes.c_uint16 * n)(*s0)
    a_s1 = (ctypes.c_uint16 * n)(*s1)
    a_r0 = (ctypes.c_uint8 * n)(*r0)
    a_r1 = (ctypes.c_uint8 * n)(*r1)

    uw, uh = (ep.tile_w + 3) >> 2, (ep.tile_h + 3) >> 2
    uw8, uh8 = (uw + 1) >> 1, (uh + 1) >> 1
    max_cu = uw * uh + 256
    max_tu = 3 * max_cu
    # 2x the 4:2:0 sample count: a fully-coded tile (every TB carrying
    # residual) sits exactly at 1.5x, leaving real headroom before the
    # overflow bail (-6). Known issue: some dense RA full-inter entries
    # with 2 active refs desync the C reader and trip this bail — the
    # Python parser takes over and output stays bit-exact
    # (fallback reason "native_parse:parse_bail" in Decoder.stats).
    max_coef = ep.tile_w * ep.tile_h * 2 + 65536
    nb_ctu = entry.nb_ctu_w * entry.nb_ctu_h
    # pooled working buffers (~26 MB/entry at 1080p): fresh-page faults
    # cost far more than the parse itself; RawNativeEntry.release()
    # returns them once reconstruction consumed them
    from openvvc_tpu.utils.pool import GLOBAL as _pool
    cu_buf = _pool.take(max_cu * _CU_NFIELDS, np.int32)
    tu_buf = _pool.take(max_tu * _TU_NFIELDS, np.int32)
    coef_buf = _pool.take(max_coef, np.int32)
    sao_buf = _pool.take_zeroed(nb_ctu * _CTU_NFIELDS, np.int32)
    ctu_meta = _pool.take_zeroed(nb_ctu * 3, np.int32)
    # TMVP exports escape into the DPB (collocated field of later
    # pictures) — never pooled
    tmvp_dir0 = np.zeros(uh * uw, np.uint8)
    tmvp_mv0 = np.zeros(uh8 * uw8 * 3, np.int32)
    tmvp_dir1 = np.zeros(uh * uw, np.uint8)
    tmvp_mv1 = np.zeros(uh8 * uw8 * 3, np.int32)
    sub_mv = None
    if ep.affine_enabled or ep.sbtmvp_on:
        # per-4x4-unit MV export for affine/SbTMVP reconstruction
        sub_mv = np.zeros(uh * uw * 4, np.int32)
    counts = (ctypes.c_int64 * 4)()

    vp = ctypes.c_void_p
    rc = lib.ov_parse_entry(
        entry.data, len(entry.data), ctypes.byref(ep),
        a_s0, a_s1, a_r0, a_r1,
        vp(cqp.ctypes.data),
        vp(cu_buf.ctypes.data), max_cu,
        vp(tu_buf.ctypes.data), max_tu,
        vp(coef_buf.ctypes.data), max_coef,
        vp(sao_buf.ctypes.data), vp(ctu_meta.ctypes.data),
        vp(tmvp_dir0.ctypes.data), vp(tmvp_mv0.ctypes.data),
        vp(tmvp_dir1.ctypes.data), vp(tmvp_mv1.ctypes.data),
        vp(col_planes[0].ctypes.data if col_planes else None),
        vp(col_planes[1].ctypes.data if col_planes else None),
        vp(col_planes[2].ctypes.data if col_planes else None),
        vp(col_planes[3].ctypes.data if col_planes else None),
        vp(sub_mv.ctypes.data if sub_mv is not None else None),
        counts)
    if rc != 0:
        # ERR_UNSUPPORTED (-1): expected mid-parse bail (SCIPU, 4x4 inter).
        # Other codes (overflow / stream): fall back to the Python parser
        # too — it re-parses from scratch and raises precise errors.
        if rc != -1 and os.environ.get("OPENVVC_NATIVE_STRICT"):
            dump = os.environ.get("OPENVVC_NATIVE_DUMP")
            if dump:
                import pickle
                with open(dump, "wb") as f:
                    pickle.dump({
                        "data": bytes(entry.data),
                        "ep": {fld[0]: getattr(ep, fld[0])
                               for fld in _EntryParamsC._fields_},
                        "s0": list(s0), "s1": list(s1),
                        "r0": list(r0), "r1": list(r1),
                        "cqp": cqp.copy(),
                        "max_cu": max_cu, "max_tu": max_tu,
                        "max_coef": max_coef, "nb_ctu": nb_ctu,
                        "uw": uw, "uh": uh,
                    }, f)
            raise ValueError(f"native parse failed: rc={rc} "
                             f"counts={list(counts)}")
        return None

    raw = RawNativeEntry()
    raw.params, raw.entry, raw.ep = params, entry, ep
    raw.cu_buf, raw.tu_buf, raw.coef_buf = cu_buf, tu_buf, coef_buf
    raw.sao_buf, raw.ctu_meta = sao_buf, ctu_meta
    raw.tmvp_dir0, raw.tmvp_mv0 = tmvp_dir0, tmvp_mv0
    raw.tmvp_dir1, raw.tmvp_mv1 = tmvp_dir1, tmvp_mv1
    raw.sub_mv = sub_mv
    raw.counts = counts
    raw.uw, raw.uh, raw.uw8, raw.uh8 = uw, uh, uw8, uh8
    raw.cqp = cqp
    return raw


def parse_entry_native(params, entry):
    """Native full-entry parse; returns (ectx, None, dec-like) or None."""
    raw = parse_entry_native_raw(params, entry)
    if raw is None:
        return None
    return _convert_native_entry(params, entry, raw)


def _convert_native_entry(params, entry, raw):
    from openvvc_tpu.vcl.ctu import CU, TU, CtuIR
    from openvvc_tpu.vcl.sao import SaoParams
    from openvvc_tpu.drv.inter_mvp import MV

    ep = raw.ep
    cu_buf, tu_buf, coef_buf = raw.cu_buf, raw.tu_buf, raw.coef_buf
    sao_buf, ctu_meta = raw.sao_buf, raw.ctu_meta
    counts = raw.counts
    uw, uh, uw8, uh8 = raw.uw, raw.uh, raw.uw8, raw.uh8

    ncu, ntu, ncoef, nctu = (int(counts[i]) for i in range(4))
    cu_t = cu_buf[:ncu * _CU_NFIELDS].reshape(ncu, _CU_NFIELDS).tolist()
    tu_t = tu_buf[:ntu * _TU_NFIELDS].reshape(ntu, _TU_NFIELDS).tolist()
    meta = ctu_meta[:nctu * 3].reshape(nctu, 3).tolist()

    # default-field templates: skipping the dataclass __init__ (50 defaulted
    # fields per CU) cuts conversion time ~3x at 60k CUs/frame
    tu_tmpl = TU(0, 0, 2, 2, 0).__dict__
    cu_tmpl = CU(0, 0, 2, 2).__dict__.copy()
    del cu_tmpl["tus"]
    tu_new, cu_new, mv_new = TU.__new__, CU.__new__, MV.__new__

    # TU objects (coeffs are views into coef_buf, no copies)
    tus = []
    tus_append = tus.append
    for r in tu_t:
        (comp, x0, y0, l2w, l2h, cbf, jcbcr, lfnst, mts, ts, qp, bdpcm,
         lastx, lasty, siglo, sighi, coef) = r
        t = tu_new(TU)
        t.__dict__ = tu_tmpl | {
            "comp": comp, "x0": x0, "y0": y0, "log2_w": l2w, "log2_h": l2h,
            "cbf": 1, "joint_cbcr": jcbcr, "lfnst_idx": lfnst, "mts_idx": mts,
            "transform_skip": ts, "bdpcm": bdpcm, "bdpcm_dir": bdpcm >> 1,
            "qp": qp, "last_pos": (lastx, lasty),
            "sig_sb_map": ((sighi & 0xFFFFFFFF) << 32) | (siglo & 0xFFFFFFFF),
            "coeffs": coef_buf[coef:coef + (1 << (l2w + l2h))]
                .reshape(1 << l2h, 1 << l2w),
        }
        tus_append(t)

    ctus = [CtuIR(m[0], m[1]) for m in meta]
    cu_lists = [c.cus for c in ctus]
    F = _CuF
    for r in cu_t:
        cu = cu_new(CU)
        d = cu_tmpl | {
            "x0": r[F.X0], "y0": r[F.Y0],
            "log2_w": r[F.LOG2W], "log2_h": r[F.LOG2H],
            "pred_mode": r[F.PRED], "intra_mode_l": r[F.INTRA_L],
            "intra_mode_c": r[F.INTRA_C], "mrl_idx": r[F.MRL],
            "lfnst_idx": r[F.LFNST], "skip_flag": r[F.SKIP],
            "merge_flag": r[F.MERGE_FLAG], "merge_idx": r[F.MERGE_IDX],
            "inter_dir": r[F.INTER_DIR], "qp": r[F.QP],
            "root_cbf": r[F.ROOT_CBF], "prec_amvr_eff": r[F.PREC_EFF],
            "tus": tus[r[F.TU0]:r[F.TU0] + r[F.NTU]],
        }
        if r[F.MIP_FLAG]:
            d["mip_flag"] = 1
            d["mip_transpose"] = r[F.MIP_T]
            d["mip_mode"] = r[F.MIP_MODE]
        if r[F.BDPCM]:
            b = r[F.BDPCM]
            d["bdpcm_l"] = b & 1
            d["bdpcm_dir_l"] = (b >> 1) & 1
            d["bdpcm_c"] = (b >> 2) & 1
            d["bdpcm_dir_c"] = (b >> 3) & 1
        if r[F.MV0REF] >= 0:
            mv = mv_new(MV)
            mv.__dict__ = {"x": r[F.MV0X], "y": r[F.MV0Y],
                           "ref_idx": r[F.MV0REF],
                           "bcw_idx_plus1": r[F.MV0BCW],
                           "prec_amvr": r[F.MV0PREC]}
            d["mv0"] = mv
        if r[F.MV1REF] >= 0:
            mv = mv_new(MV)
            mv.__dict__ = {"x": r[F.MV1X], "y": r[F.MV1Y],
                           "ref_idx": r[F.MV1REF],
                           "bcw_idx_plus1": r[F.MV0BCW],
                           "prec_amvr": r[F.MV0PREC]}
            d["mv1"] = mv
        if r[F.COL_MODE] >= 0:
            d["col_luma_mode"] = r[F.COL_MODE]
        if r[F.SMVD]:
            d["smvd_flag"] = 1
        if r[F.MMVD]:
            d["mmvd_flag"] = 1
        if r[F.CIIP_WT]:
            d["ciip_flag"] = 1
            d["ciip_wt"] = r[F.CIIP_WT]
        if r[F.SB_FLAG]:
            # affine / SbTMVP: rebuild the recon payload from the exported
            # per-unit motion maps + the CU record's PROF deltas
            from openvvc_tpu.drv.affine import DeltaMV

            flag = r[F.SB_FLAG]
            uw_, uh_ = raw.uw, raw.uh
            sm = raw.sub_mv.reshape(uh_, uw_, 2, 2)
            ux0 = (r[F.X0] - ep.tile_x0) >> 2
            uy0 = (r[F.Y0] - ep.tile_y0) >> 2
            nw_ = max(1, (1 << r[F.LOG2W]) >> 2)
            nh_ = max(1, (1 << r[F.LOG2H]) >> 2)
            d["mv0"] = None
            d["mv1"] = None
            d["inter_dir"] = 1  # payload carries the real dirs
            if flag == 1:
                idir = r[F.INTER_DIR]
                bcw = r[F.MV0BCW]

                def subs(lst, ref):
                    return [[MV(int(sm[uy0 + i, ux0 + j, lst, 0]),
                                int(sm[uy0 + i, ux0 + j, lst, 1]),
                                ref, bcw, 0)
                             for j in range(nw_)] for i in range(nh_)]

                sub0 = subs(0, r[F.MV0REF]) if idir & 1 else None
                sub1 = subs(1, r[F.MV1REF]) if idir & 2 else None
                dmv0 = DeltaMV(MV(r[F.DMV0HX], r[F.DMV0HY]),
                               MV(r[F.DMV0VX], r[F.DMV0VY]))
                dmv1 = DeltaMV(MV(r[F.DMV1HX], r[F.DMV1HY]),
                               MV(r[F.DMV1VX], r[F.DMV1VY]))
                d["sb_info"] = ("affine", sub0, sub1, idir,
                                r[F.PROF_DIR], dmv0, dmv1)
                d["affine_flag"] = 1
                d["sb_merge_flag"] = 1 if r[F.MERGE_FLAG] else 0
            else:
                d["sb_merge_flag"] = 1
                units = []
                if flag == 3:
                    idir = r[F.INTER_DIR]
                    z = MV(0, 0, 0, 0, 0)
                    units.append((0, 0, idir, z,
                                  z if idir & 2 else None,
                                  r[F.LOG2W], r[F.LOG2H]))
                else:
                    d0m = raw.tmvp_dir0.reshape(uh_, uw_)
                    d1m = raw.tmvp_dir1.reshape(uh_, uw_)
                    for gy in range(0, 1 << r[F.LOG2H], 8):
                        for gx in range(0, 1 << r[F.LOG2W], 8):
                            ui = uy0 + (gy >> 2)
                            uj = ux0 + (gx >> 2)
                            idir = ((1 if d0m[ui, uj] else 0)
                                    | (2 if d1m[ui, uj] else 0))
                            m0 = MV(int(sm[ui, uj, 0, 0]),
                                    int(sm[ui, uj, 0, 1]), 0, 0, 0)
                            m1 = MV(int(sm[ui, uj, 1, 0]),
                                    int(sm[ui, uj, 1, 1]), 0, 0, 0) \
                                if idir & 2 else None
                            units.append((gx, gy, idir, m0, m1, 3, 3))
                d["sb_info"] = ("sbtmvp", units)
        if r[F.GPM_DIRS]:
            from openvvc_tpu.drv.gpm import gpm_units_from_parts

            gd0 = 1 + ((r[F.GPM_DIRS] - 1) & 1)
            gd1 = 1 + ((r[F.GPM_DIRS] - 1) >> 1)
            gm0 = d["mv0"]
            gm1 = mv_new(MV)
            gm1.__dict__ = {"x": r[F.MV1X], "y": r[F.MV1Y],
                            "ref_idx": r[F.MV1REF], "bcw_idx_plus1": 0,
                            "prec_amvr": 0}
            d["mv1"] = gm1
            d["gpm_flag"] = 1
            d["gpm_split_dir"] = r[F.GPM_SPLIT]
            d["gpm_dirs"] = (gd0, gd1)
            d["gpm_mvs"] = (gm0, gm1)
            d["inter_dir"] = 0
            d["gpm_units"] = gpm_units_from_parts(
                r[F.GPM_SPLIT], max(1, (1 << r[F.LOG2W]) >> 2),
                max(1, (1 << r[F.LOG2H]) >> 2), gd0, gm0, gd1, gm1)
        cu.__dict__ = d
        cu_lists[r[F.CTU]].append(cu)

    sao_params = {}
    if ep.sao_luma or ep.sao_chroma:
        sao_t = sao_buf[:nctu * _CTU_NFIELDS] \
            .reshape(nctu, _CTU_NFIELDS)[:, :_SAO_NFIELDS]
        for i, m in enumerate(meta):
            rec = sao_t[i]
            sp = SaoParams()
            sp.type_idx = rec[0:3].tolist()
            sp.offset_val = rec[3:18].reshape(3, 5).tolist()
            sp.band_position = rec[18:21].tolist()
            sp.eo_class = rec[21:24].tolist()
            sao_params[(m[0], m[1])] = sp

    inter_ctx = None
    if params.slice_type != 2:
        inter_ctx = _NativeInterCtx(
            uw, uh, raw.tmvp_dir0.reshape(uh, uw),
            raw.tmvp_mv0.reshape(uh8, uw8, 3), uw8, uh8,
            raw.tmvp_dir1.reshape(uh, uw),
            raw.tmvp_mv1.reshape(uh8, uw8, 3))

    ectx = NativeEntryCtx(entry, ctus, sao_params, inter_ctx,
                          ep.tile_x0, ep.tile_y0)
    ectx.alf_params = _alf_params_from_raw(ep, sao_buf, meta, nctu)
    return ectx, None, _NoOverread()


def _alf_params_from_raw(ep, sao_buf, meta, nctu):
    """Per-CTU AlfCtuParams dict from the parse records (rec[24:30])."""
    if not (ep.alf_luma or ep.alf_cb or ep.alf_cr
            or ep.cc_cb_enabled or ep.cc_cr_enabled):
        return {}
    from openvvc_tpu.vcl.alf import AlfCtuParams

    alf_t = sao_buf[:nctu * _CTU_NFIELDS].reshape(nctu, _CTU_NFIELDS)
    out = {}
    for i in range(nctu):
        r = alf_t[i, _SAO_NFIELDS:]
        if not r.any():
            continue
        m = meta[i]
        out[(int(m[0]), int(m[1]))] = AlfCtuParams(
            ctb_alf_flag=int(r[0]), ctb_alf_idx=int(r[1]),
            cb_alternative=int(r[2]), cr_alternative=int(r[3]),
            cc_alf_idx=(int(r[4]), int(r[5])))
    return out


class _CuF:
    (X0, Y0, LOG2W, LOG2H, TREE, PRED, INTRA_L, INTRA_C, MIP_FLAG, MIP_T,
     MIP_MODE, MRL, LFNST, SKIP, MERGE_FLAG, MERGE_IDX, INTER_DIR, MV0X,
     MV0Y, MV0REF, MV0BCW, MV0PREC, MV1X, MV1Y, MV1REF, QP, ROOT_CBF,
     PREC_EFF, TU0, NTU, CTU, COL_MODE, CIIP_WT, GPM_DIRS,
     GPM_SPLIT, SB_FLAG, PROF_DIR, DMV0HX, DMV0HY, DMV0VX, DMV0VY,
     DMV1HX, DMV1HY, DMV1VX, DMV1VY, SMVD, MMVD, BDPCM) = range(48)


# ---------------------------------------------------------------------------
# Native reconstruction (recon.c): consumes a RawNativeEntry directly and
# writes the frame planes + DBF maps, bypassing Python CU/TU objects.
# ---------------------------------------------------------------------------


class _ReconParamsC(ctypes.Structure):
    _fields_ = [("dbf_enabled", ctypes.c_int32),
                ("csign", ctypes.c_int32),
                ("nb_refs", ctypes.c_int32),
                ("nb_refs1", ctypes.c_int32),
                ("poc0", ctypes.c_int32 * 16),
                ("poc1", ctypes.c_int32 * 16)]


_DBF_PTR_NAMES = (
    "edge_ver", "edge_hor", "bs2_ver", "bs2_hor", "bs1_ver", "bs1_hor",
    "cu_edge_ver", "cu_edge_hor", "qp_l", "mv_dir", "mv_vals", "mv_dist",
    "cedge_ver", "cedge_hor", "cbs2_ver", "cbs2_hor",
    "cbs1_cb_ver", "cbs1_cb_hor", "cbs1_cr_ver", "cbs1_cr_hor",
    "qp_cb", "qp_cr", "sb_edge_ver", "sb_edge_hor", "aff_unit",
)


class _DbfBufsC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _DBF_PTR_NAMES]


_recon_proto_done = False


def _setup_recon_proto(lib):
    global _recon_proto_done
    if _recon_proto_done:
        return
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    lib.ov_recon_entry.restype = i64
    lib.ov_recon_entry.argtypes = [
        ctypes.POINTER(_EntryParamsC), ctypes.POINTER(_ReconParamsC),
        vp, i64,          # cu_buf, ncu
        vp, i64,          # tu_buf, ntu
        vp,               # coef_buf
        vp,               # cqp_tab
        vp, vp, vp,       # frame planes
        ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),  # refs0
        ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),  # refs1
        vp, vp,           # dist0, dist1
        vp, vp, vp,       # sub_dir0, sub_dir1, sub_mv (nullable)
        vp, vp,           # tmvp_mv0, tmvp_mv1 (DMVR field override)
        ctypes.POINTER(_DbfBufsC),
    ]
    _recon_proto_done = True


def recon_entry_native(raw, frame, refs0, dist0, dbf, csign,
                       refs1=None, dist1=None) -> bool:
    """Reconstruct a natively-parsed entry in C. Returns True on success;
    False means an unsupported feature — caller must fall back to the
    Python reconstruction path (outputs are untouched in that case)."""
    lib = load_cabac_lib()
    if lib is None:
        return False
    _setup_recon_proto(lib)

    rp = _ReconParamsC()
    rp.dbf_enabled = int(dbf is not None)
    rp.csign = csign
    rp.nb_refs = len(refs0) if refs0 else 0
    rp.nb_refs1 = len(refs1) if refs1 else 0

    vp = ctypes.c_void_p

    def _ref_arrays(rl):
        nref = max(1, len(rl) if rl else 0)
        ry = (vp * nref)()
        rcb = (vp * nref)()
        rcr = (vp * nref)()
        for i, f in enumerate(rl or []):
            ry[i] = f.y.ctypes.data
            rcb[i] = f.cb.ctypes.data if f.cb is not None else None
            rcr[i] = f.cr.ctypes.data if f.cr is not None else None
        return ry, rcb, rcr

    ry, rcb, rcr = _ref_arrays(refs0)
    r1y, r1cb, r1cr = _ref_arrays(refs1)
    for i, f in enumerate(refs0 or []):
        rp.poc0[i] = int(f.poc)
    for i, f in enumerate(refs1 or []):
        rp.poc1[i] = int(f.poc)
    d0 = np.zeros(16, np.int32)
    if dist0:
        d0[:len(dist0)] = dist0
    d1 = np.zeros(16, np.int32)
    if dist1:
        d1[:len(dist1)] = dist1

    db = _DbfBufsC()
    if dbf is not None:
        for name in _DBF_PTR_NAMES:
            arr = getattr(dbf, name, None)
            setattr(db, name, arr.ctypes.data if arr is not None else None)

    ncu, ntu = int(raw.counts[0]), int(raw.counts[1])
    rc = lib.ov_recon_entry(
        ctypes.byref(raw.ep), ctypes.byref(rp),
        vp(raw.cu_buf.ctypes.data), ncu,
        vp(raw.tu_buf.ctypes.data), ntu,
        vp(raw.coef_buf.ctypes.data),
        vp(raw.cqp.ctypes.data),
        vp(frame.y.ctypes.data),
        vp(frame.cb.ctypes.data if frame.cb is not None else None),
        vp(frame.cr.ctypes.data if frame.cr is not None else None),
        ry, rcb, rcr, r1y, r1cb, r1cr,
        vp(d0.ctypes.data), vp(d1.ctypes.data),
        vp(raw.tmvp_dir0.ctypes.data), vp(raw.tmvp_dir1.ctypes.data),
        vp(raw.sub_mv.ctypes.data if raw.sub_mv is not None else None),
        vp(raw.tmvp_mv0.ctypes.data), vp(raw.tmvp_mv1.ctypes.data),
        ctypes.byref(db))
    return rc == 0


class _DbfFrameParamsC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "pic_w", "pic_h", "bitdepth", "chroma_enabled", "log2_ctb",
        "beta_off_l", "tc_off_l", "beta_off_cb", "tc_off_cb",
        "beta_off_cr", "tc_off_cr", "nb_no_x", "nb_no_y",
        "finalize_inter_bs",
    )]


_dbf_proto_done = False


def _setup_dbf_proto(lib):
    global _dbf_proto_done
    if _dbf_proto_done:
        return
    vp = ctypes.c_void_p
    lib.ov_dbf_frame_part.restype = ctypes.c_int64
    lib.ov_dbf_frame_part.argtypes = [
        ctypes.POINTER(_DbfFrameParamsC), ctypes.POINTER(_DbfBufsC),
        vp, vp, vp,  # planes
        vp, vp,      # no_filter_x / no_filter_y
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # part, lo, hi
    ]
    _dbf_proto_done = True


def dbf_frame_native(frame, dbf, offsets, log2_ctb, no_x=(), no_y=(),
                     finalize=True, part=0, lo=0, hi=0) -> bool:
    """Whole-frame deblocking in C (ref_dbf.py deblock_frame +
    finalize_inter_bs parity). offsets = (beta_l, tc_l, beta_cb, tc_cb,
    beta_cr, tc_cr). Returns False if the native lib is unavailable."""
    lib = load_cabac_lib()
    if lib is None:
        return False
    _setup_dbf_proto(lib)

    fp = _DbfFrameParamsC()
    fp.pic_w, fp.pic_h = frame.y.shape[1], frame.y.shape[0]
    fp.bitdepth = frame.bitdepth
    fp.chroma_enabled = int(frame.cb is not None)
    fp.log2_ctb = log2_ctb
    (fp.beta_off_l, fp.tc_off_l, fp.beta_off_cb, fp.tc_off_cb,
     fp.beta_off_cr, fp.tc_off_cr) = offsets
    nx = np.asarray(list(no_x), np.int32)
    ny = np.asarray(list(no_y), np.int32)
    fp.nb_no_x, fp.nb_no_y = len(nx), len(ny)
    fp.finalize_inter_bs = int(finalize)

    db = _DbfBufsC()
    for name in _DBF_PTR_NAMES:
        arr = getattr(dbf, name, None)
        setattr(db, name, arr.ctypes.data if arr is not None else None)

    vp = ctypes.c_void_p
    rc = lib.ov_dbf_frame_part(
        ctypes.byref(fp), ctypes.byref(db),
        vp(frame.y.ctypes.data),
        vp(frame.cb.ctypes.data if frame.cb is not None else None),
        vp(frame.cr.ctypes.data if frame.cr is not None else None),
        vp(nx.ctypes.data if len(nx) else None),
        vp(ny.ctypes.data if len(ny) else None), part, lo, hi)
    return rc == 0


class _SaoEntryParamsC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "pic_w", "pic_h", "bitdepth", "chroma_enabled", "ctb_log2",
        "ex0", "ey0", "nw", "nh",
    )]


_sao_proto_done = False


def _setup_sao_proto(lib):
    global _sao_proto_done
    if _sao_proto_done:
        return
    vp = ctypes.c_void_p
    lib.ov_sao_entry.restype = ctypes.c_int64
    lib.ov_sao_entry.argtypes = [
        ctypes.POINTER(_SaoEntryParamsC), vp, ctypes.c_int64, vp, vp, vp,
    ]
    _sao_proto_done = True


def sao_recs_from_params(sao_params):
    """Flatten a {(cx,cy): SaoParams} dict into the C record array."""
    recs = np.zeros((len(sao_params), 26), np.int32)
    for i, ((cx, cy), sp) in enumerate(sao_params.items()):
        r = recs[i]
        r[0], r[1] = cx, cy
        r[2:5] = sp.type_idx
        r[5:20] = np.asarray(sp.offset_val, np.int32).reshape(15)
        r[20:23] = sp.band_position
        r[23:26] = sp.eo_class
    return recs


def sao_apply_native(frame, entry_bounds, ctb_log2, recs) -> bool:
    """Apply SAO for one entry in C (ref_sao.py apply_sao_entry parity).
    recs: (n, 26) int32 [cx, cy, type[3], val[3][5], band_pos[3], eo[3]].
    Returns False if the native lib is unavailable."""
    lib = load_cabac_lib()
    if lib is None:
        return False
    _setup_sao_proto(lib)
    sp = _SaoEntryParamsC()
    sp.pic_w, sp.pic_h = frame.y.shape[1], frame.y.shape[0]
    sp.bitdepth = frame.bitdepth
    sp.chroma_enabled = int(frame.cb is not None)
    sp.ctb_log2 = ctb_log2
    sp.ex0, sp.ey0, sp.nw, sp.nh = entry_bounds
    recs = np.ascontiguousarray(recs, np.int32)
    vp = ctypes.c_void_p
    rc = lib.ov_sao_entry(
        ctypes.byref(sp), vp(recs.ctypes.data), len(recs),
        vp(frame.y.ctypes.data),
        vp(frame.cb.ctypes.data if frame.cb is not None else None),
        vp(frame.cr.ctypes.data if frame.cr is not None else None))
    return rc == 0


def native_entry_ctx_from_raw(raw):
    """Build the minimal entry context (SAO params + TMVP export) for an
    entry whose CUs were reconstructed natively — no CU/TU objects."""
    params, entry, ep = raw.params, raw.entry, raw.ep
    nctu = int(raw.counts[3])
    meta = raw.ctu_meta[:nctu * 3].reshape(nctu, 3)

    sao_params = {}
    sao_recs = None
    if ep.sao_luma or ep.sao_chroma:
        sao_t = raw.sao_buf[:nctu * _CTU_NFIELDS] \
            .reshape(nctu, _CTU_NFIELDS)[:, :_SAO_NFIELDS]
        sao_recs = np.concatenate([meta[:, :2], sao_t], axis=1)

    inter_ctx = None
    if params.slice_type != 2:
        uw, uh, uw8, uh8 = raw.uw, raw.uh, raw.uw8, raw.uh8
        inter_ctx = _NativeInterCtx(
            uw, uh, raw.tmvp_dir0.reshape(uh, uw),
            raw.tmvp_mv0.reshape(uh8, uw8, 3), uw8, uh8,
            raw.tmvp_dir1.reshape(uh, uw),
            raw.tmvp_mv1.reshape(uh8, uw8, 3))

    ectx = NativeEntryCtx(entry, [], sao_params, inter_ctx,
                          ep.tile_x0, ep.tile_y0)
    ectx.sao_recs = sao_recs
    ectx.alf_params = _alf_params_from_raw(ep, raw.sao_buf, meta, nctu)
    return ectx


# ---------------------------------------------------------------------------
# Device-IR builder (ov_build_ir): dense per-frame tensors for the device path
# ---------------------------------------------------------------------------

_ir_proto_done = False


def _setup_ir_proto(lib):
    global _ir_proto_done
    if _ir_proto_done:
        return
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    vp = ctypes.c_void_p
    lib.ov_build_ir.restype = i64
    lib.ov_build_ir.argtypes = [
        ctypes.POINTER(_EntryParamsC), ctypes.POINTER(_ReconParamsC),
        vp, i64,        # cu_buf, ncu
        vp, i64,        # tu_buf, ntu
        vp, vp,         # coef_buf, cqp_tab
        vp, vp, vp,     # res_y, res_cb, res_cr
        i32, i32,       # ry_stride, rc_stride
        vp, vp, vp, vp, vp, vp, vp, i32,  # gmask, gmv, gref, gw, ghpel,
                                          # glist, gwp, g_stride
        vp, i64,        # jobs_l, cap_l
        vp, i64,        # jobs_c, cap_c
        vp, vp,         # dist0, dist1
        ctypes.POINTER(_DbfBufsC),
        vp, i64,        # dtu records, cap (device-residual TUs)
        vp, i64,        # dtu coef flat, cap
        vp,             # out_counts int64[7]
    ]
    _ir_proto_done = True


class FrameIR:
    """Dense per-frame IR tensors shared by all entries of one picture."""

    __slots__ = ("res_y", "res_cb", "res_cr", "gmask", "gmv", "gref", "gw",
                 "ghpel", "glist", "gwp", "has_gpm", "jobs_l", "jobs_c",
                 "uw", "uh", "chroma", "dtu", "dtu_coef")

    def __init__(self, pic_w, pic_h, chroma=True):
        from openvvc_tpu.utils.pool import GLOBAL as _pool

        uw, uh = (pic_w + 3) >> 2, (pic_h + 3) >> 2
        self.uw, self.uh = uw, uh
        self.chroma = chroma
        self.res_y = _pool.take_zeroed((uh * 4, uw * 4), np.int16)
        if chroma:
            self.res_cb = _pool.take_zeroed((uh * 2, uw * 2), np.int16)
            self.res_cr = _pool.take_zeroed((uh * 2, uw * 2), np.int16)
        else:
            self.res_cb = self.res_cr = None
        self.gmask = _pool.take_zeroed((uh, uw), np.uint8)
        self.gmv = _pool.take_zeroed((uh, uw, 2, 2), np.int32)
        self.gref = _pool.take_zeroed((uh, uw, 2), np.int8)
        self.gw = _pool.take_zeroed((uh, uw, 2), np.int8)
        self.ghpel = _pool.take_zeroed((uh, uw), np.uint8)
        # per-unit MC slot->list map + per-sample w0 plane (GPM ramps);
        # only read where gmask is set, so no per-frame clearing needed
        self.glist = _pool.take((uh, uw, 2), np.int8)
        self.gwp = _pool.take((uh * 4, uw * 4), np.int8)
        self.has_gpm = False
        self.jobs_l = []  # per-entry (n, J_NFIELDS) int32 arrays
        self.jobs_c = []
        # per-entry device-residual TU records + flat levels (the frame
        # program runs dequant+LFNST+itx; None entries shipped no records)
        self.dtu = []
        self.dtu_coef = []

    def release(self):
        from openvvc_tpu.utils.pool import GLOBAL as _pool

        _pool.give(self.res_y, self.res_cb, self.res_cr, self.gmask,
                   self.gmv, self.gref, self.gw, self.ghpel, self.glist,
                   self.gwp)
        self.res_y = self.res_cb = self.res_cr = None
        self.gmask = self.gmv = self.gref = self.gw = self.ghpel = None
        self.glist = self.gwp = None


_J_NFIELDS = 16
_DTU_NFIELDS = 16  # ov_shared.h DTU_* record


def build_ir_entry_native(raw, ir: FrameIR, dbf, csign, nb_refs0, nb_refs1,
                          dist0, dist1, entry_idx=None) -> bool:
    """Run ov_build_ir for one parsed entry into the shared FrameIR.

    Returns True on success; False = unsupported tool (caller falls back to
    host reconstruction for the whole picture; partially-written IR buffers
    are discarded)."""
    lib = load_cabac_lib()
    if lib is None:
        return False
    _setup_ir_proto(lib)

    rp = _ReconParamsC()
    rp.dbf_enabled = int(dbf is not None)
    rp.csign = csign
    rp.nb_refs = nb_refs0
    rp.nb_refs1 = nb_refs1

    d0 = np.zeros(16, np.int32)
    if dist0:
        d0[:len(dist0)] = dist0
    d1 = np.zeros(16, np.int32)
    if dist1:
        d1[:len(dist1)] = dist1

    db = _DbfBufsC()
    if dbf is not None:
        for name in _DBF_PTR_NAMES:
            arr = getattr(dbf, name, None)
            setattr(db, name, arr.ctypes.data if arr is not None else None)

    ep = raw.ep
    # job capacity: one job per 4x4 unit of the tile is the worst case
    cap_l = ((ep.tile_w // 4 + 1) * (ep.tile_h // 4 + 1)) + 256
    cap_c = cap_l
    jobs_l = np.empty((cap_l, _J_NFIELDS), np.int32)
    jobs_c = np.empty((cap_c, _J_NFIELDS), np.int32)
    counts = (ctypes.c_int64 * 7)()

    vp = ctypes.c_void_p
    ncu, ntu = int(raw.counts[0]), int(raw.counts[1])
    # device-residual records: one per TB worst case; levels bounded by the
    # entry's parsed coefficient payload
    dtu = dtu_coef = None
    dtu_cap = coef_cap = 0
    if os.environ.get("OPENVVC_DEVICE_RESID", "1") != "0":
        dtu_cap = ntu + 8
        coef_cap = int(raw.coef_buf.shape[0])
        dtu = np.empty((dtu_cap, _DTU_NFIELDS), np.int32)
        dtu_coef = np.empty(max(coef_cap, 1), np.int32)
    rc = lib.ov_build_ir(
        ctypes.byref(ep), ctypes.byref(rp),
        vp(raw.cu_buf.ctypes.data), ncu,
        vp(raw.tu_buf.ctypes.data), ntu,
        vp(raw.coef_buf.ctypes.data), vp(raw.cqp.ctypes.data),
        vp(ir.res_y.ctypes.data),
        vp(ir.res_cb.ctypes.data if ir.res_cb is not None else None),
        vp(ir.res_cr.ctypes.data if ir.res_cr is not None else None),
        ir.res_y.shape[1], ir.res_cb.shape[1] if ir.res_cb is not None else 0,
        vp(ir.gmask.ctypes.data), vp(ir.gmv.ctypes.data),
        vp(ir.gref.ctypes.data), vp(ir.gw.ctypes.data),
        vp(ir.ghpel.ctypes.data), vp(ir.glist.ctypes.data),
        vp(ir.gwp.ctypes.data), ir.uw,
        vp(jobs_l.ctypes.data), cap_l,
        vp(jobs_c.ctypes.data), cap_c,
        vp(d0.ctypes.data), vp(d1.ctypes.data),
        ctypes.byref(db),
        vp(dtu.ctypes.data if dtu is not None else None), dtu_cap,
        vp(dtu_coef.ctypes.data if dtu_coef is not None else None), coef_cap,
        ctypes.cast(counts, ctypes.c_void_p))
    if rc != 0:
        return False
    if counts[4]:
        ir.has_gpm = True
    jl = jobs_l[:int(counts[0])].copy()
    jc = jobs_c[:int(counts[1])].copy()
    dt = dtu[:int(counts[5])].copy() if dtu is not None else None
    dtc = dtu_coef[:int(counts[6])].copy() if dtu_coef is not None else None
    if entry_idx is None:
        ir.jobs_l.append(jl)
        ir.jobs_c.append(jc)
        ir.dtu.append(dt)
        ir.dtu_coef.append(dtc)
    else:
        # slot-indexed: entries build concurrently on the pool, so append
        # order is completion order — the per-tile multichip banding needs
        # jobs_l[i] == entry i
        while len(ir.jobs_l) <= entry_idx:
            ir.jobs_l.append(None)
            ir.jobs_c.append(None)
            ir.dtu.append(None)
            ir.dtu_coef.append(None)
        ir.jobs_l[entry_idx] = jl
        ir.jobs_c[entry_idx] = jc
        ir.dtu[entry_idx] = dt
        ir.dtu_coef[entry_idx] = dtc
    return True

