"""Device LMCS (tpu/lmcs_dense.py): the device frame program must decode
LMCS streams (reshaper curve + chroma residual scaling) bit-identically
to the host decoder, intra and inter."""

import numpy as np
import pytest
from openvvc_tpu.testing.generator import StreamConfig, build_stream, build_stream_frames, rect_tree_builder
from openvvc_tpu.vcl.coding_tree import NO_SPLIT, QT_SPLIT, TreeNode
from openvvc_tpu.vcl.ctu import CU, TU, TREE_DUAL_LUMA
from openvvc_tpu.testing.generator import _find_last_pos_diag as find_last_pos
from openvvc_tpu.decoder import Decoder

def _run(label, lp, dbf, crs, inter=False):
    rng = np.random.RandomState(7)
    cfg = StreamConfig(width=128, height=128, qp=30, deblocking=dbf, lmcs=True,
                       lmcs_params=lp, lmcs_chroma_scaling=crs,
                       max_mtt_depth=4, min_cb_log2=2, sao=True)
    lw = lh = 4
    def make_cu(x, y, dual):
        cu = CU(x, y, lw, lh, intra_mode_l=int(rng.randint(0, 67)), intra_mode_c=0,
                tree_type=TREE_DUAL_LUMA if dual else 0)
        n, m = 1 << lh, 1 << lw
        lv = (rng.randint(-12, 13, (n, m)) * (rng.rand(n, m) < 0.25)).astype(np.int32)
        if not lv.any(): lv[0, 0] = 2
        cu.tus.append(TU(x, y, lw, lh, 0, cbf=1, levels=lv,
                         last_pos=find_last_pos(lv, lw, lh)))
        if rng.rand() < 0.6:
            clv = (rng.randint(-8, 9, (n >> 1, m >> 1)) * (rng.rand(n >> 1, m >> 1) < 0.3)).astype(np.int32)
            if clv.any():
                cu.tus.append(TU(x >> 1, y >> 1, lw - 1, lh - 1, 1, cbf=1, levels=clv,
                                 last_pos=find_last_pos(clv, lw - 1, lh - 1)))
        return TreeNode(NO_SPLIT, cu=cu)
    tb = rect_tree_builder(lw, lh, make_cu, rng)
    if inter:
        def inter_cu(x, y, l):
            cu = CU(x, y, l, l); cu.pred_mode = 1
            if rng.rand() < 0.5:
                cu.skip_flag = 1; cu.merge_flag = 1; cu.merge_idx = int(rng.randint(0,5))
            else:
                cu.merge_flag = 0; cu.ref_idx = 0
                cu.mvd = (int(rng.randint(-16,17)), int(rng.randint(-16,17))); cu.mvp_idx = 0
                lv = (rng.randint(-9,10,(1<<l,1<<l)) * (rng.rand(1<<l,1<<l) < 0.1)).astype(np.int32)
                if lv.any():
                    cu.tus.append(TU(x, y, l, l, 0, cbf=1, levels=lv, last_pos=find_last_pos(lv, l, l)))
                clv = (rng.randint(-6,7,(1<<(l-1),1<<(l-1))) * (rng.rand(1<<(l-1),1<<(l-1)) < 0.1)).astype(np.int32)
                if clv.any():
                    cu.tus.append(TU(x>>1, y>>1, l-1, l-1, 1, cbf=1, levels=clv, last_pos=find_last_pos(clv, l-1, l-1)))
            return TreeNode(NO_SPLIT, cu=cu)
        def qt2f(params, entry):
            clg = params.sps.ctb_log2
            def qt2(x, y, l2):
                if l2 > 4:
                    hh = 1 << (l2-1)
                    return TreeNode(QT_SPLIT, children=[qt2(x,y,l2-1), qt2(x+hh,y,l2-1), qt2(x,y+hh,l2-1), qt2(x+hh,y+hh,l2-1)])
                return inter_cu(x, y, l2)
            return {(entry.ctu_x+c, entry.ctu_y+r): qt2((entry.ctu_x+c)<<clg, (entry.ctu_y+r)<<clg, clg)
                    for r in range(entry.nb_ctu_h) for c in range(entry.nb_ctu_w)}
        stream = build_stream_frames(cfg, [{"tree_builder": tb},
                                           {"tree_builder": qt2f, "slice_type": 1, "ref_deltas": [1]},
                                           {"tree_builder": qt2f, "slice_type": 1, "ref_deltas": [1]}])
    else:
        stream = build_stream(cfg, tb)
    host = Decoder()
    want = b''.join(f.to_yuv_bytes() for f in host.output_order(host.decode(stream)))
    tp = Decoder(use_tpu=True)
    got = b''.join(f.to_yuv_bytes() for f in tp.output_order(tp.decode(stream)))
    assert tp.stats.get('tpu_frames', 0) == (3 if inter else 1), tp.stats
    assert got == want, label


@pytest.mark.parametrize("label,lp,dbf,crs,inter", [
    ("curve-intra", dict(cw_deltas={2: 10, 5: -8, 8: 16, 12: -12}), True,
     False, False),
    ("crs-intra", dict(cw_deltas={3: 12, 9: -10}, crs=3), False, True,
     False),
    ("curve-inter", dict(cw_deltas={2: 10, 5: -8, 8: 16, 12: -12}), True,
     False, True),
    ("crs-inter", dict(cw_deltas={3: 12, 9: -10}, crs=3), True, True,
     True),
])
def test_lmcs_device_parity(label, lp, dbf, crs, inter):
    _run(label, lp, dbf, crs, inter)
