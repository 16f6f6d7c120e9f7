"""Device CCLM/MDLM (KIND_CCLM chroma wave jobs): the device frame program
must decode CCLM streams bit-identically to the host decoder across all
three modes and both luma-sample alignments."""

import numpy as np
import pytest

from openvvc_tpu.testing.generator import (StreamConfig,
                                           _find_last_pos_diag,
                                           build_stream, rect_tree_builder)
from openvvc_tpu.vcl.coding_tree import NO_SPLIT, TreeNode
from openvvc_tpu.vcl.ctu import CU, TU, TREE_DUAL_LUMA


@pytest.mark.parametrize("cmode", [81, 82, 83])
@pytest.mark.parametrize("colloc", [False, True])
def test_cclm_device_parity(cmode, colloc):
    from openvvc_tpu.decoder import Decoder

    rng = np.random.RandomState(cmode * 2 + colloc)
    cfg = StreamConfig(width=128, height=128, qp=30, deblocking=True,
                       sao=True, cclm=True, cclm_collocated=colloc,
                       max_mtt_depth=4, min_cb_log2=2)
    lw = lh = 4

    def make_cu(x, y, dual):
        cu = CU(x, y, lw, lh, intra_mode_l=int(rng.randint(0, 67)),
                intra_mode_c=0,
                tree_type=TREE_DUAL_LUMA if dual else 0)
        cu.intra_mode_c = cmode if rng.rand() < 0.8 else 0
        n, m = 1 << lh, 1 << lw
        lv = (rng.randint(-12, 13, (n, m))
              * (rng.rand(n, m) < 0.2)).astype(np.int32)
        if lv.any():
            cu.tus.append(TU(x, y, lw, lh, 0, cbf=1, levels=lv,
                             last_pos=_find_last_pos_diag(lv, lw, lh)))
        clv = (rng.randint(-8, 9, (n >> 1, m >> 1))
               * (rng.rand(n >> 1, m >> 1) < 0.3)).astype(np.int32)
        if clv.any():
            cu.tus.append(TU(x >> 1, y >> 1, lw - 1, lh - 1, 1, cbf=1,
                             levels=clv,
                             last_pos=_find_last_pos_diag(clv, lw - 1,
                                                          lh - 1)))
        return TreeNode(NO_SPLIT, cu=cu)

    stream = build_stream(cfg, rect_tree_builder(lw, lh, make_cu, rng))
    host = Decoder()
    want = b"".join(f.to_yuv_bytes()
                    for f in host.output_order(host.decode(stream)))
    tp = Decoder(use_tpu=True)
    got = b"".join(f.to_yuv_bytes()
                   for f in tp.output_order(tp.decode(stream)))
    assert tp.stats.get("tpu_frames", 0) == 1, tp.stats
    assert got == want
