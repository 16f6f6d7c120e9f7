"""Device MIP (KIND_MIP wave jobs): the device frame program must decode
MIP streams bit-identically to the host decoder (itself oracle
bit-exact), across all three size classes and transposes."""

import numpy as np
import pytest

from openvvc_tpu.rcn.ref_mip import nb_mip_modes
from openvvc_tpu.testing.generator import (StreamConfig,
                                           _find_last_pos_diag,
                                           build_stream, rect_tree_builder)
from openvvc_tpu.vcl.coding_tree import NO_SPLIT, TreeNode
from openvvc_tpu.vcl.ctu import CU, TU, TREE_DUAL_LUMA


@pytest.mark.parametrize("lw,lh", [(3, 3), (4, 4), (5, 5), (4, 5)])
def test_mip_device_parity(lw, lh):
    from openvvc_tpu.decoder import Decoder

    rng = np.random.RandomState(lw * 8 + lh)
    cfg = StreamConfig(width=128, height=128, qp=30, deblocking=True,
                       sao=True, mip=True, max_mtt_depth=4, min_cb_log2=2)

    def make_cu(x, y, dual):
        cu = CU(x, y, lw, lh, intra_mode_l=0, intra_mode_c=0,
                tree_type=TREE_DUAL_LUMA if dual else 0)
        cu.mip_flag = 1
        cu.mip_transpose = int(rng.randint(0, 2))
        cu.mip_mode = int(rng.randint(0, nb_mip_modes(lw, lh)))
        if rng.rand() < 0.7:
            n, m = 1 << lh, 1 << lw
            lv = (rng.randint(-12, 13, (n, m))
                  * (rng.rand(n, m) < 0.2)).astype(np.int32)
            if not lv.any():
                lv[0, 0] = 2
            cu.tus.append(TU(x, y, lw, lh, 0, cbf=1, levels=lv,
                             last_pos=_find_last_pos_diag(lv, lw, lh)))
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
