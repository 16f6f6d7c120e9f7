"""Frame pipeline depth (-t): the device path chains device programs on the
donated DPB stacks (XLA data flow = the reference's cross-frame watermark,
dpb.c:1222-1361, at frame granularity) — output must be byte-identical at
every pipeline depth, and the backlog must respect the bound."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gen(path, **kw):
    if os.path.exists(path):
        return
    args = [sys.executable, os.path.join(REPO, "tools/gen_bench_stream.py"),
            "--out", path]
    for k, v in kw.items():
        args += [f"--{k}"] if v is None else [f"--{k}", str(v)]
    subprocess.run(args, check=True, capture_output=True, timeout=600)


@pytest.mark.parametrize("gop", ["lowdelay", "ra"])
def test_depth_invariance(gop):
    from openvvc_tpu.decoder import Decoder

    path = f"/tmp/fp_depth_{gop}.266"
    _gen(path, width=256, height=192, frames=6, gop=gop,
         **{"leaf-intra": 4, "leaf-inter": 4})
    with open(path, "rb") as f:
        stream = f.read()
    outs = []
    for k in (1, 2, 4, 8):
        d = Decoder(use_tpu=True, nb_frame_threads=k)
        frames = d.decode(stream)
        assert d.stats.get("tpu_frames", 0) == 6, (k, d.stats)
        outs.append(b"".join(f.to_yuv_bytes()
                             for f in d.output_order(frames)))
    assert all(o == outs[0] for o in outs[1:]), \
        "output depends on pipeline depth"
