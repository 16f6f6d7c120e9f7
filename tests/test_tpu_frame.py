"""End-to-end device frame pipeline vs the host decoder (itself oracle
bit-exact vs the reference binary): Decoder(use_tpu=True) must produce
byte-identical YUV with every picture going through the fused device
program (no host fallback)."""

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


def _yuv(dec, stream):
    frames = dec.decode(stream)
    return b"".join(f.to_yuv_bytes() for f in dec.output_order(frames))


@pytest.mark.parametrize("gop,tiles,alf", [("lowdelay", 1, False),
                                           ("lowdelay", 2, False),
                                           ("ra", 2, False),
                                           ("lowdelay", 1, True),
                                           ("ra", 2, True),
                                           ("lowdelay", 1, "all-tools"),
                                           ("ra", 2, "all-tools")])
def test_tpu_frame_bit_exact(gop, tiles, alf):
    from openvvc_tpu.decoder import Decoder

    path = f"/tmp/tpu_e2e_{gop}_{tiles}_{alf}.266"
    kw = {"leaf-intra": 4, "leaf-inter": 4}
    if alf == "all-tools":
        kw["all-tools"] = None  # ALF + LFNST hostile profile
        kw["leaf-intra"] = 5
    elif alf:
        kw["alf"] = None  # boolean flag
    _gen(path, width=256, height=192, frames=5, tiles=tiles, gop=gop, **kw)
    with open(path, "rb") as f:
        stream = f.read()

    host = Decoder()
    ref = _yuv(host, stream)

    tpu = Decoder(use_tpu=True)
    got = _yuv(tpu, stream)
    assert tpu.stats.get("tpu_frames", 0) == 5, \
        f"device path fell back: {tpu.stats}"
    assert got == ref
