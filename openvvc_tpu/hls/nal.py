"""NAL unit model and Annex-B byte-stream demux/mux for VVC.

Fresh implementation of ITU-T H.266 section 7.3.1 (NAL unit syntax) and
Annex B (byte-stream format). Mirrors the capability of the reference demuxer
(/root/reference/libovvc/ovdmx.c: start-code scan, EPB strip, picture-unit
grouping) without its chunked-IO machinery: host RAM is not the bottleneck for
the device pipeline, so we demux whole buffers/memory-mapped files.
"""

from __future__ import annotations

import enum
import io
from dataclasses import dataclass, field

from openvvc_tpu.utils.bitstream import (
    insert_emulation_prevention,
    strip_emulation_prevention,
)


class NalType(enum.IntEnum):
    # VCL
    TRAIL = 0
    STSA = 1
    RADL = 2
    RASL = 3
    RSV_VCL_4 = 4
    RSV_VCL_5 = 5
    RSV_VCL_6 = 6
    IDR_W_RADL = 7
    IDR_N_LP = 8
    CRA = 9
    GDR = 10
    RSV_IRAP_11 = 11
    # non-VCL
    OPI = 12
    DCI = 13
    VPS = 14
    SPS = 15
    PPS = 16
    PREFIX_APS = 17
    SUFFIX_APS = 18
    PH = 19
    AUD = 20
    EOS = 21
    EOB = 22
    PREFIX_SEI = 23
    SUFFIX_SEI = 24
    FD = 25
    RSV_NVCL_26 = 26
    RSV_NVCL_27 = 27
    UNSPEC_28 = 28
    UNSPEC_29 = 29
    UNSPEC_30 = 30
    UNSPEC_31 = 31


VCL_TYPES = frozenset(range(0, 12))
IRAP_TYPES = frozenset({NalType.IDR_W_RADL, NalType.IDR_N_LP, NalType.CRA})


def is_vcl(t: int) -> bool:
    return t in VCL_TYPES


@dataclass
class NalUnit:
    """One NAL unit with its RBSP payload (EPBs already removed)."""

    type: NalType
    rbsp: bytes
    layer_id: int = 0
    temporal_id: int = 0  # nuh_temporal_id_plus1 - 1
    epb_positions: list[int] = field(default_factory=list)

    @classmethod
    def parse(cls, ebsp: bytes) -> "NalUnit":
        """Parse a NAL unit from its EBSP bytes (header + payload, no start code)."""
        if len(ebsp) < 3:
            raise ValueError("NAL unit too short")
        b0, b1 = ebsp[0], ebsp[1]
        if b0 & 0x80:
            raise ValueError("forbidden_zero_bit set")
        layer_id = b0 & 0x3F
        nal_type = NalType((b1 >> 3) & 0x1F)
        tid_plus1 = b1 & 0x07
        if tid_plus1 == 0:
            raise ValueError("nuh_temporal_id_plus1 must be nonzero")
        rbsp, epb = strip_emulation_prevention(ebsp[2:])
        return cls(nal_type, rbsp, layer_id, tid_plus1 - 1, epb)

    def serialize(self) -> bytes:
        """NAL header + EPB-protected payload (no start code)."""
        hdr = bytes(
            [
                (self.layer_id & 0x3F),
                ((int(self.type) & 0x1F) << 3) | ((self.temporal_id + 1) & 0x07),
            ]
        )
        return hdr + insert_emulation_prevention(self.rbsp)


@dataclass
class PictureUnit:
    """A group of NAL units forming one coded picture (OVPictureUnit analog)."""

    nalus: list[NalUnit] = field(default_factory=list)

    @property
    def vcl_nalus(self) -> list[NalUnit]:
        return [n for n in self.nalus if is_vcl(n.type)]


def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into raw NALU (EBSP) payloads.

    Accepts 3- or 4-byte start codes; trailing zero bytes of each NALU are
    trimmed (they belong to the next start code / trailing_zero_8bits).
    """
    nalus: list[bytes] = []
    n = len(data)
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        start = i + 3
        j = data.find(b"\x00\x00\x01", start)
        end = j if j >= 0 else n
        # trim trailing zeros (part of the next start code prefix or padding)
        while end > start and data[end - 1] == 0:
            end -= 1
        if end > start:
            nalus.append(data[start:end])
        if j < 0:
            break
        i = j
    return nalus


def demux_annexb(data: bytes) -> list[NalUnit]:
    return [NalUnit.parse(raw) for raw in split_annexb(data)]


def group_picture_units(nalus: list[NalUnit]) -> list[PictureUnit]:
    """Group NAL units into picture units.

    Prefix non-VCL NALUs (SPS/PPS/PH/prefix APS/prefix SEI/AUD...) attach to the
    *following* picture; suffix NALUs (suffix SEI/APS, EOS, EOB, FD) attach to
    the current one. Single-slice pictures, as in the reference (ovdec.c:129-133).
    """
    suffix_types = {NalType.SUFFIX_SEI, NalType.SUFFIX_APS, NalType.EOS, NalType.EOB, NalType.FD}
    pus: list[PictureUnit] = []
    cur = PictureUnit()
    seen_vcl = False
    for nal in nalus:
        if seen_vcl and nal.type not in suffix_types:
            pus.append(cur)
            cur = PictureUnit()
            seen_vcl = False
        cur.nalus.append(nal)
        if is_vcl(nal.type):
            seen_vcl = True
    if cur.nalus:
        pus.append(cur)
    return pus


def mux_annexb(nalus: list[NalUnit], four_byte_first: bool = True) -> bytes:
    """Serialize NAL units to an Annex-B byte stream."""
    out = io.BytesIO()
    for k, nal in enumerate(nalus):
        if k == 0 and four_byte_first:
            out.write(b"\x00\x00\x00\x01")
        else:
            out.write(b"\x00\x00\x01")
        out.write(nal.serialize())
    return out.getvalue()
