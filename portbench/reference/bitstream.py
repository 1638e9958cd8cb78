"""Bitstream writer/reader with HEVC emulation prevention.

Host-side byte/bit plumbing: exp-Golomb codes, RBSP trailing bits, NAL
encapsulation (start codes + emulation-prevention three-bytes).

Reference parity: kvazaar src/bitstream.c (chunked writer, ue/se codes,
zerocount-based emulation prevention) and src/nal.c. Ours uses a flat
bytearray — frames are assembled host-side, there is no need for the
reference's 4 KiB chunk pooling.
"""
from __future__ import annotations


def ebsp_to_rbsp_ex(ebsp: bytes) -> tuple[bytes, list[int]]:
    """Strip emulation bytes; also return, for each ebsp byte index, the
    count of rbsp bytes preceding it (for entry-point offset conversion)."""
    out = bytearray()
    pos = [0] * (len(ebsp) + 1)
    zeros = 0
    for i, b in enumerate(ebsp):
        pos[i] = len(out)
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    pos[len(ebsp)] = len(out)
    return bytes(out), pos


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation-prevention bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# NAL unit types (spec Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_R = 3
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


class BitReader:
    """MSB-first bit reader over RBSP bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # bit position

    def u(self, nbits: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(nbits):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 40:
                raise ValueError("corrupt exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        v = self.ue()
        return (v + 1) >> 1 if v & 1 else -(v >> 1)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        return self.pos >> 3

    def more_rbsp_data(self) -> bool:
        # True unless only the rbsp stop bit + alignment zeros remain.
        nbits = len(self.data) * 8
        if self.pos >= nbits:
            return False
        # find last set bit in stream
        last = nbits - 1
        while last >= 0:
            if (self.data[last >> 3] >> (7 - (last & 7))) & 1:
                break
            last -= 1
        return self.pos < last


def split_annexb(stream: bytes) -> list[tuple[int, int, bytes]]:
    """Split an Annex-B stream into (nal_type, temporal_id, ebsp_payload)."""
    nals = []
    i = 0
    n = len(stream)
    starts = []
    while i < n - 3:
        if stream[i] == 0 and stream[i + 1] == 0:
            if stream[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if i < n - 4 and stream[i + 2] == 0 and stream[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    starts.append(None)
    for k in range(len(starts) - 1):
        s = starts[k]
        e = starts[k + 1]
        if e is None:
            chunk = stream[s:]
        else:
            # strip start-code prefix of next NAL (3 or 4 zeros+1)
            e2 = e - 3
            if e2 > 0 and stream[e2 - 1] == 0:
                e2 -= 1
            chunk = stream[s:e2]
        # trim trailing zero bytes (trailing_zero_8bits)
        header = chunk[:2]
        nal_type = (header[0] >> 1) & 0x3F
        tid = (header[1] & 7) - 1
        nals.append((nal_type, tid, chunk[2:]))
    return nals
