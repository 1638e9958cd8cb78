"""CABAC binary arithmetic coder (HEVC spec 9.3).

Host-side entropy coding: the encoder engine follows the standard low/range
formulation with carry propagation via byte buffering; the decoder follows
spec 9.3.4.3 exactly. Both are validated by round-trip tests and by decoding
reference-encoder bitstreams.

Reference parity: kvazaar src/cabac.c / src/cabac.h (engine + context
families) and src/context.c (initialization). In our TPU design CABAC stays
on host and consumes device-computed decision/coefficient tensors; see
kvazaar_tpu/syntax/.
"""
from __future__ import annotations

from .bitstream import BitReader
from .tables import (CONTEXT_INIT, LPS_TABLE, RENORM_TABLE, TRANS_LPS,
                     TRANS_MPS, context_init_state)

_LPS = LPS_TABLE.tolist()
_TLPS = TRANS_LPS.tolist()
_TMPS = TRANS_MPS.tolist()
_RENORM = RENORM_TABLE.tolist()


class ContextSet:
    """All context models of one slice, stored as flat state/mps lists.

    Contexts are addressed as (family, index) resolved once into flat
    offsets via `offsets`.
    """

    FAMILIES = [k for k, v in CONTEXT_INIT.items() if v is not None]
    OFFSETS: dict[str, int] = {}
    _n = 0
    for _f in FAMILIES:
        OFFSETS[_f] = _n
        _n += len(CONTEXT_INIT[_f][0])
    NUM_CTX = _n

    __slots__ = ("state", "mps")

    def __init__(self, init_type: int, qp: int) -> None:
        self.state = [0] * self.NUM_CTX
        self.mps = [0] * self.NUM_CTX
        for fam in self.FAMILIES:
            base = self.OFFSETS[fam]
            for i, iv in enumerate(CONTEXT_INIT[fam][init_type]):
                s, m = context_init_state(iv, qp)
                self.state[base + i] = s
                self.mps[base + i] = m

    def copy(self) -> "ContextSet":
        new = object.__new__(ContextSet)
        new.state = list(self.state)
        new.mps = list(self.mps)
        return new

    @classmethod
    def idx(cls, family: str, i: int = 0) -> int:
        return cls.OFFSETS[family] + i


class CabacDecoder:
    """HEVC binary arithmetic decoder (spec 9.3.4.3)."""

    __slots__ = ("range", "offset", "br", "ctx", "crypto_res")

    def __init__(self, br: BitReader, ctx: ContextSet) -> None:
        self.br = br
        self.ctx = ctx
        self.crypto_res = None   # (CryptoHandle, features) or None
        self.range = 510
        self.offset = br.u(9)

    def _read_bit(self) -> int:
        br = self.br
        if br.pos < len(br.data) * 8:
            return br.u(1)
        br.pos += 1  # conceptually reading past the end yields 0
        return 0

    def decode_bin(self, ctx_idx: int) -> int:
        ctx = self.ctx
        state = ctx.state[ctx_idx]
        lps = _LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            binval = ctx.mps[ctx_idx] ^ 1
            self.offset -= self.range
            self.range = lps
            if state == 0:
                ctx.mps[ctx_idx] ^= 1
            ctx.state[ctx_idx] = _TLPS[state]
        else:
            binval = ctx.mps[ctx_idx]
            ctx.state[ctx_idx] = _TMPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return binval

    def decode_bin_ep(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bins_ep(self, nbins: int) -> int:
        v = 0
        for _ in range(nbins):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def decode_unary_max(self, ctx_idx: int, max_val: int) -> int:
        v = 0
        while v < max_val and self.decode_bin(ctx_idx):
            v += 1
        return v

    def decode_remaining_golomb(self, rice: int) -> int:
        prefix = 0
        while prefix < 32 and self.decode_bin_ep():
            prefix += 1
        if prefix < 3:
            return (prefix << rice) + (self.decode_bins_ep(rice) if rice
                                       else 0)
        length = prefix - 3 + rice
        return ((((1 << (prefix - 3)) + 3 - 1) << rice)
                + self.decode_bins_ep(length))
