"""Selective encryption (AES-CFB keystream over syntax elements).

TPU-native parity port of the reference's optional crypto component
(reference: src/extras/crypto.cpp, src/extras/crypto.h; hooks at
src/encode_coding_tree.c:442,477-560,1091-1107, src/cabac.c:303-440
(kvz_cabac_write_coeff_remain_encry), src/cabac.c:576-583
(ep_ex_golomb MVD suffix), and
src/strategies/generic/encode_coding_tree-generic.c:243-265
(coefficient sign / suffix gates)).

The scheme scrambles *values* of selected syntax elements with an
AES-128-CFB keystream before binarization, in a way that keeps the
stream length-preserving and parseable by a stock HEVC decoder (which
then reconstructs garbled video); a decoder holding the key regenerates
the keystream and inverts each transform. Host-side entropy layer only —
nothing here touches the traced device programs.

Feature flags mirror kvazaar.h:171-177. The AES block cipher is
implemented here directly (this environment has no AES package); the
CFB chaining, the counter layout and the bit-serving order of
``get_key`` replicate crypto.cpp:34-140 exactly so the keystream design
matches the reference.
"""
from __future__ import annotations

# -- feature flags (kvazaar.h:170-178) --------------------------------------
CRYPTO_OFF = 0
CRYPTO_MVS = 1 << 0
CRYPTO_MV_SIGNS = 1 << 1
CRYPTO_TRANSF_COEFFS = 1 << 2
CRYPTO_TRANSF_COEFF_SIGNS = 1 << 3
CRYPTO_INTRA_MODE = 1 << 4
CRYPTO_ON = (1 << 5) - 1

FEATURE_NAMES = {
    "mvs": CRYPTO_MVS,
    "mv_signs": CRYPTO_MV_SIGNS,
    "trans_coeffs": CRYPTO_TRANSF_COEFFS,
    "trans_coeff_signs": CRYPTO_TRANSF_COEFF_SIGNS,
    "intra_pred_modes": CRYPTO_INTRA_MODE,
}

# default key/IV (crypto.cpp:29-30)
DEFAULT_IV = bytes([201, 75, 219, 152, 6, 245, 237, 107,
                    179, 194, 81, 29, 66, 98, 198, 0])
DEFAULT_KEY = bytes([16, 213, 27, 56, 255, 127, 242, 112,
                     97, 126, 197, 204, 25, 59, 38, 30])


def parse_crypto_spec(spec: str) -> int:
    """'off' | 'on' | '+'-joined feature names (cfg.c:1156-1198)."""
    spec = (spec or "off").strip().lower()
    if spec in ("off", ""):
        return CRYPTO_OFF
    if spec == "on":
        return CRYPTO_ON
    feats = 0
    for tok in spec.replace(",", "+").split("+"):
        tok = tok.strip()
        if not tok:
            continue
        if tok not in FEATURE_NAMES:
            raise ValueError(f"unknown crypto feature '{tok}' "
                             f"(choose from {sorted(FEATURE_NAMES)})")
        feats |= FEATURE_NAMES[tok]
    return feats


# -- AES-128 (FIPS-197), encryption direction only ---------------------------

_SBOX = [
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
]

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36]


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1b) & 0xff if a & 0x100 else a


def _expand_key(key: bytes) -> list[list[int]]:
    """AES-128 key schedule -> 11 round keys of 16 bytes."""
    w = [list(key[i:i + 4]) for i in range(0, 16, 4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r:4 * r + 4], []) for r in range(11)]


def _aes_encrypt_block(rk: list[list[int]], block: bytes) -> bytes:
    s = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]
        # ShiftRows on column-major state: byte i sits at row i%4, col i//4
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        if rnd < 10:
            t = []
            for c in range(0, 16, 4):
                a = s[c:c + 4]
                t += [
                    _xtime(a[0]) ^ _xtime(a[1]) ^ a[1] ^ a[2] ^ a[3],
                    a[0] ^ _xtime(a[1]) ^ _xtime(a[2]) ^ a[2] ^ a[3],
                    a[0] ^ a[1] ^ _xtime(a[2]) ^ _xtime(a[3]) ^ a[3],
                    _xtime(a[0]) ^ a[0] ^ a[1] ^ a[2] ^ _xtime(a[3]),
                ]
            s = t
        s = [b ^ k for b, k in zip(s, rk[rnd])]
    return bytes(s)


class CryptoHandle:
    """AES-128-CFB keystream generator (crypto.cpp:34-140).

    counter[i] = IV[5+i] for i<11 else key[i-11]; each refill encrypts
    the counter through the CFB cipher (feedback register seeded with
    the IV and chained through the produced blocks) and increments
    counter[0]. ``get_key`` serves bits from byte 15 downward, 8 bits
    per byte, exactly like crypto.cpp:85-140.
    """

    def __init__(self, key: bytes | None = None,
                 iv: bytes | None = None) -> None:
        self.key = bytes(key or DEFAULT_KEY)
        self.iv = bytes(iv or DEFAULT_IV)
        if len(self.key) != 16 or len(self.iv) != 16:
            raise ValueError("crypto key/IV must be 16 bytes")
        self._rk = _expand_key(self.key)
        self._register = self.iv  # CFB feedback register
        self.counter = bytearray(
            self.iv[5 + i] if i < 11 else self.key[i - 11]
            for i in range(16))
        self.out = bytearray(16)
        self.avail = 0
        self.idx = 0
        self.idx_pos = 0
        # chained previous-position state shared by the suffix schemes
        # (encoderstate.h crypto_prev_pos analog)
        self.prev_pos = 0

    def _cfb_block(self, block: bytes) -> bytes:
        ks = _aes_encrypt_block(self._rk, self._register)
        out = bytes(b ^ k for b, k in zip(block, ks))
        self._register = out
        return out

    def _refill(self) -> None:
        self.out = bytearray(self._cfb_block(bytes(self.counter)))
        self.avail = 128
        self.idx = 15
        self.idx_pos = 8
        self.counter[0] = (self.counter[0] + 1) & 0xff

    def get_key(self, nb_bits: int) -> int:
        """Serve nb_bits (<=32) keystream bits (crypto.cpp:100-140)."""
        if nb_bits > 32:
            raise ValueError("max 32 bits per call")
        if nb_bits == 0:
            return 0
        if not self.avail:
            self._refill()
        self.avail = max(0, self.avail - nb_bits)
        key = 0
        while nb_bits:
            nb = min(nb_bits, self.idx_pos)
            key = (key << nb) | (self.out[self.idx] & ((1 << nb) - 1))
            self.out[self.idx] >>= nb
            nb_bits -= nb
            if self.idx and nb == self.idx_pos:
                self.idx -= 1
                self.idx_pos = 8
            else:
                self.idx_pos -= nb
                if nb_bits:
                    self._refill()
                    self.avail -= nb_bits
        return key


# -- length-preserving syntax transforms -------------------------------------

# intra-mode scan classes (encode_coding_tree.c:426-432). Each class is
# closed under the encryption map, so the decoder recovers the class
# from the *encrypted* mode and inverts.
_INTRA_SETS = (
    (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20, 21, 31, 32, 33, 34),
    (22, 23, 24, 25, 27, 28, 29, 30),
    (6, 7, 8, 9, 11, 12, 13, 14),
)
_INTRA_SET_OF = {}
for _s, _set in enumerate(_INTRA_SETS):
    for _i, _m in enumerate(_set):
        _INTRA_SET_OF[_m] = (_s, _i)


def decrypt_intra_mode(hdl: CryptoHandle, enc_mode: int) -> int:
    if enc_mode in (10, 26):
        return enc_mode
    keybits = hdl.get_key(5)
    s, idx = _INTRA_SET_OF[enc_mode]
    n = len(_INTRA_SETS[s])
    return _INTRA_SETS[s][(idx - keybits % n) % n]


def _golomb_window(value_hi: int, k_max: int, rice: int,
                   base_level: int) -> int:
    """Largest k <= k_max such that every suffix variant in the low-k
    window leaves the decoder's golomb-rice state machine unchanged —
    i.e. the rice-adaptation guard ``level > 3 << rice`` is constant
    across the window. This computes the invariance the reference
    enumerates case-by-case in cabac.c:303-440.

    value_hi is the suffix with its low k_max bits already masked off
    (the encrypted window only ever changes low bits, so the decoder
    can evaluate the same rule from the received codeword)."""
    for k in range(k_max, 0, -1):
        base = (value_hi >> k) << k
        lo = base_level + base
        hi = base_level + base + (1 << k) - 1
        thresh = 3 << rice
        if (lo > thresh) == (hi > thresh):
            return k
    return 0


def decrypt_golomb_suffix(hdl: CryptoHandle, recv_suffix: int, rice: int,
                          base_level_plus_hi: int) -> int:
    """Inverse of the encoder's suffix encryption. base_level_plus_hi is
    base_level + ((code_number >> rice) << rice), both known from the
    prefix before the suffix bits are consumed. The encrypted window
    only changes low bits, so _golomb_window picks the same k here as
    it did at encode time (bits >= k are untouched)."""
    k = _golomb_window(recv_suffix, rice, rice, base_level_plus_hi)
    if k == 0:
        return recv_suffix
    key = hdl.get_key(k)
    mask = (1 << k) - 1
    true_low = ((recv_suffix & mask) - (hdl.prev_pos ^ key)) & mask
    hdl.prev_pos = recv_suffix & mask
    return (recv_suffix & ~mask) | true_low


def decrypt_ep_suffix(hdl: CryptoHandle, recv: int, nbits: int) -> int:
    if nbits <= 0:
        return recv
    key = hdl.get_key(nbits)
    mask = (1 << nbits) - 1
    true = (recv - (hdl.prev_pos ^ key)) & mask
    hdl.prev_pos = recv & mask
    return true


def xor_bits(hdl: CryptoHandle, value: int, nbits: int) -> int:
    """Plain keystream XOR (MV signs encode_coding_tree.c:1091-1107,
    coefficient signs encode_coding_tree-generic.c:243-251)."""
    if nbits <= 0:
        return value
    return value ^ hdl.get_key(min(nbits, 32))
