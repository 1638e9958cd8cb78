"""SEI messages: decoded-picture-hash (spec D.2.20) and user data.

Reference parity: kvazaar src/encoder_state-bitstream.c:962 (add_checksum)
and :608 (encoder-version user-data SEI).
"""
from __future__ import annotations

import hashlib

import numpy as np


SEI_DECODED_PICTURE_HASH = 132
SEI_USER_DATA_UNREGISTERED = 5

HASH_MD5 = 0
HASH_CRC = 1
HASH_CHECKSUM = 2


def plane_checksum(plane: np.ndarray, bit_depth: int = 8) -> int:
    """HEVC picture checksum of one plane (spec D.3.20)."""
    h, w = plane.shape
    y, x = np.mgrid[0:h, 0:w]
    xor_mask = ((x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)).astype(
        np.uint32)
    vals = (plane.astype(np.uint32) & 0xFF) ^ xor_mask
    total = int(vals.sum(dtype=np.uint64) & 0xFFFFFFFF)
    # For bit depths > 8 the high byte contributes too.
    if bit_depth > 8:
        hi = ((plane.astype(np.uint32) >> 8) ^ xor_mask)
        total = (total + int(hi.sum(dtype=np.uint64))) & 0xFFFFFFFF
    return total


def plane_md5(plane: np.ndarray, bit_depth: int = 8) -> bytes:
    if bit_depth <= 8:
        data = plane.astype(np.uint8).tobytes()
    else:
        data = plane.astype("<u2").tobytes()
    return hashlib.md5(data).digest()


def parse_sei_messages(rbsp: bytes) -> list[tuple[int, bytes]]:
    """Parse SEI RBSP into (payload_type, payload) messages."""
    out = []
    i = 0
    n = len(rbsp)
    while i < n - 1:  # last byte is rbsp trailing bits
        ptype = 0
        while rbsp[i] == 255:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        size = 0
        while rbsp[i] == 255:
            size += 255
            i += 1
        size += rbsp[i]
        i += 1
        out.append((ptype, rbsp[i:i + size]))
        i += size
        if i >= n:
            break
        # stop if only trailing bits remain
        if all(b == 0 for b in rbsp[i + 1:]) and rbsp[i] == 0x80:
            break
    return out


def parse_hash_sei(payload: bytes) -> tuple[int, list[bytes]]:
    hash_type = payload[0]
    size = {HASH_MD5: 16, HASH_CRC: 2, HASH_CHECKSUM: 4}[hash_type]
    hashes = [payload[1 + i * size:1 + (i + 1) * size]
              for i in range((len(payload) - 1) // size)]
    return hash_type, hashes
