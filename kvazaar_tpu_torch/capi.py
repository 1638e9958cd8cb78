"""kvz_api-shaped public interface of the PyTorch/CUDA port.

The reference library's surface (src/kvazaar.h `kvz_api` vtable:
config_alloc/init/parse/destroy, picture_alloc/free,
encoder_open/close/headers/encode, chunk handling) with its 1-in/<=1-out
pipelined contract (src/kvazaar.c:238-308): `encoder_encode` may buffer
the picture and return data for an earlier one; feed None (pic_in ==
NULL) to drain. Without a B pyramid the ring holds `owf` submitted
frames whose device work runs while an earlier frame is entropy coded;
with one (--gop 2/4/8/16) the pictures go through `Encoder.push_frame`,
which returns nothing until a span is complete, and the drain codes the
tail through `Encoder.flush`. Under rate control a frame's QP is chosen
when it enters the ring, before the bits of the frames still in it are
known, as in the reference.

`api.Encoder` stays the idiomatic interface underneath; every type here
is plain (bytes, ndarray, dataclass). The encoder runs on `device`
("cuda" unless the caller asks for "cpu"), and raises without a card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .api import Encoder
from .cfg import Config


@dataclass
class KvzPicture:
    """kvz_picture analog: planar 4:2:0 buffers and metadata."""
    width: int
    height: int
    bit_depth: int = 8
    y: np.ndarray = None
    u: np.ndarray = None
    v: np.ndarray = None
    pts: int = 0

    def __post_init__(self):
        dt = np.uint8 if self.bit_depth == 8 else np.uint16
        if self.y is None:
            self.y = np.zeros((self.height, self.width), dt)
            self.u = np.zeros((self.height // 2, self.width // 2), dt)
            self.v = np.zeros((self.height // 2, self.width // 2), dt)


@dataclass
class KvzFrameInfo:
    """kvz_frame_info analog (poc, qp, nal type, psnr)."""
    poc: int = 0
    qp: int = 0
    nal_unit_type: int = 0
    psnr: tuple = (0.0, 0.0, 0.0)


class KvzEncoder:
    """kvz_encoder analog: the encoder and its 1-in/N-out ring."""

    def __init__(self, cfg: Config, device="cuda") -> None:
        self.enc = Encoder(cfg, device=device)
        self.cfg = cfg
        self._pending = []        # coded (bytes, info) not yet returned
        self._meta_q = []         # submitted device work (the OWF ring)
        self._frames_in = 0
        self._frames_out = 0


class KvzApi:
    """The kvz_api vtable as a plain object; `kvz_api_get()` returns one
    instance (the bit depth rides the config)."""

    # -- config ----------------------------------------------------------

    def config_alloc(self) -> Config:
        return Config()

    def config_init(self, cfg: Config) -> Config:
        return cfg  # the dataclass defaults are kvz_config_init's

    def config_destroy(self, cfg: Config) -> None:
        pass

    def config_parse(self, cfg: Config, name: str, value) -> bool:
        try:
            cfg.parse(name, value)
            return True
        except (KeyError, ValueError):
            return False

    # -- pictures --------------------------------------------------------

    def picture_alloc(self, width: int, height: int,
                      bit_depth: int = 8) -> KvzPicture:
        return KvzPicture(width, height, bit_depth)

    def picture_free(self, pic: KvzPicture) -> None:
        pass

    def chunk_free(self, chunk) -> None:
        pass

    # -- encoder ---------------------------------------------------------

    def encoder_open(self, cfg: Config, device="cuda") -> KvzEncoder:
        return KvzEncoder(cfg, device=device)

    def encoder_close(self, enc: KvzEncoder) -> None:
        enc._pending.clear()
        enc._meta_q.clear()

    def encoder_headers(self, enc: KvzEncoder) -> bytes:
        return enc.enc.headers()

    def encoder_encode(self, enc: KvzEncoder, pic_in: KvzPicture | None):
        """Feed one picture (or None to drain). Returns (data_out: bytes,
        pic_out: KvzPicture | None, info: KvzFrameInfo | None): at most
        one coded picture a call, empty data while the pipeline fills."""
        e = enc.enc
        if e.gop_enabled:
            if pic_in is not None:
                enc._pending.extend(
                    e.push_frame(pic_in.y, pic_in.u, pic_in.v))
                enc._frames_in += 1
            elif enc._frames_out < enc._frames_in and not enc._pending:
                enc._pending.extend(e.flush())
        else:
            if pic_in is not None:
                # submit this frame's device work now, entropy code an
                # earlier frame meanwhile
                enc._meta_q.append(
                    e.submit_frame(pic_in.y, pic_in.u, pic_in.v))
                enc._frames_in += 1
                if len(enc._meta_q) > max(0, enc.cfg.owf):
                    enc._pending.append(
                        e.finalize_frame(enc._meta_q.pop(0)))
            elif enc._meta_q:
                enc._pending.append(e.finalize_frame(enc._meta_q.pop(0)))
        if not enc._pending:
            return b"", None, None
        data, info = enc._pending.pop(0)
        enc._frames_out += 1
        rec = info["recon_out"]
        pic_out = KvzPicture(rec[0].shape[1], rec[0].shape[0],
                             enc.cfg.input_bitdepth,
                             y=np.asarray(rec[0]), u=np.asarray(rec[1]),
                             v=np.asarray(rec[2]))
        fi = KvzFrameInfo(poc=info["poc"], qp=info["qp"],
                          psnr=tuple(info["psnr"]))
        return data, pic_out, fi


_API = KvzApi()


def kvz_api_get(bit_depth: int = 8) -> KvzApi:
    """kvz_api_get analog (src/kvazaar.h); the bit depth rides the
    config (`input_bitdepth`), not separate builds."""
    return _API
