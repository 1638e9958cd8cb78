"""Selective encryption of the port on the CPU (--crypto, --key;
tools/torch_goldens.py EXTRA_CONFIGS, tests/data/torch_golden_extras.npz;
live JAX twins are marked `slow`).

- kvazaar_tpu_torch.api encodes through encode_sequence, byte-identical to
  the JAX package with equal maps: the three intra features
  (intra_pred_modes+trans_coeffs+trans_coeff_signs) on one 128x128 frame,
  and every feature (--crypto on) on IDR + 2 B at 128x64, whose B frames
  the Python writers code with the encrypted motion vectors.
- Each stream decodes hash-exactly with the key in both packages'
  decoders, and parses without it into pictures that miss their hash.
- A malformed --key raises ValueError in both packages.
- capi.py (encoder_open / encoder_encode) codes the golden's crypto and
  tile streams.

This module also holds the helpers of tests/test_torch_field.py and
tests/test_torch_tiles.py: the port's run of an EXTRA_CONFIGS entry and
its check against the golden.

Tolerances: 0 (maps, planes, streams).
"""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import smoke_key as key_bytes  # noqa: E402
from tools.torch_goldens import (EXTRA_CONFIGS, EXTRA_KEYS,  # noqa: E402
                                 OUT_EXTRAS, extra_frames, jax_extra_stream)
from kvazaar_tpu_torch.api import (Encoder, encode_sequence,  # noqa: E402
                                   field_config)
from kvazaar_tpu_torch.cfg import Config  # noqa: E402

CRYPTO_CASES = ("crypto_intra", "crypto_on")
_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden():
    return np.load(OUT_EXTRAS)


def extra_config(name: str, **over) -> Config:
    """The frame Config of an EXTRA_CONFIGS entry, with `over` on top."""
    frames = extra_frames(name)
    h, w = frames[0][0].shape
    return Config(width=w, height=h, **dict(EXTRA_CONFIGS[name][0], **over))


def port_extra_run(name: str, **over):
    """(stream, per coded frame maps, infos, encoder) of the port on the
    CPU through encode_sequence, once per configuration: the
    EXTRA_CONFIGS entry with the Config options `over` on top (field
    coding's encoder built on the field configuration)."""
    key = (name, tuple(sorted(over.items())))
    if key not in _RUNS:
        cfg = extra_config(name, **over)
        enc = Encoder(field_config(cfg), device="cpu")
        decs = []
        finalize = enc.finalize_frame

        def record(meta):
            out = finalize(meta)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in EXTRA_KEYS})
            return out
        enc.finalize_frame = record
        stream, infos = encode_sequence(cfg, extra_frames(name),
                                        encoder=enc)
        _RUNS[key] = (stream, decs, infos, enc)
    return _RUNS[key]


def check_extra(name: str, skip=()) -> None:
    """The port's stream and every coded frame's maps equal the golden's
    (the JAX package's); maps in `skip` are left out."""
    stream, decs, _, _ = port_extra_run(name)
    g = golden()
    n = sum(1 for i in range(64) if f"{name}_f{i}_hash" in g.files)
    assert len(decs) == n
    for i, d in enumerate(decs):
        held = {k for k in EXTRA_KEYS if f"{name}_f{i}_{k}" in g.files}
        assert held - set(skip) <= set(d), f"frame {i}: {sorted(d)}"
        for k in sorted(held - set(skip)):
            np.testing.assert_array_equal(
                d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    if not skip:
        assert stream == g[f"{name}_stream"].tobytes()


def decoder_of(package: str, **kw):
    return importlib.import_module(
        package + ".decoder.decoder").HEVCDecoder(**kw)


@pytest.mark.parametrize("name", CRYPTO_CASES)
def test_crypto_stream_byte_identical_to_reference(name):
    check_extra(name)


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", CRYPTO_CASES)
def test_crypto_decodes_hash_exact_with_key(name, decoder):
    stream, _, infos, _ = port_extra_run(name)
    pics = decoder_of(decoder, crypto=EXTRA_CONFIGS[name][0]["crypto"],
                      crypto_key=key_bytes()).decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CRYPTO_CASES)
def test_crypto_parses_garbled_without_key(name):
    """A decoder without the key parses every picture (the scheme keeps
    the syntax), but reconstructs other samples: some picture misses its
    hash. With the wrong key as well."""
    stream, _, infos, _ = port_extra_run(name)
    for kw in ({}, dict(crypto=EXTRA_CONFIGS[name][0]["crypto"],
                        crypto_key=bytes(16))):
        pics = decoder_of("kvazaar_tpu_torch", **kw).decode(stream)
        assert len(pics) == len(infos)
        assert not all(p.hash_ok for p in pics)


def test_crypto_routes_every_slice_to_the_python_writers():
    """Encryption hooks live in the Python writers only: no slice of an
    encrypted stream is coded natively, and crypto_on's B frames are B
    slices (both kernels' path)."""
    for name in CRYPTO_CASES:
        _, _, infos, enc = port_extra_run(name)
        assert enc.native_slices == 0
    assert [i["slice_type"] for i in port_extra_run("crypto_on")[2]] == \
        [2, 0, 0]


@pytest.mark.parametrize("key", ["1,2,3", "1,2,3,4,5,6,7,8,9,10,11,12,13,"
                                 "14,15,16,17", "a,b,c,d,e,f,g,h,i,j,k,l,m,"
                                 "n,o,p"])
def test_malformed_key_raises_as_reference(key):
    from kvazaar_tpu.api import Encoder as RefEncoder
    from kvazaar_tpu.cfg import Config as RefConfig
    kw = dict(width=128, height=64, crypto="on", crypto_key=key)
    with pytest.raises(ValueError):
        RefEncoder(RefConfig(**kw))
    with pytest.raises(ValueError):
        Encoder(Config(**kw), device="cpu")


def capi_stream(name: str) -> bytes:
    """The EXTRA_CONFIGS entry's frames through capi.py's encoder_open /
    encoder_encode on the CPU (owf 1), drained with None."""
    from kvazaar_tpu_torch.capi import KvzPicture, kvz_api_get
    api = kvz_api_get()
    cfg = extra_config(name)
    cfg.owf = 1
    enc = api.encoder_open(cfg, device="cpu")
    out = b""
    for y, cb, cr in extra_frames(name):
        pic = KvzPicture(cfg.width, cfg.height, y=y, u=cb, v=cr)
        out += api.encoder_encode(enc, pic)[0]
    while True:
        data, pic_out, _ = api.encoder_encode(enc, None)
        out += data
        if pic_out is None:
            break
    api.encoder_close(enc)
    return out


@pytest.mark.parametrize("name", ["crypto_on", "tiles", "tiles_crypto"])
def test_capi_codes_crypto_and_tiles(name):
    assert capi_stream(name) == golden()[f"{name}_stream"].tobytes()


@pytest.mark.slow
def test_crypto_intra_live_against_jax():
    stream, decs = jax_extra_stream("crypto_intra")
    got, gdecs, _, _ = port_extra_run("crypto_intra")
    assert got == stream
    for k in decs[0]:
        np.testing.assert_array_equal(gdecs[0][k], decs[0][k], err_msg=k)
