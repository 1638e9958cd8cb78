"""The host route of the port on the CPU (Config.ctu_size = 32): no
pipeline is built and every frame is coded intra by the Python
IntraFrameEncoder, then deblocked on the host, as kvazaar_tpu/api.py
routes CTB 32 (use_device False).

- Streams at 120x72 (2 frames, deblocking on; --wpp --slices wpp; md5
  hashes; --bitrate, coded frame by frame) byte-identical to the JAX
  package's run live (its host route compiles nothing), each decoding
  hash-exactly in the port's decoder with the reconstruction it reports.
- capi.py with owf 2 gives the JAX package's capi stream.
- The encoder builds no pipeline, pads to 8, and needs no CUDA device.

Tolerances: 0 (streams, planes).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.torch_goldens import grid_frames  # noqa: E402
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder  # noqa: E402

W, H = 120, 72
CASES = {
    "intra": dict(),
    "wpp_slices": dict(wpp=True, slices="wpp"),
    "md5": dict(hash="md5", deblock_beta=2, deblock_tc=-1),
    "bitrate": dict(target_bitrate=400_000),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, name):
    return mod.Config(width=W, height=H, qp=30, ctu_size=32, **CASES[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ctu32_stream_matches_reference(name):
    import kvazaar_tpu.api as ref_api
    import kvazaar_tpu.cfg as ref_cfg
    import kvazaar_tpu_torch.cfg as cfg_mod
    frames = grid_frames(2, W, H)
    want, want_infos = ref_api.encode_sequence(_cfg(ref_cfg, name), frames)
    got, infos = encode_sequence(_cfg(cfg_mod, name), frames, device="cpu")
    assert got == want
    assert [i["qp"] for i in infos] == [i["qp"] for i in want_infos]
    assert [i["slice_type"] for i in infos] == [2, 2]
    pics = HEVCDecoder().decode(got)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)
    for p, info, ref in zip(pics, infos, want_infos):
        for a, b, c in zip(p.planes, info["recon_out"], ref["recon_out"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, np.asarray(c))
        np.testing.assert_allclose(info["psnr"], ref["psnr"], rtol=0,
                                   atol=1e-9)
    if name == "wpp_slices":
        assert infos[0]["slices"] == 3     # a segment a CTB row


def test_ctu32_builds_no_pipeline():
    enc = Encoder(Config(width=W, height=H, ctu_size=32, gop_len=0),
                  device="cuda")       # nothing runs on the device
    assert enc._pipeline is None
    assert not (enc.use_device or enc.use_md or enc.inter_enabled)
    assert (enc.sps.width, enc.sps.height) == (W, H)
    assert enc.sps.ctb_size == 32
    with pytest.raises(NotImplementedError, match="SAO"):
        Encoder(Config(width=W, height=H, ctu_size=32, sao_type="full"),
                device="cpu")


def _capi_stream(api_mod, cfg, frames, **kw) -> bytes:
    api = api_mod.kvz_api_get(8)
    enc = api.encoder_open(cfg, **kw)
    out = bytearray()
    for y, cb, cr in frames:
        pic = api.picture_alloc(W, H)
        pic.y[:], pic.u[:], pic.v[:] = y, cb, cr
        out += api.encoder_encode(enc, pic)[0]
    while True:
        data, _, _ = api.encoder_encode(enc, None)
        if not data:
            break
        out += data
    return bytes(out)


def test_capi_ctu32_matches_reference():
    import kvazaar_tpu.capi as ref_capi
    import kvazaar_tpu.cfg as ref_cfg
    import kvazaar_tpu_torch.capi as capi
    import kvazaar_tpu_torch.cfg as cfg_mod
    frames = grid_frames(3, W, H)
    cfgs = []
    for mod in (ref_cfg, cfg_mod):
        c = _cfg(mod, "bitrate")
        c.owf = 2
        cfgs.append(c)
    want = _capi_stream(ref_capi, cfgs[0], frames)
    got = _capi_stream(capi, cfgs[1], frames, device="cpu")
    assert got == want
    pics = HEVCDecoder().decode(got)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)
