"""The port's kvz_api-shaped interface (kvazaar_tpu_torch/capi.py) on the
CPU: the reference library's contract (1-in/<=1-out pipelined encode,
drain with None), twin of tests/test_capi.py::test_capi_roundtrip, and
the B pyramid's branch (push_frame, then a drain through flush)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kvazaar_tpu_torch.capi import kvz_api_get  # noqa: E402
from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_capi_roundtrip(rng):
    api = kvz_api_get(8)
    cfg = api.config_alloc()
    assert api.config_parse(cfg, "qp", "30")
    assert api.config_parse(cfg, "period", "1")
    assert not api.config_parse(cfg, "no-such-option", "1")
    cfg.width = cfg.height = 128
    cfg.owf = 1
    enc = api.encoder_open(cfg, device="cpu")
    headers = api.encoder_headers(enc)
    assert headers[:4] in (b"\x00\x00\x00\x01",)

    n = 3
    pics = []
    for i in range(n):
        p = api.picture_alloc(128, 128)
        p.y[:] = rng.randint(0, 255, p.y.shape)
        p.u[:] = 128
        p.v[:] = rng.randint(0, 255, p.v.shape)
        pics.append(p)

    stream = bytearray()
    outs = 0
    returned = []
    for p in pics:
        data, pic_out, info = api.encoder_encode(enc, p)
        returned.append(bool(data))
        if data:
            outs += 1
            stream += data
            assert pic_out is not None and info is not None
    # with owf=1 the first call returns nothing (pipelining)
    assert returned == [False, True, True]
    while outs < n:
        data, pic_out, info = api.encoder_encode(enc, None)
        assert data
        stream += data
        outs += 1
    dec = HEVCDecoder().decode(bytes(stream))
    assert len(dec) == n and all(f.hash_ok for f in dec)
    api.encoder_close(enc)


def test_capi_gop8_buffers_spans_and_drains():
    """--gop 8: the IDR comes back at once, the next gop_len - 1 calls
    return no data until the span (P 8 with its seven B pictures) is
    complete, and a drain with None returns every remaining picture,
    the tail through flush; the stream decodes hash-exactly, with the
    returned pictures equal to the decoder's in coding order."""
    from tools.torch_goldens import H, W, gop_frames
    api = kvz_api_get(8)
    cfg = api.config_alloc()
    for name, value in (("qp", "30"), ("gop", "8"), ("period", "0")):
        assert api.config_parse(cfg, name, value)
    cfg.width, cfg.height = W, H
    enc = api.encoder_open(cfg, device="cpu")
    assert enc.enc.gop_enabled
    frames = gop_frames(10)
    got, returned = [], []
    for y, cb, cr in frames:
        pic = api.picture_alloc(W, H)
        pic.y[:], pic.u[:], pic.v[:] = y, cb, cr
        data, pic_out, info = api.encoder_encode(enc, pic)
        returned.append(bool(data))
        if data:
            got.append((data, pic_out, info))
    assert returned == [True] + [False] * 7 + [True, True]
    while True:
        data, pic_out, info = api.encoder_encode(enc, None)
        if not data:
            break
        got.append((data, pic_out, info))
    assert len(got) == len(frames)
    assert [i.poc for _, _, i in got] == [0, 8, 4, 2, 1, 3, 6, 5, 7, 9]
    dec = HEVCDecoder().decode(b"".join(d for d, _, _ in got))
    assert len(dec) == len(frames) and all(f.hash_ok for f in dec)
    for f, (_, pic_out, info) in zip(dec, got):
        assert f.poc == info.poc
        for a, b in zip(f.planes, (pic_out.y, pic_out.u, pic_out.v)):
            np.testing.assert_array_equal(a, b)
    api.encoder_close(enc)


def test_capi_targets_cuda_by_default():
    api = kvz_api_get(8)
    cfg = api.config_alloc()
    cfg.width, cfg.height = 128, 64
    if torch.cuda.is_available():
        assert api.encoder_open(cfg).enc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            api.encoder_open(cfg)
