"""WPP of the port on the CPU, with frame-level rate control on inter
frames (tools/torch_goldens.py RC_CONFIGS "wpp_rc" and "gop_oba",
tests/data/torch_golden_rc.npz; live JAX twins are marked `slow`).

- kvazaar_tpu_torch.api encodes, at 192x128 (3x2 CTBs) through
  encode_sequence: the default configuration with --wpp --bitrate (lambda
  RC, IDR + 3 B, a substream a CTB row from both native writers), and
  --gop 4 --wpp --slices wpp with OBA RC and the intra bit allocation (6
  frames: the pyramid's layers in the RC; a slice segment a CTB row, the
  later ones dependent, through the Python writers). Each stream is
  byte-identical to the JAX package's, with equal maps and frame QPs, and
  decodes hash-exactly.
- WPP changes nothing on the device: B-frame maps with and without --wpp
  are equal (ROADMAP.md queue 3).
- The CLI with --wpp --bitrate codes the golden's stream.

Tolerances: 0 (maps, planes, QPs, streams).
"""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from test_torch_rc import check_against_golden  # noqa: E402
from tools.torch_goldens import (RC_BITRATE, RC_H, RC_KEYS, RC_W,  # noqa
                                 jax_gop_stream, rc_case_frames, rc_config)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402

WPP_CASES = ("wpp_rc", "gop_oba")
_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_run(name: str, **over):
    """(stream, per coded frame maps, infos, encoder) of the port on the
    CPU through encode_sequence, once per configuration: the RC_CONFIGS
    entry with the Config options `over` on top."""
    key = (name, tuple(sorted(over.items())))
    if key not in _RUNS:
        enc = Encoder(Config(width=RC_W, height=RC_H,
                             **dict(rc_config(name, ""), **over)),
                      device="cpu")
        decs = []
        finalize = enc.finalize_frame

        def record(meta):
            out = finalize(meta)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in RC_KEYS})
            return out
        enc.finalize_frame = record
        stream, infos = encode_sequence(enc.cfg, rc_case_frames(name),
                                        encoder=enc)
        _RUNS[key] = (stream, decs, infos, enc)
    return _RUNS[key]


@pytest.mark.parametrize("name", WPP_CASES)
def test_wpp_stream_byte_identical_to_reference(name):
    check_against_golden(name, *port_run(name)[:3])


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", WPP_CASES)
def test_wpp_stream_decodes_hash_exact(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, infos, _ = port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


def test_wpp_substreams_and_writers():
    """--wpp codes a substream a CTB row in one slice through the native
    writers (entry points in the slice header); --slices wpp codes a slice
    segment a row through the Python writers; both code B slices (and P
    anchors in the pyramid) under moving frame QPs."""
    rows = RC_H // 64
    _, _, infos, enc = port_run("wpp_rc")
    assert [(i["substreams"], i["slices"]) for i in infos] == \
        [(rows, 1)] * len(infos)
    assert enc.native_slices == len(infos)
    assert enc.pps.entropy_coding_sync_enabled
    assert not enc.pps.dependent_slice_segments_enabled
    assert [i["slice_type"] for i in infos] == [2, 0, 0, 0]
    _, _, infos, enc = port_run("gop_oba")
    assert [(i["substreams"], i["slices"]) for i in infos] == \
        [(rows, rows)] * len(infos)
    assert enc.native_slices == 0
    assert enc.pps.dependent_slice_segments_enabled
    assert sorted({i["slice_type"] for i in infos}) == [0, 1, 2]
    for name in WPP_CASES:
        assert len({i["qp"] for i in port_run(name)[2]}) > 1, name


def test_wpp_changes_no_b_frame_maps():
    """WPP changes only the entropy coding: at constant QP the maps of
    every frame (IDR and B) with --wpp equal those without it, while the
    streams differ (ROADMAP.md queue 3)."""
    with_wpp = port_run("wpp_rc", target_bitrate=0)
    without = port_run("wpp_rc", target_bitrate=0, wpp=False)
    assert with_wpp[0] != without[0]
    assert [i["slice_type"] for i in with_wpp[2]] == [2, 0, 0, 0]
    for a, b in zip(with_wpp[1], without[1]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_slices_wpp_requires_wpp():
    with pytest.raises(ValueError, match="requires --wpp"):
        Encoder(Config(width=RC_W, height=RC_H, slices="wpp"),
                device="cpu")


def test_cli_wpp_bitrate(tmp_path):
    """python -m kvazaar_tpu_torch --wpp --bitrate codes the golden's
    "wpp_rc" stream (the CLI's loop queues frame N+1 before coding frame
    N, as encode_sequence does)."""
    from kvazaar_tpu_torch.__main__ import main
    from test_torch_rc import _golden
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.hevc"
    yuv.write_bytes(b"".join(p.tobytes() for f in rc_case_frames("wpp_rc")
                             for p in f))
    assert main(["-i", str(yuv), "--input-res", f"{RC_W}x{RC_H}", "-o",
                 str(out), "--wpp", "--bitrate", str(RC_BITRATE),
                 "--device", "cpu"]) == 0
    assert out.read_bytes() == _golden()["wpp_rc_stream"].tobytes()


@pytest.mark.slow
@pytest.mark.parametrize("name", WPP_CASES)
def test_wpp_stream_matches_jax_live(name):
    stream, decs, infos, _ = port_run(name)
    want, wdecs, plan = jax_gop_stream(rc_case_frames(name), RC_KEYS,
                                       **rc_config(name, ""))
    assert [i["qp"] for i in infos] == [p["qp"] for p in plan]
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want

