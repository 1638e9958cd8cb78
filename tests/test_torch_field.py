"""Field coding of the port on the CPU (--source-scan-type tff|bff;
tools/torch_goldens.py EXTRA_CONFIGS "tff", "bff" and "tff_frames",
tests/data/torch_golden_extras.npz).

- encode_sequence codes each 128x128 frame as two 128x64 field pictures,
  the even lines first with tff and the odd lines first with bff (IDR +
  3 B), byte-identical to the JAX package with equal maps; each stream
  decodes hash-exactly to 64-line pictures in both packages' decoders.
- The SPS signals field_seq_flag and an interlaced source; every
  picture carries a pic_timing SEI whose pic_struct alternates top (1)
  and bottom (2) in the field order.
- Frames of 72 lines make fields of 36, which pad to the CTB: the port
  codes them, where the JAX package's split refuses them (ROADMAP.md
  queue 3).
- The CLI and capi.py do not split frames into fields, as the JAX
  package's do not (they call submit_frame): they code whole frames under
  the field SPS, the golden's "tff_frames" stream (ROADMAP.md queue 3).

Tolerances: 0 (maps, planes, streams).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import mixed_frames, pic_structs  # noqa: E402
from test_torch_crypto import (capi_stream, check_extra,  # noqa: E402
                               decoder_of, golden, port_extra_run)
from tools.torch_goldens import extra_frames  # noqa: E402
from kvazaar_tpu_torch.api import encode_sequence  # noqa: E402
from kvazaar_tpu_torch.bitstream import (NAL_PREFIX_SEI,  # noqa: E402
                                         NAL_SPS, ebsp_to_rbsp,
                                         split_annexb)
from kvazaar_tpu_torch.cfg import Config  # noqa: E402

# the CLI and dryrun subprocesses: one intra-op thread, as the fixtures
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")

FIELD_CASES = ("tff", "bff")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FIELD_CASES)
def test_field_stream_byte_identical_to_reference(name):
    check_extra(name)


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", FIELD_CASES)
def test_field_stream_decodes_hash_exact(name, decoder):
    stream, _, infos, _ = port_extra_run(name)
    pics = decoder_of(decoder).decode(stream)
    assert len(pics) == 4 == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        assert p.planes[0].shape == (64, 128)
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)
    assert [i["slice_type"] for i in infos] == [2, 0, 0, 0]


def _sps_rbsp(stream: bytes) -> bytes:
    return next(ebsp_to_rbsp(e) for t, _, e in split_annexb(stream)
                if t == NAL_SPS)


def _sps(stream: bytes):
    from kvazaar_tpu_torch.hevc.headers import parse_sps
    return parse_sps(_sps_rbsp(stream))


@pytest.mark.parametrize("name", FIELD_CASES)
def test_field_sps_and_pic_timing(name):
    """The stream's SPS is the encoder's, whose VUI field_seq_flag is set
    (it differs from the same SPS with the flag clear), with an
    interlaced, not progressive, source in its profile-tier-level."""
    import copy
    from kvazaar_tpu_torch.hevc.headers import write_sps
    stream, _, _, enc = port_extra_run(name)
    assert enc.sps.field_seq_flag == 1
    assert _sps_rbsp(stream) == write_sps(enc.sps)
    progressive = copy.deepcopy(enc.sps)
    progressive.field_seq_flag = 0
    assert write_sps(progressive) != write_sps(enc.sps)
    ptl = _sps(stream).ptl
    assert (ptl.general_interlaced_source_flag,
            ptl.general_progressive_source_flag,
            ptl.general_frame_only_constraint_flag) == (1, 0, 0)
    top, bottom = 1, 2
    first = top if name == "tff" else bottom
    second = bottom if name == "tff" else top
    assert pic_structs(stream) == [first, second] * 2


def test_field_order_follows_scan_type():
    """tff codes the even lines first, bff the odd lines: bff's first
    field is tff's second source field, so its IDR equals the IDR of a
    tff encode of the frame with its lines swapped in pairs."""
    frames = extra_frames("tff")[:1]
    y, cb, cr = frames[0]
    swapped = [tuple(np.ascontiguousarray(
        p.reshape(-1, 2, p.shape[1])[:, ::-1].reshape(p.shape))
        for p in (y, cb, cr))]
    cfg = dict(width=128, height=128)
    bff, _ = encode_sequence(Config(source_scan_type="bff", **cfg), frames,
                             device="cpu")
    tff, _ = encode_sequence(Config(source_scan_type="tff", **cfg),
                             swapped, device="cpu")
    # the same two pictures; only the pic_timing SEIs' parities differ
    assert pic_structs(bff) == [2, 1] and pic_structs(tff) == [1, 2]
    strip = [(t, e) for t, _, e in split_annexb(bff) if t != NAL_PREFIX_SEI]
    assert strip == [(t, e) for t, _, e in split_annexb(tff)
                     if t != NAL_PREFIX_SEI]


def test_field_of_36_lines_pads_to_the_ctb():
    """A frame of 72 lines gives fields of 36: the JAX package's split
    refuses them (Config.validate wants multiples of 8 of the field), the
    port validates the frame and pads each field to 64 lines with a
    conformance window (ROADMAP.md queue 3)."""
    from kvazaar_tpu.api import encode_sequence as ref_encode_sequence
    from kvazaar_tpu.cfg import Config as RefConfig
    frames = mixed_frames(1, 128, 72)
    with pytest.raises(ValueError, match="multiples of 8"):
        ref_encode_sequence(RefConfig(width=128, height=72,
                                      source_scan_type="tff"), frames)
    stream, infos = encode_sequence(
        Config(width=128, height=72, source_scan_type="tff"), frames,
        device="cpu")
    pics = decoder_of("kvazaar_tpu_torch").decode(stream)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)
    assert [p.planes[0].shape for p in pics] == [(36, 128)] * 2
    assert _sps(stream).conf_win == (0, 0, 0, 14)
    with pytest.raises(ValueError, match="multiples of 8"):
        encode_sequence(Config(width=128, height=68,
                               source_scan_type="tff"), frames, device="cpu")


def test_field_cli_codes_whole_frames():
    """python -m kvazaar_tpu_torch --source-scan-type tff codes each frame
    whole under the field SPS (the JAX CLI calls submit_frame and never
    splits), the golden's tff_frames stream."""
    import tempfile
    frames = extra_frames("tff_frames")
    with tempfile.TemporaryDirectory() as tmp:
        yuv, out = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "o.hevc")
        with open(yuv, "wb") as f:
            for p in frames:
                f.write(b"".join(a.tobytes() for a in p))
        r = subprocess.run(
            [sys.executable, "-m", "kvazaar_tpu_torch", "-i", yuv,
             "--input-res", "128x64", "-o", out, "--source-scan-type",
             "tff", "--device", "cpu"], cwd=ROOT, env=ONE_THREAD,
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr
        stream = open(out, "rb").read()
    assert stream == golden()["tff_frames_stream"].tobytes()
    pics = decoder_of("kvazaar_tpu_torch").decode(stream)
    assert [p.planes[0].shape for p in pics] == [(64, 128)] * 2
    assert all(p.hash_ok for p in pics)


def test_field_capi_codes_whole_frames():
    assert capi_stream("tff_frames") == \
        golden()["tff_frames_stream"].tobytes()
