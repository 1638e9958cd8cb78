"""Rate control and delta QP of the port on the CPU
(tools/torch_goldens.py RC_CONFIGS, tests/data/torch_golden_rc.npz; live
JAX twins are marked `slow`).

- kvazaar_tpu_torch.api encodes, at 192x128 (3x2 CTBs) through
  encode_sequence: -p 1 --bitrate --wpp (LCU rate control: a QP a CTB,
  the final-QP chain reset each CTB row, update_lcu), -p 1 --bitrate
  --rc-algorithm oba (update_oba), --vaq 8 --roi with SAO, RDOQ and sign
  hiding, and --vaq 8 --pu-depth-intra 0-4 --rd 3 (NxN cells, 64 leaves
  and the rd ladder under per-CTB QPs). Each stream is byte-identical to
  the JAX package's, with equal maps and final per-CTB QPs (`qp_ctb`) and
  equal frame QPs, and decodes hash-exactly.
- The intra stages under a non-uniform QP map against the JAX package's
  outputs: _leaf_rd at --rd 0 and 2, _leaf_rd4, _leaf_rd64, _partition,
  the partition and reconstruction with RDOQ and sign hiding, the
  final-QP chain with and without WPP; deblock_frame_torch with a QP a
  4x4 block against the numpy oracle ops/deblock.py.
- capi.py with --bitrate (owf 2) codes the JAX package's capi stream.
- The reference's behaviour that the port keeps (ROADMAP.md queue 3):
  frame N+1's QP is chosen before frame N's bits are known, so the QPs
  of the pipelined encode are not those of a frame-by-frame one; LCU
  rate control and delta QP stay off on inter configurations; no-rc
  keeps the QP constant with a bitrate set.

Tolerances: 0 for integers, maps, planes, QPs and streams; rtol 1e-5 for
float32 costs.
"""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.torch_goldens import (OUT_RC as GOLDEN, RC_BITRATE,  # noqa
                                 RC_CAPI_FRAMES, RC_CONFIGS, RC_H, RC_KEYS,
                                 RC_W, STAGE_QP, STAGE_QPMAP, capi_stream,
                                 dq_levels, intra_frames, jax_gop_stream,
                                 rc_case_frames, rc_config, rc_frames)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.models.intra_md import MdIntraPipeline  # noqa: E402

RC_CASES = ("lcu_rc", "lcu_oba", "vaq_roi", "vaq_leaves")
RTOL = 1e-5
_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roi_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("roi") / "roi.txt")


def _golden():
    return np.load(GOLDEN)


def port_run(name: str, roi: str):
    """(stream, per coded frame maps, infos) of the port on the CPU
    through encode_sequence, once per RC_CONFIGS entry."""
    if name not in _RUNS:
        enc = Encoder(Config(width=RC_W, height=RC_H,
                             **rc_config(name, roi)), device="cpu")
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
        _RUNS[name] = (stream, decs, infos)
    return _RUNS[name]


def check_against_golden(name: str, stream, decs, infos) -> None:
    """The stream, every coded frame's maps (qp_ctb included where the
    golden holds it) and the frame QPs equal the golden's."""
    import json
    g = _golden()
    plan = json.loads(str(g[f"{name}_plan"]))
    assert len(decs) == len(plan)
    assert [i["qp"] for i in infos] == [p["qp"] for p in plan]
    for i, d in enumerate(decs):
        held = {k for k in RC_KEYS if f"{name}_f{i}_{k}" in g.files}
        assert set(d) == held, f"frame {i}: port maps {sorted(d)}"
        for k in sorted(held):
            np.testing.assert_array_equal(
                d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    assert stream == g[f"{name}_stream"].tobytes()


@pytest.mark.parametrize("name", RC_CASES)
def test_rc_stream_byte_identical_to_reference(name, roi_path):
    check_against_golden(name, *port_run(name, roi_path))
    # every frame of these configurations codes a QP a CTB
    assert all("qp_ctb" in d for d in port_run(name, roi_path)[1])


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", RC_CASES)
def test_rc_stream_decodes_hash_exact(name, decoder, roi_path):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, infos = port_run(name, roi_path)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", RC_CASES)
def test_rc_qp_maps_are_not_uniform(name, roi_path):
    """The cases exercise delta QP: some frame's final CTB QPs differ
    from one another (LCU RC, ROI and VAQ offsets)."""
    decs = port_run(name, roi_path)[1]
    assert any(len(np.unique(d["qp_ctb"])) > 1 for d in decs)


def test_rc_qps_move_and_lag_one_frame(roi_path):
    """Pinned reference behaviour (ROADMAP.md queue 3, "the RC lag"): in
    encode_sequence frame N+1's QP is chosen before frame N's bits update
    the model, so the QPs differ from a frame-by-frame encode's (submit,
    then finalize, each frame) after the first; the pipelined QPs are the
    golden's (test_rc_stream_byte_identical_to_reference), and they
    move."""
    _, _, infos = port_run("lcu_rc", roi_path)
    piped = [i["qp"] for i in infos]
    assert len(set(piped)) > 1
    enc = Encoder(Config(width=RC_W, height=RC_H,
                         **rc_config("lcu_rc", roi_path)), device="cpu")
    serial = [enc.encode_frame(*f)[1]["qp"]
              for f in rc_case_frames("lcu_rc")]
    assert serial[0] == piped[0]
    assert serial != piped


def test_capi_bitrate_matches_reference():
    """capi.py with -p 1 --bitrate --wpp and owf = 2 (frames submitted two
    ahead of their entropy coding) codes the JAX package's capi stream
    with its QPs."""
    from kvazaar_tpu_torch.capi import kvz_api_get
    g = _golden()
    stream, qps = capi_stream(kvz_api_get(8), rc_frames(RC_CAPI_FRAMES),
                              device="cpu")
    assert qps == g["capi_qps"].tolist()
    assert stream == g["capi_stream"].tobytes()
    assert len(set(qps)) > 1


def test_lcu_rc_and_delta_qp_stay_off_on_inter():
    """Pinned reference behaviour (ROADMAP.md queue 3): with --bitrate on
    an inter configuration rate control sets a QP a frame only; the PPS
    codes no cu_qp_delta, and OBA runs at frame level."""
    for algo in ("lambda", "oba"):
        enc = Encoder(Config(width=RC_W, height=RC_H,
                             target_bitrate=RC_BITRATE, rc_algorithm=algo),
                      device="cpu")
        assert enc.inter_enabled and not enc.lcu_rc
        assert not enc.dqp_enabled and not enc.pps.cu_qp_delta_enabled
        assert not enc._pipeline.delta_qp
        assert type(enc._rc).__name__ == {"lambda": "RateControl",
                                          "oba": "OBARateControl"}[algo]


def test_no_rc_keeps_constant_qp():
    """--rc-algorithm no-rc with a bitrate codes at constant QP, as the
    reference does."""
    cfg = Config(width=RC_W, height=RC_H, qp=30, intra_period=1,
                 target_bitrate=RC_BITRATE, rc_algorithm="no-rc")
    enc = Encoder(cfg, device="cpu")
    assert enc._rc is None
    _, infos = encode_sequence(cfg, rc_frames(2), encoder=enc)
    assert [i["qp"] for i in infos] == [30, 30]


def test_cli_lcu_rc_and_vaq_roi(tmp_path, roi_path):
    """python -m kvazaar_tpu_torch codes the goldens of -p 1 --bitrate
    --wpp and --vaq 8 --roi with the tool row."""
    from kvazaar_tpu_torch.__main__ import main
    g = _golden()
    cases = {"lcu_rc": ["-p", "1", "--bitrate", str(RC_BITRATE), "--wpp",
                        "--qp", "22"],
             "vaq_roi": ["--vaq", "8", "--roi", roi_path, "--sao", "full",
                         "--rdoq", "--signhide"]}
    for name, flags in cases.items():
        rc_config(name, roi_path)          # writes the ROI map
        yuv, out = tmp_path / f"{name}.yuv", tmp_path / f"{name}.hevc"
        yuv.write_bytes(b"".join(p.tobytes() for f in rc_case_frames(name)
                                 for p in f))
        assert main(["-i", str(yuv), "--input-res", f"{RC_W}x{RC_H}",
                     "-o", str(out), "--device", "cpu"] + flags) == 0
        assert out.read_bytes() == g[f"{name}_stream"].tobytes(), name


# ---------------------------------------------------------------------
# stages under a non-uniform QP map
# ---------------------------------------------------------------------

def _src():
    return [torch.from_numpy(p.astype(np.int32))
            for p in intra_frames("halfflat", 1, RC_W, RC_H)[0]]


def _pipe(**kw):
    """A delta-QP pipeline whose constants hold STAGE_QPMAP."""
    from kvazaar_tpu_torch.models.intra_md import consts_from_numpy
    pipe = MdIntraPipeline(RC_H, RC_W, STAGE_QP, delta_qp=True,
                           device="cpu", **kw)
    consts = dict(pipe._consts_for(None))
    consts.update(consts_from_numpy(pipe.qp_map_arrays(STAGE_QPMAP),
                                    pipe.device))
    pipe.set_consts(consts)
    return pipe


def _cmp_cost(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, err_msg=what)


def test_stage_qp_map_is_not_uniform():
    assert len(np.unique(STAGE_QPMAP)) > 2
    assert (_golden()["dq_fq"] != STAGE_QP).any()


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("rd", [0, 2])
def test_dq_leaf_rd_matches_reference(rd, n):
    g = _golden()
    modes, cost = _pipe(rd=rd)._leaf_rd(*_src(), n)
    np.testing.assert_array_equal(modes.numpy(),
                                  g[f"dq_leafrd{rd}_{n}_modes"])
    _cmp_cost(cost, g[f"dq_leafrd{rd}_{n}_cost"], f"rd {rd} n {n}")


def test_dq_leaf_rd4_and_rd64_match_reference():
    g = _golden()
    pipe = _pipe(pu_depth=(0, 4))
    m4, c4 = pipe._leaf_rd4(*_src())
    np.testing.assert_array_equal(m4.numpy(), g["dq_leaf4_modes"])
    _cmp_cost(c4, g["dq_leaf4_cost"], "leaf4")
    m64, c64 = pipe._leaf_rd64(*_src())
    np.testing.assert_array_equal(m64.numpy(), g["dq_leaf64_modes"])
    _cmp_cost(c64, g["dq_leaf64_cost"], "leaf64")


def test_dq_partition_matches_reference():
    g = _golden()
    for k, v in zip(("size_map8", "mode_map8", "mode_map4"),
                    _pipe(pu_depth=(0, 4))._partition(*_src())):
        np.testing.assert_array_equal(v.numpy(), g[f"dq_part_{k}"],
                                      err_msg=k)


def test_dq_recon_matches_reference():
    """The wavefront with RDOQ and sign hiding at depths 1-4 on the
    reference's partition, each TU at its CTB's QP (RDOQ's lambda too):
    reconstruction and levels of every plane."""
    g = _golden()
    pipe = _pipe(pu_depth=(1, 4), rdoq=True, sign_hiding=True)
    maps = [torch.from_numpy(g[f"dq_rec_{k}"].astype(np.int32))
            for k in ("size_map8", "mode_map8", "mode_map4")]
    luma, chroma, written, _ = pipe._recon_md(*_src(), maps[0], maps[1],
                                              mode_map4=maps[2])
    assert bool(written.all())
    h, w = RC_H, RC_W
    np.testing.assert_array_equal(luma[:, 1:1 + h, 1:1 + w].numpy(),
                                  g["dq_rec_luma"][:, 1:1 + h, 1:1 + w])
    np.testing.assert_array_equal(
        chroma[:, 1:1 + h // 2, 1:1 + w // 2].numpy(),
        g["dq_rec_chroma"][:, 1:1 + h // 2, 1:1 + w // 2])


@pytest.mark.parametrize("wpp", [False, True], ids=["raster", "wpp"])
def test_final_qp_chain_matches_reference(wpp):
    """CTBs that code no coefficient take their predecessor's QP: across
    the row end in raster order, the slice QP at each row start with
    WPP."""
    g = _golden()
    pipe = _pipe(wpp=wpp)
    fq = pipe._final_qp(*(torch.from_numpy(a) for a in dq_levels()))
    want = g["dq_fq_wpp" if wpp else "dq_fq"]
    np.testing.assert_array_equal(fq.numpy(), want)
    # CTB (1, 0) codes nothing: the slice QP with WPP, CTB (0, 2)'s QP
    # without
    assert STAGE_QP != STAGE_QPMAP[0, 2]
    assert want[1, 0] == (STAGE_QP if wpp else STAGE_QPMAP[0, 2])


@pytest.mark.parametrize("grain", ["ctb", "4x4"])
def test_deblock_qp4_matches_numpy_oracle(grain):
    """deblock_frame_torch with a QP a 4x4 block (per CTB as the encoder
    makes it, and a random one a block) against ops/deblock.py, bit
    exact, with BS 1 and 2 edges and beta / tc offsets."""
    from kvazaar_tpu_torch.ops.deblock import deblock_frame
    from kvazaar_tpu_torch.ops.deblock_torch import deblock_frame_torch
    rng = np.random.RandomState(41)
    h, w = RC_H, RC_W
    y = (np.cumsum(rng.randint(-3, 4, (h, w)), 1) + 128).clip(0, 255)
    cb = rng.randint(100, 140, (h // 2, w // 2))
    cr = rng.randint(100, 140, (h // 2, w // 2))
    bv = rng.randint(0, 3, (h // 4, w // 8))
    bh = rng.randint(0, 3, (h // 8, w // 4))
    if grain == "ctb":
        qp4 = np.repeat(np.repeat(rng.randint(15, 45, (h // 64, w // 64)),
                                  16, 0), 16, 1)
    else:
        qp4 = rng.randint(10, 52, (h // 4, w // 4))
    planes = [a.astype(np.int32) for a in (y, cb, cr, bv, bh, qp4)]
    want = deblock_frame(*(a.copy() for a in planes[:3]), planes[3],
                         planes[4], 30, 29, 29, 1, -1, qp4=planes[5])
    got = deblock_frame_torch(*(torch.from_numpy(a) for a in planes[:5]),
                              30, 29, 29, 1, -1,
                              qp4=torch.from_numpy(planes[5]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert not np.array_equal(got[0].numpy(), planes[0])


@pytest.mark.slow
@pytest.mark.parametrize("name", RC_CASES)
def test_rc_stream_matches_jax_live(name, roi_path):
    stream, decs, infos = port_run(name, roi_path)
    want, wdecs, plan = jax_gop_stream(rc_case_frames(name), RC_KEYS,
                                       **rc_config(name, roi_path))
    assert [i["qp"] for i in infos] == [p["qp"] for p in plan]
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want


@pytest.mark.slow
def test_capi_bitrate_matches_jax_live():
    from kvazaar_tpu.capi import kvz_api_get as ref_api
    from kvazaar_tpu_torch.capi import kvz_api_get
    frames = rc_frames(RC_CAPI_FRAMES)
    assert (capi_stream(kvz_api_get(8), frames, device="cpu")
            == capi_stream(ref_api(8), frames))
