"""The preset ladder on the CPU (tools/torch_goldens.py PRESET_CONFIGS,
tests/data/torch_golden_presets.npz; live JAX twins are marked `slow`).

- kvazaar_tpu_torch.api encodes, at 128x64: all-intra with NxN 4x4
  leaves (--pu-depth-intra 1-4, QP 22, tests/test_intra_nxn.py's detail
  content); --pu-depth-intra 0-4 --rd 3 with SAO full, RDOQ and sign
  hiding at QP 27 (64 leaves, NxN with the mode-dependent sign-hiding
  scan, the rd ladder on half flat content); --pu-depth-intra 4-4 and 0-0
  (forced NxN, 64 leaves only); --preset ultrafast, medium and placebo
  (5 frames through encode_sequence). Each stream is byte-identical to the
  JAX package's, with equal maps per coded frame (mode_map4 and the SAO
  parameters included), and decodes hash-exactly to the encoder's
  reconstruction.
- The stages against the JAX package's outputs on the golden's inputs:
  _satd4, _leaf_rd4, _leaf_rd64, _leaf_rd at --rd 1, 2 and 3 on
  tie-heavy content, _partition at depth ranges 0-4, 1-4, 2-3 and 4-4,
  the NxN reconstruction with RDOQ and sign hiding, the inter split DP
  under the depth gates of five configurations, and the SMP search's
  sub-pel refinement at --subme 0, 2 and 4.
- The CLI with --preset medium on the CPU codes the golden's stream.
- The reference's behaviour that the port keeps (ROADMAP.md queue 3):
  the intra depth range gates the inter quadtree, --subme changes no
  stream without SMP/AMP, inter frames code no NxN.

Tolerances: 0 for integers, maps, planes and streams; rtol 1e-5 for
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
from tools.torch_goldens import (DP_GATES, H, OUT_PRESETS as GOLDEN,  # noqa
                                 PART_RANGES, PRESET_CONFIGS, PRESET_KEYS,
                                 SAO_KEYS, STAGE_QP, W, dp_inputs,
                                 intra_frames, jax_gop_stream, jax_stream,
                                 preset_config, preset_frames,
                                 subpel_inputs)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.models.inter_md import MdInterPipeline  # noqa: E402
from kvazaar_tpu_torch.models.intra_md import MdIntraPipeline  # noqa: E402

_RUNS: dict = {}
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    return np.load(GOLDEN)


def _port_run(name: str, **over):
    """(stream, per coded frame maps, infos) of the port on the CPU through
    encode_sequence, once per configuration (Config options `over` on top
    of the PRESET_CONFIGS entry)."""
    key = (name, tuple(sorted(over.items())))
    if key not in _RUNS:
        enc = Encoder(Config(width=W, height=H,
                             **dict(preset_config(name), **over)),
                      device="cpu")
        decs = []
        finalize = enc.finalize_frame

        def record(meta):
            out = finalize(meta)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in PRESET_KEYS})
            return out
        enc.finalize_frame = record
        stream, infos = encode_sequence(enc.cfg, preset_frames(name),
                                        encoder=enc)
        _RUNS[key] = (stream, decs, infos)
    return _RUNS[key]


@pytest.mark.parametrize("name", sorted(PRESET_CONFIGS))
def test_preset_stream_byte_identical_to_reference(name):
    stream, decs, infos = _port_run(name)
    g = _golden()
    assert len(decs) == len(preset_frames(name))
    for i, (d, info) in enumerate(zip(decs, infos)):
        # the maps each coded frame must carry: the intra ones with
        # mode_map4 in I slices, the list-0 maps in P and B slices, the
        # list-1 maps in B slices, the SAO parameters where SAO is on
        want = {"size_map8", "mode_map8", "levels_y", "levels_cb",
                "levels_cr", "hash", "rec_y", "rec_cb", "rec_cr"}
        want |= ({"mode_map4"} if info["slice_type"] == 2
                 else {"inter8", "mv8", "ref8"})
        if info["slice_type"] == 0:
            want |= {"dir8", "mv8b", "ref8b"}
        if preset_config(name).get("sao_type", "off") != "off":
            want |= set(SAO_KEYS)
        held = {k for k in PRESET_KEYS if f"{name}_f{i}_{k}" in g.files}
        assert held == want, f"frame {i}: golden maps {sorted(held)}"
        assert set(d) == want, f"frame {i}: port maps {sorted(d)}"
        for k in sorted(want):
            np.testing.assert_array_equal(
                d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    assert stream == g[f"{name}_stream"].tobytes()


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", sorted(PRESET_CONFIGS))
def test_preset_stream_decodes_hash_exact(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, infos = _port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):          # both in coding order
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


def test_smoke_intra_leaves_are_the_golden_rd3():
    """chip_smoke.py's intra-leaves run (held on the GPU against the CPU
    path) uses the configuration and content of the golden "rd3"."""
    import chip_smoke
    cfg, kind, n = PRESET_CONFIGS["rd3"]
    assert chip_smoke.INTRA_LEAVES == cfg
    for w, h in ((W, H), (416, 240)):
        for a, b in zip(chip_smoke.leaf_frames(n, w, h),
                        intra_frames(kind, n, w, h)):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb)


def test_leaf_sizes_are_exercised():
    """The golden runs code what they are there for: NxN cells on the
    detail content and beside 64 leaves at depths 0-4, every cell NxN at
    4-4 and every cell a 64 leaf at 0-0."""
    sizes = {name: np.concatenate([d["size_map8"].ravel()
                                   for d in _port_run(name)[1]])
             for name in ("nxn", "rd3", "d44", "d00")}
    assert (sizes["nxn"] == 4).any() and (sizes["nxn"] != 4).any()
    assert (sizes["rd3"] == 4).any() and (sizes["rd3"] == 64).any()
    assert (sizes["d44"] == 4).all()
    assert (sizes["d00"] == 64).all()


# ---------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------

def _src():
    return [torch.from_numpy(p.astype(np.int32))
            for p in intra_frames("halfflat", 1)[0]]


def _cmp_cost(got, want, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, err_msg=what)


def test_satd4_matches_reference():
    g = _golden()
    got = MdIntraPipeline._satd4(torch.from_numpy(g["satd4_in"]))
    np.testing.assert_array_equal(got.numpy(), g["satd4_out"])


def test_leaf_rd4_and_rd64_match_reference():
    g = _golden()
    pipe = MdIntraPipeline(H, W, STAGE_QP, pu_depth=(0, 4), device="cpu")
    m4, c4 = pipe._leaf_rd4(*_src())
    np.testing.assert_array_equal(m4.numpy(), g["leaf4_modes"])
    _cmp_cost(c4, g["leaf4_cost"], "leaf4")
    m64, c64 = pipe._leaf_rd64(*_src())
    np.testing.assert_array_equal(m64.numpy(), g["leaf64_modes"])
    _cmp_cost(c64, g["leaf64_cost"], "leaf64")


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("rd", [1, 2, 3])
def test_leaf_rd_ladder_matches_reference(rd, n):
    """The rd ladder on half flat content, where whole blocks tie on SATD
    across all 35 modes: the candidates must be the reference's (ties by
    mode index), then the RD-cheapest."""
    g = _golden()
    src = _src()
    pipe = MdIntraPipeline(H, W, STAGE_QP, rd=rd, device="cpu")
    assert pipe.rd_cands == rd + 1
    modes, cost = pipe._leaf_rd(*src, n)
    np.testing.assert_array_equal(modes.numpy(),
                                  g[f"leafrd{rd}_{n}_modes"])
    _cmp_cost(cost, g[f"leafrd{rd}_{n}_cost"], f"rd {rd} n {n}")
    # the content has blocks whose SATDs tie across modes
    from kvazaar_tpu_torch.ops.me import satd_tiles
    gm, fm = pipe._gf(n, True)
    preds = pipe._preds_full(pipe._src_refs(src[0], n), gm, fm, n, True)
    satd = satd_tiles(pipe._blocks(src[0], n)[:, None]
                      - preds.reshape(-1, 35, n, n))
    assert ((satd == satd.min(dim=1, keepdim=True).values).sum(1) > 1).any()


@pytest.mark.parametrize("depths", PART_RANGES,
                         ids=[f"{lo}-{hi}" for lo, hi in PART_RANGES])
def test_partition_matches_reference(depths):
    g = _golden()
    lo, hi = depths
    pipe = MdIntraPipeline(H, W, STAGE_QP, pu_depth=depths, device="cpu")
    for k, v in zip(("size_map8", "mode_map8", "mode_map4"),
                    pipe._partition(*_src())):
        np.testing.assert_array_equal(v.numpy(), g[f"part{lo}{hi}_{k}"],
                                      err_msg=k)


def test_nxn_recon_matches_reference():
    """The wavefront on the reference's partition at depths 1-4 with RDOQ
    and sign hiding (4x4 luma TUs on their mode-dependent scans):
    reconstruction and levels of every plane."""
    g = _golden()
    assert (g["nxnrec_size_map8"] == 4).any()
    pipe = MdIntraPipeline(H, W, STAGE_QP, pu_depth=(1, 4), rdoq=True,
                           sign_hiding=True, device="cpu")
    maps = [torch.from_numpy(g[f"nxnrec_{k}"].astype(np.int32))
            for k in ("size_map8", "mode_map8", "mode_map4")]
    luma, chroma, written, _ = pipe._recon_md(*_src(), maps[0], maps[1],
                                              mode_map4=maps[2])
    assert bool(written.all())
    h, w = H, W
    np.testing.assert_array_equal(luma[:, 1:1 + h, 1:1 + w].numpy(),
                                  g["nxnrec_luma"][:, 1:1 + h, 1:1 + w])
    np.testing.assert_array_equal(
        chroma[:, 1:1 + h // 2, 1:1 + w // 2].numpy(),
        g["nxnrec_chroma"][:, 1:1 + h // 2, 1:1 + w // 2])


def _dp(name):
    intra, inter = DP_GATES[name]
    pipe = MdInterPipeline(H, W, 22, pu_depth=intra, pu_depth_inter=inter,
                           device="cpu")
    costs = dp_inputs()
    return pipe._dp_merge({n: {"cost": torch.from_numpy(costs[n])}
                           for n in costs}).numpy()


@pytest.mark.parametrize("name", sorted(DP_GATES))
def test_dp_merge_depth_gates_match_reference(name):
    np.testing.assert_array_equal(_dp(name), _golden()[f"dp_{name}"])


def test_dp_merge_intra_range_gates_inter_quadtree():
    """ROADMAP.md queue 3, "the intra depth range gates the inter
    quadtree": with --pu-depth-intra 2-3 (ultrafast) the split DP codes no
    32x32 CU, though --pu-depth-inter 1-2 allows inter 32s, and no 64
    (the inter range lacks depth 0); on the same costs with every gate open
    (medium) it picks 64 leaves."""
    ultra, medium = _dp("ultrafast"), _dp("medium")
    assert (medium == 64).any()
    assert set(np.unique(ultra)) <= {8, 16}
    pipe = MdInterPipeline(H, W, 22, pu_depth=(2, 3), pu_depth_inter=(1, 2),
                           device="cpu")
    assert pipe.allow_inter[32] and not pipe.allow[32]


@pytest.mark.parametrize("subme", [0, 2, 4])
def test_refine_subpel_matches_reference(subme):
    g = _golden()
    inp = {k: torch.from_numpy(v) for k, v in subpel_inputs().items()}
    pipe = MdInterPipeline(H, W, 22, subme=subme, smp=True, device="cpu")
    for blocks, tag in ((inp["blocks"], ""), (inp["blocks"][:, :8],
                                              "_half")):
        mv, satd = pipe._refine_subpel(blocks, inp["ref"], inp["y0"],
                                       inp["x0"], inp["mv"])
        np.testing.assert_array_equal(mv.numpy(), g[f"subpel{subme}_mv{tag}"])
        np.testing.assert_array_equal(satd.numpy(),
                                      g[f"subpel{subme}_satd{tag}"])
    if subme == 0:
        assert (mv % 4 == 0).all()


# ---------------------------------------------------------------------
# the reference's behaviour that the port keeps, and the CLI
# ---------------------------------------------------------------------

def test_subme_changes_no_stream_without_smp():
    """ROADMAP.md queue 3, "--subme outside SMP": ultrafast (--subme 0)
    codes the stream of ultrafast with --subme 4, since only the SMP
    search reads --subme and me_refine's quarter-pel sweep ignores it."""
    assert _port_run("ultrafast")[0] == _port_run("ultrafast", subme=4)[0]


def test_inter_frames_code_no_nxn():
    """ROADMAP.md queue 3, "no NxN in inter frames": medium reaches
    --pu-depth-intra 4, yet on tests/test_intra_nxn.py's detail content
    (a fresh mosaic a frame) only the IDR codes NxN cells; the P and B
    frames code intra 8x8 cells but no NxN (and carry no mode_map4, as
    the reference's inter programs do not)."""
    enc = Encoder(Config(width=W, height=H, **preset_config("medium")),
                  device="cpu")
    decs = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        decs.append(dict(enc._last_decisions))
        return out
    enc.finalize_frame = record
    _, infos = encode_sequence(enc.cfg, intra_frames("detail", 3),
                               encoder=enc)
    assert [i["slice_type"] for i in infos] == [2, 1, 0]
    assert (np.asarray(decs[0]["size_map8"]) == 4).any()
    for d in decs[1:]:
        size = np.asarray(d["size_map8"])
        intra = ~np.asarray(d["inter8"]).astype(bool)
        assert ((size == 8) & intra).any()
        assert not (size == 4).any()
        assert "mode_map4" not in d


def test_cli_preset_medium_on_cpu(tmp_path):
    """python -m kvazaar_tpu_torch --preset medium codes the golden's
    medium stream (the preset applied over the parsed flags)."""
    from kvazaar_tpu_torch.__main__ import main
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.hevc"
    yuv.write_bytes(b"".join(p.tobytes() for f in preset_frames("medium")
                             for p in f))
    assert main(["-i", str(yuv), "--input-res", f"{W}x{H}", "-o", str(out),
                 "--preset", "medium", "--device", "cpu"]) == 0
    assert out.read_bytes() == _golden()["medium_stream"].tobytes()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(PRESET_CONFIGS))
def test_preset_stream_matches_jax_live(name):
    stream, decs, _ = _port_run(name)
    if PRESET_CONFIGS[name][1] == "gop":
        want, wdecs, _ = jax_gop_stream(preset_frames(name), PRESET_KEYS,
                                        **preset_config(name))
    else:
        want, wdecs = jax_stream(preset_frames(name), PRESET_KEYS,
                                 **preset_config(name))
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want
