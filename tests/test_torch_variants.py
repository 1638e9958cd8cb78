"""The remaining intra variants on the CPU: transform skip,
--fast-coeff-table, Main 10, scaling lists (--scaling-list default,
--cqmfile) and lossless coding (tools/torch_goldens.py VARIANT_CONFIGS,
tests/data/torch_golden_variants.npz; live JAX twins are marked `slow`).

- kvazaar_tpu_torch.api encodes, at 128x64, each VARIANT_CONFIGS stream
  byte-identical to the JAX package's, with equal maps per coded frame
  (the transform-skip bits `ts8` included), and each decodes hash-exactly
  to the encoder's reconstruction in both packages' decoders; the lossless
  reconstruction is the source; 10-bit at the default -p 64 codes every
  frame intra.
- The stages against the JAX package's outputs on the golden's inputs:
  _transform_quant at 10-bit (plain, and with RDOQ and sign hiding), the
  scaled dequant at 8 and 10 bits up to its int32 fold, the transform-skip
  T/Q/IT and its RD competition, and the 10-bit leaf costs and partition.
- Deblocking and SAO at 10-bit against kvazaar_tpu/ops/deblock_jax.py and
  ops/sao_jax.py, live.
- The CLI (16-bit YUV in and out at --input-bitdepth 10, and
  --transform-skip) and capi.py code the golden's streams.

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
from tools.torch_goldens import (CQM_FILE, FCT_TABLE, H,  # noqa: E402
                                 OUT as SLICE_GOLDEN,
                                 OUT_VARIANTS as GOLDEN, SAO_KEYS,
                                 SDQ_QPS, VARIANT_CONFIGS, VARIANT_KEYS,
                                 VARIANT_QP, W, cqm_text, fct_table,
                                 jax_gop_stream, variant_frames,
                                 variant_stage_inputs)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.hevc.scaling import ScalingLists  # noqa: E402
from kvazaar_tpu_torch.models.intra_md import (  # noqa: E402
    MdIntraPipeline, ts_lambda)

_RUNS: dict = {}
RTOL = 1e-5
SHAPES = ((4, True), (8, True), (16, True), (32, True), (4, False),
          (8, False), (16, False))


def _sid(shape):
    n, luma = shape
    return f"{'y' if luma else 'c'}{n}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    return np.load(GOLDEN)


def _port_run(name: str):
    """(stream, per coded frame maps, infos) of the port on the CPU through
    encode_sequence, once per configuration."""
    if name not in _RUNS:
        enc = Encoder(Config(width=W, height=H, **VARIANT_CONFIGS[name][0]),
                      device="cpu")
        decs = []
        finalize = enc.finalize_frame

        def record(meta):
            out = finalize(meta)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in VARIANT_KEYS})
            return out
        enc.finalize_frame = record
        stream, infos = encode_sequence(enc.cfg, variant_frames(name),
                                        encoder=enc)
        _RUNS[name] = (stream, decs, infos)
    return _RUNS[name]


def _want_maps(name: str, slice_type: int) -> set:
    """The maps a coded frame of a VARIANT_CONFIGS run carries: the intra
    ones with mode_map4 (and ts8 with transform skip) in I slices, the
    list-0 and list-1 maps in B slices, the SAO parameters where SAO is
    on."""
    cfg = VARIANT_CONFIGS[name][0]
    want = {"size_map8", "mode_map8", "levels_y", "levels_cb", "levels_cr",
            "hash", "rec_y", "rec_cb", "rec_cr"}
    if slice_type == 2:
        want |= {"mode_map4"} | ({"ts8"} if cfg.get("trskip_enable")
                                 else set())
    else:
        want |= {"inter8", "mv8", "ref8", "dir8", "mv8b", "ref8b"}
    if cfg.get("sao_type", "off") != "off":
        want |= set(SAO_KEYS)
    return want


@pytest.mark.parametrize("name", sorted(VARIANT_CONFIGS))
def test_variant_stream_byte_identical_to_reference(name):
    """Every map of every coded frame equal, and the stream equal; but
    for trskip_b, whose B frames the port codes with the transform_skip
    flags of inter CUs that the JAX package's writer omits (ROADMAP.md
    queue 3): there the IDR's bytes are equal, and
    test_trskip_b_differs_only_in_inter_transform_skip_flags holds the
    rest."""
    stream, decs, infos = _port_run(name)
    g = _golden()
    assert len(decs) == len(variant_frames(name))
    for i, (d, info) in enumerate(zip(decs, infos)):
        want = _want_maps(name, info["slice_type"])
        held = {k for k in VARIANT_KEYS if f"{name}_f{i}_{k}" in g.files}
        assert held == want, f"frame {i}: golden maps {sorted(held)}"
        assert set(d) == want, f"frame {i}: port maps {sorted(d)}"
        for k in sorted(want):
            np.testing.assert_array_equal(
                d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    ref = g[f"{name}_stream"].tobytes()
    if name == "trskip_b":
        n0 = infos[0]["bytes"]
        assert stream[:n0] == ref[:n0] and stream != ref
    else:
        assert stream == ref


def test_trskip_b_differs_only_in_inter_transform_skip_flags(monkeypatch):
    """The JAX package's trskip_b stream does not decode: its P/B writer
    codes no transform_skip_flag on the 4x4 chroma TUs of inter CUs (spec
    7.3.8.11 codes one on every 4x4 TU when the PPS enables transform
    skip). The port's stream, written without those flags, is the
    reference's byte for byte."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    from kvazaar_tpu_torch.engine.md_inter_writer import MdPSliceWriter
    ref = _golden()["trskip_b_stream"].tobytes()
    with pytest.raises(ValueError, match="end_of_slice"):
        HEVCDecoder().decode(ref)
    inter_cu = MdPSliceWriter._inter_cu

    def without_flags(self, *args):
        pps = self.pps
        saved, pps.transform_skip_enabled = pps.transform_skip_enabled, 0
        try:
            return inter_cu(self, *args)
        finally:
            pps.transform_skip_enabled = saved
    monkeypatch.setattr(MdPSliceWriter, "_inter_cu", without_flags)
    stream, _ = encode_sequence(
        Config(width=W, height=H, **VARIANT_CONFIGS["trskip_b"][0]),
        variant_frames("trskip_b"), device="cpu")
    assert stream == ref


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", sorted(VARIANT_CONFIGS))
def test_variant_stream_decodes_hash_exact(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, infos = _port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


def test_lossless_reconstruction_equals_source():
    _, decs, infos = _port_run("lossless")
    for info, src in zip(infos, variant_frames("lossless")):
        for got, want in zip(info["recon_out"], src):
            np.testing.assert_array_equal(got, want)
        assert info["psnr"] == [99.0, 99.0, 99.0]


def test_main10_codes_every_frame_intra_in_main10():
    """10-bit at the default -p 64 codes no inter frame (as the reference:
    kvazaar_tpu/api.py:244-251), its SPS names the Main 10 profile and
    its samples span 0-1023."""
    stream, decs, infos = _port_run("main10_p64")
    assert [i["slice_type"] for i in infos] == [2, 2, 2]
    enc = Encoder(Config(width=W, height=H, input_bitdepth=10),
                  device="cpu")
    assert not enc.inter_enabled
    assert enc.sps.ptl.general_profile_idc == 2
    assert enc.sps.bit_depth_luma == 10
    y = variant_frames("main10_p64")[0][0]
    assert y.dtype == np.uint16 and y.min() < 16 and y.max() > 1000
    assert decs[0]["rec_y"].max() > 255


def test_transform_skip_is_chosen():
    """On screen content the competition takes transform skip on some
    NxN luma and 4x4 chroma TUs of every frame (`ts8`: four luma bits in
    z order, then Cb and Cr); B frames of trskip_b carry no ts8."""
    _, decs, infos = _port_run("trskip")
    for d in decs:
        assert d["ts8"][..., :4].any() and d["ts8"][..., 4:].any()
    _, decs, infos = _port_run("trskip_b")
    assert [i["slice_type"] for i in infos] == [2, 0, 0]
    assert "ts8" in decs[0] and "ts8" not in decs[1]


def test_fct_table_moves_decisions():
    """The committed --fast-coeff-table is fct_table() (the learned
    weights at 1.5 times, no 32x32 entry), and it changes maps against
    the default table on the same frames (the slice golden)."""
    import json
    with open(FCT_TABLE) as f:
        assert json.load(f) == fct_table()
    with open(CQM_FILE) as f:
        assert f.read() == cqm_text()
    pipe = MdIntraPipeline(H, W, 22, fast_coeff_table=FCT_TABLE,
                           device="cpu")
    assert pipe.fast_cost.get(5) is None
    assert not pipe.c["fcw"][3].any() and pipe.c["fcw"][:3].any()
    _, decs, _ = _port_run("fct_b")
    s = np.load(SLICE_GOLDEN)
    moved = [k for i, d in enumerate(decs)
             for k in ("size_map8", "mode_map8", "levels_y")
             if not np.array_equal(d[k], s[f"f{i}_{k}"])]
    assert moved


def test_cqm_quantises_cr_with_its_own_lists(tmp_path):
    """A --cqmfile whose Cr lists differ from its Cb lists: the port
    quantises Cr with Cr's (the SPS signals both), so the stream decodes
    hash-exactly; the JAX package quantises Cr with Cb's lists and its
    stream does not (ROADMAP.md queue 3)."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    from kvazaar_tpu_torch.hevc.scaling import load_cqmfile
    out, v = [], False
    for ln in cqm_text().split("\n"):
        if ln.endswith("="):
            v = ln.endswith("CHROMAV =")
        elif v and ln:
            ln = ",".join(str(min(255, 3 * int(x)))
                          for x in ln.rstrip(",").split(",")) + ","
        out.append(ln)
    path = tmp_path / "crv.txt"
    path.write_text("\n".join(out))
    sl = load_cqmfile(str(path))
    assert not np.array_equal(sl.matrix(8, 1), sl.matrix(8, 2))
    stream, infos = encode_sequence(
        Config(width=W, height=H, qp=30, cqmfile=str(path)),
        variant_frames("cqm")[:1], device="cpu")
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 1 and pics[0].hash_ok
    np.testing.assert_array_equal(pics[0].planes[2],
                                  infos[0]["recon_out"][2])


def test_wavefront_runs_past_the_reference_cap():
    """Forced NxN (--pu-depth-intra 4-4) on a 1024x64 picture needs more
    waves than the reference's bound of 3 * r8 + 2 * c8 + 64, at which
    the JAX package stops with cells unwritten (its stream then misses
    the hash; ROADMAP.md queue 3): the port's wavefront runs until every
    cell is written, and the stream decodes hash-exactly."""
    from chip_smoke import leaf_frames
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    w, h = 1024, 64
    stream, infos = encode_sequence(
        Config(width=w, height=h, qp=27, intra_period=1,
               pu_depth_intra=(4, 4)), leaf_frames(1, w, h), device="cpu")
    assert infos[0]["n_waves"] > 3 * (h // 8) + 2 * (w // 8) + 64
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 1 and pics[0].hash_ok


def test_smoke_content_is_the_feature_tests():
    """chip_smoke.py's screen_frames and main10_frames (phase 12, and the
    goldens' "screen" and "main10" content) are tests/test_trskip.py's
    and tests/test_main10.py's generators with their `rng` seed."""
    pytest.importorskip("jax")
    from chip_smoke import main10_frames, screen_frames
    from tests.test_main10 import _frames10
    from tests.test_trskip import _screen_frame
    rng = np.random.RandomState(1234)
    want = [_screen_frame(W, H, rng) for _ in range(2)]
    for got, ref in ((screen_frames(2, W, H), want),
                     (main10_frames(2, W, H),
                      _frames10(W, H, 2, np.random.RandomState(1234)))):
        for a, b in zip(got, ref):
            for pa, pb in zip(a, b):
                assert pa.dtype == pb.dtype
                np.testing.assert_array_equal(pa, pb)


def test_rate_tu_takes_the_analytic_estimate_without_weights():
    """A TU size the table has no weights for is rated by the analytic
    estimate (the reference's model-availability branch); zero levels
    cost nothing either way."""
    pipe = MdIntraPipeline(H, W, 22, fast_coeff_table=FCT_TABLE,
                           device="cpu")
    lv = torch.zeros((2, 32, 32), dtype=torch.int32)
    lv[0, 0, 0], lv[0, 3, 1], lv[0, 9, 20] = 1, -2, 7
    r = pipe._rate_tu(lv, 32)
    al = np.abs(lv[0].numpy()).astype(np.float32)
    bins = sum(3.0 if a == 1 else 4.0 if a == 2 else
               5.0 + 2.0 * np.floor(np.log2(max(a - 1.0, 1.0)))
               for a in al[al > 0])
    f = pipe._tu_features(lv, 32)
    want = bins + 0.6 * (f[4][0] - f[0][0]) + f[5][0] + f[6][0] + 2.0
    assert float(r[0]) == pytest.approx(float(want), rel=RTOL)
    assert float(r[1]) == 0.0


# ----------------------------------------------------------------------
# stages
# ----------------------------------------------------------------------

def _dst_kw(n, luma):
    """The 4x4 DST of intra luma, the DCT otherwise."""
    return dict(dst=luma and n == 4)


@pytest.mark.parametrize("shape", SHAPES, ids=_sid)
@pytest.mark.parametrize("tag", ["p", "r"])
def test_transform_quant_10bit_matches_reference(tag, shape):
    n, luma = shape
    tools = dict(rdoq=True, sign_hiding=True) if tag == "r" else {}
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=10, device="cpu",
                        **tools)
    r = torch.from_numpy(variant_stage_inputs()[f"r10_{n}"])
    lv, r2 = p._transform_quant(r, n, p.qp_y if luma else p.qp_c,
                                is_luma=luma, tools=True, **_dst_kw(n, luma))
    g = _golden()
    key = f"tq10{tag}_{_sid(shape)}"
    np.testing.assert_array_equal(lv.numpy(), g[key + "_levels"])
    np.testing.assert_array_equal(r2.numpy(), g[key + "_resi"])


@pytest.mark.parametrize("qp", SDQ_QPS)
@pytest.mark.parametrize("shape", SHAPES, ids=_sid)
@pytest.mark.parametrize("bd", [8, 10])
def test_scaled_dequant_matches_reference(bd, shape, qp):
    n, luma = shape
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=bd,
                        scaling=ScalingLists(), device="cpu")
    r = torch.from_numpy(variant_stage_inputs()[f"r10_{n}"] >> (10 - bd))
    lv, r2 = p._transform_quant(r, n, qp, is_luma=luma, tools=True,
                                **_dst_kw(n, luma))
    g = _golden()
    key = f"sdq{bd}_{_sid(shape)}_q{qp}"
    np.testing.assert_array_equal(lv.numpy(), g[key + "_levels"])
    np.testing.assert_array_equal(r2.numpy(), g[key + "_resi"])


@pytest.mark.parametrize("bd", [8, 10])
def test_scaled_quantiser_with_a_qp_a_tu(bd):
    """Delta QP with scaling lists (a QP tensor, one a TU): each TU's
    levels and residual equal those of its QP given alone, across both
    sides of the int32 fold."""
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=bd,
                        scaling=ScalingLists(), rdoq=True, device="cpu")
    qps = np.array([4, 51, 30, 22, 45, 37, 12, 27], np.int32)
    for n, luma in SHAPES:
        r = torch.from_numpy(variant_stage_inputs()[f"r10_{n}"] >> (10 - bd))
        kw = dict(is_luma=luma, tools=True, **_dst_kw(n, luma))
        lv, r2 = p._transform_quant(r, n, torch.from_numpy(qps), **kw)
        for i, q in enumerate(qps):
            lvi, r2i = p._transform_quant(r[i:i + 1], n, int(q), **kw)
            assert torch.equal(lv[i:i + 1], lvi), (n, luma, int(q))
            assert torch.equal(r2[i:i + 1], r2i), (n, luma, int(q))


def test_scaled_dequant_reaches_the_int32_fold():
    """The stage inputs reach both sides of the fold with nonzero levels:
    the right shift at QP 4 and the left shift (the QP's sixth above the
    dequantiser's shift) at QP 51, at 8 and at 10 bits; the product
    level * m * ls stays inside int32."""
    from kvazaar_tpu_torch.tables import INV_QUANT_SCALES
    g = _golden()
    sl = ScalingLists()
    for bd in (8, 10):
        for qp, left in ((4, False), (51, True)):
            qb = qp + 6 * (bd - 8)
            hits = 0
            for n, luma in SHAPES:
                lv = g[f"sdq{bd}_{_sid((n, luma))}_q{qp}_levels"]
                s_fold = bd + int(np.log2(n)) - 5 - qb // 6
                assert (s_fold <= 0) == left
                x = (lv.astype(np.int64) * sl.matrix(n, 0 if luma else 1)
                     * INV_QUANT_SCALES[qb % 6])
                assert np.abs(x).max() < 2 ** 31
                hits += int((lv != 0).sum())
            assert hits > 0, (bd, qp)


@pytest.mark.parametrize("luma", [True, False], ids=["y", "c"])
@pytest.mark.parametrize("tag", ["p", "r", "s"])
@pytest.mark.parametrize("bd", [8, 10])
def test_transform_quant_skip_matches_reference(bd, tag, luma):
    kw = {"p": {}, "r": dict(rdoq=True, sign_hiding=True),
          "s": dict(scaling=ScalingLists())}[tag]
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=bd, trskip=True,
                        device="cpu", **kw)
    r = torch.from_numpy(variant_stage_inputs()["r10_4"] >> (10 - bd))
    lv, r2 = p._transform_quant_skip(r, p.qp_y if luma else p.qp_c,
                                     is_luma=luma, tools=True)
    g = _golden()
    key = f"tqs{bd}{tag}_{'y' if luma else 'c'}"
    np.testing.assert_array_equal(lv.numpy(), g[key + "_levels"])
    np.testing.assert_array_equal(r2.numpy(), g[key + "_resi"])


@pytest.mark.parametrize("luma", [True, False], ids=["y", "c"])
@pytest.mark.parametrize("tag", ["p", "r"])
def test_tq_4x4_rd_matches_reference(tag, luma):
    kw = dict(rdoq=True, sign_hiding=True) if tag == "r" else {}
    p = MdIntraPipeline(H, W, VARIANT_QP, trskip=True, device="cpu", **kw)
    r = torch.from_numpy(variant_stage_inputs()["ts4"])
    lv, r2, use = p._tq_4x4_rd(r, p.qp_y if luma else p.qp_c,
                               ts_lambda(p.qp_y), is_luma=luma, dst=luma)
    g = _golden()
    key = f"tqrd{tag}_{'y' if luma else 'c'}"
    np.testing.assert_array_equal(use.numpy(), g[key + "_use"])
    np.testing.assert_array_equal(lv.numpy(), g[key + "_levels"])
    np.testing.assert_array_equal(r2.numpy(), g[key + "_resi"])
    # both sides of the competition occur on these inputs
    assert 0 < int(use.sum()) < len(use)


def _main10_src():
    return tuple(torch.from_numpy(a.astype(np.int32))
                 for a in variant_frames("main10")[0])


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_leaf_rd_10bit_matches_reference(n):
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=10, pu_depth=(1, 4),
                        device="cpu")
    src = _main10_src()
    modes, cost = (p._leaf_rd4(*src) if n == 4 else p._leaf_rd(*src, n))
    g = _golden()
    np.testing.assert_array_equal(modes.numpy(), g[f"leaf10_{n}_modes"])
    np.testing.assert_allclose(cost.numpy(), g[f"leaf10_{n}_cost"],
                               rtol=RTOL)


def test_partition_10bit_matches_reference():
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=10, pu_depth=(1, 4),
                        device="cpu")
    g = _golden()
    for k, v in zip(("size_map8", "mode_map8", "mode_map4"),
                    p._partition(*_main10_src())):
        np.testing.assert_array_equal(v.numpy(), g[f"part10_{k}"],
                                      err_msg=k)


# ----------------------------------------------------------------------
# deblocking and SAO at 10-bit, live against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("qp", [22, 37])
def test_deblock_10bit_matches_jax(qp):
    """tc scaled by 4 (spec 8.7.2.5.3) and the 10-bit clip."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from kvazaar_tpu.ops.deblock_jax import deblock_frame_jax
    from kvazaar_tpu_torch.ops.deblock_torch import deblock_frame_torch
    from kvazaar_tpu_torch.tables import chroma_qp
    rng = np.random.RandomState(qp)
    y = (rng.randint(0, 1024, (H, W)) // 64
         + 4 * np.add.outer(np.arange(H), np.arange(W))).clip(0, 1023)
    cb = rng.randint(400, 624, (H // 2, W // 2))
    cr = (np.add.outer(np.arange(H // 2), np.arange(W // 2)) * 8
          + rng.randint(0, 40, (H // 2, W // 2))).clip(0, 1023)
    planes = [a.astype(np.int32) for a in (y, cb, cr)]
    bs_v = rng.randint(0, 3, (H // 4, W // 8)).astype(np.int32)
    bs_h = rng.randint(0, 3, (H // 8, W // 4)).astype(np.int32)
    qc = chroma_qp(qp)
    want = jax.jit(deblock_frame_jax, static_argnums=(8, 9, 10))(
        *(jnp.asarray(a) for a in (*planes, bs_v, bs_h)), jnp.int32(qp),
        jnp.int32(qc), jnp.int32(qc), 1, -1, 10)
    got = deblock_frame_torch(*(torch.from_numpy(a)
                                for a in (*planes, bs_v, bs_h)),
                              qp, qc, qc, 1, -1, bit_depth=10)
    assert not np.array_equal(got[0].numpy(), planes[0])   # it filtered
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["full", "band", "edge"])
def test_sao_10bit_matches_jax(mode):
    """SAO's offsets shifted by bit depth - 10 (none at 10-bit, so
    offsets up to 31 where 8-bit stops at 7) and the band table of the
    top 5 bits, luma and joint chroma."""
    jax = pytest.importorskip("jax")
    from kvazaar_tpu.ops import sao_jax
    from kvazaar_tpu_torch.ops import sao_torch
    ab, ae = mode in ("full", "band"), mode in ("full", "edge")
    rng = np.random.RandomState(9)
    lam = np.float32(0.57 * 2.0 ** ((VARIANT_QP + 12 - 12) / 3.0))

    def pair(h, w):
        # a smooth 10-bit field whose reconstruction has every third
        # column pushed down by 24: local minima (edge offsets) and a
        # bias (band offsets) beyond 8-bit SAO's range of 7
        yy, xx = np.mgrid[0:h, 0:w]
        src = (300 + 5 * xx + 3 * yy + rng.randint(0, 3, (h, w)))
        rec = src.copy()
        rec[:, ::3] -= 24
        return (src.clip(0, 1023).astype(np.int32),
                rec.clip(0, 1023).astype(np.int32))
    src, rec = pair(H, W)
    want_out, want = jax.jit(lambda s, r, lam: sao_jax.sao_luma(
        s, r, 64, lam, ab, ae, bit_depth=10))(src, rec, lam)
    out, got = sao_torch.sao_luma(torch.from_numpy(src),
                                  torch.from_numpy(rec), 64,
                                  torch.tensor(lam), ab, ae, bit_depth=10)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert np.abs(np.asarray(want["offs"])).max() > 7
    (cb, rcb), (cr_, rcr) = pair(H // 2, W // 2), pair(H // 2, W // 2)
    cs, cr = [cb, cr_], [rcb, rcr]
    want_b, want_r, want = jax.jit(lambda a, b, c, d, lam: sao_jax.sao_chroma(
        a, b, c, d, 32, lam, ab, ae, bit_depth=10))(*cs, *cr, lam)
    out_b, out_r, got = sao_torch.sao_chroma(
        *(torch.from_numpy(a) for a in (*cs, *cr)), 32, torch.tensor(lam),
        ab, ae, bit_depth=10)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(out_r.numpy(), np.asarray(want_r))


# ----------------------------------------------------------------------
# the CLI and capi.py
# ----------------------------------------------------------------------

def test_cli_main10_16bit_yuv_on_cpu(tmp_path):
    """--input-bitdepth 10 reads 16-bit little-endian YUV and writes the
    --debug reconstruction in 16 bits; the stream is the golden's."""
    from kvazaar_tpu_torch.__main__ import main
    frames = variant_frames("main10")
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for fr in frames:
            for p in fr:
                f.write(p.astype("<u2").tobytes())
    out, dbg = tmp_path / "out.hevc", tmp_path / "rec.yuv"
    assert main(["-i", str(src), "--input-res", f"{W}x{H}", "-o", str(out),
                 "--input-bitdepth", "10", "-q", str(VARIANT_QP), "--sao",
                 "full", "--rdoq", "--signhide", "--debug", str(dbg),
                 "--device", "cpu"]) == 0
    g = _golden()
    assert out.read_bytes() == g["main10_stream"].tobytes()
    rec = np.fromfile(dbg, "<u2")
    n = W * H * 3 // 2
    assert rec.size == n * len(frames)
    np.testing.assert_array_equal(rec[:W * H].reshape(H, W),
                                  g["main10_f0_rec_y"])


def test_cli_transform_skip_on_cpu(tmp_path):
    from kvazaar_tpu_torch.__main__ import main
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for fr in variant_frames("trskip"):
            for p in fr:
                f.write(p.tobytes())
    out = tmp_path / "out.hevc"
    assert main(["-i", str(src), "--input-res", f"{W}x{H}", "-o", str(out),
                 "--transform-skip", "--pu-depth-intra", "1-4", "-q", "27",
                 "-p", "1", "--device", "cpu"]) == 0
    assert out.read_bytes() == _golden()["trskip_stream"].tobytes()


@pytest.mark.parametrize("name", ["main10", "lossless"])
def test_capi_codes_the_golden_stream(name):
    """capi.py gives the golden's stream: the options through
    config_parse, the bit depth and SAO (which it has no name for) on the
    config, 16-bit pictures at 10-bit."""
    from kvazaar_tpu_torch.capi import kvz_api_get
    bd = VARIANT_CONFIGS[name][0].get("input_bitdepth", 8)
    api = kvz_api_get(bd)
    cfg = api.config_alloc()
    opts = {"main10": (("qp", "30"), ("rdoq", "1"), ("signhide", "1")),
            "lossless": (("lossless", "1"),)}[name]
    for k, v in opts:
        assert api.config_parse(cfg, k, v)
    if name == "main10":
        cfg.sao_type = "full"
    cfg.width, cfg.height, cfg.input_bitdepth = W, H, bd
    enc = api.encoder_open(cfg, device="cpu")
    out = b""
    frames = variant_frames(name)
    for f in frames + [None] * len(frames):
        pic = None
        if f is not None:
            pic = api.picture_alloc(W, H, bd)
            pic.y[:], pic.u[:], pic.v[:] = f
        data, _, _ = api.encoder_encode(enc, pic)
        out += data or b""
    api.encoder_close(enc)
    assert out == _golden()[f"{name}_stream"].tobytes()


# ----------------------------------------------------------------------
# live twins
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(VARIANT_CONFIGS))
def test_variant_stream_matches_jax_live(name):
    pytest.importorskip("jax")
    stream, decs, _ = _port_run(name)
    want, wdecs, _ = jax_gop_stream(variant_frames(name), VARIANT_KEYS,
                                    **VARIANT_CONFIGS[name][0])
    for i, (d, w) in enumerate(zip(decs, wdecs)):
        for k in sorted(w):
            np.testing.assert_array_equal(d[k], w[k],
                                          err_msg=f"frame {i} {k}")
    if name == "trskip_b":
        # the port's P/B writer codes the inter CUs' transform_skip flags
        n0 = _port_run(name)[2][0]["bytes"]
        assert stream[:n0] == want[:n0]
    else:
        assert stream == want
