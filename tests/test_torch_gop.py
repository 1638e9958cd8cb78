"""Bench scenario 3 on the CPU: the B pyramid (--gop 2/4/8/16, closed
and open GOP) fed in display order through push_frame/flush
(tools/torch_goldens.py GOP_CONFIGS, GOP_PLANS).

- kvazaar_tpu_torch.api encodes the moving content of
  tests/test_gop_md.py at 128x64 in four configurations: bench scenario 3
  (-p 24 --gop 8, the tool row at QP 27, 12 frames), --gop 8 -p 8
  --open-gop (12 frames), --gop 4 -p 0 --ref 2 (9 frames: two pictures a
  list, different in l0 and l1) and --gop 4 -p 0 --no-bipred (5
  frames). Each stream must be byte-identical to the JAX package's
  (tests/data/torch_golden_gop.npz, live in `slow` twins), with equal
  maps (dir8, ref8b and the SAO parameters included; tolerance 0) and an
  equal plan per coded frame, decode hash-exactly in both packages'
  decoders and come out in display order. The Python slice writer gives
  the native writer's stream, and both writers get the union of the
  lists.
- The frame plan (display index, POC, slice and NAL type, QP, l0, l1,
  the retention set, the retained DPB) at gop 2, 4, 8 and 16 with --ref
  4, closed and open, equals the JAX package's through stand-in
  pipelines, the reference's order at a closed period boundary included
  (ROADMAP.md queue 3).
- The B leaf (n = 16 and 64) with distinct two-picture stacks a list
  equals the JAX method's decisions exactly and its cost within rtol
  1e-5, with bi-prediction on (the cross-reference candidate on a list 0
  and a list 1 picture wins somewhere) and off (no bi block).
- The CLI encodes scenario 3 on the CPU to the golden's stream.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.torch_goldens import (GOP_CONFIGS, GOP_PLANS, H,  # noqa: E402
                                 LEAF_QP, MAP_KEYS, OUT_GOP as GOLDEN,
                                 SAO_KEYS, W, drive_plan, gop_frames,
                                 gop_leaf_inputs, gop_plan_entry)
from chip_smoke import future_l1_blocks, output_order  # noqa: E402
from kvazaar_tpu_torch import native  # noqa: E402
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.engine import md_inter_writer  # noqa: E402

_RUNS: dict = {}
LEAF_KEYS = ("mv0", "r0", "mv1", "r1", "dir", "cost", "pred_y", "pred_cb",
             "pred_cr")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _UnionSpy(md_inter_writer.MdPSliceWriter):
    """The Python P/B slice writer, recording the union it is given."""
    unions: list = []

    def __init__(self, *a, union_pocs=None, **kw):
        _UnionSpy.unions.append(list(union_pocs))
        super().__init__(*a, union_pocs=union_pocs, **kw)


def _port_run(name: str, python_writer: bool = False):
    """(stream, per coded frame maps, plan entries and the union given to
    the slice writer, infos, encoder) of the port on the CPU through
    encode_sequence, once per configuration and writer. The native
    writer's calls are wrapped to record their union; with python_writer
    the native library is reported missing, so the Python writer codes
    every slice."""
    key = (name, python_writer)
    if key in _RUNS:
        return _RUNS[key]
    cfg, n = GOP_CONFIGS[name]
    enc = Encoder(Config(width=W, height=H, **cfg), device="cpu")
    decs, plan, unions = [], [], []
    finalize = enc.finalize_frame

    def record(meta):
        _UnionSpy.unions.clear()
        out = finalize(meta)
        plan.append(gop_plan_entry(meta))
        decs.append({k: np.asarray(v) for k, v in
                     enc._last_decisions.items() if k in MAP_KEYS})
        unions.append(seen[0] if seen else
                      _UnionSpy.unions[0] if _UnionSpy.unions else None)
        seen.clear()
        return out
    enc.finalize_frame = record
    seen = []
    pb = native.encode_md_slice_pb

    def spy_pb(*a, union_pocs=None, **kw):
        seen.append(list(union_pocs))
        return pb(*a, union_pocs=union_pocs, **kw)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(native, "encode_md_slice_pb", spy_pb)
        mp.setattr(md_inter_writer, "MdPSliceWriter", _UnionSpy)
        if python_writer:
            mp.setattr(native, "available", lambda: False)
        stream, infos = encode_sequence(enc.cfg, gop_frames(n),
                                        encoder=enc)
    finally:
        mp.undo()
    _RUNS[key] = (stream, decs, plan, unions, infos, enc)
    return _RUNS[key]


def _golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("name", sorted(GOP_CONFIGS))
def test_gop_stream_byte_identical_to_reference(name):
    stream, decs, plan, _, infos, enc = _port_run(name)
    g = _golden()
    assert plan == json.loads(str(g[f"{name}_plan"]))
    sao = GOP_CONFIGS[name][0].get("sao_type", "off") != "off"
    for i, d in enumerate(decs):
        # the tool row's frames carry their SAO parameters, compared too
        assert (set(SAO_KEYS) <= set(d)) == \
            (f"{name}_f{i}_sao_y_typ" in g.files) == sao
        for k in MAP_KEYS:
            if f"{name}_f{i}_{k}" in g.files:
                np.testing.assert_array_equal(
                    d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    assert stream == g[f"{name}_stream"].tobytes()
    assert enc.native_slices == len(infos) == GOP_CONFIGS[name][1]


def test_bench_scenario_3_plan():
    """Scenario 3's 12 frames at QP 27: the IDR at QP 25, the anchor P 8
    with the pyramid B 4 2 1 3 6 5 7 at QP 31 / 33 / 37 (layers 2 to 4),
    then the tail's P 10, B 9 and P 11 (QP 27, 31, 27)."""
    plan = _port_run("g8")[2]
    got = [(p["poc"], p["slice_type"], p["qp"], p["l0"], p["l1"])
           for p in plan]
    assert got == [
        (0, 2, 25, [], []), (8, 1, 27, [0], []), (4, 0, 31, [0], [8]),
        (2, 0, 33, [0], [4, 8]), (1, 0, 37, [0], [2, 4]),
        (3, 0, 37, [2, 0], [4, 8]), (6, 0, 33, [4, 2], [8]),
        (5, 0, 37, [4, 2], [6, 8]), (7, 0, 37, [6, 4], [8]),
        (10, 1, 27, [8, 0], []), (9, 0, 31, [8, 0], [10]),
        (11, 1, 27, [10, 8], [])]


@pytest.mark.parametrize("name", sorted(GOP_CONFIGS))
def test_b_frames_predict_from_future_pictures(name):
    """Some B frame predicts some block from a future picture of list 1,
    in the port and in the golden."""
    _, decs, plan, _, _, _ = _port_run(name)
    g = _golden()
    for src in ("port", "golden"):
        cells = []
        for i, p in enumerate(plan):
            if p["slice_type"] != 0:
                continue
            m = dict(decs[i]) if src == "port" else {
                k: g[f"{name}_f{i}_{k}"]
                for k in ("inter8", "dir8", "ref8b")}
            cells.append(future_l1_blocks(dict(m, l1=p["l1"]), p["poc"]))
        assert any(cells), src


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", sorted(GOP_CONFIGS))
def test_gop_stream_decodes_hash_exact_in_display_order(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, plan, _, infos, _ = _port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        assert p.poc == info["poc"]
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)
    assert output_order(pics, [p["disp"] for p in plan]) == \
        list(range(len(infos)))


def test_open_gop_nal_types():
    """--open-gop: the period boundary is a CRA picture, the pyramid
    before it RASL pictures (RASL_R for the references 4, 2 and 6,
    RASL_N for the leaves), the rest trailing pictures."""
    from chip_smoke import NAL_NAMES, nal_types
    stream = _port_run("open")[0]
    kinds = [NAL_NAMES[t] for t in nal_types(stream) if t < 32]
    assert kinds == ["IDR_W_RADL", "CRA_NUT", "RASL_R", "RASL_R", "RASL_N",
                     "RASL_N", "RASL_R", "RASL_N", "RASL_N", "TRAIL_R",
                     "TRAIL_N", "TRAIL_R"]


@pytest.mark.parametrize("writer", ["native", "python"])
def test_slice_writers_get_the_union_of_both_lists(writer):
    """Both slice writers are handed l0 followed by the l1 POCs that are
    not in l0 (kvazaar_tpu/api.py:650), not list 0 alone; the Python
    writer's stream is the native writer's."""
    stream, _, plan, unions, _, _ = _port_run("ref2",
                                              writer == "python")
    inter = [(p, u) for p, u in zip(plan, unions) if p["slice_type"] != 2]
    assert inter and all(u is not None for _, u in inter)
    for p, u in inter:
        assert u == p["l0"] + [q for q in p["l1"] if q not in p["l0"]]
    assert any(u != p["l0"] for p, u in inter)
    assert stream == _golden()["ref2_stream"].tobytes()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GOP_CONFIGS))
def test_gop_stream_matches_jax_live(name):
    from tools.torch_goldens import jax_gop_stream
    stream, decs, plan, _, _, _ = _port_run(name)
    cfg, n = GOP_CONFIGS[name]
    want, wdecs, wplan = jax_gop_stream(gop_frames(n), **cfg)
    assert plan == wplan
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want


# ---------------------------------------------------------------------
# the frame plan
# ---------------------------------------------------------------------

def _port_plan(name: str) -> list[dict]:
    cfg, n = GOP_PLANS[name]
    return drive_plan(Encoder(Config(width=W, height=H, **cfg),
                              device="cpu"), gop_frames(n))


@pytest.mark.parametrize("name", sorted(GOP_PLANS))
def test_frame_plan_matches_reference(name):
    assert _port_plan(name) == json.loads(str(_golden()[f"plan_{name}"]))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GOP_PLANS))
def test_frame_plan_matches_jax_live(name):
    from tools.torch_goldens import jax_gop_plan
    assert _port_plan(name) == jax_gop_plan(name)


def test_period_boundary_order_follows_reference():
    """A closed GOP whose intra period the stream reaches (-p 8 --gop 8,
    9 frames): the IDR at display index 8 is coded while frames 1-7 are
    still buffered, so they are coded after it, relative to it (POCs
    1-7), and a decoder outputs frame 8 before frames 1-7. This is the
    JAX package's order (kvazaar_tpu/api.py:714-724), logged as a
    reference fault in ROADMAP.md queue 3; the port reproduces it until
    both packages are fixed."""
    frames = [tuple(np.full_like(p, i) for p in f)
              for i, f in enumerate(gop_frames(9))]
    enc = Encoder(Config(width=W, height=H, **GOP_PLANS["p8g8"][0]),
                  device="cpu")
    sources = []
    submit = enc._submit_spec

    def spy(spec, y, cb, cr):
        sources.append(int(y[0, 0]))
        return submit(spec, y, cb, cr)
    enc._submit_spec = spy
    plan = drive_plan(enc, frames)
    assert plan == json.loads(str(_golden()["plan_p8g8"]))
    pocs = [p["poc"] for p in plan]
    assert sources == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert pocs == [0, 0, 4, 2, 1, 3, 6, 5, 7]
    shown = [sources[k] for k in sorted(
        range(9), key=lambda k: (k > 0, pocs[k]))]
    assert shown == [0, 8, 1, 2, 3, 4, 5, 6, 7]


# ---------------------------------------------------------------------
# the B leaf with distinct lists
# ---------------------------------------------------------------------

def _port_leaves() -> dict:
    from kvazaar_tpu_torch.models.inter_md import MdInterPipeline
    inp = gop_leaf_inputs()
    src = tuple(torch.from_numpy(p.astype(np.int32)) for p in inp["src"])
    stacks = [tuple(torch.stack([torch.from_numpy(r[c].astype(np.int32))
                                 for r in inp[lst]]) for c in range(3))
              for lst in ("l0", "l1")]
    out = {}
    for tag, bipred in (("b", True), ("u", False)):
        pipe = MdInterPipeline(H, W, LEAF_QP, n_refs=2, deblock=True,
                               bipred=bipred, device="cpu")
        me0, me1 = (pipe._me_sizes(src[0], s[0],
                                   [pipe._coarse_field(src[0], r)
                                    for r in s[0]]) for s in stacks)
        for n in (16, 64):
            res = pipe._inter_leaf_b(*src, *stacks, n, me0[n], me1[n])
            out.update({f"gleaf{tag}{n}_{k}": v.numpy()
                        for k, v in zip(LEAF_KEYS, res)})
    return out


@pytest.fixture(scope="module")
def port_leaves():
    return _port_leaves()


def _compare_leaves(got: dict, want: dict, tag: str) -> None:
    for n in (16, 64):
        for k in LEAF_KEYS:
            key = f"gleaf{tag}{n}_{k}"
            if k == "cost":
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)


@pytest.mark.parametrize("tag", ["b", "u"], ids=["bipred", "no_bipred"])
def test_leaf_distinct_lists_matches_golden(port_leaves, tag):
    _compare_leaves(port_leaves, dict(_golden()), tag)


@pytest.mark.parametrize("n", [16, 64])
def test_leaf_bipred_gate(port_leaves, n):
    """With bi-prediction some block takes the cross-reference pair
    (picture 0 of list 0, picture 1 of list 1, four different pictures
    in all); with --no-bipred no block is bi-predicted. In the port and
    in the golden."""
    g = _golden()
    for d in (port_leaves, {k: g[k] for k in g.files}):
        cross = ((d[f"gleafb{n}_dir"] == 3) & (d[f"gleafb{n}_r0"] == 0)
                 & (d[f"gleafb{n}_r1"] == 1))
        assert cross.any()
        assert (d[f"gleafu{n}_dir"] != 3).all()
        assert (d[f"gleafu{n}_dir"] == 2).any()


@pytest.mark.slow
def test_leaf_distinct_lists_matches_jax_live(port_leaves):
    from tools.torch_goldens import jax_gop_leaves
    want = jax_gop_leaves()
    for tag in ("b", "u"):
        _compare_leaves(port_leaves, want, tag)


def test_cli_encodes_bench_scenario_3_on_cpu(tmp_path):
    """python -m kvazaar_tpu_torch ... -p 24 --gop 8 with the tool row at
    QP 27 codes the 12 frames of the golden's scenario 3 stream, byte for
    byte."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.hevc"
    yuv.write_bytes(b"".join(p.tobytes() for f in gop_frames(12)
                             for p in f))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "kvazaar_tpu_torch", "-i",
                        str(yuv), "--input-res", f"{W}x{H}", "-o", str(out),
                        "-p", "24", "--gop", "8", "--qp", "27", "--sao",
                        "full", "--rdoq", "--device", "cpu"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == _golden()["g8_stream"].tobytes()
