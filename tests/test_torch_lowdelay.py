"""Bench scenario 2 on the CPU: the low-delay GOP lp-g4d3t1 with two
reference pictures a list (tools/torch_goldens.py LOWDELAY_CONFIGS).

- kvazaar_tpu_torch.api encodes 6 frames (IDR + 5 B) of slice_frames at
  128x64 with the default tools and with bench scenario 1's tool row at
  QP 27; each stream must be byte-identical to the JAX package's
  (tests/data/torch_golden_lowdelay.npz, live in `slow` twins), with
  equal maps per frame, and decode hash-exactly in both packages'
  decoders. Some block of some B frame predicts from a second reference
  picture.
- The frame plan (POC, QP, l0, l1, is_ref, the retained DPB) of 9 frames
  at --ref 1, 2 and 4 equals the JAX package's.
- me_eval_plain on two-picture stacks with per-pair reference indices
  equals the JAX package's _eval_exact for each list (XLA branch) plus
  _bi_avg and _satd_tiles, tolerance 0.
- One B leaf (n = 16 and 64) with two-picture stacks equals the JAX
  method's decisions exactly and its cost within rtol 1e-5, on inputs
  where the cross-reference bi candidate wins.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.torch_goldens import (H, LEAF_QP, LOWDELAY,  # noqa: E402
                                 LOWDELAY_CONFIGS, MAP_KEYS,
                                 OUT_LOWDELAY as GOLDEN, PLAN_FRAMES,
                                 PLAN_REFS, SAO_KEYS, cross_inputs,
                                 jax_lowdelay_leaves,
                                 jax_plan, jax_stream, plan_entry,
                                 slice_frames, W)
from chip_smoke import second_ref_blocks  # noqa: E402
from kvazaar_tpu_torch.api import Encoder  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.ops import me  # noqa: E402

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


def _port_run(name: str):
    """(stream, per-frame maps, infos, encoder) of the port on the CPU,
    once per configuration."""
    if name not in _RUNS:
        cfg, n = LOWDELAY_CONFIGS[name]
        enc = Encoder(Config(width=W, height=H, **cfg), device="cpu")
        stream, decs, infos = b"", [], []
        for f in slice_frames(n):
            chunk, info = enc.encode_frame(*f)
            stream += chunk
            infos.append(info)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in MAP_KEYS})
        _RUNS[name] = (stream, decs, infos, enc)
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(LOWDELAY_CONFIGS))
def test_lowdelay_stream_byte_identical_to_reference(name):
    stream, decs, infos, enc = _port_run(name)
    g = np.load(GOLDEN)
    sao = LOWDELAY_CONFIGS[name][0].get("sao_type", "off") != "off"
    for i, d in enumerate(decs):
        # the tool row's frames carry their SAO parameters, compared too
        in_port = set(SAO_KEYS) <= set(d)
        in_golden = f"{name}_f{i}_sao_y_typ" in g.files
        assert in_port == in_golden == sao
        for k in MAP_KEYS:
            if f"{name}_f{i}_{k}" in g.files:
                np.testing.assert_array_equal(
                    d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    assert stream == g[f"{name}_stream"].tobytes()
    assert enc.native_slices == len(infos)
    # the lp-g4d3t1 layers: QP offsets -1 (IDR), 3, 2, 3, 1, 3
    base = LOWDELAY_CONFIGS[name][0].get("qp", Config().qp)
    assert [i["qp"] - base for i in infos] == [-1, 3, 2, 3, 1, 3]


@pytest.mark.parametrize("name", sorted(LOWDELAY_CONFIGS))
def test_golden_predicts_from_second_reference(name):
    """Some B frame after POC 1 (whose lists repeat one picture) predicts
    some block from the second picture of a list, in the golden and in
    the port."""
    g = np.load(GOLDEN)
    _, decs, infos, _ = _port_run(name)
    for src in ("golden", "port"):
        cells = []
        for i, info in enumerate(infos):
            if info["poc"] in (0, 1):
                continue
            d = decs[i] if src == "port" else {
                k: g[f"{name}_f{i}_{k}"]
                for k in ("inter8", "dir8", "ref8", "ref8b")}
            cells.append(second_ref_blocks(d))
        assert any(cells), src


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", sorted(LOWDELAY_CONFIGS))
def test_lowdelay_stream_decodes_hash_exact(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, infos, _ = _port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(LOWDELAY_CONFIGS))
def test_lowdelay_stream_matches_jax_live(name):
    stream, decs, _, _ = _port_run(name)
    cfg, n = LOWDELAY_CONFIGS[name]
    want, wdecs = jax_stream(slice_frames(n), **cfg)
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want


# ---------------------------------------------------------------------
# the frame plan
# ---------------------------------------------------------------------

class _PlanOnly:
    """Stands in for the port's pipeline: no device work, records the
    reference POCs and QP each frame was submitted with."""

    def __init__(self):
        self.calls = []

    def submit(self, y, cb, cr, qp=None):
        self.calls.append(([], qp))
        return {"rec_y": y, "rec_cb": cb, "rec_cr": cr}

    def submit_inter_b(self, y, cb, cr, l0, l1, l0_pocs, l1_pocs, qp=None):
        assert l1 is l0 and list(l1_pocs) == list(l0_pocs)
        assert len(l0[0]) == len(l0_pocs)
        self.calls.append((list(l0_pocs), qp))
        return {"rec_y": y, "rec_cb": cb, "rec_cr": cr}


def _port_plan(ref_frames: int):
    enc = Encoder(Config(width=W, height=H,
                         **dict(LOWDELAY, ref_frames=ref_frames)),
                  device="cpu")
    enc._pipeline = stub = _PlanOnly()
    plan = [plan_entry(enc.submit_frame(*f))
            for f in slice_frames(PLAN_FRAMES)]
    return plan, stub.calls


@pytest.mark.parametrize("ref_frames", PLAN_REFS)
def test_frame_plan_matches_reference(ref_frames):
    plan, calls = _port_plan(ref_frames)
    want = json.loads(str(np.load(GOLDEN)[f"plan_ref{ref_frames}"]))
    assert plan == want
    # the pipeline got each frame's QP and list 0
    assert calls == [(p["l0"], p["qp"]) for p in plan]


@pytest.mark.slow
@pytest.mark.parametrize("ref_frames", PLAN_REFS)
def test_frame_plan_matches_jax_live(ref_frames):
    assert _port_plan(ref_frames)[0] == jax_plan(ref_frames)


def test_frame_plan_of_bench_scenario_2():
    """The plan of bench.py's scenario 2 at QP 27: POC, QP and l0 as the
    low-delay GOP lp-g4d3t1 with --ref 2 sets them."""
    enc = Encoder(Config(width=W, height=H, qp=27, **LOWDELAY),
                  device="cpu")
    enc._pipeline = _PlanOnly()
    got = [(p["poc"], p["qp"], p["l0"]) for p in
           (plan_entry(enc.submit_frame(*f)) for f in slice_frames(6))]
    assert got == [(0, 26, []), (1, 30, [0]), (2, 29, [1, 0]),
                   (3, 30, [2, 0]), (4, 28, [3, 0]), (5, 30, [4, 0])]


# ---------------------------------------------------------------------
# me_eval on reference stacks
# ---------------------------------------------------------------------

_STACK_JAX: dict = {}


def _jax_stack_pairs(n: int, K: int):
    """Jitted JAX reference of one me_eval call on reference stacks: per
    pair, the XLA branch of _eval_exact for each list with its per-block
    reference index, then _bi_avg and _satd_tiles."""
    if (n, K) not in _STACK_JAX:
        from kvazaar_tpu.models.inter_md import MdInterPipeline
        pipe = MdInterPipeline(H, W, 27, n_refs=2, deblock=False)
        cols = W // n
        L = (H // n) * cols
        bid = jnp.arange(L)
        y0, x0 = (bid // cols) * n, (bid % cols) * n

        def fn(s0, s1, b, m0, m1, i0, i1):
            sat, preds = [], None
            for k in range(K):
                a0, v0 = pipe._eval_exact(None, s0, b, y0, x0, m0[:, k],
                                          i0[:, k], n, want_pred=True,
                                          hi=True)
                a1, v1 = pipe._eval_exact(None, s1, b, y0, x0, m1[:, k],
                                          i1[:, k], n, want_pred=True,
                                          hi=True)
                sbi = pipe._satd_tiles(b - pipe._bi_avg(v0, v1, pipe.maxv))
                sat.append((a0, a1, sbi))
                preds = preds or (v0, v1)
            return tuple(jnp.stack(c, axis=1) for c in zip(*sat)), preds
        _STACK_JAX[(n, K)] = jax.jit(pipe._with_consts(fn)), pipe.consts
    return _STACK_JAX[(n, K)]


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_me_eval_on_stacks_matches_jax(n, K):
    """me_eval_plain (and the wrapper on the CPU) on stacks of two
    pictures, against the JAX package at tolerance 0: random per-pair
    indices with list 1 on its own stack, and tie-heavy ones (list 1's
    indices and MVs equal to list 0's on one shared stack, most indices
    0), MVs reaching 20 px outside the picture."""
    rng = np.random.RandomState(70 + n + K)
    planes = rng.randint(0, 256, (3, H, W)).astype(np.int32)
    src = np.clip(np.roll(planes[0], (2, -5), (0, 1))
                  + rng.randint(-2, 3, (H, W)), 0, 255).astype(np.int32)
    rows, cols = H // n, W // n
    L = rows * cols
    blocks = np.ascontiguousarray(np.moveaxis(
        src.reshape(rows, n, cols, n), 1, 2).reshape(L, n, n))
    s0, s1 = planes[:2], planes[[2, 0]]
    m0 = rng.randint(-80, 81, (L, K, 2)).astype(np.int32)
    m1 = rng.randint(-80, 81, (L, K, 2)).astype(np.int32)
    i0 = rng.randint(0, 2, (L, K)).astype(np.int32)
    i1 = rng.randint(0, 2, (L, K)).astype(np.int32)
    tie = (rng.randint(0, 8, (L, K)) == 0).astype(np.int32)
    cases = {"random": (s0, s1, m0, m1, i0, i1),
             "tie_heavy": (s0, s0, m0, m0, tie, tie)}
    jf, consts = _jax_stack_pairs(n, K)
    flags = [(True, False)] + ([(False, True), (True, True)]
                               if K == 1 else [])
    for name, (a0, a1, b0, b1, r0, r1) in cases.items():
        js, jp = jf(consts, *(jnp.asarray(x) for x in (a0, a1, blocks, b0,
                                                        b1, r0, r1)))
        t = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (a0, a1, blocks, b0, b1, r0, r1)]
        if a1 is a0:
            t[1] = t[0]
        for want_satd, want_pred in flags:
            for f in (me.me_eval, me.me_eval_plain):
                sat, pred = f(*t, n=n, cols=cols, want_satd=want_satd,
                              want_pred=want_pred)
                for got, want in zip(sat or (), js):
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want), name)
                for got, want in zip(pred or (), jp):
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want), name)


# ---------------------------------------------------------------------
# the B leaf with two pictures a list
# ---------------------------------------------------------------------

def _port_leaves() -> dict:
    from kvazaar_tpu_torch.models.inter_md import MdInterPipeline
    inp = cross_inputs()
    pipe = MdInterPipeline(H, W, LEAF_QP, n_refs=2, deblock=True,
                           device="cpu")
    src = tuple(torch.from_numpy(p.astype(np.int32)) for p in inp["src"])
    stack = tuple(torch.stack([torch.from_numpy(r[c].astype(np.int32))
                               for r in inp["refs"]]) for c in range(3))
    fields = [pipe._coarse_field(src[0], r) for r in stack[0]]
    me_all = pipe._me_sizes(src[0], stack[0], fields)
    out = {}
    for n in (16, 64):
        res = pipe._inter_leaf_b(*src, stack, stack, n, me_all[n],
                                 me_all[n])
        out.update({f"ldleaf{n}_{k}": v.numpy()
                    for k, v in zip(LEAF_KEYS, res)})
    return out


@pytest.fixture(scope="module")
def port_leaves():
    return _port_leaves()


def _compare_leaves(got: dict, want: dict) -> None:
    for n in (16, 64):
        for k in LEAF_KEYS:
            key = f"ldleaf{n}_{k}"
            if k == "cost":
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)


def test_leaf_two_references_matches_golden(port_leaves):
    _compare_leaves(port_leaves, dict(np.load(GOLDEN)))


@pytest.mark.parametrize("n", [16, 64])
def test_leaf_cross_reference_candidate_wins(port_leaves, n):
    """Both lists hold the same two pictures, so each list's own best
    picture is the same and a bi block on pictures (0, 1) comes from the
    cross-reference candidate (directly or through a merge with a block
    that took it): some block of the input takes it."""
    g = np.load(GOLDEN)
    for d in (port_leaves, {k: g[k] for k in g.files}):
        cross = ((d[f"ldleaf{n}_dir"] == 3) & (d[f"ldleaf{n}_r0"] == 0)
                 & (d[f"ldleaf{n}_r1"] == 1))
        assert cross.any()


@pytest.mark.slow
def test_leaf_two_references_matches_jax_live(port_leaves):
    _compare_leaves(port_leaves, jax_lowdelay_leaves())


def test_cli_encodes_bench_scenario_2_on_cpu(tmp_path):
    """python -m kvazaar_tpu_torch ... -p 0 --gop lp-g4d3t1 --ref 2 codes
    the first 3 frames of the default-tools golden's stream, byte for
    byte, and they decode hash-exactly."""
    import subprocess
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.hevc"
    yuv.write_bytes(b"".join(p.tobytes() for f in slice_frames(3)
                             for p in f))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "kvazaar_tpu_torch", "-i",
                        str(yuv), "--input-res", f"{W}x{H}", "-o", str(out),
                        "-p", "0", "--gop", "lp-g4d3t1", "--ref", "2",
                        "--device", "cpu"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pics = HEVCDecoder().decode(out.read_bytes())
    assert len(pics) == 3 and all(p.hash_ok for p in pics)
    assert np.load(GOLDEN)["lp_stream"].tobytes().startswith(
        out.read_bytes())
