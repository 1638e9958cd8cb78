"""The P program (--no-bipred) with SMP/AMP on the CPU
(tools/torch_goldens.py P_CONFIGS and the P stage goldens).

- kvazaar_tpu_torch.api encodes (a) the default configuration with
  bi-prediction off (IDR + 2 P at 128x64), (b) tests/test_smp.py's
  split-motion content with SMP and AMP (3 frames at 192x128, QP 30) and
  (c) bench scenario 2's GOP lp-g4d3t1 --ref 2 with the tool row and P
  slices (6 frames at 128x64); each stream must be byte-identical to the
  JAX package's (tests/data/torch_golden_p.npz, live in `slow` twins),
  with equal maps per frame (part8 and SAO parameters included), and
  decode hash-exactly in both packages' decoders. (b) chooses
  rectangular and asymmetric PUs; (c) predicts from a second picture.
- me_eval's one-list mode on stacks of 1, 2 and 4 pictures equals the
  JAX package's _eval_exact (XLA branch), tolerance 0; _global_mv and
  _part_mode_bits equal the JAX methods.
- _merge_align_p and the P leaf (n = 16, 64) on two-picture stacks and
  the SMP/AMP leaf (n = 16, 32) equal the JAX methods' decisions exactly
  and their costs within rtol 1e-5 (against the golden; live in `slow`).
- The P-path faults: the AUD's pic_type, the P slice header's list
  counts, the SPS's amp_enabled flag (tests/test_torch_package.py) and
  SMP slices coded by the Python writer.
"""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.torch_goldens import (H, LEAF_P_KEYS, LEAF_QP,  # noqa: E402
                                 MAP_KEYS, MERGE_P_KEYS, OUT_P as GOLDEN,
                                 P_CONFIGS, SAO_KEYS, SMP_KEYS, W,
                                 cross_inputs, jax_p_leaves, jax_stream,
                                 p_frames, split_inputs)
from kvazaar_tpu_torch.api import Encoder  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.ops import me  # noqa: E402

_RUNS: dict = {}


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
        cfg, kind, n = P_CONFIGS[name]
        frames = p_frames(kind, n)
        h, w = frames[0][0].shape
        enc = Encoder(Config(width=w, height=h, **cfg), device="cpu")
        stream, decs, infos = b"", [], []
        for f in frames:
            chunk, info = enc.encode_frame(*f)
            stream += chunk
            infos.append(info)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in MAP_KEYS})
        _RUNS[name] = (stream, decs, infos, enc)
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(P_CONFIGS))
def test_p_stream_byte_identical_to_reference(name):
    stream, decs, infos, _ = _port_run(name)
    assert [i["slice_type"] for i in infos] == [2] + [1] * (len(infos) - 1)
    g = np.load(GOLDEN)
    sao = P_CONFIGS[name][0].get("sao_type", "off") != "off"
    for i, d in enumerate(decs):
        in_port = set(SAO_KEYS) <= set(d)
        in_golden = f"{name}_f{i}_sao_y_typ" in g.files
        assert in_port == in_golden == sao
        # the P frames of the SMP configuration carry part8
        assert ("part8" in d) == (f"{name}_f{i}_part8" in g.files)
        for k in MAP_KEYS:
            if f"{name}_f{i}_{k}" in g.files:
                np.testing.assert_array_equal(
                    d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    assert stream == g[f"{name}_stream"].tobytes()


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", sorted(P_CONFIGS))
def test_p_stream_decodes_hash_exact(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, _, infos, _ = _port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


def test_smp_stream_chooses_rectangular_and_asymmetric_pus():
    """On the split-motion content the P frames code some 2NxN/Nx2N CU
    and some asymmetric one (parts 3-6), in the golden and in the
    port."""
    g = np.load(GOLDEN)
    _, decs, _, _ = _port_run("smp")
    for src in ("port", "golden"):
        used = set()
        for i in range(1, len(decs)):
            parts = decs[i]["part8"] if src == "port" \
                else g[f"smp_f{i}_part8"]
            used |= set(np.unique(parts).tolist())
        assert used & {1, 2} and used & {3, 4, 5, 6}, (src, used)


def test_smp_slices_take_the_python_writer():
    """The native P/B writer has no part_mode syntax: slices whose
    decisions carry part8 go to the Python writer (the IDR and the frames
    without SMP stay native)."""
    from kvazaar_tpu_torch import native
    for name in P_CONFIGS:
        _, decs, infos, enc = _port_run(name)
        n_plain = sum("part8" not in d for d in decs)
        assert enc.native_slices == (n_plain if native.available() else 0)
    assert sum("part8" in d for d in _port_run("smp")[1]) == 2


def test_lowdelay_p_predicts_from_second_reference():
    """Some P frame after POC 1 (whose stack repeats one picture) of the
    lp GOP predicts some inter cell from picture 1 of its list."""
    g = np.load(GOLDEN)
    _, decs, infos, _ = _port_run("lp_p")
    for src in ("golden", "port"):
        cells = []
        for i, info in enumerate(infos):
            if info["poc"] in (0, 1):
                continue
            d = decs[i] if src == "port" else {
                k: g[f"lp_p_f{i}_{k}"] for k in ("inter8", "ref8")}
            cells.append(int((d["inter8"].astype(bool)
                              & (d["ref8"] == 1)).sum()))
        assert any(cells), src


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(P_CONFIGS))
def test_p_stream_matches_jax_live(name):
    stream, decs, _, _ = _port_run(name)
    cfg, kind, n = P_CONFIGS[name]
    want, wdecs = jax_stream(p_frames(kind, n), **cfg)
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want


def test_cli_encodes_no_bipred_on_cpu(tmp_path):
    """python -m kvazaar_tpu_torch ... --no-bipred codes the golden's
    configuration (a) byte for byte, and it decodes hash-exactly."""
    import subprocess
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yuv, out = tmp_path / "in.yuv", tmp_path / "out.hevc"
    yuv.write_bytes(b"".join(p.tobytes() for f in p_frames("slice", 3)
                             for p in f))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "kvazaar_tpu_torch", "-i",
                        str(yuv), "--input-res", f"{W}x{H}", "-o", str(out),
                        "--no-bipred", "--device", "cpu"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pics = HEVCDecoder().decode(out.read_bytes())
    assert len(pics) == 3 and all(p.hash_ok for p in pics)
    assert out.read_bytes() == np.load(GOLDEN)["p_stream"].tobytes()


# ---------------------------------------------------------------------
# me_eval's one-list mode
# ---------------------------------------------------------------------

_ONE_JAX: dict = {}


def _jax_one_list(n: int, K: int, R: int):
    """Jitted JAX reference of one me_eval call in its one-list mode: per
    candidate the XLA branch of _eval_exact with its per-block reference
    index on a stack of R pictures (the 14-bit prediction of candidate
    0 beside it)."""
    if (n, K, R) not in _ONE_JAX:
        from kvazaar_tpu.models.inter_md import MdInterPipeline
        pipe = MdInterPipeline(H, W, 27, n_refs=R, deblock=False)
        cols = W // n
        bid = jnp.arange((H // n) * cols)
        y0, x0 = (bid // cols) * n, (bid % cols) * n

        def fn(st, b, mv, ri):
            sat, pred = [], None
            for k in range(K):
                s, v = pipe._eval_exact(None, st, b, y0, x0, mv[:, k],
                                        ri[:, k], n, want_pred=True, hi=True)
                sat.append(s)
                pred = v if pred is None else pred
            return jnp.stack(sat, axis=1), pred
        _ONE_JAX[(n, K, R)] = jax.jit(pipe._with_consts(fn)), pipe.consts
    return _ONE_JAX[(n, K, R)]


@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_me_eval_one_list_matches_jax(n, K):
    """me_eval (the wrapper on the CPU) and me_eval_plain in their
    one-list mode, on stacks of 1, 2 and 4 pictures with random and with
    coinciding per-candidate indices (most of them 0, MVs repeated), MVs
    reaching 20 px outside the picture, against the JAX package at
    tolerance 0."""
    rng = np.random.RandomState(90 + n + K)
    planes = rng.randint(0, 256, (4, H, W)).astype(np.int32)
    src = np.clip(np.roll(planes[0], (2, -5), (0, 1))
                  + rng.randint(-2, 3, (H, W)), 0, 255).astype(np.int32)
    rows, cols = H // n, W // n
    L = rows * cols
    blocks = np.ascontiguousarray(np.moveaxis(
        src.reshape(rows, n, cols, n), 1, 2).reshape(L, n, n))
    mv = rng.randint(-80, 81, (L, K, 2)).astype(np.int32)
    mv_tie = np.repeat(mv[:, :1], K, axis=1)
    flags = [(True, False)] + ([(False, True), (True, True)]
                               if K == 1 else [])
    for R in (1, 2, 4):
        ri = rng.randint(0, R, (L, K)).astype(np.int32)
        tie = ri * (rng.randint(0, 8, (L, K)) == 0)
        jf, consts = _jax_one_list(n, K, R)
        for name, (m, r) in {"random": (mv, ri),
                             "coinciding": (mv_tie, tie)}.items():
            js, jp = jf(consts, *(jnp.asarray(x) for x in
                                  (planes[:R], blocks, m, r)))
            t = [torch.from_numpy(np.ascontiguousarray(x))
                 for x in (planes[:R], blocks, m, r)]
            for want_satd, want_pred in flags:
                for f in (me.me_eval, me.me_eval_plain):
                    sat, pred = f(t[0], None, t[1], t[2], None, t[3], None,
                                  n=n, cols=cols, want_satd=want_satd,
                                  want_pred=want_pred)
                    msg = f"{name}, {R} pictures"
                    if want_satd:
                        assert len(sat) == 1
                        np.testing.assert_array_equal(
                            sat[0].numpy(), np.asarray(js), msg)
                    else:
                        assert sat is None
                    if want_pred:
                        assert len(pred) == 1
                        np.testing.assert_array_equal(
                            pred[0].numpy(), np.asarray(jp), msg)
                    else:
                        assert pred is None


def test_me_eval_one_list_checks_its_arguments():
    """The one-list mode takes neither list 1 MVs nor indices, and holds
    its indices to its stack."""
    st = torch.zeros((2, H, W), dtype=torch.int32)
    blocks = torch.zeros((32, 16, 16), dtype=torch.int32)
    mv = torch.zeros((32, 5, 2), dtype=torch.int32)
    r = torch.ones((32, 5), dtype=torch.int32)
    kw = dict(n=16, cols=8)
    sat, pred = me.me_eval(st, None, blocks, mv, None, r, None, **kw)
    assert len(sat) == 1 and pred is None
    for bad in ((st, None, blocks, mv, mv, r, None),
                (st, None, blocks, mv, None, r, r),
                (st, st, blocks, mv, None, r, None),
                (st, None, blocks, mv, None, r + 1, None),
                (st, None, blocks, mv, None, r - 2, None)):
        with pytest.raises(ValueError):
            me.me_eval(*bad, **kw)


# ---------------------------------------------------------------------
# the merge candidates' global MV and the part_mode price
# ---------------------------------------------------------------------

def test_global_mv_matches_jax_on_even_counts():
    """An even count of field values takes the float32 mean of the two
    middle values truncated toward zero (jnp.median, astype int32), not
    torch.median's lower middle value: middles 4 and 8 give 6 where
    torch.median gives 4; -3 and -4 give -3."""
    from kvazaar_tpu.models.inter_md import MdInterPipeline as JaxPipe
    from kvazaar_tpu_torch.models.inter_md import MdInterPipeline
    x = np.array([0, 4, 8, 12] * 4, np.int32)
    y = np.array([-8, -4, -3, 0] * 4, np.int32)
    rng = np.random.RandomState(5)
    fields = [np.stack([x, y], -1).reshape(4, 4, 2),
              np.stack([y, x], -1).reshape(2, 8, 2),
              rng.randint(-24, 25, (4, 6, 2)).astype(np.int32) * 4,
              rng.randint(-9, 10, (3, 5, 2)).astype(np.int32)]
    for f in fields:
        got = MdInterPipeline._global_mv(torch.from_numpy(f)).numpy()
        want = np.asarray(JaxPipe._global_mv(jnp.asarray(f)))
        np.testing.assert_array_equal(got, want)
    assert MdInterPipeline._global_mv(
        torch.from_numpy(fields[0])).tolist() == [6, -3]
    assert torch.from_numpy(x).median().item() == 4


@pytest.mark.parametrize("amp", [False, True])
def test_part_mode_bits_match_jax(amp):
    from kvazaar_tpu.models.inter_md import MdInterPipeline as JaxPipe
    from kvazaar_tpu_torch.models.inter_md import MdInterPipeline
    jp = JaxPipe(H, W, 27, smp=True, amp=amp)
    tp = MdInterPipeline(H, W, 27, smp=True, amp=amp, device="cpu")
    for part in range(1, 7):
        got = tp._part_mode_bits(part)
        assert got.dtype == torch.float32
        assert got.item() == float(np.asarray(jp._part_mode_bits(part)))


# ---------------------------------------------------------------------
# the P stages against the golden: merge alignment, P leaf, SMP leaf
# ---------------------------------------------------------------------

def _stack(inp):
    src = tuple(torch.from_numpy(p.astype(np.int32)) for p in inp["src"])
    refs = tuple(torch.stack([torch.from_numpy(r[c].astype(np.int32))
                              for r in inp["refs"]]) for c in range(3))
    return src, refs


def _port_p_stages() -> dict:
    from kvazaar_tpu_torch.models.inter_md import MdInterPipeline
    pipe = MdInterPipeline(H, W, LEAF_QP, n_refs=2, deblock=True,
                           device="cpu")
    src, refs = _stack(cross_inputs())
    fields = [pipe._coarse_field(src[0], r) for r in refs[0]]
    pipe._merge_field0 = fields[0]
    me_all = pipe._me_sizes(src[0], refs[0], fields)
    out = {}
    for n in (16, 64):
        rows, cols = H // n, W // n
        lam_satd = torch.sqrt(pipe.lam)
        mv_q, ref, satd, bits, pred = pipe._pick_ref_me(me_all[n], lam_satd)
        merge = pipe._merge_align_p(refs[0], pipe._blocks(src[0], n), rows,
                                    cols, n, mv_q, ref, satd, bits, pred,
                                    lam_satd)
        out.update({f"pmerge{n}_{k}": v.numpy()
                    for k, v in zip(MERGE_P_KEYS, merge)})
        leaf = pipe._inter_leaf_p(*src, refs, n, me_all[n])
        out.update({f"pleaf{n}_{k}": v.numpy()
                    for k, v in zip(LEAF_P_KEYS, leaf)})
    pipe = MdInterPipeline(H, W, LEAF_QP, n_refs=2, deblock=True, smp=True,
                           amp=True, device="cpu")
    src, refs = _stack(split_inputs())
    fields = [pipe._coarse_field(src[0], r) for r in refs[0]]
    for n in (16, 32):
        res = pipe._smp_leaf(*src, refs, fields, n)
        out.update({f"psmp{n}_{k}": v.numpy()
                    for k, v in zip(SMP_KEYS, res)})
    return out


@pytest.fixture(scope="module")
def port_p_stages():
    return _port_p_stages()


def _compare_stages(got: dict, want: dict, prefix: str) -> None:
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for key in keys:
        if key.endswith("_cost"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("stage", ["pmerge", "pleaf", "psmp"])
def test_p_stage_matches_golden(port_p_stages, stage):
    _compare_stages(port_p_stages, dict(np.load(GOLDEN)), stage)


def test_merge_alignment_adopts_candidates(port_p_stages):
    """The merge alignment of the cross_inputs adopts a candidate for some
    block at both sizes, and the P leaf picks the second picture for some
    block (the stages see both pictures of the stack)."""
    for n in (16, 64):
        assert port_p_stages[f"pmerge{n}_use"].any()
    assert (port_p_stages["pleaf16_ref"] == 1).any()


def test_smp_leaf_picks_the_split_geometry(port_p_stages):
    """On split_inputs (band edge at row 40) some 16-CU of rows 32-47
    takes a horizontal split (part 1) and some 32-CU of rows 32-63 an
    asymmetric one (2NxnU, part 3, whose first PU is the 8 rows above
    the edge)."""
    p16 = port_p_stages["psmp16_part"].reshape(H // 16, W // 16)
    p32 = port_p_stages["psmp32_part"].reshape(H // 32, W // 32)
    assert (p16[2] == 1).any()
    assert (p32[1] == 3).any()


@pytest.mark.slow
def test_p_stages_match_jax_live(port_p_stages):
    want = jax_p_leaves()
    for stage in ("pmerge", "pleaf", "psmp"):
        _compare_stages(port_p_stages, want, stage)


# ---------------------------------------------------------------------
# the P-path faults of the stream's syntax
# ---------------------------------------------------------------------

def _nal_units(stream: bytes) -> list[tuple[int, bytes]]:
    """(nal_unit_type, payload after the 2-byte header) of an Annex-B
    stream."""
    parts = stream.split(b"\x00\x00\x01")[1:]
    return [((p[0] >> 1) & 0x3F, p[2:].rstrip(b"\x00")) for p in parts]


@pytest.mark.parametrize("bipred", [False, True])
def test_aud_pic_type_by_slice_type(bipred):
    """The access unit delimiter names the frame's slice types: pic_type
    0 (I) for the IDR, 1 (P, I) for a P frame, 2 (B, P, I) for a B
    frame."""
    from kvazaar_tpu_torch.api import encode_sequence
    from kvazaar_tpu_torch.bitstream import NAL_AUD
    rng = np.random.RandomState(4)
    f0 = tuple(rng.randint(0, 256, s).astype(np.uint8)
               for s in ((64, 64), (32, 32), (32, 32)))
    frames = [f0, tuple(np.roll(p, 1, axis=1) for p in f0)]
    stream, infos = encode_sequence(
        Config(width=64, height=64, aud_enable=True, bipred=bipred),
        frames, device="cpu")
    auds = [p[0] >> 5 for t, p in _nal_units(stream) if t == NAL_AUD]
    assert [i["slice_type"] for i in infos] == [2, 0 if bipred else 1]
    assert auds == [0, 2 if bipred else 1]


def test_p_slice_header_counts_list0_only():
    """A P slice signals no list 1: one reference keeps the PPS default
    (no override), two override list 0's count alone; a B slice
    overrides both lists' counts."""
    enc = Encoder(Config(width=64, height=64, bipred=False), device="cpu")
    base = dict(is_idr=False, poc=3, qp=22, dpb_pocs=[2, 1])
    sh = enc._slice_header(dict(base, slice_type=1, l0=[2], l1=[]))
    assert sh.num_ref_idx_active_override == 0
    sh = enc._slice_header(dict(base, slice_type=1, l0=[2, 1], l1=[]))
    assert (sh.num_ref_idx_active_override, sh.num_ref_idx_l0_active_minus1,
            sh.num_ref_idx_l1_active_minus1) == (1, 1, 0)
    sh = enc._slice_header(dict(base, slice_type=0, l0=[2, 1],
                                l1=[2, 1]))
    assert (sh.num_ref_idx_active_override, sh.num_ref_idx_l0_active_minus1,
            sh.num_ref_idx_l1_active_minus1) == (1, 1, 1)
