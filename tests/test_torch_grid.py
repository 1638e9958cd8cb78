"""The 16x16-grid pipelines of the port on the CPU (--ctu 16:
models/intra_pipeline.py and models/inter_pipeline.py).

- Stages at 128x64 on seeded inputs, bit-exact against the JAX package's
  (kvazaar_tpu/models/intra_pipeline.py, inter_pipeline.py) run live and
  jitted with their constants traced, as its pipelines run them: the
  mode search, the +-8 integer motion search, quarter-pel luma and
  eighth-pel chroma MC (8-bit and 14-bit), the sub-pel refinement, the
  grid's RDOQ and sign-hiding fix, the transform path with the inter
  rounding offset, the wavefront (recon, levels, checksum, SSE, SAO
  maps), the boundary strengths of one and two lists, and the float32
  constants (SAO lambda, the B frame's second-list penalty) at every QP.
- Streams of tools/torch_goldens.py GRID_CONFIGS (IDR + 2 P at 120x72,
  the low-delay GOP, the B pyramid with SAO, RDOQ and sign hiding, WPP
  with rate control, frame_batch, field coding at 128x80) byte-identical
  to tests/data/torch_golden_grid.npz with equal maps, each decoding
  hash-exactly in the port's decoder; `-m slow` compares them live.
- frame_batch 2 gives the unbatched stream; the CLI codes --ctu 16; the
  encoder builds its grid pipelines on cuda by default.

Tolerances: 0 (maps, planes, streams, levels).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.torch_goldens import (GRID_CONFIGS, GRID_KEYS,  # noqa: E402
                                 OUT_GRID, grid_frames, jax_grid_stream)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder  # noqa: E402
from kvazaar_tpu_torch.models.inter_pipeline import (  # noqa: E402
    ME_RANGE, SUBPEL_PAD, InterPipeline, bi_penalty, edge_pad)
from kvazaar_tpu_torch.models.intra_pipeline import (  # noqa: E402
    IntraPipeline, _wave_structure)

H, W = 64, 128
QP = 30
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _frames(seed: int = 1):
    """Three 128x64 frames: a ramp with a noise patch that moves, and
    flat rows (SAD and SATD ties), each shifted a few pels."""
    rng = np.random.RandomState(seed)
    y = (np.add.outer(np.arange(H) * 2, np.arange(W) * 3) % 256).astype(
        np.uint8)
    y[16:48, 32:96] = rng.randint(0, 256, (32, 64))
    y[:8] = 77
    out = []
    for s in (0, 3, -5):
        out.append((np.roll(y, s, 1),
                    rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
                    rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)))
    return out


def _pipes(inter: bool = False, **kw):
    """(JAX pipeline, port pipeline on the CPU) at 128x64."""
    if inter:
        from kvazaar_tpu.models.inter_pipeline import InterPipeline as JP
        return (JP(H, W, QP, n_refs=2, **kw),
                InterPipeline(H, W, QP, n_refs=2, device="cpu", **kw))
    from kvazaar_tpu.models.intra_pipeline import IntraPipeline as JP
    return JP(H, W, QP, **kw), IntraPipeline(H, W, QP, device="cpu", **kw)


def _jit(jp, fn):
    """fn of the JAX pipeline jp jitted with its constants traced."""
    jax, _ = _jax()
    f = jax.jit(jp._with_consts(fn))
    return lambda *a: f(jp.consts, *a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def _blocks(y):
    return y.reshape(H // 16, 16, W // 16, 16).transpose(0, 2, 1, 3) \
        .reshape(-1, 16, 16).astype(np.int32)


# ---------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------

def test_wave_structure_covers_every_block_once():
    blocks, mask, wlen = _wave_structure(68, 120)
    assert blocks.shape == (254, wlen)
    assert sorted(blocks[mask].tolist()) == list(range(68 * 120))


def test_search_modes_match_reference():
    _, jnp = _jax()
    jp, tp = _pipes()
    for y, _, _ in _frames()[:2]:
        src = y.astype(np.int32)
        want = _jit(jp, jp._search_impl)(jnp.asarray(src))
        _eq(tp._search_impl(_t(src)), want)
    # a batch of frames at once
    both = np.stack([f[0] for f in _frames()]).astype(np.int32)
    _eq(tp._search_impl(_t(both))[2], _jit(jp, jp._search_impl)(both[2]))


def test_me_impl_matches_reference():
    _, jnp = _jax()
    jp, tp = _pipes(inter=True)
    f = _frames()
    src = _blocks(f[1][0])
    for ref in (f[0][0], f[2][0]):
        pad = np.pad(ref.astype(np.int32), ME_RANGE, mode="edge")
        mv_j, sad_j = _jit(jp, jp._me_impl)(jnp.asarray(src),
                                              jnp.asarray(pad))
        mv_t, sad_t = tp._me_impl(_t(src), _t(pad))
        _eq(mv_t, mv_j)
        _eq(sad_t, sad_j)
    assert (np.asarray(mv_j) != 0).any()


@pytest.mark.parametrize("hi", [False, True], ids=["8bit", "14bit"])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_mc_qpel_matches_reference(plane, hi):
    """A two-picture stack with a reference a block, then one plane; MVs
    beyond the padding (the clamp is the edge extension)."""
    jp, tp = _pipes(inter=True)
    f = _frames()
    rng = np.random.RandomState(7)
    nb = tp.n_blocks
    mv = rng.randint(-90, 90, (nb, 2)).astype(np.int32)
    ridx = rng.randint(0, 2, nb).astype(np.int32)
    k = 0 if plane == "luma" else 1
    p = SUBPEL_PAD if plane == "luma" else (SUBPEL_PAD >> 1) + 2
    stack = np.stack([f[0][k], f[2][k]]).astype(np.int32)
    pad = np.pad(stack, ((0, 0), (p, p), (p, p)), mode="edge")
    # chroma: the blocks' origins in the chroma plane
    org = ((tp.b_r * 8).numpy(), (tp.b_c * 8).numpy()) \
        if plane == "chroma" else ()
    jf = jp._mc_luma_qpel if plane == "luma" else jp._mc_chroma_qpel
    tf = tp._mc_luma_qpel if plane == "luma" else tp._mc_chroma_qpel
    for pl, r in ((pad, ridx), (pad[1], None)):
        want = _jit(jp, lambda a, m, *o: jf(a, m, *o, ridx=r, hi=hi))(
            pl, mv, *org)
        got = tf(_t(pl), _t(mv), *map(_t, org),
                 ridx=None if r is None else _t(r), hi=hi)
        _eq(got, want)


def test_subpel_refine_matches_reference():
    _, jnp = _jax()
    jp, tp = _pipes(inter=True)
    # smooth content moved by a fraction of a pel
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)

    def smooth(dy, dx):
        return np.round(128 + 60 * np.sin((xx + dx) / 5)
                        * np.cos((yy + dy) / 7)).astype(np.int32)
    src = _blocks(smooth(0.25, 1.5))
    ref = smooth(0, 0)
    mv_int, _ = tp._me_impl(_t(src), edge_pad(_t(ref), ME_RANGE))
    ypad = np.pad(ref, SUBPEL_PAD, mode="edge")
    mv_j, satd_j = _jit(jp, jp._subpel_refine)(src, ypad, mv_int.numpy())
    mv_t, satd_t = tp._subpel_refine(_t(src), _t(ypad), mv_int)
    _eq(mv_t, mv_j)
    _eq(satd_t, satd_j)
    assert (np.asarray(mv_j) % 4 != 0).any()     # sub-pel positions won


def _coeffs(n: int, seed: int) -> np.ndarray:
    """Transform-domain blocks: mostly small values, some large ones (the
    level range up to 2^12) and exact rounding boundaries."""
    rng = np.random.RandomState(seed)
    co = np.round(rng.laplace(0, 60, (96, n, n))).astype(np.int32)
    co[::7] = rng.randint(-32768, 32768, co[::7].shape)
    co[::5, :2, :2] *= 9
    return np.clip(co, -32768, 32767)


@pytest.mark.parametrize("n", [16, 8])
def test_rdoq_levels_match_reference(n):
    """_rdoq_levels with the QP traced, as _transform_quant calls it, at
    QPs across the range."""
    jax, jnp = _jax()
    from kvazaar_tpu.tables import QUANT_SCALES
    jp, tp = _pipes(rdoq=True)
    log2n = int(np.log2(n))
    tshift = 7 - log2n

    def jf(co, qp):
        qbits = 14 + qp // 6 + tshift
        scale = jnp.asarray(QUANT_SCALES, jnp.int32)[qp % 6]
        return jp._rdoq_levels(co, scale, qbits, qp, log2n, None)
    jf = jax.jit(jf)
    co = _coeffs(n, 3 + n)
    for qp in (0, 4, 13, 22, 27, 30, 37, 44, 51):
        want = jf(jnp.asarray(co), jnp.int32(qp))
        qbits = 14 + qp // 6 + tshift
        got = tp._rdoq_levels(_t(co), int(QUANT_SCALES[qp % 6]), qbits, qp,
                              log2n)
        _eq(got, want)


@pytest.mark.parametrize("n", [16, 8])
def test_sdh_fix_matches_reference(n):
    jax, jnp = _jax()
    jp, tp = _pipes(sign_hiding=True)
    rng = np.random.RandomState(n)
    lv = rng.randint(-3, 4, (64, n, n)).astype(np.int32)
    lv[rng.rand(64, n, n) < 0.5] = 0
    err = rng.randint(-(1 << 17), 1 << 17, (64, n, n)).astype(np.int32)
    qbits = 21
    want = jax.jit(lambda a, b: jp._sdh_fix(a, n, b, qbits))(lv, err)
    _eq(tp._sdh_fix(_t(lv), n, _t(err), qbits), want)
    assert (np.asarray(want) != lv).any()


@pytest.mark.parametrize("tools", [False, True], ids=["plain", "rdoq_sdh"])
def test_transform_quant_sel_matches_reference(tools):
    """The grid's T/Q/IT with the per-block inter rounding offset."""
    _, jnp = _jax()
    kw = dict(rdoq=True, sign_hiding=True) if tools else {}
    jp, tp = _pipes(inter=True, **kw)
    rng = np.random.RandomState(11)
    for n, t_j, t_t in ((16, "t16", tp.t16), (8, "t8", tp.t8)):
        resi = rng.randint(-90, 90, (40, n, n)).astype(np.int32)
        inter = rng.rand(40) < 0.5
        want = _jit(jp, lambda r, m: jp._transform_quant_sel(
            r, getattr(jp, t_j), jp.qp2[0], n, m))(resi, inter)
        got = tp._transform_quant_sel(_t(resi), t_t, QP, n, _t(inter))
        for g, w_ in zip(got, want):
            _eq(g, w_)


@pytest.mark.parametrize("tools", [False, True], ids=["plain", "tools"])
def test_waves_match_reference(tools):
    """The wavefront's recon and levels, then deblocking, SAO, the
    checksum and the SSE, on the search's modes."""
    _, jnp = _jax()
    kw = (dict(rdoq=True, sign_hiding=True, deblock=True, sao="full")
          if tools else {})
    jp, tp = _pipes(**kw)
    y, cb, cr = (p.astype(np.int32) for p in _frames()[1])
    modes = tp._search_impl(_t(y))
    want = _jit(jp, jp._waves_impl)(y, cb, cr, modes.numpy())
    got = tp._waves_impl(_t(y), _t(cb), _t(cr), modes)
    assert set(want) - {"lmask_y", "lmask_cb", "lmask_cr", "lvals_y",
                        "lvals_cb", "lvals_cr", "lvl_ovf"} \
        == {k.replace("levels_", "levels16_") for k in got} - {"n_waves"}
    for k, v in got.items():
        if k != "n_waves":
            _eq(v, want[k.replace("levels_", "levels16_")])
    assert got["n_waves"] == 2 * (H // 16 - 1) + W // 16


def test_bs_blocks_match_reference():
    jax, jnp = _jax()
    jp, tp = _pipes(inter=True)
    rng = np.random.RandomState(5)
    nb = tp.n_blocks
    is_inter = rng.rand(nb) < 0.7
    nz = rng.rand(nb) < 0.3
    mv = rng.randint(-6, 7, (nb, 2)).astype(np.int32)
    ridx = rng.randint(0, 2, nb).astype(np.int32)
    want = jax.jit(jp._bs_blocks)(is_inter, nz, mv, ridx)
    got = tp._bs_blocks(_t(is_inter), _t(nz), _t(mv), _t(ridx))
    for g, w_ in zip(got, want):
        _eq(g, w_)
    mv2 = rng.randint(-6, 7, (nb, 2, 2)).astype(np.int32)
    pocs = np.asarray([0, 2, 4, -(1 << 30)], np.int32)
    poc2 = pocs[rng.randint(0, 4, (nb, 2))]
    want = jax.jit(jp._bs_blocks_bi)(is_inter, nz, mv2, poc2)
    got = tp._bs_blocks_bi(_t(is_inter), _t(nz), _t(mv2), _t(poc2))
    for g, w_ in zip(got, want):
        _eq(g, w_)
        assert set(np.unique(np.asarray(w_)).tolist()) == {0, 1, 2}


def test_float32_constants_match_reference():
    """SAO's lambda and the B frame's second-list penalty at every QP, as
    the reference's jitted programs form them in float32."""
    jax, jnp = _jax()
    from kvazaar_tpu_torch.models.intra_md import ts_lambda
    q = jnp.arange(52, dtype=jnp.int32)
    lam = jax.jit(lambda q: 0.57 * 2.0 ** ((q.astype(jnp.float32) - 12.0)
                                           / 3.0))(q)
    pen = jax.jit(lambda q: (12.0 * (jnp.sqrt(0.57) * 2.0 ** (
        (q.astype(jnp.float32) - 12.0) / 6.0))).astype(jnp.int32))(q)
    np.testing.assert_array_equal(
        np.float32([ts_lambda(i) for i in range(52)]), np.asarray(lam))
    np.testing.assert_array_equal([bi_penalty(i) for i in range(52)],
                                  np.asarray(pen))


# ---------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------

def port_grid_run(name: str):
    """A GRID_CONFIGS stream of the port on the CPU: (stream, infos, the
    GRID_KEYS maps per coded frame)."""
    import copy
    from kvazaar_tpu_torch.api import field_config
    kw, w, h, n = GRID_CONFIGS[name]
    cfg = Config(width=w, height=h, qp=30, **kw)
    enc = Encoder(field_config(copy.copy(cfg)), device="cpu")
    decs = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        decs.append({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                     for k, v in enc._last_decisions.items()
                     if k in GRID_KEYS})
        return out
    enc.finalize_frame = record
    stream, infos = encode_sequence(cfg, grid_frames(n, w, h), encoder=enc)
    return stream, infos, decs


def _check_maps(decs, want_decs):
    assert len(decs) == len(want_decs)
    for d, w_ in zip(decs, want_decs):
        assert set(d) == set(w_)
        for k in d:
            np.testing.assert_array_equal(d[k], w_[k], err_msg=k)


def _golden_run(name: str):
    g = np.load(OUT_GRID)
    pre = name + "_"
    stream = g[pre + "stream"].tobytes()
    decs = []
    i = 0
    while any(k.startswith(f"{pre}f{i}_") for k in g.files):
        decs.append({k[len(f"{pre}f{i}_"):]: g[k] for k in g.files
                     if k.startswith(f"{pre}f{i}_")})
        i += 1
    return stream, decs


@pytest.mark.parametrize("name", sorted(GRID_CONFIGS))
def test_grid_stream_matches_reference(name):
    stream, infos, decs = port_grid_run(name)
    want, want_decs = _golden_run(name)
    assert stream == want
    _check_maps(decs, want_decs)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos) and all(p.hash_ok for p in pics)
    kw, w, h, n = GRID_CONFIGS[name]
    field = kw.get("source_scan_type") == "tff"
    assert len(infos) == (2 * n if field else n)
    assert pics[0].planes[0].shape == ((h // 2, w) if field else (h, w))
    if name in ("p", "lp", "wpp_rc"):
        assert [i["slice_type"] for i in infos][1:] == [1] * (n - 1)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GRID_CONFIGS))
def test_grid_stream_matches_reference_live(name):
    stream, _, decs = port_grid_run(name)
    want, want_decs = jax_grid_stream(name)
    assert stream == want
    _check_maps(decs, want_decs)


def test_frame_batch_equals_unbatched():
    """frame_batch 2 runs frames 0-1 through one pass of the waves and
    frame 2 alone; the stream equals frame-by-frame coding."""
    frames = grid_frames(3, 120, 72)
    cfg = dict(width=120, height=72, qp=27, ctu_size=16, intra_period=1,
               deblock_enable=True, sao_type="full")
    calls = []
    enc = Encoder(Config(frame_batch=2, **cfg), device="cpu")
    many = enc._pipeline.submit_many
    enc._pipeline.submit_many = lambda ys, *a, **k: (
        calls.append(len(ys)), many(ys, *a, **k))[1]
    batched, _ = encode_sequence(enc.cfg, frames, encoder=enc)
    single, _ = encode_sequence(Config(**cfg), frames, device="cpu")
    assert calls == [2, 1]
    assert batched == single
    pics = HEVCDecoder().decode(batched)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)


def test_encoder_builds_grid_pipelines_on_cuda_by_default():
    cfg = Config(width=120, height=72, ctu_size=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Encoder(cfg)
    enc = Encoder(cfg, device="cpu")
    assert type(enc._pipeline) is InterPipeline
    assert enc._pipeline.device.type == "cpu"
    assert (enc.sps.width, enc.sps.height) == (128, 80)
    assert enc.sps.conf_win == (0, 4, 0, 4)
    assert enc.use_device and enc.inter_enabled and not enc.use_md
    gop = Encoder(Config(width=128, height=64, ctu_size=16, gop_len=8),
                  device="cpu")
    assert gop.gop_enabled and gop.n_refs == gop._pipeline.n_refs == 4
    intra = Encoder(Config(width=128, height=64, ctu_size=16,
                           intra_period=1), device="cpu")
    assert type(intra._pipeline) is IntraPipeline


def test_oba_falls_back_to_lambda_off_ctb64(capsys):
    cfg = Config(width=128, height=64, ctu_size=16, target_bitrate=500000,
                 rc_algorithm="oba")
    enc = Encoder(cfg, device="cpu")
    assert cfg.rc_algorithm == "lambda"
    assert type(enc._rc).__name__ == "RateControl"
    assert "falling back to lambda RC" in capsys.readouterr().err


def test_cli_encodes_ctu16_on_cpu(tmp_path):
    """python -m kvazaar_tpu_torch --ctu 16 codes IDR + P at 120x72 (a
    conformance window), hash-exact, with encode_sequence's stream."""
    frames = grid_frames(2, 120, 72)
    yuv = tmp_path / "in.yuv"
    out = tmp_path / "out.hevc"
    yuv.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    r = subprocess.run([sys.executable, "-m", "kvazaar_tpu_torch", "-i",
                        str(yuv), "--input-res", "120x72", "-o", str(out),
                        "--ctu", "16", "--device", "cpu"], cwd=ROOT,
                       env=ONE_THREAD, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    pics = HEVCDecoder().decode(out.read_bytes())
    assert len(pics) == 2 and all(p.hash_ok for p in pics)
    want, _ = encode_sequence(Config(width=120, height=72, ctu_size=16),
                              frames, device="cpu")
    assert out.read_bytes() == want
