"""The PyTorch port's motion-estimation kernels (kvazaar_tpu_torch/ops/me.py)
against the JAX reference: the plain versions must be bit-exact with the
XLA twins the JAX package runs off-TPU (_me_xla_one for me_refine; the
XLA branch of _eval_exact for each list of me_eval, _bi_avg and
_satd_tiles for its pair). The CUDA kernels are held against the plain
versions in tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kvazaar_tpu.models.inter_md import MdInterPipeline  # noqa: E402
from kvazaar_tpu_torch.ops import me  # noqa: E402

H, W = 64, 128


def _inputs(seed):
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, 256, (H, W)).astype(np.int32)
    src = np.clip(np.roll(ref, (2, -5), (0, 1))
                  + rng.randint(-2, 3, (H, W)), 0, 255).astype(np.int32)
    return rng, ref, src


def _blocks(src, n):
    rows, cols = H // n, W // n
    return np.ascontiguousarray(np.moveaxis(
        src.reshape(rows, n, cols, n), 1, 2).reshape(rows * cols, n, n))


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_me_plain_matches_jax_twins(n):
    rng, ref, src = _inputs(11 + n)
    pipe = MdInterPipeline(H, W, 27, n_refs=1, deblock=False)
    rows, cols = H // n, W // n
    L = rows * cols
    blocks = _blocks(src, n)
    # out-of-frame candidates (+-20 px around 64x128) exercise clamping
    cands = rng.randint(-20, 21, (L, 3, 2)).astype(np.int32)
    mvs = rng.randint(-80, 81, (L, 2)).astype(np.int32)
    bid = jnp.arange(L)
    y0, x0 = (bid // cols) * n, (bid % cols) * n

    def jax_fn(s, r, c, lam, b, m):
        refine = pipe._me_xla_one(s, r, c, n, lam)
        evals = [pipe._eval_exact(None, r[None], b, y0, x0, m,
                                  jnp.zeros((L,), jnp.int32), n,
                                  want_pred=True, hi=hi)
                 for hi in (False, True)]
        return refine, evals

    jf = jax.jit(pipe._with_consts(jax_fn))
    t_ref, t_blocks = torch.from_numpy(ref), torch.from_numpy(blocks)
    for lam in (0, 37):
        (mv, sd, pr), evals = jf(pipe.consts, jnp.asarray(src),
                                 jnp.asarray(ref), jnp.asarray(cands),
                                 jnp.int32(lam), jnp.asarray(blocks),
                                 jnp.asarray(mvs))
        tm, ts, tp = me.me_refine_plain(t_ref, t_blocks,
                                        torch.from_numpy(cands),
                                        torch.tensor([lam]), n, cols)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(mv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(sd))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(pr))
    for hi, (s2, p2) in zip((False, True), evals):
        es, ep = me.eval_one_plain(t_ref, t_blocks, torch.from_numpy(mvs), n,
                                   cols, hi)
        np.testing.assert_array_equal(es.numpy(), np.asarray(s2))
        np.testing.assert_array_equal(ep.numpy(), np.asarray(p2))


_PAIR_JAX = {}


def _jax_pairs(n, K):
    """Jitted JAX reference of one me_eval call: per pair, the XLA branch
    of _eval_exact for each list (14-bit predictions), then _bi_avg and
    _satd_tiles for the pair. Returns (satd0, satd1, satd_bi) [L, K] and
    the predictions of pair 0."""
    if (n, K) not in _PAIR_JAX:
        pipe = MdInterPipeline(H, W, 27, n_refs=1, deblock=False)
        rows, cols = H // n, W // n
        L = rows * cols
        bid = jnp.arange(L)
        y0, x0 = (bid // cols) * n, (bid % cols) * n
        zero = jnp.zeros((L,), jnp.int32)

        def fn(r0, r1, b, m0, m1):
            sat, preds = [], None
            for k in range(K):
                s0, v0 = pipe._eval_exact(None, r0[None], b, y0, x0,
                                          m0[:, k], zero, n, want_pred=True,
                                          hi=True)
                s1, v1 = pipe._eval_exact(None, r1[None], b, y0, x0,
                                          m1[:, k], zero, n, want_pred=True,
                                          hi=True)
                sbi = pipe._satd_tiles(b - pipe._bi_avg(v0, v1, pipe.maxv))
                sat.append((s0, s1, sbi))
                preds = preds or (v0, v1)
            return tuple(jnp.stack(c, axis=1) for c in zip(*sat)), preds
        _PAIR_JAX[(n, K)] = jax.jit(pipe._with_consts(fn)), pipe.consts
    return _PAIR_JAX[(n, K)]


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_me_eval_pairs_match_jax(n, K):
    """me_eval_plain (and the wrapper on the CPU) against the JAX
    package, tolerance 0: K pairs a block with MVs reaching 20 px outside
    the picture, on one plane for both lists and on two planes (stacks of
    one, reference indices 0), with satd only, predictions only (K = 1)
    and both."""
    rng, ref, src = _inputs(50 + n + K)
    ref1 = rng.randint(0, 256, (H, W)).astype(np.int32)
    cols = W // n
    blocks = _blocks(src, n)
    L = blocks.shape[0]
    jf, consts = _jax_pairs(n, K)
    t_blocks = torch.from_numpy(blocks)
    for r0, r1 in ((ref, ref), (ref, ref1)):
        m0 = rng.randint(-80, 81, (L, K, 2)).astype(np.int32)
        m1 = rng.randint(-80, 81, (L, K, 2)).astype(np.int32)
        (js, (jv0, jv1)) = jf(consts, jnp.asarray(r0), jnp.asarray(r1),
                              jnp.asarray(blocks), jnp.asarray(m0),
                              jnp.asarray(m1))
        t0 = torch.from_numpy(r0)[None]
        t1 = t0 if r1 is r0 else torch.from_numpy(r1)[None]
        zero = torch.zeros((L, K), dtype=torch.int32)
        flags = [(True, False)] + ([(False, True), (True, True)]
                                   if K == 1 else [])
        for want_satd, want_pred in flags:
            for f in (me.me_eval, me.me_eval_plain):
                sat, pred = f(t0, t1, t_blocks, torch.from_numpy(m0),
                              torch.from_numpy(m1), zero, zero, n=n,
                              cols=cols, want_satd=want_satd,
                              want_pred=want_pred)
                assert (sat is None) != want_satd
                assert (pred is None) != want_pred
                for got, want in zip(sat or (), js):
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))
                for got, want in zip(pred or (), (jv0, jv1)):
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))


def test_satd_tiles_matches_float_hadamard():
    rng = np.random.RandomState(5)
    d = rng.randint(-255, 256, (6, 16, 24)).astype(np.int32)
    pipe = MdInterPipeline(64, 64, 22, n_refs=1)
    want = np.asarray(pipe._satd_tiles(jnp.asarray(d)))
    got = me.satd_tiles(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_take_plain_version_on_cpu():
    rng, ref, src = _inputs(3)
    n, cols = 16, W // 16
    blocks = _blocks(src, n)
    L = blocks.shape[0]
    cands = torch.from_numpy(rng.randint(-9, 10, (L, 2, 2)).astype(np.int32))
    lam = torch.tensor([21], dtype=torch.int32)
    mv0, mv1 = (torch.from_numpy(rng.randint(-30, 31, (L, 1, 2))
                                 .astype(np.int32)) for _ in range(2))
    t_ref, t_blocks = torch.from_numpy(ref), torch.from_numpy(blocks)
    before = (me.me_refine.launches, me.me_eval.launches)
    a = me.me_refine(t_ref, t_blocks, cands, lam, n=n, cols=cols)
    b = me.me_refine_plain(t_ref, t_blocks, cands, lam, n, cols)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    kw = dict(n=n, cols=cols, want_pred=True)
    st = torch.stack([t_ref, t_ref.flip(1).contiguous()])
    ri = torch.from_numpy(rng.randint(0, 2, (L, 1)).astype(np.int32))
    a = me.me_eval(st, st, t_blocks, mv0, mv1, ri, 1 - ri, **kw)
    b = me.me_eval_plain(st, st, t_blocks, mv0, mv1, ri, 1 - ri, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))
    # launch counters count kernel launches only
    assert (me.me_refine.launches, me.me_eval.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "size",
                                 "ref1", "pred_k", "maxv", "no_output",
                                 "plane", "r_shape", "r_low", "r_high"])
def test_wrappers_reject_bad_inputs(bad):
    """me_eval refuses what its kernel does not take, on every device:
    wrong types, shapes or layouts, predictions of more than one pair,
    samples beyond 10 bits (the kernel's float32 range), a call that
    asks for nothing, a single plane where a stack is due, and reference
    indices of the wrong shape or outside their stack."""
    ref = torch.zeros((2, H, W), dtype=torch.int32)
    ref1 = ref[:1]
    blocks = torch.zeros((32, 16, 16), dtype=torch.int32)
    mv0 = torch.zeros((32, 1, 2), dtype=torch.int32)
    mv1 = mv0
    r0 = torch.ones((32, 1), dtype=torch.int32)
    r1 = torch.zeros((32, 1), dtype=torch.int32)
    kw = dict(n=16, cols=8)
    me.me_eval(ref, ref1, blocks, mv0, mv1, r0, r1, maxv=1023,
               want_pred=True, **kw)
    if bad == "dtype":
        ref = ref.to(torch.int64)
    elif bad == "shape":
        mv1 = torch.zeros((31, 1, 2), dtype=torch.int32)
    elif bad == "contiguous":
        ref = torch.zeros((2, W, H), dtype=torch.int32).transpose(1, 2)
    elif bad == "size":
        kw["n"] = 12
    elif bad == "ref1":
        ref1 = torch.zeros((1, H, W + 8), dtype=torch.int32)
    elif bad == "pred_k":
        mv0 = mv1 = torch.zeros((32, 2, 2), dtype=torch.int32)
        r0 = r1 = torch.zeros((32, 2), dtype=torch.int32)
        kw["want_pred"] = True
    elif bad == "maxv":
        kw["maxv"] = 1024
    elif bad == "no_output":
        kw["want_satd"] = False
    elif bad == "plane":
        ref = ref[0]
    elif bad == "r_shape":
        r0 = torch.zeros((32,), dtype=torch.int32)
    elif bad == "r_low":
        r0 = r0 - 2
    else:
        r1 = r1 + 1
    with pytest.raises((TypeError, ValueError)):
        me.me_eval(ref, ref1, blocks, mv0, mv1, r0, r1, **kw)


def test_me_refine_rejects_more_candidates_than_keys_hold():
    """The kernel's argmin keys hold c * 49 + o in 16 bits: the wrapper
    takes 1337 candidates per block and refuses 1338, on every device."""
    ref = torch.zeros((8, 8), dtype=torch.int32)
    blocks = torch.zeros((1, 8, 8), dtype=torch.int32)
    lam = torch.tensor([0], dtype=torch.int32)
    mv, _, _ = me.me_refine(ref, blocks,
                            torch.zeros((1, 1337, 2), dtype=torch.int32),
                            lam, n=8, cols=1)
    # a flat plane ties everywhere: the first position of both scans
    assert mv.tolist() == [[-3 * 4 - 3, -3 * 4 - 3]]
    with pytest.raises(ValueError, match="1337"):
        me.me_refine(ref, blocks,
                     torch.zeros((1, 1338, 2), dtype=torch.int32),
                     lam, n=8, cols=1)


def _first_min_by_key(costs):
    """Torch mirror of the kernels' argmin: the smallest 64-bit key
    (cost << 16) | order over the last dimension, order being the
    position in scan order; returns the position."""
    order = torch.arange(costs.shape[-1], dtype=torch.int64)
    key = (costs.to(torch.int64) << 16) | order
    return (key.min(dim=-1).values & 0xFFFF).to(torch.int64)


def _strict_scan(costs):
    """Position of the first minimum, by the strict-< scan."""
    out = []
    for row in costs.tolist():
        best, pos = 1 << 62, 0
        for i, c in enumerate(row):
            if c < best:
                best, pos = c, i
        out.append(pos)
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("spread", [3, 1 << 20])
def test_packed_key_argmin_is_strict_scan(spread):
    """The packed-key minimum picks the first minimum in scan order, on
    costs with many exact ties (spread 3) and on wide random costs, over
    49 sub-pel offsets and over K x 49 (candidate, dy, dx) orders."""
    rng = np.random.RandomState(spread)
    for width in (49, 2 * 49, 5 * 49):
        costs = torch.from_numpy(rng.randint(0, spread, (500, width)))
        assert torch.equal(_first_min_by_key(costs), _strict_scan(costs))


def _int_costs(ref, blocks, cands, lam, n, cols):
    """me_refine_plain's integer scan costs [L, K * 49], in (candidate,
    dy, dx) order."""
    L, K = cands.shape[:2]
    y0, x0 = me._block_origins(L, n, cols, ref.device)
    costs = []
    for k in range(K):
        mvk = cands[:, k].clamp(-me.MV_CLAMP, me.MV_CLAMP)
        win = me.clamped_window(ref, y0 + mvk[:, 1] - 3,
                                x0 + mvk[:, 0] - 3, n + 6, n + 6)
        for o, prior in enumerate(me.prior_int_table()):
            dy, dx = divmod(o, 7)
            sad = (win[:, dy:dy + n, dx:dx + n] - blocks).abs().sum(
                dim=(1, 2), dtype=torch.int32)
            costs.append(sad + ((lam * prior) >> 8))
    return torch.stack(costs, 1)


def _qpel_costs(ref, blocks, lam, n, cols, mv_int):
    """me_refine_plain's quarter-pel scan costs [L, 49] around the
    full-pel MVs mv_int, in (qy, qx) order."""
    y0, x0 = me._block_origins(blocks.shape[0], n, cols, ref.device)
    costs = []
    for o, prior in enumerate(me.prior_qpel_table()):
        qy, qx = o // 7 - 3, o % 7 - 3
        mvq = torch.stack([mv_int[:, 0] * 4 + qx, mv_int[:, 1] * 4 + qy], 1)
        pred = me.mc_luma_plain(ref, mvq, y0, x0, n)
        costs.append(me.satd_tiles(blocks - pred) + ((lam * prior) >> 8))
    return torch.stack(costs, 1)


@pytest.mark.parametrize("n", [8, 32])
def test_tie_inputs_meet_exact_ties(n):
    """chip_smoke's tie-heavy inputs (flat and striped planes, candidates
    coinciding in pairs) give blocks whose integer and quarter-pel scans
    both hold more than one offset at the minimum, and me_refine_plain
    then takes the first minimum in scan order in both."""
    from chip_smoke import tie_inputs, tie_planes
    gen = torch.Generator().manual_seed(n)
    for name, plane, lam64 in tie_planes(H, W):
        ref, blocks, cands, _, cols = tie_inputs(plane, n, 5, gen, "cpu")
        lam = torch.tensor([lam64], dtype=torch.int32)
        mv, _, _ = me.me_refine_plain(ref, blocks, cands, lam, n, cols)
        c_int = _int_costs(ref, blocks, cands, lam, n, cols)
        first = _first_min_by_key(c_int)
        c, o = first // 49, first % 49
        cand = cands[torch.arange(len(c)), c].clamp(-me.MV_CLAMP,
                                                    me.MV_CLAMP)
        mv_int = cand + torch.stack([o % 7 - 3, o // 7 - 3], 1)
        c_q = _qpel_costs(ref, blocks, lam, n, cols, mv_int)
        for costs in (c_int, c_q):
            ties = (costs == costs.min(dim=1, keepdim=True).values).sum(1)
            assert int((ties > 1).sum()) >= blocks.shape[0] // 2, name
        first_q = _first_min_by_key(c_q)
        want = mv_int * 4 + torch.stack([first_q % 7 - 3,
                                         first_q // 7 - 3], 1)
        assert torch.equal(mv.to(torch.int64), want), name
