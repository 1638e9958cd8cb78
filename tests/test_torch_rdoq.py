"""The port's quantisation tools against the JAX package's methods, each
jitted alone on a small JAX pipeline (consts traced as in the frame
programs, no frame program compiled):

- RDOQ (`_rdoq_levels`) for log2n 2-5, luma and chroma, the I and the
  P/B context prices (INIT_TYPE 0 and 1) and QP 22, 27, 37: levels equal,
  the last-position costs `tot` (read at the argmin of each side) within
  rtol 1e-5;
- the sign-hiding parity fix (`_sdh_fix`) with the diagonal scan and with
  per-TU mode-dependent scans: levels equal;
- the pieces whose float32 rounding the port reproduces: the RDOQ lambda
  for every QP, the Golomb price's floor(log2) at every power of two, and
  the summation orders of the reference's compiled sums and prefix sums.
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kvazaar_tpu.models.inter_md import MdInterPipeline as JaxInter  # noqa
from kvazaar_tpu.models.intra_md import MdIntraPipeline as JaxIntra  # noqa
from kvazaar_tpu.tables import QUANT_SCALES  # noqa: E402
from kvazaar_tpu_torch.models import intra_md as port_md  # noqa: E402
from kvazaar_tpu_torch.models.inter_md import MdInterPipeline  # noqa: E402
from kvazaar_tpu_torch.models.intra_md import MdIntraPipeline  # noqa: E402

PIPES = {0: (JaxIntra, MdIntraPipeline, {}),
         1: (JaxInter, MdInterPipeline, {"b_slices": True})}
SIZES = [(2, True), (2, False), (3, True), (3, False), (4, True),
         (4, False), (5, True)]
_PIPE_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipes(init_type: int, qp: int):
    key = (init_type, qp)
    if key not in _PIPE_CACHE:
        jcls, pcls, kw = PIPES[init_type]
        _PIPE_CACHE[key] = (
            jcls(64, 128, qp, rdoq=True, sign_hiding=True, **kw),
            pcls(64, 128, qp, rdoq=True, sign_hiding=True, device="cpu"))
    return _PIPE_CACHE[key]


def _quant_params(qp: int, log2n: int):
    return int(QUANT_SCALES[qp % 6]), 14 + qp // 6 + 7 - log2n


def _coeffs(L: int, n: int, qp: int, seed: int) -> np.ndarray:
    """Laplacian transform coefficients decaying with frequency, scaled
    with the QP so every level range is exercised."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    sc = 2000.0 / (1 + xx + yy) ** 1.3 * 2 ** ((qp - 22) / 6)
    return np.clip(np.round(rng.laplace(0, 1, (L, n, n)) * sc), -32768,
                   32767).astype(np.int32)


def _jax_rdoq(jp, co, qp: int, log2n: int, is_luma: bool):
    """(levels, tot) of the JAX method, jitted with the QP traced (scale
    and qbits derived inside, as _transform_quant does); tot is read at
    its argmin."""
    cap = {}
    argmin = jnp.argmin

    def spy(x, axis=None, **kw):
        if x.ndim == 2 and "tot" not in cap:
            cap["tot"] = x
        return argmin(x, axis=axis, **kw)

    def fn(co, qp):
        scale = jnp.asarray(QUANT_SCALES, jnp.int32)[qp % 6]
        qbits = 14 + qp // 6 + 7 - log2n
        offset = jnp.left_shift(171, qbits - 9)
        with mock.patch.object(jnp, "argmin", spy):
            lev = jp._rdoq_levels(co, scale, qbits, qp, log2n, offset,
                                  is_luma=is_luma)
        return lev, cap["tot"]

    lev, tot = jax.jit(jp._with_consts(fn))(jp.consts, co, jnp.int32(qp))
    return np.asarray(lev), np.asarray(tot)


def _port_rdoq(pp, co, qp: int, log2n: int, is_luma: bool):
    cap = {}
    argmin = torch.argmin

    def spy(x, dim=None, **kw):
        if x.dim() == 2 and "tot" not in cap:
            cap["tot"] = x
        return argmin(x, dim=dim, **kw)

    scale, qbits = _quant_params(qp, log2n)
    with mock.patch.object(torch, "argmin", spy):
        lev = pp._rdoq_levels(torch.from_numpy(co), scale, qbits, qp, log2n,
                              is_luma)
    return lev.numpy(), cap["tot"].numpy()


@pytest.mark.parametrize("log2n,is_luma", SIZES)
@pytest.mark.parametrize("qp", [22, 27, 37])
@pytest.mark.parametrize("init_type", [0, 1])
def test_rdoq_levels_match_jax(init_type, qp, log2n, is_luma):
    jp, pp = _pipes(init_type, qp)
    co = _coeffs(64, 1 << log2n, qp, seed=100 * qp + 10 * log2n + is_luma)
    lev_j, tot_j = _jax_rdoq(jp, co, qp, log2n, is_luma)
    lev_p, tot_p = _port_rdoq(pp, co, qp, log2n, is_luma)
    np.testing.assert_array_equal(lev_p, lev_j)
    np.testing.assert_allclose(tot_p, tot_j, rtol=1e-5)
    # RDOQ moved levels away from the plain deadzone rule
    scale, qbits = _quant_params(qp, log2n)
    plain = (np.abs(co).astype(np.int64) * scale + (171 << (qbits - 9))) \
        >> qbits
    assert (lev_j != 0).any() and (np.abs(lev_j) != plain).any()


@pytest.mark.parametrize("init_type", [0, 1])
def test_rdoq_consts_priced_at_the_slice_type(init_type):
    """The port's RDOQ prices are the JAX pipeline's (same names and
    values), priced at each pipeline's INIT_TYPE, and the I and P/B
    prices differ."""
    jp, pp = _pipes(init_type, 27)
    other = _pipes(1 - init_type, 27)[1]
    for k in ("sigp", "csbfp", "g1p", "g2p", "lastp5", "lastc4"):
        np.testing.assert_array_equal(pp.c[k].numpy(),
                                      np.asarray(jp.consts[k]), err_msg=k)
    assert not torch.equal(pp.c["sigp"], other.c["sigp"])


def test_rdoq_lambda_bit_exact():
    """1.5 * 0.57 * 2^((qp - 12) / 3) as the reference's compiled program
    forms it from a traced QP (intra_md.py _rdoq_levels), every QP."""
    qps = jnp.arange(52, dtype=jnp.int32)
    want = np.asarray(jax.jit(lambda q: jnp.asarray(
        1.5 * (0.57 * 2.0 ** ((q.astype(jnp.float32) - 12.0) / 3.0)),
        jnp.float32))(qps))
    got = np.asarray([port_md.rdoq_lambda(q) for q in range(52)],
                     np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_golomb_log2_at_powers_of_two():
    """floor(log2(rem)) of the Golomb price at rem = 2^k, k = 0..15:
    the reference's log2 is log(x) / log(2) in float32 and lands below k
    at some k (_LOG2_LOW); the port keeps the reference's value, and is
    exact between the powers."""
    rem = (2.0 ** np.arange(16)).astype(np.float32)
    rem = np.concatenate([rem, rem + 1, np.maximum(rem - 1, 1)])
    want = np.asarray(jax.jit(lambda r: jnp.floor(jnp.log2(
        jnp.maximum(r, 1.0))))(rem))
    _, pp = _pipes(0, 27)
    got = pp._golomb_log2(torch.from_numpy(rem)).numpy()
    np.testing.assert_array_equal(got, want)
    low = [k for k in range(16) if want[k] != k]
    assert low == list(port_md._LOG2_LOW)


@pytest.mark.parametrize("k", [0, 3, 12, 13, 14])
def test_golomb_price_in_rdoq_at_powers_of_two(k):
    """The price inside _rdoq_levels: a 32x32 TU at QP 0 whose DC level is
    3 + 2^k (rem = 2^k), other coefficients small; tot equals the JAX
    method's bit for bit and the levels are equal."""
    qp, log2n = 0, 5
    scale, qbits = _quant_params(qp, log2n)
    co = _coeffs(4, 32, 0, seed=k) // 64
    lf = 3 + (1 << k)
    co[:, 0, 0] = -(-(lf << qbits) // scale)          # rounds to lf
    jp, pp = _pipes(0, qp)
    lev_j, tot_j = _jax_rdoq(jp, co, qp, log2n, True)
    lev_p, tot_p = _port_rdoq(pp, co, qp, log2n, True)
    assert abs(int(lev_j[0, 0, 0])) in (lf - 1, lf)
    np.testing.assert_array_equal(lev_p, lev_j)
    np.testing.assert_array_equal(tot_p, tot_j)


@pytest.mark.parametrize("scans", ["diagonal", "per-tu"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_sdh_fix_matches_jax(n, scans):
    """The parity fix after plain quantisation: the JAX base method
    (diagonal scan) or its scan-aware override (_sdh_scan_sel set, as the
    wavefront sets it for 8x8 luma and 4x4 chroma TUs)."""
    qp = 27
    jp, pp = _pipes(0, qp)
    log2n = n.bit_length() - 1
    scale, qbits = _quant_params(qp, log2n)
    rng = np.random.RandomState(n)
    co = _coeffs(256, n, 37, seed=n) // 4
    lev = (np.sign(co) * ((np.abs(co).astype(np.int64) * scale
                           + (171 << (qbits - 9))) >> qbits)).astype(np.int32)
    err = (np.abs(co).astype(np.int64) * scale
           - (np.abs(lev).astype(np.int64) << qbits)).astype(np.int32)
    sel = None if scans == "diagonal" else \
        rng.randint(0, 3, len(co)).astype(np.int32)

    def fn(lev, err, sel):
        jp._sdh_scan_sel = sel
        try:
            return jp._sdh_fix(lev, n, err, jnp.int32(qbits))
        finally:
            jp._sdh_scan_sel = None

    want = np.asarray(jax.jit(jp._with_consts(fn))(jp.consts, lev, err, sel))
    got = pp._sdh_fix(torch.from_numpy(lev), n, torch.from_numpy(err), qbits,
                      None if sel is None else torch.from_numpy(sel))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != lev).any()


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_reference_summation_orders(n):
    """_xla_cumsum and _xla_sum add float32 terms in the order of the
    reference's compiled jnp.cumsum and row sum: bit-exact."""
    x = (np.random.RandomState(n).rand(40, n) * 1000).astype(np.float32)
    cs, s = jax.jit(lambda a: (jnp.cumsum(a, axis=1), a.sum(axis=1)))(x)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(port_md._xla_cumsum(xt).numpy(),
                                  np.asarray(cs))
    np.testing.assert_array_equal(port_md._xla_sum(xt).numpy(),
                                  np.asarray(s))
