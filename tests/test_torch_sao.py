"""The port's SAO (kvazaar_tpu_torch/ops/sao_torch.py) against the JAX
package's kvazaar_tpu/ops/sao_jax.py, jitted with a traced lambda as in
the frame programs: on seeded planes (random, flat and period-2 striped
reconstructions) at 128x64 with CTB 64 (luma) and 64x32 with 32 (chroma),
with `sao` full, band and edge, the parameters and the filtered planes
are equal at tolerance 0. The port's filter also equals the NumPy oracle
ops/sao.py::apply_sao_plane on the parameters it chose."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kvazaar_tpu.ops import sao_jax  # noqa: E402
from kvazaar_tpu_torch.ops import sao_torch  # noqa: E402
from kvazaar_tpu_torch.ops.sao import apply_sao_plane  # noqa: E402

LUMA = (64, 128, 64)      # plane height, width, CTB size in its samples
CHROMA = (32, 64, 32)
MODES = {"full": (True, True), "band": (True, False), "edge": (False, True)}
CONTENT = ("random", "flat", "stripes")
_JIT: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane_pair(kind: str, h: int, w: int, seed: int):
    """(source, reconstruction) int32 planes. flat: a constant
    reconstruction (every edge category 0); stripes: period-2 vertical
    stripes (every sample a horizontal extremum, vertical neighbours
    equal), both tie-heavy for the class and band-position argmaxes."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        src = rng.randint(0, 256, (h, w))
        rec = src + rng.randint(-8, 9, (h, w))
    elif kind == "flat":
        rec = np.full((h, w), 117)
        src = rec + rng.randint(-3, 4, (h, w))
    else:
        rec = 60 + 120 * (np.arange(w)[None, :] & 1).repeat(h, 0)
        src = rec + rng.randint(-5, 6, (h, w))
    return (np.clip(src, 0, 255).astype(np.int32),
            np.clip(rec, 0, 255).astype(np.int32))


def _lam(qp: int) -> np.float32:
    return np.float32(0.57 * 2.0 ** ((qp - 12) / 3.0))


def _jax_luma(mode: str):
    key = ("luma", mode)
    if key not in _JIT:
        ab, ae = MODES[mode]
        _JIT[key] = jax.jit(lambda s, r, lam: sao_jax.sao_luma(
            s, r, LUMA[2], lam, ab, ae))
    return _JIT[key]


def _jax_chroma(mode: str):
    key = ("chroma", mode)
    if key not in _JIT:
        ab, ae = MODES[mode]
        _JIT[key] = jax.jit(lambda sb, sr, rb, rr, lam: sao_jax.sao_chroma(
            sb, sr, rb, rr, CHROMA[2], lam, ab, ae))
    return _JIT[key]


def _equal(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _oracle(rec, typ, offs, pos, cls, n):
    params = {(cy, cx): (int(typ[cy, cx]), [int(o) for o in offs[:, cy, cx]],
                         int(pos[cy, cx] if typ[cy, cx] == 1
                             else cls[cy, cx]))
              for cy in range(typ.shape[0]) for cx in range(typ.shape[1])}
    return apply_sao_plane(rec, params, n)


@pytest.mark.parametrize("qp", [27, 37])
@pytest.mark.parametrize("kind", CONTENT)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sao_luma_matches_jax(mode, kind, qp):
    h, w, n = LUMA
    src, rec = _plane_pair(kind, h, w, qp)
    lam = _lam(qp)
    want_out, want = _jax_luma(mode)(src, rec, lam)
    out, got = sao_torch.sao_luma(torch.from_numpy(src),
                                  torch.from_numpy(rec), n,
                                  torch.tensor(lam), *MODES[mode])
    _equal(got, want)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    p = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(
        out.numpy(), _oracle(rec, p["typ"], p["offs"], p["pos"], p["cls"],
                             n))


@pytest.mark.parametrize("qp", [27, 37])
@pytest.mark.parametrize("kind", CONTENT)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sao_chroma_matches_jax(mode, kind, qp):
    h, w, n = CHROMA
    src_b, rec_b = _plane_pair(kind, h, w, qp + 1)
    src_r, rec_r = _plane_pair(kind, h, w, qp + 2)
    lam = _lam(qp)
    want_b, want_r, want = _jax_chroma(mode)(src_b, src_r, rec_b, rec_r,
                                             lam)
    out_b, out_r, got = sao_torch.sao_chroma(
        *(torch.from_numpy(p) for p in (src_b, src_r, rec_b, rec_r)), n,
        torch.tensor(lam), *MODES[mode])
    _equal(got, want)
    np.testing.assert_array_equal(out_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(out_r.numpy(), np.asarray(want_r))
    p = {k: v.numpy() for k, v in got.items()}
    for out, rec, c in ((out_b, rec_b, "cb"), (out_r, rec_r, "cr")):
        np.testing.assert_array_equal(
            out.numpy(), _oracle(rec, p["typ"], p[f"offs_{c}"],
                                 p[f"pos_{c}"], p["cls"], n))
