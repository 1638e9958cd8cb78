"""Per-QP constants: the JAX pipeline's consts, converted with
consts_from_numpy, equal the port's own (same names, values and dtypes),
and a port pipeline run on them gives the same leaf RD results."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from kvazaar_tpu.models.inter_md import MdInterPipeline as JaxInter  # noqa
from kvazaar_tpu.models.intra_md import MdIntraPipeline as JaxIntra  # noqa
from kvazaar_tpu_torch.models.inter_md import MdInterPipeline  # noqa: E402
from kvazaar_tpu_torch.models.intra_md import (  # noqa: E402
    MdIntraPipeline, consts_from_numpy)

CASES = [(JaxIntra, MdIntraPipeline, {}, 22),
         (JaxIntra, MdIntraPipeline, {}, 37),
         (JaxInter, MdInterPipeline, {"b_slices": True}, 22),
         (JaxInter, MdInterPipeline, {"b_slices": True}, 32)]


def _pair(jcls, pcls, kw, qp):
    jp = jcls(64, 128, qp, deblock=True, **kw)
    pp = pcls(64, 128, qp, deblock=True, device="cpu")
    return jp, pp


@pytest.mark.parametrize("jcls,pcls,kw,qp", CASES)
def test_consts_match_jax(jcls, pcls, kw, qp):
    jp, pp = _pair(jcls, pcls, kw, qp)
    conv = consts_from_numpy(jp.consts, "cpu")
    assert set(pp.consts) <= set(conv)
    # the 4x4 luma matrices of NxN PUs are among them
    assert {"g4l", "f4", "dst4"} <= set(pp.consts)
    for k, v in pp.consts.items():
        assert conv[k].dtype == v.dtype, k
        assert torch.equal(conv[k], v), k


def test_consts_change_with_qp():
    pp = MdInterPipeline(64, 128, 22, device="cpu")
    a, b = pp._consts_for(22), pp._consts_for(37)
    assert a is pp._consts_for(22)
    for k in ("qp2", "lam2", "dpc"):
        assert not torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("n", [8, 16, 32])
def test_pipeline_runs_on_jax_consts(n):
    jp, pp = _pair(JaxInter, MdInterPipeline, {"b_slices": True}, 27)
    rng = np.random.RandomState(n)
    src = [torch.from_numpy(rng.randint(0, 256, s).astype(np.int32))
           for s in ((64, 128), (32, 64), (32, 64))]
    own = pp._leaf_rd(*src, n)
    pp.set_consts(consts_from_numpy(jp.consts, "cpu"))
    assert (pp.qp_y, pp.qp_c) == (27, 27)
    fed = pp._leaf_rd(*src, n)
    for a, b in zip(own, fed):
        assert torch.equal(a, b)
