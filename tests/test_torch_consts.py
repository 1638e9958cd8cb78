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


def _variant_kw(name: str, scaling_mod):
    """Pipeline options of a variant, with `scaling_mod`'s ScalingLists
    (each package its own)."""
    import os
    fct = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_fct_table.json")
    return {"trskip": dict(trskip=True),
            "scaling": dict(scaling=scaling_mod.ScalingLists()),
            "cqm": dict(scaling=scaling_mod.load_cqmfile(fct.replace(
                "torch_fct_table.json", "torch_cqm.txt"))),
            "fct": dict(fast_coeff_table=fct),
            "main10": dict(bit_depth=10)}[name]


@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("name", ["trskip", "scaling", "cqm", "fct",
                                  "main10"])
def test_variant_consts_match_jax(name, qp):
    """The transform-skip flag prices `tsp`, the scaling lists' quantiser
    and dequantiser tables (`qt<n>`, `dm<n>`, chroma `qt<n>c`, `dm<n>c`)
    and a --fast-coeff-table's weights `fcw` equal the JAX pipeline's."""
    import kvazaar_tpu.hevc.scaling as jscaling
    import kvazaar_tpu_torch.hevc.scaling as pscaling
    jp = JaxIntra(64, 128, qp, **_variant_kw(name, jscaling))
    pp = MdIntraPipeline(64, 128, qp, device="cpu",
                         **_variant_kw(name, pscaling))
    conv = consts_from_numpy(jp.consts, "cpu")
    # the port keeps Cr's scaling lists apart (qt<n>r, dm<n>r); the JAX
    # package quantises Cr with Cb's
    own = {f"{t}{n}r" for t in ("qt", "dm") for n in (4, 8, 16)}
    assert set(pp.consts) - own <= set(conv)
    want = {"trskip": {"tsp"}, "fct": {"fcw"}, "main10": set(),
            "scaling": {f"{t}{n}{c}" for t in ("qt", "dm")
                        for n in (4, 8, 16, 32) for c in ("", "c")
                        if not (c and n == 32)}}
    assert want.get(name, want["scaling"]) <= set(pp.consts)
    for k, v in pp.consts.items():
        # Cr's lists equal Cb's in the default lists and the test file
        ref = conv[k[:-1] + "c" if k in own else k]
        assert ref.dtype == v.dtype, k
        assert torch.equal(ref, v), k


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
