"""The PyTorch port's B-slice stages against the JAX package on one
128x64 B frame (tools/torch_goldens.py stage_inputs): coarse motion field
bit-exact (live), and against the goldens the tool writes from the JAX
package: the inter leaf at n=16, the partition maps, the batched inter
recon and the wavefront recon over it. Integer outputs exact, float costs
rtol 1e-5, maps equal. A `slow` twin recomputes the goldens live."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.torch_goldens import (H, OUT as GOLDEN, W, jax_stages,  # noqa
                                 stage_inputs)
from kvazaar_tpu_torch.models.inter_md import MdInterPipeline  # noqa: E402

INT_KEYS = ("mv0", "r0", "mv1", "r1", "dir", "pred_y", "pred_cb",
            "pred_cr")


def _port():
    pipe = MdInterPipeline(H, W, 22, deblock=True, device="cpu")
    inp = stage_inputs()
    src = tuple(torch.from_numpy(p.astype(np.int32)) for p in inp["src"])
    ref = tuple(torch.from_numpy(p.astype(np.int32))[None]
                for p in inp["ref"])
    return pipe, src, ref


def _port_stages(pipe, src, ref) -> dict:
    out = {}
    me0 = pipe._me_sizes(src[0], ref[0],
                         [pipe._coarse_field(src[0], ref[0][0])])
    for k, v in zip(("mv0", "r0", "mv1", "r1", "dir", "cost", "pred_y",
                     "pred_cb", "pred_cr"),
                    pipe._inter_leaf_b(*src, ref, ref, 16, me0[16],
                                       me0[16])):
        out["leafb_" + k] = v
    (size8, mode8, inter8, dir8, mv8, ref8, mv8b, ref8b,
     preds) = pipe._partition_inter_b(*src, ref, ref)
    out.update(part_size_map8=size8, part_mode_map8=mode8,
               part_inter8=inter8, part_dir8=dir8, part_mv8=mv8,
               part_mv8b=mv8b)
    init = pipe._inter_recon_batch(*src, size8, inter8, preds)
    out.update(batch_luma=init[0], batch_chroma=init[1],
               batch_written=init[2])
    luma, chroma, written, _ = pipe._recon_md(
        *src, size8, mode8, init_state=init, exclude8=init[2])
    out.update(recon_luma=luma, recon_chroma=chroma, recon_written=written)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port_stages():
    return _port_stages(*_port())


def _compare(got: dict, want: dict, prefix: str) -> None:
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys
    for k in keys:
        if k.endswith("cost"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_coarse_field_bit_exact():
    from kvazaar_tpu.models.inter_md import MdInterPipeline as JaxInter
    jpipe = JaxInter(H, W, 22, n_refs=1, b_slices=True)
    inp = stage_inputs()
    want = jax.jit(jpipe._coarse_field)(jnp.asarray(inp["src"][0],
                                                    jnp.int32),
                                        jnp.asarray(inp["ref"][0],
                                                    jnp.int32))
    pipe, src, ref = _port()
    got = pipe._coarse_field(src[0], ref[0][0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stage", ["leafb_", "part_", "batch_", "recon_"])
def test_stage_matches_golden(port_stages, stage):
    _compare(port_stages, dict(np.load(GOLDEN)), stage)


def test_golden_frame_mixes_intra_and_inter(port_stages):
    inter8 = port_stages["part_inter8"]
    assert inter8.any() and not inter8.all()
    assert len(np.unique(port_stages["part_size_map8"])) > 1


@pytest.mark.slow
def test_stages_match_jax_live(port_stages):
    want = jax_stages()
    for stage in ("leafb_", "part_", "batch_", "recon_"):
        _compare(port_stages, want, stage)
