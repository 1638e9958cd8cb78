"""The batched CTB-64 intra program of the port on the CPU
(MdIntraPipeline.submit_many: frame_batch and the mesh's device blocks;
tools/torch_goldens.py BATCH_CONFIGS, tests/data/torch_golden_batch.npz;
the live JAX twin is marked `slow`).

- encode_sequence with frame_batch 2 over 3 frames at 128x64 (a full
  batch, then a partial one) codes the frame_batch 0 stream, byte for
  byte, with every map of every frame equal (n_waves included), for each
  all-intra option set of BATCH_OPTIONS; each stream decodes hash-exactly
  in the port's decoder; a batch runs one search and one wavefront.
  The default, NxN and 64-to-NxN sets run again on 64x128 pictures (two
  CTB rows), where a CTB row inside a picture has upper neighbours.
- submit_many equals submit picture by picture, with per-picture hash
  masks, under delta QP without a QP map and on 64x128 tiles; it
  refuses pictures of another shape, and a stalled picture in a batch
  raises.
- The port's batched stream of "md_batch" equals the JAX package's own
  frame_batch stream (its vmapped program), maps included.
- MeshTiledIntraPipeline makes one batched call a device block and codes
  TiledIntraPipeline's stream.

Tolerances: 0 (maps, planes, streams).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import main10_frames, mixed_frames, smoke_key  # noqa: E402
from tools.torch_goldens import (BATCH_CONFIGS, BATCH_KEYS,  # noqa: E402
                                 OUT_BATCH, batch_frames, jax_batch_stream)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder  # noqa: E402
from kvazaar_tpu_torch.models.intra_md import MdIntraPipeline  # noqa: E402
from kvazaar_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshTiledIntraPipeline)
from kvazaar_tpu_torch.parallel.tiled import tile_masks  # noqa: E402

W, H = 128, 64
SMOKE_KEY = ",".join(str(17 * i + 3) for i in range(16))
# the CTB-64 all-intra option sets: (Config options, content)
BATCH_OPTIONS = {
    "default": ({}, "mixed"),
    "tool_row": (dict(deblock_enable=True, sao_type="full", rdoq_enable=True,
                      signhide_enable=True), "mixed"),
    "nxn": (dict(pu_depth_intra=(1, 4)), "mixed"),
    "pu64": (dict(pu_depth_intra=(0, 4)), "mixed"),
    "trskip": (dict(trskip_enable=True, pu_depth_intra=(1, 4)), "mixed"),
    "main10_scaling": (dict(input_bitdepth=10, scaling_list="default",
                            qp=30), "main10"),
    "lossless": (dict(lossless=True), "mixed"),
    "crypto": (dict(crypto="on", crypto_key=SMOKE_KEY), "mixed"),
    "wpp": (dict(wpp=True), "mixed"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def content(kind: str, n: int, w: int, h: int) -> list:
    """n frames of w x h: main10_frames, or mixed_frames (for 64x128, which
    it cannot fill, turned a quarter left and last frame first: the left
    CTB of its third frame, where a 64x64 leaf wins, becomes the first
    frame's lower CTB row)."""
    if kind == "main10":
        return main10_frames(n, w, h)
    if w >= 128:
        return mixed_frames(n, w, h)
    return [tuple(np.ascontiguousarray(np.rot90(a)) for a in f)
            for f in mixed_frames(n, h, w)[::-1]]


def _maps(enc) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in enc._last_decisions.items()}


def port_run(cfg: Config, frames, spy=()):
    """(stream, per coded frame maps, infos, calls) of the port on the CPU
    through encode_sequence; calls: per method name in spy, the number of
    pictures of each call (ys' length for submit_many, the stacked
    height over the pipeline's for the others)."""
    enc = Encoder(cfg, device="cpu")
    pipe = enc._pipeline
    h0 = pipe.h
    calls: dict = {}
    for name in spy:
        def wrap(fn, name=name):
            def run(*a, **kw):
                n = len(a[0]) if name == "submit_many" else pipe.h // h0
                calls.setdefault(name, []).append(n)
                return fn(*a, **kw)
            return run
        setattr(pipe, name, wrap(getattr(pipe, name)))
    decs = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        decs.append(_maps(enc))
        return out
    enc.finalize_frame = record
    stream, infos = encode_sequence(cfg, frames, encoder=enc)
    return stream, decs, infos, calls


def _assert_maps_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), f"frame {i}"
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"frame {i} {k}")


def _check_frame_batch(name: str, w: int, h: int) -> None:
    """frame_batch 2 over 3 frames of w x h: frames 0-1 through one search
    and one wavefront, frame 2 alone; the stream, every map and the waves
    equal frame-by-frame coding, and the stream decodes hash-exactly."""
    opts, kind = BATCH_OPTIONS[name]
    frames = content(kind, 3, w, h)
    base = dict(width=w, height=h, intra_period=1, **opts)
    spy = ("submit_many", "_partition", "_recon_md")
    batched, b_maps, b_infos, calls = port_run(
        Config(frame_batch=2, **base), frames, spy)
    single, s_maps, s_infos, s_calls = port_run(Config(**base), frames, spy)
    assert calls == {"submit_many": [2, 1], "_partition": [2, 1],
                     "_recon_md": [2, 1]}
    assert s_calls == {"_partition": [1, 1, 1], "_recon_md": [1, 1, 1]}
    assert batched == single
    _assert_maps_equal(b_maps, s_maps)
    assert [i["n_waves"] for i in b_infos] == \
        [i["n_waves"] for i in s_infos]
    assert all(i["n_waves"] > 0 for i in b_infos)
    kw = ({"crypto": "on", "crypto_key": smoke_key()} if "crypto" in opts
          else {})
    pics = HEVCDecoder(**kw).decode(batched)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)


@pytest.mark.parametrize("name", sorted(BATCH_OPTIONS))
def test_frame_batch_equals_unbatched(name):
    """Pictures one CTB row tall, stacked: each CTB row is a picture's
    top row."""
    _check_frame_batch(name, W, H)


@pytest.mark.parametrize("name", ["default", "nxn", "pu64"])
def test_frame_batch_two_ctb_rows(name):
    """Pictures of two CTB rows (64x128, the pixels of 128x64): a CTB row
    inside a picture sees its upper neighbours, the picture's first row
    none, and a picture's last row is no neighbour of the next."""
    _check_frame_batch(name, H, W)


PIPE_OPTIONS = {
    "masks": dict(deblock=True, sao="full"),
    "delta_qp": dict(delta_qp=True, wpp=True, rdoq=True),
    "nxn": dict(pu_depth=(1, 4)),
    "pu64": dict(pu_depth=(0, 4)),
}


def _check_submit_many(name: str, w: int, h: int) -> None:
    """submit_many over three pictures of w x h gives, picture by picture,
    what submit gives, each picture with its own hash masks (a tile's at
    its offset)."""
    from kvazaar_tpu_torch.hevc.tiles import TileGrid
    pipe = MdIntraPipeline(h, w, 27, device="cpu", **PIPE_OPTIONS[name])
    frames = content("mixed", 3, w, h)
    grid = TileGrid.make(3 * w // 64, h // 64, 3, 1)
    masks = [tile_masks(grid, t, 64, "cpu") for t in range(3)]
    one = [pipe.materialize(pipe.submit(*f, masks=m))
           for f, m in zip(frames, masks)]
    many = [pipe.materialize(o)
            for o in pipe.submit_many(*zip(*frames), masks=masks)]
    for a, b in zip(one, many):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    assert len({int(o["hash"][0]) for o in many}) == 3


@pytest.mark.parametrize("name", ["masks", "delta_qp"])
def test_submit_many_equals_submit(name):
    """With per-picture hash masks, and on a delta-QP pipeline at the
    frame QP."""
    _check_submit_many(name, W, H)


@pytest.mark.parametrize("name", ["masks", "nxn", "pu64"])
def test_submit_many_equals_submit_two_ctb_rows(name):
    """Pictures (tiles) of two CTB rows, 64x128."""
    _check_submit_many(name, H, W)


def test_submit_many_refuses_other_shapes():
    pipe = MdIntraPipeline(H, W, 27, device="cpu")
    y, cb, cr = mixed_frames(1, W, 2 * H)[0]
    with pytest.raises(ValueError, match="shape"):
        pipe.submit_many([y], [cb], [cr])
    y, cb, cr = mixed_frames(1, W, H)[0]
    with pytest.raises(ValueError, match="masks"):
        pipe.submit_many([y, y], [cb, cb], [cr, cr], masks=[{}])


def test_stalled_picture_in_batch_raises():
    """A picture of a batch whose TUs never become ready stalls the
    wavefront, which raises (the other picture being done)."""
    pipe = MdIntraPipeline(H, W, 27, device="cpu")
    ready = pipe._class_ready

    def never_in_picture_1(written, st, s):
        r = ready(written, st, s).clone()
        r[r.shape[0] // 2:] = False
        return r
    pipe._class_ready = never_in_picture_1
    frames = mixed_frames(2, W, H)
    with pytest.raises(RuntimeError, match="picture 1"):
        pipe.submit_many(*zip(*frames))


def test_md_batch_matches_jax_golden():
    """The port's frame_batch stream of "md_batch" (two full batches) is
    the JAX package's frame_batch stream, every map equal; the JAX
    package's unbatched stream of the same frames is the same."""
    g = np.load(OUT_BATCH)
    name = "md_batch"
    kw, w, h, n = BATCH_CONFIGS[name]
    stream, decs, infos, calls = port_run(
        Config(width=w, height=h, **kw), batch_frames(name),
        ("submit_many",))
    assert calls == {"submit_many": [2, 2]}
    assert stream == g[f"{name}_stream"].tobytes()
    assert stream == g[f"{name}_single_stream"].tobytes()
    assert len(decs) == n
    for i, d in enumerate(decs):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(d[k], g[f"{name}_f{i}_{k}"],
                                          err_msg=f"frame {i} {k}")


@pytest.mark.slow
def test_md_batch_live_against_jax():
    name = "md_batch"
    kw, w, h, _ = BATCH_CONFIGS[name]
    stream, decs, _, _ = port_run(Config(width=w, height=h, **kw),
                                  batch_frames(name))
    want, want_decs = jax_batch_stream(name)
    assert stream == want
    for d, e in zip(decs, want_decs):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(d[k], e[k], err_msg=k)


def test_mesh_one_batched_call_a_block():
    """Over [cpu, cpu] the mesh (1x2 over a 4x2 grid of 64x64 tiles) codes
    each device block of 2x2 tiles in one submit_many call, never tile by
    tile, and its stream equals TiledIntraPipeline's."""
    cfg = dict(width=256, height=128, tiles=(4, 2), qp=30, sao_type="full",
               rdoq_enable=True)
    devs = [torch.device("cpu")] * 2
    enc = Encoder(Config(**cfg), device="cpu", tile_devices=devs)
    mesh = enc._pipeline
    assert isinstance(mesh, MeshTiledIntraPipeline)
    (pipe,) = mesh.pipes.values()
    calls = []
    many, submit = pipe.submit_many, pipe.submit
    pipe.submit_many = lambda ys, *a, **k: (calls.append(len(ys)),
                                            many(ys, *a, **k))[1]
    pipe.submit = lambda *a, **k: (calls.append("submit"),
                                   submit(*a, **k))[1]
    frames = mixed_frames(2, 256, 128)
    s_mesh, infos = encode_sequence(enc.cfg, frames, encoder=enc)
    assert calls == [4, 4, 4, 4]
    assert mesh.work[devs[0]] == [0, 1, 4, 5, 2, 3, 6, 7]
    s_tiled, t_infos = encode_sequence(Config(**cfg), frames, device="cpu")
    assert s_mesh == s_tiled
    assert [i["n_waves"] for i in infos] == [i["n_waves"] for i in t_infos]
    pics = HEVCDecoder().decode(s_mesh)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)
