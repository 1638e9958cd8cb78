"""Tiles of the port on the CPU (--tiles, --slices tiles; the tiled and
multi-device tile pipelines and their dryrun; tools/torch_goldens.py
EXTRA_CONFIGS "tiles*", tests/data/torch_golden_extras.npz; live JAX
twins are marked `slow`).

- kvazaar_tpu_torch.api codes every frame intra, tile by tile
  (parallel/tiled.py's TiledIntraPipeline), byte-identical to the JAX
  package with equal maps: a 2x2 grid at 256x128 plain, with SAO full,
  with RDOQ and sign hiding, with --slices tiles (a slice segment a
  tile), with --vaq 8 (a QP a CTB, the chain reset at each tile) and
  with --crypto on; a 2x1 grid over 200x136 (padded to 256x192). Each
  stream decodes hash-exactly in both packages' decoders.
- --tiles 2x2 --pu-depth-intra 1-4: the JAX package's stitch drops the
  4x4 PU modes (mode_map4), so its intra writer signals the 8x8 mode for
  every NxN sub-PU and its stream misses the hash; the port stitches
  mode_map4 (ROADMAP.md queue 3). The two streams differ only there: the
  port's stream decodes hash-exactly, and the port with mode_map4 dropped
  from its decisions writes the golden's stream.
- mesh_shape_for and grid_is_uniform equal the JAX package's on a table
  of grids and device counts; MeshTiledIntraPipeline over [cpu] * 2,
  [cpu] * 4 and [cpu, cpu:0] (two host threads) codes the
  TiledIntraPipeline's stream; Encoder takes the mesh
  path as the reference does; `python -m kvazaar_tpu_torch.parallel.dryrun
  2 --device cpu` prints MULTICHIP OK.
- Tiles disable WPP (with the reference's message), TMVP is off in the
  SPS, and the CLI's --tiles forces CTB 64.

Tolerances: 0 (maps, planes, streams).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from test_torch_crypto import (check_extra, decoder_of,  # noqa: E402
                               golden, key_bytes, port_extra_run)
from tools.torch_goldens import (EXTRA_CONFIGS, extra_frames,  # noqa: E402
                                 jax_extra_stream)
from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402

# the CLI and dryrun subprocesses: one intra-op thread, as the fixtures
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")
from kvazaar_tpu_torch.hevc.tiles import TileGrid  # noqa: E402
from kvazaar_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshTiledIntraPipeline, grid_is_uniform, mesh_shape_for)
from kvazaar_tpu_torch.parallel.tiled import TiledIntraPipeline  # noqa

TILE_CASES = ("tiles", "tiles_sao", "tiles_rdoq", "tiles21", "tiles_slices",
              "tiles_vaq", "tiles_crypto")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", TILE_CASES)
def test_tiles_stream_byte_identical_to_reference(name):
    check_extra(name)


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", TILE_CASES + ("tiles_nxn",))
def test_tiles_stream_decodes_hash_exact(name, decoder):
    stream, _, infos, _ = port_extra_run(name)
    kw = {}
    if "crypto" in EXTRA_CONFIGS[name][0]:
        kw = dict(crypto="on", crypto_key=key_bytes())
    pics = decoder_of(decoder, **kw).decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)


def test_tiles_substreams_slices_and_pipelines():
    """A substream a tile through the Python writers, in one slice with
    entry points, or (--slices tiles) a slice segment a tile; every frame
    intra; TiledIntraPipeline on the CPU; per-tile wave counts; the
    per-CTB QPs of --vaq not all equal."""
    for name in TILE_CASES:
        _, decs, infos, enc = port_extra_run(name)
        n_tiles = enc.tile_grid.n_tiles
        segs = n_tiles if name == "tiles_slices" else 1
        assert [(i["substreams"], i["slices"]) for i in infos] == \
            [(n_tiles, segs)] * len(infos), name
        assert {i["slice_type"] for i in infos} == {2}
        assert enc.native_slices == 0
        assert isinstance(enc._pipeline, TiledIntraPipeline)
        assert all(len(i["tile_waves"]) == n_tiles for i in infos)
        assert not enc.sps.temporal_mvp_enabled
        assert enc.pps.loop_filter_across_tiles == 0
    q = port_extra_run("tiles_vaq")[1][0]["qp_ctb"]
    assert q.min() < q.max()
    assert port_extra_run("tiles21")[3].tile_grid.col_widths == [2, 2]


def test_tiles_nxn_differs_from_reference_only_in_nxn_sub_modes():
    """The JAX tile stitch drops mode_map4: its stream misses the hash.
    The port's maps equal the golden's and its stream decodes
    hash-exactly (test_tiles_stream_decodes_hash_exact), with NxN cells
    whose sub-PU modes differ from their 8x8 mode; with mode_map4 dropped
    from its decisions, as the JAX stitch drops it, the port writes the
    golden's stream byte for byte, so the 4x4 PU modes are the only
    difference."""
    g = golden()
    pics = decoder_of("kvazaar_tpu").decode(g["tiles_nxn_stream"].tobytes())
    assert not all(p.hash_ok for p in pics)
    check_extra("tiles_nxn", skip=("mode_map4",))
    stream, decs, _, _ = port_extra_run("tiles_nxn")
    d = decs[0]
    nxn = np.repeat(np.repeat(d["size_map8"] == 4, 2, 0), 2, 1)
    m8 = np.repeat(np.repeat(d["mode_map8"], 2, 0), 2, 1)
    assert (d["mode_map4"] != m8)[nxn].any()
    assert stream != g["tiles_nxn_stream"].tobytes()
    enc = Encoder(Config(width=256, height=128,
                         **EXTRA_CONFIGS["tiles_nxn"][0]), device="cpu")
    stitched = enc._pipeline.materialize

    def without_mode_map4(outs):
        res = stitched(outs)
        del res["mode_map4"]
        return res
    enc._pipeline.materialize = without_mode_map4
    dropped, _ = encode_sequence(enc.cfg, extra_frames("tiles_nxn"),
                                 encoder=enc)
    assert dropped == g["tiles_nxn_stream"].tobytes()


GRIDS = [(w, h, c, r) for (w, h) in ((2, 1), (4, 2), (4, 4), (5, 3), (8, 6),
                                     (20, 12), (3, 3))
         for (c, r) in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 4), (3, 1),
                        (4, 2)) if c <= w and r <= h]


@pytest.mark.parametrize("w,h,c,r", GRIDS)
def test_mesh_shape_for_matches_reference(w, h, c, r):
    from kvazaar_tpu.hevc.tiles import TileGrid as RefGrid
    from kvazaar_tpu.parallel import mesh as ref
    g, rg = TileGrid.make(w, h, c, r), RefGrid.make(w, h, c, r)
    assert grid_is_uniform(g) == ref.grid_is_uniform(rg)
    for n in (1, 2, 3, 4, 6, 8, 16):
        assert mesh_shape_for(g, n) == ref.mesh_shape_for(rg, n), n


def _tile_frames():
    from chip_smoke import mixed_frames
    return mixed_frames(2, 256, 128)


@pytest.mark.parametrize("n_dev,tiles", [(2, (2, 2)), (4, (4, 2))],
                         ids=["2", "4"])
def test_mesh_equals_tiled_on_cpu(n_dev, tiles):
    """MeshTiledIntraPipeline over [cpu] * n_dev (one thread a distinct
    device: here one) codes the tiled path's stream, SAO and RDOQ on."""
    cfg = dict(width=256, height=128, tiles=tiles, sao_type="full",
               rdoq_enable=True, qp=30)
    devs = [torch.device("cpu")] * n_dev
    enc = Encoder(Config(**cfg), device="cpu", tile_devices=devs)
    assert isinstance(enc._pipeline, MeshTiledIntraPipeline)
    mr, mc = enc._pipeline.mr, enc._pipeline.mc
    assert mr * mc == n_dev
    s_mesh, _ = encode_sequence(enc.cfg, _tile_frames(), encoder=enc)
    s_tiled, _ = encode_sequence(Config(**cfg), _tile_frames(),
                                 device="cpu")
    assert s_mesh == s_tiled
    pics = decoder_of("kvazaar_tpu_torch").decode(s_mesh)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)


def test_mesh_threads_over_distinct_devices():
    """Distinct devices run their blocks in host threads of their own:
    over cpu and cpu:0 (distinct torch devices of one CPU) the mesh holds
    two pipelines and a two-thread pool, gives each device its block of
    tile columns, and codes the tiled path's stream."""
    cfg = dict(width=256, height=128, tiles=(4, 2), qp=30)
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    enc = Encoder(Config(**cfg), device="cpu", tile_devices=devs)
    pipe = enc._pipeline
    assert isinstance(pipe, MeshTiledIntraPipeline)
    assert (pipe.mr, pipe.mc) == (1, 2)
    assert len(pipe.pipes) == 2
    assert pipe.work == {devs[0]: [0, 1, 4, 5], devs[1]: [2, 3, 6, 7]}
    s_mesh, _ = encode_sequence(enc.cfg, _tile_frames(), encoder=enc)
    assert s_mesh == encode_sequence(Config(**cfg), _tile_frames(),
                                     device="cpu")[0]


def test_encoder_routes_tiles_as_reference():
    """Uniform grids of more than one tile without delta QP take the mesh
    over the given devices; --vaq, a non-uniform grid, mesh_tiles off or
    one device take the tiled path."""
    devs = [torch.device("cpu")] * 4
    base = dict(width=256, height=128, tiles=(2, 2))

    def kind(devices=devs, **kw):
        return type(Encoder(Config(**dict(base, **kw)), device="cpu",
                            tile_devices=devices)._pipeline).__name__
    assert kind() == "MeshTiledIntraPipeline"
    assert kind(vaq=8) == "TiledIntraPipeline"
    assert kind(mesh_tiles="off") == "TiledIntraPipeline"
    assert kind(devices=devs[:1]) == "TiledIntraPipeline"
    assert kind(tiles=(3, 1)) == "TiledIntraPipeline"    # widths 1, 1, 2
    assert type(Encoder(Config(**base), device="cpu")._pipeline) is \
        TiledIntraPipeline


def test_dryrun_two_devices_on_cpu():
    r = subprocess.run([sys.executable, "-m",
                        "kvazaar_tpu_torch.parallel.dryrun", "2",
                        "--device", "cpu"], cwd=ROOT, env=ONE_THREAD,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "MULTICHIP OK: 2 devices (cpu, cpu), mesh 1x2" in r.stdout


def test_tiles_disable_wpp(capfd):
    cfg = Config(width=256, height=128, tiles=(2, 2), wpp=True)
    enc = Encoder(cfg, device="cpu")
    assert "Disabling WPP because tiles were enabled." in \
        capfd.readouterr().err
    assert cfg.wpp is False
    assert enc.pps.entropy_coding_sync_enabled == 0
    stream, _ = encode_sequence(cfg, extra_frames("tiles")[:1], encoder=enc)
    assert stream == encode_sequence(
        Config(width=256, height=128, tiles=(2, 2)),
        extra_frames("tiles")[:1], device="cpu")[0]


def test_tiles_with_wpp_slices_code_a_segment_a_tile():
    """--tiles 2x2 --wpp --slices wpp: tiles disable WPP, and the port
    addresses each slice segment at its tile's first CTB, so the stream is
    --slices tiles' and decodes hash-exactly; the JAX package addresses
    them as CTB rows (ROADMAP.md queue 3,
    test_tiles_with_wpp_slices_reference_fails)."""
    frames = extra_frames("tiles_slices")
    stream, infos = encode_sequence(
        Config(width=256, height=128, tiles=(2, 2), wpp=True, slices="wpp"),
        frames, device="cpu")
    assert [i["slices"] for i in infos] == [4]
    assert stream == golden()["tiles_slices_stream"].tobytes()


@pytest.mark.slow
def test_tiles_with_wpp_slices_reference_fails():
    from kvazaar_tpu.api import encode_sequence as ref_encode_sequence
    from kvazaar_tpu.cfg import Config as RefConfig
    with pytest.raises(AssertionError):
        ref_encode_sequence(RefConfig(width=256, height=128, tiles=(2, 2),
                                      wpp=True, slices="wpp"),
                            extra_frames("tiles_slices"))


def test_cli_tiles_force_ctb64(tmp_path):
    """--tiles 2x2 with --ctu 16 codes at CTB 64 (the CUDA default
    device replaced by the CPU): the golden's "tiles" stream."""
    frames = extra_frames("tiles")
    yuv, out = tmp_path / "in.yuv", tmp_path / "o.hevc"
    yuv.write_bytes(b"".join(a.tobytes() for f in frames for a in f))
    r = subprocess.run(
        [sys.executable, "-m", "kvazaar_tpu_torch", "-i", str(yuv),
         "--input-res", "256x128", "-o", str(out), "--tiles", "2x2",
         "--ctu", "16", "--device", "cpu"], cwd=ROOT, env=ONE_THREAD,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == golden()["tiles_stream"].tobytes()


@pytest.mark.slow
def test_tiles21_live_against_jax():
    stream, decs = jax_extra_stream("tiles21")
    got, gdecs, _, _ = port_extra_run("tiles21")
    assert got == stream
    for k in decs[0]:
        np.testing.assert_array_equal(gdecs[0][k], decs[0][k], err_msg=k)
