"""Tests of the PyTorch port that need an NVIDIA GPU (marked `cuda`; they
skip where there is none). They use chip_smoke.py's helpers, which the
smoke runs at 1080p. This file imports no JAX, so it also runs on a GPU
machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (EXTRAS_416, GOP8, GOP_OBA,  # noqa: E402
                        GRID, GRID_BATCH, GRID_GOP8, INTRA_LEAVES, LCU_OBA,
                        LOWDELAY, MD_BATCH, MD_BATCH_TOOLS, OPEN_GOP, P_SMP,
                        SMOKE_ROI, TOOL_LDB, TOOL_ROW, TRSKIP_FCT, VAQ_ROI,
                        VARIANTS_416, WPP_RC,
                        compare_devices, kernel_errors, kernel_inputs,
                        leaf_frames, main10_frames, mixed_frames,
                        screen_frames, smoke_key, split_motion_frames,
                        tie_inputs, tie_planes)
from kvazaar_tpu_torch.ops import me  # noqa: E402

H, W = 64, 128


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_kernels_match_plain(n):
    """Both kernels bit-exact with their plain versions, candidates and
    MVs reaching far outside the picture (index clamping), on random
    content and on the tie-heavy planes (flat, stripes; candidates
    coinciding in pairs), where the strict-< scan order decides; me_eval
    with K = 1 and 4 pairs, every output flag, on a stack of one picture
    for both lists and on stacks of two with random (and, on the
    tie-heavy planes, coinciding) per-pair reference indices, and in its
    one-list mode with K = 1 and 5 on stacks of one, two and four
    pictures."""
    dev = _need_cuda()
    rng = np.random.RandomState(n)
    ref = torch.from_numpy(rng.randint(0, 256, (H, W)).astype(np.int32))
    src = (ref.roll((2, -5), (0, 1))
           + torch.from_numpy(rng.randint(-2, 3, (H, W)).astype(np.int32))
           ).clamp(0, 255).to(dev)
    ref = ref.to(dev)
    ref1 = torch.from_numpy(rng.randint(0, 256, (H, W)).astype(np.int32)) \
        .to(dev)
    gen = torch.Generator(device="cpu").manual_seed(n)
    blocks, cands, mvs, cols = kernel_inputs(ref, src, n, 5, gen)
    lam = torch.tensor([153], dtype=torch.int32, device=dev)
    before = (me.me_refine.launches, me.me_eval.launches)
    err = kernel_errors(me, ref, blocks, cands, mvs, lam, n, cols, ref1)
    # me_eval: 4 call patterns x 3 pairs of stacks, then 3 one-list call
    # patterns x 3 stacks
    assert (me.me_refine.launches, me.me_eval.launches) == \
        (before[0] + 1, before[1] + 12 + 9)
    assert err == {"me_refine": 0, "me_eval": 0}
    for name, plane, lam64 in tie_planes(H, W):
        t_ref, t_blocks, t_cands, t_mvs, _ = tie_inputs(plane, n, 5, gen,
                                                        dev)
        err = kernel_errors(me, t_ref, t_blocks, t_cands, t_mvs,
                            torch.tensor([lam64], dtype=torch.int32,
                                         device=dev), n, cols,
                            t_ref.roll(1, 1).contiguous())
        assert err == {"me_refine": 0, "me_eval": 0}, name
    for name in me.KERNELS:
        assert me.kernel_occupancy(name, n)["blocks_per_sm"] >= 1, name
    assert me.kernel_occupancy("me_eval", n, lists=1)["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_cuda_stream_equals_cpu_stream():
    """The slice on the GPU gives the CPU path's stream and maps (IDR +
    2 B with fresh content, so the B frames mix intra and inter leaves),
    with 8 me_refine and 12 me_eval launches a B frame."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    before = (me.me_refine.launches, me.me_eval.launches)
    stream, rows = compare_devices(mixed_frames(3, W, H), W, H)
    # per B frame on the card: me_refine per list and size, me_eval three
    # launches a size (EVAL_CALLS)
    assert (me.me_refine.launches - before[0],
            me.me_eval.launches - before[1]) == (2 * 8, 2 * 12)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    assert all(r["waves"][0] > 0 for r in rows[1:])
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
def test_cuda_tool_row_equals_cpu():
    """The tool row (SAO full, RDOQ and sign hiding at QP 27) gives the
    CPU path's stream and maps on the GPU, SAO parameters included, with
    the same kernel launches a B frame as the default configuration."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    before = (me.me_refine.launches, me.me_eval.launches)
    stream, rows = compare_devices(mixed_frames(3, W, H), W, H, **TOOL_LDB)
    assert (me.me_refine.launches - before[0],
            me.me_eval.launches - before[1]) == (2 * 8, 2 * 12)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
def test_cuda_lowdelay_equals_cpu():
    """Bench scenario 2's GOP (lp-g4d3t1, two references a list) gives
    the CPU path's stream and maps on the GPU over IDR + 5 B, with 16
    me_refine launches (4 sizes x 2 lists x 2 pictures) and 12 me_eval
    launches a B frame."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    before = (me.me_refine.launches, me.me_eval.launches)
    stream, rows = compare_devices(mixed_frames(6, W, H), W, H, **LOWDELAY)
    assert (me.me_refine.launches - before[0],
            me.me_eval.launches - before[1]) == (5 * 16, 5 * 12)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 6 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
def test_cuda_p_smp_equals_cpu():
    """The P program with SMP, AMP and two reference pictures gives the
    CPU path's stream and maps (part8 included) on the GPU over IDR + 2 P
    of split-motion content, with 8 me_refine launches (4 sizes x 2
    pictures) and 8 one-list me_eval launches a P frame."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    before = (me.me_refine.launches, me.me_eval.launches,
              me.me_eval.one_list_launches)
    frames = split_motion_frames(3, W, H, edges=(40,), patch=True)
    stream, rows = compare_devices(frames, W, H, **P_SMP)
    assert (me.me_refine.launches - before[0],
            me.me_eval.launches - before[1],
            me.me_eval.one_list_launches - before[2]) == (2 * 8, 2 * 8,
                                                          2 * 8)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(TOOL_ROW, **GOP8), OPEN_GOP],
                         ids=["gop8_tools", "open_gop"])
def test_cuda_gop_equals_cpu(opts):
    """The B pyramid gives the CPU path's stream and maps on the GPU over
    12 frames fed in display order (bench scenario 3 with the tool row:
    IDR, P 8, B 4 2 1 3 6 5 7, P 10, B 9, P 11; the open GOP: IDR, CRA 8
    with seven RASL pictures, P 10, B 9, P 11), with 8 me_refine and 12
    me_eval launches a B frame, 4 me_refine and 8 one-list me_eval
    launches a P anchor."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    before = (me.me_refine.launches, me.me_eval.launches,
              me.me_eval.one_list_launches)
    stream, rows = compare_devices(mixed_frames(12, W, H), W, H, **opts)
    n_p = 3 if not opts.get("open_gop") else 2
    n_b = 8
    assert (me.me_refine.launches - before[0],
            me.me_eval.launches - before[1],
            me.me_eval.one_list_launches - before[2]) == (
                8 * n_b + 4 * n_p, 12 * n_b + 8 * n_p, 8 * n_p)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 12 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["ultrafast", "medium"])
def test_cuda_presets_equal_cpu(preset):
    """--preset ultrafast (intra depths 2-3, inter 1-2, --subme 0, one
    reference) and medium (NxN, GOP 16, --ref 4, SAO and RDOQ) give the
    CPU path's stream and maps on the GPU over 5 frames fed in display
    order (IDR, P 4, B 2 1 3), with 8 me_refine launches a picture of a B
    frame's stacks, 4 a picture of the P anchor's, 12 me_eval launches a
    B frame and 8 one-list launches in the P anchor."""
    _need_cuda()
    from kvazaar_tpu_torch.cfg import PRESETS
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    before = (me.me_refine.launches, me.me_eval.launches,
              me.me_eval.one_list_launches)
    cfg = PRESETS[preset]
    stream, rows = compare_devices(mixed_frames(5, W, H), W, H, **cfg)
    refs = cfg["ref_frames"]
    assert (me.me_refine.launches - before[0],
            me.me_eval.launches - before[1],
            me.me_eval.one_list_launches - before[2]) == (
                3 * 8 * min(2, refs) + 4 * refs, 3 * 12 + 8, 8)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 5 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
def test_cuda_intra_leaves_equal_cpu():
    """Every intra depth (64x64 leaves to NxN 4x4, --pu-depth-intra 0-4)
    with --rd 3, SAO full, RDOQ and sign hiding at QP 27 on half
    detailed, half flat content (the CPU tests' golden "rd3") gives the
    CPU path's stream and maps on the GPU over 2 frames, with NxN cells
    and 64x64 leaves in each, and decodes hash-exactly."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    stream, rows = compare_devices(leaf_frames(2, W, H), W, H,
                                   **INTRA_LEAVES)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    assert all(r["sizes"].get(4, 0) and r["sizes"].get(64, 0)
               for r in rows), [r["sizes"] for r in rows]
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wpp_rc", "lcu_oba", "vaq_roi",
                                  "gop_oba"])
def test_cuda_wpp_rc_delta_qp_equal_cpu(name, tmp_path):
    """WPP with lambda rate control (IDR + 3 B), all-intra OBA rate
    control with WPP (a QP a CTB), VAQ with a ROI map and the tool row,
    and the B pyramid with WPP slices and OBA (6 frames) give the CPU
    path's streams, maps and CTB QPs on the GPU at 192x128 (3x2 CTBs),
    and decode hash-exactly."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    roi = tmp_path / "roi.txt"
    roi.write_text(SMOKE_ROI)
    cfg, n = {"wpp_rc": (dict(WPP_RC, target_bitrate=600_000), 4),
              "lcu_oba": (dict(LCU_OBA, target_bitrate=600_000), 2),
              "vaq_roi": (dict(VAQ_ROI, roi_file=str(roi)), 2),
              "gop_oba": (dict(GOP_OBA, target_bitrate=600_000), 6)}[name]
    stream, rows = compare_devices(mixed_frames(n, 192, 128), 192, 128,
                                   **cfg)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == n and all(p.hash_ok for p in pics)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [v[0] for v in VARIANTS_416]
                         + ["trskip_fct"])
def test_cuda_intra_variants_equal_cpu(name):
    """Transform skip (IDR + 2 B), Main 10 with the tool row, a --cqmfile
    and lossless coding (chip_smoke.py's VARIANTS_416), and transform
    skip with NxN leaves and the --fast-coeff-table of phase 12 (i) on
    screen content, give the CPU path's streams and maps on the GPU at
    128x64 and decode hash-exactly; the lossless reconstruction is the
    source."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    if name == "trskip_fct":
        cfg, frames = TRSKIP_FCT, screen_frames(3, W, H)
    else:
        _, cfg, kind, n = {v[0]: v for v in VARIANTS_416}[name]
        frames = (main10_frames(n, W, H) if kind == "main10"
                  else mixed_frames(n, W, H))
    stream, rows = compare_devices(frames, W, H, **cfg)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(frames) and all(p.hash_ok for p in pics)
    if name == "lossless":
        for p, f in zip(pics, frames):
            for a, b in zip(p.planes, f):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [e[0] for e in EXTRAS_416])
def test_cuda_crypto_field_tiles_equal_cpu(name):
    """The three intra features of --crypto (128x64), bottom field first
    (128x128 frames, two fields each) and 2x2 tiles with --vaq 8 (256x128;
    chip_smoke.py's EXTRAS_416) give the CPU path's streams and maps on
    the GPU, and decode hash-exactly (the encrypted stream with its
    key)."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    _, cfg, n = {e[0]: e for e in EXTRAS_416}[name]
    w, h = (256, 128) if "tiles" in cfg else (
        (128, 128) if "source_scan_type" in cfg else (W, H))
    stream, rows = compare_devices(mixed_frames(n, w, h), w, h, **cfg)
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    kw = (dict(crypto=cfg["crypto"], crypto_key=smoke_key())
          if "crypto" in cfg else {})
    pics = HEVCDecoder(**kw).decode(stream)
    assert len(pics) == len(rows) and all(p.hash_ok for p in pics)


@pytest.mark.cuda
def test_cuda_mesh_over_one_card_twice():
    """The multi-device dryrun over cuda:0 twice (or two cards): a 2x1
    grid through MeshTiledIntraPipeline, hash-exact and byte-identical to
    TiledIntraPipeline's stream on the card and to the CPU's."""
    _need_cuda()
    from kvazaar_tpu_torch.parallel import dryrun
    r = dryrun.run(2, "cuda")
    assert r["mesh"] == (1, 2) and len(r["devices"]) == 2
    assert r["stream"] == dryrun.run(2, "cpu")["stream"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p", "gop8", "batch"])
def test_cuda_grid_equals_cpu(name):
    """The 16x16-grid pipelines (--ctu 16) at 120x72 (padded to 128x80):
    IDR + 3 P, the GOP 8 pyramid with the tool row (9 frames) and
    frame_batch 2 (2 frames) give the CPU path's streams and maps on the
    GPU, decode hash-exactly, and launch neither kernel."""
    _need_cuda()
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    from tools.torch_goldens import grid_frames
    cfg, n = {"p": (GRID, 4), "gop8": (GRID_GOP8, 9),
              "batch": (GRID_BATCH, 2)}[name]
    before = (me.me_refine.launches, me.me_eval.launches)
    stream, rows = compare_devices(grid_frames(n, 120, 72), 120, 72, **cfg)
    assert (me.me_refine.launches, me.me_eval.launches) == before
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == n and all(p.hash_ok for p in pics)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "tools"])
def test_cuda_md_batch_equals_cpu(name):
    """The batched CTB-64 intra program (frame_batch 2 over 3 frames at
    128x64: a full batch and a partial one), -p 1 with the default tools
    and the tool row with --pu-depth-intra 1-4, gives the CPU path's
    stream and maps on the GPU and the unbatched stream, decodes
    hash-exactly and launches neither kernel."""
    _need_cuda()
    from kvazaar_tpu_torch.api import encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    cfg = {"default": MD_BATCH, "tools": MD_BATCH_TOOLS}[name]
    frames = mixed_frames(3, W, H)
    before = (me.me_refine.launches, me.me_eval.launches)
    stream, rows = compare_devices(frames, W, H, **cfg)
    assert (me.me_refine.launches, me.me_eval.launches) == before
    assert all(r["same_stream"] and not r["differing_maps"] for r in rows)
    single, _ = encode_sequence(Config(width=W, height=H,
                                       **dict(cfg, frame_batch=0)), frames,
                                device="cuda")
    assert stream == single
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)
