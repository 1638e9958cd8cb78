"""Write the reference goldens the PyTorch port's tests compare against.

Runs the JAX package (kvazaar_tpu) on the CPU and stores, in
tests/data/torch_golden_slice.npz:

- the default-config stream of 3 synthetic frames (IDR + 2 B) at
  128x64 (slice_frames) and every frame's decision maps (`f{i}_<key>`);
- stage outputs of one B frame whose JAX programs are too costly to
  compile inside the tier-1 test budget: the recon of the intra
  wavefront (`recon_*`) and the inter leaf / partition / batch recon
  (`leafb_*`, `part_*`, `batch_*`), all on inputs made from fixed seeds;

in tests/data/torch_golden_tools.npz, per TOOL_CONFIGS entry, the
stream (`<name>_stream`) and every frame's maps, SAO parameters included
(`<name>_f{i}_<key>`), of slice_frames at 128x64 with SAO, RDOQ and
sign-data hiding;

and in tests/data/torch_golden_lowdelay.npz, bench.py's scenario 2 (the
low-delay GOP lp-g4d3t1 with two references a list):

- per LOWDELAY_CONFIGS entry the stream and every frame's maps of 6
  slice_frames at 128x64 (IDR + 5 B), as above;
- the frame plan (`plan_ref<R>`: per frame POC, QP, l0, l1, is_ref and
  the retained DPB, as JSON) of 9 slice_frames with --ref 1, 2, 4;
- the B inter leaf at n = 16 and 64 with two-picture reference stacks
  (`ldleaf<n>_*`) on cross_inputs, where the cross-reference
  bi-prediction candidate wins;

and in tests/data/torch_golden_p.npz, the P program (--no-bipred):

- per P_CONFIGS entry the stream and every frame's maps (`part8`
  included where SMP is on), as above;
- on cross_inputs with a two-picture stack, the merge alignment
  (`pmerge<n>_*`) and the P inter leaf (`pleaf<n>_*`) at n = 16 and 64;
- on split_inputs, the SMP/AMP leaf (`psmp<n>_*`) at n = 16 and 32;

and in tests/data/torch_golden_gop.npz, the B pyramid (bench.py's
scenario 3, --gop 2/4/8/16, closed and open GOP), fed display order
through push_frame/flush:

- per GOP_CONFIGS entry the stream, every coded frame's maps (coding
  order) and its plan entry (`<name>_plan`, JSON) on gop_frames at
  128x64;
- the frame plans of GOP_PLANS (`plan_<name>`: per coded frame the
  display index, POC, slice and NAL type, QP, l0, l1, the retention set
  and the retained DPB), through stand-in pipelines (no device work);
- the B inter leaf at n = 16 and 64 with distinct two-picture stacks a
  list, bi-prediction on and off (`gleaf<b><n>_*`), on gop_leaf_inputs;

and in tests/data/torch_golden_presets.npz, the preset ladder:

- per PRESET_CONFIGS entry the stream and every coded frame's maps
  (`mode_map4` included): all-intra NxN and 64x64 leaves and the --rd
  ladder on intra_frames at 128x64, and --preset ultrafast, medium and
  placebo on gop_frames through encode_sequence;
- the intra stages on intra_frames("halfflat") (`satd4_*`, `leaf4_*`,
  `leaf64_*`, `leafrd<rd>_<n>_*`, `part<lo><hi>_*`, `nxnrec_*`), the
  inter split DP under the depth gates of DP_GATES (`dp_<name>`) and
  the SMP search's sub-pel refinement at --subme 0, 2 and 4
  (`subpel<s>_*`);

and in tests/data/torch_golden_rc.npz, WPP, rate control and delta QP
at 192x128 (3x2 CTBs):

- per RC_CONFIGS entry the stream, every coded frame's maps (`qp_ctb`
  included under delta QP) and its plan entry (the frame QP), through
  encode_sequence on mixed content;
- `capi_stream` / `capi_qps`: RC_CAPI through the JAX package's
  capi.py with owf = 2;
- the intra stages under the non-uniform QP map STAGE_QPMAP
  (`dq_leaf*`, `dq_part_*`, `dq_rec_*`) and the final-QP chain with
  and without WPP on level planes of DQ_LEVEL_SEED (`dq_fq*`);

and in tests/data/torch_golden_variants.npz, the remaining intra
variants (transform skip, --fast-coeff-table, Main 10, scaling lists,
lossless) at 128x64:

- per VARIANT_CONFIGS entry the stream and every coded frame's maps
  (`ts8` included with transform skip), through encode_sequence; the
  --fast-coeff-table and --cqmfile inputs are the committed
  tests/data/torch_fct_table.json and tests/data/torch_cqm.txt
  (write_fct_table, write_cqm_file);
- the stages (`tq10_*`, `sdq*`, `tqs*`, `tqrd*`, `leaf10_*`,
  `part10_*`): _transform_quant at 10-bit, the scaled dequant up to its
  int32 fold, _transform_quant_skip, the transform-skip RD competition
  _tq_4x4_rd, and the 10-bit leaf costs and partition.

and in tests/data/torch_golden_grid.npz, the 16x16-grid pipelines
(--ctu 16): per GRID_CONFIGS entry the stream and every coded frame's
maps (GRID_KEYS) on grid_frames through encode_sequence;

and in tests/data/torch_golden_batch.npz, the batched CTB-64 intra
program: per BATCH_CONFIGS entry the stream and every coded frame's maps
(BATCH_KEYS) through encode_sequence with Config.frame_batch, which runs
the JAX pipeline's vmapped program (MdIntraPipeline.submit_many), and
the stream of the same frames with frame_batch 0 (`<name>_single_stream`).

Usage:  JAX_PLATFORMS=cpu python tools/torch_goldens.py
[slice|tools|lowdelay|p|gop|presets|rc|variants|extras|grid|batch] (every
file when no argument is given); `variants <part> ...` re-runs those parts
and merges them into the file.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import SMOKE_KEY  # noqa: E402

W, H, N_FRAMES = 128, 64, 3
OUT = os.path.join(ROOT, "tests", "data", "torch_golden_slice.npz")
OUT_TOOLS = os.path.join(ROOT, "tests", "data", "torch_golden_tools.npz")
OUT_LOWDELAY = os.path.join(ROOT, "tests", "data",
                            "torch_golden_lowdelay.npz")
OUT_P = os.path.join(ROOT, "tests", "data", "torch_golden_p.npz")
OUT_GOP = os.path.join(ROOT, "tests", "data", "torch_golden_gop.npz")
OUT_PRESETS = os.path.join(ROOT, "tests", "data",
                           "torch_golden_presets.npz")
OUT_RC = os.path.join(ROOT, "tests", "data", "torch_golden_rc.npz")
OUT_VARIANTS = os.path.join(ROOT, "tests", "data",
                            "torch_golden_variants.npz")
OUT_EXTRAS = os.path.join(ROOT, "tests", "data", "torch_golden_extras.npz")
OUT_GRID = os.path.join(ROOT, "tests", "data", "torch_golden_grid.npz")
OUT_BATCH = os.path.join(ROOT, "tests", "data", "torch_golden_batch.npz")
FCT_TABLE = os.path.join(ROOT, "tests", "data", "torch_fct_table.json")
CQM_FILE = os.path.join(ROOT, "tests", "data", "torch_cqm.txt")
SAO_KEYS = ("sao_y_typ", "sao_y_cls", "sao_y_offs", "sao_y_pos",
            "sao_c_typ", "sao_c_cls", "sao_c_offs_cb", "sao_c_pos_cb",
            "sao_c_offs_cr", "sao_c_pos_cr")
MAP_KEYS = ("size_map8", "mode_map8", "inter8", "dir8", "mv8", "ref8",
            "mv8b", "ref8b", "levels_y", "levels_cb", "levels_cr", "hash",
            "rec_y", "rec_cb", "rec_cr", "part8") + SAO_KEYS
# the tool-row goldens at QP 27: (configuration, frames). "intra" is
# bench.py's scenario 1 tool row (deblocking, SAO full, RDOQ, no sign
# hiding) all-intra; "ldb" adds sign hiding on IDR + 2 generalized-B.
TOOL_CONFIGS = {
    "intra": (dict(qp=27, intra_period=1, sao_type="full",
                   rdoq_enable=True), 2),
    "ldb": (dict(qp=27, sao_type="full", rdoq_enable=True,
                 signhide_enable=True), 3),
}

# bench.py's scenario 2 (bench.py:232-233): the low-delay GOP lp-g4d3t1
# with two references a list, at the default tools ("lp") and with the
# tool row of scenario 1 at QP 27 ("lp_tools"; bench.py:41-42, 123)
LOWDELAY = dict(intra_period=0, gop_len=4, gop_lowdelay=True,
                gop_lp=(3, 1), ref_frames=2)
LOWDELAY_CONFIGS = {
    "lp": (LOWDELAY, 6),
    "lp_tools": (dict(LOWDELAY, qp=27, deblock_enable=True,
                      sao_type="full", rdoq_enable=True,
                      signhide_enable=False), 6),
}
# the P program (--no-bipred): (configuration, frames, count). "p" is
# the default configuration with bi-prediction off; "smp" the run of
# tests/test_smp.py (split-motion content at 192x128, QP 30) with SMP and
# AMP; "lp_p" scenario 2's GOP with the tool row, its frames P slices
P_CONFIGS = {
    "p": (dict(bipred=False), "slice", 3),
    "smp": (dict(bipred=False, qp=30, intra_period=0, smp_enable=True,
                 amp_enable=True), "split", 3),
    "lp_p": (dict(LOWDELAY_CONFIGS["lp_tools"][0], bipred=False),
             "slice", 6),
}
SMP_W, SMP_H = 192, 128
# the B pyramid: (configuration, frames). "g8" is bench.py's scenario 3
# (bench.py:252, -p 24 --gop 8) with the tool row of scenario 1 at QP 27
# (bench.py:41-42, 123); "open" --gop 8 -p 8 --open-gop (a CRA with
# seven RASL pictures); "ref2" --gop 4 -p 0 --ref 2 (two pictures a
# list, different in l0 and l1); "nobi" --gop 4 -p 0 --no-bipred
GOP_CONFIGS = {
    "g8": (dict(qp=27, intra_period=24, gop_len=8, deblock_enable=True,
                sao_type="full", rdoq_enable=True,
                signhide_enable=False), 12),
    "open": (dict(gop_len=8, intra_period=8, open_gop=True), 12),
    "ref2": (dict(gop_len=4, intra_period=0, ref_frames=2), 9),
    "nobi": (dict(gop_len=4, intra_period=0, bipred=False), 5),
}
# frame plans through stand-in pipelines, --ref 4: (configuration,
# frames). Closed GOPs at intra period 2g cross a period boundary, open
# ones at period g code CRA pictures; "p8g8" is the period-boundary order
# of the reference (ROADMAP.md queue 3).
GOP_PLANS = {
    **{f"g{g}": (dict(gop_len=g, intra_period=2 * g, ref_frames=4),
                 2 * g + 3) for g in (2, 4, 8, 16)},
    **{f"g{g}_open": (dict(gop_len=g, intra_period=g, open_gop=True,
                           ref_frames=4), 2 * g + 3) for g in (2, 4, 8, 16)},
    "p8g8": (dict(gop_len=8, intra_period=8), 9),
}
PLAN_REFS = (1, 2, 4)
PLAN_FRAMES = 9
LEAF_QP = 22


def slice_frames(n: int = N_FRAMES) -> list:
    """chip_smoke.py's mixed_frames at 128x64: bench.py's synthetic
    formula plus fresh content per frame, so B frames mix intra and inter
    leaves of several sizes."""
    from chip_smoke import mixed_frames
    return mixed_frames(n, W, H)


def gop_frames(n: int, w: int = W, h: int = H) -> list:
    """The moving content of tests/test_gop_md.py (`_frames`): a ramp
    that pans 2 px a frame plus fresh noise in 0..11, with chroma
    changing a little a frame."""
    rng = np.random.default_rng(5)
    base = (np.arange(w * h).reshape(h, w) % 256).astype(np.uint8)
    out = []
    for i in range(n):
        y = np.roll(base, i * 2, axis=1)
        y = (y.astype(np.int32)
             + rng.integers(0, 12, (h, w))).clip(0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 100 + i, np.uint8)
        cr = ((np.arange(h // 2 * w // 2).reshape(h // 2, w // 2) + 3 * i)
              % 256).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def stage_inputs() -> dict:
    """Inputs of the stage goldens: slice frame 1 as the source and
    slice frame 0 as the reference of both lists (as low-delay B)."""
    frames = slice_frames(2)
    return {"src": frames[1], "ref": frames[0]}


def jax_stream(frames, keys=MAP_KEYS, **cfg) -> tuple[bytes, list[dict]]:
    """Encode frames with kvazaar_tpu (Config options cfg); returns
    (stream, decisions: the maps of `keys`)."""
    from kvazaar_tpu.api import Encoder
    from kvazaar_tpu.cfg import Config
    enc = Encoder(Config(width=frames[0][0].shape[1],
                         height=frames[0][0].shape[0], **cfg))
    out, decs = b"", []
    for f in frames:
        chunk, _ = enc.encode_frame(*f)
        out += chunk
        decs.append({k: np.asarray(v) for k, v in
                     enc._last_decisions.items() if k in keys})
    return out, decs


def jax_stages() -> dict:
    """Stage outputs of the JAX B program on stage_inputs()."""
    import jax
    import jax.numpy as jnp
    from kvazaar_tpu.models.inter_md import MdInterPipeline
    inp = stage_inputs()
    pipe = MdInterPipeline(H, W, 22, n_refs=1, b_slices=True,
                           deblock=True)
    src = tuple(jnp.asarray(p, jnp.int32) for p in inp["src"])
    ref = tuple(jnp.asarray(p, jnp.int32)[None] for p in inp["ref"])
    lam = pipe.lam2[0]

    def part(s_y, s_cb, s_cr, l0, l1):
        return pipe._partition_inter_b(s_y, s_cb, s_cr, l0, l1, lam)

    (size8, mode8, inter8, dir8, mv8, ref8, mv8b, ref8b,
     preds) = jax.jit(pipe._with_consts(part))(pipe.consts, *src, ref, ref)
    out = {"part_size_map8": size8, "part_mode_map8": mode8,
           "part_inter8": inter8, "part_dir8": dir8, "part_mv8": mv8,
           "part_mv8b": mv8b}

    def leaf16(s_y, s_cb, s_cr, l0, l1):
        f0 = [pipe._coarse_field(s_y, l0[0][0])]
        me0 = pipe._me_kernel_sizes(s_y, l0[0], f0, None)
        return pipe._inter_leaf_b(s_y, s_cb, s_cr, l0, l1, f0, f0, 16,
                                  pipe.t16, pipe.t8, lam, me0=me0[16],
                                  me1=me0[16])

    res = jax.jit(pipe._with_consts(leaf16))(pipe.consts, *src, ref, ref)
    for k, v in zip(("mv0", "r0", "mv1", "r1", "dir", "cost", "pred_y",
                     "pred_cb", "pred_cr"), res):
        out["leafb_" + k] = v

    def batch(s_y, s_cb, s_cr, l0, l1, sm, im, d8, m8, r8, m8b, r8b, pr):
        return pipe._inter_recon_batch(s_y, s_cb, s_cr, l0[0], l0[1], l0[2],
                                       sm, im, m8, r8, l1=l1, dir8=d8,
                                       mv8b=m8b, ref8b=r8b, preds=pr)

    luma, chroma, written = jax.jit(pipe._with_consts(batch))(
        pipe.consts, *src, ref, ref, size8, inter8, dir8, mv8, ref8, mv8b,
        ref8b, preds)
    out.update(batch_luma=luma, batch_chroma=chroma, batch_written=written)

    def recon(s_y, s_cb, s_cr, sm, mm, init):
        return pipe._recon_md(s_y, s_cb, s_cr, sm, mm, init_state=init,
                              exclude8=init[2])[:3]

    rl, rc, rw = jax.jit(pipe._with_consts(recon))(
        pipe.consts, *src, size8, mode8, (luma, chroma, written))
    out.update(recon_luma=rl, recon_chroma=rc, recon_written=rw)
    return {k: np.asarray(v) for k, v in out.items()}


def jax_plan(ref_frames: int) -> list[dict]:
    """The JAX package's frame plan of PLAN_FRAMES slice_frames of
    scenario 2's GOP with --ref ref_frames: per frame the POC, QP, l0,
    l1, is_ref and the POCs the DPB keeps after it."""
    from kvazaar_tpu.api import Encoder
    from kvazaar_tpu.cfg import Config
    enc = Encoder(Config(width=W, height=H,
                         **dict(LOWDELAY, ref_frames=ref_frames)))
    plan = []
    for f in slice_frames(PLAN_FRAMES):
        meta = enc.submit_frame(*f)
        enc.finalize_frame(meta)
        plan.append(plan_entry(meta))
    return plan


def plan_entry(meta: dict) -> dict:
    """The frame-plan fields of an encoder's submit_frame meta."""
    return {"poc": int(meta["poc"]), "qp": int(meta["qp"]),
            "l0": [int(p) for p in meta["l0"]],
            "l1": [int(p) for p in meta["l1"]],
            "is_ref": bool(meta.get("is_ref", True)),
            "dpb_pocs": [int(p) for p in meta["dpb_pocs"]]}


def gop_plan_entry(meta: dict) -> dict:
    """plan_entry plus the B pyramid's fields: display index, slice
    type, NAL kind ("IDR", "CRA", "RASL" or ""), the retention set."""
    keep = meta.get("keep")
    return dict(plan_entry(meta), disp=int(meta["frame_num"]),
                slice_type=int(meta["slice_type"]),
                nal="IDR" if meta["is_idr"] else meta.get("nal", ""),
                keep=None if keep is None else sorted(int(p) for p in keep))


class PlanStub:
    """Stands in for an encoder's pipelines (the JAX package's or the
    port's): no device work; the reconstruction is the source."""

    def submit(self, y, cb, cr, qp=None, **kw):
        return {"rec_y": y, "rec_cb": cb, "rec_cr": cr}

    def submit_inter(self, y, cb, cr, *refs, ref_pocs=None, qp=None):
        return self.submit(y, cb, cr)

    def submit_inter_b(self, y, cb, cr, l0, l1, l0_pocs, l1_pocs, qp=None):
        return self.submit(y, cb, cr)


def drive_plan(enc, frames) -> list[dict]:
    """Feed frames to enc (the JAX package's Encoder or the port's) in
    display order through push_frame/flush with its pipelines replaced by
    PlanStub and finalize_frame by a recorder; returns the coded frames'
    gop_plan_entry in coding order."""
    stub = PlanStub()
    enc._pipeline = stub
    if hasattr(enc, "_inter_pipeline"):
        enc._inter_pipeline = stub
    plan = []

    def finalize(meta):
        plan.append(gop_plan_entry(meta))
        return b"", {}
    enc.finalize_frame = finalize
    for f in frames:
        enc.push_frame(*f)
    enc.flush()
    return plan


def jax_gop_plan(name: str) -> list[dict]:
    from kvazaar_tpu.api import Encoder
    from kvazaar_tpu.cfg import Config
    cfg, n = GOP_PLANS[name]
    return drive_plan(Encoder(Config(width=W, height=H, **cfg)),
                      gop_frames(n))


def jax_gop_stream(frames, keys=MAP_KEYS,
                   **cfg) -> tuple[bytes, list[dict], list[dict]]:
    """Encode display-order frames with kvazaar_tpu through
    encode_sequence (push_frame/flush); returns (stream, decisions: the
    maps of `keys`, plan), the last two per coded frame in coding
    order."""
    from kvazaar_tpu.api import Encoder, encode_sequence
    from kvazaar_tpu.cfg import Config
    enc = Encoder(Config(width=frames[0][0].shape[1],
                         height=frames[0][0].shape[0], **cfg))
    decs, plan = [], []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        plan.append(gop_plan_entry(meta))
        decs.append({k: np.asarray(v) for k, v in
                     enc._last_decisions.items() if k in keys})
        return out
    enc.finalize_frame = record
    stream, _ = encode_sequence(enc.cfg, frames, encoder=enc)
    return stream, decs, plan


def gop_leaf_inputs() -> dict:
    """Inputs of the distinct-list leaf goldens at 128x64: four pictures
    that share slice frame 0's content under independent +-12 noise, two
    a list, and a source of that content with +-2 noise, so averaging
    a list 0 picture with a list 1 picture predicts it better than
    either alone."""
    rng = np.random.RandomState(22)
    base = [p.astype(np.int32) for p in slice_frames(1)[0]]

    def noisy(amp):
        return tuple(np.clip(p + rng.randint(-amp, amp + 1, p.shape), 0,
                             255).astype(np.uint8) for p in base)
    return {"src": noisy(2), "l0": (noisy(12), noisy(12)),
            "l1": (noisy(12), noisy(12))}


def jax_gop_leaves(tags=("b", "u")) -> dict:
    """The JAX B inter leaf at n = 16 and 64, list 0 and list 1 on their
    own two-picture stacks of gop_leaf_inputs (a coarse field and ME set
    per list), with bi-prediction on (tag "b": `gleafb<n>_*`) and off
    ("u": `gleafu<n>_*`), QP LEAF_QP."""
    import jax
    import jax.numpy as jnp
    from kvazaar_tpu.models.inter_md import MdInterPipeline
    inp = gop_leaf_inputs()
    src = tuple(jnp.asarray(p, jnp.int32) for p in inp["src"])
    stacks = [tuple(jnp.stack([jnp.asarray(r[c], jnp.int32)
                               for r in inp[lst]]) for c in range(3))
              for lst in ("l0", "l1")]
    out = {}
    for tag in tags:
        pipe = MdInterPipeline(H, W, LEAF_QP, n_refs=2, b_slices=True,
                               deblock=True, bipred=tag == "b")
        lam = pipe.lam2[0]
        for n, t, tc in ((16, pipe.t16, pipe.t8), (64, pipe.t32, pipe.t16)):
            def leaf(s_y, s_cb, s_cr, l0, l1, n=n, t=t, tc=tc, pipe=pipe,
                     lam=lam):
                f0 = [pipe._coarse_field(s_y, l0[0][k]) for k in range(2)]
                f1 = [pipe._coarse_field(s_y, l1[0][k]) for k in range(2)]
                me0 = pipe._me_kernel_sizes(s_y, l0[0], f0, None)
                me1 = pipe._me_kernel_sizes(s_y, l1[0], f1, None)
                return pipe._inter_leaf_b(s_y, s_cb, s_cr, l0, l1, f0, f1,
                                          n, t, tc, lam, me0=me0[n],
                                          me1=me1[n])
            res = jax.jit(pipe._with_consts(leaf))(pipe.consts, *src,
                                                   *stacks)
            for k, v in zip(("mv0", "r0", "mv1", "r1", "dir", "cost",
                             "pred_y", "pred_cb", "pred_cr"), res):
                out[f"gleaf{tag}{n}_{k}"] = np.asarray(v)
    return out


def cross_inputs() -> dict:
    """Inputs of the two-reference leaf goldens at 128x64: two reference
    pictures that share slice frame 0's content under independent +-12
    noise, and a source of that content with +-2 noise, so averaging
    the two pictures (the cross-reference bi candidate: list 0 on picture
    0, list 1 on picture 1) predicts it better than either alone."""
    rng = np.random.RandomState(21)
    base = [p.astype(np.int32) for p in slice_frames(1)[0]]

    def noisy(amp):
        return tuple(np.clip(p + rng.randint(-amp, amp + 1, p.shape), 0,
                             255).astype(np.uint8) for p in base)
    return {"src": noisy(2), "refs": (noisy(12), noisy(12))}


def jax_lowdelay_leaves() -> dict:
    """The JAX B inter leaf at n = 16 and 64 with both lists the
    two-picture stack of cross_inputs (QP LEAF_QP)."""
    import jax
    import jax.numpy as jnp
    from kvazaar_tpu.models.inter_md import MdInterPipeline
    inp = cross_inputs()
    pipe = MdInterPipeline(H, W, LEAF_QP, n_refs=2, b_slices=True,
                           deblock=True)
    src = tuple(jnp.asarray(p, jnp.int32) for p in inp["src"])
    stack = tuple(jnp.stack([jnp.asarray(r[c], jnp.int32)
                             for r in inp["refs"]]) for c in range(3))
    lam = pipe.lam2[0]
    out = {}
    for n, t, tc in ((16, pipe.t16, pipe.t8), (64, pipe.t32, pipe.t16)):
        def leaf(s_y, s_cb, s_cr, l0, n=n, t=t, tc=tc):
            fields = [pipe._coarse_field(s_y, l0[0][k]) for k in range(2)]
            me = pipe._me_kernel_sizes(s_y, l0[0], fields, None)
            return pipe._inter_leaf_b(s_y, s_cb, s_cr, l0, l0, fields,
                                      fields, n, t, tc, lam, me0=me[n],
                                      me1=me[n])
        res = jax.jit(pipe._with_consts(leaf))(pipe.consts, *src, stack)
        for k, v in zip(("mv0", "r0", "mv1", "r1", "dir", "cost",
                         "pred_y", "pred_cb", "pred_cr"), res):
            out[f"ldleaf{n}_{k}"] = np.asarray(v)
    return out


def p_frames(kind: str, n: int) -> list:
    """Frames of a P_CONFIGS entry: slice_frames, or tests/test_smp.py's
    split-motion content at SMP_W x SMP_H."""
    if kind == "split":
        from chip_smoke import split_motion_frames
        return split_motion_frames(n, SMP_W, SMP_H)
    return slice_frames(n)


def split_inputs() -> dict:
    """Inputs of the SMP leaf goldens at 128x64: split-motion content with
    its band edge at row 40 (half a 16-block, a quarter of a 32-block
    inside the CU rows 32-63), frame 2 as the source and frames 1 and 0
    as a two-picture stack."""
    from chip_smoke import split_motion_frames
    f = split_motion_frames(3, W, H, edges=(40,))
    return {"src": f[2], "refs": (f[1], f[0])}


def p_pipeline(**kw):
    """The JAX P pipeline of the stage goldens: QP LEAF_QP, two pictures
    a stack, deblocking on."""
    from kvazaar_tpu.models.inter_md import MdInterPipeline
    return MdInterPipeline(H, W, LEAF_QP, n_refs=2, b_slices=False,
                           deblock=True, **kw)


def _stack_inputs(inp):
    import jax.numpy as jnp
    src = tuple(jnp.asarray(p, jnp.int32) for p in inp["src"])
    refs = tuple(jnp.stack([jnp.asarray(r[c], jnp.int32)
                            for r in inp["refs"]]) for c in range(3))
    return src, refs


def jax_p_leaves() -> dict:
    """The JAX P merge alignment and inter leaf at n = 16 and 64 on
    cross_inputs, and the SMP/AMP leaf at n = 16 and 32 on split_inputs
    (two-picture stacks, QP LEAF_QP)."""
    import jax
    import jax.numpy as jnp
    pipe = p_pipeline()
    lam = pipe.lam2[0]
    src, refs = _stack_inputs(cross_inputs())
    out = {}
    for n, t, tc in ((16, pipe.t16, pipe.t8), (64, pipe.t32, pipe.t16)):
        def leaf(s_y, s_cb, s_cr, r_y, r_cb, r_cr, n=n, t=t, tc=tc):
            fields = [pipe._coarse_field(s_y, r_y[k]) for k in range(2)]
            pipe._merge_field0 = fields[0]
            me = pipe._me_kernel_sizes(s_y, r_y, fields, None)
            blocks, rows, cols = pipe._blocks_of(s_y, n)
            lam_satd = jnp.sqrt(lam).astype(jnp.float32)
            mv_q, ref, satd, bits, pred = pipe._pick_ref_me(
                me[n], lam_satd, rows * cols)
            merge = pipe._merge_align_p(None, r_y, blocks, rows, cols, n,
                                        mv_q, ref, satd, bits, pred,
                                        lam_satd)
            return merge, pipe._inter_leaf(s_y, s_cb, s_cr, r_y, r_cb,
                                           r_cr, fields, n, t, tc, lam,
                                           me=me[n], planes=None)
        merge, res = jax.jit(pipe._with_consts(leaf))(pipe.consts, *src,
                                                     *refs)
        for k, v in zip(MERGE_P_KEYS, merge):
            out[f"pmerge{n}_{k}"] = np.asarray(v)
        for k, v in zip(LEAF_P_KEYS, res):
            out[f"pleaf{n}_{k}"] = np.asarray(v)
    pipe = p_pipeline(smp=True, amp=True)
    lam = pipe.lam2[0]
    src, refs = _stack_inputs(split_inputs())
    for n in (16, 32):
        def smp(s_y, s_cb, s_cr, r_y, r_cb, r_cr, n=n):
            fields = [pipe._coarse_field(s_y, r_y[k]) for k in range(2)]
            return pipe._smp_leaf(s_y, s_cb, s_cr, r_y, r_cb, r_cr, fields,
                                  n, lam)
        res = jax.jit(pipe._with_consts(smp))(pipe.consts, *src, *refs)
        for k, v in zip(SMP_KEYS, res):
            out[f"psmp{n}_{k}"] = np.asarray(v)
    return out


MERGE_P_KEYS = ("mv", "ref", "mv_bits", "pred_y", "use", "delta")
LEAF_P_KEYS = ("mv", "ref", "cost", "pred_y", "pred_cb", "pred_cr")
SMP_KEYS = ("part", "mva", "refa", "mvb", "refb", "cost")


def _stream_arrays(prefix: str, stream: bytes, decs: list) -> dict:
    data = {prefix + "stream": np.frombuffer(stream, np.uint8)}
    for i, d in enumerate(decs):
        for k, v in d.items():
            data[f"{prefix}f{i}_{k}"] = v
    return data


def _save(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **data)
    print(f"wrote {path}: {len(data)} arrays")


def write_slice_golden(path: str = OUT) -> None:
    data = _stream_arrays("", *jax_stream(slice_frames()))
    data.update(jax_stages())
    _save(path, data)


def write_tools_golden(path: str = OUT_TOOLS) -> None:
    data = {}
    for name, (cfg, n) in TOOL_CONFIGS.items():
        data.update(_stream_arrays(name + "_",
                                   *jax_stream(slice_frames(n), **cfg)))
    _save(path, data)


def write_lowdelay_golden(path: str = OUT_LOWDELAY) -> None:
    import json
    data = {}
    for name, (cfg, n) in LOWDELAY_CONFIGS.items():
        data.update(_stream_arrays(name + "_",
                                   *jax_stream(slice_frames(n), **cfg)))
    for r in PLAN_REFS:
        data[f"plan_ref{r}"] = np.array(json.dumps(jax_plan(r)))
    data.update(jax_lowdelay_leaves())
    _save(path, data)


def write_p_golden(path: str = OUT_P) -> None:
    import time
    data = {}
    for name, (cfg, kind, n) in P_CONFIGS.items():
        t = time.perf_counter()
        data.update(_stream_arrays(name + "_",
                                   *jax_stream(p_frames(kind, n), **cfg)))
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    data.update(jax_p_leaves())
    print(f"stages: {time.perf_counter() - t:.1f} s", flush=True)
    _save(path, data)


def _gop_part(part: str) -> dict:
    """The arrays of one part of the GOP golden: a GOP_CONFIGS stream,
    the distinct-list leaves with bi-prediction on ("leaves_b") or off
    ("leaves_u"), or the frame plans ("plans")."""
    import json
    import time
    t = time.perf_counter()
    if part == "plans":
        data = {f"plan_{name}": np.array(json.dumps(jax_gop_plan(name)))
                for name in GOP_PLANS}
    elif part.startswith("leaves_"):
        data = jax_gop_leaves((part[-1],))
    else:
        cfg, n = GOP_CONFIGS[part]
        stream, decs, plan = jax_gop_stream(gop_frames(n), **cfg)
        data = _stream_arrays(part + "_", stream, decs)
        data[f"{part}_plan"] = np.array(json.dumps(plan))
    print(f"{part}: {time.perf_counter() - t:.1f} s", flush=True)
    return data


def write_gop_golden(path: str = OUT_GOP, workers: int = 2) -> None:
    """Each part in a fresh process, `workers` at a time: one process
    that compiles every program of the file runs out of the memory that
    XLA's CPU backend maps for compiled code."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    parts = ["ref2", "g8", "open", "nobi", "leaves_b", "leaves_u", "plans"]
    data = {}
    with ProcessPoolExecutor(workers, max_tasks_per_child=1,
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as ex:
        for arrays in ex.map(_gop_part, parts):
            data.update(arrays)
    _save(path, data)


# the preset ladder. PRESET_KEYS: the maps of every coded frame, with the
# per-4x4 PU modes of NxN cells. PRESET_CONFIGS: (configuration, content,
# frames); "nxn" is tests/test_intra_nxn.py's NxN run on its detail
# content, "rd3" the deepest intra range with the --rd ladder and every
# tool on half flat, half detailed content (64 leaves, NxN with the
# mode-dependent sign-hiding scan, ties in the ladder), "d44" / "d00"
# forced NxN and 64-only, and ultrafast, medium (bench.py's comparison
# point) and placebo the presets themselves (kvazaar_tpu.cfg.PRESETS,
# applied over the defaults as the CLI applies --preset).
PRESET_KEYS = MAP_KEYS + ("mode_map4",)
PRESET_CONFIGS = {
    "nxn": (dict(qp=22, intra_period=1, pu_depth_intra=(1, 4)), "detail",
            2),
    "rd3": (dict(qp=27, intra_period=1, pu_depth_intra=(0, 4), rd=3,
                 sao_type="full", rdoq_enable=True, signhide_enable=True),
            "halfflat", 2),
    "d44": (dict(qp=27, intra_period=1, pu_depth_intra=(4, 4)),
            "halfflat", 1),
    "d00": (dict(qp=27, intra_period=1, pu_depth_intra=(0, 0)),
            "halfflat", 1),
    "ultrafast": ("ultrafast", "gop", 5),
    "medium": ("medium", "gop", 5),
    "placebo": ("placebo", "gop", 5),
}
# the depth gates of the inter split DP: (pu_depth_intra, pu_depth_inter)
DP_GATES = {"ultrafast": ((2, 3), (1, 2)), "veryfast": ((2, 3), (1, 3)),
            "medium": ((1, 4), (0, 3)), "d44": ((4, 4), (0, 3)),
            "d00": ((0, 0), (0, 3))}
# intra depth ranges of the partition stage, and QP of the intra stages
PART_RANGES = ((0, 4), (1, 4), (2, 3), (4, 4))
STAGE_QP = 27


def intra_frames(kind: str, n: int, w: int = W, h: int = H) -> list:
    """All-intra content. "detail": tests/test_intra_nxn.py's mosaic of
    4x4 directional gradients (its generator and seed), where one 8x8
    mode cannot fit the four quadrants, so NxN wins on many cells;
    "halfflat": that mosaic in the left half and, in the right half, a
    flat top (every intra mode predicts it exactly: SATD ties) over a
    shallow ramp, with flat chroma beside a chroma ramp."""
    rng = np.random.RandomState(1234)
    out = []
    for i in range(n):
        y = np.zeros((h, w), np.int32)
        for by in range(0, h, 4):
            for bx in range(0, w, 4):
                k = rng.randint(4)
                g = np.add.outer(np.arange(4) * [13, -13, 0, 29][k],
                                 np.arange(4) * [0, 23, -23, -17][k])
                y[by:by + 4, bx:bx + 4] = rng.randint(0, 200) + g
        cb = np.full((h // 2, w // 2), 128, np.int32)
        cr = np.full((h // 2, w // 2), 128, np.int32)
        if kind == "halfflat":
            xs = np.arange(w - w // 2)
            y[:h // 2, w // 2:] = 117 + i
            y[h // 2:, w // 2:] = 90 + (xs // 3)[None, :] + 2 * i
            cr[:, w // 4:] = 100 + np.arange(w // 4)[None, :] // 2
        out.append((y.clip(0, 255).astype(np.uint8), cb.astype(np.uint8),
                    cr.astype(np.uint8)))
    return out


def preset_config(name: str) -> dict:
    """Config options of a PRESET_CONFIGS entry."""
    cfg = PRESET_CONFIGS[name][0]
    if isinstance(cfg, str):
        from kvazaar_tpu.cfg import PRESETS
        return dict(PRESETS[cfg])
    return dict(cfg)


def preset_frames(name: str) -> list:
    _, kind, n = PRESET_CONFIGS[name]
    return gop_frames(n) if kind == "gop" else intra_frames(kind, n)


def subpel_inputs() -> dict:
    """Inputs of the sub-pel refinement goldens at 128x64: slice frame 0
    as the reference, frame 1's 16x16 blocks (and the top 16x8 halves)
    as the sources, integer MVs in -4..4 from a fixed seed."""
    f = slice_frames(2)
    ref, src = f[0][0].astype(np.int32), f[1][0].astype(np.int32)
    rows, cols = H // 16, W // 16
    blocks = src.reshape(rows, 16, cols, 16).transpose(0, 2, 1, 3) \
        .reshape(-1, 16, 16)
    bid = np.arange(rows * cols)
    rng = np.random.RandomState(31)
    return {"ref": ref, "blocks": blocks,
            "y0": ((bid // cols) * 16).astype(np.int32),
            "x0": ((bid % cols) * 16).astype(np.int32),
            "mv": rng.randint(-4, 5, (rows * cols, 2)).astype(np.int32)}


def dp_inputs() -> dict:
    """Leaf costs of the split-DP goldens: per size n (8..64) a cost per
    aligned block, uniform noise times n^2 times a factor that makes
    larger leaves cheaper, so an ungated DP picks the 64 and 32 leaves
    the gates forbid."""
    rng = np.random.RandomState(32)
    f = {8: 1.0, 16: 0.9, 32: 0.75, 64: 0.6}
    return {n: (rng.uniform(0.6, 1.0, (H // n) * (W // n)) * n * n * f[n]
                ).astype(np.float32) for n in (8, 16, 32, 64)}


def jax_preset_stages() -> dict:
    """The JAX intra stages on intra_frames("halfflat") at QP STAGE_QP:
    _satd4 on random differences, _leaf_rd4, _leaf_rd64, _leaf_rd at rd
    1, 2 and 3 (n = 8, 16, 32), _partition at PART_RANGES, partition and
    NxN reconstruction with RDOQ and sign hiding at depths 1-4; the inter
    split DP on dp_inputs under DP_GATES; _refine_subpel on
    subpel_inputs at --subme 0, 2 and 4."""
    import jax
    import jax.numpy as jnp
    from kvazaar_tpu.models.inter_md import MdInterPipeline
    from kvazaar_tpu.models.intra_md import MdIntraPipeline
    src = tuple(jnp.asarray(p, jnp.int32)
                for p in intra_frames("halfflat", 1)[0])
    out = {}
    rng = np.random.RandomState(30)
    diff = rng.randint(-255, 256, (96, 4, 4)).astype(np.int32)
    pipe = MdIntraPipeline(H, W, STAGE_QP, pu_depth=(0, 4))
    out["satd4_in"] = diff
    out["satd4_out"] = jax.jit(pipe._satd4)(jnp.asarray(diff))

    def run(p, fn, *args):
        return jax.jit(p._with_consts(fn))(p.consts, *args)

    def leaf4(y, cb, cr):
        return pipe._leaf_rd4(y, cb, cr, pipe.lam2[0])

    def leaf64(y, cb, cr):
        return pipe._leaf_rd64(y, cb, cr, pipe.lam2[0])
    out["leaf4_modes"], out["leaf4_cost"] = run(pipe, leaf4, *src)
    out["leaf64_modes"], out["leaf64_cost"] = run(pipe, leaf64, *src)
    for rd in (1, 2, 3):
        p = MdIntraPipeline(H, W, STAGE_QP, rd=rd)
        for n in (8, 16, 32):
            def leaf(y, cb, cr, p=p, n=n):
                g, f, gc, t, tc = {
                    8: (p.g8l, p.f8, p.g4c, p.t8, p.t4),
                    16: (p.g16l, p.f16l, p.g8cc, p.t16, p.t8),
                    32: (p.g32l, p.f32, p.g16c, p.t32, p.t16)}[n]
                return p._leaf_rd(y, cb, cr, n, g, f, gc, t, tc,
                                  p.lam2[0])
            m, c = run(p, leaf, *src)
            out[f"leafrd{rd}_{n}_modes"], out[f"leafrd{rd}_{n}_cost"] = m, c
    for lo, hi in PART_RANGES:
        p = MdIntraPipeline(H, W, STAGE_QP, pu_depth=(lo, hi))

        def part(y, cb, cr, p=p):
            return p._partition(y, cb, cr, p.lam2[0])
        for k, v in zip(("size_map8", "mode_map8", "mode_map4"),
                        run(p, part, *src)):
            out[f"part{lo}{hi}_{k}"] = v
    p = MdIntraPipeline(H, W, STAGE_QP, pu_depth=(1, 4), rdoq=True,
                        sign_hiding=True)

    def nxn(y, cb, cr):
        sm, mm, m4 = p._partition(y, cb, cr, p.lam2[0])
        luma, chroma, _, _ = p._recon_md(y, cb, cr, sm, mm, mode_map4=m4)
        return sm, mm, m4, luma, chroma
    for k, v in zip(("size_map8", "mode_map8", "mode_map4", "luma",
                     "chroma"), run(p, nxn, *src)):
        out[f"nxnrec_{k}"] = v
    costs = dp_inputs()
    for name, (intra, inter) in DP_GATES.items():
        p = MdInterPipeline(H, W, 22, pu_depth=intra, pu_depth_inter=inter)

        def dp(c8, c16, c32, c64, p=p):
            return p._dp_merge({8: {"cost": c8}, 16: {"cost": c16},
                                32: {"cost": c32}, 64: {"cost": c64}},
                               p.lam2[0])
        out[f"dp_{name}"] = run(p, dp, *(jnp.asarray(costs[n])
                                         for n in (8, 16, 32, 64)))
    inp = subpel_inputs()
    for s in (0, 2, 4):
        p = MdInterPipeline(H, W, 22, subme=s, smp=True)
        P = p.SUBPEL_PAD

        def subpel(ref, blocks, y0, x0, mv, p=p, P=P):
            ypad = jnp.pad(ref, P, mode="edge")
            a = p._refine_subpel(blocks, ypad, y0, x0, mv, P)
            b = p._refine_subpel(blocks[:, :8], ypad, y0, x0, mv, P)
            return a + b
        res = run(p, subpel, *(jnp.asarray(inp[k]) for k in
                               ("ref", "blocks", "y0", "x0", "mv")))
        for k, v in zip(("mv", "satd", "mv_half", "satd_half"), res):
            out[f"subpel{s}_{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _preset_part(part: str) -> dict:
    """The arrays of one part of the presets golden: a PRESET_CONFIGS
    stream (all-intra through encode_frame, presets through
    encode_sequence) or the stages ("stages")."""
    import time
    t = time.perf_counter()
    if part == "stages":
        data = jax_preset_stages()
    elif PRESET_CONFIGS[part][1] == "gop":
        stream, decs, _ = jax_gop_stream(preset_frames(part), PRESET_KEYS,
                                         **preset_config(part))
        data = _stream_arrays(part + "_", stream, decs)
    else:
        data = _stream_arrays(part + "_", *jax_stream(
            preset_frames(part), PRESET_KEYS, **preset_config(part)))
    print(f"{part}: {time.perf_counter() - t:.1f} s", flush=True)
    return data


def write_presets_golden(path: str = OUT_PRESETS, workers: int = 2) -> None:
    """Each part in a fresh process, `workers` at a time (as
    write_gop_golden)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    parts = ["medium", "placebo", "ultrafast", "stages", "rd3", "nxn",
             "d44", "d00"]
    data = {}
    with ProcessPoolExecutor(workers, max_tasks_per_child=1,
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as ex:
        for arrays in ex.map(_preset_part, parts):
            data.update(arrays)
    _save(path, data)


# WPP, rate control and delta QP at RC_W x RC_H: 3x2 CTBs, so that WPP
# has rows to synchronise and a QP map has neighbours. RC_KEYS: the maps
# of every coded frame with the final per-CTB QPs. RC_CONFIGS:
# (configuration, content, frames): chip_smoke.py's mixed_frames
# ("mixed") or intra_frames("halfflat"), at RC_BITRATE (600 kbit/s at
# the default 25 fps: QPs of 11-28 that move from frame to frame) where a
# bitrate is set. "wpp_rc" is
# the default configuration with --wpp --bitrate (lambda RC on IDR + 3
# B, the native writers with WPP); "gop_oba" --gop 4 --wpp --slices wpp
# with OBA RC and the intra bit allocation (pyramid layers, a slice
# segment a CTB row through the Python writers); "lcu_rc" -p 1 --bitrate
# --wpp (LCU RC: a QP map, the final-QP chain reset every row);
# "lcu_oba" -p 1 with OBA (update_oba); "vaq_roi" --vaq 8 --roi with
# SAO, RDOQ and sign hiding (every frame intra); "vaq_leaves" --vaq 8
# --pu-depth-intra 0-4 --rd 3 on half flat content (VAQ offsets that
# differ between CTBs, NxN cells and 64 leaves).
RC_W, RC_H = 192, 128
RC_BITRATE = 600_000
RC_KEYS = MAP_KEYS + ("mode_map4", "qp_ctb")
# the ROI map of "vaq_roi": 4x3 delta QPs over the 3x2 CTBs
ROI_TEXT = "4 3\n-4 0 3 6\n2 -2 5 -6\n1 1 -3 0\n"
RC_CONFIGS = {
    "wpp_rc": (dict(wpp=True, target_bitrate=RC_BITRATE), "mixed", 4),
    "gop_oba": (dict(gop_len=4, wpp=True, slices="wpp",
                     target_bitrate=RC_BITRATE, rc_algorithm="oba",
                     intra_bits=True), "mixed", 6),
    "lcu_rc": (dict(intra_period=1, target_bitrate=RC_BITRATE, wpp=True),
               "mixed", 3),
    "lcu_oba": (dict(intra_period=1, target_bitrate=RC_BITRATE,
                     rc_algorithm="oba"), "mixed", 2),
    "vaq_roi": (dict(vaq=8, roi_file="<roi>", sao_type="full",
                     rdoq_enable=True, signhide_enable=True), "mixed", 2),
    "vaq_leaves": (dict(vaq=8, pu_depth_intra=(0, 4), rd=3), "halfflat",
                   1),
}
# the capi run: "lcu_rc"'s options through config_parse, with owf = 2
RC_CAPI = (("period", "1"), ("bitrate", str(RC_BITRATE)), ("wpp", "1"),
           ("owf", "2"))
RC_CAPI_FRAMES = 4
# the intra stages: one QP per CTB of RC_H x RC_W, at STAGE_QP's slice
STAGE_QPMAP = np.array([[22, 31, 25], [35, 19, 27]], np.int32)
DQ_LEVEL_SEED = 33


def rc_frames(n: int, kind: str = "mixed") -> list:
    if kind == "halfflat":
        return intra_frames(kind, n, RC_W, RC_H)
    from chip_smoke import mixed_frames
    return mixed_frames(n, RC_W, RC_H)


def rc_case_frames(name: str) -> list:
    """The frames of an RC_CONFIGS entry."""
    _, kind, n = RC_CONFIGS[name]
    return rc_frames(n, kind)


def rc_config(name: str, roi_path: str) -> dict:
    """Config options of an RC_CONFIGS entry; a ROI map is written to
    roi_path."""
    cfg = dict(RC_CONFIGS[name][0])
    if "roi_file" in cfg:
        with open(roi_path, "w") as f:
            f.write(ROI_TEXT)
        cfg["roi_file"] = roi_path
    return cfg


def capi_stream(api, frames, **open_kw) -> tuple[bytes, list[int]]:
    """Drive a kvz_api (the JAX package's capi or the port's) with the
    options of RC_CAPI: every frame in, then None until the pipeline is
    drained; returns (stream, QP of each returned picture)."""
    cfg = api.config_alloc()
    for name, value in RC_CAPI:
        assert api.config_parse(cfg, name, value)
    cfg.width, cfg.height = frames[0][0].shape[1], frames[0][0].shape[0]
    enc = api.encoder_open(cfg, **open_kw)
    out, qps = b"", []
    feed = [f for f in frames] + [None] * len(frames)
    for f in feed:
        pic = None
        if f is not None:
            pic = api.picture_alloc(cfg.width, cfg.height)
            pic.y[:], pic.u[:], pic.v[:] = f
        data, _, info = api.encoder_encode(enc, pic)
        if data:
            out += data
            qps.append(int(info.qp))
    api.encoder_close(enc)
    return out, qps


def dq_levels() -> tuple:
    """Sparse level planes at RC_H x RC_W whose CTBs (0, 1), (1, 0) and
    (1, 2) code no coefficient, so the final-QP chain carries a
    predecessor's QP there (across the row end without WPP)."""
    rng = np.random.RandomState(DQ_LEVEL_SEED)
    planes = []
    for h, w, n in ((RC_H, RC_W, 64), (RC_H // 2, RC_W // 2, 32),
                    (RC_H // 2, RC_W // 2, 32)):
        lv = rng.randint(-3, 4, (h, w)) * (rng.rand(h, w) < 0.02)
        for r, c in ((0, 1), (1, 0), (1, 2)):
            lv[r * n:(r + 1) * n, c * n:(c + 1) * n] = 0
        planes.append(lv.astype(np.int32))
    return tuple(planes)


def jax_dq_consts(p, qm):
    """The JAX pipeline p's constants with the per-CTB QP map qm, as its
    submit(qp_map=qm) sets them."""
    import jax.numpy as jnp
    from kvazaar_tpu.tables import chroma_qp
    consts = dict(p.consts)
    consts["qpmap_y"] = jnp.asarray(qm)
    consts["qpmap_c"] = jnp.asarray(
        np.vectorize(chroma_qp)(qm).astype(np.int32))
    consts["lammap"] = jnp.asarray(0.57 * 2.0 ** ((qm - 12) / 3.0),
                                   jnp.float32)
    return consts


def jax_dq_stages() -> dict:
    """The JAX intra stages under delta QP with STAGE_QPMAP on
    intra_frames("halfflat") at RC_H x RC_W: _leaf_rd at --rd 0 and 2
    (n = 8, 16, 32), _leaf_rd4, _leaf_rd64, _partition at depths 0-4,
    partition and reconstruction with RDOQ and sign hiding at depths 1-4,
    and _final_qp with and without WPP on dq_levels."""
    import jax
    import jax.numpy as jnp
    from kvazaar_tpu.models.intra_md import MdIntraPipeline
    src = tuple(jnp.asarray(p, jnp.int32)
                for p in intra_frames("halfflat", 1, RC_W, RC_H)[0])
    qm = STAGE_QPMAP
    out = {}

    def run(p, fn, *args):
        return jax.jit(p._with_consts(fn))(jax_dq_consts(p, qm), *args)

    for rd in (0, 2):
        p = MdIntraPipeline(RC_H, RC_W, STAGE_QP, delta_qp=True, rd=rd)
        for n in (8, 16, 32):
            def leaf(y, cb, cr, p=p, n=n):
                g, f, gc, t, tc = {
                    8: (p.g8l, p.f8, p.g4c, p.t8, p.t4),
                    16: (p.g16l, p.f16l, p.g8cc, p.t16, p.t8),
                    32: (p.g32l, p.f32, p.g16c, p.t32, p.t16)}[n]
                return p._leaf_rd(y, cb, cr, n, g, f, gc, t, tc,
                                  p.lam2[0])
            m, c = run(p, leaf, *src)
            out[f"dq_leafrd{rd}_{n}_modes"] = m
            out[f"dq_leafrd{rd}_{n}_cost"] = c
    p = MdIntraPipeline(RC_H, RC_W, STAGE_QP, delta_qp=True,
                        pu_depth=(0, 4))

    def leaf4(y, cb, cr):
        return p._leaf_rd4(y, cb, cr, p.lam2[0])

    def leaf64(y, cb, cr):
        return p._leaf_rd64(y, cb, cr, p.lam2[0])

    def part(y, cb, cr):
        return p._partition(y, cb, cr, p.lam2[0])
    out["dq_leaf4_modes"], out["dq_leaf4_cost"] = run(p, leaf4, *src)
    out["dq_leaf64_modes"], out["dq_leaf64_cost"] = run(p, leaf64, *src)
    for k, v in zip(("size_map8", "mode_map8", "mode_map4"),
                    run(p, part, *src)):
        out[f"dq_part_{k}"] = v
    p = MdIntraPipeline(RC_H, RC_W, STAGE_QP, delta_qp=True,
                        pu_depth=(1, 4), rdoq=True, sign_hiding=True)

    def rec(y, cb, cr):
        sm, mm, m4 = p._partition(y, cb, cr, p.lam2[0])
        luma, chroma, _, _ = p._recon_md(y, cb, cr, sm, mm, mode_map4=m4)
        return sm, mm, m4, luma, chroma
    for k, v in zip(("size_map8", "mode_map8", "mode_map4", "luma",
                     "chroma"), run(p, rec, *src)):
        out[f"dq_rec_{k}"] = v
    lv = tuple(jnp.asarray(a) for a in dq_levels())
    for wpp in (False, True):
        p = MdIntraPipeline(RC_H, RC_W, STAGE_QP, delta_qp=True, wpp=wpp)
        out["dq_fq_wpp" if wpp else "dq_fq"] = run(p, p._final_qp, *lv)
    return {k: np.asarray(v) for k, v in out.items()}


def _rc_part(part: str) -> dict:
    """The arrays of one part of the RC golden: an RC_CONFIGS stream (with
    the capi run after "lcu_rc", whose program it shares) or the stages
    ("stages")."""
    import json
    import tempfile
    import time
    t = time.perf_counter()
    if part == "stages":
        data = jax_dq_stages()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = rc_config(part, os.path.join(tmp, "roi.txt"))
            stream, decs, plan = jax_gop_stream(rc_case_frames(part),
                                                RC_KEYS, **cfg)
        data = _stream_arrays(part + "_", stream, decs)
        data[f"{part}_plan"] = np.array(json.dumps(plan))
        if part == "lcu_rc":
            from kvazaar_tpu.capi import kvz_api_get
            stream, qps = capi_stream(kvz_api_get(8),
                                      rc_frames(RC_CAPI_FRAMES))
            data["capi_stream"] = np.frombuffer(stream, np.uint8)
            data["capi_qps"] = np.asarray(qps, np.int32)
    print(f"{part}: {time.perf_counter() - t:.1f} s", flush=True)
    return data


RC_PARTS = (("wpp_rc", "gop_oba"),
            ("lcu_rc", "lcu_oba", "vaq_roi", "vaq_leaves", "stages"))


def write_rc_golden(path: str = OUT_RC, only=()) -> None:
    """Each part in a fresh process: the two inter streams one after the
    other in one worker, the intra parts in a second worker beside it
    (two inter programs compiling at once need more memory than one
    intra and one inter). `only`: run these parts and merge them into
    the existing file."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    lanes = [[p for p in lane if not only or p in only]
             for lane in RC_PARTS]
    pools = [ProcessPoolExecutor(1, max_tasks_per_child=1, mp_context=ctx)
             for _ in lanes]
    futs = [pool.submit(_rc_part, part)
            for pool, parts in zip(pools, lanes) for part in parts]
    data = dict(np.load(path)) if only else {}
    for f in futs:
        data.update(f.result())
    for pool in pools:
        pool.shutdown()
    _save(path, data)


# the remaining intra variants at 128x64. VARIANT_KEYS: every coded
# frame's maps with the per-4x4 PU modes and the transform-skip bits.
# VARIANT_CONFIGS: (configuration, content, frames): "trskip" is
# tests/test_trskip.py's run (--transform-skip --pu-depth-intra 1-4, QP
# 27) all-intra on its screen content; "trskip_b" and "fct_b" IDR + 2 B
# of slice_frames with transform skip and with --fast-coeff-table
# FCT_TABLE; "main10" 10-bit with SAO full, RDOQ and sign hiding at QP
# 30 and "main10_p64" at the defaults (-p 64, every frame intra all the
# same), on tests/test_main10.py's 0-1023 content; "scaling" --scaling-
# list default with that tool row; "cqm" --cqmfile CQM_FILE; "lossless".
VARIANT_KEYS = MAP_KEYS + ("mode_map4", "ts8")
VARIANT_TOOLS = dict(sao_type="full", rdoq_enable=True,
                     signhide_enable=True)
VARIANT_CONFIGS = {
    "trskip": (dict(trskip_enable=True, pu_depth_intra=(1, 4), qp=27,
                    intra_period=1), "screen", 2),
    "trskip_b": (dict(trskip_enable=True), "slice", 3),
    "fct_b": (dict(fast_coeff_table=FCT_TABLE), "slice", 3),
    "main10": (dict(VARIANT_TOOLS, input_bitdepth=10, qp=30), "main10",
               2),
    "main10_p64": (dict(input_bitdepth=10), "main10", 3),
    "scaling": (dict(VARIANT_TOOLS, scaling_list="default", qp=30),
                "slice", 2),
    "cqm": (dict(cqmfile=CQM_FILE, qp=30), "slice", 2),
    "lossless": (dict(lossless=True), "slice", 2),
}
# the stages: QP of the 10-bit and transform-skip stages, the QPs of the
# scaled dequant (51 reaches the int32 fold's left shift and its clip)
VARIANT_QP = 30
SDQ_QPS = (4, 30, 51)
VARIANT_SEED = 34


def variant_frames(name: str, w: int = W, h: int = H) -> list:
    """The frames of a VARIANT_CONFIGS entry."""
    from chip_smoke import main10_frames, screen_frames
    _, kind, n = VARIANT_CONFIGS[name]
    return {"screen": screen_frames, "main10": main10_frames,
            "slice": lambda n, w, h: slice_frames(n)}[kind](n, w, h)


def fct_table() -> dict:
    """The --fast-coeff-table of "fct_b": engine/fast_cost_weights.py's
    weights for 4x4 to 16x16 TUs at 1.5 times their value (dearer
    coefficients: fewer coded TUs and larger leaves), and no entry for
    32x32, whose rate then takes the analytic estimate."""
    from kvazaar_tpu_torch.engine.fast_cost_weights import FAST_COST_WEIGHTS
    return {str(k): {str(q): [round(1.5 * x, 4) for x in w]
                     for q, w in v.items()}
            for k, v in FAST_COST_WEIGHTS.items() if k < 5}


def write_fct_table(path: str = FCT_TABLE) -> None:
    import json
    with open(path, "w") as f:
        json.dump(fct_table(), f, indent=1)
        f.write("\n")


def cqm_text() -> str:
    """An HM-format quantisation-matrix file (kvazaar --cqmfile): every
    intra and inter list from the default ones at three quarters of
    their value plus noise from a fixed seed, in up-right diagonal scan
    order; Cr equal to Cb (the quadtree path quantises both chroma
    planes with matrix id 1, as the reference does), DC values 12."""
    from kvazaar_tpu_torch.hevc.scaling import default_list
    from kvazaar_tpu_torch.tables import SCAN_DIAG, scan_order
    rng = np.random.RandomState(35)
    lines = []
    for size_id, (sz, names) in enumerate((
            ("4X4", ("LUMA", "CHROMAU", "CHROMAV")),
            ("8X8", ("LUMA", "CHROMAU", "CHROMAV")),
            ("16X16", ("LUMA", "CHROMAU", "CHROMAV")),
            ("32X32", ("LUMA",)))):
        log2 = 2 if size_id == 0 else 3
        for mode, base_id in (("INTRA", 0), ("INTER", 3)):
            chroma = None
            for k, nm in enumerate(names):
                if nm == "CHROMAV":
                    vals = chroma
                else:
                    base = default_list(size_id, base_id + k)
                    vals = [int(np.clip(base[y, x] * 3 // 4
                                        + rng.randint(0, 9), 6, 100))
                            for x, y in scan_order(SCAN_DIAG, log2)]
                    chroma = vals
                lines.append(f"{mode}{sz}_{nm} =")
                for i in range(0, len(vals), 8):
                    lines.append(",".join(str(v) for v in vals[i:i + 8])
                                 + ",")
                if size_id >= 2:
                    lines.append(f"{mode}{sz}_{nm}_DC =")
                    lines.append("12")
    return "\n".join(lines) + "\n"


def write_cqm_file(path: str = CQM_FILE) -> None:
    with open(path, "w") as f:
        f.write(cqm_text())


def variant_stage_inputs() -> dict:
    """Residual blocks of the variant stages, from VARIANT_SEED: per size
    n, 8 random TUs at amplitudes 4, 40, 400 and 1023 (two each, int32
    [8, n, n]; `r10_<n>`); and 4x4 TUs that favour one side of the
    transform-skip competition or the other (`ts4`, [32, 4, 4]): one to
    three isolated spikes on zero, steps, smooth ramps and small noise."""
    rng = np.random.RandomState(VARIANT_SEED)
    out = {}
    amps = np.repeat([4, 40, 400, 1023], 2)
    for n in (4, 8, 16, 32):
        r = rng.randint(-1023, 1024, (8, n, n))
        out[f"r10_{n}"] = (r * amps[:, None, None] // 1023).astype(np.int32)
    ts = np.zeros((32, 4, 4), np.int32)
    yy, xx = np.mgrid[0:4, 0:4]
    for i in range(32):
        kind = i % 4
        if kind == 0:
            for _ in range(1 + i % 3):
                ts[i, rng.randint(4), rng.randint(4)] = \
                    rng.choice([-1, 1]) * rng.randint(40, 140)
        elif kind == 1:
            ts[i] = np.where(xx >= 1 + i % 3, rng.randint(30, 120), 0)
        elif kind == 2:
            ts[i] = (xx * rng.randint(-9, 10) + yy * rng.randint(-9, 10))
        else:
            ts[i] = rng.randint(-6, 7, (4, 4))
    out["ts4"] = ts
    return out


def jax_variant_stages() -> dict:
    """The JAX intra stages of the variants on variant_stage_inputs():
    _transform_quant at 10-bit and VARIANT_QP for luma n = 4 (DST) to 32
    and chroma n = 4 to 16, with the plain quantiser and with RDOQ and
    sign hiding (`tq10{p,r}_{y,c}{n}_*`); the scaled dequant through
    _transform_quant with the default lists at 8 and 10 bits and the QPs
    of SDQ_QPS (`sdq{bd}_{y,c}{n}_q{qp}_*`); _transform_quant_skip on
    4x4 TUs at 8 and 10 bits, plain, with RDOQ and sign hiding, and with
    the default lists (`tqs{bd}{p,r,s}_{y,c}_*`); the transform-skip RD
    competition _tq_4x4_rd at QP VARIANT_QP, plain and with RDOQ and
    sign hiding (`tqrd{p,r}_{y,c}_*`: levels, reconstruction, choice);
    and at 10-bit on main10 frame 0 the leaf costs of _leaf_rd (n = 8,
    16, 32), _leaf_rd4, and _partition at depths 1-4 (`leaf10_*`,
    `part10_*`)."""
    import jax
    import jax.numpy as jnp
    from kvazaar_tpu.hevc.scaling import ScalingLists
    from kvazaar_tpu.models.intra_md import MdIntraPipeline
    inp = variant_stage_inputs()
    out = {}

    def run(p, fn, *args):
        return jax.jit(p._with_consts(fn))(p.consts, *args)

    def tmat(p, n, luma):
        return p.dst4 if (luma and n == 4) else getattr(p, f"t{n}")

    shapes = ((4, True), (8, True), (16, True), (32, True), (4, False),
              (8, False), (16, False))
    for tag, tools in (("p", {}), ("r", dict(rdoq=True,
                                              sign_hiding=True))):
        p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=10, **tools)
        for n, luma in shapes:
            def tq(r, p=p, n=n, luma=luma):
                return p._transform_quant(
                    r, tmat(p, n, luma), p.qp2[0] if luma else p.qp2[1],
                    n, is_luma=luma)
            key = f"tq10{tag}_{'y' if luma else 'c'}{n}"
            out[key + "_levels"], out[key + "_resi"] = run(
                p, tq, jnp.asarray(inp[f"r10_{n}"]))
    for bd in (8, 10):
        p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=bd,
                            scaling=ScalingLists())
        for n, luma in shapes:
            r = jnp.asarray(inp[f"r10_{n}"] >> (10 - bd))
            for qp in SDQ_QPS:
                def sdq(r, p=p, n=n, luma=luma, qp=qp):
                    return p._transform_quant(
                        r, tmat(p, n, luma), qp, n,
                        mats=p._mats_for(n, luma), is_luma=luma)
                key = f"sdq{bd}_{'y' if luma else 'c'}{n}_q{qp}"
                out[key + "_levels"], out[key + "_resi"] = run(p, sdq, r)
    for bd in (8, 10):
        for tag, kw in (("p", {}), ("r", dict(rdoq=True, sign_hiding=True)),
                        ("s", dict(scaling=ScalingLists()))):
            p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=bd, trskip=True,
                                **kw)
            r = jnp.asarray(inp["r10_4"] >> (10 - bd))
            for luma in (True, False):
                def tqs(r, p=p, luma=luma):
                    return p._transform_quant_skip(
                        r, p.qp2[0] if luma else p.qp2[1], 4,
                        mats=p._mats_for(4, luma), is_luma=luma)
                key = f"tqs{bd}{tag}_{'y' if luma else 'c'}"
                out[key + "_levels"], out[key + "_resi"] = run(p, tqs, r)
    for tag, kw in (("p", {}), ("r", dict(rdoq=True, sign_hiding=True))):
        p = MdIntraPipeline(H, W, VARIANT_QP, trskip=True, **kw)
        for luma in (True, False):
            def tqrd(r, p=p, luma=luma):
                # the wavefront's lambda (MdIntraPipeline._class_apply)
                lam = 0.57 * 2.0 ** ((jnp.asarray(p.qp2[0], jnp.float32)
                                      - 12.0) / 3.0)
                return p._tq_4x4_rd(r, p.dst4 if luma else p.t4,
                                    p.qp2[0] if luma else p.qp2[1], lam,
                                    mats=p._mats_for(4, luma),
                                    is_luma=luma)
            key = f"tqrd{tag}_{'y' if luma else 'c'}"
            lv, r2, use = run(p, tqrd, jnp.asarray(inp["ts4"]))
            out.update({key + "_levels": lv, key + "_resi": r2,
                        key + "_use": use})
    src = tuple(jnp.asarray(a, jnp.int32)
                for a in variant_frames("main10")[0])
    p = MdIntraPipeline(H, W, VARIANT_QP, bit_depth=10, pu_depth=(1, 4))
    for n in (8, 16, 32):
        def leaf(y, cb, cr, n=n):
            g, f, gc, t, tc = {
                8: (p.g8l, p.f8, p.g4c, p.t8, p.t4),
                16: (p.g16l, p.f16l, p.g8cc, p.t16, p.t8),
                32: (p.g32l, p.f32, p.g16c, p.t32, p.t16)}[n]
            return p._leaf_rd(y, cb, cr, n, g, f, gc, t, tc, p.lam2[0])
        out[f"leaf10_{n}_modes"], out[f"leaf10_{n}_cost"] = run(p, leaf,
                                                                *src)

    def leaf4(y, cb, cr):
        return p._leaf_rd4(y, cb, cr, p.lam2[0])

    def part(y, cb, cr):
        return p._partition(y, cb, cr, p.lam2[0])
    out["leaf10_4_modes"], out["leaf10_4_cost"] = run(p, leaf4, *src)
    for k, v in zip(("size_map8", "mode_map8", "mode_map4"),
                    run(p, part, *src)):
        out[f"part10_{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _variant_part(part: str) -> dict:
    """The arrays of one part of the variants golden: a VARIANT_CONFIGS
    stream through encode_sequence, or the stages ("stages")."""
    import time
    t = time.perf_counter()
    if part == "stages":
        data = jax_variant_stages()
    else:
        stream, decs, _ = jax_gop_stream(
            variant_frames(part), VARIANT_KEYS, **VARIANT_CONFIGS[part][0])
        data = _stream_arrays(part + "_", stream, decs)
    print(f"{part}: {time.perf_counter() - t:.1f} s", flush=True)
    return data


VARIANT_PARTS = (("trskip_b", "fct_b"),
                 ("trskip", "main10", "main10_p64", "scaling", "cqm",
                  "lossless", "stages"))


def write_variants_golden(path: str = OUT_VARIANTS, only=()) -> None:
    """Each part in a fresh process: the two B programs one after the
    other in one worker, the all-intra parts in a second worker beside it
    (as write_rc_golden). `only`: run these parts and merge them into the
    existing file."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    lanes = [[p for p in lane if not only or p in only]
             for lane in VARIANT_PARTS]
    pools = [ProcessPoolExecutor(1, max_tasks_per_child=1, mp_context=ctx)
             for _ in lanes]
    futs = [pool.submit(_variant_part, part)
            for pool, parts in zip(pools, lanes) for part in parts]
    data = dict(np.load(path)) if only else {}
    for f in futs:
        data.update(f.result())
    for pool in pools:
        pool.shutdown()
    _save(path, data)


# selective encryption, field coding and tiles. EXTRA_KEYS: every coded
# frame's maps with the per-CTB QPs (the JAX tile stitch carries no
# mode_map4). EXTRA_CONFIGS: (configuration, content, width, height,
# frames): "crypto_intra" the three intra features of --crypto with
# chip_smoke.py's --key SMOKE_KEY on one frame; "crypto_on" every
# feature on IDR + 2 B; "tff" and "bff" field coding, each frame two
# fields of 128x64 (IDR + 3 B); "tff_frames" the JAX CLI's and capi.py's field coding, which
# feed whole 128x64 frames to submit_frame (no split: WHOLE_FRAMES);
# "tiles*" a 2x2 grid of 128x64 tiles: plain, with SAO full, with
# RDOQ and sign hiding, with --slices tiles, --vaq 8, --crypto on and
# --pu-depth-intra 1-4 (on the NxN mosaic intra_frames("detail")), and
# "tiles21" a 2x1 grid over 200x136 (4x3 CTBs after padding).
EXTRA_KEYS = RC_KEYS
CRYPTO_INTRA = "intra_pred_modes+trans_coeffs+trans_coeff_signs"
TILES = dict(tiles=(2, 2))
EXTRA_CONFIGS = {
    "crypto_intra": (dict(crypto=CRYPTO_INTRA, crypto_key=SMOKE_KEY),
                     "mixed", 128, 128, 1),
    "crypto_on": (dict(crypto="on", crypto_key=SMOKE_KEY), "mixed", 128,
                  64, 3),
    "tff": (dict(source_scan_type="tff"), "mixed", 128, 128, 2),
    "bff": (dict(source_scan_type="bff"), "mixed", 128, 128, 2),
    "tff_frames": (dict(source_scan_type="tff"), "mixed", 128, 64, 2),
    "tiles": (TILES, "mixed", 256, 128, 2),
    "tiles_sao": (dict(TILES, qp=27, sao_type="full"), "mixed", 256, 128,
                  1),
    "tiles_rdoq": (dict(TILES, qp=27, rdoq_enable=True,
                        signhide_enable=True), "mixed", 256, 128, 1),
    "tiles21": (dict(tiles=(2, 1)), "mixed", 200, 136, 1),
    "tiles_slices": (dict(TILES, slices="tiles"), "mixed", 256, 128, 1),
    "tiles_vaq": (dict(TILES, vaq=8), "mixed", 256, 128, 2),
    "tiles_crypto": (dict(TILES, crypto="on", crypto_key=SMOKE_KEY),
                     "mixed", 256, 128, 1),
    "tiles_nxn": (dict(TILES, pu_depth_intra=(1, 4)), "detail", 256, 128,
                  1),
}


WHOLE_FRAMES = ("tff_frames",)


def extra_frames(name: str) -> list:
    _, kind, w, h, n = EXTRA_CONFIGS[name]
    if kind == "detail":
        return intra_frames(kind, n, w, h)
    from chip_smoke import mixed_frames
    return mixed_frames(n, w, h)


def jax_extra_stream(name: str) -> tuple[bytes, list[dict]]:
    """An EXTRA_CONFIGS stream of kvazaar_tpu through encode_sequence
    (WHOLE_FRAMES: encode_frame a frame); returns (stream, the maps of
    EXTRA_KEYS per coded frame). Field coding's encoder is built on the
    field configuration, as encode_sequence builds it."""
    import copy
    from kvazaar_tpu.api import Encoder, encode_sequence
    from kvazaar_tpu.cfg import Config
    frames = extra_frames(name)
    h, w = frames[0][0].shape
    cfg = Config(width=w, height=h, **EXTRA_CONFIGS[name][0])
    ecfg = cfg
    if cfg.source_scan_type != "progressive" and name not in WHOLE_FRAMES:
        ecfg = copy.copy(cfg)
        ecfg.height = h // 2
        ecfg._fields_split = True
    enc = Encoder(ecfg)
    decs = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        decs.append({k: np.asarray(v) for k, v in
                     enc._last_decisions.items() if k in EXTRA_KEYS})
        return out
    enc.finalize_frame = record
    if name in WHOLE_FRAMES:
        return b"".join(enc.encode_frame(*f)[0] for f in frames), decs
    stream, _ = encode_sequence(cfg, frames, encoder=enc)
    return stream, decs


def _extra_part(part: str) -> dict:
    import time
    t = time.perf_counter()
    data = _stream_arrays(part + "_", *jax_extra_stream(part))
    print(f"{part}: {time.perf_counter() - t:.1f} s", flush=True)
    return data


# the three B streams share one compiled JAX B program in one worker
EXTRA_PARTS = (("crypto_on", "tff", "bff", "tff_frames"),
               ("crypto_intra", "tiles", "tiles_sao", "tiles_rdoq",
                "tiles21", "tiles_slices", "tiles_vaq", "tiles_crypto",
                "tiles_nxn"))


def _extra_lane(parts) -> dict:
    data = {}
    for part in parts:
        data.update(_extra_part(part))
    return data


def write_extras_golden(path: str = OUT_EXTRAS, only=()) -> None:
    """Two workers side by side, each a fresh process: the B streams in
    one, the all-intra streams in the other. `only`: run these parts and
    merge them into the existing file."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    lanes = [[p for p in lane if not only or p in only]
             for lane in EXTRA_PARTS]
    with ProcessPoolExecutor(2, mp_context=ctx) as pool:
        futs = [pool.submit(_extra_lane, lane) for lane in lanes if lane]
        data = dict(np.load(path)) if only else {}
        for f in futs:
            data.update(f.result())
    _save(path, data)


# the 16x16-grid pipelines (--ctu 16). GRID_CONFIGS: (configuration,
# width, height, frames) on grid_frames: "p" IDR + 2 P at 120x72 (padded
# to 128x80 with a conformance window); "lp" the low-delay GOP lp-g4d3t1
# with two references (P slices: the grid codes no generalized B); "g8"
# the B pyramid --gop 8 -p 8 with SAO full, RDOQ and sign hiding (an IDR,
# then a period-boundary IDR and seven pictures after it); "wpp_rc"
# --wpp with --bitrate (lambda RC, a QP a frame); "batch" -p 1 with
# frame_batch 2 over 3 frames (the same stream as unbatched); "tff" field
# coding at 128x80 (fields of 40 lines, padded to 48).
GRID_KEYS = ("modes", "levels_y", "levels_cb", "levels_cr", "mv",
             "is_inter", "ref_idx", "mv2", "ref2", "inter_dir", "hash",
             "rec_y", "rec_cb", "rec_cr") + SAO_KEYS
GRID = dict(ctu_size=16)
GRID_CONFIGS = {
    "p": (GRID, 120, 72, 3),
    "lp": (dict(GRID, gop_len=4, gop_lowdelay=True, gop_lp=(3, 1),
                ref_frames=2), 120, 72, 5),
    "g8": (dict(GRID, gop_len=8, intra_period=8, sao_type="full",
                rdoq_enable=True, signhide_enable=True), 120, 72, 9),
    "wpp_rc": (dict(GRID, wpp=True, target_bitrate=300_000), 120, 72, 3),
    "batch": (dict(GRID, intra_period=1, frame_batch=2), 120, 72, 3),
    "tff": (dict(GRID, source_scan_type="tff"), 128, 80, 2),
}


def grid_frames(n: int, w: int, h: int) -> list:
    """chip_smoke.py's mixed_frames cropped to w x h (any size down to
    16x16; the content is made at least 128x64)."""
    from chip_smoke import mixed_frames
    frames = mixed_frames(n, max(w, 128), max(h, 64))
    return [(y[:h, :w], cb[:h // 2, :w // 2], cr[:h // 2, :w // 2])
            for y, cb, cr in frames]


def jax_grid_stream(name: str) -> tuple[bytes, list[dict]]:
    """A GRID_CONFIGS stream of kvazaar_tpu through encode_sequence;
    returns (stream, the maps of GRID_KEYS per coded frame)."""
    from kvazaar_tpu.api import Encoder, encode_sequence
    from kvazaar_tpu.cfg import Config
    kw, w, h, n = GRID_CONFIGS[name]
    cfg = Config(width=w, height=h, qp=30, **kw)
    ecfg = cfg
    if cfg.source_scan_type != "progressive":
        import copy
        ecfg = copy.copy(cfg)
        ecfg.height = h // 2
        ecfg._fields_split = True
    enc = Encoder(ecfg)
    decs = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        decs.append({k: np.asarray(v) for k, v in
                     enc._last_decisions.items() if k in GRID_KEYS})
        return out
    enc.finalize_frame = record
    stream, _ = encode_sequence(cfg, grid_frames(n, w, h), encoder=enc)
    return stream, decs


def write_grid_golden(path: str = OUT_GRID) -> None:
    """Every GRID_CONFIGS stream in this process (the JAX pipelines of
    one frame size are shared across encoders)."""
    import time
    data = {}
    for name in GRID_CONFIGS:
        t = time.perf_counter()
        data.update(_stream_arrays(name + "_", *jax_grid_stream(name)))
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    _save(path, data)


# the batched CTB-64 intra program. BATCH_CONFIGS: (configuration, width,
# height, frames) on chip_smoke.py's mixed_frames: "md_batch" -p 1 with
# frame_batch 2 over 4 frames (two full batches) at 128x64.
BATCH_KEYS = ("size_map8", "mode_map8", "mode_map4", "levels_y",
              "levels_cb", "levels_cr", "hash", "rec_y", "rec_cb", "rec_cr",
              "n_waves")
BATCH_CONFIGS = {
    "md_batch": (dict(intra_period=1, frame_batch=2), 128, 64, 4),
}


def batch_frames(name: str) -> list:
    from chip_smoke import mixed_frames
    _, w, h, n = BATCH_CONFIGS[name]
    return mixed_frames(n, w, h)


def jax_batch_stream(name: str, frame_batch=None) -> tuple[bytes, list]:
    """A BATCH_CONFIGS stream of kvazaar_tpu through encode_sequence (with
    frame_batch in place of the entry's when given); returns (stream, the
    maps of BATCH_KEYS per coded frame)."""
    from kvazaar_tpu.api import Encoder, encode_sequence
    from kvazaar_tpu.cfg import Config
    kw, w, h, _ = BATCH_CONFIGS[name]
    if frame_batch is not None:
        kw = dict(kw, frame_batch=frame_batch)
    cfg = Config(width=w, height=h, **kw)
    enc = Encoder(cfg)
    decs = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        decs.append({k: np.asarray(v) for k, v in
                     enc._last_decisions.items() if k in BATCH_KEYS})
        return out
    enc.finalize_frame = record
    stream, _ = encode_sequence(cfg, batch_frames(name), encoder=enc)
    return stream, decs


def write_batch_golden(path: str = OUT_BATCH) -> None:
    """Every BATCH_CONFIGS stream, batched and unbatched, in this process;
    prints whether the two are the same stream."""
    import time
    data = {}
    for name in BATCH_CONFIGS:
        t = time.perf_counter()
        stream, decs = jax_batch_stream(name)
        data.update(_stream_arrays(name + "_", stream, decs))
        t1 = time.perf_counter()
        single, _ = jax_batch_stream(name, frame_batch=0)
        data[name + "_single_stream"] = np.frombuffer(single, np.uint8)
        print(f"{name}: batched {t1 - t:.1f} s, unbatched "
              f"{time.perf_counter() - t1:.1f} s; the same stream "
              f"{stream == single}", flush=True)
    _save(path, data)


if __name__ == "__main__":
    which = sys.argv[1:] or ["slice", "tools", "lowdelay", "p", "gop",
                             "presets", "rc", "variants", "extras", "grid",
                             "batch"]
    if which[0] in ("rc", "variants", "extras") and len(which) > 1:
        # python tools/torch_goldens.py rc|variants|extras <part> ...:
        # re-run those parts
        {"rc": write_rc_golden, "variants": write_variants_golden,
         "extras": write_extras_golden}[which[0]](only=tuple(which[1:]))
        sys.exit(0)
    for w in which:
        {"slice": write_slice_golden, "tools": write_tools_golden,
         "lowdelay": write_lowdelay_golden, "p": write_p_golden,
         "gop": write_gop_golden, "presets": write_presets_golden,
         "rc": write_rc_golden, "variants": write_variants_golden,
         "extras": write_extras_golden, "grid": write_grid_golden,
         "batch": write_batch_golden}[w]()
