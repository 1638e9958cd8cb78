"""Package rules of the PyTorch port: it imports neither JAX nor anything of
kvazaar_tpu (nor do chip_smoke.py and the tools that run on the GPU
machine: me_bench.py, me_eval_ab.py, torch_profile.py,
torch_lowdelay_refs.py), it targets CUDA
unless asked for the CPU, and it accepts and refuses the configurations
the JAX package accepts and refuses."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kvazaar_tpu_torch.cfg import PRESETS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "kvazaar_tpu_torch")
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py"]
    + [os.path.join("tools", f)
       for f in ("me_bench.py", "me_eval_ab.py", "torch_profile.py",
                 "torch_lowdelay_refs.py")])
FORBIDDEN = ("jax", "jaxlib", "kvazaar_tpu")


def _imported(path: str) -> set[str]:
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_reference_imports(path):
    bad = sorted(n for n in _imported(path)
                 if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_import_loads_no_jax_or_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "import kvazaar_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'kvazaar_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import kvazaar_tpu_torch.__main__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kvazaar_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_tf32_is_off():
    import kvazaar_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_encoder_targets_cuda_by_default():
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.cfg import Config
    cfg = Config(width=64, height=64)
    if torch.cuda.is_available():
        assert Encoder(cfg)._pipeline.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Encoder(cfg)
    assert Encoder(cfg, device="cpu")._pipeline.device.type == "cpu"


KEY = ",".join(str(i) for i in range(16))
DATA = os.path.join(ROOT, "tests", "data")
CQM = os.path.join(DATA, "torch_cqm.txt")
FCT = os.path.join(DATA, "torch_fct_table.json")


# option sets (CLI flag, value) on which both encoders are built at
# 128x64: the port raises where the JAX package raises (with the same
# exception type) and otherwise writes its VPS, SPS and PPS. "<roi>" is
# replaced by a ROI map file; a name that Config.parse does not know is a
# Config field set as it is (the bit depth, SAO).
OPTION_SETS = {
    "default": (),
    "wpp": (("wpp", "1"),),
    "slices_wpp": (("wpp", "1"), ("slices", "wpp")),
    "slices_wpp_without_wpp": (("slices", "wpp"),),
    "slices_tiles_without_tiles": (("slices", "tiles"),),
    "bitrate": (("bitrate", "500000"),),
    "bitrate_oba": (("bitrate", "500000"), ("rc-algorithm", "oba")),
    "bitrate_no_rc": (("bitrate", "500000"), ("rc-algorithm", "no-rc")),
    "bitrate_intra_bits": (("bitrate", "500000"), ("intra-bits", "1")),
    "bitrate_gop8": (("bitrate", "500000"), ("gop", "8")),
    "bitrate_lp": (("bitrate", "500000"), ("gop", "lp-g4d3t1")),
    "lcu_rc": (("period", "1"), ("bitrate", "500000"), ("wpp", "1")),
    "lcu_oba": (("period", "1"), ("bitrate", "500000"),
                ("rc-algorithm", "oba")),
    "lcu_no_rc": (("period", "1"), ("bitrate", "500000"),
                  ("rc-algorithm", "no-rc")),
    "vaq": (("vaq", "4"),),
    "roi": (("roi", "<roi>"),),
    "vaq_roi_p1": (("vaq", "4"), ("roi", "<roi>"), ("period", "1")),
    "vaq_bitrate": (("vaq", "4"), ("bitrate", "500000")),
    "vaq_gop8": (("vaq", "4"), ("gop", "8")),
    "vaq_lp": (("vaq", "4"), ("gop", "lp-g4d3t1")),
    "vaq_smp": (("vaq", "4"), ("smp", "1")),
    "roi_amp_p1": (("roi", "<roi>"), ("amp", "1"), ("period", "1")),
    "lp_p1": (("gop", "lp-g4d3t1"), ("period", "1")),
    "lp_p1_ref2": (("gop", "lp-g4d3t1"), ("period", "1"), ("ref", "2")),
    "gop8_p1": (("gop", "8"), ("period", "1")),
    "gop4_wpp_slices_oba": (("gop", "4"), ("wpp", "1"), ("slices", "wpp"),
                            ("bitrate", "500000"), ("rc-algorithm", "oba")),
    "main10": (("input_bitdepth", 10),),
    "main10_gop8": (("input_bitdepth", 10), ("gop", "8")),
    "main10_smp": (("input_bitdepth", 10), ("smp", "1")),
    "main10_vaq": (("input_bitdepth", 10), ("vaq", "4")),
    "lossless": (("lossless", "1"),),
    "lossless_sao": (("lossless", "1"), ("sao_type", "full"),
                     ("rdoq", "1"), ("signhide", "1")),
    "scaling_default": (("scaling-list", "default"),),
    "cqmfile": (("scaling-list", "custom"), ("cqmfile", CQM)),
    "scaling_gop8": (("scaling-list", "default"), ("gop", "8")),
    "trskip": (("transform-skip", "1"),),
    "trskip_tiles": (("transform-skip", "1"), ("tiles", "2x1")),
    "fct": (("fast-coeff-table", FCT),),
    "crypto_on": (("crypto", "on"),),
    "crypto_key": (("crypto", "on"), ("key", KEY)),
    "crypto_intra_features": (("crypto", "intra_pred_modes+trans_coeffs"),
                              ("key", KEY)),
    "crypto_bad_feature": (("crypto", "intra_modes"),),
    "crypto_short_key": (("crypto", "on"), ("key", "1,2,3")),
    "crypto_bad_key": (("crypto", "on"), ("key", "x" * 16)),
    "crypto_tiles": (("crypto", "on"), ("tiles", "2x1")),
    "field_tff": (("source-scan-type", "tff"),),
    "field_bff": (("source-scan-type", "bff"),),
    "field_gop8": (("source-scan-type", "tff"), ("gop", "8")),
    "field_lp": (("source-scan-type", "bff"), ("gop", "lp-g4d3t1")),
    "field_tiles": (("source-scan-type", "tff"), ("tiles", "2x1")),
    "tiles": (("tiles", "2x1"),),
    "tiles_p1": (("tiles", "2x1"), ("period", "1")),
    "tiles_wpp": (("tiles", "2x1"), ("wpp", "1")),
    "slices_tiles": (("tiles", "2x1"), ("slices", "tiles")),
    "tiles_vaq": (("tiles", "2x1"), ("vaq", "4")),
    "tiles_bitrate": (("tiles", "2x1"), ("bitrate", "500000")),
    "tiles_gop8": (("tiles", "2x1"), ("gop", "8")),
    "tiles_smp": (("tiles", "2x1"), ("smp", "1")),
    "tiles_lossless": (("tiles", "2x1"), ("lossless", "1")),
    "tiles_main10": (("tiles", "2x1"), ("input_bitdepth", 10)),
    "tiles_scaling": (("tiles", "2x1"), ("scaling-list", "default")),
    "tiles_sao_rdoq": (("tiles", "2x1"), ("sao_type", "full"),
                       ("rdoq", "1"), ("signhide", "1")),
}
# CTB 16 (the grid pipelines) and CTB 32 (the host route): alone and with
# the options the reference routes or refuses off CTB 64
CTB_ROWS = {
    "": (),
    "_gop8": (("gop", "8"),),
    "_lp": (("gop", "lp-g4d3t1"),),
    "_smp": (("smp", "1"),),
    "_main10": (("input_bitdepth", 10),),
    "_trskip": (("transform-skip", "1"),),
    "_vaq": (("vaq", "4"),),
    "_roi": (("roi", "<roi>"),),
    "_lossless": (("lossless", "1"),),
    "_lossless_p1": (("lossless", "1"), ("period", "1")),
    "_scaling": (("scaling-list", "default"),),
    "_scaling_p1": (("scaling-list", "default"), ("period", "1")),
    "_tiles": (("tiles", "2x1"),),
    "_crypto_on": (("crypto", "on"),),
    "_crypto_intra": (("crypto", "intra_pred_modes"),),
    "_sao": (("sao_type", "full"),),
    "_oba": (("bitrate", "500000"), ("rc-algorithm", "oba")),
    "_slices_wpp": (("wpp", "1"), ("slices", "wpp")),
    "_p1": (("period", "1"),),
}
for _ctb in (16, 32):
    for _sfx, _opts in CTB_ROWS.items():
        OPTION_SETS[f"ctu{_ctb}{_sfx}"] = (("ctu_size", _ctb),) + _opts


def _build(cfg_mod, api_mod, opts, roi, **kw):
    """Build an encoder of one package with the option set: returns its
    parameter sets, or the exception its constructor raised."""
    cfg = cfg_mod.Config(width=128, height=64)
    for name, value in opts:
        if name in cfg._OPTION_MAP:
            cfg.parse(name, roi if value == "<roi>" else value)
        else:
            setattr(cfg, name, value)
    try:
        enc = api_mod.Encoder(cfg, **kw)
    except Exception as e:      # compared with the other package's
        return e
    return enc.headers()


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_option_matrix_matches_reference(name, tmp_path):
    """The port accepts and refuses what the JAX package accepts and
    refuses (--gop lp-g4d3t1 -p 1 among the refused), and writes its
    parameter sets where both accept."""
    import kvazaar_tpu.api as ref_api
    import kvazaar_tpu.cfg as ref_cfg
    import kvazaar_tpu_torch.api as api
    import kvazaar_tpu_torch.cfg as cfg
    roi = tmp_path / "roi.txt"
    roi.write_text("2 1\n-3 4\n")
    want = _build(ref_cfg, ref_api, OPTION_SETS[name], str(roi))
    got = _build(cfg, api, OPTION_SETS[name], str(roi), device="cpu")
    if isinstance(want, Exception):
        assert type(got) is type(want), f"port: {got!r}, reference: {want!r}"
    else:
        assert not isinstance(got, Exception), repr(got)
        assert got == want


TOOLS = {"sao": dict(sao_type="full"), "rdoq": dict(rdoq_enable=True),
         "signhide": dict(signhide_enable=True),
         "ref2": dict(ref_frames=2),
         "lp_gop": dict(gop_len=4, gop_lowdelay=True, gop_lp=(3, 1),
                        ref_frames=2),
         "no_bipred": dict(bipred=False),
         "smp": dict(smp_enable=True), "amp": dict(amp_enable=True),
         "lp_no_bipred": dict(gop_len=4, gop_lowdelay=True, bipred=False),
         "gop8": dict(gop_len=8), "gop4_pyramid": dict(gop_len=4),
         "open_gop": dict(gop_len=8, open_gop=True),
         "nxn": dict(pu_depth_intra=(1, 4)),
         "intra64": dict(pu_depth_intra=(0, 3)), "rd2": dict(rd=2),
         "subme2": dict(subme=2), "pu_depth_inter_1_2":
         dict(pu_depth_inter=(1, 2)),
         "trskip": dict(trskip_enable=True, pu_depth_intra=(1, 4)),
         "fct": dict(fast_coeff_table=FCT),
         "main10": dict(input_bitdepth=10),
         "scaling": dict(scaling_list="default"),
         "cqmfile": dict(cqmfile=CQM),
         "lossless": dict(lossless=True)}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_options_encode_and_decode(name):
    """Each option of the tool row, two references a list, the low-delay
    GOP, the P program (--no-bipred), SMP/AMP, the B pyramid (closed
    and open GOP), NxN and 64 intra leaves, the rd ladder, --subme, an
    inter depth range, transform skip, --fast-coeff-table, 10-bit,
    scaling lists (default and --cqmfile) and lossless build on cuda
    unless the CPU is asked for, and encode IDR + B (P with --no-bipred,
    and in a pyramid, whose one-frame tail is a P anchor; --smp/--amp
    change only the SPS under bi-prediction; two intra frames with
    10-bit, scaling lists and lossless) at 128x64 on the CPU (both
    pipelines), hash-exact in the port's decoder."""
    from kvazaar_tpu_torch.api import Encoder, encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    cfg = Config(width=128, height=64, qp=27, **TOOLS[name])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Encoder(cfg)
    rng = np.random.RandomState(3)
    top, dt = 1 << cfg.input_bitdepth, (np.uint8 if cfg.input_bitdepth == 8
                                        else np.uint16)
    frames = [(rng.randint(0, top, (64, 128)).astype(dt),
               rng.randint(0, top, (32, 64)).astype(dt),
               rng.randint(0, top, (32, 64)).astype(dt))]
    frames.append(tuple(np.roll(p, 2, axis=1) for p in frames[0]))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stream, infos = encode_sequence(cfg, frames, device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    pyramid = cfg.gop_len > 1 and not cfg.gop_lowdelay
    intra = (cfg.input_bitdepth != 8 or cfg.lossless
             or cfg.scaling_list != "off")
    assert [i["slice_type"] for i in infos] == [
        2, 2 if intra else 0 if cfg.bipred and not pyramid else 1]
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 2 and all(p.hash_ok for p in pics)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_encode_and_decode(preset):
    """Each of the ten --preset rows encodes 3 frames of moving content at
    64x64 on the CPU through encode_sequence (an IDR, then the GOP's
    span), hash-exact in the port's decoder."""
    from kvazaar_tpu_torch.api import encode_sequence
    from kvazaar_tpu_torch.cfg import Config, apply_preset
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    cfg = apply_preset(Config(width=64, height=64), preset)
    rng = np.random.RandomState(4)
    base = [rng.randint(0, 256, s).astype(np.uint8)
            for s in ((64, 64), (32, 32), (32, 32))]
    frames = [tuple(np.roll(p, i, axis=1) for p in base) for i in range(3)]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stream, infos = encode_sequence(cfg, frames, device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    assert len(infos) == 3 and infos[0]["slice_type"] == 2
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == 3 and all(p.hash_ok for p in pics)


@pytest.mark.parametrize("opts", [{}, dict(smp_enable=True),
                                  dict(amp_enable=True),
                                  dict(amp_enable=True, bipred=False)],
                         ids=["default", "smp", "amp", "amp_no_bipred"])
def test_sps_equals_reference(opts):
    """build_sps writes the JAX package's SPS, amp_enabled_flag included
    (set by --amp under bi-prediction too)."""
    from kvazaar_tpu.api import build_sps as ref_build_sps
    from kvazaar_tpu.hevc.headers import write_sps as ref_write_sps
    from kvazaar_tpu_torch.api import build_sps
    from kvazaar_tpu_torch.cfg import Config
    from kvazaar_tpu_torch.hevc.headers import write_sps
    cfg = Config(width=128, height=64, **opts)
    sps = build_sps(cfg)
    assert sps.amp_enabled == int(cfg.amp_enable)
    assert write_sps(sps) == ref_write_sps(ref_build_sps(cfg))


def test_cli_encodes_on_cpu(tmp_path):
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    rng = np.random.RandomState(2)
    yuv = tmp_path / "in.yuv"
    out = tmp_path / "out.hevc"
    frames = [rng.randint(0, 256, 64 * 64 * 3 // 2).astype(np.uint8)
              for _ in range(2)]
    yuv.write_bytes(b"".join(f.tobytes() for f in frames))
    r = subprocess.run([sys.executable, "-m", "kvazaar_tpu_torch", "-i",
                        str(yuv), "--input-res", "64x64", "-o", str(out),
                        "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pics = HEVCDecoder().decode(out.read_bytes())
    assert len(pics) == 2 and all(p.hash_ok for p in pics)


def test_cli_forces_ctb64_for_quadtree_tools(tmp_path):
    """As the JAX CLI does (kvazaar_tpu/__main__.py:167-169), --vaq (like
    --tiles, --roi, --lossless, 10-bit input and scaling lists) codes at
    CTB 64 whatever --ctu says: --ctu 16 --vaq 4 gives --vaq 4's
    stream."""
    rng = np.random.RandomState(5)
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(rng.randint(0, 256, 64 * 64 * 3 // 2).astype(
        np.uint8).tobytes())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    streams = []
    for extra in ([], ["--ctu", "16"]):
        out = tmp_path / f"out{len(extra)}.hevc"
        r = subprocess.run([sys.executable, "-m", "kvazaar_tpu_torch", "-i",
                            str(yuv), "--input-res", "64x64", "-o", str(out),
                            "--vaq", "4", "--device", "cpu"] + extra,
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        streams.append(out.read_bytes())
    assert streams[0] == streams[1]
