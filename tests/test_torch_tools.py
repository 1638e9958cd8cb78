"""The tool row on the CPU: kvazaar_tpu_torch.api encodes the
tools/torch_goldens.py TOOL_CONFIGS at 128x64 (QP 27; all-intra with
SAO full + RDOQ, bench.py's scenario 1 tool row, and IDR + 2 B with SAO
full + RDOQ + sign hiding). Each stream must be byte-identical to the JAX
package's (tests/data/torch_golden_tools.npz, and live in `slow` twins),
with equal decision maps and SAO parameters per frame, and decode with
every frame hash-exact and equal to the encoder's reconstruction, which
SAO filtered and the B frames referenced; the Python slice writers,
the fallback where the native library cannot be built, give the same
streams."""
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.torch_goldens import (H, MAP_KEYS, OUT_TOOLS as GOLDEN,  # noqa
                                 SAO_KEYS, TOOL_CONFIGS, W, jax_stream,
                                 slice_frames)
from kvazaar_tpu_torch.api import Encoder  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402

_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_run(name: str):
    """(stream, per-frame maps, infos, encoder) of the port on the CPU,
    once per configuration."""
    if name not in _RUNS:
        cfg, n = TOOL_CONFIGS[name]
        enc = Encoder(Config(width=W, height=H, **cfg), device="cpu")
        stream, decs, infos = b"", [], []
        for f in slice_frames(n):
            chunk, info = enc.encode_frame(*f)
            stream += chunk
            infos.append(info)
            decs.append({k: np.asarray(v) for k, v in
                         enc._last_decisions.items() if k in MAP_KEYS})
        _RUNS[name] = (stream, decs, infos, enc)
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(TOOL_CONFIGS))
def test_tools_stream_byte_identical_to_reference(name):
    stream, decs, infos, enc = _port_run(name)
    g = np.load(GOLDEN)
    for i, d in enumerate(decs):
        assert set(SAO_KEYS) <= set(d), f"frame {i} lacks SAO maps"
        for k in MAP_KEYS:
            if f"{name}_f{i}_{k}" in g.files:
                np.testing.assert_array_equal(
                    d[k], g[f"{name}_f{i}_{k}"], err_msg=f"frame {i} {k}")
    assert stream == g[f"{name}_stream"].tobytes()
    assert enc.native_slices == len(infos)


@pytest.mark.parametrize("decoder", ["kvazaar_tpu", "kvazaar_tpu_torch"])
@pytest.mark.parametrize("name", sorted(TOOL_CONFIGS))
def test_tools_stream_decodes_hash_exact(name, decoder):
    HEVCDecoder = importlib.import_module(
        decoder + ".decoder.decoder").HEVCDecoder
    stream, decs, infos, _ = _port_run(name)
    pics = HEVCDecoder().decode(stream)
    assert len(pics) == len(infos)
    assert all(p.hash_ok for p in pics)
    for p, info in zip(pics, infos):
        for got, want in zip(p.planes, info["recon_out"]):
            np.testing.assert_array_equal(got, want)
    # SAO changed some CTB of some frame (the filtered planes are what the
    # decoder and the next B frame read)
    assert any((d["sao_y_typ"] != 0).any() or (d["sao_c_typ"] != 0).any()
               for d in decs)


@pytest.mark.parametrize("name", sorted(TOOL_CONFIGS))
def test_tools_python_writers_match_native(name, monkeypatch):
    """Where the native library is unavailable the Python slice writers
    (with the SAO syntax writer) code the same decisions to the same
    stream."""
    from kvazaar_tpu_torch import native
    monkeypatch.setattr(native, "available", lambda: False)
    cfg, n = TOOL_CONFIGS[name]
    enc = Encoder(Config(width=W, height=H, **cfg), device="cpu")
    stream = b"".join(enc.encode_frame(*f)[0] for f in slice_frames(n))
    assert enc.native_slices == 0
    assert stream == np.load(GOLDEN)[f"{name}_stream"].tobytes()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(TOOL_CONFIGS))
def test_tools_stream_matches_jax_live(name):
    stream, decs, _, _ = _port_run(name)
    cfg, n = TOOL_CONFIGS[name]
    want, wdecs = jax_stream(slice_frames(n), **cfg)
    for d, w in zip(decs, wdecs):
        for k in w:
            np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert stream == want
