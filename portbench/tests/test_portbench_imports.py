"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: every portbench module's
AST, top-level module names compared whole; and sys.modules after a CPU
rehearsal of each cell, in a fresh process."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "kvazaar_tpu"}
PROGRAM = "kvazaar_tpu_torch"


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """(absolute module name, line) of every import statement anywhere in
    the file; relative imports resolved against the file's package."""
    rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
    pkg = rel[:-1] if rel[-1] != "__init__" else rel[:-1]
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                name = ".".join(base + ([node.module] if node.module
                                        else []))
            else:
                name = node.module
            yield name, node.lineno


def test_no_forbidden_imports():
    bad = []
    ref = os.path.join(HERE, "reference")
    for path in _modules():
        in_ref = path.startswith(ref + os.sep)
        for name, line in _imports(path):
            top = name.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path}:{line} imports {name}")
            if in_ref and (top == PROGRAM or not (
                    name.startswith("portbench.reference")
                    or top not in ("portbench", PROGRAM))):
                bad.append(f"{path}:{line} (reference) imports {name}")
    assert not bad, "\n".join(bad)


def test_reference_stays_inside_its_package():
    """Relative imports of the reference resolve inside it."""
    ref = os.path.join(HERE, "reference")
    for path in _modules():
        if not path.startswith(ref + os.sep):
            continue
        for name, line in _imports(path):
            if name.startswith("portbench"):
                assert name.startswith("portbench.reference"), (path, line,
                                                                name)


def test_top_level_names_compared_whole():
    """kvazaar_tpu_torch begins with kvazaar_tpu and is allowed."""
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN, forbidden_modules
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert PROGRAM not in forbidden_modules()
    sys.modules["kvazaar_tpu_torch_fake_probe"] = sys
    try:
        assert "kvazaar_tpu" not in forbidden_modules()
    finally:
        del sys.modules["kvazaar_tpu_torch_fake_probe"]


@pytest.mark.parametrize("cell", ["ai_ultrafast_1080p.batch8",
                                  "ldb_ultrafast_1080p.live"])
def test_no_forbidden_modules_after_a_rehearsal(cell):
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run(
        [sys.executable, "-m", "portbench.tests.rehearse", cell, "11",
         "0.1", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"] is True
