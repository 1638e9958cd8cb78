"""The kernels' operation and byte counts (rooflines/) equal the ones
chip_smoke.py's kernel table is held to, at 1080p shapes, and follow a
call's arguments."""
import importlib.util
import os

import pytest
import torch

from portbench.spec import ROOT
from portbench.rooflines import me_eval, me_refine


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py, read as a fixture (the harness never imports it)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_rooflines", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HP, WP = 1088, 1920


@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("K", [1, 4, 9])
def test_me_refine_counts(smoke, n, K):
    L = (HP // n) * (WP // n)
    for hp, wp in ((HP, WP), (HP + 2 * 64, WP + 2 * 64)):
        assert me_refine.work_from_shapes(n, L, K, hp, wp) == \
            smoke.refine_work(n, L, K, hp, wp)


@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("lists", [1, 2])
def test_me_eval_counts(smoke, n, lists):
    L = (HP // n) * (WP // n)
    for K, want_satd, want_pred in ((1, True, False), (4, True, False),
                                    (5, True, False), (1, False, True)):
        for planes in (1, 2, 4):
            assert me_eval.work_from_shapes(
                n, L, K, HP, WP, planes, want_satd, want_pred, lists) == \
                smoke.eval_work(n, L, K, HP, WP, planes, want_satd,
                                want_pred, lists)


def test_counts_from_a_call(smoke):
    n, cols, rows, K = 16, 6, 4, 3
    L = cols * rows
    ref = torch.zeros((rows * n + 16, cols * n + 16), dtype=torch.int32)
    blocks = torch.zeros((L, n, n), dtype=torch.int32)
    cands = torch.zeros((L, K, 2), dtype=torch.int32)
    got = me_refine.work((ref, blocks, cands, torch.zeros(1)),
                         {"n": n, "cols": cols})()
    assert got == smoke.refine_work(n, L, K, *ref.shape)
    stack = torch.zeros((2,) + tuple(ref.shape), dtype=torch.int32)
    mv = torch.zeros((L, K, 2), dtype=torch.int32)
    r0 = torch.zeros((L, K), dtype=torch.int32)
    r1 = torch.ones((L, K), dtype=torch.int32)
    kw = {"n": n, "cols": cols, "want_satd": True, "want_pred": False}
    args = (stack, stack, blocks, mv, mv, r0, r1)
    assert me_eval.work(args, kw)() == smoke.eval_work(
        n, L, K, *ref.shape, smoke.eval_pictures(args), True, False, 2)
    one = (stack, None, blocks, mv, None, r0, None)
    assert me_eval.work(one, kw)() == smoke.eval_work(
        n, L, K, *ref.shape, smoke.eval_pictures(one), True, False, 1)
