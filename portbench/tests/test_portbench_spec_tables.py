"""The reference's constant tables held to what ITU-T H.265 says of them,
and the reference's intra mode decision held to the program's search."""
import numpy as np
import pytest

from portbench.reference import tables as T
from portbench.reference.intra_search import (check_modes, intra_units,
                                              mode_satds, satd)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_scans_follow_their_definitions(log2):
    n = 1 << log2
    for idx in (T.SCAN_DIAG, T.SCAN_HOR, T.SCAN_VER):
        s = T.get_scan(idx, log2)
        assert sorted(map(tuple, s)) == [(x, y) for x in range(n)
                                         for y in range(n)]
        # coding order by 4x4 sub-block, the sub-blocks in the same scan
        sb = s // 4
        cg = T.get_cg_scan(idx, log2)
        order = {tuple(p): i for i, p in enumerate(cg)}
        ranks = [order[tuple(p)] for p in sb] if log2 > 2 else [0] * len(s)
        assert ranks == sorted(ranks)
        inner = s[:16] % 4
        if idx == T.SCAN_DIAG:
            # 6.5.3: anti-diagonals in turn, each from bottom-left upwards
            keys = [(x + y, -y) for x, y in inner]
            assert keys == sorted(keys)
        elif idx == T.SCAN_HOR:
            assert [(y, x) for x, y in inner] == sorted(
                (y, x) for x, y in inner)
        else:
            assert [tuple(p) for p in inner] == sorted(map(tuple, inner))


def test_transform_matrices_are_the_specs_cosines():
    for n, m in T.DCT_MATRICES.items():
        k = np.arange(n)
        ideal = 64 * np.sqrt(2) * np.cos(
            np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
        ideal[0] = 64
        assert np.abs(m - ideal).max() <= 2.5, n
        # near-orthogonal rows of norm 64 * sqrt(n) (8.6.4.2's design)
        gram = m.astype(np.int64) @ m.T
        norm = 64 * 64 * n
        assert np.abs(gram - np.diag(np.diag(gram))).max() < 0.01 * norm
        assert np.abs(np.diag(gram) - norm).max() < 0.01 * norm
    # the smaller transforms are rows of the 32-point one (8.6.4.2)
    assert np.array_equal(T.DCT_MATRICES[4], [[64, 64, 64, 64],
                                              [83, 36, -36, -83],
                                              [64, -64, -64, 64],
                                              [36, -83, 83, -36]])
    k = np.arange(4)
    dst7 = 128 * 2 / 3 * np.sin(np.pi * (2 * k[:, None] + 1)
                                * (k[None, :] + 1) / 9)
    assert np.abs(T.DST4 - dst7).max() < 1.5


def test_angles_and_cabac_tables():
    ang = T.INTRA_PRED_ANGLE
    # modes 10 and 26 are pure horizontal and vertical; mode 2 + k and
    # mode 34 - k take the same angle
    assert len(ang) == 33 and ang[8] == 0 and ang[24] == 0
    assert np.array_equal(ang, ang[::-1]) and ang[16] == -32
    for mode in range(11, 26):
        a = T.intra_pred_angle(mode)
        assert T.intra_inv_angle(mode) == round(256 * 32 / -a)
    # rangeTabLps falls with the state and rises with the range quarter
    lps = T.LPS_TABLE[:63]
    assert np.all(np.diff(lps, axis=0) <= 0)
    assert np.all(np.diff(lps, axis=1) > 0)
    assert np.all(T.TRANS_LPS[:63] <= np.arange(63))
    for i in range(32):
        r = max(8 * i, 6)
        assert (r << T.RENORM_TABLE[i]) >= 256 > (r << (T.RENORM_TABLE[i]
                                                        - 1))
    assert [T.chroma_qp(q) for q in (29, 30, 35, 43, 44, 51)] == \
        [29, 29, 33, 37, 38, 45]
    for name, rows in T.CONTEXT_INIT.items():
        assert len(rows) == 3 and len({len(r) for r in rows}) == 1, name
        assert all(0 <= v <= 255 for r in rows for v in r), name


def test_satd_is_the_hadamard_sum():
    rng = np.random.default_rng(3)
    d = rng.integers(-40, 40, (16, 16))
    h = np.array([[1]])
    while h.shape[0] < 8:
        h = np.block([[h, h], [h, -h]])
    want = sum((np.abs(h @ d[y:y + 8, x:x + 8] @ h).sum() + 2) >> 2
               for y in (0, 8) for x in (0, 8))
    assert satd(d) == want
    d4 = d[:4, :4]
    assert satd(d4) == (np.abs(h[:4, :4] @ d4 @ h[:4, :4]).sum() + 1) >> 1


def test_the_programs_search_picks_modes_of_least_satd():
    """The program's mode search (CPU) against the reference's decision
    rule, every block of every size of a 128x64 picture: the program's
    mode is the first of least SATD."""
    import torch
    from kvazaar_tpu_torch.models.intra_md import MdIntraPipeline
    from portbench.traffic.pan_objects import PanObjects
    y, cb, cr = PanObjects(2 ** 31 + 9, 128, 64, canvas=256,
                           spectrum_exponent=1.5, luma_std=14.0,
                           max_wavelength=64).make(3)
    pipe = MdIntraPipeline(64, 128, 27, pu_depth=(0, 4), device="cpu")
    t = [torch.from_numpy(a.astype(np.int32)) for a in (y, cb, cr)]
    src = y.astype(np.int32)
    runs = {n: pipe._leaf_rd(*t, n)[0] for n in (8, 16, 32)}
    runs[4] = pipe._leaf_rd4(*t)[0]
    runs[64] = pipe._leaf_rd64(*t)[0]
    for n, modes in runs.items():
        cols = 128 // n
        for b, m in enumerate(modes.tolist()):
            s = mode_satds(src, (b // cols) * n, (b % cols) * n, n)
            assert m == int(np.argmin(s)), (n, b, m, s)


def test_check_modes_counts_a_mode_not_of_least_satd():
    from portbench.traffic.pan_objects import PanObjects
    y = PanObjects(5, 64, 64, canvas=256).make(0)[0].astype(np.int32)
    pu = np.zeros((16, 16), np.int8)
    pu[:4, :4] = 4            # one 16x16 unit
    pu[4:6, :2] = 3           # one 8x8 unit
    assert intra_units(pu) == [(0, 0, 16), (16, 0, 8)]
    modes = np.zeros((16, 16), np.int8)
    best16 = int(np.argmin(mode_satds(y, 0, 0, 16)))
    s8 = mode_satds(y, 16, 0, 8)
    modes[:4, :4] = best16
    modes[4:6, :2] = int(np.argmin(s8))
    rng = np.random.default_rng(0)
    assert check_modes(y, pu, modes, rng, 10) == (0, 2)
    modes[4:6, :2] = int(np.argmax(s8))
    assert check_modes(y, pu, modes, rng, 10) == (1, 2)
    assert check_modes(y, pu, modes, rng, 1)[1] == 1


def test_deblocking_and_interpolation_tables_are_the_specs():
    """beta' and tC' of Table 8-12 (Q 0..51 and 0..53), and the luma and
    chroma interpolation filters of 8.5.3.3.3.1 and 8.5.3.3.3.2, typed
    here from the specification."""
    from portbench.reference.ops import deblock, mc
    beta = [0] * 16 + list(range(6, 19)) + list(range(20, 65, 2))
    tc = ([0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3
          + [5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24])
    assert deblock.BETA_TABLE.tolist() == beta
    assert deblock.TC_TABLE.tolist() == tc
    assert mc.LUMA_FILTERS.tolist()[1:] == [
        [-1, 4, -10, 58, 17, -5, 1, 0], [-1, 4, -11, 40, 40, -11, 4, -1],
        [0, 1, -5, 17, 58, -10, 4, -1]]
    assert mc.CHROMA_FILTERS.tolist()[1:] == [
        [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
        [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4],
        [-2, 10, 58, -2]]
    assert all(sum(f) == 64 for f in mc.LUMA_FILTERS.tolist()
               + mc.CHROMA_FILTERS.tolist())
