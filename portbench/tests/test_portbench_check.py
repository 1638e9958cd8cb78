"""The check's pieces: the decode chains, the QPs the configurations
state, the parameter sets, and a planted difference."""
import numpy as np

from portbench import check


def test_chains_start_at_each_frames_idr():
    idr = [True, False, False, True, False]
    assert check.chains(idr, [2]) == [[0, 1, 2]]
    assert check.chains(idr, [1, 4, 2]) == [[0, 1, 2], [3, 4]]
    assert check.chains([True] * 4, [1, 3]) == [[1], [3]]


def test_expected_qp_follows_the_lp_gop():
    q = {"intra": 26, "inter_cycle": [30, 29, 30, 28]}
    assert [check.expected_qp(q, k) for k in range(7)] == \
        [26, 30, 29, 30, 28, 30, 29]


def test_parameter_sets_end_at_the_first_slice():
    vps = b"\x00\x00\x00\x01" + bytes([32 << 1, 1]) + b"\xaa"
    sps = b"\x00\x00\x01" + bytes([33 << 1, 1]) + b"\xbb"
    sl = b"\x00\x00\x01" + bytes([19 << 1, 1]) + b"\xcc"
    assert check.parameter_sets(vps + sps + sl) == vps + sps


def test_psnr_padded_matches_the_encoders_definition():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (120, 64)).astype(np.uint8)
    full = np.pad(src, ((0, 8), (0, 0)), mode="edge").astype(np.uint16)
    assert check.psnr_padded(full, src) == 99.0
    full[3, 5] ^= 1
    sse = 1
    want = 10.0 * np.log10(255.0 ** 2 * (128 * 64) / np.int64(sse))
    assert check.psnr_padded(full, src) == want
