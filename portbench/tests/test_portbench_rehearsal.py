"""Each cell's loop end to end on the CPU at 192x128 with the port's
plain kernels: the last line's keys, the quality frames under two window
lengths, the content generator, and the faults that `correct` must
catch (the control among them)."""
import numpy as np
import pytest

from portbench.tests.rehearse import rehearse

CELLS = ["ai_ultrafast_1080p.batch8", "ldb_ultrafast_1080p.live"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_quality_frames(cell):
    """Two windows of different length code the same quality frames: bits
    and PSNR equal; the line has the contract's keys, the checks last."""
    from portbench.spec import Cell
    e2e = {m["name"] for m in Cell(cell).metrics(False)}
    assert {"fps", "psnr_y_db", "setup_s"} <= e2e
    short = rehearse(cell, 2 ** 31 + 77, 0.1, False)
    # long enough for more units than the quality frames need
    span = short["attempted"] / short["metrics"]["fps"]["value"]
    long = rehearse(cell, 2 ** 31 + 77, 1.6 * span, False)
    for out in (short, long):
        keys = list(out)
        assert keys[:5] == KEYS and keys[5] == "checks", keys
        assert out["correct"] is True and out["failed"] == 0
        assert set(out["metrics"]) == e2e
        for m in out["metrics"].values():
            assert m["value"] > 0 and m["unit"]
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(out["device"])
        assert all(set(v) == {"value", "limit"}
                   for v in out["checks"].values())
    assert long["attempted"] > short["attempted"]
    for k in e2e & {"kbit_per_frame", "kbit_per_b_frame", "psnr_y_db"}:
        assert short["metrics"][k]["value"] == long["metrics"][k]["value"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    out = rehearse(cell, 5, 0.1, True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    got = set(out["metrics"])
    want = {"entropy_ms_per_frame", "wavefront_ms_per_frame",
            "waves_per_frame"}
    if cell.endswith(".live"):
        want |= {"frame_ms_p90", "inter_search_ms_per_frame"}
    # no device trace on the CPU: the kernel rooflines and the idle share
    # find nothing to read and are left out
    assert got == want, got


def test_pan_objects_is_a_function_of_seed_and_index():
    from portbench.traffic.pan_objects import PanObjects
    kw = dict(canvas=512)
    a = PanObjects(2 ** 31 + 5, 192, 128, **kw)
    b = PanObjects(2 ** 31 + 5, 192, 128, **kw)
    fa = [a.make(i) for i in (0, 7, 3)]
    fb = [b.make(i) for i in (3, 7, 0)][::-1]
    for x, y in zip(fa, fb):
        assert all(np.array_equal(p, q) for p, q in zip(x, y))
    c = PanObjects(2 ** 31 + 6, 192, 128, **kw).make(7)
    assert not np.array_equal(c[0], fa[1][0])
    assert [p.shape for p in a.make(0)] == [(128, 192), (64, 96), (64, 96)]
    # the pan (3, 1) moves the background: frame 11 matches frame 10
    # shifted far better than unshifted (without the objects, which cover
    # most of so small a frame)
    bg = PanObjects(2 ** 31 + 5, 192, 128, n_objects=0, **kw)
    y0, y1 = bg.make(10)[0], bg.make(11)[0]
    shifted = np.abs(y1[:-1, :-3].astype(int) - y0[1:, 3:]).mean()
    assert shifted < 0.5 * np.abs(y1.astype(int) - y0).mean()


@pytest.mark.parametrize("cell,fault", [
    ("ai_ultrafast_1080p.batch8", "control"),
    ("ai_ultrafast_1080p.batch8", "deblock_off"),
    ("ai_ultrafast_1080p.batch8", "stale"),
    ("ai_ultrafast_1080p.batch8", "half"),
    ("ai_ultrafast_1080p.batch8", "alter"),
    ("ldb_ultrafast_1080p.live", "control"),
    ("ldb_ultrafast_1080p.live", "deblock_off"),
    ("ldb_ultrafast_1080p.live", "stale"),
    ("ldb_ultrafast_1080p.live", "alter"),
])
def test_faults_come_out_not_correct(cell, fault):
    """The rest of a run, with the timed path broken underneath: the
    control (the search's SATDs rounded to bfloat16), the configured
    deblocking left out of the reconstruction, a step returning its state
    unchanged, half of a batch left out, an answer altered where it is
    produced. The exchange between chips does not exist on one chip."""
    out = rehearse(cell, 31, 0.1, False, fault=fault)
    assert out["correct"] is False
    assert out["failed"] > 0
    over = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    assert over
    if fault == "control":
        # a conformant stream: only the search's decisions give it away
        assert over == ["mode_not_best"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, cuda):
    """The same small rehearsal on the card, traced: the device trace
    gives the busy share, and the run is correct."""
    out = rehearse(cell, 41, 0.1, True, device="cuda")
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    assert "device_idle_pct" in out["metrics"]
