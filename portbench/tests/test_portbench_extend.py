"""A configuration, a traffic mix, a per-layer metric and a kernel
roofline are added as new files, with new entries in a copy of
BENCHMARK.json, and run: no existing file is edited."""
import hashlib
import json
import os
import shutil

from portbench.spec import HERE, ROOT
from portbench.tests.rehearse import rehearse

DATA = ("configs", "traffic", "metrics", "rooflines", "limits")


def _digest(root):
    h = {}
    for d in DATA:
        for dp, _, files in os.walk(os.path.join(root, "portbench", d)):
            for f in files:
                if f.endswith((".py", ".json")):
                    p = os.path.join(dp, f)
                    with open(p, "rb") as fh:
                        h[os.path.relpath(p, root)] = hashlib.sha256(
                            fh.read()).hexdigest()
    return h


def test_new_files_add_a_cell(tmp_path):
    root = str(tmp_path)
    for d in DATA:
        shutil.copytree(os.path.join(HERE, d),
                        os.path.join(root, "portbench", d))
    before = _digest(root)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(root, "portbench")
    conf = json.load(open(os.path.join(pb, "configs",
                                       "ai_ultrafast_1080p.json")))
    conf.update(name="ai_ultrafast_small", width=192, height=128,
                options={"period": 1, "qp": 32},
                slice_qp={"intra": 32, "inter_cycle": [32]})
    json.dump(conf, open(os.path.join(pb, "configs",
                                      "ai_ultrafast_small.json"), "w"))
    traffic = json.load(open(os.path.join(pb, "traffic", "batch8.json")))
    traffic.update(frame_batch=2, warmup_frames=2, quality_frames=2,
                   checked_extra=2,
                   profile={"skip_wave_steps": 2, "wave_steps": 4})
    traffic["content"]["canvas"] = 256
    json.dump(traffic, open(os.path.join(pb, "traffic", "batch2.json"), "w"))
    with open(os.path.join(pb, "metrics", "frames_in_window.py"), "w") as f:
        f.write('"""frames_in_window: frames the window coded."""\n\n\n'
                "def read(run):\n    return len(run.window_frames)\n")
    # a roofline of a kernel, and its reader, which finds no device trace
    # on the CPU and is left out
    with open(os.path.join(pb, "rooflines", "me_refine_copy.py"), "w") as f:
        f.write(open(os.path.join(HERE, "rooflines", "me_refine.py")).read())
    with open(os.path.join(pb, "metrics", "me_refine_copy_roofline.py"),
              "w") as f:
        f.write("from portbench.metrics._roofline import share\n\n"
                "KERNELS = ('me_refine_copy',)\n\n\n"
                "def read(run):\n    return share(run, 'me_refine_copy')\n")
    name = "ai_ultrafast_small.batch2"
    json.dump({"missing": 0, "undecodable": 0, "hash_bad": 0,
               "recon_diff": 0, "qp_off": 0, "psnr_gap_db": 1e-3,
               "mode_not_best": 0},
              open(os.path.join(pb, "limits", name + ".json"), "w"))
    bench["configs"].append({"name": "ai_ultrafast_small", "source": "x",
                             "file": "portbench/configs/"
                                     "ai_ultrafast_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": name, "config": "ai_ultrafast_small",
                               "traffic": "batch2", "chips": 1, "why": "x"})
    bench["per_layer"] += [
        {"name": "frames_in_window", "unit": "frames", "better": "higher",
         "source": "host_clock", "layer": "API and entropy coding",
         "moves": "fps", "workloads": [name]},
        {"name": "me_refine_copy_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "Kernels", "moves": "fps",
         "workloads": [name]}]
    plain = rehearse(name, 3, 0.1, False, root=root, size=None, bench=bench)
    traced = rehearse(name, 3, 0.1, True, root=root, size=None, bench=bench)
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"fps", "psnr_y_db", "setup_s"}
    assert traced["metrics"]["frames_in_window"]["value"] == \
        traced["attempted"]
    assert "me_refine_copy_roofline" not in traced["metrics"]
    after = _digest(root)
    assert {k: after[k] for k in before} == before
