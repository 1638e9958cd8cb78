"""Run one cell of BENCHMARK.json once.

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Builds the cell's configuration and traffic (portbench/configs/,
portbench/traffic/), makes the frames from --seed, warms up, codes frames
through kvazaar_tpu_torch.api.encode_sequence for --seconds (ending on a
whole unit), then, with the program's device state freed, has the plain
reference judge the output (check.py). With --trace 0 it reports the
cell's end-to-end metrics; with --trace 1 it wraps spans around the
program's layers from outside and profiles a stretch after the window,
and reports the per-layer metrics. The last line of standard output is
one JSON object: correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the numbers compared with their limits
(also the last lines of standard error).

It exits with another code than 0 and prints no result when there is no
CUDA device or fewer than the cell asks for, or when jax, jaxlib, flax or
kvazaar_tpu (top-level module names, compared whole) are loaded once the
window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

_T_IMPORT = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "kvazaar_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port builds its kernels into kvazaar_tpu_torch/_build/ itself)."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def make_config(conf: dict, width: int, height: int, traffic: dict):
    """The program's Config: the preset first, then the options, as
    kvazaar's command line reads them; the traffic's frame_batch."""
    from kvazaar_tpu_torch.cfg import Config, apply_preset
    cfg = Config(width=width, height=height)
    if conf.get("preset"):
        apply_preset(cfg, conf["preset"])
    for k, v in conf.get("options", {}).items():
        cfg.parse(k, v)
    if "frame_batch" in traffic:
        cfg.frame_batch = int(traffic["frame_batch"])
    return cfg


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)

    def spans(self, name: str) -> list:
        return [s for s in self.span_list if s.name == name]


def _install_spans(tracer, enc, spans: dict) -> None:
    pipe = enc._pipeline
    targets = {"encoder": enc, "pipeline": pipe}
    for name, (target, attr) in sorted(spans.items()):
        obj = targets[target]
        if not hasattr(obj, attr):
            continue
        tracer.wrap_span(name, obj, attr,
                         pics_of=lambda: getattr(pipe, "n_pics", 1))


def _stretch(feed, tracer, cell, readers):
    """Profile the traffic's fixed stretch of steady work after the
    window: wave steps of one more batch, or whole frames."""
    from .trace import StretchDone
    for r in readers.values():
        for kernel in getattr(r, "KERNELS", ()):
            rl = cell.roofline(kernel)
            tracer.wrap_launches(kernel, *rl.WRAP, rl.work)
    prof = cell.traffic["profile"]
    pipe = feed.enc._pipeline

    def run(start, stop):
        if "wave_steps" in prof:
            ready = pipe._class_ready
            n_sizes = len(pipe.SIZES)
            first = int(prof["skip_wave_steps"]) * n_sizes
            last = first + int(prof["wave_steps"]) * n_sizes
            calls = [0]

            def counted(*a, **kw):
                if calls[0] == first:
                    start()
                if calls[0] == last:
                    stop()
                    raise StretchDone
                calls[0] += 1
                return ready(*a, **kw)
            pipe._class_ready = counted
            try:
                feed.extra_unit()
            finally:
                del pipe._class_ready
            # the unit's wavefront ended inside the stretch
            if first < calls[0] < last:
                stop()
            elif calls[0] <= first:
                raise RuntimeError(
                    f"the profiled unit ran {calls[0] // n_sizes} wave "
                    f"steps, fewer than the {prof['skip_wave_steps']} that "
                    "the stretch skips")
        else:
            start()
            for _ in range(int(prof["frames"])):
                feed.extra_unit()
            stop()
    try:
        return tracer.profile(run)
    finally:
        tracer.unwrap()


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", size=None, fault: str | None = None,
             t_start: float | None = None, log=None) -> dict:
    """One run of `cell` (a spec.Cell). size (width, height) replaces the
    configuration's (CPU rehearsals); fault plants one of faults.py's
    faults in the program (the control and the fault tests). Returns the
    result dict that main prints."""
    import numpy as np
    import torch
    from kvazaar_tpu_torch.api import Encoder
    from . import check as chk
    from .feeds import FEEDS
    from .trace import Tracer
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    conf, traffic = cell.config, cell.traffic
    w, h = size or (conf["width"], conf["height"])
    cfg = make_config(conf, w, h, traffic)
    source = cell.generator().make_source(seed, w, h, traffic["content"])
    enc = Encoder(cfg, device=device)
    if fault:
        from .faults import install
        install(fault, enc)
    feed = FEEDS[traffic["feed"]](torch, cfg, enc, source, traffic, seconds)
    readers = {m["name"]: cell.reader(m["name"])
               for m in cell.metrics(trace)}
    tracer = None
    if trace:
        tracer = Tracer(torch)
        spans = {}
        for r in readers.values():
            spans.update(getattr(r, "SPANS", {}))
        feed.on_window_start = lambda: _install_spans(tracer, enc, spans)
        feed.on_window_end = tracer.unwrap
    feed.warmup()
    feed.window()
    setup_s = feed.t0 - t_start
    coded, n_fed = feed.coded, feed.n_fed
    span_list = list(tracer.spans) if tracer else []
    stretch = _stretch(feed, tracer, cell, readers) if trace else None
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    win = feed.window_frames
    units = [b - a for a, b in zip([feed.t0] + feed.unit_ends[:-1],
                                   feed.unit_ends)]
    log(f"portbench: {cell.name} seed {seed} on {kind}: {w}x{h}, set-up "
        f"{setup_s:.4f} s, window {feed.t_end - feed.t0:.4f} s with "
        f"{len(win)} frames in {len(units)} units (unit s: "
        f"{[round(u, 4) for u in units]}); making a frame "
        f"{1e3 * statistics.median(feed.made_s):.2f} ms (median)")
    run = Run(setup_s=setup_s, window_s=feed.t_end - feed.t0,
              window_frames=win, units=units, coded=coded,
              quality=feed.quality, span_list=span_list, stretch=stretch,
              yielded=dict(getattr(feed, "yielded", {})),
              roofline=cell.roofline)
    # the program's device state is freed before the reference runs
    del enc, feed, tracer
    import gc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(seed), 0x5A3])
    rest = [k for k in win if k not in run.quality]
    extra = int(traffic.get("checked_extra", 0))
    sample = run.quality + sorted(rng.choice(
        rest, min(extra, len(rest)), replace=False).tolist())
    need = set(sample)
    for ch in chk.chains([c["info"]["slice_type"] == 2 for c in coded],
                         sample):
        need.update(ch)
    run.sources = {k: source.make(k) for k in sorted(need)}
    metrics = {}
    for m in cell.metrics(trace):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    t = time.perf_counter()
    res = chk.run_check(coded, run.sources, sample, conf["slice_qp"], n_fed,
                        cell.limits, seed)
    units = ", ".join(f"{n} in {t} pictures ({b} not of least SATD)"
                      for t, (n, b) in res["units"].items() if n)
    log(f"portbench: reference decoded {res['decoded']} pictures and "
        f"checked the modes of {units or 'no'} intra units in "
        f"{time.perf_counter() - t:.1f} s{'; ' if res['errors'] else ''}"
        f"{'; '.join(res['errors'])}")
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    out = {"correct": bool(res["correct"]), "attempted": len(win),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
        out["breakdown"] = {"device_ops": stretch.ops[:10],
                            "idle_gaps": stretch.gaps[:10]}
    out["checks"] = {k: {"value": res["numbers"][k],
                         "limit": res["limits"][k]}
                     for k in chk.NUMBERS}
    return out


def device_line() -> str:
    """The card's name and power limit beside the published peaks."""
    import subprocess
    from .peaks import FP32_FLOP_S, HBM_BYTE_S
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi: not available"
    return (f"portbench: {smi}; published peaks {FP32_FLOP_S:.4g} FLOP/s "
            f"float32, {HBM_BYTE_S:.4g} B/s HBM (at 700 W)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() - process_age()
    from .spec import ROOT, Cell
    cell = Cell(args.workload)
    set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(device_line(), file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(f"check correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
