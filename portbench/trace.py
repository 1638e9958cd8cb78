"""Traced runs (--trace 1): spans around calls into the program's layers,
wrapped from outside the program, and one profiled stretch.

A span is the host clock around one call, with the device synchronized
before and after, so it holds the call's device work; it also opens a
torch.profiler annotation of its name. The profiled stretch is a fixed
amount of steady work after the window (wave steps or frames, as the
traffic file says), run under torch.profiler; from its trace come the
device's busy seconds, the time of each device operation by name, the
longest idle gaps labelled by what the host was doing, and the kernel
records that the roofline readers pair with the launches recorded during
the stretch.
"""
from __future__ import annotations

import importlib
import re
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    pics: int = 1          # pictures the call codes (a batch's call: B)
    frame: int | None = None   # the frame a finalize_frame call codes


@dataclass
class Stretch:
    """What the profiled stretch gave: busy_s and window_s, each device
    operation's total seconds by name, the idle gaps (label, seconds)
    longest first, and the kernel records (name, start_ns, dur_ns) in
    start order."""
    busy_s: float
    window_s: float
    ops: list
    gaps: list
    kernels: list
    launches: dict = field(default_factory=dict)


class Tracer:
    def __init__(self, torch) -> None:
        self.torch = torch
        self.spans: list[Span] = []
        self.launches: dict[str, list] = {}
        self.recording = False
        self._undo: list = []

    def _sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def wrap_span(self, name: str, obj, attr: str, pics_of=None) -> None:
        """Replace obj.attr (on the instance) by a wrapper that records a
        span of `name`; pics_of() gives the pictures the call codes."""
        from torch.profiler import record_function
        fn = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})

        def wrapper(*a, **kw):
            pics = pics_of() if pics_of is not None else 1
            frame = None
            if a and isinstance(a[0], dict) and "frame_num" in a[0]:
                frame = a[0]["frame_num"]
            self._sync()
            t = time.perf_counter()
            with record_function(name):
                r = fn(*a, **kw)
            self._sync()
            self.spans.append(Span(name, t, time.perf_counter(), pics,
                                   frame))
            return r
        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, had, fn))

    def wrap_launches(self, kernel: str, module: str, attr: str,
                      work) -> None:
        """Replace module.attr by a wrapper that, while the profiled
        stretch runs, keeps work(args, kwargs) of each call (a callable
        giving (bytes, operations) once the stretch has ended)."""
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)

        def wrapper(*a, **kw):
            if self.recording:
                self.launches.setdefault(kernel, []).append(work(a, kw))
            return fn(*a, **kw)
        setattr(mod, attr, wrapper)
        self._undo.append((mod, attr, True, fn))

    def unwrap(self) -> None:
        for obj, attr, had, fn in reversed(self._undo):
            if had:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def profile(self, run) -> Stretch:
        """Run run(start, stop), which calls start() and stop() around the
        stretch, under torch.profiler, and analyse the trace. run may end
        the unit it is in by raising StretchDone once it has stopped."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        state = {}

        def start():
            self._sync()
            prof.start()
            self.recording = True
            state["t0"] = time.perf_counter()

        def stop():
            self._sync()
            state["t1"] = time.perf_counter()
            self.recording = False
            prof.stop()
        try:
            run(start, stop)
        except StretchDone:
            pass
        if "t1" not in state:
            raise RuntimeError("the profiled stretch did not end")
        out = analyse(prof, state["t1"] - state["t0"])
        out.launches = {k: [w() for w in v]
                        for k, v in self.launches.items()}
        return out


class StretchDone(Exception):
    """Raised from inside the program's call once the profiled stretch
    has what it needs, to end the unit it is part of."""


# host events of the profiler's own bookkeeping, never a label of a gap
_PROFILER_HOST = ("Activity Buffer Request",)


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and signature: the
    function, and the first functor or kernel named in its template
    arguments (which tells the elementwise kernels apart). Other device
    operations (copies, sets) keep their names."""
    if not name.startswith("void "):
        return name
    n = name[5:]
    cut = min([i for i in (n.find("<"), n.find("(")) if i >= 0],
              default=len(n))
    base = n[:cut].split("::")[-1] or n[:cut]
    for m in re.finditer(r"\w*(?:Functor|functor|_kernel_cuda|_kernel_impl|"
                         r"_impl)\w*", n[cut:]):
        if not m.group(0).startswith(("gpu_kernel_impl", "gpu_index")):
            return f"{base}[{m.group(0)}]"
    return base


def _events(prof):
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = []
    out = []
    for e in evs:
        dev = str(e.device_type()).split(".")[-1]
        out.append((dev, e.name(), e.start_ns(), e.duration_ns(),
                    bool(e.is_user_annotation())))
    return out


def analyse(prof, window_s: float) -> Stretch:
    """busy_s: the union of the device operations' intervals; ops: seconds
    by operation name, most first; gaps: the idle stretches between them
    (and at the ends of the window) labelled by the innermost host
    operation open at the gap's start, under the innermost harness span
    open there; kernels: (name, start_ns, dur_ns) of every device
    operation."""
    evs = _events(prof)
    dev = sorted((s, d, n) for kind, n, s, d, _ in evs
                 if kind == "CUDA" and d > 0)
    host = [(s, s + d, n, ann) for kind, n, s, d, ann in evs
            if kind == "CPU" and n not in _PROFILER_HOST]
    by_name: dict[str, float] = {}
    for s, d, n in dev:
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + d * 1e-9
    busy_ns = 0
    gaps = []
    cur_s = cur_e = None
    for s, d, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    # the stretch's ends: its first and last host events
    if host and dev:
        h0 = min(h[0] for h in host)
        h1 = max(h[1] for h in host)
        if dev[0][0] > h0:
            gaps.append((h0, dev[0][0]))
        if h1 > cur_e:
            gaps.append((cur_e, h1))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for g0, g1 in gaps[:10]:
        inner = span = None
        for h0, h1, n, ann in host:
            if h0 <= g0 < h1:
                if ann:
                    if span is None or h1 - h0 < span[1] - span[0]:
                        span = (h0, h1, n)
                elif inner is None or h1 - h0 < inner[1] - inner[0]:
                    inner = (h0, h1, n)
        label = inner[2] if inner else "host (no operation open)"
        if span is not None:
            label = f"{span[2]} > {label}"
        labelled.append([label, (g1 - g0) * 1e-9])
    ops = sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])
    return Stretch(busy_ns * 1e-9, window_s, ops, labelled,
                   [(n, s, d) for s, d, n in dev])
