"""The two ways a traffic file feeds frames to the program's entry,
kvazaar_tpu_torch.api.encode_sequence, with one Encoder for the run.

- "batch": an offline queue; encode_sequence is called once per unit of
  `frame_batch` frames (Config.frame_batch), which the batched path lists
  before coding. A unit is one call.
- "stream": a live feed; encode_sequence gets one lazy iterable of the
  warm-up frames and then the window's, which stops yielding once the
  window's seconds have passed and its quality frames are in. A unit is
  one frame.

Both make frame i of the run from the generator as it is needed, so the
making is inside the window. The window starts with the first unit after
the warm-up and ends on a whole unit. Its quality frames, the first
`quality_frames` frames it codes, are the same frames on every run of a
seed, whatever the program's speed.
"""
from __future__ import annotations

import time


class Feed:
    def __init__(self, torch, cfg, enc, source, traffic: dict,
                 seconds: float) -> None:
        self.torch = torch
        self.cfg = cfg
        self.enc = enc
        self.source = source
        self.traffic = traffic
        self.seconds = seconds
        self.n_warm = int(traffic["warmup_frames"])
        self.n_quality = int(traffic["quality_frames"])
        self.coded: list[dict] = []      # per coded frame: chunk, info
        self.made_s: list[float] = []    # seconds making each frame
        self.t0 = self.t_end = None      # the window
        self.unit_ends: list[float] = []
        self.n_fed = 0
        self.on_window_start = None      # traced runs: install spans
        self.on_window_end = None

    def _sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def make(self, i: int) -> tuple:
        t = time.perf_counter()
        f = self.source.make(i)
        self.made_s.append(time.perf_counter() - t)
        self.n_fed += 1
        return f

    def _record(self, stream: bytes, infos: list) -> None:
        off = 0
        for info in infos:
            self.coded.append({"chunk": stream[off:off + info["bytes"]],
                               "info": info})
            off += info["bytes"]
        if off != len(stream):
            raise RuntimeError("the coded frames' sizes do not add up to "
                               "the stream's")

    @property
    def window_frames(self) -> list[int]:
        """Coded-frame indices of the window's frames."""
        return list(range(self.n_warm, len(self.coded)))

    @property
    def quality(self) -> list[int]:
        return list(range(self.n_warm, self.n_warm + self.n_quality))


class BatchFeed(Feed):
    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.unit = int(self.traffic["frame_batch"])
        if self.n_warm % self.unit or self.n_quality % self.unit:
            raise ValueError("warm-up and quality frames must be whole "
                             "batches")

    def _unit(self, start: int) -> None:
        from kvazaar_tpu_torch.api import encode_sequence
        frames = [self.make(i) for i in range(start, start + self.unit)]
        stream, infos = encode_sequence(self.cfg, frames, encoder=self.enc)
        self._sync()
        self._record(stream, infos)

    def warmup(self) -> None:
        for s in range(0, self.n_warm, self.unit):
            self._unit(s)

    def window(self) -> None:
        if self.on_window_start:
            self.on_window_start()
        self.t0 = time.perf_counter()
        i = self.n_warm
        while True:
            self._unit(i)
            i += self.unit
            now = time.perf_counter()
            self.unit_ends.append(now)
            if (now - self.t0 >= self.seconds
                    and i - self.n_warm >= self.n_quality):
                break
        self.t_end = self.unit_ends[-1]
        if self.on_window_end:
            self.on_window_end()

    def extra_unit(self) -> None:
        """One more unit after the window (the profiled stretch)."""
        self._unit(self.n_warm + len(self.window_frames))


class StreamFeed(Feed):
    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.yielded: dict[int, float] = {}   # frame -> yield time

    def _frames(self):
        for i in range(self.n_warm):
            yield self.make(i)
        if self.on_window_start:
            self.on_window_start()
        i = self.n_warm
        self.t0 = time.perf_counter()
        while True:
            f = self.make(i)
            t = time.perf_counter()
            self.yielded[i] = t
            if i > self.n_warm:
                self.unit_ends.append(t)
            yield f
            i += 1
            if (time.perf_counter() - self.t0 >= self.seconds
                    and i - self.n_warm >= self.n_quality):
                return

    def warmup(self) -> None:
        """Nothing apart: the warm-up frames open the one encode call,
        which window() makes; set-up ends at the window's first frame."""

    def window(self) -> None:
        from kvazaar_tpu_torch.api import encode_sequence
        stream, infos = encode_sequence(self.cfg, self._frames(),
                                        encoder=self.enc)
        self._sync()
        self.t_end = time.perf_counter()
        self.unit_ends.append(self.t_end)
        self._record(stream, infos)
        if self.on_window_end:
            self.on_window_end()

    def extra_unit(self) -> None:
        """One more frame after the window (the profiled stretch)."""
        from kvazaar_tpu_torch.api import encode_sequence
        i = self.n_warm + len(self.window_frames)
        encode_sequence(self.cfg, [self.make(i)], encoder=self.enc)
        self._sync()


FEEDS = {"batch": BatchFeed, "stream": StreamFeed}
