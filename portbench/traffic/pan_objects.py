"""Seeded synthetic video with motion that a motion search can follow.

Frame i of a run is a pure function of the seed and i:

- a periodic texture canvas, larger than the frame, with a 1/f**exponent
  amplitude spectrum (fixed magnitudes, no wavelengths above
  `max_wavelength`), one texture for every seed (`texture_seed`); the
  seed picks where the frame starts on it, and the frame pans `pan`
  pixels a frame from there (wrapping around the canvas);
- `n_objects` textured ellipses (patches of the canvas at seeded places,
  each with its own fixed contrast and brightness) of fixed sizes spread
  over `object_size`, each moving at its own fixed integer velocity of
  at most `object_speed` pixels a frame; the seed deals out their start
  cells on a fixed grid and their drawing order, so that they occlude
  one another and uncover the background as they move;
- camera noise of standard deviation `noise_sigma` levels, one plane of a
  bank made at set-up, chosen per frame from the seed and i;
- chroma from smoothed copies of the canvas.

Every seed gets the same texture statistics, object sizes, contrasts and
velocities in another arrangement, so the seed changes the content and
not the amount of work.
"""
from __future__ import annotations

import numpy as np


def _pink(rng, h: int, w: int, exponent: float,
          max_wavelength: float = 0.0) -> np.ndarray:
    """A periodic h x w float32 texture of zero mean and unit standard
    deviation whose amplitude spectrum is exactly 1 / f**exponent: the
    phases are those of white noise from rng, the magnitudes fixed, so
    every seed has the same energy at every frequency."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** -exponent
    amp[0, 0] = 0.0
    if max_wavelength:
        amp[f < 1.0 / max_wavelength] = 0.0
    spec = np.fft.rfft2(rng.standard_normal((h, w)))
    spec *= amp / np.maximum(np.abs(spec), 1e-12)
    tex = np.fft.irfft2(spec, s=(h, w))
    return (tex / tex.std()).astype(np.float32)


def _smooth(tex: np.ndarray, sigma: float) -> np.ndarray:
    """A Gaussian low-pass of a periodic texture (through the spectrum)."""
    h, w = tex.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    g = np.exp(-2 * (np.pi * sigma) ** 2 * (fy * fy + fx * fx))
    out = np.fft.irfft2(np.fft.rfft2(tex) * g, s=(h, w))
    return (out / max(out.std(), 1e-6)).astype(np.float32)


def _to_u8(a: np.ndarray, mean: float, std: float) -> np.ndarray:
    return np.clip(np.rint(a * std + mean), 0, 255).astype(np.uint8)


class PanObjects:
    """The frames of one run: make(i) -> (y, cb, cr) uint8 planes."""

    def __init__(self, seed: int, width: int, height: int, *,
                 canvas: int = 2048, spectrum_exponent: float = 1.0,
                 luma_mean: float = 128.0, luma_std: float = 40.0,
                 chroma_std: float = 12.0, chroma_smoothing: float = 4.0,
                 pan=(3, 1), n_objects: int = 8, object_size=(64, 256),
                 object_speed: int = 6, noise_sigma: float = 2.0,
                 noise_bank: int = 16, texture_seed: int = 20130101,
                 max_wavelength: float = 0.0) -> None:
        if width % 2 or height % 2:
            raise ValueError("4:2:0 frames need even dimensions")
        if canvas < max(width, height):
            raise ValueError("the canvas must be at least the frame size")
        self.seed = int(seed)
        self.w, self.h = width, height
        self.pan = (int(pan[0]), int(pan[1]))
        # one texture for every seed: a seed looks at another part of it
        base = _pink(np.random.default_rng(texture_seed), canvas, canvas,
                     spectrum_exponent, max_wavelength)
        rng = np.random.default_rng([self.seed, 0x9A0])
        self.origin = tuple(int(v) for v in rng.integers(0, canvas, 2))
        self.canvas = [_to_u8(base, luma_mean, luma_std)] + [
            _to_u8(_smooth(np.roll(base, (k * canvas // 3, k * canvas // 5),
                                   (0, 1)), chroma_smoothing),
                   128.0, chroma_std) for k in (1, 2)]
        # objects: fixed sizes, shapes, contrasts and velocities; the seed
        # deals out their drawing order (who occludes whom) and start
        # positions on a fixed grid
        lo, hi = object_size
        k = np.arange(n_objects)
        sizes = np.linspace(lo, hi, n_objects).round().astype(int)
        aspects = 0.6 + 0.4 * ((k * 3) % max(n_objects, 1)) / max(
            n_objects - 1, 1)
        gains = 0.8 + 0.4 * ((k * 5) % max(n_objects, 1)) / max(
            n_objects - 1, 1)
        shifts = -24.0 + 48.0 * ((k * 7) % max(n_objects, 1)) / max(
            n_objects - 1, 1)
        speeds = [(object_speed - (j * 5) % (2 * object_speed + 1),
                   ((j * 3) % (2 * object_speed + 1)) - object_speed)
                  for j in range(n_objects)]
        deal = [rng.permutation(n_objects) for _ in range(2)]
        self.objects = []
        for j in deal[0]:
            ow = int(sizes[j])
            oh = max(16, int(round(ow * aspects[j])))
            yy, xx = np.mgrid[:oh, :ow]
            mask = (((yy + 0.5 - oh / 2) / (oh / 2)) ** 2
                    + ((xx + 0.5 - ow / 2) / (ow / 2)) ** 2) <= 1.0
            # its texture: a patch of the canvas from elsewhere, so that
            # it has the background's statistics, with its own contrast
            # and brightness
            ty, tx = (int(v) for v in rng.integers(0, canvas, 2))
            rows = (ty + np.arange(oh)) % canvas
            cols = (tx + np.arange(ow)) % canvas
            patch = base.take(rows, 0).take(cols, 1)
            patch = patch - patch.mean()
            planes = [_to_u8(patch * gains[j], luma_mean + shifts[j],
                             luma_std)]
            for c, cs in zip(self.canvas[1:], (1, -1)):
                cp = c.take(rows[::2], 0).take(cols[::2], 1).astype(
                    np.float32) + cs * shifts[j] / 2
                planes.append(np.clip(cp, 0, 255).astype(np.uint8))
            self.objects.append({
                "planes": planes, "mask": mask,
                "mask_c": mask[::2, ::2],
                # start positions on a fixed grid over the frame
                "pos": (int((deal[1][j] // 4 + 0.5) * height
                            / max(1, (n_objects + 3) // 4)) - oh // 2,
                        int((deal[1][j] % 4 + 0.5) * width / 4) - ow // 2),
                "vel": speeds[j]})
        nrng = np.random.default_rng([self.seed, 0x401])
        self.noise = np.clip(np.rint(nrng.normal(
            0.0, noise_sigma, (noise_bank, height + 2, width + 2))),
            -127, 127).astype(np.int8)

    def _crop(self, plane: np.ndarray, y0: int, x0: int, h: int, w: int,
              step: int) -> np.ndarray:
        c = plane.shape[0]
        rows = (y0 + np.arange(0, h * step, step)) % c
        cols = (x0 + np.arange(0, w * step, step)) % plane.shape[1]
        return plane.take(rows, axis=0).take(cols, axis=1)

    def make(self, i: int) -> tuple:
        """Frame i: (y [h, w], cb [h/2, w/2], cr [h/2, w/2]) uint8."""
        h, w = self.h, self.w
        y0 = self.origin[0] + self.pan[1] * i
        x0 = self.origin[1] + self.pan[0] * i
        out = [self._crop(self.canvas[0], y0, x0, h, w, 1)]
        out += [self._crop(p, y0, x0, h // 2, w // 2, 2)
                for p in self.canvas[1:]]
        for ob in self.objects:
            oh, ow = ob["mask"].shape
            py = (ob["pos"][0] + ob["vel"][1] * i) % (h + oh) - oh
            px = (ob["pos"][1] + ob["vel"][0] * i) % (w + ow) - ow
            py -= py % 2
            px -= px % 2
            for k, plane in enumerate(out):
                s = 1 if k == 0 else 2
                m = ob["mask"] if k == 0 else ob["mask_c"]
                src = ob["planes"][k]
                y_a, x_a = py // s, px // s
                y_b = min(y_a + m.shape[0], plane.shape[0])
                x_b = min(x_a + m.shape[1], plane.shape[1])
                sy, sx = max(0, -y_a), max(0, -x_a)
                y_a, x_a = max(0, y_a), max(0, x_a)
                if y_b <= y_a or x_b <= x_a:
                    continue
                mm = m[sy:sy + y_b - y_a, sx:sx + x_b - x_a]
                view = plane[y_a:y_b, x_a:x_b]
                view[mm] = src[sy:sy + y_b - y_a, sx:sx + x_b - x_a][mm]
        k = int(np.random.default_rng([self.seed, 0x401, i]).integers(
            len(self.noise)))
        nz = self.noise[k]
        res = []
        for j, plane in enumerate(out):
            ph, pw = plane.shape
            oy, ox = (0, 0) if j == 0 else (j, j)
            n = nz[oy:oy + ph, ox:ox + pw]
            res.append(np.clip(plane.astype(np.int16) + n, 0, 255)
                       .astype(np.uint8))
        return tuple(res)


def make_source(seed: int, width: int, height: int, params: dict):
    """The frame source of a traffic file's `content` parameters."""
    return PanObjects(seed, width, height, **params)
