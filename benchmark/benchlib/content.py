"""Seeded synthetic YUV420 clips: the benchmark's frozen copy of the
repository's content generator (tools/make_content.py, synth_sequence).

The reference codec's sequences (akiyo, foreman, ...) are not public in
the repository, so the clips are synthetic stand-ins of the same classes:
"benchA" (foreman class: a panned textured background with noise and five
moving shapes) and "synthStatic" (akiyo class: a static background with
saturated regions and one small moving disc).  The generator draws from
the content's name together with the run's seed, so one seed always gives
one clip, and every seed gives a clip of the same class and sizes.
"""
from __future__ import annotations

import zlib

import numpy as np


def _rng(name: str, seed: int) -> np.random.Generator:
    return np.random.default_rng([zlib.crc32(name.encode()), int(seed) % 2 ** 64])


def clip(name: str, seed: int, nframes: int, width: int = 352, height: int = 288):
    """(y, cb, cr): (F, H, W) and (F, H/2, W/2) uint8 planes of a clip of
    the class `name` ("benchA", or a name beginning with "synthStatic")."""
    rng = _rng(name, seed)
    if name.startswith("synthStatic"):
        return _static(rng, nframes, width, height)
    return _bench_a(rng, nframes, width, height)


def _bench_a(rng, nframes: int, w: int, h: int):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cyy, cxx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    # static base: gradient + sinusoidal texture
    phase = rng.uniform(0, 6.28, size=4)
    base = (96 + 48 * np.sin(xx / 37.0 + phase[0]) + 32 * np.sin(yy / 23.0 + phase[1])
            + 16 * np.sin((xx + yy) / 11.0 + phase[2]))
    noise = rng.normal(0, 3.0, size=(h, w)).astype(np.float32)
    # moving objects: (x0, y0, w, h, vx, vy, level)
    objs = [(rng.integers(0, w - 64), rng.integers(0, h - 64), int(rng.integers(24, 80)),
             int(rng.integers(24, 80)), float(rng.integers(-6, 7)), float(rng.integers(-6, 7)),
             float(rng.integers(30, 226))) for _ in range(5)]
    y = np.empty((nframes, h, w), np.uint8)
    cb = np.empty((nframes, h // 2, w // 2), np.uint8)
    cr = np.empty_like(cb)
    for t in range(nframes):
        f = np.roll(base + noise, t % w, axis=1)  # global pan, wraps around
        for (x0, y0, ow, oh, vx, vy, lvl) in objs:
            px, py = int(x0 + vx * t) % w, int(y0 + vy * t) % h
            x1, y1 = min(px + ow, w), min(py + oh, h)
            f[py:y1, px:x1] = 0.7 * f[py:y1, px:x1] + 0.3 * lvl
        y[t] = np.clip(f, 0, 255).astype(np.uint8)
        cb[t] = np.clip(128 + 40 * np.sin(cxx / 29.0 + phase[3] + 0.05 * t), 0, 255)
        cr[t] = np.clip(128 + 40 * np.cos(cyy / 31.0 + phase[0] - 0.03 * t), 0, 255)
    return y, cb, cr


def _static(rng, nframes: int, w: int, h: int):
    """Static textured background + saturated black/white rectangles + one
    small moving disc; everything but the disc is identical across frames."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cyy, cxx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    base = (96 + 48 * np.sin(xx / 37.0) + 32 * np.sin(yy / 23.0)
            + rng.normal(0, 3.0, size=(h, w)).astype(np.float32))
    base[64:160, 48:176] = 0      # saturated black rectangle
    base[176:256, 208:320] = 255  # saturated white rectangle
    cb0 = np.clip(128 + 40 * np.sin(cxx / 29.0), 0, 255).astype(np.uint8)
    cr0 = np.clip(128 + 40 * np.cos(cyy / 31.0), 0, 255).astype(np.uint8)
    y = np.empty((nframes, h, w), np.uint8)
    for t in range(nframes):
        f = base.copy()
        px, py = (40 + 5 * t) % (w - 24), (30 + 3 * t) % (h - 24)
        f[py:py + 24, px:px + 24] = 200.0
        y[t] = np.clip(f, 0, 255).astype(np.uint8)
    return y, np.repeat(cb0[None], nframes, 0), np.repeat(cr0[None], nframes, 0)
