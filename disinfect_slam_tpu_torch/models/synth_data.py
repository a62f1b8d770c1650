"""Procedural ht/lt training scenes (counterpart of
disinfect_slam_tpu/models/synth_data.py, restated line for line so that
the port loads nothing of the JAX package; tests/test_torch_train.py
holds the two bit-equal).

The reference consumes a pre-trained high-touch/low-touch TorchScript
model whose weights were never published (segmentation/inference.cc:39-44
loads an external .pt).  To ship *working* weights, this module generates
the kind of indoor scenes the disinfection robot sees, with exact labels:

  - low-touch (channel 1): large surfaces — walls, floor, door leaves,
    table tops.  Muted, low-saturation textures.
  - high-touch (channel 0): small fixtures people grab — door handles,
    push plates, grab rails, light switches, faucet-like knobs.  Compact,
    high-saturation / metallic-bright shapes attached to surfaces.
  - neither: clutter blobs and shadows (both channels 0).

Everything is numpy (the host-side input pipeline), so the same
np.random.default_rng(seed) gives the same batches in both packages.
Scenes are resolution-independent so the fully convolutional net can
train small (fast) and run at the reference's 640x352 contract
(inference.cc:49-50).
"""

from __future__ import annotations

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int, base, amp: float) -> np.ndarray:
    """Low-frequency color texture around a base color."""
    small = rng.uniform(-1, 1, (-(-h // 16), -(-w // 16), 3))
    tex = np.kron(small, np.ones((16, 16, 1)))[:h, :w]
    noise = rng.uniform(-1, 1, (h, w, 3)) * 0.25
    img = np.asarray(base)[None, None] + (tex + noise) * amp
    return img


def _rect(mask_h, mask_w, cy, cx, hh, hw):
    y0, y1 = int(cy - hh), int(cy + hh)
    x0, x1 = int(cx - hw), int(cx + hw)
    y0, x0 = max(y0, 0), max(x0, 0)
    return slice(y0, max(y1, y0 + 1)), slice(x0, max(x1, x0 + 1))


def _ellipse(h, w, cy, cx, ry, rx):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / max(ry, 1e-3)) ** 2 + ((xx - cx) / max(rx, 1e-3)) ** 2 <= 1.0


def make_scene(rng: np.random.Generator, h: int, w: int):
    """One scene -> (rgb f32 [h,w,3] in [0,1], labels f32 [h,w,2] {ht,lt})."""
    img = np.zeros((h, w, 3), np.float32)
    ht = np.zeros((h, w), np.float32)
    lt = np.zeros((h, w), np.float32)

    # wall: muted base color, low-touch
    wall_base = rng.uniform(0.45, 0.8, 3) * np.array([1.0, 0.97, 0.9])
    img[:] = _texture(rng, h, w, wall_base, 0.05)
    lt[:] = 1.0

    # floor: bottom band with a different muted texture, low-touch
    horizon = int(h * rng.uniform(0.6, 0.8))
    floor_base = rng.uniform(0.25, 0.55, 3) * np.array([0.95, 0.9, 0.85])
    img[horizon:] = _texture(rng, h - horizon, w, floor_base, 0.08)

    # doors: tall rectangles on the wall, low-touch, each with a handle
    # and sometimes a push plate (high-touch)
    for _ in range(rng.integers(1, 3)):
        dw = int(w * rng.uniform(0.1, 0.18))
        dh = int(h * rng.uniform(0.35, 0.55))
        cx = rng.integers(dw, w - dw)
        cy = horizon - dh // 2
        ys, xs = _rect(h, w, cy, cx, dh // 2, dw // 2)
        door_base = rng.uniform(0.3, 0.7, 3) * np.array([0.9, 0.8, 0.7])
        img[ys, xs] = _texture(rng, ys.stop - ys.start, xs.stop - xs.start, door_base, 0.04)
        lt[ys, xs] = 1.0
        ht[ys, xs] = 0.0
        # handle: small bright metallic bar near the door edge
        side = -1 if rng.random() < 0.5 else 1
        hx = cx + side * int(dw * 0.35)
        hy = cy + rng.integers(-dh // 8, dh // 8)
        hw_ = max(int(w * rng.uniform(0.015, 0.03)), 2)
        hh_ = max(int(h * 0.008), 1)
        if rng.random() < 0.5:
            hh_, hw_ = hw_, hh_  # vertical handle
        ys2, xs2 = _rect(h, w, hy, hx, hh_, hw_)
        shade = rng.uniform(0.75, 1.0)
        img[ys2, xs2] = np.array([shade, shade * 0.95, rng.uniform(0.3, 0.6)])
        ht[ys2, xs2] = 1.0
        lt[ys2, xs2] = 0.0
        if rng.random() < 0.4:  # push plate
            ys3, xs3 = _rect(h, w, cy + dh // 4, hx, max(int(h * 0.02), 2), hw_)
            img[ys3, xs3] = np.array([shade * 0.9, shade * 0.9, rng.uniform(0.35, 0.6)])
            ht[ys3, xs3] = 1.0
            lt[ys3, xs3] = 0.0

    # grab rails: long thin bright horizontal bars on the wall, high-touch
    for _ in range(rng.integers(0, 3)):
        ry = rng.integers(int(h * 0.3), max(horizon - 2, int(h * 0.3) + 1))
        rx = rng.integers(int(w * 0.2), int(w * 0.8))
        rlen = int(w * rng.uniform(0.12, 0.3))
        rth = max(int(h * 0.008), 1)
        ys, xs = _rect(h, w, ry, rx, rth, rlen // 2)
        bright = rng.uniform(0.8, 1.0)
        img[ys, xs] = np.array([bright, bright * 0.97, rng.uniform(0.35, 0.65)])
        ht[ys, xs] = 1.0
        lt[ys, xs] = 0.0

    # light switches: tiny bright squares near doors, high-touch
    for _ in range(rng.integers(0, 4)):
        sy = rng.integers(int(h * 0.35), max(horizon - 2, int(h * 0.35) + 1))
        sx = rng.integers(4, w - 4)
        s = max(int(min(h, w) * 0.02), 2)
        ys, xs = _rect(h, w, sy, sx, s, s)
        img[ys, xs] = np.array([0.95, 0.95, rng.uniform(0.4, 0.7)])
        ht[ys, xs] = 1.0
        lt[ys, xs] = 0.0

    # clutter blobs: neither class (e.g. posters, stains, shadows) in a
    # cold hue band so the classes stay separable but non-trivial
    for _ in range(rng.integers(1, 5)):
        cy = rng.integers(0, h)
        cx = rng.integers(0, w)
        m = _ellipse(h, w, cy, cx, rng.uniform(0.02, 0.08) * h, rng.uniform(0.02, 0.1) * w)
        hue = rng.uniform(0.1, 0.5)
        img[m] = np.array([hue * 0.5, rng.uniform(0.4, 0.8), rng.uniform(0.5, 0.9)])
        ht[m] = 0.0
        lt[m] = 0.0

    # global illumination jitter + sensor noise
    img = img * rng.uniform(0.8, 1.15) + rng.normal(0, 0.015, img.shape)
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    labels = np.stack([ht, lt], axis=-1)
    return img, labels


def make_batch(rng: np.random.Generator, n: int, h: int, w: int):
    """Batch of scenes -> (images f32 [n,h,w,3], labels f32 [n,h,w,2])."""
    imgs = np.empty((n, h, w, 3), np.float32)
    labs = np.empty((n, h, w, 2), np.float32)
    for i in range(n):
        imgs[i], labs[i] = make_scene(rng, h, w)
    return imgs, labs
