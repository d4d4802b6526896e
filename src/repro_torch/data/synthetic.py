"""Procedural image datasets and the LM token stream (NumPy only).

MNIST/smallNORB/CIFAR *analogues*: class templates rendered with random
affine pose + noise.  A copy of the reference package's
`make_image_dataset` and `ImageTask`: the same seed gives the same
images, so both packages calibrate, serve and train on identical inputs;
`TokenTask` is the reference's token stream, token for token.
"""
from __future__ import annotations

import numpy as np

DIGITS = [
    "01110 10001 10011 10101 11001 10001 01110",  # 0
    "00100 01100 00100 00100 00100 00100 01110",  # 1
    "01110 10001 00001 00010 00100 01000 11111",  # 2
    "01110 10001 00001 00110 00001 10001 01110",  # 3
    "00010 00110 01010 10010 11111 00010 00010",  # 4
    "11111 10000 11110 00001 00001 10001 01110",  # 5
    "01110 10000 11110 10001 10001 10001 01110",  # 6
    "11111 00001 00010 00100 01000 01000 01000",  # 7
    "01110 10001 10001 01110 10001 10001 01110",  # 8
    "01110 10001 10001 01111 00001 00001 01110",  # 9
]


def _bitmap(tpl: str) -> np.ndarray:
    rows = tpl.split()
    return np.array([[float(c) for c in r] for r in rows], np.float32)


_DIGIT_MAPS = [np.kron(_bitmap(t), np.ones((3, 3), np.float32))
               for t in DIGITS]                        # 21 x 15


def _affine_place(canvas_hw, img, rng, max_shift=3, rot=0.35, scale=0.25):
    """Place `img` on a canvas with a random rotation/scale/shift
    (inverse-mapped bilinear sampling)."""
    H, W = canvas_hw
    h, w = img.shape
    th = rng.uniform(-rot, rot)
    sc = 1.0 + rng.uniform(-scale, scale)
    cx, cy = W / 2 + rng.integers(-max_shift, max_shift + 1), \
        H / 2 + rng.integers(-max_shift, max_shift + 1)
    cos, sin = np.cos(th) / sc, np.sin(th) / sc
    ys, xs = np.mgrid[0:H, 0:W]
    u = cos * (xs - cx) + sin * (ys - cy) + w / 2
    v = -sin * (xs - cx) + cos * (ys - cy) + h / 2
    u0 = np.clip(np.floor(u).astype(int), 0, w - 2)
    v0 = np.clip(np.floor(v).astype(int), 0, h - 2)
    du = np.clip(u - u0, 0, 1)
    dv = np.clip(v - v0, 0, 1)
    valid = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    out = (img[v0, u0] * (1 - du) * (1 - dv) + img[v0, u0 + 1] * du * (1 - dv)
           + img[v0 + 1, u0] * (1 - du) * dv + img[v0 + 1, u0 + 1] * du * dv)
    return np.where(valid, out, 0.0).astype(np.float32)


def _shape_mask(kind: int, size: int = 24) -> np.ndarray:
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2
    x, y = (xs - c) / c, (ys - c) / c
    if kind == 0:                                     # ellipse
        return ((x / 0.9) ** 2 + (y / 0.55) ** 2 <= 1).astype(np.float32)
    if kind == 1:                                     # rectangle
        return ((np.abs(x) <= 0.8) & (np.abs(y) <= 0.45)).astype(np.float32)
    if kind == 2:                                     # triangle
        return ((y >= -0.7) & (y <= 0.8) &
                (np.abs(x) <= 0.8 * (0.8 - y) / 1.5)).astype(np.float32)
    if kind == 3:                                     # plus
        return ((np.abs(x) <= 0.25) | (np.abs(y) <= 0.25)).astype(np.float32)
    r = np.sqrt(x * x + y * y)
    a = np.arctan2(y, x)
    return (r <= 0.45 + 0.4 * np.cos(5 * a) ** 2).astype(np.float32)  # star


_DIGIT_MAPS_SMALL = [np.kron(_bitmap(t), np.ones((2, 2), np.float32))
                     for t in DIGITS]                  # 14 x 10

def make_image_dataset(kind: str, n: int, seed: int = 0):
    """kind: mnist | smallnorb | cifar10 | edge_tiny.
    Returns (images NHWC, labels).  "edge_tiny" is the MNIST analogue
    shrunk to the serving registry's EDGE_TINY geometry (16x16x1, digits
    0-3) so the deep-edge config has a real accuracy task to train on."""
    rng = np.random.default_rng(seed)
    if kind == "mnist":
        H, W, C, ncls = 28, 28, 1, 10
    elif kind == "edge_tiny":
        H, W, C, ncls = 16, 16, 1, 4
    elif kind == "smallnorb":
        H, W, C, ncls = 32, 32, 2, 5
    else:
        H, W, C, ncls = 32, 32, 3, 10
    imgs = np.zeros((n, H, W, C), np.float32)
    labels = rng.integers(0, ncls, n).astype(np.int32)
    for i in range(n):
        y = int(labels[i])
        if kind == "mnist":
            base = _affine_place((H, W), _DIGIT_MAPS[y], rng)
            imgs[i, :, :, 0] = base
        elif kind == "edge_tiny":
            base = _affine_place((H, W), _DIGIT_MAPS_SMALL[y], rng,
                                 max_shift=1)
            imgs[i, :, :, 0] = base
        elif kind == "smallnorb":
            m = _shape_mask(y)
            base = _affine_place((H, W), m, rng, rot=1.2)
            light = rng.uniform(0.5, 1.0)
            shift = rng.integers(1, 3)
            imgs[i, :, :, 0] = base * light
            imgs[i, :, :, 1] = np.roll(base, shift, axis=1) * light
        else:
            shape = _shape_mask(y % 5)
            base = _affine_place((H, W), shape, rng, rot=1.2)
            hue = (y // 5)
            col = rng.uniform(0.6, 1.0, 3)
            col[hue] *= 0.3                       # class-dependent colour
            for ch in range(3):
                imgs[i, :, :, ch] = base * col[ch]
            imgs[i] += rng.uniform(0, 0.25) * \
                rng.random((H, W, C)).astype(np.float32)
        imgs[i] += rng.normal(0, 0.04, (H, W, C)).astype(np.float32)
    np.clip(imgs, 0.0, 1.0, out=imgs)
    return imgs, labels


class ImageTask:
    """Index-addressable image batches (for CapsNet training): batch i is
    a pure function of (seed, i), so a resumed run replays the exact
    sample stream."""

    def __init__(self, kind: str, seed: int = 0):
        self.kind = kind
        self.seed = seed

    def batch(self, index: int, batch_size: int):
        return make_image_dataset(self.kind, batch_size,
                                  seed=(self.seed * 100003 + index))


class TokenTask:
    """Noisy affine-recurrence token stream: token_{t+1} =
    (a * token_t + b) mod V with random resets — learnable structure.
    The reference's `TokenTask`: batch i is a pure function of (seed, i),
    the same int32 tokens bit for bit."""

    def __init__(self, vocab: int, seq_len: int, seed: int = 0,
                 a: int = 31, b: int = 17, reset_p: float = 0.05):
        self.vocab = max(vocab, 8)
        self.seq = seq_len
        self.seed = seed
        self.a, self.b, self.reset_p = a, b, reset_p

    def batch(self, index: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed, index))
        toks = np.zeros((batch_size, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        resets = rng.random((batch_size, self.seq)) < self.reset_p
        fresh = rng.integers(0, self.vocab, (batch_size, self.seq))
        for t in range(self.seq):
            nxt = (self.a * toks[:, t] + self.b) % self.vocab
            toks[:, t + 1] = np.where(resets[:, t], fresh[:, t], nxt)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
