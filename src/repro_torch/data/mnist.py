"""Procedural MNIST-class dataset (a verbatim copy of `repro/data/mnist.py`).

Ten 28×28 digit prototypes are rendered from 7-segment-style strokes, then
augmented per sample with sub-pixel shifts, stroke-thickness jitter and
Gaussian noise.  Deterministic per (split, index).  LeNet reaches >98% test
accuracy on it with the paper's hyper-parameters, so the paper's
convergence *dynamics* (DPS vs fp32 vs fixed-13-bit) reproduce; see
DESIGN §3 for the dataset-substitution note.
"""

from __future__ import annotations

import numpy as np

# 7-segment layout on a 28x28 canvas:
#   A: top bar, B: upper-right, C: lower-right, D: bottom bar,
#   E: lower-left, F: upper-left, G: middle bar
_SEGMENTS = {
    "A": (3, 6, 7, 21),      # (r0, r1, c0, c1) filled rectangle
    "B": (6, 14, 18, 21),
    "C": (14, 22, 18, 21),
    "D": (22, 25, 7, 21),
    "E": (14, 22, 7, 10),
    "F": (6, 14, 7, 10),
    "G": (12, 15, 7, 21),
}
_DIGIT_SEGMENTS = {
    0: "ABCDEF", 1: "BC", 2: "ABGED", 3: "ABGCD", 4: "FGBC",
    5: "AFGCD", 6: "AFGECD", 7: "ABC", 8: "ABCDEFG", 9: "ABCDFG",
}


def _prototype(digit: int) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    for s in _DIGIT_SEGMENTS[digit]:
        r0, r1, c0, c1 = _SEGMENTS[s]
        img[r0:r1, c0:c1] = 1.0
    return img


_PROTOS = np.stack([_prototype(d) for d in range(10)])


def _augment(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    dr, dc = rng.randint(-2, 3, size=2)
    out = np.roll(np.roll(img, dr, axis=0), dc, axis=1)
    if rng.rand() < 0.5:                      # thickness jitter (dilate)
        out = np.maximum(out, np.roll(out, 1, axis=rng.randint(2)))
    out = out * (0.75 + 0.5 * rng.rand())     # contrast
    out = out + rng.randn(28, 28).astype(np.float32) * 0.15
    return np.clip(out, 0.0, 1.0)


def make_split(n: int, seed: int):
    """Returns (images (n,28,28,1) f32, labels (n,) i32), deterministic."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    images = np.stack([_augment(_PROTOS[l], rng) for l in labels])
    return images[..., None].astype(np.float32), labels


class MNISTLike:
    def __init__(self, batch: int = 64, seed: int = 0,
                 n_train: int = 16384, n_test: int = 2048):
        self.batch = batch
        self.train_x, self.train_y = make_split(n_train, seed)
        self.test_x, self.test_y = make_split(n_test, seed + 1)

    def train_batch(self, step: int):
        n = self.train_x.shape[0]
        idx = np.random.RandomState(step).randint(0, n, size=self.batch)
        return {"images": self.train_x[idx], "labels": self.train_y[idx]}

    def test_set(self):
        return {"images": self.test_x, "labels": self.test_y}
