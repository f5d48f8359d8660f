"""CIFAR-10, real if a local copy exists, else a deterministic synthetic
stand-in: the port's own copy of examples/cifar/data.py.

Nothing is downloaded: `load_cifar10` reads a `cifar-10-batches-py`
directory or `cifar-10-python.tar.gz` from `root`, `FLASHY_TPU_CIFAR` or
the search paths, and otherwise returns `_synthetic()`, bit-equal to the
JAX package's for the same seed (class-conditional frequency patterns
plus noise, learnable, so accuracy curves stay meaningful). Images are
[N, 32, 32, 3] f32 in [0, 1], NHWC as the models take them; labels
int32. `CifarDataset` normalizes and, for training, augments (a random
crop of the 4-pixel reflect-padded image and a horizontal flip).
"""
import os
import pickle
import tarfile
import typing as tp

import numpy as np

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)

_SEARCH_PATHS = [
    "./data/cifar-10-batches-py",
    "./data/cifar-10-python.tar.gz",
    os.path.expanduser("~/data/cifar-10-batches-py"),
    "/data/cifar-10-batches-py",
]


def _load_real(path: str) -> tp.Optional[tp.Tuple[np.ndarray, ...]]:
    def read_batches(opener, names):
        xs, ys = [], []
        for name in names:
            with opener(name) as f:
                entry = pickle.load(f, encoding="bytes")
            xs.append(entry[b"data"])
            ys.append(entry[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.concatenate(ys).astype(np.int32)

    train_names = [f"data_batch_{i}" for i in range(1, 6)]
    if os.path.isdir(path):
        opener = lambda n: open(os.path.join(path, n), "rb")
        train = read_batches(opener, train_names)
        test = read_batches(opener, ["test_batch"])
        return train + test
    if path.endswith(".tar.gz") and os.path.exists(path):
        with tarfile.open(path) as tar:
            opener = lambda n: tar.extractfile(f"cifar-10-batches-py/{n}")
            train = read_batches(opener, train_names)
            test = read_batches(opener, ["test_batch"])
            return train + test
    return None


def _synthetic(n_train: int = 50000, n_test: int = 10000,
               seed: int = 0) -> tp.Tuple[np.ndarray, ...]:
    """Deterministic learnable stand-in: class-conditional frequency
    patterns + noise. A reasonable classifier can exceed 90% on it, so
    accuracy curves remain meaningful."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    prototypes = np.stack([
        np.stack([np.sin(2 * np.pi * ((c % 5 + 1) * xx + (c // 5) * yy) + p)
                  for p in (0.0, 1.0, 2.0)], axis=-1)
        for c in range(10)
    ])  # [10, 32, 32, 3]
    prototypes = (prototypes * 0.25 + 0.5).astype(np.float32)

    def make(n, offset):
        labels = rng.integers(0, 10, n).astype(np.int32)
        images = prototypes[labels] + rng.normal(0, 0.2, (n, 32, 32, 3)).astype(np.float32)
        return np.clip(images, 0.0, 1.0), labels

    return make(n_train, 0) + make(n_test, 1)


def load_cifar10(root: tp.Optional[str] = None
                 ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """Returns (x_train, y_train, x_test, y_test, is_real).

    `root` (or the FLASHY_TPU_CIFAR env var) points at a local
    `cifar-10-batches-py` directory or `cifar-10-python.tar.gz` archive
    — the files torchvision downloads; with no network the user drops
    them in place instead. An explicit root that does not
    resolve raises (silent synthetic fallback would invalidate the
    accuracy-to-baseline comparison); without one, the default search
    paths are tried and the synthetic stand-in is the fallback.
    """
    explicit = root or os.environ.get("FLASHY_TPU_CIFAR")
    if explicit:
        data = _load_real(explicit)
        if data is None:
            raise FileNotFoundError(
                f"CIFAR-10 not found at {explicit!r} (expected a "
                "cifar-10-batches-py directory or cifar-10-python.tar.gz)")
        return data + (True,)
    for path in _SEARCH_PATHS:
        data = _load_real(path)
        if data is not None:
            return data + (True,)
    return _synthetic() + (False,)


class CifarDataset:
    """Normalized CIFAR samples with optional train-time augmentation
    (random crop with 4px padding + horizontal flip, the standard
    CIFAR recipe)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 augment: bool = False, seed: int = 0):
        self.images = images
        self.labels = labels
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        image = self.images[index]
        if self.augment:
            if self.rng.random() < 0.5:
                image = image[:, ::-1]
            padded = np.pad(image, ((4, 4), (4, 4), (0, 0)), mode="reflect")
            top, left = self.rng.integers(0, 9, 2)
            image = padded[top:top + 32, left:left + 32]
        image = (image - MEAN) / STD
        return {"image": image.astype(np.float32), "label": self.labels[index]}
