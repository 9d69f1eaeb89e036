"""Named dataset iterators: counterpart of
``deeplearning4j_tpu/datasets/fetchers.py``.

Nothing is downloaded. Iris ships in the package (``_iris.csv``, the
same 150 rows as the JAX package's copy). MNIST and EMNIST read the
standard IDX files (optionally gzipped), CIFAR-10 its binary batches,
from a local directory: ``data_dir``, else ``$DL4J_TPU_DATA_DIR/<name>``,
else ``~/.deeplearning4j_tpu/<name>``. A missing file raises
``FileNotFoundError`` naming where it was looked for. Labels are one-hot;
images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator


def _data_dir(sub: str) -> str:
    root = os.environ.get(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))
    return os.path.join(root, sub)


class IrisDataSetIterator(ArrayDataSetIterator):
    """150 examples, 4 features, 3 classes (Fisher 1936)."""

    def __init__(self, batch: int = 150, num_examples: int = 150,
                 seed: int = 12345, shuffle: bool = True):
        raw = np.loadtxt(os.path.join(os.path.dirname(__file__),
                                      "_iris.csv"), delimiter=",",
                         dtype=np.float32)
        x = raw[:, :4]
        y = np.eye(3, dtype=np.float32)[raw[:, 4].astype(np.int64)]
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(x))
            x, y = x[order], y[order]
        x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch)


def _read_idx(path: str) -> np.ndarray:
    """An (optionally gzipped) IDX file of unsigned bytes."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype = (magic >> 8) & 0xFF
        if dtype != 0x08:
            raise ValueError(f"{path}: unsupported IDX dtype 0x{dtype:02x}")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _find_idx(directory: str, stems) -> str:
    for stem in stems:
        for suffix in ("", ".gz"):
            p = os.path.join(directory, stem + suffix)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(
        f"None of {list(stems)} found in {directory!r}. Nothing is "
        "downloaded: place the IDX files there (or set $DL4J_TPU_DATA_DIR).")


class MnistDataSetIterator(ArrayDataSetIterator):
    """Flat [N, 784] f32 rows in [0, 1] with one-hot labels
    (``as_images=True``: [N, 28, 28, 1])."""

    IMG_STEMS_TRAIN = ("train-images-idx3-ubyte", "train-images.idx3-ubyte")
    LBL_STEMS_TRAIN = ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte")
    IMG_STEMS_TEST = ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte")
    LBL_STEMS_TEST = ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte")

    def __init__(self, batch: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 12345,
                 shuffle: Optional[bool] = None, binarize: bool = False,
                 as_images: bool = False, data_dir: Optional[str] = None,
                 subdir: str = "mnist", label_offset: int = 0,
                 num_classes: int = 10):
        d = data_dir or _data_dir(subdir)
        img = _read_idx(_find_idx(
            d, self.IMG_STEMS_TRAIN if train else self.IMG_STEMS_TEST))
        lbl = _read_idx(_find_idx(
            d, self.LBL_STEMS_TRAIN if train else self.LBL_STEMS_TEST))
        x = img.astype(np.float32) / 255.0
        if binarize:
            x = (x > 0.5).astype(np.float32)
        lbl = lbl.astype(np.int64) - label_offset
        # the width is the dataset's class count, not inferred from the
        # data, so every split agrees on the label shape
        if lbl.min() < 0 or lbl.max() >= num_classes:
            raise ValueError(
                f"labels outside [0, {num_classes}) after offset "
                f"{label_offset}: [{lbl.min()}, {lbl.max()}]")
        y = np.eye(num_classes, dtype=np.float32)[lbl]
        if shuffle is None:
            shuffle = train
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(x))
            x, y = x[order], y[order]
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        x = x[..., None] if as_images else x.reshape(len(x), -1)
        super().__init__(x, y, batch)


class EmnistDataSetIterator(MnistDataSetIterator):
    """EMNIST's splits in MNIST's IDX format
    (``emnist-<split>-<train|test>-images-idx3-ubyte``)."""

    def __init__(self, dataset_type: str, batch: int, train: bool = True,
                 **kw):
        t = "train" if train else "test"
        self.IMG_STEMS_TRAIN = self.IMG_STEMS_TEST = (
            f"emnist-{dataset_type}-{t}-images-idx3-ubyte",)
        self.LBL_STEMS_TRAIN = self.LBL_STEMS_TEST = (
            f"emnist-{dataset_type}-{t}-labels-idx1-ubyte",)
        kw.setdefault("subdir", "emnist")
        # 'letters' labels are 1..26
        if dataset_type == "letters":
            kw.setdefault("label_offset", 1)
        outcomes = {"letters": 26, "balanced": 47, "bymerge": 47,
                    "byclass": 62, "digits": 10, "mnist": 10}
        kw.setdefault("num_classes", outcomes.get(dataset_type, 10))
        super().__init__(batch, train=train, **kw)


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """CIFAR-10's binary batches (``data_batch_*.bin`` / ``test_batch.bin``:
    a label byte and 3072 CHW pixel bytes a record) as NHWC [N, 32, 32, 3]
    f32 in [0, 1]."""

    def __init__(self, batch: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 12345,
                 shuffle: Optional[bool] = None,
                 data_dir: Optional[str] = None):
        d = data_dir or _data_dir("cifar10")
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        xs, ys = [], []
        for nm in names:
            p = os.path.join(d, nm)
            if not os.path.exists(p):
                p2 = os.path.join(d, "cifar-10-batches-bin", nm)
                if not os.path.exists(p2):
                    # any missing batch fails: no training on part of it
                    raise FileNotFoundError(
                        f"{nm} not found under {d!r}. Nothing is "
                        "downloaded: place the CIFAR-10 binary batches "
                        "there (or set $DL4J_TPU_DATA_DIR).")
                p = p2
            raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0])
            xs.append(raw[:, 1:])
        x = (np.concatenate(xs).reshape(-1, 3, 32, 32)
             .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
        y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
        if shuffle is None:
            shuffle = train
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(x))
            x, y = x[order], y[order]
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch)


__all__ = ["IrisDataSetIterator", "MnistDataSetIterator",
           "EmnistDataSetIterator", "Cifar10DataSetIterator"]
