"""Dataset loaders for the BASELINE measurement matrix.

Counterpart of ``distkeras_tpu/data/loaders.py``, returning the port's
:class:`~distkeras_torch.data.dataset.Dataset`: the same cache search
order, archive formats, trusted-directory rule for pickles and synthetic
stand-ins (pure numpy, bit for bit the JAX package's for a seed and size),
and the same telemetry (the ``data.load`` span, ``data_loads_total`` and
``data_load_seconds``).

Offline-first: loaders search local caches for the standard archives and
NEVER download.  When no cache exists they fall back to deterministic,
clearly-labeled synthetic stand-ins with identical shapes/dtypes
(class-prototype clusters — learnable, so accuracy targets still exercise
the full train/eval loop), and the returned ``info`` dict says so:
benchmark records must carry the ``synthetic`` flag.

Cache search order: explicit ``cache_dir`` arg, ``$DKT_DATA_DIR``,
``~/.keras/datasets``, ``~/.cache/distkeras_tpu``, ``./data``.

Accepted archive formats — the raw distribution artifacts work as dropped
in, no conversion step:

- ``mnist.npz`` — keys ``x_train, y_train, x_test, y_test`` (Keras layout);
- the four raw IDX files (optionally gzipped): ``train-images-idx3-ubyte
  [.gz]``, ``train-labels-idx1-ubyte[.gz]``, ``t10k-images-idx3-ubyte
  [.gz]``, ``t10k-labels-idx1-ubyte[.gz]``;
- ``cifar10.npz`` / ``cifar100.npz`` — npz with the same keys, images
  [N, 32, 32, 3] uint8;
- the upstream ``cifar-10-batches-py``/``cifar-100-python`` directories or
  their ``.tar.gz`` archives (the canonical pickled python batches — these
  are the one place the no-pickle rule yields, because the upstream
  distribution IS a pickle).  Pickled archives are ONLY loaded from dirs
  you designated explicitly — the ``cache_dir`` argument or
  ``$DKT_DATA_DIR`` — never from the shared search dirs (cwd ``./data``,
  ``~/.keras/datasets``), so nothing an attacker drops there is unpickled.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
import time
from typing import Dict, Optional, Tuple

import numpy as np

from distkeras_torch import observability as obs
from distkeras_torch.data.dataset import Dataset


def _trusted_dirs(cache_dir: Optional[str]):
    """Dirs the user designated EXPLICITLY (a ``cache_dir`` argument or
    ``$DKT_DATA_DIR``).  Formats whose parsing executes a pickle are only
    ever loaded from here — never from the shared/implicit search dirs —
    so an attacker-placed archive in cwd or ``~/.keras`` cannot reach
    ``pickle.loads`` (the module's no-pickle rule, see module docstring)."""
    dirs = []
    if cache_dir:
        dirs.append(cache_dir)
    if os.environ.get("DKT_DATA_DIR"):
        dirs.append(os.environ["DKT_DATA_DIR"])
    return dirs


def _search_dirs(cache_dir: Optional[str]):
    home = os.path.expanduser("~")
    return _trusted_dirs(cache_dir) + [
        os.path.join(home, ".keras", "datasets"),
        os.path.join(home, ".cache", "distkeras_tpu"),
        os.path.join(os.getcwd(), "data")]


def _find_npz(filename: str, cache_dir: Optional[str]) -> Optional[str]:
    for d in _search_dirs(cache_dir):
        path = os.path.join(d, filename)
        if os.path.exists(path):
            return path
    return None


def _read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (the raw MNIST distribution format), gzipped or
    not: big-endian magic 0x0000080{1,3} + dims, then uint8 payload."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        if magic >> 8 != 0x08 or ndim not in (1, 3):
            raise ValueError(f"{path}: not an IDX uint8 file (magic 0x{magic:08x})")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path}: payload size {data.size} != dims {dims}")
    return data.reshape(dims)


_IDX_NAMES = {  # (images, labels) per split, each with optional .gz
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _find_mnist_idx(cache_dir: Optional[str]):
    """The four raw IDX files in one search dir -> (xtr, ytr, xte, yte)."""
    for d in _search_dirs(cache_dir):
        def resolve(stem):
            for name in (stem, stem + ".gz"):
                p = os.path.join(d, name)
                if os.path.exists(p):
                    return p
            return None

        paths = [resolve(s) for split in ("train", "test") for s in _IDX_NAMES[split]]
        if all(p is not None for p in paths):
            try:
                xtr, ytr, xte, yte = (_read_idx(p) for p in paths)
                return (xtr, ytr, xte, yte), d
            except (OSError, ValueError):
                continue  # corrupt/truncated IDX set: keep searching/fall back
    return None, None


def _cifar_from_pickles(members) -> Dict[str, np.ndarray]:
    """Merge CIFAR pickle batches: {b'data': [N, 3072], b'labels'|b'fine_labels'}."""
    xs, ys = [], []
    for raw in members:
        batch = pickle.loads(raw, encoding="bytes")
        data = np.asarray(batch[b"data"], np.uint8)
        labels = batch.get(b"labels", batch.get(b"fine_labels"))
        if labels is None:  # neither key: raise the callers' catchable error
            raise KeyError("CIFAR batch has neither b'labels' nor b'fine_labels'")
        xs.append(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(labels, np.int64))
    return {"x": np.concatenate(xs), "y": np.concatenate(ys)}


_CIFAR_LAYOUT = {
    # archive/dir name -> (train member basenames, test member basename)
    "cifar-10-batches-py": ([f"data_batch_{i}" for i in range(1, 6)], "test_batch"),
    "cifar-100-python": (["train"], "test"),
}


def _find_cifar_raw(kind: str, cache_dir: Optional[str]):
    """The upstream pickled distribution, extracted dir or .tar.gz."""
    train_names, test_name = _CIFAR_LAYOUT[kind]

    def read_file(path):
        with open(path, "rb") as f:
            return f.read()

    trusted = _trusted_dirs(cache_dir)
    for d in trusted:
        root = os.path.join(d, kind)
        if os.path.isdir(root):
            try:
                tr = _cifar_from_pickles(
                    read_file(os.path.join(root, n)) for n in train_names)
                te = _cifar_from_pickles([read_file(os.path.join(root, test_name))])
                return (tr["x"], tr["y"], te["x"], te["y"]), root
            except (OSError, KeyError, pickle.UnpicklingError):
                pass  # corrupt dir: fall through to the tar in the SAME dir
        tar_path = os.path.join(d, kind.replace("-batches-py", "-python") + ".tar.gz")
        if os.path.exists(tar_path):
            try:
                with tarfile.open(tar_path, "r:gz") as tf:
                    def member(n):
                        return tf.extractfile(f"{kind}/{n}").read()

                    tr = _cifar_from_pickles(member(n) for n in train_names)
                    te = _cifar_from_pickles([member(test_name)])
                return (tr["x"], tr["y"], te["x"], te["y"]), tar_path
            except (OSError, KeyError, tarfile.TarError, pickle.UnpicklingError):
                continue
    # existence-only scan (nothing is unpickled) of the SHARED dirs so a
    # user whose archive sits in ~/.keras/datasets learns why it was
    # skipped instead of silently training on synthetics
    import warnings

    for d in _search_dirs(cache_dir):
        if d in trusted:
            continue
        for name in (kind, kind.replace("-batches-py", "-python") + ".tar.gz"):
            p = os.path.join(d, name)
            if os.path.exists(p):
                warnings.warn(
                    f"found raw CIFAR archive {p!r} but pickled archives are "
                    f"only loaded from explicitly designated dirs (the "
                    f"cache_dir argument or $DKT_DATA_DIR); move the archive "
                    f"to a directory YOU control and designate that — do not "
                    f"designate shared/world-writable dirs, unpickling an "
                    f"attacker-placed archive executes code", stacklevel=3)
                break
    return None, None


def _synthetic_images(num_classes: int, shape: Tuple[int, ...], n_train: int,
                      n_test: int, seed: int, label_noise: float = 0.05,
                      signal_amplitude: float = 7.0):
    """Hard synthetic stand-ins: same shape/dtype as the real set,
    deterministic, and calibrated so accuracy targets take real training.

    The classes share one base image
    and differ only by a LOW-amplitude prototype delta under heavy pixel
    noise (low per-pixel SNR — the model must average evidence over many
    pixels across many steps), and ``label_noise`` of the TRAIN labels are
    resampled (test stays clean, so the target stays reachable)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(64.0, 192.0, size=shape).astype(np.float32)
    # low-amplitude class signal with SPATIAL structure: iid pixel deltas
    # are invisible to convolutional inductive bias (a CNN plateaued ~0.87
    # on them), so smooth the per-class pattern with a box blur and
    # renormalize to the target amplitude
    deltas = rng.normal(0.0, 1.0, size=(num_classes,) + shape).astype(np.float32)
    if len(shape) >= 2:
        for axis in (1, 2):  # H and W (leading axis is the class)
            k = 5
            pad = [(0, 0)] * deltas.ndim
            pad[axis] = (k // 2, k // 2)
            padded = np.pad(deltas, pad, mode="wrap")
            deltas = np.mean(np.stack([np.roll(padded, -i, axis=axis)
                                       for i in range(k)]), axis=0)
            sl = [slice(None)] * deltas.ndim
            sl[axis] = slice(0, shape[axis - 1])
            deltas = deltas[tuple(sl)]
    # per-dataset amplitude: the pixel-SNR knob that sets how many epochs
    # of evidence-averaging a conv net needs (calibration notes on each
    # loader; lower = harder)
    deltas *= signal_amplitude / (deltas.std() + 1e-9)

    def make(n, split_seed, noisy_labels):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, num_classes, size=n)
        # per-sample nuisance offset: the first thing a model fits is NOT
        # the label signal, which buys the later epochs their job
        offset = r.normal(0.0, 16.0, size=(n,) + (1,) * len(shape))
        imgs = base + deltas[labels] + offset \
            + r.normal(0.0, 48.0, size=(n,) + shape)
        seen = labels
        if noisy_labels and label_noise > 0.0:
            flip = r.random(n) < label_noise
            seen = np.where(flip, r.integers(0, num_classes, size=n), labels)
        return np.clip(imgs, 0, 255).astype(np.uint8), seen.astype(np.int64)

    xtr, ytr = make(n_train, seed + 1, noisy_labels=True)
    xte, yte = make(n_test, seed + 2, noisy_labels=False)
    return xtr, ytr, xte, yte


def _to_datasets(x_train, y_train, x_test, y_test, num_classes: int,
                 flatten: bool) -> Tuple[Dataset, Dataset]:
    def prep(x, y):
        feats = np.asarray(x, np.float32) / 255.0
        if feats.ndim == 3:  # grayscale [N, H, W] -> [N, H, W, 1]
            feats = feats[..., None]
        if flatten:
            feats = feats.reshape(len(feats), -1)
        y = np.asarray(y).reshape(-1).astype(np.int32)
        return Dataset({"features": feats,
                        "label": np.eye(num_classes, dtype=np.float32)[y],
                        "label_index": y})

    return prep(x_train, y_train), prep(x_test, y_test)


def _load(filename: str, num_classes: int, image_shape: Tuple[int, ...],
          synthetic_sizes: Tuple[int, int], seed: int, cache_dir: Optional[str],
          synthetic_fallback: bool, flatten: bool, raw_finder=None,
          signal_amplitude: float = 7.0) -> Tuple[Dataset, Dataset, Dict]:
    with obs.span("data.load", dataset=filename):
        train, test, info = _load_inner(
            filename, num_classes, image_shape, synthetic_sizes, seed,
            cache_dir, synthetic_fallback, flatten, raw_finder,
            signal_amplitude)
    if obs.enabled():
        obs.counter("data_loads_total", dataset=filename,
                    synthetic=str(bool(info["synthetic"])).lower()).inc()
    return train, test, info


def _load_inner(filename: str, num_classes: int, image_shape: Tuple[int, ...],
                synthetic_sizes: Tuple[int, int], seed: int,
                cache_dir: Optional[str], synthetic_fallback: bool,
                flatten: bool, raw_finder=None,
                signal_amplitude: float = 7.0) -> Tuple[Dataset, Dataset, Dict]:
    t0 = time.perf_counter()
    path = _find_npz(filename, cache_dir)
    raw = raw_source = None
    if path is None and raw_finder is not None:
        raw, raw_source = raw_finder(cache_dir)
    if path is not None:
        with np.load(path) as z:
            xtr, ytr = z["x_train"], z["y_train"]
            xte, yte = z["x_test"], z["y_test"]
        info = {"synthetic": False, "source": path}
    elif raw is not None:
        xtr, ytr, xte, yte = raw
        info = {"synthetic": False, "source": raw_source}
    elif synthetic_fallback:
        xtr, ytr, xte, yte = _synthetic_images(
            num_classes, image_shape, *synthetic_sizes, seed=seed,
            signal_amplitude=signal_amplitude)
        info = {"synthetic": True,
                "source": f"deterministic synthetic stand-in (no {filename} in "
                          f"{_search_dirs(cache_dir)}; raw pickled archives are "
                          f"honored only in {_trusted_dirs(cache_dir) or 'cache_dir/$DKT_DATA_DIR'})"}
    else:
        raise FileNotFoundError(
            f"{filename} not found in {_search_dirs(cache_dir)} (raw pickled "
            f"archives are honored only in explicitly designated dirs: "
            f"{_trusted_dirs(cache_dir) or 'pass cache_dir= or set $DKT_DATA_DIR'}) "
            "and synthetic_fallback=False (this environment has no network access)")
    train, test = _to_datasets(xtr, ytr, xte, yte, num_classes, flatten)
    info.update(num_classes=num_classes, train_rows=len(train), test_rows=len(test))
    if obs.enabled():
        obs.histogram("data_load_seconds").observe(time.perf_counter() - t0)
    return train, test, info


def load_mnist(cache_dir: Optional[str] = None, synthetic_fallback: bool = True,
               flatten: bool = False) -> Tuple[Dataset, Dataset, Dict]:
    """MNIST digits: features [N, 28, 28, 1] float32 in [0,1] (or flat 784),
    ``label`` one-hot, ``label_index`` int32.  Returns (train, test, info)."""
    return _load("mnist.npz", 10, (28, 28), (60000, 10000), seed=1234,
                 cache_dir=cache_dir, synthetic_fallback=synthetic_fallback,
                 flatten=flatten, raw_finder=_find_mnist_idx)


def load_cifar10(cache_dir: Optional[str] = None, synthetic_fallback: bool = True
                 ) -> Tuple[Dataset, Dataset, Dict]:
    """CIFAR-10: features [N, 32, 32, 3] float32 in [0,1].

    Synthetic amplitude 3.5, the JAX package's calibration: at 7.0 the CIFAR
    CNN separated the classes within an epoch or two, which defeats the
    wall-to-target metric (see ``distkeras_tpu/data/loaders.py``)."""
    return _load("cifar10.npz", 10, (32, 32, 3), (50000, 10000), seed=2345,
                 cache_dir=cache_dir, synthetic_fallback=synthetic_fallback,
                 flatten=False, signal_amplitude=3.5,
                 raw_finder=lambda cd: _find_cifar_raw("cifar-10-batches-py", cd))


def load_cifar100(cache_dir: Optional[str] = None, synthetic_fallback: bool = True
                  ) -> Tuple[Dataset, Dataset, Dict]:
    """CIFAR-100: features [N, 32, 32, 3] float32 in [0,1], 100 classes."""
    return _load("cifar100.npz", 100, (32, 32, 3), (50000, 10000), seed=3456,
                 cache_dir=cache_dir, synthetic_fallback=synthetic_fallback,
                 flatten=False,
                 raw_finder=lambda cd: _find_cifar_raw("cifar-100-python", cd))
