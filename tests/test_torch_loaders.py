"""The port's dataset loaders against the JAX package's: the synthetic
stand-ins bit for bit (at the published sizes and amplitudes, generated
here at small sizes through the same function), the archive formats read to
equal arrays, and the pickle rule alike in both packages.  Every case runs
with ``HOME``, the working directory and ``$DKT_DATA_DIR`` moved into its
``tmp_path``, so no cache of the machine is read."""

import gzip
import io
import os
import pickle
import struct
import tarfile
import warnings

import numpy as np
import pytest

from distkeras_torch.data import loaders as tl
from distkeras_tpu.data import loaders as jl

LOADERS = {"mnist": ("load_mnist", 60000, 10000, 7.0),
           "cifar10": ("load_cifar10", 50000, 10000, 3.5),
           "cifar100": ("load_cifar100", 50000, 10000, 7.0)}


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("DKT_DATA_DIR", raising=False)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return tmp_path


def _same(ja, ta):
    """Two (train, test, info) triples hold equal columns and info."""
    (jtr, jte, jinfo), (ttr, tte, tinfo) = ja, ta
    assert jinfo == tinfo
    for j, t in ((jtr, ttr), (jte, tte)):
        assert sorted(j.columns) == sorted(t.columns)
        for c in j.columns:
            assert j[c].dtype == t[c].dtype, c
            np.testing.assert_array_equal(j[c], t[c], err_msg=c)


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_synthetic_stand_ins_bit_equal(name, isolated, monkeypatch):
    """Each loader asks its generator for the published sizes, seed and
    amplitude (recorded), and the generator gives the JAX package's bits
    (run at 96 + 24 rows: the full sets hold 10**8 pixels)."""
    fn, n_train, n_test, amplitude = LOADERS[name]
    calls = {}
    for pkg, mod in (("jax", jl), ("port", tl)):
        real = mod._synthetic_images

        def small(num_classes, shape, n_tr, n_te, seed, _real=real, _pkg=pkg, **kw):
            calls[_pkg] = (num_classes, shape, n_tr, n_te, seed, kw)
            return _real(num_classes, shape, 96, 24, seed, **kw)

        monkeypatch.setattr(mod, "_synthetic_images", small)
    _same(getattr(jl, fn)(), getattr(tl, fn)())
    assert calls["port"] == calls["jax"]
    assert calls["port"][2:4] == (n_train, n_test)
    assert calls["port"][5]["signal_amplitude"] == amplitude


@pytest.mark.parametrize("shape,classes,amplitude", [((28, 28), 10, 7.0),
                                                     ((32, 32, 3), 100, 3.5), ((5,), 3, 7.0)])
def test_synthetic_generator_bit_equal(shape, classes, amplitude):
    a = jl._synthetic_images(classes, shape, 300, 50, seed=11, signal_amplitude=amplitude)
    b = tl._synthetic_images(classes, shape, 300, 50, seed=11, signal_amplitude=amplitude)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_mnist_flatten_and_npz_cache(isolated):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (32, 28, 28), dtype=np.uint8)
    y = rng.integers(0, 10, 32)
    np.savez(isolated / "mnist.npz", x_train=x, y_train=y, x_test=x[:8], y_test=y[:8])
    for flatten in (False, True):
        ja = jl.load_mnist(cache_dir=str(isolated), flatten=flatten)
        _same(ja, tl.load_mnist(cache_dir=str(isolated), flatten=flatten))
        assert ja[2]["synthetic"] is False
        assert ja[0]["features"].shape == ((32, 784) if flatten else (32, 28, 28, 1))


def _write_idx(path, arr, gz):
    arr = np.asarray(arr, np.uint8)
    payload = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape) + arr.tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(payload)
    else:
        path.write_bytes(payload)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_raw_idx_files_load_alike(gz, isolated, monkeypatch):
    rng = np.random.default_rng(1)
    d = isolated / "idx"
    d.mkdir()
    _write_idx(d / "train-images-idx3-ubyte", rng.integers(0, 256, (20, 28, 28)), gz)
    _write_idx(d / "train-labels-idx1-ubyte", rng.integers(0, 10, (20,)), gz)
    _write_idx(d / "t10k-images-idx3-ubyte", rng.integers(0, 256, (6, 28, 28)), gz)
    _write_idx(d / "t10k-labels-idx1-ubyte", rng.integers(0, 10, (6,)), gz)
    monkeypatch.setenv("DKT_DATA_DIR", str(d))
    ja = jl.load_mnist(synthetic_fallback=False)
    _same(ja, tl.load_mnist(synthetic_fallback=False))
    assert ja[2]["source"] == str(d) and len(ja[1]) == 6


def test_corrupt_idx_falls_back_alike(isolated):
    d = isolated / "idx"
    d.mkdir()
    for stem in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"):
        (d / stem).write_bytes(b"\x00\x00\x09\x01" + b"\x00" * 8)
    jerr = pytest.raises(FileNotFoundError, jl.load_mnist, cache_dir=str(d),
                         synthetic_fallback=False)
    terr = pytest.raises(FileNotFoundError, tl.load_mnist, cache_dir=str(d),
                         synthetic_fallback=False)
    assert str(jerr.value) == str(terr.value)
    assert "synthetic_fallback=False" in str(terr.value)


def _cifar10_dir(root, rng):
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for i in range(1, 6):
        (d / f"data_batch_{i}").write_bytes(pickle.dumps(
            {b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, 3).tolist()}))
    (d / "test_batch").write_bytes(pickle.dumps(
        {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
         b"labels": rng.integers(0, 10, 4).tolist()}))


def _cifar100_tar(root, rng):
    with tarfile.open(root / "cifar-100-python.tar.gz", "w:gz") as tf:
        for name, n in (("train", 7), ("test", 3)):
            blob = pickle.dumps({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                                 b"fine_labels": rng.integers(0, 100, n).tolist()})
            ti = tarfile.TarInfo(f"cifar-100-python/{name}")
            ti.size = len(blob)
            tf.addfile(ti, io.BytesIO(blob))


@pytest.mark.parametrize("form", ["cifar10_dir", "cifar100_targz"])
def test_cifar_pickles_load_alike_from_a_trusted_dir(form, isolated):
    rng = np.random.default_rng(2)
    trusted = isolated / "trusted"
    trusted.mkdir()
    if form == "cifar10_dir":
        _cifar10_dir(trusted, rng)
        fn = "load_cifar10"
    else:
        _cifar100_tar(trusted, rng)
        fn = "load_cifar100"
    ja = getattr(jl, fn)(cache_dir=str(trusted), synthetic_fallback=False)
    _same(ja, getattr(tl, fn)(cache_dir=str(trusted), synthetic_fallback=False))
    assert ja[2]["synthetic"] is False and ja[0]["features"].shape[1:] == (32, 32, 3)


class _Trap:
    """Unpickling this records that a pickle from an untrusted dir ran."""

    def __reduce__(self):
        return (os.makedirs, (os.path.join(os.getcwd(), "UNPICKLED"),))


@pytest.mark.parametrize("shared", ["cwd_data", "keras_cache"])
def test_pickles_refused_outside_trusted_dirs_alike(shared, isolated):
    """A raw CIFAR archive in a shared search dir (./data, ~/.keras/datasets)
    is never unpickled: both packages warn, name the rule, and raise (or
    fall back) the same way."""
    d = (isolated / "work" / "data" if shared == "cwd_data"
         else isolated / "home" / ".keras" / "datasets")
    root = d / "cifar-10-batches-py"
    root.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        (root / name).write_bytes(pickle.dumps(_Trap()))
    msgs = {}
    for pkg, mod in (("jax", jl), ("port", tl)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with pytest.raises(FileNotFoundError) as e:
                mod.load_cifar10(synthetic_fallback=False)
        assert any("only loaded from explicitly designated dirs" in str(w.message)
                   for w in caught), pkg
        msgs[pkg] = str(e.value)
    assert msgs["port"] == msgs["jax"]
    assert not (isolated / "work" / "UNPICKLED").exists()
    assert tl._search_dirs(None) == jl._search_dirs(None)
    assert tl._trusted_dirs("x") == jl._trusted_dirs("x") == ["x"]
