"""The port's DKCOL container against the JAX package's: the same bytes on
disk, files of either package loading in the other (native loader and
``np.memmap``), the same chunks and chunk-local shuffles, and the port's
``Dataset`` / trainer feed reading straight off the mapping."""

import struct

import numpy as np
import pytest

import distkeras_torch.data.colfile as tcf
import distkeras_tpu.data.colfile as jcf

needs_native = pytest.mark.skipif(
    not tcf.native_loader_available(),
    reason="no C++ toolchain: the native loader is unavailable (the memmap cases still run)")


@pytest.fixture()
def cols():
    rng = np.random.default_rng(0)
    return {
        "features": rng.normal(size=(256, 12)).astype(np.float32),
        "label": np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=256)],
        "label_index": rng.integers(0, 4, size=256).astype(np.int32),
    }


@pytest.fixture()
def colfile(tmp_path, cols):
    path = str(tmp_path / "train.dkcol")
    tcf.write_columns(path, cols)
    return path, cols


@pytest.fixture(params=["native", "memmap"])
def loader(request, monkeypatch):
    """Both ways of opening a container in both packages."""
    if request.param == "memmap":
        monkeypatch.setattr(tcf, "_load_lib", lambda: None)
        monkeypatch.setattr(jcf, "_load_lib", lambda: None)
    elif not tcf.native_loader_available():
        pytest.skip("no C++ toolchain")
    return request.param


@needs_native
def test_native_loader_builds_into_the_ports_build_dir():
    from distkeras_torch._build import BUILD_DIR
    from distkeras_torch.runtime.native import shared_library_path

    assert shared_library_path(tcf.SOURCE, "data_loader").parent == BUILD_DIR
    assert shared_library_path(tcf.SOURCE, "data_loader").exists()


def test_writers_produce_the_same_bytes(tmp_path, cols):
    tcf.write_columns(str(tmp_path / "t.dkcol"), cols)
    jcf.write_columns(str(tmp_path / "j.dkcol"), cols)
    assert (tmp_path / "t.dkcol").read_bytes() == (tmp_path / "j.dkcol").read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_packages(tmp_path, cols, loader, writer):
    """A file written by either package loads in both, column for column."""
    path = str(tmp_path / "x.dkcol")
    (tcf if writer == "port" else jcf).write_columns(path, cols)
    with tcf.ColumnFile(path) as t, jcf.ColumnFile(path) as j:
        assert t.native == j.native == (loader == "native")
        assert t.columns == j.columns == list(cols)
        for name, arr in cols.items():
            assert t[name].dtype == arr.dtype
            np.testing.assert_array_equal(t[name], arr)
            np.testing.assert_array_equal(t[name], j[name])


@needs_native
def test_views_are_zero_copy_and_read_only(colfile):
    path, _ = colfile
    with tcf.ColumnFile(path) as cf:
        arr = cf["features"]
        assert not arr.flags.owndata and not arr.flags.writeable


@needs_native
def test_prefetch_and_warm(colfile):
    import time

    path, _ = colfile
    with tcf.ColumnFile(path, warm=True) as cf:
        cf.prefetch("features", 0, 128)
        cf.prefetch("features", 200, 56)
        cf.prefetch("features", 0, 10 ** 9)   # out of range: ignored
        deadline = time.time() + 5
        while cf.warmed_bytes() == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert cf.warmed_bytes() > 0


def test_chunks_and_shuffle_match_jax(colfile, loader):
    """The same chunks in the same order, and the same chunk-local shuffle
    for the same seed, as the JAX package's dataset over the same file."""
    path, cols = colfile
    with tcf.ColumnFile(path) as t, jcf.ColumnFile(path) as j:
        for seed in (None, 7):
            td, jd = t.dataset(), j.dataset()
            if seed is not None:
                td, jd = td.shuffle(seed=seed), jd.shuffle(seed=seed)
            tc = list(td.chunked_epoch(32, ["features", "label_index"], chunk_windows=3))
            jc = list(jd.chunked_epoch(32, ["features", "label_index"], chunk_windows=3))
            assert len(tc) == len(jc) == 3
            for a, b in zip(tc, jc):
                for c in a:
                    np.testing.assert_array_equal(a[c], b[c])
        feats = np.concatenate([c["features"].reshape(-1, 12) for c in tc])
        assert not np.array_equal(feats, cols["features"])
        np.testing.assert_array_equal(np.sort(feats, axis=0), np.sort(cols["features"], axis=0))


def test_dataset_and_training_from_file(colfile):
    """The port's Dataset and SingleTrainer read the mapped columns (the feed
    copies each read-only chunk), and the unshuffled run matches training
    on the same rows in memory."""
    from distkeras_torch import Dataset, ModelSpec, SingleTrainer

    path, cols = colfile
    spec = ModelSpec(name="mlp", config={"hidden_sizes": (8,), "num_outputs": 4},
                     input_shape=(12,))
    with tcf.ColumnFile(path) as cf:
        ds = cf.dataset()
        assert isinstance(ds, Dataset) and len(ds) == 256
        chunks = list(ds.chunked_epoch(32, ["features", "label"], chunk_windows=4))
        assert sum(c["features"].shape[0] for c in chunks) == 8
        t = SingleTrainer(spec, batch_size=32, num_epoch=2, learning_rate=0.1, chunk_windows=4,
                          seed=3, device="cpu")
        t.train(ds, shuffle=False)
    ref = SingleTrainer(spec, batch_size=32, num_epoch=2, learning_rate=0.1, chunk_windows=4,
                        seed=3, device="cpu")
    ref.train(Dataset(cols), shuffle=False)
    assert np.isfinite(t.history).all()
    np.testing.assert_array_equal(np.asarray(t.history), np.asarray(ref.history))


def test_chunked_epoch_prefetches_ahead(colfile, monkeypatch):
    path, _ = colfile
    with tcf.ColumnFile(path) as cf:
        calls = []
        monkeypatch.setattr(cf, "prefetch", lambda name, start, n: calls.append((name, start, n)))
        chunks = list(cf.dataset().chunked_epoch(32, ["features"], chunk_windows=3))
        assert len(chunks) == 3  # 8 windows -> 3 + 3 + 2
        assert ("features", 3 * 32, 3 * 32) in calls
        assert ("features", 6 * 32, 2 * 32) in calls


@needs_native
def test_views_survive_close(colfile):
    """close() releases the handle but keeps the mapping: views handed out
    earlier stay valid."""
    path, cols = colfile
    cf = tcf.ColumnFile(path)
    ds = cf.dataset()
    arr = cf["features"]
    cf.close()
    np.testing.assert_array_equal(arr, cols["features"])
    np.testing.assert_array_equal(ds["label_index"], cols["label_index"])


def test_split_rejected_on_mapped_dataset(colfile):
    path, _ = colfile
    with tcf.ColumnFile(path) as cf:
        with pytest.raises(NotImplementedError, match="write separate"):
            cf.dataset().split(0.9, seed=0)


def test_corrupt_files_rejected(tmp_path, loader):
    bad = tmp_path / "bad.dkcol"
    bad.write_bytes(b"NOTDKCOL" + b"\x00" * 64)
    with pytest.raises(OSError, match="magic|DKCOL"):
        tcf.ColumnFile(str(bad))
    # a header whose offset + nbytes wraps uint64
    evil = tmp_path / "evil.dkcol"
    name, dtype = b"x", b"<f4"
    header = struct.pack("<I", 1)
    header += struct.pack("<I", len(name)) + name
    header += struct.pack("<I", len(dtype)) + dtype
    header += struct.pack("<I", 1) + struct.pack("<q", 4)
    header += struct.pack("<QQ", 0xFFFFFFFFFFFFF000, 0x2000)
    evil.write_bytes(b"DKCOL1\0\0" + header + b"\x00" * 64)
    with pytest.raises(OSError, match="corrupt"):
        tcf.ColumnFile(str(evil))


def test_out_of_core_epoch_bounded_anonymous_memory(tmp_path):
    """Train through a file larger than the feed's chunks: the process's
    anonymous memory (what a copy of the dataset would grow) stays well
    under the file's size; mapped file pages do not count."""
    import gc
    import threading

    from distkeras_torch import Dataset, ModelSpec, SingleTrainer

    def rss_anon_kb():
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("RssAnon"):
                    return int(line.split()[1])
        return 0  # pragma: no cover - non-Linux

    rows, feat, file_mb = 8192, 1024, 32
    rng = np.random.default_rng(0)
    path = str(tmp_path / "big.dkcol")
    tcf.write_columns(path, {
        "features": rng.normal(size=(rows, feat)).astype(np.float32),
        "label": np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=rows)],
    })
    spec = ModelSpec(name="mlp", config={"hidden_sizes": (8,), "num_outputs": 4},
                     input_shape=(feat,))
    kw = dict(batch_size=64, num_epoch=1, learning_rate=0.1, chunk_windows=8, device="cpu")
    # warm the trainer's code paths before the baseline sample
    warm = Dataset({"features": rng.normal(size=(512, feat)).astype(np.float32),
                    "label": np.eye(4, dtype=np.float32)[rng.integers(0, 4, 512)]})
    SingleTrainer(spec, **kw).train(warm, shuffle=True)
    del warm
    gc.collect()
    base_kb = rss_anon_kb()
    peak = [base_kb]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], rss_anon_kb())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        with tcf.ColumnFile(path) as cf:
            tr = SingleTrainer(spec, **kw)
            tr.train(cf.dataset(), shuffle=True)
    finally:
        stop.set()
        t.join(timeout=5)
    grew_mb = (peak[0] - base_kb) / 1024
    assert np.isfinite(tr.history).all()
    assert grew_mb < file_mb / 2, f"anonymous memory grew {grew_mb:.1f} MB"
