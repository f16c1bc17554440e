"""DKCOL columnar container: out-of-core datasets mapped into the process.

Counterpart of ``distkeras_tpu/data/colfile.py``: the same ``DKCOL1``
format, so a file written by either package loads in the other.  The
repo's C++ loader (``native/data_loader.cpp``) is built with ``g++`` into
``distkeras_torch/_build/`` at first use, as ``runtime/native.py`` builds
the hub, and bound with ``ctypes``: columns come back as zero-copy numpy
views over the mapping, an optional background thread warms the page
cache, and the chunked feed advises the next chunk's byte range while the
current one trains.  When ``g++`` is missing or fails, the container loads
through numpy's ``np.memmap`` with the same semantics (no warm thread, no
advice), as in the JAX package: host code, not a fallback of a kernel.

Format (little-endian): 8-byte magic ``DKCOL1\\0\\0``, u32 ncols, then per
column ``u32 name_len, name, u32 dtype_len, dtype(np .str), u32 ndim,
ndim*i64 dims, u64 offset (64-aligned), u64 nbytes``, then the data blobs.

Usage::

    write_columns("train.dkcol", {"features": x, "label": y})
    ds = ColumnFile("train.dkcol").dataset()   # the port's Dataset of views
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from distkeras_torch.data.dataset import Dataset

SOURCE = Path(__file__).resolve().parents[2] / "native" / "data_loader.cpp"
MAGIC = b"DKCOL1\0\0"
_ALIGN = 64

_LOCK = threading.Lock()
_LIB: List[Optional[ctypes.CDLL]] = []   # the loaded library, or None once a build failed


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.dk_dl_open.restype = c.c_void_p
    lib.dk_dl_open.argtypes = [c.c_char_p, c.c_int]
    lib.dk_dl_error.restype = c.c_char_p
    lib.dk_dl_close.argtypes = [c.c_void_p]
    lib.dk_dl_release.argtypes = [c.c_void_p]
    lib.dk_dl_ncols.restype = c.c_int32
    lib.dk_dl_ncols.argtypes = [c.c_void_p]
    lib.dk_dl_col_name.restype = c.c_char_p
    lib.dk_dl_col_name.argtypes = [c.c_void_p, c.c_int32]
    lib.dk_dl_col_dtype.restype = c.c_char_p
    lib.dk_dl_col_dtype.argtypes = [c.c_void_p, c.c_int32]
    lib.dk_dl_col_ndim.restype = c.c_int32
    lib.dk_dl_col_ndim.argtypes = [c.c_void_p, c.c_int32]
    lib.dk_dl_col_dim.restype = c.c_int64
    lib.dk_dl_col_dim.argtypes = [c.c_void_p, c.c_int32, c.c_int32]
    lib.dk_dl_col_nbytes.restype = c.c_int64
    lib.dk_dl_col_nbytes.argtypes = [c.c_void_p, c.c_int32]
    lib.dk_dl_col_data.restype = c.c_void_p
    lib.dk_dl_col_data.argtypes = [c.c_void_p, c.c_int32]
    lib.dk_dl_prefetch.argtypes = [c.c_void_p, c.c_int32, c.c_int64, c.c_int64]
    lib.dk_dl_warmed_bytes.restype = c.c_int64
    lib.dk_dl_warmed_bytes.argtypes = [c.c_void_p]


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loader's library, built on the first call; None when ``g++``
    cannot build it (the reason is printed once)."""
    from distkeras_torch.runtime.native import build_shared_library

    with _LOCK:
        if not _LIB:
            try:
                lib = ctypes.CDLL(str(build_shared_library(SOURCE, "data_loader")))
                _bind(lib)
            except (OSError, RuntimeError) as e:
                print(f"DKCOL native loader unavailable, reading through np.memmap: {e}",
                      file=sys.stderr)
                lib = None
            _LIB.append(lib)
        return _LIB[0]


def native_loader_available() -> bool:
    return _load_lib() is not None


def write_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write a DKCOL container (atomic: tmp file + rename)."""
    cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
    header = bytearray()
    header += struct.pack("<I", len(cols))
    # compute offsets after a first pass to know the header size
    metas = []
    for name, arr in cols.items():
        nb = name.encode("utf-8")
        db = arr.dtype.str.encode("utf-8")
        metas.append((nb, db, arr))
    fixed = len(MAGIC) + 4
    for nb, db, arr in metas:
        fixed += 4 + len(nb) + 4 + len(db) + 4 + 8 * arr.ndim + 8 + 8
    offset = (fixed + _ALIGN - 1) // _ALIGN * _ALIGN
    placed = []
    for nb, db, arr in metas:
        placed.append(offset)
        offset = (offset + arr.nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    for (nb, db, arr), off in zip(metas, placed):
        header += struct.pack("<I", len(nb)) + nb
        header += struct.pack("<I", len(db)) + db
        header += struct.pack("<I", arr.ndim)
        header += struct.pack(f"<{arr.ndim}q", *arr.shape)
        header += struct.pack("<QQ", off, arr.nbytes)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(bytes(header))
        for (nb, db, arr), off in zip(metas, placed):
            f.seek(off)
            arr.tofile(f)  # streams the buffer; no transient full copy
    os.replace(tmp, path)


class ColumnFile:
    """Open a DKCOL container; columns are zero-copy views of the mapping.

    ``warm=True`` starts the native background page-warm thread.  Loads
    through ``np.memmap`` when the native loader cannot be built.
    """

    def __init__(self, path: str, warm: bool = False):
        self.path = path
        self._handle = None
        self._lib = _load_lib()
        self._cols: Dict[str, np.ndarray] = {}
        self._col_index: Dict[str, int] = {}
        self.native = self._lib is not None
        if self.native:
            self._open_native(warm)
        else:
            self._open_fallback()

    def _open_native(self, warm: bool) -> None:
        lib = self._lib
        handle = lib.dk_dl_open(self.path.encode("utf-8"), int(warm))
        if not handle:
            raise OSError(f"native loader failed: {lib.dk_dl_error().decode()}")
        self._handle = handle
        for i in range(lib.dk_dl_ncols(handle)):
            name = lib.dk_dl_col_name(handle, i).decode()
            dtype = np.dtype(lib.dk_dl_col_dtype(handle, i).decode())
            shape = tuple(lib.dk_dl_col_dim(handle, i, j)
                          for j in range(lib.dk_dl_col_ndim(handle, i)))
            nbytes = lib.dk_dl_col_nbytes(handle, i)
            if any(d < 0 for d in shape) or \
                    int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != nbytes:
                # no views escaped yet: a full close (munmap) is safe here,
                # unlike the keep-mapped release used once views exist
                lib.dk_dl_close(handle)
                raise OSError(f"corrupt DKCOL header: column {name!r} dims {shape} "
                              f"disagree with nbytes {nbytes}")
            addr = lib.dk_dl_col_data(handle, i)
            buf = (ctypes.c_char * nbytes).from_address(addr)
            arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
            arr.flags.writeable = False
            self._cols[name] = arr
            self._col_index[name] = i

    def _open_fallback(self) -> None:
        size = os.path.getsize(self.path)
        try:
            with open(self.path, "rb") as f:
                if f.read(8) != MAGIC:
                    raise OSError(f"{self.path} is not a DKCOL1 container")
                (ncols,) = struct.unpack("<I", f.read(4))
                if ncols > 4096:
                    raise OSError("corrupt DKCOL header: column count")
                for i in range(ncols):
                    (nlen,) = struct.unpack("<I", f.read(4))
                    if nlen > 4096:  # same caps as the native loader, so a
                        raise OSError("corrupt DKCOL header: name length")
                    name = f.read(nlen).decode()
                    (dlen,) = struct.unpack("<I", f.read(4))
                    if dlen > 64:  # flipped byte can't trigger a huge read
                        raise OSError("corrupt DKCOL header: dtype length")
                    dtype = np.dtype(f.read(dlen).decode())
                    (ndim,) = struct.unpack("<I", f.read(4))
                    if ndim > 32:
                        raise OSError("corrupt DKCOL header: ndim")
                    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
                    off, nbytes = struct.unpack("<QQ", f.read(16))
                    # same validation contract as the native loader
                    if off > size or nbytes > size - off:
                        raise OSError("corrupt DKCOL header: column out of bounds")
                    if any(d < 0 for d in shape) or \
                            int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != nbytes:
                        raise OSError("corrupt DKCOL header: dims/nbytes mismatch")
                    self._cols[name] = np.memmap(self.path, dtype=dtype, mode="r",
                                                 offset=off, shape=tuple(shape))
                    self._col_index[name] = i
        except (struct.error, UnicodeDecodeError, TypeError, ValueError,
                OverflowError) as e:
            raise OSError(f"corrupt DKCOL header: {e}") from None

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def dataset(self) -> Dataset:
        """The port's ``Dataset`` over the zero-copy views; its chunked
        feeding advises the next chunk's pages through the native hook."""
        return _PrefetchingDataset(self._cols, self)

    def prefetch(self, name: str, start_row: int, num_rows: int) -> None:
        """Advise the kernel to fault in rows [start, start+num) of a column
        (no-op on the fallback path — memmap still works, just lazily)."""
        if not self.native or self._handle is None:
            return  # fallback, or closed: memmap/page cache still works lazily
        arr = self._cols[name]
        row_bytes = arr.dtype.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64))
        self._lib.dk_dl_prefetch(self._handle, self._col_index[name],
                                 start_row * row_bytes, num_rows * row_bytes)

    def warmed_bytes(self) -> int:
        if not self.native or self._handle is None:
            return 0
        return int(self._lib.dk_dl_warmed_bytes(self._handle))

    def close(self) -> None:
        """Stop the warm thread and close the fd.  The MAPPING stays alive
        for the process lifetime, so views/Datasets handed out earlier can
        never dangle (file-backed clean pages — the kernel reclaims them
        under pressure; the cost is address space, not RAM)."""
        if self.native and self._handle is not None:
            self._lib.dk_dl_release(self._handle)
            self._handle = None

    def __enter__(self) -> "ColumnFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _PrefetchingDataset(Dataset):
    """Dataset whose chunked feeding overlaps IO with compute: while chunk k
    trains, chunk k+1's pages are madvise'd in by the native loader.

    Out-of-core semantics differ from the in-RAM Dataset in one place:
    ``shuffle`` is CHUNK-LOCAL — rows are permuted inside each fed chunk
    (bounded memory; prefetch stays effective) instead of globally.  A
    global permutation would fancy-index every mapped column into a full
    in-RAM copy, the exact OOM this container exists to avoid; for a true
    global shuffle, load the data into a plain Dataset.  ``split`` is
    unsupported for the same reason — split at ``write_columns`` time.
    """

    def __init__(self, columns, colfile: ColumnFile, shuffle_seed: Optional[int] = None):
        super().__init__(columns)
        self._colfile = colfile
        self._shuffle_seed = shuffle_seed

    def shuffle(self, seed: int = 0) -> "_PrefetchingDataset":
        return _PrefetchingDataset(self._columns, self._colfile, shuffle_seed=seed)

    def split(self, fraction, seed=None):
        raise NotImplementedError(
            "split() on a mapped DKCOL dataset would materialize it; write "
            "separate train/test containers instead (write_columns twice)")

    def chunked_epoch(self, batch_size, columns, window=1, chunk_windows=None):
        per_window = batch_size * window
        num_windows = len(self) // per_window
        step = num_windows if chunk_windows is None else int(chunk_windows)
        rng = (np.random.default_rng(self._shuffle_seed)
               if self._shuffle_seed is not None else None)
        for i, chunk in enumerate(super().chunked_epoch(
                batch_size, columns, window=window, chunk_windows=chunk_windows)):
            nxt = (i + 1) * step
            if nxt < num_windows:
                n = min(step, num_windows - nxt)
                for c in columns:
                    if c in self._colfile._col_index:
                        self._colfile.prefetch(c, nxt * per_window, n * per_window)
            if rng is not None:
                # chunk-local shuffle: one permutation of the chunk's rows,
                # applied identically to every column (the copy is bounded
                # by the chunk size, which is the point of chunking)
                n_rows = chunk[columns[0]].shape[0] * window * batch_size
                perm = rng.permutation(n_rows)
                chunk = {
                    c: v.reshape((n_rows,) + v.shape[3:])[perm].reshape(v.shape)
                    for c, v in chunk.items()
                }
            yield chunk
