"""ctypes binding of the C++ parameter-server hub (``native/ps_server.cpp``).

The port's own binding of the repo's C++ hub: the source is compiled on
first use with ``g++`` and the JAX package's flags (``-ffp-contract=off``
keeps the apply a separate multiply and add, numpy's float32 sequence, so
this hub and the Python hub move the center to the same bits) into
``distkeras_torch/_build/``, named by a hash of the source, and loaded
with ``ctypes``.  There is no fallback: a failed build raises with the
compiler's output.

:class:`NativeParameterServer` has the core surface of the Python hub
(``runtime/parameter_server.py``): ``start`` / ``stop`` / ``port`` /
``get_weights`` / ``num_updates`` and the in-process pair ``pull_direct`` /
``commit_direct``.  Its socket side speaks the same wire protocol, and its
ctypes calls release the GIL while the hub copies and applies.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch._build import BUILD_DIR
from distkeras_torch.runtime import networking as net
from distkeras_torch.runtime.parameter_server import _reject

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ps_server.cpp"
BUILD_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", "-ffp-contract=off"]

MODE_DELTA = 0   # center += d              (DOWNPOUR, elastic)
MODE_ADAG = 1    # center += d / num_workers
MODE_DYNSGD = 2  # center += d / (staleness + 1)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the hub's library is (or will be) built: named by the digest of
    the source and of the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(BUILD_FLAGS).encode())
    return BUILD_DIR / f"libps_server_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the hub if its library is missing; raise with the
    compiler's output (also printed) when ``g++`` fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native hub source not found: {SOURCE}")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: a concurrent builder never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *BUILD_FLAGS, str(SOURCE), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build the native hub: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        print(proc.stderr, file=sys.stderr)
        raise RuntimeError(f"g++ failed to build the native hub (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    lib.dk_ps_create.restype = ctypes.c_void_p
    lib.dk_ps_create.argtypes = [
        ctypes.c_int, ctypes.c_int, P(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, P(ctypes.c_int32), P(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int64]
    lib.dk_ps_start.restype = ctypes.c_int
    lib.dk_ps_start.argtypes = [ctypes.c_void_p]
    lib.dk_ps_stop.argtypes = [ctypes.c_void_p]
    lib.dk_ps_port.restype = ctypes.c_int
    lib.dk_ps_port.argtypes = [ctypes.c_void_p]
    lib.dk_ps_get_weights.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_set_weights.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_num_updates.restype = ctypes.c_int64
    lib.dk_ps_num_updates.argtypes = [ctypes.c_void_p]
    lib.dk_ps_pull.restype = ctypes.c_int64
    lib.dk_ps_pull.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_commit.restype = ctypes.c_int
    lib.dk_ps_commit.argtypes = [ctypes.c_void_p, P(ctypes.c_float), ctypes.c_int64]
    lib.dk_ps_destroy.argtypes = [ctypes.c_void_p]


def load() -> ctypes.CDLL:
    """The loaded hub library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _LIB = lib
        return _LIB


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeParameterServer:
    """The C++ hub with the Python hub's core interface.  ``mode`` is the
    commit rule (``MODE_DELTA`` / ``MODE_ADAG`` / ``MODE_DYNSGD``)."""

    def __init__(self, weights: Sequence[np.ndarray], mode: int = MODE_DELTA,
                 num_workers: int = 1, port: int = 0, elastic: bool = False,
                 idle_timeout: Optional[float] = 300.0,
                 snapshot_dir: Optional[str] = None, restore: bool = False,
                 shard_id: Optional[int] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 sparse_leaves: Sequence[int] = (), adaptive: bool = False,
                 shm_dir: Optional[str] = None, recv_batch_depth: int = 0):
        _reject(elastic=(elastic, False), snapshot_dir=(snapshot_dir, None),
                restore=(restore, False), shard_id=(shard_id, None),
                replica_of=(replica_of, None), sparse_leaves=(tuple(sparse_leaves), ()),
                adaptive=(adaptive, False), shm_dir=(shm_dir, None),
                recv_batch_depth=(recv_batch_depth, 0))
        lib = load()
        self._lib = lib
        self._templates = [np.array(w, dtype=np.float32) for w in weights]
        sizes = (ctypes.c_int64 * len(self._templates))(*[t.size for t in self._templates])
        no_sparse_idx = (ctypes.c_int32 * 1)(0)
        no_sparse_dim = (ctypes.c_int64 * 1)(0)
        idle_ms = 0 if idle_timeout is None else max(1, int(idle_timeout * 1000))
        self._handle = lib.dk_ps_create(int(port), len(self._templates), sizes, int(mode),
                                        int(num_workers), 0, idle_ms, 0, no_sparse_idx,
                                        no_sparse_dim, 0,
                                        int(net.max_request_payload(self._templates)))
        if not self._handle:
            raise RuntimeError("dk_ps_create failed")
        flat = (np.concatenate([t.reshape(-1) for t in self._templates])
                if self._templates else np.zeros(0, np.float32))
        self._total = int(flat.size)
        lib.dk_ps_set_weights(self._handle, _f32p(flat))
        self.port = -1
        self._started = False

    def start(self) -> None:
        port = self._lib.dk_ps_start(self._handle)
        if port < 0:
            raise RuntimeError("native hub failed to bind")
        self.port = port
        self._started = True

    def stop(self) -> None:
        if self._started:
            self._lib.dk_ps_stop(self._handle)
            self._started = False

    def _split(self, flat: np.ndarray, copy: bool) -> List[np.ndarray]:
        out, off = [], 0
        for t in self._templates:
            leaf = flat[off:off + t.size].reshape(t.shape)
            out.append(leaf.copy() if copy else leaf)
            off += t.size
        return out

    def get_weights(self) -> List[np.ndarray]:
        out = np.zeros(self._total, np.float32)
        self._lib.dk_ps_get_weights(self._handle, _f32p(out))
        return self._split(out, copy=True)

    def pull_direct(self) -> Tuple[List[np.ndarray], int]:
        """(center copy, clock at the copy), as the Python hub's."""
        flat = np.empty(self._total, np.float32)
        clock = int(self._lib.dk_ps_pull(self._handle, _f32p(flat)))
        return self._split(flat, copy=False), clock

    def commit_direct(self, delta: Sequence[np.ndarray], last_pull_clock: int) -> None:
        if len(delta) != len(self._templates):
            raise ValueError(f"commit has {len(delta)} tensors, center has "
                             f"{len(self._templates)}")
        parts = []
        for d, t in zip(delta, self._templates):
            a = np.ascontiguousarray(d, dtype=np.float32).reshape(-1)
            if a.size != t.size:
                raise ValueError(f"commit tensor size {a.size} != center size {t.size}")
            parts.append(a)
        flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        rc = int(self._lib.dk_ps_commit(self._handle, _f32p(flat), int(last_pull_clock)))
        if rc != 0:
            raise RuntimeError(f"the native hub refused a commit (code {rc})")

    @property
    def num_updates(self) -> int:
        return int(self._lib.dk_ps_num_updates(self._handle))

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self.stop()
                self._lib.dk_ps_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
