"""ctypes binding of the C++ parameter-server hub (``native/ps_server.cpp``).

The port's own binding of the repo's C++ hub: the source is compiled on
first use with ``g++`` and the JAX package's flags (``-ffp-contract=off``
keeps the apply a separate multiply and add, numpy's float32 sequence, so
this hub and the Python hub move the center to the same bits) into
``distkeras_torch/_build/``, named by a hash of the source, and loaded
with ``ctypes``.  There is no fallback: a failed build raises with the
compiler's output.

:class:`NativeParameterServer` has the surface of the Python hub
(``runtime/parameter_server.py``): ``start`` / ``stop`` / ``kill`` /
``port`` / ``get_weights`` / ``num_updates`` / ``live_workers``, the
in-process pair ``pull_direct`` / ``commit_direct``, snapshots
(``snapshot_dir``, ``restore``, ``snapshot_state`` / ``restore_state``, the
C++ hub's clock fence), elastic ADAG and the hot standby (``replica_of``,
``is_standby``, ``promoted``, ``wait_synced``, ``promote``; the C++ hub
runs the feed thread and the promotion).  Its socket side speaks the same
wire protocol, the shared-memory attach (action ``Z``) and the replication
feed (action ``R``) included, and its ctypes calls release the GIL while
the hub copies and applies.  The
standalone ring handles (``dk_shm_ring_*``) drive the C++ hub's own ring
code, which shares one file layout with ``networking.ShmFrameRing``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import subprocess
import sys
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def shared_library_path(source: Path, stem: str, flags=BUILD_FLAGS) -> Path:
    """Where ``g++`` puts the library of ``source``: ``_build/lib<stem>_<h>.so``,
    ``h`` the digest of the source and of the flags."""
    h = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_shared_library(source: Path, stem: str, flags=BUILD_FLAGS) -> Path:
    """Compile a C++ source of ``native/`` with ``g++`` if its library is
    missing; raise with the compiler's output (also printed) when it
    fails."""
    if not source.exists():
        raise RuntimeError(f"native source not found: {source}")
    out = shared_library_path(source, stem, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: a concurrent builder never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, str(source), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build {source.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        print(proc.stderr, file=sys.stderr)
        raise RuntimeError(f"g++ failed to build {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """Where the hub's library is (or will be) built."""
    return shared_library_path(SOURCE, "ps_server")


def build() -> Path:
    """Compile the hub if its library is missing (see
    :func:`build_shared_library`)."""
    return build_shared_library(SOURCE, "ps_server")


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    lib.dk_ps_create.restype = ctypes.c_void_p
    lib.dk_ps_create.argtypes = [
        ctypes.c_int, ctypes.c_int, P(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, P(ctypes.c_int32), P(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int64]
    lib.dk_ps_set_replica_of.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.dk_ps_restore.argtypes = [ctypes.c_void_p, P(ctypes.c_float), ctypes.c_int64,
                                  ctypes.c_int64]
    lib.dk_ps_snapshot.restype = ctypes.c_int64
    lib.dk_ps_snapshot.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_is_standby.restype = ctypes.c_int
    lib.dk_ps_is_standby.argtypes = [ctypes.c_void_p]
    lib.dk_ps_promoted.restype = ctypes.c_int
    lib.dk_ps_promoted.argtypes = [ctypes.c_void_p]
    lib.dk_ps_promoted_at_clock.restype = ctypes.c_int64
    lib.dk_ps_promoted_at_clock.argtypes = [ctypes.c_void_p]
    lib.dk_ps_promote.restype = ctypes.c_int
    lib.dk_ps_promote.argtypes = [ctypes.c_void_p]
    lib.dk_ps_wait_synced.restype = ctypes.c_int
    lib.dk_ps_wait_synced.argtypes = [ctypes.c_void_p, ctypes.c_int64]
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
    lib.dk_ps_stats.argtypes = [ctypes.c_void_p, P(ctypes.c_int64)]
    lib.dk_ps_destroy.argtypes = [ctypes.c_void_p]
    # the shared-memory transport: the hub's attach switch, and the ring
    # code it serves with, as standalone handles
    lib.dk_ps_shm_attach.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dk_shm_ring_create.restype = ctypes.c_void_p
    lib.dk_shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64]
    lib.dk_shm_ring_open.restype = ctypes.c_void_p
    lib.dk_shm_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dk_shm_ring_write.restype = ctypes.c_longlong
    lib.dk_shm_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int]
    lib.dk_shm_ring_read.restype = ctypes.c_longlong
    lib.dk_shm_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int]
    lib.dk_shm_ring_close.argtypes = [ctypes.c_void_p]
    lib.dk_shm_ring_destroy.argtypes = [ctypes.c_void_p]


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


# the slots of dk_ps_stats (native/ps_server.cpp StatSlot), of which the
# binding reads live_workers
_STAT_SLOTS = 28
_STAT_LIVE_WORKERS = 5


class NativeParameterServer:
    """The C++ hub with the Python hub's interface.  ``mode`` is the
    commit rule (``MODE_DELTA`` / ``MODE_ADAG`` / ``MODE_DYNSGD``).

    ``shm_dir`` arms the hub's ``Z`` attach (ring files under it);
    ``shard_id`` names the shard of a sharded deployment.
    ``recv_batch_depth`` is taken as the Python hub takes it, and turns
    nothing here: the C++ receive loop already drains a connection's
    queued frames with one ``recv`` a wake-up into its growing buffer.
    ``elastic=True`` divides ADAG commits by the live committers.
    ``snapshot_dir`` attaches a
    :class:`~distkeras_torch.runtime.parameter_server.HubSnapshotter` and
    ``restore=True`` loads the newest snapshot before serving, the fence
    armed in C++.  ``replica_of`` starts the hub as a standby of that
    primary (the C++ feed thread, promotion on feed loss or a first
    commit); an ``R`` hello from a peer attaches it to this hub's own feed
    as a primary."""

    def __init__(self, weights: Sequence[np.ndarray], mode: int = MODE_DELTA,
                 num_workers: int = 1, port: int = 0, elastic: bool = False,
                 idle_timeout: Optional[float] = 300.0,
                 snapshot_dir: Optional[str] = None, snapshot_interval: float = 30.0,
                 snapshot_keep: int = 3, restore: bool = False,
                 shard_id: Optional[int] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 replica_feed_retries: int = 3, replica_feed_backoff: float = 0.2,
                 sparse_leaves: Sequence[int] = (), adaptive: bool = False,
                 shm_dir: Optional[str] = None, recv_batch_depth: int = 0):
        _reject(sparse_leaves=(tuple(sparse_leaves), ()), adaptive=(adaptive, False))
        if restore and snapshot_dir is None:
            raise ValueError("restore=True requires snapshot_dir")
        lib = load()
        self._lib = lib
        self._templates = [np.array(w, dtype=np.float32) for w in weights]
        sizes = (ctypes.c_int64 * len(self._templates))(*[t.size for t in self._templates])
        no_sparse_idx = (ctypes.c_int32 * 1)(0)
        no_sparse_dim = (ctypes.c_int64 * 1)(0)
        idle_ms = 0 if idle_timeout is None else max(1, int(idle_timeout * 1000))
        self._handle = lib.dk_ps_create(int(port), len(self._templates), sizes, int(mode),
                                        int(num_workers), 1 if elastic else 0, idle_ms, 0,
                                        no_sparse_idx, no_sparse_dim, 0,
                                        int(net.max_request_payload(self._templates)))
        if not self._handle:
            raise RuntimeError("dk_ps_create failed")
        self.elastic = bool(elastic)
        self.replica_of = (None if replica_of is None
                           else (str(replica_of[0]), int(replica_of[1])))
        if self.replica_of is not None:
            host = self.replica_of[0]
            if host in ("", "0.0.0.0"):
                host = "127.0.0.1"
            # the C++ dialer takes numeric addresses: resolve a name here,
            # loudly, rather than run a standby that never syncs
            try:
                host = socket.gethostbyname(host)
            except OSError as e:
                raise ValueError(f"replica_of host {self.replica_of[0]!r} does not "
                                 f"resolve: {e}") from e
            lib.dk_ps_set_replica_of(self._handle, host.encode("utf-8"),
                                     int(self.replica_of[1]), int(replica_feed_retries),
                                     max(1, int(float(replica_feed_backoff) * 1000)))
        flat = (np.concatenate([t.reshape(-1) for t in self._templates])
                if self._templates else np.zeros(0, np.float32))
        self._total = int(flat.size)
        lib.dk_ps_set_weights(self._handle, _f32p(flat))
        self.shard_id = None if shard_id is None else int(shard_id)
        self.shm_dir = None if shm_dir is None else str(shm_dir)
        if self.shm_dir is not None:
            os.makedirs(self.shm_dir, exist_ok=True)
            lib.dk_ps_shm_attach(self._handle, self.shm_dir.encode("utf-8"))
        self.recv_batch_depth = max(0, int(recv_batch_depth))
        self.port = -1
        self._started = False
        self._restore = bool(restore)
        self.snapshotter = None
        if snapshot_dir is not None:
            from distkeras_torch.runtime.parameter_server import HubSnapshotter

            self.snapshotter = HubSnapshotter(self, snapshot_dir, interval=snapshot_interval,
                                              keep=snapshot_keep)

    def start(self) -> None:
        if self._restore and self.snapshotter is not None:
            # the Python hub's rule: snapshots present but unreadable stop
            # the hub; an empty directory is a first boot
            if not self.snapshotter.restore_latest():
                if self.snapshotter.checkpointer.all_steps():
                    raise RuntimeError(
                        f"restore requested: snapshots exist in "
                        f"{self.snapshotter.checkpointer.directory} but none is readable "
                        f"(see warnings)")
                warnings.warn("restore requested but no snapshot exists yet; "
                              "serving initial weights")
        port = self._lib.dk_ps_start(self._handle)
        if port < 0:
            raise RuntimeError("native hub failed to bind")
        self.port = port
        self._started = True
        if self.snapshotter is not None:
            self.snapshotter.start()

    def stop(self) -> None:
        """Stop serving, with a final snapshot when ``snapshot_dir`` is set."""
        self._shutdown(final_snapshot=True)

    def kill(self) -> None:
        """Tear down as a crash would: no final snapshot."""
        self._shutdown(final_snapshot=False)

    def _shutdown(self, final_snapshot: bool) -> None:
        if self._started:
            if self.snapshotter is not None:
                self.snapshotter.stop(final_snapshot=final_snapshot)
            self._lib.dk_ps_stop(self._handle)
            self._started = False

    # -- hot standby ---------------------------------------------------------------
    def is_standby(self) -> bool:
        """True while the hub tracks its primary and has not been promoted."""
        return bool(self._lib.dk_ps_is_standby(self._handle))

    @property
    def promoted(self) -> bool:
        return bool(self._lib.dk_ps_promoted(self._handle))

    @property
    def promoted_at_clock(self) -> Optional[int]:
        v = int(self._lib.dk_ps_promoted_at_clock(self._handle))
        return None if v < 0 else v

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        """Block until the standby applied its first full sync (True) or
        ``timeout`` passed (False)."""
        ms = -1 if timeout is None else max(0, int(timeout * 1000))
        return bool(self._lib.dk_ps_wait_synced(self._handle, ms))

    def promote(self, reason: str = "manual") -> bool:
        """Make the standby the primary (fence at its clock); idempotent,
        True if this call promoted."""
        performed = bool(self._lib.dk_ps_promote(self._handle))
        if performed:
            warnings.warn(f"native replica hub promoting to primary at clock "
                          f"{self.promoted_at_clock}: {reason}")
        return performed

    # -- durability -----------------------------------------------------------------
    def snapshot_state(self) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """``(center copy, state)`` in one view taken under the C++ hub's gate."""
        flat = np.empty(self._total, np.float32)
        clock = int(self._lib.dk_ps_snapshot(self._handle, _f32p(flat)))
        return self._split(flat, copy=True), {"clock": clock,
                                              "num_updates": int(self.num_updates)}

    def restore_state(self, center: Sequence[np.ndarray], state: Dict[str, Any]) -> None:
        """Load a snapshot; the C++ hub resumes its clock and arms the fence."""
        if len(center) != len(self._templates):
            raise ValueError(f"snapshot has {len(center)} tensors, center has "
                             f"{len(self._templates)}")
        parts = [np.ascontiguousarray(c, np.float32).reshape(-1) for c in center]
        flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        if flat.size != self._total:
            raise ValueError(f"snapshot has {flat.size} values, center has {self._total}")
        self._lib.dk_ps_restore(self._handle, _f32p(flat), int(state.get("clock", 0)),
                                int(state.get("num_updates", 0)))

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
        if self.is_standby() and not self._lib.dk_ps_wait_synced(self._handle, 0):
            raise RuntimeError("pull_direct from a never-synced standby refused (it holds "
                               "no job state yet); wait_synced() first")
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
        if rc == 1:
            raise RuntimeError("commit_direct into a never-synced standby refused (it has no "
                               "state to take over); wait_synced() first")
        if rc == 2:
            raise net.ProtocolError("commit into a standby refused (not promoted yet; "
                                    "verifying the primary — retry)")
        if rc != 0:
            raise RuntimeError(f"the native hub refused a commit (code {rc})")

    @property
    def num_updates(self) -> int:
        return int(self._lib.dk_ps_num_updates(self._handle))

    def live_workers(self) -> int:
        """Connections that committed and are still open (the C++ hub's
        count, with its idle eviction)."""
        out = (ctypes.c_int64 * _STAT_SLOTS)()
        self._lib.dk_ps_stats(self._handle, out)
        return int(out[_STAT_LIVE_WORKERS])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self.stop()
                self._lib.dk_ps_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
