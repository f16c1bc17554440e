"""Job deployment: the reference's ``Punchcard`` service and ``Job`` client.

Counterpart of ``distkeras_tpu/runtime/job_deployment.py``, wire-identical:
a ``Job`` of either package submits to a daemon of either package, and the
model blobs it fetches are the JAX package's blob format (``Model.serialize``),
which either package reads.  The same protocol version, frame limits, HMAC
challenge, job lifecycle, spool directory with its lock, reload and
eviction.  The daemon owns its device (the card unless ``device="cpu"``) and
passes it to every trainer it builds; the trainer registry points at this
package's trainers.  The telemetry pull (metrics, Prometheus text, trace,
fleet and health) answers with the JAX daemon's keys, read from this
package's own observability registry, tracer and health collector.

- Transport is the framed JSON/tensor protocol (``runtime/networking.py``)
  — no pickle, no Flask.  Control messages are JSON frames; inline
  datasets and trained models travel as raw frames.
- Auth is HMAC-SHA256 challenge/response: the server sends a fresh nonce
  per connection and the client proves possession of the shared secret
  without the secret (or a replayable token) ever crossing the wire.
- The service owns the card, so jobs run FIFO on one executor thread.
- Datasets arrive either inline (tensor frame, schema in the job JSON) or
  as a server-side ``.npz`` path confined to the daemon's ``data_root``.

Typical use::

    pc = Punchcard(secret="s3cret", data_root="/data")   # on the GPU host
    pc.start()

    job = Job(host, pc.port, secret="s3cret", name="mnist",
              model=spec, trainer="adag",
              trainer_kwargs={"num_epoch": 5, "batch_size": 64},
              data=train_ds)                              # anywhere
    model = job.run()                                     # submit+wait+fetch
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import queue
import secrets as _secrets
import shutil
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from distkeras_torch import observability as obs
from distkeras_torch.platform import DeviceLike, resolve_device
from distkeras_torch.runtime import networking as net

PROTOCOL_VERSION = 1

# frame-size bounds: before auth only a tiny hello/auth message is legal;
# after auth, control JSON stays small; bulk tensor frames get their own cap
AUTH_FRAME_LIMIT = 64 * 1024
CTRL_FRAME_LIMIT = 8 * (1 << 20)
DATA_FRAME_LIMIT = 8 * (1 << 30)

# job lifecycle
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

# single source for name validation AND the late-import registry (the
# trainers import the models and the engine only when a job runs)
_TRAINER_PATHS = {
    "single": ("distkeras_torch.trainers", "SingleTrainer"),
    "adag": ("distkeras_torch.trainers", "ADAG"),
    "downpour": ("distkeras_torch.trainers", "DOWNPOUR"),
    "aeasgd": ("distkeras_torch.trainers", "AEASGD"),
    "eamsgd": ("distkeras_torch.trainers", "EAMSGD"),
    "dynsgd": ("distkeras_torch.trainers", "DynSGD"),
    "averaging": ("distkeras_torch.trainers", "AveragingTrainer"),
    "ensemble": ("distkeras_torch.trainers", "EnsembleTrainer"),
    "async-adag": ("distkeras_torch.runtime.async_trainer", "AsyncADAG"),
    "async-downpour": ("distkeras_torch.runtime.async_trainer", "AsyncDOWNPOUR"),
    "async-aeasgd": ("distkeras_torch.runtime.async_trainer", "AsyncAEASGD"),
    "async-eamsgd": ("distkeras_torch.runtime.async_trainer", "AsyncEAMSGD"),
    "async-dynsgd": ("distkeras_torch.runtime.async_trainer", "AsyncDynSGD"),
}
_TRAINER_NAMES = tuple(_TRAINER_PATHS)

def _trainer_registry() -> Dict[str, Any]:
    import importlib

    return {name: getattr(importlib.import_module(mod), attr)
            for name, (mod, attr) in _TRAINER_PATHS.items()}


def _mac(secret: str, nonce: str) -> str:
    return hmac.new(secret.encode("utf-8"), bytes.fromhex(nonce), hashlib.sha256).hexdigest()


class _FatalProtocolError(Exception):
    """The connection's byte stream is desynced; report once, then drop."""


class JobRecord:
    """Server-side state of one submitted job."""

    def __init__(self, job_id: str, job: Dict[str, Any]):
        self.job_id = job_id
        self.job = job
        self.state = QUEUED
        self.error: Optional[str] = None
        self.history: List[float] = []
        self.training_time: Optional[float] = None
        self.model_blobs: List[bytes] = []
        self.submitted_at = time.time()
        self.data: Optional[Dict[str, np.ndarray]] = None  # inline columns

    def public(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "name": self.job.get("name"),
            "trainer": self.job.get("trainer"),
            "state": self.state,
            "error": self.error,
            "history": self.history,
            "training_time": self.training_time,
            "num_models": len(self.model_blobs),
        }

    def manifest(self) -> Dict[str, Any]:
        """Everything needed to resurrect this record after a daemon
        restart EXCEPT bulk payloads (inline data -> data.npz, model blobs
        -> model_N.bin files beside the manifest)."""
        return {
            "job_id": self.job_id,
            "job": self.job,
            "state": self.state,
            "error": self.error,
            "history": self.history,
            "training_time": self.training_time,
            "num_models": len(self.model_blobs),
            "submitted_at": self.submitted_at,
        }

    @staticmethod
    def from_manifest(m: Dict[str, Any]) -> "JobRecord":
        rec = JobRecord(m["job_id"], m["job"])
        rec.state = m["state"]
        rec.error = m.get("error")
        rec.history = list(m.get("history") or [])
        rec.training_time = m.get("training_time")
        rec.submitted_at = m.get("submitted_at", time.time())
        return rec


class Punchcard:
    """The job-deployment daemon (reference: ``Punchcard`` service loop).

    One accept loop, one handler thread per connection, one FIFO executor
    thread (the card is a single resource).  ``port=0`` binds an ephemeral
    port, read it from ``self.port`` after ``start()``.  The daemon owns
    ``device`` (the card unless ``device="cpu"``) and every trainer it
    builds runs there, whatever a job's ``trainer_kwargs`` say.
    """

    def __init__(self, secret: str, host: str = "127.0.0.1", port: int = 0,
                 data_root: Optional[str] = None,
                 state_dir: Optional[str] = None, max_retained: int = 20,
                 device: DeviceLike = None):
        if not secret:
            raise ValueError("Punchcard requires a non-empty shared secret")
        self.device = resolve_device(device)
        self._secret = secret
        self._host = host
        self._port = port
        self._data_root = os.path.realpath(data_root) if data_root else None
        # durability (without it a restart loses the queue, the running
        # job, and every fetchable model): job records + payloads spool to
        # state_dir and the queue reloads on start().  Defaults to
        # <data_root>/.punchcard-state when a data_root exists; None (no
        # data_root, no explicit state_dir) stays RAM-only.
        if state_dir is None and self._data_root is not None:
            state_dir = os.path.join(self._data_root, ".punchcard-state")
        self._state_dir = os.path.realpath(state_dir) if state_dir else None
        self._max_retained = int(max_retained)
        self._jobs: Dict[str, JobRecord] = {}
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.Lock()
        # serializes all spool mutation (handler threads save on cancel
        # while the executor saves transitions; shared tmp paths must not
        # interleave) and freezes the spool after stop() so an orphaned
        # executor can't corrupt state a restarted daemon now owns
        self._spool_lock = threading.Lock()
        self._running = False
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle -------------------------------------------------------------
    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("Punchcard not started")
        return self._sock.getsockname()[1]

    def start(self) -> "Punchcard":
        # bind FIRST: a second daemon pointed at a live daemon's port must
        # die on EADDRINUSE before it can touch (and corrupt) the spool
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, self._port))
        self._sock.listen(16)
        try:
            self._acquire_spool_lock()
            self._running = True  # before reload: its saves must not be frozen
            self._reload_state()
        except BaseException:
            # a failed start must leak neither the bound port nor the lock
            self._running = False
            self._sock.close()
            self._sock = None
            self._release_spool_lock()
            raise
        for target in (self._accept_loop, self._executor_loop):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def _acquire_spool_lock(self) -> None:
        """Exclusive spool ownership: two daemons sharing a state_dir would
        double-run each other's jobs and rmtree records the other serves.
        The lock is a pidfile; a stale lock (holder dead, e.g. SIGKILL) is
        taken over, so crashes never brick restarts."""
        if self._state_dir is None:
            return
        os.makedirs(self._state_dir, exist_ok=True)
        path = os.path.join(self._state_dir, "daemon.lock")
        # the whole check-remove-create sequence holds an flock on a guard
        # file: without it two daemons racing a stale lock can BOTH read the
        # dead pid, and the slower one's os.remove() deletes the faster
        # one's freshly created pidfile (TOCTOU) — then both own the spool
        import fcntl

        try:
            # 0o666 (pre-umask) so another user of a SHARED state_dir can
            # still open the guard after this process dies — a 0600 guard
            # would permanently block the cross-user stale-lock takeover
            # the pidfile's EPERM handling explicitly supports
            guard = os.open(os.path.join(self._state_dir, ".lock-guard"),
                            os.O_CREAT | os.O_RDWR, 0o666)
            try:
                # os.open's mode is masked by umask (022 → 0644), which
                # would deny other users the O_RDWR open and silently
                # reopen the TOCTOU this guard closes; fchmod realizes the
                # intended world-RW bits (best-effort: may not own the file)
                os.fchmod(guard, 0o666)
            except OSError:
                pass
        except PermissionError:
            # a prior owner created the guard with a restrictive umask and
            # we can't open it: degrade to unguarded acquisition (the
            # O_EXCL pidfile still provides mutual exclusion; only the
            # stale-takeover race window reopens) rather than bricking
            # every other user's restart forever
            guard = None
        try:
            if guard is not None:
                fcntl.flock(guard, fcntl.LOCK_EX)
            while True:
                try:
                    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.write(fd, str(os.getpid()).encode())
                    os.close(fd)
                    self._lock_path = path  # lint: unguarded-ok start-time store, before the accept/executor threads exist; all later mutation goes through _release_spool_lock under _lock
                    return
                except FileExistsError:
                    try:
                        with open(path) as f:
                            holder = int(f.read().strip() or "0")
                    except (OSError, ValueError):
                        holder = 0
                    alive = False
                    if holder == os.getpid():
                        alive = True  # a second daemon in THIS process is still
                        #               a second daemon — reject it too
                    elif holder > 0:
                        try:
                            os.kill(holder, 0)
                            alive = True
                        except ProcessLookupError:
                            alive = False
                        except PermissionError:
                            alive = True  # EPERM means the pid EXISTS (another
                            #               user's daemon) — standard pidfile idiom
                    if alive:
                        raise RuntimeError(
                            f"state_dir {self._state_dir!r} is owned by a live "
                            f"Punchcard daemon (pid {holder}); two daemons must "
                            "not share a spool") from None
                    try:
                        os.remove(path)  # stale: holder is gone, take over
                    except FileNotFoundError:
                        pass
        finally:
            if guard is not None:
                try:
                    fcntl.flock(guard, fcntl.LOCK_UN)
                finally:
                    os.close(guard)

    def stop(self) -> None:
        self._running = False  # also freezes the spool (see _save_record)
        self._queue.put(None)  # wake the executor
        if self._sock is not None:
            # close() alone does NOT wake a concurrently-blocked accept()
            # on Linux; shutdown() makes it return EINVAL immediately, which
            # the join below needs now that lock release waits on the threads
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for th in self._threads:
            th.join(timeout=5)
        # release the pidfile only AFTER the executor thread confirmed exit:
        # dropping it while a job is still running would let a restarted
        # daemon requeue the spooled RUNNING record and execute it a second
        # time, concurrently, on the same devices.  If the join timed out the
        # lock stays for now (this pid is alive, so a takeover is correctly
        # refused) and the executor itself releases it when the job finally
        # ends (_executor_loop's exit path) — otherwise nothing ever would.
        if not any(th.is_alive() for th in self._threads):
            self._release_spool_lock()

    def _release_spool_lock(self) -> None:
        """Idempotent pidfile release; callable from stop() AND from the
        executor's own exit path (they may race after a timed-out join)."""
        with self._lock:
            lock = getattr(self, "_lock_path", None)
            self._lock_path = None
        if lock is not None:
            try:
                os.remove(lock)
            except OSError:
                pass

    # -- accept/handle ---------------------------------------------------------
    def _accept_loop(self) -> None:
        assert self._sock is not None
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            th = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            th.start()

    def _handle(self, conn: socket.socket) -> None:
        nonce = _secrets.token_hex(16)
        authed = False
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            net.send_json(conn, {"punchcard": PROTOCOL_VERSION, "nonce": nonce,
                                 "data_limit": DATA_FRAME_LIMIT})
            while self._running:
                try:
                    # pre-auth only the tiny auth message is legal; post-auth
                    # control JSON gets the full control budget
                    req = net.recv_json(
                        conn, limit=CTRL_FRAME_LIMIT if authed else AUTH_FRAME_LIMIT)
                except (ConnectionError, OSError):
                    return
                except (ValueError, UnicodeDecodeError):
                    return  # oversized / desynced / non-JSON frame: drop connection
                if not isinstance(req, dict):
                    return  # valid JSON but not a request object: drop
                action = req.get("action")
                if not authed:
                    mac = req.get("mac", "")
                    if not isinstance(mac, str) or \
                            not hmac.compare_digest(mac, _mac(self._secret, nonce)):
                        net.send_json(conn, {"ok": False, "error": "authentication failed"})
                        return
                    authed = True
                    if action == "auth":  # dedicated handshake message
                        net.send_json(conn, {"ok": True})
                        continue
                try:
                    stop_after = self._dispatch(conn, action, req)
                except _FatalProtocolError as e:
                    net.send_json(conn, {"ok": False, "error": str(e)})
                    return  # stream is desynced; further frames are garbage
                except Exception as e:  # request error: report, keep serving
                    net.send_json(conn, {"ok": False, "error": f"{type(e).__name__}: {e}"})
                    continue
                if stop_after:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn: socket.socket, action: str, req: Dict[str, Any]) -> bool:
        if action == "submit":
            rec = self._submit(conn, req)
            net.send_json(conn, {"ok": True, "job_id": rec.job_id})
        elif action == "status":
            rec = self._get(req["job_id"])
            net.send_json(conn, {"ok": True, **rec.public()})
        elif action == "list":
            with self._lock:
                jobs = [r.public() for r in self._jobs.values()]
            net.send_json(conn, {"ok": True, "jobs": jobs})
        elif action == "cancel":
            rec = self._get(req["job_id"])
            with self._lock:
                if rec.state == QUEUED:
                    rec.state = CANCELLED
            self._save_record(rec)
            net.send_json(conn, {"ok": True, "state": rec.state})
        elif action == "fetch":
            rec = self._get(req["job_id"])
            if rec.state != DONE:
                net.send_json(conn, {"ok": False,
                                     "error": f"job {rec.job_id} is {rec.state}, not {DONE}"})
                return False
            net.send_json(conn, {"ok": True, "num_models": len(rec.model_blobs)})
            for blob in rec.model_blobs:
                net.send_frame(conn, blob)
        elif action == "telemetry":
            # a running job's metrics, readable while the executor is
            # mid-job (the registry and tracer are thread-safe; no job lock
            # is taken), and on request the span ring as a Chrome trace, the
            # Prometheus text, the fleet report (over every flushed
            # process's spans when DKT_TRACE_DIR is set, with the live
            # collector) and the live health view
            resp: Dict[str, Any] = {
                "ok": True,
                "enabled": obs.enabled(),
                "metrics": obs.snapshot(),
            }
            if req.get("prometheus"):
                resp["prometheus"] = obs.render_prometheus()
            if req.get("trace"):
                resp["trace"] = obs.chrome_trace()
            if req.get("fleet"):
                from distkeras_torch.observability import health as _health
                from distkeras_torch.observability.distributed import fleet_report

                resp["fleet"] = fleet_report(
                    trace_dir=os.environ.get("DKT_TRACE_DIR") or None,
                    live=_health.collector())
            if req.get("health"):
                from distkeras_torch.observability import health as _health

                resp["health"] = _health.health_snapshot()
            net.send_json(conn, resp)
        elif action == "shutdown":
            net.send_json(conn, {"ok": True})
            threading.Thread(target=self.stop, daemon=True).start()
            return True
        else:
            net.send_json(conn, {"ok": False, "error": f"unknown action {action!r}"})
        return False

    def _get(self, job_id: str) -> JobRecord:
        with self._lock:
            if job_id not in self._jobs:
                raise KeyError(f"unknown job_id {job_id!r}")
            return self._jobs[job_id]

    # -- durable state ---------------------------------------------------------
    def _job_dir(self, job_id: str) -> str:
        assert self._state_dir is not None
        return os.path.join(self._state_dir, "jobs", job_id)

    def _save_record(self, rec: JobRecord, with_payloads: bool = False) -> None:
        """Persist the manifest (and optionally inline data / model blobs)
        atomically: tmp file + rename, so a crash mid-write leaves either
        the old or the new manifest, never a torn one.  All spool mutation
        serializes on ``_spool_lock`` and freezes once ``stop()`` ran — an
        orphaned executor thread must not overwrite state a restarted
        daemon may already own."""
        if self._state_dir is None:
            return
        with self._spool_lock:
            if not self._running:
                return
            d = self._job_dir(rec.job_id)
            os.makedirs(d, exist_ok=True)
            if with_payloads and rec.data is not None:
                # hand-rolled npz (zip of .npy members): np.savez(**cols)
                # would collide with its own 'file' parameter for a column
                # literally named "file"
                import io
                import zipfile

                tmp = os.path.join(d, ".data.npz.tmp")
                with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
                    for k, v in rec.data.items():
                        buf = io.BytesIO()
                        np.save(buf, np.asarray(v))
                        zf.writestr(f"{k}.npy", buf.getvalue())
                os.replace(tmp, os.path.join(d, "data.npz"))
            if with_payloads:
                for i, blob in enumerate(rec.model_blobs):
                    tmp = os.path.join(d, f".model_{i}.bin.tmp")
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, os.path.join(d, f"model_{i}.bin"))
            tmp = os.path.join(d, ".manifest.json.tmp")
            with open(tmp, "w") as f:
                json.dump(rec.manifest(), f)
            os.replace(tmp, os.path.join(d, "manifest.json"))

    def _drop_spooled_data(self, rec: JobRecord) -> None:
        if self._state_dir is None:
            return
        with self._spool_lock:
            if not self._running:
                return
            path = os.path.join(self._job_dir(rec.job_id), "data.npz")
            if os.path.exists(path):
                os.remove(path)

    def _evict_old(self) -> None:
        """Cap disk/RAM retention: beyond ``max_retained`` terminal jobs,
        the oldest are dropped entirely (records and spool dirs)."""
        with self._lock:
            terminal = sorted(
                (r for r in self._jobs.values()
                 if r.state in (DONE, FAILED, CANCELLED)),
                key=lambda r: r.submitted_at)
            victims = terminal[:max(0, len(terminal) - self._max_retained)]
            for rec in victims:
                del self._jobs[rec.job_id]
        if self._state_dir is not None:
            with self._spool_lock:
                if not self._running:
                    return
                for rec in victims:
                    shutil.rmtree(self._job_dir(rec.job_id), ignore_errors=True)

    def _reload_state(self) -> None:
        """Resurrect spooled jobs: terminal records become fetchable again
        (model blobs read back), queued AND interrupted-running jobs are
        re-queued in original submission order."""
        if self._state_dir is None:
            return
        jobs_root = os.path.join(self._state_dir, "jobs")
        os.makedirs(jobs_root, exist_ok=True)
        recs = []
        for job_id in os.listdir(jobs_root):
            d = os.path.join(jobs_root, job_id)
            try:
                with open(os.path.join(d, "manifest.json")) as f:
                    m = json.load(f)
                rec = JobRecord.from_manifest(m)
                num_models = int(m.get("num_models") or 0)
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn/foreign dir: skip, don't brick the daemon
            if rec.state == DONE:
                try:
                    blobs = []
                    for i in range(num_models):
                        with open(os.path.join(d, f"model_{i}.bin"), "rb") as f:
                            blobs.append(f.read())
                    rec.model_blobs = blobs
                except OSError:
                    rec.state = FAILED
                    rec.error = "daemon restart: model blobs missing from spool"
                    self._save_record(rec)  # memory and spool must agree
            elif rec.state in (QUEUED, RUNNING):
                if rec.state == RUNNING:
                    # the interrupted run never completed; start over
                    rec.state = QUEUED
                data_path = os.path.join(d, "data.npz")
                if os.path.exists(data_path):
                    try:
                        with np.load(data_path) as npz:
                            rec.data = {k: npz[k] for k in npz.files}
                    except Exception:  # torn/foreign npz: fail the JOB, not boot
                        rec.state = FAILED
                        rec.error = "daemon restart: spooled dataset unreadable"
                        self._save_record(rec)
                elif "columns" in (rec.job.get("dataset") or {}):
                    rec.state = FAILED
                    rec.error = "daemon restart: inline dataset missing from spool"
                    self._save_record(rec)
            recs.append(rec)
        recs.sort(key=lambda r: r.submitted_at)
        with self._lock:
            for rec in recs:
                self._jobs[rec.job_id] = rec
        for rec in recs:
            if rec.state == QUEUED:
                self._save_record(rec)  # persist the RUNNING->QUEUED reset
                self._queue.put(rec.job_id)
        # an operator may restart with a LOWER --max-retained over a large
        # spool; trim immediately rather than on the next completed job
        self._evict_old()

    def _submit(self, conn: socket.socket, req: Dict[str, Any]) -> JobRecord:
        job = req["job"]
        dataset = job.get("dataset") or {}
        trainer = job.get("trainer")
        if trainer not in _TRAINER_NAMES:
            raise ValueError(f"unknown trainer {trainer!r}; known: {_TRAINER_NAMES}")
        rec = JobRecord(uuid.uuid4().hex[:12], job)
        if "columns" in dataset:
            # two-phase inline upload: validation above happens BEFORE the
            # go-ahead, so a rejected client never streams its dataset (and
            # never hits a TCP reset racing the error reply); blobs arrive
            # in schema order, reinterpreted by declared dtype/shape
            net.send_json(conn, {"ok": True, "send_data": True})
            try:
                _, blobs = net.recv_tensors(conn, limit=DATA_FRAME_LIMIT)
            except ValueError as e:
                # declared frame over the data cap: unread payload bytes are
                # in flight, the stream can't be reused
                raise _FatalProtocolError(str(e)) from None
            schema = dataset["columns"]
            if len(blobs) != len(schema):
                raise ValueError(f"inline data has {len(blobs)} tensors, schema {len(schema)}")
            cols = {}
            for meta, blob in zip(schema, blobs):
                # zero-copy reinterpret of the received uint8 buffer
                arr = np.frombuffer(blob, dtype=np.dtype(meta["dtype"]))
                cols[meta["name"]] = arr.reshape(meta["shape"])
            rec.data = cols
        elif "path" in dataset:
            self._resolve_data_path(dataset["path"])  # validate before queuing
        else:
            raise ValueError("job.dataset needs either 'columns' (inline) or 'path'")
        with self._lock:
            self._jobs[rec.job_id] = rec
        self._save_record(rec, with_payloads=True)
        self._queue.put(rec.job_id)
        return rec

    def _resolve_data_path(self, path: str) -> str:
        if self._data_root is None:
            raise ValueError("this Punchcard accepts only inline datasets (no data_root)")
        full = os.path.realpath(os.path.join(self._data_root, path))
        if not (full == self._data_root or full.startswith(self._data_root + os.sep)):
            raise ValueError(f"dataset path {path!r} escapes the data root")
        if self._state_dir is not None and (
                full == self._state_dir
                or full.startswith(self._state_dir + os.sep)):
            # the spool holds OTHER submitters' inline datasets and models
            # (and eviction may delete files mid-run); it is not servable
            raise ValueError(f"dataset path {path!r} points into the daemon's "
                             "state spool")
        if not os.path.exists(full):
            raise FileNotFoundError(f"dataset path {path!r} not found under data root")
        return full

    # -- executor --------------------------------------------------------------
    def _executor_loop(self) -> None:
        while True:
            job_id = self._queue.get()
            if job_id is None or not self._running:
                # stop() must not let queued jobs keep the devices.  If
                # stop()'s join timed out because a job outlived it, stop()
                # left the pidfile for us — release it now that no job can
                # ever run again, or restarts in this process would be
                # refused forever ("owned by a live daemon", our own pid)
                self._release_spool_lock()
                return
            rec = self._jobs.get(job_id)
            if rec is None:
                continue  # evicted while queued (restart + cap)
            try:
                with self._lock:
                    if rec.state != QUEUED:
                        continue  # cancelled while queued (finally still runs)
                    rec.state = RUNNING
                self._save_record(rec)
                with obs.span("punchcard.job", job_id=rec.job_id,
                              trainer=rec.job.get("trainer")):
                    self._run(rec)
                rec.state = DONE
            except Exception as e:
                rec.error = f"{type(e).__name__}: {e}"
                rec.state = FAILED
            finally:
                obs.counter("punchcard_jobs_total", state=rec.state).inc()
                # a long-running daemon must not pin submitted datasets in
                # RAM — cancelled ones included; only the fetchable model
                # blobs outlive the run (and the spooled data.npz goes too).
                # Spool-write failures (ENOSPC, permissions) must NOT kill
                # the executor thread — durability degrades, execution lives
                rec.data = None
                try:
                    self._save_record(rec, with_payloads=True)
                    self._drop_spooled_data(rec)
                    self._evict_old()
                except Exception as e:
                    rec.error = ((rec.error + "; ") if rec.error else "") +                         f"spool write failed: {type(e).__name__}: {e}"
                    import sys as _sys
                    print(f"punchcard: spool write failed for {rec.job_id}: {e}",
                          file=_sys.stderr, flush=True)

    def _run(self, rec: JobRecord) -> None:
        from distkeras_torch.data.dataset import Dataset
        from distkeras_torch.models.base import ModelSpec

        job = rec.job
        spec = ModelSpec.from_dict(job["model"])
        kwargs = dict(job.get("trainer_kwargs") or {}, device=self.device)
        trainer = _trainer_registry()[job["trainer"]](spec, **kwargs)

        if rec.data is not None:
            ds = Dataset(rec.data)
        else:
            full = self._resolve_data_path(job["dataset"]["path"])
            with np.load(full) as npz:
                ds = Dataset({k: npz[k] for k in npz.files})

        result = trainer.train(ds)
        models = result if isinstance(result, list) else [result]
        rec.model_blobs = [m.serialize() for m in models]
        rec.history = [float(x) for x in getattr(trainer, "history", [])]
        rec.training_time = trainer.get_training_time()


class _Conn:
    """One authenticated client connection; reusable for many requests
    (the server's handler loop keeps serving until the socket closes)."""

    def __init__(self, host: str, port: int, secret: str):
        self.sock = net.connect(host, port)
        try:
            hello = net.recv_json(self.sock)
            self.data_limit = hello.get("data_limit")
            # dedicated auth handshake: proves the secret (and surfaces
            # PermissionError) before any real payload is built or sent
            net.send_json(self.sock, {"action": "auth",
                                      "mac": _mac(secret, hello["nonce"])})
            resp = net.recv_json(self.sock)
            if not resp.get("ok"):
                raise PermissionError(resp.get("error", "authentication failed"))
        except BaseException:
            self.close()
            raise

    def request(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        net.send_json(self.sock, payload)
        resp = net.recv_json(self.sock)
        if not resp.get("ok"):
            err = resp.get("error", "request failed")
            if "authentication" in err:
                raise PermissionError(err)
            raise RuntimeError(err)
        return resp

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "_Conn":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Job:
    """Client handle for one remote job (reference: ``Job.send``/``run``).
    Fetched models land on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, host: str, port: int, secret: str, name: str,
                 model: Any, trainer: str = "adag",
                 trainer_kwargs: Optional[Dict[str, Any]] = None,
                 data: Optional[Any] = None, dataset_path: Optional[str] = None,
                 device: DeviceLike = None):
        from distkeras_torch.models.base import Model, ModelSpec

        if isinstance(model, Model):
            model = model.spec
        if not isinstance(model, ModelSpec):
            raise TypeError(f"model must be a Model or ModelSpec, got {type(model)}")
        if (data is None) == (dataset_path is None):
            raise ValueError("pass exactly one of data= (inline) or dataset_path= (server-side)")
        self.host, self.port, self.secret, self.name = host, port, secret, name
        self.model_spec = model
        self.trainer = trainer
        self.trainer_kwargs = dict(trainer_kwargs or {})
        self.dataset_path = dataset_path
        self._columns = None
        if data is not None:
            cols = data._columns if hasattr(data, "_columns") else dict(data)
            self._columns = {k: np.ascontiguousarray(v) for k, v in cols.items()}
        self.job_id: Optional[str] = None
        self.device = resolve_device(device)

    # -- wire helpers ----------------------------------------------------------
    def _connect(self) -> _Conn:
        return _Conn(self.host, self.port, self.secret)

    def _request(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        with self._connect() as conn:
            return conn.request(payload)

    # -- public API ------------------------------------------------------------
    def submit(self) -> str:
        job: Dict[str, Any] = {
            "name": self.name,
            "trainer": self.trainer,
            "trainer_kwargs": self.trainer_kwargs,
            "model": self.model_spec.to_dict(),
        }
        if self._columns is not None:
            job["dataset"] = {"columns": [
                {"name": k, "dtype": v.dtype.str, "shape": list(v.shape)}
                for k, v in self._columns.items()]}
        else:
            job["dataset"] = {"path": self.dataset_path}
        with self._connect() as conn:
            resp = conn.request({"action": "submit", "job": job})
            if resp.get("send_data"):
                # two-phase upload: the server validated the job and asked
                # for the dataset; stream it and read the final reply
                # pre-flight the encoded-frame size the server will check
                nbytes = net.encoded_tensors_size(list(self._columns.values()))
                if conn.data_limit and nbytes > conn.data_limit:
                    raise ValueError(
                        f"inline dataset frame is {nbytes} bytes; daemon accepts "
                        f"at most {conn.data_limit} — use a server-side dataset_path")
                net.send_tensors(conn.sock, net.ACTION_COMMIT,
                                 list(self._columns.values()))
                resp = net.recv_json(conn.sock)
                if not resp.get("ok"):
                    raise RuntimeError(resp.get("error", "submit failed"))
        self.job_id = resp["job_id"]
        return self.job_id

    def status(self) -> Dict[str, Any]:
        if self.job_id is None:
            raise RuntimeError("job not submitted")
        return self._request({"action": "status", "job_id": self.job_id})

    def telemetry(self, trace: bool = False, fleet: bool = False,
                  health: bool = False) -> Dict[str, Any]:
        """The daemon's live telemetry snapshot (see :func:`fetch_telemetry`);
        daemon-wide, so it does not require this job to be submitted."""
        return fetch_telemetry(self.host, self.port, self.secret, trace=trace,
                               fleet=fleet, health=health)

    def cancel(self) -> str:
        if self.job_id is None:
            raise RuntimeError("job not submitted")
        return self._request({"action": "cancel", "job_id": self.job_id})["state"]

    def wait(self, timeout: Optional[float] = None, poll_interval: float = 0.2) -> Dict[str, Any]:
        if self.job_id is None:
            raise RuntimeError("job not submitted")
        deadline = None if timeout is None else time.time() + timeout
        # one authenticated connection for the whole poll loop — not a fresh
        # TCP+HMAC handshake per 0.2s status check
        with self._connect() as conn:
            while True:
                st = conn.request({"action": "status", "job_id": self.job_id})
                if st["state"] in (DONE, FAILED, CANCELLED):
                    return st
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(f"job {self.job_id} still {st['state']} after {timeout}s")
                time.sleep(poll_interval)

    def fetch_models(self) -> List[Any]:
        from distkeras_torch.models.base import Model

        if self.job_id is None:
            raise RuntimeError("job not submitted")
        with self._connect() as conn:
            resp = conn.request({"action": "fetch", "job_id": self.job_id})
            blobs = [net.recv_frame(conn.sock) for _ in range(resp["num_models"])]
        return [Model.deserialize(b, device=self.device) for b in blobs]

    def run(self, timeout: Optional[float] = None):
        """submit + wait + fetch; returns the trained Model (or list for
        ensemble trainers).  Raises on job failure (reference ``Job.run``)."""
        self.submit()
        st = self.wait(timeout=timeout)
        if st["state"] != DONE:
            raise RuntimeError(f"job {self.job_id} {st['state']}: {st.get('error')}")
        models = self.fetch_models()
        return models if len(models) > 1 else models[0]


def list_jobs(host: str, port: int, secret: str) -> List[Dict[str, Any]]:
    """List all jobs known to a Punchcard daemon."""
    with _Conn(host, port, secret) as conn:
        return conn.request({"action": "list"})["jobs"]


def fetch_telemetry(host: str, port: int, secret: str,
                    trace: bool = False,
                    prometheus: bool = False,
                    fleet: bool = False,
                    health: bool = False) -> Dict[str, Any]:
    """Pull the daemon process's telemetry (authenticated): the metrics
    snapshot, plus the span ring as Chrome ``trace_event`` JSON when
    ``trace=True``, the Prometheus text when ``prometheus=True``, the
    :func:`~distkeras_torch.observability.distributed.fleet_report` when
    ``fleet=True`` and the live health view (what ``distkeras-torch-top``
    renders) when ``health=True``.  The same request as the JAX
    package's; either package's daemon answers it."""
    with _Conn(host, port, secret) as conn:
        return conn.request({"action": "telemetry", "trace": bool(trace),
                             "prometheus": bool(prometheus),
                             "fleet": bool(fleet),
                             "health": bool(health)})


def shutdown(host: str, port: int, secret: str) -> None:
    """Remotely stop a Punchcard daemon (authenticated)."""
    with _Conn(host, port, secret) as conn:
        conn.request({"action": "shutdown"})


def main(argv: Optional[List[str]] = None) -> None:
    """Daemon CLI: ``distkeras-torch-punchcard --secret-file s.txt --port 5000``."""
    import argparse

    parser = argparse.ArgumentParser(description="distkeras_torch job daemon")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--secret-file", required=True,
                        help="file whose (stripped) contents are the shared secret")
    parser.add_argument("--data-root", default=None,
                        help="directory server-side dataset paths are confined to")
    parser.add_argument("--state-dir", default=None,
                        help="spool job records/models here so the queue and "
                             "fetchable results survive a restart (default: "
                             "<data-root>/.punchcard-state when --data-root is set)")
    parser.add_argument("--max-retained", type=int, default=20,
                        help="terminal jobs kept (records + model blobs); older evicted")
    parser.add_argument("--cpu", action="store_true",
                        help="run the jobs on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)
    with open(args.secret_file) as f:
        secret = f.read().strip()
    pc = Punchcard(secret=secret, host=args.host, port=args.port,
                   data_root=args.data_root, state_dir=args.state_dir,
                   max_retained=args.max_retained,
                   device="cpu" if args.cpu else None).start()
    print(f"punchcard listening on {args.host}:{pc.port}", flush=True)
    try:
        while True:
            time.sleep(1)
            if not pc._running:
                return
    except KeyboardInterrupt:
        pc.stop()


if __name__ == "__main__":
    main()
