"""Streaming inference service: the reference's Kafka pipeline counterpart.

Counterpart of ``distkeras_tpu/runtime/streaming.py``, wire-identical: a
client of either package talks to a server of either package.  The server
holds the model on its device (the card unless ``device="cpu"``) and runs
the apply under ``torch.inference_mode()`` at one static batch, ``max_batch``:
a smaller frame is padded by repeating its last row and the reply is
truncated, a larger one is refused.  It learns ``output_shape`` from one
call at start-up.  Connections share the model and one lock around the
apply (a handler copies its rows in, applies, copies out, then releases),
so requests from several connections run one at a time on one stream.

Wire protocol (after :mod:`distkeras_torch.runtime.networking`):

    server hello: JSON {"streaming_predictor": 1, "row_shape": [...],
                        "dtype": "...", "max_batch": N, "output_shape": [...],
                        "output_dtype": "..."}
    client frame: tensors(action 'C', [features [b, *row_shape]]), b <= N
    server frame: tensors(action 'W', [predictions [b, *output_shape]])
    action 'B' closes the connection.

Use :class:`StreamingClient` (or :func:`stream_predict` for an
iterator-in, iterator-out pipeline, the shape of a Kafka consumer loop).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from distkeras_torch.platform import DeviceLike, resolve_device
from distkeras_torch.runtime import networking as net


class StreamingInferenceServer:
    """Serve a model's predictions over TCP at one static batch shape.

    ``max_batch`` is the batch every apply runs at: larger client frames
    are rejected, smaller ones are padded (rows repeated) and truncated on
    reply.  ``port=0`` binds an ephemeral port (read ``.port``).  bfloat16
    outputs go out as float32 (numpy holds no bfloat16).
    """

    def __init__(self, model: Any, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 256, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self._params = {k: t.to(self.device) for k, t in model.params.items()}
        self._apply = model.spec.apply_fn()
        self._host, self._port = host, int(port)
        self.max_batch = int(max_batch)
        self.row_shape = tuple(model.spec.input_shape)
        self.row_dtype = np.dtype(model.spec.input_dtype)
        # one call up front: warms the device path and gives the output shape
        out = self._predict(np.zeros((self.max_batch,) + self.row_shape, self.row_dtype))
        self.output_shape = tuple(out.shape[1:])
        self.output_dtype = out.dtype
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._running = False
        self._threads: List[threading.Thread] = []

    def _predict(self, batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self._apply(self._params, torch.as_tensor(np.require(batch, requirements="W"),
                                                        device=self.device))
            if out.dtype == torch.bfloat16:
                out = out.float()
            return out.cpu().numpy()

    @property
    def port(self) -> int:
        if self._sock is None:
            raise RuntimeError("server not started")
        return self._sock.getsockname()[1]

    def start(self) -> "StreamingInferenceServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, self._port))
        self._sock.listen(64)
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            # close() alone does not wake a blocked accept() on Linux
            for close in (lambda: self._sock.shutdown(socket.SHUT_RDWR), self._sock.close):
                try:
                    close()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=5)

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        row_elems = int(np.prod(self.row_shape)) if self.row_shape else 1
        try:
            net.send_json(conn, {
                "streaming_predictor": 1,
                "row_shape": list(self.row_shape),
                "dtype": self.row_dtype.str,
                "max_batch": self.max_batch,
                "output_shape": list(self.output_shape),
                "output_dtype": self.output_dtype.str,
            })
            while self._running:
                try:
                    action, blobs = net.recv_tensors(
                        conn, limit=16 + self.max_batch * row_elems * self.row_dtype.itemsize * 2)
                except (ConnectionError, OSError, ValueError):
                    return
                if action == net.ACTION_BYE:
                    return
                if action != net.ACTION_COMMIT or len(blobs) != 1:
                    net.send_json(conn, {"ok": False, "error": "expected one feature frame"})
                    return
                flat = np.frombuffer(blobs[0], dtype=self.row_dtype)
                if flat.size % row_elems:
                    net.send_json(conn, {"ok": False,
                                         "error": f"frame size {flat.size} not a multiple "
                                                  f"of row size {row_elems}"})
                    return
                batch = flat.reshape((-1,) + self.row_shape)
                b = len(batch)
                if b == 0 or b > self.max_batch:
                    net.send_json(conn, {"ok": False,
                                         "error": f"batch {b} outside 1..{self.max_batch}"})
                    return
                if b < self.max_batch:
                    batch = np.concatenate(
                        [batch, np.repeat(batch[-1:], self.max_batch - b, axis=0)])
                with self._lock:
                    preds = self._predict(batch)[:b]
                net.send_tensors(conn, net.ACTION_WEIGHTS, [np.ascontiguousarray(preds)])
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass


class StreamingClient:
    """Producer-side handle: ``predict(batch) -> predictions``, reusable
    across many micro-batches on one connection."""

    def __init__(self, host: str, port: int, timeout: Optional[float] = 60.0):
        self.sock = net.connect(host, port, timeout=timeout)
        hello = net.recv_json(self.sock)
        if hello.get("streaming_predictor") != 1:
            self.close()
            raise ConnectionError(f"not a streaming predictor endpoint: {hello}")
        self.row_shape = tuple(hello["row_shape"])
        self.dtype = np.dtype(hello["dtype"])
        self.max_batch = int(hello["max_batch"])
        self.output_shape = tuple(hello["output_shape"])
        self.output_dtype = np.dtype(hello.get("output_dtype", "<f4"))

    def predict(self, batch: np.ndarray) -> np.ndarray:
        batch = np.ascontiguousarray(np.asarray(batch, dtype=self.dtype))
        if batch.shape[1:] != self.row_shape:
            raise ValueError(f"rows of shape {batch.shape[1:]}, server expects {self.row_shape}")
        if not 1 <= len(batch) <= self.max_batch:
            raise ValueError(f"batch {len(batch)} outside 1..{self.max_batch}")
        net.send_tensors(self.sock, net.ACTION_COMMIT, [batch])
        payload = net.recv_frame(self.sock)
        if payload[:1] == net.ACTION_WEIGHTS:
            _, blobs = net.decode_tensors(payload)
            flat = np.frombuffer(blobs[0], dtype=self.output_dtype)
            return flat.reshape((len(batch),) + self.output_shape)
        err = json.loads(payload.decode("utf-8"))
        raise RuntimeError(err.get("error", "streaming predict failed"))

    def close(self) -> None:
        try:
            net.send_tensors(self.sock, net.ACTION_BYE, [])
        except OSError:
            pass
        finally:
            try:
                self.sock.close()
            except OSError:
                pass

    def __enter__(self) -> "StreamingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_predict(host: str, port: int, events: Iterable[np.ndarray],
                   micro_batch: int = 64) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Micro-batch an event stream through a predictor service: ``events``
    yields single feature rows, grouped into ``micro_batch``-row frames;
    ``(rows, predictions)`` pairs are yielded as they return, the final
    partial batch at the stream's end."""
    with StreamingClient(host, port) as client:
        buf: List[np.ndarray] = []
        for row in events:
            buf.append(np.asarray(row))
            if len(buf) >= micro_batch:
                rows = np.stack(buf)
                yield rows, client.predict(rows)
                buf = []
        if buf:
            rows = np.stack(buf)
            yield rows, client.predict(rows)
