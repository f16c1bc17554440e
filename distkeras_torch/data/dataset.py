"""Columnar in-memory Dataset and the double-buffered device feed.

Counterpart of ``distkeras_tpu/data/dataset.py``.  Columns are contiguous
host numpy arrays; batching is a zero-copy slice; shuffles draw the JAX
package's permutation (``np.random.default_rng(seed)``), so both packages
see the same rows in the same order.

:func:`prefetch_to_device` is the feed.  On a CUDA device each chunk is
copied into pinned host memory (on a producer thread, ahead of the
consumer) and then to the card with ``non_blocking=True`` on a side CUDA
stream; the consumer's stream waits on that copy's event before it uses the
chunk, so chunk N+1's copy overlaps chunk N's training.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from distkeras_torch import utils
from distkeras_torch.platform import DeviceLike, resolve_device

# bytes of feature data per chunk for "auto" chunking, the JAX package's
DEFAULT_CHUNK_BUDGET_BYTES = 25 * 2**20


def chunk_windows_for_budget(row_bytes: int, batch_size: int, window: int = 1,
                             budget_bytes: Optional[int] = None) -> int:
    """``chunk_windows`` value sizing each chunk near the feed budget.

    ``row_bytes`` is one sample's feature bytes.  At least 1: chunking
    cannot split below one window."""
    if row_bytes <= 0 or batch_size <= 0 or window <= 0:
        raise ValueError(f"row_bytes, batch_size and window must be positive, "
                         f"got {row_bytes}, {batch_size}, {window}")
    budget = DEFAULT_CHUNK_BUDGET_BYTES if budget_bytes is None else budget_bytes
    return max(1, budget // (row_bytes * batch_size * window))


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _produced(source: Iterator, stage: Callable) -> Iterator:
    """``stage(chunk)`` for each chunk of ``source``, run on a producer thread
    one chunk ahead of the consumer.  The producer puts with a bounded wait
    so an abandoned consumer cannot strand it, and the consumer checks the
    producer's liveness so a producer that died without its end sentinel
    raises instead of hanging."""
    q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        # holds `source`, never the generator below: a reference from the
        # live thread to the generator would keep its stop-setting finalizer
        # from running on an abandoned consumer
        try:
            for c in source:
                if not put(("chunk", stage(c))):
                    return
        except BaseException as exc:  # surfaced on the consumer side
            put(("error", exc))
        else:
            put(("done", None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            try:
                kind, val = q.get(timeout=1.0)
            except queue.Empty:
                if thread.is_alive():
                    continue
                try:  # the sentinel may have landed between timeout and check
                    kind, val = q.get_nowait()
                except queue.Empty:
                    raise RuntimeError(
                        "prefetch producer thread died without delivering its chunk "
                        "or end-of-epoch sentinel; the feed cannot make progress") from None
            if kind == "error":
                raise val
            if kind == "done":
                return
            yield val
    finally:
        stop.set()  # runs on normal exhaustion and on GeneratorExit


def prefetch_to_device(chunks: Iterator, place: Optional[Callable] = None,
                       device: DeviceLike = None, produce_ahead: bool = True) -> Iterator:
    """Double-buffered feed: yield each chunk's arrays as tensors on
    ``device`` (the card unless ``device="cpu"``), with the next chunk's
    host-to-device copy already started before the current one is yielded.

    ``place`` maps a chunk to a dict, list or tuple of host arrays (the
    chunk passes as it is when ``None``).  On a CUDA device the arrays are
    copied into pinned memory, by a producer thread one chunk ahead when
    ``produce_ahead`` (so host work such as the shuffle's gather overlaps
    training too), then sent with ``non_blocking=True`` on a side stream;
    the consuming stream waits on that copy's event, and each tensor is
    marked as used by the consuming stream so the allocator keeps it until
    that stream is done with it.  At most two chunks are on the device."""
    # resolved here, not at the first next(): without a card the call raises
    return _feed(chunks, place, resolve_device(device), produce_ahead)


def _feed(chunks: Iterator, place: Optional[Callable], dev: torch.device,
          produce_ahead: bool) -> Iterator:
    cuda = dev.type == "cuda"
    place = place or (lambda c: c)

    def host_tensor(a):
        a = np.asarray(a)
        if cuda:
            # one copy, straight into pinned memory, whatever the array's
            # layout or flags (a mapped DKCOL column is read-only)
            t = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                            pin_memory=True)
            t.numpy()[...] = a
            return t
        a = np.ascontiguousarray(a)
        # a read-only array is copied: torch tensors are writable
        return torch.from_numpy(a if a.flags.writeable else a.copy())

    def stage(chunk):
        return _map(host_tensor, place(chunk))

    staged = _produced(iter(chunks), stage) if produce_ahead else map(stage, chunks)
    if not cuda:
        yield from staged
        return
    side = torch.cuda.Stream(device=dev)

    def copy_in(host):
        with torch.cuda.stream(side):
            out = _map(lambda t: t.to(dev, non_blocking=True), host)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def hand_over(item):
        out, ready = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(ready)
        _map(lambda t: t.record_stream(consumer), out)
        return out

    it = iter(staged)
    try:
        cur = copy_in(next(it))
    except StopIteration:
        return
    for host in it:
        nxt = copy_in(host)
        yield hand_over(cur)
        cur = nxt
    yield hand_over(cur)


class Dataset:
    """A dict of equal-length numpy columns with DataFrame-ish helpers."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"column length mismatch: {lengths}")
        self._columns = {k: np.asarray(v) for k, v in columns.items()}

    # -- DataFrame-ish surface -------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values()))) if self._columns else 0

    def __getitem__(self, col: str) -> np.ndarray:
        return self._columns[col]

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        if len(values) != len(self):
            raise ValueError(f"new column {name!r} has {len(values)} rows, dataset has {len(self)}")
        cols = dict(self._columns)
        cols[name] = np.asarray(values)
        return Dataset(cols)

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({n: self._columns[n] for n in names})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    def shuffle(self, seed: int = 0) -> "Dataset":
        """Row shuffle, the JAX package's permutation."""
        return Dataset(utils.shuffle_arrays(self._columns, seed=seed))

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Contiguous row shard ``index`` of ``num_shards``; equal sizes, the
        tail remainder dropped."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of range for {num_shards} shards")
        per = len(self) // num_shards
        if per == 0:
            raise ValueError(f"dataset of {len(self)} rows cannot be split into {num_shards} shards")
        return Dataset({k: v[index * per:(index + 1) * per] for k, v in self._columns.items()})

    def split(self, fraction: float, seed: Optional[int] = None) -> Sequence["Dataset"]:
        """(train, test)-style split, shuffled first when ``seed`` is given."""
        ds = self.shuffle(seed) if seed is not None else self
        cut = int(len(ds) * fraction)
        return (Dataset({k: v[:cut] for k, v in ds._columns.items()}),
                Dataset({k: v[cut:] for k, v in ds._columns.items()}))

    # -- batch plane -----------------------------------------------------------
    def batches(self, batch_size: int, columns: Optional[Sequence[str]] = None,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batch dicts of the requested columns."""
        names = list(columns) if columns is not None else self.columns
        n = len(self)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            yield {c: self._columns[c][i:i + batch_size] for c in names}

    def chunked_epoch(self, batch_size: int, columns: Sequence[str],
                      window: int = 1, chunk_windows: Optional[int] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the epoch in chunks of ``[n, window, batch, ...]`` (zero-copy
        reshapes of column slices), at most ``chunk_windows`` windows each;
        ``None`` yields the whole epoch as one chunk.  The tail that does not
        fill a window is dropped."""
        per_window = batch_size * window
        num_windows = len(self) // per_window
        if num_windows == 0:
            raise ValueError(
                f"dataset of {len(self)} rows too small for batch_size={batch_size} window={window}")
        step = num_windows if chunk_windows is None else int(chunk_windows)
        if step <= 0:
            raise ValueError(f"chunk_windows must be positive, got {chunk_windows}")
        for start in range(0, num_windows, step):
            n = min(step, num_windows - start)
            out = {}
            for c in columns:
                v = self._columns[c][start * per_window:(start + n) * per_window]
                out[c] = v.reshape((n, window, batch_size) + v.shape[1:])
            yield out

    def stacked_epoch(self, batch_size: int, columns: Sequence[str],
                      window: int = 1) -> Dict[str, np.ndarray]:
        """One epoch as ``[num_windows, window, batch, ...]`` arrays: the
        single-chunk case of :meth:`chunked_epoch`."""
        return next(self.chunked_epoch(batch_size, columns, window=window))
