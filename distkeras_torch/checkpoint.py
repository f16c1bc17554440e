"""Checkpoint and resume, in the JAX package's on-disk format.

Counterpart of ``distkeras_tpu/checkpoint.py``.  A checkpoint directory
holds ``step_<N>`` subdirectories, each with one ``<tree>.npz`` of raw leaf
bytes and one ``<tree>.json`` manifest of ``(path, dtype, shape)`` per
named tree, plus ``checkpoint.json`` (step, tree names, metadata).  No
pickle: a restore fills a template's structure by leaf path.  A save
writes ``.tmp-<step>`` and renames it to ``step_<N>`` only when complete;
``keep`` checkpoints are retained; a corrupt latest checkpoint is skipped
with a warning when no step is named.

Leaf paths are the names ``jax.tree_util.keystr`` gives: ``['key']`` for a
dict entry (keys sorted), ``[i]`` for a list or tuple item, ``.field`` for
a named tuple or dataclass field.  The trainers store the port's tensors
under the JAX package's names and layouts (:func:`params_tree`,
:func:`opt_state_tree`, :func:`state_tree`): a ``params`` checkpoint
written by either package restores in the other, optimizer state restores
across packages where it maps onto optax's names (adam's ``count`` /
``mu`` / ``nu``, also adamax's, nadam's and lamb's; the momentum
``trace``), and anything else raises,
naming the missing and extra paths.  Within the port every tree
round-trips bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distkeras_torch.utils import decode_array, dtype_name, encode_array

_STEP_PREFIX = "step_"


# -- trees ----------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """``(key string, child)`` pairs of a tree node, in the order JAX
    flattens it; None for a leaf."""
    if isinstance(tree, Mapping):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten(child, prefix + key))
    return out


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if isinstance(tree, Mapping):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    values = [_rebuild(c, leaves) for _, c in kids]
    if _is_namedtuple(tree):
        return type(tree)(*values)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: v for f, v in
                                            zip(dataclasses.fields(tree), values)})
    return type(tree)(values)


def _as_saved(leaf) -> Tuple[np.ndarray, str, list]:
    """(uint8 bytes, dtype name, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        return encode_array(leaf), dtype_name(leaf), list(leaf.shape)
    arr = np.asarray(leaf)
    return encode_array(arr), arr.dtype.name, list(arr.shape)


def _like(stored: torch.Tensor, template):
    """A restored leaf in the template leaf's kind: a tensor on its device,
    a numpy array, or a Python scalar."""
    if isinstance(template, torch.Tensor):
        return stored.to(template.device)
    if isinstance(template, bool):
        return bool(stored)
    if isinstance(template, int):
        return int(stored)
    if isinstance(template, float):
        return float(stored)
    return stored.numpy()


def save_tree(path: str, tree: Any) -> None:
    """One tree to ``<path>.npz`` + ``<path>.json`` (no pickle)."""
    leaves = _flatten(tree)
    saved = [(p, *_as_saved(leaf)) for p, leaf in leaves]
    manifest = [{"path": p, "dtype": dt, "shape": shape} for p, _, dt, shape in saved]
    # members keyed by index: leaf paths are not safe file names
    np.savez(path + ".npz", **{f"leaf{i}": raw for i, (_, raw, _, _) in enumerate(saved)})
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def restore_tree(path: str, template: Any) -> Any:
    """A tree saved by :func:`save_tree` (by either package) in
    ``template``'s structure, matched by leaf path; a missing or extra
    path, or a shape that differs, raises."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    stored: Dict[str, torch.Tensor] = {}
    with np.load(path + ".npz", allow_pickle=False) as z:
        for i, meta in enumerate(manifest):
            stored[meta["path"]] = decode_array(z[f"leaf{i}"], meta["dtype"], meta["shape"])
    leaves = _flatten(template)
    want = [p for p, _ in leaves]
    missing = [p for p in want if p not in stored]
    extra = [p for p in stored if p not in want]
    if missing or extra:
        raise ValueError(
            f"checkpoint/template structure mismatch: missing={missing[:5]} extra={extra[:5]}")
    out = []
    for p, tmpl in leaves:
        arr = stored[p]
        tmpl_shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
        if tmpl_shape != tuple(arr.shape):
            raise ValueError(f"checkpoint leaf {p} has shape {tuple(arr.shape)}, "
                             f"template expects {tmpl_shape}")
        out.append(_like(arr, tmpl))
    return _rebuild(template, iter(out))


# -- the port's training state under the JAX package's names ---------------------

def unflatten_paths(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b": leaf}`` -> ``{"a": {"b": leaf}}`` (a weight list's paths,
    ``utils.flatten_weights``' treedef, back to the Flax tree)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _flatten_paths(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten_paths(v, path) if isinstance(v, Mapping) else {path: v})
    return out


def params_tree(params: Mapping[str, torch.Tensor], spec, stacked: bool = False) -> Dict[str, Any]:
    """A port param dict (``stacked``: every tensor with a leading replica
    axis) -> the Flax-layout tree the JAX package keeps, CPU tensors."""
    from distkeras_torch.bridge import flax_tensors

    if not stacked:
        return flax_tensors(params, spec)
    r = next(iter(params.values())).shape[0]
    rows = [_flatten_paths(flax_tensors({k: t[i] for k, t in params.items()}, spec))
            for i in range(r)]
    return unflatten_paths({p: torch.stack([row[p] for row in rows]) for p in rows[0]})


def params_from_tree(tree: Mapping, spec, like: Mapping[str, torch.Tensor],
                     stacked: bool = False) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`params_tree`: a port param dict with ``like``'s keys,
    order and device."""
    from distkeras_torch.bridge import params_from_flax_tensors

    flat = {p: torch.as_tensor(t) for p, t in _flatten_paths(tree).items()}
    device = next(iter(like.values())).device
    if not stacked:
        out = params_from_flax_tensors(flat, spec, device=device)
    else:
        r = next(iter(flat.values())).shape[0]
        rows = [params_from_flax_tensors({p: t[i] for p, t in flat.items()}, spec,
                                         device=device) for i in range(r)]
        out = {k: torch.stack([row[k] for row in rows]) for k in rows[0]}
    return {k: out[k] for k in like}


class TraceState(NamedTuple):
    trace: Any


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class EmptyState(NamedTuple):
    pass


_ADAM_KEYS = {"count", "mu", "nu"}
_TRACE_KEYS = {"count", "trace"}


def opt_state_tree(state: Mapping, spec, stacked: bool = False):
    """The port optimizer's state -> optax's state tree for the same
    optimizer: ``adam`` / ``adamw`` / ``adamax`` / ``nadam`` / ``lamb`` (a
    ``count``, ``mu`` and ``nu``) -> ``(ScaleByAdamState(count, mu, nu),
    EmptyState())``, the leaf paths of optax's state for each of them;
    ``momentum`` / ``nesterov`` -> ``(TraceState(trace),
    ScaleByScheduleState(count))``; ``sgd`` -> ``(EmptyState(),
    ScaleByScheduleState(count))``.  ``lars`` has momentum's keys and so
    momentum's tree, but optax's ``lars`` keeps its trace at ``[3]`` (after
    the weight decay, trust ratio and learning-rate transforms): its state
    restores within the port only.  The other optimizers' states keep the
    port's keys (``{"count": ..., "nu": {...}}``) and restore within the
    port only.  The port counts steps for every optimizer, where optax keeps
    a count only for adam-like transforms or a schedule: that ``count``
    restores within the port only."""
    def tree(d):
        return params_tree(d, spec, stacked=stacked)

    keys = set(state)
    if keys == _ADAM_KEYS:
        return (ScaleByAdamState(state["count"], tree(state["mu"]), tree(state["nu"])),
                EmptyState())
    if keys == _TRACE_KEYS:
        return (TraceState(tree(state["trace"])), ScaleByScheduleState(state["count"]))
    if keys == {"count"}:
        return (EmptyState(), ScaleByScheduleState(state["count"]))
    return {k: tree(v) if isinstance(v, Mapping) else v for k, v in state.items()}


def opt_state_from_tree(tree, spec, like: Mapping, stacked: bool = False) -> Dict:
    """Inverse of :func:`opt_state_tree`; ``like`` is the port state whose
    structure, keys and device the result takes."""
    def back(t, params_like):
        return params_from_tree(t, spec, params_like, stacked=stacked)

    keys = set(like)
    if keys == _ADAM_KEYS:
        first, _ = tree
        return {"count": first.count, "mu": back(first.mu, like["mu"]),
                "nu": back(first.nu, like["nu"])}
    if keys == _TRACE_KEYS:
        first, second = tree
        return {"count": second.count, "trace": back(first.trace, like["trace"])}
    if keys == {"count"}:
        return {"count": tree[1].count}
    return {k: back(tree[k], v) if isinstance(v, Mapping) else tree[k] for k, v in like.items()}


class ReplicaStateTree(NamedTuple):
    """The window engine's state under the field names of the JAX
    package's ``ReplicaState`` (``.center``, ``.local``, ...)."""

    center: Any
    local: Any
    opt_state: Any
    extra: Any
    step: Any


def state_tree(state, spec) -> ReplicaStateTree:
    """``parallel.engine.ReplicaState`` -> its checkpoint tree (``extra``
    keeps the port's keys: no algorithm of the port has any)."""
    return ReplicaStateTree(center=params_tree(state.center, spec),
                            local=params_tree(state.local, spec, stacked=True),
                            opt_state=opt_state_tree(state.opt_state, spec, stacked=True),
                            extra={k: v for k, v in state.extra.items()}, step=state.step)


def state_from_tree(tree: ReplicaStateTree, spec, like):
    """Inverse of :func:`state_tree`, ``like`` a state of the same engine."""
    return dataclasses.replace(
        like, center=params_from_tree(tree.center, spec, like.center),
        local=params_from_tree(tree.local, spec, like.local, stacked=True),
        opt_state=opt_state_from_tree(tree.opt_state, spec, like.opt_state, stacked=True),
        extra={k: v.to(like.extra[k].device) for k, v in tree.extra.items()},
        step=int(tree.step))


# -- the checkpoint directory ------------------------------------------------------

class Checkpointer:
    """A directory of ``step_<N>`` checkpoints with atomic writes and keep-N
    retention.  A checkpoint holds named trees plus a JSON metadata dict."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep} (a save must survive its own retention)")
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX):
                try:
                    steps.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step:010d}")

    def save(self, step: int, trees: Dict[str, Any], metadata: Optional[Dict[str, Any]] = None,
             apply_retention: bool = True) -> str:
        """Atomically write checkpoint ``step``, then apply retention."""
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            for name, tree in trees.items():
                save_tree(os.path.join(tmp, name), tree)
            meta = {"step": int(step), "trees": sorted(trees), "metadata": metadata or {}}
            with open(os.path.join(tmp, "checkpoint.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if apply_retention:
            self._apply_retention()
        return final

    def delete_step(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def restore(self, templates: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """Named trees at ``step`` (default: the latest readable one, a
        corrupt later one skipped with a warning).  A named ``step`` raises
        on corruption rather than substitute another."""
        if step is not None:
            return self._restore_at(step, templates)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                return self._restore_at(s, templates)
            except Exception as e:
                last_err = e
                warnings.warn(f"skipping corrupt/unreadable checkpoint "
                              f"step {s}: {type(e).__name__}: {e}")
        raise FileNotFoundError(
            f"no readable checkpoint in {self.directory} "
            f"({len(steps)} present, all corrupt or unreadable; last error: "
            f"{type(last_err).__name__}: {last_err})") from last_err

    def _restore_at(self, step: int, templates: Dict[str, Any]) -> Dict[str, Any]:
        d = self._step_dir(step)
        with open(os.path.join(d, "checkpoint.json")) as f:
            meta = json.load(f)
        missing = sorted(set(templates) - set(meta["trees"]))
        if missing:
            raise ValueError(f"checkpoint {step} lacks trees {missing}; has {meta['trees']}")
        return {name: restore_tree(os.path.join(d, name), tmpl) for name, tmpl in templates.items()}

    def metadata(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self._step_dir(step), "checkpoint.json")) as f:
            return json.load(f)

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
