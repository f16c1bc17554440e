"""A pool of Gloo processes for the port's tests over several devices.

The JAX side of such a test runs in the test's own process on the
conftest's virtual CPU devices; the port's side runs in ``world`` Gloo
processes started once for a test file.  Each child joins through
``initialize_multihost(cpu_devices_per_process=1)``, imports torch and
``distkeras_torch`` only (the file's ``job_<name>`` functions between
:data:`CHILD_HEAD` and :data:`CHILD_TAIL`; never a test module, which
imports JAX), and serves jobs read from its standard input.  Inputs and
results cross in ``.npz`` files; nested trees are flattened with keys
joined by :data:`SEP`.

Every job has a timeout, the group's collectives time out after 60 s,
and a job that fails or times out kills the pool (the next job starts a
new one): a stuck rank fails its case, not the suite.  A child that
imported JAX, Flax, optax or the JAX package fails its job.
"""

import json
import os
import pathlib
import queue
import socket
import subprocess
import sys
import tempfile
import threading

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEP = "|"

CHILD_HEAD = r'''
import json, sys, traceback
import numpy as np, torch, torch.distributed as dist
from distkeras_torch.runtime.launcher import initialize_multihost

initialize_multihost(cpu_devices_per_process=1, timeout=60)
RANK = dist.get_rank()
SEP = "|"


def unflatten(arrs, prefix):
    tree = {}
    for key in arrs.files:
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arrs[key]
    return tree


def flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, prefix + k + SEP, out)
        else:
            out[prefix + k] = np.asarray(v)
    return out


'''

CHILD_TAIL = r'''
JOBS = {name[4:]: fn for name, fn in list(globals().items()) if name.startswith("job_")}

for line in sys.stdin:
    req = json.loads(line)
    if req["job"] == "exit":
        break
    try:
        result = JOBS[req["job"]](req["args"], np.load(req["dir"] + "/in.npz"))
        if result is not None:
            np.savez(f"{req['dir']}/out_{RANK}.npz", **result)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax",
                                                                  "distkeras_tpu"))
        print("DONE " + json.dumps(bad), flush=True)
    except Exception:
        print("FAIL " + json.dumps(traceback.format_exc()), flush=True)
dist.destroy_process_group()
'''


def child(jobs: str) -> str:
    """The child's code: the shared head, ``jobs`` (``job_<name>(args,
    arrays)`` functions returning a dict of arrays or ``None``), the
    serving loop."""
    return CHILD_HEAD + jobs + CHILD_TAIL


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Pool:
    """``world`` Gloo processes that run one job at a time, all together."""

    def __init__(self, code: str, world: int, job_timeout: float):
        self.world, self.job_timeout = world, job_timeout
        self.tmp = tempfile.mkdtemp(prefix="dkt-mesh-")
        self.procs, self.lines = [], []
        port = _free_port()
        for rank in range(world):
            env = dict(os.environ, DKT_COORDINATOR=f"127.0.0.1:{port}",
                       DKT_NUM_PROCESSES=str(world), DKT_PROCESS_ID=str(rank),
                       PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
            err = open(os.path.join(self.tmp, f"err_{rank}.log"), "w")
            p = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                                 text=True)
            q = queue.Queue()
            threading.Thread(target=lambda p=p, q=q: [q.put(l) for l in p.stdout],
                             daemon=True).start()
            self.procs.append(p)
            self.lines.append(q)
        self.jobs = 0

    def alive(self):
        return all(p.poll() is None for p in self.procs)

    def run(self, job, args, arrays):
        self.jobs += 1
        d = os.path.join(self.tmp, f"job{self.jobs}")
        os.makedirs(d)
        np.savez(os.path.join(d, "in.npz"), **arrays)
        req = json.dumps({"job": job, "args": args, "dir": d}) + "\n"
        for p in self.procs:
            p.stdin.write(req)
            p.stdin.flush()
        outs = []
        for rank, q in enumerate(self.lines):
            try:
                line = q.get(timeout=self.job_timeout)
            except queue.Empty:
                raise AssertionError(f"rank {rank} gave no answer to {job} in "
                                     f"{self.job_timeout} s: {self._err(rank)}")
            if not line.startswith("DONE "):
                raise AssertionError(f"rank {rank} failed {job}: "
                                     f"{json.loads(line[5:]) if line.startswith('FAIL ') else line}")
            assert json.loads(line[5:]) == [], f"rank {rank} imported {line[5:]}"
            path = os.path.join(d, f"out_{rank}.npz")
            outs.append(dict(np.load(path)) if os.path.exists(path) else None)
        return outs

    def _err(self, rank):
        with open(os.path.join(self.tmp, f"err_{rank}.log")) as f:
            return f.read()[-3000:]

    def close(self):
        for p in self.procs:
            try:
                if p.poll() is None:
                    p.stdin.write(json.dumps({"job": "exit"}) + "\n")
                    p.stdin.flush()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


def serve(code: str, world: int, job_timeout: float):
    """The body of a module-scoped pytest fixture: yields ``run(job, args,
    arrays)`` -> each rank's result dict (``None`` where a rank returned
    nothing), starting the pool at first use and anew after a failure."""
    holder = {"pool": None}

    def run(job, args, arrays):
        if holder["pool"] is None or not holder["pool"].alive():
            holder["pool"] = Pool(code, world, job_timeout)
        try:
            return holder["pool"].run(job, args, arrays)
        except BaseException:
            for p in holder["pool"].procs:       # a stuck or failed rank: start anew
                p.kill()
            holder["pool"].close()
            holder["pool"] = None
            raise

    yield run
    if holder["pool"] is not None:
        holder["pool"].close()


def flat(tree, prefix=""):
    """A nested dict of arrays as one level, keys joined by :data:`SEP`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + SEP))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def subtree(arrs, prefix):
    """The entries of ``arrs`` under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in arrs.items() if k.startswith(prefix)}
