"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into its own shared library with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

then loaded with ``ctypes``: pointers and the CUDA stream travel as
``c_void_p``, sizes as ``c_int``.  Libraries land in ``_build/`` next to
this file (ignored by git), named by a hash of their source, so an edited
source rebuilds and an unchanged one is reused.  :func:`build_all` starts
one ``nvcc`` per source at once; a failed build raises with the compiler's
output.

Every launch function returns ``cudaGetLastError()``; :meth:`Kernel.launch`
raises on anything but success, because a refused launch never runs and
a later synchronise does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else the toolkit's default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of distkeras_torch are "
                       "compiled at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> Tuple[Path, Optional[subprocess.Popen], Optional[Path]]:
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders (several
    # test processes on one machine) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, proc, Path(tmp)


def _finish(name: str, out: Path, proc: Optional[subprocess.Popen],
            tmp: Optional[Path]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, out)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile every listed source (default: all of ``csrc/``) in parallel."""
    names = list(names) if names is not None else sources()
    with _LOCK:
        started = [(n, *_start(n)) for n in names]
        errors = []
        for name, out, proc, tmp in started:
            try:
                _finish(name, out, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.dk_error_string.argtypes = [ctypes.c_int]
            lib.dk_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


class Kernel:
    """One hand-written kernel: its library, its C entry point and the
    count of launches made through its wrapper."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point, raise on a launch error, count it."""
        err = self.fn()(*args)
        if err != 0:
            msg = load(self.source).dk_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err} "
                               f"({msg})")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
