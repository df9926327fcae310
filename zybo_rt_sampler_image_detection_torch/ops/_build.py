"""Build + ctypes binding for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/lib<name>-<digest>.so`` beside the package (override with
``ZRT_TORCH_KERNEL_DIR``; git ignores ``build/``).  The digest keys the
binary by the content of the source and of the ``csrc/*.cuh`` headers it
includes, so an edited kernel or header is rebuilt.  Nothing here
runs at import: the CPU tests import every module on hosts with no
``nvcc``.  The same idiom as ``ingest/native_build.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_LOCK = threading.Lock()
_LIBS: dict = {}
# seconds each kernel library took to build (0.0 when it was found built)
build_seconds: dict = {}


def _build_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get("ZRT_TORCH_KERNEL_DIR",
                          os.path.join(root, "build", "kernels"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build from source on first use")


def _digest(src: str) -> str:
    """The build key of a source: its content and that of every
    ``csrc/*.cuh`` it includes (``#include "x.cuh"``, followed through the
    headers), so an edited shared header rebuilds every library using it."""
    h = hashlib.sha256()
    seen, todo = set(), [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b"\0" + text)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', text,
                              re.MULTILINE):
            todo.append(os.path.join(_CSRC, inc.decode()))
    return h.hexdigest()[:12]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not built yet); returns the .so."""
    src = os.path.join(_CSRC, f"{name}.cu")
    digest = _digest(src)
    out_dir = _build_dir()
    so = os.path.join(out_dir, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        build_seconds.setdefault(name, 0.0)
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    # ptxas -v: registers, shared memory and spills of each kernel
    with open(os.path.join(out_dir, f"{name}.ptxas.txt"), "w") as f:
        f.write(res.stderr)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build(name))
        return lib
