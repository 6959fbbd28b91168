"""Build the port's CUDA sources into shared libraries with a plain C interface.

Each source ``meshrcnn_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``meshrcnn_tpu_torch/_build/<name>_<digest>.so`` at first use
and loaded with ``ctypes``. The digest covers the source, the headers of
``csrc/`` and the flags, so an edit rebuilds and an unchanged tree reuses the
library. ``build`` starts one ``nvcc`` per missing library, all at once.

``host_build`` / ``load_host`` do the same for a C source of the host,
``csrc/<name>.c``, compiled by the host's ``cc`` (the compiler ``nvcc``
drives as well) into ``_build/<name>_<digest>.so``. Each build writes a file
of its own and renames it into place, so processes that build one library at
once (test workers, loader threads) end with one library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))
CC_FLAGS = ("-O3", "-std=c11", "-shared", "-fPIC")

build_log: Dict[str, str] = {}     # name -> nvcc's output of the last build here
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` at this tree's sources lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[:-1]).encode())   # not the checkout's path
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every library of ``names`` not built yet, all in parallel."""
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        build_log[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{CSRC / f'{n}.cu'}:\n{build_log[n]}" for n in failed))
    return out


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with each C function of
    ``signatures`` given its argument types; every function returns a cudaError int."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def host_library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.c`` at this tree's source lives."""
    h = hashlib.sha256((CSRC / f"{name}.c").read_bytes())
    h.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def host_build(name: str) -> Path:
    """Compile ``csrc/<name>.c`` with ``cc`` unless it is built already; a
    failed compile raises with the compiler's output."""
    path = host_library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", prefix=f"{name}_", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["cc", *CC_FLAGS, "-o", tmp, str(CSRC / f"{name}.c")],
                              capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"cc failed on {CSRC / f'{name}.c'}:\n{build_log[name]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_host(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.c``, built if needed, with each C function
    of ``signatures`` given its (result type, argument types)."""
    if name not in _libs:
        lib = ctypes.CDLL(str(host_build(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        _libs[name] = lib
    return _libs[name]
