"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` becomes a shared library with a
plain C interface, compiled for ``sm_90a`` at first use into
``build/paddle_tpu_torch/`` at the repository root (listed in
``.gitignore``).  The library's file name carries a hash of its source,
so an edited source rebuilds and an unchanged one loads the library
already there.  ``build_all`` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "paddle_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# a lock older than this is left over from a build that died
STALE_LOCK_S = 600.0

_loaded = {}   # name -> ctypes.CDLL


def sources():
    """Names of every kernel source under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc():
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's "
            "CUDA kernels are built from source at first use")
    return cand


def _paths(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR,
                       f"lib{name}_{digest.hexdigest()[:16]}.so")
    return src, lib, lib + ".lock", lib + ".ptxas.txt"


def _lock_is_stale(lock):
    """True when the process named in ``lock`` is gone, or the lock is
    older than any build takes."""
    try:
        with open(lock) as f:
            pid = int(f.read().strip() or 0)
        age = time.time() - os.path.getmtime(lock)
    except (FileNotFoundError, ValueError):
        return True
    if age > STALE_LOCK_S:
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    return False


def _take_lock(lock):
    """Create ``lock`` exclusively; remove a stale one left by a build
    that died.  Returns False when a live build holds it."""
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        if _lock_is_stale(lock):
            try:
                os.remove(lock)
            except FileNotFoundError:
                pass
        return False
    os.write(fd, str(os.getpid()).encode())
    os.close(fd)
    return True


def _start(name):
    """Start nvcc for ``name`` unless its library is already built.
    Returns ``(name, process or None, paths)``."""
    src, lib, lock, log = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if os.path.exists(lib):
        return name, None, (lib, lock, log)
    while not _take_lock(lock):
        if os.path.exists(lib):
            return name, None, (lib, lock, log)
        time.sleep(0.2)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, (lib, lock, log, tmp)


def _finish(name, proc, paths):
    lib, lock, log = paths[:3]
    if proc is not None:
        tmp = paths[3]
        try:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{text}")
            with open(log, "w") as f:
                f.write(text)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
            os.remove(lock)
    return lib


def build_all():
    """Build every kernel source in parallel (one nvcc each) and load the
    libraries.  Returns ``{name: ptxas report}``."""
    started = [_start(n) for n in sources()]
    reports = {}
    for name, proc, paths in started:
        lib_path = _finish(name, proc, paths)
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(lib_path)
        log = paths[2]
        reports[name] = ""
        if os.path.exists(log):
            with open(log) as f:
                reports[name] = f.read()
    return reports


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib_path = _finish(*_start(name))
        lib = _loaded[name] = ctypes.CDLL(lib_path)
    return lib

