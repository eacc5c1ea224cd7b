"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` becomes a shared library with a
plain C interface, compiled for ``sm_90a`` at first use into
``build/paddle_tpu_torch/`` at the repository root (listed in
``.gitignore``).  The library's file name carries a hash of its source,
so an edited source rebuilds and an unchanged one loads the library
already there.  ``build_all`` starts one ``nvcc`` per source, all at
once; the ragged source is compiled as ``RAGGED_PARTS`` objects in
parallel (one ``nvcc -c`` a part, ``RPA_PART`` set to the part's
number) and linked into its library.  Nothing here runs at import: the CPU
tests import every module.
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
# the ragged source's 40 kernels take two minutes in one nvcc; each of
# its parts 0-3 instantiates a quarter of them, and part 4 is its C
# interface
RAGGED = "ragged_paged_attn"
RAGGED_PARTS = 5
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


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start(name):
    """Start nvcc for ``name`` unless its library is already built: one
    process, or one a part for the ragged source.  Returns ``(name,
    processes, paths)``, ``paths`` ending with the temporary library and
    the part objects to link."""
    src, lib, lock, log = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if os.path.exists(lib):
        return name, [], (lib, lock, log)
    while not _take_lock(lock):
        if os.path.exists(lib):
            return name, [], (lib, lock, log)
        time.sleep(0.2)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if name != RAGGED:
        return name, [_run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src])], (
            lib, lock, log, tmp, [])
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.{k}.o" for k in range(RAGGED_PARTS)]
    procs = [_run([_nvcc(), *flags, f"-DRPA_PART={k}", "-c", "-o", obj, src])
             for k, obj in enumerate(objs)]
    return name, procs, (lib, lock, log, tmp, objs)


def _finish(name, procs, paths):
    lib, lock, log = paths[:3]
    if not procs:
        return lib
    tmp, objs = paths[3:]
    try:
        texts = []
        for proc in procs:
            text, _ = proc.communicate()
            texts.append(text)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{text}")
        if objs:
            link = _run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                         *objs])
            text, _ = link.communicate()
            if link.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to link csrc/{name}.cu's parts "
                    f"(exit {link.returncode}):\n{text}")
        with open(log, "w") as f:
            f.write("".join(texts))
        os.replace(tmp, lib)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in [tmp, *objs]:
            if os.path.exists(path):
                os.remove(path)
        os.remove(lock)
    return lib


def build_all():
    """Build every kernel source in parallel (one nvcc each, or one a
    part) and load the libraries.  Returns ``{name: ptxas report}``."""
    started = [_start(n) for n in sources()]
    reports = {}
    for name, procs, paths in started:
        lib_path = _finish(name, procs, paths)
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

