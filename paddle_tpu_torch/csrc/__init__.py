"""The host library (C++), built with the system ``c++`` and loaded with
ctypes — counterpart of ``paddle_tpu/csrc/__init__.py``.

``blocking_queue.cc`` (the ordered MPMC queue under the ``DataLoader``)
and ``dataset.cc`` (the ``InMemoryDataset`` engine) are copies of the
JAX package's sources.  ``load`` compiles them at first use
(``-O2 -fPIC -std=c++17 -pthread -shared``) into ``build/paddle_tpu_torch/``
at the repository root, beside the CUDA kernels, under a file name that
carries a hash of the two sources and the flags, with the kernels' lock
(``ops/_build.py``); it never writes into the source tree.  A failed
build raises ``RuntimeError`` with the compiler's stderr, where the JAX
package falls back to ``queue.Queue`` without a word.

The CUDA sources (``*.cu``) beside them are built by ``ops/_build.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

SOURCES = ("blocking_queue.cc", "dataset.cc")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_LIB = None
_lock = threading.Lock()


def source_hash(*names):
    """sha256 of the named sources, concatenated (the value embedded in
    the library as ``ptq_source_hash``)."""
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for n in names:
        with open(os.path.join(here, n), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def lib_path():
    """Where the library of the sources on disk lives (built or not)."""
    from ..ops._build import BUILD_DIR
    digest = hashlib.sha256((source_hash(*SOURCES) + " ".join(
        CXX_FLAGS)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libptq_{digest}.so")


def _compiler():
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler (c++ or g++ on PATH, or $CXX): the port's "
            "host library (paddle_tpu_torch/csrc/*.cc) is built from "
            "source at first use")
    return cxx


def build():
    """Compile the library unless it is built; returns its path."""
    from ..ops._build import BUILD_DIR, _take_lock
    lib = lib_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    lock = lib + ".lock"
    while not _take_lock(lock):
        if os.path.exists(lib):
            return lib
        time.sleep(0.1)
    try:
        if os.path.exists(lib):
            return lib
        here = os.path.dirname(os.path.abspath(__file__))
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_compiler(), *CXX_FLAGS,
               f'-DPTQ_SRC_HASH="{source_hash(*SOURCES)}"', "-o", tmp,
               *[os.path.join(here, s) for s in SOURCES]]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(
                f"building the host library failed ({' '.join(cmd)}):\n"
                f"{res.stderr}")
        os.replace(tmp, lib)
        return lib
    finally:
        try:
            os.remove(lock)
        except FileNotFoundError:
            pass


def _bind(lib):
    c = ctypes
    lib.ptq_source_hash.restype = c.c_char_p
    lib.ptq_new.restype = c.c_void_p
    lib.ptq_new.argtypes = [c.c_int64, c.c_int]
    lib.ptq_put.restype = c.c_int
    lib.ptq_put.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_int64]
    lib.ptq_get.restype = c.c_int
    lib.ptq_get.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_int64),
                            c.POINTER(c.c_void_p), c.POINTER(c.c_int64)]
    lib.ptq_close.argtypes = [c.c_void_p]
    lib.ptq_size.restype = c.c_int64
    lib.ptq_size.argtypes = [c.c_void_p]
    lib.ptq_free.argtypes = [c.c_void_p]
    # the dataset engine (dataset.cc)
    lib.ptds_new.restype = c.c_void_p
    lib.ptds_new.argtypes = []
    lib.ptds_free.argtypes = [c.c_void_p]
    lib.ptds_set_filelist.argtypes = [c.c_void_p, c.POINTER(c.c_char_p),
                                      c.c_int]
    lib.ptds_load_into_memory.restype = c.c_int64
    lib.ptds_load_into_memory.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.ptds_num_records.restype = c.c_int64
    lib.ptds_num_records.argtypes = [c.c_void_p]
    lib.ptds_local_shuffle.argtypes = [c.c_void_p, c.c_uint64]
    lib.ptds_get_batch.restype = c.c_int64
    lib.ptds_get_batch.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                   c.POINTER(c.c_float)]
    lib.ptds_shard.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.ptds_reset_order.argtypes = [c.c_void_p]
    lib.ptds_release_memory.argtypes = [c.c_void_p]
    return lib


def load():
    """The library, built on first use; raises when it cannot be built
    or when the loaded binary does not carry the sources' hash."""
    global _LIB
    with _lock:
        if _LIB is None:
            path = build()
            lib = _bind(ctypes.CDLL(path))
            got = lib.ptq_source_hash().decode()
            if got != source_hash(*SOURCES):
                raise RuntimeError(
                    f"{path} embeds source hash {got}, not the sources' "
                    f"{source_hash(*SOURCES)}: remove it to rebuild")
            _LIB = lib
            _LIB.path = path
    return _LIB


def available() -> bool:
    """True when the library builds and loads (its build errors are
    ``load``'s to raise)."""
    try:
        load()
    except RuntimeError:
        return False
    return True


class NativeOrderedQueue:
    """Bounded MPMC queue that hands items out in sequence order, in
    native code.

    Payloads are Python objects held in a registry here; the native side
    moves only (seq, slot) pairs, and its mutex hand-off runs outside
    the GIL.  ``get`` raises ``StopIteration`` once the queue is closed
    and drained, ``TimeoutError`` when ``timeout_ms`` passes first.
    """

    def __init__(self, capacity=8):
        self._lib = load()
        self._q = ctypes.c_void_p(self._lib.ptq_new(capacity, 1))
        self._store = {}
        self._store_lock = threading.Lock()
        self._next_slot = 0

    def put(self, seq, obj):
        with self._store_lock:
            slot = self._next_slot
            self._next_slot += 1
            self._store[slot] = obj
        rc = self._lib.ptq_put(self._q, seq, ctypes.c_void_p(slot + 1), 0)
        if rc != 0:
            with self._store_lock:
                self._store.pop(slot, None)
            raise RuntimeError("queue closed")

    def get(self, timeout_ms=-1):
        seq = ctypes.c_int64()
        data = ctypes.c_void_p()
        length = ctypes.c_int64()
        rc = self._lib.ptq_get(self._q, timeout_ms, ctypes.byref(seq),
                               ctypes.byref(data), ctypes.byref(length))
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise TimeoutError
        with self._store_lock:
            obj = self._store.pop((data.value or 1) - 1)
        return seq.value, obj

    def close(self):
        self._lib.ptq_close(self._q)

    def __del__(self):
        try:
            self._lib.ptq_close(self._q)
            self._lib.ptq_free(self._q)
        except Exception:
            pass
