"""ctypes bindings for the port's native host runtime (`hp_runtime.cpp`).

A copy of `hyperpose_tpu/runtime/native/__init__.py` (bounded queues, an
affinity-pinned worker pool and the bilinear resize into a batch slot) with
one change: the library is built at first use with the host C++ compiler into
`build/hyperpose_torch/` beside the package (listed in `.gitignore`), under a
name that carries a hash of the source and the flags, never into the package
directory. Without a compiler `get_lib()` returns None and the stream runtime
uses its Python queues and the numpy resize, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ...ops.kernels.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "hp_runtime.cpp"
# No -march=native: the build directory may be shared by hosts of other CPUs.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_build_lock = threading.Lock()
build_error: str | None = None  # why the last build failed, if it did

# C task callback signature for the native worker pool.
TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def library_path() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libhp_runtime-{digest}.so"


def _build() -> Path | None:
    global build_error
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        build_error = "no C++ compiler (g++ or c++) on PATH"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                       check=True, capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as e:
        build_error = e.stderr or str(e)
        tmp.unlink(missing_ok=True)
        return None
    except (subprocess.SubprocessError, OSError) as e:
        build_error = str(e)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        lib.hp_queue_new.restype = p
        lib.hp_queue_new.argtypes = [i64]
        lib.hp_queue_free.argtypes = [p]
        lib.hp_queue_push.restype = ctypes.c_int
        lib.hp_queue_push.argtypes = [p, i64]
        lib.hp_queue_try_push.restype = ctypes.c_int
        lib.hp_queue_try_push.argtypes = [p, i64]
        lib.hp_queue_pop.restype = ctypes.c_int
        lib.hp_queue_pop.argtypes = [p, ctypes.POINTER(i64), i64]
        lib.hp_queue_dump.restype = i64
        lib.hp_queue_dump.argtypes = [p, ctypes.POINTER(i64), i64, i64]
        lib.hp_queue_close.argtypes = [p]
        lib.hp_queue_stats.argtypes = [p, ctypes.POINTER(i64)]
        lib.hp_copy_into_batch.argtypes = [
            ctypes.c_char_p, i64, i64, ctypes.c_char_p, i64, i64, i64,
        ]
        lib.hp_resize_into_batch.argtypes = [
            ctypes.c_char_p, i64, i64, ctypes.c_char_p, i64, i64, i64,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.hp_pool_new.restype = p
        lib.hp_pool_new.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.hp_pool_free.argtypes = [p]
        lib.hp_pool_enqueue.argtypes = [p, TASK_FN, p]
        lib.hp_pool_wait.argtypes = [p]
        _lib = lib
        return _lib


def resize_into_batch(img, batch, slot: int, keep_ratio: bool = False,
                      swap_rb: bool = False):
    """Native bilinear resize of an HWC3 uint8 frame straight into
    `batch[slot]` (letterbox when keep_ratio; `swap_rb` swaps R and B).
    Returns (rx, ry) coverage ratios, or None when the native library is
    unavailable or the frame is not HWC3 uint8 (the caller then resizes with
    `ops.image.resize_bilinear`, which gives the same bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        return None
    if not img.flags["C_CONTIGUOUS"]:
        img = np.ascontiguousarray(img)
    assert batch.dtype == np.uint8 and batch.flags["C_CONTIGUOUS"]
    b, dh, dw, _ = batch.shape
    assert 0 <= slot < b
    ratio = (ctypes.c_float * 2)()
    lib.hp_resize_into_batch(
        img.ctypes.data_as(ctypes.c_char_p), img.shape[0], img.shape[1],
        batch.ctypes.data_as(ctypes.c_char_p), slot, dh, dw,
        1 if keep_ratio else 0, 1 if swap_rb else 0, ratio,
    )
    return float(ratio[0]), float(ratio[1])


class NativeQueue:
    """Bounded MPMC token queue backed by the C++ ring buffer; carries
    Python objects through a token registry."""

    def __init__(self, capacity: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {build_error}")
        self._lib = lib
        self._q = lib.hp_queue_new(capacity)
        self._objects: dict[int, object] = {}
        self._next = 1
        self._reg_lock = threading.Lock()

    def push(self, obj) -> bool:
        with self._reg_lock:
            token = self._next
            self._next += 1
            self._objects[token] = obj
        if self._lib.hp_queue_push(self._q, token) != 0:
            with self._reg_lock:
                self._objects.pop(token, None)
            return False
        return True

    def pop(self, timeout_ms: int = -1):
        out = ctypes.c_int64(0)
        rc = self._lib.hp_queue_pop(self._q, ctypes.byref(out), timeout_ms)
        if rc == 1:
            raise TimeoutError
        if rc == -1:
            raise EOFError
        with self._reg_lock:
            return self._objects.pop(out.value)

    def dump(self, max_items: int, timeout_ms: int = -1) -> list:
        buf = (ctypes.c_int64 * max_items)()
        n = self._lib.hp_queue_dump(self._q, buf, max_items, timeout_ms)
        if n == 0:
            stats = self.stats()
            if stats["closed"] and stats["size"] == 0:
                raise EOFError
            return []
        with self._reg_lock:
            return [self._objects.pop(buf[i]) for i in range(n)]

    def close(self):
        self._lib.hp_queue_close(self._q)

    def stats(self) -> dict:
        s = (ctypes.c_int64 * 5)()
        self._lib.hp_queue_stats(self._q, s)
        return {
            "size": s[0], "capacity": s[1], "pushed": s[2], "popped": s[3],
            "closed": bool(s[4]),
        }

    def __del__(self):
        try:
            self._lib.hp_queue_free(self._q)
        except Exception:
            pass


class NativePool:
    """Affinity-pinned C++ worker pool driving Python callables via a
    ctypes trampoline (reference: src/thread_pool.cpp:39-68)."""

    def __init__(self, n_threads: int, pin_affinity: bool = True):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {build_error}")
        self._lib = lib
        self._pool = lib.hp_pool_new(n_threads, 1 if pin_affinity else 0)
        self._tasks: dict[int, object] = {}
        self._next = 1
        self._lock = threading.Lock()

        def trampoline(ctx):
            with self._lock:
                fn = self._tasks.pop(int(ctx), None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass

        self._trampoline = TASK_FN(trampoline)  # keep alive

    def enqueue(self, fn) -> None:
        with self._lock:
            token = self._next
            self._next += 1
            self._tasks[token] = fn
        self._lib.hp_pool_enqueue(self._pool, self._trampoline, token)

    def wait(self) -> None:
        self._lib.hp_pool_wait(self._pool)

    def close(self) -> None:
        if self._pool is not None:
            self._lib.hp_pool_free(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
