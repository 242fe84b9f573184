"""The host runtime: the SPSC audio ring and the realtime time stretcher
(port of april_asr_tpu/native/__init__.py).

Both run in the repository's C++ library, `native/april_native.cc`, loaded
with ctypes through its flat C ABI. It is compiled on first use, under a
lock, with

    g++ -O2 -shared -fPIC -std=c++17 native/april_native.cc \
        -o build/torch_kernels/april_native-<hash>.so

into the kernels' build directory (`APRIL_TORCH_BUILD_DIR` overrides it;
the name carries a hash of the source and flags, so an edit rebuilds).
Where g++ or the build fails, `load_native` raises: the port does not go on
silently on NumPy. `NumpyRing` and `NumpyStretcher` are the JAX package's
NumPy versions of the two, kept as the plain versions the tests hold the
library against; no serving path uses them.

The reference's host runtime is src/audio_provider.{c,h} (the ring between
the caller's and the worker's threads) and src/sonic (the PICOLA stretch of
the ASYNC_RT catch-up mode, fbank.c:174-186).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "april_native.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    from ..ops.cuda_build import build_dir

    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"april_native-{h.hexdigest()[:12]}.so"


def build_native() -> tuple:
    """Compile the library if it is missing: (path, g++'s output, seconds),
    the output empty and the seconds 0 where it was built before."""
    import time

    if not SOURCE.exists():
        raise FileNotFoundError(f"the host runtime's source is missing: {SOURCE}")
    out = library_path()
    if out.exists():
        return out, "", 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host runtime (native/april_native.cc) is "
                           "built on first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, time.perf_counter() - t0


def load_native() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises where it cannot be)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build_native()
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes and restype of the C ABI (JAX native/__init__.py:111-136)."""
    i16p = ctypes.POINTER(ctypes.c_int16)
    u64 = ctypes.c_uint64
    p = ctypes.c_void_p
    sigs = {
        "an_ring_create": ([u64], p),
        "an_ring_free": ([p], None),
        "an_ring_capacity": ([p], u64),
        "an_ring_available": ([p], u64),
        "an_ring_dropped": ([p], u64),
        "an_ring_push": ([p, i16p, u64], u64),
        "an_ring_pull": ([p, i16p, u64], u64),
        "an_stretch_create": ([ctypes.c_int], p),
        "an_stretch_free": ([p], None),
        "an_stretch_set_speed": ([p, ctypes.c_double], None),
        "an_stretch_get_speed": ([p], ctypes.c_double),
        "an_stretch_write": ([p, i16p, u64], None),
        "an_stretch_flush": ([p], None),
        "an_stretch_available": ([p], u64),
        "an_stretch_read": ([p, i16p, u64], u64),
        "an_version": ([], ctypes.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _i16p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


class AudioRing:
    """Bounded SPSC PCM16 ring: one producer thread pushes, one consumer
    pulls. `push` is all-or-nothing: False means the block did not fit and
    the caller reports CANT_KEEP_UP (ap_push_audio, audio_provider.c:59-64)."""

    def __init__(self, capacity: int):
        self._lib = load_native()
        self._h = self._lib.an_ring_create(capacity)
        if not self._h:
            raise MemoryError("an_ring_create failed")
        self.capacity = capacity

    def push(self, pcm: np.ndarray) -> bool:
        pcm = np.ascontiguousarray(pcm, np.int16)
        return bool(self._lib.an_ring_push(self._h, _i16p(pcm), len(pcm)))

    def pull(self, max_samples: int) -> np.ndarray:
        out = np.empty(max_samples, np.int16)
        n = self._lib.an_ring_pull(self._h, _i16p(out), max_samples)
        return out[:n]

    @property
    def available(self) -> int:
        return int(self._lib.an_ring_available(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.an_ring_dropped(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.an_ring_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class TimeStretcher:
    """Pitch-synchronous speed-up (>= 1x) of PCM16 audio, with which
    ASYNC_RT sessions catch up when processing falls behind realtime
    (fbank_set_speed + sonic, fbank.c:164-186)."""

    def __init__(self, sample_rate: int):
        self._lib = load_native()
        self.sample_rate = sample_rate
        self._speed = 1.0
        self._h = self._lib.an_stretch_create(sample_rate)
        if not self._h:
            raise MemoryError("an_stretch_create failed")

    @property
    def speed(self) -> float:
        return self._speed

    def set_speed(self, speed: float) -> None:
        self._speed = max(1.0, float(speed))
        self._lib.an_stretch_set_speed(self._h, self._speed)

    def process(self, pcm: np.ndarray, flush: bool = False) -> np.ndarray:
        """Feed samples, return whatever stretched output is ready."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        if len(pcm):
            self._lib.an_stretch_write(self._h, _i16p(pcm), len(pcm))
        if flush:
            self._lib.an_stretch_flush(self._h)
        n = int(self._lib.an_stretch_available(self._h))
        out = np.empty(n, np.int16)
        if n:
            self._lib.an_stretch_read(self._h, _i16p(out), n)
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.an_stretch_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NumpyRing:
    """The plain version of `AudioRing` (JAX native/__init__.py:155-185, its
    NumPy fallback): the same all-or-nothing push and drop count."""

    def __init__(self, capacity: int):
        self._buf = np.zeros(capacity, np.int16)
        self._head = 0
        self._tail = 0
        self._dropped = 0
        self._lock = threading.Lock()
        self.capacity = capacity

    def push(self, pcm: np.ndarray) -> bool:
        pcm = np.ascontiguousarray(pcm, np.int16)
        with self._lock:
            if self._tail - self._head + len(pcm) > self.capacity:
                self._dropped += len(pcm)
                return False
            idx = (self._tail + np.arange(len(pcm))) % self.capacity
            self._buf[idx] = pcm
            self._tail += len(pcm)
            return True

    def pull(self, max_samples: int) -> np.ndarray:
        with self._lock:
            n = min(self._tail - self._head, max_samples)
            idx = (self._head + np.arange(n)) % self.capacity
            out = self._buf[idx].copy()
            self._head += n
            return out

    @property
    def available(self) -> int:
        with self._lock:
            return self._tail - self._head

    @property
    def dropped(self) -> int:
        return self._dropped


class NumpyStretcher:
    """The plain version of `TimeStretcher` (JAX native/__init__.py:254-298,
    `_process_numpy` and `_find_period`): AMDF pitch pick on a subsampled
    grid, linear cross-fade, a resampled tail at flush."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._speed = 1.0
        self._pending = np.zeros(0, np.int16)
        self._min_p = max(4, sample_rate // 400)
        self._max_p = sample_rate // 65

    @property
    def speed(self) -> float:
        return self._speed

    def set_speed(self, speed: float) -> None:
        self._speed = max(1.0, float(speed))

    def process(self, pcm: np.ndarray, flush: bool = False) -> np.ndarray:
        buf = np.concatenate([self._pending, np.ascontiguousarray(pcm, np.int16)])
        speed = self._speed
        if speed <= 1.0 + 1e-6:
            self._pending = np.zeros(0, np.int16)
            return buf
        out = []
        pos = 0
        x = buf.astype(np.float32)
        while len(buf) - pos >= 2 * self._max_p:
            seg = x[pos : pos + 2 * self._max_p]
            p = self._find_period(seg)
            t = np.arange(p, dtype=np.float32) / max(p, 1)
            ola = seg[:p] * (1.0 - t) + seg[p : 2 * p] * t
            out.append(ola.astype(np.int16))
            pos += 2 * p
            if speed < 2.0:
                keep = int(round(p * (2.0 - speed) / (speed - 1.0)))
                keep = min(keep, len(buf) - pos)
                out.append(buf[pos : pos + keep])
                pos += keep
            elif speed > 2.0:
                pos += min(int(round(p * (speed - 2.0))), len(buf) - pos)
        self._pending = buf[pos:]
        if flush and len(self._pending):
            n_in = len(self._pending)
            n_out = int(n_in / speed)
            t = np.arange(n_out) * speed
            j = np.minimum(t.astype(np.int64), n_in - 1)
            j1 = np.minimum(j + 1, n_in - 1)
            frac = (t - j).astype(np.float32)
            tail = self._pending[j] * (1.0 - frac) + self._pending[j1] * frac
            out.append(tail.astype(np.int16))
            self._pending = np.zeros(0, np.int16)
        return np.concatenate(out) if out else np.zeros(0, np.int16)

    def _find_period(self, seg: np.ndarray) -> int:
        best_p, best = self._min_p, None
        for p in range(self._min_p, self._max_p + 1):
            d = np.mean(np.abs(seg[0:p:4] - seg[p : 2 * p : 4]))
            if best is None or d < best:
                best, best_p = d, int(p)
        return best_p
