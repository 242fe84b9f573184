"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

No `--use_fast_math`: the kernels call `tanhf`, `logf` and `rsqrtf` as
written. The library name carries a hash of the source and flags, so an edit
rebuilds and a stale library is never loaded. The build directory defaults to
`build/torch_kernels/` beside the package (override: APRIL_TORCH_BUILD_DIR).

`build_all()` starts one nvcc per source at once and waits for all of them,
which is how `chip_smoke.py` keeps the build inside its time limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fbank_i8", "lstm_i8", "chunk_decode", "fbank_bf16x3", "lstm_chunk", "lstm_step",
           "joiner", "conv_embed", "lstm_chunk_i8", "lstm_wavefront", "int8_mm", "lstm_tp",
           "lstm_mma", "lstm_mma_float", "lstm_chunk_mma")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# Launch counts per kernel: each wrapper adds one where it launches its
# kernel, and nowhere else (the CPU path and the plain versions never count).
# A kernel built for two weight types counts each under its own key.
COUNTS: Dict[str, int] = {
    "fbank_i8": 0, "lstm_rec_stream2_i8": 0, "ffn_norm_i8": 0, "chunk_decode": 0,
    "chunk_decode_f32": 0, "fbank_bf16x3": 0, "lstm_chunk_mma_f32": 0, "lstm_chunk_mma_bf16": 0,
    "lstm_step_i8": 0, "lstm_step_f32": 0, "lstm_step_bf16": 0, "dec_joiner": 0,
    "dec_joiner_f32": 0, "joiner_argmax": 0, "joiner_argmax_f32": 0, "conv_embed": 0,
    "conv_embed_front": 0, "fbank_frames": 0, "lstm_rec_i8": 0, "lstm_rec_stream_i8": 0,
    "lstm_chunk_i8": 0, "lstm_wavefront_i8": 0, "mm_bf16": 0, "mm_i8": 0, "mm_i8_dynq": 0,
    "rec_interleave_i8": 0, "tp_gcp_f32": 0, "tp_gcp_bf16": 0, "tp_gc_i8": 0, "tp_ffn_f32": 0,
    "tp_ffn_bf16": 0, "tp_ffn_mid_i8": 0, "lstm_step_i8_simt": 0, "lstm_step_float_simt": 0,
    "lstm_chunk_simt": 0, "ffn_norm_i8_r8": 0, "ffn_norm_i8_r4": 0,
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def build_dir() -> Path:
    d = os.environ.get("APRIL_TORCH_BUILD_DIR")
    if d:
        return Path(d)
    return CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns nvcc's output
    (register and shared-memory use from -Xptxas -v) per built source."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        return {n: _finish(n, out, job) for n, out, job in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def bind(name: str, fn: str, n_ptr: int, n_int: int, n_float: int = 0):
    """ctypes handle for `int fn(void* x n_ptr, int x n_int, float x n_float,
    void* stream)`: every pointer and the stream are c_void_p; the C
    function returns cudaGetLastError() of its launch."""
    f = getattr(load(name), fn)
    f.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float] * n_float + [ctypes.c_void_p]
    )
    f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
