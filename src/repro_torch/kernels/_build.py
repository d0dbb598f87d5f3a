"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with ctypes.

Every source ``csrc/<name>.cu`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
All missing libraries are built together, one ``nvcc`` process per source,
started at once. A library is named after a hash of its source, the shared
headers and the flags, so an edited source is rebuilt and a stale library is
never loaded. The build directory sits next to ``csrc/`` and is listed in
``.gitignore``.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine-independent module only touches ``nvcc`` when a kernel is
first launched on a CUDA tensor (or :func:`build_all` is called).
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Any, Dict, List, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

#: One shared library per source, in this order.
SOURCES = ("partition", "hash_slide", "segment_fold", "spa_accum",
           "hash_accum", "topk_block")

#: Hopper only (``sm_90a``); no fast-math: every fold is an IEEE f32 add.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: The flag of the sources whose kernels add values: f32 adds (and
#: compares) flush subnormal inputs and results to signed zero, XLA's rule
#: (``xla_float``). ``topk_block`` only orders values and keeps their bits.
NVCC_FTZ = "-ftz=true"
FTZ_SOURCES = ("partition", "hash_slide", "segment_fold", "spa_accum",
               "hash_accum")


def flags(name: str) -> Tuple[str, ...]:
    """``nvcc`` flags of source ``name``."""
    return NVCC_FLAGS + ((NVCC_FTZ,) if name in FTZ_SOURCES else ())

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Any] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) from the build of ``name``'s current source."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build_all() -> float:
    """Compile every library that is missing, all ``nvcc`` processes in
    parallel. Returns the seconds spent (0.0 when everything was built).
    Raises with the compiler's output when any source fails."""
    with _lock:
        todo = [n for n in SOURCES if not os.path.exists(library_path(n))]
        if not todo:
            return 0.0
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.monotonic()
        procs = []
        for name in todo:
            out = library_path(name)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *flags(name), "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            with open(out[:-3] + ".log", "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})"
                                f"\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(library_path(name))
                lib.spk_error_string.argtypes = [ctypes.c_int]
                lib.spk_error_string.restype = ctypes.c_char_p
                lib.spk_max_dynamic_smem.argtypes = [
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
                lib.spk_max_dynamic_smem.restype = ctypes.c_int
                _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: List[Any]):
    """The C entry point ``symbol`` of library ``name``, with its argument
    types declared (pointers and the stream as ``c_void_p``) and a
    ``cudaError_t`` (int) result."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = load(SOURCES[0]).spk_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


@functools.lru_cache(maxsize=None)
def max_dynamic_smem(name: str, device_index: int) -> int:
    """Dynamic shared memory one block of ``name``'s kernel may opt in to on
    the device: the per-block opt-in limit less the kernel's static shared
    memory."""
    out = ctypes.c_int(0)
    check(load(name).spk_max_dynamic_smem(device_index, ctypes.byref(out)),
          f"{name}: shared-memory query")
    return int(out.value)


def stream_ptr(tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the tensor's
    device, as an int for ``ctypes.c_void_p``."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
