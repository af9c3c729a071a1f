"""Build the port's CUDA C++ kernels with `nvcc` and bind them with ctypes.

Each source `msml_torch/csrc/<name>.cu` is compiled at its first launch,
for Hopper only, into `msml_torch/_build/cuda/lib<name>_<hash>.so`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas=-v -o lib<name>_<hash>.so <name>.cu

The hash covers the source and the flags, so an edited source builds
anew. The sources have a plain C interface: every pointer and the stream
go in as `c_void_p`, every int as `c_int`, and each entry point returns
the `cudaError_t` of its launch, which `check` turns into an exception
with the text of the library's `cuda_error_string`.
`nvcc` is looked up in `$CUDA_HOME/bin`, then on `PATH`; the module
imports without it, and a build without it raises. Each library builds
once in a process: a thread that reaches its first use while another
thread builds it waits for that build and loads the result (two sources
still build side by side).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "cuda")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

builds: dict = {}  # name -> {"seconds", "nvcc", "log", "path"}, this process
_LOCKS: dict = {}  # name -> the lock held while its library is built
_LOCKS_GUARD = threading.Lock()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built at first use")


def nvcc_version(nvcc: str) -> str:
    """The last line of `nvcc --version` (the release and build)."""
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it if needed."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{name}_{digest.hexdigest()[:16]}.so")
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if not os.path.exists(lib_path):
            _build(name, src, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _build(name: str, src: str, lib_path: str) -> None:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src} "
                           f"(exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    builds[name] = {"seconds": time.perf_counter() - t0,
                    "nvcc": nvcc_version(nvcc),
                    "log": proc.stdout + proc.stderr, "path": lib_path}


def signature(fn, pointers: int, ints: int) -> None:
    """`pointers` c_void_p arguments, then `ints` c_int, then the stream;
    returns the cudaError_t as an int."""
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
