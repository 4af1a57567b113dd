"""Build the port's CUDA sources into C-ABI shared libraries, and load them.

Every ``csrc/<name>.cu`` is compiled by nvcc for ``sm_90a`` into
``build/sslrec_tpu_torch/lib<name>.so`` (gitignored) at first use, and loaded
with ctypes.  A library is rebuilt when forced or when its source is newer;
each build writes a temporary file and renames it whole, so concurrent
builders never load a half-written library.  Several libraries build at once,
one nvcc process per source.  Needs ``nvcc`` (``$CUDA_HOME/bin``, default
``/usr/local/cuda``); a failed build raises, naming the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "sslrec_tpu_torch")
KERNELS = ("csr_spmm", "segment_max")
_LOADED: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_libraries(names=KERNELS, force: bool = False) -> dict[str, tuple[str, str]]:
    """Compile each named source whose library is missing or older than it
    (every one when ``force``), all nvcc processes started together.

    Returns ``{name: (library path, nvcc output)}``; the output holds ptxas's
    register and spill counts, and is empty for a library that was current.
    Waits for every process it started, then raises if any failed.
    """
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    done, running = {}, {}
    for name in names:
        src, so = source_path(name), library_path(name)
        if (not force and os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src)):
            done[name] = (so, "")
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp, src]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"lib{name}.so: nvcc exited {proc.returncode}:\n{out}")
            continue
        os.replace(tmp, so)
        done[name] = (so, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return done


def load_kernel(name: str, symbol: str, argtypes: list):
    """``symbol`` of the library of ``csrc/<name>.cu`` (built first if needed),
    declared to take ``argtypes`` and to return a ``cudaError_t`` as an int."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(build_libraries((name,))[name][0])
    fn = getattr(_LOADED[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
