"""Build the CUDA kernels in ``csrc/`` into one shared library, at first use.

Every ``csrc/*.cu`` exposes a plain C interface, so ``nvcc`` compiles each
in seconds (no PyTorch headers): one ``nvcc`` per source, all started
together, then one link; ``ctypes`` loads the result. The library lands in
``tim_tpu_torch/build/`` under a name keyed by a hash of the sources and
flags; a build that fails, or a host without ``nvcc``, raises
``RuntimeError``. There is no fallback: the plain PyTorch versions run
only for tensors on the CPU. (``csrc/host/`` holds host C++ that
``evals/nms.py`` builds with ``g++``.) Beside the library, a ``.log``
keeps each source's compile seconds and ``ptxas``' resource report
(registers, spills per kernel); ``resource_usage`` reads it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the
    toolkit's default install, or None."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.isfile(default) else None


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(nvcc: str, src: str, obj: str):
    """One nvcc over ``src``: (the finished process, its seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                          capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build() -> str:
    """Compile the kernels if no library for these sources exists yet;
    returns the library's path."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    out = os.path.join(_BUILD_DIR, f"libtim_kernels_{_source_hash(srcs)}.so")
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # unique temp names + atomic rename: concurrent builds never load a
    # half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            done = list(pool.map(lambda so: _compile(nvcc, *so),
                                 zip(srcs, objs)))
        failed, log = [], []
        for src, (proc, seconds) in zip(srcs, done):
            if proc.returncode != 0:
                failed.append(f"{src} ({proc.returncode}):\n{proc.stdout}\n"
                              f"{proc.stderr}")
            log.append(f"== {os.path.basename(src)} {seconds:.2f} s\n"
                       f"{proc.stderr}")
        if failed:
            raise RuntimeError("nvcc failed building " + "\n".join(failed))
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {objs}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(f"{out}.log", "w") as f:
            f.write("\n".join(log))
        os.replace(tmp, out)
    finally:
        for path in objs:
            if os.path.exists(path):
                os.remove(path)
    return out


def resource_usage(lib: str) -> Tuple[List[str], List[tuple]]:
    """From the build log beside ``lib``: the lines giving each source's
    compile seconds, and (mangled kernel, registers, spill store bytes,
    spill load bytes) per kernel as ``ptxas -v`` reported them."""
    with open(f"{lib}.log") as f:
        text = f.read()
    sources = re.findall(r"^== (\S+ [0-9.]+ s)$", text, re.M)
    kernels = []
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        kernels.append((name, int(regs.group(1)) if regs else -1,
                        *(int(x) for x in (spill.groups() if spill
                                           else (-1, -1)))))
    return sources, kernels


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


def launcher(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's C launcher ``name``, its argument types set on first
    use; it returns a CUDA error code (ctypes' default ``int`` result)."""
    fn = getattr(library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
    return fn


def check(status: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code (``cudaGetLastError``
    right after the launch: a refused launch never runs, and a later
    synchronise would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
