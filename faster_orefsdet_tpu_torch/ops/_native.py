"""Build and load the hand-written CUDA kernels of ``csrc/``, and its host
C++ library.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers) into ``_build/<hash>/lib<name>.so``, which is loaded
with ``ctypes``. The hash covers the sources and the flags, so an edited
source builds anew; all sources compile in parallel, once per process, at the
first kernel launch. ``csrc/cocoeval.cc`` (the COCO matcher) builds the same
way with the host's ``g++`` (``host_library``), at its first use. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
SOURCES = ("cgm", "nms")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of each library's functions: {name: (argtypes, restype)}
_SIGNATURES = {
    "cgm": {"cgm_forward": ([_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP], _I)},
    "nms": {
        "nms_forward": ([_VP, _VP, _VP, ctypes.c_float, _I, _I, _VP, _VP, _VP], _I),
        "nms_workspace_bytes": ([_I, _I], ctypes.c_longlong),
    },
}


_D, _I64, _U8 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
# C signatures of the host libraries' functions
_HOST_SIGNATURES = {
    "cocoeval": {"evaluate_image": ([_D, _I64, _D, _I64, _U8, _U8, _D, _I64, ctypes.c_double, ctypes.c_double,
                                     _U8, _U8], None)},
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the CUDA kernels need nvcc to build")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source not yet built (all nvcc processes at once) and
    return {name: path of its .so}. The compiler's register and shared-memory
    report lands in ``<name>.log`` beside each library."""
    out = _build_dir()
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    if all(p.exists() for p in libs.values()):
        return libs
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in SOURCES if not libs[n].exists()]
        procs = {}
        for name in todo:
            tmp = out / f"lib{name}.so.tmp"
            log = open(out / f"{name}.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp)
        failed = []
        for name, (proc, log, tmp) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{name}.cu (nvcc rc={rc}):\n{(out / f'{name}.log').read_text()}")
            else:
                os.replace(tmp, libs[name])
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` with its functions' signatures set."""
    lib = ctypes.CDLL(str(build()[name]))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.error_string(rc).decode()})")


@functools.lru_cache(maxsize=None)
def host_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cc`` built with the host's g++ into
    ``_build/<hash>/lib<name>.so`` (once; the hash covers the source and the
    flags) and loaded, its functions' signatures set. A failed build raises,
    naming the command."""
    src = CSRC_DIR / f"{name}.cc"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16]
    path = out / f"lib{name}.so"
    if not path.exists():
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                tmp = out / f"lib{name}.so.tmp"
                cmd = [shutil.which("g++") or "g++", *CXX_FLAGS, "-o", str(tmp), str(src)]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"host build of {src.name} failed: {' '.join(cmd)}: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"host build of {src.name} failed (rc={proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stderr}")
                os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for fn_name, (argtypes, restype) in _HOST_SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
