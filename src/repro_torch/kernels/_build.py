"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/<hash of source and flags>/lib<name>.so``
under the repository root (``build/`` is git-ignored), with a plain C
interface that ``ctypes`` loads — no PyTorch headers, so a build takes
seconds. ``-fmad=false`` keeps every multiply and add separately rounded,
as XLA's dequantize-then-sum is. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points of wire.cu: (argtypes), all return cudaGetLastError()
WIRE_API = {
    "wire_quantize": (_P, _P, _P, _I64, _I64, _I32, _P),
    "wire_dequantize": (_P, _P, _P, _I64, _P),
    "wire_quant_avg_dequant": (_P, _P, _I64, _I64, _I32, _P),
    "wire_quant_avg_dequant_ef": (_P, _P, _P, _P, _I64, _I64, _I32, _P),
}

#: compiler output (``-Xptxas -v``) of the builds this process ran
BUILD_LOGS = {}
_LOADED = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA wire kernels are built on "
                       "a machine with the CUDA toolkit")


def lib_path(name="wire"):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return REPO_ROOT / "build" / "kernels" / h.hexdigest()[:16] / \
        f"lib{name}.so"


def build_cmd(name, out):
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(name="wire"):
    """Compile ``csrc/<name>.cu`` unless its library already exists; the
    library is written to a temporary name and renamed into place, so a
    concurrent build never loads a half-written file."""
    out = lib_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        res = subprocess.run(build_cmd(name, tmp), capture_output=True,
                             text=True, check=False)
        BUILD_LOGS[name] = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name="wire"):
    """Build (if needed) and load the library once per process, with the
    ``argtypes`` / ``restype`` of every entry point declared."""
    if name not in _LOADED:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in WIRE_API.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]
