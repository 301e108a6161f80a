"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/<hash of source and flags>/lib<name>.so``
under the repository root (``build/`` is git-ignored), with a plain C
interface that ``ctypes`` loads — no PyTorch headers, so a build takes
seconds. Each library has its own flags (``NVCC_FLAGS``), hashed into its
path, and its own C entry points (``API``): the wire kernels build with
``-fmad=false``, which keeps every multiply and add separately rounded as
XLA's dequantize-then-sum is; flash attention (held to 2e-5), the
mLSTM recurrence (2e-4) and the selective scan (1e-5) keep fused
multiply-adds, as does decode attention (K8, held to 1e-5). Flash
attention and the mLSTM share ``csrc/tf32_mma.cuh``
(the 3xTF32 tensor-core products and cp.async staging): every ``*.cuh``
there is hashed into each library's path and ``csrc/`` is on the include
path. Nothing here runs at import time.
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
_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FLAGS = {"wire": _BASE_FLAGS + ("-fmad=false",),
              "flash_attention": _BASE_FLAGS,
              "mlstm": _BASE_FLAGS,
              "selective_scan": _BASE_FLAGS,
              "decode_attention": _BASE_FLAGS}

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C entry points of each library: (argtypes); all return a cudaError_t
WIRE_API = {
    "wire_quantize": (_P, _P, _P, _I64, _I64, _I32, _P),
    "wire_dequantize": (_P, _P, _P, _I64, _P),
    "wire_quant_avg_dequant": (_P, _P, _I64, _I64, _I32, _P),
    "wire_quant_avg_dequant_ef": (_P, _P, _P, _P, _I64, _I64, _I32, _P),
}
FLASH_API = {
    # q, k, v, o, dtype, B, Sq, Sk, H, KV, hd, hd_v, window, scale, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _I32, *(_I64,) * 8, _F32, _P),
}
MLSTM_API = {
    # q, k, v, ig, fg, h, scratch, dtype, gate_dtype, B, S, H, hd, scale,
    # stream
    "mlstm_fwd": (*(_P,) * 7, _I32, _I32, *(_I64,) * 4, _F32, _P),
}
SCAN_API = {
    # xc, dt, Bm, Cm, A, D, y, h, x_dtype, B, S, di, st, stream
    "selective_scan_fwd": (*(_P,) * 8, _I32, *(_I64,) * 4, _P),
}
DECODE_API = {
    # q, k, v, pos, pos64, o, part, B, S, H, KV, hd, scale, stream
    "decode_attention_fwd": (*(_P,) * 4, _I32, _P, _P, *(_I64,) * 5, _F32,
                             _P),
}
API = {"wire": WIRE_API, "flash_attention": FLASH_API, "mlstm": MLSTM_API,
       "selective_scan": SCAN_API, "decode_attention": DECODE_API}

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
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def lib_path(name="wire"):
    """``build/kernels/<hash>/lib<name>.so``, the hash over the source, every
    header under ``csrc/`` (by name and bytes) and the flags, so a changed
    header never leaves a stale library in place."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[name]).encode())
    return REPO_ROOT / "build" / "kernels" / h.hexdigest()[:16] / \
        f"lib{name}.so"


def build_cmd(name, out):
    return [nvcc_path(), *NVCC_FLAGS[name], "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


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
        for fn, argtypes in API[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return _LOADED[name]
