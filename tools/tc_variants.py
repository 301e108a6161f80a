#!/usr/bin/env python3
"""Time K5 and K7 against variants of their own source, on one CUDA card.

    python3 tools/tc_variants.py        # from the repository root

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with one edit,
built with the port's own flags into ``build/variants/`` and called through
the same C entry points, on the same inputs, at the serving paths' shapes
(K5 at ``chip_smoke.FA_PATH`` and ``FA_PATH_JAMBA``, K7 at ``ML_PATH``).
Every variant is timed twice, the order reversed the second time, beside
its max abs error against the plain version. The variants are the design
choices the sources' notes give a reason for:

- ``cvt``: round to TF32 with ``cvt.rna.tf32.f32`` (low bits cleared)
  instead of the two integer operations;
- ``generic``: no K5 instance specialised for 128-wide heads;
- ``inplace``: K7 adds each depth-8 step's three TF32 products into its
  accumulators on the tensor core (``mma3``) instead of summing them apart
  and adding in f32 (``mma3_rn``).

Prints one JSON object and writes it to ``build/tc_variants.json``.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TF32_INT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
TF32_CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
            '"f"(x));\n  return r & 0xffffe000u;')
# variant: [(file, text, replacement)]
VARIANTS = {
    "source": [],
    "cvt": [("tf32_mma.cuh", TF32_INT, TF32_CVT)],
    "generic": [("flash_attention.cu", "if (hd == HD_MAX && hd_v == HD_MAX)",
                 "if (false)")],
    "inplace": [("mlstm.cu", "tc::mma3_rn(", "tc::mma3(")],
}


def build(variant, lib):
    from repro_torch.kernels import _build
    d = ROOT / "build" / "variants" / f"{variant}-{lib}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for name, text, repl in VARIANTS[variant]:
        src = (d / name).read_text()
        if text not in src:
            raise RuntimeError(f"{variant}: {text!r} not in {name}")
        (d / name).write_text(src.replace(text, repl))
    so = d / f"lib{lib}.so"
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS[lib], "-I",
                          str(d), "-o", str(so), str(d / f"{lib}.cu")],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {variant}/{lib}:\n{res.stderr}")
    handle = ctypes.CDLL(str(so))
    for fn, argtypes in _build.API[lib].items():
        f = getattr(handle, fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
    return handle


def main():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import mlstm as ml, ref
    from repro_torch.kernels.quantize import _ptr, _stream
    if not torch.cuda.is_available():
        print("tc_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    jobs = [(v, lib) for v in VARIANTS for lib in ("flash_attention", "mlstm")
            if v == "source" or any(f.startswith(lib)
                                    or f == "tf32_mma.cuh"
                                    for f, _, _ in VARIANTS[v])]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda j: build(*j), jobs)))
    out = {"card": cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]), "runs": {}}

    def timed(key, variants, call, got, want):
        for order in (variants, variants[::-1]):
            for v in order:
                call(libs[(v, key[1])])
                err = float((got() - want).abs().max())
                ms = cs.cuda_ms(torch, lambda: call(libs[(v, key[1])]))
                out["runs"].setdefault(f"{key[0]}/{v}", []).append(
                    {"ms": ms, "max_abs_err": err})

    for shape, seed in ((cs.FA_PATH, 4), (cs.FA_PATH_JAMBA, 12)):
        B, Sq, Sk, H, KV, hd, hd_v, window = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = cs._fa_inputs(torch, dev, g, shape, torch.float32)
        want = ref.flash_attention_ref(q, k, v, n_kv_heads=KV)
        o = torch.empty((B, Sq, H, hd_v), device=dev)

        def fa(lib, q=q, k=k, v=v, o=o, shape=shape):
            rc = lib.flash_attention_fwd(
                _ptr(q), _ptr(k), _ptr(v), _ptr(o), 0, *shape[:7],
                shape[7], float(shape[5] ** -0.5), _stream(q))
            cs.check(rc == 0, f"flash_attention_fwd returned {rc}")
        timed((f"K5 H{H}", "flash_attention"),
              [v for v, lib in jobs if lib == "flash_attention"], fa,
              lambda o=o: o, want)
        del q, k, v, want, o
        torch.cuda.empty_cache()

    B, S, H, hd = cs.ML_PATH
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, ig, fg = cs._ml_inputs(torch, dev, g, cs.ML_PATH, "standard",
                                    torch.float32)
    want, _ = ref.mlstm_ref(q, k, v, ig, fg)
    h = torch.empty_like(q)
    scratch = torch.empty(ml.scratch_floats(B, S, H, hd), device=dev)

    def mlstm(lib):
        rc = lib.mlstm_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(ig), _ptr(fg),
                           _ptr(h), _ptr(scratch), 0, 0, B, S, H, hd,
                           float(hd ** -0.25), _stream(q))
        cs.check(rc == 0, f"mlstm_fwd returned {rc}")
    timed(("K7", "mlstm"), [v for v, lib in jobs if lib == "mlstm"], mlstm,
          lambda: h, want)
    text = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "tc_variants.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
