#!/usr/bin/env python3
"""Time K5, K7 and K6 against variants of their own source, on one CUDA card.

    python3 tools/tc_variants.py                 # from the repository root
    python3 tools/tc_variants.py --only K6 [--baseline OTHER/csrc]

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with one edit,
built with the port's own flags into ``build/variants/`` and called through
the same C entry points, on the same inputs, at the serving paths' shapes
(K5 at ``chip_smoke.FA_PATH`` and ``FA_PATH_JAMBA``, K7 at ``ML_PATH``, K6
at ``SS_PATH``). Every variant is timed twice, the order reversed the
second time, beside its max abs error against the plain version. The
variants are the design choices the sources' notes give a reason for:

- ``cvt``: round to TF32 with ``cvt.rna.tf32.f32`` (low bits cleared)
  instead of the two integer operations;
- ``generic``: no K5 instance specialised for 128-wide heads;
- ``inplace``: K7 adds each depth-8 step's three TF32 products into its
  accumulators on the tensor core (``mma3``) instead of summing them apart
  and adding in f32 (``mma3_rn``);
- K6 (``K6_VARIANTS``): a share of the exps on the FMA pipe (``fmaN``:
  one state in N, by a polynomial the variant adds), ``expf`` of the
  unscaled product instead of ex2.approx of the prescaled one (the
  arithmetic of the first K6), dt·x formed once a step instead of
  (dt·B)·x per state (``dtx``), y summed in four partial sums
  (``tree4``), B and C read one float at a time (``scalar``), two threads
  a channel (``split``), 2, 8 or 16 steps a chunk (``chN``); and two that
  measure a share, not a design: the exps replaced by a constant
  (``noexp``) and the x, dt loads by values made in registers
  (``noload``). ``--baseline DIR`` times DIR's ``selective_scan.cu`` too
  (a ``csrc`` of another tree, e.g. an unpacked ``git archive`` of a
  parent commit). K6 is timed with dt and A drawn as the JAX suite draws
  them; every variant's error is also held at 1e-5 with Mamba's
  initialisation and with strong decay (``K6_regimes``), each error
  also as its worst ratio to the tolerance (``tol_ratio``), and its
  chunk loop's SASS is counted per state update
  (``chip_smoke.sass_loop``).

Prints one JSON object and writes it to ``build/tc_variants.json``.
"""
from __future__ import annotations

import argparse
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
# K6: [(text, replacement)] in selective_scan.cu. The source takes every
# exp on the SFU; the fmaN variants add this exp2 on the FMA pipe and give
# it one state in N: z = j + f with j = round(z) (read from the low bits of
# z + 1.5 * 2^23) and |f| <= 1/2, 2^f by a degree-5 minimax polynomial
# (Horner, p(0) = 1 exactly), j added to the exponent field; z clamped to
# [-127, 128] first (0 at the bottom, inf at the top, as the SFU gives).
K6_EXP = "ex2_sfu(d * a2[s])"
K6_LD4 = "// four consecutive staged floats"
EX2_FMA = """__device__ __forceinline__ float ex2_fma(float z) {
  z = fminf(fmaxf(z, -127.f), 128.f);
  const float t = z + 12582912.f;
  const float f = z - (t - 12582912.f);
  float p = 0x1.5bba14p-10f;
  p = fmaf(p, f, 0x1.3cea88p-7f);
  p = fmaf(p, f, 0x1.c6b752p-5f);
  p = fmaf(p, f, 0x1.ebf9bcp-3f);
  p = fmaf(p, f, 0x1.62e42ap-1f);
  p = fmaf(p, f, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

"""
K6_VARIANTS = {
    "source": [],
    **{f"fma{n}": [(K6_LD4, EX2_FMA + K6_LD4),
                   (K6_EXP, f"(s % {n} == {n - 1} ? ex2_fma(d * a2[s]) : "
                            f"{K6_EXP})")]
       for n in (16, 8, 5, 4, 3)},
    "expf": [(" * LOG2E;", ";"), (K6_EXP, "expf(d * a2[s])")],
    "dtx": [("d = dr[i];", "d = dr[i], dx = d * x;"),
            ("d * bq[r] * x", "dx * bq[r]")],
    "tree4": [("float acc = 0.f;", "float acc[4] = {};"),
              ("acc = fmaf(h[s], cq[r], acc);",
               "acc[r] = fmaf(h[s], cq[r], acc[r]);"),
              ("fmaf(x, dd, acc)",
               "fmaf(x, dd, (acc[0] + acc[2]) + (acc[1] + acc[3]))")],
    "scalar": [("return *reinterpret_cast<const float4*>(p);",
                "const volatile float* v = p;\n"
                "  return make_float4(v[0], v[1], v[2], v[3]);")],
    # two threads a channel, half the states each, y_t summed by a shuffle
    # (timed at st 16; its st-4 instance is built but never called)
    "split": [
        ("const int64_t c = (int64_t)blockIdx.x * THREADS + tid;",
         "const int part = tid % 2;\n"
         "  const int64_t c = (int64_t)blockIdx.x * (THREADS / 2) + tid / 2;"),
        ("float a2[ST], h[ST];",
         "constexpr int SPT = ST / 2;\n  float a2[SPT], h[SPT];"),
        ("for (int s = 0; s < ST; ++s) {\n    a2[s] = A[cl * ST + s]",
         "for (int s = 0; s < SPT; ++s) {\n"
         "    a2[s] = A[cl * ST + part * SPT + s]"),
        ("const float* Bt = bc[buf][i];",
         "const float* Bt = bc[buf][i] + part * SPT;"),
        ("const float* Ct = bc[buf][i] + ST;",
         "const float* Ct = bc[buf][i] + ST + part * SPT;"),
        ("q < ST / 4", "q < SPT / 4"),
        ("if (store) *yq =",
         "acc += __shfl_xor_sync(0xffffffffu, acc, 1);\n"
         "    if (store && part == 0) *yq ="),
        ("c) * ST;\n#pragma unroll\n    for (int s = 0; s < ST; ++s)",
         "c) * ST + part * SPT;\n#pragma unroll\n"
         "    for (int s = 0; s < SPT; ++s)"),
        ("((di + THREADS - 1) / THREADS)",
         "((di + THREADS / 2 - 1) / (THREADS / 2))")],
    **{f"ch{n}": [("CH = 8;", f"CH = {n};")] for n in (2, 4, 16)},
    "noexp": [(K6_EXP, "0.96875f")],
    "noload": [("xr[i] = *xq;",
                "xr[i] = static_cast<TX>(__uint_as_float(0x3f000000u | "
                "((uint32_t)(uintptr_t)xq * 2654435761u >> 9)));"),
               ("dr[i] = *dq;",
                "dr[i] = __uint_as_float(0x3c000000u | "
                "((uint32_t)(uintptr_t)dq * 40503u >> 9));")],
}
# dt and A drawn as the JAX suite draws them (timed), then as Mamba
# initialises them and with strong decay (errors only)
K6_REGIMES = ("jax", "mamba_init", "strong")

def build(variant, lib, baseline=None):
    """Copy csrc, apply the variant's edits (K6's ``baseline`` takes the
    whole file from ``baseline``), build it."""
    from repro_torch.kernels import _build
    d = ROOT / "build" / "variants" / f"{variant}-{lib}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    if variant == "baseline":
        shutil.copy(Path(baseline) / "selective_scan.cu", d)
    edits = ([("selective_scan.cu", *e) for e in K6_VARIANTS[variant]]
             if lib == "selective_scan" and variant != "baseline"
             else VARIANTS.get(variant, []))
    for name, text, repl in edits:
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
    handle.path = so
    for fn, argtypes in _build.API[lib].items():
        f = getattr(handle, fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
    return handle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("K5", "K7", "K6"), action="append",
                    help="time only these kernels' variants (repeatable)")
    ap.add_argument("--baseline", help="a csrc directory whose "
                    "selective_scan.cu is timed as K6's 'baseline'")
    args = ap.parse_args(argv)
    groups = set(args.only or ("K5", "K7", "K6"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import mlstm as ml, ref
    from repro_torch.kernels.quantize import _ptr, _stream
    if not torch.cuda.is_available():
        print("tc_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs_of = {"K5": "flash_attention", "K7": "mlstm"}
    jobs = [(v, lib) for v in VARIANTS for g, lib in libs_of.items()
            if g in groups and (v == "source" or any(
                f.startswith(lib) or f == "tf32_mma.cuh"
                for f, _, _ in VARIANTS[v]))]
    if "K6" in groups:
        jobs += [(v, "selective_scan") for v in K6_VARIANTS]
        if args.baseline:
            jobs.append(("baseline", "selective_scan"))
    with ThreadPoolExecutor(min(len(jobs), 8)) as ex:
        libs = dict(zip(jobs, ex.map(lambda j: build(*j, args.baseline),
                                     jobs)))
    out = {"card": cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]), "runs": {}}

    def error(got, want, tol=None):
        """max |got - want|; with ``tol``, the largest |got - want| /
        (atol + rtol |want|) too: within the tolerance while <= 1."""
        d = (got - want).abs()
        res = {"max_abs_err": float(d.max())}
        if tol:
            bound = tol["atol"] + tol["rtol"] * want.abs()
            res.update(tol_ratio=float((d / bound).max()),
                       within_tol=bool((d <= bound).all()))
        return res

    def timed(key, variants, call, got, want, tol=None):
        for order in (variants, variants[::-1]):
            for v in order:
                call(libs[(v, key[1])])
                run = error(got(), want, tol)
                run["ms"] = cs.cuda_ms(torch,
                                       lambda: call(libs[(v, key[1])]))
                out["runs"].setdefault(f"{key[0]}/{v}", []).append(run)

    for shape, seed in ((cs.FA_PATH, 4), (cs.FA_PATH_JAMBA, 12)) \
            if "K5" in groups else ():
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

    if "K7" in groups:
        B, S, H, hd = cs.ML_PATH
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v, ig, fg = cs._ml_inputs(torch, dev, g, cs.ML_PATH,
                                        "standard", torch.float32)
        want, _ = ref.mlstm_ref(q, k, v, ig, fg)
        h = torch.empty_like(q)
        scratch = torch.empty(ml.scratch_floats(B, S, H, hd), device=dev)

        def mlstm(lib):
            rc = lib.mlstm_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(ig),
                               _ptr(fg), _ptr(h), _ptr(scratch), 0, 0, B, S,
                               H, hd, float(hd ** -0.25), _stream(q))
            cs.check(rc == 0, f"mlstm_fwd returned {rc}")
        timed(("K7", "mlstm"), [v for v, lib in jobs if lib == "mlstm"],
              mlstm, lambda: h, want)
        del q, k, v, ig, fg, want, h, scratch
        torch.cuda.empty_cache()

    if "K6" in groups:
        B, S, di, st = cs.SS_PATH
        g = torch.Generator(device=dev).manual_seed(11)
        variants = [v for v, lib in jobs if lib == "selective_scan"]
        y = torch.empty((B, S, di), device=dev)
        hf = torch.empty((B, di, st), device=dev)

        def scan(lib):
            rc = lib.selective_scan_fwd(*(_ptr(t) for t in (*xs, y, hf)), 0,
                                        B, S, di, st, _stream(y))
            cs.check(rc == 0, f"selective_scan_fwd returned {rc}")
        out["K6_regimes"] = {}
        for regime in K6_REGIMES[::-1]:     # the JAX suite's draw is timed
            xs = cs._ss_inputs(torch, dev, g, cs.SS_PATH, torch.float32,
                               regime)
            want = torch.cat([t.reshape(-1)
                              for t in ref.selective_scan_ref(*xs)])
            got = lambda: torch.cat([y.reshape(-1), hf.reshape(-1)])
            if regime == "jax":
                timed(("K6", "selective_scan"), variants, scan, got, want,
                      cs.SS_TOL)
                continue
            for v in variants:
                scan(libs[(v, "selective_scan")])
                out["K6_regimes"].setdefault(v, {})[regime] = error(
                    got(), want, cs.SS_TOL)
            del want
        # the SM clock and power while 400 launches of the source run
        torch.cuda.synchronize()
        for _ in range(400):
            scan(libs[("source", "selective_scan")])
        out["K6_clock_under_load"] = cs.run_cmd([
            "nvidia-smi", "--query-gpu=clocks.sm,power.draw",
            "--format=csv,noheader"])
        torch.cuda.synchronize()
        out["K6_sass"] = {}
        for v in variants:
            lib = libs[(v, "selective_scan")]
            ch = cs.scan_chunk(Path(lib.path).parent / "selective_scan.cu")
            out["K6_sass"][v] = {"steps_per_chunk": ch, **(cs.sass_loop(
                lib.path, r".*selective_scan_kernelIfLi16E",
                ch * (st // 2 if v == "split" else st)) or {})}
    text = json.dumps(out)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "tc_variants.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
