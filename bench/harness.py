"""The benchmark's core: one cell, one run.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix. Each lives in a file of its own, found by name:

* ``bench/workloads/<cell>.json``: the configuration and traffic names, the
  chips, and the limits of the numbers that decide ``correct``;
* ``bench/configs/<config>.json``: the model as it is run (``model``: the
  port's ``ModelConfig`` fields), its source, the cut, the precision, the
  reference family and the peaks;
* ``bench/traffic/<traffic>.json``: the entry point it drives
  (``bench/drivers/<entry>.py``) and that driver's parameters;
* ``bench/metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``,
  ``read(ctx) -> float | None`` (None: nothing to read, the metric is left
  out of the line).

``run_cell`` builds the driver, lets it set up (weights and inputs from
the seed, the warm-up of this cell's shapes, a training run's first
steps), measures whole calls until ``seconds`` have passed, optionally
profiles a short steady sub-window, frees the program's state, runs the
check against the plain reference and reads the metrics.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import a file by path (metric names hold dots, so they are not
    importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(cell, bench_dir=BENCH):
    """(workload, config, traffic) dicts of a cell, found by name."""
    wl = load_json(bench_dir / "workloads" / f"{cell}.json")
    cfg = load_json(bench_dir / "configs" / f"{wl['config']}.json")
    tr = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, tr


def reference_module(config, bench_dir=BENCH):
    fam = config["family"]
    return load_module(bench_dir / "reference" / f"{fam}.py",
                       f"bench_reference_{fam}")


def driver_module(traffic, bench_dir=BENCH):
    entry = traffic["entry"]
    return load_module(bench_dir / "drivers" / f"{entry}.py",
                       f"bench_driver_{entry}")


def model_config(config):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig
    m = dict(config["model"])
    m["segments"] = tuple((tuple(p), int(r)) for p, r in m["segments"])
    return ModelConfig(**m)


def metrics_for(spec, cell, trace):
    """The ``BENCHMARK.json`` metrics a cell reports: its end-to-end ones
    (``trace`` 0) or its per-layer ones (``trace`` 1). A metric with a
    ``workloads`` key belongs to those cells; an end-to-end one without it
    to every cell; a per-layer one without it to every cell that reports
    the end-to-end metric it ``moves``."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (res.stdout or res.stderr).strip()


class Run:
    """What one run knows: the cell's files, the seed, the device, and
    what the window and the trace measured (``ctx`` for the readers)."""

    def __init__(self, cell, workload, config, traffic, seed, seconds,
                 trace, device, t_start, bench_dir=BENCH):
        self.cell, self.workload = cell, workload
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.bench_dir = bench_dir
        self.ref = reference_module(config, bench_dir)
        #: counters the driver reads off the program (wire bytes, replays)
        self.counters = {}


# ---------------------------------------------------------------------------
# the traced sub-window
# ---------------------------------------------------------------------------
def _kineto(prof):
    """(name, on_device, start_ns, end_ns) of every event of a finished
    profile, from kineto's own records (building ``prof.events()`` for
    hundreds of thousands of kernels takes minutes)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            a, d = e.start_ns(), e.duration_ns()
        else:
            a, d = 1000 * e.start_us(), 1000 * e.duration_us()
        out.append((e.name(), e.device_type() != DeviceType.CPU, a, a + d))
    return out


def _union(spans, lo, hi):
    """Merged intervals of ``spans`` clipped to [lo, hi]."""
    merged = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events, marker="bench.call"):
    """The traced sub-window: each call's host range (the ``marker``
    annotations), the device's busy seconds (the union of every device
    operation's interval) within the window and within each call, the
    device time by operation name, and the longest idle gaps labelled by
    the innermost host event running across each gap's middle."""
    calls = sorted((a, b) for n, dev, a, b in events
                   if not dev and n == marker)
    if not calls:
        return None
    lo, hi = calls[0][0], calls[-1][1]
    # kineto mirrors each annotation on the device's timeline: not an op
    device = [(n, a, b) for n, dev, a, b in events
              if dev and b > a and n != marker]
    busy = _union([(a, b) for _, a, b in device], lo, hi)
    by_name = {}
    for n, a, b in device:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + (b - a) / 1e9, c + 1)
    per_call = [sum(y - x for x, y in _union([(a, b) for _, a, b in device],
                                              ca, cb)) / 1e9
                for ca, cb in calls]
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [(n, a, b) for n, dev, a, b in events
            if not dev and n != marker]
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        cover = [(y - x, n) for n, x, y in host if x <= mid <= y]
        labelled.append([min(cover)[1] if cover else "host: Python",
                         (b - a) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (hi - lo) / 1e9,
            "calls": len(calls),
            "busy_per_call_s": per_call,
            "by_name": by_name,
            "device_ops": [[n[:160], t] for n, (t, _) in top],
            "idle_gaps": labelled}


def traced_window(call, n, device, first_index):
    """Profile ``n`` calls (each synchronised, each under one
    ``bench.call`` annotation) and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        for i in range(n):
            with record_function("bench.call"):
                call(first_index + i)
                sync(device)
    return reduce_trace(_kineto(prof))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def window(call, seconds, device, call_s=None):
    """Whole calls until ``seconds`` have passed: the window closes at the
    end of the first call that ends after them. Returns (calls, work
    units, seconds); ``call_s``, a list, gets each call's seconds."""
    sync(device)
    t0 = last = time.perf_counter()
    calls = units = 0
    while True:
        units += call(calls)
        calls += 1
        sync(device)
        now = time.perf_counter()
        if call_s is not None:
            call_s.append(now - last)
        last = now
        if now - t0 >= seconds:
            return calls, units, now - t0


def peak_bytes(device):
    """The allocator's reserved peak since the last reset: what the card
    had to hold. Its allocated peak would miss the captured graphs'
    private pools, whose blocks a replay reuses without allocating."""
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_reserved(device)


def judge(checks, limits):
    """``correct``: every compared number is finite and within its limit.
    ``checks`` maps a name to its reading; a name without a limit is an
    error of the cell's files, not a pass."""
    rows = {}
    ok = True
    for name, value in checks.items():
        limit = limits[name]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        rows[name] = {"value": value, "limit": limit}
    return ok and bool(rows), rows


def run_cell(run, spec, probe=None):
    """Set up, measure, trace, check and read one cell; returns the result
    dict (without the module check, which ``run.py`` makes last).

    ``probe`` (``bench/calibrate.py``; the benchmark's runs pass none)
    reads more off the same run: ``probe.program(drv)`` before the
    program's state is released, ``probe.reference(drv)`` after, before
    the check; what the latter returns is the result's ``probe``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = run.device
    drv = driver_module(run.traffic, run.bench_dir).Driver(run)
    drv.setup()
    free_device()               # set-up's cached temporaries go back
    sync(dev)
    setup_s = time.perf_counter() - run.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    calls, units, window_s = window(drv.call, run.seconds, dev,
                                    run.counters.setdefault("call_s", []))
    drv.window_calls = calls
    peak = peak_bytes(dev)
    trace = None
    if run.trace:
        trace = traced_window(drv.call, drv.traced_calls, dev, calls)
    if probe is not None:
        probe.program(drv)
    drv.release()
    free_device()
    probed = probe.reference(drv) if probe is not None else None
    checks = drv.check()
    correct, rows = judge(checks, run.workload["limits"])
    ctx = {"run": run, "setup_s": setup_s, "calls": calls,
           "units": units, "window_s": window_s, "peak_bytes": peak,
           "trace": trace, "counters": run.counters}
    metrics = {}
    for m in metrics_for(spec, run.cell, run.trace):
        reader = load_module(run.bench_dir / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": run.workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": drv.attempted(calls),
              "failed": 0, "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["card"] = run.counters.get("card", "")
    if probe is not None:
        result["probe"] = probed
    result["checks"] = rows
    return result
