"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell's files are found by name under ``bench/`` (see
``harness.py``); the program under test is the ``repro_torch`` package
under ``src/``. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``; ``checks`` last: each compared number beside
its limit, which also end standard error). Exits 2 without the cards the
cell asks for, 3 when the program is missing, 4 when the process holds
the JAX package or JAX once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the allocator's segments grow in place: the training cell's round
    # peaks near the card's capacity
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    wl, cfg, tr = harness.cell_files(args.workload)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"bench: {args.workload} needs {wl['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    run = harness.Run(args.workload, wl, cfg, tr, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    run.counters["card"] = harness.power_limit()
    result = harness.run_cell(run, spec)
    found = forbidden_modules()
    if found:
        print(f"bench: the process holds {found} after the window",
              file=sys.stderr)
        return 4
    print("call seconds " + " ".join(
        f"{s:.4f}" for s in run.counters.get("call_s", [])), file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
