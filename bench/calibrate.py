"""Readings that the limits of a cell's compared numbers are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 3 --out <file.json>

On the card, at the cell's own sizes, in one process. For each of
``--seeds``, one run of the cell through ``harness.run_cell``, the path
that ``run.py`` takes (``--seconds`` long, untraced): its compared numbers
are the lower readings. For each of ``--control-seeds`` the same run also
reads the upper readings, once the program's state is freed and before
the check: the control (the plain reference computed on TF32-rounded
operands, put in the program's place) and the faults the cell can have,
planted in the reference put in the program's place, each judged by the
cell's own limits (``harness.judge``), as a run would judge it.

A prefill run also counts, in each MoE layer of its checked calls, the
tokens whose top-k experts or whose kept picks differ between the
program and the reference (the program's picks read off its dispatch by
rerunning the checked calls before release); on the control seeds it
reads the gap that one flipped pick causes: the reference with the last
token of row 0 sent to its (k+1)-th expert instead of its k-th, in one
MoE layer at a time, against the reference.

The benchmark's own runs never run this. Writes one JSON object, after
every seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# the upper readings: the control and the faults, per entry
# ---------------------------------------------------------------------------
def _round(drv):
    ref = drv.reference_rounds()
    half = drv.t["batch"] // 2
    return {
        "control": drv.compare(*drv.reference_rounds(low=True)[:2], *ref),
        "half_batch": drv.compare(*drv.reference_rounds(rows=half)[:2],
                                  *ref),
        "no_exchange": drv.compare(
            *drv.reference_rounds(average=False)[:2], *ref)}


def _prefill(drv):
    from bench.drivers.prefill import logit_gap
    worst = {"control": 0.0, "answer_altered": 0.0}
    for i in drv.sample():
        ref = drv.reference_logits(i)
        low = drv.reference_logits(i, low=True)
        worst["control"] = max(worst["control"], logit_gap(low, ref))
        bad = drv.answers[i].clone()
        bad[0, 0] += 1.0
        worst["answer_altered"] = max(worst["answer_altered"],
                                      logit_gap(bad, ref))
    return {k: {"logit_gap": v} for k, v in worst.items()}


def _decode(drv):
    import torch
    picks = drv.sample()
    low = drv.reference_gaps(picks, low=True)
    i, b = picks[0]
    kept = drv.served[i].clone()
    drv.served[i][b, -1] = (drv.served[i][b, -1] + 1) % drv.vocab
    altered = drv.reference_gaps(picks)
    drv.served[i] = kept
    return {"control": {"served_gap": float(low.max())},
            "token_altered": {"served_gap": float(torch.max(altered))}}


UPPER = {"round": _round, "prefill": _prefill, "decode": _decode}


# ---------------------------------------------------------------------------
# prefill: the routing of the program against the reference's
# ---------------------------------------------------------------------------
def program_picks(drv, i):
    """(the experts (T, k) and which of them were kept (T, k), in token
    order, of each MoE layer; the logits) of the program's prefill of call
    ``i``, run again with its dispatch read."""
    import torch
    from bench.drivers.prefill import prompt_tokens
    from repro_torch.models import moe
    rec, orig = [], moe._dispatch

    def spy(xg, ge, E, cap, k):
        out = orig(xg, ge, E, cap, k)
        order, keep = out[1], out[3]
        kept = torch.empty_like(keep).scatter_(1, order, keep)
        rec.append((ge.reshape(-1, k).clone(), kept.reshape(-1, k).clone()))
        return out
    moe._dispatch = spy
    try:
        toks = prompt_tokens(drv.run.seed, i, drv.t, drv.vocab,
                             drv.run.device)
        with torch.no_grad():
            answer = drv.step(drv.params, {"tokens": toks})
    finally:
        moe._dispatch = orig
    return rec, answer


def reference_picks(drv, i, flip_layer=None):
    """As ``program_picks``, of the reference; with ``flip_layer`` the
    last token of row 0 goes, in that MoE layer, to its (k+1)-th expert
    instead of its k-th."""
    import torch
    ref = drv.run.ref
    rec, route, keep = [], ref.route, ref.capacity_keep

    def spy_route(p, xt, arch, low):
        probs, top_p, top_i = route(p, xt, arch, low)
        if flip_layer == len(rec):
            t, k = drv.t["seq_len"] - 1, arch["top_k"]
            top_i = top_i.clone()
            top_i[t, k - 1] = torch.topk(probs[t], k + 1).indices[k]
            w = probs[t, top_i[t]]
            top_p = top_p.clone()
            top_p[t] = w / w.sum()
        rec.append([top_i])
        return probs, top_p, top_i

    def spy_keep(top_i, arch):
        kept = keep(top_i, arch)
        rec[-1].append(kept)
        return kept
    ref.route, ref.capacity_keep = spy_route, spy_keep
    try:
        logits = drv.reference_logits(i)
    finally:
        ref.route, ref.capacity_keep = route, keep
    return [tuple(r) for r in rec], logits


def routing_diff(prog, ref):
    """Per MoE layer: tokens whose top-k experts differ, tokens whose kept
    experts differ, and the picks each side dropped."""
    import torch
    out = []
    for (pi, pk), (ri, rk) in zip(prog, ref):
        kept_p = torch.where(pk, pi, -1).sort(-1).values
        kept_r = torch.where(rk, ri, -1).sort(-1).values
        out.append({
            "flipped": int((pi.sort(-1).values != ri.sort(-1).values)
                           .any(-1).sum()),
            "kept_differs": int((kept_p != kept_r).any(-1).sum()),
            "dropped": [int((~pk).sum()), int((~rk).sum())]})
    return out


class Probe:
    """What ``harness.run_cell`` reads besides the run: the upper readings
    on a control seed; a prefill's routing against the reference's."""

    def __init__(self, entry, control):
        self.entry, self.control = entry, control
        self.picks = {}

    def program(self, drv):
        if self.entry == "prefill":
            self.picks = {i: program_picks(drv, i) for i in drv.sample()}

    def reference(self, drv):
        from bench.drivers.prefill import logit_gap
        out = {}
        if self.entry == "prefill":
            out["routing"] = []
            for i, (prog, again) in self.picks.items():
                ref, logits = reference_picks(drv, i)
                out["routing"].append({
                    "call": i, "gap": logit_gap(drv.answers[i], logits),
                    "rerun_gap": logit_gap(again, drv.answers[i]),
                    "layers": routing_diff(prog, ref)})
            self.picks = {}
        if self.control:
            out["upper"] = UPPER[self.entry](drv)
            if self.entry == "prefill":
                i = drv.sample()[0]
                _, base = reference_picks(drv, i)
                out["one_flip"] = [
                    logit_gap(reference_picks(drv, i, flip_layer=j)[1], base)
                    for j in range(len(out["routing"][0]["layers"]))]
        return out


# ---------------------------------------------------------------------------
# one seed, many seeds
# ---------------------------------------------------------------------------
def one_seed(cell, seed, seconds, control, spec):
    from bench import harness
    wl, cfg, tr = harness.cell_files(cell)
    run = harness.Run(cell, wl, cfg, tr, seed, seconds, False, "cuda",
                      time.perf_counter())
    res = harness.run_cell(run, spec, Probe(tr["entry"], control))
    rec = {"seed": seed, "correct": res["correct"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "call_s": run.counters["call_s"],
           "lower": {k: v["value"] for k, v in res["checks"].items()}}
    probed = res["probe"]
    for fault, readings in probed.pop("upper", {}).items():
        ok, _ = harness.judge(readings, wl["limits"])
        rec.setdefault("upper", {})[fault] = {"readings": readings,
                                              "correct": ok}
    rec.update(probed)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from bench import harness
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = {"workload": args.workload, "card": harness.power_limit(),
           "runs": []}
    for s in (int(x) for x in args.seeds.split(",")):
        try:
            rec = one_seed(args.workload, s, args.seconds, s in control,
                           spec)
        except Exception:                  # keep the other seeds' readings
            rec = {"seed": s, "error": traceback.format_exc()[-4000:]}
            harness.free_device()
        out["runs"].append(rec)
        print(json.dumps(rec), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
