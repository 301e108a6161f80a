"""The dry run's repeated trips (``launch/dryrun.CostMode.trips`` and
``models/layers.trips``): a loop of alike trips traced as three, trip 1
booked ``n - 2`` times, against the whole loop traced eagerly.

The whole trace runs with the mechanism switched off in the subprocess
only (``CostMode.trips = None``). The xLSTM and Jamba training cases run
``layers.chunked_scan`` at a 16-step chunk (its default is 256) so that
the eager trace, which runs every step, stays short: 16, 32, 48, 64 and
80 steps give the loops 256, 512, 768, 1,024 and 1,280 give at the
default (one chunk, ``c == S``, a plain loop; two and three chunks, each
a loop of trips; four and five chunks, whose middle ones are one trip),
and 40 a ragged length (one plain loop of trips). Jamba's also run at
256 and 768 steps at the default chunk, and the prefills at 256 and 512
(their in-place loops take no chunk) and 4,096 (the attention's 1,024 by
1,024 tiles, four by four).
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")

# (arch, variant, mesh, seq_len, chunk of chunked_scan)
CASES = [
    ("xlstm-1.3b", "train_vanilla", "single", 16, 16),
    ("xlstm-1.3b", "train_vanilla", "single", 80, 16),
    ("xlstm-1.3b", "train_vanilla", "single", 40, 16),
    ("xlstm-1.3b", "prefill", "single", 256, 256),
    ("xlstm-1.3b", "train_colearn", "multi", 48, 16),
    ("xlstm-1.3b", "round_colearn", "multi", 32, 16),
    ("jamba-v0.1-52b", "train_vanilla", "single", 768, 256),
    ("jamba-v0.1-52b", "train_vanilla", "single", 80, 16),
    ("jamba-v0.1-52b", "prefill", "single", 512, 256),
    ("jamba-v0.1-52b", "train_colearn", "multi", 256, 256),
    ("jamba-v0.1-52b", "round_colearn", "multi", 64, 16),
    ("internlm2-1.8b", "prefill", "single", 4096, 256),
    ("deepseek-v3-671b", "prefill", "multi", 4096, 256),
]

TRIPS = r"""
import json, sys, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import layers
M.init_process_mesh(0, D.WORLD, "", "fake")
meshes = {"single": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                               mesh_dim_names=("data", "model")),
          "multi": DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                              mesh_dim_names=("pod", "data", "model"))}
kinds = {"train_vanilla": "train", "train_colearn": "train",
         "round_colearn": "train", "prefill": "prefill"}
book = D.CostMode.trips
out = []
for arch, variant, mesh, S, chunk in json.loads(sys.argv[1]):
    layers.chunked_scan.__defaults__ = (chunk, True)
    shape = InputShape("t", S, 8, kinds[variant])
    got = {}
    for way, trips in (("trips", book), ("whole", None)):
        D.CostMode.trips = trips
        costs, memory, _ = D._trace(get_smoke_config(arch), shape,
                                    meshes[mesh], mesh == "multi", variant)
        got[way] = [costs, memory["peak_bytes_per_device"]]
    out.append(got)
print("RESULT " + json.dumps(out))
"""


def _run(script, args, timeout):
    proc = subprocess.run([sys.executable, "-c", script, *args], env=ENV,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def traced():
    """Every case traced both ways, in one subprocess (one fake world)."""
    return dict(zip(CASES, _run(TRIPS, [json.dumps(CASES)], timeout=900)))


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_trip_counts_equal_the_whole_trace(traced, case):
    """FLOPs, bytes, link bytes, cross-pod bytes, collectives and every
    op's link bytes equal the eager trace of every trip (``rel=1e-12``);
    the peak of live storage is within 1% of it."""
    (trips, peak), (whole, whole_peak) = traced[case]["trips"], \
        traced[case]["whole"]
    for k in ("flops", "bytes", "link_bytes", "cross_pod_link_bytes",
              "n_coll"):
        assert trips[k] == pytest.approx(whole[k], rel=1e-12), k
    assert set(trips["by_op"]) == set(whole["by_op"])
    for op, v in whole["by_op"].items():
        assert trips["by_op"][op] == pytest.approx(v, rel=1e-12), op
    assert whole["flops"] > 0 and whole_peak > 0
    assert peak == pytest.approx(whole_peak, rel=0.01)


SCALING = r"""
import json, time, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
M.init_process_mesh(0, D.WORLD, "", "fake")
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
cfg = get_smoke_config("xlstm-1.3b")
best = {}
for _ in range(2):
    for S in (256, 768, 4096, 32768):
        t0 = time.perf_counter()
        D._trace(cfg, InputShape("t", S, 8, "train"), mesh, False,
                 "train_vanilla")
        best[S] = min(best.get(S, 1e9), time.perf_counter() - t0)
print("RESULT " + json.dumps(best))
"""


def test_trace_time_does_not_grow_with_seq_len():
    """An xlstm-1.3b smoke ``train_vanilla`` trace (the best of two) at
    4,096 and 32,768 steps takes at most 1.5x the trace at 768 (three
    chunks of 256, the first length at which every longer one also runs
    three chunks of three steps). 256 steps, one chunk without
    checkpoints, runs a third of that and is reported, not bounded."""
    best = _run(SCALING, [], timeout=600)
    for S in ("4096", "32768"):
        assert best[S] <= 1.5 * best["768"], best


def test_trips_are_inert_outside_a_cost_count_on_meta():
    """``layers.trips`` is a plain loop of every trip without a
    ``CostMode``, on a tensor that is not on ``meta``, or with three
    trips or fewer; only under a ``CostMode`` on ``meta`` does it run
    trips 0, 1 and n - 1."""
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.models import layers
    meta, cpu = torch.empty(8, 2, device="meta"), torch.zeros(8, 2)
    assert list(layers.trips(8, meta)) == list(range(8))
    with D.CostMode():
        assert list(layers.trips(8, cpu)) == list(range(8))
        assert list(layers.trips(3, meta)) == [0, 1, 2]
        loop = layers.trips(8, meta)
        assert list(loop) == [0, 1, 7]
        parts = loop.pick(meta)
        assert len(parts) == 3
        assert loop.join(parts, stack=True).shape == (8, 2)
    # the CPU recurrences compute the same under a CostMode as without
    from repro_torch.models import mamba
    g = torch.Generator().manual_seed(0)
    xc, dt = (torch.randn(2, 8, 4, generator=g) for _ in range(2))
    Bm, Cm = (torch.randn(2, 8, 3, generator=g) for _ in range(2))
    A, D_ = -torch.rand(4, 3, generator=g), torch.randn(4, generator=g)
    y0, h0 = mamba.selective_scan_ref(xc, dt.abs(), Bm, Cm, A, D_)
    with D.CostMode():
        y1, h1 = mamba.selective_scan_ref(xc, dt.abs(), Bm, Cm, A, D_)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
