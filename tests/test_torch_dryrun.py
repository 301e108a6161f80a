"""The port's dry run (``repro_torch/launch/dryrun.py``) over the fake
backend, against the reference's ``repro/launch/dryrun.py``.

Everything that joins a process group runs in a subprocess (the fake
world is one per process), and so does every import of the reference's
dry run: importing it writes ``XLA_FLAGS`` into ``os.environ`` for 512
forced host devices.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")


def _run(script, timeout=600):
    proc = subprocess.run([sys.executable, "-c", script], env=ENV,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[-1][len("RESULT "):])


REFERENCE = r"""
import json
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch import dryrun as D
hlo = []
for op, shape in (("all-gather", "f32[8,16]"), ("reduce-scatter", "f32[2,16]"),
                  ("all-reduce", "bf16[64,32]"), ("all-to-all", "f32[8,4]"),
                  ("collective-permute", "f32[3,5]")):
    hlo.append(f"%x = {shape}{{1,0}} {op}(f32[1,1]{{1,0}} %p), "
               "replica_groups={{0,1,2,3}}")
print("RESULT " + json.dumps({
    "variants": D.VARIANTS,
    "microbatch": {n: D._microbatch(s) for n, s in INPUT_SHAPES.items()},
    "reduced": {a: [list(map(list, [p, [r]])) for p, r in
                    D._reduced(get_config(a), [1] * len(
                        get_config(a).segments)).segments]
                for a in ARCH_IDS},
    "links": [[c["op"], c["link_bytes"], c["group"]]
              for c in D.parse_collectives("\n".join(hlo))]}))
"""


def test_tables_and_ring_model_equal_the_reference():
    """``VARIANTS``, ``_microbatch`` over every input shape, ``_reduced``
    over every arch and the ring model's link bytes per op are the
    reference's."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun as D
    ref = _run(REFERENCE, timeout=300)
    assert D.VARIANTS == ref["variants"]
    assert {n: D._microbatch(s) for n, s in INPUT_SHAPES.items()} \
        == ref["microbatch"]
    for a in ARCH_IDS:
        cfg = get_config(a)
        got = D._reduced(cfg, [1] * len(cfg.segments))
        assert [[list(p), [r]] for p, r in got.segments] == ref["reduced"][a]
        assert got.n_layers == sum(len(p) for p, _ in cfg.segments)
    nbytes = {"all-gather": 8 * 16 * 4, "reduce-scatter": 2 * 16 * 4,
              "all-reduce": 64 * 32 * 2, "all-to-all": 8 * 4 * 4,
              "collective-permute": 3 * 5 * 4}
    assert len(ref["links"]) == 5
    for op, link, g in ref["links"]:
        assert g == 4
        assert D.link_bytes(op, nbytes[op], g) == pytest.approx(link,
                                                                rel=1e-12)


TOY = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.sharding import specs as sp
from repro_torch.sharding.constrain import constrain, mesh_scope
M.init_process_mesh(0, D.WORLD, "", "fake")
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
meta = lambda *s: torch.empty(s, device="meta")
x, w = sp.distribute({"x": meta(8, 16), "w": meta(16, 32)},
                     {"x": (None, None), "w": (None, "model")}, mesh).values()
mode = D.CostMode()
with mode, mesh_scope(x):
    y = constrain(x @ w, (None, "r"))         # gathered over model
    n = (y * y).sum(-1)                       # the replicated norm
out = mode.summary()
# a DTensor at a kernel raises
from repro_torch.kernels import ops
try:
    ops.quantize_blockwise(x)
    out["kernel_refused"] = False
except TypeError as e:
    out["kernel_refused"] = "DTensor" in str(e)
# the production meshes build over the fake world
out["single"] = list(D._mesh(False).mesh.shape)
out["multi"] = list(D._mesh(True).mesh.shape)
print("RESULT " + json.dumps(out))
"""


def test_toy_costs_are_the_hand_count():
    """A ``model``-sharded matmul, its result gathered and a replicated
    norm: per device 2·8·16·16 FLOPs of product, 8·32 of square and 8·32
    of sum; one all-gather of the (8, 32) f32 result over 2 ranks moves
    half of its 1 KiB. The production meshes build over the fake world
    and a DTensor at a kernel wrapper raises."""
    got = _run(TOY, timeout=300)
    assert got["flops"] == 2 * 8 * 16 * 16 + 8 * 32 + 8 * 32
    assert got["link_bytes"] == 8 * 32 * 4 / 2
    assert got["by_op"] == {"all-gather": 8 * 32 * 4 / 2}
    assert got["n_coll"] == 1 and got["cross_pod_link_bytes"] == 0
    assert got["kernel_refused"]
    assert got["single"] == [16, 16] and got["multi"] == [2, 16, 16]


SMOKE = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
M.init_process_mesh(0, D.WORLD, "", "fake")
meshes = {"single": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                               mesh_dim_names=("data", "model")),
          "multi": DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                              mesh_dim_names=("pod", "data", "model"))}
out = {}
for arch in ARCH_IDS:
    cfg = get_smoke_config(arch)
    for kind, by_mesh in D.VARIANTS.items():
        shape = InputShape(kind, 16, 8, kind)
        for mesh, variants in by_mesh.items():
            for variant in variants:
                costs, memory, _ = D._trace(cfg, shape, meshes[mesh],
                                            mesh == "multi", variant)
                out[f"{arch}/{mesh}/{variant}"] = [
                    costs["flops"], costs["link_bytes"],
                    costs["cross_pod_link_bytes"],
                    memory["peak_bytes_per_device"]]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def smoke_traces():
    """Every arch's smoke config, every variant of ``VARIANTS`` on a
    (2, 2) and a (2, 2, 2) fake mesh, 8 rows of 16 tokens: one
    subprocess (one fake world)."""
    return _run(SMOKE, timeout=900)


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return list(ARCH_IDS)


@pytest.mark.parametrize("arch", _arch_ids())
def test_every_arch_smoke_config_traces(smoke_traces, arch):
    """Each arch's smoke config traces every variant of both meshes
    (training, the pod variants, prefill, decode), with FLOPs and a peak
    to show for each; the pods' traffic crosses pods where the reference
    has them meet (the gradient mean, Eq. 2, the round) and nowhere else
    (a co-learning step, a prefill, a decode: a pod holds its rows)."""
    from repro_torch.launch import dryrun as D
    for kind, by_mesh in D.VARIANTS.items():
        for mesh, variants in by_mesh.items():
            for variant in variants:
                tag = f"{arch}/{mesh}/{variant}"
                flops, link, xpod, peak = smoke_traces[tag]
                assert flops > 0 and peak > 0, tag
                crosses = mesh == "multi" and variant in (
                    "train_vanilla", "average", "round_colearn")
                assert (xpod > 0) == crosses, tag
                if crosses:
                    assert link >= xpod, tag


DECOMP = r"""
import json, torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.sharding import specs as sp
M.init_process_mesh(0, D.WORLD, "", "fake")
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
out = []
for on_mesh in (True, True, False):
    x = torch.empty((8, 16) if on_mesh else (4, 8), device="meta")
    if on_mesh:
        x = sp.distribute({"x": x}, {"x": ("data", "model")}, mesh)["x"]
    x.requires_grad_(True)
    mode = D.CostMode()
    with mode:
        y = F.softplus(x)
        torch.autograd.backward(y, torch.ones_like(y))
    out.append([mode.flops, mode.bytes, mode.peak])
print("RESULT " + json.dumps(out))
"""


def test_dtensor_propagation_by_decomposition_is_not_counted():
    """DTensor has no rule for ``softplus_backward`` and propagates its
    sharding by running the op's decomposition on ``meta`` tensors of the
    global (8, 16) shape: none of it is a device's work. A sharded
    softplus and its backward cost a device what its (4, 8) shard's
    program costs, the second time as the first."""
    first, second, shard = _run(DECOMP, timeout=300)
    assert first == second == shard


LINEAR = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
M.init_process_mesh(0, D.WORLD, "", "fake")
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                  mesh_dim_names=("data", "model"))
cfg = get_smoke_config("internlm2-1.8b")
out = {}
for r in (1, 3, 5, 7):
    costs = D._trace(cfg.with_(n_layers=r, segments=((("gqa:dense",), r),)),
                     InputShape("t", 16, 8, "train"), mesh, False,
                     "train_vanilla")[0]
    out[r] = [costs["flops"], costs["bytes"], costs["link_bytes"]]
print("RESULT " + json.dumps(out))
"""


def test_a_training_step_costs_linear_in_depth():
    """The traced step's FLOPs, bytes and link bytes grow by the same
    amount with every two more layers (odd depths: the reference's
    templates shard an even stack of dense-FFN leaves over ``model``), so
    depth differencing is exact. Slicing each repeat out of the stacked
    params instead of one unbind made the backward pass's bytes grow with
    the square of the depth."""
    got = _run(LINEAR, timeout=300)
    for k in range(3):
        v = [got[str(r)][k] for r in (1, 3, 5, 7)]
        assert v[2] - 2 * v[1] + v[0] == 0 and v[3] - 2 * v[2] + v[1] == 0


FULL = r"""
import json, sys
from repro_torch.launch import dryrun as D
mesh_kind, variant = sys.argv[1], sys.argv[2]
rec = D.run_one("internlm2-1.8b", "train_4k", mesh_kind, variant,
                profile=(mesh_kind == "single"))
print("RESULT " + json.dumps(rec))
"""


def _run_all(args, timeout):
    """``FULL`` once per argument pair, all at once (one process each)."""
    procs = {a: subprocess.Popen([sys.executable, "-c", FULL, *a], env=ENV,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for a in args}
    out = {}
    try:
        for a, p in procs.items():
            so, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            line = [x for x in so.splitlines() if x.startswith("RESULT ")]
            out["/".join(a)] = json.loads(line[-1][len("RESULT "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


KEYS = {"arch", "shape", "mesh", "variant", "compile_s", "n_devices",
        "microbatch", "params_total", "params_active", "memory",
        "scan_raw_cost", "analytic"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_bytes_per_device"}
COSTS = {"flops", "bytes", "link_bytes", "cross_pod_link_bytes", "by_op",
         "n_coll"}


def test_internlm2_full_size_train_4k_on_both_meshes():
    """internlm2-1.8b at full size, ``train_4k``, every variant of both
    production meshes: the reference's record keys; the depth-differenced
    ``profile`` agrees with the raw trace within 1%; the pod variants'
    traffic crosses pods and the single pod's does not."""
    from repro_torch.launch import dryrun as D
    got = _run_all([(m, v) for m in ("single", "multi")
                    for v in D.VARIANTS["train"][m]], timeout=900)
    assert set(got) == {"single/train_vanilla", "multi/train_vanilla",
                        "multi/train_colearn", "multi/average",
                        "multi/round_colearn"}
    for tag, rec in got.items():
        assert KEYS <= set(rec), tag
        assert MEMORY <= set(rec["memory"]), tag
        assert COSTS <= set(rec["scan_raw_cost"]), tag
        assert rec["analytic"]["scan_correction_flops"] == 0.0
        assert rec["scan_raw_cost"]["flops"] > 0, tag
        assert rec["n_devices"] == (256 if tag.startswith("single") else 512)
    single = got["single/train_vanilla"]
    raw, prof = single["scan_raw_cost"], single["profile"]
    for k in ("flops", "bytes", "link_bytes"):
        assert prof[k] == pytest.approx(raw[k], rel=0.01), k
    assert single["scan_raw_cost"]["cross_pod_link_bytes"] == 0
    for tag in ("multi/train_vanilla", "multi/average",
                "multi/round_colearn"):
        assert got[tag]["scan_raw_cost"]["cross_pod_link_bytes"] > 0, tag
    assert got["multi/train_colearn"]["scan_raw_cost"][
        "cross_pod_link_bytes"] == 0
    assert single["microbatch"] == 4
