"""Every architecture's smoke config on a (data 2, model 2) mesh of four
CPU gloo ranks: one training step and two decode steps as DTensor
programs (the MoE dispatch, the recurrences, MLA's latent cache and the
vocab-sliced loss through ``constrain.local_call``), against the port's
unsharded steps at 1e-5 (rtol = atol).

One module fixture starts the ranks (``subprocess`` workers, one torch
thread each, a ``file://`` rendezvous); rank 0 writes what it gathered.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD, B, S, NDEC = 4, 4, 8, 2
TOL = {"rtol": 1e-5, "atol": 1e-5}

WORKER = r"""
import sys
import numpy as np
import torch

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
B, S, NDEC = (int(x) for x in sys.argv[4:7])
torch.set_num_threads(1)
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import transformer as tr
from repro_torch.sharding import specs as sp
from repro_torch.tree import leaves_with_path

M.init_process_mesh(rank, world, f"file://{d}/rdv", "gloo", "cpu")
mesh = M.make_sim_mesh((2, 2), ("data", "model"), "cpu")
inp = dict(np.load(f"{d}/inputs.npz"))
out = {}
for arch in ARCH_IDS:
    cfg = get_smoke_config(arch)
    params = tr.init_params(0, cfg, torch.float32, device="cpu")
    batch = {k[len(arch) + 1:]: torch.as_tensor(v) for k, v in inp.items()
             if k.startswith(arch + "/")}
    dparams = sp.distribute(params, sp.param_specs(params, cfg, mesh), mesh)
    dbatch = sp.distribute(batch, sp.batch_specs(cfg, mesh, "train"), mesh)
    new, loss = steps.make_train_step(cfg, lr=0.1)(dparams, dbatch)
    for path, t in leaves_with_path(sp.gather(new)):
        out[f"{arch}/train/{path}"] = t.numpy()
    out[f"{arch}/loss"] = loss.numpy()
    cache = tr.init_cache(cfg, B, S, torch.float32, device="cpu")
    dcache = sp.distribute(cache, sp.cache_specs(cache, mesh, B), mesh)
    serve = steps.make_serve_step(cfg)
    for i in range(NDEC):
        tok = sp.distribute({"tokens": batch["tokens"][:, i:i + 1]},
                            sp.batch_specs(cfg, mesh, "decode"),
                            mesh)["tokens"]
        logits, dcache = serve(dparams, dcache, tok, torch.tensor(i))
        out[f"{arch}/decode{i}"] = sp.gather(logits).numpy()
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
"""


def _batch(cfg, rng):
    pre = cfg.prefix_len if cfg.input_mode == "tokens+prefix" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int64),
             "labels": rng.integers(0, cfg.vocab_size, (B, S + pre),
                                    np.int64)}
    if pre:
        batch["prefix"] = rng.standard_normal(
            (B, pre, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_archs")
    rng = np.random.default_rng(0)
    batches = {a: _batch(get_smoke_config(a), rng) for a in ARCH_IDS}
    np.savez(d / "inputs.npz", **{f"{a}/{k}": v for a, b in batches.items()
                                  for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(k), str(WORLD), str(d), str(B),
         str(S), str(NDEC)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=400)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, errs[0]
    return {"out": dict(np.load(d / "out.npz")), "batches": batches}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_on_the_mesh_matches_unsharded(mesh_runs, arch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_smoke_config(arch)
        params = tr.init_params(0, cfg, torch.float32, device="cpu")
        batch = {k: torch.as_tensor(v)
                 for k, v in mesh_runs["batches"][arch].items()}
        new, loss = steps.make_train_step(cfg, lr=0.1)(params, batch)
        cache = tr.init_cache(cfg, B, S, torch.float32, device="cpu")
        serve = steps.make_serve_step(cfg)
        logits = []
        for i in range(NDEC):
            lg, cache = serve(params, cache, batch["tokens"][:, i:i + 1],
                              torch.tensor(i))
            logits.append(lg)
    finally:
        torch.set_num_threads(threads)
    out = mesh_runs["out"]
    for path, t in leaves_with_path(new):
        np.testing.assert_allclose(out[f"{arch}/train/{path}"], t.numpy(),
                                   err_msg=path, **TOL)
    np.testing.assert_allclose(out[f"{arch}/loss"], loss.numpy(), **TOL)
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(out[f"{arch}/decode{i}"], lg.numpy(),
                                   **TOL)
