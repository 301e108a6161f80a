"""Per-layer recomputation (``remat``) on the port's training path.

``transformer.forward`` / ``loss_fn`` recompute each repeat of each
segment in the backward pass by default, as the reference's
``jax.checkpoint`` of its scan body does. Parameters are JAX-initialised
and carried across with ``checkpoint.io``; inputs come from numpy with a
fixed seed; f32 on both sides.

* The loss and every gradient of ``loss_fn(remat=True)`` against the
  reference's ``loss_fn(..., remat=True)`` at 1e-5, for the smoke configs
  of internlm2 (GQA, dense), jamba (Mamba + MoE), xlstm (mLSTM + sLSTM at
  S 512: each recurrence's two 256-step ``chunked_scan`` checkpoints
  nest inside the layer's) and deepseek-v3 (MLA + MoE + the MTP head).
* Within the port, the gradients with and without ``remat`` at 1e-7.
* A count of ``layer_apply`` calls shows the knob acting: each layer runs
  twice per forward and backward with ``remat``, once without it, and
  once under ``torch.no_grad`` (where ``remat`` does nothing); the step
  builders pass it through.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import transformer as jtr
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import averaging as tavg
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves, leaves_with_path

TOL = {"rtol": 1e-5, "atol": 1e-5}
# (arch, S): xlstm at S 512 runs two 256-step chunks a recurrence
CASES = [("internlm2-1.8b", 16), ("jamba-v0.1-52b", 16),
         ("xlstm-1.3b", 512), ("deepseek-v3-671b", 16)]


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y[0, :3] = -1                         # ignored positions
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = get_smoke_config(arch)
    return cfg, jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)


def _port(arch, S, B=2):
    """The smoke config, the JAX params as torch leaves that require grad,
    and a batch of tokens."""
    cfg, jp = _jax_params(arch)
    tp = tio.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for t in leaves(tp):
        t.requires_grad_()
    x, y = _tokens(cfg, B, S)
    return cfg, tp, {"tokens": torch.tensor(x), "labels": torch.tensor(y)}


def _grads(tp, cfg, batch, **kw):
    loss, metrics = ttr.loss_fn(tp, cfg, batch, **kw)
    return loss, metrics, torch.autograd.grad(loss, leaves(tp))


@pytest.mark.parametrize("arch,S", CASES)
def test_remat_loss_and_every_gradient_match_jax(arch, S):
    cfg, jp = _jax_params(arch)
    _, tp, batch = _port(arch, S)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, cfg, b, remat=True), has_aux=True))(
        jp, jb)
    tl, tm, grads = _grads(tp, t_smoke(arch), batch, remat=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    for key in jm:
        np.testing.assert_allclose(tm[key].detach().numpy(),
                                   np.asarray(jm[key]), **TOL)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for (path, _), g, want in zip(leaves_with_path(tp), grads, jleaves):
        assert torch.isfinite(g).all(), path
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch,S", CASES)
def test_remat_changes_no_gradient(arch, S):
    """The recomputed forward is the same forward: loss and gradients
    with and without ``remat`` within 1e-7 on the CPU."""
    _, tp, batch = _port(arch, S)
    cfg = t_smoke(arch)
    l1, _, g1 = _grads(tp, cfg, batch, remat=True)
    l0, _, g0 = _grads(tp, cfg, batch, remat=False)
    assert torch.allclose(l1, l0, rtol=0, atol=1e-7)
    for (path, _), a, b in zip(leaves_with_path(tp), g1, g0):
        assert torch.allclose(a, b, rtol=0, atol=1e-7), path


def _counting(monkeypatch):
    """Count ``transformer.layer_apply`` calls (the MTP head's too)."""
    calls = [0]
    real = ttr.layer_apply

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(ttr, "layer_apply", counted)
    return calls


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v3-671b"])
def test_each_layer_is_recomputed_once_per_backward(arch, monkeypatch):
    """Twice per forward and backward with ``remat`` (the forward, then
    the recomputation), once without, once under ``torch.no_grad``. The
    MTP head's layer is outside the segments and runs once either way."""
    calls = _counting(monkeypatch)
    _, tp, batch = _port(arch, 8)
    cfg = t_smoke(arch)
    n = cfg.n_layers
    mtp = int(bool(cfg.mtp_depth))
    for remat, want in ((True, 2 * n + mtp), (False, n + mtp)):
        calls[0] = 0
        _grads(tp, cfg, batch, remat=remat)
        assert calls[0] == want, (remat, calls[0])
    calls[0] = 0
    with torch.no_grad():
        ttr.loss_fn(tp, cfg, batch, remat=True)
    assert calls[0] == n + mtp


def test_step_builders_pass_remat_through(monkeypatch):
    """``make_train_step``, ``make_colearn_train_step`` and
    ``make_fused_round_step`` recompute by default, as the reference's
    builders do, and not with ``remat=False``; the two settings give the
    same step."""
    calls = _counting(monkeypatch)
    _, _, batch = _port("internlm2-1.8b", 8)
    cfg = t_smoke("internlm2-1.8b")
    params = tio.params_from_numpy(
        jax.tree.map(np.asarray, _jax_params("internlm2-1.8b")[1]), "cpu")
    n = cfg.n_layers
    outs = {}
    for remat, kw in ((True, {}), (False, {"remat": False})):
        calls[0] = 0
        new, loss = tsteps.make_train_step(cfg, lr=0.05, **kw)(params, batch)
        assert calls[0] == (2 if remat else 1) * n
        calls[0] = 0
        stacked = tavg.stack_participants(params, 2)
        cb = {k: torch.stack([v, v]) for k, v in batch.items()}
        tsteps.make_colearn_train_step(cfg, lr=0.05, **kw)(stacked, cb)
        assert calls[0] == (2 if remat else 1) * n * 2
        calls[0] = 0
        ccfg = CoLearnConfig(n_participants=2, T0=1, eta0=0.05,
                             max_rounds=2)
        rf = tsteps.make_fused_round_step(cfg, ccfg, device="cpu",
                                          codec="fused", **kw)
        rb = {k: v[None, :, None] for k, v in cb.items()}
        p, _, aux = rf(tavg.stack_participants(params, 2), (), rb, 0)
        assert calls[0] == (2 if remat else 1) * n * 2
        outs[remat] = (new, loss, p, aux["losses"])
    for a, b in zip(leaves(outs[True][0]), leaves(outs[False][0])):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)
    assert torch.allclose(outs[True][1], outs[False][1], rtol=0, atol=1e-7)
    for a, b in zip(leaves(outs[True][2]), leaves(outs[False][2])):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)
    assert torch.allclose(outs[True][3], outs[False][3], rtol=0, atol=1e-7)
