"""The paper-task testbeds: the port's ``models/convnets.py`` against the
JAX package's, model by model.

All nine models are initialised in JAX (``PRNGKey(0)``) and carried across
with ``params_from_numpy``; on a batch of 4 from each task's generator the
logits, the gradients of ``logits.sum()`` and those of the harness's
classification loss match at atol = rtol = 1e-5. The port's own init gives
the same leaf paths, shapes and dtypes in ``tree.leaves`` order, and the
image models also run at odd and small sizes, where JAX's ``"SAME"`` pads
differently from a symmetric padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import audio_like, image_like, text_like
from repro.models import convnets as jcn
from repro.models.layers import softmax_xent as jxent
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.models import convnets as tcn
from repro_torch.models.layers import softmax_xent as txent
from repro_torch.tree import leaves, leaves_with_path

TOL = {"rtol": 1e-5, "atol": 1e-5}
TASKS = {"image": (jcn.IMAGE_MODELS, tcn.IMAGE_MODELS, image_like),
         "text": (jcn.TEXT_MODELS, tcn.TEXT_MODELS, text_like),
         "audio": (jcn.AUDIO_MODELS, tcn.AUDIO_MODELS, audio_like)}
CASES = [(task, name) for task, (models, _, _) in TASKS.items()
         for name in models]


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               err_msg=what, **TOL)


def _both(task, name):
    jmodels, tmodels, data = TASKS[task]
    x, y = data(seed=0, n=8)
    params_np = jax.tree.map(np.asarray,
                             jmodels[name][0](jax.random.PRNGKey(0)))
    return jmodels[name], tmodels[name], x[:4], y[:4], params_np


def _grads(apply_fn, params, fn):
    ps = {k: v for k, v in zip(
        [p for p, _ in leaves_with_path(params)], leaves(params))}
    for t in ps.values():
        t.requires_grad_(True)
    out = fn(apply_fn(params))
    return out, dict(zip(ps, torch.autograd.grad(out, list(ps.values()))))


@pytest.mark.parametrize("task,name", CASES)
def test_logits_and_grads_match_jax(task, name):
    (jinit, japply), (_, tapply), x, y, params_np = _both(task, name)
    jp = jax.tree.map(jnp.asarray, params_np)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)

    _close(tapply(params_from_numpy(params_np, "cpu"), xt),
           jax.jit(japply)(jp, xj), f"{name} logits")
    jlosses = {
        "sum": lambda p: japply(p, xj).sum(),
        "xent": lambda p: jxent(japply(p, xj)[:, None, :], yj[:, None])}
    tlosses = {
        "sum": lambda lg: lg.sum(),
        "xent": lambda lg: txent(lg[:, None, :], yt[:, None].long())}
    for kind in ("sum", "xent"):
        jval, jg = jax.jit(jax.value_and_grad(jlosses[kind]))(jp)
        tval, tg = _grads(lambda p: tapply(p, xt),
                          params_from_numpy(params_np, "cpu"),
                          tlosses[kind])
        _close(tval, jval, f"{name} {kind}")
        jflat = dict(zip([p for p, _ in leaves_with_path(params_np)],
                         jax.tree.leaves(jg)))
        assert set(jflat) == set(tg)
        for path, g in tg.items():
            _close(g, jflat[path], f"{name} d{kind}/d{path}")


@pytest.mark.parametrize("task,name", CASES)
def test_init_tree_matches_jax(task, name):
    (jinit, _), (tinit, _), _, _, params_np = _both(task, name)
    tp = tinit(torch.Generator().manual_seed(0))
    jl = [(p, a.shape, str(a.dtype)) for p, a in leaves_with_path(params_np)]
    tl = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
          for p, t in leaves_with_path(tp)]
    assert tl == jl
    # the same order as jax.tree.leaves (the flat wire's order)
    assert [a.shape for a in jax.tree.leaves(params_np)] == [
        tuple(t.shape) for t in leaves(tp)]
    for p, t in leaves_with_path(tp):
        assert torch.isfinite(t).all(), p
        if p.endswith("/b"):
            assert not t.any(), p               # biases start at zero


@pytest.mark.parametrize("hw", [9, 10, 5])
@pytest.mark.parametrize("name", sorted(jcn.IMAGE_MODELS))
def test_same_padding_at_odd_and_small_sizes(name, hw):
    """hw 9: stride 2 pads (1, 1) then (1, 1); hw 10: (0, 1) then (1, 1);
    hw 5: (1, 1) then (0, 1) — a fixed (0, 1) or a symmetric 1 each fail
    one of them."""
    x, _ = image_like(seed=3, n=4, hw=12)
    x = np.ascontiguousarray(x[:, :hw, :hw])
    params_np = jax.tree.map(np.asarray, jcn.IMAGE_MODELS[name][0](
        jax.random.PRNGKey(1)))
    want = jcn.IMAGE_MODELS[name][1](jax.tree.map(jnp.asarray, params_np),
                                     jnp.asarray(x))
    got = tcn.IMAGE_MODELS[name][1](params_from_numpy(params_np, "cpu"),
                                    torch.as_tensor(x))
    _close(got, want, f"{name} at hw={hw}")


def test_same_pads_are_jaxs():
    for n in range(1, 20):
        for stride in (1, 2):
            lo, hi = tcn._same_pads(n, 3, stride)
            out = -(-n // stride)
            assert (n + lo + hi - 3) // stride + 1 == out
            assert hi - lo in (0, 1)
    assert tcn._same_pads(16, 3, 2) == (0, 1)
    assert tcn._same_pads(9, 3, 2) == (1, 1)
    assert tcn._same_pads(16, 3, 1) == (1, 1)
