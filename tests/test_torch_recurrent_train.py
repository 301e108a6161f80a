"""Training the recurrent families: the port's ``layers.chunked_scan`` and
the backward pass of ``mlstm_cell_ref``, ``slstm_cell_ref`` and
``selective_scan_ref`` against the JAX package.

Inputs come from numpy with a fixed seed; f32 on both sides, 1e-5 (the
tolerance of ``tests/test_torch_models.py``). At S 512 every recurrence
runs two 256-step chunks, each recomputed in the backward pass
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``). The
smoke configs' loss and every gradient leaf are held through
``transformer.loss_fn`` at S 16 (a plain loop) and S 512 (chunked). A
``saved_tensors_hooks`` count shows what the chunking buys: the mLSTM's
(B, H, hd, hd) matrix memory is saved at least once a step without it and
at no step with it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import transformer as jtr
from repro.models import xlstm as jxl
from repro_torch.checkpoint import io as tio
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as txl
from repro_torch.tree import leaves, leaves_with_path

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _rand(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _torch_grads(fn, arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts)


def _jax_grads(fn, arrays):
    return jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))


# ---------------------------------------------------------------------------
# chunked_scan on a toy step
# ---------------------------------------------------------------------------
def _toy_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    return [_rand(rng, (S, 2, 4)), _rand(rng, (4, 4), 0.3),
            _rand(rng, (2, 4)), _rand(rng, (2, 4, 4), 0.5)]


def _toy_step(mod, W):
    """carry (a (B,d), M (B,d,d)); x_t (B,d); y_t (B,d)."""
    def step(carry, x_t):
        a, M = carry
        a = mod.tanh(x_t + a @ W)
        M = 0.5 * M + a[:, :, None] * a[:, None, :]
        return (a, M), (M * a[:, None, :]).sum(-1)
    return step


def _toy_loss(scan, mod, xs, W, a0, M0):
    (a, M), ys = scan(_toy_step(mod, W), (a0, M0), xs)
    return (ys * mod.sin(ys)).sum() + (a * 3.0).sum() + M.sum()


@pytest.mark.parametrize("S,chunk", [(12, 5), (8, 8), (8, 16), (12, 4)],
                         ids=["S%c", "c==S", "c>S", "chunked"])
def test_chunked_scan_matches_jax_values_and_gradients(S, chunk):
    """Values and gradients (xs, the step's closure W, both carries) of
    the toy step's scan at 1e-5 against the reference's ``chunked_scan``
    at the same ``chunk``: a plain loop when ``c`` does not divide S and
    when ``c == S``, three recomputed chunks in the last case."""
    arrays = _toy_inputs(S)
    tl, tg = _torch_grads(functools.partial(
        _toy_loss, functools.partial(tlayers.chunked_scan, chunk=chunk),
        torch), arrays)
    jl, jg = _jax_grads(functools.partial(
        _toy_loss, functools.partial(jlayers.chunked_scan, chunk=chunk),
        jnp), arrays)
    _close(tl, jl)
    for g, want in zip(tg, jg):
        _close(g, want)


def test_chunked_scan_recomputation_changes_no_value():
    """The recomputed chunks give the plain loop's values and gradients
    bit for bit (the same operations on the same inputs), and the scan
    keeps the leading time dim of ``ys`` and a tensor ``xs``."""
    arrays = _toy_inputs(12)
    runs = [_torch_grads(functools.partial(
        _toy_loss, functools.partial(tlayers.chunked_scan, chunk=4,
                                     remat=remat), torch), arrays)
            for remat in (True, False)]
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    x = torch.arange(6.0).reshape(6, 1)
    carry, ys = tlayers.chunked_scan(lambda c, x_t: (c + x_t, c * x_t),
                                     torch.zeros(1), x, chunk=2)
    assert ys.shape == (6, 1) and float(carry) == 15.0


# ---------------------------------------------------------------------------
# The three recurrences' gradients at S 512 (two recomputed chunks)
# ---------------------------------------------------------------------------
S_CHUNKED = 512


def _mlstm_arrays(B=2, S=S_CHUNKED, H=2, hd=8, seed=1):
    """q, k, v at 0.5, the forget gate's pre-activation around 2 (a long
    memory, carried across the chunk boundary), the loss weights."""
    rng = np.random.default_rng(seed)
    return [_rand(rng, (B, S, H, hd), 0.5) for _ in range(3)] + [
        _rand(rng, (B, S, H)), _rand(rng, (B, S, H), 1.0, 2.0),
        _rand(rng, (B, S, H, hd))]


def _mlstm_loss(mod, cell, q, k, v, ig, fg, w):
    h, st = cell(q, k, v, ig, fg)
    return (h * w).sum() + st["C"].sum() + st["n"].sum() + mod.tanh(
        st["m"]).sum()


def _slstm_arrays(B=2, S=S_CHUNKED, H=2, hd=4, seed=2):
    rng = np.random.default_rng(seed)
    return [_rand(rng, (B, S, H, 4 * hd)), _rand(rng, (H, hd, 4 * hd), 0.5),
            _rand(rng, (H, 4 * hd), 0.1), _rand(rng, (B, S, H, hd))]


def _slstm_loss(mod, cell, state, wx, r, b, w):
    h, st = cell(wx, r, b, state)
    return (h * w).sum() + st["c"].sum() + st["n"].sum() + st["h"].sum()


def _slstm_state(mod, B, H, hd):
    z = mod.zeros((B, H, hd), dtype=mod.float32)
    return {"h": z, "c": z, "n": z,
            "m": mod.full((B, H, hd), -1e30, dtype=mod.float32)}


def _scan_arrays(B=2, S=S_CHUNKED, di=6, st=4, seed=3):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(_rand(rng, (B, S, di), 1.0, -2.0)))   # softplus
    return [_rand(rng, (B, S, di)), dt.astype(np.float32),
            _rand(rng, (B, S, st)), _rand(rng, (B, S, st)),
            -np.exp(_rand(rng, (di, st), 0.5)), _rand(rng, (di,)),
            _rand(rng, (B, S, di))]


def _scan_loss(fn, xc, dt, Bm, Cm, A, D, w):
    y, h = fn(xc, dt, Bm, Cm, A, D)
    return (y * w).sum() + (h * h).sum()


def _cell_cases():
    B, H, hd = 2, 2, 4
    return {
        "mlstm": (_mlstm_arrays(),
                  functools.partial(_mlstm_loss, torch, txl.mlstm_cell_ref),
                  functools.partial(_mlstm_loss, jnp, jxl.mlstm_cell_ref)),
        "slstm": (_slstm_arrays(B=B, H=H, hd=hd),
                  functools.partial(_slstm_loss, torch, txl.slstm_cell_ref,
                                    _slstm_state(torch, B, H, hd)),
                  functools.partial(_slstm_loss, jnp, jxl.slstm_cell_ref,
                                    _slstm_state(jnp, B, H, hd))),
        "selective_scan": (_scan_arrays(),
                           functools.partial(_scan_loss,
                                             tmamba.selective_scan_ref),
                           functools.partial(_scan_loss,
                                             jmamba.selective_scan_ref))}


@pytest.mark.parametrize("cell", ["mlstm", "slstm", "selective_scan"])
def test_recurrence_gradients_match_jax_at_s512(cell):
    """The loss over every output (the sequence and the final state) and
    its gradient with respect to every input at 1e-5 against
    ``jax.value_and_grad`` of the reference cell: the mLSTM starts from
    m = -inf (no NaN reaches a gradient through its first ``f_p``), the
    sLSTM from the decode init's m = -1e30."""
    arrays, tfn, jfn = _cell_cases()[cell]
    tl, tg = _torch_grads(tfn, arrays)
    jl, jg = _jax_grads(jfn, arrays)
    _close(tl, jl)
    for g, want in zip(tg, jg):
        assert torch.isfinite(g).all()
        _close(g, want)


def test_grad_reads_a_given_state_and_returns_a_new_one():
    """Under autograd a given state is the initial carry only: the mLSTM
    and sLSTM cells leave it as it was and return new tensors (the
    no-grad path still updates it in place, as decode needs)."""
    q, k, v, ig, fg, _ = (torch.tensor(a) for a in _mlstm_arrays(S=6))
    st = {"C": torch.zeros((2, 2, 8, 8)), "n": torch.zeros((2, 2, 8)),
          "m": torch.full((2, 2), -1e30)}
    kept = {key: t.clone() for key, t in st.items()}
    for t in (q, k, v, ig, fg):
        t.requires_grad_()
    _, new = txl.mlstm_cell_ref(q, k, v, ig, fg, st)
    assert all(torch.equal(st[key], kept[key]) for key in st)
    assert all(new[key] is not st[key] and new[key].requires_grad
               for key in st)
    with torch.no_grad():
        _, same = txl.mlstm_cell_ref(q, k, v, ig, fg, st)
    assert all(same[key] is st[key] for key in st)
    assert not torch.equal(st["C"], kept["C"])
    wx, r, b, _ = (torch.tensor(a) for a in _slstm_arrays(S=6, hd=4))
    sst = _slstm_state(torch, 2, 2, 4)
    sst = {key: t.clone() for key, t in sst.items()}
    skept = {key: t.clone() for key, t in sst.items()}
    _, snew = txl.slstm_cell_ref(wx, r.requires_grad_(), b, sst)
    assert all(torch.equal(sst[key], skept[key]) for key in sst)
    assert all(snew[key] is not sst[key] for key in sst)


def _saved_matrix_memories(remat, S=S_CHUNKED, B=1, H=2, hd=8):
    """How many (B, H, hd, hd) tensors one mLSTM call's autograd graph
    saves, through a ``saved_tensors_hooks`` count, and its gradients."""
    arrays = _mlstm_arrays(B=B, S=S, H=H, hd=hd)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays[:5]]
    count = [0]

    def pack(t):
        count[0] += tuple(t.shape) == (B, H, hd, hd)
        return t
    scan = functools.partial(tlayers.chunked_scan, remat=remat)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(txl, "chunked_scan", scan)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            h, _ = txl.mlstm_cell_ref(*ts)
    return count[0], torch.autograd.grad((h * h).sum(), ts)


def test_chunked_mlstm_saves_no_matrix_memory_per_step():
    """Without the recomputation every step saves the matrix memory (at
    least once: S of them); with it the call saves no more than the
    boundary carries (S / 256 = 2), since each chunk's steps are
    recomputed in the backward pass. The gradients are equal."""
    n_remat, g_remat = _saved_matrix_memories(True)
    n_plain, g_plain = _saved_matrix_memories(False)
    assert n_plain >= S_CHUNKED
    assert n_remat <= S_CHUNKED // 256
    assert all(torch.equal(a, b) for a, b in zip(g_remat, g_plain))


# ---------------------------------------------------------------------------
# The smoke configs through transformer.loss_fn
# ---------------------------------------------------------------------------
def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y[0, :3] = -1                         # ignored positions
    return x, y


@pytest.mark.parametrize("arch,S", [("xlstm-1.3b", 16), ("xlstm-1.3b", 512),
                                    ("jamba-v0.1-52b", 512)])
def test_smoke_loss_and_every_gradient_match_jax(arch, S):
    """The smoke config's loss (the aux term in it for jamba) and every
    gradient leaf at 1e-5 against ``jax.value_and_grad(loss_fn)``: at S
    16 each recurrence is a plain loop, at S 512 two recomputed chunks
    (jamba's at S 16 is ``test_jamba_every_gradient_matches_jax``)."""
    cfg = get_smoke_config(arch)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    x, y = _tokens(cfg, 2, S)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, cfg, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    tp = tio.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tparams = [t.requires_grad_() for t in leaves(tp)]
    tl, _ = ttr.loss_fn(tp, cfg, {"tokens": torch.tensor(x),
                                  "labels": torch.tensor(y)})
    _close(tl, jl)
    grads = torch.autograd.grad(tl, tparams)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for (path, _), g, want in zip(leaves_with_path(tp), grads, jleaves):
        assert torch.isfinite(g).all(), path
        _close(g, want)
