"""The port's captured serving step and captured sLSTM recurrence against
the JAX package, on the CPU (where ``core/graphs.py`` runs each captured
function uncaptured, counting what the card would capture):

* ``transformer.reset_cache_`` gives back ``init_cache`` in place;
* one ``ServeLoop`` reused for two prompt batches (its one cache reset in
  place) gives the JAX loop's greedy tokens, for internlm2's (window 0
  and 4), xlstm's and jamba's smoke configs;
* a hot swap copies into the loop's own params and leaves the bank's
  snapshot as it was; a call that would capture a second graph raises;
* ``slstm_apply(impl="kernel")`` (``xlstm.slstm_scan``) equals
  ``impl="ref"`` and the JAX ``slstm_apply`` at 1e-5, and the sLSTM
  layers of a model share one capture without writing into their params;
* ``launch/serve.prefill_into_cache`` and ``launch/steps.make_serve_step``
  against their JAX counterparts.

Params are JAX-initialised and carried across with ``params_from_numpy``;
inputs come from numpy with a fixed seed. Greedy tokens must be equal;
logits and states agree at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.models import xlstm as jxl
from repro.serving import ServeLoop as JLoop
from repro_torch.checkpoint import io as tio
from repro_torch.core import graphs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as txl
from repro_torch.serving import ModelBank, ServeLoop
from repro_torch.tree import leaves, tree_map

TOL = {"rtol": 1e-5, "atol": 1e-5}
ARCHS = ["internlm2-1.8b", "xlstm-1.3b", "jamba-v0.1-52b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tio.params_from_numpy(_np(tree), "cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def tiny_lm(window=0):
    return get_smoke_config("internlm2-1.8b").with_(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, window=window, segments=((("gqa:dense",), 1),))


def _prompts(cfg, B, P, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)


# ---------------------------------------------------------------------------
# transformer.reset_cache_
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_reset_cache_gives_back_init_cache(arch):
    """After a few decode steps every leaf has moved; ``reset_cache_``
    writes ``init_cache``'s values back into the same storage, leaf by
    leaf (zeros, and -1e30 for the xLSTM stabilizers)."""
    cfg = get_smoke_config(arch)
    params = ttr.init_params(0, cfg, torch.float32, device="cpu")
    want = ttr.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    cache = ttr.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in leaves(cache)]
    toks = torch.tensor(_prompts(cfg, 2, 3, 1), dtype=torch.int64)
    for t in range(3):
        ttr.decode_step(params, cfg, cache, toks[:, t:t + 1],
                        torch.tensor(t, dtype=torch.int32))
    assert all(not torch.equal(a, b)
               for a, b in zip(leaves(cache), leaves(want)))
    assert ttr.reset_cache_(cfg, cache) is cache
    assert [t.data_ptr() for t in leaves(cache)] == ptrs
    for a, b in zip(leaves(cache), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# ServeLoop: one cache, one capture
# ---------------------------------------------------------------------------
LOOP_CASES = [("internlm2-w0", tiny_lm(0)), ("internlm2-w4", tiny_lm(4)),
              ("xlstm", get_smoke_config("xlstm-1.3b")),
              ("jamba", get_smoke_config("jamba-v0.1-52b"))]


@pytest.mark.parametrize("name,cfg", LOOP_CASES,
                         ids=[n for n, _ in LOOP_CASES])
def test_two_generates_on_one_loop_equal_jax(name, cfg):
    """Two prompt batches of different lengths through one loop (its one
    cache reset in place before each) give the JAX loop's tokens, with
    one capture and the cache's storage unmoved."""
    jp = jtr.init_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    jloop = JLoop(cfg, jp, batch=2, max_seq=12)
    loop = ServeLoop(cfg, _t(jp), batch=2, max_seq=12, device="cpu")
    ptrs = [t.data_ptr() for t in leaves(loop._cache)]
    for P, seed in ((6, 0), (3, 1)):
        prompts = _prompts(cfg, 2, P, seed)
        gen, stats = loop.generate(torch.tensor(prompts), 5)
        jgen, _ = jloop.generate(jnp.asarray(prompts), 5)
        np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
        assert stats["compile_count"] == 1
    assert [t.data_ptr() for t in leaves(loop._cache)] == ptrs
    assert loop.compile_count() == 1 and loop.batches_served == 2


def test_swap_copies_into_the_loops_params():
    """``poll`` copies the published version into the loop's own params:
    their storage is unmoved, their values are the new version's, and the
    bank's snapshot is only read."""
    cfg = tiny_lm()
    loop = ServeLoop(cfg, _t(jtr.init_params(jax.random.PRNGKey(0), cfg,
                                             jnp.float32)),
                     batch=2, max_seq=12, device="cpu")
    own = leaves(loop.params)
    ptrs = [t.data_ptr() for t in own]
    p1 = _t(jtr.init_params(jax.random.PRNGKey(1), cfg, jnp.float32))
    kept = tree_map(torch.clone, p1)
    bank = ModelBank()
    bank.publish(p1, round_i=1)
    assert loop.poll(bank) and loop.version == 1
    assert [t.data_ptr() for t in leaves(loop.params)] == ptrs
    assert all(a is b for a, b in zip(leaves(loop.params), own))
    for a, b in zip(leaves(loop.params), leaves(p1)):
        assert a is not b and torch.equal(a, b)
    snap = bank.current().params
    for a, b in zip(leaves(snap), leaves(kept)):
        assert torch.equal(a, b)
    assert loop.compile_count() == 1


def test_serveloop_second_capture_raises():
    """Params on other storage than the loop captured on would need a
    second capture: the call raises ``RecaptureError`` before capturing,
    and the loop serves again once its own params are back."""
    cfg = tiny_lm()
    loop = ServeLoop(cfg, ttr.init_params(0, cfg, torch.float32,
                                          device="cpu"),
                     batch=2, max_seq=12, device="cpu")
    prompts = torch.tensor(_prompts(cfg, 2, 4, 0))
    want, _ = loop.generate(prompts, 3)
    own, loop.params = loop.params, tree_map(torch.clone, loop.params)
    with pytest.raises(graphs.RecaptureError, match="limit of 1"):
        loop.generate(prompts, 3)
    assert loop.compile_count() == 1
    loop.params = own
    got, _ = loop.generate(prompts, 3)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# core/graphs: the capture limit and owned static inputs
# ---------------------------------------------------------------------------
def test_graphset_limit_raises_before_a_capture():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1
    f = graphs.GraphSet("cpu").capture(fn, "f", limit=1)
    x = torch.zeros(3)
    f(x)
    f(x)
    with pytest.raises(graphs.RecaptureError):
        f(torch.zeros(4))                 # another layout
    with pytest.raises(graphs.RecaptureError):
        f(torch.zeros(3))                 # other storage
    assert f.captures == 1 and len(calls) == 2
    assert torch.equal(f(x), torch.ones(3))


def test_graphset_owned_inputs_leave_the_callers_tensors():
    """With ``own_inputs`` the static inputs are clones of the first
    call's: a later call copies into them, never into the first caller's
    tensor (a view of stacked storage here)."""
    stack = torch.arange(6.0).reshape(2, 3)
    f = graphs.GraphSet("cpu").capture(lambda x: x * 2, "f", inputs=(0,),
                                       own_inputs=True)
    assert torch.equal(f(stack[0]), stack[0] * 2)
    assert torch.equal(f(stack[1]), stack[1] * 2)
    assert torch.equal(stack, torch.arange(6.0).reshape(2, 3))
    assert f.captures == 1


# ---------------------------------------------------------------------------
# the captured sLSTM recurrence
# ---------------------------------------------------------------------------
def _slstm_case(seed=0, B=2, S=12):
    cfg = get_smoke_config("xlstm-1.3b")
    jp = jxl.slstm_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, jp, x


def test_slstm_kernel_impl_matches_ref_and_jax():
    cfg, jp, x = _slstm_case()
    want = jxl.slstm_apply(jp, jnp.asarray(x), cfg)
    tp = _t(jp)
    with torch.no_grad():
        got = txl.slstm_apply(tp, torch.tensor(x), cfg, impl="kernel")
        ref = txl.slstm_apply(tp, torch.tensor(x), cfg, impl="ref")
    _close(got, want)
    _close(ref, want)
    torch.testing.assert_close(got, ref, **TOL)


def test_slstm_scan_state_matches_plain_loop():
    """``slstm_scan``'s hs and final state equal ``slstm_cell_ref`` from
    ``slstm_state_init``'s state."""
    cfg, jp, x = _slstm_case(seed=1, S=9)
    tp = _t(jp)
    wx = torch.einsum("bsd,dhg->bshg", torch.tensor(x), tp["w_in"])
    hs, st = txl.slstm_scan(wx, tp["r"], tp["b"])
    want_hs, want_st = txl.slstm_cell_ref(
        wx, tp["r"], tp["b"], txl.slstm_state_init(cfg, 2, torch.float32,
                                                   "cpu"))
    torch.testing.assert_close(hs, want_hs, **TOL)
    for k in ("h", "c", "n", "m"):
        torch.testing.assert_close(st[k], want_st[k], **TOL)


def test_slstm_layers_share_one_capture():
    """Two sLSTM layers (views of one stacked param tensor) run through one
    graph key, copied into its own static inputs: the layers' params are
    unchanged, and the prefill equals ``impl="ref"`` at 1e-5."""
    cfg = get_smoke_config("xlstm-1.3b").with_(
        n_layers=4, segments=((("mlstm:-", "slstm:-"), 2),))
    jp = jtr.init_params(jax.random.PRNGKey(5), cfg, jnp.float32)
    tp = _t(jp)
    kept = tree_map(torch.clone, tp)
    batch = {"tokens": torch.tensor(_prompts(cfg, 2, 10, 5))}
    txl.release_slstm_graphs()
    got = ttr.prefill(tp, cfg, batch, impl="kernel")
    assert txl.slstm_graph_counts() == {"captures": 1, "replays": 0}
    got2 = ttr.prefill(tp, cfg, batch, impl="kernel")
    assert txl.slstm_graph_counts()["captures"] == 1
    for a, b in zip(leaves(tp), leaves(kept)):
        assert torch.equal(a, b)
    want = jtr.prefill(jp, cfg, {"tokens": jnp.asarray(batch["tokens"])},
                       impl="pallas")
    _close(got, want)
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
    torch.testing.assert_close(got, ttr.prefill(tp, cfg, batch, impl="ref"),
                               **TOL)
    txl.release_slstm_graphs()
    assert txl.slstm_graph_counts() == {"captures": 0, "replays": 0}


def test_slstm_kernel_impl_rejects_grad():
    """The captured recurrence is forward only, as K5 and K7 are: with
    grad enabled and a param that requires grad it raises; under
    ``no_grad`` the same params run."""
    cfg, jp, x = _slstm_case(seed=2, S=4)
    tp = tree_map(lambda t: t.requires_grad_(), _t(jp))
    with pytest.raises(RuntimeError, match="forward only"):
        txl.slstm_apply(tp, torch.tensor(x), cfg, impl="kernel")
    with torch.no_grad():
        got = txl.slstm_apply(tp, torch.tensor(x), cfg, impl="kernel")
    _close(got, jxl.slstm_apply(jp, jnp.asarray(x), cfg))


# ---------------------------------------------------------------------------
# launch entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_cache_matches_jax(arch):
    cfg = get_smoke_config(arch)
    jp = jtr.init_params(jax.random.PRNGKey(9), cfg, jnp.float32)
    prompts = _prompts(cfg, 2, 5, 9)
    jlogits, jcache = jserve.prefill_into_cache(
        JLoop(cfg, jp, batch=2, max_seq=12), jnp.asarray(prompts))
    loop = ServeLoop(cfg, _t(jp), batch=2, max_seq=12, device="cpu")
    logits, cache = tserve.prefill_into_cache(loop, torch.tensor(prompts))
    assert cache is loop._cache
    _close(logits, jlogits)
    assert len(leaves(cache)) == len(jax.tree.leaves(jcache))
    for t, j in zip(leaves(cache), jax.tree.leaves(jcache)):
        _close(t, j)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_serve_step_matches_jax(arch):
    cfg = get_smoke_config(arch)
    jp = jtr.init_params(jax.random.PRNGKey(4), cfg, jnp.float32)
    tp = _t(jp)
    jstep, tstep = jsteps.make_serve_step(cfg), tsteps.make_serve_step(cfg)
    jc = jtr.init_cache(cfg, 2, 8, jnp.float32)
    tc = ttr.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    toks = _prompts(cfg, 2, 3, 4)
    for t in range(3):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc2 = tstep(tp, tc, torch.tensor(toks[:, t:t + 1]),
                        torch.tensor(t, dtype=torch.int32))
        assert tc2 is tc
        _close(tl, jl)
    for t, j in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(t, j)
