"""The port's config registry and the six architectures it gained last
against the JAX package: qwen1.5-32b and qwen2-72b (``gqa:dense`` with
QKV bias), musicgen-large (``gqa:dense``, MHA), internvl2-76b
(``tokens+prefix``), arctic-480b (``gqa:moe_dense``) and deepseek-v3-671b
(``mla:dense`` / ``mla:moe`` and the MTP head).

Parameters are JAX-initialised and carried across with
``repro_torch.checkpoint.io.params_from_numpy``; the QKV biases, which JAX
initialises to zero, get random values in numpy first, so that both sides
read them. Inputs come from numpy with a fixed seed; f32 on both sides,
1e-5 (the tolerance of ``tests/test_torch_models.py``). Each JAX run is
made once per architecture (``_jax_run``).
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import io as tio
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves, leaves_with_path

TOL = {"rtol": 1e-5, "atol": 1e-5}
NEW = ("qwen1.5-32b", "qwen2-72b", "musicgen-large", "internvl2-76b",
       "arctic-480b", "deepseek-v3-671b")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_arch_ids_equal_the_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(NEW) < set(tconfigs.ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("llama-7b")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference_field_by_field(arch):
    for get in ("get_config", "get_smoke_config"):
        t = getattr(tconfigs, get)(arch)
        j = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, get)
        assert t.layer_kinds() == j.layer_kinds()


def _batch(cfg, B=2, S=16, seed=0):
    """Tokens and labels; a ``tokens+prefix`` config also gets a
    (B, prefix_len, d_model) prefix, and its labels are -1 over it."""
    rng = np.random.default_rng(seed)
    P = cfg.prefix_len if cfg.input_mode == "tokens+prefix" else 0
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    y = rng.integers(0, cfg.vocab_size, (B, P + S)).astype(np.int32)
    y[:, :P] = -1
    y[0, P:P + 3] = -1
    b["labels"] = y
    if P:
        b["prefix"] = rng.standard_normal((B, P, cfg.d_model)).astype(
            np.float32)
    return b


def _params(cfg, seed=0):
    """The JAX init as numpy, with random QKV biases."""
    npp = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(seed),
                                                   cfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for seg in npp["segments"]:
        for layer in seg.values():
            for name in ("bq", "bk", "bv"):
                if name in layer["mixer"]:
                    layer["mixer"][name] = (0.5 * rng.standard_normal(
                        layer["mixer"][name].shape)).astype(np.float32)
    return npp


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """(params as numpy, batch, logits, metrics, grads) of the JAX
    package's smoke config."""
    cfg = jconfigs.get_smoke_config(arch)
    npp, b = _params(cfg), _batch(cfg)
    jp = jax.tree.map(jnp.asarray, npp)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    logits, _ = jax.jit(lambda p, x: jtr.forward(p, cfg, x))(jp, jb)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, x: jtr.loss_fn(p, cfg, x), has_aux=True))(jp, jb)
    return npp, b, np.asarray(logits), jax.tree.map(np.asarray, metrics), \
        jax.tree.leaves(grads)


@pytest.mark.parametrize("arch", NEW)
def test_smoke_logits_loss_and_every_gradient_match_jax(arch):
    """Logits, every metric of the loss (the aux loss and, for deepseek,
    the MTP loss included) and every gradient leaf at 1e-5."""
    npp, b, jlogits, jm, jg = _jax_run(arch)
    cfg = tconfigs.get_smoke_config(arch)
    tp = tio.params_from_numpy(npp, "cpu")
    tb = {k: torch.tensor(v) for k, v in b.items()}
    logits, _ = ttr.forward(tp, cfg, tb)
    assert tuple(logits.shape) == jlogits.shape
    _close(logits, jlogits)
    tparams = [t.requires_grad_() for t in leaves(tp)]
    loss, tm = ttr.loss_fn(tp, cfg, tb)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k])
    if cfg.n_experts:
        assert float(jm["aux_loss"]) > 0
    grads = torch.autograd.grad(loss, tparams)
    assert len(grads) == len(jg)
    for (path, _), g, want in zip(leaves_with_path(tp), grads, jg):
        _close(g, want)
        if path.rsplit("/", 1)[1] in ("bq", "bk", "bv"):
            assert float(g.abs().max()) > 0, path


@pytest.mark.parametrize("arch", NEW)
def test_smoke_prefill_and_in_place_decode_match_jax(arch):
    """``prefill(impl="kernel")`` (the plain K5 on the CPU; MLA ignores
    ``impl``) against JAX ``prefill(impl="pallas")`` (interpret mode), and
    a 4-token prompt then 4 greedy tokens through ``decode_step``: logits
    every step and every cache leaf at the end at 1e-5, the cache written
    in place. Decode reads tokens only, in both packages."""
    npp, b, _, _, _ = _jax_run(arch)
    cfg = tconfigs.get_smoke_config(arch)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = tio.params_from_numpy(npp, "cpu")
    pb = {k: v for k, v in b.items() if k != "labels"}
    want = jtr.prefill(jp, cfg, {k: jnp.asarray(v) for k, v in pb.items()},
                       impl="pallas")
    got = ttr.prefill(tp, cfg, {k: torch.tensor(v) for k, v in pb.items()},
                      impl="kernel")
    _close(got, want)
    jc = jtr.init_cache(cfg, 2, 8, jnp.float32)
    tc = ttr.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in leaves(tc)]
    jstep = jax.jit(lambda p, c, t, i: jtr.decode_step(p, cfg, c, t, i))
    prompt = b["tokens"][:, :4]
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.tensor(prompt[:, :1])
    for pos in range(8):
        jl, jc = jstep(jp, jc, jtok, jnp.int32(pos))
        tl, _ = ttr.decode_step(tp, cfg, tc, ttok, torch.tensor(pos))
        _close(tl, jl)
        if pos + 1 < 4:
            jtok = jnp.asarray(prompt[:, pos + 1:pos + 2])
            ttok = torch.tensor(prompt[:, pos + 1:pos + 2])
        else:
            jtok = jnp.argmax(jl, -1).astype(jnp.int32)
            ttok = torch.argmax(tl, -1)
    assert [t.data_ptr() for t in leaves(tc)] == ptrs
    for t, j in zip(leaves(tc), jax.tree.leaves(jc)):
        _close(t, j)


def test_internvl2_prefix_goes_before_the_tokens():
    """A (2, 16, 256) prefix, cast to the embeddings' dtype, then the
    token embeddings: ``embed_inputs`` equals JAX's, in bf16 too, and the
    forward's positions span prefix plus tokens (32 logits rows)."""
    cfg = tconfigs.get_smoke_config("internvl2-76b")
    assert (cfg.input_mode, cfg.prefix_len, cfg.d_model) == (
        "tokens+prefix", 16, 256)
    npp, b, jlogits, _, _ = _jax_run("internvl2-76b")
    assert b["prefix"].shape == (2, 16, 256)
    assert (b["labels"][:, :16] == -1).all()
    assert jlogits.shape == (2, 32, cfg.vocab_size)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdtype), npp)
        tp = tio.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        want = jtr.embed_inputs(jp, cfg, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        got = ttr.embed_inputs(tp, cfg, {k: torch.tensor(v)
                                         for k, v in b.items()})
        assert got.dtype == dtype and tuple(got.shape) == (2, 32, 256)
        np.testing.assert_array_equal(
            tio.params_to_numpy(got).astype(np.float32),
            np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_arctic_moe_dense_layer_matches_jax(factor):
    """One ``gqa:moe_dense`` layer: its output (the MoE's plus the dense
    FFN's on the same normed input) and its aux loss at 1e-5, at a factor
    that drops tokens and a drop-free one."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    cfg = tconfigs.get_smoke_config("arctic-480b").with_(
        capacity_factor=factor)
    assert cfg.segments[0][0] == ("gqa:moe_dense",)
    jl = jtr.layer_init(jax.random.PRNGKey(4), "gqa:moe_dense", cfg,
                        jnp.float32)
    assert sorted(jl["ffn"]) == ["dense", "moe"]
    npl = jax.tree.map(np.asarray, jl)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jy, jaux = jtr.layer_apply(jl, "gqa:moe_dense", jnp.asarray(x), cfg,
                               jnp.asarray(pos))
    tl = tio.params_from_numpy(npl, "cpu")
    ty, taux = ttr.layer_apply(tl, "gqa:moe_dense", torch.tensor(x), cfg,
                               torch.tensor(pos))
    assert float(jaux) > 0
    _close(ty, jy)
    _close(taux, jaux)
    # the output is the attention residual plus the MoE's and the dense
    # FFN's outputs on the same normed input; without the dense FFN's it
    # differs
    from repro_torch.models import attention as tattn
    from repro_torch.models.layers import ffn_apply, rmsnorm_apply
    xt = torch.tensor(x)
    a, _ = tattn.attn_apply(tl["mixer"],
                            rmsnorm_apply(tl["norm1"], xt, cfg.norm_eps),
                            cfg, torch.tensor(pos))
    x1 = xt + a
    h = rmsnorm_apply(tl["norm2"], x1, cfg.norm_eps)
    moe_only, _ = tmoe.moe_apply(tl["ffn"]["moe"], h, cfg)
    jmoe_only, _ = jmoe.moe_apply(jl["ffn"]["moe"],
                                  jnp.asarray(h.numpy()), cfg)
    _close(moe_only, jmoe_only)
    dense = ffn_apply(tl["ffn"]["dense"], h)
    _close(x1 + moe_only + dense, jy)
    assert float(dense.abs().max()) > 1e-2
    assert not np.allclose((x1 + moe_only).numpy(), np.asarray(jy), **TOL)


ROUND = re.compile(r"^round (\d+): .* local_loss=([\d.]+) eval=([\d.]+) ")
CLI = ["--participants", "2", "--rounds", "1", "--t0", "1",
       "--n-examples", "16", "--batch-size", "4", "--seq-len", "8",
       "--steps-per-epoch", "2", "--engine", "python"]


def test_train_cli_deepseek_prints_the_jax_losses(capsys, monkeypatch):
    """``--arch deepseek-v3-671b`` (the MTP loss and the MoE in the local
    steps), python engine, one round: the port's CLI, started from the
    JAX CLI's init, prints the JAX CLI's local and eval losses (to the
    printed 4 places, one unit of rounding allowed)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    argv = CLI + ["--arch", "deepseek-v3-671b"]
    assert jtrain.main(argv) == 0
    j_out = capsys.readouterr().out

    def jax_init(seed, cfg, dtype, device=None):
        p = jtr.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
        return tio.params_from_numpy(jax.tree.map(np.asarray, p), device)
    monkeypatch.setattr(ttrain.tr, "init_params", jax_init)
    assert ttrain.main(argv + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert t_out.splitlines()[0].startswith("co-learning deepseek-v3-smoke")
    t = [ROUND.match(x).groups() for x in t_out.splitlines()
         if x.startswith("round ")]
    j = [ROUND.match(x).groups() for x in j_out.splitlines()
         if x.startswith("round ")]
    assert len(t) == len(j) == 1
    for a, b in zip(t[0][1:], j[0][1:]):
        assert abs(float(a) - float(b)) <= 1.5e-4, (t, j)


@pytest.mark.parametrize("cli", ["train", "continuous"])
def test_clis_refuse_a_prefix_config_before_the_first_round(capsys, cli):
    """internvl2-76b's batches need a prefix the synthetic corpus does not
    make (the JAX train CLI fails inside its first step with KeyError:
    'prefix'): the port's CLIs stop at once, naming it."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--arch", "internvl2-76b", "--device", "cpu",
                  "--rounds", "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "'prefix'" in err and "tokens+prefix" in err
