"""``python -m repro_torch.launch.train --device cpu`` prints the JAX
CLI's per-round fields, round for round, under every ported strategy
flag (the divergence trigger's ``SKIP(sync)`` rounds included), and
rejects the flag combinations the JAX CLI rejects. ``--arch xlstm-1.3b``
(the recurrences' backward pass in the local steps), started from the JAX
CLI's init, matches its round fields at 1e-5 on both engines."""
import contextlib
import io
import re

import pytest

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ARGS = ["--participants", "3", "--rounds", "2", "--t0", "1",
        "--n-examples", "48", "--batch-size", "4", "--seq-len", "16",
        "--steps-per-epoch", "2", "--codec", "fused"]
ROUND = re.compile(
    r"^round (\d+): T=(\d+) lr ([\d.]+)->([\d.]+) rel_dw=(\S+) "
    r"local_loss=([\d.]+) eval=([\d.]+) comm=([\d.]+)MiB next_T=(\d+)"
    r"( SKIP\(sync\))? \([\d.]+s\)$")


def _rounds(out):
    return [ROUND.match(line).groups() for line in out.splitlines()
            if line.startswith("round ")]


@pytest.mark.parametrize("engine", ["fused", "python"])
def test_train_cli_prints_the_jax_fields(capsys, engine):
    """Both CLIs default to the fused engine: that case passes no
    ``--engine``; the python case passes it to both."""
    flags = [] if engine == "fused" else ["--engine", engine]
    assert ttrain.main(ARGS + flags + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert jtrain.main(ARGS + flags) == 0
    j_out = capsys.readouterr().out
    t_rounds, j_rounds = _rounds(t_out), _rounds(j_out)
    assert len(t_rounds) == len(j_rounds) == 2
    for t, j in zip(t_rounds, j_rounds):
        # round, T, lr first/last, comm and next_T are data-independent;
        # the losses differ (each package draws its own random init)
        assert t[:4] == j[:4] and t[7:] == j[7:]
    assert t_out.splitlines()[0].startswith("co-learning internlm2-smoke")
    assert "device=cpu" in t_out
    assert f"engine={engine}" in t_out and f"engine={engine}" in j_out


def _both(capsys, flags):
    assert ttrain.main(ARGS + flags + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert jtrain.main(ARGS + flags) == 0
    j_out = capsys.readouterr().out
    return t_out, j_out


@pytest.mark.parametrize("flags", [
    ["--aggregator", "partial", "--partition", "sizes", "--sizes",
     "24,16,8", "--engine", "python"],
    ["--aggregator", "partial", "--partial-m", "3", "--partition",
     "dirichlet", "--dirichlet-alpha", "0.3"]])
def test_train_cli_strategy_flags_print_the_jax_fields(capsys, flags):
    """Partial participation on quantity-skewed (ragged: 6, 4 and 2
    batches of 4, truncated to 2 steps) and label-skewed shards: the same
    shard sizes in the header, and every data-independent field (T, the
    rates, the partial bill, next T) round for round."""
    t_out, j_out = _both(capsys, flags)
    t_rounds, j_rounds = _rounds(t_out), _rounds(j_out)
    assert len(t_rounds) == len(j_rounds) == 2
    for t, j in zip(t_rounds, j_rounds):
        assert t[:4] == j[:4] and t[7:] == j[7:]
    shards = re.search(r"shards=\[[\d, ]+\]", j_out).group(0)
    assert shards in t_out.splitlines()[0]
    assert "aggregator=partial" in t_out


def test_train_cli_divtrigger_skips_the_jax_rounds(capsys):
    """δ = 0.05: both rounds quiet (0 bytes, ``SKIP(sync)``), and each
    round's divergence printed as rel_dw. Between the two divergences (each
    ≥ 5% away from it, on both sides), δ = 0.002 gives a quiet round 0 and
    a synced round 1 in both CLIs: the gate decides on the same values up
    to round 1 (round 0 is quiet in both runs)."""
    base = ["--sync-policy", "divtrigger", "--partition", "dirichlet"]
    t_out, j_out = _both(capsys, base)
    divs = []
    for out in (t_out, j_out):
        rounds = _rounds(out)
        assert [r[9] for r in rounds] == [" SKIP(sync)"] * 2
        assert [r[7] for r in rounds] == ["0.0"] * 2
        divs += [float(r[4]) for r in rounds]
    delta = 0.002
    # rel_dw is printed to 4 places: allow its rounding in the margin
    assert all(abs(d - delta) - 5e-5 > 0.05 * delta for d in divs), divs
    t_out, j_out = _both(capsys, base + ["--trigger-delta", str(delta)])
    t_rounds, j_rounds = _rounds(t_out), _rounds(j_out)
    assert [r[9] for r in t_rounds] == [r[9] for r in j_rounds] == [
        " SKIP(sync)", None]
    for t, j in zip(t_rounds, j_rounds):
        assert t[:4] == j[:4] and t[7:] == j[7:]


@pytest.mark.parametrize("flags", [
    ["--aggregator", "partial", "--partial-m", "4"],
    ["--aggregator", "partial", "--partial-m", "0"],
    ["--sizes", "24,16,8"],
    ["--partition", "sizes"],
    ["--dirichlet-alpha", "0.3"],
    ["--partition", "dirichlet", "--drop-remainder"],
    ["--aggregator", "partial", "--weighted-avg"],
    ["--topology", "grid2d"],
    ["--churn-events", "crash:1:1"],
    ["--codec", "exact", "--error-feedback"]])
def test_train_cli_rejects_what_the_jax_cli_rejects(capsys, flags):
    for main, extra in ((ttrain.main, ["--device", "cpu"]),
                        (jtrain.main, [])):
        with pytest.raises(SystemExit) as e:
            main(ARGS[:-2] + flags + extra)
        assert e.value.code == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# xlstm-1.3b: the mLSTM and sLSTM backward pass in the local steps
# ---------------------------------------------------------------------------
XLSTM_ARGS = ["--arch", "xlstm-1.3b", "--participants", "2", "--rounds", "2",
              "--n-examples", "64", "--seq-len", "16"]
FIELD_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _recorded_run(main, colearner, module, argv, init=None):
    """``main(argv)``'s stdout and, at full precision, each round's log
    and eval loss (``CoLearner.run_round`` and ``eval_loss`` wrapped)."""
    logs, evals = [], []
    run_round, eval_loss = colearner.run_round, module.eval_loss

    def recorded_round(self, *a, **kw):
        state = run_round(self, *a, **kw)
        logs.append(state["log"][-1])
        return state

    def recorded_eval(*a, **kw):
        evals.append(eval_loss(*a, **kw))
        return evals[-1]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(colearner, "run_round", recorded_round)
        mp.setattr(module, "eval_loss", recorded_eval)
        if init is not None:
            mp.setattr(module.tr, "init_params", init)
        assert main(argv) == 0
    return out.getvalue(), logs, evals


def _jax_init(seed, cfg, dtype, device=None):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import transformer as jtr
    from repro_torch.checkpoint import io as tio
    p = jtr.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return tio.params_from_numpy(jax.tree.map(np.asarray, p), device)


@pytest.fixture(scope="module", params=["fused", "python"])
def xlstm_runs(request):
    """One run of each CLI per engine (the fused one passes no
    ``--engine``: the default of both), the port's started from the JAX
    CLI's init."""
    from repro.core.colearn import CoLearner as JCoLearner
    from repro_torch.core.colearn import CoLearner as TCoLearner
    engine = request.param
    flags = XLSTM_ARGS + ([] if engine == "fused" else ["--engine", engine])
    j = _recorded_run(jtrain.main, JCoLearner, jtrain, flags)
    t = _recorded_run(ttrain.main, TCoLearner, ttrain,
                      flags + ["--device", "cpu"], init=_jax_init)
    return engine, t, j


def test_train_cli_xlstm_round_fields_match_jax(xlstm_runs):
    """``--arch xlstm-1.3b`` (its smoke config: one mLSTM and one sLSTM
    layer, trained through their backward pass) on each engine: the
    port's round fields equal the JAX CLI's, T, comm bytes and next T
    exactly, the rates, rel_dw, the local losses and the eval loss at
    1e-5, and the printed lines agree field for field but the seconds."""
    import numpy as np
    engine, (t_out, t_logs, t_evals), (j_out, j_logs, j_evals) = xlstm_runs
    assert len(t_logs) == len(j_logs) == 2
    for t, j in zip(t_logs, j_logs):
        assert (t.round, t.T, t.comm_bytes, t.synced) == (
            j.round, j.T, j.comm_bytes, j.synced)
        np.testing.assert_allclose([t.lr_first, t.lr_last],
                                   [j.lr_first, j.lr_last], **FIELD_TOL)
        np.testing.assert_allclose(t.local_losses, j.local_losses,
                                   **FIELD_TOL)
        if np.isinf(j.rel_change):
            assert np.isinf(t.rel_change)
        else:
            np.testing.assert_allclose(t.rel_change, j.rel_change,
                                       **FIELD_TOL)
    np.testing.assert_allclose(t_evals, j_evals, **FIELD_TOL)
    t_rounds, j_rounds = _rounds(t_out), _rounds(j_out)
    assert [r[:4] + r[7:] for r in t_rounds] == [r[:4] + r[7:]
                                                 for r in j_rounds]
    assert t_out.splitlines()[0].startswith("co-learning xlstm-smoke")
    assert f"engine={engine}" in t_out and f"engine={engine}" in j_out
