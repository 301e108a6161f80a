"""``python -m repro_torch.launch.train --device cpu`` prints the JAX
CLI's per-round fields, round for round, under every ported strategy
flag (the divergence trigger's ``SKIP(sync)`` rounds included), and
rejects the flag combinations the JAX CLI rejects."""
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
