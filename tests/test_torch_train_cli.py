"""``python -m repro_torch.launch.train --device cpu`` prints the JAX
CLI's per-round fields, round for round."""
import re

import pytest

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ARGS = ["--participants", "3", "--rounds", "2", "--t0", "1",
        "--n-examples", "48", "--batch-size", "4", "--seq-len", "16",
        "--steps-per-epoch", "2", "--codec", "fused"]
ROUND = re.compile(
    r"^round (\d+): T=(\d+) lr ([\d.]+)->([\d.]+) rel_dw=(\S+) "
    r"local_loss=([\d.]+) eval=([\d.]+) comm=([\d.]+)MiB next_T=(\d+) "
    r"\([\d.]+s\)$")


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
