"""``python -m repro_torch.launch.serve``: the JAX CLI's ``--max-seq``
guard, a run on the CPU when asked for, and no run without a card
otherwise."""
import ast
import re

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

ARGS = ["--batch", "2", "--prompt-len", "4", "--new-tokens", "3",
        "--max-seq", "8"]
LINE = re.compile(r"^(\S+): prefill (\d+) tok in [\d.]+s, decoded (\d+) tok "
                  r"in [\d.]+s \([\d.]+ tok/s batch=(\d+), (\d+) compile")


def test_serve_cli_validates_max_seq():
    over = ["--batch", "1", "--prompt-len", "16", "--new-tokens", "16",
            "--max-seq", "24"]
    for main, argv in ((tserve.main, over + ["--device", "cpu"]),
                       (jserve.main, over)):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2             # argparse parse-time error


def test_serve_cli_runs_on_the_cpu_and_prints_the_jax_fields(capsys):
    assert tserve.main(ARGS + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out.splitlines()
    assert jserve.main(ARGS) == 0
    j_out = capsys.readouterr().out.splitlines()
    # the numbers drawn differ (each package its own init); the fields,
    # the counts and the single decode-step build do not
    assert LINE.match(t_out[0]).groups() == LINE.match(j_out[0]).groups()
    assert "device=cpu" in t_out[0]
    toks = ast.literal_eval(t_out[1].split(":", 1)[1].strip())
    assert len(toks) == 3 and all(0 <= t < 512 for t in toks)


def test_serve_cli_runs_xlstm_on_the_cpu(capsys):
    """``--arch xlstm-1.3b`` goes through the registry to its smoke config,
    as the JAX CLI's does."""
    argv = ARGS + ["--arch", "xlstm-1.3b"]
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out.splitlines()
    assert jserve.main(argv) == 0
    j_out = capsys.readouterr().out.splitlines()
    assert LINE.match(t_out[0]).groups() == LINE.match(j_out[0]).groups()
    assert t_out[0].startswith("xlstm-smoke:") and "device=cpu" in t_out[0]
    toks = ast.literal_eval(t_out[1].split(":", 1)[1].strip())
    assert len(toks) == 3 and all(0 <= t < 256 for t in toks)


def test_serve_cli_runs_jamba_on_the_cpu(capsys):
    """``--arch jamba-v0.1-52b`` goes to its smoke config (Mamba + MoE and
    attention layers), as the JAX CLI's does."""
    argv = ARGS + ["--arch", "jamba-v0.1-52b"]
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out.splitlines()
    assert jserve.main(argv) == 0
    j_out = capsys.readouterr().out.splitlines()
    assert LINE.match(t_out[0]).groups() == LINE.match(j_out[0]).groups()
    assert t_out[0].startswith("jamba-smoke:") and "device=cpu" in t_out[0]
    toks = ast.literal_eval(t_out[1].split(":", 1)[1].strip())
    assert len(toks) == 3 and all(0 <= t < 512 for t in toks)


def test_serve_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(ARGS)
