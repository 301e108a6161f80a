"""The torch examples (``examples/torch_*.py``) run on the CPU and print
what their walkthroughs promise.

Each example is the port of the JAX example of the same name and takes
``--device`` (cuda by default); the training-heavy ones also take
``--n-examples``, cut here so the suite stays quick. The printed numbers
that depend only on the model's and the graph's shapes (wire bytes,
parameter counts, spectral gaps, live counts, membership events) equal
those of the JAX examples at their own sizes.
"""
import importlib.util
import re
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def run(name, capsys, *argv):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)            # defines main(); runs nothing
    capsys.readouterr()
    assert mod.main(["--device", "cpu", *argv]) == 0
    return capsys.readouterr().out.splitlines()


def test_examples_default_to_the_card():
    for path in sorted(EXAMPLES.glob("torch_*.py")):
        src = path.read_text()
        assert 'add_argument("--device", default="cuda"' in src, path.name
        assert "def main(argv=None)" in src, path.name


def test_quickstart(capsys):
    out = run("quickstart", capsys, "--n-examples", "200")
    rounds = [x for x in out if x.startswith("round ")]
    assert len(rounds) == 4
    pat = re.compile(r"^round (\d): T_i=(\d+) lr 0\.050->\S+ loss=\S+ "
                     r"\|Δw̄\|/\|w̄\|=\S+ next_T=(\d+) comm=11\.0MiB$")
    fields = [pat.match(x).groups() for x in rounds]
    assert [f[0] for f in fields] == ["0", "1", "2", "3"]
    assert "|Δw̄|/|w̄|=inf" in rounds[0]
    # Eq. 4: each round runs the T the previous one chose
    assert all(b[1] == a[2] for a, b in zip(fields, fields[1:]))
    assert out[-1] == "shared model params: 1443072"


def test_compressed_wan(capsys):
    out = run("compressed_wan", capsys, "--n-examples", "100")
    want = {"exact (paper)": "9.5", "int8 leafwise": "6.0",
            "int8 flat-buffer": "6.0", "int4 flat + EF": "5.4",
            "1-bit flat + EF": "4.9", "flat + partial m=2": "5.4",
            "flat + div-trigger": "6.0"}
    assert len(out) == len(want)
    for line, (label, mib) in zip(out, want.items()):
        m = re.match(r"^(.{20}) final_loss=(\S+)  comm/round=(\S+)MiB per "
                     r"participant, 3-round total=(\S+)MiB over (\d)/3 "
                     r"synced rounds \(f32 full-avg would be 9\.5MiB/round\)$",
                     line)
        assert m, line
        assert m.group(1).rstrip() == label and m.group(3) == mib
        synced = int(m.group(5))
        assert synced == 3 or label == "flat + div-trigger"
        assert float(m.group(4)) == pytest.approx(synced * float(mib),
                                                  abs=0.15)


def test_elastic_membership(capsys):
    out = run("elastic_membership", capsys, "--n-examples", "160")
    rounds = [x for x in out if x.startswith("round ")]
    assert [re.search(r"live=(\d)/4", x).group(1) for x in rounds] == [
        "4", "4", "3", "3", "4", "4"]
    assert rounds[2].endswith("<-- slot 1 leaves")
    assert rounds[4].endswith("<-- slot 1 joins")
    assert all("comm=11.0MiB" in x for x in rounds)
    assert out[-2] == ("membership event log: ((2, 1, 'leave'), "
                       "(4, 1, 'join'))")
    assert out[-1] == "shared model params: 1443072"


def test_graph_gossip(capsys):
    out = run("graph_gossip", capsys, "--n-examples", "320")
    assert out[:6] == [
        "topology diagnostics at K=8:",
        "  ring         max_degree=1 spectral_gap=0.076",
        "  grid2d       max_degree=3 spectral_gap=0.500",
        "  hypercube    max_degree=3 spectral_gap=0.500",
        "  exponential  max_degree=1 spectral_gap=0.333  (time-varying, "
        "period-averaged)",
        "  complete     max_degree=7 spectral_gap=1.000"]
    rounds = [x for x in out if x.startswith("round ")]
    assert len(rounds) == 4
    assert all(x.endswith("comm=33.0MiB/node (dense all-to-all would be "
                          "77.1MiB)") for x in rounds)
    spread = float(re.search(r"consensus mean: (\S+)$", out[-2]).group(1))
    assert 0 < spread < 0.1
    assert out[-1] == "shared model params: 1443072"


def test_serve_decode(capsys):
    out = run("serve_decode", capsys, "--n-examples", "90")
    assert [x.split(":")[0] for x in out[:2]] == ["round 0", "round 1"]
    prompt = eval(out[2].split(": ", 1)[1])
    gen = eval(out[3].split(": ", 1)[1])
    assert len(prompt) == 8 and len(gen) == 12
    assert all(0 <= t < 512 for t in gen)
    assert out[4] == "cache kinds: ['gqa', 'mamba']"


def test_continuous_serving(capsys):
    out = run("continuous_serving", capsys)
    rounds = [x for x in out if x.startswith("round ")]
    assert len(rounds) == 6
    for line in rounds:
        m = re.match(r"^round \d: (sync|quiet) loss=\S+ serving v(\d+) "
                     r"\(stale (\d+) rounds\) (swapped|held) \d+ tok/s "
                     r"compiles=1$", line)
        assert m, line
        assert (m.group(1) == "sync") == (m.group(4) == "swapped")
        assert (m.group(3) == "0") == (m.group(1) == "sync")
    n_sync = sum(" sync " in x for x in rounds)
    assert out[-1] == (f"served 192 tokens across 6 batches while training "
                       f"6 rounds; final version v{1 + n_sync} of "
                       f"{1 + n_sync}")


def test_heterogeneous_shards(capsys):
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import image_like
    out = run("heterogeneous_shards", capsys, "--n-examples", "400",
              "--rounds", "2")
    assert out[0].startswith("== quantity skew")
    for line in out[1:3]:
        assert re.match(r"^  weighted=(False|True): shards=\[200, 100, 50, "
                        r"50\] acc/round=\['\S+', '\S+'\]$", line), line
    assert out[3].startswith("== label skew")
    _, y = image_like(seed=0, n=400)
    for line, alpha in zip(out[4:6], (0.1, 1.0)):
        want = [len(i) for i in dirichlet_partition(y, 4, alpha, 0,
                                                    min_size=32)]
        assert line.startswith(f"  alpha={alpha}: shards={want} "), line
        assert sum(want) == 400
    assert out[-1] == ("every example trained: shard sizes above always "
                       "sum to 400")


def test_multidc_ablation(capsys):
    out = run("multidc_ablation", capsys, "--n-examples", "320",
              "--rounds", "1")
    rows = [x for x in out if x.startswith("ablation,resnet_tiny,")]
    assert [x.split(",")[2] for x in rows] == [
        "clr+ile", "clr+fle", "elr+ile", "elr+fle"]
    assert all(x.endswith(",T=[1]") for x in rows)
    assert re.match(r"^best combo: (clr|elr)\+(ile|fle) \(paper: clr\+ile\)$",
                    out[out.index(rows[-1]) + 1])
    table = [x for x in out if x.startswith("table2,")]
    assert [x.split(",")[1] for x in table] == ["vgg_tiny", "resnet_tiny"]
    for line in table:
        accs = dict(kv.split("=") for kv in line.split(",")[2:])
        assert set(accs) == {"vanilla", "ensemble", "colearn", "local_mean"}
        assert all(0.0 <= float(a) <= 1.0 for a in accs.values())
