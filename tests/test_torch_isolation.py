"""The PyTorch port stands alone and never falls back to the CPU.

* No module of ``src/repro_torch/``, no torch example
  (``examples/torch_*.py``) and not ``chip_smoke.py`` imports ``jax``,
  ``jaxlib`` or anything of the JAX package ``repro``.
* Without a card, every entry point raises unless the caller passes
  ``device="cpu"`` (``--device cpu``) explicitly.
"""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    return files + examples + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 20
    # the port's own copies of the reference's numpy-only modules, and
    # the pod path's modules
    for name in ("membership", "topology", "collectives"):
        assert ROOT / "src" / "repro_torch" / "core" / f"{name}.py" in files
    for rel in (("launch", "mesh.py"), ("launch", "steps.py"),
                ("sharding", "specs.py"), ("sharding", "constrain.py"),
                ("launch", "dryrun.py")):
        assert ROOT.joinpath("src", "repro_torch", *rel) in files
    assert ROOT / "src" / "repro_torch" / "data" / "stream.py" in files
    assert {f.name for f in files if f.parent.name == "examples"} == {
        f"torch_{n}.py" for n in ("quickstart", "compressed_wan",
                                  "elastic_membership", "graph_gossip",
                                  "serve_decode", "continuous_serving",
                                  "heterogeneous_shards",
                                  "multidc_ablation")}
    assert {f.name for f in files if f.parent.name == "paper_tasks"} == {
        "__init__.py", "harness.py", "cifar_like.py", "tasks.py",
        "ablation.py"}
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import CoLearnConfig
    from repro_torch.core.colearn import CoLearner
    from repro_torch.device import resolve_device
    from repro_torch.launch import train
    from repro_torch.models import transformer as tr

    cfg = get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.init_params(0, cfg, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoLearner(CoLearnConfig(n_participants=2), lambda p, b: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--rounds", "1", "--participants", "2",
                    "--n-examples", "16", "--batch-size", "4",
                    "--seq-len", "8"])
    from repro_torch.launch import continuous
    with pytest.raises(RuntimeError, match="CUDA"):
        continuous.main(["--rounds", "1"])
    from repro_torch.paper_tasks import ablation, cifar_like, tasks
    for script in (cifar_like, tasks, ablation):
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main([])
    import importlib.util
    for path in sorted((ROOT / "examples").glob("torch_*.py")):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    # asked for explicitly, the CPU is fine
    assert resolve_device("cpu").type == "cpu"
    p = tr.init_params(0, cfg.with_(n_layers=1,
                                    segments=((("gqa:dense",), 1),)),
                       torch.float32, device="cpu")
    assert p["embed"]["table"].device.type == "cpu"


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A world of one over gloo and its (1,) ``pod`` mesh."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    mesh.init_process_mesh(0, 1, f"file://{tmp_path}/rdv", "gloo", "cpu")
    try:
        yield mesh.make_sim_mesh((1,), ("pod",), "cpu")
    finally:
        dist.destroy_process_group()


def test_unported_paths_raise_not_implemented(one_rank_mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import api, engine, schedule
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tr
    from repro_torch.optim.optimizers import get_optimizer

    # every architecture and layer kind of the reference is ported: what
    # is left raises for what it is, an unknown arch or layer kind
    with pytest.raises(ValueError, match="unknown layer kind"):
        tr.init_params(0, get_smoke_config("internlm2-1.8b").with_(
            n_layers=1, segments=((("mla:ssm",), 1),)), device="cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("deepseek-v4")
    assert get_smoke_config("deepseek-v3-671b").mtp_depth == 1
    # the pod axis is ported: every aggregator's mesh branch builds over a
    # one-rank gloo mesh (the gossip permutes, the psums, the fused mean),
    # and so does the live pod round; only the intra-pod axes and the
    # TPU's production mesh are left, and they raise
    for spec in ("full", "partial", "ring", "graph", "d2"):
        fn = api.get_aggregator(spec).make_aggregate_fn(
            api.ExactF32(), mesh=one_rank_mesh)
        assert fn.pod.size == 1 and fn.pod.index == 0
    opt = get_optimizer("sgd")
    agg = api.FullAverage().make_aggregate_fn(
        api.FlatFusedInt8(), mesh=one_rank_mesh, dynamic=True)
    assert callable(engine.make_fused_round(lambda p, b: None, opt,
                                            live=True, aggregate_fn=agg,
                                            spmd_axis_name="pod"))
    host = mesh.make_host_mesh("cpu")
    assert host.mesh_dim_names == ("data", "model") and host.size() == 1
    # the intra-pod axes are ported too: a 3-axis mesh builds; the
    # production mesh needs its world, and a DTensor never reaches a
    # kernel as if its shard were the whole tensor
    assert mesh.make_sim_mesh((1, 1, 1), device="cpu").mesh_dim_names == (
        "pod", "data", "model")
    with pytest.raises(ValueError, match="need a world of 512"):
        mesh.make_production_mesh(multi_pod=True)
    from repro_torch.kernels import ops
    from repro_torch.sharding import specs
    dt = specs.distribute({"x": torch.ones(4, 256)}, {"x": ("data", None)},
                          host)["x"]
    with pytest.raises(TypeError, match="DTensor"):
        ops.quantize_blockwise(dt)
    # (the live divergence no longer raises: one live row, drift 1)
    assert schedule.divergence({"w": torch.zeros((2, 256))},
                               {"w": torch.ones(256)}, [True, False]) == 1.0
