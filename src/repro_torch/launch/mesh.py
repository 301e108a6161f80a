"""Meshes over ``torch.distributed``, ported from
``repro/launch/mesh.py``.

The reference builds ``jax.make_mesh`` over the devices of one process.
The port runs one process per mesh position, started by the caller (the
tests and ``chip_smoke.py`` start them, as ``torchrun`` would): each
joins the default process group with :func:`init_process_mesh`, then
:func:`make_sim_mesh` / :func:`make_host_mesh` /
:func:`make_production_mesh` lay a ``DeviceMesh`` over it. Any
``(pod, data, model)`` shape runs: ``pod`` carries the participants (one
pod's row on each pod group, ``core/collectives.PodAxis``), ``data`` and
``model`` the FSDP and tensor parallelism inside a pod (DTensor
placements from ``sharding/specs.py``).

:func:`make_production_mesh` keeps the reference's shapes, (16, 16)
``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")``, so
that each dry-run record (``launch/dryrun.py``, over the ``"fake"``
backend) pairs with one of the reference's. On H100 nodes of 8 cards a
``model`` axis of 16 spans two NVLink domains: its collectives cross the
nodes' network. The shape is kept all the same.

The backend is always named by the caller, never switched: NCCL needs one
card per rank, so ranks sharing one card run over ``"gloo"``; ``"fake"``
(``torch.testing._internal.distributed.fake_pg``) is the dry run's.
"""
from __future__ import annotations

import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

SINGLE_POD = (16, 16)                       # the reference's TPU v5e pod
MULTI_POD = (2, 16, 16)


def init_process_mesh(rank: int, world: int, init_method: str,
                      backend: str, device=None):
    """Join the default process group as ``rank`` of ``world`` at
    ``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``) over
    ``backend`` (``"gloo"`` or ``"nccl"``, named explicitly; ``"staged"``:
    gloo on the host for a card's tensors too, ``collectives.StagedGroup``,
    for DTensor's collectives when ranks share a card; ``"fake"``:
    one process stands for rank ``rank`` of a world of ``world`` whose
    collectives move nothing, ``init_method`` unused — the dry run's).
    ``device``: ``"cpu"`` or a card (``"cuda"`` picks card ``rank %
    device_count``). Returns the rank's device, made current on the card.

    An NCCL group whose ranks share a card fails in its first collective
    ("Duplicate GPU detected"); it is refused here instead, naming the
    fix."""
    if backend not in ("gloo", "nccl", "fake", "staged"):
        raise ValueError(f"backend must be 'gloo', 'nccl', 'staged' or "
                         f"'fake'; got {backend!r}")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        return torch.device("cpu")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if backend == "staged":
        from repro_torch.core.collectives import register_staged
        register_staged()
        backend = ("cpu:gloo,cuda:staged" if dev.type == "cuda"
                   else "cpu:staged")
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world)
    if backend == "nccl":
        _refuse_shared_cards(dev, world)
    return dev


def _refuse_shared_cards(dev, world):
    side = dist.new_group(backend="gloo")
    ids = [None] * world
    dist.all_gather_object(
        ids, (socket.gethostname(),
              str(torch.cuda.get_device_properties(dev).uuid)), group=side)
    dist.destroy_process_group(side)
    if len(set(ids)) < world:
        raise ValueError(
            "two ranks of an NCCL group share one card, which NCCL refuses; "
            "pass backend='gloo', or give each rank a card of its own")


def make_sim_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"),
                  device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (whose world size must be ``prod(shape)``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device=None):
    """The trivial (1, 1) ``("data", "model")`` mesh of a world of one."""
    return make_sim_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(pod, data, model) = (2, 16, 16) or (data, model) = (16, 16), laid
    over the first ``prod(shape)`` ranks of the default group, so that one
    world of 512 serves both shapes (the dry run's). Every rank of the
    group must call it; a rank past the mesh holds no coordinate
    (``get_coordinate()`` is None). A smaller group raises
    ``ValueError`` naming the world it needs."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise ValueError(
            f"need a world of {n} ranks for {axes}={shape}, have {world} "
            "(the dry run joins the 'fake' backend at world 512)")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)
