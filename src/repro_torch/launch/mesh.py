"""Meshes over ``torch.distributed``, ported from
``repro/launch/mesh.py``.

The reference builds ``jax.make_mesh`` over the devices of one process.
The port runs one process per participant, started by the caller (the
tests and ``chip_smoke.py`` start them, as ``torchrun`` would): each
joins the default process group with :func:`init_process_mesh`, then
:func:`make_sim_mesh` / :func:`make_host_mesh` lay a ``DeviceMesh`` over
it (``init_device_mesh``). This slice runs the ``pod`` axis only: an
intra-pod ``data`` or ``model`` axis of size > 1 raises
``NotImplementedError``, and so does :func:`make_production_mesh`, whose
(16, 16) / (2, 16, 16) shapes are a TPU pod's.

The backend is always named by the caller, never switched: NCCL needs one
card per rank, so ranks sharing one card run over ``"gloo"``.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from repro_torch.core.collectives import check_pod_only
from repro_torch.device import resolve_device

SINGLE_POD = (16, 16)                       # the reference's TPU v5e pod
MULTI_POD = (2, 16, 16)


def init_process_mesh(rank: int, world: int, init_method: str,
                      backend: str, device=None):
    """Join the default process group as ``rank`` of ``world`` at
    ``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``) over
    ``backend`` (``"gloo"`` or ``"nccl"``, named explicitly). ``device``:
    ``"cpu"`` or a card (``"cuda"`` picks card ``rank % device_count``).
    Returns the rank's device, made current on the card.

    An NCCL group whose ranks share a card fails in its first collective
    ("Duplicate GPU detected"); it is refused here instead, naming the
    fix."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl'; got {backend!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device per rank")
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
    (whose world size must be ``prod(shape)``). Intra-pod axes of size > 1
    are not ported yet."""
    check_pod_only(dict(zip(axes, shape)))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device=None):
    """The trivial (1, 1) ``("data", "model")`` mesh of a world of one."""
    return make_sim_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    raise NotImplementedError(
        f"the production mesh {shape} is a TPU pod's shape; an H100 "
        "counterpart is not yet ported, see ROADMAP.md")
