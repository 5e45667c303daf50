"""Meshes of the port. Functions, not module constants: importing this
touches no device and no process group.

Counterpart of ``src/repro/launch/mesh.py``. One process drives one GPU
(``torchrun --nproc_per_node=<GPUs>``), so a mesh is laid over the
process group's world: its ``data`` dim carries the batch (DP / FSDP /
ZeRO), its ``model`` dim tensor, expert and sequence parallelism.
"""

from __future__ import annotations

import torch.distributed as dist

# GPUs of one NVLink node: the production mesh's model dim stays inside it.
NODE_GPUS = 8


def _device_type() -> str:
    """The process group's device type: "cuda" under NCCL, "cpu" under
    gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "[mesh] no process group: call torch.distributed."
            "init_process_group first (one process per GPU, e.g. under "
            "torchrun)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False):
    """The H100 cluster's mesh over the process group's world: ``model``
    is the 8 GPUs of an NVLink node, ``data`` the rest of the world;
    ``multi_pod`` adds an outer ``pod`` axis of 2 that extends DP across
    the pod boundary (gradient reductions then decompose hierarchically:
    inside a pod, then across the two).

    Axes: ('data', 'model'), or ('pod', 'data', 'model') under
    ``multi_pod``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _world()
    pods = 2 if multi_pod else 1
    if world % (pods * NODE_GPUS) != 0:
        raise ValueError(
            f"[mesh] a world of {world} GPUs does not fill {pods} pod(s) of "
            f"{NODE_GPUS}-GPU nodes")
    data = world // (pods * NODE_GPUS)
    shape = (pods, data, NODE_GPUS) if multi_pod else (data, NODE_GPUS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """A ``(world // model, model)`` mesh, dims ('data', 'model'), over
    every process of the group (one a GPU; the CPU under gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _world()
    if model < 1 or world % model != 0:
        raise ValueError(f"[mesh] a world of {world} processes does not "
                         f"divide into a model axis of {model}")
    return init_device_mesh(_device_type(), (world // model, model),
                            mesh_dim_names=("data", "model"))
