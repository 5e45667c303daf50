"""Elastic restart: resume training on the devices that are left.

Counterpart of ``src/repro/ft/elastic.py`` (``rescale_plan`` :33,
``rescale_data_config`` :52, ``restore_state`` :57). After a loss or grow
event the launcher re-execs with the surviving device set;
``rescale_plan`` checks the ``(data, model)`` shape of that set and the
host slice, the data pipeline replays the exact global stream (a batch is
a pure function of its step), and ``restore_state`` loads the latest
checkpoint into the live state. Checkpoints hold full, unsharded leaves,
so any device count can restore them.

One process drives one device. With a process group up, the device set
is the world's (one device a rank), the plan carries a ``("data",
"model")`` ``DeviceMesh`` over it (``launch.mesh.make_host_mesh``) and
``restore_state`` places each full leaf by ``sharding.make_param_specs``
/ ``make_opt_specs`` on it; without one, the plan's first device holds
the whole state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import sharding
from repro_torch.train import train_step


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    devices: tuple
    shape: tuple[int, int]          # (data, model)
    host_index: int
    host_count: int
    mesh: object = None             # DeviceMesh with a process group up


def rescale_plan(*, devices=None, model_axis: int = 1,
                 host_index: int = 0, host_count: int = 1) -> RescalePlan:
    """``devices``: the surviving devices (every CUDA device when None);
    with a process group up, one device a rank of the world, in rank
    order."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    # ValueError, not assert: this runs in the relaunch path after a loss,
    # exactly where `python -O` would have stripped an assert.
    if n == 0:
        raise ValueError(
            "[rescale-mesh] no surviving devices: a mesh needs at least "
            "one (pass the device set, or run where a card is present)")
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(
            f"[rescale-mesh] {n} surviving devices not divisible by "
            f"model_axis={model_axis}; pick a model axis that divides the "
            "device count (or shrink it before re-exec)")
    if host_count < 1 or not 0 <= host_index < host_count:
        raise ValueError(
            f"[rescale-hosts] host_index={host_index} outside "
            f"[0, host_count={host_count})")
    mesh = None
    if dist.is_initialized():
        if n != dist.get_world_size():
            raise ValueError(
                f"[rescale-mesh] {n} devices for a world of "
                f"{dist.get_world_size()} processes: one process drives "
                "one device")
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=model_axis)
    return RescalePlan(devices=tuple(devices),
                       shape=(n // model_axis, model_axis),
                       host_index=host_index, host_count=host_count,
                       mesh=mesh)


def rescale_data_config(dcfg: DataConfig, plan: RescalePlan) -> DataConfig:
    return dataclasses.replace(dcfg, host_index=plan.host_index,
                               host_count=plan.host_count)


def state_specs(cfg, plan: RescalePlan, params) -> dict:
    """The train state's specs on the plan's mesh: the parameters'
    (``make_param_specs``) and the moments' (``make_opt_specs``), as the
    reference's ``restore_state`` builds them."""
    p_specs = sharding.make_param_specs(cfg, params, plan.mesh)
    return {"params": p_specs, "opt": sharding.make_opt_specs(p_specs)}


def restore_state(ckpt, cfg, plan: RescalePlan, state):
    """Load the latest checkpoint into the live ``state``. Returns
    ``(state, step)``. On a plan with a mesh the live parameters and
    moments must lie where ``state_specs`` places them, and each full
    leaf restored is cut to this rank's shard of that placement;
    otherwise the state lives on the plan's first device (one
    process)."""
    if plan.mesh is None:
        dev = torch.device(plan.devices[0])
        held = {p.device for p in state["params"].parameters()}
        if held != {dev}:
            raise ValueError(f"[rescale-device] the state lives on "
                             f"{sorted(map(str, held))}, the plan's device "
                             f"is {dev}")
    else:
        specs = state_specs(cfg, plan, state["params"])
        moments = specs["opt"]["moments"]
        live = [(n, p, specs["params"][n])
                for n, p in state["params"].named_parameters()]
        live += [(f"{n}.{f}", t, moments[n][f])
                 for n, mv in state["opt"]["moments"].items()
                 for f, t in mv.items()]
        for name, t, spec in live:
            places = sharding.placements(plan.mesh, spec)
            got = list(getattr(t, "placements", ()))
            if got != places:
                raise ValueError(
                    f"[rescale-placement] {name} lies in {got}, the plan's "
                    f"specs place it in {places}")
    tree, step = ckpt.restore()
    return train_step.restore_snapshot(tree, state), step
