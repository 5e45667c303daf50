"""Elastic restart: resume training on the devices that are left.

The one-process part of ``src/repro/ft/elastic.py`` (``rescale_plan``
:33, ``rescale_data_config`` :52, ``restore_state`` :57). After a loss or
grow event the launcher re-execs with the surviving device set;
``rescale_plan`` checks the ``(data, model)`` shape of that set and the
host slice, the data pipeline replays the exact global stream (a batch is
a pure function of its step), and ``restore_state`` loads the latest
checkpoint into the live state. Checkpoints hold full, unsharded leaves,
so any device count can restore them. The plan holds the device list and
its shape; a ``DeviceMesh`` over it comes with the multi-process
executors.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.pipeline import DataConfig
from repro_torch.train import train_step


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    devices: tuple
    shape: tuple[int, int]          # (data, model)
    host_index: int
    host_count: int


def rescale_plan(*, devices=None, model_axis: int = 1,
                 host_index: int = 0, host_count: int = 1) -> RescalePlan:
    """``devices``: the surviving devices (every CUDA device when None)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    # ValueError, not assert: this runs in the relaunch path after a loss,
    # exactly where `python -O` would have stripped an assert.
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(
            f"[rescale-mesh] {n} surviving devices not divisible by "
            f"model_axis={model_axis}; pick a model axis that divides the "
            "device count (or shrink it before re-exec)")
    if host_count < 1 or not 0 <= host_index < host_count:
        raise ValueError(
            f"[rescale-hosts] host_index={host_index} outside "
            f"[0, host_count={host_count})")
    return RescalePlan(devices=tuple(devices),
                       shape=(n // model_axis, model_axis),
                       host_index=host_index, host_count=host_count)


def rescale_data_config(dcfg: DataConfig, plan: RescalePlan) -> DataConfig:
    return dataclasses.replace(dcfg, host_index=plan.host_index,
                               host_count=plan.host_count)


def restore_state(ckpt, cfg, plan: RescalePlan, state):
    """Load the latest checkpoint into the live ``state``, which lives on
    the plan's first device (one process). Returns ``(state, step)``."""
    del cfg      # the full leaves need no per-config re-sharding yet
    dev = torch.device(plan.devices[0])
    held = {p.device for p in state["params"].parameters()}
    if held != {dev}:
        raise ValueError(f"[rescale-device] the state lives on "
                         f"{sorted(map(str, held))}, the plan's device is "
                         f"{dev}")
    tree, step = ckpt.restore()
    return train_step.restore_snapshot(tree, state), step
