"""The devices a job runs over, in order.

Port of ``vbt_tpu.parallel.mesh.make_mesh`` for one process over the local
devices: where the JAX package builds a ``('data', 'model')`` mesh and lets
GSPMD place arrays on it, the port keeps an ordered list of
``torch.device`` and places each piece of work on its device itself
(``runtime.batch_runner.shard_clips``, ``parallel.time_shard``). The
model axis was 1 in every JAX configuration, so the list is the data axis.

``batch_sharding`` and ``replicated`` are JAX placement objects with no
user outside the JAX package's own ``parallel/__init__.py``; they have no
counterpart here.
"""

from __future__ import annotations

import torch


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The devices to shard over: ``devices`` as given (the CPU lane passes
    e.g. ``[torch.device("cpu")] * 8``), else every CUDA card, the first
    ``n_devices`` of them if given. Raises if there is no card and no
    devices were given."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA card; pass devices explicitly for the CPU lane")
        devices = [torch.device("cuda", i) for i in range(count)]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("want at least one device")
    return devices
