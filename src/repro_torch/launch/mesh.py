"""Meshes. FUNCTIONS, not module-level constants: importing this module
touches no device.

The port's meshes are records (distributed/sharding.Mesh): axis names
over an ndarray of ``torch.device``. Without a process group a test mesh
repeats one device in every position (a one-device mesh); with a group of
as many ranks as the mesh has positions it spans those ranks, one device
per rank, and trees placed on it are DTensors (distributed/sharding.py).
Either way its sharding rules and topology record are those of a JAX mesh
of the same shape.

``fake_group(n)`` initialises torch's fake process group: this process
is rank 0 of ``n`` and every collective returns at once without moving
data (its outputs hold whatever memory they were given). It runs rank
0's per-device program of a production mesh in one process, on ``meta``
(the dry run) or on one card."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16) single pod (256 devices) or
    (pod=2, data=16, model=16) two pods (512 devices), over the CUDA
    devices this process sees; raises when there are fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {found} CUDA devices")
    devices = np.empty(n, dtype=object)
    for i in range(n):
        devices[i] = torch.device("cuda", i)
    return Mesh(devices.reshape(shape), axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """Mesh of ``shape``. With an initialised process group of as many
    ranks as positions (and more than one), a mesh over those ranks in
    order, each rank's device ``device`` (cuda: the rank's card modulo
    the cards this process sees); otherwise every position is ``device``
    (a one-device mesh). A group of another size raises."""
    from repro_torch.distributed.sharding import group_size
    dev = resolve_device(device)
    n = int(np.prod(shape))
    devices = np.empty(n, dtype=object)
    ranks = None
    world = group_size()
    if world and n > 1:
        if world != n:
            raise ValueError(f"a mesh of shape {tuple(shape)} over a "
                             f"process group of {world} ranks")
        ranks = np.arange(n)
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    for i in range(n):
        devices[i] = torch.device("cuda", i % cards) \
            if ranks is not None and cards else dev
    return Mesh(devices.reshape(tuple(shape)), axes,
                ranks=None if ranks is None else ranks.reshape(tuple(shape)))


def _register_fake_backend() -> None:
    """Register torch's FakeProcessGroup as the c10d backend ``fake``
    (torch knows the name only once a test module registers it)."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup
    if "FAKE" in dist.Backend._plugins:
        return

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(
            common_opts.group_rank, common_opts.group_size, backend_opts)
    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks, this process
    being ``rank``, for the duration of the block; destroyed on exit, so
    the process is left with no group, as it was. Inside an already open
    fake group of the same size and rank it reuses that one; any other
    initialised group raises."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import forget_device_meshes
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size()
                == world_size and dist.get_rank() == rank):
            yield
            return
        raise RuntimeError(
            f"fake_group({world_size}): a process group of "
            f"{dist.get_world_size()} ranks ({dist.get_backend()}) is "
            f"already initialised")
    _register_fake_backend()
    dist.init_process_group("fake", rank=rank, world_size=world_size,
                            store=dist.HashStore())
    try:
        yield
    finally:
        forget_device_meshes()
        dist.destroy_process_group()
