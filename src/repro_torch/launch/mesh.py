"""Meshes. FUNCTIONS, not module-level constants: importing this module
touches no device.

The port's meshes are records (distributed/sharding.Mesh): axis names
over an ndarray of ``torch.device``. The port places a tree on one device,
so a test mesh repeats one device in every position; its sharding rules
and topology record are those of a JAX mesh of the same shape."""
from __future__ import annotations

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
    """Small mesh of ``shape`` whose every position is ``device``."""
    dev = resolve_device(device)
    devices = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(devices.size):
        devices[i] = dev
    return Mesh(devices.reshape(tuple(shape)), axes)
