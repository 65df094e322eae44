"""Device resolution and host <-> tensor conversion shared by the port.

Entry points take an explicit ``device``; ``resolve_device`` turns it into
a ``torch.device`` and raises when a CUDA device is asked for on a machine
without one — nothing carries on quietly on the CPU.

Host arrays are numpy. numpy has no bfloat16 without ``ml_dtypes`` (which
the port must not import), so a bf16 host array is a uint16 buffer of the
bit patterns whose dtype carries ``metadata={"dtype": "bfloat16"}``
(``BF16``). ``dtype_name`` reads that back, so manifests record
``"bfloat16"`` exactly as the JAX package writes it.
"""
from __future__ import annotations

import numpy as np
import torch

BF16 = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})

_TORCH_TO_NP = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device; raises if a CUDA device is requested but absent.
    ``"meta"`` (shapes and dtypes, no memory) is admitted when the caller
    names it, as the dry run does (launch/dryrun.py); nothing falls back
    to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain torch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def dtype_name(x) -> str:
    """numpy-style dtype name of a host array, torch tensor or dtype:
    "float32", "int32", "bfloat16", ..."""
    if isinstance(x, torch.Tensor):
        x = x.dtype
    if isinstance(x, torch.dtype):
        return _TORCH_TO_NP[x]
    if isinstance(x, str) and x == "bfloat16":
        return x
    dt = x.dtype if isinstance(x, (np.ndarray, np.generic)) else np.dtype(x)
    meta = dt.metadata or {}
    return meta.get("dtype", str(dt))


def itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def np_dtype(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


def to_host(t, copy: bool = True) -> np.ndarray:
    """Tensor (any device) or array-like -> numpy host array. A bf16
    tensor lands as a ``BF16`` bit-pattern array. A tensor's array is a
    snapshot: a CPU tensor is copied (``.cpu()`` would alias it, and the
    train step updates its state in place), unless ``copy=False`` says
    the caller owns the tensor."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if copy and t.device.type == "cpu":
        t = t.clone()
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().view(BF16)
    return t.cpu().numpy()


def to_device(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy host array (``BF16`` understood) -> tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        bf16 = dtype_name(a) == "bfloat16"
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.ascontiguousarray(a).copy()
        t = torch.from_numpy(a.view(np.int16) if bf16 else a)
        if bf16:
            t = t.view(torch.bfloat16)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)
