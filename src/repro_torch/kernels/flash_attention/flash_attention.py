"""K6: flash-attention forward on Hopper, bound with ctypes.

``flash_attention_fwd`` takes CUDA tensors to the hand-written kernels in
``csrc/flash_attention.cu`` (built for ``sm_90a`` by ``nvcc`` at first use
into ``<repo>/build/flash_attention/``; see ``kernels/_build.py``) and CPU
tensors to the plain torch version in ``ref.py``. A CUDA tensor never
reaches the plain version: the wrapper launches a kernel or raises.

  kernel               replaces
  K6 flash_attention   src/repro/kernels/flash_attention/flash_attention.py
                       flash_attention_fwd (_kernel)

Two routes, chosen by ``route(dtype, head_dim)`` alone, never by a retry:
``"wgmma"`` (bf16 at head dims 64 and 128: tensor cores, TMA-staged K/V
tiles) and ``"simt"`` (fp32 at every head dim, whose 2e-6 tolerance rules
out tensor cores, and bf16 at head dims 16 and 32: fp32 FMAs on the CUDA
cores). Unlike the Pallas kernel both take any Sq <= Skv (the ragged last
tiles are masked by position). See the .cu file for the designs.

``LAUNCHES["flash_attention"]`` counts kernel launches of either route and
``ROUTE_LAUNCHES`` each route's (plain-version calls are not counted), so a
run can show that its path went through the kernel and which one.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import Library, stream_of
from repro_torch.kernels.flash_attention import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = Library(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"flash_attention_fwd_simt": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _P],
     "flash_attention_fwd_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _F, _P]},
    error_fn="flash_error_string")

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
LAUNCHES = {"flash_attention": 0}
ROUTE_LAUNCHES = {"wgmma": 0, "simt": 0}
_lock = threading.Lock()


def reset_launches():
    with _lock:
        LAUNCHES["flash_attention"] = 0
        for r in ROUTE_LAUNCHES:
            ROUTE_LAUNCHES[r] = 0


def route(dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 at head dims 64
    and 128, ``"simt"`` otherwise."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _check(q, k, v):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: float32 or bfloat16, got {q.dtype}")
    if k.ndim != 4 or tuple(k.shape) != (B, Skv, KV, hd) \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k, v must be [B, Skv, KV, hd] "
                         f"with q {tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hd not in HEAD_DIMS or H % KV or Sq > Skv or Sq == 0 \
            or B * H >= 65536:
        raise ValueError(f"flash_attention: unsupported shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} (head_dim in "
                         f"{HEAD_DIMS}, KV divides H, 0 < Sq <= Skv)")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q [B,Sq,H,hd]; k,v [B,Skv,KV,hd] (KV divides H). q occupies the last
    Sq slots of the kv stream (q_off = Skv - Sq). Returns [B,Sq,H,hd] in
    q's dtype."""
    if q.device.type == "cpu":
        return ref.reference_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be [B, Sq, H, hd], got "
                         f"{tuple(q.shape)}")
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    way = route(q.dtype, hd)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        if way == "wgmma":
            LIB.call("flash_attention_fwd_wgmma", *ptrs, out.data_ptr(), B,
                     Sq, Skv, H, KV, hd, int(bool(causal)), int(window),
                     float(softcap), hd ** -0.5, stream_of(q))
        else:
            LIB.call("flash_attention_fwd_simt", *ptrs, out.data_ptr(), B,
                     Sq, Skv, H, KV, hd, int(q.dtype == torch.bfloat16),
                     int(bool(causal)), int(window), float(softcap),
                     hd ** -0.5, stream_of(q))
    with _lock:
        LAUNCHES["flash_attention"] += 1
        ROUTE_LAUNCHES[way] += 1
    return out
