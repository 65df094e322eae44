"""Device-side checkpoint codec: fused encode+digest on the card,
double-buffered against host-side chunk writes.

The host dump hot path pays three passes per leaf (codec encode, serialize,
digest) before a byte reaches storage. This stage moves the first and last
onto the device with the fused kernels behind kernels/ckpt_codec/ops.py and
overlaps the device->host transfer with the executor's chunk writes:

    device encode leaf i+1   ||   device->host land leaf i   ||   chunk
                                                                  writes i-1

``encode_leaves`` launches the fused encode for up to ``depth`` leaves
before blocking on the oldest transfer (a bounded deque — the double
buffer). Each launch is followed by non-blocking copies into pinned host
buffers and a CUDA event; landing a leaf waits on its event and resolves a
per-leaf Future the executor's ``do_leaf`` consumes in place of the host
codec. On a serial engine the pump runs inline before the dump.

Unlike the JAX package, a failed launch or transfer fails the dump: there
is no per-leaf host fallback, so a broken kernel cannot hide behind the
host codec. The error reaches the executor through the leaf's Future.

Bit-identity contract: the stored buffer a landed Future carries is byte
for byte what ``core.compression.encode_leaf`` would have produced; the
only difference is codec_meta: device-encoded leaves additionally carry
the fused payload digest ("pmac32x2-v1"), which decode_leaf re-verifies.
"""
from __future__ import annotations

import contextlib
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core.compression import CODEC_BLOCK
from repro_torch.device import BF16, resolve_device, to_device
from repro_torch.kernels.ckpt_codec import ops

DEVICE_CODEC_MODES = ("off", "auto", "on")
# below this a leaf's dispatch overhead beats the fused win; encode on host
DEVICE_MIN_BYTES = 1 << 16
DEPTH = 2            # double buffer: encodes in flight before landing


def resolve_mode(mode, device="cuda") -> bool:
    """CodecPolicy.device -> use the device stage? "auto" turns on when the
    entry point's device is CUDA; "on" forces the fused path (the plain
    torch versions when the device is the CPU — the test configuration)."""
    if mode in (None, False, "off"):
        return False
    if mode in (True, "on"):
        return True
    if mode == "auto":
        return torch.device(device).type == "cuda"
    raise ValueError(f"unknown device codec mode {mode!r}; "
                     f"choose from {DEVICE_CODEC_MODES}")


def eligible(lp) -> bool:
    """Which planned leaves the device stage takes: codec actually applied
    (delta8 with a baseline, or bf16 — both imply fp32 at plan time), not
    a pre-dump record re-emission, and big enough to beat dispatch cost."""
    return (lp.reuse is None
            and (lp.codec == "bf16"
                 or (lp.codec == "delta8" and lp.use_prev))
            and lp.nbytes >= DEVICE_MIN_BYTES)


def _landing(shape, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


def _dispatch(lp, x: torch.Tensor, prev: np.ndarray | None, device):
    """Launch one leaf's fused encode and its copies to the host. Returns
    (host buffers, event); the buffers are valid once the event is done."""
    cuda = device.type == "cuda"
    if lp.codec == "delta8":
        pflat = to_device(prev, device, torch.float32).reshape(-1)
        q, s, d, h1, h2 = ops.delta_encode_digest(x, pflat, block=CODEC_BLOCK)
        nblk = q.shape[0]
        # the stored layout (scale bytes, then q) lands in one buffer
        stored = _landing((nblk * 4 + q.numel(),), torch.int8, cuda)
        stored[:nblk * 4].view(torch.float32).copy_(s, non_blocking=cuda)
        stored[nblk * 4:].view(q.shape).copy_(q, non_blocking=cuda)
        rest = [d, h1, h2]
    else:
        y, h1, h2 = ops.bf16_encode_digest(x, block=CODEC_BLOCK)
        stored = _landing(y.shape, torch.int16, cuda)
        stored.copy_(y.view(torch.int16), non_blocking=cuda)
        rest = [h1, h2]
    host = [stored]
    for t in rest:
        h = _landing(t.shape, t.dtype, cuda)
        h.copy_(t, non_blocking=cuda)
        host.append(h)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return host, event


def _land(lp, host, event):
    """Wait for one leaf's transfer and assemble the stored buffer +
    codec_meta, byte-identical to the host encode_leaf layouts."""
    if event is not None:
        event.synchronize()
    n = int(np.prod(lp.shape, dtype=np.int64))
    if lp.codec == "delta8":
        stored, d, h1, h2 = (t.numpy() for t in host)
        nblk = d.shape[0]
        s = stored[:nblk * 4].view(np.float32)
        meta = {"applied": True, "orig_dtype": "float32",
                "orig_shape": list(lp.shape),
                "block": CODEC_BLOCK, "nblk": int(nblk),
                "dirty_blocks": int(d.sum()),
                "digest": ops.fold_digest(h1, h2, scale_bits=s, n=n),
                "digest_alg": ops.DIGEST_ALG, "encoder": "device"}
        return stored, meta
    y, h1, h2 = (t.numpy() for t in host)
    stored = y.view(BF16).reshape(-1)[:n].reshape(lp.shape)
    meta = {"applied": True, "orig_dtype": "float32",
            "digest": ops.fold_digest(h1, h2, n=n),
            "digest_alg": ops.DIGEST_ALG, "encoder": "device"}
    return stored, meta


def encode_leaves(plan, source: dict, prev_host_tree: dict | None = None,
                  executor=None, *, depth: int = DEPTH,
                  device="cuda") -> dict:
    """Start the device encode stage for a DumpPlan.

    source: {path: tensor or array} — device-resident tensors when the
    caller has them (dump passes the live tree, so the kernels read device
    memory directly), host arrays otherwise (the stage uploads). Returns
    {path: Future -> (stored np.ndarray, codec_meta)} covering the eligible
    leaves; the executor's do_leaf falls through to the host codec for
    every other path. A failure sets that leaf's Future's exception (the
    dump fails) and stops the stage."""
    dev = resolve_device(device)
    prev_host_tree = prev_host_tree or {}
    todo = [lp for lp in plan.leaves
            if eligible(lp) and lp.path in source
            and (lp.codec != "delta8" or lp.path in prev_host_tree)]
    if not todo:
        return {}
    futs = {lp.path: Future() for lp in todo}

    def dispatch(lp):
        x = to_device(source[lp.path], dev, torch.float32).reshape(-1)
        prev = prev_host_tree.get(lp.path) if lp.codec == "delta8" else None
        return _dispatch(lp, x, prev, dev)

    def pump():
        pending = deque()
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                for lp in todo:
                    pending.append((lp, dispatch(lp)))
                    while len(pending) >= depth:
                        lp0, (host, ev) = pending.popleft()
                        futs[lp0.path].set_result(_land(lp0, host, ev))
                while pending:
                    lp0, (host, ev) = pending.popleft()
                    futs[lp0.path].set_result(_land(lp0, host, ev))
        except BaseException as e:
            for f in futs.values():
                if not f.done():
                    f.set_exception(e)
            if not isinstance(e, Exception):
                raise

    started = executor.submit_cpu(pump) if executor is not None else None
    if started is None:
        pump()    # serial engine / no executor: inline, no overlap
    return futs
