"""Recurrent blocks: Mamba2 (SSD, chunked-parallel) and xLSTM (mLSTM matrix
memory, chunked; sLSTM scalar memory, sequential scan) — the JAX package's
models/ssm.py on tensors, op for op.

Each block kind provides: ``*_specs`` (params), ``*_apply`` (the parallel
form), ``*_apply_with_state`` (prefill: the output and the final recurrent
state), ``*_step`` (single-token decode recurrence), ``*_init_state``,
``*_state_axes`` and a sequential ``*_ref`` oracle. Decode state is O(1)
in context length.

What keeps the JAX results:

  * the products JAX asks for with ``preferred_element_type=float32`` take
    their bf16 inputs upcast to fp32 (exact) and return fp32;
  * the stabilisers are JAX's: ``m`` starts at -1e30 (not -inf), masked
    ``seg`` entries are -inf, and ``exp(-m_row)`` may overflow to inf;
  * scans over chunks (and sLSTM's over tokens) are Python loops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import flags
from repro_torch.models import params as pm
from repro_torch.models.layers import rms_norm

_F_BIAS = 4.0  # xLSTM forget-gate bias offset (paper inits in [3, 6])
_M0 = -1e30    # the stabiliser's start (JAX's; not -inf)
_F32 = torch.float32


def _chunks(S: int, Q: int) -> int:
    """The largest divisor of S that is at most Q (1 for a prime S > Q)."""
    Q = min(Q, S)
    while S % Q:
        Q -= 1
    return Q


def _f32(x):
    return x.to(_F32)


# ---------------------------------------------------------------- causal conv
def causal_conv(x, w, b):
    """Depthwise causal conv along seq. x [B,S,C], w [K,C], b [C]; on a
    mesh on each rank's rows and channels (``sharding.local_channels``)."""
    return shd.local_channels(_causal_conv, x, w, b)


def _causal_conv(x, w, b):
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return y + b


def conv_step(tail, x1, w, b):
    """Single-step causal conv. tail [B,K-1,C] (past inputs), x1 [B,C]."""
    window = torch.cat([tail, x1[:, None, :]], dim=1)               # [B,K,C]
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:, :]


def _tail(x, K: int):
    """Last K-1 positions (front-padded for short sequences)."""
    S = x.shape[1]
    if S >= K - 1:
        return x[:, S - (K - 1):, :]
    return F.pad(x, (0, 0, K - 1 - S, 0))


# ======================================================================= SSD
def mamba2_specs(cfg: ModelConfig):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.mamba_heads, cfg.ssm_conv
    return {
        "w_z": pm.dense((d, di), ("embed", "inner")),
        "w_x": pm.dense((d, di), ("embed", "inner")),
        "w_B": pm.dense((d, N), ("embed", "state")),
        "w_C": pm.dense((d, N), ("embed", "state")),
        "w_dt": pm.dense((d, H), ("embed", None)),
        "conv_x": pm.ParamSpec((K, di), ("conv", "inner"), "normal", K ** -0.5),
        "conv_B": pm.ParamSpec((K, N), ("conv", "state"), "normal", K ** -0.5),
        "conv_C": pm.ParamSpec((K, N), ("conv", "state"), "normal", K ** -0.5),
        "b_conv_x": pm.zeros((di,), ("inner",)),
        "b_conv_B": pm.zeros((N,)),
        "b_conv_C": pm.zeros((N,)),
        "A_log": pm.zeros((H,)),          # A = -exp(A_log) = -1 at init
        "D": pm.scale_ones(H),
        "dt_bias": pm.zeros((H,)),
        "gate_norm": pm.scale_ones(di),
        "w_out": pm.dense((di, d), ("inner", "embed")),
    }


def _mamba2_inputs(p, x):
    dt_ = x.dtype
    z = x @ p["w_z"].to(dt_)
    xi = x @ p["w_x"].to(dt_)
    Bi = x @ p["w_B"].to(dt_)
    Ci = x @ p["w_C"].to(dt_)
    dt_raw = _f32(x @ p["w_dt"].to(dt_))
    return z, xi, Bi, Ci, dt_raw


def _gate_out(p, y, z, cfg: ModelConfig):
    g = y * F.silu(z)
    g = rms_norm(g, p["gate_norm"], cfg.norm_eps)
    return g @ p["w_out"].to(g.dtype)


def mamba2_apply(p, x, cfg: ModelConfig, chunk: int = 128,
                 return_state: bool = False):
    """Chunked SSD. x [B,S,d] -> y [B,S,d] (optionally + the final
    recurrent state, matching mamba2_init_state, for prefill -> decode)."""
    B, S, d = x.shape
    H, N = cfg.mamba_heads, cfg.ssm_state
    P = cfg.d_inner // H
    K = cfg.ssm_conv
    dt_ = x.dtype
    z, xi, Bi, Ci, dt_raw = _mamba2_inputs(p, x)
    tails = {"conv_x": _tail(xi, K), "conv_B": _tail(Bi, K),
             "conv_C": _tail(Ci, K)} if return_state else None
    xi = F.silu(causal_conv(xi, p["conv_x"].to(dt_), p["b_conv_x"].to(dt_)))
    Bi = F.silu(causal_conv(Bi, p["conv_B"].to(dt_), p["b_conv_B"].to(dt_)))
    Ci = F.silu(causal_conv(Ci, p["conv_C"].to(dt_), p["b_conv_C"].to(dt_)))
    dt = F.softplus(dt_raw + p["dt_bias"])                     # [B,S,H] fp32
    A = -torch.exp(_f32(p["A_log"]))                           # [H]

    Q = _chunks(S, chunk)
    nc = S // Q
    xh = xi.reshape(B, nc, Q, H, P)
    Bc = _f32(Bi.reshape(B, nc, Q, N))
    Cc = _f32(Ci.reshape(B, nc, Q, N))
    dtc = dt.reshape(B, nc, Q, H)

    a = A * dtc                                                # [B,nc,Q,H] (<0)
    A_cs = torch.cumsum(a, dim=2)                              # inclusive
    A_tot = A_cs[:, :, -1, :]                                  # [B,nc,H]

    # ---- intra-chunk (quadratic within chunk)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)               # [B,nc,Q,Q]
    seg = A_cs[:, :, :, None, :] - A_cs[:, :, None, :, :]      # [B,nc,i,j,H]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(tril[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=_F32, device=x.device))
    L = CB[:, :, :, :, None] * decay * dtc[:, :, None, :, :]   # [B,nc,i,j,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", L.to(dt_), xh)

    # ---- inter-chunk (state carried across chunks)
    w_end = torch.exp(A_tot[:, :, None, :] - A_cs) * dtc       # [B,nc,Q,H]
    S_c = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                       w_end, Bc, _f32(xh))                    # [B,nc,H,P,N]
    h = torch.zeros((B, H, P, N), dtype=_F32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(A_tot[:, c])[:, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # [B,nc,H,P,N]
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_prev) * \
        torch.exp(A_cs)[..., None]
    y = (_f32(y_intra) + y_inter
         + p["D"][None, None, None, :, None] * _f32(xh))
    y = y.reshape(B, S, cfg.d_inner).to(dt_)
    out = _gate_out(p, y, z, cfg)
    if return_state:
        return out, {"h": h, **tails}
    return out


def mamba2_apply_with_state(p, x, cfg: ModelConfig, chunk: int = 128):
    return mamba2_apply(p, x, cfg, chunk, return_state=True)


def mamba2_init_state(cfg: ModelConfig, B: int, dtype=_F32, device="cpu"):
    H, N = cfg.mamba_heads, cfg.ssm_state
    P = cfg.d_inner // H
    K = cfg.ssm_conv
    return {
        "h": torch.zeros((B, H, P, N), dtype=_F32, device=device),
        "conv_x": torch.zeros((B, K - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((B, K - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((B, K - 1, N), dtype=dtype, device=device),
    }


def mamba2_state_axes(cfg: ModelConfig):
    return {
        "h": ("batch", None, None, "state"),
        "conv_x": ("batch", None, "inner"),
        "conv_B": ("batch", None, "state"),
        "conv_C": ("batch", None, "state"),
    }


def mamba2_step(p, x1, state, cfg: ModelConfig):
    """x1 [B,d] -> (y1 [B,d], state)."""
    B = x1.shape[0]
    H, N = cfg.mamba_heads, cfg.ssm_state
    P = cfg.d_inner // H
    x = x1[:, None, :]
    dt_ = x.dtype
    z, xi, Bi, Ci, dt_raw = _mamba2_inputs(p, x)
    xi1, conv_x = conv_step(state["conv_x"], xi[:, 0], p["conv_x"].to(dt_),
                            p["b_conv_x"].to(dt_))
    Bi1, conv_B = conv_step(state["conv_B"], Bi[:, 0], p["conv_B"].to(dt_),
                            p["b_conv_B"].to(dt_))
    Ci1, conv_C = conv_step(state["conv_C"], Ci[:, 0], p["conv_C"].to(dt_),
                            p["b_conv_C"].to(dt_))
    xi1 = _f32(F.silu(xi1).reshape(B, H, P))
    Bi1 = _f32(F.silu(Bi1))
    Ci1 = _f32(F.silu(Ci1))
    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"])               # [B,H]
    A = -torch.exp(_f32(p["A_log"]))
    h = state["h"] * torch.exp(A * dt)[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xi1 * dt[..., None], Bi1)
    y = torch.einsum("bhpn,bn->bhp", h, Ci1) + p["D"][None, :, None] * xi1
    y = y.reshape(B, 1, cfg.d_inner).to(x1.dtype)
    out = _gate_out(p, y, z, cfg)[:, 0]
    return out, {"h": h, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}


def _scan_ref(step_fn, init_state, p, x, cfg):
    state = init_state(cfg, x.shape[0], x.dtype, x.device)
    ys = []
    for t in range(x.shape[1]):
        y, state = step_fn(p, x[:, t], state, cfg)
        ys.append(y)
    return torch.stack(ys, dim=1)


def mamba2_ref(p, x, cfg: ModelConfig):
    """Sequential oracle (token-by-token recurrence)."""
    return _scan_ref(mamba2_step, mamba2_init_state, p, x, cfg)


# ===================================================================== mLSTM
def mlstm_specs(cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    H, K = cfg.num_heads, cfg.ssm_conv
    return {
        "w_xin": pm.dense((d, di), ("embed", "inner")),
        "w_z": pm.dense((d, di), ("embed", "inner")),
        "conv_x": pm.ParamSpec((K, di), ("conv", "inner"), "normal", K ** -0.5),
        "b_conv_x": pm.zeros((di,), ("inner",)),
        "w_q": pm.dense((di, di), (None, "inner")),
        "w_k": pm.dense((di, di), (None, "inner")),
        "w_v": pm.dense((di, di), (None, "inner")),
        "w_i": pm.dense((di, H), (None, None)),
        "w_f": pm.dense((di, H), (None, None)),
        "b_i": pm.zeros((H,)),
        "b_f": pm.zeros((H,)),
        "mh_norm": pm.scale_ones(di),
        "w_down": pm.dense((di, d), ("inner", "embed")),
    }


def _mlstm_qkvgates(p, x, cfg: ModelConfig):
    dt_ = x.dtype
    di, H = cfg.d_inner, cfg.num_heads
    dh = di // H
    xin = x @ p["w_xin"].to(dt_)
    z = x @ p["w_z"].to(dt_)
    xc = F.silu(causal_conv(xin, p["conv_x"].to(dt_), p["b_conv_x"].to(dt_)))
    # q, k, v stay [B, S, d_inner]: their heads are split in the scan
    q = xc @ p["w_q"].to(dt_)
    k = (xc @ p["w_k"].to(dt_)) * (dh ** -0.5)
    v = xin @ p["w_v"].to(dt_)
    logi = _f32(xc @ p["w_i"].to(dt_)) + p["b_i"]
    logf = F.logsigmoid(_f32(xc @ p["w_f"].to(dt_)) + p["b_f"] + _F_BIAS)
    return q, k, v, logi, logf, z, xin


def _mlstm_out(p, h, z, cfg: ModelConfig):
    B, S = h.shape[0], h.shape[1]
    h = h.reshape(B, S, cfg.d_inner)
    h = rms_norm(h, p["mh_norm"], cfg.norm_eps)
    h = h * F.silu(z)
    return h @ p["w_down"].to(h.dtype)


def mlstm_apply(p, x, cfg: ModelConfig, chunk: int = 128,
                return_state: bool = False):
    """Chunked-parallel mLSTM. x [B,S,d] -> [B,S,d]. On a mesh the
    chunked scan runs on each rank's rows with its heads whole
    (``sharding.local_rows``)."""
    q, k, v, logi, logf, z, xin_raw = _mlstm_qkvgates(p, x, cfg)
    h, C, n, m = shd.local_rows(
        lambda *a: _mlstm_scan(*a, cfg.num_heads, chunk),
        (q, k, v, logi, logf))
    out = _mlstm_out(p, h, z, cfg)
    if return_state:
        return out, {"C": C, "n": n, "m": m,
                     "conv_x": _tail(xin_raw, cfg.ssm_conv)}
    return out


def _mlstm_scan(q, k, v, logi, logf, H: int, chunk: int):
    """The chunked scan on plain tensors: q, k, v [B,S,di], the gates
    [B,S,H] -> (h [B,S,di] in q's dtype, the final C, n, m)."""
    B, S, di = q.shape
    dh = di // H
    dev = q.device
    Q = _chunks(S, chunk)
    nc = S // Q
    qc = q.reshape(B, nc, Q, H, dh)
    kc = k.reshape(B, nc, Q, H, dh)
    vc = v.reshape(B, nc, Q, H, dh)
    li = logi.reshape(B, nc, Q, H)
    lf = logf.reshape(B, nc, Q, H)
    F_cs = torch.cumsum(lf, dim=2)                             # inclusive
    F_tot = F_cs[:, :, -1, :]

    # decay from step j (incl. its input gate) to row i, within chunk
    seg = F_cs[:, :, :, None, :] - F_cs[:, :, None, :, :] + \
        li[:, :, None, :, :]                                   # [B,nc,i,j,H]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dev))[None, None, :, :, None]
    seg = torch.where(tril, seg, torch.full((), -torch.inf, dtype=_F32,
                                            device=dev))
    # to-chunk-end decays (for state update)
    dend = F_tot[:, :, None, :] - F_cs + li                    # [B,nc,j,H]

    C = torch.zeros((B, H, dh, dh), dtype=_F32, device=dev)
    n = torch.zeros((B, H, dh), dtype=_F32, device=dev)
    m = torch.full((B, H), _M0, dtype=_F32, device=dev)
    hs = []
    for c in range(nc):
        qx, kx, vx = qc[:, c], kc[:, c], vc[:, c]
        segx, dendx, fcs, ftot = seg[:, c], dend[:, c], F_cs[:, c], F_tot[:, c]
        m_intra = segx.amax(dim=2)                             # [B,i,H]
        m_row = torch.maximum(fcs + m[:, None, :], m_intra)    # [B,i,H]
        w_intra = torch.exp(segx - m_row[:, :, None, :])       # [B,i,j,H]
        w_inter = torch.exp(fcs + m[:, None, :] - m_row)       # [B,i,H]
        qkt = torch.einsum("bihd,bjhd->bijh", _f32(qx), _f32(kx))
        wq = qkt * w_intra
        num = torch.einsum("bijh,bjhd->bihd", _f32(wq.to(vx.dtype)), _f32(vx))
        num = num + w_inter[..., None] * torch.einsum(
            "bihd,bhde->bihe", _f32(qx), C)
        den = wq.sum(dim=2) + w_inter * torch.einsum(
            "bihd,bhd->bih", _f32(qx), n)
        hs.append(num / torch.maximum(
            torch.abs(den), torch.exp(-m_row))[..., None])     # [B,i,H,dh]
        # ---- state update to chunk end
        m_end = torch.maximum(ftot + m, dendx.amax(dim=1))     # [B,H]
        w_c = torch.exp(dendx - m_end[:, None, :])             # [B,j,H]
        scale = torch.exp(ftot + m - m_end)                    # [B,H]
        kw = _f32(kx) * w_c[..., None]
        C = scale[..., None, None] * C + torch.einsum(
            "bjhd,bjhe->bhde", kw, _f32(vx))
        n = scale[..., None] * n + kw.sum(dim=1)
        m = m_end
    h = torch.stack(hs, dim=1).reshape(B, S, di).to(q.dtype)
    return h, C, n, m


def mlstm_apply_with_state(p, x, cfg: ModelConfig, chunk: int = 128):
    return mlstm_apply(p, x, cfg, chunk, return_state=True)


def mlstm_init_state(cfg: ModelConfig, B: int, dtype=_F32, device="cpu"):
    H = cfg.num_heads
    dh = cfg.d_inner // H
    K = cfg.ssm_conv
    return {
        "C": torch.zeros((B, H, dh, dh), dtype=_F32, device=device),
        "n": torch.zeros((B, H, dh), dtype=_F32, device=device),
        "m": torch.full((B, H), _M0, dtype=_F32, device=device),
        "conv_x": torch.zeros((B, K - 1, cfg.d_inner), dtype=dtype,
                              device=device),
    }


def mlstm_state_axes(cfg: ModelConfig):
    return {"C": ("batch", None, None, None), "n": ("batch", None, None),
            "m": ("batch", None), "conv_x": ("batch", None, "inner")}


def mlstm_step(p, x1, state, cfg: ModelConfig):
    """x1 [B,d] -> (y1 [B,d], state)."""
    H = cfg.num_heads
    dh = cfg.d_inner // H
    dt_ = x1.dtype
    xin = x1 @ p["w_xin"].to(dt_)
    z = x1 @ p["w_z"].to(dt_)
    xc1, conv_x = conv_step(state["conv_x"], xin, p["conv_x"].to(dt_),
                            p["b_conv_x"].to(dt_))
    xc1 = F.silu(xc1)
    q = _f32(xc1 @ p["w_q"].to(dt_))
    k = _f32((xc1 @ p["w_k"].to(dt_)) * (dh ** -0.5))
    v = _f32(xin @ p["w_v"].to(dt_))
    logi = _f32(xc1 @ p["w_i"].to(dt_)) + p["b_i"]
    logf = F.logsigmoid(_f32(xc1 @ p["w_f"].to(dt_)) + p["b_f"] + _F_BIAS)
    h, C, n, m = shd.local_rows(
        lambda *a: _mlstm_cell(*a, H, dt_),
        (q, k, v, logi, logf, state["C"], state["n"], state["m"]))
    out = _mlstm_out(p, h, z[:, None], cfg)[:, 0]
    return out, {"C": C, "n": n, "m": m, "conv_x": conv_x}


def _mlstm_cell(q, k, v, logi, logf, C, n, m, H: int, dt_):
    """One decode step's recurrence on plain tensors: q, k, v [B,di] fp32,
    the gates [B,H], the state -> (h [B,1,di] in ``dt_``, C, n, m)."""
    B, di = q.shape
    dh = di // H
    q, k, v = (t.reshape(B, H, dh) for t in (q, k, v))
    m_new = torch.maximum(logf + m, logi)                      # [B,H]
    wf = torch.exp(logf + m - m_new)
    wi = torch.exp(logi - m_new)
    C = wf[..., None, None] * C + wi[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = wf[..., None] * n + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    h = h[:, None].reshape(B, 1, di).to(dt_)
    return h, C, n, m_new


def mlstm_ref(p, x, cfg: ModelConfig):
    return _scan_ref(mlstm_step, mlstm_init_state, p, x, cfg)


# ===================================================================== sLSTM
def slstm_specs(cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    H = cfg.num_heads
    dh = di // H
    t = {"mh_norm": pm.scale_ones(di),
         "w_down": pm.dense((di, d), ("inner", "embed"))}
    for g in ("z", "i", "f", "o"):
        t[f"w_{g}"] = pm.dense((d, di), ("embed", "inner"))
        t[f"r_{g}"] = pm.ParamSpec((H, dh, dh), (None, None, None),
                                   "normal", dh ** -0.5)
        t[f"b_{g}"] = pm.zeros((di,), ("inner",))
    return t


def slstm_init_state(cfg: ModelConfig, B: int, dtype=_F32, device="cpu"):
    """All four cell states are fp32 whatever ``dtype`` (as in JAX)."""
    di = cfg.d_inner
    return {
        "c": torch.zeros((B, di), dtype=_F32, device=device),
        "n": torch.zeros((B, di), dtype=_F32, device=device),
        "m": torch.full((B, di), _M0, dtype=_F32, device=device),
        "h": torch.zeros((B, di), dtype=_F32, device=device),
    }


def slstm_state_axes(cfg: ModelConfig):
    return {k: ("batch", "inner") for k in ("c", "n", "m", "h")}


_GATES = ("z", "i", "f", "o")
_STATE = ("c", "n", "m", "h")


def _slstm_cell(p, gates_x, state, cfg: ModelConfig):
    """gates_x: precomputed input contributions [B, 4, di] (z,i,f,o). On
    a mesh the cell runs on each rank's rows with its heads whole
    (``sharding.local_rows``)."""
    def cell(gx, *a):
        new = _slstm_step(dict(zip(_GATES, a[4:])), gx,
                          dict(zip(_STATE, a[:4])), cfg.num_heads)
        return tuple(new[k] for k in _STATE)
    return dict(zip(_STATE, shd.local_rows(
        cell, (gates_x, *(state[k] for k in _STATE)),
        tuple(p[f"r_{g}"] for g in _GATES))))


def _slstm_steps(gx, state, r, H: int, steps: int):
    """``steps`` cell steps on plain tensors from ``state`` over gx
    [B,S,4,di] -> (h [B,steps,di] fp32, the final c, n, m, h)."""
    hs = []
    for t in range(steps):
        state = _slstm_step(r, gx[:, t], state, H)
        hs.append(state["h"])
    return (torch.stack(hs, dim=1), *(state[k] for k in _STATE))


def _slstm_step(r, gates_x, state, H: int):
    """One cell step on plain tensors; ``r`` {gate: [H, dh, dh]}."""
    B, _, di = gates_x.shape
    dh = di // H
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hh = h.reshape(B, H, dh)

    def rec(g):
        return torch.einsum("bhd,hde->bhe", hh, _f32(r[g])).reshape(B, -1)

    zt = torch.tanh(gates_x[:, 0] + rec("z"))
    it = gates_x[:, 1] + rec("i")
    ft = gates_x[:, 2] + rec("f") + _F_BIAS
    ot = torch.sigmoid(gates_x[:, 3] + rec("o"))
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    wi = torch.exp(it - m_new)
    wf = torch.exp(logf + m - m_new)
    c = wf * c + wi * zt
    n = wf * n + wi
    h_new = ot * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h_new}


def _slstm_gates_x(p, x):
    dt_ = x.dtype
    gx = torch.stack([(x @ p[f"w_{g}"].to(dt_)) + p[f"b_{g}"].to(dt_)
                      for g in ("z", "i", "f", "o")], dim=-2)
    return _f32(gx)                                            # [B,S,4,di]


def slstm_apply(p, x, cfg: ModelConfig, chunk: int = 0,
                return_state: bool = False):
    """Sequential scan over time (sLSTM is inherently recurrent): a Python
    loop of S cell steps, on a mesh on each rank's rows with its heads
    whole (``sharding.local_rows``). On the meta device under
    ``flags.slstm_one_step`` the loop traces one step, repeated S times
    (the dry run's FLOP count, models/flags.py)."""
    B, S = x.shape[:2]
    gx = _slstm_gates_x(p, x)
    steps = 1 if flags.SLSTM_ONE_STEP and x.device.type == "meta" else S

    def scan(gx, *r):
        init = slstm_init_state(cfg, gx.shape[0], x.dtype, gx.device)
        return _slstm_steps(gx, init, dict(zip(_GATES, r)), cfg.num_heads,
                            steps)
    h, *last = shd.local_rows(scan, (gx,), tuple(p[f"r_{g}"]
                                                 for g in _GATES))
    state = dict(zip(_STATE, last))
    h = h.to(x.dtype)                                          # [B,S,di]
    if steps != S:
        h = h.expand(B, S, h.shape[-1])
    h = rms_norm(h, p["mh_norm"], cfg.norm_eps)
    out = h @ p["w_down"].to(x.dtype)
    if return_state:
        return out, state
    return out


def slstm_apply_with_state(p, x, cfg: ModelConfig):
    return slstm_apply(p, x, cfg, return_state=True)


def slstm_step(p, x1, state, cfg: ModelConfig):
    gx = _slstm_gates_x(p, x1[:, None, :])[:, 0]
    state = _slstm_cell(p, gx, state, cfg)
    h = state["h"][:, None].to(x1.dtype)
    h = rms_norm(h, p["mh_norm"], cfg.norm_eps)
    return (h @ p["w_down"].to(x1.dtype))[:, 0], state


slstm_ref = slstm_apply  # the scan IS the sequential definition
