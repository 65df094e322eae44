"""The decoder LM: the JAX package's models/model.py on tensors.

  train   — full forward, chunked-CE loss (never materializes [B,S,V])
  prefill — forward + KV cache construction (serving)
  decode  — one token against the cache (serving)

Layers are stacked per repeating pattern group exactly as in the JAX
package (``params/stack/b0/...`` leaves with a leading ``num_groups``
axis), so the parameter tree — and with it the checkpoint image — is the
same. A Python loop indexes the stacked leaves where JAX scans; autograd
sends each group's gradient back into the stacked leaf. Compute runs in
bf16 on fp32 masters by default, as in the JAX package. Remat is not used
(at the sizes the port runs, activations are small next to the state).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import params as pm
from repro_torch.models.blocks import apply_attn_block, block_specs
from repro_torch.models.layers import embed_lookup, embed_specs, rms_norm, unembed


class LM:
    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        if cfg.tail_layers or cfg.shared_attn_every:
            raise NotImplementedError(
                f"{cfg.name}: tail / shared blocks are not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------------ specs
    def specs(self):
        cfg = self.cfg
        entry = {f"b{j}": block_specs(kind, cfg)
                 for j, kind in enumerate(cfg.pattern)}
        return {
            "embed": embed_specs(cfg),
            "stack": pm.stack_specs(entry, cfg.num_groups),
            "final_norm": pm.scale_ones(cfg.d_model),
        }

    def abstract(self, dtype=torch.float32):
        return pm.abstract(self.specs(), dtype)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        return pm.init(self.specs(), generator, dtype, device)

    def n_params(self) -> int:
        return pm.count(self.specs())

    # ---------------------------------------------------------------- forward
    def forward(self, params, *, tokens, positions=None, mode="train",
                cache=None, compute_dtype=torch.bfloat16):
        """tokens [B,S] -> (hidden [B,S,d] after the final norm, new_cache).
        prefill and decode take a cache (``kvcache.init_cache``) and update
        it in place; its ``pos`` cursor advances by S (prefill) or 1
        (decode). train takes none and returns None for it."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens, cfg, compute_dtype)
        B, S = x.shape[:2]
        # one host read of the cursor per forward: cache writes and the
        # decode mask slice by it
        pos = int(cache["pos"]) if cache is not None else 0
        if positions is None:
            positions = (torch.arange(S, dtype=torch.int32, device=x.device)
                         + pos)[None].expand(B, S)
        stack = params["stack"]
        for g in range(cfg.num_groups):
            gp = pm.tree_map(lambda _, a: a[g], stack)
            for j, win in enumerate(cfg.windows):
                c = None if cache is None else {
                    n: t[g] for n, t in cache["stack"][f"b{j}"].items()}
                x, _ = apply_attn_block(gp[f"b{j}"], x, cfg,
                                        positions=positions, window=win,
                                        mode=mode, cache=c, pos=pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        new_cache = None
        if cache is not None and mode != "train":
            new_cache = {"stack": cache["stack"],
                         "pos": cache["pos"] + (1 if mode == "decode" else S)}
        return x, new_cache

    # ------------------------------------------------------------------- loss
    def loss(self, params, batch, ce_chunk: int = 512):
        """batch: {"tokens": [B,S]}. Returns (loss, metrics)."""
        tokens = batch["tokens"]
        labels = batch.get("labels", tokens)
        x, _ = self.forward(params, tokens=tokens,
                            positions=batch.get("positions"))
        ce = self._chunked_ce(params, x[:, :-1], labels[:, 1:], ce_chunk)
        return ce, {"ce": ce, "loss": ce}

    def _chunked_ce(self, params, x, labels, chunk: int):
        """Streaming CE over seq chunks — never materializes [B, S, V]
        logits for more than one chunk at a time."""
        cfg = self.cfg
        B, T, d = x.shape
        c = min(chunk, T)
        while T % c:
            c -= 1
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(T // c):
            xc = x[:, i * c:(i + 1) * c]
            lc = labels[:, i * c:(i + 1) * c]
            logits = unembed(params["embed"], xc, cfg)       # fp32 [B,c,V]
            lz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
            tot = tot + (lz - gold).sum()
        return tot / (B * T)

    # -------------------------------------------------------------- serving
    def prefill(self, params, *, tokens, positions=None, S_max=None,
                compute_dtype=torch.bfloat16):
        """tokens [B,S] -> (last-position logits [B,V] fp32, cache). The
        cache holds S_max (default S) positions, on the tokens' device."""
        B, S = tokens.shape
        cache = kvcache.init_cache(self.cfg, B, S_max or S,
                                   dtype=compute_dtype, device=tokens.device)
        x, cache = self.forward(params, tokens=tokens, positions=positions,
                                mode="prefill", cache=cache,
                                compute_dtype=compute_dtype)
        logits = unembed(params["embed"], x[:, -1:], self.cfg)[:, 0]
        return logits, cache

    def decode_step(self, params, cache, tokens,
                    compute_dtype=torch.bfloat16):
        """tokens [B,1] -> (logits [B,V] fp32, cache advanced by one)."""
        x, cache = self.forward(params, tokens=tokens, mode="decode",
                                cache=cache, compute_dtype=compute_dtype)
        logits = unembed(params["embed"], x[:, -1:], self.cfg)[:, 0]
        return logits, cache
