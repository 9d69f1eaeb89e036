"""Causal language model (GPT-style) with KV-cache generation.

Counterpart of ``deeplearning4j_tpu/models/gpt.py``: a pre-LN
transformer decoder with learned positions and a tied embedding LM
head. Parameters are a plain nested dict in the JAX package's layout
(``tok_emb``, ``pos_emb``, ``ln_f`` and a ``layers`` list), matmul
weights stored ``[in, out]`` and applied as ``x @ W``, so a tree from
the JAX ``CausalLM.init_params()`` carries over without a transpose
(:func:`params_from_jax`). Master parameters are f32; every function
casts them to the compute dtype where it uses them.

Numerics that follow the JAX model rather than PyTorch's habits:

- the GELU is the tanh approximation (``jax.nn.gelu``'s default);
- layer norm uses eps 1e-5 and the biased variance, whatever
  ``cfg.eps`` says (gpt.py:79-83);
- the attention mask value is ``finfo(compute dtype).min`` and the
  scale ``1 / sqrt(head_dim)`` is rounded to the compute dtype;
- the tied head runs in the compute dtype and is cast to f32 after;
- greedy ties go to the first index (``argmax``).

Generation runs eagerly: one batched prefill forward writes the prompt's
K/V into a dense ``[L, N, H, max_len, hd]`` cache, then one
:meth:`CausalLM._decode_one` call per new token updates it in place.
Sampling draws Gumbel noise from a ``torch.Generator``; it follows the
same distribution as the JAX model's ``jax.random.categorical`` but not
the same draws.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.params import (  # noqa: F401 (re-exported)
    _leaves, params_from_jax, params_to_numpy, tree_map)

#: layer-norm epsilon of the JAX model, independent of ``cfg.eps``
LN_EPS = 1e-5


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise: ``argmax(logits / T + noise)`` draws from
    ``softmax(logits / T)``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class CausalLM:
    def __init__(self, config: TransformerConfig,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.cfg = config
        self.compute_dtype = compute_dtype

    # -- shared pieces --------------------------------------------------
    @staticmethod
    def _ln(x, p):
        m = x.mean(dim=-1, keepdim=True)
        v = x.var(dim=-1, correction=0, keepdim=True)
        return ((x - m) * torch.rsqrt(v + LN_EPS) * p["g"].to(x.dtype)
                + p["b"].to(x.dtype))

    def _scale(self, device) -> torch.Tensor:
        hd = torch.tensor(self.cfg.head_dim, dtype=self.compute_dtype,
                          device=device)
        return 1.0 / torch.sqrt(hd)

    def _heads(self, y, n, t):
        cfg = self.cfg
        return y.reshape(n, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    def mlp(self, x, lp):
        """The residual MLP branch ``gelu(ln2(x) @ w1 + b1) @ w2``
        (without ``b2``, which callers add in the JAX association)."""
        cd = self.compute_dtype
        h = self._ln(x, lp["ln2"])
        return F.gelu(h @ lp["w1"].to(cd) + lp["b1"].to(cd),
                      approximate="tanh") @ lp["w2"].to(cd)

    # -- forward --------------------------------------------------------
    def forward(self, params, ids, return_kv: bool = False):
        """ids ``[N, T]`` -> logits ``[N, T, V]`` (causal, compute dtype).
        With ``return_kv``, also the per-layer K/V stacks
        ``[L, N, H, T, hd]`` (the parallel prefill of generate())."""
        cfg = self.cfg
        cd = self.compute_dtype
        ids = ids.long()
        n, t = ids.shape
        dev = ids.device
        x = params["tok_emb"].to(cd)[ids] + params["pos_emb"].to(cd)[None, :t]
        causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        scale = self._scale(dev)
        neg = torch.finfo(cd).min
        all_k, all_v = [], []
        for lp in params["layers"]:
            h = self._ln(x, lp["ln1"])
            qkv = h @ lp["wqkv"].to(cd) + lp["bqkv"].to(cd)
            q, kk, v = (self._heads(y, n, t)
                        for y in qkv.split(cfg.d_model, dim=-1))
            if return_kv:
                all_k.append(kk)
                all_v.append(v)
            logits = torch.einsum("nhqd,nhkd->nhqk", q, kk) * scale
            logits = logits.masked_fill(~causal, neg)
            w = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("nhqk,nhkd->nhqd", w, v)
            ctx = ctx.transpose(1, 2).reshape(n, t, cfg.d_model)
            x = x + (ctx @ lp["wo"].to(cd) + lp["bo"].to(cd))
            x = x + (self.mlp(x, lp) + lp["b2"].to(cd))
        x = self._ln(x, params["ln_f"])
        logits = x @ params["tok_emb"].to(cd).T
        if return_kv:
            return logits, torch.stack(all_k), torch.stack(all_v)
        return logits

    def lm_loss(self, params, ids):
        """Next-token cross entropy over ids[:, :-1] -> ids[:, 1:]
        (no dropout: the port has no training path yet)."""
        logits = self.forward(params, ids[:, :-1]).float()
        targets = ids[:, 1:].long()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, targets[..., None])[..., 0]
        return (lse - picked).mean()

    # -- KV-cache generation --------------------------------------------
    def _decode_one(self, params, ck, cv, pos: int, tok):
        """One decode step. ``tok`` ``[N]`` at position ``pos``;
        ``ck``/``cv`` ``[L, N, H, max_len, hd]``, written in place at
        ``pos``. Returns (logits ``[N, V]`` f32, ck, cv)."""
        cfg = self.cfg
        cd = self.compute_dtype
        n = tok.shape[0]
        dev = tok.device
        x = params["tok_emb"].to(cd)[tok.long()] + params["pos_emb"].to(cd)[pos]
        scale = self._scale(dev)
        neg = torch.finfo(cd).min
        valid = (torch.arange(cfg.max_len, device=dev) <= pos)[None, None, None, :]
        for li, lp in enumerate(params["layers"]):
            h = self._ln(x, lp["ln1"])
            qkv = h @ lp["wqkv"].to(cd) + lp["bqkv"].to(cd)
            q, k, v = (y.reshape(n, cfg.n_heads, 1, cfg.head_dim)
                       for y in qkv.split(cfg.d_model, dim=-1))
            ck[li, :, :, pos] = k[:, :, 0]
            cv[li, :, :, pos] = v[:, :, 0]
            logits = torch.einsum("nhqd,nhkd->nhqk", q, ck[li]) * scale
            logits = logits.masked_fill(~valid, neg)
            w = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("nhqk,nhkd->nhqd", w, cv[li]).reshape(n, cfg.d_model)
            x = x + ctx @ lp["wo"].to(cd) + lp["bo"].to(cd)
            x = x + self.mlp(x, lp) + lp["b2"].to(cd)
        x = self._ln(x, params["ln_f"])
        return (x @ params["tok_emb"].to(cd).T).float(), ck, cv

    @torch.no_grad()
    def generate(self, params, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """Greedy (temperature 0) or sampled continuation ``[N, new]``
        int32 of ``prompt_ids`` ``[N, t0]``, on the parameters' device."""
        cfg = self.cfg
        dev = params["tok_emb"].device
        prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                                 device=dev)
        n, t0 = prompt.shape
        if t0 + max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({cfg.max_len})")

        def sample(logits):
            if temperature > 0.0:
                logits = logits / temperature + gumbel_noise(
                    logits.shape, generator, dev)
            return logits.argmax(dim=-1).to(torch.int32)

        logits_p, ks, vs = self.forward(params, prompt, return_kv=True)
        shape = (cfg.n_layers, n, cfg.n_heads, cfg.max_len, cfg.head_dim)
        ck = torch.zeros(shape, dtype=self.compute_dtype, device=dev)
        cv = torch.zeros(shape, dtype=self.compute_dtype, device=dev)
        ck[:, :, :, :t0] = ks
        cv[:, :, :, :t0] = vs
        tok = sample(logits_p[:, -1].float())
        toks = [tok]
        for i in range(max_new_tokens - 1):
            logits, ck, cv = self._decode_one(params, ck, cv, t0 + i, tok)
            tok = sample(logits)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    @staticmethod
    def num_params(params) -> int:
        return sum(int(t.numel()) for t in _leaves(params))


# ------------------------------------------------------ parameter trees
def init_params_numpy(cfg: TransformerConfig, seed: int = 0) -> Dict[str, Any]:
    """Random parameters in the JAX tree layout, drawn with numpy at the
    JAX model's init scales (gpt.py:45-76). The JAX model draws with
    threefry, so the values differ; shapes and scales do not."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff

    def norm(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    def ln():
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    out_scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    return {
        "tok_emb": norm((cfg.vocab_size, d), 0.02),
        "pos_emb": norm((cfg.max_len, d), 0.01),
        "ln_f": ln(),
        "layers": [{
            "ln1": ln(),
            "wqkv": norm((d, 3 * d), 0.02),
            "bqkv": np.zeros((3 * d,), np.float32),
            "wo": norm((d, d), out_scale),
            "bo": np.zeros((d,), np.float32),
            "ln2": ln(),
            "w1": norm((d, f), 0.02),
            "b1": np.zeros((f,), np.float32),
            "w2": norm((f, d), out_scale),
            "b2": np.zeros((d,), np.float32),
        } for _ in range(cfg.n_layers)],
    }
