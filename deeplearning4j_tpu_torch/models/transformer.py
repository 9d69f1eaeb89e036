"""Transformer configuration and the BERT-style encoder.

Counterpart of ``deeplearning4j_tpu/models/transformer.py``:
``TransformerConfig``, ``bert_base``, ``tiny_config`` (the same fields
and defaults, as a plain dataclass; the JAX package's serde registration
is not carried over) and :class:`TransformerEncoder` with a dense FFN,
its MLM head and loss, and the single-device MLM train step.

Parameters are a plain nested dict in the JAX layout (``tok_emb``,
``pos_emb``, ``type_emb``, ``emb_ln``, a ``layers`` list, ``mlm_bias``;
matmul weights ``[in, out]`` applied as ``x @ W``), so a tree from the
JAX ``TransformerEncoder.init_params()`` carries over with
``params_from_jax``. Masters are f32; the forward casts them to
``cfg.compute_dtype`` where it uses them.

Numerics that follow the JAX encoder rather than PyTorch's habits:

- layer norm uses ``cfg.eps`` (1e-12 for BERT) and the biased variance,
  with keys ``gamma``/``beta`` (not the GPT's 1e-5 and ``g``/``b``);
- the GELU is the tanh approximation (``jax.nn.gelu``);
- ``attn_impl="default"`` masks with ``finfo(compute dtype).min`` and
  rounds the scale ``1/sqrt(head_dim)`` to the compute dtype;
  ``attn_impl="flash"`` goes through ``ops.flash_attention.attention``
  (``-1e30`` masking, f32 online softmax) — two different numerics;
- ``masked_capacity`` keeps the K largest mask flags per row with ties
  to the lowest index, as ``lax.top_k`` does (a stable descending sort);
- the MLM logits run in the compute dtype and are cast to f32 before the
  log-sum-exp; the head is tied, so ``tok_emb`` takes gradient from both
  the lookup and the head.

Dropout draws from an explicit ``torch.Generator``: the same
distribution as the JAX model's ``jax.random.bernoulli``, not the same
draws. Sharding (``param_specs``), the ring/Ulysses steps and MoE layers
are not ported; ``n_experts > 0`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.flash_attention import attention
from deeplearning4j_tpu_torch.ops.fused_update import (fused_master_update,
                                                       require_adam)
from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 30522          # BERT-base vocab
    max_len: int = 512
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dropout: float = 0.1
    type_vocab: int = 2
    eps: float = 1e-12
    dtype: str = "float32"           # params; compute may be bf16
    compute_dtype: str = "bfloat16"
    seed: int = 0
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_base() -> TransformerConfig:
    return TransformerConfig()


def tiny_config(vocab=128, max_len=64, d_model=64, n_layers=2, n_heads=4,
                d_ff=128) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, max_len=max_len,
                             d_model=d_model, n_layers=n_layers,
                             n_heads=n_heads, d_ff=d_ff,
                             compute_dtype="float32")


def normal_init(rng: np.random.Generator, shape, std: float = 0.02):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def init_params_numpy(cfg: TransformerConfig, seed: int = 0) -> Dict[str, Any]:
    """Random encoder parameters in the JAX tree layout, drawn with numpy
    at the JAX encoder's scale (normal, std 0.02; transformer.py:95-143).
    The JAX model draws with threefry, so the values differ; the shapes
    and scales do not."""
    if cfg.n_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    rng = np.random.default_rng(seed)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size

    def ln():
        return {"gamma": np.ones((d,), np.float32),
                "beta": np.zeros((d,), np.float32)}

    return {
        "tok_emb": normal_init(rng, (v, d)),
        "pos_emb": normal_init(rng, (cfg.max_len, d)),
        "type_emb": normal_init(rng, (cfg.type_vocab, d)),
        "emb_ln": ln(),
        "layers": [{
            "wqkv": normal_init(rng, (d, 3 * d)),
            "bqkv": np.zeros((3 * d,), np.float32),
            "wo": normal_init(rng, (d, d)),
            "bo": np.zeros((d,), np.float32),
            "ln1": ln(),
            "ln2": ln(),
            "w1": normal_init(rng, (d, f)),
            "b1": np.zeros((f,), np.float32),
            "w2": normal_init(rng, (f, d)),
            "b2": np.zeros((d,), np.float32),
        } for _ in range(cfg.n_layers)],
        "mlm_bias": np.zeros((v,), np.float32),
    }


def flat_train_step(loss_fn, updater):
    """The single-device train step over a :class:`FlatParams`: the loss
    on the tree of views, autograd into the flat gradient, then **one**
    fused Adam launch over the whole flat master, which updates master, m
    and v in place (the JAX step donates them). Returns the loss as a
    device tensor; nothing syncs with the host."""
    require_adam(updater)

    def step(flat: FlatParams, opt_state, it_step: int, *batch, **kw):
        loss = loss_fn(flat.tree, *batch, **kw)
        grad = flat.gather_grads(loss)
        fused_master_update(flat.master, opt_state["m"], opt_state["v"], grad,
                            it_step, updater)
        return loss.detach()

    return step


class TransformerEncoder:
    def __init__(self, config: TransformerConfig, attn_impl: str = "default"):
        """attn_impl: 'default' (plain softmax attention in torch ops) or
        'flash' (``ops.flash_attention.attention``: the CUDA kernels on
        the card, blockwise online softmax on the CPU)."""
        if attn_impl not in ("default", "flash"):
            raise ValueError(f"attn_impl must be default|flash: {attn_impl}")
        if config.n_experts:
            raise NotImplementedError(
                "MoE layers (n_experts > 0) are not ported yet")
        self.cfg = config
        self.attn_impl = attn_impl
        self._cdtype = getattr(torch, config.compute_dtype)

    # ------------------------------------------------------------- params
    def init_params(self, seed: Optional[int] = None, device=None):
        """Random parameters (:func:`init_params_numpy`) on ``device``
        (default: the CUDA card)."""
        seed = self.cfg.seed if seed is None else seed
        return params_from_jax(init_params_numpy(self.cfg, seed), device)

    # ------------------------------------------------------------ forward
    def _ln(self, x, p):
        m = x.mean(dim=-1, keepdim=True)
        v = x.var(dim=-1, correction=0, keepdim=True)
        return (x - m) * torch.rsqrt(v + self.cfg.eps) * p["gamma"] + p["beta"]

    def _cast(self, p):
        return {k: t.to(self._cdtype) for k, t in p.items()}

    def _dropout(self, x, generator):
        keep = 1.0 - self.cfg.dropout
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return x * (u < keep) / keep

    def encode(self, params, ids, type_ids=None, mask=None, train=False,
               generator: Optional[torch.Generator] = None):
        """ids ``[N, T]`` -> hidden ``[N, T, D]`` in the compute dtype;
        ``mask`` ``[N, T]`` is a key-padding mask (1 = real token)."""
        cd = self._cdtype
        ids = ids.long()
        t = ids.shape[1]
        x = params["tok_emb"].to(cd)[ids]
        x = x + params["pos_emb"].to(cd)[None, :t]
        if type_ids is not None:
            x = x + params["type_emb"].to(cd)[type_ids.long()]
        x = self._ln(x, self._cast(params["emb_ln"]))
        drop = train and generator is not None and self.cfg.dropout > 0
        for lp in params["layers"]:
            x = self._block(x, lp, mask, generator if drop else None)
        return x

    def _block(self, x, lp, mask, generator):
        cfg = self.cfg
        cd = self._cdtype
        n, t, d = x.shape
        h, hd = cfg.n_heads, cfg.head_dim

        # attention (post-LN like BERT: LN after the residual)
        qkv = x @ lp["wqkv"].to(cd) + lp["bqkv"].to(cd)
        q, k, v = (y.reshape(n, t, h, hd).transpose(1, 2)
                   for y in qkv.split(d, dim=-1))
        if self.attn_impl == "flash":
            ctx = attention(q, k, v, mask)
        else:
            scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=cd,
                                                  device=x.device))
            logits = torch.einsum("nhqd,nhkd->nhqk", q, k) * scale
            if mask is not None:
                logits = logits.masked_fill(
                    ~mask.bool()[:, None, None, :], torch.finfo(cd).min)
            w = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("nhqk,nhkd->nhqd", w, v)
        ctx = ctx.transpose(1, 2).reshape(n, t, d)
        att = ctx @ lp["wo"].to(cd) + lp["bo"].to(cd)
        if generator is not None:
            att = self._dropout(att, generator)
        x = self._ln(x + att, self._cast(lp["ln1"]))

        hmid = F.gelu(x @ lp["w1"].to(cd) + lp["b1"].to(cd),
                      approximate="tanh")
        out = hmid @ lp["w2"].to(cd) + lp["b2"].to(cd)
        if generator is not None:
            out = self._dropout(out, generator)
        return self._ln(x + out, self._cast(lp["ln2"]))

    def mlm_logits(self, params, hidden):
        """Tied-embedding MLM head: ``hidden @ tok_emb^T + bias``."""
        return (hidden @ params["tok_emb"].to(hidden.dtype).T
                + params["mlm_bias"].to(hidden.dtype))

    # ------------------------------------------------------ loss and step
    def mlm_loss(self, params, ids, labels, mask_positions, train=True,
                 generator: Optional[torch.Generator] = None,
                 masked_capacity: Optional[int] = None):
        """labels ``[N, T]`` with targets; mask_positions ``[N, T]`` 1.0
        where the token was masked (loss only there). With
        ``masked_capacity=K`` only the K largest mask flags of each row
        are projected to the vocabulary (ties to the lowest index)."""
        hidden = self.encode(params, ids, train=train, generator=generator)
        labels = labels.long()
        if masked_capacity is not None:
            kcap = int(masked_capacity)
            idx = torch.sort(mask_positions, dim=1, descending=True,
                             stable=True).indices[:, :kcap]
            hidden = hidden.gather(
                1, idx[..., None].expand(-1, -1, hidden.shape[-1]))
            labels = labels.gather(1, idx)
            mask_positions = mask_positions.gather(1, idx)
        logits = self.mlm_logits(params, hidden).float()
        lse = torch.logsumexp(logits, dim=-1)
        tok = logits.gather(-1, labels[..., None])[..., 0]
        denom = torch.clamp(mask_positions.sum(), min=1.0)
        return -((tok - lse) * mask_positions).sum() / denom

    def make_train_step(self, updater, masked_capacity: Optional[int] = None):
        """The single-device MLM train step (transformer.py:356-372, the
        unsharded branch)::

            flat = FlatParams(params)
            opt_state = updater.init_state(flat.master)
            loss = step(flat, opt_state, it_step, ids, labels, mask_pos,
                        generator=g)

        updates ``flat`` and ``opt_state`` in place (one fused Adam
        launch per step) and returns the loss on the device."""

        def loss_fn(tree, ids, labels, mask_pos, generator=None):
            return self.mlm_loss(tree, ids, labels, mask_pos, True, generator,
                                 masked_capacity)

        return flat_train_step(loss_fn, updater)
