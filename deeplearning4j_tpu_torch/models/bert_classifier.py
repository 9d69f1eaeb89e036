"""BERT sequence classification, the fine-tuning recipe.

Counterpart of ``deeplearning4j_tpu/models/bert_classifier.py``: the
encoder of ``models/transformer.py``, first-token ("[CLS]") pooling, a
tanh dense pooler and an ``n_classes`` linear head. Parameters are the
encoder's tree plus ``pooler`` and ``classifier`` (``{"W", "b"}`` each),
in the JAX layout. This is the path that sends a real key-padding mask
through the encoder's attention (``encode(..., mask=...)``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, TransformerEncoder, flat_train_step,
    init_params_numpy, normal_init)
from deeplearning4j_tpu_torch.params import params_from_jax


class BertSequenceClassifier:
    def __init__(self, config: TransformerConfig, n_classes: int,
                 attn_impl: str = "default"):
        self.encoder = TransformerEncoder(config, attn_impl=attn_impl)
        self.cfg = config
        self.n_classes = n_classes

    # -- params ---------------------------------------------------------
    def init_params_numpy(self, seed: int = 0,
                          encoder_params: Optional[Dict[str, Any]] = None):
        """Numpy parameters in the JAX layout: a fresh head (normal, std
        0.02, zero biases), the encoder fresh or transplanted from
        ``encoder_params`` (numpy leaves)."""
        rng = np.random.default_rng(seed)
        d = self.cfg.d_model
        enc = encoder_params if encoder_params is not None \
            else init_params_numpy(self.cfg, seed + 1)
        params = dict(enc)
        params["pooler"] = {"W": normal_init(rng, (d, d)),
                            "b": np.zeros((d,), np.float32)}
        params["classifier"] = {
            "W": normal_init(rng, (d, self.n_classes)),
            "b": np.zeros((self.n_classes,), np.float32)}
        return params

    def init_params(self, seed: int = 0, device=None,
                    encoder_params: Optional[Dict[str, Any]] = None):
        """:meth:`init_params_numpy` on ``device`` (default: the CUDA
        card)."""
        return params_from_jax(self.init_params_numpy(seed, encoder_params),
                               device)

    # -- forward --------------------------------------------------------
    def logits(self, params, ids, mask=None, train=False,
               generator: Optional[torch.Generator] = None):
        cd = self.encoder._cdtype
        hidden = self.encoder.encode(params, ids, mask=mask, train=train,
                                     generator=generator)
        cls = hidden[:, 0]                      # [N, D] first-token pool
        pooled = torch.tanh(cls @ params["pooler"]["W"].to(cd)
                            + params["pooler"]["b"].to(cd))
        out = (pooled @ params["classifier"]["W"].to(cd)
               + params["classifier"]["b"].to(cd))
        return out.float()

    def loss(self, params, ids, labels, mask=None, train=True,
             generator: Optional[torch.Generator] = None):
        lg = self.logits(params, ids, mask=mask, train=train,
                         generator=generator)
        logp = torch.log_softmax(lg, dim=-1)
        return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()

    # -- fine-tune step ---------------------------------------------------
    def make_train_step(self, updater):
        """The fine-tune step, over a ``FlatParams`` as the encoder's
        :meth:`TransformerEncoder.make_train_step`::

            loss = step(flat, opt_state, it_step, ids, labels, mask,
                        generator=g)
        """

        def loss_fn(tree, ids, labels, mask, generator=None):
            return self.loss(tree, ids, labels, mask=mask, train=True,
                             generator=generator)

        return flat_train_step(loss_fn, updater)

    @torch.no_grad()
    def predict(self, params, ids, mask=None):
        return torch.argmax(self.logits(params, ids, mask=mask), dim=-1)
