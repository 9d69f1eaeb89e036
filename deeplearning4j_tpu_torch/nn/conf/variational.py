"""The pretrainable layers: counterpart of
``deeplearning4j_tpu/nn/conf/variational.py`` (``VariationalAutoencoder``
and the denoising ``AutoEncoder``).

Each layer is a feedforward encoder in a supervised network and carries
an unsupervised objective, ``unsupervised_loss(params, x, generator)``,
that ``MultiLayerNetwork.pretrainLayer`` and
``ComputationGraph.pretrainLayer`` minimise. The noise has a seam: the VAE's
reparameterisation draws ``eps`` and the autoencoder's corruption mask
``keep`` are optional arguments, drawn from ``generator`` (JAX's
distributions, not its draws) when absent, so a test can hand in JAX's
own. Parameter keys are JAX's: ``e{i}W``/``e{i}b`` (encoder),
``d{i}W``/``d{i}b`` (decoder), ``pZXMeanW``/``b``, ``pZXLogStd2W``/``b``
and ``pXZW``/``b`` (the VAE); ``W``, ``b`` and the visible bias ``vb``
(the autoencoder, decoding through the tied ``W^T``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.common.serde import serializable, tuplify
from deeplearning4j_tpu_torch.loss import LossFunction, compute_loss
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, _act
from deeplearning4j_tpu_torch.nn.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.ops.transforms import jax_abs

_LOG2PI = math.log(2.0 * math.pi)


def _mlp_init(generator, sizes, weight_init, dtype, device, prefix) -> dict:
    """``{prefix}{i}W`` / ``{prefix}{i}b`` of a dense stack over
    ``sizes``."""
    p = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        p[f"{prefix}{i}W"] = init_weights(weight_init, generator, (a, b), a,
                                          b, dtype, device)
        p[f"{prefix}{i}b"] = torch.zeros((b,), dtype=dtype, device=device)
    return p


def _mlp_apply(params, x, n: int, act, prefix: str):
    for i in range(n):
        x = act.fn(x @ params[f"{prefix}{i}W"] + params[f"{prefix}{i}b"])
    return x


@serializable
@dataclasses.dataclass
class VariationalAutoencoder(Layer):
    """A VAE layer. In a supervised network it emits the latent mean
    through ``pzx_activation``; pretraining minimises the negative ELBO.
    ``reconstruction_distribution`` is "gaussian" (the pXZ head gives a
    mean and a log-variance per feature, ``2 * n_in`` outputs) or
    "bernoulli" (``n_in`` logits, data in [0, 1]). ``n_out`` is the latent
    size."""

    n_in: int = 0
    n_out: int = 0
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    reconstruction_distribution: str = "gaussian"
    #: the activation of the Gaussian reconstruction mean
    reconstruction_activation: str = "identity"
    pzx_activation: str = "identity"
    num_samples: int = 1

    def __post_init__(self):
        super().__post_init__()
        self.encoder_layer_sizes = tuplify(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuplify(self.decoder_layer_sizes)

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(self.n_out)

    def _dist_size(self) -> int:
        if self.reconstruction_distribution == "gaussian":
            return 2 * self.n_in
        if self.reconstruction_distribution == "bernoulli":
            return self.n_in
        raise ValueError("reconstruction_distribution must be "
                         "'gaussian' or 'bernoulli', got "
                         f"{self.reconstruction_distribution!r}")

    def init_params(self, generator, it, dtype, device) -> dict:
        wi = self.weight_init or WeightInit.XAVIER
        enc = (self.n_in,) + self.encoder_layer_sizes
        dec = (self.n_out,) + self.decoder_layer_sizes
        p = _mlp_init(generator, enc, wi, dtype, device, "e")
        p.update(_mlp_init(generator, dec, wi, dtype, device, "d"))
        e_last, d_last, ds = enc[-1], dec[-1], self._dist_size()
        for head in ("pZXMean", "pZXLogStd2"):
            p[f"{head}W"] = init_weights(wi, generator, (e_last, self.n_out),
                                         e_last, self.n_out, dtype, device)
            p[f"{head}b"] = torch.zeros((self.n_out,), dtype=dtype,
                                        device=device)
        p["pXZW"] = init_weights(wi, generator, (d_last, ds), d_last, ds,
                                 dtype, device)
        p["pXZb"] = torch.zeros((ds,), dtype=dtype, device=device)
        return p

    # -- pieces ---------------------------------------------------------
    def _encode(self, params, x):
        act = _act(self.activation or "identity")
        h = _mlp_apply(params, x, len(self.encoder_layer_sizes), act, "e")
        mean = h @ params["pZXMeanW"] + params["pZXMeanb"]
        log_var = h @ params["pZXLogStd2W"] + params["pZXLogStd2b"]
        return mean, log_var

    def _decode_logp(self, params, z, x):
        """``log p(x | z)`` per example; ``z`` may be ``[K, N, L]``."""
        act = _act(self.activation or "identity")
        d = _mlp_apply(params, z, len(self.decoder_layer_sizes), act, "d")
        out = d @ params["pXZW"] + params["pXZb"]
        if self.reconstruction_distribution == "bernoulli":
            # -BCE on logits, stable: x * out - log(1 + e^out)
            return torch.sum(x * out - torch.logaddexp(out.new_zeros(()),
                                                       out), dim=-1)
        self._dist_size()
        mu, lv = torch.chunk(out, 2, dim=-1)
        mu = _act(self.reconstruction_activation).fn(mu)
        return -0.5 * torch.sum(_LOG2PI + lv + (x - mu) ** 2 * torch.exp(-lv),
                                dim=-1)

    def _eps(self, eps, k: int, mean, generator):
        if eps is None:
            eps = torch.randn((k,) + tuple(mean.shape), generator=generator,
                              device=mean.device, dtype=mean.dtype)
        return eps

    # -- the supervised path: the latent mean ---------------------------
    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        mean, _ = self._encode(params, x)
        return _act(self.pzx_activation).fn(mean), state

    # -- the unsupervised path ------------------------------------------
    def unsupervised_loss(self, params, x, generator, eps=None):
        """The negative ELBO averaged over the batch, over
        ``num_samples`` draws ``eps`` ``[K, N, n_out]``."""
        mean, log_var = self._encode(params, x)
        eps = self._eps(eps, self.num_samples, mean, generator)
        z = mean[None] + torch.exp(0.5 * log_var)[None] * eps
        logp = torch.mean(self._decode_logp(params, z, x[None]), dim=0)
        kl = -0.5 * torch.sum(1.0 + log_var - mean ** 2 - torch.exp(log_var),
                              dim=-1)
        return torch.mean(kl - logp)

    def reconstruction_log_prob(self, params, x, generator,
                                num_samples: int = 16, eps=None):
        """Importance-sampled ``log p(x)`` per example (the anomaly score:
        higher is more normal), the ``num_samples`` decoder passes as one
        batched pass."""
        mean, log_var = self._encode(params, x)
        std = torch.exp(0.5 * log_var)
        eps = self._eps(eps, num_samples, mean, generator)
        z = mean[None] + std[None] * eps
        log_px_z = self._decode_logp(params, z, x[None])
        log_pz = -0.5 * torch.sum(_LOG2PI + z ** 2, dim=-1)
        log_qz = -0.5 * torch.sum(_LOG2PI + log_var[None] + eps ** 2, dim=-1)
        return (torch.logsumexp(log_px_z + log_pz - log_qz, dim=0)
                - math.log(float(num_samples)))


@serializable
@dataclasses.dataclass
class AutoEncoder(Layer):
    """A denoising autoencoder layer. The supervised forward is the
    encoder (dense, the activation, sigmoid by default); the unsupervised
    loss reconstructs the uncorrupted input from a masking-corrupted
    encoding through the tied decoder ``act(h @ W^T + vb)``, plus
    ``sparsity`` times the mean absolute hidden activation."""

    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(self.n_out)

    def init_params(self, generator, it, dtype, device) -> dict:
        w = init_weights(self.weight_init or WeightInit.XAVIER, generator,
                         (self.n_in, self.n_out), self.n_in, self.n_out,
                         dtype, device)
        return {"W": w,
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
                "vb": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, state, x, train, generator):
        x = self._maybe_dropout(x, train, generator)
        act = _act(self.activation or "sigmoid")
        return act.fn(x @ params["W"] + params["b"]), state

    def unsupervised_loss(self, params, x, generator, keep=None):
        """The reconstruction loss; ``keep`` (a boolean mask of ``x``'s
        shape, True where an input survives the corruption) is drawn from
        ``generator`` when absent, and unused at ``corruption_level``
        0."""
        act = _act(self.activation or "sigmoid")
        x_in = x
        if self.corruption_level > 0.0:
            if keep is None:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) \
                    < 1.0 - self.corruption_level
            x_in = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
        h = act.fn(x_in @ params["W"] + params["b"])
        recon_pre = h @ params["W"].T + params["vb"]
        loss = compute_loss(LossFunction.resolve(self.loss), x, recon_pre,
                            self.activation or "sigmoid", None)
        if self.sparsity > 0.0:
            loss = loss + self.sparsity * torch.mean(jax_abs(h))
        return loss


__all__ = ["VariationalAutoencoder", "AutoEncoder"]
