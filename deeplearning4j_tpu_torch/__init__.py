"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
``numpy`` and never JAX or anything of ``deeplearning4j_tpu``. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``.

Ported so far (slice 1, GPT decode serving):

- ``models.transformer``: ``TransformerConfig``, ``tiny_config``;
- ``models.gpt``: ``CausalLM`` (forward, ``lm_loss``, ``generate``) and
  the parameter-tree bridges ``params_from_jax`` / ``params_to_numpy``;
- ``ops.paged_attention``: the paged-attention kernel
  (``csrc/paged_attention.cu``) and its plain PyTorch reference;
- ``serving.kv_pages`` and ``serving.engine``: the page pool and the
  continuous-batching ``DecodeEngine``.
"""
