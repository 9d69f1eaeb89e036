"""PyTorch/CUDA port of ``deeplearning4j_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
``numpy`` and never JAX or anything of ``deeplearning4j_tpu``. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``.

Ported so far:

- slice 1, GPT decode serving:
  ``models.gpt`` (``CausalLM``: forward, ``lm_loss``, ``generate``),
  ``ops.paged_attention`` (the paged-attention kernel
  ``csrc/paged_attention.cu`` and its plain PyTorch reference),
  ``serving.kv_pages`` and ``serving.engine`` (the page pool and the
  continuous-batching ``DecodeEngine``);
- slice 2, BERT training:
  ``models.transformer`` (``TransformerConfig``, ``bert_base``,
  ``tiny_config``, ``TransformerEncoder`` with its MLM loss and flat
  train step), ``models.bert_classifier`` (the fine-tune recipe),
  ``learning.updaters`` (``Adam`` with a float learning rate; ``Sgd``
  and ``apply_updater`` came with slice 3),
  ``ops.flash_attention`` (forward and backward kernels
  ``csrc/flash_attention.cu``) and ``ops.fused_update`` (the fused Adam
  master update ``csrc/fused_update.cu``);
- slice 3, the layer framework's char-LSTM training and sampling:
  ``nn.multilayer.MultiLayerNetwork`` (``fit`` with standard and
  truncated BPTT, ``output``, ``rnnTimeStep``), ``nn.conf`` (builders,
  config JSON, ``DenseLayer``, ``OutputLayer``, ``LSTM``,
  ``RnnOutputLayer``), ``activations``, ``loss``, ``nn.weights``,
  ``datasets.DataSet``, ``util.model_serializer`` (reads the JAX side's
  zips), ``zoo.TextGenerationLSTM`` and ``ops.nn.lstm_layer`` over
  ``ops.lstm_recurrence`` (the persistent LSTM recurrence kernels
  ``csrc/lstm_recurrence.cu``, forward and backward);
- ``params``: parameter trees in the JAX layout (``params_from_jax``,
  ``mln_params_from_numpy``, ``params_to_numpy``) and ``FlatParams``, the
  flat f32 master buffer.
"""
