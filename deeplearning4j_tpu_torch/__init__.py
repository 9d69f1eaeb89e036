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
- slice 4, the rest of the serving engine (all but the fleet and the
  HTTP/telemetry plane): ``nn.precision`` (int8 decode weights, the fp8
  KV format), fp8 pools in ``serving.kv_pages``, ``serving.prefix_cache``,
  ``serving.sessions``, ``serving.spec_decode``, and the engine's prefix
  prefill, session resume, speculative verify, int8 decode and
  cancellation, with the paged-attention kernel's fp8 branch and query
  tiles of any width;
- slice 5, ops by name: ``ops.registry`` (the port's own op registry),
  ``ndarray`` (``DataType``, ``NDArray``, ``Nd4j`` with ``exec``),
  ``autodiff`` (``SameDiff``: graphs of registered ops run eagerly, torch
  autograd gradients, the JAX side's zip), ``ops.transforms.relu``,
  ``ops.nn.batch_norm``, and the kernels that only this path reaches:
  ``ops.conv_bn_stats`` (conv 1x1 and 3x3 + batch-norm statistics,
  ``csrc/conv_bn_stats.cu``) and ``ops.residual_tail`` (batch-norm apply +
  residual + ReLU, ``csrc/residual_tail.cu``);
- slice 10, image models: ``ops.nn`` convolution (cuDNN through
  ``F.conv2d`` on NHWC tensors), pools and training batch norm,
  ``nn.conf`` image layers, ``InputType.convolutional`` and the
  preprocessor tags, ``Nesterovs``, ``nn.graph`` (``ComputationGraph``,
  its configuration and vertices), ``zoo.LeNet`` and ``zoo.ResNet50``, and
  ``ModelSerializer.restoreComputationGraph`` / ``restore``; the image
  layers reach no Pallas kernel in the reference, so no hand kernel;
- slice 14, the training loop: ``datasets`` (iterators, normalizers,
  local-file fetchers, ``AsyncDataSetIterator``, ``DevicePrefetchIterator``
  with page-locked staging and copies on a side stream), ``evaluation``,
  ``optimize.listeners``, ``earlystopping``, ``ModelSerializer.writeModel``
  and ``restoreNormalizer``, and ``fit`` over iterators, ``evaluate`` and
  the listeners on both networks;
- the vision zoo: ``nn.conf`` ``SeparableConvolution2D``,
  ``Upsampling2D``, ``DepthwiseConvolution2D``, ``SpaceToDepthLayer`` and
  ``objdetect`` (``Yolo2OutputLayer``, ``YoloUtils``), ``ops.image``
  (batched NMS), ``ops.shape``, and ``zoo``'s ``SimpleCNN``, ``VGG16``,
  ``VGG19``, ``Darknet19``, ``TinyYOLO``, ``YOLO2``, ``SqueezeNet``,
  ``UNet``, ``Xception``, ``InceptionResNetV1``, ``FaceNetNN4Small2`` and
  ``NASNet``; no hand kernel (the reference's convolutions are ``lax``
  ops; the batch norm runs the kernels of ``ops.batch_norm``);
- network surgery and pretraining: the per-layer configs ``nn.conf``
  ``dropout`` (the ``IDropout`` family), ``weightnoise`` and
  ``constraint``, ``nn.transferlearning`` (frozen layers, the
  ``TransferLearning`` builders, ``TransferLearningHelper``),
  ``nn.conf.variational`` (``VariationalAutoencoder``, ``AutoEncoder``)
  and ``nn.conf.ocnn``, layerwise pretraining and ``summary`` of both
  networks; no hand kernel (a frozen layer's parameters stay out of the
  gradient and the updater);
- the training infrastructure: ``util.resilience`` (the fault-tolerant
  fit: preemption bundles, auto-resume, divergence rollback, the
  watchdog, bundle stores), ``util.sharded_checkpoint``, the prefetcher's
  transfer retries, and ``profiler`` (``telemetry``, ``flops``,
  ``flight_recorder``, ``chaos``, ``model_health``); no hand kernel (the
  kernel wrappers count their launches' FLOPs for the MFU);
- ``params``: parameter trees in the JAX layout (``params_from_jax``,
  ``mln_params_from_numpy``, ``cg_params_from_numpy``,
  ``params_to_numpy``) and ``FlatParams``, the flat f32 master buffer.
"""
