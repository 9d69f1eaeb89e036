#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA
   versions;
2. build: ``csrc/paged_attention.cu``, ``csrc/flash_attention.cu``,
   ``csrc/fused_update.cu``, ``csrc/lstm_recurrence.cu``,
   ``csrc/conv_bn_stats.cu`` and ``csrc/residual_tail.cu`` compiled from
   this checkout by ``nvcc`` for sm_90a, one ``nvcc`` per source, all
   started together; ``ptxas`` registers and spills of the kernels the
   slices run (and any ptxas note that it serialized wgmma), and
   ``cuobjdump -sass``: each head-dim instance of the three bf16 flash
   kernels (forward, dk/dv, dq) must hold tensor-core instructions
   (``HMMA``/``HGMMA``), each of the four (taps, BN) instances of the
   bf16 tensor-core conv route ``conv_bn_stats_tc_kernel`` must hold
   ``HGMMA``, each of the six (H, rows) instances of the LSTM
   cluster routes ``lstm_fwd_cluster_kernel`` and
   ``lstm_bwd_cluster_kernel`` and each of the
   eight bf16-query 8-row-tile instances of ``paged_attention_kernel``
   (bf16 or fp8 pools, head_dim 32-128) must hold ``HMMA``;
3. kernel: the paged-attention kernel against its plain PyTorch version
   at every shape the serving paths give it (H=12, hd=64, ps=16, P=32):
   the decode step (N=8, Q=1; float pools and fp8 pools with f32 scale
   planes), the speculative verify (N=8, Q in {3, 5, 9}) and the prefix
   prefill (N=1, Q in {32, 64, 128, 512}, qbase page-aligned and
   mid-page), under f32 and bf16 queries; f32 queries within 1e-5, bf16
   within 2e-2 of the reference run at f32 on the same (dequantized)
   values, the largest error by kind on single rows and 8-row tiles, and
   every warp count per block (1-8) at a mixed decode and a verify case
   in every pool kind; then at the decode (float and fp8), verify (Q=5)
   and prefix (N=1, Q=128) shapes: two calls bit-equal, the kernel's time
   beside the plain version's, a page gather (+ dequantization) +
   ``scaled_dot_product_attention`` yardstick and the bound from the
   bytes it must move, the profiler's device time per call and the
   host's cost per call of the wrapper and of the C entry alone
   (``tools/attention_probe.py``), and those at the f32 engine's decode
   shape;
4. serve: the GPT-2-small-like model (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32000, max_len 512; random weights from a numpy
   seed in the JAX tree layout) behind ``DecodeEngine(slots=8,
   page_size=16, max_context=512)`` in bf16, serving 24 concurrent
   greedy requests; every decode step must have gone through the
   kernel. Then an f32 pass whose engine tokens must equal the dense
   ``CausalLM.generate()``. The serving phases that follow use the same
   model and engine shape, and each checks that every decode step,
   verify pass and suffix prefill launched the kernel once per layer
   and that its pool drains:
   - fp8: phase 4's requests with ``kv_dtype="fp8_e4m3"`` (tokens/s,
     TTFT, bytes per page, agreement with the float engine, reported);
     at f32 the fp8 pages after prefill (within one e4m3 step at a
     rounding boundary) and the greedy tokens (equal) on the card
     against a CPU twin;
   - prefix: bench_gpt_decode.py's prefix_ab traffic (16 users, a
     192-token system prompt, 32-token user suffixes, 64 new tokens, one
     after another) cold and warm, then a second turn per user adding 80
     tokens, resumed from its sticky session (suffix bucket 128); at f32
     warm and resumed tokens equal cold ones;
   - spec: phase 4's requests with ``spec_decode`` k in {2, 4, 8}
     against plain (acceptance, tokens per verify, tokens/s); at f32 the
     tokens equal plain;
   - int8: phase 4's requests with ``quantization="int8"``; at f32 the
     card's tokens equal a CPU twin's;
5. train kernels: the flash-attention forward kernel against
   ``blockwise_attention`` (N=4, H=12, hd=64, T in {128, 77}; no mask,
   padded rows, padded rows plus one fully masked row; causal off and
   on; f32 within 2e-5, bf16 within 2e-2 of the f32 plain version on the
   bf16-rounded inputs), the backward kernels against autograd through
   ``blockwise_attention`` (f32 within 1e-4 of max |grad|, bf16 within
   2e-2), the fused Adam kernel against ``adam_update_reference`` (step
   300, loss scale and clip; n = 108,922,170 and an unaligned n; rtol
   1e-6, atol 1e-7); the bf16 (tensor-core) flash kernels at hd 32, 64,
   96 and 128, T in {1, 16, 77, 128, 200} and Tq != Tk, no mask or a
   fully masked row, causal off and on (forward within 2e-2, backward
   within 2e-2 of max |grad| with a 1e-5 floor where the gradient is 0
   in exact arithmetic); f16 and head dims 16, 48 and 160 (C9, C10:
   zero-padded or widened copies; f16 within 2e-3), forward and backward;
   then, at the training shape (N=96, bf16), the
   forward and backward kernels against the f32 plain version again
   (within 2e-2, of max |grad| for the backward), two backward calls
   bit-equal, each kernel's time at the training shapes beside its plain
   version's, its bound and a library yardstick the port never calls,
   and each call's device time from the profiler (the backward's split
   between its three kernels);
6. train: BERT-base (``bert_base()``, 108.9 M parameters, random weights
   from a numpy seed in the JAX tree layout) with ``attn_impl="flash"``,
   bf16 compute and f32 masters in one flat buffer, MLM on a fixed batch
   of 96 x 128 tokens with 19 masked positions per row,
   ``masked_capacity=20``, dropout 0.1 from a seeded generator, Adam at
   lr 1e-4: 2 warm-up and 10 timed steps, every layer through the flash
   kernels and every step through one fused Adam launch; the loss must
   start near ln(vocab) and fall. Then a profiled window of 3 steps:
   device busy per step and the flash kernels' share of it;
7. train parity: 2 layers at full width, batch 8 x 128, dropout 0, f32:
   3 MLM steps on the card (the kernels) and on the CPU (the plain
   versions) from the same numpy weights must agree (loss 1e-4
   relative, parameters 2e-5 absolute) and the card's update must have
   moved a parameter by at least half a step of lr, then one
   ``BertSequenceClassifier`` fine-tune step with a padding mask alike;
8. LSTM kernels: the recurrence forward and backward kernels against
   their plain versions (H=256, N in {1, 256}, T in {1, 50, 200}, and
   the sampling shapes T in {1, 64} at N=4; non-zero h0 and c0, with and
   without the cell stream; f32 within 1e-5, bf16 within 2e-2 of the f32
   plain version on the bf16-rounded inputs; the backward's d x_proj,
   d w_hh, dh0 and dc0 within 1e-4 (f32) and 2e-2 (bf16) of max |grad|,
   and the bf16 d w_hh within 2^-8 of max |grad| of the f32 sum over the
   kernel's own stored ys and cs); both directions at wide shapes (C10:
   N=512 at H=1024 and at H=256, and H=2048) at f32 and bf16, and f16
   calls (C9) against the plain versions; at every one of those shapes the bf16 forward on its
   cluster route (``fwd_route``) and on the first (grid) design, both
   against the plain version and each other within 2e-2, two cluster
   calls bit-equal; the three mixes of f32 and bf16 among x_proj, w_hh
   and the state (C6: the grid route over widened inputs), forward and
   backward against the plain versions on the same mixed inputs (dtypes
   equal, values within 1e-5 (2e-3 under a bf16 w_hh, where the
   recurrence rounds h) or one bf16 step, gradients within 1e-4 of max
   |grad| or one bf16 step); then at the char-LSTM training shape
   (N=256, T=200, H=256, bf16): both directions on their cluster routes
   (``fwd_route``, ``bwd_route``), two calls bit-equal, the first (grid)
   designs against the plain version too, each kernel's time (each
   direction's two designs in turns with cuDNN in the same call) beside
   its plain version's, its bound and a ``torch.nn.LSTM`` (cuDNN)
   yardstick the port never calls, with the port's projection matmul
   plus the kernel beside it (like with like), and the profiler's device
   time per call of each cluster route and the forward's grid design;
9. char-LSTM training: ``TextGenerationLSTM(vocab_size=77, hidden=256)``
   (887,117 parameters, random weights from a numpy seed in the JAX
   layout) through ``MultiLayerNetwork.fit`` at ``bench_common.
   build_char_lstm``'s shape (batch 256 x 200 one-hot characters, labels
   the next character, bf16, standard BPTT, Adam 1e-3): 2 warm-up and 10
   timed steps, exactly 2 forward and 2 backward kernel launches per
   step, the per-character loss starting within 0.5 of ln 77 and falling;
   a profiled window of 3 steps; then the zoo's own tBPTT 50 at f32 on the
   same batch: one ``fit`` is 4 segments, 8 + 8 launches, 4 iterations;
   every bf16 launch on the cluster routes (``fwd_cluster_launches``,
   ``bwd_cluster_launches``); then the JAX bench's wide model (hidden
   1024, C10) on the same batch: a few steps on the grid route, ms/step,
   and B5 at T=200, N=256, H=1024 against its plain version;
10. LSTM parity: the zoo model (hidden 256, tBPTT 50, f32), 3 minibatches
   of 8 x 100 on the card (the kernels) and on the CPU (the plain
   versions) from the same numpy weights (loss 1e-5 relative, parameters
   2e-5 absolute, some parameter moved by at least lr/2); then, on the
   card, ``rnnTimeStep`` fed 64 characters one at a time (batch 4) equals
   ``output()`` over the sequence, and both equal the same network's
   ``output()`` on the CPU (the plain versions), within 1e-5; a changed
   batch size with stored state raises; then the same sampling at bf16,
   every launch on the forward's cluster route, within 2e-2 of bf16
   ``output()``, its ms per character beside f32's;
11. conv / tail kernels: through ``Nd4j.exec`` by name, at batch 256 in
   bf16, the conv + BN-stats kernel (``csrc/conv_bn_stats.cu``) at the 9
   1x1 and 4 3x3 stride-1 shapes of ResNet-50's bottleneck stacks
   (bench_conv_pallas.py:23-37) and the residual-tail kernel
   (``csrc/residual_tail.cu``) at its 4 residual joins
   (bench_residual_tail.py:31-36), each conv against its plain version at
   f32 on the same bf16 values (y within one bf16 rounding, 2^-8 of the
   largest value; means within 1e-5 of max |y|, variances within 1e-4 of
   max E[y^2]: f32 sums in another order), every conv shape on the
   tensor-core route, then each one's time beside the first bf16
   design's (the route odd shapes still take), its plain version's, a
   library yardstick the port never calls (``torch.matmul`` or
   ``F.conv2d`` + ``torch.var_mean``) and its bound; at each conv row
   shape two calls bit-equal and the profiler's device time per call of
   the conv and reduction kernels; the tail in f32, bf16 and both mixes
   of x and res (C5) against its plain version at f32 on the same values
   (f32 within 1e-5, a bf16 output within one bf16 rounding, 2^-8 of the
   largest value), two
   calls bit-equal, each one's time beside its plain version's, the
   library's (``F.batch_norm`` + add + ``relu``) and its byte bound, with
   its share of that bound; f16 by name (C9) for both ops;
11b. batch-norm kernels (``csrc/batch_norm.cu``): the statistics, the
   apply (with and without the ReLU) and the backward at the 9 distinct
   batch-norm shapes of ResNet-50 at batch 256 in bf16 against their
   plain versions (the statistics within 1e-4, the apply bit for bit on
   the same statistics, dx within one bf16 rounding), two calls
   bit-equal, each kernel's time beside its plain version's, the
   library's (``torch.var_mean``, ``F.batch_norm`` forward in inference
   mode, the backward of ``F.batch_norm`` in training mode) and its byte
   bound; the statistics' and the backward's times in turns with their
   two-launch design (``tools/bn_two_launch.cu``, built beside the
   sources) and their launch plans; at 56x56x256 a profiled call of each
   must run one device kernel; the f16 instances at one shape;
12. ResNet-50 blocks by name: the four identity bottleneck blocks
   (256->64->256 at 56x56, 512->128 at 28x28, 1024->256 at 14x14,
   2048->512 at 7x7; numpy He-normal weights from a seed) as ``SameDiff``
   graphs of ``conv1x1_bn_stats``, ``batch_norm``, ``relu``, ``cast``,
   ``conv3x3_bn_stats`` and ``bn_relu_residual``, at batch 256 in bf16:
   one ``output`` of each graph launches B4a 8, B4b 4 and B3 4 times in
   all; ms per block; a device profile; ``calculateGradients`` of the
   first block's last gamma and beta through B3 against the plain
   formula's f32 autograd (1e-4 of max |grad|); a gradient through B4
   must raise; the 7x7 graph saved and loaded gives the same output;
13. block parity: the four blocks at f32, batch 8, on the card (the
   kernels) against the CPU (the plain versions), within 1e-4 of max(1,
   max |out|);
14. LeNet: ``zoo.LeNet`` through ``MultiLayerNetwork`` (Nesterovs 0.01,
   0.9) from one numpy tree on the card (cuDNN at f32, TF32 off)
   and on the CPU, three ``fit`` steps at batch 64 on 28x28x1 data:
   losses within 1e-5 relative, parameters within 2e-5, the inference
   output within 2e-5 of max(1, max |out|);
15. ResNet-50 training at full width: ``zoo.ResNet50(num_classes=1000)``
   (25.6 M parameters) through ``ComputationGraph.fit`` at bench.py's
   cell (batch 256, 224x224x3, bf16, ``Nesterovs(0.1, 0.9)``,
   ``RandomState(0)`` images and one-hot labels), ``cudnn.benchmark`` on
   for this phase only: 2 warm-up and 10 timed steps, a finite loss at
   every step; run twice, with ``FUSED_BN_RELU_BWD`` off (the
   reference's default) and on (``batch_norm_relu_train``); each run:
   the batch-norm kernels launched once per BN layer per step (53), ms
   per step, images/s, peak memory, the FLOPs per step counted from the
   graph's conv and dense shapes (2 x MACs, x3 for the backward) over the
   step time and the bf16 peak, each beside the card's ``nvidia-smi``
   line; a profiled step: device busy and idle share, device time by
   group (conv, batch norm, ReLU/add, updater, other), the ten largest
   device operations (no batch-norm work among them outside the kernels)
   and cuDNN's layout transposes; then 5 steps with ``F.batch_norm`` in
   place of the batch norm, a yardstick the port never calls;
16. graph parity: the cut ResNet (``zoo.resnet50.cut_resnet_conf``: the
   stem, a projection block, an identity block, 32x32x3, 4 classes) at
   f32, three ``Nesterovs`` steps on the card and on the CPU from one
   numpy tree (losses 1e-5 relative, parameters 2e-5, BN running state
   2e-5 of max(1, |value|)), then one inference ``output`` alike; with
   ``FUSED_BN_RELU_BWD`` off and on.

17. the training loop: (a) LeNet at f32, batch 64, 8 batches (TF32 off,
   cuDNN deterministic): ``fit(DevicePrefetchIterator(ArrayDataSetIterator
   (shuffle=True), depth=2), epochs=2)`` against ``fit(x_i, y_i)`` on the
   same batches, parameters bit-equal; ``evaluate`` on the card against an
   ``Evaluation`` of the same outputs on the CPU, confusion matrices equal;
   ``EarlyStoppingTrainer`` (``MaxEpochsTerminationCondition(3)``,
   ``DataSetLossCalculator``, ``InMemoryModelSaver``), the best model's
   recomputed score within 1e-6 relative of the recorded one;
   ``writeModel`` and a restore on the card, outputs bit-equal. (b)
   ResNet-50 at phase 15's cell from 8 host-resident uint8 224x224x3
   batches (``RandomState(0)``, one-hot labels) through
   ``ArrayDataSetIterator`` and ``DevicePrefetchIterator(dtype=bfloat16)``
   at depth 2 and depth 0, 2 warm-up and 6 timed steps a run, three
   rounds in turns with the same steps on a batch already on the card
   (phase 15's step beside them): finite losses, 53 launches of each
   batch-norm kernel a step, ms per step, images/s, the ETL wait per
   step, the host staging, the prefetch overlap, the copies' ms per batch
   on the card and to the end of the cast, a bare copy of the same bytes
   as a yardstick, with the card's ``nvidia-smi`` line; then
   ``evaluate`` over 2 held-out batches, its accuracy equal to argmax
   (output) == argmax(label) computed directly. (c) The char-LSTM at
   phase 9's cell: 3 steps of ``fit(ArrayDataSetIterator(...))`` against
   ``fit(x, y)`` on the same batches from the same weights, B5's forward
   and backward launches equal, losses within 1e-5 relative. No prefetch
   or ETL thread may be left.
18. the recurrent graph: (a) ``Seq2SeqLSTM(16, 16, hidden=128, t_in=12,
   t_out=12)`` (216,080 parameters) at batch 64 on the reversal task, f32
   with TF32 off: 3 Adam steps (epsilon 1e-4) on the card and on the CPU
   from one numpy tree, then ``output``: unmasked; masked (source lengths
   4-12 from the seed, a features mask on ``encoderInput``, the same mask
   as ``LastTimeStepVertex``'s second input, a labels mask on the output);
   AdamW under an ``ExponentialSchedule``; losses within 1e-5 relative,
   parameters within 2e-5, B5 2 + 2 launches a step. (b) The timed cell:
   the same model at batch 256 in bf16, 2 warm-up and 10 timed steps, ms
   a step, target tokens/s (256 x 12 a step), peak memory, the device's
   idle share of a profiled step, both LSTMs on B5's cluster route; then
   hidden 512 (one warm-up, 3 timed steps) on the wide route. (c)
   ``rnnTimeStep``: 12 single steps at f32 on (a)'s graphs against the
   stepwise formula (every recurrent vertex advances, so the decoder's
   step t sees the encoder's step t) and against the CPU's steps, one
   12-step call against ``output()``, a batch change refused; then ms a
   step at batch 256 in bf16, 2 forward launches a step on the cluster
   route. (d) ``EmbeddingLayer(77, 128)`` on ``[N, T, 1]`` ids ->
   ``Bidirectional(LSTM(128), CONCAT)`` -> masked average pooling ->
   ``OutputLayer(2)`` at batch 64 x 200 with lengths from the seed, 3 Adam
   steps card against CPU at f32, B5 2 + 2 launches a step. The phase's
   B5 launches are added to B5's rows.
19. the precision policies: (1) the char-LSTM of phase 9 (batch 256 x
   200, hidden 256, vocab 77, Adam 1e-3, standard BPTT) under
   ``float32``, ``mixed_bfloat16``, ``bfloat16`` (the identity, phase 9's
   cell) and ``mixed_float16``: 2 warm-up and 10 timed steps each, ms a
   step, tokens/s, peak memory, the idle share of 3 profiled steps, B5's
   launches by route (under mixed_bfloat16 every one on the cluster
   route), the masters' and the updater state's dtypes (f32 under the
   mixed policies), and every loss after the loss scale settled finite.
   (2) ``ResNet50(num_classes=1000, precision="mixed_bfloat16")`` at
   phase 15's cell: ms a step and images/s beside phase 15's, peak
   memory, 53 launches of each batch-norm kernel a step on f32 inputs
   (the islands), the device time by group of a profiled step and the
   idle share. (3) ``AlexNet(num_classes=1000)`` (62,378,344 parameters)
   under mixed_bfloat16 at batch 128 x 224x224x3: ms a step, images/s,
   the LRN layers on f32. (4) The narrow char-LSTM (hidden 64, batch 16 x
   50) and the cut ResNet under mixed_bfloat16 and mixed_float16: 3
   Nesterovs steps on the card against 3 on the CPU from one numpy tree
   (tolerances ``PREC_LSTM_TOL`` and ``PREC_RESNET_TOL``); under
   mixed_float16 a forced overflow (parameters and updater state
   bit-equal, the scale halved, one overflow and one skipped step) and the
   doubling after ``growth_interval`` (2) clean steps, the loss-scale
   state equal on both devices. The phase's B5 and batch-norm launches
   are added to their rows.
20. the vision zoo: (a) ``zoo.YOLO2()`` at its published widths
   (608x608x3, 80 COCO classes, 5 anchors, a 19x19x425 output) under
   ``mixed_bfloat16`` through ``ComputationGraph.fit`` at batch 16 on a
   synthetic batch with YOLO labels from a numpy seed: 2 warm-up and 10
   timed steps, ms a step, images/s, peak memory, finite falling losses,
   one launch of each batch-norm kernel per layer per step on f32 inputs,
   a profiled step's idle share and device time by group (batch norm,
   conv, activation/add, loss, updater); (b) ``output()`` of that batch
   and ``YoloUtils.getPredictedObjects`` (decode and NMS on the card), ms
   of each, then the cut YOLO2 (128x128, 3 classes) with planted
   detections: the card's lists equal the CPU's; ties take the first
   index on the card (NMS, anchor responsibility); (c) ``zoo.Xception()``
   at 299x299x3, 1000 classes, ``mixed_bfloat16``, batch 32: ms a step,
   images/s, peak memory, idle share; (d) VGG16, VGG19, Darknet19,
   TinyYOLO, SqueezeNet, UNet, InceptionResNetV1, FaceNetNN4Small2 and
   NASNet at their defaults (f32), two steps at batch 4: parameters, ms,
   peak memory, finite losses and parameters that moved; (e) YOLO2,
   Xception, NASNet and UNet at the CPU tests' cut sizes, card against
   CPU at f32 (``VISION_TOL``); (f) the three batch-norm kernels against
   their plain versions at the zoo's new shapes (``VISION_BN_SHAPES``), in
   f32 and bf16, with each kernel's event ms and share of its bound. The
   batch-norm launches of (a)-(d) are added to their rows.
21. network surgery and pretraining: (a) ``zoo.VGG16()`` at its
   published widths (224x224x3, 1000 classes, f32), edited by
   ``TransferLearning.Builder`` as dl4j-examples' EditLastLayerOthersFrozen
   (Nesterovs(5e-5, 0.9), ``setFeatureExtractor(19)``, the head replaced
   by a 5-class softmax) and fine-tuned at batch 32: ms a step beside the
   ms of ``output()`` on the same batch (the step held to
   ``TRANSFER_STEP_BOUND`` times it), images/s, peak memory, a profiled
   step's idle share, the unfrozen source's step; every frozen parameter
   and the source bit-identical after the steps, no ``grad_fn`` out of a
   frozen layer, only the head handed to ``torch.autograd.grad``; (b)
   ``TransferLearningHelper`` on it: featurize 256 images, 10 head steps
   on the features, the head written back equal to ``unfrozenMLN()``'s;
   (c) ``zoo.ResNet50()`` in bf16 through ``TransferLearning.GraphBuilder``
   (``setFeatureExtractor("avg_pool")``, ``nOutReplace("fc", 5)``) at
   batch 64: ms a step, idle share and device time by group (the frozen
   batch norms run the plain inference formula), peak memory, no
   batch-norm kernel launch, frozen parameters and running statistics
   bit-identical; (d) the VAE of dl4j-examples' VaeMNISTAnomaly
   (784-256-256-32, Bernoulli, leaky ReLU, Adam(1e-3), l2 1e-4) pretrained
   by ``pretrainLayer`` for 50 steps at batch 128 on synthetic data in [0,
   1] (a falling -ELBO), ``reconstructionLogProbability`` of 1,024
   examples over 16 samples, and 5 steps of ``ComputationGraph
   .pretrainLayer``; (e) every ``IDropout`` and ``IWeightNoise`` on a
   [32, 56, 56, 256] tensor and on VGG16's fc1 weight within its
   distribution's tolerances, every constraint against its CPU result
   (1e-6), and a small MLN with ``Dropout(0.5)``, ``DropConnect(0.5)`` and
   ``MaxNormConstraint(2.0)`` trained 5 steps with its column norms held;
   (f) card against CPU at f32 at the tests' cut sizes
   (``TRANSFER_TOL``): a frozen MLN fine-tune, a graph transfer with
   ``nOutReplace``, a ``FrozenLayerWithBackprop`` GAN step, an
   AutoEncoder pretrain and an OCNN fit.
22. the rest of the layer framework: (a) C3D (Tran et al. 2015: eight
   ``Convolution3D`` 3x3x3 Same of 64-512, five max
   ``Subsampling3DLayer``, pool5 1x4x4x512 = 8,192 features, two fc of
   4096 with dropout 0.5, 487 classes) at bf16, batch 30 of 16 x 112 x
   112 x 3 clips: its parameters against the builder's reckoning, 2
   warm-up and 10 timed steps (ms a step, clips/s, peak memory), a
   profiled step's idle share and device time by group (conv, pool,
   matmul, softmax, elementwise/other); (b) CapsNet (Sabour et al. 2017:
   Conv 256 9x9, ``PrimaryCapsules`` 32 x 8, ``CapsuleLayer`` 10 x 16 with
   3 routings, ``CapsuleStrengthLayer``, softmax; 6,804,334 parameters) at
   f32, batch 128 of learnable synthetic 28x28x1 images: 30 steps, the
   loss falling, every capsule shorter than 1; (c) TensorFlow's GRU
   character model (``EmbeddingSequenceLayer(65, 256)``, ``GRU(1024)``
   with both biases, softmax 65; 4,021,569 parameters) at bf16, batch 64 x
   100: ms a step, tokens/s, 200 sampled characters through
   ``rnnTimeStep``, stepping against ``output()`` (``GRU_STEP_TOL``), the
   GRU layer alone beside cuDNN's ``nn.GRU`` (a yardstick, not on the
   path); then ``GravesBidirectionalLSTM(256)`` on the same batch (two
   forward and two backward B5 launches a step, its output bit-equal to
   ``Bidirectional(LSTM(256), CONCAT)``'s) and ``MaskZeroLayer(LSTM(256))``
   on padded rows (the padded steps zero); (d) ``SelfAttentionLayer`` ->
   ``RecurrentAttentionLayer`` -> ``LearnedSelfAttentionLayer(4)`` ->
   average pooling -> ``OutputLayer(2)`` at d_model 768, 12 heads, T 128,
   batch 32, bf16: ms a step and the recurrent layer's loop's share of
   it; (e) card against CPU at f32 at the tests' cut sizes
   (``LAYERS_TOL``): every class of the slice in nine networks, and the
   builder's ``dropOut`` default's kept fraction on both devices. The
   phase's B5 launches are added to B5's rows.
23. resilience, the training infrastructure: (a) phase 9's char-LSTM
   (vocabulary 77, hidden 256, bf16, Adam, batch 256 x 200) over a
   ``ListDataSetIterator`` of 12 synthetic batches for 2 epochs,
   preempted at step 9 by ``ChaosConfig(preempt_at_step=9)`` and resumed
   in a fresh model from its bundle: parameters and Adam state bit-equal
   to an uninterrupted run, B5's launches two a step; (b) the same cell
   under ``ChaosConfig(nan_steps=(4,))``, ``snapshot_every=2``: one
   rollback, one skipped batch, finite parameters, the registry's
   counters; the guard's cost as ms a step at ``divergence_window=16``
   against 0, timed in turns; (c) the cell under ``mixed_float16`` with a
   batch that overflows f16: the loss-scale gauge and the overflow and
   skipped-step counters in ``to_prometheus()``, read by
   ``_peek_loss_scale``, and no rollback; (d), run first, phase 15's own
   ResNet-50 network with
   ``HealthMonitor(frequency=10)`` over 20 steps: ``first_nonfinite``
   -1, a gauge per layer, ``dl4j_tpu_mfu`` against the table's 989
   TFLOP/s, ms a step monitored against unmonitored in turns; an
   unmonitored step runs the same operations as phase 15's step (the
   profiler's host-side count, by name; its device records of a long
   process lose some kernels, so their count is reported beside it) and
   launches each batch-norm kernel once per layer, and the same after a
   monitored run; 3 monitored steps, and 3 unmonitored ones after the
   FLOP count, leave the parameters equal to 3 unmonitored ones (cuDNN's
   deterministic algorithms for that check);
   (e) ``Seq2SeqLSTM`` at hidden 512 (B5's wide route), bf16, batch 256,
   preempted and resumed bit-equal through the graph's guarded fit; (f)
   ``DevicePrefetchIterator`` at depth 2 under a chaos transfer failure
   rate: retries counted, then every batch of a poisoned stream
   quarantined; (g) a chaos hang past a 0.5 s ``step_deadline``: one
   stall with its stack dump; (h) the Chrome trace exported to a temp
   directory and parsed. The phase's B5 launches are added to B5's rows.
24. SameDiff by name: (a) BERT-base MLM (12 layers, d 768, 12 heads, FFN
   3,072, vocab 30,522, max_len 512; f32, dropout off) as a SameDiff
   graph built through the public API only (``bert_mlm_graph``: the
   embeddings, post-LN blocks, ``flash_attention`` by name with a key
   mask, ``top_k`` + ``take_along_axis`` capacity, the tied head), at
   batch 128 x 128 with rows padded at random lengths in 64-128 and 20
   masked positions a row; its forward loss against
   ``TransformerEncoder.encode`` + ``mlm_head_loss`` on the same numpy
   tree (1e-4 relative), its gradients (cosine >= 0.999 per parameter),
   5 ``fit`` steps of Adam(1e-4) with finite losses and B1 launched 12 +
   12 times a step (counts set to 0 before the fit), one more profiled
   step (idle share), ``save`` with the updater state, ``load`` on the
   card and one more step equal to the same step in memory; the
   encoder's own f32 flash step as a yardstick; (b) a counted
   ``whileLoop`` carrying float state trained by ``fit``, ``ifCond`` and
   ``case_graph``, each equal to the CPU's (1e-5), a dynamic loop whose
   ``fit`` raises JAX's documented error, and the host's ms per loop
   iteration and per branch; (c) ``flash_attention``,
   ``fused_adam_master_update`` (BERT-base's flat size) and
   ``paged_attention`` by name, once each against their plain versions,
   each counter up by one; (d) every name the slice registers
   (``tools/op_cases.py``) once on CUDA tensors against the CPU (1e-4 of
   max(1, |x|), integers exact, every result on the card), and NDArray
   ``get`` / ``put`` / TAD on a card array. Phase 24's ``fit`` launches
   of B1 are added to B1's rows.
25. TensorFlow import (BASELINE config 4, BERT-base via SameDiff TF
   import): (a) the committed frozen ``TFBertForMaskedLM(BertConfig())``
   graph (``tools/make_tf_fixture.py``: 3,053 nodes at ``[None, 128]``,
   its 89 large constants emptied) with its weights seeded back by
   ``graphdef_wire.seeded_consts`` (the whole ~439 MB GraphDef), parsed
   and imported by ``TFGraphMapper.importGraph`` on the card (seconds,
   nodes, ops); (b) ``output()`` at 2 x 128, f32, TF32 off, against TF's
   stored golden (``logits[:, :4, :8]`` and row sums, rtol 2e-3 / atol
   2e-4) and against the same graph imported and run on the CPU in this
   process (1e-4 of the largest |logit|); (c) the float constants of rank
   >= 2 promoted, per-token cross-entropy over the vocabulary, 5
   ``SameDiff.fit`` steps of Adam at batch 32 x 128 with finite, falling
   losses, the median step, tokens/s, one more profiled step (device
   kernels, aten operations, idle share). No hand kernel is on this path:
   every kernel counter must stay as it was. The phase must finish
   within 90 s.
26. ONNX import (a full-width ResNet-50: torchvision's architecture, 1,000
   classes, 224 x 224): (a) the whole model (175 nodes, 267 initializers,
   ~102.4 MB: ``tools/make_onnx_fixture.py``'s fixture with its
   initializers filled by ``onnx_proto.seeded_initializers``) imported by
   ``OnnxImport.importGraph`` on the card (seconds, nodes, ops, bytes
   uploaded); (b) ``output()`` at 2 x 3 x 224 x 224, f32, TF32 off,
   against torch's stored golden (logits and row sums, rtol 1e-3 / atol
   1e-3) and against the same model imported and run on the CPU in this
   process (1e-4 of the largest |logit|); (c) the float initializers of
   rank >= 2 promoted, softmax cross-entropy over the 1,000 logits, 5
   ``SameDiff.fit`` steps of Adam(1e-4) at batch 32 with finite, falling
   losses, the median step, images/s, one more profiled step (device
   kernels, aten operations, idle share, the share of device time in the
   NCHW<->NHWC brackets' layout copies). No hand kernel is on this path:
   every kernel counter must stay as it was. The phase must finish within
   60 s.

The peak rates that the bounds and the MFU divide by come from the
port's ``profiler/flops.py`` (its row for the card's name).

Prints progress lines, then a JSON line with every kernel's numbers, the
card's ``nvidia-smi`` line, and last the JSON result line.

``python3 chip_smoke.py tail-times TAG``, run from the root of any tree of
the port (this file given by its path), prints only the residual-tail
kernel's times at the four joins in bf16 and f32 (tagged TAG), for the
port found from the current directory: an earlier design can be timed in
the same chip call as this one. ``python3 chip_smoke.py resnet50-step
TAG`` runs phase 15 alone the same way, ``python3 chip_smoke.py
lstm-train TAG`` phase 9, ``python3 chip_smoke.py training-loop``
phase 17, ``python3 chip_smoke.py seq2seq`` phase 18, ``python3
chip_smoke.py precision`` phase 19, ``python3 chip_smoke.py vision``
phase 20, ``python3 chip_smoke.py transfer`` phase 21 and ``python3
chip_smoke.py layers`` phase 22, ``python3 chip_smoke.py
resilience`` phase 23, ``python3 chip_smoke.py samediff`` phase 24 and
``python3 chip_smoke.py tfimport`` phase 25 and ``python3 chip_smoke.py
onnximport`` phase 26.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.join(HERE, "deeplearning4j_tpu_torch")

# the card's peaks, from the port's profiler/flops.py (set_peaks): HBM
# bandwidth, the f32 rate outside the tensor cores and the dense bf16
# tensor-core rate
HBM_BYTES_PER_S = F32_FLOPS = BF16_FLOPS = math.nan

# the training slice: bench.py's BERT-base MLM cell
TRAIN_BATCH, TRAIN_SEQ, MASKED_PER_ROW, MASKED_CAPACITY = 96, 128, 19, 20
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 3
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_update",
                  "lstm_recurrence", "conv_bn_stats", "residual_tail",
                  "batch_norm")

SLOTS, PAGE, HEADS, HEAD_DIM, LAYERS = 8, 16, 12, 64, 12
MAX_CONTEXT = 512
PAGES_PER_SLOT = MAX_CONTEXT // PAGE
DEVICE = "cuda"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------- device
def set_peaks() -> None:
    """The peak rates of this card from the port's ``profiler/flops.py``
    (the table the health monitor's MFU divides by too)."""
    global HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS
    from deeplearning4j_tpu_torch.profiler import flops

    bf16, f32 = flops.peak_flops("bf16"), flops.peak_flops("f32")
    hbm = flops.peak_hbm_gbps()
    check(None not in (bf16, f32, hbm),
          f"profiler/flops.py has no row for {flops.device_kind()!r}")
    BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S = bf16, f32, hbm * 1e9


def phase_device() -> str:
    set_peaks()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    say("device", f"nvidia-smi: {line}")
    say("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}; peaks from "
                  f"profiler/flops.py: bf16 {BF16_FLOPS / 1e12:g}, f32 "
                  f"{F32_FLOPS / 1e12:g} TFLOP/s, HBM "
                  f"{HBM_BYTES_PER_S / 1e9:g} GB/s")
    # state the f32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


# ----------------------------------------------------------------- build
def phase_build() -> None:
    from deeplearning4j_tpu_torch.ops import native

    global BN_YARDSTICK
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.tools import bn_probe

    t0 = time.perf_counter()
    # the batch norm's two-launch design, timed in turns in phase 11b: its
    # nvcc runs beside the sources' (the thread only waits on it)
    pool = ThreadPoolExecutor(1)
    BN_YARDSTICK = pool.submit(
        bn_probe.build, {"two launches": bn_probe.read(bn_probe.TWO_LAUNCH)})
    pool.shutdown(wait=False)
    paths = native.build(KERNEL_SOURCES)
    say("build", f"{len(paths)} sources in {time.perf_counter() - t0:.2f} s")
    # ptxas -v for the instantiations the slices run: head_dim 64 is the
    # template argument 2 (vectors of 32) of paged attention and 64 of
    # flash attention (and 128, where the bf16 dk/dv accumulators are the
    # spill risk); the Adam kernels have no template; the LSTM kernels at
    # one row per thread (the char-LSTM shape's plan) and the backward's
    # cluster route at H=256 (both row tiles)
    marks = {"paged_attention": ("Li2E",),
             "flash_attention": ("Li64E", "Li128E", "deep_kernel"),
             "fused_update": ("",),
             "lstm_recurrence": ("Li1E", "cluster_kernelILi4E",
                                 "wide_kernel"),
             "conv_bn_stats": ("nv_bfloat16",),
             "residual_tail": ("residual_tail_kernelI",),
             "batch_norm": ("nv_bfloat16Li8E",)}
    for name in KERNEL_SOURCES:
        log = native.build_logs.get(name, {})
        say("build", f"{os.path.relpath(paths[name], HERE)}: "
                     f"{log.get('seconds', 0.0):.2f} s")
        lines = str(log.get("output", "")).splitlines()
        for i, ln in enumerate(lines):
            mark = next((m for m in marks[name] if m in ln), None)
            if "Compiling entry function" in ln and mark is not None:
                found = re.search(r"(paged_attention_kernel"
                                  r"|flash_(?:fwd|bwd_[a-z]+)(?:_tc|_deep)?"
                                  r"_kernel"
                                  r"|fused_adam_(?:vec4|scalar)"
                                  r"|lstm_(?:fwd|bwd)(?:_cluster|_wide)?"
                                  r"_kernel"
                                  r"|conv_bn_stats(?:_tc)?_kernel"
                                  r"|residual_tail_kernel"
                                  r"|bn_(?:reduce|apply)_kernel)", ln)
                tc_conv = re.search(
                    r"conv_bn_stats_tc_kernelILi(\d+)ELi(\d+)E", ln)
                cl = re.search(r"cluster_kernelILi(\d)ELi(\d)E", ln)
                wide = "wide_kernel" in ln
                kind = ("bf16" if "nv_bfloat16" in ln or "_tc_" in ln or cl
                        or wide else "f32") \
                    + (" queries, fp8 pools" if "Fp8E4M3" in ln else "") \
                    + (", tensor cores" if any(k in ln for k in
                                               FLASH_TC_KERNELS) else "") \
                    + (f", wgmma, taps {tc_conv.group(1)}, BN "
                       f"{tc_conv.group(2)}" if tc_conv else "") \
                    + (", hd 128" if mark == "Li128E" else "") \
                    + (f", mma.sync, H {64 * int(cl.group(1))}, "
                       f"{16 * int(cl.group(2))} rows per cluster"
                       if cl else "") \
                    + (", mma.sync, wide route" if wide else "") \
                    + (f", template <{tail.group(1)}>" if (tail := re.search(
                        r"residual_tail_kernelI(\w+?)EEv", ln)) else "")
                info = [x.split(":", 1)[-1].strip()
                        for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                say("build", f"  ptxas {found.group(1) if found else ln} "
                             f"({kind}): {'; '.join(info)}")
            if "wgmma" in ln and "serialized" in ln:
                say("build", f"  ptxas warning: {ln.strip()}")
    check_tensor_core_sass(paths["flash_attention"], FLASH_TC_KERNELS,
                           r"\bH(?:G)?MMA\b", "head-dim", 4)
    check_tensor_core_sass(paths["conv_bn_stats"], CONV_TC_KERNELS,
                           r"\bHGMMA\b", "(taps, BN)", 4)
    check_tensor_core_sass(paths["lstm_recurrence"], LSTM_TC_KERNELS,
                           r"\bHMMA\b", "(H, rows)", 6)
    check_tensor_core_sass(paths["lstm_recurrence"], LSTM_WIDE_KERNELS,
                           r"\bHMMA\b", "route", 1)
    # paged attention's 8-row tiles under bf16 queries (pools bf16 or fp8,
    # head_dim 32, 64, 96, 128: template arguments 1-4 and rows 8)
    check_tensor_core_sass(paths["paged_attention"], PAGED_TC_KERNELS,
                           r"\bHMMA\b", "(pool, head_dim)", 8,
                           select=r"kernelI13__nv_bfloat16.*?Li[1234]ELi8EE")


#: the bf16 flash-attention kernels, which must run on the tensor cores
FLASH_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                    "flash_bwd_dq_tc_kernel")
#: the bf16 conv + BN-stats route that must issue wgmma (HGMMA in SASS)
CONV_TC_KERNELS = ("conv_bn_stats_tc_kernel",)
#: the LSTM cluster routes, whose gate (forward) and dh and gate
#: (backward) products must run on the tensor cores (HMMA in SASS)
LSTM_TC_KERNELS = ("lstm_fwd_cluster_kernel", "lstm_bwd_cluster_kernel")
#: the LSTM wide route (bf16, H past 256): its gate and dh products must
#: run on the tensor cores too
LSTM_WIDE_KERNELS = ("lstm_fwd_wide_kernel", "lstm_bwd_wide_kernel")
#: the paged-attention kernel, whose multi-row bf16 tiles must run on the
#: tensor cores
PAGED_TC_KERNELS = ("paged_attention_kernel",)


def check_tensor_core_sass(lib_path: str, kernels, pattern: str, per: str,
                           instances: int, select: str = "") -> None:
    """``cuobjdump -sass`` of a built library: each of the ``instances``
    instantiations of every kernel in ``kernels`` (those whose mangled name
    matches ``select``, where given) must hold tensor-core instructions
    matching ``pattern`` (``HMMA``/``HGMMA`` for flash attention, ``HGMMA``
    for the conv route, ``HMMA`` for the LSTM and paged-attention routes),
    or the run fails."""
    from deeplearning4j_tpu_torch.ops import native

    tool = os.path.join(os.path.dirname(native.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        kernel = next((k for k in kernels if k in name), None)
        if kernel is not None and re.search(select, name):
            counts.setdefault(kernel, []).append(
                len(re.findall(pattern, fn)))
    for kernel in kernels:
        found = counts.get(kernel, [])
        check(len(found) == instances and min(found) > 0,
              f"{kernel}: {pattern} per {per} instance {found} (cuobjdump "
              f"-sass); need {instances} instances, each > 0")
        say("build", f"  SASS {kernel}: {pattern} per {per} instance "
                     f"{found}")


# ---------------------------------------------------------------- kernel
#: tolerance against the plain version run at f32 on the same (dequantized)
#: values, by the kinds of ``tools/attention_probe.py`` (pool kind and
#: query dtype): f32 queries 1e-5, bf16 queries 2e-2 (the bf16 output
#: rounding)
KIND_TOL = {"f32": 1e-5, "bf16": 2e-2, "fp8-f32": 1e-5, "fp8-bf16": 2e-2}


def f32_tree(kv):
    """The pools at f32 on the same values: fp8 pages dequantized in f32
    (what the kernel computes on), float pools widened."""
    if "k_scale" in kv:
        return {n: kv[n].float() * kv[n + "_scale"][..., None, None]
                for n in ("k", "v")}
    return {n: t.float() for n, t in kv.items()}


def library_attention(q, kv, layer, tables, qbase):
    """Yardstick only, never called by the port: a page gather (and, for
    fp8 pools, the dequantization in the query's dtype) followed by
    ``scaled_dot_product_attention`` with the flat-position mask (no one
    library call walks a page table)."""
    N, H, Q, hd = q.shape
    P, ps = tables.shape[1], kv["k"].shape[3]
    t = tables.long()

    def flat(name):
        pool = kv[name]
        if "k_scale" in kv:
            pages = pool.view(torch.uint8)[layer][t].view(pool.dtype) \
                .to(q.dtype) * kv[name + "_scale"][layer][t][..., None, None] \
                .to(q.dtype)
        else:
            pages = pool[layer][t]
        return pages.permute(0, 2, 1, 3, 4).reshape(N, H, P * ps, hd)

    qpos = qbase.long()[:, None] + torch.arange(Q, device=q.device)
    mask = (torch.arange(P * ps, device=q.device)[None, None, None, :]
            <= qpos[:, None, :, None])
    return F.scaled_dot_product_attention(q, flat("k"), flat("v"),
                                          attn_mask=mask)


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, kv, tables, qbase):
    """(bound_ms, bound_by, bytes, flops) for one layer call on these
    inputs: each live K/V page read once (pages past a row's last query
    position are masked and need not be read) with its two scales when
    fp8, q/tables/qbase read and the output written once; 4 * hd flops
    per admitted (query, key, head), plus one multiply per dequantized
    fp8 element, at the tensor-core rate of the queries' type (bf16) or
    the f32 rate, as :func:`flash_bound` counts."""
    N, H, Q, hd = q.shape
    ps = kv["k"].shape[3]
    tab = tables.cpu().numpy()
    qb = qbase.cpu().numpy().astype(np.int64)
    live = set()
    admitted = 0
    for n in range(N):
        n_live = min(tab.shape[1], (int(qb[n]) + Q - 1) // ps + 1)
        live.update(int(p) for p in tab[n, :n_live])
        admitted += sum(min(int(qb[n]) + i + 1, tab.shape[1] * ps)
                        for i in range(Q))
    page_bytes = H * ps * hd * kv["k"].element_size()
    if "k_scale" in kv:
        page_bytes += H * 4
    nbytes = (2 * len(live) * page_bytes + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + qbase.numel() * 4)
    flops = 4 * hd * H * admitted
    if "k_scale" in kv:
        flops += 2 * len(live) * H * ps * hd
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def check_kernel(label: str, kind: str, q, kv, tables, qbase) -> float:
    """The kernel against the plain version at f32 on the same
    (dequantized) values, at a middle layer; returns the max abs
    error."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    layer = LAYERS // 2
    got = pa.paged_attention(q, kv, layer, tables, qbase)
    want = pa.paged_attention_reference(q.float(), f32_tree(kv), layer,
                                        tables, qbase)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"kernel output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = float((got.float() - want).abs().max())
    tol = KIND_TOL[kind]
    say("kernel", f"{label} {kind}: max abs err {err:.3e} (tolerance "
                  f"{tol:g})")
    check(err <= tol, f"kernel disagrees with the reference at {label} "
                      f"{kind}: {err:.3e} > {tol:g}")
    return err


#: N=1 query positions of the prefix-prefill checks: page-aligned and
#: mid-page (a copy-on-write or session resume point)
PREFIX_QBASE = {32: (192, 200), 64: (192, 200), 128: (224, 287), 512: (0,)}


def time_row(name: str, label: str, q, kv, tables, qbase,
             max_err: float) -> dict:
    """The kernel's time at one shape beside its plain version's, the
    library yardstick's and the bound; launches cycle over the 12 layers
    (151 MB of float pools, more than the 50 MB L2) so each one reads its
    pages from HBM as the serving path does. Two calls must be bit-equal.
    Then the profiler's device time per call and the host's cost per call
    (``tools/attention_probe.py``)."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    a = pa.paged_attention_kernel(q, kv, 0, tables, qbase)
    b = pa.paged_attention_kernel(q, kv, 0, tables, qbase)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{label}: two kernel calls differ")
    plan = ap.plan_of(q, kv, tables)
    lib = library_attention(q, kv, 0, tables, qbase)
    ref = pa.paged_attention_reference(q.float(), f32_tree(kv), 0, tables,
                                       qbase)
    lib_err = float((lib.float() - ref).abs().max())
    iters = 240

    def kernel(i):
        pa.paged_attention_kernel(q, kv, i % LAYERS, tables, qbase)

    kern_ms = cuda_ms(kernel, iters)
    plain_ms = cuda_ms(lambda i: pa.paged_attention_reference(
        q, kv, i % LAYERS, tables, qbase), iters)
    lib_ms = cuda_ms(lambda i: library_attention(
        q, kv, i % LAYERS, tables, qbase), iters)
    kern_ms2 = cuda_ms(kernel, iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(q, kv, tables, qbase)
    say("kernel", f"{label}: kernel {kern_ms:.4f} / {kern_ms2:.4f} ms "
                  f"({plan}), plain {plain_ms:.4f} ms, library (yardstick "
                  f"the port never calls; max abs err {lib_err:.3e} vs the "
                  f"reference) {lib_ms:.4f} ms")
    peak = "989 TFLOP/s bf16" if q.dtype == torch.bfloat16 \
        else "67 TFLOP/s f32"
    say("kernel", f"  bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B at "
                  f"3.35 TB/s, {flops} flop at {peak}); kernel at "
                  f"{nbytes / (min(kern_ms, kern_ms2) * 1e-3) / 1e9:.1f} GB/s")
    say_times(q, kv, tables, qbase)
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
            "replaces": "deeplearning4j_tpu/ops/paged_attention_pallas.py:203",
            "launches": 0, "max_abs_err": max_err,
            "ms": min(kern_ms, kern_ms2), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def say_times(q, kv, tables, qbase) -> None:
    """The profiler's device time, the event time and the host's cost per
    call at one shape (``tools/attention_probe.py``'s ``shape_times``)."""
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    r = ap.shape_times(q, kv, tables, qbase)
    say("kernel", f"  event {r['event_ms'] * 1e3:.1f} us per call, device "
                  f"{r['device_us']:.1f} us per call (profiler, "
                  f"{r['traced']} of 48 launches traced), host "
                  f"{r['host_us']:.1f} us per wrapper call, the C entry "
                  f"alone {r['c_entry_us']:.1f} us")


def check_warp_counts() -> dict:
    """The kernel at every warp count a block takes (1-8 where their rings
    fit one block's shared memory, so warps that get no chunk, and warps
    whose chunks a tile's early rows cannot see),
    at a mixed decode case (shared pages, null-page tails, qbase 0 and
    full context) and a two-tile verify case, in every pool kind, against
    the plain version at f32; at the planned count it must equal the
    wrapper's output bit for bit. Returns the largest error by pool kind
    ("float", "fp8")."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    worst = {"float": 0.0, "fp8": 0.0}
    for Q in (1, 9):
        for kind in ap.KINDS:
            q, kv, tables, qbase = ap.kernel_case(Q, kind, seed=30 + Q)
            layer = LAYERS // 2
            want = pa.paged_attention_reference(q.float(), f32_tree(kv),
                                                layer, tables, qbase)
            plan = ap.plan_of(q, kv, tables)
            wrapped = pa.paged_attention_kernel(q, kv, layer, tables, qbase)
            rows = 1 if Q == 1 else 8
            for warps in (w for w in range(1, 9) if pa.block_smem(
                    rows, HEAD_DIM, kv["k"].element_size(), tables.shape[1],
                    w) <= pa.SMEM_PER_SM - 1024):
                ints = pa.pack_ints(q, kv["k"], tables,
                                    plan._replace(warps=warps), 0,
                                    "k_scale" in kv)
                got = pa.launch(q, kv, layer, tables, qbase, 0, ints)
                err = float((got.float() - want).abs().max())
                check(err <= KIND_TOL[kind],
                      f"Q={Q} {kind} at {warps} warps: {err:.3e} > "
                      f"{KIND_TOL[kind]:g}")
                check(warps != plan.warps or torch.equal(got, wrapped),
                      f"Q={Q} {kind}: the wrapper's call differs from a "
                      f"launch at its planned {warps} warps")
                pool = "fp8" if kind.startswith("fp8") else "float"
                worst[pool] = max(worst[pool], err)
    torch.cuda.synchronize()
    say("kernel", f"1-8 warps per block where they fit (Q 1 and 9; f32, "
                  f"bf16, fp8 under "
                  f"bf16 and f32 queries): max abs err {worst['float']:.3e} "
                  f"(float pools), {worst['fp8']:.3e} (fp8 pools)")
    return worst


def phase_kernel() -> dict:
    """Every shape the serving paths give the kernel, then its times at
    the decode (float and fp8 pools), verify and prefix shapes. Returns
    the kernel rows by name."""
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    errs = {"float": 0.0, "fp8": 0.0, "verify": 0.0, "prefix": 0.0}
    # the largest error by kind on single rows (the CUDA cores) and 8-row
    # tiles (under bf16 queries up to head_dim 128, the tensor cores, with
    # the probabilities and fp8's dequantized K and V rounded to bf16)
    by_path = {}

    def note(kind, Q, err):
        key = (kind, "1-row" if Q == 1 else "8-row")
        by_path[key] = max(by_path.get(key, 0.0), err)

    # decode: N=8, Q=1 (and the old Q=4 case), float and fp8 pools
    for kind in ap.KINDS:
        for Q in ((1, 4) if kind in ("f32", "bf16") else (1,)):
            for full in (False, True):
                args = ap.kernel_case(Q, kind, seed=Q, full=full)
                err = check_kernel(f"decode N={SLOTS} Q={Q} "
                                   f"{'full' if full else 'mixed'}", kind,
                                   *args)
                key = "fp8" if kind.startswith("fp8") else "float"
                errs[key] = max(errs[key], err)
                note(kind, Q, err)
    # verify: N=8, Q = k + 1 for k in {2, 4, 8}
    for Q in (3, 5, 9):
        for kind in ap.KINDS:
            err = check_kernel(f"verify N={SLOTS} Q={Q}", kind,
                               *ap.kernel_case(Q, kind, seed=10 + Q))
            errs["verify"] = max(errs["verify"], err)
            note(kind, Q, err)
    # prefix prefill: N=1, Q = the suffix bucket, page-aligned and mid-page
    for Q, bases in PREFIX_QBASE.items():
        for qb in bases:
            for kind in ap.KINDS:
                err = check_kernel(f"prefix N=1 Q={Q} qbase={qb}", kind,
                                   *ap.kernel_case(Q, kind, seed=20 + Q, N=1,
                                                   qbase=qb))
                errs["prefix"] = max(errs["prefix"], err)
                note(kind, Q, err)
    say("kernel", "max abs err by kind and tile: " + ", ".join(
        f"{kind} {rows} {err:.3e} (of {KIND_TOL[kind]:g})"
        for (kind, rows), err in sorted(by_path.items())))
    for pool, err in check_warp_counts().items():
        errs[pool] = max(errs[pool], err)
    rows = {}
    rows["paged_attention"] = time_row(
        "paged_attention", f"decode N={SLOTS} H={HEADS} Q=1 hd={HEAD_DIM} "
        f"ps={PAGE} P={PAGES_PER_SLOT} bf16, full context",
        *ap.kernel_case(1, "bf16", seed=7, full=True), errs["float"])
    rows["paged_attention_fp8"] = time_row(
        "paged_attention_fp8", f"decode N={SLOTS} Q=1 fp8 pools, bf16 "
        f"queries, full context", *ap.kernel_case(1, "fp8-bf16", seed=8,
                                                  full=True), errs["fp8"])
    rows["paged_attention_verify"] = time_row(
        "paged_attention_verify", f"verify N={SLOTS} Q=5 bf16, full context",
        *ap.kernel_case(5, "bf16", seed=9, full=True), errs["verify"])
    rows["paged_attention_prefix"] = time_row(
        "paged_attention_prefix", "prefix N=1 Q=128 qbase=287 bf16 (a "
        "resumed second turn)", *ap.kernel_case(128, "bf16", seed=11, N=1,
                                                qbase=287), errs["prefix"])
    say("kernel", f"decode N={SLOTS} Q=1 f32 pools (the f32 engine's "
                  f"shape), full context:")
    say_times(*ap.kernel_case(1, "f32", seed=12, full=True))
    return rows


# ----------------------------------------------------------------- serve
def tail_new_tokens(rng, lo: int, hi: int) -> int:
    """Truncated-exponential decode length over [lo, hi], the long tail
    of bench_gpt_decode.py's mixed traffic."""
    span = max(hi - lo, 0)
    return lo + int(min(rng.exponential(0.35 * span), span))


def serving_jobs(vocab: int, n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        t0 = int(rng.integers(16, 257))
        jobs.append((rng.integers(0, vocab, (t0,)).astype(np.int32),
                     tail_new_tokens(rng, 16, 128)))
    return jobs


def common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def serve_config():
    """The GPT-2-small-like configuration bench_gpt_decode.py serves."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=32000, max_len=MAX_CONTEXT,
                             d_model=768, n_layers=LAYERS, n_heads=HEADS,
                             d_ff=3072, dropout=0.0)


def device_profile(phase: str, what: str, run, focus,
                   expect: dict = None, group=None, top: int = 8,
                   out: dict = None) -> float:
    """Device busy share over ``run()`` from a torch.profiler trace: the
    kernels' device times summed over the window's wall time (one
    stream, so kernels do not overlap), the share of the kernels whose
    names hold each string of ``focus`` with the launches the trace holds
    of them (against ``expect[key]`` launches where given: a long process
    can lose records, and then the sums undercount), and the ``top``
    largest kernels by device time. With ``group`` (a function from the
    names of the CPU op that launched a kernel and of its parents,
    innermost first, to a group's name), also the device time by group,
    and each of the largest kernels' group. Record ranges
    (``dl4j::...``) show on the device's timeline too and are not
    kernels. ``out``, where given, receives the ``top`` largest kernels as
    (name, us, group or None) under "largest", and every kernel as (name,
    us, group or None, launches) under "all". Returns the busy
    milliseconds (0 when the profiler saw no device time)."""
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    by_name, launches = Counter(), Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(
                "dl4j::"):
            by_name[e.name] += e.time_range.elapsed_us()
            launches[e.name] += 1
    busy_us = sum(by_name.values())
    if busy_us == 0:
        say(phase, "torch.profiler saw no device time: device idle share "
                   "not measured")
        return 0.0
    say(phase, f"{what} in {wall_us / 1e3:.1f} ms: device busy "
               f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of the "
               f"window, idle {1 - busy_us / wall_us:.3f}), "
               f"{sum(launches.values())} kernels")
    for key in focus:
        t = sum(v for n, v in by_name.items() if key in n)
        k = sum(v for n, v in launches.items() if key in n)
        want = (expect or {}).get(key)
        lost = (f" of {want} launched: the trace is incomplete, so is this "
                f"sum" if want is not None and k != want else "")
        say(phase, f"  {key}*: {t / 1e3:.2f} ms ({t / busy_us:.3f} of "
                   f"device time, {k} launches traced{lost})")
    of_name = defaultdict(Counter)
    if group is not None:
        groups = Counter()
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            chain, q = [], e
            while q is not None:
                chain.append(q.name)
                q = q.cpu_parent
            g = group(chain)
            for k in e.kernels:
                groups[g] += k.duration
                of_name[k.name][g] += k.duration
        groups["not traced to an op"] = max(busy_us - sum(groups.values()),
                                            0)
        say(phase, "device time by group: " + ", ".join(
            f"{g} {t / 1e3:.2f} ms ({t / busy_us:.3f})"
            for g, t in groups.most_common()))
    largest = []
    for name, t in by_name.most_common(top):
        grp = of_name[name].most_common(1)[0][0] if of_name[name] else None
        g = f" [{grp}]" if grp else ""
        say(phase, f"  {t / 1e3:9.2f} ms {t / busy_us:.3f} "
                   f"x{launches[name]:<5d}{g} {name[:90]}")
        largest.append((name, t, grp))
    if out is not None:
        out["largest"] = largest
        out["all"] = [(n, t, of_name[n].most_common(1)[0][0]
                       if of_name[n] else None, launches[n])
                      for n, t in by_name.most_common()]
    return busy_us / 1e3


def profile_window(eng, jobs, phase: str = "profile",
                   sequential: bool = False) -> None:
    """The device profile of one batch (prefill and decode) served by a
    running engine."""
    steps0 = eng.n_steps

    def run():
        run_jobs(eng, jobs, sequential=sequential)

    device_profile(phase, f"{len(jobs)} requests", run,
                   ("paged_attention",))
    say(phase, f"  ({eng.n_steps - steps0} decode steps and verify passes)")


def reset_launches(eng) -> tuple:
    """Zero the kernel's counts just before a driven run; returns the
    engine's (decode steps, warm admissions, verify passes) so far."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    torch.cuda.synchronize()
    pa.launches = pa.multi_row_launches = 0
    return eng.n_steps, eng.n_warm_admissions, eng.n_verify_dispatches


def launch_check(tag: str, eng, since: tuple) -> tuple:
    """Every decode step, verify pass and suffix prefill since ``since``
    (from :func:`reset_launches`) went through the kernel, one launch
    per layer each: one-row launches are the decode steps (the engine
    counts a verify pass as a step too), multi-row ones the verify
    passes and warm admissions. Returns (launches, one-row launches,
    multi-row launches)."""
    from deeplearning4j_tpu_torch.ops import paged_attention as pa

    launches, multi = pa.launches, pa.multi_row_launches
    steps = eng.n_steps - since[0]
    warm = eng.n_warm_admissions - since[1]
    verify = eng.n_verify_dispatches - since[2]
    L = eng.model.cfg.n_layers
    check(steps > 0 and launches - multi == L * (steps - verify)
          and multi == L * (warm + verify),
          f"{tag}: kernel launches {launches - multi} one-row + {multi} "
          f"multi-row != {L} layers x ({steps - verify} decode steps) + "
          f"{L} x ({verify} verify passes + {warm} warm admissions)")
    return launches, launches - multi, multi


def run_jobs(eng, jobs, sequential: bool = False, **kw):
    """Serve ``jobs`` (prompt, max_new[, session_id]); returns (tokens,
    requests, wall seconds)."""
    t0 = time.perf_counter()
    if sequential:
        reqs = []
        for j in jobs:
            reqs.append(eng.submit(j[0], j[1], session_id=(
                j[2] if len(j) > 2 else None), **kw))
            reqs[-1].result(timeout=600)
    else:
        reqs = [eng.submit(j[0], j[1], **kw) for j in jobs]
    outs = [r.result(timeout=600) for r in reqs]
    return outs, reqs, time.perf_counter() - t0


def ttft_ms(reqs, q: float) -> float:
    return float(np.percentile([r.ttft_s for r in reqs], q) * 1e3)


def agreement(outs, ref) -> str:
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, ref))
    agree = sum(common_prefix(a, b) for a, b in zip(outs, ref))
    return (f"{same}/{len(ref)} requests identical, common prefix "
            f"{agree}/{sum(len(b) for b in ref)} tokens")


def check_same(tag: str, outs, ref) -> None:
    for i, (a, b) in enumerate(zip(outs, ref)):
        check(np.array_equal(a, b), f"{tag}, request {i}: {a.tolist()} != "
                                    f"{b.tolist()}")


def phase_serve(rows: dict) -> dict:
    from deeplearning4j_tpu_torch.models.gpt import (
        CausalLM, init_params_numpy, params_from_jax)
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg = serve_config()
    t0 = time.perf_counter()
    tree = init_params_numpy(cfg, seed=0)
    params = params_from_jax(tree, device=DEVICE)
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    say("serve", f"{CausalLM.num_params(params) / 1e6:.1f} M parameters "
                 f"(f32 master, bf16 compute) in "
                 f"{time.perf_counter() - t0:.1f} s")
    jobs = serving_jobs(cfg.vocab_size, 24)
    say("serve", f"{len(jobs)} greedy requests, prompts "
                 f"{min(len(p) for p, _ in jobs)}-"
                 f"{max(len(p) for p, _ in jobs)} tokens, max_new "
                 f"{min(n for _, n in jobs)}-{max(n for _, n in jobs)}")
    eng = DecodeEngine(model, params, slots=SLOTS, page_size=PAGE,
                       max_context=MAX_CONTEXT, device=DEVICE)
    with eng:
        page_bytes = eng.pool.bytes_per_page()
        say("serve", f"pool {eng.pool.n_pages} pages of {page_bytes} B")
        eng.generate(jobs[0][0][:16], 4)          # first CUDA calls
        steps0, dec0 = eng.n_steps, eng.decode_seconds
        since = reset_launches(eng)
        outs, reqs, wall = run_jobs(eng, jobs)
        launches, _, _ = launch_check("serve", eng, since)
        steps = eng.n_steps - steps0
        dec_s = eng.decode_seconds - dec0
        occupancy = eng.stats()["avg_occupancy"]
        profile_window(eng, serving_jobs(cfg.vocab_size, 8, seed=2))
    check(eng.pool.allocated == 0,
          f"pool did not drain: {eng.pool.allocated} pages allocated")
    for (p, n), out in zip(jobs, outs):
        check(len(out) == n, f"request returned {len(out)} of {n} tokens")
        check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              "token outside the vocabulary")
    rows["paged_attention"]["launches"] = launches
    tokens = sum(len(o) for o in outs)
    say("serve", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
                 f"tokens/s; TTFT p50 {ttft_ms(reqs, 50):.1f} ms, "
                 f"p99 {ttft_ms(reqs, 99):.1f} ms; decode "
                 f"{dec_s / steps * 1e3:.3f} ms/step over {steps} steps "
                 f"(avg occupancy {occupancy:.3f}); kernel launches "
                 f"{launches} = {cfg.n_layers} x {steps}")
    # bf16: agreement with the dense generate() is reported, not required
    # (one-ulp argmax ties on random weights are expected at bf16)
    dense = [model.generate(params, p[None], n)[0].cpu().numpy()
             for p, n in jobs[:8]]
    say("serve", f"bf16 engine vs dense generate(): "
                 f"{agreement(outs[:8], dense)}")

    # f32: engine tokens must equal the dense generate() exactly
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, min(n, 32)) for p, n in jobs[:4]]
    with DecodeEngine(model32, params, slots=SLOTS, page_size=PAGE,
                      max_context=MAX_CONTEXT, device=DEVICE) as eng32:
        outs32, _, _ = run_jobs(eng32, jobs32)
    check(eng32.pool.allocated == 0, "f32 pool did not drain")
    check_same("f32 engine vs generate()", outs32, [
        model32.generate(params, p[None], n)[0].cpu().numpy()
        for p, n in jobs32])
    say("serve", f"f32 engine == dense generate() for {len(jobs32)} "
                 f"requests ({sum(n for _, n in jobs32)} tokens)")
    return {"cfg": cfg, "tree": tree, "params": params, "jobs": jobs,
            "outs": outs, "tokens_per_s": tokens / wall,
            "page_bytes": page_bytes, "cpu_params": None}


def cpu_params(ctx: dict):
    """The same numpy weights on the CPU, for the twin engines (built
    once)."""
    from deeplearning4j_tpu_torch.models.gpt import params_from_jax

    if ctx["cpu_params"] is None:
        ctx["cpu_params"] = params_from_jax(ctx["tree"], device="cpu")
    return ctx["cpu_params"]


def fp8_code_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Steps between two float8_e4m3fn byte patterns along the number
    line (sign-magnitude: the low 7 bits order the magnitudes)."""
    sa, sb = (a >> 7).astype(np.int64), (b >> 7).astype(np.int64)
    ma, mb = (a & 0x7F).astype(np.int64), (b & 0x7F).astype(np.int64)
    va = np.where(sa == 1, -ma, ma)
    vb = np.where(sb == 1, -mb, mb)
    return np.abs(va - vb)


def phase_fp8(ctx: dict, rows: dict) -> None:
    """fp8 KV pages: phase 4's traffic at bf16 with kv_dtype="fp8_e4m3",
    then at f32 the pools after prefill and the greedy tokens on the card
    against a CPU twin (the plain versions)."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params, jobs = ctx["cfg"], ctx["params"], ctx["jobs"]
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    eng = DecodeEngine(model, params, slots=SLOTS, page_size=PAGE,
                       max_context=MAX_CONTEXT, device=DEVICE,
                       kv_dtype="fp8_e4m3")
    with eng:
        eng.generate(jobs[0][0][:16], 4)
        steps0 = eng.n_steps
        since = reset_launches(eng)
        outs, reqs, wall = run_jobs(eng, jobs)
        launches, _, _ = launch_check("fp8", eng, since)
        steps = eng.n_steps - steps0
        fp8_bytes = eng.pool.bytes_per_page()
        profile_window(eng, serving_jobs(cfg.vocab_size, 8, seed=2), "fp8")
    check(eng.pool.allocated == 0, "fp8 pool did not drain")
    rows["paged_attention_fp8"]["launches"] = launches
    tokens = sum(len(o) for o in outs)
    say("fp8", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
               f"tokens/s (float pools {ctx['tokens_per_s']:.1f}); TTFT p50 "
               f"{ttft_ms(reqs, 50):.1f} ms, p99 {ttft_ms(reqs, 99):.1f} ms; "
               f"page {fp8_bytes} B against {ctx['page_bytes']} B bf16 "
               f"({fp8_bytes / ctx['page_bytes']:.4f}); kernel launches "
               f"{launches} = {cfg.n_layers} x {steps}")
    say("fp8", f"bf16 fp8 engine vs float engine (reported, not a gate): "
               f"{agreement(outs, ctx['outs'])}")

    # f32: the card against the CPU twin. Sessions pin each prompt's
    # pages after its prefill (one new token), so the pools hold them
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, 24) for p, _ in jobs[:4]]
    snap, toks, pages = {}, {}, {}
    for dev, prm in ((DEVICE, params), ("cpu", cpu_params(ctx))):
        kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
                  device=dev, kv_dtype="fp8_e4m3")
        with DecodeEngine(model32, prm, session_capacity=4, **kw) as e:
            run_jobs(e, [(p, 1, f"u{i}") for i, (p, _) in
                         enumerate(jobs32)], sequential=True)
            pages[dev] = sorted(e.pool._refs)
            snap[dev] = {n: (t.view(torch.uint8) if t.dtype ==
                             torch.float8_e4m3fn else t)[:, pages[dev]]
                         .cpu().numpy() for n, t in e.pool.tree().items()}
        check(e.pool.allocated == 0, f"f32 fp8 pool on {dev} did not drain")
        with DecodeEngine(model32, prm, **kw) as e:
            toks[dev], _, _ = run_jobs(e, jobs32)
    check(pages[DEVICE] == pages["cpu"] and len(pages["cpu"]) > 0,
          f"pinned pages differ: {pages[DEVICE]} / {pages['cpu']}")
    card, cpu = snap[DEVICE], snap["cpu"]
    for n in ("k", "v"):
        dist = fp8_code_distance(card[n], cpu[n])
        frac = float((dist > 0).mean())
        rel = float(np.abs(card[n + "_scale"] / cpu[n + "_scale"] - 1).max())
        say("fp8", f"f32 {n} pages after prefill, card vs CPU: "
                   f"{int((dist > 0).sum())} of {dist.size} bytes differ "
                   f"({frac:.2e}), at most {int(dist.max())} e4m3 step(s); "
                   f"scales max relative diff {rel:.2e}")
        check(dist.max() <= 1 and frac <= 1e-3,
              f"fp8 {n} bytes: card and CPU differ beyond one e4m3 step "
              f"at a rounding boundary")
        check(rel <= 1e-5, f"fp8 {n} scales differ by {rel:.2e}")
    check_same("f32 fp8 card vs CPU", toks[DEVICE], toks["cpu"])
    say("fp8", f"f32 fp8 card tokens == CPU twin for {len(jobs32)} requests "
               f"({sum(n for _, n in jobs32)} tokens)")


def shared_prefix_requests(vocab: int, n_users: int, system_len: int,
                           user_len: int, seed: int = 0):
    """bench_gpt_decode.py's prefix_ab traffic: one shared system
    prompt, distinct user suffixes."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, (system_len,)).astype(np.int32)
    return [np.concatenate(
        [sys_p, rng.integers(0, vocab, (user_len,)).astype(np.int32)])
        for _ in range(n_users)]


def prefix_turns(eng, prompts, new: int, new2: int, added: int):
    """Each user's first turn, submitted one after another, then one
    second turn per user that adds ``added`` tokens to the whole first
    turn (a sticky-session resume when the engine has sessions). Returns
    (turn-1 tokens, turn-1 requests, turn-2 prompts, turn-2 tokens,
    turn-2 requests)."""
    rng = np.random.default_rng(5)
    outs1, reqs1, _ = run_jobs(eng, [(p, new, f"user{i}")
                                     for i, p in enumerate(prompts)],
                               sequential=True)
    second = [np.concatenate([p, o, rng.integers(
        0, eng.model.cfg.vocab_size, (added,)).astype(np.int32)])
        for p, o in zip(prompts, outs1)]
    outs2, reqs2, _ = run_jobs(eng, [(p, new2, f"user{i}")
                                     for i, p in enumerate(second)],
                               sequential=True)
    return outs1, reqs1, second, outs2, reqs2


def phase_prefix(ctx: dict, rows: dict) -> None:
    """prefix_ab's traffic (16 users, a 192-token system prompt, 32-token
    suffixes, 64 new tokens, one after another) cold and then warm at
    bf16, plus a second turn per user that adds 80 tokens: a session
    resume whose suffix bucket is 128, Q > 32 through the kernel. At f32
    warm and resumed tokens must equal cold ones."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params = ctx["cfg"], ctx["params"]
    users, system, user, new, added, new2 = 16, 192, 32, 64, 80, 32
    prompts = shared_prefix_requests(cfg.vocab_size, users, system, user)
    kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
              device=DEVICE)
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    # request 0 fills the cache and pays each engine's first calls: the
    # turn-1 TTFT medians leave it out on both sides, as prefix_ab does
    with DecodeEngine(model, params, **kw) as cold:
        c1, creqs1, second, c2, creqs2 = prefix_turns(cold, prompts, new,
                                                      new2, added)
    warm = DecodeEngine(model, params, prefix_cache=True,
                        session_capacity=users, **kw)
    with warm:
        steps0, warm0 = warm.n_steps, warm.n_warm_admissions
        since = reset_launches(warm)
        w1, wreqs1, second_w, w2, wreqs2 = prefix_turns(warm, prompts, new,
                                                        new2, added)
        launches, one_row, multi = launch_check("prefix", warm, since)
        n_warm = warm.n_warm_admissions - warm0
        n_steps = warm.n_steps - steps0
        st = warm.prefix_stats()
        more = shared_prefix_requests(cfg.vocab_size, users + 4, system,
                                      user)[users:]
        profile_window(warm, [(p, new) for p in more], "prefix",
                       sequential=True)
    check(warm.pool.allocated == 0, "prefix pool did not drain")
    # a user's second turn extends its own first turn, so at bf16 the
    # cold and warm second prompts differ where the first turns did
    same2 = [i for i in range(users)
             if np.array_equal(second[i], second_w[i])]
    hits1 = [r.cache_hit_tokens for r in wreqs1[1:]]
    hits2 = [r.cache_hit_tokens for r in wreqs2]
    check(min(hits1) >= system and min(hits2) >= system + user + new - 1,
          f"warm hits {hits1} / resumed hits {hits2}")
    rows["paged_attention_prefix"]["launches"] = multi
    say("prefix", f"{users} users, system {system} + user {user} tokens, "
                  f"{new} new, one after another: TTFT p50 cold "
                  f"{np.median([r.ttft_s for r in creqs1[1:]]) * 1e3:.2f} ms, "
                  f"warm {np.median([r.ttft_s for r in wreqs1[1:]]) * 1e3:.2f} "
                  f"ms; mean hit tokens {np.mean(hits1):.1f}")
    say("prefix", f"second turn (+{added} tokens, suffix bucket 128, "
                  f"{new2} new): TTFT p50 cold "
                  f"{np.median([r.ttft_s for r in creqs2]) * 1e3:.2f} ms, "
                  f"resumed {np.median([r.ttft_s for r in wreqs2]) * 1e3:.2f}"
                  f" ms; mean hit tokens {np.mean(hits2):.1f}; "
                  f"{st['sessions']['resumed_total']} resumes")
    say("prefix", f"kernel launches {launches}: {one_row} one-row = "
                  f"{cfg.n_layers} x {n_steps} decode steps, {multi} at "
                  f"N=1 Q = suffix bucket = {cfg.n_layers} x {n_warm} warm "
                  f"admissions; bf16 warm vs cold: {agreement(w1, c1)}; "
                  f"resumed vs cold, over the {len(same2)} users whose "
                  f"second prompts agree: "
                  f"{agreement([w2[i] for i in same2], [c2[i] for i in same2])}")

    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    few = prompts[:4]
    with DecodeEngine(model32, params, **kw) as cold:
        c1, _, _, c2, _ = prefix_turns(cold, few, new, new2, added)
    with DecodeEngine(model32, params, prefix_cache=True,
                      session_capacity=users, **kw) as warm:
        w1, r1, _, w2, r2 = prefix_turns(warm, few, new, new2, added)
    check(all(r.cache_hit_tokens > 0 for r in r1[1:] + r2),
          "f32 warm run reused nothing")
    check_same("f32 warm vs cold", w1, c1)
    check_same("f32 resumed vs cold", w2, c2)
    say("prefix", f"f32: warm == cold and resumed == cold for {len(few)} "
                  f"users ({len(few) * (new + new2)} tokens)")


def phase_spec(ctx: dict, rows: dict) -> None:
    """Speculative decoding on phase 4's mixed traffic, k in {2, 4, 8},
    against plain decoding in the same phase; at f32 the tokens must
    equal plain."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params, jobs = ctx["cfg"], ctx["params"], ctx["jobs"]
    kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
              device=DEVICE)
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    with DecodeEngine(model, params, **kw) as eng:
        eng.generate(jobs[0][0][:16], 4)
        plain, _, plain_s = run_jobs(eng, jobs)
    tokens = sum(len(o) for o in plain)
    say("spec", f"plain: {tokens / plain_s:.1f} tokens/s")
    total = 0
    for k in (2, 4, 8):
        eng = DecodeEngine(model, params, spec_decode=k, **kw)
        with eng:
            eng.generate(jobs[0][0][:16], 4)
            since = reset_launches(eng)
            outs, _, wall = run_jobs(eng, jobs)
            _, _, multi = launch_check(f"spec k={k}", eng, since)
            sp = eng.stats()["spec"]
            if k == 4:
                profile_window(eng, serving_jobs(cfg.vocab_size, 8, seed=2),
                               "spec")
        total += multi
        check(eng.pool.allocated == 0, f"spec k={k} pool did not drain")
        check(sp["verify_dispatches"] > 0, f"spec k={k} never verified")
        say("spec", f"k={k}: {tokens / wall:.1f} tokens/s "
                    f"({plain_s / wall:.3f}x plain); acceptance "
                    f"{sp['acceptance']:.3f}, {sp['tokens_per_dispatch']:.3f}"
                    f" tokens per verify per lane over "
                    f"{sp['verify_dispatches']} verify passes; bf16 vs "
                    f"plain: {agreement(outs, plain)}")
    rows["paged_attention_verify"]["launches"] = total

    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, min(n, 32)) for p, n in jobs[:6]]
    with DecodeEngine(model32, params, **kw) as eng:
        plain32, _, _ = run_jobs(eng, jobs32)
    for k in (2, 4, 8):
        with DecodeEngine(model32, params, spec_decode=k, **kw) as eng:
            outs32, _, _ = run_jobs(eng, jobs32)
        check_same(f"f32 spec k={k} vs plain", outs32, plain32)
    say("spec", f"f32: spec k in (2, 4, 8) == plain for {len(jobs32)} "
                f"requests")


def phase_int8(ctx: dict) -> None:
    """int8 decode weights: phase 4's traffic at bf16, then at f32 the
    card's tokens against a CPU twin."""
    from deeplearning4j_tpu_torch.models.gpt import CausalLM
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    cfg, params, jobs = ctx["cfg"], ctx["params"], ctx["jobs"]
    kw = dict(slots=SLOTS, page_size=PAGE, max_context=MAX_CONTEXT,
              quantization="int8")
    model = CausalLM(cfg, compute_dtype=torch.bfloat16)
    eng = DecodeEngine(model, params, device=DEVICE, **kw)
    with eng:
        eng.generate(jobs[0][0][:16], 4)
        since = reset_launches(eng)
        outs, reqs, wall = run_jobs(eng, jobs)
        launch_check("int8", eng, since)
    check(eng.pool.allocated == 0, "int8 pool did not drain")
    tokens = sum(len(o) for o in outs)
    say("int8", f"{tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} "
                f"tokens/s (float weights {ctx['tokens_per_s']:.1f}); TTFT "
                f"p50 {ttft_ms(reqs, 50):.1f} ms; vs float weights "
                f"(reported): {agreement(outs, ctx['outs'])}")
    model32 = CausalLM(cfg, compute_dtype=torch.float32)
    jobs32 = [(p, 24) for p, _ in jobs[:4]]
    toks = {}
    for dev, prm in ((DEVICE, params), ("cpu", cpu_params(ctx))):
        with DecodeEngine(model32, prm, device=dev, **kw) as e:
            toks[dev], _, _ = run_jobs(e, jobs32)
    check_same("f32 int8 card vs CPU", toks[DEVICE], toks["cpu"])
    say("int8", f"f32 int8 card tokens == CPU twin for {len(jobs32)} "
                f"requests")


# --------------------------------------------------------- train kernels
BERT_BASE_PARAMS = 108_922_170


def bound(nbytes: int, flops: int, peak_flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the operations over ``peak_flops``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_case(N: int, T: int, dtype, mask_kind: str, seed: int,
               hd: int = HEAD_DIM):
    """q, k, v [N, 12, T, hd] and a key mask: none, padded (row n keeps
    its first T - 7n keys), or padded with the last row fully masked."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn(N, HEADS, T, hd, generator=g,
                           device=DEVICE).to(dtype) for _ in range(3))
    mask = None
    if mask_kind != "none":
        keep = torch.tensor([max(1, T - 7 * n) for n in range(N)],
                            device=DEVICE)
        mask = (torch.arange(T, device=DEVICE)[None, :]
                < keep[:, None]).float()
        if mask_kind == "full_row":
            mask[-1] = 0.0
    return q, k, v, mask


def flash_plain(q, k, v, mask, causal):
    """The kernels' plain version at f32: ``blockwise_attention`` with one
    block spanning the keys, so that a fully masked row is the mean of v
    as in the kernel (a padded block would let its padding in)."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        blockwise_attention)

    return blockwise_attention(q.float(), k.float(), v.float(), mask,
                               causal=causal, block_k=k.shape[2])


def flash_bound(q, backward: bool):
    """(bound_ms, bound_by, bytes, flops) of one unmasked, non-causal call
    (the training path's): the forward reads q, k, v and writes out and
    the row statistics; the backward reads q, k, v, out, dout and the
    statistics and writes dq, dk, dv. Matmul operations only: 2 (QK^T,
    PV) or 5 (QK^T again, dV, dP, dQ, dK) products of 2 * T * T * hd per
    (sequence, head), at the tensor-core rate of the inputs' type."""
    N, H, T, hd = q.shape
    one = q.numel() * q.element_size()
    stats = 2 * N * H * T * 4
    products = 5 if backward else 2
    nbytes = (8 if backward else 4) * one + stats
    flops = products * 2 * N * H * T * T * hd
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def flash_grads(q, k, v, mask, causal, dout, dtype, kernel: bool):
    """dq, dk, dv of attention at ``dtype``: through the kernels'
    autograd Function, or through the plain version at f32."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    work = torch.float32 if not kernel else dtype
    leaves = [t.to(dtype).to(work).clone().requires_grad_(True)
              for t in (q, k, v)]
    out = (fa.attention(*leaves, mask, causal) if kernel
           else flash_plain(*leaves, mask, causal))
    return torch.autograd.grad(out, leaves, dout.to(dtype).to(work))


def flash_bf16_case(label: str, q, k, v, m, causal) -> tuple:
    """The bf16 kernels on one case against the f32 plain version: the
    forward within 2e-2, each gradient within 2e-2 of its max |grad|.
    Returns (forward err, backward err / max |grad|)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    lq, lk, lv = (x.to(torch.bfloat16) for x in (q, k, v))
    out, _ = fa.flash_attention_fwd(lq, lk, lv, m, causal)
    err = float((out.float() - flash_plain(lq, lk, lv, m, causal))
                .abs().max())
    check(bool(torch.isfinite(out).all()) and err <= 2e-2,
          f"flash forward bf16 {label}: {err:.3e} > 0.02")
    dout = torch.randn_like(q)
    got = flash_grads(q, k, v, m, causal, dout, torch.bfloat16, True)
    want = flash_grads(q, k, v, m, causal, dout, torch.bfloat16, False)
    worst = 0.0
    for name, a, b in zip("qkv", got, want):
        e = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        # where the gradient is 0 in exact arithmetic (one key, no mask)
        # both sides hold f32 round-off only: an absolute floor of 1e-5
        check(a.dtype == torch.bfloat16 and e <= max(2e-2 * scale, 1e-5),
              f"flash backward d{name} bf16 {label}: {e:.3e} > 0.02 x max "
              f"|grad| {scale:.3e} (floor 1e-5)")
        if scale > 5e-4:
            worst = max(worst, e / scale)
    return err, worst


def flash_bf16_shapes() -> tuple:
    """The bf16 (tensor-core) kernels at every head dim, at lengths that
    fit one tile (1, 16), end in a ragged tile (77, 200) or fill two
    (128), with no mask or a fully masked row, causal off and on, and Tq
    != Tk both ways. Returns the largest forward error and backward
    error / max |grad|."""
    fwd = bwd = 0.0
    n_cases = 0
    for hd in (32, 64, 96, 128):
        for T in (1, 16, 77, 128, 200):
            if hd == HEAD_DIM and T in (77, 128):
                continue  # the T x mask x causal grid above
            for mask_kind in ("none", "full_row"):
                for causal in (False, True):
                    q, k, v, m = flash_case(2, T, torch.float32, mask_kind,
                                            seed=hd + T, hd=hd)
                    e = flash_bf16_case(f"hd={hd} T={T} {mask_kind} "
                                        f"causal={causal}", q, k, v, m,
                                        causal)
                    fwd, bwd = max(fwd, e[0]), max(bwd, e[1])
                    n_cases += 1
        for tq, tk in ((50, 77), (200, 64)):
            q, k, v, m = flash_case(2, tk, torch.float32, "full_row",
                                    seed=hd + tq, hd=hd)
            q = torch.randn(2, HEADS, tq, hd, device=DEVICE)
            for causal in (False, True):
                e = flash_bf16_case(f"hd={hd} Tq={tq} Tk={tk} full_row "
                                    f"causal={causal}", q, k, v, m, causal)
                fwd, bwd = max(fwd, e[0]), max(bwd, e[1])
                n_cases += 1
    torch.cuda.synchronize()
    say("flash", f"bf16 (tensor cores) at hd 32, 64, 96, 128, T 1, 16, 77, "
                 f"128, 200 and Tq != Tk, {n_cases} cases: forward max abs "
                 f"err {fwd:.3e} (tolerance 0.02), backward err / max |grad| "
                 f"{bwd:.3e} (tolerance 0.02)")
    return fwd, bwd


def device_split(what: str, run, calls: int = 20,
                 pattern: str = r"flash_\w+?_kernel",
                 phase: str = "flash", shape: str = "the training shape"
                 ):
    """Device time per call of each kernel matching ``pattern`` that
    ``run`` launches, from a torch.profiler trace of ``calls`` calls:
    each kernel's mean over the launch records the trace holds, and how
    many it holds (a long process can lose records; a sum over lost ones
    divided by ``calls`` would read low). Beside the CUDA-event time per
    call, which also holds the gaps between launches when the host
    enqueues more slowly than the card runs. Returns the sum of the
    means in us (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(pattern, e.name)
            if m:
                t, n = split.get(m.group(0), (0.0, 0))
                split[m.group(0)] = (t + e.time_range.elapsed_us(), n + 1)
    if not split:
        say(phase, f"torch.profiler saw no device time: {what} split not "
                   f"measured")
        return None
    total = sum(t / n for t, n in split.values())
    say(phase, f"{what} device time per call at {shape} (profiler): "
               f"{total:.1f} us = "
               + " + ".join(f"{k} {t / n:.1f} us ({n} of {calls} launches "
                            f"traced)" for k, (t, n) in sorted(split.items())))
    return total


#: (dtype, head dim) the kernels are not built for, run on zero-padded or
#: widened copies (C9: f16; C10: head dims 16, 48, 160 of 32, 64, 96, 128,
#: 256 tiles), with their tolerances against the f32 plain version on the
#: same rounded inputs: (forward, backward of max |grad|)
FLASH_WIDE = ((torch.float16, 64, (2e-3, 2e-3)), (torch.float32, 16,
                                                   (2e-5, 1e-4)),
              (torch.bfloat16, 16, (2e-2, 2e-2)),
              (torch.float32, 48, (2e-5, 1e-4)),
              (torch.float16, 160, (2e-3, 2e-3)),
              (torch.bfloat16, 160, (2e-2, 2e-2)),
              (torch.float32, 320, (2e-5, 1e-4)),
              (torch.bfloat16, 320, (2e-2, 2e-2)),
              (torch.float32, 512, (2e-5, 1e-4)),
              (torch.bfloat16, 512, (2e-2, 2e-2)))


def check_flash_wide(fa) -> None:
    """C9 and C10 on the card: f16, and head dims outside 32/64/96/128,
    through ``fa.attention`` forward and backward (N=4, H=12, Tq=77, Tk=128,
    padded keys, causal off and on) against autograd through the plain
    version at f32 on the same rounded inputs."""
    g = torch.Generator(device=DEVICE).manual_seed(77)
    for dtype, hd, tol in FLASH_WIDE:
        q = torch.randn(4, HEADS, 77, hd, generator=g, device=DEVICE)
        k, v = (torch.randn(4, HEADS, 128, hd, generator=g, device=DEVICE)
                for _ in range(2))
        m = torch.ones(4, 128, device=DEVICE)
        m[0, 90:] = 0.0
        dout = torch.randn(q.shape, generator=g, device=DEVICE).to(dtype)
        errs = []
        for causal in (False, True):
            a = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
            before = (fa.fwd_launches, fa.bwd_launches)
            out = fa.attention(*a, m, causal)
            got = torch.autograd.grad(out, a, dout)
            b = [t.to(dtype).float().requires_grad_(True) for t in (q, k, v)]
            ref = flash_plain(*b, m, causal)
            want = torch.autograd.grad(ref, b, dout.float())
            torch.cuda.synchronize()
            check((fa.fwd_launches - before[0], fa.bwd_launches - before[1])
                  == (1, 1), f"flash {dtype} hd={hd}: not one launch each")
            check(out.dtype == dtype and out.shape == q.shape,
                  f"flash {dtype} hd={hd}: output {out.dtype} "
                  f"{tuple(out.shape)}")
            err = float((out.detach().float() - ref.detach()).abs().max())
            check(err <= tol[0], f"flash forward {dtype} hd={hd} causal="
                                 f"{causal}: {err:.3e} > {tol[0]:g}")
            errs.append(err)
            for name, x, y in zip("qkv", got, want):
                e = float((x.float() - y).abs().max()) / float(
                    y.abs().max())
                check(x.dtype == dtype and e <= tol[1],
                      f"flash backward d{name} {dtype} hd={hd} causal="
                      f"{causal}: {e:.3e} > {tol[1]:g} of max |grad|")
                errs.append(e)
        tile = fa.kernel_layout(dtype, hd)
        say("flash", f"{str(dtype)[6:]} hd={hd} (kernel tile {tile[0]} at "
                     f"{str(tile[1])[6:]}): forward max abs err "
                     f"{max(errs[0], errs[4]):.2e}, backward err / max "
                     f"|grad| {max(errs[1:4] + errs[5:]):.2e}")
    # C11's head dims past 256 walk 64-column slices: their time at this
    # check's shape, f32, beside the 256 tile's
    for hd in (256, 512):
        q, k, v = (torch.randn(4, HEADS, 128, hd, generator=g, device=DEVICE)
                   for _ in range(3))
        out, stats = fa.flash_attention_fwd(q, k, v, None, False)
        fwd = cuda_ms(lambda i: fa.flash_attention_fwd(q, k, v, None, False),
                      10, 2)
        bwd = cuda_ms(lambda i: fa.flash_attention_bwd(q, k, v, out, out,
                                                       stats), 10, 2)
        say("flash", f"f32 hd={hd} at N=4 H={HEADS} T=128 (kernel tile "
                     f"{fa.kernel_layout(torch.float32, hd)[0]}): forward "
                     f"{fwd:.4f} ms, backward {bwd:.4f} ms a call (CUDA "
                     f"events)")


def phase_flash() -> tuple:
    """Rows of ``flash_attention_fwd`` and ``flash_attention_bwd``:
    checks against the plain version, then times at the training shape."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    fwd_err = bwd_err = 0.0
    for T in (128, 77):
        for mask_kind in ("none", "padded", "full_row"):
            for causal in (False, True):
                q, k, v, m = flash_case(4, T, torch.float32, mask_kind,
                                        seed=T)
                dout = torch.randn_like(q)
                line = []
                for dtype, tol in ((torch.float32, 2e-5),
                                   (torch.bfloat16, 2e-2)):
                    lq, lk, lv = (x.to(dtype) for x in (q, k, v))
                    out, stats = fa.flash_attention_fwd(lq, lk, lv, m, causal)
                    want = flash_plain(lq, lk, lv, m, causal)
                    torch.cuda.synchronize()
                    check(out.dtype == dtype and out.shape == q.shape
                          and stats.shape == (2, 4 * HEADS, T),
                          f"forward output {out.dtype} {tuple(out.shape)}")
                    check(bool(torch.isfinite(out).all()),
                          "forward output not finite")
                    err = float((out.float() - want).abs().max())
                    fwd_err = max(fwd_err, err)
                    check(err <= tol, f"flash forward {dtype} T={T} "
                                      f"{mask_kind} causal={causal}: "
                                      f"{err:.3e} > {tol:g}")
                    line.append(f"fwd {str(dtype)[6:]} {err:.2e}")
                for dtype, tol in ((torch.float32, 1e-4),
                                   (torch.bfloat16, 2e-2)):
                    got = flash_grads(q, k, v, m, causal, dout, dtype, True)
                    want = flash_grads(q, k, v, m, causal, dout, dtype, False)
                    torch.cuda.synchronize()
                    for name, a, b in zip("qkv", got, want):
                        check(a.dtype == dtype and a.shape == b.shape,
                              f"d{name} {a.dtype} {tuple(a.shape)}")
                        err = float((a.float() - b).abs().max())
                        scale = float(b.abs().max())
                        bwd_err = max(bwd_err, err)
                        check(err <= tol * scale,
                              f"flash backward d{name} {dtype} T={T} "
                              f"{mask_kind} causal={causal}: {err:.3e} > "
                              f"{tol:g} x max |grad| {scale:.3e}")
                        line.append(f"d{name} {str(dtype)[6:]} "
                                    f"{err / scale:.2e}")
                say("flash", f"T={T} mask={mask_kind} causal={causal}: "
                             f"max abs err {', '.join(line[:2])}; bwd err "
                             f"/ max |grad| {', '.join(line[2:])}")

    more = flash_bf16_shapes()
    fwd_err = max(fwd_err, more[0])
    check_flash_wide(fa)

    # the training shape: bf16, N=96, H=12, T=128, hd=64, no key mask
    q, k, v, _ = flash_case(TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, "none",
                            seed=5)
    dout = torch.randn_like(q)
    out, stats = fa.flash_attention_fwd(q, k, v)
    err = float((out.float() - flash_plain(q, k, v, None, False)).abs().max())
    fwd_err = max(fwd_err, err)
    check(err <= 2e-2, f"flash forward bf16 at the training shape: "
                       f"{err:.3e} > 0.02")
    line = [f"fwd {err:.2e}"]
    got = flash_grads(q, k, v, None, False, dout, torch.bfloat16, True)
    want = flash_grads(q, k, v, None, False, dout, torch.bfloat16, False)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, want):
        err = float((a.float() - b).abs().max())
        scale = float(b.abs().max())
        bwd_err = max(bwd_err, err)
        check(err <= 2e-2 * scale, f"flash backward d{name} bf16 at the "
                                   f"training shape: {err:.3e} > 0.02 x max "
                                   f"|grad| {scale:.3e}")
        line.append(f"d{name} {err / scale:.2e}")
    del got, want
    first = fa.flash_attention_bwd(q, k, v, out, dout, stats)
    again = fa.flash_attention_bwd(q, k, v, out, dout, stats)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two backward calls on the same inputs differ")
    del first, again
    say("flash", "two backward calls at the training shape: dq, dk, dv "
                 "bit-equal")
    say("flash", f"training shape N={TRAIN_BATCH} bf16 against the f32 plain "
                 f"version: max abs err {line[0]}; bwd err / max |grad| "
                 f"{', '.join(line[1:])}")
    key_mask = torch.ones(TRAIN_BATCH, 1, 1, TRAIN_SEQ, dtype=torch.bool,
                          device=DEVICE)
    plain_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = fa.blockwise_attention(*plain_in)
    lib_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=key_mask)
    lib_err = float((lib_out.detach().float() - out.float()).abs().max())
    say("flash", f"yardstick SDPA vs kernel at the training shape: max abs "
                 f"err {lib_err:.3e}")
    iters = 50

    def times():
        return (cuda_ms(lambda i: fa.flash_attention_fwd(q, k, v), iters),
                cuda_ms(lambda i: fa.flash_attention_bwd(
                    q, k, v, out, dout, stats), iters))

    kern1 = times()
    plain = (cuda_ms(lambda i: fa.blockwise_attention(q, k, v), iters),
             cuda_ms(lambda i: torch.autograd.grad(
                 plain_out, plain_in, dout, retain_graph=True), iters))
    lib = (cuda_ms(lambda i: F.scaled_dot_product_attention(
               q, k, v, attn_mask=key_mask), iters),
           cuda_ms(lambda i: torch.autograd.grad(
               lib_out, lib_in, dout, retain_graph=True), iters))
    kern2 = times()
    device_split("forward", lambda: fa.flash_attention_fwd(q, k, v))
    device_split("backward", lambda: fa.flash_attention_bwd(
        q, k, v, out, dout, stats))
    rows = []
    for j, (name, err) in enumerate((("flash_attention_fwd", fwd_err),
                                     ("flash_attention_bwd", bwd_err))):
        bound_ms, bound_by, nbytes, flops = flash_bound(q, backward=j == 1)
        ms = min(kern1[j], kern2[j])
        say("flash", f"{name} at N={TRAIN_BATCH} H={HEADS} T={TRAIN_SEQ} "
                     f"hd={HEAD_DIM} bf16: kernel {kern1[j]:.4f} / "
                     f"{kern2[j]:.4f} ms, plain {plain[j]:.4f} ms, library "
                     f"(SDPA with a boolean key mask, never called by the "
                     f"port) {lib[j]:.4f} ms; bound {bound_ms:.4f} ms by "
                     f"{bound_by} ({nbytes} B, {flops} flop at 989 TFLOP/s "
                     f"bf16); kernel at {nbytes / (ms * 1e-3) / 1e9:.1f} "
                     f"GB/s, {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplearning4j_tpu_torch/csrc/"
                               "flash_attention.cu",
                     "replaces": "deeplearning4j_tpu/ops/flash_attention.py:"
                                 + ("181" if j == 0 else "208"),
                     "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain[j], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib[j]})
    return tuple(rows)


def adam_case(n: int, offset: int, seed: int, fresh: bool = False):
    """Flat f32 master, m, v and grad of n elements at the JAX golden's
    scales, or with m = v = 0 (``fresh``, the first step's state);
    ``offset`` 1 starts every buffer one element into its allocation,
    which takes the kernel off its 16-byte vector path."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bufs = []
    for scale, positive in ((1.0, False), (0.01, False), (1e-4, True),
                            (2.0 ** 12, False)):
        x = torch.randn(n + offset, generator=g, device=DEVICE)
        x = (x.abs() if positive else x).mul_(0.0 if fresh and scale < 1
                                                else scale)
        bufs.append(x[offset:])
    return bufs


def phase_adam() -> dict:
    """Row of ``fused_adam_update``: checks against the plain version at
    step 300 with a loss scale and a clip, and at step 0 from zero
    moments, then times at the full flat buffer of BERT-base."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    upd = Adam(3e-4)
    hyper = dict(beta1=upd.beta1, beta2=upd.beta2, eps=upd.epsilon)
    max_err = 0.0
    for n, offset, it in ((BERT_BASE_PARAMS, 0, 300), (1_000_003, 1, 300),
                          (1_000_003, 0, 0)):
        master, m, v, grad = adam_case(n, offset, seed=offset, fresh=it == 0)
        sc = fu.adam_update_scalars(upd, it, inv_scale=2.0 ** -12,
                                    clip_norm=0.5,
                                    grad_norm=torch.linalg.vector_norm(grad))
        want = fu.adam_update_reference(master, m, v, grad, sc[0], sc[1],
                                        upd.beta1, upd.beta2, upd.epsilon)
        got = fu.adam_segment_update(master, m, v, grad, sc, **hyper)
        torch.cuda.synchronize()
        for name, a, b in zip(("master", "m", "v"), got, want):
            err = (a - b).abs()
            worst = float((err - 1e-6 * b.abs()).max())
            max_err = max(max_err, float(err.max()))
            check(worst <= 1e-7, f"fused Adam {name} n={n} step {it}: "
                                 f"|err| exceeds 1e-7 + 1e-6 |want| by "
                                 f"{worst:.3e}")
        say("adam", f"n={n} offset={offset} step {it}: kernel == plain "
                    f"within rtol 1e-6, atol 1e-7 (max abs err so far "
                    f"{max_err:.3e})")
        del master, m, v, grad, want, got

    # the train step's call: the whole BERT-base flat buffer, scalars
    # from the host
    n = BERT_BASE_PARAMS
    master, m, v, grad = adam_case(n, 0, seed=2)
    gscale, alpha = fu.adam_update_scalars(Adam(1e-4), 300).tolist()
    iters = 20

    def kernel_ms():
        return cuda_ms(lambda i: fu.fused_adam_update(
            master, m, v, grad, gscale, alpha, **hyper), iters, warmup=3)

    kern1 = kernel_ms()
    plain_ms = cuda_ms(lambda i: fu.adam_update_reference(
        master, m, v, grad, gscale, alpha, upd.beta1, upd.beta2,
        upd.epsilon), iters, warmup=3)
    p = torch.nn.Parameter(master.clone())
    p.grad = grad.clone()
    opt = torch.optim.Adam([p], lr=1e-4, fused=True)
    lib_ms = cuda_ms(lambda i: opt.step(), iters, warmup=3)
    del p, opt
    kern2 = kernel_ms()
    ms = min(kern1, kern2)
    nbytes, flops = 28 * n, 12 * n    # reads 4 f32, writes 3; ~12 flop each
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    say("adam", f"fused_adam_update at n={n}: kernel {kern1:.4f} / "
                f"{kern2:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"(torch.optim.Adam(fused=True), not the same function: its "
                f"eps comes after the bias correction) {lib_ms:.4f} ms; "
                f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B); kernel "
                f"at {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    del master, m, v, grad
    torch.cuda.empty_cache()
    return {"name": "fused_adam_update", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/fused_update.cu",
            "replaces": "deeplearning4j_tpu/ops/fused_update_pallas.py:147",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


# ----------------------------------------------------------------- train
def mlm_batch(vocab: int, batch: int, seq: int, seed: int):
    """bench.py's MLM batch from a numpy seed: random ids and labels,
    MASKED_PER_ROW masked positions per row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    labels = rng.integers(0, vocab, (batch, seq))
    mask_pos = np.zeros((batch, seq), np.float32)
    for r in range(batch):
        mask_pos[r, rng.choice(seq, MASKED_PER_ROW, replace=False)] = 1.0
    return ids, labels, mask_pos


def reset_train_counts() -> None:
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    fa.fwd_launches = fa.bwd_launches = fu.launches = 0


def train_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_update as fu

    return fa.fwd_launches, fa.bwd_launches, fu.launches


def phase_train(rows: dict) -> None:
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, bert_base, init_params_numpy)
    from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax

    cfg = bert_base()
    model = TransformerEncoder(cfg, attn_impl="flash")
    t0 = time.perf_counter()
    flat = FlatParams(params_from_jax(init_params_numpy(cfg, seed=0),
                                      device=DEVICE))
    check(flat.numel == BERT_BASE_PARAMS,
          f"bert_base() has {flat.numel} parameters")
    upd = Adam(1e-4)
    opt = upd.init_state(flat.master)
    step = model.make_train_step(upd, masked_capacity=MASKED_CAPACITY)
    batch = [torch.from_numpy(a).to(DEVICE) for a in
             mlm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    say("train", f"bert_base(): {flat.numel} parameters in one flat f32 "
                 f"master, {cfg.compute_dtype} compute, attn_impl=flash, "
                 f"dropout {cfg.dropout}; batch {TRAIN_BATCH} x "
                 f"{TRAIN_SEQ}, {MASKED_PER_ROW} masked per row, "
                 f"masked_capacity {MASKED_CAPACITY}, Adam lr "
                 f"{upd.learning_rate}; set up in "
                 f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    losses = [step(flat, opt, i, *batch, generator=gen)
              for i in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS, WARMUP_STEPS + TIMED_STEPS):
        losses.append(step(flat, opt, i, *batch, generator=gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, adam = train_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    steps = WARMUP_STEPS + TIMED_STEPS
    check((fwd, bwd, adam) == (cfg.n_layers * steps, cfg.n_layers * steps,
                               steps),
          f"launches fwd {fwd}, bwd {bwd}, adam {adam} over {steps} steps "
          f"of {cfg.n_layers} layers")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 1.0,
          f"first loss {losses[0]:.4f} is not within 1.0 of ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = wall / TIMED_STEPS
    say("train", f"{TIMED_STEPS} timed steps: {step_s * 1e3:.2f} ms/step, "
                 f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.1f} tokens/s; peak "
                 f"memory {peak} B ({peak / 2 ** 30:.2f} GiB); launches "
                 f"over {steps} steps: flash fwd {fwd}, flash bwd {bwd}, "
                 f"fused Adam {adam}")
    say("train", "losses " + " ".join(f"{x:.4f}" for x in losses))
    rows["flash_attention_fwd"]["launches"] = fwd
    rows["flash_attention_bwd"]["launches"] = bwd
    rows["fused_adam_update"]["launches"] = adam

    def run():
        for i in range(steps, steps + PROFILED_STEPS):
            step(flat, opt, i, *batch, generator=gen)

    busy_ms = device_profile("train", f"{PROFILED_STEPS} more steps", run,
                             ("flash_", "flash_fwd", "flash_bwd",
                              "fused_adam"))
    if busy_ms:
        per_step = busy_ms / PROFILED_STEPS
        say("train", f"device busy {per_step:.2f} ms per profiled step "
                     f"against {step_s * 1e3:.2f} ms per timed step "
                     f"(unprofiled): idle about "
                     f"{1 - per_step / (step_s * 1e3):.3f} of a step")


def run_steps(step, updater, tree, arrays, n_steps: int, device: str):
    """``n_steps`` of a flat train step from the numpy parameter tree on
    ``device``: the losses, the final flat master on the CPU, and the
    largest distance a parameter moved."""
    from deeplearning4j_tpu_torch.params import FlatParams, params_from_jax

    flat = FlatParams(params_from_jax(tree, device=device))
    start = flat.master.detach().cpu().clone()
    opt = updater.init_state(flat.master)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    losses = [float(step(flat, opt, i, *args)) for i in range(n_steps)]
    final = flat.master.detach().cpu()
    return losses, final, float((final - start).abs().max())


#: card-vs-CPU parameter limit: the sound runs differ by 1e-6 to 2e-6,
#: while one Adam step moves a parameter by up to lr = 1e-4, so a skipped
#: or wrong update fails it
PARITY_PARAM_ATOL = 2e-5


def compare_runs(what: str, card, cpu, lr: float) -> None:
    (lc, mc, moved), (lh, mh, _) = card, cpu
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    err = float((mc - mh).abs().max())
    say("parity", f"{what}: card losses {' '.join(f'{x:.6f}' for x in lc)}, "
                  f"CPU {' '.join(f'{x:.6f}' for x in lh)} (max relative "
                  f"diff {rel:.2e}, tolerance 1e-4); parameters max abs diff "
                  f"{err:.2e} (tolerance {PARITY_PARAM_ATOL:g}); the card "
                  f"moved a parameter by up to {moved:.3e}")
    check(rel <= 1e-4, f"{what}: card and CPU losses differ by {rel:.3e}")
    check(err <= PARITY_PARAM_ATOL,
          f"{what}: card and CPU parameters differ by {err:.3e}")
    check(moved >= 0.5 * lr, f"{what}: the card's update moved no parameter "
                             f"by half a step of lr {lr:g} ({moved:.3e})")


def phase_parity() -> None:
    """The training path through the kernels on the card against the
    same path through the plain versions on the CPU."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.bert_classifier import (
        BertSequenceClassifier)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, bert_base, init_params_numpy)

    cfg = bert_base()
    cfg.n_layers, cfg.dropout, cfg.compute_dtype = 2, 0.0, "float32"
    tree = init_params_numpy(cfg, seed=3)
    batch = mlm_batch(cfg.vocab_size, 8, TRAIN_SEQ, seed=4)
    upd = Adam(1e-4)
    step = TransformerEncoder(cfg, attn_impl="flash").make_train_step(
        upd, masked_capacity=MASKED_CAPACITY)
    reset_train_counts()
    card = run_steps(step, upd, tree, batch, 3, DEVICE)
    check(train_counts() == (6, 6, 3),
          f"card MLM steps launched {train_counts()}, not (6, 6, 3)")
    cpu = run_steps(step, upd, tree, batch, 3, "cpu")
    check(train_counts() == (6, 6, 3), "the CPU steps launched a kernel")
    compare_runs("MLM, 2 layers, 3 steps", card, cpu, upd.learning_rate)

    clf = BertSequenceClassifier(cfg, 3, attn_impl="flash")
    ctree = clf.init_params_numpy(seed=5, encoder_params=tree)
    lens = np.array([128, 100, 77, 64, 33, 16, 5, 1])
    pad = (np.arange(TRAIN_SEQ)[None, :] < lens[:, None]).astype(np.float32)
    arrays = (batch[0], np.array([0, 1, 2, 0, 1, 2, 0, 1]), pad)
    cstep = clf.make_train_step(upd)
    reset_train_counts()
    card = run_steps(cstep, upd, ctree, arrays, 1, DEVICE)
    check(train_counts() == (2, 2, 1),
          f"card fine-tune step launched {train_counts()}, not (2, 2, 1)")
    compare_runs("BertSequenceClassifier, padding mask, 1 step", card,
                 run_steps(cstep, upd, ctree, arrays, 1, "cpu"),
                 upd.learning_rate)

# ------------------------------------------------------------ LSTM kernels
LSTM_HIDDEN, LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ = 256, 77, 256, 200


def lstm_case(T: int, N: int, H: int, seed: int):
    """x_proj [T, N, 4H], w_hh [H, 4H] and non-zero h0, c0 [N, H] at the
    scales of a trained layer (f32, on the card)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x_proj = 0.5 * torch.randn(T, N, 4 * H, generator=g, device=DEVICE)
    w_hh = torch.randn(H, 4 * H, generator=g, device=DEVICE) / math.sqrt(H)
    h0 = 0.5 * torch.randn(N, H, generator=g, device=DEVICE)
    c0 = 0.5 * torch.randn(N, H, generator=g, device=DEVICE)
    return x_proj, w_hh, h0, c0


def lstm_bound(T: int, N: int, H: int, nbytes_el: int, backward: bool):
    """(bound_ms, bound_by, bytes, flops) of one call at the training
    shape: the forward reads x_proj, w_hh, h0, c0 and writes ys, the cell
    stream, hT, cT; its matmul is T steps of [N, H] @ [H, 4H]. The backward
    call reads x_proj, w_hh, h0, c0, ys, cs, dys, dhT, dcT and writes
    d x_proj, d w_hh, dh0, dc0; its matmuls are the gate recompute,
    da @ w_hh^T and the weight gradient, three of the forward's size."""
    xp = T * N * 4 * H * nbytes_el
    seq = T * N * H * nbytes_el
    w = H * 4 * H * nbytes_el
    state = N * H * nbytes_el
    one = 2 * T * N * H * 4 * H
    if backward:
        nbytes, flops = 2 * xp + 3 * seq + 2 * w + 6 * state, 3 * one
    else:
        nbytes, flops = xp + 2 * seq + w + 4 * state, one
    return (*bound(nbytes, flops, BF16_FLOPS), nbytes, flops)


def phase_lstm_kernels() -> tuple:
    """Rows of the LSTM forward and backward kernels: checks against the
    plain versions, one refused shape, then times at the training shape."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    H = LSTM_HIDDEN
    fwd_err = bwd_err = 0.0
    # the training shapes, then phase 10's sampling shapes: rnnTimeStep
    # (T=1) and output() over 64 characters, both at batch 4
    shapes = [(T, N) for T in (1, 50, 200) for N in (1, 256)]
    for T, N in shapes + [(1, 4), (64, 4)]:
        x_proj, w_hh, h0, c0 = lstm_case(T, N, H, seed=T + N)
        g = torch.Generator(device=DEVICE).manual_seed(T * N)
        dys = torch.randn(T, N, H, generator=g, device=DEVICE)
        dhT = torch.randn(N, H, generator=g, device=DEVICE)
        dcT = torch.randn(N, H, generator=g, device=DEVICE)
        line = []
        for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-4),
                                 (torch.bfloat16, 2e-2, 2e-2)):
            ins = [t.to(dtype) for t in (x_proj, w_hh, h0, c0)]
            f32 = [t.float() for t in ins]
            want = lr.lstm_recurrence_reference(*f32, collect_cell=True)
            # bf16 takes the cluster route, held against the plain version
            # and against the first (grid) design on the same inputs
            routes = ("cluster", "grid") if dtype == torch.bfloat16 \
                else ("grid",)
            check(lr.fwd_route(*ins) == routes[0],
                  f"LSTM forward {dtype} T={T} N={N} takes the "
                  f"{lr.fwd_route(*ins)} route, not {routes[0]}")
            outs = {}
            for route in routes:
                for cells in (False, True):
                    got = lr.lstm_recurrence_fwd(*ins, collect_cell=cells,
                                                 route=route)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        check(a.dtype == dtype and a.shape == b.shape,
                              f"LSTM forward output {a.dtype} "
                              f"{tuple(a.shape)}")
                        check(bool(torch.isfinite(a).all()),
                              "LSTM forward output not finite")
                        err = float((a.float() - b).abs().max())
                        if route == routes[0]:
                            fwd_err = max(fwd_err, err)
                        check(err <= tol, f"LSTM forward {dtype} {route} "
                                          f"T={T} N={N} cells={cells}: "
                                          f"{err:.3e} > {tol:g}")
                    outs[route] = got
                line.append(f"fwd {str(dtype)[6:]} {route} {err:.2e}")
            if dtype == torch.bfloat16:
                again = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in
                          zip(again, outs["cluster"])),
                      f"LSTM forward T={T} N={N}: two cluster-route calls "
                      f"differ")
                gap = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(outs["cluster"], outs["grid"]))
                check(gap <= tol, f"LSTM forward T={T} N={N}: cluster and "
                                  f"grid routes {gap:.3e} apart > {tol:g}")
                line.append(f"cluster vs grid {gap:.2e} (bit-equal twice)")
            ys_k, _, _, cs_k = lr.lstm_recurrence_fwd(*ins,
                                                      collect_cell=True)
            up = [t.to(dtype) for t in (dys, dhT, dcT)]
            got = lr.lstm_recurrence_bwd(*ins, ys_k, cs_k, *up)
            ref = lr.lstm_recurrence_backward_reference(
                *f32, want[0], want[3], *(t.float() for t in up))
            torch.cuda.synchronize()
            for name, a, b in zip(("dx_proj", "dw_hh", "dh0", "dc0"),
                                  got, ref):
                check(a.dtype == dtype and a.shape == b.shape,
                      f"LSTM {name} {a.dtype} {tuple(a.shape)}")
                err = float((a.float() - b).abs().max())
                scale = float(b.abs().max())
                bwd_err = max(bwd_err, err)
                check(err <= gtol * scale,
                      f"LSTM backward {name} {dtype} T={T} N={N}: "
                      f"{err:.3e} > {gtol:g} x max |grad| {scale:.3e}")
                line.append(f"{name} {str(dtype)[6:]} {err / scale:.2e}")
            if dtype == torch.bfloat16:
                # d w_hh against the f32 sum over the kernel's own stored
                # ys and cs: the f32 da it sums must stay within the final
                # bf16 rounding; the sum of bf16-rounded da is printed
                # beside it
                same = lr.lstm_recurrence_backward_reference(
                    *f32, ys_k.float(), cs_k.float(),
                    *(t.float() for t in up))[1]
                h_prev = torch.cat([ins[2][None], ys_k[:-1]])
                rounded = (h_prev.reshape(T * N, H).T
                           @ got[0].reshape(T * N, 4 * H))
                scale = float(same.abs().max())
                e_f32 = float((got[1].float() - same).abs().max()) / scale
                e_bf16 = float((rounded.float() - same).abs().max()) / scale
                check(e_f32 <= 2 ** -8, f"LSTM bf16 dw_hh T={T} N={N} off "
                                        f"its f32 sum by {e_f32:.3e}")
                line.append(f"dw_hh bf16 on its own ys {e_f32:.2e} (from "
                            f"bf16 da {e_bf16:.2e})")
        say("lstm", f"H={H} T={T} N={N}: {', '.join(line)} (fwd: max "
                    f"abs err; bwd: err / max |grad|; plan "
                    f"{lr.last_plan})")
    check_lstm_wide(lr)
    check_lstm_f16(lr, H)
    check_lstm_mixed(lr, H)
    wide_rows = lstm_wide_kernels(lr)

    # the training shape: bf16, T=200, N=256, H=256
    T, N = LSTM_SEQ, LSTM_BATCH
    x_proj, w_hh, h0, c0 = (t.to(torch.bfloat16) for t in
                            lstm_case(T, N, H, seed=11))
    g = torch.Generator(device=DEVICE).manual_seed(12)
    dys = torch.randn(T, N, H, generator=g, device=DEVICE).to(torch.bfloat16)
    check(lr.fwd_route(x_proj, w_hh, h0, c0) == "cluster",
          "the training shape must take the forward's cluster route")
    ys, hT, cT, cs = lr.lstm_recurrence_fwd(x_proj, w_hh, h0, c0,
                                            collect_cell=True)
    fwd_plan = lr.last_plan
    lr.lstm_recurrence_fwd(x_proj, w_hh, h0, c0, collect_cell=True,
                           route="grid")
    fwd_grid_plan = lr.last_plan
    check(lr.bwd_route(x_proj, w_hh, h0, ys) == "cluster",
          "the training shape must take the backward's cluster route")
    got = lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys)
    bwd_plan = lr.last_plan
    again = lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys)
    first = lr.lstm_recurrence_bwd(x_proj, w_hh, h0, c0, ys, cs, dys,
                                   route="grid")
    grid_plan = lr.last_plan
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "two cluster-route backward calls differ")
    ref = lr.lstm_recurrence_backward_reference(
        *(t.float() for t in (x_proj, w_hh, h0, c0, ys, cs, dys)))
    line = []
    for name, a, b, c in zip(("dx_proj", "dw_hh", "dh0", "dc0"), got, first,
                             ref):
        scale = float(c.abs().max())
        e_cl = float((a.float() - c).abs().max()) / scale
        e_gr = float((b.float() - c).abs().max()) / scale
        check(e_cl <= 2e-2 and e_gr <= 2e-2,
              f"LSTM backward {name} at the training shape: cluster "
              f"{e_cl:.3e}, grid {e_gr:.3e} of max |grad| > 0.02")
        line.append(f"{name} {e_cl:.2e} / {e_gr:.2e}")
    say("lstm", f"backward at T={T} N={N} H={H} bf16, err / max |grad|, "
                f"cluster route / first (grid) design: {', '.join(line)}; "
                f"two cluster-route calls bit-equal")
    iters = 20

    def kernels():
        return (cuda_ms(lambda i: lr.lstm_recurrence_fwd(
                    x_proj, w_hh, h0, c0, collect_cell=True), iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_bwd(
                    x_proj, w_hh, h0, c0, ys, cs, dys), iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_bwd(
                    x_proj, w_hh, h0, c0, ys, cs, dys, route="grid"),
                    iters, 3),
                cuda_ms(lambda i: lr.lstm_recurrence_fwd(
                    x_proj, w_hh, h0, c0, collect_cell=True, route="grid"),
                    iters, 3))

    kern1 = kernels()
    plain = (cuda_ms(lambda i: lr.lstm_recurrence_reference(
                 x_proj, w_hh, h0, c0, collect_cell=True), 3, 1),
             cuda_ms(lambda i: lr.lstm_recurrence_backward_reference(
                 x_proj, w_hh, h0, c0, ys, cs, dys), 3, 1))
    lib, port_layer = lstm_yardstick(x_proj.shape, iters)
    kern2 = kernels()
    say("lstm", f"B5 bwd, first (grid) design at T={T} N={N} H={H} bf16 "
                f"(plan {grid_plan}), in turns with the cluster route: "
                f"{kern1[2]:.4f} / {kern2[2]:.4f} ms")
    say("lstm", f"B5 fwd, first (grid) design at T={T} N={N} H={H} bf16 "
                f"(plan {fwd_grid_plan}), in turns with the cluster route "
                f"and cuDNN: {kern1[3]:.4f} / {kern2[3]:.4f} ms "
                f"({min(kern1[3], kern2[3]) / T * 1e3:.2f} us per step)")
    # the sampling shape (rnnTimeStep: T=1, N=4) at bf16, each route in
    # turns: a call there is the launch and the prologue
    one = [t.to(torch.bfloat16) for t in lstm_case(1, 4, H, seed=41)]
    samp = [cuda_ms(lambda i: lr.lstm_recurrence_fwd(*one, route=r), 200)
            for r in ("cluster", "grid", "cluster", "grid")]
    say("lstm", f"B5 fwd at the sampling shape T=1 N=4 H={H} bf16, in turns: "
                f"cluster route {samp[0] * 1e3:.1f} / {samp[2] * 1e3:.1f} us, "
                f"grid route {samp[1] * 1e3:.1f} / {samp[3] * 1e3:.1f} us per "
                f"call (CUDA events)")
    for what, run in (
            ("B5 fwd, cluster route", lambda: lr.lstm_recurrence_fwd(
                x_proj, w_hh, h0, c0, collect_cell=True)),
            ("B5 fwd, grid route", lambda: lr.lstm_recurrence_fwd(
                x_proj, w_hh, h0, c0, collect_cell=True, route="grid")),
            ("B5 bwd, cluster route", lambda: lr.lstm_recurrence_bwd(
                x_proj, w_hh, h0, c0, ys, cs, dys))):
        device_split(what, run, calls=10, pattern=r"lstm_\w+?_kernel",
                     phase="lstm", shape=f"T={T} N={N} H={H} bf16")
    rows = []
    for j, (name, err, plan) in enumerate((("B5", fwd_err, fwd_plan),
                                           ("B5 bwd", bwd_err, bwd_plan))):
        bound_ms, bound_by, nbytes, flops = lstm_bound(T, N, H, 2, j == 1)
        ms = min(kern1[j], kern2[j])
        say("lstm", f"{name} at T={T} N={N} H={H} bf16 (plan {plan}): kernel "
                    f"{kern1[j]:.4f} / {kern2[j]:.4f} ms ({ms / T * 1e3:.2f} "
                    f"us per step), plain {plain[j]:.4f} ms, library "
                    f"(torch.nn.LSTM on cuDNN, projection included, never "
                    f"called by the port) {lib[j]:.4f} ms against the port's "
                    f"projection + kernel {port_layer[j]:.4f} ms; bound "
                    f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} "
                    f"flop at 989 TFLOP/s bf16); kernel at "
                    f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                    f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplearning4j_tpu_torch/csrc/"
                               "lstm_recurrence.cu",
                     "replaces": "deeplearning4j_tpu/ops/lstm_pallas.py:123",
                     "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain[j], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib[j]})
    return tuple(rows) + wide_rows


#: the wide route's widths timed in phase 8 at the training batch: the JAX
#: bench's wide char-LSTM (its row) and H=512 beside it (printed)
LSTM_WIDE_ROWS = (1024, 512)


def lstm_wide_kernels(lr) -> tuple:
    """Rows of the wide route, B5 and B5 bwd at T=200, N=256, H=1024 bf16
    (H=512 printed beside them): each direction against its plain version
    (forward within 2e-2, backward within 2e-2 of max |grad|) and two calls
    bit-equal; then CUDA-event times of the kernel calls (the backward's
    with its f32 dw matmul, also timed alone), the kernels' device time
    (profiler), the plain versions', cuDNN's (``torch.nn.LSTM``, never
    called by the port) and the bounds."""
    T, N = LSTM_SEQ, LSTM_BATCH
    rows = []
    for H in LSTM_WIDE_ROWS:
        ins = [t.to(torch.bfloat16) for t in lstm_case(T, N, H, seed=H)]
        g = torch.Generator(device=DEVICE).manual_seed(H + 1)
        up = [torch.randn(shape, generator=g, device=DEVICE)
              .to(torch.bfloat16) for shape in ((T, N, H), (N, H), (N, H))]
        check(lr.fwd_route(*ins) == "wide", f"B5 at H={H} bf16 takes the "
                                            f"{lr.fwd_route(*ins)} route")
        f32 = [t.float() for t in ins]
        want = lr.lstm_recurrence_reference(*f32, collect_cell=True)
        got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        fplan = lr.last_plan
        again = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"B5 wide H={H}: two forward calls differ")
        ferr = max(float((a.float() - b).abs().max())
                   for a, b in zip(got, want))
        check(ferr <= 2e-2, f"B5 wide H={H}: forward {ferr:.3e} > 2e-2")
        ys, cs = got[0], got[3]
        check(lr.bwd_route(ins[0], ins[1], ins[2], ys) == "wide",
              f"B5 bwd at H={H} bf16 not on the wide route")
        grads = lr.lstm_recurrence_bwd(*ins, ys, cs, *up)
        bplan = lr.last_plan
        twice = lr.lstm_recurrence_bwd(*ins, ys, cs, *up)
        ref = lr.lstm_recurrence_backward_reference(
            *f32, ys.float(), cs.float(), *(t.float() for t in up))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads, twice)),
              f"B5 wide H={H}: two backward calls differ")
        babs = max(float((a.float() - b).abs().max())
                   for a, b in zip(grads, ref))
        brel = max(float((a.float() - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(grads, ref))
        check(brel <= 2e-2, f"B5 bwd wide H={H}: {brel:.3e} of max |grad| "
                            f"> 2e-2")

        def fwd(i):
            return lr.lstm_recurrence_fwd(*ins, collect_cell=True)

        def bwd(i):
            return lr.lstm_recurrence_bwd(*ins, ys, cs, *up)

        kern = (cuda_ms(fwd, 10, 2), cuda_ms(bwd, 10, 2))
        h_prev = torch.cat([ins[2][None], ys[:-1]]).float() \
            .reshape(T * N, H)
        da = torch.randn(T * N, 4 * H, generator=g, device=DEVICE)
        dw_ms = cuda_ms(lambda i: torch.matmul(h_prev.T, da), 10, 2)
        plain = (cuda_ms(lambda i: lr.lstm_recurrence_reference(
                     *ins, collect_cell=True), 2, 1),
                 cuda_ms(lambda i: lr.lstm_recurrence_backward_reference(
                     *ins, ys, cs, *up), 2, 1))
        lib, port_layer = lstm_yardstick((T, N, 4 * H), 10)
        shape = f"T={T} N={N} H={H} bf16"
        split = [device_split(what, lambda: run(0), calls=5,
                              pattern=r"lstm_\w+?_kernel", phase="lstm",
                              shape=shape)
                 for what, run in (("B5 fwd, wide route", fwd),
                                   ("B5 bwd, wide route", bwd))]
        for j, (name, err, plan) in enumerate((("B5 wide", ferr, fplan),
                                               ("B5 bwd wide", babs,
                                                bplan))):
            bound_ms, bound_by, nbytes, flops = lstm_bound(T, N, H, 2, j == 1)
            dev = split[j]
            say("lstm", f"{name} at {shape} (plan {plan}): kernel call "
                        f"{kern[j]:.4f} ms ({kern[j] / T * 1e3:.2f} us per "
                        f"step; kernel device time "
                        + (f"{dev / 1e3:.4f} ms" if dev else "not measured")
                        + (f", f32 dw matmul alone {dw_ms:.4f} ms" if j
                           else "")
                        + f"), plain {plain[j]:.4f} ms, library (torch.nn."
                          f"LSTM on cuDNN, projection included) {lib[j]:.4f} "
                          f"ms against the port's projection + kernel "
                          f"{port_layer[j]:.4f} ms; bound {bound_ms:.4f} ms "
                          f"by {bound_by} ({nbytes} B, {flops} flop at 989 "
                          f"TFLOP/s bf16); errors: forward max abs "
                          f"{ferr:.2e}, backward max abs {babs:.2e} "
                          f"({brel:.2e} of max |grad|); two calls bit-equal")
            if H == LSTM_WIDE_ROWS[0]:
                rows.append({"name": name, "route": "cuda",
                             "source": "deeplearning4j_tpu_torch/csrc/"
                                       "lstm_recurrence.cu",
                             "replaces":
                                 "deeplearning4j_tpu/ops/lstm_pallas.py:123",
                             "launches": 0, "max_abs_err": err,
                             "ms": kern[j], "plain_ms": plain[j],
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": lib[j]})
    return tuple(rows)


#: wide (T, N, H) (C10): N=512 at the JAX bench's width (f32 on the grid
#: route: a forward block walks 4 batch tiles with w_hh in shared memory,
#: the backward reads w_hh from L2; bf16 on the wide route), a width whose
#: w_hh no block can keep (both directions read it from L2), and N=512 at
#: the training width (bf16 there takes the cluster routes, two waves of
#: clusters)
LSTM_WIDE = ((5, 512, 1024), (3, 8, 2048), (5, 512, 256))


def lstm_pair(lr, ins, up, dtype):
    """Forward (with the cell stream) and backward kernels on ``ins`` and
    the upstream ``up``, against the plain versions at f32 on the same
    rounded values: (forward max abs err, backward max err / max |grad|,
    the forward's plan, the backward's plan)."""
    f32 = [t.float() for t in ins]
    want = lr.lstm_recurrence_reference(*f32, collect_cell=True)
    got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
    fplan = lr.last_plan
    torch.cuda.synchronize()
    ferr = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
    grads = lr.lstm_recurrence_bwd(*ins, got[0], got[3], *up)
    bplan = lr.last_plan
    ref = lr.lstm_recurrence_backward_reference(
        *f32, got[0].float(), got[3].float(), *(t.float() for t in up))
    torch.cuda.synchronize()
    for a, t in zip((*got, *grads), (*ins[:1],) * 4 + tuple(ins)):
        check(a.dtype == t.dtype, f"LSTM {dtype} output {a.dtype}")
    berr = max(float((a.float() - b).abs().max()) / float(b.abs().max())
               for a, b in zip(grads, ref))
    return ferr, berr, fplan, bplan


def check_lstm_wide(lr) -> None:
    """C10: wide shapes, both directions at f32 and bf16 on the routes
    they take, against the plain versions (f32 within
    1e-5 and 1e-4 of max |grad|; bf16 within 2e-2 of the f32 plain
    version on the bf16-rounded inputs)."""
    for T, N, H in LSTM_WIDE:
        g = torch.Generator(device=DEVICE).manual_seed(N + H)
        base = lstm_case(T, N, H, seed=N + H)
        up = [torch.randn(shape, generator=g, device=DEVICE)
              for shape in ((T, N, H), (N, H), (N, H))]
        for dtype, tol, gtol in ((torch.float32, 1e-5, 1e-4),
                                 (torch.bfloat16, 2e-2, 2e-2)):
            ins = [t.to(dtype) for t in base]
            route = lr.fwd_route(*ins)
            ferr, berr, fplan, bplan = lstm_pair(
                lr, ins, [t.to(dtype) for t in up], dtype)
            check(ferr <= tol and berr <= gtol,
                  f"LSTM {dtype} T={T} N={N} H={H}: forward {ferr:.3e} > "
                  f"{tol:g} or backward {berr:.3e} > {gtol:g}")
            say("lstm", f"wide shape, {str(dtype)[6:]} T={T} "
                        f"N={N} H={H}, {route} route: forward max abs err "
                        f"{ferr:.2e} (plan "
                        f"{fplan}), backward err / max |grad| {berr:.2e} "
                        f"(plan {bplan}); grid plan: blocks, rows per "
                        f"thread, chunk, shared bytes, blocks per SM, tiles "
                        f"per block, w_hh in shared memory")


def check_lstm_f16(lr, H: int) -> None:
    """C9: f16 x_proj and state with an f16 or a bf16 w_hh, the grid route
    at f32 over widened inputs, outputs and gradients in the primal
    dtypes, against the plain versions on the same values: values within
    2e-3, gradients within 2e-3 of max |grad| (the f16 ones) or one bf16
    step (a bf16 w_hh's)."""
    T, N = 50, 64
    base = lstm_case(T, N, H, seed=51)
    g = torch.Generator(device=DEVICE).manual_seed(52)
    f16 = torch.float16
    for w_dtype in (f16, torch.bfloat16):
        ins = [base[0].to(f16), base[1].to(w_dtype), base[2].to(f16),
               base[3].to(f16)]
        check(lr.fwd_route(*ins) == "grid", "f16 LSTM not on the grid route")
        want = lr.lstm_recurrence_reference(*ins, collect_cell=True)
        got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        up = [torch.randn(shape, generator=g, device=DEVICE).to(f16)
              for shape in ((T, N, H), (N, H), (N, H))]
        ref = lr.lstm_recurrence_backward_reference(*ins, want[0], want[3],
                                                    *up)
        grads = lr.lstm_recurrence_bwd(*ins, want[0], want[3], *up)
        torch.cuda.synchronize()
        worst = []
        for name, a, b, grad in (
                *((n, a, b, False) for n, a, b in
                  zip(("ys", "hT", "cT", "cs"), got, want)),
                *((n, a, b, True) for n, a, b in
                  zip(("dx_proj", "dw_hh", "dh0", "dc0"), grads, ref))):
            check(a.dtype == b.dtype, f"f16 LSTM {name}: {a.dtype} against "
                                      f"{b.dtype}")
            err = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max()) if grad else 1.0
            tol = (2e-3 if a.dtype == f16 else 2 ** -7) * scale
            check(err <= tol, f"f16 LSTM (w_hh {w_dtype}) {name}: {err:.3e}"
                              f" > {tol:.3e}")
            worst.append(f"{name} {err / scale:.2e}")
        say("lstm", f"f16 x_proj and state, w_hh {str(w_dtype)[6:]}, T={T} "
                    f"N={N} H={H}, grid route over widened inputs, against "
                    f"the plain versions (values abs, gradients / max "
                    f"|grad|): {', '.join(worst)}")


#: (x_proj, w_hh, h0 and c0) dtypes of the mixed LSTM calls (C6)
LSTM_MIXES = ((torch.float32, torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16, torch.float32))


#: f32 forward outputs of a mixed call with a bf16 w_hh: the recurrence
#: rounds h to bf16 before every product, so a 1-ulp change in f32 can flip
#: a rounding and moves the outputs by up to 6.6e-4 at T=200, N=256 in the
#: plain version itself (x_proj scaled by 1 + 2^-23)
MIXED_ROUNDED_TOL = 2e-3


def mixed_tol(t, scale: float, f32_tol: float) -> float:
    """f32 results within ``f32_tol`` (of ``scale`` for gradients); bf16
    ones within one bf16 step of the largest value."""
    return f32_tol * scale if t.dtype == torch.float32 else 2 ** -7 * scale


def check_lstm_mixed(lr, H: int) -> None:
    """C6: the three mixes, forward and backward on the card (the grid
    route at f32 over widened inputs) against the plain versions on the
    same mixed inputs: output and gradient dtypes equal, values within
    1e-5 (f32) or one bf16 step, gradients within 1e-4 of max |grad|
    (f32) or one bf16 step."""
    T, N = 50, 64
    x_proj, w_hh, h0, c0 = lstm_case(T, N, H, seed=31)
    g = torch.Generator(device=DEVICE).manual_seed(32)
    for mix in LSTM_MIXES:
        ins = [t.to(d) for t, d in zip((x_proj, w_hh, h0, c0),
                                       (mix[0], mix[1], mix[2], mix[2]))]
        check(lr.fwd_route(*ins) == "grid", f"mixed {mix} not on the grid "
                                            f"route")
        want = lr.lstm_recurrence_reference(*ins, collect_cell=True)
        got = lr.lstm_recurrence_fwd(*ins, collect_cell=True)
        ys, cs = want[0], want[3]
        dys, dhT, dcT = (torch.randn(shape, generator=g, device=DEVICE)
                         .to(mix[0]) for shape in ((T, N, H), (N, H), (N, H)))
        ref = lr.lstm_recurrence_backward_reference(*ins, ys, cs, dys, dhT,
                                                    dcT)
        grads = lr.lstm_recurrence_bwd(*ins, ys, cs, dys, dhT, dcT)
        torch.cuda.synchronize()
        worst = []
        for name, a, b, absolute in (
                *((n, a, b, True) for n, a, b in
                  zip(("ys", "hT", "cT", "cs"), got, want)),
                *((n, a, b, False) for n, a, b in
                  zip(("dx_proj", "dw_hh", "dh0", "dc0"), grads, ref))):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"mixed {mix} {name}: {a.dtype} {tuple(a.shape)} against "
                  f"{b.dtype} {tuple(b.shape)}")
            err = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max())
            f32_tol = ((MIXED_ROUNDED_TOL if mix[1] == torch.bfloat16
                        else 1e-5) if absolute else 1e-4)
            tol = mixed_tol(a, max(1.0, scale) if absolute else scale,
                            f32_tol)
            check(err <= tol, f"mixed {mix} {name}: {err:.3e} > {tol:.3e}")
            worst.append(f"{name} {str(a.dtype)[6:]} {err:.2e}")
        say("lstm", f"mixed (x_proj, w_hh, state) "
                    f"{tuple(str(d)[6:] for d in mix)} at T={T} N={N} H={H}, "
                    f"grid route over widened inputs, max abs err against "
                    f"the plain versions: {', '.join(worst)}")


def lstm_yardstick(shape, iters: int):
    """``torch.nn.LSTM`` (cuDNN) forward and backward over one layer with
    the port's weights transposed (``weight_ih = W^T``, ``weight_hh =
    RW^T``, ``bias_ih = b``, ``bias_hh = 0``), input width H, bf16 (f32 if
    cuDNN refuses bf16), and the port's own layer (projection matmul +
    kernels) on the same inputs: ``((lib_fwd, lib_bwd), (port_fwd,
    port_bwd))`` in ms. The two outputs' difference is printed first."""
    from deeplearning4j_tpu_torch.ops.nn import lstm_layer

    T, N, four_h = shape
    H = four_h // 4
    g = torch.Generator(device=DEVICE).manual_seed(13)
    bf = torch.bfloat16
    x = torch.randn(N, T, H, generator=g, device=DEVICE).to(bf)
    W = (torch.randn(H, 4 * H, generator=g, device=DEVICE)
         / math.sqrt(H)).to(bf)
    RW = (torch.randn(H, 4 * H, generator=g, device=DEVICE)
          / math.sqrt(H)).to(bf)
    b = (0.1 * torch.randn(4 * H, generator=g, device=DEVICE)).to(bf)
    dy = torch.randn(N, T, H, generator=g, device=DEVICE).to(bf)
    leaves = [t.clone().requires_grad_(True) for t in (x, W, RW, b)]
    port_out, _ = lstm_layer(*leaves)
    for lib_dtype in (bf, torch.float32):
        # cuDNN's RNN may refuse bf16; then the yardstick runs at f32
        cudnn = torch.nn.LSTM(H, H, batch_first=True).to(DEVICE, lib_dtype)
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(W.T)
            cudnn.weight_hh_l0.copy_(RW.T)
            cudnn.bias_ih_l0.copy_(b)
            cudnn.bias_hh_l0.zero_()
        cudnn.flatten_parameters()    # one weight buffer, as cuDNN wants
        lib_x = x.to(lib_dtype).requires_grad_(True)
        try:
            lib_out, _ = cudnn(lib_x)
            torch.cuda.synchronize()
            break
        except RuntimeError as e:
            say("lstm", f"cuDNN LSTM refused {lib_dtype}: {e}")
    lib_dy = dy.to(lib_dtype)
    err = float((lib_out.detach().float() - port_out.detach().float())
                .abs().max())
    say("lstm", f"yardstick cuDNN LSTM ({lib_dtype}) vs the port's bf16 "
                f"layer: max abs err {err:.3e}")
    lib = (cuda_ms(lambda i: cudnn(lib_x), iters, 3),
           cuda_ms(lambda i: torch.autograd.grad(
               lib_out, [lib_x, *cudnn.parameters()], lib_dy,
               retain_graph=True), iters, 3))
    port = (cuda_ms(lambda i: lstm_layer(*leaves), iters, 3),
            cuda_ms(lambda i: torch.autograd.grad(
                port_out, leaves, dy, retain_graph=True), iters, 3))
    return lib, port


# -------------------------------------------------------- char-LSTM train
def textgen_params_numpy(vocab: int, hidden: int, seed: int):
    """TextGenerationLSTM's parameters in the JAX layout from a numpy
    seed: Xavier-normal W [in, 4H], RW [H, 4H], zero b with the forget
    gate's slice at 1, and the head's W [H, vocab], b."""
    rng = np.random.default_rng(seed)

    def xavier(n_in, n_out):
        return (rng.standard_normal((n_in, n_out))
                * math.sqrt(2.0 / (n_in + n_out))).astype(np.float32)

    layers = []
    for n_in in (vocab, hidden):
        b = np.zeros(4 * hidden, np.float32)
        b[hidden:2 * hidden] = 1.0
        layers.append({"W": xavier(n_in, 4 * hidden),
                       "RW": xavier(hidden, 4 * hidden), "b": b})
    layers.append({"W": xavier(hidden, vocab),
                   "b": np.zeros(vocab, np.float32)})
    return layers


def char_batch(vocab: int, batch: int, seq: int, seed: int, dtype, device):
    """bench_common.build_char_lstm's batch: one-hot ids from
    ``np.random.default_rng(seed)``, labels the next character (rolled
    by one)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    eye = np.eye(vocab, dtype=np.float32)
    return (torch.from_numpy(eye[ids]).to(device, dtype),
            torch.from_numpy(eye[np.roll(ids, -1, 1)]).to(device, dtype))


def textgen_net(dtype: str, tbptt: int, device, seed: int = 0,
                hidden: int = LSTM_HIDDEN):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = TextGenerationLSTM(vocab_size=LSTM_VOCAB, hidden=hidden,
                              tbptt_length=tbptt).conf()
    conf.dtype = dtype
    net = MultiLayerNetwork(conf, device=device).init()
    net.params_list = mln_params_from_numpy(
        textgen_params_numpy(LSTM_VOCAB, hidden, seed), device=device,
        dtype=net._dtype)
    return net


def eval_loss_f32(params_list, x, y) -> float:
    """The network loss of ``params_list`` (cast to f32) on ``(x, y)`` at
    f32, through an f32 twin of the training network."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    net = textgen_net("float32", 0, x.device)
    net.params_list = [{k: v.float() for k, v in p.items()}
                       for p in params_list]
    return net.score(DataSet(x.float(), y.float()))


def lstm_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    return lr.fwd_launches, lr.bwd_launches


def lstm_cluster_counts() -> tuple:
    """The launches of :func:`lstm_counts` that took the cluster route."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    return lr.fwd_cluster_launches, lr.bwd_cluster_launches


def lstm_wide_counts() -> tuple:
    """The launches of :func:`lstm_counts` that took the wide route."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    return lr.fwd_wide_launches, lr.bwd_wide_launches


def reset_lstm_counts() -> None:
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    lr.fwd_launches = lr.bwd_launches = 0
    lr.fwd_cluster_launches = lr.bwd_cluster_launches = 0
    lr.fwd_wide_launches = lr.bwd_wide_launches = 0


def phase_lstm_train(rows: dict) -> None:
    net = textgen_net("bfloat16", 0, DEVICE)
    H, V = LSTM_HIDDEN, LSTM_VOCAB
    want = 4 * H * (V + H + 1) + 4 * H * (2 * H + 1) + H * V + V
    check(net.numParams() == want,     # 887,117 at V=77, H=256
          f"{net.numParams()} parameters, not {want}")
    x, y = char_batch(LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ, 0, torch.bfloat16,
                      DEVICE)
    ln_v = math.log(LSTM_VOCAB)
    say("lstm-train", f"TextGenerationLSTM(vocab_size={LSTM_VOCAB}, hidden="
                      f"{LSTM_HIDDEN}): {net.numParams()} parameters, bf16, "
                      f"standard BPTT, Adam lr 1e-3; batch {LSTM_BATCH} x "
                      f"{LSTM_SEQ} one-hot characters")
    start = [dict(p) for p in net.params_list]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lstm_counts()
    losses = []
    for _ in range(WARMUP_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = lstm_counts()
    cluster = lstm_cluster_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    per_char = [float(l) / LSTM_SEQ for l in losses]
    check((fwd, bwd) == (2 * steps, 2 * steps) == cluster,
          f"LSTM launches fwd {fwd}, bwd {bwd} (cluster route {cluster}) "
          f"over {steps} steps of 2 layers")
    check(all(math.isfinite(v) for v in per_char), f"losses {per_char}")
    check(abs(per_char[0] - ln_v) <= 0.5,
          f"first loss per character {per_char[0]:.4f} is not within 0.5 of "
          f"ln {LSTM_VOCAB} = {ln_v:.4f}")
    # the bf16 loss sums 200 steps (~870), where bf16 resolves only 4
    # (0.02 per character): the fall is held on an f32 evaluation of the
    # first and the last parameters on the same batch
    evals = [eval_loss_f32(p, x, y) / LSTM_SEQ
             for p in (start, net.params_list)]
    say("lstm-train", f"f32 evaluation of the batch, per character: before "
                      f"{evals[0]:.6f}, after {steps} steps {evals[1]:.6f}")
    check(evals[1] < evals[0], f"loss did not fall: {evals}")
    step_s = wall / TIMED_STEPS
    tokens_s = LSTM_BATCH * LSTM_SEQ / step_s
    say("lstm-train", f"{TIMED_STEPS} timed steps: {step_s * 1e3:.2f} "
                      f"ms/step, {tokens_s:.1f} tokens/s; peak memory {peak} "
                      f"B ({peak / 2 ** 30:.2f} GiB); launches over {steps} "
                      f"steps: fwd {fwd}, bwd {bwd}, all on the cluster "
                      f"routes")
    say("lstm-train", "loss per character (the network's loss sums over "
                      "the 200 steps): " + " ".join(f"{v:.4f}"
                                                    for v in per_char))
    rows["B5"]["launches"] = fwd
    rows["B5 bwd"]["launches"] = bwd

    def run():
        for _ in range(PROFILED_STEPS):
            net.fit(x, y)

    busy_ms = device_profile("lstm-train", f"{PROFILED_STEPS} more steps", run,
                             ("lstm_fwd", "lstm_bwd"))
    if busy_ms:
        per_step = busy_ms / PROFILED_STEPS
        say("lstm-train", f"device busy {per_step:.2f} ms per profiled step "
                          f"against {step_s * 1e3:.2f} ms per timed step "
                          f"(unprofiled): idle about "
                          f"{1 - per_step / (step_s * 1e3):.3f} of a step")
    del net

    # the zoo's own truncated BPTT (50) at f32 on the same batch
    net = textgen_net("float32", 50, DEVICE)
    reset_lstm_counts()
    it0 = net.getIterationCount()
    net.fit(x.float(), y.float())
    torch.cuda.synchronize()
    counts = lstm_counts()
    check(counts == (8, 8), f"tBPTT 50 over 200 steps launched {counts}, "
                            f"not 4 segments x 2 layers (8, 8)")
    check(net.getIterationCount() - it0 == 4,
          f"tBPTT advanced {net.getIterationCount() - it0} iterations")
    say("lstm-train", f"tBPTT 50, f32: one fit = 4 segments, launches "
                      f"{counts}, iterations {it0} -> "
                      f"{net.getIterationCount()}, last segment loss per "
                      f"character {float(net._score) / 50:.4f}")
    del net
    lstm_wide_train(x, y, rows)


#: the JAX bench's wide char-LSTM (bench.py:654, lstm1024_tokens_per_sec_chip;
#: bench_common.py:279): hidden 1024 at batch 256 x 200, bf16
LSTM_WIDE_HIDDEN, LSTM_WIDE_STEPS = 1024, 3


def lstm_wide_train(x, y, rows: dict) -> None:
    """The wide route on the training path: TextGenerationLSTM at hidden
    1024 through ``MultiLayerNetwork.fit`` at phase 9's batch (bf16,
    standard BPTT): one warm-up and a few timed steps, two wide-route
    launches per direction per step (the rows' launches), finite losses;
    then B5 at that width (T=200, N=256, H=1024, bf16) against its plain
    version (forward within 2e-2, backward within 2e-2 of max |grad|)."""
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr

    H = LSTM_WIDE_HIDDEN
    net = textgen_net("bfloat16", 0, DEVICE, hidden=H)
    reset_lstm_counts()
    net.fit(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(LSTM_WIDE_STEPS):
        net.fit(x, y)
        losses.append(float(net._score) / LSTM_SEQ)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LSTM_WIDE_STEPS
    steps = 1 + LSTM_WIDE_STEPS
    counts, wide = lstm_counts(), lstm_wide_counts()
    check(counts == (2 * steps, 2 * steps) == wide,
          f"hidden {H}: launches {counts} (wide route {wide}) over {steps} "
          f"steps of 2 layers, all on the wide route")
    rows["B5 wide"]["launches"] = counts[0]
    rows["B5 bwd wide"]["launches"] = counts[1]
    check(all(math.isfinite(v) for v in losses), f"hidden {H}: losses "
                                                 f"{losses}")
    say("lstm-train", f"TextGenerationLSTM(hidden={H}) ({net.numParams()} "
                      f"parameters), bf16, batch {LSTM_BATCH} x {LSTM_SEQ}: "
                      f"{LSTM_WIDE_STEPS} timed steps {step_s * 1e3:.2f} "
                      f"ms/step, {LSTM_BATCH * LSTM_SEQ / step_s:.1f} "
                      f"tokens/s; launches {counts} on the wide route; loss "
                      f"per character " + " ".join(f"{v:.4f}"
                                                   for v in losses))
    say("lstm-train", f"yardstick at hidden {H} (phase 8, never called by "
                      f"the port): cuDNN's torch.nn.LSTM forward "
                      f"{rows['B5 wide']['library_ms']:.4f} ms and backward "
                      f"{rows['B5 bwd wide']['library_ms']:.4f} ms per layer "
                      f"against the wide route's kernel calls "
                      f"{rows['B5 wide']['ms']:.4f} and "
                      f"{rows['B5 bwd wide']['ms']:.4f} ms")
    busy_ms = device_profile("lstm-train", f"one more step at hidden {H}",
                             lambda: net.fit(x, y), ("lstm_fwd", "lstm_bwd"),
                             expect={"lstm_fwd": 2, "lstm_bwd": 2})
    if busy_ms:
        say("lstm-train", f"hidden {H}: device busy {busy_ms:.2f} ms against "
                          f"{step_s * 1e3:.2f} ms per timed step "
                          f"(unprofiled): idle about "
                          f"{1 - busy_ms / (step_s * 1e3):.3f} of a step")
    del net
    T, N = LSTM_SEQ, LSTM_BATCH
    ins = [t.to(torch.bfloat16) for t in lstm_case(T, N, H, seed=61)]
    g = torch.Generator(device=DEVICE).manual_seed(62)
    up = [torch.randn(shape, generator=g, device=DEVICE).to(torch.bfloat16)
          for shape in ((T, N, H), (N, H), (N, H))]
    ferr, berr, fplan, bplan = lstm_pair(lr, ins, up, torch.bfloat16)
    check(ferr <= 2e-2 and berr <= 2e-2,
          f"B5 at T={T} N={N} H={H} bf16: forward {ferr:.3e}, backward "
          f"{berr:.3e} of max |grad| > 0.02")
    say("lstm-train", f"B5 at T={T} N={N} H={H} bf16 (wide route): forward "
                      f"max abs err {ferr:.2e} against the plain version "
                      f"(plan {fplan}); backward err / max |grad| "
                      f"{berr:.2e} (plan {bplan}); times in phase 8")


def phase_lstm_parity() -> None:
    """The zoo model on the card (the kernels) against the CPU (the plain
    versions), then stateful sampling against the full forward."""
    lr_ = 1e-3
    out = {}
    for dev in (DEVICE, "cpu"):
        net = textgen_net("float32", 50, dev, seed=5)
        start = [{k: v.detach().cpu().clone() for k, v in p.items()}
                 for p in net.params_list]
        reset_lstm_counts()
        losses = []
        for b in range(3):
            x, y = char_batch(LSTM_VOCAB, 8, 100, 10 + b, torch.float32, dev)
            net.fit(x, y)
            losses.append(float(net._score))
        counts = lstm_counts()
        final = [{k: v.detach().cpu() for k, v in p.items()}
                 for p in net.params_list]
        moved = max(float((final[i][k] - start[i][k]).abs().max())
                    for i in range(len(final)) for k in final[i])
        out[dev] = (losses, final, moved, counts)
    (lc, pc, moved, kc), (lh, ph, _, hc) = out[DEVICE], out["cpu"]
    check(kc == (12, 12) and hc == (0, 0),
          f"launches card {kc} (want 3 x 2 segments x 2 layers), CPU {hc}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    err = max(float((pc[i][k] - ph[i][k]).abs().max())
              for i in range(len(pc)) for k in pc[i])
    say("lstm-parity", f"3 minibatches of 8 x 100, tBPTT 50, f32: card "
                       f"losses {' '.join(f'{x:.6f}' for x in lc)}, CPU "
                       f"{' '.join(f'{x:.6f}' for x in lh)} (max relative "
                       f"diff {rel:.2e}, tolerance 1e-5); parameters max abs "
                       f"diff {err:.2e} (tolerance {PARITY_PARAM_ATOL:g}); "
                       f"the card moved a parameter by up to {moved:.3e}")
    check(rel <= 1e-5, f"card and CPU losses differ by {rel:.3e}")
    check(err <= PARITY_PARAM_ATOL,
          f"card and CPU parameters differ by {err:.3e}")
    check(moved >= 0.5 * lr_, f"the card's updates moved no parameter by "
                              f"half a step of lr {lr_:g} ({moved:.3e})")

    net = textgen_net("float32", 50, DEVICE, seed=6)
    x, _ = char_batch(LSTM_VOCAB, 4, 64, 20, torch.float32, DEVICE)
    reset_lstm_counts()
    full = net.output(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = torch.stack([net.rnnTimeStep(x[:, t]) for t in range(64)], 1)
    torch.cuda.synchronize()
    per_char = (time.perf_counter() - t0) / 64 * 1e3
    counts = lstm_counts()
    err = float((steps - full).abs().max())
    # the same network on the CPU (the plain versions): both card paths
    # run the kernels at N=4, so only this twin can tell a fault there
    plain = textgen_net("float32", 50, "cpu", seed=6).output(x.cpu())
    err_plain = max(float((a.cpu() - plain).abs().max())
                    for a in (full, steps))
    say("lstm-parity", f"rnnTimeStep x 64 (batch 4) vs output(): max abs err "
                       f"{err:.3e}; both vs the CPU twin's output() "
                       f"{err_plain:.3e} (tolerance 1e-5); {per_char:.3f} "
                       f"ms per character (host clock, 2 layers + head); "
                       f"launches {counts}")
    check(counts == (2 * 65, 0),
          f"sampling launched {counts}, not 2 layers x 65 calls")
    check(err <= 1e-5, f"rnnTimeStep differs from output() by {err:.3e}")
    check(err_plain <= 1e-5, f"card sampling differs from the CPU's plain "
                             f"versions by {err_plain:.3e}")
    try:
        net.rnnTimeStep(x[:2, 0])
    except ValueError as e:
        say("lstm-parity", f"batch 4 -> 2 with stored state refused: {e}")
    else:
        raise RuntimeError("rnnTimeStep took a new batch size with stored "
                           "state")

    # sampling at bf16, the training dtype: every rnnTimeStep on the
    # forward's cluster route (T=1, N=4); the state goes back to the
    # network in bf16 between characters, so output() over the sequence
    # (h and c carried in f32 inside one launch) differs by the roundings
    net = textgen_net("bfloat16", 50, DEVICE, seed=6)
    xb = x.to(torch.bfloat16)
    full = net.output(xb)
    net.rnnTimeStep(xb[:, 0])                 # warm-up, then a fresh state
    net.rnnClearPreviousState()
    reset_lstm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = torch.stack([net.rnnTimeStep(xb[:, t]) for t in range(64)], 1)
    torch.cuda.synchronize()
    per_char_bf16 = (time.perf_counter() - t0) / 64 * 1e3
    counts, cluster = lstm_counts(), lstm_cluster_counts()
    err = float((steps.float() - full.float()).abs().max())
    say("lstm-parity", f"bf16 rnnTimeStep x 64 (batch 4): {per_char_bf16:.3f} "
                       f"ms per character (host clock, 2 layers + head; f32 "
                       f"above: {per_char:.3f}); launches {counts}, on the "
                       f"cluster route {cluster}; max abs diff from bf16 "
                       f"output() {err:.3e} (tolerance 2e-2)")
    check(counts == cluster == (2 * 64, 0),
          f"bf16 sampling launched {counts}, cluster route {cluster}, not "
          f"2 layers x 64 calls on the cluster route")
    check(err <= 2e-2, f"bf16 rnnTimeStep differs from output() by "
                       f"{err:.3e}")


# ------------------------------------------------- conv / tail kernels (B4, B3)
# (kind, N, H, W, Cin, Cout): every stride-1 conv class of ResNet-50's
# bottleneck stacks at batch 256 (bench_conv_pallas.py:23-37)
CONV_SHAPES = [
    ("1x1", 256, 56, 56, 64, 64),
    ("1x1", 256, 56, 56, 64, 256),
    ("1x1", 256, 56, 56, 256, 64),
    ("1x1", 256, 28, 28, 512, 128),
    ("1x1", 256, 28, 28, 128, 512),
    ("1x1", 256, 14, 14, 1024, 256),
    ("1x1", 256, 14, 14, 256, 1024),
    ("1x1", 256, 7, 7, 2048, 512),
    ("1x1", 256, 7, 7, 512, 2048),
    ("3x3", 256, 56, 56, 64, 64),
    ("3x3", 256, 28, 28, 128, 128),
    ("3x3", 256, 14, 14, 256, 256),
    ("3x3", 256, 7, 7, 512, 512),
]
#: (N, H, W, C): the four residual joins of batch-256 ResNet-50
#: (bench_residual_tail.py:31-36)
TAIL_SHAPES = [(256, 56, 56, 256), (256, 28, 28, 512), (256, 14, 14, 1024),
               (256, 7, 7, 2048)]
#: the shape of each kernel's row in the kernels line
CONV_ROW_SHAPES = {"1x1": ("1x1", 256, 56, 56, 64, 256),
                   "3x3": ("3x3", 256, 56, 56, 64, 64)}
TAIL_ROW_SHAPE = (256, 56, 56, 256)
#: ResNet-50's identity bottleneck stages (zoo/resnet50.py:46-56): (H = W,
#: block width C, bottleneck width)
RESNET_STAGES = [(56, 256, 64), (28, 512, 128), (14, 1024, 256),
                 (7, 2048, 512)]
RESNET_BATCH, RESNET_PARITY_BATCH = 256, 8


def conv_bound(x, w, y, taps: int):
    """(bound_ms, bound_by, bytes, flops) of one conv + BN-stats call: x
    and w read once, y and the two f32 [Cout] vectors written once; 2 flops
    per product of the implicit GEMM, at the tensor-core rate of the
    inputs' type."""
    rows, cin, cout = y.numel() // y.shape[-1], x.shape[-1], y.shape[-1]
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + y.numel() * y.element_size() + 2 * cout * 4)
    flops = 2 * rows * taps * cin * cout
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
    return (*bound(nbytes, flops, peak), nbytes, flops)


def tail_bound(x, res):
    """(bound_ms, bound_by, bytes, flops) of one residual-tail call: x and
    res read once, out (x's dtype) written once, four f32 [C] vectors read
    once; 6 f32 operations per element."""
    c = x.shape[-1]
    nbytes = (2 * x.numel() * x.element_size()
              + res.numel() * res.element_size() + 4 * c * 4)
    flops = 6 * x.numel()
    return (*bound(nbytes, flops, F32_FLOPS), nbytes, flops)


#: (x, res) dtypes of the tail checks: f32, bf16 and both mixes (C5)
TAIL_DTYPES = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16))


def tail_case(shape, mix):
    """(x, res, mean, var, gamma, beta) of one residual join: x and res
    in the dtypes of ``mix`` from the same seeded values whatever the
    dtypes, f32 statistics and parameters."""
    n, h, w_, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(c + h)
    x = torch.randn(n, h, w_, c, generator=g, device=DEVICE).to(mix[0])
    res = torch.randn(n, h, w_, c, generator=g, device=DEVICE).relu_() \
        .to(mix[1])
    mean = 0.1 * torch.randn(c, generator=g, device=DEVICE)
    var = torch.rand(c, generator=g, device=DEVICE) + 0.5
    gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
    beta = 0.1 * torch.randn(c, generator=g, device=DEVICE)
    return x, res, mean, var, gamma, beta


def tail_times(args, iters: int = 20) -> dict:
    """The residual-tail kernel's time through ``Nd4j.exec`` (two runs,
    in turns with the library yardstick), the plain version's, the
    library's (``F.batch_norm`` + add + ``relu`` on channels-last views,
    never called by the port; an eager composition where ``F.batch_norm``
    refuses the dtypes) and the bound. Needs only the op by name and its
    plain version, so it also times an earlier tree's kernel."""
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    x, res, mean, var, gamma, beta = args
    kern1 = cuda_ms(lambda i: Nd4j.exec("bn_relu_residual", *args), iters, 3)
    plain = cuda_ms(lambda i: rt.residual_tail_reference(*args), 5, 1)
    x_nchw, r_nchw = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
    kind = "F.batch_norm + add + relu"
    try:
        F.batch_norm(x_nchw, mean, var, gamma, beta, False, 0.0, 1e-5)

        def library(i):
            return torch.relu(F.batch_norm(x_nchw, mean, var, gamma, beta,
                                           False, 0.0, 1e-5) + r_nchw)
    except RuntimeError:
        kind = "eager composition"

        def library(i):
            return torch.relu((x - mean) * torch.rsqrt(var + 1e-5) * gamma
                              + beta + res)
    lib = cuda_ms(library, iters, 3)
    kern2 = cuda_ms(lambda i: Nd4j.exec("bn_relu_residual", *args), iters, 3)
    ms = min(kern1, kern2)
    bound_ms, bound_by, nbytes, _ = tail_bound(x, res)
    kinds = "/".join(str(t.dtype)[6:] for t in (x, res))
    device = device_split(
        "bn_relu_residual", lambda: Nd4j.exec("bn_relu_residual", *args),
        pattern=r"residual_tail\w*?_kernel", phase="tail",
        shape=f"{'x'.join(map(str, x.shape[1:]))} N={x.shape[0]} {kinds}")
    return {"kernel": (kern1, kern2), "plain": plain, "library": lib,
            "library_kind": kind, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "gbs": nbytes / (ms * 1e-3) / 1e9,
            "share": bound_ms / ms,
            "device_share": (bound_ms * 1e3 / device) if device else None}


def fmt_share(share) -> str:
    return "not measured" if share is None else f"{share:.3f}"


def say_tail_times(tag: str) -> None:
    """The residual tail's times (:func:`tail_times`) at the four joins in
    bf16 and f32, one line each: run from the root of an earlier tree of
    the port, with this file's functions loaded, it times that tree's
    kernel, so two designs can be compared in one chip call."""
    for shape in TAIL_SHAPES:
        for mix in TAIL_DTYPES[:2]:
            t = tail_times(tail_case(shape, mix))
            say("tail-times", f"{tag} {'x'.join(map(str, shape[1:]))} "
                              f"N={shape[0]} {str(mix[0])[6:]}: kernel "
                              f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} "
                              f"ms, library {t['library']:.4f} ms, bound "
                              f"{t['bound_ms']:.4f} ms, {t['share']:.3f} of "
                              f"the bound ({fmt_share(t['device_share'])} "
                              f"by device time)")


def conv_errors(y, m, v, ry, rm, rv) -> tuple:
    """(y err / max |y|, mean err / max |y|, var err / max E[y^2]) of a
    kernel result against its plain version at f32."""
    ymax = float(ry.abs().max())
    e2 = float((rv + rm * rm).max())
    return (float((y.float() - ry).abs().max()) / ymax,
            float((m - rm).abs().max()) / ymax,
            float((v - rv).abs().max()) / e2)


#: tolerances of the bf16 conv checks against the plain version's f32
#: product of the same bf16 values: y one bf16 rounding (2^-8 of max |y|);
#: the statistics come from f32 accumulators on both sides and differ only
#: in summation order over up to 802,816 rows
CONV_TOL = (2 ** -8, 1e-5, 1e-4)


def phase_conv_kernels() -> tuple:
    """Rows of B4a, B4b and B3: each shape through ``Nd4j.exec`` at bf16
    against the plain version at f32 on the same bf16 values, then each
    kernel's time beside its plain version's, a library yardstick the port
    never calls, and its bound."""
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    bf = torch.bfloat16
    rows = {}
    errs = {"1x1": 0.0, "3x3": 0.0}
    for shape in CONV_SHAPES:
        kind, n, h, w_, cin, cout = shape
        g = torch.Generator(device=DEVICE).manual_seed(cin * cout + h)
        x = torch.randn(n, h, w_, cin, generator=g, device=DEVICE).relu_() \
            .to(bf)
        taps = 1 if kind == "1x1" else 9
        wshape = (cin, cout) if taps == 1 else (3, 3, cin, cout)
        w = (torch.randn(wshape, generator=g, device=DEVICE)
             * math.sqrt(2.0 / (taps * cin))).to(bf)
        name = "conv1x1_bn_stats" if taps == 1 else "conv3x3_bn_stats"
        ref = (cb.conv1x1_bn_stats_reference if taps == 1
               else cb.conv3x3_bn_stats_reference)
        route = cb.kernel_route(x, w, taps)
        check(route == "tc", f"{name} at {shape[1:]} takes the {route!r} "
                             f"route, not the tensor-core route")
        y, m, v = Nd4j.exec(name, x, w)
        ry, rm, rv = ref(x.float(), w.float())
        torch.cuda.synchronize()
        check(y.dtype == bf and y.shape == ry.shape,
              f"{name} output {y.dtype} {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(v).all()),
              f"{name} output not finite")
        e = conv_errors(y, m, v, ry, rm, rv)
        errs[kind] = max(errs[kind], float((y.float() - ry).abs().max()))
        check(all(a <= t for a, t in zip(e, CONV_TOL)),
              f"{name} at {shape[1:]}: errors {e} above {CONV_TOL}")
        del ry, rm, rv
        iters = 20
        kern1 = cuda_ms(lambda i: Nd4j.exec(name, x, w), iters, 3)
        plain = cuda_ms(lambda i: ref(x, w), 5, 1)
        if taps == 1:
            x2 = x.reshape(-1, cin)

            def library(i):
                out = torch.matmul(x2, w)
                return torch.var_mean(out, dim=0, correction=0)
        else:
            x_nchw = x.permute(0, 3, 1, 2)          # a channels-last view
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library(i):
                out = F.conv2d(x_nchw, w_oihw, padding=1)
                return torch.var_mean(out, dim=(0, 2, 3), correction=0)
        lib = cuda_ms(library, iters, 3)
        # the first bf16 design, still the route of odd shapes
        first = cuda_ms(lambda i: cb.conv_bn_stats_kernel(x, w, taps,
                                                          route="wmma"),
                        iters, 3)
        kern2 = cuda_ms(lambda i: Nd4j.exec(name, x, w), iters, 3)
        ms = min(kern1, kern2)
        bound_ms, bound_by, nbytes, flops = conv_bound(x, w, y, taps)
        say("conv", f"{name} {h}x{w_} {cin}->{cout} N={n} bf16: err/max|y| "
                    f"{e[0]:.2e}, mean {e[1]:.2e}, var/max E[y^2] {e[2]:.2e}; "
                    f"kernel {kern1:.4f} / {kern2:.4f} ms, first bf16 design "
                    f"{first:.4f} ms, plain {plain:.4f} ms, library "
                    f"{lib:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
                    f"({nbytes} B, {flops} flop); kernel at "
                    f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
                    f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                    f"{bound_ms / ms:.3f} of its bound")
        if shape == CONV_ROW_SHAPES[kind]:
            again = Nd4j.exec(name, x, w)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(again, (y, m, v))),
                  f"{name} at {shape[1:]}: two calls differ")
            say("conv", f"{name} at {shape[1:]}: two calls give the same y, "
                        f"mean and var, bit for bit")
            device_split(f"{name} {h}x{w_} {cin}->{cout}",
                         lambda: Nd4j.exec(name, x, w),
                         pattern=r"conv_bn_stats(?:_tc)?_kernel"
                                 r"|reduce_stats_kernel",
                         phase="conv", shape=f"N={n}")
            del again
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "deeplearning4j_tpu_torch/csrc/conv_bn_stats.cu",
                "replaces": "deeplearning4j_tpu/ops/conv_pallas.py:"
                            + ("88" if taps == 1 else "167"),
                "launches": 0, "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib}
        del x, w, y, m, v
    rows["conv1x1_bn_stats"]["max_abs_err"] = errs["1x1"]
    rows["conv3x3_bn_stats"]["max_abs_err"] = errs["3x3"]
    say("conv", "library yardsticks (never called by the port): torch.matmul "
                "+ torch.var_mean (1x1), F.conv2d on a channels-last view + "
                "torch.var_mean (3x3), all bf16; plain versions at f32")

    tail_err = 0.0
    for shape in TAIL_SHAPES:
        n, h, w_, c = shape
        for mix in TAIL_DTYPES:
            args = tail_case(shape, mix)
            x = args[0]
            out = Nd4j.exec("bn_relu_residual", *args)
            # the plain version at f32 on the same values
            want = rt.residual_tail_reference(x.float(), args[1].float(),
                                              *args[2:])
            torch.cuda.synchronize()
            check(out.dtype == mix[0] and out.shape == x.shape,
                  f"bn_relu_residual output {out.dtype} {tuple(out.shape)}")
            again = Nd4j.exec("bn_relu_residual", *args)
            torch.cuda.synchronize()
            check(torch.equal(again, out), f"bn_relu_residual at {shape} "
                                           f"{mix}: two calls differ")
            err = float((out.float() - want).abs().max())
            scale = float(want.abs().max())
            # f32: the same operations in the same order (rsqrt rounded
            # apart); a bf16 output: the same f32 value rounded once
            tol = 1e-5 if mix[0] == torch.float32 else 2 ** -8 * scale
            check(err <= tol, f"bn_relu_residual at {shape} {mix}: "
                              f"{err:.3e} > {tol:.3e}")
            if mix == (bf, bf):
                tail_err = max(tail_err, err)
            del out, want, again
            t = tail_times(args)
            kinds = "/".join(str(d)[6:] for d in mix)
            say("tail", f"bn_relu_residual {h}x{w_}x{c} N={n} x/res {kinds}: "
                        f"max abs err {err:.3e} (max |out| {scale:.2f}, "
                        f"tolerance {tol:.2e}); two calls bit-equal; kernel "
                        f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms, "
                        f"plain {t['plain']:.4f} ms, library "
                        f"({t['library_kind']}) {t['library']:.4f} ms; bound "
                        f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
                        f"({t['bytes']} B); kernel at {t['gbs']:.1f} GB/s, "
                        f"{t['share']:.3f} of its bound ("
                        f"{fmt_share(t['device_share'])} by device time)")
            if shape == TAIL_ROW_SHAPE and mix == (bf, bf):
                rows["bn_relu_residual"] = {
                    "name": "bn_relu_residual", "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/csrc/residual_tail.cu",
                    "replaces": "deeplearning4j_tpu/ops/residual_tail_pallas.py"
                                ":63",
                    "launches": 0, "max_abs_err": 0.0, "ms": min(t["kernel"]),
                    "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": t["library"]}
            del args, x
    rows["bn_relu_residual"]["max_abs_err"] = tail_err
    check_conv_tail_f16(cb, rt)
    return tuple(rows.values())


def check_conv_tail_f16(cb, rt) -> None:
    """C9: f16 by name on the card, at ResNet-50's first stage (batch 8):
    the conv ops (f16 x with an f16 or an f32 w) on the f32 route over
    widened copies, y in x's dtype within one f16 rounding (2^-10 of max
    |y|) of the plain version at f32 on the same values and the
    statistics as at f32 (``CONV_TOL``); the tail with an f16 x or res
    within one rounding of x's dtype (2^-10 of max |out| at f16, 1e-5 at
    f32)."""
    from deeplearning4j_tpu_torch.ndarray import Nd4j

    f16 = torch.float16
    g = torch.Generator(device=DEVICE).manual_seed(16)
    x = torch.randn(8, 56, 56, 64, generator=g, device=DEVICE).relu_()
    for taps, cout in ((1, 256), (9, 64)):
        wshape = (64, cout) if taps == 1 else (3, 3, 64, cout)
        w = torch.randn(wshape, generator=g, device=DEVICE) * math.sqrt(
            2.0 / (taps * 64))
        name = "conv1x1_bn_stats" if taps == 1 else "conv3x3_bn_stats"
        ref = (cb.conv1x1_bn_stats_reference if taps == 1
               else cb.conv3x3_bn_stats_reference)
        for w_dtype in (f16, torch.float32):
            xh, wh = x.to(f16), w.to(w_dtype)
            check(cb.kernel_route(xh, wh, taps) == "f32",
                  f"{name} f16 not on the f32 route")
            y, m, v = Nd4j.exec(name, xh, wh)
            ry, rm, rv = ref(xh.float(), wh.float())
            torch.cuda.synchronize()
            check(y.dtype == f16, f"{name} f16 output {y.dtype}")
            e = conv_errors(y, m, v, ry, rm, rv)
            tol = (2 ** -10,) + CONV_TOL[1:]
            check(all(a <= t for a, t in zip(e, tol)),
                  f"{name} f16 x, {w_dtype} w: errors {e} above {tol}")
            say("conv", f"{name} 56x56 64->{cout} N=8, x f16, w "
                        f"{str(w_dtype)[6:]} (f32 route over widened "
                        f"copies): err/max|y| {e[0]:.2e}, mean {e[1]:.2e}, "
                        f"var/max E[y^2] {e[2]:.2e}")
    for mix in ((f16, f16), (f16, torch.float32), (torch.float32, f16)):
        args = tail_case((8, 56, 56, 256), mix)
        out = Nd4j.exec("bn_relu_residual", *args)
        want = rt.residual_tail_reference(args[0].float(), args[1].float(),
                                          *args[2:])
        torch.cuda.synchronize()
        err = float((out.float() - want).abs().max())
        tol = 1e-5 if mix[0] == torch.float32 else \
            2 ** -10 * float(want.abs().max())
        check(out.dtype == mix[0] and err <= tol,
              f"bn_relu_residual x/res {mix}: {out.dtype}, {err:.3e} > "
              f"{tol:.3e}")
        say("tail", f"bn_relu_residual 56x56x256 N=8 x/res "
                    f"{'/'.join(str(d)[6:] for d in mix)} (the f32 kernel "
                    f"over widened copies): max abs err {err:.2e} "
                    f"(tolerance {tol:.2e})")


# ------------------------------------------------------- batch-norm kernels
#: the distinct batch-norm shapes of ResNet-50 (H = W, C) at batch 256
BN_SHAPES = [(112, 64), (56, 64), (56, 256), (28, 128), (28, 512),
             (14, 256), (14, 1024), (7, 512), (7, 2048)]
BN_BATCH = 256
#: the shape of the three batch-norm rows in the kernels line
BN_ROW_SHAPE = (56, 256)
#: the kernels line's batch-norm rows: name, the reference formula each
#: replaces (no Pallas kernel stands behind them), f32 operations per
#: element
BN_ROWS = (("bn_stats_kernel", "deeplearning4j_tpu/ops/nn.py:390", 3),
           ("bn_apply_kernel", "deeplearning4j_tpu/ops/nn.py:426", 2),
           ("bn_backward_kernel", "deeplearning4j_tpu/ops/nn.py:460", 14))
#: tolerances against the plain versions on the card: the statistics
#: (f32 sums of up to 3.2 M terms in another order) of max(1, |value|);
#: dx one bf16 rounding of max |dx|; dgamma, dbeta of the largest sum of
#: |terms| they add
BN_STATS_TOL, BN_DX_TOL, BN_SUM_TOL = 1e-4, 2 ** -8, 1e-5
#: the future of the two-launch design's build (``tools/bn_two_launch.cu``),
#: started by phase_build
BN_YARDSTICK = None


def bn_bounds(x) -> tuple:
    """(bound_ms, bound_by, bytes) of each kernel on ``x`` [rows, C]: (a)
    reads x and writes the f32 mean and var; (b) reads x and the four f32
    vectors and writes y; (c) reads x, g and the four vectors and writes
    dx, dgamma and dbeta; their f32 operations per element (BN_ROWS) at
    67 TFLOP/s."""
    n, c = x.numel() * x.element_size(), x.shape[1] * 4
    out = []
    for nbytes, (_, _, ops) in zip((n + 2 * c, 2 * n + 4 * c,
                                    3 * n + 6 * c), BN_ROWS):
        out.append((*bound(nbytes, ops * x.numel(), F32_FLOPS), nbytes))
    return tuple(out)


def phase_bn_kernels() -> tuple:
    """Phase 11b: the batch-norm kernels (``csrc/batch_norm.cu``) at every
    distinct ResNet-50 shape at batch 256 in bf16, against their plain
    versions on the card: (a) within ``BN_STATS_TOL``, (b) bit for bit on
    the same statistics, with and without the ReLU, (c) within
    ``BN_DX_TOL`` / ``BN_SUM_TOL`` with and without the ReLU; two calls
    bit-equal; each kernel's time (CUDA events, in turns) beside its plain
    version's, the library's (never called by the port: ``torch.var_mean``
    for (a), ``F.batch_norm`` in inference mode for (b), the backward of
    ``F.batch_norm`` in training mode for (c), cuDNN's NHWC kernels on a
    channels-last view) and its byte bound; (a) and (c) also in turns
    with their two-launch design (``tools/bn_two_launch.cu``, never
    called by the port) and, at ``BN_ROW_SHAPE``, a profiled call of each
    (one device kernel); then the f16 kernels (C9) at one shape. Returns
    the three rows of the kernels line at ``BN_ROW_SHAPE``."""
    from deeplearning4j_tpu_torch.ops import batch_norm as bn
    from deeplearning4j_tpu_torch.tools import bn_probe

    bf = torch.bfloat16
    errs = [0.0, 0.0, 0.0]
    rows = {}
    old_stats, old_bwd = bn_probe.legacy_calls(
        BN_YARDSTICK.result()["two launches"])
    for hw, c in BN_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(hw * c)
        x4 = (torch.randn(BN_BATCH, hw, hw, c, generator=g, device=DEVICE)
              * 2 + 0.5).to(bf)
        x = x4.reshape(-1, c)
        dy = torch.randn(x.shape, generator=g, device=DEVICE).to(bf)
        gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
        beta = torch.randn(c, generator=g, device=DEVICE)
        m, v = bn.bn_stats_kernel(x)
        rm, rv = bn.bn_stats_reference(x, (0,))
        e_stats = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in ((m, rm), (v, rv)))
        check(e_stats <= BN_STATS_TOL, f"bn statistics {hw}x{hw}x{c}: "
                                       f"{e_stats:.3e} > {BN_STATS_TOL:g}")
        errs[0] = max(errs[0], max(float((m - rm).abs().max()),
                                   float((v - rv).abs().max())))
        del rm, rv
        line = [f"stats {e_stats:.2e}"]
        for relu in (False, True):
            y = bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, relu)
            check(torch.equal(y, bn.bn_apply_reference(
                x, m, v, gamma, beta, 1e-5, relu)),
                f"bn apply {hw}x{hw}x{c} relu={relu}: not bit-equal to the "
                f"plain version")
            dx, dg, db = bn.bn_backward_kernel(x, dy, m, v, gamma, beta,
                                               1e-5, relu)
            wx, wg, wb = bn.bn_backward_reference(x, dy, gamma, beta, m, v,
                                                  1e-5, relu, (0,))
            torch.cuda.synchronize()
            e_dx = float((dx.float() - wx.float()).abs().max()) / float(
                wx.float().abs().max())
            gsum = float(dy.float().abs().sum(0).max())
            e_db = float((db - wb).abs().max()) / gsum
            e_dg = float((dg - wg).abs().max()) / gsum / float(
                ((x.float() - m).abs().amax(0) * torch.rsqrt(v + 1e-5)).max())
            check(e_dx <= BN_DX_TOL and max(e_db, e_dg) <= BN_SUM_TOL,
                  f"bn backward {hw}x{hw}x{c} relu={relu}: dx {e_dx:.3e}, "
                  f"dbeta {e_db:.3e}, dgamma {e_dg:.3e}")
            errs[2] = max(errs[2], float((dx.float() - wx.float()).abs()
                                         .max()))
            line.append(f"relu={relu}: apply bit-equal, dx {e_dx:.2e}, "
                        f"dgamma {e_dg:.2e}, dbeta {e_db:.2e}")
            del y, dx, wx
        first = (*bn.bn_stats_kernel(x),
                 bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, True),
                 *bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, True))
        again = (*bn.bn_stats_kernel(x),
                 bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, True),
                 *bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, True))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"bn kernels at {hw}x{hw}x{c}: two calls differ")
        del first, again
        kernels = (lambda i: bn.bn_stats_kernel(x),
                   lambda i: bn.bn_apply_kernel(x, m, v, gamma, beta),
                   lambda i: bn.bn_backward_kernel(x, dy, m, v, gamma, beta))
        plains = (lambda i: bn.bn_stats_reference(x, (0,)),
                  lambda i: bn.bn_apply_reference(x, m, v, gamma, beta),
                  lambda i: bn.bn_backward_reference(x, dy, gamma, beta, m,
                                                     v))
        x_nchw = x4.permute(0, 3, 1, 2)        # a channels-last view
        lib_in = x_nchw.detach().clone(
            memory_format=torch.channels_last).requires_grad_(True)
        lib_g = gamma.clone().requires_grad_(True)
        lib_b = beta.clone().requires_grad_(True)
        lib_out = F.batch_norm(lib_in, None, None, lib_g, lib_b, True, 0.0,
                               1e-5)
        lib_dy = dy.reshape(x4.shape).permute(0, 3, 1, 2)
        libs = (lambda i: torch.var_mean(x, dim=0, correction=0),
                lambda i: F.batch_norm(x_nchw, m, v, gamma, beta, False,
                                       0.0, 1e-5),
                lambda i: torch.autograd.grad(lib_out, (lib_in, lib_g, lib_b),
                                              lib_dy, retain_graph=True))
        olds = (lambda i: old_stats(x),
                lambda i: old_bwd(x, dy, m, v, gamma, beta))
        kern1 = [cuda_ms(f, 10, 2) for f in kernels]
        old1 = [cuda_ms(f, 10, 2) for f in olds]
        plain = [cuda_ms(f, 3, 1) for f in plains]
        lib = [cuda_ms(f, 10, 2) for f in libs]
        old2 = [cuda_ms(f, 10, 2) for f in olds]
        kern2 = [cuda_ms(f, 10, 2) for f in kernels]
        del lib_in, lib_out
        bn.bn_stats_kernel(x)
        stats_plan = bn.last_launch()
        bn.bn_backward_kernel(x, dy, m, v, gamma, beta)
        bwd_plan = bn.last_launch()
        if (hw, c) == BN_ROW_SHAPE:
            check_bn_one_kernel(bn, x, dy, m, v, gamma, beta)
        bounds = bn_bounds(x)
        times = []
        for j, (name, replaces, _) in enumerate(BN_ROWS):
            ms = min(kern1[j], kern2[j])
            bound_ms, bound_by, nbytes = bounds[j]
            times.append(f"{name} {kern1[j]:.4f} / {kern2[j]:.4f} ms "
                         f"({bound_ms / ms:.3f} of its bound {bound_ms:.4f} "
                         f"ms by {bound_by}, {nbytes} B), plain "
                         f"{plain[j]:.4f}, library {lib[j]:.4f}")
            if (hw, c) == BN_ROW_SHAPE:
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/csrc/batch_norm.cu",
                    "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
                    "ms": ms, "plain_ms": plain[j], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib[j]}
        say("bn", f"{hw}x{hw}x{c} N={BN_BATCH} bf16 ({x.shape[0]} rows): "
                  f"{'; '.join(line)}; two calls bit-equal")
        say("bn", f"  {'; '.join(times)}")
        say("bn", "  in turns with the two-launch design "
                  "(tools/bn_two_launch.cu): " + "; ".join(
                      f"{name} one launch {kern1[j]:.4f} / {kern2[j]:.4f} ms, "
                      f"two launches {old1[i]:.4f} / {old2[i]:.4f} ms"
                      for i, (j, name) in enumerate(
                          ((0, "statistics"), (2, "backward"))))
                  + f"; plan (grid, ring stages, shared bytes, blocks per "
                    f"SM): statistics {stats_plan}, backward {bwd_plan}")
        del x4, x, dy, m, v
    for name, err in zip((r[0] for r in BN_ROWS), errs):
        rows[name]["max_abs_err"] = err
    say("bn", "library yardsticks (never called by the port): "
              "torch.var_mean (a), F.batch_norm in inference mode (b), the "
              "backward of F.batch_norm in training mode (c), on cuDNN's "
              "NHWC kernels; plain versions: the reference's formulas in "
              "eager PyTorch at f32")
    check_bn_f16(bn)
    return tuple(rows.values())


def check_bn_one_kernel(bn, x, dy, m, v, gamma, beta) -> None:
    """A profiled call of the statistics and of the backward each runs
    exactly one device kernel (memsets aside)."""
    from deeplearning4j_tpu_torch.tools import bn_probe

    for what, fn in (("statistics", lambda: bn.bn_stats_kernel(x)),
                     ("backward", lambda: bn.bn_backward_kernel(
                         x, dy, m, v, gamma, beta))):
        names = bn_probe.device_kernels(fn)
        if not names:
            say("bn", f"profiled {what} call: torch.profiler saw no device "
                      f"time (kernel count not measured)")
            continue
        check(len(names) == 1 and "bn_reduce_kernel" in names[0],
              f"a profiled {what} call ran {names}")
        say("bn", f"profiled {what} call: one device kernel, "
                  f"{names[0][:70]}")


def check_bn_f16(bn) -> None:
    """The f16 instances of the batch-norm kernels at 56x56x64, batch 8:
    (a) within ``BN_STATS_TOL``, (b) bit for bit, (c) dx within one f16
    rounding (2^-10) of max |dx|."""
    g = torch.Generator(device=DEVICE).manual_seed(16)
    x = (torch.randn(8 * 56 * 56, 64, generator=g, device=DEVICE) + 1).half()
    dy = torch.randn(x.shape, generator=g, device=DEVICE).half()
    gamma = torch.rand(64, generator=g, device=DEVICE) + 0.5
    beta = torch.randn(64, generator=g, device=DEVICE)
    m, v = bn.bn_stats_kernel(x)
    rm, rv = bn.bn_stats_reference(x, (0,))
    e = max(float((a - b).abs().max()) for a, b in ((m, rm), (v, rv)))
    check(e <= BN_STATS_TOL * max(1.0, float(rv.max()), float(rm.abs().max())),
          f"f16 bn statistics: {e:.3e}")
    for relu in (False, True):
        check(torch.equal(bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, relu),
                          bn.bn_apply_reference(x, m, v, gamma, beta, 1e-5,
                                                relu)),
              f"f16 bn apply relu={relu}: not bit-equal")
        dx = bn.bn_backward_kernel(x, dy, m, v, gamma, beta, 1e-5, relu)[0]
        wx = bn.bn_backward_reference(x, dy, gamma, beta, m, v, 1e-5,
                                      relu, (0,))[0]
        torch.cuda.synchronize()
        e_dx = float((dx.float() - wx.float()).abs().max()) / float(
            wx.float().abs().max())
        check(dx.dtype == torch.float16 and e_dx <= 2 ** -10,
              f"f16 bn backward relu={relu}: {e_dx:.3e}")
    say("bn", f"f16 at 56x56x64 N=8: statistics {e:.2e}, apply bit-equal, "
              f"dx within {e_dx:.2e} of max |dx| (relu on)")


# ------------------------------------------------------ ResNet-50 blocks by name
def resnet_block_weights(c: int, mid: int, seed: int) -> dict:
    """An identity bottleneck block's parameters from a numpy seed, in the
    JAX layout: He-normal 1x1 [C, mid], 3x3 HWIO [3, 3, mid, mid], 1x1
    [mid, C], f32; batch-norm gamma near 1 and beta near 0 per conv."""
    rng = np.random.default_rng(seed)
    p = {"w2a": rng.standard_normal((c, mid)) * math.sqrt(2.0 / c),
         "w2b": rng.standard_normal((3, 3, mid, mid))
         * math.sqrt(2.0 / (9 * mid)),
         "w2c": rng.standard_normal((mid, c)) * math.sqrt(2.0 / mid)}
    for tag, width in (("2a", mid), ("2b", mid), ("2c", c)):
        p[f"g{tag}"] = 1.0 + 0.1 * rng.standard_normal(width)
        p[f"b{tag}"] = 0.1 * rng.standard_normal(width)
    return {k: v.astype(np.float32) for k, v in p.items()}


def resnet_block(weights: dict, c: int, dtype: str, device):
    """A SameDiff graph of ResNet-50's identity bottleneck block: conv1x1
    + stats -> batch_norm -> relu -> cast, conv3x3 + stats -> batch_norm
    -> relu -> cast, conv1x1 + stats -> bn_relu_residual with the block
    input as the residual. Convolution weights in ``dtype``, batch-norm
    parameters f32 (bf16 y with f32 statistics promotes to f32; each cast
    brings the next conv's input back to ``dtype``)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    sd = SameDiff.create(device=device)
    x = sd.placeholder("x", shape=(None, None, None, c), dtype=dtype)
    v = {}
    for k, a in weights.items():
        t = torch.from_numpy(a)
        v[k] = sd.var(k, t.to(getattr(torch, dtype)) if k[0] == "w" else t)
    h = x
    for tag, op in (("2a", "conv1x1_bn_stats"), ("2b", "conv3x3_bn_stats")):
        y, m, var = sd.invoke_op(op, [h, v[f"w{tag}"]], n_out=3,
                                 name=f"conv{tag}")
        a = sd.nn.batch_norm(y, v[f"g{tag}"], v[f"b{tag}"], m, var,
                             name=f"bn{tag}")
        h = sd.math.cast(sd.nn.relu(a, name=f"relu{tag}"), dtype=dtype,
                         name=f"cast{tag}")
    y, m, var = sd.invoke_op("conv1x1_bn_stats", [h, v["w2c"]], n_out=3,
                             name="conv2c")
    out = sd.nn.bn_relu_residual(y, x, m, var, v["g2c"], v["b2c"], name="out")
    sd.setLossVariables(out)
    return sd


def conv_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    return cb.launches_1x1, cb.launches_3x3, rt.launches


def reset_conv_counts() -> None:
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    cb.launches_1x1 = cb.launches_3x3 = rt.launches = 0


def phase_resnet_blocks(rows: dict) -> None:
    """The four identity bottleneck blocks of ResNet-50 as SameDiff graphs
    at batch 256 in bf16, run by name; launches, a gradient through B3, a
    refused gradient through B4, and a save / load round trip."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    graphs, inputs = [], []
    for i, (hw, c, mid) in enumerate(RESNET_STAGES):
        graphs.append(resnet_block(resnet_block_weights(c, mid, seed=i), c,
                                   "bfloat16", DEVICE))
        g = torch.Generator(device=DEVICE).manual_seed(100 + i)
        inputs.append(torch.randn(RESNET_BATCH, hw, hw, c, generator=g,
                                  device=DEVICE).relu_().to(torch.bfloat16))
    for sd, x in zip(graphs, inputs):       # warm-up, untimed
        sd.output({"x": x}, ["out"])
    torch.cuda.synchronize()
    reset_conv_counts()
    outs = [sd.output({"x": x}, ["out"])["out"] for sd, x in
            zip(graphs, inputs)]
    torch.cuda.synchronize()
    counts = conv_counts()
    check(counts == (8, 4, 4), f"launches per output of the four block graphs "
                               f"(B4a, B4b, B3): {counts}, not (8, 4, 4)")
    rows["conv1x1_bn_stats"]["launches"] = counts[0]
    rows["conv3x3_bn_stats"]["launches"] = counts[1]
    rows["bn_relu_residual"]["launches"] = counts[2]
    for (hw, c, mid), x, out in zip(RESNET_STAGES, inputs, outs):
        check(out.dtype == torch.bfloat16 and out.shape == x.shape,
              f"block output {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()) and float(out.min()) >= 0.0,
              f"block {hw}x{hw}x{c} output not finite or negative")
    say("resnet", f"one output of each block graph launched B4a, B4b, B3 "
                  f"{counts} times (2, 1, 1 per block)")
    for (hw, c, mid), sd, x in zip(RESNET_STAGES, graphs, inputs):
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            sd.output({"x": x}, ["out"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        say("resnet", f"block {hw}x{hw} {c}->{mid}->{c} N={RESNET_BATCH} "
                      f"bf16: {ms:.3f} ms per output ({reps} timed, host "
                      f"clock, synchronised)")
    device_profile("resnet", "one output of each of the four blocks",
                   lambda: [sd.output({"x": x}, ["out"])
                            for sd, x in zip(graphs, inputs)],
                   ("conv_bn_stats", "reduce_stats", "residual_tail"),
                   {"conv_bn_stats": 12, "reduce_stats": 12,
                    "residual_tail": 4})

    # a gradient through B3: the first stage's 2c gamma and beta, against
    # autograd of the plain formula at f32 on the same tail inputs
    sd, x = graphs[0], inputs[0]
    grads = sd.calculateGradients({"x": x}, wrt=["g2c", "b2c"])
    tail_in = sd.output({"x": x}, [f"conv2c:{j}" for j in range(3)])
    y, m, var = (tail_in[f"conv2c:{j}"] for j in range(3))
    leaves = [sd.getVariable(n).getArr().detach().clone().requires_grad_(True)
              for n in ("g2c", "b2c")]
    with torch.enable_grad():
        plain = rt.residual_tail_reference(y.float(), x.float(), m, var,
                                           *leaves)
        want = torch.autograd.grad(plain.sum(), leaves)
    for n, w in zip(("g2c", "b2c"), want):
        got = grads[n]
        err = float((got.float() - w).abs().max())
        scale = float(w.abs().max())
        check(got.shape == w.shape and err <= 1e-4 * scale,
              f"d{n} through B3: {err:.3e} > 1e-4 x {scale:.3e}")
        say("resnet", f"calculateGradients d{n} ({RESNET_STAGES[0][0]}x"
                      f"{RESNET_STAGES[0][0]} block, through B3's "
                      f"autograd Function): max abs err {err:.3e} against the "
                      f"plain formula's f32 autograd (max |grad| {scale:.3e})")
    try:
        graphs[-1].calculateGradients({"x": inputs[-1]}, wrt=["w2a"])
    except RuntimeError as e:
        check("forward-only" in str(e), f"unexpected error: {e}")
        say("resnet", f"a gradient through B4 raises: {e}")
    else:
        raise RuntimeError("calculateGradients through conv1x1_bn_stats "
                           "returned instead of raising")

    # save and load the 7x7 block's graph (bf16 weights), same output; the
    # zip goes to the git-ignored build directory inside the checkout
    tmp = tempfile.mkdtemp(dir=os.path.join(PKG, "_build"))
    try:
        path = os.path.join(tmp, "block.zip")
        graphs[-1].save(path)
        loaded = SameDiff.load(path, device=DEVICE)
        again = loaded.output({"x": inputs[-1]}, ["out"])["out"]
        check(torch.equal(again, outs[-1]), "the loaded graph's output differs")
        say("resnet", f"save / load of the 7x7 block ({os.path.getsize(path)} "
                      f"B zip, bf16 weights): the same output, bit for bit")
    finally:
        shutil.rmtree(tmp)


#: card (kernels) vs CPU (plain versions), f32 blocks at batch 8: each
#: block's output after three convolutions and batch norms with batch
#: statistics, where the f32 sums differ in order between the two devices
BLOCK_PARITY_TOL = 1e-4


def phase_resnet_parity() -> None:
    """The four blocks at f32, batch 8, full width: the card's graphs (the
    kernels) against the same graphs on the CPU (the plain versions)."""
    for i, (hw, c, mid) in enumerate(RESNET_STAGES):
        weights = resnet_block_weights(c, mid, seed=i)
        rng = np.random.default_rng(200 + i)
        x = np.maximum(rng.standard_normal(
            (RESNET_PARITY_BATCH, hw, hw, c)), 0).astype(np.float32)
        outs = []
        for dev in (DEVICE, "cpu"):
            reset_conv_counts()
            sd = resnet_block(weights, c, "float32", dev)
            outs.append(sd.output({"x": x}, ["out"])["out"].cpu())
            check(conv_counts() == ((2, 1, 1) if dev == DEVICE
                                    else (0, 0, 0)),
                  f"{dev}: launches {conv_counts()}")
        err = float((outs[0] - outs[1]).abs().max())
        scale = float(outs[1].abs().max())
        check(err <= BLOCK_PARITY_TOL * max(1.0, scale),
              f"block {hw}x{hw}x{c} card vs CPU: {err:.3e} > "
              f"{BLOCK_PARITY_TOL:g} x max(1, {scale:.3e})")
        say("resnet-parity", f"block {hw}x{hw} {c}->{mid}->{c} N="
                             f"{RESNET_PARITY_BATCH} f32: card vs CPU max abs "
                             f"err {err:.3e} (max |out| {scale:.3f}, "
                             f"tolerance {BLOCK_PARITY_TOL:g} x max(1, max "
                             f"|out|))")


# ------------------------------------------------------- image models
LENET_BATCH, LENET_CLASSES = 64, 10
RESNET50_BATCH, RESNET50_HW, RESNET50_CLASSES = 256, 224, 1000
GRAPH_PARITY_BATCH = 8
PARITY_STEPS = 3
#: card (cuDNN, TF32 off) vs CPU at f32 after three steps: losses 1e-5
#: relative, BN running state and outputs 2e-5 of max(1, max |value|)
#: (conv sums in another order); parameters PARITY_PARAM_ATOL absolute
IMAGE_LOSS_RTOL, IMAGE_STATE_TOL = 1e-5, 2e-5


def numpy_tree(named_params, seed: int, scheme: str = "relu") -> dict:
    """Normal weights ``W`` from a numpy seed (``scheme`` "relu": He,
    sqrt(2 / fan_in); "xavier": sqrt(2 / (fan_in + fan_out)); fan_in the
    product of all but the last axis of HWIO or [in, out], fan_out the
    product of all but the next to last), ``gamma`` ones and every other
    leaf zero, at the shapes of ``named_params`` ((key, {name: tensor})
    pairs)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, p in named_params:
        out[key] = {}
        for k in sorted(p):
            shape = tuple(p[k].shape)
            if k == "W":
                fan_in = int(np.prod(shape[:-1]))
                fan_out = int(np.prod(shape[:-2])) * shape[-1]
                a = rng.standard_normal(shape) * math.sqrt(2.0 / (
                    fan_in if scheme == "relu" else fan_in + fan_out))
            else:
                a = np.full(shape, 1.0 if k == "gamma" else 0.0)
            out[key][k] = a.astype(np.float32)
    return out


def image_batch(n: int, hw: int, c: int, classes: int, seed: int):
    """bench.py's synthetic data: ``RandomState(seed)`` normal images
    [n, hw, hw, c] and one-hot labels."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, hw, hw, c)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]


def close_card_cpu(what: str, card, cpu, tol: float) -> float:
    """Max abs difference of two tensors, held to ``tol`` of max(1, max
    |cpu|)."""
    card, cpu = card.detach().float().cpu(), cpu.detach().float().cpu()
    check(card.shape == cpu.shape, f"{what}: {tuple(card.shape)} vs "
                                   f"{tuple(cpu.shape)}")
    err = float((card - cpu).abs().max()) if cpu.numel() else 0.0
    scale = max(1.0, float(cpu.abs().max())) if cpu.numel() else 1.0
    check(err <= tol * scale, f"{what}: card vs CPU {err:.3e} > {tol:g} x "
                              f"{scale:.3e}")
    return err


def check_losses(phase: str, card, cpu) -> None:
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    check(all(math.isfinite(v) for v in card + cpu),
          f"{phase}: losses {card} {cpu}")
    check(rel <= IMAGE_LOSS_RTOL, f"{phase}: card and CPU losses differ by "
                                  f"{rel:.3e} relative")
    say(phase, f"losses card {' '.join(f'{v:.7f}' for v in card)}, CPU "
               f"{' '.join(f'{v:.7f}' for v in cpu)} (max relative diff "
               f"{rel:.2e}, tolerance {IMAGE_LOSS_RTOL:g})")


def phase_lenet() -> None:
    """LeNet through MultiLayerNetwork, three Nesterovs steps on the card
    (cuDNN at f32, TF32 off) and on the CPU from one numpy tree. Nesterovs
    moves a parameter by lr times its gradient, so the gradients' rounding
    differences reach the parameters unamplified (Adam divides each
    gradient by its own size: where one cancels to near its epsilon, a
    rounding difference moves the update by up to lr)."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.zoo import LeNet

    t0 = time.perf_counter()
    lr = 1e-2
    zoo = LeNet(num_classes=LENET_CLASSES, updater=Nesterovs(lr, 0.9))
    x, y = image_batch(LENET_BATCH, 28, 1, LENET_CLASSES, seed=0)
    tree, runs = None, []
    for dev in (DEVICE, "cpu"):
        net = zoo.init(device=dev)
        if tree is None:
            tree = numpy_tree(enumerate(net.params_list), seed=13,
                              scheme="xavier")
        net.params_list = mln_params_from_numpy(
            [tree[i] for i in range(len(tree))], device=dev)
        start = net.params().cpu()
        losses = []
        for _ in range(PARITY_STEPS):
            net.fit(x, y)
            losses.append(net.score())
        runs.append((losses, net, float((net.params().cpu() - start)
                                        .abs().max())))
    (lc, card, moved), (lh, cpu, _) = runs
    check_losses("lenet", lc, lh)
    err, where = max((float((p[k].cpu() - q[k]).abs().max()), f"{i}/{k}")
                     for i, (p, q) in enumerate(zip(card.params_list,
                                                    cpu.params_list))
                     for k in q)
    check(err <= PARITY_PARAM_ATOL,
          f"lenet: parameters differ by {err:.3e} (layer {where})")
    check(moved >= 100 * PARITY_PARAM_ATOL,
          f"lenet: the card's updates moved no parameter by 100 x the "
          f"tolerance ({moved:.3e})")
    out = close_card_cpu("lenet output", card.output(x), cpu.output(x),
                         IMAGE_STATE_TOL)
    say("lenet", f"LeNet ({card.numParams()} parameters, conv 5x5 x20, pool, "
                 f"conv 5x5 x50, pool, dense 500, softmax {LENET_CLASSES}) at "
                 f"batch {LENET_BATCH} x 28x28x1, f32, Nesterovs({lr:g}, "
                 f"0.9): {PARITY_STEPS} steps, parameters max abs diff "
                 f"{err:.2e} at layer {where} (tolerance "
                 f"{PARITY_PARAM_ATOL:g}; the card moved one by up to "
                 f"{moved:.3e}), inference output {out:.2e}; "
                 f"{time.perf_counter() - t0:.1f} s")


def graph_macs(conf) -> int:
    """Multiply-adds per example of a graph's convolutions and dense
    layers, from the shapes its configuration gives them."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ConvolutionLayer, DenseLayer, SeparableConvolution2D)
    from deeplearning4j_tpu_torch.nn.conf.layers_extra import (
        DepthwiseConvolution2D)

    types = dict(zip(conf.network_inputs, conf.input_types))
    macs = 0
    for node in conf.nodes:
        out = node.vertex.output_type([types[s] for s in node.inputs])
        layer = getattr(node.vertex, "layer", None)
        if isinstance(layer, (SeparableConvolution2D,
                              DepthwiseConvolution2D)):
            kh, kw = layer.kernel_size
            mid = layer.n_in * layer.depth_multiplier
            macs += out.height * out.width * mid * kh * kw
            if isinstance(layer, SeparableConvolution2D):
                macs += out.height * out.width * mid * out.channels
        elif isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            macs += out.height * out.width * out.channels * kh * kw \
                * layer.n_in
        elif isinstance(layer, DenseLayer):
            macs += layer.n_in * layer.n_out
        types[node.name] = out
    return macs


def kernel_group(chain) -> str:
    """The group of a kernel (conv, batch norm, ReLU/add, updater or
    other) from the names of the CPU op that launched it and of its
    parents, innermost first: in the forward and the update, the record
    range that ``ComputationGraph`` puts around each vertex
    (``dl4j::<layer or vertex class>``) and around the update
    (``dl4j::updater``); in the backward, the autograd function (the
    batch-norm kernels' ``BatchNormKernelsBackward``)."""
    text = " | ".join(chain)
    if "BatchNormKernels" in text:
        return BN_GROUP
    if any(k in text for k in ("relu", "clamp_min", "threshold_backward",
                               "ReluBackward", "dl4j::ActivationLayer",
                               "dl4j::ElementWiseVertex")):
        return "ReLU/add"
    if "dl4j::updater" in text:
        return "updater"
    if "dl4j::ConvolutionLayer" in text or "onvolution" in text \
            or "aten::mm" in text or "aten::addmm" in text \
            or "MmBackward" in text:
        return "conv"
    # the batch norm's own forward, and in the backward its kernels'
    # function or the functions of an eager formula (the l2 term's and the
    # global pool's share them, small)
    if "dl4j::BatchNormalization" in text or any(k in text for k in (
            "MulBackward", "SubBackward", "MeanBackward", "ToCopyBackward",
            "MaximumBackward", "RsqrtBackward", "AddBackward",
            "SelectBackward")):
        return BN_GROUP
    return "other"


#: the batch norm's group in the device profile
BN_GROUP = "batch norm"


def library_batch_norm_train(x, gamma, beta, eps=1e-5, axes=None):
    """``F.batch_norm`` in training mode on an NHWC ``x`` (cuDNN's fused
    kernels, two-pass statistics and an unbiased running variance: not
    the reference's formula). A yardstick the port never calls."""
    c = x.shape[-1]
    mean = torch.zeros(c, device=x.device)
    var = torch.ones(c, device=x.device)
    y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, gamma.float(),
                     beta.float(), True, 1.0, eps)
    return y.permute(0, 2, 3, 1), mean.to(x.dtype), var.to(x.dtype)


def library_bn_step(phase: str, net, x, y, step_ms: float, smi: str,
                    steps: int = 5) -> None:
    """The same training step with every batch norm through
    :func:`library_batch_norm_train`, timed after one warm-up step: how
    much of the step the eager batch-norm formula costs."""
    from deeplearning4j_tpu_torch.ops import nn as nnops

    plain = nnops.batch_norm_train
    nnops.batch_norm_train = library_batch_norm_train
    try:
        net.fit(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    finally:
        nnops.batch_norm_train = plain
    check(math.isfinite(net.score()), "the yardstick's loss is not finite")
    say(phase, f"yardstick: the step with F.batch_norm (cuDNN) in place of "
               f"the reference's batch-norm formula, {steps} timed: "
               f"{ms:.2f} ms/step ({ms / step_ms:.3f} of the port's "
               f"{step_ms:.2f}); {smi}")


def bn_counts() -> tuple:
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    return bn.stats_launches, bn.apply_launches, bn.bwd_launches


def reset_bn_counts() -> None:
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    bn.stats_launches = bn.apply_launches = bn.bwd_launches = 0


def set_fused(on: bool) -> None:
    from deeplearning4j_tpu_torch.ops import nn as nnops

    nnops.FUSED_BN_RELU_BWD = on


def phase_resnet50_train(smi: str, rows: dict) -> float:
    """ResNet-50 through ComputationGraph at full width: bench.py's cell
    (batch 256, 224x224x3, bf16, Nesterovs(0.1, 0.9), RandomState(0)
    data), twice: with ``FUSED_BN_RELU_BWD`` off (the reference's
    default: batch norm, then the ReLU) and on (``batch_norm_relu_train``
    in every BN layer with a ReLU); cuDNN autotuning
    (``cudnn.benchmark``) on for this phase only. Returns the ms per step
    with the toggle off."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50

    t_phase = time.perf_counter()
    B, HW = RESNET50_BATCH, RESNET50_HW
    conf = ResNet50(num_classes=RESNET50_CLASSES, in_shape=(HW, HW, 3),
                    updater=Nesterovs(learning_rate=1e-1,
                                      momentum=0.9)).conf()
    conf.dtype = "bfloat16"
    net = ComputationGraph(conf, device=DEVICE).init()
    n_params = net.numParams()
    n_bn = sum(isinstance(getattr(n.vertex, "layer", None),
                          BatchNormalization) for n in conf.nodes)
    if (HW, RESNET50_CLASSES) == (224, 1000):
        check(25_000_000 < n_params < 26_500_000,
              f"ResNet-50 has {n_params} parameters")
        check(n_bn == 53, f"ResNet-50 has {n_bn} batch-norm layers")
    x, y = image_batch(B, HW, 3, RESNET50_CLASSES, seed=0)
    x = torch.from_numpy(x).to(DEVICE, torch.bfloat16)
    y = torch.from_numpy(y).to(DEVICE)
    macs = graph_macs(conf)
    flops = 6 * macs * B        # 2 x MACs, x3 for the backward
    say("resnet50", f"ResNet50(num_classes={RESNET50_CLASSES}): {n_params} "
                    f"parameters, {len(conf.nodes)} nodes ({n_bn} batch "
                    f"norms), bf16, Nesterovs(0.1, 0.9), batch {B} x "
                    f"{HW}x{HW}x3; {macs / 1e9:.3f} GMAC per image forward, "
                    f"{flops / 1e12:.3f} TFLOP per training step")
    torch.backends.cudnn.benchmark = True
    try:
        step_ms = {}
        for fused in (False, True):
            set_fused(fused)
            step_ms[fused], launches = resnet50_run(net, x, y, fused, flops,
                                                    n_bn, smi)
            if not fused:
                for name, k in zip((r[0] for r in BN_ROWS), launches):
                    rows[name]["launches"] = k
        set_fused(False)
        say("resnet50", f"step with the fused ReLU {step_ms[True]:.2f} ms "
                        f"against {step_ms[False]:.2f} ms without "
                        f"({step_ms[True] / step_ms[False]:.3f}); {smi}")
        library_bn_step("resnet50", net, x, y, step_ms[False], smi)
    finally:
        set_fused(False)
        torch.backends.cudnn.benchmark = False
    # phase 23 (d) steps this network again: its kernels are the ones
    # counted here (cuDNN keys its algorithm choices by the tensors too)
    PHASE15_KERNELS["model"] = (net, x, y)
    del net, x, y
    torch.cuda.empty_cache()
    say("resnet50", f"phase {time.perf_counter() - t_phase:.1f} s")
    return step_ms[False]


#: phase 15's network, batch and labels ("model"), and of one step with
#: the toggle off the kernels by name ("kernels") and the operations by
#: name ("ops"), both the profiler's counts: phase 23 (d) steps that
#: network and holds an unmonitored step to them
PHASE15_KERNELS: dict = {}


def profiled_ops(run) -> dict:
    """``{aten operation: calls}`` of ``run()`` (the backward's too), from
    the profiler's host-side events. Unlike its device records, which a
    long process loses some of (``device_profile``), these are complete:
    every kernel a step launches comes from one of them, or from a hand
    kernel's wrapper, which counts its own launches."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    return dict(Counter(e.name for e in prof.events()
                        if e.device_type == DeviceType.CPU
                        and e.name.startswith("aten::")))


def resnet50_run(net, x, y, fused: bool, flops: int, n_bn: int,
                 smi: str) -> tuple:
    """Warm-up and timed steps of phase 15 with the toggle as set: a
    finite loss at every step, one launch of each batch-norm kernel per
    BN layer per step, ms per step, images/s, peak memory, FLOP share,
    then one profiled step whose largest batch-norm operations must be the
    kernels (the eager formula gone). Returns (ms per step, the kernels'
    launches over the warm-up and timed steps)."""
    tag = ("fused ReLU on" if fused
           else "fused ReLU off, the reference's default")
    B = x.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_bn_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = bn_counts()
    steps = WARMUP_STEPS + TIMED_STEPS
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals), f"losses {vals}")
    check({t.dtype for p in net.params_map.values()
           for t in p.values()} == {torch.bfloat16}, "a parameter left bf16")
    check(launches == (n_bn * steps,) * 3,
          f"batch-norm kernel launches {launches} over {steps} steps, not "
          f"one of each per BN layer per step ({n_bn * steps})")
    step_s = wall / TIMED_STEPS
    say("resnet50", f"[{tag}] {WARMUP_STEPS} warm-up steps in {warm_s:.2f} "
                    f"s (cuDNN autotuning included); losses "
                    + " ".join(f"{v:.4f}" for v in vals))
    say("resnet50", f"[{tag}] {TIMED_STEPS} timed steps: "
                    f"{step_s * 1e3:.2f} ms/step, {B / step_s:.1f} images/s; "
                    f"{smi}")
    say("resnet50", f"[{tag}] batch-norm kernel launches over {steps} steps "
                    f"(statistics, apply, backward): {launches}, "
                    f"{n_bn} BN layers x {steps}")
    say("resnet50", f"[{tag}] peak memory {peak} B ({peak / 2 ** 30:.2f} "
                    f"GiB, torch.cuda.max_memory_allocated); {smi}")
    say("resnet50", f"[{tag}] {flops / step_s / 1e12:.1f} TFLOP/s counted, "
                    f"{flops / step_s / BF16_FLOPS:.4f} of the bf16 "
                    f"tensor-core peak {BF16_FLOPS / 1e12:.0f} TFLOP/s; {smi}")

    def one_step():
        net.fit(x, y)

    out = {}
    # the layout transposes cuDNN would add around an NCHW kernel
    device_profile("resnet50", f"[{tag}] one profiled training step "
                               f"(unprofiled {step_s * 1e3:.2f} ms; {smi})",
                   one_step, ("nchwToNhwc", "nhwcToNchw", "bn_",
                              "bn_reduce_kernel", "bn_apply_kernel"),
                   group=kernel_group, top=10, out=out)
    if not fused:
        # one step's kernels and its operations by name, phase 23 (d)'s
        # yardstick
        PHASE15_KERNELS["kernels"] = {r[0]: r[3] for r in out.get("all", ())}
        PHASE15_KERNELS["ops"] = profiled_ops(one_step)
    eager = [n for n, _, g in out.get("largest", ())
             if g == BN_GROUP and "bn_" not in n]
    check(not eager, f"[{tag}] batch-norm work outside the kernels among "
                     f"the largest device operations: {eager}")
    # the check's margin: the group's largest operation that is not a
    # kernel against the smallest of the largest
    rest = [r for r in out.get("all", ())
            if r[2] == BN_GROUP and "bn_" not in r[0]]
    if out.get("largest"):
        say("resnet50", f"[{tag}] batch-norm work outside the kernels: "
                        + (f"largest {rest[0][1] / 1e3:.3f} ms x{rest[0][3]} "
                           f"({rest[0][0][:80]})" if rest else "none")
                        + f"; the {len(out['largest'])}th largest device "
                          f"operation {out['largest'][-1][1] / 1e3:.3f} ms")
    return step_s * 1e3, launches


def phase_graph_parity() -> None:
    """The cut ResNet (``zoo.resnet50.cut_resnet_conf``) at f32: three
    Nesterovs steps on the card (cuDNN, TF32 off; the batch-norm kernels)
    and on the CPU from one numpy tree, then one ``output`` in inference
    mode; with ``FUSED_BN_RELU_BWD`` off and on."""
    try:
        for fused in (False, True):
            set_fused(fused)
            graph_parity(fused)
    finally:
        set_fused(False)


def graph_parity(fused: bool) -> None:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.params import cg_params_from_numpy
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    t0 = time.perf_counter()
    conf = cut_resnet_conf()
    tree = numpy_tree(ComputationGraph(conf, device="cpu").init()
                      .params_map.items(), seed=21)
    x, y = image_batch(GRAPH_PARITY_BATCH, 32, 3, 4, seed=1)
    runs = []
    for dev in (DEVICE, "cpu"):
        g = ComputationGraph(conf, device=dev).init()
        g.params_map = cg_params_from_numpy(conf.nodes, tree, device=dev)
        start = g.params().cpu()
        losses = []
        reset_bn_counts()
        for _ in range(PARITY_STEPS):
            g.fit(x, y)
            losses.append(g.score())
        launched = bn_counts()
        runs.append((losses, g, float((g.params().cpu() - start)
                                      .abs().max()), launched))
    (lc, card, moved, launched), (lh, cpu, _, none) = runs
    check(min(launched) > 0 and none == (0, 0, 0),
          f"graph-parity: batch-norm kernel launches card {launched}, CPU "
          f"{none}")
    tag = "fused ReLU " + ("on" if fused else "off")
    check_losses(f"graph-parity [{tag}]", lc, lh)
    err = float((card.params().cpu() - cpu.params()).abs().max())
    check(err <= PARITY_PARAM_ATOL,
          f"graph-parity [{tag}]: parameters differ by {err:.3e}")
    check(moved >= 100 * PARITY_PARAM_ATOL,
          f"graph-parity [{tag}]: the card's updates moved no parameter by "
          f"100 x the tolerance ({moved:.3e})")
    state = max(close_card_cpu(f"BN state {n}/{k}", card.states_map[n][k],
                               cpu.states_map[n][k], IMAGE_STATE_TOL)
                for n in cpu.states_map for k in cpu.states_map[n])
    out = close_card_cpu("inference output", card.outputSingle(x),
                         cpu.outputSingle(x), IMAGE_STATE_TOL)
    say("graph-parity", f"[{tag}] cut ResNet ({cpu.numParams()} parameters; "
                        f"stem, a projection and an identity block, 32x32x3, "
                        f"4 classes) at batch {GRAPH_PARITY_BATCH}, f32, "
                        f"Nesterovs(0.05, 0.9), l2 1e-4: parameters max abs "
                        f"diff {err:.2e} (tolerance {PARITY_PARAM_ATOL:g}; the "
                        f"card moved one by up to {moved:.3e}), BN running "
                        f"state {state:.2e} and inference output {out:.2e} "
                        f"(tolerance {IMAGE_STATE_TOL:g} of max(1, |value|)); "
                        f"batch-norm kernel launches {launched}; "
                        f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------ the training loop
#: phase 17: batches through the iterator; LeNet's epochs and ResNet-50's
#: warm-up and timed steps
LOOP_BATCHES, LOOP_HELD_OUT, LOOP_WARMUP, LOOP_EPOCHS = 8, 2, 2, 2
LOOP_ROUNDS = 3
LOOP_LSTM_STEPS = 3
#: the char-LSTM's losses through the iterator against fit(x, y)'s
LOOP_LOSS_RTOL = 1e-5
#: the early-stopping best model's recomputed score against the recorded
LOOP_SCORE_RTOL = 1e-6
PREFETCH_THREADS = ("DevicePrefetch-transfer", "AsyncDataSet-ETL")


def prefetch_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate()
            if t.name in PREFETCH_THREADS and t.is_alive()]


def phase_training_loop(smi: str, resident_ms) -> None:
    """Phase 17: the loop users run, through the port's entry points on
    the card: (a) LeNet, (b) ResNet-50 fed from host uint8 images through
    the device prefetcher, (c) the char-LSTM through an iterator."""
    t0 = time.perf_counter()
    loop_lenet()
    loop_resnet50(smi, resident_ms)
    loop_char_lstm()
    check(not prefetch_threads(), f"threads left: {prefetch_threads()}")
    say("train-loop", f"phase {time.perf_counter() - t0:.1f} s")


def loop_lenet() -> None:
    """(a) LeNet at f32 (TF32 off, cuDNN deterministic): ``fit`` over a
    depth-2 prefetcher for 2 epochs against ``fit(x_i, y_i)`` on the same
    batches, bit for bit; ``evaluate`` on the card against an
    ``Evaluation`` of the same outputs on the CPU; early stopping; and a
    ``writeModel`` / restore round trip, bit for bit."""
    from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                                   DevicePrefetchIterator)
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition, TerminationReason)
    from deeplearning4j_tpu_torch.evaluation import Evaluation
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)
    from deeplearning4j_tpu_torch.zoo import LeNet

    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        zoo = LeNet(num_classes=LENET_CLASSES, updater=Nesterovs(1e-2, 0.9))
        tree = None

        def net():
            nonlocal tree
            n = zoo.init(device=DEVICE)
            if tree is None:
                tree = numpy_tree(enumerate(n.params_list), seed=13,
                                  scheme="xavier")
            n.params_list = mln_params_from_numpy(
                [tree[i] for i in range(len(tree))], device=DEVICE)
            return n

        B = LENET_BATCH
        x, y = image_batch(B * LOOP_BATCHES, 28, 1, LENET_CLASSES, seed=3)
        xe, ye = image_batch(B * LOOP_HELD_OUT, 28, 1, LENET_CLASSES,
                             seed=4)
        a, b = net(), net()
        it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, B,
                                                         shuffle=True),
                                    depth=2)
        try:
            a.fit(it, epochs=LOOP_EPOCHS)
        finally:
            it.shutdown()
        ref = ArrayDataSetIterator(x, y, B, shuffle=True)
        for _ in range(LOOP_EPOCHS):
            for ds in ref:
                b.fit(ds.features, ds.labels)
        steps = LOOP_BATCHES * LOOP_EPOCHS
        check(a.getIterationCount() == b.getIterationCount() == steps,
              f"lenet: iterations {a.getIterationCount()}, "
              f"{b.getIterationCount()}")
        pa, pb = a.params(), b.params()
        check(torch.equal(pa, pb),
              f"lenet: fit(prefetcher) and fit(x, y) differ in "
              f"{int((pa != pb).sum())} parameters, by up to "
              f"{float((pa - pb).abs().max()):.3e}")
        ev = a.evaluate(ArrayDataSetIterator(xe, ye, B))
        check(ev._counts.device.type == "cuda",
              "evaluate's counts left the card")
        host = Evaluation()
        for ds in ArrayDataSetIterator(xe, ye, B):
            host.eval(ds.labels, a.output(ds.features).cpu())
        check((ev.confusionMatrix() == host.confusionMatrix()).all(),
              "lenet: evaluate on the card differs from the CPU's "
              "Evaluation of the same outputs")
        calc = DataSetLossCalculator(ArrayDataSetIterator(xe, ye, B))
        cfg = EarlyStoppingConfiguration(
            calc, [MaxEpochsTerminationCondition(3)],
            model_saver=InMemoryModelSaver())
        res = EarlyStoppingTrainer(cfg, net(), ArrayDataSetIterator(
            x, y, B, shuffle=True)).fit()
        check(res.termination_reason == TerminationReason.EPOCH_TERMINATION
              and res.total_epochs == 3,
              f"early stopping: {res.termination_reason} "
              f"{res.termination_details} after {res.total_epochs} epochs")
        again = calc.calculate_score(res.best_model)
        rel = abs(again - res.best_model_score) / abs(res.best_model_score)
        check(rel <= LOOP_SCORE_RTOL,
              f"early stopping: the best model scores {again} against the "
              f"recorded {res.best_model_score}")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "lenet.zip")
            ModelSerializer.writeModel(a, path, save_updater=True)
            back = ModelSerializer.restore(path, load_updater=True,
                                           device=DEVICE)
            check(torch.equal(back.output(xe), a.output(xe)),
                  "lenet: the restored model's output differs")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    say("train-loop", f"(a) LeNet, f32, batch {B}: fit(DevicePrefetchIterator"
                      f"(ArrayDataSetIterator(shuffle=True), depth=2), "
                      f"epochs={LOOP_EPOCHS}) bit-equal to fit(x_i, y_i) "
                      f"over {steps} steps; evaluate on the card = the CPU's "
                      f"(accuracy {ev.accuracy():.4f}); early stopping "
                      f"best epoch {res.best_model_epoch} of "
                      f"{res.total_epochs}, score {res.best_model_score:.6f} "
                      f"(recomputed, {rel:.1e} relative); writeModel and "
                      f"restore bit-equal; {time.perf_counter() - t0:.1f} s")


class StepClock:
    """A listener: each step's loss tensor and ETL wait, and the host
    clock after a ``torch.cuda.synchronize()`` at the end of step
    ``warmup`` and of the last step."""

    def __init__(self, warmup: int, steps: int):
        self.warmup, self.steps = warmup, steps
        self.losses, self.etl_ms, self.clock = [], [], {}

    def iterationDone(self, model, iteration, epoch):
        self.losses.append(model._score)
        self.etl_ms.append(model._last_etl_ms)
        k = len(self.losses)
        if k in (self.warmup, self.steps):
            torch.cuda.synchronize()
            self.clock[k] = time.perf_counter()

    def step_ms(self) -> float:
        return ((self.clock[self.steps] - self.clock[self.warmup])
                / (self.steps - self.warmup) * 1e3)


def loop_resnet50(smi: str, resident_ms) -> None:
    """(b) ResNet-50 at phase 15's cell from host-resident uint8 images:
    ``fit`` over ``DevicePrefetchIterator(ArrayDataSetIterator(...),
    dtype=bfloat16)`` at depth 2 and depth 0, in turns with the same steps
    on a batch already on the card, LOOP_ROUNDS rounds (the host-bound
    step moves between calls more than the pipeline's effect); then
    ``evaluate`` on held-out batches against the accuracy computed
    directly."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50

    t0 = time.perf_counter()
    B, HW, C = RESNET50_BATCH, RESNET50_HW, RESNET50_CLASSES
    conf = ResNet50(num_classes=C, in_shape=(HW, HW, 3),
                    updater=Nesterovs(learning_rate=1e-1,
                                      momentum=0.9)).conf()
    conf.dtype = "bfloat16"
    net = ComputationGraph(conf, device=DEVICE).init()
    n_bn = sum(isinstance(getattr(n.vertex, "layer", None),
                          BatchNormalization) for n in conf.nodes)
    rng = np.random.RandomState(0)
    n = B * (LOOP_BATCHES + LOOP_HELD_OUT)
    x = rng.randint(0, 256, (n, HW, HW, 3), dtype=np.uint8)
    y = np.eye(C, dtype=np.float32)[rng.randint(0, C, n)]
    xt, yt = x[:B * LOOP_BATCHES], y[:B * LOOP_BATCHES]
    xh, yh = x[B * LOOP_BATCHES:], y[B * LOOP_BATCHES:]
    steps, nbytes = LOOP_BATCHES, xt[:B].nbytes
    say("train-loop", f"(b) ResNet-50, bf16, batch {B}: {steps} host uint8 "
                      f"batches of {nbytes / 1e6:.1f} MB "
                      f"({x.nbytes / 1e6:.0f} MB with {LOOP_HELD_OUT} "
                      f"held out), {LOOP_WARMUP} warm-up and "
                      f"{steps - LOOP_WARMUP} timed steps a run; "
                      f"{LOOP_ROUNDS} rounds of resident, depth 2, depth 0")
    torch.backends.cudnn.benchmark = True
    try:
        xr = torch.from_numpy(xt[:B]).to(DEVICE).to(torch.bfloat16)
        yr = torch.from_numpy(yt[:B]).to(DEVICE)
        runs = {"resident": [], 2: [], 0: []}
        for _ in range(LOOP_ROUNDS):
            clock = StepClock(LOOP_WARMUP, steps)
            net.setListeners(clock)
            for _ in range(steps):
                net.fit(xr, yr)
            runs["resident"].append({"ms": clock.step_ms()})
            for depth in (2, 0):
                runs[depth].append(loop_resnet50_run(net, xt, yt, depth,
                                                     n_bn, steps))
        net.setListeners()
        del xr, yr
        # a yardstick the port never calls: the same bytes copied alone
        # from page-locked memory, the card idle
        src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
        bare_ms = cuda_ms(lambda i: dst.copy_(src, non_blocking=True), 10, 3)
        del src, dst
        ev = net.evaluate(ArrayDataSetIterator(xh, yh, B))
        correct = 0
        for i in range(LOOP_HELD_OUT):
            xb = torch.from_numpy(xh[i * B:(i + 1) * B]).to(DEVICE)
            yb = torch.from_numpy(yh[i * B:(i + 1) * B]).to(DEVICE)
            o = net.outputSingle(xb.to(torch.bfloat16))
            correct += int((o.argmax(-1) == yb.argmax(-1)).sum())
        direct = correct / (B * LOOP_HELD_OUT)
        check(ev.getNumRowCounter() == B * LOOP_HELD_OUT
              and ev.accuracy() == direct,
              f"evaluate: accuracy {ev.accuracy()} over "
              f"{ev.getNumRowCounter()} rows, directly {direct}")
    finally:
        net.setListeners()
        torch.backends.cudnn.benchmark = False

    def med(rows, key):
        return float(np.median([r[key] for r in rows]))

    here = [r["ms"] for r in runs["resident"]]
    ref = (f"phase 15's {resident_ms:.2f}" if resident_ms is not None
           else "phase 15 not run")
    say("train-loop", f"(b) resident batch: "
                      + " ".join(f"{v:.2f}" for v in here)
                      + f" ms/step by round, median {np.median(here):.2f} "
                      f"({ref}); {smi}")
    for depth in (2, 0):
        rows = runs[depth]
        ms = [r["ms"] for r in rows]
        copy, ready = med(rows, "copy"), med(rows, "ready")
        say("train-loop", f"(b) depth {depth}: "
                          + " ".join(f"{v:.2f}" for v in ms)
                          + " ms/step by round ("
                          + " ".join(f"{v / h:.3f}" for v, h in zip(ms, here))
                          + f" of the resident run before it), median "
                          f"{np.median(ms):.2f} ({B / np.median(ms) * 1e3:.1f} "
                          f"images/s); medians: ETL wait "
                          f"{med(rows, 'etl'):.3f} ms/step, host staging "
                          f"{med(rows, 'stage'):.3f} ms/batch, copies on the "
                          f"card {copy:.3f} ms/batch ({nbytes / copy / 1e6:.1f}"
                          f" GB/s of pixels) and {ready:.3f} to the end of "
                          f"the cast (CUDA events)"
                          + (f", overlap {med(rows, 'overlap'):.2f} ms from "
                             f"copy issue to consumption" if depth else "")
                          + f"; {smi}")
    say("train-loop", f"(b) yardstick: {nbytes / 1e6:.1f} MB copied alone "
                      f"from page-locked memory to the idle card "
                      f"{bare_ms:.3f} ms ({nbytes / bare_ms / 1e6:.1f} GB/s); "
                      f"{smi}")
    say("train-loop", f"(b) evaluate over {LOOP_HELD_OUT} held-out batches: "
                      f"accuracy {ev.accuracy():.6f} = argmax(output) == "
                      f"argmax(label) directly; "
                      f"{time.perf_counter() - t0:.1f} s")
    del net
    torch.cuda.empty_cache()


def loop_resnet50_run(net, x, y, depth: int, n_bn: int, steps: int) -> dict:
    """One epoch of ``steps`` batches through the prefetcher at ``depth``:
    finite losses, the batch-norm kernels once per layer per step. Returns
    ms per timed step, and means of the ETL wait per timed step, the
    overlap, the copies and the time to the end of the casts on the card,
    and the host staging per batch, all in ms."""
    from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                                   DevicePrefetchIterator)

    B = RESNET50_BATCH
    clock = StepClock(LOOP_WARMUP, steps)
    net.setListeners(clock)
    it = DevicePrefetchIterator(ArrayDataSetIterator(x, y, B), depth=depth,
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    reset_bn_counts()
    try:
        net.fit(it)
        launches = bn_counts()
        copies, ready = it.copy_ms(), it.ready_ms()
    finally:
        it.shutdown()
    losses = [float(v) for v in clock.losses]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"depth {depth}: losses {losses}")
    check(launches == (n_bn * steps,) * 3,
          f"depth {depth}: batch-norm kernel launches {launches} over "
          f"{steps} steps, not {n_bn} a step")
    check(len(copies) == steps, f"depth {depth}: {len(copies)} copies")
    etl = clock.etl_ms[LOOP_WARMUP:]
    say("train-loop", f"(b) depth {depth}: losses "
                      + " ".join(f"{v:.4f}" for v in losses)
                      + f"; batch-norm launches {launches}; queue depth "
                      f"{it.queue_depth} when last taken")
    return {"ms": clock.step_ms(), "etl": sum(etl) / len(etl),
            "overlap": (it.transfer_overlap_ms_total
                        / max(it.transfer_overlap_batches, 1)),
            "copy": sum(copies) / steps, "ready": sum(ready) / steps,
            "stage": it.stage_ms_total / steps}


def loop_char_lstm() -> None:
    """(c) The char-LSTM at phase 9's cell: ``fit(ArrayDataSetIterator)``
    over 3 batches against ``fit(x, y)`` on the same batches from the
    same weights: B5's launches per step equal, losses within
    LOOP_LOSS_RTOL."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator

    t0 = time.perf_counter()
    B, T, V = LSTM_BATCH, LSTM_SEQ, LSTM_VOCAB
    rng = np.random.default_rng(30)
    ids = rng.integers(0, V, (B * LOOP_LSTM_STEPS, T))
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[ids], eye[np.roll(ids, -1, 1)]
    a, b = (textgen_net("bfloat16", 0, DEVICE),
            textgen_net("bfloat16", 0, DEVICE))
    clock = StepClock(1, LOOP_LSTM_STEPS)
    a.setListeners(clock)
    reset_lstm_counts()
    a.fit(ArrayDataSetIterator(x, y, B))
    through_it = lstm_counts()
    reset_lstm_counts()
    direct = []
    for i in range(LOOP_LSTM_STEPS):
        b.fit(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
        direct.append(b._score)
    through_arrays = lstm_counts()
    la = [float(v) for v in clock.losses]
    lb = [float(v) for v in direct]
    check(through_it == through_arrays and min(through_it) > 0,
          f"char-LSTM: B5 launches {through_it} through the iterator, "
          f"{through_arrays} through fit(x, y)")
    rel = max(abs(p - q) / abs(q) for p, q in zip(la, lb))
    check(len(la) == LOOP_LSTM_STEPS and rel <= LOOP_LOSS_RTOL,
          f"char-LSTM: losses {la} against fit(x, y)'s {lb}")
    say("train-loop", f"(c) char-LSTM {B} x {T}, bf16: "
                      f"fit(ArrayDataSetIterator) {LOOP_LSTM_STEPS} steps, B5 "
                      f"launches (forward, backward) {through_it} = fit(x, "
                      f"y)'s; losses {' '.join(f'{v:.5f}' for v in la)} "
                      f"(max relative diff {rel:.1e}, tolerance "
                      f"{LOOP_LOSS_RTOL:g}); {time.perf_counter() - t0:.1f} s")

# ------------------------------------------------------ the recurrent graph
#: phase 18: Seq2SeqLSTM at its default widths (16 features, hidden 128,
#: 12 steps each side); the card-vs-CPU runs at batch 64, the timed cell
#: at batch 256 in bf16, the wide route at hidden 512
S2S_FEATURES, S2S_HIDDEN, S2S_T = 16, 128, 12
S2S_PARITY_BATCH, S2S_BATCH, S2S_WIDE_HIDDEN, S2S_WIDE_STEPS = 64, 256, 512, 3
#: Adam's epsilon in the card-vs-CPU runs: 1e-4 keeps lr / eps at 50, so a
#: gradient that cancels to near zero cannot turn a 1e-9 rounding
#: difference into an lr-sized parameter difference (phase 14's note)
S2S_PARITY_EPS = 1e-4
#: (d): EmbeddingLayer(77, 128) -> Bidirectional(LSTM(128), CONCAT) ->
#: masked average pooling -> OutputLayer(2), batch 64 x 200
BI_VOCAB, BI_WIDTH, BI_BATCH, BI_T = 77, 128, 64, 200
#: rnnTimeStep stepping against the full-sequence formula at f32
S2S_STEP_TOL = 1e-5


def reversal_batch(n: int, t: int, k: int, seed: int):
    """tests/test_seq2seq.py's task at ``k`` symbols: one-hot sources, the
    reversed target, and the decoder input (the target shifted right
    behind a zero "go" step)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, k, (n, t))
    eye = np.eye(k, dtype=np.float32)
    enc, out = eye[src], eye[src[:, ::-1]]
    dec = np.zeros_like(out)
    dec[:, 1:] = out[:, :-1]
    return enc, dec, out


def length_mask(n: int, t: int, lo: int, seed: int) -> np.ndarray:
    """``[n, t]`` masks of lengths drawn from ``[lo, t]``."""
    lens = np.random.RandomState(seed).randint(lo, t + 1, n)
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def seq2seq_conf(hidden: int, updater, masked: bool = False):
    """``Seq2SeqLSTM``'s configuration; ``masked`` adds a third input,
    ``encoderMask``, wired into ``LastTimeStepVertex`` beside the encoder
    (the same builder calls as the model otherwise)."""
    from deeplearning4j_tpu_torch.models import Seq2SeqLSTM
    from deeplearning4j_tpu_torch.nn.conf import (LSTM, InputType,
                                                  RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration, DuplicateToTimeSeriesVertex,
        LastTimeStepVertex, MergeVertex)

    if not masked:
        return Seq2SeqLSTM(S2S_FEATURES, S2S_FEATURES, hidden=hidden,
                           t_in=S2S_T, t_out=S2S_T, updater=updater).conf()
    b = (ComputationGraphConfiguration.graphBuilder().seed(42)
         .updater(updater)
         .addInputs("encoderInput", "decoderInput", "encoderMask")
         .setInputTypes(InputType.recurrent(S2S_FEATURES, S2S_T),
                        InputType.recurrent(S2S_FEATURES, S2S_T),
                        InputType.feedForward(S2S_T)))
    b.addLayer("encoder", LSTM(n_out=hidden, activation="tanh"),
               "encoderInput")
    b.addVertex("thought", LastTimeStepVertex(), "encoder", "encoderMask")
    b.addVertex("dup", DuplicateToTimeSeriesVertex(), "thought",
                "decoderInput")
    b.addVertex("decoderIn", MergeVertex(), "decoderInput", "dup")
    b.addLayer("decoder", LSTM(n_out=hidden, activation="tanh"),
               "decoderIn")
    b.addLayer("output", RnnOutputLayer(n_out=S2S_FEATURES,
                                        activation="softmax",
                                        loss="mcxent"), "decoder")
    return b.setOutputs("output").build()


def recurrent_tree(params_map, seed: int) -> dict:
    """Numpy weights for a graph's parameter tree (nested dicts): every
    ``W`` / ``RW`` normal at sqrt(2 / (fan_in + fan_out)), biases zero, an
    LSTM's forget-gate bias 1."""
    rng = np.random.default_rng(seed)

    def leaf(k, t):
        shape = tuple(t.shape)
        if k in ("W", "RW"):
            return (rng.standard_normal(shape) * math.sqrt(
                2.0 / (shape[0] + shape[-1]))).astype(np.float32)
        a = np.zeros(shape, np.float32)
        if k == "b" and shape[0] % 4 == 0 and shape[0] >= 4:
            a[shape[0] // 4:shape[0] // 2] = 1.0
        return a

    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in sorted(p.items())}

    return {n: walk(p) for n, p in params_map.items()}


def graph_leaves(g) -> dict:
    """``{"node/key/...": tensor}`` of a graph's parameters."""
    out = {}

    def walk(prefix, p):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                out[f"{prefix}{k}"] = v

    for n, p in g.params_map.items():
        walk(f"{n}/", p)
    return out


def card_cpu_runs(tag: str, conf, tree, batches, steps: int) -> tuple:
    """The same graph on the card and on the CPU from one numpy tree,
    ``steps`` fits of each batch list in ``batches`` (``(xs, ys,
    label_masks, feature_masks)``), held to phases 14 and 16's tolerances:
    losses IMAGE_LOSS_RTOL relative, parameters PARITY_PARAM_ATOL, the
    card's update moving some parameter by 100 x that. Returns the two
    graphs and the card's B5 launches."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.params import cg_params_from_numpy

    runs = []
    for dev in (DEVICE, "cpu"):
        g = ComputationGraph(conf, device=dev).init()
        g.params_map = cg_params_from_numpy(conf.nodes, tree, device=dev)
        start = {k: v.detach().cpu() for k, v in graph_leaves(g).items()}
        reset_lstm_counts()
        losses = []
        for _ in range(steps):
            xs, ys, lm, fm = batches
            g.fit(MultiDataSet(xs, ys, features_mask_arrays=fm,
                               labels_mask_arrays=lm))
            losses.append(g.score())
        launched = lstm_counts()
        moved = max(float((v.detach().cpu() - start[k]).abs().max())
                    for k, v in graph_leaves(g).items())
        runs.append((g, losses, launched, moved))
    (card, lc, launched, moved), (cpu, lh, none, _) = runs
    check(none == (0, 0), f"{tag}: the CPU run launched {none}")
    check_losses(tag, lc, lh)
    got, want = graph_leaves(card), graph_leaves(cpu)
    err, where = max((float((got[k].detach().cpu() - want[k]).abs().max()),
                      k) for k in want)
    check(err <= PARITY_PARAM_ATOL,
          f"{tag}: parameters differ by {err:.3e} ({where})")
    check(moved >= 100 * PARITY_PARAM_ATOL,
          f"{tag}: the card's updates moved no parameter by 100 x the "
          f"tolerance ({moved:.3e})")
    return card, cpu, launched, err, moved


def phase_seq2seq(smi: str, rows) -> None:
    """Phase 18: the recurrent ComputationGraph on the card (a)-(d); the
    phase's B5 launches go to B5's rows."""
    t0 = time.perf_counter()
    total = [0, 0, 0, 0]          # fwd, bwd (other routes); fwd, bwd wide

    def add(launched, wide):
        for i in range(2):
            total[i] += launched[i] - wide[i]
            total[2 + i] += wide[i]

    seq2seq_parity(smi, add)
    seq2seq_timed(smi, add)
    bidirectional_parity(smi, add)
    for key, n in zip(("B5", "B5 bwd", "B5 wide", "B5 bwd wide"), total):
        rows[key]["launches"] = rows[key].get("launches", 0) + n
    say("seq2seq", f"B5 launches in phase 18: forward {total[0]}, backward "
                   f"{total[1]}, wide route forward {total[2]}, backward "
                   f"{total[3]} (added to B5's rows); "
                   f"{time.perf_counter() - t0:.1f} s")


def seq2seq_parity(smi: str, add) -> None:
    """(a) Seq2SeqLSTM at f32 (TF32 off) on the card and on the CPU from
    one numpy tree, 3 Adam steps each and an ``output``: unmasked, masked
    (a features mask on the encoder input, the same mask into
    ``LastTimeStepVertex``, a labels mask on the output), and AdamW under
    an ExponentialSchedule. Then (c) stateful stepping on the unmasked
    pair."""
    from deeplearning4j_tpu_torch.learning import (Adam, AdamW,
                                                   ExponentialSchedule)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    B, T, K = S2S_PARITY_BATCH, S2S_T, S2S_FEATURES
    enc, dec, out = reversal_batch(B, T, K, seed=40)
    mask = length_mask(B, T, 4, seed=41)
    runs = (("unmasked", Adam(5e-3, epsilon=S2S_PARITY_EPS), False),
            ("masked", Adam(5e-3, epsilon=S2S_PARITY_EPS), True),
            ("AdamW + ExponentialSchedule",
             AdamW(ExponentialSchedule(5e-3, 0.9), epsilon=S2S_PARITY_EPS,
                   weight_decay=0.1), False))
    kept = None
    for tag, upd, masked in runs:
        t1 = time.perf_counter()
        conf = seq2seq_conf(S2S_HIDDEN, upd, masked)
        tree = recurrent_tree(ComputationGraph(conf, device="cpu").init()
                              .params_map, seed=50)
        if masked:
            batches = ([enc, dec, mask], [out], [mask], [mask, None, None])
        else:
            batches = ([enc, dec], [out], None, None)
        card, cpu, launched, err, moved = card_cpu_runs(
            f"seq2seq (a) {tag}", conf, tree, batches, PARITY_STEPS)
        check(launched == (2 * PARITY_STEPS, 2 * PARITY_STEPS),
              f"seq2seq (a) {tag}: B5 launches {launched}, not 2 + 2 a step")
        add(launched, lstm_wide_counts())
        xs = batches[0]
        fms = batches[3]
        o = close_card_cpu(f"seq2seq (a) {tag} output",
                           card.output(*xs, feature_masks=fms)[0],
                           cpu.output(*xs, feature_masks=fms)[0],
                           IMAGE_STATE_TOL)
        say("seq2seq", f"(a) {tag}: Seq2SeqLSTM({K}, {K}, hidden={S2S_HIDDEN},"
                       f" t_in=t_out={T}) at batch {B}, f32, "
                       f"{type(upd).__name__}: {PARITY_STEPS} steps, "
                       f"parameters max abs diff {err:.2e} (tolerance "
                       f"{PARITY_PARAM_ATOL:g}; the card moved one by up to "
                       f"{moved:.3e}), output {o:.2e}; B5 launches "
                       f"{launched}; {time.perf_counter() - t1:.1f} s")
        if tag == "unmasked":
            kept = (card, cpu)
    seq2seq_stepping(*kept, enc, dec)


def stepwise_formula(g, enc, dec):
    """What ``rnnTimeStep`` over single steps gives on the seq2seq graph:
    every recurrent vertex advances, so the decoder's step t sees the
    encoder's output at step t (its running state), not its last step.
    The encoder over the whole sequence, its outputs beside the decoder
    input, the decoder and the head."""
    by = {n.name: n.vertex for n in g.conf.nodes}
    p = g.params_map
    with torch.no_grad():
        ys, _ = by["encoder"].layer.apply(p["encoder"], {}, enc, False, None)
        yd, _ = by["decoder"].layer.apply(p["decoder"], {},
                                          torch.cat([dec, ys], -1), False,
                                          None)
        o, _ = by["output"].layer.apply(p["output"], {}, yd, False, None)
    return o


def seq2seq_stepping(card, cpu, enc, dec) -> None:
    """(c) ``rnnTimeStep``: T single steps on the card against the
    stepwise formula on the card and the same steps on the CPU; one
    T-step call against ``output()``; a batch change refused."""
    T = S2S_T
    outs = []
    for g in (card, cpu):
        e = torch.from_numpy(enc).to(g.device)
        d = torch.from_numpy(dec).to(g.device)
        g.rnnClearPreviousState()
        reset_lstm_counts()
        steps = torch.stack([g.rnnTimeStep(e[:, t], d[:, t])[0]
                             for t in range(T)], 1)
        launched = lstm_counts()
        g.rnnClearPreviousState()
        whole = g.rnnTimeStep(e, d)[0]
        g.rnnClearPreviousState()
        outs.append((steps, stepwise_formula(g, e, d), whole,
                     g.output(e, d)[0], launched))
    steps, formula, whole, full, launched = outs[0]
    check(launched == (2 * T, 0),
          f"seq2seq (c): {T} steps launched {launched}, not 2 forward a "
          f"step")
    e1 = float((steps - formula).abs().max())
    e2 = float((steps.cpu() - outs[1][0]).abs().max())
    e3 = float((whole - full).abs().max())
    check(max(e1, e2, e3) <= S2S_STEP_TOL,
          f"seq2seq (c): steps vs the stepwise formula {e1:.3e}, vs the "
          f"CPU's steps {e2:.3e}; one {T}-step call vs output() {e3:.3e}")
    try:
        card.rnnTimeStep(torch.from_numpy(enc[:2, 0]).to(card.device),
                         torch.from_numpy(dec[:2, 0]).to(card.device))
        card.rnnTimeStep(torch.from_numpy(enc[:3, 0]).to(card.device),
                         torch.from_numpy(dec[:3, 0]).to(card.device))
    except ValueError as err:
        say("seq2seq", f"(c) batch 2 -> 3 with stored state refused: {err}")
    else:
        raise RuntimeError("rnnTimeStep took a new batch size with stored "
                           "state")
    card.rnnClearPreviousState()
    say("seq2seq", f"(c) rnnTimeStep x {T} single steps at f32: against the "
                   f"stepwise formula (the encoder's running state) "
                   f"{e1:.2e}, against the CPU's steps {e2:.2e}; one "
                   f"{T}-step call against output() {e3:.2e} (tolerance "
                   f"{S2S_STEP_TOL:g}); B5 forward launches {launched[0]}")


def seq2seq_timed(smi: str, add) -> None:
    """(b) The timed cell: Seq2SeqLSTM at batch 256 in bf16, 2 warm-up and
    10 timed Adam steps, both LSTMs on the cluster route; a profiled
    step; then hidden 512 on the wide route; (c)'s stepping timed."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    B, T, K = S2S_BATCH, S2S_T, S2S_FEATURES
    enc, dec, out = (torch.from_numpy(a).to(DEVICE).to(torch.bfloat16)
                     for a in reversal_batch(B, T, K, seed=42))
    for hidden, warm, timed in ((S2S_HIDDEN, WARMUP_STEPS, TIMED_STEPS),
                                (S2S_WIDE_HIDDEN, 1, S2S_WIDE_STEPS)):
        conf = seq2seq_conf(hidden, Adam(5e-3))
        conf.dtype = "bfloat16"
        g = ComputationGraph(conf, device=DEVICE).init()
        route = "cluster" if hidden == S2S_HIDDEN else "wide"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_lstm_counts()
        losses = []
        for i in range(warm + timed):
            if i == warm:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            g.fit([enc, dec], [out])
            losses.append(g._score)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / timed
        steps = warm + timed
        counts = lstm_counts()
        on_route = (lstm_cluster_counts() if route == "cluster"
                    else lstm_wide_counts())
        add(counts, lstm_wide_counts())
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        check(counts == (2 * steps, 2 * steps) == on_route,
              f"seq2seq (b) hidden {hidden}: B5 launches {counts}, on the "
              f"{route} route {on_route}, over {steps} steps of 2 LSTMs")
        check(all(math.isfinite(v) for v in losses),
              f"seq2seq (b) hidden {hidden}: losses {losses}")
        say("seq2seq", f"(b) Seq2SeqLSTM hidden {hidden} ({g.numParams()} "
                       f"parameters), bf16, batch {B} x {T}: {timed} timed "
                       f"steps {step_s * 1e3:.3f} ms/step, "
                       f"{B * T / step_s:.1f} target tokens/s; peak memory "
                       f"{peak / 2 ** 20:.1f} MiB; B5 launches {counts}, all "
                       f"on the {route} route; losses "
                       + " ".join(f"{v:.4f}" for v in losses) + f"; {smi}")
        reset_lstm_counts()
        busy_ms = device_profile("seq2seq", f"one profiled step at hidden "
                                            f"{hidden}",
                                 lambda: g.fit([enc, dec], [out]),
                                 ("lstm_fwd", "lstm_bwd"),
                                 expect={"lstm_fwd": 2, "lstm_bwd": 2})
        add(lstm_counts(), lstm_wide_counts())
        if busy_ms:
            say("seq2seq", f"(b) hidden {hidden}: device busy {busy_ms:.3f} "
                           f"ms against {step_s * 1e3:.3f} ms per timed step "
                           f"(unprofiled): idle about "
                           f"{1 - busy_ms / (step_s * 1e3):.3f} of a step; "
                           f"{smi}")
        if hidden == S2S_HIDDEN:
            seq2seq_step_times(g, enc, dec, smi, add)
        del g
    torch.cuda.empty_cache()


def seq2seq_step_times(g, enc, dec, smi: str, add) -> None:
    """(c) timed: T single-step ``rnnTimeStep`` calls at batch 256 in
    bf16, 2 B5 forward launches a step on the cluster route."""
    T = S2S_T
    g.rnnTimeStep(enc[:, 0], dec[:, 0])        # warm-up, then a fresh state
    g.rnnClearPreviousState()
    reset_lstm_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for t in range(T):
        o = g.rnnTimeStep(enc[:, t], dec[:, t])[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / T * 1e3
    counts, cluster = lstm_counts(), lstm_cluster_counts()
    add(counts, lstm_wide_counts())
    g.rnnClearPreviousState()
    check(counts == cluster == (2 * T, 0),
          f"seq2seq (c): bf16 stepping launched {counts}, cluster route "
          f"{cluster}, not 2 forward a step on the cluster route")
    check(bool(torch.isfinite(o.float()).all()), "seq2seq (c): bf16 steps "
                                                  "not finite")
    say("seq2seq", f"(c) rnnTimeStep at batch {S2S_BATCH}, bf16: "
                   f"{ms:.3f} ms a step (host clock, both LSTMs, T = 1), B5 "
                   f"forward launches {counts[0]} over {T} steps, on the "
                   f"cluster route {cluster[0]}; {smi}")


def bidirectional_parity(smi: str, add) -> None:
    """(d) EmbeddingLayer(77, 128) -> Bidirectional(LSTM(128), CONCAT) ->
    masked GlobalPoolingLayer(AVG) -> OutputLayer(2) at batch 64 x 200 from
    ids ``[N, T, 1]`` with lengths from the seed: 3 Adam steps on the card
    and on the CPU from one numpy tree, B5 2 + 2 launches a step (the
    backward direction on the flipped input). The ids come as ``[N, T,
    1]`` through ``EmbeddingLayer`` (which drops the trailing axis): both
    packages validate a features mask against an ``[N, T, F]`` input, so
    ``EmbeddingSequenceLayer``'s ``[N, T]`` ids take none."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (LSTM, Bidirectional,
                                                  EmbeddingLayer,
                                                  GlobalPoolingLayer,
                                                  InputType, OutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration)

    t1 = time.perf_counter()
    B, T = BI_BATCH, BI_T
    b = (ComputationGraphConfiguration.graphBuilder().seed(7)
         .updater(Adam(1e-3, epsilon=S2S_PARITY_EPS)).addInputs("ids")
         .setInputTypes(InputType.recurrent(1, T)))
    b.addLayer("embed", EmbeddingLayer(n_in=BI_VOCAB, n_out=BI_WIDTH), "ids")
    b.addLayer("bilstm", Bidirectional(layer=LSTM(n_out=BI_WIDTH),
                                       mode="CONCAT"), "embed")
    b.addLayer("pool", GlobalPoolingLayer(pooling_type="avg"), "bilstm")
    b.addLayer("out", OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"), "pool")
    conf = b.setOutputs("out").build()
    tree = recurrent_tree(ComputationGraph(conf, device="cpu").init()
                          .params_map, seed=51)
    rng = np.random.RandomState(52)
    ids = rng.randint(0, BI_VOCAB, (B, T, 1)).astype(np.float32)
    mask = length_mask(B, T, 20, seed=53)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, B)]
    card, cpu, launched, err, moved = card_cpu_runs(
        "seq2seq (d) Bidirectional", conf, tree,
        ([ids], [y], None, [mask]), PARITY_STEPS)
    check(launched == (2 * PARITY_STEPS, 2 * PARITY_STEPS),
          f"seq2seq (d): B5 launches {launched}, not 2 + 2 a step")
    add(launched, lstm_wide_counts())
    o = close_card_cpu("seq2seq (d) output",
                       card.output(ids, feature_masks=[mask])[0],
                       cpu.output(ids, feature_masks=[mask])[0],
                       IMAGE_STATE_TOL)
    say("seq2seq", f"(d) EmbeddingLayer({BI_VOCAB}, {BI_WIDTH}) -> "
                   f"Bidirectional(LSTM({BI_WIDTH}), CONCAT) -> masked "
                   f"average pooling -> OutputLayer(2) at batch {B} x {T} "
                   f"(lengths 20-{T}), f32: {PARITY_STEPS} steps, parameters "
                   f"max abs diff {err:.2e} (tolerance {PARITY_PARAM_ATOL:g};"
                   f" the card moved one by up to {moved:.3e}), output "
                   f"{o:.2e}; B5 launches {launched}; "
                   f"{time.perf_counter() - t1:.1f} s; {smi}")


# --------------------------------------------------- precision policies
#: phase 19: the char-LSTM's policies in bench_common.precision_ab's order,
#: with the f16 policy last
PREC_POLICIES = ("float32", "mixed_bfloat16", "bfloat16", "mixed_float16")
#: AlexNet's batch (Krizhevsky et al., 2012)
ALEXNET_BATCH = 128
#: the narrow char-LSTM of the card-vs-CPU runs: batch x steps, hidden (a
#: cluster width of B5), and the cut ResNet's batch
PREC_PARITY_BATCH, PREC_PARITY_T, PREC_PARITY_HIDDEN = 16, 50, 64
#: card vs CPU under a mixed policy after three Nesterovs steps, as the
#: CPU tests hold the port against JAX (tests/test_torch_mixed_precision.py):
#: each side rounds every op to bf16/f16, so an f32-level difference in a
#: sum (another summation order, an f32 island's formula) moves an
#: activation by one bf16/f16 step where it crosses a rounding boundary,
#: and the cut ResNet's batch norms spread such steps. Losses relative,
#: parameters and outputs absolute (outputs of max(1, |value|)).
PREC_LSTM_TOL = (5e-4, 1e-2, 1e-3)
PREC_RESNET_TOL = (1e-2, 2e-2, 5e-2)


def policy_conf(conf, policy: str):
    """``conf`` under ``policy``: a mixed preset as its precision, an
    identity dtype ("float32", "bfloat16") as its dtype, as
    bench_common.precision_ab builds its sides."""
    if policy.startswith("mixed_"):
        conf.precision = policy
    else:
        conf.dtype = policy
    return conf


def float_dtypes(tree) -> set:
    from deeplearning4j_tpu_torch.params import tree_leaves

    return {t.dtype for t in tree_leaves(tree)
            if torch.is_tensor(t) and t.is_floating_point()}


def phase_precision(smi: str, rows, resnet_bf16_ms) -> None:
    """Phase 19: the precision policies at full width on the card (1)-(4);
    the phase's B5 and batch-norm launches go to their rows."""
    t0 = time.perf_counter()
    totals = {}

    def add(key, n):
        totals[key] = totals.get(key, 0) + n

    for policy in PREC_POLICIES:
        precision_char_lstm(policy, smi, add)
    torch.cuda.empty_cache()
    precision_resnet50(smi, add, resnet_bf16_ms)
    torch.cuda.empty_cache()
    precision_alexnet(smi)
    torch.cuda.empty_cache()
    precision_parity(smi, add)
    for key, n in totals.items():
        rows[key]["launches"] = rows[key].get("launches", 0) + n
    say("precision", "launches in phase 19 (added to their rows): "
        + ", ".join(f"{k} {n}" for k, n in totals.items())
        + f"; {time.perf_counter() - t0:.1f} s")


def precision_char_lstm(policy: str, smi: str, add) -> None:
    """(1) bench_common.build_char_lstm's model (TextGenerationLSTM,
    vocab 77, hidden 256, standard BPTT, Adam 1e-3) at batch 256 x 200
    under ``policy``: 2 warm-up and 10 timed steps, ms a step, tokens/s,
    peak memory, the idle share of a profiled step, B5's launches by
    route, the dtypes of the masters and the updater state."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    V, H, B, T = LSTM_VOCAB, LSTM_HIDDEN, LSTM_BATCH, LSTM_SEQ
    conf = policy_conf(TextGenerationLSTM(vocab_size=V, hidden=H,
                                          tbptt_length=0).conf(), policy)
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    net.params_list = mln_params_from_numpy(
        textgen_params_numpy(V, H, 0), device=DEVICE, dtype=net._dtype)
    x, y = char_batch(V, B, T, 0, net._input_dtype, DEVICE)
    mixed = policy.startswith("mixed_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lstm_counts()
    losses, skipped = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        net.fit(x, y)
        losses.append(net._score)
        ls = net._loss_scale_state
        skipped.append(ls["skipped_steps"] if ls is not None else None)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TIMED_STEPS
    counts, cluster, wide = lstm_counts(), lstm_cluster_counts(), \
        lstm_wide_counts()
    add("B5", counts[0] - wide[0])
    add("B5 bwd", counts[1] - wide[1])
    vals = [float(v) for v in losses]
    # the scale settles at the last skipped step: every later loss must be
    # finite (a skipped step's loss may be inf)
    skips = [int(s) if s is not None else 0 for s in skipped]
    settled = vals[skips.index(skips[-1]) + (1 if skips[-1] else 0):]
    check(counts == (2 * steps, 2 * steps),
          f"precision (1) {policy}: B5 launches {counts} over {steps} steps")
    check(all(math.isfinite(v) for v in settled),
          f"precision (1) {policy}: a loss after the scale settled is not "
          f"finite: {vals}")
    masters = float_dtypes(net.params_list)
    state = float_dtypes(net.opt_states)
    if mixed:
        check(masters == state == {torch.float32},
              f"precision (1) {policy}: masters {masters}, updater state "
              f"{state}, not all f32")
    if policy == "mixed_bfloat16":
        check(cluster == counts,
              f"precision (1) mixed_bfloat16: B5 launches {counts}, of "
              f"them on the cluster route {cluster}: a launch left it")
    routes = (f"forward {counts[0]} (cluster {cluster[0]}, wide {wide[0]}, "
              f"grid {counts[0] - cluster[0] - wide[0]}), backward "
              f"{counts[1]} (cluster {cluster[1]}, wide {wide[1]}, grid "
              f"{counts[1] - cluster[1] - wide[1]})")
    ls = net._loss_scale_state
    scale = ("" if ls is None else
             f"; loss scale {float(ls['scale']):g}, overflows "
             f"{int(ls['overflows'])}, skipped steps "
             f"{int(ls['skipped_steps'])}")
    say("precision", f"(1) char-LSTM {policy}: {step_s * 1e3:.3f} ms/step, "
                     f"{B * T / step_s:.1f} tokens/s; peak memory "
                     f"{peak / 2 ** 30:.3f} GiB; B5 launches {routes}; "
                     f"masters {sorted(str(d) for d in masters)}, updater "
                     f"state {sorted(str(d) for d in state)}{scale}; "
                     f"losses per character "
                     + " ".join(f"{v / T:.4f}" for v in vals) + f"; {smi}")
    reset_lstm_counts()
    busy_ms = device_profile("precision", f"(1) {policy}: "
                                          f"{PROFILED_STEPS} profiled steps",
                             lambda: [net.fit(x, y)
                                      for _ in range(PROFILED_STEPS)],
                             ("lstm_fwd", "lstm_bwd"))
    counts, wide = lstm_counts(), lstm_wide_counts()
    add("B5", counts[0] - wide[0])
    add("B5 bwd", counts[1] - wide[1])
    if busy_ms:
        per = busy_ms / PROFILED_STEPS
        say("precision", f"(1) char-LSTM {policy}: device busy {per:.3f} ms "
                         f"a profiled step against {step_s * 1e3:.3f} ms a "
                         f"timed step: idle about "
                         f"{1 - per / (step_s * 1e3):.3f}; {smi}")
    del net, x, y


def record_bn_dtypes():
    """Wrap the batch-norm statistics kernel's wrapper to record the dtype
    of every input it is handed (no launch is added or counted here);
    returns (the set, a function that puts the wrapper back)."""
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    seen, plain = set(), bn.bn_stats_kernel

    def wrapped(x2, *a, **k):
        seen.add(x2.dtype)
        return plain(x2, *a, **k)

    bn.bn_stats_kernel = wrapped

    def restore():
        bn.bn_stats_kernel = plain

    return seen, restore


def precision_resnet50(smi: str, add, bf16_ms) -> None:
    """(2) bench.py's ResNet-50, ``ResNet50(num_classes=1000,
    precision="mixed_bfloat16")``, at batch 256 x 224x224x3 with
    Nesterovs(0.1, 0.9), ``cudnn.benchmark`` on: 2 warm-up and 10 timed
    steps, ms a step and images/s beside phase 15's bf16 identity step,
    peak memory, the batch-norm kernels' launches and the dtype of their
    input (f32: the islands), the device time by group of a profiled
    step and the idle share."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import ResNet50

    B, HW, C = RESNET50_BATCH, RESNET50_HW, RESNET50_CLASSES
    conf = ResNet50(num_classes=C, in_shape=(HW, HW, 3),
                    updater=Nesterovs(learning_rate=1e-1, momentum=0.9),
                    precision="mixed_bfloat16").conf()
    net = ComputationGraph(conf, device=DEVICE).init()
    n_bn = sum(isinstance(getattr(n.vertex, "layer", None),
                          BatchNormalization) for n in conf.nodes)
    x, y = image_batch(B, HW, 3, C, seed=0)
    x = torch.from_numpy(x).to(DEVICE, net._input_dtype)
    y = torch.from_numpy(y).to(DEVICE)
    seen, restore = record_bn_dtypes()
    torch.backends.cudnn.benchmark = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_bn_counts()
        losses = []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            if i == WARMUP_STEPS:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            net.fit(x, y)
            losses.append(net._score)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / TIMED_STEPS
        peak = torch.cuda.max_memory_allocated()
        launches = bn_counts()
        steps = WARMUP_STEPS + TIMED_STEPS
        vals = [float(v) for v in losses]
        for name, k in zip((r[0] for r in BN_ROWS), launches):
            add(name, k)
        check(all(math.isfinite(v) for v in vals),
              f"precision (2): losses {vals}")
        check(launches == (n_bn * steps,) * 3,
              f"precision (2): batch-norm launches {launches}, not "
              f"{n_bn} x {steps} of each")
        check(seen == {torch.float32},
              f"precision (2): the batch-norm kernels ran on {seen}, not "
              f"on f32 inside the islands")
        masters = float_dtypes(net.params_map)
        state = float_dtypes(net.opt_states)
        check(masters == state == {torch.float32},
              f"precision (2): masters {masters}, updater state {state}")
        ident = (f"{bf16_ms:.2f} ms/step, {B / bf16_ms * 1e3:.1f} images/s"
                 if bf16_ms else "not run in this call")
        say("precision", f"(2) ResNet-50 mixed_bfloat16 at batch {B} x "
                         f"{HW}x{HW}x3, Nesterovs(0.1, 0.9): "
                         f"{step_s * 1e3:.2f} ms/step, {B / step_s:.1f} "
                         f"images/s (phase 15, bfloat16 identity, this run: "
                         f"{ident}); peak memory {peak / 2 ** 30:.3f} GiB; "
                         f"batch-norm launches {launches} ({n_bn} layers x "
                         f"{steps}), input dtype "
                         f"{sorted(str(d) for d in seen)}; losses "
                         + " ".join(f"{v:.4f}" for v in vals) + f"; {smi}")
        reset_bn_counts()
        busy_ms = device_profile(
            "precision", f"(2) one profiled mixed_bfloat16 step "
                         f"(unprofiled {step_s * 1e3:.2f} ms; {smi})",
            lambda: net.fit(x, y), ("bn_reduce_kernel", "bn_apply_kernel"),
            group=kernel_group, top=10)
        for name, k in zip((r[0] for r in BN_ROWS), bn_counts()):
            add(name, k)
        if busy_ms:
            say("precision", f"(2) idle about "
                             f"{1 - busy_ms / (step_s * 1e3):.3f} of a step "
                             f"({busy_ms:.2f} ms busy); {smi}")
    finally:
        restore()
        torch.backends.cudnn.benchmark = False
    del net, x, y


def precision_alexnet(smi: str) -> None:
    """(3) ``zoo.AlexNet(num_classes=1000)`` under mixed_bfloat16 at batch
    128 x 224x224x3 (dropout on, as fit trains it): 2 warm-up and 10 timed
    steps, ms a step, images/s; the LRN layers computed in f32."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import nn as nnops
    from deeplearning4j_tpu_torch.zoo import AlexNet

    B = ALEXNET_BATCH
    conf = policy_conf(AlexNet(num_classes=1000).conf(), "mixed_bfloat16")
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    n = net.numParams()
    check(n == 62_378_344, f"precision (3): AlexNet has {n} parameters")
    x, y = image_batch(B, 224, 3, 1000, seed=0)
    x = torch.from_numpy(x).to(DEVICE, net._input_dtype)
    y = torch.from_numpy(y).to(DEVICE)
    seen, plain = set(), nnops.local_response_normalization

    def lrn(a, *args, **kw):
        seen.add(a.dtype)
        return plain(a, *args, **kw)

    nnops.local_response_normalization = lrn
    torch.backends.cudnn.benchmark = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            if i == WARMUP_STEPS:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            net.fit(x, y)
            losses.append(net._score)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / TIMED_STEPS
    finally:
        nnops.local_response_normalization = plain
        torch.backends.cudnn.benchmark = False
    peak = torch.cuda.max_memory_allocated()
    vals = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in vals),
          f"precision (3): AlexNet losses {vals}")
    check(seen == {torch.float32}, f"precision (3): LRN ran on {seen}")
    check(float_dtypes(net.params_list) == {torch.float32},
          "precision (3): a master left f32")
    say("precision", f"(3) AlexNet ({n} parameters) mixed_bfloat16 at batch "
                     f"{B} x 224x224x3, Nesterovs(0.01, 0.9), l2 5e-4: "
                     f"{step_s * 1e3:.2f} ms/step, {B / step_s:.1f} images/s; "
                     f"peak memory {peak / 2 ** 30:.3f} GiB; LRN input "
                     f"{sorted(str(d) for d in seen)}; losses "
                     + " ".join(f"{v:.4f}" for v in vals) + f"; {smi}")
    del net, x, y


def precision_parity(smi: str, add) -> None:
    """(4) the narrow char-LSTM and the cut ResNet under mixed_bfloat16 and
    mixed_float16: 3 Nesterovs steps on the card against 3 on the CPU from
    one numpy tree; then under mixed_float16 on both devices a forced
    overflow (an input of 1e7, inf once staged in f16: the step is
    skipped, parameters and updater state bit-equal, the scale halved,
    overflows == skipped steps == 1) and the growth (growth_interval 2:
    the scale doubles after 2 clean steps), the loss-scale states equal
    across the devices."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
    from deeplearning4j_tpu_torch.params import (cg_params_from_numpy,
                                                 mln_params_from_numpy)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.resnet50 import cut_resnet_conf

    t0 = time.perf_counter()
    V, H, B, T = LSTM_VOCAB, PREC_PARITY_HIDDEN, PREC_PARITY_BATCH, \
        PREC_PARITY_T
    tree = textgen_params_numpy(V, H, 3)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (B, T))
    eye = np.eye(V, dtype=np.float32)
    cx, cy = eye[ids], eye[np.roll(ids, -1, 1)]
    ix, iy = image_batch(GRAPH_PARITY_BATCH, 32, 3, 4, seed=1)

    def lstm_net(policy, dev):
        conf = TextGenerationLSTM(vocab_size=V, hidden=H, tbptt_length=0,
                                  updater=Nesterovs(0.05, 0.9)).conf()
        conf.precision = policy
        net = MultiLayerNetwork(conf, device=dev).init()
        net.params_list = mln_params_from_numpy(tree, device=dev)
        return net

    gtree = None

    def resnet_net(policy, dev):
        nonlocal gtree
        conf = cut_resnet_conf()
        conf.precision = policy
        g = ComputationGraph(conf, device=dev).init()
        if gtree is None:
            gtree = numpy_tree(ComputationGraph(conf, device="cpu").init()
                               .params_map.items(), seed=21)
        g.params_map = cg_params_from_numpy(conf.nodes, gtree, device=dev)
        return g

    def leaves(model):
        return model.params().detach().float().cpu()

    for policy in ("mixed_bfloat16", "mixed_float16"):
        for what, make, xy, tol in (("char-LSTM", lstm_net, (cx, cy),
                                     PREC_LSTM_TOL),
                                    ("cut ResNet", resnet_net, (ix, iy),
                                     PREC_RESNET_TOL)):
            runs = []
            for dev in (DEVICE, "cpu"):
                m = make(policy, dev)
                reset_lstm_counts()
                losses = []
                for _ in range(PARITY_STEPS):
                    m.fit(*xy)
                    losses.append(m.score())
                if dev == DEVICE:
                    counts, wide = lstm_counts(), lstm_wide_counts()
                    add("B5", counts[0] - wide[0])
                    add("B5 bwd", counts[1] - wide[1])
                    cluster = lstm_cluster_counts()
                runs.append((m, losses))
            (card, lc), (cpu, lh) = runs
            rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
            perr = float((leaves(card) - leaves(cpu)).abs().max())
            out_card = (card.output(xy[0]) if what == "char-LSTM"
                        else card.outputSingle(xy[0]))
            out_cpu = (cpu.output(xy[0]) if what == "char-LSTM"
                       else cpu.outputSingle(xy[0]))
            check(out_card.dtype == torch.float32,
                  f"precision (4) {what} {policy}: output {out_card.dtype}")
            oerr = close_card_cpu(f"precision (4) {what} {policy} output",
                                  out_card, out_cpu, tol[2])
            check(all(math.isfinite(v) for v in lc + lh) and rel <= tol[0],
                  f"precision (4) {what} {policy}: losses card {lc}, CPU "
                  f"{lh} ({rel:.3e} relative > {tol[0]:g})")
            check(perr <= tol[1], f"precision (4) {what} {policy}: "
                                  f"parameters differ by {perr:.3e}")
            if what == "char-LSTM" and policy == "mixed_bfloat16":
                check(cluster == (PARITY_STEPS * 2,) * 2,
                      f"precision (4): narrow char-LSTM B5 launches on the "
                      f"cluster route {cluster}")
            say("precision", f"(4) {what} {policy}, {PARITY_STEPS} Nesterovs "
                             f"steps card against CPU: losses max relative "
                             f"diff {rel:.2e} (tolerance {tol[0]:g}), "
                             f"parameters {perr:.2e} ({tol[1]:g}), output "
                             f"{oerr:.2e} ({tol[2]:g} of max(1, |value|))")

    # the forced overflow and the growth, mixed_float16, on both devices
    pol = PrecisionPolicy.of("mixed_float16")
    pol.growth_interval = 2
    states = []
    for dev in (DEVICE, "cpu"):
        g = resnet_net(pol, dev)
        g.fit(ix, iy)
        s0 = {k: v.clone() for k, v in g._loss_scale_state.items()}
        p0, o0 = g.params().clone(), [t.clone() for t in
                                      _leaves_of(g.opt_states)]
        g.fit(ix * np.float32(1e7), iy)
        s1 = g._loss_scale_state
        held = (torch.equal(g.params(), p0)
                and all(torch.equal(a, b) for a, b in
                        zip(_leaves_of(g.opt_states), o0)))
        check(held, f"precision (4) overflow on {dev}: the skipped step "
                    f"moved the parameters or the updater state")
        check(int(s0["overflows"]) == 0 and int(s1["overflows"]) == 1
              and int(s1["skipped_steps"]) == 1
              and float(s1["scale"]) == float(s0["scale"]) * 0.5,
              f"precision (4) overflow on {dev}: loss-scale state "
              f"{ {k: float(v) for k, v in s1.items()} } after "
              f"{ {k: float(v) for k, v in s0.items()} }")
        before = float(s1["scale"])
        g.fit(ix, iy)
        g.fit(ix, iy)
        s2 = g._loss_scale_state
        check(float(s2["scale"]) == 2 * before and int(s2["good_steps"]) == 0,
              f"precision (4) growth on {dev}: scale {float(s2['scale'])} "
              f"after 2 clean steps at {before}")
        states.append({k: float(v) for k, v in s2.items()})
        states.append(g.getIterationCount())
    check(states[0] == states[2] and states[1] == states[3],
          f"precision (4): loss-scale state card {states[0]}, CPU "
          f"{states[2]}; iterations {states[1]}, {states[3]}")
    say("precision", f"(4) mixed_float16 forced overflow (input 1e7) on the "
                     f"card and the CPU: parameters and updater state held "
                     f"bit-equal, the scale halved, overflows == skipped "
                     f"steps == 1; then 2 clean steps at growth_interval 2 "
                     f"doubled it: {states[0]} on both, {states[1]} "
                     f"iterations; {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------- the vision zoo
#: phase 20: YOLO2 at its published widths (608x608x3, 80 COCO classes, 5
#: anchors: a 19x19 grid, 425 output channels) and Xception at 299x299x3,
#: 1000 classes, each under mixed_bfloat16
YOLO2_BATCH, YOLO2_HW, YOLO2_CLASSES = 16, 608, 80
#: (a)'s rate: from random weights on random images the zoo's Nesterovs
#: (1e-3, 0.9) took YOLO2's loss to NaN by the fourth step on the card
#: (696.8, 871.1, 1192.0, nan; YOLO training starts with a burn-in); at
#: 1e-5 it fell 709 -> 394-470 over 13 steps at batch 2 on the CPU
YOLO2_LR = 1e-5
XCEPTION_BATCH, XCEPTION_HW = 32, 299
#: (d): the other nine builders at their defaults, two steps at batch 4
ZOO_BATCH, ZOO_STEPS = 4, 2
#: (e) card against CPU at f32 at the CPU tests' cut sizes, with their
#: updaters and tolerances (tests/test_torch_zoo_vision.py): outputs of
#: max(1, |value|), losses relative, parameters absolute
VISION_TOL = (1e-4, 1e-4, 1e-3)
VISION_PARITY_BATCH = 2
#: (f) the batch-norm kernels at the zoo's new shapes: (model, batch, H,
#: W, C); YOLO2's first and last widths, Xception's entry and middle
#: flows, NASNet's first cell (44 channels: not a 16-byte group in bf16)
#: and InceptionResNetV1's block17 projection
VISION_BN_SHAPES = (("YOLO2", 16, 608, 608, 32), ("YOLO2", 16, 19, 19, 1024),
                    ("Xception", 32, 150, 150, 32),
                    ("Xception", 32, 19, 19, 728),
                    ("NASNet", 4, 112, 112, 44),
                    ("InceptionResNetV1", 4, 8, 8, 896))


def yolo_labels(n: int, grid: int, classes: int, seed: int,
                share: float = 0.1) -> np.ndarray:
    """``[n, grid, grid, 4 + classes]`` YOLO labels from a numpy seed, as
    ``tests/test_zoo_extended.py::TestYOLO2`` builds them: about ``share``
    of the cells hold an object, a box (x1, y1, x2, y2) in grid units
    around a point of the cell, 0.3-4 cells a side, and a one-hot class;
    the other cells are zero."""
    rng = np.random.RandomState(seed)
    y = np.zeros((n, grid, grid, 4 + classes), np.float32)
    ii, gy, gx = np.nonzero(rng.rand(n, grid, grid) < share)
    cx, cy = gx + rng.rand(len(ii)), gy + rng.rand(len(ii))
    bw, bh = rng.uniform(0.3, 4.0, (2, len(ii)))
    y[ii, gy, gx, 0], y[ii, gy, gx, 1] = cx - bw / 2, cy - bh / 2
    y[ii, gy, gx, 2], y[ii, gy, gx, 3] = cx + bw / 2, cy + bh / 2
    y[ii, gy, gx, 4 + rng.randint(0, classes, len(ii))] = 1.0
    return y


#: the activations' ops: the leaky ReLU is ``where(x >= 0, x, a * x)``,
#: and it runs inside the ``BatchNormalization`` layer's record range
ACTIVATION_OPS = ("aten::where", "aten::ge", "aten::mul")
ACTIVATION_BACKWARD = ("WhereBackward", "MulBackward")


def vision_group(chain) -> str:
    """``kernel_group`` with the YOLO loss head as its own group and the
    activation that a batch-norm layer applies (its ``where`` / ``ge`` /
    ``mul`` forward, their backward) apart from the batch norm."""
    text = " | ".join(chain)
    if "dl4j::Yolo2OutputLayer" in text:
        return "loss"
    if "BatchNormKernels" in text:
        return BN_GROUP
    if (chain[0] in ACTIVATION_OPS and "dl4j::BatchNormalization" in text) \
            or any(k in text for k in ACTIVATION_BACKWARD):
        return "activation/add"
    g = kernel_group(chain)
    return "activation/add" if g == "ReLU/add" else g


def bn_layers(conf) -> int:
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization

    nodes = getattr(conf, "nodes", None)
    layers = ([getattr(n.vertex, "layer", None) for n in nodes]
              if nodes is not None else conf.layers)
    return sum(isinstance(v, BatchNormalization) for v in layers)


def timed_fit(net, x, y, warmup: int, timed: int) -> tuple:
    """``warmup`` then ``timed`` steps of ``net.fit(x, y)``: (losses, ms a
    timed step, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / timed * 1e3
    return ([float(v) for v in losses], ms,
            torch.cuda.max_memory_allocated())


def phase_vision(smi: str, rows) -> None:
    """Phase 20: the vision zoo on the card, (a)-(f); the batch-norm
    launches of (a)-(d) go to the batch-norm rows."""
    t0 = time.perf_counter()
    totals = {}

    def add(key, n):
        totals[key] = totals.get(key, 0) + n

    torch.backends.cudnn.benchmark = True
    try:
        net, x = vision_yolo2_train(smi, add)
        vision_yolo2_decode(net, x, smi)
        del net, x
        torch.cuda.empty_cache()
        vision_xception(smi, add)
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    # (d) without autotuning: two steps would not repay it (UNet's f32
    # convolutions at 512x512x64 autotuned for ~100 s, to a 68 GiB peak)
    vision_zoo(smi, add)
    torch.cuda.empty_cache()
    vision_ties()
    vision_parity()
    torch.cuda.empty_cache()
    vision_bn_kernels(smi)
    for key, n in totals.items():
        rows[key]["launches"] = rows[key].get("launches", 0) + n
    say("vision", "batch-norm launches in phase 20 (added to their rows): "
        + ", ".join(f"{k} {n}" for k, n in totals.items())
        + f"; {time.perf_counter() - t0:.1f} s")


def vision_yolo2_train(smi: str, add) -> tuple:
    """(a) ``zoo.YOLO2()`` at 608x608x3, 80 classes, 5 anchors, under
    mixed_bfloat16 through ``ComputationGraph.fit`` at batch 16 with
    Nesterovs(``YOLO2_LR``, 0.9): 2 warm-up and 10 timed steps on one
    synthetic batch, ms a step, images/s, peak memory, finite and falling
    losses, one launch of each batch-norm kernel per layer per step on f32
    inputs (the islands), then a profiled step: idle share and device time
    by group. Returns the network and the batch for (b)."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import YOLO2

    t0 = time.perf_counter()
    B, HW, C = YOLO2_BATCH, YOLO2_HW, YOLO2_CLASSES
    conf = YOLO2(num_classes=C, in_shape=(HW, HW, 3),
                 updater=Nesterovs(YOLO2_LR, 0.9)).conf()
    conf.precision = "mixed_bfloat16"
    net = ComputationGraph(conf, device=DEVICE).init()
    n_params, n_bn = net.numParams(), bn_layers(conf)
    grid = HW // 32
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(0, 1, (B, HW, HW, 3)).astype(
        np.float32)).to(DEVICE, net._input_dtype)
    y = torch.from_numpy(yolo_labels(B, grid, C, seed=1)).to(DEVICE)
    macs = graph_macs(conf)
    flops = 6 * macs * B
    say("vision", f"(a) YOLO2(num_classes={C}, in_shape=({HW}, {HW}, 3)): "
                  f"{n_params} parameters, {len(conf.nodes)} nodes ({n_bn} "
                  f"batch norms), output {grid}x{grid}x{5 * (5 + C)}, "
                  f"mixed_bfloat16, Nesterovs({YOLO2_LR:g}, 0.9), batch {B}; "
                  f"{macs / 1e9:.3f} GMAC per image forward; "
                  f"{int(y[..., 4:].sum())} objects in the labels")
    seen, restore = record_bn_dtypes()
    try:
        reset_bn_counts()
        losses, step_ms, peak = timed_fit(net, x, y, WARMUP_STEPS,
                                          TIMED_STEPS)
        launches = bn_counts()
    finally:
        restore()
    steps = WARMUP_STEPS + TIMED_STEPS
    for name, k in zip((r[0] for r in BN_ROWS), launches):
        add(name, k)
    check(all(math.isfinite(v) for v in losses),
          f"vision (a): YOLO2 losses {losses}")
    check(losses[-1] < losses[0], f"vision (a): the YOLO2 loss did not fall "
                                  f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    check(launches == (n_bn * steps,) * 3,
          f"vision (a): batch-norm launches {launches}, not {n_bn} x {steps}")
    check(seen == {torch.float32},
          f"vision (a): the batch-norm kernels ran on {seen}, not f32")
    check(float_dtypes(net.params_map) == {torch.float32},
          "vision (a): a master left f32")
    say("vision", f"(a) YOLO2 {TIMED_STEPS} timed steps: {step_ms:.2f} "
                  f"ms/step, {B / step_ms * 1e3:.1f} images/s, "
                  f"{flops / step_ms / 1e9:.1f} TFLOP/s counted; peak memory "
                  f"{peak / 2 ** 30:.2f} GiB; batch-norm launches a step "
                  f"{tuple(k // steps for k in launches)} ({n_bn} layers, "
                  f"f32 inputs); losses "
                  + " ".join(f"{v:.4f}" for v in losses) + f"; {smi}")
    reset_bn_counts()
    busy = device_profile(
        "vision", f"(a) one profiled YOLO2 step (unprofiled {step_ms:.2f} "
                  f"ms; {smi})", lambda: net.fit(x, y),
        ("bn_reduce_kernel", "bn_apply_kernel"), group=vision_group, top=10)
    for name, k in zip((r[0] for r in BN_ROWS), bn_counts()):
        add(name, k)
    if busy:
        say("vision", f"(a) YOLO2 idle about {1 - busy / step_ms:.3f} of a "
                      f"step ({busy:.2f} ms busy of {step_ms:.2f}); "
                      f"{time.perf_counter() - t0:.1f} s")
    return net, x


def vision_yolo2_decode(net, x, smi: str) -> None:
    """(b) ``output()`` of (a)'s batch, then ``YoloUtils
    .getPredictedObjects`` on the card (decode, objectness threshold 0.5,
    NMS 0.4, 50 objects an image; and at 0.05, where the trained head
    leaves boxes to suppress): ms of each, three times; then the cut
    YOLO2 (128x128, 3 classes) on the card and the CPU from the same
    weights, a detection planted in its activations: the card's lists
    equal the CPU's."""
    from deeplearning4j_tpu_torch.nn.conf.objdetect import YoloUtils
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.params import tree_map
    from deeplearning4j_tpu_torch.zoo import YOLO2

    layer = next(n.vertex.layer for n in net.conf.nodes if n.name == "yolo")
    fwd, dec, low = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = net.outputSingle(x)
        torch.cuda.synchronize()
        fwd.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        dets = YoloUtils.getPredictedObjects(layer, out)
        dec.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        many = YoloUtils.getPredictedObjects(layer, out, 0.05, 0.4, 50)
        low.append((time.perf_counter() - t) * 1e3)
    check(out.dtype == torch.float32 and tuple(out.shape) == (
        x.shape[0], YOLO2_HW // 32, YOLO2_HW // 32, 5 * (5 + YOLO2_CLASSES))
        and bool(torch.isfinite(out).all()),
        f"vision (b): output {out.dtype} {tuple(out.shape)}")
    check(len(dets) == x.shape[0], f"vision (b): {len(dets)} lists")
    say("vision", f"(b) YOLO2 output() of batch {x.shape[0]}: "
                  + ", ".join(f"{v:.2f}" for v in fwd) + " ms; decode + NMS "
                  "on the card (getPredictedObjects, 0.5 / 0.4, 50 a image): "
                  + ", ".join(f"{v:.2f}" for v in dec) + " ms; detections "
                  f"per image {[len(d) for d in dets]}; at objectness 0.05 "
                  + ", ".join(f"{v:.2f}" for v in low) + " ms, detections "
                  f"{[len(d) for d in many]}; {smi}")
    del out, dets, many

    conf = YOLO2(num_classes=3, in_shape=(128, 128, 3)).conf()
    cpu = ComputationGraph(conf, device="cpu").init()
    card = ComputationGraph(conf, device=DEVICE).init()
    card.params_map = tree_map(lambda t: t.to(DEVICE), cpu.params_map)
    card.states_map = tree_map(lambda t: t.to(DEVICE), cpu.states_map)
    xs = np.random.RandomState(5).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    outs = [cpu.outputSingle(xs), card.outputSingle(xs)]
    err = close_card_cpu("vision (b) cut YOLO2 output", outs[1], outs[0],
                         VISION_TOL[0])
    cut_layer = next(n.vertex.layer for n in conf.nodes if n.name == "yolo")
    lists = []
    for dev, o in zip(("cpu", DEVICE), outs):
        o = o.detach().clone().reshape(2, 4, 4, 5, 8)
        o[..., 4] = -8.0                       # no objectness anywhere ...
        o[:, 1, 2, 0] = torch.tensor([0.0, 0.0, 0.0, 0.0, 8.0, -8, -8, 8])
        #                                ... but one object, class 2, and
        o[:, 1, 2, 1] = torch.tensor([0.0, 0.0, -0.7, -0.7, 6.0, -8, -8, 6])
        #                                its duplicate, suppressed by NMS;
        o[1, 3, 0, 2] = torch.tensor([0.3, -0.2, 0.1, 0.2, 5.0, -8, 9, -8])
        #                                a second object, class 1
        lists.append(YoloUtils.getPredictedObjects(
            cut_layer, o.reshape(2, 4, 4, 40), 0.5, 0.4, 10, device=dev))
    got = [[(d.getPredictedClass(), d.getCenterX(), d.getCenterY(),
             d.getWidth(), d.getHeight(), d.getConfidence()) for d in ds]
           for ds in lists[1]]
    want = [[(d.getPredictedClass(), d.getCenterX(), d.getCenterY(),
              d.getWidth(), d.getHeight(), d.getConfidence()) for d in ds]
            for ds in lists[0]]
    classes = [[t[0] for t in d] for d in want]
    check(classes == [[2], [2, 1]], f"vision (b): the CPU decoded {want}")
    check([[t[0] for t in d] for d in got] == [[t[0] for t in d]
                                                for d in want]
          and all(abs(a - b) <= 1e-6 for dg, dw in zip(got, want)
                  for tg, tw in zip(dg, dw) for a, b in zip(tg[1:], tw[1:])),
          f"vision (b): the card decoded {got}, the CPU {want}")
    say("vision", f"(b) cut YOLO2 (128x128, 3 classes) card against CPU at "
                  f"f32: output {err:.2e} (tolerance {VISION_TOL[0]:g} of "
                  f"max(1, |value|)); planted detections decode to the same "
                  f"lists on both (classes {[[t[0] for t in d] for d in got]},"
                  f" coordinates and confidences within 1e-6)")


def vision_ties() -> None:
    """The first index on a tie, on the card as on the CPU: NMS over equal
    scores, and the Yolo loss's anchor responsibility where a square
    object ties two anchors (the first takes the gradient)."""
    from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
    from deeplearning4j_tpu_torch.ops.image import non_max_suppression

    boxes = torch.tensor([[[0, 0, 1, 1], [5, 5, 6, 6], [0, 0, 1, 1.0],
                           [5, 5, 6, 6]]])
    scores = torch.full((1, 4), 0.5)
    res = [non_max_suppression(boxes.to(d), scores.to(d), 4, 0.5)
           for d in ("cpu", DEVICE)]
    check(res[0][0].tolist() == res[1][0].cpu().tolist() == [[0, 1, -1, -1]],
          f"vision: NMS on tied scores {res[0][0].tolist()} (CPU), "
          f"{res[1][0].tolist()} (card)")
    layer = Yolo2OutputLayer(anchors=((1.0, 2.0), (2.0, 1.0)))
    y = torch.zeros(1, 4, 4, 7)
    y[0, 1, 2, :4] = torch.tensor([1.75, 0.75, 3.25, 2.25])
    y[0, 1, 2, 6] = 1.0
    xg = torch.from_numpy(np.random.RandomState(2).normal(
        0, 0.5, (1, 4, 4, 16)).astype(np.float32))
    grads = []
    for dev in ("cpu", DEVICE):
        xt = xg.detach().to(dev).clone().requires_grad_(True)
        layer.loss_value({}, {}, xt, y.to(dev)).backward()
        grads.append(xt.grad.reshape(1, 4, 4, 2, 8)[0, 1, 2].cpu())
    keys = [0, 1, 2, 3, 5, 6, 7]
    check(all(bool((g[0, keys] != 0).all()) and bool((g[1, keys] == 0).all())
              for g in grads),
          f"vision: anchor tie: box gradients {grads}")
    say("vision", "ties take the first index on the card as on the CPU: NMS "
                  "[0, 1, -1, -1] on equal scores, the first of two tied "
                  "anchors responsible in the Yolo loss")


def vision_xception(smi: str, add) -> None:
    """(c) ``zoo.Xception()`` at 299x299x3, 1000 classes, under
    mixed_bfloat16 at batch 32 with its Adam(1e-3): 2 warm-up and 10 timed
    steps, ms a step, images/s, peak memory, a profiled step's idle share
    and device time by group."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import Xception

    t0 = time.perf_counter()
    B, HW = XCEPTION_BATCH, XCEPTION_HW
    conf = Xception(num_classes=1000, in_shape=(HW, HW, 3)).conf()
    conf.precision = "mixed_bfloat16"
    net = ComputationGraph(conf, device=DEVICE).init()
    n_bn = bn_layers(conf)
    x, y = image_batch(B, HW, 3, 1000, seed=2)
    x = torch.from_numpy(x).to(DEVICE, net._input_dtype)
    y = torch.from_numpy(y).to(DEVICE)
    reset_bn_counts()
    losses, step_ms, peak = timed_fit(net, x, y, WARMUP_STEPS, TIMED_STEPS)
    launches = bn_counts()
    for name, k in zip((r[0] for r in BN_ROWS), launches):
        add(name, k)
    steps = WARMUP_STEPS + TIMED_STEPS
    check(all(math.isfinite(v) for v in losses),
          f"vision (c): Xception losses {losses}")
    check(launches == (n_bn * steps,) * 3,
          f"vision (c): batch-norm launches {launches}, not {n_bn} x {steps}")
    say("vision", f"(c) Xception(num_classes=1000) ({net.numParams()} "
                  f"parameters, {len(conf.nodes)} nodes, {n_bn} batch norms) "
                  f"mixed_bfloat16 at batch {B} x {HW}x{HW}x3, Adam(1e-3): "
                  f"{step_ms:.2f} ms/step, {B / step_ms * 1e3:.1f} images/s; "
                  f"peak memory {peak / 2 ** 30:.2f} GiB; losses "
                  + " ".join(f"{v:.4f}" for v in losses) + f"; {smi}")
    reset_bn_counts()
    busy = device_profile(
        "vision", f"(c) one profiled Xception step (unprofiled "
                  f"{step_ms:.2f} ms; {smi})", lambda: net.fit(x, y),
        ("bn_reduce_kernel", "bn_apply_kernel", "onv"), group=vision_group,
        top=10)
    for name, k in zip((r[0] for r in BN_ROWS), bn_counts()):
        add(name, k)
    if busy:
        say("vision", f"(c) Xception idle about {1 - busy / step_ms:.3f} of "
                      f"a step ({busy:.2f} ms busy); "
                      f"{time.perf_counter() - t0:.1f} s")
    del net, x, y


def zoo_cases() -> list:
    """(d)'s nine models at their defaults: (name, builder, input shape,
    labels of a batch of ``ZOO_BATCH``)."""
    from deeplearning4j_tpu_torch import zoo

    rng = np.random.RandomState(3)

    def onehot(k):
        return np.eye(k, dtype=np.float32)[rng.randint(0, k, ZOO_BATCH)]

    tiny = zoo.TinyYOLO()
    return [
        ("VGG16", zoo.VGG16(), onehot(1000)),
        ("VGG19", zoo.VGG19(), onehot(1000)),
        ("Darknet19", zoo.Darknet19(), onehot(1000)),
        ("TinyYOLO", tiny, yolo_labels(ZOO_BATCH, 13, tiny.num_classes, 4)),
        ("SqueezeNet", zoo.SqueezeNet(), onehot(1000)),
        ("UNet", zoo.UNet(), (rng.rand(ZOO_BATCH, 512, 512, 1) > 0.5)
         .astype(np.float32)),
        ("InceptionResNetV1", zoo.InceptionResNetV1(), onehot(1000)),
        ("FaceNetNN4Small2", zoo.FaceNetNN4Small2(), onehot(1000)),
        ("NASNet", zoo.NASNet(), onehot(1000)),
    ]


def vision_zoo(smi: str, add) -> None:
    """(d) The other nine models at their default widths (f32, their own
    updaters): init on the card, two ``fit`` steps at batch 4; the
    parameter count, ms of the second step, peak memory; losses and
    parameters finite, and the parameters moved."""
    from deeplearning4j_tpu_torch.params import tree_leaves

    for name, model, y in zoo_cases():
        t0 = time.perf_counter()
        net = model.init(device=DEVICE)
        h, w, c = model.in_shape
        x = torch.from_numpy(np.random.RandomState(6).rand(
            ZOO_BATCH, h, w, c).astype(np.float32)).to(DEVICE)
        yt = torch.from_numpy(y).to(DEVICE)
        tree = getattr(net, "params_map", None) or net.params_list
        before = [t.detach().clone() for t in tree_leaves(tree)[:4]]
        reset_bn_counts()
        losses, step_ms, peak = timed_fit(net, x, yt, ZOO_STEPS - 1, 1)
        for key, k in zip((r[0] for r in BN_ROWS), bn_counts()):
            add(key, k)
        leaves = tree_leaves(getattr(net, "params_map", None)
                             or net.params_list)
        finite = all(bool(torch.isfinite(t).all()) for t in leaves)
        moved = max(float((a - b).abs().max())
                    for a, b in zip(leaves[:4], before))
        check(all(math.isfinite(v) for v in losses) and finite,
              f"vision (d) {name}: losses {losses}, parameters finite "
              f"{finite}")
        check(moved > 0, f"vision (d) {name}: no parameter moved")
        say("vision", f"(d) {name} ({net.numParams()} parameters, "
                      f"{h}x{w}x{c}, f32) {ZOO_STEPS} steps at batch "
                      f"{ZOO_BATCH}: second step {step_ms:.2f} ms, peak "
                      f"memory {peak / 2 ** 30:.2f} GiB, losses "
                      + " ".join(f"{v:.4f}" for v in losses)
                      + f", first weights moved by up to {moved:.2e}; "
                      f"{time.perf_counter() - t0:.1f} s; {smi}")
        del net, x, yt, leaves, before
        torch.cuda.empty_cache()


def vision_parity() -> None:
    """(e) YOLO2 (128x128, 3 classes), Xception (71x71, one middle block),
    NASNet (32x32, one cell a stage) and UNet (32x32, base 4, depth 2) at
    f32 (TF32 off) on the card and on the CPU from the CPU network's
    weights: the outputs, then three steps at the CPU tests' Nesterovs
    rates, losses and parameters within ``VISION_TOL``."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.params import tree_map

    rng = np.random.RandomState(7)
    nb = VISION_PARITY_BATCH
    g4 = np.zeros((nb, 4, 4, 7), np.float32)
    g4[:, 1, 1, :4] = (0.3, 0.3, 0.6, 0.6)
    g4[:, 1, 1, 4] = 1.0
    cases = [
        ("YOLO2", zoo.YOLO2(num_classes=3, in_shape=(128, 128, 3),
                            updater=Nesterovs(1e-8, 0.9)),
         rng.normal(0, 1, (nb, 128, 128, 3)), g4),
        ("Xception", zoo.Xception(num_classes=5, in_shape=(71, 71, 3),
                                  middle_blocks=1,
                                  updater=Nesterovs(1e-4, 0.9)),
         rng.rand(nb, 71, 71, 3), np.eye(5)[rng.randint(0, 5, nb)]),
        ("NASNet", zoo.NASNet(num_classes=3, in_shape=(32, 32, 3),
                              num_cells=1, penultimate_filters=96,
                              stem_filters=8, updater=Nesterovs(1e-3, 0.9)),
         rng.rand(nb, 32, 32, 3), np.eye(3)[rng.randint(0, 3, nb)]),
        ("UNet", zoo.UNet(in_shape=(32, 32, 3), base_filters=4, depth=2,
                          updater=Nesterovs(1e-3, 0.9)),
         rng.rand(nb, 32, 32, 3), (rng.rand(nb, 32, 32, 1) > 0.5)),
    ]
    for name, model, x, y in cases:
        t0 = time.perf_counter()
        x, y = x.astype(np.float32), y.astype(np.float32)
        cpu = model.init(device="cpu")
        card = model.init(device=DEVICE)
        card.params_map = tree_map(lambda t: t.to(DEVICE), cpu.params_map)
        card.states_map = tree_map(lambda t: t.to(DEVICE), cpu.states_map)
        card.opt_states = tree_map(
            lambda t: t.to(DEVICE) if torch.is_tensor(t) else t,
            cpu.opt_states)
        out = close_card_cpu(f"vision (e) {name} output",
                             card.outputSingle(x), cpu.outputSingle(x),
                             VISION_TOL[0])
        lc, lh = [], []
        for _ in range(PARITY_STEPS):
            card.fit(x, y)
            cpu.fit(x, y)
            lc.append(card.score())
            lh.append(cpu.score())
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        check(all(math.isfinite(v) for v in lc + lh)
              and rel <= VISION_TOL[1],
              f"vision (e) {name}: losses card {lc}, CPU {lh}")
        perr = max(float((card.params_map[n][k].cpu() - v).abs().max())
                   for n, p in cpu.params_map.items() for k, v in p.items())
        check(perr <= VISION_TOL[2],
              f"vision (e) {name}: parameters differ by {perr:.3e}")
        say("vision", f"(e) {name} card against CPU at f32 "
                      f"({cpu.numParams()} parameters, batch {nb}): output "
                      f"{out:.2e}, {PARITY_STEPS} steps' losses {rel:.2e} "
                      f"relative, parameters {perr:.2e} (tolerances "
                      f"{VISION_TOL[0]:g} of max(1, |value|), "
                      f"{VISION_TOL[1]:g}, {VISION_TOL[2]:g}); "
                      f"{time.perf_counter() - t0:.1f} s")
        del cpu, card


def vision_bn_kernels(smi: str) -> None:
    """(f) The three batch-norm kernels at the zoo's new shapes
    (``VISION_BN_SHAPES``), in f32 (the islands of (a) and (c), and (d)'s
    f32) and in bf16 (the identity policy; NASNet's 44 channels take the
    one-element plan there): against their plain versions on the card as
    phase 11b holds them (statistics within ``BN_STATS_TOL``, apply bit for
    bit, backward within ``BN_DX_TOL`` for bf16 or 1e-5 for f32 and
    ``BN_SUM_TOL``), then each kernel's event ms and share of its bound.
    These calls are checks, not main-path launches."""
    from deeplearning4j_tpu_torch.ops import batch_norm as bn

    before = bn_counts()
    for model, n, h, w, c in VISION_BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=DEVICE).manual_seed(h * c)
            x = (torch.randn(n * h * w, c, generator=g, device=DEVICE) * 2
                 + 0.5).to(dtype)
            dy = torch.randn(x.shape, generator=g, device=DEVICE).to(dtype)
            gamma = torch.rand(c, generator=g, device=DEVICE) + 0.5
            beta = torch.randn(c, generator=g, device=DEVICE)
            m, v = bn.bn_stats_kernel(x)
            rm, rv = bn.bn_stats_reference(x, (0,))
            e_stats = max(float((a - b).abs().max()) / max(1.0, float(
                b.abs().max())) for a, b in ((m, rm), (v, rv)))
            del rm, rv
            y = bn.bn_apply_kernel(x, m, v, gamma, beta, 1e-5, True)
            same = torch.equal(y, bn.bn_apply_reference(
                x, m, v, gamma, beta, 1e-5, True))
            del y
            dx, dg, db = bn.bn_backward_kernel(x, dy, m, v, gamma, beta,
                                               1e-5, True)
            wx, wg, wb = bn.bn_backward_reference(x, dy, gamma, beta, m, v,
                                                  1e-5, True, (0,))
            torch.cuda.synchronize()
            e_dx = float((dx.float() - wx.float()).abs().max()) / float(
                wx.float().abs().max())
            gsum = float(dy.float().abs().sum(0).max())
            e_db = float((db - wb).abs().max()) / gsum
            e_dg = float((dg - wg).abs().max()) / float(
                (dy.float() * (x.float() - m) * torch.rsqrt(v + 1e-5)).abs()
                .sum(0).max())
            del dx, wx
            dx_tol = BN_DX_TOL if dtype == torch.bfloat16 else 1e-5
            tag = (f"{model} {h}x{w}x{c} N={n} "
                   f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
            check(e_stats <= BN_STATS_TOL and same and e_dx <= dx_tol
                  and max(e_db, e_dg) <= BN_SUM_TOL,
                  f"vision (f) {tag}: statistics {e_stats:.2e}, apply "
                  f"bit-equal {same}, dx {e_dx:.2e}, dbeta {e_db:.2e}, "
                  f"dgamma {e_dg:.2e}")
            ms = [cuda_ms(lambda i: bn.bn_stats_kernel(x), 10, 2),
                  cuda_ms(lambda i: bn.bn_apply_kernel(x, m, v, gamma, beta),
                          10, 2),
                  cuda_ms(lambda i: bn.bn_backward_kernel(
                      x, dy, m, v, gamma, beta), 10, 2)]
            vec = bn.reduce_plan(x.shape[0], c, x.element_size(),
                                 x.data_ptr() % 16 == 0).vec
            say("vision", f"(f) {tag} ({x.shape[0]} rows; plan vec "
                          f"{vec}): statistics {e_stats:.1e}, apply "
                          f"bit-equal, dx {e_dx:.1e}, dgamma {e_dg:.1e}, "
                          f"dbeta {e_db:.1e}; " + ", ".join(
                              f"{name} {t:.4f} ms ({b[0] / t:.3f} of its "
                              f"bound {b[0]:.4f} by {b[1]})"
                              for (name, _, _), t, b in zip(
                                  BN_ROWS, ms, bn_bounds(x)))
                          + f"; {smi}")
            del x, dy, m, v
    torch.cuda.empty_cache()
    bn.stats_launches, bn.apply_launches, bn.bwd_launches = before


# ------------------------------------------------- phase 21: transfer
TRANSFER_BATCH, TRANSFER_CLASSES, TRANSFER_HW = 32, 5, 224
TRANSFER_RESNET_BATCH, TRANSFER_RESNET_HW, TRANSFER_FEATURIZED = 64, 224, 256
#: (e) the activation-shaped input of the stochastic configs
CONFIG_SHAPE = (32, 56, 56, 256)
#: a frozen fine-tune step against ``output()`` on the same batch: the
#: frozen forward is the same work as inference (no dropout or batch norm
#: in VGG16), and the 4096 x 5 head's forward, backward and update add
#: well under a per cent of its operations; the rest is launches and the
#: host's walk, which 1.3x leaves room for
TRANSFER_STEP_BOUND = 1.3
VAE_BATCH, VAE_STEPS, VAE_SCORED, VAE_SAMPLES = 128, 50, 1024, 16
#: card against CPU at f32 (TF32 off): outputs 1e-5 of max(1, |value|),
#: losses 1e-5 relative, parameters 1e-4 absolute after three steps
TRANSFER_TOL = (1e-5, 1e-5, 1e-4)
#: (e) the distribution contract: a fraction or mean within this many
#: standard deviations of the draws it averages, a variance within 5 %
CONTRACT_SIGMAS, CONTRACT_VAR_RTOL = 7.0, 0.05


def phase_transfer(smi: str) -> None:
    """Phase 21: network surgery and pretraining on the card, (a)-(f).
    No hand kernel runs on this path (VGG16's and ResNet-50's
    convolutions are cuDNN's, the frozen batch norms the plain inference
    formula, the VAE dense products), so no kernel row changes; (c)
    checks that the batch-norm kernels stay idle."""
    t0 = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    try:
        fc1 = transfer_vgg16(smi)
        torch.cuda.empty_cache()
        torch.backends.cudnn.benchmark = True
        transfer_resnet50(smi)
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    transfer_vae(smi)
    transfer_configs(fc1, smi)
    del fc1
    torch.cuda.empty_cache()
    transfer_parity()
    say("transfer", f"phase 21 {time.perf_counter() - t0:.1f} s; {smi}")


def _clones(tree) -> list:
    return [t.clone() for t in _leaves_of(tree)]


def _unchanged(tree, clones) -> bool:
    leaves = _leaves_of(tree)
    return len(leaves) == len(clones) and all(
        torch.equal(a, b) for a, b in zip(leaves, clones))


def transfer_vgg16(smi: str):
    """(a) and (b). Returns VGG16's fc1 weight for (e)."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn import transferlearning as tl
    from deeplearning4j_tpu_torch.nn.conf import OutputLayer

    t0 = time.perf_counter()
    src = zoo.VGG16(in_shape=(TRANSFER_HW, TRANSFER_HW, 3)).init(
        device=DEVICE)
    n_src = src.numParams()
    check(n_src == 138_357_544 or TRANSFER_HW != 224,
          f"transfer (a): VGG16 has {n_src} parameters")
    tuned = (tl.TransferLearning.Builder(src)
             .fineTuneConfiguration(tl.FineTuneConfiguration(
                 updater=Nesterovs(5e-5, momentum=0.9), seed=12345))
             .setFeatureExtractor(19).removeOutputLayer()
             .addLayer(OutputLayer(n_in=4096, n_out=TRANSFER_CLASSES,
                                   activation="softmax", loss="mcxent"))
             .build())
    frozen = [i for i, l in enumerate(tuned.conf.layers)
              if isinstance(l, tl.FrozenLayer)]
    check(len(frozen) == 15 and max(frozen) == 19,
          f"transfer (a): frozen layers {frozen}")
    check(all(tuned.params_list[i][k] is src.params_list[i][k]
              for i in frozen for k in src.params_list[i]),
          "transfer (a): the kept layers do not share the source's tensors")
    n_head = sum(t.numel() for t in _leaves_of(tuned.params_list[20]))
    say("transfer", f"(a) VGG16: {n_src} parameters, {len(frozen)} frozen "
                    f"layers (0-19), head 4096 x {TRANSFER_CLASSES} "
                    f"({n_head} parameters), Nesterovs(5e-5, 0.9), batch "
                    f"{TRANSFER_BATCH}, f32 (TF32 off); built in "
                    f"{time.perf_counter() - t0:.1f} s")
    x, y = image_batch(TRANSFER_BATCH, TRANSFER_HW, 3, TRANSFER_CLASSES,
                       seed=0)
    x = torch.from_numpy(x).to(DEVICE)
    y = torch.from_numpy(y).to(DEVICE)
    src_clones = _clones(src.params_list)
    # what a step does with the frozen layers: their outputs and what the
    # gradient is asked of
    outs, handed = [], []
    real_apply, real_grad = tl.FrozenLayer.apply, torch.autograd.grad

    def apply(self, *a, **kw):
        out = real_apply(self, *a, **kw)
        outs.append(out[0])
        return out

    def grad(outputs, inputs, *a, **kw):
        inputs = list(inputs)
        handed.append(sum(t.numel() for t in inputs))
        return real_grad(outputs, inputs, *a, **kw)

    tl.FrozenLayer.apply, torch.autograd.grad = apply, grad
    try:
        tuned.fit(x, y)
    finally:
        tl.FrozenLayer.apply, torch.autograd.grad = real_apply, real_grad
    check(len(outs) == len(frozen) and all(
        o.grad_fn is None and not o.requires_grad for o in outs),
        "transfer (a): a frozen layer's output carries an autograd graph")
    check(handed == [n_head], f"transfer (a): torch.autograd.grad was "
                              f"handed {handed} parameters, not the head's "
                              f"{n_head}")
    del outs
    losses, step_ms, peak = timed_fit(tuned, x, y, WARMUP_STEPS - 1,
                                      TIMED_STEPS)
    check(all(math.isfinite(v) for v in losses),
          f"transfer (a): losses {losses}")
    with torch.no_grad():
        out_ms = cuda_ms(lambda _: tuned.output(x), TIMED_STEPS, 2)
    torch.cuda.reset_peak_memory_stats()
    tuned.output(x)
    out_peak = torch.cuda.max_memory_allocated()
    # the frozen layers still hold the source's tensors, and those hold
    # their bits
    check(_unchanged(src.params_list, src_clones),
          "transfer (a): the source network moved")
    check(all(tuned.params_list[i][k] is src.params_list[i][k]
              for i in frozen for k in src.params_list[i]),
          "transfer (a): a frozen parameter was replaced")
    ratio = step_ms / out_ms
    say("transfer", f"(a) VGG16 frozen fine-tune, {TIMED_STEPS} timed "
                    f"steps: {step_ms:.2f} ms/step "
                    f"({TRANSFER_BATCH / step_ms * 1e3:.1f} images/s), "
                    f"output() {out_ms:.2f} ms, the step {ratio:.3f} of it "
                    f"(bound {TRANSFER_STEP_BOUND}); peak memory "
                    f"{peak / 2 ** 30:.2f} GiB in the steps, "
                    f"{out_peak / 2 ** 30:.2f} GiB in output(); losses "
                    + " ".join(f"{v:.4f}" for v in losses) + f"; {smi}")
    check(ratio <= TRANSFER_STEP_BOUND,
          f"transfer (a): a frozen step takes {ratio:.3f} of output()'s "
          f"time, above {TRANSFER_STEP_BOUND}")
    busy = device_profile(
        "transfer", f"(a) one profiled VGG16 frozen step (unprofiled "
                    f"{step_ms:.2f} ms; {smi})", lambda: tuned.fit(x, y),
        (), top=6)
    if busy:
        say("transfer", f"(a) VGG16 frozen step idle about "
                        f"{1 - busy / step_ms:.3f} ({busy:.2f} ms busy)")
    del src_clones
    # (b) and the unfrozen source without cuDNN's autotuning: a new batch
    # size (256) or the backward's shapes would autotune for tens of
    # seconds, to time calls that are not the cell's
    torch.backends.cudnn.benchmark = False
    transfer_helper(tuned, smi)
    # the unfrozen source at the same batch, for comparison (its step
    # moves the source, so it runs after the checks)
    y1000 = torch.zeros((TRANSFER_BATCH, 1000), device=DEVICE)
    y1000[:, 0] = 1.0
    fc1 = src.params_list[18]["W"]
    del tuned
    torch.cuda.empty_cache()
    losses, full_ms, full_peak = timed_fit(src, x, y1000, 1, 5)
    check(all(math.isfinite(v) for v in losses),
          f"transfer (a): the unfrozen source's losses {losses}")
    say("transfer", f"(a) the unfrozen VGG16 at batch {TRANSFER_BATCH} "
                    f"(cuDNN's heuristics for the backward): "
                    f"{full_ms:.2f} ms/step ({full_ms / step_ms:.2f}x the "
                    f"frozen step), peak {full_peak / 2 ** 30:.2f} GiB; "
                    f"{time.perf_counter() - t0:.1f} s; {smi}")
    return fc1


def transfer_helper(tuned, smi: str) -> None:
    """(b) ``TransferLearningHelper`` on (a)'s network:
    ``TRANSFER_FEATURIZED`` images featurized to 4096 features, 10 steps of the head on them, the head
    written back equal to ``unfrozenMLN()``'s."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import transferlearning as tl

    t0 = time.perf_counter()
    helper = tl.TransferLearningHelper(tuned)
    check(helper.frozen_up_to == 19, f"transfer (b): frozen up to "
                                     f"{helper.frozen_up_to}")
    n = TRANSFER_FEATURIZED
    x, y = image_batch(n, TRANSFER_HW, 3, TRANSFER_CLASSES, seed=1)
    ds = DataSet(torch.from_numpy(x).to(DEVICE),
                 torch.from_numpy(y).to(DEVICE))
    feat_ms = []
    for _ in range(2):      # the first call chooses cuDNN's algorithms
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = helper.featurize(ds)
        torch.cuda.synchronize()
        feat_ms.append((time.perf_counter() - t1) * 1e3)
    check(tuple(feats.features.shape) == (n, 4096)
          and feats.features.grad_fn is None
          and bool(torch.isfinite(feats.features).all()),
          f"transfer (b): features {tuple(feats.features.shape)}")
    head_ms = cuda_ms(lambda _: helper.fitFeaturized(feats), 10, 1)
    tail = helper.unfrozenMLN()
    check(all(torch.equal(tuned.params_list[20][k], v)
              for k, v in tail.params_list[0].items()),
          "transfer (b): the head written back differs from unfrozenMLN()'s")
    check(math.isfinite(tail.score()), "transfer (b): head loss not finite")
    say("transfer", f"(b) TransferLearningHelper: featurize {n} images "
                    f"{feat_ms[1]:.2f} ms ({n / feat_ms[1] * 1e3:.1f} "
                    f"images/s; the first call {feat_ms[0]:.2f} ms), "
                    f"a head step on the features {head_ms:.3f} ms, head "
                    f"loss {tail.score():.4f}; {time.perf_counter() - t0:.1f}"
                    f" s; {smi}")


def transfer_resnet50(smi: str) -> None:
    """(c) ResNet-50 in bf16 through ``TransferLearning.GraphBuilder``."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn import transferlearning as tl
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph.vertices import FrozenVertex
    from deeplearning4j_tpu_torch.zoo import ResNet50

    t0 = time.perf_counter()
    hw = TRANSFER_RESNET_HW
    conf = ResNet50(num_classes=1000, in_shape=(hw, hw, 3),
                    updater=Nesterovs(learning_rate=1e-1,
                                      momentum=0.9)).conf()
    conf.dtype = "bfloat16"
    src = ComputationGraph(conf, device=DEVICE).init()
    x, y = image_batch(TRANSFER_RESNET_BATCH, hw, 3, TRANSFER_CLASSES, seed=2)
    x = torch.from_numpy(x).to(DEVICE, torch.bfloat16)
    y = torch.from_numpy(y).to(DEVICE)
    # a trained model's running statistics: training-mode forwards of the
    # batch move the source's batch norms to its statistics (decay 0.9:
    # 0.12 of the initial state left after 20), nothing else changes
    with torch.no_grad():
        for _ in range(20):
            _, src.states_map = src._forward_all(
                src.params_map, src.states_map, src._inputs([x]), True, None)
    g = (tl.TransferLearning.GraphBuilder(src)
         .fineTuneConfiguration(tl.FineTuneConfiguration(
             updater=Nesterovs(1e-4, momentum=0.9), seed=12345))
         .setFeatureExtractor("avg_pool")
         .nOutReplace("fc", TRANSFER_CLASSES, "xavier").build())
    frozen = [n.name for n in g.conf.nodes
              if isinstance(n.vertex, FrozenVertex)]
    n_bn = sum(isinstance(getattr(n.vertex.vertex, "layer", None),
                          BatchNormalization)
               for n in g.conf.nodes if isinstance(n.vertex, FrozenVertex))
    check(n_bn == 53 and "fc" not in frozen,
          f"transfer (c): {n_bn} frozen batch norms, fc frozen: "
          f"{'fc' in frozen}")
    say("transfer", f"(c) ResNet-50: {src.numParams()} parameters, "
                    f"{len(frozen)} frozen vertices ({n_bn} batch norms), "
                    f"fc 2048 x {TRANSFER_CLASSES}, bf16, Nesterovs(1e-4, "
                    f"0.9), batch {TRANSFER_RESNET_BATCH}; the source's "
                    f"running statistics calibrated on the batch")
    fz = {n: g.params_map[n] for n in frozen}
    fz_states = {n: g.states_map[n] for n in frozen}
    p_clones, s_clones = _clones(fz), _clones(fz_states)
    reset_bn_counts()
    losses, step_ms, peak = timed_fit(g, x, y, WARMUP_STEPS, TIMED_STEPS)
    launches = bn_counts()
    steps = WARMUP_STEPS + TIMED_STEPS
    check(all(math.isfinite(v) for v in losses),
          f"transfer (c): losses {losses}")
    check(launches == (0, 0, 0), f"transfer (c): batch-norm kernel "
                                 f"launches {launches} in {steps} steps, "
                                 f"not 0: a frozen batch norm trained")
    check(_unchanged({n: g.params_map[n] for n in frozen}, p_clones)
          and _unchanged({n: g.states_map[n] for n in frozen}, s_clones),
          "transfer (c): a frozen parameter or running statistic moved")
    say("transfer", f"(c) ResNet-50 frozen fine-tune, {TIMED_STEPS} timed "
                    f"steps: {step_ms:.2f} ms/step "
                    f"({TRANSFER_RESNET_BATCH / step_ms * 1e3:.1f} "
                    f"images/s), peak {peak / 2 ** 30:.2f} GiB; batch-norm "
                    f"kernel launches a step "
                    f"{tuple(k // steps for k in launches)}; losses "
                    + " ".join(f"{v:.4f}" for v in losses) + f"; {smi}")
    busy = device_profile(
        "transfer", f"(c) one profiled ResNet-50 frozen step (unprofiled "
                    f"{step_ms:.2f} ms; {smi})", lambda: g.fit(x, y),
        (), group=kernel_group, top=6)
    if busy:
        say("transfer", f"(c) ResNet-50 frozen step idle about "
                        f"{1 - busy / step_ms:.3f} ({busy:.2f} ms busy); "
                        f"{time.perf_counter() - t0:.1f} s")


def vae_data(n: int, seed: int) -> np.ndarray:
    """``n`` synthetic 784-pixel examples in [0, 1]: ten random strokes
    patterns, each example one of them with noise, clipped."""
    rs = np.random.RandomState(seed)
    protos = (rs.rand(10, 784) < 0.15).astype(np.float32)
    x = protos[rs.randint(0, 10, n)] + rs.normal(0, 0.1, (n, 784))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def vae_conf(graph: bool):
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration,
                                                  VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration)

    vae = VariationalAutoencoder(
        n_out=32, encoder_layer_sizes=(256, 256),
        decoder_layer_sizes=(256, 256), activation="leakyrelu",
        reconstruction_distribution="bernoulli", pzx_activation="identity")
    if graph:
        vae.n_in, vae.l2 = 784, 1e-4
        return (ComputationGraphConfiguration.graphBuilder().seed(12345)
                .updater(Adam(1e-3)).addInputs("in")
                .addLayer("vae", vae, "in").setOutputs("vae")
                .setInputTypes(InputType.feedForward(784)).build())
    return (NeuralNetConfiguration.builder().seed(12345)
            .updater(Adam(1e-3)).l2(1e-4).list().layer(vae)
            .setInputType(InputType.feedForward(784)).build())


def transfer_vae(smi: str) -> None:
    """(d) The VAE of VaeMNISTAnomaly at its published widths."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t0 = time.perf_counter()
    net = MultiLayerNetwork(vae_conf(False), device=DEVICE).init()
    data = torch.from_numpy(vae_data(VAE_STEPS * VAE_BATCH, 3)).to(DEVICE)
    losses = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(VAE_STEPS):
        net.pretrainLayer(0, data[i * VAE_BATCH:(i + 1) * VAE_BATCH])
        losses.append(net._score)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / VAE_STEPS * 1e3
    losses = [float(v) for v in losses]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"transfer (d): the -ELBO did not fall ({first:.2f} -> "
          f"{last:.2f})")
    check(net.getIterationCount() == VAE_STEPS,
          "transfer (d): the pretrain steps were not counted")
    scored = data[:VAE_SCORED]
    net.reconstructionLogProbability(0, scored[:8], VAE_SAMPLES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = net.reconstructionLogProbability(0, scored, VAE_SAMPLES)
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t1) * 1e3
    check(tuple(s.shape) == (VAE_SCORED,)
          and bool(torch.isfinite(s).all()) and s.is_cuda,
          f"transfer (d): scores {tuple(s.shape)}")
    g = ComputationGraph(vae_conf(True), device=DEVICE).init()
    glosses = []
    for i in range(5):
        g.pretrainLayer("vae", data[i * VAE_BATCH:(i + 1) * VAE_BATCH])
        glosses.append(g.score())
    check(all(math.isfinite(v) for v in glosses),
          f"transfer (d): graph pretrain losses {glosses}")
    say("transfer", f"(d) VAE 784-256-256-32 (Bernoulli, "
                    f"{net.numParams()} parameters), batch {VAE_BATCH}: "
                    f"{step_ms:.3f} ms a pretrain step, -ELBO "
                    f"{losses[0]:.2f} -> {losses[-1]:.2f} (means of 5: "
                    f"{first:.2f} -> {last:.2f}); reconstructionLog"
                    f"Probability of {VAE_SCORED} x {VAE_SAMPLES} samples "
                    f"{score_ms:.2f} ms (mean {float(s.mean()):.2f}); the "
                    f"graph's 5 steps " + " ".join(f"{v:.2f}" for v in
                                                   glosses)
                    + f"; {time.perf_counter() - t0:.1f} s; {smi}")


def contract_rows(name: str, kw: dict, x, out) -> list:
    """The distribution an ``IDropout`` or ``IWeightNoise`` promises, as
    (quantity, value, expected, tolerance) rows for its output ``out`` of
    ``x`` (tensors on the card)."""
    n, rows = x.numel(), []
    if name in ("Dropout", "SpatialDropout", "DropConnect"):
        # the kept entries exactly x / keep, in x's dtype
        kept = out != 0
        rows.append(("kept = x / keep", float(
            torch.where(kept, out - x / (1.0 - kw["rate"]), 0.0).abs()
            .max()), 0.0, 0.0))
    x, out = x.double(), out.double()

    def mean_row(what, r, s2):
        # r: residuals of mean 0, s2: their variances
        rows.append((f"{what} mean", float(r.mean()), 0.0,
                     CONTRACT_SIGMAS * float(s2.sum()) ** 0.5 / n))
        rows.append((f"{what} variance ratio", float((r * r).sum())
                     / float(s2.sum()), 1.0, CONTRACT_VAR_RTOL))

    if name in ("Dropout", "SpatialDropout", "DropConnect"):
        keep = 1.0 - kw["rate"]
        kept = out != 0
        draws = kept
        if name == "SpatialDropout" and x.dim() == 4:
            rows.append(("mask constant over H, W", float(
                (kept == kept[:, :1, :1, :]).all()), 1.0, 0.0))
            draws = kept[:, 0, 0, :]
        m = draws.numel()
        rows.append(("kept fraction", float(draws.double().mean()), keep,
                     CONTRACT_SIGMAS * (keep * (1 - keep) / m) ** 0.5))
        if name != "SpatialDropout":
            mean_row("out - x", out - x, x * x * (1 - keep) / keep)
    elif name == "AlphaDropout":
        keep = 1.0 - kw["rate"]
        from deeplearning4j_tpu_torch.nn.conf.dropout import _ALPHA_PRIME
        a = (keep + _ALPHA_PRIME ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * _ALPHA_PRIME * (1 - keep)
        kept = (out - (a * x + b)).abs() <= 1e-5 * (1 + x.abs())
        rows.append(("kept fraction", float(kept.double().mean()), keep,
                     CONTRACT_SIGMAS * (keep * (1 - keep) / n) ** 0.5))
        rows.append(("dropped = a alpha' + b", float(
            ((out - (a * _ALPHA_PRIME + b)).abs() * ~kept).max()), 0.0,
            1e-6))
        if abs(float(x.mean())) < 0.01 and abs(float(x.var()) - 1) < 0.01:
            rows.append(("mean (SELU fixed point)", float(out.mean()), 0.0,
                         0.01))
            rows.append(("variance (SELU fixed point)", float(out.var()),
                         1.0, CONTRACT_VAR_RTOL))
    elif name == "GaussianDropout":
        s2 = x * x * kw["rate"] / (1 - kw["rate"])
        mean_row("out - x", out - x, s2)
    elif name == "GaussianNoise":
        mean_row("out - x", out - x, torch.full_like(x, kw["stddev"] ** 2))
    else:                                   # WeightNoise
        mu, sd = kw["mean"], kw["stddev"]
        if kw["additive"]:
            mean_row("out - x - mean", out - x - mu,
                     torch.full_like(x, sd ** 2))
        else:
            mean_row("out - mean x", out - mu * x, sd ** 2 * x * x)
    return rows


def transfer_configs(fc1, smi: str) -> None:
    """(e) The regularisation configs on the card."""
    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer, InputType, NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf import constraint as tc
    from deeplearning4j_tpu_torch.nn.conf import dropout as td
    from deeplearning4j_tpu_torch.nn.conf import weightnoise as tw
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    acts = torch.randn(CONFIG_SHAPE, generator=gen, device=DEVICE)
    ones = torch.ones(CONFIG_SHAPE, device=DEVICE)
    cases = [("Dropout", td.Dropout, dict(rate=0.5)),
             ("SpatialDropout", td.SpatialDropout, dict(rate=0.3)),
             ("GaussianDropout", td.GaussianDropout, dict(rate=0.4)),
             ("GaussianNoise", td.GaussianNoise, dict(stddev=0.1)),
             ("AlphaDropout", td.AlphaDropout, dict(rate=0.2)),
             ("DropConnect", tw.DropConnect, dict(rate=0.5)),
             ("WeightNoise", tw.WeightNoise, dict(mean=0.0, stddev=0.05,
                                                  additive=True)),
             ("WeightNoise", tw.WeightNoise, dict(mean=1.0, stddev=0.1,
                                                  additive=False))]
    inputs = {str(list(CONFIG_SHAPE)): (ones, acts),
              f"fc1 {list(fc1.shape)}": (fc1, fc1)}
    worst = 0.0
    for name, cls, kw in cases:
        cfg = cls(**kw)
        for where, (const, normal) in inputs.items():
            x = normal if name in ("GaussianNoise", "AlphaDropout",
                                   "WeightNoise") else const
            if isinstance(cfg, tw.IWeightNoise):
                b = x[0]
                out = cfg.apply({"W": x, "b": b}, gen)
                check(out["b"] is b, f"transfer (e): {name} noised a bias")
                out = out["W"]
            else:
                out = cfg.apply(x, gen)
            rows = contract_rows(name, kw, x, out)
            for what, v, want, tol in rows:
                check(abs(v - want) <= tol,
                      f"transfer (e): {name}({kw}) on {where}: {what} "
                      f"{v:.6g}, expected {want:g} +- {tol:.3g}")
                worst = max(worst, abs(v - want) / tol if tol else 0.0)
            args = ", ".join(f"{k}={v}" for k, v in kw.items())
            say("transfer", f"(e) {name}({args}) on {where}: "
                + "; ".join(f"{w} {v:.6g} (expected {e:g} +- {t:.2g})"
                            for w, v, e, t in rows))
            del out
    say("transfer", f"(e) every contract held, the worst at {worst:.2f} of "
                    f"its tolerance ({CONTRACT_SIGMAS:g} standard "
                    f"deviations of the draws' mean, variances "
                    f"{CONTRACT_VAR_RTOL:g} relative)")
    del acts, ones
    conv = torch.randn((3, 3, 256, 256), generator=gen, device=DEVICE) * 0.05
    for c in (tc.MaxNormConstraint(1.0), tc.MinMaxNormConstraint(0.5, 2.0,
                                                                 0.7),
              tc.UnitNormConstraint(), tc.NonNegativeConstraint()):
        errs = []
        for w in (fc1, conv):
            card = c.apply({"W": w})["W"]
            cpu = c.apply({"W": w.cpu()})["W"]
            errs.append(float((card.cpu() - cpu).abs().max()))
        check(max(errs) <= 1e-6, f"transfer (e): {type(c).__name__} card "
                                 f"against CPU {errs}")
        say("transfer", f"(e) {type(c).__name__}: card against CPU on fc1 "
                        f"and a 3x3x256x256 conv weight, max |diff| "
                        f"{max(errs):.2e} (tolerance 1e-6)")
    conf = (NeuralNetConfiguration.builder().seed(21).updater(Sgd(2.0))
            .list()
            .layer(DenseLayer(n_out=256, activation="relu",
                              dropout=td.Dropout(0.5),
                              weight_noise=tw.DropConnect(0.5),
                              constraints=[tc.MaxNormConstraint(2.0)]))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .setInputType(InputType.feedForward(784)).build())
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    x = torch.from_numpy(vae_data(256, 4) * 4).to(DEVICE)
    y = torch.zeros((256, 10), device=DEVICE)
    y[torch.arange(256), torch.arange(256) % 10] = 1.0
    norms = []
    for _ in range(5):
        net.fit(x, y)
        norms.append(float(torch.linalg.norm(net.params_list[0]["W"],
                                             dim=0).max()))
        check(norms[-1] <= 2.0 * (1 + 1e-6) and math.isfinite(net.score()),
              f"transfer (e): column norm {norms[-1]} after a step")
    say("transfer", f"(e) Dropout(0.5) + DropConnect(0.5) + "
                    f"MaxNormConstraint(2.0) MLN, 5 steps: largest column "
                    f"norm " + " ".join(f"{v:.4f}" for v in norms)
        + f"; {time.perf_counter() - t0:.1f} s; {smi}")


def transfer_parity() -> None:
    """(f) Card against CPU at f32 at the tests' cut sizes."""
    from deeplearning4j_tpu_torch.learning.updaters import (NoOp, Nesterovs,
                                                            Sgd)
    from deeplearning4j_tpu_torch.nn import transferlearning as tl
    from deeplearning4j_tpu_torch.nn.conf import (
        AutoEncoder, ConvolutionLayer, DenseLayer, InputType,
        NeuralNetConfiguration, OCNNOutputLayer, OutputLayer,
        SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import tree_map

    t0 = time.perf_counter()
    rs = np.random.RandomState(9)

    def mln(layers, it, updater):
        b = NeuralNetConfiguration.builder().seed(5).updater(updater).list()
        for layer in layers:
            b.layer(layer)
        return b.setInputType(it).build()

    def pair(build):
        """The network ``build(device)`` on the card and on the CPU, the
        card's parameters and state copied from the CPU's."""
        cpu, card = build("cpu"), build(DEVICE)
        tree = "params_map" if hasattr(cpu, "params_map") else "params_list"
        state = "states_map" if tree == "params_map" else "states_list"
        for attr in (tree, state):
            setattr(card, attr, tree_map(lambda t: t.to(DEVICE),
                                         getattr(cpu, attr)))
        return card, cpu

    def mln_transfer(device):
        src = MultiLayerNetwork(mln(
            [ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu"),
             SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
             DenseLayer(n_out=12, activation="relu"),
             DenseLayer(n_out=8, activation="tanh"),
             OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
            InputType.convolutional(6, 6, 2), Sgd(0.1)),
            device=device).init()
        return (tl.TransferLearning.Builder(src)
                .fineTuneConfiguration(tl.FineTuneConfiguration(
                    updater=Nesterovs(0.05, 0.9), seed=12345))
                .setFeatureExtractor(3).removeOutputLayer()
                .addLayer(OutputLayer(n_in=8, n_out=2, activation="softmax",
                                      loss="mcxent")).build())

    def graph_transfer(device):
        b = (ComputationGraphConfiguration.graphBuilder().seed(1)
             .updater(Sgd(0.1)).addInputs("in")
             .addLayer("fe1", DenseLayer(n_out=10, activation="relu"), "in")
             .addLayer("fe2", DenseLayer(n_out=8, activation="relu"), "fe1")
             .addLayer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "fe2")
             .setOutputs("out").setInputTypes(InputType.feedForward(5)))
        src = ComputationGraph(b.build(), device=device).init()
        return (tl.TransferLearning.GraphBuilder(src)
                .setFeatureExtractor("fe1").nOutReplace("fe2", 6).build())

    def gan(device):
        return MultiLayerNetwork(mln(
            [DenseLayer(n_out=6, activation="relu"),
             DenseLayer(n_out=2, activation="identity"),
             tl.FrozenLayerWithBackprop(layer=DenseLayer(
                 n_out=5, activation="leakyrelu")),
             tl.FrozenLayerWithBackprop(layer=DenseLayer(
                 n_out=5, activation="leakyrelu")),
             OutputLayer(n_out=1, activation="identity", loss="wasserstein",
                         updater=NoOp())],
            InputType.feedForward(4), Sgd(0.05)), device=device).init()

    def autoencoder(device):
        return MultiLayerNetwork(mln(
            [DenseLayer(n_out=6, activation="tanh"),
             AutoEncoder(n_out=4, corruption_level=0.0, sparsity=0.05),
             OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
            InputType.feedForward(5), Sgd(0.2)), device=device).init()

    def ocnn(device):
        return MultiLayerNetwork(mln(
            [DenseLayer(n_out=5, activation="tanh"),
             OCNNOutputLayer(hidden_size=6, nu=0.2)],
            InputType.feedForward(4), Sgd(0.05)), device=device).init()

    img = rs.randn(16, 6, 6, 2).astype(np.float32)
    vec5 = rs.randn(16, 5).astype(np.float32)
    vec4 = rs.randn(16, 4).astype(np.float32)
    cases = [("frozen MLN fine-tune", mln_transfer, img,
              np.eye(2, dtype=np.float32)[rs.randint(0, 2, 16)], "fit"),
             ("graph transfer, nOutReplace", graph_transfer, vec5,
              np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)], "fit"),
             ("FrozenLayerWithBackprop GAN", gan, vec4,
              -np.ones((16, 1), np.float32), "fit"),
             ("AutoEncoder pretrain", autoencoder, vec5, None, "pretrain"),
             ("OCNN fit", ocnn, vec4, np.zeros((16, 1), np.float32), "fit")]
    for what, build, x, y, how in cases:
        card, cpu = pair(build)
        out = close_card_cpu(f"transfer (f) {what} output",
                             _first(card.output(x)), _first(cpu.output(x)),
                             TRANSFER_TOL[0])
        lc, lh = [], []
        for _ in range(PARITY_STEPS):
            for net, losses in ((card, lc), (cpu, lh)):
                if how == "pretrain":
                    net.pretrainLayer(1, x)
                else:
                    net.fit(x, y)
                losses.append(net.score())
        rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lc, lh))
        check(all(math.isfinite(v) for v in lc + lh)
              and rel <= TRANSFER_TOL[1],
              f"transfer (f) {what}: losses card {lc}, CPU {lh}")
        tree = "params_map" if hasattr(cpu, "params_map") else "params_list"
        perr = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            _leaves_of(getattr(card, tree)), _leaves_of(getattr(cpu, tree))))
        check(perr <= TRANSFER_TOL[2],
              f"transfer (f) {what}: parameters differ by {perr:.3e}")
        say("transfer", f"(f) {what}, card against CPU at f32: output "
                        f"{out:.2e}, {PARITY_STEPS} steps' losses "
                        f"{rel:.2e} relative, parameters {perr:.2e} "
                        f"(tolerances {TRANSFER_TOL[0]:g} of max(1, "
                        f"|value|), {TRANSFER_TOL[1]:g}, "
                        f"{TRANSFER_TOL[2]:g})")
    say("transfer", f"(f) {time.perf_counter() - t0:.1f} s")


# ---------------------------------------- phase 22: the layer framework
#: (a) C3D (Tran et al. 2015, section 3.3 and Fig. 3) on clips of
#: Sports-1M's shape: batch 30 (the paper's), 16 frames of 112x112x3, 487
#: classes; eight 3x3x3 convolutions, five max pools, two fc of 4096
C3D_BATCH, C3D_FRAMES, C3D_HW, C3D_CLASSES = 30, 16, 112, 487
C3D_WIDTHS = (64, 128, 256, 256, 512, 512, 512, 512)
#: after which convolutions (by index) a max pool comes: pool1 is 1x2x2,
#: the rest 2x2x2, each in Same mode
C3D_POOLS = {0: (1, 2, 2), 1: (2, 2, 2), 3: (2, 2, 2), 5: (2, 2, 2),
             7: (2, 2, 2)}
C3D_FC, C3D_LR = 4096, 0.003
#: (b) CapsNet (Sabour et al. 2017, section 4) without the reconstruction
#: decoder and the margin loss, at f32 on 28x28x1 images
CAPS_BATCH, CAPS_STEPS, CAPS_PARAMS = 128, 30, 6_804_334
#: (c) the GRU model of TensorFlow's "Text generation with an RNN"
#: tutorial: vocabulary 65, embedding 256, GRU(1024), batch 64 x 100
GRU_VOCAB, GRU_EMBED, GRU_UNITS = 65, 256, 1024
GRU_BATCH, GRU_SEQ, GRU_SAMPLE, GRU_PARAMS = 64, 100, 200, 4_021_569
GRAVES_UNITS = 256
#: rnnTimeStep against output() on the same sequence: the softmax
#: probabilities within 1e-5 at f32 (TF32 off) and within 2^-5 at bf16
#: (the stepped input projection is another matmul shape, rounded alike
#: only at f32)
GRU_STEP_TOL = (1e-5, 2.0 ** -5)
#: (d) the attention layers at BERT-base's widths
ATTN_BATCH, ATTN_T, ATTN_D, ATTN_HEADS, ATTN_QUERIES = 32, 128, 768, 12, 4
#: (e) card against CPU at f32 (TF32 off): outputs within 1e-5 of max(1,
#: |value|), losses 1e-5 relative, parameters 1e-4 absolute after three
#: steps (the tests' tolerances)
LAYERS_TOL = (1e-5, 1e-5, 1e-4)
#: the attention classes of nn/conf/layers.py; (e) holds these and those
#: of layers_extra.py (but the vision zoo's DepthwiseConvolution2D and
#: SpaceToDepthLayer, which phase 20 drives) in its networks
SLICE_ATTENTION = {"SelfAttentionLayer", "LearnedSelfAttentionLayer",
                   "RecurrentAttentionLayer"}


def layers_group(chain) -> str:
    """The group of a kernel of phase 22's networks (which run through
    ``MultiLayerNetwork``, without record ranges) from the names of the
    CPU op that launched it and of its parents, innermost first: B5 (under
    its autograd function), conv, pool, matmul, softmax or
    elementwise/other."""
    text = " | ".join(chain)
    low = text.lower()
    if "LSTMRecurrence" in text:
        return "B5"
    if "convolution" in low:
        return "conv"
    if "pool" in low:
        return "pool"
    if any(k in text for k in ("aten::mm", "aten::addmm", "aten::bmm",
                               "MmBackward", "BmmBackward")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "elementwise/other"


def layers_mln(layers, it, updater, dtype="float32", seed=5, device=None):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    b = (NeuralNetConfiguration.builder().seed(seed).updater(updater)
         .weightInit("relu").dataType(dtype).list())
    for layer in layers:
        b.layer(layer)
    return MultiLayerNetwork(b.setInputType(it).build(),
                             device=device or DEVICE).init()


def layers_report(tag: str, what: str, net, x, y, warmup: int, timed: int,
                  items: int, unit: str, smi: str) -> tuple:
    """Train ``net`` on one batch (``warmup`` + ``timed`` steps) and print
    its parameters, ms a step, ``unit`` a second (``items`` a step), peak
    memory, and a profiled step's idle share and device time by group.
    Returns (losses, ms a step)."""
    losses, ms, peak = timed_fit(net, x, y, warmup, timed)
    check(all(math.isfinite(v) for v in losses),
          f"layers {tag}: losses {losses}")
    say("layers", f"{tag} {what}: {net.numParams()} parameters; {timed} "
                  f"timed steps after {warmup}: {ms:.2f} ms/step "
                  f"({items / ms * 1e3:.1f} {unit}/s), peak "
                  f"{peak / 2 ** 30:.2f} GiB; losses "
                  + " ".join(f"{v:.4f}" for v in losses) + f"; {smi}")
    busy = device_profile("layers", f"{tag} one profiled step (unprofiled "
                                    f"{ms:.2f} ms; {smi})",
                          lambda: net.fit(x, y), (), group=layers_group,
                          top=6)
    if busy:
        say("layers", f"{tag} idle about {max(1 - busy / ms, 0):.3f} of a "
                      f"step ({busy:.2f} ms busy)")
    return losses, ms


def phase_layers(smi: str, rows) -> None:
    """Phase 22: the rest of the layer framework on the card, (a)-(e). The
    B5 launches of (c)'s GravesBidirectionalLSTM and MaskZeroLayer go to
    B5's rows."""
    t0 = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    try:
        layers_c3d(smi)
    finally:
        torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    layers_capsnet(smi)
    torch.cuda.empty_cache()
    launched = layers_gru(smi)
    torch.cuda.empty_cache()
    layers_attention(smi)
    torch.cuda.empty_cache()
    layers_parity()
    for key, n in zip(("B5", "B5 bwd"), launched):
        rows[key]["launches"] = rows[key].get("launches", 0) + n
    say("layers", f"B5 launches in phase 22: forward {launched[0]}, "
                  f"backward {launched[1]} (cluster route; added to B5's "
                  f"rows); phase 22 {time.perf_counter() - t0:.1f} s; {smi}")


def c3d_layers():
    from deeplearning4j_tpu_torch.nn.conf import (Convolution3D, DenseLayer,
                                                  OutputLayer,
                                                  Subsampling3DLayer)

    layers = []
    for i, width in enumerate(C3D_WIDTHS):
        layers.append(Convolution3D(n_out=width, kernel_size=3,
                                    convolution_mode="Same",
                                    activation="relu"))
        if i in C3D_POOLS:
            layers.append(Subsampling3DLayer(
                kernel_size=C3D_POOLS[i], stride=C3D_POOLS[i],
                convolution_mode="Same"))
    return layers + [
        DenseLayer(n_out=C3D_FC, activation="relu"),
        DenseLayer(n_out=C3D_FC, activation="relu", dropout=0.5),
        OutputLayer(n_out=C3D_CLASSES, activation="softmax", loss="mcxent",
                    dropout=0.5)]


def layers_c3d(smi: str) -> None:
    """(a) C3D at bf16 (the ``dataType("bfloat16")`` identity), batch 30 of
    16 x 112 x 112 x 3 clips, 487 classes, Nesterovs(0.003, 0.9) as the
    paper trains it."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf import InputType

    t1 = time.perf_counter()
    it = InputType.convolutional3D(C3D_FRAMES, C3D_HW, C3D_HW, 3)
    net = layers_mln(c3d_layers(), it, Nesterovs(C3D_LR, momentum=0.9),
                     "bfloat16")
    conf = net.conf
    # the reckoning: every 3x3x3 convolution, then fc6 from pool5
    t = conf.input_type
    want, widths, macs = 0, (3,) + C3D_WIDTHS, 0
    for layer in conf.layers:
        out = layer.output_type(t)
        if type(layer).__name__ == "Convolution3D":
            want += 27 * layer.n_in * layer.n_out + layer.n_out
            macs += 27 * layer.n_in * out.arrayElementsPerExample()
        elif hasattr(layer, "n_out"):
            want += layer.n_in * layer.n_out + layer.n_out
            macs += layer.n_in * layer.n_out
        t = out
    pool5 = conf.layers[-3].n_in
    check([l.n_in for l in conf.layers
           if type(l).__name__ == "Convolution3D"] == list(widths[:-1]),
          "layers (a): C3D's convolution widths")
    check(pool5 == 1 * 4 * 4 * 512,
          f"layers (a): pool5 gives {pool5} features, not 8,192")
    check(net.numParams() == want,
          f"layers (a): C3D has {net.numParams()} parameters, the "
          f"reckoning {want}")
    check(conf.preprocessors == {len(conf.layers) - 3: "flatten"},
          f"layers (a): preprocessors {conf.preprocessors}")
    rng = np.random.RandomState(60)
    x = torch.from_numpy(rng.randn(C3D_BATCH, C3D_FRAMES, C3D_HW, C3D_HW,
                                   3).astype(np.float32)).to(
        DEVICE, torch.bfloat16)
    y = torch.zeros((C3D_BATCH, C3D_CLASSES), device=DEVICE)
    y[torch.arange(C3D_BATCH), torch.from_numpy(rng.randint(
        0, C3D_CLASSES, C3D_BATCH))] = 1.0
    say("layers", f"(a) C3D: 8 Convolution3D 3x3x3 Same ({C3D_WIDTHS}), 5 "
                  f"max Subsampling3DLayer (pool1 1x2x2), pool5 1x4x4x512 "
                  f"= {pool5} features, fc6/fc7 {C3D_FC} (dropout 0.5), "
                  f"{C3D_CLASSES} classes; {want} parameters by the "
                  f"reckoning, {macs / 1e9:.2f} GMAC a clip forward; bf16, "
                  f"batch {C3D_BATCH}; built in "
                  f"{time.perf_counter() - t1:.1f} s")
    _, ms = layers_report("(a)", f"C3D {C3D_FRAMES}x{C3D_HW}x{C3D_HW}x3",
                          net, x, y, WARMUP_STEPS, TIMED_STEPS, C3D_BATCH,
                          "clips", smi)
    tflops = 3 * 2 * macs * C3D_BATCH / (ms * 1e-3) / 1e12
    say("layers", f"(a) C3D about {tflops:.1f} TFLOP/s of its forward and "
                  f"backward (3 x the forward's MACs); "
                  f"{time.perf_counter() - t1:.1f} s")


def capsnet_data(n: int, seed: int):
    """28x28x1 images whose class can be learned: one of ten fixed
    random strokes (a template per class, from the seed) at a random
    shift, under noise; one-hot labels."""
    rng = np.random.RandomState(seed)
    templates = (rng.rand(10, 12, 12) > 0.7).astype(np.float32)
    y = rng.randint(0, 10, n)
    x = 0.1 * rng.rand(n, 28, 28, 1).astype(np.float32)
    for i, k in enumerate(y):
        r, c = rng.randint(4, 13, 2)
        x[i, r:r + 12, c:c + 12, 0] += templates[k]
    return x, np.eye(10, dtype=np.float32)[y]


def capsnet_layers():
    from deeplearning4j_tpu_torch.nn.conf import (CapsuleLayer,
                                                  CapsuleStrengthLayer,
                                                  ConvolutionLayer,
                                                  OutputLayer,
                                                  PrimaryCapsules)

    return [ConvolutionLayer(n_out=256, kernel_size=(9, 9), stride=(1, 1),
                             activation="relu"),
            PrimaryCapsules(channels=32, capsule_dimensions=8,
                            kernel_size=(9, 9), stride=(2, 2)),
            CapsuleLayer(capsules=10, capsule_dimensions=16, routings=3),
            CapsuleStrengthLayer(),
            OutputLayer(n_out=10, activation="softmax", loss="mcxent")]


def layers_capsnet(smi: str) -> None:
    """(b) CapsNet at f32 (TF32 off), batch 128, Adam(1e-3): 2 warm-up and
    28 timed steps, the loss falling; every capsule shorter than 1."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import InputType

    t1 = time.perf_counter()
    net = layers_mln(capsnet_layers(), InputType.convolutional(28, 28, 1),
                     Adam(1e-3))
    check(net.numParams() == CAPS_PARAMS,
          f"layers (b): CapsNet has {net.numParams()} parameters, not "
          f"{CAPS_PARAMS:,}")
    caps = net.conf.layers[2]
    check((caps.input_capsules, caps.n_in) == (1152, 8),
          f"layers (b): {caps.input_capsules} primary capsules of "
          f"{caps.n_in}, not 1,152 of 8")
    x, y = capsnet_data(CAPS_BATCH, seed=61)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in (x, y))
    losses, _ = layers_report(
        "(b)", "CapsNet 28x28x1 (Conv 256 9x9 -> PrimaryCapsules 32 x 8 -> "
               "CapsuleLayer 10 x 16, 3 routings -> strength -> softmax)",
        net, x, y, WARMUP_STEPS, CAPS_STEPS - WARMUP_STEPS, CAPS_BATCH,
        "images", smi)
    check(losses[-1] < losses[0], f"layers (b): the loss did not fall "
                                  f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    with torch.no_grad():
        v = net.feedForward(x)[3]
    longest = float(torch.linalg.norm(v.float(), dim=-1).max())
    check(tuple(v.shape) == (CAPS_BATCH, 10, 16) and longest < 1.0,
          f"layers (b): capsules {tuple(v.shape)}, longest {longest}")
    say("layers", f"(b) loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
                  f"{CAPS_STEPS} steps; the longest of {CAPS_BATCH} x 10 "
                  f"capsules {longest:.4f}; "
                  f"{time.perf_counter() - t1:.1f} s")


def gru_char_layers():
    from deeplearning4j_tpu_torch.nn.conf import (GRU, EmbeddingSequenceLayer,
                                                  RnnOutputLayer)

    return [EmbeddingSequenceLayer(n_in=GRU_VOCAB, n_out=GRU_EMBED),
            GRU(n_out=GRU_UNITS, recurrent_bias=True),
            RnnOutputLayer(n_out=GRU_VOCAB, activation="softmax",
                           loss="mcxent")]


def char_ids(n: int, t: int, seed: int):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, GRU_VOCAB, (n, t + 1))
    eye = np.eye(GRU_VOCAB, dtype=np.float32)
    return ids[:, :-1].astype(np.float32), eye[ids[:, 1:]]


def layers_gru(smi: str) -> tuple:
    """(c) The GRU character model at bf16, its sampling through
    ``rnnTimeStep``, cuDNN's ``nn.GRU`` as a yardstick, then
    ``GravesBidirectionalLSTM`` and ``MaskZeroLayer(LSTM)`` on B5. Returns
    the B5 launches (forward, backward) of its runs."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import InputType

    t1 = time.perf_counter()
    it = InputType.recurrent(1, GRU_SEQ)
    net = layers_mln(gru_char_layers(), it, Adam(1e-3), "bfloat16")
    check(net.numParams() == GRU_PARAMS,
          f"layers (c): the GRU model has {net.numParams()} parameters, not "
          f"{GRU_PARAMS:,}")
    ids, y = char_ids(GRU_BATCH, GRU_SEQ, seed=62)
    x = torch.from_numpy(ids).to(DEVICE)
    y = torch.from_numpy(y).to(DEVICE)
    _, ms = layers_report(
        "(c)", f"GRU char model (Embedding {GRU_VOCAB}x{GRU_EMBED} -> "
               f"GRU({GRU_UNITS}, two biases) -> softmax {GRU_VOCAB}), bf16, "
               f"{GRU_BATCH} x {GRU_SEQ}", net, x, y, WARMUP_STEPS,
        TIMED_STEPS, GRU_BATCH * GRU_SEQ, "tokens", smi)
    gru_sampling(net)
    gru_stepping(net)
    gru_yardstick(net, x)
    reset_lstm_counts()
    graves_lstm(smi)
    mask_zero_lstm()
    launched = lstm_counts()
    check(launched[0] > 0 and launched[1] > 0 and lstm_wide_counts() == (0, 0)
          and lstm_cluster_counts() == launched,
          f"layers (c): B5 launches {launched}, of which "
          f"{lstm_cluster_counts()} on the cluster route and "
          f"{lstm_wide_counts()} on the wide route")
    say("layers", f"(c) {time.perf_counter() - t1:.1f} s")
    return launched


def gru_sampling(net) -> None:
    """200 characters through ``rnnTimeStep`` from one seed character,
    each drawn from the softmax by a numpy generator."""
    rng = np.random.RandomState(63)
    net.rnnClearPreviousState()
    # ids [N] are one step of EmbeddingSequenceLayer (a sequence of one)
    c = np.zeros((1,), np.float32)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRU_SAMPLE):
        p = net.rnnTimeStep(c)
        probs = p[0, -1].float().cpu().numpy().astype(np.float64)
        k = int(rng.choice(GRU_VOCAB, p=probs / probs.sum()))
        out.append(k)
        c = np.full((1,), k, np.float32)
    ms = (time.perf_counter() - t0) / GRU_SAMPLE * 1e3
    net.rnnClearPreviousState()
    check(len(set(out)) > 1, f"layers (c): samples {out[:20]}")
    say("layers", f"(c) sampled {GRU_SAMPLE} characters through rnnTimeStep "
                  f"at batch 1: {ms:.3f} ms a character (the host's draw "
                  f"included)")


def gru_stepping(net) -> None:
    """``rnnTimeStep`` one step at a time against ``output()`` on the same
    sequences: at bf16 on the model itself, and at f32 (TF32 off) on a
    copy of its parameters."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import InputType
    from deeplearning4j_tpu_torch.params import tree_map

    ids, _ = char_ids(4, GRU_SEQ, seed=64)
    f32 = layers_mln(gru_char_layers(), InputType.recurrent(1, GRU_SEQ),
                     Adam(1e-3))
    f32.params_list = tree_map(lambda t: t.float(), net.params_list)
    errs = []
    for model, tol in ((f32, GRU_STEP_TOL[0]), (net, GRU_STEP_TOL[1])):
        with torch.no_grad():
            full = model.output(ids).float()
            model.rnnClearPreviousState()
            steps = torch.stack([model.rnnTimeStep(ids[:, t])[:, 0]
                                 for t in range(GRU_SEQ)], dim=1).float()
            model.rnnClearPreviousState()
        errs.append(close_card_cpu("layers (c) rnnTimeStep vs output()",
                                   steps, full, tol))
    say("layers", f"(c) rnnTimeStep over {GRU_SEQ} steps against output() "
                  f"(batch 4): max |diff| of the probabilities f32 "
                  f"{errs[0]:.2e} (tolerance {GRU_STEP_TOL[0]:g}), bf16 "
                  f"{errs[1]:.2e} (tolerance {GRU_STEP_TOL[1]:g})")


def gru_yardstick(net, x) -> None:
    """The port's GRU layer (the plain loop over T) forward and forward +
    backward at the model's shape beside cuDNN's ``nn.GRU`` (the same
    reset-after cell and biases), which the port never calls."""
    from deeplearning4j_tpu_torch.ops import nn as tnn

    p = net.params_list[1]
    with torch.no_grad():
        emb, _ = net.conf.layers[0].apply(net.params_list[0], {}, x, False,
                                          None)
    emb = emb.detach()
    leaves = [p["W"], p["RW"], p["b"], p["Rb"]]

    def port(grad: bool):
        ws = [t.detach().requires_grad_(grad) for t in leaves]
        ys, _ = tnn.gru_layer(emb, *ws[:3], rb=ws[3])
        if grad:
            torch.autograd.grad(ys.float().sum(), ws)

    ref = torch.nn.GRU(GRU_EMBED, GRU_UNITS, batch_first=True).to(
        DEVICE, torch.bfloat16)
    ref.flatten_parameters()

    def cudnn(grad: bool):
        ys, _ = ref(emb)
        if grad:
            torch.autograd.grad(ys.float().sum(), list(ref.parameters()))

    times = {}
    for name, fn in (("port", port), ("cudnn", cudnn)):
        with torch.no_grad():
            times[name, "fwd"] = cuda_ms(lambda _: fn(False), 5, 2)
        times[name, "fwd+bwd"] = cuda_ms(lambda _: fn(True), 5, 2)
    say("layers", f"(c) GRU({GRU_UNITS}) alone at {GRU_BATCH} x {GRU_SEQ} x "
                  f"{GRU_EMBED}, bf16: the port's loop forward "
                  f"{times['port', 'fwd']:.3f} ms, forward + backward "
                  f"{times['port', 'fwd+bwd']:.3f} ms; cuDNN nn.GRU "
                  f"(yardstick, not on the path) {times['cudnn', 'fwd']:.3f} "
                  f"/ {times['cudnn', 'fwd+bwd']:.3f} ms")


def graves_lstm(smi: str) -> None:
    """``GravesBidirectionalLSTM(256)`` on (c)'s batch at bf16 (B5's
    cluster route): B5 launches a step, and its output equal to
    ``Bidirectional(LSTM(256), "CONCAT")``'s on the same parameters."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (
        LSTM, Bidirectional, EmbeddingSequenceLayer, GravesBidirectionalLSTM,
        InputType, RnnOutputLayer)

    def layers(rec):
        return [EmbeddingSequenceLayer(n_in=GRU_VOCAB, n_out=GRU_EMBED), rec,
                RnnOutputLayer(n_out=GRU_VOCAB, activation="softmax",
                               loss="mcxent")]

    it = InputType.recurrent(1, GRU_SEQ)
    net = layers_mln(layers(GravesBidirectionalLSTM(n_out=GRAVES_UNITS)),
                     it, Adam(1e-3), "bfloat16")
    ids, y = char_ids(GRU_BATCH, GRU_SEQ, seed=65)
    x = torch.from_numpy(ids).to(DEVICE)
    y = torch.from_numpy(y).to(DEVICE)
    f0, b0 = lstm_counts()
    _, ms = layers_report("(c)", f"GravesBidirectionalLSTM({GRAVES_UNITS}) "
                                 f"char model, bf16, {GRU_BATCH} x "
                                 f"{GRU_SEQ}", net, x, y, WARMUP_STEPS,
                          TIMED_STEPS, GRU_BATCH * GRU_SEQ, "tokens", smi)
    launched = (lstm_counts()[0] - f0, lstm_counts()[1] - b0)
    steps = WARMUP_STEPS + TIMED_STEPS + 1        # the profiled step too
    check(launched == (2 * steps, 2 * steps),
          f"layers (c): B5 launches {launched} over {steps} steps, not two "
          f"forward and two backward a step")
    same = layers_mln(layers(Bidirectional(layer=LSTM(n_out=GRAVES_UNITS),
                                           mode="CONCAT")),
                      it, Adam(1e-3), "bfloat16")
    same.params_list = net.params_list
    with torch.no_grad():
        a, b = net.output(x), same.output(x)
    check(torch.equal(a, b), "layers (c): GravesBidirectionalLSTM's output "
                             "differs from Bidirectional(LSTM)'s")
    say("layers", f"(c) GravesBidirectionalLSTM: B5 launches {launched} over "
                  f"{steps} steps (two forward, two backward a step, the "
                  f"cluster route), output bit-equal to Bidirectional(LSTM("
                  f"{GRAVES_UNITS}), CONCAT) on the same parameters")


def mask_zero_lstm() -> None:
    """``MaskZeroLayer(LSTM(256))`` at bf16 on one-hot rows padded with
    the mask value (0) from lengths 40-100 (of 100): the padded steps give
    zero output; two steps and a forward on B5."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (LSTM, InputType,
                                                  MaskZeroLayer,
                                                  RnnOutputLayer)

    net = layers_mln([MaskZeroLayer(layer=LSTM(n_out=GRAVES_UNITS),
                                    mask_value=0.0),
                      RnnOutputLayer(n_out=GRU_VOCAB, activation="softmax",
                                     loss="mcxent")],
                     InputType.recurrent(GRU_VOCAB, GRU_SEQ), Adam(1e-3),
                     "bfloat16")
    _, y = char_ids(GRU_BATCH, GRU_SEQ, seed=66)
    x, _ = char_ids(GRU_BATCH, GRU_SEQ, seed=67)
    x = np.eye(GRU_VOCAB, dtype=np.float32)[x.astype(int)]
    lengths = np.random.RandomState(68).randint(2 * GRU_SEQ // 5,
                                                GRU_SEQ + 1, GRU_BATCH)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    x = torch.from_numpy(x).to(DEVICE, torch.bfloat16)
    y = torch.from_numpy(y).to(DEVICE)
    f0, b0 = lstm_counts()
    for _ in range(2):
        net.fit(x, y)
    with torch.no_grad():
        h = net.feedForward(x)[1]
    launched = (lstm_counts()[0] - f0, lstm_counts()[1] - b0)
    pad = torch.from_numpy(np.arange(GRU_SEQ)[None, :] >= lengths[:, None]
                           ).to(DEVICE)
    check(bool(torch.all(h[pad] == 0)) and bool(torch.all(
        h[~pad].float().abs().sum(-1) > 0)),
        "layers (c): MaskZeroLayer's padded steps are not zero, or a real "
        "one is")
    check(launched == (3, 2), f"layers (c): MaskZeroLayer B5 launches "
                              f"{launched}, not 3 forward and 2 backward")
    say("layers", f"(c) MaskZeroLayer(LSTM({GRAVES_UNITS})) at bf16 on rows "
                  f"padded from lengths {lengths.min()}-{lengths.max()}: "
                  f"{int(pad.sum())} padded steps all zero, B5 launches "
                  f"{launched} over 2 steps and a forward")


def layers_attention(smi: str) -> None:
    """(d) SelfAttentionLayer -> RecurrentAttentionLayer ->
    LearnedSelfAttentionLayer(4) -> average pooling -> OutputLayer(2) at
    BERT-base's widths, bf16; then the recurrent layer's forward and
    backward alone, its share of the step."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (
        GlobalPoolingLayer, InputType, LearnedSelfAttentionLayer,
        OutputLayer, RecurrentAttentionLayer, SelfAttentionLayer)

    t1 = time.perf_counter()
    d, h = ATTN_D, ATTN_HEADS
    net = layers_mln([SelfAttentionLayer(n_out=d, n_heads=h),
                      RecurrentAttentionLayer(n_out=d, n_heads=h),
                      LearnedSelfAttentionLayer(n_out=d, n_heads=h,
                                                n_queries=ATTN_QUERIES),
                      GlobalPoolingLayer(pooling_type="avg"),
                      OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent")],
                     InputType.recurrent(d, ATTN_T), Adam(1e-4), "bfloat16")
    check(all(l.head_size == d // h for l in net.conf.layers[:3]),
          "layers (d): head sizes")
    rng = np.random.RandomState(69)
    x = torch.from_numpy(rng.randn(ATTN_BATCH, ATTN_T, d).astype(
        np.float32)).to(DEVICE, torch.bfloat16)
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[
        rng.randint(0, 2, ATTN_BATCH)]).to(DEVICE)
    _, ms = layers_report("(d)", f"attention stack, d_model {d}, {h} heads "
                                 f"of {d // h}, T {ATTN_T}, bf16",
                          net, x, y, WARMUP_STEPS, TIMED_STEPS,
                          ATTN_BATCH * ATTN_T, "tokens", smi)
    layer, p = net.conf.layers[1], net.params_list[1]
    with torch.no_grad():
        a, _ = net.conf.layers[0].apply(net.params_list[0], {}, x, False,
                                        None)

    def loop(_):
        ps = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xin = a.detach().requires_grad_(True)
        out, _ = layer.apply(ps, {}, xin, True, None)
        torch.autograd.grad(out.float().sum(), [xin, *ps.values()])

    loop_ms = cuda_ms(loop, 3, 1)
    say("layers", f"(d) RecurrentAttentionLayer's {ATTN_T}-step loop alone, "
                  f"forward + backward: {loop_ms:.2f} ms, "
                  f"{loop_ms / ms:.3f} of a step; "
                  f"{time.perf_counter() - t1:.1f} s")


def parity_nets():
    """(e)'s networks at the tests' cut sizes, every class of the slice in
    one of them: (name, layers, input type, x, y)."""
    from deeplearning4j_tpu_torch.nn import conf as C

    rs = np.random.RandomState(70)

    def onehot(n, k, t=None):
        shape = (n,) if t is None else (n, t)
        return np.eye(k, dtype=np.float32)[rs.randint(0, k, shape)]

    def randn(*shape):
        return rs.randn(*shape).astype(np.float32)

    pad = randn(4, 7, 4)
    pad[0, 5:] = 0.0
    pad[2, 4:] = 0.0
    return [
        ("1D", [C.ZeroPadding1DLayer(pad=(1, 1)),
                C.Convolution1D(n_out=8, kernel_size=3, activation="relu"),
                C.Subsampling1DLayer(kernel_size=2, stride=2),
                C.Upsampling1D(size=2), C.Cropping1D(crop=(1, 1)),
                C.LocallyConnected1D(n_out=6, kernel_size=3),
                C.GlobalPoolingLayer(pooling_type="avg"),
                C.OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
         C.InputType.recurrent(4, 16), randn(5, 16, 4), onehot(5, 3)),
        ("2D", [C.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                   activation="relu"),
                C.Deconvolution2D(n_out=3, kernel_size=(3, 3), stride=(2, 2),
                                  convolution_mode="Same",
                                  activation="tanh"),
                C.Cropping2D(crop=(1, 1, 0, 2)),
                C.LocallyConnected2D(n_out=4, kernel_size=(3, 3),
                                     stride=(2, 2), activation="relu"),
                C.SpaceToBatchLayer(block_size=2, padding=((1, 0), (0, 1))),
                C.DenseLayer(n_out=8, activation="relu"),
                C.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
         C.InputType.convolutional(9, 9, 2), randn(4, 9, 9, 2),
         onehot(16, 2)),
        ("3D", [C.ZeroPadding3DLayer(pad=(1, 1, 1)),
                C.Convolution3D(n_out=4, kernel_size=(3, 3, 3),
                                activation="relu"),
                C.Subsampling3DLayer(kernel_size=(2, 2, 2),
                                     stride=(2, 2, 2)),
                C.Upsampling3D(size=2),
                C.Cropping3D(crop=(1, 1, 1, 1, 1, 1)),
                C.Deconvolution3D(n_out=2, kernel_size=(3, 3, 3),
                                  stride=(2, 2, 2), padding=(1, 1, 1),
                                  activation="relu"),
                C.Subsampling3DLayer(pooling_type="avg",
                                     kernel_size=(2, 2, 2),
                                     stride=(1, 1, 1),
                                     convolution_mode="Same"),
                C.DenseLayer(n_out=8, activation="relu"),
                C.OutputLayer(n_out=2, activation="softmax", loss="mcxent")],
         C.InputType.convolutional3D(6, 5, 6, 2), randn(3, 6, 5, 6, 2),
         onehot(3, 2)),
        ("misc", [C.DenseLayer(n_out=6, activation="identity"),
                  C.PReLULayer(),
                  C.ElementWiseMultiplicationLayer(activation="tanh"),
                  C.LambdaLayer(fn=lambda t: torch.tanh(t) * 2.0),
                  C.RepeatVector(n=4), C.MaskLayer(),
                  C.PermuteLayer(dims=(2, 1)),
                  C.GlobalPoolingLayer(pooling_type="max"),
                  C.DenseLayer(n_out=12, activation="relu"),
                  C.ReshapeLayer(target_shape=(3, 4)),
                  C.Subsampling1DLayer(pooling_type="pnorm", kernel_size=2,
                                       stride=1),
                  C.GlobalPoolingLayer(pooling_type="sum"),
                  C.CenterLossOutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent", lambda_=0.5)],
         C.InputType.feedForward(5), randn(9, 5), onehot(9, 3)),
        ("CapsNet", [C.ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                        activation="relu"),
                     C.PrimaryCapsules(capsule_dimensions=4, channels=2,
                                       kernel_size=(5, 5), stride=(2, 2)),
                     C.CapsuleLayer(capsules=3, capsule_dimensions=6,
                                    routings=2),
                     C.CapsuleStrengthLayer(),
                     C.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent")],
         C.InputType.convolutional(20, 20, 1), randn(4, 20, 20, 1),
         onehot(4, 3)),
        ("GRU", [C.GRU(n_out=6, recurrent_bias=True),
                 C.RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent")],
         C.InputType.recurrent(4, 7), randn(3, 7, 4), onehot(3, 3, 7)),
        ("GravesBidirectionalLSTM",
         [C.GravesBidirectionalLSTM(n_out=6),
          C.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")],
         C.InputType.recurrent(4, 7), randn(3, 7, 4), onehot(3, 3, 7)),
        ("MaskZeroLayer", [C.MaskZeroLayer(layer=C.LSTM(n_out=6)),
                           C.RnnOutputLayer(n_out=3, activation="softmax",
                                            loss="mcxent")],
         C.InputType.recurrent(4, 7), pad, onehot(4, 3, 7)),
        ("attention", [C.SelfAttentionLayer(n_heads=2, head_size=4,
                                            activation="tanh"),
                       C.RecurrentAttentionLayer(n_out=6, n_heads=2),
                       C.LearnedSelfAttentionLayer(n_heads=2, head_size=3,
                                                   n_queries=2),
                       C.GlobalPoolingLayer(pooling_type="avg"),
                       C.OutputLayer(n_out=2, activation="softmax",
                                     loss="mcxent")],
         C.InputType.recurrent(8, 6), randn(5, 6, 8), onehot(5, 2)),
    ]


def layers_parity() -> None:
    """(e) Card against CPU at f32 (TF32 off) at the tests' cut sizes:
    every class of the slice, outputs, then three Adam steps' losses and
    parameters; then the builder's ``dropOut`` default, whose kept
    fraction is held to the distribution contract on both devices."""
    import copy

    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer, InputType,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.params import tree_map

    t1 = time.perf_counter()
    classes = set()
    for name, layers, it, x, y in parity_nets():
        cpu = layers_mln(copy.deepcopy(layers), it, Adam(1e-3),
                         device="cpu")
        card = layers_mln(layers, it, Adam(1e-3))
        card.params_list = tree_map(lambda t: t.to(DEVICE), cpu.params_list)
        classes |= {type(l).__name__ for l in cpu.conf.layers}
        classes |= {type(l.layer).__name__ for l in cpu.conf.layers
                    if hasattr(l, "mask_value")}
        out = close_card_cpu(f"layers (e) {name} output", card.output(x),
                             cpu.output(x), LAYERS_TOL[0])
        lc, lh = [], []
        for _ in range(PARITY_STEPS):
            for net, losses in ((card, lc), (cpu, lh)):
                net.fit(x, y)
                losses.append(net.score())
        rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lc, lh))
        check(all(math.isfinite(v) for v in lc + lh)
              and rel <= LAYERS_TOL[1],
              f"layers (e) {name}: losses card {lc}, CPU {lh}")
        perr = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            _leaves_of(card.params_list), _leaves_of(cpu.params_list)))
        check(perr <= LAYERS_TOL[2],
              f"layers (e) {name}: parameters differ by {perr:.3e}")
        say("layers", f"(e) {name}, card against CPU at f32: output "
                      f"{out:.2e}, {PARITY_STEPS} steps' losses {rel:.2e} "
                      f"relative, parameters {perr:.2e}")
    # the builder's dropOut(keep): every layer without a rate takes 1 - keep
    keep, n = 0.75, 256 * 512
    frac = {}
    for dev in ("cpu", DEVICE):
        b = (NeuralNetConfiguration.builder().seed(3).dropOut(keep).list()
             .layer(DenseLayer(n_out=8)).layer(OutputLayer(n_out=2))
             .setInputType(InputType.feedForward(512)).build())
        check(all(l.dropout == 1.0 - keep for l in b.layers),
              f"layers (e): dropOut({keep}) gave "
              f"{[l.dropout for l in b.layers]}")
        gen = torch.Generator(device=dev).manual_seed(4)
        out = b.layers[0]._maybe_dropout(torch.ones((256, 512), device=dev),
                                         True, gen)
        kept = out != 0
        frac[dev] = float(kept.float().mean())
        check(bool(torch.all(out[kept] == 1.0 / keep)),
              "layers (e): dropout's scale")
    sigma = math.sqrt(keep * (1 - keep) / n)
    for dev, f in frac.items():
        check(abs(f - keep) <= CONTRACT_SIGMAS * sigma,
              f"layers (e): dropOut({keep}) kept {f:.4f} on {dev}")
    say("layers", f"(e) dropOut({keep}): kept fraction card "
                  f"{frac[DEVICE]:.4f}, CPU {frac['cpu']:.4f} of {n} (within "
                  f"{CONTRACT_SIGMAS:g} sigma = "
                  f"{CONTRACT_SIGMAS * sigma:.4f} of {keep})")
    from deeplearning4j_tpu_torch.nn.conf import layers_extra

    missing = (set(layers_extra.__all__) | SLICE_ATTENTION) - classes - {
        "DepthwiseConvolution2D", "SpaceToDepthLayer"}
    check(not missing, f"layers (e): no network holds {sorted(missing)}")
    say("layers", f"(e) {len(classes)} layer classes through the card: "
                  f"{', '.join(sorted(classes))} (tolerances "
                  f"{LAYERS_TOL[0]:g} of max(1, |value|), "
                  f"{LAYERS_TOL[1]:g}, {LAYERS_TOL[2]:g}); "
                  f"{time.perf_counter() - t1:.1f} s")


# ------------------------------------------------------------- phase 23
#: (a)-(c): phase 9's cell over this many synthetic batches, 2 epochs,
#: preempted after FT_PREEMPT steps
FT_BATCHES, FT_EPOCHS, FT_PREEMPT = 12, 2, 9
#: (e): the wide seq2seq cell over this many batches, 2 epochs
FT_S2S_BATCHES, FT_S2S_PREEMPT = 6, 5
#: (d): the monitor's cadence and the monitored steps
HEALTH_FREQ, HEALTH_STEPS = 10, 20
#: (g): the watchdog's deadline and the injected hang, seconds
FT_DEADLINE_S, FT_HANG_S = 0.5, 1.0


class _LogCapture:
    """The port's log records of a block, kept from stderr (the guarded
    fit logs every recovery, the watchdog whole thread stacks)."""

    def __enter__(self):
        import logging

        self.records = []
        self.log = logging.getLogger("deeplearning4j_tpu_torch")
        self.handler = logging.Handler()
        self.handler.emit = self.records.append
        self.saved = (self.log.level, self.log.propagate)
        self.log.setLevel(logging.INFO)
        self.log.propagate = False
        self.log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)
        self.log.setLevel(self.saved[0])
        self.log.propagate = self.saved[1]

    def text(self) -> str:
        return "\n".join(r.getMessage() for r in self.records)


def ft_char_batches(dtype, n: int = FT_BATCHES) -> list:
    """``n`` synthetic batches of phase 9's shape on the card
    (char_batch, seeds 0 to n - 1)."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    return [DataSet(*char_batch(LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ, s, dtype,
                                DEVICE)) for s in range(n)]


def bit_equal(tag: str, a, b) -> None:
    la, lb = _leaves_of(a), _leaves_of(b)
    check(len(la) == len(lb) and len(la) > 0, f"{tag}: {len(la)} leaves "
                                              f"against {len(lb)}")
    bad = sum(not torch.equal(u, v) for u, v in zip(la, lb))
    check(bad == 0, f"{tag}: {bad} of {len(la)} tensors differ")


def ft_counter(name: str) -> float:
    from deeplearning4j_tpu_torch.profiler import telemetry

    return telemetry.MetricsRegistry.get_default().counter(name).total()


def phase_resilience(smi: str, rows) -> None:
    """Phase 23: the training infrastructure on the card, (a)-(h); the
    phase's B5 launches go to B5's rows."""
    from deeplearning4j_tpu_torch.profiler import telemetry

    t0 = time.perf_counter()
    total = [0, 0, 0, 0]          # fwd, bwd (other routes); fwd, bwd wide

    def add(launched, wide):
        for i in range(2):
            total[i] += launched[i] - wide[i]
            total[2 + i] += wide[i]

    telemetry.reset()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilience.")
    try:
        with _LogCapture() as logs:
            # (d) first: phase 15's network, as close to phase 15's count
            # as the process allows (other work between them moves a few
            # fill and copy kernels of the same step)
            resilience_health(smi)
            resilience_preempt_mln(smi, tmp, add)
            resilience_divergence(smi, tmp, add)
            resilience_loss_scale(smi, tmp, add)
            resilience_preempt_graph(smi, tmp, add)
            resilience_transfer(smi, add)
            resilience_watchdog(smi, tmp, add, logs)
        resilience_export(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key, n in zip(("B5", "B5 bwd", "B5 wide", "B5 bwd wide"), total):
        rows[key]["launches"] = rows[key].get("launches", 0) + n
    say("resilience", f"B5 launches in phase 23: forward {total[0]}, "
                      f"backward {total[1]}, wide route forward {total[2]}, "
                      f"backward {total[3]} (added to B5's rows); "
                      f"{time.perf_counter() - t0:.1f} s")


def resilience_preempt_mln(smi: str, tmp: str, add) -> None:
    """(a) preempted at step FT_PREEMPT, resumed in a fresh model (other
    initial weights), bit-equal to an uninterrupted run."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.profiler import chaos
    from deeplearning4j_tpu_torch.util import resilience
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance

    batches = ft_char_batches(torch.bfloat16)
    ck = os.path.join(tmp, "mln")
    policy = lambda: FaultTolerance(checkpoint_dir=ck, divergence_window=0)
    reset_lstm_counts()
    times = {}
    clean = textgen_net("bfloat16", 0, DEVICE)
    net = textgen_net("bfloat16", 0, DEVICE)
    fresh = textgen_net("bfloat16", 0, DEVICE, seed=1)
    for tag, model, kw in (("clean", clean, {}),
                           ("preempted", net, {"fault_tolerance": policy()}),
                           ("resumed", fresh, {"fault_tolerance": policy()})):
        scope = (chaos.installed(chaos.ChaosConfig(
            preempt_at_step=FT_PREEMPT)) if tag == "preempted"
            else contextlib.nullcontext())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with scope:
            model.fit(ListDataSetIterator(batches), epochs=FT_EPOCHS, **kw)
        torch.cuda.synchronize()
        times[tag] = time.perf_counter() - t1
        if tag == "preempted":
            check(net.getIterationCount() == FT_PREEMPT,
                  f"resilience (a): preempted at iteration "
                  f"{net.getIterationCount()}, not {FT_PREEMPT}")
            bundle = resilience.latest_valid_bundle(ck)
            check(bundle is not None, "resilience (a): no valid bundle")
            size = sum(os.path.getsize(os.path.join(bundle, f))
                       for f in os.listdir(bundle))
    steps = FT_BATCHES * FT_EPOCHS
    check((fresh.getIterationCount(), fresh.getEpochCount())
          == (steps, FT_EPOCHS),
          f"resilience (a): resumed run ended at iteration "
          f"{fresh.getIterationCount()}, epoch {fresh.getEpochCount()}")
    bit_equal("resilience (a) parameters", clean.params_list,
              fresh.params_list)
    bit_equal("resilience (a) Adam state", clean.opt_states, fresh.opt_states)
    check(resilience.latest_valid_bundle(ck) is None,
          "resilience (a): the finished run left its bundles")
    counts, cluster = lstm_counts(), lstm_cluster_counts()
    add(counts, lstm_wide_counts())
    want = 2 * (2 * steps)          # clean + preempted and resumed, 2 LSTMs
    check(counts == (want, want) == cluster,
          f"resilience (a): B5 launches {counts} (cluster route {cluster}), "
          f"not {want} = 2 LSTMs x 2 x {steps} steps")
    say("resilience", f"(a) char-LSTM (V {LSTM_VOCAB}, H {LSTM_HIDDEN}, bf16, "
                      f"batch {LSTM_BATCH} x {LSTM_SEQ}), {FT_BATCHES} "
                      f"batches x {FT_EPOCHS} epochs: uninterrupted "
                      f"{times['clean']:.3f} s; preempted at step "
                      f"{FT_PREEMPT} with a {size} B bundle in "
                      f"{times['preempted']:.3f} s; resumed "
                      f"{steps - FT_PREEMPT} steps in {times['resumed']:.3f} "
                      f"s; parameters and Adam state bit-equal; B5 launches "
                      f"{counts}, all on the cluster route; {smi}")


def resilience_divergence(smi: str, tmp: str, add) -> None:
    """(b) a NaN batch at ordinal 4 rolled back and skipped; the guard's
    cost (one read-back a step) in turns."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.profiler import chaos, telemetry
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance

    batches = ft_char_batches(torch.bfloat16)
    reset_lstm_counts()
    net = textgen_net("bfloat16", 0, DEVICE)
    r0 = (ft_counter(telemetry.FT_ROLLBACKS),
          ft_counter(telemetry.FT_SKIPPED_BATCHES))
    with chaos.installed(chaos.ChaosConfig(nan_steps=(4,))):
        net.fit(ListDataSetIterator(batches), epochs=1,
                fault_tolerance=FaultTolerance(
                    divergence_window=16, snapshot_every=2,
                    flight_dir=os.path.join(tmp, "incidents")))
    got = (ft_counter(telemetry.FT_ROLLBACKS) - r0[0],
           ft_counter(telemetry.FT_SKIPPED_BATCHES) - r0[1])
    check(got == (1, 1), f"resilience (b): rollbacks, skipped batches {got}")
    check(all(bool(torch.isfinite(t.float()).all())
              for t in _leaves_of(net.params_list)),
          "resilience (b): a parameter is not finite after the rollback")
    # the rollback rewinds the iteration count to the snapshot (step 4)
    check(net.getIterationCount() == FT_BATCHES - 1,
          f"resilience (b): iteration {net.getIterationCount()}")
    lines = [l for l in telemetry.MetricsRegistry.get_default()
             .to_prometheus().splitlines()
             if l.startswith(("dl4j_tpu_ft_", "dl4j_tpu_chaos_"))]
    say("resilience", f"(b) NaN batch at ordinal 4, snapshot_every 2: "
                      f"rolled back and skipped, iteration "
                      f"{net.getIterationCount()}, parameters finite; "
                      + "; ".join(lines))
    ms = {16: [], 0: []}
    for _ in range(3):
        for window in (16, 0):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            net.fit(ListDataSetIterator(batches), epochs=1,
                    fault_tolerance=FaultTolerance(divergence_window=window))
            torch.cuda.synchronize()
            ms[window].append((time.perf_counter() - t1) / FT_BATCHES * 1e3)
    add(lstm_counts(), lstm_wide_counts())
    say("resilience", f"(b) the guard's cost, ms a step over {FT_BATCHES} "
                      f"steps in turns: divergence_window=16 "
                      + " ".join(f"{v:.3f}" for v in ms[16])
                      + "; divergence_window=0 "
                      + " ".join(f"{v:.3f}" for v in ms[0])
                      + f" (min {min(ms[16]) / min(ms[0]):.3f}x); {smi}")


def resilience_loss_scale(smi: str, tmp: str, add) -> None:
    """(c) the cell under mixed_float16 with one batch that overflows f16:
    the loss-scale series in the registry, and no rollback."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.profiler import telemetry
    from deeplearning4j_tpu_torch.util import resilience
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = policy_conf(TextGenerationLSTM(
        vocab_size=LSTM_VOCAB, hidden=LSTM_HIDDEN, tbptt_length=0).conf(),
        "mixed_float16")
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    net.params_list = mln_params_from_numpy(
        textgen_params_numpy(LSTM_VOCAB, LSTM_HIDDEN, 0), device=DEVICE,
        dtype=net._dtype)
    batches = ft_char_batches(net._input_dtype, 4)
    x, y = batches[0].features, batches[0].labels
    batches.insert(2, DataSet(torch.full_like(x, float("inf")), y))
    reset_lstm_counts()
    r0 = ft_counter(telemetry.FT_ROLLBACKS)
    net.fit(ListDataSetIterator(batches), epochs=1,
            fault_tolerance=FaultTolerance(
                divergence_window=16, snapshot_every=1,
                flight_dir=os.path.join(tmp, "incidents")))
    add(lstm_counts(), lstm_wide_counts())
    check(ft_counter(telemetry.FT_ROLLBACKS) == r0,
          "resilience (c): a handled overflow was rolled back")
    text = telemetry.MetricsRegistry.get_default().to_prometheus()
    want = [f'{n}{{site="mln"}}' for n in (
        telemetry.LOSS_SCALE, telemetry.LOSS_SCALE_OVERFLOWS,
        telemetry.LOSS_SCALE_SKIPPED_STEPS, telemetry.PRECISION_CASTS)]
    lines = [l for l in text.splitlines() if l.split(" ")[0] in want]
    check(len(lines) == 4, f"resilience (c): loss-scale series {lines}")
    scale = float(net._loss_scale_state["scale"])
    peek = resilience._peek_loss_scale(net)
    check(peek == scale, f"resilience (c): _peek_loss_scale {peek} against "
                         f"the state's {scale}")
    skipped = int(net._loss_scale_state["skipped_steps"])
    check(skipped >= 1, "resilience (c): no step was skipped")
    say("resilience", f"(c) mixed_float16, {len(batches)} batches, one "
                      f"poisoned: no rollback; " + "; ".join(lines)
                      + f"; _peek_loss_scale {peek:g}")


def _profiled_kernels(tag: str, run) -> dict:
    """``{kernel name: launches}`` the profiler counts in ``run()``
    (empty when it saw no device time), from an idle card: no earlier
    step's kernels run into the window."""
    torch.cuda.synchronize()
    out = {}
    device_profile("resilience", tag, run, (), top=3, out=out)
    return {r[0]: r[3] for r in out.get("all", ())}


def _kernel_diff(a: dict, b: dict) -> str:
    """The kernels whose launches differ between two counts."""
    names = sorted(n for n in set(a) | set(b) if a.get(n) != b.get(n))
    return "; ".join(f"{n[:110]} {a.get(n, 0)} -> {b.get(n, 0)}"
                     for n in names[:6]) or "no kernel differs"


def _three_steps(net, step, adapter, snap, monitor=None) -> dict:
    """The parameters after 3 steps from ``snap`` (restored first),
    under ``monitor`` (None: unmonitored) and cuDNN's deterministic
    algorithms."""
    from deeplearning4j_tpu_torch.util import resilience

    torch.backends.cudnn.deterministic = True
    try:
        adapter.restore(snap)
        net.setHealthMonitor(monitor)
        for _ in range(3):
            step()
        return resilience._clone_tree(net.params_map)
    finally:
        torch.backends.cudnn.deterministic = False
        net.setHealthMonitor(None)


def resilience_health(smi: str) -> None:
    """(d) ResNet-50 of phase 15 under the health monitor: kernels of an
    unmonitored step against phase 15's, the monitor's cost in turns
    (without the FLOP count), then HEALTH_STEPS steps at HEALTH_FREQ with
    it (MFU), and the trajectory of 3 steps monitored, unmonitored, and
    unmonitored after the FLOP count, all equal."""
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.profiler import model_health, telemetry
    from deeplearning4j_tpu_torch.profiler.model_health import HealthMonitor
    from deeplearning4j_tpu_torch.util import resilience
    from deeplearning4j_tpu_torch.zoo import ResNet50

    B, HW = RESNET50_BATCH, RESNET50_HW
    model = PHASE15_KERNELS.pop("model", None)
    if model is not None:
        net, x, y = model
        conf = net.conf
    else:
        conf = ResNet50(num_classes=RESNET50_CLASSES, in_shape=(HW, HW, 3),
                        updater=Nesterovs(learning_rate=1e-1,
                                          momentum=0.9)).conf()
        conf.dtype = "bfloat16"
        net = ComputationGraph(conf, device=DEVICE).init()
        x, y = image_batch(B, HW, 3, RESNET50_CLASSES, seed=0)
        x = torch.from_numpy(x).to(DEVICE, torch.bfloat16)
        y = torch.from_numpy(y).to(DEVICE)
    step = lambda: net.fit(x, y)
    adapter = resilience._FitAdapter(net)
    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(WARMUP_STEPS):
            step()
        reset_bn_counts()
        ops = profiled_ops(step)
        bn_launched = bn_counts()
        n_bn = sum(isinstance(getattr(n.vertex, "layer", None),
                              BatchNormalization) for n in conf.nodes)
        ref_ops = PHASE15_KERNELS.get("ops", ops)
        check(sum(ops.values()) > 0 and ops == ref_ops
              and bn_launched == (n_bn,) * 3,
              f"resilience (d): an unmonitored step ran "
              f"{sum(ops.values())} operations and batch-norm kernels "
              f"{bn_launched}, phase 15's {sum(ref_ops.values())} and "
              f"{(n_bn,) * 3}: {_kernel_diff(ref_ops, ops)}")
        base = _profiled_kernels("(d) one unmonitored step", step)
        n_base = sum(base.values())
        ref = PHASE15_KERNELS.get("kernels", base)
        snap = adapter.snapshot()
        plain = _three_steps(net, step, adapter, snap)
        torch.backends.cudnn.benchmark = True
        # the monitor's cost, in turns (without the FLOP count)
        ms = {False: [], True: []}
        cost = HealthMonitor(frequency=HEALTH_FREQ, mfu=False)
        for _ in range(2):
            for mon in (False, True):
                net.setHealthMonitor(cost if mon else None)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(HEALTH_FREQ):
                    step()
                torch.cuda.synchronize()
                ms[mon].append((time.perf_counter() - t1) / HEALTH_FREQ * 1e3)
        net.setHealthMonitor(None)
        after_ops = profiled_ops(step)
        check(after_ops == ops,
              f"resilience (d): after monitoring an unmonitored step ran "
              f"{sum(after_ops.values())} operations, before "
              f"{sum(ops.values())}: {_kernel_diff(ops, after_ops)}")
        after = _profiled_kernels("(d) one unmonitored step after the "
                                  "monitor was detached", step)
        # the monitor as users run it: MFU from the counted FLOPs, from
        # the warm state (lr 0.1 on one batch runs away in ~100 steps)
        adapter.restore(snap)
        hm = HealthMonitor(frequency=HEALTH_FREQ)
        net.setHealthMonitor(hm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(HEALTH_STEPS):
            step()
        torch.cuda.synchronize()
        mon_s = (time.perf_counter() - t1) / HEALTH_STEPS
        net.setHealthMonitor(None)
        counted = _profiled_kernels("(d) one unmonitored step after the "
                                    "FLOP count", step)
    finally:
        torch.backends.cudnn.benchmark = False
    fetches, last = hm.fetches, hm.last
    check(fetches == HEALTH_STEPS // HEALTH_FREQ,
          f"resilience (d): {fetches} read-backs over {HEALTH_STEPS} "
          f"steps at frequency {HEALTH_FREQ}")
    check(last["nonfinite_first_layer"] == -1,
          f"resilience (d): first non-finite layer "
          f"{last['nonfinite_first_layer']}")
    gauges = telemetry.MetricsRegistry.get_default().gauge(
        telemetry.LAYER_GRAD_NORM).values()
    n_cg = sum(dict(k).get("site") == "cg" for k in gauges)
    check(n_cg == len(conf.nodes), f"resilience (d): {n_cg} grad-norm "
                                   f"gauges for {len(conf.nodes)} vertices")
    mfu = last.get("mfu")
    check(mfu is not None and 0 < mfu < 1, f"resilience (d): MFU {mfu}")
    flops = model_health.site_flops("cg_step")
    macs = 6 * graph_macs(conf) * B
    # the trajectory: unmonitored after the FLOP count, then monitored
    again = _three_steps(net, step, adapter, snap)
    bit_equal("resilience (d) 3 unmonitored steps after the FLOP count",
              again, plain)
    watched = _three_steps(net, step, adapter, snap,
                           HealthMonitor(frequency=1, mfu=False))
    bit_equal("resilience (d) 3 monitored steps", watched, plain)
    say("resilience", f"(d) ResNet-50, bf16, batch {B}, HealthMonitor("
                      f"frequency={HEALTH_FREQ}) over {HEALTH_STEPS} steps: "
                      f"{mon_s * 1e3:.2f} ms a step (the first under the "
                      f"FLOP counter), {fetches} read-backs, first "
                      f"non-finite layer -1, {n_cg} per-layer gauges each of "
                      f"grad norm, parameter norm and update ratio; FLOPs a "
                      f"step {flops:.6g} counted (FlopCounterMode + kernel "
                      f"launches; 6 x MACs x batch {macs:.6g}); dl4j_tpu_mfu "
                      f"{mfu:.4f} of {BF16_FLOPS / 1e12:g} TFLOP/s; {smi}")
    say("resilience", f"(d) ms a step in turns of {HEALTH_FREQ}: "
                      "unmonitored " + " ".join(f"{v:.2f}" for v in ms[False])
                      + "; monitored " + " ".join(f"{v:.2f}" for v in ms[True])
                      + f" (min {min(ms[True]) / min(ms[False]):.3f}x); "
                      f"an unmonitored step's operations {sum(ops.values())}, "
                      f"phase 15's and after monitoring the same; its "
                      f"kernels in the profiler's device records {n_base} "
                      f"(phase 15's {sum(ref.values())}: "
                      f"{_kernel_diff(ref, base)}), after monitoring "
                      f"{sum(after.values())}, after the FLOP count "
                      f"{sum(counted.values())} "
                      f"({_kernel_diff(base, counted)}); 3 steps monitored, "
                      f"unmonitored and unmonitored after the FLOP count "
                      f"bit-equal; {smi}")
    del net, x, y, snap, plain, again, watched, adapter
    torch.cuda.empty_cache()


def resilience_preempt_graph(smi: str, tmp: str, add) -> None:
    """(e) Seq2SeqLSTM at hidden 512 (the wide route), preempted and
    resumed bit-equal through the graph's guarded fit."""
    from deeplearning4j_tpu_torch.datasets import (ListMultiDataSetIterator,
                                                   MultiDataSet)
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.profiler import chaos
    from deeplearning4j_tpu_torch.util import resilience
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance

    class StatefulList(ListMultiDataSetIterator):
        """Its position as state: a mid-epoch resume takes the next
        batch."""

        def get_state(self):
            return {"i": self._i}

        def set_state(self, state):
            self._i = int(state["i"])

    batches = []
    for s in range(FT_S2S_BATCHES):
        enc, dec, out = (torch.from_numpy(a).to(DEVICE, torch.bfloat16)
                         for a in reversal_batch(S2S_BATCH, S2S_T,
                                                 S2S_FEATURES, seed=s))
        batches.append(MultiDataSet([enc, dec], [out]))
    conf = seq2seq_conf(S2S_WIDE_HIDDEN, Adam(5e-3))
    conf.dtype = "bfloat16"
    ck = os.path.join(tmp, "cg")
    policy = lambda: FaultTolerance(checkpoint_dir=ck, divergence_window=0)
    reset_lstm_counts()
    clean = ComputationGraph(conf, device=DEVICE).init()
    clean.fit(StatefulList(batches), epochs=FT_EPOCHS)
    net = ComputationGraph(conf, device=DEVICE).init()
    with chaos.installed(chaos.ChaosConfig(preempt_at_step=FT_S2S_PREEMPT)):
        net.fit(StatefulList(batches), epochs=FT_EPOCHS,
                fault_tolerance=policy())
    check(net.getIterationCount() == FT_S2S_PREEMPT,
          f"resilience (e): preempted at {net.getIterationCount()}")
    check(resilience.latest_valid_bundle(ck) is not None,
          "resilience (e): no valid bundle")
    fresh = ComputationGraph(conf, device=DEVICE).init()
    fresh.fit(StatefulList(batches), epochs=FT_EPOCHS,
              fault_tolerance=policy())
    steps = FT_S2S_BATCHES * FT_EPOCHS
    check(fresh.getIterationCount() == steps,
          f"resilience (e): resumed run ended at {fresh.getIterationCount()}")
    bit_equal("resilience (e) parameters", clean.params_map, fresh.params_map)
    bit_equal("resilience (e) Adam state", clean.opt_states, fresh.opt_states)
    counts, wide = lstm_counts(), lstm_wide_counts()
    add(counts, wide)
    want = 2 * (2 * steps)
    check(counts == wide == (want, want),
          f"resilience (e): B5 launches {counts} (wide route {wide}), not "
          f"{want}")
    say("resilience", f"(e) Seq2SeqLSTM hidden {S2S_WIDE_HIDDEN}, bf16, "
                      f"batch {S2S_BATCH}, {FT_S2S_BATCHES} batches x "
                      f"{FT_EPOCHS} epochs: preempted at step "
                      f"{FT_S2S_PREEMPT}, resumed in a fresh graph, "
                      f"parameters and Adam state bit-equal; B5 launches "
                      f"{counts}, all on the wide route; {smi}")


def resilience_transfer(smi: str, add) -> None:
    """(f) transfer retries and quarantine of the device prefetcher."""
    from deeplearning4j_tpu_torch.datasets import (DataSet,
                                                   DevicePrefetchIterator,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.profiler import chaos, telemetry
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance

    host = [DataSet(d.features.cpu().numpy(), d.labels.cpu().numpy())
            for d in ft_char_batches(torch.float32, 4)]
    net = textgen_net("bfloat16", 0, DEVICE)
    reset_lstm_counts()
    r0 = (ft_counter(telemetry.TRANSFER_RETRIES),
          ft_counter(telemetry.TRANSFER_QUARANTINES))
    it = DevicePrefetchIterator(ListDataSetIterator(host), depth=2,
                                device=DEVICE, dtype=torch.bfloat16)
    with chaos.installed(chaos.ChaosConfig(transfer_error_rate=0.3,
                                           seed=3)), it:
        net.fit(it, epochs=2, fault_tolerance=FaultTolerance(
            divergence_window=0, transfer_retries=8,
            transfer_backoff=0.002))
        posture = (it._transfer_retries, it._quarantine)
    retries = ft_counter(telemetry.TRANSFER_RETRIES) - r0[0]
    check(net.getIterationCount() == 2 * len(host) and retries > 0
          and ft_counter(telemetry.TRANSFER_QUARANTINES) == r0[1],
          f"resilience (f): {net.getIterationCount()} steps, {retries} "
          f"retries")
    check(posture == (0, False), f"resilience (f): the policy's retry "
                                 f"posture stayed on the prefetcher "
                                 f"{posture}")
    it0 = net.getIterationCount()
    poisoned = DevicePrefetchIterator(
        ListDataSetIterator(host), depth=2, device=DEVICE,
        dtype=torch.bfloat16, transfer_retries=1, transfer_backoff=0.001,
        quarantine=True)
    with chaos.installed(chaos.ChaosConfig(transfer_error_rate=1.0)), \
            poisoned:
        net.fit(poisoned, epochs=1, fault_tolerance=FaultTolerance(
            divergence_window=0, transfer_retries=0))
    quarantined = ft_counter(telemetry.TRANSFER_QUARANTINES) - r0[1]
    check(net.getIterationCount() == it0 and quarantined == len(host),
          f"resilience (f): {quarantined} batches quarantined, "
          f"{net.getIterationCount() - it0} steps on a poisoned stream")
    add(lstm_counts(), lstm_wide_counts())
    check(not prefetch_threads(), f"resilience (f): prefetch threads left "
                                  f"{prefetch_threads()}")
    say("resilience", f"(f) DevicePrefetchIterator depth 2 at phase 9's "
                      f"batch, chaos failure rate 0.3: {2 * len(host)} steps, "
                      f"{retries:g} retries, none quarantined; rate 1.0 with "
                      f"1 retry: {quarantined:g} of {len(host)} batches "
                      f"quarantined, no step, the fit went on")


def resilience_watchdog(smi: str, tmp: str, add, logs) -> None:
    """(g) a chaos hang of FT_HANG_S past a FT_DEADLINE_S deadline."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.profiler import (chaos, flight_recorder,
                                                   telemetry)
    from deeplearning4j_tpu_torch.util.resilience import FaultTolerance

    batches = ft_char_batches(torch.bfloat16, 3)
    net = textgen_net("bfloat16", 0, DEVICE)
    net.fit(batches[0].features, batches[0].labels)      # warm
    reset_lstm_counts()
    s0 = ft_counter(telemetry.WATCHDOG_STALLS)
    n_logs = len(logs.records)
    dumps = os.path.join(tmp, "watchdog")
    with chaos.installed(chaos.ChaosConfig(hang_step=2,
                                           hang_seconds=FT_HANG_S)):
        net.fit(ListDataSetIterator(batches), epochs=1,
                fault_tolerance=FaultTolerance(
                    divergence_window=0, step_deadline=FT_DEADLINE_S,
                    flight_dir=dumps))
    torch.cuda.synchronize()
    add(lstm_counts(), lstm_wide_counts())
    stalls = ft_counter(telemetry.WATCHDOG_STALLS) - s0
    fired = [r.getMessage() for r in logs.records[n_logs:]
             if r.getMessage().startswith("WATCHDOG")]
    check(stalls == 1 and len(fired) == 1,
          f"resilience (g): {stalls} stalls counted, {len(fired)} logged")
    check("Thread stacks" in fired[0] and "MainThread" in fired[0],
          "resilience (g): the stall's log holds no stack dump")
    deadline = time.monotonic() + 5
    while not flight_recorder.list_dumps(dumps) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    dump = flight_recorder.list_dumps(dumps)
    check(len(dump) == 1 and flight_recorder.load_dump(dump[0])["valid"],
          f"resilience (g): incident dumps {dump}")
    say("resilience", f"(g) a {FT_HANG_S:g} s hang at step 2 past a "
                      f"{FT_DEADLINE_S:g} s step_deadline: {stalls:g} stall, "
                      f"a {len(fired[0])}-character stack dump, one valid "
                      f"incident dump; the fit finished "
                      f"{net.getIterationCount() - 1} steps")


def resilience_export(tmp: str) -> None:
    """(h) the Chrome trace to a temp directory, parsed back."""
    from deeplearning4j_tpu_torch.profiler import telemetry

    path = telemetry.export_chrome_trace(os.path.join(tmp, "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    names = {e["name"] for e in events}
    check({"etl_wait", "device_step"} <= names,
          f"resilience (h): trace span names {sorted(names)[:10]}")
    check(all(e["ph"] == "X" and e["dur"] >= 0 for e in events),
          "resilience (h): a malformed trace event")
    h = telemetry.MetricsRegistry.get_default().histogram(
        telemetry.STEP_PHASE_SECONDS)
    say("resilience", f"(h) Chrome trace: {len(events)} events, "
                      f"{os.path.getsize(path)} B, parsed; step phases "
                      f"etl_wait {h.count(phase='etl_wait')}, device_step "
                      f"{h.count(phase='device_step')} spans, device_step "
                      f"p50 {h.percentiles(phase='device_step')['p50'] * 1e3:.3f}"
                      f" ms (host dispatch)")


# ------------------------------------------------- phase 24: SameDiff by name
#: (a): BASELINE.md's BERT row, batch 128 x 128, rows padded at random
#: lengths in [64, 128], 20 masked positions a row, masked_capacity 20
SD_BATCH, SD_SEQ, SD_MIN_LEN, SD_MASKED, SD_CAPACITY = 128, 128, 64, 20, 20
SD_FIT_STEPS = 5
#: the graph's forward loss against TransformerEncoder's, relative; the
#: per-parameter cosine of their gradients
SD_LOSS_RTOL, SD_GRAD_COS = 1e-4, 0.999
#: (b) card against CPU; (d) the sweep's card against CPU, relative to
#: max(1, |CPU|)
SD_CF_TOL, SD_SWEEP_TOL = 1e-5, 1e-4
SD_FEEDS = ("ids", "type_ids", "key_mask", "labels", "mask_pos")


def bert_mlm_graph(sd, tree, cfg, seq: int, capacity: int):
    """BERT MLM as a SameDiff graph through the public API only
    (``placeholder``, ``var``, ``constant``, ``sd.nn`` / ``sd.math``,
    ``invoke_op``), op by op as ``TransformerEncoder.encode`` with type
    ids and a key mask, then ``mlm_head_loss``: the token, position and
    type embeddings and ``emb_ln``; post-LN blocks with the tanh GELU and
    attention by name (``flash_attention``, key mask); ``masked_capacity``
    as ``top_k`` + ``take_along_axis``; the tied head,
    ``reduce_logsumexp`` and the masked mean. Works on either package's
    SameDiff (the API is the same); variables are named by their path in
    ``tree`` (``layers.3.wqkv``). Returns the loss variable."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    ph = {n: sd.placeholder(n, shape=(None, seq), dtype=dt) for n, dt in
          zip(SD_FEEDS, ("int32", "int32", "float32", "int32", "float32"))}

    def ln(x, p, name):
        g = sd.var(f"{name}.gamma", p["gamma"])
        b = sd.var(f"{name}.beta", p["beta"])
        return sd.nn.layer_norm(x, g, b, eps=cfg.eps)

    tok = sd.var("tok_emb", tree["tok_emb"])
    pos = sd.var("pos_emb", tree["pos_emb"])
    typ = sd.var("type_emb", tree["type_emb"])
    where = sd.constant("positions", np.arange(seq, dtype=np.int32))
    x = (sd.nn.embedding_lookup(tok, ph["ids"])
         + sd.math.gather(pos, where, axis=0)
         + sd.nn.embedding_lookup(typ, ph["type_ids"]))
    x = ln(x, tree["emb_ln"], "emb_ln")
    for i, lp in enumerate(tree["layers"]):
        def w(k, lp=lp, i=i):
            return sd.var(f"layers.{i}.{k}", lp[k])

        qkv = sd.nn.xw_plus_b(x, w("wqkv"), w("bqkv"))
        q, k, v = sd.invoke_op("split", [qkv], n_out=3, name=f"qkv{i}",
                               num_splits=3, axis=-1)
        q, k, v = (sd.nn.permute(t.reshape(-1, seq, h, hd),
                                 axes=[0, 2, 1, 3]) for t in (q, k, v))
        ctx = sd.nn.flash_attention(q, k, v, ph["key_mask"], causal=False,
                                    name=f"attention{i}")
        ctx = sd.nn.permute(ctx, axes=[0, 2, 1, 3]).reshape(-1, seq, d)
        x = ln(x + sd.nn.xw_plus_b(ctx, w("wo"), w("bo")), lp["ln1"],
               f"layers.{i}.ln1")
        hmid = sd.nn.gelu(sd.nn.xw_plus_b(x, w("w1"), w("b1")))
        x = ln(x + sd.nn.xw_plus_b(hmid, w("w2"), w("b2")), lp["ln2"],
               f"layers.{i}.ln2")
    _, idx = sd.invoke_op("top_k", [ph["mask_pos"]], n_out=2,
                          name="capacity", k=capacity)
    hid = sd.nn.take_along_axis(x, sd.math.expand_dims(idx, axis=2), axis=1)
    lab = sd.nn.take_along_axis(ph["labels"], idx, axis=1)
    mpos = sd.nn.take_along_axis(ph["mask_pos"], idx, axis=1)
    logits = sd.math.matmul(hid, tok, transpose_b=True) \
        + sd.var("mlm_bias", tree["mlm_bias"])
    lse = sd.math.reduce_logsumexp(logits, dimensions=[-1])
    picked = sd.nn.take_along_axis(logits, sd.math.expand_dims(lab, axis=2),
                                   axis=2)
    per_tok = sd.math.squeeze(picked, axis=2) - lse
    denom = sd.math.maximum(mpos.sum(), 1.0)
    loss = -(per_tok * mpos).sum() / denom
    loss.rename("loss")
    sd.setLossVariables(loss)
    return loss


def sd_mlm_batch(vocab: int, batch: int, seq: int, masked: int,
                 min_len: int, seed: int) -> dict:
    """A padded MLM batch from a numpy seed: row lengths in [min_len,
    seq], ids and labels random below ``vocab`` (ids 0 past a row's end),
    two segments a row (type ids 0 then 1), ``masked`` masked positions
    inside each row."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, seq + 1, batch)
    ar = np.arange(seq)[None, :]
    real = ar < lens[:, None]
    cut = rng.integers(1, min_len, batch)
    ids = np.where(real, rng.integers(1, vocab, (batch, seq)), 0)
    mask_pos = np.zeros((batch, seq), np.float32)
    for r in range(batch):
        mask_pos[r, rng.choice(lens[r], masked, replace=False)] = 1.0
    return {"ids": ids.astype(np.int32),
            "type_ids": ((ar >= cut[:, None]) & real).astype(np.int32),
            "key_mask": real.astype(np.float32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "mask_pos": mask_pos}


def _cosine(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else float(a.equal(b))


def _leaf_names(tree, prefix="") -> dict:
    """``{"layers.3.wqkv": tensor}`` over a parameter tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_names(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_names(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


class _StepClock:
    """A fit listener: the host's clock at each iteration's end (``fit``
    reads each step's loss back, so the card is done by then)."""

    def __init__(self):
        self.stamps = [time.perf_counter()]

    def iterationDone(self, sd, iteration, epoch):
        self.stamps.append(time.perf_counter())

    def ms(self) -> list:
        return [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]


def phase_samediff(smi: str, rows) -> None:
    """Phase 24: SameDiff by name on the card, (a)-(d); (a)'s B1 launches
    go to B1's rows."""
    t0 = time.perf_counter()
    fwd, bwd = samediff_bert(smi)
    parts = [time.perf_counter()]
    samediff_control_flow(smi)
    parts.append(time.perf_counter())
    samediff_kernels_by_name()
    parts.append(time.perf_counter())
    samediff_sweep()
    parts.append(time.perf_counter())
    say("samediff", "seconds by part: (a) {:.1f}, (b) {:.1f}, (c) {:.1f}, "
                    "(d) {:.1f}".format(parts[0] - t0, *(
                        b - a for a, b in zip(parts, parts[1:]))))
    rows["flash_attention_fwd"]["launches"] = \
        rows["flash_attention_fwd"].get("launches", 0) + fwd
    rows["flash_attention_bwd"]["launches"] = \
        rows["flash_attention_bwd"].get("launches", 0) + bwd
    say("samediff", f"B1 launches in phase 24: forward {fwd}, backward "
                    f"{bwd} (added to B1's rows); "
                    f"{time.perf_counter() - t0:.1f} s")


def samediff_bert(smi: str) -> tuple:
    """(a) BERT-base MLM as a SameDiff graph, trained by ``fit``."""
    import dataclasses

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, bert_base, init_params_numpy)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.params import (FlatParams,
                                                 params_from_jax)

    cfg = dataclasses.replace(bert_base(), compute_dtype="float32",
                              dropout=0.0)
    tree = init_params_numpy(cfg, seed=0)
    batch = sd_mlm_batch(cfg.vocab_size, SD_BATCH, SD_SEQ, SD_MASKED,
                         SD_MIN_LEN, seed=24)
    t0 = time.perf_counter()
    sd = SameDiff.create(device=DEVICE)
    loss = bert_mlm_graph(sd, tree, cfg, SD_SEQ, SD_CAPACITY)
    n_par = sum(int(a.numel()) for n, a in sd._arrays.items()
                if n in sd.trainable_names())
    check(n_par == BERT_BASE_PARAMS, f"the graph holds {n_par} parameters")
    say("samediff", f"(a) BERT-base MLM graph: {len(sd._ops)} ops, "
                    f"{len(sd.trainable_names())} variables, {n_par} "
                    f"parameters, f32, dropout off; batch {SD_BATCH} x "
                    f"{SD_SEQ}, lengths {SD_MIN_LEN}-{SD_SEQ}, {SD_MASKED} "
                    f"masked a row; built in "
                    f"{time.perf_counter() - t0:.1f} s")

    # the reference: TransformerEncoder(f32, flash) on the same tree
    enc = TransformerEncoder(cfg, attn_impl="flash")
    params = params_from_jax(tree, device=DEVICE)
    leaves = _leaf_names(params)
    for t in leaves.values():
        t.requires_grad_(True)
    dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    hidden = enc.encode(params, dev["ids"], type_ids=dev["type_ids"],
                        mask=dev["key_mask"])
    want = enc.mlm_head_loss(params, hidden, dev["labels"], dev["mask_pos"],
                             SD_CAPACITY)
    want_g = dict(zip(leaves, torch.autograd.grad(want,
                                                  list(leaves.values()))))
    want = float(want.detach())
    del hidden, params

    f0, b0 = fa.fwd_launches, fa.bwd_launches
    got = float(sd.outputSingle(batch, loss))
    f1 = fa.fwd_launches
    rel = abs(got - want) / abs(want)
    say("samediff", f"(a) forward loss: graph {got:.7f}, TransformerEncoder"
                    f" {want:.7f}, relative {rel:.3e} (tolerance "
                    f"{SD_LOSS_RTOL:g}); ln(vocab) "
                    f"{math.log(cfg.vocab_size):.4f}")
    check(rel <= SD_LOSS_RTOL, f"graph loss {got} against {want}")
    check(f1 - f0 == cfg.n_layers and fa.bwd_launches == b0,
          f"forward launched B1 {f1 - f0} / {fa.bwd_launches - b0} times")
    grads = sd.calculateGradients(batch)
    check(fa.fwd_launches - f1 == cfg.n_layers
          and fa.bwd_launches - b0 == cfg.n_layers,
          f"gradients launched B1 fwd {fa.fwd_launches - f1}, bwd "
          f"{fa.bwd_launches - b0}")
    cos = {n: _cosine(grads[n], want_g[n]) for n in want_g}
    worst = min(cos, key=cos.get)
    say("samediff", f"(a) gradients of {len(cos)} parameters: cosine >= "
                    f"{cos[worst]:.6f} (worst {worst}; tolerance "
                    f"{SD_GRAD_COS})")
    check(cos[worst] >= SD_GRAD_COS, f"gradient cosine {cos[worst]} at "
                                     f"{worst}")
    del grads, want_g, leaves

    say("samediff", f"(a) reference, forward and gradients checked at "
                    f"{time.perf_counter() - t0:.1f} s")
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-4), data_set_feature_mapping=list(SD_FEEDS)))
    ds = DataSet([batch[k] for k in SD_FEEDS], None)
    clock = _StepClock()
    reset_train_counts()            # the main path's counts start at 0
    hist = sd.fit([ds] * SD_FIT_STEPS, listeners=[clock])
    fwd, bwd = fa.fwd_launches, fa.bwd_launches
    losses = hist.lossCurve()
    check(len(losses) == SD_FIT_STEPS
          and all(math.isfinite(x) for x in losses), f"losses {losses}")
    check((fwd, bwd) == (cfg.n_layers * SD_FIT_STEPS,
                         cfg.n_layers * SD_FIT_STEPS),
          f"fit launched B1 fwd {fwd}, bwd {bwd} over {SD_FIT_STEPS} steps")
    step_ms = sorted(clock.ms()[1:])[len(clock.ms()[1:]) // 2]
    say("samediff", f"(a) fit, {SD_FIT_STEPS} steps of Adam(1e-4): losses "
                    + " ".join(f"{x:.5f}" for x in losses)
                    + f"; step ms {' '.join(f'{x:.2f}' for x in clock.ms())}"
                    f" (median of 2-{SD_FIT_STEPS} {step_ms:.2f} ms, "
                    f"{SD_BATCH * SD_SEQ / step_ms * 1e3:.1f} tokens/s); B1 "
                    f"fwd {fwd}, bwd {bwd}; {smi}")

    def one_step():
        sd.fit(ds)

    busy = device_profile("samediff", "one more fit step", one_step,
                          ("flash_",))
    if busy:
        say("samediff", f"(a) device busy {busy:.2f} ms in one fit step "
                        f"against {step_ms:.2f} ms a step: idle about "
                        f"{1 - busy / step_ms:.3f}")

    # save with the updater state, load on the card, one more step each
    tmp = tempfile.mkdtemp(prefix="chip_smoke_samediff.")
    try:
        path = os.path.join(tmp, "bert.sdz")
        t1 = time.perf_counter()
        sd.save(path)
        loaded = SameDiff.load(path, device=DEVICE)
        say("samediff", f"(a) save + load: {os.path.getsize(path)} B in "
                        f"{time.perf_counter() - t1:.2f} s")
        a = sd.fit(ds).lossCurve()[0]
        b = loaded.fit(ds).lossCurve()[0]
        say("samediff", f"(a) the step after the save: in memory {a!r}, "
                        f"loaded {b!r}")
        check(a == b, f"loaded step loss {b!r} != in-memory {a!r}")
        check(loaded._iteration == sd._iteration,
              f"iterations {loaded._iteration} / {sd._iteration}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the counts of the whole run since the reset: the fit, the profiled
    # step and the two steps after the save, each step 12 + 12
    fwd, bwd = fa.fwd_launches, fa.bwd_launches
    steps = SD_FIT_STEPS + 3
    check((fwd, bwd) == (cfg.n_layers * steps, cfg.n_layers * steps),
          f"{steps} steps launched B1 fwd {fwd}, bwd {bwd}")
    del sd, loaded
    torch.cuda.empty_cache()

    # the yardstick: TransformerEncoder's own f32 flash step (no key mask,
    # no type ids; B2 for the update)
    flat = FlatParams(params_from_jax(tree, device=DEVICE))
    upd = Adam(1e-4)
    opt = upd.init_state(flat.master)
    step = enc.make_train_step(upd, masked_capacity=SD_CAPACITY)
    args = (dev["ids"].long(), dev["labels"].long(), dev["mask_pos"])
    step(flat, opt, 0, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(1, SD_FIT_STEPS + 1):
        step(flat, opt, i, *args)
    torch.cuda.synchronize()
    y_ms = (time.perf_counter() - t1) * 1e3 / SD_FIT_STEPS
    busy = device_profile("samediff", "one TransformerEncoder step",
                          lambda: step(flat, opt, 99, *args), ("flash_",))
    say("samediff", f"(a) yardstick TransformerEncoder f32 flash step: "
                    f"{y_ms:.2f} ms ({SD_BATCH * SD_SEQ / y_ms * 1e3:.1f} "
                    f"tokens/s)" + (f", idle about {1 - busy / y_ms:.3f}"
                                    if busy else "") + f"; {smi}")
    del flat, opt
    torch.cuda.empty_cache()
    return fwd, bwd


def _cf_graphs(device):
    """(b)'s three graphs on ``device``: a counted loop carrying float
    state under a training config, a dynamic loop, and a branch and a
    case."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.tools.op_cases import subgraph

    rs = np.random.default_rng(7)
    counted = SameDiff.create(device=device)
    x = counted.placeholder("x", shape=(None, 16))
    y = counted.placeholder("y", shape=(None, 16))
    w = counted.var("w", (rs.normal(size=(16, 16)) * 0.3).astype(np.float32))
    w2 = counted.var("w2", (rs.normal(size=(16, 16)) * 0.3)
                     .astype(np.float32))
    i0 = counted.constant("i0", np.int32(0))
    _, h, _ = counted.whileLoop(
        [i0, x @ w, w2],
        cond_fn=lambda s, i, h, m: s._op(
            "lt", [i.name, s.constant("n", np.int32(4)).name]),
        body_fn=lambda s, i, h, m: [
            s._op("add", [i.name, s.constant("one", np.int32(1)).name]),
            s.nn.tanh(h @ m), m])
    counted.setLossVariables(counted.math.square(h - y).mean())
    counted.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-2), data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"]))

    dynamic = SameDiff.create(device=device)
    a0 = dynamic.placeholder("a0", shape=(2,))
    wd = dynamic.var("w", np.asarray([1.0, 1.0], np.float32))
    (out,) = (dynamic.whileLoop(
        [dynamic._op("mul", [a0.name, wd.name])],
        cond_fn=lambda s, a: s._op(
            "lt", [s._op("reduce_sum", [a.name]).name,
                   s.constant("b", np.float32(40.0)).name]),
        body_fn=lambda s, a: [s._op(
            "mul", [a.name, s.constant("two", np.float32(2.0)).name])]),)
    dynamic.setLossVariables(dynamic._op("reduce_sum", [out.name]))
    dynamic.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-2), data_set_feature_mapping=["a0"]))

    branch = SameDiff.create(device=device)
    xb = branch.placeholder("x", shape=(None, 16))
    p = branch.placeholder("p", shape=())
    k = branch.placeholder("k", shape=(), dtype="int32")
    wb = branch.var("w", (rs.normal(size=(16, 16)) * 0.3).astype(np.float32))
    branch.ifCond(p, [xb, wb], lambda s, a, m: s.nn.relu(a @ m),
                  lambda s, a, m: s.nn.sigmoid(a @ m), name="if")
    branch.invoke_op("case_graph", [k, xb], name="case", branches=[
        subgraph(lambda s, a: a * 2.0, 1),
        subgraph(lambda s, a: s.nn.tanh(a), 1),
        subgraph(lambda s, a: a - 1.0, 1)])
    return counted, dynamic, branch


def samediff_control_flow(smi: str) -> None:
    """(b) the three control-flow graphs on the card against the CPU, and
    the host's cost per loop iteration and per branch."""
    from deeplearning4j_tpu_torch.autodiff import control_flow as cf
    from deeplearning4j_tpu_torch.datasets import DataSet

    rs = np.random.default_rng(8)
    x = rs.normal(size=(64, 16)).astype(np.float32)
    y = rs.normal(size=(64, 16)).astype(np.float32)
    card, cpu = _cf_graphs(DEVICE), _cf_graphs("cpu")
    check(next(n for n in card[0]._ops if n.op_name == "while_loop")
          .attrs["max_trip_count"] == 4, "the counted loop's trip count")
    ds = DataSet(x, y)
    lc = card[0].fit([ds] * 3).lossCurve()
    lp = cpu[0].fit([ds] * 3).lossCurve()
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lc, lp))
    perr = max(float((card[0]._arrays[n].cpu() - cpu[0]._arrays[n]).abs()
                     .max()) for n in ("w", "w2"))
    say("samediff", f"(b) counted loop (4 trips, float state), 3 fit steps:"
                    f" card {' '.join(f'{v:.6f}' for v in lc)}, CPU "
                    f"{' '.join(f'{v:.6f}' for v in lp)}; loss err "
                    f"{err:.2e}, parameters {perr:.2e} (tolerance "
                    f"{SD_CF_TOL:g})")
    check(err <= SD_CF_TOL and perr <= SD_CF_TOL, "counted loop card/CPU")
    for g in (card[1], cpu[1]):
        try:
            g.fit(DataSet(np.ones(2, np.float32), None))
        except ValueError as e:
            check("inference-only" in str(e), f"dynamic loop: {e}")
        else:
            check(False, "fit through a dynamic loop did not raise")
    dyn = card[1].outputSingle({"a0": np.ones(2, np.float32)}, "whileLoop")
    check(dyn.device.type == "cuda" and dyn.tolist() == [32.0, 32.0],
          f"dynamic loop forward {dyn}")
    say("samediff", "(b) dynamic loop: forward [32, 32] on the card; fit "
                    "raises JAX's documented error on the card and CPU")
    for pred in (True, False):
        for idx in (0, 1, 5, -1):
            feeds = {"x": x, "p": np.asarray(pred), "k": np.int32(idx)}
            got = card[2].output(feeds, ["if", "case"])
            want = cpu[2].output(feeds, ["if", "case"])
            for n in ("if", "case"):
                e = float((got[n].cpu() - want[n]).abs().max())
                check(got[n].device.type == "cuda" and e <= SD_CF_TOL,
                      f"{n} pred {pred} index {idx}: {e:.2e}")
    say("samediff", f"(b) ifCond and case_graph (indices 0, 1, 5, -1) equal "
                    f"the CPU's within {SD_CF_TOL:g}")

    # the host's cost: a 200-trip loop of one add, and a branch of one op
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    long_loop = SameDiff.create(device=DEVICE)
    i0 = long_loop.placeholder("i0", shape=())
    long_loop.whileLoop([i0], cond_fn=lambda s, i: i < 200.0,
                        body_fn=lambda s, i: [i + 1.0], name="loop")
    feeds = {"i0": np.float32(0.0)}
    long_loop.output(feeds, ["loop"])
    torch.cuda.synchronize()
    r0, t0 = cf.host_reads, time.perf_counter()
    for _ in range(5):
        long_loop.output(feeds, ["loop"])
    loop_ms = (time.perf_counter() - t0) * 1e3 / 5
    reads = (cf.host_reads - r0) / 5
    feeds = {"x": x, "p": np.asarray(True), "k": np.int32(0)}
    card[2].output(feeds, ["if"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        card[2].output(feeds, ["if"])
    branch_ms = (time.perf_counter() - t0) * 1e3 / 50
    say("samediff", f"(b) host cost: {loop_ms / reads:.4f} ms per loop "
                    f"iteration ({reads:.0f} condition reads a 200-trip "
                    f"loop, {loop_ms:.2f} ms), {branch_ms:.4f} ms per ifCond "
                    f"output (one predicate read, one matmul + relu); "
                    f"{smi}")


def samediff_kernels_by_name() -> None:
    """(c) the three kernel ops by name, each once on the card against
    its plain version; each launch counter rises by one."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.ops.registry import get_op
    from deeplearning4j_tpu_torch.tools import attention_probe as ap

    q, k, v, m = flash_case(4, SD_SEQ, torch.float32, "padded", seed=24)
    f0 = fa.fwd_launches
    got = get_op("flash_attention")(q, k, v, m, impl="pallas")
    err = float((got - flash_plain(q, k, v, m, False)).abs().max())
    check(fa.fwd_launches == f0 + 1 and err <= 1e-5,
          f"flash_attention by name: launches {fa.fwd_launches - f0}, "
          f"err {err:.2e}")

    upd = Adam(3e-4)
    master, mm, vv, grad = adam_case(BERT_BASE_PARAMS, 0, seed=24)
    # the op's own global norm, so that both take the same scalars
    norm = torch.sqrt(torch.sum(grad ** 2))
    sc = fu.adam_update_scalars(upd, 300, clip_norm=0.5, grad_norm=norm)
    want = fu.adam_update_reference(master, mm, vv, grad, sc[0], sc[1],
                                    upd.beta1, upd.beta2, upd.epsilon)
    a0 = fu.launches
    out = get_op("fused_adam_master_update")(master, mm, vv, grad, 300, upd,
                                             clip_norm=0.5, grad_norm=norm,
                                             mode="pallas")
    aerr = max(float((a - b).abs().max()) for a, b in zip(out, want))
    # phase 5's tolerance: 1e-7 + 1e-6 |want|
    worst = max(float((a - b).abs().sub(1e-6 * b.abs()).max())
                for a, b in zip(out, want))
    check(fu.launches == a0 + 1 and worst <= 1e-7,
          f"fused_adam_master_update by name: launches "
          f"{fu.launches - a0}, err {aerr:.2e}")
    del master, mm, vv, grad, want, out

    qp, kv, tables, qbase = ap.kernel_case(1, "bf16", seed=24)
    p0 = pa.launches
    pout = get_op("paged_attention")(qp, kv, LAYERS // 2, tables, qbase,
                                     mode="pallas")
    pwant = pa.paged_attention_reference(qp.float(), f32_tree(kv),
                                         LAYERS // 2, tables, qbase)
    perr = float((pout.float() - pwant).abs().max())
    check(pa.launches == p0 + 1 and perr <= KIND_TOL["bf16"],
          f"paged_attention by name: launches {pa.launches - p0}, err "
          f"{perr:.2e}")
    torch.cuda.empty_cache()
    say("samediff", f"(c) by name, one launch each: flash_attention "
                    f"(N=4, T={SD_SEQ}, f32, key mask) err {err:.2e}; "
                    f"fused_adam_master_update (n={BERT_BASE_PARAMS}) err "
                    f"{aerr:.2e}; paged_attention (decode N={SLOTS}, bf16) "
                    f"err {perr:.2e}")


def samediff_sweep() -> None:
    """(d) every name of the slice once on CUDA tensors against the CPU
    (``tools/op_cases.py``), and NDArray get / put / TAD on a card
    array."""
    from deeplearning4j_tpu_torch.ndarray import NDArray, NDArrayIndex
    from deeplearning4j_tpu_torch.ops.jax_rules import on_device
    from deeplearning4j_tpu_torch.ops.registry import get_op
    from deeplearning4j_tpu_torch.tools import op_cases as oc

    t0 = time.perf_counter()
    worst, worst_name = 0.0, ""
    cases = oc.cases(0)
    took = {}
    for name, (args, kwargs, kind) in sorted(cases.items()):
        took[name] = time.perf_counter()
        outs = {}
        for dev in ("cpu", DEVICE):
            with on_device(dev):
                res = get_op(name)(*(oc.to_port(a, dev) for a in args),
                                   **{k: oc.to_port(v, dev)
                                      for k, v in kwargs.items()})
            outs[dev] = oc.flat_outputs(res)
        torch.cuda.synchronize()
        check(len(outs["cpu"]) == len(outs[DEVICE]), f"{name}: outputs")
        for c, g in zip(outs["cpu"], outs[DEVICE]):
            check(g.device.type == "cuda", f"{name}: a result on {g.device}")
            check(g.dtype == c.dtype and g.shape == c.shape,
                  f"{name}: {g.dtype} {tuple(g.shape)} against the CPU's "
                  f"{c.dtype} {tuple(c.shape)}")
            if kind == "random":
                check(bool(torch.isfinite(g.float()).all())
                      == bool(torch.isfinite(c.float()).all()),
                      f"{name}: finite pattern")
                continue
            cn, gn = oc.as_numpy(c), oc.as_numpy(g)
            check(np.array_equal(np.isnan(cn), np.isnan(gn)),
                  f"{name}: NaNs differ")
            ok = ~np.isnan(cn)
            if cn.dtype.kind in "biu":
                check(np.array_equal(cn, gn), f"{name}: integers differ")
                continue
            gk, ck = gn[ok].astype(np.float64), cn[ok].astype(np.float64)
            with np.errstate(invalid="ignore"):   # inf - inf where equal
                err = float(np.where(gk == ck, 0.0, np.abs(gk - ck) / np.maximum(
                    1.0, np.abs(ck))).max()) if ok.any() else 0.0
            if err > worst:
                worst, worst_name = err, name
            check(err <= SD_SWEEP_TOL, f"{name}: card against CPU {err:.2e}")
        took[name] = time.perf_counter() - took[name]
    slow = sorted(took, key=took.get, reverse=True)[:6]
    say("samediff", "(d) slowest names (s, CPU and card, first calls): "
                    + ", ".join(f"{n} {took[n]:.2f}" for n in slow))
    a = NDArray(torch.arange(24.0, device=DEVICE).reshape(2, 3, 4))
    c = NDArray(torch.arange(24.0).reshape(2, 3, 4))
    for arr in (a, c):
        view = arr.get(NDArrayIndex.point(1), NDArrayIndex.interval(0, 2),
                       NDArrayIndex.all())
        before = view.toNumpy().copy()
        arr.put([NDArrayIndex.point(1), NDArrayIndex.all(),
                 NDArrayIndex.indices(0, 3)], 7.0)
        arr.putScalar(0, -1.0)
        check(np.array_equal(view.toNumpy(), before), "a get view changed")
    check(np.array_equal(a.toNumpy(), c.toNumpy())
          and a.torch.device.type == "cuda", "NDArray put on the card")
    check(np.array_equal(a.tensorAlongDimension(2, 1).toNumpy(),
                         c.tensorAlongDimension(2, 1).toNumpy()), "TAD")
    say("samediff", f"(d) {len(cases)} names on the card equal the CPU "
                    f"(worst {worst:.2e} at {worst_name}, tolerance "
                    f"{SD_SWEEP_TOL:g} of max(1, |x|); integers exact; no "
                    f"result left on the host); NDArray get / put / TAD on "
                    f"a card array equal the CPU's; "
                    f"{time.perf_counter() - t0:.1f} s")


# -------------------------------------------------- phase 25: TF import
#: (b): logits against TF's stored golden at the tolerance of JAX's
#: test_full_bert_base_golden (rtol, atol); the card against the CPU,
#: relative to the CPU's largest |logit|
TF_GOLDEN_TOL = (2e-3, 2e-4)
TF_CPU_RTOL = 1e-4
#: (c): BASELINE config 4, BERT-base via SameDiff TF import: batch 32 x
#: 128, 5 fit steps of Adam
TF_FIT_BATCH, TF_FIT_STEPS, TF_FIT_LR = 32, 5, 1e-4
TF_NODES = 3053
TF_PHASE_S = 90.0


def hand_kernel_counts() -> dict:
    """Every hand kernel's launch counter, by name."""
    from deeplearning4j_tpu_torch.ops import batch_norm as bn
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_update as fu
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
    from deeplearning4j_tpu_torch.ops import paged_attention as pa
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    return {"paged_attention": pa.launches, "flash_fwd": fa.fwd_launches,
            "flash_bwd": fa.bwd_launches, "fused_adam": fu.launches,
            "lstm_fwd": lr.fwd_launches, "lstm_bwd": lr.bwd_launches,
            "conv_1x1": cb.launches_1x1, "conv_3x3": cb.launches_3x3,
            "residual_tail": rt.launches, "bn_stats": bn.stats_launches,
            "bn_apply": bn.apply_launches, "bn_bwd": bn.bwd_launches}


def phase_tfimport(smi: str) -> None:
    """Phase 25: the TensorFlow importer on BASELINE config 4, BERT-base
    via SameDiff TF import, at full width: (a) the whole frozen graph
    (``tools/make_tf_fixture.py``'s fixture with its weights seeded back)
    imported on the card; (b) its logits against TF's stored golden and
    against the same graph imported and run on the CPU; (c) fine-tuned by
    ``SameDiff.fit``. No hand kernel is on this path (JAX's importer maps
    the graph to plain registry ops): the kernel counters must not move."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.autodiff.samediff import VariableType
    from deeplearning4j_tpu_torch.datasets.multi_dataset import MultiDataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        OpMappingRegistry, TFGraphMapper, cf_import, graphdef_wire as gw)
    from deeplearning4j_tpu_torch.tools import make_tf_fixture as mf

    t0 = time.perf_counter()
    small, golden = mf.load_fixture()
    full = gw.seeded_consts(small, int(golden["seed"]))
    t_seed = time.perf_counter() - t0
    check(len(full) == int(golden["whole_bytes"]),
          f"the seeded graph is {len(full)} B, the fixture's "
          f"{int(golden['whole_bytes'])}")
    t1 = time.perf_counter()
    gd = gw.parse_graph_def(full)
    t_parse = time.perf_counter() - t1
    mapped = sum(1 for n in gd.node if OpMappingRegistry.has(n.op)
                 or n.op in cf_import.WALKER_OPS)
    check(len(gd.node) == TF_NODES, f"{len(gd.node)} nodes")
    before = hand_kernel_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sd = TFGraphMapper.importGraph(gd, device=DEVICE)
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t1
    on_card = sum(a.numel() * a.element_size() for a in sd._arrays.values())
    say("tfimport", f"(a) BERT-base frozen graph: {len(full)} B whole "
                    f"(fixture {len(small)} B, seeded in {t_seed:.2f} s), "
                    f"parsed in {t_parse:.2f} s: {len(gd.node)} nodes, "
                    f"{mapped} through the mappers; imported on the card in "
                    f"{t_import:.2f} s: {len(sd._ops)} ops, "
                    f"{len(sd._arrays)} constants, {on_card} B on the card")

    ins = [str(n) for n in golden["inputs"]]
    out = str(golden["output"])
    feeds = dict(zip(ins, (golden["ids"], golden["mask"],
                           golden["type_ids"])))
    logits = sd.output(feeds, [out])[out]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = sd.output(feeds, [out])[out]
    torch.cuda.synchronize()
    out_ms = (time.perf_counter() - t1) * 1e3
    check(logits.is_cuda and tuple(logits.shape) == (2, mf.SEQ, 30522)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} on {logits.device}")
    got = logits.cpu().numpy()
    head, sums = got[:, :4, :8], got.sum(-1, dtype=np.float64)
    e_head = float(np.abs(head - golden["logits_head"]).max())
    e_sums = float(np.abs(sums - golden["row_sums"]).max())
    rt_, at_ = TF_GOLDEN_TOL
    ok_head = np.allclose(head, golden["logits_head"], rtol=rt_, atol=at_)
    ok_sums = np.allclose(sums, golden["row_sums"], rtol=rt_, atol=at_)
    say("tfimport", f"(b) output 2 x {mf.SEQ}, f32, TF32 off: {out_ms:.1f} "
                    f"ms; against TF's golden: logits[:, :4, :8] max |err| "
                    f"{e_head:.3e}, row sums max |err| {e_sums:.3e} (of "
                    f"|sum| up to {float(np.abs(golden['row_sums']).max()):.1f}"
                    f"; rtol {rt_:g}, atol {at_:g})")
    check(ok_head and ok_sums, "logits disagree with TF's golden")
    t1 = time.perf_counter()
    cpu = TFGraphMapper.importGraph(gd, device="cpu")
    want = cpu.output(feeds, [out])[out].numpy()
    del cpu
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    say("tfimport", f"(b) the same graph imported and run on the CPU in "
                    f"{time.perf_counter() - t1:.1f} s: card against CPU "
                    f"max |diff| / max |CPU| {rel:.3e} (tolerance "
                    f"{TF_CPU_RTOL:g})")
    check(rel <= TF_CPU_RTOL, f"card against CPU {rel}")
    del gd, full, logits

    names = [v.name for v in sd.variables()
             if v.vtype is VariableType.CONSTANT and v.name in sd._arrays
             and sd._arrays[v.name].dim() >= 2
             and sd._arrays[v.name].is_floating_point()]
    sd.convertConstantsToVariables(*names)
    n_par = sum(int(sd._arrays[n].numel()) for n in names)
    vocab = 30522
    y = sd.placeholder("y_ids", shape=(None, mf.SEQ))
    oh = sd.math.one_hot(y, depth=vocab)
    logp = sd.nn.log_softmax(sd.getVariable(out))
    loss = -(oh * logp).sum(-1).mean()
    sd.setLossVariables(loss.name)
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(TF_FIT_LR), data_set_feature_mapping=ins,
        data_set_label_mapping=["y_ids"]))
    rng = np.random.default_rng(25)
    batch = [rng.integers(0, vocab, (TF_FIT_BATCH, mf.SEQ)).astype(np.int32),
             np.ones((TF_FIT_BATCH, mf.SEQ), np.int32),
             np.zeros((TF_FIT_BATCH, mf.SEQ), np.int32)]
    targets = rng.integers(0, vocab, (TF_FIT_BATCH, mf.SEQ)).astype(np.int32)
    mds = MultiDataSet(batch, [targets])
    clock = _StepClock()
    hist = sd.fit([mds] * TF_FIT_STEPS, listeners=[clock])
    losses = hist.lossCurve()
    check(len(losses) == TF_FIT_STEPS
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], f"losses {losses}")
    steps = clock.ms()
    step_ms = sorted(steps[1:])[len(steps[1:]) // 2]
    tokens = TF_FIT_BATCH * mf.SEQ
    say("tfimport", f"(c) fine-tune: {len(names)} float constants of rank "
                    f">= 2 promoted ({n_par} parameters), per-token "
                    f"cross-entropy over {vocab}, Adam({TF_FIT_LR:g}), batch "
                    f"{TF_FIT_BATCH} x {mf.SEQ}, f32: losses "
                    + " ".join(f"{x:.5f}" for x in losses)
                    + f"; step ms {' '.join(f'{x:.2f}' for x in steps)} "
                    f"(median of 2-{TF_FIT_STEPS} {step_ms:.2f} ms, "
                    f"{tokens / step_ms * 1e3:.1f} tokens/s); {smi}")

    def one_step():
        sd.fit(mds)

    prof = {}
    busy = device_profile("tfimport", "(c) one more fit step", one_step, (),
                          out=prof)
    kernels = sum(r[3] for r in prof.get("all", ()))
    aten = profiled_ops(one_step)
    if busy:
        say("tfimport", f"(c) a step: {kernels} device kernels in the "
                        f"profiler's window, {sum(aten.values())} aten "
                        f"operations ({len(aten)} kinds) on the host; device "
                        f"busy {busy:.2f} ms against {step_ms:.2f} ms a step:"
                        f" idle about {1 - busy / step_ms:.3f}; {smi}")
    after = hand_kernel_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    check(not moved, f"hand kernels launched on the import path: {moved}")
    del sd, hist
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    say("tfimport", f"no hand kernel on this path (counters unchanged); "
                    f"phase 25 took {secs:.1f} s (budget {TF_PHASE_S:g} s)")
    check(secs <= TF_PHASE_S, f"phase 25 took {secs:.1f} s")


# ------------------------------------------------ phase 26: ONNX import
#: (b): logits against torch's stored golden (rtol, atol), and the card
#: against the CPU relative to the CPU's largest |logit|
ONNX_GOLDEN_TOL = (1e-3, 1e-3)
ONNX_CPU_RTOL = 1e-4
#: (c): the promoted ResNet-50 fine-tuned at batch 32 x 224 x 224, 5
#: steps of Adam
ONNX_FIT_BATCH, ONNX_FIT_STEPS, ONNX_FIT_LR = 32, 5, 1e-4
ONNX_HW, ONNX_CLASSES = 224, 1000
ONNX_NODES, ONNX_INITIALIZERS = 175, 267
ONNX_PHASE_S = 60.0
#: the kernels that move data from one layout to another: cuDNN's
#: conversions (launched inside the convolutions), and the copies of a
#: strided tensor
LAYOUT_OPS = ("aten::contiguous", "aten::clone", "PermuteBackward")
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")


def onnx_group(chain) -> str:
    """The group of a kernel in phase 26's profile: the batch's copy to
    the card (and any cast), the NCHW<->NHWC brackets' copies
    ("transpose": a clone or contiguous call, or a permute's backward),
    the convolutions and the head's matmuls, the updater, or the rest
    (the decomposed batch norm, ReLU, residual adds, pools, the loss)."""
    text = " | ".join(chain)
    if "aten::_to_copy" in text:
        return "upload/cast"
    if any(k in text for k in LAYOUT_OPS):
        return "transpose"
    if "onvolution" in text or "aten::mm" in text or "aten::addmm" in text \
            or "MmBackward" in text:
        return "conv/matmul"
    if "apply_updater" in text or "_foreach" in text:
        return "updater"
    return "elementwise/pool/loss"


def phase_onnximport(smi: str) -> None:
    """Phase 26: the ONNX importer on a full-width ResNet-50 (torchvision's
    architecture, 1,000 classes, 224 x 224): (a) the whole model
    (``tools/make_onnx_fixture.py``'s fixture with its initializers seeded
    back by ``onnx_proto.seeded_initializers``) imported on the card; (b)
    its logits against torch's stored golden and against the same model
    imported and run on the CPU; (c) the rank >= 2 initializers promoted
    and fine-tuned by ``SameDiff.fit``. No hand kernel is on this path
    (JAX's importer maps the graph to plain registry ops): the kernel
    counters must not move."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.onnx import (
        OnnxImport, decode_model, onnx_proto)
    from deeplearning4j_tpu_torch.tools import make_onnx_fixture as mf

    t0 = time.perf_counter()
    small, golden = mf.load_fixture()
    full = onnx_proto.seeded_model(small, int(golden["seed"]))
    t_seed = time.perf_counter() - t0
    check(len(full) == int(golden["whole_bytes"]),
          f"the seeded model is {len(full)} B, the fixture's "
          f"{int(golden['whole_bytes'])}")
    t1 = time.perf_counter()
    model = decode_model(full)
    t_parse = time.perf_counter() - t1
    g = model.graph
    check(len(g.nodes) == ONNX_NODES
          and len(g.initializers) == ONNX_INITIALIZERS,
          f"{len(g.nodes)} nodes, {len(g.initializers)} initializers")
    before = hand_kernel_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sd = OnnxImport.importGraph(model, device=DEVICE)
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t1
    on_card = sum(a.numel() * a.element_size() for a in sd._arrays.values())
    ops = {}
    for op in sd._ops:
        ops[op.op_name] = ops.get(op.op_name, 0) + 1
    say("onnximport", f"(a) ResNet-50 ONNX model: {len(full)} B whole "
                      f"(fixture {len(small)} B, seeded in {t_seed:.2f} s), "
                      f"decoded in {t_parse:.2f} s: opset "
                      f"{model.opset_version}, {len(g.nodes)} nodes, "
                      f"{len(g.initializers)} initializers; imported on the "
                      f"card in {t_import:.2f} s: {len(sd._ops)} ops ("
                      + ", ".join(f"{k} {v}" for k, v in sorted(
                          ops.items(), key=lambda kv: -kv[1])[:8])
                      + f"), {len(sd._arrays)} constants, {on_card} B "
                        f"uploaded")

    inp, out = str(golden["input"]), str(golden["output"])
    x = mf.golden_input(int(golden["seed"]))
    logits = sd.output({inp: x}, [out])[out]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = sd.output({inp: x}, [out])[out]
    torch.cuda.synchronize()
    out_ms = (time.perf_counter() - t1) * 1e3
    check(logits.is_cuda and tuple(logits.shape) == (mf.BATCH, ONNX_CLASSES)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} on {logits.device}")
    got = logits.cpu().numpy()
    sums = got.sum(-1, dtype=np.float64)
    e_log = float(np.abs(got - golden["logits"]).max())
    e_sums = float(np.abs(sums - golden["row_sums"]).max())
    rt_, at_ = ONNX_GOLDEN_TOL
    ok = np.allclose(got, golden["logits"], rtol=rt_, atol=at_) and \
        np.allclose(sums, golden["row_sums"], rtol=rt_, atol=at_)
    say("onnximport", f"(b) output {mf.BATCH} x 3 x {mf.HW} x {mf.HW}, f32, "
                      f"TF32 off: {out_ms:.1f} ms; against torch's golden: "
                      f"logits max |err| {e_log:.3e} (of |logit| up to "
                      f"{float(np.abs(golden['logits']).max()):.1f}), row "
                      f"sums max |err| {e_sums:.3e} (rtol {rt_:g}, atol "
                      f"{at_:g})")
    check(ok, "logits disagree with torch's golden")
    t1 = time.perf_counter()
    cpu = OnnxImport.importGraph(model, device="cpu")
    want = cpu.output({inp: x}, [out])[out].numpy()
    del cpu
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    say("onnximport", f"(b) the same model imported and run on the CPU in "
                      f"{time.perf_counter() - t1:.1f} s: card against CPU "
                      f"max |diff| / max |CPU| {rel:.3e} (tolerance "
                      f"{ONNX_CPU_RTOL:g})")
    check(rel <= ONNX_CPU_RTOL, f"card against CPU {rel}")
    del model, full, logits

    names = [t.name for t in g.initializers
             if len(t.dims) >= 2 and t.data_type in onnx_proto.FLOAT_TYPES]
    sd.convertConstantsToVariables(*names)
    n_par = sum(int(sd._arrays[n].numel()) for n in names)
    y = sd.placeholder("labels", shape=(None,))
    oh = sd.math.one_hot(y, depth=ONNX_CLASSES)
    logp = sd.nn.log_softmax(sd.getVariable(out))
    loss = -(oh * logp).sum(-1).mean()
    sd.setLossVariables(loss.name)
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(ONNX_FIT_LR), data_set_feature_mapping=[inp],
        data_set_label_mapping=["labels"]))
    rng = np.random.default_rng(26)
    images = rng.standard_normal((ONNX_FIT_BATCH, 3, ONNX_HW, ONNX_HW),
                                 dtype=np.float32)
    labels = rng.integers(0, ONNX_CLASSES, ONNX_FIT_BATCH).astype(np.int32)
    ds = DataSet(images, labels)
    clock = _StepClock()
    hist = sd.fit([ds] * ONNX_FIT_STEPS, listeners=[clock])
    losses = hist.lossCurve()
    check(len(losses) == ONNX_FIT_STEPS
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0], f"losses {losses}")
    steps = clock.ms()
    step_ms = sorted(steps[1:])[len(steps[1:]) // 2]
    say("onnximport", f"(c) fine-tune: {len(names)} float initializers of "
                      f"rank >= 2 promoted ({n_par} parameters), softmax "
                      f"cross-entropy over {ONNX_CLASSES}, "
                      f"Adam({ONNX_FIT_LR:g}), batch {ONNX_FIT_BATCH} x 3 x "
                      f"{ONNX_HW} x {ONNX_HW}, f32, TF32 off: losses "
                      + " ".join(f"{v:.4f}" for v in losses)
                      + f"; step ms {' '.join(f'{v:.2f}' for v in steps)} "
                      f"(median of 2-{ONNX_FIT_STEPS} {step_ms:.2f} ms, "
                      f"{ONNX_FIT_BATCH / step_ms * 1e3:.1f} images/s); "
                      f"{smi}")

    def one_step():
        sd.fit(ds)

    prof = {}
    busy = device_profile("onnximport", "(c) one more fit step", one_step,
                          LAYOUT_KERNELS, group=onnx_group, out=prof)
    aten = profiled_ops(one_step)
    if busy:
        kernels = sum(r[3] for r in prof["all"])
        moved = sum(r[1] for r in prof["all"] if r[2] == "transpose"
                    or any(k in r[0] for k in LAYOUT_KERNELS)) / 1e3
        say("onnximport", f"(c) a step: {kernels} device kernels in the "
                          f"profiler's window, {sum(aten.values())} aten "
                          f"operations ({len(aten)} kinds) on the host; "
                          f"device busy {busy:.2f} ms against {step_ms:.2f} "
                          f"ms a step: idle about {1 - busy / step_ms:.3f}; "
                          f"the transposes' layout copies (their copies "
                          f"and cuDNN's conversions) {moved:.2f} ms, "
                          f"{moved / busy:.3f} of device time; {smi}")
    after = hand_kernel_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    check(not moved, f"hand kernels launched on the import path: {moved}")
    del sd, hist
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    say("onnximport", f"no hand kernel on this path (counters unchanged); "
                      f"phase 26 took {secs:.1f} s (budget "
                      f"{ONNX_PHASE_S:g} s)")
    check(secs <= ONNX_PHASE_S, f"phase 26 took {secs:.1f} s")


def _first(out):
    return out[0] if isinstance(out, list) else out


def _leaves_of(tree) -> list:
    from deeplearning4j_tpu_torch.params import tree_leaves

    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["tail-times"]:
        # the residual tail's times alone, of the port found from the
        # current directory (an earlier tree, to compare designs)
        sys.path.insert(0, os.getcwd())
        phase_device()
        say_tail_times(argv[1] if len(argv) > 1 else os.getcwd())
        return 0
    if argv[:1] == ["resnet50-step"]:
        # phase 15 alone, of the port found from the current directory
        sys.path.insert(0, os.getcwd())
        smi = phase_device()
        import deeplearning4j_tpu_torch
        say("resnet50", f"[{argv[1] if len(argv) > 1 else os.getcwd()}] "
                        f"the port of {deeplearning4j_tpu_torch.__file__}")
        phase_resnet50_train(smi, {r[0]: {} for r in BN_ROWS})
        return 0
    if argv[:1] == ["lstm-train"]:
        # phase 9 alone, of the port found from the current directory; the
        # kernel rows that phase 8 fills print as nan
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_device()
        import deeplearning4j_tpu_torch
        say("lstm-train", f"[{argv[1] if len(argv) > 1 else os.getcwd()}] "
                          f"the port of {deeplearning4j_tpu_torch.__file__}")
        phase_lstm_train(defaultdict(lambda: defaultdict(lambda: math.nan)))
        return 0
    if argv[:1] == ["training-loop"]:
        # phase 17 alone, of the port found from the current directory
        sys.path.insert(0, os.getcwd())
        phase_training_loop(phase_device(), None)
        return 0
    if argv[:1] == ["seq2seq"]:
        # phase 18 alone, of the port found from the current directory
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_seq2seq(phase_device(), defaultdict(dict))
        return 0
    if argv[:1] == ["precision"]:
        # phase 19 alone, of the port found from the current directory
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_precision(phase_device(), defaultdict(dict), None)
        return 0
    if argv[:1] == ["vision"]:
        # phase 20 alone, of the port found from the current directory
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_vision(phase_device(), defaultdict(dict))
        return 0
    if argv[:1] == ["transfer"]:
        # phase 21 alone, of the port found from the current directory
        sys.path.insert(0, os.getcwd())
        phase_transfer(phase_device())
        return 0
    if argv[:1] == ["layers"]:
        # phase 22 alone, of the port found from the current directory
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_layers(phase_device(), defaultdict(dict))
        return 0
    if argv[:1] == ["resilience"]:
        # phase 23 alone, of the port found from the current directory
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_resilience(phase_device(), defaultdict(dict))
        return 0
    if argv[:1] == ["samediff"]:
        # phase 24 alone, of the port found from the current directory
        from collections import defaultdict

        sys.path.insert(0, os.getcwd())
        phase_samediff(phase_device(), defaultdict(dict))
        return 0
    if argv[:1] == ["tfimport"]:
        # phase 25 alone, of the port found from the current directory
        sys.path.insert(0, os.getcwd())
        phase_tfimport(phase_device())
        return 0
    if argv[:1] == ["onnximport"]:
        # phase 26 alone, of the port found from the current directory
        sys.path.insert(0, os.getcwd())
        phase_onnximport(phase_device())
        return 0
    if not os.path.isdir(os.path.join(PKG, "csrc")):
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({PKG})", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    ctx = phase_serve(rows)
    phase_fp8(ctx, rows)
    phase_prefix(ctx, rows)
    phase_spec(ctx, rows)
    phase_int8(ctx)
    del ctx
    rows.update((r["name"], r) for r in (*phase_flash(), phase_adam()))
    phase_train(rows)
    phase_parity()
    rows.update((r["name"], r) for r in phase_lstm_kernels())
    phase_lstm_train(rows)
    phase_lstm_parity()
    rows.update((r["name"], r) for r in phase_conv_kernels())
    rows.update((r["name"], r) for r in phase_bn_kernels())
    phase_resnet_blocks(rows)
    phase_resnet_parity()
    phase_lenet()
    resident_ms = phase_resnet50_train(smi, rows)
    phase_graph_parity()
    phase_training_loop(smi, resident_ms)
    phase_seq2seq(smi, rows)
    phase_precision(smi, rows, resident_ms)
    phase_vision(smi, rows)
    phase_transfer(smi)
    phase_layers(smi, rows)
    phase_resilience(smi, rows)
    phase_samediff(smi, rows)
    phase_tfimport(smi)
    phase_onnximport(smi)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
