"""One call for each op name the by-name slice registers (ROADMAP A10.1),
from numpy inputs made from a seed.

``cases(seed)`` returns ``{name: (args, kwargs, kind)}``: ``kind`` is
"exact" (compare values), "random" (compare shape, dtype and support:
draws differ between generators and devices) or "inplace" (the op writes
into its first arguments, so give each run fresh copies). Two
placeholders stand in for package objects: :data:`RNG` for a random key
(the port takes a seed) and :data:`ADAM` for an ``Adam`` updater.
Sub-graph attributes (branches, loop bodies) are built with the port's
``SameDiff`` and work in either package.

:func:`to_port` puts a case's arguments on a device. ``chip_smoke.py``
runs every case on the card and on the CPU; the CPU tests hold the port
against the JAX package on the same inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

RNG = "<rng>"
ADAM = "<adam>"


def subgraph(build, n_in: int):
    """A sub-graph dict (branch, loop body) from ``build(sub, *args) ->
    out(s)``, traced on a CPU SameDiff; it runs on any device."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.autodiff.control_flow import (
        ARG_PREFIX, subgraph_to_dict)

    sub = SameDiff(device="cpu")
    phs = [sub.placeholder(f"{ARG_PREFIX}{i}") for i in range(n_in)]
    outs = build(sub, *phs)
    outs = [outs] if not isinstance(outs, (list, tuple)) else list(outs)
    return subgraph_to_dict(sub, [o.name for o in outs], n_in)


def cases(seed: int = 0) -> Dict[str, Tuple[tuple, dict, str]]:
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (r.normal(size=shape) * scale).astype(np.float32)

    def u(lo, hi, *shape):
        return r.uniform(lo, hi, shape).astype(np.float32)

    def i32(v):
        return np.asarray(v, np.int32)

    X, Y, P = n(4, 6), n(4, 6), u(0.1, 0.9, 4, 6)
    IMG, SEQ, VOL = u(0, 1, 2, 8, 8, 3), n(2, 10, 4), n(2, 6, 6, 6, 3)
    INTS = i32(r.integers(0, 255, (4, 6)))
    SQ = n(4, 4)
    XZ = np.where(X > 0, X, 0).astype(np.float32)
    c = {}

    def add(name, *args, kind="exact", **kw):
        c[name] = (args, kw, kind)

    # ------------------------------------------------------ ops_math
    add("argmin", X, dimensions=1)
    add("batch_mmul", SEQ, SEQ.transpose(0, 2, 1).copy())
    add("concat", X, Y, axis=1)
    add("count_nonzero", XZ, dimensions=1)
    add("cumprod", P, axis=1, exclusive=True, reverse=True)
    add("cumsum", INTS, axis=1, exclusive=True)
    add("diag", X[0].copy())
    add("eq", INTS % 3, INTS % 2)
    add("expand_dims", X, axis=(0, -1))
    add("eye", 3, m=4)
    add("fill_like", X, 3.0)
    add("floordiv", X, P)
    add("gather", X, i32([0, 3, -1, 5, -5]), axis=0)
    add("gather_nd", X, i32([[0, 1], [3, 5], [9, 9], [-1, 0]]))
    add("is_finite", np.asarray([1.0, np.inf, np.nan], np.float32))
    add("linspace", 0.0, 1.0, 5)
    add("logical_and", X > 0, X > -1)
    add("logical_or", X > 0, X > -1)
    add("logical_not", X > 0)
    add("logical_xor", X > 0, X > -1)
    add("maximum", X, Y)
    add("minimum", X, Y)
    add("mod", INTS - 100, i32(-7))
    add("neq", X, Y)
    add("ones_like", X)
    add("zeros_like", INTS)
    add("pad", X, [[1, 2], [2, 1]], mode="symmetric")
    add("range", 0, 10, 3)
    add("rank_of", VOL)
    add("reduce_all", X > -1, dimensions=1)
    add("reduce_any", X > 1, dimensions=1)
    add("reduce_logsumexp", X, dimensions=(0, 1), keep_dims=True)
    add("reduce_norm1", X, dimensions=1)
    add("reduce_norm_max", X, dimensions=1)
    add("reduce_prod", P, dimensions=(0, 1))
    add("reduce_var", X, dimensions=0, bias_corrected=False)
    add("repeat", X, repeats=2, axis=1)
    add("reverse", X, dimensions=(0, 1))
    add("scatter_add", X, i32([0, 2, 2, 7, -1]), np.ones((5, 6), np.float32))
    add("scatter_update", X, i32([1, 1, -4]),
        np.arange(18, dtype=np.float32).reshape(3, 6))
    ids = i32([0, 0, 2, 5])
    add("segment_max", X, ids, 3)
    add("segment_min", X, ids, 3)
    add("segment_mean", X, ids, 3)
    add("segment_sum", X, ids, 3)
    add("shape_of", VOL)
    add("size_of", X)
    add("slice", X, begin=(1, 3), size=(2, 4))
    add("split", X, num_splits=3, axis=1)
    add("squared_difference", X, Y)
    add("squeeze", X[None, :, None], axis=(0, 2))
    add("stack", X, Y, axis=1)
    add("stop_gradient", X)
    add("strided_slice", X, begin=[3, 5], end=[0, 0], strides=[-1, -2])
    add("tensordot", SEQ, SEQ, axes=[[1, 2], [1, 2]])
    add("tile", X, reps=(2, 1))
    add("top_k", np.asarray([[1, 3, 3, 0, 3], [2, 2, 2, 2, 2]], np.float32),
        k=3)
    add("trace", SQ)
    add("unstack", X, axis=1)
    add("where", X > 0, X, Y)
    # ---------------------------------------------------- transforms
    for name, arg in (("abs", np.concatenate([X, np.zeros((1, 6),
                                                          np.float32)])),
                      ("acos", P), ("asin", P), ("atan", X), ("ceil", X * 3),
                      ("cos", X), ("cosh", X), ("erf", X), ("exp", X),
                      ("floor", X * 3), ("log", P), ("log1p", P),
                      ("reciprocal", P), ("round", X * 3), ("rsqrt", P),
                      ("sign", np.round(X)), ("sin", X), ("sinh", X),
                      ("sqrt", P), ("square", X), ("step", X), ("tan", X)):
        add(name, arg)
    add("isinf", np.asarray([1.0, np.inf, -np.inf, np.nan], np.float32))
    add("isnan", np.asarray([1.0, np.inf, np.nan], np.float32))
    add("atan2", X, Y)
    add("clip_by_norm", X, 1.0)
    add("clip_by_value", X, -0.5, 0.5)
    add("log_softmax", X, axis=0)
    add("max_pairwise", X, Y)
    add("min_pairwise", X, Y)
    add("pow", P, 2.5)
    add("prelu", X, np.float32(0.2))
    add("standardize", X, axis=1)
    # -------------------------------------------------------- reduce
    add("argamax", X, axis=1)
    add("argamin", X)
    add("confusion_matrix", i32([0, 1, 2, 1]), i32([0, 2, 2, 1]), 3)
    add("cosine_distance", X, Y, axis=1)
    add("cosine_similarity", X, Y, axis=1)
    add("count_zero", XZ, axis=0)
    add("dot", X, Y, axis=1)
    add("entropy", P, axis=1)
    add("euclidean_distance", X, Y, axis=1)
    add("hamming_distance", INTS % 3, INTS % 2)
    add("in_top_k", np.asarray([[1, 3, 3, 0], [2, 2, 2, 2], [0, 1, 2, 3]],
                               np.float32), i32([2, 1, 1]), 2)
    add("jaccard_distance", P, P * 0.5)
    add("log_entropy", P)
    add("manhattan_distance", X, Y)
    add("matrix_trace", np.stack([SQ, SQ * 2]))
    add("moments", X, axis=0)
    add("norm1", X, axis=1)
    add("norm2", X, axis=1)
    add("normmax", X, axis=1)
    add("segment_prod", X, i32([0, 0, 1, 2]), 3)
    add("shannon_entropy", P)
    add("squared_norm", X)
    add("std", X, axis=1, ddof=1)
    add("unsorted_segment_mean", X, i32([1, 0, 1, 7]), 3)
    add("unsorted_segment_sum", X, i32([1, 0, 1, 7]), 3)
    add("variance", X, axis=1)
    add("zero_fraction", XZ)
    # --------------------------------------------------------- shape
    add("batch_to_space", n(8, 2, 2, 3), (2, 2), ((0, 1), (1, 0)))
    add("broadcast_to", X[0].copy(), (3, 6))
    add("compress", X, np.asarray([True, False, True, True]), 5, axis=0,
        fill_value=-1)
    add("depth_to_space", n(2, 4, 4, 12), 2)
    add("diag_part", SQ)
    add("dynamic_update_slice", X, np.zeros((2, 2), np.float32), (3, 5))
    add("fill", (2, 3), 7)
    add("flatten_2d", VOL)
    add("masked_fill", X, X > 0, 0.0)
    add("matrix_diag", X)
    add("matrix_set_diag", X, Y[0].copy())
    add("meshgrid", np.arange(3, dtype=np.float32),
        np.arange(4, dtype=np.float32))
    add("mirror_pad", X, [[1, 1], [2, 2]], reflect=False)
    add("permute", SEQ, (2, 0, 1))
    add("rank", VOL)
    add("reverse_sequence", SEQ, i32([3, 10]))
    dup = i32([1, 1, 3])
    for op in ("scatter_div", "scatter_max", "scatter_min", "scatter_mul",
               "scatter_sub"):
        add(op, X, dup, u(0.5, 2.0, 3, 6))
    add("scatter_nd", i32([[0, 1], [2, 3], [0, 1], [5, 0]]),
        np.asarray([1, 2, 3, 4], np.float32), (4, 6))
    add("select", X > 0, X, Y)
    add("space_to_batch", IMG, (2, 2), ((1, 1), (0, 2)))
    add("space_to_depth", IMG, 2)
    add("split_v", X, (2, 4), axis=1)
    add("take_along_axis", X, i32([[0, 5, -1, 9]] * 4), 1)
    add("unique_with_counts", INTS % 5, 7)
    # ------------------------------------------------------------ nn
    add("avgpool1d", SEQ, 3, stride=2, padding="SAME")
    add("avgpool3d", VOL)
    add("celu", X, alpha=0.7)
    add("conv1d", SEQ, n(3, 4, 5, scale=0.3), n(5))
    add("conv3d", VOL, n(2, 2, 2, 3, 4, scale=0.3))
    add("ctc_loss", n(2, 12, 5), i32([[1, 2, 3], [2, 4, 0]]), i32([12, 12]),
        i32([3, 2]))
    add("deconv2d", IMG, n(3, 3, 3, 4, scale=0.3), strides=(2, 2))
    add("depthwise_conv2d", IMG, n(3, 3, 3, 2, scale=0.3))
    q = n(2, 3, 5, 4)
    add("dot_product_attention", q, n(2, 3, 5, 4), n(2, 3, 5, 4),
        np.tril(np.ones((5, 5), bool))[None, None])
    add("dropout", np.ones(4000, np.float32), 0.5, RNG, kind="random")
    add("embedding_lookup", n(10, 4), i32([[1, 2], [9, -1], [10, 3]]))
    add("global_max_pool", IMG)
    add("glu", X)
    add("group_norm", IMG, np.ones(3, np.float32), np.zeros(3, np.float32), 3)
    add("gru_layer", SEQ, n(4, 15, scale=0.4), n(5, 15, scale=0.4), n(15))
    add("gru_seq", SEQ, n(4, 15, scale=0.4), n(5, 15, scale=0.4), n(15),
        n(15), reverse=True)
    add("hard_swish", X * 4)
    add("hinge_loss", np.asarray([0.0, 1.0, 1.0, 0.0], np.float32),
        np.asarray([0.3, 2.0, -1.0, -0.4], np.float32))
    add("huber_loss", X, Y)
    add("im2col", IMG, (3, 3), strides=(2, 2), padding="SAME")
    add("instance_norm", IMG, np.ones(3, np.float32), np.zeros(3, np.float32))
    pn = P / P.sum(-1, keepdims=True)
    add("kl_divergence", pn, pn[::-1].copy())
    add("locally_connected1d", SEQ, n(9, 8, 3))
    add("locally_connected2d", IMG, n(49, 12, 5))
    add("log_loss", P, (P > 0.5).astype(np.float32))
    add("log_sigmoid", X)
    w_ih, w_hh, b = n(4, 20, scale=0.4), n(5, 20, scale=0.4), n(20)
    add("lstm_layer", SEQ, w_ih, w_hh, b, reverse=True)
    add("lstm_seq", SEQ, w_ih, w_hh, b)
    add("maxpool1d", SEQ, 2)
    add("maxpool3d", VOL)
    add("mean_pairwise_squared_error", np.zeros_like(X), X)
    add("multi_head_dot_product_attention", n(2, 5, 8), n(2, 7, 8),
        n(8, 8, scale=0.3), n(8, 8, scale=0.3), n(8, 8, scale=0.3),
        n(8, 8, scale=0.3), np.asarray([[1] * 7, [1] * 4 + [0] * 3],
                                       np.float32), num_heads=2)
    add("one_hot", i32([0, 2, -1, 5]), 4)
    lens = i32([6, 10])
    add("onnx_gru_seq", SEQ, n(4, 15, scale=0.4), n(5, 15, scale=0.4), n(15),
        n(15), lens, has_lens=True, reverse=True, linear_before_reset=False)
    add("onnx_lstm_seq", SEQ, w_ih, w_hh, b, n(2, 5), n(2, 5), lens,
        n(3, 5, scale=0.3), has_state=True, has_lens=True, has_peep=True,
        cell_clip=3.0)
    add("onnx_rnn_seq", SEQ, n(4, 5, scale=0.4), n(5, 5, scale=0.4), n(5),
        acts=[["relu", None, None]])
    add("pnormpool1d", SEQ, 2)
    add("poisson_nll_loss", P, X)
    add("rms_norm", X, np.full(6, 1.1, np.float32))
    add("separable_conv2d", IMG, n(3, 3, 3, 1, scale=0.3),
        n(1, 1, 3, 5, scale=0.3))
    add("sigmoid_cross_entropy", X, P)
    add("simple_rnn_layer", SEQ, n(4, 5, scale=0.4), n(5, 5, scale=0.4),
        n(5))
    add("softmax_cross_entropy", X, np.eye(6, dtype=np.float32)[[0, 1, 2, 3]])
    add("sumpool1d", SEQ, 2)
    add("upsampling2d", IMG, 2)
    add("xw_plus_b", X, n(6, 3), n(3))
    # -------------------------------------------------- extra_indexing
    add("batch_gather", SEQ, i32([[0, 1], [2, 11]]))
    add("bincount", i32([0, 1, 1, 3, 4]), minlength=2, maxlength=5)
    add("dynamic_partition_masks", X, i32([0, 0, 1, 2]), 3)
    add("dynamic_stitch", [i32([0, 2]), i32([1, 3])],
        [np.ones((2, 6), np.float32), 2 * np.ones((2, 6), np.float32)], 4)
    add("flip", X, axis=1)
    add("histogram_fixed_width", P, 0.0, 1.0, nbins=4)
    add("nth_element", X, 2, reverse=True)
    add("roll", X, 2, axis=1)
    add("rot90", X)
    add("scatter_nd_add", np.zeros((4, 6), np.float32),
        i32([[0, 1], [2, 3], [0, 1]]), np.ones(3, np.float32))
    add("scatter_nd_sub", np.zeros((4, 6), np.float32), i32([[0, 1], [2, 3]]),
        np.ones(2, np.float32))
    add("scatter_nd_update", np.zeros((4, 6), np.float32),
        i32([[0, 1], [2, 3], [9, 0]]), np.full(3, 7.0, np.float32))
    add("searchsorted", np.asarray([1.0, 2.0, 4.0], np.float32),
        np.asarray([0.5, 2.0, 3.0], np.float32), side="right")
    add("sequence_mask", i32([1, 3]), 4)
    sid = i32([0, 0, 1, 4])
    for op in ("unsorted_segment_max", "unsorted_segment_min",
               "unsorted_segment_prod", "unsorted_segment_sqrt_n"):
        add(op, X, sid, 3)
    # -------------------------------------------------------- random
    for op, kw in (("random_uniform", {"minval": -1.0, "maxval": 2.0}),
                   ("random_normal", {"mean": 1.0, "std": 2.0}),
                   ("random_bernoulli", {"p": 0.3}),
                   ("random_exponential", {"lam": 2.0}),
                   ("truncated_normal", {}),
                   ("random_gamma", {"alpha": 2.0}),
                   ("random_poisson", {"lam": 3.0}),
                   ("random_laplace", {}), ("random_cauchy", {}),
                   ("random_gumbel", {}),
                   ("random_beta", {"a": 2.0, "b": 3.0}),
                   ("random_rademacher", {})):
        add(op, RNG, (4000,), kind="random", **kw)
    add("dropout_mask", RNG, (4000,), 0.7, kind="random")
    add("random_categorical", RNG, np.log(np.asarray(
        [[0.1, 0.2, 0.7], [0.5, 0.5, 1e-9]], np.float32)), 2000,
        kind="random")
    add("random_shuffle", RNG, X, kind="random")
    # --------------------------------------------- kernels by name
    add("flash_attention", n(2, 2, 16, 8), n(2, 2, 16, 8), n(2, 2, 16, 8),
        np.asarray([[1] * 16, [1] * 9 + [0] * 7], np.float32), causal=True)
    add("fused_adam_master_update", n(1000), n(1000, scale=0.1),
        u(0.0, 0.1, 1000), n(1000), 3, ADAM, clip_norm=1.0, kind="inplace")
    add("paged_attention", n(2, 2, 1, 32),
        {"k": n(1, 6, 2, 16, 32), "v": n(1, 6, 2, 16, 32)}, 0,
        i32([[0, 1, 2], [3, 4, 5]]), i32([5, 40]))
    # -------------------------------------------------- control flow
    add("if_cond", np.asarray(True), X,
        true_graph=subgraph(lambda s, a: a * 2.0, 1),
        false_graph=subgraph(lambda s, a: a + 100.0, 1))
    add("case_graph", i32(7), X, branches=[
        subgraph(lambda s, a: a + 1.0, 1), subgraph(lambda s, a: a * 3.0, 1),
        subgraph(lambda s, a: a - 5.0, 1)])
    add("call_graph", X, Y, graph=subgraph(lambda s, a, b: [a * b, a - b], 2))
    add("while_loop", np.float32(0.0), X,
        cond_graph=subgraph(lambda s, i, a: i < 3.0, 2),
        body_graph=subgraph(lambda s, i, a: [i + 1.0, a * 2.0], 2),
        max_trip_count=None)
    return c



def tf_cases(seed: int = 0) -> Dict[str, Tuple[tuple, dict, str]]:
    """One call for each of the 112 names the TensorFlow-import slice
    registers (ROADMAP A10.2): ``ops/tf_compat.py``, ``tensor_array.py``,
    ``bitwise.py``, ``extra_math.py``, ``linalg.py`` and the six names of
    ``declarable_tail.py``; the same ``(args, kwargs, kind)`` form as
    :func:`cases`."""
    r = np.random.default_rng(seed + 22)

    def n(*shape, scale=1.0):
        return (r.normal(size=shape) * scale).astype(np.float32)

    def u(lo, hi, *shape):
        return r.uniform(lo, hi, shape).astype(np.float32)

    def i32(v):
        return np.asarray(v, np.int32)

    X, Y, P = n(4, 6), n(4, 6), u(0.1, 0.9, 4, 6)
    INTS = i32(r.integers(-300, 300, (4, 6)))
    SH = i32(r.integers(0, 40, (4, 6)))
    SQ = n(4, 4)
    SPD = (SQ @ SQ.T + 4 * np.eye(4)).astype(np.float32)
    XN = X.copy()
    XN[0, :2] = np.nan
    XN[3, :] = np.nan
    c = {}

    def add(name, *args, kind="exact", **kw):
        c[name] = (args, kw, kind)

    # ------------------------------------------------------ tf_compat
    add("tf_strided_slice", n(5, 6, 3), begin=[1, -1, 0, 0],
        end=[5, 0, 0, 2], strides=[2, -2, 1, 1], begin_mask=0, end_mask=0,
        shrink_axis_mask=0b0100, new_axis_mask=0b1000)
    add("tf_strided_slice_dyn", n(5, 6, 3), i32([3, -2, 0]),
        begin=[None, 1, None], end=[None, 4, None], begin_mask=0b100,
        end_mask=0b100, shrink_axis_mask=0b001)
    add("tf_fill", shape=[2, 3], value=1.5)
    add("erfc", X)
    # --------------------------------------------------- tensor_array
    add("tensorarray_reserve", size=4, elem_shape=[2, 3], dtype="float32")
    add("tensorarray_write", np.zeros((4, 6), np.float32), i32(-1), X[0])
    add("tensorarray_scatter", np.zeros((5, 6), np.float32), i32([3, 0, 9]),
        X[:3].copy())
    add("tensorarray_size", np.zeros((7, 2), np.float32))
    # -------------------------------------------------------- bitwise
    add("bitwise_and", INTS, SH)
    add("bitwise_or", INTS, SH)
    add("bitwise_xor", INTS, SH)
    add("bitwise_not", INTS)
    add("shift_left", INTS, SH)
    add("shift_right", INTS, SH)
    add("cyclic_shift_left", INTS, 5)
    add("cyclic_shift_right", INTS, 37)
    add("toggle_bits", INTS)
    add("bits_hamming_distance", INTS, SH)
    add("bitcast", X, "int32")
    add("equals", INTS % 3, SH % 3)
    add("not_equals", INTS % 3, SH % 3)
    add("greater", X, Y)
    add("greater_equal", INTS % 3, SH % 3)
    add("less", X, Y)
    add("less_equal", INTS % 3, SH % 3)
    add("is_close", X, X + n(4, 6, scale=1e-5), rtol=1e-5, atol=1e-5)
    add("floormod", X * 5, Y)
    add("truncatediv", INTS, i32(r.integers(1, 9, (4, 6))) * np.where(
        SH > 20, 1, -1).astype(np.int32))
    add("divide_no_nan", X, np.where(Y > 0, Y, 0).astype(np.float32))
    # ----------------------------------------------------- extra_math
    for name, arg in (("asinh", X), ("acosh", 1.0 + P * 3),
                      ("atanh", u(-0.9, 0.9, 4, 6)), ("expm1", X),
                      ("rint", np.round(X * 4) / 2), ("trunc", X * 3),
                      ("cbrt", X * 8), ("erfinv", u(-0.95, 0.95, 4, 6)),
                      ("lgamma", P * 5), ("digamma", P * 5),
                      ("sinc", X), ("deg2rad", X * 90),
                      ("rad2deg", X), ("log_cosh", X * 10),
                      ("cummax", X), ("cummin", X)):
        add(name, arg)
    add("polygamma", np.ones((4, 6), np.float32), P * 3)
    add("igamma", P * 2, P * 3)
    add("igammac", P * 2, P * 3)
    add("betainc", P * 3, (1 - P) * 2 + 0.3, u(0.05, 0.95, 4, 6))
    add("nan_to_num", np.asarray([1.0, np.nan, np.inf, -np.inf], np.float32),
        nan=-1.0)
    add("softmin", X, axis=0)
    add("logaddexp", X, Y)
    add("logaddexp2", X, Y)
    add("hypot", X, Y)
    add("heaviside", np.round(X), np.float32(0.5))
    add("copysign", X, Y)
    add("fmod", X * 5, Y)
    add("xdivy", np.where(X > 0, X, 0).astype(np.float32), P)
    add("xlogy", np.where(X > 0, X, 0).astype(np.float32), P)
    add("xlog1py", np.where(X > 0, X, 0).astype(np.float32), P)
    add("lerp", X, Y, P)
    add("addcmul", X, Y, P, value=0.5)
    add("addcdiv", X, Y, P, value=0.5)
    add("polyval", [np.float32(2.0), np.float32(-1.0), np.float32(0.5)], X)
    add("absolute_difference", X, Y)
    add("nanmean", XN, dimensions=[1])
    add("nansum", XN, dimensions=[0, 1], keep_dims=True)
    add("nanmax", XN, dimensions=[1])
    add("nanmin", XN)
    add("percentile", X, np.asarray([10.0, 50.0, 95.0], np.float32),
        dimensions=[1], interpolation="midpoint")
    add("median", X, dimensions=[0, 1], keep_dims=True)
    add("quantile", X, np.float32(0.3), dimensions=[0])
    add("diff", X, n=2, axis=1)
    add("trapz", X, dx=0.5, axis=0)
    add("einsum", n(2, 3, 4), n(2, 4, 5), equation="bij,bjk->bik")
    # --------------------------------------------------------- linalg
    add("batched_gemm", n(2, 3, 4), n(2, 4, 5), alpha=2.0, beta=0.5,
        c=n(2, 3, 5))
    add("tensormmul", n(3, 4, 5), n(4, 5, 2), [1, 2], [0, 1])
    add("outer", X[0].copy(), Y[1].copy())
    add("cholesky", SPD)
    add("qr", n(5, 3))
    add("svd", n(5, 3), compute_uv=False)
    add("eigh", SPD)
    add("solve", SPD, n(4, 2))
    add("triangular_solve", np.tril(SPD), n(4, 2), lower=True, adjoint=True)
    add("lstsq", n(6, 3), n(6, 2))
    add("lu", SPD)
    add("matrix_inverse", SPD)
    add("pinv", n(5, 3))
    add("matrix_determinant", SPD)
    add("log_matrix_determinant", SQ)
    add("matrix_band_part", n(5, 6), 1, 2)
    add("tri", 3, m=5, k=1)
    add("triu", X, k=1)
    add("tril", X, k=-1)
    add("cross", n(5, 3), n(5, 3))
    add("kron", n(2, 3), n(3, 2))
    add("norm_fro", X)
    add("l2_normalize", X, axis=0)
    add("slogdet", SQ)
    add("matrix_power", SQ, 3)
    add("matrix_rank", np.outer(X[0], Y[0]).astype(np.float32))
    add("eigvalsh", SPD)
    add("expm", SQ * 0.3)
    add("cond_number", SPD)
    add("multi_dot", [n(3, 4), n(4, 5), n(5, 2)])
    add("adjoint", X)
    # ------------------------------------------------- declarable_tail
    add("l2_loss", X)
    add("sparse_softmax_cross_entropy", X, i32([0, 5, 2, 7]))
    add("invert_permutation", i32([2, 0, 3, 1, 4]))
    add("space_to_batch_nd", n(2, 4, 6, 3), [2, 3], [[0, 2], [1, 2]])
    add("batch_to_space_nd", n(12, 3, 3, 2), [2, 3], [[1, 0], [0, 2]])
    add("zeta", P * 3 + 1.5, P + 0.5)
    return c


def onnx_cases(seed: int = 0) -> Dict[str, Tuple[tuple, dict, str]]:
    """One call for each of the 40 names the ONNX-import slice registers
    (ROADMAP A10.2): ``ops/onnx_compat.py``, ``image.py`` and
    ``compression.py``; the same ``(args, kwargs, kind)`` form as
    :func:`cases`. Ties (hardmax, top-k, non-max suppression), exact
    halves for the quantizer's rounding, and slice ends past the axis are
    in on purpose."""
    r = np.random.default_rng(seed + 23)

    def n(*shape, scale=1.0):
        return (r.normal(size=shape) * scale).astype(np.float32)

    def u(lo, hi, *shape):
        return r.uniform(lo, hi, shape).astype(np.float32)

    def i32(v):
        return np.asarray(v, np.int32)

    X = n(4, 6)
    IMG = u(0, 1, 2, 8, 8, 3)
    c = {}

    def add(name, *args, kind="exact", **kw):
        c[name] = (args, kw, kind)

    big = 2 ** 63 - 1
    # ----------------------------------------------------- onnx_compat
    add("onnx_reshape", X, shape=[0, 3, -1])
    add("onnx_flatten", IMG, axis=2)
    add("onnx_slice", n(5, 6, 3), starts=[1, 5, -2], ends=[big, -big, 9],
        axes=[0, 1, -1], steps=[2, -2, 1])
    add("hardmax", np.round(X * 0.7), axis=0)
    add("shrink", X, lambd=0.5, bias=0.2)
    add("mean_variance_norm", n(2, 3, 5, 5))
    halves = (np.arange(-12, 12, dtype=np.float32) * 0.25).reshape(2, 3, 4)
    add("quantize_linear", halves * 40, np.asarray([0.5, 2.0, 1.0],
                                                   np.float32),
        np.asarray([3, -2, 0], np.int8), axis=1, qmin=-128, qmax=127)
    add("dequantize_linear", np.asarray(r.integers(-128, 128, (2, 3, 4)),
                                        np.int8),
        np.asarray([0.5, 0.25, 2.0], np.float32),
        np.asarray([1, -3, 0], np.int8), axis=1)
    add("grid_sample", n(2, 5, 6, 3), u(-1.2, 1.2, 2, 4, 7, 2))
    # ----------------------------------------------------------- image
    add("resize_bilinear", IMG, [13, 5])
    add("resize_nearest_neighbor", IMG, [5, 13])
    add("resize_bicubic", IMG, [11, 6])
    add("resize_area", IMG, [3, 5])
    add("crop_and_resize", IMG, np.asarray(
        [[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 1.0],
         [-0.1, 0.3, 0.5, 1.2]], np.float32), i32([1, 0, 1]), (4, 5))
    add("extract_image_patches", IMG, (3, 2), (2, 1), rates=(1, 2),
        padding="SAME")
    add("image_flip_left_right", IMG)
    add("image_flip_up_down", IMG)
    add("adjust_brightness", IMG, 0.1)
    add("adjust_contrast", IMG, 1.5)
    add("adjust_saturation", IMG, 0.6)
    add("adjust_hue", IMG, 0.3)
    add("rgb_to_hsv", IMG)
    add("hsv_to_rgb", u(0, 1, 2, 8, 8, 3))
    add("rgb_to_grayscale", IMG)
    add("rgb_to_yuv", IMG)
    add("yuv_to_rgb", IMG)
    lo = u(0, 6, 10, 2)
    boxes = np.concatenate([lo, lo + u(1, 4, 10, 2)], 1)[:, [0, 1, 2, 3]]
    scores = u(0, 1, 10)
    scores[7] = scores[2]
    add("non_max_suppression", boxes, scores, 6, iou_threshold=0.4,
        score_threshold=0.1)
    add("central_crop", u(0, 1, 2, 9, 8, 3), 0.5)
    add("per_image_standardization", IMG)
    add("image_gradients", IMG)
    add("sobel_edges", IMG)
    add("pad_to_bounding_box", IMG, 1, 2, 12, 11)
    add("crop_to_bounding_box", IMG, 1, 2, 5, 4)
    add("adjust_gamma", IMG, gamma=2.2, gain=1.1)
    add("image_translate", IMG, 2, -3)
    # ----------------------------------------------------- compression
    add("encode_threshold", X, 0.5)
    add("decode_threshold", np.asarray(r.integers(-1, 2, (4, 6)), np.int8),
        0.5)
    add("encode_topk", np.round(n(40) * 2) / 2, 7)
    add("decode_topk", i32([3, 0, 9, 3, -2, 40]), n(6), 12)
    add("adaptive_threshold", X, target_sparsity=0.1, current_threshold=0.5)
    return c

def to_port(a: Any, device, seed: int = 0):
    """A case argument for the port on ``device``: numpy arrays as tensors
    (64-bit narrowed), containers element by element, :data:`RNG` as
    ``seed``, :data:`ADAM` as the port's ``Adam(1e-3)``; anything else
    as it is."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.params import numpy_to_tensor_narrowed

    if isinstance(a, str) and a == RNG:
        return seed
    if isinstance(a, str) and a == ADAM:
        return Adam(1e-3)
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return numpy_to_tensor_narrowed(np.asarray(a)).to(device)
    if isinstance(a, dict) and "ops" not in a:
        return {k: to_port(v, device, seed) for k, v in a.items()}
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [to_port(v, device, seed) for v in a]
    return a


def flat_outputs(out) -> list:
    """An op's result as a flat list of tensors."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def as_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)
