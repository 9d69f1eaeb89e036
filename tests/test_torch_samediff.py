"""PyTorch port, SameDiff by name: ``deeplearning4j_tpu_torch/autodiff``
(``samediff.py``, ``serde.py``, ``ops_math.py``) against
``deeplearning4j_tpu/autodiff`` on the same numpy arrays at f32.

- A ResNet-50 identity bottleneck block (conv1x1_bn_stats, batch_norm,
  relu, cast, conv3x3_bn_stats, bn_relu_residual) at N=2, 8x8, widths
  32/8: the port's graph on the CPU (the plain versions) against the JAX
  graph (the Pallas bodies through the interpreter): 1e-4 of max(1,
  max |out|) for values downstream of the single-pass variances (their
  cancellation loses digits that three normalisations carry forward),
  1e-5 for the first conv's y and mean.
- Gradients of ``calculateGradients`` against JAX's: 1e-5 of max |grad|
  (f32 sums in another order); a gradient through B4 raises in both.
- Zips written by either package load in the other, ops and arrays
  included.
- The operators and reductions that ``SDVariable`` emits: 1e-6.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff, VariableType


def _block_weights(c=32, mid=8, seed=0):
    rs = np.random.RandomState(seed)
    w = {"w2a": rs.randn(c, mid) * np.sqrt(2.0 / c),
         "w2b": rs.randn(3, 3, mid, mid) * np.sqrt(2.0 / (9 * mid)),
         "w2c": rs.randn(mid, c) * np.sqrt(2.0 / mid)}
    for tag, width in (("2a", mid), ("2b", mid), ("2c", c)):
        w[f"g{tag}"] = 1.0 + 0.1 * rs.randn(width)
        w[f"b{tag}"] = 0.1 * rs.randn(width)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _block(SD, weights, c=32, **kw):
    """The same graph in either package (the calls are the same API)."""
    sd = SD.create(**kw)
    x = sd.placeholder("x", shape=(None, None, None, c), dtype="float32")
    v = {k: sd.var(k, a) for k, a in weights.items()}
    h = x
    for tag, op in (("2a", "conv1x1_bn_stats"), ("2b", "conv3x3_bn_stats")):
        y, m, var = sd.invoke_op(op, [h, v[f"w{tag}"]], n_out=3,
                                 name=f"conv{tag}")
        a = sd.nn.batch_norm(y, v[f"g{tag}"], v[f"b{tag}"], m, var,
                             name=f"bn{tag}")
        h = sd.math.cast(sd.nn.relu(a, name=f"relu{tag}"), dtype="float32",
                         name=f"cast{tag}")
    y, m, var = sd.invoke_op("conv1x1_bn_stats", [h, v["w2c"]], n_out=3,
                             name="conv2c")
    out = sd.nn.bn_relu_residual(y, x, m, var, v["g2c"], v["b2c"], name="out")
    sd.setLossVariables(out)
    return sd


def _jax_sd():
    import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JaxSameDiff

    return JaxSameDiff


def _x(seed=1, shape=(2, 8, 8, 32)):
    return np.maximum(np.random.RandomState(seed).randn(*shape),
                      0).astype(np.float32)


def _close_rel(got, want, tol, floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err:.3e} > {tol:g} x {scale:.3e}"


# ------------------------------------------------------- the identity block
def test_identity_block_matches_jax():
    JSD = _jax_sd()
    w, x = _block_weights(), _x()
    names = ["out", "conv2a:0", "conv2a:1", "conv2a:2", "conv2b:2", "bn2b"]
    want = _block(JSD, w).output({"x": x}, names)
    got = _block(SameDiff, w, device="cpu").output({"x": x}, names)
    for n in names:
        assert tuple(got[n].shape) == tuple(want[n].shape), n
        assert got[n].dtype == torch.float32
    _close_rel(got["conv2a:0"], want["conv2a:0"], 1e-5)
    _close_rel(got["conv2a:1"], want["conv2a:1"], 1e-5, floor=1.0)
    for n in ("conv2a:2", "conv2b:2", "bn2b", "out"):
        _close_rel(got[n], want[n], 1e-4, floor=1.0)


def test_identity_block_gradients_match_jax_and_b4_refuses():
    """Gradients of the block's last gamma and beta (through B3 only)
    equal JAX's; a gradient that crosses B4 raises in both packages."""
    JSD = _jax_sd()
    w, x = _block_weights(seed=2), _x(seed=3)
    jsd = _block(JSD, w)
    tsd = _block(SameDiff, w, device="cpu")
    want = jsd.calculateGradients({"x": x}, wrt=["g2c", "b2c"])
    got = tsd.calculateGradients({"x": x}, wrt=["g2c", "b2c"])
    for n in ("g2c", "b2c"):
        _close_rel(got[n], want[n], 1e-5)
        assert tsd.getVariable(n).gradient() is got[n]
        assert tsd.grad(n) is got[n]
    with pytest.raises(Exception):
        jsd.calculateGradients({"x": x}, wrt=["w2a"])
    with pytest.raises(RuntimeError, match="conv1x1_bn_stats is forward-only"):
        tsd.calculateGradients({"x": x}, wrt=["w2a", "g2c"])
    # w2b's path back from the loss crosses conv2c (a 1x1) first
    with pytest.raises(RuntimeError, match="_bn_stats is forward-only"):
        tsd.calculateGradients({"x": x}, wrt=["w2b"])


def test_jax_saved_block_loads_in_the_port(tmp_path):
    JSD = _jax_sd()
    w, x = _block_weights(seed=4), _x(seed=5)
    jsd = _block(JSD, w)
    path = str(tmp_path / "jax_block.zip")
    jsd.save(path)
    tsd = SameDiff.load(path, device="cpu")
    assert tsd.variableNames() == jsd.variableNames()
    assert [n.op_name for n in tsd._ops] == [n.op_name for n in jsd._ops]
    assert tsd.getLossVariables() == ["out"]
    for k, a in w.items():
        np.testing.assert_array_equal(tsd.getVariable(k).getArr().numpy(), a)
    want = np.asarray(jsd.output({"x": x}, ["out"])["out"])
    _close_rel(tsd.output({"x": x}, ["out"])["out"], want, 1e-4, floor=1.0)
    assert tsd.summary() == jsd.summary()


def test_port_saved_block_loads_in_jax(tmp_path):
    JSD = _jax_sd()
    w, x = _block_weights(seed=6), _x(seed=7)
    tsd = _block(SameDiff, w, device="cpu")
    path = str(tmp_path / "port_block.zip")
    tsd.save(path)
    jsd = JSD.load(path)
    assert jsd.variableNames() == tsd.variableNames()
    for k, a in w.items():
        np.testing.assert_array_equal(np.asarray(jsd._arrays[k]), a)
    want = np.asarray(jsd.output({"x": x}, ["out"])["out"])
    got = tsd.output({"x": x}, ["out"])["out"]
    _close_rel(got, want, 1e-4, floor=1.0)
    again = SameDiff.load(path, device="cpu").output({"x": x}, ["out"])["out"]
    assert torch.equal(again, got)


def test_bf16_arrays_cross_from_jax(tmp_path):
    """The JAX writer stores bf16 arrays as 2-byte void (``ml_dtypes``);
    the port reads them back bit for bit through graph.json's dtype, and
    writes them the same way."""
    import jax.numpy as jnp

    JSD = _jax_sd()
    rs = np.random.RandomState(8)
    a = rs.randn(8, 4).astype(np.float32)
    jsd = JSD.create()
    jsd.var("w", jnp.asarray(a, jnp.bfloat16))
    path = str(tmp_path / "bf16.zip")
    jsd.save(path)
    tsd = SameDiff.load(path, device="cpu")
    got = tsd.getVariable("w").getArr()
    assert got.dtype == torch.bfloat16 and tsd.getVariable("w").dtype == \
        "bfloat16"
    want = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    path2 = str(tmp_path / "bf16_port.zip")
    tsd.save(path2)
    import io
    import zipfile
    with zipfile.ZipFile(path) as za, zipfile.ZipFile(path2) as zb:
        ja = np.load(io.BytesIO(za.read("arrays.npz")))["w"]
        pa = np.load(io.BytesIO(zb.read("arrays.npz")))["w"]
    assert ja.dtype.kind == pa.dtype.kind == "V"
    assert ja.tobytes() == pa.tobytes()


# ------------------------------------------------ operators and reductions
def _ops_graph(SD, **kw):
    rs = np.random.RandomState(9)
    sd = SD.create(**kw)
    x = sd.placeholder("x", shape=(None, 4))
    w = sd.var("w", rs.randn(4, 3).astype(np.float32))
    b = sd.var("b", rs.randn(3).astype(np.float32))
    h = x @ w + b
    h2 = (2.0 - h) * 0.5 / (h * h + 1.0)
    h3 = 1.0 / (-h2 + 3.0) ** 2.0
    outs = {
        "h3": h3,
        "sum": h3.sum(1), "mean": h3.mean(), "max": h3.max(0, keep_dims=True),
        "min": h3.min(1), "std": h3.std(True, 0), "norm2": h3.norm2(1),
        "argmax": h3.argmax(1), "gt": h3 > 0.1, "le": h3 <= 0.1,
        "reshape": h3.reshape(-1), "transpose": h3.transpose(1, 0),
        "dot": h3.mmul(sd.constant("k", np.ones((3, 2), np.float32))),
        "div": h3.div(b), "sub": h3.sub(b), "mul": h3.mul(b),
        "add": h3.add(b), "rsub": 1.5 - h3, "lt": h3 < 0.2, "ge": h3 >= 0.2,
    }
    loss = (h3 * h3).sum()
    sd.setLossVariables(loss)
    return sd, {k: v.name for k, v in outs.items()}


def test_operators_and_reductions_match_jax():
    JSD = _jax_sd()
    x = np.random.RandomState(10).randn(5, 4).astype(np.float32)
    jsd, jn = _ops_graph(JSD)
    tsd, tn = _ops_graph(SameDiff, device="cpu")
    assert jn == tn
    want = jsd.output({"x": x}, list(jn.values()))
    got = tsd.output({"x": x}, list(tn.values()))
    for k, n in tn.items():
        g, wv = got[n], np.asarray(want[n])
        assert tuple(g.shape) == wv.shape, k
        if wv.dtype == np.bool_:
            np.testing.assert_array_equal(g.numpy(), wv, err_msg=k)
        elif k == "argmax":
            np.testing.assert_array_equal(g.numpy(), wv, err_msg=k)
        else:
            np.testing.assert_allclose(g.numpy(), wv, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    jg = jsd.calculateGradients({"x": x})
    tg = tsd.calculateGradients({"x": x})
    assert set(jg) == set(tg) == {"w", "b"}
    for n in jg:
        _close_rel(tg[n], jg[n], 1e-5)


def test_unreached_variables_get_zero_gradients_as_in_jax():
    JSD = _jax_sd()
    x = np.ones((2, 3), np.float32)
    grads = []
    for SD, kw in ((JSD, {}), (SameDiff, {"device": "cpu"})):
        sd = SD.create(**kw)
        xp = sd.placeholder("x", shape=(None, 3))
        w = sd.var("w", np.full((3,), 2.0, np.float32))
        sd.var("unused", np.zeros((4,), np.float32))
        sd.setLossVariables((xp * w).sum(), (w * w).mean())
        grads.append(sd.calculateGradients({"x": x}))
    for n in ("w", "unused"):
        np.testing.assert_allclose(np.asarray(grads[1][n]),
                                   np.asarray(grads[0][n]), rtol=1e-6)


def test_graph_bookkeeping_matches_jax():
    JSD = _jax_sd()
    seen = []
    for SD, kw in ((JSD, {}), (SameDiff, {"device": "cpu"})):
        sd = SD.create(**kw)
        x = sd.placeholder("x", shape=(-1, 2))
        c = sd.constant("c", np.array([1.0, 2.0], np.float32))
        y = (x + c).rename("y")
        z = sd.math.neg(y, name="z")
        sd.math.identity(z)
        sd.convertConstantsToVariables("c")
        with pytest.raises(ValueError):
            sd.convertConstantsToVariables("c")
        with pytest.raises(ValueError, match="not a placeholder"):
            sd.output({"c": np.zeros(2, np.float32)}, ["z"])
        with pytest.raises(AttributeError, match="no registered op"):
            sd.nn.no_such_op
        sd.getVariable("c").setArray(np.array([3.0, 4.0], np.float32))
        out = sd.output({"x": np.ones((1, 2), np.float32)}, ["z"])["z"]
        seen.append((sd.variableNames(), sd.trainable_names(),
                     sd.getVariable("x").shape, sd.getVariable("c").vtype.value,
                     sd.summary(), np.asarray(out).tolist(),
                     [n.op_name for n in sd._prune(("z",))]))
    assert seen[0] == seen[1]


def test_unported_members_raise_naming_themselves():
    sd = SameDiff.create(device="cpu")
    for name, call in (("ifCond", lambda: sd.ifCond(None, [], None, None)),
                       ("whileLoop", lambda: sd.whileLoop([], None, None)),
                       ("fit", lambda: sd.fit(None)),
                       ("evaluate", lambda: sd.evaluate(None, "y")),
                       ("to_stablehlo", lambda: sd.to_stablehlo({}, [])),
                       ("setTrainingConfig",
                        lambda: sd.setTrainingConfig(None))):
        with pytest.raises(NotImplementedError, match=f"SameDiff.{name}"):
            call()


def test_feeds_and_variables_live_on_the_graph_device():
    sd = SameDiff.create(device="cpu")
    v = sd.var("v", np.arange(3, dtype=np.float64))
    assert v.dtype == "float32"            # jnp.asarray narrows float64
    x = sd.placeholder("x", shape=(3,))
    out = sd.outputSingle({"x": [1, 2, 3]}, x * v)
    assert out.device == torch.device("cpu")
    assert out.tolist() == [0.0, 2.0, 6.0]
    assert sd.getVariable("x").vtype is VariableType.PLACEHOLDER


# ---------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_block_matches_cpu_and_launches_each_kernel():
    """The f32 block on the card (the kernels) against the CPU (the plain
    versions): 1e-4 of max(1, max |out|); one output launches B4a twice,
    B4b and B3 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    w, x = _block_weights(seed=11), _x(seed=12)
    cpu = _block(SameDiff, w, device="cpu").output({"x": x}, ["out"])["out"]
    card = _block(SameDiff, w, device="cuda")
    before = (cb.launches_1x1, cb.launches_3x3, rt.launches)
    got = card.output({"x": x}, ["out"])["out"]
    torch.cuda.synchronize()
    after = (cb.launches_1x1, cb.launches_3x3, rt.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 1, 1)
    assert got.device.type == "cuda"
    _close_rel(got.cpu(), cpu, 1e-4, floor=1.0)
    grads = card.calculateGradients({"x": x}, wrt=["g2c", "b2c"])
    want = _block(SameDiff, w, device="cpu").calculateGradients(
        {"x": x}, wrt=["g2c", "b2c"])
    for n in want:
        _close_rel(grads[n].cpu(), want[n], 1e-4)
