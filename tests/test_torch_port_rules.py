"""PyTorch port, ground rules: ``deeplearning4j_tpu_torch`` and
``chip_smoke.py`` never import JAX or the JAX package, and the port's
entry points run on the CPU only when the caller asks for it.

The name ``deeplearning4j_tpu_torch`` starts with ``deeplearning4j_tpu``,
so every check below matches the JAX package by its exact name or its
name followed by a dot, never by a bare prefix.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deeplearning4j_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_prefix_trap_is_not_matched():
    assert not _forbidden("deeplearning4j_tpu_torch")
    assert not _forbidden("deeplearning4j_tpu_torch.ops.native")
    assert _forbidden("deeplearning4j_tpu")
    assert _forbidden("deeplearning4j_tpu.common.serde")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_free")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_ast_scan_sees_every_import_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "from deeplearning4j_tpu.common import serde\n"
                   "def f():\n    from jax import lax\n"
                   "from . import sibling\n")
    assert [m for m in _imports(str(src)) if _forbidden(m)] == [
        "jax.numpy", "deeplearning4j_tpu.common", "jax"]


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port and
    ``chip_smoke.py`` (its imports; main() runs only as a script), then
    checks ``sys.modules``."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r}))
print(len(names), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(n) >= 16, out.stdout       # every module was imported
    assert bad == "[]", f"the port loaded {bad}"


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from deeplearning4j_tpu_torch.models.gpt import (
        CausalLM, init_params_numpy, params_from_jax)
    from deeplearning4j_tpu_torch.models.transformer import tiny_config
    from deeplearning4j_tpu_torch.serving.engine import DecodeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(vocab=13, max_len=16, d_model=16, n_layers=1,
                      n_heads=2, d_ff=32)
    tree = init_params_numpy(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree)
    params = params_from_jax(tree, device="cpu")
    model = CausalLM(cfg, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, params, slots=1, page_size=4)
    with DecodeEngine(model, params, slots=1, page_size=4,
                      device="cpu") as eng:
        assert eng.device == torch.device("cpu")
        assert len(eng.generate(np.array([1, 2, 3], np.int32), 2)) == 2


def test_training_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    """The encoder's and the classifier's parameters land on the card
    unless the caller names the CPU; so does everything the flat train
    step builds from them."""
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.models.bert_classifier import (
        BertSequenceClassifier)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerEncoder, tiny_config)
    from deeplearning4j_tpu_torch.params import FlatParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(vocab=16, max_len=8, d_model=16, n_layers=1,
                      n_heads=2, d_ff=32)
    enc = TransformerEncoder(cfg, attn_impl="flash")
    clf = BertSequenceClassifier(cfg, 2, attn_impl="flash")
    for init in (enc.init_params, clf.init_params):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init()
    flat = FlatParams(enc.init_params(device="cpu"))
    assert flat.master.device == torch.device("cpu")
    upd = Adam(1e-3)
    opt = upd.init_state(flat.master)
    assert opt["m"].device == torch.device("cpu")
    ids = torch.zeros(2, 8, dtype=torch.long)
    mask_pos = torch.zeros(2, 8)
    mask_pos[:, 1] = 1.0
    loss = enc.make_train_step(upd)(flat, opt, 0, ids, ids, mask_pos)
    assert loss.device == torch.device("cpu") and torch.isfinite(loss)
    assert clf.init_params(device="cpu")["classifier"]["W"].shape == (16, 2)


def test_layer_framework_entry_points_refuse_the_cpu_unless_asked(
        monkeypatch, tmp_path):
    """``MultiLayerNetwork``, the zoo, the zip reader and the weight bridge
    land on the card unless the caller names the CPU; ``lstm_layer`` runs
    where its tensors are, the plain version on CPU tensors (no launch),
    and refuses any other device."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lstm_recurrence as lr
    from deeplearning4j_tpu_torch.ops.nn import lstm_layer
    from deeplearning4j_tpu_torch.params import mln_params_from_numpy
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zoo = TextGenerationLSTM(vocab_size=5, hidden=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(zoo.conf())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mln_params_from_numpy([{"W": np.zeros((2, 2), np.float32)}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelSerializer.restoreMultiLayerNetwork(
            str(tmp_path / "absent.zip"))
    net = zoo.init(device="cpu")
    assert net.device == torch.device("cpu")
    before = (lr.fwd_launches, lr.bwd_launches)
    x = np.eye(5, dtype=np.float32)[np.arange(6).reshape(2, 3) % 5]
    net.fit(x, x)
    assert net.output(x).device == torch.device("cpu")
    assert net.rnnTimeStep(x[:, 0]).shape == (2, 5)
    ys, _ = lstm_layer(torch.zeros(2, 3, 5), torch.zeros(5, 16),
                       torch.zeros(4, 16), torch.zeros(16))
    assert ys.shape == (2, 3, 4)
    assert (lr.fwd_launches, lr.bwd_launches) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_layer(torch.zeros(2, 3, 5, device="meta"),
                   torch.zeros(5, 16, device="meta"),
                   torch.zeros(4, 16, device="meta"),
                   torch.zeros(16, device="meta"))


def test_by_name_entry_points_refuse_the_cpu_unless_asked(monkeypatch,
                                                          tmp_path):
    """``Nd4j``'s constructors and ``SameDiff`` (built or loaded) land on
    the card unless the caller names the CPU; an op by name runs where its
    tensors are, the plain version on CPU tensors (no launch)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.ops import conv_bn_stats as cb
    from deeplearning4j_tpu_torch.ops import residual_tail as rt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Nd4j.zeros(2), lambda: Nd4j.ones(2),
                 lambda: Nd4j.create([1.0]), lambda: Nd4j.rand(2),
                 lambda: Nd4j.randn(2), SameDiff, SameDiff.create):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    sd = SameDiff.create(device="cpu")
    sd.var("w", np.ones((2, 2), np.float32))
    path = str(tmp_path / "g.zip")
    sd.save(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff.load(path)
    assert SameDiff.load(path, device="cpu").device == torch.device("cpu")
    before = (cb.launches_1x1, cb.launches_3x3, rt.launches)
    y, _, _ = Nd4j.exec("conv1x1_bn_stats", torch.ones(2, 4), torch.ones(4, 3))
    c = torch.ones(3)
    out = Nd4j.exec("bn_relu_residual", y, y, c, c, c, c)
    assert out.device == torch.device("cpu")
    assert (cb.launches_1x1, cb.launches_3x3, rt.launches) == before
