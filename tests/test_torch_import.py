"""The PyTorch port stands alone: no JAX, no distkeras_tpu, and no silent
CPU fallback for its entry points."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distkeras_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distkeras_tpu")


def _run(code: str, **env):
    full_env = dict(os.environ, **env)
    full_env["PYTHONPATH"] = str(ROOT) + os.pathsep + full_env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out_of_sys_modules():
    r = _run("import sys, distkeras_torch, distkeras_torch.bridge\n"
             "import distkeras_torch.ops.decode_step, distkeras_torch.ops.flash_attention\n"
             "import distkeras_torch.ops.losses, distkeras_torch.ops.optimizers\n"
             "import distkeras_torch.parallel, distkeras_torch.parallel.engine\n"
             "import distkeras_torch.parallel.algorithms, distkeras_torch.trainers\n"
             "import distkeras_torch.data, distkeras_torch.utils\n"
             "import distkeras_torch.models.mlp, distkeras_torch.models.cnn\n"
             "import distkeras_torch.checkpoint, distkeras_torch.evaluators\n"
             "import distkeras_torch.predictors, distkeras_torch.runtime\n"
             "import distkeras_torch.runtime.networking, distkeras_torch.runtime.native\n"
             "import distkeras_torch.runtime.parameter_server\n"
             "import distkeras_torch.runtime.async_trainer\n"
             f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
             "print(bad)\n"
             "sys.exit(1 if bad else 0)")
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    return sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py"))


@pytest.mark.parametrize("relpath", _sources())
def test_source_imports_nothing_of_jax(relpath):
    tree = ast.parse((ROOT / relpath).read_text(), filename=relpath)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{relpath}:{node.lineno} imports {name}"


def test_entry_points_raise_without_cuda():
    """Without a card every entry point raises unless device='cpu' is passed;
    CUDA_VISIBLE_DEVICES hides any card this machine may have."""
    code = """
import torch
from distkeras_torch import (ADAG, Model, SingleTrainer, generate, make_generate_fn,
                             make_lm_train_step, mnist_cnn_spec, small_lm_spec)
from distkeras_torch.data import prefetch_to_device
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_torch.models.decode import init_cache
from distkeras_torch.platform import default_device
assert not torch.cuda.is_available()
spec = small_lm_spec(vocab_size=11, model_dim=16, num_heads=2, num_layers=1, max_seq_len=8)
calls = [lambda: default_device(), lambda: Model.init(spec),
         lambda: make_generate_fn(spec, 2), lambda: init_cache(spec.config, 1, 4),
         lambda: params_from_jax({}, spec),
         lambda: make_lm_train_step(spec, get_optimizer("sgd")),
         lambda: Model.init(mnist_cnn_spec()), lambda: SingleTrainer(mnist_cnn_spec()),
         lambda: ADAG(mnist_cnn_spec()), lambda: prefetch_to_device(iter([]))]
model = Model.init(spec, device="cpu")
calls.append(lambda: generate(model, [[1, 2]], 2))
for i, call in enumerate(calls):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit(f"call {i} ran without a CUDA device")
out = generate(model, [[1, 2]], 2, device="cpu")
assert out.shape == (1, 2) and out.device.type == "cpu"
cnn = Model.init(mnist_cnn_spec(), device="cpu")
from distkeras_torch import AccuracyEvaluator, AsyncADAG, AsyncAEASGD, ModelPredictor
from distkeras_torch.evaluators import ConfusionMatrixEvaluator
calls = [lambda: SingleTrainer(cnn), lambda: ADAG(cnn), lambda: Model.deserialize(cnn.serialize()),
         lambda: AsyncADAG(cnn), lambda: AsyncAEASGD(mnist_cnn_spec()),
         lambda: ModelPredictor(cnn), lambda: AccuracyEvaluator(),
         lambda: ConfusionMatrixEvaluator(10)]
for i, call in enumerate(calls):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit(f"trainer call {i} ran without a CUDA device")
assert SingleTrainer(cnn, device="cpu").model.device.type == "cpu"
assert ADAG(cnn, device="cpu").num_workers == 1
assert AsyncADAG(cnn, device="cpu").model.device.type == "cpu"
assert ModelPredictor(cnn, device="cpu").device.type == "cpu"
assert AccuracyEvaluator(device="cpu").device.type == "cpu"
assert Model.deserialize(cnn.serialize(), device="cpu").params.keys() == cnn.params.keys()
assert list(prefetch_to_device(iter([(0,)]), device="cpu"))[0][0].device.type == "cpu"
print("ok")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr
