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
             "import distkeras_torch.runtime.async_trainer, distkeras_torch.runtime.launcher\n"
             "import distkeras_torch.runtime.streaming, distkeras_torch.runtime.job_deployment\n"
             "import distkeras_torch.models.resnet, distkeras_torch.models.sequential\n"
             "import distkeras_torch.models.layers, distkeras_torch.data.loaders\n"
             "import distkeras_torch.examples, distkeras_torch.examples.workflow\n"
             "import distkeras_torch.examples.baseline, distkeras_torch.examples.streaming\n"
             "import distkeras_torch.examples.higgs_workflow\n"
             "import distkeras_torch.examples.lm_workflow, distkeras_torch.models.beam\n"
             "import distkeras_torch.models.speculative, distkeras_torch.data.colfile\n"
             "import distkeras_torch.data.text, distkeras_torch.observability\n"
             "import distkeras_torch.observability.health\n"
             "import distkeras_torch.observability.distributed\n"
             "import distkeras_torch.models.rnn, distkeras_torch.parallel.moe\n"
             "import distkeras_torch.parallel.mesh, distkeras_torch.parallel.lm\n"
             "import distkeras_torch.parallel.zero, distkeras_torch.parallel.pipeline\n"
             "import distkeras_torch.analysis.cli, distkeras_torch.analysis.lockset\n"
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


# the JAX package's public names that have no counterpart in the port yet,
# with the ROADMAP item that ports each
UNPORTED_NAMES = {}
# names the port leaves out by design (ROADMAP Queue C says why)
BY_DESIGN = {"pin_cpu_devices"}


def _jax_exports(relpath):
    """The public names a JAX package ``__init__`` exports, read from its
    source (no jax import): an ``_EXPORTS`` dict's keys, ``__all__``, or
    its ``from ... import`` names."""
    tree = ast.parse((ROOT / relpath).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            if any(getattr(t, "id", None) == "_EXPORTS" for t in node.targets):
                names |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Assign) and isinstance(node.value, (ast.List, ast.Tuple))
              and any(getattr(t, "id", None) == "__all__" for t in node.targets)):
            names |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("distkeras_tpu"):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_public_names_of_the_jax_package_resolve_on_the_port():
    import importlib

    checked = 0
    for pkg in ("", ".parallel", ".runtime", ".ops", ".data", ".models", ".observability"):
        relpath = "distkeras_tpu" + pkg.replace(".", "/") + "/__init__.py"
        port = importlib.import_module("distkeras_torch" + pkg)
        names = _jax_exports(relpath)
        assert names, relpath
        missing = sorted(n for n in names - set(UNPORTED_NAMES) - BY_DESIGN
                         if not hasattr(port, n))
        assert missing == [], f"distkeras_torch{pkg} lacks {missing}"
        checked += len(names)
        # an unported name that the port gained is taken off the list
        assert not [n for n in names & set(UNPORTED_NAMES) if hasattr(port, n)]
    assert checked > 60


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
from distkeras_torch.models.rnn import lstm_classifier_spec
from distkeras_torch.parallel import moe
moe_lm = small_lm_spec(vocab_size=11, model_dim=16, num_heads=2, num_layers=1, max_seq_len=8,
                       moe_experts=2)
calls += [lambda: Model.init(lstm_classifier_spec(vocab_size=5, seq_len=3)),
          lambda: moe.make_moe_train_step(moe.moe_classifier_spec(), get_optimizer("sgd")),
          lambda: moe.make_moe_lm_train_step(moe_lm, get_optimizer("sgd")),
          lambda: moe.moe_data_sharding(None),
          lambda: moe.moe_state_shardings(None, get_optimizer("sgd"), {})]
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
import os, tempfile
from distkeras_torch import Job, Punchcard, StreamingInferenceServer, resnet20_spec
from distkeras_torch.examples import baseline, higgs_workflow, lm_workflow, streaming, workflow
from distkeras_torch.runtime import job_deployment
from distkeras_torch import make_beam_search_fn, make_speculative_generate_fn
secret = os.path.join(tempfile.mkdtemp(), "secret")
with open(secret, "w") as f:
    f.write("s")
calls = [lambda: StreamingInferenceServer(cnn), lambda: Punchcard("s"),
         lambda: Job("127.0.0.1", 1, "s", "j", cnn.spec, data={"x": [0]}),
         lambda: Model.init(resnet20_spec()),
         lambda: workflow.main([]), lambda: baseline.main(["--config", "1"]),
         lambda: higgs_workflow.main([]), lambda: streaming.main([]),
         lambda: job_deployment.main(["--secret-file", secret, "--port", "0"]),
         lambda: make_beam_search_fn(spec, 2), lambda: make_speculative_generate_fn(spec, spec, 2),
         lambda: lm_workflow.main([])]
for i, call in enumerate(calls):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit(f"entry point {i} ran without a CUDA device")
server = StreamingInferenceServer(cnn, max_batch=2, device="cpu")
assert server.device.type == "cpu" and server.output_shape == (10,)
assert Punchcard("s", device="cpu").device.type == "cpu"
print("ok")
"""
    r = _run(code, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr
