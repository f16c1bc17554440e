"""The port's examples, each ``main`` with ``--cpu`` at small sizes, as
``tests/test_job_deployment.py`` drives the JAX Higgs walkthrough; and
``baseline.run_config`` against the JAX runner's record.  The loaders'
synthetic stand-ins are generated at 1024 + 256 rows here (their full
sizes hold 10**8 pixels); ``HOME`` and the working directory move into the
case's ``tmp_path`` so that no cache of the machine is read and nothing is
written beside the checkout."""

import json

import numpy as np
import pytest
import torch

from distkeras_torch.data import loaders as tl
from distkeras_torch.examples import baseline as tbaseline, run_device
from distkeras_torch.examples import higgs_workflow, lm_workflow, streaming, workflow
from distkeras_tpu.data import loaders as jl


@pytest.fixture
def small_data(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("DKT_DATA_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    for mod in (jl, tl):
        real = mod._synthetic_images

        def small(num_classes, shape, n_train, n_test, seed, _real=real, **kw):
            return _real(num_classes, shape, 1024, 256, seed, **kw)

        monkeypatch.setattr(mod, "_synthetic_images", small)
    return tmp_path


def test_run_device_reads_the_cpu_flag():
    assert run_device(4) == (torch.device("cpu"), 4)
    assert run_device(4, 2) == (torch.device("cpu"), 2)


@pytest.mark.parametrize("trainer", ["single", "adag", "async-adag"])
def test_workflow_main(trainer, capsys):
    workflow.main(["--trainer", trainer, "--cpu", "4", "--epochs", "3"])
    out = capsys.readouterr().out
    assert out.startswith("devices: [device(type='cpu')]")
    acc = float(out.split("test accuracy: ")[1].split()[0])
    assert acc >= 0.9


def test_lm_workflow_main(capsys):
    """Train, then greedy, beam-4 and self-draft speculative decoding, on
    the CPU at the JAX example's defaults; it exits 1 when the loss does
    not fall, the continuation is under half right or the speculative
    decode parts from the greedy one."""
    lm_workflow.main(["--cpu", "1"])
    out = capsys.readouterr().out
    assert out.startswith("devices: 1 x cpu (global batch 1 x 64)")
    first, last = map(float, out.split("\nloss ")[1].split()[::2][:2])
    assert last < first
    assert float(out.split("continuation accuracy: ")[1].split()[0]) >= 0.5
    assert "beam-4 best scores: [" in out
    assert float(out.split("vs greedy agreement: ")[1].split()[0]) >= 0.9


def test_streaming_main(capsys):
    streaming.main(["--cpu", "1", "--events", "640", "--micro-batch", "64"])
    out = capsys.readouterr().out
    assert "streamed 640 events" in out
    assert float(out.split("accuracy ")[-1].split()[0]) >= 0.9


def test_higgs_workflow_main(capsys):
    higgs_workflow.main(["--cpu", "4", "--rows", "1536", "--epochs", "4", "--workers", "4"])
    out = capsys.readouterr().out
    assert "workflow OK" in out and "punchcard round trip: fetched model acc" in out


def test_baseline_record_has_the_jax_keys(small_data):
    from distkeras_tpu.examples import baseline as jbaseline

    rec = tbaseline.run_config(1, epochs_cap=1, device="cpu")
    want = jbaseline.run_config(1, epochs_cap=1)
    assert list(rec) == list(want)
    assert rec["platform"] == "cpu" and rec["chips"] == 1 and rec["epochs_run"] == 1
    assert rec["data"] == want["data"] == "synthetic" and rec["target"] == want["target"]
    assert rec["samples_per_sec_per_chip_steady"] > 0
    assert 0.0 <= rec["accuracy"][0] <= 1.0 and np.isfinite(rec["final_loss"])


def test_baseline_train_rows_cut_the_training_set(small_data):
    """``train_rows`` trains on the first rows only: every epoch (the
    capped one and the record's steady-rate one) has their minibatches."""
    rec, tr = tbaseline.run_config(1, epochs_cap=1, device="cpu", train_rows=512,
                                   return_trainer=True)
    assert rec["epochs_run"] == 1 and len(tr.history) == 2 * 512 // rec["batch_size"]
    assert rec["samples_per_sec_per_chip_steady"] > 0


def test_baseline_main_writes_only_out(small_data):
    out = small_data / "records.json"
    code = 0
    try:
        tbaseline.main(["--config", "1", "--cpu", "1", "--epochs-cap", "1",
                        "--out", str(out)])
    except SystemExit as e:        # a missed target exits 1, as the JAX runner
        code = e.code
    records = json.loads(out.read_text())
    assert code == (0 if records[0]["target_reached"] else 1)
    assert [r["config"] for r in records] == [1]
    assert sorted(p.name for p in small_data.iterdir()) == ["records.json"]
