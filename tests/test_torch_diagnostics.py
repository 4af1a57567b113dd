"""The diagnostic keys of the port's CLI on the CPU (counterparts of the JAX
package's ``main.py``): ``train.debug_nans`` raises ``FloatingPointError``
at an injected NaN loss and leaves anomaly mode off after the run;
``train.profile`` writes a Chrome trace of the run; the dispatch trace
writes matched BEGIN/END lines for an epoch's steps, the loss sync, each
evaluation and each state save into ``SSLREC_TRACE_FILE`` (under
``train.trace_sync`` too), and the CLI's default file lands under
``runs_torch/`` of the working directory with the variable left unset."""

import json
import os

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.models.general_cf import lightgcn
from sslrec_tpu_torch.utils import dispatch_trace
from test_torch_main import _toy_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


def _run(tmp_path, *sets, epochs=2):
    return tmain.main(["--model", "lightgcn", "--data_dir", str(tmp_path), "--dataset", "toy",
                       "--device", "cpu", "--epoch", str(epochs), "--set", "train.batch_size=128",
                       "--set", f"train.results_dir={tmp_path / 'res'}",
                       *[a for s in sets for a in ("--set", s)]])


@pytest.fixture
def toy(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SSLREC_TRACE_FILE", raising=False)
    dispatch_trace.reset()
    yield tmp_path
    dispatch_trace.reset()


def test_debug_nans_raises_at_a_nan_loss(toy, monkeypatch):
    loss = lightgcn.LightGCN.loss

    def nan_loss(self, batch, key):
        value, aux = loss(self, batch, key)
        return value + (float("nan") if batch["step"] == 2 else 0.0), aux

    monkeypatch.setattr(lightgcn.LightGCN, "loss", nan_loss)
    with pytest.raises(FloatingPointError, match="step 2"):
        _run(toy, "train.debug_nans=true")
    assert not torch.is_anomaly_enabled()
    _run(toy, epochs=1)             # without the key, the NaN trains on


def test_profile_writes_a_chrome_trace(toy):
    _run(toy, f"train.profile={toy / 'prof'}", epochs=1)
    files = list((toy / "prof").glob("lightgcn_toy_*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def _pairs(path):
    begins, ends = [], []
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        _, kind, tag = line.split(" ", 3)[:3]
        (begins if kind == "BEGIN" else ends).append(tag)
    return begins, ends


@pytest.mark.parametrize("sync", [False, True])
def test_trace_file_has_matched_marks(toy, monkeypatch, sync):
    path = toy / "trace" / "t.log"
    monkeypatch.setenv("SSLREC_TRACE_FILE", str(path))
    _run(toy, "train.save_state_every=1", "train.test_step=1",
         f"train.trace_sync={str(sync).lower()}")
    dispatch_trace.reset()
    begins, ends = _pairs(path)
    assert begins == ends
    for e in (0, 1):
        for tag in ("whole_epoch", "losses_sync", "eval", "save_state"):
            assert f"ep{e}.{tag}" in begins
    assert os.environ["SSLREC_TRACE_FILE"] == str(path)     # a set variable is kept


def test_cli_default_trace_file(toy):
    _run(toy, epochs=1)
    logs = list((toy / "runs_torch").glob("dispatch_trace_*.log"))
    assert len(logs) == 1 and _pairs(logs[0])[0] == ["ep0.whole_epoch", "ep0.losses_sync",
                                                       "ep0.eval"]
    assert "SSLREC_TRACE_FILE" not in os.environ
    assert np.isfinite(json.loads((toy / "res" / "lightgcn_toy.json").read_text())
                       ["trajectory"][0]["loss"]["loss"])
