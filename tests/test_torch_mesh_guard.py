"""``train.mesh`` and ``train.distributed`` in the port
(``sslrec_tpu_torch/parallel/mesh.py``): a mesh of one device trains (absent,
empty, 1×1, and ``{model: 1}``, whose data axis fills the CPU's one device);
a mesh of more than one device, or one that ``make_mesh`` cannot lay out,
``train.distributed`` and the variables of a multi-host run raise
``NotImplementedError`` before any data is read."""

import numpy as np
import pytest

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.parallel import mesh
from test_torch_main import _toy_split


def _run(root, *sets):
    return tmain.main(["--model", "lightgcn", "--data_dir", str(root), "--dataset", "toy",
                       "--device", "cpu", "--epoch", "1", "--set", "train.batch_size=128",
                       "--set", f"train.results_dir={root / 'res'}",
                       *[a for s in sets for a in ("--set", s)]])


@pytest.fixture
def toy(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    for var in ("SSLREC_COORDINATOR", "SSLREC_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


@pytest.mark.parametrize("sets", [(), ("train.mesh={}",),
                                  ("train.mesh.data=1", "train.mesh.model=1"),
                                  ("train.mesh.model=1",)])
def test_a_mesh_of_one_device_trains(toy, sets):
    trainer = _run(toy, *sets)
    assert np.isfinite(trainer.recorder.epochs[0]["loss"]["loss"])


@pytest.mark.parametrize("sets", [("train.mesh.data=2",), ("train.mesh.model=2",),
                                  ("train.mesh.data=1", "train.mesh.model=4"),
                                  ("train.distributed.coordinator=localhost:1234",
                                   "train.distributed.num_processes=2",
                                   "train.distributed.process_id=0"),
                                  ("train.distributed.enable=true",)])
def test_more_than_one_device_raises(toy, sets):
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        _run(toy, *sets)
    assert not (toy / "res").exists()


@pytest.mark.parametrize("var,value", [("SSLREC_COORDINATOR", "localhost:1234"),
                                       ("SSLREC_DISTRIBUTED", "1")])
def test_multi_host_variables_raise(toy, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match="SSLREC_COORDINATOR"):
        _run(toy)


def test_mesh_size_as_make_mesh_reckons_it():
    cfg = load_config("lightgcn")
    assert mesh.mesh_shape(cfg, 1) is None
    assert mesh.mesh_shape(cfg.set_path("train.mesh.model", 2), 8) == (4, 2)
    assert mesh.mesh_shape(cfg.set_path("train.mesh.data", 2), 1) == (2, 0)
    assert mesh.device_count("cpu") == 1
    assert mesh.maybe_distributed_init(cfg) is False
