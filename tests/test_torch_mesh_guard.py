"""``train.mesh`` and ``train.distributed`` at the port's CLI
(``sslrec_tpu_torch/parallel/mesh.py``): a mesh of one device is the
single-device run (absent, empty, 1×1, and ``{model: 1}``, whose data axis
fills the CPU's one device); LightGCN, DCCF, MBGMN, DSL, MHCN and BERT4Rec
train on a mesh of gloo processes, and all 31 models pass ``check_model``;
a mesh that cannot be laid out raises ``ValueError`` as ``make_mesh`` does,
and a model class that still sets ``mesh_todo`` (a stub here: no shipped
model does) ``NotImplementedError``, both before any data is read;
``train.distributed`` and the variables of a multi-process run reach
``init_process_group``."""

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.models import registry
from sslrec_tpu_torch.models.base import MESH_NONE, RecModel
from sslrec_tpu_torch.parallel import mesh
from test_torch_main import _toy_split
from test_torch_mb_data import write_mb_dir
from test_torch_seq_data import write_seq_dir
from test_torch_social_data import write_social_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


# the models that train on the Tmall-named multi-behavior split, and the
# social ones on the toy social split (the rest on the toy general_cf split)
MB_SETS = {"mbgmn": ("model.embedding_size=8", "model.sampNum=8", "test.k=[3,5]",
                     "test.batch_size=64")}
SOCIAL_SETS = {m: ("model.embedding_size=8", "test.k=[3,5]") for m in ("dsl", "mhcn")}
SEQ_SETS = {"bert4rec": ("model.embedding_size=16", "model.max_seq_len=10", "model.n_layers=1",
                         "train.batch_size=16")}


class NoMeshModel(RecModel):
    """A model class without a mesh branch: it keeps ``RecModel``'s
    ``mesh_todo``."""


def _run(root, *sets, model="lightgcn"):
    dataset = "tmall" if model in MB_SETS else "toy"
    own = {**MB_SETS, **SOCIAL_SETS, **SEQ_SETS}.get(model, ())
    return tmain.main(["--model", model, "--data_dir", str(root), "--dataset", dataset,
                       "--device", "cpu", "--epoch", "1", "--set", "train.batch_size=128",
                       "--set", f"train.results_dir={root / 'res'}",
                       *[a for s in (*own, *sets) for a in ("--set", s)]])


class Stop(Exception):
    """Raised by the stand-in ``init_process_group`` to end the run there."""


@pytest.fixture
def toy(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    write_mb_dir(tmp_path)
    write_social_dir(tmp_path)
    write_seq_dir(tmp_path)
    monkeypatch.chdir(tmp_path)
    for var in ("SSLREC_COORDINATOR", "SSLREC_NUM_PROCESSES", "SSLREC_PROCESS_ID",
                "SSLREC_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path


@pytest.fixture
def init_calls(monkeypatch):
    """``init_process_group``'s calls, made to a stand-in that raises
    :class:`Stop`."""
    calls = []

    def init(*a, **kw):
        calls.append((a, kw))
        raise Stop

    monkeypatch.setattr(mesh.dist, "init_process_group", init)
    return calls


@pytest.mark.parametrize("sets", [(), ("train.mesh={}",),
                                  ("train.mesh.data=1", "train.mesh.model=1"),
                                  ("train.mesh.model=1",)])
def test_a_mesh_of_one_device_trains(toy, sets):
    trainer = _run(toy, *sets)
    assert np.isfinite(trainer.recorder.epochs[0]["loss"]["loss"])


TRAINS, CANNOT, NOT_PORTED, FORWARDED = "trains", "cannot", "not ported", "forwarded"


@pytest.mark.parametrize("model,sets,expect", [
    ("lightgcn", ("train.mesh.data=2", "train.mesh.model=1"), TRAINS),
    ("lightgcn", ("train.mesh.model=2",), CANNOT),
    ("dccf", ("train.mesh.data=2", "train.mesh.model=1"), TRAINS),
    ("mbgmn", ("train.mesh.data=2", "train.mesh.model=2"), TRAINS),
    ("dsl", ("train.mesh.data=1", "train.mesh.model=2"), TRAINS),
    ("mhcn", ("train.mesh.data=2", "train.mesh.model=2"), TRAINS),
    ("bert4rec", ("train.mesh.data=2", "train.mesh.model=1"), TRAINS),
    ("no_mesh", ("train.mesh.data=2", "train.mesh.model=1"), NOT_PORTED),
    ("lightgcn", ("train.distributed.coordinator=localhost:1234",
                  "train.distributed.num_processes=2",
                  "train.distributed.process_id=0"), FORWARDED),
    ("lightgcn", ("train.distributed.enable=true",), FORWARDED)])
def test_more_than_one_device_raises(toy, init_calls, monkeypatch, model, sets, expect):
    """A mesh of more than one device trains (LightGCN's and DCCF's on two gloo
    processes, MBGMN's, of item 9a, on four; DSL's, of item 9b, on the model
    axis of two alone, MHCN's on four; BERT4Rec's, of item 9c, on the data
    axis of two) or raises before any data is read: ``ValueError`` for a
    mesh that cannot be laid out on the CPU's one device (the data axis left
    out fills 1 // 2 = 0 devices), ``NotImplementedError`` for a model class
    that still sets ``mesh_todo`` (``NoMeshModel``, which the CLI's lookup
    returns for LightGCN's name here);
    ``train.distributed`` is forwarded to ``init_process_group`` (a stand-in
    that stops the run there)."""
    if model == "no_mesh":
        monkeypatch.setattr(tmain, "model_class", lambda name: NoMeshModel)
        model = "lightgcn"
    if expect == TRAINS:
        run = _run(toy, *sets, model=model)
        shape = {k.split(".")[-1]: int(v) for k, v in (x.split("=") for x in sets)}
        assert run.mesh == shape and len(run.ranks) == shape["data"] * shape["model"]
        assert np.isfinite(run.epochs[0]["loss"]["loss"])
        return
    want = {CANNOT: (ValueError, "needs more than 1 devices"),
            NOT_PORTED: (NotImplementedError, "NoMeshModel does not run on a device mesh "
                                              r"\(the model has no mesh branch"),
            FORWARDED: (Stop, None)}
    with pytest.raises(want[expect][0], match=want[expect][1]):
        _run(toy, *sets, model=model)
    assert not (toy / "res").exists()
    if expect == FORWARDED:
        method = ("tcp://localhost:1234" if "coordinator" in sets[0] else "env://")
        assert [c[1]["init_method"] for c in init_calls] == [method]


@pytest.mark.parametrize("model", registry.available_models())
def test_which_models_a_mesh_takes(model):
    """On a mesh of more than one device every registered model passes
    ``check_model``: LightGCN, the four models of ROADMAP Queue A item 7, the
    four KG models of item 8a, the four multi-behavior models of item 8b,
    the seven of item 9a, the social five of item 9b and the sequential six
    of item 9c; a class that keeps ``RecModel``'s ``mesh_todo`` is refused,
    and the message says that all 31 models run."""
    cls = registry.model_class(model)
    assert cls.mesh_todo is None
    mesh.check_model(cls, None)
    mesh.check_model(cls, (2, 2))
    mesh.check_model(cls, (2, 1))
    assert len(registry.available_models()) == 31
    assert NoMeshModel.mesh_todo == MESH_NONE
    with pytest.raises(NotImplementedError, match="all 31 models of the registry do"):
        mesh.check_model(NoMeshModel, (2, 1))


@pytest.mark.parametrize("var,value", [("SSLREC_COORDINATOR", "localhost:1234"),
                                       ("SSLREC_DISTRIBUTED", "1")])
def test_multi_host_variables_raise(toy, init_calls, monkeypatch, var, value):
    """The variables of a multi-process run: a coordinator alone raises JAX's
    ``ValueError`` (no process count or id); ``SSLREC_DISTRIBUTED=1`` joins
    torchrun's group (``env://``, gloo on the CPU)."""
    monkeypatch.setenv(var, value)
    if var == "SSLREC_COORDINATOR":
        with pytest.raises(ValueError, match="num_processes"):
            _run(toy)
        assert init_calls == []
    else:
        with pytest.raises(Stop):
            _run(toy)
        assert init_calls == [(("gloo",), {"init_method": "env://"})]
    assert not (toy / "res").exists()


def test_mesh_size_as_make_mesh_reckons_it():
    cfg = load_config("lightgcn")
    assert mesh.mesh_shape(cfg, 1) is None
    assert mesh.mesh_shape(cfg.set_path("train.mesh.model", 2), 8) == (4, 2)
    with pytest.raises(ValueError, match="mesh 2x0 needs more than 1 devices"):
        mesh.mesh_shape(cfg.set_path("train.mesh.data", 2), None)
    two = cfg.set_path("train.mesh.data", 2).set_path("train.mesh.model", 2)
    assert mesh.mesh_shape(two, None) == (2, 2)       # the CPU stands in for 4 devices
    with pytest.raises(ValueError, match="mesh 2x2 needs more than 1 devices"):
        mesh.mesh_shape(two, 1)                        # one card
    assert mesh.device_count("cpu") is None
    assert mesh.maybe_distributed_init(cfg) is False
