"""The port's CLI trains and evaluates each self-supervised general_cf model
on a tiny split on the CPU and writes its results artifact; and, where there
is a CUDA card, one training step of each on the card equals the same step
on the CPU's plain versions (AutoCF's and GFormer's views built on each
device from the same draws; AdaGCL's whole four-phase step, held by the
parameters it leaves).

Nothing here imports JAX, so on a machine with a card and no JAX the file
runs as ``python -m pytest --noconftest tests/test_torch_ssl_cli.py``.
The card test's tolerance is chip_smoke's: max |card - CPU| / max |CPU| <=
1e-5 for the loss and each gradient (float sums in another order); AdaGCL's
parameters after its step's five Adam updates, which divide by √v and so
magnify those differences, within rtol 1e-4, atol 1e-6, as against JAX.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.trainer.trainer import generator
from test_torch_main import _toy_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

MODELS = ["sgl", "simgcl", "directau", "ncl", "lightgcl", "hccf", "dccf", "autocf", "gformer",
          "adagcl"]


@pytest.mark.parametrize("model", MODELS)
def test_cli_trains_and_evaluates_on_cpu(model, tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)     # the logger writes ./log
    res = tmp_path / "res"
    # tune.enable off: NCL's shipped config asks for its grid search, which
    # test_torch_tuner.py drives; this test is of one training run
    trainer = tmain.main(["--model", model, "--data_dir", str(tmp_path), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2", "--set", "train.test_step=1",
                          "--set", "train.batch_size=128", "--set", "model.embedding_size=8",
                          "--set", f"train.results_dir={res}", "--set", "tune.enable=false"])
    doc = json.loads((res / f"{model}_toy.json").read_text())
    assert "partial" not in doc and doc["device"] == "cpu"
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
        assert r["train_examples"] == 512 and len(r["valid"]["recall"]) == 3
    assert len(doc["test"]["recall"]) == 3
    assert all(0.0 <= v <= 1.0 for v in doc["test"]["recall"])
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


def _small_train_mat(n_users=300, n_items=200, n=3000, seed=7):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_users, n), np.arange(n_users)])
    cols = np.concatenate([rng.integers(0, n_items, n), rng.integers(0, n_items, n_users)])
    trn = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                        shape=(n_users, n_items))
    return (trn.tocsr() != 0).astype(np.float32).tocoo()


def _close_to(got: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    assert torch.isfinite(got).all(), what
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), f"{what}: max abs err {err}"


@pytest.mark.parametrize("model", MODELS)
def test_step_on_cuda_matches_cpu(model):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 has no CPU mode")
    cfg = load_config(model, overrides={"train.batch_size": 256})
    trn = _small_train_mat()
    cpu = build_model(cfg, bundle_from_matrices(trn, None, trn, device="cpu"))
    cpu.init_params(generator(1, 2))
    card = build_model(cfg, bundle_from_matrices(trn, None, trn, device="cuda"))
    card.load_state_dict(cpu.state_dict())
    if model == "lightgcl":
        for k in ("ut", "vt", "u_mul_s", "v_mul_s"):
            setattr(card, k, getattr(cpu, k).cuda())
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, hi, (256,), generator=gen, dtype=torch.int32)
             for k, hi in (("user", cpu.user_num), ("pos", cpu.item_num),
                           ("neg", cpu.item_num))}
    batch["step"] = 0
    view_draws = None
    if hasattr(cpu, "view_draws"):
        cpu._n_batches_hint = card._n_batches_hint = 1
        view_draws = [cpu.view_draws(gen)]
    elif hasattr(cpu, "epoch_state"):
        batch["aux"] = cpu.epoch_state(gen, 0)
    draws = cpu.step_draws(gen) if cpu.step_generator else None
    key = torch.tensor([11, 12])
    out = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        def on(x):
            if isinstance(x, dict):
                return {k: on(v) for k, v in x.items()}
            return x.to(dev) if torch.is_tensor(x) else x

        b = on(batch)
        if view_draws is not None:
            b["aux"] = m.epoch_state(None, 0, draws=[on(d) for d in view_draws])
        kw = {} if draws is None else {"draws": on(draws)}
        if hasattr(m, "train_step"):
            aux = m.train_step(b, None, **kw)
            out[dev] = aux["loss"].cpu().reshape(1), {k: p.detach().cpu()
                                                      for k, p in m.named_parameters()}
            continue
        loss, _ = m.loss(b, on(key), **kw)
        loss.backward()
        out[dev] = loss.detach().cpu().reshape(1), {k: p.grad.cpu()
                                                    for k, p in m.named_parameters()}
    _close_to(out["cuda"][0], out["cpu"][0], f"{model} loss")
    for k, g in out["cpu"][1].items():
        if hasattr(cpu, "train_step"):
            torch.testing.assert_close(out["cuda"][1][k], g, rtol=1e-4, atol=1e-6,
                                       msg=f"{model} parameter {k} after the step")
        else:
            _close_to(out["cuda"][1][k], g, f"{model} grad {k}")
