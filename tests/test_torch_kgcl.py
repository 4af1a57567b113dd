"""The port's KGCL slice against the JAX package on one tiny KG: weights
carried across, ``generate``, ``forward`` under injected KG masks and view
values, the loss and every parameter gradient (dropout off, and on with the
same injected masks), three Adam steps, the epoch's keep probabilities and
views, the TransE sub-loop of ``train_trans`` (``kg_loss`` and its
gradients, one epoch of the trainer's sub-loop under the same indices and
negatives), CPU CLI runs with and without it, and one step on the card
against the CPU.

Random draws differ between jax.random and torch, so the tests inject them:
into the port through its draw-free arguments, into JAX by standing in for
``jax.random.bernoulli`` with the same numpy-made masks.

Tolerances: rtol 1e-5, atol 1e-6 for one forward and backward pass (float
sums taken in another order).  Gradients take atol 1e-6 times the largest
entry of the tensor where that exceeds 1: an entry near zero there is the
cancellation of terms of that size, whose float32 rounding scales with them
(the largest all_embed gradient entries are about 6).  rtol 1e-4, atol 1e-6
after three Adam steps, which divide by √v and so magnify those differences.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import kg as jkg
from sslrec_tpu.models.kg.kgcl import KGCL as JKGCL
from sslrec_tpu.trainer import trainer as jtrainer
from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import kg as tkg
from sslrec_tpu_torch.models.kg.kgcl import KGCL as TKGCL
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils.convert import kgcl_params_from_jax
from test_torch_kg_data import write_kg_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6
SMALL = {"model.embedding_size": 8, "model.triplet_num": 5, "train.batch_size": 32,
         "test.k": [3, 5], "test.batch_size": 16}
NO_DROPOUT = {"model.node_dropout": False, "model.mess_dropout": False}


def _build(root, device="cpu", **overrides):
    """JAX and port KGCL on the same tiny KG, the port carrying JAX's
    ``init_params`` weights."""
    ov = {**SMALL, "data.dir": str(root), "data.name": "toy", **overrides}
    jcfg, tcfg = jload_config("kgcl", overrides=ov), tload_config("kgcl", overrides=ov)
    jdata, tdata = jkg.load(jcfg), tkg.load(tcfg, device)
    jmodel, tmodel = JKGCL(jcfg, jdata), TKGCL(tcfg, tdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel.load_state_dict(kgcl_params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel, tdata, jcfg, tcfg


@pytest.fixture(scope="module")
def kg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kg")
    write_kg_dir(root)
    return root


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a).copy()).to(device)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_grad(got, want):
    _close(got, want, atol=ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _aux(jmodel, seed):
    """Injected epoch views: two KG masks and the view values of two rect masks."""
    rng = np.random.default_rng(seed)
    n_kg, n_rect = jmodel.heads.shape[0], jmodel.bi.nnz_rect
    kg1, kg2 = ((rng.random(n_kg) < 0.5).astype(np.float32) for _ in range(2))
    m1, m2 = ((rng.random(n_rect) < 0.7).astype(np.float32) for _ in range(2))
    return {"kg_mask1": kg1, "kg_mask2": kg2,
            "ui_vals1": np.asarray(jmodel.bi.view_vals(jnp.asarray(m1))),
            "ui_vals2": np.asarray(jmodel.bi.view_vals(jnp.asarray(m2)))}


def _batch(jmodel, aux, seed, device="cpu", b=32):
    rng = np.random.default_rng(seed)
    idx = {"user": rng.integers(0, jmodel.user_num, b),
           "pos": rng.integers(0, jmodel.item_num, b),
           "neg": rng.integers(0, jmodel.item_num, b)}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in idx.items()}
    tb = {k: _t(v.astype(np.int32), device) for k, v in idx.items()}
    jb["aux"] = {k: jnp.asarray(v) for k, v in aux.items()}
    tb["aux"] = {k: _t(v, device) for k, v in aux.items()}
    return jb, tb


def _step_masks(tmodel, seed):
    """One step's node- and message-dropout keeps, as numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (tmodel.context_hops, tmodel.n_entities, tmodel.embedding_size)
    return {"rect_keep": (rng.random(tmodel.bi.nnz_rect) < 0.5).astype(np.float32),
            "kg_keep": (rng.random(tmodel.heads.shape[0]) < 0.5).astype(np.float32),
            "mess_keep": rng.random(shape) < 0.9}


def _fake_bernoulli(monkeypatch, outputs, seen_p=None):
    """``jax.random.bernoulli`` returning ``outputs`` in call order; a callable
    output gets ``p`` (recorded in ``seen_p``)."""
    queue = list(outputs)

    def bernoulli(key, p=0.5, shape=None):
        out = queue.pop(0)
        if callable(out):
            if seen_p is not None:
                seen_p.append(np.asarray(p))
            return out(p)
        return jnp.asarray(out)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return queue


def test_weights_carried_across_and_generate(kg_root):
    jmodel, params, tmodel, *_ = _build(kg_root)
    np.testing.assert_array_equal(tmodel.all_embed.detach().numpy(),
                                  np.asarray(params["all_embed"]))
    np.testing.assert_array_equal(tmodel.rgat_fc["w"].detach().numpy(),
                                  np.asarray(params["rgat_fc"]["w"]))
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    _close(tu, ju)
    _close(ti, ji)


def test_forward_with_injected_masks(kg_root):
    jmodel, params, tmodel, *_ = _build(kg_root)
    aux = _aux(jmodel, 1)
    aux["kg_mask1"][np.asarray(jmodel.heads) == int(np.asarray(jmodel.heads)[0])] = 0.0
    with torch.no_grad():
        tu, ti = tmodel.forward(kg_mask=_t(aux["kg_mask1"]), adj_vals=_t(aux["ui_vals1"]))
    ju, ji = jmodel.forward(params, jax.random.PRNGKey(0), kg_mask=jnp.asarray(aux["kg_mask1"]),
                            adj_vals=jnp.asarray(aux["ui_vals1"]))
    _close(tu, ju)
    _close(ti, ji)


def _check_loss_and_grads(jmodel, params, tmodel, jbatch, tbatch, draws):
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jbatch, jax.random.PRNGKey(3))
    tloss, taux = tmodel.loss(tbatch, None, draws=draws)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    for k in ("rec_loss", "cl_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=RTOL)
    want = {"all_embed": jgrads["all_embed"], "relation_embed": jgrads["relation_embed"],
            "rgat_fc.w": jgrads["rgat_fc"]["w"], "rgat_fc.b": jgrads["rgat_fc"]["b"]}
    for name, p in tmodel.named_parameters():
        if name in ("rgat_w", "rgat_a"):    # unused by the forward: no gradient
            assert p.grad is None and not np.asarray(jgrads[name]).any()
            continue
        _close_grad(p.grad, want[name])


def test_loss_and_grads_match_jax_without_dropout(kg_root):
    jmodel, params, tmodel, *_ = _build(kg_root, **NO_DROPOUT)
    jbatch, tbatch = _batch(jmodel, _aux(jmodel, 2), 2)
    assert tmodel.step_draws(None) == {}
    _check_loss_and_grads(jmodel, params, tmodel, jbatch, tbatch, {})


def test_loss_and_grads_match_jax_with_injected_dropout(kg_root, monkeypatch):
    jmodel, params, tmodel, *_ = _build(kg_root)
    jbatch, tbatch = _batch(jmodel, _aux(jmodel, 4), 4)
    m = _step_masks(tmodel, 5)
    left = _fake_bernoulli(monkeypatch, [m["rect_keep"] > 0, m["kg_keep"] > 0,
                                         m["mess_keep"][0], m["mess_keep"][1]])
    _check_loss_and_grads(jmodel, params, tmodel, jbatch, tbatch,
                          {k: _t(v) for k, v in m.items()})
    assert not left


def test_adam_steps_match_optax(kg_root):
    jmodel, params, tmodel, tdata, jcfg, tcfg = _build(kg_root, **NO_DROPOUT)
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tmodel, tdata)
    for step in range(3):
        jbatch, tbatch = _batch(jmodel, _aux(jmodel, 10 + step), 10 + step)
        (jloss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, jbatch, jax.random.PRNGKey(step))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        aux = trainer.train_step(tbatch, None)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-4)
    want = kgcl_params_from_jax(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        _close(p, want[name].numpy(), rtol=1e-4, atol=1e-6)


def test_epoch_state_keep_probs_and_views(kg_root, monkeypatch):
    jmodel, params, tmodel, *_ = _build(kg_root)
    rng = np.random.default_rng(6)
    n_kg, n_rect = jmodel.heads.shape[0], jmodel.bi.nnz_rect
    draws = {"kg_mask1": (rng.random(n_kg) < 0.5).astype(np.float32),
             "kg_mask2": (rng.random(n_kg) < 0.5).astype(np.float32),
             "view_u1": rng.random(n_rect).astype(np.float32),
             "view_u2": rng.random(n_rect).astype(np.float32)}
    seen_p = []
    _fake_bernoulli(monkeypatch, [draws["kg_mask1"] > 0, draws["kg_mask2"] > 0,
                                  lambda p: jnp.asarray(draws["view_u1"]) < p,
                                  lambda p: jnp.asarray(draws["view_u2"]) < p], seen_p)
    with jax.disable_jit():
        want = jmodel.epoch_state(params, jax.random.PRNGKey(0), 0)
    tdraws = {k: _t(v) for k, v in draws.items()}
    p = tmodel.keep_probs(tdraws["kg_mask1"], tdraws["kg_mask2"])
    _close(p, seen_p[0])
    np.testing.assert_array_equal(seen_p[0], seen_p[1])
    assert 0.3 * 0.7 / 0.95 - 1e-6 <= float(p.min()) and float(p.max()) <= 0.95 + 1e-7
    got = tmodel.epoch_state(None, 0, draws=tdraws)
    for k in ("kg_mask1", "kg_mask2", "ui_vals1", "ui_vals2"):
        _close(got[k], want[k])


def test_epoch_state_draws_on_generator(kg_root):
    _, _, tmodel, *_ = _build(kg_root)
    gen = torch.Generator().manual_seed(0)
    s1 = tmodel.epoch_state(gen)
    s2 = tmodel.epoch_state(torch.Generator().manual_seed(0))
    for k in s1:
        assert torch.equal(s1[k], s2[k])
    d = tmodel.step_draws(gen)
    assert d["mess_keep"].dtype == torch.bool and d["mess_keep"].shape[0] == 2
    assert set(d["rect_keep"].unique().tolist()) <= {0.0, 1.0}


def test_train_trans_not_ported(kg_root):
    """The TransE sub-loop is ported: the model builds, and the trainer runs
    the sub-loop only where ``train_trans`` is set."""
    for flag in (True, False):
        _, _, tmodel, tdata, _, tcfg = _build(kg_root, **{"model.train_trans": flag})
        assert tmodel.train_trans is flag and Trainer(tcfg, tmodel, tdata).kg_trans is flag


def _kg_batches(jmodel, n_steps, bsz, seed):
    """Triplet indices with replacement and negative tails, as numpy."""
    rng = np.random.default_rng(seed)
    n_trip = len(jmodel._kg_triplets)
    return (rng.integers(0, n_trip, (n_steps, bsz)),
            rng.integers(0, jmodel.n_entities, (n_steps, bsz)))


def test_kg_loss_and_grads_match_jax(kg_root):
    jmodel, params, tmodel, *_ = _build(kg_root)
    idx, neg = _kg_batches(jmodel, 1, 64, 21)
    trip = jmodel._kg_triplets[idx[0]]
    h, r, t = trip[:, 0], trip[:, 1], trip[:, 2]
    jloss, jgrads = jax.value_and_grad(jmodel.kg_loss)(
        params, tuple(jnp.asarray(a, jnp.int32) for a in (h, r, t, neg[0])))
    tloss = tmodel.kg_loss(*(_t(a) for a in (h, r, t, neg[0])))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    _close_grad(tmodel.all_embed.grad, jgrads["all_embed"])
    _close_grad(tmodel.relation_embed.grad, jgrads["relation_embed"])
    assert tmodel.rgat_fc["w"].grad is None and not np.asarray(jgrads["rgat_fc"]["w"]).any()


class _Silent:
    def log(self, *a, **k):
        pass


def test_kg_trans_epoch_matches_jax(kg_root, monkeypatch):
    """One epoch of the TransE sub-loop (3 steps of 64) against the JAX
    trainer's ``_kg_trans_epoch``, the indices and negatives injected into
    both; the JAX epoch runs eagerly, its draws standing in for
    ``jax.random.randint`` and ``sample_negatives``."""
    ov = {"train.kg_batch_size": 64, "model.train_trans": True}
    jmodel, params, tmodel, tdata, jcfg, tcfg = _build(kg_root, **ov)
    n_steps = len(jmodel._kg_triplets) // 64
    idx, neg = _kg_batches(jmodel, n_steps, 64, 22)
    idx_q, neg_q = [jnp.asarray(a, jnp.int32) for a in idx], [jnp.asarray(a, jnp.int32)
                                                             for a in neg]
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: idx_q.pop(0))
    monkeypatch.setattr(jtrainer, "sample_negatives", lambda *a, **k: neg_q.pop(0))
    jt = jtrainer.Trainer(jcfg, jmodel, jkg.load(jcfg), logger=_Silent())
    with jax.disable_jit():
        jparams, jloss = jt._kg_trans_epoch(params, jax.random.PRNGKey(0))
    assert not idx_q and not neg_q
    trainer = Trainer(tcfg, tmodel, tdata)
    tloss = trainer.kg_trans_epoch(_t(idx), _t(neg))
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-5)
    want = kgcl_params_from_jax(jax.device_get(jparams))
    for name, p in tmodel.named_parameters():
        _close(p, want[name].numpy(), rtol=1e-4, atol=1e-6)
    moved = tmodel.all_embed.detach().numpy() != np.asarray(params["all_embed"])
    assert moved[jmodel.user_num:].any() and not moved[: jmodel.user_num].any()
    ti, tn = trainer.kg_trans_draws(0)
    assert ti.shape == tn.shape == (n_steps, 64) and trainer.kg_trans_draws(0)[0].equal(ti)


def test_cli_trains_kgcl_with_train_trans(kg_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = tmain.main(["--model", "kgcl", "--data_dir", str(kg_root), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2", "--set=model.train_trans=true",
                          "--set=train.kg_batch_size=64",
                          *[f"--set={k}={v}" for k, v in SMALL.items()]])
    rows = trainer.recorder.epochs
    assert [r["epoch"] for r in rows] == [0, 1] and trainer.kg_optimizer is not None
    for r in rows:
        assert set(r["loss"]) == {"rec_loss", "cl_loss", "loss", "kg_loss"}
        assert all(np.isfinite(v) for v in r["loss"].values())


def test_cli_trains_kgcl_and_writes_results_torch(kg_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # the logger writes ./log, results go to ./results_torch
    trainer = tmain.main(["--model", "kgcl", "--data_dir", str(kg_root), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2",
                          *[f"--set={k}={v}" for k, v in SMALL.items()]])
    doc = json.loads((tmp_path / "results_torch" / "kgcl_toy.json").read_text())
    assert "partial" not in doc and doc["device"] == "cpu"
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
        assert set(r["loss"]) == {"rec_loss", "cl_loss", "loss"}
    assert len(doc["test"]["recall"]) == 2
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


def test_step_on_cuda_matches_cpu(kg_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the B1/B2 kernels have no CPU mode")
    jmodel, _, cpu_model, *_ = _build(kg_root)
    _, _, cuda_model, *_ = _build(kg_root, device="cuda")
    aux, m = _aux(jmodel, 7), _step_masks(cpu_model, 8)
    losses = {}
    for model, dev in ((cpu_model, "cpu"), (cuda_model, "cuda")):
        _, tbatch = _batch(jmodel, aux, 7, dev)
        loss, _ = model.loss(tbatch, None, draws={k: _t(v, dev) for k, v in m.items()})
        loss.backward()
        losses[dev] = loss.detach().cpu()
    _close(losses["cuda"], losses["cpu"].numpy())
    for (name, pc), (_, pg) in zip(cpu_model.named_parameters(), cuda_model.named_parameters()):
        if pc.grad is not None:
            _close_grad(pg.grad, pc.grad.numpy())
