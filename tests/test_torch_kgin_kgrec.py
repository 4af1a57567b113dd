"""The port's KGIN and KGRec against the JAX package on one tiny KG (written
by ``test_torch_kg_data.write_kg_dir``, embedding 8, KGRec's MAE mask of 16
edges): the interact edges;
weights carried across by ``convert`` and ``generate()``; the loss, every
loss term and every parameter gradient under JAX's draws, with and without
dropout; KGIN's distance correlation and its gradient at the exactly-zero
diagonal of the pairwise distances; KGRec's top-k and sort thresholds on
ties, and its loss where ties decide (fewer live edges than the MAE's k, so
−inf scores are picked; the contrast's threshold is the dead edges' tied
−inf); three Adam steps through the port's trainer against optax; and
a tiny CPU CLI run of each.

Random draws are JAX's, injected: each model's draws under the loss's key,
made with the same ``jax.random`` calls on the same split keys.

Tolerances: rtol 1e-5, atol 1e-6 for a forward and backward pass (float sums
in another order); gradients take atol 1e-6 times the largest entry of the
tensor where that exceeds 1, as in ``test_torch_kgcl.py``; rtol 1e-4, atol
1e-6 after three Adam steps, which divide by √v and so magnify those
differences.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import kg as jkg
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import kg as tkg
from sslrec_tpu_torch.models.kg import kgin as tkgin
from sslrec_tpu_torch.models.kg import kgrec as tkgrec
from sslrec_tpu_torch.models.registry import build_model as tbuild
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils import convert
from test_torch_kg_data import write_kg_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6
SMALL = {"model.embedding_size": 8, "train.batch_size": 32, "test.k": [3, 5],
         "test.batch_size": 16}
# KGRec's MAE masks mae_msize top edges and as many random ones: at the
# published 256 every live edge of the tiny KG is masked and the encoder has
# no KG edge (no attention gradient), so the runs here mask 16 (the ties test
# keeps 256)
KGREC_MAE = {"model.mae_msize": 16}
NO_DROPOUT = {"kgin": {"model.node_dropout": False, "model.mess_dropout": False},
              "kgrec": {"model.mess_dropout": False}}
CONVERT = {"kgin": convert.kgin_params_from_jax, "kgrec": convert.kgrec_params_from_jax}


@pytest.fixture(scope="module")
def kg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kg")
    write_kg_dir(root)
    return root


def _pair(root, name, **over):
    ov = {**SMALL, **(KGREC_MAE if name == "kgrec" else {}), "data.dir": str(root),
          "data.name": "toy", **over}
    jcfg, tcfg = jload_config(name, overrides=ov), tload_config(name, overrides=ov)
    jmodel = jbuild(jcfg, jkg.load(jcfg))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tdata = tkg.load(tcfg)
    tmodel = tbuild(tcfg, tdata)
    tmodel.load_state_dict(CONVERT[name](jax.device_get(params)))
    return jmodel, params, tmodel, tdata, jcfg, tcfg


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _batch(jmodel, seed, b=32):
    rng = np.random.default_rng(seed)
    arrs = {"user": rng.integers(0, jmodel.user_num, b),
            "pos": rng.integers(0, jmodel.item_num, b),
            "neg": rng.integers(0, jmodel.item_num, b)}
    return ({k: jnp.asarray(v, jnp.int32) for k, v in arrs.items()},
            {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrs.items()})


def _mess_keeps(jm, key, n_ent, n_user):
    out = []
    for _ in range(jm.context_hops):
        key, k1, k2 = jax.random.split(key, 3)
        keep = 1 - jm.mess_dropout_rate
        out.append((_t(jax.random.bernoulli(k1, keep, (n_ent, jm.embedding_size))),
                    _t(jax.random.bernoulli(k2, keep, (n_user, jm.embedding_size)))))
    return out


def kgin_draws(jm, key):
    """JAX KGIN's ``_gcn`` draws under ``key``, as the port's."""
    draws = {}
    if jm.node_dropout:
        key, k1, k2 = jax.random.split(key, 3)
        draws["kg_mask"] = _t(jax.random.bernoulli(k1, jm.node_dropout_rate,
                                                   jm.kg_heads.shape), torch.float32)
        draws["im_keep"] = _t(jax.random.bernoulli(k2, 1 - jm.node_dropout_rate,
                                                   jm.im_vals.shape))
    if jm.mess_dropout:
        draws["mess_keep"] = _mess_keeps(jm, key, jm.n_entities, jm.user_num)
    return draws


def kgrec_draws(jm, key):
    """JAX KGRec's ``loss`` draws under ``key``, as the port's."""
    ks = jax.random.split(key, 8)
    rate = jm.node_dropout_rate
    draws = {"live": _t(jax.random.bernoulli(ks[0], 1 - rate, (jm.n_kg,)), torch.float32),
             "mae_u": _t(jax.random.uniform(ks[1], (jm.n_kg,))),
             "rand_ids": _t(jax.random.randint(ks[2], (jm.mae_msize,), 0, jm.n_kg),
                            torch.int64),
             "ie_mask": _t(jax.random.bernoulli(ks[3], 1 - rate, (jm.n_ui,)), torch.float32),
             "ui_u": _t(jax.random.uniform(ks[5], (jm.n_ui,))),
             "perm": _t(jax.random.permutation(ks[6], jm.item_num), torch.int64)}
    if jm.mess_dropout:
        draws["mess_keep"] = _mess_keeps(jm, ks[4], jm.n_entities, jm.user_num)
    return draws


DRAWS = {"kgin": kgin_draws, "kgrec": kgrec_draws}


def _check_loss_and_grads(name, jm, params, tm, seed, key, nonzero=True):
    jbatch, tbatch = _batch(jm, seed)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jbatch, key)
    tloss, taux = tm.loss(tbatch, None, draws=DRAWS[name](jm, key))
    tloss.backward()
    _close(tloss.item(), float(jloss), f"{name} loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k].item(), float(jaux[k]), f"{name} {k}")
    want = CONVERT[name](jax.device_get(jgrads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        w = want[k].numpy()
        assert np.abs(w).max() > 0 or not nonzero, k
        _close(got[k].numpy(), w, f"{name} grad {k}",
               atol=ATOL * max(1.0, float(np.abs(w).max())))


def test_interact_edges_match_jax(kg_root):
    jin, _, tin, *_ = _pair(kg_root, "kgin")
    rows, cols = (tin.seg_iu.layout.ids.numpy(), tin.seg_ic.layout.ids.numpy())
    np.testing.assert_array_equal(rows, np.asarray(jin.im_rows))
    np.testing.assert_array_equal(cols, np.asarray(jin.im_cols))
    np.testing.assert_array_equal(tin.im_vals.numpy(), np.asarray(jin.im_vals))
    jre, _, tre, *_ = _pair(kg_root, "kgrec")
    np.testing.assert_array_equal(tre.seg_ieu.layout.ids.numpy(), np.asarray(jre.ie_u))
    np.testing.assert_array_equal(tre.ie_i.numpy(), np.asarray(jre.ie_i))
    np.testing.assert_array_equal(tre.ie_w.numpy(), np.asarray(jre.ie_w))
    assert tre.n_kg == jre.n_kg == len(tin.seg_h.layout.ids)


@pytest.mark.parametrize("name", ["kgin", "kgrec"])
def test_convert_and_generate(kg_root, name):
    jm, params, tm, *_ = _pair(kg_root, name)
    with torch.no_grad():
        tu, ti = tm.generate()
    ju, ji = jm.generate(params)
    assert tu.shape == ju.shape and ti.shape == ji.shape
    _close(tu.numpy(), ju, f"{name} users")
    _close(ti.numpy(), ji, f"{name} items")


@pytest.mark.parametrize("name", ["kgin", "kgrec"])
@pytest.mark.parametrize("dropout", [True, False])
def test_loss_and_every_gradient(kg_root, name, dropout):
    jm, params, tm, *_ = _pair(kg_root, name, **({} if dropout else NO_DROPOUT[name]))
    _check_loss_and_grads(name, jm, params, tm, 3, jax.random.PRNGKey(5))


@pytest.mark.parametrize("ind", ["cosine", "mi"])
def test_kgin_independence_terms(kg_root, ind):
    jm, params, tm, *_ = _pair(kg_root, "kgin", **{"model.ind": ind})
    att = np.asarray(params["disen_weight_att"])
    jval, jgrad = jax.value_and_grad(lambda a: jm._cor({**params, "disen_weight_att": a}))(
        jnp.asarray(att))
    tval = tm._cor()
    tval.backward()
    _close(tval.item(), float(jval), ind)
    _close(tm.disen_weight_att.grad.numpy(), jgrad, f"{ind} grad")


def test_distance_cor_gradient_at_the_zero_diagonal(kg_root):
    """The pairwise distances' diagonal is exactly 0, where ``max(·, 0)`` ties,
    and ``√(· + 1e-8)`` there multiplies the upstream gradient by 5,000: the
    diagonal's contribution cancels analytically, but its float32 rounding is
    1e-4 to 5e-3 of the gradient in either package.  So ``_relu0``'s gradient
    at the tie is held to ``jnp.maximum``'s (a half; ``clamp`` passes it
    whole), the model's distance-correlation term (every factor pair; also
    with a repeated value, an off-diagonal tie) to JAX's in float64 within
    1e-10, and the port's float32 gradient to that within twice the error of
    JAX's float32 gradient plus 1e-4 (max-norm, relative)."""
    zero = torch.zeros((), requires_grad=True)
    tkgin._relu0(zero).backward()
    assert zero.grad.item() == float(jax.grad(lambda v: jnp.maximum(v, 0.0))(0.0)) == 0.5
    clamped = torch.zeros((), requires_grad=True)
    clamped.clamp(min=0.0).backward()
    assert clamped.grad.item() == 1.0
    jm, params, tm, *_ = _pair(kg_root, "kgin")
    att = np.asarray(params["disen_weight_att"]).astype(np.float64)
    tied = att.copy()
    tied[1, 2] = tied[1, 4]

    def jcor(a):
        return jm._cor({**params, "disen_weight_att": a})

    def tcor(a, dtype):
        tm.disen_weight_att.data = torch.tensor(a, dtype=dtype)
        tm.disen_weight_att.grad = None
        val = tm._cor()
        val.backward()
        return val.item(), tm.disen_weight_att.grad.numpy()

    with jax.enable_x64(True):
        for a in (att, tied):
            want, want_g = jax.value_and_grad(jcor)(jnp.asarray(a, jnp.float64))
            assert want_g.dtype == jnp.float64
            val, grad = tcor(a, torch.float64)
            np.testing.assert_allclose(val, float(want), rtol=1e-10)
            np.testing.assert_allclose(grad, np.asarray(want_g), rtol=1e-10, atol=1e-12)
        want_g = np.asarray(jax.grad(jcor)(jnp.asarray(att, jnp.float64)))
        j32 = np.asarray(jax.grad(jcor)(jnp.asarray(att, jnp.float32)))
    assert j32.dtype == np.float32
    scale = np.abs(want_g).max()
    port_err = np.abs(tcor(att, torch.float32)[1] - want_g).max() / scale
    jax_err = np.abs(j32 - want_g).max() / scale
    assert port_err <= 2 * jax_err + 1e-4, (port_err, jax_err)


def test_top_k_and_thresholds_keep_jax_ties():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 5, 300).astype(np.float32)
    x[rng.random(300) < 0.3] = -np.inf
    for k in (1, 7, 100, 250, 300):
        np.testing.assert_array_equal(tkgrec.top_k_ids(torch.from_numpy(x), k).numpy(),
                                      np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))
        assert tkgrec.kth_largest(torch.from_numpy(x), k).item() == float(
            jnp.sort(jnp.asarray(x))[-k])


def test_kgrec_loss_where_ties_decide(kg_root):
    """At the published ``mae_msize`` (256) the tiny KG has fewer live edges,
    so the top-k picks −inf scores, lowest ids first; and fewer than the
    contrast keeps, so its KG threshold is the dead edges' tied −inf."""
    jm, params, tm, *_ = _pair(kg_root, "kgrec", **{"model.mae_msize": 256})
    key = jax.random.PRNGKey(9)
    draws = kgrec_draws(jm, key)
    live = draws["live"]
    assert int(live.sum()) < tm.mae_msize
    with torch.no_grad():
        rel = tm.rel_take.take(tm.relation_emb)
        score = tm._norm_attn(tm.all_embed[tm.user_num:], rel, live, tm.seg_h.sum(live))
        masked = torch.where(live > 0, score, float("-inf"))
        th = tkgrec.kth_largest(masked, int((1 - tm.cl_drop) * tm.n_kg))
    assert th.item() == float("-inf") and int((masked == th).sum()) > 1
    # every live edge is masked: the encoder's attention has no gradient
    _check_loss_and_grads("kgrec", jm, params, tm, 4, key, nonzero=False)


def test_step_draws_on_a_generator(kg_root):
    for name in ("kgin", "kgrec"):
        _, _, tm, *_ = _pair(kg_root, name)
        d1 = tm.step_draws(torch.Generator().manual_seed(0))
        d2 = tm.step_draws(torch.Generator().manual_seed(0))
        assert set(d1) == set(DRAWS[name](_pair(kg_root, name)[0], jax.random.PRNGKey(0)))
        for k in d1:
            if k == "mess_keep":
                assert len(d1[k]) == tm.context_hops and d1[k][0][0].dtype == torch.bool
                continue
            assert torch.equal(d1[k], d2[k])


@pytest.mark.parametrize("name", ["kgin", "kgrec"])
def test_three_adam_steps(kg_root, name, monkeypatch):
    jm, params, tm, tdata, jcfg, tcfg = _pair(kg_root, name)
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tm, tdata)
    loss_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    for step in range(3):
        key = jax.random.PRNGKey(30 + step)
        jbatch, tbatch = _batch(jm, 20 + step)
        (jloss, _), grads = loss_fn(params, jbatch, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        draws = DRAWS[name](jm, key)
        monkeypatch.setattr(tm, "step_draws", lambda gen, d=draws: d)
        aux = trainer.train_step(tbatch, None)
        _close(aux["loss"].item(), float(jloss), f"{name} step {step} loss", rtol=1e-4)
    want = CONVERT[name](jax.device_get(params))
    for k, p in tm.named_parameters():
        _close(p.detach().numpy(), want[k].numpy(), f"{name} {k}", rtol=1e-4)


@pytest.mark.parametrize("name", ["kgin", "kgrec"])
def test_cli_trains_and_evaluates_on_cpu(kg_root, name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # the logger writes ./log, the model ./checkpoint_torch
    res = tmp_path / "res"
    trainer = tmain.main(["--model", name, "--data_dir", str(kg_root), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2", "--set", "train.test_step=1",
                          "--set", f"train.results_dir={res}",
                          *[f"--set={k}={v}" for k, v in SMALL.items()]])
    doc = json.loads((res / f"{name}_toy.json").read_text())
    assert "partial" not in doc and doc["device"] == "cpu"
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
    assert len(doc["test"]["recall"]) == 2
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
