"""The port's KCGN and SMIN against the JAX package on a tiny synthetic
social split (embedding 16): weights carried across by ``convert`` and
``generate()``; the loss, every loss term and every parameter gradient under
JAX's draws; three Adam steps through the port's trainer against optax; and
a tiny CPU CLI run of each.  KCGN runs with one rating class (unit times,
the handler's fallback) and with two, its item copies fused by their mean
and by a learned weight.  SMIN's port is built on the JAX package's own
sampled metapaths (the samplers draw differently; the structures given the
same metapaths are held in ``test_torch_social_metapaths.py``).

Random draws are JAX's, injected: the DGI row shuffles under the loss's key.

Tolerances: rtol 1e-5, atol 1e-6 for a forward and backward pass (float sums
in another order: B1's segment sums against XLA's); rtol 1e-4, atol 1e-6
after three Adam steps, which divide by √v and so magnify those differences.
KCGN's time projection is used by every edge of the expanded graph, so its
gradient is a float32 sum over all of them, whose rounding scales with the
sum of the terms' magnitudes (XLA's CPU sum is off from the float64 sum by
up to 1e-5 relative where the terms cancel): it is held within 1e-6 of that
magnitude sum, entry by entry, on top of atol 1e-6.  SMIN's semantic
attention's first layers (``attn_*.l1``) have gradients that are such sums
over every node, cancelling to 1e-3 of their terms (float32 noise about 3e-7
against entries of 1e-7 to 8e-4), and Adam moves each entry by about
``lr · g / (|g| + eps)``, so noise of that size changes the small entries'
moves by percents of lr: after the three steps they are held within 2e-4
(a fifteenth of the 3e-3 the three steps can move them; measured 1.2e-4),
every other parameter within rtol 1e-4, atol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import social as jsocial
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import social as tsocial
from sslrec_tpu_torch.models.registry import build_model as tbuild
from sslrec_tpu_torch.models.social import kcgn as tkcgn
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils import convert
from test_torch_social_data import social_split, write_social_dir
from test_torch_social_metapaths import rated_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6
CONVERT = {"kcgn": convert.kcgn_params_from_jax, "smin": convert.smin_params_from_jax}
# (model, overrides, ratings of the train pairs): None keeps the binary split
# and the handler's unit times
CASES = {"kcgn_r1": ("kcgn", {}, None),
         "kcgn_r2_mean": ("kcgn", {"model.fuse": "mean"}, (1.0, 3.0)),
         "kcgn_r2_weight": ("kcgn", {"model.fuse": "weight"}, (1.0, 3.0)),
         "smin": ("smin", {}, None)}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _mats(ratings):
    if ratings is None:
        return social_split(), {}
    rated, tst, trust, times = rated_split(seed=11, ratings=ratings)
    return (rated, tst, trust), {"trn_time": times}


def _pair(case, monkeypatch):
    name, over, ratings = CASES[case]
    over = {"model.embedding_size": 16, "train.batch_size": 64, **over}
    jcfg, tcfg = jload_config(name, overrides=over), tload_config(name, overrides=over)
    mats, kw = _mats(ratings)
    monkeypatch.setattr(tsocial, "gen_metapaths", jsocial.gen_metapaths)
    jdata = jsocial.bundle_from_matrices(jcfg, *mats, **kw)
    jmodel = jbuild(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tdata = tsocial.bundle_from_matrices(tcfg, *mats, **kw)
    tmodel = tbuild(tcfg, tdata)
    tmodel.load_state_dict(CONVERT[name](jax.device_get(params)))
    return name, jmodel, params, tmodel, tdata, jcfg, tcfg


def _batch(jmodel, seed, b=64):
    rng = np.random.default_rng(seed)
    arrs = {"user": rng.integers(0, jmodel.user_num, b),
            "pos": rng.integers(0, jmodel.item_num, b),
            "neg": rng.integers(0, jmodel.item_num, b)}
    return ({k: jnp.asarray(v, jnp.int32) for k, v in arrs.items()},
            {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrs.items()})


def _draws(name, jmodel, key):
    """JAX's row shuffles under the loss's key, as the port's draws."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64)

    if name == "smin":
        return {"perm": t(jax.random.permutation(key, jmodel.user_num + jmodel.item_num))}
    k1, k2 = jax.random.split(key)
    return {"perm_u": t(jax.random.permutation(k1, jmodel.user_num)),
            "perm_i": t(jax.random.permutation(k2, jmodel.item_num))}


@pytest.mark.parametrize("case", list(CASES))
def test_convert_and_generate(case, monkeypatch):
    name, jmodel, params, tmodel, *_ = _pair(case, monkeypatch)
    if name == "kcgn":
        assert tmodel.r_class == jmodel.r_class == (1 if case == "kcgn_r1" else 2)
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    assert tu.shape == ju.shape and ti.shape == ji.shape
    _close(tu.numpy(), ju, f"{case} users")
    _close(ti.numpy(), ji, f"{case} items")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient(case, monkeypatch):
    name, jmodel, params, tmodel, *_ = _pair(case, monkeypatch)
    key = jax.random.PRNGKey(7)
    jbatch, tbatch = _batch(jmodel, 3)
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jbatch, key)
    edge_grad = {}
    if name == "kcgn":
        def apply_linear(p, x, _apply=tkcgn.apply_linear):
            y = _apply(p, x)
            y.register_hook(lambda g: edge_grad.__setitem__("g", g.abs()))
            return y

        monkeypatch.setattr(tkcgn, "apply_linear", apply_linear)
    tloss, taux = tmodel.loss(tbatch, None, draws=_draws(name, jmodel, key))
    tloss.backward()
    _close(tloss.item(), float(jloss), f"{case} loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k].item(), float(jaux[k]), f"{case} {k}")
        assert float(jaux[k]) != 0.0, k
    want = CONVERT[name](jax.device_get(jgrads))
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    scale = {}
    if edge_grad:
        scale = {"time_lin.b": edge_grad["g"].sum(0),
                 "time_lin.w": tmodel.edge_time.abs().T @ edge_grad["g"]}
    for k in want:
        if k in scale:
            err = (got[k] - want[k]).abs()
            assert bool((err <= ATOL + 1e-6 * scale[k]).all()), (k, float(err.max()))
        else:
            _close(got[k].numpy(), want[k].numpy(), f"{case} grad {k}")


@pytest.mark.parametrize("case", ["kcgn_r2_weight", "smin"])
def test_three_adam_steps(case, monkeypatch):
    name, jmodel, params, tmodel, tdata, jcfg, tcfg = _pair(case, monkeypatch)
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tmodel, tdata)
    for step in range(3):
        key = jax.random.PRNGKey(20 + step)
        jbatch, tbatch = _batch(jmodel, 10 + step)
        (jloss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jbatch, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        draws = _draws(name, jmodel, key)
        monkeypatch.setattr(tmodel, "step_draws", lambda gen, d=draws: d)
        aux = trainer.train_step(tbatch, None)
        _close(aux["loss"].item(), float(jloss), f"{case} step {step} loss", rtol=1e-4)
    want = CONVERT[name](jax.device_get(params))
    for k, p in tmodel.named_parameters():
        atol = 2e-4 if k.startswith(("attn_u.l1.", "attn_i.l1.")) else ATOL
        _close(p.detach().numpy(), want[k].numpy(), f"{case} {k}", rtol=1e-4, atol=atol)


def test_step_draws_on_a_generator(monkeypatch):
    for case in ("kcgn_r1", "smin"):
        _, jmodel, _, tmodel, *_ = _pair(case, monkeypatch)
        d1 = tmodel.step_draws(torch.Generator().manual_seed(0))
        d2 = tmodel.step_draws(torch.Generator().manual_seed(0))
        for k, v in d1.items():
            assert torch.equal(v, d2[k])
            assert torch.equal(v.sort().values, torch.arange(v.numel()))


@pytest.mark.parametrize("name", ["kcgn", "smin"])
def test_cli_trains_and_evaluates_on_cpu(name, tmp_path, monkeypatch):
    write_social_dir(tmp_path)
    monkeypatch.chdir(tmp_path)     # the logger writes ./log, the model ./checkpoint_torch
    res = tmp_path / "res"
    trainer = tmain.main(["--model", name, "--data_dir", str(tmp_path), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2", "--set", "train.test_step=1",
                          "--set", "train.batch_size=64", "--set", "model.embedding_size=8",
                          "--set", "test.k=[3, 5, 10]", "--set", f"train.results_dir={res}"])
    doc = json.loads((res / f"{name}_toy.json").read_text())
    assert "partial" not in doc and doc["device"] == "cpu"
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
    assert all(0.0 <= v <= 1.0 for v in doc["test"]["recall"])
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
