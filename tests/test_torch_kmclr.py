"""KMCLR of the port against the JAX package on the small Tmall-named split of
``test_torch_mb_data.py`` (300 users × 200 items, d 8) with 8,200 random
triplets over items 0–149 (items 150–199 have none, so their entity lists
are all pad) into 400 entities and 3 relations: weights carried across and
``generate()``; the relation GAT (with and without an entity mask) and
TransR's and TATEC's losses, values and every gradient; ``make_views``
given the same uniforms; one BPR + contrast step and one whole epoch hook
(2 TransR/TATEC batches of 4,096, the views, 2 contrast steps, the KG
users) followed by two train steps, parameters and Adam moments; a CPU CLI
run; B1's calls counted on the CPU.

Draws are injected into JAX as in ``test_torch_cml.py`` (``randint``,
``uniform``, ``permutation``, ``bernoulli`` as ``U < p``, and
``sample_negatives`` in both modules), and ``jax.lax.scan`` runs as a
Python loop while the hook is traced, so that each of its steps takes its
own draws.

Tolerances: rtol 1e-5 on values, 1e-4 on gradients (atol 1e-6 times the
largest entry where that exceeds 1), in float32.  The contrast step, the
hook and the train steps are held in float64 on both sides (a fresh Adam
moves every entry by about ``lr·sign(g)``, so float32 noise in a gradient
that is zero in exact arithmetic, such as the GAT's bias under the
softmax, would move it by a full ``2·lr``): within 1e-10 of a tensor's
largest entry where the views come from JAX, 1e-6 in the whole hook, whose
views both packages make in float32 (JAX's ``make_views`` casts its keep
mask to float32), where their ``deg ** -0.5`` differ in the last bit for
about a quarter of the degrees.
"""

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu.models.multi_behavior import cml as jcml
from sslrec_tpu.models.multi_behavior import kmclr as jkmclr
from sslrec_tpu.models.registry import build_model as jbuild_model
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.utils import convert
from test_torch_mb_data import mb_split, write_mb_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-6
SMALL = {"model.embedding_size": 8, "model.latent_dim_rec": 8, "train.batch_size": 64,
         "train.SSL_batch": 2, "model.bpr_batch_size": 900, "test.k": [3, 5],
         "test.batch_size": 64}
B = 64


def kg_triplets(n=8200, seed=7):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 150, n), rng.integers(0, 3, n),
                     rng.integers(0, 400, n)], 1).astype(np.int64)


def _precision(f64):
    return jax.enable_x64(True) if f64 else contextlib.nullcontext()


def _over(**over):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in {**SMALL, **over}.items()))


@functools.lru_cache(maxsize=None)
def _jax_side(over, f64=False):
    behaviors, mats, _, tst = mb_split()
    jcfg = jload_config("kmclr", overrides=dict(over))
    jdata = jmb.bundle_from_behaviors(jcfg, behaviors, mats, tst, kg_triplets=kg_triplets())
    jmodel = jbuild_model(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    if f64:
        with _precision(True):
            params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
    return jmodel, params


def _build(f64=False, device="cpu", **over):
    behaviors, mats, _, tst = mb_split()
    jmodel, params = _jax_side(_over(**over), f64)
    tcfg = tload_config("kmclr", overrides=dict(_over(**over)))
    tdata = tmb.bundle_from_behaviors(tcfg, behaviors, mats, tst, kg_triplets=kg_triplets(),
                                      device=device)
    tmodel = build_model(tcfg, tdata)
    tmodel.load_state_dict(convert.kmclr_params_from_jax(
        jax.tree.map(lambda p: np.asarray(p, np.float32), params)))
    if f64:
        tmodel.double()
        _load64(tmodel, params)
    return jmodel, params, tmodel, tdata


def _load64(tmodel, params):
    with torch.no_grad():
        for k, v in convert._tree("", params).items():
            tmodel.get_parameter(k).copy_(torch.from_numpy(np.array(v)))


_DRAWS: dict = {}


def _py_scan(f, init, xs):
    carry, ys = init, []
    for i in range(xs.shape[0]):
        carry, y = f(carry, xs[i])
        ys.append(y)
    return carry, jnp.stack(ys)


def _stand_in(monkeypatch):
    def pop(fn):
        return lambda *a, **k: _DRAWS[fn].pop(0)

    for fn in ("randint", "uniform", "permutation"):
        monkeypatch.setattr(jax.random, fn, pop(fn))
    for mod in (jcml, jkmclr):
        monkeypatch.setattr(mod, "sample_negatives", pop("sample_negatives"))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: _DRAWS["bernoulli"].pop(0) < p)
    monkeypatch.setattr(jax.lax, "scan", _py_scan)


def _set_draws(jd):
    _DRAWS.clear()
    _DRAWS.update({k: list(v) for k, v in jd.items()})


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_grad(got, want):
    _close(got, want, GRAD_RTOL, ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _scaled(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _grads_match(tmodel, jg):
    want = convert.kmclr_params_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), jg))
    for k, p in tmodel.named_parameters():
        if p.grad is None:
            assert not want[k].numpy().any(), k
            continue
        _close_grad(p.grad, want[k].numpy())


def test_weights_carried_across_and_generate():
    jmodel, params, tmodel, _ = _build()
    assert tmodel.kg_cap == jmodel.kg_cap == 32
    np.testing.assert_array_equal(tmodel.item_ents.numpy(), np.asarray(jmodel.item_ents))
    np.testing.assert_array_equal(tmodel.item_rels.numpy(), np.asarray(jmodel.item_rels))
    assert (tmodel.item_ents[150:] == tmodel.n_entities).all()      # pad-only items
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jax.jit(jmodel.generate)(params)
    _close(tu, ju)
    _close(ti, ji)


@pytest.mark.parametrize("index,masked", [(0, False), (1, True)])
def test_relation_gat_value_and_gradients(index, masked):
    jmodel, params, tmodel, _ = _build()
    rng = np.random.default_rng(index)
    mask = rng.random(tuple(tmodel.item_ents.shape)) < 0.5 if masked else None
    proj = rng.standard_normal((tmodel.item_num, 8)).astype(np.float32)

    def f(kg):
        out = jmodel._rgat_items(kg, index, None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * proj), out

    (_, jout), jg = jax.value_and_grad(f, has_aux=True)(params["kg"])
    out = tmodel.rgat_items(index, None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(proj)).sum().backward()
    _close(out, jout)
    assert np.asarray(jout)[150:].any()         # pad-only items: the pad entity's row
    _grads_match(tmodel, {"mb": jax.tree.map(jnp.zeros_like, params["mb"]), "kg": jg})


@pytest.mark.parametrize("mode", ["transR", "TATEC"])
def test_trans_loss_value_and_gradients(mode):
    jmodel, params, tmodel, _ = _build()
    rng = np.random.default_rng(3)
    trip = kg_triplets()[rng.integers(0, 8200, 256)]
    neg = rng.integers(0, 400, 256)
    index = 0 if mode == "transR" else 1
    jloss, jg = jax.value_and_grad(lambda kg: jmodel._trans_loss(
        kg, (*(jnp.asarray(trip[:, i], jnp.int32) for i in range(3)), jnp.asarray(neg, jnp.int32)),
        index, mode))(params["kg"])
    h, r, t = torch.from_numpy(trip).unbind(1)
    loss = tmodel.trans_loss(h, r, t, torch.from_numpy(neg), index, mode)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    _grads_match(tmodel, {"mb": jax.tree.map(jnp.zeros_like, params["mb"]), "kg": jg})


def view_draws(tmodel, rng):
    """``make_views``' draws: per view two entity masks' uniforms and the
    keep uniforms; the port's by name (masks as ``U < 0.5``), JAX's list."""
    d, bern = {}, []
    for v in range(2):
        for k, shape in (("m1", tuple(tmodel.item_ents.shape)),
                         ("m2", tuple(tmodel.item_ents.shape)), ("keep_u", (tmodel.n_buy,))):
            d[f"view{v}.{k}"] = rng.random(shape, dtype=np.float32)
            bern.append(d[f"view{v}.{k}"])
    td = {k: torch.from_numpy(v < 0.5 if not k.endswith("keep_u") else v) for k, v in d.items()}
    return td, bern


def hook_draws(tmodel, seed):
    rng = np.random.default_rng(seed)
    td, jd = {}, {"randint": [], "sample_negatives": []}
    n_trip = tmodel.kg_trip.shape[0]
    for s in range(tmodel.n_trans):
        td[f"trip{s}"] = rng.integers(0, n_trip, tmodel.kg_bsz)
        td[f"trip_neg{s}"] = rng.integers(0, tmodel.n_entities, tmodel.kg_bsz)
    vd, jd["bernoulli"] = view_draws(tmodel, rng)
    for s in range(tmodel.n_bpr):
        td[f"bpr{s}"] = rng.integers(0, tmodel.n_buy, tmodel.bpr_bsz)
        td[f"bpr_neg{s}"] = rng.integers(0, tmodel.item_num, tmodel.bpr_bsz)
    for kind in ("trip", "bpr"):
        n = tmodel.n_trans if kind == "trip" else tmodel.n_bpr
        jd["randint"] += [np.asarray(td[f"{kind}{s}"], np.int32) for s in range(n)]
        jd["sample_negatives"] += [np.asarray(td[f"{kind}_neg{s}"], np.int32) for s in range(n)]
    return {**_t(td), **vd}, jd


def test_make_views_given_the_draws(monkeypatch):
    jmodel, params, tmodel, _ = _build()
    rng = np.random.default_rng(11)
    td, bern = view_draws(tmodel, rng)
    _stand_in(monkeypatch)
    _set_draws({"bernoulli": bern})
    jmodel._build_kg_fns()
    jviews = jmodel._kg_fns["make_views"](params["kg"], jax.random.PRNGKey(0))
    views = tmodel.make_views(StepDraws(None, td, "cpu"))
    for v, key in zip(views, ("uiv1", "uiv2")):
        assert v.dtype == torch.float32
        _close(v, jviews[key])
        assert 0 < int((v == 0).sum()) < v.numel()       # some edges dropped, not all


def _moments(state):
    return optax.tree_utils.tree_get(state, "mu"), optax.tree_utils.tree_get(state, "nu")


def _opt_match(tmodel, opt, state, tol, part):
    """``opt``'s moments against those of an optax Adam ``state`` over the
    subtree ``part`` (``"kg"`` or ``"mb"``) of the parameters."""
    names = dict(tmodel.named_parameters())
    mu, nu = _moments(state)
    if part in mu:
        mu, nu = mu[part], nu[part]
    for (k, m), n in zip(convert._tree(part, mu).items(), convert._tree(part, nu).values()):
        st = opt.state[names[k]]
        _scaled(st["exp_avg"], m, tol)
        _scaled(st["exp_avg_sq"], n, tol)


def test_one_contrast_step_in_float64(monkeypatch):
    """One BPR + contrast step (``bpr_batch_size`` 1100: one step over the
    2,092 buy pairs) on JAX's views: the KG parameters and the KG Adam."""
    jmodel, params, tmodel, _ = _build(f64=True, **{"model.bpr_batch_size": 1100})
    assert tmodel.n_bpr == 1
    rng = np.random.default_rng(13)
    td, bern = view_draws(tmodel, rng)
    idx = rng.integers(0, tmodel.n_buy, 1100)
    neg = rng.integers(0, tmodel.item_num, 1100)
    _stand_in(monkeypatch)
    _set_draws({"bernoulli": bern, "randint": [idx.astype(np.int32)],
                "sample_negatives": [neg.astype(np.int32)]})
    with _precision(True):
        jmodel._build_kg_fns()
        views = jmodel._kg_fns["make_views"](params["kg"], jax.random.PRNGKey(0))
        kgp, state = jmodel._kg_fns["bpr_contrast"](params["kg"], jmodel._kg_opt.init(params["kg"]),
                                                     jax.random.PRNGKey(1), views)
    tmodel.opt_kg = torch.optim.Adam(tmodel.kg.parameters(), lr=tmodel.kg_lr)
    tmodel.bpr_contrast(StepDraws(None, {"bpr0": torch.from_numpy(idx),
                                         "bpr_neg0": torch.from_numpy(neg)}, "cpu"),
                        [torch.from_numpy(np.asarray(views[k])) for k in ("uiv1", "uiv2")])
    names = dict(tmodel.named_parameters())
    for k, v in convert._tree("kg", kgp).items():
        _scaled(names[k], v, 1e-10)
    _opt_match(tmodel, tmodel.opt_kg, state, 1e-10, "kg")


@functools.lru_cache(maxsize=None)
def _jax_step():
    jmodel = _jax_side(_over(), True)[0]

    def f(params, opt_state, batch, key, draws):
        _set_draws(draws)
        return jmodel.train_step(params, opt_state, batch, key)

    return jax.jit(f)


def step_draws(tmodel, seed):
    rng = np.random.default_rng(seed)
    d = {}
    for b in range(3):
        d[f"glob{b}"] = rng.integers(0, tmodel.sampler.items[b].shape[0], B)
        d[f"off{b}"] = rng.random(B, dtype=np.float32)
    for b in range(4):
        d[f"neg{b}"] = rng.integers(0, tmodel.item_num, B)
    d["perm"] = rng.permutation(B)
    i32 = lambda a: np.asarray(a, np.int32)     # noqa: E731
    jd = {"randint": [i32(d[f"glob{b}"]) for b in range(3)],
          "uniform": [d[f"off{b}"] for b in range(3)],
          "sample_negatives": [i32(d[f"neg{b}"]) for b in range(4)],
          "permutation": [i32(d["perm"])] * 2}      # one key, both rounds
    return _t(d), jd


def test_epoch_hook_and_two_steps_in_float64(monkeypatch):
    jmodel, params, tmodel, tdata = _build(f64=True)
    assert (tmodel.n_trans, tmodel.kg_bsz, tmodel.n_bpr) == (2, 4096, 2)
    td, jd = hook_draws(tmodel, 17)
    _stand_in(monkeypatch)
    _set_draws(jd)
    with _precision(True):
        aux = jmodel.epoch_state(params, jax.random.PRNGKey(2), 0)
    taux = tmodel.epoch_state(None, 0, draws=td)
    assert set(tmodel.hook_s) == {"trans_epoch", "make_views", "bpr_contrast", "get_all"}
    names = dict(tmodel.named_parameters())
    for k, v in convert._tree("kg", aux["kg_params"]).items():
        _scaled(names[k], v, 1e-6)
    _opt_match(tmodel, tmodel.opt_kg, jmodel._epoch_kg_opt_state, 1e-6, "kg")
    _scaled(taux["kg_user"], aux["kg_user"], 1e-6)
    # the steps from the same KG side: JAX's hook's, in both
    _load64(tmodel, {"kg": aux["kg_params"]})
    taux = {"kg_user": torch.from_numpy(np.array(aux["kg_user"]))}
    with _precision(True):
        state = jmodel.init_opt_state(params)
    rng = np.random.default_rng(19)
    for step in range(2):
        idx = {"user": rng.integers(0, tdata.user_num, B).astype(np.int32),
               "pos": rng.integers(0, tdata.item_num, B).astype(np.int32)}
        sd, sjd = step_draws(tmodel, 30 + step)
        with _precision(True):
            params, state, jout = _jax_step()(
                params, state, {**{k: jnp.asarray(v) for k, v in idx.items()}, "aux": aux},
                jax.random.PRNGKey(step), sjd)
        tout = tmodel.train_step({**_t(idx), "aux": taux}, None, draws=sd)
        for k in ("loss", "bpr_loss", "infonce_loss"):
            np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-10)
    for k, v in convert._tree("", params).items():
        _scaled(names[k], v, 1e-10)
    _opt_match(tmodel, tmodel.opt_model, state["model"], 1e-10, "mb")
    kg_mu = optax.tree_utils.tree_get(state["model"], "mu")["kg"]
    assert not any(np.asarray(x).any() for x in jax.tree.leaves(kg_mu))    # zero moments


class _Count:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **k):
        self.n += 1
        return self.fn(*a, **k)


def test_b1_calls_of_the_hook_a_step_and_a_generate(monkeypatch):
    """The all-ones view's values once (1), then a hook of ``n_bpr`` contrast
    steps × (9 hops + 9 dx + 4 GATs' entity and relation gathers' backward),
    the two views' values (2) and ``get_all`` (3); 96 a step (2 rounds of 24
    hops + 24 dx); 24 a ``generate()``."""
    _, _, tmodel, tdata = _build()
    counter = _Count(sk.csr_spmm)
    monkeypatch.setattr(sk, "csr_spmm", counter)
    monkeypatch.setattr(skn, "csr_spmm", counter)       # the segment sums' name for it
    td, _ = hook_draws(tmodel, 17)
    aux = tmodel.epoch_state(None, 0, draws=td)
    assert counter.n == 1 + 26 * tmodel.n_bpr + 2 + 3
    sd, _ = step_draws(tmodel, 30)
    rng = np.random.default_rng(1)
    idx = {"user": torch.from_numpy(rng.integers(0, tdata.user_num, B)),
           "pos": torch.from_numpy(rng.integers(0, tdata.item_num, B))}
    counter.n = 0
    tmodel.train_step({**idx, "aux": aux}, None, draws=sd)
    assert counter.n == 96
    with torch.no_grad():
        tmodel.generate()
    assert counter.n == 120


def test_cli_trains_on_cpu(tmp_path, monkeypatch):
    d = write_mb_dir(tmp_path)
    np.savetxt(os.path.join(d, "kg.txt"), kg_triplets(), fmt="%d")
    monkeypatch.chdir(tmp_path)
    trainer = tmain.main(["--model", "kmclr", "--data_dir", str(tmp_path), "--dataset", "tmall",
                          "--device", "cpu", "--epoch", "2", "--set", "train.save_model=false",
                          "--set", f"train.results_dir={tmp_path / 'res'}",
                          *[f"--set={k}={v}" for k, v in SMALL.items()],
                          "--set", "train.batch_size=512"])
    doc = json.loads((tmp_path / "res" / "kmclr_tmall.json").read_text())
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
    np.testing.assert_array_equal(trainer.data.extras["kg_triplets"], kg_triplets())
    assert trainer.model.n_entities == 400 and trainer.model.n_relations == 3
