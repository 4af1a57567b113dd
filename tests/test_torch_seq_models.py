"""The port's BERT4Rec, CL4SRec, DuoRec and ICLRec against the JAX package
on the JAX sequential tests' small split (d 16, windows of 10, 1 layer, 2
heads): weights carried across by ``convert``, ``generate()``, the loss and
every parameter gradient under the same draws, and three Adam steps through
the trainer's step against optax.  BERT4Rec runs with the shipped
``masked_budget`` 0 and the opt-in 16; ICLRec's per-epoch clusters are held
to JAX's from the same initial pick.

Random draws: JAX makes them from the step key as its model's ``loss`` does
(:func:`test_torch_seq_layers.tower_masks` and ``aug_draws``), and the
port takes them by name through ``loss``'s ``draws``.

Tolerances: rtol 1e-5, atol 1e-6 for one forward and backward pass; a
gradient takes atol 1e-6 times the largest entry of its tensor where that is
larger; rtol 1e-4, atol 1e-6 after three Adam steps, which divide by √v and
so magnify those differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils import convert
from test_torch_seq_data import make_pair
from test_torch_seq_layers import aug_draws, grad_close, t, tower_masks

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6
B = 16

CASES = {"bert4rec": ("bert4rec", {}), "bert4rec_budget": ("bert4rec", {"model.masked_budget": 4}),
         "cl4srec": ("cl4srec", {}), "duorec": ("duorec", {}), "iclrec": ("iclrec", {})}


@pytest.fixture(params=list(CASES), scope="module")
def pair(request):
    name, extra = CASES[request.param]
    return (name, *make_pair(name, extra))


def jax_draws(name, jmodel, jbatch, key) -> dict:
    """The draws JAX's ``loss`` makes from ``key``, under the port's names."""
    rate, h, n_layers, d = jmodel.dropout_rate, jmodel.n_heads, jmodel.n_layers, jmodel.emb_size
    seqs = jbatch["seq_last" if name == "bert4rec" else "seq"]
    b, l = seqs.shape

    def drop(k):
        return tower_masks(k, n_layers, rate, b, l, d, h)

    if name == "bert4rec":
        kmask, kdrop = jax.random.split(key)
        ku, kr = jax.random.split(kmask)
        return {"mask_u": t(jax.random.uniform(ku, seqs.shape)),
                "rand_items": t(jax.random.randint(kr, seqs.shape, 1, jmodel.item_num + 1,
                                                   dtype=seqs.dtype)),
                "drop": drop(kdrop)}
    if name == "cl4srec":
        kf, ka, k1, k2 = jax.random.split(key, 4)
        return {"drop": drop(kf), **aug_draws(ka, seqs), "drop1": drop(k1), "drop2": drop(k2)}
    if name == "duorec":
        k0, k1, k2, ks = jax.random.split(key, 4)
        cnt = jmodel.cand_count[jbatch["pos"]]
        return {"drop": drop(k0), "drop1": drop(k1), "drop2": drop(k2),
                "sem_j": t(jax.random.randint(ks, jbatch["pos"].shape, 0,
                                              jnp.maximum(cnt, 1)))}
    k0, ka, k1, k2, _, _ = jax.random.split(key, 6)
    return {"drop": drop(k0), **aug_draws(ka, seqs, 0.2, 0.2), "drop1": drop(k1),
            "drop2": drop(k2)}


def batches(name, jmodel, jdata, seed):
    """A batch of B train rows in both packages (and ICLRec's negatives and
    the JAX epoch state)."""
    rng = np.random.default_rng(seed)
    arrays = jdata.extras["train_arrays"]
    idx = rng.choice(jdata.n_train, B, replace=False)
    jb = {k: v[idx] for k, v in arrays.items()}
    if name == "iclrec":
        jb["neg"] = jnp.asarray(rng.integers(1, jdata.item_num, B).astype(np.int32))
    tb = {k: t(v) for k, v in jb.items()}
    return jb, tb


@pytest.fixture(scope="module")
def iclrec_aux():
    jmodel, params, tmodel, jdata, *_ = make_pair("iclrec")
    key = jax.random.PRNGKey(4)
    jaux = jmodel.epoch_state(params, key, 0)
    n = jmodel.train_seqs.shape[0]
    pick = t(jax.random.choice(key, n, (jmodel.num_clusters,), replace=n < jmodel.num_clusters))
    return jaux, tmodel.epoch_state(None, 0, pick=pick)


def test_iclrec_epoch_state_matches_jax(iclrec_aux):
    jaux, taux = iclrec_aux
    for k in ("centroids", "centroids_raw"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _with_aux(name, jb, tb, iclrec_aux):
    if name == "iclrec":
        jb = {**jb, "aux": iclrec_aux[0]}
        tb = {**tb, "aux": {k: t(v) for k, v in iclrec_aux[0].items()}}
    return jb, tb


def test_convert_and_generate(pair):
    name, jmodel, params, tmodel, *_ = pair
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(
        getattr(convert, f"{name}_params_from_jax")(jax.device_get(params)))
    ju, ji = jmodel.generate(params)
    with torch.no_grad():
        tu, ti = tmodel.generate()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    assert ti.shape[0] == tmodel.item_num + 1


def test_loss_and_grads_match_jax(pair, iclrec_aux):
    name, jmodel, params, tmodel, jdata, *_ = pair
    jb, tb = _with_aux(name, *batches(name, jmodel, jdata, 1), iclrec_aux)
    key = jax.random.PRNGKey(11)
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb, key)
    tmodel.zero_grad(set_to_none=True)
    tloss, taux = tmodel.loss(tb, None, jax_draws(name, jmodel, jb, key))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    want = getattr(convert, f"{name}_params_from_jax")(jax.device_get(jgrads))
    for pname, p in tmodel.named_parameters():
        grad_close(p.grad.numpy(), want[pname].numpy(), f"{name}: {pname}")


def test_adam_steps_match_optax(pair, iclrec_aux):
    name, jmodel, params, tmodel, jdata, tdata, jcfg, tcfg = pair
    tmodel.load_state_dict(getattr(convert, f"{name}_params_from_jax")(jax.device_get(params)))
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tmodel, tdata)
    for step in range(3):
        jb, tb = _with_aux(name, *batches(name, jmodel, jdata, 20 + step), iclrec_aux)
        key = jax.random.PRNGKey(30 + step)
        (jloss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        draws = jax_draws(name, jmodel, jb, key)
        tmodel.draws = lambda gen, given=None, d=draws: StepDraws(None, d, "cpu")
        aux = trainer.train_step(tb, None)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-4)
    del tmodel.draws
    want = getattr(convert, f"{name}_params_from_jax")(jax.device_get(params))
    for pname, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[pname].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{name}: {pname}")
