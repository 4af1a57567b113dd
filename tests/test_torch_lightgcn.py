"""The port's LightGCN slice against the JAX package on one small graph:
weights carried across, propagation, loss and gradients under the same
dropout mask, five Adam steps, the full-sort evaluator and top-k ties.

Tolerances: rtol 1e-5 (atol 1e-7 for entries near zero) for one forward and
backward pass, sums taken in another order; rtol 1e-4, atol 1e-6 after five
Adam steps, which divide by √v and so magnify those differences; atol 1e-6
on the evaluator's metrics, which count hits and differ only if a rounding
difference reorders two scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_ui_matrix
from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data.general_cf import bundle_from_matrices as jbundle
from sslrec_tpu.models import augment as jaugment
from sslrec_tpu.models.general_cf.lightgcn import LightGCN as JLightGCN
from sslrec_tpu.ops import topk as jtopk
from sslrec_tpu.ops.pallas_spmm import _prf_uniform as j_prf_uniform
from sslrec_tpu.trainer.metrics import Evaluator as JEvaluator
from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models import augment as taugment
from sslrec_tpu_torch.models.general_cf.lightgcn import LightGCN as TLightGCN
from sslrec_tpu_torch.ops import topk as ttopk
from sslrec_tpu_torch.trainer.metrics import Evaluator as TEvaluator
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils.convert import lightgcn_params_from_jax

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


def _mats():
    """The matrices of the ``tiny_bundle`` fixture."""
    return (random_ui_matrix(seed=1), random_ui_matrix(density=0.02, seed=2),
            random_ui_matrix(density=0.02, seed=3))


@pytest.fixture
def models(tiny_bundle):
    """JAX LightGCN with params from ``init_params``, and the port's LightGCN
    carrying the same weights."""
    jcfg, tcfg = jload_config("lightgcn"), tload_config("lightgcn")
    jmodel = JLightGCN(jcfg, tiny_bundle)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tdata = tbundle(*_mats())
    tmodel = TLightGCN(tcfg, tdata)
    tmodel.load_state_dict(lightgcn_params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel, tdata, jcfg, tcfg


@pytest.fixture
def prf_edge_drop(monkeypatch):
    """JAX's edge_drop on a CooGraph made to return the PRF mask that its
    accelerator path (and the port) uses."""
    def edge_drop(key, g, keep_rate, resize_val=False, salts=0):
        u = j_prf_uniform(key, jnp.arange(g.nnz, dtype=jnp.uint32), 0)
        return jnp.floor(u + jnp.float32(keep_rate))

    monkeypatch.setattr(jaugment, "edge_drop", edge_drop)


def _batch(n_users, n_items, seed, b=32):
    rng = np.random.default_rng(seed)
    arrs = {"user": rng.integers(0, n_users, b), "pos": rng.integers(0, n_items, b),
            "neg": rng.integers(0, n_items, b)}
    return ({k: jnp.asarray(v, jnp.int32) for k, v in arrs.items()},
            {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrs.items()})


def _keys(seed):
    k = np.random.default_rng(seed).integers(0, 2**32, 2, dtype=np.uint64)
    return jnp.asarray(k.astype(np.uint32)), torch.from_numpy(k.astype(np.int64))


def test_weights_carried_across_and_propagate(models):
    jmodel, params, tmodel, *_ = models
    np.testing.assert_array_equal(tmodel.user_embeds.detach().numpy(),
                                  np.asarray(params["user_embeds"]))
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-7)
    ew = np.random.default_rng(0).uniform(size=tmodel.adj.nnz).astype(np.float32)
    with torch.no_grad():
        tu, ti = tmodel.propagate(torch.from_numpy(ew))
    ju, ji = jmodel.propagate(params, jnp.asarray(ew))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-7)


def test_loss_and_grads_match_jax(models, prf_edge_drop):
    jmodel, params, tmodel, tdata, *_ = models
    jbatch, tbatch = _batch(tdata.user_num, tdata.item_num, 1)
    jkey, tkey = _keys(1)
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jbatch, jkey)
    tloss, taux = tmodel.loss(tbatch, tkey)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k in ("bpr_loss", "reg_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   rtol=1e-5, atol=1e-7)


def test_adam_steps_match_optax(models, prf_edge_drop):
    jmodel, params, tmodel, tdata, jcfg, tcfg = models
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tmodel, tdata)
    for step in range(5):
        jbatch, tbatch = _batch(tdata.user_num, tdata.item_num, 10 + step)
        jkey, tkey = _keys(10 + step)
        (jloss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, jbatch, jkey)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        aux = trainer.train_step(tbatch, tkey)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-4)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                                   rtol=1e-4, atol=1e-6)


def test_evaluator_matches_jax(models, tiny_bundle):
    jmodel, params, tmodel, tdata, jcfg, tcfg = models
    for jsplit, tsplit in ((tiny_bundle.valid, tdata.valid), (tiny_bundle.test, tdata.test)):
        want = JEvaluator(jmodel, jsplit, jcfg)(params)
        got = TEvaluator(tsplit, tcfg)(tmodel)
        assert set(got) == set(want) == {"recall", "ndcg"}
        for m in want:
            np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6)
    # every metric of the JAX evaluator, on a batch size that wraps the tail
    cfg_j = jcfg.set_path("test.metrics", ["recall", "ndcg", "precision", "mrr"])
    cfg_j = cfg_j.set_path("test.batch_size", 16)
    cfg_t = tcfg.set_path("test.metrics", ["recall", "ndcg", "precision", "mrr"])
    cfg_t = cfg_t.set_path("test.batch_size", 16)
    want = JEvaluator(jmodel, tiny_bundle.test, cfg_j)(params)
    got = TEvaluator(tdata.test, cfg_t)(tmodel)
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6)


def test_topk_ties_go_to_lower_index():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0, 5.0],
                       [0.0, -1.0, 0.0, -1.0, 7.0, 0.0]], np.float32)
    got = ttopk.topk_indices(torch.from_numpy(scores), 4).numpy()
    np.testing.assert_array_equal(got, [[1, 2, 4, 3], [0, 1, 2, 3], [4, 0, 2, 5]])
    np.testing.assert_array_equal(got, np.asarray(jtopk.topk_indices(jnp.asarray(scores), 4)))
    rng = np.random.default_rng(0)
    tied = rng.integers(0, 4, (20, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        ttopk.topk_indices(torch.from_numpy(tied), 10).numpy(),
        np.asarray(jtopk.topk_indices(jnp.asarray(tied), 10)))
    cols = rng.integers(0, 50, (20, 6)).astype(np.int32)
    valid = rng.uniform(size=(20, 6)) < 0.7
    np.testing.assert_array_equal(
        ttopk.masked_topk_indices(torch.from_numpy(tied), torch.from_numpy(cols),
                                  torch.from_numpy(valid), 10).numpy(),
        np.asarray(jtopk.masked_topk_indices(jnp.asarray(tied), jnp.asarray(cols),
                                             jnp.asarray(valid), 10)))


def test_edge_drop_forms(models):
    *_, tmodel, tdata, _, _ = models
    g = tmodel.adj
    key = torch.tensor([7, 8])
    assert taugment.edge_drop(key, g, 1.0) is None
    m = taugment.edge_drop(key, g, 0.5)
    assert m.w.shape == (g.nnz,) and set(m.w.unique().tolist()) <= {0.0, 1.0}
    assert taugment.edge_drop(key, g, 0.5, salts=[0, 1]).w.shape == (2, g.nnz)
    r = taugment.edge_drop(key, g, 0.5, resize_val=True).w
    np.testing.assert_array_equal(r.numpy(), m.w.numpy() / np.float32(0.5))
    plain = taugment.edge_drop_mask(torch.Generator().manual_seed(0), 10_000, 0.7)
    assert abs(float(plain.mean()) - 0.7) < 0.03
