"""The port's MHCN and DSL against the JAX package on a tiny synthetic social
split (embedding 16; the helpers and split of ``test_torch_social_models.py``):
the loss, every loss term and every parameter gradient under the same draws;
DSL's social negatives in the epoch draws; and one DSL trainer step with the
gradient clip active and weight decay on, against
``optax.chain(clip_by_global_norm(10), add_decayed_weights, adam)``.

Random draws are JAX's, injected: MHCN's permutations, DSL's user pairs and
dropout masks.

Tolerances: rtol 1e-5, atol 1e-6 for a forward and backward pass; the
parameters after one Adam step within atol 1e-6 (the step is lr-sized).
"""

import jax
import numpy as np
import optax
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import social as jsocial
from sslrec_tpu.trainer.trainer import Trainer as JTrainer
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import social as tsocial
from sslrec_tpu_torch.trainer.trainer import Trainer as TTrainer
from test_torch_social_data import social_split
from test_torch_social_models import CONVERT, _batch, _check_loss, _pair

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


class _Silent:
    def log(self, *a, **k):
        pass

    log_loss = log_eval = log


def _mhcn_draws(jmodel, key):
    """JAX's permutations under the loss's key, as the port's draws."""
    n, d = jmodel.user_num, jmodel.embedding_size
    out = []
    for kc in jax.random.split(key, 3):
        k1, k2, k3, _ = jax.random.split(kc, 4)
        p = {"row1": jax.random.permutation(k1, n)}
        for tag, k in (("2", k2), ("3", k3)):
            ka, kb = jax.random.split(k)
            p["col" + tag] = jax.random.permutation(ka, d)
            p["row" + tag] = jax.random.permutation(kb, n)
        out.append({k: torch.tensor(np.asarray(v), dtype=torch.int64) for k, v in p.items()})
    return out


def test_mhcn_loss_and_grads():
    jmodel, params, tmodel = _pair("mhcn")
    key = jax.random.PRNGKey(4)
    jbatch, tbatch = _batch(jmodel, 3)
    _check_loss("mhcn", jmodel, params, tmodel, jbatch, tbatch, key,
                draws=_mhcn_draws(jmodel, key))


def _dsl_inputs(jmodel, key, seed, b=64):
    U = jmodel.user_num
    jbatch, tbatch = _batch(jmodel, seed, b, suser=U, spos=U, sneg=U, sal_u1=U, sal_u2=U)
    _, kl = jax.random.split(key)
    k1, k2 = jax.random.split(kl)
    draws = {"sal_u1": tbatch.pop("sal_u1"), "sal_u2": tbatch.pop("sal_u2"),
             "keep1": torch.tensor(np.asarray(
                 jax.random.bernoulli(k1, 0.5, (b, jmodel.embedding_size)))),
             "keep2": torch.tensor(np.asarray(jax.random.bernoulli(k2, 0.5, (b, 1))))}
    return jbatch, tbatch, draws


def test_dsl_loss_and_grads():
    jmodel, params, tmodel = _pair("dsl")
    key = jax.random.PRNGKey(6)
    jbatch, tbatch, draws = _dsl_inputs(jmodel, key, 4)
    assert 0 < int(draws["keep1"].sum()) < draws["keep1"].numel()
    _check_loss("dsl", jmodel, params, tmodel, jbatch, tbatch, key, draws=draws)


def test_dsl_step_clips_before_decay_and_adam():
    """One trainer step at weight_decay 0.5 with the global-norm clip active."""
    over = {"optimizer.weight_decay": 0.5, "optimizer.lr": 1e-2}
    jmodel, params, tmodel = _pair("dsl", **over)
    mats = social_split()
    jcfg = jload_config("dsl", overrides={"model.embedding_size": 16, **over})
    jtrainer = JTrainer(jcfg, jmodel, jsocial.bundle_from_matrices(jcfg, *mats), _Silent())
    key = jax.random.PRNGKey(8)
    jbatch, tbatch, draws = _dsl_inputs(jmodel, key, 5, b=512)
    grads = jax.grad(lambda p: jmodel.loss(p, jbatch, key)[0])(params)
    norm = float(optax.global_norm(grads))
    assert norm > 2 * jmodel.grad_clip, f"the clip is not active: norm {norm}"
    updates, _ = jtrainer.optimizer.update(grads, jtrainer.optimizer.init(params), params)
    want = CONVERT["dsl"](jax.device_get(optax.apply_updates(params, updates)))

    ttrainer = TTrainer(tload_config("dsl", overrides={"model.embedding_size": 16, **over}),
                        tmodel, tmodel_data(tmodel), _Silent())
    assert ttrainer.grad_clip == 10.0
    tmodel.step_draws = lambda gen, n: draws
    ttrainer.train_step({**tbatch, "step": 0}, None)
    for k, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"after the step: {k}")


def tmodel_data(tmodel):
    """A port bundle of the test split for a trainer (the model holds its graphs)."""
    return tsocial.bundle_from_matrices(tmodel.cfg, *social_split())


def test_dsl_extra_negatives_in_the_epoch_draws():
    _, _, tmodel = _pair("dsl", **{"train.batch_size": 128})
    data = tmodel_data(tmodel)
    trainer = TTrainer(tmodel.cfg, tmodel, data, _Silent())
    idx, sampled, _ = trainer.epoch_draws(0)
    arrays = data.extras["train_arrays"]
    assert set(sampled) == {"neg", "sneg"}
    assert sampled["sneg"].shape == arrays["suser"].shape
    edges = data.extras["trust_edge_set"]
    hit = edges.contains(arrays["suser"], sampled["sneg"])
    assert hit.float().mean() < 0.05             # rejection leaves few trust edges
    assert trainer.n_batches * trainer.batch_size >= data.n_train == arrays["user"].shape[0]
