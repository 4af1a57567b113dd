"""SGL (three augmentations), SimGCL, NCL and DirectAU on a {data: 2,
model: 2} mesh of gloo processes: one step against the JAX package's
``value_and_grad`` of the model's loss, and one step of the port's Trainer
against its single-device step.

The ranks run ``parallel.checks.model_step`` and ``checks.trainer_step`` in
one spawn of four.  The JAX side is the single-device model (its loss is
the whole batch's, which the mesh's ranks split), fed the tiny graph,
parameters, batch and draws of ``tests/test_torch_ssl_models.py``: the
dropout PRF bit for bit, SimGCL's noise, node drop's uniforms and NCL's
clusters as ``draws``.  The batch has 31 rows, so the two ``data`` slices
differ by one (DirectAU's uniformity gathers them padded).

Tolerances: the loss rtol 1e-5; the whole gradients (summed over ``data``,
gathered over ``model``) rtol 2e-4 and atol 1e-5 of the largest entry, as
``test_sharded_step_matches_jax`` holds LightGCN's.  The Trainer's step:
those of ``test_mesh_step_matches_single_step`` (the loss rtol 1e-6, the
gradients rtol 1e-5, the tables after Adam rtol 2e-4 / atol 2e-6), with the
gradients' atol 1e-9 raised to 1e-6 of the largest entry where that is
larger, the rule of ``test_torch_ssl_models.py`` for these models: the
slices' contrastive terms, summed in another order, cancel at entries near
zero with float32 rounding that the 1/temperature before every logit
multiplies.  The clean BPR view read
through the detached ``propagate()``, or an L2 term left unsummed over the
``model`` group, fails these.
"""

import jax
import numpy as np
import pytest
import torch

from sslrec_tpu.data.general_cf import bundle_from_matrices as jbundle
from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu_torch.parallel import checks, launch
from sslrec_tpu_torch.utils import convert
from test_torch_lightgcn import _batch, _keys, _mats
from test_torch_parallel import _trainer_inputs
from test_torch_ssl_models import CASES, _draws, prf_edge_drop  # noqa: F401 (a fixture)

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

STEP_CASES = ("sgl", "sgl_random_walk", "sgl_node_drop", "simgcl", "ncl", "directau")
TRAINER_MODELS = ("sgl", "simgcl", "ncl", "directau")
TRAINER_OVERRIDES = {"ncl": {"model.cluster_num": 8}}
BATCH = 31


def _jax_case(case, mats):
    """The JAX model, its init parameters, the whole batch (both packages'),
    the step keys and the draws of ``case``; the port's ``model_step``
    inputs."""
    name, jcls, ov, _ = CASES[case]
    jmodel = jcls(jload_config(name, overrides=ov), jbundle(*mats))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    jbatch, tbatch = _batch(jmodel.user_num, jmodel.item_num, 1, b=BATCH)
    jkey, tkey = _keys(1)
    extra, draws = _draws(case, jmodel, params, jkey)
    jbatch = {**jbatch, **extra}
    whole = {k: v.numpy() for k, v in
             getattr(convert, f"{name}_params_from_jax")(jax.device_get(params)).items()}
    inp = {"model": name, "n_data": 2, "n_model": 2, "overrides": ov,
           "trn": mats[0].toarray(), "val": mats[1].toarray(), "tst": mats[2].toarray(),
           "params": whole, "key": tkey.numpy(),
           **{k: v.numpy() for k, v in tbatch.items()},
           "aux": {k: np.asarray(v) for k, v in extra["aux"].items()} if extra else None,
           "draws": None if draws is None else {k: v.numpy() for k, v in draws.items()}}
    return (jmodel, params, jbatch, jkey), inp


def _trainer_case(model):
    inp = _trainer_inputs(2, 2)
    inp["model"] = model
    inp["overrides"] = {**inp["overrides"], "train.batch_size": 63,
                        **TRAINER_OVERRIDES.get(model, {})}
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    mats = _mats()
    jax_side, todo = {}, []
    for case in STEP_CASES:
        jax_side[case], inp = _jax_case(case, mats)
        todo.append((case, "model_step", inp))
    todo += [(f"trainer.{m}", "trainer_step", _trainer_case(m)) for m in TRAINER_MODELS]
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("ssl22")))
    return jax_side, out


@pytest.mark.parametrize("case", STEP_CASES)
def test_mesh_step_matches_jax(ranks, prf_edge_drop, case):  # noqa: F811
    """The loss terms and the whole gradients of one {2, 2} step against
    ``jax.value_and_grad`` of the JAX model's loss on the whole batch."""
    jax_side, out = ranks
    jmodel, params, jbatch, jkey = jax_side[case]
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jbatch, jkey)
    for r in out:
        got = r[case]
        assert got["local_rows"] == jmodel.user_num // 2
        np.testing.assert_allclose(got["terms"]["loss"], float(jloss), rtol=1e-5)
        assert set(got["terms"]) == {*jaux, "loss"}
        for k, v in jaux.items():
            np.testing.assert_allclose(got["terms"][k], float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case}: {k}")
        assert set(got["grads"]) == set(jgrads)
        for k, v in jgrads.items():
            want = np.asarray(v)
            np.testing.assert_allclose(got["grads"][k], want, rtol=2e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{case}: {k}")


@pytest.mark.parametrize("model", TRAINER_MODELS)
def test_trainer_mesh_step_matches_single_step(ranks, model):
    """One step of the port's Trainer on the {2, 2} mesh against the same
    step on one device (63 rows a batch, weight decay on): the gradients
    summed over ``data`` and the tables after weight decay and Adam."""
    _, out = ranks
    inp = _trainer_case(model)
    single = checks.trainer_step({**inp, "n_data": 1, "n_model": 1})
    for r in out:
        got = r[f"trainer.{model}"]
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6)
        for k in ("user_embeds", "item_embeds"):
            want = single[k + ".grad"]
            np.testing.assert_allclose(got[k + ".grad"], want, rtol=1e-5,
                                       atol=max(1e-9, 1e-6 * np.abs(want).max()),
                                       err_msg=f"{model}: {k}")
            np.testing.assert_allclose(got[k], single[k], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{model}: {k}")
