"""KGCL, KGIN, KGRec and DiffKG on a {data: 2, model: 2} mesh of gloo
processes: one step against the JAX package's ``value_and_grad`` of the
model's loss, and one epoch of the port's Trainer (its first step, and the
epoch's hooks: KGCL's views and TransE sub-loop, DiffKG's diffusion epoch
and rebuild) against the same epoch on one device.

The ranks run ``parallel.checks.model_step`` and ``checks.trainer_step`` in
one spawn of four.  The JAX side is the single-device model on the tiny KG
of ``tests/test_models_kg.py::_synthetic_kg`` (65 nodes, so that
``all_embed`` row-shards with a padding row), its parameters carried across
by ``utils.convert``; its loss is the whole batch's, which the mesh's ranks
split (31 rows: the two ``data`` slices differ by one).  Draws are
injected as ``tests/test_torch_{kgcl,kgin_kgrec,diffkg}.py`` inject them:
KGCL's and DiffKG's masks through a stand-in ``jax.random.bernoulli`` that
returns the jitted loss's draw arguments while it is traced, KGIN's and
KGRec's made by JAX's own calls under the loss's key.

Tolerances: the loss and its terms rtol 1e-5; the whole gradients
(summed over ``data``, gathered over ``model``) rtol 2e-4 and atol 1e-5 of
the largest entry, as ``test_torch_mesh_ssl_step.py`` holds item 7's.  The
Trainer's epoch: those of ``test_mesh_step_matches_single_step`` (loss
terms rtol 1e-6, gradients rtol 1e-5, the tables after Adam rtol 2e-4 /
atol 2e-6), the gradients' atol 1e-5 of the largest entry, as against JAX:
KGIN's distance correlation cancels a diagonal whose float32 rounding is
1e-4 to 5e-3 of its gradient (``test_torch_kgin_kgrec.py``), and the mesh
scales that term by each rank's share of the batch before its backward, so
its small entries move by up to 8e-6 of the largest; DiffKG's denoiser and
denoised KG, which every rank computes from the same whole tables and
draws, exactly.  The single epoch runs in each rank, in the same process
as the mesh's (the same float32 kernels).

A replicated parameter's gradient left unsummed over ``model``, a detached
entity-table gather, or the TransE sub-loop's gradients left unsummed over
``data`` fails these.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import kg as jkg
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu_torch.parallel import checks, launch
from sslrec_tpu_torch.utils import convert
from test_models_kg import _synthetic_kg
from test_torch_kgin_kgrec import kgin_draws, kgrec_draws

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

BATCH = 31
SMALL = {"model.embedding_size": 8, "model.triplet_num": 5}
OVERRIDES = {"kgcl": SMALL, "kgin": SMALL, "kgrec": {**SMALL, "model.mae_msize": 8},
             "diffkg": {**SMALL, "model.dims_list": [16], "model.d_emb_size": 4}}
TRAINER_CASES = {"kgcl": ("kgcl", {}),
                 "kgcl_trans": ("kgcl", {"model.train_trans": True,
                                         "train.kg_batch_size": 32}),
                 "kgin": ("kgin", {}), "kgrec": ("kgrec", {}), "diffkg": ("diffkg", {})}
CONVERT = {m: getattr(convert, f"{m}_params_from_jax") for m in OVERRIDES}


def _kg():
    train_cf, test_cf, trip, n_ent, n_rel = _synthetic_kg()
    return {"train_cf": train_cf, "test_cf": test_cf, "triplets": trip,
            "n_entities": n_ent, "n_relations": n_rel}


_DRAWS: list = []      # the stand-in draws of the JAX loss being traced, in call order


@functools.lru_cache(maxsize=None)
def _jax_loss(model):
    """``value_and_grad`` of ``model``'s loss, jitted, the stand-in draws an
    argument (:data:`_DRAWS`, popped by the stand-in ``bernoulli``)."""
    def f(params, batch, key, draws):
        _DRAWS[:] = list(draws)
        return jax.value_and_grad(model.loss, has_aux=True)(params, batch, key)

    return jax.jit(f)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return np.asarray(x)


def _kgcl_draws(jm, rng):
    """KGCL's epoch views (two KG masks, two UI views' values) and one step's
    node- and message-dropout keeps; the bernoulli stand-in's order."""
    n_kg, n_rect = jm.heads.shape[0], jm.bi.nnz_rect
    kg1, kg2 = ((rng.random(n_kg) < 0.5).astype(np.float32) for _ in range(2))
    m1, m2 = ((rng.random(n_rect) < 0.7).astype(np.float32) for _ in range(2))
    aux = {"kg_mask1": kg1, "kg_mask2": kg2,
           "ui_vals1": np.asarray(jm.bi.view_vals(jnp.asarray(m1))),
           "ui_vals2": np.asarray(jm.bi.view_vals(jnp.asarray(m2)))}
    draws = {"rect_keep": (rng.random(n_rect) < 0.5).astype(np.float32),
             "kg_keep": (rng.random(n_kg) < 0.5).astype(np.float32),
             "mess_keep": rng.random((jm.context_hops, jm.n_entities, jm.embedding_size)) < 0.9}
    order = [draws["rect_keep"] > 0, draws["kg_keep"] > 0, *draws["mess_keep"]]
    return aux, draws, order


def _diffkg_draws(jm, rng):
    """A denoised-KG-shaped edge list (random tails per entity and the
    reverse, relations from the lookup, a kept part) and the step's
    message-dropout keeps; the bernoulli stand-in's order."""
    n = jm.n_entities
    heads = np.arange(n).repeat(2)
    tails = rng.integers(0, n, 2 * n)
    h2, t2 = np.concatenate([heads, tails]), np.concatenate([tails, heads])
    jr, jf = jm._lookup_rel(jnp.asarray(h2, jnp.int32), jnp.asarray(t2, jnp.int32))
    valid = (np.asarray(jf) & (rng.random(h2.size) < 0.6)).astype(np.float32)
    r = np.where(np.asarray(jf), np.asarray(jr), 0)
    dkg = tuple(a.astype(np.int32) for a in (h2, t2, r)) + (valid,)
    shape = (jm.context_hops, n, jm.embedding_size)
    draws = {k: rng.random(shape) < 1 - jm.mess_dropout_rate for k in ("mess_main", "mess_kg")}
    return {"dkg": dkg}, draws, [*draws["mess_main"], *draws["mess_kg"]]


def _jax_case(name, kg):
    """The JAX model and its ``value_and_grad`` on the whole batch under the
    case's draws; the port's ``model_step`` inputs."""
    cfg = jload_config(name, overrides=OVERRIDES[name])
    jm = jbuild(cfg, jkg.bundle_from_kg(cfg, kg["train_cf"], kg["test_cf"], kg["triplets"],
                                        kg["n_entities"], kg["n_relations"]))
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    idx = {"user": rng.integers(0, jm.user_num, BATCH), "pos": rng.integers(0, jm.item_num, BATCH),
           "neg": rng.integers(0, jm.item_num, BATCH)}
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in idx.items()}
    aux, order = None, []
    if name == "kgcl":
        aux, draws, order = _kgcl_draws(jm, rng)
    elif name == "diffkg":
        aux, draws, order = _diffkg_draws(jm, rng)
    else:
        draws = _np({"kgin": kgin_draws, "kgrec": kgrec_draws}[name](jm, key))
    if aux is not None:
        jbatch["aux"] = jax.tree.map(jnp.asarray, aux)
    with pytest.MonkeyPatch.context() as mp:
        if order:
            mp.setattr(jax.random, "bernoulli", lambda *a, **k: _DRAWS.pop(0))
        (loss, terms), grads = _jax_loss(jm)(params, jbatch, key,
                                             [jnp.asarray(o) for o in order])
    assert not _DRAWS
    whole = {k: v.numpy() for k, v in CONVERT[name](jax.device_get(params)).items()}
    inp = {"model": name, "n_data": 2, "n_model": 2, "overrides": OVERRIDES[name], "kg": kg,
           "params": whole, "key": None, **{k: v.astype(np.int32) for k, v in idx.items()},
           "aux": aux, "draws": draws}
    want = {k: v.numpy() for k, v in CONVERT[name](jax.device_get(grads)).items()}
    return (float(loss), {k: float(v) for k, v in terms.items()}, want), inp


def _trainer_case(case, n_data, n_model, kg):
    model, over = TRAINER_CASES[case]
    return {"model": model, "n_data": n_data, "n_model": n_model, "kg": kg,
            "overrides": {**OVERRIDES[model], "train.batch_size": 31,
                          "optimizer.weight_decay": 1e-4, **over}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    kg = _kg()
    jax_side, todo = {}, []
    for name in OVERRIDES:
        jax_side[name], inp = _jax_case(name, kg)
        todo.append((name, "model_step", inp))
    for case in TRAINER_CASES:
        todo += [(f"trainer.{case}", "trainer_step", _trainer_case(case, 2, 2, kg)),
                 (f"single.{case}", "trainer_step", _trainer_case(case, 1, 1, kg))]
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("kg23")))
    return jax_side, out


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_mesh_step_matches_jax(ranks, name):
    """The loss terms and the whole gradients of one {2, 2} step against
    ``jax.value_and_grad`` of the JAX model's loss on the whole batch."""
    jax_side, out = ranks
    jloss, jterms, jgrads = jax_side[name]
    shards = {"diffkg": {"u_embeds": 15, "e_embeds": 18}}.get(name, {"all_embed": 33})
    for r in out:
        got = r[name]
        assert {k: s[0] for k, s in got["local_shapes"].items()} == shards
        np.testing.assert_allclose(got["terms"]["loss"], jloss, rtol=1e-5)
        assert set(got["terms"]) == {*jterms, "loss"}
        for k, v in jterms.items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}: {k}")
        assert set(got["grads"]) == set(jgrads)
        for k, want in jgrads.items():
            if got["grads"][k] is None:      # KGCL's rgat_w and rgat_a: unused
                assert not want.any(), f"{name}: {k}"
                continue
            np.testing.assert_allclose(got["grads"][k], want, rtol=2e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{name}: {k}")


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_mesh_epoch_matches_single(ranks, case):
    """One epoch of one step (with the epoch's hooks) of the port's Trainer on
    the {2, 2} mesh against the same epoch on one device: the loss terms,
    the last step's gradients (summed over ``data``; the TransE sub-loop's
    last step for ``kgcl_trans``), the tables after Adam, and DiffKG's
    denoiser and denoised KG on every rank."""
    _, out = ranks
    for r in out:
        got, single = r[f"trainer.{case}"], r[f"single.{case}"]
        assert set(got) == set(single)
        for k, v in single["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-6, err_msg=f"{case}: {k}")
        for k, want in single.items():
            if k in ("loss", "terms") or want is None:
                assert want is None or k in ("loss", "terms")
                continue
            if k.startswith(("dn.", "dkg.")):
                np.testing.assert_array_equal(got[k], want, err_msg=f"{case}: {k}")
            elif k.endswith(".grad"):
                np.testing.assert_allclose(got[k], want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max(),
                                           err_msg=f"{case}: {k}")
            else:
                np.testing.assert_allclose(got[k], want, rtol=2e-4, atol=2e-6,
                                           err_msg=f"{case}: {k}")
    assert "kg_loss" in out[0]["trainer.kgcl_trans"]["terms"]
    assert any(k.startswith("dn.") for k in out[0]["trainer.diffkg"])
