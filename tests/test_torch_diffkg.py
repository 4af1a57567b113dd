"""The port's DiffKG against the JAX package on one small KG (200 entities,
d 8, a denoiser of width 32): the relation lookup exactly (a duplicate
``(h, t)`` with two relations included), one diffusion step's loss,
gradients and Adam step, the rebuild given the same denoiser output (edges,
relations and validity exactly, ties included), the RGAT on a denoised KG,
the loss and every gradient under both ``cl_pattern`` values, a CPU CLI run,
and one step on the card against the CPU.

Draws are injected: into the port by name, into JAX by standing in for
``jax.random.permutation`` / ``randint`` / ``normal`` / ``bernoulli`` with
the same numpy-made arrays, its jitted epoch functions run eagerly.

Tolerances: rtol 1e-5 on values, 1e-4 on gradients (atol 1e-6 times the
largest entry where that exceeds 1), rtol 1e-4 after an Adam step; exact on
structures.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import kg as jkg
from sslrec_tpu.models.kg.diffkg import DiffKG as JDiffKG
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import kg as tkg
from sslrec_tpu_torch.models.kg.diffkg import DiffKG as TDiffKG
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.utils.convert import diffkg_denoiser_from_jax, diffkg_params_from_jax
from test_torch_kg_data import write_kg_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-6
SMALL = {"model.embedding_size": 8, "model.triplet_num": 5, "model.dims_list": [32],
         "train.batch_size": 32, "test.k": [3, 5], "test.batch_size": 16}
N_ENTS = 200


@pytest.fixture(scope="module")
def kg_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("diffkg")
    d = write_kg_dir(root, n_users=40, n_items=30, n_ents=N_ENTS, n_rels=4, n_raw=900)
    with open(d / "kg_final.txt", "a") as f:     # one (h, t) under two relations
        f.write("5 1 7\n5 3 7\n199 0 198\n")
    return root


def _build(root, device="cpu", **overrides):
    ov = {**SMALL, "data.dir": str(root), "data.name": "toy", **overrides}
    jcfg, tcfg = jload_config("diffkg", overrides=ov), tload_config("diffkg", overrides=ov)
    jmodel, tmodel = JDiffKG(jcfg, jkg.load(jcfg)), TDiffKG(tcfg, tkg.load(tcfg, device))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel.load_state_dict(diffkg_params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a).copy()).to(device)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_grad(got, want):
    _close(got, want, GRAD_RTOL, ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _queue(monkeypatch, name, outputs):
    q = [jnp.asarray(o) for o in outputs]
    monkeypatch.setattr(jax.random, name, lambda *a, **k: q.pop(0))
    return q


def test_config_and_weights_carried_across(kg_root):
    assert tload_config("diffkg").to_dict() == jload_config("diffkg").to_dict()
    jmodel, params, tmodel = _build(kg_root)
    assert tmodel.n_entities == N_ENTS
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    _close(tu, ju)
    _close(ti, ji)


def test_lookup_rel_exact(kg_root):
    jmodel, _, tmodel = _build(kg_root)
    trip = jkg.load(jmodel.cfg).extras["kg_triplets_full"]
    rng = np.random.default_rng(3)
    hit = trip[rng.integers(0, len(trip), 1500)]      # pairs in the KG, and random ones
    h = np.concatenate([rng.integers(0, N_ENTS, 1500), hit[:, 0], [5, 7, 199, 0]])
    t = np.concatenate([rng.integers(0, N_ENTS, 1500), hit[:, 2], [7, 5, 198, N_ENTS - 1]])
    jr, jf = jmodel._lookup_rel(jnp.asarray(h, jnp.int32), jnp.asarray(t, jnp.int32))
    tr, tf = tmodel.lookup_rel(_t(h), _t(t))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jf = np.asarray(jf)
    np.testing.assert_array_equal(tr.numpy()[jf], np.asarray(jr)[jf])
    assert 0.4 < jf.mean() < 0.95 and len(trip) == tmodel._map_r.shape[0]
    # the duplicate pair takes the relation first in the h-major, t-minor order
    assert tr[-4].item() == 2 and bool(tf[-4])


def _denoisers(jmodel, tmodel, seed=5):
    dp = jmodel._init_denoise(jax.random.PRNGKey(seed))
    tmodel.load_denoiser(diffkg_denoiser_from_jax(jax.device_get(dp)))
    return dp


def test_diffusion_step_loss_gradients_and_adam(kg_root, monkeypatch):
    jmodel, params, tmodel = _build(kg_root)
    dp = _denoisers(jmodel, tmodel)
    rng = np.random.default_rng(4)
    n = N_ENTS
    draws = {"perm": rng.permutation(n), "ts0": rng.integers(0, jmodel.steps, n),
             "noise0": rng.standard_normal((n, n)).astype(np.float32),
             "drop0": rng.random((n, n)) < 0.5}
    draws["ts0"][:7] = 0                               # the SNR weight's t = 0 branch
    real, seen = optax.adam(jmodel.diff_lr), []

    def update(grads, state, p):
        seen.append(grads)
        return real.update(grads, state, p)

    jmodel._dn_opt = optax.GradientTransformation(real.init, update)
    jmodel._build_diff_fns()
    left = [_queue(monkeypatch, "permutation", [draws["perm"]]),
            _queue(monkeypatch, "randint", [draws["ts0"]]),
            _queue(monkeypatch, "normal", [draws["noise0"]]),
            _queue(monkeypatch, "bernoulli", [draws["drop0"]])]
    with jax.disable_jit():
        jdp, _, jloss = jmodel._diff_epoch(dp, real.init(dp), params, jax.random.PRNGKey(1),
                                           jmodel.kg_rows.cols, jmodel.kg_rows.mask)
    assert not any(left)
    tloss = tmodel.diffusion_epoch(StepDraws(None, {k: _t(v) for k, v in draws.items()}, "cpu"))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    want_g = diffkg_denoiser_from_jax(jax.device_get(seen[0]))
    want_p = diffkg_denoiser_from_jax(jax.device_get(jdp))
    assert set(want_g) == set(tmodel._dn)
    for k, p in tmodel._dn.items():
        _close_grad(p.grad, want_g[k].numpy())
        _close(p, want_p[k].numpy(), rtol=1e-4)


def _fake_denoised(rng, n):
    """Denoiser scores with many ties (integers 0..4)."""
    return rng.integers(0, 5, (n, n)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2])
def test_rebuild_given_the_same_denoiser_output(kg_root, monkeypatch, k):
    jmodel, _, tmodel = _build(kg_root, **{"model.rebuild_k": k})
    rng = np.random.default_rng(10 + k)
    table = _fake_denoised(rng, N_ENTS)
    keep = rng.random(2 * N_ENTS * k) < jmodel.keep_rate
    monkeypatch.setattr(jmodel, "_p_sample", lambda dp, x0: jnp.asarray(table[: x0.shape[0]]))
    monkeypatch.setattr(tmodel, "p_sample", lambda x0: _t(table[: x0.shape[0]]))
    left = _queue(monkeypatch, "bernoulli", [keep])
    jmodel._dn_opt = optax.adam(1e-3)
    jmodel._build_diff_fns()
    with jax.disable_jit():
        h, t, r, v = jmodel._rebuild(None, jax.random.PRNGKey(0), jmodel.kg_rows.cols,
                                     jmodel.kg_rows.mask)["dkg"]
    assert not left
    got = tmodel.rebuild(StepDraws(None, {"keep": _t(keep)}, "cpu"))
    for lay, want in ((got.h, h), (got.t, t), (got.r, r)):
        np.testing.assert_array_equal(lay.ids.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(v))
    assert 0 < float(got.valid.mean()) < 1


def _dkg(jmodel, tmodel, seed):
    """A denoised-KG-shaped edge list: random tails per entity and the reverse,
    relations from the lookup, a kept half; one head with no valid edge."""
    rng = np.random.default_rng(seed)
    n = N_ENTS
    heads = np.arange(n).repeat(2)
    tails = rng.integers(0, n, 2 * n)
    h2, t2 = np.concatenate([heads, tails]), np.concatenate([tails, heads])
    jr, jf = jmodel._lookup_rel(jnp.asarray(h2, jnp.int32), jnp.asarray(t2, jnp.int32))
    valid = (np.asarray(jf) & (rng.random(h2.size) < 0.6)).astype(np.float32)
    valid[h2 == 3] = 0.0
    r = np.where(np.asarray(jf), np.asarray(jr), 0)
    jkg_ = tuple(jnp.asarray(a) for a in (h2.astype(np.int32), t2.astype(np.int32),
                                          r.astype(np.int32), valid))
    return jkg_, tmodel.kg_edges(_t(h2), _t(t2), _t(r), _t(valid))


def test_rgat_on_a_denoised_kg(kg_root):
    jmodel, params, tmodel = _build(kg_root)
    jd, td = _dkg(jmodel, tmodel, 6)
    with torch.no_grad():
        tu, ti = tmodel.forward(td)
        th = tmodel._rgat(td)
    ju, ji = jmodel.forward(params, jax.random.PRNGKey(0), kg=jd)
    _close(th, jmodel._rgat(params, None, *jd[:3], jd[3], False))
    _close(tu, ju)
    _close(ti, ji)


def _batch(jmodel, seed, b=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, hi, b).astype(np.int32) for k, hi in
            (("user", jmodel.user_num), ("pos", jmodel.item_num), ("neg", jmodel.item_num))}


@pytest.mark.parametrize("cl_pattern", [0, 1])
def test_loss_and_every_gradient(kg_root, monkeypatch, cl_pattern):
    jmodel, params, tmodel = _build(kg_root, **{"model.cl_pattern": cl_pattern})
    jd, td = _dkg(jmodel, tmodel, 7)
    idx = _batch(jmodel, 8)
    rng = np.random.default_rng(9)
    shape = (jmodel.context_hops, N_ENTS, jmodel.embedding_size)
    masks = {k: rng.random(shape) < 1 - jmodel.mess_dropout_rate for k in ("mess_main",
                                                                            "mess_kg")}
    left = _queue(monkeypatch, "bernoulli", [*masks["mess_main"], *masks["mess_kg"]])
    jb = {**{k: jnp.asarray(v) for k, v in idx.items()}, "aux": {"dkg": jd}}
    (jloss, jaux), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jb, jax.random.PRNGKey(3))
    assert not left
    tloss, taux = tmodel.loss({**{k: _t(v) for k, v in idx.items()}, "aux": {"dkg": td}},
                              None, draws={k: _t(v) for k, v in masks.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    for k in ("bpr_loss", "reg_loss", "cl_loss"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=RTOL)
    for name, p in tmodel.named_parameters():
        _close_grad(p.grad, jg[name])


def test_epoch_state_draws_and_rebuilds_on_a_generator(kg_root):
    _, _, tmodel = _build(kg_root)
    aux = tmodel.epoch_state(torch.Generator().manual_seed(0), 0)
    dkg = aux["dkg"]
    assert dkg.h.n == 2 * N_ENTS * tmodel.rebuild_k and tmodel._last_dkg is dkg
    assert np.isfinite(tmodel.diff_loss)
    found = tmodel.lookup_rel(dkg.h.ids, dkg.t.ids)[1]
    assert bool((dkg.valid <= found.float()).all())
    batch = {k: _t(v) for k, v in _batch(tmodel, 1).items()}
    loss, _ = tmodel.loss({**batch, "aux": aux}, torch.Generator().manual_seed(1))
    assert np.isfinite(loss.item())


def test_cli_trains_diffkg_on_cpu(kg_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = tmain.main(["--model", "diffkg", "--data_dir", str(kg_root), "--dataset", "toy",
                          "--device", "cpu", "--epoch", "2", "--set", "train.save_model=false",
                          "--set", f"train.results_dir={tmp_path / 'res'}",
                          *[f"--set={k}={v}" for k, v in SMALL.items()]])
    doc = json.loads((tmp_path / "res" / "diffkg_toy.json").read_text())
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert set(r["loss"]) == {"bpr_loss", "reg_loss", "cl_loss", "loss"}
        assert all(np.isfinite(v) for v in r["loss"].values())
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


def test_step_on_cuda_matches_cpu(kg_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the B1/B2 kernels have no CPU mode")
    jmodel, params, cpu_model = _build(kg_root)
    _, _, cuda_model = _build(kg_root, device="cuda")
    idx = _batch(jmodel, 11)
    rng = np.random.default_rng(12)
    shape = (jmodel.context_hops, N_ENTS, jmodel.embedding_size)
    masks = {k: rng.random(shape) < 0.9 for k in ("mess_main", "mess_kg")}
    out = {}
    for model, dev in ((cpu_model, "cpu"), (cuda_model, "cuda")):
        _, td = _dkg(jmodel, model, 13)
        loss, _ = model.loss({**{k: _t(v, dev) for k, v in idx.items()}, "aux": {"dkg": td}},
                             None, draws={k: _t(v, dev) for k, v in masks.items()})
        loss.backward()
        out[dev] = (loss.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    _close(out["cuda"][0], out["cpu"][0].numpy())
    for k, g in out["cpu"][1].items():
        _close_grad(out["cuda"][1][k], g.numpy())
