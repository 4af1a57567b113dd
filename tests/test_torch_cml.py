"""CML of the port against the JAX package on the small Tmall-named split of
``test_torch_mb_data.py`` (300 users × 200 items, d 8, batch 64, 32 meta
users, SSL chunks of 2): weights carried across and ``generate()``; the
sampler's positives, negatives and validity, and each of the three rounds'
loss and every gradient, given the same draws; two whole three-round steps
against JAX's ``train_step`` in float64, parameters and both optimizer
states; the cyclic learning rates; a CPU CLI run; B1's calls a step and a
``generate()``, counted on the CPU.

Draws are injected into JAX by standing in for ``jax.random.randint`` /
``uniform`` / ``permutation`` / ``bernoulli`` and CML's
``sample_negatives`` while its jitted function is traced; the
``bernoulli`` stand-in takes a uniform ``U`` and returns ``U < p``, and the
port gets the masks ``U < 0.5`` by name, each of the meta net's six a
behavior under its own.

Tolerances: rtol 1e-5 on values, 1e-4 on gradients (atol 1e-6 times the
largest entry where that exceeds 1), as ``test_torch_mb_models.py``.  The
whole steps are held in float64 on both sides within 1e-10 (atol 1e-10
times a tensor's largest entry): the clone's fresh AdamW moves every entry
by about ``lr·sign(g)``, so float32 noise in a near-zero gradient entry
becomes a full ``2·lr`` difference there, in either package.
"""

import contextlib
import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu.models.multi_behavior import cml as jcml
from sslrec_tpu.models.registry import build_model as jbuild_model
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.models.multi_behavior import cml as tcml
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.utils import convert
from test_torch_mb_data import mb_split, write_mb_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-6
SMALL = {"model.hidden_dim": 8, "train.batch_size": 64, "train.meta_batch": 32,
         "train.SSL_batch": 2, "test.k": [3, 5], "test.batch_size": 64}
B, META_B, EPOCH = 64, 32, 3
META_FILE = "meta_multi_single_beh_user_index_shuffle"


def meta_users():
    """Users with a buy and another behavior, shuffled."""
    _, mats, _, _ = mb_split()
    buy = np.asarray(mats[3].sum(1)).reshape(-1) > 0
    other = np.asarray(sum(m for m in mats[:3]).sum(1)).reshape(-1) > 0
    return np.random.default_rng(5).permutation(np.nonzero(buy & other)[0]).astype(np.int32)


def _precision(f64):
    return jax.enable_x64(True) if f64 else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _jax_side(f64=False):
    behaviors, mats, _, tst = mb_split()
    jcfg = jload_config("cml", overrides=SMALL)
    jdata = jmb.bundle_from_behaviors(jcfg, behaviors, mats, tst, meta_users=meta_users())
    jmodel = jbuild_model(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    if f64:
        with _precision(True):
            params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
    return jmodel, params


def _build(f64=False, device="cpu"):
    behaviors, mats, _, tst = mb_split()
    jmodel, params = _jax_side(f64)
    tcfg = tload_config("cml", overrides=SMALL)
    tdata = tmb.bundle_from_behaviors(tcfg, behaviors, mats, tst, meta_users=meta_users(),
                                      device=device)
    tmodel = build_model(tcfg, tdata)
    tmodel.load_state_dict(convert.cml_params_from_jax(
        jax.tree.map(lambda p: np.asarray(p, np.float32), params)))
    if f64:
        tmodel.double()
        with torch.no_grad():   # the float64 values, not their float32 roundings
            for k, v in convert._tree("", {"gcn": params["gcn"], "meta_net": params["meta"]}
                                      ).items():
                tmodel.get_parameter(k).copy_(torch.from_numpy(np.asarray(v)))
    return jmodel, params, tmodel, tdata


_DRAWS: dict = {}


def _stand_in(monkeypatch):
    def pop(fn):
        return lambda *a, **k: _DRAWS[fn].pop(0)

    for fn in ("randint", "uniform", "permutation"):
        monkeypatch.setattr(jax.random, fn, pop(fn))
    monkeypatch.setattr(jcml, "sample_negatives", pop("sample_negatives"))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: _DRAWS["bernoulli"].pop(0) < p)


def step_draws(tmodel, seed):
    """One step's draws by the port's names (masks as uniforms), and the JAX
    stand-ins' lists in the order ``train_step`` takes them."""
    rng = np.random.default_rng(seed)
    n_items, h = tmodel.item_num, tmodel.hidden
    d = {}
    for prefix, n, beh in (("", B, range(3)), ("m", META_B, range(4))):
        for b in beh:
            d[f"{prefix}glob{b}"] = rng.integers(0, tmodel.sampler.items[b].shape[0], n)
            d[f"{prefix}off{b}"] = rng.random(n, dtype=np.float32)
        for b in range(4):
            d[f"{prefix}neg{b}"] = rng.integers(0, n_items, n)
        if prefix == "":
            d["meta_idx"] = rng.integers(0, tmodel.meta_users.shape[0], META_B)
    bern = []
    for r, n in ((1, B), (2, META_B), (3, B)):
        d[f"r{r}.perm"] = rng.permutation(n)
        s = max(n // 10, 1)
        for b in range(4):
            for k, shape in (("ssl_in", (s, 3 * h // 2)), ("ssl_out", (s,)), ("ssl3", (s, 1)),
                             ("rs_in", (n, 3 * h // 2)), ("rs_out", (n,)), ("rs3", (n, 1))):
                d[f"r{r}.{k}{b}"] = rng.random(shape, dtype=np.float32)
                bern.append(d[f"r{r}.{k}{b}"])
    i32 = lambda a: np.asarray(a, np.int32)     # noqa: E731
    jd = {"randint": [i32(d[f"glob{b}"]) for b in range(3)] + [i32(d["meta_idx"])]
          + [i32(d[f"mglob{b}"]) for b in range(4)],
          "uniform": [d[f"off{b}"] for b in range(3)] + [d[f"moff{b}"] for b in range(4)],
          "sample_negatives": [i32(d[f"neg{b}"]) for b in range(4)]
          + [i32(d[f"mneg{b}"]) for b in range(4)],
          "permutation": [i32(d[f"r{r}.perm"]) for r in (1, 2, 3)],
          "bernoulli": bern}
    td = {k: torch.from_numpy(v < 0.5) if "." in k and not k.endswith("perm")
          else torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    return td, jd


def _batch(tdata, seed):
    rng = np.random.default_rng(seed)
    return {"user": rng.integers(0, tdata.user_num, B).astype(np.int32),
            "pos": rng.integers(0, tdata.item_num, B).astype(np.int32)}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_grad(got, want):
    _close(got, want, GRAD_RTOL, ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _scaled(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def test_weights_carried_across_and_generate():
    jmodel, params, tmodel, _ = _build()
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jax.jit(jmodel.generate)(params)
    _close(tu, ju)
    _close(ti, ji)


@functools.lru_cache(maxsize=None)
def _jax_rounds():
    """The three rounds' losses and gradients of JAX's ``train_step`` at
    fixed parameters (round 2 on a given clone), with the sampler's
    outputs, jitted once, the draws an argument."""
    jmodel = _jax_side(False)[0]

    def f(params, clone_gcn, users, target, key, draws):
        _DRAWS.clear()
        _DRAWS.update({k: list(v) for k, v in draws.items()})
        pos_l, neg_l, val_l = jmodel._sample_behaviors(key, users, target)

        def loss(p, us, pl, nl, vl, stop_meta=False, half=False):
            ue, ie, ues, bl, il, su = jmodel._round_losses(p, key, us, pl, nl, vl, key)
            return jmodel._weighted_total(p, key, us, pl, nl, vl, bl, il, su, ues, ue, ie,
                                          stop_meta=stop_meta, half=half)[0]

        r1 = jax.value_and_grad(loss)(params, users, pos_l, neg_l, val_l)
        mu = jmodel.meta_users[jax.random.randint(key, (META_B,), 0, 1)]
        mpos, mneg, mval = jmodel._sample_behaviors(key, mu, None)
        r2 = jax.value_and_grad(lambda p: loss({"gcn": clone_gcn, "meta": p["meta"]}, mu, mpos,
                                               mneg, mval, half=True))(params)
        r3 = jax.value_and_grad(lambda p: loss(p, users, pos_l, neg_l, val_l,
                                               stop_meta=True))(params)
        return (pos_l, neg_l, val_l, mpos, mneg, mval), (r1, r2, r3)

    return jax.jit(f)


def test_sampler_and_each_rounds_loss_and_gradients(monkeypatch):
    jmodel, params, tmodel, tdata = _build()
    idx = _batch(tdata, 3)
    td, jd = step_draws(tmodel, 4)
    clone = jax.tree.map(lambda p: p * 0.9, params["gcn"])
    _stand_in(monkeypatch)
    samples, rounds = _jax_rounds()(params, clone, jnp.asarray(idx["user"]),
                                    jnp.asarray(idx["pos"]), jax.random.PRNGKey(5), jd)
    dr = StepDraws(None, td, "cpu")
    users = torch.from_numpy(idx["user"]).long()
    got = tmodel.sampler.sample(dr, "", users, torch.from_numpy(idx["pos"]).long())
    mu = tmodel.meta_users[dr.randint("meta_idx", 0, 1, (META_B,)).long()]
    got += tmodel.sampler.sample(dr, "m", mu, None)
    for g_list, w_list in zip(got, samples):
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos_l, neg_l, val_l, mpos, mneg, mval = got
    clone_t = {k: torch.from_numpy(np.array(v)) for k, v in convert._tree("", clone).items()}
    meta_const = {k: v.detach() for k, v in tmodel.meta_net.named_parameters()}
    cases = (lambda: tmodel._total(dr, "r1", tmodel.gcn(), users, pos_l, neg_l, val_l)[0],
             lambda: 0.5 * tmodel._total(dr, "r2", torch.func.functional_call(
                 tmodel.gcn, clone_t, ()), mu, mpos, mneg, mval)[0],
             lambda: tmodel._total(dr, "r3", tmodel.gcn(), users, pos_l, neg_l, val_l,
                                   meta=meta_const)[0])
    for r, (case, (jloss, jg)) in enumerate(zip(cases, rounds), 1):
        tmodel.zero_grad(set_to_none=True)
        loss = case()
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL, err_msg=f"round {r}")
        want = convert.cml_params_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), jg))
        moved = 0
        for k, p in tmodel.named_parameters():
            if p.grad is None:
                assert not want[k].numpy().any(), (r, k)
                continue
            _close_grad(p.grad, want[k].numpy())
            moved += bool(p.grad.abs().sum() > 0)
        assert moved >= (2 if r == 2 else 6), r


@functools.lru_cache(maxsize=None)
def _jax_step():
    jmodel = _jax_side(True)[0]

    def f(params, opt_state, batch, key, draws):
        _DRAWS.clear()
        _DRAWS.update({k: list(v) for k, v in draws.items()})
        return jmodel.train_step(params, opt_state, batch, key)

    return jax.jit(f)


def _adam_moments(state):
    return optax.tree_utils.tree_get(state, "mu"), optax.tree_utils.tree_get(state, "nu")


def test_two_whole_steps_match_jax_in_float64(monkeypatch):
    jmodel, params, tmodel, tdata = _build(f64=True)
    _stand_in(monkeypatch)
    with _precision(True):
        state = jmodel.init_opt_state(params)
        # the learning rates as the steps set them (float32), so one trace serves both
        state = {k: jcml._set_chain_lr(v, jnp.float32(1e-3)) for k, v in state.items()}
    for step in range(2):
        idx = _batch(tdata, 10 + step)
        td, jd = step_draws(tmodel, 20 + step)
        with _precision(True):
            params, state, jaux = _jax_step()(
                params, state, {**{k: jnp.asarray(v) for k, v in idx.items()},
                                "aux": {"epoch": jnp.asarray(EPOCH, jnp.float32)}},
                jax.random.PRNGKey(step), jd)
        taux = tmodel.train_step({**{k: torch.from_numpy(v) for k, v in idx.items()},
                                  "aux": {"epoch": EPOCH}}, None, draws=td)
        for k in ("loss", "bpr_loss", "infonce_loss"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-10)
    names = dict(tmodel.named_parameters())
    flat = lambda tree: convert._tree("", {"gcn": tree["gcn"], "meta_net": tree["meta"]})  # noqa
    for k, v in flat(params).items():
        _scaled(names[k], v, 1e-10)
    for opt_name, opt in tmodel.optimizers().items():
        mu, nu = _adam_moments(state[opt_name])
        for k, m, n in zip(flat(mu), flat(mu).values(), flat(nu).values()):
            st = opt.state[names[k]]
            _scaled(st["exp_avg"], m, 1e-10)
            _scaled(st["exp_avg_sq"], n, 1e-10)
        assert all(int(opt.state[p]["step"]) == (4 if opt_name == "meta" else 2)
                   for p in names.values())


@pytest.mark.parametrize("up,down,base,mx", [(5, 10, 1e-3, 3e-3), (2, 3, 1e-4, 1e-3)])
def test_cyclic_lr_matches_jax(up, down, base, mx):
    """As ``train_step`` computes it, jitted (XLA fuses the product and the
    sum, one float32 rounding)."""
    lr = jax.jit(lambda e: jcml._cyclic_lr(e, base, mx, up=up, down=down))
    for epoch in range(16):
        want = float(lr(jnp.asarray(epoch, jnp.float32)))
        assert tcml.cyclic_lr(epoch, base, mx, up=up, down=down) == want, epoch


def write_cml_dir(root):
    d = write_mb_dir(root)
    with open(os.path.join(d, META_FILE), "wb") as f:
        pickle.dump(meta_users().tolist(), f)
    return d


class _Count:
    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **k):
        self.n += 1
        return self.fn(*a, **k)


def test_b1_calls_a_step_and_a_generate(monkeypatch):
    """120 a step (rounds 1 and 3: 24 hops and 24 dx each; round 2: 24 hops
    through the clone, no dx), 24 a ``generate()``: the counts the card's
    run is held to."""
    _, _, tmodel, tdata = _build()
    counter = _Count(sk.csr_spmm)
    monkeypatch.setattr(sk, "csr_spmm", counter)
    idx = _batch(tdata, 3)
    td, _ = step_draws(tmodel, 4)
    tmodel.train_step({**{k: torch.from_numpy(v) for k, v in idx.items()},
                       "aux": {"epoch": 0}}, None, draws=td)
    assert counter.n == 120
    with torch.no_grad():
        tmodel.generate()
    assert counter.n == 144


def test_cli_trains_on_cpu(tmp_path, monkeypatch):
    write_cml_dir(tmp_path)
    monkeypatch.chdir(tmp_path)
    trainer = tmain.main(["--model", "cml", "--data_dir", str(tmp_path), "--dataset", "tmall",
                          "--device", "cpu", "--epoch", "2", "--set", "train.save_model=false",
                          "--set", f"train.results_dir={tmp_path / 'res'}",
                          *[f"--set={k}={v}" for k, v in SMALL.items()],
                          "--set", "train.batch_size=512"])
    doc = json.loads((tmp_path / "res" / "cml_tmall.json").read_text())
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
    assert trainer.optimizer is None and set(trainer.optimizers()) == {"model", "meta"}
    assert torch.equal(trainer.model.meta_users.cpu(), torch.from_numpy(meta_users()).long())
