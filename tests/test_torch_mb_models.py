"""MBGMN, HMGCR and SMBRec of the port against the JAX package on the small
Tmall-named split of ``test_torch_mb_data.py`` (300 users × 200 items, d 8):
weights carried across, ``generate()``, the loss and every gradient given the
same draws (MBGMN's users, positives' offsets, negatives and fallbacks, with
the hinge detached as shipped and not; SMBRec's co-user offsets), three Adam
steps, MBGMN's epoch schedule, a CPU CLI run of each, one step on the card
against the CPU, and HMGCR's ``grace_loss`` against the checkpointed form it
had before it ran under vmap (float64, 1e-12).

Draws are injected into JAX by standing in for ``jax.random.randint`` /
``uniform`` and MBGMN's ``sample_negatives`` with the same numpy arrays, in
the order the JAX loss takes them, while its jitted loss is traced.

Tolerances: rtol 1e-5 on values, 1e-4 on gradients (atol 1e-6 times the
largest entry where that exceeds 1); rtol 1e-4 after three Adam steps.
SMBRec is held in float64 on both sides (JAX under ``jax.enable_x64``, the
port's model in double): its contrast sums some 10^7 similarity terms of
either sign into a total thousands of times smaller than their magnitudes,
so float32 rounding moves its loss by ~5e-4 and the user-side weights'
gradients by ~3e-3 of their largest entry in either package (JAX's own
float32 loss is 5e-4 from its float64 one on this split), while in float64
the two agree to 1e-12.
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu.models.multi_behavior import mbgmn as jmbgmn
from sslrec_tpu.models.registry import build_model as jbuild_model
from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils import convert
from test_torch_mb_data import mb_split, write_mb_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-6
SMALL = {"model.embedding_size": 8, "model.hidden_dim": 8, "model.sampNum": 8,
         "train.batch_size": 32, "test.k": [3, 5], "test.batch_size": 64}
MODELS = ("mbgmn", "hmgcr", "smbrec")
CONVERT = {m: getattr(convert, f"{m}_params_from_jax") for m in MODELS}
BLOCK = 128


F64 = {"smbrec"}      # held in float64 on both sides (the module's docstring)
F64_ADAM = {"smbrec", "hmgcr"}


def _precision(f64: bool):
    return jax.enable_x64(True) if f64 else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _jax_side(name, over=(), f64=False):
    """The JAX model, its ``init_params`` and config, built once a module."""
    behaviors, mats, metas, tst = mb_split()
    jcfg = jload_config(name, overrides={**SMALL, **dict(over)})
    jdata = jmb.bundle_from_behaviors(jcfg, behaviors, mats, tst,
                                      meta_mats=metas if name == "hmgcr" else None)
    jmodel = jbuild_model(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    if f64:
        with _precision(True):
            params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
    return jmodel, params, jcfg


def _build(name, device="cpu", f64=False, **over):
    behaviors, mats, metas, tst = mb_split()
    jmodel, params, jcfg = _jax_side(name, tuple(sorted(over.items())), f64)
    tcfg = tload_config(name, overrides={**SMALL, **over})
    tdata = tmb.bundle_from_behaviors(tcfg, behaviors, mats, tst,
                                      meta_mats=metas if name == "hmgcr" else None, device=device)
    tmodel = build_model(tcfg, tdata)
    tmodel.load_state_dict(CONVERT[name](jax.tree.map(lambda p: np.asarray(p, np.float32),
                                                      params)))
    if f64:
        tmodel.double()
    return jmodel, params, tmodel, tdata, jcfg, tcfg


_DRAWS: dict = {}      # the stand-in draws of the JAX loss being traced, by function


@functools.lru_cache(maxsize=None)
def _jax_loss(name, over=(), f64=False):
    """``value_and_grad`` of the JAX loss, jitted once a module, the draws an
    argument: while it is traced, ``jax.random.randint`` / ``uniform`` and
    MBGMN's ``sample_negatives`` (stood in for by :func:`_stand_in`) take
    them in call order.  SMBRec's ``lax.map`` body is traced once: one
    block's offsets serve every block."""
    jmodel = _jax_side(name, over, f64)[0]

    def f(params, batch, key, draws):
        _DRAWS.clear()
        _DRAWS.update({k: list(v) for k, v in draws.items()})
        return jax.value_and_grad(jmodel.loss, has_aux=True)(params, batch, key)

    return jax.jit(f)


def _stand_in(monkeypatch):
    for where, fn in ((jax.random, "randint"), (jax.random, "uniform"),
                      (jmbgmn, "sample_negatives")):
        monkeypatch.setattr(where, fn, lambda *a, _fn=fn, **k: _DRAWS[_fn].pop(0))


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a).copy()).to(device)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_grad(got, want):
    _close(got, want, GRAD_RTOL, ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _batch(n_users, n_items, seed, b=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, hi, b).astype(np.int32) for k, hi in
            (("user", n_users), ("pos", n_items), ("neg", n_items))}


def mbgmn_draws(jmodel, b, seed):
    """MBGMN's draws by the port's names: users, each behavior's uniforms
    for the positives' offsets, negatives and fallbacks."""
    rng = np.random.default_rng(seed)
    s, n_items = jmodel.samp_num, jmodel.item_num
    d = {"users": rng.integers(0, jmodel.user_num, b)}
    for beh in range(jmodel.n_beh):
        d[f"pos_u{beh}"] = rng.random((b, s)).astype(np.float32)
        d[f"neg{beh}"] = rng.integers(0, n_items, (b, s))
        d[f"fallback{beh}"] = rng.integers(0, n_items, (b, 1))
    return d


def smbrec_draws(jmodel, seed):
    """Per behavior one block's co-user offsets [128, S], the same in every
    block of the padded users."""
    rng = np.random.default_rng(seed)
    n_blocks = -(-jmodel.user_num // BLOCK)
    return {f"co_u{b}": np.tile(rng.random((BLOCK, jmodel.samp_pos)), (n_blocks, 1))
            for b in range(jmodel.n_beh)}


def _draws(name, jmodel, seed, b=32):
    """The port's draws by name, and the JAX loss's in the order it takes them."""
    n = getattr(jmodel, "n_beh", 0)
    if name == "mbgmn":
        d = mbgmn_draws(jmodel, b, seed)
        return d, {"randint": [d["users"], *[d[f"fallback{k}"] for k in range(n)]],
                   "uniform": [d[f"pos_u{k}"] for k in range(n)],
                   "sample_negatives": [d[f"neg{k}"].reshape(-1) for k in range(n)]}
    if name == "smbrec":
        d = smbrec_draws(jmodel, seed)
        return d, {"uniform": [d[f"co_u{k}"][:BLOCK] for k in range(n)]}
    return None, {}


def _loss(name, tmodel, tbatch, draws):
    if name == "hmgcr":
        return tmodel.loss(tbatch)
    dtype = next(tmodel.parameters()).dtype
    return tmodel.loss(tbatch, None, draws={k: _t(v).to(dtype) if v.dtype.kind == "f"
                                            else _t(v) for k, v in draws.items()})


@pytest.mark.parametrize("name", MODELS)
def test_weights_carried_across_and_generate(name):
    jmodel, params, tmodel, *_ = _build(name)
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jax.jit(jmodel.generate)(params)
    _close(tu, ju)
    _close(ti, ji)


@pytest.mark.parametrize("name,over", [
    ("mbgmn", {}), ("mbgmn", {"model.detach_pre_loss": False}), ("hmgcr", {}), ("smbrec", {})])
def test_loss_and_every_gradient(name, over, monkeypatch):
    f64 = name in F64
    jmodel, params, tmodel, tdata, *_ = _build(name, f64=f64, **over)
    idx = _batch(tdata.user_num, tdata.item_num, 3)
    draws, jdraws = _draws(name, jmodel, 4)
    _stand_in(monkeypatch)
    with _precision(f64):
        (jloss, jaux), jg = _jax_loss(name, tuple(sorted(over.items())), f64)(
            params, {k: jnp.asarray(v) for k, v in idx.items()}, jax.random.PRNGKey(5), jdraws)
        jg = jax.tree.map(lambda g: np.asarray(g, np.float32), jg)
    tloss, taux = _loss(name, tmodel, {k: _t(v) for k, v in idx.items()}, draws)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), rtol=RTOL)
    want = CONVERT[name](jg)
    grads = 0
    for k, p in tmodel.named_parameters():
        if p.grad is None:      # unreached by the loss: JAX's gradient is zero there
            assert not want[k].numpy().any(), k
            continue
        _close_grad(p.grad.float(), want[k].numpy())
        grads += bool(p.grad.abs().sum() > 0)
    assert grads >= 2


@pytest.mark.parametrize("name", MODELS)
def test_three_adam_steps_match_optax(name, monkeypatch):
    """Three steps on three batches and draws; HMGCR too in float64 (its lr 1e-2 Adam moves a weight by
    about lr whatever its gradient's size, so an entry of a weight's
    gradient summed over every user to near zero is float32 noise)."""
    f64 = name in F64_ADAM
    jmodel, params, tmodel, tdata, jcfg, tcfg = _build(name, f64=f64)
    opt = jbuild_optimizer(jcfg)
    trainer = Trainer(tcfg, tmodel, tdata)
    _stand_in(monkeypatch)
    with _precision(f64):
        state = opt.init(params)
    for step in range(3):
        idx = _batch(tdata.user_num, tdata.item_num, 10 + step)
        draws, jdraws = _draws(name, jmodel, 20 + step)
        with _precision(f64):
            (jloss, _), g = _jax_loss(name, (), f64)(
                params, {k: jnp.asarray(v) for k, v in idx.items()}, jax.random.PRNGKey(step),
                jdraws)
            updates, state = opt.update(g, state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
        trainer.optimizer.zero_grad(set_to_none=True)
        loss, _ = _loss(name, tmodel, {k: _t(v) for k, v in idx.items()}, draws)
        loss.backward()
        trainer.optimizer.step()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = CONVERT[name](jax.tree.map(lambda p: np.asarray(p, np.float32), params))
    for k, p in tmodel.named_parameters():
        _close(p.float(), want[k].numpy(), rtol=1e-4, atol=1e-6)


def test_mbgmn_epoch_schedule_and_sampler():
    jmodel, _, tmodel, tdata, _, tcfg = _build("mbgmn")
    assert tmodel.epoch_schedule(tdata.n_train, 256) == jmodel.epoch_schedule(0, 256) == (1, 100)
    assert tmodel.epoch_schedule(0, 32) == jmodel.epoch_schedule(0, 32) == (4, 25)
    trainer = Trainer(tcfg, tmodel, tdata)
    assert (trainer.n_batches, trainer.batch_size) == (4, 25)        # trnNum 100, batch 32
    idx, sampled, _ = trainer.epoch_draws(0)
    assert idx.shape == (4, 25) and "neg" not in sampled
    gen = torch.Generator().manual_seed(0)
    uids, iids = tmodel.sample(tmodel_draws(gen), 50)
    for beh, (u, i) in enumerate(zip(uids, iids)):
        pos_u, pos_i = u[: u.shape[0] // 2], i[: i.shape[0] // 2]
        deg = tmodel._beh_csr[beh][0][pos_u + 1] - tmodel._beh_csr[beh][0][pos_u]
        has = tdata.extras["behavior_mats_scipy"][beh].tocsr()[np.array(pos_u), np.array(pos_i)]
        assert np.asarray(has).reshape(-1)[deg.numpy() > 0].all()


def tmodel_draws(gen):
    from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
    return StepDraws(gen)


def test_smbrec_co_users_fall_back_to_the_anchor():
    _, _, tmodel, *_ = _build("smbrec")
    anchors = torch.arange(tmodel.user_num)
    u = torch.rand(tmodel.user_num, tmodel.samp_pos, generator=torch.Generator().manual_seed(1))
    got = tmodel.sample_co_users(u, anchors)
    deg = tmodel.co_indptr[1:] - tmodel.co_indptr[:-1]
    assert (got[deg == 0] == anchors[deg == 0, None]).all()
    for a in torch.nonzero(deg > 0)[:20, 0].tolist():
        row = set(tmodel.co_indices[tmodel.co_indptr[a]:tmodel.co_indptr[a + 1]].tolist())
        assert set(got[a].tolist()) <= row and a not in row


@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_on_cpu(name, tmp_path, monkeypatch):
    write_mb_dir(tmp_path)
    monkeypatch.chdir(tmp_path)
    trainer = tmain.main(["--model", name, "--data_dir", str(tmp_path), "--dataset", "tmall",
                          "--device", "cpu", "--epoch", "2", "--set", "train.save_model=false",
                          "--set", f"train.results_dir={tmp_path / 'res'}",
                          *[f"--set={k}={v}" for k, v in SMALL.items()],
                          "--set", "train.batch_size=512"])
    doc = json.loads((tmp_path / "res" / f"{name}_tmall.json").read_text())
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert all(np.isfinite(v) for v in r["loss"].values())
    assert len(doc["test"]["recall"]) == 2
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())


@pytest.mark.parametrize("name", MODELS)
def test_step_on_cuda_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the B1 kernel has no CPU mode")
    jmodel, _, cpu_model, tdata, *_ = _build(name)
    _, _, cuda_model, *_ = _build(name, device="cuda")
    if name == "smbrec":    # its dense contrast is held in float64 above, not here
        cpu_model.cl_weight = cuda_model.cl_weight = 0.0
    idx = _batch(tdata.user_num, tdata.item_num, 7)
    draws = _draws(name, jmodel, 8)[0]
    out = {}
    for model, dev in ((cpu_model, "cpu"), (cuda_model, "cuda")):
        batch = {k: _t(v, dev) for k, v in idx.items()}
        if name == "hmgcr":
            loss, _ = model.loss(batch)
        else:
            loss, _ = model.loss(batch, None, draws={k: _t(v, dev) for k, v in draws.items()})
        loss.backward()
        out[dev] = (loss.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()
                                          if p.grad is not None})
    _close(out["cuda"][0], out["cpu"][0].numpy())
    for k, g in out["cpu"][1].items():
        _close_grad(out["cuda"][1][k], g.numpy())


def _grace_loss_checkpointed(z1, z2, tau, chunk):
    """HMGCR's GRACE semi-loss in its earlier form: the row sums of ``z1``'s
    rows ``chunk`` at a time under ``torch.utils.checkpoint``."""
    import torch.utils.checkpoint
    from sslrec_tpu_torch.models.losses import _grace_row_sums, _l2norm_safe
    n = z1.shape[0]
    z1n, z2n = _l2norm_safe(z1), _l2norm_safe(z2)
    z_all = torch.cat([z1n, z2n])
    sums = torch.cat([torch.utils.checkpoint.checkpoint(
        _grace_row_sums, z1n[s:s + chunk], z_all, tau, 2, use_reentrant=False)
        for s in range(0, n, chunk)])
    denom = sums[:, 0] + sums[:, 1] - torch.exp((z1n * z1n).sum(-1) / tau)
    diag = (z1n * z2n).sum(-1)
    return -torch.log(torch.exp(diag / tau) / denom + 1e-8).sum() / n


@pytest.mark.parametrize("n,chunk", [(300, 1024), (300, 100), (300, 64)])
def test_grace_loss_equals_its_checkpointed_form(n, chunk):
    """``losses.grace_loss`` on ``GraceRowSumsFn`` (which runs under vmap)
    against the checkpointed form it replaced, float64: value and both
    views' gradients within 1e-12; under ``torch.func.vmap`` over 3 lanes,
    each lane the same."""
    from sslrec_tpu_torch.models import losses
    rng = np.random.default_rng(n + chunk)
    z1, z2 = (torch.from_numpy(rng.standard_normal((3, n, 8))).requires_grad_()
              for _ in range(2))
    z1.data[0, :5] = 0.0                    # zero rows (a post-sigmoid view has none; relu's may)
    got = torch.func.vmap(lambda a, b: losses.grace_loss(a, b, 0.4, chunk))(z1, z2)
    g1, g2 = torch.autograd.grad(got.sum(), (z1, z2))
    for i in range(3):
        a, b = z1[i].detach().requires_grad_(), z2[i].detach().requires_grad_()
        want = _grace_loss_checkpointed(a, b, 0.4, chunk)
        w1, w2 = torch.autograd.grad(want, (a, b))
        one = losses.grace_loss(a, b, 0.4, chunk)
        o1, o2 = torch.autograd.grad(one, (a, b))
        for g, w in ((got[i], want), (one, want), (g1[i], w1), (g2[i], w2), (o1, w1), (o2, w2)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
