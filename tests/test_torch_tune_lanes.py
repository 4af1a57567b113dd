"""The ``tune.parallel`` lanes (``trainer/lanes.py``) below the tuner: B1's
Functions under ``torch.func.vmap``, one lanes step of each of the seventeen
lanes models against its single-model steps, and the lanes steps of
LightGCN, SMBRec and DuoRec against ``jax.vmap`` of the JAX model's loss.

Vmap rules: K = 3 lanes in float64 (the plain versions compute in the
inputs' dtype) against K separate calls, values and gradients within 1e-12;
where only the dense operand has lanes the Function runs once for all of
them (B1's calls counted), where the weight has lanes once a lane.

Models: K = 3 lanes of distinct scalars, one step (loss, every parameter's
gradient and the parameters after Adam) against each lane's trial run alone
from the same parameters, batch and draws, through the check that
``chip_smoke.py`` runs on the card (``lanes_step_check``), in float32 (a
parameter the loss leaves out, as MBGMN's detached hinge does, keeps no
gradient in either): loss and gradients
within 1e-5 of the tensor's largest entry plus 1e-7 (the lanes' scalars are float32
tensors where a single run multiplies by a Python float, and a division by
a tensor is not the multiplication by a reciprocal that a scalar divisor
gets).  The parameters after the lanes' Adam step equal, bit for bit, Adam
applied to each lane alone with that lane's gradient; against the single
run they agree within 1e-6 wherever the single run's gradient is at least
1e-4 of its tensor's largest entry.  Elsewhere Adam's first step,
``lr · g / (|g| + 1e-8)``, turns the float rounding of a gradient near 1e-8
into a step of up to ``lr`` (SMIN's attention weights have such entries).
SMBRec and DCRec_seq run in float64 (``F64``) and are held at 1e-10 of the
largest entry plus 1e-15 (``F64_TOL``), where rounding is ~1e-13.

The port's ``hparams()`` models are the JAX package's, less the three that
JAX keeps serial (AutoCF, GFormer, DiffKG); each returns the JAX keys in
JAX's order (one case a model, read from the JAX source).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_ui_matrix
from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.models.general_cf.lightgcn import LightGCN as JLightGCN
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.data import sequential as tseq
from sslrec_tpu_torch.data import social as tsocial
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models.registry import available_models, build_model, model_class
from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.sparse import from_scipy
from sslrec_tpu_torch.trainer import lanes as tlanes
from sslrec_tpu_torch.trainer.lanes import Lanes
from sslrec_tpu_torch.trainer.trainer import build_optimizer, clip_grad_global_norm
from sslrec_tpu_torch.utils.convert import lightgcn_params_from_jax
from test_torch_lightgcn import _batch, _keys, _mats, prf_edge_drop  # noqa: F401 (fixture)
from test_torch_mb_data import mb_split
from test_torch_seq_data import synthetic_seqs
from test_torch_social_data import social_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

K = 3


@pytest.fixture
def b1_calls(monkeypatch):
    """B1's calls (``csr_spmm``, as the Functions reach it) while the test runs."""
    calls = []

    def counted(fn):
        def call(*a, **k):
            calls.append(a[1].shape)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(sk, "csr_spmm", counted(sk.csr_spmm))
    monkeypatch.setattr(skn, "csr_spmm", counted(skn.csr_spmm))
    return calls


def _graph():
    a = random_ui_matrix(n_users=30, n_items=25, density=0.15, seed=4)
    return sk.build_csr_graph(from_scipy(a))


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


def _lanes_vs_loop(fn, xs, extra=(), dims=0):
    """``torch.func.vmap(fn)`` over ``xs`` (lanes at ``dims``) against K calls;
    values and the gradients of a random cotangent."""
    leaves = [x.requires_grad_() for x in (*xs, *extra)]
    out = torch.func.vmap(fn, in_dims=dims)(*xs)
    ct = _rand(*out.shape, seed=9)
    grads = torch.autograd.grad((out * ct).sum(), leaves)
    lane_args = [[x.select(d, i) if d is not None else x
                  for x, d in zip(xs, dims if isinstance(dims, tuple) else (dims,) * len(xs))]
                 for i in range(K)]
    want = torch.stack([fn(*a) for a in lane_args])
    wgrads = torch.autograd.grad((want * ct).sum(), leaves)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12)
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("weight", ["none", "tensor", "prf", "edge_mask"])
def test_spmm_lanes_fold_into_one_call(weight, b1_calls):
    g = _graph()
    ew = {"none": None, "tensor": torch.rand(g.nnz, dtype=torch.float64),
          "prf": sk.prf_mask(torch.tensor([7, 11]), g, 0.6, resize_val=True),
          "edge_mask": sk.EdgeMask(torch.rand(g.nnz, dtype=torch.float64))}[weight]
    x = _rand(K, g.n_rows, 5)
    _lanes_vs_loop(lambda x: spmm(g, spmm(g.t(), x, ew), ew), [x])
    # two hops: vmapped forward and backward, then K lanes' forward and backward
    assert len(b1_calls) == 4 + 4 * K
    assert all(s[1] == K * 5 for s in b1_calls[:4])


def test_spmm_learned_weight_with_lanes_takes_a_call_a_lane(b1_calls):
    g = _graph()
    x, ew = _rand(K, g.n_cols, 4), torch.rand(K, g.nnz, dtype=torch.float64)
    _lanes_vs_loop(lambda x, w: spmm(g, x, w), [x, ew])
    assert len(b1_calls) == 4 * K       # lanes: K forward + K backward; loop the same
    # the dense operand without lanes (DCCF's degree sum over ones)
    b1_calls.clear()
    ones = torch.ones(g.n_cols, 1, dtype=torch.float64)
    _lanes_vs_loop(lambda w: spmm(g, ones, w), [ew])
    assert len(b1_calls) == 2 * K


@pytest.mark.parametrize("op", ["sum_1d", "sum_2d", "take", "softmax"])
def test_segment_ops_under_lanes(op, b1_calls):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 9, 40)
    ids[:5] = 2                              # one longer segment
    ops = skn.SegmentOps(ids, 10)           # segment 9 is empty
    fn, x = {"sum_1d": (ops.sum, _rand(K, 40)), "sum_2d": (ops.sum, _rand(K, 40, 6)),
             "take": (ops.take, _rand(K, 10, 6)), "softmax": (ops.softmax, _rand(K, 40))}[op]
    _lanes_vs_loop(fn, [x])
    if op == "softmax":     # B2 reduces one column: a call a lane
        assert len(b1_calls) == 2 * (2 * K)
    else:                   # forward (sum) or backward (take): one B1 call for K lanes
        assert len(b1_calls) == 1 + K and b1_calls[0][1] == K * x[0].reshape(x.shape[1], -1).shape[1]


def test_layouts_keep_their_plan_cache_under_vmap(monkeypatch):
    """vmap rebuilds a Function's operand containers: the layout B1 gets must
    still hold the graph's own split-plan cache (else every call under vmap
    builds its plan anew)."""
    g = _graph()
    seen = []
    real = sk.csr_spmm

    def spy(lay, x, w=None):
        seen.append(lay.plans)
        return real(lay, x, w)

    monkeypatch.setattr(sk, "csr_spmm", spy)
    monkeypatch.setattr(skn, "csr_spmm", spy)
    x = _rand(K, g.n_rows, 4).requires_grad_()
    torch.func.vmap(lambda x: spmm(g.t(), x))(x).sum().backward()
    assert [id(p) for p in seen] == [id(g.bwd.plans), id(g.fwd.plans)]
    ops = skn.SegmentOps(np.arange(6) % 3, 3)
    seen.clear()
    torch.func.vmap(ops.sum)(_rand(K, 6, 2))
    assert seen[0] is ops.layout.csr.plans


def test_lanes_at_dimension_one_stay_folded(b1_calls):
    """Chained hops: a hop's output keeps the lanes next to its features, so
    the next hop's fold is a view of it (no copy: same storage)."""
    sq = sk.build_csr_graph(from_scipy(random_ui_matrix(30, 30, 0.2, seed=5)))
    x = _rand(K, 30, 4)
    torch.func.vmap(lambda x: spmm(sq, spmm(sq, x)))(x)
    assert b1_calls == [(30, K * 4)] * 2
    seen = []
    real = sk.csr_spmm

    def spy(lay, x, w=None):
        out = real(lay, x, w)
        seen.append((x, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sk, "csr_spmm", spy)
        torch.func.vmap(lambda x: spmm(sq, spmm(sq, x)))(x)
    # the second hop reads the first hop's output where it lies
    assert seen[1][0].data_ptr() == seen[0][1].data_ptr()


# -- one lanes step of each model against its single runs --------------------

# the multi-behavior and sequential test files' small shapes
MB_SMALL = {"model.hidden_dim": 8, "model.sampNum": 8}
SEQ_SMALL = {"model.max_seq_len": 10, "model.n_layers": 1, "model.n_heads": 2,
             "train.batch_size": 16}
# model: (config overrides, each lane's scalars)
MODELS = {
    "lightgcn": ({}, {"reg_weight": [1e-3, 1e-1, 1.0]}),
    "sgl": ({}, {"reg_weight": [1e-3, 1e-2, 1e-1], "cl_weight": [0.1, 0.5, 1.0],
                 "temperature": [0.2, 0.5, 1.0]}),
    "simgcl": ({}, {"cl_weight": [0.1, 0.5, 1.0], "eps": [0.1, 0.5, 0.9]}),
    "directau": ({}, {"gamma": [0.5, 1.0, 2.0]}),
    "dccf": ({"model.intent_num": 4}, {"reg_weight": [1e-3, 1e-2, 1e-1],
                                       "cl_weight": [0.1, 0.5, 1.0],
                                       "temperature": [0.2, 0.5, 1.0]}),
    "hccf": ({"model.hyper_num": 8}, {"cl_weight": [0.1, 0.5, 1.0],
                                      "temperature": [0.2, 0.5, 1.0]}),
    "ncl": ({"model.cluster_num": 4}, {"temperature": [0.1, 0.5, 1.0],
                                       "proto_weight": [1e-3, 1e-1, 1.0],
                                       "struct_weight": [1e-3, 1e-1, 1.0]}),
    "mhcn": ({}, {"reg_weight": [1e-3, 1e-2, 1e-1], "ss_rate": [0.01, 0.1, 1.0]}),
    "dcrec": ({}, {"reg_weight": [1e-3, 1e-2, 1e-1], "cross_weight": [0.1, 0.5, 1.0],
                   "domain_weight": [0.1, 0.5, 1.0]}),
    "kcgn": ({}, {"reg_weight": [1e-3, 1e-2, 1e-1]}),
    "smin": ({}, {"reg_weight": [1e-3, 1e-2, 1e-1], "lambda1": [0.1, 0.5, 1.0],
                  "lambda2": [0.1, 0.5, 1.0]}),
    # MBGMN's and HMGCR's reg_weight is inert (their docstrings): the lanes'
    # losses are equal, each lane still its own trial's
    "mbgmn": (MB_SMALL, {"reg_weight": [1e-3, 1e-2, 1e-1]}),
    "hmgcr": (MB_SMALL, {"reg_weight": [1e-3, 1e-2, 1e-1]}),
    "smbrec": (MB_SMALL, {"reg_weight": [1e-3, 1e-2, 1e-1], "cl_weight": [1e-3, 1e-2, 1e-1]}),
    "cl4srec": (SEQ_SMALL, {"lmd": [0.05, 0.1, 0.5], "tau": [0.5, 1.0, 2.0]}),
    "duorec": (SEQ_SMALL, {"lmd_sem": [0.05, 0.1, 0.5], "tau": [0.5, 1.0, 2.0]}),
    "dcrec_seq": ({**SEQ_SMALL, "model.sim_group_k": 2},
                  {"cl_lambda": [1e-3, 1e-1, 1.0], "weight_mean": [0.3, 0.5, 0.7]}),
}
SOCIAL = ("mhcn", "dcrec", "kcgn", "smin")
# held in float64: SMBRec's contrast sums terms of either sign into a total
# far smaller than they are (float32 moves its gradients by ~3e-3 of their
# largest entry, test_torch_mb_models.py), and DCRec_seq's attention key
# biases take a gradient that is rounding alone (softmax ignores a shift of
# every key), which Adam's first step turns into a step of up to lr
F64 = ("smbrec", "dcrec_seq")
F64_TOL = (1e-10, 1e-15)        # rel of the largest entry, atol
MULTI_BEHAVIOR = ("mbgmn", "hmgcr", "smbrec")
SEQUENTIAL = ("cl4srec", "duorec", "dcrec_seq")


def _data(name, cfg):
    if name in SOCIAL:
        return tsocial.bundle_from_matrices(cfg, *social_split())
    if name in MULTI_BEHAVIOR:
        behaviors, mats, metas, tst = mb_split()
        return tmb.bundle_from_behaviors(cfg, behaviors, mats, tst,
                                         meta_mats=metas if name == "hmgcr" else None)
    if name in SEQUENTIAL:
        return tseq.bundle_from_seqs(cfg, *synthetic_seqs())
    return tbundle(*_mats())


def _close(got, want, what, rel=1e-5, atol=1e-7):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + atol, f"{what}: {err} > {rel} x {scale} + {atol}"


def _chip_smoke():
    """The repo's ``chip_smoke.py`` (its root is not a package)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("name", list(MODELS))
def test_lanes_step_equals_single_steps(name):
    """Through ``chip_smoke.lanes_step_check``, the check phase 36 runs on the
    card (``sure_abs`` 0: every entry at least 1e-4 of its tensor's largest
    gradient is held after Adam)."""
    over, lanes_hp = MODELS[name]
    cfg = load_config(name, overrides={"model.embedding_size": 8, "train.batch_size": 32,
                                       "optimizer.lr": 1e-2, **over})
    data = _data(name, cfg)
    dtype = torch.float64 if name in F64 else torch.float32
    lanes = Lanes(cfg, build_model(cfg, data).to(dtype), data)
    assert list(lanes.probe.hparams()) == list(JAX_HPARAM_KEYS[name])
    hp = {k: torch.tensor(lanes_hp.get(k, [float(cfg.model[k])] * K), dtype=torch.float32)
          for k in lanes.probe.hparams()}
    assert all(len(set(v.tolist())) == K for k, v in hp.items() if k in lanes_hp)
    rel, atol = F64_TOL if name in F64 else (1e-5, 1e-7)
    out = _chip_smoke().lanes_step_check(lanes, hp, rel=rel, atol=atol, sure_abs=0.0)
    assert out["dtype"] == str(dtype) and len(out["lanes_loss"]) == K


def test_grad_clip_is_per_lane():
    """A lanes clip equals the trainer's global-norm clip of each lane alone
    (a lane under the norm untouched, one over it scaled), not the stacked
    norm's."""
    grads = [_rand(K, 4, 3, seed=1), _rand(K, 5, seed=2)]
    for g in grads:
        g[0] *= 0.01                            # lane 0 under the norm
    leaves = [torch.zeros_like(g).requires_grad_() for g in grads]
    for p, g in zip(leaves, grads):
        p.grad = g.clone()
    tlanes.clip_lanes_global_norm(leaves, 1.0)
    for i in range(K):
        alone = [torch.zeros_like(g[i]).requires_grad_() for g in grads]
        for p, g in zip(alone, grads):
            p.grad = g[i].clone()
        clip_grad_global_norm(alone, 1.0)
        for p, a in zip(leaves, alone):
            torch.testing.assert_close(p.grad[i], a.grad, rtol=1e-12, atol=1e-15)
    assert torch.equal(leaves[0].grad[0], grads[0][0])


# the JAX models' hparams() keys, in their order (they decide what is structural)
JAX_HPARAM_KEYS = {
    "lightgcn": ("reg_weight",), "sgl": ("reg_weight", "cl_weight", "temperature"),
    "simgcl": ("reg_weight", "cl_weight", "temperature", "eps"), "directau": ("gamma",),
    "dccf": ("reg_weight", "cl_weight", "temperature"), "hccf": ("cl_weight", "temperature"),
    "ncl": ("temperature", "proto_weight", "struct_weight"),
    "mhcn": ("reg_weight", "ss_rate"), "dcrec": ("reg_weight", "cross_weight", "domain_weight"),
    "kcgn": ("reg_weight",), "smin": ("reg_weight", "lambda1", "lambda2"),
    "mbgmn": ("reg_weight",), "hmgcr": ("reg_weight",), "smbrec": ("reg_weight", "cl_weight"),
    "cl4srec": ("lmd", "tau"), "duorec": ("lmd_sem", "tau"),
    "dcrec_seq": ("cl_lambda", "weight_mean"),
}
# JAX models with an hparams() hook whose grids JAX's own conditions send to
# the serial loop (an epoch_state without an epoch_state_fn)
JAX_SERIAL_ONLY = ("autocf", "gformer", "diffkg")


def _jax_class(name):
    from sslrec_tpu.models import registry as jregistry
    module, cls = jregistry._REGISTRY[name]
    return getattr(importlib.import_module(module), cls)


@pytest.mark.parametrize("name", list(JAX_HPARAM_KEYS))
def test_hparams_keys_are_jax_keys(name):
    """The JAX class's ``hparams()`` returns these keys in this order (read
    from its source, without building the model)."""
    import inspect
    keys = JAX_HPARAM_KEYS[name]
    src = inspect.getsource(_jax_class(name).hparams)
    assert src.count('": jnp.float32(') == len(keys), name
    pos = [src.index(f'"{k}"') for k in keys]
    assert pos == sorted(pos), name


def test_lanes_models_are_the_jax_lanes_models():
    """The port's models with an ``hparams()`` hook are the JAX package's,
    less the three that JAX's conditions keep serial; every one is held
    above."""
    from sslrec_tpu.models import registry as jregistry
    jax_hooked = {n for n in jregistry.available_models() if hasattr(_jax_class(n), "hparams")}
    port_hooked = {n for n in available_models() if hasattr(model_class(n), "hparams")}
    assert port_hooked == jax_hooked - set(JAX_SERIAL_ONLY) == set(JAX_HPARAM_KEYS) == set(MODELS)
    assert len(port_hooked) == 17


def test_lightgcn_lanes_step_against_jax_vmap(tiny_bundle, prf_edge_drop):
    """``jax.vmap(jax.value_and_grad(loss))`` over stacked ``batch["hp"]`` and
    the port's lanes step from the same parameters, batch and PRF key."""
    jcfg = jload_config("lightgcn")
    jmodel = JLightGCN(jcfg, tiny_bundle)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    jbatch, tbatch = _batch(jmodel.user_num, jmodel.item_num, 3)
    jkey, tkey = _keys(3)
    regs = np.array([1e-4, 1e-2, 1.0], np.float32)

    def lane(p, reg):
        return jmodel.loss(p, {**jbatch, "hp": {"reg_weight": reg}}, jkey)[0]

    stacked = jax.tree.map(lambda a: jnp.stack([a] * K), params)
    jloss, jgrads = jax.vmap(jax.value_and_grad(lane))(stacked, jnp.asarray(regs))

    cfg = load_config("lightgcn")
    data = tbundle(*_mats())
    lanes = Lanes(cfg, build_model(cfg, data), data)
    tparams = {"model." + n: v.unsqueeze(0).repeat(K, 1, 1).requires_grad_()
               for n, v in lightgcn_params_from_jax(jax.device_get(params)).items()}
    opt = build_optimizer(cfg, list(tparams.values()))
    loss = lanes.step(tparams, opt, {**tbatch, "step": 0}, tkey,
                      {"reg_weight": torch.from_numpy(regs)}, None)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    for n, p in tparams.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n[len("model."):]]),
                                   rtol=1e-5, atol=1e-7)


def _stacked_from(model) -> dict:
    """``model``'s parameters repeated K times along a lane dimension, as the
    lanes' leaves."""
    return {"model." + n: p.detach().unsqueeze(0).repeat(K, *(1,) * p.dim()).requires_grad_()
            for n, p in model.named_parameters()}


def test_smbrec_lanes_step_against_jax_vmap(monkeypatch):
    """SMBRec's lanes step against ``jax.vmap(jax.value_and_grad(loss))`` over
    stacked ``batch["hp"]``, from JAX's initial parameters, one batch and the
    same co-user offsets (given to both packages as in
    ``test_torch_mb_models.py``), float64 on both sides (that file's
    docstring): loss and gradients within 1e-9 of the largest entry."""
    import test_torch_mb_models as mbt
    from sslrec_tpu_torch.models.multi_behavior import smbrec as tsmbrec
    from sslrec_tpu_torch.models.sequential.base_seq import StepDraws

    jmodel, params, tmodel, tdata, _, tcfg = mbt._build("smbrec", f64=True)
    idx = mbt._batch(tdata.user_num, tdata.item_num, 3)
    draws, jdraws = mbt._draws("smbrec", jmodel, 4)
    hp = {"reg_weight": np.array([1e-3, 1e-2, 1e-1], np.float32),
          "cl_weight": np.array([1e-3, 1e-2, 1.0], np.float32)}
    mbt._stand_in(monkeypatch)
    jbatch = {k: jnp.asarray(v) for k, v in idx.items()}

    def lane(p, h):
        return jmodel.loss(p, {**jbatch, "hp": h}, jax.random.PRNGKey(5))[0]

    def f(p, h, d):
        mbt._DRAWS.clear()
        mbt._DRAWS.update({k: list(v) for k, v in d.items()})
        return jax.vmap(jax.value_and_grad(lane))(
            jax.tree.map(lambda a: jnp.stack([a] * K), p), h)

    with jax.enable_x64(True):
        jloss, jgrads = jax.jit(f)(params, {k: jnp.asarray(v) for k, v in hp.items()}, jdraws)
        jloss, jgrads = np.asarray(jloss), jax.tree.map(np.asarray, jgrads)

    given = {k: torch.from_numpy(v).double() for k, v in draws.items()}
    monkeypatch.setattr(tsmbrec, "StepDraws", lambda gen, d, dev: StepDraws(None, given, dev))
    lanes = Lanes(tcfg, tmodel, tdata)
    tparams = _stacked_from(tmodel)
    loss = lanes.step(tparams, build_optimizer(tcfg, list(tparams.values())),
                      {**{k: torch.from_numpy(v) for k, v in idx.items()}, "step": 0}, None,
                      {k: torch.from_numpy(v) for k, v in hp.items()}, None)
    assert loss.dtype == torch.float64
    _close(loss, torch.from_numpy(np.array(jloss)), "loss", rel=1e-9, atol=0.0)
    from sslrec_tpu_torch.utils import convert
    for i in range(K):
        # smbrec_params_from_jax's names (its tree's dotted paths), kept in float64
        want = convert._tree("", jax.tree.map(lambda g: g[i], jgrads))
        assert {"model." + n for n in want} == set(tparams)
        for n, p in tparams.items():
            if p.grad is None:      # unreached by the loss: JAX's gradient is zero there
                assert not np.asarray(want[n[len("model."):]]).any(), n
                continue
            _close(p.grad[i], torch.from_numpy(np.array(want[n[len("model."):]])),
                   f"lane {i} grad {n}", rel=1e-9, atol=0.0)


def test_duorec_lanes_step_against_jax_vmap():
    """DuoRec's lanes step against ``jax.vmap(jax.value_and_grad(loss))`` over
    stacked ``batch["hp"]``, from JAX's initial parameters, one batch and the
    dropout and semantic draws JAX makes from the key (given to the port by
    name, as in ``test_torch_seq_models.py``), float32: loss within rtol
    1e-5, gradients within that file's tolerance (rtol 1e-5, atol 1e-6 of the
    largest entry)."""
    from test_torch_seq_data import make_pair
    from test_torch_seq_layers import grad_close
    from test_torch_seq_models import batches, jax_draws
    from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
    from sslrec_tpu_torch.utils import convert

    jmodel, params, tmodel, jdata, tdata, _, tcfg = make_pair("duorec")
    jb, tb = batches("duorec", jmodel, jdata, 1)
    key = jax.random.PRNGKey(11)
    hp = {"lmd_sem": np.array([0.05, 0.1, 0.5], np.float32),
          "tau": np.array([0.5, 1.0, 2.0], np.float32)}

    def lane(p, h):
        return jmodel.loss(p, {**jb, "hp": h}, key)[0]

    jloss, jgrads = jax.jit(jax.vmap(jax.value_and_grad(lane)))(
        jax.tree.map(lambda a: jnp.stack([a] * K), params),
        {k: jnp.asarray(v) for k, v in hp.items()})

    draws = jax_draws("duorec", jmodel, jb, key)
    tmodel.draws = lambda gen, given=None: StepDraws(None, draws, "cpu")
    lanes = Lanes(tcfg, tmodel, tdata)
    tparams = _stacked_from(tmodel)
    loss = lanes.step(tparams, build_optimizer(tcfg, list(tparams.values())),
                      {**tb, "step": 0}, None, {k: torch.from_numpy(v) for k, v in hp.items()},
                      None)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    assert len(set(np.asarray(jloss).tolist())) == K
    for i in range(K):
        want = convert.duorec_params_from_jax(jax.tree.map(lambda g: np.asarray(g[i]), jgrads))
        for n, p in tparams.items():
            grad_close(p.grad[i].numpy(), want[n[len("model."):]].numpy(), f"lane {i} {n}")
