"""BERT4Rec, CL4SRec, DuoRec, ICLRec, DCRec_seq and MAERec on a {data: 2,
model: 2} mesh of gloo processes: one step of each against the JAX package
on one device (``value_and_grad`` of the loss on the whole batch; MAERec's
own ``train_step`` with the gradients it gives its Adam), and the rule that
leaves every parameter of the six replicated.

The ranks run ``parallel.checks.model_step`` for the six in one spawn of
four.  The JAX package shards a parameter only where its leading dimension
is a user, item or ``U+I`` count (``sharded_row_dims``); none of the six's
is, at the published configs (Amazon Sports' 35,598 users and 18,357 items)
or at this file's toy split (53 users, 37 items, d 16), so each rank holds
every parameter whole and the batch splits over ``data``.  The batch has 15
rows, so the two ``data`` slices differ by one.

Draws are JAX's under the loss's key, traced with the loss into one jitted
program in the same float64 context (``test_torch_seq_models.jax_draws``,
``test_torch_seq_graph_models.dcrec_draws`` and ``step_draws``), under
JAX's ``unsafe_rbg`` PRNG, which the loss and the draws both take; they are
the whole batch's, and each rank keeps its slice of those whose leading
dimension is the batch (the towers' dropout masks, BERT4Rec's mask uniforms
and random items, the augmentations, DuoRec's candidate slots).  ICLRec
takes JAX's clusters and MAERec JAX's mask bank as their epoch state.

All six run in float64 on both sides (JAX under ``jax.enable_x64``, the
port's model in double; the graphs' values stay float32).  Tolerances, as
``test_torch_mesh_social_step.py`` holds item 9b's: the loss terms rtol
1e-6; the whole gradients (summed over ``data``) rtol 1e-5 with atol 1e-7
of the tensor's largest entry (the attention's key biases, whose gradient
is zero in exact arithmetic, within 1e-12 of the model's largest gradient
entry on both sides).  MAERec's loss history after the step equals
JAX's (rtol 1e-6) on every rank.

Without JAX, the draws a rank makes from the epoch's generator on its slice
are held to the whole batch's rows of the same draws (and a given draw to
its rows), for every kind the six take.

A tower mask drawn at the slice's shape, a per-row ``randint`` scaled
before it is sliced, ``nt_xent`` or ICLRec's ``nce_loss`` without the
gather, DCRec_seq's removed edges or agreement taken from the slice,
BERT4Rec's masked count taken from the slice, or MAERec's history recorded
before the ``data`` reduction fails these.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import sequential as jseq
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import sequential as tseq
from sslrec_tpu_torch.models import seq_augment
from sslrec_tpu_torch.models.registry import build_model as tbuild
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.parallel import checks, launch
from sslrec_tpu_torch.utils import convert
import test_torch_seq_graph_models as seq_graph_models
import test_torch_seq_layers as seq_layers
import test_torch_seq_models as seq_models
from test_torch_seq_data import MODEL_SMALL, SMALL, synthetic_seqs

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

N_USERS, N_ITEMS, BATCH = 53, 37, 15
MODELS = ("bert4rec", "cl4srec", "duorec", "iclrec", "dcrec_seq", "maerec")
N_BATCHES = 2       # MAERec's mask bank: one view (mask_steps 2), step 0 a mask step
TERMS_RTOL, RTOL, ATOL_REL = 1e-6, 1e-5, 1e-7
ZERO_REL = 1e-12    # a gradient zero in exact arithmetic, relative to the largest entry
# the published shape: Amazon Sports and Outdoors 5-core (S3-Rec's table)
SPORTS_USERS, SPORTS_ITEMS = 35_598, 18_357


@contextlib.contextmanager
def _traced():
    """Float64, JAX's ``unsafe_rbg`` PRNG (its draws compile in a fraction of
    threefry's time; the loss and the draw helpers both take it) and the
    draw helpers returning JAX arrays, so that the loss and its draws trace
    into one jitted program."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            jax.default_prng_impl("unsafe_rbg"):
        for mod in (seq_layers, seq_models, seq_graph_models):
            mp.setattr(mod, "t", lambda a: a)
        yield


def _over(name):
    return {**SMALL, **MODEL_SMALL[name]}


@functools.lru_cache(maxsize=None)
def toy():
    return synthetic_seqs(n_users=N_USERS, n_items=N_ITEMS, seed=4)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return np.asarray(x)


def _names(name, tree) -> dict:
    """A JAX parameter (or gradient) tree as numpy arrays under the port's
    names, in the tree's own precision."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_state", lambda flat: {k: np.asarray(v) for k, v in flat.items()})
        return getattr(convert, f"{name}_params_from_jax")(
            jax.tree.map(np.asarray, jax.device_get(tree)))


def _grads_tx():
    """An optax transformation that changes nothing and keeps the gradients
    it is given as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_case(name):
    """The JAX reference of one step on the whole batch (float64), and the
    port's ``model_step`` inputs."""
    train, test = toy()
    jcfg = jload_config(name, overrides=_over(name))
    jdata = jseq.bundle_from_seqs(jcfg, train, test)
    jm = jbuild(jcfg, jdata)
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    arrays = {k: np.asarray(v) for k, v in jdata.extras["train_arrays"].items()}
    idx = rng.choice(jdata.n_train, BATCH, replace=False)
    batch = {k: v[idx] for k, v in arrays.items()}
    if name == "iclrec":
        batch["neg"] = rng.integers(1, jdata.item_num, BATCH).astype(np.int32)
    inp = {"model": name, "n_data": 2, "n_model": 2, "overrides": _over(name),
           "seq_split": {"train": train, "test": test}, "f64": True, "key": None, **batch}
    with _traced():
        key = jax.random.PRNGKey(9)
        params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if name == "maerec":
            jm._n_batches_hint = N_BATCHES
            jb.update(step=jnp.asarray(0), aux=jm.epoch_state(params, jax.random.PRNGKey(8), 0))
            jm._opt = _grads_tx()

            def step(params, jb, key):
                _, state, terms = jm.train_step(params, jm.init_opt_state(params), jb, key)
                return state, terms, seq_graph_models.step_draws(jm, jb["seq"], key)

            state, terms, draws = jax.jit(step)(params, jb, key)
            want = {"terms": {k: float(v) for k, v in terms.items()},
                    "grads": _names(name, state["opt"]),
                    "loss_hist": np.asarray(state["loss_hist"])}
            inp.update(aux=_np(jb["aux"]), step=0)
        else:
            if name == "iclrec":
                jb["aux"] = jm.epoch_state(params, jax.random.PRNGKey(4), 0)
                inp["aux"] = _np(jb["aux"])

            def step(params, jb, key):
                draws = (seq_graph_models.dcrec_draws(jm, jb["seq"], key)
                         if name == "dcrec_seq" else seq_models.jax_draws(name, jm, jb, key))
                return jax.value_and_grad(jm.loss, has_aux=True)(params, jb, key), draws

            ((loss, terms), grads), draws = jax.jit(step)(params, jb, key)
            want = {"terms": {**{k: float(v) for k, v in terms.items()}, "loss": float(loss)},
                    "grads": _names(name, grads)}
    inp.update(params=_names(name, params), draws=_np(draws))
    return want, inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax_side, todo = {}, []
    for name in MODELS:
        jax_side[name], inp = _jax_case(name)
        todo.append((name, "model_step", inp))
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("seq21")))
    return jax_side, out


@pytest.mark.parametrize("name", MODELS)
def test_mesh_step_matches_jax(ranks, name):
    """One {2, 2} step against JAX on the whole batch, in every rank: the loss
    terms and the whole gradients (a parameter the loss does not reach, as
    DCRec_seq's ``cl_fc1`` and ``cl_fc2``, has none, and JAX's is zero);
    every parameter whole in each rank; MAERec's loss history."""
    jax_side, out = ranks
    want = jax_side[name]
    for r in out:
        got = r[name]
        assert got["local_shapes"] == {}
        assert set(got["terms"]) == set(want["terms"])
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=TERMS_RTOL,
                                       err_msg=f"{name}: {k}")
        assert set(got["grads"]) == set(want["grads"])
        top = max(np.abs(v).max() for v in want["grads"].values())
        for k, v in want["grads"].items():
            if got["grads"][k] is None:
                assert not np.asarray(v).any(), f"{name}: {k} has no gradient"
                continue
            assert got["grads"][k].dtype == np.float64
            if k.endswith("attn.k.b"):
                # zero in exact arithmetic (a bias shared by every key shifts
                # each query's scores alike, and the softmax ignores it): both
                # sides hold rounding alone
                for g in (got["grads"][k], v):
                    assert np.abs(g).max() <= ZERO_REL * top, f"{name}: grads {k}"
                continue
            np.testing.assert_allclose(got["grads"][k], v, rtol=RTOL,
                                       atol=ATOL_REL * max(np.abs(v).max(), 1e-30),
                                       err_msg=f"{name}: grads {k}")
        if name == "maerec":
            assert got["extra_state"]["hist_len"] == 1
            np.testing.assert_allclose(got["extra_state"]["loss_hist"], want["loss_hist"],
                                       rtol=TERMS_RTOL, err_msg="maerec: loss_hist")


def _sports_split():
    """A split at Amazon Sports' published counts of users and items (the
    last user's and item's ids present), with few sequences: the shapes of
    the published configs' parameters depend on these counts only."""
    rng = np.random.default_rng(1)
    uids = [int(u) for u in np.linspace(0, SPORTS_USERS - 1, 20)]
    seqs = [[int(x) for x in rng.integers(1, SPORTS_ITEMS + 1, 6)] for _ in uids]
    seqs[-1][-1] = SPORTS_ITEMS
    train = (uids, [s[:-2] for s in seqs], [s[-2] for s in seqs])
    test = (uids, [s[:-1] for s in seqs], [s[-1] for s in seqs])
    return train, test


@pytest.mark.parametrize("sizes", ["published", "toy"])
@pytest.mark.parametrize("name", MODELS)
def test_no_parameter_is_row_sharded(name, sizes):
    """JAX's rule shards none of the model's parameters (no leading dimension
    is in its ``sharded_row_dims``: a user, item or ``U+I`` count), at the
    published config on Amazon Sports' counts and at this file's toy sizes,
    and the port's model lists no row shard: its parameters are JAX's, name
    for name and shape for shape."""
    over = {} if sizes == "published" else _over(name)
    train, test = _sports_split() if sizes == "published" else toy()
    jcfg, tcfg = jload_config(name, overrides=over), tload_config(name, overrides=over)
    jm = jbuild(jcfg, jseq.bundle_from_seqs(jcfg, train, test))
    if sizes == "published":
        assert (jm.user_num, jm.item_num) == (SPORTS_USERS, SPORTS_ITEMS)
    dims = jm.sharded_row_dims()
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    sharded = [(jax.tree_util.keystr(path), leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)
               if len(leaf.shape) >= 1 and leaf.shape[0] in dims]
    assert sharded == [], (dims, sharded)
    tm = tbuild(tcfg, tseq.bundle_from_seqs(tcfg, train, test))
    assert tm.row_shards == {} and tm.mesh_todo is None
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: v.shape for k, v in _names(name, zeros).items()}
    assert {k: tuple(p.shape) for k, p in tm.named_parameters()} == want


def _slice_draws(dr, seqs, rows):
    """Every kind of draw the six make, for the batch rows ``rows`` of
    ``seqs``: batch-sized ones (uniforms, keeps, normals, integers below an
    int and below per-row bounds, the two views' augmentation draws, a tower
    dropout's masks) and one that is not (``alike``)."""
    b, l = seqs[rows].shape
    spans = 1 + (seqs > 0).sum(1)
    drop = dr.dropout("drop", 0.3)
    op_u, v1, v2 = seq_augment.two_view_draws(dr, seqs[rows], 0.6, 0.6)
    return {"u": dr.uniform("u", (b, l), batch=True),
            "keep": dr.keep("keep", 0.3, (b, 3), batch=True),
            "z": dr.normal("z", (b,), batch=True),
            "i": dr.randint("i", 1, 30, (b, l), batch=True),
            "j": dr.randint("j", 0, spans[rows], (b,), batch=True),
            "alike": dr.uniform("alike", (7,)),
            "aug_op_u": op_u, **{f"aug_view1.{k}": v for k, v in v1.items()},
            **{f"aug_view2.{k}": v for k, v in v2.items()},
            "drop": [drop(torch.ones(b, l, 4)) for _ in range(2)]}


@pytest.mark.parametrize("n_data", [2, 3])
def test_a_slice_draws_the_whole_batch_rows(n_data):
    """On each ``data`` slice of a batch of 15 (slices of unequal sizes), the
    batch-sized draws from the epoch's generator are the rows of the same
    draws made for the whole batch, and a draw not sized by the batch is
    the whole draw; given draws (a test's JAX ones) are sliced the same
    way, the augmentation's and the dropout masks too."""
    n = 15
    seqs = torch.from_numpy(np.asarray(
        [np.pad(s, (10 - len(s[-10:]), 0))[-10:] for s in toy()[0][1][:n]]))
    whole = _slice_draws(StepDraws(torch.Generator().manual_seed(3)), seqs, slice(None))
    given = {k: v for k, v in whole.items() if not k.startswith("aug_") and k != "drop"}
    given.update(aug_op_u=whole["aug_op_u"],
                 drop=[(m > 0) for m in whole["drop"]] + [(m > 0) for m in whole["drop"]],
                 **{f"aug_view{v}": {k.split(".")[1]: t for k, t in whole.items()
                                     if k.startswith(f"aug_view{v}.")} for v in (1, 2)})
    for r in range(n_data):
        sl = slice(n * r // n_data, n * (r + 1) // n_data)
        for dr in (StepDraws(torch.Generator().manual_seed(3)), StepDraws(None, given, "cpu")):
            got = _slice_draws(dr.on_rows(n, sl), seqs, sl)
            assert set(got) == set(whole)
            for k, v in whole.items():
                want = v if k == "alike" else [m[sl] for m in v] if k == "drop" else v[sl]
                for a, b in zip(got[k] if k == "drop" else [got[k]],
                                want if k == "drop" else [want]):
                    assert torch.equal(a, b), (r, k)
