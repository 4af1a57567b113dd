"""The port's sequential handler (``sslrec_tpu_torch/data/sequential.py``)
against the JAX package's ``bundle_from_seqs``, array for array, with the
prefix expansion on and off; DCRec_seq's graphs, MAERec's transition graph
and DuoRec's candidate table against the JAX models' own, exactly; and the
TSV reader on a written directory.  Helpers here (the synthetic split, the
small config, the model pair) serve the other ``test_torch_seq_*`` files.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import sequential as jseq
from sslrec_tpu.models.registry import build_model as jbuild_model
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import sequential as tseq
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.models.sequential import dcrec as tdcrec
from sslrec_tpu_torch.models.sequential import duorec as tduorec
from sslrec_tpu_torch.models.sequential import maerec as tmaerec
from sslrec_tpu_torch.utils import convert

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

# the JAX package's sequential test shape: d 16, windows of 10, 1 layer, 2 heads
SMALL = {"model.embedding_size": 16, "model.max_seq_len": 10, "model.n_layers": 1,
         "model.n_heads": 2, "train.batch_size": 16}
MODEL_SMALL = {
    "bert4rec": {}, "cl4srec": {}, "duorec": {},
    "iclrec": {"model.num_intent_clusters": 4},
    "dcrec_seq": {"model.sim_group_k": 2},
    "maerec": {"model.con_batch": 8, "model.num_reco_neg": 4, "model.num_mask_cand": 5,
               "model.mask_steps": 2, "model.num_trm_layers": 1},
}


def synthetic_seqs(n_users=40, n_items=30, seed=0):
    """The JAX package's test split (``tests/test_models_sequential.py``)."""
    rng = np.random.default_rng(seed)
    trn_u, trn_s, trn_l, tst_u, tst_s, tst_l = [], [], [], [], [], []
    for u in range(n_users):
        ln = int(rng.integers(3, 12))
        seq = [int(x) for x in rng.integers(1, n_items + 1, ln)]
        trn_u.append(u)
        trn_s.append(seq[:-1])
        trn_l.append(seq[-1])
        tst_u.append(u)
        tst_s.append(seq)
        tst_l.append(int(rng.integers(1, n_items + 1)))
    return (trn_u, trn_s, trn_l), (tst_u, tst_s, tst_l)


def write_seq_dir(root, name="toy", n_users=40, n_items=30, seed=0) -> None:
    """A TSV split under ``root/sequential/<name>/``: each user's train row
    ends one item before its test row."""
    d = os.path.join(root, "sequential", name)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = {"train": [], "test": []}
    for u in range(n_users):
        s = [int(x) for x in rng.integers(1, n_items + 1, int(rng.integers(5, 12)))]
        rows["train"].append(f"{u}\t{' '.join(map(str, s[:-2]))}\t{s[-2]}")
        rows["test"].append(f"{u}\t{' '.join(map(str, s[:-1]))}\t{s[-1]}")
    for split, lines in rows.items():
        with open(os.path.join(d, f"{split}.tsv"), "w") as f:
            f.write("\n".join(["uid\tseq\tlast", *lines]) + "\n")


def configs(name, extra=None):
    over = {**SMALL, **MODEL_SMALL[name], **(extra or {})}
    return jload_config(name, overrides=over), tload_config(name, overrides=over)


def make_pair(name, extra=None, seed=0):
    """``(jmodel, params, tmodel, jdata, tdata, jcfg, tcfg)`` on the synthetic
    split, the port's model holding JAX's initial weights."""
    jcfg, tcfg = configs(name, extra)
    train, test = synthetic_seqs(seed=seed)
    jdata = jseq.bundle_from_seqs(jcfg, train, test)
    tdata = tseq.bundle_from_seqs(tcfg, train, test)
    jmodel = jbuild_model(jcfg, jdata)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, tdata)
    tmodel.load_state_dict(getattr(convert, f"{name}_params_from_jax")(
        jax.device_get(params)))
    return jmodel, params, tmodel, jdata, tdata, jcfg, tcfg


def _same(got, want, what):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _padded_same(tp, jp, what):
    for f in ("cols", "mask", "lengths"):
        _same(getattr(tp, f), getattr(jp, f), f"{what}.{f}")


@pytest.mark.parametrize("seq_aug", [False, True], ids=["plain", "seq_aug"])
def test_bundle_matches_jax(seq_aug):
    over = {**SMALL, "data.seq_aug": seq_aug}
    jcfg, tcfg = jload_config("cl4srec", overrides=over), tload_config("cl4srec", overrides=over)
    train, test = synthetic_seqs()
    j, t = jseq.bundle_from_seqs(jcfg, train, test), tseq.bundle_from_seqs(tcfg, train, test)
    assert (t.user_num, t.item_num) == (j.user_num, j.item_num)
    _same(t.train_users, j.train_users, "train_users")
    _same(t.train_items, j.train_items, "train_items")
    _same(t.train_edge_set.codes, j.train_edge_set.codes, "edge set")
    assert t.valid is None and j.valid is None
    _same(t.test.test_users, j.test.test_users, "test_users")
    _padded_same(t.test.ground_truth, j.test.ground_truth, "ground_truth")
    _padded_same(t.test.history, j.test.history, "history")
    assert t.test.n_test_users == j.test.n_test_users
    for k in ("user", "seq", "seq_last", "pos"):
        _same(t.extras["train_arrays"][k], j.extras["train_arrays"][k], k)
    for k in ("user_seq_table", "user_seq_uids", "test_seqs", "test_uids"):
        _same(t.extras[k], j.extras[k], k)
    assert (t.extras["score_cols"], t.extras["neg_low"]) == (j.extras["score_cols"], 1)
    n_rows = sum(max(len(s) - 2, 0) for s in train[1]) if seq_aug else 0
    assert t.n_train == len(train[0]) + n_rows


def test_load_reads_the_tsv_directory(tmp_path):
    write_seq_dir(tmp_path)
    cfg = tload_config("bert4rec", overrides={**SMALL, "data.dir": str(tmp_path),
                                              "data.name": "toy"})
    data = load_data(cfg, "cpu")
    train = tseq.read_tsv(os.path.join(tmp_path, "sequential", "toy", "train.tsv"))
    test = tseq.read_tsv(os.path.join(tmp_path, "sequential", "toy", "test.tsv"))
    assert data.n_train == 40 and data.test.n_test_users == 40
    # the train row's target precedes the test row's, inside the test row
    for s_tr, l_tr, s_te in zip(train[1], train[2], test[1]):
        assert s_te == s_tr + [l_tr]
    assert data.extras["train_arrays"]["seq"].dtype == torch.int32


def test_dcrec_graphs_equal_jax():
    jmodel, _, tmodel, jdata, tdata, *_ = make_pair("dcrec_seq")
    from sslrec_tpu.models.sequential.dcrec import _build_graphs as jbuild
    for table in ("user_seq_table", "test_seqs"):
        jg = jbuild(jdata.extras[table], jmodel.n_items1, jmodel.sim_k)
        tg = tdcrec.build_graphs(tdata.extras[table].numpy(), tmodel.n_items1, tmodel.sim_k)
        for jpart, tpart, what in zip(jg, tg, ("adj", "user_edges", "sim")):
            for i, (ja, ta) in enumerate(zip(jpart, tpart)):
                _same(ta, ja, f"{table}.{what}[{i}]")
    _same(tmodel.adj.rows, jmodel.adj[0], "model adj rows")
    _same(tmodel.sim.vals, jmodel.sim[2], "model sim vals")
    _same(tmodel.adj_test.cols, jmodel.adj_test[1], "model test adj cols")
    _same(tmodel.user_eids, jmodel.user_eids, "user_eids")
    _same(tmodel.user_emask, jmodel.user_emask, "user_emask")
    _same(tmodel.row_of_uid, jmodel.row_of_uid, "row_of_uid")
    assert tmodel.adj.g.fwd.vals_ones and tmodel.adj.g.fwd.ids_identity


def test_maerec_graph_equal_jax():
    jmodel, _, tmodel, *_ = make_pair("maerec")
    _same(tmodel.rows, jmodel.rows, "rows")
    _same(tmodel.cols, jmodel.cols, "cols")
    _same(tmodel.norm_vals, jmodel.norm_vals, "norm_vals")
    assert tmodel.nnz == jmodel.nnz
    _same(tmodel.ii_edge_set.codes, jmodel.ii_edge_set.codes, "ii edge set")
    assert tmodel.graph.fwd.vals_ones and tmodel.graph.nnz == jmodel.nnz
    _, (r, c, v) = tmaerec.transition_graph(np.zeros((3, 10), np.int32), 5)
    assert list(zip(r, c)) == [(i, i) for i in range(5)] and (v == 1).all()


def test_duorec_candidate_table_bit_equal():
    jmodel, _, tmodel, *_ = make_pair("duorec")
    _same(tmodel.cand_table, jmodel.cand_table, "cand_table")
    _same(tmodel.cand_count, jmodel.cand_count, "cand_count")
    # a target with more than 20 rows: the rng's pick, bit for bit
    lasts = np.r_[np.full(57, 3), np.arange(1, 9)].astype(np.int32)
    cand, cnt = tduorec.candidate_table(lasts, 10)
    rng = np.random.default_rng(0)
    order = np.argsort(lasts, kind="stable")
    assert cnt[3] == 20
    groups = [order[lasts[order] == i] for i in np.unique(lasts)]
    picks = [rng.choice(g, 20, replace=False) if len(g) > 20 else g for g in groups]
    np.testing.assert_array_equal(cand[3], picks[2])
