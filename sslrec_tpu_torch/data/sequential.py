"""Sequential data handler (port of ``sslrec_tpu/data/sequential.py``).

TSV rows ``uid \\t seq \\t last`` (1-indexed items, a header line) for the
train and test splits; optional prefix expansion of the train rows
(``data.seq_aug``); left padding / truncation to ``max_seq_len`` with pad id
0.  The test ground truth is each row's single ``last`` item, and evaluation
masks the items of that row's input sequence.  Scores are ``item_num + 1``
wide: column ``i`` is item ``i``, column 0 the pad.

Everything lands as int32 tensors on the run's device: the train rows carry
the input sequence (``seq``), the window of (seq + last) that BERT4Rec masks
(``seq_last``) and the target (``pos``).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch.data.base import DataBundle, EvalData
from sslrec_tpu_torch.ops import sparse as sparse_ops

_DEFAULT_DATA_ROOT = "datasets"


def read_tsv(path: str):
    """``(uids, seqs, lasts)`` of one TSV split, the header skipped."""
    uids, seqs, lasts = [], [], []
    with open(path) as f:
        next(f)
        for line in f:
            uid, seq, last = line.strip().split("\t")
            uids.append(int(uid))
            seqs.append([int(x) for x in seq.split(" ")])
            lasts.append(int(last))
    return uids, seqs, lasts


def _pad_left(seq, max_len):
    if len(seq) >= max_len:
        return seq[-max_len:]
    return [0] * (max_len - len(seq)) + seq


def _dataset_dir(cfg) -> str:
    root = cfg.data.get("dir") or _DEFAULT_DATA_ROOT
    name = cfg.data.name
    sub = {"sports": "sports_seq", "ml-20m": "ml-20m_seq"}
    return os.path.join(root, "sequential", sub.get(name, name))


def load(cfg, device="cpu") -> DataBundle:
    """``<data.dir>/sequential/<name>/{train,test}.tsv`` (``sports`` reads
    ``sports_seq``, ``ml-20m`` ``ml-20m_seq``)."""
    d = _dataset_dir(cfg)
    train = read_tsv(os.path.join(d, "train.tsv"))
    test = read_tsv(os.path.join(d, "test.tsv"))
    return bundle_from_seqs(cfg, train, test, device)


def _padded(seqs, max_len) -> np.ndarray:
    if not len(seqs):
        return np.zeros((0, max_len), np.int32)
    return np.asarray([_pad_left(list(s), max_len) for s in seqs], np.int32)


def bundle_from_seqs(cfg, train, test, device="cpu") -> DataBundle:
    """The bundle of parsed ``(uids, seqs, lasts)`` splits (also used by tests)."""
    trn_u, trn_s, trn_l = train
    tst_u, tst_s, tst_l = test
    max_len = int(cfg.model.max_seq_len)
    item_num = max(max(max(s) for s in trn_s), max(trn_l),
                   max(max(s) for s in tst_s), max(tst_l))
    user_num = max(max(trn_u), max(tst_u)) + 1

    if cfg.data.get("seq_aug", False):
        # prefix expansion: [1, 2, 3] -> ([1], 2), ([1, 2], 3) after the row itself
        au, as_, al = list(trn_u), [list(s) for s in trn_s], list(trn_l)
        for uid, seq in zip(trn_u, trn_s):
            for i in range(1, len(seq) - 1):
                au.append(uid)
                as_.append(seq[:i])
                al.append(seq[i])
        trn_u, trn_s, trn_l = au, as_, al

    seqs = _padded(trn_s, max_len)
    seq_last = _padded([list(s) + [l] for s, l in zip(trn_s, trn_l)], max_len)
    lasts = np.asarray(trn_l, np.int32)
    uids = np.asarray(trn_u, np.int32)

    # per-user history (every item of its rows, and their targets) for rejecting
    # negatives
    hist = {}
    for uid, s, l in zip(trn_u, trn_s, trn_l):
        items = hist.setdefault(uid, set())
        items.update(s)
        items.add(l)
    hrows = [u for u, items in hist.items() for _ in items]
    hcols = [i for items in hist.values() for i in items]
    width = item_num + 1
    hist_mat = sp.coo_matrix((np.ones(len(hrows), np.float32), (hrows, hcols)),
                             shape=(user_num, width))

    gt_rows, gt_cols, th_rows, th_cols = [], [], [], []
    for uid, s, l in zip(tst_u, tst_s, tst_l):
        gt_rows.append(uid)
        gt_cols.append(l)
        for it in set(s):
            th_rows.append(uid)
            th_cols.append(it)

    def mat(rows, cols):
        return sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                             shape=(user_num, width))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    test_eval = EvalData(
        test_users=t(np.asarray(tst_u, np.int32)),
        ground_truth=sparse_ops.build_padded_rows(mat(gt_rows, gt_cols), device=device),
        history=sparse_ops.build_padded_rows(mat(th_rows, th_cols), device=device),
        n_test_users=len(tst_u),
    )
    return DataBundle(
        user_num=int(user_num),
        item_num=int(item_num),
        train_users=t(uids),
        train_items=t(lasts),
        train_edge_set=sparse_ops.build_edge_set(hist_mat, device=device),
        valid=None,     # the test split serves as the validation split too
        test=test_eval,
        extras={
            "train_arrays": {"user": t(uids), "seq": t(seqs), "seq_last": t(seq_last),
                             "pos": t(lasts)},
            # the unexpanded train rows, one a user (DCRec_seq's graphs)
            "user_seq_table": t(_padded(train[1], max_len)),
            "user_seq_uids": t(np.asarray(train[0], np.int32)),
            "test_seqs": t(_padded(tst_s, max_len)),
            "test_uids": t(np.asarray(tst_u, np.int32)),
            "score_cols": width,
            "neg_low": 1,   # negatives are drawn from [1, item_num)
        },
    )
