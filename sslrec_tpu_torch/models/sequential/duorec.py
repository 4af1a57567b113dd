"""DuoRec: contrastive regularisation with a dropout-twice positive and a
same-target (semantic) positive (port of
``sslrec_tpu/models/sequential/duorec.py``).

Next-item cross entropy against the token table; each item's candidate
table holds at most 20 train rows whose target it is (20 picked with
``np.random.default_rng(0)`` where there are more, bit for bit as the JAX
package), one of which replaces the batch row's sequence (its own where
the target has none); NT-Xent between a second dropout pass of the batch
and the pass over those sequences.

Draws: ``drop``, ``drop1``, ``drop2`` and ``sem_j`` [B], the candidate's
slot.  On a mesh, as CL4SRec: the NT-Xent over the whole batch's gathered
encodings, the cross entropy the slice's mean.
"""

from __future__ import annotations

import numpy as np
import torch

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.sequential.cl4srec import SeqTowerModel, nt_xent


def candidate_table(lasts: np.ndarray, item_num: int, width: int = 20):
    """``(cand [item_num + 2, width], count [item_num + 2])``: per item the
    train rows whose target it is, ``width`` of them drawn without
    replacement from ``np.random.default_rng(0)`` where there are more."""
    order = np.argsort(lasts, kind="stable")
    cand = np.zeros((item_num + 2, width), np.int32)
    cnt = np.zeros((item_num + 2,), np.int32)
    rng = np.random.default_rng(0)
    sorted_lasts = lasts[order]
    start = 0
    for i in range(1, len(order) + 1):
        if i == len(order) or sorted_lasts[i] != sorted_lasts[start]:
            group = order[start:i]
            item = int(sorted_lasts[start])
            pick = rng.choice(group, width, replace=False) if len(group) > width else group
            cand[item, : len(pick)] = pick
            cnt[item] = len(pick)
            start = i
    return cand, cnt


class DuoRec(SeqTowerModel):
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.lmd_sem = float(cfg.model.lmd_sem)
        self.tau = float(cfg.model.tau)
        arrays = data.extras["train_arrays"]
        self.train_seqs = arrays["seq"]
        cand, cnt = candidate_table(arrays["pos"].cpu().numpy(), self.item_num)
        self.cand_table = torch.from_numpy(cand).to(self.device)
        self.cand_count = torch.from_numpy(cnt).to(self.device)

    def semantic_views(self, seqs, lasts, j):
        cnt = self.cand_count[lasts.long()]
        rows = self.cand_table[lasts.long(), j.long()]
        return torch.where((cnt > 0)[:, None], self.train_seqs[rows.long()], seqs)

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel``."""
        return {"lmd_sem": self.lmd_sem, "tau": self.tau}

    def loss(self, batch: dict, gen, draws: dict | None = None):
        hp = batch.get("hp", {})
        lmd_sem = hp.get("lmd_sem", self.lmd_sem)
        tau = hp.get("tau", self.tau)
        seqs, lasts = batch["seq"], batch["pos"]
        dr = self.step_draws(gen, draws, batch)
        h = self._encode(seqs, dr.dropout("drop", self.dropout_rate))
        rec_loss = losses.next_item_ce(h @ self._items().T, lasts)
        h1 = self._encode(seqs, dr.dropout("drop1", self.dropout_rate))
        j = dr.randint("sem_j", 0, self.cand_count[lasts.long()].clamp(min=1), lasts.shape,
                       batch=True)
        h2 = self._encode(self.semantic_views(seqs, lasts, j),
                          dr.dropout("drop2", self.dropout_rate))
        cl_loss = lmd_sem * nt_xent(self.whole(h1, batch), self.whole(h2, batch), tau)
        return rec_loss + cl_loss, {"rec_loss": rec_loss, "cl_loss": cl_loss}
