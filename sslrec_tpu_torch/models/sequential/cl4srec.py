"""CL4SRec: next-item cross entropy plus NT-Xent between two augmented views
of each sequence (port of ``sslrec_tpu/models/sequential/cl4srec.py``).

The prediction head is the token table over ids 0..item_num (no bias); each
row's two views apply two distinct ops of {crop, mask, reorder}
(:mod:`~sslrec_tpu_torch.models.seq_augment`); NT-Xent runs over the 2B
in-batch views with raw dot-product similarities.

Draws: ``drop``, ``drop1``, ``drop2`` (the three tower passes' keep masks)
and the augmentation's ``aug_op_u``, ``aug_view1``, ``aug_view2``.

On a mesh the NT-Xent's negatives are the whole batch's views: both views'
encodings are gathered over ``data`` and the term is computed whole on
every rank; the next-item cross entropy is the slice's mean.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import layers, losses, seq_augment
from sslrec_tpu_torch.models.sequential.base_seq import SequentialModel


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, temp) -> torch.Tensor:
    """In-batch NT-Xent: per row of the 2B views, the cross entropy of its
    partner against every view but itself and its partner.  ``temp`` is a
    float or a tensor (a lane's scalar): it only divides."""
    b = z1.shape[0]
    z = torch.cat([z1, z2], 0)
    sim = z @ z.T / temp
    pos = torch.cat([(z1 * z2).sum(-1), (z2 * z1).sum(-1)]) / temp
    idx = torch.arange(2 * b, device=z.device)
    partner = torch.where(idx < b, idx + b, idx - b)
    neg_mask = torch.ones(2 * b, 2 * b, dtype=torch.bool, device=z.device)
    neg_mask[idx, idx] = False
    neg_mask[idx, partner] = False
    neg = torch.where(neg_mask, sim, -torch.inf)
    denom = torch.logsumexp(torch.cat([pos[:, None], neg], 1), dim=1)
    return (denom - pos).mean()


class SeqTowerModel(SequentialModel):
    """A model whose items are the tower's token table (vocabulary ``item_num
    + 2``, the last id a mask token) and whose head is that table over ids
    0..item_num: CL4SRec, DuoRec and ICLRec."""

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.mask_token = self.item_num + 1
        self.emb, self.layers = layers.tower_params(
            self.item_num + 2, self.emb_size, self.max_len, self.n_layers, self.device)

    def init_params(self, gen: torch.Generator) -> None:
        layers.init_tower(gen, self.emb, self.layers)

    def _encode(self, seqs, drop=None, mean: bool = False):
        h = layers.apply_transformer_tower(self.emb, self.layers, seqs, self.n_heads, drop)
        return h.mean(1) if mean else h[:, -1, :]

    def _items(self):
        return self.emb["token"][: self.item_num + 1]

    def encode_for_predict(self, seqs, ctx):
        return self._encode(seqs)

    def item_logits_params(self, ctx):
        w = self._items()
        return w, w.new_zeros(w.shape[0])


class CL4SRec(SeqTowerModel):
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.lmd = float(cfg.model.lmd)
        self.tau = float(cfg.model.tau)

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel``; ``dropout_rate`` stays
        structural (it sizes the tower's dropout calls)."""
        return {"lmd": self.lmd, "tau": self.tau}

    def loss(self, batch: dict, gen, draws: dict | None = None):
        hp = batch.get("hp", {})
        lmd = hp.get("lmd", self.lmd)
        tau = hp.get("tau", self.tau)
        seqs = batch["seq"]
        dr = self.step_draws(gen, draws, batch)
        h = self._encode(seqs, dr.dropout("drop", self.dropout_rate))
        rec_loss = losses.next_item_ce(h @ self._items().T, batch["pos"])
        op_u, d1, d2 = seq_augment.two_view_draws(dr, seqs, 0.6, 0.6)
        v1, v2 = seq_augment.cl4srec_two_views(seqs, op_u, d1, d2, self.mask_token)
        h1 = self._encode(v1, dr.dropout("drop1", self.dropout_rate))
        h2 = self._encode(v2, dr.dropout("drop2", self.dropout_rate))
        cl_loss = lmd * nt_xent(self.whole(h1, batch), self.whole(h2, batch), tau)
        return rec_loss + cl_loss, {"rec_loss": rec_loss, "cl_loss": cl_loss}
