"""BERT4Rec: masked-item modelling over a bidirectional transformer (port of
``sslrec_tpu/models/sequential/bert4rec.py``).

The vocabulary is ``item_num + 2`` (pad 0, mask token ``item_num + 1``).
Training masks the (seq + last) window: a live position is selected with
probability ``mask_prob`` and then becomes the mask token (80%), a random
item (10%) or itself (10%), read off the same uniform; the loss is the cross
entropy over ``item_num + 1`` classes at the selected positions.  With
``masked_budget`` K > 0 only the first K selected positions of a row (in
``lax.top_k``'s order of the 0/1 selection, ties toward the lower position)
enter the loss.  Evaluation appends the mask token and scores the last
position.

Draws (:class:`StepDraws`): ``mask_u`` [B, L] uniforms, ``rand_items``
[B, L] in [1, item_num], ``drop`` the tower's keep masks.

On a mesh the cross entropy's denominator is the whole batch's count of
masked positions (summed over ``data``, no gradient): a rank's term is its
slice's sum over that count and its share of the batch, so that the ranks'
terms weighted by their shares sum to the whole batch's.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import layers, losses
from sslrec_tpu_torch.models.base import apply_linear, linear_layer
from sslrec_tpu_torch.models.sequential.base_seq import SequentialModel
from sslrec_tpu_torch.ops.topk import topk_indices
from sslrec_tpu_torch.parallel import dist_train


class BERT4Rec(SequentialModel):
    batch_fields = ("user", "seq_last", "pos")

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.mask_prob = float(cfg.model.mask_prob)
        self.mask_token = self.item_num + 1
        self.masked_budget = int(cfg.model.get("masked_budget", 0))
        self.emb, self.layers = layers.tower_params(
            self.item_num + 2, self.emb_size, self.max_len, self.n_layers, self.device)
        self.out_fc = linear_layer(self.emb_size, self.item_num + 1, self.device)

    def init_params(self, gen: torch.Generator) -> None:
        layers.init_tower(gen, self.emb, self.layers)
        layers.init_linear_normal(gen, self.out_fc)

    def _tower(self, seqs, drop=None):
        return layers.apply_transformer_tower(self.emb, self.layers, seqs, self.n_heads, drop)

    def mask_train_seq(self, seqs, u, rand_items):
        """80/10/10 masking from the uniforms ``u`` and the random items."""
        selected = (u < self.mask_prob) & (seqs != 0)
        sub = u / self.mask_prob
        replacement = torch.where(sub < 0.8, self.mask_token,
                                  torch.where(sub < 0.9, rand_items.to(seqs.dtype), seqs))
        return torch.where(selected, replacement, seqs), torch.where(selected, seqs, 0)

    def loss(self, batch: dict, gen, draws: dict | None = None):
        seqs = batch["seq_last"]
        dr = self.step_draws(gen, draws, batch)
        u = dr.uniform("mask_u", seqs.shape, batch=True)
        rand_items = dr.randint("rand_items", 1, self.item_num + 1, seqs.shape, batch=True)
        masked, labels = self.mask_train_seq(seqs, u, rand_items)
        h = self._tower(masked, dr.dropout("drop", self.dropout_rate))
        if self.masked_budget > 0:
            k = min(self.masked_budget, labels.shape[1])
            idx = topk_indices((labels != 0).float(), k)
            labels = torch.gather(labels, 1, idx)
            h = torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))
        logits = apply_linear(self.out_fc, h).reshape(-1, self.item_num + 1)
        if self.mesh is None:
            loss = losses.cross_entropy_ignore(logits, labels.reshape(-1), 0)
        else:
            count = dist_train.reduce_terms({"count": (labels != 0).sum()}, self.mesh,
                                            1.0)["count"].clamp(min=1.0)
            loss = (losses.cross_entropy_ignore(logits, labels.reshape(-1), 0, total=True)
                    / (count * batch["share"]))
        return loss, {"rec_loss": loss}

    def encode_for_predict(self, seqs, ctx):
        seqs = torch.cat([seqs[:, 1:], torch.full_like(seqs[:, :1], self.mask_token)], 1)
        return self._tower(seqs)[:, -1, :]

    def item_logits_params(self, ctx):
        return self.out_fc["w"].T, self.out_fc["b"]
