"""ICLRec: intent-prototype contrastive learning (port of
``sslrec_tpu/models/sequential/iclrec.py``).

Each epoch clusters the mean-pooled eval-mode encodings of every train row
with :func:`~sslrec_tpu_torch.models.augment.kmeans` (20 Lloyd iterations,
``num_intent_clusters`` clusters) and keeps the raw centroids and their
L2-normalised copies.  A step: binary cross entropy of the last position
against the target and a sampled negative, an in-batch NCE between two
augmented views (eta 0.2, gamma 0.7, beta 0.2), and a prototype NCE of each
view against the normalised centroid nearest (by L2 to the raw centroids)
to the row's clean mean encoding.

Draws: ``drop``, ``drop1``, ``drop2`` and the augmentation's; the epoch's
k-means pick comes from the epoch generator, or ``epoch_state``'s ``pick``.

On a mesh the clusters are made alike on every rank (the same rows, the
same generator); both NCE terms take the whole batch's rows as negatives,
so both views' encodings (with autograd) and the intents (without) are
gathered over ``data`` and the terms computed whole on every rank; the
binary cross entropy is the slice's mean.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import augment, layers, seq_augment
from sslrec_tpu_torch.models.sequential.cl4srec import SeqTowerModel

ENCODE_CHUNK = 512


def nce_loss(z1: torch.Tensor, z2: torch.Tensor, temp) -> torch.Tensor:
    """2N-way cross entropy over the [sim12 | sim11] and [sim22 | sim12ᵀ]
    logit blocks, self-similarities at −inf."""
    n = z1.shape[0]
    sim11, sim22, sim12 = z1 @ z1.T / temp, z2 @ z2.T / temp, z1 @ z2.T / temp
    eye = torch.eye(n, dtype=torch.bool, device=z1.device)
    sim11 = torch.where(eye, -torch.inf, sim11)
    sim22 = torch.where(eye, -torch.inf, sim22)
    logits = torch.cat([torch.cat([sim12, sim11], -1), torch.cat([sim22, sim12.T], -1)], 0)
    logp = torch.log_softmax(logits, -1)
    return -torch.diagonal(logp).mean()


class ICLRec(SeqTowerModel):
    batch_fields = ("user", "seq", "pos", "neg")

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.cl_weight = float(m.cl_weight)
        self.intent_cl_weight = float(m.intent_cl_weight)
        self.tau = float(m.tau)
        self.num_clusters = int(m.num_intent_clusters)
        self.train_seqs = data.extras["train_arrays"]["seq"]

    @torch.no_grad()
    def epoch_state(self, gen, epoch: int, pick: torch.Tensor | None = None) -> dict:
        """The centroids of the train rows' mean encodings, raw and normalised."""
        n = self.train_seqs.shape[0]
        enc = torch.cat([self._encode(self.train_seqs[i:i + ENCODE_CHUNK], mean=True)
                         for i in range(0, n, ENCODE_CHUNK)])
        cents, _, _ = augment.kmeans(enc, self.num_clusters, iters=20, gen=gen, pick=pick)
        cents_n = cents / torch.sqrt((cents * cents).sum(-1, keepdim=True) + 1e-12)
        return {"centroids": cents_n, "centroids_raw": cents}

    def loss(self, batch: dict, gen, draws: dict | None = None):
        seqs = batch["seq"]
        dr = self.step_draws(gen, draws, batch)
        h = self._encode(seqs, dr.dropout("drop", self.dropout_rate))
        tok = self.emb["token"]
        pos_logits = (layers.take_rows(tok, batch["pos"]) * h).sum(-1)
        neg_logits = (layers.take_rows(tok, batch["neg"]) * h).sum(-1)
        rec = (-torch.log(torch.sigmoid(pos_logits) + 1e-24)
               - torch.log(1 - torch.sigmoid(neg_logits) + 1e-24)).sum() / seqs.shape[0]

        op_u, d1, d2 = seq_augment.two_view_draws(dr, seqs, 0.2, 0.2)
        v1, v2 = seq_augment.cl4srec_two_views(seqs, op_u, d1, d2, self.mask_token,
                                               eta=0.2, gamma=0.7, beta=0.2)
        h1 = self._encode(v1, dr.dropout("drop1", self.dropout_rate), mean=True)
        h2 = self._encode(v2, dr.dropout("drop2", self.dropout_rate), mean=True)
        h1, h2 = self.whole(h1, batch), self.whole(h2, batch)
        cl = self.cl_weight * nce_loss(h1, h2, self.tau)

        cents, raw = batch["aux"]["centroids"], batch["aux"]["centroids_raw"]
        with torch.no_grad():
            h_mean = self._encode(seqs, mean=True)
            d2_ = ((h_mean ** 2).sum(1, keepdim=True) - 2 * h_mean @ raw.T
                   + (raw ** 2).sum(1)[None, :])
            intent = self.whole(cents[torch.argmin(d2_, dim=1)], batch)
        intent_cl = self.intent_cl_weight * 0.5 * (nce_loss(h1, intent, self.tau)
                                                   + nce_loss(h2, intent, self.tau))
        return rec + cl + intent_cl, {"rec_loss": rec, "cl_loss": cl,
                                      "intent_cl_loss": intent_cl}
