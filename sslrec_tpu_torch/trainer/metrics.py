"""Full-sort top-k evaluation on the run's device (port of
``sslrec_tpu/trainer/metrics.py``).

- recall@k  = Σ_u |topk(u)[:k] ∩ gt(u)| / |gt(u)|
- ndcg@k    = Σ_u dcg/idcg with idcg over min(k,|gt|) slots
- precision = Σ_u |hits| / k
- mrr       = Σ_u Σ_j hit_j / (j+1)

all divided by the number of test users.  Per user batch: score every item,
mask train history at −1e8, take the top-k, sum the metrics; the
``[B, n_items]`` score matrix never leaves the device.  The JAX package packs
the history into a bitmask because a TPU scatter is serial; here the history
is one masked write per batch.

Under a device mesh (``mesh``) the batch size is rounded up to a multiple of
the ``data`` axis, each rank scores its slice of every batch on the whole
tables that ``generate()`` gives, and the metric sums are added over the
``data`` group at the end, as the JAX evaluator splits its batches over
``data`` and all-reduces the sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from sslrec_tpu_torch.data.base import EvalData, pad_to_batches
from sslrec_tpu_torch.ops.topk import masked_topk_indices, topk_indices

_METRICS = ("recall", "ndcg", "precision", "mrr")


def _batch_metric_sums(topk: torch.Tensor, gt_cols: torch.Tensor,
                       gt_mask: torch.Tensor, gt_len: torch.Tensor,
                       valid: torch.Tensor, ks: tuple[int, ...]) -> torch.Tensor:
    """Per-batch summed metrics ``[len(_METRICS), len(ks)]``; ``topk [B,Kmax]``,
    padded gt ``[B,W]``, ``valid [B]`` float 0/1."""
    hits = (topk[:, :, None] == gt_cols[:, None, :]) & gt_mask[:, None, :]
    r = hits.any(dim=-1).to(torch.float32) * valid[:, None]      # [B, Kmax]
    gt_len_f = gt_len.to(torch.float32).clamp(min=1.0)
    kmax = topk.shape[1]
    ranks = torch.arange(1, kmax + 1, dtype=torch.float32, device=topk.device)
    inv_log2 = 1.0 / torch.log2(ranks + 1.0)

    out = {m: [] for m in _METRICS}
    for k in ks:
        rk = r[:, :k]
        right = rk.sum(dim=1)
        out["recall"].append((right / gt_len_f).sum())
        out["precision"].append(right.sum() / k)
        out["mrr"].append((rk / ranks[None, :k]).sum())
        dcg = (rk * inv_log2[None, :k]).sum(dim=1)
        # idcg = Σ_{j<min(k,|gt|)} 1/log2(j+2)
        slot = torch.arange(k, device=topk.device)[None, :]
        idcg = torch.where(slot < gt_len.clamp(max=k)[:, None],
                           inv_log2[None, :k], 0.0).sum(dim=1)
        idcg = torch.where(idcg == 0.0, 1.0, idcg)
        out["ndcg"].append((valid * dcg / idcg).sum())
    return torch.stack([torch.stack(out[m]) for m in _METRICS])


class Evaluator:
    """Full-sort evaluator for one split; ``evaluator(model)`` scores the
    model's current parameters."""

    def __init__(self, eval_data: EvalData, cfg, mesh=None):
        self.eval_data = eval_data
        self.metrics = tuple(cfg.test.metrics)
        self.ks = tuple(int(k) for k in cfg.test.k)
        self.mesh = mesh
        device = eval_data.test_users.device
        users = eval_data.test_users.cpu().numpy()
        n = users.shape[0]
        batch_size = int(cfg.test.batch_size)
        if mesh is not None:
            batch_size = -(-batch_size // mesh.n_data) * mesh.n_data
        batches = pad_to_batches(n, batch_size)                  # indices into users
        # wrap-padded tail entries must not contribute: valid only for first n slots
        valid = np.arange(batches.size).reshape(batches.shape) < n
        if mesh is not None:
            part = batch_size // mesh.n_data
            cols = slice(mesh.data_index * part, (mesh.data_index + 1) * part)
            batches, valid = batches[:, cols], valid[:, cols]
        self._user_batches = torch.from_numpy(users[batches]).to(device)
        self._valid = torch.from_numpy(valid.astype(np.float32)).to(device)

    @torch.no_grad()
    def __call__(self, model) -> dict[str, np.ndarray]:
        gt, hist = self.eval_data.ground_truth, self.eval_data.history
        user_emb, item_emb = model.generate()
        kmax = max(self.ks)
        total = None
        for users, valid in zip(self._user_batches, self._valid):
            users = users.long()
            scores = model.rating(user_emb[users], item_emb)
            if hist is not None:
                topk = masked_topk_indices(scores, hist.cols[users],
                                           hist.mask[users], kmax)
            else:
                topk = topk_indices(scores, kmax)
            sums = _batch_metric_sums(topk, gt.cols[users], gt.mask[users],
                                      gt.lengths[users], valid, self.ks)
            total = sums if total is None else total + sums
        if self.mesh is not None and self.mesh.data_group is not None:
            dist.all_reduce(total, group=self.mesh.data_group)
        total = total.cpu().numpy()
        denom = float(self.eval_data.n_test_users)
        return {m: total[_METRICS.index(m)] / denom for m in self.metrics}
