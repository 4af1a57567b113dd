"""Losses (port of ``sslrec_tpu/models/losses.py``: the pairwise pieces)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bpr_loss(anc_embeds, pos_embeds, neg_embeds):
    """Softplus-form BPR, sum-reduced; callers divide by the batch size."""
    pos_preds = (anc_embeds * pos_embeds).sum(-1)
    neg_preds = (anc_embeds * neg_embeds).sum(-1)
    return F.softplus(neg_preds - pos_preds).sum()


def reg_params(params: dict[str, torch.Tensor]):
    """L2² over every parameter, summed in name order (the JAX package's
    pytree-leaf order)."""
    return sum((params[k] ** 2).sum() for k in sorted(params))
