"""Sequence augmentations of CL4SRec and ICLRec: crop, mask, reorder (port
of ``sslrec_tpu/models/seq_augment.py``).

Rows are left-padded [B, L]; positions are named by their end-offset ``j``
(0 is the most recent item).  Per row:

- crop(eta): keep ``floor(len·eta)`` items, a window starting ``begin``
  items before the end's window, right-aligned;
- mask(gamma): the ``floor(len·gamma)`` live positions with the smallest
  uniforms become the mask token;
- reorder(beta): the window of ``floor(len·beta)`` end-offsets from
  ``begin`` is permuted by ranking its uniforms.

Each op takes its draws as arguments; :func:`view_draws` makes them from a
model's step draws (a test gives the JAX package's).  :func:`cl4srec_two_views`
applies two of the three ops, distinct and chosen per row, one to each view;
rows of length ≤ 1 pass unchanged.
"""

from __future__ import annotations

import torch


def lengths(seqs: torch.Tensor) -> torch.Tensor:
    return (seqs > 0).sum(1)


def _end_offsets(l: int, device) -> torch.Tensor:
    return torch.arange(l - 1, -1, -1, device=device)


def crop_len(lens: torch.Tensor, eta: float) -> torch.Tensor:
    return (lens.float() * eta).long().clamp(min=0)


def crop(seqs: torch.Tensor, begin: torch.Tensor, eta: float = 0.6) -> torch.Tensor:
    b, l = seqs.shape
    num_left = crop_len(lengths(seqs), eta)
    keep = _end_offsets(l, seqs.device)[None, :] < num_left[:, None]
    src = (torch.arange(l, device=seqs.device)[None, :] - begin[:, None].long()).clamp(0, l - 1)
    return torch.where(keep, torch.gather(seqs, 1, src), 0)


def mask(seqs: torch.Tensor, u: torch.Tensor, mask_token: int,
         gamma: float = 0.3) -> torch.Tensor:
    b, l = seqs.shape
    lens = lengths(seqs)
    num_mask = (lens.float() * gamma).long()
    valid = _end_offsets(l, seqs.device)[None, :] < lens[:, None]
    u = torch.where(valid, u, 2.0)
    sorted_u = torch.sort(u, dim=1).values
    padded = torch.cat([sorted_u, sorted_u.new_full((b, 1), 3.0)], 1)
    kth = torch.gather(padded, 1, (num_mask[:, None] - 1).clamp(0, l))
    sel = valid & (u <= kth) & (num_mask[:, None] > 0)
    return torch.where(sel, mask_token, seqs)


def reorder_len(lens: torch.Tensor, beta: float) -> torch.Tensor:
    return (lens.float() * beta).long()


def reorder(seqs: torch.Tensor, begin: torch.Tensor, u: torch.Tensor,
            beta: float = 0.6) -> torch.Tensor:
    b, l = seqs.shape
    num_re = reorder_len(lengths(seqs), beta)
    j = _end_offsets(l, seqs.device)[None, :]
    begin = begin[:, None].long()
    in_win = (j >= begin) & (j < begin + num_re[:, None])
    u = torch.where(in_win, u, torch.inf)
    order = torch.sort(u, dim=1, stable=True).indices   # order[:, s]: the position ranked s
    slot = torch.cumsum(in_win.long(), 1) - 1
    src = torch.gather(order, 1, slot.clamp(0, l - 1))
    return torch.where(in_win, torch.gather(seqs, 1, src), seqs)


def view_draws(dr, seqs: torch.Tensor, eta: float, beta: float) -> dict:
    """One view's draws for all three ops from a :class:`StepDraws` ``dr``:
    ``crop_begin`` [B] in [0, len − crop_len], ``mask_u`` [B, L],
    ``reorder_begin`` [B] in [0, len − reorder_len], ``reorder_u`` [B, L];
    each a batch-sized draw (on a mesh, the whole batch's, sliced)."""
    b, l = seqs.shape
    lens = lengths(seqs)
    return {"crop_begin": dr.randint("", 0, (lens - crop_len(lens, eta) + 1).clamp(min=1),
                                     (b,), batch=True),
            "mask_u": dr.uniform("", (b, l), batch=True),
            "reorder_begin": dr.randint("", 0, (lens - reorder_len(lens, beta) + 1).clamp(min=1),
                                        (b,), batch=True),
            "reorder_u": dr.uniform("", (b, l), batch=True)}


def apply_view(seqs: torch.Tensor, op: torch.Tensor, draws: dict, mask_token: int,
               eta: float, gamma: float, beta: float) -> torch.Tensor:
    """Each row's op ``op`` [B] (0 crop, 1 mask, 2 reorder) under ``draws``."""
    c = crop(seqs, draws["crop_begin"], eta)
    m = mask(seqs, draws["mask_u"], mask_token, gamma)
    r = reorder(seqs, draws["reorder_begin"], draws["reorder_u"], beta)
    stacked = torch.stack([c, m, r])
    return torch.gather(stacked, 0, op.long()[None, :, None].expand(1, *seqs.shape))[0]


def cl4srec_two_views(seqs: torch.Tensor, op_u: torch.Tensor, draws1: dict, draws2: dict,
                      mask_token: int, eta: float = 0.6, gamma: float = 0.3,
                      beta: float = 0.6):
    """Two views: per row the ops ranked first and second by ``op_u`` [B, 3]
    uniforms, under ``draws1`` and ``draws2``."""
    choice = torch.sort(op_u, dim=1, stable=True).indices
    v1 = apply_view(seqs, choice[:, 0], draws1, mask_token, eta, gamma, beta)
    v2 = apply_view(seqs, choice[:, 1], draws2, mask_token, eta, gamma, beta)
    passthrough = (lengths(seqs) <= 1)[:, None]
    return torch.where(passthrough, seqs, v1), torch.where(passthrough, seqs, v2)


def two_view_draws(dr, seqs: torch.Tensor, eta: float, beta: float) -> tuple:
    """``(op_u, draws1, draws2)`` from a :class:`StepDraws` (given by name as
    ``aug_op_u``, ``aug_view1``, ``aug_view2``), all batch-sized draws."""
    if dr.given is not None:
        g, rows = dr.given, dr.own_rows
        return (rows(g["aug_op_u"]), {k: rows(v) for k, v in g["aug_view1"].items()},
                {k: rows(v) for k, v in g["aug_view2"].items()})
    op_u = dr.uniform("", (seqs.shape[0], 3), batch=True)
    return op_u, view_draws(dr, seqs, eta, beta), view_draws(dr, seqs, eta, beta)
