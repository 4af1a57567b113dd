"""Negative sampling (port of ``sslrec_tpu/data/sampling.py``).

One negative per (user, pos) interaction per epoch: uniform draws rejected
against the train edge set, with a fixed number of redraw rounds drawn and
tested at once.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.ops.sparse import EdgeSet


def pick_negatives(cands: torch.Tensor, users: torch.Tensor,
                   edge_set: EdgeSet) -> torch.Tensor:
    """From ``cands [rounds, n]``, each column's first candidate that is not a
    train edge of its user; the last candidate where every round hits one."""
    ok = ~edge_set.contains(users.expand_as(cands), cands)
    first = torch.argmax(ok.to(torch.uint8), dim=0)    # first accepting round
    negs = torch.gather(cands, 0, first[None, :])[0]
    return torch.where(ok.any(dim=0), negs, cands[-1])


def sample_negatives(gen: torch.Generator, users: torch.Tensor,
                     edge_set: EdgeSet, n_items: int, rounds: int = 6,
                     low: int = 0) -> torch.Tensor:
    """One negative item per interaction: uniform over [low, n_items),
    rejecting train edges.  Draws on ``gen``'s device, tests on ``users``'.

    ``users``: int32 [n]; returns int32 [n].
    """
    n = users.shape[0]
    cands = torch.randint(low, n_items, (rounds, n), generator=gen,
                          device=gen.device, dtype=torch.int32)
    return pick_negatives(cands.to(users.device), users, edge_set)


def sample_from_rows(indptr: torch.Tensor, indices: torch.Tensor, rows: torch.Tensor,
                     u: torch.Tensor):
    """Entries of CSR rows ``rows`` drawn with replacement at the uniform
    offsets ``u`` [n, S] (``floor(u · max(len, 1))``), and each row's length;
    an empty row's draws are arbitrary, for the caller to replace."""
    start = indptr[rows]
    deg = indptr[rows + 1] - start
    off = (u * deg.clamp(min=1)[:, None]).long()
    return indices[(start[:, None] + off).clamp(0, indices.shape[0] - 1)], deg
