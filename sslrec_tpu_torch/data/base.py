"""Data layer base types (port of ``sslrec_tpu/data/base.py``).

A handler is a function ``load(cfg, device) -> DataBundle``: an immutable
bundle of tensors on the run's device (graphs, interaction lists, padded eval
structures) plus dataset statistics.  Batch iteration is index-based and
fixed-shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sslrec_tpu_torch.ops.sparse import EdgeSet, PaddedRows


@dataclasses.dataclass(frozen=True)
class EvalData:
    """Fixed-shape full-sort evaluation data for one split.

    ``test_users`` are users with ≥1 positive in the split; ``ground_truth``
    their padded positive item lists; ``history`` the padded *train* positives
    used for score masking (−1e8), keyed by global user id.
    """

    test_users: torch.Tensor         # int32 [n_test_users]
    ground_truth: PaddedRows         # [n_users, w_gt] (indexed by global user id)
    history: PaddedRows | None       # [n_users, w_hist] or None (no masking)
    n_test_users: int


@dataclasses.dataclass(frozen=True)
class DataBundle:
    """Everything a model + trainer needs, loaded once."""

    user_num: int
    item_num: int
    # training interactions as parallel arrays (COO of the train matrix)
    train_users: torch.Tensor        # int32 [n_train]
    train_items: torch.Tensor        # int32 [n_train]
    train_edge_set: EdgeSet          # membership for negative-sampling rejection
    valid: EvalData | None
    test: EvalData
    # scenario-specific extras (graphs, raw matrices)
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_train(self) -> int:
        return int(self.train_users.shape[0])

    @property
    def device(self) -> torch.device:
        return self.train_users.device


def pad_to_batches(n: int, batch_size: int) -> np.ndarray:
    """Index array [n_batches, batch_size] covering 0..n-1, last batch wraps.

    Wrapping keeps every batch full-size, as in the JAX package; the few
    duplicated tail samples reweight the epoch negligibly.
    """
    n_batches = -(-n // batch_size)
    idx = np.arange(n_batches * batch_size) % n
    return idx.reshape(n_batches, batch_size).astype(np.int32)
