"""Model protocol (port of ``sslrec_tpu/models/base.py``).

The JAX package keeps parameters in an explicit pytree; here a model is an
``nn.Module`` that owns its parameters, and the protocol's methods read them
from ``self``.

Required methods
----------------
``init_params(gen)``                 (re)draw every parameter from a ``torch.Generator``
``loss(batch, key) -> (loss, {name: scalar})``
``generate() -> (user_emb, item_emb)``   eval-mode embeddings

Optional
--------
``rating(user_emb, item_emb) -> scores``  (default: dot product)
``step_generator = True``            ``loss`` gets the epoch's device generator, not a PRF key
``epoch_state(gen, epoch) -> aux``   once per epoch under ``no_grad``, with the epoch's device
                                     generator; reaches ``loss`` as ``batch["aux"]``
"""

from __future__ import annotations

import torch
from torch import nn


class RecModel(nn.Module):
    step_generator = False

    def __init__(self, cfg, data):
        super().__init__()
        self.cfg = cfg
        self.user_num = data.user_num
        self.item_num = data.item_num
        self.embedding_size = int(cfg.model.embedding_size)

    # -- protocol -----------------------------------------------------------
    def init_params(self, gen: torch.Generator) -> None:
        raise NotImplementedError

    def loss(self, batch: dict, key: torch.Tensor):
        raise NotImplementedError

    def generate(self):
        raise NotImplementedError

    def rating(self, user_emb: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
        return user_emb @ item_emb.T
