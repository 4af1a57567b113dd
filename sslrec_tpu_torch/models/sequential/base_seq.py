"""Shared machinery of the sequential (transformer) models (port of
``sslrec_tpu/models/sequential/base_seq.py``).

Evaluation: :meth:`SequentialModel.generate` runs one forward over the test
sequences in chunks of 512, writes each hidden state into its user's row of
a ``[user_num, d + 1]`` table, and appends the output bias to the item side
as the last coordinate (1 on the user side), so the evaluator's plain dot
product gives the output projection's logits.  What the forward needs of
the item graph (DCRec_seq's GCN tables, MAERec's encoded items) is computed
once a ``generate()`` by :meth:`predict_context`, not once a chunk.

Draws: every sequential model sets ``step_generator``, and a step takes its
random draws through :class:`StepDraws`, from the epoch's device generator,
or given by name (a test hands over the JAX package's draws).
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import layers
from sslrec_tpu_torch.models.base import RecModel


class StepDraws:
    """One step's draws by name: made from ``gen`` where ``given`` is None,
    else ``given[name]`` (a tensor, or for a dropout the list of its keep
    masks in the order the tower takes them)."""

    def __init__(self, gen: torch.Generator | None, given: dict | None = None,
                 device=None):
        self.gen, self.given = gen, given
        self.device = device if device is not None else gen.device

    def draw(self, name: str, make):
        """``make()``, or the given draw ``name``."""
        if self.given is not None:
            v = self.given[name]
            return v.to(self.device) if torch.is_tensor(v) else v
        return make()

    def uniform(self, name: str, shape, low: float = 0.0) -> torch.Tensor:
        """Uniform in ``[low, 1)``."""
        return self.draw(name, lambda: low + (1.0 - low) * torch.rand(
            shape, generator=self.gen, device=self.gen.device))

    def normal(self, name: str, shape) -> torch.Tensor:
        return self.draw(name, lambda: torch.randn(shape, generator=self.gen,
                                                    device=self.gen.device))

    def keep(self, name: str, p: float, shape) -> torch.Tensor:
        """Bernoulli(p) as ``U < p``."""
        return self.draw(name, lambda: torch.rand(shape, generator=self.gen,
                                                   device=self.gen.device) < p)

    def permutation(self, name: str, n: int) -> torch.Tensor:
        return self.draw(name, lambda: torch.randperm(n, generator=self.gen,
                                                       device=self.gen.device))

    def randint(self, name: str, low: int, high, shape) -> torch.Tensor:
        """Uniform integers in ``[low, high)``; ``high`` an int or a tensor of
        per-entry bounds (each at least ``low + 1``)."""
        def make():
            if not torch.is_tensor(high):
                return torch.randint(low, high, shape, generator=self.gen,
                                     device=self.gen.device)
            u = torch.rand(shape, generator=self.gen, device=self.gen.device)
            span = (high - low).to(u.device)
            return low + torch.minimum((u * span).long(), span - 1)

        return self.draw(name, make)

    def dropout(self, name: str, rate: float):
        """A tower's dropout callable (``None`` at rate 0)."""
        if rate <= 0.0:
            return None
        if self.given is not None:
            return layers.mask_dropout(self.given[name], rate)
        return layers.gen_dropout(self.gen, rate)


class SequentialModel(RecModel):
    step_generator = True
    batch_fields = ("user", "seq", "pos")     # no negatives unless a model asks

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.max_len = int(m.max_seq_len)
        self.dropout_rate = float(m.dropout_rate)
        self.n_layers = int(m.n_layers)
        self.n_heads = int(m.n_heads)
        self.emb_size = int(m.embedding_size)
        self.test_seqs = data.extras["test_seqs"]
        self.test_uids = data.extras["test_uids"]
        self.device = data.device

    def draws(self, gen, given: dict | None = None) -> StepDraws:
        return StepDraws(gen, given, self.device)

    # -- subclass API ----------------------------------------------------------
    def predict_context(self):
        """What every chunk's forward shares (default: nothing)."""
        return None

    def encode_for_predict(self, seqs: torch.Tensor, ctx) -> torch.Tensor:
        """[B, L] → [B, d], the final position's representation in eval mode."""
        raise NotImplementedError

    def item_logits_params(self, ctx):
        """``(W [item_num + 1, d], b [item_num + 1])`` of the output projection."""
        raise NotImplementedError

    # -- the evaluator's contract -------------------------------------------------
    def generate(self, chunk: int = 512):
        ctx = self.predict_context()
        n = self.test_seqs.shape[0]
        h = torch.cat([self.encode_for_predict(self.test_seqs[i:i + chunk], ctx)
                       for i in range(0, n, chunk)])
        table = h.new_zeros(self.user_num, h.shape[-1] + 1)
        table[self.test_uids.long()] = torch.cat([h, h.new_ones(n, 1)], dim=1)
        w, b = self.item_logits_params(ctx)
        return table, torch.cat([w, b[:, None]], dim=1)
