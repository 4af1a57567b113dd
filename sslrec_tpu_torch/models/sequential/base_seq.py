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

On a device mesh (``train.mesh``) every parameter is replicated, as the JAX
package's generic rule leaves it (no table's leading dimension counts users
or items: the vocabularies are ``item_num + 1`` and ``item_num + 2``), and
a step's batch splits over ``data``.  The JAX package runs one program on
the whole batch, so every draw is the whole batch's: a rank makes each draw
whose leading dimension is the batch at the whole batch's rows, in the
single run's order, and keeps its slice (:meth:`StepDraws.on_rows`; given
draws are sliced the same way), and a term that crosses the batch gathers
the batch's rows over ``data`` (:meth:`SequentialModel.whole`) and is
computed whole, alike on every ``data`` rank.  Draws not sized by the batch
(MAERec's negatives, DCRec_seq's GCN keeps) are made alike on every rank
from the same epoch generator.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import layers
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config


class StepDraws:
    """One step's draws by name: made from ``gen`` where ``given`` is None,
    else ``given[name]`` (a tensor, or for a dropout the list of its keep
    masks in the order the tower takes them).

    A draw marked ``batch`` has the batch as its leading dimension; after
    :meth:`on_rows` (a mesh rank's ``data`` slice of a batch of ``n``) it is
    made for all ``n`` rows, in the single run's order, and sliced, and a
    given one is sliced the same way.  Every tower dropout is such a draw."""

    def __init__(self, gen: torch.Generator | None, given: dict | None = None,
                 device=None):
        self.gen, self.given = gen, given
        self.device = device if device is not None else gen.device
        self.rows = None

    def on_rows(self, n: int, sl: slice) -> "StepDraws":
        """Draw the batch-sized draws for ``n`` rows and keep ``sl`` of them."""
        self.rows = (int(n), sl)
        return self

    def _whole(self, shape, batch: bool) -> tuple:
        shape = tuple(shape)
        return (self.rows[0], *shape[1:]) if batch and self.rows else shape

    def _slice(self, v, batch: bool):
        return v[self.rows[1]] if batch and self.rows and torch.is_tensor(v) else v

    def own_rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a given batch-sized draw ``v``, on the device."""
        return self._slice(v.to(self.device), True)

    def draw(self, name: str, make, batch: bool = False):
        """``make()``, or the given draw ``name``; a ``batch`` draw sliced to
        this rank's rows."""
        if self.given is not None:
            v = self.given[name]
            v = v.to(self.device) if torch.is_tensor(v) else v
        else:
            v = make()
        return self._slice(v, batch)

    def _rand(self, shape, batch: bool) -> torch.Tensor:
        return torch.rand(self._whole(shape, batch), generator=self.gen,
                          device=self.gen.device)

    def uniform(self, name: str, shape, low: float = 0.0, batch: bool = False) -> torch.Tensor:
        """Uniform in ``[low, 1)``."""
        return self.draw(name, lambda: low + (1.0 - low) * self._rand(shape, batch), batch)

    def normal(self, name: str, shape, batch: bool = False) -> torch.Tensor:
        return self.draw(name, lambda: torch.randn(self._whole(shape, batch), generator=self.gen,
                                                   device=self.gen.device), batch)

    def keep(self, name: str, p: float, shape, batch: bool = False) -> torch.Tensor:
        """Bernoulli(p) as ``U < p``."""
        return self.draw(name, lambda: self._rand(shape, batch) < p, batch)

    def permutation(self, name: str, n: int) -> torch.Tensor:
        return self.draw(name, lambda: torch.randperm(n, generator=self.gen,
                                                       device=self.gen.device))

    def randint(self, name: str, low: int, high, shape, batch: bool = False) -> torch.Tensor:
        """Uniform integers in ``[low, high)``; ``high`` an int or a tensor of
        per-entry bounds (each at least ``low + 1``; for a ``batch`` draw the
        slice's own, which scale the uniforms after they are sliced)."""
        if not torch.is_tensor(high):
            return self.draw(name, lambda: torch.randint(
                low, high, self._whole(shape, batch), generator=self.gen,
                device=self.gen.device), batch)
        if self.given is not None:
            return self.draw(name, None, batch)
        u = self._slice(self._rand(shape, batch), batch)
        span = (high - low).to(u.device)
        return low + torch.minimum((u * span).long(), span - 1)

    def dropout(self, name: str, rate: float):
        """A tower's dropout callable (``None`` at rate 0); its keep masks
        are batch-sized draws."""
        if rate <= 0.0:
            return None
        sl = self.rows[1] if self.rows else slice(None)
        if self.given is not None:
            return layers.mask_dropout([m[sl] for m in self.given[name]], rate)
        return layers.gen_dropout(self.gen, rate, self.rows)


class SequentialModel(RecModel):
    step_generator = True
    mesh_todo = None
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
        self.mesh = mesh_from_config(cfg, self.device)

    def draws(self, gen, given: dict | None = None) -> StepDraws:
        return StepDraws(gen, given, self.device)

    def step_draws(self, gen, given: dict | None, batch: dict) -> StepDraws:
        """:meth:`draws` for ``batch``: on a mesh, its batch-sized draws made
        for the whole batch and sliced to this rank's rows."""
        dr = self.draws(gen, given)
        if self.mesh is not None:
            n = int(batch["n_whole"])
            dr.on_rows(n, dist_train.batch_slice(n, self.mesh))
        return dr

    def whole(self, x: torch.Tensor, batch: dict) -> torch.Tensor:
        """The whole batch's rows of this rank's slice ``x``, gathered over
        ``data`` with autograd (``x`` itself off a mesh)."""
        if self.mesh is None:
            return x
        return dist_train.gather_batch(x, int(batch["n_whole"]), self.mesh)

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
