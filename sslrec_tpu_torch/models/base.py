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
``epoch_state(gen, epoch) -> aux``   once per epoch, with the epoch's device generator; reaches
                                     ``loss`` as ``batch["aux"]`` (DiffKG trains its denoiser in it)
``train_step(batch, key) -> aux``    a model-managed step (AdaGCL's three updates): the model
                                     owns its optimizers, and the trainer calls this in place of
                                     its own Adam step and builds no optimizer; such a model also
                                     has ``optimizers() -> {name: optimizer}``, whose state
                                     checkpoints save and restore; on a mesh it gets its
                                     ``data`` slice (``share``, ``n_whole``) and does the
                                     mesh's gradient sums itself (CML, KMCLR, AdaGCL)
``extra_negatives(gen, arrays)``     full-epoch auxiliary streams ({name: [n] tensor}) drawn from
                                     the epoch's generator, sliced per batch (DSL's social negatives)
``grad_clip``                        a float: the trainer clips the gradients' global norm to it
                                     before weight decay and Adam
``batch_fields``                     the batch's index fields; without ``"neg"`` the trainer
                                     draws no negatives
``epoch_schedule(n_train, bsz)``     ``(steps, batch size)`` of an epoch, in place of one pass over
                                     the interactions (MBGMN)
``train_trans`` and ``kg_loss(h, r, t, neg)``  the trainer's TransE sub-loop after each epoch
``extra_state()`` / ``load_extra_state(state)``  model state that a train state saves beside the
                                     parameters and optimizers (MAERec's loss history)
``hparams() -> {name: float}``      the scalars its ``loss`` reads from ``batch["hp"]`` where
                                     given: the tuner's ``tune.parallel`` runs a grid of them as lanes

The device mesh (:mod:`~sslrec_tpu_torch.parallel.mesh`): ``mesh_todo``
says that a model has no mesh branch, and a mesh of more than one device
refuses the model while it is set; it is set by default, so that no model
runs replicated in silence, and all 31 models clear it.  A model
that trains on a mesh lists in ``row_shards`` (``{name: whole rows}``) the
tables of which each rank holds a row shard (the JAX package's rule: a
table whose leading dimension counts users, items, nodes or entities), so
that the trainer can gather and split their snapshots and checkpoints;
every other parameter is replicated over the ``model`` axis, and the
trainer sums its gradient over that axis.

Every batch also carries ``batch["step"]``, the step's index in the epoch
(an int), and the trainer sets ``model._n_batches_hint`` to the number of
steps an epoch before the first ``epoch_state``, so that a model can size
its per-epoch state by it (AutoCF's and GFormer's view banks).
"""

from __future__ import annotations

import torch
from torch import nn


MESH_NONE = "the model has no mesh branch: its batch and tables would not split"


class RecModel(nn.Module):
    step_generator = False
    batch_fields = ("user", "pos", "neg")
    mesh_todo: str | None = MESH_NONE
    row_shards: dict = {}

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


def linear_layer(in_dim: int, out_dim: int, device) -> nn.ParameterDict:
    """A dense layer in the JAX package's layout, ``{"w": [in, out], "b":
    [out]}``, uninitialised (fill it from ``initializers.linear_params``)."""
    return nn.ParameterDict({"w": nn.Parameter(torch.empty(in_dim, out_dim, device=device)),
                             "b": nn.Parameter(torch.empty(out_dim, device=device))})


def apply_linear(p: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]
