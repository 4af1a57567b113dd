"""Transformer building blocks of the sequential models (port of
``sslrec_tpu/models/layers.py``).

Parameters live in the JAX package's layout, so that its pytree maps onto
them name for name: a linear layer is ``{"w": [in, out], "b": [out]}``, a
layer norm ``{"scale", "bias"}``, the tower ``emb.token`` / ``emb.pos`` and
``layers.<i>.{attn.{q,k,v,out}, ff.{w1,w2}, ln1, ln2}``.  A model assigns
these containers to its own attributes, so their names sit at the top of its
``state_dict`` as in the JAX pytree.

Attention is written as the JAX package writes it (projections, scores
masked to −1e9 at padded keys, softmax, dropout of the probabilities), so
that a test can inject every dropout mask.  There is no kernel here: the
products are ``torch.matmul`` in float32 (TF32 stays off).

Dropout: each function takes ``drop``, a callable ``drop(x) -> x`` applied
at every dropout site in a fixed order (see :func:`apply_transformer_tower`),
or ``None`` in eval mode.  :func:`gen_dropout` draws each keep mask from a
generator; :func:`mask_dropout` takes given masks in that order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models.base import apply_linear, linear_layer
from sslrec_tpu_torch.utils.initializers import normal_init


# -- primitives ---------------------------------------------------------------

def layer_norm_params(d: int, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones(d, device=device)),
                             "bias": nn.Parameter(torch.zeros(d, device=device))})


def apply_layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


@torch.no_grad()
def init_linear_normal(gen: torch.Generator, lin: nn.ParameterDict, std: float = 0.02):
    """N(0, std²) weight and zero bias (the BERT4Rec ``_init_weights`` rule)."""
    lin["w"].copy_(normal_init(gen, tuple(lin["w"].shape), std))
    lin["b"].zero_()


def dropout_keep(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``keep ? x / (1 - rate) : 0``, JAX's inverted dropout."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


def gen_dropout(gen: torch.Generator, rate: float, rows: tuple | None = None):
    """Dropout at ``rate`` whose keep masks ``U < 1 - rate`` are drawn from
    ``gen`` at each call; ``None`` (no dropout) when ``rate`` is 0.  ``rows``
    ``(n, sl)``: ``x`` is the slice ``sl`` of a batch of ``n`` rows, and each
    mask is drawn for all ``n`` rows and sliced (a mesh rank's)."""
    if rate <= 0.0:
        return None

    def drop(x):
        shape = x.shape if rows is None else (rows[0], *x.shape[1:])
        u = torch.rand(shape, generator=gen, device=gen.device)
        if rows is not None:
            u = u[rows[1]]
        return dropout_keep(x, (u < 1.0 - rate).to(x.device), rate)

    return drop


def mask_dropout(masks, rate: float):
    """Dropout at ``rate`` whose keep masks are ``masks`` (bool tensors), taken
    in order, one a call."""
    it = iter(masks)

    def drop(x):
        return dropout_keep(x, next(it).to(x.device), rate)

    return drop


def _apply(drop, x):
    return x if drop is None else drop(x)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for any shape of ``ids``, through ``F.embedding``:
    autograd's backward of an index (``index_put_`` with accumulation)
    serialises repeated ids, and a batch of left-padded windows repeats the
    pad id at most of its positions and popular items at many; the
    embedding's backward sorts the ids and sums each run once."""
    return F.embedding(ids.long(), table)


# -- attention, the transformer layer, the tower --------------------------------

def attention_params(d: int, device) -> nn.ModuleDict:
    return nn.ModuleDict({k: linear_layer(d, d, device) for k in ("q", "k", "v", "out")})


def apply_attention(p, x: torch.Tensor, mask: torch.Tensor | None, n_heads: int,
                    drop=None) -> torch.Tensor:
    """Self-attention over ``x`` [B, L, d]; ``mask`` [B, L] key validity or
    [B, 1, L, L] (1 keeps); ``drop`` is applied to the probabilities."""
    b, l, d = x.shape
    dk = d // n_heads

    def split_heads(t):
        return t.reshape(b, l, n_heads, dk).transpose(1, 2)

    q = split_heads(apply_linear(p["q"], x))
    k = split_heads(apply_linear(p["k"], x))
    v = split_heads(apply_linear(p["v"], x))
    scores = q @ k.transpose(-1, -2) / math.sqrt(dk)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask == 0, -1e9, scores)
    attn = _apply(drop, torch.softmax(scores, dim=-1))
    out = (attn @ v).transpose(1, 2).reshape(b, l, d)
    return apply_linear(p["out"], out)


def transformer_layer_params(d: int, d_ff: int, device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "attn": attention_params(d, device),
        "ff": nn.ModuleDict({"w1": linear_layer(d, d_ff, device),
                             "w2": linear_layer(d_ff, d, device)}),
        "ln1": layer_norm_params(d, device), "ln2": layer_norm_params(d, device)})


def apply_transformer_layer(p, x: torch.Tensor, mask, n_heads: int, drop=None):
    """Pre-LN residual sublayers and a trailing dropout; dropout sites in
    order: attention probabilities, the attention sublayer's output, the
    GELU (exact erf), the feed-forward output, the layer's output."""
    a = apply_attention(p["attn"], apply_layer_norm(p["ln1"], x), mask, n_heads, drop)
    x = x + _apply(drop, a)
    h = apply_linear(p["ff"]["w1"], apply_layer_norm(p["ln2"], x))
    h = _apply(drop, F.gelu(h, approximate="none"))
    x = x + _apply(drop, apply_linear(p["ff"]["w2"], h))
    return _apply(drop, x)


def tower_params(vocab: int | None, d: int, max_len: int, n_layers: int, device,
                 d_ff: int | None = None) -> tuple[nn.ParameterDict, nn.ModuleList]:
    """``(emb, layers)``: ``emb`` holds ``token`` [vocab, d] (none where
    ``vocab`` is None: MAERec's items come from its GCN) and ``pos``."""
    d_ff = d_ff or 4 * d
    emb = {"pos": nn.Parameter(torch.empty(max_len, d, device=device))}
    if vocab is not None:
        emb["token"] = nn.Parameter(torch.empty(vocab, d, device=device))
    layers = nn.ModuleList([transformer_layer_params(d, d_ff, device)
                            for _ in range(n_layers)])
    return nn.ParameterDict(emb), layers


@torch.no_grad()
def init_tower(gen: torch.Generator, emb: nn.ParameterDict, layers: nn.ModuleList) -> None:
    """N(0, 0.02) token (row 0, the pad, zeroed) and position tables, N(0,
    0.02) linear weights with zero biases, unit layer norms."""
    if "token" in emb:
        emb["token"].copy_(normal_init(gen, tuple(emb["token"].shape)))
        emb["token"][0] = 0.0
    emb["pos"].copy_(normal_init(gen, tuple(emb["pos"].shape)))
    for lp in layers:
        for lin in (*lp["attn"].values(), lp["ff"]["w1"], lp["ff"]["w2"]):
            init_linear_normal(gen, lin)
        for ln in (lp["ln1"], lp["ln2"]):
            ln["scale"].fill_(1.0)
            ln["bias"].zero_()


def apply_transformer_embedding(emb, seqs: torch.Tensor, drop=None) -> torch.Tensor:
    """[B, L] ids → [B, L, d]: token rows (zero at pads) plus every position's
    row, then dropout."""
    x = take_rows(emb["token"], seqs) * (seqs != 0)[..., None]
    x = x + emb["pos"][None, : seqs.shape[1], :]
    return _apply(drop, x)


def apply_layers(layers, x: torch.Tensor, seqs: torch.Tensor, n_heads: int, drop=None):
    """The transformer layers over ``x``, keys masked where ``seqs`` is 0."""
    mask = (seqs > 0).to(torch.int32)
    for lp in layers:
        x = apply_transformer_layer(lp, x, mask, n_heads, drop)
    return x


def apply_transformer_tower(emb, layers, seqs: torch.Tensor, n_heads: int,
                            drop=None) -> torch.Tensor:
    """Hidden states [B, L, d].  Dropout sites in order: the embedding, then
    each layer's five (:func:`apply_transformer_layer`)."""
    x = apply_transformer_embedding(emb, seqs, drop)
    return apply_layers(layers, x, seqs, n_heads, drop)
