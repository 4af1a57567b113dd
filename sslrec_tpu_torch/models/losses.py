"""Losses (port of ``sslrec_tpu/models/losses.py``: the pairwise and
contrastive pieces, with the JAX package's reductions and epsilons)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bpr_loss(anc_embeds, pos_embeds, neg_embeds):
    """Softplus-form BPR, sum-reduced; callers divide by the batch size."""
    pos_preds = (anc_embeds * pos_embeds).sum(-1)
    neg_preds = (anc_embeds * neg_embeds).sum(-1)
    return F.softplus(neg_preds - pos_preds).sum()


def reg_pick_embeds(embeds_list):
    """Sum of squared entries over picked embedding batches."""
    return sum((e * e).sum() for e in embeds_list)


def bce_logits(score: torch.Tensor, label: float) -> torch.Tensor:
    """Per-element BCE with logits, in the JAX package's form; ``max(s, 0)``
    is ``torch.maximum`` against zeros, whose gradient at a tie is a half,
    as ``jnp.maximum``'s."""
    return (torch.maximum(score, torch.zeros_like(score)) - score * label
            + torch.log1p(torch.exp(-score.abs())))


def reg_params(params: dict[str, torch.Tensor]):
    """L2² over every parameter, summed in name order (the JAX package's
    pytree-leaf order)."""
    return sum((params[k] ** 2).sum() for k in sorted(params))


def _l2norm_eps(x, eps=1e-8):
    return x / torch.sqrt(eps + (x * x).sum(dim=-1, keepdim=True))


def _l2norm_safe(x, eps=1e-12):
    """Row L2-normalise with a finite gradient at zero rows (not
    ``F.normalize``, which clamps the norm)."""
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def infonce_loss(embeds1, embeds2, all_embeds2, temp=1.0):
    """InfoNCE, sum-reduced, every operand L2-normalised with 1e-8 inside the
    square root; the negatives through ``logsumexp`` over ``all_embeds2``."""
    n1, n2, na2 = _l2norm_eps(embeds1), _l2norm_eps(embeds2), _l2norm_eps(all_embeds2)
    nume_term = -(n1 * n2 / temp).sum(dim=-1)
    deno_term = torch.logsumexp(n1 @ na2.T / temp, dim=-1)
    return (nume_term + deno_term).sum()


def infonce_loss_spec_nodes(embeds1, embeds2, nodes, temp):
    """InfoNCE over the rows ``nodes``, mean-reduced; each table normalised as
    ``F.normalize(x + 1e-8)`` (an additive epsilon), then :func:`_l2norm_safe`."""
    e1, e2 = _l2norm_safe(embeds1 + 1e-8), _l2norm_safe(embeds2 + 1e-8)
    p1, p2 = e1[nodes], e2[nodes]
    nume = torch.exp((p1 * p2).sum(dim=-1) / temp)
    deno = torch.exp(p1 @ e2.T / temp).sum(dim=-1) + 1e-8
    return -torch.log(nume / deno).mean()


def alignment_loss(x, y, alpha=2.0):
    """DirectAU alignment: mean of ‖x̂ - ŷ‖^alpha."""
    xn, yn = _l2norm_safe(x), _l2norm_safe(y)
    return (((xn - yn) ** 2).sum(dim=-1) ** (alpha / 2.0)).mean()


def uniformity_loss(x):
    """DirectAU uniformity: log of the mean of exp(-2‖x̂_a - x̂_b‖²) over
    ordered pairs a ≠ b, from the Gram matrix as the JAX package writes it
    (not ``torch.pdist``, whose pair mean rounds differently): the diagonal's
    n ones are subtracted from the full sum."""
    xn = _l2norm_safe(x)
    gram = xn @ xn.T
    sq = torch.maximum(2.0 - 2.0 * gram, gram.new_zeros(()))   # ‖a-b‖² of unit rows
    n = x.shape[0]
    total = torch.exp(-2.0 * sq).sum() - n
    return torch.log(total / (n * (n - 1)))


def _grace_row_sums(rows, z_all, tau: float, g_n: int):
    """Per row of ``rows`` and per view ``h``: Σ_j exp(⟨row, z_h,j⟩ / τ) → [C, G]."""
    s = torch.exp(rows @ z_all.T / tau)
    return s.view(rows.shape[0], g_n, -1).sum(-1)


class GraceRowSumsFn(torch.autograd.Function):
    """:func:`_grace_row_sums` of the first ``n_rows`` rows of ``z_all``
    ``[G·N, d]``, ``chunk`` rows at a time → ``[n_rows, G]``.  Only ``z_all``
    is saved: the backward recomputes each chunk's ``[chunk, G·N]``
    similarities (JAX's remat), so none outlives its chunk.  This is
    ``torch.utils.checkpoint`` of each chunk written out, because a
    checkpoint's recomputation, which runs in the backward pass, cannot reach
    the lanes of ``torch.func.vmap``; under vmap each lane takes its own call
    (the dot products mix the features, so lanes cannot share one)."""

    @staticmethod
    def forward(z_all, tau: float, g_n: int, chunk: int, n_rows: int):
        return torch.cat([_grace_row_sums(z_all[s:min(s + chunk, n_rows)], z_all, tau, g_n)
                          for s in range(0, n_rows, chunk)])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.tau, ctx.g_n, ctx.chunk, ctx.n_rows = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        (z_all,) = ctx.saved_tensors
        tau, g_n, chunk, n_rows = ctx.tau, ctx.g_n, ctx.chunk, ctx.n_rows
        n = z_all.shape[0] // g_n
        dz = torch.zeros_like(z_all)
        for s in range(0, n_rows, chunk):
            stop = min(s + chunk, n_rows)
            rows = z_all[s:stop]
            e = torch.exp(rows @ z_all.T / tau)                      # [C, G·N]
            de = grad[s:stop, :, None].expand(-1, g_n, n).reshape(e.shape)
            dl = de * e / tau
            dz[s:stop] += dl @ z_all
            dz += dl.T @ rows
        return dz, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, z_all, tau, g_n, chunk, n_rows):
        outs = [GraceRowSumsFn.apply(z_all.select(in_dims[0], i), tau, g_n, chunk, n_rows)
                for i in range(info.batch_size)]
        return torch.stack(outs), 0


def grace_pair_losses(zs, tau: float, chunk: int = 256) -> dict:
    """All ordered-pair GRACE semi-losses over ``G`` same-shaped ``[N, d]``
    views (port of the JAX package's ``hmgcr.grace_pair_losses``), as
    ``{(g, h): mean semi-loss}``:

        semi(g→h)[i] = -log(e^{⟨ẑ_g,i, ẑ_h,i⟩/τ} /
                            (rowsum_i(g, g) + rowsum_i(g, h) − e^{‖ẑ_g,i‖²/τ}) + 1e-8)

    with ``ẑ`` rows normalised by ``√(‖z‖² + 1e-12)`` and ``rowsum_i(g, h) =
    Σ_j e^{⟨ẑ_g,i, ẑ_h,j⟩/τ}``.  One pass over the concatenated views in
    chunks of ``chunk`` rows computes every row-sum table
    (:class:`GraceRowSumsFn`, whose backward recomputes each chunk), so the
    ``[G·N, G·N]`` matrix is never held whole (JAX's remat)."""
    g_n, n = len(zs), zs[0].shape[0]
    zn = [_l2norm_safe(z) for z in zs]
    sums = GraceRowSumsFn.apply(torch.cat(zn, 0), tau, g_n, chunk, g_n * n).view(g_n, n, g_n)
    out = {}
    for g in range(g_n):
        # ‖ẑ_g,i‖² is not assumed 1: a post-relu view may have zero rows
        self_diag = torch.exp((zn[g] * zn[g]).sum(-1) / tau)
        for h in range(g_n):
            if g == h:
                continue
            diag = (zn[g] * zn[h]).sum(-1)
            denom = sums[g, :, g] + sums[g, :, h] - self_diag
            out[(g, h)] = -torch.log(torch.exp(diag / tau) / denom + 1e-8).sum() / n
    return out


def grace_loss(z1, z2, tau: float, chunk: int = 1024):
    """The GRACE semi-loss of view ``z1`` against ``z2`` (port of the JAX
    package's ``hmgcr.grace_loss``): ``semi(0→1)`` of
    :func:`grace_pair_losses` over the two views, the row sums taken for
    ``z1``'s rows only, ``chunk`` rows at a time (:class:`GraceRowSumsFn`,
    which recomputes each chunk in the backward and runs under vmap)."""
    n = z1.shape[0]
    z1n, z2n = _l2norm_safe(z1), _l2norm_safe(z2)
    sums = GraceRowSumsFn.apply(torch.cat([z1n, z2n]), tau, 2, chunk, n)   # [n, 2]
    denom = sums[:, 0] + sums[:, 1] - torch.exp((z1n * z1n).sum(-1) / tau)
    diag = (z1n * z2n).sum(-1)
    return -torch.log(torch.exp(diag / tau) / denom + 1e-8).sum() / n


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 0,
                         total: bool = False):
    """Mean cross entropy over the positions whose label is not
    ``ignore_index`` (BERT4Rec's masked-item loss); 0 where there is none.
    ``total``: the sum, undivided (a mesh rank divides by the whole batch's
    count)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    valid = (labels != ignore_index).to(logits.dtype)
    if total:
        return -(ll * valid).sum()
    return -(ll * valid).sum() / valid.sum().clamp(min=1.0)


def next_item_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean of −log softmax(logits)[target] over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, targets.long()[:, None])[:, 0].mean()
