"""Graph-partitioned, row-sharded, data-parallel training on a device mesh
(port of ``sslrec_tpu/parallel/dist_train.py``).

Layout
------
The user table is padded to ``U_pad = P·U_loc`` rows and split over the
``model`` axis, the item table likewise; the propagation's node space is
``[users_pad; items_pad]`` (``N_pad = U_pad + I_pad``).  Shard ``p`` owns user
rows ``[p·U_loc, (p+1)·U_loc)`` and item rows ``[p·I_loc, (p+1)·I_loc)``; its
propagation state is ``[U_loc + I_loc, d]``.

Each hop gathers the whole ``[N_pad, d]`` table over the ``model`` group
(:func:`assemble_full`), then sums the edges whose *destination* rows the
shard owns: one B1 call on the shard's own CSR layout (:func:`shard_graph`),
``U_loc + I_loc`` rows over the gathered columns, whose edge ids are the
edges' ids in the whole graph, so that a multiplier in the original edge
order (a dropout PRF, a view's values) reaches the shard through them.  Its
backward is B1 on the transposed layout, then the gather's adjoint, a
reduce-scatter.  A batch's rows come from the shards through
:func:`owned_lookup` (a masked lookup and an all-reduce).

Hops that run on the whole graph (SGL's and SimGCL's augmented views, NCL's
and DirectAU's hops, and every hop of the models that partition no graph:
LightGCL, HCCF, DCCF, AutoCF, GFormer, AdaGCL, MBGMN and the social five)
read the tables whole through :func:`whole_nodes`, one gather whose adjoint
is again the reduce-scatter (:func:`row_tables` and :func:`init_rows` hold
and draw such a model's row-sharded tables, :func:`ui_nodes` reads its user
and item tables as one, :func:`whole_param` any one of them); a term that
crosses the batch gathers the batch's rows over the ``data`` group
(:func:`gather_batch`: DirectAU's uniformity, DCCF's in-batch contrast, the
union of the batch's ids that KCGN's and SMIN's DGI masks take), and
:func:`reg_params` sums the row shards' L2 over ``model``.

A model whose user and item rows live in one fused table (the KG models'
``all_embed [users; entities]``) row-shards that table contiguously: rank
``p`` holds rows ``[p·N_loc, (p+1)·N_loc)``, ``N_loc = ⌈N / M⌉``, so that
:func:`whole_state`, :func:`local_state` and checkpoints treat it as any
other row shard.  Such a model reads the whole table with autograd
(:func:`whole_table`) and cuts the partition's ``U_loc`` and ``I_loc`` rows
out of it (:func:`own_rows`, differentiable) for a partitioned hop; where
a computation that every rank runs alike (an RGAT) makes those rows, its
output passes :func:`share_cotangent`, so that its backward sees the whole
cotangent on every rank, as one device's does.

A parameter outside ``row_shards`` is replicated: every rank of a ``model``
group holds all of it and reads it directly, with no collective whose
backward would sum the ranks' cotangents, so :func:`sync_model_grads` sums
its gradient over the ``model`` group.  A gradient clip then takes
:func:`global_norm`, whose squares of the row shards' gradients are summed
over the ``model`` group, as one device's norm is over the whole tables.

The JAX package runs all of it in one process under ``shard_map``; here a
process is a rank of the mesh (:mod:`~sslrec_tpu_torch.parallel.mesh`), and
the collectives are ``torch.distributed`` calls with autograd.  Their
backward sums the cotangents of the ranks, which is right for a sum of the
ranks' losses; :func:`mesh_backward` makes the ranks' losses such a sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.ops.sparse import CooGraph
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import CsrGraph, csr_layout, prf_mask
from sslrec_tpu_torch.ops.spmm_kernel import _threefry2x32
from sslrec_tpu_torch.parallel.mesh import Mesh, mesh_from_config, pad_to_multiple
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class ShardedGraph(NamedTuple):
    """Destination-partitioned padded edge lists, host numpy, equal to the JAX
    package's.

    ``local_rows[p]``: destination row in shard-local node coordinates
    (0..U_loc+I_loc); ``cols[p]``: source node in *global padded* coordinates;
    ``vals[p]``: edge weight (0 for padding); ``src_idx[p]``: the edge's index
    in the ORIGINAL (unpartitioned) edge list, -1 for padding slots.  All
    ``[P, E_pad]``; padding slots follow each shard's sorted slots.
    ``n_edges`` is the original graph's edge count; ``shards`` caches each
    shard's B1 layouts (:func:`shard_graph`).
    """

    local_rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    src_idx: np.ndarray
    u_loc: int
    i_loc: int
    n_model: int
    n_edges: int
    shards: dict

    @property
    def n_local(self) -> int:
        return self.u_loc + self.i_loc

    @property
    def n_pad(self) -> int:
        return (self.u_loc + self.i_loc) * self.n_model


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def partition_graph(g, n_users: int, n_items: int, n_model: int) -> ShardedGraph:
    """Host-side: split the bidirectional adjacency ``g`` (rows, cols, vals
    over nodes ``[users; items]`` 0..U+I, unpadded) by destination-row owner,
    each shard's slots sorted by local row (stably: original order within a
    row) and padded to the longest shard."""
    u_loc = pad_to_multiple(n_users, n_model) // n_model
    i_loc = pad_to_multiple(n_items, n_model) // n_model
    u_pad = u_loc * n_model
    rows, cols, vals = _host(g.rows), _host(g.cols), _host(g.vals)

    def remap(x):
        return np.where(x < n_users, x, u_pad + (x - n_users))

    rows_p, cols_p = remap(rows), remap(cols)
    is_user = rows_p < u_pad
    owner = np.where(is_user, rows_p // u_loc, (rows_p - u_pad) // i_loc)
    local = np.where(is_user, rows_p % u_loc, u_loc + (rows_p - u_pad) % i_loc)
    e_max = max(int(np.max(np.bincount(owner, minlength=n_model))), 1)
    lr = np.zeros((n_model, e_max), np.int32)
    lc = np.zeros((n_model, e_max), np.int32)
    lv = np.zeros((n_model, e_max), np.float32)
    si = np.full((n_model, e_max), -1, np.int32)
    eids = np.arange(rows.shape[0], dtype=np.int32)
    for p in range(n_model):
        sel = owner == p
        k = int(sel.sum())
        order = np.argsort(local[sel], kind="stable")
        lr[p, :k] = local[sel][order]
        lc[p, :k] = cols_p[sel][order]
        lv[p, :k] = vals[sel][order]
        si[p, :k] = eids[sel][order]
    return ShardedGraph(lr, lc, lv, si, u_loc, i_loc, n_model, int(rows.shape[0]), {})


class Shard(NamedTuple):
    """Shard ``p``'s B1 operator: ``graph`` (forward layout ``[U_loc+I_loc]``
    rows over the ``[N_pad]`` gathered columns, and its transposed layout),
    ``live`` the slots of the ``[E_pad]`` row it holds, and ``order`` the
    transposed layout's slots as forward slots."""

    graph: CsrGraph
    live: torch.Tensor
    order: torch.Tensor

    def with_vals(self, vals_row: torch.Tensor) -> CsrGraph:
        """The operator under a view's values ``vals_row`` (the shard's
        ``[E_pad]`` row of :func:`view_vals_partitioned`), in place of the
        partition's own (float32, float64 values kept as such for a model run
        in float64 on the CPU)."""
        dtype = torch.promote_types(vals_row.dtype, torch.float32)
        v = vals_row.to(self.graph.vals.device, dtype)[self.live].contiguous()
        g = self.graph
        fwd = g.fwd._replace(vals=v, vals_ones=False)
        bwd = g.bwd._replace(vals=v[self.order].contiguous(), vals_ones=False)
        return g._replace(fwd=fwd, bwd=bwd, vals=v)


def shard_graph(sg: ShardedGraph, p: int, device) -> Shard:
    """Shard ``p``'s B1 layouts from its live slots only (the padding slots,
    appended after the sorted rows with row 0, would break the CSR's row
    order), its edge ids the original ones (``src_idx``) out of ``n_edges``;
    built once a device and cached on ``sg``."""
    key = (int(p), str(torch.device(device)))
    if key in sg.shards:
        return sg.shards[key]
    live = np.flatnonzero(sg.src_idx[p] >= 0)
    rows, cols = sg.local_rows[p][live], sg.cols[p][live]
    vals, ids = sg.vals[p][live], sg.src_idx[p][live]
    n_local, n_pad = sg.n_local, sg.n_pad
    fwd = csr_layout(rows, cols, vals, ids, n_local, n_pad, device, n_ids=sg.n_edges)
    order = np.lexsort((rows, cols))
    bwd = csr_layout(cols[order], rows[order], vals[order], ids[order], n_pad, n_local,
                     device, n_ids=sg.n_edges)
    g = CsrGraph(fwd=fwd, bwd=bwd, rows=fwd.rows, cols=fwd.cols, vals=fwd.vals,
                 n_rows=n_local, n_cols=n_pad)
    out = Shard(g, torch.from_numpy(live).to(device), torch.from_numpy(order).to(device))
    sg.shards[key] = out
    return out


# ---------------------------------------------------------------------------
# Collectives with autograd
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """``all_gather`` over ``group`` along the rows, ``[n, d]`` → ``[P·n, d]``
    in rank order; backward: the reduce-scatter (sum) of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        chunks = [c.contiguous() for c in grad.chunk(dist.get_world_size(ctx.group))]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=ctx.group)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``; backward: the same of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ShareCotangent(torch.autograd.Function):
    """Identity; backward: the mean over ``group`` of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``x`` of every rank of ``group``, in rank order, with
    autograd (``x`` itself outside a started group)."""
    return x if group is None else _GatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group``'s ranks of ``x``, with autograd."""
    return x if group is None else _AllReduceSum.apply(x, group)


def assemble_full(x_local: torch.Tensor, u_loc: int, i_loc: int, mesh: Mesh) -> torch.Tensor:
    """all_gather shard-local ``[U_loc+I_loc, d]`` states → global padded
    ``[N_pad, d]`` (``[users of every shard; items of every shard]``)."""
    d = x_local.shape[-1]
    g = gather_rows(x_local, mesh.model_group).view(-1, u_loc + i_loc, d)
    return torch.cat([g[:, :u_loc].reshape(-1, d), g[:, u_loc:].reshape(-1, d)])


def owned_lookup(table_local: torch.Tensor, idx: torch.Tensor, shard_size: int,
                 mesh: Mesh) -> torch.Tensor:
    """Row-sharded table lookup: the rows of ``idx`` this shard owns (others
    0), summed over the ``model`` group."""
    off = mesh.model_index * shard_size
    idx = idx.long()
    owned = (idx >= off) & (idx < off + shard_size)
    rows = table_local[(idx - off).clamp(0, shard_size - 1)]
    return all_reduce_sum(torch.where(owned[:, None], rows, 0.0), mesh.model_group)


# ---------------------------------------------------------------------------
# Partitioned propagation
# ---------------------------------------------------------------------------

def partitioned_spmm(u_loc: int, i_loc: int, x_local: torch.Tensor, graph: CsrGraph,
                     mesh: Mesh, ew=None) -> torch.Tensor:
    """ONE graph-partitioned ``A @ x`` hop: gather the whole node table over
    the ``model`` group, then B1 over the edges whose destination rows this
    shard owns (``graph``, :func:`shard_graph`), under an optional constant
    multiplier ``ew`` in the original edge order (an ``EdgeMask`` or a
    ``PrfMask`` of the whole graph)."""
    return spmm(graph, assemble_full(x_local, u_loc, i_loc, mesh), ew)


def partitioned_propagate(sg: ShardedGraph, u_local: torch.Tensor, i_local: torch.Tensor,
                          graph: CsrGraph, layer_num: int, mesh: Mesh, combine: str = "sum",
                          ew=None):
    """Multi-hop propagation from shard-local tables; ``combine``: 'sum'
    (x0 + Σ hops, LightGCN), 'mean' (the layer mean) or 'last' (the final
    hop).  Returns ``(user_local, item_local)``."""
    x = torch.cat([u_local, i_local])
    acc = [x]
    for _ in range(layer_num):
        x = partitioned_spmm(sg.u_loc, sg.i_loc, x, graph, mesh, ew)
        acc.append(x)
    if combine == "sum":
        out = sum(acc)
    elif combine == "mean":
        out = sum(acc) / len(acc)
    else:
        out = x
    return out[:sg.u_loc], out[sg.u_loc:]


def view_vals_partitioned(sg: ShardedGraph, vals) -> torch.Tensor:
    """Per-view edge values in ORIGINAL edge order → the partitioned ``[P,
    E_pad]`` layout (padding slots get 0)."""
    vals = torch.as_tensor(vals)
    src = torch.from_numpy(sg.src_idx).to(vals.device).long()
    return torch.where(src >= 0, vals[src.clamp(min=0)], 0.0)


def mesh_partitioned_propagate(mesh: Mesh, sg: ShardedGraph, u_x: torch.Tensor,
                               i_x: torch.Tensor, vals_part, layer_num: int,
                               combine: str = "sum", ew=None):
    """Graph-partitioned multi-hop propagation on this rank's shard.

    The JAX function takes whole tables, and GSPMD splits them; here each
    rank holds its own rows: ``u_x [U_loc, d]`` and ``i_x [I_loc, d]`` (padded
    with zero rows past the last user and item), and gets its own rows of
    the result.  ``vals_part``: the ``[P, E_pad]`` values of
    :func:`view_vals_partitioned`, or None for the partition's own; ``ew``:
    an optional constant multiplier in the original edge order."""
    shard = shard_graph(sg, mesh.model_index, u_x.device)
    graph = shard.graph if vals_part is None else shard.with_vals(vals_part[mesh.model_index])
    return partitioned_propagate(sg, u_x, i_x, graph, layer_num, mesh, combine, ew)


def maybe_partition_bi(cfg, rows, cols, n_users: int, n_items: int, vals=None,
                       device="cpu"):
    """Under a config-driven mesh whose ``model`` axis is > 1, partition a
    bidirectional ``[users; items]``-indexed edge list by destination owner
    and return ``(mesh, ShardedGraph)``; otherwise ``(mesh, None)``, and the
    model keeps its single-device propagation.  ``vals`` default to ones."""
    mesh = mesh_from_config(cfg, device)
    if mesh is None or mesh.n_model <= 1:
        return mesh, None
    rows = _host(rows)
    vals = np.ones(rows.shape[0], np.float32) if vals is None else _host(vals).astype(np.float32)
    g = CooGraph(rows=rows, cols=_host(cols), vals=vals, n_rows=n_users + n_items,
                 n_cols=n_users + n_items)
    return mesh, partition_graph(g, n_users, n_items, mesh.n_model)


def maybe_partition_rect_pair(cfg, a_graph, at_graph, n_users: int, n_items: int,
                              device="cpu"):
    """Partition a chained rect propagation pair (A: users←items, then AT:
    items←users, HMGCR's and SMBRec's tower) into two direction-specific
    :class:`ShardedGraph` s, static values in ``sg.vals``.  Returns ``(mesh,
    (sg_a, sg_at))`` or ``(mesh, None)`` off a model-sharded mesh."""
    mesh = mesh_from_config(cfg, device)
    if mesh is None or mesh.n_model <= 1:
        return mesh, None

    def part(rows, cols, vals):
        g = CooGraph(rows=rows, cols=cols, vals=np.asarray(vals, np.float32),
                     n_rows=n_users + n_items, n_cols=n_users + n_items)
        return partition_graph(g, n_users, n_items, mesh.n_model)

    ar, ac = _host(a_graph.rows).astype(np.int64), _host(a_graph.cols).astype(np.int64)
    tr, tc = _host(at_graph.rows).astype(np.int64), _host(at_graph.cols).astype(np.int64)
    sg_a = part(ar, n_users + ac, _host(a_graph.vals))           # users ← items
    sg_at = part(n_users + tr, tc, _host(at_graph.vals))         # items ← users
    return mesh, (sg_a, sg_at)


# ---------------------------------------------------------------------------
# Whole tables, the backward, the gradients
# ---------------------------------------------------------------------------

def model_sharded(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` splits the tables' rows (a ``model`` axis > 1)."""
    return mesh is not None and mesh.n_model > 1


def shard_rows(n: int, mesh: Mesh | None) -> int:
    """The rows a rank holds of an ``n``-row table: a padded shard on a
    model-sharded mesh, else all ``n``."""
    return pad_to_multiple(n, mesh.n_model) // mesh.n_model if model_sharded(mesh) else n


def own_rows(whole: torch.Tensor, n_loc: int, mesh: Mesh | None) -> torch.Tensor:
    """This shard's ``n_loc`` rows of a whole table, zero rows past its end, a
    copy (``whole`` itself off a mesh); with autograd, the rows' gradient
    going back to the same rows of ``whole``."""
    if mesh is None:
        return whole
    lo = mesh.model_index * n_loc
    out = whole.new_zeros((n_loc, *whole.shape[1:]))
    part = whole[lo:lo + n_loc]
    out[:part.shape[0]] = part
    return out


def gather_whole(local: torch.Tensor, n_rows: int, mesh: Mesh) -> torch.Tensor:
    """The whole ``[n_rows, ...]`` table of which each rank of the ``model``
    group holds the row shard ``local``, with autograd: its backward is the
    reduce-scatter of the cotangent, and the padding rows past ``n_rows`` get
    a zero gradient."""
    return gather_rows(local, mesh.model_group)[:n_rows]


UI_TABLES = ("user_embeds", "item_embeds")


def row_tables(model, cfg, device, tables: dict) -> None:
    """Give ``model`` the tables ``tables`` (``{name: whole shape}``,
    uninitialised) as a model that reads them whole holds them: its ``mesh``
    (``train.mesh`` of ``cfg``) and, on a model-sharded mesh, a row shard of
    each, listed in its ``row_shards``."""
    model.mesh = mesh_from_config(cfg, device)
    if model_sharded(model.mesh):
        model.row_shards = {**model.row_shards, **{k: s[0] for k, s in tables.items()}}
    for name, (n, *rest) in tables.items():
        setattr(model, name, torch.nn.Parameter(
            torch.empty(shard_rows(n, model.mesh), *rest, device=device)))


def ui_tables(model, cfg, width: int, device, names=UI_TABLES) -> None:
    """:func:`row_tables` of ``model``'s user and item tables (``names``,
    ``[n, width]``)."""
    row_tables(model, cfg, device, dict(zip(names, ((model.user_num, width),
                                                    (model.item_num, width)))))


@torch.no_grad()
def init_rows(model, gen: torch.Generator, names) -> None:
    """Xavier-uniform parameters ``names``, drawn in that order from ``gen``:
    a table of :func:`row_tables` whole on every rank of a mesh, as one
    device draws it, each rank keeping its own rows."""
    shards = model.row_shards
    for name in names:
        p = getattr(model, name)
        if name in shards:
            p.copy_(own_rows(xavier_uniform(gen, (shards[name], *p.shape[1:])), p.shape[0],
                             model.mesh))
        else:
            p.copy_(xavier_uniform(gen, tuple(p.shape)))


def init_ui_tables(model, gen: torch.Generator, names=UI_TABLES) -> None:
    """:func:`init_rows` of the user and item tables of :func:`ui_tables`,
    the user table first."""
    init_rows(model, gen, names)


def ui_nodes(model, names=UI_TABLES) -> torch.Tensor:
    """``[users; items]`` of :func:`ui_tables`, whole, with autograd
    (:func:`whole_nodes`)."""
    u, i = (getattr(model, name) for name in names)
    return whole_nodes(u, i, model.user_num, model.item_num, model.mesh)


def whole_param(model, name: str) -> torch.Tensor:
    """``model``'s table ``name`` whole, with autograd: gathered over the
    ``model`` group where it is one of the row shards of :func:`row_tables`
    (a user table alone, as MHCN's channels read it), else the parameter."""
    p = getattr(model, name)
    n = model.row_shards.get(name) if model_sharded(getattr(model, "mesh", None)) else None
    return p if n is None else gather_whole(p, n, model.mesh)


def reg_params(model, mesh: Mesh | None, names=None) -> torch.Tensor:
    """L2² of ``model``'s parameters (those of ``names``; default every one),
    as ``losses.reg_params`` sums them on one device: on a model-sharded
    mesh the squares of the row shards (``row_shards``) are summed over the
    ``model`` group with autograd, and a replicated parameter, whole on every
    rank, is counted once."""
    params = dict(model.named_parameters())
    if names is not None:
        params = {k: params[k] for k in names}
    if not model_sharded(mesh):
        return losses.reg_params(params)
    shards = model.row_shards
    rows = all_reduce_sum(losses.reg_params({k: v for k, v in params.items() if k in shards}),
                          mesh.model_group)
    rep = {k: v for k, v in params.items() if k not in shards}
    return rows + losses.reg_params(rep) if rep else rows


def whole_nodes(u_local: torch.Tensor, i_local: torch.Tensor, n_users: int, n_items: int,
                mesh: Mesh | None) -> torch.Tensor:
    """The differentiable whole-table path: ``[users; items]`` at the unpadded
    ``U + I`` rows, the node space of a model's whole graph (its
    ``bi_adj``), from this rank's row shards of the two tables (one gather
    over the ``model`` group), or their concatenation off a model-sharded
    mesh.

    Each rank of a ``data`` row then runs the whole graph's hops itself, as
    one device does, and computes the same loss from them; the gather's
    adjoint sums the ``M`` equal cotangents, and :func:`mesh_backward`'s
    division by ``M`` makes that sum the single run's gradient, as on the
    partitioned path, with no scaling here.  Model-agnostic: any model whose
    user and item tables are row-sharded (``row_shards``) reads its whole
    tables through it."""
    if not model_sharded(mesh):
        return torch.cat([u_local, i_local])
    u_loc = u_local.shape[0]
    full = assemble_full(torch.cat([u_local, i_local]), u_loc, i_local.shape[0], mesh)
    u_pad = u_loc * mesh.n_model
    return torch.cat([full[:n_users], full[u_pad:u_pad + n_items]])


def share_cotangent(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x``, a whole table that every rank of a ``model`` group computes
    alike, for a partitioned hop that reads each rank's rows of it
    (:func:`own_rows`): in the backward each rank's cotangent (its own rows')
    is replaced by the group's mean, so that the computation that made ``x``
    runs its backward on the whole cotangent on every rank, as one device
    does (JAX's GSPMD sums it there too), rather than on a part of it whose
    results the gather's reduce-scatter adds later.  The gradient is the
    same; the float sums are the single run's.  ``x`` itself off a
    model-sharded mesh."""
    return _ShareCotangent.apply(x, mesh.model_group) if model_sharded(mesh) else x


def whole_table(local: torch.Tensor, n_rows: int, mesh: Mesh | None) -> torch.Tensor:
    """:func:`gather_whole` on a model-sharded mesh, else ``local`` (which is
    then the whole table)."""
    return gather_whole(local, n_rows, mesh) if model_sharded(mesh) else local


@torch.no_grad()
def whole_rows(local: torch.Tensor, n_rows: int, mesh: Mesh) -> torch.Tensor:
    """The whole ``[n_rows, ...]`` table of which each shard holds ``local``,
    detached (snapshots, checkpoints, evaluation)."""
    return gather_whole(local.detach(), n_rows, mesh).clone()


def whole_state(model, mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """The model's parameters as whole tables (a copy), its ``row_shards``
    gathered over the ``model`` group."""
    shards = getattr(model, "row_shards", {}) if mesh is not None else {}
    return {k: whole_rows(v, shards[k], mesh) if k in shards else v.detach().clone()
            for k, v in model.state_dict().items()}


def local_state(model, state: dict, mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """Whole tables ``state`` as the model's own rows (:func:`whole_state`'s
    inverse)."""
    shards = getattr(model, "row_shards", {}) if mesh is not None else {}
    own = model.state_dict()
    return {k: own_rows(v.to(own[k].device), own[k].shape[0], mesh) if k in shards else v
            for k, v in state.items()}


def batch_slice(n: int, mesh: Mesh) -> slice:
    """This rank's slice of a batch of ``n`` over the ``data`` axis (sizes
    differing by at most one, as ``torch.tensor_split``'s)."""
    return slice(n * mesh.data_index // mesh.n_data, n * (mesh.data_index + 1) // mesh.n_data)


def gather_batch(x: torch.Tensor, n: int, mesh: Mesh | None) -> torch.Tensor:
    """The whole batch's rows from this rank's slice ``x`` of a batch of ``n``
    (:func:`batch_slice`), gathered over the ``data`` group in rank order,
    with autograd (``x`` itself where the ``data`` axis is 1).  Slices that
    differ by a row are padded to the largest, gathered and trimmed.

    For a term that crosses the batch (DirectAU's uniformity): every data
    rank computes the whole batch's term, and :func:`mesh_backward`'s
    ``share`` makes the ranks' sum exact (the shares sum to 1, and the
    gather's adjoint sums their cotangents)."""
    if mesh is None or mesh.n_data <= 1:
        return x
    bounds = [n * k // mesh.n_data for k in range(mesh.n_data + 1)]
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    width = max(sizes)
    padded = torch.cat([x, x.new_zeros((width - x.shape[0], *x.shape[1:]))])
    parts = gather_rows(padded, mesh.data_group).split(width)
    return torch.cat([p[:k] for p, k in zip(parts, sizes)])


def mesh_backward(loss: torch.Tensor, mesh: Mesh, share: float) -> None:
    """Backpropagate this rank's ``loss`` (over its batch slice, ``share`` of
    the whole batch) so that the gradients summed over the ``data`` group
    (:func:`sync_grads`) are those of the whole batch's loss.

    The JAX step averages the loss over ``model`` and then over ``data``
    (``dist_train.py:299``: ``lax.pmean(lax.pmean(loss, MODEL_AXIS),
    DATA_AXIS)``).  Here each of the ``M`` ranks of a data row computes the
    row's whole loss and backpropagates it itself, and the collectives'
    backward (gather ⇄ reduce-scatter, all-reduce ⇄ all-reduce) sums the
    ``M`` equal cotangents: without the division by ``M`` every gradient
    would be ``M`` times too large.  This is the one place that scales.

    A replicated parameter (outside the model's ``row_shards``) has no such
    collective: each rank's gradient is its own part of the sum, ``1/M`` of
    the whole where every rank computes the same, its own rows' share where
    the rank reads it over its row shard; :func:`sync_model_grads` adds the
    parts over the ``model`` group."""
    (loss * (share / mesh.n_model)).backward()


def _all_reduce_grads(grads: list, group) -> None:
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@torch.no_grad()
def sync_grads(params, mesh: Mesh, replicated=()) -> None:
    """Sum the gradients of ``replicated`` over the ``model`` group (each rank
    holds a part of theirs, :func:`mesh_backward`), then every gradient of
    ``params`` over the ``data`` group, in place, one all-reduce each."""
    _all_reduce_grads([p.grad for p in replicated if p.grad is not None], mesh.model_group)
    _all_reduce_grads([p.grad for p in params if p.grad is not None], mesh.data_group)


def sync_model_grads(model, mesh: Mesh, prefix: str | tuple = "", data: bool = True) -> None:
    """:func:`sync_grads` of the parameters of ``model`` whose names start with
    ``prefix`` (a string or a tuple of them, as ``str.startswith`` takes it;
    all by default); on a model-sharded mesh those outside its
    ``row_shards`` are replicated, summed over the ``model`` group first.
    ``data`` False leaves out the ``data`` sum, for a computation that every
    ``data`` rank runs alike on the same inputs (KMCLR's epoch hook)."""
    shards = getattr(model, "row_shards", {})
    named = [(name, p) for name, p in model.named_parameters() if name.startswith(prefix)]
    replicated = [p for name, p in named if name not in shards] if model_sharded(mesh) else []
    sync_grads([p for _, p in named] if data else [], mesh, replicated)


@torch.no_grad()
def global_norm(model, mesh: Mesh | None, prefix: str = "") -> torch.Tensor:
    """The global L2 norm of the gradients of ``model``'s parameters whose
    names start with ``prefix`` (one without a gradient counts as zero), as
    one device computes it, for ``optax.clip_by_global_norm`` after
    :func:`sync_model_grads`.

    On a model-sharded mesh a rank holds a row shard of each table in
    ``row_shards`` (padding rows with a zero gradient), so the squares of
    those gradients are summed over the ``model`` group; a replicated
    parameter's gradient, the same on every rank after the sums, is counted
    once.  The ``data`` group needs no sum: its ranks hold the same
    gradients after :func:`sync_grads`.  Elsewhere the squares are summed in
    parameter order, as on one device."""
    named = [(n, p.grad) for n, p in model.named_parameters()
             if n.startswith(prefix) and p.grad is not None]
    if not model_sharded(mesh):
        return torch.sqrt(sum((g * g).sum() for _, g in named))
    shards = model.row_shards
    rows, rep = (sum(((g * g).sum() for n, g in named if (n in shards) == own),
                     named[0][1].new_zeros(())) for own in (True, False))
    dist.all_reduce(rows, group=mesh.model_group)
    return torch.sqrt(rows + rep)


@torch.no_grad()
def reduce_terms(terms: dict, mesh: Mesh, share: float) -> dict:
    """The whole batch's loss terms from each rank's (``share``-weighted
    sum over the ``data`` group)."""
    names = list(terms)
    flat = torch.stack([torch.as_tensor(terms[k], dtype=torch.float32).reshape(())
                        for k in names]) * share
    if mesh.data_group is not None:
        dist.all_reduce(flat, group=mesh.data_group)
    return dict(zip(names, flat.unbind()))


def fold_key(key: torch.Tensor, *coords: int) -> torch.Tensor:
    """A PRF key with mesh coordinates folded in (one Threefry-2x32 of the
    key at counter ``coords``), so that each shard draws its own mask."""
    k = key.to(torch.int64)
    c = torch.tensor(list(coords) + [0] * (2 - len(coords)), dtype=torch.int64,
                     device=k.device)
    x0, x1 = _threefry2x32(k[0], k[1], c[0], c[1])
    return torch.stack([x0, x1])


def build_sharded_lightgcn_step(mesh: Mesh, sg: ShardedGraph, layer_num: int,
                                reg_weight: float, keep_rate: float, optimizer):
    """Returns ``(init, train_step)``: a sharded LightGCN step, TP (row-sharded
    tables, partitioned graph) × DP (the batch split over ``data``).

    ``init({"user_embeds": [U_pad, d], "item_embeds": [I_pad, d]})`` gives
    this rank's rows as parameters and ``optimizer(params)`` over them
    (``optimizer`` a factory, e.g. ``lambda ps: torch.optim.Adam(ps,
    lr)``); ``train_step(params, opt, batch, key)`` takes the whole batch
    (``user``/``pos``/``neg``), steps on this rank's slice, and returns the
    whole batch's loss.  Edge dropout at ``keep_rate`` < 1 draws a PRF mask
    a shard, its key with the model and data coordinates folded in
    (``dist_train.py:286-287``)."""
    u_loc, i_loc = sg.u_loc, sg.i_loc

    def init(whole: dict):
        params = {"user_embeds": own_rows(whole["user_embeds"], u_loc, mesh),
                  "item_embeds": own_rows(whole["item_embeds"], i_loc, mesh)}
        params = {k: torch.nn.Parameter(v.contiguous()) for k, v in params.items()}
        return params, optimizer(list(params.values()))

    def train_step(params, opt, batch, key):
        u_emb, i_emb = params["user_embeds"], params["item_embeds"]
        shard = shard_graph(sg, mesh.model_index, u_emb.device)
        ew = None
        if keep_rate < 1.0:
            k = fold_key(key, mesh.model_index, mesh.data_index).to(u_emb.device)
            ew = prf_mask(k, shard.graph, keep_rate)._replace(nnz=sg.n_edges)
        sl = batch_slice(batch["user"].shape[0], mesh)
        users, poss, negs = (batch[f][sl] for f in ("user", "pos", "neg"))
        opt.zero_grad(set_to_none=True)
        fin_u, fin_i = partitioned_propagate(sg, u_emb, i_emb, shard.graph, layer_num, mesh,
                                             "sum", ew)
        anc = owned_lookup(fin_u, users, u_loc, mesh)
        pos = owned_lookup(fin_i, poss, i_loc, mesh)
        neg = owned_lookup(fin_i, negs, i_loc, mesh)
        bpr = losses.bpr_loss(anc, pos, neg) / anc.shape[0]
        reg_local = (u_emb ** 2).sum() + (i_emb ** 2).sum()
        loss = bpr + reg_weight * all_reduce_sum(reg_local, mesh.model_group)
        share = users.shape[0] / batch["user"].shape[0]
        mesh_backward(loss, mesh, share)
        sync_grads(params.values(), mesh)
        opt.step()
        return reduce_terms({"loss": loss.detach()}, mesh, share)["loss"]

    return init, train_step
