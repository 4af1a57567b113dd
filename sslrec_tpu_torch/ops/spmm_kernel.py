"""CSR SpMM: layouts and split plans (built on the host, or on the edges' own
device), the CUDA kernel's wrapper, autograd, edge-dropout PRF.

Port of ``sslrec_tpu/ops/pallas_spmm.py``.  The TPU kernel there reduced
padded edge chunks (R-row blocks, M-edge chunks) with one-hot matmuls; that
tiling is the TPU's and is dropped.  Here each propagation direction is a
plain CSR layout (:class:`CsrLayout`), and ``csrc/csr_spmm.cu`` computes the
whole operator ``out[r] = Σ_e vals[e]·w(e)·x[cols[e]]`` in one call: rows cut
into chunks of at most T edges by :func:`split_plan`, a row of more than T
edges summed as several chunks, whose partials a fixed tree in the plan adds
up inside the same launch.

Dispatch: a tensor on the CPU goes to :func:`csr_spmm_plain`; a CUDA tensor
launches the kernel or raises.  Both follow the precision mode
(:func:`bf16_mode`): exact float32 by default; with
``SSLREC_PALLAS_PRECISION=default``, the variable the JAX package reads,
every contribution is ``bf16(bf16(x[col]) · bf16(vals·w))`` summed in
float32; the kernel gathers x as bf16 rows, cast in the call, where a
layout reads each row of x often (:func:`bf16_rows`), else rounds the
float32 rows as they load.  The backward pass of every hop is the same
kernel on the transposed layout, which is always built: A need not be
symmetric.  Edge dropout (:class:`PrfMask`) is evaluated inside the kernel
from each layout's edge ids; :class:`EdgeMask` carries a materialised
multiplier.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from sslrec_tpu_torch.ops.cuda_build import load_kernel
from sslrec_tpu_torch.ops.sparse import CooGraph


class PlanCache(dict):
    """A layout's split plans by threshold.  A dict subclass, so that a
    pytree takes it as a leaf: ``torch.func.vmap`` rebuilds the containers
    of a Function's operands (the layout's NamedTuples, a plain dict among
    them) and passes the leaves on, so this cache stays the layout's own
    under vmap, where a plain dict would be a new empty one every call."""


class CsrLayout(NamedTuple):
    """One propagation direction: destination rows over source columns.

    ``indptr`` int32 [n_rows+1]; ``rows`` int32 [nnz] (the destination row
    of each slot, read by the plain version and, as a segment layout's
    sorted ids, by B2); ``cols`` int32 [nnz];
    ``vals`` float32 [nnz]; ``edge_ids`` int32 [nnz], the original edge index
    of each slot, through which a per-edge multiplier held in the original
    edge order is read; ``ids_identity`` marks ``edge_ids == arange(nnz)`` and
    ``vals_ones`` marks ``vals`` all 1 (segment layouts, KGCL's bi-adjacency),
    so the kernel reads neither there; ``plans`` (a :class:`PlanCache`)
    caches the split plan by threshold; ``n_ids``, where set, is the number of
    edges that ``edge_ids`` index (a mesh shard's layout holds some of a
    graph's edges under their original ids), else ``nnz``.
    """

    indptr: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    edge_ids: torch.Tensor
    n_rows: int
    n_cols: int
    ids_identity: bool
    vals_ones: bool
    plans: PlanCache
    n_ids: int | None = None


class CsrGraph(NamedTuple):
    """Forward and transposed layouts of a sparse operator A, plus its COO
    arrays in the original edge order (for edge-weight gradients; row-sorted
    in a host build)."""

    fwd: CsrLayout
    bwd: CsrLayout  # Aᵀ, for dx = Aᵀ g
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def t(self) -> "CsrGraph":
        """Aᵀ, sharing the layouts; edge ids keep A's original order."""
        return CsrGraph(fwd=self.bwd, bwd=self.fwd, rows=self.cols,
                        cols=self.rows, vals=self.vals,
                        n_rows=self.n_cols, n_cols=self.n_rows)


def csr_layout(rows, cols, vals, edge_ids, n_rows, n_cols, device, n_ids=None) -> CsrLayout:
    """Layout from host arrays already sorted by destination row."""
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    edge_ids, vals = np.asarray(edge_ids), np.asarray(vals, np.float32)
    return CsrLayout(indptr=t(indptr, np.int32), rows=t(rows, np.int32),
                     cols=t(cols, np.int32), vals=t(vals, np.float32),
                     edge_ids=t(edge_ids, np.int32),
                     n_rows=int(n_rows), n_cols=int(n_cols),
                     ids_identity=bool(np.array_equal(edge_ids, np.arange(edge_ids.size))),
                     vals_ones=bool((vals == 1).all()), plans=PlanCache(), n_ids=n_ids)


def build_csr_graph(g: CooGraph, device="cpu") -> CsrGraph:
    """Both layouts of ``g`` on ``device``, built on the host.

    The original edge order is ``g``'s (row-sorted, then column-sorted), so
    the forward layout's edge ids are the identity.  The transposed layout
    sorts by (col, row); its edge ids are that permutation.
    """
    rows = g.rows.cpu().numpy().astype(np.int64)
    cols = g.cols.cpu().numpy().astype(np.int64)
    vals = g.vals.cpu().numpy()
    if g.nnz and (np.diff(rows) < 0).any():
        raise ValueError("edges must be sorted by destination row")
    fwd = csr_layout(rows, cols, vals, np.arange(g.nnz), g.n_rows, g.n_cols, device)
    order = np.lexsort((rows, cols))
    bwd = csr_layout(cols[order], rows[order], vals[order], order, g.n_cols,
                     g.n_rows, device)
    return CsrGraph(fwd=fwd, bwd=bwd, rows=fwd.rows, cols=fwd.cols,
                    vals=fwd.vals, n_rows=g.n_rows, n_cols=g.n_cols)


# ---------------------------------------------------------------------------
# Layouts built on the tensors' own device
# ---------------------------------------------------------------------------
#
# For graphs made anew every view (AutoCF's and GFormer's), a host build
# would copy the edges to the host and back each time.  These functions sort
# on the edges' device and give, field for field, what the host build gives for
# the same edges; the host build stays the reference.  Sizes the host must
# know (the flags, the split plan's counts) are read back in one transfer per
# build, and lists whose length that read gives are compacted by a scatter
# rather than by boolean indexing, which would read its own size.

def stable_order(keys: torch.Tensor, n_keys: int):
    """``(sorted keys int64, stable argsort int64, indptr int64 [n_keys+1])``
    of int ``keys`` in ``[0, n_keys)``, on their device, without a host read:
    ``indptr[k]`` counts the keys below ``k``."""
    sorted_keys, order = torch.sort(keys.long(), stable=True)
    bounds = torch.arange(n_keys + 1, device=keys.device)
    return sorted_keys, order, torch.searchsorted(sorted_keys, bounds)


def compact(mask: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """``values[mask]`` given its length ``n``, with no host read: each kept
    value scattered to its rank, the others to a slot past the end."""
    rank = torch.cumsum(mask, 0) - 1
    out = values.new_empty(n + 1)
    out.scatter_(0, torch.where(mask, rank, n), values)
    return out[:n]


def _is_arange(t: torch.Tensor) -> torch.Tensor:
    return (t == torch.arange(t.shape[0], device=t.device)).all()


def csr_graph_from_edges(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
                         n_cols: int) -> CsrGraph:
    """Both layouts of the all-ones operator ``A[rows[e], cols[e]] += 1``
    built on the edges' device: unsorted int ``rows`` / ``cols`` [nnz], which
    are the original edge order (duplicates and self loops allowed).

    Each layout sorts its destinations stably, so it equals the host build
    ``csr_layout(dst[o], src[o], ones, o, …)`` with ``o`` the stable argsort
    of its destinations, field for field; for row-sorted edges that is what
    :func:`build_csr_graph` gives.  One host read: both layouts'
    ``ids_identity`` and the ids' range, which is checked.
    """
    dev, nnz = rows.device, rows.shape[0]
    if cols.shape != (nnz,):
        raise ValueError(f"csr_graph_from_edges: rows {tuple(rows.shape)}, "
                         f"cols {tuple(cols.shape)}")
    ones = torch.ones(nnz, dtype=torch.float32, device=dev)

    def layout(dst, src, n_dst, n_src):
        keys, order, indptr = stable_order(dst, n_dst)
        return CsrLayout(indptr=indptr.int(), rows=keys.int(), cols=src[order].int(),
                         vals=ones, edge_ids=order.int(), n_rows=int(n_dst),
                         n_cols=int(n_src), ids_identity=True, vals_ones=True, plans=PlanCache())

    fwd = layout(rows, cols, n_rows, n_cols)
    bwd = layout(cols, rows, n_cols, n_rows)
    if nnz:
        fwd_id, bwd_id, r_lo, r_hi, c_lo, c_hi = torch.stack([
            t.long() for t in (_is_arange(fwd.edge_ids), _is_arange(bwd.edge_ids),
                               rows.min(), rows.max(), cols.min(), cols.max())]).tolist()
        if r_lo < 0 or r_hi >= n_rows or c_lo < 0 or c_hi >= n_cols:
            raise ValueError(f"csr_graph_from_edges: ids out of range for "
                             f"{n_rows} x {n_cols}")
        fwd = fwd._replace(ids_identity=bool(fwd_id))
        bwd = bwd._replace(ids_identity=bool(bwd_id))
    return CsrGraph(fwd=fwd, bwd=bwd, rows=rows.int(), cols=cols.int(), vals=ones,
                    n_rows=int(n_rows), n_cols=int(n_cols))


# ---------------------------------------------------------------------------
# Split plan: rows cut into chunks of at most T edges
# ---------------------------------------------------------------------------

FAN_IN = 16
"""R: the most partials one node of a split row's combine tree sums (see
:class:`SplitPlan`).  A row of up to R chunks is summed by one node, in
chunk order (every row of LightGCN's hop at d 32: at most 502 edges in
chunks of 32); KMCLR's pad row, 30,041 chunks at d 32, by a tree of depth 4.
PERF.md has the sweep (``chip_compare.py --sweep``) that chose it."""


class SplitPlan(NamedTuple):
    """The kernel's work list for one layout and threshold ``t``.

    Chunk ``c`` sums the edges ``[chunk_ptr[c], chunk_ptr[c+1])``, all of row
    ``chunk_row[c]``; a row of ``n > t`` edges has ``⌈n/t⌉`` chunks, in edge
    order, the others one, an empty row none.  ``chunk_dst[c]`` is the row
    for a whole row's chunk, else ``-1 - slot`` with ``slot`` its partial,
    a row's chunks taking consecutive slots in chunk order; ``split_rows``
    [n_split] are the rows with several chunks; ``empty_rows`` are written 0.
    ``n_slots`` is the number of chunk partials.

    The split rows' combine tree: a node sums at most ``fan_in`` consecutive
    partials of one row, those in ``[node_ptr[j], node_ptr[j+1])``, in slot
    order, and writes ``node_dst[j]``: the row for a row's last node (its
    root), else ``-1 - slot`` with ``slot`` a partial of the next level.  A
    row's partials of one level are cut into runs of ``fan_in`` from its
    first; nodes are ordered by level, then row, and the partials they write
    follow the chunk partials in that order, so each level's nodes cover the
    previous level's partials in order and ``node_ptr`` rises from 0 to
    ``n_partials``; the first ``n_first`` nodes are the first level's, over
    the chunk partials.  ``slot_node`` [n_partials] is each partial's node;
    ``arrivals`` [n_nodes] are the kernel's arrival counters, zero between
    calls.  All tensors int32.
    """

    t: int
    chunk_ptr: torch.Tensor
    chunk_row: torch.Tensor
    chunk_dst: torch.Tensor
    empty_rows: torch.Tensor
    split_rows: torch.Tensor
    n_slots: int
    fan_in: int
    n_first: int
    node_ptr: torch.Tensor
    node_dst: torch.Tensor
    slot_node: torch.Tensor
    arrivals: torch.Tensor

    @property
    def n_chunks(self) -> int:
        return self.chunk_row.shape[0]

    @property
    def n_partials(self) -> int:
        return self.slot_node.shape[0]


def _host_tree(n_split: np.ndarray, rows: np.ndarray, r: int):
    """``(node_ptr, node_dst, slot_node, n_first)`` of the combine tree over
    split rows ``rows`` of ``n_split`` chunk partials each (numpy, int64)."""
    counts, lo = n_split, 0          # partials per live row at this level; its first slot
    ptr, dst, owner, n_nodes = [], [], [], 0
    while counts.size:
        nodes = -(-counts // r)
        first = lo + np.cumsum(counts) - counts              # each row's first partial
        first_node = n_nodes + np.cumsum(nodes) - nodes
        node_row = np.repeat(np.arange(rows.size), nodes)
        k = np.arange(nodes.sum()) - np.repeat(first_node - n_nodes, nodes)
        ptr.append(first[node_row] + k * r)
        root = nodes[node_row] == 1
        nxt = lo + counts.sum()                              # this level's first new partial
        dst.append(np.where(root, rows[node_row], -1 - (nxt + np.cumsum(~root) - 1)))
        slot_row = np.repeat(np.arange(rows.size), counts)
        pos = np.arange(counts.sum()) - np.repeat(first - lo, counts)
        owner.append(first_node[slot_row] + pos // r)
        n_nodes += int(nodes.sum())
        lo = nxt
        counts, rows = nodes[nodes > 1], rows[nodes > 1]
    empty = np.zeros(0, np.int64)
    return (np.concatenate(ptr + [[lo]]), np.concatenate(dst or [empty]),
            np.concatenate(owner or [empty]), ptr[0].size if ptr else 0)


def split_plan(indptr_t: torch.Tensor, t: int, fan_in: int = FAN_IN) -> SplitPlan:
    """The chunks of the rows of ``indptr_t`` under threshold ``t`` and their
    combine tree of fan-in ``fan_in``, built on the host and placed on
    ``indptr_t``'s device; see :class:`SplitPlan`.  The reference for
    :func:`device_split_plan`, which B1 uses."""
    if t < 1 or fan_in < 2:
        raise ValueError(f"split threshold must be >= 1 and fan-in >= 2, got {t}, {fan_in}")
    device = indptr_t.device
    indptr = indptr_t.cpu().numpy().astype(np.int64)
    deg = np.diff(indptr)
    live = np.flatnonzero(deg)
    per_row = -(-deg[live] // t)                         # chunks of each live row
    chunk_row = np.repeat(live, per_row)
    first = np.cumsum(per_row) - per_row                 # each live row's first chunk
    k = np.arange(chunk_row.size) - np.repeat(first, per_row)
    chunk_ptr = np.append(indptr[chunk_row] + k * t, indptr[-1])
    split = per_row > 1
    in_split = np.repeat(split, per_row)
    slot = np.cumsum(in_split) - 1
    chunk_dst = np.where(in_split, -1 - slot, chunk_row)
    node_ptr, node_dst, slot_node, n_first = _host_tree(per_row[split], live[split], fan_in)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return SplitPlan(t=int(t), chunk_ptr=t32(chunk_ptr), chunk_row=t32(chunk_row),
                     chunk_dst=t32(chunk_dst), empty_rows=t32(np.flatnonzero(deg == 0)),
                     split_rows=t32(live[split]), n_slots=int(in_split.sum()),
                     fan_in=int(fan_in), n_first=int(n_first),
                     node_ptr=t32(node_ptr),
                     node_dst=t32(node_dst), slot_node=t32(slot_node),
                     arrivals=t32(np.zeros(node_dst.size)))


def _tree_levels(fan_in: int) -> int:
    """Levels enough for any row of fewer than 2**31 chunks."""
    levels = 1
    while fan_in ** levels < 2 ** 31:
        levels += 1
    return levels


def device_split_plan(indptr_t: torch.Tensor, t: int, fan_in: int = FAN_IN) -> SplitPlan:
    """:func:`split_plan` built on ``indptr_t``'s own device, field for field
    equal to it, with one host read (the numbers of chunks, split rows,
    partials and empty rows, and the tree's rows, partials and nodes a
    level) and no copy of the layout to the host.  A split row of ``n``
    chunks is live at level ``k`` (from 0) while ``n > R^k`` (``R`` the
    fan-in): it then has ``⌈n / R^k⌉`` partials and ``⌈n / R^(k+1)⌉`` nodes
    there."""
    if t < 1 or fan_in < 2:
        raise ValueError(f"split threshold must be >= 1 and fan-in >= 2, got {t}, {fan_in}")
    dev = indptr_t.device
    indptr = indptr_t.long()
    deg = indptr[1:] - indptr[:-1]
    per_row = (deg + (t - 1)) // t                       # 0 for an empty row
    split, empty = per_row > 1, deg == 0
    leaves = per_row * split                             # a split row's chunk partials
    power = fan_in ** torch.arange(_tree_levels(fan_in) + 1, device=dev)
    ceil_at = (leaves[None, :] + power[:, None] - 1) // power[:, None]
    live = leaves[None, :] > power[:-1, None]            # [level, row]
    sizes = torch.cat([torch.stack([per_row.sum(), split.sum(), empty.sum()]),
                       live.sum(1), (ceil_at[:-1] * live).sum(1),
                       (ceil_at[1:] * live).sum(1)]).tolist()
    n_chunks, n_split, n_empty = sizes[:3]
    n_levels = power.shape[0] - 1
    live_at, items_at, nodes_at = (sizes[3 + i * n_levels:3 + (i + 1) * n_levels]
                                   for i in range(3))
    row_ids = torch.arange(deg.shape[0], device=dev)
    chunk_row = torch.repeat_interleave(row_ids, per_row, output_size=n_chunks)
    first = torch.cumsum(per_row, 0) - per_row           # each row's first chunk
    k = torch.arange(n_chunks, device=dev) - first[chunk_row]
    chunk_ptr = torch.cat([indptr[chunk_row] + k * t, indptr[-1:]])
    in_split = split[chunk_row]
    slot = torch.cumsum(in_split, 0) - 1
    chunk_dst = torch.where(in_split, -1 - slot, chunk_row)
    ptr, dst, owner = [], [], []
    lo = n_nodes = 0                                     # the level's first partial; nodes so far
    for level in range(n_levels):
        n_live, n_items, n_new = live_at[level], items_at[level], nodes_at[level]
        if n_live == 0:
            break
        rows = compact(live[level], row_ids, n_live)
        counts, nodes = ceil_at[level, rows], ceil_at[level + 1, rows]
        first_p = lo + torch.cumsum(counts, 0) - counts  # each row's first partial
        first_node = n_nodes + torch.cumsum(nodes, 0) - nodes
        local = torch.arange(n_live, device=dev)
        node_row = torch.repeat_interleave(local, nodes, output_size=n_new)
        j = torch.arange(n_new, device=dev) - (first_node - n_nodes)[node_row]
        ptr.append(first_p[node_row] + j * fan_in)
        root = nodes[node_row] == 1
        nxt = lo + n_items                               # this level's first new partial
        dst.append(torch.where(root, rows[node_row], -1 - (nxt + torch.cumsum(~root, 0) - 1)))
        slot_row = torch.repeat_interleave(local, counts, output_size=n_items)
        pos = torch.arange(n_items, device=dev) - (first_p - lo)[slot_row]
        owner.append(first_node[slot_row] + pos // fan_in)
        n_nodes += n_new
        lo = nxt
    none = indptr.new_zeros(0)
    return SplitPlan(t=int(t), chunk_ptr=chunk_ptr.int(), chunk_row=chunk_row.int(),
                     chunk_dst=chunk_dst.int(), empty_rows=compact(empty, row_ids, n_empty).int(),
                     split_rows=compact(split, row_ids, n_split).int(),
                     n_slots=int(items_at[0]), fan_in=int(fan_in), n_first=int(nodes_at[0]),
                     node_ptr=torch.cat(ptr + [indptr.new_full((1,), lo)]).int(),
                     node_dst=torch.cat(dst or [none]).int(),
                     slot_node=torch.cat(owner or [none]).int(),
                     arrivals=torch.zeros(n_nodes, dtype=torch.int32, device=dev))


NARROW_D = 4
"""Widths up to this take the kernel's narrow mode: each lane of a chunk's
group sums its own edges for all features, the group adds them by a
butterfly."""


def lane_group(d: int, mean_degree: float = 0.0) -> int:
    """Lanes per chunk at width ``d``: one per 8 values of a row (two
    16-byte vectors of float32, one of bf16 in the bf16 mode's cast rows), a
    power of two from 4 to 32; where ``d % 4`` (one value a load), one per
    two values and at least 8.  Two float32 vectors a lane keep more gathers
    in flight than one, and more chunks share a warp; a lane of bf16 rows
    holds one vector and four edges in flight (at half the lanes it is
    slower: MAERec's hop at d 64 0.0299 ms in 4 lanes, 0.0271 in 8); PERF.md
    has the sweeps over widths that chose this.  At ``d <= NARROW_D`` (the
    narrow mode, where the lanes take edges, four in flight each) a power of
    two from 4 to 16 near a quarter of the layout's mean row length
    ``mean_degree``: no one width fits both AdaGCL's gate rows (3.5 edges a
    row, fastest at 2-4 lanes) and DCRec_seq's and MAERec's item graphs (17
    and 40 a row, fastest at 16 with longer chunks), as PERF.md's sweep
    (``chip_compare.py --sweep``) shows."""
    if d <= NARROW_D:
        want = max(1, int(np.ceil(mean_degree / 4)))
        return min(16, max(4, 1 << (want - 1).bit_length()))
    if d % 4 == 0:
        return min(32, max(4, 1 << (-(-d // 8) - 1).bit_length()))
    return min(32, max(8, 1 << (-(-d // 2) - 1).bit_length()))


def mean_degree(layout: CsrLayout) -> float:
    """Edges a row of ``layout``, on average: :func:`lane_group` takes it."""
    return layout.cols.shape[0] / max(layout.n_rows, 1)


@functools.cache
def resident_threads(device_index: int) -> int:
    """Threads the card holds resident at once: its SMs × threads per SM."""
    p = torch.cuda.get_device_properties(device_index)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def split_threshold(nnz: int, group: int, resident: int, row_bytes: int = 4) -> int:
    """T: about twice the edges each lane group gets when the card's
    ``resident`` threads, in groups of ``group``, share ``nnz`` evenly, as a
    power of two from 32 to 1024, so that no chunk outlasts the rest of the
    grid by much and short rows stay whole.  Over bf16 rows (``row_bytes``
    2) half that, so that a chunk gathers the bytes it would over float32
    rows: PERF.md's sweep found it fastest at every hop it timed (LightGCN's
    T 16, MAERec's 32, DCRec_seq's 16)."""
    per_group = 2 * nnz * group / resident
    t = min(1024, max(32, 1 << max(0, int(np.ceil(per_group)) - 1).bit_length()))
    return t * row_bytes // 4


def layout_plan(layout: CsrLayout, t: int) -> SplitPlan:
    """The split plan of ``layout`` at ``t``, built once on the layout's
    device (:func:`device_split_plan`) and cached on the layout."""
    if t not in layout.plans:
        layout.plans[t] = device_split_plan(layout.indptr, t)
    return layout.plans[t]


def _ordered_sums(items: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                  lanes: int) -> torch.Tensor:
    """Each run ``items[starts[i]:starts[i] + lengths[i]]`` summed as a group
    of ``lanes`` lanes of the kernel sums it: lane ``l`` adds the items
    ``l, l + lanes, …`` in order, then the butterfly adds lane ``l ^ off``'s
    sum for ``off = lanes/2, …, 1``, and lane 0's is the result (one lane:
    the items in order)."""
    acc = items.new_zeros(starts.shape[0], lanes, items.shape[1])
    lane = torch.arange(lanes, device=items.device)
    for k in range(-(-int(lengths.max()) // lanes) if lengths.numel() else 0):
        pos = k * lanes + lane
        live = pos[None, :] < lengths[:, None]
        at = torch.where(live, starts[:, None] + pos[None, :], 0)
        acc = torch.where(live[..., None], acc + items[at], acc)
    off = lanes // 2
    while off:
        acc = acc + acc[:, lane ^ off]
        off //= 2
    return acc[:, 0]


def csr_spmm_split_plain(layout: CsrLayout, plan: SplitPlan, x: torch.Tensor,
                         ew=None, group: int | None = None) -> torch.Tensor:
    """Plain PyTorch emulation of the kernel's schedule, for tests: each
    chunk's sum, then the combine tree's nodes level by level, each sum in
    the kernel's order: in order where the lanes hold features (d >
    ``NARROW_D``), else lane-strided over ``group`` lanes (default
    :func:`lane_group`) with the butterfly."""
    d = x.shape[1]
    lanes = (group or lane_group(d)) if d <= NARROW_D else 1
    contrib = _contributions(layout, x, ew)
    ptr = plan.chunk_ptr.long()
    sums = _ordered_sums(contrib, ptr[:-1], torch.diff(ptr), lanes)
    out = torch.zeros(layout.n_rows, d, dtype=x.dtype, device=x.device)
    part = torch.zeros(plan.n_partials, d, dtype=x.dtype, device=x.device)
    dst = plan.chunk_dst.long()
    out[dst[dst >= 0]] = sums[dst >= 0]
    part[-1 - dst[dst < 0]] = sums[dst < 0]
    node_ptr, node_dst = plan.node_ptr.long(), plan.node_dst.long()
    j, ready = 0, plan.n_slots               # a level's nodes read the partials below `ready`
    while j < node_dst.shape[0]:
        j1 = int(torch.searchsorted(node_ptr, ready))
        sums = _ordered_sums(part, node_ptr[j:j1], torch.diff(node_ptr[j:j1 + 1]), lanes)
        nd = node_dst[j:j1]
        out[nd[nd >= 0]] = sums[nd >= 0]
        part[-1 - nd[nd < 0]] = sums[nd < 0]
        j, ready = j1, ready + int((nd < 0).sum())
    return out


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load_kernel("csr_spmm", "csr_spmm_f32",
                       [p, p, i, p, i, p, p, p, p, i, p, p, p, p, p, ctypes.c_uint,
                        ctypes.c_float, i, p, p, p, i, i, i, p])


@functools.lru_cache(maxsize=1)
def bf16_mode() -> bool:
    """Whether ``SSLREC_PALLAS_PRECISION`` is ``default`` (read once, as the
    JAX package's ``_mxu_precision``; ``bf16_mode.cache_clear()`` rereads it).

    The JAX package's mode: its hops gather ``bf16(x)`` and multiply by
    ``bf16(vals·w)`` in bf16, and the TPU's one-pass matmul rounds every
    segment sum's contribution to bf16, each summed in float32.  Here every
    B1 call, hop or segment sum, forms ``bf16(bf16(x[col]) · bf16(vals·w))``
    and sums it in float32 (for a segment sum, whose values are 1, that is
    ``bf16(x)``); the backward pass's hops follow the same mode, and a learned
    weight's gradient stays float32."""
    return os.environ.get("SSLREC_PALLAS_PRECISION", "highest").lower() == "default"


CAST_READS = 2.0
"""The bf16 mode casts x to bf16 rows before the kernel where a layout
gathers each row of x at least this often on average (``nnz / n_cols``),
so the cast's pass over x pays for itself in the halved gathers (from 3.5
reads a row, LightGCN's hop, on); below it (a segment sum reads each row
once: there the cast took 0.039 of 0.058 ms) the kernel rounds float32 rows
as it loads them.  At ``d <= NARROW_D`` the rows are always cast.  PERF.md
has the sweep (``chip_compare.py --sweep``) that chose it."""


def bf16_rows(layout: CsrLayout, d: int) -> bool:
    """Whether the bf16 mode gathers ``layout``'s x at width ``d`` as bf16
    rows, cast before the kernel (else float32 rows rounded on load): at
    ``d <= NARROW_D``, and where ``d % 8 == 0`` (a lane's 16-byte vector of
    8 values) and each row of x is read ``CAST_READS`` times or more."""
    return d <= NARROW_D or (d % 8 == 0 and
                             layout.cols.shape[0] >= CAST_READS * max(layout.n_cols, 1))


def row_bytes(layout: CsrLayout, d: int) -> int:
    """Bytes of a value of the rows the kernel gathers for ``layout`` at
    width ``d`` in the precision mode (:func:`bf16_mode`): 2 for bf16 rows,
    else 4."""
    return 2 if bf16_mode() and bf16_rows(layout, d) else 4


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _contributions(layout: CsrLayout, x: torch.Tensor, ew) -> torch.Tensor:
    """Each slot's ``vals[e]·w(e)·x[cols[e]]``, rounded as the mode says."""
    ev = _edge_values(layout, ew)
    if bf16_mode():
        return _round_bf16(_round_bf16(x[layout.cols]) * _round_bf16(ev).to(x.dtype)[:, None])
    return ev[:, None] * x[layout.cols]


def _edge_values(layout: CsrLayout, ew) -> torch.Tensor:
    """``vals[e]·w(e)`` per slot of ``layout``."""
    if ew is None:
        return layout.vals
    if isinstance(ew, PrfMask):
        return layout.vals * ew.at(layout.edge_ids)
    return layout.vals * ew[layout.edge_ids]


def csr_spmm_plain(layout: CsrLayout, x: torch.Tensor, ew=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same sum through ``index_add_``,
    in the precision mode (:func:`bf16_mode`)."""
    out = torch.zeros(layout.n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, layout.rows, _contributions(layout, x, ew))


def _check(layout: CsrLayout, x: torch.Tensor, ew):
    def need(cond, what):
        if not cond:
            raise ValueError(f"csr_spmm: {what}")

    need(x.dim() == 2 and x.shape[0] == layout.n_cols,
         f"x must be [{layout.n_cols}, d], got {tuple(x.shape)}")
    need(x.dtype == torch.float32 and x.is_contiguous(), "x must be contiguous float32")
    need(layout.indptr.shape == (layout.n_rows + 1,), "indptr must be [n_rows+1]")
    nnz = layout.cols.shape[0]
    n_ids = nnz if layout.n_ids is None else layout.n_ids
    for name in ("indptr", "cols", "edge_ids"):
        t = getattr(layout, name)
        need(t.dtype == torch.int32 and t.is_contiguous(), f"{name} must be contiguous int32")
        need(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
    need(layout.vals.dtype == torch.float32 and layout.vals.is_contiguous()
         and layout.vals.shape == (nnz,), "vals must be contiguous float32 [nnz]")
    need(layout.vals.device == x.device, "vals must be on x's device")
    if isinstance(ew, PrfMask):
        need(ew.ndim == 1, "a PrfMask with several salts must be indexed by layer first")
        need(ew.nnz == n_ids, f"PrfMask over {ew.nnz} edges, layout has {n_ids}")
        k = ew.key
        need(k.shape == (2,) and k.dtype == torch.int64 and k.is_contiguous(),
             "PrfMask key must be contiguous int64 [2]")
        need(k.device == x.device, f"PrfMask key is on {k.device}, x on {x.device}")
    elif ew is not None:
        need(ew.shape == (n_ids,) and ew.dtype == torch.float32 and ew.is_contiguous(),
             f"edge weight must be contiguous float32 [{n_ids}]")
        need(ew.device == x.device, "edge weight must be on x's device")


def csr_spmm(layout: CsrLayout, x: torch.Tensor, ew=None) -> torch.Tensor:
    """``out[r] = Σ_e vals[e]·w(e)·x[cols[e]]`` over ``layout``'s row ``r``.
    ``ew``: ``None`` (w = 1); a float32 [nnz] tensor in the original edge
    order (``w(e) = ew[edge_ids[e]]``); or a single-salt :class:`PrfMask`,
    evaluated inside the kernel.

    A CPU ``x`` takes :func:`csr_spmm_plain`; a CUDA ``x`` launches the kernel
    (in bf16 mode on a bf16 copy of ``x``, made here, where :func:`bf16_rows`
    says so, else on ``x`` itself, rounded as it loads) on the current
    stream with the lane group and split threshold that
    :func:`lane_group` and :func:`split_threshold` pick for ``d``, the layout's
    rows and the card, or raises.  ``csr_spmm.launches`` counts the launches of
    the chunk kernel, one a call; ``csr_spmm.combine_launches`` those of the
    second kernel that adds the split rows' partials by the plan's tree, one
    a call over a layout with split rows at ``d > NARROW_D`` (at ``d <=
    NARROW_D`` the chunk kernel's groups add them);
    ``csr_spmm.by_shape[(n_rows, n_cols)]`` both counts, ``[launches,
    combine_launches]``, of the layouts of that shape.
    """
    if x.device.type == "cpu":
        return csr_spmm_plain(layout, x, ew)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm: no kernel for device {x.device}")
    _check(layout, x, ew)
    group, t = schedule(layout, x.shape[1], resident_threads(x.device.index))
    return csr_spmm_at(layout, x, ew, group, layout_plan(layout, t))


def schedule(layout: CsrLayout, d: int, resident: int) -> tuple[int, int]:
    """The lane group and split threshold of a call over ``layout`` at width
    ``d`` on a card of ``resident`` threads, in the precision mode in
    force: :func:`lane_group` and :func:`split_threshold` over the rows the
    kernel gathers (:func:`row_bytes`)."""
    group = lane_group(d, mean_degree(layout))
    return group, split_threshold(layout.cols.shape[0], group, resident, row_bytes(layout, d))


def csr_spmm_at(layout: CsrLayout, x: torch.Tensor, ew, group: int,
                plan: SplitPlan, cast: bool | None = None) -> torch.Tensor:
    """The kernel launch of :func:`csr_spmm`, on operands it has checked, at
    lane group ``group`` and split plan ``plan`` (of ``layout``), which a
    schedule sweep may set, as may ``cast`` in the bf16 mode (bf16 rows cast
    before the kernel, or float32 rows rounded on load; default
    :func:`bf16_rows`); counted as :func:`csr_spmm` counts."""
    d = x.shape[1]
    out = torch.empty(layout.n_rows, d, dtype=torch.float32, device=x.device)
    if layout.n_rows == 0 or d == 0:
        return out
    partials = torch.empty(plan.n_partials, d, dtype=torch.float32, device=x.device)
    prf = ew if isinstance(ew, PrfMask) else None
    tensor_ew = None if prf is not None else ew
    mode = 0        # the kernel's: float32; bf16 on bf16 rows cast here (1) or on x (2)
    if bf16_mode():
        cast = bf16_rows(layout, d) if cast is None else cast or d <= NARROW_D
        if cast and d > NARROW_D and d % 8:
            raise ValueError(f"csr_spmm: bf16 rows need d % 8 == 0 at d > {NARROW_D}, got {d}")
        mode = 1 if cast else 2
    xk = x.to(torch.bfloat16) if mode == 1 else x
    err = _kernel()(
        plan.chunk_ptr.data_ptr(), plan.chunk_dst.data_ptr(), plan.n_chunks,
        plan.empty_rows.data_ptr(), plan.empty_rows.shape[0],
        plan.node_ptr.data_ptr(), plan.node_dst.data_ptr(), plan.slot_node.data_ptr(),
        plan.arrivals.data_ptr(), plan.n_first,
        layout.cols.data_ptr(), None if layout.vals_ones else layout.vals.data_ptr(),
        None if layout.ids_identity or ew is None else layout.edge_ids.data_ptr(),
        None if tensor_ew is None else tensor_ew.data_ptr(),
        None if prf is None else prf.key.data_ptr(),
        0 if prf is None else prf.salts & _U32,
        1.0 if prf is None else prf.keep_rate,
        int(prf is not None and prf.resize_val),
        xk.data_ptr(), out.data_ptr(), partials.data_ptr(), d, group.bit_length() - 1,
        mode, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"csr_spmm: launch of libcsr_spmm.so's kernel failed: "
                           f"cudaError {err}")
    counts = csr_spmm.by_shape.setdefault((layout.n_rows, layout.n_cols), [0, 0])
    csr_spmm.launches += 1
    counts[0] += 1
    if plan.n_first and d > NARROW_D:
        csr_spmm.combine_launches += 1
        counts[1] += 1
    return out


csr_spmm.launches = csr_spmm.combine_launches = 0
csr_spmm.by_shape = {}


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class SpmmFn(torch.autograd.Function):
    """``A @ x`` with an optional learned per-edge weight (port of
    ``pallas_spmm``).  dx = Aᵀ(ew) g is the same kernel on the transposed
    layout; d ew[e] = vals[e]·⟨g[row_e], x[col_e]⟩ is a gather-dot in plain
    torch, computed only when the weight needs a gradient.  Under
    ``torch.func.vmap`` its rule is :func:`vmap_lanes`."""

    @staticmethod
    def forward(g: CsrGraph, x: torch.Tensor, ew: torch.Tensor | None):
        return csr_spmm(g.fwd, x.contiguous(), ew)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, x, ew = inputs
        ctx.graph = g
        ctx.save_for_backward(x, ew)

    @staticmethod
    def backward(ctx, grad):
        x, ew = ctx.saved_tensors
        g = ctx.graph
        grad = grad.contiguous()
        dx = csr_spmm(g.bwd, grad, ew) if ctx.needs_input_grad[1] else None
        dew = None
        if ew is not None and ctx.needs_input_grad[2]:
            dew = g.vals * (grad[g.rows] * x[g.cols]).sum(-1)
        return None, dx, dew

    @staticmethod
    def vmap(info, in_dims, g, x, ew):
        return vmap_lanes(SpmmFn, info, in_dims, g, x, ew)


class SpmmPvFn(torch.autograd.Function):
    """``(W∘A) @ x`` with a constant multiplier ``W`` (port of
    ``pallas_spmm_pv``): a materialised [nnz] tensor, or a :class:`PrfMask`
    whose key and salt are all that is kept for the backward.  The
    multiplier gets no cotangent; dx is the kernel on the transposed layout.
    Under ``torch.func.vmap`` its rule is :func:`vmap_lanes`."""

    @staticmethod
    def forward(g: CsrGraph, x: torch.Tensor, w):
        return csr_spmm(g.fwd, x.contiguous(), w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, _, w = inputs
        ctx.graph, ctx.prf = g, w if isinstance(w, PrfMask) else None
        if ctx.prf is None:
            ctx.save_for_backward(w)

    @staticmethod
    def backward(ctx, grad):
        w = ctx.prf if ctx.prf is not None else ctx.saved_tensors[0]
        return None, csr_spmm(ctx.graph.bwd, grad.contiguous(), w), None

    @staticmethod
    def vmap(info, in_dims, g, x, w):
        return vmap_lanes(SpmmPvFn, info, in_dims, g, x, w)


# ---------------------------------------------------------------------------
# Lanes: the Functions' rule under torch.func.vmap
# ---------------------------------------------------------------------------
#
# The tuner's lanes (trainer/lanes.py) run K trials of a grid as one model
# under torch.func.vmap.  A Function's vmap rule is handed the physical
# tensors and, for each operand, the dimension that holds the lanes (None
# for a tensor that no lane owns: the graph, a dropout key, a constant
# mask).  Where only the dense operand has lanes, they are laid side by side
# in its feature dimension, [n, K, d] -> [n, K·d], and the Function runs
# once: every column of B1's sum is independent of the others, so each
# lane's d columns are what that lane alone would give, forward and
# backward.  The output keeps the lanes next to the features (out_dims 1),
# so that the next hop's fold is a view.  Where the weight has lanes (DCCF's
# learned edge weight, a function of each lane's parameters) every lane
# takes its own call.

def has_lanes(dims) -> bool:
    """Whether an operand's ``in_dims`` entry (an int, None, or a structure of
    them for a :class:`PrfMask`) gives any of its tensors a lane dimension."""
    return any(d is not None for d in pytree.tree_leaves(dims))


def lane_of(arg, dims, i: int):
    """Lane ``i`` of an operand whose lane dimension ``dims`` gives
    (contiguous, as the kernel wants its weights)."""
    if isinstance(arg, PrfMask):
        return arg._replace(key=lane_of(arg.key, dims.key, i))
    if isinstance(arg, torch.Tensor) and dims is not None:
        return arg.select(dims, i).contiguous()
    return arg


def vmap_lanes(fn, info, in_dims, op, x, *w):
    """The vmap rule of a Function ``fn.apply(op, x[, w])`` whose output rows
    mix ``x``'s rows and never its columns (B1's hops and segment sums, a
    gather).  ``op`` (the graph or segment layout) has no lanes.  With no
    lanes in ``w``: one call on ``x`` folded to ``[n, K·d]``, returned as
    ``[m, K, d]`` at ``out_dims`` 1.  Else one call a lane, stacked at 0."""
    k = info.batch_size
    op_dims, x_dims, *w_dims = in_dims
    if has_lanes(op_dims):
        raise ValueError(f"{fn.__name__}: the graph or layout cannot have lanes")
    if not any(has_lanes(d) for d in w_dims):
        lanes = x.movedim(x_dims, 1)                        # [n, K, ...]
        out = fn.apply(op, lanes.reshape(lanes.shape[0], -1), *w)
        return out.view(out.shape[0], k, *lanes.shape[2:]), 1
    outs = [fn.apply(op, lane_of(x, x_dims, i), *(lane_of(a, d, i) for a, d in zip(w, w_dims)))
            for i in range(k)]
    return torch.stack(outs), 0


# ---------------------------------------------------------------------------
# Edge dropout from a counter-mode PRF, bit-exact with the JAX package
# ---------------------------------------------------------------------------
#
# uint32 arithmetic is held in int64 tensors, masked to 32 bits after every
# add and shift (torch's uint32 support is incomplete).  The kernel evaluates
# the same function in uint32 registers (csrc/csr_spmm.cu, dropout_keep).

_U32 = 0xFFFFFFFF


def _rotl32(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _U32


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, the schedule of jax.random's bit generator,
    at counter arrays ``c0``/``c1`` (int64 tensors holding uint32 values)."""
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _U32
    x1 = (c1 + ks[1]) & _U32
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of a raw key (two uint32 values in an int64 tensor
    [2]) into ``num`` keys ``[num, 2]``, bit for bit, in the threefry mode
    where ``jax_threefry_partitionable`` is set (JAX's default since 0.5): key
    ``i`` is Threefry-2x32 of the 64-bit counter ``i`` as (hi, lo) words."""
    key = key.to(torch.int64)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([x0, x1], dim=-1)


def _prf_uniform(key: torch.Tensor, counts: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform [0, 1) float32 at ``counts`` from a ``key`` of two uint32 values
    (an int64 tensor [2]); equal to the JAX package's ``_prf_uniform``."""
    key = key.to(device=counts.device, dtype=torch.int64)
    c0 = counts.to(torch.int64) & _U32
    c1 = torch.full_like(c0, int(salt) & _U32)
    bits, _ = _threefry2x32(key[0], key[1], c0, c1)
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _prf_keep(key, counts, salt: int, keep_rate: float, resize_val: bool) -> torch.Tensor:
    """``floor(U + keep_rate)`` (÷ keep_rate with ``resize_val``) at ``counts``."""
    kr = torch.tensor(keep_rate, dtype=torch.float32, device=counts.device)
    keep = torch.floor(_prf_uniform(key, counts, salt) + kr)
    return keep / kr if resize_val else keep


class EdgeMask(NamedTuple):
    """A constant per-edge multiplier in the original edge order (port of
    ``PaddedEdgeWeight``).  :func:`~sslrec_tpu_torch.ops.spmm.spmm` routes it
    to :class:`SpmmPvFn`, and each layout reads it through its ``edge_ids``."""

    w: torch.Tensor

    @property
    def ndim(self) -> int:
        return self.w.dim()

    def layer(self, i: int) -> "EdgeMask":
        return EdgeMask(self.w[i])


class PrfMask(NamedTuple):
    """Bernoulli(keep_rate) edge dropout ``floor(U(e) + keep_rate)`` (÷
    keep_rate with ``resize_val``), ``U(e)`` the PRF of original edge id
    ``e`` under ``key`` (int64 [2] holding uint32 values, on the graph's
    device) and a salt: the JAX package's ``dropout_padded``, which each
    layout evaluates from its own edge ids.  B1 evaluates it inside the
    kernel, so no mask tensor exists on the card's path; ``w`` materialises
    it through the plain path.  Leading dimensions, outermost first: keys
    ``[V, 2]`` for one mask per view (SGL's two views), then ``salts`` as a
    tuple for one mask per layer; ``layer(i)`` picks index ``i`` of the
    outermost, as a stacked ``[V, L, nnz]`` mask would be indexed."""

    key: torch.Tensor
    salts: int | tuple
    keep_rate: float
    resize_val: bool
    nnz: int

    @property
    def ndim(self) -> int:
        return self.key.dim() + (0 if isinstance(self.salts, int) else 1)

    def layer(self, i: int) -> "PrfMask":
        if self.key.dim() == 2:
            return self._replace(key=self.key[i])
        return self._replace(salts=self.salts[i])

    def at(self, edge_ids: torch.Tensor) -> torch.Tensor:
        """The multipliers of original edge ids ``edge_ids`` (one key, one salt)."""
        return _prf_keep(self.key, edge_ids, self.salts, self.keep_rate, self.resize_val)

    @property
    def w(self) -> torch.Tensor:
        """The multiplier in the original edge order, ``[..., nnz]`` with the
        leading dimensions above."""
        if self.ndim == 1:
            return self.at(torch.arange(self.nnz, device=self.key.device))
        n = self.key.shape[0] if self.key.dim() == 2 else len(self.salts)
        return torch.stack([self.layer(i).w for i in range(n)])


def prf_mask(key: torch.Tensor, g: CsrGraph, keep_rate: float,
             salts: int | Sequence[int] = 0, resize_val: bool = False) -> PrfMask:
    """The :class:`PrfMask` of ``g`` under ``key`` (``[2]``, or ``[V, 2]`` for
    one mask per view; moved to ``g``'s device)."""
    salts = int(salts) if isinstance(salts, (int, np.integer)) else tuple(map(int, salts))
    return PrfMask(key=key.to(device=g.vals.device, dtype=torch.int64).contiguous(),
                   salts=salts, keep_rate=float(keep_rate), resize_val=bool(resize_val),
                   nnz=g.nnz)


def dropout_mask(key: torch.Tensor, g: CsrGraph, keep_rate: float,
                 salts: int | Sequence[int] = 0,
                 resize_val: bool = False) -> EdgeMask:
    """The materialised :class:`EdgeMask` of :func:`prf_mask`: Bernoulli
    (keep_rate) ``floor(U + keep_rate)`` with ``U`` the PRF of the original
    edge id (port of ``dropout_padded``).  Both layouts read the one mask
    through their edge ids, so an edge is kept or dropped alike in the
    forward and the transposed hop.  A sequence of ``salts`` stacks one mask
    per salt along a leading dimension."""
    return EdgeMask(prf_mask(key, g, keep_rate, salts, resize_val).w)
