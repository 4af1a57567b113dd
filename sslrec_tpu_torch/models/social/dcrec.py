"""DcRec (social): dual-domain contrastive recommendation (port of
``sslrec_tpu/models/social/dcrec.py``).

A LightGCN tower over the UI bi-adjacency and a weightless relu-GCN tower
over the trust graph; each step draws two augmented UI views and two
augmented trust views (two distinct kinds of {edge add, edge drop, node
drop} per domain), passes the users of each view through the domain's
linear + relu head, and couples the views with GRACE semi-losses within each
domain (``domain_weight``) and across them (``cross_weight``), on top of BPR
and the picked embeddings' L2.

Every sum is B1.  A view's drops are weights on the fixed UI and trust
layouts (the exact-count edge drop: the ``n_aug`` smallest uniforms; the node
drop: ``n_drop_users`` rows); its added edges (``n_aug`` uniform pairs) get
a layout built on the card each step (``csr_graph_from_edges``), which keeps
duplicates, so an added edge that repeats a real one counts twice, as in the
JAX model.  A view's degrees are d 1 sums over both, its hops d-wide sums
over both.  The trust tower is ``D_r^-1/2 Aᵀ D_r^-1/2``: it sums into
columns, with row degrees.  The kinds are drawn on the card and read on the
host once a step, and a view whose kind adds no edge builds no layout.

Draws: the model sets ``step_generator``; :meth:`step_views` draws a step's
four views from the epoch's device generator, which a test injects through
``loss``'s ``views`` (JAX's ``_view`` draws as the port's view dicts).

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
the three tables (``row_shards``) and reads them whole with autograd
(``dist_train.ui_nodes``, ``whole_param``), so the base tower and every
view run on the whole graphs in every rank, with the views the single run
draws (every rank draws them alike from the epoch's generator and builds
their added edges' layouts itself); the heads are replicated.  BPR and the
picked embeddings' L2 are sums over the batch, which a ``data`` slice
scales by ``n_whole / b``; the GRACE terms are over the whole views and are
computed whole, alike on every rank, and counted once (split over the
``model`` ranks, such a contrast moves the tables by its float sum order:
HMGCR's GRACE did so beyond the mesh's tolerance on the card).
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.spmm import spmm, spmm_layers, spmm_t
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, csr_graph_from_edges
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params

EDGE_ADD, EDGE_DROP, NODE_DROP = 0, 1, 2
UI_TABLES = ("ui_user_embeds", "ui_item_embeds")
TABLES = ("ui_user_embeds", "uu_user_embeds", "ui_item_embeds")     # the init order
GRACE_CHUNK = 1024      # rows a chunk of grace_pair_losses (its recomputed unit)


def _inv_sqrt(deg):
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1e-12)), deg.new_zeros(()))


class DcRec(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.adj = data.extras["bi_adj"]
        self.ui_rows, self.ui_cols = data.train_users, data.train_items    # row-sorted
        self.t_rows, self.t_cols = data.extras["trust_edges"]              # row-sorted
        self.ui = csr_graph_from_edges(self.ui_rows, self.ui_cols, self.user_num, self.item_num)
        self.trust = csr_graph_from_edges(self.t_rows, self.t_cols, self.user_num,
                                          self.user_num)
        self.layer_num = int(m.layer_num)
        self.reg_weight = float(m.reg_weight)
        self.keep_rate = float(m.keep_rate)
        self.cross_weight = float(m.cross_weight)
        self.domain_weight = float(m.domain_weight)
        self.tau = float(m.tau)
        p = 1.0 - self.keep_rate
        self.n_aug_ui = int(p * self.ui.nnz)          # as many added as dropped
        self.n_aug_t = int(p * self.trust.nnz)
        self.n_drop_users = int(p * self.user_num)
        self.added_views = {"ui": 0, "uu": 0}         # views with added edges, so far
        d, device = self.embedding_size, data.device
        dist_train.row_tables(self, cfg, device, dict(zip(
            TABLES, ((self.user_num, d), (self.user_num, d), (self.item_num, d)))))
        self.ui_linear = linear_layer(d, d, device)
        self.uu_linear = linear_layer(d, d, device)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and ``nn.Linear``-default heads, drawn from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_rows(self, gen, TABLES)
        for lin in (self.ui_linear, self.uu_linear):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)

    # -- augmentation ------------------------------------------------------------
    def _draw_view(self, gen, kind: int, rows, n_rows: int, n_cols: int, n_aug: int) -> dict:
        """One view: ``{"w": [n_edges] weights of the fixed edges, "add": (rows,
        cols) of the added edges or None}``."""
        dev, n_edges = rows.device, rows.shape[0]
        w = torch.ones(n_edges, device=dev)
        add = None
        if kind == EDGE_DROP:
            u = torch.rand(n_edges, generator=gen, device=dev)
            w[torch.argsort(u)[:n_aug]] = 0.0
        elif kind == NODE_DROP:
            u = torch.rand(n_rows, generator=gen, device=dev)
            keep_row = torch.ones(n_rows, device=dev)
            keep_row[torch.argsort(u)[: self.n_drop_users]] = 0.0
            w = keep_row[rows.long()]
        else:
            add = (torch.randint(0, n_rows, (n_aug,), generator=gen, device=dev),
                   torch.randint(0, n_cols, (n_aug,), generator=gen, device=dev))
        return {"w": w, "add": add}

    def step_views(self, gen: torch.Generator) -> list:
        """A step's views ``[ui1, ui2, uu1, uu2]``: per domain an ordered pair
        of distinct kinds (one of the six pairs, uniformly), read on the host."""
        pairs = torch.randint(0, 6, (2,), generator=gen, device=gen.device).tolist()
        kinds = [k for r in pairs for k in (r // 2, (r // 2 + 1 + r % 2) % 3)]
        ui = (self.ui_rows, self.user_num, self.item_num, self.n_aug_ui)
        uu = (self.t_rows, self.user_num, self.user_num, self.n_aug_t)
        return [self._draw_view(gen, k, *spec) for k, spec in zip(kinds, (ui, ui, uu, uu))]

    def _added(self, view: dict, n_rows: int, n_cols: int):
        if view["add"] is None:
            return None
        return csr_graph_from_edges(*view["add"], n_rows, n_cols)

    # -- propagation ---------------------------------------------------------------
    def _lightgcn_base(self, embeds=None):
        """The base tower over ``[users; items]`` (``embeds``, else the UI
        tables read whole)."""
        embeds = dist_train.ui_nodes(self, UI_TABLES) if embeds is None else embeds
        acc = (embeds + spmm_layers(self.adj, embeds, self.layer_num).sum(0)) \
            / (self.layer_num + 1)
        return acc[: self.user_num], acc[self.user_num:]

    def _lightgcn_view(self, view: dict, embeds=None):
        """LightGCN over an augmented, renormalised UI graph, from ``[users;
        items]`` (``embeds``, else the UI tables read whole)."""
        w, add = view["w"], self._added(view, self.user_num, self.item_num)
        dev = w.device
        ones_i = torch.ones(self.item_num, 1, device=dev)
        ones_u = torch.ones(self.user_num, 1, device=dev)
        deg_u = spmm(self.ui, ones_i, EdgeMask(w))[:, 0]
        deg_i = spmm_t(self.ui, ones_u, EdgeMask(w))[:, 0]
        if add is not None:
            self.added_views["ui"] += 1
            deg_u = deg_u + spmm(add, ones_i)[:, 0]
            deg_i = deg_i + spmm_t(add, ones_u)[:, 0]
        du, di = _inv_sqrt(deg_u), _inv_sqrt(deg_i)
        ev = EdgeMask(w * du[self.ui_rows.long()] * di[self.ui_cols.long()])
        if add is not None:
            ev_add = EdgeMask(du[add.rows.long()] * di[add.cols.long()])
        embeds = dist_train.ui_nodes(self, UI_TABLES) if embeds is None else embeds
        u, i = embeds[: self.user_num], embeds[self.user_num:]
        acc_u, acc_i = u, i
        for _ in range(self.layer_num):
            nu, ni = spmm(self.ui, i, ev), spmm_t(self.ui, u, ev)
            if add is not None:
                nu, ni = nu + spmm(add, i, ev_add), ni + spmm_t(add, u, ev_add)
            u, i = nu, ni
            acc_u, acc_i = acc_u + u, acc_i + i
        n = self.layer_num + 1
        return acc_u / n, acc_i / n

    def _gcn_view(self, view: dict, users=None):
        """Weightless relu-GCN over an augmented trust graph, ``D_r^-1/2 Aᵀ D_r^-1/2``,
        from ``users`` (else the trust table read whole)."""
        w, add = view["w"], self._added(view, self.user_num, self.user_num)
        ones = torch.ones(self.user_num, 1, device=w.device)
        deg = spmm(self.trust, ones, EdgeMask(w))[:, 0]
        if add is not None:
            self.added_views["uu"] += 1
            deg = deg + spmm(add, ones)[:, 0]
        d = _inv_sqrt(deg)
        ve = EdgeMask(w * d[self.t_rows.long()])
        if add is not None:
            ve_add = EdgeMask(d[add.rows.long()])

        def prop(x):
            s = spmm_t(self.trust, x, ve)
            if add is not None:
                s = s + spmm_t(add, x, ve_add)
            return d[:, None] * s

        x = dist_train.whole_param(self, "uu_user_embeds") if users is None else users
        acc = x
        for _ in range(self.layer_num):
            x = torch.relu(prop(x))
            acc = acc + x
        return acc / (self.layer_num + 1)

    # -- objective -------------------------------------------------------------------
    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight, "cross_weight": self.cross_weight,
                "domain_weight": self.domain_weight}

    def loss(self, batch: dict, gen: torch.Generator | None, views: list | None = None):
        """BPR + L2 of the picked embeddings + the domain and cross GRACE
        terms; ``views`` (else drawn from ``gen``) as :meth:`step_views` gives.
        On a mesh the batch is a ``data`` slice, whose BPR and L2 scale by
        ``n_whole / b``."""
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        cross_w = hp.get("cross_weight", self.cross_weight)
        domain_w = hp.get("domain_weight", self.domain_weight)
        nodes = dist_train.ui_nodes(self, UI_TABLES)
        trust_users = dist_train.whole_param(self, "uu_user_embeds")
        user_embeds, item_embeds = self._lightgcn_base(nodes)
        if self.keep_rate >= 1.0:       # no augmentation: every view is the base graph
            uiu1 = uiu2 = user_embeds
            uii1 = uii2 = item_embeds
            uu1 = uu2 = self._gcn_view({"w": torch.ones_like(self.trust.vals), "add": None},
                                       trust_users)
        else:
            views = self.step_views(gen) if views is None else views
            uiu1, uii1 = self._lightgcn_view(views[0], nodes)
            uiu2, uii2 = self._lightgcn_view(views[1], nodes)
            uu1, uu2 = self._gcn_view(views[2], trust_users), self._gcn_view(views[3], trust_users)

        def head(lin, x):
            return torch.relu(apply_linear(lin, x))

        uiu1, uiu2 = head(self.ui_linear, uiu1), head(self.ui_linear, uiu2)
        uu1, uu2 = head(self.uu_linear, uu1), head(self.uu_linear, uu2)

        anc_e = user_embeds[batch["user"]]
        pos_e, neg_e = item_embeds[batch["pos"]], item_embeds[batch["neg"]]
        bpr = losses.bpr_loss(anc_e, pos_e, neg_e)
        pu = losses.grace_pair_losses([uu1, uu2, uiu1, uiu2], self.tau, GRACE_CHUNK)
        pi = losses.grace_pair_losses([uii1, uii2], self.tau, GRACE_CHUNK)

        def gca(a, b):
            return 0.5 * (pu[(a, b)] + pu[(b, a)])

        cross = cross_w * (gca(0, 2) + gca(0, 3) + gca(1, 2) + gca(1, 3))
        i_loss = gca(2, 3) + 0.5 * (pi[(0, 1)] + pi[(1, 0)])
        domain = domain_w * (i_loss + gca(0, 1))
        reg = reg_w * losses.reg_pick_embeds([anc_e, pos_e, neg_e])
        if self.mesh is not None:
            scale = batch["n_whole"] / anc_e.shape[0]
            bpr, reg = bpr * scale, reg * scale
        loss = bpr + reg + domain + cross
        return loss, {"bpr_loss": bpr, "reg_loss": reg, "domain_loss": domain,
                      "cross_loss": cross}

    def generate(self):
        return self._lightgcn_base()
