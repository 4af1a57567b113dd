"""Rank programs that exercise the mesh's parts on numpy inputs.

:func:`run` executes a list of named checks in each rank of a group started
by :func:`~sslrec_tpu_torch.parallel.launch.spawn` and returns their outputs
as numpy arrays; whoever started the group holds them against a reference
(the JAX package's functions in the CPU tests, the plain single-device
computation on the card).  Every rank runs the same checks in the same
order, since each makes its mesh, and so its process groups, collectively.
Inputs are whole arrays; each check takes this rank's part of them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch.ops.sparse import CooGraph
from sslrec_tpu_torch.ops.spmm_kernel import CsrGraph, EdgeMask
from sslrec_tpu_torch.ops.topk import sharded_topk
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import make_mesh


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _coo(inp: dict, prefix: str = "") -> CooGraph:
    n = int(inp[prefix + "n"])
    return CooGraph(rows=np.asarray(inp[prefix + "rows"]), cols=np.asarray(inp[prefix + "cols"]),
                    vals=np.asarray(inp[prefix + "vals"], np.float32), n_rows=n, n_cols=n)


def _dev(inp: dict) -> torch.device:
    return torch.device(inp.get("device", "cpu"))


def mesh_shape(inp: dict) -> dict:
    m = make_mesh(inp.get("n_data"), inp.get("n_model"))
    return {"shape": m.shape, "coords": (m.data_index, m.model_index)}


def owned_lookup(inp: dict) -> dict:
    """Rows ``idx`` of a table split over ``model`` ``P`` ways."""
    mesh = make_mesh(1, int(inp["n_model"]))
    table, n = torch.from_numpy(inp["table"]).to(_dev(inp)), int(inp["shard"])
    local = table[mesh.model_index * n:(mesh.model_index + 1) * n]
    idx = torch.from_numpy(inp["idx"]).to(_dev(inp))
    return {"out": _np(dist_train.owned_lookup(local, idx, n, mesh))}


def topk(inp: dict) -> dict:
    """``sharded_topk`` of scores split by columns over ``model``."""
    mesh = make_mesh(1, int(inp["n_model"]))
    scores = torch.from_numpy(inp["scores"]).to(_dev(inp))
    n = scores.shape[1] // mesh.n_model
    local = scores[:, mesh.model_index * n:(mesh.model_index + 1) * n]
    return {"out": _np(sharded_topk(local, mesh.model_index * n, int(inp["k"]),
                                    mesh.model_group))}


def sharded_step(inp: dict) -> dict:
    """One :func:`~.dist_train.build_sharded_lightgcn_step` step (Adam at
    ``lr``) from whole padded tables; the whole tables after it, and the
    whole gradients the step gave Adam (summed over the ``data`` group)."""
    mesh = make_mesh(int(inp["n_data"]), int(inp["n_model"]))
    sg = dist_train.partition_graph(_coo(inp), int(inp["n_users"]), int(inp["n_items"]),
                                    mesh.n_model)
    init, step = dist_train.build_sharded_lightgcn_step(
        mesh, sg, int(inp["layer_num"]), float(inp["reg_weight"]), float(inp["keep_rate"]),
        lambda ps: torch.optim.Adam(ps, lr=float(inp["lr"])))
    dev = _dev(inp)
    params, opt = init({k: torch.from_numpy(inp[k]).to(dev)
                        for k in ("user_embeds", "item_embeds")})
    batch = {k: torch.from_numpy(inp[k]).to(dev) for k in ("user", "pos", "neg")}
    loss = step(params, opt, batch, torch.tensor(inp["key"]))
    out = {"loss": float(loss)}
    for k, n in (("user_embeds", sg.u_loc), ("item_embeds", sg.i_loc)):
        out[k] = _np(dist_train.whole_rows(params[k], n * sg.n_model, mesh))
        out[f"{k}_grad"] = _np(dist_train.whole_rows(params[k].grad, n * sg.n_model, mesh))
    return out


def propagate(inp: dict) -> dict:
    """``mesh_partitioned_propagate`` of whole padded tables under each view's
    values (``view_vals``: a list of ``[nnz]`` in the original edge order;
    ``combine``), the views' outputs summed, whole padded tables."""
    mesh = make_mesh(int(inp["n_data"]), int(inp["n_model"]))
    sg = dist_train.partition_graph(_coo(inp), int(inp["n_users"]), int(inp["n_items"]),
                                    mesh.n_model)
    dev = _dev(inp)
    u_x, i_x = (dist_train.own_rows(torch.from_numpy(inp[k]).to(dev), n, mesh)
                for k, n in (("u", sg.u_loc), ("i", sg.i_loc)))
    u_out = i_out = 0
    for vals in inp["view_vals"]:
        pv = dist_train.view_vals_partitioned(sg, torch.from_numpy(vals).to(dev))
        u, i = dist_train.mesh_partitioned_propagate(mesh, sg, u_x, i_x, pv,
                                                     int(inp["layer_num"]), inp["combine"])
        u_out, i_out = u_out + u, i_out + i
    return {"u": _np(dist_train.whole_rows(u_out, sg.u_loc * sg.n_model, mesh)),
            "i": _np(dist_train.whole_rows(i_out, sg.i_loc * sg.n_model, mesh)),
            "pv": _np(dist_train.view_vals_partitioned(sg, torch.from_numpy(
                inp["view_vals"][0])))}


def _cfg(name: str, inp: dict):
    from sslrec_tpu_torch.config import load_config
    return load_config(name, overrides={"train.mesh": {"data": int(inp["n_data"]),
                                                       "model": int(inp["n_model"])},
                                        **inp.get("overrides", {})})


def rect_pair(inp: dict) -> dict:
    """``maybe_partition_rect_pair`` of A (users ← items) and AT under the
    config's mesh: both partitions' arrays."""
    cfg = _cfg("hmgcr", inp)
    u, i = int(inp["n_users"]), int(inp["n_items"])
    a = CooGraph(inp["a_rows"], inp["a_cols"], inp["a_vals"], u, i)
    at = CooGraph(inp["at_rows"], inp["at_cols"], inp["at_vals"], i, u)
    _, (sg_a, sg_at) = dist_train.maybe_partition_rect_pair(cfg, a, at, u, i)
    return {f"{tag}.{f}": getattr(sg, f) for tag, sg in (("a", sg_a), ("at", sg_at))
            for f in ("local_rows", "cols", "vals", "src_idx")}


def _bundle(inp: dict, device, cfg=None):
    """The data of ``inp``: a sequential split (``inp["seq_split"]``: ``train`` and
    ``test``, each ``(uids, sequences, targets)`` as ``bundle_from_seqs``
    takes them, under ``cfg``), a KG split (``inp["kg"]``: ``train_cf``,
    ``test_cf``, ``triplets``, ``n_entities``, ``n_relations``, as the KG
    handler's ``bundle_from_kg`` takes them, under ``cfg``), a multi-behavior
    one (``inp["mb"]``: ``behaviors``, their ``mats``, ``tst`` and the
    optional ``meta_mats``, ``meta_users``, ``kg_triplets``, as
    ``bundle_from_behaviors`` takes them), a social one (``inp["social"]``:
    ``trn``, ``tst``, ``trust`` and the optional ``trn_time``, as the social
    handler's ``bundle_from_matrices`` takes them, and ``metapaths``, SMIN's
    sampled metapath matrices in place of the handler's own draw), else a
    general_cf one from the ``trn`` / ``val`` / ``tst`` matrices."""
    if inp.get("seq_split") is not None:
        from sslrec_tpu_torch.data.sequential import bundle_from_seqs
        split = inp["seq_split"]
        return bundle_from_seqs(cfg, split["train"], split["test"], device)
    if inp.get("social") is not None:
        from sslrec_tpu_torch.data import social
        soc = inp["social"]
        draw = social.gen_metapaths
        if soc.get("metapaths") is not None:
            social.gen_metapaths = lambda *a, **k: dict(soc["metapaths"])
        try:
            return social.bundle_from_matrices(cfg, soc["trn"], soc["tst"], soc["trust"],
                                               device, trn_time=soc.get("trn_time"))
        finally:
            social.gen_metapaths = draw
    if inp.get("mb") is not None:
        from sslrec_tpu_torch.data.multi_behavior import bundle_from_behaviors
        mb = inp["mb"]
        return bundle_from_behaviors(cfg, list(mb["behaviors"]), mb["mats"], mb["tst"],
                                     meta_mats=mb.get("meta_mats"),
                                     meta_users=mb.get("meta_users"),
                                     kg_triplets=mb.get("kg_triplets"), device=device)
    if inp.get("kg") is not None:
        from sslrec_tpu_torch.data.kg import bundle_from_kg
        kg = inp["kg"]
        return bundle_from_kg(cfg, kg["train_cf"], kg["test_cf"], kg["triplets"],
                              int(kg["n_entities"]), int(kg["n_relations"]), device=device)
    from sslrec_tpu_torch.data.general_cf import bundle_from_matrices
    mats = [None if inp.get(k) is None else sp.coo_matrix(inp[k]) for k in ("trn", "val", "tst")]
    return bundle_from_matrices(*mats, device=device)


def _tensors(x, device):
    """numpy arrays (in dicts, lists and tuples, kept as such) as tensors on
    ``device``; Python numbers stay."""
    if isinstance(x, dict):
        return {k: _tensors(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tensors(v, device) for v in x)
    if x is None or isinstance(x, (int, float)):    # a scalar the model reads as such
        return x
    return torch.from_numpy(np.asarray(x)).to(device)


def lightgcn(inp: dict) -> dict:
    """The port's LightGCN under the config's mesh, loaded with whole tables
    ``params``: ``propagate()`` and, where ``mask`` is given, ``propagate``
    under that multiplier in the original edge order; the evaluator's test
    metrics (``Evaluator(mesh=...)``), and the rows each rank holds."""
    from sslrec_tpu_torch.models.general_cf.lightgcn import LightGCN
    from sslrec_tpu_torch.trainer.metrics import Evaluator

    cfg = _cfg("lightgcn", inp)
    data = _bundle(inp, _dev(inp))
    model = LightGCN(cfg, data)
    mesh = model.mesh
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    model.load_state_dict(dist_train.local_state(model, params, mesh))
    out = {"local_rows": model.user_embeds.shape[0],
           "sharded": model.sg is not None}
    with torch.no_grad():
        out["u"], out["i"] = map(_np, model.propagate())
        if inp.get("mask") is not None:
            ew = EdgeMask(torch.from_numpy(inp["mask"]).to(_dev(inp)))
            out["u_mask"], out["i_mask"] = map(_np, model.propagate(ew))
    out["metrics"] = Evaluator(data.test, cfg, mesh=mesh)(model)
    return out


def _whole_params(model, attr: str = "data") -> dict:
    """The model's parameters (``attr`` "data") or gradients ("grad") as whole
    tables: its ``row_shards`` gathered over the ``model`` group (a
    parameter without a gradient: None)."""
    shards = model.row_shards
    out = {}
    for name, p in model.named_parameters():
        t = getattr(p, attr)
        if t is None:
            out[name] = None
            continue
        t = t.detach()
        out[name] = _np(t if name not in shards else
                        dist_train.whole_rows(t, shards[name], model.mesh))
    return out


def _model(inp: dict):
    """The port's model ``inp["model"]`` (a config name, with ``overrides``)
    under the config's mesh, on ``_bundle``'s data, loaded with the whole
    parameters ``params`` (in float64 where ``inp["f64"]``), with the
    constants ``attrs`` set in place of its own (LightGCL's SVD factors; in
    the parameters' precision), and its config."""
    from sslrec_tpu_torch.models.registry import build_model

    cfg = _cfg(inp["model"], inp)
    dev = _dev(inp)
    model = build_model(cfg, _bundle(inp, dev, cfg))
    if inp.get("f64"):
        model.double()
    for k, v in (inp.get("attrs") or {}).items():
        setattr(model, k, torch.from_numpy(np.asarray(
            v, np.float64 if inp.get("f64") else np.float32)).to(dev))
    params = {k: torch.from_numpy(v).to(dev) for k, v in inp["params"].items()}
    model.load_state_dict(dist_train.local_state(model, params, getattr(model, "mesh", None)))
    return model, cfg


def _whole_moments(model, opts: dict | None = None) -> dict:
    """The Adam moments of each of ``opts`` (default ``model.optimizers()``)
    as whole tables, by ``<optimizer>.<parameter>.exp_avg`` / ``exp_avg_sq``."""
    shards, names = model.row_shards, {id(p): n for n, p in model.named_parameters()}
    out = {}
    for opt_name, opt in (model.optimizers() if opts is None else opts).items():
        for p, st in opt.state.items():
            name = names[id(p)]
            for k in ("exp_avg", "exp_avg_sq"):
                t = st[k]
                out[f"{opt_name}.{name}.{k}"] = _np(
                    dist_train.whole_rows(t, shards[name], model.mesh) if name in shards else t)
    return out


def model_step(inp: dict) -> dict:
    """One step of the port's model (:func:`_model`) under the config's mesh
    from the whole batch ``user``/``pos`` (and ``neg`` where the model's
    ``batch_fields`` have it): this rank's ``data`` slice of the batch (with
    its ``share`` and ``n_whole``, as the Trainer makes it), ``aux`` and
    ``draws`` (DcRec: ``views``) where given, or the view bank of ``epoch_state(None, 0,
    draws=inp["epoch_draws"])`` from the loaded parameters (AutoCF's and
    GFormer's, over ``n_batches`` steps), at step ``step`` (default 0).  A
    model with its own ``train_step`` (CML, KMCLR, AdaGCL, MAERec) takes it:
    the whole batch's loss terms (reduced as the Trainer reduces them), the
    whole parameters after it, the whole gradients its optimizer took, its
    optimizers' whole moments and its ``extra_state()`` where it has one
    (MAERec's loss history).  Any
    other: ``loss(batch, key, draws=...)`` (``key`` a PRF key),
    :func:`~.dist_train.mesh_backward` and the gradients summed over
    ``data``: the whole batch's loss terms, the whole gradients and their
    global norm (:func:`~.dist_train.global_norm`)."""
    model, cfg = _model(inp)
    dev = _dev(inp)
    mesh = model.mesh
    n = inp["user"].shape[0]
    sl = dist_train.batch_slice(n, mesh)
    batch = {k: torch.from_numpy(inp[k][sl]).to(dev) for k in model.batch_fields}
    share = batch["user"].shape[0] / n
    batch.update(share=share, n_whole=n, step=int(inp.get("step", 0)))
    if inp.get("aux") is not None:
        batch["aux"] = _tensors(inp["aux"], dev)
        if "dkg" in batch["aux"]:       # DiffKG's denoised KG: heads, tails, relations, validity
            batch["aux"]["dkg"] = model.kg_edges(*batch["aux"]["dkg"])
    if inp.get("epoch_draws") is not None:      # a view bank made here from the parameters
        model._n_batches_hint = int(inp["n_batches"])
        batch["aux"] = model.epoch_state(None, 0, draws=_tensors(inp["epoch_draws"], dev))
    kw = {k: _tensors(inp[k], dev) for k in ("draws", "views") if inp.get(k) is not None}
    key = None if inp.get("key") is None else torch.from_numpy(inp["key"]).to(dev)
    shapes = {k: tuple(model.state_dict()[k].shape) for k in model.row_shards}
    if hasattr(model, "train_step"):
        terms = dist_train.reduce_terms(model.train_step(batch, key, **kw), mesh, share)
        extra = model.extra_state() if hasattr(model, "extra_state") else {}
        return {"terms": {k: float(v) for k, v in terms.items()},
                "params": _whole_params(model), "grads": _whole_params(model, "grad"),
                "moments": _whole_moments(model), "local_shapes": shapes,
                "extra_state": {k: _np(v) if torch.is_tensor(v) else v
                                for k, v in extra.items()}}
    loss, terms = model.loss(batch, key, **kw)
    dist_train.mesh_backward(loss, mesh, share)
    dist_train.sync_model_grads(model, mesh)
    terms = dist_train.reduce_terms({**terms, "loss": loss.detach()}, mesh, share)
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": _whole_params(model, "grad"), "local_shapes": shapes,
            "norm": float(dist_train.global_norm(model, mesh)),
            "local_rows": next(iter(shapes.values()), (None,))[0]}


def trainer_step(inp: dict) -> dict:
    """One step of the port's Trainer (the model ``inp["model"]``, LightGCN
    by default; epoch 0's first batch, with the epoch's generator and
    ``epoch_state`` as the epoch gives them) under the config's mesh from
    the seeded initial tables: the whole gradients (summed over ``data``)
    and the whole tables after Adam."""
    from sslrec_tpu_torch.models.registry import build_model
    from sslrec_tpu_torch.trainer.trainer import INIT_STREAM, Trainer, generator

    cfg = _cfg(inp.get("model", "lightgcn"), inp)
    data = _bundle(inp, _dev(inp), cfg)
    model = build_model(cfg, data)
    trainer = Trainer(cfg, model, data)
    model.init_params(generator(int(cfg.train.seed), INIT_STREAM))
    trainer.n_batches = 1           # the epoch's first step, and no other
    terms = trainer.train_epoch(0)
    return {"loss": float(terms["loss"]), "terms": {k: float(v) for k, v in terms.items()},
            **_whole_params(model), **{k + ".grad": v for k, v in
                                       _whole_params(model, "grad").items()},
            **_model_state(model)}


def kmclr_hook(inp: dict) -> dict:
    """KMCLR's epoch hook (:func:`_model`, ``epoch_state(None, 0,
    draws=inp["draws"])``) under the config's mesh, or on one device for a
    1×1 mesh: the whole KG tables after it, the KG Adam's whole moments, both
    views' values and the KG users it returns."""
    model, _ = _model(inp)
    views = []
    make_views = model.make_views

    def keep(dr):
        out = make_views(dr)
        views.extend(out)
        return out

    model.make_views = keep
    aux = model.epoch_state(None, 0, draws=_tensors(inp["draws"], _dev(inp)))
    return {"params": {k: v for k, v in _whole_params(model).items() if k.startswith("kg.")},
            "moments": _whole_moments(model, {"kg": model.opt_kg}),
            "views": [_np(v) for v in views],
            "kg_user": _np(aux["kg_user"])}


def global_norm(inp: dict) -> dict:
    """``dist_train.global_norm`` and the clip of ``trainer.clip_grad_global_norm``
    on a module of one row-sharded table (``table``, ``[n, d]``) and one
    replicated weight (``weight``), their whole gradients given (``grads``):
    this rank's rows of the table's, the weight's whole, as they stand after
    the mesh's sums.  Returns the norm, whether the clip fired, and the
    clipped gradients whole."""
    from sslrec_tpu_torch.trainer.trainer import clip_grad_global_norm

    mesh = make_mesh(int(inp["n_data"]), int(inp["n_model"]))
    n = inp["table"].shape[0]
    model = torch.nn.Module()
    model.row_shards = {"table": n}
    model.table = torch.nn.Parameter(dist_train.own_rows(
        torch.from_numpy(inp["table"]), dist_train.shard_rows(n, mesh), mesh))
    model.weight = torch.nn.Parameter(torch.from_numpy(inp["weight"]))
    model.table.grad = dist_train.own_rows(torch.from_numpy(inp["grads"]["table"]),
                                           model.table.shape[0], mesh)
    model.weight.grad = torch.from_numpy(inp["grads"]["weight"]).clone()
    norm = dist_train.global_norm(model, mesh)
    clip_grad_global_norm(model.parameters(), float(inp["max_norm"]), norm)
    return {"norm": float(norm), "clipped": bool(norm >= float(inp["max_norm"])),
            "table": _np(dist_train.whole_rows(model.table.grad, n, mesh)),
            "weight": _np(model.weight.grad)}


def _model_state(model) -> dict:
    """State a model keeps outside its parameters after an epoch's hook:
    DiffKG's denoiser (``dn.<name>``) and its denoised KG's edges (``dkg.h``,
    ``dkg.t``, ``dkg.r``, ``dkg.valid``)."""
    out = {}
    if getattr(model, "_dn", None) is not None:
        out.update({f"dn.{k}": _np(v) for k, v in model._dn.items()})
    dkg = getattr(model, "_last_dkg", None)
    if dkg is not None:
        out.update({f"dkg.{k}": _np(getattr(dkg, k).ids) for k in ("h", "t", "r")})
        out["dkg.valid"] = _np(dkg.valid)
    return out


def propagate_grad(inp: dict) -> dict:
    """One step of ``mesh_partitioned_propagate`` (2 hops, sum, under the
    dropout PRF of the whole graph at ``key``) and ``owned_lookup`` of rows
    ``idx``, value and gradients of a weighted sum (the shards' terms summed
    over ``model``, backpropagated through ``mesh_backward``), against the plain hop
    (``csr_spmm_plain`` on the whole graph) with autograd: the largest error
    of each relative to the plain one's largest value.  Whole tables in; a
    shard's rows each."""
    from sslrec_tpu_torch.ops.spmm_kernel import build_csr_graph, csr_spmm_plain, prf_mask

    mesh = make_mesh(int(inp["n_data"]), int(inp["n_model"]))
    dev = _dev(inp)
    n_users, n_items = int(inp["n_users"]), int(inp["n_items"])
    coo = _coo(inp)
    sg = dist_train.partition_graph(coo, n_users, n_items, mesh.n_model)
    whole = build_csr_graph(CooGraph(*(torch.from_numpy(np.asarray(a)) for a in
                                       (coo.rows, coo.cols, coo.vals)), coo.n_rows,
                                     coo.n_cols), dev)
    prf = prf_mask(torch.tensor(inp["key"]), whole, float(inp["keep_rate"]))
    u0, i0, wu, wi, wa = (torch.from_numpy(inp[k]).to(dev) for k in ("u", "i", "wu", "wi", "wa"))
    idx = torch.from_numpy(inp["idx"]).to(dev)
    u = dist_train.own_rows(u0, sg.u_loc, mesh).requires_grad_()
    i = dist_train.own_rows(i0, sg.i_loc, mesh).requires_grad_()
    ou, oi = dist_train.mesh_partitioned_propagate(mesh, sg, u, i, None, 2, "sum", prf)
    anc = dist_train.owned_lookup(ou, idx, sg.u_loc, mesh)
    own_w = [dist_train.own_rows(w, n, mesh) for w, n in ((wu, sg.u_loc), (wi, sg.i_loc))]
    tables = (ou * own_w[0]).sum() + (oi * own_w[1]).sum()
    loss = dist_train.all_reduce_sum(tables, mesh.model_group) + (anc * wa).sum()
    dist_train.mesh_backward(loss, mesh, 1.0)       # a data row's replica: its whole loss

    pu, pi = u0.clone().requires_grad_(), i0.clone().requires_grad_()
    x = torch.cat([pu, pi])
    acc, h = x, x
    for _ in range(2):
        h = csr_spmm_plain(whole.fwd, h, prf)
        acc = acc + h
    ru, ri = acc[:n_users], acc[n_users:]
    ((ru * wu).sum() + (ri * wi).sum() + (ru[idx.long()] * wa).sum()).backward()

    def err(got, ref, n_loc):
        ref = dist_train.own_rows(ref.detach(), n_loc, mesh)
        return float((got.detach() - ref).abs().max() / ref.abs().max())

    return {"value": max(err(ou, ru, sg.u_loc), err(oi, ri, sg.i_loc)),
            "lookup": float((anc.detach() - ru[idx.long()].detach()).abs().max()
                            / ru.detach().abs().max()),
            "grad": max(err(u.grad, pu.grad, sg.u_loc), err(i.grad, pi.grad, sg.i_loc)),
            "backend": torch.distributed.get_backend() if torch.distributed.is_initialized()
            else None}


# the head layouts whose segment softmax B2 shifts, by model class
B2_LAYOUTS = {"KGCL": lambda m: {"kg_heads": m.seg_h.layout},
              "KGRec": lambda m: {"kg_full_heads": m.seg_h.layout},
              "DiffKG": lambda m: {"kg_heads": m.kg.h, "dkg_heads": m._last_dkg.h}}


def whole_layouts(model) -> dict:
    """The B1 layouts of the whole graphs a model holds as attributes (a
    ``CsrGraph``, one in a list or tuple: MBGMN's behavior pairs, SMIN's
    metapaths, or one held as the attribute ``g`` of an attribute:
    DCRec_seq's item graphs), each once, by ``<attribute>[.<index>…]:forward``
    / ``:transposed``, and of its segment ops (``SegmentOps``: KCGN's and
    SMIN's sums and gathers over constant ids) by ``<attribute>:segments``:
    the layouts on which a model that partitions no graph runs every hop in
    every rank (DCCF, HCCF, LightGCL, AutoCF, GFormer, AdaGCL, MBGMN, the
    social five, DCRec_seq and MAERec)."""
    from sslrec_tpu_torch.ops.segment_kernel import SegmentOps

    out, seen = {}, set()

    def visit(name, x):
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            for i, v in enumerate(x):
                visit(f"{name}.{i}", v)
            return
        if isinstance(getattr(x, "g", None), CsrGraph):
            x = x.g
        lays = ({"segments": x.layout.csr} if isinstance(x, SegmentOps)
                else {"forward": x.fwd, "transposed": x.bwd} if isinstance(x, CsrGraph) else {})
        for tag, lay in lays.items():
            if id(lay) not in seen:
                seen.add(id(lay))
                out[f"{name}:{tag}"] = lay

    for name, x in vars(model).items():
        visit(name, x)
    return out


def mesh_graphs(model) -> dict:
    """The ``ShardedGraph`` s a model partitions on a model-sharded mesh, by
    name: one (``""``) for LightGCN's and the KG models' ``sg``; each tower's
    pair for HMGCR and SMBRec (``t<i>.a``, ``t<i>.at``); each behavior's
    bidirectional hop for CML and KMCLR (``beh<b>``) and KMCLR's buy
    bi-adjacency (``buy``)."""
    if getattr(model, "sg", None) is not None:
        return {"": model.sg}
    out = {}
    for t, (sg_a, sg_at) in enumerate(getattr(model, "sgs", None) or []):
        out[f"t{t}.a"], out[f"t{t}.at"] = sg_a, sg_at
    gcn = getattr(model, "gcn", None) or getattr(model, "mb", None)
    for b, sg in enumerate(getattr(gcn, "sgs", None) or []):
        out[f"beh{b}"] = sg
    if getattr(model, "sg_bi", None) is not None:
        out["buy"] = model.sg_bi
    return out


LONG_ROW = 4096     # a layout with a longer row is probed against a float64 plain version


def _probe_b1(lay, gen, d: int, values: bool = False) -> float:
    """B1 on ``lay`` against its plain version at width ``d`` (under seeded
    values in the original edge order where ``values``): the largest error
    relative to the plain output's largest entry.  Where a row is longer
    than ``LONG_ROW`` the plain version runs in float64 on small integers
    and values in {0, 0.5, 1, 2} (a float32 sum of so many terms in another
    order alone nears ``TOL``), as ``chip_smoke.check_graph`` holds its long
    rows."""
    from sslrec_tpu_torch.ops import spmm_kernel

    dev = lay.cols.device
    n_ids = lay.n_ids or lay.cols.shape[0]
    long_rows = lay.n_rows > 0 and int((lay.indptr[1:] - lay.indptr[:-1]).max()) > LONG_ROW
    w = None
    if long_rows:
        x = torch.randint(-8, 9, (lay.n_cols, d), generator=gen, device=dev).float()
        if values:
            w = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)[
                torch.randint(0, 4, (n_ids,), generator=gen, device=dev)]
        ref = spmm_kernel.csr_spmm_plain(lay, x.double(), None if w is None else w.double())
    else:
        x = torch.randn(lay.n_cols, d, generator=gen, device=dev)
        if values:
            w = torch.rand(n_ids, generator=gen, device=dev)
        ref = spmm_kernel.csr_spmm_plain(lay, x, w)
    got = spmm_kernel.csr_spmm(lay, x, w).to(ref.dtype)
    return float((got - ref).abs().max() / ref.abs().max())


def layout_probe(trainer) -> dict:
    """The kernels on a trained model's layouts in this rank, each against its
    plain version on seeded random inputs at the width of the model's first
    row-sharded table (its embedding size where it has none: the sequential
    models): B1 on the rank's shard layouts of each graph the
    model partitions (:func:`mesh_graphs`; keys ``<graph>:forward`` …, the
    bare layout's name for a model of one graph), forward and transposed,
    without a multiplier and under random values in the original edge order
    (a view's, through ``view_vals_partitioned``), or, for a model that
    partitions none, on the whole graphs' layouts it holds
    (:func:`whole_layouts`; without a multiplier and under random values), the
    largest error relative to the plain output's largest entry (a layout
    with a row longer than ``LONG_ROW`` against a float64 plain version,
    :func:`_probe_b1`); B2 on the
    model's head layouts over the whole KG (``B2_LAYOUTS``), whether it
    equals the plain version bit for bit."""
    from sslrec_tpu_torch.ops import segment_kernel

    model, dev = trainer.model, trainer.device
    gen = torch.Generator(device=dev).manual_seed(17 + model.mesh.rank)
    d = (model.state_dict()[next(iter(model.row_shards))].shape[1] if model.row_shards
         else int(model.embedding_size))
    out = {"b1": {}, "b2": {}}
    p = model.mesh.model_index
    for gname, sg in mesh_graphs(model).items():
        shard = dist_train.shard_graph(sg, p, dev)
        vals = torch.rand(sg.n_edges, generator=gen, device=dev)
        graphs = {"": shard.graph,
                  ".vals": shard.with_vals(dist_train.view_vals_partitioned(sg, vals)[p])}
        for tag, g in graphs.items():
            for name, lay in (("forward", g.fwd), ("transposed", g.bwd)):
                out["b1"][f"{gname}:{name}{tag}" if gname else name + tag] = _probe_b1(
                    lay, gen, d)
    if not mesh_graphs(model):
        for name, lay in whole_layouts(model).items():
            for tag, values in (("", False), (".vals", True)):
                out["b1"][name + tag] = _probe_b1(lay, gen, d, values)
    for name, lay in B2_LAYOUTS.get(type(model).__name__, lambda m: {})(model).items():
        logits = torch.randn(lay.n, generator=gen, device=dev) * 5
        out["b2"][name] = bool(torch.equal(segment_kernel.segment_max(lay, logits),
                                           segment_kernel.segment_max_plain(lay, logits)))
    return out


def cli_runs(inp: dict) -> dict:
    """The CLI runs ``inp["argvs"]`` one after the other in this started group
    (:func:`~.launch.cli_rank` each, as the CLI's own spawn runs one): rank
    summaries by run.  On the CPU every B1 and B2 call counts where the card
    counts a launch (``spmm_kernel.csr_spmm``'s counters, by layout shape,
    also where ``segment_kernel`` calls it, and ``segment_max.launches``),
    so that a path's launch count can be held before it meets the card.
    ``inp["probe"]`` set (or, a list, set for a run): each run (that run)
    ends with :func:`layout_probe`."""
    from sslrec_tpu_torch.ops import segment_kernel, spmm_kernel
    from sslrec_tpu_torch.parallel import launch

    kernel, segmax = spmm_kernel.csr_spmm, segment_kernel.segment_max
    if _dev(inp).type == "cpu":
        def counted(layout, x, ew=None):
            counted.launches += 1
            counted.by_shape.setdefault((layout.n_rows, layout.n_cols), [0, 0])[0] += 1
            return kernel(layout, x, ew)

        def counted_max(lay, data):
            counted_max.launches += 1
            return segmax(lay, data)

        spmm_kernel.csr_spmm = segment_kernel.csr_spmm = counted
        segment_kernel.segment_max = counted_max
    try:
        probes = inp.get("probe")
        if not isinstance(probes, (list, tuple)):
            probes = [probes] * len(inp["argvs"])
        return {"runs": [launch.cli_rank(list(argv), layout_probe if probe else None)
                         for argv, probe in zip(inp["argvs"], probes)]}
    finally:
        spmm_kernel.csr_spmm = segment_kernel.csr_spmm = kernel
        segment_kernel.segment_max = segmax


CHECKS = {"mesh_shape": mesh_shape, "owned_lookup": owned_lookup, "topk": topk,
          "sharded_step": sharded_step, "propagate": propagate, "rect_pair": rect_pair,
          "lightgcn": lightgcn, "trainer_step": trainer_step, "propagate_grad": propagate_grad,
          "model_step": model_step, "cli_runs": cli_runs, "kmclr_hook": kmclr_hook,
          "global_norm": global_norm}


def run(checks: list[tuple[str, str, dict]]) -> dict:
    """``{tag: CHECKS[name](inputs)}`` for each ``(tag, name, inputs)``, in
    order, in this rank."""
    return {tag: CHECKS[name](inp) for tag, name, inp in checks}
