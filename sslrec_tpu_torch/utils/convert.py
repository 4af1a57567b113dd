"""Weights carried across from the JAX package's parameter pytrees."""

from __future__ import annotations

import numpy as np
import torch


def _state(flat: dict) -> dict[str, torch.Tensor]:
    """Float32 numpy arrays → tensors under the same names."""
    out = {}
    for name, a in flat.items():
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise ValueError(f"{name}: want float32, got {a.dtype}")
        out[name] = torch.from_numpy(a.copy())
    return out


def lightgcn_params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX ``LightGCN.init_params`` output (numpy arrays) → a state dict for the
    port's :class:`~sslrec_tpu_torch.models.general_cf.lightgcn.LightGCN`.

    Both tables are ``[n, embedding_size]`` float32 under the same names.
    """
    for name in ("user_embeds", "item_embeds"):
        if np.ndim(params[name]) != 2:
            raise ValueError(f"{name}: want a 2-D table, got shape {np.shape(params[name])}")
    return _state({k: params[k] for k in ("user_embeds", "item_embeds")})


def sgl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """SGL holds LightGCN's two tables and nothing else."""
    return lightgcn_params_from_jax(params)


def simgcl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """SimGCL holds LightGCN's two tables and nothing else."""
    return lightgcn_params_from_jax(params)


def ncl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """NCL holds LightGCN's two tables; its centroids are per-epoch state."""
    return lightgcn_params_from_jax(params)


def directau_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """DirectAU holds the two embedding tables and nothing else."""
    return lightgcn_params_from_jax(params)


def lightgcl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables, and the JAX list ``ws`` as ``ws.0`` … ``ws.{L-1}``
    (an ``nn.ParameterList``)."""
    flat = {k: params[k] for k in ("user_embeds", "item_embeds")}
    flat.update({f"ws.{i}": w for i, w in enumerate(params["ws"])})
    return _state(flat)


def hccf_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables and the two ``[d, hyper_num]`` hyperedge tables."""
    return _state({k: params[k] for k in
                   ("user_embeds", "item_embeds", "user_hyper", "item_hyper")})


def dccf_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables and the two ``[d, intent_num]`` intent tables."""
    return _state({k: params[k] for k in
                   ("user_embeds", "item_embeds", "user_intent", "item_intent")})


def kgcl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``KGCL.init_params`` output (numpy arrays) → a state dict for the
    port's :class:`~sslrec_tpu_torch.models.kg.kgcl.KGCL`.

    The nested ``rgat_fc`` becomes ``rgat_fc.w`` / ``rgat_fc.b``; ``w`` keeps
    its ``[2d, d]`` layout, since the port computes ``a_in @ w + b`` as JAX
    does.
    """
    flat = {k: params[k] for k in ("all_embed", "relation_embed", "rgat_w", "rgat_a")}
    flat.update({f"rgat_fc.{k}": params["rgat_fc"][k] for k in ("w", "b")})
    return _state(flat)


def diffkg_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The recommender's four arrays under the same names: ``u_embeds``,
    ``e_embeds``, ``r_embeds`` and ``rgat_w`` ([2d, d])."""
    return _state({k: params[k] for k in ("u_embeds", "e_embeds", "r_embeds", "rgat_w")})


def diffkg_denoiser_from_jax(dn: dict) -> dict[str, torch.Tensor]:
    """DiffKG's denoiser (``_dn_params``: the lists ``in`` and ``out`` of
    dense layers and the time embedding's ``emb``) as ``in.0.w``, ``out.0.b``,
    ``emb.w`` …, the names :meth:`DiffKG.load_denoiser` takes."""
    flat = {**_layers("in", dn["in"]), **_layers("out", dn["out"])}
    flat.update({f"emb.{k}": v for k, v in dn["emb"].items()})
    return _state(flat)


def _layers(prefix: str, layers: list) -> dict:
    """A JAX list of ``{"w", "b"}`` layers as ``prefix.i.w`` / ``prefix.i.b``."""
    return {f"{prefix}.{i}.{k}": v for i, lin in enumerate(layers) for k, v in lin.items()}


def autocf_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables, and the JAX list ``gt`` of ``{q, k, v}`` [d, d] as
    ``gt.i.q`` / ``gt.i.k`` / ``gt.i.v``."""
    flat = {k: params[k] for k in ("user_embeds", "item_embeds")}
    flat.update(_layers("gt", params["gt"]))
    return _state(flat)


def gformer_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables, ``gt.{q,k,v}``, and the PNN's two dense layers
    ``pnn_hidden.{w,b}`` ([2d, d]) and ``pnn_out.{w,b}`` ([d, d])."""
    flat = {k: params[k] for k in ("user_embeds", "item_embeds")}
    for part in ("gt", "pnn_hidden", "pnn_out"):
        flat.update({f"{part}.{k}": v for k, v in params[part].items()})
    return _state(flat)


def adagcl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The three partitions: ``rec``'s two tables at the top level, and the
    lists of dense layers of ``vgae`` (``enc_mean``, ``enc_std``, ``dec``) and
    ``dn`` (``nb``, ``self``, ``attn``) as ``vgae.enc_mean.0.w`` and so on."""
    flat = dict(params["rec"])
    for part in ("vgae", "dn"):
        for name, layers in params[part].items():
            flat.update(_layers(f"{part}.{name}", layers))
    return _state(flat)


def _linears(params: dict, tables, linears) -> dict[str, torch.Tensor]:
    """The ``tables`` as they are and each dense layer of ``linears`` as
    ``name.w`` ([in, out], the JAX layout) and ``name.b``."""
    flat = {k: params[k] for k in tables}
    flat.update({f"{k}.{p}": v for k in linears for p, v in params[k].items()})
    return _state(flat)


def dcrec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The three tables (``ui_user_embeds``, ``uu_user_embeds``,
    ``ui_item_embeds``) and the two heads ``ui_linear`` / ``uu_linear``."""
    return _linears(params, ("ui_user_embeds", "uu_user_embeds", "ui_item_embeds"),
                    ("ui_linear", "uu_linear"))


def mhcn_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables, ``attn`` [1, d] and ``attn_mat`` [d, d], and the JAX
    lists ``gating`` (4) and ``sgating`` (3) as ``gating.i.w`` and so on."""
    flat = {k: params[k] for k in ("user_embeds", "item_embeds", "attn", "attn_mat")}
    flat.update(_layers("gating", params["gating"]))
    flat.update(_layers("sgating", params["sgating"]))
    return _state(flat)


def dsl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables and the label's layers ``linear1`` ([2d, d]) and
    ``linear2`` ([d, 1])."""
    return _linears(params, ("user_embeds", "item_embeds"), ("linear1", "linear2"))


def _list(prefix: str, arrays: list) -> dict:
    """A JAX list of arrays as ``prefix.0``, ``prefix.1``, … (an ``nn.ParameterList``)."""
    return {f"{prefix}.{i}": a for i, a in enumerate(arrays)}


def smin_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The two tables, the lists ``u_conv_w`` / ``i_conv_w`` of [d, d] hop
    weights as ``u_conv_w.i``, the scalar ``prelu``, and each semantic
    attention's ``l1`` dense layer and ``l2.w`` ([128, 1]) as
    ``attn_u.l1.w`` and so on."""
    flat = {k: params[k] for k in ("user_embeds", "item_embeds", "prelu")}
    for k in ("u_conv_w", "i_conv_w"):
        flat.update(_list(k, params[k]))
    for k in ("attn_u", "attn_i"):
        flat.update({f"{k}.l1.{p}": v for p, v in params[k]["l1"].items()})
        flat[f"{k}.l2.w"] = params[k]["l2"]["w"]
    return _state(flat)


def kcgn_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The user table, the (item × rating) table, ``time_lin.{w,b}``, the
    lists ``u_w`` / ``v_w`` as ``u_w.i``, the scalar ``prelu`` and, with
    ``fuse: weight``, ``fuse_w`` ([items, ratings, 1])."""
    flat = {k: params[k] for k in ("user_embeds", "item_embeds", "prelu", "fuse_w")
            if k in params}
    flat.update({f"time_lin.{p}": v for p, v in params["time_lin"].items()})
    for k in ("u_w", "v_w"):
        flat.update(_list(k, params[k]))
    return _state(flat)


def kgin_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Four arrays under the same names: ``all_embed``, ``latent_emb``,
    ``weight`` and ``disen_weight_att``."""
    return _state({k: params[k] for k in
                   ("all_embed", "latent_emb", "weight", "disen_weight_att")})


def kgrec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tables ``all_embed``, ``relation_emb`` and ``w_q``, and the two
    contrast MLPs' dense layers as ``cl_mlp1.0.w`` and so on."""
    flat = {k: params[k] for k in ("all_embed", "relation_emb", "w_q")}
    flat.update(_layers("cl_mlp1", params["cl_mlp1"]))
    flat.update(_layers("cl_mlp2", params["cl_mlp2"]))
    return _state(flat)


def _tree(prefix: str, node) -> dict:
    """A nested JAX tree of dicts and lists as dotted names (lists by index)."""
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {prefix: node}
    out = {}
    for k, v in items:
        out.update(_tree(f"{prefix}.{k}" if prefix else str(k), v))
    return out


def _tower(params: dict, extra=()) -> dict[str, torch.Tensor]:
    """The transformer tower's ``emb`` (``token`` where present, ``pos``) and
    ``layers`` (``layers.i.attn.q.w`` …, ``ff.w1``, ``ln1.scale`` …), and
    the model's ``extra`` top-level entries, under the same dotted names."""
    flat = _tree("emb", params["emb"])
    flat.update(_tree("layers", params["layers"]))
    for k in extra:
        flat.update(_tree(k, params[k]))
    return _state(flat)


def bert4rec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tower and the output projection ``out_fc.{w,b}`` ([d, item_num + 1])."""
    return _tower(params, ("out_fc",))


def cl4srec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tower and nothing else (the head is its token table)."""
    return _tower(params)


def duorec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tower and nothing else."""
    return _tower(params)


def iclrec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tower and nothing else; the centroids are per-epoch state."""
    return _tower(params)


def dcrec_seq_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tower, ``cl_fc1`` / ``cl_fc2`` dense layers, ``attn_weights``
    [d, d], ``attn`` [1, d] and the GCN's layer norm ``gcn_ln``."""
    return _tower(params, ("cl_fc1", "cl_fc2", "attn_weights", "attn", "gcn_ln"))


def maerec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tower without a token table (``emb.pos``, ``layers``), the item
    table ``item_emb`` and the decoder's ``dec.l1`` … ``dec.l3``."""
    return _tower(params, ("item_emb", "dec"))


def mbgmn_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The tables ``u_embed``, ``i_embed``, ``beh_embeds`` ([behaviors + 1,
    d/2]) and ``q``, and the dense layers ``spec_u`` … ``pred_fc5`` as
    ``spec_u.w`` / ``spec_u.b``."""
    return _linears(params, ("u_embed", "i_embed", "beh_embeds", "q"),
                    [k for k in params if k.startswith(("spec_", "pred_fc"))])


def hmgcr_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX list ``towers`` as ``towers.i.user_emb``, ``towers.i.item_emb``,
    ``towers.i.u_w.l`` and ``towers.i.i_w.l``."""
    return _state(_tree("towers", params["towers"]))


def smbrec_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The towers as HMGCR's, ``cat_trans`` / ``user_trans`` dense layers and
    ``beh_weights``."""
    flat = _tree("towers", params["towers"])
    flat.update(_tree("", {k: params[k] for k in ("cat_trans", "user_trans", "beh_weights")}))
    return _state(flat)


def cml_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The ``gcn`` tree (``gcn.user_emb``, ``gcn.u_w.l`` …) and the ``meta``
    tree (``meta.ssl1.w`` …, the scalar ``meta.prelu``, ``meta.beh_emb``)
    under ``meta_net``."""
    flat = _tree("gcn", params["gcn"])
    flat.update(_tree("meta_net", params["meta"]))
    return _state(flat)


def kmclr_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The ``mb`` tree as CML's ``gcn`` and the ``kg`` tree (``kg.item.0``,
    ``kg.entity.1``, ``kg.transR_W``, ``kg.gat_fc.w`` …) under the same
    dotted names."""
    flat = _tree("mb", params["mb"])
    flat.update(_tree("kg", params["kg"]))
    return _state(flat)
