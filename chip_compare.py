#!/usr/bin/env python3
"""B1 and B2 device times at the main paths' shapes, for several checkouts of
this repo on one card, so that a kernel's earlier and current versions are
compared within one run; and a sweep of B1's schedule in this checkout.

    python3 chip_compare.py <checkout> [<checkout> ...]    # e.g. parent . . parent
    python3 chip_compare.py --sweep

Needs one CUDA card and ``nvcc``.  Each checkout runs in its own process, in
the order given, and builds its own kernels into its own ``build/``.  The
operands are this checkout's: ``chip_smoke.lightgcn_data`` and
``chip_smoke.kgcl_shapes``, each timed (``chip_smoke.device_ms``) through
the call the models make, so every checkout runs its own version of it:

- the LightGCN hop (d 32) through ``ops.spmm.spmm`` / ``spmm_t``: no
  multiplier; a materialised dropout mask (``dropout_mask``); and the
  training hop's dropout, ``augment.edge_drop``'s multiplier built in the
  call, as each training step builds it;
- KGCL: B1 as the segment sum at d 65 and d 1 and as the UI hop at d 64 under
  a view's values (both layouts), through ``csr_spmm``; the relation take's
  forward and backward as the model runs them (``KGCL.rel_take``); and B2.

and :data:`LAYOUT_SHAPES`, B1 layouts that this checkout's models build
(:func:`build_operands`, once, before any checkout runs; KMCLR's per-item
lists, DiffKG's denoised KG, KCGN's components, AdaGCL's gate rows,
DCRec_seq's and MAERec's item graphs, AutoCF's decoder, KGCL's segment sum,
the LightGCN hop, also under the 3-lane fold), handed to every checkout as
their arrays and timed through ``csr_spmm``, the call every Function of the
models makes for them (a segment sum's forward, a gather's backward, a
hop), beside ``torch.sparse.mm`` on the same operands (under a multiplier
also with the values' gather inside the timed call); then the bf16 pass:
:data:`BF16_SHAPES` again under ``SSLREC_PALLAS_PRECISION=default`` (the
call's cast of x included), the cast alone, and ``torch.sparse.mm`` on a
bfloat16 CSR tensor.

A checkout needs those entry points and the ones the two builders call.
Prints one JSON line per checkout, then the card line.  ``--sweep`` times
this checkout's kernel at every narrow shape (d <= 4) over lane groups and
split thresholds, at the long-row shapes over split thresholds and the
combine tree's fan-in, and in the bf16 mode at :data:`BF16_SHAPES` over lane
groups and split thresholds, each call held against the plain version; it
prints a JSON line a shape and one for all.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OPERANDS = os.path.join(HERE, "build", "chip_compare_operands.pt")

# (name, operand, layout, d, multiplier): operand keys of build_operands;
# layout "fwd"/"bwd" of a graph or "seg" (a segment layout's csr); the
# multiplier "w" (the operand's own values) or None
LAYOUT_SHAPES = (
    ("kmclr_ent_lists_take_bwd_d32", "kmclr_ent", "seg", 32, None),
    ("kmclr_rel_lists_take_bwd_d32", "kmclr_rel", "seg", 32, None),
    ("diffkg_dkg_rels_take_bwd_d64", "diffkg_dkg_rels", "seg", 64, None),
    ("diffkg_dkg_heads_softmax_sum_d1", "diffkg_dkg_heads", "seg", 1, None),
    ("kcgn_ii_comp_sum_d128", "kcgn_ii_comp", "fwd", 128, None),
    ("kcgn_ii_label_take_bwd_d128", "kcgn_ii_labels", "seg", 128, None),
    ("kcgn_ii_hop_d128", "kcgn_ii", "fwd", 128, None),
    ("adagcl_gate_deg_d1", "adagcl_gate", "seg", 1, None),
    ("maerec_spread_d1", "maerec", "fwd", 1, None),
    ("maerec_hop_d64", "maerec", "fwd", 64, "w"),
    ("dcrec_seq_deg_d1", "dcrec_seq_adj", "fwd", 1, "w"),
    ("dcrec_seq_deg_t_d1", "dcrec_seq_adj", "bwd", 1, "w"),
    ("dcrec_seq_adj_hop_d64", "dcrec_seq_adj", "fwd", 64, "w"),
    ("kgcl_deg_d1", "kgcl_deg", "seg", 1, None),
    ("autocf_dec_sum_d4", "autocf_dec", "seg", 4, None),
    ("autocf_dec_sum_d32", "autocf_dec", "seg", 32, None),
    ("lightgcn_hop_fold3_d96", "lightgcn", "fwd", 96, None),
    ("lightgcn_hop_d32", "lightgcn", "fwd", 32, None),
    ("lightgcn_hop_t_d32", "lightgcn", "bwd", 32, None),
    ("kgcl_seg_sum_d64", "kgcl_seg", "seg", 64, None),
    ("maerec_hop_t_d64", "maerec", "bwd", 64, "w"))
# the bf16 mode's timed shapes (names of LAYOUT_SHAPES): its pass in every
# checkout and, with two more (x rows gathered 17 and 117 times each), its
# sweep
BF16_SHAPES = ("lightgcn_hop_d32", "lightgcn_hop_t_d32", "kgcl_seg_sum_d64", "maerec_hop_d64",
               "maerec_hop_t_d64")
BF16_SWEPT = BF16_SHAPES + ("dcrec_seq_adj_hop_d64", "kcgn_ii_hop_d128")
LAYOUT_FIELDS = ("indptr", "rows", "cols", "vals", "edge_ids", "n_rows", "n_cols",
                 "ids_identity", "vals_ones", "n_ids")
SWEEP_GROUPS = (1, 2, 4, 8, 16)
SWEEP_T = (16, 32, 64, 128, 256)
SWEEP_FAN_IN = (8, 16, 32, 64)
SWEEP_BF16_GROUPS = (2, 4, 8, 16)
SWEEP_BF16_T = (16, 32, 64, 128)


def _chip_smoke():
    """This checkout's ``chip_smoke`` module (its builders and timer),
    loaded by path, importing whichever ``sslrec_tpu_torch`` comes first on
    ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_operands(path: str = OPERANDS) -> None:
    """The layouts of :data:`LAYOUT_SHAPES` as this checkout's models build
    them at their published configs (the synthetic KG, yelp_sub, the
    sports- and Tmall-shaped splits written as ``chip_smoke.py`` writes
    them; seeded weights and draws, no training), saved to ``path`` as CPU
    arrays with each multiplier and its bound."""
    import torch

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def model(name, dataset, data_dir):
        cfg = cs.load_config(name, dataset=dataset, overrides={"data.dir": data_dir})
        m = cs.build_model(cfg, cs.load_data(cfg, dev))
        m.init_params(cs.generator(7, 2))
        return m

    _, data = cs.lightgcn_data(dev)
    bi = data.extras["bi_adj"]
    ops = {"lightgcn": (bi, None),
           "adagcl_gate": (cs.skn.build_segment_layout(bi.rows, bi.n_rows, dev), None)}
    kg = cs.kgcl_shapes(dev)
    ops["kgcl_deg"], ops["kgcl_seg"] = (kg["deg"], None), (kg["seg"], None)
    dk = model("diffkg", cs.KG_DATASET, cs.SMOKE_RESULTS)
    with torch.no_grad():
        dkg = dk.epoch_state(gen)["dkg"]
    ops["diffkg_dkg_rels"], ops["diffkg_dkg_heads"] = (dkg.r, None), (dkg.h, None)
    kc = model("kcgn", cs.SOCIAL_DATASET, cs.DATA_DIR)
    ops["kcgn_ii_comp"], ops["kcgn_ii"] = (kc.ii_sub_adj, None), (kc.ii_g, None)
    ops["kcgn_ii_labels"] = (kc.ii_labels.layout, None)
    cs.write_sports_split()
    dm = model("dcrec_seq", cs.SEQ_DATASET, cs.SMOKE_RESULTS)
    ops["dcrec_seq_adj"] = (dm.adj.g, torch.rand(dm.adj.nnz, generator=gen, device=dev))
    mm = model("maerec", cs.SEQ_DATASET, cs.SMOKE_RESULTS)
    ops["maerec"] = (mm.graph, mm.one_view(mm.draws(gen))["enc_vals"])
    cs.write_mb_dataset(cs.MB_DATASET)
    cs.write_mb_extras(cs.MB_DATASET)
    km = model("kmclr", cs.MB_DATASET, cs.SMOKE_RESULTS)
    ops["kmclr_ent"], ops["kmclr_rel"] = (km.ent_lay, None), (km.rel_lay, None)
    ac = model("autocf", cs.DATASET, cs.DATA_DIR)
    with torch.no_grad():
        view = ac.one_view(ac.view_draws(gen))
    ops["autocf_dec"] = (view["dec"][0], None)
    saved = {}
    for name, op, layout, d, w in LAYOUT_SHAPES:
        g, vals = ops[op]
        lay = g.csr if layout == "seg" else getattr(g, layout)
        saved[name] = {"layout": {f: (getattr(lay, f).cpu() if torch.is_tensor(getattr(lay, f))
                                      else getattr(lay, f)) for f in LAYOUT_FIELDS},
                       "w": None if w is None else vals.cpu(), "d": d,
                       "bound": cs.bound_ms(lay, d, "none" if w is None else "mask")}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(saved, path)


def load_operands(sk, dev, path: str = OPERANDS) -> dict:
    """``{name: (layout, multiplier, d, bound)}`` of :func:`build_operands`'s
    file, each layout rebuilt by ``sk`` (a checkout's ``spmm_kernel``) on
    ``dev``."""
    import torch

    out = {}
    for name, rec in torch.load(path).items():
        f = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in rec["layout"].items()}
        lay = sk.CsrLayout(plans=sk.PlanCache(), **f)
        w = None if rec["w"] is None else rec["w"].to(dev)
        out[name] = (lay, w, rec["d"], tuple(rec["bound"]))
    return out


def run_one(root: str) -> dict:
    """Times in the package under ``root``; this function runs in a process
    of its own with ``root`` first on ``sys.path``."""
    import torch

    cs = _chip_smoke()
    from sslrec_tpu_torch.data import kg as kg_data
    from sslrec_tpu_torch.models import augment
    from sslrec_tpu_torch.models.registry import build_model
    from sslrec_tpu_torch.ops import cuda_build
    from sslrec_tpu_torch.ops import segment_kernel as skn
    from sslrec_tpu_torch.ops import spmm as tspmm
    from sslrec_tpu_torch.ops import spmm_kernel as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if not os.path.abspath(sk.__file__).startswith(os.path.abspath(root) + os.sep):
        raise AssertionError(f"imported {sk.__file__}, not the package under {root}")
    cuda_build.build_libraries(force=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    _, data = cs.lightgcn_data(dev)
    g = data.extras["bi_adj"]
    x = torch.randn(g.n_cols, 32, generator=gen, device=dev)
    key = torch.tensor([1, 2], device=dev)
    mask = sk.dropout_mask(key, g, 0.5)

    kg = cs.kgcl_shapes(dev)
    seg, deg, ui, ui_w = (kg[k] for k in ("seg", "deg", "ui", "ui_w"))
    model = build_model(kg["cfg"], kg_data.load(kg["cfg"], dev))
    x65 = torch.randn(seg.n, 65, generator=gen, device=dev)
    x1 = torch.rand(deg.n, 1, generator=gen, device=dev)
    x64 = torch.randn(ui.n_cols, 64, generator=gen, device=dev)
    logits = torch.randn(seg.n, generator=gen, device=dev)
    table = torch.randn(model.n_relations, 64, generator=gen, device=dev, requires_grad=True)
    g_rel = torch.randn(seg.n, 64, generator=gen, device=dev)

    calls = {
        "hop": lambda: tspmm.spmm(g, x),
        "hop_mask": lambda: tspmm.spmm(g, x, mask),
        "hop_mask_bwd": lambda: tspmm.spmm_t(g, x, mask),
        "hop_dropout": lambda: tspmm.spmm(g, x, augment.edge_drop(key, g, 0.5)),
        "hop_dropout_bwd": lambda: tspmm.spmm_t(g, x, augment.edge_drop(key, g, 0.5)),
        "kg_sum_d65": lambda: sk.csr_spmm(seg.csr, x65),
        "kg_sum_d1": lambda: sk.csr_spmm(deg.csr, x1),
        "ui_hop_d64": lambda: sk.csr_spmm(ui.fwd, x64, ui_w),
        "ui_hop_d64_bwd": lambda: sk.csr_spmm(ui.bwd, x64, ui_w),
        "relation_take_fwd_bwd": lambda: torch.autograd.grad(
            model.rel_take.take(table), table, g_rel),
        "b2": lambda: skn.segment_max(seg, logits)}
    library, gathered, bound, err = {}, {}, {}, {}
    layouts = load_operands(sk, dev) if os.path.exists(OPERANDS) else {}
    xs_of = {}
    for name, (lay, w, d, b) in layouts.items():
        xs = xs_of[name] = torch.randn(lay.n_cols, d, generator=gen, device=dev)
        calls[name] = lambda lay=lay, xs=xs, w=w: sk.csr_spmm(lay, xs, w)
        err[name] = cs.rel_err(sk.csr_spmm(lay, xs, w),
                               sk.csr_spmm_plain(lay, xs.double(), w).float())
        csr = cs.csr_tensor(lay, None if w is None else lay.vals * w[lay.edge_ids.long()])
        library[name] = cs.device_ms(lambda csr=csr, xs=xs: torch.sparse.mm(csr, xs), b[0])
        if w is not None:       # the values' gather made in the call
            gathered[name] = cs.device_ms(cs.library_gather(lay, xs, w), b[0])
        bound[name] = b
    ms = {name: cs.device_ms(fn, bound.get(name, (0.0,))[0]) for name, fn in calls.items()}
    return {"root": root, "ms": ms, "library_ms": library, "library_gather_ms": gathered,
            "bound_ms": bound, "rel_err": err,
            "bf16": bf16_pass(sk, cs, layouts, xs_of) if layouts else {}}


def bf16_pass(sk, cs, layouts: dict, xs_of: dict) -> dict:
    """The bf16 mode at :data:`BF16_SHAPES` in this checkout: each call's
    device time (its cast of x included), its error against the bf16 plain
    version, the cast of x alone, and ``torch.sparse.mm`` on a bfloat16 CSR
    tensor (values pre-multiplied) and bfloat16 x, cast before the call and
    in it."""
    import torch

    out = {}
    cs.set_precision(True)
    try:
        for name in BF16_SHAPES:
            lay, w, _, b = layouts[name]
            xs = xs_of[name]
            got = sk.csr_spmm(lay, xs, w)
            out[name] = {
                "ms": cs.device_ms(lambda: sk.csr_spmm(lay, xs, w), b[0]),
                "cast_ms": cs.device_ms(lambda: xs.to(torch.bfloat16)),
                "rel_err": cs.rel_err(got, sk.csr_spmm_plain(lay, xs, w)),
                "repeat_equal": bool(torch.equal(got, sk.csr_spmm(lay, xs, w)))}
    finally:
        cs.set_precision(False)
    for name in BF16_SHAPES:
        lay, w, _, _ = layouts[name]
        lib = cs.bf16_library_ms(lay, xs_of[name], w)
        out[name].update(library_ms=lib["library_ms"], library_cast_ms=lib["library_cast_ms"])
    return out


def sweep() -> dict:
    """This checkout's B1 at every narrow shape of :data:`LAYOUT_SHAPES`
    over lane groups (``SWEEP_GROUPS``) and split thresholds
    (``SWEEP_T``), and at the long-row shapes over split thresholds and the
    combine tree's fan-in (``SWEEP_FAN_IN``), at the lane group the host
    picks; each call within ``chip_smoke.TOL`` of the plain version."""
    import torch

    cs = _chip_smoke()
    from sslrec_tpu_torch.ops import cuda_build
    from sslrec_tpu_torch.ops import spmm_kernel as sk

    cuda_build.build_libraries(force=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = load_operands(sk, dev)
    out = {}
    for name, (lay, w, d, b) in ops.items():
        xs = torch.randn(lay.n_cols, d, generator=gen, device=dev)
        ref = sk.csr_spmm_plain(lay, xs.double(), w).float()    # rows up to 961,308 long
        group, t_pick = cs.schedule(lay, d)
        if d <= sk.NARROW_D:
            grid = [(gr, t, sk.FAN_IN) for gr in SWEEP_GROUPS for t in SWEEP_T]
        elif "take_bwd" in name or "comp_sum" in name:
            grid = [(group, t, r) for t in SWEEP_T for r in SWEEP_FAN_IN]
        else:
            continue
        row = {"picked": [group, t_pick], "bound_ms": b[0]}
        for gr, t, r in grid:
            plan = sk.device_split_plan(lay.indptr, t, r)
            got = sk.csr_spmm_at(lay, xs, w, gr, plan)
            cs.ErrTrack().check(f"{name} G{gr} T{t} R{r}", got, ref)
            row[f"G{gr}_T{t}_R{r}"] = cs.device_ms(
                lambda: sk.csr_spmm_at(lay, xs, w, gr, plan), b[0])
        out[name] = row
        print(json.dumps({name: row}), flush=True)
    out.update(sweep_bf16(sk, cs, ops, gen))
    return out


def sweep_bf16(sk, cs, ops: dict, gen) -> dict:
    """The bf16 mode at :data:`BF16_SWEPT` over its two row types (bf16 rows
    cast before the kernel, float32 rows rounded on load), lane groups
    (``SWEEP_BF16_GROUPS``) and split thresholds (``SWEEP_BF16_T``), each
    call within ``chip_smoke.TOL`` of the bf16 plain version, beside the
    float32 mode and the bf16 mode at the schedules the host picks and the
    cast of x alone (every bf16 time includes the call's cast, if any)."""
    import torch

    out = {}
    for name in BF16_SWEPT:
        lay, w, d, b = ops[name]
        xs = torch.randn(lay.n_cols, d, generator=gen, device=lay.indptr.device)
        row = {"bound_ms": b[0], "reads_per_row": lay.cols.shape[0] / lay.n_cols,
               "f32_picked": cs.schedule(lay, d),
               "f32_ms": cs.device_ms(lambda: sk.csr_spmm(lay, xs, w), b[0]),
               "cast_ms": cs.device_ms(lambda: xs.to(torch.bfloat16))}
        cs.set_precision(True)
        try:
            ref = sk.csr_spmm_plain(lay, xs, w)
            row["picked"] = cs.schedule(lay, d) + (sk.bf16_rows(lay, d),)
            row["bf16_ms"] = cs.device_ms(lambda: sk.csr_spmm(lay, xs, w), b[0])
            for cast in (True, False):
                for gr in SWEEP_BF16_GROUPS:
                    for t in SWEEP_BF16_T:
                        plan = sk.device_split_plan(lay.indptr, t)
                        got = sk.csr_spmm_at(lay, xs, w, gr, plan, cast)
                        key = f"{'cast' if cast else 'load'}_G{gr}_T{t}"
                        cs.ErrTrack().check(f"{name} bf16 {key}", got, ref)
                        row[key] = cs.device_ms(
                            lambda: sk.csr_spmm_at(lay, xs, w, gr, plan, cast), b[0])
        finally:
            cs.set_precision(False)
        out[f"bf16.{name}"] = row
        print(json.dumps({f"bf16.{name}": row}), flush=True)
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: torch.cuda.is_available() is False; needs a CUDA card")
    build_operands()
    if argv == ["--sweep"]:
        print(json.dumps({"sweep": sweep()}), flush=True)
        print(_chip_smoke().card_line(), flush=True)
        return 0
    for root in argv:
        root = os.path.abspath(root)
        # this file, loaded by path: the package comes from `root`
        out = subprocess.run([sys.executable, "-c",
                              "import importlib.util, sys; sys.path.insert(0, sys.argv[1]); "
                              "spec = importlib.util.spec_from_file_location('chip_compare', "
                              f"{os.path.abspath(__file__)!r}); "
                              "m = importlib.util.module_from_spec(spec); "
                              "spec.loader.exec_module(m); "
                              "sys.exit(m.main(['--one'] + sys.argv[1:]))",
                              root],
                             cwd=HERE, capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            raise SystemExit(f"chip_compare: the run of {root} failed ({out.returncode})")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(_chip_smoke().card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
