#!/usr/bin/env python3
"""Measurements behind ``chip_smoke.py`` phases 37(d) to 37(h) (the KG and
the multi-behavior families, ROADMAP Queue A item 9a's seven models and
item 9b's social five on a ``{data: 1, model: 2}`` mesh, item 9c's
sequential six on a ``{data: 2, model: 1}`` one), each on one CUDA card:

    python3 chip_kg_mesh.py phase      # phases 37(d) and (e) alone, one spawn; a table beyond
                                       # the tolerance is printed with every table's share of
                                       # it, then raised
    python3 chip_kg_mesh.py phase-mb   # phase 37(e) alone (phase 29's split written first)
    python3 chip_kg_mesh.py phase-gcf  # phase 37(f) alone (phase 29's split written first;
                                       # a missed table is held to its single run's own
                                       # move under cuBLASLt)
    python3 chip_kg_mesh.py phase-social  # phase 37(g) alone (yelp_sub; the single runs
                                          # made here, where the script reuses phases 17
                                          # and 19's)
    python3 chip_kg_mesh.py phase-seq  # phase 37(h) alone (phase 18's sports-shaped split
                                       # written first; MESH_SEQ_DATASET, its first quarter)
    python3 chip_kg_mesh.py phase-seq-whole  # the same on the whole sports-shaped split at
                                             # phase 23's settings (the depth cut's yardstick)
    python3 chip_kg_mesh.py control    # KGCL's and DiffKG's single runs on the phase's split:
                                       # again, under cuBLASLt, and twice with torch's
                                       # deterministic algorithms
    python3 chip_kg_mesh.py control-mb # the same for HMGCR, SMBRec, CML and KMCLR on 37(e)'s
    python3 chip_kg_mesh.py regions    # KGCL's mesh run against its single run, with and
                                       # without TransE: the largest difference in all_embed's
                                       # user, item and other entity rows

Each builds the kernels, writes the synthetic KG and the phase's split
(``chip_smoke.write_mesh_kg_split``; the multi-behavior ones phase 29's
Tmall-shaped split and ``chip_smoke.write_mesh_mb_split``'s; 37(f) also
``write_mesh_cf_split``'s; 37(g) reads the repo's yelp_sub; 37(h) writes
phase 18's sports-shaped split) and prints one JSON line last.
"""

from __future__ import annotations

import json
import sys
import time
import warnings

import torch

import chip_smoke as cs
from sslrec_tpu_torch import main as port_main
from sslrec_tpu_torch.ops import cuda_build


def argv(model: str, *sets: str) -> list[str]:
    root, dataset = ((cs.MESH_MB_DIR, cs.MB_DATASET) if model in cs.MESH_MB
                     else (cs.SMOKE_RESULTS, cs.MESH_KG_DATASET))
    out = ["--model", model, "--data_dir", root, "--dataset", dataset,
           "--epoch", str(cs.MESH_EPOCHS), "--device", "cuda", "--set", "train.test_step=1",
           "--set", "tune.enable=false", "--set", f"train.results_dir={cs.SMOKE_RESULTS}/kg_mesh"]
    return out + [a for s in sets for a in ("--set", s)]


def single(model: str, *sets: str) -> dict:
    tr = port_main.main(argv(model, *sets))
    return {k: v.cpu() for k, v in tr.best_state.items()}


def phase(families=("kg", "mb")) -> dict:
    """Phases 37(d), (e) and (f) (``families``), their table misses recorded
    with every table's share of ``MESH_PARAM_TOL`` before they raise."""
    check, missed = cs.mesh_kg_check, []

    def lenient(model, one, run, control=None):
        try:
            return check(model, one, run, control)
        except AssertionError as e:
            missed.append(f"{model}: {e}")
            return {"param_diff": cs.table_diff(run.best_state, one["best_state"]),
                    "param_tol_use": {}, "metric_diff": {}, "losses": [], "want_by_layout": {},
                    "by_layout_by_rank": [], "steps": 0, "test_recall20": 0.0,
                    "probe_b1_max_rel_err": 0.0, "probe_b2_layouts": []}

    cs.mesh_kg_check = lenient
    dev = torch.device("cuda")
    out = cs.mesh_kg_phase(torch.Generator(device=dev).manual_seed(0), dev, families)
    res = {"s": out["s"], "missed": missed}
    for fam, run, models in (("kg", out["run"], cs.MESH_KG_MODELS),
                             ("mb", out["mb"]["run"], cs.MESH_MB_MODELS),
                             ("gcf", out["gcf"]["run"], cs.MESH_GCF_MODELS),
                             ("social", out["social"]["run"], cs.MESH_SOCIAL_MODELS),
                             ("seq", out["seq"]["run"], cs.MESH_SEQ_MODELS)):
        if run:
            res[fam] = {"mesh_s": run["mesh_s"], "single_s": run["single_s"],
                        "split": run["split"],
                        **{m: {k: run[m].get(k) for k in ("param_diff", "param_tol_use",
                                                          "losses", "control_param_diff")}
                           for m in models}}
    if out["mb"]["hops"]:
        res["mb_hops"] = {k: {"ms": t["ms"], "plain_ms": t["plain_ms"],
                              "library_ms": t["library_ms"],
                              "bound_ms": out["mb"]["hops"]["bound"][k][0]}
                          for k, t in out["mb"]["hops"]["t"].items()}
    return res


def phase_seq_whole() -> dict:
    """Phase 37(h) on the whole sports-shaped split (phase 23's), where the
    phase runs on ``MESH_SEQ_DATASET``: what the depth cut saves."""
    cs.MESH_SEQ_DATASET = cs.SEQ_DATASET
    return phase(("seq",))


def control(models=("kgcl", "diffkg")) -> dict:
    """The single runs' own spread: repeated, under cuBLASLt, and twice under
    ``torch.use_deterministic_algorithms`` (warn only: the warnings name the
    path's nondeterministic ops)."""
    if any(m in cs.MESH_MB for m in models):
        cs.write_mesh_mb_split()
    else:
        cs.write_mesh_kg_split()
    out = {}
    for m in models:
        sets = cs.MESH_KG_ARGS.get(m, [])[1::2]
        a, b = single(m, *sets), single(m, *sets)
        with cs.gemm_order_control():
            c = single(m, *sets)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                d1, d2 = single(m, *sets), single(m, *sets)
            finally:
                torch.use_deterministic_algorithms(False)
        out[m] = {"repeat": cs.table_diff(b, a), "cublaslt": cs.table_diff(c, a),
                  "deterministic_repeat": cs.table_diff(d2, d1),
                  "nondeterministic_ops": sorted({str(x.message)[:160] for x in w
                                                  if "deterministic" in str(x.message)})}
    return out


def regions() -> dict:
    """Where KGCL's mesh run differs from its single run: ``all_embed``'s
    users, items and other entities, with and without ``train_trans``."""
    cs.write_mesh_kg_split()
    sets = {trans: f"model.train_trans={str(trans).lower()}" for trans in (True, False)}
    singles = {}
    for trans, s in sets.items():
        tr = port_main.main(argv("kgcl", s))
        singles[trans] = ({k: v.cpu() for k, v in tr.best_state.items()}, tr.data.user_num,
                          tr.data.item_num)
        del tr
    runs = cs.mesh_spawn([argv("kgcl", s) for s in sets.values()], cs.MESH_KG_RUN)
    out = {}
    for trans, run in zip(sets, runs):
        one, u, i = singles[trans]
        d = (run.best_state["all_embed"] - one["all_embed"]).abs()
        tol = cs.MESH_PARAM_TOL["atol"] + cs.MESH_PARAM_TOL["rtol"] * one["all_embed"].abs()
        out[f"train_trans={trans}"] = {
            "tables": cs.table_diff(run.best_state, one),
            **{name: {"max": float(d[sl].max()), "over_1e-5": int((d[sl] > 1e-5).sum()),
                      "over_tolerance": int((d[sl] > tol[sl]).sum()), "n": int(d[sl].numel())}
               for name, sl in (("users", slice(0, u)), ("items", slice(u, u + i)),
                                ("others", slice(u + i, None)))}}
    return out


def main() -> int:
    what = sys.argv[1] if len(sys.argv) > 1 else "phase"
    cs.MESH_MB_TIMED = cs.MESH_MB_TIMED_ALL
    runs = {"phase": phase, "phase-mb": lambda: phase(("mb",)),
            "phase-gcf": lambda: phase(("gcf",)), "phase-social": lambda: phase(("social",)),
            "phase-seq": lambda: phase(("seq",)), "phase-seq-whole": phase_seq_whole,
            "control": control,
            "control-mb": lambda: control(cs.MESH_MB_MODELS), "regions": regions}
    if what not in runs:
        raise SystemExit(f"chip_kg_mesh: {what!r}: one of {', '.join(runs)}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_kg_mesh: needs a CUDA card")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs.log(cs.card_line())
    cuda_build.build_libraries(force=True)
    if what in ("phase", "control", "regions"):
        cs.write_kg_dataset(cs.KG_DATASET, *cs.synthetic_kg())
    if what in ("phase", "phase-mb", "phase-gcf", "control-mb"):
        cs.write_mb_dataset(cs.MB_DATASET)
    if what.startswith("phase-seq"):
        cs.write_sports_split()
    out = runs[what]()
    print(json.dumps({what: out, "total_s": time.perf_counter() - t0}), flush=True)
    return 1 if out.get("missed") else 0


if __name__ == "__main__":
    sys.exit(main())
