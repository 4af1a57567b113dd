#!/usr/bin/env python3
"""B1 and B2 device times at the main paths' shapes, for several checkouts of
this repo on one card, so that a kernel's earlier and current versions are
compared within one run.

    python3 chip_compare.py <checkout> [<checkout> ...]    # e.g. parent . . parent

Needs one CUDA card and ``nvcc``.  Each checkout runs in its own process, in
the order given, and builds its own kernels into its own ``build/``.  The
operands are this checkout's ``chip_smoke.lightgcn_data`` and
``chip_smoke.kgcl_shapes``; each is timed (``chip_smoke.device_ms``) through
the call the models make, so every checkout runs its own version of it:

- the LightGCN hop (d 32) through ``ops.spmm.spmm`` / ``spmm_t``: no
  multiplier; a materialised dropout mask (``dropout_mask``); and the
  training hop's dropout, ``augment.edge_drop``'s multiplier built in the
  call, as each training step builds it;
- KGCL: B1 as the segment sum at d 65 and d 1 and as the UI hop at d 64 under
  a view's values (both layouts), through ``csr_spmm``; the relation take's
  forward and backward as the model runs them (``KGCL.rel_take``); and B2.

A checkout needs those entry points and the ones the two builders call.
Prints one JSON line per checkout, then the card line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's ``chip_smoke`` module (its builders and timer),
    loaded by path, importing whichever ``sslrec_tpu_torch`` comes first on
    ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    return {"root": root, "ms": {name: cs.device_ms(fn) for name, fn in calls.items()}}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: torch.cuda.is_available() is False; needs a CUDA card")
    for root in argv:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c",
                              "import sys; sys.path.insert(0, sys.argv[1]); "
                              f"sys.path.insert(1, {HERE!r}); import chip_compare; "
                              "sys.exit(chip_compare.main(['--one'] + sys.argv[1:]))",
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
