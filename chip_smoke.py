#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sslrec_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME``, default ``/usr/local/cuda``).
Phases, in order; any failure raises and the script exits non-zero:

1. card check: ``torch.cuda.is_available()``, the card's name and power limit;
2. build the CSR SpMM kernel from ``sslrec_tpu_torch/csrc/csr_spmm.cu``;
3. hold the kernel against its plain PyTorch version at the main path's
   shape (the alibaba-fashion bipartite adjacency, both layouts, no weight /
   dropout mask / learned weight with dx and dew) and on edge cases (widths
   1..64, empty rows, a rectangular graph): max |k - p| / max |p| <= 1e-5;
4. time kernel, plain version and ``torch.sparse.mm`` with CUDA events;
5. drive the main path, ``sslrec_tpu_torch.main`` (LightGCN, 2 epochs), with
   the kernel's launch count reset just before and read just after; check
   losses, metrics and the trained embeddings against the plain propagation,
   and one training step on a small graph against the same step on the CPU;
6. print the ``{"kernels": [...]}`` line, then the card line, then
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch import main as port_main
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.data import general_cf
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.ops.sparse import from_scipy
from sslrec_tpu_torch.trainer.trainer import Trainer, generator

TOL = 1e-5                  # max |kernel - plain| / max |plain|
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
SMOKE_RESULTS = "smoke_results"
DATA_DIR, DATASET = "datasets", "alibaba-fashion"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class ErrTrack:
    """Largest absolute and relative (to max |plain|) error over all checks."""

    def __init__(self):
        self.abs = 0.0
        self.rel = 0.0

    def check(self, what: str, got: torch.Tensor, ref: torch.Tensor) -> None:
        if got.shape != ref.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite values")
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        rel = err / scale if scale > 0 else err
        self.abs, self.rel = max(self.abs, err), max(self.rel, rel)
        if rel > TOL:
            raise AssertionError(f"{what}: rel err {rel:.3g} > {TOL}")


def check_graph(errs: ErrTrack, name: str, g: sk.CsrGraph, widths, gen, with_grads):
    """Kernel against plain on both directions of ``g``: no weight, a PRF
    dropout mask and (``with_grads``) a learned weight with dx and dew."""
    dev = g.vals.device
    mask = sk.dropout_mask(torch.tensor([12345, 678], device=dev), g, 0.5).w
    for direction, gd in (("fwd", g), ("bwd", g.t())):
        lay = gd.fwd
        for d in widths:
            x = torch.randn(gd.n_cols, d, generator=gen, device=dev)
            tag = f"{name}.{direction}.d{d}"
            errs.check(f"{tag}.plain", sk.csr_spmm(lay, x), sk.csr_spmm_plain(lay, x))
            errs.check(f"{tag}.mask", sk.csr_spmm(lay, x, mask),
                       sk.csr_spmm_plain(lay, x, mask))
            if not with_grads:
                continue
            ew = torch.rand(gd.nnz, generator=gen, device=dev)
            w_out = torch.randn(gd.n_rows, d, generator=gen, device=dev)
            xk, ewk = x.clone().requires_grad_(), ew.clone().requires_grad_()
            yk = sk.SpmmFn.apply(gd, xk, ewk)
            (yk * w_out).sum().backward()
            xp, ewp = x.clone().requires_grad_(), ew.clone().requires_grad_()
            yp = sk.csr_spmm_plain(lay, xp, ewp)
            (yp * w_out).sum().backward()
            errs.check(f"{tag}.weight", yk.detach(), yp.detach())
            errs.check(f"{tag}.weight.dx", xk.grad, xp.grad)
            errs.check(f"{tag}.weight.dew", ewk.grad, ewp.grad)
            xm = x.clone().requires_grad_()
            (sk.SpmmPvFn.apply(gd, xm, mask) * w_out).sum().backward()
            xq = x.clone().requires_grad_()
            (sk.csr_spmm_plain(lay, xq, mask) * w_out).sum().backward()
            errs.check(f"{tag}.mask.dx", xm.grad, xq.grad)
    torch.cuda.synchronize()
    log(f"  {name}: {g.n_rows}x{g.n_cols}, nnz {g.nnz}, widths {list(widths)}: ok")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median of ``iters`` single-call CUDA-event timings, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(lay: sk.CsrLayout, d: int, masked: bool) -> tuple[float, str]:
    """Least time for one hop: each input read once, the output written once,
    over HBM bandwidth; 2·nnz·d flops over the float32 peak; the larger."""
    nnz = lay.cols.shape[0]
    n_bytes = 4 * (lay.n_cols * d + lay.n_rows * d + 2 * nnz + lay.n_rows + 1)
    flops = 2 * nnz * d
    if masked:  # edge_ids + mask read, one more multiply per edge
        n_bytes += 4 * 2 * nnz
        flops += nnz
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def small_step_check(errs: ErrTrack) -> None:
    """One LightGCN training step on a small seeded graph, on the card and on
    the CPU from the same weights, batch and dropout key."""
    rng = np.random.default_rng(7)
    n_u, n_i = 300, 200
    rows = np.concatenate([rng.integers(0, n_u, 3000), np.arange(n_u)])
    cols = np.concatenate([rng.integers(0, n_i, 3000), rng.integers(0, n_i, n_u)])
    trn = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n_u, n_i))
    trn = (trn.tocsr() != 0).astype(np.float32).tocoo()
    cfg = load_config("lightgcn", overrides={"train.batch_size": 256})
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        data = bundle_from_matrices(trn, None, trn, device=dev)
        model = build_model(cfg, data)
        model.init_params(generator(1, 2))
        trainer = Trainer(cfg, model, data)
        idx, negs, keys = trainer.epoch_draws(0)
        b = idx[0]
        batch = {"user": data.train_users[b], "pos": data.train_items[b], "neg": negs[b]}
        loss, _ = model.loss(batch, keys[0])
        loss.backward()
        losses[dev] = loss.detach().reshape(1).cpu()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    errs.check("small.loss", losses["cuda"], losses["cpu"])
    for k in grads["cpu"]:
        errs.check(f"small.grad.{k}", grads["cuda"][k], grads["cpu"][k])
    log(f"  small graph step, card vs CPU: loss {float(losses['cuda'][0]):.6f}: ok")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    log("== 1. card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== 2. build")
    t0 = time.perf_counter()
    so, out = sk.build_library(force=True)
    log(f"built {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("== 3. kernel against plain")
    t0 = time.perf_counter()
    cfg = load_config("lightgcn", dataset=DATASET, overrides={"data.dir": DATA_DIR})
    data = general_cf.load(cfg, dev)
    g = data.extras["bi_adj"]
    log(f"loaded {DATASET} in {time.perf_counter() - t0:.1f} s: {data.user_num} users, "
        f"{data.item_num} items, {data.n_train} train pairs; bi-adjacency "
        f"{g.n_rows} nodes, {g.nnz} edges")
    errs = ErrTrack()
    gen = torch.Generator(device=dev).manual_seed(0)
    check_graph(errs, "bi_adj", g, (32,), gen, with_grads=True)
    main_abs, main_rel = errs.abs, errs.rel
    check_graph(errs, "bi_adj", g, (1, 8, 33, 64), gen, with_grads=False)
    rect = sk.build_csr_graph(from_scipy(data.extras["train_mat_scipy"]), dev)
    check_graph(errs, "train_mat", rect, (1, 8, 32, 33, 64), gen, with_grads=True)
    rng = np.random.default_rng(3)
    m = sp.random(5000, 3000, density=0.002, random_state=rng, format="coo")
    live = (m.row < 1000) | (m.row >= 4000)   # rows 1000..3999 empty
    m = sp.coo_matrix((m.data[live], (m.row[live], m.col[live])), shape=m.shape)
    check_graph(errs, "empty_rows", sk.build_csr_graph(from_scipy(m), dev),
                (1, 32, 33), gen, with_grads=True)
    log(f"max abs err {errs.abs:.3g}, max rel err {errs.rel:.3g} (tolerance {TOL}); "
        f"main-path shape: abs {main_abs:.3g}, rel {main_rel:.3g}")

    log("== 4. timing")
    d = int(cfg.model.embedding_size)
    lay = g.fwd
    x = torch.randn(g.n_cols, d, generator=gen, device=dev)
    mask = sk.dropout_mask(torch.tensor([1, 2], device=dev), g, 0.5).w
    csr_t = torch.sparse_csr_tensor(lay.indptr, lay.cols, lay.vals,
                                    size=(lay.n_rows, lay.n_cols))
    launches_before = sk.csr_spmm.launches
    t = {
        "plain": time_ms(lambda: sk.csr_spmm_plain(lay, x)),
        "kernel": time_ms(lambda: sk.csr_spmm(lay, x)),
        "library": time_ms(lambda: torch.sparse.mm(csr_t, x)),
        "kernel_masked": time_ms(lambda: sk.csr_spmm(lay, x, mask)),
        "plain_masked": time_ms(lambda: sk.csr_spmm_plain(lay, x, mask)),
        "kernel_bwd_masked": time_ms(lambda: sk.csr_spmm(g.bwd, x, mask)),
    }
    t["kernel_2"] = time_ms(lambda: sk.csr_spmm(lay, x))
    t["plain_2"] = time_ms(lambda: sk.csr_spmm_plain(lay, x))
    b_ms, b_by = bound_ms(lay, d, masked=False)
    bm_ms, _ = bound_ms(lay, d, masked=True)
    for k, v in t.items():
        log(f"  {k:18s} {v * 1e3:9.2f} us")
    log(f"  bound {b_ms * 1e3:.2f} us ({b_by}); masked {bm_ms * 1e3:.2f} us; "
        f"kernel at {100 * b_ms / t['kernel']:.1f}% of the bound")
    assert sk.csr_spmm.launches > launches_before

    log("== 5. main path")
    argv = ["--model", "lightgcn", "--data_dir", DATA_DIR, "--dataset", DATASET,
            "--epoch", "2", "--device", "cuda", "--set", "train.test_step=1",
            "--set", f"train.results_dir={SMOKE_RESULTS}"]
    sk.csr_spmm.launches = 0
    trainer = port_main.main(argv)
    launches = sk.csr_spmm.launches
    rows = trainer.recorder.epochs
    steps = len(rows) * trainer.n_batches
    log(f"kernel launches {launches} over {steps} steps "
        f"({launches / steps:.2f} per step, incl. evaluation)")
    if launches < 4 * steps:
        raise AssertionError(f"csr_spmm launched {launches} times, want >= {4 * steps}")
    losses = [r["loss"]["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses) or not losses[1] < losses[0]:
        raise AssertionError(f"losses {losses}: want finite and decreasing")
    r20 = [r["valid"]["recall"][1] for r in rows]
    if not min(r20) > 0:
        raise AssertionError(f"valid recall@20 {r20}: want > 0")
    for r in rows:
        log(f"  epoch {r['epoch']}: loss {r['loss']['loss']:.6f}, train "
            f"{r['train_s']:.3f} s ({r['train_examples'] / r['train_s']:.0f} examples/s), "
            f"valid recall@20 {r['valid']['recall'][1]:.5f}, eval {r['eval_s']:.3f} s "
            f"({r['eval_users'] / r['eval_s']:.0f} users/s)")
    log(f"  test recall@20 {trainer.test_results['recall'][1]:.5f}, "
        f"ndcg@20 {trainer.test_results['ndcg'][1]:.5f}")
    model = trainer.model
    with torch.no_grad():
        u, i = model.generate()
        e = torch.cat([model.user_embeds, model.item_embeds])
        acc, h = e.clone(), e
        for _ in range(model.layer_num):
            h = sk.csr_spmm_plain(model.adj.fwd, h)
            acc += h
    errs.check("generate", torch.cat([u, i]), acc)
    log(f"  trained embeddings {tuple(u.shape)} + {tuple(i.shape)} finite, "
        f"= plain propagation: ok")
    small_step_check(errs)

    log("== 6. result")
    kernel = {
        "name": "csr_spmm", "route": "cuda",
        "source": "sslrec_tpu_torch/csrc/csr_spmm.cu",
        "replaces": "sslrec_tpu/ops/pallas_spmm.py:123",
        "replaces_fn": "sslrec_tpu/ops/pallas_spmm.py::_spmm_kernel",
        "launches": launches, "launches_per_step": launches / steps,
        "max_abs_err": main_abs, "max_rel_err": main_rel,
        "max_rel_err_all_checks": errs.rel,
        "shape": {"n_rows": lay.n_rows, "n_cols": lay.n_cols,
                  "nnz": int(lay.cols.shape[0]), "d": d},
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": t["library"],
        "ms_masked": t["kernel_masked"], "plain_ms_masked": t["plain_masked"],
        "bound_ms_masked": bm_ms, "ms_bwd_masked": t["kernel_bwd_masked"],
    }
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
