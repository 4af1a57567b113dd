#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sslrec_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``$CUDA_HOME``, default ``/usr/local/cuda``).
Phases, in order; any failure raises and the script exits non-zero:

1. card check: ``torch.cuda.is_available()``, the card's name and power limit;
2. build both kernels, B1 ``csrc/csr_spmm.cu`` and B2 ``csrc/segment_max.cu``
   (one nvcc each, started together), and log ptxas's lines for both;
3. hold B1 against its plain PyTorch version at the LightGCN path's shape
   (the alibaba-fashion bipartite adjacency, both layouts, no weight /
   dropout mask / learned weight with dx and dew) and on edge cases (widths
   1..64, empty rows, a rectangular graph): max |k - p| / max |p| <= 1e-5;
4. time B1, its plain version and ``torch.sparse.mm`` with CUDA events;
5. drive the LightGCN path, ``sslrec_tpu_torch.main --model lightgcn`` (2
   epochs), with the launch counts reset just before and read just after;
   check losses, metrics and the trained embeddings against the plain
   propagation, and one training step on a small graph against the CPU;
6. write the synthetic-at-scale KG dataset (a copy of the JAX benchmark's
   generator) and hold B2 against its plain version at the KGCL shape
   (297,404 logits into 30,000 segments) and on edge cases, exactly
   (``torch.equal``, −inf included); hold B1 as segment sum, gather and
   fused attention (values and gradients, d = 64 and 65) within 1e-5;
7. time B2, its plain version and ``scatter_reduce_``, and B1 as the
   [297,404 × 65] segment sum, with CUDA events;
8. drive the KGCL path, ``sslrec_tpu_torch.main --model kgcl`` (2 epochs) on
   that dataset, with the launch counts reset around it; check losses, the
   launch counts per step, the trained embeddings against the same forward
   on the CPU's plain versions, and one step on a small KG against the CPU;
9. print the ``{"kernels": [...]}`` line, then the card line, then
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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sslrec_tpu_torch import main as port_main
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.data import general_cf
from sslrec_tpu_torch.data import kg as kg_data
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.ops import cuda_build
from sslrec_tpu_torch.ops import segment as plain_seg
from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.ops.sparse import from_scipy
from sslrec_tpu_torch.profile_epoch import device_us
from sslrec_tpu_torch.trainer.trainer import Trainer, generator

TOL = 1e-5                  # max |kernel - plain| / max |plain|
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
SMOKE_RESULTS = "smoke_results"
DATA_DIR, DATASET = "datasets", "alibaba-fashion"
KG_DATASET = "synthetic"    # written under SMOKE_RESULTS/kg/synthetic_kg/
# B1 / B2 launches per KGCL training step, counted from the code: the forward
# runs 3 RGATs of 2 hops (one B2 max and one B1 [n, d+1] sum each), 3 UI
# propagations of 2 B1 hops and one B1 degree sum for the node-dropout view
# (13 B1, 6 B2); the backward runs the 6 UI hops on the transposed layout and
# a B1 segment sum for each endpoint gather, 2 shared by hop 0 and 6 of hop 1
# (14 B1).  Each epoch adds epoch_state (6 B1, 4 B2) and each evaluation's
# generate() 5 B1 and 2 B2.
KGCL_B1_PER_STEP, KGCL_B2_PER_STEP = 27, 6


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


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, after a warm-up: the summed durations of
    the kernels, copies and memsets that ``iters`` calls put on the card
    (torch.profiler), over ``iters``.  Host time between launches is not in
    it, so it is the kernel's own time even where the host is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / iters / 1e3


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median of ``iters`` single-call CUDA-event timings, after a warm-up.
    A call shorter than its host-side launch path measures that path."""
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


def check_exact(what: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """Kernel equal to plain, element for element, −inf included."""
    if got.shape != ref.shape or not torch.equal(got, ref):
        n_bad = int((got != ref).sum()) if got.shape == ref.shape else -1
        raise AssertionError(f"{what}: kernel != plain ({n_bad} entries differ)")


def synthetic_kg(n_users=20000, n_items=15000, n_ents=30000, n_rels=20,
                 n_cf=200000, n_trip=150000, n_test=20000, seed=0):
    """A copy of the JAX package's benchmark generator (``bench.py``
    ``_synthetic_kg_scaled``, which imports JAX): unique train and test
    (u, i) pairs, and the unique raw (h, r, t) triples before the inverse
    expansion, which ``read_triplets`` redoes."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n_cf + n_users)
    users[:n_users] = np.arange(n_users)
    items = rng.integers(0, n_items, n_cf + n_users)
    train_cf = np.unique(np.stack([users, items], 1), axis=0)
    tu = rng.integers(0, n_users, n_test)
    ti = rng.integers(0, n_items, n_test)
    test_cf = np.unique(np.stack([tu, ti], 1), axis=0)
    raw = np.stack([rng.integers(0, n_ents, n_trip),
                    rng.integers(0, n_rels, n_trip),
                    rng.integers(0, n_ents, n_trip)], 1)
    raw[: n_ents, 0] = np.arange(n_ents)
    return train_cf, test_cf, np.unique(raw, axis=0)


def write_kg_dataset(name: str, train_cf, test_cf, triples) -> None:
    """The KG handler's layout under ``SMOKE_RESULTS/kg/<name>_kg/``."""
    d = os.path.join(SMOKE_RESULTS, "kg", f"{name}_kg")
    os.makedirs(d, exist_ok=True)
    for fname, pairs in (("train.txt", train_cf), ("test.txt", test_cf)):
        users, starts = np.unique(pairs[:, 0], return_index=True)
        with open(os.path.join(d, fname), "w") as f:
            for u, items in zip(users, np.split(pairs[:, 1], starts[1:])):
                f.write(" ".join(map(str, [u, *items])) + "\n")
    np.savetxt(os.path.join(d, "kg_final.txt"), triples, fmt="%d")


def attn_plain(ids, num_segments, logits, values, mask):
    """The fused attention's plain counterpart: segment softmax, mask, sum."""
    e = plain_seg.segment_softmax(logits, ids, num_segments) * mask
    return plain_seg.segment_sum(values * e[:, None], ids, num_segments)


def check_segment_ops(errs: ErrTrack, lay: skn.SegmentLayout, gen) -> None:
    """B2 exactly equal to its plain version at the KGCL shape and on edge
    cases; B1 as segment sum, gather and fused attention (values and
    gradients) against their plain versions at the KGCL shape."""
    dev = lay.ids.device
    n, S = lay.n, lay.num_segments
    logits = torch.randn(n, generator=gen, device=dev) * 5
    keep = torch.rand(n, generator=gen, device=dev) < 0.5
    for tag, data in (("logits", logits),
                      ("masked", torch.where(keep, logits, -1e9)),
                      ("all_masked", torch.full((n,), -1e9, device=dev))):
        check_exact(f"segmax.kgcl.{tag}", skn.segment_max(lay, data),
                    skn.segment_max_plain(lay, data))
    ids = lay.ids.cpu().numpy()
    rng = np.random.default_rng(11)
    long = np.concatenate([np.zeros(5000), np.ones(1025), np.full(1024, 2),
                           rng.integers(3, 50, 3000)]).astype(np.int64)
    cases = {"empty_segments": (ids[(ids < 1000) | (ids >= 2000)], S),
             "one_element": (rng.permutation(5000), 6000),
             "long_segments": (rng.permutation(long), 60),
             "n0": (np.zeros(0, np.int64), 100)}
    for tag, (ids_c, s_c) in cases.items():
        lay_c = skn.build_segment_layout(ids_c, s_c, dev)
        data = torch.randn(ids_c.size, generator=gen, device=dev)
        got = skn.segment_max(lay_c, data)
        check_exact(f"segmax.{tag}", got, skn.segment_max_plain(lay_c, data))
        log(f"  B2 {tag}: n {ids_c.size}, {s_c} segments, "
            f"{int(torch.isinf(got).sum())} empty (-inf): exact")
    for d in (64, 65):
        x = torch.randn(n, d, generator=gen, device=dev)
        w_out = torch.randn(S, d, generator=gen, device=dev)
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        yk = skn.SegmentSumFn.apply(lay, xk)
        (yk * w_out).sum().backward()
        yp = plain_seg.segment_sum(xp, lay.ids, S)
        (yp * w_out).sum().backward()
        errs.check(f"segsum.d{d}", yk.detach(), yp.detach())
        errs.check(f"segsum.d{d}.grad", xk.grad, xp.grad)
        table = torch.randn(S, d, generator=gen, device=dev)
        w_e = torch.randn(n, d, generator=gen, device=dev)
        tk, tp = table.clone().requires_grad_(), table.clone().requires_grad_()
        yk = skn.TakeFn.apply(lay, tk)
        (yk * w_e).sum().backward()
        yp = tp[lay.ids]
        (yp * w_e).sum().backward()
        errs.check(f"take.d{d}", yk.detach(), yp.detach())
        errs.check(f"take.d{d}.grad", tk.grad, tp.grad)
    mask = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    mask[lay.ids == 0] = 0.0                           # a fully masked head
    values = torch.randn(n, 64, generator=gen, device=dev)
    w_out = torch.randn(S, 64, generator=gen, device=dev)

    def run(fn):
        lg, v = logits.clone().requires_grad_(), values.clone().requires_grad_()
        out = fn(torch.where(mask > 0, lg, -1e9), v)
        (out * w_out).sum().backward()
        return out.detach(), lg.grad, v.grad

    got = run(lambda lg, v: skn.attn_aggregate(lay, lg, v, mask)[0])
    ref = run(lambda lg, v: attn_plain(lay.ids, S, lg, v, mask))
    for tag, a, b in zip(("value", "dlogits", "dvalues"), got, ref):
        errs.check(f"attn.{tag}", a, b)
    torch.cuda.synchronize()


def time_segment_ops(lay: skn.SegmentLayout, gen) -> dict[str, float]:
    """B2, its plain version and ``scatter_reduce_``; B1 as the [n × 65]
    segment sum, its plain version and ``torch.sparse.mm``; in turns."""
    dev = lay.ids.device
    logits = torch.randn(lay.n, generator=gen, device=dev)
    ids64 = lay.ids.long()
    out = torch.full((lay.num_segments,), float("-inf"), device=dev)
    x65 = torch.randn(lay.n, 65, generator=gen, device=dev)
    csr_t = torch.sparse_csr_tensor(lay.csr.indptr, lay.csr.cols, lay.csr.vals,
                                    size=(lay.num_segments, lay.n))
    launches_before = skn.segment_max.launches
    t = {
        "b2_plain": time_ms(lambda: skn.segment_max_plain(lay, logits)),
        "b2_kernel": time_ms(lambda: skn.segment_max(lay, logits)),
        "b2_library": time_ms(lambda: out.scatter_reduce_(0, ids64, logits, "amax",
                                                          include_self=False)),
        "b1_plain": time_ms(lambda: sk.csr_spmm_plain(lay.csr, x65)),
        "b1_kernel": time_ms(lambda: sk.csr_spmm(lay.csr, x65)),
        "b1_library": time_ms(lambda: torch.sparse.mm(csr_t, x65)),
    }
    t["b2_kernel_2"] = time_ms(lambda: skn.segment_max(lay, logits))
    t["b2_plain_2"] = time_ms(lambda: skn.segment_max_plain(lay, logits))
    dt = {
        "b2_kernel": device_ms(lambda: skn.segment_max(lay, logits)),
        "b2_plain": device_ms(lambda: skn.segment_max_plain(lay, logits)),
        "b2_library": device_ms(lambda: out.scatter_reduce_(0, ids64, logits, "amax",
                                                            include_self=False)),
        "b1_kernel": device_ms(lambda: sk.csr_spmm(lay.csr, x65)),
        "b1_plain": device_ms(lambda: sk.csr_spmm_plain(lay.csr, x65)),
        "b1_library": device_ms(lambda: torch.sparse.mm(csr_t, x65)),
    }
    assert skn.segment_max.launches > launches_before
    return t, dt


def segmax_bound_ms(lay: skn.SegmentLayout) -> tuple[float, str]:
    """Least time for one segment max: data, perm and indptr read once, the
    output written once, over HBM bandwidth; one compare per element over
    the float32 peak; the larger."""
    n_bytes = 4 * (2 * lay.n + 2 * lay.num_segments + 1)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, lay.n / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kgcl_small_step_check(errs: ErrTrack, devices=("cpu", "cuda")) -> None:
    """One KGCL epoch_state and training step on a small seeded KG, on the
    card and on the CPU, from the same weights, batch and injected draws."""
    write_kg_dataset("small", *synthetic_kg(300, 200, 400, 5, 3000, 2000, n_test=500,
                                            seed=7))
    cfg = load_config("kgcl", dataset="small", overrides={"data.dir": SMOKE_RESULTS})
    rng = np.random.default_rng(8)
    out, draws = {}, None
    for dev in devices:
        data = kg_data.load(cfg, dev)
        model = build_model(cfg, data)
        model.init_params(generator(1, 2))
        if draws is None:
            n_kg, n_rect = model.heads.shape[0], model.bi.nnz_rect
            hops = (model.context_hops, model.n_entities, model.embedding_size)
            draws = ({"kg_mask1": (rng.random(n_kg) < 0.5).astype(np.float32),
                      "kg_mask2": (rng.random(n_kg) < 0.5).astype(np.float32),
                      "view_u1": rng.random(n_rect).astype(np.float32),
                      "view_u2": rng.random(n_rect).astype(np.float32)},
                     {"rect_keep": (rng.random(n_rect) < 0.5).astype(np.float32),
                      "kg_keep": (rng.random(n_kg) < 0.5).astype(np.float32),
                      "mess_keep": rng.random(hops) < 0.9},
                     {k: rng.integers(0, hi, 256).astype(np.int32) for k, hi in
                      (("user", data.user_num), ("pos", data.item_num),
                       ("neg", data.item_num))})

        def on(d):
            return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}

        aux = model.epoch_state(None, on(draws[0]))
        batch = {**on(draws[2]), "aux": aux}
        loss, _ = model.loss(batch, None, draws=on(draws[1]))
        loss.backward()
        out[dev] = (loss.detach().reshape(1).cpu(), {k: v.cpu() for k, v in aux.items()},
                    {k: p.grad.cpu() for k, p in model.named_parameters()
                     if p.grad is not None})
    ref, got = out[devices[0]], out[devices[1]]
    errs.check("kgcl.small.loss", got[0], ref[0])
    for k in ref[1]:
        errs.check(f"kgcl.small.aux.{k}", got[1][k], ref[1][k])
    for k in ref[2]:
        errs.check(f"kgcl.small.grad.{k}", got[2][k], ref[2][k])
    log(f"  small KG epoch_state + step, card vs CPU: loss {float(got[0][0]):.6f}: ok")


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
    built = cuda_build.build_libraries(force=True)
    log(f"built {', '.join(os.path.relpath(so) for so, _ in built.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for name, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("== 3. B1 against plain")
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

    log("== 4. B1 timing")
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
    dt = {"kernel": device_ms(lambda: sk.csr_spmm(lay, x)),
          "plain": device_ms(lambda: sk.csr_spmm_plain(lay, x)),
          "library": device_ms(lambda: torch.sparse.mm(csr_t, x))}
    b_ms, b_by = bound_ms(lay, d, masked=False)
    bm_ms, _ = bound_ms(lay, d, masked=True)
    for k, v in t.items():
        log(f"  {k:18s} {v * 1e3:9.2f} us (events)")
    for k, v in dt.items():
        log(f"  {k:18s} {v * 1e3:9.2f} us (device)")
    log(f"  bound {b_ms * 1e3:.2f} us ({b_by}); masked {bm_ms * 1e3:.2f} us; "
        f"kernel at {100 * b_ms / dt['kernel']:.1f}% of the bound")
    assert sk.csr_spmm.launches > launches_before

    log("== 5. LightGCN path")
    argv = ["--model", "lightgcn", "--data_dir", DATA_DIR, "--dataset", DATASET,
            "--epoch", "2", "--device", "cuda", "--set", "train.test_step=1",
            "--set", f"train.results_dir={SMOKE_RESULTS}"]
    sk.csr_spmm.launches = skn.segment_max.launches = 0
    trainer = port_main.main(argv)
    launches, lgcn_b2 = sk.csr_spmm.launches, skn.segment_max.launches
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

    log("== 6. B2 and the segment ops against plain, KGCL shape")
    t0 = time.perf_counter()
    synth = synthetic_kg()
    write_kg_dataset(KG_DATASET, *synth)
    kg_cfg = load_config("kgcl", dataset=KG_DATASET, overrides={"data.dir": SMOKE_RESULTS})
    kg_cpu = kg_data.load(kg_cfg, "cpu")
    ex = kg_cpu.extras
    log(f"wrote and loaded {KG_DATASET} in {time.perf_counter() - t0:.1f} s: "
        f"{kg_cpu.user_num} users, {kg_cpu.item_num} items, {kg_cpu.n_train} train pairs, "
        f"{kg_cpu.test.n_test_users} test users; {ex['kg_triplets_full'].shape[0]} triplets "
        f"over {ex['entity_num']} entities and {ex['relation_num']} relations, "
        f"{ex['kg_heads'].shape[0]} kept by the per-head cap; UI bi-adjacency "
        f"{ex['bi_adj_maskable'].n_nodes} nodes, {ex['bi_adj_maskable'].graph.nnz} edges")
    seg_lay = skn.build_segment_layout(ex["kg_heads"], ex["entity_num"], dev)
    seg_errs = ErrTrack()
    check_segment_ops(seg_errs, seg_lay, gen)
    log(f"B2 exact in every case; B1 segment ops max abs err {seg_errs.abs:.3g}, "
        f"max rel err {seg_errs.rel:.3g} (tolerance {TOL})")

    log("== 7. segment timing")
    ts, dts = time_segment_ops(seg_lay, gen)
    b2_bound, b2_by = segmax_bound_ms(seg_lay)
    b1s_bound, b1s_by = bound_ms(seg_lay.csr, 65, masked=False)
    for k, v in ts.items():
        log(f"  {k:18s} {v * 1e3:9.2f} us (events)")
    for k, v in dts.items():
        log(f"  {k:18s} {v * 1e3:9.2f} us (device)")
    log(f"  B2 bound {b2_bound * 1e3:.2f} us ({b2_by}); B1 [n x 65] bound "
        f"{b1s_bound * 1e3:.2f} us ({b1s_by})")

    log("== 8. KGCL path")
    argv = ["--model", "kgcl", "--data_dir", SMOKE_RESULTS, "--dataset", KG_DATASET,
            "--epoch", "2", "--device", "cuda", "--set", "train.test_step=1",
            "--set", f"train.results_dir={SMOKE_RESULTS}"]
    sk.csr_spmm.launches = skn.segment_max.launches = 0
    kg_trainer = port_main.main(argv)
    kg_b1, kg_b2 = sk.csr_spmm.launches, skn.segment_max.launches
    kg_rows = kg_trainer.recorder.epochs
    kg_steps = len(kg_rows) * kg_trainer.n_batches
    n_evals = len(kg_rows) + 2      # every epoch, best valid, test
    want_b1 = KGCL_B1_PER_STEP * kg_steps + 6 * len(kg_rows) + 5 * n_evals
    want_b2 = KGCL_B2_PER_STEP * kg_steps + 4 * len(kg_rows) + 2 * n_evals
    log(f"launches over {kg_steps} steps: B1 {kg_b1} ({kg_b1 / kg_steps:.2f} per step; "
        f"{want_b1} counted from the code), B2 {kg_b2} ({kg_b2 / kg_steps:.2f} per step; "
        f"{want_b2} counted from the code)")
    if kg_b2 < KGCL_B2_PER_STEP * kg_steps or kg_b1 < KGCL_B1_PER_STEP * kg_steps:
        raise AssertionError(f"KGCL launched B1 {kg_b1}, B2 {kg_b2} times; want >= "
                             f"{KGCL_B1_PER_STEP} and {KGCL_B2_PER_STEP} per step")
    kg_losses = [r["loss"]["loss"] for r in kg_rows]
    if not all(math.isfinite(v) for v in kg_losses) or not kg_losses[1] < kg_losses[0]:
        raise AssertionError(f"KGCL losses {kg_losses}: want finite and decreasing")
    for r in kg_rows:
        log(f"  epoch {r['epoch']}: loss {r['loss']['loss']:.4f} (rec "
            f"{r['loss']['rec_loss']:.4f}, cl {r['loss']['cl_loss']:.4f}), train "
            f"{r['train_s']:.3f} s ({r['train_examples'] / r['train_s']:.0f} examples/s), "
            f"recall@20 {r['valid']['recall'][1]:.5f}, eval {r['eval_s']:.3f} s "
            f"({r['eval_users'] / r['eval_s']:.0f} users/s)")
    log(f"  test recall@20 {kg_trainer.test_results['recall'][1]:.5f}, "
        f"ndcg@20 {kg_trainer.test_results['ndcg'][1]:.5f}")
    cpu_model = build_model(kg_cfg, kg_cpu)
    cpu_model.load_state_dict({k: v.cpu() for k, v in kg_trainer.model.state_dict().items()})
    with torch.no_grad():
        gu, gi = kg_trainer.model.generate()
        cu, ci = cpu_model.generate()
    errs.check("kgcl.generate", torch.cat([gu, gi]).cpu(), torch.cat([cu, ci]))
    log(f"  trained embeddings {tuple(gu.shape)} + {tuple(gi.shape)} finite, = the same "
        f"forward on the CPU's plain versions: ok")
    kgcl_small_step_check(errs)

    log("== 9. result")
    b1 = {
        "name": "csr_spmm", "route": "cuda",
        "source": "sslrec_tpu_torch/csrc/csr_spmm.cu",
        "replaces": "sslrec_tpu/ops/pallas_spmm.py:123",
        "replaces_fn": "sslrec_tpu/ops/pallas_spmm.py::_spmm_kernel",
        "launches": launches + kg_b1,
        "launches_by_path": {"lightgcn": launches, "kgcl": kg_b1},
        "launches_per_step": {"lightgcn": launches / steps, "kgcl": kg_b1 / kg_steps},
        "max_abs_err": main_abs, "max_rel_err": main_rel,
        "max_rel_err_all_checks": max(errs.rel, seg_errs.rel),
        "shape": {"n_rows": lay.n_rows, "n_cols": lay.n_cols,
                  "nnz": int(lay.cols.shape[0]), "d": d},
        "ms": dt["kernel"], "plain_ms": dt["plain"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": dt["library"],
        "event_ms": t["kernel"], "plain_event_ms": t["plain"],
        "library_event_ms": t["library"],
        "event_ms_masked": t["kernel_masked"], "plain_event_ms_masked": t["plain_masked"],
        "bound_ms_masked": bm_ms, "event_ms_bwd_masked": t["kernel_bwd_masked"],
        "segment_sum": {
            "shape": {"n": seg_lay.n, "num_segments": seg_lay.num_segments, "d": 65},
            "max_abs_err": seg_errs.abs, "max_rel_err": seg_errs.rel,
            "ms": dts["b1_kernel"], "plain_ms": dts["b1_plain"], "bound_ms": b1s_bound,
            "bound_by": b1s_by, "library_ms": dts["b1_library"],
            "event_ms": ts["b1_kernel"], "plain_event_ms": ts["b1_plain"],
            "library_event_ms": ts["b1_library"]},
    }
    b2 = {
        "name": "segment_max", "route": "cuda",
        "source": "sslrec_tpu_torch/csrc/segment_max.cu",
        "replaces": "sslrec_tpu/ops/pallas_segment.py:137",
        "replaces_fn": "sslrec_tpu/ops/pallas_segment.py::_segmax_kernel",
        "launches": kg_b2,
        "launches_by_path": {"lightgcn": lgcn_b2, "kgcl": kg_b2},
        "launches_per_step": {"kgcl": kg_b2 / kg_steps},
        "max_abs_err": 0.0,
        "shape": {"n": seg_lay.n, "num_segments": seg_lay.num_segments},
        "ms": dts["b2_kernel"], "plain_ms": dts["b2_plain"], "bound_ms": b2_bound,
        "bound_by": b2_by, "library_ms": dts["b2_library"],
        "event_ms": ts["b2_kernel"], "plain_event_ms": ts["b2_plain"],
        "library_event_ms": ts["b2_library"],
        "library_call": "Tensor.scatter_reduce_(0, ids, data, 'amax', include_self=False) "
                        "into a -inf-filled tensor (the plain version's own call)",
    }
    log(json.dumps({"kernels": [b1, b2]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
