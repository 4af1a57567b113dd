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
   materialised dropout mask / in-kernel dropout PRF / learned weight with
   dx and dew) and on edge cases (widths 1..128, so every lane group the
   host picks; empty rows, a rectangular graph, a stress graph with rows of
   961,308 and 100,000 edges and rows around the split threshold, held
   against the plain version in float64, also in the bf16 mode at d 1-4,
   32, 36, 64 and 65): max |k - p| / max |p| <= 1e-5; every kernel
   call repeated bit for bit, and the PRF mode equal (``torch.equal``) to
   the kernel fed the mask;
4. time B1 at the LightGCN hop (no multiplier, mask, PRF; both layouts), its
   plain version and ``torch.sparse.mm``, device time (torch.profiler) and
   CUDA events;
5. drive the LightGCN path, ``sslrec_tpu_torch.main --model lightgcn`` (2
   epochs), with the launch counts reset just before and read just after;
   check losses, metrics and the trained embeddings against the plain
   propagation, and one training step on a small graph against the CPU;
6. write the synthetic-at-scale KG dataset (a copy of the JAX benchmark's
   generator) and hold B2 against its plain version at the KGCL shape
   (297,404 logits into 30,000 segments) and on edge cases whose segment
   lengths make the host pick each group width, exactly (``torch.equal``,
   −inf included); hold B1 as
   segment sum (d = 1, 64, 65), gather, fused attention (values and
   gradients), UI hop (d = 64, both layouts) and relation take (297,404 rows
   into 41, value and table gradient, bit for bit twice) within 1e-5;
7. time B2, its plain version and ``scatter_reduce_``; B1 as the KG segment
   sum at d = 65 and d = 1, the UI hop at d = 64 and the relation take's
   backward with two yardsticks (``index_put_(…, accumulate=True)``,
   autograd's call for an index, and the one-hot GEMM ``onehotᵀ @ g``);
8. drive the KGCL path, ``sslrec_tpu_torch.main --model kgcl`` (2 epochs) on
   that dataset, with the launch counts reset around it; check losses, the
   launch counts per step, the trained embeddings against the same forward
   on the CPU's plain versions, and one step on a small KG against the CPU;
9. hold B1 against its plain version at the self-supervised models' new
   shapes: DCCF's all-ones bi-adjacency (no vals read) with a learned weight
   (value, dx, dew) and LightGCL's rectangular 1/√(rowD·colD) train matrix at
   d 32 and 13 (its SVD's width), both layouts, within 1e-5;
10. time them: DCCF's weighted hop both ways and its weight's gradient
   (``sampled_addmm`` as the yardstick), LightGCL's hop at d 32 and 13 both
   ways, each beside its bound, its plain version and ``torch.sparse.mm``;
11. drive each of SGL, SimGCL, DirectAU, NCL, LightGCL, HCCF and DCCF
   through ``sslrec_tpu_torch.main`` (``PATH_EPOCHS`` at its published config on
   alibaba-fashion), the counts reset around each run: finite losses, B1's
   launches equal to ``SSL_B1``'s count from the code, no B2, and
   ``generate()`` equal to the same forward on the CPU's plain versions;
12. build one AutoCF view and one GFormer view at full width on the card
   (seeded random weights and draws) and hold every layout built there
   against the host build of the same edges (``torch.equal`` on every
   field, split plans included), then B1 on them against its plain version
   within 1e-5: AutoCF's decoder (1,650,921 edges into 144,777 rows) as
   segment sum at d 32 and 4 and gather backward, GFormer's augmented graph
   (656,865 edges) as a hop both ways and as segment layouts, its decoder
   (948,053 edges) as segment layouts;
13. time them, each beside its bound, its plain version and
   ``torch.sparse.mm`` (the gathers' backward also beside
   ``index_put_(…, accumulate=True)``), and one view's layout build on the
   card beside the host build of the same layouts;
14. drive AutoCF, GFormer and AdaGCL the same way as phase 11 (``PATH_EPOCHS`` at
   their published configs), B1's launches asserted equal to ``VIEW_B1``'s
   count from the code;
15. load yelp_sub for DcRec, DSL and MHCN and hold B1 against its plain
   version at the social paths' shapes within 1e-5: the bi-adjacency hop
   (38,422², d 64), the normalised trust graph both ways, DcRec's all-ones
   UI and trust layouts under a view's weights (d 64 and the d 1 degree
   sum), one UI view's 43,077 added edges in a layout built on the card
   (held field for field against the host build first), MHCN's R both ways
   and its three motif channels;
16. time them, each beside its bound, its plain version and
   ``torch.sparse.mm``, and the added edges' layout build on the card
   beside the host build;
17. drive DcRec, MHCN and DSL the same way as phase 11 (``PATH_EPOCHS`` at their
   published configs on yelp_sub), B1's launches asserted equal to
   ``SOCIAL_B1``'s count from the code (DcRec's views with added edges
   counted from the run's draws), no B2;
18. the tuner and resume on the card: a 2-trial LightGCN grid of 1 epoch
   each (its tune artifact and no run artifact), and LightGCN 4 epochs
   against 2 + a resumed 2, the train states after epoch 3 bit-equal; the
   sports-shaped split of phase 23 is written here, with its first
   ``SEQ_CUT_SHARE`` of users beside it (``SEQ_CUT_DATASET``), on which
   MAERec (at batch 4096) is held as 2 epochs against 1 + a resumed 1, its
   loss history in the train state;
19. drive KCGN and SMIN the same way as phase 11 (``PATH_EPOCHS`` at their
   published configs on yelp_sub: the CLI loads the data and builds both
   models on the card), B1's launches equal to ``SOCIAL_B1``;
20. hold B1 against its plain version at the trained models' shapes within
   1e-5, value and gradients, both layouts: KCGN's expanded-graph
   destination sum and source gather (161,500 edges), its uu and ii DGI
   hops at d 128 (80,564 and ~3.44M edges), their component sums and label
   gathers (the ii graph's single component of 29,422 nodes against the
   plain version in float64); SMIN's five metapath hops at d 64 (ITI ~3.44M
   edges), its DGI and 2-hop subgraph hops and the one-hop edges' gathers
   at d 192;
21. time them, each beside its bound, its plain version and
   ``torch.sparse.mm``;
22. drive KGIN and KGRec ``PATH_EPOCHS`` through the CLI on the synthetic KG of
   phase 6, B1's and B2's launches equal to ``KG_COUNTS``; then hold B2
   exactly at the trained KGRec's uncapped triplets' heads (300,000 into
   30,000) and B1 at both models' segment layouts (heads at d 64, 33, 1;
   tails, relations, the interact edges' users, items and entities) within
   1e-5, and time both;
23. on the synthetic split shaped like Amazon Sports and Outdoors 5-core
   (35,598 users, 18,357 items, 296,337 interactions; ``sports_like_seqs``)
   drive BERT4Rec, CL4SRec, DuoRec, ICLRec, DCRec_seq and MAERec 1
   epoch each (``SEQ_EPOCHS``) at their published configs through the
   CLI (CL4SRec, DuoRec, ICLRec and MAERec at batch 2048:
   ``SEQ_BATCH_ARGS``), B1's launches equal to ``SEQ_B1`` (0 for the first four), no B2,
   each ``generate()`` equal to the CPU's plain forward at the users of its
   first ``SEQ_CPU_ROWS`` test sequences and every item;
24. hold B1 against its plain version at the trained DCRec_seq's
   transition, similarity and test graphs and MAERec's distance-3 graph
   (d 64 and 1, both layouts, value, dx and dew) within 1e-5;
25. B1's bf16 mode (``SSLREC_PALLAS_PRECISION=default``): against its bf16
   plain version within 1e-5 and the float32 plain version within 3.8e-3
   at the LightGCN hop (both layouts, with and without the dropout PRF),
   KGCL's segment sum (d 64) and MAERec's encoder hop, every call repeated
   bit for bit; bit for bit on a case of exact halfway, subnormal,
   underflowing and overflowing products, inf, NaN and signed zeros at d 64,
   36 and 65 (``bf16_tie_case``); the float32 mode bit for bit as before the
   switch; then LightGCN 2 epochs in bf16 mode, B1's launches equal to the
   float32 run's;
26. time DCRec_seq's hops and degree sums and MAERec's hop and d 1 spread
   (under a multiplier also ``torch.sparse.mm`` with the values' gather
   inside the call), and the bf16 mode beside the float32 mode, the cast of
   x alone and ``torch.sparse.mm`` on a bfloat16 CSR tensor at the LightGCN
   and MAERec hops, both layouts, and KGCL's d-64 segment sum, each beside
   its bound, its plain version and ``torch.sparse.mm``;
27. drive DiffKG and KGCL with ``model.train_trans`` (its TransE sub-loop)
   ``PATH_EPOCHS`` each through the CLI on the synthetic KG of phase 6, B1's and
   B2's launches equal to ``KG_COUNTS`` (DiffKG 30 B1 + 4 B2 a step, one
   B1 an epoch for its diffusion's UI hop), each ``generate()`` equal to the
   CPU's plain forward in float64;
28. hold the trained DiffKG's denoised-KG layouts (built on the card each
   epoch) against the host builds, B2 exactly at its denoised and capped
   heads, and B1 within 1e-5 at its RGAT sums and gathers (heads, tails,
   relations, both KGs), its UI hop under the all-ones view's values and
   its ukgc term's rectangular UI matrix, both directions;
29. write a synthetic split shaped like Tmall (CML's table: 31,882 users,
   31,232 items, 1,451,219 interactions over pv, fav, cart and buy, the
   per-behavior counts assumed: ``TMALL_SHAPE``; ``tmall_like_split``) with
   HMGCR's meta-path intersections under ``SMOKE_RESULTS/multi_behavior/
   tmall/``, and drive MBGMN, HMGCR and SMBRec ``PATH_EPOCHS`` each at their
   published configs, B1's launches equal to ``MB_B1``, no B2, each
   ``generate()`` equal to the CPU's plain forward;
30. hold B1 within 1e-5 at every behavior's A and AT (d 32 and 16) and
   every meta path's (d 16), both layouts, value and gradients;
31. time DiffKG's and the multi-behavior shapes and B2 at the denoised and
   capped heads, each beside its bound, its plain version and the library
   call (``torch.sparse.mm``; ``scatter_reduce_`` for B2);
32. on phase 29's split, with a meta-user file (``MB_META_FILE``: a seeded
   permutation of the users with a buy and another behavior, this
   script's assumption) and the repository's real Tmall ``kg.txt`` (39,290
   triplets) copied beside it, drive CML and KMCLR ``PATH_EPOCHS`` each at their
   published configs, B1's launches equal to ``MB_B1`` and ``MB_EPOCH_B1``
   (KMCLR's epoch hook), no B2, each ``generate()`` equal to the CPU's plain
   forward;
33. hold B1 within 1e-5 at CML's behavior graphs (A and AT, d 16), at
   KMCLR's buy bi-adjacency under a view's values (d 32), both layouts,
   value and gradients, and at the segment layouts of KMCLR's per-item
   entity and relation lists (999,424 slots, 961,308 of them in the pad's
   row; small integer inputs, plain in float64) as sum and gather
   backward, d 32;
34. time them, each beside its bound, its plain version and
   ``torch.sparse.mm``, and KMCLR's epoch hook in its four parts (host
   clock);
35. ``tune.parallel``'s lanes: hold B1 under the Functions' vmap rule at
   the LightGCN hop (K in ``LANE_KS`` lanes of d 32 folded into one call at
   d 32·K, no multiplier and the PRF mode; DCCF's learned weight with 3
   lanes, a call a lane), value and gradients per lane within 1e-5, one
   launch a hop where the weight has no lanes; time the 3-lane fold (d 96)
   beside its bound, its plain version, ``torch.sparse.mm`` and three d 32
   calls; drive LightGCN's shipped grid (3 lanes), KCGN's 2 x 2 and DCCF's
   1 x 2 (2 lanes), 1 epoch each, through the CLI with ``tune.parallel`` and
   serially: each trial's test score equal to its serial score, B1's launches
   equal to ``LANES_B1``'s count, no B2, each grid's wall time;
36. the lanes of MBGMN, HMGCR, SMBRec, CL4SRec, DuoRec and DCRec_seq at
   their published configs on phase 29's and phase 18's splits: one step of
   ``LANE_K`` lanes against the single steps for HMGCR (in float64, B1's
   plain version in place of the kernel), CL4SRec and DuoRec (loss and
   gradients within the CPU test's tolerance, the parameters after Adam); ``LANE_TIMED_STEPS`` lanes steps timed against single steps for
   all six; B1 under the lanes' vmap rule at the folded Tmall pv graph (d
   2 x 32) and DCRec_seq's transition hop (d 2 x 64), value and dx per lane
   within 1e-5, one launch a hop, timed beside its bound, plain version,
   ``torch.sparse.mm`` and the calls a lane at a time; MBGMN's, SMBRec's and
   DCRec_seq's 2-trial grids (1 epoch, 2 lanes; DCRec_seq's on
   ``SEQ_CUT_DATASET``) through the CLI with ``tune.parallel`` and
   serially, held as phase 35's (DCRec_seq's to within a few swaps at the
   top-k boundary: ``LAST_LANE_GRIDS``);
37. the device mesh (``sslrec_tpu_torch/parallel``): (a) partition the
   alibaba-fashion bi-adjacency for a ``model`` axis of 2 and of 4
   (``MESH_PARTS``) and hold B1 on every shard's layouts (its destination
   rows over the gathered ``[U_pad + I_pad, 32]`` table, and transposed) against
   its plain version, with no multiplier and under the in-kernel PRF keyed
   by the original edge id (``torch.equal`` to the kernel fed the whole
   graph's mask, and each shard's mask equal to the whole one's gathered
   through ``src_idx``), the reassembled shards against the unpartitioned
   hop, and time each shard's hop beside its bound, its plain version and
   ``torch.sparse.mm``; (b) train LightGCN and SGL (``MESH_MODELS``)
   ``MESH_EPOCHS`` epoch each at their published configs on
   ``MESH_CF_DATASET`` (alibaba-fashion with ``MESH_CF_TRAIN_SHARE`` of its
   train pairs: the depth cut of this part) on a ``{data: 2,
   model: 2}`` mesh of four gloo processes sharing card 0 (one spawn of the
   library's ``launch.spawn`` with an explicit gloo group, each rank running
   the CLIs in turn) and hold their losses, parameters and test metrics
   against the single-device runs', within the CPU tests' tolerances (SGL's
   parameters against its ``MESH_SPLIT_REF`` run, its single run's under
   another GEMM order recorded beside them), and each rank's B1 launches by
   layout against ``MESH_B1``; four processes on one card give no speed
   figure for a mesh; (c) in a one-rank NCCL group, one step
   of ``mesh_partitioned_propagate`` with a one-shard partition and
   ``owned_lookup``, value and gradients, against the plain hop; (d) the
   KG family: partition the synthetic KG's UI bi-adjacency and KGIN's
   interact graph for a model axis of 2, hold B1 on every shard (both
   layouts, under values and without) against its plain version and time
   each shard's hop; then train KGCL (with ``train_trans``), KGIN, KGRec
   and DiffKG ``MESH_EPOCHS`` epoch each at their published configs on
   ``MESH_KG_DATASET`` (the synthetic KG with ``MESH_KG_TRAIN_SHARE`` of
   its train pairs: the depth cut of this phase) once on the card and once
   on a ``{data: 1, model: 2}`` mesh of two gloo processes sharing card 0
   (one spawn), hold their losses and test metrics within
   ``MESH_METRIC_TOL`` and whole tables within ``MESH_PARAM_TOL`` of the
   single runs, each rank's B1 launches by layout and B2 launches against
   ``MESH_KG``, and in each rank B1 on its shard layouts within 1e-5 and B2
   on its whole-KG head layouts bit for bit against their plain versions
   (``parallel.checks.layout_probe``); (e) the multi-behavior family:
   partition phase 29's whole Tmall-shaped split as HMGCR, SMBRec, CML and
   KMCLR do for a model axis of 2 (each behavior's A and AT as one
   bidirectional graph, each behavior's and meta path's chained pair apart,
   KMCLR's buy bi-adjacency: ``mesh_mb_partitions``), hold B1 on both
   shards of each, forward and transposed, at d 16 and 32 (the buy
   bi-adjacency under values) within ``TOL`` of plain and time those of
   ``MESH_MB_TIMED``; then train the four ``MESH_EPOCHS`` epoch
   each at their published configs on ``MESH_MB_DIR`` (phase 29's split
   with ``MESH_MB_TRAIN_SHARE`` of each behavior's train pairs, CML's meta
   users and the real Tmall ``kg.txt`` beside it: the depth cut) once on
   the card and once on the ``{data: 1, model: 2}`` mesh, in 37(d)'s
   spawn, held as 37(d)'s runs, their launches against ``MESH_MB`` and B1
   in each rank on the shard layouts of every graph it partitions within
   ``MESH_MB_B1_TOL``; (f) the models that partition no graph
   (``MESH_GCF_MODELS``: LightGCL, HCCF, DCCF, AutoCF, GFormer and AdaGCL
   on ``MESH_CF_DATASET``, MBGMN on 37(e)'s split) ``MESH_EPOCHS`` epoch
   each at their published configs, once on the card and once on the
   ``{data: 1, model: 2}`` mesh in 37(d)'s spawn (with (b)'s SGL
   ``MESH_SPLIT_REF`` run), held as 37(d)'s runs (a table that misses
   ``MESH_PARAM_TOL`` then against its single run's own move under
   cuBLASLt), their launches against ``MESH_GSPMD_A`` and B1 in each rank
   on its whole layouts within ``TOL``; (g) the social five
   (``MESH_SOCIAL_MODELS``: DcRec, MHCN, DSL, KCGN, SMIN) ``MESH_EPOCHS``
   epoch each at their published configs on the whole yelp_sub, on the
   ``{data: 1, model: 2}`` mesh in 37(d)'s spawn, held as 37(d)'s runs to
   their single runs of phases 17 and 19 (the same arguments; no single
   run is made again), their launches against ``MESH_SOCIAL`` and B1 in
   each rank on its whole layouts and segment layouts within ``TOL``; (h)
   the sequential six (``MESH_SEQ_MODELS``) ``MESH_EPOCHS`` epoch each at
   their published configs on ``MESH_SEQ_DATASET`` (the first quarter of
   phase 18's sports-shaped split's users, MAERec at batch 16384: the depth
   cut, ``MESH_SEQ_ARGS``), once on the card and once on a ``{data: 2,
   model: 1}`` mesh (``MESH_SEQ_RUN``, the axis these replicated models
   split) in 37(d)'s spawn, held as 37(f)'s runs, their launches against
   ``MESH_SEQ`` (B1 on DCRec_seq's and MAERec's item graphs; none for the
   other four) and B1 in each rank on its whole layouts within ``TOL``;
38. print the ``{"kernels": [...]}`` line, then the card line, then
   ``{"ok": true, "device": {...}}`` last.

The paths of phases 11, 14, 17, 19, 22, 27, 29 and 32 train ``PATH_EPOCHS``
epoch each (2 before the mesh's phase was added), and phase 18 holds MAERec's
resume as 2 epochs against 1 and a resumed 1, to leave the mesh's phase room
in the time limit; for SGL's mesh runs, phase 35's LightGCN grid trains 1
epoch (was 2) and phase 36 times ``LANE_TIMED_STEPS`` steps (was 10,
then 5); for
the KG models' mesh runs, phase 23 holds ``SEQ_CPU_ROWS`` test sequences
against the CPU (was all), loads the CPU data once for the sequential
runs that share it and trains CL4SRec, DuoRec, ICLRec and MAERec at batch
1024 (was 512), and phase 35 runs DCCF's grid as 1 x 2 (was 2 x 2); for
the multi-behavior models' mesh runs, phase 23 holds 2048 test sequences
against the CPU (was 4096) and trains those four at batch 2048 (was 1024),
phase 37(b) trains on ``MESH_CF_DATASET`` (was the whole alibaba-fashion
split), 37(d)'s KGCL runs its TransE sub-loop at batch 16384 (was 4096)
and phase 36 times 3 lanes steps (was 5); for 37(f), 37(b)'s SGL
``MESH_SPLIT_REF`` run rides 37(d)'s spawn (was a spawn of its own), the
resume checks of phase 18 resume from the straight run's own state (was a
third run), and phases 17, 19, 23, 29 and 32 hold ``generate()`` on a CPU
copy of the run's data (``CPU_FROM_CARD``; was a second load); for 37(g),
MAERec's resume check (phase 18) and DCRec_seq's grid both ways (phase 36)
run on ``SEQ_CUT_DATASET`` (was the whole sports-shaped split); 37(h)
trains on ``SEQ_CUT_DATASET`` with its single runs made there (phase 23's
runs on the whole split are not reused).

``lightgcn_data``, ``kgcl_shapes``, ``ssl_graphs``, ``view_operands`` and
``social_operands`` build the paths' operands (``kcgn_smin_operands`` and
``kg_full_operands`` take them from the trained models); the comparison of
checkouts (``chip_compare.py``) times its kernels on the first two.

Every device time (``device_ms``) must come from two profiler windows that
agree and that are at least the work's bound: a window that lost kernel
records is measured again, and a time that cannot be made whole fails the
script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sslrec_tpu_torch import main as port_main
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.data import general_cf
from sslrec_tpu_torch.data import kg as kg_data
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.general_cf.dccf import plain_and_norm_adj
from sslrec_tpu_torch.models.general_cf.lightgcl import rect_norm_adj
from sslrec_tpu_torch.models.kg.kgin import interact_edges
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.parallel import checks as mesh_checks
from sslrec_tpu_torch.parallel import dist_train, launch
from sslrec_tpu_torch.parallel import mesh as mesh_mod
from sslrec_tpu_torch.ops import cuda_build
from sslrec_tpu_torch.ops import segment as plain_seg
from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.ops.sparse import CooGraph, EdgeSet, from_scipy
from sslrec_tpu_torch.ops.spmm import spmm as sk_spmm
from sslrec_tpu_torch.profile_epoch import device_us
from sslrec_tpu_torch.trainer.lanes import Lanes
from sslrec_tpu_torch.trainer.trainer import DEVICE_STREAM, Trainer, build_optimizer, generator
from sslrec_tpu_torch.utils import checkpoint as ckpt

TOL = 1e-5                  # max |kernel - plain| / max |plain|
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
PRF_OPS_PER_EDGE = 80       # Threefry-2x32's 20 rounds and key steps, and the keep
SMOKE_RESULTS = "smoke_results"
DATA_DIR, DATASET = "datasets", "alibaba-fashion"
KG_DATASET = "synthetic"    # written under SMOKE_RESULTS/kg/synthetic_kg/
# B1 / B2 launches per KGCL training step, counted from the code: the forward
# runs 3 RGATs of 2 hops (one B2 max and one B1 [n, d+1] sum each), 3 UI
# propagations of 2 B1 hops and one B1 degree sum for the node-dropout view
# (13 B1, 6 B2); the backward runs the 6 UI hops on the transposed layout, a
# B1 segment sum for each endpoint gather, 2 shared by hop 0 and 6 of hop 1,
# and one for each relation take, 1 shared by hop 0 and 3 of hop 1 (18 B1).
# Each epoch adds epoch_state (6 B1, 4 B2) and each evaluation's generate()
# 5 B1 and 2 B2.
KGCL_B1_PER_STEP, KGCL_B2_PER_STEP = 31, 6
SSL_MODELS = ("sgl", "simgcl", "directau", "ncl", "lightgcl", "hccf", "dccf")
# B1 launches of the self-supervised general_cf models at their published
# configs, counted from the code: (per training step, per generate(), at
# construction).  A step runs each forward hop once and, since every hop's
# input needs a gradient, once more on the transposed layout for dx; a learned
# edge weight's gradient (dew) is a gather-dot, not a launch.  None runs B2.
# - SGL: two dropout views and the clean view, 2 hops each: 6 + 6.
# - SimGCL: two noise views and the clean view, 2 hops each: 6 + 6.
# - DirectAU: 2 hops: 2 + 2.
# - NCL: max(layer_num 3, 2 * high_order 2) = 4 hops: 4 + 4; generate 3.
# - LightGCL: per layer A·E_i and Aᵀ·E_u, 2 layers: 4 + 4; generate 4; its SVD
#   at construction: omega's product, 4 iterations of Aᵀ then A, a last Aᵀ: 10.
# - HCCF: one rescaled-dropout hop a layer, 2 layers: 2 + 2; generate 2.
# - DCCF: per layer the GNN hop, two adaptive-mask hops and the two masks'
#   degree sums (d 1): 5 forward; backward the GNN and masked hops' dx (the
#   degree sums' input is constant): 3; 2 layers: 10 + 6; generate 10.
SSL_B1 = {"sgl": (12, 2, 0), "simgcl": (12, 2, 0), "directau": (4, 2, 0), "ncl": (8, 3, 0),
          "lightgcl": (8, 4, 10), "hccf": (4, 2, 0), "dccf": (16, 10, 0)}
VIEW_MODELS = ("autocf", "gformer", "adagcl")
# B1 launches of AutoCF, GFormer and AdaGCL at their published configs,
# counted from the code: (per training step, per view-regenerating step, per
# view of the epoch's bank, per generate()).  A graph-transformer layer with
# a gradient is 5: its two segment sums forward, and backward the gathers of
# its query rows, its key/value cols and its row normaliser (a segment sum's
# own backward is a gather, no launch); its forward alone is 2.
# - AutoCF: 2 encoder hops (2 + 2 dx) and one GT layer over the decoder: 9 a
#   step; where the views regenerate (step % 10 == 0, one step per view) the
#   infomax term's 2 seed-score hops and their dx: 4; a view: 2 seed-score
#   hops, 1 closure hop and 1 degree sum (d 1): 4; generate: 2 hops + a GT
#   forward: 4.  Layouts are built on the card (sorts, no launch).
# - GFormer: GT layers over the augmented edges on the cmp and sub supports
#   and one over the decoder: 15; 2 layers of three hops (enc, sub, cmp)
#   with dx: 12; a step 27; a view: 3 degree sums (d 1) for the three value
#   vectors (the anchor distances are scatter_reduce amin, the attention
#   scores plain products); generate 2.
# - AdaGCL: the VGAE view's 2 hops; phase 1: 2 hops + dx (4) and the
#   denoised forward, per gate layer a degree sum and a hop + dx (6): 10;
#   phase 2 the same: 10; phase 3: 4; the VGAE loss's 2 hops without
#   gradient; the denoise loss: layer 0 a degree sum, a weighted hop and the
#   normaliser's two gathers' backward (4), layer 1 as layer 0 with the
#   logits' two gathers' backward and the hop's dx (7): 39 a step; generate 2.
VIEW_B1 = {"autocf": (9, 4, 4, 4), "gformer": (27, 0, 3, 2), "adagcl": (39, 0, 0, 2)}
SOCIAL_DATASET = "yelp_sub"
SOCIAL_MODELS = ("dcrec", "mhcn", "dsl")
# B1 launches of DcRec, MHCN and DSL at their published configs on yelp_sub,
# counted from the code: (per training step, per generate()).  Every hop's
# input needs a gradient, so each forward hop has one dx hop; a degree sum's
# input is constant and has none.
# - DcRec (4 layers): the base tower's 4 hops and dx: 8; a UI view without
#   added edges: the user and item degree sums (d 1) over the fixed layout
#   and, per layer, a hop each way with dx: 2 + 16 = 18; a trust view
#   without added edges: 1 degree sum and 4 transposed hops with dx: 9;
#   4 views: 8 + 2·18 + 2·9 = 62.  A view whose kind adds edges runs as
#   many again over the added edges' layout (DCREC_ADDED_B1), counted from
#   the views the run drew (``DcRec.added_views``); generate: 4 hops.
# - MHCN (2 layers): per layer the three motif hops, Rᵀ's and R's hops, with
#   dx: 20; the SSL term's three channel hops with dx: 6; 26 a step;
#   generate 10.
# - DSL: 3 UI hops and 2 trust hops with dx: 10 a step; generate: the UI
#   tower's 3 hops.
# - KCGN (2 layers): the expanded graph's hop, a destination sum, and its
#   source gather's backward: 2; per DGI graph (uu, ii) the node table's hop,
#   its row shuffle's hop and the component sum, each with dx, and the
#   summary gather's backward over the labels: 7; 16 a step; generate 1.
# - SMIN (3 layers): 3 user and 2 item metapaths of 2 hops with dx: 20;
#   Informax's DGI hops of the node table and its shuffle and the subgraph
#   hop with dx: 6; the one-hop edges' two endpoint gathers' backward: 2;
#   28 a step; generate 10.
SOCIAL_B1 = {"dcrec": (62, 4), "mhcn": (26, 10), "dsl": (10, 3), "kcgn": (16, 1),
             "smin": (28, 10)}
DCREC_ADDED_B1 = {"ui": 18, "uu": 9}
KCGN_SMIN = ("kcgn", "smin")
KG_MODELS = ("kgin", "kgrec")
# B1 and B2 launches of the KG paths through the CLI at their published
# configs (2 hops), counted from the code: (B1, B2) per training step, per
# generate(), per epoch (its epoch_state) and at construction.
# - KGIN: the heads' live count once, per hop the heads' sum and the users'
#   sum: 5 forward; backward the relation take once and per hop the tails'
#   and the interact entities' gathers: 5; 10 a step; generate 5.
# - KGRec: without gradient the heads' live count, the rationale softmax (a
#   B2 shift and a B1 sum), the heads' and tails' score sums and the tails'
#   live count: 5 B1, 1 B2; the encoder per hop two heads' fused attention
#   (a B2 shift and a B1 [n, 33] sum each) and the users' sum: 3 B1, 2 B2;
#   the UI tower per hop 2 sums; the KG tower its live count and a sum per
#   hop: 3; 18 B1, 5 B2 forward; backward the relation take once, per
#   encoder hop the heads', tails' and interact entities' gathers (6), the UI
#   tower's gathers but the last hop's user-side one, whose output is unused
#   (3), and the KG tower's tails' gathers (2): 12; 30 B1, 5 B2 a step;
#   generate 6 B1, 4 B2.
# - DiffKG (cl_pattern 1): two forwards a step (the capped KG's and the
#   denoised KG's), each an RGAT of 2 hops (per hop a B2 shift, the
#   softmax's B1 sum and the attention sum; backward the softmax's sum and
#   the heads' and tails' gathers: 5 B1) with the relation take's backward
#   once (11 B1, 2 B2), and 2 UI hops with their dx (4): 30 B1, 4 B2 a step;
#   generate 6 B1, 2 B2; an epoch's diffusion the ukgc term's one transposed
#   UI hop; construction the all-ones view's degree sum.
# - KGCL with train_trans: phase 8's counts (KGCL_B1_PER_STEP, ...); the
#   TransE sub-loop's gathers are embeddings, no launch.
KG_COUNTS = {"kgin": {"step": (10, 0), "gen": (5, 0)},
             "kgrec": {"step": (30, 5), "gen": (6, 4)},
             "diffkg": {"step": (30, 4), "gen": (6, 2), "epoch": (1, 0), "build": (1, 0)},
             "kgcl": {"step": (31, 6), "gen": (5, 2), "epoch": (6, 4)}}
KG_NEW = ("diffkg", "kgcl")
KG_NEW_ARGS = {"kgcl": ["--set", "model.train_trans=true"]}
MB_DATASET = "tmall"        # written under SMOKE_RESULTS/multi_behavior/tmall/
MB_MODELS = ("mbgmn", "hmgcr", "smbrec")
# B1 launches of the multi-behavior models at their published configs on the
# four Tmall behaviors, counted from the code: (per training step, per
# generate()).  None runs B2.
# - MBGMN (2 layers): a behavior's tower specialises (A·items, AT·users) and
#   runs 2 hops a layer: 6; the final tower the same over every behavior:
#   24; 48 forward; the hinge carries no gradient (detach_pre_loss), so only
#   the final tower's 24 hops have a dx: 72 a step (one step an epoch:
#   trnNum 100 users); generate 48.
# - HMGCR (3 layers, 4 meta-path towers): per layer A·i then AT·u, each with
#   dx: 48 a step; generate 24.
# - SMBRec (2 layers, 4 behavior towers): 32 a step; generate 16.
# - CML (3 layers, 4 behaviors, d 16): a GCN is 4 × (A·items, AT·users) a
#   layer: 24 hops; rounds 1 and 3 take them with their dx (48 each), round
#   2 runs the clone's GCN without gradient (24): 120 a step; generate 24.
# - KMCLR (3 layers, d 32): two rounds of 24 hops and 24 dx: 96 a step;
#   generate 24; its epoch hook below (MB_EPOCH_B1).
MB_B1 = {"mbgmn": (72, 48), "hmgcr": (48, 24), "smbrec": (32, 16), "cml": (120, 24),
         "kmclr": (96, 24)}
# KMCLR's epoch hook, counted from the code: each of its ``n_bpr`` contrast
# steps (``n_buy // bpr_batch_size``) runs the KG LightGCN three times (the
# BPR side and two views) of 3 hops over the buy bi-adjacency, each hop with
# its dx (18), and four relation GATs, whose entity and relation gathers'
# backward are segment sums (8): 26; the two views' values are a segment
# sum each (2) and the KG users one more LightGCN (3); TransR and TATEC run
# no B1.  Once a run, the all-ones view's values (a segment sum) are made at
# the first contrast step.
MB_EPOCH_B1 = {"kmclr": lambda model: (26 * model.n_bpr + 2 + 3, 1)}
MB_NEW = ("cml", "kmclr")
MB_META_FILE = "meta_multi_single_beh_user_index_shuffle"
TMALL_KG = os.path.join("datasets", "multi_behavior", "tmall", "kg.txt")
# Tmall (CML, WSDM 2022): 31,882 users, 31,232 items, 1,451,219 interactions
# over page view, favourite, cart and buy.  The split per behavior is this
# script's assumption (pv densest, buy sparsest), the test's held-out buys
# included in buy's count.
TMALL_SHAPE = {"users": 31_882, "items": 31_232,
               "counts": {"pv": 1_000_000, "fav": 144_000, "cart": 140_000, "buy": 167_219}}
SEQ_DATASET = "sports_syn"  # written under SMOKE_RESULTS/sequential/sports_syn/
# The depth cut that pays for phase 37(g): MAERec's resume check (phase 18)
# and DCRec_seq's grid both ways (phase 36) run on the first quarter of the
# sports-shaped split's users (the same generator, item ids and sequence
# shapes; fewer sequences, so fewer steps and smaller graphs to build)
SEQ_CUT_DATASET = "sports_cut"
SEQ_CUT_SHARE = 0.25
SEQ_MODELS = ("bert4rec", "cl4srec", "duorec", "iclrec", "dcrec_seq", "maerec")
# the sequential paths' depth: one epoch each, so that the script's later
# phases fit its time (CL4SRec, DuoRec and ICLRec take 12-20 s an epoch)
SEQ_EPOCHS = 1
PATH_EPOCHS = 1             # the CLI paths of phases 11-32 (phase 5 and 8 keep 2)
# Phase 23's depth cut (PR 17): each sequential model's generate() is held
# against the CPU's plain forward on its first SEQ_CPU_ROWS test sequences
# (of 35,598) and every item; the card's forward still encodes every one.
SEQ_CPU_ROWS = 2048
# and the four whose epoch is 371 steps at their published batch of 512
# train at batch 2048 (93 steps; first 1024, to make room for phase 37(d),
# then 2048, for 37(e)): widths and the split stay
SEQ_BATCH_ARGS = {m: ["--set", "train.batch_size=2048"]
                  for m in ("cl4srec", "duorec", "iclrec", "maerec")}
# B1 launches of the sequential models at their published configs, counted
# from the code: (per training step, per mask step, per view of the epoch's
# mask bank, per generate()).  BERT4Rec, CL4SRec, DuoRec and ICLRec run no
# B1 (their towers are dense products); none runs B2.
# - DCRec_seq: three GCNs (the transition, similarity and augmented graph),
#   each its in- and out-degree sums (d 1) and 2 hops: 12; the civil and
#   foreign readouts, a hop and a count sum (d 1) each: 4; backward the 6
#   GCN hops' and the 2 readout hops' dx (a degree or count sum's input is
#   constant): 8; 24 a step; generate: the test graphs' two GCNs, 8.
# - MAERec: the encoder's 2 hops and their dx: 4 a step; on a mask step
#   (step % mask_steps == 0) the path scores: the degree sum, the first hop,
#   per depth (3) a d 64 hop, a d 1 hop and a degree sum: 11, and the 4 d 64
#   hops' dx: 15; a view: the path scores' 11, the closure's 2 spreads (d 1)
#   and the kept edges' degree sum: 14; generate: the encoder's 2 hops.
SEQ_B1 = {"bert4rec": (0, 0, 0, 0), "cl4srec": (0, 0, 0, 0), "duorec": (0, 0, 0, 0),
          "iclrec": (0, 0, 0, 0), "dcrec_seq": (24, 0, 0, 8), "maerec": (4, 15, 14, 2)}
BF16_VS_F32 = 3.8e-3        # the JAX bf16 mode's error against XLA (BENCH_r05.json)
# three bf16 roundings a contribution (x, the value, the product), each
# within 2^-8 relative: every output of the bf16 mode is within this share
# of the sum of its contributions' magnitudes of the float32 output
BF16_ROUNDING = 3 * 2.0**-8 + 2.0**-15
PRECISION_VAR = "SSLREC_PALLAS_PRECISION"
# The tune.parallel lanes (phase 35): the widths B1 is held at under the lanes'
# vmap rule (K lanes of d 32 folded to d 32·K), and the grids driven both ways
LANE_KS = (2, 3, 4, 8)
# B1 launches of the lanes, counted from the code: (per training step, per
# generate()) of a chunk of K lanes at layer_num L.  A call whose weight has
# no lanes runs once for all K lanes on [n, K·d] (the Functions' vmap rule,
# ops/spmm_kernel.py vmap_lanes); DCCF's learned edge weights are each
# lane's own, so its degree sums, masked hops and their dx take a call a
# lane; evaluations run one lane at a time.  K = 1 is the serial loop's.
# - LightGCN: L hops and their dx: 2L; generate L.
# - DCCF: per layer the GNN hop and its dx (2), two degree sums and two
#   masked hops (4K), the masked hops' dx (2K): (2 + 6K)·L; generate 5L.
# - KCGN: SOCIAL_B1's count at L, every call folded: 2(L - 1) + 14;
#   generate L - 1.
# - MBGMN (phase 36; 4 behaviors): each behavior's tower specialises (2
#   hops) and runs 2 hops a layer, the final tower the same over all four:
#   16 + 16L forward; only the final tower's 8 + 8L take a dx (the hinge is
#   detached): 24 + 24L (MB_B1's 72 at L 2); generate 16 + 16L.
# - SMBRec (phase 36; 4 behavior towers): 2 hops a layer each, with their
#   dx: 16L; generate 8L.
# - DCRec_seq (phase 36): SEQ_B1's 24 and 8 at every K.  Its edge weights
#   (the graphs' values, the dropout draws the lanes share and the batch's
#   removed edges) have no lanes, and weight_mean enters after the hops, so
#   every call folds; the degree sums (their input is ones) have no lanes
#   at all.
LANES_B1 = {"lightgcn": lambda L, K: (2 * L, L),
            "dccf": lambda L, K: ((2 + 6 * K) * L, 5 * L),
            "kcgn": lambda L, K: (2 * (L - 1) + 14, L - 1),
            "mbgmn": lambda L, K: (24 + 24 * L, 16 + 16 * L),
            "smbrec": lambda L, K: (16 * L, 8 * L),
            "dcrec_seq": lambda L, K: (24, 8)}
# the grids, each run with tune.parallel and serially: LightGCN's shipped grid
# (2 layer_num groups of 3 lanes), KCGN's 2 x 2 (2 groups of 2 lanes) and
# DCCF's 1 x 2 (1 group of 2 lanes; 2 x 2 before the KG models' mesh runs
# were added to phase 37) at their published configs, 1 epoch each
# (LightGCN's 2 before SGL's mesh runs were added)
LANE_GRIDS = {
    "lightgcn": {"data": (DATA_DIR, DATASET), "epochs": 1, "parallel": 3,
                 "grid": {"layer_num": [2, 3], "reg_weight": [1.0e-6, 1.0e-7, 1.0e-8]}},
    "dccf": {"data": (DATA_DIR, DATASET), "epochs": 1, "parallel": 2,
             "grid": {"layer_num": [2], "cl_weight": [1.0e-1, 1.0e-2]}},
    "kcgn": {"data": (DATA_DIR, "yelp_sub"), "epochs": 1, "parallel": 2,
             "grid": {"layer_num": [1, 2], "reg_weight": [1.0e-1, 1.0e-2]}}}
# a trial's test score (recall at the config's first k), lanes against
# serial, must be equal: the same hits give the same float32 sums in the same
# order, and one swap of two items at a top-k boundary moves recall by 1 /
# (test users · |ground truth|), as much as the gap between two of KCGN's trials on yelp_sub, so
# any looser limit would pass a lane that trained on another trial's scalars.
# The lanes' hops run at width K·d, where B1 picks a wider lane group and a
# longer split threshold (float32 rounding), and vmap batches dense weight
# gradients; every trial of every run so far gave the serial score exactly.
LANES_SCORE_TOL = 0.0
# Phase 36, the lanes of the multi-behavior and sequential models: each at
# its published config on its smoke split; MBGMN's, SMBRec's and
# DCRec_seq's 2-trial grids driven both ways (1 group of 2 lanes, 1 epoch).
# DCRec_seq's grid alone is held to "swaps" swaps, not to equality: its
# lanes step differs from its single steps in the last bits of nearly every
# weight gradient (vmap runs the weight gradients' products as batched GEMMs
# and their sums over the batch as reductions along a lane dimension, where
# the single step runs plain GEMMs and reductions), and over an epoch's 70
# steps that moves 2 of 35,598 test users across the top-k boundary in its
# cl_lambda 1e-2 trial, the same 2 in every run on the card.  A swap moves
# recall by at most 1 / (test users · the fewest ground-truth items of a test
# user), read from the split (:func:`swap_unit`); 4 swaps is a quarter of the
# gap between its two trials' serial scores (16 swaps), and each lane must
# still lie nearer its own trial's serial score than half that gap
# (:func:`lane_is_its_trial`).
LAST_LANES = {"mbgmn": MB_DATASET, "smbrec": MB_DATASET, "hmgcr": MB_DATASET,
              "cl4srec": SEQ_DATASET, "duorec": SEQ_DATASET, "dcrec_seq": SEQ_DATASET}
LAST_LANE_GRIDS = {
    "mbgmn": {"data": (SMOKE_RESULTS, MB_DATASET), "epochs": 1, "parallel": 2,
              "grid": {"layer_num": [2], "reg_weight": [1.0e-1, 1.0e-2]}},
    "smbrec": {"data": (SMOKE_RESULTS, MB_DATASET), "epochs": 1, "parallel": 2,
               "grid": {"layer_num": [2], "reg_weight": [1.0e-1, 1.0e-2]}},
    "dcrec_seq": {"data": (SMOKE_RESULTS, SEQ_CUT_DATASET), "epochs": 1, "parallel": 2,
                  "grid": {"cl_lambda": [1.0e-4, 1.0e-2], "weight_mean": [0.5]}, "swaps": 4}}
# HMGCR's, CL4SRec's and DuoRec's epochs (12-14 s) are too long for a grid
# both ways: one step of LANE_K lanes is held against the lanes' single steps
# instead, with the CPU test's tolerance (tests/test_torch_tune_lanes.py):
# loss and gradients within LANE_REL of the tensor's largest entry plus
# LANE_ATOL; after Adam, LANE_ADAM_ATOL wherever the single run's gradient is
# at least LANE_SURE of its tensor's largest entry and LANE_SURE_ABS (Adam's
# first step, lr·g/(|g| + 1e-8), turns the rounding of a gradient near 1e-8,
# as the attention key biases' gradient, which softmax ignores, into a step
# of up to lr).
# HMGCR's step is held in float64 (LANE_F64), with B1's plain version in
# place of the kernel, which takes float32 only, at LANE_REL_F64: in float32
# its layer weights' gradients, which sum the GRACE terms of all 31,882 users
# over four meta paths, cancel, and the lanes' batched GEMMs reorder those
# sums by 1.0e-4 of the largest entry on the card, ten times the float32
# limit; in float64 the same step agrees to rounding, so a fault of the
# lanes' path cannot hide under that limit.
# The models whose path (phases 17, 19, 23, 29 and 32) holds generate() to
# the CPU's plain forward on a copy of the run's own data (on_device), not on
# a second load on the host: a depth cut of the loads (KCGN's and SMIN's
# handler samples on the host for ~12 s each) that keeps the check; the KG
# handler's bundles hold a class that keeps its device, and still reload
CPU_FROM_CARD = (*SOCIAL_MODELS, *KCGN_SMIN, *SEQ_MODELS, *MB_MODELS, *MB_NEW)
LANE_STEP_MODELS = ("hmgcr", "cl4srec", "duorec")
LANE_F64 = ("hmgcr",)
LANE_K = 2
LANE_REL, LANE_ATOL, LANE_ADAM_ATOL, LANE_SURE, LANE_SURE_ABS = 1e-5, 1e-7, 1e-6, 1e-4, 1e-6
LANE_REL_F64 = 1e-10
LANE_TIMED_STEPS = 3        # each of the six: LANE_K-lane steps against single steps




def b1_count(name: str, epochs: int, n_batches: int, fix_steps: int,
             model=None) -> tuple[int, str]:
    """B1 launches of ``epochs`` epochs of ``n_batches`` steps of model
    ``name`` through the CLI (an evaluation each epoch, the best valid and
    the test), counted from the code, and how they were counted; DcRec's
    views with added edges are read from the trained ``model``; views are
    made every ``fix_steps`` steps (MAERec's ``mask_steps``)."""
    steps, evals = epochs * n_batches, epochs + 2
    if name in SEQ_B1:
        per_step, per_mask, per_view, per_gen = SEQ_B1[name]
        masks = epochs * -(-n_batches // fix_steps) if per_mask or per_view else 0
        return (per_step * steps + (per_mask + per_view) * masks + per_gen * evals,
                f"{per_step} per step, {per_mask} per mask step and {per_view} per view "
                f"({masks} of each), {per_gen} per evaluation")
    if name in KG_COUNTS:
        c = {k: v[0] for k, v in KG_COUNTS[name].items()}
        per_epoch, build = c.get("epoch", 0), c.get("build", 0)
        return (c["step"] * steps + per_epoch * epochs + c["gen"] * evals + build,
                f"{c['step']} per step, {per_epoch} per epoch, {c['gen']} per evaluation, "
                f"{build} at construction")
    if name in MB_B1:
        per_step, per_gen = MB_B1[name]
        per_epoch, once = MB_EPOCH_B1[name](model) if name in MB_EPOCH_B1 else (0, 0)
        return (per_step * steps + per_gen * evals + per_epoch * epochs + once,
                f"{per_step} per step, {per_gen} per evaluation, {per_epoch} per epoch, "
                f"{once} once")
    if name in SOCIAL_B1:
        per_step, per_gen = SOCIAL_B1[name]
        added = getattr(model, "added_views", {"ui": 0, "uu": 0})
        extra = sum(DCREC_ADDED_B1[k] * n for k, n in added.items())
        return (per_step * steps + extra + per_gen * evals,
                f"{per_step} per step, {per_gen} per evaluation, {extra} over the added "
                f"edges of {added['ui']} UI and {added['uu']} trust views")
    if name in SSL_B1:
        per_step, per_gen, per_build = SSL_B1[name]
        return (per_step * steps + per_gen * evals + per_build,
                f"{per_step} per step, {per_gen} per evaluation, {per_build} at construction")
    per_step, per_regen, per_view, per_gen = VIEW_B1[name]
    views = epochs * -(-n_batches // fix_steps) if per_regen or per_view else 0
    return (per_step * steps + (per_regen + per_view) * views + per_gen * evals,
            f"{per_step} per step, {per_regen} per regenerating step and {per_view} per view "
            f"({views} of each), {per_gen} per evaluation")


def b2_count(name: str, epochs: int, n_batches: int) -> int:
    """B2 launches of ``epochs`` epochs of model ``name`` through the CLI,
    counted from the code: the KG paths' alone among those ``ssl_paths`` runs."""
    if name not in KG_COUNTS:
        return 0
    c = {k: v[1] for k, v in KG_COUNTS[name].items()}
    return (c["step"] * epochs * n_batches + c.get("epoch", 0) * epochs
            + c["gen"] * (epochs + 2) + c.get("build", 0))


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's heading ("== ...") with the seconds since the
    script started."""
    if msg.startswith("== "):
        msg = f"{msg} (at {time.perf_counter() - T_START:.1f} s)"
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


def check_graph(errs: ErrTrack, name: str, g: sk.CsrGraph, widths, gen, with_grads,
                ref64: bool = False):
    """Kernel against plain on both directions of ``g``: no weight, two
    materialised PRF dropout masks (keep 0.5; keep 0.6 rescaled), the same
    two as in-kernel :class:`PrfMask`s, which must equal the kernel fed the
    materialised mask bit for bit, and (``with_grads``) a learned weight with
    dx and dew and both constant multipliers' dx.  Every kernel call with no
    weight, a mask or the PRF is made twice and must repeat bit for bit.  ``ref64``: the plain version
    runs in float64, for rows so long that float32 rounding in another sum
    order alone would reach the tolerance; inputs are then small integers
    and the learned weight takes values in {0, 0.5, 1, 2}."""
    dev = g.vals.device
    key = torch.tensor([12345, 678], device=dev)
    masks = [(f"{kr}{'r' if rs else ''}", sk.dropout_mask(key, g, kr, resize_val=rs).w,
              sk.prf_mask(key, g, kr, resize_val=rs)) for kr, rs in ((0.5, False), (0.6, True))]

    def rand(*shape):
        if ref64:
            return torch.randint(-8, 9, shape, generator=gen, device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev)

    def plain(lay, x, ew=None):
        if not ref64:
            return sk.csr_spmm_plain(lay, x, ew)
        return sk.csr_spmm_plain(lay, x.double(), ew).float()

    for direction, gd in (("fwd", g), ("bwd", g.t())):
        lay = gd.fwd
        for d in widths:
            x = rand(gd.n_cols, d)
            tag = f"{name}.{direction}.d{d}"
            got = sk.csr_spmm(lay, x)
            check_exact(f"{tag}.repeat", sk.csr_spmm(lay, x), got)
            errs.check(f"{tag}.plain", got, plain(lay, x))
            if ref64:       # small integers: every sum is exact in float32
                check_exact(f"{tag}.exact", got, plain(lay, x))
            for mtag, mask, prf in masks:
                km = sk.csr_spmm(lay, x, mask)
                check_exact(f"{tag}.mask{mtag}.repeat", sk.csr_spmm(lay, x, mask), km)
                errs.check(f"{tag}.mask{mtag}", km, plain(lay, x, mask))
                kp = sk.csr_spmm(lay, x, prf)
                check_exact(f"{tag}.prf{mtag}.repeat", sk.csr_spmm(lay, x, prf), kp)
                check_exact(f"{tag}.prf{mtag}=mask", kp, km)
                errs.check(f"{tag}.prf{mtag}", kp, plain(lay, x, prf))
            if not with_grads:
                continue
            if ref64:
                ew = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)[
                    torch.randint(0, 4, (gd.nnz,), generator=gen, device=dev)]
            else:
                ew = torch.rand(gd.nnz, generator=gen, device=dev)
            w_out = rand(gd.n_rows, d)
            xk, ewk = x.clone().requires_grad_(), ew.clone().requires_grad_()
            yk = sk.SpmmFn.apply(gd, xk, ewk)
            (yk * w_out).sum().backward()
            dt = torch.float64 if ref64 else torch.float32
            xp = x.to(dt, copy=True).requires_grad_()
            ewp = ew.to(dt, copy=True).requires_grad_()
            yp = sk.csr_spmm_plain(lay, xp, ewp)
            (yp * w_out).sum().backward()
            errs.check(f"{tag}.weight", yk.detach(), yp.detach().float())
            errs.check(f"{tag}.weight.dx", xk.grad, xp.grad.float())
            errs.check(f"{tag}.weight.dew", ewk.grad, ewp.grad.float())
            for mtag, m in (("mask", masks[1][1]), ("prf", masks[1][2])):
                xm = x.clone().requires_grad_()
                (sk.SpmmPvFn.apply(gd, xm, m) * w_out).sum().backward()
                xq = x.to(dt, copy=True).requires_grad_()
                (sk.csr_spmm_plain(lay, xq, m) * w_out).sum().backward()
                errs.check(f"{tag}.{mtag}.dx", xm.grad, xq.grad.float())
    torch.cuda.synchronize()
    log(f"  {name}: {g.n_rows}x{g.n_cols}, nnz {g.nnz}, widths {list(widths)}: ok")


STRESS_LONG_ROW = 961_308      # KMCLR's pad row: its lists' gather backward


def stress_graph(dev) -> sk.CsrGraph:
    """A row of ``STRESS_LONG_ROW`` edges and one of 100,000, rows of T-1, T,
    T+1 and 2T+1 edges around every split threshold B1 picks here (32 to
    128), single-edge rows and empty rows, over 60,000 columns, edge values
    in {0.5, 1, 2}."""
    rng = np.random.default_rng(21)
    deg = np.concatenate([[STRESS_LONG_ROW, 100_000],
                          np.tile([31, 32, 33, 65, 0, 63, 64, 1, 0, 129, 127, 128], 300),
                          np.zeros(500, np.int64)])
    rows = np.repeat(np.arange(deg.size), deg)
    cols = rng.integers(0, 60_000, rows.size)
    order = np.lexsort((cols, rows))
    vals = rng.choice(np.float32([0.5, 1.0, 2.0]), rows.size)
    rows, cols = (torch.from_numpy(a[order].astype(np.int32)) for a in (rows, cols))
    return sk.build_csr_graph(CooGraph(rows=rows, cols=cols, vals=torch.from_numpy(vals),
                                       n_rows=deg.size, n_cols=60_000), dev)


def tree_shape(plan: sk.SplitPlan) -> str:
    """The nodes of each level of ``plan``'s combine tree, as a string."""
    ptr, dst = plan.node_ptr.cpu(), plan.node_dst.cpu()
    levels, j, ready = [], 0, plan.n_slots
    while j < dst.shape[0]:
        j1 = int(torch.searchsorted(ptr, ready))
        levels.append(j1 - j)
        j, ready = j1, ready + int((dst[j:j1] < 0).sum())
    return f"{'/'.join(map(str, levels)) or 'none'} nodes (fan-in {plan.fan_in})"


def device_ms(fn, floor: float = 0.0, iters: int = 50, warmup: int = 5,
              windows: int = 8, agree: float = 0.2) -> float:
    """Mean device time of one call, after a warm-up: the kernels, copies and
    memsets that ``iters`` calls put on the card (torch.profiler), each
    kind's mean duration times its count per call, summed.  Host time
    between launches is not in it, so it is the kernel's own time even where
    the host is slower.

    The profiler loses kernel records and now and then misreads durations
    (on the H100: 2 of a window's 50 B2 calls every time, 8 of 150 records
    of a flush and a B1 call, a whole window read at half its time, a 31 µs
    B1 call once read as 9.4 µs, under the least time its work can take).
    So a kind's count per call is its records over ``iters``, rounded; a
    window counts only where it has every kind at the count per call of the
    fullest window seen and its time per call is at least ``floor`` (the
    work's bound, ms); the reading is the mean of the first two such windows
    whose times agree within ``agree``.  A window that reads no CUDA record
    at all (4 of 8 in one run) is measured again without counting toward
    ``windows``, up to ``3 * windows`` windows in all.  Raises when
    ``windows`` windows that read records, or the ``3 * windows``, give no
    such pair."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    whole, seen, empty = [], [], 0
    while len(seen) < windows and len(seen) + empty < 3 * windows:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.count and not getattr(e, "is_user_annotation", False)]
        if not events:
            empty += 1
            continue
        per_call = {e.key: max(1, round(e.count / iters)) for e in events}
        ms = sum(device_us(e) / e.count * per_call[e.key] for e in events) / 1e3
        seen.append((per_call, sum(e.count for e in events), round(ms, 6)))
        fullest = max((k for k, _, _ in seen), key=lambda k: sum(k.values()))
        if per_call != fullest or ms < floor:
            continue
        for k0, ms0 in whole:
            if k0 == fullest and abs(ms - ms0) <= agree * max(ms, ms0):
                return (ms + ms0) / 2
        whole.append((per_call, ms))
    raise AssertionError(f"device_ms: no two whole windows of {iters} calls agree among "
                         f"{len(seen)} that read records; {empty} of {len(seen) + empty} "
                         f"windows read no CUDA record (records, ms per call: "
                         f"{[w[1:] for w in seen]}; kinds per call "
                         f"{seen[-1][0] if seen else {}}; floor {floor:.6f} ms)")


def cold_ms(fn, floor: float = 0.0, flush_bytes: int = 64 * 2**20, tries: int = 3) -> float:
    """Device time of ``fn`` with the 50 MB L2 cache flushed before each
    call: that of a ``flush_bytes`` fill followed by the call, less that of
    the fill alone.  Repeated calls on one input otherwise find it in L2
    wherever it fits there.  Each reading has its floor (the fill's bound,
    and ``floor`` for ``fn``'s work); a difference under ``floor`` is
    measured again, up to ``tries`` times, then raises."""
    buf = torch.empty(flush_bytes // 4, device="cuda")
    fill_floor = 1e3 * flush_bytes / HBM_BYTES_PER_S

    def flush():
        buf.fill_(0.0)

    got = []
    for _ in range(tries):
        got.append(device_ms(lambda: (flush(), fn()), fill_floor + floor)
                   - device_ms(flush, fill_floor))
        if got[-1] >= floor:
            return got[-1]
    raise AssertionError(f"cold_ms: {got} ms under the floor {floor:.6f} ms")


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


def bound_ms(lay: sk.CsrLayout, d: int, mode: str = "none",
             x_rows: int | None = None) -> tuple[float, str]:
    """Least time for one B1 call: each input the function needs read once
    (x's ``x_rows`` rows, by default all ``n_cols``; cols, indptr, and vals
    unless the layout's are all ones), the output written once, over HBM
    bandwidth; 2·nnz·d flops over the float32 peak; the larger.  ``mode``:
    "none"; "mask" (a [nnz] multiplier read, through the edge ids on a
    permuted layout; one multiply per edge); "prf" (no mask: the edge ids on
    a permuted layout only, and the PRF's operations)."""
    nnz = lay.cols.shape[0]
    vals = 0 if lay.vals_ones else nnz
    x_rows = lay.n_cols if x_rows is None else x_rows
    n_bytes = 4 * (x_rows * d + lay.n_rows * d + nnz + vals + lay.n_rows + 1)
    flops = 2 * nnz * d
    ids_bytes = 0 if lay.ids_identity else 4 * nnz
    if mode == "mask":
        n_bytes += 4 * nnz + ids_bytes
        flops += nnz
    elif mode == "prf":
        n_bytes += ids_bytes
        flops += (PRF_OPS_PER_EDGE + 1) * nnz
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timing(kernel, plain, library=None, floor: float = 0.0, **extra) -> dict:
    """Device times (torch.profiler) of a kernel call, its plain version and a
    library call, then their CUDA-event times, in that order; ``extra``
    callables are timed on the device too, under their own names.  The
    first three compute the same function, so each device reading must be
    at least ``floor``, its bound (ms)."""
    r = {"ms": device_ms(kernel, floor), "plain_ms": device_ms(plain, floor),
         "library_ms": None if library is None else device_ms(library, floor)}
    r.update({f"{k}_ms": device_ms(fn) for k, fn in extra.items()})
    r.update({"event_ms": time_ms(kernel), "plain_event_ms": time_ms(plain),
              "library_event_ms": None if library is None else time_ms(library)})
    return r


def schedule(lay: sk.CsrLayout, d: int) -> tuple[int, int]:
    """The lane group and split threshold B1 picks for ``lay`` at width ``d``
    on card 0, in the precision mode in force."""
    return sk.schedule(lay, d, sk.resident_threads(0))


def log_timing(name: str, r: dict, bound: tuple[float, str]) -> None:
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f}"
    log(f"  {name}: kernel {r['ms'] * 1e3:.2f} us device ({r['event_ms'] * 1e3:.2f} events), "
        f"plain {r['plain_ms'] * 1e3:.2f}, library {lib}; bound {bound[0] * 1e3:.2f} us "
        f"({bound[1]}), kernel at {100 * bound[0] / r['ms']:.1f}% of it")
    more = {k[:-3]: v for k, v in r.items() if k.endswith("_ms") and k not in
            ("plain_ms", "library_ms", "event_ms", "plain_event_ms", "library_event_ms")}
    if more:
        log("    device us: " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in more.items()))


def csr_tensor(lay: sk.CsrLayout, vals: torch.Tensor | None = None) -> torch.Tensor:
    """``lay`` as a torch CSR tensor, for ``torch.sparse.mm`` (the yardstick)."""
    return torch.sparse_csr_tensor(lay.indptr, lay.cols, lay.vals if vals is None else vals,
                                   size=(lay.n_rows, lay.n_cols))


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
        idx, sampled, keys = trainer.epoch_draws(0)
        b = idx[0]
        batch = {"user": data.train_users[b], "pos": data.train_items[b],
                 "neg": sampled["neg"][b]}
        loss, _ = model.loss(batch, keys[0])
        loss.backward()
        losses[dev] = loss.detach().reshape(1).cpu()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    errs.check("small.loss", losses["cuda"], losses["cpu"])
    for k in grads["cpu"]:
        errs.check(f"small.grad.{k}", grads["cuda"][k], grads["cpu"][k])
    log(f"  small graph step, card vs CPU: loss {float(losses['cuda'][0]):.6f}: ok")


def check_exact(what: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """``got`` equal to ``ref``, element for element, −inf included."""
    if got.shape != ref.shape or not torch.equal(got, ref):
        n_bad = int((got != ref).sum()) if got.shape == ref.shape else -1
        raise AssertionError(f"{what}: not equal ({n_bad} entries differ)")


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


def write_cf_pairs(path: str, pairs: np.ndarray) -> None:
    """(user, item) pairs grouped by user, users ascending, in the KG
    handler's ``u i1 i2 ...`` lines."""
    users, starts = np.unique(pairs[:, 0], return_index=True)
    with open(path, "w") as f:
        for u, items in zip(users, np.split(pairs[:, 1], starts[1:])):
            f.write(" ".join(map(str, [u, *items])) + "\n")


def write_kg_dataset(name: str, train_cf, test_cf, triples) -> None:
    """The KG handler's layout under ``SMOKE_RESULTS/kg/<name>_kg/``."""
    d = os.path.join(SMOKE_RESULTS, "kg", f"{name}_kg")
    os.makedirs(d, exist_ok=True)
    for fname, pairs in (("train.txt", train_cf), ("test.txt", test_cf)):
        write_cf_pairs(os.path.join(d, fname), pairs)
    np.savetxt(os.path.join(d, "kg_final.txt"), triples, fmt="%d")


def attn_plain(ids, num_segments, logits, values, mask):
    """The fused attention's plain counterpart: segment softmax, mask, sum."""
    e = plain_seg.segment_softmax(logits, ids, num_segments) * mask
    return plain_seg.segment_sum(values * e[:, None], ids, num_segments)


def zipf_heads(n: int = 300_000, n_segments: int = 30_000, seed: int = 24,
               power: float = 1.1) -> np.ndarray:
    """B2's stress layout: ``n`` head ids over ``n_segments``, id i drawn
    with p ∝ 1/(i + 1)^power, then the slots shuffled; a KG whose head
    degrees follow a power law (at the defaults its longest segment holds
    42,678 slots and 9,214 are empty)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_segments + 1) ** power
    return rng.permutation(rng.choice(n_segments, n, p=p / p.sum()))


def b2_shape(lay: skn.SegmentLayout) -> dict:
    """A B2 layout's shape as the card runs it: its runs, the spread
    segments (combined across runs), the longest and the empty ones."""
    lengths = np.diff(lay.csr.indptr.cpu().numpy())
    spread, _, parts = skn.spread_segments(lay.csr.indptr)
    return {"n": lay.n, "num_segments": lay.num_segments, "runs": -(-lay.n // skn.RUN_SLOTS),
            "spread_segments": int(spread.size), "most_parts": int(parts.max(initial=0)),
            "longest_segment": int(lengths.max(initial=0)),
            "empty_segments": int((lengths == 0).sum())}


def check_bits(what: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """``got`` equal to ``ref`` bit for bit (NaN and the sign of 0 included)."""
    check_exact(what, got.view(torch.int32), ref.view(torch.int32))


def b2_cases(rng, kgcl_ids: np.ndarray, n_kgcl: int) -> dict:
    """(ids, segments) of B2 cases that take every path of its plan: the
    power-law stress layout and a uniform one of the same n and segment
    count (both timed in phase 7), segments that end on a run's end, on the
    end of the next run's first 32 slots and one past it, two spread over
    thousands of runs, one segment, one slot each, a gap of 1,000 empty
    segments, a ragged last run, 0 slots, and a power-law layout of more runs
    than the card holds warps at once."""
    def of_lengths(lengths, reps=1):
        lengths = np.tile(lengths, reps)
        return rng.permutation(np.repeat(np.arange(lengths.size), lengths)), lengths.size

    resident = sk.resident_threads(0)
    return {"zipf": (zipf_heads(), 30_000),
            "uniform": (rng.integers(0, 30_000, 300_000), 30_000),
            "ends_on_run_end": of_lengths([100, 28, 128, 64, 64, 1, 127], 200),
            "ends_on_window_end": of_lengths([120, 40, 96, 160, 96], 200),
            "one_past_window": of_lengths([120, 41, 95, 161, 95], 200),
            "spans_many_runs": of_lengths([3, 100_000, 0, 0, 2, 70_000, 5, 1]),
            "one_segment": (np.full(50_000, 3), 5),
            "one_element": (rng.permutation(5000), 6000),
            "empty_segments": (kgcl_ids[(kgcl_ids < 1000) | (kgcl_ids >= 2000)], n_kgcl),
            "ragged": (rng.integers(0, 97, 12_345), 97),
            "n0": (np.zeros(0, np.int64), 100),
            "more_runs_than_warps": (zipf_heads(4 * resident + 1, seed=25), 30_000)}


def signed_zeros(lay: skn.SegmentLayout, gen) -> torch.Tensor:
    """Data of ±0 and negatives over ``lay``: the zeros of an even segment
    −0, of an odd one +0, of every fifth one of either sign."""
    dev = lay.ids.device
    ids = lay.ids.long()
    coin = torch.rand(lay.n, generator=gen, device=dev) < 0.5
    negative = torch.where(ids % 5 == 0, coin, ids % 2 == 0)
    zeros = torch.where(negative, -0.0, 0.0)
    low = -torch.rand(lay.n, generator=gen, device=dev) - 1.0
    return torch.where(torch.rand(lay.n, generator=gen, device=dev) < 0.3, zeros, low)


def check_b2_bits(what: str, lay: skn.SegmentLayout, data: torch.Tensor) -> torch.Tensor:
    """B2 bit for bit against its plain version on ``data`` and against its
    own second call.  A segment whose max is 0 and that holds both −0 and +0
    is the one exception: the plain version's answer there depends on the
    order of its atomics, so the kernel must give +0 and the plain version
    ±0."""
    got = skn.segment_max(lay, data)
    ref = skn.segment_max_plain(lay, data.contiguous())
    check_bits(f"segmax.{what}.repeat", skn.segment_max(lay, data), got)
    zero = data.contiguous() == 0
    signs = [plain_seg.segment_max((zero & (torch.signbit(data) == neg)).float(), lay.ids,
                                   lay.num_segments) > 0 for neg in (False, True)]
    mixed = signs[0] & signs[1] & (ref == 0)
    check_bits(f"segmax.{what}", got[~mixed], ref[~mixed])
    if not (torch.equal(got[mixed], ref[mixed]) and not torch.signbit(got[mixed]).any()):
        raise AssertionError(f"segmax.{what}: a max of -0 and +0 is not +0")
    return got


def check_segment_ops(errs: ErrTrack, lay: skn.SegmentLayout, gen) -> dict:
    """B2 bit for bit against its plain version and its own second call at
    the KGCL shape and on cases that take every path of its plan (random
    data; NaN inside the longest segment; ±0; all −1e9);
    B1 as segment sum, gather and fused attention (values and gradients)
    against their plain versions at the KGCL shape.  Returns the power-law
    and uniform layouts, which phase 7 times."""
    dev = lay.ids.device
    n, S = lay.n, lay.num_segments
    logits = torch.randn(n, generator=gen, device=dev) * 5
    keep = torch.rand(n, generator=gen, device=dev) < 0.5
    for tag, data in (("logits", logits),
                      ("masked", torch.where(keep, logits, -1e9)),
                      ("all_masked", torch.full((n,), -1e9, device=dev))):
        check_b2_bits(f"kgcl.{tag}", lay, data)
    rng = np.random.default_rng(11)
    spread, stress = set(), {}
    for tag, (ids_c, s_c) in b2_cases(rng, lay.ids.cpu().numpy(), S).items():
        lay_c = skn.build_segment_layout(ids_c, s_c, dev)
        shape = b2_shape(lay_c)
        if shape["spread_segments"]:
            spread.add(tag)
        data = torch.randn(ids_c.size, generator=gen, device=dev)
        got = check_b2_bits(tag, lay_c, data)
        check_b2_bits(f"{tag}.all_masked", lay_c, torch.full_like(data, -1e9))
        if ids_c.size:
            nan = data.clone()
            longest = int(np.bincount(ids_c).argmax())
            occurs = np.flatnonzero(ids_c == longest)
            nan[int(occurs[occurs.size // 2])] = float("nan")
            if not torch.isnan(check_b2_bits(f"{tag}.nan", lay_c, nan)[longest]):
                raise AssertionError(f"segmax.{tag}.nan: the NaN did not win")
            check_b2_bits(f"{tag}.signed_zeros", lay_c, signed_zeros(lay_c, gen))
        if tag in ("zipf", "uniform"):
            stress[tag] = lay_c
        log(f"  B2 {tag}: {shape}, {int(torch.isinf(got).sum())} -inf; bit for bit (data, "
            f"all -1e9, NaN in the longest segment, ±0) and twice")
    want_spread = {"zipf", "one_past_window", "spans_many_runs", "one_segment", "ragged",
                   "more_runs_than_warps"}
    if spread != want_spread:
        raise AssertionError(f"B2's cases with segments combined across runs: {sorted(spread)}, "
                             f"want {sorted(want_spread)}")
    column = torch.randn(n, 2, generator=gen, device=dev)[:, 1]
    check_b2_bits("kgcl.strided_column", lay, column)
    check_segment_b1(errs, "kgcl_heads", lay, (1, 64, 65), gen)
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
    return stress


def check_relation_take(errs: ErrTrack, rel: skn.OneHotTake, d: int, gen) -> None:
    """KGCL's relation take at its shape: the value a plain index gives, the
    table gradient (B1's segment sum, rows split into chunks) against the
    plain index's autograd, and that gradient bit for bit twice."""
    dev = rel.layout.ids.device
    V, n = rel.layout.num_segments, rel.layout.n
    table = torch.randn(V, d, generator=gen, device=dev)
    w = torch.randn(n, d, generator=gen, device=dev)
    tk, tp = table.clone().requires_grad_(), table.clone().requires_grad_()
    yk = rel.take(tk)
    (yk * w).sum().backward()
    (tp[rel.layout.ids.long()] * w).sum().backward()
    check_exact("relation_take.value", yk.detach(), table[rel.layout.ids.long()])
    errs.check("relation_take.grad", tk.grad, tp.grad)
    again = table.clone().requires_grad_()
    (rel.take(again) * w).sum().backward()
    check_exact("relation_take.grad.repeat", again.grad, tk.grad)
    plan = sk.layout_plan(rel.layout.csr, schedule(rel.layout.csr, d)[1])
    torch.cuda.synchronize()
    log(f"  relation take: {n} rows into {V}, d {d}: {plan.n_chunks} chunks of <= {plan.t} "
        f"edges, {plan.split_rows.numel()} split rows; value exact, gradient within "
        f"tolerance and bit for bit twice")


def time_b2(lay: skn.SegmentLayout, gen) -> tuple[dict, tuple[float, str]]:
    """B2's device and event times over ``lay`` on random logits, beside its
    plain version and ``scatter_reduce_``, and its bound."""
    logits = torch.randn(lay.n, generator=gen, device=lay.ids.device)
    ids64 = lay.ids.long()
    amax = torch.full((lay.num_segments,), float("-inf"), device=lay.ids.device)
    bound = segmax_bound_ms(lay)
    return timing(lambda: skn.segment_max(lay, logits), lambda: skn.segment_max_plain(lay, logits),
                  lambda: amax.scatter_reduce_(0, ids64, logits, "amax", include_self=False),
                  bound[0]), bound


def time_kgcl_shapes(seg_lay: skn.SegmentLayout, deg_lay: skn.SegmentLayout,
                     ui: sk.CsrGraph, ui_w: torch.Tensor, rel_lay: skn.SegmentLayout,
                     b2_stress: dict, gen) -> tuple[dict[str, dict], dict[str, tuple[float, str]]]:
    """Device and event times at the KGCL path's shapes, and their bounds: B2,
    and B2 at the power-law and uniform layouts of ``b2_stress``; B1 as the
    RGAT's [n × 65] segment sum, as the [n_bi × 1] degree sum, as the UI hop
    at d = 64 under a view's values (both layouts), and as the relation
    take's backward with both yardsticks."""
    dev = seg_lay.ids.device
    n = seg_lay.n
    t = {}
    bounds = {"kg_sum_d65": bound_ms(seg_lay.csr, 65),
              "kg_sum_d1": bound_ms(deg_lay.csr, 1), "ui_hop_d64": bound_ms(ui.fwd, 64, "mask"),
              "relation_take": bound_ms(rel_lay.csr, 64)}
    for key, lay in (("b2", seg_lay), *((f"b2_{k}", v) for k, v in b2_stress.items())):
        t[key], bounds[key] = time_b2(lay, gen)
    x65 = torch.randn(n, 65, generator=gen, device=dev)
    csr_seg = csr_tensor(seg_lay.csr)
    t["kg_sum_d65"] = timing(
        lambda: sk.csr_spmm(seg_lay.csr, x65), lambda: sk.csr_spmm_plain(seg_lay.csr, x65),
        lambda: torch.sparse.mm(csr_seg, x65), bounds["kg_sum_d65"][0])
    x1 = torch.rand(deg_lay.n, 1, generator=gen, device=dev)
    csr_deg = csr_tensor(deg_lay.csr)
    t["kg_sum_d1"] = timing(lambda: sk.csr_spmm(deg_lay.csr, x1),
                            lambda: sk.csr_spmm_plain(deg_lay.csr, x1),
                            lambda: torch.sparse.mm(csr_deg, x1), bounds["kg_sum_d1"][0])
    x64 = torch.randn(ui.n_cols, 64, generator=gen, device=dev)
    csr_ui = csr_tensor(ui.fwd, ui.fwd.vals * ui_w)          # forward ids: the identity
    csr_ui_b = csr_tensor(ui.bwd, ui.bwd.vals * ui_w[ui.bwd.edge_ids.long()])
    t["ui_hop_d64"] = timing(lambda: sk.csr_spmm(ui.fwd, x64, ui_w),
                             lambda: sk.csr_spmm_plain(ui.fwd, x64, ui_w),
                             lambda: torch.sparse.mm(csr_ui, x64), bound_ms(ui.fwd, 64)[0],
                             bwd=lambda: sk.csr_spmm(ui.bwd, x64, ui_w),
                             library_bwd=lambda: torch.sparse.mm(csr_ui_b, x64))
    g = torch.randn(rel_lay.n, 64, generator=gen, device=dev)
    rel_ids = rel_lay.ids.long()
    onehot = F.one_hot(rel_ids, rel_lay.num_segments).float()
    t["relation_take"] = timing(
        lambda: sk.csr_spmm(rel_lay.csr, g), lambda: sk.csr_spmm_plain(rel_lay.csr, g),
        lambda: g.new_zeros(rel_lay.num_segments, 64).index_put_((rel_ids,), g,
                                                                   accumulate=True),
        bounds["relation_take"][0], onehot=lambda: onehot.T @ g)
    t["relation_take"]["onehot_mb"] = onehot.numel() * 4 / 1e6
    return t, bounds


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

        aux = model.epoch_state(None, 0, draws=on(draws[0]))
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


def lightgcn_data(dev):
    """The LightGCN path's config and its alibaba-fashion data on ``dev``,
    as ``sslrec_tpu_torch.main`` loads them (the bi-adjacency is
    ``data.extras["bi_adj"]``)."""
    cfg = load_config("lightgcn", dataset=DATASET, overrides={"data.dir": DATA_DIR})
    return cfg, general_cf.load(cfg, dev)


def kgcl_shapes(dev) -> dict:
    """The KGCL path's kernel operands at the synthetic-at-scale shape: the
    dataset written under ``SMOKE_RESULTS`` and loaded on the CPU (``cfg``,
    ``data``), the RGAT's segment layout over the KG heads (``seg``), the
    view degrees' layout over the UI bi-adjacency's rows (``deg``), that
    bi-adjacency in both layouts (``ui``) and one view's values (``ui_w``,
    from a seeded draw), on ``dev``."""
    write_kg_dataset(KG_DATASET, *synthetic_kg())
    cfg = load_config("kgcl", dataset=KG_DATASET, overrides={"data.dir": SMOKE_RESULTS})
    data = kg_data.load(cfg, "cpu")
    ex = data.extras
    bi = ex["bi_adj_maskable"]
    keep = torch.rand(bi.nnz_rect, generator=torch.Generator().manual_seed(0)) < 0.5
    return {"cfg": cfg, "data": data,
            "seg": skn.build_segment_layout(ex["kg_heads"], ex["entity_num"], dev),
            "deg": skn.build_segment_layout(bi.graph.rows, bi.n_nodes, dev),
            "ui": sk.build_csr_graph(CooGraph(rows=bi.graph.rows, cols=bi.graph.cols,
                                              vals=bi.graph.vals, n_rows=bi.n_nodes,
                                              n_cols=bi.n_nodes), dev),
            "ui_w": bi.view_vals(keep.float()).to(dev)}


def ssl_graphs(data, dev) -> tuple[sk.CsrGraph, sk.CsrGraph]:
    """The self-supervised models' new B1 operands from ``data``'s train
    matrix: DCCF's plain (all-ones) bi-adjacency and LightGCL's
    1/√(rowD·colD) user × item matrix, both layouts on ``dev``."""
    trn = data.extras["train_mat_scipy"]
    plain, _ = plain_and_norm_adj(trn, data.user_num, data.item_num, dev)
    return plain, rect_norm_adj(trn, dev)


def dew_bound_ms(g: sk.CsrGraph, d: int) -> tuple[float, str]:
    """Least time for the learned weight's gradient vals[e]·⟨g[row_e], x[col_e]⟩:
    both [n, d] tables, rows and cols read once (vals are all ones on DCCF's
    graph), [nnz] written; 2·nnz·d flops."""
    vals = 0 if g.fwd.vals_ones else g.nnz
    n_bytes = 4 * ((g.n_rows + g.n_cols) * d + 3 * g.nnz + vals)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * g.nnz * d / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ssl_shapes(plain: sk.CsrGraph, rect: sk.CsrGraph,
                    gen) -> tuple[dict[str, dict], dict[str, tuple[float, str]]]:
    """Device and event times at the new shapes, and their bounds: B1 as
    DCCF's hop with a learned weight over its all-ones layouts (forward and
    transposed) and the weight's gradient (dew, plain torch, with
    ``sampled_addmm`` as its yardstick); LightGCL's rectangular hop at d 32
    and its SVD's width 13, both directions.  Each kernel is also timed with
    L2 flushed (``cold_ms``)."""
    dev = plain.vals.device
    t = {}
    b = {"dccf_hop": bound_ms(plain.fwd, 32, "mask"), "dccf_hop_t": bound_ms(plain.bwd, 32, "mask"),
         "dccf_dew": dew_bound_ms(plain, 32),
         **{f"lightgcl_d{d}{s}": bound_ms(lay, d) for d in (32, 13)
            for s, lay in (("", rect.fwd), ("_t", rect.bwd))}}
    # the weighted hops' floor: the bound without the weight, which the
    # library call (values pre-multiplied) does not read
    f_hop, f_hop_t = bound_ms(plain.fwd, 32)[0], bound_ms(plain.bwd, 32)[0]
    x = torch.randn(plain.n_cols, 32, generator=gen, device=dev)
    g_out = torch.randn(plain.n_rows, 32, generator=gen, device=dev)
    ew = torch.rand(plain.nnz, generator=gen, device=dev)
    ew_b = ew[plain.bwd.edge_ids.long()]
    csr_f, csr_b = csr_tensor(plain.fwd, ew), csr_tensor(plain.bwd, ew_b)
    pattern = csr_tensor(plain.fwd)
    t["dccf_hop"] = timing(lambda: sk.csr_spmm(plain.fwd, x, ew),
                           lambda: sk.csr_spmm_plain(plain.fwd, x, ew),
                           lambda: torch.sparse.mm(csr_f, x), f_hop)
    t["dccf_hop_t"] = timing(lambda: sk.csr_spmm(plain.bwd, x, ew),
                             lambda: sk.csr_spmm_plain(plain.bwd, x, ew),
                             lambda: torch.sparse.mm(csr_b, x), f_hop_t)
    t["dccf_dew"] = timing(
        lambda: plain.vals * (g_out[plain.rows] * x[plain.cols]).sum(-1),
        lambda: plain.vals * (g_out[plain.rows] * x[plain.cols]).sum(-1),
        lambda: torch.sparse.sampled_addmm(pattern, g_out, x.T, beta=0.0), b["dccf_dew"][0])
    for d in (32, 13):
        xi = torch.randn(rect.n_cols, d, generator=gen, device=dev)
        xu = torch.randn(rect.n_rows, d, generator=gen, device=dev)
        csr_r, csr_rt = csr_tensor(rect.fwd), csr_tensor(rect.bwd)
        t[f"lightgcl_d{d}"] = timing(lambda: sk.csr_spmm(rect.fwd, xi),
                                     lambda: sk.csr_spmm_plain(rect.fwd, xi),
                                     lambda: torch.sparse.mm(csr_r, xi),
                                     b[f"lightgcl_d{d}"][0])
        t[f"lightgcl_d{d}_t"] = timing(lambda: sk.csr_spmm(rect.bwd, xu),
                                       lambda: sk.csr_spmm_plain(rect.bwd, xu),
                                       lambda: torch.sparse.mm(csr_rt, xu),
                                       b[f"lightgcl_d{d}_t"][0])
        t[f"lightgcl_d{d}"]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(rect.fwd, xi),
                                                 b[f"lightgcl_d{d}"][0])
        t[f"lightgcl_d{d}_t"]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(rect.bwd, xu),
                                                   b[f"lightgcl_d{d}_t"][0])
    t["dccf_hop"]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(plain.fwd, x, ew), f_hop)
    t["dccf_hop_t"]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(plain.bwd, x, ew), f_hop_t)
    t["dccf_dew"]["cold_ms"] = cold_ms(
        lambda: plain.vals * (g_out[plain.rows] * x[plain.cols]).sum(-1), b["dccf_dew"][0])
    return t, b


def ssl_paths(errs: ErrTrack, device: str = "cuda", data_dir: str = DATA_DIR,
              dataset: str = DATASET, epochs: int = PATH_EPOCHS, models=SSL_MODELS,
              keep: dict | None = None, extra_args: dict | None = None,
              ref64=(), refs: dict | None = None) -> dict[str, dict]:
    """Each of ``models`` trained ``epochs`` epochs at its published config
    through ``sslrec_tpu_torch.main``, with the launch counts reset just
    before and read just after the run; checks the losses, B1's launches
    against :func:`b1_count`, B2's against :func:`b2_count`, and
    ``generate()`` against the same forward on the CPU's plain versions
    (LightGCL with the card's SVD factors; in float64 for the models in
    ``ref64``, whose RGAT's row normalisation magnifies float32 rounding, as
    phase 8 holds KGCL).  ``extra_args`` adds a model's CLI arguments.  The
    CPU's data are loaded anew, or, for the models in ``CPU_FROM_CARD``,
    copied from the run's (:func:`on_device`).  Each trained model goes into
    ``keep`` where it is given, so later phases take its layouts, and its
    run's :func:`mesh_reference` into ``refs``, so that phase 37(g) holds
    the model's mesh run to it."""
    cpu_data, cpu_key, out = None, None, {}
    for name in models:
        argv = ["--model", name, "--data_dir", data_dir, "--dataset", dataset,
                "--epoch", str(epochs), "--device", device, "--set", "train.test_step=1",
                "--set", f"train.results_dir={SMOKE_RESULTS}", "--set", "tune.enable=false",
                *(extra_args or {}).get(name, [])]
        sk.csr_spmm.launches = sk.csr_spmm.combine_launches = skn.segment_max.launches = 0
        t0 = time.perf_counter()
        trainer = port_main.main(argv)
        wall = time.perf_counter() - t0
        b1, combine, b2 = (sk.csr_spmm.launches, sk.csr_spmm.combine_launches,
                           skn.segment_max.launches)
        rows = trainer.recorder.epochs
        steps = len(rows) * trainer.n_batches
        m_cfg = trainer.cfg.model
        want, how = b1_count(name, len(rows), trainer.n_batches,
                             int(m_cfg.get("fix_steps", m_cfg.get("mask_steps", 1))),
                             trainer.model)
        want_b2 = b2_count(name, len(rows), trainer.n_batches)
        log(f"  {name}: {len(rows)} epochs of {trainer.n_batches} steps in {wall:.1f} s; B1 "
            f"{b1} launches ({want} counted from the code: {how}; {combine} with the split "
            f"rows' combine), B2 {b2} ({want_b2} counted from the code)")
        if (b1, b2) != (want, want_b2):
            raise AssertionError(f"{name} launched B1 {b1}, B2 {b2} times; the code counts "
                                 f"{want} and {want_b2}")
        at20 = list(trainer.cfg.test.k).index(20)
        for r in rows:
            if not all(math.isfinite(v) for v in r["loss"].values()):
                raise AssertionError(f"{name} epoch {r['epoch']}: losses {r['loss']}")
            log(f"    epoch {r['epoch']}: loss {r['loss']['loss']:.5f}, train "
                f"{r['train_s']:.3f} s, valid recall@20 {r['valid']['recall'][at20]:.5f}, "
                f"eval {r['eval_s']:.3f} s")
        model = trainer.model
        key = cpu_data_key(trainer.cfg)
        if name in CPU_FROM_CARD:
            cpu_data, cpu_key = on_device(trainer.data, torch.device("cpu")), None
        elif cpu_data is None or key is None or key != cpu_key:
            cpu_data, cpu_key = load_data(trainer.cfg, "cpu"), key
        cpu_model = build_model(trainer.cfg, cpu_data)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        if name == "lightgcl":
            for k in ("ut", "vt", "u_mul_s", "v_mul_s"):
                setattr(cpu_model, k, getattr(model, k).cpu())
        if name in ref64:
            cpu_model.double()
        sub = None
        if hasattr(cpu_model, "test_seqs") and cpu_model.test_seqs.shape[0] > SEQ_CPU_ROWS:
            cpu_model.test_seqs = cpu_model.test_seqs[:SEQ_CPU_ROWS]
            cpu_model.test_uids = cpu_model.test_uids[:SEQ_CPU_ROWS]
            sub = cpu_model.test_uids.long()
        with torch.no_grad():
            gu, gi = model.generate()
            cu, ci = cpu_model.generate()
        if sub is not None:
            gu, cu = gu[sub.to(gu.device)], cu[sub]
        got, ref = torch.cat([gu, gi]).cpu().to(cu.dtype), torch.cat([cu, ci])
        errs.check(f"{name}.generate", got, ref)
        test = trainer.test_results
        log(f"    test recall@20 {test['recall'][at20]:.5f}, ndcg@20 {test['ndcg'][at20]:.5f}; "
            f"generate() {tuple(gu.shape)} + {tuple(gi.shape)} = the CPU's plain forward "
            f"(rel err {rel_err(got, ref):.3g})"
            + ("" if sub is None else f"; the users of its first {SEQ_CPU_ROWS} test rows"))
        if keep is not None:
            keep[name] = model
        if refs is not None:
            refs[name] = mesh_reference(name, trainer, wall)
        out[name] = {"launches": b1, "combine_launches": combine, "b2_launches": b2,
                     "losses": [r["loss"] for r in rows],
                     "steps": steps, "per_step": b1 / steps, "wall_s": wall,
                     "train_s": [r["train_s"] for r in rows],
                     "test_recall20": float(test["recall"][at20]),
                     "test_ndcg20": float(test["ndcg"][at20]),
                     "train_rows": trainer.data.n_train, "n_batches": trainer.n_batches}
        del trainer, model, cpu_model
    return out


def on_device(x, device: torch.device):
    """``x`` (a ``DataBundle`` and what it holds: dataclasses, named tuples,
    dicts, lists, tuples) with every tensor on ``device``; anything else as
    it is."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, EdgeSet):
        return EdgeSet(x.codes.to(device), x.n_cols)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: on_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(on_device(v, device) for v in x))
    if isinstance(x, dict):
        return {k: on_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(on_device(v, device) for v in x)
    return x


def cpu_data_key(cfg):
    """What makes two runs' CPU data one bundle, so that :func:`ssl_paths`
    loads it once: the general_cf split of the call, or a sequential split
    with the same data keys and window; None where the data also depend on
    the model (the KG, social and multi-behavior handlers')."""
    if cfg.data.type == "general_cf":
        return ("general_cf",)
    if cfg.data.type == "sequential":
        return ("sequential", repr(sorted(cfg.data.to_dict().items())),
                int(cfg.model.max_seq_len))
    return None


def view_operands(data, dev) -> dict[str, dict]:
    """One AutoCF view and one GFormer view at their published configs on
    ``data`` (on ``dev``), from seeded random weights and draws, built as
    ``epoch_state`` builds each view (layouts on the card); per model its
    ``model`` and ``view``."""
    out = {}
    for seed, name in enumerate(("autocf", "gformer")):
        cfg = load_config(name, dataset=DATASET, overrides={"data.dir": DATA_DIR})
        model = build_model(cfg, data)
        model.init_params(generator(seed, 2))
        with torch.no_grad():
            view = model.one_view(model.view_draws(
                torch.Generator(device=dev).manual_seed(seed)))
        torch.cuda.synchronize()
        out[name] = {"model": model, "view": view}
    return out


def host_graph_layouts(rows, cols, n_rows: int, n_cols: int,
                       dev) -> tuple[sk.CsrLayout, sk.CsrLayout]:
    """The host build of the all-ones graph of edges ``rows`` → ``cols``
    (copied to the host): each layout sorted stably by its destinations,
    ``csr_layout``, back on ``dev``."""
    rows, cols = rows.cpu().numpy(), cols.cpu().numpy()
    ones = np.ones(rows.size, np.float32)
    o, p = np.argsort(rows, kind="stable"), np.argsort(cols, kind="stable")
    return (sk.csr_layout(rows[o], cols[o], ones, o, n_rows, n_cols, dev),
            sk.csr_layout(cols[p], rows[p], ones, p, n_cols, n_rows, dev))


def check_same(what: str, got, want) -> None:
    """Every field of two layouts (NamedTuples) equal, tensors by
    ``torch.equal`` and dtype; the plan caches (B1's ``plans``, B2's
    ``runs``, filled by the calls made so far) are not compared."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f in ("plans", "runs"):
            continue
        if hasattr(a, "_fields"):
            check_same(f"{what}.{f}", a, b)
        elif torch.is_tensor(a):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{what}.{f}: device build differs from the host's")
        elif a != b:
            raise AssertionError(f"{what}.{f}: {a} != {b}")


def check_layout_builds(name: str, graphs: dict, segs: dict, widths=(32, 4, 1)) -> int:
    """Each device-built CsrGraph and SegmentLayout equal to the host build
    of the same edges, and its split plans, built on the card, equal to the
    host's ``split_plan`` at the thresholds B1 picks for ``widths``.
    Returns the number of layouts held."""
    layouts = []
    for tag, g in graphs.items():
        fwd, bwd = host_graph_layouts(g.rows, g.cols, g.n_rows, g.n_cols, g.rows.device)
        check_same(f"{name}.{tag}.fwd", g.fwd, fwd)
        check_same(f"{name}.{tag}.bwd", g.bwd, bwd)
        layouts += [(f"{tag}.fwd", g.fwd), (f"{tag}.bwd", g.bwd)]
    for tag, lay in segs.items():
        check_same(f"{name}.{tag}", lay,
                   skn.build_segment_layout(lay.ids, lay.num_segments, lay.ids.device))
        layouts.append((tag, lay.csr))
    for tag, lay in layouts:
        for t in sorted({schedule(lay, d)[1] for d in widths}):
            check_same(f"{name}.{tag}.plan{t}", sk.layout_plan(lay, t), sk.split_plan(lay.indptr, t))
    return len(layouts)


def check_segment_b1(errs: ErrTrack, name: str, lay: skn.SegmentLayout, widths, gen,
                     ref64: bool = False, ints: bool = False) -> None:
    """B1 as segment sum (value and gradient) and as a gather's backward
    over ``lay``, against the plain versions, at each width.  ``ref64``: the
    plain versions run in float64 (segments so long that float32 rounding in
    another sum order alone would reach the tolerance); ``ints``: the inputs
    are small integers, as ``check_graph``'s with ``ref64``, for a segment so
    long (~10^6 slots) that float32 rounding of random normals alone comes
    within a factor 2 of the tolerance: their sums are exact in float32."""
    dev = lay.ids.device
    n, S, ids = lay.n, lay.num_segments, lay.ids.long()
    dt = torch.float64 if ref64 else torch.float32

    def rand(*shape):
        if ints:
            return torch.randint(-8, 9, shape, generator=gen, device=dev).float()
        return torch.randn(*shape, generator=gen, device=dev)

    for d in widths:
        x = rand(n, d)
        w_out = rand(S, d)
        xk, xp = x.clone().requires_grad_(), x.to(dt, copy=True).requires_grad_()
        yk = skn.SegmentSumFn.apply(lay, xk)
        (yk * w_out).sum().backward()
        yp = plain_seg.segment_sum(xp, lay.ids, S)
        (yp * w_out).sum().backward()
        errs.check(f"{name}.sum.d{d}", yk.detach(), yp.detach().float())
        errs.check(f"{name}.sum.d{d}.grad", xk.grad, xp.grad.float())
        table = rand(S, d)
        w_e = rand(n, d)
        tk, tp = table.clone().requires_grad_(), table.to(dt, copy=True).requires_grad_()
        yk, yp = skn.TakeFn.apply(lay, tk), tp[ids]
        (yk * w_e).sum().backward()
        (yp * w_e).sum().backward()
        errs.check(f"{name}.take.d{d}", yk.detach(), yp.detach().float())
        errs.check(f"{name}.take.d{d}.grad", tk.grad, tp.grad.float())
    torch.cuda.synchronize()
    log(f"  {name}: {n} edges into {S} rows, widths {list(widths)}: ok")


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` through a synchronise, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(out))


def time_layout_builds(ops: dict) -> dict[str, dict]:
    """One view's layouts built on the card (the view's own build functions, and
    each layout's split plan at the d-32 threshold) against the host build
    of the same layouts from the same edges on the card: copied to the host,
    sorted there, copied back, the plans by ``split_plan``."""
    dev = torch.device("cuda", 0)
    n = ops["autocf"]["model"].n_nodes
    ac, gf = ops["autocf"]["view"], ops["gformer"]["view"]
    ac_ids = [lay.ids for lay in ac["dec"][:2]]
    gf_ids = [lay.ids for lay in (*gf["aug_seg"], *gf["dec_seg"])]
    aug_r, aug_c = gf["aug_rows"], gf["aug_cols"]

    def plans(lays, host):
        for lay in lays:
            t = schedule(lay, 32)[1]
            (sk.split_plan(lay.indptr, t) if host else sk.layout_plan(lay, t))

    def device_build(ids_list, graph):
        segs = [skn.segment_layout_from_ids(ids, n).csr for ids in ids_list]
        lays = segs if graph is None else segs + list(sk.csr_graph_from_edges(*graph, n, n)[:2])
        plans(lays, host=False)

    def host_build(ids_list, graph):
        segs = [skn.build_segment_layout(ids.cpu(), n, dev).csr for ids in ids_list]
        lays = segs if graph is None else segs + list(host_graph_layouts(*graph, n, n, dev))
        plans(lays, host=True)

    return {"autocf_view": {"device_ms": wall_ms(lambda: device_build(ac_ids, None)),
                            "host_ms": wall_ms(lambda: host_build(ac_ids, None)),
                            "layouts": "2 segment layouts of the decoder, 1,650,921 edges"},
            "gformer_view": {"device_ms": wall_ms(lambda: device_build(gf_ids, (aug_r, aug_c))),
                             "host_ms": wall_ms(lambda: host_build(gf_ids, (aug_r, aug_c))),
                             "layouts": "the augmented CsrGraph (656,865 edges) and 4 segment "
                                        "layouts (augmented and decoder rows and cols)"}}


def time_view_shapes(ops: dict, gen) -> tuple[dict[str, dict], dict[str, tuple[float, str]]]:
    """Device and event times of B1 at the new shapes, and their bounds:
    AutoCF's decoder as the attention's segment sums (d 32, d 4) and the
    gathers' backward (d 32, also beside ``index_put_``); GFormer's augmented
    hop with the view's encoder values both ways, and its decoder's segment
    sum and gathers' backward at d 32; AdaGCL's gate degree sum over the
    bi-adjacency's rows (d 1)."""
    dev = torch.device("cuda", 0)
    t, b = {}, {}
    ac, gf = ops["autocf"]["view"], ops["gformer"]["view"]

    def seg_sum(key, lay, d):
        x = torch.randn(lay.n, d, generator=gen, device=dev)
        csr = csr_tensor(lay.csr)
        b[key] = bound_ms(lay.csr, d)
        t[key] = timing(lambda: sk.csr_spmm(lay.csr, x), lambda: sk.csr_spmm_plain(lay.csr, x),
                        lambda: torch.sparse.mm(csr, x), b[key][0])
        t[key]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(lay.csr, x), b[key][0])

    def take_bwd(key, lay, d):
        g = torch.randn(lay.n, d, generator=gen, device=dev)
        ids, csr = lay.ids.long(), csr_tensor(lay.csr)
        b[key] = bound_ms(lay.csr, d)
        t[key] = timing(lambda: sk.csr_spmm(lay.csr, g), lambda: sk.csr_spmm_plain(lay.csr, g),
                        lambda: torch.sparse.mm(csr, g), b[key][0],
                        index_put=lambda: g.new_zeros(lay.num_segments, d).index_put_(
                            (ids,), g, accumulate=True))

    seg_sum("autocf_dec_sum_d32", ac["dec"][0], 32)
    seg_sum("autocf_dec_sum_d4", ac["dec"][0], 4)
    take_bwd("autocf_dec_take_bwd_d32", ac["dec"][1], 32)
    aug, ew = gf["aug"], gf["enc_vals"]
    x = torch.randn(aug.n_cols, 32, generator=gen, device=dev)
    for key, lay in (("gformer_aug_hop", aug.fwd), ("gformer_aug_hop_t", aug.bwd)):
        csr = csr_tensor(lay, ew[lay.edge_ids.long()])
        b[key], floor = bound_ms(lay, 32, "mask"), bound_ms(lay, 32)[0]
        t[key] = timing(lambda: sk.csr_spmm(lay, x, ew), lambda: sk.csr_spmm_plain(lay, x, ew),
                        lambda: torch.sparse.mm(csr, x), floor)
        t[key]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(lay, x, ew), floor)
    seg_sum("gformer_dec_sum_d32", gf["dec_seg"][0], 32)
    take_bwd("gformer_dec_take_bwd_d32", gf["dec_seg"][1], 32)
    seg_sum("adagcl_gate_deg_d1", ops["adagcl"]["gate_rows"], 1)
    return t, b

def social_operands(dev) -> dict:
    """The social paths' B1 operands on yelp_sub, on ``dev``: the bi-adjacency
    (DcRec's base tower, DSL's UI tower) and the normalised trust graph
    (DSL's), DcRec's all-ones UI and trust layouts with one seeded view's
    weights (an edge drop of the published count) and one UI view's added
    edges, their layout built on the card; MHCN's three motif channels and
    its joint matrix R, as the handler loads them."""
    over = {"data.dir": DATA_DIR}
    dc = build_model(load_config("dcrec", dataset=SOCIAL_DATASET, overrides=over),
                     load_data(load_config("dcrec", dataset=SOCIAL_DATASET, overrides=over),
                               dev))
    mh = load_data(load_config("mhcn", dataset=SOCIAL_DATASET, overrides=over), dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    drop = dc._draw_view(gen, 1, dc.ui_rows, dc.user_num, dc.item_num, dc.n_aug_ui)["w"]
    add = dc._draw_view(gen, 0, dc.ui_rows, dc.user_num, dc.item_num, dc.n_aug_ui)["add"]
    added = dc._added({"w": None, "add": add}, dc.user_num, dc.item_num)
    ex = mh.extras
    return {"dcrec": dc, "bi": dc.adj, "uu": load_data(load_config(
                "dsl", dataset=SOCIAL_DATASET, overrides=over), dev).extras["uu_adj"],
            "ui": dc.ui, "trust": dc.trust, "drop_w": drop, "added": added,
            "h_s": ex["mhcn_h_s"], "h_j": ex["mhcn_h_j"], "h_p": ex["mhcn_h_p"],
            "r": ex["mhcn_r"]}


def time_social_shapes(ops: dict, gen) -> tuple[dict[str, dict], dict[str, tuple[float, str]]]:
    """Device times (and with L2 flushed, ``cold_ms``) of B1 at the social
    paths' shapes, d 64 unless named, and their bounds: the yelp_sub
    bi-adjacency hop, DcRec's transposed trust hop under a view's values,
    its UI view's hop both ways under the drop weights, the hop over a
    view's added edges both ways, the view's degree sum (d 1), MHCN's R both
    ways and its three channels; each beside its plain version and
    ``torch.sparse.mm``."""
    dev = ops["bi"].vals.device
    t, b = {}, {}

    def row(key, lay, d, ew=None):
        x = torch.randn(lay.n_cols, d, generator=gen, device=dev)
        vals = None if ew is None else lay.vals * ew[lay.edge_ids.long()]
        csr = csr_tensor(lay, vals)
        b[key], floor = bound_ms(lay, d, "none" if ew is None else "mask"), bound_ms(lay, d)[0]
        t[key] = timing(lambda: sk.csr_spmm(lay, x, ew), lambda: sk.csr_spmm_plain(lay, x, ew),
                        lambda: torch.sparse.mm(csr, x), floor)
        t[key]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(lay, x, ew), floor)

    ui, added, trust = ops["ui"], ops["added"], ops["trust"]
    row("yelp_bi_hop_d64", ops["bi"].fwd, 64)
    row("dcrec_trust_hop_t_d64", trust.bwd, 64,
        torch.rand(trust.nnz, generator=gen, device=dev))
    view_w = ops["drop_w"] * torch.rand(ui.nnz, generator=gen, device=dev)
    row("dcrec_ui_view_d64", ui.fwd, 64, view_w)
    row("dcrec_ui_view_t_d64", ui.bwd, 64, view_w)
    added_w = torch.rand(added.nnz, generator=gen, device=dev)
    row("dcrec_added_hop_d64", added.fwd, 64, added_w)
    row("dcrec_added_hop_t_d64", added.bwd, 64, added_w)
    row("dcrec_view_deg_d1", ui.fwd, 1, ops["drop_w"])
    row("mhcn_r_d64", ops["r"].fwd, 64)
    row("mhcn_r_t_d64", ops["r"].bwd, 64)
    for ch in ("h_s", "h_j", "h_p"):
        row(f"mhcn_{ch}_d64", ops[ch].fwd, 64)
    return t, b


def kcgn_smin_operands(k, m) -> dict:
    """KCGN's and SMIN's B1 operands as the trained models ``k`` and ``m``
    hold them: KCGN's expanded graph's destination and source segment
    layouts, its uu and ii DGI graphs, component sums and label layouts;
    SMIN's five metapath graphs, its DGI and 2-hop subgraph graphs and the
    one-hop edges' row and column layouts."""
    return {"seg": {"kcgn_dst": k.seg_dst.layout, "kcgn_src": k.seg_src.layout,
                    "kcgn_uu_labels": k.uu_labels.layout, "kcgn_ii_labels": k.ii_labels.layout,
                    "smin_edge_rows": m.edge_rows.layout, "smin_edge_cols": m.edge_cols.layout},
            "graphs": {"kcgn_uu": k.uu_g, "kcgn_ii": k.ii_g, "kcgn_uu_comp": k.uu_sub_adj,
                       "kcgn_ii_comp": k.ii_sub_adj, "smin_dgi": m.dgi_graph,
                       "smin_sub": m.sub_adj,
                       **{f"smin_{p.lower()}": g for p, g in zip(
                           (*m.cfg.model.user_graph_indx.split("_"),
                            *m.cfg.model.item_graph_indx.split("_")),
                           (*m.user_paths, *m.item_paths))}}}


# (key, operand, width, layout) of each KCGN/SMIN shape timed in phase 21;
# a segment layout's "take_bwd" is its gather's backward, a B1 sum like "sum"
KCGN_SMIN_SHAPES = (
    ("kcgn_dst_sum_d64", "kcgn_dst", 64, "seg"), ("kcgn_src_take_bwd_d64", "kcgn_src", 64, "seg"),
    ("kcgn_uu_hop_d128", "kcgn_uu", 128, "fwd"), ("kcgn_ii_hop_d128", "kcgn_ii", 128, "fwd"),
    ("kcgn_ii_hop_t_d128", "kcgn_ii", 128, "bwd"),
    ("kcgn_uu_comp_sum_d128", "kcgn_uu_comp", 128, "fwd"),
    ("kcgn_ii_comp_sum_d128", "kcgn_ii_comp", 128, "fwd"),
    ("kcgn_uu_label_take_bwd_d128", "kcgn_uu_labels", 128, "seg"),
    ("kcgn_ii_label_take_bwd_d128", "kcgn_ii_labels", 128, "seg"),
    ("smin_uu_hop_d64", "smin_uu", 64, "fwd"), ("smin_uiu_hop_d64", "smin_uiu", 64, "fwd"),
    ("smin_uitiu_hop_d64", "smin_uitiu", 64, "fwd"), ("smin_iui_hop_d64", "smin_iui", 64, "fwd"),
    ("smin_iti_hop_d64", "smin_iti", 64, "fwd"), ("smin_iti_hop_t_d64", "smin_iti", 64, "bwd"),
    ("smin_dgi_hop_d192", "smin_dgi", 192, "fwd"), ("smin_sub_hop_d192", "smin_sub", 192, "fwd"),
    ("smin_edge_take_bwd_d192", "smin_edge_rows", 192, "seg"))


def shape_layout(ops: dict, op: str, layout: str) -> sk.CsrLayout:
    if layout == "seg":
        return ops["seg"][op].csr
    return getattr(ops["graphs"][op], layout)


def time_layouts(ops: dict, shapes, gen) -> tuple[dict, dict]:
    """Device times (and with L2 flushed, ``cold_ms``) of B1 at ``shapes``,
    each beside its plain version and ``torch.sparse.mm``, the schedule the
    host picks, and its bound."""
    t, bounds = {}, {}
    for key, op, d, layout in shapes:
        lay = shape_layout(ops, op, layout)
        x = torch.randn(lay.n_cols, d, generator=gen, device=lay.vals.device)
        csr = csr_tensor(lay)
        bounds[key] = bound_ms(lay, d)
        t[key] = timing(lambda: sk.csr_spmm(lay, x), lambda: sk.csr_spmm_plain(lay, x),
                        lambda: torch.sparse.mm(csr, x), bounds[key][0])
        t[key]["cold_ms"] = cold_ms(lambda: sk.csr_spmm(lay, x), bounds[key][0])
        group, thresh = schedule(lay, d)
        plan = sk.layout_plan(lay, thresh)
        t[key].update(lane_group=group, split_threshold=thresh, chunks=plan.n_chunks,
                      split_rows=plan.split_rows.numel())
    return t, bounds


def kg_full_operands(gi, gr) -> dict:
    """The segment layouts of the trained KGIN ``gi`` and KGRec ``gr`` over
    the uncapped triplets and the interact edges."""
    return {"graphs": {},
            "seg": {"kg_full_heads": gr.seg_h.layout, "kg_full_tails": gr.seg_t.layout,
                    "kg_full_rels": gr.rel_take.layout, "kgin_im_users": gi.seg_iu.layout,
                    "kgin_im_ents": gi.seg_ic.layout, "kgrec_ie_users": gr.seg_ieu.layout,
                    "kgrec_ie_items": gr.seg_iei.layout, "kgrec_ie_ents": gr.seg_ie_ent.layout}}


# (key, operand, width, layout) of each KGIN/KGRec B1 shape timed in phase 22
KG_SHAPES = (
    ("kg_full_heads_sum_d64", "kg_full_heads", 64, "seg"),
    ("kg_full_heads_attn_d33", "kg_full_heads", 33, "seg"),
    ("kg_full_heads_count_d1", "kg_full_heads", 1, "seg"),
    ("kg_full_tails_take_bwd_d64", "kg_full_tails", 64, "seg"),
    ("kg_full_rel_take_bwd_d64", "kg_full_rels", 64, "seg"),
    ("kgin_im_user_sum_d64", "kgin_im_users", 64, "seg"),
    ("kgin_im_ent_take_bwd_d64", "kgin_im_ents", 64, "seg"),
    ("kgrec_ie_item_sum_d64", "kgrec_ie_items", 64, "seg"))


def kcgn_smin_phases(errs: ErrTrack, gen, refs: dict | None = None) -> dict:
    """Phases 19-21: KCGN and SMIN driven through the CLI on yelp_sub (their
    runs' references for phase 37(g) into ``refs``), then B1 held and timed
    at the trained models' shapes."""
    log("== 19. KCGN and SMIN paths (yelp_sub)")
    trained = {}
    runs = ssl_paths(errs, dataset=SOCIAL_DATASET, models=KCGN_SMIN, keep=trained, refs=refs)
    km, sm = trained["kcgn"], trained["smin"]
    ks = kcgn_smin_operands(km, sm)
    shapes = {k: (g.n_rows, g.n_cols, g.nnz) for k, g in ks["graphs"].items()}
    shapes.update({k: (lay.num_segments, lay.n, lay.n) for k, lay in ks["seg"].items()})
    log(f"  KCGN expanded graph {km.n_nodes} nodes, {km.seg_dst.layout.n} edges, "
        f"{km.r_class} rating class(es), {km.max_time} time ids; uu / ii DGI graphs "
        f"{km.uu_g.nnz} / {km.ii_g.nnz} edges, {km.uu_sub_adj.n_rows} / "
        f"{km.ii_sub_adj.n_rows} components; SMIN metapaths "
        + ", ".join(f"{k[5:].upper()} {v[2]}" for k, v in shapes.items()
                    if k.startswith("smin_") and k[5:] in ("uu", "uiu", "uitiu", "iui", "iti"))
        + f"; one-hop graph {sm.dgi_graph.nnz} edges, 2-hop subgraph {sm.sub_adj.nnz}")

    log("== 20. B1 against plain, the trained KCGN's and SMIN's shapes")
    ks_errs = ErrTrack()
    for k, lay in ks["seg"].items():
        d_k = 192 if k.startswith("smin") else (64 if k in ("kcgn_dst", "kcgn_src") else 128)
        check_segment_b1(ks_errs, k, lay, (d_k,), gen, ref64=k == "kcgn_ii_labels")
    for k, g in ks["graphs"].items():
        d_k = 64 if k.startswith("smin") and k not in ("smin_dgi", "smin_sub") else (
            192 if k.startswith("smin") else 128)
        check_graph(ks_errs, k, g, (d_k,), gen, with_grads=True, ref64=k == "kcgn_ii_comp")
    log(f"max abs err {ks_errs.abs:.3g}, max rel err {ks_errs.rel:.3g} (tolerance {TOL}; the "
        f"single {km.ii_sub_adj.nnz}-edge row of the ii component sum and its label layout "
        f"against the plain version in float64)")

    log("== 21. KCGN's and SMIN's shapes timing")
    t, bound = time_layouts(ks, KCGN_SMIN_SHAPES, gen)
    for k, r in t.items():
        log_timing(k, r, bound[k])
    return {"runs": runs, "errs": ks_errs, "t": t, "bound": bound, "shapes": shapes}


def check_b2(what: str, lay: skn.SegmentLayout, gen, valid=None) -> None:
    """B2 equal to its plain version over ``lay``: random logits, the logits
    at -1e9 where ``valid`` is 0 (else on a random half), all at -1e9."""
    dev = lay.ids.device
    logits = torch.randn(lay.n, generator=gen, device=dev) * 5
    keep = (torch.rand(lay.n, generator=gen, device=dev) < 0.5) if valid is None else valid > 0
    for tag, data in (("logits", logits), ("masked", torch.where(keep, logits, -1e9)),
                      ("all_masked", torch.full((lay.n,), -1e9, device=dev))):
        check_exact(f"segmax.{what}.{tag}", skn.segment_max(lay, data),
                    skn.segment_max_plain(lay, data))


def kg_phases(errs: ErrTrack, gen, dev) -> dict:
    """Phase 22: KGIN and KGRec driven through the CLI on the synthetic KG
    (written by phase 6), then B2 held exactly and B1 within the tolerance
    at the trained models' shapes over the uncapped triplets, both timed."""
    log("== 22. KGIN and KGRec: the paths, then B1 and B2 at the uncapped triplets' shapes")
    trained = {}
    runs = ssl_paths(errs, data_dir=SMOKE_RESULTS, dataset=KG_DATASET, models=KG_MODELS,
                     keep=trained)
    kgf = kg_full_operands(trained["kgin"], trained["kgrec"])
    heads = kgf["seg"]["kg_full_heads"]
    shapes = {k: (lay.num_segments, lay.n, lay.n) for k, lay in kgf["seg"].items()}
    heads_shape = b2_shape(heads)
    log(f"  {heads.n} uncapped triplets into {heads.num_segments} heads (B2: {heads_shape}), "
        f"{trained['kgin'].im_vals.shape[0]} interact edges")
    kgf_errs = ErrTrack()
    check_b2("kgrec", heads, gen)
    log("  B2 at the uncapped heads: exact (logits, masked, all masked)")
    widths = {"kg_full_heads": (64, 33, 1)}
    for k, lay in kgf["seg"].items():
        check_segment_b1(kgf_errs, k, lay, widths.get(k, (64,)), gen)
    log(f"max abs err {kgf_errs.abs:.3g}, max rel err {kgf_errs.rel:.3g} (tolerance {TOL})")
    t, bound = time_layouts(kgf, KG_SHAPES, gen)
    t["b2_kgrec_heads"], bound["b2_kgrec_heads"] = time_b2(heads, gen)
    for k, r in t.items():
        log_timing(k, r, bound[k])
    return {"runs": runs, "errs": kgf_errs, "t": t, "bound": bound, "shapes": shapes,
            "heads_shape": heads_shape}


def resume_check(model: str, data_dir: str, dataset: str, extra=(), device: str = "cuda",
                 tag: str = "", half: int = 2) -> int:
    """``model`` ``2·half`` epochs straight against ``half`` and a resumed
    ``half`` through the CLI, a state saved every ``half`` epochs: the train
    states after the last epoch (every tensor: parameters, optimizer states,
    best snapshot, the model's own extra state) must be bit-equal, and the
    bookkeeping equal.  The resumed run starts from the state the straight
    run saved after epoch ``half - 1``, which a run of ``half`` epochs saves
    alike (a depth cut: one run fewer, ~15 s of MAERec's loads and graph
    build).  Returns the number of tensors held."""
    base = ["--model", model, "--data_dir", data_dir, "--dataset", dataset, "--device", device,
            "--set", "train.test_step=1", "--set", "train.early_stop=false",
            "--set", f"train.save_state_every={half}", "--set", "train.results_dir=", *extra]
    t0 = time.perf_counter()
    state_dir = os.path.join(ckpt.CHECKPOINT_DIR, model)
    before = set(os.listdir(state_dir)) if os.path.isdir(state_dir) else set()
    straight = port_main.main(base + ["--epoch", str(2 * half)])
    saved = sorted((os.path.join(state_dir, f) for f in os.listdir(state_dir)
                    if f.endswith(".ckpt.state") and f not in before), key=os.path.getmtime)
    first_state = saved[0]
    if ckpt.load(first_state, straight._state_template())["epoch"] != half - 1:
        raise AssertionError(f"resume.{model}: {first_state} is not the state after epoch "
                             f"{half - 1}")
    resumed = port_main.main(base + ["--epoch", str(2 * half), "--set",
                                     f"train.resume_path={first_state}"])
    template = straight._state_template()
    a = ckpt.load(straight.state_path, template)
    b = ckpt.load(resumed.state_path, template)

    def walk(x, y, where):
        if torch.is_tensor(x):
            check_exact(f"resume.{model}.{where}", y, x)
            return 1
        if isinstance(x, dict):
            return sum(walk(x[k], y[k], f"{where}.{k}") for k in x)
        if x != y:
            raise AssertionError(f"resume.{model}.{where}: {x} != {y}")
        return 0

    n = walk(a, b, "state")
    extra_state = a.get("extra", {})
    log(f"  {model} {tag}{2 * half} epochs against {half} + resumed {half} in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"the states after epoch {a['epoch']} equal bit for bit ({n} tensors), best_metric "
        f"{a['best_metric']:.5f}, wait {a['wait']}"
        + (f", extra state {sorted(extra_state)}" if extra_state else ""))
    return n


def tune_and_resume(device: str = "cuda", data_dir: str = DATA_DIR,
                    dataset: str = DATASET) -> dict:
    """On the card: a 2-trial LightGCN grid of 1 epoch each, which must write
    its tune artifact and no run artifact under a scratch results_dir; a
    LightGCN run of 4 epochs against 2 and a resumed 2 (:func:`resume_check`);
    and MAERec's, 2 against 1 and a resumed 1, on the depth-cut sports-shaped
    split (``SEQ_CUT_DATASET``) at batch 4096 (one mask step; its loss
    history rides in the train state)."""
    base = ["--model", "lightgcn", "--data_dir", data_dir, "--dataset", dataset,
            "--device", device, "--set", "train.test_step=1", "--set", "train.early_stop=false"]
    tune_dir = os.path.join(SMOKE_RESULTS, "tune")
    t0 = time.perf_counter()
    best = port_main.main(base + [
        "--epoch", "1", "--set", f"train.results_dir={tune_dir}", "--set", "tune.enable=true",
        "--set", "tune.hyperparameters=[reg_weight]", "--set", "tune.reg_weight=[1.0e-8, 1.0e-4]"])
    doc = json.load(open(os.path.join(tune_dir, f"lightgcn_{dataset}_tune.json")))
    if (sorted(os.listdir(tune_dir)) != [f"lightgcn_{dataset}_tune.json"]
            or len(doc["trials"]) != 2 or doc["best"]["score"] != best[0]):
        raise AssertionError(f"tune: {os.listdir(tune_dir)}, {doc}")
    log(f"  2-trial grid in {time.perf_counter() - t0:.1f} s: "
        f"{[(t['assignment'], round(t['score'], 5)) for t in doc['trials']]}, best {best}")
    n = resume_check("lightgcn", data_dir, dataset, device=device)
    n_maerec = resume_check("maerec", SMOKE_RESULTS, SEQ_CUT_DATASET, device=device,
                            extra=["--set", "train.batch_size=4096"], tag="(batch 4096) ",
                            half=1)
    return {"tune": doc, "resume_tensors": n, "maerec_resume_tensors": n_maerec}


def write_sports_split() -> dict:
    """The sports-shaped sequential split under SMOKE_RESULTS and its sizes,
    and its first ``SEQ_CUT_SHARE`` of users as ``SEQ_CUT_DATASET``."""
    t0 = time.perf_counter()
    seqs = sports_like_seqs()
    write_seq_dataset(SEQ_DATASET, seqs)
    write_seq_dataset(SEQ_CUT_DATASET, seqs[:round(len(seqs) * SEQ_CUT_SHARE)])
    lens = np.array([len(s) for s in seqs])
    split = {"users": len(seqs), "items": int(max(max(s) for s in seqs)),
             "interactions": int(lens.sum()), "mean_len": float(lens.mean()),
             "min_len": int(lens.min()), "max_len": int(lens.max()),
             "write_s": time.perf_counter() - t0}
    log(f"  wrote {SEQ_DATASET}: {split['users']} users, {split['items']} items, "
        f"{split['interactions']} interactions (length {split['min_len']}..{split['max_len']}, "
        f"mean {split['mean_len']:.2f}) in {split['write_s']:.1f} s")
    return split


def sports_like_seqs(n_users: int = 35_598, n_items: int = 18_357,
                     n_inter: int = 296_337, seed: int = 2020) -> list[list[int]]:
    """Item sequences shaped like Amazon Sports and Outdoors 5-core (S3-Rec's
    dataset table: 35,598 users, 18,357 items, 296,337 interactions): every
    user at least 5 items, lengths 5 plus a geometric tail (mean 8.32),
    items drawn from a Zipf-like popularity (exponent 0.8 over a random
    ranking of the ids), and with probability 0.4 the next item a near
    neighbour of the previous in that ranking, so that transitions repeat;
    every id 1..n_items occurs."""
    rng = np.random.default_rng(seed)
    extra = rng.geometric(1.0 / (1.0 + (n_inter / n_users - 5.0)), n_users) - 1
    lens = 5 + extra
    diff = n_inter - int(lens.sum())
    while diff:
        users = rng.choice(n_users, abs(diff), replace=True)
        step = 1 if diff > 0 else -1
        np.add.at(lens, users, step)
        lens = np.maximum(lens, 5)
        diff = n_inter - int(lens.sum())
    rank_to_id = rng.permutation(n_items) + 1
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    ranks = rng.choice(n_items, n_inter, p=pop / pop.sum())
    near = rng.random(n_inter) < 0.4
    hop = rng.integers(-20, 21, n_inter)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    first = np.zeros(n_inter, bool)
    first[starts] = True
    for i in np.flatnonzero(near & ~first):         # a walk in the popularity ranking
        ranks[i] = min(max(ranks[i - 1] + hop[i], 0), n_items - 1)
    items = rank_to_id[ranks]
    missing = np.setdiff1d(np.arange(1, n_items + 1), items)
    items[rng.choice(n_inter, missing.size, replace=False)] = missing
    return [items[s:s + n].tolist() for s, n in zip(starts, lens)]


def write_seq_dataset(name: str, seqs) -> str:
    """The handler's TSV split under SMOKE_RESULTS/sequential/<name>/: a
    user's train row is its sequence but the last two items with the second
    to last as target, its test row all but the last with the last as
    target."""
    d = os.path.join(SMOKE_RESULTS, "sequential", name)
    os.makedirs(d, exist_ok=True)
    for split, cut in (("train", 2), ("test", 1)):
        with open(os.path.join(d, f"{split}.tsv"), "w") as f:
            f.write("uid\tseq\tlast\n")
            f.writelines(f"{u}\t{' '.join(map(str, s[:-cut]))}\t{s[-cut]}\n"
                         for u, s in enumerate(seqs))
    return d


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def set_precision(bf16: bool) -> None:
    """B1's precision mode, as the variable the JAX package reads sets it."""
    if bf16:
        os.environ[PRECISION_VAR] = "default"
    else:
        os.environ.pop(PRECISION_VAR, None)
    sk.bf16_mode.cache_clear()
    if sk.bf16_mode() != bf16:
        raise AssertionError(f"bf16 mode {sk.bf16_mode()}, want {bf16}")


def bf16_cases(lgcn: sk.CsrGraph, seg_lay: skn.SegmentLayout, maerec, gen) -> dict:
    """(layout, x, multiplier) of each bf16 check: the LightGCN hop both
    ways with and without the dropout PRF, the KGCL segment sum at d 64, and
    MAERec's encoder hop both ways under a view's values."""
    dev = lgcn.vals.device
    prf = sk.prf_mask(torch.tensor([3, 4], device=dev), lgcn, 0.5)
    view = maerec.one_view(maerec.draws(gen))
    mg = maerec.graph

    def x(lay, d):
        return torch.randn(lay.n_cols, d, generator=gen, device=dev)

    return {"lightgcn_hop": (lgcn.fwd, x(lgcn.fwd, 32), None),
            "lightgcn_hop_t": (lgcn.bwd, x(lgcn.bwd, 32), None),
            "lightgcn_hop_prf": (lgcn.fwd, x(lgcn.fwd, 32), prf),
            "lightgcn_hop_prf_t": (lgcn.bwd, x(lgcn.bwd, 32), prf),
            "kgcl_segment_sum_d64": (seg_lay.csr, x(seg_lay.csr, 64), None),
            "maerec_hop_d64": (mg.fwd, x(mg.fwd, 64), view["enc_vals"]),
            "maerec_hop_t_d64": (mg.bwd, x(mg.bwd, 64), view["enc_vals"])}


# The bf16 mode's shapes timed in phase 26 (keys of bf16_cases), each beside
# the float32 mode, the cast of x alone and torch.sparse.mm in bfloat16
BF16_TIMED = ("lightgcn_hop", "lightgcn_hop_t", "kgcl_segment_sum_d64", "maerec_hop_d64",
              "maerec_hop_t_d64")
# The bf16 mode's bit-for-bit case: widths over the bf16 kernel's three row
# vectors (bf16 rows: 8 values a load; float32 rows: 4 and one)
BF16_TIE_WIDTHS = (64, 36, 65)
BF16_TIE_LONG = 300         # edges of each of its two long rows (split, combined)


def bf16_floats(mant: np.ndarray, exp: np.ndarray, sign: np.ndarray) -> np.ndarray:
    """Float32 values that are bf16 values: ``±(1 + mant/128)·2^exp`` for
    ``mant`` in [0, 128), ``exp`` in bf16's normal range."""
    return (np.where(sign, -1.0, 1.0) * (1 + mant / 128.0) * np.exp2(exp)).astype(np.float32)


def bf16_tie_case(dev, seed: int = 23):
    """A graph and x whose bf16-mode contributions hold exact halfway
    products (to be rounded to even), subnormal products (bf16's are below
    2^-126), products below 2^-134 that round to ±0, products that round to
    the largest bf16 value or overflow to inf, inf and NaN inputs, signed
    zeros and negative values, in rows whose float32 sums are exact in any
    order, so that the kernel must equal the plain version bit for bit.
    Each edge's value is a bf16 value and each row of x its own column.
    Single-edge rows, each in one regime: a product near 1 (x and the
    value within a few binades), a subnormal product, one under 2^-134, one
    near the top of the range, special inputs; and two rows of
    ``BF16_TIE_LONG`` edges (split into chunks, summed by the combine tree):
    one of subnormal products (multiples of 2^-133 summing under 2^-117),
    one of products in [1, 64) (multiples of 2^-7 summing under 2^15).
    Returns (layout, x [n, max width], counts of each kind of product)."""
    rng = np.random.default_rng(seed)
    d = max(BF16_TIE_WIDTHS)
    n_single = 2048
    regimes = rng.integers(0, 5, n_single)
    n_edges = n_single + 2 * BF16_TIE_LONG
    row_exp = np.zeros(n_edges, np.int64)       # each edge's x row exponent offset
    val_exp = np.zeros(n_edges, np.int64)
    # single-edge rows: (x exponent, value exponent) by regime
    lo_hi = {0: ((-3, 3), (-3, 3)),                # near 1: ties at every binade
             1: ((-70, -60), (-72, -62)),          # 2^-134 ... 2^-126: subnormal products
             2: ((-75, -70), (-70, -65)),          # under 2^-134 (and around it)
             3: ((60, 63), (63, 64)),              # 2^123 ... 2^128: bf16's top, inf
             4: ((-3, 3), (-3, 3))}                # special inputs, below
    for r, ((xl, xh), (vl, vh)) in lo_hi.items():
        at = np.flatnonzero(regimes == r)
        row_exp[at] = rng.integers(xl, xh + 1, at.size)
        val_exp[at] = rng.integers(vl, vh + 1, at.size)
    sub = slice(n_single, n_single + BF16_TIE_LONG)
    big = slice(n_single + BF16_TIE_LONG, n_edges)
    row_exp[sub], val_exp[sub] = rng.integers(-66, -63, BF16_TIE_LONG), -66
    row_exp[big], val_exp[big] = (rng.integers(0, 3, BF16_TIE_LONG),
                                  rng.integers(0, 2, BF16_TIE_LONG))
    x_exp = row_exp[:, None] + rng.integers(0, 2, (n_edges, d))
    x = bf16_floats(rng.integers(0, 128, (n_edges, d)), x_exp, rng.random((n_edges, d)) < 0.5)
    vals = bf16_floats(rng.integers(0, 128, n_edges), val_exp, rng.random(n_edges) < 0.5)
    special = np.flatnonzero(regimes == 4)
    kinds = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan])
    pick = rng.integers(0, 2 * kinds.size, (special.size, d))    # half keep their value
    block = x[special]
    block[pick < kinds.size] = kinds[pick[pick < kinds.size]]
    x[special] = block
    vals[special[: special.size // 4]] = -0.0
    rows = np.concatenate([np.arange(n_single), np.full(BF16_TIE_LONG, n_single),
                           np.full(BF16_TIE_LONG, n_single + 1)])
    g = sk.build_csr_graph(CooGraph(rows=torch.from_numpy(rows.astype(np.int32)),
                                    cols=torch.arange(n_edges, dtype=torch.int32),
                                    vals=torch.from_numpy(vals), n_rows=n_single + 2,
                                    n_cols=n_edges), dev)
    xt = torch.from_numpy(x)
    prod = xt * torch.from_numpy(vals)[:, None]     # bf16 values: exact where it matters
    bits = prod.view(torch.int32)
    finite = torch.isfinite(prod)
    rounded = prod.to(torch.bfloat16).float()
    counts = {"products": int(prod.numel()),
              "ties": int((finite & ((bits & 0xFFFF) == 0x8000)).sum()),
              "subnormal": int(((rounded != 0) & (rounded.abs() < 2.0**-126)).sum()),
              "to_zero": int(((prod != 0) & (rounded == 0)).sum()),
              "to_inf": int((finite & torch.isinf(rounded)).sum()),
              "nan": int(torch.isnan(prod).sum()), "signed_zero": int((prod == 0).sum())}
    return g.fwd, xt.to(dev), counts


def equal_bits(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """``got`` and ``ref`` equal bit for bit, zeros' signs included, and NaN
    where the other is NaN (whatever the NaN's bits)."""
    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        torch.where(nan, 0.0, got).view(torch.int32), torch.where(nan, 0.0, ref).view(torch.int32)))


def layout_on(lay: sk.CsrLayout, device) -> sk.CsrLayout:
    """``lay``'s arrays on ``device``, with a plan cache of its own."""
    return lay._replace(**{f: getattr(lay, f).to(device) for f in
                           ("indptr", "rows", "cols", "vals", "edge_ids")},
                        plans=sk.PlanCache())


def bf16_tie_check(dev) -> dict:
    """The bf16 mode's kernel equal to its plain version bit for bit at
    :func:`bf16_tie_case`, at each of ``BF16_TIE_WIDTHS``, on float32 rows
    rounded on load and, where ``d % 8 == 0``, on bf16 rows cast before the
    kernel, twice.  The plain
    version runs on the CPU: on the card its ``index_add_`` adds with float
    atomics, which flush subnormal values to zero (PTX's ``atom.add.f32``),
    where IEEE arithmetic, the CPU's and the kernel's, keeps them (the
    card's plain version differs from both at the case's subnormal
    products; that count is returned as ``card_plain_flushed``)."""
    lay, x, counts = bf16_tie_case(dev)
    if min(counts.values()) == 0:
        raise AssertionError(f"bf16 tie case: a kind of product is missing: {counts}")
    cpu_lay = layout_on(lay, "cpu")
    flushed = 0
    for d in BF16_TIE_WIDTHS:
        xd = x[:, :d].contiguous()
        want = sk.csr_spmm_plain(cpu_lay, xd.cpu())
        for cast in (True, False) if d % 8 == 0 else (False,):
            group = sk.lane_group(d, sk.mean_degree(lay))
            plan = sk.layout_plan(lay, sk.split_threshold(
                lay.cols.shape[0], group, sk.resident_threads(0), 2 if cast else 4))
            got = sk.csr_spmm_at(lay, xd, None, group, plan, cast)
            again = sk.csr_spmm_at(lay, xd, None, group, plan, cast)
            if not equal_bits(got.cpu(), want) or not equal_bits(again, got):
                bad = int((got.cpu().view(torch.int32) != want.view(torch.int32)).sum())
                raise AssertionError(f"bf16 tie case d {d}, {'bf16' if cast else 'float32'} "
                                     f"rows: not equal bit for bit to the plain version "
                                     f"({bad} entries' bits differ)")
        card = sk.csr_spmm_plain(lay, xd).cpu()
        same = (card.view(torch.int32) == want.view(torch.int32)) | (
            torch.isnan(card) & torch.isnan(want))
        flushed = max(flushed, int((~same).sum()))
    log(f"  bf16 tie case: equal bit for bit to its plain version (on the CPU) at d "
        f"{list(BF16_TIE_WIDTHS)}, float32 rows (and bf16 rows at d % 8 == 0) ({counts}); "
        f"the card's plain "
        f"version differs at {flushed} entries (its atomics flush subnormals)")
    return {**counts, "card_plain_flushed": flushed}


def bf16_checks(cases: dict) -> dict:
    """The bf16 mode against its plain version (within 1e-5 relative) and
    against the float32 plain version: every output within the rounding
    bound ``BF16_ROUNDING`` of its contributions' magnitudes, and the error
    over the largest output recorded beside the JAX mode's 3.76e-3 (which is
    one input's reading, not a bound: the JAX mode's own formula reads
    3.2e-3 to 4.5e-3 at the LightGCN hop on seeded normals,
    ``tests/test_torch_spmm_bf16.py``); every call repeated bit for bit;
    the tie case bit for bit (:func:`bf16_tie_check`); then the float32 mode
    again, equal bit for bit to its output before the switch.  Returns the
    errors by case, and the tie case's counts under ``"tie_case"``."""
    f32 = {}
    for k, (lay, x, w) in cases.items():
        # every case's values and multiplier are non-negative
        mag = sk.csr_spmm_plain(lay, x.abs(), w)
        f32[k] = (sk.csr_spmm(lay, x, w), sk.csr_spmm_plain(lay, x, w), mag)
    set_precision(True)
    out = {}
    try:
        for k, (lay, x, w) in cases.items():
            got = sk.csr_spmm(lay, x, w)
            check_exact(f"bf16.{k}.repeat", sk.csr_spmm(lay, x, w), got)
            plain_bf16 = sk.csr_spmm_plain(lay, x, w)
            e_plain, e_f32 = rel_err(got, plain_bf16), rel_err(got, f32[k][1])
            mag = f32[k][2]
            share = float(((got - f32[k][1]).abs() / mag.clamp(min=1e-30)).max())
            within = bool(((got - f32[k][1]).abs()
                           <= BF16_ROUNDING * mag + 1e-7 * float(mag.max())).all())
            out[k] = {"max_abs_err": float((got - plain_bf16).abs().max()),
                      "max_rel_err": e_plain, "max_rel_err_vs_f32": e_f32,
                      "max_err_share_of_magnitude": share,
                      "within_jax_reading_3_8e-3": e_f32 <= BF16_VS_F32}
            if e_plain > TOL or not within or not e_f32 > 0:
                raise AssertionError(f"bf16 {k}: rel err {e_plain:.3g} against the bf16 plain "
                                     f"version (<= {TOL}); against float32 {e_f32:.3g} of the "
                                     f"largest output, {share:.3g} of an output's magnitude "
                                     f"(<= {BF16_ROUNDING:.4g})")
            log(f"  bf16 {k}: rel err {e_plain:.3g} against its plain version; against the "
                f"float32 plain version {e_f32:.3g} of the largest output (the JAX mode's "
                f"reading: 3.76e-3), at most {share:.3g} of an output's magnitude (bound "
                f"{BF16_ROUNDING:.4g})")
        ties = bf16_tie_check(next(iter(cases.values()))[1].device)
    finally:
        set_precision(False)
    for k, (lay, x, w) in cases.items():
        check_exact(f"f32.{k}.after_bf16", sk.csr_spmm(lay, x, w), f32[k][0])
    log("  float32 mode after the switch back: every case equal bit for bit to its output "
        "before it")
    return out, ties


def bf16_lightgcn_path(want: tuple[int, int]) -> dict:
    """LightGCN 2 epochs through the CLI with B1 in bf16 mode, the counts
    reset around it: finite losses, and B1's launches (and the split rows'
    combines) equal to the float32 run's ``want``, since the mode changes no
    call."""
    argv = ["--model", "lightgcn", "--data_dir", DATA_DIR, "--dataset", DATASET,
            "--epoch", "2", "--device", "cuda", "--set", "train.test_step=1",
            "--set", f"train.results_dir={os.path.join(SMOKE_RESULTS, 'bf16')}"]
    set_precision(True)
    try:
        sk.csr_spmm.launches = sk.csr_spmm.combine_launches = skn.segment_max.launches = 0
        trainer = port_main.main(argv)
        got = (sk.csr_spmm.launches, sk.csr_spmm.combine_launches)
    finally:
        set_precision(False)
    rows = trainer.recorder.epochs
    losses = [r["loss"]["loss"] for r in rows]
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses) or got != want:
        raise AssertionError(f"bf16 LightGCN: losses {losses}, launches {got}, want {want}")
    r20 = [r["valid"]["recall"][1] for r in rows]
    log(f"  bf16 LightGCN: losses {[round(v, 6) for v in losses]}, valid recall@20 "
        f"{[round(v, 5) for v in r20]}, B1 launches {got[0]} ({got[1]} with the combine), "
        f"as the float32 run")
    return {"launches": got[0], "combine_launches": got[1], "losses": losses,
            "valid_recall20": r20, "train_s": [r["train_s"] for r in rows]}


def time_b1(lay: sk.CsrLayout, x: torch.Tensor, w, gather: bool = True,
            **extra) -> tuple[dict, tuple[float, str]]:
    """B1 at ``lay`` (multiplier ``w``: None or a [nnz] tensor) beside its
    plain version and ``torch.sparse.mm`` on the values pre-multiplied, its
    time with L2 flushed, ``extra`` callables' device times, and its bound
    (the floor: the bound without the multiplier, which the library call
    does not read).  Under a multiplier, with ``gather``, also
    ``library_gather_ms``: the library call with ``vals * w[edge_ids]``
    formed inside it, as a caller of ``torch.sparse.mm`` whose weight
    changes every call must form it."""
    d = x.shape[1]
    bound = bound_ms(lay, d, "none" if w is None else "mask")
    floor = bound_ms(lay, d)[0]
    vals = lay.vals if w is None else lay.vals * w[lay.edge_ids.long()]
    csr = csr_tensor(lay, vals)
    if w is not None and gather:
        extra = {**extra, "library_gather": library_gather(lay, x, w)}
    r = timing(lambda: sk.csr_spmm(lay, x, w), lambda: sk.csr_spmm_plain(lay, x, w),
               lambda: torch.sparse.mm(csr, x), floor, **extra)
    r["cold_ms"] = cold_ms(lambda: sk.csr_spmm(lay, x, w), floor)
    group, thresh = schedule(lay, d)
    r.update(lane_group=group, split_threshold=thresh,
             chunks=sk.layout_plan(lay, thresh).n_chunks)
    return r, bound


def library_gather(lay: sk.CsrLayout, x: torch.Tensor, w: torch.Tensor):
    """``torch.sparse.mm`` of ``lay`` under the multiplier ``w`` (in the
    original edge order) with the values ``vals * w[edge_ids]`` formed in the
    call; the ids' int64 copy is made once, outside it."""
    ids = lay.edge_ids.long()
    return lambda: torch.sparse.mm(csr_tensor(lay, lay.vals * w[ids]), x)


def bf16_library_ms(lay: sk.CsrLayout, x: torch.Tensor, w) -> dict:
    """The bf16 mode's library call: ``torch.sparse.mm`` on a bfloat16 CSR
    tensor of ``lay`` (values pre-multiplied by ``w``) and bfloat16 ``x``,
    its device time with x cast before it (``library_ms``) and with the cast
    of the float32 x inside the call (``library_cast_ms``), as the bf16
    mode's own time holds its cast; None and PyTorch's refusal or the
    profiler's failure under ``library_call`` where there is no reading."""
    vals = lay.vals if w is None else lay.vals * w[lay.edge_ids.long()]
    csr = torch.sparse_csr_tensor(lay.indptr, lay.cols, vals.to(torch.bfloat16),
                                  size=(lay.n_rows, lay.n_cols))
    xb = x.to(torch.bfloat16)
    none = {"library_ms": None, "library_cast_ms": None}
    try:
        torch.sparse.mm(csr, xb)
        torch.cuda.synchronize()
    except Exception as e:      # a yardstick only: PyTorch may not take bfloat16 CSR
        return {**none, "library_call": "torch.sparse.mm refuses a bfloat16 CSR tensor here: "
                                        + str(e).splitlines()[0][:200]}
    what = "torch.sparse.mm on a bfloat16 CSR tensor (values pre-multiplied) and bfloat16 x"
    try:
        return {"library_ms": device_ms(lambda: torch.sparse.mm(csr, xb)),
                "library_cast_ms": device_ms(lambda: torch.sparse.mm(csr, x.to(torch.bfloat16))),
                "library_call": what}
    except AssertionError as e:     # the profiler's windows did not agree: no reading
        return {**none, "library_call": f"{what}: not measured ({str(e)[:200]})"}


def bf16_timing(cases: dict, bf16_err: dict) -> tuple[dict, dict]:
    """Phase 26's bf16 rows: at each of ``BF16_TIMED`` (keys of
    :func:`bf16_cases`) the bf16 mode's device time (its cast of x, if any,
    included), its cold time and schedule, which rows it gathers, the cast
    of x alone, the float32 mode's time and ``torch.sparse.mm`` on a
    bfloat16 CSR tensor (:func:`bf16_library_ms`) and in float32; keyed
    ``bf16_<case>``, with the bounds."""
    t, bound = {}, {}
    for k in BF16_TIMED:
        lay, x, w = cases[k]
        floor = bound_ms(lay, x.shape[1])[0]
        f32_ms = device_ms(lambda: sk.csr_spmm(lay, x, w), floor)
        f32_cold = cold_ms(lambda: sk.csr_spmm(lay, x, w), floor)
        set_precision(True)
        try:
            key = f"bf16_{k}"
            # the call's own cast of x to bf16, timed alone beside it
            t[key], bound[key] = time_b1(lay, x, w, gather=False,
                                         cast=lambda: x.to(torch.bfloat16))
        finally:
            set_precision(False)
        t[key].update(f32_ms=f32_ms, f32_cold_ms=f32_cold, library_f32_ms=t[key]["library_ms"],
                      bf16_rows=sk.bf16_rows(lay, x.shape[1]), **bf16_library_ms(lay, x, w),
                      **bf16_err[k])
        log_timing(key, t[key], bound[key])
        lib = t[key]["library_cast_ms"]
        log(f"    float32 mode: {f32_ms * 1e3:.2f} us device, {f32_cold * 1e3:.2f} cold; bf16 "
            f"mode {t[key]['cold_ms'] * 1e3:.2f} cold, on "
            f"{'bf16 rows' if t[key]['bf16_rows'] else 'float32 rows rounded on load'}, lane "
            f"group {t[key]['lane_group']}, T {t[key]['split_threshold']}; the cast of x alone "
            f"{t[key]['cast_ms'] * 1e3:.2f}; library: {t[key]['library_call']}, with the cast "
            f"in the call {'n/a' if lib is None else f'{lib * 1e3:.2f}'}; in float32 "
            f"{t[key]['library_f32_ms'] * 1e3:.2f}")
    return t, bound


def seq_operands(dm, mm, gen) -> dict:
    """(layout, x, multiplier) of each timed sequential shape, from the
    trained DCRec_seq ``dm`` and MAERec ``mm``: the GCN hops both ways under
    a view's values and the degree sums (d 1); MAERec's encoder hop both
    ways under a mask-bank view and the closure spread (d 1, no values)."""
    dev = mm.item_emb.device
    n = dm.n_items1

    def x(lay, d):
        return torch.randn(lay.n_cols, d, generator=gen, device=dev)

    we_adj = torch.rand(dm.adj.nnz, generator=gen, device=dev)
    we_sim = torch.rand(dm.sim.nnz, generator=gen, device=dev)
    view = mm.one_view(mm.draws(gen))
    closure = (torch.rand(mm.n_items1, 1, generator=gen, device=dev) < 0.01).float()
    return {
        "dcrec_seq_adj_hop_d64": (dm.adj.g.fwd, x(dm.adj.g.fwd, 64), we_adj),
        "dcrec_seq_adj_hop_t_d64": (dm.adj.g.bwd, x(dm.adj.g.bwd, 64), we_adj),
        "dcrec_seq_sim_hop_d64": (dm.sim.g.fwd, x(dm.sim.g.fwd, 64), we_sim),
        "dcrec_seq_sim_hop_t_d64": (dm.sim.g.bwd, x(dm.sim.g.bwd, 64), we_sim),
        "dcrec_seq_deg_d1": (dm.adj.g.fwd, torch.ones(n, 1, device=dev), we_adj),
        "dcrec_seq_deg_t_d1": (dm.adj.g.bwd, torch.ones(n, 1, device=dev), we_adj),
        "maerec_hop_d64": (mm.graph.fwd, x(mm.graph.fwd, 64), view["enc_vals"]),
        "maerec_hop_t_d64": (mm.graph.bwd, x(mm.graph.bwd, 64), view["enc_vals"]),
        "maerec_spread_d1": (mm.graph.fwd, closure, None)}


def seq_phases(errs: ErrTrack, gen, lgcn: sk.CsrGraph, seg_lay: skn.SegmentLayout,
               lgcn_counts: tuple[int, int], split: dict) -> dict:
    """Phases 23-26: the sequential family on the sports-shaped split (written
    in phase 18), B1 at DCRec_seq's and MAERec's layouts, B1's bf16 mode,
    and their timing."""
    log("== 23. the sequential paths (a synthetic sports-shaped split)")
    trained = {}
    t0 = time.perf_counter()
    runs = ssl_paths(errs, data_dir=SMOKE_RESULTS, dataset=SEQ_DATASET, models=SEQ_MODELS,
                     keep=trained, epochs=SEQ_EPOCHS, extra_args=SEQ_BATCH_ARGS)
    dm, mm = trained["dcrec_seq"], trained["maerec"]
    sizes = {"train_rows": {k: r["train_rows"] for k, r in runs.items()},
             "dcrec_seq": {"adj": dm.adj.nnz, "sim": dm.sim.nnz, "adj_test": dm.adj_test.nnz,
                           "sim_test": dm.sim_test.nnz},
             "maerec": {"ii": mm.nnz}, "paths_s": time.perf_counter() - t0}
    log(f"  train rows {sizes['train_rows']}; DCRec_seq graph nnz {sizes['dcrec_seq']}; "
        f"MAERec distance-3 graph nnz {mm.nnz}; {sizes['paths_s']:.1f} s")

    log("== 24. B1 against plain, DCRec_seq's and MAERec's layouts")
    t0 = time.perf_counter()
    seq_errs = ErrTrack()
    for k, g in (("dcrec_seq_adj", dm.adj.g), ("dcrec_seq_sim", dm.sim.g),
                 ("dcrec_seq_adj_test", dm.adj_test.g), ("maerec_ii", mm.graph)):
        check_graph(seq_errs, k, g, (64, 1), gen, with_grads=True)
    log(f"max abs err {seq_errs.abs:.3g}, max rel err {seq_errs.rel:.3g} (tolerance {TOL}); "
        f"{time.perf_counter() - t0:.1f} s")

    log("== 25. B1's bf16 mode (SSLREC_PALLAS_PRECISION=default)")
    t0 = time.perf_counter()
    cases = bf16_cases(lgcn, seg_lay, mm, gen)
    bf16_err, bf16_ties = bf16_checks(cases)
    bf16_path = bf16_lightgcn_path(lgcn_counts)
    log(f"  {time.perf_counter() - t0:.1f} s")

    log("== 26. the sequential shapes and the bf16 mode timing")
    t0 = time.perf_counter()
    t, bound = {}, {}
    ops = seq_operands(dm, mm, gen)
    for k, (lay, x, w) in ops.items():
        t[k], bound[k] = time_b1(lay, x, w)
        log_timing(k, t[k], bound[k])
    bt, bb = bf16_timing(cases, bf16_err)
    t.update(bt)
    bound.update(bb)
    log(f"  {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "errs": seq_errs, "t": t, "bound": bound, "split": split,
            "sizes": sizes, "bf16_err": bf16_err, "bf16_ties": bf16_ties,
            "bf16_path": bf16_path,
            "shapes": {k: (lay.n_rows, lay.n_cols, lay.cols.shape[0], x.shape[1])
                       for k, (lay, x, _) in {**ops, **cases}.items()}}


# (key, operand, width, layout) of each DiffKG B1 shape timed in phase 31
DIFFKG_SHAPES = (
    ("diffkg_dkg_heads_sum_d64", "dkg_heads", 64, "seg"),
    ("diffkg_dkg_heads_softmax_sum_d1", "dkg_heads", 1, "seg"),
    ("diffkg_dkg_tails_take_bwd_d64", "dkg_tails", 64, "seg"),
    ("diffkg_dkg_rels_take_bwd_d64", "dkg_rels", 64, "seg"),
    ("diffkg_kg_heads_sum_d64", "kg_heads", 64, "seg"),
    ("diffkg_kg_tails_take_bwd_d64", "kg_tails", 64, "seg"),
    ("diffkg_ukgc_hop_t_d64", "ui_rect", 64, "bwd"))


def kg_new_phases(errs: ErrTrack, gen, dev) -> dict:
    """Phases 27-28: DiffKG and KGCL with its TransE sub-loop driven through
    the CLI on the synthetic KG (written by phase 6), then B2 held exactly
    and B1 within the tolerance at the trained DiffKG's shapes, its denoised
    KG's layouts (built on the card each epoch) against the host builds."""
    log("== 27. DiffKG and KGCL with train_trans (the synthetic KG)")
    trained = {}
    runs = ssl_paths(errs, data_dir=SMOKE_RESULTS, dataset=KG_DATASET, models=KG_NEW,
                     keep=trained, extra_args=KG_NEW_ARGS, ref64=KG_NEW)
    runs["kgcl_train_trans"] = runs.pop("kgcl")     # apart from phase 8's KGCL run
    kg_losses = [r["kg_loss"] for r in runs["kgcl_train_trans"]["losses"]]
    if len(kg_losses) != PATH_EPOCHS or not all(math.isfinite(v) for v in kg_losses):
        raise AssertionError(f"KGCL's TransE losses {kg_losses}")
    dm = trained["diffkg"]
    dkg = dm._last_dkg
    valid = float(dkg.valid.mean())
    kg_bsz = int(trained["kgcl"].cfg.train.get("kg_batch_size", 4096))
    log(f"  KGCL's TransE sub-loop: kg_loss {[round(v, 5) for v in kg_losses]} over "
        f"{max(dm._map_r.numel() // kg_bsz, 1)} steps of {kg_bsz} an epoch; "
        f"DiffKG's denoised KG {dkg.h.n} edges into {dkg.h.num_segments} heads ({valid:.3f} "
        f"valid; B2: {b2_shape(dkg.h)}), the capped KG {dm.kg.h.n} edges, "
        f"denoiser loss {dm.diff_loss:.5f}")

    log("== 28. B2 and B1 against plain, DiffKG's shapes")
    t0 = time.perf_counter()
    n_lay = check_layout_builds("diffkg", {}, {"dkg_heads": dkg.h, "dkg_tails": dkg.t,
                                               "dkg_rels": dkg.r}, widths=(64, 1))
    check_b2("diffkg_dkg_heads", dkg.h, gen, dkg.valid)
    check_b2("diffkg_kg_heads", dm.kg.h, gen)
    log(f"  {n_lay} denoised-KG layouts built on the card equal the host builds; B2 exact at "
        f"the denoised and the capped heads (logits, invalid edges at -1e9, all at -1e9)")
    kg_errs = ErrTrack()
    ops = {"graphs": {"ui_rect": dm.ui},
           "seg": {"dkg_heads": dkg.h, "dkg_tails": dkg.t, "dkg_rels": dkg.r,
                   "kg_heads": dm.kg.h, "kg_tails": dm.kg.t, "kg_rels": dm.kg.r}}
    for k, lay in ops["seg"].items():
        check_segment_b1(kg_errs, f"diffkg_{k}", lay, (64, 1) if k.endswith("heads") else (64,),
                         gen)
    check_graph(kg_errs, "diffkg_ui_rect", dm.ui, (64,), gen, with_grads=True)
    bi = dm.bi.graph
    x = torch.randn(bi.n_cols, 64, generator=gen, device=dev)
    w_out = torch.randn(bi.n_rows, 64, generator=gen, device=dev)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    yk = sk.SpmmPvFn.apply(bi, xk, dm.adj_vals)
    (yk * w_out).sum().backward()
    yp = sk.csr_spmm_plain(bi.fwd, xp, dm.adj_vals)
    (yp * w_out).sum().backward()
    kg_errs.check("diffkg_ui_hop", yk.detach(), yp.detach())
    kg_errs.check("diffkg_ui_hop.dx", xk.grad, xp.grad)
    log(f"max abs err {kg_errs.abs:.3g}, max rel err {kg_errs.rel:.3g} (tolerance {TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "errs": kg_errs, "ops": ops, "model": dm,
            "shapes": {k: (lay.num_segments, lay.n, lay.n) for k, lay in ops["seg"].items()}
            | {"ui_rect": (dm.ui.n_rows, dm.ui.n_cols, dm.ui.nnz)}}


def tmall_like_split(shape=None, seed=2022):
    """Behavior matrices shaped like Tmall (``TMALL_SHAPE``): unique (user,
    item) pairs, users by a lognormal activity, items by a Zipf-like
    popularity (exponent 0.5 over a random ranking of the ids); fav and cart
    take 80% of their pairs from pv's, buy 70% from fav's and cart's and 20%
    from pv's, the rest fresh.  Each user with two or more buys has one held
    out (the test).  Returns ``({behavior: csr}, {meta path: csr}, test)``,
    the meta paths the intersections HMGCR reads."""
    rng = np.random.default_rng(seed)
    shape = shape or TMALL_SHAPE
    n_u, n_i, counts = shape["users"], shape["items"], shape["counts"]
    u_p = rng.lognormal(0.0, 1.0, n_u)
    u_p /= u_p.sum()
    i_p = 1.0 / np.arange(1, n_i + 1) ** 0.5
    i_p = (i_p / i_p.sum())[np.argsort(rng.permutation(n_i))]

    def fresh(n, taken):
        out = np.zeros(0, np.int64)
        while out.size < n:
            k = 2 * (n - out.size) + 1000
            c = rng.choice(n_u, k, p=u_p).astype(np.int64) * n_i + rng.choice(n_i, k, p=i_p)
            c = np.setdiff1d(np.unique(c), np.concatenate([taken, out]))
            out = np.concatenate([out, rng.permutation(c)[: n - out.size]])
        return out

    def nested(n, parents):
        picked = [rng.choice(p, min(int(share * n), p.size), replace=False)
                  for p, share in parents]
        base = np.unique(np.concatenate(picked))
        return np.unique(np.concatenate([base, fresh(n - base.size, base)]))

    codes = {"pv": fresh(counts["pv"], np.zeros(0, np.int64))}
    codes["fav"] = nested(counts["fav"], [(codes["pv"], 0.8)])
    codes["cart"] = nested(counts["cart"], [(codes["pv"], 0.8)])
    codes["buy"] = nested(counts["buy"], [(np.union1d(codes["fav"], codes["cart"]), 0.7),
                                          (codes["pv"], 0.2)])
    buy_u = codes["buy"] // n_i
    order = rng.permutation(codes["buy"].size)
    first = order[np.unique(buy_u[order], return_index=True)[1]]   # one random buy a user
    many = np.bincount(buy_u, minlength=n_u)[buy_u[first]] >= 2
    test = codes["buy"][first[many]]
    codes["buy"] = np.setdiff1d(codes["buy"], test)

    def mat(c):
        return sp.csr_matrix((np.ones(c.size, np.float32), (c // n_i, c % n_i)),
                             shape=(n_u, n_i))

    mats = {b: mat(c) for b, c in codes.items()}
    return mats, meta_path_mats(mats), mat(test)


def write_mb_dataset(name: str) -> dict:
    """The Tmall-shaped split in the handler's layout under
    ``SMOKE_RESULTS/multi_behavior/<name>/``; returns its sizes."""
    t0 = time.perf_counter()
    return write_mb_files(name, *tmall_like_split(), t0)


def read_mb_split(name: str) -> tuple[dict, sp.csr_matrix]:
    """The behavior matrices and the test matrix of a split that
    :func:`write_mb_files` wrote."""
    import pickle
    d = os.path.join(SMOKE_RESULTS, "multi_behavior", name)
    out = {}
    for key in ("pv", "fav", "cart", "buy", "test"):
        fname = "test_mat.pkl" if key == "test" else f"train_mat_{key}.pkl"
        with open(os.path.join(d, fname), "rb") as f:
            out[key] = sp.csr_matrix(pickle.load(f))
    return out, out.pop("test")


def meta_path_mats(mats: dict) -> dict:
    """HMGCR's meta paths of Tmall's behaviors: the intersections."""
    pv, fav, cart, buy = (mats[b] for b in ("pv", "fav", "cart", "buy"))
    return {"buy": buy, "pv_buy": pv.multiply(buy).tocsr(),
            "pv_fav_buy": pv.multiply(fav).multiply(buy).tocsr(),
            "pv_fav_cart_buy": pv.multiply(fav).multiply(cart).multiply(buy).tocsr()}


def write_mb_files(name: str, mats: dict, metas: dict, tst, t0: float,
                   root: str = SMOKE_RESULTS) -> dict:
    """``mats``, ``metas`` and the test matrix ``tst`` in the handler's layout
    under ``<root>/multi_behavior/<name>/``; returns their sizes."""
    import pickle
    d = os.path.join(root, "multi_behavior", name)
    os.makedirs(d, exist_ok=True)
    for key, m in (*mats.items(), *((k, m) for k, m in metas.items() if k != "buy"),
                   ("test", tst)):
        fname = "test_mat.pkl" if key == "test" else f"train_mat_{key}.pkl"
        with open(os.path.join(d, fname), "wb") as f:
            pickle.dump(m, f)
    sizes = {"users": tst.shape[0], "items": tst.shape[1],
             "nnz": {k: int(m.nnz) for k, m in mats.items()},
             "meta_nnz": {k: int(m.nnz) for k, m in metas.items()},
             "test": int(tst.nnz), "write_s": time.perf_counter() - t0}
    sizes["interactions"] = sum(sizes["nnz"].values()) + sizes["test"]
    log(f"  wrote {name}: {sizes['users']} users, {sizes['items']} items, "
        f"{sizes['interactions']} interactions ({sizes['nnz']}, {sizes['test']} held-out "
        f"buys); meta paths {sizes['meta_nnz']}; {sizes['write_s']:.1f} s")
    return sizes


def mb_phases(errs: ErrTrack, gen) -> dict:
    """Phases 29-30: the Tmall-shaped split, MBGMN, HMGCR and SMBRec driven
    through the CLI on it, then B1 held at the trained models' behavior and
    meta-path graphs, both directions, value and gradients."""
    log("== 29. the multi-behavior paths (a synthetic Tmall-shaped split)")
    sizes = write_mb_dataset(MB_DATASET)
    trained = {}
    runs = ssl_paths(errs, data_dir=SMOKE_RESULTS, dataset=MB_DATASET, models=MB_MODELS,
                     keep=trained)
    sm, hm = trained["smbrec"], trained["hmgcr"]
    sizes["co_user_nnz"] = int(sm.co_indices.numel())
    log(f"  SMBRec's co-user rows {sizes['co_user_nnz']} entries; train rows "
        f"{ {k: r['train_rows'] for k, r in runs.items()} }")

    log("== 30. B1 against plain, the behavior and meta-path graphs")
    t0 = time.perf_counter()
    mb_errs = ErrTrack()
    behaviors = ("pv", "fav", "cart", "buy")
    graphs = {**{f"{b}_{d}": g for b, pair in zip(behaviors, sm.graphs)
                 for d, g in zip(("a", "at"), pair)},
              **{f"meta_{m}_{d}": g for m, pair in zip(
                  ("buy", "pv_buy", "pv_fav_buy", "pv_fav_cart_buy"), hm.graphs)
                 for d, g in zip(("a", "at"), pair)}}
    for k, g in graphs.items():
        check_graph(mb_errs, k, g, (16,) if k.startswith("meta") else (32, 16), gen,
                    with_grads=True)
    log(f"max abs err {mb_errs.abs:.3g}, max rel err {mb_errs.rel:.3g} (tolerance {TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "errs": mb_errs, "sizes": sizes, "graphs": graphs}


# (key, operand, width, layout) of each multi-behavior B1 shape timed in phase 31
MB_SHAPES = (
    *((f"mb_{b}_{d}_d32", f"{b}_{d}", 32, "fwd") for b in ("pv", "fav", "cart", "buy")
      for d in ("a", "at")),
    ("mb_pv_a_d16", "pv_a", 16, "fwd"),
    *((f"hmgcr_{m}_{d}_d16", f"meta_{m}_{d}", 16, "fwd")
      for m in ("pv_buy", "pv_fav_buy", "pv_fav_cart_buy") for d in ("a", "at")))


def new_shapes_timing(kgn: dict, mbp: dict, gen) -> dict:
    """Phase 31: B1 at DiffKG's and the multi-behavior models' shapes, its UI
    hop under the all-ones view's values, and B2 at the denoised and the
    capped heads, each beside its bound, its plain version and the library
    call."""
    log("== 31. DiffKG's and the multi-behavior shapes timing")
    t0 = time.perf_counter()
    dm = kgn["model"]
    t, bound = time_layouts(kgn["ops"], DIFFKG_SHAPES, gen)
    bi = dm.bi.graph
    x = torch.randn(bi.n_cols, 64, generator=gen, device=bi.vals.device)
    t["diffkg_ui_hop_d64"], bound["diffkg_ui_hop_d64"] = time_b1(bi.fwd, x, dm.adj_vals)
    mb_t, mb_bound = time_layouts({"graphs": mbp["graphs"], "seg": {}}, MB_SHAPES, gen)
    t.update(mb_t)
    bound.update(mb_bound)
    for key, lay in (("b2_diffkg_dkg_heads", dm._last_dkg.h), ("b2_diffkg_kg_heads", dm.kg.h)):
        t[key], bound[key] = time_b2(lay, gen)
    for k, r in t.items():
        log_timing(k, r, bound[k])
    log(f"  {time.perf_counter() - t0:.1f} s")
    return {"t": t, "bound": bound}


def write_mb_extras(name: str, root: str = SMOKE_RESULTS) -> dict:
    """Beside phase 29's split (or another under ``root``): CML's meta users
    (a seeded permutation of the users with a buy and at least one other
    behavior; an assumption, the real file being absent) and the
    repository's real Tmall ``kg.txt``."""
    import pickle
    import shutil
    d = os.path.join(root, "multi_behavior", name)
    mats = {}
    for b in ("pv", "fav", "cart", "buy"):
        with open(os.path.join(d, f"train_mat_{b}.pkl"), "rb") as f:
            mats[b] = sp.csr_matrix(pickle.load(f))
    has = {b: np.diff(m.indptr) > 0 for b, m in mats.items()}
    meta = np.nonzero(has["buy"] & (has["pv"] | has["fav"] | has["cart"]))[0]
    meta = np.random.default_rng(2022).permutation(meta).astype(np.int64)
    with open(os.path.join(d, MB_META_FILE), "wb") as f:
        pickle.dump(meta.tolist(), f)
    shutil.copy(TMALL_KG, os.path.join(d, "kg.txt"))
    trip = np.loadtxt(TMALL_KG, dtype=np.int64, ndmin=2)
    per_item = np.bincount(trip[:, 0])
    out = {"meta_users": int(meta.size), "kg_triplets": int(trip.shape[0]),
           "kg_relations": np.bincount(trip[:, 1]).tolist(),
           "kg_max_id": int(trip[:, [0, 2]].max()), "kg_items": int((per_item > 0).sum()),
           "kg_max_per_item": int(per_item.max())}
    log(f"  {MB_META_FILE}: {out['meta_users']} users (buy and another behavior, seeded "
        f"permutation: an assumption); kg.txt (real, Tmall): {out['kg_triplets']} triplets, "
        f"relations {out['kg_relations']}, ids <= {out['kg_max_id']}, {out['kg_items']} items "
        f"with a triplet, at most {out['kg_max_per_item']} an item")
    return out


def check_weighted(errs: ErrTrack, name: str, g: sk.CsrGraph, w: torch.Tensor, d: int,
                   gen) -> None:
    """B1 against plain on both layouts of ``g`` under the constant multiplier
    ``w`` ([nnz], the original edge order): value, and dx through
    :class:`SpmmPvFn`."""
    dev = g.vals.device
    for direction, gd in (("fwd", g), ("bwd", g.t())):
        tag = f"{name}.{direction}.d{d}"
        x = torch.randn(gd.n_cols, d, generator=gen, device=dev)
        w_out = torch.randn(gd.n_rows, d, generator=gen, device=dev)
        got = sk.csr_spmm(gd.fwd, x, w)
        check_exact(f"{tag}.repeat", sk.csr_spmm(gd.fwd, x, w), got)
        errs.check(f"{tag}.plain", got, sk.csr_spmm_plain(gd.fwd, x, w))
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        (sk.SpmmPvFn.apply(gd, xk, w) * w_out).sum().backward()
        (sk.csr_spmm_plain(gd.fwd, xp, w) * w_out).sum().backward()
        errs.check(f"{tag}.dx", xk.grad, xp.grad)
    torch.cuda.synchronize()
    log(f"  {name}: {g.n_rows}x{g.n_cols}, nnz {g.nnz}, d {d}, under a view's values: ok")


def mb_new_phases(errs: ErrTrack, gen) -> dict:
    """Phases 32-33: CML and KMCLR driven through the CLI on phase 29's split,
    then B1 held at CML's behavior graphs and KMCLR's bi-adjacency under a
    view's values."""
    log("== 32. CML and KMCLR (the Tmall-shaped split, real Tmall kg.txt)")
    extras = write_mb_extras(MB_DATASET)
    trained = {}
    runs = ssl_paths(errs, data_dir=SMOKE_RESULTS, dataset=MB_DATASET, models=MB_NEW,
                     keep=trained)
    km = trained["kmclr"]
    extras.update(kmclr_kg={"entities": km.n_entities, "relations": km.n_relations,
                            "cap": km.kg_cap, "trans_batches": km.n_trans,
                            "contrast_steps": km.n_bpr},
                  kmclr_hook_s_last_epoch=dict(km.hook_s))
    log(f"  KMCLR: {km.n_entities} entities, {km.n_relations} relations, lists of "
        f"{km.kg_cap}; {km.n_trans} TransR/TATEC batches and {km.n_bpr} contrast steps an "
        f"epoch; the last epoch's hook (s): {km.hook_s}")

    log("== 33. B1 against plain, CML's behavior graphs and KMCLR's views")
    t0 = time.perf_counter()
    mb_errs = ErrTrack()
    graphs = {f"cml_{b}_{d}": g for b, pair in zip(("pv", "fav", "cart", "buy"),
                                                   trained["cml"].gcn.graphs)
              for d, g in zip(("a", "at"), pair)}
    for k, g in graphs.items():
        check_graph(mb_errs, k, g, (16,), gen, with_grads=True)
    with torch.no_grad():
        views = km.make_views(StepDraws(gen))
    graphs["kmclr_bi"] = km.bi.graph
    for v, w in enumerate(views):
        check_weighted(mb_errs, f"kmclr_bi_view{v}", km.bi.graph, w, 32, gen)
    check_weighted(mb_errs, "kmclr_bi_ones", km.bi.graph, km.ones_vals(), 32, gen)
    segs = {"kmclr_ent_lists": km.ent_lay, "kmclr_rel_lists": km.rel_lay}
    for k, lay in segs.items():     # the pad's row: 961,308 of the 999,424 slots
        check_segment_b1(mb_errs, k, lay, (32,), gen, ref64=True, ints=True)
    log(f"max abs err {mb_errs.abs:.3g}, max rel err {mb_errs.rel:.3g} (tolerance {TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "errs": mb_errs, "extras": extras, "graphs": graphs, "segs": segs,
            "view": views[0], "model": km}


# (key, operand, width, layout) of each CML B1 shape timed in phase 34
CML_SHAPES = tuple((f"cml_{b}_{d}_d16", f"cml_{b}_{d}", 16, "fwd")
                   for b in ("pv", "fav", "cart", "buy") for d in ("a", "at")
                   if (b, d) != ("pv", "a"))
# and KMCLR's per-item lists' gathers' backward (segment sums), d 32
KMCLR_SEG_SHAPES = (("kmclr_ent_lists_d32", "kmclr_ent_lists", 32, "seg"),
                    ("kmclr_rel_lists_d32", "kmclr_rel_lists", 32, "seg"))


def mb_new_timing(mbn: dict, gen) -> dict:
    """Phase 34: B1 at CML's behavior graphs (d 16; pv's A at d 16 is phase
    31's) and KMCLR's bi-adjacency under a view's values (d 32, both
    layouts), each beside its bound, its plain version and
    ``torch.sparse.mm``; KMCLR's epoch hook in its four parts."""
    log("== 34. CML's and KMCLR's shapes timing")
    t0 = time.perf_counter()
    t, bound = time_layouts({"graphs": mbn["graphs"], "seg": mbn["segs"]},
                            CML_SHAPES + KMCLR_SEG_SHAPES, gen)
    g, w = mbn["graphs"]["kmclr_bi"], mbn["view"]
    for key, lay in (("kmclr_bi_view_d32", g.fwd), ("kmclr_bi_view_t_d32", g.bwd)):
        x = torch.randn(lay.n_cols, 32, generator=gen, device=w.device)
        t[key], bound[key] = time_b1(lay, x, w)
    for k, r in t.items():
        log_timing(k, r, bound[k])
    km = mbn["model"]
    km.epoch_state(gen, 2)
    hook = dict(km.hook_s)
    log(f"  KMCLR's epoch hook, host clock (s, each part synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in hook.items())
        + f"; {sum(hook.values()):.3f} in all")
    log(f"  {time.perf_counter() - t0:.1f} s")
    return {"t": t, "bound": bound, "hook_s": hook}


def lanes_b1(name: str, groups, k: int, n_batches: int, epochs: int) -> tuple[int, int]:
    """B1 launches of a grid's lanes run and of its serial run, counted from
    the code (:data:`LANES_B1`): ``groups`` lists (layer_num, trials) per
    structural group; each group runs chunks of ``k`` lanes (the tail padded);
    with ``train.test_step=1`` and no early stop a chunk evaluates every lane
    each epoch and tests it once, a serial trial evaluates each epoch, its
    best valid and its test."""
    lanes = serial = 0
    for layers, n in groups:
        step, per_gen = LANES_B1[name](layers, k)
        lanes += -(-n // k) * (epochs * n_batches * step + per_gen * k * (epochs + 1))
        step1, _ = LANES_B1[name](layers, 1)
        serial += n * (epochs * n_batches * step1 + per_gen * (epochs + 2))
    return lanes, serial


def yaml_list(values) -> str:
    """A list for ``--set``, floats in YAML's float form (``1.0e-06``)."""
    return "[" + ", ".join(f"{v:.1e}" if isinstance(v, float) else str(v)
                           for v in values) + "]"


def run_grid(name: str, spec: dict, parallel: int, device: str = "cuda") -> dict:
    """``spec``'s grid of model ``name`` through the CLI, with ``tune.parallel``
    at ``parallel`` (0: the serial loop), the launch counts reset just before
    and read just after; its tune artifact (mode, no run artifact) and each
    trial's test score."""
    tune_dir = os.path.join(SMOKE_RESULTS, f"tune_{name}_{parallel}")
    grid = spec["grid"]
    argv = ["--model", name, "--data_dir", spec["data"][0], "--dataset", spec["data"][1],
            "--device", device, "--epoch", str(spec["epochs"]), "--set", "train.test_step=1",
            "--set", "train.early_stop=false", "--set", f"train.results_dir={tune_dir}",
            "--set", "tune.enable=true", "--set", f"tune.parallel={parallel}",
            "--set", f"tune.hyperparameters=[{', '.join(grid)}]",
            *(a for h, v in grid.items() for a in ("--set", f"tune.{h}={yaml_list(v)}"))]
    sk.csr_spmm.launches = sk.csr_spmm.combine_launches = skn.segment_max.launches = 0
    t0 = time.perf_counter()
    best = port_main.main(argv)
    wall = time.perf_counter() - t0
    b1, combine, b2 = (sk.csr_spmm.launches, sk.csr_spmm.combine_launches,
                       skn.segment_max.launches)
    art = f"{name}_{spec['data'][1]}_tune.json"
    doc = json.load(open(os.path.join(tune_dir, art)))
    mode = "vmapped" if parallel > 1 else "serial"
    if (sorted(os.listdir(tune_dir)) != [art] or doc["mode"] != mode
            or doc["best"]["score"] != best[0]):
        raise AssertionError(f"{name} tune ({mode}): {os.listdir(tune_dir)}, {doc}")
    return {"wall_s": wall, "launches": b1, "combine_launches": combine, "b2_launches": b2,
            "scores": {json.dumps(t["assignment"], sort_keys=True): t["score"]
                       for t in doc["trials"]}}


def lanes_phases(errs: ErrTrack, gen, data, n_batches: dict, dev) -> dict:
    """Phase 35: B1 under the lanes' vmap rule at the LightGCN hop (K lanes of
    d 32 folded into one call at d 32·K, no multiplier and the PRF mode; and
    DCCF's learned weight with lanes, a call a lane), value and gradients per
    lane against the plain version, one launch a hop where the weight has no
    lanes; the time of the 3-lane fold (d 96); then LightGCN's, DCCF's and
    KCGN's grids through the CLI with tune.parallel and serially
    (:func:`grids_both_ways`)."""
    log("== 35. the tune.parallel lanes: B1 under the vmap rule, three grids both ways")
    g = data.extras["bi_adj"]
    plain, _ = ssl_graphs(data, dev)
    lane_errs = ErrTrack()
    key = torch.tensor([12345, 678], device=dev)
    checked = []
    for k in LANE_KS:
        for mode, w in (("none", None), ("prf", sk.prf_mask(key, g, 0.5))):
            fold_check(lane_errs, f"lanes{k}.{mode}", g, w, 32, k, gen)
            checked.append((k, mode))
    k = 3
    x = torch.randn(k, plain.n_cols, 32, generator=gen, device=dev, requires_grad=True)
    ew = torch.rand(k, plain.nnz, generator=gen, device=dev, requires_grad=True)
    ct = torch.randn(k, plain.n_rows, 32, generator=gen, device=dev)
    before = sk.csr_spmm.launches
    y = torch.func.vmap(lambda xl, wl: sk_spmm(plain, xl, wl))(x, ew)
    dx, dew = torch.autograd.grad((y * ct).sum(), (x, ew))
    launched = sk.csr_spmm.launches - before
    if launched != 2 * k:
        raise AssertionError(f"lanes with a learned weight: {launched} launches, want {2 * k}")
    for i in range(k):
        xi = x[i].detach().clone().requires_grad_()
        wi = ew[i].detach().clone().requires_grad_()
        yi = sk.csr_spmm_plain(plain.fwd, xi, wi)
        dxi, dwi = torch.autograd.grad((yi * ct[i]).sum(), (xi, wi))
        lane_errs.check(f"dccf_lanes.lane{i}", y[i].detach(), yi.detach())
        lane_errs.check(f"dccf_lanes.lane{i}.dx", dx[i], dxi)
        lane_errs.check(f"dccf_lanes.lane{i}.dew", dew[i], dwi)
    del x, ew, ct, y, dx, dew
    log(f"B1 under the lanes' vmap rule at the LightGCN hop ({g.n_rows} nodes, {g.nnz} "
        f"edges), K in {LANE_KS} lanes of d 32, no multiplier and PRF: one launch for the "
        f"hop and one for its dx each; DCCF's learned weight with 3 lanes: a launch a lane; "
        f"value and gradients per lane: max abs err {lane_errs.abs:.3g}, max rel err "
        f"{lane_errs.rel:.3g} (tolerance {TOL})")

    lay = g.fwd
    x96 = torch.randn(g.n_cols, 96, generator=gen, device=dev)
    x32 = torch.randn(g.n_cols, 32, generator=gen, device=dev)
    t96, bound96 = time_b1(lay, x96, None,
                           three_d32=lambda: [sk.csr_spmm(lay, x32) for _ in range(3)])
    log_timing("LightGCN hop, 3-lane fold d 96", t96, bound96)
    del x96, x32

    grids = grids_both_ways(LANE_GRIDS, n_batches)
    return {"errs": lane_errs, "checked": checked, "t96": t96, "bound96": bound96,
            "grids": grids}


def lane_is_its_trial(a: str, lanes: dict, serial: dict) -> bool:
    """Trial ``a``'s lanes score is nearer its serial score than half the gap
    from that score to every other trial's distinct serial score."""
    drift = abs(lanes[a] - serial[a])
    gaps = [abs(s - serial[a]) for b, s in serial.items() if b != a and s != serial[a]]
    return all(drift < g / 2 for g in gaps)


def swap_unit(data) -> float:
    """The most that one swap at a top-k boundary moves a split's test recall:
    1 / (test users · the fewest ground-truth items of a test user)."""
    t = data.test
    fewest = int(t.ground_truth.lengths[t.test_users.long()].min())
    return 1.0 / (t.n_test_users * max(fewest, 1))


def grids_both_ways(specs: dict, n_batches: dict, swap_units: dict | None = None,
                    device: str = "cuda") -> dict:
    """Each grid of ``specs`` through the CLI with ``tune.parallel`` and
    serially: each trial's test score equal to its serial score
    (``LANES_SCORE_TOL``), or, for a grid with ``"swaps"``, within that many
    of ``swap_units[name]`` and nearer its own serial score than half the gap
    to any other trial's (:func:`lane_is_its_trial`); B1's launches equal to
    :func:`lanes_b1`'s count (``n_batches`` steps an epoch), no B2, and each
    grid's wall time."""
    grids = {}
    for name, spec in specs.items():
        swaps = spec.get("swaps", 0)
        tol = swaps * swap_units[name] if swaps else LANES_SCORE_TOL
        lanes = run_grid(name, spec, spec["parallel"], device)
        serial = run_grid(name, spec, 0, device)
        per_group = int(np.prod([len(v) for h, v in spec["grid"].items() if h != "layer_num"]))
        want = lanes_b1(name, [(L, per_group) for L in spec["grid"].get("layer_num", [None])],
                        spec["parallel"], n_batches[name], spec["epochs"])
        got = (lanes["launches"], serial["launches"])
        diff = max(abs(lanes["scores"][a] - serial["scores"][a]) for a in serial["scores"])
        strays = [a for a in serial["scores"] if not lane_is_its_trial(a, lanes["scores"],
                                                                        serial["scores"])]
        held = (f"{swaps} swaps of {swap_units[name]:.4g}, and nearer its own trial's serial "
                f"score than half the gap to any other's" if swaps else "equal")
        log(f"  {name}: {len(serial['scores'])} trials, lanes (tune.parallel="
            f"{spec['parallel']}) {lanes['wall_s']:.1f} s, serial {serial['wall_s']:.1f} s "
            f"(host clock, data load included); B1 {got[0]} / {got[1]} launches ({want[0]} / "
            f"{want[1]} counted from the code, {n_batches[name]} steps an epoch); B2 "
            f"{lanes['b2_launches']} / {serial['b2_launches']}; test score lanes - serial "
            f"max |diff| {diff:.3g} (tolerance {tol:.4g}: {held})")
        for a in serial["scores"]:
            log(f"    {a}: lanes {lanes['scores'][a]:.5f}, serial {serial['scores'][a]:.5f}")
        if set(lanes["scores"]) != set(serial["scores"]) or diff > tol or strays:
            raise AssertionError(f"{name}: lanes {lanes['scores']} against serial "
                                 f"{serial['scores']} (tolerance {tol:.4g})")
        if got != want or lanes["b2_launches"] or serial["b2_launches"]:
            raise AssertionError(f"{name}: B1 launched {got}, the code counts {want}; B2 "
                                 f"{lanes['b2_launches']}, {serial['b2_launches']}")
        grids[name] = {"lanes": lanes, "serial": serial, "want_b1": want,
                       "max_score_diff": diff, "score_tol": tol, "parallel": spec["parallel"],
                       "epochs": spec["epochs"], "grid": spec["grid"]}
    return grids


def grid_summary(grids: dict) -> dict:
    """The kernels line's record of :func:`grids_both_ways`'s grids."""
    return {k: {"lanes_wall_s": v["lanes"]["wall_s"], "serial_wall_s": v["serial"]["wall_s"],
                "b1_lanes_serial": [v["lanes"]["launches"], v["serial"]["launches"]],
                "b1_counted": list(v["want_b1"]), "max_score_diff": v["max_score_diff"],
                "score_tol": v["score_tol"],
                "parallel": v["parallel"], "epochs": v["epochs"], "grid": v["grid"],
                "lanes_scores": v["lanes"]["scores"], "serial_scores": v["serial"]["scores"]}
            for k, v in grids.items()}


def lane_hp(cfg, probe, k: int, dev) -> dict:
    """``k`` lanes' scalars of each of ``probe``'s ``hparams()`` keys: the
    first ``k`` values of its list in the config's tune grid (its config
    value repeated where the grid does not tune it), [k] float32."""
    tuned = set(cfg.tune.get("hyperparameters", ()))
    hp = {h: [float(v) for v in (list(cfg.tune[h])[:k] if h in tuned else [cfg.model[h]] * k)]
          for h in probe.hparams()}
    if any(len(v) != k for v in hp.values()):
        raise AssertionError(f"{cfg.model.name}: fewer than {k} lanes in the grid: {hp}")
    return {h: torch.tensor(v, dtype=torch.float32, device=dev) for h, v in hp.items()}


def lane_batches(lanes: Lanes, n: int) -> list:
    """The first ``n`` batches of epoch 0 (wrapping) with their PRF keys, or
    the epoch's device generator for a ``step_generator`` model."""
    idx, sampled, keys = lanes.trainer.epoch_draws(0)
    gen = generator(int(lanes.cfg.train.seed), 0, DEVICE_STREAM, device=lanes.device)
    out = []
    for i in range(n):
        b = {k: v[idx[i % len(idx)]] for k, v in (*lanes.trainer.arrays.items(),
                                                   *sampled.items())}
        b["step"] = i
        out.append((b, gen if lanes.probe.step_generator else keys[i % len(keys)]))
    return out


def lanes_step_check(lanes: Lanes, hp: dict, rel: float = LANE_REL, atol: float = LANE_ATOL,
                     sure_abs: float = LANE_SURE_ABS) -> dict:
    """One step of the lanes of ``hp`` from the probe's initial parameters
    against each lane's single step (its trial's config) from the same
    parameters, first batch of epoch 0 and draws, in the probe's dtype: loss
    and every gradient within ``rel`` of the tensor's largest entry plus
    ``atol``; a parameter the loss leaves out keeps no gradient in either;
    the parameters after the lanes' Adam equal to Adam of each lane alone bit
    for bit, and the single run's within ``LANE_ADAM_ATOL`` where its gradient
    is sure (at least ``LANE_SURE`` of its tensor's largest entry and
    ``sure_abs``).  Shared with ``tests/test_torch_tune_lanes.py``.  Returns
    the lanes' losses, the largest share of its tolerance that a loss and a
    gradient took, the largest relative gradient error, and the largest
    difference after Adam."""
    cfg, data, dev = lanes.cfg, lanes.data, lanes.device
    k = next(iter(hp.values())).shape[0]
    params = lanes.init_lanes(k)
    init = {n: p.detach().clone() for n, p in params.items()}
    dtype = next(iter(init.values())).dtype
    idx, sampled, keys = lanes.trainer.epoch_draws(0)
    batch = {n: v[idx[0]] for n, v in (*lanes.trainer.arrays.items(), *sampled.items())}
    batch["step"] = 0
    seed = int(cfg.train.seed)
    gen = generator(seed, 0, DEVICE_STREAM, device=dev)
    aux = lanes.epoch_state(params, gen) if lanes.has_aux else None
    loss = lanes.step(params, build_optimizer(cfg, list(params.values())), batch,
                      gen if lanes.probe.step_generator else keys[0], hp, aux)
    grads = {n: p.grad for n, p in params.items()}
    for i in range(k):      # Adam is elementwise: each lane's update is its own
        alone = [init[n][i].clone().requires_grad_() for n in params]
        for a, n in zip(alone, params):     # Adam skips a leaf the loss leaves out
            a.grad = None if grads[n] is None else grads[n][i].clone()
        build_optimizer(cfg, alone).step()
        for a, n in zip(alone, params):
            if not torch.equal(a.detach(), params[n][i].detach()):
                raise AssertionError(f"{cfg.model.name} lane {i} {n}: the lanes' Adam is not "
                                     f"Adam of the lane alone")
    worst = {"loss": 0.0, "grad": 0.0, "grad_rel": 0.0, "grad_rel_at": "", "adam_abs": 0.0}
    failed = []

    def close(what, got, want, field):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst[field] = max(worst[field], err / (rel * scale + atol))
        # the largest relative error among tensors whose gradient is not
        # rounding alone (the attention key biases' is ~1e-12)
        if field == "grad" and scale >= LANE_SURE_ABS and err / scale > worst["grad_rel"]:
            worst["grad_rel"], worst["grad_rel_at"] = err / scale, what
        if not err <= rel * scale + atol:
            failed.append(f"{what}: {err:.3g} > {rel} x {scale:.3g} + {atol}")

    for i in range(k):
        lcfg = cfg.replace(model={h: float(v[i]) for h, v in hp.items()})
        model = build_model(lcfg, data).to(dtype)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init["model." + n][i])
        lgen = generator(seed, 0, DEVICE_STREAM, device=dev)
        lbatch = dict(batch)
        if lanes.has_aux:
            lbatch["aux"] = model.epoch_state(lgen, 0)
        out = Trainer(lcfg, model, data).train_step(
            lbatch, lgen if model.step_generator else keys[0])
        close(f"lane {i} loss", loss[i], out["loss"], "loss")
        for n, p in model.named_parameters():
            g = grads["model." + n]
            if g is None:
                if p.grad is not None or not torch.equal(params["model." + n][i], p):
                    failed.append(f"lane {i} {n}: out of the lanes' loss, not of the single "
                                  f"run's")
                continue
            close(f"lane {i} grad {n}", g[i], p.grad, "grad")
            sure = (p.grad.abs() >= LANE_SURE * p.grad.abs().max()) & (
                p.grad.abs() >= sure_abs)
            d = float((params["model." + n][i].detach()[sure] - p.detach()[sure]).abs().max()
                      ) if bool(sure.any()) else 0.0
            worst["adam_abs"] = max(worst["adam_abs"], d)
            if d > LANE_ADAM_ATOL:
                failed.append(f"lane {i} {n} after Adam: {d:.3g} > {LANE_ADAM_ATOL}")
        del model
    if failed:
        raise AssertionError(f"{cfg.model.name}: {len(failed)} checks failed: "
                             + "; ".join(failed[:12]))
    return {"lanes_loss": loss.tolist(), "rel": rel, "atol": atol, "dtype": str(dtype), **worst}


class plain_b1:
    """B1's plain version in place of its kernel while the block runs, for a
    float64 check on the card (the kernel takes float32 only); its launch
    counters are left as they were."""

    def __enter__(self):
        self.real = sk.csr_spmm
        sk.csr_spmm = skn.csr_spmm = sk.csr_spmm_plain
        return self

    def __exit__(self, *exc):
        sk.csr_spmm = skn.csr_spmm = self.real
        return False


def time_lane_steps(lanes: Lanes, hp: dict, n: int = LANE_TIMED_STEPS, warmup: int = 2) -> dict:
    """Host-clock ms of a step of the lanes of ``hp`` and of a single step
    (the probe under its own config, through the serial trainer's step),
    each the mean of ``n`` steps on epoch 0's batches after ``warmup``, the
    card synced before and after; ``ratio`` is the lanes' step over one
    trial's (K where the lanes save nothing)."""
    k = next(iter(hp.values())).shape[0]
    params = lanes.init_lanes(k)
    opt = build_optimizer(lanes.cfg, list(params.values()))
    batches = lane_batches(lanes, warmup + n)

    def run(step) -> float:
        for b, key in batches[:warmup]:
            step(dict(b), key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, key in batches[warmup:]:
            step(dict(b), key)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    lanes_ms = run(lambda b, key: lanes.step(params, opt, b, key, hp, None))
    single_ms = run(lanes.trainer.train_step)
    del params, opt
    return {"k": k, "steps": n, "lanes_ms": lanes_ms, "single_ms": single_ms,
            "ratio": lanes_ms / single_ms}


def fold_check(errs: ErrTrack, what: str, g: sk.CsrGraph, w, d: int, k: int, gen) -> None:
    """B1 under the lanes' vmap rule at ``g`` (k lanes of width ``d``; ``w``
    None, a :class:`PrfMask` or a constant [nnz] multiplier): one launch for
    the hop and one for its dx, each lane's value and dx against the plain
    version."""
    x = torch.randn(k, g.n_cols, d, generator=gen, device=g.fwd.cols.device, requires_grad=True)
    ct = torch.randn(k, g.n_rows, d, generator=gen, device=x.device)
    ew = sk.EdgeMask(w) if isinstance(w, torch.Tensor) else w
    before = sk.csr_spmm.launches
    y = torch.func.vmap(lambda xl: sk_spmm(g, xl, ew))(x)
    (dx,) = torch.autograd.grad((y * ct).sum(), x)
    launched = sk.csr_spmm.launches - before
    if launched != 2:
        raise AssertionError(f"{what}: {launched} B1 launches for a hop and its dx, want 2")
    for i in range(k):
        errs.check(f"{what}.lane{i}", y[i].detach(), sk.csr_spmm_plain(g.fwd, x[i].detach(), w))
        errs.check(f"{what}.lane{i}.dx", dx[i], sk.csr_spmm_plain(g.bwd, ct[i], w))


def fold_timing(errs: ErrTrack, what: str, g: sk.CsrGraph, w, d: int, gen) -> dict:
    """:func:`fold_check` of ``LANE_K`` lanes of width ``d`` at ``g``, then B1
    timed at the fold's width beside its bound, plain version,
    ``torch.sparse.mm`` and ``LANE_K`` calls at width ``d``."""
    fold_check(errs, what, g, w, d, LANE_K, gen)
    lay = g.fwd
    x = torch.randn(g.n_cols, LANE_K * d, generator=gen, device=lay.cols.device)
    xd = x[:, :d].contiguous()
    r, bound = time_b1(lay, x, w, **{f"lanes_d{d}": lambda: [sk.csr_spmm(lay, xd, w)
                                                             for _ in range(LANE_K)]})
    log_timing(f"{what} ({LANE_K} lanes of d {d} as one [{g.n_cols}, {LANE_K * d}] operand)",
               r, bound)
    return {"t": r, "bound": bound,
            "shape": {"n_rows": g.n_rows, "n_cols": g.n_cols, "nnz": g.nnz, "d": LANE_K * d}}


def last_lanes_phases(gen, dev) -> dict:
    """Phase 36: the lanes of MBGMN, HMGCR, SMBRec, CL4SRec, DuoRec and
    DCRec_seq at their published configs.  Per model: one step of
    ``LANE_K`` lanes held against the single steps (HMGCR in float64 with
    B1's plain version, CL4SRec, DuoRec),
    and ``LANE_TIMED_STEPS`` lanes steps timed against single steps (all
    six); B1 under the lanes' vmap rule and timed at the folded Tmall pv
    graph (d 2 x 32) and DCRec_seq's transition hop (d 2 x 64, the call's
    values); then MBGMN's, SMBRec's and DCRec_seq's grids both ways
    (:func:`grids_both_ways`)."""
    log("== 36. the lanes of MBGMN, HMGCR, SMBRec, CL4SRec, DuoRec and DCRec_seq")
    fold_errs = ErrTrack()
    steps, timed, n_batches, folds = {}, {}, {}, {}
    for name, dataset in LAST_LANES.items():
        t0 = time.perf_counter()
        cfg = port_main.parse_cli(["--model", name, "--data_dir", SMOKE_RESULTS, "--dataset",
                                   dataset, "--device", "cuda"])
        data = load_data(cfg, dev)
        lanes = Lanes(cfg, build_model(cfg, data), data)
        n_batches[name] = lanes.trainer.n_batches
        hp = lane_hp(cfg, lanes.probe, LANE_K, dev)
        load_s = time.perf_counter() - t0
        if name in LANE_F64:
            with plain_b1():
                steps[name] = lanes_step_check(
                    Lanes(cfg, build_model(cfg, data).to(torch.float64), data), hp,
                    rel=LANE_REL_F64, atol=0.0)
        elif name in LANE_STEP_MODELS:
            steps[name] = lanes_step_check(lanes, hp)
        if name in steps:
            log(f"  {name}: one {LANE_K}-lane step against the single steps "
                f"({steps[name]['dtype']}), hp "
                f"{ {h: v.tolist() for h, v in hp.items()} }: losses {steps[name]['lanes_loss']}"
                f"; largest error over its tolerance ({steps[name]['rel']} of the largest entry + "
                f"{steps[name]['atol']}): loss {steps[name]['loss']:.3g}, gradients "
                f"{steps[name]['grad']:.3g} (largest relative {steps[name]['grad_rel']:.3g}, "
                f"{steps[name]['grad_rel_at']}); after Adam max abs diff "
                f"{steps[name]['adam_abs']:.3g} (tolerance {LANE_ADAM_ATOL})")
        timed[name] = time_lane_steps(lanes, hp)
        t = timed[name]
        log(f"  {name}: {t['steps']} steps of {LANE_K} lanes {t['lanes_ms']:.2f} ms a step, "
            f"single {t['single_ms']:.2f} ms; ratio {t['ratio']:.3f} ({LANE_K}: the lanes save "
            f"nothing; host clock, synced); load and build {load_s:.1f} s")
        if name == "smbrec":
            key = "tmall_pv_a_lanes2_d64"
            folds[key] = fold_timing(fold_errs, key, data.extras["behavior_graphs"][0][0],
                                     None, 32, gen)
        elif name == "dcrec_seq":
            key, adj = "dcrec_seq_adj_hop_lanes2_d128", lanes.probe.adj
            folds[key] = fold_timing(fold_errs, key, adj.g,
                                     torch.rand(adj.nnz, generator=gen, device=dev), 64, gen)
        del lanes, data
        torch.cuda.empty_cache()
    log(f"  B1 under the lanes' vmap rule at the folded shapes: max abs err {fold_errs.abs:.3g}, "
        f"max rel err {fold_errs.rel:.3g} (tolerance {TOL}), one launch a hop and one a dx")
    grid_batches, swap_units = dict(n_batches), {}
    for name, spec in LAST_LANE_GRIDS.items():      # the grids' own splits, where they differ
        if spec["data"] == (SMOKE_RESULTS, LAST_LANES[name]) and not spec.get("swaps"):
            continue
        cfg = port_main.parse_cli(["--model", name, "--data_dir", spec["data"][0],
                                   "--dataset", spec["data"][1], "--device", "cuda"])
        data = load_data(cfg, dev)
        grid_batches[name] = Lanes(cfg, build_model(cfg, data), data).trainer.n_batches
        if spec.get("swaps"):
            swap_units[name] = swap_unit(data)
    grids = grids_both_ways(LAST_LANE_GRIDS, grid_batches, swap_units)
    return {"errs": fold_errs, "steps": steps, "timed": timed, "folds": folds,
            "grids": grids, "n_batches": n_batches}


MESH_PARTS = (2, 4)         # phase 37(a): the model axes the bi-adjacency is partitioned for
MESH_RUN = {"data": 2, "model": 2}      # phase 37(b): four gloo ranks on card 0
MESH_EPOCHS = 1
MESH_PARAM_TOL = {"rtol": 2e-4, "atol": 2e-5}   # the CPU tests' (and JAX's) tolerances
MESH_METRIC_TOL = {"rtol": 1e-4, "atol": 1e-6}
MESH_MODELS = ("lightgcn", "sgl")       # phase 37(b): trained on MESH_RUN, in one spawn
# Phase 37(b)'s reference for SGL's tables: a run with MESH_RUN's data split
# and whole tables.  SGL's InfoNCE gives every row a gradient, and Adam's
# normalisation carries the float32 rounding of entries that cancel into the
# tables: over 62 steps its single run moves 6.7e-5 / 8.0e-5 (users / items)
# when cuBLASLt replaces cuBLAS, and a {2, 1} run, which changes only the
# order in which the batch's gradient is summed, 6.3e-5 / 3.4e-5, both
# beyond MESH_PARAM_TOL (this phase on an NVIDIA H100 80GB HBM3, 700 W).  So
# the mesh run's tables are held within MESH_PARAM_TOL of the run with its
# own data split, which isolates the model axis, and their deviation from
# the single run is recorded beside the single run's own under the other
# GEMM order (``gemm_order_control``); losses and metrics are held to the
# single run.  The run rides phase 37(d)'s spawn of two gloo ranks (the same
# world size; a depth cut that saves a spawn and keeps the check).
MESH_SPLIT_REF = {"data": 2, "model": 1}
# Phase 37(b)'s depth cut, which makes room for 37(e): LightGCN and SGL
# train on alibaba-fashion with a seeded share of its train pairs (the same
# users, items, valid and test pairs), 16 steps an epoch where the whole
# split has 62; phase 37(a) still partitions the whole bi-adjacency.
MESH_CF_DATASET = "alibaba_mesh"    # written under SMOKE_RESULTS/kg/alibaba_mesh_kg/
MESH_CF_TRAIN_SHARE = 0.25
# B1 launches in each rank of a mesh run with a model axis > 1, by layout, as
# (a step, an evaluation), counted from the code at the shipped layer counts:
# "forward" / "transposed" the shard's layouts (the partitioned clean forward
# and its backward, and the partitioned generate()), "whole" the whole graph's
# two layouts, which share one shape (SGL's and SimGCL's two views of 2 hops
# and their backward; NCL's 4 training hops and their backward, 3 in
# generate(); DirectAU's 2 hops and their backward, 2 in generate())
MESH_B1 = {"lightgcn": {"forward": (2, 2), "transposed": (2, 0)},
           "sgl": {"forward": (2, 2), "transposed": (2, 0), "whole": (8, 0)},
           "simgcl": {"forward": (2, 2), "transposed": (2, 0), "whole": (8, 0)},
           "ncl": {"whole": (8, 3)},
           "directau": {"whole": (4, 2)}}


# B1 and B2 launches in each rank of a KG model's run on a mesh with a model
# axis > 1, counted from the code at the published configs (2 UI layers, 2
# KG hops), by layout as in MESH_B1 ("forward" / "transposed" the
# partitioned graph's shard layouts; "whole" every other layout, the KG's
# segment layouts over the whole KG and the whole graphs) and "b2", per
# training step, per generate(), per epoch (the epoch hook) and at
# construction.  KG_COUNTS' single-device counts, with each hop that the
# mesh partitions moved from "whole" to the shard's layouts:
# - KGCL: each of the step's three forwards (the main view, the two
#   contrastive views) runs 2 partitioned UI hops, a forward launch each
#   and a transposed one in the backward: 6 + 6 of KG_COUNTS' 31; generate
#   2 of its 5; the epoch's views run no UI hop.  The TransE sub-loop
#   launches nothing.
# - KGIN: the users' interact sum of each hop is the partitioned hop (the
#   [users; entities] graph's user-destination edges), its entity gather's
#   backward the transposed one: 2 + 2 of 10; generate 2 of 5.
# - KGRec: the UI tower's 2 hops are one partitioned hop each (both
#   directions in one layout), a transposed one each in the backward (the
#   last hop's, whose user side is unused, too): 2 + 2 where the single run
#   has 4 + 3; generate runs no UI tower.
# - DiffKG: both forwards' 2 UI hops and their dx: 4 + 4 of 30; generate 2
#   of 6; the epoch's ukgc hop reads the whole users' table.
MESH_KG = {"kgcl": {"step": {"forward": 6, "transposed": 6, "whole": 19, "b2": 6},
                    "gen": {"forward": 2, "whole": 3, "b2": 2},
                    "epoch": {"whole": 6, "b2": 4}},
           "kgin": {"step": {"forward": 2, "transposed": 2, "whole": 6},
                    "gen": {"forward": 2, "whole": 3}},
           "kgrec": {"step": {"forward": 2, "transposed": 2, "whole": 23, "b2": 5},
                     "gen": {"whole": 6, "b2": 4}},
           "diffkg": {"step": {"forward": 4, "transposed": 4, "whole": 22, "b2": 4},
                      "gen": {"forward": 2, "whole": 4, "b2": 2},
                      "epoch": {"whole": 1}, "build": {"whole": 1}}}
MESH_KG_MODELS = ("kgcl", "kgin", "kgrec", "diffkg")
MESH_KG_RUN = {"data": 1, "model": 2}   # phase 37(d): two gloo ranks on card 0
# KGCL's TransE sub-loop at batch 16384 (18 steps an epoch over the full
# triplets, was 73 at its published 4096: a depth cut, for 37(e))
MESH_KG_ARGS = {"kgcl": ["--set", "model.train_trans=true", "--set", "train.kg_batch_size=16384"]}
# Phase 37(d)'s depth cut: its runs train on the synthetic KG (the same
# triplets, test pairs, users, items and entities) with a seeded share of
# its train pairs, so fewer steps an epoch; widths and the KG stay.
MESH_KG_DATASET = "synthetic_mesh"      # written under SMOKE_RESULTS/kg/synthetic_mesh_kg/
MESH_KG_TRAIN_SHARE = 0.03125


# B1 launches in each rank of a multi-behavior model's run on a mesh with a
# model axis > 1, counted from the code at the published configs on the
# Tmall-shaped split (4 behaviors; HMGCR's 4 meta-path towers), by layout as
# in MESH_KG, per training step, per generate(), per KMCLR contrast step, per
# epoch (the hook's other parts) and once.  Every hop of these models is
# partitioned, and all their partitions share one node space [users;
# items], so one forward and one transposed shape:
# - HMGCR (4 towers, 3 layers) and SMBRec (4 towers, 2 layers): each layer's
#   A hop and AT hop, and the backward of both (the first A hop reads the
#   item table): 2·4·3 = 24 and 2·4·2 = 16 each way; generate the forward.
# - CML (4 behaviors, 3 layers): one bidirectional hop a behavior and layer,
#   12 a GCN forward; rounds 1 and 3 run it with its backward, round 2
#   through the constant clone without: 36 forward, 24 transposed a step;
#   generate 12.
# - KMCLR: its MB GCN as CML's, 2 rounds: 24 + 24 a step, generate 12; a
#   contrast step of the hook runs three LightGCNs of 3 hops over the buy
#   bi-adjacency (the all-ones view's and two views') with their backward,
#   9 + 9, and the four GATs' entity and relation list gathers' backward, 8
#   whole-KG segment sums; an epoch's views make their values (2 whole) and
#   get_all runs 3 hops; the all-ones view's values are made once.
MESH_MB = {"hmgcr": {"step": {"forward": 24, "transposed": 24}, "gen": {"forward": 24}},
           "smbrec": {"step": {"forward": 16, "transposed": 16}, "gen": {"forward": 16}},
           "cml": {"step": {"forward": 36, "transposed": 24}, "gen": {"forward": 12}},
           "kmclr": {"step": {"forward": 24, "transposed": 24}, "gen": {"forward": 12},
                     "contrast": {"forward": 9, "transposed": 9, "whole": 8},
                     "epoch": {"forward": 3, "whole": 2}, "build": {"whole": 1}}}
MESH_MB_MODELS = ("hmgcr", "smbrec", "cml", "kmclr")


# B1 launches in each rank of a run on a mesh with a model axis > 1 of the
# models that partition no graph (ROADMAP Queue A item 9a), counted from the
# code at the published configs, by layout as in MESH_KG, per training step,
# per generate(), at construction, per view of AutoCF's and GFormer's banks
# and per step where those regenerate.  Each rank holds a row shard of the
# tables and reads them whole (dist_train.whole_nodes), so every hop runs on
# the whole graph in every rank, and each rank launches what one device
# launches (SSL_B1, VIEW_B1, MB_B1; their comments count them); no layout
# has a shard's shape:
# - DCCF: per layer the GNN hop, two adaptive-mask hops and two degree sums
#   (d 1), backward 3 dx, 2 layers: 16; generate 10.
# - HCCF: one rescaled-dropout hop a layer and its dx, 2 layers: 4;
#   generate 2.
# - LightGCL: A·E_i and Aᵀ·E_u a layer with their dx, 2 layers: 8; generate
#   4; its SVD at construction in every rank: 10.
# - AutoCF: 2 encoder hops with dx and a GT layer over the decoder: 9; a
#   regenerating step's infomax hops with dx: 4; a view: 4; generate 4.
# - GFormer: 27 a step; a view's three degree sums: 3; generate 2.
# - AdaGCL: the four phases' hops, degree sums and gathers' backward: 39;
#   generate 2.
# - MBGMN (4 behaviors, 2 layers): 48 forward, the final tower's 24 dx: 72;
#   generate 48.
MESH_GSPMD_A = {"dccf": {"step": {"whole": 16}, "gen": {"whole": 10}},
                "hccf": {"step": {"whole": 4}, "gen": {"whole": 2}},
                "lightgcl": {"step": {"whole": 8}, "gen": {"whole": 4}, "build": {"whole": 10}},
                "autocf": {"step": {"whole": 9}, "regen": {"whole": 4}, "view": {"whole": 4},
                           "gen": {"whole": 4}},
                "gformer": {"step": {"whole": 27}, "view": {"whole": 3}, "gen": {"whole": 2}},
                "adagcl": {"step": {"whole": 39}, "gen": {"whole": 2}},
                "mbgmn": {"step": {"whole": 72}, "gen": {"whole": 48}}}
MESH_GCF_MODELS = ("lightgcl", "hccf", "dccf", "autocf", "gformer", "adagcl", "mbgmn")


# B1 launches in each rank of the social five's runs on a mesh with a model
# axis > 1 (ROADMAP Queue A item 9b; phase 37(g)), by layout as in MESH_KG,
# per training step, per generate() and per DcRec view with added edges
# ("added_ui", "added_uu": the views the run drew, DcRec.added_views, which
# every rank draws alike).  Like item 9a's seven, each rank reads its row
# shards whole and runs every hop on the whole graphs with the single run's
# draws, so each rank launches what one device launches (SOCIAL_B1 and
# DCREC_ADDED_B1, whose comment counts them); no layout has a shard's shape.
MESH_SOCIAL = {m: {"step": {"whole": step}, "gen": {"whole": gen}}
               for m, (step, gen) in SOCIAL_B1.items()}
MESH_SOCIAL["dcrec"].update({f"added_{k}": {"whole": c} for k, c in DCREC_ADDED_B1.items()})
MESH_SOCIAL_MODELS = ("dcrec", "mhcn", "dsl", "kcgn", "smin")


# B1 launches in each rank of the sequential six's runs on a mesh (ROADMAP
# Queue A item 9c; phase 37(h)), by layout as in MESH_KG, per training step,
# per MAERec mask step, per view of its mask bank and per generate().  Every
# parameter is replicated and every item-graph hop runs on the whole graph in
# every rank with the single run's draws, so each rank launches what one
# device launches (SEQ_B1, whose comment counts them); the four models whose
# towers are dense products launch none.
MESH_SEQ = {m: {part: {"whole": c} for part, c in zip(("step", "mask", "view", "gen"), counts)
                if c}
            for m, counts in SEQ_B1.items()}
MESH_SEQ_MODELS = SEQ_MODELS
MESH_SEQ_RUN = {"data": 2, "model": 1}  # phase 37(h): two gloo ranks on card 0, in 37(d)'s spawn
# Phase 37(h)'s depth cut: the six train on SEQ_CUT_DATASET (the first
# quarter of the sports-shaped split's users: the same item ids, widths and
# sequence shapes), single runs made there in the same call, at phase 23's
# batch sizes (SEQ_BATCH_ARGS) but MAERec's, which trains 3 steps at batch
# 16384: its decoder's float32 training turns any rounding-level change
# into an Adam step of about lr once a ReLU of the decoder flips in one run
# and not the other (a 1e-7 relative change of a single run's item table
# moves the decoder 7.5e-4 in an epoch on the CPU, where the float64 mesh
# run stays within 2.2e-14 of the single run), and over its 24 steps at
# batch 2048 the {2, 1} run moved the decoder 2.65e-3 from the single run
# and the single run under cuBLASLt 4.82e-4 (PERF.md section 6, on an NVIDIA
# H100 80GB HBM3 at 700 W)
MESH_SEQ_DATASET = SEQ_CUT_DATASET
MESH_SEQ_ARGS = {**SEQ_BATCH_ARGS, "maerec": ["--set", "train.batch_size=16384"]}


def mesh_table_want(table: dict, model: str, steps: int, evals: int, epochs: int,
                    contrast: int = 0, views: int = 0, added=None,
                    mask: int = 0) -> dict[str, int]:
    """``table[model]``'s count (``MESH_KG``, ``MESH_MB``, ``MESH_GSPMD_A``,
    ``MESH_SOCIAL`` or ``MESH_SEQ``), by layout and B2, for ``steps`` steps,
    ``evals`` evaluations, ``epochs`` epochs, ``contrast`` KMCLR contrast
    steps, ``views`` views (AutoCF's and GFormer's, one regenerating step
    each; MAERec's mask bank), DcRec's ``added`` views (``{"ui": n, "uu":
    n}``) and ``mask`` MAERec mask steps of one construction."""
    added = added or {}
    times = {"step": steps, "gen": evals, "epoch": epochs, "build": 1, "contrast": contrast,
             "view": views, "regen": views, "added_ui": added.get("ui", 0),
             "added_uu": added.get("uu", 0), "mask": mask}
    out = {}
    for part, counts in table[model].items():
        for k, c in counts.items():
            out[k] = out.get(k, 0) + c * times[part]
    return {k: v for k, v in out.items() if v}


def mesh_kg_want(model: str, steps: int, evals: int, epochs: int) -> dict[str, int]:
    """``MESH_KG``'s count for ``steps`` steps, ``evals`` evaluations and
    ``epochs`` epochs of one construction."""
    return mesh_table_want(MESH_KG, model, steps, evals, epochs)


def mesh_kg_launches(run, n_users: int, n_side: int) -> list[dict[str, int]]:
    """Each rank's B1 launches of a KG model's mesh run by ``MESH_KG``'s
    layout names (the partition of ``[users; side]``, ``n_side`` its items
    or, for KGIN, its entities: every other shape is "whole") and its B2
    launches."""
    layouts = mesh_layouts(n_users, n_side, run.mesh["model"])
    out = []
    for r in run.ranks:
        by = {}
        for shape, c in r["launches_by_shape"].items():
            name = layouts.get(shape, "whole")
            by[name] = by.get(name, 0) + c[0]
        if r["b2_launches"]:
            by["b2"] = r["b2_launches"]
        out.append(by)
    return out


def mesh_b1_want(model: str, steps: int, evals: int) -> dict[str, int]:
    """``MESH_B1``'s count for ``steps`` steps and ``evals`` evaluations."""
    return {k: a * steps + b * evals for k, (a, b) in MESH_B1[model].items()}


def mesh_layouts(n_users: int, n_items: int, n_model: int) -> dict[tuple, str]:
    """The layouts of ``MESH_B1`` by their ``(n_rows, n_cols)`` shape on a model
    axis of ``n_model``: a shard's forward (its rows over the gathered padded
    nodes), its transposed, and the whole graph's."""
    n_local = -(-n_users // n_model) + -(-n_items // n_model)
    n_pad, n = n_local * n_model, n_users + n_items
    return {(n_local, n_pad): "forward", (n_pad, n_local): "transposed", (n, n): "whole"}


def mesh_launches(run, n_users: int, n_items: int) -> list[dict[str, list[int]]]:
    """Each rank's B1 ``[launches, combine launches]`` of a mesh run
    (``launch.MeshRun``) over ``n_users`` and ``n_items`` by
    :func:`mesh_layouts`' names (the shape where it names none)."""
    layouts = mesh_layouts(n_users, n_items, run.mesh["model"])
    return [{layouts.get(k, str(k)): list(c) for k, c in r["launches_by_shape"].items()}
            for r in run.ranks]


def mesh_hops(errs: ErrTrack, gen, data, d: int, dev) -> dict:
    """Phase 37(a): B1 on every shard of the bi-adjacency partitioned for each
    of ``MESH_PARTS``, both layouts, against its plain version (no
    multiplier; the whole graph's PRF, bit for bit the kernel fed its mask),
    each shard's PRF mask equal to the whole one's gathered through
    ``src_idx``, the reassembled forward shards against the whole hop; then
    each shard's hop timed beside its bound, which counts the rows of x that
    the shard's edges reference.  Returns the timings, bounds, shapes and
    the reassembly's differences."""
    g = data.extras["bi_adj"]
    coo = CooGraph(g.rows.cpu(), g.cols.cpu(), g.vals.cpu(), g.n_rows, g.n_cols)
    n_u, n_i = data.user_num, data.item_num
    prf = sk.prf_mask(torch.tensor([12345, 678], device=dev), g, 0.5)
    mask = prf.w
    out = {"t": {}, "bound": {}, "shape": {}, "whole_diff": {}, "build_s": {}}
    for parts in MESH_PARTS:
        t0 = time.perf_counter()
        sg = dist_train.partition_graph(coo, n_u, n_i, parts)
        shards = [dist_train.shard_graph(sg, p, dev) for p in range(parts)]
        out["build_s"][parts] = time.perf_counter() - t0
        x = torch.randn(sg.n_pad, d, generator=gen, device=dev)
        real = torch.cat([torch.arange(n_u), sg.u_loc * parts + torch.arange(n_i)]).to(dev)
        whole = sk.csr_spmm(g.fwd, x[real].contiguous())
        fwd_out = []
        for p, sh in enumerate(shards):
            xt = torch.randn(sg.n_local, d, generator=gen, device=dev)
            for tag, lay, xi in (("fwd", sh.graph.fwd, x), ("bwd", sh.graph.bwd, xt)):
                what = f"mesh.P{parts}.shard{p}.{tag}"
                got = sk.csr_spmm(lay, xi)
                check_exact(f"{what}.repeat", sk.csr_spmm(lay, xi), got)
                errs.check(f"{what}.plain", got, sk.csr_spmm_plain(lay, xi))
                kp = sk.csr_spmm(lay, xi, prf)
                check_exact(f"{what}.prf=mask", kp, sk.csr_spmm(lay, xi, mask))
                errs.check(f"{what}.prf", kp, sk.csr_spmm_plain(lay, xi, prf))
                if tag == "fwd":
                    fwd_out.append(got)
            src = torch.from_numpy(sg.src_idx[p]).to(dev).long()[sh.live]
            check_exact(f"mesh.P{parts}.shard{p}.mask", prf.at(sh.graph.fwd.edge_ids), mask[src])
            check_exact(f"mesh.P{parts}.shard{p}.mask_t", prf.at(sh.graph.bwd.edge_ids),
                        mask[src][sh.order])
        full = torch.stack(fwd_out)
        glob = torch.cat([full[:, :sg.u_loc].reshape(-1, d), full[:, sg.u_loc:].reshape(-1, d)])
        diff = float((glob[real] - whole).abs().max())
        rel = diff / float(whole.abs().max())
        exact = torch.equal(glob[real], whole)
        out["whole_diff"][parts] = {"max_abs": diff, "max_rel": rel, "bit_equal": exact}
        if rel > TOL:
            raise AssertionError(f"P {parts}: the shards' hop differs from the whole hop by "
                                 f"{rel:.3g} > {TOL}")
        nnz = [int(sh.graph.nnz) for sh in shards]
        log(f"  P {parts}: U_loc {sg.u_loc}, I_loc {sg.i_loc}, shard nnz {nnz} (E_pad "
            f"{sg.src_idx.shape[1]}), partition and layouts {out['build_s'][parts]:.2f} s; "
            f"every shard within {TOL} of plain, PRF = mask bit for bit, the shards' mask = "
            f"the whole one's through src_idx; reassembled hop - whole hop: max abs "
            f"{diff:.3g}, rel {rel:.3g}{' (bit-equal)' if exact else ''}")
        for p, sh in enumerate(shards):
            for tag, lay, n_in in (("", sh.graph.fwd, sg.n_pad), ("_t", sh.graph.bwd, sg.n_local)):
                xi = torch.randn(n_in, d, generator=gen, device=dev)
                k = f"mesh_hop_P{parts}_shard{p}{tag}"
                # a shard reads only the rows of x that its edges reference
                x_rows = int(torch.unique(lay.cols).numel())
                bound = bound_ms(lay, d, x_rows=x_rows)
                csr = csr_tensor(lay)
                out["t"][k] = timing(lambda lay=lay, xi=xi: sk.csr_spmm(lay, xi),
                                     lambda lay=lay, xi=xi: sk.csr_spmm_plain(lay, xi),
                                     lambda csr=csr, xi=xi: torch.sparse.mm(csr, xi), bound[0])
                out["bound"][k] = bound
                group, t_pick = schedule(lay, d)
                out["shape"][k] = {"n_rows": lay.n_rows, "n_cols": lay.n_cols,
                                   "x_rows_read": x_rows,
                                   "nnz": int(lay.cols.shape[0]), "d": d, "shards": parts,
                                   "shard": p, "layout": "transposed" if tag else "forward",
                                   "lane_group": group, "split_threshold": t_pick}
                log_timing(f"shard {p} of {parts}{' (transposed)' if tag else ''}",
                           out["t"][k], bound)
    return out


def table_diff(a: dict, b: dict) -> dict[str, float]:
    """Each table's largest absolute difference between two whole states."""
    return {k: float((a[k].cpu() - v.cpu()).abs().max()) for k, v in b.items()}


@contextlib.contextmanager
def gemm_order_control():
    """float32 GEMMs that sum in another order: cuBLASLt in place of cuBLAS
    (the same math, rounded otherwise)."""
    prev = torch.backends.cuda.preferred_blas_library()
    torch.backends.cuda.preferred_blas_library("cublaslt")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_blas_library(prev)


def mesh_check(model: str, single, run, n_users: int, n_items: int, split_ref=None,
               control=None) -> dict:
    """One model's ``MESH_RUN`` run (``launch.MeshRun``) held against its
    single-device run: losses (rtol 1e-5), test metrics (``MESH_METRIC_TOL``),
    each rank's B1 launches by layout against ``mesh_b1_want``
    (``MESH_EPOCHS + 2`` evaluations: one an epoch, the best on valid, the
    test), no B2; and the whole tables within ``MESH_PARAM_TOL`` of the
    single run, or, given ``split_ref`` (a ``MESH_SPLIT_REF`` run), of
    ``split_ref``, their deviations from the single run then recorded beside
    those of ``split_ref`` and of ``control`` (the single run under
    :func:`gemm_order_control`).  Returns the deviations and counts."""
    if run.mesh != MESH_RUN:
        raise AssertionError(f"{model}: mesh run on {run.mesh}, want {MESH_RUN}")
    ref = single.best_state if split_ref is None else split_ref.best_state
    for k, v in ref.items():
        if not torch.allclose(run.best_state[k], v.cpu(), **MESH_PARAM_TOL):
            raise AssertionError(f"{model} mesh run {k}: max abs diff "
                                 f"{table_diff(run.best_state, ref)[k]:.3g} from the "
                                 f"{'single' if split_ref is None else MESH_SPLIT_REF} run "
                                 f"beyond {MESH_PARAM_TOL}")
    dev_tab = table_diff(run.best_state, single.best_state)
    out = {"param_diff": dev_tab}
    if split_ref is not None:
        out["param_diff_split_ref"] = table_diff(run.best_state, ref)
        out["split_ref_param_diff"] = table_diff(ref, single.best_state)
        out["control_param_diff"] = table_diff(control.best_state, single.best_state)
    dev_met = {}
    for m, v in single.test_results.items():
        got = np.asarray(run.test_results[m])
        dev_met[m] = float(np.abs(got - np.asarray(v)).max())
        np.testing.assert_allclose(got, v, **MESH_METRIC_TOL, err_msg=f"{model} mesh run {m}")
    losses = [(a["loss"]["loss"], b["loss"]["loss"])
              for a, b in zip(single.recorder.epochs, run.epochs)]
    for a, b in losses:
        if not math.isclose(a, b, rel_tol=1e-5):
            raise AssertionError(f"{model} mesh run loss {b} against {a}")
    steps = single.n_batches * MESH_EPOCHS
    want = mesh_b1_want(model, steps, MESH_EPOCHS + 2)
    by_layout = mesh_launches(run, n_users, n_items)
    if any({k: c[0] for k, c in b.items()} != want for b in by_layout) \
            or any(r["b2_launches"] for r in run.ranks):
        raise AssertionError(f"{model} mesh run B1 launches by rank and layout {by_layout}, "
                             f"want {want} in each rank, and no B2")
    return {**out, "losses": losses, "metric_diff": dev_met,
            "launches_by_rank": [r["launches"] for r in run.ranks],
            "combine_by_rank": [r["combine_launches"] for r in run.ranks],
            "by_layout_by_rank": by_layout, "steps": steps, "want_by_layout": want,
            "test_recall20": float(run.test_results["recall"][list(single.cfg.test.k)
                                                               .index(20)])}


def mesh_spawn(argvs: list, shape, probe=False, device: str = "cuda:0") -> list:
    """``argvs`` run in turn on a mesh of gloo processes sharing card 0
    (``parallel.checks.cli_runs``, with its layout probe after each run
    where ``probe``): a ``launch.MeshRun`` each.  ``shape`` (and ``probe``)
    may be a list, one an argv: runs on meshes of one world size share the
    spawn."""
    shapes = shape if isinstance(shape, list) else [shape] * len(argvs)
    worlds = {s["data"] * s["model"] for s in shapes}
    if len(worlds) != 1:
        raise ValueError(f"mesh_spawn: one spawn takes one world size, not {sorted(worlds)}")
    argvs = [argv + ["--set", f"train.mesh.data={s['data']}", "--set",
                     f"train.mesh.model={s['model']}"] for argv, s in zip(argvs, shapes)]
    inp = {"argvs": argvs, "device": device, "probe": probe}
    ranks = launch.spawn(mesh_checks.run, ([("cli", "cli_runs", inp)],), worlds.pop(),
                         device=device, backend="gloo")
    return [launch.MeshRun([r["cli"]["runs"][k] for r in ranks]) for k in range(len(argvs))]


def write_mesh_cf_split() -> dict:
    """Phase 37(b)'s split (``MESH_CF_DATASET``): alibaba-fashion's with a
    seeded ``MESH_CF_TRAIN_SHARE`` of its train pairs, the pairs of the last
    user and the last item among them, so that the handler counts the same
    users and items; its valid and test pairs whole."""
    import shutil
    src = os.path.join(DATA_DIR, "kg", f"{DATASET}_kg")
    d = os.path.join(SMOKE_RESULTS, "kg", f"{MESH_CF_DATASET}_kg")
    os.makedirs(d, exist_ok=True)
    train = kg_data.read_cf(os.path.join(src, "train.txt"))
    keep = np.random.default_rng(37).choice(len(train), round(len(train) * MESH_CF_TRAIN_SHARE),
                                            replace=False)
    last = np.flatnonzero((train[:, 0] == train[:, 0].max())
                          | (train[:, 1] == train[:, 1].max()))
    keep = np.union1d(keep, last)
    write_cf_pairs(os.path.join(d, "train.txt"), train[keep])
    for fname in ("valid.txt", "test.txt"):
        shutil.copy(os.path.join(src, fname), os.path.join(d, fname))
    return {"train_pairs": int(keep.size), "of": int(len(train))}


def mesh_run(data) -> dict:
    """Phase 37(b), its runs: each of ``MESH_MODELS`` at its shipped config,
    ``MESH_EPOCHS`` epoch on ``MESH_CF_DATASET`` (:func:`write_mesh_cf_split`)
    once on the card and once on a ``MESH_RUN`` mesh of gloo processes
    sharing card 0 (one spawn for all, each rank running the CLIs in turn),
    and SGL's single run under :func:`gemm_order_control`.  SGL's
    ``MESH_SPLIT_REF`` run rides 37(d)'s spawn (``"split_ref_argv"``), and
    :func:`mesh_run_check` holds the runs together."""
    split = write_mesh_cf_split()
    argvs = {m: ["--model", m, "--data_dir", SMOKE_RESULTS, "--dataset", MESH_CF_DATASET,
                 "--epoch", str(MESH_EPOCHS), "--device", "cuda", "--set", "train.test_step=1"]
             for m in MESH_MODELS}
    singles, single_s = {}, {}
    for m, argv in argvs.items():
        t0 = time.perf_counter()
        singles[m] = port_main.main(argv + ["--set",
                                            f"train.results_dir={SMOKE_RESULTS}/mesh_single"])
        single_s[m] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with gemm_order_control():
        control = port_main.main(argvs["sgl"] + ["--set",
                                                 f"train.results_dir={SMOKE_RESULTS}/mesh_ctrl"])
    single_s["sgl_gemm_order_control"] = time.perf_counter() - t0
    mesh_argvs = [argv + ["--set", f"train.results_dir={SMOKE_RESULTS}/mesh"]
                  for argv in argvs.values()]
    t0 = time.perf_counter()
    runs = dict(zip(MESH_MODELS, mesh_spawn(mesh_argvs, MESH_RUN)))
    mesh_s = time.perf_counter() - t0
    log(f"  {MESH_CF_DATASET}: {split['train_pairs']} of alibaba-fashion's {split['of']} train "
        f"pairs; the {MESH_RUN} mesh of 4 gloo processes ran {' and '.join(MESH_MODELS)} in "
        f"{mesh_s:.1f} s")
    return {"split": split, "singles": singles, "single_s": single_s, "control": control,
            "runs": runs, "mesh_s": mesh_s,
            "split_ref_argv": mesh_argvs[MESH_MODELS.index("sgl")]}


def mesh_run_check(data, part: dict, split_ref) -> dict:
    """Phase 37(b), its checks: each of :func:`mesh_run`'s ``MESH_RUN`` runs
    held against its single-device run by :func:`mesh_check`; SGL's tables
    against ``split_ref``, its ``MESH_SPLIT_REF`` run (made in 37(d)'s
    spawn), and its single run under :func:`gemm_order_control`."""
    singles, single_s, mesh_s = part["singles"], part["single_s"], part["mesh_s"]
    out = {"mesh_s": mesh_s, "single_s": single_s, "split": part["split"]}
    for m in MESH_MODELS:
        refs = {"split_ref": split_ref, "control": part["control"]} if m == "sgl" else {}
        out[m] = r = mesh_check(m, singles[m], part["runs"][m], data.user_num, data.item_num,
                                **refs)
        log(f"  {m}: single run {single_s[m]:.1f} s; losses {r['losses']}; whole tables' max "
            f"abs diff {r['param_diff']}; test metrics' max abs diff {r['metric_diff']}; test "
            f"recall@20 {r['test_recall20']:.5f}; B1 launches in each rank by layout "
            f"{r['want_by_layout']} over {r['steps']} steps and {MESH_EPOCHS + 2} evaluations")
    r = out["sgl"]
    log(f"  sgl's tables: {r['param_diff_split_ref']} from its {MESH_SPLIT_REF} run (in 37(d)'s "
        f"spawn), which is {r['split_ref_param_diff']} from the single run; the single run "
        f"under another GEMM order {r['control_param_diff']} from it")
    log(f"  the {MESH_RUN} mesh of 4 gloo processes ran {' and '.join(MESH_MODELS)} in "
        f"{mesh_s:.1f} s (processes, data, {MESH_EPOCHS} epoch each, evaluations); four "
        f"processes sharing one card give no speed figure for a mesh")
    return out


def mesh_nccl(data, dev) -> dict:
    """Phase 37(c): in a one-rank NCCL group in this process, one step of
    ``mesh_partitioned_propagate`` (2 hops under the PRF) with a one-shard
    partition and ``owned_lookup``, value and gradients, against the plain
    hop (``parallel.checks.propagate_grad``); 4 B1 launches."""
    import tempfile
    import torch.distributed as dist
    g = data.extras["bi_adj"]
    rng = np.random.default_rng(37)
    n_u, n_i = data.user_num, data.item_num

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inp = {"rows": g.rows.cpu().numpy(), "cols": g.cols.cpu().numpy(),
           "vals": g.vals.cpu().numpy(), "n": g.n_rows, "n_users": n_u, "n_items": n_i,
           "n_data": 1, "n_model": 1, "device": str(dev), "key": np.array([3, 7]),
           "keep_rate": 0.5, "u": f(n_u, 32), "i": f(n_i, 32), "wu": f(n_u, 32),
           "wi": f(n_i, 32), "wa": f(4096, 32), "idx": rng.integers(0, n_u, 4096)}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            sk.csr_spmm.launches = 0
            t0 = time.perf_counter()
            r = mesh_checks.propagate_grad(inp)
            torch.cuda.synchronize()
            r["s"] = time.perf_counter() - t0
            r["launches"] = sk.csr_spmm.launches
        finally:
            mesh_mod.reset()
            dist.destroy_process_group()
    if r["backend"] != "nccl" or max(r["value"], r["lookup"], r["grad"]) > TOL \
            or r["launches"] != 4:
        raise AssertionError(f"NCCL step: {r}")
    log(f"  one-rank NCCL group: value rel err {r['value']:.3g}, lookup {r['lookup']:.3g}, "
        f"gradients {r['grad']:.3g} against the plain hop; {r['launches']} B1 launches; "
        f"{r['s']:.2f} s")
    return r


def write_mesh_kg_split() -> dict:
    """Phase 37(d)'s split (``MESH_KG_DATASET``): phase 6's synthetic KG with
    a seeded ``MESH_KG_TRAIN_SHARE`` of its train pairs, the pairs of the
    last user and the last item among them, so that the handler counts the
    same users, items and entities."""
    train_cf, test_cf, triples = synthetic_kg()
    rng = np.random.default_rng(37)
    keep = rng.choice(len(train_cf), round(len(train_cf) * MESH_KG_TRAIN_SHARE), replace=False)
    last = np.flatnonzero((train_cf[:, 0] == train_cf[:, 0].max())
                          | (train_cf[:, 1] == train_cf[:, 1].max()))
    keep = np.union1d(keep, last)
    write_kg_dataset(MESH_KG_DATASET, train_cf[keep], test_cf, triples)
    return {"train_pairs": int(keep.size), "of": int(len(train_cf))}


def mesh_kg_partitions(dev) -> dict:
    """The graphs phase 37(d)'s models partition for a model axis of 2, at
    the whole synthetic KG's split (phase 6's): the UI bi-adjacency over
    ``[users; items]`` (KGCL's, KGRec's and DiffKG's) and KGIN's interact
    edges over ``[users; entities]`` (user-destination edges only), each a
    ``ShardedGraph`` with its shards' layouts on ``dev``; and the models'
    published width."""
    cfg = load_config("kgin", overrides={"data.dir": SMOKE_RESULTS, "data.name": KG_DATASET})
    data = load_data(cfg, "cpu")
    ex = data.extras
    u, i, e = data.user_num, data.item_num, ex["entity_num"]
    bi = ex["bi_adj_maskable"].graph
    rows, cols, vals = interact_edges(ex["train_mat_scipy"], u, ex["node_num"])
    graphs = {"kg_ui": (CooGraph(bi.rows.numpy(), bi.cols.numpy(),
                                 np.ones(bi.nnz, np.float32), u + i, u + i), i),
              "kgin_iu": (CooGraph(rows.astype(np.int64), u + cols.astype(np.int64), vals,
                                   u + e, u + e), e)}
    out = {}
    for name, (g, n_side) in graphs.items():
        sg = dist_train.partition_graph(g, u, n_side, MESH_KG_RUN["model"])
        out[name] = {"sg": sg, "n_users": u, "n_side": n_side,
                     "shards": [dist_train.shard_graph(sg, p, dev) for p in range(sg.n_model)]}
    return out, int(cfg.model.embedding_size)


def mesh_kg_hops(errs: ErrTrack, gen, dev) -> dict:
    """Phase 37(d)'s kernels at the whole split's shapes: B1 on each shard of
    :func:`mesh_kg_partitions`, forward and transposed, under seeded values in
    the original edge order (the views' and the dropout's, through
    ``view_vals_partitioned``) and without, against its plain version; then
    each shard's hop under values timed beside its bound (x counted as the
    rows its edges reference), plain version and ``torch.sparse.mm``."""
    parts, d = mesh_kg_partitions(dev)
    out = {"t": {}, "bound": {}, "shape": {}}
    for name, part in parts.items():
        sg = part["sg"]
        vals = torch.rand(sg.n_edges, generator=gen, device=dev)
        pv = dist_train.view_vals_partitioned(sg, vals)
        for p, sh in enumerate(part["shards"]):
            g = sh.with_vals(pv[p])
            for tag, lay, lay0 in (("", g.fwd, sh.graph.fwd), ("_t", g.bwd, sh.graph.bwd)):
                x = torch.randn(lay.n_cols, d, generator=gen, device=dev)
                what = f"mesh_kg.{name}.P2.shard{p}{tag}"
                got = sk.csr_spmm(lay, x)
                check_exact(f"{what}.repeat", sk.csr_spmm(lay, x), got)
                errs.check(f"{what}.vals", got, sk.csr_spmm_plain(lay, x))
                errs.check(f"{what}.plain", sk.csr_spmm(lay0, x), sk.csr_spmm_plain(lay0, x))
                k = f"mesh_{name}_hop_P2_shard{p}{tag}"
                x_rows = int(torch.unique(lay.cols).numel())
                bound = bound_ms(lay, d, x_rows=x_rows)
                csr = csr_tensor(lay)
                out["t"][k] = timing(lambda lay=lay, x=x: sk.csr_spmm(lay, x),
                                     lambda lay=lay, x=x: sk.csr_spmm_plain(lay, x),
                                     lambda csr=csr, x=x: torch.sparse.mm(csr, x), bound[0])
                out["bound"][k] = bound
                group, t_pick = schedule(lay, d)
                out["shape"][k] = {"n_rows": lay.n_rows, "n_cols": lay.n_cols,
                                   "x_rows_read": x_rows, "nnz": int(lay.cols.shape[0]), "d": d,
                                   "shards": sg.n_model, "shard": p, "graph": name,
                                   "layout": "transposed" if tag else "forward",
                                   "lane_group": group, "split_threshold": t_pick}
                log_timing(f"{name} shard {p} of 2{' (transposed)' if tag else ''}",
                           out["t"][k], bound)
        log(f"  {name}: U_loc {sg.u_loc}, side_loc {sg.i_loc}, shard nnz "
            f"{[int(sh.graph.nnz) for sh in part['shards']]} of {sg.n_edges}")
    log(f"  B1 on the KG shards: max abs err {errs.abs:.3g}, max rel err {errs.rel:.3g} "
        f"(tolerance {TOL})")
    return out


def mesh_kg_check(model: str, single: dict, run, control=None) -> dict:
    """One KG (phase 37(d)), multi-behavior (37(e)), item 9a (37(f)) or
    social (37(g)) model's ``MESH_KG_RUN`` run, or a sequential (37(h))
    model's ``MESH_SEQ_RUN`` run, held against its single-device run: each
    epoch's loss terms and the test metrics within ``MESH_METRIC_TOL``, the
    whole tables within ``MESH_PARAM_TOL``, each rank's B1 launches by
    layout and B2 launches against ``mesh_kg_want``'s, ``MESH_MB``'s,
    ``MESH_GSPMD_A``'s, ``MESH_SOCIAL``'s or ``MESH_SEQ``'s count, and each
    rank's ``layout_probe`` (B1 on its shards, or 37(f)'s, 37(g)'s and
    37(h)'s on its whole graphs and segment layouts, within ``TOL`` of
    plain, within ``MESH_MB_B1_TOL`` for 37(e); B2 on its whole-KG head
    layouts bit for bit; a model without a graph probes none).  Where a
    table misses and ``control(model)`` is given (37(f), 37(h)), that single
    run under :func:`gemm_order_control` is made and its own move recorded:
    a missed table passes within that move, and fails beyond it.  Returns
    the deviations and counts."""
    shape = MESH_SEQ_RUN if model in MESH_SEQ else MESH_KG_RUN
    if run.mesh != shape:
        raise AssertionError(f"{model}: mesh run on {run.mesh}, want {shape}")
    param_diff = table_diff(run.best_state, single["best_state"])
    misses = [k for k, v in single["best_state"].items()
              if not torch.allclose(run.best_state[k], v, **MESH_PARAM_TOL)]
    # the largest |a - b| / (atol + rtol |b|) of each table: 1 is the limit
    tol_use = {k: float(((run.best_state[k] - v).abs()
                         / (MESH_PARAM_TOL["atol"] + MESH_PARAM_TOL["rtol"] * v.abs())).max())
               for k, v in single["best_state"].items()}
    metric_diff = {m: float(np.abs(np.asarray(run.test_results[m]) - np.asarray(v)).max())
                   for m, v in single["test_results"].items()}
    for m, v in single["test_results"].items():
        np.testing.assert_allclose(run.test_results[m], v, **MESH_METRIC_TOL,
                                   err_msg=f"{model} mesh run {m}")
    losses = []
    for a, b in zip(single["epochs"], run.epochs, strict=True):
        for term, v in a["loss"].items():
            losses.append((term, v, b["loss"][term]))
            np.testing.assert_allclose(b["loss"][term], v, **MESH_METRIC_TOL,
                                       err_msg=f"{model} mesh run {term}")
    steps = single["n_batches"] * MESH_EPOCHS
    if model in MESH_MB:
        want = mesh_table_want(MESH_MB, model, steps, MESH_EPOCHS + 2, MESH_EPOCHS,
                               single["n_bpr"] * MESH_EPOCHS)
    elif model in MESH_GSPMD_A:
        views = MESH_EPOCHS * -(-single["n_batches"] // single["fix_steps"])
        want = mesh_table_want(MESH_GSPMD_A, model, steps, MESH_EPOCHS + 2, MESH_EPOCHS,
                               views=views)
    elif model in MESH_SOCIAL:
        want = mesh_table_want(MESH_SOCIAL, model, steps, MESH_EPOCHS + 2, MESH_EPOCHS,
                               added=single["added"])
    elif model in MESH_SEQ:
        views = MESH_EPOCHS * -(-single["n_batches"] // single["mask_steps"])
        want = mesh_table_want(MESH_SEQ, model, steps, MESH_EPOCHS + 2, MESH_EPOCHS,
                               views=views, mask=views)
    else:
        want = mesh_kg_want(model, steps, MESH_EPOCHS + 2, MESH_EPOCHS)
    got = mesh_kg_launches(run, single["n_users"], single["n_side"])
    if got != [want] * len(run.ranks):
        raise AssertionError(f"{model} mesh run launches by rank and layout {got}, want {want} "
                             f"in each rank")
    probes = [r["probe"] for r in run.ranks]
    b1_err = max(v for pr in probes for v in pr["b1"].values()) if probes[0]["b1"] else None
    b1_tol = MESH_MB_B1_TOL if model in MESH_MB else TOL     # 37(d) and 37(f): TOL
    # every model with B1 launches probes its layouts (the four sequential
    # models whose towers are dense products hold none)
    if (b1_err is None and want) or (b1_err is not None and b1_err > b1_tol) \
            or not all(all(pr["b2"].values()) for pr in probes):
        raise AssertionError(f"{model}: the ranks' kernels against plain: {probes}")
    control_diff = None
    if misses and control is not None:
        control_diff = table_diff(control(model), single["best_state"])
        log(f"  {model}: tables {misses} beyond MESH_PARAM_TOL, {param_diff} from the single "
            f"run, which under cuBLASLt moves {control_diff}")
        misses = [k for k in misses if param_diff[k] > control_diff[k]]
    if misses:
        raise AssertionError(f"{model} mesh run tables {misses}: max abs diff "
                             f"{ {k: param_diff[k] for k in misses} } from the single run "
                             f"beyond {MESH_PARAM_TOL}"
                             + (f" and the single run's own move under cuBLASLt {control_diff}"
                                if control_diff is not None else ""))
    return {"param_diff": param_diff, "param_tol_use": tol_use, "metric_diff": metric_diff,
            "control_param_diff": control_diff, "graph_nnz": single.get("graph_nnz", {}),
            "losses": losses,
            "by_layout_by_rank": got, "want_by_layout": want, "steps": steps,
            "probe_b1_max_rel_err": b1_err,
            "probe_b2_layouts": sorted(probes[0]["b2"]),
            "test_recall20": float(run.test_results["recall"][single["k"].index(20)])}


def mesh_reference(model: str, tr, s: float) -> dict:
    """What :func:`mesh_kg_check` holds a mesh run to: the single-device
    run ``tr`` (a trainer, ``s`` seconds) of ``model``."""
    return {"best_state": {k: v.cpu() for k, v in tr.best_state.items()},
            "test_results": tr.test_results, "epochs": tr.recorder.epochs,
            "n_batches": tr.n_batches, "n_users": tr.data.user_num,
            "n_side": tr.model.n_entities if model == "kgin" else tr.data.item_num,
            "n_train": tr.data.n_train, "k": list(tr.cfg.test.k),
            "n_bpr": int(getattr(tr.model, "n_bpr", 0)),
            "fix_steps": int(getattr(tr.model, "fix_steps", 1)),
            "added": dict(getattr(tr.model, "added_views", {})),
            "mask_steps": int(getattr(tr.model, "mask_steps", 1)),
            "graph_nnz": {k.split(":")[0]: int(lay.cols.shape[0])
                          for k, lay in mesh_checks.whole_layouts(tr.model).items()
                          if k.endswith(":forward")} if model in MESH_SEQ else {},
            "s": s}


def mesh_single(model: str, argv: list, results: str) -> dict:
    """A phase 37(d) to (h) model's single-device run (``argv``):
    :func:`mesh_reference`."""
    t0 = time.perf_counter()
    tr = port_main.main(argv + ["--set", f"train.results_dir={SMOKE_RESULTS}/{results}_single"])
    return mesh_reference(model, tr, time.perf_counter() - t0)


def mesh_gcf_root(model: str) -> tuple[str, str]:
    """Phase 37(f)'s split for ``model``: the general_cf six's
    ``MESH_CF_DATASET``, MBGMN's 37(e) split."""
    return (MESH_MB_DIR, MB_DATASET) if model == "mbgmn" else (SMOKE_RESULTS, MESH_CF_DATASET)


def write_mesh_gcf_splits(families=("gcf",)) -> dict:
    """Phase 37(f)'s splits: 37(b)'s ``MESH_CF_DATASET`` (written anew: it
    is seeded) and, where 37(e) does not run with it, 37(e)'s split for
    MBGMN (after phase 29's whole one)."""
    out = {"cf": write_mesh_cf_split()}
    if "mb" not in families:
        out["mb"] = write_mesh_mb_split()
    return out


def mesh_kg_run(device: str = "cuda", families=("kg",), extra=(), singles=None) -> dict:
    """Phase 37(d): KGCL (with ``train_trans``), KGIN, KGRec and DiffKG at
    their published configs, ``MESH_EPOCHS`` epoch each on the
    ``MESH_KG_DATASET`` split, once on one device and once on a
    ``MESH_KG_RUN`` mesh of gloo processes sharing card 0 (one spawn, each
    rank running the CLIs in turn and probing its kernels after each), held
    together by :func:`mesh_kg_check`; with ``"mb"`` in ``families``, phase
    37(e)'s HMGCR, SMBRec, CML and KMCLR on ``MESH_MB_DATASET``
    (:func:`write_mesh_mb_split`) too, and with ``"gcf"`` phase 37(f)'s
    ``MESH_GCF_MODELS`` (:func:`mesh_gcf_root`; a table that misses is held
    to its single run's own move under cuBLASLt), with ``"social"`` phase
    37(g)'s ``MESH_SOCIAL_MODELS`` on yelp_sub, and with ``"seq"`` phase
    37(h)'s ``MESH_SEQ_MODELS`` on ``MESH_SEQ_DATASET`` (written in phase
    18, :func:`write_sports_split`) on a ``MESH_SEQ_RUN`` mesh (a missed
    table held as 37(f)'s), their mesh runs in the same spawn; ``extra``
    (``(argv, shape)`` pairs of the spawn's world
    size: 37(b)'s SGL ``MESH_SPLIT_REF`` run) join the spawn, unprobed, and
    come back under ``"extra"``.  ``singles`` (``{model:``
    :func:`mesh_reference` ``}``) holds single runs made already with the
    same arguments (phases 17 and 19's of the social five), which are not
    made again.  ``device`` "cpu" runs it all on the CPU (a call there
    counts where the card counts a launch).  Returns each family's results
    by its name (``"kg"``, ``"mb"``, ``"gcf"``, ``"social"``, ``"seq"``)."""
    datasets = {"kg": (MESH_KG_MODELS, lambda m: (SMOKE_RESULTS, MESH_KG_DATASET),
                       write_mesh_kg_split),
                "mb": (MESH_MB_MODELS, lambda m: (MESH_MB_DIR, MB_DATASET), write_mesh_mb_split),
                "gcf": (MESH_GCF_MODELS, mesh_gcf_root,
                        lambda: write_mesh_gcf_splits(families)),
                "social": (MESH_SOCIAL_MODELS, lambda m: (DATA_DIR, SOCIAL_DATASET), dict),
                "seq": (MESH_SEQ_MODELS, lambda m: (SMOKE_RESULTS, MESH_SEQ_DATASET), dict)}
    argvs, splits = {}, {}
    singles = dict(singles or {})
    for fam in families:
        models, root_of, write = datasets[fam]
        splits[fam] = write()
        for m in models:
            root, dataset = root_of(m)
            argvs[m] = ["--model", m, "--data_dir", root, "--dataset", dataset,
                        "--epoch", str(MESH_EPOCHS), "--device", device,
                        "--set", "train.test_step=1", "--set", "tune.enable=false",
                        *(MESH_SEQ_ARGS if fam == "seq" else MESH_KG_ARGS).get(m, [])]
            if m not in singles:
                singles[m] = mesh_single(m, argvs[m], f"mesh_{fam}")
        n = {(singles[m]["n_users"], singles[m]["n_train"]) for m in models}
        log(f"  {fam}: users, train pairs {n}; single runs "
            f"{ {m: round(singles[m]['s'], 1) for m in models} } s")
    t0 = time.perf_counter()
    fams = {m: fam for fam in families for m in datasets[fam][0]}
    runs = mesh_spawn([argv + ["--set", f"train.results_dir={SMOKE_RESULTS}/mesh_kg"]
                       for argv in argvs.values()] + [argv for argv, _ in extra],
                      [MESH_SEQ_RUN if fams[m] == "seq" else MESH_KG_RUN for m in argvs]
                      + [shape for _, shape in extra],
                      probe=[True] * len(argvs) + [False] * len(extra),
                      device="cuda:0" if device == "cuda" else device)
    mesh_s = time.perf_counter() - t0
    out = {fam: {"mesh_s": mesh_s, "split": splits[fam],
                 "single_s": {m: singles[m]["s"] for m in datasets[fam][0]}}
           for fam in families}
    out["extra"] = runs[len(argvs):]

    def control(model):
        with gemm_order_control():
            return mesh_single(model, argvs[model], "mesh_ctrl")["best_state"]

    for m, run in zip(argvs, runs):
        fam = fams[m]
        out[fam][m] = r = mesh_kg_check(m, singles[m], run,
                                        control if fam in ("gcf", "seq") else None)
        use = {k: round(v, 3) for k, v in r["param_tol_use"].items()}
        probe = ("no graph to probe" if r["probe_b1_max_rel_err"] is None else
                 f"B1 on its {'shards' if fam in ('kg', 'mb') else 'whole graphs'} within "
                 f"{r['probe_b1_max_rel_err']:.3g} of plain")
        log(f"  {m}: losses {r['losses']}; whole tables' max abs diff {r['param_diff']} "
            f"(share of MESH_PARAM_TOL used: {use}); test "
            f"metrics' max abs diff {r['metric_diff']}; test recall@20 "
            f"{r['test_recall20']:.5f}; launches in each rank {r['want_by_layout']} over "
            f"{r['steps']} steps; in each rank {probe}, B2 exact on {r['probe_b2_layouts']}")
    shapes = sorted({str(MESH_SEQ_RUN if fams[m] == "seq" else MESH_KG_RUN) for m in argvs})
    log(f"  the {' and '.join(shapes)} meshes of 2 gloo processes ran {', '.join(argvs)}"
        + (f" and {len(extra)} other run(s)" if extra else "")
        + f" in {mesh_s:.1f} s (processes, data, {MESH_EPOCHS} epoch each, evaluations, probes)")
    return out


MESH_MB_RUN = MESH_KG_RUN       # phase 37(e): its runs ride 37(d)'s spawn of two gloo ranks
# Phase 37(e)'s depth cut: phase 29's Tmall-shaped split (the same users,
# items, behaviors and held-out buys) with a seeded share of each behavior's
# train pairs, so fewer steps an epoch and fewer KMCLR contrast steps;
# widths, the real Tmall KG and the rule for CML's meta users stay.
MESH_MB_DIR = os.path.join(SMOKE_RESULTS, "mesh_mb")   # its split: <dir>/multi_behavior/tmall/
MESH_MB_TRAIN_SHARE = 0.0625
MESH_MB_B1_TOL = 1e-6       # B1 on a rank's own shard layouts (its probe): max |kernel - plain| /
                            # max |plain|; the whole split's, with rows up to 8x longer, TOL
# the shard layouts phase 37(e) times, by graph and width (each graph's are
# all checked against plain): pv's bidirectional hop, the largest, at
# CML's width
MESH_MB_TIMED = (("beh_pv", 16),)
# and the others too (``chip_kg_mesh.py phase-mb``)
MESH_MB_TIMED_ALL = MESH_MB_TIMED + (("rect_pv_buy.a", 16), ("rect_pv_buy.at", 16),
                                     ("kmclr_buy", 32), ("rect_pv.a", 32), ("rect_pv.at", 32))


def write_mesh_mb_split() -> dict:
    """Phase 37(e)'s split (``MB_DATASET`` under ``MESH_MB_DIR``, the handler
    reading Tmall's behaviors by the name): phase 29's with a seeded
    ``MESH_MB_TRAIN_SHARE`` of each behavior's train pairs, the pairs of the
    last user and the last item among them, its meta paths their
    intersections, the same test pairs; then CML's meta users and the real
    Tmall ``kg.txt`` beside it (:func:`write_mb_extras`)."""
    t0 = time.perf_counter()
    mats, tst = read_mb_split(MB_DATASET)
    rng = np.random.default_rng(37)
    cut = {}
    for b, m in mats.items():
        m = m.tocoo()
        keep = rng.choice(m.nnz, round(m.nnz * MESH_MB_TRAIN_SHARE), replace=False)
        last = np.flatnonzero((m.row == m.shape[0] - 1) | (m.col == m.shape[1] - 1))
        keep = np.union1d(keep, last)
        cut[b] = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    sizes = write_mb_files(MB_DATASET, cut, meta_path_mats(cut), tst, t0, MESH_MB_DIR)
    sizes.update(write_mb_extras(MB_DATASET, MESH_MB_DIR),
                 of={b: int(m.nnz) for b, m in mats.items()})
    return sizes


def mesh_mb_partitions(dev) -> dict:
    """The graphs phase 37(e)'s models partition for a model axis of 2, at
    phase 29's whole split: each behavior's A and AT as one bidirectional
    graph (CML's and KMCLR's, ``beh_<b>``), each behavior's and meta path's
    chained pair apart (SMBRec's and HMGCR's, ``rect_<b>.a`` users ← items,
    ``rect_<b>.at`` items ← users), and KMCLR's buy bi-adjacency
    (``kmclr_buy``), each a ``ShardedGraph`` with its shards' layouts on
    ``dev``, as the models partition them."""
    from sslrec_tpu_torch.data.multi_behavior import behavior_graphs
    mats, _ = read_mb_split(MB_DATASET)
    u, i = mats["buy"].shape
    n_model = MESH_MB_RUN["model"]

    def part(rows, cols, vals):
        g = CooGraph(np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                     np.asarray(vals, np.float32), u + i, u + i)
        return dist_train.partition_graph(g, u, i, n_model)

    sgs = {}
    metas = {k: m for k, m in meta_path_mats(mats).items() if k != "buy"}
    for b, m in {**mats, **metas}.items():
        a, at = (tuple(t.numpy().astype(np.float64 if t.is_floating_point() else np.int64)
                       for t in (g.rows, g.cols, g.vals)) for g in behavior_graphs(m, "cpu"))
        if b in mats:
            sgs[f"beh_{b}"] = part(np.concatenate([a[0], u + at[0]]),
                                   np.concatenate([u + a[1], at[1]]),
                                   np.concatenate([a[2], at[2]]))
        sgs[f"rect_{b}.a"] = part(a[0], u + a[1], a[2])
        sgs[f"rect_{b}.at"] = part(u + at[0], at[1], at[2])
    g = kg_data.MaskableBiAdj(mats["buy"].tocoo(), u, i, "cpu").graph
    sgs["kmclr_buy"] = part(g.rows.numpy(), g.cols.numpy(), np.ones(g.nnz))
    return {k: {"sg": sg, "shards": [dist_train.shard_graph(sg, p, dev) for p in range(n_model)]}
            for k, sg in sgs.items()}


def mesh_mb_hops(errs: ErrTrack, gen, dev) -> dict:
    """Phase 37(e)'s kernels at the whole split's shapes: B1 on each shard of
    :func:`mesh_mb_partitions`, forward and transposed, at widths 16 and 32
    (KMCLR's buy bi-adjacency under seeded values in the original edge
    order, through ``view_vals_partitioned``), against its plain version
    (within ``TOL``, as 37(d)'s whole-split shards; the ranks' own layouts
    are held to ``MESH_MB_B1_TOL`` by their probe) and itself again bit for
    bit; then the
    shards of ``MESH_MB_TIMED`` timed beside their bound (x counted as the
    rows the edges reference), plain version and ``torch.sparse.mm``."""
    parts = mesh_mb_partitions(dev)
    out = {"t": {}, "bound": {}, "shape": {}, "checked": 0}
    mb_errs = ErrTrack()
    timed = dict(MESH_MB_TIMED)
    for name, part in parts.items():
        sg = part["sg"]
        pv = None
        if name == "kmclr_buy":
            pv = dist_train.view_vals_partitioned(
                sg, torch.rand(sg.n_edges, generator=gen, device=dev))
        for p, sh in enumerate(part["shards"]):
            g = sh.graph if pv is None else sh.with_vals(pv[p])
            for tag, lay in (("", g.fwd), ("_t", g.bwd)):
                for d in (16, 32):
                    x = torch.randn(lay.n_cols, d, generator=gen, device=dev)
                    what = f"mesh_mb.{name}.P2.shard{p}{tag}.d{d}"
                    got = sk.csr_spmm(lay, x)
                    check_exact(f"{what}.repeat", sk.csr_spmm(lay, x), got)
                    mb_errs.check(what, got, sk.csr_spmm_plain(lay, x))
                    out["checked"] += 1
                    if timed.get(name) != d:
                        continue
                    k = f"mesh_mb_{name.replace('.', '_')}_P2_shard{p}{tag}_d{d}"
                    x_rows = int(torch.unique(lay.cols).numel())
                    bound = bound_ms(lay, d, x_rows=x_rows)
                    csr = csr_tensor(lay)
                    out["t"][k] = timing(lambda lay=lay, x=x: sk.csr_spmm(lay, x),
                                         lambda lay=lay, x=x: sk.csr_spmm_plain(lay, x),
                                         lambda csr=csr, x=x: torch.sparse.mm(csr, x), bound[0])
                    out["bound"][k] = bound
                    group, t_pick = schedule(lay, d)
                    out["shape"][k] = {"n_rows": lay.n_rows, "n_cols": lay.n_cols,
                                       "x_rows_read": x_rows, "nnz": int(lay.cols.shape[0]),
                                       "d": d, "shards": sg.n_model, "shard": p, "graph": name,
                                       "layout": "transposed" if tag else "forward",
                                       "lane_group": group, "split_threshold": t_pick}
                    log_timing(f"{name} shard {p} of 2{' (transposed)' if tag else ''}, d {d}",
                               out["t"][k], bound)
    if mb_errs.rel > TOL:
        raise AssertionError(f"B1 on the multi-behavior shards: max rel err {mb_errs.rel:.3g} "
                             f"beyond {TOL}")
    errs.abs, errs.rel = max(errs.abs, mb_errs.abs), max(errs.rel, mb_errs.rel)
    sg = parts["beh_pv"]["sg"]
    log(f"  B1 on {out['checked']} shard layouts of {len(parts)} graphs (U_loc {sg.u_loc}, "
        f"I_loc {sg.i_loc}): max abs err {mb_errs.abs:.3g}, max rel err {mb_errs.rel:.3g} "
        f"(tolerance {TOL})")
    out["errs"] = mb_errs
    return out


def mesh_phases(gen, data, cfg, dev, social_refs=None) -> dict:
    """Phase 37: the device mesh, (a) the partitioned hop at full width, (b)
    LightGCN and SGL on a mesh of four gloo ranks on the one card, (c)
    NCCL, (d) the KG family, (e) the multi-behavior family, (f) the models
    of ROADMAP Queue A item 9a and (g) the social five (held to their runs
    of phases 17 and 19, ``social_refs``) on a mesh of two gloo ranks, and
    (h) the sequential six on a 2x1 mesh, in one spawn with (b)'s SGL
    reference."""
    log("== 37. the device mesh: partitioned hops, a 2x2 mesh on the card, NCCL, the KG "
        "and multi-behavior families, item 9a's seven and the social five on a 1x2 mesh, "
        "the sequential six on a 2x1 mesh")
    t0 = time.perf_counter()
    errs = ErrTrack()
    hops = mesh_hops(errs, gen, data, int(cfg.model.embedding_size), dev)
    part = mesh_run(data)
    nccl = mesh_nccl(data, dev)
    kg = mesh_kg_phase(gen, dev, extra=[(part["split_ref_argv"], MESH_SPLIT_REF)],
                       singles=social_refs)
    run = mesh_run_check(data, part, kg.pop("extra")[0])
    log(f"  phase 37 took {time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "hops": hops, "run": run, "nccl": nccl, "kg": kg}


def mesh_kg_phase(gen, dev, families=("kg", "mb", "gcf", "social", "seq"), extra=(),
                  singles=None) -> dict:
    """Phases 37(d) to (h): :func:`mesh_kg_hops` and :func:`mesh_mb_hops`,
    then :func:`mesh_kg_run` of the ``families`` (and the ``extra`` runs,
    given the ``singles``) in one spawn."""
    log("  (d) the KG family, (e) the multi-behavior family, (f) item 9a's seven, (g) "
        "the social five and (h) the sequential six on the mesh")
    t0 = time.perf_counter()
    errs = ErrTrack()
    hops = mesh_kg_hops(errs, gen, dev) if "kg" in families else None
    mb_hops = mesh_mb_hops(errs, gen, dev) if "mb" in families else None
    run = mesh_kg_run(dev.type, families, extra, singles)
    s = time.perf_counter() - t0
    log(f"  phases 37(d) to (h) took {s:.1f} s")
    return {"errs": errs, "hops": hops, "run": run.get("kg"), "s": s,
            "mb": {"hops": mb_hops, "run": run.get("mb")}, "gcf": {"run": run.get("gcf")},
            "social": {"run": run.get("social")}, "seq": {"run": run.get("seq")},
            "extra": run["extra"]}


def mesh_mb_rows(mm: dict, b1_row) -> list[dict]:
    """The kernels line's rows of phase 37(e): B1 on each timed shard layout
    of ``mm["hops"]`` with its launches in the rank holding the shard
    (``mm["run"]``'s counts by layout of the models that partition that
    graph), the last row carrying the runs' summary; ``b1_row`` makes a
    row as ``main`` does."""
    # the models whose mesh runs hop over each timed graph's partition (all
    # their shard layouts share one shape, so a row counts them all)
    graph_models = {"beh_pv": ("cml", "kmclr"), "rect_pv": ("smbrec",),
                    "rect_pv_buy": ("hmgcr",), "kmclr_buy": ("kmclr",)}
    rows = []
    for k, t in mm["hops"]["t"].items():
        shape = mm["hops"]["shape"][k]
        graph, p = shape["graph"], shape["shard"]
        models = graph_models[graph.split(".")[0]]
        counts = sum(mm["run"][m]["by_layout_by_rank"][p].get(shape["layout"], 0)
                     for m in models)
        values = graph == "kmclr_buy"
        rows.append(b1_row(
            f"csr_spmm.{k}", t, mm["hops"]["bound"][k], (counts, None), mm["hops"]["errs"],
            {**shape, "what": f"B1, the Tmall-shaped split's {graph} partition, one of 2 "
                              f"destination shards" + (", under a view's values" if values
                                                       else "")},
            launches_scope=f"the B1 launches on layouts of this shard's {shape['layout']} shape "
                           f"in rank {p} of the {MESH_MB_RUN} mesh runs of {', '.join(models)} "
                           f"({MESH_EPOCHS} epoch each on {MESH_MB_DIR}, whose layouts have "
                           f"this shape and fewer edges; every graph those models partition "
                           f"shares the shape); combine launches not counted apart",
            library_call="torch.sparse.mm on a CSR tensor of the shard's layout"
                         + (", values pre-multiplied" if values else ""),
            launches_of=[f"{m}'s {MESH_MB_RUN} mesh run, rank {p}" for m in models]))
    rows[-1]["mesh_mb"] = {"run": dict(mm["run"]), "checked_layouts": mm["hops"]["checked"]}
    return rows


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
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}")

    log("== 3. B1 against plain")
    t0 = time.perf_counter()
    cfg, data = lightgcn_data(dev)
    g = data.extras["bi_adj"]
    log(f"loaded {DATASET} in {time.perf_counter() - t0:.1f} s: {data.user_num} users, "
        f"{data.item_num} items, {data.n_train} train pairs; bi-adjacency "
        f"{g.n_rows} nodes, {g.nnz} edges")
    errs = ErrTrack()
    gen = torch.Generator(device=dev).manual_seed(0)
    check_graph(errs, "bi_adj", g, (32,), gen, with_grads=True)
    main_abs, main_rel = errs.abs, errs.rel
    check_graph(errs, "bi_adj", g, (1, 8, 17, 33, 64, 65, 128), gen, with_grads=False)
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
    stress = stress_graph(dev)
    stress_errs = ErrTrack()
    check_graph(stress_errs, "stress", stress, (1, 2, 3, 4, 32, 64, 65), gen, with_grads=True,
                ref64=True)
    set_precision(True)         # every row vector in bf16 mode, against the bf16 plain
    check_graph(stress_errs, "stress.bf16", stress, (1, 2, 3, 4, 32, 36, 64, 65), gen,
                with_grads=False, ref64=True)
    set_precision(False)
    for sd in (32, 1):
        splan = sk.layout_plan(stress.fwd, schedule(stress.fwd, sd)[1])
        log(f"stress graph (float64 plain): max abs err {stress_errs.abs:.3g}, max rel err "
            f"{stress_errs.rel:.3g}; at d {sd} {splan.n_chunks} chunks of <= {splan.t} edges, "
            f"{splan.split_rows.numel()} split rows, {splan.empty_rows.numel()} empty; "
            f"combine tree {tree_shape(splan)}")

    log("== 4. B1 timing, LightGCN hop")
    d = int(cfg.model.embedding_size)
    lay = g.fwd
    nnz = g.nnz
    x = torch.randn(g.n_cols, d, generator=gen, device=dev)
    key = torch.tensor([1, 2], device=dev)
    mask = sk.dropout_mask(key, g, 0.5).w
    prf = sk.prf_mask(key, g, 0.5)
    csr_t, csr_m = csr_tensor(lay), csr_tensor(lay, lay.vals * mask)
    csr_mb = csr_tensor(g.bwd, g.bwd.vals * mask[g.bwd.edge_ids.long()])
    launches_before = sk.csr_spmm.launches
    calls = {"none": lambda: sk.csr_spmm(lay, x), "mask": lambda: sk.csr_spmm(lay, x, mask),
             "prf": lambda: sk.csr_spmm(lay, x, prf),
             "mask_bwd": lambda: sk.csr_spmm(g.bwd, x, mask),
             "prf_bwd": lambda: sk.csr_spmm(g.bwd, x, prf)}
    hop_bound = {k: bound_ms(g.bwd if k.endswith("bwd") else lay, d, k.split("_")[0])
                 for k in calls}
    # each mode's floor: the bound without the multiplier, which the library
    # call (values pre-multiplied) does not read
    floor = {k: bound_ms(g.bwd if k.endswith("bwd") else lay, d)[0] for k in calls}
    order = list(calls) + list(calls)[::-1]      # in turns, to show the spread
    repeat = {k: [] for k in calls}
    for k in order:
        repeat[k].append(device_ms(calls[k], floor[k]))
    hop = {
        "none": timing(lambda: sk.csr_spmm(lay, x), lambda: sk.csr_spmm_plain(lay, x),
                       lambda: torch.sparse.mm(csr_t, x), floor["none"]),
        "mask": timing(lambda: sk.csr_spmm(lay, x, mask),
                       lambda: sk.csr_spmm_plain(lay, x, mask),
                       lambda: torch.sparse.mm(csr_m, x), floor["mask"]),
        "prf": timing(lambda: sk.csr_spmm(lay, x, prf), lambda: sk.csr_spmm_plain(lay, x, prf),
                      lambda: torch.sparse.mm(csr_m, x), floor["prf"]),
        "mask_bwd": timing(lambda: sk.csr_spmm(g.bwd, x, mask),
                           lambda: sk.csr_spmm_plain(g.bwd, x, mask),
                           lambda: torch.sparse.mm(csr_mb, x), floor["mask_bwd"]),
        "prf_bwd": timing(lambda: sk.csr_spmm(g.bwd, x, prf),
                          lambda: sk.csr_spmm_plain(g.bwd, x, prf),
                          lambda: torch.sparse.mm(csr_mb, x), floor["prf_bwd"]),
    }
    for k, r in hop.items():
        log_timing(f"LightGCN hop, {k}", r, hop_bound[k])
        log("    again, in turns: " + ", ".join(f"{v * 1e3:.2f}" for v in repeat[k]))
        r["repeat_ms"] = repeat[k]
    assert sk.csr_spmm.launches > launches_before
    group, t_pick = schedule(lay, d)
    log(f"  picked: lane group {group}, split threshold {t_pick} "
        f"({sk.resident_threads(0)} resident threads on the card)")

    log("== 5. LightGCN path")
    argv = ["--model", "lightgcn", "--data_dir", DATA_DIR, "--dataset", DATASET,
            "--epoch", "2", "--device", "cuda", "--set", "train.test_step=1",
            "--set", f"train.results_dir={SMOKE_RESULTS}"]
    sk.csr_spmm.launches = sk.csr_spmm.combine_launches = skn.segment_max.launches = 0
    trainer = port_main.main(argv)
    launches, lgcn_b2 = sk.csr_spmm.launches, skn.segment_max.launches
    lgcn_combine = sk.csr_spmm.combine_launches
    rows = trainer.recorder.epochs
    steps = len(rows) * trainer.n_batches
    log(f"kernel launches {launches} over {steps} steps "
        f"({launches / steps:.2f} per step, incl. evaluation), "
        f"{lgcn_combine} of them with the split rows' combine")
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
    kg_ops = kgcl_shapes(dev)
    kg_cfg, kg_cpu = kg_ops["cfg"], kg_ops["data"]
    ex = kg_cpu.extras
    bi = ex["bi_adj_maskable"]
    log(f"wrote and loaded {KG_DATASET} in {time.perf_counter() - t0:.1f} s: "
        f"{kg_cpu.user_num} users, {kg_cpu.item_num} items, {kg_cpu.n_train} train pairs, "
        f"{kg_cpu.test.n_test_users} test users; {ex['kg_triplets_full'].shape[0]} triplets "
        f"over {ex['entity_num']} entities and {ex['relation_num']} relations, "
        f"{ex['kg_heads'].shape[0]} kept by the per-head cap; UI bi-adjacency "
        f"{bi.n_nodes} nodes, {bi.graph.nnz} edges")
    seg_lay, deg_lay, ui, ui_w = (kg_ops[k] for k in ("seg", "deg", "ui", "ui_w"))
    seg_errs = ErrTrack()
    b2_stress = check_segment_ops(seg_errs, seg_lay, gen)
    log(f"B2 bit for bit in every case (KGCL's heads: {b2_shape(seg_lay)}); B1 segment ops "
        f"max abs err {seg_errs.abs:.3g}, max rel err {seg_errs.rel:.3g} (tolerance {TOL})")
    rel = skn.OneHotTake(ex["kg_rels"], ex["relation_num"], dev)
    rel_errs = ErrTrack()
    check_relation_take(rel_errs, rel, int(kg_cfg.model.embedding_size), gen)
    ui_errs = ErrTrack()
    check_graph(ui_errs, "kgcl_ui", ui, (64,), gen, with_grads=True)

    log("== 7. KGCL shapes timing")
    kg, kg_bound = time_kgcl_shapes(seg_lay, deg_lay, ui, ui_w, rel.layout, b2_stress, gen)
    for k, r in kg.items():
        log_timing(k, r, kg_bound[k])
    rt = kg["relation_take"]
    log(f"  relation take backward: B1 {rt['ms'] * 1e3:.2f} us, index_put_ "
        f"{rt['library_ms'] * 1e3:.2f} us, one-hot GEMM {rt['onehot_ms'] * 1e3:.2f} us "
        f"({rt['onehot_mb']:.1f} MB one-hot)")

    log("== 8. KGCL path")
    argv = ["--model", "kgcl", "--data_dir", SMOKE_RESULTS, "--dataset", KG_DATASET,
            "--epoch", "2", "--device", "cuda", "--set", "train.test_step=1",
            "--set", f"train.results_dir={SMOKE_RESULTS}"]
    sk.csr_spmm.launches = sk.csr_spmm.combine_launches = skn.segment_max.launches = 0
    kg_trainer = port_main.main(argv)
    kg_b1, kg_b2 = sk.csr_spmm.launches, skn.segment_max.launches
    kg_combine = sk.csr_spmm.combine_launches
    kg_rows = kg_trainer.recorder.epochs
    kg_steps = len(kg_rows) * kg_trainer.n_batches
    n_evals = len(kg_rows) + 2      # every epoch, best valid, test
    want_b1 = KGCL_B1_PER_STEP * kg_steps + 6 * len(kg_rows) + 5 * n_evals
    want_b2 = KGCL_B2_PER_STEP * kg_steps + 4 * len(kg_rows) + 2 * n_evals
    log(f"launches over {kg_steps} steps: B1 {kg_b1} ({kg_b1 / kg_steps:.2f} per step; "
        f"{want_b1} counted from the code; {kg_combine} with the split rows' combine), "
        f"B2 {kg_b2} ({kg_b2 / kg_steps:.2f} per step; {want_b2} counted from the code)")
    if (kg_b1, kg_b2) != (want_b1, want_b2):
        raise AssertionError(f"KGCL launched B1 {kg_b1}, B2 {kg_b2} times; the code "
                             f"counts {want_b1} and {want_b2}")
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
    # the reference runs in float64: the RGAT's row normalisation magnifies
    # float32 rounding where a head's attention sum nearly cancels, and a
    # float32 reference on the CPU, whose rounding varies with the host, has
    # read over the tolerance against the same training
    cpu_model = build_model(kg_cfg, kg_cpu)
    cpu_model.load_state_dict({k: v.cpu() for k, v in kg_trainer.model.state_dict().items()})
    cpu_model.double()
    with torch.no_grad():
        gu, gi = kg_trainer.model.generate()
        cu, ci = cpu_model.generate()
    got, ref = torch.cat([gu, gi]).cpu().double(), torch.cat([cu, ci])
    errs.check("kgcl.generate", got, ref)
    log(f"  trained embeddings {tuple(gu.shape)} + {tuple(gi.shape)} finite, = the same "
        f"forward on the CPU's plain versions in float64 (rel err {rel_err(got, ref):.3g})")
    kgcl_small_step_check(errs)

    log("== 9. B1 against plain, the self-supervised models' shapes")
    plain, lgcl = ssl_graphs(data, dev)
    ssl_errs = ErrTrack()
    check_graph(ssl_errs, "dccf_plain", plain, (32,), gen, with_grads=True)
    check_graph(ssl_errs, "lightgcl_rect", lgcl, (32, 13), gen, with_grads=True)
    log(f"max abs err {ssl_errs.abs:.3g}, max rel err {ssl_errs.rel:.3g} (tolerance {TOL}); "
        f"DCCF's plain layouts read no vals: {plain.fwd.vals_ones and plain.bwd.vals_ones}")

    log("== 10. the self-supervised models' shapes timing")
    ssl_t, ssl_bound = time_ssl_shapes(plain, lgcl, gen)
    for k, r in ssl_t.items():
        log_timing(k, r, ssl_bound[k])

    log("== 11. the self-supervised general_cf paths")
    ssl_runs = ssl_paths(errs)

    log("== 12. B1 on layouts built on the card: AutoCF's and GFormer's views")
    t0 = time.perf_counter()
    ops = view_operands(data, dev)
    ac, gf = ops["autocf"]["view"], ops["gformer"]["view"]
    log(f"built one AutoCF view and one GFormer view in {time.perf_counter() - t0:.1f} s: "
        f"AutoCF decoder {ac['dec'][0].n} edges (kept {int(ac['keep'].sum())} of "
        f"{ops['autocf']['model'].nnz}); GFormer augmented {gf['aug'].nnz} edges, decoder "
        f"{gf['dec_seg'][0].n}")
    n_lay = check_layout_builds("autocf", {}, {"dec_rows": ac["dec"][0], "dec_cols": ac["dec"][1]})
    n_lay += check_layout_builds("gformer", {"aug": gf["aug"]},
                                 {"aug_rows": gf["aug_seg"][0], "aug_cols": gf["aug_seg"][1],
                                  "dec_rows": gf["dec_seg"][0], "dec_cols": gf["dec_seg"][1]})
    log(f"{n_lay} layouts built on the card equal the host builds of the same edges, field "
        f"for field, split plans included")
    view_errs = ErrTrack()
    check_segment_b1(view_errs, "autocf_dec_rows", ac["dec"][0], (32, 4), gen)
    check_segment_b1(view_errs, "autocf_dec_cols", ac["dec"][1], (32,), gen)
    check_segment_b1(view_errs, "gformer_aug_rows", gf["aug_seg"][0], (32, 4), gen)
    check_segment_b1(view_errs, "gformer_aug_cols", gf["aug_seg"][1], (32,), gen)
    check_segment_b1(view_errs, "gformer_dec_rows", gf["dec_seg"][0], (32, 4), gen)
    check_segment_b1(view_errs, "gformer_dec_cols", gf["dec_seg"][1], (32,), gen)
    # AdaGCL's gate degrees: a d 1 segment sum over the bi-adjacency's rows
    bi = data.extras["bi_adj"]
    ops["adagcl"] = {"gate_rows": skn.build_segment_layout(bi.rows, bi.n_rows, dev)}
    check_segment_b1(view_errs, "adagcl_gate_rows", ops["adagcl"]["gate_rows"], (1,), gen)
    check_graph(view_errs, "gformer_aug", gf["aug"], (32, 1), gen, with_grads=True)
    xv = torch.randn(gf["aug"].n_cols, 32, generator=gen, device=dev)
    xk, xp = xv.clone().requires_grad_(), xv.clone().requires_grad_()
    w_out = torch.randn(gf["aug"].n_rows, 32, generator=gen, device=dev)
    yk = sk.SpmmPvFn.apply(gf["aug"], xk, gf["enc_vals"])
    (yk * w_out).sum().backward()
    yp = sk.csr_spmm_plain(gf["aug"].fwd, xp, gf["enc_vals"])
    (yp * w_out).sum().backward()
    view_errs.check("gformer_aug.enc_vals", yk.detach(), yp.detach())
    view_errs.check("gformer_aug.enc_vals.dx", xk.grad, xp.grad)
    log(f"max abs err {view_errs.abs:.3g}, max rel err {view_errs.rel:.3g} (tolerance {TOL})")

    log("== 13. the views' shapes timing")
    view_t, view_bound = time_view_shapes(ops, gen)
    for k, r in view_t.items():
        log_timing(k, r, view_bound[k])
    builds = time_layout_builds(ops)
    for k, r in builds.items():
        log(f"  {k} layouts ({r['layouts']}): built on the card {r['device_ms']:.2f} ms, "
            f"on the host {r['host_ms']:.2f} ms (host clock, median of 5)")
    ops_gate = ops["adagcl"]["gate_rows"]
    del ops

    log("== 14. AutoCF, GFormer and AdaGCL paths")
    view_runs = ssl_paths(errs, models=VIEW_MODELS)

    log("== 15. B1 against plain, the social paths' shapes (yelp_sub)")
    t0 = time.perf_counter()
    soc = social_operands(dev)
    dc = soc["dcrec"]
    log(f"loaded yelp_sub for DcRec, DSL and MHCN in {time.perf_counter() - t0:.1f} s: "
        f"{dc.user_num} users, {dc.item_num} items, {dc.ui.nnz} train pairs, "
        f"{dc.trust.nnz} trust edges; bi-adjacency {soc['bi'].n_rows} nodes, {soc['bi'].nnz} "
        f"edges; a UI view drops {int((soc['drop_w'] == 0).sum())} and adds "
        f"{soc['added'].nnz}; MHCN channels nnz {soc['h_s'].nnz}, {soc['h_j'].nnz}, "
        f"{soc['h_p'].nnz}, R {soc['r'].nnz}")
    n_lay = check_layout_builds("dcrec", {"ui": soc["ui"], "trust": soc["trust"],
                                          "ui_added": soc["added"]}, {}, widths=(64, 1))
    log(f"{n_lay} layouts built on the card equal the host builds of the same edges, "
        f"split plans included")
    soc_errs = ErrTrack()
    check_graph(soc_errs, "yelp_bi", soc["bi"], (64,), gen, with_grads=True)
    check_graph(soc_errs, "yelp_trust_norm", soc["uu"], (64,), gen, with_grads=True)
    check_graph(soc_errs, "dcrec_trust", soc["trust"], (64, 1), gen, with_grads=True)
    check_graph(soc_errs, "dcrec_ui", soc["ui"], (64, 1), gen, with_grads=True)
    check_graph(soc_errs, "dcrec_ui_added", soc["added"], (64, 1), gen, with_grads=True)
    for ch in ("r", "h_s", "h_j", "h_p"):
        check_graph(soc_errs, f"mhcn_{ch}", soc[ch], (64,), gen, with_grads=True)
    log(f"max abs err {soc_errs.abs:.3g}, max rel err {soc_errs.rel:.3g} (tolerance {TOL})")

    log("== 16. the social paths' shapes timing")
    soc_t, soc_bound = time_social_shapes(soc, gen)
    for k, r in soc_t.items():
        log_timing(k, r, soc_bound[k])
    ui_rows, ui_cols, n_u, n_i = dc.ui_rows, dc.ui_cols, dc.user_num, dc.item_num
    add_rows, add_cols = soc["added"].rows, soc["added"].cols
    build = {"device_ms": wall_ms(lambda: sk.csr_graph_from_edges(add_rows, add_cols, n_u, n_i)),
             "host_ms": wall_ms(lambda: host_graph_layouts(add_rows, add_cols, n_u, n_i, dev))}
    log(f"  a view's added-edge layouts ({soc['added'].nnz} edges, both directions): built "
        f"on the card {build['device_ms']:.2f} ms, on the host {build['host_ms']:.2f} ms "
        f"(host clock, median of 5)")
    soc_shapes = {k: (soc[k].n_rows, soc[k].n_cols, soc[k].nnz)
                  for k in ("bi", "trust", "ui", "added", "r", "h_s", "h_j", "h_p")}
    del soc, dc, ui_rows, ui_cols, add_rows, add_cols

    log("== 17. DcRec, MHCN and DSL paths (yelp_sub)")
    social_refs = {}        # the five's single runs, which phase 37(g) holds its mesh runs to
    soc_runs = ssl_paths(errs, dataset=SOCIAL_DATASET, models=SOCIAL_MODELS, refs=social_refs)

    log("== 18. the tuner and resume on the card")
    sports = write_sports_split()
    tr = tune_and_resume()

    ks = kcgn_smin_phases(errs, gen, social_refs)
    kgp = kg_phases(errs, gen, dev)
    seq = seq_phases(errs, gen, data.extras["bi_adj"], seg_lay, (launches, lgcn_combine), sports)
    kgn = kg_new_phases(errs, gen, dev)
    mbp = mb_phases(errs, gen)
    newt = new_shapes_timing(kgn, mbp, gen)

    mbn = mb_new_phases(errs, gen)
    mbt = mb_new_timing(mbn, gen)
    lanes_steps = {"lightgcn": -(-data.n_train // int(cfg.train.batch_size)),
                   "dccf": ssl_runs["dccf"]["n_batches"], "kcgn": ks["runs"]["kcgn"]["n_batches"]}
    lp = lanes_phases(errs, gen, data, lanes_steps, dev)
    llp = last_lanes_phases(gen, dev)

    mesh = mesh_phases(gen, data, cfg, dev, social_refs)

    log("== 38. result")
    common = {"route": "cuda", "source": "sslrec_tpu_torch/csrc/csr_spmm.cu",
              "replaces": "sslrec_tpu/ops/pallas_spmm.py:123",
              "replaces_fn": "sslrec_tpu/ops/pallas_spmm.py::_spmm_kernel"}

    def b1_row(name, r, bound, path_launches, err, shape, **more):
        return {"name": name, **common, "launches": path_launches[0],
                "combine_launches": path_launches[1],
                "launches_scope": "launches of B1's chunk kernel (spmm_chunks, or "
                                  "spmm_narrow at d <= 4; one per B1 call) and of "
                                  "combine_tree (combine_launches: one per call over a "
                                  "layout with split rows at d > 4; spmm_narrow sums its "
                                  "own tree) in the path's 2-epoch run",
                "max_abs_err": err.abs, "max_rel_err": err.rel, "shape": shape,
                **r, "bound_ms": bound[0], "bound_by": bound[1], **more}

    def b2_row(name, r, bound, path_launches, shape, **more):
        return {"name": name, "route": "cuda", "source": "sslrec_tpu_torch/csrc/segment_max.cu",
                "replaces": "sslrec_tpu/ops/pallas_segment.py:137",
                "replaces_fn": "sslrec_tpu/ops/pallas_segment.py::_segmax_kernel",
                "launches": path_launches, "max_abs_err": 0.0, "shape": shape, **r,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_call": "Tensor.scatter_reduce_(0, ids, data, 'amax', "
                                "include_self=False) into a -inf-filled tensor (the plain "
                                "version's own call)", **more}

    hop_shape = {"n_rows": lay.n_rows, "n_cols": lay.n_cols, "nnz": nnz, "d": d,
                 "lane_group": group, "split_threshold": t_pick}
    lgcn_err = ErrTrack()
    lgcn_err.abs, lgcn_err.rel = main_abs, main_rel
    lgcn_counts, kg_counts = (launches, lgcn_combine), (kg_b1, kg_combine)
    ssl_runs = {**ssl_runs, **view_runs, **soc_runs, **ks["runs"], **kgp["runs"],
                **seq["runs"], **kgn["runs"], **mbp["runs"], **mbn["runs"]}
    ssl_b1 = sum(r["launches"] for r in ssl_runs.values())
    ssl_combine = sum(r["combine_launches"] for r in ssl_runs.values())
    b1 = b1_row("csr_spmm", hop["none"], hop_bound["none"],
                (launches + kg_b1 + ssl_b1, lgcn_combine + kg_combine + ssl_combine),
                lgcn_err, hop_shape,
                launches_by_path={"lightgcn": launches, "kgcl": kg_b1,
                                  **{k: r["launches"] for k, r in ssl_runs.items()}},
                combine_launches_by_path={"lightgcn": lgcn_combine, "kgcl": kg_combine,
                                          **{k: r["combine_launches"]
                                             for k, r in ssl_runs.items()}},
                launches_per_step={"lightgcn": launches / steps, "kgcl": kg_b1 / kg_steps,
                                   **{k: r["per_step"] for k, r in ssl_runs.items()}},
                max_rel_err_all_checks=max(errs.rel, seg_errs.rel, rel_errs.rel,
                                           ui_errs.rel, ssl_errs.rel, view_errs.rel,
                                           soc_errs.rel, ks["errs"].rel, kgp["errs"].rel,
                                           seq["errs"].rel, kgn["errs"].rel, mbp["errs"].rel,
                                           mbn["errs"].rel, lp["errs"].rel, llp["errs"].rel,
                                           mesh["errs"].rel,
                                           *(e["max_rel_err"] for e in seq["bf16_err"].values())),
                stress={"max_abs_err": stress_errs.abs, "max_rel_err": stress_errs.rel,
                        "reference": "plain version in float64"},
                library_call="torch.sparse.mm on a CSR tensor of the layout")
    rows_b1 = [b1]
    for k in ("mask", "prf", "mask_bwd", "prf_bwd"):
        rows_b1.append(b1_row(
            f"csr_spmm.lightgcn_hop_{k}", hop[k], hop_bound[k], lgcn_counts, lgcn_err,
            {**hop_shape, "layout": "transposed" if k.endswith("bwd") else "forward"},
            library_call="torch.sparse.mm on a CSR tensor whose values already carry "
                         "the mask (the mask's product and the PRF are not timed)"))
    seg_shape = {"n": seg_lay.n, "num_segments": seg_lay.num_segments}
    rows_b1.append(b1_row("csr_spmm.kg_sum_d65", kg["kg_sum_d65"], kg_bound["kg_sum_d65"],
                          kg_counts, seg_errs, {**seg_shape, "d": 65},
                          library_call="torch.sparse.mm on the segment layout"))
    rows_b1.append(b1_row("csr_spmm.kg_sum_d1", kg["kg_sum_d1"], kg_bound["kg_sum_d1"],
                          kg_counts, seg_errs,
                          {"n": deg_lay.n, "num_segments": deg_lay.num_segments, "d": 1},
                          library_call="torch.sparse.mm on the degree layout"))
    rows_b1.append(b1_row("csr_spmm.kgcl_ui_hop_d64", kg["ui_hop_d64"],
                          kg_bound["ui_hop_d64"], kg_counts, ui_errs,
                          {"n_rows": ui.n_rows, "nnz": ui.nnz, "d": 64},
                          library_call="torch.sparse.mm on a CSR tensor whose values "
                                       "already carry the view's values"))
    rows_b1.append(b1_row("csr_spmm.relation_take_bwd", kg["relation_take"],
                          kg_bound["relation_take"], kg_counts, rel_errs,
                          {"n": rel.layout.n, "num_segments": rel.layout.num_segments,
                           "d": 64},
                          library_call="zeros.index_put_((ids,), g, accumulate=True), the "
                                       "call autograd makes for an index's backward; "
                                       "onehot_ms: the one-hot GEMM onehot.T @ g"))
    dccf_counts = tuple(ssl_runs["dccf"][k] for k in ("launches", "combine_launches"))
    lgcl_counts = tuple(ssl_runs["lightgcl"][k] for k in ("launches", "combine_launches"))
    sparse_mm = "torch.sparse.mm on a CSR tensor of the layout"
    for k, counts, shape, more in (
            ("dccf_hop", dccf_counts, plain.fwd, {
                "library_call": "torch.sparse.mm on a CSR tensor whose values already "
                                "carry the learned weight"}),
            ("dccf_hop_t", dccf_counts, plain.bwd, {
                "library_call": "torch.sparse.mm on a CSR tensor whose values already "
                                "carry the learned weight"}),
            ("lightgcl_d32", lgcl_counts, lgcl.fwd, {"library_call": sparse_mm}),
            ("lightgcl_d32_t", lgcl_counts, lgcl.bwd, {"library_call": sparse_mm}),
            ("lightgcl_d13", lgcl_counts, lgcl.fwd, {"library_call": sparse_mm}),
            ("lightgcl_d13_t", lgcl_counts, lgcl.bwd, {"library_call": sparse_mm})):
        d_k = 13 if "d13" in k else 32
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", ssl_t[k], ssl_bound[k], counts, ssl_errs,
            {"n_rows": shape.n_rows, "n_cols": shape.n_cols, "nnz": shape.cols.shape[0],
             "d": d_k, "layout": "transposed" if k.endswith("_t") else "forward",
             "vals_ones": shape.vals_ones}, **more))
    rows_b1[-6]["dew"] = {
        "what": "the learned weight's gradient vals[e]*<g[row_e], x[col_e]>, plain torch "
                "in SpmmFn.backward (not a kernel), at DCCF's plain graph, d 32",
        **{k: v for k, v in ssl_t["dccf_dew"].items()},
        "bound_ms": ssl_bound["dccf_dew"][0], "bound_by": ssl_bound["dccf_dew"][1],
        "library_call": "torch.sparse.sampled_addmm(pattern, g, x.T, beta=0)"}
    ac_counts = tuple(view_runs["autocf"][k] for k in ("launches", "combine_launches"))
    gf_counts = tuple(view_runs["gformer"][k] for k in ("launches", "combine_launches"))
    for k, counts, lay, d, call in (
            ("autocf_dec_sum_d32", ac_counts, ac["dec"][0].csr, 32, sparse_mm),
            ("autocf_dec_sum_d4", ac_counts, ac["dec"][0].csr, 4, sparse_mm),
            ("autocf_dec_take_bwd_d32", ac_counts, ac["dec"][1].csr, 32,
             sparse_mm + "; index_put_ms: zeros.index_put_((ids,), g, accumulate=True), the "
                         "call autograd makes for an index's backward"),
            ("gformer_aug_hop", gf_counts, gf["aug"].fwd, 32,
             "torch.sparse.mm on a CSR tensor whose values already carry the view's values"),
            ("gformer_aug_hop_t", gf_counts, gf["aug"].bwd, 32,
             "torch.sparse.mm on a CSR tensor whose values already carry the view's values"),
            ("gformer_dec_sum_d32", gf_counts, gf["dec_seg"][0].csr, 32, sparse_mm),
            ("gformer_dec_take_bwd_d32", gf_counts, gf["dec_seg"][1].csr, 32,
             sparse_mm + "; index_put_ms: zeros.index_put_((ids,), g, accumulate=True)")):
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", view_t[k], view_bound[k], counts, view_errs,
            {"n_rows": lay.n_rows, "n_cols": lay.n_cols, "nnz": lay.cols.shape[0], "d": d,
             "built_on": "the card"}, library_call=call))
    rows_b1[-7]["layout_build"] = builds
    gate = ops_gate.csr
    rows_b1.append(b1_row(
        "csr_spmm.adagcl_gate_deg_d1", view_t["adagcl_gate_deg_d1"],
        view_bound["adagcl_gate_deg_d1"],
        tuple(view_runs["adagcl"][k] for k in ("launches", "combine_launches")), view_errs,
        {"n_rows": gate.n_rows, "n_cols": gate.n_cols, "nnz": gate.cols.shape[0], "d": 1,
         "what": "AdaGCL's gate degrees: the denoise net's gates summed over each row of the "
                 "bi-adjacency"}, library_call=sparse_mm))
    soc_rows = {  # key: (operand, width, the paths whose runs launch B1 there, library call)
        "yelp_bi_hop_d64": ("bi", 64, ("dcrec", "dsl"), sparse_mm),
        "dcrec_trust_hop_t_d64": ("trust", 64, ("dcrec",), "torch.sparse.mm on a CSR tensor "
                                  "whose values already carry the view's values"),
        "dcrec_ui_view_d64": ("ui", 64, ("dcrec",), "torch.sparse.mm, values pre-multiplied"),
        "dcrec_ui_view_t_d64": ("ui", 64, ("dcrec",), "torch.sparse.mm, values pre-multiplied"),
        "dcrec_added_hop_d64": ("added", 64, ("dcrec",), "torch.sparse.mm, values "
                                "pre-multiplied"),
        "dcrec_added_hop_t_d64": ("added", 64, ("dcrec",), "torch.sparse.mm, values "
                                  "pre-multiplied"),
        "dcrec_view_deg_d1": ("ui", 1, ("dcrec",), "torch.sparse.mm, values pre-multiplied"),
        "mhcn_r_d64": ("r", 64, ("mhcn",), sparse_mm),
        "mhcn_r_t_d64": ("r", 64, ("mhcn",), sparse_mm),
        **{f"mhcn_{ch}_d64": (ch, 64, ("mhcn",), sparse_mm) for ch in ("h_s", "h_j", "h_p")}}
    for k, (op, d_k, paths, call) in soc_rows.items():
        n_r, n_c, nnz_k = soc_shapes[op]
        if "_t_" in k:
            n_r, n_c = n_c, n_r
        counts = (sum(soc_runs[p]["launches"] for p in paths),
                  sum(soc_runs[p]["combine_launches"] for p in paths))
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", soc_t[k], soc_bound[k], counts, soc_errs,
            {"n_rows": n_r, "n_cols": n_c, "nnz": nnz_k, "d": d_k,
             "layout": "transposed" if "_t_" in k else "forward",
             **({"built_on": "the card"} if op == "added" else {})},
            library_call=call, launches_of=list(paths)))
        if k == "dcrec_added_hop_d64":
            rows_b1[-1]["layout_build"] = build
    for k, op, d_k, layout in KCGN_SMIN_SHAPES + KG_SHAPES:
        model = k.split("_")[0]
        paths = {"kcgn": ("kcgn",), "smin": ("smin",), "kgin": ("kgin",),
                 "kgrec": ("kgrec",), "kg": KG_MODELS}[model]
        ph = ks if model in KCGN_SMIN else kgp
        counts = (sum(ssl_runs[p]["launches"] for p in paths),
                  sum(ssl_runs[p]["combine_launches"] for p in paths))
        n_r, n_c, nnz_k = ph["shapes"][op]
        if layout == "bwd":
            n_r, n_c = n_c, n_r
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", ph["t"][k], ph["bound"][k], counts, ph["errs"],
            {"n_rows": n_r, "n_cols": n_c, "nnz": nnz_k, "d": d_k,
             "layout": {"seg": "segment layout", "fwd": "forward",
                        "bwd": "transposed"}[layout]},
            library_call=sparse_mm, launches_of=list(paths)))
    for k, r in seq["t"].items():
        model = "maerec" if "maerec" in k else "dcrec_seq"
        counts = (ssl_runs[model]["launches"], ssl_runs[model]["combine_launches"])
        err, more = seq["errs"], {"launches_of": [model]}
        if k.startswith("bf16_"):
            err = ErrTrack()
            be = seq["bf16_err"][k[5:]]
            err.abs, err.rel = be["max_abs_err"], be["max_rel_err"]
            rows = ("x cast to bf16 rows in the call" if r["bf16_rows"] else
                    "float32 rows of x rounded to bf16 as they load")
            more = {"precision": f"bf16 mode (SSLREC_PALLAS_PRECISION=default): {rows}, each "
                                 "product a packed bf16 multiply, summed in float32",
                    "max_rel_err_vs_f32_plain": be["max_rel_err_vs_f32"],
                    "bf16_checks": seq["bf16_err"],
                    "f32_ms": r["f32_ms"], "f32_cold_ms": r["f32_cold_ms"],
                    "bound_note": "the function's bound: x read once as float32, out written "
                                  "once (a cast of x, where the call makes one, is part of it)",
                    "bf16_tie_case": seq["bf16_ties"]}
            # the bf16 kernels' launches: the bf16 mode's path, LightGCN
            p = seq["bf16_path"]
            counts = (p["launches"], p["combine_launches"])
            more.update(launches_of=["lightgcn (bf16 mode, 2 epochs)"], bf16_path=p)
        n_r, n_c, nnz_k, d_k = seq["shapes"][k[5:] if k.startswith("bf16_") else k]
        vals = "" if k.endswith("spread_d1") else " whose values already carry the call's values"
        r = dict(r)
        call = r.pop("library_call", f"torch.sparse.mm on a CSR tensor of the layout{vals}")
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", r, seq["bound"][k], counts, err,
            {"n_rows": n_r, "n_cols": n_c, "nnz": nnz_k, "d": d_k,
             "layout": "segment layout" if "segment" in k else
                       "transposed" if "_t_" in k or k.endswith("_t") else "forward"},
            library_call=call, **more))
    rows_b1[-1]["sequential"] = {"split": seq["split"], "sizes": seq["sizes"],
                                 "runs": seq["runs"]}
    kg_shape = {**kgn["shapes"], **{k: (g.n_rows, g.n_cols, g.nnz)
                                    for k, g in mbp["graphs"].items()}}
    new_shapes = [(k, op, d_k, layout, ("diffkg",)) for k, op, d_k, layout in DIFFKG_SHAPES]
    new_shapes.append(("diffkg_ui_hop_d64", None, 64, "fwd", ("diffkg",)))
    new_shapes += [(k, op, d_k, layout, ("hmgcr",) if k.startswith("hmgcr") else
                    ("mbgmn", "smbrec") if "d32" in k else ("mbgmn",))
                   for k, op, d_k, layout in MB_SHAPES]
    for k, op, d_k, layout, paths in new_shapes:
        counts = (sum(ssl_runs[p]["launches"] for p in paths),
                  sum(ssl_runs[p]["combine_launches"] for p in paths))
        if op is None:          # the UI hop: the bi-adjacency under the all-ones view's values
            g = kgn["model"].bi.graph
            shape = {"n_rows": g.n_rows, "n_cols": g.n_cols, "nnz": g.nnz, "d": d_k,
                     "layout": "forward"}
            call = "torch.sparse.mm on a CSR tensor whose values already carry the view's values"
        else:
            n_r, n_c, nnz_k = kg_shape[op]
            if layout == "bwd":
                n_r, n_c = n_c, n_r
            shape = {"n_rows": n_r, "n_cols": n_c, "nnz": nnz_k, "d": d_k,
                     "layout": {"seg": "segment layout", "fwd": "forward",
                                "bwd": "transposed"}[layout]}
            call = sparse_mm
        if op is not None and op.startswith("dkg"):
            shape["built_on"] = "the card, each epoch"
        rows_b1.append(b1_row(f"csr_spmm.{k}", newt["t"][k], newt["bound"][k], counts,
                              kgn["errs"] if k.startswith("diffkg") else mbp["errs"], shape,
                              library_call=call, launches_of=list(paths)))
    rows_b1[-1]["multi_behavior"] = {"split": mbp["sizes"], "runs": mbp["runs"]}
    for k, op, d_k, layout in CML_SHAPES:
        g = mbn["graphs"][op]
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", mbt["t"][k], mbt["bound"][k],
            (mbn["runs"]["cml"]["launches"], mbn["runs"]["cml"]["combine_launches"]),
            mbn["errs"], {"n_rows": g.n_rows, "n_cols": g.n_cols, "nnz": g.nnz, "d": d_k,
                          "layout": "forward"},
            library_call=sparse_mm, launches_of=["cml"]))
    for k, op, d_k, _ in KMCLR_SEG_SHAPES:
        lay = mbn["segs"][op]
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", mbt["t"][k], mbt["bound"][k],
            (mbn["runs"]["kmclr"]["launches"], mbn["runs"]["kmclr"]["combine_launches"]),
            mbn["errs"], {"n": lay.n, "num_segments": lay.num_segments, "d": d_k,
                          "layout": "segment layout",
                          "what": "the backward of the gather of KMCLR's per-item "
                                  + ("entity" if "ent" in k else "relation") + " lists"},
            library_call=sparse_mm, launches_of=["kmclr"]))
    g = mbn["graphs"]["kmclr_bi"]
    for k in ("kmclr_bi_view_d32", "kmclr_bi_view_t_d32"):
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", mbt["t"][k], mbt["bound"][k],
            (mbn["runs"]["kmclr"]["launches"], mbn["runs"]["kmclr"]["combine_launches"]),
            mbn["errs"], {"n_rows": g.n_rows, "n_cols": g.n_cols, "nnz": g.nnz, "d": 32,
                          "layout": "transposed" if "_t_" in k else "forward",
                          "what": "the buy bi-adjacency under a make_views view's values"},
            library_call="torch.sparse.mm on a CSR tensor whose values already carry the "
                         "view's values", launches_of=["kmclr"]))
    rows_b1[-1]["cml_kmclr"] = {"data": mbn["extras"], "runs": mbn["runs"],
                                "kmclr_hook_s": mbt["hook_s"]}
    lane_grids = lp["grids"]
    rows_b1.append(b1_row(
        "csr_spmm.lightgcn_hop_lanes3_d96", lp["t96"], lp["bound96"],
        (lane_grids["lightgcn"]["lanes"]["launches"],
         lane_grids["lightgcn"]["lanes"]["combine_launches"]), lp["errs"],
        {**hop_shape, "d": 96, "lane_group": lp["t96"]["lane_group"],
         "split_threshold": lp["t96"]["split_threshold"],
         "what": "the LightGCN hop under tune.parallel's 3-lane fold: 3 lanes of d 32 laid "
                 "side by side as one [n, 96] operand"},
        library_call="torch.sparse.mm on a CSR tensor of the layout at d 96; three_d32_ms: "
                     "three B1 calls at d 32, the three lanes one at a time",
        launches_of=["lightgcn grid with tune.parallel=3"],
        lanes={"checked_k_and_mode": lp["checked"], "grids": grid_summary(lane_grids)}))
    last_grids = llp["grids"]
    for key, f in llp["folds"].items():
        model = "smbrec" if key.startswith("tmall") else "dcrec_seq"
        paths = ("mbgmn", "smbrec") if model == "smbrec" else ("dcrec_seq",)
        counts = (sum(last_grids[p]["lanes"]["launches"] for p in paths),
                  sum(last_grids[p]["lanes"]["combine_launches"] for p in paths))
        rows_b1.append(b1_row(
            f"csr_spmm.{key}", f["t"], f["bound"], counts, llp["errs"],
            {**f["shape"], "layout": "forward", "lane_group": f["t"]["lane_group"],
             "split_threshold": f["t"]["split_threshold"],
             "what": f"tune.parallel's {LANE_K}-lane fold: {LANE_K} lanes of d "
                     f"{f['shape']['d'] // LANE_K} as one operand"
                     + ("" if model == "smbrec" else ", the call's values")},
            library_call="torch.sparse.mm on a CSR tensor of the layout at the fold's width"
                         + ("" if model == "smbrec" else ", values pre-multiplied")
                         + f"; lanes_d{f['shape']['d'] // LANE_K}_ms: {LANE_K} B1 calls at "
                         "the lane's width, one lane at a time",
            launches_of=[f"{p} grid with tune.parallel={LANE_K}" for p in paths]))
    rows_b1[-1]["last_lanes"] = {
        "steps": llp["steps"], "timed": llp["timed"], "n_batches": llp["n_batches"],
        "grids": grid_summary(last_grids)}
    mr = mesh["run"]
    n_model, world = MESH_RUN["model"], MESH_RUN["data"] * MESH_RUN["model"]

    def mesh_counts(models, layout, ranks):
        """B1's (launches, combine launches) on ``layout`` in ``ranks`` of the
        ``models``' mesh runs."""
        return tuple(sum(mr[m]["by_layout_by_rank"][r].get(layout, [0, 0])[i]
                         for m in models for r in ranks) for i in (0, 1))

    for k, t in mesh["hops"]["t"].items():
        shape = mesh["hops"]["shape"][k]
        parts, p = shape["shards"], shape["shard"]
        ranks = [r for r in range(world) if r % n_model == p]
        counts = mesh_counts(MESH_MODELS, shape["layout"], ranks) if parts == n_model else (0, 0)
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", t, mesh["hops"]["bound"][k], counts, mesh["errs"],
            {**shape, "what": f"B1, LightGCN hop, one of {parts} destination shards"},
            library_call="torch.sparse.mm on a CSR tensor of the shard's layout",
            launches_of=([f"the ranks holding shard {p} in the {MESH_RUN} mesh runs of "
                          f"{' and '.join(MESH_MODELS)} ({MESH_EPOCHS} epoch each, those "
                          f"ranks' B1 calls on this layout)"]
                         if parts == n_model else
                         [f"no run of this script trains on a model axis of {parts}"])))
    rows_b1.append(b1_row(
        "csr_spmm.mesh_sgl_whole_hop_prf", hop["prf"], hop_bound["prf"],
        mesh_counts(("sgl",), "whole", range(world)), lgcn_err,
        {**hop_shape, "layout": "forward",
         "what": "SGL's augmented views on a mesh rank: B1 on the whole graph over the whole "
                 "tables (dist_train.whole_nodes), under the views' PRF edge masks"},
        launches_scope="SGL's B1 calls on the whole graph's forward and transposed layouts "
                       "(one shape) in every rank of the mesh run; the time is the forward "
                       "PRF hop's, timed in phase 1",
        library_call="torch.sparse.mm on a CSR tensor whose values already carry the mask",
        launches_of=[f"sgl's {MESH_RUN} mesh run, {MESH_EPOCHS} epoch, all {world} ranks"]))
    rows_b1[-1]["mesh"] = {
        "whole_diff": mesh["hops"]["whole_diff"], "run": {k: v for k, v in mr.items()},
        "nccl": {k: v for k, v in mesh["nccl"].items()}}
    mk = mesh["kg"]
    kg_graph_models = {"kg_ui": ("kgcl", "kgrec", "diffkg"), "kgin_iu": ("kgin",)}
    for k, t in mk["hops"]["t"].items():
        shape = mk["hops"]["shape"][k]
        models, p = kg_graph_models[shape["graph"]], shape["shard"]
        # rank p of the {1, 2} runs holds shard p
        counts = sum(mk["run"][m]["by_layout_by_rank"][p].get(shape["layout"], 0)
                     for m in models)
        graph = ("the KG models' UI bi-adjacency" if shape["graph"] == "kg_ui"
                 else "KGIN's interact graph (user-destination edges)")
        rows_b1.append(b1_row(
            f"csr_spmm.{k}", t, mk["hops"]["bound"][k], (counts, None), mk["errs"],
            {**shape, "what": f"B1, {graph} at the whole synthetic split, one of 2 "
                              f"destination shards, under values in the original edge order"},
            launches_scope=f"the B1 launches on this shard's {shape['layout']} layout in rank "
                           f"{p} of the {MESH_KG_RUN} mesh runs of {', '.join(models)} "
                           f"({MESH_EPOCHS} epoch each on {MESH_KG_DATASET}, whose layouts "
                           f"have this shape and fewer edges); combine launches not counted "
                           f"apart",
            library_call="torch.sparse.mm on a CSR tensor of the shard's layout, values "
                         "pre-multiplied",
            launches_of=[f"{m}'s {MESH_KG_RUN} mesh run, rank {p}" for m in models]))
    rows_b1[-1]["mesh_kg"] = {"run": {k: v for k, v in mk["run"].items()}, "s": mk["s"]}
    rows_b1 += mesh_mb_rows(mk["mb"], b1_row)
    mg = mk["gcf"]["run"]
    # phase 37(f): every rank runs each hop of item 9a's models on the whole
    # graph, so each row times one of those graphs at the whole split (in
    # phases 10 and 31) and counts the B1 launches of the models that hop
    # over it in both ranks of their mesh runs (all their layouts: the
    # bi-adjacency's, the views' and decoders', LightGCL's rectangle)
    gcf_rows = (
        ("mesh_gcf_bi_adj_values", ssl_t["dccf_hop"], ssl_bound["dccf_hop"],
         {"n_rows": plain.n_rows, "nnz": plain.nnz, "d": 32, "layout": "forward"},
         ("dccf", "hccf", "autocf", "gformer", "adagcl"),
         "the whole bi-adjacency under per-edge values (DCCF's learned weight timed)",
         "torch.sparse.mm on a CSR tensor whose values already carry the weight"),
        ("mesh_gcf_lightgcl_rect", ssl_t["lightgcl_d32"], ssl_bound["lightgcl_d32"],
         {"n_rows": lgcl.n_rows, "n_cols": lgcl.n_cols, "nnz": lgcl.nnz, "d": 32,
          "layout": "forward"},
         ("lightgcl",), "LightGCL's whole rectangular adjacency",
         "torch.sparse.mm on a CSR tensor of the layout"),
        ("mesh_gcf_mbgmn_pv_a", newt["t"]["mb_pv_a_d32"], newt["bound"]["mb_pv_a_d32"],
         {"graph": "pv A", "d": 32, "layout": "forward"}, ("mbgmn",),
         "MBGMN's behavior graphs (the whole Tmall-shaped pv A timed)",
         "torch.sparse.mm on a CSR tensor of the layout"))
    for key, t, bound, shape, models, what, library in gcf_rows:
        counts = sum(c.get("whole", 0) for m in models for c in mg[m]["by_layout_by_rank"])
        rows_b1.append(b1_row(
            f"csr_spmm.{key}", t, bound, (counts, None), ssl_errs if key != "mesh_gcf_mbgmn_pv_a"
            else mbp["errs"],
            {**shape, "what": f"B1 on {what} inside every rank of the {MESH_KG_RUN} mesh runs"},
            launches_scope=f"every B1 launch of {', '.join(models)} in both ranks of their "
                           f"{MESH_KG_RUN} mesh runs ({MESH_EPOCHS} epoch each; all whole-graph "
                           f"layouts, at the depth-cut split); combine launches not counted "
                           f"apart",
            library_call=library,
            launches_of=[f"{m}'s {MESH_KG_RUN} mesh run, both ranks" for m in models]))
    rows_b1[-1]["mesh_gcf"] = {"run": dict(mg)}
    ms = mk["social"]["run"]
    # phase 37(g): likewise for the social five, each row one of their graphs
    # timed at yelp_sub (phases 16 and 21), its launches those of the models
    # that hop over it (all their layouts) in both ranks of their mesh runs
    social_rows = (
        ("mesh_social_yelp_bi_hop", soc_t["yelp_bi_hop_d64"], soc_bound["yelp_bi_hop_d64"],
         soc_shapes["bi"], 64, ("dcrec", "dsl"), soc_errs,
         "the yelp_sub bi-adjacency (and DcRec's views and trust graph, DSL's trust graph)"),
        ("mesh_social_mhcn_r", soc_t["mhcn_r_d64"], soc_bound["mhcn_r_d64"], soc_shapes["r"],
         64, ("mhcn",), soc_errs, "MHCN's R (and its three channels)"),
        ("mesh_social_kcgn_ii_hop", ks["t"]["kcgn_ii_hop_d128"], ks["bound"]["kcgn_ii_hop_d128"],
         ks["shapes"]["kcgn_ii"], 128, ("kcgn",), ks["errs"],
         "KCGN's ii DGI graph (and its expanded graph, uu graph and component sums)"),
        ("mesh_social_smin_iti_hop", ks["t"]["smin_iti_hop_d64"], ks["bound"]["smin_iti_hop_d64"],
         ks["shapes"]["smin_iti"], 64, ("smin",), ks["errs"],
         "SMIN's ITI metapath (and its other metapaths, DGI and subgraph hops)"))
    for key, t, bound, (n_r, n_c, nnz_k), d_k, models, err, what in social_rows:
        counts = sum(c.get("whole", 0) for m in models for c in ms[m]["by_layout_by_rank"])
        rows_b1.append(b1_row(
            f"csr_spmm.{key}", t, bound, (counts, None), err,
            {"n_rows": n_r, "n_cols": n_c, "nnz": nnz_k, "d": d_k, "layout": "forward",
             "what": f"B1 on {what} inside every rank of the {MESH_KG_RUN} mesh runs"},
            launches_scope=f"every B1 launch of {', '.join(models)} in both ranks of their "
                           f"{MESH_KG_RUN} mesh runs ({MESH_EPOCHS} epoch each on "
                           f"{SOCIAL_DATASET}; all whole-graph and segment layouts); combine "
                           f"launches not counted apart",
            library_call=sparse_mm,
            launches_of=[f"{m}'s {MESH_KG_RUN} mesh run, both ranks" for m in models]))
    rows_b1[-1]["mesh_social"] = {"run": dict(ms)}
    mq = mk["seq"]["run"]
    # phase 37(h): every rank runs DCRec_seq's and MAERec's item-graph hops on
    # the whole graph; each row times one of those graphs at the whole
    # sports-shaped split (phase 26; its degree sums and spreads at d 1 beside
    # it) and counts the launches in both ranks of the model's mesh run, on
    # MESH_SEQ_DATASET's graph of the same kind (its nnz in the row)
    seq_rows = (("mesh_seq_dcrec_seq_adj_hop", "dcrec_seq_adj_hop_d64", "dcrec_seq_deg_d1",
                 "dcrec_seq", "adj", "DCRec_seq's transition graph (and its similarity and "
                 "test graphs; its degree, readout and count sums)"),
                ("mesh_seq_maerec_hop", "maerec_hop_d64", "maerec_spread_d1", "maerec", "graph",
                 "MAERec's distance-3 graph (its encoder hops, path scores, degree sums and "
                 "closure spreads)"))
    for key, timed, d1_key, model, graph, what in seq_rows:
        counts = sum(c.get("whole", 0) for c in mq[model]["by_layout_by_rank"])
        n_r, n_c, nnz_k, d_k = seq["shapes"][timed]
        rows_b1.append(b1_row(
            f"csr_spmm.{key}", seq["t"][timed], seq["bound"][timed], (counts, None), seq["errs"],
            {"n_rows": n_r, "n_cols": n_c, "nnz": nnz_k, "d": d_k, "layout": "forward",
             "what": f"B1 on {what} inside every rank of the {MESH_SEQ_RUN} mesh runs",
             "mesh_split_nnz": mq[model]["graph_nnz"],
             "d1_ms": seq["t"][d1_key]["ms"], "d1_bound_ms": seq["bound"][d1_key][0],
             "d1_plain_ms": seq["t"][d1_key]["plain_ms"],
             "d1_library_ms": seq["t"][d1_key]["library_ms"]},
            launches_scope=f"every B1 launch of {model} in both ranks of its {MESH_SEQ_RUN} mesh "
                           f"run ({MESH_EPOCHS} epoch on {MESH_SEQ_DATASET}, whose graph has "
                           f"the nnz in mesh_split_nnz; all whole-graph layouts); combine "
                           f"launches not counted apart",
            library_call=sparse_mm + ", values pre-multiplied",
            launches_of=[f"{model}'s {MESH_SEQ_RUN} mesh run, both ranks"]))
    rows_b1[-1]["mesh_seq"] = {"run": dict(mq)}
    rows_b1[0]["tuner_and_resume_on_card"] = {
        "tune_trials": [(t["assignment"], t["score"]) for t in tr["tune"]["trials"]],
        "resume_bit_equal_tensors": tr["resume_tensors"],
        "maerec_resume_bit_equal_tensors": tr["maerec_resume_tensors"]}
    b2_rows = [
        b2_row("segment_max", kg["b2"], kg_bound["b2"],
               kg_b2 + sum(r["b2_launches"] for r in ssl_runs.values()),
               b2_shape(seg_lay),
               launches_by_path={"lightgcn": lgcn_b2, "kgcl": kg_b2,
                                 **{k: r["b2_launches"] for k, r in ssl_runs.items()}},
               launches_per_step={"kgcl": kg_b2 / kg_steps,
                                  "kgrec": ssl_runs["kgrec"]["b2_launches"]
                                  / ssl_runs["kgrec"]["steps"]},
               stress_layouts={k: {"shape": b2_shape(v), **kg[f"b2_{k}"],
                                   "bound_ms": kg_bound[f"b2_{k}"][0]}
                               for k, v in b2_stress.items()}),
        b2_row("segment_max.kgrec_heads", kgp["t"]["b2_kgrec_heads"],
               kgp["bound"]["b2_kgrec_heads"], ssl_runs["kgrec"]["b2_launches"],
               kgp["heads_shape"], launches_of=["kgrec"])]
    dm = kgn["model"]
    for key, lay, what in (("b2_diffkg_dkg_heads", dm._last_dkg.h, "the denoised KG's heads, "
                            "a layout built on the card each epoch"),
                           ("b2_diffkg_kg_heads", dm.kg.h, "the capped KG's heads")):
        b2_rows.append(b2_row(
            f"segment_max.{key[3:]}", newt["t"][key], newt["bound"][key],
            ssl_runs["diffkg"]["b2_launches"],
            {**b2_shape(lay), "what": what},
            launches_of=["diffkg"]))
    mesh_b2 = sum(sum(r.get("b2", 0) for r in mk["run"][m]["by_layout_by_rank"])
                  for m in MESH_KG_MODELS)
    b2_rows.append(b2_row(
        "segment_max.mesh_kg_whole_kg_heads", kg["b2"], kg_bound["b2"], mesh_b2,
        {**b2_shape(seg_lay),
         "what": "B2 on the whole KG's head layouts inside each rank of the KG models' "
                 "mesh runs (KGCL's capped heads timed here; KGRec's uncapped and DiffKG's "
                 "heads in their rows)"},
        launches_of=[f"{m}'s {MESH_KG_RUN} mesh run, both ranks" for m in MESH_KG_MODELS]))
    log(json.dumps({"kernels": rows_b1 + b2_rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
