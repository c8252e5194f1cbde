#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

1. Builds every CUDA kernel of the port from the sources (nvcc, one
   process per source, all at once) and prints the build time.
2. magnet_mxu kernel phase: holds K1 (``csr_dual_spmm``) against its plain
   PyTorch version on the card — on the MagNet path's own operator
   (N=65,536, about 5M nonzeros) at the widths it applies (4 and 64),
   float32 and bf16, and on a small graph with duplicate edges and empty
   rows — and times kernel, plain version and one library call beside the
   least time the card could take (bytes over 3.35 TB/s or flops over
   67 TFLOP/s, the larger).
3. magnet_mxu slice phase: builds the bench's magnet_mxu configuration
   through the port's public API (DSBM N=65,536, degree features, magnetic
   Laplacian pair at q=0.25, MagNet K=2 hidden 32, 2 layers), checks the
   kernel tier's forward against the plain segment tier on the card and
   the gradients against the CPU on a small graph, then trains 30 Adam
   steps at lr 1e-2 on K1, MagNetConv running fused over the frozen pair
   (one ``complex_epilogue`` launch a layer forward, one
   ``complex_epilogue_backward`` a layer backward).  The epilogue kernel
   is held bit for bit against its plain version at the path's shape
   (N=65,536, hidden 32) and at the giant MagNet benchmark cell's
   (N=2,388,953, hidden 64), bias and complex ReLU on, and timed beside
   its byte bound.
4. Giant phase: the giant bench's WikiTalk-scale power-law digraph
   (N=2,400,000, 10M draws, alpha 1.0, seed 0) on the column-split and
   streamed layouts, applied by K2 (``csr_dual_spmm_accum``).  Checks the
   layouts, holds the apply and K2 alone against their plain versions,
   runs every CSR entry (K1/K2, the pair entries, K3 and K4) on a
   synthetic CSR with the graph's largest row (324,064 edges) and rows
   around the piece length at which the kernels cut rows, holds the dual
   (plain and accumulate, W = 1, 5, 10, 32, 64) and ``csr_scatter_sum``
   (every width 1 to 40, message rows 16-byte aligned or not) on a CSR
   of one- and two-edge rows beside a hub row and rows around the
   kernels' row-block length, times the apply
   in the flat, split and split+streamed
   layouts, checks the forward against the segment tier, and trains 10
   steps with bf16 messages.
5. BSR phase: the bench's headline MagNet graph (N=8192, average degree
   24) on the ``bsr`` tier, applied by K5 (``bsr_spmm``).  Holds K5 against
   its plain version at the path's widths (2 and 32), forward and
   transposed, times it (one call, 20 back to back and a replayed CUDA
   graph of 20) beside a dense matmul and ``torch.sparse.mm`` on a BSR
   tensor (the faster of the two is the library call), checks the model's
   forward against the dense tier, and trains 30 steps.
6. Trainable-q phase: the bench's trainable-q configuration
   (``magnet_trainable_q_step_ratio``): the magnet_mxu graph, a
   ``magnetic_template`` (mxu), MagNet with ``trainable_q=True`` from
   q=0.25.  Holds K1's ``csr_pair_spmm`` (the pair forward, which gathers
   x itself) against its plain version on the template at the widths the
   path applies (2F = 4 and 64, f32 and bf16), K3 (``csr_dual_sddmm``) on
   the transposed template at the same widths, K4
   (``csr_dual_sddmm_accum``) on a split and a streamed layout of the
   template, and, off the path, K1's own contract ``csr_scatter_sum`` at
   the widths of the TPU pair forward's messages (8 and 128) against
   ``torch.segment_reduce``; times each beside its bound and a PyTorch
   composite; checks forward, dx and dq of the flat template and of the
   one-card sharded template (``local_mesh()``) against a float64
   reference, and the model's gradients against the CPU; then trains 30
   steps on each (flat: ``csr_pair_spmm`` forward, ``csr_dual_spmm`` dx;
   sharded: ``csr_dual_spmm`` forward, K3 backward) and prints the
   trainable/frozen step ratio against phase 3.
7. Experiments phase: the four entry points ``magnet_node``,
   ``magnet_link`` (one split), ``msgnn_node`` and ``msgnn_link`` through
   their ``main(argv)`` at ``--dataset synthetic --num_nodes 9000`` and
   their default widths, 30 epochs each, on the layouts ops/layout.py
   picks at that size (streamed K2 for the first three, flat K1 for
   msgnn_link).  Prints input edges, Laplacian nnz, the layout and its cut
   rows, host seconds by stage, median ms/step, first and last loss and
   test accuracy; requires falling losses and launch counts equal to
   those the layouts imply for the steps and evaluation forwards run, and
   for each training step, counted around it.
   Holds K1 on msgnn_link's flat operator and K2 on the first streamed
   block of magnet_node's (every row cut) and msgnn_node's operators
   against their plain versions at 2F = 4, 8, 32 and 128, float32, and
   times each (one call between events, and 20 back to back) beside its
   bound and two cuSPARSE products; off the path, K1 the same way on
   magnet_node's Laplacian laid out flat, where every row is cut.
8. Directed families phase: DIGRAC, DiGCN and DGCN.  The ``digrac``
   experiment through its ``main(argv)`` at ``--N 9000 --epochs 30`` and
   its own defaults (K=3, Hermitian features, hidden 32, hop 2: K1 on the
   two walk operators at W=32 and on A and A^T at W=3); bench.py's digrac
   cell (N=65,536, E=2,000,000 uniform edges, K=5) trained 30 steps with
   the (P_A, P_AT) pair and 30 with the fused duals
   (``rw_norm_dual_propagator``, ``adj_dual_propagator``), whose first
   losses must agree at 1e-5; bench.py's DiGCN inception cell (N=65,536,
   average degree 15, two stand-in operators, hidden 32, 5 labels); DGCN
   at dgcn_node's hidden 32 on that graph through its own operators
   (``directed_features_in_out``: the in and out graphs stream, K2); and
   ``dgcn_link``, ``digcn_link`` and ``digcn_inception_link`` through
   ``main(argv)`` at ``--dataset synthetic --splits 1 --epochs 30`` and
   their default 1,000 nodes (the dense tier: no kernel launch).  Each
   run must launch exactly what its layouts imply, for the run and for
   each step, and its loss must fall.  Holds K1 on single operators
   (the digrac P_s at W=3 and 32, the bench P_s at W=5 and 32), K1 on
   the two fused duals (2F=64, 2K=10) and K2 on block 0 of DGCN's
   streamed A_in (W=32) against their plain versions, timed beside their
   bound and one (or two) cuSPARSE products.
9. Signed families phase: SSSNET and SGCN.  The ``sssnet`` experiment
   through its ``main(argv)`` at ``--N 9000 --epochs 30`` and its own
   defaults (K=3, p=0.1, eta=0.1, hidden 16, hop 2, two splits: K1 on the
   walk operators at W=16 and on D_bar at W=3, K1 or K2 on the cut loss's
   D_p - (A_p - A_n) as its layout streams or not); bench.py's SSSNET cell
   (N=65,536, 1.6M positive and 0.4M negative uniform edges, signed
   degree features, K=5, hidden 16, hop 2, the balanced normalized cut
   alone) trained 30 steps; bench.py's SGCN cell (N=131,072, 600k
   positive and 120k negative edges, a standard-normal input embedding of
   width 64 as a parameter, 2 layers) trained 30 steps on ``SGCN.loss``
   with the mean-operator pair and 30 with the fused union-edge-set dual,
   on 30 sets of non-edges and triplets drawn before training, whose
   first losses must agree at 1e-5.  Each run must launch exactly what its
   layouts imply, for the run and for each step, and its loss must fall.
   Holds K1 on the bench SSSNET's P_p (W=16, 5) and D_bar (W=5), K1 on
   the SGCN dual (2F=128, 64) and K2 on block 0 of the experiment's cut
   operator (if it streams) against their plain versions, timed beside
   their bound and one (or two) cuSPARSE products.
10. Signed attention phase: SNEA, SiGAT and SDGNN, on K1's own contract
   ``csr_scatter_sum`` (through ``ops.scatter.scatter_sum``, whose
   backward is a gather, and ``motif_attend``).  bench.py's SNEA cell
   (N=16,384, 400k positive and 100k negative uniform draws, a
   standard-normal input embedding of width 32 as a parameter, SNEA in
   32 / out 32, 2 layers) and the same at epinions scale (N=131,580,
   589,888 + 121,322 draws), each trained 30 steps on ``SNEA.loss`` over
   30 sample sets drawn before training: 3 K1 a step (g_pos and g_neg at
   W=17, the fused pair on g_cat at W=34); bench.py's SiGAT and SDGNN
   cells (N=3,783, 22,650 + 1,536 draws, the spectral embedding of width
   20) trained 30 steps with one GAT a motif graph (SiGAT 38 K1 a step at
   W=21, SDGNN 8) and 30 with the fused motif stack from the same weights
   (SiGAT 3: one forward at W=21 over 38 N rows, two backward at W=21 by
   source and W=1 by destination; SDGNN 6; the two at W=21 read their
   messages by index, and the backward's edge kernel runs once a layer),
   whose first losses must agree
   at 1e-5.  Each run must launch exactly that, for the run and for each
   step, and its loss must fall.  Holds ``csr_scatter_sum`` on these CSRs
   at W = 17, 34, 21 and 1 against its plain version, timed beside its
   bound and ``torch.segment_reduce``.
11. DiGCL and the real-data entry points.  bench.py's DiGCL cell
   (N=65,536, average degree 15, its degree features, the GCN-normalized
   operator that ``gcn_norm_propagator(mode="auto")`` puts on the kernel
   tier, DiGCL hidden 64 / projection 32 / tau 0.4, Adam at lr 1e-3)
   trained 10 steps with the batched InfoNCE at B=4096 and at the bench's
   1024-row baseline from the same weights (first losses equal at 1e-5):
   ms/step, similarity pairs/s (2 N^2 a step), peak allocated memory and
   8 K1 calls a step (4 forward at W=128, 64, 128, 64, their 4
   transposes).  Holds K1 on that operator at W=128 and 64 against its
   plain version, timed beside its bound and one ``torch.sparse.mm``.
   Then, on files written in each dataset's schema at its published size
   into a temporary directory named by ``PGSD_TPU_DATA``, through their
   ``main(argv)``, 20 epochs and one split or run each: digcl_node,
   dgcn_node, digcn_node and digcn_inception_node on cora_ml, digcl_link
   on telegram, link_sign_prediction with SGCN and SNEA on bitcoin_alpha,
   run_link_sign_direction_tasks on its SDSBM with MSGNN and SGCN; each
   prints its cuts, host seconds, ms/step, losses and metrics; the dense
   tier launches nothing, SNEA 3 K1 a step.
12. Captured training: ``train.scan_node_training``'s epoch (a training
   step and an evaluation forward with the best-validation selection,
   ``train.SplitRun``) captured as a CUDA graph and replayed, on
   magnet_mxu (K1; 2 splits, 50 epochs), bsr (K5; 2 splits, 50 epochs),
   magnet_node's streamed operator at N=9,000 (K2; 1 split, 30
   epochs) and trainable-q MagNet on the magnet_mxu graph's template
   (2 splits, 50 epochs each): flat (K1's ``csr_pair_spmm`` forward, K1
   dx) and sharded on ``local_mesh()`` (K1 a shard forward, K3
   ``csr_dual_sddmm`` a shard backward, so K3 runs inside the graph), by
   the reference recipe of scripts/reference_protocol_
   magnet.py (Adam at lr 1e-2, coupled L2 5e-4) on random 60/20/20
   masks.  Against an eager loop of the same epochs from the same init,
   masks and optimizer, whose first epoch runs with every host sync an
   error: every
   epoch's loss and the selections must agree bit for bit, and the eager
   epoch and the capture must launch what the layouts imply for a step
   and an evaluation forward.  Prints ms an epoch eager and captured,
   the capture's seconds, and the device time and idle share over 10
   traced replays.

13. Sharded paths (parallel/): each on ``local_mesh()`` and on four shards
   of the one card (``Mesh((cuda:0,) * 4)``), which measures the partition
   and the per-shard kernel calls at real shard sizes, not multi-card
   speed.  bench.py's SNEA cell and its SDGNN cell (one GAT a motif) on
   sharded attention graphs, 30 steps each (K1 ``csr_scatter_sum`` once a
   shard and attend: SNEA 4 a shard and step, layer 2's pair not fused on
   a sharded graph; SDGNN 8); the bench SGCN cell's pair and fused dual
   sharded four ways on the mxu tier, 5 steps (K1 ``csr_dual_spmm`` a
   shard and apply, 3 applies of each operator and 3 of its transpose a
   step); the bsr cell's MagNet on its bsr operators sharded 1 and 4 ways
   (K5 a shard and apply), 30 steps; every first loss equal to the flat
   model's at 1e-4, every run launching exactly what its shards imply.
   Holds ``csr_scatter_sum`` on shard 0 of the bench SNEA graphs (W=17,
   34), of SDGNN's largest motif graph (W=21) and on an edgeless shard,
   K1 on shard 0 of the sharded SGCN dual (2F=128, 64) and K5 on shard 0
   of the bsr cell (W=32) against their plain versions.  Then one Adam
   step on four shards through an NCCL process group of world size 1
   (``parallel.init_process_mesh``), equal to the controller mesh's bit
   for bit, and the dense and segment tiers on a (2, 2) data x graph
   mesh: two trainings from two seeds of 10 steps, each equal to its own
   single-device run at rtol 1e-4 / atol 1e-5.
14. DIGRAC at WikiTalk scale: ``main`` of scripts/giant_digrac_torch.py
   (the port's giant_digrac: the giant graph, degree features, K=5,
   hidden 32, hop 2, the JAX script's ``Prob_Imbalance_Loss(5)``, bf16
   messages, 30 Adam steps and 10 traced), with the four single
   operators and then with the fused duals; every operator is
   column-split (all but A and Aᵀ of the pair, 7.2M nonzeros, also
   streamed), so every apply is K2, at W=32 and 5 (pair)
   and 2F=64 and 2K=10 (fused).  Each loss must fall, each step must
   launch the K2 calls the layouts imply, and the first losses of the two
   forms, taken again with f32 messages from the same weights, must agree
   at 1e-5.  Holds K2 on block 0 of P_s (W=32), of the walk dual (2F=64),
   of P_A (W=5) and of the A dual (2K=10) against its plain version, f32
   and bf16, timed beside its bound and one (or two) cuSPARSE ``addmm``.
15. K1 reading its messages by index, at the SDGNN benchmark cell's
   shapes (port_bench's ``epinions_signed`` traffic at seed 0, width 32;
   run after phase 10): the motif attend's sums by destination and by
   source (W=33 over 526,320 rows and 1,948,740 edges) and the losses'
   gather backward (W=32 over the positive and negative lists'
   sources), each against its plain version, timed beside its bound and
   beside PyTorch's gather of the messages and K1 over them, which it
   replaces; the attend backward's edge kernel (``attend_logit_grad``)
   at the stack's edges against its plain version.

Every kernel case also calls the kernel twice and requires the same
bits (no atomics).  Each training run sets the launch counters to 0 just
before and reads them just after, and must launch exactly the kernels its
layouts imply (one count per wrapper call, which makes one or two device
launches).
Any failed phase raises, so the exit code is nonzero and no result line
is printed.  The last lines are the card's nvidia-smi name and power
limit, one JSON line of kernel measurements, and
{"ok": true, "device": {...}}.
"""
import contextlib
import importlib.util
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

DEV = "cuda"
N = 65_536                   # the bench's magnet_mxu configuration
EXPECTED_E = 2_456_932       # its input edges at seed 0
STEPS = 30
# scripts/bench_giant.py's graph and training run; the expected counts are
# those of the generator and the port's magnetic Laplacian at seed 0
GIANT = dict(nodes=2_400_000, edges=10_000_000, alpha=1.0, seed=0,
             expected_e=9_929_144, expected_nnz=16_035_378, steps=10)
LABEL_FREQ = (0.4, 0.25, 0.15, 0.12, 0.08)
# bench.py's headline MagNet graph (_build_magnet(8192, 24))
BSR_GRAPH = dict(nodes=8192, avg_deg=24, seed=0, steps=30)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
GIANT_CELL_NODES = 2_388_953  # port_bench's giant MagNet cell (WikiTalk)
# MagNetConv's epilogue a step of a 2-layer MagNet over a frozen pair
EPILOGUE_STEP = {"complex_epilogue": 2, "complex_epilogue_backward": 2}
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
REPS = 20
# SDGNN steps phase 15 counts at the SDGNN cell's shapes
INDEXED_STEPS = 3
# the experiments at N=9000, just over the dense tier's 8192 nodes, at
# their default widths; each trains at least EXPERIMENT_EPOCHS steps
EXPERIMENT_N = 9000
EXPERIMENT_EPOCHS = 30
EXPERIMENT_ARGV = {"magnet_node": [], "magnet_link": ["--splits", "1"],
                   "msgnn_node": [], "msgnn_link": []}
# 2F of the applies on their paths: MagNet's 2 degree features, MSGNN's 4
# signed ones, hidden 16 and hidden 64
EXPERIMENT_WIDTHS = (4, 8, 32, 128)
# phase 8: the digrac experiment at N=9000 with its own defaults (K=3,
# p=0.1, hermitian features, hidden 32, hop 2), 30 epochs; bench.py's
# digrac cell (bench.py:409-461, run at :641) and its DiGCN inception cell
# (bench.py:522-567, :643), DGCN at dgcn_node's hidden 32 on the latter's
# graph; the three link experiments at their default 1,000 nodes
DIGRAC_ARGV = ["--N", "9000", "--epochs", "30"]
BENCH_DIGRAC = dict(nodes=65_536, edges=2_000_000, k=5, steps=30)
DIGCN_GRAPH = dict(nodes=65_536, avg_deg=15, steps=30)
DGCN_HIDDEN = 32
LINK_EXPERIMENTS = ("dgcn_link", "digcn_link", "digcn_inception_link")
LINK_ARGV = ["--dataset", "synthetic", "--splits", "1", "--epochs", "30"]
# phase 9: the sssnet experiment at N=9000 with its own defaults (K=3,
# p=0.1, eta=0.1, hidden 16, hop 2, two splits), 30 epochs; bench.py's
# SSSNET cell (bench.py:464-519, run at :642) and SGCN cell (bench.py:212-
# 247, :635)
SSSNET_ARGV = ["--N", "9000", "--epochs", "30"]
BENCH_SSSNET = dict(nodes=65_536, e_pos=1_600_000, e_neg=400_000, k=5,
                    hidden=16, hop=2, steps=30)
BENCH_SGCN = dict(nodes=131_072, e_pos=600_000, e_neg=120_000, dim=64,
                  steps=30)
# phase 10: bench.py's SNEA cell (bench.py:173-206, run at :628) and its
# epinions-scale run (:633), its SiGAT (:257-295, :637) and SDGNN
# (:298-334, :638) cells at bitcoin_alpha scale
BENCH_SNEA = dict(nodes=16_384, e_pos=400_000, e_neg=100_000, dim=32,
                  steps=30)
SNEA_EPINIONS = dict(nodes=131_580, e_pos=589_888, e_neg=121_322, dim=32,
                     steps=30)
BENCH_MOTIF = dict(nodes=3783, e_pos=22_650, e_neg=1_536, dim=20, steps=30)
# phase 11: bench.py's DiGCL cell (bench.py:337-403, run at :640), at its
# batch of 4096 rows and its 1024-row baseline; the real-data entry points
# on files written in each dataset's schema at its published size, 20
# epochs and one split or run each
# (a step launches 3,700 / 10,500 kernels at B=4096 / 1024 and is
# device-bound: 2 traced steps read its device time)
BENCH_DIGCL = dict(nodes=65_536, avg_deg=15, steps=10, batches=(4096, 1024),
                   profile=2)
REAL_EPOCHS = 20
REAL_RUNS = (
    ("digcl_node", ["--splits", "1"]),
    ("dgcn_node", ["--dataset", "cora_ml"]),
    ("digcn_node", ["--dataset", "cora_ml"]),
    ("digcn_inception_node", ["--dataset", "cora_ml"]),
    ("digcl_link", ["--dataset", "telegram", "--splits", "1"]),
    ("link_sign_prediction", ["--model", "sgcn"]),
    ("link_sign_prediction", ["--model", "snea"]),
    ("run_link_sign_direction_tasks", ["--dataset", "synthetic", "--method",
                                       "msgnn", "--runs", "1"]),
    ("run_link_sign_direction_tasks", ["--dataset", "synthetic", "--method",
                                       "sgcn", "--runs", "1"]))
# phase 12: scan_node_training's captured epoch against an eager loop on
# magnet_mxu, bsr and magnet_node's streamed operator (splits, epochs), by
# the JAX reference recipe of scripts/reference_protocol_magnet.py: Adam
# at lr 1e-2 with coupled L2 5e-4, dropout off
CAPTURED = (("magnet_mxu", 2, 50), ("bsr", 2, 50), ("magnet_node", 1, 30),
            ("trainable_q_flat", 2, 50), ("trainable_q_sharded", 2, 50))
# trainable-q MagNet (K=2, 2 layers) on the magnet_mxu graph's template:
# wrapper calls of a training step and of an evaluation forward.  Flat:
# the pair forward is one csr_pair_spmm an apply (2F=4 in layer 1, 2F=64
# in layer 2, two each); the backward's dx is one csr_dual_spmm an apply
# whose input needs a gradient (layer 1's second, both of layer 2); dq
# needs no kernel.  Sharded: one csr_dual_spmm a shard forward and one
# csr_dual_sddmm a shard backward an apply (K3 gives dx and dq together,
# so layer 1's first apply runs it too)
TRAINABLE_Q_STEP = {"flat": {"csr_pair_spmm": 4, "csr_dual_spmm": 3},
                    "sharded": {"csr_dual_spmm": 4, "csr_dual_sddmm": 4}}
TRAINABLE_Q_EVAL = {"flat": {"csr_pair_spmm": 4},
                    "sharded": {"csr_dual_spmm": 4}}
CAPTURED_LR, CAPTURED_WD = 1e-2, 5e-4
# phase 13: the sharded paths, each on the one-card mesh local_mesh() and
# on four shards of the one card (Mesh((cuda:0,) * 4)), at the bench cells'
# own sizes: SNEA and SDGNN per motif (30 steps on SHARDED_SETS sample
# sets, cycled), SGCN's pair and fused dual on the mxu tier (5 steps), the
# bsr cell's MagNet (30 steps); the dense and segment tiers on a (2, 2)
# data x graph mesh (two seeds, 10 steps each); and one step through an
# NCCL process group of world size 1
SHARDS = 4
SHARDED_STEPS = 30
SHARDED_SETS = 10
SHARDED_SGCN_STEPS = 5
DATA_GRAPH_STEPS = 10
# steps traced for a sharded path's device time (the 4-shard SNEA and SDGNN
# steps launch 2,300-3,600 kernels, which the profiler is slow to collect)
SHARDED_PROFILE_STEPS = 3
# sharded first losses against the flat ones: each shard shifts its
# softmax by its own largest logit, and sums run in other orders
SHARDED_TOL = 1e-4
# phase 14: scripts/giant_digrac_torch.py's main on the giant graph (its
# defaults), pair then fused, 30 steps; K2 is held on block 0 of these
# operators at these widths (W of a single operator, 2F of a dual): the
# walk at hidden 32 and its dual at 64, the imbalance volumes at K=5 and
# their dual at 2K=10
GIANT_DIGRAC = dict(k=5, hop=2, hidden=32, seed=0)
GIANT_DIGRAC_CASES = {"pair": (("P_s", 32), ("P_A", 5)),
                      "fused": (("walk dual", 64), ("A dual", 10))}
# steps traced by torch.profiler for each phase-8, -9, -10 and -12 path's
# device time
PROFILE_STEPS = 10
# f32: the kernels sum in compensated float32, the plain versions in
# float64 (with atomics, in no fixed order)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# cuSPARSE yardsticks sum in plain float32 in their own order: a hub row
# of 10^5 terms drifts by about 1e-5 of its value
LIBRARY_TOL = dict(rtol=1e-4, atol=1e-4)
# K3's acc sums a product over every row, so larger terms cancel
ACC_TOL = dict(rtol=1e-4, atol=1e-4)
SRC = "pytorch_geometric_signed_directed_tpu_torch/ops/cuda/csrc/"
TPU = "pytorch_geometric_signed_directed_tpu/ops/pallas/"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=REPS):
    """Median milliseconds of ``reps`` calls, each timed by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, reps=REPS):
    """Milliseconds a call of ``reps`` calls made back to back between two
    CUDA events: the device's time where the host keeps ahead of it."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=REPS):
    """Milliseconds per call of ``fn`` captured ``reps`` times into one
    CUDA graph and replayed: the device's time alone, where a call's host
    work (the wrapper's checks, its plan arguments, the launch) would
    otherwise outlast a short kernel.  None where ``fn`` cannot be
    captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_graph(n, avg_deg, seed):
    """The bench's MagNet graph: DSBM with a cyclic meta-graph, normalized
    in/out-degree features."""
    from pytorch_geometric_signed_directed_tpu_torch.data import DSBM
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        meta_graph_generation)

    F = meta_graph_generation("cyclic", 5, 0.05, False)
    p = avg_deg / n
    A, labels = DSBM(n, 5, p * 5 / 2, F, rng=np.random.default_rng(seed))
    edge_index = np.vstack(A.nonzero())
    w = A.tocoo().data
    x = in_out_degree(edge_index, n, edge_weight=w)
    return edge_index, w, (x / max(x.max(), 1.0)).astype(np.float32), labels


def giant_digrac_script():
    """scripts/giant_digrac_torch.py as a module, loaded once."""
    name = "giant_digrac_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "scripts", name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


def powerlaw_digraph(n, e, alpha, seed):
    """The giant bench's graph generator: scripts/giant_digrac_torch.py's
    copy of scripts/bench_giant.py's (bit-equal for the same seed)."""
    return giant_digrac_script().powerlaw_digraph(n, e, alpha, seed)


def make_model(device, seed=0, trainable_q=False):
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        MagNet_node_classification)

    return MagNet_node_classification(
        num_features=2, hidden=32, K=2, label_dim=5, activation=True,
        layer=2, trainable_q=trainable_q, q=0.25, device=device,
        generator=torch.Generator().manual_seed(seed))


def train(model, x, y, lap, steps):
    """``steps`` Adam steps at lr 1e-2 on the mean NLL over all nodes, the
    launch counters (the sparse kernels' and MagNetConv's epilogue's) set
    to 0 just before and read just after.  Returns (losses, launches,
    per-step device ms, host seconds)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        complex_epilogue, launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    def loss_fn(m):
        return torch.nn.functional.nll_loss(m(x, x, lap), y)

    trainer = Trainer(loss_fn, lr=1e-2, device=DEV)
    state = trainer.init(model)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    events[0].record()
    losses = []
    for i in range(steps):
        losses.append(trainer.step_async(state))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**launch_counts(), **complex_epilogue.LAUNCHES}
    losses = [float(v) for v in losses]
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    return losses, launches, step_ms, wall


def check_launches(launches, expected, steps, what):
    """Every kernel launched exactly ``expected[name]`` times a step."""
    for name, count in launches.items():
        if count != expected.get(name, 0) * steps:
            raise AssertionError(
                f"{what}: {name} launched {count} times in {steps} steps, "
                f"expected {expected.get(name, 0)} a step ({launches})")


def kernel_entry(name, r, launches, source, replaces):
    return {"name": name, "route": "cuda", "source": SRC + source,
            "replaces": TPU + replaces if replaces else None,
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]}


def log_case(label, r):
    dev = (f" device_ms={r['device_ms']:.4f}" if "device_ms" in r else "")
    if r.get("graph_ms") is not None:
        dev += f" graph_ms={r['graph_ms']:.4f}"
    if r.get("library_device_ms") is not None:
        dev += f" library_device_ms={r['library_device_ms']:.4f}"
    # K1/K2 gathers: edges x W x element size, read from L2 where the
    # table stays there (the byte bound counts the table once)
    gathered = (f" gathered={r['gathered']} B" if "gathered" in r else "")
    log(f"{label}: kernel_ms={r['ms']:.4f}{dev} plain_ms={r['plain_ms']:.4f} "
        f"library_ms={r['library_ms']} bound_us={r['bound_ms'] * 1e3:.2f} "
        f"({r['bound_by']}, {r['bytes']} B){gathered} "
        f"max_abs_err={r['max_abs_err']:.3g}")


# ---------------------------------------------------------------------------
# magnet_mxu: K1


def dual_kernel_case(D, width, dtype, seed, single=False):
    """Kernel vs plain vs library on operator D at one width and type.
    ``single``: D is one operator (``single_view``), applied to every lane
    (fa = width), and the library call is one ``torch.sparse.mm``."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    n, m, nnz = D.num_nodes, D.num_cols, D.col.numel()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(m, width, device=DEV, generator=gen).to(dtype)
    fa = width if single else width // 2
    args = (D.rowptr, D.col, D.val_a, D.val_b, x, fa)
    got = scatter_csr.csr_dual_spmm(*args, D.row_split)
    want = scatter_csr.csr_dual_spmm_plain(*args)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    same_bits(got, scatter_csr.csr_dual_spmm(*args, D.row_split),
              "csr_dual_spmm")
    err = float((got - want).abs().max())
    ms = time_ms(lambda: scatter_csr.csr_dual_spmm(*args, D.row_split))
    device_ms = back_to_back_ms(
        lambda: scatter_csr.csr_dual_spmm(*args, D.row_split))
    plain_ms = time_ms(lambda: scatter_csr.csr_dual_spmm_plain(*args))
    library_ms = None
    rp, cl = D.rowptr.long(), D.col.long()
    library_device_ms = None
    if dtype == torch.float32 and single:
        # yardstick only: one cuSPARSE product
        A = torch.sparse_csr_tensor(rp, cl, D.val_a, size=(n, m))
        torch.testing.assert_close(torch.sparse.mm(A, x), want, **F32_TOL)
        library_ms = time_ms(lambda: torch.sparse.mm(A, x))
        library_device_ms = back_to_back_ms(lambda: torch.sparse.mm(A, x))
    elif dtype == torch.float32:
        # yardstick only: two cuSPARSE products, A x_a and B x_b
        A = torch.sparse_csr_tensor(rp, cl, D.val_a, size=(n, m))
        B = torch.sparse_csr_tensor(rp, cl, D.val_b, size=(n, m))
        xa, xb = x[:, :fa].contiguous(), x[:, fa:].contiguous()
        lib = torch.cat([torch.sparse.mm(A, xa), torch.sparse.mm(B, xb)], 1)
        torch.testing.assert_close(lib, want, **F32_TOL)
        library_ms = time_ms(lambda: (torch.sparse.mm(A, xa),
                                      torch.sparse.mm(B, xb)))
    # one value array a single operator, two a dual
    nbytes = (4 * (n + 1) + (8 if single else 12) * nnz
              + x.numel() * x.element_size() + 4 * n * width)
    b_ms, b_by = bound(nbytes, 2 * nnz * width)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, library_device_ms=library_device_ms,
                bytes=nbytes, gathered=nnz * width * x.element_size(),
                shape=f"N={n} nnz={nnz} W={width} {str(dtype)[6:]}")


def epilogue_cases(n, f, seed):
    """MagNetConv's complex epilogue (``ops/cuda/complex_epilogue``) at n
    rows of width 2F, with a bias and the complex ReLU: forward and
    backward against their plain versions, the same bits for z, the mask
    and the gradient of [o1 | o2], the bias gradient (float64 sums in
    another order) to float32 rounding; the same bits twice; re = 0
    exactly on a third of the rows in a quarter of the lanes (the mask's
    edge); each timed beside its byte bound, ``bytes_moved``.  Returns
    {"complex_epilogue": r, "complex_epilogue_backward": r}."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        complex_epilogue as epi)

    gen = torch.Generator(device=DEV).manual_seed(seed)
    y = torch.randn(n, 2 * f, device=DEV, generator=gen)
    dz = torch.randn(n, 2 * f, device=DEV, generator=gen)
    bias = torch.randn(f, device=DEV, generator=gen)
    bias[: f // 4] = 0
    y[: n // 3, :f] = y[: n // 3, f:]
    z, mask = epi.complex_epilogue(y, bias, True)
    want, want_mask = epi.complex_epilogue_plain(y, bias, True)
    if not (torch.equal(z, want) and torch.equal(mask, want_mask)):
        raise AssertionError(f"complex_epilogue N={n} F={f} differs from "
                             f"its plain version")
    if not mask[: n // 3, : f // 4].all():
        raise AssertionError("complex_epilogue masked out re = 0")
    same_bits(z, epi.complex_epilogue(y, bias, True)[0], "complex_epilogue")
    uv, db = epi.complex_epilogue_backward(dz, mask, True)
    want_uv, want_db = epi.complex_epilogue_backward_plain(dz, mask, True)
    if not torch.equal(uv, want_uv):
        raise AssertionError(f"complex_epilogue_backward N={n} F={f} "
                             f"differs from its plain version")
    torch.testing.assert_close(db, want_db, rtol=1e-6, atol=1e-5)
    again = epi.complex_epilogue_backward(dz, mask, True)
    same_bits(uv, again[0], "complex_epilogue_backward")
    same_bits(db, again[1], "complex_epilogue_backward")
    del z, want, want_mask, uv, want_uv, again
    nbytes = epi.bytes_moved(n, f)
    cases = {}
    for name, kernel, plain, flops, err in (
            ("complex_epilogue",
             lambda: epi.complex_epilogue(y, bias, True),
             lambda: epi.complex_epilogue_plain(y, bias, True), 6, 0.0),
            ("complex_epilogue_backward",
             lambda: epi.complex_epilogue_backward(dz, mask, True),
             lambda: epi.complex_epilogue_backward_plain(dz, mask, True), 5,
             float((db - want_db).abs().max()))):
        b_ms, b_by = bound(nbytes, flops * n * f)
        cases[name] = dict(
            max_abs_err=err, ms=time_ms(kernel),
            device_ms=back_to_back_ms(kernel), plain_ms=time_ms(plain),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes,
            shape=f"N={n} 2F={2 * f} bias relu float32")
        log_case(f"{name} N={n} 2F={2 * f}", cases[name])
    return cases


def same_bits(a, b, name):
    """Two calls of a kernel on the same inputs gave the same bits."""
    import torch

    if not torch.equal(a, b):
        raise AssertionError(f"{name} is not deterministic")


def scatter_kernel_case(rowptr, split, nnz, width, dtype, seed):
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    n = rowptr.numel() - 1
    gen = torch.Generator(device=DEV).manual_seed(seed)
    msgs = torch.randn(nnz, width, device=DEV, generator=gen).to(dtype)
    got = scatter_csr.csr_scatter_sum(rowptr, msgs, split)
    want = scatter_csr.csr_scatter_sum_plain(rowptr, msgs)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    same_bits(got, scatter_csr.csr_scatter_sum(rowptr, msgs, split),
              "csr_scatter_sum")
    err = float((got - want).abs().max())
    ms = time_ms(lambda: scatter_csr.csr_scatter_sum(rowptr, msgs, split))
    device_ms = back_to_back_ms(
        lambda: scatter_csr.csr_scatter_sum(rowptr, msgs, split))
    plain_ms = time_ms(lambda: scatter_csr.csr_scatter_sum_plain(rowptr,
                                                                 msgs))
    library_ms = library_device_ms = None
    if dtype == torch.float32 and nnz:
        # yardstick only: one segment_reduce over the same rowptr
        offsets = rowptr.long()
        lib = torch.segment_reduce(msgs, "sum", offsets=offsets, axis=0)
        torch.testing.assert_close(lib, want, **F32_TOL)
        library_ms = time_ms(lambda: torch.segment_reduce(
            msgs, "sum", offsets=offsets, axis=0))
        library_device_ms = back_to_back_ms(lambda: torch.segment_reduce(
            msgs, "sum", offsets=offsets, axis=0))
    nbytes = 4 * (n + 1) + msgs.numel() * msgs.element_size() + 4 * n * width
    b_ms, b_by = bound(nbytes, nnz * width)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, library_device_ms=library_device_ms,
                bytes=nbytes,
                shape=f"N={n} nnz={nnz} W={width} {str(dtype)[6:]}")


def small_graph_checks():
    """Duplicate edges, empty rows, ragged widths: kernel vs plain."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    rng = np.random.default_rng(1)
    n_rows, n_cols, e = 3000, 2000, 40000
    row = rng.integers(0, n_rows // 2, e) * 2        # odd rows empty
    col = rng.integers(0, n_cols, e)
    row[:4000], col[:4000] = row[-4000:], col[-4000:]  # duplicates
    va = rng.standard_normal(e).astype(np.float32)
    vb = rng.standard_normal(e).astype(np.float32)
    D = spmm.dual_propagator(row, col, va, vb, n_rows, n_cols, mode="mxu",
                             device=DEV)
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for width in (2, 4, 38, 64, 300):
            x = torch.randn(n_cols, width, device=DEV).to(dtype)
            args = (D.rowptr, D.col, D.val_a, D.val_b, x, width // 2)
            got = scatter_csr.csr_dual_spmm(*args)
            torch.testing.assert_close(
                got, scatter_csr.csr_dual_spmm_plain(*args), **tol)
            if got[1::2].abs().max() != 0:
                raise AssertionError("an empty row was not zeroed")
            msgs = torch.randn(e, width, device=DEV).to(dtype)
            torch.testing.assert_close(
                scatter_csr.csr_scatter_sum(D.rowptr, msgs),
                scatter_csr.csr_scatter_sum_plain(D.rowptr, msgs), **tol)
    log("small graph (duplicates, empty rows, widths 2/4/38/64/300, "
        "f32+bf16): kernels agree with their plain versions")


def small_model_check():
    """Forward and every gradient of the kernel tier on the card against
    the same model on the CPU (plain versions), at N=3000."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    ei, w, x, y = slice_graph(3000, 30, seed=1)
    outs = {}
    for dev in (DEV, "cpu"):
        lap = magnet_propagators(ei, w, q=0.25, num_nodes=3000, mode="mxu",
                                 device=dev)
        model = make_model(dev, seed=1)
        xt = torch.from_numpy(x).to(dev)
        logp = model(xt, xt, lap)
        torch.nn.functional.nll_loss(
            logp, torch.from_numpy(y).to(dev)).backward()
        outs[dev] = [logp.detach()] + [p.grad for p in model.parameters()]
    for a, b in zip(outs[DEV], outs["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    log("small model (N=3000, mxu tier): card forward and all parameter "
        "gradients agree with the CPU at 1e-4")


def magnet_mxu_phase(smi):
    """Phases 2 and 3: K1 on the magnet_mxu operator, then its training."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    n = N
    t0 = time.perf_counter()
    ei, w, x_np, y_np = slice_graph(n, 30, seed=0)
    e = ei.shape[1]
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="auto",
                             device=DEV)
    torch.cuda.synchronize()
    D = lap.dual
    if D is None or D.mode != "mxu" or D.rowptr is None:
        raise AssertionError("mode='auto' did not pick the flat kernel tier")
    nnz = D.col.numel()
    log(f"slice graph: N={n} E={e} Laplacian nnz={nnz} "
        f"(built in {time.perf_counter() - t0:.2f} s)")
    if EXPECTED_E is not None and e != EXPECTED_E:
        raise AssertionError(f"expected the bench's E={EXPECTED_E}, got {e}")

    small_graph_checks()
    cases = {}
    for width in (4, 64):
        for dtype in (torch.float32, torch.bfloat16):
            for op, d in (("fwd", D), ("bwd", D.transposed)):
                r = dual_kernel_case(d, width, dtype, seed=width)
                cases[("csr_dual_spmm", width, dtype, op)] = r
                log_case(f"csr_dual_spmm {op} W={width} {str(dtype)[6:]}", r)
    for width in (4, 64):
        for dtype in (torch.float32, torch.bfloat16):
            r = scatter_kernel_case(D.rowptr, D.row_split, nnz, width,
                                    dtype, seed=width)
            cases[("csr_scatter_sum", width, dtype)] = r
            log_case(f"csr_scatter_sum W={width} {str(dtype)[6:]}", r)
    # the path's epilogue: hidden 32, both layers
    cases.update(epilogue_cases(n, 32, seed=5))

    small_model_check()
    x = torch.from_numpy(x_np).to(DEV)
    y = torch.from_numpy(y_np).to(DEV)
    model = make_model(DEV, seed=0)
    lap_plain = magnet_propagators(ei, w, q=0.25, num_nodes=n,
                                   mode="segment", device=DEV)
    with torch.no_grad():
        torch.testing.assert_close(model(x, x, lap),
                                   model(x, x, lap_plain),
                                   rtol=1e-4, atol=1e-4)
    log("slice forward: kernel tier agrees with the segment tier at 1e-4")
    del lap_plain

    losses, launches, step_ms, wall = train(model, x, y, lap, STEPS)
    # 4 forward applies, 2 transposed ones (layer 2's), all flat: K1; one
    # epilogue a layer each way
    check_launches(launches, {"csr_dual_spmm": 6, **EPILOGUE_STEP}, STEPS,
                   "magnet_mxu")
    with torch.no_grad():
        acc = float((model(x, x, lap).argmax(1) == y).float().mean())
    ms_step = statistics.median(step_ms[1:])
    log(f"slice train: {STEPS} steps, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, train acc {acc:.4f}; launches {launches} "
        f"(6 csr_dual_spmm and {EPILOGUE_STEP} per step)")
    log(f"slice speed on {smi}: median {ms_step:.3f} ms/step "
        f"(first step {step_ms[0]:.3f} ms, mean {wall / STEPS * 1e3:.3f} ms "
        f"by host clock), {e / (ms_step / 1e3):.1f} input edges/s")
    return cases, launches, ms_step


# ---------------------------------------------------------------------------
# giant: K2 on the column-split and streamed layouts


def per_apply(d):
    """The launches one apply of direction ``d`` makes."""
    if d.blocks:
        return {"csr_dual_spmm_accum": len(d.blocks)}
    return {"csr_dual_spmm": 1}


def count_applies(applies):
    """The K1/K2 wrapper calls of ``applies``: each (d, k) is k applies of
    one direction d (a CSR or a DualPropagator) of the kernel tier."""
    expected = {}
    for d, k in applies:
        for name, count in per_apply(d).items():
            expected[name] = expected.get(name, 0) + k * count
    return {name: v for name, v in expected.items() if v}


def plain_apply(d, x, fa):
    """The plain version of one split or streamed apply: the same blocks
    in the same order, each through K2's plain version."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    xm = x.to(spmm._kernel_dtype(x))
    x_hot = xm[d.hot_ids] if d.hot_ids is not None else None
    out = torch.zeros((d.num_nodes, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i, b in enumerate(d.blocks):
        out = scatter_csr.csr_dual_spmm_accum_plain(
            b.rowptr, d.col[b.e0:b.e1], d.val_a[b.e0:b.e1],
            d.val_b[b.e0:b.e1], x_hot if i < d.hot_blocks else xm, fa, out,
            b.row0)
    return out


def accum_kernel_case(D, b, table_rows, width, dtype, seed,
                      what="block 0 of the giant dual", single=False):
    """K2 alone on block ``b`` of ``D``, into a non-zero output: kernel vs
    plain vs two cuSPARSE ``addmm`` (one, for a ``single`` operator)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    gen = torch.Generator(device=DEV).manual_seed(seed)
    n, fa = D.num_nodes, width if single else width // 2
    rows, nnz = b.rowptr.numel() - 1, b.e1 - b.e0
    x = torch.randn(table_rows, width, device=DEV, generator=gen).to(dtype)
    out0 = torch.randn(n, width, device=DEV, generator=gen)
    args = (b.rowptr, D.col[b.e0:b.e1], D.val_a[b.e0:b.e1],
            D.val_b[b.e0:b.e1], x, fa)
    got = scatter_csr.csr_dual_spmm_accum(*args, out0.clone(), b.row0,
                                          b.split)
    want = scatter_csr.csr_dual_spmm_accum_plain(*args, out0, b.row0)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    same_bits(got, scatter_csr.csr_dual_spmm_accum(*args, out0.clone(),
                                                   b.row0, b.split),
              "csr_dual_spmm_accum")
    err = float((got - want).abs().max())
    out = out0.clone()
    ms = time_ms(lambda: scatter_csr.csr_dual_spmm_accum(*args, out, b.row0,
                                                         b.split))
    device_ms = back_to_back_ms(lambda: scatter_csr.csr_dual_spmm_accum(
        *args, out, b.row0, b.split))
    plain_ms = time_ms(
        lambda: scatter_csr.csr_dual_spmm_accum_plain(*args, out0, b.row0))
    library_ms = None
    rp, cl = b.rowptr.long(), args[1].long()
    if dtype == torch.float32 and single:
        # yardstick only: out + A x by cuSPARSE
        A = torch.sparse_csr_tensor(rp, cl, args[2], size=(rows, table_rows))
        o = out0[b.row0:b.row0 + rows]
        torch.testing.assert_close(torch.addmm(o, A, x),
                                   want[b.row0:b.row0 + rows], **LIBRARY_TOL)
        library_ms = time_ms(lambda: torch.addmm(o, A, x))
    elif dtype == torch.float32:
        # yardstick only: out_a + A x_a and out_b + B x_b by cuSPARSE
        A = torch.sparse_csr_tensor(rp, cl, args[2], size=(rows, table_rows))
        B = torch.sparse_csr_tensor(rp, cl, args[3], size=(rows, table_rows))
        oa = out0[b.row0:b.row0 + rows, :fa].contiguous()
        ob = out0[b.row0:b.row0 + rows, fa:].contiguous()
        xa, xb = x[:, :fa].contiguous(), x[:, fa:].contiguous()
        lib = torch.cat([torch.addmm(oa, A, xa), torch.addmm(ob, B, xb)], 1)
        torch.testing.assert_close(lib, want[b.row0:b.row0 + rows],
                                   **LIBRARY_TOL)
        library_ms = time_ms(lambda: (torch.addmm(oa, A, xa),
                                      torch.addmm(ob, B, xb)))
    # K1's bytes, with the output rows read as well as written
    nbytes = (4 * (rows + 1) + (8 if single else 12) * nnz
              + x.numel() * x.element_size() + 8 * rows * width)
    b_ms, b_by = bound(nbytes, 2 * nnz * width)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, bytes=nbytes,
                gathered=nnz * width * x.element_size(),
                shape=f"{what}: rows={rows} nnz={nnz} "
                      f"cut rows={b.split.rows.numel()} "
                      f"pieces={b.split.pieces.shape[0]} "
                      f"table={table_rows} W={width} {str(dtype)[6:]}")


def scatter_accum_case(b, width, seed):
    """K2's own contract on the rowptr of block ``b``, into a non-zero
    output: kernel vs plain."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    gen = torch.Generator(device=DEV).manual_seed(seed)
    rows, nnz = b.rowptr.numel() - 1, b.e1 - b.e0
    msgs = torch.randn(nnz, width, device=DEV, generator=gen)
    out0 = torch.randn(rows, width, device=DEV, generator=gen)
    got = scatter_csr.csr_scatter_accum(b.rowptr, msgs, out0.clone(), 0,
                                        b.split)
    want = scatter_csr.csr_scatter_accum_plain(b.rowptr, msgs, out0)
    torch.testing.assert_close(got, want, **F32_TOL)
    same_bits(got, scatter_csr.csr_scatter_accum(b.rowptr, msgs,
                                                 out0.clone(), 0, b.split),
              "csr_scatter_accum")
    out = out0.clone()
    ms = time_ms(lambda: scatter_csr.csr_scatter_accum(b.rowptr, msgs, out, 0,
                                                       b.split))
    plain_ms = time_ms(
        lambda: scatter_csr.csr_scatter_accum_plain(b.rowptr, msgs, out0))
    # yardstick only: one index_add_ in float32 (atomics)
    ids = torch.repeat_interleave(
        torch.arange(rows, device=DEV), (b.rowptr[1:] - b.rowptr[:-1]).long())
    library_ms = time_ms(lambda: out.index_add_(0, ids, msgs))
    nbytes = 4 * (rows + 1) + msgs.numel() * 4 + 8 * rows * width
    b_ms, b_by = bound(nbytes, nnz * width)
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, bytes=nbytes,
                shape=f"block 0 rowptr: rows={rows} nnz={nnz} W={width} "
                      f"float32")


def hub_row_cases(table_rows, width=64):
    """Every CSR entry on a synthetic CSR holding the giant graph's
    largest row (324,064 edges), rows of one edge fewer than a piece, a
    piece and one edge more, empty rows and 10^5 short rows, gathering
    from a table the size of the giant graph's hot table; f32 and bf16,
    the accumulate entries into a non-zero output.  Kernel vs plain, the
    same bits twice, rows without edges untouched (or 0); the f32 times
    beside the bound."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    L = scatter_csr.PIECE_EDGES
    rng = np.random.default_rng(8)
    lengths = np.concatenate([[324_064, 0, L - 1, L, L + 1, 2 * L + 5, 0],
                              rng.integers(0, 8, 100_000)])
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(DEV)
    split = scatter_csr.plan_row_split(rowptr)
    n, e = len(lengths), int(lengths.sum())
    gen = torch.Generator(device=DEV).manual_seed(9)
    col = torch.randint(0, table_rows, (e,), generator=gen, device=DEV,
                        dtype=torch.int32)
    va, vb, wa, wb = torch.randn(4, e, generator=gen, device=DEV)
    x32 = torch.randn(table_rows, width, generator=gen, device=DEV)
    msgs32 = torch.randn(e, width, generator=gen, device=DEV)
    out0 = torch.randn(n, width, generator=gen, device=DEV)
    out0_pair = torch.randn(n, 2 * width, generator=gen, device=DEV)
    empty = torch.from_numpy(lengths == 0).to(DEV)
    log(f"hub CSR: rows={n} edges={e} largest row={int(lengths.max())} "
        f"cut rows={split.rows.numel()} pieces={split.pieces.shape[0]} "
        f"(piece length {L})")
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        x, msgs = x32.to(dtype), msgs32.to(dtype)
        dual = (rowptr, col, va, vb, x, width // 2)
        pair = (rowptr, col, va, vb, wa, wb, x, width // 2)
        out = out0.clone()
        out_pair = out0_pair.clone()
        # name: (checked call, plain call, timed call (accumulates in
        # place), bytes beyond the inputs' read of rowptr: per edge, the
        # source, and the output read and written or written)
        calls = {
            "csr_dual_spmm": (
                lambda: scatter_csr.csr_dual_spmm(*dual, split),
                lambda: scatter_csr.csr_dual_spmm_plain(*dual),
                lambda: scatter_csr.csr_dual_spmm(*dual, split),
                12 * e + x.numel() * x.element_size() + 4 * n * width),
            "csr_scatter_sum": (
                lambda: scatter_csr.csr_scatter_sum(rowptr, msgs, split),
                lambda: scatter_csr.csr_scatter_sum_plain(rowptr, msgs),
                lambda: scatter_csr.csr_scatter_sum(rowptr, msgs, split),
                msgs.numel() * msgs.element_size() + 4 * n * width),
            "csr_dual_spmm_accum": (
                lambda: scatter_csr.csr_dual_spmm_accum(
                    *dual, out0.clone(), 0, split),
                lambda: scatter_csr.csr_dual_spmm_accum_plain(*dual, out0),
                lambda: scatter_csr.csr_dual_spmm_accum(*dual, out, 0,
                                                        split),
                12 * e + x.numel() * x.element_size() + 8 * n * width),
            "csr_scatter_accum": (
                lambda: scatter_csr.csr_scatter_accum(
                    rowptr, msgs, out0.clone(), 0, split),
                lambda: scatter_csr.csr_scatter_accum_plain(rowptr, msgs,
                                                            out0),
                lambda: scatter_csr.csr_scatter_accum(rowptr, msgs, out, 0,
                                                      split),
                msgs.numel() * msgs.element_size() + 8 * n * width),
            "csr_pair_spmm": (
                lambda: scatter_csr.csr_pair_spmm(*pair, split),
                lambda: scatter_csr.csr_pair_spmm_plain(*pair),
                lambda: scatter_csr.csr_pair_spmm(*pair, split),
                20 * e + x.numel() * x.element_size() + 8 * n * width),
            "csr_pair_spmm_accum": (
                lambda: scatter_csr.csr_pair_spmm_accum(
                    *pair, out0_pair.clone(), 0, split),
                lambda: scatter_csr.csr_pair_spmm_accum_plain(*pair,
                                                              out0_pair),
                lambda: scatter_csr.csr_pair_spmm_accum(*pair, out_pair, 0,
                                                        split),
                20 * e + x.numel() * x.element_size() + 16 * n * width),
        }
        for name, (kernel, plain, timed, nbytes) in calls.items():
            got, want = kernel(), plain()
            torch.testing.assert_close(got, want, **tol)
            same_bits(got, kernel(), name)
            prior = out0_pair if "pair" in name else out0
            if name.endswith("_accum"):
                if not torch.equal(got[empty], prior[empty]):
                    raise AssertionError(f"{name} wrote a row without edges")
            elif got[empty].abs().max() != 0:
                raise AssertionError(f"{name} did not zero a row without "
                                     f"edges")
            err = float((got - want).abs().max())
            if dtype != torch.float32:
                log(f"hub CSR {name} W={width} {str(dtype)[6:]}: agrees "
                    f"with its plain version (max abs err {err:.3g})")
                continue
            nbytes += 4 * (n + 1)
            flops = {"dual": 2, "pair": 4}.get(name.split("_")[1], 1) \
                * e * width
            b_ms, b_by = bound(nbytes, flops)
            r = dict(max_abs_err=err, ms=time_ms(timed),
                     plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, bytes=nbytes)
            if "scatter" not in name:
                r["gathered"] = e * width * x.element_size()
            cases[name] = r
            log_case(f"hub CSR {name} W={width} float32", r)
        cases.update(hub_sddmm_cases(rowptr, split, col, (va, vb, wa, wb), x,
                                     out0, empty, dtype))
    return cases


def short_row_cases(table_rows):
    """The kernels' row blocks: a CSR of 200,000 one- and two-edge rows (a
    tenth empty) beside a hub row of 100,000 edges, rows of the block
    length and one edge more, and uncut rows of 64 to 1,024 edges (which
    csr_scatter_sum walks a warp a row at V = 1).  The dual, plain and
    accumulate, at W = 1, 5, 10, 32 and 64 and at the wide widths 33, 48,
    96 and 128 (the walk's lanes as vectors at 48, 96, 128, strided at 33;
    the row blocks walked, and again in tiles of 32 lanes with the rule of
    ``scatter_csr.WIDE_BLOCK_L2`` set to 0), and ``csr_scatter_sum`` at
    every width from 1 to 40 and at 64 with message rows 16-byte aligned
    and not, f32 and bf16: against the plain version, the same bits twice,
    rows without edges 0 or untouched.  At the wide widths the cut hub row
    is held at LIBRARY_TOL, as the A/B script holds cut rows: its
    compensated f32 pieces lie ~1e-5 of its sums from float64, which
    F32_TOL misses where a lane cancels to near 0, and more lanes make
    such a lane likelier."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    T = scatter_csr.BLOCK_EDGES
    rng = np.random.default_rng(10)
    short = rng.integers(1, 3, 200_000) * (rng.random(200_000) > 0.1)
    lengths = np.concatenate([short[:100_000], [100_000, T, T + 1],
                              [64, 65, 100, 300, 1024], short[100_000:]]
                             ).astype(np.int64)
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int32)).to(DEV)
    split = scatter_csr.plan_row_split(rowptr)
    n, e = len(lengths), int(lengths.sum())
    empty = torch.from_numpy(lengths == 0).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(11)
    col = torch.randint(0, table_rows, (e,), generator=gen, device=DEV,
                        dtype=torch.int32)
    va, vb = torch.randn(2, e, generator=gen, device=DEV)
    log(f"short-row CSR: rows={n} edges={e} row blocks="
        f"{split.blocks.shape[0]} mid rows={split.mids.numel()} walked rows="
        f"{split.walks.numel()} cut rows={split.rows.numel()}")
    worst = {}
    cut = torch.zeros(n, dtype=torch.bool, device=DEV)
    cut[split.rows.long()] = True
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for width in (1, 5, 10, 32, 64):
            x = torch.randn(table_rows, width, generator=gen,
                            device=DEV).to(dtype)
            out0 = torch.randn(n, width, generator=gen, device=DEV)
            args = (rowptr, col, va, vb, x, width // 2)
            for name, kernel, plain in (
                    ("csr_dual_spmm",
                     lambda: scatter_csr.csr_dual_spmm(*args, split),
                     lambda: scatter_csr.csr_dual_spmm_plain(*args)),
                    ("csr_dual_spmm_accum",
                     lambda: scatter_csr.csr_dual_spmm_accum(
                         *args, out0.clone(), 0, split),
                     lambda: scatter_csr.csr_dual_spmm_accum_plain(*args,
                                                                   out0))):
                dual_row_check(name, kernel, plain, tol, tol, cut, empty,
                               out0, f"W={width}", worst, dtype)
        flat = torch.randn(e * 64 + 1, generator=gen, device=DEV).to(dtype)
        for width in [*range(1, 41), 64]:
            for base in (0, 1):
                msgs = flat[base:base + e * width].view(e, width)
                got = scatter_csr.csr_scatter_sum(rowptr, msgs, split)
                want = scatter_csr.csr_scatter_sum_plain(rowptr, msgs)
                torch.testing.assert_close(got, want, **tol)
                same_bits(got, scatter_csr.csr_scatter_sum(rowptr, msgs,
                                                           split),
                          "csr_scatter_sum")
                if not bool(torch.all(got[empty] == 0)):
                    raise AssertionError(f"short-row CSR csr_scatter_sum "
                                         f"W={width}: an empty row not 0")
                key = ("csr_scatter_sum", str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0),
                                 float((got - want).abs().max()))
    wide_dual_cases(rowptr, split, col, va, vb, cut, empty, table_rows,
                    worst)
    log("short-row CSR: every case agrees with its plain version and "
        "repeats bit for bit; max abs err " +
        ", ".join(f"{k[0]} {k[1]} {v:.3g}" for k, v in worst.items()))


def dual_row_check(name, kernel, plain, tol, cut_tol, cut, empty, out0,
                   what, worst, dtype):
    """One dual case of the short-row CSR: the rows at ``tol`` and its cut
    rows at ``cut_tol`` against the plain version, the same bits twice,
    rows without edges 0 (plain) or untouched (accumulate); the worst
    error kept in ``worst``."""
    import torch

    got, want = kernel(), plain()
    torch.testing.assert_close(got[~cut], want[~cut], **tol)
    torch.testing.assert_close(got[cut], want[cut], **cut_tol)
    same_bits(got, kernel(), name)
    untouched = (torch.equal(got[empty], out0[empty])
                 if name.endswith("accum")
                 else bool(torch.all(got[empty] == 0)))
    if not untouched:
        raise AssertionError(f"short-row CSR {name} {what}: a row without "
                             f"edges changed")
    key = (name, str(dtype)[6:])
    worst[key] = max(worst.get(key, 0.0), float((got - want).abs().max()))


def wide_dual_cases(rowptr, split, col, va, vb, cut, empty, table_rows,
                    worst):
    """The dual, plain and accumulate, on the short-row CSR at the wide
    widths 33, 48, 64, 96 and 128, f32 and bf16: the row blocks walked (the
    L2 rule for this table) and in tiles of 32 lanes (the rule set to 0).
    The cut hub row at LIBRARY_TOL in f32 (see short_row_cases)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    n = rowptr.numel() - 1
    gen = torch.Generator(device=DEV).manual_seed(12)
    rule = scatter_csr.WIDE_BLOCK_L2
    try:
        for dtype in (torch.float32, torch.bfloat16):
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            cut_tol = LIBRARY_TOL if dtype == torch.float32 else tol
            for width in (33, 48, 64, 96, 128):
                x = torch.randn(table_rows, width, generator=gen,
                                device=DEV).to(dtype)
                out0 = torch.randn(n, width, generator=gen, device=DEV)
                args = (rowptr, col, va, vb, x, width // 2)
                for tiled in (False, True):
                    scatter_csr.WIDE_BLOCK_L2 = 0 if tiled else rule
                    what = f"W={width} {'tiled' if tiled else 'walked'}"
                    dual_row_check(
                        "csr_dual_spmm",
                        lambda: scatter_csr.csr_dual_spmm(*args, split),
                        lambda: scatter_csr.csr_dual_spmm_plain(*args), tol,
                        cut_tol, cut, empty, out0, what, worst, dtype)
                    dual_row_check(
                        "csr_dual_spmm_accum",
                        lambda: scatter_csr.csr_dual_spmm_accum(
                            *args, out0.clone(), 0, split),
                        lambda: scatter_csr.csr_dual_spmm_accum_plain(
                            *args, out0), tol, cut_tol, cut, empty, out0,
                        what, worst, dtype)
    finally:
        scatter_csr.WIDE_BLOCK_L2 = rule


def hub_sddmm_cases(rowptr, split, col, terms, g, out0, empty, dtype):
    """K3 and K4 on the hub CSR: against the plain version, the same bits
    twice, rows without edges 0 (K3) or untouched (K4); f32 times."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        dual_sddmm)

    n, width = out0.shape
    e, fa = col.numel(), width // 2
    gen = torch.Generator(device=DEV).manual_seed(10)
    x = torch.randn(n, width, generator=gen, device=DEV)
    acc0 = torch.randn(width, generator=gen, device=DEV)
    args = (rowptr, col, *terms, g, x, fa)
    out, acc = out0.clone(), acc0.clone()
    calls = {
        "csr_dual_sddmm": (
            lambda: dual_sddmm.csr_dual_sddmm(*args, split),
            lambda: dual_sddmm.csr_dual_sddmm_plain(*args),
            lambda: dual_sddmm.csr_dual_sddmm(*args, split)),
        "csr_dual_sddmm_accum": (
            lambda: dual_sddmm.csr_dual_sddmm_accum(
                *args, out0.clone(), acc0.clone(), 0, split),
            lambda: dual_sddmm.csr_dual_sddmm_accum_plain(*args, out0, acc0),
            lambda: dual_sddmm.csr_dual_sddmm_accum(*args, out, acc, 0,
                                                    split)),
    }
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    cases = {}
    for name, (kernel, plain, timed) in calls.items():
        got, want = kernel(), plain()
        torch.testing.assert_close(got[0], want[0], **tol)
        torch.testing.assert_close(got[1], want[1], **ACC_TOL)
        again = kernel()
        if not (torch.equal(got[0], again[0]) and
                torch.equal(got[1], again[1])):
            raise AssertionError(f"{name} is not deterministic")
        if name.endswith("_accum"):
            if not torch.equal(got[0][empty], out0[empty]):
                raise AssertionError(f"{name} wrote a row without edges")
        elif got[0][empty].abs().max() != 0:
            raise AssertionError(f"{name} did not zero a row without edges")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if dtype != torch.float32:
            log(f"hub CSR {name} 2F={width} {str(dtype)[6:]}: agrees with "
                f"its plain version (max abs err {err:.3g})")
            continue
        nbytes = sddmm_bytes(n, e, g, width)
        b_ms, b_by = bound(nbytes, 4 * e * width + 2 * n * width)
        r = dict(max_abs_err=err, ms=time_ms(timed),
                 plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, bytes=nbytes)
        cases[name] = r
        log_case(f"hub CSR {name} 2F={width} float32", r)
    return cases


def with_knobs(build, **knobs):
    """``build()`` with ops/layout.py's knobs set to ``knobs`` for the
    call."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import layout

    saved = {k: getattr(layout, k) for k in knobs}
    for k, v in knobs.items():
        setattr(layout, k, v)
    try:
        return build()
    finally:
        for k, v in saved.items():
            setattr(layout, k, v)


def dual_with_knobs(arrays, n, **knobs):
    """The kernel-tier dual of ``arrays`` built with the layout knobs set
    to ``knobs``."""
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm

    return with_knobs(lambda: spmm.dual_propagator(*arrays, n, mode="mxu",
                                                   device=DEV), **knobs)


def giant_phase(smi):
    """Phase 4: the giant graph on the split and streamed layouts (K2)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree)
    from pytorch_geometric_signed_directed_tpu_torch.ops import layout, spmm
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        MagneticPair, magnet_operator_arrays, magnet_propagators)

    g = GIANT
    n = g["nodes"]
    t0 = time.perf_counter()
    row, col = powerlaw_digraph(n, g["edges"], g["alpha"], seed=g["seed"])
    e = len(row)
    ei = np.vstack([row, col])
    w = np.ones(e, np.float32)
    feats = in_out_degree(ei, n, edge_weight=w)
    feats = (feats / max(feats.max(), 1.0)).astype(np.float32)
    # 5 classes with unequal frequencies: the giant bench's uniform random
    # labels leave nothing to learn at this N (their empirical frequencies
    # differ from 1/5 by about 3e-4), and 10 Adam steps then move the loss
    # by less than their own second-order noise
    labels = np.random.default_rng(1).choice(5, n, p=LABEL_FREQ)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu",
                             device=DEV)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    D = lap.dual
    nnz = D.col.numel()
    log(f"giant graph: N={n} E={e} Laplacian nnz={nnz}; host seconds: "
        f"graph + features {t_graph:.2f}, magnet_propagators (Laplacian + "
        f"both layouts, on the card) {t_prep:.2f}")
    if g["expected_e"] is not None and e != g["expected_e"]:
        raise AssertionError(f"expected E={g['expected_e']}, got {e}")
    if g["expected_nnz"] is not None and nnz != g["expected_nnz"]:
        raise AssertionError(f"expected nnz={g['expected_nnz']}, got {nnz}")
    largest = {}
    for name, d in (("forward", D), ("transposed", D.transposed)):
        if d.hot_ids is None or d.hot_ids.numel() != layout.GATHER_FAST_ROWS:
            raise AssertionError(f"giant {name} direction is not "
                                 f"column-split")
        if not d.streamed or len(d.blocks) < 2:
            raise AssertionError(f"giant {name} direction is not streamed")
        lengths = giant_digrac_script().row_lengths(d)
        largest[name] = int(lengths.max())
        hot_edges = d.blocks[d.hot_blocks - 1].e1
        log(f"giant {name}: {len(d.blocks)} blocks ({d.hot_blocks} hot, "
            f"edges per block {[b.e1 - b.e0 for b in d.blocks]}), "
            f"{d.hot_ids.numel()} hot columns cover "
            f"{hot_edges / nnz:.4f} of the edges; largest row "
            f"{largest[name]} edges, rows over 10^5 edges: "
            f"{int((lengths > 100_000).sum())}")

    # the same operator in the flat and split-only layouts, and on the
    # segment tier, from the same host arrays
    t0 = time.perf_counter()
    r, c, vre, vim, _ = magnet_operator_arrays(ei, w, q=0.25, num_nodes=n)
    arrays = (r, c, vre, vim)
    layouts = {
        "flat": dual_with_knobs(arrays, n, COL_SPLIT_MIN_COLS=1 << 60,
                                STREAM_THRESHOLD_EDGES=1 << 60),
        "split": dual_with_knobs(arrays, n, STREAM_THRESHOLD_EDGES=1 << 60),
        "split+streamed": D,
    }
    D_seg = spmm.dual_propagator(*arrays, n, mode="segment", device=DEV)
    torch.cuda.synchronize()
    log(f"giant comparison layouts built in {time.perf_counter() - t0:.2f} s")
    if layouts["flat"].rowptr is None or layouts["split"].streamed or \
            layouts["split"].hot_ids is None:
        raise AssertionError("the knobs did not force the flat and split "
                             "layouts")
    del r, c, vre, vim, arrays

    gen = torch.Generator(device=DEV).manual_seed(2)
    applies = {}
    for width in (4, 64):
        for mdt in (None, "bf16"):
            x = torch.randn(n, width, device=DEV, generator=gen)
            spmm.set_message_dtype(mdt)
            try:
                got = spmm.dual_spmm_stacked(D, x)
                want = plain_apply(D, x, width // 2)
            finally:
                spmm.set_message_dtype(None)
            torch.testing.assert_close(got, want,
                                       **(BF16_TOL if mdt else F32_TOL))
            applies[(width, mdt)] = float((got - want).abs().max())
    log(f"giant apply (split+streamed) vs its plain version, max abs err "
        f"by (width, message type): {applies}")

    k2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        r2 = accum_kernel_case(D, D.blocks[0], D.hot_ids.numel(), 64, dtype,
                               seed=3)
        k2[dtype] = r2
        log_case(f"csr_dual_spmm_accum block 0 W=64 {str(dtype)[6:]}", r2)
    k2_own = scatter_accum_case(D.blocks[0], 64, seed=4)
    log_case("csr_scatter_accum block 0 W=64 float32", k2_own)
    hub_row_cases(D.hot_ids.numel())
    short_row_cases(D.hot_ids.numel())
    # the epilogue at the giant MagNet benchmark cell's shape (hidden 64)
    epi = epilogue_cases(GIANT_CELL_NODES, 64, seed=6)
    torch.cuda.empty_cache()

    # one apply at the path's widest shape, in each layout
    spmm.set_message_dtype("bf16")
    try:
        x = torch.randn(n, 64, device=DEV, generator=gen)
        layout_ms = {name: time_ms(lambda d=d: spmm.dual_spmm_stacked(d, x),
                                   reps=10)
                     for name, d in layouts.items()}
        log(f"giant apply W=64 bf16 messages, ms by layout on {smi}: "
            f"{layout_ms}")
        # where the time of the split+streamed apply goes, block by block
        xm = x.to(torch.bfloat16)
        x_hot = xm[D.hot_ids]
        out = torch.zeros((n, 64), device=DEV)
        for i, b in enumerate(D.blocks):
            lens = b.rowptr[1:] - b.rowptr[:-1]
            def block_k2(b=b, src=(x_hot if i < D.hot_blocks else xm)):
                return scatter_csr.csr_dual_spmm_accum(
                    b.rowptr, D.col[b.e0:b.e1], D.val_a[b.e0:b.e1],
                    D.val_b[b.e0:b.e1], src, 32, out, b.row0, b.split)

            bms = time_ms(block_k2, reps=5)
            cut = b.split.rows.numel()
            log(f"  block {i} ({'hot' if i < D.hot_blocks else 'cold'}): "
                f"rows={lens.numel()} edges={b.e1 - b.e0} largest row "
                f"piece={int(lens.max())} cut rows={cut} (pieces="
                f"{b.split.pieces.shape[0]}, edges in them="
                f"{int(lens[b.split.rows.long()].sum()) if cut else 0}, "
                f"row blocks={b.split.blocks.shape[0]}) kernel_ms={bms:.4f} "
                f"device_ms={back_to_back_ms(block_k2):.4f} gathered="
                f"{(b.e1 - b.e0) * 64 * xm.element_size()} B")
    finally:
        spmm.set_message_dtype(None)
    del layouts

    # forward against the segment tier (f32 messages, "highest"), run in
    # float64: in float32 its atomic sums over the 10^5-edge hub rows
    # drift by about 3e-4 at the output, the kernels' compensated sums do
    # not
    xg = torch.from_numpy(feats).to(DEV)
    y = torch.from_numpy(labels).to(DEV)
    model = make_model(DEV, seed=0)
    lap_seg = MagneticPair(*spmm.propagators_from_dual(D_seg), dual=D_seg)
    with torch.no_grad():
        got = model(xg, xg, lap)
        seg32 = model(xg, xg, lap_seg)
        xd = xg.double()
        ref = make_model(DEV, seed=0).double()(xd, xd, lap_seg).float()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    log(f"giant forward (f32 messages): split+streamed kernel tier agrees "
        f"with the float64 segment tier at 1e-4 (max abs err "
        f"{float((got - ref).abs().max()):.3g}; the float32 segment tier's "
        f"is {float((seg32 - ref).abs().max()):.3g})")
    del lap_seg, D_seg, got, seg32, ref

    # training as scripts/bench_giant.py runs it: bf16 messages, "default"
    spmm.set_message_dtype("bf16")
    spmm.set_matmul_precision("default")
    try:
        losses, launches, step_ms, wall = train(model, xg, y, lap,
                                                g["steps"])
    finally:
        spmm.set_message_dtype(None)
        spmm.set_matmul_precision("highest")
    # 4 forward applies of D and 2 of its transpose (layer 2's backward);
    # one epilogue a layer each way
    expected = dict(EPILOGUE_STEP)
    for d, k in ((D, 4), (D.transposed, 2)):
        for name, count in per_apply(d).items():
            expected[name] = expected.get(name, 0) + k * count
    check_launches(launches, expected, g["steps"], "giant")
    ms_step = statistics.median(step_ms[1:])
    log(f"giant train: {g['steps']} steps, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; launches {launches} ({expected} per step)")
    log(f"giant speed on {smi}: median {ms_step:.3f} ms/step (first step "
        f"{step_ms[0]:.3f} ms, mean {wall / g['steps'] * 1e3:.3f} ms by "
        f"host clock), {e / (ms_step / 1e3):.1f} input edges/s; largest "
        f"rows {largest}")
    return k2, k2_own, launches, epi


# ---------------------------------------------------------------------------
# bsr: K5


def dense_of(op):
    """The BSR operator as a dense [num_rows, num_cols] matrix."""
    import torch

    n_br = op.block_rowptr.numel() - 1
    n_bc = -(-op.num_cols // 128)
    dense = torch.zeros((n_br, n_bc, 128, 128), device=op.blocks.device)
    dense[op.block_rows.long(), op.block_cols.long()] = op.blocks
    dense = dense.permute(0, 2, 1, 3).reshape(n_br * 128, n_bc * 128)
    return dense[:op.num_rows, :op.num_cols].contiguous()


def bsr_kernel_case(op, width, seed):
    """K5 vs plain vs a dense matmul and torch.sparse.mm on a BSR tensor:
    one call between events, 20 back to back (``device_ms``) and a replayed
    CUDA graph of 20 (``graph_ms``); the library call is the faster of the
    two yardsticks, also timed back to back."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import bsr_spmm

    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(op.num_cols, width, device=DEV, generator=gen)
    args = (op.blocks, op.block_rowptr, op.block_cols, x, op.num_rows)

    def kernel():
        return bsr_spmm.bsr_matmul(*args, op.split)

    got = kernel()
    want = bsr_spmm.bsr_matmul_plain(*args)
    torch.testing.assert_close(got, want, **F32_TOL)
    same_bits(got, kernel(), "bsr_spmm")
    ms = time_ms(kernel)
    device_ms = back_to_back_ms(kernel)
    g_ms = graph_ms(kernel)
    plain_ms = time_ms(lambda: bsr_spmm.bsr_matmul_plain(*args))
    # yardsticks only: the dense operator, and cuSPARSE's BSR product
    dense = dense_of(op)
    torch.testing.assert_close(torch.matmul(dense, x), want, **F32_TOL)
    libs = {"dense matmul": lambda: torch.matmul(dense, x)}
    n_br = op.block_rowptr.numel() - 1
    n_bc = -(-op.num_cols // 128)
    x_pad = torch.zeros((n_bc * 128, width), device=DEV)
    x_pad[:op.num_cols] = x
    bsr_note = ""
    try:
        A = torch.sparse_bsr_tensor(op.block_rowptr.long(),
                                    op.block_cols.long(), op.blocks,
                                    size=(n_br * 128, n_bc * 128))
        lib = torch.sparse.mm(A, x_pad)[:op.num_rows]
    except (RuntimeError, NotImplementedError) as exc:
        # this torch has no BSR product on the card: the dense matmul is
        # the only yardstick
        bsr_note = f"torch.sparse.mm on a BSR tensor did not run: {exc}"
    else:
        torch.testing.assert_close(lib, want, **F32_TOL)
        libs["torch.sparse.mm BSR"] = lambda: torch.sparse.mm(A, x_pad)
    lib_ms = {k: time_ms(f) for k, f in libs.items()}
    lib_dev = {k: back_to_back_ms(f) for k, f in libs.items()}
    best = min(lib_ms, key=lib_ms.get)
    del dense, libs
    nb = op.blocks.shape[0]
    nbytes = nb * 128 * 128 * 4 + x.numel() * 4 + op.num_rows * width * 4
    b_ms, b_by = bound(nbytes, 2 * nb * 128 * 128 * width)
    tile = bsr_spmm.tile_config(width)
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                device_ms=device_ms, graph_ms=g_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms[best],
                library_device_ms=lib_dev[best], library=best,
                dense_ms=lib_ms["dense matmul"],
                dense_device_ms=lib_dev["dense matmul"],
                bsr_ms=lib_ms.get("torch.sparse.mm BSR"),
                bsr_device_ms=lib_dev.get("torch.sparse.mm BSR"),
                bsr_note=bsr_note, bytes=nbytes,
                shape=f"N={op.num_rows} blocks={nb} pieces="
                      f"{op.split.pieces.shape[0]} of <= "
                      f"{op.split.piece_len} blocks W={width} float32; tile "
                      f"{tile['tile']} lanes, {tile['stages']} stages, "
                      f"{tile['smem_bytes']} B a CTA")


def bsr_phase(smi):
    """Phase 5: the headline MagNet graph on the bsr tier (K5)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    cfg = BSR_GRAPH
    n = cfg["nodes"]
    t0 = time.perf_counter()
    ei, w, x_np, y_np = slice_graph(n, cfg["avg_deg"], seed=cfg["seed"])
    e = ei.shape[1]
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="bsr",
                             device=DEV)
    torch.cuda.synchronize()
    if lap.dual is not None or lap.re.mode != "bsr" or lap.im.mode != "bsr":
        raise AssertionError("mode='bsr' did not build two single bsr "
                             "operators")
    B = lap.re.bsr
    nb = B.blocks.shape[0]
    log(f"bsr graph: N={n} E={e} blocks={nb} per operator "
        f"({nb * 128 * 128 * 4 / 1e6:.1f} MB of float32 blocks; "
        f"built in {time.perf_counter() - t0:.2f} s)")

    cases = {}
    for width in (2, 32):
        for op_name, op in (("fwd", B), ("bwd", B.transposed)):
            r = bsr_kernel_case(op, width, seed=width)
            cases[(width, op_name)] = r
            log_case(f"bsr_spmm {op_name} W={width}", r)
            bsr = ("did not run" if r["bsr_ms"] is None else
                   f"{r['bsr_ms']:.4f} ms (device {r['bsr_device_ms']:.4f})")
            log(f"  {r['shape']}; yardsticks: dense matmul "
                f"{r['dense_ms']:.4f} ms (device {r['dense_device_ms']:.4f}),"
                f" torch.sparse.mm on a BSR tensor {bsr} {r['bsr_note']}")

    x = torch.from_numpy(x_np).to(DEV)
    y = torch.from_numpy(y_np).to(DEV)
    model = make_model(DEV, seed=0)
    lap_dense = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="dense",
                                   device=DEV)
    with torch.no_grad():
        torch.testing.assert_close(model(x, x, lap), model(x, x, lap_dense),
                                   rtol=1e-4, atol=1e-4)
    log("bsr forward: bsr tier agrees with the dense tier at 1e-4")
    del lap_dense

    losses, launches, step_ms, wall = train(model, x, y, lap, cfg["steps"])
    # per step: 4 forward applies at width 2 (layer 1) and 4 at width 32
    # (layer 2), and 4 transposed applies at width 32 (layer 2's backward)
    check_launches(launches, {"bsr_spmm": 12}, cfg["steps"], "bsr")
    ms_step = statistics.median(step_ms[1:])
    log(f"bsr train: {cfg['steps']} steps, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; launches {launches} (12 bsr_spmm per step)")
    log(f"bsr speed on {smi}: median {ms_step:.3f} ms/step (first step "
        f"{step_ms[0]:.3f} ms, mean {wall / cfg['steps'] * 1e3:.3f} ms by "
        f"host clock), {e / (ms_step / 1e3):.1f} input edges/s")
    return cases, launches


# ---------------------------------------------------------------------------
# trainable q: K3 (and K4 off the path) on the magnet_mxu graph


def template_terms(t, q):
    """(va, vb, wa, wb) of template direction ``t`` at phase ``q``."""
    from pytorch_geometric_signed_directed_tpu_torch.spectral.magnetic \
        import _template_terms

    return _template_terms(t.a_norm, t.theta, q)


def sddmm_bytes(rows, nnz, g, width):
    """Least bytes of one K3/K4 call: rowptr, 20 B per edge, the g table,
    x read and out written once (out read too in the accumulate mode is
    left out: a bound, not a count of what the kernel moves)."""
    return (4 * (rows + 1) + 20 * nnz + g.numel() * g.element_size()
            + 8 * rows * width + 4 * width)


def four_products(rowptr, col, terms, g, fa, n_cols):
    """``[A_va g_a | A_vb g_b | A_wa g_a | A_wb g_b]`` by four cuSPARSE
    products in plain float32: the pair forward's function, and the half
    of K3's."""
    import torch

    rows = rowptr.numel() - 1
    rp, cl = rowptr.long(), col.long()
    mats = [torch.sparse_csr_tensor(rp, cl, v, size=(rows, n_cols))
            for v in terms]
    ga, gb = g[:, :fa].contiguous(), g[:, fa:].contiguous()

    def run():
        return torch.cat([torch.sparse.mm(a, h) for a, h in
                          zip(mats, (ga, gb, ga, gb))], 1)

    return run


def composite_sddmm(rowptr, col, terms, g, x, fa, n_cols):
    """The yardstick: four cuSPARSE products and a sum, the same function
    as K3 in plain float32 (a composite of library calls, not one)."""
    products = four_products(rowptr, col, terms, g, fa, n_cols)
    rows, w = rowptr.numel() - 1, g.shape[1]

    def run():
        both = products()
        return both[:, :w], (x[:rows] * both[:, w:]).sum(0)

    return run


def sddmm_kernel_case(t, q, width, dtype, seed):
    """K3 alone on the flat direction ``t``: kernel vs plain vs the
    composite."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        dual_sddmm)

    n, nnz = t.num_nodes, t.col.numel()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(n, width, device=DEV, generator=gen).to(dtype)
    x = torch.randn(n, width, device=DEV, generator=gen)
    fa = width // 2
    terms = template_terms(t, q)
    args = (t.rowptr, t.col, *terms, g, x, fa)
    got = dual_sddmm.csr_dual_sddmm(*args, t.row_split)
    want = dual_sddmm.csr_dual_sddmm_plain(*args)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)
    again = dual_sddmm.csr_dual_sddmm(*args, t.row_split)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("csr_dual_sddmm is not deterministic")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ms = time_ms(lambda: dual_sddmm.csr_dual_sddmm(*args, t.row_split))
    plain_ms = time_ms(lambda: dual_sddmm.csr_dual_sddmm_plain(*args))
    library_ms = None
    if dtype == torch.float32:
        run = composite_sddmm(t.rowptr, t.col, terms, g, x, fa, n)
        for a, b in zip(run(), want):
            torch.testing.assert_close(a, b, **LIBRARY_TOL)
        library_ms = time_ms(run)
    nbytes = sddmm_bytes(n, nnz, g, width)
    b_ms, b_by = bound(nbytes, 4 * nnz * width + 2 * n * width)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, bytes=nbytes,
                library="composite: 4x torch.sparse.mm + (x*m).sum(0)",
                shape=f"transposed template N={n} nnz={nnz} 2F={width} "
                      f"{str(dtype)[6:]}")


def pair_kernel_case(t, q, width, dtype, seed):
    """K1's ``csr_pair_spmm`` alone on the flat template ``t``: kernel vs
    plain vs the composite of four cuSPARSE products."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    n, nnz = t.num_nodes, t.col.numel()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(n, width, device=DEV, generator=gen).to(dtype)
    fa = width // 2
    terms = template_terms(t, q)
    args = (t.rowptr, t.col, *terms, x, fa)
    got = scatter_csr.csr_pair_spmm(*args, t.row_split)
    want = scatter_csr.csr_pair_spmm_plain(*args)
    torch.testing.assert_close(
        got, want, **(F32_TOL if dtype == torch.float32 else BF16_TOL))
    same_bits(got, scatter_csr.csr_pair_spmm(*args, t.row_split),
              "csr_pair_spmm")
    err = float((got - want).abs().max())
    ms = time_ms(lambda: scatter_csr.csr_pair_spmm(*args, t.row_split))
    plain_ms = time_ms(lambda: scatter_csr.csr_pair_spmm_plain(*args))
    library_ms = None
    if dtype == torch.float32:
        run = four_products(t.rowptr, t.col, terms, x, fa, n)
        torch.testing.assert_close(run(), want, **LIBRARY_TOL)
        library_ms = time_ms(run)
    # rowptr, col and four values per edge, the x table once, the [N, 2W]
    # float32 output once
    nbytes = (4 * (n + 1) + 20 * nnz + x.numel() * x.element_size()
              + 8 * n * width)
    b_ms, b_by = bound(nbytes, 4 * nnz * width)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, bytes=nbytes,
                library="composite: 4x torch.sparse.mm",
                shape=f"template N={n} nnz={nnz} 2F={width} "
                      f"{str(dtype)[6:]}")


def accum_sddmm_case(L, q, width, seed):
    """K4 alone on block 0 (hot) of the split direction ``L``, into a
    non-zero (out, acc): kernel vs plain."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        dual_sddmm)

    n, fa = L.num_nodes, width // 2
    b = L.blocks[0]
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g_hot = torch.randn(L.hot_ids.numel(), width, device=DEV, generator=gen)
    x = torch.randn(n, width, device=DEV, generator=gen)
    out0 = torch.randn(n, width, device=DEV, generator=gen)
    acc0 = torch.randn(width, device=DEV, generator=gen)
    s = slice(b.e0, b.e1)
    args = (b.rowptr, L.col[s], *(v[s] for v in template_terms(L, q)),
            g_hot, x, fa)
    got = dual_sddmm.csr_dual_sddmm_accum(*args, out0.clone(), acc0.clone(),
                                          b.row0, b.split)
    want = dual_sddmm.csr_dual_sddmm_accum_plain(*args, out0, acc0, b.row0)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, **F32_TOL)
    again = dual_sddmm.csr_dual_sddmm_accum(*args, out0.clone(),
                                            acc0.clone(), b.row0, b.split)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError("csr_dual_sddmm_accum is not deterministic")
    err = max(float((a - c).abs().max()) for a, c in zip(got, want))
    out, acc = out0.clone(), acc0.clone()
    ms = time_ms(lambda: dual_sddmm.csr_dual_sddmm_accum(*args, out, acc,
                                                         b.row0, b.split))
    plain_ms = time_ms(lambda: dual_sddmm.csr_dual_sddmm_accum_plain(
        *args, out0, acc0, b.row0))
    rows, nnz = b.rowptr.numel() - 1, b.e1 - b.e0
    # yardstick only: K3's composite on the block (no single PyTorch call
    # computes it), checked once with the priors added
    run = composite_sddmm(b.rowptr, args[1], args[2:6], g_hot,
                          x[b.row0:b.row0 + rows], fa, L.hot_ids.numel())
    lib_out, lib_acc = run()
    out_lib = out0.clone()
    out_lib[b.row0:b.row0 + rows] += lib_out
    torch.testing.assert_close(out_lib, want[0], **LIBRARY_TOL)
    torch.testing.assert_close(acc0 + lib_acc, want[1], **LIBRARY_TOL)
    library_ms = time_ms(run)
    nbytes = sddmm_bytes(rows, nnz, g_hot, width)
    b_ms, b_by = bound(nbytes, 4 * nnz * width + 2 * rows * width)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, bytes=nbytes,
                library="composite: 4x torch.sparse.mm + (x*m).sum(0)",
                shape=f"hot block 0 of the split transposed template: "
                      f"rows={rows} nnz={nnz} table={L.hot_ids.numel()} "
                      f"2F={width} float32")


def reference_apply(seg, q, x, g):
    """Forward, dx and dq of the template apply in float64 on the card,
    from the segment template's edges."""
    import math

    import torch

    row, col = seg.row, seg.col
    a, th = seg.a_norm.double(), seg.theta.double()
    ang = 2 * math.pi * q * th
    scale = 2 * math.pi * th * a
    fa = x.shape[1] // 2
    xd, gd = x.double(), g.double()

    def apply(v_a, v_b, src, dst, table):
        msgs = torch.cat([v_a[:, None] * table[src, :fa],
                          v_b[:, None] * table[src, fa:]], 1)
        return torch.zeros_like(table).index_add_(0, dst, msgs)

    y = apply(-a * torch.cos(ang), a * torch.sin(ang), col, row, xd)
    yp = apply(scale * torch.sin(ang), scale * torch.cos(ang), col, row, xd)
    dx = apply(-a * torch.cos(ang), a * torch.sin(ang), row, col, gd)
    return y, dx, float((gd * yp).sum())


def template_paths_check(tmpl, tmpl_s, seg, n):
    """Forward, dx and dq of the flat and the one-card sharded template on
    the card, and of the segment template (autograd through its values),
    against the float64 reference."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        template_dual_apply, template_propagators)

    gen = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn(n, 64, device=DEV, generator=gen)
    g = torch.randn(n, 64, device=DEV, generator=gen)
    q0 = 0.25
    y_ref, dx_ref, dq_ref = reference_apply(seg, q0, x, g)

    def segment_apply(q, v):
        P_re, P_im = template_propagators(seg, q)
        return torch.cat([P_re(v[:, :32]), P_im(v[:, 32:])], 1)

    errs = {}
    for name, fn, dq_rtol in (
            ("flat", lambda q, v: template_dual_apply(tmpl, q, v), 1e-4),
            ("sharded", lambda q, v: template_dual_apply(tmpl_s, q, v), 1e-3),
            ("segment", segment_apply, 1e-4)):
        q = torch.tensor(q0, device=DEV, requires_grad=True)
        xx = x.clone().requires_grad_(True)
        y = fn(q, xx)
        (y * g).sum().backward()
        y = y.detach()
        torch.testing.assert_close(y.double(), y_ref, **F32_TOL)
        torch.testing.assert_close(xx.grad.double(), dx_ref, **F32_TOL)
        if abs(q.grad.item() - dq_ref) > dq_rtol * abs(dq_ref) + 1e-5:
            raise AssertionError(f"{name} dq {q.grad.item()} vs float64 "
                                 f"{dq_ref}")
        errs[name] = (float((y.double() - y_ref).abs().max()),
                      float((xx.grad.double() - dx_ref).abs().max()),
                      abs(q.grad.item() - dq_ref) / abs(dq_ref))
    log(f"trainable_q apply at 2F=64, q=0.25 against float64 (max abs err "
        f"of y, dx; relative err of dq = {dq_ref:.6f}): {errs}")


def small_trainable_model_check():
    """Forward and every gradient (q included) of the trainable-q model on
    the card, flat and one-card sharded, against the CPU at N=3000."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, shard_magnet_laplacian)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnetic_template)

    ei, w, x, y = slice_graph(3000, 30, seed=1)
    outs = {}
    for dev in (DEV, "cpu"):
        tmpl = magnetic_template(ei, w, num_nodes=3000, mode="mxu",
                                 device=dev)
        laps = {dev: tmpl}
        if dev == DEV:
            laps["sharded"] = shard_magnet_laplacian(tmpl, local_mesh())
        for name, lap in laps.items():
            model = make_model(dev, seed=1, trainable_q=True)
            xt = torch.from_numpy(x).to(dev)
            logp = model(xt, xt, lap)
            torch.nn.functional.nll_loss(
                logp, torch.from_numpy(y).to(dev)).backward()
            outs[name] = [logp.detach()] + [p.grad for p in
                                            model.parameters()]
    for name in (DEV, "sharded"):
        for a, b in zip(outs[name], outs["cpu"]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    log("small trainable-q model (N=3000): card forward and all parameter "
        "gradients, q included, agree with the CPU at 1e-4 (flat and "
        "one-card sharded)")


def trainable_q_phase(smi, frozen_ms):
    """Phase 6: trainable-q MagNet, flat (K1) and one-card sharded (K1
    forward, K3 backward); K3 and K4 against their plain versions."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops import sddmm
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, shard_magnet_laplacian)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnetic_template)

    n = N
    t0 = time.perf_counter()
    ei, w, x_np, y_np = slice_graph(n, 30, seed=0)
    e = ei.shape[1]
    tmpl = magnetic_template(ei, w, num_nodes=n, mode="auto", device=DEV)
    tmpl_s = shard_magnet_laplacian(tmpl, local_mesh())
    torch.cuda.synchronize()
    if tmpl.mode != "mxu" or tmpl.blocks or tmpl.transposed.blocks:
        raise AssertionError("mode='auto' did not pick a flat mxu template")
    if tmpl_s.mode != "mxu_sharded" or tmpl_s.sharded.n_devices != 1:
        raise AssertionError("local_mesh() did not shard onto one card")
    tt = tmpl.transposed
    nnz = tt.col.numel()
    log(f"trainable_q graph: N={n} E={e} template nnz={nnz} (flat and "
        f"one-card sharded templates built in "
        f"{time.perf_counter() - t0:.2f} s)")
    q = torch.tensor(0.25, device=DEV)

    cases = {}
    for width in (4, 64):
        for dtype in (torch.float32, torch.bfloat16):
            r = pair_kernel_case(tmpl, q, width, dtype, seed=width)
            cases[("csr_pair_spmm", width, dtype)] = r
            log_case(f"csr_pair_spmm 2F={width} {str(dtype)[6:]}", r)
            r = sddmm_kernel_case(tt, q, width, dtype, seed=width)
            cases[("csr_dual_sddmm", width, dtype)] = r
            log_case(f"csr_dual_sddmm 2F={width} {str(dtype)[6:]}", r)
    # off the path: K1's own contract at the widths of the [E, 4F]
    # messages the TPU's pair forward scatters, beside torch.segment_reduce
    for width in (8, 128):
        r = scatter_kernel_case(tmpl.rowptr, tmpl.row_split, nnz, width,
                                torch.float32, seed=width)
        cases[("csr_scatter_sum", width)] = r
        log_case(f"csr_scatter_sum (template rowptr) W={width} float32", r)

    # K4 on a split (a quarter of the columns hot) and a streamed (five
    # blocks) layout of the same template
    layouts = {
        "split": with_knobs(lambda: magnetic_template(
            ei, w, num_nodes=n, mode="mxu", device=DEV),
            COL_SPLIT_MIN_COLS=n // 2, GATHER_FAST_ROWS=n // 4,
            COL_SPLIT_MIN_COVERAGE=0.0).transposed,
        "streamed": with_knobs(lambda: magnetic_template(
            ei, w, num_nodes=n, mode="mxu", device=DEV),
            STREAM_THRESHOLD_EDGES=0,
            STREAM_BLOCK_EDGES=-(-nnz // 5)).transposed,
    }
    if layouts["split"].hot_ids is None or layouts["split"].streamed or \
            not layouts["streamed"].streamed:
        raise AssertionError("the knobs did not force the split and "
                             "streamed layouts")
    gen = torch.Generator(device=DEV).manual_seed(5)
    g = torch.randn(n, 64, device=DEV, generator=gen)
    xx = torch.randn(n, 64, device=DEV, generator=gen)
    flat = sddmm.dual_scatter_sddmm(tt, g, *template_terms(tt, q), xx, 32)
    for name, L, entry in (
            ("split", layouts["split"], sddmm.split_dual_scatter_sddmm),
            ("streamed", layouts["streamed"],
             sddmm.streamed_dual_scatter_sddmm)):
        got = entry(L, g, *template_terms(L, q), xx, 32)
        for a, b in zip(got, flat):
            torch.testing.assert_close(a, b, **F32_TOL)
        log(f"K4 over the {name} layout ({len(L.blocks)} blocks, "
            f"{L.hot_blocks} hot): agrees with K3 on the flat one (max abs "
            f"err {max(float((a - b).abs().max()) for a, b in zip(got, flat)):.3g})")
    k4 = accum_sddmm_case(layouts["split"], q, 64, seed=6)
    log_case("csr_dual_sddmm_accum hot block 0 2F=64 float32", k4)
    del layouts, flat, g, xx

    seg = magnetic_template(ei, w, num_nodes=n, mode="segment", device=DEV)
    template_paths_check(tmpl, tmpl_s, seg, n)
    del seg
    small_trainable_model_check()

    x = torch.from_numpy(x_np).to(DEV)
    y = torch.from_numpy(y_np).to(DEV)
    runs = {}
    for name, lap in (("flat", tmpl), ("sharded", tmpl_s)):
        expected = TRAINABLE_Q_STEP[name]
        model = make_model(DEV, seed=0, trainable_q=True)
        losses, launches, step_ms, wall = train(model, x, y, lap, STEPS)
        check_launches(launches, expected, STEPS, f"trainable_q {name}")
        qs = [float(c.q) for c in model.convs]
        if all(v == 0.25 for v in qs):
            raise AssertionError(f"trainable_q {name}: q did not move")
        ms_step = statistics.median(step_ms[1:])
        runs[name] = (launches, ms_step)
        log(f"trainable_q {name} train: {STEPS} steps, loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}, q per layer {qs}; "
            f"launches {launches} ({expected} per step)")
        log(f"trainable_q {name} speed on {smi}: median {ms_step:.3f} "
            f"ms/step (first step {step_ms[0]:.3f} ms, mean "
            f"{wall / STEPS * 1e3:.3f} ms by host clock), "
            f"{e / (ms_step / 1e3):.1f} input edges/s, trainable/frozen "
            f"step ratio {ms_step / frozen_ms:.3f} (frozen {frozen_ms:.3f} "
            f"ms)")
    return cases, k4, runs


# ---------------------------------------------------------------------------
# experiments: the four entry points at N=9000 (K1 and K2)


def layout_text(d):
    """One direction of a kernel-tier dual: its layout and cut rows."""
    if not d.blocks:
        return (f"flat, nnz={d.col.numel()}, cut rows "
                f"{d.row_split.rows.numel()} of {d.num_nodes} "
                f"({d.row_split.pieces.shape[0]} pieces)")
    parts = []
    for b in d.blocks:
        lens = b.rowptr[1:] - b.rowptr[:-1]
        parts.append(f"[rows {int((lens > 0).sum())}, edges {b.e1 - b.e0}, "
                     f"cut {b.split.rows.numel()}]")
    kind = "streamed" if d.streamed else "split"
    return f"{kind}, {len(d.blocks)} blocks " + " ".join(parts)


def experiment_launches(D, K, layers, steps, evals):
    """The K1/K2 wrapper calls of ``steps`` training steps and ``evals``
    evaluation forwards of a ``layers``-layer model of order ``K`` on the
    dual ``D``: a forward applies D K times a layer; the backward applies
    D's transpose K times in every layer but the first, whose input needs
    no gradient."""
    return count_applies([(D, (steps + evals) * layers * K),
                          (D.transposed, steps * (layers - 1) * K)])


@contextlib.contextmanager
def launches_by_step(into):
    """While in the block, append to ``into`` the launches each
    ``Trainer.step_async`` call makes: the counts after it less those
    before (the counters are not reset)."""
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    step_async = Trainer.step_async

    def counted(self, *args):
        before = launch_counts()
        loss = step_async(self, *args)
        after = launch_counts()
        into.append({k: v - before[k] for k, v in after.items()
                     if v != before[k]})
        return loss

    Trainer.step_async = counted
    try:
        yield into
    finally:
        Trainer.step_async = step_async


def check_counts(name, launches, by_step, per_step, steps, evals=None):
    """The run launched ``per_step`` in each of its ``steps`` steps, as
    counted around each, and ``evals`` besides (its evaluation forwards)."""
    evals = evals or {}
    run = {k: per_step.get(k, 0) * steps + evals.get(k, 0)
           for k in set(per_step) | set(evals)}
    for k in set(launches) | set(run):
        if launches.get(k, 0) != run.get(k, 0):
            raise AssertionError(
                f"{name}: {k} launched {launches.get(k, 0)} times, the "
                f"layouts imply {run.get(k, 0)} ({steps} steps of "
                f"{per_step}, evaluation {evals}; {launches})")
    if len(by_step) != steps or any(s != per_step for s in by_step):
        raise AssertionError(
            f"{name}: {len(by_step)} steps counted ({steps} run), launches by "
            f"step {sorted(map(str, by_step))[:3]}, the layouts imply "
            f"{per_step} a step")


def check_losses(name, losses):
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")


def run_main(mod, argv):
    """``mod.main(argv)`` with the launch counters set to 0 just before and
    read just after, and each training step's launches counted around it:
    (result, seconds, launches, launches by step)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)

    torch.cuda.synchronize()
    with launches_by_step([]) as by_step:
        reset_counts()
        t0 = time.perf_counter()
        res = mod.main(argv)
        wall = time.perf_counter() - t0
        launches = launch_counts()
    return res, wall, launches, by_step


def experiment_phase(smi):
    """Phase 7: magnet_node, magnet_link, msgnn_node and msgnn_link
    through their ``main(argv)`` at N=9000, on the layouts ops/layout.py
    picks there; K1 on msgnn_link's flat operator and K2 on one streamed
    block of magnet_node's and msgnn_node's, at 2F = 4, 8, 32, 128."""
    import importlib

    import torch
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        EXPERIMENTS)
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm

    runs, cases = {}, {}
    for name, extra in EXPERIMENT_ARGV.items():
        mod = importlib.import_module(
            "pytorch_geometric_signed_directed_tpu_torch.experiments."
            + EXPERIMENTS[name][0])
        argv = ["--dataset", "synthetic", "--num_nodes", str(EXPERIMENT_N),
                "--epochs", str(EXPERIMENT_EPOCHS), "--device", DEV] + extra
        args = mod.parser().parse_args(argv)
        res, wall, launches, by_step = run_main(mod, argv)
        inputs = res["inputs"]
        lap = (res["runs"][0]["split"].lap if name == "magnet_link"
               else inputs.lap)
        D = lap.dual
        if D is None or D.mode != "mxu":
            raise AssertionError(f"{name}: mode='auto' did not pick the "
                                 f"kernel tier at N={EXPERIMENT_N}")
        steps = sum(r["steps"] for r in res["runs"])
        evals = sum(r["evals"] for r in res["runs"])
        # each training step, as counted around it, launches what the
        # layouts imply for one step; the rest are the evaluation forwards'
        check_counts(name, launches, by_step,
                     experiment_launches(D, args.K, 2, 1, 0), steps,
                     experiment_launches(D, args.K, 2, 0, evals))
        for i, r in enumerate(res["runs"]):
            check_losses(f"{name} split {i}", r["losses"])
            if not 0.0 <= r["acc"] <= 1.0:
                raise AssertionError(f"{name} split {i}: accuracy {r['acc']}")
        graph_edges = (res["runs"][0]["split"].graph_edges
                       if name == "magnet_link" else
                       getattr(inputs, "graph_edges", inputs.num_edges))
        step_ms = [m for r in res["runs"] for m in r["step_ms"][1:]]
        ms_step = statistics.median(step_ms)
        log(f"{name}: N={EXPERIMENT_N} input edges {inputs.num_edges} "
            f"(operator graph {graph_edges}), Laplacian nnz "
            f"{D.col.numel()}, K={args.K} hidden={args.hidden}")
        log(f"  layout forward: {layout_text(D)}")
        log(f"  layout transposed: {layout_text(D.transposed)}")
        log(f"  host seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["host_seconds"].items()))
        log(f"  train on {smi}: {steps} steps in {len(res['runs'])} "
            f"split(s), median {ms_step:.3f} ms/step (first step "
            f"{res['runs'][0]['step_ms'][0]:.3f} ms), training seconds "
            f"{[round(v, 3) for v in res['seconds']]}, main() {wall:.2f} s")
        log(f"  losses (first -> last): " + ", ".join(
            f"{r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}"
            for r in res["runs"]) + f"; test acc {res['accs']}")
        log(f"  launches {launches}: {by_step[0]} in each of {steps} steps "
            f"as counted around each, the rest in {evals} evaluation "
            f"forwards")
        runs[name] = dict(launches=launches, per_step=by_step[0],
                          ms_step=ms_step, host=res["host_seconds"])

        if name == "msgnn_link":
            if D.rowptr is None:
                raise AssertionError("msgnn_link's operator is not flat")
            for width in EXPERIMENT_WIDTHS:
                r = dual_kernel_case(D, width, torch.float32, seed=width)
                r["shape"] = f"msgnn_link flat operator: {r['shape']}"
                cases[(name, width)] = r
                log_case(f"csr_dual_spmm msgnn_link 2F={width} float32", r)
        elif name in ("magnet_node", "msgnn_node"):
            if not D.streamed:
                raise AssertionError(f"{name}'s operator is not streamed")
            b = D.blocks[0]
            lens = b.rowptr[1:] - b.rowptr[:-1]
            rows, cut = int((lens > 0).sum()), b.split.rows.numel()
            # only the block's first and last rows may be partial, and
            # short, at its edge boundaries
            if name == "magnet_node" and cut < rows - 2:
                raise AssertionError(f"magnet_node block 0: {cut} of {rows} "
                                     f"rows cut, expected every row")
            for width in EXPERIMENT_WIDTHS:
                r = accum_kernel_case(
                    D, b, D.num_cols, width, torch.float32, seed=width,
                    what=f"{name} streamed block 0 ({cut} of {rows} rows "
                         f"cut)")
                cases[(name, width)] = r
                log_case(f"csr_dual_spmm_accum {name} block 0 2F={width} "
                         f"float32", r)
            x = torch.randn(D.num_cols, 128, device=DEV)
            torch.testing.assert_close(spmm.dual_spmm_stacked(D, x),
                                       plain_apply(D, x, 64), **F32_TOL)
            log(f"  {name} streamed apply 2F=128 agrees with its plain "
                f"version")
        if name == "magnet_node":
            # off the path: K1 on the same Laplacian laid out flat, where
            # every row (~2,560 entries) is cut
            F = dual_with_knobs(inputs.arrays, D.num_nodes,
                                STREAM_THRESHOLD_EDGES=D.col.numel() + 1)
            rows = int((giant_digrac_script().row_lengths(F) > 0).sum())
            cut = F.row_split.rows.numel()
            if F.blocks or cut != rows:
                raise AssertionError(f"magnet_node flat: {cut} of {rows} "
                                     f"rows cut, expected every row")
            for width in EXPERIMENT_WIDTHS:
                r = dual_kernel_case(F, width, torch.float32, seed=width)
                r["shape"] = (f"magnet_node's Laplacian laid out flat "
                              f"({cut} of {rows} rows cut): {r['shape']}")
                cases[("magnet_node flat", width)] = r
                log_case(f"csr_dual_spmm magnet_node flat 2F={width} "
                         f"float32", r)
            del F
        del res, inputs, lap, D
        torch.cuda.empty_cache()
    return runs, cases


# ---------------------------------------------------------------------------
# directed families: DIGRAC, DiGCN and DGCN (K1 and K2)


def single_view(csr):
    """One kernel-tier operator (a CSR) seen as a dual whose two value
    arrays are its one: what ``_csr_apply`` hands the kernels."""
    from types import SimpleNamespace

    return SimpleNamespace(rowptr=csr.rowptr, col=csr.col, val_a=csr.val,
                           val_b=csr.val, num_nodes=csr.num_rows,
                           num_cols=csr.num_cols, row_split=csr.row_split,
                           blocks=csr.blocks, hot_blocks=csr.hot_blocks,
                           hot_ids=csr.hot_ids, streamed=csr.streamed)


def both_ways(ops, k=1):
    """k applies of each operator and k of its transpose (the backward's:
    every operator of these models sees an input that needs a gradient)."""
    return [(d, k) for op in ops for d in (op, op.transposed)]


def csr_of(P):
    if P.mode != "mxu":
        raise AssertionError(f"mode='auto' gave the {P.mode!r} tier, not "
                             f"the kernel tier")
    return P.csr


def device_profile(name, trainer, state, ms_step, steps=PROFILE_STEPS,
                   batch=()):
    """Traces ``steps`` more steps with torch.profiler (after 2 untraced),
    each given ``batch``: device ms a step, the idle share of an untraced
    step of ``ms_step`` ms (1 - device ms / ms_step), and the kernels that
    take the most device time."""
    for _ in range(2):
        trainer.step_async(state, *batch)
    device_ms, per_step, top = giant_digrac_script().traced_device_ms(
        lambda: trainer.step_async(state, *batch), steps)
    log(f"  device: {device_ms:.4f} ms a step, {per_step:.1f} "
        f"kernels; idle share {1 - device_ms / ms_step:.3f} of a "
        f"{ms_step:.3f} ms step; most: " + "; ".join(
            f"{t:.4f} {n[:60]}" for t, n in top))
    return dict(device_ms=device_ms, idle=1 - device_ms / ms_step,
                kernels_per_step=per_step)


def train_path(name, loss_fn, model, steps, per_step, smi, edges,
               profile_steps=PROFILE_STEPS):
    """``steps`` Adam steps at lr 1e-2 of ``loss_fn`` on ``model``, the
    launch counters set to 0 just before and read just after, each step
    counted around it; requires ``per_step`` launches a step and a falling
    loss.  Returns the run (experiments._common.run_steps) with its
    launches and median ms/step."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.experiments._common \
        import run_steps
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    trainer = Trainer(loss_fn, lr=1e-2, device=DEV)
    state = trainer.init(model)
    torch.cuda.synchronize()
    with launches_by_step([]) as by_step:
        reset_counts()
        run = run_steps(trainer, state, (), steps)
        launches = launch_counts()
    check_counts(name, launches, by_step, per_step, steps)
    check_losses(name, run["losses"])
    ms_step = statistics.median(run["step_ms"][1:])
    log(f"  train on {smi}: {steps} steps, median {ms_step:.3f} ms/step "
        f"(first step {run['step_ms'][0]:.3f} ms), "
        f"{edges / (ms_step / 1e3):.1f} input edges/s; loss "
        f"{run['losses'][0]:.6f} -> {run['losses'][-1]:.6f}")
    log(f"  launches {launches}: {by_step[0]} in each step as counted "
        f"around it")
    return dict(run, launches=launches, per_step=by_step[0], ms_step=ms_step,
                **device_profile(name, trainer, state, ms_step,
                                 steps=profile_steps))


def single_cases(P, widths, label, cases, key):
    """K1 on the single operator ``P`` at each width (f32)."""
    import torch

    v = single_view(csr_of(P))
    if v.blocks:
        raise AssertionError(f"{label}: not flat")
    for width in widths:
        r = dual_kernel_case(v, width, torch.float32, seed=width,
                             single=True)
        r["shape"] = f"{label} (one operator, cut rows " \
                     f"{v.row_split.rows.numel()}): {r['shape']}"
        cases[(key, width)] = r
        log_case(f"csr_dual_spmm {label} W={width} float32", r)


def digrac_experiment(smi, cases):
    """The digrac experiment through ``main(argv)`` at N=9000."""
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        digrac)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        Prob_Imbalance_Loss)

    argv = DIGRAC_ARGV + ["--device", DEV]
    args = digrac.parser().parse_args(argv)
    res, wall, launches, by_step = run_main(digrac, argv)
    inputs, r = res["inputs"], res["runs"][0]
    csrs = [csr_of(P) for P in (inputs.P_s, inputs.P_t, *inputs.A)]
    walks, adj = csrs[:2], csrs[2:]
    per_step = count_applies(both_ways(walks, args.hop) + both_ways(adj))
    evals = count_applies([(c, args.hop) for c in walks]
                          + [(c, 1) for c in adj])
    check_counts("digrac", launches, by_step, per_step, r["steps"], evals)
    check_losses("digrac", r["losses"])
    ms_step = statistics.median(r["step_ms"][1:])
    log(f"digrac: N={args.N} K={args.K} input edges {inputs.num_edges}, "
        f"P_s nnz {csrs[0].col.numel()}, P_A nnz {csrs[2].col.numel()}, "
        f"{args.features} features {tuple(inputs.x.shape)}, hidden "
        f"{args.hidden}, hop {args.hop}")
    for label, c in zip(("P_s", "P_t", "P_A", "P_AT"), csrs):
        log(f"  layout {label}: {layout_text(single_view(c))}")
    log(f"  host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["host_seconds"].items()))
    log(f"  train on {smi}: {r['steps']} steps, median {ms_step:.3f} "
        f"ms/step (first step {r['step_ms'][0]:.3f} ms), main() "
        f"{wall:.2f} s; loss {r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}, "
        f"final {r['loss']:.6f}, ARI {r['ari']:.4f}")
    log(f"  launches {launches}: {by_step[0]} in each of {r['steps']} steps "
        f"as counted around each, {evals} in the evaluation forward")
    trainer = Trainer(digrac.loss_function(args, inputs, Prob_Imbalance_Loss(
        inputs.F)), lr=args.lr, device=DEV)
    prof = device_profile("digrac", trainer, trainer.init(
        digrac.make_model(args, inputs)), ms_step)
    single_cases(inputs.P_s, (3, 32), "digrac P_s", cases, "digrac")
    return dict(launches=launches, per_step=by_step[0], ms_step=ms_step,
                **prof)


def uniform_digraph(n, e, rng):
    """bench.py's uniform random digraph: e (row, col) draws, weights 1,
    normalized degree features."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree)

    ei = np.vstack([rng.integers(0, n, e), rng.integers(0, n, e)])
    w = np.ones(e, np.float32)
    x = in_out_degree(ei, n, edge_weight=w)
    return ei, w, torch.from_numpy(x / max(x.max(), 1.0)).to(DEV)


def bench_digrac_path(fused, graph=None):
    """bench.py's digrac cell (N=65,536, E=2,000,000, K=5, hidden 32, hop
    2, ``Prob_Imbalance_Loss(5)``): its model (seed 0), loss, operators,
    the launches of a step, input edges and host seconds.  ``fused``: the
    walk and adjacency duals in place of the four single operators."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        digrac)
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        DIGRAC_node_clustering)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        Prob_Imbalance_Loss)

    n, e, k = BENCH_DIGRAC["nodes"], BENCH_DIGRAC["edges"], BENCH_DIGRAC["k"]
    hop = 2
    ei, w, x = graph or uniform_digraph(n, e, np.random.default_rng(0))
    t0 = time.perf_counter()
    P_s, P_t, A = digrac.operators(ei, w, n, DEV, fused=fused)
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    if fused:
        per_step = count_applies(both_ways([P_s], hop) + both_ways([A]))
    else:
        per_step = count_applies(
            both_ways([csr_of(P_s), csr_of(P_t)], hop)
            + both_ways([csr_of(P) for P in A]))
    imb = Prob_Imbalance_Loss(k)
    model = DIGRAC_node_clustering(
        num_features=2, hidden=32, nclass=k, hop=hop, device=DEV,
        generator=torch.Generator().manual_seed(0))

    def loss_fn(m):
        return imb(m(P_s, P_t, x)[3], A, k, "vol_sum", "sort")

    return dict(model=model, loss_fn=loss_fn, ops=(P_s, P_t, A),
                per_step=per_step, edges=e, host=host)


def bench_digrac(smi, cases):
    """The digrac cell, 30 steps with the (P_A, P_AT) pair and 30 with the
    fused duals, from one seed: their first losses agree."""
    import torch

    n, e, k = BENCH_DIGRAC["nodes"], BENCH_DIGRAC["edges"], BENCH_DIGRAC["k"]
    graph = uniform_digraph(n, e, np.random.default_rng(0))
    runs = {}
    for form in ("pair", "fused"):
        p = bench_digrac_path(form == "fused", graph)
        P_s, _, A = p["ops"]
        if form == "fused":
            log(f"bench digrac fused: N={n} E={e} K={k}; walk dual nnz "
                f"{P_s.col.numel()} ({layout_text(P_s)}), A dual nnz "
                f"{A.col.numel()} ({layout_text(A)}); built in "
                f"{p['host']:.2f} s")
        else:
            c = csr_of(P_s)
            log(f"bench digrac pair: N={n} E={e} K={k}; P_s nnz "
                f"{c.col.numel()} ({layout_text(single_view(c))}), P_A nnz "
                f"{csr_of(A[0]).col.numel()}; built in {p['host']:.2f} s")
        runs[form] = train_path(f"bench digrac {form}", p["loss_fn"],
                                p["model"], BENCH_DIGRAC["steps"],
                                p["per_step"], smi, e)
        if form == "fused":
            for D, width, key in ((P_s, 64, "walk dual"),
                                  (A, 2 * k, "A dual")):
                r = dual_kernel_case(D, width, torch.float32, seed=width)
                r["shape"] = f"bench digrac {key}: {r['shape']}"
                cases[("bench digrac " + key, width)] = r
                log_case(f"csr_dual_spmm bench digrac {key} 2F={width} "
                         f"float32", r)
        else:
            single_cases(P_s, (k, 32), "bench digrac P_s", cases,
                         "bench digrac")
        del p, P_s, A
    a, b = runs["pair"]["losses"][0], runs["fused"]["losses"][0]
    if abs(a - b) > 1e-5:
        raise AssertionError(f"bench digrac: the first losses of the pair "
                             f"and fused forms differ: {a} vs {b}")
    log(f"  first-step loss: pair {a:.8f}, fused {b:.8f} (|diff| "
        f"{abs(a - b):.3g} <= 1e-5)")
    return runs


def digcn_graph():
    """bench.py's DiGCN inception graph (N=65,536, average degree 15,
    seed 0): edges, weights, features, 5 random labels and the second
    stand-in operator's edges, drawn in the bench's order."""
    import torch

    n, e = DIGCN_GRAPH["nodes"], DIGCN_GRAPH["nodes"] * DIGCN_GRAPH["avg_deg"]
    rng = np.random.default_rng(0)
    ei, w, x = uniform_digraph(n, e, rng)
    y = torch.from_numpy(rng.integers(0, 5, n)).to(DEV)
    ei2 = np.vstack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return n, ei, w, x, y, ei2


def digcn_path(graph=None):
    """The DiGCN inception cell: model (seed 0, hidden 32, 5 labels),
    loss, its two operators, the launches of a step, input edges and host
    seconds."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        norm_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        DiGCN_Inception_Block_node_classification)

    n, ei, w, x, y, ei2 = graph or digcn_graph()
    t0 = time.perf_counter()
    P1 = norm_propagator(ei, w, n, device=DEV)
    P2 = norm_propagator(ei2, w, n, device=DEV)
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    model = DiGCN_Inception_Block_node_classification(
        num_features=2, hidden=32, label_dim=5, device=DEV,
        generator=torch.Generator().manual_seed(0))
    return dict(model=model, ops=(P1, P2), edges=2 * ei.shape[1], host=host,
                loss_fn=lambda m: torch.nn.functional.nll_loss(
                    m(x, P1, P2), y),
                per_step=count_applies(both_ways([csr_of(P1), csr_of(P2)],
                                                 3)))


def dgcn_path(graph=None):
    """DGCN at dgcn_node's hidden 32 on the DiGCN graph, through its own
    operators (``directed_features_in_out``, GCN-normalized): model,
    loss, operators, the launches of a step, input edges and host seconds
    (the in/out graphs, the operators)."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        directed_features_in_out, gcn_norm_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        DGCN_node_classification)

    n, ei, w, x, y, _ = graph or digcn_graph()
    t0 = time.perf_counter()
    idx, e_in, w_in, e_out, w_out = directed_features_in_out(ei, n, w)
    t1 = time.perf_counter()
    Ps = [gcn_norm_propagator(a, b, n, device=DEV)
          for a, b in ((idx, None), (e_in, w_in), (e_out, w_out))]
    torch.cuda.synchronize()
    model = DGCN_node_classification(
        num_features=2, hidden=DGCN_HIDDEN, label_dim=5, device=DEV,
        generator=torch.Generator().manual_seed(0))
    return dict(model=model, ops=Ps, edges=ei.shape[1],
                host=(t1 - t0, time.perf_counter() - t1),
                graphs=(idx.shape[1], e_in.shape[1], e_out.shape[1]),
                loss_fn=lambda m: torch.nn.functional.nll_loss(m(x, *Ps), y),
                per_step=count_applies(both_ways([csr_of(P) for P in Ps],
                                                 2)))


def bench_digcn_and_dgcn(smi, cases):
    """The DiGCN inception cell, then DGCN on the same graph (its in and
    out graphs stream: K2)."""
    import torch

    graph = digcn_graph()
    steps = DIGCN_GRAPH["steps"]
    runs = {}
    p = digcn_path(graph)
    c = csr_of(p["ops"][0])
    log(f"bench digcn inception: N={c.num_rows} E={p['edges']} (2 "
        f"operators), nnz {c.col.numel()} and "
        f"{csr_of(p['ops'][1]).col.numel()} ({layout_text(single_view(c))});"
        f" built in {p['host']:.2f} s")
    runs["digcn"] = train_path("bench digcn inception", p["loss_fn"],
                               p["model"], steps, p["per_step"], smi,
                               p["edges"])
    del p, c

    p = dgcn_path(graph)
    ops = [csr_of(P) for P in p["ops"]]
    log(f"dgcn (dgcn_node's widths, bench graph): N={ops[0].num_rows} "
        f"E={p['edges']}; symmetrized, in and out graphs {p['graphs']} "
        f"edges; host {p['host'][0]:.2f} s, operators {p['host'][1]:.2f} s")
    for label, c in zip(("A_sym", "A_in", "A_out"), ops):
        log(f"  layout {label}: {layout_text(single_view(c))}; transposed "
            f"{layout_text(single_view(c.transposed))}")
    if ops[0].blocks or not (ops[1].streamed and ops[2].streamed):
        raise AssertionError("dgcn: expected A_sym flat, A_in and A_out "
                             "streamed")
    runs["dgcn"] = train_path("dgcn", p["loss_fn"], p["model"], steps,
                              p["per_step"], smi, p["edges"])
    v = single_view(ops[1])
    b = v.blocks[0]
    table = v.hot_ids.numel() if v.hot_blocks > 0 else v.num_cols
    r = accum_kernel_case(v, b, table, DGCN_HIDDEN, torch.float32,
                          seed=DGCN_HIDDEN, single=True,
                          what=f"dgcn A_in block 0 of {len(v.blocks)}")
    cases[("dgcn A_in", DGCN_HIDDEN)] = r
    log_case(f"csr_dual_spmm_accum dgcn A_in block 0 W={DGCN_HIDDEN} "
             f"float32", r)
    xs = torch.randn(v.num_cols, DGCN_HIDDEN, device=DEV)
    torch.testing.assert_close(p["ops"][1](xs),
                               plain_apply(v, xs, DGCN_HIDDEN), **F32_TOL)
    log(f"  A_in streamed apply W={DGCN_HIDDEN} agrees with its plain "
        f"version")
    return runs


def link_experiments(smi):
    """dgcn_link, digcn_link and digcn_inception_link through ``main(argv)``
    at their default size, on the dense tier: no K1/K2 launch."""
    import importlib

    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        _directed_link)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    runs = {}
    for name in LINK_EXPERIMENTS:
        mod = importlib.import_module(
            "pytorch_geometric_signed_directed_tpu_torch.experiments." + name)
        argv = LINK_ARGV + ["--device", DEV]
        res, wall, launches, by_step = run_main(mod, argv)
        r = res["runs"][0]
        if any(P.mode != "dense" for P in r["split"].ops):
            raise AssertionError(f"{name}: expected the dense tier")
        check_counts(name, launches, by_step, {}, r["steps"])
        check_losses(name, r["losses"])
        ms_step = statistics.median(r["step_ms"][1:])
        log(f"{name}: N={res['inputs'].data.num_nodes} input "
            f"edges {res['inputs'].num_edges}, observed graph "
            f"{r['split'].graph_edges}, operator nnz "
            f"{[int((P.dense != 0).sum()) for P in r['split'].ops]}")
        log(f"  host seconds: " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["host_seconds"].items()))
        log(f"  train on {smi}: {r['steps']} steps, median {ms_step:.3f} "
            f"ms/step, main() {wall:.2f} s; loss {r['losses'][0]:.5f} -> "
            f"{r['losses'][-1]:.5f}; test acc {res['accs']}; launches "
            f"{launches}")
        args = mod.parser().parse_args(argv)
        trainer = Trainer(_directed_link.loss_function(r["split"]),
                          lr=args.lr, weight_decay=args.weight_decay,
                          device=DEV)
        runs[name] = dict(ms_step=ms_step, host=res["host_seconds"],
                          **device_profile(name, trainer, trainer.init(
                              mod.make_model(args, res["inputs"])), ms_step))
        del res
    return runs


def directed_phase(smi):
    """Phase 8: the digrac experiment, bench digrac (pair and fused), the
    bench DiGCN inception cell, DGCN on the same graph, and the three
    link experiments; K1 and K2 held at the widths they apply."""
    import torch

    cases, runs = {}, {}
    for name, path in (("digrac", digrac_experiment),
                       ("bench digrac", bench_digrac),
                       ("bench digcn/dgcn", bench_digcn_and_dgcn),
                       ("link", lambda smi, cases: link_experiments(smi))):
        t0 = time.perf_counter()
        out = path(smi, cases)
        runs.update(out if name != "digrac" else {"digrac": out})
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return runs, cases


# ---------------------------------------------------------------------------
# signed families: SSSNET and SGCN (K1, and K2 where the cut streams)


def simpa_applies(hop):
    """(P_p, P_n) applies of one SIMPA forward: hop positive walks of x_p,
    hop - 1 of x_n, hop (hop - 1) / 2 inside the enemy paths, and hop
    negative applies (nn/signed/simpa.py)."""
    return 2 * hop - 1 + hop * (hop - 1) // 2, hop


def sssnet_step_launches(P_p, P_n, hop, cut_ops):
    """The K1/K2 calls of one SSSNET step: SIMPA's applies of the walk
    operators and one apply of each cut operator, each with its
    transposed apply in the backward."""
    a_p, a_n = simpa_applies(hop)
    return count_applies(both_ways([P_p], a_p) + both_ways([P_n], a_n)
                         + both_ways(cut_ops))


def log_host(seconds):
    log(f"  host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items()))


def sssnet_experiment(smi, cases):
    """The sssnet experiment through ``main(argv)`` at N=9000."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        sssnet)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    argv = SSSNET_ARGV + ["--device", DEV]
    args = sssnet.parser().parse_args(argv)
    res, wall, launches, by_step = run_main(sssnet, argv)
    inputs, runs = res["inputs"], res["runs"]
    P_p, P_n = csr_of(inputs.P_p), csr_of(inputs.P_n)
    mat, D_bar = csr_of(inputs.cut.mat), csr_of(inputs.cut.D_bar)
    a_p, a_n = simpa_applies(args.hop)
    steps = sum(r["steps"] for r in runs)
    evals = sum(r["evals"] for r in runs)
    per_step = sssnet_step_launches(P_p, P_n, args.hop, [mat, D_bar])
    # an evaluation forward: SIMPA and the unhappy ratio's own operator
    eval_counts = count_applies([(P_p, a_p * evals), (P_n, a_n * evals),
                                 (csr_of(inputs.unhappy.mat), evals)])
    check_counts("sssnet", launches, by_step, per_step, steps, eval_counts)
    for i, r in enumerate(runs):
        check_losses(f"sssnet split {i}", r["losses"])
        if not -1.0 <= r["ari"] <= 1.0:
            raise AssertionError(f"sssnet split {i}: ARI {r['ari']}")
    ms_step = statistics.median(m for r in runs for m in r["step_ms"][1:])
    log(f"sssnet: N={inputs.data.num_nodes} K={args.K} input edges "
        f"{inputs.num_edges} (positive {inputs.data.edge_index_p.shape[1]}, "
        f"negative {inputs.data.edge_index_n.shape[1]}), features "
        f"{tuple(inputs.x.shape)}, hidden {args.hidden}, hop {args.hop}")
    for label, c in (("P_p", P_p), ("P_n", P_n), ("cut D_p - A", mat),
                     ("cut D_bar", D_bar)):
        log(f"  layout {label}: {layout_text(single_view(c))}; transposed "
            f"{layout_text(single_view(c.transposed))}")
    log_host(res["host_seconds"])
    log(f"  train on {smi}: {steps} steps in {len(runs)} splits, median "
        f"{ms_step:.3f} ms/step (first step {runs[0]['step_ms'][0]:.3f} ms),"
        f" training seconds {[round(v, 3) for v in res['seconds']]}, main() "
        f"{wall:.2f} s")
    log(f"  losses (first -> last): " + ", ".join(
        f"{r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}" for r in runs)
        + f"; test ARI {[round(r['ari'], 4) for r in runs]}, unhappy "
        f"{[round(r['unhappy'], 4) for r in runs]}")
    log(f"  launches {launches}: {by_step[0]} in each of {steps} steps as "
        f"counted around each, {eval_counts} in {evals} evaluation forwards")
    triplets, nsc, ncl = sssnet.triplet_batches(args, inputs, 1)
    trainer = Trainer(sssnet.loss_function(inputs, 0, nsc, ncl), lr=args.lr,
                      device=DEV)
    prof = device_profile("sssnet", trainer, trainer.init(
        sssnet.make_model(args, inputs)), ms_step, batch=(triplets[0],))
    if mat.streamed:
        v = single_view(mat)
        b = v.blocks[0]
        r = accum_kernel_case(
            v, b, v.num_cols, args.K, torch.float32, seed=args.K,
            single=True,
            what=f"sssnet cut block 0 of {len(v.blocks)}")
        cases[("sssnet cut", args.K)] = r
        log_case(f"csr_dual_spmm_accum sssnet cut block 0 W={args.K} "
                 f"float32", r)
        xs = torch.randn(v.num_cols, args.K, device=DEV)
        torch.testing.assert_close(inputs.cut.mat(xs),
                                   plain_apply(v, xs, args.K), **F32_TOL)
        log(f"  cut streamed apply W={args.K} agrees with its plain version")
    return dict(launches=launches, per_step=by_step[0], ms_step=ms_step,
                host=res["host_seconds"], **prof)


def bench_sssnet(smi, cases):
    """bench.py's SSSNET cell: uniform signed edges (seed 0), signed degree
    features, SSSNET (K=5, hidden 16, hop 2, dropout 0) trained on the
    balanced normalized cut alone."""
    import scipy.sparse as sp
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        in_out_degree, rw_norm_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.nn import (
        SSSNET_node_clustering)
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        Prob_Balanced_Normalized_Loss)

    c = BENCH_SSSNET
    n, k, hop = c["nodes"], c["k"], c["hop"]
    host = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    ei = np.vstack([rng.integers(0, n, m), rng.integers(0, n, m)])
    sign = np.concatenate([np.ones(c["e_pos"]),
                           -np.ones(c["e_neg"])]).astype(np.float32)
    ei_p, ei_n = ei[:, sign > 0], ei[:, sign < 0]
    w_p, w_n = sign[sign > 0], -sign[sign < 0]
    A_p = sp.csr_matrix((w_p, (ei_p[0], ei_p[1])), shape=(n, n))
    A_n = sp.csr_matrix((w_n, (ei_n[0], ei_n[1])), shape=(n, n))
    host["graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = in_out_degree(ei, n, signed=True, edge_weight=sign)
    x = torch.from_numpy(np.asarray(x, np.float32)
                         / max(float(np.abs(x).max()), 1.0)).to(DEV)
    host["features"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    P_p = rw_norm_propagator(ei_p, w_p, n, fill_value=0.5, device=DEV)
    P_n = rw_norm_propagator(ei_n, w_n, n, fill_value=0.0, device=DEV)
    cut = Prob_Balanced_Normalized_Loss(A_p, A_n, device=DEV)
    torch.cuda.synchronize()
    host["operators"] = time.perf_counter() - t0
    ops = [csr_of(P) for P in (P_p, P_n, cut.mat, cut.D_bar)]
    per_step = sssnet_step_launches(ops[0], ops[1], hop, ops[2:])
    log(f"bench sssnet: N={n} E={m} ({c['e_pos']} positive, {c['e_neg']} "
        f"negative draws), K={k}, hidden {c['hidden']}, hop {hop}")
    for label, op in zip(("P_p", "P_n", "cut D_p - A", "cut D_bar"), ops):
        log(f"  layout {label}: {layout_text(single_view(op))}")
    log_host(host)
    model = SSSNET_node_clustering(
        nfeat=4, hidden=c["hidden"], nclass=k, dropout=0.0, hop=hop,
        device=DEV, generator=torch.Generator().manual_seed(0))
    run = train_path("bench sssnet", lambda mo: cut(mo(P_p, P_n, x)[3]),
                     model, c["steps"], per_step, smi, m)
    single_cases(P_p, (c["hidden"], k), "bench sssnet P_p", cases,
                 "bench sssnet P_p")
    single_cases(cut.D_bar, (k,), "bench sssnet D_bar", cases,
                 "bench sssnet D_bar")
    return {"bench sssnet": dict(run, host=host)}


def sgcn_samples(pos, neg, n, sets, rng):
    """``sets`` draws of SGCN's non-edges and positive and negative
    triplets by the port's samplers, on the card: their host seconds."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.utils import (
        negative_sampling, structured_negative_sampling)

    both = np.concatenate([pos, neg], 1)
    t0 = time.perf_counter()
    drawn = [(negative_sampling(both, n, rng=rng),
              structured_negative_sampling(pos, n, rng=rng),
              structured_negative_sampling(neg, n, rng=rng))
             for _ in range(sets)]
    seconds = time.perf_counter() - t0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)

    return [(dev(a), [dev(v) for v in b], [dev(v) for v in c])
            for a, b, c in drawn], seconds


def bench_sgcn(smi, cases):
    """bench.py's SGCN cell, 30 steps with the two mean operators and 30
    with the fused dual, from one seed and the same samples: their first
    losses agree."""
    import itertools

    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import SGCN
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sgcn import (
        prepare_sgcn_inputs, split_signed_edges)

    c = BENCH_SGCN
    n, dim, steps = c["nodes"], c["dim"], c["steps"]
    rng = np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    t0 = time.perf_counter()
    edge_s = np.column_stack([
        rng.integers(0, n, m), rng.integers(0, n, m),
        np.concatenate([np.ones(c["e_pos"]), -np.ones(c["e_neg"])])
    ]).astype(np.int64)
    init_emb = rng.standard_normal((n, dim)).astype(np.float32)
    graph_s = time.perf_counter() - t0
    pos, neg = split_signed_edges(edge_s)
    samples, sample_s = sgcn_samples(pos, neg, n, steps,
                                     np.random.default_rng(1))
    log(f"bench sgcn: N={n} E={m} ({pos.shape[1]} positive, "
        f"{neg.shape[1]} negative), in/out {dim}, 2 layers; graph "
        f"{graph_s:.2f} s")
    log(f"  samplers: {steps} sets of {samples[0][0].shape[1]} non-edges "
        f"and {pos.shape[1]} + {neg.shape[1]} triplets on the host in "
        f"{sample_s:.2f} s ({sample_s / steps * 1e3:.1f} ms a set)")
    pos_t = torch.from_numpy(pos).to(DEV)
    neg_t = torch.from_numpy(neg).to(DEV)
    runs = {}
    for form in ("pair", "fused"):
        t0 = time.perf_counter()
        _, _, emb, P_pos, P_neg = prepare_sgcn_inputs(
            n, edge_s, in_dim=dim, init_emb=init_emb, fused=form == "fused",
            device=DEV)
        torch.cuda.synchronize()
        host = {"graph": graph_s, "samplers": sample_s,
                "operators": time.perf_counter() - t0}
        if form == "fused":
            ops = [P_pos]
            log(f"bench sgcn fused: dual nnz {P_pos.col.numel()} "
                f"({layout_text(P_pos)}); built in {host['operators']:.2f} s")
        else:
            ops = [csr_of(P_pos), csr_of(P_neg)]
            log(f"bench sgcn pair: P_pos nnz {ops[0].col.numel()} "
                f"({layout_text(single_view(ops[0]))}), P_neg nnz "
                f"{ops[1].col.numel()}; built in {host['operators']:.2f} s")
        # layer 1 applies each operator once, layer 2 twice; the embedding
        # is a parameter, so every apply has its transposed apply
        per_step = count_applies(both_ways(ops, 3))
        model = SGCN(n, in_dim=dim, out_dim=dim, init_emb=emb,
                     init_emb_grad=True, device=DEV,
                     generator=torch.Generator().manual_seed(0))
        cycle = itertools.cycle(samples)

        def loss_fn(mo, P_pos=P_pos, P_neg=P_neg, cycle=cycle):
            none, pt, nt = next(cycle)
            return mo.loss(P_pos, P_neg, pos_t, neg_t, none, pt, nt)

        runs[f"bench sgcn {form}"] = dict(
            train_path(f"bench sgcn {form}", loss_fn, model, steps, per_step,
                       smi, m), host=host)
        if form == "fused":
            for width in (2 * dim, dim):
                r = dual_kernel_case(P_pos, width, torch.float32, seed=width)
                r["shape"] = f"bench sgcn dual: {r['shape']}"
                cases[("bench sgcn dual", width)] = r
                log_case(f"csr_dual_spmm bench sgcn dual 2F={width} float32",
                         r)
        del P_pos, P_neg, model, ops
    a = runs["bench sgcn pair"]["losses"][0]
    b = runs["bench sgcn fused"]["losses"][0]
    if abs(a - b) > 1e-5 * max(1.0, abs(a)):
        raise AssertionError(f"bench sgcn: the first losses of the pair and "
                             f"fused forms differ: {a} vs {b}")
    log(f"  first-step loss: pair {a:.8f}, fused {b:.8f} (|diff| "
        f"{abs(a - b):.3g})")
    return runs


def signed_phase(smi):
    """Phase 9: the sssnet experiment, the bench SSSNET cell and the bench
    SGCN cell (pair and fused); K1 and K2 held at the widths they apply."""
    import torch

    cases, runs = {}, {}
    for name, path in (("sssnet", sssnet_experiment),
                       ("bench sssnet", bench_sssnet),
                       ("bench sgcn", bench_sgcn)):
        t0 = time.perf_counter()
        out = path(smi, cases)
        runs.update(out if name != "sssnet" else {"sssnet": out})
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return runs, cases


# ---------------------------------------------------------------------------
# signed attention: SNEA, SiGAT and SDGNN (K1 csr_scatter_sum)


def attention_case(plan, width, label, path, cases):
    """K1 ``csr_scatter_sum`` on an attention CSR at one width (f32),
    against its plain version and ``torch.segment_reduce``."""
    import torch

    r = scatter_kernel_case(plan.rowptr, plan.split, plan.row_ids.numel(),
                            width, torch.float32, seed=width)
    r["shape"] = (f"{label} (cut rows {plan.split.rows.numel()}): "
                  f"{r['shape']}")
    r["path"] = path
    cases[(label, width)] = r
    log_case(f"csr_scatter_sum {label} W={width} float32", r)


def graph_text(plan):
    lens = plan.rowptr[1:] - plan.rowptr[:-1]
    return (f"{plan.row_ids.numel()} edges over {plan.num_rows} rows, "
            f"longest {int(lens.max())}, cut rows {plan.split.rows.numel()}")


def snea_path(name, c, smi, cases):
    """bench.py's SNEA cell (``bench_snea``): uniform positive and negative
    draws (seed 0), a standard-normal input embedding as a parameter,
    SNEA(in 32, out 32, 2 layers) trained on ``SNEA.loss`` over ``steps``
    sample sets drawn before training (the bench trains (z**2).sum())."""
    import itertools

    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import SNEA
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        snea_graphs)

    n, dim, steps = c["nodes"], c["dim"], c["steps"]
    host = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pos = np.vstack([rng.integers(0, n, c["e_pos"]),
                     rng.integers(0, n, c["e_pos"])])
    neg = np.vstack([rng.integers(0, n, c["e_neg"]),
                     rng.integers(0, n, c["e_neg"])])
    init_emb = rng.standard_normal((n, dim)).astype(np.float32)
    host["graph"] = time.perf_counter() - t0
    samples, host["samplers"] = sgcn_samples(pos, neg, n, steps,
                                             np.random.default_rng(1))
    t0 = time.perf_counter()
    graphs = snea_graphs(pos, neg, n, device=DEV)
    torch.cuda.synchronize()
    host["attention graphs"] = time.perf_counter() - t0
    m = c["e_pos"] + c["e_neg"]
    log(f"{name}: N={n} E={m} ({c['e_pos']} positive, {c['e_neg']} "
        f"negative draws), in/out {dim}, 2 layers")
    for label, g in zip(("g_pos", "g_neg", "g_cat"), graphs):
        log(f"  {label}: {graph_text(g.plan)}")
    log_host(host)
    model = SNEA(n, in_dim=dim, out_dim=dim, init_emb=init_emb, device=DEV,
                 generator=torch.Generator().manual_seed(0))
    if not model.convs[0].fused:
        raise AssertionError(f"{name}: layer 2 does not take the fused pair")
    pos_t = torch.from_numpy(pos).to(DEV)
    neg_t = torch.from_numpy(neg).to(DEV)
    cycle = itertools.cycle(samples)

    def loss_fn(mo):
        none, pt, nt = next(cycle)
        return mo.loss(graphs, pos_t, neg_t, none, pt, nt)

    # layer 1 attends on g_pos and on g_neg (W = 1 + 16), layer 2 the
    # fused pair on g_cat (W = 2 + 32); the backward of each is a gather
    run = train_path(name, loss_fn, model, steps, {"csr_scatter_sum": 3},
                     smi, m)
    half = dim // 2
    attention_case(graphs[0].plan, 1 + half, f"{name} g_pos", name, cases)
    attention_case(graphs[2].plan, 2 + 2 * half, f"{name} g_cat", name,
                   cases)
    return {name: dict(run, host=host)}


def motif_paths(model_name, smi, cases):
    """bench.py's SiGAT (``bench_sigat``) or SDGNN (``bench_sdgnn``) cell:
    bitcoin_alpha-scale uniform signed edges (seed 0), the spectral input
    embedding of width 20; 30 steps of the model's loss with one GAT a
    motif graph, then 30 with the fused motif stack from the same
    weights (``stack_state_dict``), whose first losses agree."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import SDGNN, SiGAT
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        motif_stack, prepare_sdgnn_inputs, prepare_sigat_inputs,
        split_signed_edges)
    from pytorch_geometric_signed_directed_tpu_torch.spectral.features \
        import create_spectral_features

    c = BENCH_MOTIF
    n, dim, steps = c["nodes"], c["dim"], c["steps"]
    sigat = model_name == "sigat"
    host = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    edges = np.column_stack([
        rng.integers(0, n, m), rng.integers(0, n, m),
        np.concatenate([np.ones(c["e_pos"]), -np.ones(c["e_neg"])])
    ]).astype(np.int64)
    host["graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb = create_spectral_features(*split_signed_edges(edges), n, dim)
    host["features"] = time.perf_counter() - t0
    prepare = prepare_sigat_inputs if sigat else prepare_sdgnn_inputs
    inputs = {}
    for form in ("per-motif", "fused"):
        t0 = time.perf_counter()
        inputs[form] = prepare(n, edges, in_dim=dim, init_emb=emb,
                               fused=form == "fused", device=DEV)
        torch.cuda.synchronize()
        host[f"motifs and graphs, {form}"] = time.perf_counter() - t0
    lists, stack = inputs["per-motif"][3], inputs["fused"][3]
    G = len(lists)
    log(f"bench {model_name}: N={n} E={m} ({c['e_pos']} positive, "
        f"{c['e_neg']} negative draws), {G} motif graphs of "
        f"{sum(g.src.numel() for g in lists)} edges (loops included), "
        f"in/out {dim}")
    log(f"  largest motif graph: {graph_text(lists[0].plan)}; stack: "
        f"{graph_text(stack.g.plan)}; source CSR "
        f"{graph_text(stack.src_plan)}")
    log_host(host)
    cls = SiGAT if sigat else SDGNN
    kw = dict(in_dim=dim, out_dim=dim, init_emb=emb, device=DEV)
    per = cls(n, generator=torch.Generator().manual_seed(0), **kw)
    fused = cls(n, fused=True, **kw)
    fused.load_state_dict(motif_stack.stack_state_dict(per.state_dict()))
    layers = 1 if sigat else len(per.layers)
    runs = {}
    for form, model, graphs, per_step in (
            ("per-motif", per, lists, {"csr_scatter_sum": G * layers}),
            ("fused", fused, stack, {"csr_scatter_sum": 3 * layers,
                                     "csr_scatter_sum_indexed": 2 * layers,
                                     "attend_logit_grad": layers})):
        pos, neg = (torch.from_numpy(a).to(DEV)
                    for a in inputs[form][:2])
        extra = [torch.from_numpy(a).to(DEV) for a in inputs[form][4:]]

        def loss_fn(mo, graphs=graphs, pos=pos, neg=neg, extra=extra):
            return mo.loss(graphs, pos, neg, *extra)

        # per motif one K1 forward a GAT (W = 1 + 20), its backward a
        # gather; fused one forward a layer (W = 21 over G N rows, its
        # messages read by index) and two in motif_attend's backward (W =
        # 21 by source, read by index, and W = 1 by destination), with the
        # edge kernel once
        name = f"bench {model_name} {form}"
        runs[name] = dict(
            train_path(name, loss_fn, model, steps, per_step, smi, m),
            host=host)
    a = runs[f"bench {model_name} per-motif"]["losses"][0]
    b = runs[f"bench {model_name} fused"]["losses"][0]
    if abs(a - b) > 1e-5 * max(1.0, abs(a)):
        raise AssertionError(f"bench {model_name}: the first losses of the "
                             f"per-motif and fused forms differ: {a} vs {b}")
    log(f"  first-step loss: per-motif {a:.6f}, fused {b:.6f} (|diff| "
        f"{abs(a - b):.3g})")
    if not sigat:
        attend_case(stack, dim, "sdgnn stack edges", "bench sdgnn fused",
                    cases)
    if sigat:
        path = "bench sigat"
        attention_case(lists[0].plan, dim + 1, "sigat motif 0",
                       f"{path} per-motif", cases)
        attention_case(stack.g.plan, dim + 1, "sigat stack by destination",
                       f"{path} fused", cases)
        attention_case(stack.src_plan, dim + 1, "sigat stack by source",
                       f"{path} fused", cases)
        attention_case(stack.g.plan, 1, "sigat stack by destination",
                       f"{path} fused", cases)
    return runs


def attention_entries(runs, cases):
    """The ``kernels`` entries of phase 10: K1's own contract on the
    attention CSRs, and the motif attend's edge kernel on the bench SDGNN
    stack, with the launches of the path each case belongs to."""
    out = []
    for r in cases.values():
        name = r.get("kernel", "csr_scatter_sum")
        k1 = name == "csr_scatter_sum"
        out.append({**kernel_entry(
            name, r, runs[r["path"]]["launches"][name],
            "scatter_csr.cu" if k1 else "attend_grad.cu",
            "scatter_mxu.py:503" if k1 else None),
            "path": r["path"], "launches_per_step":
                runs[r["path"]]["per_step"][name],
            "library": "torch.segment_reduce" if k1 else None})
    return out


def attention_phase(smi):
    """Phase 10: the bench SNEA cell and SNEA at epinions scale, the bench
    SiGAT and SDGNN cells (per motif and fused); K1 ``csr_scatter_sum``
    held at the widths they run."""
    import torch

    cases, runs = {}, {}
    for name, path in (
            ("bench snea", lambda: snea_path("bench snea", BENCH_SNEA, smi,
                                             cases)),
            ("snea epinions", lambda: snea_path("snea epinions",
                                                SNEA_EPINIONS, smi, cases)),
            ("bench sigat", lambda: motif_paths("sigat", smi, cases)),
            ("bench sdgnn", lambda: motif_paths("sdgnn", smi, cases))):
        t0 = time.perf_counter()
        runs.update(path())
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return runs, cases


def indexed_case(label, rowptr, split, table, kw, cases):
    """K1 reading its messages by index (``csr_scatter_sum(..., index=)``)
    against its plain version (float64 over the materialized messages),
    twice the same bits, timed beside its bound (``port_bench``'s
    ``cost_scatter``: row pointers, the [E, W] messages read once, the
    output written once) and beside what it replaces: the messages
    gathered (and weighted, concatenated, reordered) by PyTorch, then K1
    over them."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        scatter_csr)

    def kernel():
        return scatter_csr.csr_scatter_sum(rowptr, table, split, **kw)

    def replaced():
        return scatter_csr.csr_scatter_sum(
            rowptr, scatter_csr.indexed_messages(table, **kw), split)

    got = kernel()
    wide = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in kw.items()}
    want = scatter_csr.csr_scatter_sum_plain(
        rowptr, scatter_csr.indexed_messages(table.double(), **wide))
    torch.testing.assert_close(got.double(), want, **F32_TOL)
    same_bits(got, kernel(), "csr_scatter_sum (indexed)")
    n, w, nnz = got.shape[0], got.shape[1], kw["index"].numel()
    nbytes = 4 * (n + 1) + 4 * nnz * w + 4 * n * w
    b_ms, b_by = bound(nbytes, nnz * w)
    r = dict(max_abs_err=float((got.double() - want).abs().max()),
             ms=time_ms(kernel), device_ms=back_to_back_ms(kernel),
             graph_ms=graph_ms(kernel), plain_ms=time_ms(
                 lambda: scatter_csr.csr_scatter_sum_plain(
                     rowptr, scatter_csr.indexed_messages(table, **kw))),
             replaced_ms=back_to_back_ms(replaced),
             replaced_graph_ms=graph_ms(replaced), bound_ms=b_ms,
             bound_by=b_by, library_ms=None, bytes=nbytes,
             shape=f"{label}: N={n} nnz={nnz} W={w} (cut rows "
                   f"{split.rows.numel()})")
    cases[label] = r
    log_case(f"csr_scatter_sum indexed {label}", r)
    log(f"  replaced (PyTorch's gather + K1): device_ms="
        f"{r['replaced_ms']:.4f} graph_ms={r['replaced_graph_ms']}")


def attend_case(ms, f, label, path, cases):
    """The motif attend backward's edge kernel (``attend_logit_grad``) on
    the stack ``ms`` at width ``f``, random inputs, against its plain
    version (the [E, F] gathers it replaces), twice the same bits, timed
    beside its bound."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        attend_grad)

    gen = torch.Generator(device=DEV).manual_seed(f)
    gn, e = ms.g.num_nodes, ms.g.src.numel()
    T, out, dout = (torch.randn(gn, f, device=DEV, generator=gen)
                    for _ in range(3))
    alpha = torch.rand(e, device=DEV, generator=gen)
    pre = torch.randn(e, device=DEV, generator=gen)
    args = (ms.g.dst, ms.g.src, T, out, dout, alpha, pre, 0.2)

    def kernel():
        return attend_grad.attend_logit_grad(*args)

    got = kernel()
    want = attend_grad.attend_logit_grad_plain(*args)
    torch.testing.assert_close(got, want, **F32_TOL)
    same_bits(got, kernel(), "attend_logit_grad")
    # an edge's two int64 indices, alpha, pre, dpre and its T row; each
    # destination's out and dout rows once
    nbytes = e * (2 * 8 + 3 * 4 + 4 * f) + 2 * 4 * gn * f
    b_ms, b_by = bound(nbytes, 3 * e * f)
    r = dict(max_abs_err=float((got - want).abs().max()), ms=time_ms(kernel),
             device_ms=back_to_back_ms(kernel), graph_ms=graph_ms(kernel),
             plain_ms=time_ms(
                 lambda: attend_grad.attend_logit_grad_plain(*args)),
             library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
             shape=f"{label}: E={e} F={f}", kernel="attend_logit_grad",
             path=path)
    cases[label] = r
    log_case(f"attend_logit_grad {label}", r)


def indexed_phase(smi):
    """Phase 15: K1 reading its messages by index, and the motif attend's
    edge kernel, at the SDGNN benchmark cell's shapes: the traffic
    ``epinions_signed`` at seed 0 (131,580 nodes; 589,888 positive and
    121,322 negative edges), width 32, its motif stack (4 graphs, 526,320
    rows, 1,948,740 edges with the self-loops) and its planned edges.
    The sums: the attend forward by destination and its backward by source
    (W=33, the scalar first), the losses' gather backward (W=32 over the
    positive and the negative list's sources).  Then SDGNN (2 layers,
    width 32) trains ``INDEXED_STEPS`` steps on that stack and those
    edges, the launch counters set to 0 just before and read just after:
    18 ``csr_scatter_sum`` a step, 16 of them indexed, and 2
    ``attend_logit_grad``."""
    import torch
    from port_bench.gen import signed_powerlaw
    from pytorch_geometric_signed_directed_tpu_torch.nn import SDGNN
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        prepare_sdgnn_inputs)
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.utils.signed import (
        link_sign_loss)

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "port_bench", "traffic",
                           "epinions_signed.json")) as f:
        g = signed_powerlaw.generate(json.load(f), 0, device=DEV)
    n, f = g["num_nodes"], 32
    es = np.vstack([g["edge_index"], g["edge_sign"]]).T
    t0 = time.perf_counter()
    pos, neg, _, ms, w_pos, w_neg = prepare_sdgnn_inputs(
        n, es, f, init_emb=np.zeros((n, f), np.float32), fused=True,
        device=DEV)
    planned = [link_sign_loss.plan_edges(e, n, DEV) for e in (pos, neg)]
    torch.cuda.synchronize()
    log(f"indexed K1 on the SDGNN cell's shapes on {smi}: motif stack and "
        f"planned edges {time.perf_counter() - t0:.1f} s; stack "
        f"{graph_text(ms.g.plan)}; source CSR {graph_text(ms.src_plan)}")
    gen = torch.Generator(device=DEV).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=DEV, generator=gen)

    gn, e = ms.g.num_nodes, ms.g.src.numel()
    T, dout = randn(gn, f), randn(gn, f)
    ex = torch.rand(e, device=DEV, generator=gen)
    alpha, dpre = torch.rand(e, device=DEV, generator=gen), randn(e)
    perm = ms.src_perm
    cases = {}
    indexed_case("stack by destination", ms.g.plan.rowptr, ms.g.plan.split,
                 T, dict(index=ms.g.src, weight=ex, scalar=ex), cases)
    indexed_case("stack by source", ms.src_plan.rowptr, ms.src_plan.split,
                 dout, dict(index=ms.dst_by_src, weight=alpha[perm],
                            scalar=dpre[perm]), cases)
    # the backward puts its two [E] scalars in the source CSR's slot order
    # before the sum by source
    r = cases["stack by source"]
    r["reorder_ms"] = back_to_back_ms(lambda: (alpha[perm], dpre[perm]))
    log(f"  the [E] scalars' reorder (alpha[src_perm], dpre[src_perm]): "
        f"device_ms={r['reorder_ms']:.4f}")
    for name, pe in zip(("positive", "negative"), planned):
        gp = pe.src
        indexed_case(f"gather backward, {name} sources", gp.plan.rowptr,
                     gp.plan.split, randn(gp.index.numel(), f),
                     dict(index=gp.order), cases)
    attend_case(ms, f, "stack edges", "sdgnn.epinions_signed", cases)
    # SDGNN's steps at the cell's shapes, counted
    model = SDGNN(n, in_dim=f, out_dim=f, fused=True, device=DEV,
                  init_emb=np.random.default_rng(0).standard_normal(
                      (n, f)).astype(np.float32))
    weights = [torch.as_tensor(w, dtype=torch.float32, device=DEV)
               for w in (w_pos, w_neg)]
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(INDEXED_STEPS):
        model.zero_grad(set_to_none=True)
        model.loss(ms, *planned, *weights).backward()
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    per_step = {k: v / INDEXED_STEPS for k, v in launches.items()}
    want = {"csr_scatter_sum": 18, "csr_scatter_sum_indexed": 16,
            "attend_logit_grad": 2}
    if per_step != want:
        raise AssertionError(f"SDGNN at the cell's shapes: {per_step} "
                             f"launches a step, not {want}")
    log(f"  SDGNN, {INDEXED_STEPS} steps on the stack: launches {launches}")
    return cases, dict(launches=launches, per_step=per_step)


def indexed_entries(cases, run):
    """The ``kernels`` entries of phase 15, with the launches of its
    counted SDGNN steps at the cell's shapes."""
    out = []
    for label, r in cases.items():
        name = r.get("kernel", "csr_scatter_sum")
        k1 = name == "csr_scatter_sum"
        key = "csr_scatter_sum_indexed" if k1 else name
        entry = {**kernel_entry(name, r, run["launches"][key],
                                "scatter_csr.cu" if k1 else
                                "attend_grad.cu",
                                "scatter_mxu.py:503" if k1 else None),
                 "path": "sdgnn.epinions_signed, SDGNN steps",
                 "launches_per_step": run["per_step"][key]}
        if k1:
            entry.update(indexed=True, replaced_ms=r["replaced_ms"],
                         replaced_graph_ms=r["replaced_graph_ms"])
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# DiGCL (K1 on its GCN-normalized operator) and the real-data entry points


def digcl_run(name, model, x, P, batch, steps, smi, per_step, profile):
    """``steps`` Adam steps at lr 1e-3 of DiGCL's loss between the views
    (x, 0.9 x) of ``P``, in row batches of ``batch``; the launch counters
    set to 0 just before and read just after, each step counted around it,
    and the run's peak of allocated device memory; then ``profile`` steps
    traced for the device time."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.experiments._common \
        import run_steps
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.train import Trainer

    def loss_fn(m):
        return m.loss(m(x, P), m(0.9 * x, P), batch_size=batch)

    trainer = Trainer(loss_fn, lr=1e-3, device=DEV)
    state = trainer.init(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with launches_by_step([]) as by_step:
        reset_counts()
        run = run_steps(trainer, state, (), steps)
        launches = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    check_counts(name, launches, by_step, per_step, steps)
    check_losses(name, run["losses"])
    ms_step = statistics.median(run["step_ms"][1:])
    n = x.shape[0]
    pairs = 2 * n * n / (ms_step / 1e3)
    log(f"  train B={batch} on {smi}: {steps} steps, median {ms_step:.3f} "
        f"ms/step (first step {run['step_ms'][0]:.3f} ms), {pairs:.4g} "
        f"similarity pairs/s (2 N^2 a step); peak allocated "
        f"{peak / 2 ** 30:.3f} GiB; loss {run['losses'][0]:.6f} -> "
        f"{run['losses'][-1]:.6f}")
    log(f"  launches {launches}: {by_step[0]} in each step as counted "
        f"around it")
    return dict(run, launches=launches, per_step=by_step[0], ms_step=ms_step,
                peak_bytes=peak, pairs_per_s=pairs,
                **device_profile(name, trainer, state, ms_step,
                                 steps=profile))


def bench_digcl(smi, cases):
    """bench.py's DiGCL cell: the bench MagNet graph at N=65,536 and
    average degree 15, its degree features, ``gcn_norm_propagator(mode=
    "auto")`` (the kernel tier), DiGCL(2, relu, 64, 32, tau 0.4, 2 layers)
    trained 10 steps with the batched InfoNCE at B=4096 and at its
    1024-row baseline, from the same weights (first losses equal at
    1e-5).  8 K1 calls a step: the encoder applies the operator at W=128
    and W=64 for each view, and each apply's transpose in the backward."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.graph import (
        gcn_norm_propagator)
    from pytorch_geometric_signed_directed_tpu_torch.nn import DiGCL

    c = BENCH_DIGCL
    n = c["nodes"]
    host = {}
    t0 = time.perf_counter()
    edge_index, w, x, _ = slice_graph(n, c["avg_deg"], 0)
    x = torch.from_numpy(x).to(DEV)
    host["graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = gcn_norm_propagator(edge_index, w, n, mode="auto", device=DEV)
    torch.cuda.synchronize()
    host["operator"] = time.perf_counter() - t0
    csr = csr_of(P)
    per_step = count_applies(both_ways([csr], k=4))
    log(f"bench digcl: N={n} input edges {edge_index.shape[1]}, operator "
        f"nnz {csr.col.numel()} (self-loops added), features "
        f"{tuple(x.shape)}, DiGCL hidden 64, projection 32, tau 0.4, 2 "
        f"layers, Adam lr 1e-3")
    log(f"  layout: {layout_text(single_view(csr))}; transposed: "
        f"{layout_text(single_view(csr.transposed))}")
    log_host(host)
    runs = {}
    for batch in c["batches"]:
        model = DiGCL(2, "relu", 64, 32, tau=0.4, num_layers=2, device=DEV,
                      generator=torch.Generator().manual_seed(0))
        runs[batch] = digcl_run(f"bench digcl B={batch}", model, x, P, batch,
                                c["steps"], smi, per_step, c["profile"])
        del model
        torch.cuda.empty_cache()
    first = [runs[b]["losses"][0] for b in c["batches"]]
    if not np.allclose(first[0], first[1:], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"bench digcl: first losses of the batchings "
                             f"differ: {first}")
    big, base = (runs[b]["ms_step"] for b in c["batches"])
    log(f"  B={c['batches'][0]} over the B={c['batches'][1]} baseline: "
        f"{base / big:.3f}x (the bench's vs_baseline)")
    single_cases(P, (128, 64), "bench digcl P", cases, "bench digcl")
    return {f"bench digcl B={b}": dict(r, host=host)
            for b, r in runs.items()}


def real_data_runs(smi):
    """The real-data entry points through ``main(argv)``, on files written
    in each dataset's schema at its published size (cora_ml, telegram,
    bitcoin_alpha) into a temporary directory that ``PGSD_TPU_DATA`` names,
    20 epochs and one split or run each; each step's launches counted
    around it."""
    import importlib
    import os
    import tempfile

    from pytorch_geometric_signed_directed_tpu_torch.data import (
        schema_files)
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        EXPERIMENTS)

    runs = {}
    saved = {k: os.environ.get(k) for k in ("PGSD_TPU_DATA",
                                            "PGSD_TPU_NO_CACHE")}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        schema_files.write_citation(d, "cora_ml")
        schema_files.write_telegram(d)
        schema_files.write_signed_csv(d)
        log(f"real data: schema files in {time.perf_counter() - t0:.2f} s: "
            f"cora_ml {schema_files.CORA_ML}, telegram "
            f"{schema_files.TELEGRAM}, bitcoin_alpha "
            f"{schema_files.BITCOIN_ALPHA}")
        os.environ["PGSD_TPU_DATA"] = d
        os.environ["PGSD_TPU_NO_CACHE"] = "1"
        try:
            for name, extra in REAL_RUNS:
                module = EXPERIMENTS.get(name, (name,))[0]
                mod = importlib.import_module(
                    "pytorch_geometric_signed_directed_tpu_torch."
                    "experiments." + module)
                argv = extra + ["--epochs", str(REAL_EPOCHS), "--device", DEV]
                label = " ".join([name] + extra)
                runs[label] = real_data_run(label, mod, argv, smi)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return runs


def real_data_run(label, mod, argv, smi):
    """One entry point: its cuts, host seconds, ms/step, losses, metrics
    and launches; the dense tier launches nothing, SNEA's attention K1
    ``csr_scatter_sum`` the same count every step."""
    parser = mod.parser()
    args = parser.parse_args(argv)
    res, wall, launches, by_step = run_main(mod, argv)
    launches = {k: v for k, v in launches.items() if v}
    runs = res["runs"]
    steps = sum(r["steps"] for r in runs)
    losses = [v for r in runs for v in r["losses"]]
    check_losses(label, [losses[0], min(losses)])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss")
    if len(by_step) != steps or any(s != by_step[0] for s in by_step):
        raise AssertionError(f"{label}: launches by step differ: "
                             f"{sorted(map(str, by_step))[:3]}")
    snea = getattr(args, "model", None) == "snea"
    if snea != bool(launches):
        raise AssertionError(f"{label}: launches {launches}: expected "
                             f"{'K1 on the attention graphs' if snea else 'none (the dense tier)'}")
    cuts = [f"{args.epochs} epochs in place of "
            f"{parser.get_default('epochs')}"]
    for flag in ("splits", "runs"):
        if hasattr(args, flag):
            cuts.append(f"{len(runs)} {flag[:-1]} in place of "
                        f"{parser.get_default(flag) or 'all'}")
    if not any(hasattr(args, f) for f in ("splits", "runs")):
        cuts.append(f"{len(runs)} split(s), the dataset's own")
    ms = statistics.median([t for r in runs for t in r["step_ms"][1:]])
    inputs = res["inputs"]
    log(f"{label}: N={getattr(inputs, 'n', None) or inputs.data.num_nodes} "
        f"input edges {inputs.num_edges}; main() {wall:.2f} s")
    log(f"  reduced: {'; '.join(cuts)}")
    log_host(res["host_seconds"])
    extra = ""
    if hasattr(inputs, "views"):
        extra = f"; dense views {len(inputs.views) + 1} (view 1 and one a " \
                f"distinct alpha)"
    elif runs and "split" in runs[0] and hasattr(runs[0]["split"], "cache"):
        extra = f"; dense views {len(runs[0]['split'].cache) + 1} (view 1 " \
                f"and one a distinct alpha)"
    log(f"  train on {smi}: {steps} steps, median {ms:.3f} ms/step; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; accs "
        f"{[round(float(a), 4) for a in res['accs']]}{extra}")
    log(f"  launches {launches or 0}: {by_step[0] or 0} in each step")
    return dict(ms_step=ms, launches=launches, per_step=by_step[0],
                host=res["host_seconds"], wall=wall)


def digcl_phase(smi):
    """Phase 11: the bench DiGCL cell (B=4096 and 1024) with K1 held on its
    operator at W=128 and 64, then the real-data entry points."""
    import torch

    cases, runs = {}, {}
    for name, path in (("bench digcl", lambda: bench_digcl(smi, cases)),
                       ("real data", lambda: real_data_runs(smi))):
        t0 = time.perf_counter()
        runs.update(path())
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return runs, cases


# ---------------------------------------------------------------------------
# captured training: scan_node_training's epoch as a CUDA graph


def random_masks(n, splits, seed):
    """[3, splits, n] float32 train / validation / test masks: each split
    a random 60 / 20 / 20 partition of the nodes."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((3, splits, n), np.float32)
    for s in range(splits):
        parts = np.split(rng.permutation(n), [int(0.6 * n), int(0.8 * n)])
        for k, part in enumerate(parts):
            masks[k, s, part] = 1.0
    return masks


def trainable_q_cell(form):
    """The phase-12 cell of trainable-q MagNet on the magnet_mxu graph's
    template, ``form`` "flat" or "sharded" (on ``local_mesh()``): as
    ``captured_cell`` returns it."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        local_mesh, shard_magnet_laplacian)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnetic_template)

    ei, w, x_np, y_np = slice_graph(N, 30, seed=0)
    tmpl = magnetic_template(ei, w, num_nodes=N, mode="auto", device=DEV)
    if tmpl.mode != "mxu" or tmpl.blocks:
        raise AssertionError("mode='auto' did not pick a flat mxu template")
    text = f"template {layout_text(tmpl)}"
    if form == "sharded":
        tmpl = shard_magnet_laplacian(tmpl, local_mesh(DEV))
        if tmpl.mode != "mxu_sharded" or tmpl.sharded.n_devices != 1:
            raise AssertionError("local_mesh() did not shard onto one card")
        text = f"one-card sharded {text}"
    x = torch.from_numpy(x_np).to(DEV)
    y = torch.from_numpy(y_np).to(DEV)
    step, ev = TRAINABLE_Q_STEP[form], TRAINABLE_Q_EVAL[form]
    per_epoch = {k: step.get(k, 0) + ev.get(k, 0) for k in {*step, *ev}}

    def apply_fn(model, training, generator):
        return model(x, x, tmpl, training, generator)

    def init(s):
        return make_model(DEV, seed=s, trainable_q=True)

    return apply_fn, init, y, N, ei.shape[1], per_epoch, text


def captured_cell(name):
    """The apply function, ``init(split)``, labels, node and input edge
    counts, the K1/K2/K3/K5 calls an epoch (a training step and an
    evaluation forward, from the layouts) and the layout's text of one
    phase-12 cell."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.experiments import (
        magnet_node)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    if name.startswith("trainable_q_"):
        return trainable_q_cell(name[len("trainable_q_"):])
    if name == "magnet_node":
        args = magnet_node.parser().parse_args(
            ["--dataset", "synthetic", "--num_nodes", str(EXPERIMENT_N),
             "--dropout", "0", "--device", DEV])
        inputs = magnet_node.build_inputs(args, DEV)
        log_host(inputs.seconds)
        x, y, lap, n = inputs.x, inputs.y, inputs.lap, inputs.data.num_nodes
        edges, K = inputs.num_edges, args.K

        def init(s):
            return magnet_node.make_model(args, inputs, s)
    else:
        n, deg = (N, 30) if name == "magnet_mxu" else (BSR_GRAPH["nodes"],
                                                       BSR_GRAPH["avg_deg"])
        ei, w, x_np, y_np = slice_graph(n, deg, seed=0)
        lap = magnet_propagators(ei, w, q=0.25, num_nodes=n,
                                 mode="auto" if name == "magnet_mxu"
                                 else "bsr", device=DEV)
        x = torch.from_numpy(x_np).to(DEV)
        y = torch.from_numpy(y_np).to(DEV)
        edges, K = ei.shape[1], 2

        def init(s):
            return make_model(DEV, seed=s)
    if name == "bsr":
        if lap.re.mode != "bsr":
            raise AssertionError("mode='bsr' did not build bsr operators")
        # 4 applies at width 2 and 4 at 32 forward, 4 transposed at 32
        # backward; 8 in the evaluation forward
        per_epoch, text = {"bsr_spmm": 12 + 8}, \
            f"bsr, {lap.re.bsr.blocks.shape[0]} blocks an operator"
    else:
        D = lap.dual
        if D is None or D.mode != "mxu":
            raise AssertionError(f"{name}: not on the kernel tier")
        per_epoch, text = experiment_launches(D, K, 2, 1, 1), layout_text(D)

    def apply_fn(model, training, generator):
        return model(x, x, lap, training, generator)

    return apply_fn, init, y, n, edges, per_epoch, text


def captured_path(name, splits, epochs, smi):
    """One phase-12 cell: ``splits`` splits of ``epochs`` epochs, first as
    an eager loop (its first epoch with every host sync an error), then
    captured
    (``SplitRun``: one eager epoch, the capture, ``epochs - 1`` replays)
    from the same init, masks and optimizer (both time the epochs after
    the first, by CUDA events); requires the same losses
    and selections bit for bit and the eager epoch's launches in each
    replay; traces ``PROFILE_STEPS`` replays of split 0 for the device
    time an epoch and the idle share."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.train import (
        SplitRun, adam)

    t0 = time.perf_counter()
    apply_fn, init, y, n, edges, per_epoch, text = captured_cell(name)
    log(f"captured {name}: N={n} input edges {edges}; {text}; built in "
        f"{time.perf_counter() - t0:.2f} s")
    masks = torch.from_numpy(random_masks(n, splits, seed=12)).to(DEV)
    tx = adam(CAPTURED_LR, CAPTURED_WD)

    def split_run(s):
        return SplitRun(apply_fn, init(s), tx, y, masks[0, s], masks[1, s],
                        masks[2, s], epochs)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    eager, eager_ms = [], []
    for s in range(splits):
        run = split_run(s)
        a, b = events()
        torch.cuda.synchronize()
        before = launch_counts()
        # the first epoch, untimed as the captured run's eager one, with
        # every host sync an error
        torch.cuda.set_sync_debug_mode("error")
        try:
            run.epoch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        a.record()
        for _ in range(epochs - 1):
            run.epoch()
        b.record()
        b.synchronize()
        eager_ms.append(a.elapsed_time(b) / (epochs - 1))
        got = {k: v - before[k] for k, v in launch_counts().items()
               if v != before[k]}
        want = {k: v * epochs for k, v in per_epoch.items()}
        if got != want:
            raise AssertionError(f"captured {name}: the eager loop launched "
                                 f"{got}, the layouts imply {want}")
        eager.append((run.losses.clone(), run.results()))
        del run

    torch.cuda.synchronize()
    reset_counts()
    cap_ms, capture_s, prof = [], [], None
    for s in range(splits):
        run = split_run(s)
        run.capture()
        capture_s.append(run.capture_seconds)
        for got, label in ((run.launches, "its eager epoch"),
                           (run.launches_per_replay, "the capture")):
            if got != per_epoch:
                raise AssertionError(
                    f"captured {name} split {s}: {label} launched {got}, "
                    f"the layouts imply {per_epoch} an epoch")
        replays = epochs - 1
        if s == 0:
            prof = giant_digrac_script().traced_device_ms(
                run.graph.replay, PROFILE_STEPS)
            replays -= PROFILE_STEPS
        a, b = events()
        a.record()
        for _ in range(replays):
            run.graph.replay()
        b.record()
        b.synchronize()
        cap_ms.append(a.elapsed_time(b) / replays)
        losses, res = eager[s]
        diff = float((run.losses - losses).abs().max())
        if not (torch.equal(run.losses, losses)
                and torch.equal(run.results(), res)):
            raise AssertionError(
                f"captured {name} split {s}: the captured run differs from "
                f"the eager loop (largest loss difference {diff}; results "
                f"{run.results().tolist()} against {res.tolist()})")
        r = res.tolist()
        log(f"  split {s}: loss {float(losses[0]):.6f} -> "
            f"{float(losses[-1]):.6f}, best val {r[0]:.4f}, best test "
            f"{r[1]:.4f}, final test {r[2]:.4f}; captured = eager bit for "
            f"bit over {epochs} losses (largest difference {diff})")
        check_losses(f"captured {name} split {s}", losses.tolist())
        del run
    launches = {k: v for k, v in launch_counts().items() if v}
    want = {k: 2 * v * splits for k, v in per_epoch.items()}
    if launches != want:
        raise AssertionError(f"captured {name}: {launches} wrapper calls, "
                             f"expected one eager epoch and one capture a "
                             f"split: {want}")
    device_ms, kernels, top = prof
    e_ms, c_ms = statistics.median(eager_ms), statistics.median(cap_ms)
    log(f"  on {smi}: eager {e_ms:.4f} ms/epoch, captured {c_ms:.4f} "
        f"ms/epoch ({e_ms / c_ms:.2f}x; medians of {splits} splits: eager "
        f"{[round(v, 4) for v in eager_ms]}, captured "
        f"{[round(v, 4) for v in cap_ms]}); capture "
        f"{[round(v, 3) for v in capture_s]} s; launches {per_epoch} an "
        f"epoch, eager and in each replay; {launches} wrapper calls in the "
        f"captured run")
    log(f"  device {device_ms:.4f} ms an epoch over {PROFILE_STEPS} traced "
        f"replays, {kernels:.1f} kernels; idle share captured "
        f"{1 - device_ms / c_ms:.3f}, eager {1 - device_ms / e_ms:.3f}; "
        f"most: " + "; ".join(f"{t:.4f} {k[:50]}" for t, k in top))
    return dict(launches=launches, launches_per_replay=per_epoch,
                replays=splits * (epochs - 1), eager_ms=e_ms, captured_ms=c_ms,
                capture_s=capture_s, device_ms=device_ms,
                idle=1 - device_ms / c_ms, eager_idle=1 - device_ms / e_ms)


def captured_phase(smi):
    """Phase 12: scan_node_training's captured epoch on magnet_mxu (K1),
    bsr (K5), magnet_node's streamed operator (K2) and trainable-q MagNet,
    flat (K1's pair forward and dx) and sharded (K1 a shard forward, K3 a
    shard backward)."""
    import torch

    runs = {}
    for name, splits, epochs in CAPTURED:
        t0 = time.perf_counter()
        runs[name] = captured_path(name, splits, epochs, smi)
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# Phase 13: the sharded paths on one card


def four_shards():
    import torch
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    return parallel.Mesh((torch.device(DEV, 0),) * SHARDS)


def meshes():
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    return (("1 shard", parallel.local_mesh(device=DEV)),
            (f"{SHARDS} shards", four_shards()))


def check_first_loss(name, got, flat):
    if abs(got - flat) > SHARDED_TOL * max(1.0, abs(flat)):
        raise AssertionError(f"{name}: first loss {got} against the flat "
                             f"{flat}")
    log(f"  first loss {got:.8f}, flat {flat:.8f} (|diff| "
        f"{abs(got - flat):.3g})")


def shard_text(sg):
    sizes = [sh.src.numel() for sh in sg.shards]
    return (f"{len(sizes)} shards of {sg.rows_per_device} rows, edges "
            f"{sizes}, cut rows "
            f"{[sh.plan.split.rows.numel() for sh in sg.shards]}")


def sharded_attention_runs(name, graphs, make, loss_of, per_shard_step,
                           smi, edges):
    """``make()``'s model trained on ``graphs`` sharded on each mesh of
    ``meshes()``: ``per_shard_step`` K1 calls a shard and step, first
    losses equal to the flat model's."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch import parallel

    with torch.no_grad():
        flat = float(loss_of(make(), graphs, 0))
    runs, sharded = {}, {}
    for label, mesh in meshes():
        t0 = time.perf_counter()
        sg = parallel.shard_attention_graphs(graphs, mesh)
        torch.cuda.synchronize()
        host = {"shards": time.perf_counter() - t0}
        log(f"{name} on {label}: largest graph {shard_text(sg[0])}; "
            f"sharded in {host['shards']:.2f} s")
        step = iter(range(10 ** 9))

        def loss_fn(mo, sg=sg, step=step):
            return loss_of(mo, sg, next(step))

        run = train_path(f"{name} {label}", loss_fn, make(), SHARDED_STEPS,
                         {"csr_scatter_sum": per_shard_step * mesh.size},
                         smi, edges, SHARDED_PROFILE_STEPS)
        check_first_loss(f"{name} {label}", run["losses"][0], flat)
        runs[f"{name} {label}"] = dict(run, host=host)
        sharded[label] = sg
        torch.cuda.empty_cache()
    return runs, sharded


def sharded_snea(smi, cases):
    """bench.py's SNEA cell on sharded attention graphs: 2 attends in each
    layer (layer 2's pair on g_cat is not fused on a sharded graph), each
    one K1 a shard at W = 1 + 16."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import SNEA
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        snea_graphs)
    from pytorch_geometric_signed_directed_tpu_torch.ops.scatter import (
        build_scatter_plan)

    c = BENCH_SNEA
    n, dim = c["nodes"], c["dim"]
    rng = np.random.default_rng(0)
    pos = np.vstack([rng.integers(0, n, c["e_pos"]),
                     rng.integers(0, n, c["e_pos"])])
    neg = np.vstack([rng.integers(0, n, c["e_neg"]),
                     rng.integers(0, n, c["e_neg"])])
    init_emb = rng.standard_normal((n, dim)).astype(np.float32)
    samples, _ = sgcn_samples(pos, neg, n, SHARDED_SETS,
                              np.random.default_rng(1))
    graphs = snea_graphs(pos, neg, n, device=DEV)
    pos_t, neg_t = (torch.from_numpy(a).to(DEV) for a in (pos, neg))

    def make():
        return SNEA(n, in_dim=dim, out_dim=dim, init_emb=init_emb,
                    device=DEV, generator=torch.Generator().manual_seed(0))

    def loss_of(mo, gs, i):
        none, pt, nt = samples[i % len(samples)]
        return mo.loss(gs, pos_t, neg_t, none, pt, nt)

    runs, sharded = sharded_attention_runs(
        "sharded bench snea", graphs, make, loss_of, 4, smi,
        c["e_pos"] + c["e_neg"])
    path = f"sharded bench snea {SHARDS} shards"
    sg = sharded[f"{SHARDS} shards"]
    half = dim // 2
    attention_case(sg[0].shards[0].plan, 1 + half,
                   "sharded bench snea g_pos shard 0", path, cases)
    attention_case(sg[2].shards[0].plan, 2 + 2 * half,
                   "sharded bench snea g_cat shard 0", path, cases)
    empty = build_scatter_plan(np.zeros(0, np.int64), sg[0].rows_per_device,
                               device=DEV)
    attention_case(empty, 1 + half, "edgeless shard", path, cases)
    if cases[("edgeless shard", 1 + half)]["max_abs_err"] != 0.0:
        raise AssertionError("csr_scatter_sum on an edgeless shard")
    return runs


def sharded_sdgnn(smi, cases):
    """bench.py's SDGNN cell, one GAT a motif graph (4 graphs, 2 layers),
    on sharded motif graphs: one K1 a shard and GAT at W = 1 + 20."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.nn import SDGNN
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed import (
        prepare_sdgnn_inputs, split_signed_edges)
    from pytorch_geometric_signed_directed_tpu_torch.spectral.features \
        import create_spectral_features

    c = BENCH_MOTIF
    n, dim = c["nodes"], c["dim"]
    rng = np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    edges = np.column_stack([
        rng.integers(0, n, m), rng.integers(0, n, m),
        np.concatenate([np.ones(c["e_pos"]), -np.ones(c["e_neg"])])
    ]).astype(np.int64)
    emb = create_spectral_features(*split_signed_edges(edges), n, dim)
    inputs = prepare_sdgnn_inputs(n, edges, in_dim=dim, init_emb=emb,
                                  device=DEV)
    pos, neg = (torch.from_numpy(a).to(DEV) for a in inputs[:2])
    extra = [torch.from_numpy(a).to(DEV) for a in inputs[4:]]

    def make():
        return SDGNN(n, in_dim=dim, out_dim=dim, init_emb=emb, device=DEV,
                     generator=torch.Generator().manual_seed(0))

    def loss_of(mo, gs, i):
        return mo.loss(gs, pos, neg, *extra)

    runs, sharded = sharded_attention_runs(
        "sharded bench sdgnn", inputs[3], make, loss_of, 8, smi, m)
    attention_case(sharded[f"{SHARDS} shards"][0].shards[0].plan, dim + 1,
                   "sharded sdgnn motif 0 shard 0",
                   f"sharded bench sdgnn {SHARDS} shards", cases)
    return runs


def shard_layout_text(L):
    if L.blocks:
        return f"split, {len(L.blocks)} blocks, nnz={L.col.numel()}"
    return f"flat, nnz={L.col.numel()}, cut rows {L.row_split.rows.numel()}"


def shard_applies(S, k):
    """(layout, k) for each shard of S and of its transposed partition:
    k applies each way."""
    return [(sh.layout, k) for T in (S, S.transposed) for sh in T.shards]


def sharded_sgcn(smi, cases):
    """bench.py's SGCN cell with its pair and its fused dual sharded on the
    mxu tier four ways: per step 3 applies of each operator and 3 of its
    transpose, one K1 (or a K2 a block) a shard each."""
    import torch
    from types import SimpleNamespace

    from pytorch_geometric_signed_directed_tpu_torch import parallel
    from pytorch_geometric_signed_directed_tpu_torch.nn import SGCN
    from pytorch_geometric_signed_directed_tpu_torch.nn.signed.sgcn import (
        prepare_sgcn_inputs, split_signed_edges)

    c = BENCH_SGCN
    n, dim = c["nodes"], c["dim"]
    rng = np.random.default_rng(0)
    m = c["e_pos"] + c["e_neg"]
    edge_s = np.column_stack([
        rng.integers(0, n, m), rng.integers(0, n, m),
        np.concatenate([np.ones(c["e_pos"]), -np.ones(c["e_neg"])])
    ]).astype(np.int64)
    init_emb = rng.standard_normal((n, dim)).astype(np.float32)
    pos, neg = split_signed_edges(edge_s)
    samples, _ = sgcn_samples(pos, neg, n, SHARDED_SGCN_STEPS,
                              np.random.default_rng(1))
    pos_t, neg_t = (torch.from_numpy(a).to(DEV) for a in (pos, neg))
    mesh = four_shards()
    runs = {}
    for form in ("pair", "fused"):
        _, _, emb, P_pos, P_neg = prepare_sgcn_inputs(
            n, edge_s, in_dim=dim, init_emb=init_emb, fused=form == "fused",
            mode="mxu", device=DEV)

        def make():
            return SGCN(n, in_dim=dim, out_dim=dim, init_emb=emb,
                        init_emb_grad=True, device=DEV,
                        generator=torch.Generator().manual_seed(0))

        def loss_of(mo, a, b, i):
            none, pt, nt = samples[i % len(samples)]
            return mo.loss(a, b, pos_t, neg_t, none, pt, nt)

        with torch.no_grad():
            flat = float(loss_of(make(), P_pos, P_neg, 0))
        t0 = time.perf_counter()
        if form == "fused":
            S_pos, S_neg = parallel.shard_dual(P_pos, mesh), None
            per_step = count_applies(shard_applies(S_pos.sharded, 3))
        else:
            S_pos, S_neg = (parallel.shard_propagator(P, mesh)
                            for P in (P_pos, P_neg))
            per_step = count_applies(shard_applies(S_pos.sharded, 3)
                                     + shard_applies(S_neg.sharded, 3))
        torch.cuda.synchronize()
        name = f"sharded bench sgcn {form} {SHARDS} shards"
        log(f"{name}: sharded in {time.perf_counter() - t0:.2f} s; shard "
            f"layouts {[shard_layout_text(sh.layout) for sh in S_pos.sharded.shards]}")
        step = iter(range(10 ** 9))

        def loss_fn(mo, a=S_pos, b=S_neg, step=step):
            return loss_of(mo, a, b, next(step))

        run = train_path(name, loss_fn, make(), SHARDED_SGCN_STEPS,
                         per_step, smi, m, SHARDED_PROFILE_STEPS)
        check_first_loss(name, run["losses"][0], flat)
        runs[name] = run
        if form == "fused":
            sh = S_pos.sharded.shards[0]
            if not sh.layout.blocks:
                L = sh.layout
                view = SimpleNamespace(
                    rowptr=L.rowptr, col=L.col, val_a=sh.val, val_b=sh.val_b,
                    num_nodes=S_pos.sharded.rows_per_device, num_cols=n,
                    row_split=L.row_split)
                for width in (2 * dim, dim):
                    r = dual_kernel_case(view, width, torch.float32,
                                         seed=width)
                    r["shape"] = f"sharded sgcn dual shard 0: {r['shape']}"
                    r["path"] = name
                    cases[("sharded sgcn dual shard 0", width)] = r
                    log_case(f"csr_dual_spmm sharded sgcn dual shard 0 "
                             f"2F={width} float32", r)
        del P_pos, P_neg, S_pos, S_neg
        torch.cuda.empty_cache()
    return runs


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_bsr(smi, cases):
    """The bsr cell's MagNet on its bsr operators sharded 1 and 4 ways
    (whole block rows a shard, K5 a shard and apply: 12 a shard and step);
    the dense and segment tiers on a (2, 2) data x graph mesh; one step
    through an NCCL process group of world size 1 against the controller's
    mesh, bit for bit."""
    import torch
    import torch.nn.functional as F
    from pytorch_geometric_signed_directed_tpu_torch import parallel
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)
    from pytorch_geometric_signed_directed_tpu_torch.parallel import (
        distributed)
    from pytorch_geometric_signed_directed_tpu_torch.spectral import (
        magnet_propagators)

    cfg = BSR_GRAPH
    n = cfg["nodes"]
    ei, w, x_np, y_np = slice_graph(n, cfg["avg_deg"], seed=cfg["seed"])
    e = ei.shape[1]
    x = torch.from_numpy(x_np).to(DEV)
    y = torch.from_numpy(y_np).to(DEV)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="bsr",
                             device=DEV)

    def loss_fn(mo, L):
        return F.nll_loss(mo(x, x, L), y)

    with torch.no_grad():
        flat = float(loss_fn(make_model(DEV, seed=0), lap))
    runs, four = {}, None
    for label, mesh in meshes():
        t0 = time.perf_counter()
        lap_s = parallel.shard_magnet_laplacian(lap, mesh)
        torch.cuda.synchronize()
        B = lap_s.re.sharded
        name = f"sharded bsr {label}"
        log(f"{name}: {len(B.shards)} shards of {B.rows_per_device} rows, "
            f"blocks {[b.blocks.shape[0] for b in B.shards]}, pieces "
            f"{[b.split.pieces.shape[0] for b in B.shards]}; sharded in "
            f"{time.perf_counter() - t0:.2f} s")
        run = train_path(name, lambda mo, L=lap_s: loss_fn(mo, L),
                         make_model(DEV, seed=0), SHARDED_STEPS,
                         {"bsr_spmm": 12 * mesh.size}, smi, e,
                         SHARDED_PROFILE_STEPS)
        check_first_loss(name, run["losses"][0], flat)
        runs[name] = run
        four = lap_s
    b = four.re.sharded.shards[0]
    r = bsr_kernel_case(b, 32, seed=32)
    r["shape"] = f"sharded bsr shard 0: {r['shape']}"
    r["path"] = f"sharded bsr {SHARDS} shards"
    cases[("sharded bsr shard 0", 32)] = r
    log_case("bsr_spmm sharded bsr shard 0 W=32", r)

    # one step through NCCL (world size 1) against the controller's mesh
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        pmesh = parallel.init_process_mesh(SHARDS, device=DEV)
        if pmesh.process.backend != ("nccl" if DEV == "cuda" else "gloo"):
            raise AssertionError(f"process mesh on {pmesh.process.backend}")
        steps = {}
        for label, mesh in (("controller", four_shards()),
                            ("NCCL process group", pmesh)):
            lap_s = parallel.shard_magnet_laplacian(lap, mesh)
            model = make_model(DEV, seed=0)
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            loss = loss_fn(model, lap_s)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = launch_counts()
            check_launches(launches, {"bsr_spmm": 12 * SHARDS}, 1, label)
            steps[label] = (loss.detach(), [p.detach().clone()
                                            for p in model.parameters()])
            log(f"  one step on the {label} mesh: loss "
                f"{float(loss.detach()):.8f}, {ms:.3f} ms (first call)")
        (la, pa), (lb, pb) = steps.values()
        if not torch.equal(la, lb) or not all(
                torch.equal(u, v) for u, v in zip(pa, pb)):
            raise AssertionError("the NCCL process mesh's step differs from "
                                 "the controller's")
        log("  NCCL process group (world size 1): loss and parameters equal "
            "the controller mesh's bit for bit")
    finally:
        distributed.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del lap, four
    torch.cuda.empty_cache()

    # the dense and segment tiers on a (2, 2) data x graph mesh
    mesh22 = parallel.Mesh((torch.device(DEV, 0),) * 4, shape=(2, 2),
                           axis_names=("data", "graph"))
    for tier in ("dense", "segment"):
        L = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode=tier,
                               device=DEV)
        for i in range(mesh22.axis_size("data")):
            sub = mesh22.submesh(data=i)
            want = train(make_model(DEV, seed=i), x, y, L, DATA_GRAPH_STEPS)
            got = train(make_model(DEV, seed=i), x, y,
                        parallel.shard_magnet_laplacian(L, sub),
                        DATA_GRAPH_STEPS)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-4,
                                       atol=1e-5)
            log(f"  {tier} on data row {i} of the (2, 2) mesh ({sub.size} "
                f"graph shards): {DATA_GRAPH_STEPS} losses equal the single "
                f"device's at rtol 1e-4 (first {got[0][0]:.6f}, last "
                f"{got[0][-1]:.6f}); median "
                f"{statistics.median(got[2][1:]):.3f} ms/step against "
                f"{statistics.median(want[2][1:]):.3f}")
        del L
        torch.cuda.empty_cache()
    return runs


def sharded_phase(smi):
    """Phase 13: the sharded paths on one card."""
    import torch

    cases, runs = {}, {}
    for name, path in (("snea", sharded_snea), ("sdgnn", sharded_sdgnn),
                       ("sgcn", sharded_sgcn), ("bsr", sharded_bsr)):
        t0 = time.perf_counter()
        runs.update(path(smi, cases))
        torch.cuda.empty_cache()
        log(f"  sharded {name}: {time.perf_counter() - t0:.1f} s")
    return runs, cases


def sharded_entries(runs, cases):
    """The ``kernels`` entries of phase 13, with the launches of the
    sharded run each case belongs to."""
    out = []
    for key, r in cases.items():
        run = runs[r["path"]]
        name, source, replaces, library = {
            # the faster of the dense matmul and torch.sparse.mm on BSR
            "sharded bsr shard 0": ("bsr_spmm", "bsr_spmm.cu",
                                    "bsr_spmm.py:119", r.get("library")),
            "sharded sgcn dual shard 0": (
                "csr_dual_spmm", "scatter_csr.cu", "scatter_mxu.py:503",
                "2x torch.sparse.mm"),
        }.get(key[0], ("csr_scatter_sum", "scatter_csr.cu",
                       "scatter_mxu.py:503", "torch.segment_reduce"))
        out.append({**kernel_entry(name, r, run["launches"][name], source,
                                   replaces),
                    "path": r["path"], "launches_per_step":
                        run["per_step"][name], "library": library})
    return out


# ---------------------------------------------------------------------------
# Phase 14: DIGRAC at WikiTalk scale (K2 at the imbalance widths)


def giant_digrac_run(script, form, smi, cases):
    """``script.main`` (scripts/giant_digrac_torch.py) at its full size in
    ``form`` "pair" or "fused", the launch counters set to 0 just before
    and read just after; requires a falling loss and, in each step and in
    all, the K2 calls its layouts imply; holds K2 on block 0 of two of its
    operators (``GIANT_DIGRAC_CASES``) against its plain version in f32
    and bf16; and takes the first loss again with f32 messages and
    "highest" precision, from the same initial weights."""
    import torch
    from pytorch_geometric_signed_directed_tpu_torch.ops import spmm
    from pytorch_geometric_signed_directed_tpu_torch.instrument import (
        reset_counts)
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
        launch_counts)

    name = f"giant digrac {form}"
    report = {}
    torch.cuda.synchronize()
    reset_counts()
    try:
        rc = script.main(fused=form == "fused", device=DEV, report=report,
                         **GIANT_DIGRAC)
    finally:
        # main sets both process-wide, as the JAX script does
        spmm.set_message_dtype(None)
        spmm.set_matmul_precision("highest")
    launches = {k: v for k, v in launch_counts().items() if v}
    check_losses(name, report["losses"])
    if rc != 0:
        raise AssertionError(f"{name}: main returned {rc}")
    P_s, P_t, A = report["ops"]
    named = dict((label, script.kernel_view(op))
                 for label, op in script.named_operators(P_s, P_t, A))
    for label, d in named.items():
        for way, dd in (("", d), (" transposed", d.transposed)):
            if not dd.blocks or dd.hot_ids is None:
                raise AssertionError(f"{name} {label}{way}: not column-split "
                                     f"(the K2 path)")
    ops = list(named.values())
    k, hop, hidden, seed = (GIANT_DIGRAC[a] for a in ("k", "hop", "hidden",
                                                      "seed"))
    walks, adj = (ops[:1], ops[1:]) if form == "fused" else (ops[:2],
                                                             ops[2:])
    per_step = count_applies(both_ways(walks, hop) + both_ways(adj))
    steps = len(report["losses"]) + script.PROFILE_STEPS
    if any(s != per_step for s in report["launches"]) or \
            launches != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(
            f"{name}: launched {launches} in {steps} steps (by step "
            f"{report['launches'][:2]}...), the layouts imply {per_step} a "
            f"step")
    with torch.no_grad():
        model = script.make_model(report["x"].shape[1], hidden, k, hop,
                                  seed, DEV)
        first_f32 = float(script.imbalance_loss(model, P_s, P_t, A,
                                                report["x"], k))
    ms_step = statistics.median(report["step_ms"][1:])
    e = report["summary"]["e"]
    log(f"{name} on {smi}: median {ms_step:.3f} ms/step (mean "
        f"{report['summary']['step_seconds'] * 1e3:.3f}, first step "
        f"{report['step_ms'][0]:.3f}), {e / (ms_step / 1e3):.1f} input "
        f"edges/s; device {report['device_ms']:.4f} ms a step, idle "
        f"{report['idle']:.3f}; peak {report['peak_bytes'] / 2 ** 30:.3f} "
        f"GiB; loss {report['losses'][0]:.6f} -> {report['losses'][-1]:.6f}"
        f" (f32 messages at the same init: {first_f32:.8f}); launches "
        f"{per_step} a step, {launches} in {steps} steps; host s " +
        ", ".join(f"{k} {v:.2f}" for k, v in
                  report["host_seconds"].items()))
    for label, width in GIANT_DIGRAC_CASES[form]:
        d = named[label]
        single = form == "pair"
        D = single_view(d) if single else d
        table = D.hot_ids.numel() if D.hot_blocks else D.num_cols
        for dtype in (torch.float32, torch.bfloat16):
            r = accum_kernel_case(
                D, D.blocks[0], table, width, dtype, seed=width,
                what=f"block 0 of the giant digrac {label}", single=single)
            cases[(form, label, width, dtype)] = r
            log_case(f"csr_dual_spmm_accum giant digrac {label} "
                     f"{'W' if single else '2F'}={width} {str(dtype)[6:]}",
                     r)
    return dict(launches=launches, per_step=per_step, ms_step=ms_step,
                first_f32=first_f32, first=report["losses"][0],
                device_ms=report["device_ms"], idle=report["idle"],
                peak_bytes=report["peak_bytes"])


def giant_digrac_phase(smi):
    """Phase 14: the port's giant_digrac, pair then fused: their first
    losses with f32 messages agree at 1e-5."""
    import torch

    script = giant_digrac_script()
    runs, cases = {}, {}
    for form in ("pair", "fused"):
        t0 = time.perf_counter()
        runs[form] = giant_digrac_run(script, form, smi, cases)
        torch.cuda.empty_cache()
        log(f"  giant digrac {form}: {time.perf_counter() - t0:.1f} s")
    a, b = runs["pair"]["first_f32"], runs["fused"]["first_f32"]
    if abs(a - b) > 1e-5:
        raise AssertionError(f"giant digrac: the first losses of the pair "
                             f"and fused forms differ: {a} vs {b}")
    log(f"  first loss with f32 messages: pair {a:.8f}, fused {b:.8f} "
        f"(|diff| {abs(a - b):.3g} <= 1e-5); with bf16 messages "
        f"{runs['pair']['first']:.8f}, {runs['fused']['first']:.8f}")
    return runs, cases


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                 "is False")
    from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind}")
    t_start = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items()) or 'cached'})")
    for name, text in build.BUILD_LOG.items():
        print(f"--- nvcc {name}\n{text}", file=sys.stderr)

    # ---- 2-14. the paths ------------------------------------------------
    phases = {}
    for name, phase in (("magnet_mxu", magnet_mxu_phase),
                        ("giant", giant_phase), ("bsr", bsr_phase),
                        ("trainable_q", lambda smi: trainable_q_phase(
                            smi, phases["magnet_mxu"][2])),
                        ("experiments", experiment_phase),
                        ("directed", directed_phase),
                        ("signed", signed_phase),
                        ("attention", attention_phase),
                        ("indexed", indexed_phase),
                        ("digcl", digcl_phase),
                        ("captured", captured_phase),
                        ("sharded", sharded_phase),
                        ("giant_digrac", giant_digrac_phase)):
        t0 = time.perf_counter()
        phases[name] = phase(smi)
        torch.cuda.empty_cache()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    k1_cases, k1_launches, _ = phases["magnet_mxu"]
    k2, k2_own, k2_launches, epi_cases = phases["giant"]
    k5_cases, k5_launches = phases["bsr"]
    tq_cases, k4, tq_runs = phases["trainable_q"]
    exp_runs, exp_cases = phases["experiments"]
    dir_runs, dir_cases = phases["directed"]
    sig_runs, sig_cases = phases["signed"]
    att_runs, att_cases = phases["attention"]
    idx_cases, idx_run = phases["indexed"]
    dcl_runs, dcl_cases = phases["digcl"]
    cap_runs = phases["captured"]
    shd_runs, shd_cases = phases["sharded"]
    gd_runs, gd_cases = phases["giant_digrac"]
    flat_launches = tq_runs["flat"][0]
    sharded_launches = tq_runs["sharded"][0]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")

    print(smi)
    print(json.dumps({
        "kernels": [
            kernel_entry("csr_dual_spmm",
                         k1_cases[("csr_dual_spmm", 64, torch.float32,
                                   "fwd")],
                         k1_launches["csr_dual_spmm"], "scatter_csr.cu",
                         "scatter_mxu.py:503"),
            kernel_entry("csr_dual_spmm_accum", k2[torch.float32],
                         k2_launches["csr_dual_spmm_accum"],
                         "scatter_csr.cu", "scatter_mxu.py:580"),
            kernel_entry("bsr_spmm", k5_cases[(32, "fwd")],
                         k5_launches["bsr_spmm"], "bsr_spmm.cu",
                         "bsr_spmm.py:119"),
        ] + [
            # MagNetConv's epilogue (no TPU kernel: XLA fuses these steps
            # into the layer's einsums) at the giant benchmark cell's shape
            # with the giant run's launches, and at magnet_mxu's with its
            {**kernel_entry(name, case, launches[name],
                            "complex_epilogue.cu", None), "path": path}
            for path, cases, launches in (
                ("giant", epi_cases, k2_launches),
                ("magnet_mxu", k1_cases, k1_launches))
            for name, case in ((n, cases[n]) for n in (
                "complex_epilogue", "complex_epilogue_backward"))] + [
            # K1 on the flat trainable-q pair forward
            {**kernel_entry("csr_pair_spmm",
                            tq_cases[("csr_pair_spmm", 64, torch.float32)],
                            flat_launches["csr_pair_spmm"],
                            "scatter_csr.cu", "scatter_mxu.py:503"),
             "library": tq_cases[("csr_pair_spmm", 64,
                                  torch.float32)]["library"]},
            {**kernel_entry("csr_dual_sddmm",
                            tq_cases[("csr_dual_sddmm", 64, torch.float32)],
                            sharded_launches["csr_dual_sddmm"],
                            "dual_sddmm.cu", "scatter_mxu.py:741"),
             "library": tq_cases[("csr_dual_sddmm", 64,
                                  torch.float32)]["library"]},
        ] + [
            # K1 on msgnn_link's flat operator, K2 on a streamed block of
            # magnet_node's and msgnn_node's, at each width of the paths
            {**kernel_entry(kname, exp_cases[(path, width)],
                            exp_runs[path]["launches"][kname],
                            "scatter_csr.cu", replaces),
             "path": path, "launches_per_step":
                 exp_runs[path]["per_step"][kname]}
            for path, kname, replaces in (
                ("msgnn_link", "csr_dual_spmm", "scatter_mxu.py:503"),
                ("magnet_node", "csr_dual_spmm_accum", "scatter_mxu.py:580"),
                ("msgnn_node", "csr_dual_spmm_accum", "scatter_mxu.py:580"))
            for width in EXPERIMENT_WIDTHS] + [
            # phase 8: K1 on single operators at odd and even widths and on
            # the fused duals, K2 on a streamed block of DGCN's A_in
            {**kernel_entry(kname, dir_cases[(key, width)],
                            dir_runs[path]["launches"][kname],
                            "scatter_csr.cu", replaces),
             "path": path, "launches_per_step":
                 dir_runs[path]["per_step"][kname]}
            for key, path, kname, replaces, widths in (
                ("digrac", "digrac", "csr_dual_spmm", "scatter_mxu.py:503",
                 (3, 32)),
                ("bench digrac", "pair", "csr_dual_spmm",
                 "scatter_mxu.py:503", (5, 32)),
                ("bench digrac walk dual", "fused", "csr_dual_spmm",
                 "scatter_mxu.py:503", (64,)),
                ("bench digrac A dual", "fused", "csr_dual_spmm",
                 "scatter_mxu.py:503", (10,)),
                ("dgcn A_in", "dgcn", "csr_dual_spmm_accum",
                 "scatter_mxu.py:580", (DGCN_HIDDEN,)))
            for width in widths] + [
            # phase 9: K1 on the bench SSSNET's walk and D_bar and on the
            # SGCN dual, K2 on a streamed block of the sssnet cut operator
            {**kernel_entry(kname, sig_cases[(key, width)],
                            sig_runs[path]["launches"][kname],
                            "scatter_csr.cu", replaces),
             "path": path, "launches_per_step":
                 sig_runs[path]["per_step"][kname]}
            for key, path, kname, replaces in (
                ("sssnet cut", "sssnet", "csr_dual_spmm_accum",
                 "scatter_mxu.py:580"),
                ("bench sssnet P_p", "bench sssnet", "csr_dual_spmm",
                 "scatter_mxu.py:503"),
                ("bench sssnet D_bar", "bench sssnet", "csr_dual_spmm",
                 "scatter_mxu.py:503"),
                ("bench sgcn dual", "bench sgcn fused", "csr_dual_spmm",
                 "scatter_mxu.py:503"))
            for (k2, width) in sig_cases if k2 == key]
        + attention_entries(att_runs, att_cases)
        + indexed_entries(idx_cases, idx_run) + [
            # phase 11: K1 on the bench DiGCL operator at the encoder's
            # widths, with the launches of the B=4096 run
            {**kernel_entry("csr_dual_spmm", dcl_cases[("bench digcl",
                                                        width)],
                            dcl_runs[path]["launches"]["csr_dual_spmm"],
                            "scatter_csr.cu", "scatter_mxu.py:503"),
             "path": path, "launches_per_step":
                 dcl_runs[path]["per_step"]["csr_dual_spmm"]}
            for path in (f"bench digcl B={BENCH_DIGCL['batches'][0]}",)
            for width in (128, 64)] + [
            # phase 12: the same kernels launched from captured epochs, with
            # the earlier phases' cases at the widths of these operators;
            # launches: wrapper calls of the run (an eager epoch and a
            # capture a split), each replayed launches_per_replay times
            {**kernel_entry(kname, case, cap_runs[path]["launches"][kname],
                            source, replaces),
             "path": f"captured {path}",
             "launches_per_replay": cap_runs[path]["launches_per_replay"][
                 kname], "replays": cap_runs[path]["replays"]}
            for path, kname, case, source, replaces in (
                ("magnet_mxu", "csr_dual_spmm",
                 k1_cases[("csr_dual_spmm", 64, torch.float32, "fwd")],
                 "scatter_csr.cu", "scatter_mxu.py:503"),
                ("bsr", "bsr_spmm", k5_cases[(32, "fwd")], "bsr_spmm.cu",
                 "bsr_spmm.py:119"),
                ("magnet_node", "csr_dual_spmm_accum",
                 exp_cases[("magnet_node", 128)], "scatter_csr.cu",
                 "scatter_mxu.py:580"),
                # trainable q: phase 6's cases on the same template (the
                # dx and sharded-forward calls: phase 2's on the Laplacian
                # of the same graph)
                ("trainable_q_flat", "csr_pair_spmm",
                 tq_cases[("csr_pair_spmm", 64, torch.float32)],
                 "scatter_csr.cu", "scatter_mxu.py:503"),
                ("trainable_q_flat", "csr_dual_spmm",
                 k1_cases[("csr_dual_spmm", 64, torch.float32, "fwd")],
                 "scatter_csr.cu", "scatter_mxu.py:503"),
                ("trainable_q_sharded", "csr_dual_spmm",
                 k1_cases[("csr_dual_spmm", 64, torch.float32, "fwd")],
                 "scatter_csr.cu", "scatter_mxu.py:503"),
                ("trainable_q_sharded", "csr_dual_sddmm",
                 tq_cases[("csr_dual_sddmm", 64, torch.float32)],
                 "dual_sddmm.cu", "scatter_mxu.py:741"))]
        # phase 13: K1 csr_scatter_sum, K1 csr_dual_spmm and K5 on shards of
        # the sharded paths, with their runs' launches
        + sharded_entries(shd_runs, shd_cases) + [
            # phase 14: K2 on block 0 of the giant DIGRAC operators, with
            # the launches of their runs (30 steps and 10 traced)
            {**kernel_entry("csr_dual_spmm_accum", r,
                            gd_runs[form]["launches"]["csr_dual_spmm_accum"],
                            "scatter_csr.cu", "scatter_mxu.py:580"),
             "path": f"giant digrac {form}", "launches_per_step":
                 gd_runs[form]["per_step"]["csr_dual_spmm_accum"]}
            for (form, _, _, _), r in gd_cases.items()],
        # K2's own contract and K4: tested, on no path this script drives
        "off_path": [
            # K1 on magnet_node's Laplacian laid out flat: every row cut
            *[{**kernel_entry("csr_dual_spmm",
                              exp_cases[("magnet_node flat", width)], 0,
                              "scatter_csr.cu", "scatter_mxu.py:503"),
               "path": None} for width in EXPERIMENT_WIDTHS],
            kernel_entry("csr_scatter_accum", k2_own,
                         k2_launches["csr_scatter_accum"], "scatter_csr.cu",
                         "scatter_mxu.py:580"),
            {**kernel_entry("csr_dual_sddmm_accum", k4,
                            sharded_launches["csr_dual_sddmm_accum"],
                            "dual_sddmm.cu", "scatter_mxu.py:844"),
             "library": k4["library"]},
        ],
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
