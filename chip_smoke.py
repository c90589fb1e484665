#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`tpusched_torch`) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc (the kernels build from
tpusched_torch/csrc at first use), imports nothing of JAX or of the JAX
package, and
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels and prints the build time;
  3. kernel phase: holds each kernel against its plain PyTorch version
     on the same CUDA tensors of a 10 000 x 5 000 cluster with taints,
     selectors, affinity and cordons (cell b), requiring exact equality
     (bool, int and f32: the kernels are built with --fmad=false and
     keep their plain versions' order of f32 operations), and times
     both with CUDA events (median of several runs): K1 atom_sat,
     K2 tableau_cells, K3 finalize_static; K5 cycle at
     full width and on a 1024-row index view (equal to the same view
     gathered), both also at other tiles than cycle_tile's (each exact,
     timed), K6 row_topk (K = 8 seeded, kb = 8, beside torch.topk;
     then its two paths, the K-pass kernel and the radix select, at
     K = 4, 8, 16 and 256 without the seeded pick, each exact and timed),
     K8 prefix_commit_loop (every commit sub-step of a round in one
     launch) on the first fast round, exactly, timed by CUDA events and
     the profiler (and later on (d)'s first compacted round, fast (h)'s
     first preemption drain step and (t)'s round 1, B = 8);
     Then, on the pairwise cluster (d) (BASELINE config 3 at 10 000 x
     5 000: topology spread and inter-pod affinity), K9 sig_match, K10
     pair_counts, K11 pairwise_batch and K4's pairwise variant against
     their plain versions, exactly (the scan: assignment, chosen, used
     and the final pair state); and, on the arguments of their first
     call in a fast solve of (d), K12 waterfill, K13 (excess_min,
     excess_survive), K14 ia_ok_at_choice, K10's pair_commit, K8's
     node_add (beside one index_add_, and a profiler trace showing one
     kernel and nothing else on the card a call), K7 in fixed point,
     K11 with ia_ok and K5 with the relaxed output;
  4. main-path phases, each with every launch counter zeroed just
     before and read just after, requiring each of its kernels to
     launch:
     - parity: `Engine.solve` at 10 000 pods x 5 000 nodes on (a) the
       headline config-2 cluster, (b) the same size with constraints,
       (c) the headline with the seeded tie-break (K1-K4); on (a) and
       (c), K4 at the policy's cluster size (16 CTAs) and at one CTA,
       each exact against the audit's plain scan, with us a pod;
     - fast: the same three requests with mode="fast" (K5-K8); K7 on
       fast (a)'s round 0 (10 240 rows) and a 1 024-row view of it,
       exact, beside torch.where + sum; (b) once more with the plain
       versions on the host's CPU, which must place as many pods as
       the card;
     - ScoreBatch: `Engine.score`, `score_top1` and `score_topk(k=8)`
       on (b) (K5, K6);
     - pairwise parity: `Engine.solve` on (d), on (d) with the seeded
       tie-break, and on (e) = (d) plus running anti-affinity holders,
       three namespaces (`*` and explicit scopes) and key-less nodes
       (K1-K3, K9, K10, K4's pairwise variant; on (d) and (e) at the
       policy's cluster size and at one CTA, exact against the audit's
       plain scan);
     - pairwise ScoreBatch: `score_top1` and `score_topk(k=8)` on (d),
       `score_top1` on (e) (K1-K3, K9-K11, K5, K6);
     - fast pairwise: `Engine.solve` in fast mode on (d), (d) with the
       seeded tie-break and (e) (K1-K3, K9, K10 and its commit entry
       point, K11, K5, K6, K7 in fixed point, K8 and its node_add,
       K12-K14), then (d) with compact_cap=0 (full-width rounds only),
       which must equal the compacted solve, and (d) once more with the
       plain versions on the host's CPU, which must place as many pods
       as the card;
     after each solve a validity audit (no node over capacity, every
     placed pod's static mask true at its node, no padded pod placed)
     and equality with the same solve through the plain versions on
     the same CUDA tensors; for (d) and (e) also a pairwise audit: the
     plain scan's final pair state equals K10's recount at the final
     assignment bitwise, no placed holder of a required anti term
     shares its domain with another matching member, and no placed pod
     sits in a domain holding a required anti term that matches it; for
     the fast pairwise solves the same audit of the plain solve's final
     pair state and, in numpy, the commit-key audit: every placed pod's
     DoNotSchedule skew and required inter-pod terms hold against K10's
     recount of the pods committed at its key or before, itself left
     out; each ScoreBatch result equal to its plain version;
     - gangs (BASELINE config 4, 2 500 groups of 4): `Engine.solve` in
       parity and fast mode on (f) 5 000 nodes and (g) 1 000 nodes (the
       gang gate's K8 node_add besides each path's kernels), each with
       the audit, equality with its plain solve and a gang audit (no
       group placed in part; the plain solve's rolled-back pods
       unplaced; (g) must roll back a group);
     - preemption (BASELINE config 5 at 10 000 x 5 000, 90 % tight, a
       third of the running pods under PodDisruptionBudgets): parity
       `Engine.solve` with preemption=True on (h) (K1-K3, K4's
       preemption variant, which runs K15's victim search inside the
       scan), the audit, equality with its plain solve (evictions
       included) and a preemption audit (final usage = usage - evicted
       victims + placed pods, in f64; victims only from nodes a
       preempted pod took; no gang member preempts; at least one
       eviction); then K4's preemption variant against that plain scan,
       with and without its explain outputs (evictor, evict_pos), K15
       against its plain version at the scan's state at (h)'s first 8
       preemptors (and the chosen prefix's freed row and victims equal
       to those read off the plain tableau; at least one PDB violation
       among the tableaus), and K4's pairwise preemption variant on (h)
       with spread and inter-pod terms, all exact;
     - fast preemption: `Engine.solve` with mode="fast",
       preemption=True on (h) and on (h) with spread and inter-pod
       terms (the main rounds' kernels, then the auction rounds: K17's
       auction_ok, K16 auction_tables, K17 auction_rank, K6 at K = 256,
       K18 auction_claim, K8's node_add; with signatures also K11, K10,
       K14 and K13 in the rounds' validation), each once and then 5
       steady solves (median) with a stage breakdown, the audit,
       equality with its plain solve (evictions and host reads
       included), the commit-key audit in both eviction arms (every
       eviction applied, none; a pairwise violation counts only in
       both), the preemption audit (with signatures the victims of each
       round on nodes its kept eviction bids claimed, and the victims
       a reverted preemptor stranded counted) and at least one
       eviction; then the auction kernels against their plain versions
       on the arguments of each cell's first auction round, exactly,
       timed with CUDA events and the profiler's kernel time (K18 also
       at cluster sizes 1, 4, 8 and 16, each exact), K6 at
       K = 256 (the radix path) beside torch.topk and the K-pass kernel,
       and on tie rows (all -inf, all equal, -0.0 with +0.0, wide ties at
       the K-th, N not a multiple of 256) at K = 256 and K = N;
     - K5's calls by size class in one more fast solve of (a), (b) and
       (h) (calls, and the CUDA-event ms of every call summed per class);
     - async forms: `solve_async`, `score_async` and
       `score_topk_async(k=8)` once each on (b), each equal to its
       synchronous form;
     - the warm lineage (w) (the JAX bench's bench_warm: config 2 at
       10 000 x 5 000, seed 46, loaded as records into a DeviceSnapshot
       on the card, fast mode): a cold solve, the cold rung of
       `solve_warm` (the tableau's build), nine value-churn cycles at
       each of 0.1 %, 1 % and 10 % of the pods, each a warm solve and a
       cold solve of the same lineage state in turns (each warm result
       equal to the cold one in assignment, chosen_score and evicted,
       the first also to the plain-version solve), ten warm_churn_stream cycles (row reorders, completions,
       cordon toggles), each warm == cold, five incremental cycles at
       1 % (audit tail zero, the validity audit, carried and frontier
       counts, placed beside the cold solve's), one parity warm cycle
       equal to its cold solve; per-cycle walls and their p50, host
       reads, the bytes each apply and solve sent against the full
       upload; then K19 and K20 against their plain versions on the
       first incremental cycle's inputs;
     - the device queue (q) (the ingest bench's bounded table, 16 384
       slots at 90 %, priorities U(10, 100), SLOs U(0.5, 0.999)): twenty
       windows of 1 024 through `DeviceQueue.window` (K21), 10 % of the
       rows churned before each (removals, parks, updates, arrivals),
       each window equal to the numpy oracle `rank_reference` over the
       queue's mirror; the window wall's p50; then K21 against its plain
       version (window and full order) and rank_full against
       rank_reference at full Q, bit for bit, beside torch.sort;
     - decision provenance (x): `Engine.solve_explained(k=3)` on (h) in
       fast and parity mode with preemption and on (d) in fast mode
       (K22's two entry points, K6 at kb = 4, K4's explain outputs in
       parity mode), each equal to the unexplained solve (host reads
       included), every victim's evictor on its node, the auction table's
       evictions summing to the evicted count (fast; all zero in
       parity), the probe's tallies partitioning the valid nodes of every
       real pod; the walls of the explained solve, the probe and the
       unexplained solve; K22's entry points against their plain
       versions on (h) and (d), exactly;
     - the tenant batch (t) (eight config-2 clusters of 3 000 - 50 b
       pods on 1 500 nodes with (b)'s constraints, under one bucket
       floor without signatures): `tenants.solve_many` in parity and
       fast mode and seeded parity, each launching K1-K3 and K4 (or
       K5-K8, K23, K24) once for all tenants per call, its first wall
       and the median of 5 against the eight solo solves on the card,
       host reads against their sum, each tenant equal to its solo
       solve in all six outputs and valid, the batch equal to its
       plain-version twin (parity and fast, host reads too); K4 over
       the tenant axis (eight clusters) against one tenant's K4, each
       tenant's outputs equal to its solo launch at one CTA; K7, K23
       and K24 on their first call's arguments against their plain
       versions, beside torch.where + sum, torch.cumsum with
       searchsorted and with a scatter;
     - the tenant batch with signatures (tp) (eight config-3 clusters of
       3 000 - 50 b pods on 1 500 nodes under one floor with their
       signatures): parity (first and seeded) and fast with the default
       compact_cap, each tenant equal to its solo solve on the card in
       all six outputs and valid, a reduced batch (four tenants of 600 x
       300) equal to its plain-version twin, host reads too; K4's
       pairwise variant with 8 clusters against one tenant's (each
       tenant equal to its solo launch at one CTA); the entry
       points that gained the tenant axis (K9, K10, K4's pairwise
       variant, K11 with ia_ok, K12, K13's two, K14, K10's pair_commit,
       K8's node_add, beside index_add_ and with the one-kernel trace)
       on their first call's arguments against their plain versions,
       with CUDA-event and profiler times;
     - the tenant batch with gangs (tg) (eight config-4 clusters of
       750 - 12 b groups of 4 on 1 500 - 180 b nodes): both modes, the
       same checks, each tenant's gang audit and rolled-back groups (the
       first tenant none, the last some);
     - the tenant batches with preemption (th) (eight config-5
       clusters of 3 000 - 50 b pods on 1 500 nodes under one floor
       without signatures) and (thp) (the same with spread and inter-pod
       terms, under one floor with their signatures): parity (first and
       seeded) and fast, each launching K4's preemption variant (its
       pairwise one in (thp)) once with one CTA a tenant, or K16, K17,
       K6 at K = 256 and K18 once a round for all tenants; each tenant
       equal to its solo solve in all six outputs, valid, and through
       the preemption audit (usage less victims plus placements in f64;
       fast: the commit-key audit in both eviction arms, with signatures
       the victims of each round on nodes its kept bids claimed); a
       reduced batch (four tenants of 600 x 300) equal to its plain
       twin, host reads too; K4's preemption variants with 8 CTAs
       against one tenant's; K16, K17's two entry points, K6 at K = 256
       and K18 over the tenant axis on (th)'s first auction round
       against their plain versions, with CUDA-event and profiler
       times;
     - every fast cell of FAST_COUNTS keeps its recorded placed count,
       and its recorded host reads less the reads of the commit loop
       that K8 runs on the card (one a sub-step and one to end each
       round's loop, counted through a recording K8 in a second solve);
  5. prints per-stage time breakdowns of one steady parity and one
     steady fast solve (with the host-clock cost of the dealing in
     three forms: K23, its plain version, torch.cumsum + searchsorted),
     of one steady pairwise parity solve and one steady fast pairwise
     solve on (d), a JSON line with every
     kernel's numbers, and, last, the device JSON line.

Any failure raises and the exit code is not 0. Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tpusched_torch import _build
from tpusched_torch.config import Buckets, EngineConfig
from tpusched_torch.device_state import DeviceSnapshot
from tpusched_torch.device_state import DeviceQueue
from tpusched_torch.engine import (
    Engine,
    _pack_solve,
    _sat_tables,
    probe_core,
    score_core,
    score_top1_core,
    score_topk_core,
    solve_core,
)
from tpusched_torch.kernels import assign as kassign
from tpusched_torch.kernels import explain as kex
from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.kernels import preempt as kpre
from tpusched_torch.kernels import queue as kq
from tpusched_torch.kernels.atoms import atom_sat, atom_sat_plain
from tpusched_torch.qos import effective_priority, effective_weights, pressure_of
from tpusched_torch.tenants import solve_many, stack_snapshots
from tpusched_torch.synth import (
    config2_scale,
    config3_pairwise,
    config4_gangs,
    config5_preemption,
    make_cluster,
    warm_churn_stream,
)

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit): HBM3
# bandwidth and the f32 rate outside the tensor cores. None of these
# kernels uses the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PODS, NODES, SEED = 10_000, 5_000, 42
CONSTRAINED = dict(taint_frac=0.3, toleration_frac=0.3, selector_frac=0.3,
                   affinity_frac=0.3, cordon_frac=0.05)
# Cell (d) is the JAX bench's pairwise snapshot (seed 43); (e) adds
# running anti-affinity holders, namespace scopes and key-less nodes.
PAIR_SEED = 43
PAIR_EXTRA = dict(run_anti_frac=0.1, namespace_count=3, keyless_node_frac=0.05)
# Cells (f) and (g) are BASELINE config 4, 2 500 gangs of 4 (seed 44) on
# the JAX bench's 5 000 nodes and on the generator's own 1 000; (h) is
# config 5 at 10 000 x 5 000 (seed 45), the JAX bench's preemption
# snapshot, solved with preemption=True. (h) with spread and inter-pod
# terms drives K4's pairwise preemption variant in the kernel phase.
GANG_SEED, PRE_SEED = 44, 45
GANGS = dict(n_groups=2500, gang_size=4)
PRE_PAIR = dict(spread_frac=0.3, interpod_frac=0.3)
K15_STATES = 8   # (h)'s first preemptors, in pop order
# Cell (w) is the JAX bench's warm lineage (bench.py:1292 bench_warm):
# config 2 at 10 000 x 5 000 with one running pod a node and QoS, seed
# 46, loaded as records into a DeviceSnapshot on the card. Value churn
# redraws observed availability of a share of the pods a cycle.
WARM_SEED = 46
WARM_FRACS = (0.001, 0.01, 0.1)
WARM_CYCLES = 9        # warm cycles a churn level
WARM_STREAM = 10       # warm_churn_stream cycles
WARM_INC = 5           # incremental cycles at 1 %
# Cell (q) is the ingest bench's bounded device queue (bench.py:2036,
# qcap 16 384) at 90 % fill, priorities U(10, 100) and SLOs U(0.5,
# 0.999) (bench.py:2041-2042), windows of HostScheduler's default batch
# (host.py:301, 1 024), 10 % of the rows churned between windows.
QUEUE_CAP = 16384
QUEUE_FILL = 0.9
QUEUE_W = 1024
QUEUE_WINDOWS = 20
QUEUE_CHURN = 0.1
# Cell (x): the explained solve and probe at k = 3 (kb = 4) on (h) in
# both modes and on (d) in fast mode.
EXPLAIN_K = 3
# Cell (t): a sidecar serving eight mid-size clusters (tpusched/tenants.py
# :8-11). Tenant b is config2_scale(rng(60 + b), 3000 - 50 b pods, 1500
# nodes) with QoS and cell (b)'s constraint mix, all under one Buckets
# floor without signatures (P = 3 072, N = 1 536), solved by
# tenants.solve_many in both modes and once with the seeded tie-break.
TENANTS = 8
TENANT_SEED = 60
TENANT_PODS, TENANT_STEP, TENANT_NODES = 3000, 50, 1500
# Cell (tp): the same sidecar serving eight config-3 clusters. Tenant b is
# config3_pairwise(rng(70 + b), 3000 - 50 b pods, 1500 nodes), all under
# one Buckets floor with their signatures (P = 3 072, N = 2 048), solved
# in parity mode (first and seeded) and in fast mode with the default
# compact_cap (each tenant hands off to [1 024, N] views at its own
# round). Cell (tg): eight config-4 clusters, tenant b
# config4_gangs(rng(80 + b), n_groups=750 - 12 b, gang_size=4,
# n_nodes=1500 - 180 b): the first six keep every group, like (f), the
# last two roll groups back, like (g) (at 1500 - 125 b nodes no tenant
# rolls back). Both modes. Each phase's plain twin is a reduced batch,
# four tenants of 600 pods on 300 nodes (the plain pairwise scan at
# full size would take minutes).
PAIR_TENANT_SEED, GANG_TENANT_SEED = 70, 80
# Cells (th) and (thp): the same sidecar serving eight config-5 clusters
# (BASELINE config 5's shape at (t)'s size). Tenant b is
# config5_preemption(rng(90 + b), 3000 - 50 b pods, 1500 nodes): nodes
# 90 % full of eight running pods each, a third under budgets (P = 3 072,
# N = 2 048, M = 12 288, GP = 8 under the floor); (thp) adds spread and
# inter-pod terms (seeds 100 + b) under a floor with their signatures.
# Both modes, parity also seeded; the plain twins on four tenants of 600
# x 300 (P = 1 024, N = 512, M = 3 072).
PRE_TENANT_SEED, PRE_PAIR_TENANT_SEED = 90, 100
GANG_GROUPS, GANG_GROUP_STEP, GANG_NODE_STEP = 750, 12, 180
REDUCED_TENANTS, REDUCED_PODS, REDUCED_NODES = 4, 600, 300
# Fast placed counts and host reads recorded when the host loop ran the
# commit sub-steps, before the dealing and the tranche pick became
# kernels (K23, K24: the same bits as the torch code they replaced). A
# solve must keep the placed count, and the reads less those of the
# commit loop that K8 runs on the card (keep_fast_counts).
FAST_COUNTS = {"a": (10000, 26), "b": (9942, 64), "c": (10000, 26),
            "fast d": (9231, 46), "fast d seeded": (9231, 46),
            "h fast": (9995, 514)}

# K5's tiles measured beside cycle_tile's choice (rows, threads a CTA).
CYCLE_TILES = ((4, 128), (8, 128), (32, 128), (16, 64), (16, 256))

# (name, wrapper, its launch counter, source, the JAX function it
# replaces). A variant of a kernel (K5's relaxed output, K7's fixed point,
# K11's ia_ok) has a row of its own, counted by its own counter on the
# wrapper; the wrapper's `launches` counts every launch. K6's two kernels
# have a counter each: `launches` the K-pass kernel's, `radix_launches`
# the radix select's.
KERNELS = (
    ("atom_sat", atom_sat, "launches", "tpusched_torch/csrc/atoms.cu",
     "tpusched/kernels/atoms.py:29"),
    ("tableau_cells", kassign._tableau_cells, "launches",
     "tpusched_torch/csrc/tableau.cu", "tpusched/kernels/assign.py:110"),
    ("finalize_static", kassign.finalize_score, "launches",
     "tpusched_torch/csrc/finalize.cu", "tpusched/kernels/assign.py:233"),
    ("parity_scan", kassign.parity_scan, "launches",
     "tpusched_torch/csrc/scan.cu", "tpusched/kernels/assign.py:426"),
    ("cycle", kassign.cycle, "launches", "tpusched_torch/csrc/cycle.cu",
     "tpusched/kernels/assign.py:265"),
    ("row_topk", kassign.row_topk, "launches", "tpusched_torch/csrc/topk.cu",
     "tpusched/kernels/assign.py:854"),
    ("desirability", kassign.desirability, "launches",
     "tpusched_torch/csrc/deal.cu", "tpusched/kernels/assign.py:793"),
    ("prefix_commit_loop", kassign.prefix_commit_loop, "launches",
     "tpusched_torch/csrc/commit.cu", "tpusched/kernels/assign.py:888"),
    ("sig_match", kpair.sig_match, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:85"),
    ("pair_counts", kpair.pair_counts, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:145"),
    ("pairwise_batch", kpair.pairwise_batch, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:342"),
    ("parity_scan_pair", kassign.parity_scan_pair, "launches",
     "tpusched_torch/csrc/scan.cu", "tpusched/kernels/pairwise.py:504"),
    ("waterfill", kassign.waterfill, "launches",
     "tpusched_torch/csrc/waterfill.cu", "tpusched/kernels/assign.py:563"),
    ("excess_min", kassign.excess_min, "launches",
     "tpusched_torch/csrc/excess.cu", "tpusched/kernels/assign.py:1093"),
    ("excess_survive", kassign.excess_survive, "launches",
     "tpusched_torch/csrc/excess.cu", "tpusched/kernels/assign.py:1147"),
    ("ia_ok_at_choice", kpair.ia_ok_at_choice, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:434"),
    ("pair_commit", kpair.pair_commit, "launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/pairwise.py:174"),
    ("node_add", kassign.node_add, "launches",
     "tpusched_torch/csrc/commit.cu", "tpusched/kernels/assign.py:701"),
    ("desirability_fixed", kassign.desirability, "fixed_launches",
     "tpusched_torch/csrc/deal.cu", "tpusched/kernels/assign.py:799"),
    ("pairwise_batch_ia_ok", kpair.pairwise_batch, "ia_ok_launches",
     "tpusched_torch/csrc/pairwise.cu", "tpusched/kernels/assign.py:297"),
    ("cycle_relaxed", kassign.cycle, "relaxed_launches",
     "tpusched_torch/csrc/cycle.cu", "tpusched/kernels/assign.py:306"),
    ("preempt_step", kpre.preempt_step, "launches",
     "tpusched_torch/csrc/preempt.cu", "tpusched/kernels/preempt.py:317"),
    ("parity_scan_preempt", kassign.parity_scan_preempt, "launches",
     "tpusched_torch/csrc/scan.cu", "tpusched/kernels/assign.py:408"),
    ("parity_scan_pair_preempt", kassign.parity_scan_pair_preempt,
     "launches", "tpusched_torch/csrc/scan.cu",
     "tpusched/kernels/pairwise.py:240"),
    ("auction_tables", kpre.auction_tables, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:488"),
    ("auction_ok", kpre.auction_ok, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:443"),
    ("auction_rank", kpre.auction_rank, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:511"),
    ("row_topk_radix", kassign.row_topk, "radix_launches",
     "tpusched_torch/csrc/topk.cu", "tpusched/kernels/preempt.py:563"),
    ("auction_claim", kpre.auction_claim, "launches",
     "tpusched_torch/csrc/auction.cu", "tpusched/kernels/preempt.py:588"),
    ("capacity_prefix_keep", kassign.capacity_prefix_keep, "launches",
     "tpusched_torch/csrc/incremental.cu",
     "tpusched/kernels/assign.py:2227"),
    ("frontier_closure", kassign.frontier_closure, "launches",
     "tpusched_torch/csrc/incremental.cu",
     "tpusched/kernels/assign.py:2328"),
    ("queue_rank", kq.queue_rank, "launches", "tpusched_torch/csrc/queue.cu",
     "tpusched/kernels/queue.py:106"),
    ("explain_cells", kex.explain_cells, "launches",
     "tpusched_torch/csrc/explain.cu", "tpusched/kernels/explain.py:94"),
    ("explain_terms", kex.explain_terms, "launches",
     "tpusched_torch/csrc/explain.cu", "tpusched/kernels/explain.py:181"),
    ("parity_scan_preempt_explain", kassign.parity_scan_preempt,
     "explain_launches", "tpusched_torch/csrc/scan.cu",
     "tpusched/kernels/assign.py:485"),
    ("deal", kassign.deal, "launches", "tpusched_torch/csrc/dealing.cu",
     "tpusched/kernels/assign.py:815"),
    ("top_by_rank", kassign.top_by_rank, "launches",
     "tpusched_torch/csrc/tranche.cu", "tpusched/kernels/assign.py:996"),
)
# Kernels whose counters the main path leaves at 0, and why; each is
# held against its plain version at full size in the kernel phase.
OFF_PATH = {
    "preempt_step": "K15's standalone entry point, solo; the main path runs "
                    "K15 as a device function inside K4's preemption "
                    "variants",
}
PARITY_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                  "parity_scan")
PAIR_PARITY_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                       "sig_match", "pair_counts", "parity_scan_pair")
PAIR_SCORE_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                      "sig_match", "pair_counts", "pairwise_batch", "cycle",
                      "row_topk", "row_topk_radix")
# Kernels an entry-point call launches at most once (K1 twice with
# signatures: node labels, then member labels).
ONCE = ("tableau_cells", "finalize_static", "parity_scan", "sig_match",
        "pair_counts", "pairwise_batch", "parity_scan_pair",
        "parity_scan_preempt", "parity_scan_pair_preempt")
# K6 takes its radix path for the fast rounds' K = 8 without the seeded
# pick (kassign.RADIX_MIN_K): a seeded request launches the K-pass kernel
# and may leave the radix select idle (SEEDED_IDLE); one without it
# launches the radix select and the K-pass kernel only for its K < 8
# calls (UNSEEDED_IDLE).
FAST_KERNELS = ("atom_sat", "tableau_cells", "finalize_static", "cycle",
                "row_topk", "row_topk_radix", "desirability",
                "prefix_commit_loop", "deal", "top_by_rank")
SEEDED_IDLE = ("row_topk_radix",)
UNSEEDED_IDLE = ("row_topk",)
FAST_PAIR_KERNELS = FAST_KERNELS + (
    "sig_match", "pair_counts", "pairwise_batch", "waterfill", "excess_min",
    "excess_survive", "ia_ok_at_choice", "pair_commit", "node_add",
    "desirability_fixed", "pairwise_batch_ia_ok", "cycle_relaxed")
FAST_PAIR_ONCE = ("tableau_cells", "finalize_static", "sig_match",
                  "pair_counts")
# Kernels a request may leave idle though its path has them: K24 picks a
# tranche (or a compacted view) only while pods are still pending once
# the full-width rounds end (fast (e) never compacts). Each must still
# launch on the main path as a whole, and (t)'s fast batch requires it.
OPTIONAL = ("top_by_rank",)
SCORE_KERNELS = ("atom_sat", "tableau_cells", "finalize_static", "cycle",
                 "row_topk", "row_topk_radix")
# The gang gate reverts through K8's node_add.
GANG_PARITY_KERNELS = PARITY_KERNELS + ("node_add",)
GANG_FAST_KERNELS = FAST_KERNELS + ("node_add",)
PREEMPT_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                   "parity_scan_preempt")
PAIR_PREEMPT_KERNELS = ("atom_sat", "tableau_cells", "finalize_static",
                        "sig_match", "pair_counts",
                        "parity_scan_pair_preempt")
# Fast mode with preemption: the main rounds, then the auction rounds
# (K16-K18, K6 at K = 256, the plain commits' node_add).
AUCTION_KERNELS = ("node_add", "auction_tables", "auction_ok",
                   "auction_rank", "row_topk_radix", "auction_claim")
FAST_PREEMPT_KERNELS = FAST_KERNELS + AUCTION_KERNELS
FAST_PREEMPT_PAIR_KERNELS = FAST_PAIR_KERNELS + AUCTION_KERNELS[1:]
# The warm lineage (w): the fast solves and the tableau's K1-K3 (K1 idle
# without atoms), the incremental solves' K20, K19 and carried commit
# (node_add), and one parity warm cycle (K4).
WARM_KERNELS = FAST_KERNELS + ("node_add", "capacity_prefix_keep",
                               "frontier_closure", "parity_scan")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_clock_ms(fn, reps: int) -> float:
    """Host-clock ms per call of fn() over `reps` back-to-back calls
    (synchronised at both ends), after one warm-up call: what a
    launch-bound loop pays for it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over positions where both are finite (0 for bool
    and int outputs that agree); infinities must sit at the same
    places."""
    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    a64, b64 = a.double(), b.double()
    if not torch.equal(torch.isfinite(a64), torch.isfinite(b64)):
        return float("inf")
    fin = torch.isfinite(a64)
    if not bool(torch.equal(a64[~fin], b64[~fin])):
        return float("inf")
    return float((a64[fin] - b64[fin]).abs().max().item()) if fin.any() else 0.0


def require_equal(name: str, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        err = max(err, max_abs_err(g, w))
        if not torch.equal(g, w):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max abs err {max_abs_err(g, w)})")
    return err


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_result(cfg: EngineConfig, dsnap, ops=kassign.PLAIN, stats=None):
    """The whole solve (either mode) through the plain versions only, on
    the snapshot's device: no kernel launches."""
    buf = _pack_solve(solve_core(cfg, dsnap, ops=ops, stats=stats))
    return Engine.unpack(dsnap, buf.cpu().numpy())


def validity(name: str, cfg: EngineConfig, dsnap, res,
             mask: np.ndarray) -> dict:
    """No padded pod placed, no node over capacity, every placed pod's
    static mask true at its node, a finite score for every placed pod
    (without preemption), the order a permutation."""
    pvalid = dsnap.pods.valid.cpu().numpy()
    alloc = dsnap.nodes.allocatable.cpu().numpy()
    a = res.assignment
    placed = a >= 0
    if (placed & ~pvalid).any():
        raise AssertionError(f"{name}: a padded pod was placed")
    hit = np.zeros(alloc.shape[0], bool)
    hit[a[placed]] = True
    over = (res.final_used[hit] > alloc[hit]).any(axis=1)
    if over.any():
        raise AssertionError(f"{name}: {int(over.sum())} nodes over capacity")
    if not mask[np.nonzero(placed)[0], a[placed]].all():
        raise AssertionError(f"{name}: a pod was placed where its static "
                             "mask is false")
    # A preempted placement carries chosen = -inf (no rescore).
    if not cfg.preemption and not np.isfinite(res.chosen_score[placed]).all():
        raise AssertionError(f"{name}: a placed pod has no finite score")
    P = a.shape[0]
    if sorted(res.order.tolist()) != list(range(P)):
        raise AssertionError(f"{name}: order is not a permutation")
    return {"placed": int(placed.sum()), "valid_pods": int(pvalid.sum())}


def audit(name: str, cfg: EngineConfig, dsnap, res, hook=None) -> dict:
    """Validity of one solve result, then equality with the plain solve
    on the same CUDA tensors (host reads too, in fast mode); with
    signatures also the pairwise audit of the plain solve's final pair
    state (parity: the plain scan's, with its time; fast: the last
    state the rounds' commits and reverts left) and the commit-key
    audit (with preemption, in both eviction arms). hook(ops) may wrap
    the plain solve's ops table to record calls."""
    plain = kassign.PLAIN
    static = kassign.precompute_static(cfg, dsnap, *_sat_tables(dsnap, plain),
                                       ops=plain)
    info = validity(name, cfg, dsnap, res, static.mask.cpu().numpy())
    pstats = kassign.RoundStats()
    scans, states, pre_scans, s0_scans = [], [], [], []

    def record_s0(*args):
        t0 = time.perf_counter()
        out = kassign.parity_scan_plain(*args)
        torch.cuda.synchronize()
        s0_scans.append((args, out, (time.perf_counter() - t0) * 1e3))
        return out

    def record(*args):
        t0 = time.perf_counter()
        out = kassign.parity_scan_pair_plain(*args)
        torch.cuda.synchronize()
        scans.append((args, out, (time.perf_counter() - t0) * 1e3))
        return out

    def last_state(*args):
        out = kpair.pair_commit_plain(*args)
        # The solo rounds run as a batch of one: its state is [1, S, N].
        states[:] = [out.tenant(0) if out.counts.dim() == 3 else out]
        return out

    def record_pre(*args, explain=False):
        # The plain scan finds each victim's evictor either way: keep
        # them, so that K4's explain outputs are held at this size too.
        t0 = time.perf_counter()
        out = kassign.parity_scan_preempt_plain(*args, explain=True)
        torch.cuda.synchronize()
        pre_scans.append((args, out, (time.perf_counter() - t0) * 1e3))
        return out if explain else out[:4]

    ops = dataclasses.replace(
        plain, parity_scan=record_s0, parity_scan_pair=record,
        pair_commit=last_state, parity_scan_preempt=record_pre)
    t0 = time.perf_counter()
    want = plain_result(cfg, dsnap, hook(ops) if hook else ops, pstats)
    info["plain_solve_ms"] = (time.perf_counter() - t0) * 1e3
    for field in ("assignment", "order", "chosen_score", "commit_key",
                  "final_used", "evicted", "rounds"):
        got, exp = getattr(res, field), getattr(want, field)
        if not np.array_equal(got, exp):
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 "solve on the same CUDA tensors")
    if cfg.mode == "fast" and res.host_reads != pstats.host_reads:
        raise AssertionError(f"{name}: {res.host_reads} host reads, the "
                             f"plain solve {pstats.host_reads}")
    dom_s = kpair.sig_domains(dsnap)
    if scans:
        info.update(pair_audit(name, dsnap, res, static.sig_match, dom_s,
                               scans[0][1][3]))
        info["plain_scan_ms"] = scans[0][2]
        info["plain_pair_scan"] = scans[0]
    if states:
        info.update(pair_audit(name, dsnap, res, static.sig_match, dom_s,
                               states[0]))
    fast_pre = cfg.mode == "fast" and cfg.preemption
    if states or fast_pre:
        info.update(commit_key_audit(name, dsnap, res, static, dom_s,
                                     res.evicted if fast_pre else None))
    if pre_scans:
        info["plain_preempt_scan"] = pre_scans[0]
    if s0_scans:
        info["plain_scan"] = s0_scans[0]
    return info


def gang_audit(name: str, dsnap, res, rolled: np.ndarray) -> dict:
    """Every pod group has no placed member or at least min_member; the
    pods the plain solve's gang gate rolled back are unplaced."""
    group = dsnap.pods.group.cpu().numpy()
    gmin = dsnap.group_min_member.cpu().numpy()
    placed = res.assignment >= 0
    cnt = np.bincount(group[placed & (group >= 0)], minlength=gmin.shape[0])
    partial = (cnt > 0) & (cnt < gmin)
    if partial.any():
        raise AssertionError(f"{name}: {int(partial.sum())} pod groups are "
                             "placed in part")
    if placed[rolled].any():
        raise AssertionError(f"{name}: a rolled-back pod is placed")
    return {"groups": int((gmin > 0).sum()),
            "groups_placed": int((cnt > 0).sum()),
            "rolled_pods": int(rolled.sum()),
            "rolled_groups": int(np.unique(group[rolled]).shape[0])}


def preempt_audit(name: str, dsnap, res, rounds=None) -> dict:
    """final_used equals the snapshot's usage less the evicted victims'
    requests plus the placed pods' (recomputed in f64, rtol 1e-6 of each
    node's capacity); evicted victims are valid running pods on nodes
    where a preempted pod landed; no preempted pod (placed with chosen =
    -inf) belongs to a gang. rounds (fast preemption with signatures,
    where the end-of-round validation may revert a preemptor and leave
    its victims evicted): [(evicted before, kept eviction bids, their
    claimed nodes, evicted after)] of each auction round of the plain
    solve; the victims of a round must sit on nodes that round's kept
    eviction bids claimed, in place of the landing clause, whose misses
    are counted as stranded victims."""
    run, pods, nodes = dsnap.running, dsnap.pods, dsnap.nodes
    a, ev = res.assignment, res.evicted
    placed = a >= 0
    rnode = run.node_idx.cpu().numpy()
    if not (run.valid.cpu().numpy()[ev].all() and (rnode[ev] >= 0).all()):
        raise AssertionError(f"{name}: an evicted victim is not a running "
                             "pod on a node")
    want = nodes.used.cpu().numpy().astype(np.float64)
    np.subtract.at(want, rnode[ev], run.requests.cpu().numpy()[ev])
    np.add.at(want, a[placed], pods.requests.cpu().numpy()[placed])
    alloc = nodes.allocatable.cpu().numpy().astype(np.float64)
    off = np.abs(res.final_used - want) > 1e-6 * np.maximum(alloc, 1.0)
    if off.any():
        raise AssertionError(f"{name}: final_used differs from the usage "
                             f"less evictions plus placements at "
                             f"{int(off.sum())} entries")
    preempted = placed & ~np.isfinite(res.chosen_score)
    group = pods.group.cpu().numpy()
    if (group[preempted] >= 0).any():
        raise AssertionError(f"{name}: a gang member was placed by "
                             "preemption")
    landed = np.isin(rnode, a[preempted])
    stranded = int((ev & ~landed).sum())
    if rounds is None and stranded:
        raise AssertionError(f"{name}: a victim was evicted from a node no "
                             "preempted pod took")
    if rounds is not None:
        union = np.zeros_like(ev)
        for before, keep, target, after in rounds:
            # The solo rounds run as a batch of one: [1, M] marks.
            new = (after & ~before).cpu().numpy().reshape(-1)
            claimed = target[keep].cpu().numpy()
            if not np.isin(rnode[new], claimed).all():
                raise AssertionError(f"{name}: a victim was evicted from a "
                                     "node no kept eviction bid of its round "
                                     "claimed")
            union |= new
        if not np.array_equal(union, ev):
            raise AssertionError(f"{name}: the rounds' evictions are not "
                                 "the solve's")
    pvalid = pods.valid.cpu().numpy()
    return {"evicted": int(ev.sum()), "preempted": int(preempted.sum()),
            "stranded": stranded,
            "searches": int(preempted.sum()
                            + (pvalid & (group < 0) & ~placed).sum())}


def pair_audit(name: str, dsnap, res, sig_match, dom_s, final) -> dict:
    """The pairwise audit of a solve with signatures from the final pair
    state of its plain solve (already equal in assignment to `res`):
    that state equals K10's recount at the assignment (bitwise), and
    the required anti-affinity terms hold in the final placement both
    ways (numpy, from the recount)."""
    asg_t = torch.from_numpy(res.assignment).to(dom_s.device)
    rec = kpair.pair_counts(sig_match, dom_s, dsnap.running, dsnap.pods,
                            assigned=asg_t)
    for field in ("counts", "anti", "match_tot"):
        if not torch.equal(getattr(rec, field), getattr(final, field)):
            raise AssertionError(f"{name}: the solve's final {field} differs "
                                 "from K10's recount at the assignment")
    match = sig_match.cpu().numpy()
    dom = dom_s.cpu().numpy()
    counts, anti = rec.counts.cpu().numpy(), rec.anti.cpu().numpy()
    pods = dsnap.pods
    ia_sig = pods.ia_sig.cpu().numpy()
    holds = kpair.pod_anti_holds(pods).cpu().numpy()
    M = dsnap.running.valid.shape[0]
    S = dom.shape[0]
    asg = res.assignment
    placed = np.nonzero(asg >= 0)[0]
    mine = match[:, M + placed]                              # [S, Q]
    own = np.zeros((S, asg.shape[0]), np.int64)              # own holds
    holders = 0
    for t in range(ia_sig.shape[1]):
        sel = placed[holds[placed, t]]
        holders += sel.shape[0]
        np.add.at(own, (ia_sig[sel, t], sel), 1)
        s = ia_sig[sel, t]
        d = dom[s, asg[sel]]
        keyed = d >= 0
        others = (counts[s, np.maximum(d, 0)]
                  - match[s, M + sel].astype(np.float32))
        bad = keyed & (others != 0)
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} placed holders of a required "
                "anti term share their domain with a matching member")
    d_all = dom[:, asg[placed]]                              # [S, Q]
    held = np.take_along_axis(anti, np.maximum(d_all, 0), axis=1)
    others = held - own[:, placed]
    bad = mine & (d_all >= 0) & (others != 0)
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.any(axis=0).sum())} placed pods sit in a "
            "domain holding a required anti term that matches them")
    return {"anti_holders": holders, "signatures": S}


def commit_key_audit(name: str, dsnap, res, static, dom_s,
                     evicted: np.ndarray | None = None) -> dict:
    """The fast mode's contract (the JAX package's validate_assignment
    with the commit key, in numpy): every placed pod's DoNotSchedule
    spread skew, required inter-pod terms and the symmetric anti-affinity
    of the members hold against K10's recount of the pods whose commit
    key is at most its own, the pod itself left out. With `evicted` (fast
    preemption) the capacity holds with every eviction applied, and, as
    validate_assignment does without the evictions' timing, a pairwise
    violation counts only if it holds in both arms: the evicted running
    members counted, and left out."""
    pods, nodes = dsnap.pods, dsnap.nodes
    M = dsnap.running.valid.shape[0]
    asg, key = res.assignment, res.commit_key
    S = dom_s.shape[0]
    info = {"signatures": S}
    if evicted is not None:
        run = dsnap.running
        use = nodes.used.cpu().numpy().astype(np.float64)
        np.subtract.at(use, run.node_idx.cpu().numpy()[evicted],
                       run.requests.cpu().numpy()[evicted])
        np.add.at(use, asg[asg >= 0], pods.requests.cpu().numpy()[asg >= 0])
        over = (use > nodes.allocatable.cpu().numpy() + 1e-3).any(axis=1)
        if (over & nodes.valid.cpu().numpy()).any():
            raise AssertionError(f"{name}: {int(over.sum())} nodes over "
                                 "capacity with the evictions applied")
    if S == 0:
        return info
    match = static.sig_match.cpu().numpy()
    dom = dom_s.cpu().numpy()
    aff_ok = static.aff_ok.cpu().numpy()
    nvalid = nodes.valid.cpu().numpy()
    ts_sig, ts_valid, ts_when, ts_skew = (
        t.cpu().numpy() for t in (pods.ts_sig, pods.ts_valid, pods.ts_when,
                                  pods.ts_max_skew))
    ia_sig, ia_valid, ia_anti, ia_req = (
        t.cpu().numpy() for t in (pods.ia_sig, pods.ia_valid, pods.ia_anti,
                                  pods.ia_required))
    holds = kpair.pod_anti_holds(pods).cpu().numpy()
    ev_t = (torch.from_numpy(evicted).to(dom_s.device)
            if evicted is not None and evicted.any() else None)

    def violations(st, ps) -> np.ndarray:
        counts, anti = st.counts.cpu().numpy(), st.anti.cpu().numpy()
        mtot = st.match_tot.cpu().numpy()
        ns = asg[ps]
        bad = np.zeros(ps.shape[0], bool)
        for c in range(ts_sig.shape[1]):
            s = np.maximum(ts_sig[ps, c], 0)
            dp = dom[s]                                      # [Q, N]
            d = dp[np.arange(ps.shape[0]), ns]
            self_in = match[s, M + ps] & (d >= 0)
            excl = (np.take_along_axis(counts[s], np.maximum(dp, 0), axis=1)
                    - (self_in[:, None] & (dp == d[:, None])))
            elig = nvalid[None, :] & aff_ok[ps] & (dp >= 0)
            lo = np.where(elig, excl, np.inf).min(axis=1)
            lo = np.where(np.isfinite(lo), lo, 0.0)
            nc = excl[np.arange(ps.shape[0]), ns]
            ok = (d >= 0) & (nc + 1.0 - lo <= ts_skew[ps, c])
            bad |= ts_valid[ps, c] & (ts_when[ps, c] == 0) & ~ok
        own = np.zeros(ps.shape[0], np.int64)
        for t in range(ia_sig.shape[1]):
            s = np.maximum(ia_sig[ps, t], 0)
            d = dom[s, ns]
            self_m = match[s, M + ps]
            hk = d >= 0
            nc = counts[s, np.maximum(d, 0)] - (self_m & hk)
            node_has = hk & (nc > 0)
            all_zero = mtot[s] - self_m <= 0
            ok = np.where(ia_anti[ps, t], ~node_has,
                          node_has | (all_zero & self_m & hk))
            bad |= ia_valid[ps, t] & ia_req[ps, t] & ~ok
            own += holds[ps, t] & self_m & hk
        d_all = dom[:, ns]                                   # [S, Q]
        held = np.where(d_all >= 0, np.take_along_axis(
            anti, np.maximum(d_all, 0), axis=1), 0.0).astype(np.int64)
        return bad | ((match[:, M + ps] * held).sum(axis=0) - own > 0)

    checked = one_arm = 0
    for k in np.unique(key[asg >= 0]):
        upto = np.where((asg >= 0) & (key <= k), asg, -1).astype(np.int32)
        st = kpair.pair_counts(static.sig_match, dom_s, dsnap.running, pods,
                               assigned=torch.from_numpy(upto).to(
                                   dom_s.device))
        ps = np.nonzero((asg >= 0) & (key == k))[0]
        bad = violations(st, ps)
        if ev_t is not None:
            bad_ev = violations(kpair.pair_state_evict(
                dsnap, st, static.sig_match, dom_s, ev_t), ps)
            one_arm += int((bad ^ bad_ev).sum())
            bad = bad & bad_ev
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} pods committed at key {k} violate "
                "a spread or required inter-pod term against the pods "
                "committed up to their key")
        checked += ps.shape[0]
    info.update(commit_key_checked=checked, keys=int(np.unique(
        key[asg >= 0]).shape[0]))
    if ev_t is not None:
        info["one_arm_only"] = one_arm
    return info


def counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr, _, _ in KERNELS}


def zero_counts() -> None:
    for _, fn, attr, _, _ in KERNELS:
        setattr(fn, attr, 0)


def pair_kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """K9-K11 against their plain versions on the full-size pairwise
    cell, with times and bounds (K4's pairwise variant: k4_rows, after
    the (d) and (e) solves' audits)."""
    nodes, pods = dsnap.nodes, dsnap.pods
    out = {}
    node_sat_t, member_sat_t = _sat_tables(dsnap)
    member_ns = kpair.merge_members(dsnap.running.namespace, pods.namespace)
    # K9
    args9 = (member_sat_t, dsnap.sigs, member_ns)
    sm = kpair.sig_match(*args9)
    err = require_equal("sig_match", [sm], [kpair.sig_match_plain(*args9)])
    A, X = member_sat_t.shape
    S, AT = dsnap.sigs.atoms.shape
    NS = dsnap.sigs.ns.shape[1]
    b9 = nbytes(member_sat_t, *vars(dsnap.sigs).values(), member_ns, sm)
    out["sig_match"] = dict(
        err=err, ms=cuda_ms(lambda: kpair.sig_match(*args9), 20),
        plain_ms=cuda_ms(lambda: kpair.sig_match_plain(*args9), 5),
        bound=bound(b9, S * X * (AT + NS + 2)),
        shape=f"S={S} X={X} A={A} AT={AT} NS={NS}")
    # K10
    static = kassign.precompute_static(cfg, dsnap, node_sat_t, member_sat_t)
    order = kassign.pop_order(cfg, dsnap)
    dom_s = kpair.sig_domains(dsnap)
    run = dsnap.running
    args10 = (static.sig_match, dom_s, run, pods)
    st = kpair.pair_counts(*args10)
    want = kpair.pair_counts_plain(*args10)
    err = require_equal("pair_counts", [st.counts, st.anti, st.match_tot],
                        [want.counts, want.anti, want.match_tot])
    J, IT = run.anti_sig.shape[1], pods.ia_sig.shape[1]
    M, P = run.valid.shape[0], pods.valid.shape[0]
    N = nodes.valid.shape[0]
    b10 = nbytes(static.sig_match, dom_s, run.node_idx, run.valid,
                 run.anti_sig, pods.ia_sig, pods.ia_valid, pods.ia_anti,
                 pods.ia_required, st.counts, st.anti, st.match_tot)
    out["pair_counts"] = dict(
        err=err, ms=cuda_ms(lambda: kpair.pair_counts(*args10), 20),
        plain_ms=cuda_ms(lambda: kpair.pair_counts_plain(*args10), 5),
        bound=bound(b10, S * X * 3 + M * J + P * IT),
        shape=f"S={S} N={N} M={M} P={P} J={J} IT={IT}",
        counted=float(st.counts.sum().item()))
    # K11
    args11 = (dsnap, st, static.aff_ok, static.sig_match, dom_s)
    got = kpair.pairwise_batch(*args11)
    err = require_equal("pairwise_batch", got,
                        kpair.pairwise_batch_plain(*args11))
    C = pods.ts_sig.shape[1]
    b11 = nbytes(static.aff_ok, nodes.valid, dom_s, static.sig_match,
                 pods.ts_sig, pods.ts_valid, pods.ts_when, pods.ts_max_skew,
                 pods.ia_sig, pods.ia_valid, pods.ia_anti, pods.ia_required,
                 pods.ia_weight, st.counts, st.anti, st.match_tot, *got)
    cell_ops = C * 6 + IT * 10 + S * 3 + 14
    out["pairwise_batch"] = dict(
        err=err, ms=cuda_ms(lambda: kpair.pairwise_batch(*args11), 10),
        plain_ms=cuda_ms(lambda: kpair.pairwise_batch_plain(*args11), 3),
        bound=bound(b11, P * N * cell_ops),
        shape=f"P={P} N={N} S={S} C={C} IT={IT}",
        pair_ok=int(got[0].sum().item()))
    return out


def k4_rows(name: str, plain_scan, smi: str) -> dict:
    """K4 (its pairwise variant where the audit's plain scan carried a
    pair state) at the policy's cluster size Q and at Q = 1, each against
    the audit's plain scan of the same call (run once, tens of seconds),
    exact in every output (with signatures the final pair state too);
    CUDA-event and profiler times, us a pod. Returns the row of the
    policy's Q, with Q = 1's numbers beside it."""
    args, want, plain_ms = plain_scan
    pair = len(args) == 6
    cfg, dsnap, static = args[:3]
    nodes, pods = dsnap.nodes, dsnap.pods
    fn = kassign.parity_scan_pair if pair else kassign.parity_scan
    kname = "parity_scan_pair" if pair else "parity_scan"
    flat = ((lambda r: [r[0], r[1], r[2], r[3].counts, r[3].anti,
                        r[3].match_tot]) if pair else list)
    P, N = static.mask.shape
    R = nodes.allocatable.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q_pol = kassign.scan_cluster_size(1, N, sms)[0]
    runs = {}
    for q in (q_pol, 1):
        got = fn(*args, cluster=q)
        err = require_equal(f"{kname} on {name} at Q={q}", flat(got),
                            flat(want))
        ms = cuda_ms(lambda: fn(*args, cluster=q), 3)
        prof = profiler_ms(lambda: fn(*args, cluster=q),
                           "parity_scan_kernel", reps=2)
        runs[q] = (err, ms, prof)
        log(f"K4{' pairwise variant' if pair else ''} on {name}: Q={q}, "
            f"{kassign.scan_threads(N, q)} threads a CTA, {ms:.3f} ms "
            f"(CUDA events; profiler kernel time "
            + ("not measured" if prof is None else f"{prof:.3f} ms")
            + f"), {ms * 1e3 / P:.3f} us a pod; exact against the plain "
            f"scan ({plain_ms:.1f} ms); {smi}")
    b4 = nbytes(static.mask, static.score, nodes.allocatable, nodes.used,
                pods.requests, static.w_lr, static.w_ba, static.w_ts,
                static.w_ia, static.rw, *flat(want)) + 4 * P
    ops4 = P * N * (R * 14 + 12)
    if pair:
        dom_s, st = args[5], args[4]
        S, C, IT = dom_s.shape[0], pods.ts_sig.shape[1], pods.ia_sig.shape[1]
        b4 += nbytes(static.aff_ok, dom_s, static.sig_match, st.counts,
                     st.anti, st.match_tot)
        ops4 += P * N * (C * 6 + IT * 10 + S * 3 + 14)
    err, ms, prof = runs[q_pol]
    t4 = bound(b4, ops4)
    log(f"K4{' pairwise variant' if pair else ''} on {name}: bound "
        f"{t4[0]:.4f} ms ({t4[1]}); {smi}")
    return dict(
        err=max(r[0] for r in runs.values()), ms=ms, prof_ms=prof,
        plain_ms=plain_ms, bound=t4,
        shape=f"P={P} N={N} R={R}, Q={q_pol} "
              f"({kassign.scan_threads(N, q_pol)} threads a CTA; Q=1 "
              f"{runs[1][1]:.3f} ms)",
        placed=int((want[0] >= 0).sum().item()))


def kernel_phase(cfg: EngineConfig, dsnap, smi: str) -> dict:
    """Each kernel against its plain version on the same CUDA tensors,
    with times and bounds."""
    nodes, pods = dsnap.nodes, dsnap.pods
    out = {}
    # K1
    args1 = (dsnap.atoms, nodes.label_pairs, nodes.label_keys,
             nodes.label_nums)
    sat_k = atom_sat(*args1)
    sat_p = atom_sat_plain(*args1)
    err = require_equal("atom_sat", [sat_k], [sat_p])
    X, L = nodes.label_pairs.shape
    A, V = dsnap.atoms.pairs.shape
    b1 = nbytes(nodes.label_pairs, nodes.label_keys, nodes.label_nums,
                *vars(dsnap.atoms).values(), sat_k)
    out["atom_sat"] = dict(
        err=err, ms=cuda_ms(lambda: atom_sat(*args1), 20),
        plain_ms=cuda_ms(lambda: atom_sat_plain(*args1), 5),
        bound=bound(b1, X * A * L * (V + 3)), shape=f"X={X} L={L} A={A} V={V}")
    node_sat_t = sat_k.T.contiguous()
    # K2
    args2 = (dsnap, pods, nodes, node_sat_t)
    cells_k = kassign._tableau_cells(*args2)
    cells_p = kassign._tableau_cells_plain(*args2)
    err = require_equal("tableau_cells", cells_k, cells_p)
    P, N = cells_k[0].shape
    T, AT = pods.req_term_atoms.shape[1:]
    PT, TN = pods.pref_term_atoms.shape[1], nodes.taint_ids.shape[1]
    b2 = nbytes(node_sat_t, pods.req_term_atoms, pods.req_term_valid,
                pods.pref_term_atoms, pods.pref_term_valid,
                pods.pref_weight, nodes.taint_ids, dsnap.taint_effect,
                pods.tolerated, nodes.schedulable, nodes.valid,
                pods.tolerates_unsched, pods.valid, *cells_k)
    ops2 = P * N * ((T + PT) * (AT + 1) + 3 * TN + 6)
    out["tableau_cells"] = dict(
        err=err, ms=cuda_ms(lambda: kassign._tableau_cells(*args2), 10),
        plain_ms=cuda_ms(lambda: kassign._tableau_cells_plain(*args2), 5),
        bound=bound(b2, ops2), shape=f"P={P} N={N} T={T} AT={AT} PT={PT} "
                                     f"TN={TN}")
    # K3
    w = effective_weights(cfg, pressure_of(pods.slo_target,
                                           pods.observed_avail))
    args3 = (cells_k[2], cells_k[3], nodes.valid, w["node_affinity"],
             w["taint_toleration"])
    score_k = kassign.finalize_score(*args3)
    score_p = kassign.finalize_score_plain(*args3)
    err = require_equal("finalize_static", [score_k], [score_p])
    b3 = nbytes(*args3, score_k)
    out["finalize_static"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.finalize_score(*args3), 10),
        plain_ms=cuda_ms(lambda: kassign.finalize_score_plain(*args3), 5),
        bound=bound(b3, P * N * 12), shape=f"P={P} N={N}")
    # K4 is held in the parity audits (k4_rows); K5-K8 take its inputs.
    static = kassign.finalize_static(
        cfg, dsnap, kassign.WarmTableau(node_sat_t, None, None, *cells_k))
    order = kassign.pop_order(cfg, dsnap)
    out.update(fast_kernel_phase(cfg, dsnap, static, order, smi))
    return out


def k7_library(feasible, masked, allowed):
    """One PyTorch expression of K7's column sum, a yardstick of speed
    only: torch.sum adds in another f32 order."""
    return torch.where(feasible & allowed[..., None], masked, 0.0).sum(-2)


def k7_row(name: str, args, smi: str, view: int = 0) -> dict:
    """K7's f32 path on `args` (feasible, masked, allowed of one call)
    against its plain version, exact, and with `view` rows also on a
    compacted view (the first `view` rows, gathered, as a tranche's);
    CUDA-event and profiler times beside the library yardstick, and the
    bound from the bytes of the allowed rows."""
    f, m, al = args
    got = kassign.desirability(f, m, al)
    err = require_equal(f"desirability on {name}", [got],
                        [kassign.desirability_plain(f, m, al)])
    more = ""
    if view:
        va = tuple(t[..., :view, :].contiguous() if t.dim() == f.dim()
                   else t[..., :view].contiguous() for t in args)
        err = max(err, require_equal(
            f"desirability on {name}, {view}-row view",
            [kassign.desirability(*va)], [kassign.desirability_plain(*va)]))
        more = (f"; {view}-row view "
                f"{cuda_ms(lambda: kassign.desirability(*va), 20):.4f} ms")
    *lead, rows, N = m.shape
    B = lead[0] if lead else 1
    n_al = int(al.sum().item())
    r = dict(
        err=err, ms=cuda_ms(lambda: kassign.desirability(f, m, al), 20),
        prof_ms=profiler_ms(lambda: kassign.desirability(f, m, al),
                            "desirability_kernel"),
        plain_ms=cuda_ms(lambda: kassign.desirability_plain(f, m, al), 2),
        library="torch.where + sum (another f32 order)",
        library_ms=cuda_ms(lambda: k7_library(f, m, al), 20),
        bound=bound(n_al * N * 5 + nbytes(al) + B * N * 4, n_al * N * 2),
        shape=f"B={B} rows={rows} N={N}, {n_al} allowed rows{more}")
    log_rows({"desirability": r}, name, smi)
    return r


def first_k7_args(cfg: EngineConfig, dsnap):
    """The arguments of the first K7 call (f32) of a fast solve: round
    0's, every pod's row."""
    calls = []

    def record(*args, **kw):
        if not calls:
            calls.append(args)
        return kassign.desirability(*args, **kw)

    ops = dataclasses.replace(kassign.KERNELS, desirability=record)
    kassign.solve_rounds(cfg, dsnap, _sat_tables(dsnap)[0], ops=ops)
    return calls[0]


def loop_calls(cfg: EngineConfig, dsnap, want=lambda site, a: True,
               solve=None, first: bool = True):
    """The arguments (cloned) of K8's loop calls in one fast solve of
    `dsnap` whose _deal_commit caller (by function name) and arguments
    pass `want`: the first such call, or all of them."""
    calls = []

    def record(*args):
        if (not (first and calls)
                and want(sys._getframe(2).f_code.co_name, args)):
            calls.append(tuple(x.clone() if isinstance(x, torch.Tensor)
                               else x for x in args))
        return kassign.prefix_commit_loop(*args)

    ops = dataclasses.replace(kassign.KERNELS, prefix_commit_loop=record)
    (solve or solve_core)(dataclasses.replace(cfg, mode="fast"), dsnap,
                          ops=ops)
    return calls[0] if first else calls


def k8_set(label: str, args, smi: str) -> dict:
    """K8's loop kernel (every sub-step of a round in one launch) against
    the plain loop on one argument set, exactly, timed by CUDA events and
    the profiler's kernel time; the bound counts each argument read and
    each output written once, and the scan's adds and fit tests over the
    active rows of each sub-step (from the plain loop's sub-steps)."""
    args = args[:7]       # the recorded call's sub-step hook is not timed
    got = kassign.prefix_commit_loop(*args)
    err = require_equal(f"prefix_commit_loop ({label})", got,
                        kassign.prefix_commit_loop_plain(*args))
    active = []

    def step(perm, cand_s, requests, alloc, *rest):
        active.append(int((cand_s < alloc.shape[-2]).sum()))
        return kassign.prefix_commit_plain(perm, cand_s, requests, alloc,
                                           *rest)

    kassign.prefix_commit_loop_plain(*args, step=step)
    R = args[4].shape[-1]
    ops = sum(A * R * (max(1, (A - 1).bit_length()) + 3) for A in active)
    fn = lambda: kassign.prefix_commit_loop(*args)  # noqa: E731
    lead = tuple(args[3].shape[:-1])
    row = dict(
        err=err, ms=cuda_ms(fn, 10),
        prof_ms=profiler_ms(fn, "prefix_commit_loop_kernel"),
        plain_ms=cuda_ms(lambda: kassign.prefix_commit_loop_plain(*args), 3),
        bound=bound(nbytes(*args, *got), ops),
        substeps=int(got[2].sum()), committed=int((got[1] >= 0).sum()),
        shape=f"{label}: B={lead[0] if lead else 1} P={args[3].shape[-1]} "
              f"KC={args[0].shape[-1]} N={args[5].shape[-2]} R={R}, "
              f"{int(got[2].sum())} sub-steps over "
              f"{sum(active)} active rows, {int((got[1] >= 0).sum())} "
              f"committed")
    log_rows({"prefix_commit_loop": row}, label, smi)
    return row


def k8_merge(kp: dict, label: str, row: dict) -> None:
    """One more argument set of K8's row: its error joins the row's, its
    numbers go under extra["sets"]."""
    r = kp["prefix_commit_loop"]
    r["err"] = max(r["err"], row["err"])
    r.setdefault("extra", {}).setdefault("sets", {})[label] = {
        k: row[k] for k in ("ms", "prof_ms", "plain_ms", "substeps",
                            "committed")} | {"bound_ms": row["bound"][0]}


def fast_kernel_phase(cfg: EngineConfig, dsnap, static, order,
                      smi: str) -> dict:
    """K5-K8 against their plain versions at the shapes of ScoreBatch and
    of the first fast round."""
    nodes, pods = dsnap.nodes, dsnap.pods
    P, N = static.mask.shape
    R = nodes.allocatable.shape[1]
    out = {}
    # K5: full width (ScoreBatch), then a 1024-row view (a tranche: the
    # first 1024 pods in pop order, the even ones of them pending).
    args5 = (nodes.allocatable, nodes.used, pods.requests, static.mask,
             static.score, static.w_lr, static.w_ba, static.w_ts, static.rw)
    got = kassign.cycle(*args5)
    err = require_equal("cycle", got, kassign.cycle_plain(*args5))
    rows = order[:1024].to(torch.int32).contiguous()
    pend = pods.valid[rows.long()] & (torch.arange(
        rows.shape[0], device=rows.device) % 2 == 0)
    view_k = kassign.cycle(*args5, rows=rows, pending=pend, masked=True)
    err = max(err, require_equal("cycle (1024-row view)", view_k,
                                 kassign.cycle_plain(*args5, rows=rows,
                                                     pending=pend,
                                                     masked=True)))
    r64 = rows.long()
    gathered = (nodes.allocatable, nodes.used, pods.requests[r64].clone(),
                static.mask[r64].clone(), static.score[r64].clone(),
                static.w_lr[r64].clone(), static.w_ba[r64].clone(),
                static.w_ts[r64].clone(), static.rw)
    require_equal("cycle view vs gathered copies", view_k,
                  kassign.cycle(*gathered, pending=pend, masked=True))
    b5 = nbytes(*args5, *got)
    ops5 = P * N * (R * 14 + 12)
    view = dict(rows=rows, pending=pend, masked=True)
    view_ms = cuda_ms(lambda: kassign.cycle(*args5, **view), 10)
    # Other tiles (rows, threads a CTA) than cycle_tile's, each exact, at
    # full width and on the view.
    tiles = {}
    choose = kassign.cycle_tile
    try:
        for tile in CYCLE_TILES:
            kassign.cycle_tile = lambda n: tile  # noqa: E731
            require_equal(f"cycle, tile {tile}", kassign.cycle(*args5), got)
            require_equal(f"cycle (1024-row view), tile {tile}",
                          kassign.cycle(*args5, **view), view_k)
            tiles[tile] = tuple(
                cuda_ms(lambda: kassign.cycle(*args5, **kw), 10)
                for kw in ({}, view))
    finally:
        kassign.cycle_tile = choose
    log(f"K5 tiles on (b) (rows x threads a CTA: full width ms / "
        f"{rows.shape[0]}-row view ms): cycle_tile "
        f"{kassign.cycle_tile(N)}"
        "; " + ", ".join(f"{t[0]}x{t[1]} {a:.4f} / {b:.4f}"
                         for t, (a, b) in tiles.items()))
    view_prof = profiler_ms(lambda: kassign.cycle(*args5, **view),
                            "cycle_kernel")
    out["cycle"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.cycle(*args5), 10),
        prof_ms=profiler_ms(lambda: kassign.cycle(*args5), "cycle_kernel"),
        plain_ms=cuda_ms(lambda: kassign.cycle_plain(*args5), 3),
        bound=bound(b5, ops5),
        extra={"view_ms": view_ms, "view_prof_ms": view_prof},
        shape=f"P={P} N={N} R={R}; {rows.shape[0]}-row view "
              f"{view_ms:.4f} ms (profiler " + (
                  "not measured" if view_prof is None
                  else f"{view_prof:.4f} ms") + ")")
    # K6 on the first fast round's masked block (all valid pods pending).
    feasible, masked = kassign.cycle(*args5, pending=pods.valid, masked=True)
    K = kassign._fallback_depth(N)
    ids = torch.arange(P, dtype=torch.int32, device=masked.device)
    seed = cfg.tie_seed if cfg.tie_break == "seeded" else SEED
    args6 = (masked, K, True, seed, ids)
    top_k = kassign.row_topk(*args6)
    err = require_equal("row_topk (K=8, seeded)", top_k,
                        kassign.row_topk_plain(*args6))
    err = max(err, require_equal("row_topk (kb=8)",
                                 kassign.row_topk(masked, 8),
                                 kassign.row_topk_plain(masked, 8)))
    b6 = nbytes(masked, ids, *top_k)
    out["row_topk"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.row_topk(*args6), 10),
        plain_ms=cuda_ms(lambda: kassign.row_topk_plain(*args6), 3),
        library="torch.topk",
        library_ms=cuda_ms(lambda: torch.topk(masked, K, dim=1), 10),
        bound=bound(b6, P * N), shape=f"P={P} N={N} K={K} seeded")
    # K6's two paths without the seeded pick on the same rows, each exact:
    # the K-pass kernel and the radix select, at the fast rounds' K and
    # the auction's (their times set kassign.RADIX_MIN_K).
    paths = {}
    for kk in (4, 8, 16, 256):
        for radix in (False, True):
            require_equal(f"row_topk (K={kk}, radix={radix})",
                          kassign.row_topk_path(masked, kk, radix=radix),
                          kassign.row_topk_plain(masked, kk))
        paths[kk] = tuple(
            cuda_ms(lambda: kassign.row_topk_path(masked, kk, radix=radix),
                    10) for radix in (False, True))
    out["row_topk"]["paths"] = paths
    log("K6 paths on (b)'s first fast round (K-pass ms / radix ms): "
        + ", ".join(f"K={kk} {a:.4f} / {b:.4f}"
                    for kk, (a, b) in paths.items())
        + f"; radix from K={kassign.RADIX_MIN_K}")
    # K8's loop on the first fast round, at full width.
    label = "(b)'s round 1, full width"
    out["prefix_commit_loop"] = k8_set(label, loop_calls(cfg, dsnap), smi)
    k8_merge(out, label, out["prefix_commit_loop"])
    return out


def k5_sizes(cells, smi: str) -> list:
    """K5's calls in one fast solve of each cell (the wrapper recorded
    through an Ops table), by size class (the power of two at or above
    B x rows): calls per cell, and the CUDA-event ms of every call in the
    solve summed over the class (an event pair around each wrapper call;
    a window holds the wrapper's host work where the card waits on it),
    with the class's share of K5's time in these solves."""
    classes = {}
    for name, cfg, snap in cells:
        eng = Engine(cfg)
        dsnap = eng.put(snap)

        def rec(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kassign.cycle(*a, **kw)
            end.record()
            rows = kw.get("rows")
            n = (a[3].shape[-2] if rows is None else rows.shape[-1]) * (
                a[3].shape[0] if a[3].dim() == 3 else 1)
            c = classes.setdefault(1 << max(0, n - 1).bit_length(), {
                "calls": {}, "rows": set(), "events": []})
            c["calls"][name] = c["calls"].get(name, 0) + 1
            c["rows"].add(n)
            c["events"].append((start, end))
            return out

        solve_core(cfg, dsnap, ops=dataclasses.replace(kassign.KERNELS,
                                                       cycle=rec))
        eng.close()
    torch.cuda.synchronize()
    out = []
    for size in sorted(classes):
        c = classes[size]
        ms = sum(s.elapsed_time(e) for s, e in c["events"])
        out.append({"rows_upto": size, "rows_min": min(c["rows"]),
                    "rows_max": max(c["rows"]), "calls": c["calls"],
                    "ms": ms, "ms_per_call": ms / len(c["events"])})
    total = sum(c["ms"] for c in out)
    for c in out:
        c["share"] = c["ms"] / total
    log("K5 calls by size class in one fast solve of " + ", ".join(
        name.split(":")[0] for name, _, _ in cells) + " (CUDA events around "
        "every call): " + "; ".join(
            f"<= {c['rows_upto']} rows ({c['rows_min']}-{c['rows_max']}): "
            f"{c['calls']} calls, {c['ms']:.3f} ms in all, "
            f"{c['ms_per_call']:.4f} ms a call ({100 * c['share']:.1f} %)"
            for c in out)
        + f"; {total:.3f} ms in all; {smi}")
    return out


def first_pair_round_calls(cfg: EngineConfig, dsnap) -> dict:
    """The arguments of the first call of each fast pairwise kernel entry
    point in a fast solve of `dsnap` (its first round; node_add's first
    call that reverts anything), by kernels-line name."""
    calls = {}

    def rec(name, fn, want=lambda a, kw: True):
        def wrapped(*a, **kw):
            if name not in calls and want(a, kw):
                calls[name] = (fn, a, kw)
            return fn(*a, **kw)
        return wrapped

    k = kassign.KERNELS
    ops = dataclasses.replace(
        k, waterfill=rec("waterfill", k.waterfill),
        excess_min=rec("excess_min", k.excess_min),
        excess_survive=rec("excess_survive", k.excess_survive),
        ia_ok_at_choice=rec("ia_ok_at_choice", k.ia_ok_at_choice),
        pair_commit=rec("pair_commit", k.pair_commit),
        node_add=rec("node_add", k.node_add,
                     lambda a, kw: bool(a[2].any())),
        desirability=rec("desirability_fixed", k.desirability,
                         lambda a, kw: kw.get("fixed", False)),
        pairwise_batch=rec("pairwise_batch_ia_ok", k.pairwise_batch,
                           lambda a, kw: kw.get("with_ia_ok", False)),
        cycle=rec("cycle_relaxed", k.cycle,
                  lambda a, kw: kw.get("ia_ok") is not None))
    kassign.solve_rounds(dataclasses.replace(cfg, mode="fast"), dsnap,
                         *_sat_tables(dsnap), ops=ops)
    return calls


# Each fast pairwise entry point's plain version, by kernels-line name.
PLAIN_OF = {
    "waterfill": kassign.waterfill_plain,
    "excess_min": kassign.excess_min_plain,
    "excess_survive": kassign.excess_survive_plain,
    "ia_ok_at_choice": kpair.ia_ok_at_choice_plain,
    "pair_commit": kpair.pair_commit_plain,
    "node_add": kassign.node_add_plain,
    "desirability_fixed": kassign.desirability_plain,
    "pairwise_batch_ia_ok": kpair.pairwise_batch_plain,
    "cycle_relaxed": kassign.cycle_plain,
}


def _flat(out) -> list:
    if isinstance(out, kpair.PairState):
        return [out.counts, out.anti, out.match_tot]
    return list(out) if isinstance(out, tuple) else [out]


def index_add_library(used, node, mask, req, sign):
    """node_add's function as one `index_add_` (unordered adds), a
    yardstick only; a batch's tenants as one flat [B * N, R] table (the
    solo fast rounds run as a batch of one)."""
    N, R = used.shape[-2:]
    base = torch.arange(node.numel() // node.shape[-1],
                        device=node.device)[:, None] * N
    flat = (base + node.reshape(-1, node.shape[-1]).clamp(min=0)).reshape(-1)
    add = torch.where(mask[..., None], req * sign, 0.0).reshape(-1, R)
    return used.reshape(-1, R).clone().index_add_(0, flat.long(), add)


def fast_pair_kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """K12-K14 and the fast pairwise entry points of K5, K7, K8, K10 and
    K11 against their plain versions, on the arguments of their first
    call in a fast solve of the full-size pairwise cell, with times and
    bounds (bytes each input read once, each output written once; where
    a kernel gathers, only the entries it needs)."""
    calls = first_pair_round_calls(cfg, dsnap)
    out = {}
    P, N = dsnap.pods.valid.shape[0], dsnap.nodes.valid.shape[0]
    S = dsnap.sigs.key.shape[0]
    R = dsnap.nodes.allocatable.shape[1]
    IT = dsnap.pods.ia_sig.shape[1]
    for name, plain in PLAIN_OF.items():
        fn, a, kw = calls[name]
        got = _flat(fn(*a, **kw))
        want = _flat(plain(*a, **kw))
        err = require_equal(name, got, want)
        r = dict(err=err, ms=cuda_ms(lambda: fn(*a, **kw), 10),
                 plain_ms=cuda_ms(lambda: plain(*a, **kw), 3))
        if name == "waterfill":
            fill, ord_dom, dom_s, s_p, q, relaxed, cap, score, member, K1 = a
            b = nbytes(fill, ord_dom, dom_s, s_p, q, relaxed, cap, member,
                       *got) + 4 * P * K1
            r.update(bound=bound(b, 3 * P * N), shape=(
                f"P={P} N={N} S={S} K+1={K1}, {int(got[2].sum())} members "
                "dealt"))
        elif name == "excess_min":
            dom_s, counts, nvalid, aff_ok, s_c = a
            r.update(bound=bound(nbytes(*a, *got), 3 * P * N),
                     shape=f"P={P} N={N} S={S}")
        elif name == "excess_survive":
            r.update(bound=bound(nbytes(*a, *got), 4 * P),
                     shape=f"P={P}, {int(a[2].sum())} members, "
                           f"{int(got[0].sum())} bad")
        elif name == "ia_ok_at_choice":
            # Gathers: the member table's pod columns, the ia terms, and
            # counts/anti/dom at each pod's chosen node per signature.
            b = S * P + nbytes(*(getattr(a[0].pods, f) for f in (
                "ia_sig", "ia_valid", "ia_anti", "ia_required"))) \
                + 3 * 4 * S * P + nbytes(a[4], a[5], *got)
            r.update(bound=bound(b, (S + 10 * IT) * P),
                     shape=f"P={P} S={S} IT={IT}")
        elif name == "pair_commit":
            b = S * P + nbytes(a[4], a[5]) + 7 * P * IT + 2 * 4 * S * P
            r.update(bound=bound(b, (S + IT) * P),
                     shape=f"P={P} S={S}, {int(a[5].sum())} committed")
        elif name == "node_add":
            used, node, mask, req, rank, sign = a
            b = nbytes(node, mask, req, rank, used) + nbytes(*got)
            r.update(bound=bound(b, P * R), library="index_add_",
                     library_ms=cuda_ms(lambda: index_add_library(
                         used, node, mask, req, sign), 10),
                     prof_ms=profiler_ms(lambda: fn(*a, **kw),
                                         "node_add_kernel"),
                     shape=f"P={P} N={N} R={R}, {int(mask.sum())} reverted; "
                           + one_launch("node_add", lambda: fn(*a, **kw),
                                        "node_add_kernel"))
        elif name == "desirability_fixed":
            r.update(bound=bound(nbytes(*a, *got), 4 * P * N),
                     shape=f"P={P} N={N}")
        elif name == "pairwise_batch_ia_ok":
            snap_v, st, aff_ok, sig_match, dom_s = a
            pods = snap_v.pods
            C = pods.ts_sig.shape[-1]
            b = nbytes(aff_ok, snap_v.nodes.valid, dom_s, sig_match,
                       pods.ts_sig, pods.ts_valid, pods.ts_when,
                       pods.ts_max_skew, pods.ia_sig, pods.ia_valid,
                       pods.ia_anti, pods.ia_required, pods.ia_weight,
                       st.counts, st.anti, st.match_tot, *got)
            r.update(bound=bound(b, P * N * (C * 6 + IT * 10 + S * 3 + 14)),
                     shape=f"P={P} N={N} S={S} C={C} IT={IT}")
        elif name == "cycle_relaxed":
            b = nbytes(*a[:9], *kw["pair"], kw["w_ia"], kw["ia_ok"],
                       kw["pending"], *got)
            r.update(bound=bound(b, P * N * (R * 14 + 16)),
                     shape=f"P={P} N={N} R={R}")
        out[name] = r
    return out


def stage_breakdown(engine: Engine, snap) -> dict:
    """Device time of each stage of one parity solve (CUDA events), plus
    the host-clock transfers at both ends. With signatures the member
    label table (K1) and the signature match (K9) join the static stages
    and the pair state (K10) precedes the pairwise scan."""
    cfg = engine.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsnap = engine.put(snap)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    pairwise = dsnap.sigs.key.shape[0] > 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
    ev[0].record()
    node_sat_t, member_sat_t = _sat_tables(dsnap)
    ev[1].record()
    cells = kassign._tableau_cells(dsnap, dsnap.pods, dsnap.nodes, node_sat_t)
    ev[2].record()
    static = kassign.finalize_static(
        cfg, dsnap, kassign.WarmTableau(node_sat_t, member_sat_t, None,
                                        *cells))
    ev[3].record()
    if pairwise:
        static.sig_match = kpair.sig_match(
            member_sat_t, dsnap.sigs, kpair.merge_members(
                dsnap.running.namespace, dsnap.pods.namespace))
    ev[4].record()
    order = kassign.pop_order(cfg, dsnap)
    ev[5].record()
    if pairwise:
        dom_s = kpair.sig_domains(dsnap)
        st0 = kpair.pair_counts(static.sig_match, dom_s, dsnap.running,
                                dsnap.pods)
    ev[6].record()
    if pairwise:
        a, c, u, _ = kassign.parity_scan_pair(cfg, dsnap, static, order, st0,
                                              dom_s)
    else:
        a, c, u = kassign.parity_scan(cfg, dsnap, static, order)
    ev[7].record()
    P = a.shape[0]
    rank = torch.zeros(P, dtype=torch.int32, device=a.device)
    rank[order] = torch.arange(P, dtype=torch.int32, device=a.device)
    buf = _pack_solve((a, c, u, order, rank,
                       torch.full((), P, dtype=torch.int32, device=a.device),
                       torch.zeros(dsnap.running.valid.shape[0],
                                   dtype=torch.bool, device=a.device)))
    ev[8].record()
    t1 = time.perf_counter()
    buf.cpu()
    d2h_wait_ms = (time.perf_counter() - t1) * 1e3
    names = ("K1 atom_sat (+transpose)", "K2 tableau_cells",
             "K3 finalize_static (+QoS weights)", "K9 sig_match",
             "pop_order sort", "sig_domains + K10 pair_counts",
             "K4 parity_scan_pair" if pairwise else "K4 parity_scan",
             "rank + pack")
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)
              if pairwise or not n.startswith(("K9", "sig_domains"))}
    return {"h2d_ms_host": h2d_ms, **stages,
            "d2h_wait_ms_host": d2h_wait_ms}


def fast_breakdown(engine: Engine, snap) -> dict:
    """Device time of one fast solve (CUDA events around solve_core and
    around each round-loop stage and kernel call inside it), the host
    reads, and the host-clock transfers at both ends."""
    cfg = engine.config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dsnap = engine.put(snap)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    stats = kassign.RoundStats(timing=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t1 = time.perf_counter()
    ev[0].record()
    out = solve_core(cfg, dsnap, stats=stats)
    ev[1].record()
    buf = _pack_solve(out)
    ev[2].record()
    buf.cpu()
    host_ms = (time.perf_counter() - t1) * 1e3
    spans = stats.ms()
    n = stats.counts()
    # The dealing, once per K7 call, in three forms on the snapshot's
    # [P, R] requests and [N, R] capacity: K23, which the solve runs, its
    # plain version (the torch code it replaced) and torch.cumsum with
    # torch.searchsorted (f32 bits that depend on the device; timing
    # only).
    dem, rem = dsnap.pods.requests, dsnap.nodes.allocatable
    forms = {
        "K23 deal": lambda: kassign.deal(dem, rem),
        "plain deal (Hillis-Steele + searchsorted)":
            lambda: kassign.deal_plain(dem, rem),
        "torch.cumsum + searchsorted": lambda: deal_library(dem, rem),
    }
    prefix = {f"dealing per call, {k} (host clock)":
              host_clock_ms(f, 20) for k, f in forms.items()}
    total = ev[0].elapsed_time(ev[1])
    loops = sum(spans.get(k, 0.0) for k in (
        "round 1", "tranches", "direct rounds", "full-width rounds",
        "compacted rounds", "preemption rounds"))
    return {"h2d_ms_host": h2d_ms, "solve_core (device)": total,
            "K1-K3 + pop_order (rest of solve_core)": total - loops,
            **{f"{k} (x{n[k]})": v for k, v in spans.items()},
            "pack": ev[1].elapsed_time(ev[2]),
            "solve_core + pack + D2H (host clock)": host_ms,
            "host_reads": stats.host_reads, "rounds": int(out[5].item()),
            "K8 sub-steps (on the card)": stats.substeps(),
            **({"preemption rounds": stats.preempt_rounds,
                "preemption host reads": stats.preempt_reads}
               if cfg.preemption else {}),
            **prefix}


def check_launches(name: str, moved: dict, want: tuple[str, ...],
                   has_atoms: bool, calls: int = 1,
                   once: tuple[str, ...] = ONCE,
                   optional: tuple[str, ...] = OPTIONAL) -> None:
    """Each kernel of the path launched (K1 only with atoms to match;
    the `optional` ones may stay idle), no other kernel; the set-up
    kernels (`once`) once per entry-point call (K1 twice with
    signatures)."""
    k1_calls = 2 if "sig_match" in want else 1
    for k, n in moved.items():
        need = k in want and (k != "atom_sat" or has_atoms)
        most = (k1_calls * calls if k == "atom_sat"
                else calls if k in once else None)
        if ((need and n < 1 and k not in optional) or (not need and n)
                or (most and n > most)):
            raise AssertionError(f"{name}: kernel {k} launched {n} times "
                                 f"(launches {moved})")


def keep_fast_counts(name: str, cfg: EngineConfig, dsnap, res) -> str:
    """A fast cell of FAST_COUNTS places its recorded count of pods (the
    dealing and the tranche pick moved into kernels without changing a
    bit), and reads the host as often as recorded less the commit loop's
    reads, which K8 runs on the card: one a sub-step and one to end each
    round's loop, counted by a second solve through a recording K8 (which
    must read as often as the first)."""
    if name not in FAST_COUNTS:
        return ""
    steps = []

    def record(*a):
        out = kassign.prefix_commit_loop(*a)
        steps.append(out[2])
        return out

    stats = kassign.RoundStats()
    solve_core(cfg, dsnap, stats=stats, ops=dataclasses.replace(
        kassign.KERNELS, prefix_commit_loop=record))
    loop_reads = sum(int(t.max()) + 1 for t in steps)
    placed = int((res.assignment >= 0).sum())
    want_placed, want_reads = FAST_COUNTS[name]
    if (placed != want_placed or stats.host_reads != res.host_reads
            or res.host_reads + loop_reads != want_reads):
        raise AssertionError(
            f"fast {name}: placed {placed}, host reads {res.host_reads} "
            f"(again {stats.host_reads}) + {loop_reads} commit-loop reads; "
            f"recorded {FAST_COUNTS[name]}")
    return (f"; host reads {res.host_reads} = the recorded {want_reads} "
            f"less {loop_reads} commit-loop reads ({len(steps)} K8 launches, "
            f"{sum(int(t.sum()) for t in steps)} sub-steps)")


def solve_phase(label: str, requests, want: tuple[str, ...],
                once: tuple[str, ...] = ONCE) -> tuple:
    """Drive one main path: every counter zeroed just before, read just
    after; each request must launch each kernel of the path."""
    zero_counts()
    results = []
    for name, cfg, snap in requests:
        eng = Engine(cfg)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.solve(snap)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        eng.close()
        moved = {k: counts()[k] - v for k, v in before.items()}
        results.append((name, cfg, snap, res, wall_ms, moved))
    phase_counts = counts()
    for name, cfg, snap, res, wall_ms, moved in results:
        idle = (SEEDED_IDLE if cfg.tie_break == "seeded"
                else UNSEEDED_IDLE)
        check_launches(f"{label} {name}", moved, want,
                       snap.atoms.key.shape[0] > 0, once=once,
                       optional=OPTIONAL + idle)
    return results, phase_counts


def score_phase(cfg: EngineConfig, snap, smi: str) -> dict:
    """ScoreBatch through the engine (counters zeroed just before, read
    just after), then each result against its plain version."""
    zero_counts()
    eng = Engine(cfg)
    walls = {}
    t0 = time.perf_counter()
    sb = eng.score(snap)
    walls["score"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    best, mx, anyf, _ = eng.score_top1(snap)
    walls["score_top1"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    idx, val, _ = eng.score_topk(snap, 8)
    walls["score_topk(k=8)"] = (time.perf_counter() - t0) * 1e3
    phase_counts = counts()
    check_launches("ScoreBatch", phase_counts, SCORE_KERNELS,
                   snap.atoms.key.shape[0] > 0, calls=3)
    dsnap = eng.put(snap)
    plain = kassign.PLAIN
    f, sc = score_core(cfg, dsnap, ops=plain)
    pb, pm, pa = score_top1_core(cfg, dsnap, ops=plain)
    pi, pv = score_topk_core(cfg, dsnap, 8, ops=plain)
    checks = (("feasible", sb.feasible, f), ("scores", sb.scores, sc),
              ("top1 best", best, pb), ("top1 score", mx, pm),
              ("top1 feasible", anyf, pa), ("topk idx", idx, pi[:, :8]),
              ("topk val", val, pv[:, :8]))
    for field, got, want in checks:
        if not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError(f"ScoreBatch {field} differs from its "
                                 "plain version on the same CUDA tensors")
    P, N = sb.feasible.shape
    if not (np.isfinite(sb.scores).all() and (best[anyf] < N).all()
            and (best[~anyf] == -1).all()):
        raise AssertionError("ScoreBatch: non-finite score or bad index")
    eng.close()
    log(f"ScoreBatch on (b) [{P}x{N}]: {int(sb.feasible.sum())} feasible "
        f"cells, {int(anyf.sum())} pods with a feasible node; walls (ms, "
        "first call each) " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        walls.items())
        + f"; launches {phase_counts}; equal to the plain versions; {smi}")
    return phase_counts


def pair_score_phase(requests, smi: str) -> dict:
    """Pairwise ScoreBatch through the engine (counters zeroed just
    before, read just after): (label, cfg, snap, forms) requests, each
    form "top1" or "topk8"; then each result against its plain version
    on the same CUDA tensors."""
    zero_counts()
    results = []
    for label, cfg, snap, forms in requests:
        eng = Engine(cfg)
        for form in forms:
            t0 = time.perf_counter()
            if form == "top1":
                got = eng.score_top1(snap)[:3]
            else:
                got = eng.score_topk(snap, 8)[:2]
            results.append((label, cfg, eng.put(snap), form, got,
                            (time.perf_counter() - t0) * 1e3))
        eng.close()
    phase_counts = counts()
    check_launches("pairwise ScoreBatch", phase_counts, PAIR_SCORE_KERNELS,
                   True, calls=len(results))
    plain = kassign.PLAIN
    for label, cfg, dsnap, form, got, wall in results:
        if form == "top1":
            want = score_top1_core(cfg, dsnap, ops=plain)
        else:
            want = tuple(t[:, :8] for t in score_topk_core(cfg, dsnap, 8,
                                                           ops=plain))
        for g, w in zip(got, want):
            if not np.array_equal(g, w.cpu().numpy()):
                raise AssertionError(f"pairwise ScoreBatch {label} {form} "
                                     "differs from its plain version")
        extra = (f"{int(got[2].sum())} pods with a feasible node"
                 if form == "top1" else
                 f"{int((got[0] >= 0).sum())} feasible (pod, rank) slots")
        log(f"pairwise ScoreBatch {label} {form}: {wall:.3f} ms wall "
            f"(first call), {extra}, equal to the plain version; {smi}")
    log(f"pairwise ScoreBatch launches {phase_counts}")
    return phase_counts


def with_recorded(fn, module, attr: str, keep: int | None = None):
    """Run fn() with module.attr wrapped to record its calls' arguments
    (cloned tensors) and outputs, the first `keep` of them (all when
    None); returns (fn's result, [(args, out)])."""
    orig = getattr(module, attr)
    calls = []

    def rec(*args, **kw):
        out = orig(*args, **kw)
        if keep is None or len(calls) < keep:
            calls.append((tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args), out))
        return out

    setattr(module, attr, rec)
    try:
        return fn(), calls
    finally:
        setattr(module, attr, orig)


def gang_phase(cells, label: str, want: tuple[str, ...], smi: str) -> dict:
    """Gang cells through the engine (counters zeroed just before, read
    just after), then the audit, equality with the plain solve and the
    gang audit on the plain solve's rolled-back set."""
    results, phase_counts = solve_phase(label, cells, want)
    for name, cfg, snap, res, wall_ms, moved in results:
        dsnap = Engine(cfg).put(snap)
        info, calls = with_recorded(lambda: audit(name, cfg, dsnap, res),
                                    kassign, "gang_rollback")
        info.update(gang_audit(name, dsnap, res, calls[0][1][4].cpu().numpy()))
        log(f"{label} solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, audit "
            f"clean, equal to the plain solve ({info['plain_solve_ms']:.1f} "
            f"ms); gang audit clean: {info['groups_placed']} of "
            f"{info['groups']} groups placed, {info['rolled_groups']} groups "
            f"({info['rolled_pods']} pods) rolled back; {smi}")
        if name.startswith("g") and info["rolled_groups"] < 1:
            raise AssertionError(f"{label} {name}: no group rolled back")
    return phase_counts


def preempt_kernel_phase(cfg: EngineConfig, dsnap, plain_scan,
                         steps) -> dict:
    """K4's preemption variant against the (h) audit's plain scan (run
    once), without and with its explain outputs (evictor, evict_pos),
    and K15 against its plain version on the scan's state at (h)'s first
    preemptors (the plain scan's first preempt_step_plain calls),
    exactly, with the chosen prefix's freed row and victims equal to the
    plain tableau's (at least one PDB violation among the tableaus);
    times and bounds."""
    out = {}
    nodes, pods = dsnap.nodes, dsnap.pods
    args4, want6, plain_ms = plain_scan
    got4 = kassign.parity_scan_preempt(*args4)
    err = require_equal("parity_scan_preempt", got4, want6[:4])
    got6 = kassign.parity_scan_preempt(*args4, explain=True)
    err_x = require_equal("parity_scan_preempt (explain)", got6, want6)
    if not (got6[3].any() and torch.equal(got6[4] >= 0, got6[3])):
        raise AssertionError("K4 explain: the evictors do not cover the "
                             "evictions")
    _, _, static, order, pctx = args4
    P, N = static.mask.shape
    M, R = pctx.req_s.shape
    # The victim table once (K15 reads each victim from the planes or the
    # sorted order, not both) and the node offsets.
    vic_bytes = nbytes(pctx.perm, pctx.cost_s, pctx.vprio_s, pctx.req_s,
                       pctx.pdb_s, pctx.off)
    placed = got4[0] >= 0
    searches = int((placed & torch.isinf(got4[1])).sum()
                   + (pods.valid & (pods.group < 0) & ~placed).sum())
    b4 = nbytes(static.mask, static.score, nodes.allocatable, nodes.used,
                pods.requests, static.w_lr, static.w_ba, static.w_ts,
                static.w_ia, static.rw, *got4) + 4 * P + vic_bytes
    ops4 = P * N * (R * 14 + 12) + searches * M * (3 * R + 12)
    scan_ms = cuda_ms(lambda: kassign.parity_scan_preempt(*args4), 3)
    no_pre_ms = cuda_ms(lambda: kassign.parity_scan(cfg, dsnap, static,
                                                    order), 3)
    shape = (f"P={P} N={N} R={R} M={M}, {searches} K15 searches, "
             f"{int(got4[3].sum())} evicted")
    out["parity_scan_preempt"] = dict(
        err=err, ms=scan_ms, plain_ms=plain_ms, bound=bound(b4, ops4),
        shape=f"{shape}; K4 without preemption on the same inputs "
              f"{no_pre_ms:.3f} ms, so "
              f"{(scan_ms - no_pre_ms) * 1e3 / max(searches, 1):.2f} us a "
              "search inside the scan")
    # The plain scan computes the evictors in every call, so one plain
    # time serves both rows.
    out["parity_scan_preempt_explain"] = dict(
        err=err_x, plain_ms=plain_ms,
        ms=cuda_ms(lambda: kassign.parity_scan_preempt(*args4, explain=True),
                   3),
        bound=bound(b4 + nbytes(*got6[4:]), ops4),
        shape=f"{shape}; without the explain outputs {scan_ms:.3f} ms")
    errs, viols, need_b, need_ops, visit = 0.0, 0, 0, 0, 0
    for a, _ in steps:
        got = kpre.preempt_step(*a)
        errs = max(errs, require_equal("preempt_step", got,
                                       kpre.preempt_step_plain(*a)))
        want, v, need = k15_from_tableau(*a)
        require_equal("preempt_step against the plain tableau", got, want)
        viols += v
        need_b += need[0]
        need_ops += need[1]
        visit += need[2]
    if viols < 1:
        raise AssertionError("K15: no victim is a PDB violation at (h)'s "
                             "first preemptors")
    # The bytes and operations each search needs (k15_from_tableau), a
    # mean over the k searches.
    k = len(steps)
    b15 = need_b / k
    out["preempt_step"] = dict(
        err=errs,
        ms=cuda_ms(lambda: [kpre.preempt_step(*a) for a, _ in steps], 5) / k,
        plain_ms=cuda_ms(lambda: [kpre.preempt_step_plain(*a)
                                  for a, _ in steps], 2) / k,
        bound=bound(b15, need_ops / k),
        shape=f"M={M} N={N} R={R} V={pctx.pl_vic.shape[0]} "
              f"GP={dsnap.pdb_allowed.shape[0]}, {k} preemptor states, "
              f"{viols} PDB-violating victims in their tableaus, "
              f"{visit / k:.0f} victims and {b15:.0f} bytes a search "
              "to read, "
              f"{sum(int(o[1]) for _, o in steps)} found a prefix")
    return out


def k15_from_tableau(cfg, snap, ctx, prio, req, allowed, used, evicted):
    """K15's outputs (best node, can, evict_m, freed) read off the plain
    tableau (`tableau_plain`): the lexicographic minimum of (violations,
    cost, position) over the fitting prefixes on allowed, valid nodes,
    its eligible victims and its segment sum of their requests; with the
    tableau's PDB-violating victims and what a search must read: (bytes,
    operations, victims). A node-major walk that knew the pick would
    still read each allowed, valid node's victims up to its first prefix
    that fits or ranks at or after the pick (its whole segment where
    none does): the evicted flag and priority of each (5 bytes), the
    cost, budget and R requests of the eligible ones; each allowed,
    valid node's usage and allocatable rows and offsets; every node's
    allowed and valid flags. Operations: 3 a victim, 3R + 12 more an
    eligible one."""
    N, R = used.shape
    M = ctx.perm.shape[0]
    elig, within, wviol, fits, viol = kpre.tableau_plain(
        cfg, snap, ctx, prio, req, used, evicted,
        kpre.pdb_remaining(snap, evicted))
    node = ctx.node_s.clamp(max=N - 1).long()
    ok = (ctx.node_s < N) & allowed[node] & snap.nodes.valid[node]
    ok_nodes = int((allowed & snap.nodes.valid).sum())
    cand = fits & ok
    idx = torch.arange(M, device=used.device)
    seg = ctx.seg_start.long()
    big = torch.iinfo(torch.int32).max
    found = bool(cand.any())
    stop = cand
    if found:
        minv = torch.where(cand, wviol, big).amin()
        cost = torch.where(cand & (wviol == minv), within[:, R],
                           float("inf"))
        pos = int(torch.nonzero(cost == cost.amin())[0, 0])
        bc = within[pos, R]
        stop = stop | (elig & ok & ((wviol > minv)
                                    | ((wviol == minv) & (within[:, R]
                                                          >= bc))))
    first = torch.full((N,), M, dtype=torch.int64, device=used.device)
    first.scatter_reduce_(0, node[stop], idx[stop], "amin")
    read = ok & (idx <= first[node])
    n_read, n_elig = int(read.sum()), int((read & elig).sum())
    need = (5 * n_read + 4 * (R + 2) * n_elig
            + ok_nodes * (8 * R + 8) + 2 * N,
            3 * n_read + (3 * R + 12) * n_elig, n_read)
    evict_m = torch.zeros(M, dtype=torch.bool, device=used.device)
    if not found:
        return ((torch.zeros((), dtype=torch.int32, device=used.device),
                 torch.zeros((), dtype=torch.bool, device=used.device),
                 evict_m, torch.zeros(R, device=used.device)),
                int(viol.sum()), need)
    sel = elig & (idx >= seg[pos]) & (idx <= pos)
    evict_m[ctx.perm[sel].long()] = True
    return ((ctx.node_s[pos], torch.ones((), dtype=torch.bool,
                                         device=used.device),
             evict_m, within[pos, :R]), int(viol.sum()), need)


def pair_preempt_kernel_phase(cfg: EngineConfig, dsnap) -> dict:
    """K4's pairwise preemption variant against its plain version (timed
    once) on (h) with spread and inter-pod terms, exactly in all five
    outputs; the final pair state also equals K10's recount at the
    assignment less the evicted members."""
    nodes, pods = dsnap.nodes, dsnap.pods
    static = kassign.precompute_static(cfg, dsnap, *_sat_tables(dsnap))
    dom_s = kpair.sig_domains(dsnap)
    st = kpair.pair_counts(static.sig_match, dom_s, dsnap.running, pods)
    order = kassign.pop_order(cfg, dsnap)
    pctx = kpre.precompute(cfg, dsnap)
    args = (cfg, dsnap, static, order, st, dom_s, pctx)
    got = kassign.parity_scan_pair_preempt(*args)
    t0 = time.perf_counter()
    want = kassign.parity_scan_pair_preempt_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    flat = lambda r: [r[0], r[1], r[2], *_flat(r[3]), r[4]]
    err = require_equal("parity_scan_pair_preempt", flat(got), flat(want))
    rec = kpair.pair_counts(static.sig_match, dom_s, dsnap.running, pods,
                            assigned=got[0])
    left = kpair.pair_state_evict(dsnap, rec, static.sig_match, dom_s, got[4])
    require_equal("parity_scan_pair_preempt state", _flat(got[3]),
                  _flat(left))
    P, N = static.mask.shape
    M, R = pctx.req_s.shape
    S, C = dom_s.shape[0], pods.ts_sig.shape[1]
    IT = pods.ia_sig.shape[1]
    b = nbytes(static.mask, static.score, static.aff_ok, nodes.allocatable,
               nodes.used, pods.requests, static.w_lr, static.w_ba,
               static.w_ts, static.w_ia, static.rw, dom_s, static.sig_match,
               st.counts, st.anti, st.match_tot, pctx.perm, pctx.off,
               pctx.cost_s, pctx.vprio_s, pctx.req_s,
               pctx.pdb_s, *flat(got)) + 4 * P
    return {"parity_scan_pair_preempt": dict(
        err=err, ms=cuda_ms(lambda: kassign.parity_scan_pair_preempt(*args),
                            3),
        plain_ms=plain_ms,
        bound=bound(b, P * N * (R * 14 + 12 + C * 6 + IT * 10 + S * 3 + 14)),
        shape=f"P={P} N={N} R={R} M={M} S={S} C={C} IT={IT}, placed "
              f"{int((got[0] >= 0).sum())}, evicted {int(got[4].sum())}")}


def preempt_phase(snap_h, snap_hp, smi: str) -> tuple[dict, dict]:
    """Cell (h) through the engine with preemption (counters zeroed just
    before, read just after), the audit, equality with the plain solve
    (run once, its scan recorded with the states at its first
    preemptors) and the preemption audit; then the kernel phase of K4's
    preemption variants and K15. Returns (the phase's launch counts, the
    kernel rows)."""
    cfg = EngineConfig(mode="parity", preemption=True)
    pre, phase_counts = solve_phase(
        "preemption parity",
        (("h: config5 10000x5000 at 90% tight, 30% of running pods under "
          "PDBs, preemption on", cfg, snap_h),), PREEMPT_KERNELS)
    name, _, _, res, wall_ms, moved = pre[0]
    eng = Engine(cfg)
    dsnap = eng.put(snap_h)
    info, steps = with_recorded(lambda: audit(name, cfg, dsnap, res), kpre,
                                "preempt_step_plain", keep=K15_STATES)
    info.update(preempt_audit(name, dsnap, res))
    if info["evicted"] < 1:
        raise AssertionError(f"{name}: no victim evicted")
    log(f"preemption parity solve {name}: {wall_ms:.3f} ms wall, placed "
        f"{info['placed']}/{info['valid_pods']}, {info['preempted']} by "
        f"preemption, {info['searches']} K15 searches in the scan, "
        f"{info['evicted']} victims evicted, launches {moved}, audit clean, "
        f"equal to the plain solve in assignment, chosen, used and evicted "
        f"(plain scan {info['plain_preempt_scan'][2]:.1f} ms), preemption "
        f"audit clean; {smi}")
    kp = preempt_kernel_phase(cfg, dsnap, info["plain_preempt_scan"], steps)
    kp.update(pair_preempt_kernel_phase(cfg, eng.put(snap_hp)))
    eng.close()
    for kname, r in kp.items():
        log(f"kernel {kname} [{r['shape']}]: exact match, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); {smi}")
    return phase_counts, kp


def profiler_ms(fn, kernel: str, reps: int = 5) -> float | None:
    """The device time of the CUDA kernels whose name holds `kernel`,
    per fn() call, from a torch.profiler trace of `reps` calls (after a
    warm-up); None when the trace holds no such kernel. A trace of a
    few microsecond-long kernels can come back without their events, so
    a miss is traced once more, with host activity and 4 x the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for acts, n in (([ProfilerActivity.CUDA], reps),
                    ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     4 * reps)):
        with profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if kernel in e.key:
                total += getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0))
        if total > 0:
            return total / 1e3 / n
    return None


def one_launch(name: str, fn, kernel: str, reps: int = 5) -> str:
    """Require that fn() runs one CUDA kernel, `kernel`, and nothing else
    on the card (no sort, no copy): the device events of a profiler trace
    of `reps` calls (a trace that comes back without device events is
    taken once more with host activity and 4 x the calls, as in
    profiler_ms). Returns what the trace showed, for the log; "not
    measured" where it holds no device event at all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for acts, n in (([ProfilerActivity.CUDA], reps),
                    ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     4 * reps)):
        with profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        other = sorted({x for x in names if kernel not in x})
        if other:
            raise AssertionError(f"{name}: {n} calls ran {other} beside "
                                 f"{kernel}")
        if names:
            return f"{len(names)} device events over {n} calls, all {kernel}"
    return "launches a call not measured (no device event traced)"


def first_auction_calls(cfg: EngineConfig, dsnap) -> dict:
    """The arguments of the first call of each auction kernel (K16, K17's
    two entry points, K6 at K = 256, K18) in a fast preemption solve of
    `dsnap`: its first auction round, by kernels-line name."""
    calls = {}

    def rec(name, fn, want=lambda a: True):
        def wrapped(*a):
            if name not in calls and want(a):
                calls[name] = (fn, tuple(x.clone() if isinstance(
                    x, torch.Tensor) else x for x in a))
            return fn(*a)
        return wrapped

    k = kassign.KERNELS
    ops = dataclasses.replace(
        k, auction_ok=rec("auction_ok", k.auction_ok),
        auction_tables=rec("auction_tables", k.auction_tables),
        auction_rank=rec("auction_rank", k.auction_rank),
        row_topk=rec("row_topk_radix", k.row_topk, lambda a: a[1] > 16),
        auction_claim=rec("auction_claim", k.auction_claim))
    solve_core(cfg, dsnap, ops=ops)
    return calls


AUCTION_PLAIN = {
    "auction_tables": kpre.auction_tables_plain,
    "auction_ok": kpre.auction_ok_plain,
    "auction_rank": kpre.auction_rank_plain,
    "row_topk_radix": kassign.row_topk_plain,
    "auction_claim": kpre.auction_claim_plain,
}
# K18's cluster sizes held against its plain version and timed.
CLAIM_SWEEP = (1, 4, 8, 16)
# The CUDA kernel of each auction row, for the profiler's kernel times.
AUCTION_CUDA_NAME = {
    "auction_tables": "auction_tables_kernel",
    "auction_ok": "auction_ok_kernel",
    "auction_rank": "auction_rank_kernel",
    "row_topk_radix": "row_topk_radix_kernel",
    "auction_claim": "auction_claim_kernel",
}


def topk_tie_rows(dev, N: int, K: int) -> str:
    """K6's radix path against row_topk_plain, exactly, on rows that
    stress its ties at width N and at N - 37 (not a multiple of 256),
    for K and the whole row: all -inf, all equal, -0.0 and +0.0 mixed
    (with -inf), a few values so that the K-th lies in a wide tie, and
    bid-like rows (negated integer costs, -inf half the time); solo
    [rows, N] and as a [B, C, N] batch."""
    g = torch.Generator(device="cpu").manual_seed(N)
    checked = 0
    for n in (N, N - 37):
        rows = [torch.full((n,), float("-inf")), torch.full((n,), -7.0),
                torch.where(torch.rand(n, generator=g) < 0.5,
                            torch.tensor(-0.0), torch.tensor(0.0)),
                torch.where(torch.rand(n, generator=g) < 0.2,
                            torch.tensor(float("-inf")),
                            torch.where(torch.rand(n, generator=g) < 0.5,
                                        torch.tensor(-0.0),
                                        torch.tensor(0.0))),
                -torch.randint(1, 4, (n,), generator=g).to(torch.float32)]
        bids = -torch.randint(1, 50, (11, n), generator=g).to(torch.float32)
        bids[torch.rand(11, n, generator=g) < 0.5] = float("-inf")
        block = torch.cat([torch.stack(rows), bids]).to(dev)
        for k in (min(K, n), n):
            for m in (block, block.reshape(2, 8, n)):
                require_equal(f"row_topk radix path, tie rows N={n} K={k}",
                              _flat(kassign.row_topk_path(m, k, radix=True)),
                              _flat(kassign.row_topk_plain(m, k)))
                checked += 1
    return f"{checked} tie blocks exact (N={N}, {N - 37}; K={K} and N)"


def tableau_nv_bound(calls: dict) -> tuple[float, str]:
    """The bound of JAX's `_tableau_nv` (preempt.py:169; the port keeps
    it as plain torch, no product path runs it) at the shapes of this
    auction round's bidders: the [N, V] victim table, the bidders'
    priorities and requests, used and allocatable read once, its [C, N,
    V] outputs (elig, wcost, wviol, fits: 10 bytes a cell) and [C, N]
    minima written once; per cell the eligibility, R + 1 prefix adds,
    3R fit operations, the V-long same-budget count and the two minima."""
    ctx, ev = calls["auction_tables"][1][:2]
    C = calls["auction_rank"][1][3].shape[-1]
    N, V, R = ctx.vreq.shape[-3:]
    B = ev.numel() // ev.shape[-1]
    b = nbytes(ctx.vreq, ctx.vcost, ctx.vprio, ctx.vpdb, ctx.vvalid,
               ctx.vidx, ev) + B * (C * (R + 1) * 4 + 2 * N * R * 4
                                    + C * N * V * 10 + C * N * 8)
    return bound(b, B * C * N * V * (4 * R + V + 7))


def auction_kernel_phase(dsnap, calls: dict) -> dict:
    """K16, K17 (both entry points), K6 at K = 256 and K18 against their
    plain versions on the arguments of their first call (exact), with
    CUDA-event and profiler times and bounds (bytes each input read once,
    each output written once; the tables K17 and K18 gather, only the
    rows they read). A tenant batch's calls carry a leading [B] axis; the
    bounds then count all B tenants' work."""
    out = {}
    for name, plain in AUCTION_PLAIN.items():
        fn, a = calls[name]
        got = _flat(fn(*a))
        err = require_equal(name, got, _flat(plain(*a)))
        r = dict(err=err, ms=cuda_ms(lambda: fn(*a), 20),
                 prof_ms=profiler_ms(lambda: fn(*a), AUCTION_CUDA_NAME[name]),
                 plain_ms=cuda_ms(lambda: plain(*a), 3))
        if name == "auction_tables":
            ctx, ev, thr, rem, _ = a
            L = thr.shape[-1]
            N, V, R = ctx.vreq.shape[-3:]
            B = ev.numel() // ev.shape[-1]
            # Every lane reads the same victim rows: the table once.
            b = nbytes(ctx.vreq, ctx.vcost, ctx.vprio, ctx.vpdb, ctx.vvalid,
                       ctx.vidx) + B * N * V + nbytes(thr, rem, *got)
            r.update(bound=bound(b, B * L * N * V * (2 * R + V + 8)),
                     shape=f"B={B} L={L} N={N} V={V} R={R}")
        elif name == "auction_ok":
            mask, rows, pair_ok, pre, nvalid = a
            C, N = got[0].shape[-2:]
            B = pre.numel() // C
            b = B * C * N * (2 if pair_ok is not None else 1) + nbytes(
                pre, nvalid, *got) + (4 * B * C if rows is not None else 0)
            r.update(bound=bound(b, 4 * B * C * N),
                     shape=f"B={B} C={C} N={N}, {int(got[1].sum())} active")
        elif name == "auction_rank":
            cum_req, cum_cost, cum_viol, lane, ok, used, alloc, p_req = a
            L, N, V, R = cum_req.shape[-4:]
            C = lane.shape[-1]
            B = lane.numel() // C
            b = nbytes(*a, *got)
            steps = max(1, V.bit_length())
            r.update(bound=bound(b, B * C * N * (2 * R * (steps + 3) + 8)),
                     shape=f"B={B} C={C} N={N} L={L} V={V} R={R}, "
                           f"{int(torch.isfinite(got[0]).sum())} bids")
        elif name == "row_topk_radix":
            masked, K = a[0], a[1]
            N = masked.shape[-1]
            rows = masked.numel() // N
            # The K-pass kernel on the same rows (K6's path before the
            # radix select), and the tie rows.
            kpass = lambda: kassign.row_topk_path(masked, K, radix=False)
            require_equal("row_topk_radix (K-pass kernel)", _flat(kpass()),
                          got)
            ties = topk_tie_rows(masked.device, N, K)
            r.update(bound=bound(nbytes(masked, *got[:2]), rows * N),
                     library="torch.topk",
                     library_ms=cuda_ms(lambda: torch.topk(masked, K, dim=-1),
                                        20),
                     kpass_ms=cuda_ms(kpass, 5),
                     kpass_prof_ms=profiler_ms(kpass, "row_topk_kernel"),
                     shape=f"{rows} rows, N={N} K={K}; {ties}")
        elif name == "auction_claim":
            topv, topi, can_plain, n_plain, rank, ctx = a[:6]
            p_prio, p_req, could = a[7], a[8], a[11]
            iters = kpre.CLAIM_ITERS
            C, K = topi.shape[-2:]
            N, V, R = ctx.vreq.shape[-3:]
            B = can_plain.numel() // C
            # K18 at every cluster size of CLAIM_SWEEP, each exact.
            want = _flat(plain(*a))
            sweep = {}
            for Q in CLAIM_SWEEP:
                fq = lambda: fn(*a, cluster=Q)  # noqa: E731
                require_equal(f"auction_claim (Q={Q})", _flat(fq()), want)
                sweep[f"B={B} Q={Q}"] = {
                    "ms": cuda_ms(fq, 20),
                    "prof_ms": profiler_ms(fq, AUCTION_CUDA_NAME[name])}
            policy = kpre.claim_cluster_size(
                B, C, torch.cuda.get_device_properties(0)
                .multi_processor_count)
            r["extra"] = {"clusters": sweep}
            log(f"K18 by cluster size (B={B} C={C} K={K} N={N}; the "
                f"policy's Q={policy[0]} of {policy[1]} threads), each "
                "exact: " + ", ".join(
                    f"Q={k.split('Q=')[1]} {v['ms']:.4f} ms (profiler "
                    + ("not measured" if v["prof_ms"] is None
                       else f"{v['prof_ms']:.4f} ms") + ")"
                    for k, v in sweep.items()))
            row = ctx.vreq[..., 0, :, :].numel() // B * 4 + V * (
                4 + 4 + 1 + 4 + 1)
            b = nbytes(topv, topi, can_plain, n_plain, rank, p_prio, p_req,
                       could, *got) + B * C * (row + 2 * R * 4)
            r.update(bound=bound(b, B * (iters * C * K * 3
                                         + C * V * (R + 4))),
                     shape=f"B={B} C={C} K={K} N={N} V={V} iters={iters}, "
                           f"{int(got[1].sum())} claimed, "
                           f"{int(got[2].sum())} to evict")
        out[name] = r
    return out


def fast_preempt_phase(snap_h, snap_hp, smi: str) -> tuple[dict, dict]:
    """Fast mode with preemption on (h) and on (h) with spread and
    inter-pod terms, each through the engine (counters zeroed just before,
    read just after), then 5 steady solves (median), the audit with
    equality to the plain solve (host reads too) and the commit-key audit
    in both eviction arms, the preemption audit, a stage breakdown; then
    the auction kernels against their plain versions on the arguments of
    each cell's first auction round. Returns (the phases' launch counts,
    the kernel rows of (h))."""
    cfg = EngineConfig(mode="fast", preemption=True)
    cells = (
        ("h fast: config5 10000x5000, preemption on", snap_h,
         FAST_PREEMPT_KERNELS, ONCE),
        ("h fast + spread/inter-pod terms", snap_hp,
         FAST_PREEMPT_PAIR_KERNELS, FAST_PAIR_ONCE))
    launches, rows = {}, {}
    for name, snap, want, once in cells:
        pair = snap.sigs.key.shape[0] > 0
        results, phase_counts = solve_phase(
            "fast preemption", ((name, cfg, snap),), want, once=once)
        for k, v in phase_counts.items():
            launches[k] = launches.get(k, 0) + v
        _, _, _, res, wall_ms, moved = results[0]
        eng = Engine(cfg)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.solve(snap)
            walls.append((time.perf_counter() - t0) * 1e3)
        bd = fast_breakdown(eng, snap)
        dsnap = eng.put(snap)
        eng.close()
        counts = keep_fast_counts(name.split(":")[0], cfg, dsnap, res)
        claims = []

        def hook(ops):
            def rec(*a):
                out = ops.auction_claim(*a)
                claims.append(out[0].clone())
                return out
            return dataclasses.replace(ops, auction_claim=rec)

        info, evs = with_recorded(
            lambda: audit(name, cfg, dsnap, res, hook=hook), kassign,
            "_evict_round")
        per_round = [(a[0], a[2], t, out) for (a, out), t in zip(evs, claims)]
        info.update(preempt_audit(name, dsnap, res,
                                  per_round if pair else None))
        if info["evicted"] < 1:
            raise AssertionError(f"{name}: no victim evicted")
        extra = (f", pairwise audit clean (S={info['signatures']}, "
                 f"{info['anti_holders']} placed required-anti holders), "
                 f"commit-key audit clean in both eviction arms "
                 f"({info['commit_key_checked']} pods over {info['keys']} "
                 f"keys; {info['one_arm_only']} checks fail in one arm "
                 f"only), {info['stranded']} stranded victims (their "
                 "preemptor reverted by the round's validation)"
                 if pair else ", capacity holds with the evictions applied")
        log(f"fast preemption solve {name}: {wall_ms:.3f} ms wall (first "
            f"request), steady median of 5 {statistics.median(walls):.3f} "
            f"ms; placed {info['placed']}/{info['valid_pods']}, "
            f"{info['preempted']} by preemption, {info['evicted']} victims "
            f"evicted; rounds {res.rounds} of which preemption "
            f"{bd['preemption rounds']}, host reads {res.host_reads} of "
            f"which preemption {bd['preemption host reads']}{counts}; "
            f"launches "
            f"{moved}; audit clean, equal to the plain solve in assignment, "
            f"order, chosen, commit key, used, evicted, rounds and host "
            f"reads (plain solve {info['plain_solve_ms']:.1f} ms); "
            f"preemption audit clean{extra}; {smi}")
        log(f"steady fast preemption solve {name}: stages (ms): " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in bd.items()) + f"; {smi}")
        calls = first_auction_calls(cfg, dsnap)
        kp = auction_kernel_phase(dsnap, calls)
        where = f"{name.split(':')[0]}'s first auction round"
        log_rows(kp, where, smi)
        nv = tableau_nv_bound(calls)
        log(f"bound of _tableau_nv (plain torch, no kernel) on {where}: "
            f"{nv[0]:.5f} ms ({nv[1]}); {smi}")
        if not rows:
            rows = kp
        else:
            for kname, r in kp.items():
                rows[kname]["err"] = max(rows[kname]["err"], r["err"])
    return launches, rows


def timed(fn):
    """(fn(), host-clock ms), synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_result(name: str, got, want,
                fields=("assignment", "chosen_score", "evicted")) -> None:
    for f in fields:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{name}: {f} differs")


def value_churn(ds, pods_r: list, rng, k: int):
    """bench_warm's value churn: k pods' observed availability redrawn,
    one apply."""
    picks = rng.choice(len(pods_r), size=k, replace=False)
    ups = []
    for i in picks:
        rec = pods_r[int(i)]
        rec["observed_avail"] = float(rng.uniform(0.3, 1.0))
        ups.append(rec)
    return ds.apply(upsert_pods=ups)


def warm_phase(smi: str) -> tuple[dict, dict]:
    """The warm lineage (w) through the engine's warm entry points, every
    counter zeroed just before and read just after: a cold solve, the
    cold rung (the tableau's build), value churn at 0.1 / 1 / 10 % of the
    pods (each warm result equal to a cold solve of the same state, the
    first also to the plain-version solve), warm_churn_stream cycles
    (reorders, completions, cordon toggles), incremental cycles at 1 %
    (audit tail zero, validity, carried and frontier counts), one parity
    warm cycle. Then K19 and K20 against their plain versions on the
    first incremental cycle's inputs. Returns (the launch counts, the
    kernel rows)."""
    cfg = EngineConfig(mode="fast")
    t_phase = t0 = time.perf_counter()
    nodes_r, pods_r, running_r = (list(x) for x in make_cluster(
        np.random.default_rng(WARM_SEED), PODS, NODES, n_running_per_node=1,
        with_qos=True, as_records=True))
    t_rec = time.perf_counter() - t0
    ds = DeviceSnapshot(cfg)
    st, load_ms = timed(lambda: ds.full_load(nodes_r, pods_r, running_r))
    bk = ds.meta.buckets
    full = ds.full_bytes
    log(f"warm lineage (w): records {t_rec:.3f} s, full_load {load_ms:.1f} "
        f"ms host clock, buckets P={bk.pods} N={bk.nodes} "
        f"M={bk.running_pods}, full upload {full} bytes; {smi}")
    eng = Engine(cfg)
    zero_counts()
    cold0, cold_ms = timed(lambda: eng.solve(ds.snap))
    first, first_ms = timed(lambda: eng.solve_warm(ds))
    same_result("w cold rung vs cold solve", first, cold0)
    tab_bytes = sum(nbytes(t) for t in ds.warm_state.tableau.leaves()
                    if t is not None)
    log(f"warm (w): cold solve {cold_ms:.3f} ms, cold rung (tableau build) "
        f"{first_ms:.3f} ms, equal; tableau {tab_bytes} bytes on the "
        f"device; host reads {first.host_reads}; {smi}")
    P = len(pods_r)
    plain_checked = False
    for frac in WARM_FRACS:
        k = max(1, int(round(frac * P)))
        rng = np.random.default_rng(int(frac * 1e6) + 17)
        walls, colds, reads, sent, solve_sent, books = [], [], [], [], [], []
        for cyc in range(WARM_CYCLES):
            stats = value_churn(ds, pods_r, rng, k)
            # The lineage's host bookkeeping alone (warm_delta is pure):
            # name maps over every row, the pressure compare.
            _, book_ms = timed(ds.warm_delta)
            # Each pair runs in turns: warm first on even cycles, cold
            # first on odd ones.
            if cyc % 2:
                cold, cms = timed(lambda: eng.solve(ds.snap))
            res, ms = timed(lambda: eng.solve_warm(ds))
            if not cyc % 2:
                cold, cms = timed(lambda: eng.solve(ds.snap))
            same_result(f"w warm {frac:g} cycle {cyc} vs cold", res, cold)
            if not plain_checked:
                plain = plain_result(cfg, ds.snap)
                same_result("w warm vs the plain-version solve", res, plain)
                plain_checked = True
            walls.append(ms)
            colds.append(cms)
            reads.append(res.host_reads)
            sent.append(stats.h2d_bytes)
            solve_sent.append(res.h2d_bytes)
            books.append(book_ms)
        log(f"warm (w) value churn {frac:g} ({k} pods a cycle, dirty rows "
            f"{ds.last_warm_rows}): warm walls {[round(w, 3) for w in walls]}"
            f" ms, p50 {statistics.median(walls):.3f}; cold walls "
            f"{[round(w, 3) for w in colds]} ms, p50 {statistics.median(colds):.3f}; each "
            f"warm equal to its cold solve, warm under cold in "
            f"{sum(w < c for w, c in zip(walls, colds))} of {len(walls)} "
            f"pairs; warm_delta (host) "
            f"{[round(b, 3) for b in books]} ms; host reads {reads}; apply "
            f"h2d {sent} bytes, solve h2d {solve_sent} bytes, full upload "
            f"{full}; {smi}")
    if ds.warm_solves != len(WARM_FRACS) * WARM_CYCLES or ds.cold_solves != 1:
        raise AssertionError(f"w: {ds.cold_solves} cold rungs "
                             f"({ds.warm_cold_reasons})")
    rng = np.random.default_rng(WARM_SEED + 1)
    walls, colds, kinds = [], [], []
    for cyc, delta in enumerate(warm_churn_stream(
            rng, nodes_r, pods_r, running_r, WARM_STREAM, churn_frac=0.01,
            structural_every=5)):
        stats = ds.apply(**delta)
        res, ms = timed(lambda: eng.solve_warm(ds))
        cold, cms = timed(lambda: eng.solve(ds.snap))
        same_result(f"w stream cycle {cyc} vs cold", res, cold)
        walls.append(ms)
        colds.append(cms)
        kinds.append("reorder" if stats.reordered else stats.path)
    if ds.cold_solves != 1:
        raise AssertionError(f"w stream: a cold rung ({ds.warm_cold_reasons})")
    log(f"warm (w) churn stream ({WARM_STREAM} cycles: {kinds}): warm walls "
        f"{[round(w, 3) for w in walls]} ms, p50 {statistics.median(walls):.3f}; cold p50 "
        f"{statistics.median(colds):.3f}; each equal to its cold solve; {smi}")
    recorded = {}
    kernels = kassign.KERNELS

    def record(name):
        fn = getattr(kernels, name)

        def wrapped(*args):
            out = fn(*args)
            if name not in recorded:
                recorded[name] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return out

        return wrapped

    kassign.KERNELS = dataclasses.replace(
        kernels, capacity_prefix_keep=record("capacity_prefix_keep"),
        frontier_closure=record("frontier_closure"))
    rng = np.random.default_rng(10029)
    k = max(1, int(round(0.01 * P)))
    walls, colds, rows = [], [], []
    try:
        for cyc in range(WARM_INC):
            value_churn(ds, pods_r, rng, k)
            res, ms = timed(lambda: eng.solve_warm(ds, incremental=True))
            info = res.inc_info
            if info is None or info["audit_violations"]:
                raise AssertionError(f"w incremental cycle {cyc}: {info}")
            v = validity(f"w incremental cycle {cyc}", cfg, ds.snap, res,
                         ds.warm_state.tableau.mask.cpu().numpy())
            cold, cms = timed(lambda: eng.solve(ds.snap))
            walls.append(ms)
            colds.append(cms)
            rows.append((info["carried"], info["frontier"], v["placed"],
                         int((cold.assignment >= 0).sum()), res.host_reads,
                         cold.host_reads))
    finally:
        kassign.KERNELS = kernels
    if ds.incremental_solves != WARM_INC:
        raise AssertionError(f"w: {ds.incremental_solves} incremental solves")
    log(f"warm (w) incremental 1 % ({k} pods a cycle): walls "
        f"{[round(w, 3) for w in walls]} ms, p50 {statistics.median(walls):.3f}; cold "
        f"p50 {statistics.median(colds):.3f}; audit tails zero, validity audit clean; "
        f"(carried, frontier, placed, cold placed, host reads, cold host "
        f"reads) {rows}; {smi}")
    eng_p = Engine(EngineConfig(mode="parity"))
    eng_p.solve_warm(ds)
    if ds.warm_cold_reasons[-1] != "engine_mismatch":
        raise AssertionError(f"w parity: {ds.warm_cold_reasons}")
    value_churn(ds, pods_r, rng, k)
    res, ms = timed(lambda: eng_p.solve_warm(ds))
    cold, cms = timed(lambda: eng_p.solve(ds.snap))
    same_result("w parity warm vs cold", res, cold,
                ("assignment", "chosen_score", "evicted", "order"))
    log(f"warm (w) parity: warm {ms:.3f} ms, cold {cms:.3f} ms, equal in "
        f"assignment, chosen, evicted, order; {smi}")
    phase_counts = counts()
    for kname, n in phase_counts.items():
        need = kname in WARM_KERNELS and (
            kname != "atom_sat" or ds.snap.atoms.key.shape[0] > 0)
        if ((need and n < 1 and kname not in UNSEEDED_IDLE)
                or (not need and n)):
            raise AssertionError(f"w: kernel {kname} launched {n} times "
                                 f"(launches {phase_counts})")
    log(f"warm (w) launches {phase_counts}; the phase so far "
        f"{time.perf_counter() - t_phase:.1f} s host clock")

    out = {}
    args = recorded["capacity_prefix_keep"]
    got = kassign.capacity_prefix_keep(*args)
    err = require_equal("capacity_prefix_keep", [got],
                        [kassign.capacity_prefix_keep_plain(*args)])
    alloc, used, req, node, rank, active = args
    Pk, R = req.shape
    out["capacity_prefix_keep"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.capacity_prefix_keep(*args), 20),
        plain_ms=cuda_ms(lambda: kassign.capacity_prefix_keep_plain(*args),
                         3),
        prof_ms=profiler_ms(lambda: kassign.capacity_prefix_keep(*args),
                            "capacity_prefix_keep_kernel"),
        bound=bound(nbytes(alloc, used, req, node, rank, active, got),
                    2 * R * int(active.sum())),
        shape=f"P={Pk} N={alloc.shape[0]} R={R}, "
              f"{int(active.sum())} active, {int(got.sum())} kept")
    args = recorded["frontier_closure"]
    got = kassign.frontier_closure(*args)
    err = require_equal("frontier_closure", got,
                        kassign.frontier_closure_plain(*args))
    invol, fr0, valid, carry, dnode, mask = args
    S = 0 if invol is None else invol.shape[1]
    moved = nbytes(fr0, valid, carry, *got) + int((carry >= 0).sum()) + (
        0 if invol is None else nbytes(invol)) + (
        0 if dnode is None else nbytes(dnode))
    out["frontier_closure"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.frontier_closure(*args), 20),
        plain_ms=cuda_ms(lambda: kassign.frontier_closure_plain(*args), 5),
        prof_ms=profiler_ms(lambda: kassign.frontier_closure(*args),
                            "frontier_"),
        bound=bound(moved, fr0.shape[0] * (2 * S + 6)),
        shape=f"P={fr0.shape[0]} N={mask.shape[1]} S={S}, dirty nodes "
              f"{'none' if dnode is None else int(dnode.sum())}, frontier "
              f"{int(got[2])}")
    for kname, r in out.items():
        prof = ("not measured" if r["prof_ms"] is None
                else f"{r['prof_ms']:.4f} ms")
        log(f"kernel {kname} on (w)'s first incremental cycle "
            f"[{r['shape']}]: exact match, kernel {r['ms']:.4f} ms (CUDA "
            f"events around its wrapper; profiler kernel time {prof}), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
            f"({r['bound'][1]}); {smi}")
    eng.close()
    eng_p.close()
    return phase_counts, out


def async_phase(snap, smi: str) -> None:
    """solve_async, score_async and score_topk_async once each on (b),
    each equal to its synchronous form."""
    eng = Engine(EngineConfig(mode="fast"))
    walls = {}
    (got, want), walls["solve_async"] = timed(
        lambda: (eng.solve_async(snap).result(timeout=300.0),
                 eng.solve(snap)))
    same_result("solve_async", got, want,
                ("assignment", "chosen_score", "order", "commit_key",
                 "final_used", "evicted", "rounds", "host_reads"))
    (got, want), walls["score_async"] = timed(
        lambda: (eng.score_async(snap).result(), eng.score(snap)))
    same_result("score_async", got, want, ("feasible", "scores"))
    (got, want), walls["score_topk_async"] = timed(
        lambda: (eng.score_topk_async(snap, 8).result(),
                 eng.score_topk(snap, 8)))
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        raise AssertionError("score_topk_async differs from score_topk")
    eng.close()
    log("async forms on (b): solve_async, score_async, score_topk_async(8) "
        "equal to their synchronous forms; host clock of each pair (ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()) + f"; {smi}")


def queue_expected(dq, now: float, w: int):
    """The numpy oracle's window over the queue's own mirror."""
    order, _, ne, dep = kq.rank_reference(dq._host, now - dq._epoch,
                                          dq.qos_gain)
    return [dq._names[int(s)] for s in order[:min(w, ne)]], ne, dep


def queue_phase(smi: str) -> tuple[dict, dict]:
    """Cell (q): the bounded device queue at the ingest bench's size,
    filled to 90 %, then QUEUE_WINDOWS windows (counters zeroed just
    before, read just after), each after 10 % of the rows churned
    (removals, arrivals, parks, updates) and each equal to the numpy
    oracle over the queue's mirror; then K21 against its plain version
    and rank_reference at full Q, bit for bit, with times and bound.
    Returns (the phase's launch counts, the K21 row)."""
    rng = np.random.default_rng(47)
    dq = DeviceQueue(capacity=QUEUE_CAP, bound=QUEUE_CAP)
    now = 3600.0
    serial = 0

    def arrive(k: int) -> None:
        nonlocal serial
        for _ in range(k):
            sub = now - float(rng.uniform(0.0, 600.0))
            if not dq.upsert(f"pod-{serial}",
                             base_priority=float(rng.uniform(10.0, 100.0)),
                             slo_target=float(rng.uniform(0.5, 0.999)),
                             submitted=sub,
                             run_seconds=float(rng.uniform(0.0, now - sub)),
                             tenant=int(rng.integers(0, 4))):
                raise AssertionError("queue (q): the bounded queue shed "
                                     "below its bound")
            serial += 1

    arrive(int(QUEUE_CAP * QUEUE_FILL))
    dq.window(now, QUEUE_W)          # the first flush uploads the table
    churn = int(QUEUE_CAP * QUEUE_FILL * QUEUE_CHURN)
    zero_counts()
    walls = []
    for _ in range(QUEUE_WINDOWS):
        now += 1.0
        names = dq.names()
        pick = rng.choice(len(names), size=churn, replace=False)
        q4 = churn // 4
        dq.remove([names[int(i)] for i in pick[:q4]])
        for i in pick[q4:2 * q4]:
            dq.park(names[int(i)], until=now + float(rng.uniform(0, 30)))
        for i in pick[2 * q4:3 * q4]:
            dq.upsert(names[int(i)],
                      base_priority=float(rng.uniform(10.0, 100.0)),
                      slo_target=float(rng.uniform(0.5, 0.999)),
                      submitted=now - 600.0,
                      run_seconds=float(rng.uniform(0.0, 600.0)))
        arrive(churn - 3 * q4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dq.window(now, QUEUE_W)
        walls.append((time.perf_counter() - t0) * 1e3)
        want = queue_expected(dq, now, QUEUE_W)
        if got != want:
            raise AssertionError("queue (q): a window differs from the "
                                 "numpy oracle's")
    phase_counts = counts()
    if phase_counts["queue_rank"] != QUEUE_WINDOWS:
        raise AssertionError(f"queue (q): K21 launched "
                             f"{phase_counts['queue_rank']} times in "
                             f"{QUEUE_WINDOWS} windows")
    dev, rel, gain = dq._dev, dq._rebase(now), dq.qos_gain
    Q = dq.capacity
    kb = kq.k_bucket(QUEUE_W, Q)
    err = require_equal("queue_rank (window)",
                        kq.window_select(dev, rel, gain, kb),
                        kq.queue_rank_plain(dev, rel, gain, kb))
    full = kq.rank_full(dev, rel, gain)
    err = max(err, require_equal("queue_rank (full)", full,
                                 kq.queue_rank_plain(dev, rel, gain)))
    order, prio, ne, dep = kq.rank_reference(dq._host, rel, gain)
    if not (np.array_equal(full[0].cpu().numpy(), order)
            and np.array_equal(full[1].cpu().numpy().view(np.uint32),
                               prio.view(np.uint32))
            and (int(full[2]), int(full[3])) == (ne, dep)):
        raise AssertionError("queue (q): rank_full differs from "
                             "rank_reference at full Q")
    win = lambda: kq.window_select(dev, rel, gain, kb)   # noqa: E731
    key = torch.randint(0, 2**62, (Q,), dtype=torch.int64,
                        device=dev.valid.device)
    b = nbytes(*(dev[i] for i in (0, 1, 2, 3, 4, 5, 7))) + 8 * kb + 8
    ops = Q * 12 + Q * max(1, (Q - 1).bit_length()) * 4
    row = dict(err=err, ms=cuda_ms(win, 20),
               prof_ms=profiler_ms(win, "queue_"),
               plain_ms=cuda_ms(lambda: kq.queue_rank_plain(dev, rel, gain,
                                                            kb), 5),
               library="torch.sort (stable, one int64 key of Q)",
               library_ms=cuda_ms(lambda: torch.sort(key, stable=True), 20),
               bound=bound(b, ops),
               shape=f"Q={Q} kb={kb}, {ne} eligible of {dep}")
    prof = ("not measured" if row["prof_ms"] is None
            else f"{row['prof_ms']:.4f} ms")
    log(f"queue (q): {QUEUE_WINDOWS} windows of {QUEUE_W} over a {Q}-slot "
        f"bounded table at {dep} rows, {churn} rows churned a window "
        f"({dq.scatters} scatters, {dq.scatter_rows_total} rows shipped), "
        f"every window equal to rank_reference; window wall (flush + K21 + "
        f"read-back) p50 {statistics.median(walls):.4f} ms, max "
        f"{max(walls):.4f} ms; rank_full == rank_reference at full Q bit "
        f"for bit; {smi}")
    log(f"kernel queue_rank [{row['shape']}]: exact match, kernel "
        f"{row['ms']:.4f} ms (CUDA events; profiler kernel time {prof}), "
        f"plain {row['plain_ms']:.4f} ms, {row['library']} "
        f"{row['library_ms']:.4f} ms, bound {row['bound'][0]:.6f} ms "
        f"({row['bound'][1]}); {smi}")
    return phase_counts, {"queue_rank": row}


def explain_kernel_rows(cfg: EngineConfig, dsnap, kb: int) -> dict:
    """K22's two entry points against their plain versions on one cell
    (exact), with CUDA-event and profiler times and bounds; K6 at kb on
    the masked totals beside torch.topk (logged)."""
    node_sat_t, member_sat_t = _sat_tables(dsnap)
    tab = kassign.build_tableau(cfg, dsnap, node_sat_t, member_sat_t)
    q = kex.probe_inputs(cfg, dsnap, tab, kpair.pair_counts)
    got = kex.explain_cells(q)
    err = require_equal("explain_cells", got[:3],
                        kex.explain_cells_plain(q)[:3])
    P, N = q.aff_ok.shape
    R = dsnap.nodes.allocatable.shape[1]
    topv, topi, _ = kassign.row_topk(got[2], kb)
    terms = kex.explain_terms(q, got[3], topv, topi)
    err_t = require_equal("explain_terms", [terms],
                          [kex.explain_terms_plain(q, None, topv, topi)])
    cell_ops = R * 14 + 60
    rows = {
        "explain_cells": dict(
            err=err, ms=cuda_ms(lambda: kex.explain_cells(q), 5),
            prof_ms=profiler_ms(lambda: kex.explain_cells(q),
                                "explain_cells_kernel"),
            plain_ms=cuda_ms(lambda: kex.explain_cells_plain(q), 2),
            bound=bound(nbytes(q.aff_ok, q.na_raw, q.tt_count, *got[:3]),
                        P * N * cell_ops),
            shape=f"P={P} N={N} R={R} S={dsnap.sigs.key.shape[0]}"),
        "explain_terms": dict(
            err=err_t,
            ms=cuda_ms(lambda: kex.explain_terms(q, got[3], topv, topi), 20),
            prof_ms=profiler_ms(lambda: kex.explain_terms(q, got[3], topv,
                                                          topi),
                                "explain_terms_kernel"),
            plain_ms=cuda_ms(lambda: kex.explain_terms_plain(q, None, topv,
                                                             topi), 2),
            bound=bound(nbytes(*(t for t in (topv, topi, got[3], terms)
                                 if t is not None))
                        + P * kb * (1 + 4 + 4), P * kb * cell_ops),
            shape=f"P={P} kb={kb} S={dsnap.sigs.key.shape[0]}"),
    }
    k6 = cuda_ms(lambda: kassign.row_topk(got[2], kb), 20)
    lib = cuda_ms(lambda: torch.topk(got[2], kb, dim=1), 20)
    b6 = bound(nbytes(got[2], topv, topi), P * N)
    rows["explain_cells"]["k6"] = (k6, lib, b6)
    return rows


def explain_phase(snap_h, snap_d, smi: str) -> tuple[dict, dict]:
    """Cell (x): `Engine.solve_explained(k=3)` on (h) fast and parity
    with preemption and on (d) fast (counters zeroed just before, read
    just after), each equal to the unexplained solve (host reads too),
    its evictors on their victims' nodes, its auction table's evictions
    summing to the evicted count (fast) or all zero (parity), its probe's
    tallies partitioning the valid nodes of every real pod; the walls of
    the explained solve, the probe alone and the unexplained solve; then
    K22's entry points against their plain versions on (h) and (d) (K4's
    explain outputs are held in the preemption phase, against the (h)
    audit's plain scan). Returns (the phase's launch counts, the kernel rows)."""
    cells = (("h fast", EngineConfig(mode="fast", preemption=True), snap_h),
             ("h parity", EngineConfig(mode="parity", preemption=True),
              snap_h),
             ("d fast", EngineConfig(mode="fast"), snap_d))
    col = kassign.EXPLAIN_AUCTION_STATS.index("evictions")
    zero_counts()
    runs = []
    for name, cfg, snap in cells:
        eng = Engine(cfg)
        dsnap = eng.put(snap)
        (res, exd, probe), ex_ms = timed(
            lambda: eng.solve_explained(dsnap, k=EXPLAIN_K))
        runs.append((name, cfg, eng, dsnap, res, exd, probe, ex_ms))
    phase_counts = counts()
    for k in ("explain_cells", "explain_terms", "row_topk",
              "parity_scan_preempt_explain"):
        if phase_counts[k] < 1:
            raise AssertionError(f"explain (x): kernel {k} never launched")
    kb = Engine._k_bucket(EXPLAIN_K, NODES)
    rows = {}
    for name, cfg, eng, dsnap, res, exd, probe, ex_ms in runs:
        plain, un_ms = timed(lambda: eng.solve(dsnap))
        _, probe_ms = timed(lambda: probe_core(cfg, dsnap, kb))
        for f in ("assignment", "evicted", "commit_key", "order",
                  "chosen_score", "final_used", "rounds", "host_reads"):
            if not np.array_equal(getattr(res, f), getattr(plain, f)):
                raise AssertionError(f"explain (x) {name}: the explained "
                                     f"solve differs in {f}")
        node_idx = dsnap.running.node_idx.cpu().numpy()
        ev = res.evicted
        if ((exd.evictor >= 0) != ev).any() or not np.array_equal(
                res.assignment[exd.evictor[ev]], node_idx[ev]):
            raise AssertionError(f"explain (x) {name}: an evictor does not "
                                 "sit on its victim's node")
        if cfg.mode == "parity" and exd.auction_stats.any():
            raise AssertionError(f"explain (x) {name}: parity auction "
                                 "table not zero")
        if cfg.mode == "fast" and exd.auction_stats[:, col].sum() != ev.sum():
            raise AssertionError(f"explain (x) {name}: the auction table's "
                                 "evictions do not sum to the evicted")
        valid = dsnap.pods.valid.cpu().numpy()
        n_nodes = int(dsnap.nodes.valid.sum())
        part = probe.feasible_nodes + probe.filter_counts.sum(1)
        if not (part[valid] == n_nodes).all():
            raise AssertionError(f"explain (x) {name}: the probe's tallies "
                                 "do not partition the valid nodes")
        eng.close()
        log(f"explain (x) {name}: solve_explained(k={EXPLAIN_K}) "
            f"{ex_ms:.3f} ms wall, the probe alone {probe_ms:.3f} ms, the "
            f"unexplained solve {un_ms:.3f} ms; equal to it in assignment, "
            f"evicted, commit key, order, chosen, used, rounds "
            f"({res.rounds}) and host reads ({res.host_reads}); "
            f"{int(ev.sum())} victims, each evictor on its victim's node; "
            f"auction rows {int((exd.auction_stats.any(1)).sum())}; "
            f"partition holds for {int(valid.sum())} pods over {n_nodes} "
            f"nodes; {smi}")
        if name != "h parity":
            got = explain_kernel_rows(cfg, dsnap, kb)
            for kname, r in got.items():
                prof = ("not measured" if r["prof_ms"] is None
                        else f"{r['prof_ms']:.4f} ms")
                log(f"kernel {kname} on {name} [{r['shape']}]: exact match, "
                    f"kernel {r['ms']:.4f} ms (CUDA events; profiler kernel "
                    f"time {prof}), plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); {smi}")
            k6, lib, b6 = got["explain_cells"].pop("k6")
            log(f"kernel row_topk at kb={kb} on {name}'s masked totals: "
                f"{k6:.4f} ms, torch.topk {lib:.4f} ms, bound "
                f"{b6[0]:.4f} ms ({b6[1]}); {smi}")
            for kname, r in got.items():
                if kname in rows:
                    rows[kname]["err"] = max(rows[kname]["err"], r["err"])
                else:
                    rows[kname] = r
    return phase_counts, rows


def deal_library(dem, rem, gather=None):
    """K23's function in library calls, a yardstick only: torch.cumsum of
    the columns (a parallel scan on CUDA, another order of f32 adds) and
    R torch.searchsorted calls over the tenant rows."""
    cd = torch.cumsum(dem, dim=-2)
    if gather is not None:
        cd = cd.gather(-2, gather[..., None].expand(*gather.shape,
                                                    dem.shape[-1]))
    cr = torch.cumsum(rem, dim=-2)
    pos = torch.zeros(cd.shape[:-1], dtype=torch.int64, device=dem.device)
    for r in range(dem.shape[-1]):
        pos = torch.maximum(pos, torch.searchsorted(
            cr[..., r].contiguous(), cd[..., r].contiguous()))
    return pos


def top_by_rank_library(pend, order, C):
    """K24's function in library calls, a yardstick only: torch.cumsum of
    the int flags in pop order, then one scatter of the slots."""
    pend_rm = pend.gather(-1, order)
    cpend = torch.cumsum(pend_rm.to(torch.int32), dim=-1)
    cnon = torch.cumsum((~pend_rm).to(torch.int32), dim=-1)
    n_pend = cpend[..., -1:]
    slot = torch.where(pend_rm, cpend - 1, n_pend + cnon - 1).long()
    P = order.shape[-1]
    buf = torch.zeros(order.shape[:-1] + (P + 1,), dtype=order.dtype,
                      device=order.device)
    buf.scatter_(-1, torch.where(slot < C, slot, P), order)
    return buf[..., :C], n_pend[..., 0]


def floored(draw, n: int, buckets=Buckets, **fixed) -> list:
    """n tenants (snapshot, meta), drawn twice: on their own buckets,
    then under the elementwise max of those (with the `fixed` fields), so
    that they stack. draw(b, **kw) draws tenant b; `buckets` is the
    Buckets class of the package that draws."""
    floor = {}
    for b in range(n):
        for f, v in dataclasses.asdict(draw(b)[1].buckets).items():
            floor[f] = max(floor.get(f, 0), v)
    floor.update(fixed)
    return [draw(b, buckets=buckets(**floor)) for b in range(n)]


def tenant_cells() -> list:
    """Cell (t)'s tenants (snapshot, meta) under one floor without
    signatures."""
    return floored(lambda b, **kw: config2_scale(
        np.random.default_rng(TENANT_SEED + b), TENANT_PODS - TENANT_STEP * b,
        TENANT_NODES, with_qos=True, **CONSTRAINED, **kw), TENANTS,
        signatures=0)


def pair_tenant_cells(n: int, pods: int, step: int, nodes: int) -> list:
    """Cell (tp)'s tenants: config3_pairwise(rng(70 + b), pods - step b,
    nodes) under one floor with their signatures."""
    return floored(lambda b, **kw: config3_pairwise(
        np.random.default_rng(PAIR_TENANT_SEED + b), pods - step * b, nodes,
        **kw), n)


def gang_tenant_cells(n: int, groups: int, group_step: int, nodes: int,
                      node_step: int) -> list:
    """Cell (tg)'s tenants: config4_gangs(rng(80 + b), groups -
    group_step b groups of 4, nodes - node_step b nodes)."""
    return floored(lambda b, **kw: config4_gangs(
        np.random.default_rng(GANG_TENANT_SEED + b),
        n_groups=groups - group_step * b, gang_size=4,
        n_nodes=nodes - node_step * b, **kw), n)


def batch_wall(cfg, dstack, ops=kassign.KERNELS, stats=None):
    """(solve_many's six outputs read back to the host, host-clock ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [t.cpu() for t in solve_many(cfg, dstack, ops=ops, stats=stats)]
    return out, (time.perf_counter() - t0) * 1e3


def plain_twin(name: str, cfg, dstack, out=None, stats=None) -> float:
    """The batch on `dstack` equals its plain-version twin on the card,
    host reads too (out/stats: the kernels' batch already run there);
    returns the plain batch's host-clock ms."""
    if out is None:
        stats = kassign.RoundStats()
        out = batch_wall(cfg, dstack, stats=stats)[0]
    pstats = kassign.RoundStats()
    want, plain_ms = batch_wall(cfg, dstack, kassign.PLAIN, pstats)
    for g, w in zip(out, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: the batch differs from its "
                                 "plain-version twin")
    if pstats.host_reads != stats.host_reads:
        raise AssertionError(f"{name}: {stats.host_reads} host reads, the "
                             f"plain batch {pstats.host_reads}")
    return plain_ms


def batch_cells(cells, snaps, dstack, smi: str, reduced=None,
                hook=None) -> dict:
    """Each cell (name, cfg, the path's kernels, once, optional, twin):
    `solve_many` on the stacked tenants with every counter zeroed just
    before and read just after (each kernel of the path launched); the
    first wall and the median of 5 against the sum of the solo walls on
    the card, host reads against the solo sum; each tenant equal to its
    solo solve in all six outputs, with the validity audit (and hook(name,
    cfg, b, dsnap, res), whose strings join the log line); with `twin`,
    the batch equal to its plain-version twin, host reads too: the full
    batch itself, or the `reduced` stack when one is given. Returns the
    cells' launch counts."""
    launches = {}
    B = dstack.pods.valid.shape[0]
    for name, cfg, want, once, optional, twin in cells:
        zero_counts()
        stats = kassign.RoundStats()
        out, first_ms = batch_wall(cfg, dstack, stats=stats)
        moved = counts()
        check_launches(name, moved, want, dstack.atoms.key.shape[-1] > 0,
                       once=once, optional=optional)
        for k, v in moved.items():
            launches[k] = launches.get(k, 0) + v
        walls = [batch_wall(cfg, dstack)[1] for _ in range(5)]
        static = kassign.precompute_static(cfg, dstack, *_sat_tables(dstack))
        mask = static.mask.cpu().numpy()
        eng = Engine(cfg)
        solo_ms, solo_reads, placed, notes = [], 0, 0, []
        for b, snap in enumerate(snaps):
            ds = eng.put(snap)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = eng.solve(ds)
            solo_ms.append((time.perf_counter() - t1) * 1e3)
            solo_reads += res.host_reads
            a, c, u, o, rounds, ev = (t[b].numpy() for t in out)
            for field, got in (("assignment", a), ("chosen_score", c),
                               ("final_used", u), ("order", o),
                               ("evicted", ev)):
                if not np.array_equal(got, getattr(res, field)):
                    raise AssertionError(f"{name} tenant {b}: {field} "
                                         "differs from its solo solve")
            if int(rounds) != res.rounds:
                raise AssertionError(f"{name} tenant {b}: {int(rounds)} "
                                     f"rounds, solo {res.rounds}")
            placed += validity(f"{name} tenant {b}", cfg, ds, res,
                               mask[b])["placed"]
            if hook is not None:
                notes.append(hook(name, cfg, b, ds, res))
        eng.close()
        plain = "the plain batch not run (seeded)"
        if twin and reduced is None:
            plain_ms = plain_twin(name, cfg, dstack, out, stats)
            plain = f"equal to the plain batch ({plain_ms:.1f} ms)"
        elif twin:
            plain_ms = plain_twin(f"{name} reduced", cfg, reduced)
            plain = (f"the reduced batch ({reduced.pods.valid.shape[0]} "
                     f"tenants) equal to its plain twin, host reads too "
                     f"({plain_ms:.1f} ms)")
        hooked = f"; {'; '.join(notes)}" if notes else ""
        log(f"tenant batch {name}: solve_many over {B} tenants {first_ms:.3f}"
            f" ms first call, median of 5 {statistics.median(walls):.3f} ms "
            f"wall; the {B} solo solves on the card {sum(solo_ms):.3f} ms "
            f"together (each {', '.join(f'{m:.2f}' for m in solo_ms)}); "
            f"host reads {stats.host_reads}, solo sum {solo_reads}; rounds "
            f"{out[4].tolist()}; placed {placed}; launches {moved}; every "
            f"tenant equal to its solo solve in all six outputs, validity "
            f"clean, {plain}{hooked}; {smi}")
    return launches


def tenant_kernel_rows(cfg, dstack, smi: str) -> dict:
    """K7, K23 and K24 against their plain versions and their library
    yardsticks, on the arguments of their first call in the fast batch
    (round 1's desirability and dealing over the tenant rows at their
    ranks, the first tranche's pick)."""
    calls = {}

    def recorder(name, fn):
        def rec(*args):
            calls.setdefault(name, args)
            return fn(*args)
        return rec

    ops = dataclasses.replace(
        kassign.KERNELS, deal=recorder("deal", kassign.deal),
        top_by_rank=recorder("top_by_rank", kassign.top_by_rank),
        desirability=recorder("desirability", kassign.desirability),
        prefix_commit_loop=recorder("prefix_commit_loop",
                                    kassign.prefix_commit_loop))
    solve_many(cfg, dstack, ops=ops)
    rows = {"desirability": k7_row("(t)'s round 1", calls["desirability"],
                                   smi)}
    label = "(t)'s round 1, B = 8"
    k8 = k8_set(label, calls["prefix_commit_loop"], smi)
    rows["prefix_commit_loop"] = {"err": k8["err"]}
    k8_merge(rows, label, k8)
    dem, rem, gather = calls["deal"]
    got = kassign.deal(dem, rem, gather)
    err = require_equal("deal", [got], [kassign.deal_plain(dem, rem, gather)])
    B, L, R = dem.shape
    N, P = rem.shape[1], gather.shape[1]
    steps = lambda n: max(1, (n - 1).bit_length())  # noqa: E731
    rows["deal"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.deal(dem, rem, gather), 20),
        prof_ms=profiler_ms(lambda: kassign.deal(dem, rem, gather),
                            "deal_s"),
        plain_ms=cuda_ms(lambda: kassign.deal_plain(dem, rem, gather), 3),
        library="torch.cumsum + searchsorted",
        library_ms=cuda_ms(lambda: deal_library(dem, rem, gather), 20),
        bound=bound(nbytes(dem, rem, gather, got),
                    B * R * (L * steps(L) + N * steps(N) + P * steps(N))),
        shape=f"B={B} L={L} N={N} R={R} P={P}, rank gather",
        placed_at=int((got < N).sum().item()))
    pend, order, C = calls["top_by_rank"]
    got = kassign.top_by_rank(pend, order, C)
    err = require_equal("top_by_rank", got,
                        kassign.top_by_rank_plain(pend, order, C))
    B, P = pend.shape
    rows["top_by_rank"] = dict(
        err=err, ms=cuda_ms(lambda: kassign.top_by_rank(pend, order, C), 20),
        prof_ms=profiler_ms(lambda: kassign.top_by_rank(pend, order, C),
                            "top_by_rank_kernel"),
        plain_ms=cuda_ms(lambda: kassign.top_by_rank_plain(pend, order, C),
                         3),
        library="torch.cumsum + scatter",
        library_ms=cuda_ms(lambda: top_by_rank_library(pend, order, C), 20),
        bound=bound(nbytes(pend, order, *got), B * P * 3),
        shape=f"B={B} P={P} C={C}, {int(got[1].sum().item())} pending")
    return rows


def k4_tenants_equal_solo(name: str, cfg, dstack, static, order, st=None,
                          dom_s=None) -> tuple[int, int]:
    """K4 (with st, its pairwise variant) over the batch at the policy's
    cluster size equals each tenant's solo launch at Q = 1, in every
    output; returns the batch's (Q, threads)."""
    B, N = order.shape[0], dstack.nodes.valid.shape[1]
    if st is None:
        batch = kassign.parity_scan(cfg, dstack, static, order)
        solo = lambda b: kassign.parity_scan(  # noqa: E731
            cfg, dstack.tenant(b), static.tenant(b), order[b], cluster=1)
        flat = list
    else:
        batch = kassign.parity_scan_pair(cfg, dstack, static, order, st,
                                         dom_s)
        solo = lambda b: kassign.parity_scan_pair(  # noqa: E731
            cfg, dstack.tenant(b), static.tenant(b), order[b],
            st.tenant(b), dom_s[b], cluster=1)
        flat = lambda r: [r[0], r[1], r[2], r[3].counts, r[3].anti,  # noqa
                          r[3].match_tot]
    for b in range(B):
        require_equal(f"K4 on {name}, tenant {b}: the batch against its "
                      "solo launch at Q=1", [t[b] for t in flat(batch)],
                      flat(solo(b)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kassign.scan_cluster_size(B, N, sms)


def log_rows(rows: dict, where: str, smi: str) -> None:
    for kname, r in rows.items():
        prof = ("not measured" if r["prof_ms"] is None
                else f"{r['prof_ms']:.4f} ms")
        lib = (f"{r['library']} {r['library_ms']:.4f} ms, "
               if r.get("library_ms") is not None else "")
        if "kpass_ms" in r:
            kp = r["kpass_prof_ms"]
            lib += (f"the K-pass kernel {r['kpass_ms']:.4f} ms (profiler "
                    + ("not measured" if kp is None else f"{kp:.4f} ms")
                    + "), ")
        log(f"kernel {kname} on {where} [{r['shape']}]: exact match, kernel "
            f"{r['ms']:.4f} ms (CUDA events; profiler kernel time {prof}), "
            f"plain {r['plain_ms']:.4f} ms, {lib}bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}); {smi}")


def tenant_phase(smi: str) -> tuple[dict, dict]:
    """Cell (t): `solve_many` over eight tenants in parity and fast mode
    and once seeded in parity mode (`batch_cells`: the static kernels and
    K4 once for all tenants; the plain batches run on the full stack,
    not for the seeded run); K4 over the tenant axis against one
    tenant's K4 (and each tenant equal to its solo launch at one CTA);
    then K7, K23 and K24 against their plain versions. Returns (the
    phase's launch counts, the K7, K23 and K24 rows)."""
    t0 = time.perf_counter()
    built = tenant_cells()
    snaps = [s for s, _ in built]
    dstack = stack_snapshots(snaps).to("cuda")
    B, P = dstack.pods.valid.shape
    N = dstack.nodes.valid.shape[1]
    bk = built[0][1].buckets
    log(f"tenant snapshots (t) built and stacked on the host, then put on "
        f"the card: {time.perf_counter() - t0:.3f} s; B={B} P={P} N={N} "
        f"M={bk.running_pods} A={bk.atoms} S={bk.signatures}; "
        f"{sum(m.n_pods for _, m in built)} pods on "
        f"{sum(m.n_nodes for _, m in built)} nodes")
    cfg_p, cfg_f = EngineConfig(mode="parity"), EngineConfig(mode="fast")
    cells = (("t parity", cfg_p, PARITY_KERNELS, ONCE, (), True),
             ("t fast", cfg_f, FAST_KERNELS, ONCE, UNSEEDED_IDLE, True),
             ("t parity seeded", EngineConfig(
                 mode="parity", tie_break="seeded", tie_seed=SEED),
              PARITY_KERNELS, ONCE, (), False))
    launches = batch_cells(cells, snaps, dstack, smi)
    static = kassign.precompute_static(cfg_p, dstack, _sat_tables(dstack)[0])
    order = kassign.pop_order(cfg_p, dstack)
    k4_batch = cuda_ms(lambda: kassign.parity_scan(cfg_p, dstack, static,
                                                   order), 3)
    snap0, static0 = dstack.tenant(0), static.tenant(0)
    k4_solo = cuda_ms(lambda: kassign.parity_scan(cfg_p, snap0, static0,
                                                  order[0]), 3)
    q = k4_tenants_equal_solo("(t)", cfg_p, dstack, static, order)
    log(f"K4 over the tenant axis: {B} clusters of {q[0]} CTAs of {q[1]} "
        f"threads {k4_batch:.3f} ms, one tenant {k4_solo:.3f} ms (x{B} = "
        f"{B * k4_solo:.3f} ms); each tenant equal to its solo launch at "
        f"Q=1; {smi}")
    rows = tenant_kernel_rows(cfg_f, dstack, smi)
    log_rows({k: r for k, r in rows.items()
              if k not in ("desirability", "prefix_commit_loop")},
             "(t)'s fast batch", smi)
    return launches, rows


# The CUDA kernel of each entry point that gained the tenant axis with
# signatures and gangs, for the profiler's kernel times.
TENANT_CUDA_NAME = {
    "sig_match": "sig_match_kernel", "pair_counts": "pair_counts_kernel",
    "parity_scan_pair": "parity_scan_kernel",
    "pairwise_batch_ia_ok": "pairwise_batch_kernel",
    "waterfill": "waterfill_kernel", "excess_min": "excess_min_kernel",
    "excess_survive": "excess_survive_kernel",
    "ia_ok_at_choice": "ia_at_choice_kernel",
    "pair_commit": "pair_commit_kernel", "node_add": "node_add_kernel",
}


def first_batch_calls(cfg, dstack, names: dict) -> dict:
    """The arguments of the first call of each entry point in `names`
    (kernels-line name -> (Ops field, want(args, kw))) in solve_many on
    `dstack`."""
    calls = {}

    def rec(name, field, want):
        fn = getattr(kassign.KERNELS, field)

        def wrapped(*a, **kw):
            if name not in calls and want(a, kw):
                calls[name] = (fn, a, kw)
            return fn(*a, **kw)
        return wrapped

    solve_many(cfg, dstack, ops=dataclasses.replace(kassign.KERNELS, **{
        field: rec(name, field, want)
        for name, (field, want) in names.items()}))
    return calls


def tenant_pair_kernel_rows(dstack, reduced, smi: str) -> dict:
    """The entry points that gained the tenant axis, each on the
    arguments of its first call in (tp)'s batches (K9, K10 and K4's
    pairwise variant in the parity batch, the rest in the fast batch;
    node_add's first call that reverts anything): against its plain
    version (K4's on the reduced batch's first call: the plain pairwise
    scan of eight full tenants takes minutes), CUDA-event and profiler
    times and bounds (bytes each input read once, each output written
    once; where a kernel gathers, only the entries it needs). Also K4's
    pairwise variant with 8 CTAs against one tenant's."""
    every = lambda a, kw: True  # noqa: E731
    parity = {"sig_match": ("sig_match", every),
              "pair_counts": ("pair_counts", every),
              "parity_scan_pair": ("parity_scan_pair", every)}
    fast = {"pairwise_batch_ia_ok": (
                "pairwise_batch", lambda a, kw: kw.get("with_ia_ok", False)),
            "waterfill": ("waterfill", every),
            "excess_min": ("excess_min", every),
            "excess_survive": ("excess_survive", every),
            "ia_ok_at_choice": ("ia_ok_at_choice", every),
            "pair_commit": ("pair_commit", every),
            "node_add": ("node_add", lambda a, kw: bool(a[2].any()))}
    plain_of = dict(PLAIN_OF, sig_match=kpair.sig_match_plain,
                    pair_counts=kpair.pair_counts_plain,
                    parity_scan_pair=kassign.parity_scan_pair_plain)
    cfg_p, cfg_f = EngineConfig(mode="parity"), EngineConfig(mode="fast")
    calls = first_batch_calls(cfg_p, dstack, parity)
    calls.update(first_batch_calls(cfg_f, dstack, fast))
    small = first_batch_calls(cfg_p, reduced, {
        "parity_scan_pair": parity["parity_scan_pair"]})
    B, P = dstack.pods.valid.shape
    N = dstack.nodes.valid.shape[1]
    S = dstack.sigs.key.shape[1]
    R = dstack.nodes.allocatable.shape[2]
    IT = dstack.pods.ia_sig.shape[2]
    C = dstack.pods.ts_sig.shape[2]
    M = dstack.running.valid.shape[1]
    out = {}
    for name in (*parity, *fast):
        fn, a, kw = calls[name]
        plain = plain_of[name]
        scan = name == "parity_scan_pair"
        cmp = small[name] if scan else calls[name]
        got = [t for o in _flat(cmp[0](*cmp[1], **cmp[2])) for t in _flat(o)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*cmp[1], **cmp[2])
        end.record()
        end.synchronize()
        want = [t for o in _flat(want) for t in _flat(o)]
        err = require_equal(f"{name} over the tenant axis", got, want)
        # The plain scan runs once (seconds); the others their median.
        r = dict(err=err, ms=cuda_ms(lambda: fn(*a, **kw), 3 if scan else 10),
                 prof_ms=profiler_ms(lambda: fn(*a, **kw),
                                     TENANT_CUDA_NAME[name], 2 if scan else 5),
                 plain_ms=(start.elapsed_time(end) if scan else cuda_ms(
                     lambda: plain(*cmp[1], **cmp[2]), 3)))
        res = [t for o in _flat(fn(*a, **kw)) for t in _flat(o)]
        if name == "sig_match":
            r.update(bound=bound(nbytes(*a[:1], a[2], *res),
                                 B * S * (M + P) * 8),
                     shape=f"B={B} S={S} M+P={M + P}")
        elif name == "pair_counts":
            r.update(bound=bound(nbytes(a[0], a[1], *res), B * S * (M + P)),
                     shape=f"B={B} S={S} N={N} M+P={M + P}")
        elif name == "parity_scan_pair":
            static = a[2]
            b = nbytes(static.mask, static.score, static.aff_ok, *res)
            r.update(bound=bound(b, B * P * N * (C * 6 + IT * 10 + 30)),
                     shape=f"B={B} P={P} N={N} S={S}; plain on the reduced "
                           f"batch B={small[name][1][3].shape[0]} "
                           f"P={small[name][1][3].shape[1]}")
        elif name == "pairwise_batch_ia_ok":
            snap_v, st, aff_ok, sig_match, dom_s = a
            Pv = aff_ok.shape[1]
            b = nbytes(aff_ok, sig_match, dom_s, st.counts, st.anti, *res)
            r.update(bound=bound(b, B * Pv * N * (C * 6 + IT * 10 + S * 3
                                                  + 14)),
                     shape=f"B={B} P={Pv} N={N} S={S} C={C} IT={IT}")
        elif name == "waterfill":
            fill, ord_dom, dom_s, s_p, q, relaxed, cap, score, member, K1 = a
            Pv = relaxed.shape[1]
            b = nbytes(fill, ord_dom, dom_s, s_p, q, relaxed, cap, member,
                       *res) + 4 * B * Pv * K1
            r.update(bound=bound(b, 3 * B * Pv * N), shape=(
                f"B={B} P={Pv} N={N} S={S} K+1={K1}, "
                f"{int(res[2].sum())} members dealt"))
        elif name == "excess_min":
            Pv = a[3].shape[1]
            r.update(bound=bound(nbytes(*a, *res), 3 * B * Pv * N),
                     shape=f"B={B} P={Pv} N={N} S={S}")
        elif name == "excess_survive":
            Pv = a[1].shape[1]
            r.update(bound=bound(nbytes(*a, *res), 4 * B * Pv),
                     shape=f"B={B} P={Pv}, {int(a[2].sum())} members, "
                           f"{int(res[0].sum())} bad")
        elif name == "ia_ok_at_choice":
            Pv = a[4].shape[1]
            b = (B * S * Pv + nbytes(*(getattr(a[0].pods, f) for f in (
                "ia_sig", "ia_valid", "ia_anti", "ia_required")))
                 + 3 * 4 * B * S * Pv + nbytes(a[4], a[5], *res))
            r.update(bound=bound(b, B * (S + 10 * IT) * Pv),
                     shape=f"B={B} P={Pv} S={S} IT={IT}")
        elif name == "pair_commit":
            Pv = a[4].shape[1]
            b = (B * S * Pv + nbytes(a[4], a[5]) + 7 * B * Pv * IT
                 + 2 * 4 * B * S * Pv)
            r.update(bound=bound(b, B * (S + IT) * Pv),
                     shape=f"B={B} P={Pv} S={S}, {int(a[5].sum())} "
                           "committed")
        elif name == "node_add":
            used, node, mask, req, rank, sign = a
            Pv = node.shape[1]
            b = nbytes(node, mask, req, rank, used) + nbytes(*res)
            lib = cuda_ms(lambda: index_add_library(used, node, mask, req,
                                                    sign), 10)
            r.update(bound=bound(b, B * Pv * R), library="index_add_",
                     library_ms=lib,
                     extra={"ms_b8": r["ms"], "library_ms_b8": lib},
                     shape=f"B={B} P={Pv} N={N} R={R}, {int(mask.sum())} "
                           "reverted; " + one_launch(
                               "node_add", lambda: fn(*a, **kw),
                               "node_add_kernel"))
        out[name] = r
    fn, a, kw = calls["parity_scan_pair"]
    cfg, snap, static, order, st, dom_s = a
    k4_solo = cuda_ms(lambda: fn(cfg, snap.tenant(0), static.tenant(0),
                                 order[0], st.tenant(0), dom_s[0]), 3)
    q = k4_tenants_equal_solo("(tp)", cfg, snap, static, order, st, dom_s)
    log(f"K4's pairwise variant over the tenant axis: {B} clusters of "
        f"{q[0]} CTAs of {q[1]} threads "
        f"{out['parity_scan_pair']['ms']:.3f} ms, one tenant {k4_solo:.3f} "
        f"ms (x{B} = {B * k4_solo:.3f} ms); each tenant equal to its solo "
        f"launch at Q=1; {smi}")
    return out


def pair_tenant_phase(smi: str) -> tuple[dict, dict]:
    """Cell (tp): `solve_many` over eight config-3 tenants in parity mode
    (first and seeded) and fast mode (`batch_cells`; the plain twin on
    the reduced batch), then the tenant-axis entry points' rows. Returns
    (the phase's launch counts, the rows)."""
    t0 = time.perf_counter()
    built = pair_tenant_cells(TENANTS, TENANT_PODS, TENANT_STEP,
                              TENANT_NODES)
    snaps = [s for s, _ in built]
    dstack = stack_snapshots(snaps).to("cuda")
    reduced = stack_snapshots([s for s, _ in pair_tenant_cells(
        REDUCED_TENANTS, REDUCED_PODS, 0, REDUCED_NODES)]).to("cuda")
    B, P = dstack.pods.valid.shape
    N = dstack.nodes.valid.shape[1]
    bk = built[0][1].buckets
    log(f"tenant snapshots (tp) built, stacked and put on the card: "
        f"{time.perf_counter() - t0:.3f} s; B={B} P={P} N={N} "
        f"M={bk.running_pods} A={bk.atoms} S={bk.signatures} "
        f"C={bk.spread_constraints} IT={bk.affinity_terms}; "
        f"{sum(m.n_pods for _, m in built)} pods on "
        f"{sum(m.n_nodes for _, m in built)} nodes; the reduced batch "
        f"B={reduced.pods.valid.shape[0]} P={reduced.pods.valid.shape[1]} "
        f"N={reduced.nodes.valid.shape[1]}")
    cells = (("tp parity", EngineConfig(mode="parity"), PAIR_PARITY_KERNELS,
              ONCE, (), True),
             ("tp parity seeded", EngineConfig(
                 mode="parity", tie_break="seeded", tie_seed=SEED),
              PAIR_PARITY_KERNELS, ONCE, (), False),
             ("tp fast", EngineConfig(mode="fast"), FAST_PAIR_KERNELS,
              FAST_PAIR_ONCE, UNSEEDED_IDLE, True))
    launches = batch_cells(cells, snaps, dstack, smi, reduced=reduced)
    rows = tenant_pair_kernel_rows(dstack, reduced, smi)
    log_rows(rows, "(tp)'s batches", smi)
    return launches, rows


def gang_hook(name: str, cfg, b: int, dsnap, res) -> str:
    """Tenant b's gang audit (no group placed in part; the pods its solo
    gang gate rolled back unplaced) and its rolled-back groups."""
    rolled = solve_core(cfg, dsnap, explain=True)[-1][0].cpu().numpy()
    info = gang_audit(f"{name} tenant {b}", dsnap, res, rolled)
    last = b == TENANTS - 1
    if (b == 0 and info["rolled_groups"]) or (last
                                              and not info["rolled_groups"]):
        raise AssertionError(f"{name} tenant {b}: {info['rolled_groups']} "
                             "groups rolled back")
    return (f"tenant {b}: {info['groups_placed']} of {info['groups']} "
            f"groups placed, {info['rolled_groups']} rolled back")


def gang_tenant_phase(smi: str) -> dict:
    """Cell (tg): `solve_many` over eight config-4 tenants in both modes
    (`batch_cells` with each tenant's gang audit and rolled-back groups;
    the plain twin on the reduced batch). Returns the phase's launch
    counts."""
    t0 = time.perf_counter()
    built = gang_tenant_cells(TENANTS, GANG_GROUPS, GANG_GROUP_STEP,
                              TENANT_NODES, GANG_NODE_STEP)
    snaps = [s for s, _ in built]
    dstack = stack_snapshots(snaps).to("cuda")
    reduced = stack_snapshots([s for s, _ in gang_tenant_cells(
        REDUCED_TENANTS, REDUCED_PODS // 4, 0, REDUCED_NODES, 0)]).to("cuda")
    B, P = dstack.pods.valid.shape
    N = dstack.nodes.valid.shape[1]
    log(f"tenant snapshots (tg) built, stacked and put on the card: "
        f"{time.perf_counter() - t0:.3f} s; B={B} P={P} N={N} "
        f"G={built[0][1].buckets.pod_groups}; "
        f"{sum(m.n_pods for _, m in built)} pods on "
        f"{sum(m.n_nodes for _, m in built)} nodes")
    cells = (("tg parity", EngineConfig(mode="parity"), GANG_PARITY_KERNELS,
              ONCE, (), True),
             ("tg fast", EngineConfig(mode="fast"), GANG_FAST_KERNELS, ONCE,
              OPTIONAL + UNSEEDED_IDLE, True))
    return batch_cells(cells, snaps, dstack, smi, reduced=reduced,
                       hook=gang_hook)


def pre_tenant_cells(n: int, pods: int, step: int, nodes: int, seed: int,
                     **kw) -> list:
    """Cell (th)'s (or, with PRE_PAIR, (thp)'s) tenants:
    config5_preemption(rng(seed + b), pods - step b, nodes) under one
    floor."""
    return floored(lambda b, **x: config5_preemption(
        np.random.default_rng(seed + b), pods - step * b, nodes, **kw, **x),
        n)


def preempt_hook(name: str, cfg, b: int, dsnap, res) -> str:
    """Tenant b's preemption audit: its usage less its victims plus its
    placements in f64, victims only where its preempted pods landed (fast
    with signatures: on nodes its round's kept eviction bids claimed, from
    the per-round marks and claims of its solo solve, run again); in fast
    mode also the commit-key audit in both eviction arms. At least one
    eviction a tenant."""
    tag = f"{name} tenant {b}"
    pair = dsnap.sigs.key.shape[-1] > 0
    fast = cfg.mode == "fast"
    rounds = None
    if fast and pair:
        claims = []

        def rec(*a):
            out = kpre.auction_claim(*a)
            claims.append(out[0].clone())
            return out

        ops = dataclasses.replace(kassign.KERNELS, auction_claim=rec)
        _, evs = with_recorded(lambda: solve_core(cfg, dsnap, ops=ops),
                               kassign, "_evict_round")
        rounds = [(a[0], a[2], t, out) for (a, out), t in zip(evs, claims)]
    info = preempt_audit(tag, dsnap, res, rounds)
    if info["evicted"] < 1:
        raise AssertionError(f"{tag}: no victim evicted")
    note = (f"tenant {b}: {info['evicted']} evicted, {info['preempted']} "
            "placed by preemption")
    if fast:
        static = kassign.precompute_static(cfg, dsnap, *_sat_tables(dsnap))
        ck = commit_key_audit(tag, dsnap, res, static,
                              kpair.sig_domains(dsnap), res.evicted)
        if pair:
            note += (f", commit keys clean in both eviction arms "
                     f"({ck['commit_key_checked']} pods over {ck['keys']} "
                     f"keys, {ck.get('one_arm_only', 0)} one-arm checks), "
                     f"{info['stranded']} stranded victims")
    return note


def pre_tenant_phase(smi: str, pair: bool) -> tuple[dict, dict]:
    """Cell (th), or with pair (thp): `solve_many` with preemption over
    eight config-5 tenants in parity mode (first and seeded) and fast
    mode (`batch_cells` with `preempt_hook`; the plain twin on the
    reduced batch); K4's preemption variant (its pairwise one in (thp))
    with 8 CTAs against one tenant's; in (th) the auction kernels over
    the tenant axis on its first auction round against their plain
    versions. Returns (the phase's launch counts, the kernel rows)."""
    label = "thp" if pair else "th"
    seed = PRE_PAIR_TENANT_SEED if pair else PRE_TENANT_SEED
    kw = PRE_PAIR if pair else {}
    t0 = time.perf_counter()
    built = pre_tenant_cells(TENANTS, TENANT_PODS, TENANT_STEP, TENANT_NODES,
                             seed, **kw)
    snaps = [s for s, _ in built]
    dstack = stack_snapshots(snaps).to("cuda")
    reduced = stack_snapshots([s for s, _ in pre_tenant_cells(
        REDUCED_TENANTS, REDUCED_PODS, 0, REDUCED_NODES, seed,
        **kw)]).to("cuda")
    B, P = dstack.pods.valid.shape
    N = dstack.nodes.valid.shape[1]
    bk = built[0][1].buckets
    log(f"tenant snapshots ({label}) built, stacked and put on the card: "
        f"{time.perf_counter() - t0:.3f} s; B={B} P={P} N={N} "
        f"M={bk.running_pods} GP={bk.pdb_groups} S={bk.signatures}; "
        f"{sum(m.n_pods for _, m in built)} pods and "
        f"{sum(m.n_running for _, m in built)} running pods on "
        f"{sum(m.n_nodes for _, m in built)} nodes; the reduced batch "
        f"B={reduced.pods.valid.shape[0]} P={reduced.pods.valid.shape[1]} "
        f"N={reduced.nodes.valid.shape[1]} "
        f"M={reduced.running.valid.shape[1]}")
    cfg_p = EngineConfig(mode="parity", preemption=True)
    cfg_f = EngineConfig(mode="fast", preemption=True)
    parity_k = PAIR_PREEMPT_KERNELS if pair else PREEMPT_KERNELS
    cells = ((f"{label} parity", cfg_p, parity_k, ONCE, (), True),
             (f"{label} parity seeded", dataclasses.replace(
                 cfg_p, tie_break="seeded", tie_seed=SEED), parity_k, ONCE,
              (), False),
             (f"{label} fast", cfg_f,
              FAST_PREEMPT_PAIR_KERNELS if pair else FAST_PREEMPT_KERNELS,
              FAST_PAIR_ONCE if pair else ONCE, OPTIONAL + UNSEEDED_IDLE,
              True))
    launches = batch_cells(cells, snaps, dstack, smi, reduced=reduced,
                           hook=preempt_hook)
    static = kassign.precompute_static(cfg_p, dstack, *_sat_tables(dstack))
    order = kassign.pop_order(cfg_p, dstack)
    pctx = kpre.precompute(cfg_p, dstack)
    if pair:
        dom_s = kpair.sig_domains(dstack)
        st = kpair.pair_counts(static.sig_match, dom_s, dstack.running,
                               dstack.pods)
        fn, args = kassign.parity_scan_pair_preempt, (
            cfg_p, dstack, static, order, st, dom_s, pctx)
    else:
        fn, args = kassign.parity_scan_preempt, (cfg_p, dstack, static,
                                                 order, pctx)
    one = tuple(a.tenant(0) if hasattr(a, "tenant") else
                a[0] if isinstance(a, torch.Tensor) else a for a in args)
    k4_batch = cuda_ms(lambda: fn(*args), 3)
    k4_solo = cuda_ms(lambda: fn(*one), 3)
    log(f"K4's {'pairwise ' if pair else ''}preemption variant over the "
        f"tenant axis ({label}): {B} CTAs {k4_batch:.3f} ms, one tenant "
        f"{k4_solo:.3f} ms (x{B} = {B * k4_solo:.3f} ms); {smi}")
    rows = {}
    if not pair:
        calls = first_auction_calls(cfg_f, dstack)
        rows = auction_kernel_phase(dstack, calls)
        log_rows(rows, "(th)'s first auction round", smi)
        nv = tableau_nv_bound(calls)
        log(f"bound of _tableau_nv (plain torch, no kernel) on (th)'s first "
            f"auction round: {nv[0]:.5f} ms ({nv[1]}); {smi}")
    return launches, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU and has no CPU mode", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    _build.lib()
    n_src = len(list(_build.CSRC.glob("*.cu")))
    log(f"kernel build (nvcc, {n_src} sources in parallel) and load: "
        f"{time.perf_counter() - t0:.3f} s")
    ptxas = _build.BUILD_DIR / "ptxas.txt"
    if ptxas.exists():
        print(ptxas.read_text(), file=sys.stderr)

    t0 = time.perf_counter()
    snap_a, meta_a = config2_scale(np.random.default_rng(SEED), PODS, NODES,
                                   with_qos=True)
    snap_b, meta_b = config2_scale(np.random.default_rng(SEED), PODS, NODES,
                                   with_qos=True, **CONSTRAINED)
    log(f"snapshots built on the host: {time.perf_counter() - t0:.3f} s; "
        f"(a) buckets P={meta_a.buckets.pods} N={meta_a.buckets.nodes} "
        f"M={meta_a.buckets.running_pods} A={meta_a.buckets.atoms}; "
        f"(b) A={meta_b.buckets.atoms} T={meta_b.buckets.terms} "
        f"TN={meta_b.buckets.node_taints} VT={meta_b.buckets.taint_vocab}")
    t0 = time.perf_counter()
    snap_d, meta_d = config3_pairwise(np.random.default_rng(PAIR_SEED), PODS,
                                      NODES)
    snap_e, meta_e = config3_pairwise(np.random.default_rng(PAIR_SEED), PODS,
                                      NODES, **PAIR_EXTRA)
    log(f"pairwise snapshots built on the host: "
        f"{time.perf_counter() - t0:.3f} s; (d) P={meta_d.buckets.pods} "
        f"N={meta_d.buckets.nodes} M={meta_d.buckets.running_pods} "
        f"S={meta_d.buckets.signatures} C={meta_d.buckets.spread_constraints} "
        f"IT={meta_d.buckets.affinity_terms} A={meta_d.buckets.atoms}; "
        f"(e) S={meta_e.buckets.signatures} "
        f"NSV={meta_e.buckets.sig_namespaces} "
        f"IT={meta_e.buckets.affinity_terms}")

    cfg_first = EngineConfig(mode="parity")
    cfg_seeded = EngineConfig(mode="parity", tie_break="seeded",
                              tie_seed=SEED)
    engine = Engine(cfg_first)

    # -- kernel phase --------------------------------------------------------
    kp = kernel_phase(cfg_first, engine.put(snap_b), smi)
    kp.update(pair_kernel_phase(cfg_first, engine.put(snap_d)))
    kp.update(fast_pair_kernel_phase(cfg_first, engine.put(snap_d)))
    for name, r in kp.items():
        lib = (f", {r['library']} {r['library_ms']:.4f} ms"
               if r.get("library_ms") is not None else "")
        if "prof_ms" in r:
            lib += (", profiler kernel time " + (
                "not measured" if r["prof_ms"] is None
                else f"{r['prof_ms']:.4f} ms"))
        log(f"kernel {name} [{r['shape']}]: exact match, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); {smi}")

    # -- main-path phases ------------------------------------------------------
    cells = (("a: config2 10000x5000 qos", cfg_first, snap_a),
             ("b: + taints/tolerations/selectors/affinity/cordon",
              cfg_first, snap_b),
             ("c: config2 10000x5000 qos, seeded tie-break", cfg_seeded,
              snap_a))
    launches = {name: 0 for name, _, _, _, _ in KERNELS}
    parity, phase_counts = solve_phase("parity", cells, PARITY_KERNELS)
    for k, v in phase_counts.items():
        launches[k] += v
    parity_placed = {}
    for name, cfg, snap, res, wall_ms, moved in parity:
        info = audit(name, cfg, engine.put(snap), res)
        parity_placed[name] = info["placed"]
        if name.startswith(("a:", "c:")):
            r = k4_rows(name[0], info["plain_scan"], smi)
            if name.startswith("a:"):
                kp["parity_scan"] = r
        log(f"parity solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, "
            f"audit clean, equal to the plain solve; {smi}")
    fast_cells = tuple((name, dataclasses.replace(cfg, mode="fast"), snap)
                       for name, cfg, snap in cells)
    fast, phase_counts = solve_phase("fast", fast_cells, FAST_KERNELS)
    for k, v in phase_counts.items():
        launches[k] += v
    for name, cfg, snap, res, wall_ms, moved in fast:
        info = audit(f"fast {name}", cfg, engine.put(snap), res)
        counts = keep_fast_counts(name.split(":")[0], cfg, engine.put(snap), res)
        log(f"fast solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']} (parity placed "
            f"{parity_placed[name]}), rounds {res.rounds}, host reads "
            f"{res.host_reads}{counts}, launches {moved}, audit clean, equal "
            f"to the plain fast solve; {smi}")
    cfg_fa = dataclasses.replace(cfg_first, mode="fast")
    kp["desirability"] = k7_row(
        "fast (a)'s round 0", first_k7_args(cfg_fa, engine.put(snap_a)), smi,
        view=1024)
    # The plain fast solve on the host's CPU places on (b) what the card
    # placed (its f32 prefix sums have one order on every device).
    _, cfg_b, _, res_b, _, _ = fast[1]
    t0 = time.perf_counter()
    cpu_eng = Engine(cfg_b, device="cpu")
    res_cpu = cpu_eng.solve(snap_b)
    cpu_eng.close()
    n_card = int((res_b.assignment >= 0).sum())
    n_cpu = int((res_cpu.assignment >= 0).sum())
    if n_cpu != n_card:
        raise AssertionError(f"fast (b): {n_cpu} placed on the CPU, "
                             f"{n_card} on the card")
    log(f"fast solve (b) on the host CPU (plain versions): placed {n_cpu}, "
        f"as on the card; {int((res_cpu.assignment != res_b.assignment).sum())}"
        f" assignments differ from the card's; rounds {res_cpu.rounds}, "
        f"host reads {res_cpu.host_reads}; "
        f"{(time.perf_counter() - t0):.3f} s host clock")
    for k, v in score_phase(cfg_first, snap_b, smi).items():
        launches[k] += v
    pair_cells = (
        ("d: config3 10000x5000 pairwise", cfg_first, snap_d),
        ("d seeded: config3 10000x5000, seeded tie-break", cfg_seeded,
         snap_d),
        ("e: d + running anti, 3 namespaces, key-less nodes", cfg_first,
         snap_e))
    pair_parity, phase_counts = solve_phase("pairwise parity", pair_cells,
                                            PAIR_PARITY_KERNELS)
    for k, v in phase_counts.items():
        launches[k] += v
    for name, cfg, snap, res, wall_ms, moved in pair_parity:
        info = audit(name, cfg, engine.put(snap), res)
        if name.startswith(("d:", "e:")):
            r = k4_rows(name[0], info["plain_pair_scan"], smi)
            if name.startswith("d:"):
                kp["parity_scan_pair"] = r
        log(f"pairwise parity solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, launches {moved}, "
            f"audit clean, equal to the plain solve (plain scan "
            f"{info['plain_scan_ms']:.1f} ms), pairwise audit clean "
            f"(S={info['signatures']}, {info['anti_holders']} placed "
            f"required-anti holders); {smi}")
    for k, v in pair_score_phase(
            (("d", cfg_first, snap_d, ("top1", "topk8")),
             ("e", cfg_first, snap_e, ("top1",))), smi).items():
        launches[k] += v
    fast_pair_cells = tuple((f"fast {name}", dataclasses.replace(
        cfg, mode="fast"), snap) for name, cfg, snap in pair_cells)
    fast_pair, phase_counts = solve_phase(
        "fast pairwise", fast_pair_cells, FAST_PAIR_KERNELS,
        once=FAST_PAIR_ONCE)
    for k, v in phase_counts.items():
        launches[k] += v
    for name, cfg, snap, res, wall_ms, moved in fast_pair:
        info = audit(name, cfg, engine.put(snap), res)
        counts = keep_fast_counts(name.split(":")[0], cfg, engine.put(snap), res)
        log(f"fast pairwise solve {name}: {wall_ms:.3f} ms wall, placed "
            f"{info['placed']}/{info['valid_pods']}, rounds {res.rounds}, "
            f"host reads {res.host_reads}{counts}, launches {moved}, audit clean, "
            f"equal to the plain fast solve ({info['plain_solve_ms']:.1f} "
            f"ms), pairwise audit clean (S={info['signatures']}, "
            f"{info['anti_holders']} placed required-anti holders), "
            f"commit-key audit clean ({info['commit_key_checked']} pods "
            f"over {info['keys']} keys); {smi}")
    # Compacted rounds (compact_cap -1: [1024, N] views once the pending
    # frontier fits) equal full-width rounds (compact_cap 0) on (d).
    _, cfg_d, snap_fd, res_d, _, _ = fast_pair[0]
    eng_full = Engine(dataclasses.replace(cfg_d, compact_cap=0))
    t0 = time.perf_counter()
    res_full = eng_full.solve(snap_fd)
    full_ms = (time.perf_counter() - t0) * 1e3
    eng_full.close()
    for field in ("assignment", "chosen_score", "commit_key", "final_used",
                  "rounds"):
        if not np.array_equal(getattr(res_d, field), getattr(res_full,
                                                             field)):
            raise AssertionError(f"fast (d): compacted rounds differ from "
                                 f"full-width rounds in {field}")
    log(f"fast (d) compaction twin: compact_cap=-1 equals compact_cap=0 in "
        f"assignment, chosen_score, commit_key, final_used and rounds "
        f"({res_d.rounds}); host reads {res_d.host_reads} vs "
        f"{res_full.host_reads}, full-width solve {full_ms:.3f} ms wall; "
        f"{smi}")
    # K8's loop on (d)'s first compacted round: a [1 024, N] view whose
    # ranks are global.
    P_d = snap_fd.pods.valid.shape[0]
    label = "(d)'s first compacted round"
    k8_merge(kp, label, k8_set(label, loop_calls(
        cfg_d, engine.put(snap_fd),
        want=lambda site, a: a[3].shape[-1] < P_d), smi))
    # The plain fast solve of (d) on the host's CPU places what the card
    # placed.
    t0 = time.perf_counter()
    cpu_eng = Engine(cfg_d, device="cpu")
    res_cpu = cpu_eng.solve(snap_fd)
    cpu_eng.close()
    n_card = int((res_d.assignment >= 0).sum())
    n_cpu = int((res_cpu.assignment >= 0).sum())
    if n_cpu != n_card:
        raise AssertionError(f"fast (d): {n_cpu} placed on the CPU, "
                             f"{n_card} on the card")
    log(f"fast solve (d) on the host CPU (plain versions): placed {n_cpu}, "
        f"as on the card; "
        f"{int((res_cpu.assignment != res_d.assignment).sum())} assignments"
        f" differ from the card's; rounds {res_cpu.rounds}, host reads "
        f"{res_cpu.host_reads}; {(time.perf_counter() - t0):.3f} s host "
        "clock")

    # -- gangs (config 4) and preemption (config 5) ----------------------------
    t0 = time.perf_counter()
    snap_f, meta_f = config4_gangs(np.random.default_rng(GANG_SEED),
                                   n_nodes=NODES, **GANGS)
    snap_g, meta_g = config4_gangs(np.random.default_rng(GANG_SEED), **GANGS)
    snap_h, meta_h = config5_preemption(np.random.default_rng(PRE_SEED), PODS,
                                        NODES)
    snap_hp, meta_hp = config5_preemption(np.random.default_rng(PRE_SEED),
                                          PODS, NODES, **PRE_PAIR)
    log(f"gang and preemption snapshots built on the host: "
        f"{time.perf_counter() - t0:.3f} s; (f) P={meta_f.buckets.pods} "
        f"N={meta_f.buckets.nodes} G={meta_f.buckets.pod_groups}; (g) "
        f"N={meta_g.buckets.nodes}; (h) M={meta_h.buckets.running_pods} "
        f"GP={meta_h.buckets.pdb_groups}, {meta_h.n_running} running pods; "
        f"(h) with spread and inter-pod terms S={meta_hp.buckets.signatures}")
    gang_cells = (("f: config4 2500 gangs of 4 on 5000 nodes", cfg_first,
                   snap_f),
                  ("g: config4 2500 gangs of 4 on 1000 nodes", cfg_first,
                   snap_g))
    for k, v in gang_phase(gang_cells, "gang parity", GANG_PARITY_KERNELS,
                           smi).items():
        launches[k] += v
    fast_gang_cells = tuple((name.replace(":", " fast:", 1),
                             dataclasses.replace(cfg, mode="fast"), snap)
                            for name, cfg, snap in gang_cells)
    for k, v in gang_phase(fast_gang_cells, "gang fast", GANG_FAST_KERNELS,
                           smi).items():
        launches[k] += v
    phase_counts, kp_pre = preempt_phase(snap_h, snap_hp, smi)
    for k, v in phase_counts.items():
        launches[k] += v
    kp.update(kp_pre)
    phase_counts, kp_auction = fast_preempt_phase(snap_h, snap_hp, smi)
    for k, v in phase_counts.items():
        launches[k] += v
    kp.update(kp_auction)
    # K8's loop on a preemption drain step of fast (h) (a view of the
    # best-ranked pending pods at their global ranks): each preemption
    # round (S = 0) commits twice, the drain first, then the plain
    # claims; the first drain with an allowed row.
    pre = loop_calls(EngineConfig(mode="fast", preemption=True),
                     engine.put(snap_h), first=False,
                     want=lambda site, a: site == "_preempt_rounds_many")
    step, drain = next((i, a) for i, a in enumerate(pre[0::2])
                       if bool(a[2].any()))
    label = f"(h)'s drain in preemption round {step + 1}"
    k8_merge(kp, label, k8_set(label, drain, smi))
    kp["cycle"]["extra"]["sizes"] = k5_sizes(
        fast_cells[:2] + (("h fast: config5 10000x5000, preemption on",
                           EngineConfig(mode="fast", preemption=True),
                           snap_h),), smi)

    # -- the warm lineage (w) and the async forms ------------------------------
    async_phase(snap_b, smi)
    phase_counts, kp_warm = warm_phase(smi)
    for k, v in phase_counts.items():
        launches[k] += v
    kp.update(kp_warm)

    # -- the device queue (q), decision provenance (x), the tenant batches
    # (t), (tp), (tg), (th) and (thp) --------------------------------------
    # A row of a kernel already measured above keeps its numbers; the
    # phase's comparison joins its max_abs_err.
    for phase in (lambda: queue_phase(smi),
                  lambda: explain_phase(snap_h, snap_d, smi),
                  lambda: tenant_phase(smi),
                  lambda: pair_tenant_phase(smi),
                  lambda: (gang_tenant_phase(smi), {}),
                  lambda: pre_tenant_phase(smi, False),
                  lambda: pre_tenant_phase(smi, True)):
        phase_counts, rows = phase()
        for k, v in phase_counts.items():
            launches[k] += v
        for k, r in rows.items():
            if k not in kp:
                kp[k] = r
                continue
            kp[k]["err"] = max(kp[k]["err"], r["err"])
            extra = kp[k].setdefault("extra", {})
            for key, v in r.get("extra", {}).items():
                if isinstance(v, dict) and isinstance(extra.get(key), dict):
                    extra[key].update(v)    # K8's and K18's argument sets
                else:
                    extra[key] = v

    for name, n in launches.items():
        if name in OFF_PATH:
            log(f"kernel {name}: {n} launches on the main path "
                f"({OFF_PATH[name]})")
        elif n == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    # -- steady-state solve time and stage breakdowns -------------------------
    for mode, breakdown, steady in (("parity", stage_breakdown, cells[:2]),
                                    ("fast", fast_breakdown, cells[:2]),
                                    ("parity", stage_breakdown,
                                     pair_cells[:1]),
                                    ("fast", fast_breakdown,
                                     fast_pair_cells[:1])):
        for name, cfg, snap in steady:
            eng = Engine(dataclasses.replace(cfg, mode=mode))
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.solve(snap)
                walls.append((time.perf_counter() - t0) * 1e3)
            median = statistics.median(walls)
            bd = breakdown(eng, snap)
            eng.close()
            log(f"steady {mode} solve {name}: median of 5 {median:.3f} ms "
                "wall; stages (ms): " + ", ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in bd.items()) + f"; {smi}")

    kernels = []
    for name, _, _, source, replaces in KERNELS:
        r = kp[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"), **r.get("extra", {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
