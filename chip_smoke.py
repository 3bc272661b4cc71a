#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card -- a Table-I
capacity-planning sweep through ``repro_torch.core.OneWaySweep``, a
multi-job capacity grid through ``repro_torch.core.MultiJobSweep`` (and at
the multi-job benchmark's shape through ``run_multijob_batch``), and LLM
serving (prefill + greedy decode) of qwen2.5-3b and falcon-mamba-7b at
their full published widths through ``repro_torch.models.build_model`` --
and holds each hand-written kernel against its plain PyTorch version;
then the event engine with the reference's routing, the optimizer and an
experiment file, whose CTMC points run through the chunk kernel; and at
the end the paper's own tables (Fig. 2a / 2b and the Table-I sensitivity
grid) through ``repro_torch.studies.paper_tables`` and the trace-fitting
CLI (``scripts/torch_fit_hazard.py``); training; the MoE models; the
cross-attention models whisper-base and llama-3.2-vision-90b; and the
mesh steps on a one-rank NCCL mesh (two ranks where there are two
cards).
Phases, each of which fails the run loudly:

1. the card's name and power limit; build the nine kernel libraries
   (``src/repro_torch/csrc/{event_race,ctmc_chunk,mj_chunk,
   flash_attention,mamba_scan}.cu``, ``ctmc_chunk.cu`` again with float64
   age, its wide instances in both age dtypes, and ``mj_chunk.cu``'s
   runtime-J instance) with nvcc, all at once, and print nvcc's register,
   spill and shared-memory report;
2. the event-race kernel against ``event_race_ref`` on the card, at the
   main path's shape (4,096 x 16 x 3) and at odd shapes, with all-zero-rate
   rows and exact residual ties: events exact, dt within rtol 1e-6; then
   the kernel's and the plain version's times beside the kernel's bound;
3. the attention kernel against ``attention_ref``: the serving path's
   prefill (4 x 512, 16 query heads over 2 KV heads, d 128, bf16,
   causal) and decode (one query over a 544-slot cache, every kv_len
   1..544) shapes, the ``ATTN_CASES`` of ``tests/test_kernels.py`` in
   float32 and bf16, ragged ones, group sizes 1 and 48 at d 64 and 128,
   3 queries x group 8 (24 rows, a row tile a warp in the decode kernel)
   and inputs scaled like the serving path's (within 2e-5 float32, 2e-2
   bf16); the bf16 kernels' dynamic shared memory; then its time
   beside its bound, the plain version's and
   ``scaled_dot_product_attention``'s (a yardstick the port never calls);
4. the scan kernel against ``selective_scan_ref``: falcon-mamba's prefill
   shape (4 x 512 x 8192, N 16, bf16, B and C column slices of one
   projection), the ``SCAN_CASES`` and ragged shapes, a continuation
   from ``h0``, and the edges of the kernel's launch plan (N 8, d_inner
   not a multiple of the block or of 8, S = 1, S not a multiple of the
   span, B and C slices at falcon-mamba's and at an odd offset, dt * A
   where expf underflows) (within 1e-4 float32, 3e-2 bf16); then its
   launch plan, registers, spills and shared memory from nvcc's report,
   and its time beside its bound and the share of the bound reached;
5. the CTMC main path: ``OneWaySweep`` over ``warm_standbys`` in {4, 8,
   16, 32} at the paper's full width (job_size 4096, working pool 4160,
   spare pool 200), 1,024 replicas a point, ``job_length`` cut from 64 to
   16 days, each chunk of 64 steps one launch of the chunk kernel
   (``csrc/ctmc_chunk.cu``): its launches must equal the chunks run, its
   steps the steps run, with no launch of the standalone race; then two
   more points at the same width through ``run_replications`` with
   closed-form answers (no failures; repairs that never heal); then the
   chunk kernel against the plain step loop (``_steps_ref``) on the
   sweep's first chunk, every lane, and both one's times beside the
   kernel's bound;
6. the same sweep through the plain step loop (``event_race_impl="ref"``)
   on the same uniforms: every replica's integer metrics and histogram
   counts identical, float lanes within 1e-6 relative (the bit-different
   elements counted), and the means' z-test;
7. the whole sweep again under torch.profiler: device kernels a step,
   the device's busy share, the chunk kernel's device time a launch and
   the ops that take the host's time;
8. the serving main path: 4 prompts of 512 random token ids, 32 new
   tokens each by greedy argmax, through the full qwen2.5-3b and then the
   full falcon-mamba-7b in bf16 with random weights from a seed: init,
   prefill and decode times, the kernels' launch counts (one attention
   launch per attention layer per prefill and per decode step, one scan
   launch per Mamba layer per prefill), finite logits, a traced
   prefill + 3 decode steps (device busy share, the top device kernels
   and the ranks of the port's own), and a traced prefill alone (the
   port's kernels' share of its device time);
9. the same models in float32 through ``impl="cuda"`` and ``impl="ref"``
   on the same weights: each layer on the same input (the share of its
   output within 1e-3 of its scale), then free-running (the largest
   relative difference of the prefill logits and the share of identical
   greedy tokens, held for models without attention);
10. the event engine and the reference's routing: a retirement study
    under ``engine="auto"`` runs on the event engine on the host with no
    chunk launch, a Weibull-failure study routes to the CTMC engine, a
    Weibull-repair study runs on the CTMC engine through a slot instance
    of the chunk kernel, an ``age_dtype="float64"`` study runs on the CTMC
    engine through float64 launches, and ``simulate`` twice with one seed
    gives identical ``RunResult``s;
11. run parity on tests/test_vectorized.py's three configs: the CTMC
    engine on the card (768 replicas, through the chunk kernel) against
    the event engine (48), every compared metric within |z| < 3.5;
12. ``optimize_checkpoint_interval`` on tests/test_checkpoint_opt.py's
    config, twice: the same search both times (objective, interval,
    launches), within one grid notch of Young/Daly; then a third call
    under torch.profiler (device busy share, chunk kernel time);
13. a json experiment file (tests/test_sweeps.py's spec) through
    ``load_experiment`` and ``.run()`` on the card;
14. phase 5's sweep under each non-exponential failure family (Weibull k
    1.5, bathtub infant factor 2 over 7 days, lognormal sigma 1,
    tests/test_empirical.py's piecewise shape), each through its own
    instance of the chunk kernel (16 rates x 4 residuals, 9 uniforms a
    step), its launches counted from 0: steps, launches, sweep wall, every
    replica completed, the first chunk held exactly against the plain
    step loop with its times and bound, the chunk kernel's device time a
    launch over a traced sweep (the whole Weibull sweep through the plain
    loop is no longer run: the first chunk is the comparison);
15. run parity on tests/test_nonexp.py's and tests/test_empirical.py's
    configs and a lognormal: the CTMC engine on the card (768 replicas)
    against the event engine on the host (40), every compared metric
    within |z| < 3.5;
16. phase 5's sweep under each non-exponential repair family (Weibull k
    0.7, lognormal sigma 1.2, deterministic, tests/test_empirical.py's
    repair shape), each through the slot instance of the chunk kernel (a
    warp a row, the row's repair-slot lane in shared memory, 16 rates x 4
    residuals, 9 uniforms a step), held as in phase 14 with the slot
    lane's width and overflows (none allowed);
17. run parity on tests/test_repair_dist.py's configs and
    tests/test_empirical.py's empirical repairs: the CTMC engine on the
    card (768 replicas) against the event engine on the host (40), every
    compared metric within |z| < 3.5, no overflow;
18. examples/capacity_planning.py's rack-outage what-if at Table-I width:
    ``OneWaySweep`` over ``rack_shock_rate`` in {0, 2e-6, 5e-6, 1e-5},
    1,024 replicas a point, 40 racks in pods of 8 (45 fault domains, 109
    servers a rack), ``job_length`` 4 days (the example's 8, halved), its
    launches counted from 0,
    each the exponential scenario instance's (16 + 45 exponential lanes,
    the campaign residual first); every replica complete, servers
    conserved, shocks growing with the rate; the first chunk against the
    plain step loop with its times and bound, the sweep traced, the whole
    sweep through the plain step loop (0 bit-different elements), and the
    rate-0 point against a scenario-free Table-I run with the same seed,
    lane for lane;
19. benchmarks/engine_perf.py's correlated scenario at Table-I width
    (rack and pod shocks, a kill of rack 3 at a quarter of the job, a
    maintenance window), under lognormal sigma 1 failures and then each
    other failure family, each through ``run_replications`` and its own
    scenario instance: every replica completes with its 3 schedule
    entries, the first chunk held exactly against the plain step loop, the
    run traced; the whole lognormal run through the plain step loop (0
    bit-different elements); then run parity of tests/test_faultdomains
    .py's SCENARIO, the CTMC engine on the card (768 replicas) against the
    event engine on the host (48), every compared metric within |z| < 3.5;
20. examples/capacity_planning.py's multi-job what-if: ``MultiJobSweep``
    over ``spare_pool_size`` in {8, 10, 12} x ``repair_servers`` in {3, 4},
    three jobs (64/32/16 servers) sharing one 200-server pool and one
    repair shop, 256 replicas, ``engine="auto"``, each chunk of 64 steps
    one launch of the multi-job chunk kernel (``csrc/mj_chunk.cu``, its
    J = 3 instance, the race of 48 rates x 6 residuals fused in), its
    launches counted from 0: launches equal to the chunks run, steps equal
    to the steps run, no launch of the standalone race or of the
    single-job chunk kernel, every replica complete with its servers
    conserved, each point's makespan, stall hand-offs and queue; the same
    sweep through the plain step loop on the card (0 bit-different
    elements); the 1-job unbounded-shop point through the multi-job API
    (single-job chunk launches, no other launch, 0 differing elements
    against ``simulate_ctmc_sweep``); the grid's middle chunk again, the
    kernel held bit for bit against the plain step loop, with the
    kernel's device time a launch (128 rows a block), the plain loop's
    times and the launch's bound; the standalone race alone on the plain
    loop's race inputs at that chunk's middle step against its plain
    version, with both one's times and its bound; and the whole sweep traced
    (device kernels a step, the device's busy share, the kernel's device
    time a launch);
20b. the multi-job grid at benchmarks/engine_perf.py::
    multijob_sweep_throughput's shape (its multijob_bench_params as data:
    jobs of 64/32/16 servers and 0.5/0.7/0.6 days, no histograms, 77 ring
    records; ``spare_pool_size`` {7, 8, 9, 10} x ``repair_servers`` {3, 4},
    256 replicas, 2,048 rows) through ``run_multijob_batch``: the sweep
    wall, ms a step, launches, the kernel's device time a launch over a
    traced sweep, and the middle chunk held and timed as in phase 20 with
    the launch's bound;
21. run parity of tests/test_multijob_parity.py's two- and four-job
    clusters: the multi-job CTMC engine on the card (1,024 replicas, a
    multi-job chunk launch a chunk, no race launch) against the port's
    event engine on the host (96 and 80), every pinned per-job and fleet
    mean within |z| < 3.5; each cluster's middle chunk (its J = 2 and J = 4
    instances) held and timed as in phase 20;
22. float64 age at Table-I width: Weibull failures with Weibull repairs
    through phase 5's sweep in both age dtypes, phase 14's Weibull sweep
    and phase 19's Weibull campaign with ``age_dtype="float64"``, each
    run's launches all of one float64 instance, its first chunk bit for
    bit the float64 plain loop, its time a launch beside its float32
    twin's, and float64 against float32 on the same draws (|z| < 3.5,
    the rows whose trajectories diverged);
23. replica sharding: ``engine_shards=1`` on phase 5's sweep and phase
    20's grid bit for bit their outputs; with two or more cards two
    shards, each bit for bit its own run on ``cuda:s``, timed against one
    card; with one card the two-shard request refused naming the count;
24. the paper's own evaluation at full size through
    ``repro_torch.studies.paper_tables``: ``fig2a()``, ``fig2b()`` and
    ``sensitivity()`` (4096 servers, 32 days, 256 / 256 / 128 replicas,
    into a temporary folder), the chunk kernel's launches counted from 0
    (every one the exponential instance's, one a chunk, no standalone
    race), every replica complete; each of the 102 rows' mean total time
    against tests/data/torch_paper_reference.json (the JAX package's
    tables, from scripts/torch_paper_reference.py) at |z| < 4, the
    largest |z| a table printed; tests/test_paper_claims.py's five claims
    on these rows; fig2a's first chunk bit for bit the plain step loop,
    with the kernel's time a launch at its 3,072 rows and its bound, and
    a traced fig2a; then ``scripts/torch_fit_hazard.py --selftest`` on the
    card as a subprocess (exit 0, ``ctmc`` routing) and its ``selftest``
    in process, every chunk launch the empirical instance's;
25. the shapes past the standard chunk instances' caps, each under the
    default impl: 65 and 256 empirical failure segments, 65 empirical
    repair segments, a 32,768-slot Weibull repair lane on a 33,280-server
    cluster in float32 and float64 age and 65,536 histogram edges through
    ``simulate_ctmc`` (every launch the wide instance's, -DCTMC_WIDE), and
    nine and sixteen jobs through ``simulate_multijob_ctmc`` (every launch
    the runtime-J instance's, -DMJ_RUNTIME_J); each first chunk bit for
    bit the plain loop, its time a launch beside the standard instance's
    on the nearest shape that one takes (64 segments, 16,384 slots,
    32,768 edges, the eight-job template);
26. ``ops.flash_attention`` and ``ops.selective_scan`` under autograd at
    qwen2.5-3b's attention and falcon-mamba-7b's scan shapes, batch 2 x
    512, bf16 and float32: output and the gradients of a fixed random
    cotangent against ``impl="ref"``, one forward launch a call and none
    in the backward;
27. ``parallel.make_train_step`` at full width: qwen2.5-3b at its full
    36 layers and falcon-mamba-7b at 4 of its 64 (its full depth's
    weights and AdamW state, ~84 GB, exceed one card), bf16 parameters,
    float32 AdamW state, batch 2 x 512, three steps: each step's wall,
    loss and kernel launches (one a layer, two under a remat policy that
    recomputes the forward), the peak memory, and the
    first step's loss and grad norm against ``impl="ref"``;
28. ``train.loop.train`` at examples/torch_train_with_failures.py's 100m
    preset and cluster, 12 steps with a failure at step 9 (checkpoints in
    a temporary folder, removed; 40 steps and step 25 before phase 30
    took its time, 20 and 13 before phase 32), against the same run
    without
    injection: the recovery stats, the Young/Daly cadence, the loss
    falling, and the largest difference of the final parameters;
29. the MoE layers: (a) kimi-k2-1t-a32b at 1 of its 61 layers and
    arctic-480b at 2 of its 35, at full width (384 experts top-8 and a
    shared expert; 128 experts top-2 and a dense residual MLP), served as
    in phase 8 (bf16, 4 x 512 prompt tokens, 32 greedy tokens, the
    parameter count, one attention launch a layer a token), with the
    attention kernel against its plain version at their head shapes, the
    peak memory, the first MoE layer's drop fraction on the prefill's
    input and a traced prefill and decode step's expert GEMMs against
    their bound (every expert's weights read once a step, as the
    reference's dense expert einsum reads them); (b) jamba's smoke config
    (attention + Mamba + MoE) in float32: 1 attention and 7 scan launches
    in the prefill, and layer by layer against ``impl="ref"`` as phase 9;
    (c) the MoE dispatch (``_dispatch_one_group``) on the card bit for bit
    the CPU's at kimi-k2's full prefill shape; (d) ``make_train_step`` on
    the three MoE smoke configs on the card against the CPU (loss, aux
    metrics, gradient norm, launches);
30. cross-attention: (a) whisper-base at full size (6 encoder and 6
    decoder layers) and (b) llama-3.2-vision-90b at full width cut to 2 of
    its 20 superblocks (10 of 100 layers, 2 cross layers), served as in
    phase 8 over bf16 frames (4 x 1,500) or image embeddings (4 x 1,600 x
    1,280, through ``img_proj``), 64 and 512 prompt tokens: the parameter
    count, the attention launches (the encoder's, self and cross in the
    prefill; self and cross a decode step), finite logits, the encoder's
    or projection's share of a traced prefill, the decode step beside its
    bytes bound, the peak memory; (c) whisper-base and llama-vision's
    smoke config in float32, encoder then decoder layers through the
    kernels against ``impl="ref"`` as phase 9; (d) the attention kernel
    alone at each shape of (a) and (b) (non-causal 1,500 x 1,500 in bf16
    and float32, Sq != Sk, split-KV decode over a cross cache, 64 rows a
    KV head on the decode kernel) against ``attention_ref``, timed beside
    its bound, the plain version and ``scaled_dot_product_attention``
    (run right after phase 3: short traces late in the run have dropped
    kernels);
    (e) ``make_train_step`` on the two smoke configs on the card against
    the CPU on the pipeline's float32 frames and image embeddings, then
    three steps of whisper-base at full size (launches a step).
31. the mesh steps (``parallel.build_step``) on a one-rank NCCL mesh (a
    process group of one on a local store), against the one-device
    paths on the same weights: (a) qwen2.5-3b at full size and
    falcon-mamba-7b at 4 of 64 layers served as in phase 8 (greedy tokens
    equal, first logits within the bf16 rule and their bit-different
    elements counted, the attention and scan launches of the mesh run);
    (b) one qwen2.5-3b train step at phase 27's shape through
    ``build_step(kind="train")`` against ``make_train_step`` (loss,
    grad_norm and every leaf of the updated state); (c) kimi-k2 at 1 of
    61 layers under ``moe_buffer_mode`` "shard_map" and "ep", every decode
    step's logits against the off-mesh MoE's; (d) with two or more cards,
    two NCCL ranks on a (1, 2) mesh, spawned here: each rank's parameter
    bytes its placements' share, its prefill time and decode ms a step,
    qwen2.5-3b at 2 layers in float32 held to a one-device float32 run
    (31a's bf16 models printed beside theirs); with one card a line that
    says the two-rank run needs two cards.
32. the dry run and the roofline: (a) ``launch.dryrun.run_cell`` on
    qwen2.5-3b x train_4k x 2x16x16 and falcon-mamba-7b x long_500k x
    16x16 and ``launch.perf.run_variant`` baseline on the second, in a
    subprocess that sees no card (fake tensors, a fake process group),
    started after the builds, each record's terms printed; (b) qwen2.5-3b
    at full width on one card, ``impl="ref"``: a prefill of 4 x 512 into
    a cache of 544 slots and one decode step, each step's FLOPs, bytes
    and collectives equal to its fake trace's (CPU fakes, as the dry run
    makes them), its peak memory
    within 10% of the trace's arguments + temporaries (the peak above
    the step's own baseline printed beside the temporaries);
    (c) the plain path's and the kernel path's walls of the same steps
    at or above the plain and the kernelized bounds (attention launches
    counted); (d) qwen2.5-3b at 2 layers in float32, one train step of 2
    x 512 under remat "nothing", "dots" and "full": loss, grad_norm and
    every leaf bit for bit, the peak of each.  ``--dryrun-only`` runs
    phases 1 and 32 alone.

Prints a ``{"serving": ..., "host_paths": ...}`` line, a ``{"kernels":
[...]}`` line and, as its last line, ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, when there is no CUDA device or the repository's sources
are missing.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
try:
    #: H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W
    #: limit): the roofline's constants
    from repro_torch.roofline.analysis import FP32_FLOPS as FP32_OPS_PER_S
    from repro_torch.roofline.analysis import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.roofline.analysis import PEAK_FLOPS as BF16_OPS_PER_S
except ImportError as exc:
    sys.exit(f"chip_smoke: the repository's sources are missing ({exc})")

TPU_KERNEL = "src/repro/kernels/des_step.py:46"
KERNEL_SOURCE = "src/repro_torch/csrc/event_race.cu"
CHUNK_SOURCE = "src/repro_torch/csrc/ctmc_chunk.cu"
#: the lax.scan of one _step_u a step that the chunk kernel also replaces
CHUNK_SCAN = "src/repro/core/vectorized.py:1495"
ATTN_TPU_KERNEL = "src/repro/kernels/flash_attention.py:34"
ATTN_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
SCAN_TPU_KERNEL = "src/repro/kernels/mamba_scan.py:30"
SCAN_SOURCE = "src/repro_torch/csrc/mamba_scan.cu"

#: the ATTN_CASES of tests/test_kernels.py, plus Sq = Sk = 200:
#: (B, Sq, Sk, Hq, Hkv, d, causal)
ATTN_CASES = [(1, 128, 128, 4, 4, 64, True), (2, 256, 256, 4, 2, 64, True),
              (1, 256, 256, 8, 1, 128, True), (2, 128, 128, 4, 2, 128, False),
              (1, 384, 384, 2, 2, 64, True), (1, 200, 200, 4, 2, 64, True)]
#: the SCAN_CASES of tests/test_kernels.py, plus S = 100, di = 96:
#: (B, S, di, N)
SCAN_CASES = [(1, 64, 64, 8), (2, 128, 128, 16), (2, 64, 256, 16),
              (1, 100, 96, 16)]
#: the edges of the scan kernel's launch plan, as tests/test_torch_scan.py's
#: CUDA_EDGE_CASES: (B, S, di, N, B/C column offset in one projection,
#: dt * A where expf underflows)
SCAN_EDGE_CASES = [(2, 70, 200, 8, 0, False), (2, 45, 100, 16, 0, False),
                   (1, 33, 97, 16, 0, False), (3, 1, 128, 16, 0, False),
                   (2, 77, 192, 16, 0, False), (2, 64, 256, 16, 256, False),
                   (2, 40, 128, 8, 3, False), (2, 40, 64, 16, 0, True)]

SERVE_ARCHS = ("qwen2.5-3b", "falcon-mamba-7b")
SERVE_BATCH, PROMPT_LEN, GEN_TOKENS = 4, 512, 32
S_MAX = PROMPT_LEN + GEN_TOKENS        # cache slots: prompt + new tokens
#: the attention kernels' row log-sum-exp against the plain version's, in
#: units of 1 + |lse| (a merge's weights are off by about this share)
ATTN_LSE_TOL = 1e-4
SEED = 0
#: float32 A/B of the kernels against the plain versions (PERF.md section
#: 2 gives the reasons).  Layer by layer, on the same input: the share of
#: a layer's output elements within AB_ELEM_TOL of its largest magnitude.
AB_ELEM_TOL, AB_ELEM_SHARE = 1e-3, 0.999
#: Free-running, for models without attention (with random weights the
#: near one-hot softmax makes attention models chaotic): the largest
#: prefill-logit difference over the largest logit, and the share of
#: greedy tokens that agree.
AB_LOGIT_TOL, AB_TOKEN_SHARE = 1e-3, 0.9

SWEEP_VALUES = [4, 8, 16, 32]          # Table I's warm_standbys range
N_REPLICAS = 1024
JOB_DAYS = 16                          # cut from the default 64 days
DAY = 24 * 60.0                        # minutes
#: phase 11: tests/test_vectorized.py's configs (Params keywords, the day
#: counts of job_length and of 1 / random_failure_rate) and the metrics
#: compared, each through the CTMC engine on the card (PARITY_CTMC
#: replicas) and the event engine on the host (PARITY_EVENT)
PARITY_CONFIGS = {
    "default": (dict(job_size=64, working_pool_size=72, spare_pool_size=16,
                     warm_standbys=4, seed=3), 4, 0.5,
                ("total_time", "n_failures", "n_random_failures",
                 "n_systematic_failures", "n_auto_repairs",
                 "n_manual_repairs", "n_standby_swaps",
                 "recovery_overhead")),
    "starved": (dict(job_size=32, working_pool_size=33, spare_pool_size=2,
                     warm_standbys=1, auto_repair_time=240.0,
                     manual_repair_time=2880.0, diagnosis_probability=1.0,
                     seed=5), 2, 2.0,
                ("total_time", "n_failures", "n_preemptions",
                 "n_host_selections", "stall_time")),
    "diagnosis": (dict(job_size=48, working_pool_size=56, spare_pool_size=8,
                       warm_standbys=4, diagnosis_probability=0.6,
                       diagnosis_uncertainty=0.3, seed=7), 2, 1.0,
                  ("total_time", "n_failures", "n_undiagnosed",
                   "n_misdiagnosed")),
}
PARITY_CTMC, PARITY_EVENT, PARITY_Z = 768, 48, 3.5
#: phase 12: tests/test_checkpoint_opt.py's rollback-heavy config (4 days,
#: 0.2 failures a server a day) and its optimizer settings
OPT_CONFIG = dict(job_size=16, working_pool_size=20, spare_pool_size=4,
                  warm_standbys=2, seed=3, checkpoint_interval=113.0,
                  checkpoint_cost=5.0)
OPT_REPLICAS, OPT_GRID, OPT_REFINE = 256, 12, 8

#: float32 operations of one live row-step of the exponential step, read
#: off _step_u: rates 44 (products, 8 divisions, the active mask), residuals
#: 2, race 70 (16 + 16 sums, 16 cdf divisions and comparisons, log, divide,
#: min), progress, timer, checkpoint, ring and age 25, counters 15, the four
#: pool picks 56 (sums, cumsums, 16 divisions, comparisons), compartment
#: updates 60, histogram values 8
STEP_OPS = 280
#: bytes of one row's state the chunk kernel reads and writes (6 x 4
#: compartments, 8 lanes, 2 int32 lanes, 17 metrics) and of its parameters
ROW_STATE_BYTES = (6 * 4 + 8 + 2 + 17) * 4
ROW_PARAM_BYTES = 16 * 4

#: phase 14: each non-exponential failure family through phase 5's sweep
#: (Table-I width, exponential repairs, job_length cut to 16 days).  The
#: bathtub's infant factor is low because every restart resets the phase
#: age, so each phase sits in the infant part of the curve.
FAMILY_SWEEPS = {
    "weibull": dict(failure_distribution="weibull",
                    distribution_kwargs={"k": 1.5}),
    "bathtub": dict(failure_distribution="bathtub",
                    distribution_kwargs={"infant_factor": 2.0,
                                         "infant_tau": 7 * DAY}),
    "lognormal": dict(failure_distribution="lognormal",
                      distribution_kwargs={"sigma": 1.0}),
    # tests/test_empirical.py's shape
    "empirical": dict(failure_distribution="empirical",
                      distribution_kwargs={"edges": [0.4, 2.0],
                                           "rates": [0.3, 1.5, 0.7]}),
}
#: float32 operations of one live row-step by family: STEP_OPS plus the
#: family's hazard math read off _step_u, a log, exp or pow counted as
#: one: Weibull 8 shares (16) and their sum (7), the inversion (log,
#: divide, 2 pow, reciprocal, 3 adds, max: 9), the 8-way pick (16); bathtub
#: 3 shapes of 9 operations, the max, 8 rate scalings, the accept (2);
#: lognormal 3 hazards of about 40 (2 clips, 3 logs, log_ndtr's ~20, exp,
#: 8 adds and products), 8 rate products, the accept; empirical 3 hazards
#: and 2 windows over 2 edges (about 4 each), the accept
FAMILY_STEP_OPS = {"exponential": STEP_OPS, "weibull": STEP_OPS + 48,
                   "bathtub": STEP_OPS + 38, "lognormal": STEP_OPS + 130,
                   "empirical": STEP_OPS + 22}
#: phase 15: run parity on tests/test_nonexp.py's and tests/test_empirical
#: .py's base and families, plus a lognormal: (family keywords, metrics)
NONEXP_BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=4,
                   warm_standbys=2, job_length=2 * DAY,
                   random_failure_rate=2.0 / DAY,
                   systematic_failure_rate=4.0 / DAY, recovery_time=5.0,
                   auto_repair_time=30.0, manual_repair_time=120.0, seed=5)
_NONEXP_METRICS = ("total_time", "n_failures", "n_random_failures",
                   "n_systematic_failures", "n_auto_repairs",
                   "recovery_overhead")
NONEXP_PARITY = {
    "weibull": (dict(failure_distribution="weibull",
                     distribution_kwargs={"k": 1.5}),
                _NONEXP_METRICS + ("n_manual_repairs", "useful_work")),
    "weibull_infant": (dict(failure_distribution="weibull",
                            distribution_kwargs={"k": 0.8}),
                       ("total_time", "n_failures", "stall_time",
                        "n_standby_swaps")),
    "bathtub": (dict(failure_distribution="bathtub",
                     distribution_kwargs={"infant_factor": 8.0,
                                          "infant_tau": 0.25 * DAY}),
                _NONEXP_METRICS),
    "empirical": (FAMILY_SWEEPS["empirical"], _NONEXP_METRICS),
    "lognormal": (FAMILY_SWEEPS["lognormal"], _NONEXP_METRICS),
}
NONEXP_CTMC, NONEXP_EVENT = 768, 40
#: phase 16: each non-exponential repair family through phase 5's sweep
#: (Table-I width, exponential failures, job_length cut to 16 days);
#: tests/test_repair_dist.py's shapes and tests/test_empirical.py's
#: empirical repair shape
REPAIR_SWEEPS = {
    "weibull": dict(repair_distribution="weibull",
                    distribution_kwargs={"k": 0.7}),
    "lognormal": dict(repair_distribution="lognormal",
                      distribution_kwargs={"sigma": 1.2}),
    "deterministic": dict(repair_distribution="deterministic"),
    "empirical": dict(repair_distribution="empirical",
                      distribution_kwargs={"edges": [0.5],
                                           "rates": [0.1, 2.0]}),
}
#: phase 17: run parity on tests/test_repair_dist.py's configs (and
#: tests/test_empirical.py's empirical repairs) over NONEXP_BASE:
#: (family keywords, metrics)
_REPAIR_METRICS = ("total_time", "n_failures", "n_auto_repairs",
                   "n_manual_repairs", "recovery_overhead")
REPAIR_PARITY = {
    "weibull": (REPAIR_SWEEPS["weibull"],
                _REPAIR_METRICS + ("n_failed_repairs", "n_standby_swaps",
                                   "useful_work")),
    "lognormal": (REPAIR_SWEEPS["lognormal"], _REPAIR_METRICS),
    "deterministic": (REPAIR_SWEEPS["deterministic"],
                      _REPAIR_METRICS + ("n_failed_repairs",)),
    "combined": (dict(failure_distribution="lognormal",
                      repair_distribution="weibull",
                      distribution_kwargs={"k": 0.7, "sigma": 1.0}),
                 _REPAIR_METRICS),
    "empirical": (REPAIR_SWEEPS["empirical"], _REPAIR_METRICS),
}
#: phase 18: examples/capacity_planning.py's rack-outage what-if at Table-I
#: width: 40 racks in pods of 8 (45 fault domains, 109 servers a rack),
#: job_length cut to 4 days (the example cuts it to 8; halved to hold the
#: script's wall: the whole sweep's plain-loop run took 57-69 s at 8 days),
#: a rack_shock_rate grid
SHOCK_RACKS, SHOCK_RACKS_PER_POD, SHOCK_DAYS = 40, 8, 4
SHOCK_RATES = [0.0, 2e-6, 5e-6, 1e-5]
#: phase 19: benchmarks/engine_perf.py's correlated scenario at Table-I
#: width (lognormal sigma 1 failures, rack and pod shocks, a kill of rack 3
#: at a quarter of the job and a maintenance window of 5% of it at half),
#: job_length the benchmark's 2 days, under each failure family
CAMPAIGN_RATES = dict(rack_shock_rate=1e-5, pod_shock_rate=2e-6)
CAMPAIGN_DAYS = 2
CAMPAIGN_FAMILIES = {"lognormal": FAMILY_SWEEPS["lognormal"],
                     "exponential": {}, "weibull": FAMILY_SWEEPS["weibull"],
                     "bathtub": FAMILY_SWEEPS["bathtub"],
                     "empirical": FAMILY_SWEEPS["empirical"]}
#: phase 19's run parity: tests/test_faultdomains.py's SCENARIO and the
#: metrics its cross-engine test compares
SCEN_PARITY_BASE = dict(job_size=24, working_pool_size=32, spare_pool_size=8,
                        warm_standbys=4, job_length=3000.0,
                        random_failure_rate=2e-4,
                        systematic_failure_rate=1e-3, recovery_time=10.0,
                        seed=5)
SCEN_PARITY_METRICS = ("total_time", "n_failures", "n_standby_swaps",
                       "n_host_selections", "n_preemptions",
                       "recovery_overhead", "n_domain_shocks",
                       "n_shock_killed", "n_campaign_events")
SCEN_PARITY_CTMC, SCEN_PARITY_EVENT = 768, 48
#: a scenario instance's extra float32 operations a live row-step, read
#: off _step_u's scen branches: the maintenance gate (8 selects), the
#: campaign residual (index, subtract, max, select), the struck test and
#: the deficit (about 8); plus two a shock lane (STEP counts them apart)
SCEN_STEP_OPS = 24
#: operations of one struck row-step (the out-of-line bulk kill): four
#: systematic roundings of 4 classes (products, cumsum, 8 subtractions,
#: 8 ceils, 8 maxima, 4 differences: ~36 each), the sums, the in-shop
#: rounding, the waterfall (~20), three takes (a division, 4 products, a
#: rounding: ~41 each) and the pools' updates (20)
BULK_OPS = 4 * 36 + 20 + 20 + 3 * 41 + 20
#: bytes of a row's scenario lanes in the state (deficit, schedule pointer,
#: window flag, the three counters)
SCEN_LANE_BYTES = 6 * 4
#: phase 22: the means held between a float64-age run and its float32 twin
AGE64_METRICS = ("total_time", "n_failures", "stall_time", "useful_work",
                 "n_auto_repairs", "recovery_overhead")

#: phase 20: examples/capacity_planning.py's multi-job what-if: three
#: mixed-size jobs (job_size, job_length, warm_standbys) on one 200-server
#: pool, a spare_pool_size x repair_servers grid, the example's 256
#: replicas (its --fast count is 16)
MJ_CLUSTER = dict(working_pool_size=200, spare_pool_size=12, job_size=64,
                  job_length=720.0, random_failure_rate=0.004,
                  systematic_failure_rate=0.01, auto_repair_time=180.0,
                  manual_repair_time=480.0, repair_servers=4,
                  histogram=None)
MJ_JOBS = ((64, 720.0, 2), (32, 1000.0, 1), (16, 860.0, 1))
MJ_SPARES, MJ_SHOPS, MJ_REPLICAS = [8, 10, 12], [3, 4], 256
MJ_SOURCE = "src/repro_torch/csrc/mj_chunk.cu"
MJ_SCAN = "src/repro/core/vectorized_multijob.py:649"
#: phase 20b: benchmarks/engine_perf.py::multijob_sweep_throughput's shape
#: (its multijob_bench_params, taken as data): three jobs of 64/32/16
#: servers and 0.5/0.7/0.6 days on one 200-server pool, histograms off, 77
#: ring records; spare_pool_size {7, 8, 9, 10} x repair_servers {3, 4},
#: 256 replicas, 2,048 rows
MJ_BENCH_CLUSTER = dict(job_size=16, working_pool_size=200,
                        spare_pool_size=12, job_length=0.5 * DAY,
                        random_failure_rate=0.004,
                        systematic_failure_rate=0.01, auto_repair_time=180.0,
                        manual_repair_time=480.0, repair_servers=4,
                        histogram=None, seed=0, max_run_records=77)
MJ_BENCH_JOBS = ((64, 0.5 * DAY, 2), (32, 0.7 * DAY, 1), (16, 0.6 * DAY, 1))
MJ_BENCH_SPARES, MJ_BENCH_SHOPS = [7, 8, 9, 10], [3, 4]
#: phase 21: tests/test_multijob_parity.py's two clusters (cluster Params
#: keywords, jobs, event replications, seed) and the metrics it pins
MJ_PARITY = {
    "two_job": (dict(working_pool_size=110, spare_pool_size=16,
                     job_size=16, job_length=4000.0,
                     random_failure_rate=0.001,
                     systematic_failure_rate=0.005, auto_repair_time=180.0,
                     manual_repair_time=480.0, repair_servers=6),
                ((32, 4000.0, 2), (16, 6000.0, 1)), 96, 17),
    "four_job": (dict(working_pool_size=110, spare_pool_size=12,
                      job_size=16, job_length=3000.0,
                      random_failure_rate=0.001,
                      systematic_failure_rate=0.005, auto_repair_time=150.0,
                      manual_repair_time=420.0, repair_servers=5),
                 ((24, 3000.0, 2), (16, 4000.0, 1), (12, 3500.0, 1),
                  (8, 5000.0, 1)), 80, 29),
}
MJ_PARITY_CTMC = 1024
MJ_JOB_METRICS = ("total_time", "n_failures", "stall_time", "n_preemptions",
                  "recovery_overhead")
MJ_FLEET_METRICS = ("makespan", "stall_handoffs", "n_auto_repairs",
                    "n_manual_repairs", "n_shop_queued")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(title: str) -> None:
    print(f"== {title}", flush=True)


def device_seconds(prof) -> float:
    """Kernel time on the card in a profile: the device-side events only
    (a host op's row also carries its kernels' time, so summing every row
    would count it twice)."""
    total_us = 0.0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            total_us += getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / 1e6


def device_ms(fn, iters: int):
    """Device time per call from torch.profiler, or None if it shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_s = device_seconds(prof)
    return total_s / iters * 1e3 if total_s > 0 else None


def device_kernels_ms(fn, iters: int):
    """Device time per call of each kernel ``fn`` launches, by name, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, getattr(e, "self_device_time_total", 0.0) / iters / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


def profiled_ms(fn, iters: int, tries: int = 3):
    """``(ms, source)``: ``device_ms`` of ``fn``, traced again up to
    ``tries`` times where a trace shows no device event (late in a long
    run a short trace has shown none, at random), else ``event_ms`` --
    host-clocked, so for a kernel shorter than its launch it is the
    launch's time."""
    for _ in range(tries):
        ms = device_ms(fn, iters)
        if ms is not None:
            return ms, "profiler"
    return event_ms(fn, iters), "cuda events"


def event_ms(fn, iters: int, warmup: int = 20) -> float:
    """Milliseconds per call between CUDA events over back-to-back calls
    (host dispatch included, as the step loop pays it)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def race_inputs(R: int, k_exp: int, k_det: int, seed: int):
    """Race inputs on the card with the edge cases the kernel must keep:
    zero-rate rows, switched-off lanes and timers, exact residual ties,
    and uniforms as strided columns of an (R, 8) draw, as in the step."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rates = torch.rand((R, k_exp), generator=gen, device="cuda") * 2.0
    rates[:, k_exp // 2] = 0.0
    resid = torch.rand((R, k_det), generator=gen, device="cuda") * 5.0
    resid[: R // 4, 0] = math.inf
    if k_det > 1:
        resid[1::3, 1] = resid[1::3, 0]                  # exact ties
    rates[::5] = 0.0                                     # all-zero rows
    resid[::7] = math.inf                                # no timer at all
    u = torch.rand((R, 8), generator=gen, device="cuda").clamp_min(1e-12)
    return rates, resid, u[:, 0], u[:, 1]


def compare_race(R: int, k_exp: int, k_det: int):
    """Kernel against plain version: (event mismatches, dt max rel err,
    dt max abs err); raises if the infinities disagree."""
    import torch
    from repro_torch.kernels import des_step, ref
    args = race_inputs(R, k_exp, k_det, seed=R * 131 + k_exp)
    dt_k, ev_k = des_step.event_race_cuda(*args)
    dt_r, ev_r = ref.event_race_ref(*args)
    torch.cuda.synchronize()
    if ev_k.dtype != torch.int32 or dt_k.dtype != torch.float32:
        fail(f"kernel output dtypes {dt_k.dtype}, {ev_k.dtype}")
    mism = int((ev_k != ev_r).sum())
    fin = torch.isfinite(dt_r)
    if not torch.equal(fin, torch.isfinite(dt_k)):
        fail(f"kernel and plain version disagree on +inf dt at {R}x"
             f"{k_exp}x{k_det}")
    diff = (dt_k[fin] - dt_r[fin]).abs()
    rel = float((diff / dt_r[fin].abs().clamp_min(1e-30)).max()) \
        if bool(fin.any()) else 0.0
    return mism, rel, float(diff.max()) if bool(fin.any()) else 0.0


def capture_final_states(vectorized):
    """Wrap the engine's chunk loop to keep each batch's arguments and final
    state, and its chunk seeding to count the chunks and steps it runs.
    Returns (record, restore): record["states"], record["calls"] (each
    call's arguments), record["chunks"], record["steps"]."""
    record = {"states": [], "calls": [], "chunks": 0, "steps": 0}
    orig_loop, orig_seed = vectorized._chunk_loop, vectorized._chunk_seed

    def loop(*args, **kwargs):
        chunk, n_chunks, rem = args[4:7]
        record["calls"].append(args)
        record["plan"] = (chunk, n_chunks, rem)
        out = orig_loop(*args, **kwargs)
        record["states"].append(out)
        return out

    def seed(seed_, i):
        # one call per chunk; chunk n_chunks is the remainder
        chunk, n_chunks, rem = record["plan"]
        record["chunks"] += 1
        record["steps"] += chunk if i < n_chunks else rem
        return orig_seed(seed_, i)

    vectorized._chunk_loop, vectorized._chunk_seed = loop, seed

    def restore():
        vectorized._chunk_loop = orig_loop
        vectorized._chunk_seed = orig_seed
    return record, restore


def build_kernels(libraries) -> None:
    """Build every kernel library at once (one nvcc each) and print each
    build's time and nvcc's -Xptxas -v report."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libraries))
    print(f"kernel builds: {time.perf_counter() - t0:.2f} s for all "
          f"{len(libraries)}, in parallel")
    for lib, path in zip(libraries, paths):
        print(f"  {lib.name}: nvcc {lib.build_seconds:.2f} s -> "
              f"{os.path.relpath(path, ROOT)}")
        for line in lib.build_log.strip().splitlines():
            print(f"    {line}")


def close_err(got, want, tol: float):
    """(max abs err, within) under the tests' rule |a-b| <= tol + tol*|b|;
    non-finite output is never within."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    within = bool(torch.isfinite(g).all()) and \
        bool((diff <= tol + tol * w.abs()).all())
    return float(diff.max()), within


def seeded(seed: int):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def attn_inputs(B, Sq, Sk, Hq, Hkv, d, dtype, seed, scales=(1, 1, 1)):
    """q, k, v from a seed; ``scales`` multiply them before the cast
    ((11, 32, 1) gives the spreads of the serving path's random-weight
    attention, PERF.md section 2)."""
    import torch
    gen = seeded(seed)
    return [(torch.randn(shape, generator=gen, device="cuda") * f).to(dtype)
            for shape, f in zip(((B, Sq, Hq, d), (B, Sk, Hkv, d),
                                 (B, Sk, Hkv, d)), scales)]


def attn_bound_ms(q, k, causal, q_offset=0, kv_len=None):
    """Least time for one attention call on these inputs: q, the k/v rows
    it needs and the output moved once; 4 d operations per visible
    (query, key) pair at the inputs' peak
    (``roofline.kernel_adjust.attention_bound_s``)."""
    from repro_torch.roofline.kernel_adjust import attention_bound_s
    B, Sq, Hq, d = q.shape
    s, by = attention_bound_s(B, Sq, k.shape[1], Hq, k.shape[2], d,
                              q.element_size(), causal, q_offset, kv_len)
    return s * 1e3, by


def attention_phase(fa, ref):
    """Phase 3: the attention kernels against their plain version, then
    times at the serving path's prefill and decode shapes."""
    import torch
    import torch.nn.functional as F
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    bf16 = torch.bfloat16

    def check(label, q, k, v, **kw):
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        err, within = close_err(got, want, tol[q.dtype])
        if not within:
            fail(f"attention kernel disagrees with attention_ref at {label} "
                 f"(max abs err {err:.3e}, tolerance {tol[q.dtype]})")
        return err

    q, k, v = attn_inputs(SERVE_BATCH, PROMPT_LEN, PROMPT_LEN, 16, 2, 128,
                          bf16, seed=1)
    main_err = check("the prefill shape", q, k, v, causal=True)
    print(f"  prefill {tuple(q.shape)} over kv {tuple(k.shape)} bf16 causal: "
          f"max abs err {main_err:.3e}")
    qd, kc, vc = attn_inputs(SERVE_BATCH, 1, S_MAX, 16, 2, 128, bf16, seed=2)
    dec_err = max(check(f"decode kv_len={n}", qd, kc, vc, causal=False,
                        kv_len=n) for n in range(1, S_MAX + 1))
    print(f"  decode {tuple(qd.shape)} over a {S_MAX}-slot cache, every "
          f"kv_len 1..{S_MAX}: max abs err {dec_err:.3e}")
    for label, shape, kw in (
            ("group 1, d 64, decode", (SERVE_BATCH, 1, S_MAX, 2, 2, 64),
             dict(causal=False, kv_len=S_MAX - 7)),
            ("group 1, d 64, prefill", (2, 300, 300, 8, 8, 64),
             dict(causal=True)),
            ("Sq 3 x group 8, decode", (2, 3, S_MAX, 16, 2, 128),
             dict(causal=True, q_offset=S_MAX - 20)),
            ("group 48, decode", (2, 1, S_MAX, 48, 1, 128),
             dict(causal=False, kv_len=300)),
            ("group 48, prefill", (1, 130, 130, 48, 1, 128),
             dict(causal=True))):
        for dtype in (torch.float32, bf16):
            err = check(label, *attn_inputs(*shape, dtype, seed=21), **kw)
            print(f"  {label} {shape} {str(dtype)[6:]}: max abs err "
                  f"{err:.3e}")
    for label, shape, kw in (
            ("prefill", (SERVE_BATCH, PROMPT_LEN, PROMPT_LEN, 16, 2, 128),
             dict(causal=True)),
            ("decode", (SERVE_BATCH, 1, S_MAX, 16, 2, 128),
             dict(causal=False, kv_len=PROMPT_LEN + GEN_TOKENS // 2))):
        err = check(f"serving-scale {label}", *attn_inputs(
            *shape, bf16, seed=22, scales=(11, 32, 1)), **kw)
        print(f"  serving-scale inputs (q x 11, k x 32), {label} {shape} "
              f"bf16: max abs err {err:.3e}")
    for i, case in enumerate(ATTN_CASES):
        for dtype in (torch.float32, bf16):
            B, Sq, Sk, Hq, Hkv, d, causal = case
            err = check(f"{case} {dtype}",
                        *attn_inputs(B, Sq, Sk, Hq, Hkv, d, dtype, 10 + i),
                        causal=causal)
            print(f"  {case} {str(dtype)[6:]}: max abs err {err:.3e}")
    for label, shape, kw in (
            ("q_offset 200", (2, 100, 300, 4, 2, 32), dict(causal=True,
                                                          q_offset=200)),
            ("kv_len 41", (1, 37, 53, 2, 1, 16), dict(causal=False,
                                                     kv_len=41))):
        for dtype in (torch.float32, bf16):
            err = check(label, *attn_inputs(*shape, dtype, seed=20), **kw)
            print(f"  ragged {shape} {label} {str(dtype)[6:]}: max abs err "
                  f"{err:.3e}")

    # the row log-sum-exp the kernels write on request (the decode over a
    # sequence-split cache merges the ranks by it), on each route
    lse_err = 0.0
    for label, shape, dtype, kw in (
            ("prefill", (SERVE_BATCH, PROMPT_LEN, PROMPT_LEN, 16, 2, 128),
             bf16, dict(causal=True)),
            ("decode", (1, 1, S_MAX, 16, 2, 128), bf16,
             dict(causal=False, kv_len=S_MAX // 2)),
            ("decode", (1, 1, S_MAX, 16, 2, 128), torch.float32,
             dict(causal=False, kv_len=S_MAX // 2))):
        args = attn_inputs(*shape, dtype, seed=23)
        _, got = fa.flash_attention_cuda(*args, return_lse=True, **kw)
        _, want = ref.attention_ref(*args, return_lse=True, **kw)
        err = float(((got - want).abs() / (1 + want.abs())).max())
        print(f"  row log-sum-exp, {label} {shape} {str(dtype)[6:]}: max "
              f"err {err:.3e} (of 1 + |lse|)")
        if not err <= ATTN_LSE_TOL:
            fail(f"attention kernel's log-sum-exp at {label} {shape} "
                 f"{dtype} is {err:.3e} off attention_ref's (tolerance "
                 f"{ATTN_LSE_TOL})")
        lse_err = max(lse_err, err)

    # registers and spills: phase 1's nvcc report; the bfloat16 kernels'
    # dynamic shared memory is Q's 64 rows and a 2-stage K/V ring of 64
    # rows each, rows padded to d + 8 bf16
    print("  bf16 kernels' dynamic shared memory: " + ", ".join(
        f"d {d} {(64 + 4 * 64) * (d + 8) * 2} B" for d in fa.HEAD_DIMS))

    t = {}
    launches = fa.LAUNCHES
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    t["ms"] = device_ms(lambda: fa.flash_attention_cuda(q, k, v), 20)
    t["call_ms"] = event_ms(lambda: fa.flash_attention_cuda(q, k, v), 50)
    t["plain_ms"] = device_ms(lambda: ref.attention_ref(q, k, v), 5)
    t["plain_call_ms"] = event_ms(lambda: ref.attention_ref(q, k, v), 10,
                                  warmup=3)
    t["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    t["bound_ms"], t["bound_by"] = attn_bound_ms(q, k, causal=True)
    kv = PROMPT_LEN + GEN_TOKENS // 2
    kct, vct = (a[:, :kv].transpose(1, 2) for a in (kc, vc))
    qdt = qd.transpose(1, 2)
    t["decode_ms"] = device_ms(lambda: fa.flash_attention_cuda(
        qd, kc, vc, causal=False, kv_len=kv), 50)
    t["decode_call_ms"] = event_ms(lambda: fa.flash_attention_cuda(
        qd, kc, vc, causal=False, kv_len=kv), 200)
    t["decode_plain_ms"] = device_ms(lambda: ref.attention_ref(
        qd, kc, vc, causal=False, kv_len=kv), 20)
    t["decode_library_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(qdt, kct, vct,
                                               enable_gqa=True), 50)
    t["decode_bound_ms"], t["decode_bound_by"] = attn_bound_ms(
        qd, kc, causal=False, kv_len=kv)
    split = device_kernels_ms(lambda: fa.flash_attention_cuda(
        qd, kc, vc, causal=False, kv_len=kv), 50)
    fa.LAUNCHES = launches
    print("  decode shape, device time per call by kernel: " + "; ".join(
        f"{name[:60]} {ms:.6f} ms" for name, ms in split))
    print(f"  prefill shape, per call: device {t['ms']} ms (host-clocked "
          f"{t['call_ms']:.6f} ms); plain {t['plain_ms']} ms (host-clocked "
          f"{t['plain_call_ms']:.6f} ms); scaled_dot_product_attention "
          f"{t['library_ms']} ms; bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']})")
    print(f"  decode shape (kv_len {kv}), per call: device {t['decode_ms']} "
          f"ms (host-clocked {t['decode_call_ms']:.6f} ms); plain "
          f"{t['decode_plain_ms']} ms; scaled_dot_product_attention "
          f"{t['decode_library_ms']} ms; bound {t['decode_bound_ms']:.6f} "
          f"ms ({t['decode_bound_by']})")
    return dict(t, max_abs_err=main_err, decode_max_abs_err=dec_err,
                lse_max_err=lse_err)


def scan_inputs(B, S, di, N, dtype, seed, dt_rank=0, underflow=False):
    """Scan inputs as tests/test_kernels.py draws them; with ``dt_rank``,
    B and C are column slices of one (B, S, dt_rank + 2N) projection, as
    the Mamba layer hands them over; ``underflow`` scales every other
    channel's A by 400, so that dt * A reaches -100 and below."""
    import torch
    import torch.nn.functional as F
    gen = seeded(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (randn(B, S, di) * 0.5).to(dtype)
    dt = (F.softplus(randn(B, S, di)) * 0.1).to(dtype)
    A = -torch.exp(randn(di, N) * 0.5)
    if underflow:
        A[::2] *= 400
    if dt_rank:
        dbc = randn(B, S, dt_rank + 2 * N).to(dtype)
        Bm, Cm = dbc[..., dt_rank:dt_rank + N], dbc[..., dt_rank + N:]
    else:
        Bm, Cm = randn(B, S, N).to(dtype), randn(B, S, N).to(dtype)
    return x, dt, A, Bm, Cm


def scan_bound_ms(x, Bm, N):
    """Least time for one scan on these inputs: x, dt, B, C, A, h0 read
    once and y, h_final written once; 7 fp32 operations per (b, t, c, n)
    (dt*A, exp, decay*h, drive, add, and y's multiply-add) plus dt*x at
    the fp32 peak, or the one exp per (b, t, c, n) at the special-function
    units' rate, whichever takes longer
    (``roofline.kernel_adjust.scan_bound_s``)."""
    from repro_torch.roofline.kernel_adjust import scan_bound_s
    B, S, di = x.shape
    s, by = scan_bound_s(B, S, di, N, x.element_size())
    return s * 1e3, by


def ptxas_report(log: str, kernel: str):
    """(entry function, registers, spill bytes, static shared bytes) for
    each entry in nvcc's ``-Xptxas -v`` log whose name holds ``kernel``;
    the function as ``kernel<type, n, ...>`` where its mangled template
    arguments are float, bf16 and integers."""
    import re
    rows, name, spill = [], None, 0
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    args = re.compile(kernel + r"I(f|13__nv_bfloat16)((?:Li\d+E)*)")
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            spill = 0
            t = name and args.search(name)
            if t:
                name = f"{kernel}<" + ", ".join(
                    [types[t.group(1)]]
                    + re.findall(r"Li(\d+)E", t.group(2))) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill,
                         int(m.group(2) or 0)))
            name = None
    return rows


def scan_phase(ms, ref):
    """Phase 4: the scan kernel against its plain version, then its plan,
    nvcc's report and its times at falcon-mamba's prefill shape."""
    import torch
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    bf16 = torch.bfloat16

    def check(label, x, dt, A, Bm, Cm, h0=None):
        y, h = ms.selective_scan_cuda(x, dt, A, Bm, Cm, h0)
        y_r, h_r = ref.selective_scan_ref(x, dt, A, Bm, Cm, h0)
        err_y, ok_y = close_err(y, y_r, tol[x.dtype])
        err_h, ok_h = close_err(h, h_r, tol[x.dtype])
        if not (ok_y and ok_h) or y.dtype != x.dtype:
            fail(f"scan kernel disagrees with selective_scan_ref at {label} "
                 f"(y err {err_y:.3e}, h err {err_h:.3e}, tolerance "
                 f"{tol[x.dtype]})")
        return max(err_y, err_h)

    main = scan_inputs(SERVE_BATCH, PROMPT_LEN, 8192, 16, bf16, seed=3,
                       dt_rank=256)
    main_err = check("the prefill shape", *main)
    print(f"  prefill {tuple(main[0].shape)}, N 16, bf16, strided B/C: max "
          f"abs err {main_err:.3e}")
    for i, case in enumerate(SCAN_CASES):
        for dtype in (torch.float32, bf16):
            x, dt, A, Bm, Cm = scan_inputs(*case, dtype, seed=30 + i)
            h0 = torch.randn((case[0], case[2], case[3]),
                             generator=seeded(40 + i), device="cuda") * 0.1
            err = check(f"{case} {dtype}", x, dt, A, Bm, Cm, h0)
            print(f"  {case} {str(dtype)[6:]} from a random h0: max abs err "
                  f"{err:.3e}")
    x, dt, A, Bm, Cm = scan_inputs(2, 256, 1024, 16, torch.float32, seed=50)
    y_full, h_full = ms.selective_scan_cuda(x, dt, A, Bm, Cm)
    y1, h1 = ms.selective_scan_cuda(x[:, :128], dt[:, :128], A,
                                    Bm[:, :128], Cm[:, :128])
    y2, h2 = ms.selective_scan_cuda(x[:, 128:], dt[:, 128:], A,
                                    Bm[:, 128:], Cm[:, 128:], h1)
    err_y, ok_y = close_err(torch.cat([y1, y2], 1), y_full, 1e-4)
    err_h, ok_h = close_err(h2, h_full, 1e-4)
    if not (ok_y and ok_h):
        fail(f"scan continuation from h0 disagrees with one scan (y err "
             f"{err_y:.3e}, h err {err_h:.3e})")
    print(f"  continuation (2, 256, 1024, 16) f32 in two halves through h0: "
          f"max abs err {max(err_y, err_h):.3e}")
    for i, (B, S, di, N, offset, underflow) in enumerate(SCAN_EDGE_CASES):
        for dtype in (torch.float32, bf16):
            x, dt, A, Bm, Cm = scan_inputs(B, S, di, N, dtype, seed=60 + i,
                                           dt_rank=offset,
                                           underflow=underflow)
            h0 = torch.randn((B, di, N), generator=seeded(70 + i),
                             device="cuda") * 0.1
            err = check(f"{(B, S, di, N)} {dtype}", x, dt, A, Bm, Cm, h0)
            print(f"  {(B, S, di, N)} {str(dtype)[6:]}, B/C offset {offset}"
                  f"{', dt * A < -100' if underflow else ''}: copy widths "
                  f"{ms.launch_plan(x, dt, Bm, Cm).widths}, max abs err "
                  f"{err:.3e}")

    plan = ms.launch_plan(*main[:2], *main[3:5])
    print(f"  prefill launch plan: {plan}")
    for name, regs, spill, smem in ptxas_report(ms.LIBRARY.build_log,
                                                "selective_scan_kernel"):
        print(f"  nvcc: {name}: {regs} registers, {spill} bytes spilled, "
              f"{smem} bytes static shared memory (the rest is the "
              f"plan's dynamic)")

    t = {}
    launches = ms.LAUNCHES
    t["ms"] = device_ms(lambda: ms.selective_scan_cuda(*main), 20)
    t["call_ms"] = event_ms(lambda: ms.selective_scan_cuda(*main), 20,
                            warmup=3)
    t["plain_ms"] = device_ms(lambda: ref.selective_scan_ref(*main), 1)
    t["plain_call_ms"] = event_ms(lambda: ref.selective_scan_ref(*main), 2,
                                  warmup=1)
    t["bound_ms"], t["bound_by"] = scan_bound_ms(main[0], main[3], 16)
    ms.LAUNCHES = launches
    print(f"  prefill shape, per call: device {t['ms']} ms (host-clocked "
          f"{t['call_ms']:.6f} ms); plain {t['plain_ms']} ms (host-clocked "
          f"{t['plain_call_ms']:.6f} ms); bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']}); library: none")
    kernel_ms = t["call_ms"] if t["ms"] is None else t["ms"]
    print(f"  prefill shape: kernel {kernel_ms * 1e3:.3f} us against its "
          f"bound {t['bound_ms'] * 1e3:.3f} us = "
          f"{t['bound_ms'] / kernel_ms * 100:.1f}% of the bound")
    return dict(t, max_abs_err=main_err, library_ms=None)


INT_METRICS = ("n_failures", "n_random_failures", "n_systematic_failures",
               "n_preemptions", "n_auto_repairs", "n_manual_repairs",
               "n_failed_repairs", "n_host_selections", "n_standby_swaps",
               "n_undiagnosed", "n_misdiagnosed")


def sweep_identity(final, final_ref):
    """A sweep's final state through the chunk kernel against the plain
    step loop's: (share of replicas with identical integer metrics, phase
    and run count; histogram counts identical; largest relative
    difference of a float lane; bit-different float elements).  Fails if
    an integer lane (the repair-slot lane's classes and stages included)
    differs anywhere."""
    import torch
    same = torch.ones_like(final["n_failures"], dtype=torch.bool)
    for m in INT_METRICS + ("phase", "n_runs"):
        same &= final[m] == final_ref[m]
    frac = float(same.float().mean())
    hist_same = torch.equal(final["hist"], final_ref["hist"])
    bits, worst_rel = 0, 0.0
    for k, w in final_ref.items():
        g = final[k]
        if not w.dtype.is_floating_point and not torch.equal(g, w):
            fail(f"{k}: the kernel's and the plain loop's integer lanes "
                 "differ")
        if k in INT_METRICS or k in ("hist", "hist_edges") \
                or not w.dtype.is_floating_point:
            continue
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
            fail(f"{k}: the kernel's and the plain loop's infinities differ")
        fin = torch.isfinite(w)
        rel = (g[fin] - w[fin]).abs() / w[fin].abs().clamp_min(1e-30)
        worst_rel = max(worst_rel, float(rel.max()) if rel.numel() else 0.0)
        bits += int((g.view(torch.int32) != w.view(torch.int32)).sum())
    return frac, hist_same, worst_rel, bits


def chunk_bound_ms(live_rows, n_steps, R, n_edges, hist_adds, ring_writes,
                   kind="exponential", n_hazard_cols=0, n_uniforms=8,
                   n_slots=0, n_repair_cols=0, scen=None, struck_steps=0,
                   param_rows=None, age_bytes=4):
    """Least time for one chunk launch on these inputs: the uniforms the
    rows read (n_steps x R x n_uniforms x 4 B), each live row's state
    read and written, each parameter row the launch reads (``param_rows``:
    1 for a row shared by the batch, else the live rows, the default) read
    once (16 columns, the failure family's hazard columns, for a slot
    instance the repair family's columns, and for a scenario instance the
    exponential repairs' 3 and the scenario's 2D + 3L), each live row's
    repair-slot lane (12 B a slot) or
    scenario lanes (SCEN_LANE_BYTES) read and written once, the bin edges,
    each histogram bin added to and each domain's shock count bumped (read
    and written), each ring slot written; the family's FAMILY_STEP_OPS
    float32 operations a live row-step, plus a slot instance's two a slot
    (the minimum's compare, the decrement), a scenario instance's
    SCEN_STEP_OPS and two a shock lane (the race's sum and cumsum), and
    BULK_OPS a struck row-step, at the float32 peak.  ``scen`` is the
    scenario key (D, codes); ``struck_steps`` the shock and kill
    row-steps of the launch.  ``age_bytes`` is 8 for a float64 twin, whose
    age lane and slots' remaining times take 4 more bytes each."""
    n_dom, n_camp = (scen[0], len(scen[1])) if scen else (0, 0)
    scen_cols = 3 + 2 * n_dom + 3 * n_camp if scen else 0
    param_rows = live_rows if param_rows is None else param_rows
    nbytes = (n_steps * R * n_uniforms * 4
              + live_rows * (2 * ROW_STATE_BYTES + 2 * 12 * n_slots
                             + (2 * SCEN_LANE_BYTES if scen else 0)
                             + 2 * (age_bytes - 4) * (1 + n_slots))
              + param_rows * (ROW_PARAM_BYTES
                              + 4 * (n_hazard_cols + n_repair_cols
                                     + scen_cols))
              + 4 * n_edges + 8 * hist_adds + 4 * ring_writes
              + 8 * struck_steps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    scen_ops = SCEN_STEP_OPS + 2 * n_dom if scen else 0
    ops_ms = ((live_rows * n_steps * (FAMILY_STEP_OPS[kind] + 2 * n_slots
                                      + scen_ops)
               + struck_steps * BULK_OPS) / FP32_OPS_PER_S * 1e3)
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def parity_z(ct, ev, metrics):
    """z of each metric's mean: the CTMC run's arrays ``ct`` against the
    event engine's RunResults ``ev``, in pooled standard errors."""
    zs = {}
    for m in metrics:
        e = [float(getattr(r, m)) for r in ev]
        e_mean = sum(e) / len(e)
        e_var = sum((x - e_mean) ** 2 for x in e) / (len(e) - 1)
        c = ct[m]
        se = math.sqrt(float(c.std()) ** 2 / len(c) + e_var / len(e))
        zs[m] = (e_mean - float(c.mean())) / max(se, 1e-9)
    return zs


def traced_chunk_ms(cc, fn, counter, key):
    """(chunk kernel device ms over a traced run of ``fn``, launches it
    counted in ``counter[key]``); the counters are put back."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    counts = save_counts(cc)
    before = counter[key]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    traced = counter[key] - before
    restore_counts(cc, counts)
    ms = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")
             and "ctmc_chunk_kernel" in e.key) / 1e3
    return ms, traced


def save_counts(cc):
    """The chunk kernel's launch counters, to put back after launches made
    only to compare or time."""
    return (cc.LAUNCHES, cc.STEPS, dict(cc.LAUNCHES_BY_KIND),
            dict(cc.LAUNCHES_BY_REPAIR), dict(cc.LAUNCHES_BY_SCEN),
            dict(cc.LAUNCHES_BY_AGE), cc.LAUNCHES_WIDE)


def restore_counts(cc, counts):
    cc.LAUNCHES, cc.STEPS = counts[:2]
    cc.LAUNCHES_BY_KIND.update(counts[2])
    cc.LAUNCHES_BY_REPAIR.update(counts[3])
    cc.LAUNCHES_BY_SCEN.update(counts[4])
    cc.LAUNCHES_BY_AGE.update(counts[5])
    cc.LAUNCHES_WIDE = counts[6]


def zero_counts(cc):
    """Every launch counter of the chunk kernel to 0."""
    cc.LAUNCHES = cc.STEPS = cc.LAUNCHES_WIDE = 0
    for counter in (cc.LAUNCHES_BY_KIND, cc.LAUNCHES_BY_REPAIR,
                    cc.LAUNCHES_BY_SCEN, cc.LAUNCHES_BY_AGE):
        counter.update(dict.fromkeys(counter, 0))


def chunk_phase(cc, vectorized, call, time_plain=True, wide=False):
    """Phases 5 and 14's kernel check: the chunk kernel against the plain
    step loop on a main path's first chunk (its initial state, parameters,
    failure family and draw), every lane; then the kernel's times (and the
    plain loop's, unless ``time_plain`` is false) and its bound.  ``wide``
    launches the wide instance (phase 25)."""
    import torch
    from repro_torch.core import hazards
    pv, seed, P, R, chunk = call[:5]
    channels, init = call[9], call[10]
    kind, n_seg, rkind, n_rseg = call[11:15]
    scen = call[15] if len(call) > 15 else None
    fam = dict(kind=kind, n_seg=n_seg, rkind=rkind, n_rseg=n_rseg, scen=scen)
    n_u = vectorized._n_uniforms(kind, rkind)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(vectorized._chunk_seed(seed, 0))
    us = torch.rand((chunk, vectorized._next_pow2(R), n_u),
                    generator=gen, device="cuda").clamp_min_(1e-12)
    counts = save_counts(cc)
    launch_kw = dict(fam, wide=wide)
    got = cc.ctmc_chunk_cuda(init, us, pv, R, P, channels, **launch_kw)
    want = vectorized._steps_ref(init, us, pv, R, P, "ref", channels, kind,
                                 n_seg, rkind, n_rseg, scen)
    torch.cuda.synchronize()
    mism, bits, err = 0, 0, 0.0
    for k, w in want.items():
        g = got[k]
        if not w.dtype.is_floating_point or k == "hist":
            mism += int((g != w).sum())
            continue
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
            fail(f"chunk kernel and plain loop disagree on infinities in {k}")
        fin = torch.isfinite(w)
        diff = (g[fin] - w[fin]).abs()
        if diff.numel():
            err = max(err, float(diff.max()))
            if bool((diff > 1e-6 * w[fin].abs()).any()):
                fail(f"chunk kernel disagrees with the plain loop in {k} "
                     f"(max abs err {float(diff.max()):.3e})")
        bits += int((g.view(torch.int32) != w.view(torch.int32)).sum())
    live = int((init["phase"] != vectorized.DONE).sum())
    finished = int((want["phase"] == vectorized.DONE).sum()) \
        - (init["phase"].numel() - live)
    print(f"  first chunk of the sweep ({init['phase'].numel()} rows, {chunk}"
          f" steps): integer and histogram mismatches {mism}, bit-different "
          f"float elements {bits}, max abs err {err:.3e}; rows live {live}, "
          f"finished within the chunk {finished}")
    if mism:
        fail(f"chunk kernel disagrees with the plain loop ({mism} integer or "
             "histogram elements)")
    t = {"max_abs_err": err, "bit_different": bits}
    split = device_kernels_ms(lambda: cc.ctmc_chunk_cuda(
        init, us, pv, R, P, channels, **launch_kw), 20)
    t["ms"] = sum(ms for name, ms in split if "ctmc_chunk_kernel" in name) \
        or None
    t["call_ms"] = event_ms(lambda: cc.ctmc_chunk_cuda(
        init, us, pv, R, P, channels, **launch_kw), 50, warmup=5)
    t["plain_ms"] = t["plain_call_ms"] = None
    if time_plain:
        t["plain_ms"] = device_ms(lambda: vectorized._steps_ref(
            init, us, pv, R, P, "ref", channels, kind, n_seg, rkind, n_rseg,
            scen), 1)
        t["plain_call_ms"] = event_ms(lambda: vectorized._steps_ref(
            init, us, pv, R, P, "ref", channels, kind, n_seg, rkind, n_rseg,
            scen), 1, warmup=1)
    restore_counts(cc, counts)
    hist_adds = int((want["hist"] - init["hist"]).sum()) \
        if "hist" in want else 0
    ring = int((want["n_runs"] - init["n_runs"]).sum()) \
        if want["run_durations"].shape[1] else 0
    n_edges = init["hist_edges"].numel() if "hist_edges" in init else 0
    n_slots = init["repair_rem"].shape[1] if "repair_rem" in init else 0
    # the shock and kill row-steps of the chunk: its shocks, and its
    # campaign entries (an upper bound on its kills)
    struck = 0
    if scen is not None:
        struck = int((want["n_domain_shocks"] - init["n_domain_shocks"]
                      + want["n_campaign_events"]
                      - init["n_campaign_events"]).sum())
    t["bound_ms"], t["bound_by"] = chunk_bound_ms(
        live, chunk, R, n_edges, hist_adds, ring, kind,
        0 if kind == "exponential" else hazards.hazard_col_count(kind, n_seg),
        n_u, n_slots,
        hazards.repair_col_count(rkind, n_rseg) if n_slots else 0, scen,
        struck, 1 if pv.ndim == 1 else live, init["age"].element_size())
    t["struck_row_steps"] = struck
    t["n_slots"] = n_slots
    t["live_rows"] = live
    t["ms_per_step"] = None if t["ms"] is None else t["ms"] / chunk
    print("  device time per launch by kernel (clones included): " + "; ".join(
        f"{name[:50]} {ms:.6f} ms" for name, ms in split))
    print(f"  chunk kernel: device {t['ms']} ms a launch of {chunk} steps "
          f"({t['ms_per_step']} ms a step), host-clocked {t['call_ms']:.6f} "
          f"ms a call; plain step loop {t['plain_ms']} ms device, "
          f"{t['plain_call_ms']} ms host-clocked; bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_by']}; {hist_adds} bin adds, "
          f"{ring} ring writes)")
    return t


def generate(bundle, model, prompts, impl, fa, ms, n_new=None, cross=None):
    """Prefill ``prompts`` (with ``cross``, the batch's frames or image
    embeddings, for a cross-attention model), then greedy-decode until
    ``n_new`` new tokens: times (host clock around work that ends in a
    synchronize), the last prefill logits, the new ids and the kernels'
    launches."""
    import torch
    n_new = GEN_TOKENS if n_new is None else n_new
    B, S = prompts.shape
    cache = bundle.make_cache(B, S + n_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(model, {"tokens": prompts, **(cross or {})},
                                   cache, impl=impl)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = (fa.LAUNCHES, ms.LAUNCHES)
    first = logits[:, -1].float().clone()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    ids, finite = [tok], torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for step in range(n_new - 1):
        logits, cache = bundle.decode(model, tok, cache, S + step, impl=impl)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ids.append(tok)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    return {"prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "logits": first, "ids": torch.cat(ids, 1).cpu(),
            "finite": bool(finite), "after_prefill": after_prefill,
            "after_decode": (fa.LAUNCHES, ms.LAUNCHES)}


def release() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def prompts_for(cfg, prompt_len=PROMPT_LEN):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, prompt_len))
    return torch.as_tensor(ids, device="cuda")


def cross_inputs_for(cfg, dtype):
    """A cross-attention model's batch input on the card, from SEED:
    frames (B, encoder_seq, D) or image embeddings (B, n_image_tokens,
    d_image), scaled by 0.1 as ``with_frontend_stubs`` scales them; {}
    for a model without cross-attention."""
    import torch
    from repro_torch.models.model_zoo import cross_input_key
    key = cross_input_key(cfg)
    if key is None:
        return {}
    shape = ((SERVE_BATCH, cfg.encoder_seq, cfg.d_model) if cfg.is_encdec
             else (SERVE_BATCH, cfg.n_image_tokens, cfg.d_image))
    return {key: (torch.randn(shape, generator=seeded(SEED), device="cuda")
                  * 0.1).to(dtype)}


def train_launches(cfg, forward):
    """Kernel launches of a train step whose forward launches
    ``forward``: where the config's remat policy checkpoints the
    superblocks (``models.transformer.REMAT_POLICIES``), the backward
    runs every superblock's forward again, kernels included."""
    from repro_torch.models.transformer import REMAT_POLICIES
    return forward * (2 if cfg.remat_policy in REMAT_POLICIES else 1)


def attention_launches(cfg):
    """Attention launches of a prefill and of a decode step: the encoder's
    layers and the decoder's self- and cross-attention layers in the
    prefill, the decoder's in a decode step (which reads the cross
    caches)."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_cross = sum(cfg.layer_has_cross_attn(i) for i in range(cfg.n_layers))
    step = kinds.count("attn") + n_cross
    return cfg.encoder_layers + step, step


def serving_phase(arch, fa, ms, n_layers=None, extra=None,
                  prompt_len=PROMPT_LEN):
    """Phase 8 for one model: the serving main path in bf16.  Phases 29
    and 30 cut the depth to ``n_layers`` and call ``extra(bundle, model,
    prompts, rec, cross)`` before the model is released; phase 30 serves
    ``prompt_len``-token prompts with the frames or image embeddings its
    models' cross-attention reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.module import tree_param_count, tree_size_bytes
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_ssm = kinds.count("ssm")
    attn_prefill, attn_step = attention_launches(cfg)
    bundle = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    model = bundle.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sd = model.state_dict()
    n_params, n_bytes = tree_param_count(sd), tree_size_bytes(sd)
    if n_params != cfg.param_count():
        fail(f"{arch}: {n_params} parameters, the config counts "
             f"{cfg.param_count()}")
    prompts = prompts_for(cfg, prompt_len)
    cross = cross_inputs_for(cfg, torch.bfloat16)
    generate(bundle, model, prompts[:, :16], None, fa, ms, n_new=3,
             cross=cross)
    fa.LAUNCHES = ms.LAUNCHES = 0            # the main path's run
    out = generate(bundle, model, prompts, None, fa, ms, cross=cross)
    want_prefill = (attn_prefill, n_ssm)
    want_total = (attn_prefill + attn_step * (GEN_TOKENS - 1), n_ssm)
    if out["after_prefill"] != want_prefill \
            or out["after_decode"] != want_total:
        fail(f"{arch}: kernel launches (attention, scan) "
             f"{out['after_prefill']} after the prefill and "
             f"{out['after_decode']} in all; want {want_prefill} and "
             f"{want_total}")
    if not out["finite"]:
        fail(f"{arch}: non-finite logits")
    if out["ids"].shape != (SERVE_BATCH, GEN_TOKENS):
        fail(f"{arch}: generated ids of shape {tuple(out['ids'].shape)}")
    steps = GEN_TOKENS - 1
    rec = {"arch": arch, "dtype": "bfloat16", "params": n_params,
           "bytes": n_bytes, "init_s": init_s,
           "prefill_s": out["prefill_s"],
           "prefill_tokens_per_s": SERVE_BATCH * prompt_len
           / out["prefill_s"],
           "decode_ms_per_step": out["decode_s"] / steps * 1e3,
           "decode_tokens_per_s": SERVE_BATCH * steps / out["decode_s"],
           "attention_launches": out["after_decode"][0],
           "scan_launches": out["after_decode"][1]}
    print(f"  {arch}: {n_params:,} parameters, {n_bytes / 1e9:.3f} GB; "
          f"init {init_s:.3f} s")
    print(f"  prefill {SERVE_BATCH} x {prompt_len} tokens: "
          f"{out['prefill_s'] * 1e3:.3f} ms ({rec['prefill_tokens_per_s']:.1f}"
          f" tokens/s)")
    print(f"  decode {steps} steps x {SERVE_BATCH} requests: "
          f"{rec['decode_ms_per_step']:.3f} ms a step "
          f"({rec['decode_tokens_per_s']:.1f} tokens/s)")
    print(f"  launches: attention {out['after_prefill'][0]} in the prefill, "
          f"{out['after_decode'][0]} in all; scan {out['after_prefill'][1]} "
          f"in the prefill, {out['after_decode'][1]} in all")
    print(f"  request 0 ids: {out['ids'][0].tolist()}")

    launches = (fa.LAUNCHES, ms.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(bundle, model, prompts, None, fa, ms, n_new=4,
                 cross=cross)
        traced_wall = time.perf_counter() - t0
    fa.LAUNCHES, ms.LAUNCHES = launches
    busy = device_seconds(prof)
    rec["traced_wall_s"], rec["traced_device_busy_s"] = traced_wall, busy
    print(f"  traced prefill + 3 decode steps: wall {traced_wall:.4f} s, "
          f"device busy {busy:.4f} s = {busy / traced_wall * 100:.2f}%")
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    ranked = sorted(dev, key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))
    for rank, e in enumerate(ranked, 1):
        if rank <= 8 or "attn_" in e.key or "selective_scan" in e.key:
            print(f"    device #{rank} {e.key[:70]}: {e.count} calls, "
                  f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        generate(bundle, model, prompts, None, fa, ms, n_new=1, cross=cross)
    fa.LAUNCHES, ms.LAUNCHES = launches
    pre_s = device_seconds(prof)
    own = {"attention": "attn_", "scan": "selective_scan"}
    own_s = {k: sum(getattr(e, "self_device_time_total", 0.0)
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and tag in e.key)
             / 1e6 for k, tag in own.items()}
    rec["traced_prefill_device_s"] = pre_s
    rec.update({f"traced_prefill_{k}_s": v for k, v in own_s.items()})
    print(f"  traced prefill alone: device {pre_s * 1e3:.3f} ms; "
          + "; ".join(f"{k} kernels {v * 1e3:.3f} ms = "
                      f"{v / pre_s * 100:.2f}%" for k, v in own_s.items()))
    if extra is not None:
        extra(bundle, model, prompts, rec, cross)
        fa.LAUNCHES, ms.LAUNCHES = launches
    del model, sd
    release()
    return rec


def layerwise_ab(bundle, model, prompts, cross_src=None):
    """Each layer through the kernels and through the plain versions on
    the same input -- the plain path's hidden state -- for the prefill and
    one decode step (the cross-attention layers over ``cross_src`` in the
    prefill and their caches in the decode step).  Returns the worst share
    of a layer's output elements within AB_ELEM_TOL of its largest
    magnitude, the largest relative difference, and the (request,
    position, layer) rows with an element beyond that tolerance."""
    import torch
    from repro_torch.models.layers import embed
    impls = ("ref", "cuda")
    caches = {impl: bundle.make_cache(prompts.shape[0], S_MAX)
              for impl in impls}
    worst_share, worst_rel, rows_off = 1.0, 0.0, 0
    tokens, pos = prompts, 0
    with torch.no_grad():
        for _ in range(2):                   # the prefill, one decode step
            x = embed(model.embed, tokens)
            src = cross_src if pos == 0 else None
            for i, layer in enumerate(model.stack):
                out = {impl: layer(x, cache=caches[impl][i], pos=pos,
                                   causal=True, impl=impl, cross_src=src)
                       for impl in impls}
                share, rel, off = ab_stats(out)
                worst_share = min(worst_share, share)
                worst_rel = max(worst_rel, rel)
                rows_off += off
                x = out["ref"]
            logits = model._logits(model.final_norm(x[:, -1:]))
            pos += tokens.shape[1]
            tokens = logits[:, -1].argmax(-1, keepdim=True)
    return worst_share, worst_rel, rows_off


def ab_stats(out):
    """One layer's outputs through the kernels and the plain versions:
    the share of elements within AB_ELEM_TOL of the plain output's
    largest magnitude, the largest relative difference, the rows with an
    element beyond it."""
    diff = (out["cuda"] - out["ref"]).abs()
    scale = out["ref"].abs().max()
    off = diff > AB_ELEM_TOL * scale
    return (1.0 - float(off.float().mean()), float(diff.max() / scale),
            int(off.any(-1).sum()))


def ab_phase(arch, fa, ms):
    """Phase 9 for one model: float32 weights through the kernels and
    through the plain versions, layer by layer and free-running."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    has_attention = any(cfg.layer_kind(i) == "attn"
                        for i in range(cfg.n_layers))
    bundle = build_model(cfg, device="cuda", dtype=torch.float32)
    model = bundle.init(SEED)
    prompts = prompts_for(cfg)
    share_l, rel_l, rows_off = layerwise_ab(bundle, model, prompts)
    print(f"  {arch} float32, layer by layer on the same input (prefill + "
          f"1 decode step): worst share of elements within "
          f"{AB_ELEM_TOL} of the scale {share_l * 100:.4f}%, largest "
          f"relative difference {rel_l:.3e}, rows beyond it {rows_off}")
    if share_l < AB_ELEM_SHARE:
        fail(f"{arch} float32: a layer through the kernels disagrees with "
             f"the plain one on {(1 - share_l) * 100:.4f}% of its elements "
             f"(> {(1 - AB_ELEM_SHARE) * 100:.4f}%)")
    runs = {}
    for impl in ("cuda", "ref"):
        generate(bundle, model, prompts[:, :16], impl, fa, ms, n_new=3)
        before = (fa.LAUNCHES, ms.LAUNCHES)
        runs[impl] = out = generate(bundle, model, prompts, impl, fa, ms)
        launched = out["after_decode"] != before
        if launched != (impl == "cuda") or not out["finite"]:
            fail(f"{arch} float32 impl={impl}: kernels launched {launched}, "
                 f"finite logits {out['finite']}")
    a, b = runs["cuda"], runs["ref"]
    rel = float((a["logits"] - b["logits"]).abs().max()
                / b["logits"].abs().max())
    share = float((a["ids"] == b["ids"]).float().mean())
    print(f"  free-running: prefill {a['prefill_s'] * 1e3:.3f} ms with the "
          f"kernels, {b['prefill_s'] * 1e3:.3f} ms plain; decode "
          f"{a['decode_s'] * 1e3:.3f} ms / {b['decode_s'] * 1e3:.3f} ms")
    print(f"  free-running: prefill logits, largest |cuda - ref| / largest "
          f"|ref|: {rel:.3e}; identical greedy tokens: {share * 100:.2f}%"
          + ("" if not has_attention else
             " (printed only: attention makes the random model chaotic)"))
    if not has_attention and (rel > AB_LOGIT_TOL or share < AB_TOKEN_SHARE):
        fail(f"{arch} float32: the kernels' path disagrees with the plain "
             f"one (logit rel err {rel:.3e} > {AB_LOGIT_TOL} or token share "
             f"{share:.4f} < {AB_TOKEN_SHARE})")
    del model
    release()
    return {"arch": arch, "dtype": "float32",
            "layer_share_within": share_l, "layer_max_rel_err": rel_l,
            "layer_rows_beyond": rows_off, "logit_rel_err": rel,
            "token_share": share, "prefill_s": a["prefill_s"],
            "plain_prefill_s": b["prefill_s"], "decode_s": a["decode_s"],
            "plain_decode_s": b["decode_s"]}


def event_engine_phase(core, cc):
    """Phase 10: the event engine on the host and the reference's routing:
    ``auto`` sends a retirement study to the event engine without a
    launch, sends a Weibull-failure study to the CTMC engine, runs a
    Weibull-repair study on the CTMC engine through a slot instance, runs
    a float64-age study on the CTMC engine through float64 launches, and
    the engine repeats itself for a seed."""
    small = core.Params(job_size=8, working_pool_size=12, spare_pool_size=4,
                        warm_standbys=1, job_length=0.5 * DAY,
                        random_failure_rate=1.0 / DAY, seed=2)
    # tests/test_core_simulation.py's retirement config: repairs never
    # heal, so repeat offenders reach the threshold and retire
    retire = core.Params(
        job_size=32, working_pool_size=64, spare_pool_size=32,
        warm_standbys=4, job_length=16 * DAY, seed=123,
        retirement_threshold=2, retirement_window=100 * DAY,
        systematic_failure_fraction=0.5,
        systematic_failure_rate=0.2 / DAY, random_failure_rate=0.01 / DAY,
        auto_repair_failure_probability=1.0,
        manual_repair_failure_probability=1.0, diagnosis_probability=1.0,
        auto_repair_time=5.0, manual_repair_time=10.0)
    t0 = time.perf_counter()
    cc.LAUNCHES = 0
    rep = core.run_replications(retire, 16, engine="auto")
    launches = cc.LAUNCHES
    print(f"  retirement_threshold=2 under engine='auto': engine "
          f"{rep.engine}, {rep.n} replications, total_time "
          f"{rep.stats['total_time'].mean:.3f} min, n_retired "
          f"{rep.stats['n_retired'].mean:.3f}, chunk launches {launches}")
    if rep.engine != "event" or launches or len(rep.results) != 16:
        fail(f"retirement study ran on {rep.engine} with {launches} chunk "
             "launches; the reference runs it on its event engine")
    if rep.stats["n_retired"].mean <= 0:
        fail("the retirement study retired no server")
    if rep.stats["completed"].mean != 1.0 \
            or any(math.isinf(st.mean) for st in rep.stats.values()):
        fail("the event engine's retirement study did not complete")
    weibull = small.replace(failure_distribution="weibull",
                            distribution_kwargs={"k": 1.5})
    engine = core.resolve_engine(weibull, "auto")
    print(f"  weibull failures under engine='auto': {engine}")
    if engine != "ctmc":
        fail(f"engine='auto' sends a Weibull-failure study to {engine}; the "
             "reference runs it on its CTMC engine")
    before = cc.LAUNCHES_BY_REPAIR["weibull"]
    rep = core.run_replications(
        weibull.replace(repair_distribution="weibull"), 64, engine="auto")
    slot_launches = cc.LAUNCHES_BY_REPAIR["weibull"] - before
    print(f"  weibull repairs under engine='auto': engine {rep.engine}, "
          f"{slot_launches} slot-instance launches, completed "
          f"{rep.stats['completed'].mean:.4f}, n_auto_repairs "
          f"{rep.stats['n_auto_repairs'].mean:.3f}")
    if rep.engine != "ctmc" or slot_launches <= 0 \
            or rep.stats["completed"].mean != 1.0:
        fail(f"engine='auto' ran a Weibull-repair study on {rep.engine} with "
             f"{slot_launches} slot-instance launches; the reference runs "
             "it on its CTMC engine")
    before = cc.LAUNCHES_BY_AGE["float64"]
    rep = core.run_replications(
        weibull.replace(age_dtype="float64"), 64, engine="auto")
    age64_launches = cc.LAUNCHES_BY_AGE["float64"] - before
    print(f"  age_dtype='float64' under engine='auto': engine {rep.engine}, "
          f"{age64_launches} float64 launches, completed "
          f"{rep.stats['completed'].mean:.4f}, n_failures "
          f"{rep.stats['n_failures'].mean:.3f}")
    if rep.engine != "ctmc" or age64_launches <= 0 \
            or rep.stats["completed"].mean != 1.0:
        fail(f"engine='auto' ran a float64-age study on {rep.engine} with "
             f"{age64_launches} float64 launches; the reference runs it on "
             "its CTMC engine")
    a = [r.to_dict() for r in core.simulate(small, 4, base_seed=11)]
    b = [r.to_dict() for r in core.simulate(small, 4, base_seed=11)]
    if a != b:
        fail("simulate with the same seed gave different RunResults")
    secs = time.perf_counter() - t0
    print(f"  simulate twice with seed 11: identical RunResults "
          f"({len(a)} replications); phase {secs:.3f} s")
    return {"seconds": secs}


def parity_phase(core, cc):
    """Phase 11: the CTMC engine on the card (chunk kernel) against the
    event engine on the host, on tests/test_vectorized.py's configs."""
    out = {}
    t0 = time.perf_counter()
    for name, (kw, days, per_days, metrics) in PARITY_CONFIGS.items():
        p = core.Params(job_length=days * DAY,
                        random_failure_rate=per_days / DAY, **kw)
        cc.LAUNCHES = 0
        t1 = time.perf_counter()
        ct = core.simulate_ctmc(p, n_replicas=PARITY_CTMC, seed=0,
                                device="cuda")
        ctmc_s = time.perf_counter() - t1
        launches = cc.LAUNCHES
        t1 = time.perf_counter()
        ev = core.simulate(p, PARITY_EVENT)
        event_s = time.perf_counter() - t1
        if launches <= 0 or ct["completed"].mean() <= 0.99:
            fail(f"parity {name}: {launches} chunk launches, completed "
                 f"{ct['completed'].mean():.4f}")
        zs = parity_z(ct, ev, metrics)
        print(f"  {name}: CTMC {PARITY_CTMC} replicas on the card "
              f"{ctmc_s:.3f} s ({launches} chunk launches), event "
              f"{PARITY_EVENT} on the host {event_s:.3f} s; z: "
              + ", ".join(f"{m} {z:+.3f}" for m, z in zs.items()))
        worst = max(abs(z) for z in zs.values())
        if worst >= PARITY_Z:
            fail(f"parity {name}: |z| = {worst:.3f} >= {PARITY_Z}")
        out[name] = {"launches": launches, "max_abs_z": worst}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.3f} s")
    return out


def optimizer_phase(core, cc):
    """Phase 12: optimize_checkpoint_interval on the card, twice: the same
    search both times, within one grid notch of Young/Daly."""
    import torch
    from repro_torch.core.optimize import optimize_checkpoint_interval
    p = core.Params(job_length=4 * DAY, random_failure_rate=0.2 / DAY,
                    **OPT_CONFIG)
    runs = []
    for _ in range(2):
        cc.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize_checkpoint_interval(
            p, n_replicas=OPT_REPLICAS, n_grid=OPT_GRID,
            refine_iters=OPT_REFINE, device="cuda")
        torch.cuda.synchronize()
        runs.append((res, cc.LAUNCHES, time.perf_counter() - t0))
    for res, launches, secs in runs:
        print(f"  interval {res.interval:.6f} min (Young/Daly "
              f"{res.young_daly:.6f}), objective {res.objective:.9f}, "
              f"n_evals {res.n_evals}, {len(res.history)} refinements, "
              f"chunk launches {launches}, wall {secs:.3f} s")
    (res, launches, secs), (again, launches2, _) = runs
    if again != res or launches2 != launches:
        fail("the optimizer's second run differs from its first "
             f"({again.objective} vs {res.objective})")
    if launches <= 0 or res.n_evals != OPT_GRID + 2 * len(res.history):
        fail(f"optimizer: {launches} chunk launches, n_evals {res.n_evals}")
    notch = (res.grid[1] / res.grid[0]) ** 1.5
    if not (res.young_daly / notch <= res.interval
            <= res.young_daly * notch):
        fail(f"optimizer interval {res.interval} is not within one notch "
             f"of Young/Daly {res.young_daly}")
    # a third call under torch.profiler: where the optimizer's time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimize_checkpoint_interval(p, n_replicas=OPT_REPLICAS,
                                     n_grid=OPT_GRID,
                                     refine_iters=OPT_REFINE, device="cuda")
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    dev_s = device_seconds(prof)
    chunk_s = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and "ctmc_chunk_kernel" in e.key) / 1e6
    print(f"  traced call: wall {traced_s:.6f} s, device busy "
          f"{dev_s:.6f} s = {dev_s / traced_s * 100:.2f}%, chunk kernel "
          f"{chunk_s * 1e3:.6f} ms")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"    host {e.key}: {e.count} calls, self "
              f"{e.self_cpu_time_total / 1e3:.1f} ms")
    return {"launches": launches, "n_evals": res.n_evals,
            "interval": res.interval, "young_daly": res.young_daly,
            "wall_s": [r[2] for r in runs], "traced_wall_s": traced_s,
            "traced_device_busy_s": dev_s, "traced_chunk_kernel_s": chunk_s,
            "seconds": sum(r[2] for r in runs) + traced_s}


def experiment_phase(core, cc):
    """Phase 13: a json experiment file through load_experiment on the
    card (tests/test_sweeps.py's spec, more replications)."""
    import tempfile
    spec = {"base_params": {"job_size": 16, "working_pool_size": 22,
                            "spare_pool_size": 4, "warm_standbys": 2,
                            "job_length": 0.25 * DAY},
            "n_replications": 256,
            "sweeps": [{"title": "recovery", "parameter": "recovery_time",
                        "values": [10, 20]},
                       {"title": "grid", "parameter_a": "recovery_time",
                        "values_a": [10], "parameter_b": "warm_standbys",
                        "values_b": [0, 2]}]}
    t0 = time.perf_counter()
    cc.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "experiment.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        results = [sweep.run() for sweep in core.load_experiment(path)]
    launches, secs = cc.LAUNCHES, time.perf_counter() - t0
    points = [pt for res in results for pt in res.points]
    if len(points) != 4 or {pt.engine for pt in points} != {"ctmc"} \
            or launches <= 0:
        fail(f"experiment file: {len(points)} points on "
             f"{ {pt.engine for pt in points} }, {launches} chunk launches")
    for res in results:
        for row in res.to_rows():
            if not math.isfinite(row["total_time"]) \
                    or row["n_incomplete"] != 0.0:
                fail(f"experiment file: row {row} is not finite or "
                     "complete")
            print(f"  {res.name}: " + ", ".join(
                f"{k}={row[k]}" for k in res.parameter_names)
                + f": total_time {row['total_time']:.3f} min, "
                f"n_failures {row['n_failures']:.3f}")
    print(f"  {len(points)} points, {launches} chunk launches, "
          f"{secs:.3f} s")
    return {"launches": launches, "seconds": secs}


def family_launches(cc, hazards, p):
    """(counter, key) of the launches of ``p``'s instance: by repair
    family for a slot instance, else by failure family."""
    rkind = hazards.repair_kind(p)
    return ((cc.LAUNCHES_BY_REPAIR, rkind) if rkind != "exponential"
            else (cc.LAUNCHES_BY_KIND, hazards.hazard_kind(p)))


def family_phase(core, cc, vectorized, name, overrides, twin=False):
    """Phase 14 for one failure family (phase 16 for one repair family):
    phase 5's sweep under ``overrides``, through ``OneWaySweep`` on the
    card, with the launch counts set to 0 just before and read just after;
    every replica must complete with servers conserved and no slot-lane
    overflow.  Then the kernel against the plain step loop on the sweep's
    first chunk (chunk_phase) and the sweep again under torch.profiler.
    A ``twin`` (phase 22's float32 twin, which only lends its final state
    and its time a launch) skips the plain loop's timing and the traced
    sweep."""
    import torch

    from repro_torch.core import hazards
    base = core.Params(job_length=JOB_DAYS * DAY, **overrides)
    kind, rkind = core.hazard_kind(base), hazards.repair_kind(base)
    counter, key = family_launches(cc, hazards, base)
    sweep = core.OneWaySweep(f"{name} warm standbys", "warm_standbys",
                             SWEEP_VALUES, n_replications=N_REPLICAS,
                             base_params=base, device="cuda")
    run, restore = capture_final_states(vectorized)
    try:
        zero_counts(cc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, steps = counter[key], cc.STEPS
        others = cc.LAUNCHES - launches
    finally:
        restore()
    if key != name or launches <= 0 or others \
            or launches != run["chunks"] or steps != run["steps"]:
        fail(f"{name}: family {key}, {launches} launches of its instance "
             f"({others} of others), {steps} steps, for {run['chunks']} "
             f"chunks of {run['steps']} steps")
    if len(run["states"]) != 1:
        fail(f"{name}: expected one batch, got {len(run['states'])}")
    final = run["states"][0]
    for j, (v, pt) in enumerate(zip(SWEEP_VALUES, res.points)):
        st = pt.stats
        if st["completed"].mean != 1.0 or pt.engine != "ctmc":
            fail(f"{name} warm_standbys={v}: {st['completed'].mean:.4f} "
                 f"completed on {pt.engine}")
        for m, stat in st.items():
            if not math.isfinite(stat.mean):
                fail(f"{name} warm_standbys={v}: {m} is not finite")
        rows = slice(j * N_REPLICAS, (j + 1) * N_REPLICAS)
        total = sum(final[k][rows].sum(-1) for k in
                    ("run", "sb", "fw", "fs", "auto", "man"))
        if not bool((total == base.working_pool_size
                     + base.spare_pool_size).all()):
            fail(f"{name} warm_standbys={v}: servers not conserved")
        print(f"  {name} warm_standbys={v}: total_time "
              f"{st['total_time'].mean:.1f} min, n_failures "
              f"{st['n_failures'].mean:.2f}, goodput {st['goodput'].mean:.5f}")
    overflow = float(final["n_repair_overflow"].sum())
    n_slots = final["repair_rem"].shape[1] if "repair_rem" in final else 0
    print(f"  {name}: {launches} launches, {steps} steps, sweep wall "
          f"{wall:.6f} s ({steps / wall:.1f} steps/s), every replica "
          f"completed; repair-slot lane {n_slots} slots, overflows "
          f"{overflow:.0f}")
    if overflow:
        fail(f"{name}: {overflow:.0f} diagnosed failures found the "
             f"{n_slots}-slot repair lane full")
    t = chunk_phase(cc, vectorized, run["calls"][0], time_plain=not twin)
    if t["bit_different"]:
        fail(f"{name}: the first chunk differs from the plain loop in "
             f"{t['bit_different']} float elements")
    t["sweep_ms_per_launch"] = None
    if not twin:
        chunk_ms, traced = traced_chunk_ms(cc, sweep.run, counter, key)
        t["sweep_ms_per_launch"] = chunk_ms / max(traced, 1)
        print(f"  {name}: chunk kernel over the traced sweep {chunk_ms:.6f}"
              f" ms in {traced} launches = {t['sweep_ms_per_launch']:.6f} ms"
              f" a launch; bound {t['bound_ms']:.6f} ms on the first chunk "
              f"({t['live_rows']} live rows)")
    return dict(t, kind=kind, rkind=rkind, launches=launches, steps=steps,
                wall_s=wall, final=final, base=base, overflow=overflow)


def nonexp_parity_phase(core, cc, table):
    """Phase 15 (phase 17 with ``REPAIR_PARITY``): each family's CTMC run
    on the card against the port's event engine on the host, every
    compared mean within |z| < 3.5, and no slot-lane overflow."""
    from repro_torch.core import hazards
    out = {}
    t0 = time.perf_counter()
    for name, (kw, metrics) in table.items():
        p = core.Params(**NONEXP_BASE, **kw)
        counter, kind = family_launches(cc, hazards, p)
        before = counter[kind]
        t1 = time.perf_counter()
        ct = core.simulate_ctmc(p, n_replicas=NONEXP_CTMC, seed=0,
                                device="cuda")
        ctmc_s = time.perf_counter() - t1
        launches = counter[kind] - before
        t1 = time.perf_counter()
        ev = core.simulate(p, NONEXP_EVENT)
        event_s = time.perf_counter() - t1
        if launches <= 0 or ct["completed"].mean() <= 0.99 \
                or ct["n_repair_overflow"].sum() != 0:
            fail(f"parity {name}: {launches} {kind} launches, completed "
                 f"{ct['completed'].mean():.4f}, overflows "
                 f"{ct['n_repair_overflow'].sum():.0f}")
        zs = parity_z(ct, ev, metrics)
        print(f"  {name}: CTMC {NONEXP_CTMC} replicas on the card "
              f"{ctmc_s:.3f} s ({launches} {kind} launches), event "
              f"{NONEXP_EVENT} on the host {event_s:.3f} s; z: "
              + ", ".join(f"{m} {z:+.3f}" for m, z in zs.items()))
        worst = max(abs(z) for z in zs.values())
        if worst >= PARITY_Z:
            fail(f"parity {name}: |z| = {worst:.3f} >= {PARITY_Z}")
        out[name] = {"launches": launches, "max_abs_z": worst,
                     "ctmc_s": ctmc_s, "event_s": event_s}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase {out['seconds']:.3f} s")
    return out


def scenario_launches(cc, kind):
    """Launches of ``kind``'s scenario instance, and of every other."""
    mine = cc.LAUNCHES_BY_SCEN[kind]
    return mine, cc.LAUNCHES - mine


def check_scenario_state(final, rows, label, total):
    """Servers conserved over every pool, and each row's per-domain shock
    counts summing to its shock counter."""
    import torch
    pools = sum(final[k][rows].sum(-1) for k in
                ("run", "sb", "fw", "fs", "auto", "man"))
    if not bool((pools == total).all()):
        fail(f"{label}: servers not conserved ({float(pools.min())}.."
             f"{float(pools.max())} != {total})")
    if "domain_shocks" in final and not torch.equal(
            final["domain_shocks"][rows].sum(-1),
            final["n_domain_shocks"][rows]):
        fail(f"{label}: per-domain shock counts do not sum to "
             "n_domain_shocks")


def plain_identity(label, final, final_ref):
    """A run's final state through the chunk kernel against the plain step
    loop's on the same uniforms: 0 bit-different elements, or fail."""
    frac, hist_same, worst_rel, bits = sweep_identity(final, final_ref)
    print(f"  {label} through the plain step loop: replicas with identical "
          f"integer metrics {frac * 100:.3f}%; histograms identical "
          f"{hist_same}; float lanes: largest relative difference "
          f"{worst_rel:.3e}, bit-different elements {bits}")
    if frac < 1.0 or not hist_same or bits:
        fail(f"{label} through the chunk kernel differs from the plain "
             f"loop ({bits} bit-different float elements)")
    return {"identical_share": frac, "bit_different": bits}


def shock_sweep_phase(core, cc, vectorized):
    """Phase 18: examples/capacity_planning.py's rack-outage sweep at
    Table-I width through ``OneWaySweep`` over ``rack_shock_rate`` on the
    card, the counts set to 0 just before and read just after: every
    launch the exponential scenario instance's, every replica complete,
    servers conserved, shocks growing with the rate.  Then the first chunk
    against the plain step loop, the sweep traced, the whole sweep through
    the plain step loop (0 bit-different elements), and the rate-0 point
    against a scenario-free Table-I run with the same seed, lane for
    lane."""
    import torch
    topo = core.FaultTopology(n_racks=SHOCK_RACKS,
                              racks_per_pod=SHOCK_RACKS_PER_POD)
    base = core.Params(job_length=SHOCK_DAYS * DAY, fault_domains=topo)
    total = base.working_pool_size + base.spare_pool_size
    print(f"  {topo.n_domains} fault domains, {total // SHOCK_RACKS} "
          f"servers a rack")

    def sweep(params):
        return core.OneWaySweep("rack outages", "rack_shock_rate",
                                SHOCK_RATES, n_replications=N_REPLICAS,
                                base_params=params, device="cuda")

    run, restore = capture_final_states(vectorized)
    try:
        zero_counts(cc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep(base).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, others = scenario_launches(cc, "exponential")
        steps = cc.STEPS
    finally:
        restore()
    print(f"  {launches} launches of the exponential scenario instance "
          f"({others} of others), {steps} steps; chunks run {run['chunks']}"
          f", steps run {run['steps']}; sweep wall {wall:.6f} s "
          f"({steps / wall:.1f} steps/s)")
    if launches <= 0 or others or launches != run["chunks"] \
            or steps != run["steps"] or len(run["states"]) != 1:
        fail("the rack-outage sweep did not run one batch through the "
             "exponential scenario instance alone")
    final = run["states"][0]
    shocks = []
    for j, (v, pt) in enumerate(zip(SHOCK_RATES, res.points)):
        st = pt.stats
        if st["completed"].mean != 1.0 or pt.engine != "ctmc":
            fail(f"rack_shock_rate={v}: {st['completed'].mean:.4f} "
                 f"completed on {pt.engine}")
        for m, stat in st.items():
            if not math.isfinite(stat.mean):
                fail(f"rack_shock_rate={v}: {m} is not finite")
        rows = slice(j * N_REPLICAS, (j + 1) * N_REPLICAS)
        check_scenario_state(final, rows, f"rack_shock_rate={v}", total)
        shocks.append(st["n_domain_shocks"].mean)
        print(f"  rack_shock_rate={v}: shocks {st['n_domain_shocks'].mean:.4f}"
              f", servers killed {st['n_shock_killed'].mean:.3f}, "
              f"total_time {st['total_time'].mean:.1f} min, stall_time "
              f"{st['stall_time'].mean:.2f}, preemptions "
              f"{st['n_preemptions'].mean:.3f}, goodput "
              f"{st['goodput'].mean:.5f}")
    if shocks[0] != 0.0 or not all(a < b for a, b in zip(shocks, shocks[1:])):
        fail(f"mean shocks {shocks} do not start at 0 and grow with the rate")
    t = chunk_phase(cc, vectorized, run["calls"][0])
    if t["bit_different"]:
        fail(f"the first chunk differs from the plain loop in "
             f"{t['bit_different']} float elements")
    chunk_ms, traced = traced_chunk_ms(cc, lambda: sweep(base).run(),
                                       cc.LAUNCHES_BY_SCEN, "exponential")
    t["sweep_ms_per_launch"] = chunk_ms / max(traced, 1)
    print(f"  chunk kernel over the traced sweep {chunk_ms:.6f} ms in "
          f"{traced} launches = {t['sweep_ms_per_launch']:.6f} ms a launch;"
          f" bound {t['bound_ms']:.6f} ms on the first chunk")
    ref_run, restore = capture_final_states(vectorized)
    try:
        counts = save_counts(cc)
        t0 = time.perf_counter()
        sweep(base.replace(event_race_impl="ref")).run()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    finally:
        restore()
    if save_counts(cc) != counts:
        fail("impl='ref' launched the chunk kernel")
    print(f"  the plain step loop: wall {plain_wall:.3f} s "
          f"({ref_run['steps']} steps)")
    identity = plain_identity("the rack-outage sweep", final,
                              ref_run["states"][0])
    free_run, restore = capture_final_states(vectorized)
    try:
        counts = save_counts(cc)
        rep = core.run_replications(base.replace(fault_domains=None),
                                    N_REPLICAS, base_seed=0, device="cuda")
        restore_counts(cc, counts)
    finally:
        restore()
    if rep.engine != "ctmc" or rep.stats["completed"].mean != 1.0:
        fail("the scenario-free run did not complete on the CTMC engine")
    free = free_run["states"][0]
    rows = slice(0, N_REPLICAS)
    differ = {k: int((final[k][rows] != v).reshape(N_REPLICAS, -1)
                     .any(-1).sum())
              for k, v in free.items() if k not in ("hist_edges",)}
    differ = {k: n for k, n in differ.items() if n}
    print(f"  rate-0 point against the scenario-free Table-I run (seed 0): "
          f"{len(free) - 1} lanes compared, lanes that differ: "
          f"{differ or 'none'}; scenario lanes: shocks "
          f"{float(final['n_domain_shocks'][rows].sum()):.0f}, deficit "
          f"{float(final['deficit'][rows].sum()):.0f}")
    if differ:
        fail(f"the rate-0 point differs from the scenario-free run in "
             f"{differ}")
    return dict(t, launches=launches, steps=steps, wall_s=wall,
                plain_wall_s=plain_wall, plain_identity=identity,
                rate0_lanes_differing=0, mean_shocks=shocks)


def campaign_base(core, overrides):
    """Phase 19's scenario at Table-I width under ``overrides``'s failure
    family."""
    length = CAMPAIGN_DAYS * DAY
    return core.Params(
        job_length=length, **overrides,
        fault_domains=core.FaultTopology(
            n_racks=SHOCK_RACKS, racks_per_pod=SHOCK_RACKS_PER_POD,
            **CAMPAIGN_RATES),
        campaign=core.Campaign(events=(
            core.CampaignEvent(time=0.25 * length, kind="kill", domain=3),
            core.CampaignEvent(time=0.5 * length, kind="maintenance",
                               duration=0.05 * length))))


def campaign_phase(core, cc, vectorized, name, overrides):
    """Phase 19 for one failure family: the scripted campaign at Table-I
    width through ``run_replications`` on the card, the counts set to 0
    just before and read just after: every launch the family's scenario
    instance's, every replica complete with its three schedule entries,
    servers conserved; then the first chunk against the plain step loop
    and the run traced.  For lognormal failures the whole run through the
    plain step loop too (0 bit-different elements)."""
    import torch
    p = campaign_base(core, overrides)
    kind = core.hazard_kind(p)
    total = p.working_pool_size + p.spare_pool_size
    run, restore = capture_final_states(vectorized)
    try:
        zero_counts(cc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = core.run_replications(p, N_REPLICAS, base_seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, others = scenario_launches(cc, kind)
        steps = cc.STEPS
    finally:
        restore()
    st = rep.stats
    print(f"  {name}: engine {rep.engine}, {launches} launches of its "
          f"scenario instance ({others} of others), {steps} steps, wall "
          f"{wall:.6f} s; campaign entries {st['n_campaign_events'].mean:.3f}"
          f", shocks {st['n_domain_shocks'].mean:.4f}, servers killed "
          f"{st['n_shock_killed'].mean:.3f}, total_time "
          f"{st['total_time'].mean:.1f} min, goodput {st['goodput'].mean:.5f}")
    if rep.engine != "ctmc" or launches <= 0 or others \
            or launches != run["chunks"] or steps != run["steps"]:
        fail(f"{name}: the campaign did not run through its scenario "
             "instance alone")
    if st["completed"].mean != 1.0 \
            or not (rep.arrays["n_campaign_events"] == 3).all():
        fail(f"{name}: not every replica completed with its 3 campaign "
             "entries")
    final = run["states"][0]
    check_scenario_state(final, slice(None), name, total)
    t = chunk_phase(cc, vectorized, run["calls"][0])
    if t["bit_different"]:
        fail(f"{name}: the first chunk differs from the plain loop in "
             f"{t['bit_different']} float elements")
    chunk_ms, traced = traced_chunk_ms(
        cc, lambda: core.run_replications(p, N_REPLICAS, base_seed=0),
        cc.LAUNCHES_BY_SCEN, kind)
    t["sweep_ms_per_launch"] = chunk_ms / max(traced, 1)
    print(f"  {name}: chunk kernel over the traced run {chunk_ms:.6f} ms in "
          f"{traced} launches = {t['sweep_ms_per_launch']:.6f} ms a launch; "
          f"bound {t['bound_ms']:.6f} ms on the first chunk")
    out = dict(t, kind=kind, launches=launches, steps=steps, wall_s=wall,
               final=final)
    if name == "lognormal":
        ref_run, restore = capture_final_states(vectorized)
        try:
            counts = save_counts(cc)
            t0 = time.perf_counter()
            core.run_replications(p.replace(event_race_impl="ref"),
                                  N_REPLICAS, base_seed=0)
            torch.cuda.synchronize()
            out["plain_wall_s"] = time.perf_counter() - t0
        finally:
            restore()
        if save_counts(cc) != counts:
            fail("impl='ref' launched the chunk kernel")
        out["plain_identity"] = plain_identity(
            f"the {name} campaign run ({ref_run['steps']} steps, "
            f"{out['plain_wall_s']:.3f} s)", final, ref_run["states"][0])
    return out


def scenario_parity_phase(core, cc):
    """Phase 19's run parity: tests/test_faultdomains.py's SCENARIO (rack
    and pod shocks, a kill, a maintenance window) on the CTMC engine on
    the card against the port's event engine on the host, every compared
    mean within |z| < 3.5."""
    p = core.Params(**SCEN_PARITY_BASE).replace(
        fault_domains=core.FaultTopology(n_racks=4, racks_per_pod=2,
                                         rack_shock_rate=1.2e-4,
                                         pod_shock_rate=3e-5),
        campaign=core.Campaign(events=(
            core.CampaignEvent(time=400.0, kind="kill", domain=2),
            core.CampaignEvent(time=900.0, kind="maintenance",
                               duration=300.0))))
    before = cc.LAUNCHES_BY_SCEN["exponential"]
    t0 = time.perf_counter()
    ct = core.simulate_ctmc(p, n_replicas=SCEN_PARITY_CTMC, seed=6,
                            device="cuda")
    ctmc_s = time.perf_counter() - t0
    launches = cc.LAUNCHES_BY_SCEN["exponential"] - before
    t0 = time.perf_counter()
    ev = core.simulate(p, SCEN_PARITY_EVENT, base_seed=5)
    event_s = time.perf_counter() - t0
    if launches <= 0 or ct["completed"].mean() <= 0.99:
        fail(f"scenario parity: {launches} launches, completed "
             f"{ct['completed'].mean():.4f}")
    zs = parity_z(ct, ev, SCEN_PARITY_METRICS)
    print(f"  SCENARIO: CTMC {SCEN_PARITY_CTMC} replicas on the card "
          f"{ctmc_s:.3f} s ({launches} launches), event {SCEN_PARITY_EVENT} "
          f"on the host {event_s:.3f} s; z: "
          + ", ".join(f"{m} {z:+.3f}" for m, z in zs.items()))
    worst = max(abs(z) for z in zs.values())
    if worst >= PARITY_Z:
        fail(f"scenario parity: |z| = {worst:.3f} >= {PARITY_Z}")
    return {"launches": launches, "max_abs_z": worst, "ctmc_s": ctmc_s,
            "event_s": event_s}


def bit_different(a, b):
    """(elements whose bits differ, elements, arrays) between two lists of
    multi-job point dicts: every per-job array and every cluster lane."""
    import numpy as np
    pairs = []
    for pa, pb in zip(a, b):
        pairs += [(pa[k], pb[k]) for k in pa if k != "per_job"]
        for da, db in zip(pa["per_job"], pb["per_job"]):
            if sorted(da) != sorted(db):
                fail(f"point lanes differ: {sorted(da)} vs {sorted(db)}")
            pairs += [(da[k], db[k]) for k in da]
    n = total = 0
    for x, y in pairs:
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"lane shapes differ: {x.shape} {x.dtype} vs {y.shape} "
                 f"{y.dtype}")
        bits = f"u{x.itemsize}"
        n += int((x.view(bits) != y.view(bits)).sum())
        total += x.size
    return n, total, len(pairs)


def save_mj_counts(mjc):
    """The multi-job chunk kernel's launch counters, to put back after
    launches made only to compare or time."""
    return mjc.LAUNCHES, mjc.STEPS, dict(mjc.LAUNCHES_BY_J), mjc.LAUNCHES_RT


def restore_mj_counts(mjc, counts):
    mjc.LAUNCHES, mjc.STEPS = counts[:2]
    mjc.LAUNCHES_BY_J.update(counts[2])
    mjc.LAUNCHES_RT = counts[3]


def zero_mj_counts(mjc):
    """Every launch counter of the multi-job chunk kernel to 0."""
    restore_mj_counts(mjc, (0, 0, dict.fromkeys(mjc.LAUNCHES_BY_J, 0), 0))


def capture_mj_chunks(vmj, vectorized, mjc, keep=None):
    """Wrap the multi-job chunk loop and the chunk seeding to count the
    chunks and steps the loop runs, and the kernel's wrapper to keep chunk
    ``keep``'s inputs (cloned before its launch).  Returns (record,
    restore): record["chunks"], record["steps"], record["calls"] (each
    loop call's arguments) and record["kept"] (state, draw, pv, R, P, J,
    channels), or None."""
    record = {"chunks": 0, "steps": 0, "calls": [], "kept": None, "i": None}
    orig = (vmj._mj_chunk_loop, vectorized._chunk_seed, mjc.mj_chunk_cuda)

    def loop(*args, **kwargs):
        record["calls"].append(args)
        record["plan"] = args[4:7]
        return orig[0](*args, **kwargs)

    def seed(seed_, i):
        # one call a chunk; chunk n_chunks is the remainder
        chunk, n_chunks, rem = record["plan"]
        record["chunks"] += 1
        record["steps"] += chunk if i < n_chunks else rem
        record["i"] = i
        return orig[1](seed_, i)

    def kernel(state, us, pv, R, P, J, channels, **kwargs):
        if keep is not None and record["i"] == keep:
            record["kept"] = ({k: v.clone() for k, v in state.items()},
                              us.clone(), pv, R, P, J, tuple(channels))
        return orig[2](state, us, pv, R, P, J, channels, **kwargs)

    vmj._mj_chunk_loop, vectorized._chunk_seed = loop, seed
    mjc.mj_chunk_cuda = kernel

    def restore():
        vmj._mj_chunk_loop, vectorized._chunk_seed, mjc.mj_chunk_cuda = orig
    return record, restore


def mj_step_ops(J: int) -> int:
    """float32 operations a live row-step of the multi-job chunk kernel: the
    race's sum, cumsum, product test and compare over 16J lanes, the 16J
    rates' products, the per-job progress and timer loop, the conservation
    sum over the 20J compartment counts, and the event's own ~48."""
    return 4 * 16 * J + 8 * J + 6 * J + 20 * J + 48


def mj_chunk_bound_ms(row_steps, uniform_rows, live_rows, J, param_rows,
                      n_edges, hist_adds, ring_writes):
    """Least time for one multi-job chunk launch on these inputs, reckoned
    as chunk_bound_ms: the launch's unique uniform rows (``uniform_rows``
    rows of 40 B: a step's distinct replicas among its live rows), each
    live row's state read and written once ((38 J + 15) words: the five
    (J, 4) blocks, the pools, the per-job lanes, metrics, phase and run
    count, the clock and the cluster counters) and its fleet size read,
    each parameter row read once (14 + J columns), the bin edges, each
    histogram bin added to (read and written) and each ring slot written;
    mj_step_ops(J) float32 operations a live row-step (``row_steps``) at
    the float32 peak."""
    nbytes = (uniform_rows * 40 + live_rows * (2 * 4 * (38 * J + 15) + 4)
              + param_rows * (14 + J) * 4 + 4 * n_edges + 8 * hist_adds
              + 4 * ring_writes)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = row_steps * mj_step_ops(J) / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def mj_state_bits(got, want):
    """(bit-different elements, largest absolute difference of a finite
    float lane) between two multi-job states; fails if their infinities
    differ."""
    import torch
    bits, err = 0, 0.0
    for k, w in want.items():
        g = got[k]
        if not w.dtype.is_floating_point:
            bits += int((g != w).sum())
            continue
        bits += int((g.view(torch.int32) != w.view(torch.int32)).sum())
        if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
            fail(f"multi-job chunk: infinities differ in {k}")
        fin = torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    return bits, err


def mj_chunk_check(mjc, vmj, ref, kept, label):
    """The multi-job chunk kernel on a captured chunk (its input state,
    draw and parameters) against the plain step loop (``_mj_steps`` with
    ``impl="ref"``), every lane bit for bit, the plain race's inputs kept
    at the chunk's middle step; then the kernel's device time a launch,
    the plain loop's times and the launch's bound from the work this
    chunk's data needs."""
    state, us, pv, R, P, J, ch = kept
    n_steps = us.shape[0]
    counts = save_mj_counts(mjc)
    runtime = mjc.runtime_for(J)
    got = mjc.mj_chunk_cuda(state, us, pv, R, P, J, ch, runtime=runtime)
    # the plain loop a step at a time, counting the live rows each step and
    # keeping the plain race's inputs at the middle step
    orig_race = ref.event_race_ref
    sample = {}

    def race(*args):
        if "step" in sample and "args" not in sample:
            sample["args"] = [t.clone() for t in args]
        return orig_race(*args)

    want, row_steps, uniform_rows = state, 0, 0
    ref.event_race_ref = race
    try:
        for k in range(n_steps):
            live = (want["phase"] != vmj.DONE).any(-1)
            row_steps += int(live.sum())
            uniform_rows += int(live.view(P, R).any(0).sum())
            if k == n_steps // 2:
                sample["step"] = k
            want = vmj._mj_steps(want, us[k:k + 1], pv, R, P, J, "ref", ch)
    finally:
        ref.event_race_ref = orig_race
    bits, err = mj_state_bits(got, want)
    live_rows = int((state["phase"] != vmj.DONE).any(-1).sum())
    print(f"  {label}: {got['phase'].shape[0]} rows ({live_rows} live), J="
          f"{J}, {n_steps} steps: bit-different elements against the plain "
          f"loop {bits} (max abs err {err:.3e})")
    if bits:
        fail(f"{label}: the multi-job chunk kernel differs from the plain "
             f"loop in {bits} elements")

    def launch():
        return mjc.mj_chunk_cuda(state, us, pv, R, P, J, ch, runtime=runtime)

    split = device_kernels_ms(launch, 20)
    n_edges = state["hist_edges"].numel() if "hist_edges" in state else 0
    t = {"bit_different": bits, "max_abs_err": err,
         "race_args": sample.get("args"), "race_step": sample.get("step"),
         "ms": sum(ms for name, ms in split if "mj_chunk_kernel" in name)
         or None, "rows_per_block": (mjc.rt_plan(J, n_edges)["rows"]
                                     if runtime
                                     else mjc.rows_per_block(J, n_edges))}
    t["call_ms"] = event_ms(launch, 50, warmup=5)
    t["plain_ms"] = device_ms(lambda: vmj._mj_steps(
        state, us, pv, R, P, J, "ref", ch), 1)
    t["plain_call_ms"] = event_ms(lambda: vmj._mj_steps(
        state, us, pv, R, P, J, "ref", ch), 1, warmup=1)
    restore_mj_counts(mjc, counts)
    hist_adds = int((want["hist"] - state["hist"]).sum()) \
        if "hist" in want else 0
    ring = int((want["n_runs"] - state["n_runs"]).sum()) \
        if want["run_durations"].shape[2] else 0
    t["bound_ms"], t["bound_by"] = mj_chunk_bound_ms(
        row_steps, uniform_rows, live_rows, J,
        1 if pv.ndim == 1 else live_rows, n_edges, hist_adds, ring)
    t.update(live_rows=live_rows, row_steps=row_steps,
             uniform_rows=uniform_rows, hist_adds=hist_adds,
             ring_writes=ring)
    t["ms_per_step"] = None if t["ms"] is None else t["ms"] / n_steps
    print(f"  {label}: kernel device {t['ms']} ms a launch at "
          f"{t['rows_per_block']} rows a block, host-clocked "
          f"{t['call_ms']:.6f} ms a call; plain step loop {t['plain_ms']} ms "
          f"device, {t['plain_call_ms']:.6f} ms host-clocked; bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_by']}; {row_steps} live "
          f"row-steps, {uniform_rows} uniform rows, {hist_adds} bin adds, "
          f"{ring} ring writes)")
    return t


def traced_mj_sweep(mjc, fn):
    """(wall s, device busy s, device kernels and copies, the multi-job
    chunk kernel's device ms, its launches, top device events) of ``fn``
    under torch.profiler; the kernel's counters are put back."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    counts = save_mj_counts(mjc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mjc.LAUNCHES - counts[0]
    restore_mj_counts(mjc, counts)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    kernel_ms = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in events if "mj_chunk_kernel" in e.key) / 1e3
    top = sorted(events, key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))[:6]
    return (wall, device_seconds(prof), sum(e.count for e in events),
            kernel_ms, launches, top)


def multijob_phase(core, cc, mjc, des_step, ref):
    """Phase 20: the multi-job CTMC engine on the card, through
    ``MultiJobSweep`` and ``engine="auto"``; see the module docstring."""
    import torch
    vmj, vectorized = core.vectorized_multijob, core.vectorized
    t_phase = time.perf_counter()
    cluster = core.Params(**MJ_CLUSTER)
    jobs = [core.JobSpec(*j) for j in MJ_JOBS]
    sweep = core.MultiJobSweep(
        "fleet-capacity", jobs, "spare_pool_size", MJ_SPARES,
        parameter_b="repair_servers", values_b=MJ_SHOPS,
        n_replications=MJ_REPLICAS, base_params=cluster, engine="auto",
        device="cuda")
    rec = {}
    orig_sweep = vmj.simulate_multijob_ctmc_sweep

    def sweep_fn(*args, **kwargs):
        rec["call"] = (args, kwargs)
        rec["points"] = orig_sweep(*args, **kwargs)
        return rec["points"]

    main_run, restore = capture_mj_chunks(vmj, vectorized, mjc)
    vmj.simulate_multijob_ctmc_sweep = sweep_fn
    try:
        zero_mj_counts(mjc)                       # the multi-job path's run
        zero_counts(cc)
        des_step.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, kernel_steps = mjc.LAUNCHES, mjc.STEPS
        by_j = dict(mjc.LAUNCHES_BY_J)
        race_launches, chunk_launches = des_step.LAUNCHES, cc.LAUNCHES
    finally:
        restore()
        vmj.simulate_multijob_ctmc_sweep = orig_sweep
    chunks, n_steps = main_run["chunks"], main_run["steps"]
    print(f"  {len(res.points)} points x {MJ_REPLICAS} replicas, "
          f"{len(jobs)} jobs: {chunks} chunks of {n_steps} steps; multi-job "
          f"chunk kernel launches {launches} ({kernel_steps} steps, by J "
          f"{ {j: n for j, n in by_j.items() if n} }), standalone race "
          f"launches {race_launches}, single-job chunk launches "
          f"{chunk_launches}; wall {wall:.6f} s = "
          f"{wall / max(n_steps, 1) * 1e3:.4f} ms a step")
    if n_steps <= 0 or launches != chunks or kernel_steps != n_steps \
            or by_j[len(jobs)] != launches:
        fail(f"multi-job sweep: {chunks} chunks of {n_steps} steps but "
             f"{launches} multi-job chunk launches of {kernel_steps} steps")
    if race_launches or chunk_launches:
        fail(f"multi-job sweep: {race_launches} standalone race and "
             f"{chunk_launches} single-job chunk launches")
    for pt in res.points:
        st = pt.stats
        if pt.engine != "ctmc":
            fail(f"multi-job point {pt.values} ran on {pt.engine}")
        if st["completed"].mean != 1.0 or st["conservation_err"].maximum:
            fail(f"multi-job point {pt.values}: completed "
                 f"{st['completed'].mean}, conservation error "
                 f"{st['conservation_err'].maximum}")
        for name, stat in st.items():
            if not math.isfinite(stat.mean):
                fail(f"multi-job point {pt.values}: {name} is not finite")
        print(f"  spares={pt.values['spare_pool_size']} "
              f"shop={pt.values['repair_servers']}: makespan "
              f"{st['makespan'].mean / 60:.3f} h, stall hand-offs "
              f"{st['stall_handoffs'].mean:.3f}, queued "
              f"{st['n_shop_queued'].mean:.3f}, failures "
              f"{st['fleet_n_failures'].mean:.3f}, job0 "
              f"{st['job0_total_time'].mean / 60:.3f} h, job2 "
              f"{st['job2_total_time'].mean / 60:.3f} h")

    # the grid again, warm (the library loaded, its first launch's set-up
    # done), and the engine's call alone (set-up, scan, extraction; the
    # rest of a run is the sweep's per-point statistics)
    args, kwargs = rec["call"]
    counts = save_mj_counts(mjc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep.run()
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    orig_sweep(*args, **kwargs)
    torch.cuda.synchronize()
    engine_wall = time.perf_counter() - t0
    restore_mj_counts(mjc, counts)
    print(f"  warm: MultiJobSweep.run {warm_wall:.6f} s "
          f"({warm_wall / n_steps * 1e3:.4f} ms a step), the engine's call "
          f"alone {engine_wall:.6f} s")

    # the same sweep through the plain step loop on the card, same draws
    before = (mjc.LAUNCHES, des_step.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = orig_sweep(*args, **dict(kwargs, impl="ref"))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    if (mjc.LAUNCHES, des_step.LAUNCHES) != before:
        fail("impl='ref' launched a CUDA kernel")
    diff, total, lanes = bit_different(rec["points"], plain)
    print(f"  impl='ref' on the card: wall {plain_wall:.6f} s; "
          f"bit-different elements against the kernel's run {diff} of "
          f"{total} over {lanes} arrays")
    if diff:
        fail(f"the multi-job chunk kernel's sweep differs from the plain "
             f"loop's in {diff} elements")

    # the 1-job, unbounded-shop point: the single-job engine's chunk kernel
    t_part = time.perf_counter()
    one = cluster.replace(repair_servers=0)
    spec = jobs[0]
    race0, chunk0, mj0 = des_step.LAUNCHES, cc.LAUNCHES, mjc.LAUNCHES
    got = vmj.simulate_multijob_ctmc_sweep([(one, (spec,))],
                                           n_replicas=MJ_REPLICAS, seed=0,
                                           device="cuda")
    one_race, one_chunks = des_step.LAUNCHES - race0, cc.LAUNCHES - chunk0
    one_mj = mjc.LAUNCHES - mj0
    want = core.simulate_ctmc_sweep(
        [one.replace(job_size=spec.job_size, job_length=spec.job_length,
                     warm_standbys=spec.warm_standbys)],
        n_replicas=MJ_REPLICAS, seed=0, device="cuda")
    one_diff, one_total, one_lanes = bit_different(
        [{"per_job": [got[0]["per_job"][0]]}], [{"per_job": want}])
    print(f"  1-job point through the multi-job API: {one_chunks} chunk "
          f"launches, multi-job chunk launches {one_mj}, race launches "
          f"{one_race}; differing elements against simulate_ctmc_sweep "
          f"{one_diff} of {one_total} over {one_lanes} lanes")
    if one_race or one_mj or one_chunks <= 0 or one_diff:
        fail(f"1-job point: {one_race} race launches, {one_mj} multi-job "
             f"and {one_chunks} chunk launches, {one_diff} differing "
             "elements")
    parts = {"sweep": wall, "warm_sweep": warm_wall,
             "engine_call": engine_wall, "plain_sweep": plain_wall,
             "one_job": time.perf_counter() - t_part}
    t_part = time.perf_counter()

    # the middle chunk again, kept: the kernel against the plain loop, its
    # times and bound
    mid = chunks // 2
    kept_run, restore = capture_mj_chunks(vmj, vectorized, mjc, keep=mid)
    counts = save_mj_counts(mjc)
    try:
        again = orig_sweep(*args, **kwargs)
    finally:
        restore()
        restore_mj_counts(mjc, counts)
    again_diff = bit_different(rec["points"], again)[0]
    if again_diff or kept_run["kept"] is None:
        fail(f"the sweep run again differs in {again_diff} elements, or "
             "its middle chunk was not kept")
    chunk = mj_chunk_check(mjc, vmj, ref, kept_run["kept"],
                           f"chunk {mid} of the grid")
    parts["chunk_check"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # the race alone at the chunk's middle step, against the plain race
    race_args = chunk["race_args"]
    if race_args is None:
        fail("the plain loop raced no row at the chunk's middle step")
    rates, resid = race_args[:2]
    counted = des_step.LAUNCHES
    dt_k, ev_k = des_step.event_race_cuda(*race_args)
    dt_r, ev_r = ref.event_race_ref(*race_args)
    torch.cuda.synchronize()
    mism = int((ev_k != ev_r).sum())
    fin = torch.isfinite(dt_r)
    if not torch.equal(fin, torch.isfinite(dt_k)):
        fail("multi-job race: kernel and plain version disagree on +inf dt")
    d = (dt_k[fin] - dt_r[fin]).abs()
    rel = float((d / dt_r[fin].abs().clamp_min(1e-30)).max()) \
        if bool(fin.any()) else 0.0
    abs_err = float(d.max()) if bool(fin.any()) else 0.0
    if mism or rel > 1e-6:
        fail(f"multi-job race: {mism} event mismatches, dt rel err {rel}")
    dead = int(((rates.sum(-1) == 0) & torch.isinf(resid).all(-1)).sum())
    k_ms = event_ms(lambda: des_step.event_race_cuda(*race_args), 500)
    r_ms = event_ms(lambda: ref.event_race_ref(*race_args), 200)
    k_dev = device_ms(lambda: des_step.event_race_cuda(*race_args), 100)
    r_dev = device_ms(lambda: ref.event_race_ref(*race_args), 50)
    des_step.LAUNCHES = counted
    R, ke = rates.shape
    kd = resid.shape[1]
    row_bytes = (ke + kd + 2) * 4 + 4 + 4      # inputs read once + outputs
    row_ops = 4 * ke + kd + 4                  # sum, cumsum, divide, compare
    bytes_ms = R * row_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = R * row_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  race alone at the chunk's step {chunk['race_step']} "
          f"({R}x{ke}x{kd}, {dead} rows with no live clock): event "
          f"mismatches {mism}, dt max rel err {rel:.3e}, max abs err "
          f"{abs_err:.3e}; CUDA events (back-to-back): kernel {k_ms:.6f} "
          f"ms, plain {r_ms:.6f} ms; device time: kernel {k_dev} ms, plain "
          f"{r_dev} ms; bound {bound_ms:.6f} ms ({bound_by})")
    parts["race_alone"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # the whole sweep traced: device kernels a step, the device's busy share
    traced_wall, busy, n_kernels, kernel_ms, traced_launches, top = \
        traced_mj_sweep(mjc, lambda: orig_sweep(*args, **kwargs))
    per_step = n_kernels / n_steps
    chunk["sweep_ms_per_launch"] = kernel_ms / max(traced_launches, 1)
    print(f"  traced sweep: wall {traced_wall:.6f} s, device busy "
          f"{busy:.6f} s = {busy / traced_wall * 100:.2f}% of it, "
          f"{n_kernels} device kernels and copies = {per_step:.4f} a step; "
          f"multi-job chunk kernel {kernel_ms:.6f} ms in {traced_launches} "
          f"launches = {chunk['sweep_ms_per_launch']:.6f} ms a launch")
    for e in top:
        print(f"    device {e.key[:60]}: {e.count} calls, "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms")
    if traced_launches != launches:
        fail(f"traced sweep: {traced_launches} launches, {launches} before")
    parts["traced_sweep"] = time.perf_counter() - t_part
    print(f"  device time a step {busy / n_steps * 1e3:.6f} ms over the "
          f"untraced {wall / n_steps * 1e3:.6f} ms a step: busy "
          f"{busy / wall * 100:.2f}%; seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    chunk.pop("race_args")
    return {"call": rec["call"], "points": rec["points"],
            "launches": launches, "chunks": chunks, "steps": n_steps,
            "race_launches": race_launches, "wall_s": wall,
            "ms_per_step": wall / n_steps * 1e3, "warm_wall_s": warm_wall,
            "engine_wall_s": engine_wall, "plain_wall_s": plain_wall,
            "plain_bit_different": diff,
            "single_job_chunk_launches": one_chunks,
            "single_job_race_launches": one_race,
            "single_job_mj_launches": one_mj,
            "single_job_differing": one_diff,
            "busy_share": busy / traced_wall,
            "busy_share_untraced_wall": busy / wall, "parts_s": parts,
            "kernels_per_step": per_step, "chunk": chunk,
            "race": {"max_abs_err": abs_err, "event_mismatches": mism,
                     "dt_max_rel_err": rel, "shape": [R, ke, kd],
                     "rows_without_live_clock": dead,
                     "ms": k_ms if k_dev is None else k_dev,
                     "plain_ms": r_ms if r_dev is None else r_dev,
                     "call_ms": k_ms, "plain_call_ms": r_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by},
            "seconds": time.perf_counter() - t_phase}


def multijob_bench_phase(core, cc, mjc, des_step, ref):
    """Phase 20b: the multi-job grid at benchmarks/engine_perf.py::
    multijob_sweep_throughput's shape through ``run_multijob_batch``: its
    wall, ms a step, launches, the kernel's time a launch over the traced
    sweep, and the middle chunk held against the plain loop with its
    bound."""
    import torch
    vmj, vectorized = core.vectorized_multijob, core.vectorized
    t_phase = time.perf_counter()
    cluster = core.Params(**MJ_BENCH_CLUSTER)
    jobs = tuple(core.JobSpec(*j) for j in MJ_BENCH_JOBS)
    grid = [(cluster.replace(spare_pool_size=s, repair_servers=r), jobs)
            for s in MJ_BENCH_SPARES for r in MJ_BENCH_SHOPS]

    def run():
        return core.run_multijob_batch(grid, MJ_REPLICAS, engine="ctmc",
                                       base_seed=0, device="cuda")

    main_run, restore = capture_mj_chunks(vmj, vectorized, mjc)
    try:
        zero_mj_counts(mjc)                       # the benchmark shape's run
        race0, chunk0 = des_step.LAUNCHES, cc.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mjc.LAUNCHES
        race, single = des_step.LAUNCHES - race0, cc.LAUNCHES - chunk0
    finally:
        restore()
    chunks, n_steps = main_run["chunks"], main_run["steps"]
    rows = main_run["calls"][0][2] * main_run["calls"][0][3]
    for (c, _), rep in zip(grid, reps):
        if rep.engine != "ctmc" or rep.fleet["completed"].mean != 1.0 \
                or rep.fleet["conservation_err"].maximum:
            fail(f"benchmark-shape point spares={c.spare_pool_size} "
                 f"shop={c.repair_servers}: engine {rep.engine}, completed "
                 f"{rep.fleet['completed'].mean}, conservation error "
                 f"{rep.fleet['conservation_err'].maximum}")
    if launches != chunks or race or single or n_steps <= 0:
        fail(f"benchmark shape: {chunks} chunks, {launches} multi-job "
             f"chunk, {race} race and {single} chunk launches")
    counts = save_mj_counts(mjc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    restore_mj_counts(mjc, counts)
    traced_wall, busy, n_kernels, kernel_ms, traced_launches, _ = \
        traced_mj_sweep(mjc, run)
    mid = chunks // 2
    kept_run, restore = capture_mj_chunks(vmj, vectorized, mjc, keep=mid)
    counts = save_mj_counts(mjc)
    try:
        run()
    finally:
        restore()
        restore_mj_counts(mjc, counts)
    chunk = mj_chunk_check(mjc, vmj, ref, kept_run["kept"],
                           f"benchmark shape, chunk {mid}")
    chunk.pop("race_args")
    per_launch = kernel_ms / max(traced_launches, 1)
    print(f"  {len(grid)} points x {MJ_REPLICAS} replicas ({rows} rows), "
          f"{len(jobs)} jobs: sweep wall {wall:.6f} s (warm "
          f"{warm_wall:.6f} s), {n_steps} steps = "
          f"{wall / n_steps * 1e3:.4f} ms a step, {launches} multi-job chunk "
          f"launches; the kernel {per_launch:.6f} ms a launch over the "
          f"traced sweep (busy {busy / traced_wall * 100:.2f}% of its "
          f"{traced_wall:.6f} s, {n_kernels / n_steps:.4f} device kernels "
          f"a step); bound {chunk['bound_ms']:.6f} ms a launch "
          f"({chunk['bound_by']}, the middle chunk); mean makespan "
          + ", ".join(f"{r.fleet['makespan'].mean / 60:.2f}" for r in reps)
          + " h")
    return dict(chunk, launches=launches, chunks=chunks, steps=n_steps,
                rows=rows, wall_s=wall, warm_wall_s=warm_wall,
                sweep_ms_per_step=wall / n_steps * 1e3,
                sweep_ms_per_launch=per_launch,
                busy_share=busy / traced_wall,
                seconds=time.perf_counter() - t_phase)


def multijob_parity_phase(core, mjc, des_step, ref):
    """Phase 21: tests/test_multijob_parity.py's two- and four-job
    clusters, the multi-job CTMC engine on the card (a multi-job chunk
    launch a chunk) against the port's event engine on the host, every
    pinned mean within |z| < 3.5; then each cluster's run again with its
    middle chunk kept, that chunk held bit for bit against the plain loop
    and timed (mj_chunk_check)."""
    import numpy as np
    vmj, vectorized = core.vectorized_multijob, core.vectorized
    t_phase = time.perf_counter()
    out = {}
    for name, (kw, job_rows, n_event, seed) in MJ_PARITY.items():
        cluster = core.Params(**kw)
        jobs = [core.JobSpec(*j) for j in job_rows]
        run, restore = capture_mj_chunks(vmj, vectorized, mjc)
        try:
            zero_mj_counts(mjc)                   # this cluster's run
            des_step.LAUNCHES = 0
            t0 = time.perf_counter()
            point = vmj.simulate_multijob_ctmc_sweep(
                [(cluster, jobs)], n_replicas=MJ_PARITY_CTMC, seed=seed,
                device="cuda")[0]
            ctmc_s = time.perf_counter() - t0
            launches, race = mjc.LAUNCHES, des_step.LAUNCHES
            by_j = mjc.LAUNCHES_BY_J[len(jobs)]
        finally:
            restore()
        t0 = time.perf_counter()
        results = core.simulate_multijob(cluster, jobs,
                                         n_replications=n_event,
                                         base_seed=seed + 1)
        event_s = time.perf_counter() - t0
        if launches != run["chunks"] or launches <= 0 or race \
                or by_j != launches \
                or float(point["completed"].min()) != 1.0 \
                or float(np.max(point["conservation_err"])) != 0.0:
            fail(f"{name}: {launches} multi-job chunk launches for "
                 f"{run['chunks']} chunks, {race} race launches, completed "
                 f"{point['completed'].min()}, conservation error "
                 f"{np.max(point['conservation_err'])}")
        zs = {}
        for j in range(len(jobs)):
            zs.update({f"job{j}_{m}": z for m, z in parity_z(
                point["per_job"][j], [r.per_job[j] for r in results],
                MJ_JOB_METRICS).items()})
        fleet = {"makespan": "makespan", "stall_handoffs": "stall_events",
                 "n_shop_queued": "queue_events"}
        ev_rows = [dict({m: float(getattr(r, fleet[m])) for m in fleet},
                        n_auto_repairs=float(r.cluster.n_auto_repairs),
                        n_manual_repairs=float(r.cluster.n_manual_repairs))
                   for r in results]

        class Row:
            def __init__(self, d):
                self.__dict__.update(d)

        zs.update(parity_z(point, [Row(d) for d in ev_rows],
                           MJ_FLEET_METRICS))
        worst = max(abs(z) for z in zs.values())
        print(f"  {name}: CTMC {MJ_PARITY_CTMC} replicas on the card "
              f"{ctmc_s:.3f} s ({run['steps']} steps in {run['chunks']} "
              f"chunks, {launches} multi-job chunk launches), event "
              f"{n_event} on the host {event_s:.3f} s; largest |z| "
              f"{worst:.3f}; z: "
              + ", ".join(f"{m} {z:+.3f}" for m, z in zs.items()))
        if worst >= PARITY_Z:
            fail(f"multi-job parity {name}: |z| = {worst:.3f} >= "
                 f"{PARITY_Z}")
        mid = run["chunks"] // 2
        kept_run, restore = capture_mj_chunks(vmj, vectorized, mjc, keep=mid)
        counts = save_mj_counts(mjc)
        try:
            again = vmj.simulate_multijob_ctmc_sweep(
                [(cluster, jobs)], n_replicas=MJ_PARITY_CTMC, seed=seed,
                device="cuda")[0]
        finally:
            restore()
            restore_mj_counts(mjc, counts)
        again_diff = bit_different([point], [again])[0]
        if again_diff or kept_run["kept"] is None:
            fail(f"{name}: the run again differs in {again_diff} elements, "
                 "or its middle chunk was not kept")
        chunk = mj_chunk_check(mjc, vmj, ref, kept_run["kept"],
                               f"{name}, chunk {mid}")
        chunk.pop("race_args")
        out[name] = dict(chunk, launches=launches, steps=run["steps"],
                         J=len(jobs), max_abs_z=worst, ctmc_s=ctmc_s,
                         event_s=event_s)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def diverged_rows(a, b):
    """Rows of two final states whose trajectories differ: any integer
    metric, the phase or the run count."""
    import torch
    same = torch.ones_like(a["n_failures"], dtype=torch.bool)
    for m in INT_METRICS + ("phase", "n_runs"):
        same &= a[m] == b[m]
    return int((~same).sum())


def twin_z(a, b, metrics=AGE64_METRICS):
    """Largest |z| of the means of ``metrics`` between two final states
    over all their rows (pooled standard errors)."""
    worst = 0.0
    for m in metrics:
        x, y = a[m].double(), b[m].double()
        se = math.sqrt(float(x.var()) / x.numel() + float(y.var())
                       / y.numel())
        worst = max(worst, abs(float(x.mean() - y.mean())) / max(se, 1e-12))
    return worst


def age64_phase(core, cc, vectorized, families, campaigns):
    """Phase 22: float64 age at full width.  Weibull failures with Weibull
    repairs through phase 5's sweep in both age dtypes, phase 14's Weibull
    sweep and phase 19's Weibull campaign with ``age_dtype="float64"``:
    each run's launches all float64 launches of one instance, its first
    chunk held bit for bit against the float64 plain loop (family_phase /
    campaign_phase), its time a launch beside its float32 twin's (the same
    config and draws in this call), and float64 against float32 statistics
    on the same draws (|z| < 3.5) with the rows whose trajectories
    diverged."""
    import torch
    t0 = time.perf_counter()
    runs = {}
    wbwb = dict(failure_distribution="weibull", repair_distribution="weibull",
                distribution_kwargs={"k": 1.5})
    t1 = time.perf_counter()
    twin32 = family_phase(core, cc, vectorized, "weibull", wbwb, twin=True)
    print(f"  float32 twin: {time.perf_counter() - t1:.3f} s")
    for label, run, twin in (
            ("weibull+slots:weibull", lambda: family_phase(
                core, cc, vectorized, "weibull",
                dict(wbwb, age_dtype="float64")), twin32),
            ("weibull", lambda: family_phase(
                core, cc, vectorized, "weibull",
                dict(FAMILY_SWEEPS["weibull"], age_dtype="float64")),
             families["weibull"]),
            ("weibull+scenario", lambda: campaign_phase(
                core, cc, vectorized, "weibull",
                dict(FAMILY_SWEEPS["weibull"], age_dtype="float64")),
             campaigns["weibull"])):
        t1 = time.perf_counter()
        rec = run()
        # the run's zero_counts set it to 0; the comparison and timing
        # launches after it were put back
        age64 = cc.LAUNCHES_BY_AGE["float64"]
        final, final32 = rec["final"], twin["final"]
        if final["age"].dtype != torch.float64 \
                or age64 != rec["launches"]:
            fail(f"{label}: {age64} float64 launches of {rec['launches']}, "
                 f"age lane {final['age'].dtype}")
        z = twin_z(final, final32)
        rows = diverged_rows(final, final32)
        ms, ms32 = (r["ms"] if r["ms"] is not None else r["call_ms"]
                    for r in (rec, twin))
        print(f"  {label} float64: {rec['launches']} launches, "
              f"{ms:.6f} ms a launch against the float32 twin's "
              f"{ms32:.6f} ms ({ms / ms32:.3f}x); bound {rec['bound_ms']:.6f}"
              f" ms ({rec['bound_by']}, 8-byte age lanes); first chunk "
              f"{rec['bit_different']} bit-different; against float32 on "
              f"the same draws: largest |z| {z:.3f}, {rows} of "
              f"{final['phase'].numel()} rows diverged; "
              f"{time.perf_counter() - t1:.3f} s")
        if z >= 3.5:
            fail(f"{label}: float64 and float32 means differ (|z| {z:.3f})")
        rec.update(twin_ms=ms32, twin_launches=twin["launches"], z=z,
                   diverged_rows=rows, rows=final["phase"].numel())
        runs[label] = rec
    secs = time.perf_counter() - t0
    print(f"  phase 22: {secs:.3f} s")
    return runs, secs


def dict_bits(a, b):
    """Elements whose bits differ between two result dicts of arrays."""
    import numpy as np
    if sorted(a) != sorted(b):
        fail(f"result keys differ: {sorted(a)} vs {sorted(b)}")
    n = 0
    for k in a:
        x, y = np.ascontiguousarray(a[k]), np.ascontiguousarray(b[k])
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{k}: {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        n += int((x.view(f"u{x.itemsize}") != y.view(f"u{y.itemsize}"))
                 .sum())
    return n


def sharding_phase(core, cc, mjc, vectorized, base, final5, multijob):
    """Phase 23: replica sharding.  ``engine_shards=1`` on phase 5's sweep
    and on phase 20's multi-job grid bit for bit their outputs; with two or
    more cards a 2-shard sweep, each shard bit for bit its own run on
    cuda:s, its wall beside the one-card wall; with one card, a 2-shard
    request refused naming the card count."""
    import torch
    from repro_torch.parallel import shard_seeds
    t0 = time.perf_counter()
    vmj = core.vectorized_multijob
    got, meshes = [], []
    orig = vectorized._chunk_loop

    def spy(*args, **kwargs):
        meshes.append(kwargs.get("mesh"))
        got.append(orig(*args, **kwargs))
        return got[-1]

    vectorized._chunk_loop = spy
    try:
        counts = save_counts(cc)
        core.OneWaySweep("warm standbys", "warm_standbys", SWEEP_VALUES,
                         n_replications=N_REPLICAS,
                         base_params=base.replace(engine_shards=1),
                         device="cuda").run()
        torch.cuda.synchronize()
        restore_counts(cc, counts)
    finally:
        vectorized._chunk_loop = orig
    if len(got) != 1 or sorted(got[0]) != sorted(final5) \
            or meshes[0] is None or len(meshes[0]) != 1:
        fail(f"engine_shards=1 did not run phase 5's sweep as one batch on "
             f"a one-device mesh (meshes {meshes})")
    differ = [k for k in final5 if not torch.equal(got[0][k], final5[k])]
    print(f"  engine_shards=1 on phase 5's sweep: {len(final5)} lanes, "
          f"differing from phase 5's final state: {differ or 'none'}")
    if differ:
        fail(f"engine_shards=1 differs from phase 5 in {differ}")
    args, kwargs = multijob["call"]
    counts = save_mj_counts(mjc)
    one = vmj.simulate_multijob_ctmc_sweep(*args, **dict(kwargs, shards=1))
    restore_mj_counts(mjc, counts)
    mj_diff, _, _ = bit_different(one, multijob["points"])
    print(f"  engine_shards=1 on phase 20's grid: {len(one)} points, "
          f"bit-different elements against phase 20's outputs {mj_diff}")
    if mj_diff or len(one) != len(multijob["points"]):
        fail(f"engine_shards=1 on phase 20's grid differs in {mj_diff}")
    n_cards = torch.cuda.device_count()
    out = {"mesh1_lanes_differing": len(differ),
           "mesh1_multijob_bit_different": mj_diff, "cards": n_cards}
    pts = [base.replace(warm_standbys=v) for v in SWEEP_VALUES]
    if n_cards < 2:
        try:
            vectorized.simulate_ctmc_sweep(pts, N_REPLICAS, seed=base.seed,
                                           shards=2, device="cuda")
        except ValueError as exc:
            if "only 1 " not in str(exc) or "needs 2" not in str(exc):
                fail(f"the 2-shard refusal does not name the counts: {exc}")
            print(f"  engine_shards=2 on one card: refused ({exc})")
        else:
            fail("a 2-shard sweep ran on one card")
        print("  the 2-card case was not run: this host has 1 card")
    else:
        counts = save_counts(cc)

        def sweep(n):
            return vectorized.simulate_ctmc_sweep(
                pts, N_REPLICAS, seed=base.seed, shards=n, device="cuda")

        # the first 2-shard run also warms cuda:1 (its context, the
        # kernel's module there, the allocator); then one card and two
        # shards in turns
        sharded = sweep(2)
        walls = {0: [], 2: []}
        for n in (0, 2, 2, 0):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sweep(n)
            for d in range(2):
                torch.cuda.synchronize(d)
            walls[n].append(time.perf_counter() - t1)
        walls = {n: min(w) for n, w in walls.items()}
        R_loc = N_REPLICAS // 2
        bits = 0
        for s, seed in enumerate(shard_seeds(base.seed, 2)):
            alone = vectorized.simulate_ctmc_sweep(
                pts, R_loc, seed=seed, device=f"cuda:{s}")
            for a, b in zip(sharded, alone):
                part = {k: (v[s * R_loc:(s + 1) * R_loc]
                            if v.ndim and v.shape[0] == N_REPLICAS else v)
                        for k, v in a.items()}
                bits += dict_bits(part, b)
        restore_counts(cc, counts)
        print(f"  2 shards on cuda:0 and cuda:1: bit-different elements "
              f"against the per-shard runs {bits}; wall {walls[2]:.6f} s "
              f"against one card's {walls[0]:.6f} s (the faster of two "
              "warm runs each)")
        if bits:
            fail(f"a 2-shard sweep differs from its shards' runs in {bits}")
        out.update(two_card_bit_different=bits, wall_s=walls[2],
                   one_card_wall_s=walls[0])
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 23: {out['seconds']:.3f} s")
    return out


#: phase 24: the paper's own tables, held to the JAX package's means at
#: |z| < PAPER_Z_LIMIT (a Bonferroni bound for ~100 rows; the two packages
#: draw different bits, so this is statistical parity, not identity)
PAPER_REFERENCE = os.path.join("tests", "data", "torch_paper_reference.json")
PAPER_Z_LIMIT = 4.0
PAPER_TABLE_ROWS = {"fig2a": 12, "fig2b": 12, "sensitivity": 78}
FIT_CLI = os.path.join("scripts", "torch_fit_hazard.py")


def paper_z(tables, ref_rows):
    """|z| of each row's mean total time against the reference's row with
    the same (table, param, value, pool), on both runs' standard errors:
    the port's from its ci95 (1.96 standard errors, in hours), the
    reference's from its std and count.  Returns {table: [|z|, ...]}."""
    ref = {(r["table"], r["param"], r["value"], r["pool"]): r
           for r in ref_rows}
    zs = {}
    for table, (param, rows) in tables.items():
        for row in rows:
            name = param or row["parameter"]
            value = row[param] if param else row["value"]
            want = ref.get((table, name, value, row["working_pool_size"]))
            if want is None:
                fail(f"phase 24: no reference row for {table} {name}="
                     f"{value} pool {row['working_pool_size']}")
            tt = want["total_time"]
            se_ref = tt["std"] / math.sqrt(tt["n"])
            se = row["total_time_ci95_hours"] * 60.0 / 1.96
            z = (row["total_time_hours"] * 60.0 - tt["mean"]) \
                / max(math.hypot(se, se_ref), 1e-9)
            zs.setdefault(table, []).append(abs(z))
    return zs


def paper_claims(core, pt, fa, fb, sens):
    """tests/test_paper_claims.py's five claims on the full-size rows
    (32 days; 256 replicas, 128 in the sensitivity grid).  Returns the
    numbers each claim compares."""
    ta = {(r["recovery_time"], r["working_pool_size"]):
          r["total_time_hours"] * 60.0 for r in fa}
    tb = {(r["waiting_time"], r["working_pool_size"]):
          r["total_time_hours"] * 60.0 for r in fb}
    default = core.Params()
    rec_lo, rec_mid, rec_hi = core.PAPER_TABLE1_RANGES["recovery_time"]
    out = {}
    # 1. Fig 2a is monotone at every pool
    for pool in pt.POOL_SIZES:
        times = [ta[(rt, pool)] for rt in (rec_lo, rec_mid, rec_hi)]
        if not times[0] < times[1] < times[2]:
            fail(f"claim 1: total time not increasing with recovery time at "
                 f"pool {pool}: {times}")
    # 2. the 10 -> 30 min delta within 35% of the renewal estimate
    p = pt.paper_params()
    expected = p.expected_failures_per_minute() * p.job_length \
        * (rec_hi - rec_lo)
    delta = ta[(rec_hi, 4160)] - ta[(rec_lo, 4160)]
    out["renewal"] = {"delta_min": delta, "expected_min": expected,
                      "ratio": delta / expected}
    if abs(delta - expected) > 0.35 * expected:
        fail(f"claim 2: the recovery delta {delta:.1f} min is not within 35% "
             f"of the renewal estimate {expected:.1f} min")
    # 3. the waiting-time effect is no larger at 4192 than at 4112 (+30 min)
    wt_lo, _, wt_hi = core.PAPER_TABLE1_RANGES["waiting_time"]
    tight = tb[(wt_hi, 4112)] - tb[(wt_lo, 4112)]
    big = tb[(wt_hi, 4192)] - tb[(wt_lo, 4192)]
    out["waiting"] = {"tight_min": tight, "big_min": big}
    if tight < -1e-6 or big > tight + 30.0:
        fail(f"claim 3: waiting-time effect {tight:.1f} min at 4112, "
             f"{big:.1f} min at 4192")
    # 4. +32 servers suffice: the default cells of Fig 2a
    t128, t160, t192 = (ta[(default.recovery_time, pool)]
                        for pool in (4128, 4160, 4192))
    out["capacity"] = {"t4128": t128, "t4160": t160, "t4192": t192}
    if abs(t192 - t160) / t160 >= 0.01 or t128 < t160 - 0.01 * t160:
        fail(f"claim 4: pools 4128 / 4160 / 4192 give {t128:.1f} / "
             f"{t160:.1f} / {t192:.1f} min")
    # 5. the repair knobs are flat at pool 4160, against the grid's own
    # default-value cell
    flat = {}
    for param in ("auto_repair_time", "manual_repair_failure_probability",
                  "diagnosis_probability"):
        cells = {r["value"]: r["total_time_hours"] for r in sens
                 if r["parameter"] == param
                 and r["working_pool_size"] == 4160}
        base = cells[getattr(default, param)]
        flat[param] = max(abs(t - base) / base for t in cells.values())
        if flat[param] >= 0.05:
            fail(f"claim 5: {param} moves total time by "
                 f"{flat[param] * 100:.2f}% at pool 4160")
    out["flat_max_rel"] = flat
    return out


def fit_selftest(cc):
    """The trace-fitting CLI's selftest on the card: as a subprocess (exit
    0, ``ctmc`` routing), then its ``selftest`` function in this process
    with the chunk kernel's counts set to 0 (every launch the empirical
    instance's, at least one)."""
    import importlib.util
    import torch
    path = os.path.join(ROOT, FIT_CLI)
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, path, "--selftest"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    print(f"  {FIT_CLI} --selftest (subprocess, on the card): exit "
          f"{done.returncode} in {secs:.2f} s: {done.stdout.strip()}")
    if done.returncode != 0 or "selftest OK" not in done.stdout:
        fail(f"{FIT_CLI} --selftest failed: {done.stderr[-2000:]}")
    spec = importlib.util.spec_from_file_location("torch_fit_hazard", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    zero_counts(cc)
    if cli.selftest() != 0:
        fail("the fit CLI's selftest returned non-zero in process")
    torch.cuda.synchronize()
    emp = cc.LAUNCHES_BY_KIND["empirical"]
    print(f"  selftest in process: {emp} empirical-instance launches of "
          f"{cc.LAUNCHES}")
    if emp < 1 or emp != cc.LAUNCHES:
        fail(f"the fit selftest made {emp} empirical launches of "
             f"{cc.LAUNCHES}")
    return {"subprocess_s": secs, "launches": emp}


def paper_phase(core, cc, vectorized, des_step):
    """Phase 24: the paper's own evaluation at full size through
    ``repro_torch.studies.paper_tables``: ``fig2a()``, ``fig2b()`` and
    ``sensitivity()`` (4096 servers, 32 days, 256 / 256 / 128 replicas,
    into a temporary folder), the chunk kernel's launches counted from 0
    (every launch the exponential instance's, one a chunk, no standalone
    race), every replica complete; each row's mean total time against
    tests/data/torch_paper_reference.json (the JAX package's tables) at
    |z| < PAPER_Z_LIMIT; tests/test_paper_claims.py's five claims on these
    rows; fig2a's first chunk bit for bit the plain step loop, with the
    kernel's time a launch and its bound; a traced fig2a (the kernel's
    device time a launch over the sweep); then the fit CLI's selftest."""
    import tempfile
    import torch
    from repro_torch.studies import paper_tables as pt
    t0 = time.perf_counter()
    with open(os.path.join(ROOT, PAPER_REFERENCE)) as f:
        ref_rows = json.load(f)["rows"]
    run, restore = capture_final_states(vectorized)
    walls = {}
    try:
        with tempfile.TemporaryDirectory() as td:
            zero_counts(cc)
            des_step.LAUNCHES = 0
            torch.cuda.synchronize()
            tables = {}
            for table, fn, param in (("fig2a", pt.fig2a, "recovery_time"),
                                     ("fig2b", pt.fig2b, "waiting_time"),
                                     ("sensitivity", pt.sensitivity, None)):
                t1 = time.perf_counter()
                rows = fn(device="cuda", results_dir=td)
                torch.cuda.synchronize()
                walls[table] = time.perf_counter() - t1
                tables[table] = (param, rows)
            launches, exp_launches = cc.LAUNCHES, \
                cc.LAUNCHES_BY_KIND["exponential"]
            steps, race = cc.STEPS, des_step.LAUNCHES
            written = sorted(os.listdir(td))
    finally:
        restore()
    print("  tables: " + "; ".join(
        f"{t} {len(tables[t][1])} rows in {walls[t]:.3f} s" for t in tables)
        + f"; written {written}")
    print(f"  chunk kernel: {launches} launches ({exp_launches} of the "
          f"exponential instance), {steps} steps; chunks run {run['chunks']},"
          f" steps run {run['steps']}, batches {len(run['states'])}; "
          f"standalone race launches {race}")
    if launches != run["chunks"] or exp_launches != launches \
            or steps != run["steps"] or race:
        fail(f"phase 24 ran {run['chunks']} chunks of {run['steps']} steps "
             f"but counted {launches} launches ({exp_launches} exponential)"
             f" of {steps} steps and {race} race launches")
    for table, want in PAPER_TABLE_ROWS.items():
        if len(tables[table][1]) != want:
            fail(f"{table}: {len(tables[table][1])} rows, not {want}")
    for i, st in enumerate(run["states"]):
        if not bool((st["phase"] == vectorized.DONE).all()):
            fail(f"phase 24 batch {i}: not every replica completed")
    zs = paper_z(tables, ref_rows)
    worst = {t: max(v) for t, v in zs.items()}
    print("  |z| of the mean total time against the JAX package's tables: "
          + "; ".join(f"{t} largest {w:.3f} over {len(zs[t])} rows"
                      for t, w in worst.items()))
    if sum(len(v) for v in zs.values()) != len(ref_rows):
        fail(f"phase 24 compared {sum(len(v) for v in zs.values())} rows of "
             f"the reference's {len(ref_rows)}")
    bad = {t: w for t, w in worst.items() if w >= PAPER_Z_LIMIT}
    if bad:
        fail(f"the port's paper tables disagree with the reference's: {bad}")
    fa, fb, sens = (tables[t][1] for t in ("fig2a", "fig2b", "sensitivity"))
    claims = paper_claims(core, pt, fa, fb, sens)
    print(f"  the five claims hold: renewal delta {claims['renewal']['ratio']:.3f}"
          f" of the estimate; waiting effect {claims['waiting']['tight_min']:.1f}"
          f" min at 4112, {claims['waiting']['big_min']:.1f} min at 4192; "
          f"pools 4128 / 4160 / 4192 {claims['capacity']['t4128']:.1f} / "
          f"{claims['capacity']['t4160']:.1f} / "
          f"{claims['capacity']['t4192']:.1f} min; flat knobs "
          + ", ".join(f"{k} {v * 100:.2f}%"
                      for k, v in claims["flat_max_rel"].items()))
    for table in ("fig2a", "fig2b"):
        print(f"  {table} (hours, ci95): " + "; ".join(
            f"{r[tables[table][0]]:g}/{r['working_pool_size']} "
            f"{r['total_time_hours']:.2f} +- {r['total_time_ci95_hours']:.2f}"
            for r in tables[table][1]))
    effects = pt.effect_sizes(sens)
    print("  sensitivity effect sizes: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(effects.items())))
    # fig2a's first chunk (its 3,072 rows of 4,096 after pow2 bucketing)
    chunk = chunk_phase(cc, vectorized, run["calls"][0])
    if chunk["bit_different"]:
        fail(f"fig2a's first chunk: {chunk['bit_different']} float elements "
             "differ from the plain loop's")
    with tempfile.TemporaryDirectory() as td:
        sweep_ms, traced = traced_chunk_ms(
            cc, lambda: pt.fig2a(device="cuda", results_dir=td),
            cc.LAUNCHES_BY_KIND, "exponential")
    chunk["sweep_ms_per_launch"] = sweep_ms / traced if traced else None
    print(f"  traced fig2a: {traced} launches, {sweep_ms:.3f} ms of chunk "
          f"kernel, {chunk['sweep_ms_per_launch']} ms a launch")
    fit = fit_selftest(cc)
    secs = time.perf_counter() - t0
    print(f"  phase 24: {secs:.3f} s")
    return {"seconds": secs, "walls_s": walls, "launches": launches,
            "chunks": run["chunks"], "steps": steps, "race_launches": race,
            "max_abs_z": worst, "claims": claims, "effect_sizes": effects,
            "first_chunk": {k: chunk[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "bit_different", "live_rows", "sweep_ms_per_launch")},
            "fit_selftest": fit}



#: phase 25: shapes past the standard chunk instances' caps (ROADMAP faults
#: F1-F2), each under the default impl: name -> (Params overrides of the
#: Table-I cluster, replicas, the nearest shape a standard instance takes)


def wide_fit(n_seg: int) -> dict:
    """An empirical fit of ``n_seg`` segments a clock (days and rate
    multipliers), as ``scripts/torch_fit_hazard.py --bins n_seg`` gives
    one: rising edges, rates that wander over a decade."""
    return {"edges": [0.05 * (i + 1) for i in range(n_seg - 1)],
            "rates": [0.3 + 1.2 * ((7 * i) % 11) / 10.0
                      for i in range(n_seg)]}


#: a cluster of over 32,768 servers whose Weibull repair lane is 32,768
#: slots wide (the standard slot instances take 28,990 in float32 and
#: 19,326 in float64)
WIDE_SLOT_CLUSTER = dict(job_size=32768, working_pool_size=33024,
                         spare_pool_size=256, warm_standbys=16,
                         repair_distribution="weibull",
                         distribution_kwargs={"k": 0.7})
WIDE_CASES = {
    "empirical_65_segments": (
        dict(failure_distribution="empirical",
             distribution_kwargs=wide_fit(65)), 1024,
        dict(failure_distribution="empirical",
             distribution_kwargs=wide_fit(64))),
    "empirical_256_segments": (
        dict(failure_distribution="empirical",
             distribution_kwargs=wide_fit(256)), 1024,
        dict(failure_distribution="empirical",
             distribution_kwargs=wide_fit(64))),
    "empirical_repair_65_segments": (
        dict(repair_distribution="empirical",
             distribution_kwargs=wide_fit(65)), 1024,
        dict(repair_distribution="empirical",
             distribution_kwargs=wide_fit(64))),
    "weibull_slots_32768": (
        dict(WIDE_SLOT_CLUSTER, repair_slots=32768), 256,
        dict(WIDE_SLOT_CLUSTER, repair_slots=16384)),
    "weibull_slots_32768_age64": (
        dict(WIDE_SLOT_CLUSTER, repair_slots=32768, age_dtype="float64"), 256,
        dict(WIDE_SLOT_CLUSTER, repair_slots=16384, age_dtype="float64")),
    "hist_65536_edges": (
        dict(histogram_bins=65535), 256, dict(histogram_bins=32767)),
}
#: the nine- and sixteen-job clusters (tests/test_torch_mj_chunk.py's LOCK
#: cluster), and the eight-job one whose template instance they stand
#: beside
MJ_WIDE_LOCK = dict(spare_pool_size=4, job_size=16, job_length=400.0,
                    random_failure_rate=0.004, systematic_failure_rate=0.01,
                    auto_repair_time=150.0, manual_repair_time=400.0,
                    repair_servers=3, diagnosis_uncertainty=0.2)
MJ_WIDE_CASES = {
    9: (60, [(4, 100.0 + 30.0 * j, j % 2) for j in range(9)]),
    16: (80, [(3, 150.0 + 20.0 * j, j % 3) for j in range(16)]),
    8: (70, [(6, 200.0 + 40.0 * j, j % 2) for j in range(8)]),
}
MJ_WIDE_REPLICAS = 1024


def wide_params(core, overrides):
    """The Table-I cluster at JOB_DAYS with ``overrides``
    (``histogram_bins`` sets a log-spaced histogram of that many bins)."""
    from repro_torch.core.histograms import HistogramSpec
    kw = dict(overrides)
    bins = kw.pop("histogram_bins", None)
    if bins is not None:
        kw["histogram"] = HistogramSpec(low=1e-2, high=1e7, n_bins=bins)
    return core.Params(job_length=JOB_DAYS * DAY, **kw)


def wide_first_chunk(core, cc, vectorized, p, R, wide):
    """Two chunks of ``p`` through ``simulate_ctmc`` under the default impl
    (their launches counted), then, for a wide run, chunk_phase on the
    first chunk; for a standard run (a time to stand beside) only the
    launch's device time on that chunk."""
    import torch
    run, restore = capture_final_states(vectorized)
    try:
        zero_counts(cc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vectorized.simulate_ctmc(p, R, seed=0, max_steps=128,
                                 early_exit=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, n_wide = cc.LAUNCHES, cc.LAUNCHES_WIDE
    finally:
        restore()
    if launches != run["chunks"] or n_wide != (launches if wide else 0):
        fail(f"{run['chunks']} chunks ran {launches} launches, {n_wide} of "
             f"them wide (the route wants {'all' if wide else 'none'})")
    if not wide:
        pv, seed, P, R_, chunk = run["calls"][0][:5]
        channels, init = run["calls"][0][9], run["calls"][0][10]
        kind, n_seg, rkind, n_rseg = run["calls"][0][11:15]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(vectorized._chunk_seed(seed, 0))
        us = torch.rand((chunk, vectorized._next_pow2(R_),
                         vectorized._n_uniforms(kind, rkind)),
                        generator=gen, device="cuda").clamp_min_(1e-12)
        counts = save_counts(cc)
        split = device_kernels_ms(lambda: cc.ctmc_chunk_cuda(
            init, us, pv, R_, P, channels, kind=kind, n_seg=n_seg,
            rkind=rkind, n_rseg=n_rseg), 20)
        restore_counts(cc, counts)
        return {"ms": sum(ms for name, ms in split
                          if "ctmc_chunk_kernel" in name)}
    rec = chunk_phase(cc, vectorized, run["calls"][0], wide=True)
    if rec["bit_different"]:
        fail(f"first chunk: {rec['bit_different']} float elements differ "
             "from the plain loop's")
    rec.update(launches=launches, wide_launches=n_wide, wall_s=wall,
               chunks=run["chunks"])
    return rec


def shape_caps_phase(core, cc, mjc, vectorized, vmj, ref):
    """Phase 25: each shape past a standard instance's cap runs its wide
    or runtime-J instance under the default impl, a launch a chunk; its
    first chunk bit for bit the plain loop; its time a launch beside the
    standard instance's on the nearest shape that one takes."""
    t0 = time.perf_counter()
    out = {}
    for name, (over, R, near) in WIDE_CASES.items():
        t1 = time.perf_counter()
        rec = wide_first_chunk(core, cc, vectorized, wide_params(core, over),
                               R, True)
        std = wide_first_chunk(core, cc, vectorized, wide_params(core, near),
                               R, False)
        rec["standard_ms"] = std["ms"]
        ms_ = rec["ms"] if rec["ms"] is not None else rec["call_ms"]
        print(f"  {name}: {rec['wide_launches']} wide launches of "
              f"{rec['chunks']} chunks, first chunk 0 bit-different, "
              f"{ms_:.6f} ms a launch against the standard instance's "
              f"{rec['standard_ms']:.6f} ms on its nearest shape; "
              f"{time.perf_counter() - t1:.3f} s")
        out[name] = rec
    for J, (pool, jobs) in MJ_WIDE_CASES.items():
        t1 = time.perf_counter()
        cluster = core.Params(working_pool_size=pool, **MJ_WIDE_LOCK)
        specs = [core.JobSpec(*j) for j in jobs]
        run, restore = capture_mj_chunks(vmj, vectorized, mjc, keep=0)
        try:
            zero_mj_counts(mjc)
            vmj.simulate_multijob_ctmc(cluster, specs,
                                       n_replicas=MJ_WIDE_REPLICAS,
                                       max_steps=128, early_exit=False,
                                       device="cuda")
            launches, rt = mjc.LAUNCHES, mjc.LAUNCHES_RT
        finally:
            restore()
        want_rt = launches if mjc.runtime_for(J) else 0
        if launches != run["chunks"] or rt != want_rt:
            fail(f"{J} jobs: {run['chunks']} chunks ran {launches} launches,"
                 f" {rt} of them runtime-J")
        if not want_rt:   # the template instance: its time alone
            state, us, pv, R, P, J_, ch = run["kept"]
            counts = save_mj_counts(mjc)
            split = device_kernels_ms(lambda: mjc.mj_chunk_cuda(
                state, us, pv, R, P, J_, ch), 20)
            restore_mj_counts(mjc, counts)
            out[f"J{J}"] = {"ms": sum(ms for name, ms in split
                                      if "mj_chunk_kernel" in name)}
            continue
        rec = mj_chunk_check(mjc, vmj, ref, run["kept"], f"{J} jobs")
        rec.update(J=J, launches=launches, runtime_launches=rt,
                   chunks=run["chunks"])
        print(f"  {J} jobs: {rt} runtime-J launches of {launches}; "
              f"{time.perf_counter() - t1:.3f} s")
        out[f"J{J}"] = rec
    for J in (9, 16):
        rec, std = out[f"J{J}"], out["J8"]
        rec["standard_ms"] = std["ms"]
        ms_ = rec["ms"] if rec["ms"] is not None else rec["call_ms"]
        print(f"  runtime-J at J={J}: {ms_:.6f} ms a launch, "
              f"{ms_ / J:.6f} ms a job, against the J = 8 template's "
              f"{rec['standard_ms']:.6f} ms ({rec['standard_ms'] / 8:.6f} "
              "ms a job)")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 25: {out['seconds']:.3f} s")
    return out


#: phase 26: the training shapes of the attention and scan kernels under
#: autograd: qwen2.5-3b's attention and falcon-mamba-7b's scan at batch
#: 2 x 512; tolerances of the outputs against impl="ref", relative to the
#: reference's largest magnitude (the gradients are the plain version's
#: on both paths, so equal)
TRAIN_B, TRAIN_S = 2, 512
TRAIN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def train_kernels_phase(fa, ms, ops):
    """Phase 26: ops.flash_attention / ops.selective_scan at the training
    shapes, bf16 and float32: the output and the gradients of a fixed
    random cotangent with the kernel (impl="cuda") against impl="ref";
    one forward launch a call, none in the backward."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        gen = seeded(26)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   .requires_grad_() for s in (
                       (TRAIN_B, TRAIN_S, 16, 128), (TRAIN_B, TRAIN_S, 2, 128),
                       (TRAIN_B, TRAIN_S, 2, 128)))
        di, N = 8192, 16
        x, dt = (torch.randn((TRAIN_B, TRAIN_S, di), generator=gen,
                             device="cuda").to(dtype) for _ in range(2))
        dt = torch.nn.functional.softplus(dt.float() - 4.0).to(dtype)
        A = -torch.exp(torch.randn((di, N), generator=gen, device="cuda")
                       * 0.5)
        BC = torch.randn((TRAIN_B, TRAIN_S, 2 * N), generator=gen,
                         device="cuda").to(dtype)
        scan_leaves = [x.requires_grad_(), dt.requires_grad_(),
                       A.requires_grad_(), BC.requires_grad_()]
        for name, leaves, call, counter in (
                ("flash_attention", [q, k, v],
                 lambda impl: (ops.flash_attention(q, k, v, impl=impl),),
                 fa),
                ("selective_scan", scan_leaves,
                 lambda impl: ops.selective_scan(
                     x, dt, A, BC[..., :N], BC[..., N:], impl=impl)[:1],
                 ms)):
            before = counter.LAUNCHES
            (got,) = call("cuda")
            fwd = counter.LAUNCHES - before
            g = torch.randn(got.shape, generator=gen, device="cuda").to(
                got.dtype)
            grads = torch.autograd.grad(got, leaves, g)
            bwd = counter.LAUNCHES - before - fwd
            (want,) = call("ref")
            want_grads = torch.autograd.grad(want, leaves, g)
            counter.LAUNCHES = before
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max()) / scale
            g_err = max(float((a.float() - b.float()).abs().max())
                        / max(float(b.float().abs().max()), 1e-30)
                        for a, b in zip(grads, want_grads))
            print(f"  {name} {dname}: forward launches {fwd}, backward "
                  f"launches {bwd}; output max rel err {err:.3e}, gradients "
                  f"max rel err {g_err:.3e} (tolerance "
                  f"{TRAIN_TOL[dname]})")
            if fwd != 1 or bwd != 0:
                fail(f"{name} {dname}: {fwd} forward and {bwd} backward "
                     "launches, not 1 and 0")
            if err > TRAIN_TOL[dname] or g_err > TRAIN_TOL[dname]:
                fail(f"{name} {dname}: the kernel under autograd differs from"
                     " impl='ref'")
            out[f"{name}_{dname}"] = {"max_rel_err": err,
                                      "grad_max_rel_err": g_err,
                                      "forward_launches": fwd,
                                      "backward_launches": bwd}
        del q, k, v, x, dt, A, BC, scan_leaves
        release()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 26: {out['seconds']:.3f} s")
    return out


#: phase 27: a few train steps at full width: arch -> (depth override, the
#: kernel whose launches a step are counted)
TRAIN_ARCHS = {"qwen2.5-3b": ({}, "flash_attention"),
               # 4 of its 64 layers: the full depth's weights and AdamW
               # state (~84 GB) exceed one card
               "falcon-mamba-7b": ({"n_layers": 4}, "selective_scan")}
TRAIN_STEPS = 3


def first_step_grads(bundle, params, batch, impl, tail):
    """The loss of one step from ``params`` (no update), its gradients'
    norm and the norm over the parameters named in ``tail`` (the final
    norm and the last layer's after its attention), each summed in
    float64.  The reference's
    init draws q and k projections of std 1/sqrt(heads) (its fan-in is the
    head axis), so attention at random weights is nearly one-hot and the
    gradient grows several-fold a layer back from the loss: at full depth
    its float32 sum of squares (the step's grad_norm metric, as the
    reference takes it) overflows, and a bf16 rounding in any forward
    moves the early layers' gradients wholesale.  The tail's gradient
    passes through no attention backward: measured 5.4% apart with the
    last layer's attention in it, 77% for the whole norm."""
    import torch
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, _ = bundle.loss(leaves, batch, impl=impl)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    sq = {k: float(g.double().square().sum()) for k, g in zip(leaves, grads)}
    return (float(loss.detach()), math.sqrt(sum(sq.values())),
            math.sqrt(sum(v for k, v in sq.items() if tail(k))))


def train_step_phase(fa, ms, card_line):
    """Phase 27: make_train_step at full width (bf16 parameters, float32
    AdamW state, batch 2 x 512): the first step's loss and gradient norm
    through the kernels against impl="ref" (no update), then TRAIN_STEPS
    kernel steps, each's wall, loss, grad_norm metric and its kernel's
    launches; peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    out = {}
    shape = ShapeSpec("train", TRAIN_S, TRAIN_B, "train")
    opt_cfg = OptimizerConfig(learning_rate=1e-4, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
    for arch, (over, kernel) in TRAIN_ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(**over)
        torch.cuda.reset_peak_memory_stats()
        bundle = build_model(cfg)
        params = {k: p.detach()
                  for k, p in bundle.init(SEED).state_dict().items()}
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        pipe = SyntheticTokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_S + 1,
            global_batch=TRAIN_B, seed=SEED))
        batches = [{k: torch.as_tensor(v[:, :TRAIN_S]).cuda()
                    for k, v in pipe.batch_at(i).items()}
                   for i in range(TRAIN_STEPS)]
        last = f"stack.{cfg.n_layers - 1}."

        def tail(name):
            return name.startswith("final_norm") or (
                name.startswith(last) and ".attn." not in name
                and ".norm1." not in name)
        loss_ref, norm_ref, tail_ref = first_step_grads(
            bundle, params, batches[0], "ref", tail)
        counter = fa if kernel == "flash_attention" else ms
        before = counter.LAUNCHES
        loss_k, norm_k, tail_k = first_step_grads(bundle, params, batches[0],
                                                  None, tail)
        counter.LAUNCHES = before
        built = make_train_step(bundle, make_host_mesh(), shape, opt_cfg)
        steps = []
        with make_host_mesh():
            for i, batch in enumerate(batches):
                before = counter.LAUNCHES
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, metrics = built.fn(state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                steps.append({"wall_s": time.perf_counter() - t1,
                              "loss": loss,
                              "grad_norm": float(metrics["grad_norm"]),
                              "launches": counter.LAUNCHES - before})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        first = steps[0]
        loss_err = abs(loss_k - loss_ref) / abs(loss_ref)
        norm_err = abs(norm_k - norm_ref) / norm_ref
        tail_err = abs(tail_k - tail_ref) / tail_ref
        if first["loss"] != loss_k:
            fail(f"{arch}: the step's loss {first['loss']} is not its "
                 f"forward's {loss_k}")
        print(f"  {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.dtype} parameters, float32 AdamW state, batch "
              f"{TRAIN_B} x {TRAIN_S}; {card_line}): peak "
              f"{peak:.2f} GiB allocated")
        for i, st in enumerate(steps):
            print(f"    step {i}: wall {st['wall_s'] * 1e3:.1f} ms, loss "
                  f"{st['loss']:.5f}, grad_norm {st['grad_norm']:.4f}, "
                  f"{kernel} launches {st['launches']}")
        print(f"    first step through the kernels against impl='ref': loss "
              f"{loss_k:.5f} / {loss_ref:.5f} (rel err {loss_err:.3e}), "
              f"gradient norm (float64 sum) {norm_k:.6e} / {norm_ref:.6e} "
              f"(rel err {norm_err:.3e}, printed only), the final norm's "
              f"and the last layer's after its attention {tail_k:.6e} / "
              f"{tail_ref:.6e} (rel err {tail_err:.3e})")
        if not all(math.isfinite(st["loss"]) for st in steps):
            fail(f"{arch}: a training loss is not finite")
        want = train_launches(cfg, cfg.n_layers)
        if any(st["launches"] != want for st in steps):
            fail(f"{arch}: {kernel} launched {[st['launches'] for st in steps]}"
                 f" times in the steps, not {want} a step")
        if loss_err > 2e-2 or tail_err > 5e-2:
            fail(f"{arch}: the first step's loss or its last layer's "
                 "gradient norm is off impl='ref' by more than the bf16 "
                 "tolerance")
        out[arch] = {"n_layers": cfg.n_layers, "steps": steps,
                     "peak_gib": peak, "loss_ref": loss_ref,
                     "grad_norm_ref": norm_ref, "grad_norm_kernel": norm_k,
                     "tail_grad_norm_ref": tail_ref,
                     "tail_grad_norm_kernel": tail_k,
                     "tail_grad_norm_rel_err": tail_err,
                     "loss_rel_err": loss_err,
                     "grad_norm_rel_err": norm_err,
                     "seconds": time.perf_counter() - t0}
        del state, built, bundle, params, batches
        release()
    return out


#: phase 28: examples/torch_train_with_failures.py's 100m preset and
#: cluster, TRAIN_LOOP_STEPS steps, one deterministic failure
TRAIN_LOOP_STEPS = 12
TRAIN_LOOP_FAILURE = 9
#: no clipping: the random init's gradient explodes through the layers
#: (its norm is printed), and a unit clip scales every gradient below
#: AdamW's eps, so nothing would learn in these steps
TRAIN_LOOP_CLIP = float("inf")


def train_loop_phase(core):
    """Phase 28: the fault-tolerant loop at the example's 100m preset,
    with the example's cluster and a failure injected at step
    TRAIN_LOOP_FAILURE (checkpoints in a temporary directory), then the
    same run without injection: recovery stats, cadence, the two runs'
    final parameters, and the loss falling on a held-out batch (each
    step's loss is on its own random batch, whose spread over the run's
    steps is as large as the fall)."""
    import shutil
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.loop import TrainLoopConfig, train
    from repro_torch.train.optimizer import OptimizerConfig
    t0 = time.perf_counter()
    cfg = ModelConfig(name="lm-100m", family="dense", n_layers=12,
                      d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                      vocab_size=32768, dtype="float32")
    shape = ShapeSpec("train", 512, 8, "train")
    steps = TRAIN_LOOP_STEPS
    cluster = core.Params(job_size=64, working_pool_size=72, spare_pool_size=8,
                          warm_standbys=4,
                          random_failure_rate=1.0 / core.MINUTES_PER_DAY,
                          systematic_failure_rate=5.0 / core.MINUTES_PER_DAY,
                          job_length=steps * 1.0)
    bundle, mesh = build_model(cfg), make_host_mesh()
    runs, finals = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for label, inject in (("failure", True), ("clean", False)):
            ckdir = os.path.join(tmp, label)
            t1 = time.perf_counter()
            runs[label] = train(
                bundle, mesh, shape,
                TrainLoopConfig(total_steps=steps, log_every=5,
                                checkpoint_dir=ckdir,
                                checkpoint_cost_minutes=0.5,
                                step_minutes=1.0, inject_failures=inject,
                                deterministic_failure_steps=[
                                    TRAIN_LOOP_FAILURE],
                                cluster=cluster, seed=0),
                OptimizerConfig(learning_rate=3e-3,
                                warmup_steps=max(steps // 10, 1),
                                total_steps=steps, min_lr_fraction=0.5,
                                clip_norm=TRAIN_LOOP_CLIP))
            runs[label]["run_s"] = time.perf_counter() - t1
            finals[label] = restore_checkpoint(ckdir)[1]["params"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run = runs["failure"]
    hist = run["history"]
    for h in hist:
        print(f"    step {h['step']:3d}: loss {h['loss']:.4f}, grad_norm "
              f"{h['grad_norm']:.4e}, {h['step_time_s'] * 1e3:.1f} ms")
    diff = max(float((finals["failure"][k] - t).abs().max())
               for k, t in finals["clean"].items())
    # the loop's initial parameters (bundle.init(seed 0) on the card) and
    # its final ones on a batch no step read
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len + 1,
        global_batch=shape.global_batch, seed=0))
    held = {k: torch.as_tensor(v[:, :shape.seq_len]).cuda()
            for k, v in pipe.batch_at(10 ** 6).items()}
    with torch.no_grad():
        first = float(bundle.loss(bundle.init(0).state_dict(), held)[0])
        last = float(bundle.loss({k: t.cuda() for k, t in
                                  finals["failure"].items()}, held)[0])
    print(f"  {cfg.name}, {steps} steps of {shape.global_batch} x "
          f"{shape.seq_len}: recovery {run['recovery']}, Young/Daly cadence "
          f"every {run['checkpoint_cadence']} steps, held-out loss "
          f"{first:.4f} -> {last:.4f}; walls {runs['failure']['run_s']:.2f} s / "
          f"{runs['clean']['run_s']:.2f} s (failure / clean); largest "
          f"difference of the final parameters from the clean run {diff:.3e}")
    if run["recovery"]["n_restores"] < 1:
        fail("the loop did not restore from a checkpoint")
    if not last < first - 0.01:
        fail(f"the loss did not fall ({first:.4f} -> {last:.4f})")
    out = {"recovery": run["recovery"],
           "checkpoint_cadence": run["checkpoint_cadence"],
           "first_loss": first, "last_loss": last,
           "clean_recovery": runs["clean"]["recovery"],
           "final_param_max_abs_diff": diff,
           "walls_s": {k: r["run_s"] for k, r in runs.items()},
           "seconds": time.perf_counter() - t0}
    print(f"  phase 28: {out['seconds']:.3f} s")
    return out


#: phase 29: the MoE configs at full width, cut in depth to fit one card
#: (kimi-k2: 38.9 GB a layer of its 61 in bf16; arctic: 27.7 GB a layer of
#: its 35); jamba's smallest stack, one superblock of 8 layers, is 90.5 GB
#: at full width, so it runs at smoke width (float32 A/B)
MOE_SERVE = (("kimi-k2-1t-a32b", 1), ("arctic-480b", 2))
MOE_AB_ARCH = "jamba-1.5-large-398b"
#: phase 29d: the card's float32 train step against the CPU's, relative
#: difference of each metric (2.5e-6 to 7.5e-6 measured on an H100)
MOE_TRAIN_REL = 1e-4


def moe_expert_ms(prof, n_moe, bound_ms, label):
    """Device time of the expert GEMMs in a profile of one forward: the
    kernels of the ``torch.bmm`` calls ``MoE.forward`` makes itself, three
    a MoE layer (attention's projections reach ``aten::bmm`` under
    ``aten::einsum``; the MLPs and the head ``aten::mm`` under
    ``aten::matmul``).  Fails where the profile shows another count,
    attributes no kernel, or a time under ``bound_ms`` (more than 5%
    under it: the bound or the attribution would be wrong)."""
    gemms = [e for e in prof.events()
             if e.name == "aten::bmm" and e.cpu_parent is None]
    total = sum(e.device_time_total for e in gemms) / 1e3
    if len(gemms) != 3 * n_moe or not total > 0:
        fail(f"{label}: expert GEMMs not measured: {len(gemms)} top-level "
             f"bmm calls (want {3 * n_moe}), {total} ms of kernels")
    if bound_ms > 1.05 * total:
        fail(f"{label}: expert GEMMs {total:.3f} ms, under their bound "
             f"{bound_ms:.3f} ms")
    return total


def moe_expert_bound_ms(cfg, rows):
    """Least time of the expert GEMMs of one forward with ``rows`` = B*C
    slots an expert: every MoE layer's expert weights read once, its slot
    buffer read and its output written once (bf16); 6 E rows D F
    operations a layer at the bf16 peak."""
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    weight_bytes = n_moe * 3 * E * D * F_ * 2
    nbytes = weight_bytes + n_moe * 2 * E * rows * D * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_moe * 6 * E * rows * D * F_ / BF16_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", weight_bytes / HBM_BYTES_PER_S * 1e3)


def moe_serving_extra(fa):
    """Phase 29a's checks on a served MoE model, before it is released:
    the attention kernel against its plain version at the model's head
    shapes; the first MoE layer's drop fraction on the prefill's input;
    a traced prefill and a traced decode step, the expert GEMMs' device
    time against their bound; the peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref
    from repro_torch.models.moe import moe_capacity

    def extra(bundle, model, prompts, rec, cross):
        cfg = bundle.cfg
        B, S = prompts.shape
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        bf16 = torch.bfloat16
        errs = []
        for shape, kw in (
                ((B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                 dict(causal=True)),
                ((B, 1, S_MAX, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                 dict(causal=False, kv_len=S_MAX))):
            q, k, v = attn_inputs(*shape, bf16, seed=29)
            err, within = close_err(fa.flash_attention_cuda(q, k, v, **kw),
                                    ref.attention_ref(q, k, v, **kw), 2e-2)
            if not within:
                fail(f"{cfg.name}: attention kernel disagrees with "
                     f"attention_ref at {shape} (max abs err {err:.3e})")
            errs.append(err)
        print(f"  attention kernel at {cfg.n_heads}/{cfg.n_kv_heads} heads, "
              f"d {cfg.head_dim}, bf16: prefill max abs err {errs[0]:.3e}, "
              f"decode (kv_len {S_MAX}) {errs[1]:.3e}")

        first = next(layer.moe for layer in model.stack if layer.has_moe)
        seen = []
        hook = first.register_forward_hook(
            lambda mod, inp, out: seen.append(out[1]["moe_drop_fraction"]))
        C_pre, C_dec = moe_capacity(cfg, S), moe_capacity(cfg, 1)
        pre_bound, pre_by, _ = moe_expert_bound_ms(cfg, B * C_pre)
        dec_bound, dec_by, weights_ms = moe_expert_bound_ms(cfg, B * C_dec)
        try:
            cache = bundle.make_cache(B, S_MAX)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                logits, cache = bundle.prefill(model, {"tokens": prompts},
                                               cache)
                torch.cuda.synchronize()
            pre_ms = moe_expert_ms(prof, n_moe, pre_bound,
                                   f"{cfg.name} prefill")
            t0 = time.perf_counter()                      # warm, untraced
            logits, cache = bundle.prefill(model, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
            warm_pre_ms = (time.perf_counter() - t0) * 1e3
            tok = logits[:, -1].argmax(-1, keepdim=True)
            bundle.decode(model, tok, cache, S)           # warm
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                bundle.decode(model, tok, cache, S + 1)
                torch.cuda.synchronize()
            dec_ms = moe_expert_ms(prof, n_moe, dec_bound,
                                   f"{cfg.name} decode")
            dec_busy = device_seconds(prof) * 1e3
        finally:
            hook.remove()
        drop = float(seen[0])
        step_ms = rec["decode_ms_per_step"]
        peak = torch.cuda.max_memory_allocated()
        rec.update(
            n_layers=cfg.n_layers, peak_bytes=peak, first_moe_drop=drop,
            warm_prefill_ms=warm_pre_ms,
            attention_max_abs_err=errs[0],
            attention_decode_max_abs_err=errs[1],
            prefill_expert_ms=pre_ms, prefill_expert_bound_ms=pre_bound,
            prefill_expert_bound_by=pre_by, decode_expert_ms=dec_ms,
            decode_expert_bound_ms=dec_bound, decode_expert_bound_by=dec_by,
            decode_weights_bound_ms=weights_ms,
            traced_decode_device_ms=dec_busy,
            decode_step_over_bound=step_ms / dec_bound)
        print(f"  {cfg.name} at {cfg.n_layers} layer(s): peak "
              f"{peak / 2 ** 30:.2f} GiB allocated; the first MoE layer "
              f"drops {drop * 100:.3f}% of the prefill's {B * S * cfg.top_k}"
              f" assignments (capacity {C_pre} a group)")
        print(f"  expert GEMMs, traced: prefill {pre_ms:.3f} ms (bound "
              f"{pre_bound:.3f} ms, {pre_by}, "
              f"{pre_bound / pre_ms * 100:.2f}% of it); decode step "
              f"{dec_ms:.3f} ms of {dec_busy:.3f} ms device (bound "
              f"{dec_bound:.3f} ms, {dec_by}, {dec_bound / dec_ms * 100:.2f}%"
              f" of it; the expert weights alone {weights_ms:.3f} ms)")
        print(f"  decode {step_ms:.3f} ms a step = "
              f"{step_ms / dec_bound:.3f}x the expert bound; a warm prefill "
              f"(its shapes seen once) {warm_pre_ms:.3f} ms")
        if not (math.isfinite(drop) and 0.0 <= drop < 1.0):
            fail(f"{cfg.name}: drop fraction {drop}")
    return extra


def moe_ab_phase(fa, ms):
    """Phase 29b: jamba's smoke config (attention + Mamba + MoE) on the
    card in float32: the launches of a served prompt, then each layer
    through the kernels and through the plain versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(MOE_AB_ARCH, smoke=True)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    bundle = build_model(cfg, device="cuda", dtype=torch.float32)
    model = bundle.init(SEED)
    prompts = prompts_for(cfg)
    generate(bundle, model, prompts[:, :16], None, fa, ms, n_new=3)
    fa.LAUNCHES = ms.LAUNCHES = 0            # the main path's run
    out = generate(bundle, model, prompts, None, fa, ms)
    want = ((n_attn, n_ssm), (n_attn * GEN_TOKENS, n_ssm))
    got = (out["after_prefill"], out["after_decode"])
    print(f"  {cfg.name} smoke ({cfg.n_layers} layers: {n_attn} attention, "
          f"{n_ssm} Mamba, {n_moe} MoE with {cfg.n_experts} experts top-"
          f"{cfg.top_k}) float32: launches (attention, scan) {got[0]} after "
          f"the prefill, {got[1]} in all; prefill "
          f"{out['prefill_s'] * 1e3:.3f} ms, decode "
          f"{out['decode_s'] * 1e3 / (GEN_TOKENS - 1):.3f} ms a step")
    if got != want or not out["finite"]:
        fail(f"{cfg.name} smoke: launches {got}, want {want}; finite "
             f"logits {out['finite']}")
    launches = got[1]
    share, rel, rows_off = layerwise_ab(bundle, model, prompts)
    print(f"  layer by layer on the same input (prefill + 1 decode step, "
          f"the MoE layers included): worst share of elements within "
          f"{AB_ELEM_TOL} of the scale {share * 100:.4f}%, largest relative "
          f"difference {rel:.3e}, rows beyond it {rows_off}")
    if share < AB_ELEM_SHARE:
        fail(f"{cfg.name} smoke float32: a layer through the kernels "
             f"disagrees with the plain one on {(1 - share) * 100:.4f}% of "
             f"its elements")
    fa.LAUNCHES, ms.LAUNCHES = launches
    del model
    release()
    return {"arch": f"{cfg.name} (smoke)", "dtype": "float32",
            "attention_launches": launches[0], "scan_launches": launches[1],
            "layer_share_within": share, "layer_max_rel_err": rel,
            "layer_rows_beyond": rows_off, "prefill_s": out["prefill_s"],
            "decode_s": out["decode_s"]}


def moe_train_phase(fa, ms):
    """Phase 29d: ``make_train_step`` on the three MoE smoke configs in
    float32, on the card (the default device), one step each against the
    same step on the CPU from the same weights and batch: the loss, the
    aux metrics and the gradient norm, and the kernels' launches (one a
    kernel layer on the card, none on the CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    shape = ShapeSpec("moe_train", 64, 4, "train")
    opt_cfg = OptimizerConfig()
    out = {}
    for arch in (*(a for a, _ in MOE_SERVE), MOE_AB_ARCH):
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
        pipe = SyntheticTokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len + 1,
            global_batch=shape.global_batch, seed=SEED))
        batch = {k: torch.as_tensor(v[:, :shape.seq_len])
                 for k, v in pipe.batch_at(0).items()}
        card = build_model(cfg)
        weights = card.init(SEED).state_dict()
        runs = {}
        for dev, bundle in (("cuda", card),
                            ("cpu", build_model(cfg, device="cpu"))):
            params = {k: t.detach().clone().to(dev)
                      for k, t in weights.items()}
            state = {"params": params, "opt": init_opt_state(params,
                                                              opt_cfg)}
            mesh = make_host_mesh(device=dev)
            built = make_train_step(bundle, mesh, shape, opt_cfg)
            before = (fa.LAUNCHES, ms.LAUNCHES)
            with mesh:
                _, metrics = built.fn(state, {k: v.to(dev)
                                              for k, v in batch.items()})
            runs[dev] = ({k: float(v) for k, v in metrics.items()},
                         (fa.LAUNCHES - before[0], ms.LAUNCHES - before[1]))
            fa.LAUNCHES, ms.LAUNCHES = before
        got, want = runs["cuda"][0], runs["cpu"][0]
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
               for k in want}
        launches = {d: r[1] for d, r in runs.items()}
        print(f"  {cfg.name} smoke: loss {got['loss']:.6f} (cpu "
              f"{want['loss']:.6f}), load balance "
              f"{got['moe_load_balance']:.6f}, z {got['moe_z_loss']:.6f}, "
              f"drops {got['moe_drop_fraction']:.6f}; largest relative "
              f"difference card against CPU {max(rel.values()):.3e} "
              f"({max(rel, key=rel.get)}); launches {launches}")
        want_launches = {"cuda": (train_launches(cfg, kinds.count("attn")),
                                  train_launches(cfg, kinds.count("ssm"))),
                         "cpu": (0, 0)}
        if (sorted(got) != sorted(want) or "moe_z_loss" not in got
                or max(rel.values()) > MOE_TRAIN_REL
                or launches != want_launches):
            fail(f"{cfg.name} smoke: the card's train step against the "
                 f"CPU's: {rel}, launches {launches}, want {want_launches}")
        out[cfg.name] = {"metrics": got, "cpu_metrics": want,
                         "max_rel_diff": max(rel.values()),
                         "launches": launches["cuda"]}
    return out


def moe_dispatch_phase():
    """Phase 29c: ``_dispatch_one_group`` on the card bit for bit the
    CPU's at kimi-k2's full prefill shape (a non-stable sort or a scatter
    race would show), and its time on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _dispatch_one_group, moe_capacity
    cfg = get_config(MOE_SERVE[0][0])
    B, S, E, k, D = (SERVE_BATCH, PROMPT_LEN, cfg.n_experts, cfg.top_k,
                     cfg.d_model)
    C = moe_capacity(cfg, S)
    rng = np.random.default_rng(SEED)
    probs = torch.softmax(torch.as_tensor(
        rng.standard_normal((B, S, E), dtype=np.float32)), -1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    x = torch.as_tensor(rng.standard_normal((B, S, D), dtype=np.float32)
                        ).to(torch.bfloat16)
    host = _dispatch_one_group(x, top_idx, top_w, E, C)
    args = [t.cuda() for t in (x, top_idx, top_w)]
    card = _dispatch_one_group(*args, E, C)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(a.cpu(), b)) for name, a, b in zip(
        ("buffer", "tok_slot", "w_slot"), card, host)}
    routed = int((host[1] < S).sum())
    t = device_ms(lambda: _dispatch_one_group(*args, E, C), 20)
    print(f"  B {B}, S {S}, E {E}, k {k}, C {C}, D {D} (bf16): identical "
          f"to the CPU's {same}; {routed} of {B * S * k} assignments routed;"
          f" device {t} ms a call")
    if not all(same.values()):
        fail(f"the card's dispatch differs from the CPU's: {same}")
    return {"shape": [B, S, E, k, C, D], "identical": same,
            "routed": routed, "assignments": B * S * k, "ms": t}


#: phase 30: the cross-attention models.  whisper-base at full size (6
#: encoder and 6 decoder layers): 4 requests of 1,500 frames each (30 s of
#: audio after the stubbed conv frontend), a 64-token prompt and 32 new
#: tokens, inside its 448-token decoder context.  llama-3.2-vision-90b at
#: full width cut to 2 of its 20 superblocks (10 of 100 layers, 2 of them
#: cross layers; 10.97 B parameters, 21.9 GB in bf16): 4 x 512 prompt
#: tokens over 1,600 image tokens, as phase 29a serves.  (arch, layers or
#: None for all, prompt tokens)
CROSS_SERVE = (("whisper-base", None, 64),
               ("llama-3.2-vision-90b", 10, PROMPT_LEN))
#: phase 30c: the float32 A/B: (arch, smoke config, prompt tokens)
CROSS_AB = (("whisper-base", False, 64),
            ("llama-3.2-vision-90b", True, PROMPT_LEN))
#: phase 30d: the attention kernel alone at the shapes phase 30's serving
#: runs give it: (label, (B, Sq, Sk, Hq, Hkv, d), keywords, dtype)
CROSS_REGIMES = (
    ("whisper encoder", (4, 1500, 1500, 8, 8, 64), {"causal": False},
     "bfloat16"),
    ("whisper encoder, float32 frames", (4, 1500, 1500, 8, 8, 64),
     {"causal": False}, "float32"),
    ("whisper self prefill", (4, 64, 64, 8, 8, 64), {"causal": True},
     "bfloat16"),
    ("whisper self decode", (4, 1, 96, 8, 8, 64),
     {"causal": False, "kv_len": 80}, "bfloat16"),
    ("whisper cross prefill", (4, 64, 1500, 8, 8, 64), {"causal": False},
     "bfloat16"),
    ("whisper cross decode", (4, 1, 1500, 8, 8, 64), {"causal": False},
     "bfloat16"),
    ("vision self prefill", (4, 512, 512, 64, 8, 128), {"causal": True},
     "bfloat16"),
    ("vision cross prefill", (4, 512, 1600, 64, 8, 128), {"causal": False},
     "bfloat16"),
    ("vision cross decode", (4, 1, 1600, 64, 8, 128), {"causal": False},
     "bfloat16"),
)
#: phase 30e: whisper-base's training batch is TRAIN_B x its decoder's
#: 448-token context, over 1,500 frames
CROSS_TRAIN_S = 448
#: phase 30e: the card's float32 train step against the CPU's on the two
#: smoke configs: the loss within MOE_TRAIN_REL, the gradient norm within
#: this.  Their gradient norms are ill-conditioned at the reference's
#: random weights (near one-hot attention): on the CPU a 1e-7 relative
#: perturbation of the weights moves them 9.6e-5 (whisper) and 3.1e-4
#: (llama-vision), and float32 against float64 differs by 1.7e-4 and
#: 6.5e-4, where the dense and MoE smoke configs move 6e-6.
CROSS_GRAD_NORM_REL = 1e-3


def decode_bound_ms(cfg, model, batch, kv_len):
    """Least time of one bf16 decode step at the card's memory rate, and
    that of its weights alone: every weight the step reads once (not the
    encoder or ``img_proj``, which decode does not run; of the embedding
    table its ``batch`` rows unless it is the tied head), the self caches
    up to ``kv_len`` and the cross caches whole."""
    sd = model.state_dict()
    wbytes = sum(t.numel() * t.element_size() for k, t in sd.items()
                 if k not in ("embed", "img_proj")
                 and not k.startswith("encoder."))
    emb = sd["embed"]
    wbytes += (emb.numel() if cfg.tie_embeddings
               else batch * cfg.d_model) * emb.element_size()
    n_cross = sum(cfg.layer_has_cross_attn(i) for i in range(cfg.n_layers))
    n_self = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    from repro_torch.models.model_zoo import cross_len
    kv_bytes = (2 * batch * cfg.n_kv_heads * cfg.head_dim * 2
                * (n_self * kv_len + n_cross * cross_len(cfg)))
    return ((wbytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
            wbytes / HBM_BYTES_PER_S * 1e3)


#: phase 30a/b: calls of the cross source a trace averages over
CROSS_SOURCE_ITERS = 5


def cross_serving_extra(bundle, model, prompts, rec, cross):
    """Phase 30a/b's checks on a served cross-attention model, before it
    is released: the cross source alone traced (the encoder's or the
    image projection's device time a call and its share of the traced
    prefill's, and the attention kernels' time in it), the decode step
    against its bytes bound, the peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = bundle.cfg
    (key, x), = cross.items()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CROSS_SOURCE_ITERS):
            model.cross_source(x)
        torch.cuda.synchronize()
    # printed only: the launch counts already show the encoder's attention
    # launches, and a trace may show no device event (profiled_ms)
    src_s = device_seconds(prof) / CROSS_SOURCE_ITERS
    attn_s = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA")
                 and "attn_" in e.key) / 1e6 / CROSS_SOURCE_ITERS
    step_ms = rec["decode_ms_per_step"]
    kv = prompts.shape[1] + GEN_TOKENS // 2
    bound, weights = decode_bound_ms(cfg, model, prompts.shape[0], kv)
    peak = torch.cuda.max_memory_allocated()
    what = "encoder" if cfg.is_encdec else "img_proj"
    rec.update(n_layers=cfg.n_layers, peak_bytes=peak, cross_input=key,
               traced_cross_source_device_s=src_s,
               traced_cross_source_attention_s=attn_s,
               decode_bound_ms=bound, decode_weights_bound_ms=weights,
               decode_step_over_bound=step_ms / bound)
    print(f"  traced {what} alone ({key} {tuple(x.shape)}, "
          f"{CROSS_SOURCE_ITERS} calls): device {src_s * 1e3:.3f} ms a call = "
          f"{src_s / (rec['traced_prefill_device_s'] or math.nan) * 100:.2f}"
          "% of the "
          f"traced prefill's, attention kernels {attn_s * 1e3:.3f} ms of it")
    print(f"  decode {step_ms:.3f} ms a step = {step_ms / bound:.3f}x its "
          f"bytes bound {bound:.3f} ms (the weights alone {weights:.3f} ms, "
          f"3.35 TB/s); peak {peak / 2 ** 30:.2f} GiB allocated")


def cross_regimes_phase(fa, ref):
    """Phase 30d: the attention kernel alone at each shape phase 30's
    serving runs give it, against ``attention_ref`` (phase 3's
    tolerances), timed beside its bound, the plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never
    calls)."""
    import torch
    import torch.nn.functional as F
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    out = []
    launches = fa.LAUNCHES
    for i, (label, shape, kw, dname) in enumerate(CROSS_REGIMES):
        dtype = getattr(torch, dname)
        q, k, v = attn_inputs(*shape, dtype, seed=300 + i)
        route = ("decode" if fa.takes_decode(q, k) else
                 "tile" if dtype == torch.bfloat16 else "float32 SIMT")
        err, within = close_err(fa.flash_attention_cuda(q, k, v, **kw),
                                ref.attention_ref(q, k, v, **kw), tol[dtype])
        if not within:
            fail(f"attention kernel disagrees with attention_ref at {label} "
                 f"{shape} {dname} (max abs err {err:.3e}, tolerance "
                 f"{tol[dtype]})")
        n = kw.get("kv_len", shape[2])
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k[:, :n], v[:, :n]))
        rec = {"label": label, "shape": list(shape), "dtype": dname,
               "route": route, **kw, "max_abs_err": err}
        for key, fn, iters in (
                ("ms", lambda: fa.flash_attention_cuda(q, k, v, **kw), 20),
                ("plain_ms", lambda: ref.attention_ref(q, k, v, **kw), 5),
                ("library_ms", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=kw["causal"], enable_gqa=True),
                 20)):
            rec[key], rec[f"{key}_source"] = profiled_ms(fn, iters)
        rec["bound_ms"], rec["bound_by"] = attn_bound_ms(
            q, k, kw["causal"], kv_len=kw.get("kv_len"))
        print(f"  {label} {shape} {dname} ({route} kernel): max abs err "
              f"{err:.3e}; " + ", ".join(
                  f"{what} {rec[key]:.6f} ms ({rec[key + '_source']})"
                  for what, key in (("device", "ms"), ("plain", "plain_ms"),
                                    ("scaled_dot_product_attention",
                                     "library_ms")))
              + f"; bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
        out.append(rec)
        del q, k, v, qt, kt, vt
    fa.LAUNCHES = launches
    release()
    return out


def cross_ab_phase(fa, ms):
    """Phase 30c: float32 weights through the kernels and through the
    plain versions, a layer at a time on the plain path's input: the
    encoder's layers, then the decoder's over the plain path's cross
    source, held to phase 9's rule."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    out = []
    for arch, smoke, prompt_len in CROSS_AB:
        cfg = get_config(arch, smoke=smoke)
        bundle = build_model(cfg, device="cuda", dtype=torch.float32)
        model = bundle.init(SEED)
        prompts = prompts_for(cfg, prompt_len)
        (key, x), = cross_inputs_for(cfg, torch.float32).items()
        enc_share, enc_rel, enc_rows = 1.0, 0.0, 0
        with torch.no_grad():
            if cfg.is_encdec:
                h = x
                for layer in model.encoder.stack:
                    o = {impl: layer(h, cache=None, pos=0, causal=False,
                                     impl=impl) for impl in ("ref", "cuda")}
                    share, rel, rows = ab_stats(o)
                    enc_share = min(enc_share, share)
                    enc_rel, enc_rows = max(enc_rel, rel), enc_rows + rows
                    h = o["ref"]
                src = model.encoder.final_norm(h)
            else:
                src = model.cross_source(x, impl="ref")
        share, rel, rows = layerwise_ab(bundle, model, prompts, cross_src=src)
        label = f"{arch}{' (smoke)' if smoke else ''}"
        print(f"  {label} float32, layer by layer on the same input: "
              + (f"encoder worst share within {AB_ELEM_TOL} of the scale "
                 f"{enc_share * 100:.4f}%, largest relative difference "
                 f"{enc_rel:.3e}, rows beyond it {enc_rows}; "
                 if cfg.is_encdec else "")
              + f"decoder (prefill over {key}, 1 decode step over the cross "
              f"caches) {share * 100:.4f}%, {rel:.3e}, {rows}")
        if min(share, enc_share) < AB_ELEM_SHARE:
            fail(f"{label} float32: a layer through the kernels disagrees "
                 f"with the plain one on more than "
                 f"{(1 - AB_ELEM_SHARE) * 100:.4f}% of its elements")
        out.append({"arch": label, "dtype": "float32",
                    "encoder_share_within": enc_share,
                    "encoder_max_rel_err": enc_rel,
                    "encoder_rows_beyond": enc_rows,
                    "layer_share_within": share, "layer_max_rel_err": rel,
                    "layer_rows_beyond": rows})
        del model, src
        release()
    return out


def cross_train_phase(fa, ms, card_line):
    """Phase 30e: ``make_train_step`` on the two smoke configs in float32,
    on the card against the CPU from the same weights and the pipeline's
    stubbed batch (float32 frames or image embeddings): the loss within
    MOE_TRAIN_REL, the gradient norm within CROSS_GRAD_NORM_REL, and the
    attention launches; then three steps of whisper-base at full size
    (bf16 parameters, float32 AdamW state, the encoder in float32 on the
    float32 frames): finite losses and the attention launches a step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    def batches(cfg, shape, n):
        pipe = SyntheticTokenPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len + 1,
            global_batch=shape.global_batch, seed=SEED))
        out = []
        for _ in range(n):
            b = {k: v[:, :shape.seq_len] for k, v in next(pipe).items()}
            out.append({k: torch.as_tensor(v) for k, v in
                        pipe.with_frontend_stubs(b, cfg).items()})
        return out

    shape = ShapeSpec("cross_train", 64, 4, "train")
    opt_cfg = OptimizerConfig()
    out = {}
    for arch, _, _ in CROSS_AB:
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        (batch,) = batches(cfg, shape, 1)
        card = build_model(cfg)
        weights = card.init(SEED).state_dict()
        runs = {}
        for dev, bundle in (("cuda", card),
                            ("cpu", build_model(cfg, device="cpu"))):
            params = {k: t.detach().clone().to(dev)
                      for k, t in weights.items()}
            state = {"params": params, "opt": init_opt_state(params,
                                                              opt_cfg)}
            mesh = make_host_mesh(device=dev)
            built = make_train_step(bundle, mesh, shape, opt_cfg)
            before = fa.LAUNCHES
            with mesh:
                _, metrics = built.fn(state, {k: v.to(dev)
                                              for k, v in batch.items()})
            runs[dev] = ({k: float(v) for k, v in metrics.items()},
                         fa.LAUNCHES - before)
            fa.LAUNCHES = before
        got, want = runs["cuda"][0], runs["cpu"][0]
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
               for k in want}
        launches = {d: r[1] for d, r in runs.items()}
        want_launches = {"cuda": train_launches(
            cfg, attention_launches(cfg)[0]), "cpu": 0}
        print(f"  {cfg.name} smoke: loss {got['loss']:.6f} (cpu "
              f"{want['loss']:.6f}), grad_norm {got['grad_norm']:.6f} (cpu "
              f"{want['grad_norm']:.6f}); relative difference card against "
              f"CPU {rel}; attention launches {launches}")
        if (sorted(got) != sorted(want)
                or max(v for k, v in rel.items() if k != "grad_norm")
                > MOE_TRAIN_REL or rel["grad_norm"] > CROSS_GRAD_NORM_REL
                or launches != want_launches):
            fail(f"{cfg.name} smoke: the card's train step against the "
                 f"CPU's: {rel}, launches {launches}, want {want_launches}")
        out[cfg.name] = {"metrics": got, "cpu_metrics": want,
                         "rel_diff": rel, "launches": launches["cuda"]}

    cfg = get_config("whisper-base")
    shape = ShapeSpec("train", CROSS_TRAIN_S, TRAIN_B, "train")
    opt_cfg = OptimizerConfig(learning_rate=1e-4, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    bundle = build_model(cfg)
    params = {k: p.detach() for k, p in bundle.init(SEED).state_dict().items()}
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    built = make_train_step(bundle, make_host_mesh(), shape, opt_cfg)
    steps = []
    with make_host_mesh():
        for batch in batches(cfg, shape, TRAIN_STEPS):
            before = fa.LAUNCHES
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = built.fn(state, {k: v.cuda()
                                              for k, v in batch.items()})
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"wall_s": time.perf_counter() - t1, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "launches": fa.LAUNCHES - before})
            fa.LAUNCHES = before
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {cfg.name} at full size ({cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, bf16 parameters, float32 AdamW state, batch {TRAIN_B} x "
          f"{CROSS_TRAIN_S} tokens over {cfg.encoder_seq} float32 frames; "
          f"{card_line}): peak {peak:.2f} GiB allocated")
    for i, st in enumerate(steps):
        print(f"    step {i}: wall {st['wall_s'] * 1e3:.1f} ms, loss "
              f"{st['loss']:.5f}, grad_norm {st['grad_norm']:.4f}, "
              f"attention launches {st['launches']}")
    want = train_launches(cfg, attention_launches(cfg)[0])
    if not all(math.isfinite(st["loss"]) for st in steps) or any(
            st["launches"] != want for st in steps):
        fail(f"{cfg.name}: losses {[st['loss'] for st in steps]}, attention"
             f" launches {[st['launches'] for st in steps]}, want {want} a "
             "step")
    out[cfg.name] = {"steps": steps, "peak_gib": peak}
    del state, built, bundle, params
    release()
    return out


#: phase 31: the mesh steps on a one-rank NCCL mesh (and two ranks on two
#: cards): the models, with the depth of phase 27 for falcon-mamba-7b and
#: of phase 29a for kimi-k2
MESH_AXES = ("data", "model")
MESH_SERVE = (("qwen2.5-3b", None), ("falcon-mamba-7b", 4))
MESH_MOE = ("kimi-k2-1t-a32b", 1)
MESH_MOE_MODES = ("shard_map", "ep")
#: the bf16 rule of phases 3 and 29 (close_err: |a-b| <= tol + tol*|b|)
MESH_BF16_TOL = 2e-2
MESH_TIMEOUT_S = 300


def generate_on_mesh(bundle, mesh, params, prompts, fa, ms, n_new=None,
                     pcfg=None, keep=False):
    """``generate`` through the steps of ``parallel.build_step`` on
    ``mesh``: the whole ``params`` placed by the prefill step's specs, the
    prompt and the cache by theirs, each new token by the decode step's;
    with ``keep``, each decode step's last-position logits too."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.parallel import build_step, sharding
    n_new = GEN_TOKENS if n_new is None else n_new
    B, S = prompts.shape
    pre = build_step(bundle, mesh, ShapeSpec("prefill", S, B, "prefill"),
                     pcfg=pcfg)
    dec = build_step(bundle, mesh, ShapeSpec("decode", S + n_new, B,
                                             "decode"), pcfg=pcfg)
    if dec.in_shardings[2] != pre.in_shardings[2]:
        fail(f"{bundle.cfg.name}: the prefill and decode steps place the "
             "cache apart")
    params_l, batch, cache = pre.place(params, {"tokens": prompts},
                                       bundle.make_cache(B, S + n_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre.fn(params_l, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = (fa.LAUNCHES, ms.LAUNCHES)
    logits = pre.gather(logits, pre.out_shardings[0])
    first = logits[:, -1].float().clone()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    ids, finite, steps = [tok], torch.isfinite(logits).all(), []
    t0 = time.perf_counter()
    for step in range(n_new - 1):
        logits, cache = dec.fn(params_l, sharding.place(
            tok, dec.in_shardings[1], mesh), cache, S + step)
        logits = dec.gather(logits, dec.out_shardings[0])
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ids.append(tok)
        finite &= torch.isfinite(logits).all()
        if keep:
            steps.append(logits[:, -1].float().clone())
    torch.cuda.synchronize()
    return {"prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "logits": first, "ids": torch.cat(ids, 1).cpu(),
            "finite": bool(finite), "after_prefill": after_prefill,
            "after_decode": (fa.LAUNCHES, ms.LAUNCHES), "steps": steps,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in params_l.values())}


def generate_steps(bundle, model, prompts, fa, ms, n_new=None):
    """``generate`` off the mesh, keeping each decode step's last-position
    logits (the one-device steps phase 31c holds the mesh's to)."""
    import torch
    n_new = GEN_TOKENS if n_new is None else n_new
    B, S = prompts.shape
    cache = bundle.make_cache(B, S + n_new)
    logits, cache = bundle.prefill(model, {"tokens": prompts}, cache)
    first = logits[:, -1].float().clone()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    ids, steps = [tok], []
    for step in range(n_new - 1):
        logits, cache = bundle.decode(model, tok, cache, S + step)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ids.append(tok)
        steps.append(logits[:, -1].float().clone())
    torch.cuda.synchronize()
    return {"logits": first, "ids": torch.cat(ids, 1).cpu(), "steps": steps}


def mesh_serving_case(arch, n_layers, mesh, fa, ms):
    """Phase 31a for one model: phase 8's serving run off the mesh, then
    through the mesh steps on the same weights, warm both ways; the
    greedy tokens equal, the first logits within the bf16 rule (and their
    bit-different elements), the kernels' launches of the mesh run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    bundle = build_model(cfg)
    model = bundle.init(SEED)
    params = {k: p.detach() for k, p in model.state_dict().items()}
    prompts = prompts_for(cfg)
    counts = (fa.LAUNCHES, ms.LAUNCHES)
    generate(bundle, model, prompts[:, :16], None, fa, ms, n_new=3)
    one = generate(bundle, model, prompts, None, fa, ms)
    generate_on_mesh(bundle, mesh, params, prompts[:, :16], fa, ms, n_new=3)
    fa.LAUNCHES = ms.LAUNCHES = 0            # the mesh path's run
    run = generate_on_mesh(bundle, mesh, params, prompts, fa, ms)
    got = (run["after_prefill"], run["after_decode"])
    fa.LAUNCHES, ms.LAUNCHES = counts
    want = ((n_attn, n_ssm), (n_attn * GEN_TOKENS, n_ssm))
    err, within = close_err(run["logits"], one["logits"], MESH_BF16_TOL)
    n_bits = tensor_bits_apart(run["logits"], one["logits"])
    same_ids = bool(torch.equal(run["ids"], one["ids"]))
    steps = GEN_TOKENS - 1
    rec = {"arch": arch, "n_layers": cfg.n_layers, "mesh": [1, 1],
           "launches_prefill": list(got[0]), "launches": list(got[1]),
           "same_ids": same_ids, "logits_max_abs_err": err,
           "logits_bit_different": n_bits,
           "prefill_ms": run["prefill_s"] * 1e3,
           "one_device_prefill_ms": one["prefill_s"] * 1e3,
           "decode_ms_per_step": run["decode_s"] / steps * 1e3,
           "one_device_decode_ms_per_step": one["decode_s"] / steps * 1e3,
           "param_bytes": run["param_bytes"]}
    print(f"  {arch} ({cfg.n_layers} layers, bf16) on the (1, 1) mesh: "
          f"prefill {rec['prefill_ms']:.3f} ms (one device "
          f"{rec['one_device_prefill_ms']:.3f}), decode "
          f"{rec['decode_ms_per_step']:.3f} ms a step (one device "
          f"{rec['one_device_decode_ms_per_step']:.3f}); launches "
          f"(attention, scan) {got[0]} after the prefill, {got[1]} in all; "
          f"greedy tokens equal: {same_ids}; first logits max abs err "
          f"{err:.3e}, {n_bits} bit-different elements")
    if got != want:
        fail(f"{arch} on the mesh: launches {got}, want {want}")
    if not (same_ids and within and run["finite"]):
        fail(f"{arch} on the mesh: tokens equal {same_ids}, logits within "
             f"{MESH_BF16_TOL} {within}, finite {run['finite']}")
    del model, params
    release()
    return rec, {"ids": one["ids"], "logits": one["logits"].cpu()}


def tensor_bits_apart(a, b) -> int:
    """Elements whose bits differ between two tensors of one dtype."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.numel(), b.numel())
    w = ints[a.element_size()]
    return int((a.contiguous().view(w) != b.contiguous().view(w)).sum())


#: phases 31b and 31d's train step: qwen2.5-3b at full width and this many
#: layers, float32.  At full depth in bf16 its random-weight gradient norm
#: overflows to inf, so the clip scale is 0, the AdamW update is weight
#: decay alone and a wrong gradient would not show
MESH_TRAIN_LAYERS = 2


def train_step_inputs(bundle, device):
    """Phases 31b / 31d's train step: its shape, optimizer config and
    batch (phase 27's, from SEED) on ``device``."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.train.optimizer import OptimizerConfig
    cfg = bundle.cfg
    shape = ShapeSpec("train", TRAIN_S, TRAIN_B, "train")
    opt_cfg = OptimizerConfig(learning_rate=1e-4, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S + 1,
        global_batch=TRAIN_B, seed=SEED))
    batch = {k: torch.as_tensor(v[:, :TRAIN_S]).to(device)
             for k, v in pipe.batch_at(0).items()}
    return shape, opt_cfg, batch


def compare_train_states(got, want, m_got, m_want):
    """A train step's updated state and metrics against another's, by
    tests/test_torch_train_step.py's rule: loss rtol 1e-5, grad_norm rtol
    1e-4 (both finite), lr rtol 1e-6; each moment within 1e-4 (m) / 2e-4
    (v) of its leaf's largest magnitude; each parameter within 2 lr, and
    2e-2 lr where the first moment is resolved (above 1e-2 of its leaf's
    largest).  Returns the metrics, bit-different elements, the largest
    differences and the broken rules."""
    lr = float(m_want["lr"])
    bits = {"params": 0, "m": 0, "v": 0}
    worst = {"params": 0.0, "params_resolved": 0.0, "m": 0.0, "v": 0.0}
    for k, w in want["params"].items():
        m_ref = want["opt"]["m"][k].float()
        for part, a, b in (("params", got["params"][k], w),
                           ("m", got["opt"]["m"][k], want["opt"]["m"][k]),
                           ("v", got["opt"]["v"][k], want["opt"]["v"][k])):
            n = tensor_bits_apart(a, b)
            bits[part] += n
            if not n:
                continue
            diff = (a.float() - b.float()).abs()
            if part == "params":
                worst["params"] = max(worst["params"],
                                      float(diff.max()) / lr)
                resolved = m_ref.abs() > 1e-2 * float(m_ref.abs().max())
                if bool(resolved.any()):
                    worst["params_resolved"] = max(
                        worst["params_resolved"],
                        float(diff[resolved].max()) / lr)
            else:
                scale = max(float(b.float().abs().max()), 1e-30)
                worst[part] = max(worst[part], float(diff.max()) / scale)
    metrics = {k: (float(m_got[k]), float(m_want[k]))
               for k in ("loss", "grad_norm", "lr")}

    def close(a, b, rel):
        return math.isfinite(a) and math.isfinite(b) and (
            a == b or abs(a - b) <= rel * abs(b))
    broken = [f"{k} {metrics[k]} beyond rtol {rel}"
              for k, rel in (("loss", 1e-5), ("grad_norm", 1e-4),
                             ("lr", 1e-6))
              if not close(*metrics[k], rel)]
    broken += [f"{k} {worst[k]} beyond {bound}"
               for k, bound in (("params", 2.0), ("params_resolved", 2e-2),
                                ("m", 1e-4), ("v", 2e-4))
               if worst[k] > bound]
    return {"metrics": metrics, "bit_different": bits, "worst": worst,
            "broken": broken}


def mesh_train_pair(bundle, mesh, fa, pcfg=None, keep=False):
    """One train step from SEED's state on the same batch through the
    one-device ``make_train_step`` on the mesh's device and through
    ``build_step(kind="train")`` on ``mesh`` (under ``pcfg``; None: the
    default, sequence parallelism on), both warm: their times, the mesh
    step's attention launches and the two updated states compared
    (:func:`compare_train_states`); with ``keep``, the mesh step's
    gathered state and metrics too (on the card)."""
    import torch
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.parallel import build_step, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    shape, opt_cfg, batch = train_step_inputs(bundle, mesh.device)
    params = {k: p.detach() for k, p in bundle.init(SEED).state_dict().items()}
    # warm (the first backward of a process sets up its kernels): the
    # forward and backward of both steps' batch, no update
    leaves = {k: p.detach().clone().requires_grad_()
              for k, p in params.items()}
    torch.autograd.grad(bundle.loss(leaves, batch)[0], list(leaves.values()))
    del leaves
    release()
    host = HostMesh(mesh.device)
    one = {"params": {k: p.clone() for k, p in params.items()}}
    one["opt"] = init_opt_state(one["params"], opt_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with host:
        one, m_one = make_train_step(bundle, host, shape, opt_cfg).fn(one,
                                                                      batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    built = build_step(bundle, mesh, shape, opt_cfg, pcfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    state, batch_l = built.place(state, batch)
    before = fa.LAUNCHES
    t0 = time.perf_counter()
    state, m_mesh = built.fn(state, batch_l)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = fa.LAUNCHES - before
    fa.LAUNCHES = before
    state = built.gather(state, built.in_shardings[0])
    rec = compare_train_states(state, one, m_mesh, m_one)
    rec = dict(rec, mesh_ms=mesh_s * 1e3, one_device_ms=one_s * 1e3,
               launches=launches)
    if keep:
        rec["kept"] = (state, m_mesh)
    del one, state, params, batch_l, built
    release()
    return rec


def one_device_spread(bundle, device):
    """Phase 31b's witness: the one-device train step from SEED's state,
    as it is and with its first layer's input perturbed by about one
    float32 rounding (x + |x| 2^-23 N(0, 1), from SEED), compared by
    :func:`compare_train_states`: how far the step's own numbers move
    under the smallest change another summation order makes."""
    import torch
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models.model_zoo import _skeleton
    from repro_torch.parallel import make_train_step
    from repro_torch.train.optimizer import init_opt_state
    shape, opt_cfg, batch = train_step_inputs(bundle, device)
    params = {k: p.detach() for k, p in bundle.init(SEED).state_dict().items()}
    host = HostMesh(device)
    step = make_train_step(bundle, host, shape, opt_cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)

    def nudge(mod, args):
        x = args[0]
        noise = torch.randn(x.shape, generator=gen, device=x.device,
                            dtype=x.dtype)
        return (x + x.abs() * 2.0 ** -23 * noise,) + tuple(args[1:])
    outs = []
    for perturb in (False, True):
        state = {"params": {k: p.clone() for k, p in params.items()}}
        state["opt"] = init_opt_state(state["params"], opt_cfg)
        hook = (_skeleton(bundle.cfg).stack[0].register_forward_pre_hook(
            nudge) if perturb else None)
        try:
            with host:
                outs.append(step.fn(state, batch))
        finally:
            if hook is not None:
                hook.remove()
    (a, m_a), (b, m_b) = outs
    rec = compare_train_states(b, a, m_b, m_a)
    del outs, a, b, params
    release()
    return rec


def mesh_train_case(mesh, fa, card_line):
    """Phase 31b: one step of qwen2.5-3b at full width, MESH_TRAIN_LAYERS
    layers, float32 parameters and AdamW state, through
    ``build_step(kind="train")`` on the mesh against the one-device
    ``make_train_step`` on the same state and batch: finite metrics and
    the updated state within tests/test_torch_train_step.py's tolerances
    (:func:`compare_train_states`; one rank gives them bit for bit).
    Beside it, the one-device step's own spread under a one-rounding
    perturbation (:func:`one_device_spread`), which phase 31d's two
    ranks are read against."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    bundle = mesh_bundle("qwen2.5-3b", MESH_TRAIN_LAYERS, "float32")
    rec = mesh_train_pair(bundle, mesh, fa)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["spread"] = one_device_spread(bundle, mesh.device)
    print(f"  qwen2.5-3b at {MESH_TRAIN_LAYERS} layers, train step "
          f"{TRAIN_B} x {TRAIN_S}, float32 parameters and AdamW state "
          f"({card_line}): mesh {rec['mesh_ms']:.1f} ms, one device "
          f"{rec['one_device_ms']:.1f} ms; (mesh, one device) "
          f"{rec['metrics']}; bit-different elements "
          f"{rec['bit_different']}; largest difference (params in lr, "
          f"moments in their leaf's scale) {rec['worst']}; attention "
          f"launches {rec['launches']}; peak {rec['peak_gib']:.2f} GiB")
    sp = rec["spread"]
    print(f"  the one-device step against itself with its first layer's "
          f"input perturbed by one float32 rounding: (perturbed, as it is) "
          f"{sp['metrics']}; largest difference {sp['worst']}; beyond "
          f"tests/test_torch_train_step.py's tolerances: {sp['broken']}")
    if rec["broken"]:
        fail(f"phase 31b: the mesh step is off the one-device step: "
             f"{rec['broken']}")
    want = train_launches(bundle.cfg, MESH_TRAIN_LAYERS)
    if rec["launches"] != want:
        fail(f"phase 31b: {rec['launches']} attention launches, not "
             f"{want}")
    return rec


def mesh_moe_case(mesh, fa, ms):
    """Phase 31c: kimi-k2 at 1 of 61 layers, as phase 29a builds it,
    through the mesh steps under ``moe_buffer_mode="shard_map"`` and
    ``"ep"``: every decode step's logits and the greedy tokens against the
    off-mesh MoE's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel import ParallelConfig
    arch, n_layers = MESH_MOE
    cfg = get_config(arch).replace(n_layers=n_layers)
    bundle = build_model(cfg)
    model = bundle.init(SEED)
    params = {k: p.detach() for k, p in model.state_dict().items()}
    prompts = prompts_for(cfg)
    counts = (fa.LAUNCHES, ms.LAUNCHES)
    one = generate_steps(bundle, model, prompts, fa, ms)
    out = {}
    for mode in MESH_MOE_MODES:
        fa.LAUNCHES = ms.LAUNCHES = 0
        run = generate_on_mesh(bundle, mesh, params, prompts, fa, ms,
                               pcfg=ParallelConfig(moe_buffer_mode=mode),
                               keep=True)
        errs = [close_err(a, b, MESH_BF16_TOL)
                for a, b in zip([run["logits"]] + run["steps"],
                                [one["logits"]] + one["steps"])]
        bits = sum(tensor_bits_apart(a, b) for a, b in zip(
            [run["logits"]] + run["steps"], [one["logits"]] + one["steps"]))
        same = bool(torch.equal(run["ids"], one["ids"]))
        worst = max(e for e, _ in errs)
        out[mode] = {"same_ids": same, "max_abs_err": worst,
                     "bit_different": bits,
                     "launches": list(run["after_decode"]),
                     "prefill_ms": run["prefill_s"] * 1e3,
                     "decode_ms_per_step": run["decode_s"]
                     / (GEN_TOKENS - 1) * 1e3}
        print(f"  {arch} at {n_layers} layer, {mode}: the prefill and "
              f"{GEN_TOKENS - 1} decode steps' logits max abs err "
              f"{worst:.3e} ({bits} bit-different elements), tokens equal "
              f"{same}; prefill {out[mode]['prefill_ms']:.3f} ms, decode "
              f"{out[mode]['decode_ms_per_step']:.3f} ms a step; launches "
              f"{run['after_decode']}")
        if not (same and all(w for _, w in errs)):
            fail(f"phase 31c: {mode} is off the one-device MoE")
        if run["after_decode"] != (GEN_TOKENS, 0):
            fail(f"phase 31c: {mode} launches {run['after_decode']}")
    fa.LAUNCHES, ms.LAUNCHES = counts
    del model, params
    release()
    return out, {"ids": one["ids"], "logits": one["logits"].cpu()}


#: phase 31d's serving runs on two ranks: (arch, depth, MoE mode, dtype).
#: The float32 one at MESH_TRAIN_LAYERS layers is held to a one-device
#: float32 run; the full-depth float32 one is held layer by layer
#: (MESH_AB_RUN) and its free-running tokens printed beside a one-device
#: run perturbed by the size of its first layer's difference; the bf16
#: ones are printed against 31a / 31c.  At random weights attention is
#: nearly one-hot, and a summation order's rounding that moves a score
#: flips heads wholesale, growing with depth
MESH_RANK_RUNS = (("qwen2.5-3b", None, None, "bfloat16"),
                  ("qwen2.5-3b", MESH_TRAIN_LAYERS, None, "float32"),
                  ("qwen2.5-3b", None, None, "float32"),
                  MESH_MOE + ("shard_map", "bfloat16"))
MESH_AB_RUN = ("qwen2.5-3b", None, None, "float32")
#: phase 31d's float32 rule (close_err), the A/B's 1e-3 of phase 9
MESH_F32_TOL = 1e-3


def mesh_bundle(arch, n_layers, dtype, device=None):
    """The bundle of ``arch`` cut to ``n_layers``, in ``dtype``, on
    ``device`` (None: the card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    return build_model(cfg, device=device, dtype=getattr(torch, dtype))


def smoke_bundle(arch, dtype):
    """The bundle of ``arch``'s smoke config in ``dtype`` on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(get_config(arch, smoke=True),
                       dtype=getattr(torch, dtype))


def run_key(arch, n_layers, dtype) -> str:
    return f"{arch} {dtype}" + ("" if n_layers is None
                                else f", {n_layers} layer(s)")


def mesh_layerwise_ab(bundle, mesh, model, prompts):
    """Phase 31d's layer-by-layer A/B: each layer of ``model`` through the
    mesh steps against the same layer on one device, both fed the same
    input -- the one-device run's hidden state -- for the prefill and one
    decode step, as phase 9 feeds the kernels and the plain versions
    (its rule: ab_stats).  The mesh's layers are fed by hooks on the
    modules the steps run; under sequence parallelism a mesh layer takes
    and gives this rank's positions, and is held to the one-device
    layer's there.  Returns each step's per-layer largest relative
    difference, the worst share of elements within AB_ELEM_TOL and the
    RMS of the first layer's prefill difference."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.model_zoo import _skeleton
    from repro_torch.parallel import build_step, context, sharding
    B, S = prompts.shape
    params = {k: p.detach() for k, p in model.state_dict().items()}
    pre = build_step(bundle, mesh, ShapeSpec("prefill", S, B, "prefill"))
    dec = build_step(bundle, mesh, ShapeSpec("decode", S + 1, B, "decode"))
    p_l, b_l, cache_l = pre.place(params, {"tokens": prompts},
                                  bundle.make_cache(B, S + 1))
    cache = bundle.make_cache(B, S + 1)
    one_layers = list(model.stack)
    mesh_layers = list(_skeleton(bundle.cfg).stack)
    rels, worst_share, first_rms = [], 1.0, None
    tok = None
    with torch.no_grad():
        for step in range(2):
            ins, outs, got, tp = [], [], [], []

            def keep(mod, args, out):
                ins.append(args[0])
                outs.append(out)

            def own(x, n):
                """``x``'s positions that this rank's layer of ``n``
                positions holds."""
                if x.shape[1] == n:
                    return x
                if not tp:
                    tp.append(context.current().tp)
                return x.chunk(tp[0].size, 1)[tp[0].rank]
            hooks = [m.register_forward_hook(keep) for m in one_layers]
            try:
                if step == 0:
                    logits, _ = bundle.prefill(model, {"tokens": prompts},
                                               cache)
                else:
                    logits, _ = bundle.decode(model, tok, cache, S)
            finally:
                for h in hooks:
                    h.remove()
            hooks = [m.register_forward_pre_hook(
                lambda mod, a, i=i: (own(ins[i], a[0].shape[1]),)
                + tuple(a[1:])) for i, m in enumerate(mesh_layers)]
            hooks += [m.register_forward_hook(lambda mod, a, o: got.append(o))
                      for m in mesh_layers]
            try:
                if step == 0:
                    pre.fn(p_l, b_l, cache_l)
                else:
                    dec.fn(p_l, sharding.place(tok, dec.in_shardings[1],
                                               mesh), cache_l, S)
            finally:
                for h in hooks:
                    h.remove()
            if len(got) != len(outs):
                fail(f"phase 31d: the A/B saw {len(got)} mesh layers, "
                     f"{len(outs)} one-device layers")
            row = []
            for i, (a, b) in enumerate(zip(got, outs)):
                b = own(b, a.shape[1])
                if a.shape != b.shape:
                    fail(f"phase 31d: layer {i}'s mesh output {a.shape} is "
                         f"not the one-device {b.shape}")
                share, rel, _ = ab_stats({"cuda": a, "ref": b})
                worst_share = min(worst_share, share)
                row.append(rel)
                if step == 0 and i == 0:
                    first_rms = float((a - b).float().square().mean().sqrt())
            rels.append(row)
            tok = logits[:, -1].argmax(-1, keepdim=True)
    return {"rel_per_layer": rels, "worst_share": worst_share,
            "worst_rel": max(max(r) for r in rels),
            "first_layer_rms": first_rms}


#: phase 31d's sequence-parallel A/B: MESH_RANK_RUNS's run whose prefill
#: (under SP, the default) is also run under no_sp, and whose train step
#: is taken under both
MESH_SP_RUN = ("qwen2.5-3b", MESH_TRAIN_LAYERS, None, "float32")


def mesh_sp_ab(bundle, mesh, params, prompts, fa, ms):
    """Phase 31d's sequence-parallel A/B on this rank of ``mesh``,
    MESH_SP_RUN's part beside its SP prefill: the prefill under ``no_sp``
    (``shard_sequence=False``; its first logits, time and attention /
    scan launches), the train step (:func:`mesh_train_pair`) under SP and
    under ``no_sp``, and the largest differences of the two steps'
    metrics and updated parameters."""
    from repro_torch.parallel import ParallelConfig
    no_sp = ParallelConfig(shard_sequence=False)
    before = (fa.LAUNCHES, ms.LAUNCHES)
    run = generate_on_mesh(bundle, mesh, params, prompts, fa, ms, n_new=1,
                           pcfg=no_sp)
    fa.LAUNCHES, ms.LAUNCHES = before
    out = {"no_sp": {"prefill_s": run["prefill_s"],
                     "logits": run["logits"].cpu(),
                     "launches": [run["after_prefill"][i] - before[i]
                                  for i in range(2)]}}
    del run
    kept = {}
    for name, pcfg in (("train", None), ("train no_sp", no_sp)):
        tr = mesh_train_pair(bundle, mesh, fa, pcfg, keep=True)
        kept[name] = tr.pop("kept")
        out[name] = tr
    (a, ma), (b, mb) = kept["train"], kept["train no_sp"]
    out["train_sp_vs_no_sp"] = {
        "metrics": {k: abs(float(ma[k]) - float(mb[k]))
                    for k in ("loss", "grad_norm")},
        "params": max(float((a["params"][k].float() - b["params"][k]
                             .float()).abs().max()) for k in a["params"])}
    del a, b, kept
    release()
    return out


def report_sp_ab(rank, res, ref, card_line):
    """Phase 31d's SP A/B of one rank (:func:`mesh_sp_ab`), printed and
    held: the no_sp prefill's first logits within MESH_F32_TOL of the
    one-device run's (``ref``; the SP prefill is held in MESH_RANK_RUNS's
    loop), each train step's loss and grad_norm within MESH_F32_TOL
    (relative) of the one-device step's, the prefill's attention and scan
    launches the same under both.  Returns the printed numbers."""
    key = run_key(*MESH_SP_RUN[:2], MESH_SP_RUN[3])
    sp = res[key]
    no_sp = sp["sp_ab"]["no_sp"]
    err, within = close_err(no_sp["logits"], ref[key]["logits"],
                            MESH_F32_TOL)
    print(f"  rank {rank}, {key}, no_sp: prefill "
          f"{no_sp['prefill_s'] * 1e3:.3f} ms (SP "
          f"{sp['prefill_s'] * 1e3:.3f} ms), attention / scan launches "
          f"{no_sp['launches']} (SP {sp['prefill_launches']}), first logits "
          f"max abs err {err:.3e} against one device (within "
          f"{MESH_F32_TOL}: {within}) [{card_line}]")
    if not within:
        fail(f"phase 31d: rank {rank}'s no_sp prefill is off the one-device "
             "run")
    if no_sp["launches"] != sp["prefill_launches"]:
        fail(f"phase 31d: rank {rank}'s prefill launches "
             f"{sp['prefill_launches']} under SP, {no_sp['launches']} "
             "without")
    for tag in ("train", "train no_sp"):
        m = res[tag]["metrics"]
        rel = {k: abs(a - b) / max(abs(b), 1e-30)
               for k, (a, b) in m.items() if k in ("loss", "grad_norm")}
        if not all(v <= MESH_F32_TOL for v in rel.values()):
            fail(f"phase 31d: rank {rank}'s {tag} step is off the "
                 f"one-device step: {rel}")
    logits = float((sp["logits"] - no_sp["logits"]).abs().max())
    train = sp["sp_ab"]["train_sp_vs_no_sp"]
    print(f"  rank {rank}, {key}: largest difference SP - no_sp: first "
          f"logits {logits:.3e}; train step metrics {train['metrics']}, "
          f"parameters {train['params']:.3e} [{card_line}]")
    return {"logits_sp_vs_no_sp": logits, "train_sp_vs_no_sp": train,
            "no_sp_logits_max_abs_err": err,
            "no_sp_prefill_ms": no_sp["prefill_s"] * 1e3,
            "sp_prefill_ms": sp["prefill_s"] * 1e3,
            "launches": no_sp["launches"]}


def mesh_rank(rank, world, work):
    """Phase 31d, one rank of ``world`` (spawned by the phase), on a (1,
    world) NCCL mesh: each of MESH_RANK_RUNS from SEED, placed by the
    steps' specs and served as phase 8 serves, the MESH_AB_RUN also layer
    by layer (:func:`mesh_layerwise_ab`), the MESH_SP_RUN also under
    no_sp (:func:`mesh_sp_ab`: its prefill, and 31b's cut's float32 train
    step under SP and no_sp against the one-device step on this rank's
    card); a float32 train step of qwen2.5-3b's smoke config against
    the one-device step (:func:`mesh_train_pair`); then on a (world, 1)
    mesh a batch-1 decode whose caches' positions split over "data".
    Writes its tokens, logits, times, parameter bytes and checks'
    numbers."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import ParallelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), MESH_AXES)
        out = {}
        for arch, n_layers, mode, dtype in MESH_RANK_RUNS:
            bundle = mesh_bundle(arch, n_layers, dtype)
            model = bundle.init(SEED)
            params = {k: p.detach() for k, p in model.state_dict().items()}
            pcfg = None if mode is None else ParallelConfig(
                moe_buffer_mode=mode)
            prompts = prompts_for(bundle.cfg)
            generate_on_mesh(bundle, mesh, params, prompts[:, :16], fa, ms,
                             n_new=3, pcfg=pcfg)
            before = (fa.LAUNCHES, ms.LAUNCHES)
            run = generate_on_mesh(bundle, mesh, params, prompts, fa, ms,
                                   pcfg=pcfg)
            rec = {"ids": run["ids"], "logits": run["logits"].cpu(),
                   "prefill_s": run["prefill_s"],
                   "decode_s": run["decode_s"],
                   "param_bytes": run["param_bytes"],
                   "full_bytes": sum(p.numel() * p.element_size()
                                     for p in params.values()),
                   "coords": mesh.coords,
                   "prefill_launches": [run["after_prefill"][i] - before[i]
                                        for i in range(2)]}
            if (arch, n_layers, mode, dtype) == MESH_AB_RUN:
                rec["layerwise"] = mesh_layerwise_ab(bundle, mesh, model,
                                                     prompts)
            if (arch, n_layers, mode, dtype) == MESH_SP_RUN:
                ab = mesh_sp_ab(bundle, mesh, params, prompts, fa, ms)
                out["train"] = ab.pop("train")
                out["train no_sp"] = ab.pop("train no_sp")
                rec["sp_ab"] = ab
            out[run_key(arch, n_layers, dtype)] = rec
            del model, params
            release()
        out["train smoke"] = mesh_train_pair(
            smoke_bundle("qwen2.5-3b", "float32"), mesh, fa)
        seq_mesh = make_mesh((world, 1), MESH_AXES)
        bundle = mesh_bundle("qwen2.5-3b", MESH_TRAIN_LAYERS, "float32")
        params = {k: p.detach()
                  for k, p in bundle.init(SEED).state_dict().items()}
        launches = fa.LAUNCHES
        run = generate_on_mesh(
            bundle, seq_mesh, params, prompts_for(bundle.cfg)[:1], fa, ms,
            pcfg=ParallelConfig(cache_seq_axis=("data",)), keep=True)
        out["batch1"] = {"ids": run["ids"], "logits": run["logits"].cpu(),
                         "steps": [t.cpu() for t in run["steps"]],
                         "launches": fa.LAUNCHES - launches,
                         "decode_s": run["decode_s"]}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def first_difference(a, b) -> int:
    """The first token position at which two (B, T) id tensors differ in
    any row (T where none does)."""
    rows = (a != b).any(0).nonzero()
    return int(rows[0]) if len(rows) else a.shape[1]


def perturbed_run(bundle, model, prompts, rms):
    """``generate_steps`` of ``model`` with Gaussian noise of RMS ``rms``
    added to its first layer's prefill output (from SEED): one device's
    answer to a perturbation the size of the two ranks' first-layer
    difference."""
    import torch
    gen = torch.Generator(device=model.embed.device).manual_seed(SEED)

    def add_noise(mod, args, out):
        if out.shape[1] == 1:
            return out
        return out + rms * torch.randn(out.shape, generator=gen,
                                       device=out.device, dtype=out.dtype)
    hook = model.stack[0].register_forward_hook(add_noise)
    try:
        return generate_steps(bundle, model, prompts, None, None)
    finally:
        hook.remove()


def mesh_two_ranks(ref, spread, card_line):
    """Phase 31d: two NCCL ranks, one card each, spawned here (see
    :func:`mesh_rank`), against one-device runs on card 0.  Held: each
    rank's parameter bytes to its placements' share; qwen2.5-3b at
    MESH_TRAIN_LAYERS layers in float32 -- the greedy tokens equal and
    the first logits within MESH_F32_TOL of a one-device run, the train
    batch-1 decode over sequence-split caches (tokens equal, every step's
    logits within MESH_F32_TOL); the smoke config's float32 train step
    within tests/test_torch_train_step.py's tolerances; qwen2.5-3b at full
    depth in float32, layer by layer, within phase 9's rule.  Printed:
    the bf16 runs of 31a's qwen2.5-3b and 31c's kimi-k2 against the
    one-rank runs (``ref``), the full-depth float32 run's tokens and
    beside them a one-device run perturbed by the size of the first
    layer's difference, and the train step at 31b's cut beside the
    one-device step's own spread (``spread``, 31b's witness: at full
    width random-weight attention is nearly one-hot and the step moves
    beyond those tolerances under one rounding).  Prints each rank's
    prefill time and decode ms a step, and its SP A/B
    (:func:`report_sp_ab`)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel import params_shardings, sharding
    from repro_torch.parallel.steps import param_specs
    world = 2
    ref = dict(ref)
    for arch, n_layers, _, dtype in MESH_RANK_RUNS:
        if dtype != "float32":
            continue
        bundle = mesh_bundle(arch, n_layers, dtype)
        model = bundle.init(SEED)
        run = generate_steps(bundle, model, prompts_for(bundle.cfg), None,
                             None)
        ref[run_key(arch, n_layers, dtype)] = {
            "ids": run["ids"], "logits": run["logits"].cpu()}
        if n_layers == MESH_TRAIN_LAYERS:
            run = generate_steps(bundle, model, prompts_for(bundle.cfg)[:1],
                                 None, None)
            ref["batch1"] = {"ids": run["ids"], "logits": run["logits"].cpu(),
                             "steps": [t.cpu() for t in run["steps"]]}
        del bundle, model, run
        release()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ctx = mp.start_processes(mesh_rank, args=(world, work), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                fail(f"phase 31d: the ranks did not finish in "
                     f"{MESH_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    mesh = AbstractMesh((1, world), MESH_AXES)
    got = [torch.load(os.path.join(work, f"rank{rank}.pt"),
                      weights_only=True) for rank in range(world)]
    out = {}
    for rank, res in enumerate(got):
        for arch, n_layers, _, dtype in MESH_RANK_RUNS:
            key = run_key(arch, n_layers, dtype)
            rec = res[key]
            specs = param_specs(mesh_bundle(arch, n_layers, dtype,
                                            device="cpu"))
            p_sh = params_shardings(specs, mesh)
            want = sum(int(np.prod([i.stop - i.start for i in sharding.
                                    local_slice(p_sh[k], s.shape, mesh,
                                                rec["coords"])]))
                       * s.dtype.itemsize for k, s in specs.items())
            f32 = dtype == "float32"
            held = f32 and n_layers == MESH_TRAIN_LAYERS
            w = ref[key if f32 else arch]
            tol = MESH_F32_TOL if f32 else MESH_BF16_TOL
            err, within = close_err(rec["logits"], w["logits"], tol)
            first = first_difference(rec["ids"], w["ids"])
            steps = GEN_TOKENS - 1
            row = {"same_ids": first == GEN_TOKENS,
                   "first_different_token": first,
                   "logits_max_abs_err": err, "logits_within": within,
                   "param_bytes": rec["param_bytes"],
                   "placement_bytes": want, "full_bytes": rec["full_bytes"],
                   "prefill_ms": rec["prefill_s"] * 1e3,
                   "decode_ms_per_step": rec["decode_s"] / steps * 1e3}
            print(f"  rank {rank}, {key}: prefill {row['prefill_ms']:.3f} ms,"
                  f" decode {row['decode_ms_per_step']:.3f} ms a step; "
                  f"parameter bytes {rec['param_bytes']:,} of "
                  f"{rec['full_bytes']:,} (placements: {want:,}); first "
                  f"logits max abs err {err:.3e} (within {tol}: {within}); "
                  f"greedy tokens equal to the one-device run's up to token "
                  f"{first} of {GEN_TOKENS}")
            if rec["param_bytes"] != want:
                fail(f"phase 31d: rank {rank} holds {rec['param_bytes']} "
                     f"bytes of {key}, its placements {want}")
            if held and not (within and first == GEN_TOKENS):
                fail(f"phase 31d: rank {rank}'s {key} is off the one-device "
                     "float32 run")
            if "layerwise" in rec:
                ab = rec["layerwise"]
                row["layerwise"] = ab
                by_layer = ", ".join(f"{r:.1e}"
                                     for r in ab["rel_per_layer"][0])
                print(f"  rank {rank}, {key}, layer by layer on the same "
                      f"input (prefill + 1 decode step): worst share of "
                      f"elements within {AB_ELEM_TOL} of the scale "
                      f"{ab['worst_share'] * 100:.4f}%, largest relative "
                      f"difference {ab['worst_rel']:.3e} (prefill, by layer:"
                      f" {by_layer}); first layer's prefill difference RMS "
                      f"{ab['first_layer_rms']:.3e}")
                if ab["worst_share"] < AB_ELEM_SHARE:
                    fail(f"phase 31d: rank {rank}'s layers of {key} are off "
                         f"the one-device layers (share "
                         f"{ab['worst_share']} < {AB_ELEM_SHARE})")
            out[f"{key} rank {rank}"] = row
        for tag, what in (("train smoke", "qwen2.5-3b's smoke config"),
                          ("train", f"qwen2.5-3b at {MESH_TRAIN_LAYERS} "
                                    "layers (SP)"),
                          ("train no_sp", f"qwen2.5-3b at {MESH_TRAIN_LAYERS}"
                                          " layers (no_sp)")):
            tr = res[tag]
            print(f"  rank {rank}, {what}, float32 train step: mesh "
                  f"{tr['mesh_ms']:.1f} ms, one device "
                  f"{tr['one_device_ms']:.1f} ms; (mesh, one device) "
                  f"{tr['metrics']}; bit-different elements "
                  f"{tr['bit_different']}; largest difference {tr['worst']};"
                  f" beyond tests/test_torch_train_step.py's tolerances: "
                  f"{tr['broken']}; attention launches {tr['launches']}")
            out[f"{tag} rank {rank}"] = tr
        if res["train smoke"]["broken"]:
            fail(f"phase 31d: rank {rank}'s train step is off the one-device"
                 f" step: {res['train smoke']['broken']}")
        print(f"  (31b: the one-device step at {MESH_TRAIN_LAYERS} layers "
              f"against itself under one rounding: largest difference "
              f"{spread['worst']}, grad_norm {spread['metrics']['grad_norm']}"
              f")")
        b1, w = res["batch1"], ref["batch1"]
        errs = [close_err(a, b, MESH_F32_TOL) for a, b in zip(
            [b1["logits"]] + b1["steps"], [w["logits"]] + w["steps"])]
        first = first_difference(b1["ids"], w["ids"])
        worst = max(e for e, _ in errs)
        print(f"  rank {rank}, batch-1 decode on a ({world}, 1) mesh, the "
              f"caches' positions split over \"data\" (qwen2.5-3b at "
              f"{MESH_TRAIN_LAYERS} layers, float32): every step's logits "
              f"max abs err {worst:.3e}, tokens equal up to token {first} "
              f"of {GEN_TOKENS}; {b1['launches']} attention launches; decode "
              f"{b1['decode_s'] / (GEN_TOKENS - 1) * 1e3:.3f} ms a step")
        if first != GEN_TOKENS or not all(ok for _, ok in errs):
            fail(f"phase 31d: rank {rank}'s batch-1 sequence-split decode is "
                 "off the one-device run")
        out[f"batch1 rank {rank}"] = {
            "max_abs_err": worst, "first_different_token": first,
            "launches": b1["launches"]}
        out[f"sp rank {rank}"] = report_sp_ab(rank, res, ref, card_line)
    # one device under a perturbation the size of the first layer's
    # difference, beside the two ranks' full-depth float32 run
    key = run_key(*MESH_AB_RUN[:2], MESH_AB_RUN[3])
    rms = got[0][key]["layerwise"]["first_layer_rms"]
    bundle = mesh_bundle(*MESH_AB_RUN[:2], MESH_AB_RUN[3])
    model = bundle.init(SEED)
    pert = perturbed_run(bundle, model, prompts_for(bundle.cfg), rms)
    err, _ = close_err(pert["logits"].cpu(), ref[key]["logits"],
                       MESH_F32_TOL)
    first = first_difference(pert["ids"], ref[key]["ids"])
    two = out[f"{key} rank 0"]
    out["perturbed_one_device"] = {
        "noise_rms": rms, "logits_max_abs_err": err,
        "first_different_token": first}
    print(f"  {key} on one device, its first layer's prefill output "
          f"perturbed by noise of RMS {rms:.3e} (the two ranks' first-layer "
          f"difference): first logits max abs err {err:.3e}, tokens equal up "
          f"to token {first} of {GEN_TOKENS}; the two ranks: "
          f"{two['logits_max_abs_err']:.3e}, up to token "
          f"{two['first_different_token']}")
    del bundle, model
    release()
    return out


def mesh_phase(fa, ms, card_line):
    """Phase 31: the mesh steps (``parallel.build_step`` on a one-rank
    NCCL mesh) against the one-device paths: (a) serving, (b) a train
    step, (c) the MoE modes; (d) two ranks on two cards."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    out, ids = {}, {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), MESH_AXES)
        phase("phase 31a: serving through build_step on a (1, 1) NCCL mesh "
              f"against phase 8's path: {', '.join(a if n is None else f'{a} at {n} layers' for a, n in MESH_SERVE)}, "
              f"{SERVE_BATCH} x {PROMPT_LEN} + {GEN_TOKENS} greedy tokens")
        for arch, n_layers in MESH_SERVE:
            out[arch], ids[arch] = mesh_serving_case(arch, n_layers, mesh,
                                                     fa, ms)
        phase(f"phase 31b: one train step of qwen2.5-3b at "
              f"{MESH_TRAIN_LAYERS} layers in float32 through build_step on "
              "the mesh against make_train_step on one device")
        out["train"] = mesh_train_case(mesh, fa, card_line)
        phase(f"phase 31c: {MESH_MOE[0]} at {MESH_MOE[1]} layer on the mesh "
              f"under moe_buffer_mode {MESH_MOE_MODES} against the one-device"
              " MoE")
        out["moe"], ids[MESH_MOE[0]] = mesh_moe_case(mesh, fa, ms)
    finally:
        dist.destroy_process_group()
    n_cards = torch.cuda.device_count()
    phase("phase 31d: two NCCL ranks on a (1, 2) mesh and a (2, 1) mesh, "
          "one card each, with the SP A/B (sequence parallelism against "
          "no_sp)")
    if n_cards < 2:
        print(f"  the two-rank run needs two cards ({n_cards} visible): "
              "not run on this machine")
        out["two_ranks"] = f"needs two cards ({n_cards} visible)"
    else:
        out["two_ranks"] = mesh_two_ranks(ids, out["train"]["spread"],
                                          card_line)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 31: {out['seconds']:.3f} s")
    return out


#: phase 32: the dry run's cells, run on the card machine's host in a
#: subprocess (a fake world of 512 / 256 ranks, fake tensors, no card),
#: started after the builds and read here: (arch, shape, multi_pod); and
#: perf.py's variants: the baseline on the second, and qwen2.5-3b
#: train_4k on 16x16 with and without sequence parallelism
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", True),
                ("falcon-mamba-7b", "long_500k", False))
DRYRUN_PERF = (("falcon-mamba-7b", "long_500k", "baseline"),
               ("qwen2.5-3b", "train_4k", "baseline"),
               ("qwen2.5-3b", "train_4k", "no_sp"))
#: phase 32b: the card's peak above the phase's baseline against the
#: trace's arguments + temporaries, within this share
DRYRUN_MEM_TOL = 0.10
#: phase 32c: calls a wall is the least of
DRYRUN_REPS = 3
#: phase 32d: the remat policies held bit for bit against each other
REMAT_CHECKED = ("nothing", "dots", "full")
_DRYRUN_CHILD = """
import json, sys
from repro_torch.launch import dryrun, perf
cells, variants = json.loads(sys.argv[1])
recs = [dryrun.run_cell(a, s, m, verbose=False) for a, s, m in cells]
print(json.dumps({"cells": recs,
                  "perf": [perf.run_variant(*v) for v in variants]}))
"""


def start_dryrun_cells():
    """Phase 32a's subprocess, started early: the dry run needs no card
    (it sees none) and runs on the host beside the card phases."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD,
         json.dumps([DRYRUN_CELLS, DRYRUN_PERF])], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def roofline_terms(r):
    return (f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms; bottleneck "
            f"{r['bottleneck']}, bound {r['step_time_bound_s'] * 1e3:.3f} "
            f"ms, roofline fraction {r['roofline_fraction']:.4f}")


def dryrun_cells_phase(proc, card_line):
    """Phase 32a: the subprocess's records, their terms printed; fails
    unless qwen2.5-3b train_4k's ``baseline`` (sequence parallelism) and
    ``no_sp`` records are both there and differ."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        fail(f"phase 32a: the dry run's process exited {proc.returncode}: "
             f"{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    for rec in res["cells"]:
        label = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
        if rec["status"] != "OK":
            fail(f"phase 32a: {label} is {rec['status']}: "
                 f"{rec.get('traceback', rec.get('reason'))}")
        r = rec["roofline"]
        print(f"  {label} (computed, {rec['n_chips']} ranks, traced in "
              f"{rec['trace_s']} s): {rec['counted_flops']:.4e} FLOP and "
              f"{rec['counted_bytes']:.4e} B a rank; args "
              f"{rec['arg_bytes'] / 1e9:.3f} GB + temporaries "
              f"{rec['temp_bytes'] / 1e9:.3f} GB, fits 80 GB "
              f"{r['fits_hbm']}; collectives {rec['collectives']}; "
              f"useful ratio {r['useful_ratio']:.4f}; {roofline_terms(r)}")
    by = {}
    for p in res["perf"]:
        by[(p["arch"], p["shape"], p["variant"])] = p
        print(f"  perf.py {p['arch']} x {p['shape']} x {p['mesh']} "
              f"[{p['variant']}] (computed, traced in {p['trace_s']} s): "
              f"resident {p['per_device_resident_gb']} GB a rank; "
              f"collective link bytes {p['roofline']['collectives']}; traced "
              f"{roofline_terms(p['roofline'])}; kernelized "
              f"{roofline_terms(p['kernelized'])} [{card_line}]")
    sp, no_sp = (by.get(("qwen2.5-3b", "train_4k", v))
                 for v in ("baseline", "no_sp"))
    if sp is None or no_sp is None:
        fail("phase 32a: qwen2.5-3b train_4k's baseline or no_sp record is "
             "missing")
    if ({k: v for k, v in sp.items() if k not in ("variant", "trace_s")}
            == {k: v for k, v in no_sp.items()
                if k not in ("variant", "trace_s")}):
        fail("phase 32a: qwen2.5-3b train_4k's baseline and no_sp records "
             "are equal")
    return res


def fake_like(args):
    """Fake tensors of ``args``' shapes and dtypes on the CPU, as the dry
    run makes them, under a new FakeTensorMode."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        with mode:
            return torch.empty(t.shape, dtype=t.dtype, device="cpu")
    return mode, tree_map(one, args)


def step_counts(dryrun, step, args, label, base0):
    """Phase 32b for one step: its fake trace as the dry run takes it (CPU
    fakes) and the real step's on the card, held exactly (FLOPs, bytes,
    collectives, and on a difference the ops that differ); the card's
    memory after a warm call (cuBLAS allocates its 32 MiB workspace
    through the caching allocator at its first product): the peak above
    ``base0`` (the memory before the weights and the cache were made)
    within DRYRUN_MEM_TOL of the trace's arguments + temporaries, and the
    peak above the step's own baseline printed beside the temporaries
    (kernels' internal scratch, which no op returns, is not in the
    trace).  Returns (real trace, fake trace, step peak, resident)."""
    import torch
    mode, fargs = fake_like(args)
    with mode:
        fk = dryrun.trace_step(step.fn, fargs)
    step.fn(*args)            # warm: the library's workspaces allocated
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    real = dryrun.trace_step(step.fn, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    same = (real.flops, real.nbytes, real.collectives) == \
        (fk.flops, fk.nbytes, fk.collectives)
    print(f"  {label}: real {real.flops:,} FLOP, {real.nbytes:,} B; fake "
          f"(cpu) {fk.flops:,} FLOP, {fk.nbytes:,} B: "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        ops = sorted(k for k in set(real.by_op) | set(fk.by_op)
                     if real.by_op.get(k) != fk.by_op.get(k))
        fail(f"phase 32b: {label}'s real counts differ from its fake trace "
             f"in {ops}")
    resident = torch.cuda.max_memory_allocated() - base0
    predicted = fk.arg_bytes + fk.temp_bytes
    print(f"    resident: peak above the phase's baseline "
          f"{resident / 1e9:.4f} GB against the trace's args + temporaries "
          f"{predicted / 1e9:.4f} GB ({(resident - predicted) / predicted:+.3%}"
          f"); peak above the step's baseline {peak / 1e9:.4f} GB against "
          f"the temporaries {fk.temp_bytes / 1e9:.4f} GB "
          f"({(peak - fk.temp_bytes) / max(fk.temp_bytes, 1):+.2%})")
    if abs(resident - predicted) > DRYRUN_MEM_TOL * predicted:
        fail(f"phase 32b: {label}'s resident {resident} is beyond "
             f"{DRYRUN_MEM_TOL:.0%} of the trace's {predicted}")
    return real, fk, peak, resident


def best_wall(fn, reps=DRYRUN_REPS):
    import torch
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def dryrun_card_phase(fa, card_line):
    """Phase 32b-c: qwen2.5-3b at full width on one card (bf16, random
    weights from SEED), a prefill of SERVE_BATCH x PROMPT_LEN into a
    cache of S_MAX slots and one decode step at PROMPT_LEN: the dry run's
    counts of each step held to the real step's; the walls of the plain
    and the kernel paths above their bounds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import build_model
    from repro_torch.parallel import build_step
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.kernel_adjust import kernelized_roofline
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda")
    mesh = HostMesh(dev)
    torch.cuda.synchronize()
    base0 = torch.cuda.memory_allocated()
    bundle = build_model(cfg, device=dev)
    params = dict(bundle.init(SEED).state_dict())
    cache = bundle.make_cache(SERVE_BATCH, S_MAX)
    prompts = prompts_for(cfg)
    # the bounds' shapes: the prompt, then one query over PROMPT_LEN + 1
    # keys (the cache's first slots)
    shapes = {"prefill": ShapeSpec("prefill", PROMPT_LEN, SERVE_BATCH,
                                   "prefill"),
              "decode": ShapeSpec("decode", PROMPT_LEN + 1, SERVE_BATCH,
                                  "decode")}
    builds = {kind: {impl: build_step(bundle, mesh, ShapeSpec(
        kind, PROMPT_LEN if kind == "prefill" else S_MAX, SERVE_BATCH, kind),
        impl=impl) for impl in ("ref", None)} for kind in shapes}
    out = {"card": card_line}
    logits = None
    for kind in ("prefill", "decode"):
        if kind == "prefill":
            args = (params, {"tokens": prompts}, cache)
        else:
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            args = (params, tok, cache, PROMPT_LEN)
        real, fake, peak, resident = step_counts(
            dryrun, builds[kind]["ref"], args, f"{kind} (impl='ref')", base0)
        logits = real.outputs[0]
        roof = analyze(cfg.name, kind, "1", 1, cfg, shapes[kind], [],
                       fake.flops, fake.nbytes,
                       fake.arg_bytes + fake.temp_bytes)
        kern = kernelized_roofline(roof, cfg, shapes[kind])
        plain_s = best_wall(lambda: builds[kind]["ref"].fn(*args))
        fa.LAUNCHES = 0
        kernel_s = best_wall(lambda: builds[kind][None].fn(*args))
        launches = fa.LAUNCHES
        print(f"    wall: plain {plain_s * 1e3:.3f} ms against its bound "
              f"{roof.step_time_bound_s * 1e3:.3f} ms ({roof.bottleneck}); "
              f"kernels {kernel_s * 1e3:.3f} ms against the kernelized "
              f"bound {kern['step_time_bound_s'] * 1e3:.3f} ms "
              f"({kern['bottleneck']}); {launches} attention launches in "
              f"{DRYRUN_REPS} calls")
        if roof.step_time_bound_s > plain_s:
            fail(f"phase 32c: the plain bound of {kind} is above its wall")
        if kern["step_time_bound_s"] > kernel_s:
            fail(f"phase 32c: the kernelized bound of {kind} is above its "
                 "wall")
        if launches != DRYRUN_REPS * cfg.n_layers:
            fail(f"phase 32c: {launches} attention launches in the kernel "
                 f"path's {kind}, not {DRYRUN_REPS * cfg.n_layers}")
        out[kind] = {
            "flops": real.flops, "bytes": real.nbytes,
            "fake_equal": True, "arg_bytes": real.arg_bytes,
            "temp_bytes": fake.temp_bytes, "peak_bytes": peak,
            "resident_bytes": resident,
            "plain_ms": plain_s * 1e3,
            "plain_bound_ms": roof.step_time_bound_s * 1e3,
            "plain_bound_by": roof.bottleneck, "kernel_ms": kernel_s * 1e3,
            "kernelized_bound_ms": kern["step_time_bound_s"] * 1e3,
            "kernelized_bound_by": kern["bottleneck"],
            "launches": launches}
    del params, cache, builds, logits, args
    release()
    return out


def remat_phase(card_line):
    """Phase 32d: qwen2.5-3b at MESH_TRAIN_LAYERS layers in float32, one
    train step of TRAIN_B x TRAIN_S under each remat policy from the same
    state: loss, grad_norm and every leaf bit for bit; the peak of each."""
    import torch
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.parallel import make_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    res = {}
    for policy in REMAT_CHECKED:
        bundle = build_model(get_config("qwen2.5-3b").replace(
            n_layers=MESH_TRAIN_LAYERS, remat_policy=policy),
            dtype=torch.float32)
        shape, opt_cfg, batch = train_step_inputs(bundle, "cuda")
        step = make_train_step(bundle, HostMesh(torch.device("cuda")),
                               shape, opt_cfg)
        params = dict(bundle.init(SEED).state_dict())
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state, metrics = step.fn(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        res[policy] = (state, metrics, peak)
        print(f"  {policy}: loss {float(metrics['loss']):.6f}, grad_norm "
              f"{float(metrics['grad_norm']):.4f}, peak above the state "
              f"{peak / 1e9:.4f} GB")
    ref_state, ref_m, _ = res["full"]
    out = {"peak_bytes": {p: r[2] for p, r in res.items()}}
    for policy, (state, metrics, _) in res.items():
        bits = sum(tensor_bits_apart(state[part][k], ref_state[part][k])
                   for part in ("params",) for k in ref_state[part])
        bits += sum(tensor_bits_apart(state["opt"][m][k],
                                      ref_state["opt"][m][k])
                    for m in ("m", "v") for k in ref_state["opt"][m])
        bits += sum(tensor_bits_apart(metrics[k], ref_m[k])
                    for k in ("loss", "grad_norm"))
        out[policy] = bits
        if bits or not math.isfinite(float(metrics["grad_norm"])):
            fail(f"phase 32d: remat policy {policy!r} is {bits} elements "
                 "off the no-remat step (or its grad_norm is not finite)")
    print(f"  every policy bit for bit the no-remat step; card {card_line}")
    del res
    release()
    return out


def dryrun_phases(proc, fa, card_line):
    """Phase 32 (a)-(d)."""
    t0 = time.perf_counter()
    phase(f"phase 32b-c: qwen2.5-3b at full width on one card, impl='ref': "
          f"prefill {SERVE_BATCH} x {PROMPT_LEN} into {S_MAX} slots and one "
          "decode step, the dry run's counts against the real step's; the "
          "plain and kernel paths' walls against their bounds")
    out = {"card": dryrun_card_phase(fa, card_line)}
    phase(f"phase 32d: qwen2.5-3b at {MESH_TRAIN_LAYERS} layers in float32, "
          f"a train step of {TRAIN_B} x {TRAIN_S} under remat "
          f"{', '.join(REMAT_CHECKED)}")
    out["remat"] = remat_phase(card_line)
    phase("phase 32a: the dry run's cells (computed on the host, no card): "
          + "; ".join(f"{a} x {s} x {'2x16x16' if m else '16x16'}"
                      for a, s, m in DRYRUN_CELLS)
          + "; perf.py " + "; ".join(f"{v} on {a} x {s}"
                                     for a, s, v in DRYRUN_PERF))
    out["cells"] = dryrun_cells_phase(proc, card_line)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 32: {out['seconds']:.3f} s (32a's subprocess ran from "
          "phase 1 on)")
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import (MINUTES_PER_DAY, OneWaySweep, Params,
                                  analytical, run_replications, vectorized)
    from repro_torch.kernels import ctmc_chunk as cc
    from repro_torch.kernels import des_step, ref
    from repro_torch.kernels import mj_chunk as mjc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    # float32 products in full float32 on the card, for the A/B of phase 9
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build ------------------------------------------
    phase("phase 1: card and kernel builds")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    build_kernels([des_step.LIBRARY, cc.LIBRARY, cc.LIBRARY64, mjc.LIBRARY,
                   fa.LIBRARY, ms.LIBRARY, cc.LIBRARY_WIDE,
                   cc.LIBRARY_WIDE64, mjc.LIBRARY_RT])
    # phase 32a's dry run runs on the host meanwhile; stopped on any exit
    dry_proc = start_dryrun_cells()
    atexit.register(lambda: dry_proc.poll() is None and dry_proc.kill())
    if "--dryrun-only" in sys.argv[1:]:
        dryrun_out = dryrun_phases(dry_proc, fa, card_line)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, builds "
              "included")
        print(json.dumps({"host_paths": {"dryrun": dryrun_out}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 2: kernel against plain version ----------------------------
    phase("phase 2: event_race kernel vs plain PyTorch version")
    B_main = len(SWEEP_VALUES) * N_REPLICAS
    shapes = [(B_main, 16, 3), (130, 9, 5), (96, 23, 7), (8, 1, 1)]
    main_err = None
    for R, ke, kd in shapes:
        mism, rel, abs_err = compare_race(R, ke, kd)
        print(f"  {R}x{ke}x{kd}: event mismatches {mism}, dt max rel err "
              f"{rel:.3e}, max abs err {abs_err:.3e}")
        if mism or rel > 1e-6:
            fail(f"kernel disagrees with event_race_ref at {R}x{ke}x{kd} "
                 f"(mismatches {mism}, dt rel err {rel:.3e} > 1e-6)")
        if main_err is None:
            main_err = (mism, rel, abs_err)
    args = race_inputs(B_main, 16, 3, seed=7)
    launches_before = des_step.LAUNCHES
    k_ms = event_ms(lambda: des_step.event_race_cuda(*args), 2000)
    r_ms = event_ms(lambda: ref.event_race_ref(*args), 500)
    k_dev = device_ms(lambda: des_step.event_race_cuda(*args), 200)
    r_dev = device_ms(lambda: ref.event_race_ref(*args), 100)
    des_step.LAUNCHES = launches_before
    row_bytes = (16 + 3 + 2) * 4 + 4 + 4      # inputs read once + outputs
    row_ops = 4 * 16 + 3 + 4                  # sum, cumsum, divide, compare
    bytes_ms = B_main * row_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = B_main * row_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  {B_main}x16x3 per call, CUDA events over back-to-back calls "
          f"(host dispatch included): kernel {k_ms:.6f} ms, plain "
          f"{r_ms:.6f} ms")
    print(f"  device time per call (torch.profiler): kernel {k_dev} ms, "
          f"plain {r_dev} ms; bound {bound_ms:.6f} ms ({bound_by})")

    # ---- phases 3-4: the serving kernels against their plain versions -----
    phase("phase 3: flash_attention kernel vs plain PyTorch version")
    attn = attention_phase(fa, ref)
    # phase 30's kernel-alone timings run here: short traces taken late
    # in the run have shown no kernel, or only some of a call's kernels
    phase("phase 30d: the attention kernel alone at phase 30's shapes "
          "(run beside phase 3)")
    t30d = time.perf_counter()
    cross_regimes = cross_regimes_phase(fa, ref)
    t30d = time.perf_counter() - t30d
    phase("phase 4: selective_scan kernel vs plain PyTorch version")
    scan = scan_phase(ms, ref)

    # ---- phase 5: the CTMC main path ---------------------------------------
    phase(f"phase 5: OneWaySweep warm_standbys={SWEEP_VALUES}, "
          f"{N_REPLICAS} replicas, Table-I width, job_length cut from 64 "
          f"to {JOB_DAYS} days")
    base = Params(job_length=JOB_DAYS * MINUTES_PER_DAY)
    sweep = OneWaySweep("warm standbys", "warm_standbys", SWEEP_VALUES,
                        n_replications=N_REPLICAS, base_params=base,
                        device="cuda")
    main_run, restore = capture_final_states(vectorized)
    try:
        cc.LAUNCHES = cc.STEPS = des_step.LAUNCHES = 0   # the main path's run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, chunk_steps, race_launches = (cc.LAUNCHES, cc.STEPS,
                                                des_step.LAUNCHES)
    finally:
        restore()
    states, steps = main_run["states"], main_run["steps"]
    print(f"  chunk kernel: {launches} launches, {chunk_steps} steps; chunks "
          f"run {main_run['chunks']}, steps run {steps}; standalone race "
          f"launches {race_launches}")
    if launches != main_run["chunks"] or chunk_steps != steps or steps <= 0:
        fail(f"the main path ran {main_run['chunks']} chunks of {steps} steps"
             f" but the chunk kernel counted {launches} launches of "
             f"{chunk_steps} steps")
    if race_launches:
        fail(f"the main path launched the standalone race {race_launches} "
             "times")
    if len(states) != 1:
        fail(f"expected one batch for the sweep, got {len(states)}")
    final = states[0]
    n_events = 0.0
    for j, (v, pt) in enumerate(zip(SWEEP_VALUES, res.points)):
        st = pt.stats
        if st["completed"].mean != 1.0:
            fail(f"warm_standbys={v}: only {st['completed'].mean:.4f} of "
                 "replicas completed")
        for name, stat in st.items():
            if not math.isfinite(stat.mean):
                fail(f"warm_standbys={v}: metric {name} is not finite")
        rows = slice(j * N_REPLICAS, (j + 1) * N_REPLICAS)
        total = sum(final[k][rows].sum(-1) for k in
                    ("run", "sb", "fw", "fs", "auto", "man"))
        want = base.working_pool_size + base.spare_pool_size
        if not bool((total == want).all()):
            fail(f"warm_standbys={v}: servers not conserved "
                 f"({float(total.min())}..{float(total.max())} != {want})")
        # per replica: a failure and its timer expiry, each repair
        # completion, and the job's completion
        n_events += float((2 * final["n_failures"][rows]
                           + final["n_auto_repairs"][rows]
                           + final["n_manual_repairs"][rows] + 1).sum())
        print(f"  warm_standbys={v}: total_time {st['total_time'].mean:.1f} "
              f"min, n_failures {st['n_failures'].mean:.2f}, stall_time "
              f"{st['stall_time'].mean:.2f}, goodput "
              f"{st['goodput'].mean:.5f}, recovery_p99 "
              f"{st['recovery_dist'].percentiles[99]:.2f}")
    print(f"  wall {wall:.6f} s, {steps} scan steps ({steps / wall:.1f} "
          f"steps/s), {n_events:.0f} replica-events "
          f"({n_events / wall:.1f} replica-events/s), chunk kernel launches "
          f"{launches}")

    # ---- phase 5b: closed-form points at the same width --------------------
    calm = base.replace(random_failure_rate=0.0, systematic_failure_rate=0.0)
    rep = run_replications(calm, N_REPLICAS, device="cuda")
    want = calm.host_selection_time + calm.job_length
    tt = rep.arrays["total_time"]
    if not (abs(tt - want) <= 1e-5 * want).all() \
            or rep.arrays["n_failures"].sum() != 0:
        fail(f"failure-free point: total_time {tt.min()}..{tt.max()} != "
             f"{want}")
    print(f"  failure-free: total_time == host_selection + job_length = "
          f"{want} for all {N_REPLICAS} replicas")
    no_heal = base.replace(auto_repair_failure_probability=1.0,
                           manual_repair_failure_probability=1.0)
    rep = run_replications(no_heal, N_REPLICAS, device="cuda")
    got = rep.stats["n_failures"].mean
    exp = analytical.expected_failures(no_heal)
    print(f"  repairs never heal: mean n_failures {got:.2f}, closed form "
          f"{exp:.2f} ({(got / exp - 1) * 100:+.2f}%)")
    if abs(got / exp - 1.0) > 0.15 or rep.stats["completed"].mean != 1.0:
        fail("never-healing point is outside 15% of the closed form")

    # the chunk kernel against the plain loop on the sweep's first chunk
    chunk = chunk_phase(cc, vectorized, main_run["calls"][0])
    if chunk["ms_per_step"] is not None and k_dev is not None:
        print(f"  chunk kernel {chunk['ms_per_step'] * 1e3:.4f} us a step "
              f"against the standalone race's {k_dev * 1e3:.4f} us a call")

    # ---- phase 6: A/B against the plain step loop ---------------------------
    phase("phase 6: the same sweep through the plain step loop "
          "(event_race_impl='ref')")
    sweep_ref = OneWaySweep("warm standbys", "warm_standbys", SWEEP_VALUES,
                            n_replications=N_REPLICAS,
                            base_params=base.replace(event_race_impl="ref"),
                            device="cuda")
    ref_run, restore = capture_final_states(vectorized)
    try:
        counts = (cc.LAUNCHES, des_step.LAUNCHES)
        t0 = time.perf_counter()
        res_ref = sweep_ref.run()
        torch.cuda.synchronize()
        wall_ref = time.perf_counter() - t0
    finally:
        restore()
    if (cc.LAUNCHES, des_step.LAUNCHES) != counts:
        fail("impl='ref' launched a CUDA kernel")
    final_ref = ref_run["states"][0]
    frac, hist_same, worst_rel, bits = sweep_identity(final, final_ref)
    print(f"  wall {wall_ref:.3f} s ({steps} steps, {ref_run['steps']} in "
          f"this run); replicas with identical integer metrics: "
          f"{frac * 100:.3f}%; histogram counts identical: {hist_same}; "
          f"float lanes: largest relative difference {worst_rel:.3e}, "
          f"bit-different elements {bits}")
    if frac < 1.0 or not hist_same or worst_rel > 1e-6:
        fail(f"the chunk kernel's sweep differs from the plain loop's "
             f"(identical replicas {frac:.6f}, histograms identical "
             f"{hist_same}, float rel diff {worst_rel:.3e} > 1e-6)")
    worst = 0.0
    for pt, pt_ref in zip(res.points, res_ref.points):
        for m in ("total_time", "n_failures", "stall_time", "goodput",
                  "n_preemptions", "recovery_overhead"):
            a, b = pt.stats[m], pt_ref.stats[m]
            se = math.sqrt((a.std ** 2 + b.std ** 2) / N_REPLICAS)
            z = abs(a.mean - b.mean) / max(se, 1e-12)
            worst = max(worst, z)
    print(f"  largest |z| of the means against the plain loop: {worst:.3f}")
    if worst >= 3.5:
        fail(f"means disagree with the plain loop (|z| = {worst:.3f})")

    # ---- phase 7: traced sweep -------------------------------------------
    phase("phase 7: the whole sweep again under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    counts = (cc.LAUNCHES, cc.STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep.run()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    traced_steps = cc.STEPS - counts[1]
    traced_launches = cc.LAUNCHES - counts[0]
    cc.LAUNCHES, cc.STEPS = counts
    events = prof.key_averages()
    dev_s = device_seconds(prof)
    dev_events = [e for e in events if str(e.device_type).endswith("CUDA")]
    n_kernels = sum(e.count for e in dev_events)
    chunk_evs = [e for e in dev_events if "ctmc_chunk_kernel" in e.key]
    chunk_total_ms = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in chunk_evs) / 1e3
    chunk["sweep_ms_per_launch"] = chunk_total_ms / max(traced_launches, 1)
    chunk["sweep_ms_per_step"] = chunk_total_ms / max(traced_steps, 1)
    print(f"  traced wall {traced_wall:.6f} s for {traced_steps} steps in "
          f"{traced_launches} launches (untraced in phase 5: {wall:.6f} s); "
          f"device busy {dev_s:.6f} s = {dev_s / traced_wall * 100:.2f}% of "
          f"the traced wall; {n_kernels} device kernels and copies = "
          f"{n_kernels / traced_steps:.4f} a step")
    print(f"  chunk kernel over the sweep: {chunk_total_ms:.6f} ms in "
          f"{traced_launches} launches = {chunk['sweep_ms_per_launch']:.6f} "
          f"ms a launch, {chunk['sweep_ms_per_step'] * 1e3:.4f} us a step")
    for e in sorted(dev_events, key=lambda e: -e.count)[:8]:
        print(f"    device {e.key[:60]}: {e.count} calls, "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms")
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in top:
        print(f"    host {e.key}: {e.count} calls, self "
              f"{e.self_cpu_time_total / 1e3:.1f} ms")

    # ---- phase 8: the serving main path -----------------------------------
    serving, serve_launches = [], {}
    for arch in SERVE_ARCHS:
        phase(f"phase 8: serving {arch} (full config, bf16, random weights "
              f"from seed {SEED}): {SERVE_BATCH} prompts x {PROMPT_LEN} "
              f"tokens, {GEN_TOKENS} new tokens each, greedy")
        rec = serving_phase(arch, fa, ms)
        serving.append(rec)
        serve_launches[arch] = (rec["attention_launches"],
                                rec["scan_launches"])

    # ---- phase 9: float32 A/B of the kernels against the plain versions ----
    ab = []
    for arch in SERVE_ARCHS:
        phase(f"phase 9: {arch} in float32, impl='cuda' against impl='ref'")
        ab.append(ab_phase(arch, fa, ms))

    # ---- phases 10-13: the event engine, routing, optimizer, experiments --
    import repro_torch.core as core
    phase("phase 10: the event engine and engine='auto' routing")
    host_paths = {"event_engine": event_engine_phase(core, cc)}
    phase(f"phase 11: run parity, CTMC on the card ({PARITY_CTMC} "
          f"replicas) against the event engine ({PARITY_EVENT})")
    host_paths["parity"] = parity_phase(core, cc)
    phase(f"phase 12: optimize_checkpoint_interval on the card, twice "
          f"({OPT_REPLICAS} replicas, {OPT_GRID}-point grid, "
          f"{OPT_REFINE} refinements)")
    host_paths["optimizer"] = optimizer_phase(core, cc)
    phase("phase 13: a json experiment file through load_experiment")
    host_paths["experiment"] = experiment_phase(core, cc)
    print(f"  phases 10-13: "
          f"{sum(v['seconds'] for v in host_paths.values()):.3f} s")

    # ---- phases 14-15: the non-exponential failure families --------------
    t14 = time.perf_counter()
    families = {}
    for name in FAMILY_SWEEPS:
        phase(f"phase 14: {name} failures, phase 5's sweep "
              f"({FAMILY_SWEEPS[name]['distribution_kwargs']})")
        families[name] = family_phase(core, cc, vectorized, name,
                                      FAMILY_SWEEPS[name])
    secs14 = time.perf_counter() - t14
    print(f"  phase 14: {secs14:.3f} s")
    phase(f"phase 15: run parity of the families, CTMC on the card "
          f"({NONEXP_CTMC} replicas) against the event engine "
          f"({NONEXP_EVENT})")
    nonexp_parity = nonexp_parity_phase(core, cc, NONEXP_PARITY)
    print(f"  phases 14-15: {secs14 + nonexp_parity['seconds']:.3f} s")
    host_paths["families"] = {
        "seconds": secs14,
        **{name: {k: rec[k] for k in ("launches", "steps", "wall_s",
                                       "sweep_ms_per_launch", "live_rows")}
           for name, rec in families.items()}}
    host_paths["nonexp_parity"] = nonexp_parity

    # ---- phases 16-17: the non-exponential repair families ----------------
    t16 = time.perf_counter()
    repairs = {}
    for name, kw in REPAIR_SWEEPS.items():
        phase(f"phase 16: {name} repairs, phase 5's sweep "
              f"({kw.get('distribution_kwargs', {})})")
        repairs[name] = family_phase(core, cc, vectorized, name, kw)
    secs16 = time.perf_counter() - t16
    print(f"  phase 16: {secs16:.3f} s")
    phase(f"phase 17: run parity of the repair families, CTMC on the card "
          f"({NONEXP_CTMC} replicas) against the event engine "
          f"({NONEXP_EVENT})")
    repair_parity = nonexp_parity_phase(core, cc, REPAIR_PARITY)
    print(f"  phases 16-17: {secs16 + repair_parity['seconds']:.3f} s")
    host_paths["repairs"] = {
        "seconds": secs16,
        **{name: {k: rec[k] for k in ("launches", "steps", "wall_s",
                                       "sweep_ms_per_launch", "live_rows",
                                       "n_slots", "overflow")}
           for name, rec in repairs.items()}}
    host_paths["repair_parity"] = repair_parity

    # ---- phases 18-19: fault domains and campaigns ------------------------
    t18 = time.perf_counter()
    phase(f"phase 18: OneWaySweep rack_shock_rate={SHOCK_RATES}, "
          f"{N_REPLICAS} replicas, Table-I width, {SHOCK_RACKS} racks in "
          f"pods of {SHOCK_RACKS_PER_POD}, job_length {SHOCK_DAYS} days")
    shock = shock_sweep_phase(core, cc, vectorized)
    secs18 = time.perf_counter() - t18
    print(f"  phase 18: {secs18:.3f} s")
    t19 = time.perf_counter()
    campaigns = {}
    for name, kw in CAMPAIGN_FAMILIES.items():
        phase(f"phase 19: a scripted campaign (kill of rack 3 at 0.25, a "
              f"window at 0.5 for 0.05 of the job) under {name} failures, "
              f"{N_REPLICAS} replicas, Table-I width")
        t_fam = time.perf_counter()
        campaigns[name] = campaign_phase(core, cc, vectorized, name, kw)
        print(f"  {name}: {time.perf_counter() - t_fam:.3f} s")
    phase(f"phase 19: run parity of tests/test_faultdomains.py's SCENARIO, "
          f"CTMC on the card ({SCEN_PARITY_CTMC} replicas) against the "
          f"event engine ({SCEN_PARITY_EVENT})")
    scen_parity = scenario_parity_phase(core, cc)
    secs19 = time.perf_counter() - t19
    print(f"  phase 19: {secs19:.3f} s; phases 18-19: "
          f"{secs18 + secs19:.3f} s")
    host_paths["scenarios"] = {
        "seconds": secs18 + secs19, "parity": scen_parity,
        "rack_outages": {k: shock[k] for k in (
            "launches", "steps", "wall_s", "plain_wall_s", "plain_identity",
            "rate0_lanes_differing", "mean_shocks", "sweep_ms_per_launch")},
        **{f"campaign_{name}": {k: rec[k] for k in (
            "launches", "steps", "wall_s", "sweep_ms_per_launch")
            + (("plain_wall_s", "plain_identity") if "plain_identity" in rec
               else ())} for name, rec in campaigns.items()}}

    # ---- phases 20-21: the multi-job CTMC engine ---------------------------
    t20 = time.perf_counter()
    phase(f"phase 20: MultiJobSweep spare_pool_size={MJ_SPARES} x "
          f"repair_servers={MJ_SHOPS}, {len(MJ_JOBS)} jobs "
          f"({'/'.join(str(j[0]) for j in MJ_JOBS)}) on a "
          f"{MJ_CLUSTER['working_pool_size']}-server pool, {MJ_REPLICAS} "
          "replicas, engine='auto'")
    multijob = multijob_phase(core, cc, mjc, des_step, ref)
    secs20 = time.perf_counter() - t20
    print(f"  phase 20: {secs20:.3f} s")
    t20b = time.perf_counter()
    phase(f"phase 20b: the multi-job grid at benchmarks/engine_perf.py::"
          f"multijob_sweep_throughput's shape: spare_pool_size="
          f"{MJ_BENCH_SPARES} x repair_servers={MJ_BENCH_SHOPS}, "
          f"{MJ_REPLICAS} replicas")
    mj_bench = multijob_bench_phase(core, cc, mjc, des_step, ref)
    secs20b = time.perf_counter() - t20b
    print(f"  phase 20b: {secs20b:.3f} s")
    t21 = time.perf_counter()
    phase(f"phase 21: run parity of tests/test_multijob_parity.py's two- "
          f"and four-job clusters, CTMC on the card ({MJ_PARITY_CTMC} "
          "replicas) against the event engine")
    mj_parity = multijob_parity_phase(core, mjc, des_step, ref)
    secs21 = time.perf_counter() - t21
    print(f"  phase 21: {secs21:.3f} s; phases 20-21: "
          f"{secs20 + secs20b + secs21:.3f} s")
    host_paths["multijob"] = {
        "seconds": secs20 + secs20b + secs21, "parity": mj_parity,
        "benchmark_shape": {k: mj_bench[k] for k in (
            "launches", "steps", "rows", "wall_s", "warm_wall_s",
            "sweep_ms_per_step", "sweep_ms_per_launch", "busy_share",
            "bound_ms")},
        **{k: multijob[k] for k in (
            "launches", "chunks", "steps", "race_launches", "wall_s",
            "ms_per_step", "warm_wall_s", "engine_wall_s", "plain_wall_s",
            "plain_bit_different",
            "single_job_chunk_launches", "single_job_mj_launches",
            "single_job_differing", "busy_share",
            "busy_share_untraced_wall", "kernels_per_step")}}

    # ---- phases 22-23: float64 age and replica sharding -------------------
    phase("phase 22: float64 age at Table-I width (Weibull failures with "
          "Weibull repairs, phase 14's Weibull sweep, phase 19's Weibull "
          "campaign), each against its float32 twin")
    age64, secs22 = age64_phase(core, cc, vectorized, families, campaigns)
    host_paths["age64"] = {"seconds": secs22, **{
        label: {k: rec[k] for k in (
            "launches", "steps", "wall_s", "ms", "call_ms", "twin_ms",
            "twin_launches", "bound_ms", "bit_different", "z",
            "diverged_rows", "rows", "sweep_ms_per_launch")}
        for label, rec in age64.items()}}
    phase("phase 23: replica sharding: engine_shards=1 on phases 5 and 20, "
          "two shards on two cards or the one-card refusal")
    host_paths["sharding"] = sharding_phase(core, cc, mjc, vectorized, base,
                                            final, multijob)

    # ---- phase 24: the paper's own tables and the trace-fitting CLI -------
    phase("phase 24: the paper's Fig. 2a / 2b and Table-I sensitivity grid "
          "at full size against the JAX package's tables, the five paper "
          "claims, and the trace-fitting CLI's selftest")
    paper = paper_phase(core, cc, vectorized, des_step)
    host_paths["paper_tables"] = paper

    # ---- phases 25-28: the shape caps, then training -----------------------
    from repro_torch.core import vectorized_multijob as vmj
    from repro_torch.kernels import ops
    phase("phase 25: shapes past the standard chunk instances' caps under "
          "the default impl (65 and 256 empirical failure segments, 65 "
          "empirical repair segments, a 32,768-slot Weibull repair lane in "
          "float32 and float64 age, 65,536 histogram edges; nine and sixteen"
          " jobs)")
    caps = shape_caps_phase(core, cc, mjc, vectorized, vmj, ref)
    host_paths["shape_caps"] = {
        k: v if k in ("seconds", "J8") else {f: v.get(f) for f in (
            "launches", "wide_launches", "runtime_launches", "chunks", "ms",
            "call_ms", "plain_ms", "standard_ms", "bound_ms", "bound_by",
            "bit_different", "live_rows", "rows_per_block")}
        for k, v in caps.items()}
    phase("phase 26: the attention and scan kernels under autograd at the "
          "training shapes (qwen2.5-3b attention, falcon-mamba-7b scan, "
          f"batch {TRAIN_B} x {TRAIN_S}), bf16 and float32")
    host_paths["train_kernels"] = train_kernels_phase(fa, ms, ops)
    phase("phase 27: make_train_step at full width: qwen2.5-3b (36 layers) "
          "and falcon-mamba-7b (4 of 64 layers), bf16 parameters, float32 "
          f"AdamW state, batch {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} steps")
    t27 = time.perf_counter()
    train_steps = train_step_phase(fa, ms, card_line)
    host_paths["train_step"] = train_steps
    print(f"  phase 27: {time.perf_counter() - t27:.3f} s")
    phase("phase 28: the fault-tolerant loop, examples/torch_train_with_"
          f"failures.py's 100m preset, {TRAIN_LOOP_STEPS} steps, a failure "
          f"at step {TRAIN_LOOP_FAILURE}, against a run without it")
    host_paths["train_loop"] = train_loop_phase(core)

    # ---- phase 29: the MoE layers ------------------------------------------
    from repro_torch.configs import get_config
    t29 = time.perf_counter()
    moe_launches = {}
    for arch, n_layers in MOE_SERVE:
        phase(f"phase 29a: serving {arch} at full width, {n_layers} of "
              f"{get_config(arch).n_layers} layers (bf16, random weights from "
              f"seed {SEED}): {SERVE_BATCH} prompts x {PROMPT_LEN} tokens, "
              f"{GEN_TOKENS} new tokens each, greedy")
        torch.cuda.reset_peak_memory_stats()
        rec = serving_phase(arch, fa, ms, n_layers=n_layers,
                            extra=moe_serving_extra(fa))
        serving.append(rec)
        moe_launches[arch] = rec["attention_launches"]
    phase(f"phase 29b: {MOE_AB_ARCH}'s smoke config (attention + Mamba + "
          "MoE) in float32, impl='cuda' against impl='ref'")
    moe_ab = moe_ab_phase(fa, ms)
    ab.append(moe_ab)
    phase("phase 29c: the MoE dispatch on the card against the CPU's at "
          f"{MOE_SERVE[0][0]}'s prefill shape")
    host_paths["moe_dispatch"] = moe_dispatch_phase()
    phase("phase 29d: make_train_step on the MoE smoke configs on the card "
          "against the CPU")
    host_paths["moe_train"] = moe_train_phase(fa, ms)
    host_paths["moe_seconds"] = time.perf_counter() - t29
    print(f"  phase 29: {host_paths['moe_seconds']:.3f} s")

    # ---- phase 30: cross-attention -----------------------------------------
    t30 = time.perf_counter()
    cross_launches = {}
    for sub, (arch, n_layers, prompt_len) in zip("ab", CROSS_SERVE):
        cfg = get_config(arch)
        depth = (f"all {cfg.encoder_layers} encoder and {cfg.n_layers} "
                 "decoder layers" if n_layers is None else
                 f"{n_layers} of {cfg.n_layers} layers "
                 f"({n_layers // cfg.superblock_size} of its "
                 f"{cfg.n_superblocks} superblocks)")
        phase(f"phase 30{sub}: serving {arch} at full width, {depth} (bf16, "
              f"random weights from seed {SEED}): {SERVE_BATCH} prompts x "
              f"{prompt_len} tokens over their "
              f"{'frames' if cfg.is_encdec else 'image tokens'}, "
              f"{GEN_TOKENS} new tokens each, greedy")
        torch.cuda.reset_peak_memory_stats()
        rec = serving_phase(arch, fa, ms, n_layers=n_layers,
                            extra=cross_serving_extra, prompt_len=prompt_len)
        serving.append(rec)
        cross_launches[arch] = rec["attention_launches"]
    phase("phase 30c: whisper-base and llama-3.2-vision-90b's smoke config in "
          "float32, impl='cuda' against impl='ref', layer by layer")
    ab.extend(cross_ab_phase(fa, ms))
    phase("phase 30e: make_train_step on the cross-attention smoke configs on "
          "the card against the CPU, then whisper-base at full size")
    host_paths["cross_train"] = cross_train_phase(fa, ms, card_line)
    host_paths["cross_seconds"] = time.perf_counter() - t30 + t30d
    print(f"  phase 30: {host_paths['cross_seconds']:.3f} s ({t30d:.3f} s "
          "of it phase 30d, beside phase 3)")

    # ---- phase 31: the mesh steps ------------------------------------------
    mesh = mesh_phase(fa, ms, card_line)
    host_paths["mesh"] = mesh

    # ---- phase 32: the dry run and the roofline ----------------------------
    host_paths["dryrun"] = dryrun_phases(dry_proc, fa, card_line)

    # the standalone race's record: its launches on the main paths, the
    # single-job (phase 5) and multi-job (phases 20, 20b, 21) ones, where
    # the chunk kernels replaced it (0: each phase fails on a race launch);
    # its times and bound alone at phase 20's middle chunk's middle step,
    # and phase 2's numbers at the single-job shape beside them
    mism, rel, abs_err = main_err
    mj_race = multijob["race"]
    record = {"name": "event_race", "route": "cuda", "source": KERNEL_SOURCE,
              "replaces": TPU_KERNEL,
              "replaces_function": "src/repro/kernels/des_step.py:"
                                   "_event_race_kernel",
              "launches": race_launches + multijob["race_launches"],
              "launches_path": "the single-job and multi-job main paths "
                               "(phases 5 and 20)",
              **{k: mj_race[k] for k in (
                  "max_abs_err", "event_mismatches", "dt_max_rel_err",
                  "shape", "ms", "plain_ms", "call_ms", "plain_call_ms",
                  "bound_ms", "bound_by")},
              "phase2_shape": [B_main, 16, 3], "phase2_max_abs_err": abs_err,
              "phase2_event_mismatches": mism, "phase2_dt_max_rel_err": rel,
              "phase2_ms": k_ms if k_dev is None else k_dev,
              "phase2_plain_ms": r_ms if r_dev is None else r_dev,
              "phase2_bound_ms": bound_ms, "library_ms": None}
    mj_records = []
    for J, label, rec, launches_, extra in (
            (3, "capacity_planning grid", multijob["chunk"],
             multijob["launches"],
             {"steps": multijob["steps"], "sweep_ms_per_launch":
              multijob["chunk"]["sweep_ms_per_launch"]}),
            (3, "multijob_sweep_throughput shape", mj_bench,
             mj_bench["launches"],
             {"steps": mj_bench["steps"], "wall_s": mj_bench["wall_s"],
              "sweep_ms_per_launch": mj_bench["sweep_ms_per_launch"]}),
            *((v["J"], f"phase 21 {k} run parity", v, v["launches"],
               {"steps": v["steps"]})
              for k, v in mj_parity.items() if k != "seconds")):
        mj_records.append(dict(
            {k: rec[k] for k in ("max_abs_err", "bit_different", "call_ms",
                                 "plain_ms", "plain_call_ms", "bound_ms",
                                 "bound_by", "ms_per_step", "rows_per_block",
                                 "live_rows", "row_steps")},
            name=f"mj_chunk[J={J}]", instance=label, route="cuda",
            source=MJ_SOURCE, replaces=TPU_KERNEL,
            replaces_function="src/repro/kernels/des_step.py:"
                              f"_event_race_kernel ({16 * J} rates x "
                              f"{2 * J} residuals) and the lax.scan of "
                              f"{MJ_SCAN} (_mj_chunk_loop)",
            launches=launches_,
            ms=rec["call_ms"] if rec["ms"] is None else rec["ms"],
            library_ms=None, **extra))
    chunk_record = dict(
        chunk, name="ctmc_chunk", instance="exponential", route="cuda",
        source=CHUNK_SOURCE,
        replaces=TPU_KERNEL,
        replaces_function="src/repro/kernels/des_step.py:_event_race_kernel"
                          f" and the lax.scan of {CHUNK_SCAN}",
        launches=launches, steps=chunk_steps,
        optimizer_launches=host_paths["optimizer"]["launches"],
        parity_launches={k: v["launches"]
                         for k, v in host_paths["parity"].items()
                         if k != "seconds"},
        experiment_launches=host_paths["experiment"]["launches"],
        paper_tables_launches=paper["launches"],
        paper_tables_first_chunk=paper["first_chunk"],
        ms=chunk["call_ms"] if chunk["ms"] is None else chunk["ms"],
        library_ms=None)
    kernels = [record, chunk_record] + mj_records
    for name, rec in families.items():
        kernels.append(dict(
            {k: rec[k] for k in ("max_abs_err", "bit_different", "call_ms",
                                 "plain_ms", "plain_call_ms", "bound_ms",
                                 "bound_by", "ms_per_step",
                                 "sweep_ms_per_launch", "steps")},
            name=f"ctmc_chunk[{rec['kind']}]", route="cuda",
            source=CHUNK_SOURCE, replaces=TPU_KERNEL,
            replaces_function="src/repro/kernels/des_step.py:"
                              "_event_race_kernel (16 rates x 4 residuals) "
                              f"and the lax.scan of {CHUNK_SCAN}",
            instance=rec["kind"], launches=rec["launches"],
            **({"fit_selftest_launches": paper["fit_selftest"]["launches"]}
               if rec["kind"] == "empirical" else {}),
            ms=rec["call_ms"] if rec["ms"] is None else rec["ms"],
            library_ms=None))
    for name, rec in repairs.items():
        kernels.append(dict(
            {k: rec[k] for k in ("max_abs_err", "bit_different", "call_ms",
                                 "plain_ms", "plain_call_ms", "bound_ms",
                                 "bound_by", "ms_per_step",
                                 "sweep_ms_per_launch", "steps", "n_slots")},
            name=f"ctmc_chunk[{rec['kind']}+slots:{rec['rkind']}]",
            route="cuda", source=CHUNK_SOURCE, replaces=TPU_KERNEL,
            replaces_function="src/repro/kernels/des_step.py:"
                              "_event_race_kernel (16 rates x 4 residuals, "
                              "the repair-slot residual first) and the "
                              f"lax.scan of {CHUNK_SCAN}",
            instance=f"{rec['kind']} + repair slots", repairs=rec["rkind"],
            launches=rec["launches"],
            ms=rec["call_ms"] if rec["ms"] is None else rec["ms"],
            library_ms=None))
    scen_records = [("exponential", shock,
                     campaigns["exponential"]["launches"])]
    scen_records += [(name, rec, 0) for name, rec in campaigns.items()
                     if name != "exponential"]
    for name, rec, more in scen_records:
        kernels.append(dict(
            {k: rec[k] for k in ("max_abs_err", "bit_different", "call_ms",
                                 "plain_ms", "plain_call_ms", "bound_ms",
                                 "bound_by", "ms_per_step",
                                 "sweep_ms_per_launch", "steps",
                                 "struck_row_steps")},
            name=f"ctmc_chunk[{name}+scenario]", route="cuda",
            source=CHUNK_SOURCE, replaces=TPU_KERNEL,
            replaces_function="src/repro/kernels/des_step.py:"
                              "_event_race_kernel (16 + 45 rates, the "
                              "campaign residual first) and the lax.scan "
                              f"of {CHUNK_SCAN}",
            instance=f"{name} + fault domains", launches=rec["launches"]
            + more,
            ms=rec["call_ms"] if rec["ms"] is None else rec["ms"],
            library_ms=None))
    for label, rec in age64.items():
        kernels.append(dict(
            {k: rec[k] for k in ("max_abs_err", "bit_different", "call_ms",
                                 "plain_ms", "plain_call_ms", "bound_ms",
                                 "bound_by", "ms_per_step",
                                 "sweep_ms_per_launch", "steps", "twin_ms",
                                 "z", "diverged_rows")},
            name=f"ctmc_chunk_age64[{label}]", route="cuda",
            source=CHUNK_SOURCE, replaces=TPU_KERNEL,
            replaces_function="src/repro/kernels/des_step.py:"
                              "_event_race_kernel and the lax.scan of "
                              f"{CHUNK_SCAN}, under age_dtype='float64'",
            instance=f"{label}, float64 age", launches=rec["launches"],
            ms=rec["call_ms"] if rec["ms"] is None else rec["ms"],
            library_ms=None))
    for name, rec in caps.items():
        if name in ("seconds", "J8"):
            continue
        runtime = name.startswith("J")
        kernels.append(dict(
            {k: rec[k] for k in ("max_abs_err", "bit_different", "call_ms",
                                 "plain_ms", "plain_call_ms", "bound_ms",
                                 "bound_by", "ms_per_step", "standard_ms",
                                 "live_rows")},
            name=(f"mj_chunk_rt[J={rec['J']}]" if runtime
                  else f"ctmc_chunk_wide[{name}]"),
            route="cuda", source=MJ_SOURCE if runtime else CHUNK_SOURCE,
            replaces=TPU_KERNEL,
            replaces_function="src/repro/kernels/des_step.py:"
                              "_event_race_kernel and the lax.scan of "
                              + (MJ_SCAN if runtime else CHUNK_SCAN),
            instance=("runtime-J, -DMJ_RUNTIME_J" if runtime
                      else "wide, -DCTMC_WIDE"),
            launches=rec["runtime_launches" if runtime else "wide_launches"],
            ms=rec["call_ms"] if rec["ms"] is None else rec["ms"],
            library_ms=None))
    train_launches = {arch: [st["launches"] for st in rec["steps"]]
                      for arch, rec in train_steps.items()}
    for name, source, replaces, launches_, t, arch in (
            ("flash_attention", ATTN_SOURCE, ATTN_TPU_KERNEL,
             serve_launches["qwen2.5-3b"][0], attn, "qwen2.5-3b"),
            ("selective_scan", SCAN_SOURCE, SCAN_TPU_KERNEL,
             serve_launches["falcon-mamba-7b"][1], scan, "falcon-mamba-7b")):
        moe_paths = ({**moe_launches, f"{MOE_AB_ARCH} (smoke)":
                      moe_ab["attention_launches"]} if name == "flash_attention"
                     else {f"{MOE_AB_ARCH} (smoke)": moe_ab["scan_launches"]})
        cross = ({"cross_serving_launches": cross_launches,
                  "cross_train_launches_per_step": [
                      st["launches"] for st in
                      host_paths["cross_train"]["whisper-base"]["steps"]],
                  "cross_regimes": cross_regimes}
                 if name == "flash_attention" else {})
        mesh_launches = {
            f"{a} on the (1, 1) mesh": mesh[a]["launches"][
                0 if name == "flash_attention" else 1]
            for a, _ in MESH_SERVE}
        if name == "flash_attention":
            mesh_launches[f"qwen2.5-3b ({MESH_TRAIN_LAYERS} layers, "
                          "float32) train step on the mesh"] = \
                mesh["train"]["launches"]
            mesh_launches.update({
                f"{MESH_MOE[0]} ({MESH_MOE[1]} layer, {m}) on the mesh":
                rec["launches"][0] for m, rec in mesh["moe"].items()})
        if name == "flash_attention":
            dry = host_paths["dryrun"]["card"]
            cross["dryrun_check_launches"] = {
                f"qwen2.5-3b {k}, kernel path, {DRYRUN_REPS} calls":
                dry[k]["launches"] for k in ("prefill", "decode")}
        kernels.append(dict(t, name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches_,
                            train_launches_per_step=train_launches[arch],
                            moe_serving_launches=moe_paths, **cross,
                            mesh_launches=mesh_launches,
                            ms=t["call_ms"] if t["ms"] is None else t["ms"]))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, builds "
          "included")
    print(json.dumps({"serving": serving, "ab_float32": ab,
                      "host_paths": host_paths}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
