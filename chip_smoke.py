#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it exits non-zero, printing no result
line, when there is no card or when the repository's sources are missing.

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of the CUDA library from the repository's sources;
3. each of the four fragscore kernels against its plain torch version at
   the main path's full-width shapes (R = 500 replicas of M = 100 GPUs,
   every demand class, both metrics, the fusable key sets, homogeneous and
   four-model tables; for ``migrate_refine`` C_live = 800 victims per
   replica), equal with a tolerance of 0, with its time, its bound on the
   card and its plain version's time (``migrate_refine`` also alone with
   no victims, C = 0: its pass 0, and pass 1 by difference); besides,
   ``fragscore`` on all 2^S occupancy patterns of every device model and on
   rows with entries outside {0, 1}, ``select_from_base`` on empty, full
   and one-feasible fleets, R = 1, R = 499 and M = 33, and
   ``delta_from_base`` on the window counts of every occupancy pattern of
   each device model (homogeneous fleets and the four-model fleet, one
   replica per class), on negative counts, on tables outside its bit form
   and at R = 1, M = 10,000 and R = 7, M = 333, each kernel giving the same
   bits on two calls;
4. the pinned golden results of the reference package, mfi-defrag's
   included, reproduced with the kernels on;
5. the paper's experiment at full width (M = 100 A100-80GB, uniform mix,
   offered load 1.0, seed 0, R = 500) for mfi, ff, bf-bi, wf-bi, rr, a
   delta-only mfi spec and mfi-defrag, once through the kernels (mfi
   over the whole stream, the others over its first 250
   events; launch counts reset just before and read just after) and once
   through the plain lowering over the first 128 of the same events: traces equal
   there, launch counts matching the events; then a profiled 32-event window of the mfi, the
   delta-only and the mfi-defrag step, each also run unprofiled, the
   kernel path's event loop under ``torch.cuda.set_sync_debug_mode("error")``
   (no host sync); then the paper's Fig. 5 through the kernels (ff, rr,
   bf-bi, wf-bi, mfi over the four Table-II mixes, M = 100, load 0.85,
   seed 0, R = 500), each point beside its row of
   ``experiments/fig5_batched_500.csv`` (printed, not asserted) with its
   replica-events/s, launch counts reset just before each point;
6. the ``decode_attention`` kernel against its plain torch version
   (float32: max abs error <= 1e-5; bfloat16: |kernel - plain| <= 2e-2 +
   2e-2·|plain| and, scale-aware, <= 2^-7·|plain| + 2^-10·rms(plain row),
   the plain version computed in float32 from the same bfloat16 inputs),
   two calls on the same inputs equal bit for bit, at
   (a) the serving path's shape (B = 4 slots, H = 32, K = 8, D = 64,
   S = max_len = 161, bf16, length = pos + 1), (b) a long serving shape
   (B = 8, S = 8192, bf16, ragged lengths from 1 to S), (c) B = 4,
   S = 2048, (d) B = 1, S = 32,768 (67 MB of cache, the split the only
   parallelism), float32 with a scale override and G = 12, and the
   split-KV edges (lengths 0, 1, one split and one split ± 1 with S not a
   multiple of the split; G = 1 and G = 8; bf16 at D = 128 and 256), the
   per-row ``start`` of the sliding-window layers (a start inside a split,
   at a split's first key and one before it, equal to the length, past it;
   the tensor-core path at D = 128 and the CUDA-core one at D = 256), and
   the decode shapes of phase 13's models: (e) gemma3-12b's local cache
   padded past its window (B = 4, K = 8, G = 2, D = 256, S = 2,081, start
   = pos - 1,023) and (f) its wrapped ring of 1,024 slots, (g) qwen3-14b's
   G = 5 at D = 128, (h) starcoder2-15b's G = 12 at D = 128, (i)
   paligemma-3b's K = 1, G = 8 at D = 256, and phase 14's: (j)
   granite-moe-3b-a800m's G = 3 (B = 4, H = 24, K = 8, D = 64, bf16,
   S = 1,057 = prompt + new + 1) and (k) grok-1-314b's SMOKE (K = 2,
   G = 2, float32, S = 41), and phase 15's (l) hymba-1.5b's local cache
   padded past its window (B = 4, K = 5, G = 5, D = 64, bf16, S = 1,042,
   start = pos - 1,023), and phase 16's (m) whisper-large-v3's self cache
   (B = 4, K = 20, G = 1, D = 64, bf16, S = 144 read whole) and (n) its
   cross cache (S = 1,536 frames read whole), and phase 17's hymba-1.5b
   global layer at its assigned sizes (K = 5, G = 5, D = 64, bf16, every
   key read): (o) decode_32k's B = 128, S = 32,768 (5.37 GB of cache) and
   (p) long_500k's B = 1, S = 524,288; for (a)-(p) its device time, time
   per call, bound, plain time and the time of
   ``scaled_dot_product_attention`` (the kernel must beat it at (b));
7. the serving path at full width: ``llama3.2-1b`` (bf16, random weights
   from a ``torch.Generator`` seeded 0) behind the MIG admission controller
   (4 A100-80GB GPUs, mfi, 16 requests of the uniform mix, prompts of 128
   tokens, 32 new tokens, 4 slots) through ``ServingEngine.run``, launch
   counts reset just before and read just after (``decode_attention`` =
   layers × decode steps); the admission stats against the controller
   alone; one decode step's attention inputs through the kernel and the
   plain version; prefill and decode times and a profiled window of 16
   decode steps; then ``launch/serve.py`` run as it stands;
8. the ``mfi_delta`` kernel against its plain version on random occupancy
   at 45 % fill: A100-80GB at M = 100, 1,000, 10,000 and 1,000,000 GPUs,
   A100-40GB and H200-141GB at M = 10,000, every demand class, both
   metrics (plus non-binary occupancy at M = 10,000), equal with a
   tolerance of 0, with its time, bound and plain version's time; then on
   every occupancy pattern and on rows with entries outside {0, 1} of each
   device model, under its table and tables outside the kernel's bit form,
   every class, both metrics, the same bits on two calls;
9. the single-decision path: the host reference engine at the paper's
   Fig. 4 point (M = 100 A100-80GB, uniform mix, steady, load 1.0, seed 0)
   driven by a scheduler that decides on the card through
   ``cluster.mfi_select(use_kernel=True)`` (launch counts reset just
   before and read just after: ``mfi_delta`` = arrivals), each decision
   held to the dense lowering on the card and the host MFI scheduler, the
   result equal to the host MFI run field for field; a card-resident loop
   of 1,000 decisions at M = 10,000 (``mfi_select(use_kernel=True)``,
   ``mfi_allocate``, seeded ``release``s, no host sync inside) held
   decision for decision to ``mfi_allocate`` and at its end to a host
   ``ClusterState`` replay; decisions/s of both lowerings; then
   ``api.simulate(engine="batched")`` against ``run_batched``;
10. the cumulative and queued protocols: the cumulative protocol at the
    paper's fleet (M = 100, uniform mix, seed 0, R = 500) for mfi, ff and
    mfi-defrag, the kernel path's trace and aggregates equal to the plain
    path's, and at R = 8 its decisions equal to the host schedulers'
    (``sim/replay.py``) and ``run_batched`` to the host engine's
    ``run_many``; the reference's two pinned queued hashes with the
    kernels on; the queued protocol at M = 100, load 1.1, R = 500 for mfi
    (its whole stream) and mfi-queued (its first 250 events), kernel
    equal to plain over the first 128 events,
    with its wait percentiles,
    fairness, wait-admits and ``select_from_base`` launches per event (2),
    and on 4 of its replicas the card's trace equal to
    ``queued_host_decisions``;
    every kernel-path loop under ``set_sync_debug_mode("error")``, launch
    counts reset just before each run; a profiled 32-event window of the
    queued mfi loop;
11. the faulted protocol and the chunked driver: the reference's two
    pinned faulted hashes with the kernels on; the faulted protocol at
    M = 100, load 1.1, MTBF 60, MTTR 10, wait ring 8, patience 16, seed 0,
    R = 500 for mfi (the kernel path over the whole stream) and mfi-queued
    and ff (its first 128 events), kernel path equal to plain in every
    field over the first 128 events, launches per event exact (``fragscore`` 3,
    ``delta_from_base`` 2 for the ΔF policies, ``select_from_base`` 0), the
    kernel loop under ``set_sync_debug_mode("error")``, evictions > 0 and
    the fault keys of the run; on 4 of its replicas the card's trace equal
    to ``replay.faulted_host_decisions``; a profiled 32-event faulted
    window; the mfi rows of ``experiments/fig_faults_batched_30.csv`` (R =
    30 each, as five blocks of one run) and their queued anchor through
    ``run_batched`` (printed beside the recorded rows, not asserted), and
    ``run_batched`` at MTBF 60
    equal to its block; ``simulate_chunked`` at the Fig. 4 point (steady
    mfi, R = 500) at chunk size 256 and at the faulted point at
    chunk 512, each equal to its monolithic trace, a resume from the
    checkpoint it wrote after chunk 2 equal for one more chunk, with the
    copies' overlap share, wall time and peak device memory of both
    drivers (each phase prints its seconds);
12. the LM training path, which launches none of the kernels (the
    reference trains outside any Pallas kernel; the launch counts stay 0):
    (a) the flash-attention ``autograd.Function`` against plain autograd of
    the untiled attention at S = 4,096, B = 1, H = 32, KV = 8, D = 64,
    output and dq/dk/dv, float32 within 1e-5 of each tensor's scale and
    bfloat16 within 2e-2 + 2e-2·|plain|, with both times; (b) one SMOKE
    train step on the card against the same step on the CPU (float32, TF32
    off): loss, every gradient leaf, the parameters after AdamW; (c)
    ``launch/train.py --arch llama3.2-1b --smoke --steps 50 --batch 8
    --seq 128`` as it stands, which must print LEARNING; (d) at full width
    (bf16, random weights seeded 0, float32 moments) ``launch/train.py
    --arch llama3.2-1b --steps 5 --batch 8 --seq 128`` and two
    ``steps.train_step`` steps at train_4k's S = 4,096 with a global batch
    of 4 (cut from 256) as 2 micro-batches of 2, every loss finite, with
    ms per step, tokens/s, peak device memory against its reckoning, model
    FLOPs (6·N_active·tokens plus attention) and their share of the bf16
    dense peak, and a profiled step of one micro-batch split by what
    launched each kernel (attention, CE, optimizer, other matmuls, the
    rest); (e) one SMOKE step of gemma3-12b
    (post-norms, its window on ``blockwise_attention``'s local path at
    S = 1,024) and of paligemma-3b (the patch prefix) on the card against
    the CPU, weights scaled by 0.1: the loss and every gradient leaf, then
    ``steps.train_step``; then a ``{"train": ...}`` line;
13. the dense layer options at full width (bf16, random weights from a
    ``torch.Generator`` seeded 0, one model at a time, each freed before
    the next): gemma3-12b behind the MIG admission controller through
    ``ServingEngine.run``, one wave of 4 prompts of 1,024 tokens (its
    window: the local caches padded past it, so the decode reads from
    start = pos - 1,023) and one of 2,048 (the local path of
    ``blockwise_attention``, a wrapped ring of 1,024 slots), 32 new tokens
    each, ``decode_attention`` launched 48 times a decode step (counts
    reset just before and read just after), prefill and decode times and
    a profiled window of 8 decode steps; qwen3-14b, starcoder2-15b and
    llama3.2-1b-sw one wave of 4 prompts of 128 tokens and 8 new tokens
    each (llama3.2-1b-sw also one prompt of 8,192 tokens, the local path
    at its window of 4,096); paligemma-3b prefilled at 256 patches + 128
    tokens and decoded 8 steps through ``model``; every logit finite; then
    a ``{"dense_options": ...}`` line;
14. the mixture-of-experts family (bf16 models from a ``torch.Generator``
    seeded 0, one at a time, each freed before the next): (a) ``moe_layer``
    at granite-moe-3b-a800m's SMOKE in float32 on the card and the CPU,
    an integer-valued router and inputs skewed so that expert 0
    overflows: the same top-k, ``keep``, ``slot``, ``entry_of_slot`` and
    ``slot_hit``, outputs within 1e-5 of their scale, and the bisection
    equal to jnp's scan replayed in numpy on unsorted rows; (b)
    granite-moe-3b-a800m (32 layers, E = 40, k = 8, 6.6 GB) behind the MIG
    admission controller through ``ServingEngine.run``, one wave of 4
    prompts of 1,024 tokens (cap 256) and 32 new tokens,
    ``decode_attention`` launched 32 times a decode step (counts reset
    just before and read just after), prefill and decode times, a profiled
    window of 8 decode steps and the share of prefill entries dropped
    (over capacity, and missed by the slot search); (c) granite trained at
    train_4k's S = 4,096, global batch 2 (cut from 256) as 2 micro-batches
    of 1, 2 steps, every loss finite, with ms per step, tokens/s, peak
    memory against its reckoning, model FLOPs and a profiled micro-batch
    split (attention, MoE routing and dispatch, expert products, CE,
    optimizer, the rest); (d) one grok-1-314b SMOKE step card vs CPU and
    its SMOKE served, and one MoE block at its published widths (E = 8,
    k = 2, d = 6,144, f = 32,768; 9.7 GB bf16) on 4 x 128 tokens in bf16
    and in float32: the dispatch equal, the outputs within a stated bf16
    tolerance, both times; then a ``{"moe": ...}`` line;
15. the state-space and hybrid families (bf16 models from a
    ``torch.Generator`` seeded 0, one at a time, each freed before the
    next): (a) each SMOKE (``mamba2-2.7b``, ``hymba-1.5b``) prefilled on 4 x
    64 tokens and decoded 8 teacher-forced steps on the card and the CPU
    (float32, TF32 off), logits within the tests' tolerances (1e-3 of their
    largest magnitude under the reference's initialiser, 2e-5 with the
    weight matrices scaled by 0.1), and one SMOKE step each (the loss, every
    gradient leaf, ``train_step``) as phase 12's; (b) mamba2-2.7b (64 SSD
    layers, d 2,560, H 80, N 128) and hymba-1.5b (32 layers, 25 query and
    5 KV heads beside an SSD head of H 50, N 16 in every layer, 15:1
    local/global, window 1,024) behind the MIG admission controller through
    ``ServingEngine.run``, one wave of 4 prompts of 1,024 tokens and 16
    decode steps, ``decode_attention`` launched once per layer with
    attention and step (hymba 32, mamba2 0; counts reset just before and
    read just after), prefill and decode times and a profiled window of 8
    decode steps; (c) both trained at train_4k's S = 4,096 at each config's
    own ``grad_accum``, a global batch (cut from 256) of 2 for each, 2
    steps, every
    loss finite, with ms per step, tokens/s, peak memory, model FLOPs and a
    profiled micro-batch split (attention, the SSD chunk scan, CE,
    optimizer, the rest); then a ``{"ssm": ...}`` line;
16. the encoder-decoder family (whisper-large-v3, bf16 from a
    ``torch.Generator`` seeded 0): (a) its SMOKE prefilled on 4 x (64
    frames + 64 tokens), so that ``pad_cache`` grows the cross cache as
    the reference's does, and decoded 8 teacher-forced steps on the card
    and the CPU (float32, TF32 off), logits and every cache leaf within
    the tests' tolerances with the weight matrices scaled by 0.1 and
    within twice the CPU's own one-ulp spread at this shape under the
    reference's initialiser, and one SMOKE step (the loss, every
    gradient leaf, ``train_step``) as phase 12's; (b) whisper-large-v3
    (32 + 32 layers, d 1,280, 20 heads over 20 KV heads, 3.15 GB)
    prefilled through ``model`` on 4 x (1,536 frames + 128 tokens), the
    caches padded to 144 slots (the cross cache of 1,536 frames is not
    grown), 16 decode steps, ``decode_attention`` launched twice per
    decoder layer and step (self and cross: 64; counts reset just before
    the prefill and read just after the last step), every logit finite,
    prefill and decode times and a profiled window of 8 decode steps; (c)
    whisper trained at train_4k's S = 4,096 as 2,048 frames + 2,048
    tokens, a global batch of 4 (cut from 256) as 2 micro-batches of 2, 2
    steps, every loss finite, with ms per step, tokens/s, peak memory,
    model FLOPs (6·(N_enc·frames + N_dec·tokens) plus the attention
    products) and a profiled micro-batch split (encoder attention,
    decoder self-attention, cross-attention, CE, optimizer, matmuls, the
    rest); then an ``{"encdec": ...}`` line;
17. the replica split and the launch tooling: (a) ``_visible_devices``
    made to show the one card 2 and 4 times (the hook the CPU tests patch),
    mfi over the Fig. 4 point's first 250 events (R = 500) through the
    kernels unsplit and split 2 and 4 ways, one event loop stepping every
    block in turn under ``set_sync_debug_mode("error")``: traces
    byte-equal, aggregates equal, launches D times the unsplit run's
    (counts reset just before each run), replica-events/s of each (on one
    card a split only adds launches); mfi-defrag and faulted mfi over a
    32-event engine window split 2 ways; ``simulate_chunked`` split 2 ways
    at 64 events a chunk, checkpointed every 3 chunks, its last
    checkpoint resumed unsplit; with the one card visible
    ``run_batched(shard=True)`` raises the reference's ``ValueError`` and
    ``shard=None`` equals the unsplit run (M = 20, R = 8), and a 2-way
    ``run_batched(shard=True)`` equals it too; (b) hymba-1.5b (bf16, random
    weights seeded 0) through ``launch/steps.py::build_step``'s decode
    branch at its assigned decode_32k (128 x 32,768) and long_500k
    (1 x 524,288) shapes: the cache allocated from the meta specs, drawn at
    the standard deviation each leaf has after a 4 x 256-token prefill
    (printed), full (4 steps from pos = S - 4: every key read), with ms a
    step, a profiled window's busy share, peak memory, ``decode_attention``
    launches a step (32) and finite logits; (c) the prefill branch at
    prefill_32k's S = 32,768 with the batch cut from 32 to 1, and the train
    branch's SMOKE step (hymba-1.5b, float32, weights x 0.1) card vs CPU
    with and without the ``bf16_grad`` rule; then the phase's JSON line;
18. the mesh on the one card: two processes spawned on ``cuda:0`` and
    joined by ``gloo`` (the backend stages CUDA tensors through the host;
    NCCL takes no two ranks on one card) first try ``all_reduce``,
    ``reduce_scatter_tensor`` and ``all_gather_into_tensor`` on CUDA
    tensors, through the blocking API and through the functional ops that
    DTensor calls (a pair of processes of their own: a collective may end
    them; each result printed); then llama3.2-1b (bf16, random weights
    seeded 0) at full width, 16 rows prefilled on 1,024 tokens in one
    process, decodes 4 steps through ``build_step``'s decode branch with
    its inputs placed by the specs (``steps.place``) on each mesh of the
    one group whose collectives work: (p) ``(data=2, model=1)``, 8 rows a
    rank, and (q) ``(data=1, model=2)``, heads, ff and vocab split, the
    caches' head dim on ``model`` (8 KV heads % 16 != 0) gathered at the
    attention site; a mesh left out is named with the collective it
    lacks.  Each rank's part of the logits is held to the one-process card
    run of all 16 rows within twice that run's own spread (its two halves
    of 8 rows decoded alone against all 16 at once), and (p)'s to the
    one-process run of the same 8 rows bit for bit; with ms a step, the
    collectives of the first step by kind and bytes, the gathered cache
    bytes, ``decode_attention`` launches a step on each rank (16), peak
    memory a rank and the phase's seconds; then a ``{"mesh": ...}``
    line;
19. a ``{"kernels": [...]}`` JSON line (each kernel's launches in total
    and by path), then the result line.

Every equality of phases 3-5 and 8-11 is exact: all scores are integers
held in float32.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: SHA-256 of the (ok, gpu, aidx, free_sum, active, frag) trace of
#: SimConfig(num_gpus=100, offered_load=1.0, seed=0), mfi, runs=8 — the
#: reference package's value (tests/test_torch_engine.py checks it there)
FULL_WIDTH_HASH = "c933f4e3c382ae290653d29eb457b52c6521aab868c1a8dc6b5d7736204f30b2"

#: SHA-256 of the (ok, gpu, aidx, free_sum, active, frag, mig, mig_from_gpu,
#: mig_from_anchor, mig_to_gpu, mig_to_anchor) trace of mfi-defrag at
#: SimConfig(num_gpus=100, offered_load=1.0, seed=0), runs=8, and at the
#: mixed fleet a100-80:2,h200-141:2,a100-40:1, load 1.0, seed 3, runs=4 —
#: the reference package's values (tests/test_torch_defrag_full.py checks
#: them there)
DEFRAG_FULL_WIDTH_HASH = "181cb4f270d4ad117b2419f11486930db90537983266584ebb2a77fb9d6ca2e1"
DEFRAG_MIXED_HASH = "95c0cdde028947bbd250b583b6223f72bb829150e85943fe316cb53215d42d8b"
DEFRAG_MIXED_FLEET = "a100-80:2,h200-141:2,a100-40:1"

#: the reference's pinned steady results (tests/test_engine_core.py)
GOLDEN_TRACE_HASHES = {
    "homog": "3f61871a2075ffe549c554a6820d3bccc437d8606c80dd6e471e9daa0ad00705",
    "mixed": "fc5a944c82ab6c74ca8a49b6a1ca19981d1d3fe8953f9b35cce26e67a8678d62",
}
GOLDEN_AGGREGATES = {
    ("homog_m6", "mfi"): {
        "acceptance_rate": 0.835978120978121,
        "active_gpus": 5.0,
        "allocated_workloads": 37.25,
        "frag_severity": 7.736111243565877,
        "utilization": 0.6440972222222222,
    },
    ("mixed_k2", "rr"): {
        "acceptance_rate": 0.705775877918735,
        "active_gpus": 5.583333333333333,
        "allocated_workloads": 31.25,
        "frag_severity": 8.333333651224772,
        "utilization": 0.6458333333333334,
    },
    ("four_k4", "bf-bi"): {
        "acceptance_rate": 0.8497768071971659,
        "active_gpus": 7.1875,
        "allocated_workloads": 53.25,
        "frag_severity": 7.015625,
        "utilization": 0.68359375,
    },
}

#: experiments/fig4_batched_500.csv, mfi at load 1.0 (an older engine's run:
#: printed beside this run's numbers, not asserted)
RECORDED_FIG4_MFI = "fig4,mfi,1.0,0.9322,891.6,0.8735,98.0,4.67"
#: the paper's Fig. 5 (benchmarks/fig5_distributions.py): its policies in the
#: recorded run's order, at load 0.85 over the four Table-II mixes; the
#: recorded rows (an older engine's run) are printed, not asserted
FIG5_CSV = "experiments/fig5_batched_500.csv"
FIG5_POLICIES = ("ff", "rr", "bf-bi", "wf-bi", "mfi")
FIG5_LOAD = 0.85

#: the reference's pinned queued results (tests/test_engine_core.py), over
#: its hash's fields in its order
GOLDEN_QUEUED_TRACE_HASHES = {
    "homog": "e3d1a83fced05aaa968ff95c2d9e3ed5d71839e2e12d4c6634e0389f80918925",
    "mixed": "e368416188f84d500dbb7115410d3a24152fa06eac0dce525001032273a9f32f",
}
QUEUED_HASH_FIELDS = ("ok", "gpu", "aidx", "parked", "wadm_eidx", "wadm_gpu",
                      "wadm_aidx", "free_sum", "active", "frag")
#: phase 10: the queued protocol's load (the reference's queued tests and its
#: fault sweep's queued anchor run at 1.1-1.2) and the replica counts held
#: to the host references
QUEUED_LOAD = 1.1
HOST_RUNS_CUMULATIVE = 8
HOST_RUNS_QUEUED = 4

#: phase 11: the reference's pinned faulted results (tests/test_faults.py),
#: over its hash's fields in its order, and its fault process
GOLDEN_FAULTED_TRACE_HASHES = {
    "homog": "abb15f38d863b0c6ce819b7bb452235f163bf35e876e944c1df4c51e4deaad97",
    "mixed": "1bf958443af4abdbe75e50c4ac1e026875e84b3bbddd2658800f8b7f9079f7fe",
}
FAULTED_HASH_FIELDS = QUEUED_HASH_FIELDS[:7] + ("evicted", "evict_lost", "evict_esum",
                                                "free_sum", "active", "frag")
FAULT_MTBF = 60.0
FAULT_MTTR = 10.0
HOST_RUNS_FAULTED = 4
#: the reference's fault sweep (benchmarks/fig_faults_sweep.py defaults:
#: R = 30, M = 100, load 1.1, MTTR 10, max_retries 2, 4 tenants, seed 0)
#: and its recorded rows (printed beside this run's, not asserted)
FAULT_SWEEP_CSV = "experiments/fig_faults_batched_30.csv"
FAULT_SWEEP_RUNS = 30
FAULT_SWEEP_MTBFS = (30.0, 60.0, 120.0, 240.0, 480.0)
#: chunk sizes of the chunked driver at the Fig. 4 and the faulted point
STEADY_CHUNKS = (256,)
FAULTED_CHUNK = 512

RUNS = 500
#: phase 5 holds the plain path to the kernel path over the paper point's
#: first this many events (the kernel path runs all of them), which keeps
#: the whole script well inside its time limit on a slow host
PLAIN_EVENTS = 128
#: events of each profiled engine window (phases 5, 10, 11)
WINDOW_EVENTS = 32
#: the kernel path of phase 5's side policies (ff, bf-bi, wf-bi, rr,
#: mfi-delta-only, mfi-defrag) and of phase 10's mfi-queued: their stream's
#: first this many events (mfi takes the whole stream)
SIDE_EVENTS = 250
#: phase 3's mixed fleet of four device models
FOUR_MODEL_FLEET = "a100-80:30,a100-40:30,h100-96:20,h100-80:20"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
FRAGSCORE_SOURCE = "src/repro_torch/kernels/fragscore/csrc/fragscore.cu"
DECODE_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
SOURCES = {
    "fragscore": FRAGSCORE_SOURCE,
    "delta_from_base": FRAGSCORE_SOURCE,
    "select_from_base": FRAGSCORE_SOURCE,
    "migrate_refine": FRAGSCORE_SOURCE,
    "decode_attention": DECODE_SOURCE,
    "mfi_delta": FRAGSCORE_SOURCE,
}
REPLACES = {
    "fragscore": "src/repro/kernels/fragscore/fragscore.py:76",
    "delta_from_base": "src/repro/kernels/fragscore/fragscore.py:248",
    "select_from_base": "src/repro/kernels/fragscore/fragscore.py:473",
    "migrate_refine": "src/repro/kernels/fragscore/fragscore.py:670",
    "decode_attention": "src/repro/kernels/decode_attention/decode_attention.py:73",
    "mfi_delta": "src/repro/kernels/fragscore/fragscore.py:133",
}

#: the serving phase: llama3.2-1b at full width behind MIG admission
SERVE_ARCH = "llama3.2-1b"
SERVE_GPUS = 4
SERVE_REQUESTS = 16
SERVE_SLOTS = 4
SERVE_PROMPT = 128
SERVE_NEW = 32
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_NEW + 1
#: phase 13, the dense layer options at full width: gemma3-12b behind MIG
#: admission on one wave at its window (the local caches padded past it)
#: and one at twice it (the local path of blockwise_attention, a wrapped
#: ring), DENSE_NEW new tokens each; the other archs one short wave each
DENSE_WINDOW = 1024            # gemma3-12b's window (src/repro/configs/gemma3_12b.py)
DENSE_RING_PROMPT = 1024
DENSE_LONG_PROMPT = 2048
DENSE_NEW = 32
DENSE_PROMPT = 128
DENSE_SHORT_NEW = 8
DENSE_PATCHES = 256            # paligemma-3b's num_patches
DENSE_SW_PROMPT = 8192         # llama3.2-1b-sw: the local path at its window of 4,096
DENSE_WINDOW_STEPS = 8         # decode steps of gemma3's profiled window
#: tolerances of decode_attention against its plain version (PERF.md)
F32_ATOL = 1e-5
BF16_ATOL = BF16_RTOL = 2e-2
#: and the scale-aware bound every bf16 output is held to beside it: one
#: rounding to bf16 (at most 2^-8·|plain|) with as much again for the
#: float32 arithmetic, and 2^-10 of the row's rms where |plain| is near 0
BF16_TIGHT_RTOL = 2.0 ** -7
BF16_TIGHT_ROW_ATOL = 2.0 ** -10
#: the training phase (phase 12): llama3.2-1b at train_4k's sequence length
#: (src/repro/launch/shapes.py:31) with train_4k's global batch of 256
#: cut to 4, as 2 micro-batches of 2
TRAIN_ARCH = "llama3.2-1b"
TRAIN_SEQ = 4096
TRAIN_CUT_FROM = 256
TRAIN_BATCH = 4
TRAIN_ACCUM = 2
#: timed steps (the first is left out of the mean)
TRAIN_STEPS = 2
BF16_DENSE_OPS_PER_S = 989e12  # H100 SXM bf16 dense, tensor cores
#: the flash Function against plain autograd: (B, S, H, KV, D); float32
#: within decode_attention's 1e-5 scaled by the tensor's largest magnitude
#: where that exceeds 1 (a gradient sums up to S·G terms), bfloat16 within
#: decode_attention's 2e-2 + 2e-2·|plain|
FLASH_SHAPE = (1, 4096, 32, 8, 64)
TRAIN_F32_RTOL = 1e-5
#: one SMOKE step card vs CPU: every gradient leaf within this share of its
#: largest magnitude under the reference's initialiser (std 0.25 stacked
#: weights: attention logits reach |456|, and on the CPU a one-ulp nudge of
#: the parameters moves a gradient leaf by up to 5.4e-3 of its scale) and
#: with the weights scaled by 0.1; the parameters after AdamW within
#: 1e-5·|p| + 2·lr (a gradient element near 0 may flip its sign, and Adam's
#: step with it)
SMOKE_GRAD_TOL = 1e-2
SMOKE_TAMED_GRAD_TOL = 2e-5
SMOKE_STEP_LR = 3e-4
#: phase 12's SMOKE steps of the dense layer options: (batch, sequence)
SMOKE_ARCH_STEPS = {"gemma3-12b": (4, 1024), "paligemma-3b": (4, 128)}
#: phase 14, the mixture-of-experts family: granite-moe-3b-a800m served at
#: full width on one wave of 4 prompts of 1,024 tokens (cap 256 a row),
#: 32 new tokens each, and trained at train_4k's S = 4,096 with a global
#: batch of 2 (cut from 256) as 2 micro-batches of 1, for 2 steps (3
#: steps of a batch of 4 took phase 14 to 106 s on an H100, 12.4 s a step)
MOE_ARCH = "granite-moe-3b-a800m"
MOE_PROMPT = 1024
MOE_NEW = 32
MOE_WINDOW_STEPS = 8
MOE_TRAIN_BATCH = 2
MOE_TRAIN_ACCUM = 2
MOE_TRAIN_STEPS = 2
#: (a) moe_layer card vs CPU at granite's SMOKE: (B, S), cap 40 a row
MOE_SMOKE_LAYER = (2, 64)
#: (d) grok-1-314b: its SMOKE served on a wave of 4 prompts of 32 tokens,
#: 8 new tokens, a SMOKE step (B, S), and one MoE block at its published
#: widths on 4 x 128 tokens, bf16 against float32; the bf16 output within
#: 2^-6 of the float32 output's rms (its rms error) and 2^-4 of its
#: largest magnitude (its worst element): one bf16 rounding of each expert
#: hidden element (2^-9 relative) accumulates over f = 32,768 terms like
#: the output itself, so the relative rms error stays ~3·2^-9
GROK_ARCH = "grok-1-314b"
GROK_SMOKE_PROMPT = 32
GROK_SMOKE_NEW = 8
GROK_SMOKE_STEP = (4, 128)
GROK_LAYER_TOKENS = (4, 128)
GROK_LAYER_RMS_TOL = 2.0 ** -6
GROK_LAYER_MAX_TOL = 2.0 ** -4
#: phase 15, the state-space and hybrid families at full width: one wave
#: of 4 prompts of 1,024 tokens (4 SSD chunks of 256; hymba's local caches
#: padded past its window of 1,024, so its decode reads from start > 0),
#: 16 decode steps, a profiled window of 8; trained at train_4k's
#: S = 4,096 and each config's own grad_accum (mamba2 2, hymba 1), 2
#: steps, with a global batch cut from 256 to 2 for each (at 8 each the
#: phase took 149 s on an H100: 13.9 and 12.6 s a step);
#: the SMOKEs card vs CPU
SSM_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
SSM_PROMPT = 1024
SSM_NEW = 17
SSM_WINDOW_STEPS = 8
SSM_TRAIN_BATCH = {"mamba2-2.7b": 2, "hymba-1.5b": 2}
SSM_TRAIN_STEPS = 2
#: the SMOKEs' serving check: (B, prompt, decode steps), and the SMOKE step
SSM_SMOKE_SERVE = (4, 64, 8)
SSM_SMOKE_STEP = (4, 128)
#: the tests' logit tolerances (tests/test_torch_ssm.py): under the
#: reference's initialiser and with the weight matrices scaled by 0.1
SSM_SMOKE_LOGIT_TOL = {1.0: 1e-3, 0.1: 2e-5}
#: phase 16, the encoder-decoder family: whisper-large-v3 at full width
#: (bf16, 32 + 32 layers, 20 heads over 20 KV heads: G = 1) prefilled on
#: one wave of 4 x (1,536 frames + 128 tokens) and decoded 16 steps through
#: model (the serving engine's prefill passes tokens only, as the
#: reference's), a profiled window of 8 steps; 1,536 frames, not the
#: published 1,500, because blockwise_attention's tiles of 512 must divide
#: the frames in both packages; trained at train_4k's S = 4,096 split into
#: 2,048 frames + 2,048 tokens (src/repro/launch/shapes.py:43-47), a
#: global batch of 4 (cut from 256) as 2 micro-batches of 2, 2 steps
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_FRAMES = 1536
ENCDEC_PROMPT = 128
ENCDEC_NEW = 16
ENCDEC_WINDOW_STEPS = 8
ENCDEC_TRAIN_BATCH = 4
ENCDEC_TRAIN_ACCUM = 2
ENCDEC_TRAIN_STEPS = 2
#: the SMOKE card vs CPU: (B, frames = prompt, decode steps), so pad_cache
#: grows the cross cache as in the reference; the SMOKE step (B, S of
#: frames and of tokens); the tolerances of the logits and of every cache
#: leaf, relative to their largest magnitude.  With the weight matrices
#: scaled by 0.1, the tests' (tests/test_torch_encdec.py).  Under the
#: reference's initialiser the SMOKE is chaotic and its spread grows with
#: the prompt and the steps: at this shape a one-ulp nudge of the weights
#: moves the port's own CPU logits by 1.0e-2 and its caches by 1.5e-3
#: (measured on the CPU; the tests' 5e-3 and 2e-3 were measured at B 2,
#: 16 or 32 frames, 4 steps, where that spread is 4.4e-4 and 8.0e-5), so
#: the card is held there at 2e-2 and 3e-3
ENCDEC_SMOKE_SERVE = (4, 64, 8)
ENCDEC_SMOKE_STEP = (4, 64)
ENCDEC_SMOKE_TOL = {1.0: (2e-2, 3e-3), 0.1: (2e-5, 2e-5)}

#: phase 17, the replica split: D-way splits of the Fig. 4 point's first
#: SIDE_EVENTS events onto the one card; the chunked split's chunk and
#: checkpoint period; the fleet and replicas of the run_batched checks
SPLIT_WAYS = (2, 4)
SPLIT_CHUNK = 64
SPLIT_CKPT_EVERY = 3
SPLIT_API_GPUS = 20
SPLIT_API_RUNS = 8
STEADY_HASH_FIELDS = ("ok", "gpu", "aidx", "free_sum", "active", "frag")
#: phase 17, the launch tooling: hymba-1.5b's decode through build_step at
#: its assigned decode_32k (128 x 32,768) and long_500k (1 x 524,288)
#: shapes, ASSIGNED_STEPS steps from pos = S - ASSIGNED_STEPS over a cache
#: drawn at the scale of a SCALE_PROMPT prefill's; prefill_32k's batch cut
#: from 32 to PREFILL_BATCH
ASSIGNED_ARCH = "hymba-1.5b"
ASSIGNED_DECODE = ("decode_32k", "long_500k")
ASSIGNED_STEPS = 4
SCALE_PROMPT = (4, 256)
PREFILL_BATCH = 1
#: victims per replica of the migrate search at M = 100 (min(C, M·S))
C_LIVE = 800
#: fleet sizes of the mfi_delta kernel check (A100-80GB): the paper's
#: M = 100, benchmarks/scheduler_scaling.py's 10^3 and 10^4, and the
#: kernel's cloud scale 10^6; the occupancy fill of scheduler_scaling.py
MFI_DELTA_GPUS = (100, 1_000, 10_000, 1_000_000)
MFI_DELTA_FILL = 0.45
#: the card-resident decision loop: decisions over a fleet of this size,
#: which starts with every GPU holding work (up to this many requests each)
DECISION_GPUS = 10_000
DECISION_STEPS = 1_000
DECISION_PREFILL_TRIES = 8
#: benchmarks/scheduler_scaling.py's fleet sizes, fill and request class
SCALING_GPUS = (100, 1_000, 10_000)
SCALING_PID = 2


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def trace_hash(trace) -> str:
    """SHA-256 over the trace's fields that exist, in field order."""
    h = hashlib.sha256()
    for a in trace:
        if a is not None:
            h.update(a.tobytes())
    return h.hexdigest()


def cuda_ms(fn, iters: int, warm: int = 5) -> float:
    """Mean milliseconds per call by CUDA events over ``iters`` warm calls
    made back to back (what a caller pays, host launch cost included)."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_times(fn, iters: int):
    """Device microseconds by kernel name over ``iters`` calls, from
    ``torch.profiler`` (CUPTI): ``{name: (total_us, launches)}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = (us, e.count)
    return out


def timed(fn, iters: int, kernel=None):
    """``(ms, call_ms, source)``: ``ms`` is the device time per call — of the
    kernels whose name holds ``kernel``, or of every kernel when ``None`` —
    from the profiler, or the CUDA-event time per call where the profiler
    shows no device time; ``call_ms`` is always the CUDA-event time."""
    call_ms = cuda_ms(fn, iters)
    times = device_times(fn, iters)
    us = sum(t for name, (t, _) in times.items() if kernel is None or kernel in name)
    if us > 0:
        return us / iters / 1e3, call_ms, "profiler"
    return call_ms, call_ms, "cuda-events"


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def fleet_state(spec, tables, occ, device):
    """Engine-layout ``(occ, base, free, f)`` of the occupancy ``occ (R, M, S)``
    of ``spec`` (slices a smaller model lacks are zeroed)."""
    import numpy as np
    import torch
    from repro_torch.sim import batched

    midx = np.asarray(spec.model_index)
    occ = np.array(occ, dtype=np.int32)
    for g in range(spec.num_gpus):
        occ[:, g, spec.models[midx[g]].num_mem_slices:] = 0
    occ_t = torch.as_tensor(occ, device=device)
    mi = torch.as_tensor(midx, device=device).long()
    base = torch.einsum("rms,mns->rmn", occ_t.float(), tables.W[mi])
    free = (tables.slices[mi] - occ_t.sum(dim=2, dtype=torch.int32)).contiguous()
    f = batched._frag_from_base(base, free, "blocked", tables.V[mi])
    return occ_t, base.contiguous(), free, f.contiguous()


def random_state(spec, tables, rng, device, runs=None):
    """Engine-layout (occ, base, free, f) of ``runs`` (default ``RUNS``)
    random fills of ``spec``, replica r filled to r / runs."""
    import numpy as np

    runs = RUNS if runs is None else runs
    fill = (np.arange(runs) / runs)[:, None, None]
    occ = rng.random((runs, spec.num_gpus, spec.num_mem_slices)) < fill
    return fleet_state(spec, tables, occ, device)


def single_feasible(spec, tables, pid, rng):
    """An occupancy where each replica r has exactly one feasible anchor for
    class ``pid[r]``: every GPU full but one, which holds everything outside
    one valid anchor's window."""
    import numpy as np

    midx = np.asarray(spec.model_index)
    valid = tables.profile_valid.cpu().numpy()        # (K, P, A)
    masks = tables.profile_masks.cpu().numpy()        # (K, P, A, S)
    occ = np.ones((len(pid), spec.num_gpus, spec.num_mem_slices), np.int32)
    for r, p in enumerate(pid):
        g = rng.choice(np.flatnonzero(valid[midx, p].any(axis=1)))
        j = rng.choice(np.flatnonzero(valid[midx[g], p]))
        occ[r, g] = 1 - masks[midx[g], p, j]
    return occ


def select_cases(device, rng, pid_np):
    """select_from_base's operand sets where ties, masks and the block layout
    decide: empty fleets (every ΔF ties, the flat index decides), full fleets
    (nothing feasible), one feasible anchor per replica, on the homogeneous
    and the four-model fleet; R = 1 and R = 499 (not a multiple of the
    replicas a block takes); M = 33."""
    import numpy as np
    import torch
    from repro_torch.core import mig
    from repro_torch.sim import batched

    cases = {}
    for tag, spec in (("homog", mig.ClusterSpec.homogeneous(mig.A100_80GB, 100)),
                      ("four-model", mig.ClusterSpec.parse(FOUR_MODEL_FLEET))):
        tables = batched.spec_tables(spec, device)
        shape = (RUNS, spec.num_gpus, spec.num_mem_slices)
        for name, occ in (("empty", np.zeros(shape, np.int32)), ("full", np.ones(shape, np.int32)),
                          ("single", single_feasible(spec, tables, pid_np, rng))):
            cases[f"{tag}/{name}"] = (spec, tables, fleet_state(spec, tables, occ, device)[1:],
                                      pid_np)
    spec = mig.ClusterSpec.homogeneous(mig.A100_80GB, 100)
    tables = batched.spec_tables(spec, device)
    state = random_state(spec, tables, rng, device)[1:]
    for runs in (1, 499):
        cases[f"R = {runs}"] = (spec, tables, tuple(t[:runs].contiguous() for t in state),
                                pid_np[:runs])
    spec = mig.ClusterSpec.homogeneous(mig.A100_80GB, 33)
    tables = batched.spec_tables(spec, device)
    cases["M = 33"] = (spec, tables, random_state(spec, tables, rng, device)[1:], pid_np)
    out = {}
    for name, (spec, tables, (base, free, f), pids) in cases.items():
        midx32 = torch.as_tensor(spec.model_index, device=device)
        out[name] = (base, free, f, torch.as_tensor(pids, dtype=torch.int32, device=device),
                     midx32, tables.V, tables.maskwin, tables.profile_rows,
                     tables.profile_valid, tables.profile_anchors, tables.profile_mem)
    return out


def feasible_counts(sargs):
    """Feasible anchors of each replica's request, ``(R,)``."""
    import torch

    base, _, _, pid, midx32, _, _, rows, valid = sargs[:9]
    mi, pi = midx32.long()[None, :], pid.long()[:, None]
    sel = rows[mi, pi].long()
    return ((torch.gather(base, 2, sel) == 0) & valid[mi, pi]).sum(dim=(1, 2))


def pattern_rows(s: int):
    """Every 0/1 occupancy row of ``s`` slices, ``(2^s, s)`` int32."""
    import numpy as np

    return ((np.arange(1 << s)[:, None] >> np.arange(s)) & 1).astype(np.int32)


def pattern_state(spec, tables, device):
    """Engine-layout ``(base, free, f)`` of one replica per demand class on
    ``spec``, whose GPUs of each model hold that model's occupancy patterns
    in order (the fleet has one GPU per pattern)."""
    import numpy as np
    from repro_torch.core import mig

    occ = np.zeros((spec.num_gpus, spec.num_mem_slices), np.int32)
    g = 0
    for model, count in spec.entries:
        pats = pattern_rows(model.num_mem_slices)
        occ[g:g + count, :model.num_mem_slices] = pats[np.arange(count) % len(pats)]
        g += count
    occ = np.broadcast_to(occ, (mig.NUM_PROFILES,) + occ.shape)
    return fleet_state(spec, tables, occ, device)[1:]


def delta_cases(device, rng):
    """delta_from_base's operand sets beyond the main path's, each
    ``(base, free, f, pid, midx, V, maskwin, profile_mem)``: the window
    counts of every occupancy pattern of each device model, one replica per
    demand class, on a homogeneous fleet of each model and on the four-model
    fleet (the kernel's bit path); the A100-80GB patterns with negative
    counts, and with tables outside the bit form: window sizes halved, sizes
    one below their slice count, N > 32 by repeating the windows, a negative
    anchor count (its count path, or its bit path on sizes that are not
    slice counts); R = 1 at M = 10,000 and R = 7 at M = 333 (GPU runs that
    are not a multiple of the block)."""
    import torch
    from repro_torch.core import mig
    from repro_torch.sim import batched

    def operands(spec, tables, state, pid):
        midx32 = torch.as_tensor(spec.model_index, device=device)
        return tuple(state) + (pid, midx32, tables.V, tables.maskwin, tables.profile_mem)

    pid = torch.arange(mig.NUM_PROFILES, dtype=torch.int32, device=device)
    fleets = {m.name: f"{m.name}:{1 << m.num_mem_slices}" for m in mig.DEVICE_MODELS.values()}
    fleets["four-model"] = ",".join(
        f"{m.name}:256" for m in (mig.A100_80GB, mig.A100_40GB, mig.H100_96GB, mig.H100_80GB))
    cases = {}
    for tag, text in sorted(fleets.items()):
        spec = mig.ClusterSpec.parse(text)
        tables = batched.spec_tables(spec, device)
        cases[f"{tag}/all patterns"] = operands(spec, tables, pattern_state(spec, tables, device), pid)
    base, free, f, pid, midx32, V, maskwin, mem = cases[f"{mig.A100_80GB.name}/all patterns"]
    negative = base.clone()
    negative[:, ::5, 2] = -1.0
    bad_anchor = maskwin.clone()
    bad_anchor[:, :, 0, 0] = -1.0
    cases["negative counts"] = (negative, free, f, pid, midx32, V, maskwin, mem)
    cases["window sizes halved"] = (base, free, f, pid, midx32, V / 2, maskwin, mem)
    cases["sizes one below the slice count"] = (base, free, f, pid, midx32,
                                                (V - 1).clamp(min=0), maskwin, mem)
    cases["N > 32 (windows repeated)"] = (torch.cat([base, base], -1).contiguous(), free, f, pid,
                                          midx32, torch.cat([V, V], -1).contiguous(),
                                          torch.cat([maskwin, maskwin], -1).contiguous(), mem)
    cases["a negative anchor count"] = (base, free, f, pid, midx32, V, bad_anchor, mem)
    for runs, m in ((1, 10_000), (7, 333)):
        spec = mig.ClusterSpec.homogeneous(mig.A100_80GB, m)
        tables = batched.spec_tables(spec, device)
        occ = rng.random((runs, m, spec.num_mem_slices)) < MFI_DELTA_FILL
        cases[f"R = {runs}, M = {m}"] = operands(
            spec, tables, fleet_state(spec, tables, occ, device)[1:],
            torch.arange(runs, dtype=torch.int32, device=device) % mig.NUM_PROFILES)
    return cases


def kernel_phase(device):
    import numpy as np
    import torch
    from repro_torch.core import mig
    from repro_torch.core.policy import resolve
    from repro_torch.kernels.fragscore import fragscore as K
    from repro_torch.kernels.fragscore import ref
    from repro_torch.sim import batched

    rng = np.random.default_rng(0)
    homog = mig.ClusterSpec.homogeneous(mig.A100_80GB, 100)
    four = mig.ClusterSpec.parse(FOUR_MODEL_FLEET)
    pid = torch.as_tensor(np.arange(RUNS) % mig.NUM_PROFILES, dtype=torch.int32, device=device)
    rows = {}

    # fragscore: the expire rows (R·E) and the commit rows (R) of the main path
    occ, _, _, _ = random_state(homog, batched.spec_tables(homog, device), rng, device)
    w = torch.tensor(mig.A100_80GB.placement_masks, dtype=torch.float32, device=device)
    v = torch.tensor(mig.A100_80GB.placement_mem, dtype=torch.float32, device=device)
    expire_rows = occ[:, :12].reshape(-1, occ.shape[-1]).contiguous()  # E = 12 ring columns
    err = 0.0
    for metric in ("blocked", "partial"):
        for x in (expire_rows, occ[:, 0].contiguous()):
            got = K.fragscore(x, w, v, metric=metric)
            want = ref.fragscore_ref(x, w, v, metric)
            check(torch.equal(got, want), f"fragscore/{metric}/{tuple(x.shape)} differs from its plain version")
            err = max(err, float((got - want).abs().max()))
    # every occupancy pattern of every device model (the kernel's bit path),
    # rows with entries outside {0, 1} (its count path), each twice
    models = {m.name: m for m in mig.DEVICE_MODELS.values()}
    for name, model in sorted(models.items()):
        sm = model.num_mem_slices
        pats = pattern_rows(sm)
        odd = rng.integers(-2, 4, (256, sm))
        wm = torch.tensor(model.placement_masks, dtype=torch.float32, device=device)
        vm = torch.tensor(model.placement_mem, dtype=torch.float32, device=device)
        for metric in ("blocked", "partial"):
            for tag, rows_np in (("all patterns", pats), ("entries outside {0, 1}", odd)):
                xm = torch.as_tensor(rows_np.astype(np.int32), device=device)
                got = K.fragscore(xm, wm, vm, metric=metric)
                check(torch.equal(got, ref.fragscore_ref(xm, wm, vm, metric)),
                      f"fragscore/{name}/{metric}/{tag} differs from its plain version")
                check(torch.equal(got, K.fragscore(xm, wm, vm, metric=metric)),
                      f"fragscore/{name}/{metric}/{tag}: two calls differ")
    log(f"kernel fragscore: equal to plain on all 2^S patterns of {sorted(models)} and on rows "
        "with entries outside {0, 1}, both metrics; the same bits on two calls")
    x = expire_rows
    ms, call_ms, src = timed(lambda: K.fragscore(x, w, v), 200, "fragscore_kernel")
    plain_ms, plain_call_ms, _ = timed(lambda: ref.fragscore_ref(x, w, v), 50)
    q, s = x.shape
    n = w.shape[0]
    b_ms, b_by = bound(nbytes(x, w, v) + 4 * q, 2 * q * n * s + 3 * q * n)
    rows["fragscore"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, call_ms=call_ms, plain_call_ms=plain_call_ms,
                             ms_source=src, shape=f"occ ({q}, {s})")
    log(f"kernel fragscore: equal to plain (both metrics, {q} and {RUNS} rows); "
        f"device {ms:.5f} ms ({src}), per call {call_ms:.4f} ms; plain device "
        f"{plain_ms:.5f} ms, per call {plain_call_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")

    # delta_from_base and select_from_base on homogeneous and four-model tables
    err_d = err_s = 0.0
    timing = {}
    for tag, spec in (("homog", homog), ("four-model", four)):
        tables = batched.spec_tables(spec, device)
        midx32 = torch.as_tensor(spec.model_index, device=device)
        _, base, free, f = random_state(spec, tables, rng, device)
        dargs = (base, free, f, pid, midx32, tables.V, tables.maskwin, tables.profile_mem)
        sargs = (base, free, f, pid, midx32, tables.V, tables.maskwin, tables.profile_rows,
                 tables.profile_valid, tables.profile_anchors, tables.profile_mem)
        for metric in ("blocked", "partial"):
            got = K.delta_from_base(*dargs, metric=metric)
            want = ref.delta_from_base_ref(*dargs, metric)
            check(torch.equal(got, want), f"delta_from_base/{tag}/{metric} differs from its plain version")
            err_d = max(err_d, float((got - want).abs().max()))
            for policy in ("mfi", "ff", "bf-bi", "wf-bi"):
                keys = batched._effective_keys(resolve(policy))
                got = K.select_from_base(*sargs, keys=keys, metric=metric)
                want = ref.select_from_base_ref(*sargs, keys, metric)
                for g, wv in zip(got, want):
                    check(torch.equal(g.long(), wv.long()),
                          f"select_from_base/{tag}/{metric}/{policy} differs from its plain version")
                    err_s = max(err_s, float((g.long() - wv.long()).abs().max()))
                again = K.select_from_base(*sargs, keys=keys, metric=metric)
                check(all(torch.equal(g, h) for g, h in zip(got, again)),
                      f"select_from_base/{tag}/{metric}/{policy}: two calls differ")
        if tag == "homog":
            r, m, nn = base.shape
            a = tables.maskwin.shape[2]
            mfi_keys = batched._effective_keys(resolve("mfi"))
            timing["delta_from_base"] = (
                timed(lambda: K.delta_from_base(*dargs), 200, "delta_from_base_kernel"),
                timed(lambda: ref.delta_from_base_ref(*dargs), 50),
                dargs,
            )
            timing["select_from_base"] = (
                timed(lambda: K.select_from_base(*sargs, keys=mfi_keys), 200,
                      "select_from_base_kernel"),
                timed(lambda: ref.select_from_base_ref(*sargs, mfi_keys), 50),
                sargs,
            )
            rows_sel = tables.profile_rows[midx32.long()[None, :], pid.long()[:, None]].long()
            feasible = int(((torch.gather(base, 2, rows_sel) == 0)
                            & tables.profile_valid[midx32.long()[None, :], pid.long()[:, None]]).sum())
    pid_np = pid.cpu().numpy()
    for tag, sargs in select_cases(device, rng, pid_np).items():
        feasible_n = feasible_counts(sargs)
        if tag.endswith("/full"):
            check(int(feasible_n.max()) == 0, f"select case {tag}: a feasible anchor")
        if tag.endswith("/single"):
            check(bool((feasible_n == 1).all()), f"select case {tag}: not one feasible anchor each")
        for metric in ("blocked", "partial"):
            for policy in ("mfi", "ff", "bf-bi", "wf-bi"):
                keys = batched._effective_keys(resolve(policy))
                got = K.select_from_base(*sargs, keys=keys, metric=metric)
                want = ref.select_from_base_ref(*sargs, keys, metric)
                again = K.select_from_base(*sargs, keys=keys, metric=metric)
                for g, wv, h in zip(got, want, again):
                    check(torch.equal(g.long(), wv.long()),
                          f"select_from_base/{tag}/{metric}/{policy} differs from its plain version")
                    check(torch.equal(g, h), f"select_from_base/{tag}/{metric}/{policy}: two calls differ")
                if tag.endswith("/full"):
                    check(not bool(got[2].any()) and not bool(got[0].any()) and not bool(got[1].any()),
                          f"select_from_base/{tag}/{metric}/{policy}: not (0, 0, false)")
    log("kernel select_from_base: equal to plain and the same bits on two calls on "
        "empty, full and one-feasible fleets (homog, four-model), R = 1, R = 499, M = 33, "
        "both metrics, mfi/ff/bf-bi/wf-bi keys")
    cases = delta_cases(device, rng)
    for tag, dargs_c in cases.items():
        for metric in ("blocked", "partial"):
            got = K.delta_from_base(*dargs_c, metric=metric)
            check(torch.equal(got, ref.delta_from_base_ref(*dargs_c, metric)),
                  f"delta_from_base/{tag}/{metric} differs from its plain version")
            check(torch.equal(got, K.delta_from_base(*dargs_c, metric=metric)),
                  f"delta_from_base/{tag}/{metric}: two calls differ")
    log(f"kernel delta_from_base: equal to plain and the same bits on two calls, both "
        f"metrics, on {'; '.join(cases)}")
    (ms, call_ms, src), (plain_ms, plain_call_ms, _), dargs = timing["delta_from_base"]
    b_ms, b_by = bound(nbytes(*dargs) + 4 * r * m * a, 2 * r * m * nn * (a + 1))
    rows["delta_from_base"] = dict(max_abs_err=err_d, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, call_ms=call_ms, plain_call_ms=plain_call_ms,
                                   ms_source=src, shape=f"base ({r}, {m}, {nn})")
    log(f"kernel delta_from_base: equal to plain (homog + four-model, both metrics); "
        f"device {ms:.5f} ms ({src}), per call {call_ms:.4f} ms; plain device "
        f"{plain_ms:.5f} ms, per call {plain_call_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    (ms, call_ms, src), (plain_ms, plain_call_ms, _), sargs = timing["select_from_base"]
    # data-dependent work: the occupied sum of every row, the cross term and
    # three key comparisons of each feasible anchor
    ops = 2 * r * m * nn + feasible * (2 * nn + 3)
    b_ms, b_by = bound(nbytes(*sargs) + 9 * r, ops)
    rows["select_from_base"] = dict(max_abs_err=err_s, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, call_ms=call_ms, plain_call_ms=plain_call_ms,
                                    ms_source=src,
                                    shape=f"base ({r}, {m}, {nn}), {feasible} feasible")
    log(f"kernel select_from_base: equal to plain (homog + four-model, both metrics, "
        f"mfi/ff/bf-bi/wf-bi keys); device {ms:.5f} ms ({src}), per call {call_ms:.4f} ms; "
        f"plain device {plain_ms:.5f} ms, per call {plain_call_ms:.4f} ms; "
        f"bound {b_ms:.6f} ms ({b_by})")
    rows["migrate_refine"] = migrate_kernel_phase(device, rng, homog, four)
    return rows


def victims(spec, tables, rng, device):
    """``C_LIVE`` random victims per replica: each one's GPU, class, model
    and a patched row (a random fill of a GPU of its model)."""
    import numpy as np
    import torch

    _, base_b, free_b, f_b = random_state(spec, tables, rng, device)
    rg = torch.as_tensor(rng.integers(0, spec.num_gpus, (RUNS, C_LIVE)), device=device)
    rp = torch.as_tensor(rng.integers(0, 6, (RUNS, C_LIVE)), dtype=torch.int32, device=device)
    kc = torch.as_tensor(np.asarray(spec.model_index), device=device)[rg].to(torch.int32)
    ri = torch.arange(RUNS, device=device)[:, None]
    return (base_b[ri, rg].contiguous(), free_b[ri, rg].contiguous(), f_b[ri, rg].contiguous(),
            rg.to(torch.int32).contiguous(), rp, kc.contiguous())


def migrate_kernel_phase(device, rng, homog, four):
    import torch
    from repro_torch.core import mig
    from repro_torch.core.policy import PolicySpec, resolve
    from repro_torch.kernels.fragscore import fragscore as K
    from repro_torch.kernels.fragscore import ref
    from repro_torch.sim import batched

    key_sets = {
        "mfi-defrag": batched._effective_keys(resolve("mfi-defrag")),
        "bf-bi-keyed defrag": batched._effective_keys(PolicySpec(
            name="bf-bi-defrag", keys=("free-slices", "gpu", "-anchor"), defrag=True)),
    }
    err = 0.0
    for tag, spec in (("homog", homog), ("four-model", four)):
        tables = batched.spec_tables(spec, device)
        midx32 = torch.as_tensor(spec.model_index, device=device)
        _, base, free, f = random_state(spec, tables, rng, device)
        margs = (base, free, f) + victims(spec, tables, rng, device) + (
            midx32, tables.V, tables.maskwin, tables.profile_rows, tables.profile_valid,
            tables.profile_anchors, tables.profile_mem)
        for metric in ("blocked", "partial"):
            for kname, keys in key_sets.items():
                got = K.migrate_refine(*margs, keys=keys, metric=metric)
                want = ref.migrate_refine_ref(*margs, keys, metric)
                for i, (g, w) in enumerate(zip(got, want)):
                    check(g.dtype == w.dtype and torch.equal(g, w),
                          f"migrate_refine/{tag}/{metric}/{kname}: output {i} differs "
                          "from its plain version")
                    err = max(err, float((g.double() - w.double()).abs().max()))
        if tag == "homog":
            hargs, hkeys = margs, key_sets["mfi-defrag"]
    torch.cuda.synchronize()
    ms, call_ms, src = timed(lambda: K.migrate_refine(*hargs, keys=hkeys), 200,
                             "migrate_refine_kernel")
    plain_ms, plain_call_ms, _ = timed(lambda: ref.migrate_refine_ref(*hargs, hkeys), 10)
    # pass 0 alone: the same call with no victims (C = 0); pass 1 by difference
    no_victims = tuple(t[:, :0].contiguous() for t in hargs[3:9])
    pass0_args = hargs[:3] + no_victims + hargs[9:]
    pass0_ms, _, _ = timed(lambda: K.migrate_refine(*pass0_args, keys=hkeys), 200,
                           "migrate_refine_kernel")
    outs = K.migrate_refine(*hargs, keys=hkeys)
    base, _, _, base2, _, _, _, rp, kc, midx32 = hargs[:10]
    tables = batched.spec_tables(homog, device)
    r, m, nn = base.shape
    c, a = base2.shape[1], tables.maskwin.shape[2]
    # data-dependent work: each row's occupied sum, then the cross term and
    # the key comparisons of every feasible anchor (pass 0 over every class,
    # pass 1 over each victim's class, plus its column-0 fallback)
    mi = midx32.long()
    feas0 = sum(
        int(((torch.gather(base, 2, tables.profile_rows[mi, p].long()[None].expand(r, -1, -1))
              == 0) & tables.profile_valid[mi, p]).sum())
        for p in range(mig.NUM_PROFILES))
    kl, pl = kc.long(), rp.long()
    feas1 = int(((torch.gather(base2, 2, tables.profile_rows[kl, pl].long()) == 0)
                 & tables.profile_valid[kl, pl]).sum())
    per_anchor = 2 * nn + 2 * len(hkeys)
    ops = (2 * nn * (r * mig.NUM_PROFILES * m + r * c)
           + per_anchor * (feas0 + feas1 + r * c))
    b_ms, b_by = bound(nbytes(*hargs) + nbytes(*outs), ops)
    log(f"kernel migrate_refine: equal to plain (homog + four-model, both metrics, "
        f"mfi-defrag and bf-bi-keyed defrag keys, C_live = {c}); device {ms:.5f} ms ({src}), "
        f"per call {call_ms:.4f} ms; plain device {plain_ms:.5f} ms, per call "
        f"{plain_call_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by}, "
        f"{nbytes(*hargs) + nbytes(*outs)} bytes, {ops} ops); pass 0 alone (C = 0) "
        f"{pass0_ms:.5f} ms, pass 1 by difference {ms - pass0_ms:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                pass0_ms=pass0_ms, pass1_ms=ms - pass0_ms,
                call_ms=call_ms, plain_call_ms=plain_call_ms, ms_source=src,
                shape=f"base ({r}, {m}, {nn}), base2 ({r}, {c}, {nn}), A = {a}")


# ---------------------------------------------------------------------------
# phase 4: the reference's pinned results, kernels on
# ---------------------------------------------------------------------------


def golden_phase(device):
    import torch
    from repro_torch.core import mig
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig

    mixed = mig.ClusterSpec(((mig.A100_80GB, 3), (mig.A100_40GB, 3)))
    four = mig.ClusterSpec(((mig.A100_80GB, 2), (mig.A100_40GB, 2),
                            (mig.H100_96GB, 2), (mig.H100_80GB, 2)))

    def traced(policy, cfg, runs, spec=None):
        events, _, rr, rc = batched.presample_arrivals(cfg, runs)
        spec = spec or cfg.spec()
        _, trace = batched._simulate(
            events, policy=policy, metric=cfg.metric, num_gpus=cfg.num_gpus,
            ring_rows=rr, ring_cols=rc, use_kernel=True, kernel_spec=spec,
            midx=torch.as_tensor(spec.model_index, device=device),
            tables=batched.spec_tables(spec, device), device=device,
        )
        return events, batched.trace_to_numpy(trace)

    for tag, cfg in (("homog", SimConfig(num_gpus=5, offered_load=1.1, seed=7)),
                     ("mixed", SimConfig(cluster_spec=mixed, offered_load=1.0, seed=9))):
        got = trace_hash(traced("mfi", cfg, 3)[1])
        check(got == GOLDEN_TRACE_HASHES[tag], f"golden trace hash {tag}: {got}")
    configs = {
        "homog_m6": SimConfig(num_gpus=6, offered_load=0.9, seed=12),
        "mixed_k2": SimConfig(cluster_spec=mixed, offered_load=0.9, seed=12),
        "four_k4": SimConfig(cluster_spec=four, offered_load=0.85, seed=3),
    }
    for (tag, policy), want in GOLDEN_AGGREGATES.items():
        r = batched.run_batched(policy, configs[tag], runs=4, use_kernel=True, device=device)
        for key, value in want.items():
            check(r[key] == value, f"golden aggregate {tag}/{policy}/{key}: {r[key]!r} != {value!r}")
    full = SimConfig(num_gpus=100, offered_load=1.0, seed=0)
    got = trace_hash(traced("mfi", full, 8)[1])
    check(got == FULL_WIDTH_HASH, f"full-width hash: {got}")
    from repro_torch.kernels.fragscore import fragscore as K

    before = K.migrate_refine.launches
    _, trace = traced("mfi-defrag", full, 8)
    check(trace.mig.sum() > 0, "full-width mfi-defrag trace: no migration")
    got = trace_hash(trace)
    check(got == DEFRAG_FULL_WIDTH_HASH, f"full-width mfi-defrag hash: {got}")
    mixed_cfg = SimConfig(cluster_spec=mig.ClusterSpec.parse(DEFRAG_MIXED_FLEET),
                          offered_load=1.0, seed=3)
    _, trace = traced("mfi-defrag", mixed_cfg, 4)
    check(trace.mig.sum() > 0, "mixed-fleet mfi-defrag trace: no migration")
    got = trace_hash(trace)
    check(got == DEFRAG_MIXED_HASH, f"mixed-fleet mfi-defrag hash: {got}")
    check(K.migrate_refine.launches > before, "the defrag goldens did not launch migrate_refine")
    log("golden: 2 trace hashes, 3 aggregates, the full-width hash (M=100, runs=8) and "
        "the two mfi-defrag hashes (M=100 runs=8; mixed fleet with H200) reproduced "
        "with the kernels on")


# ---------------------------------------------------------------------------
# phase 5: the paper's experiment at full width
# ---------------------------------------------------------------------------


#: mfi's keys through the ΔF-table lowering, so that the engine runs
#: delta_from_base (the lowering of every ΔF spec whose argmin is not fused)
DELTA_ONLY = dict(name="mfi-delta-only", keys=("frag-delta", "gpu", "anchor"),
                  kernel_lowering="delta")


def paper_stream(device):
    """The paper's Fig. 4 heavy-load point (M = 100 A100-80GB, uniform mix,
    offered load 1.0, seed 0): its config, its presampled stream of ``RUNS``
    replicas and the engine's keyword arguments on ``device``."""
    import torch
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig

    cfg = SimConfig(num_gpus=100, offered_load=1.0, seed=0)
    spec = cfg.spec()
    t0 = time.perf_counter()
    events, _, ring_rows, ring_cols = batched.presample_arrivals(cfg, RUNS)
    log(f"full width: presampled (E_max, R) = {events.pid.shape}, "
        f"{int((events.pid >= 0).sum())} arrivals, ring {ring_rows} x {ring_cols}, "
        f"{time.perf_counter() - t0:.2f} s")
    common = dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=ring_rows,
                  ring_cols=ring_cols, kernel_spec=spec,
                  midx=torch.as_tensor(spec.model_index, device=device),
                  tables=batched.spec_tables(spec, device), device=device)
    return cfg, spec, events, common


def engine_windows(device, events, common, policies, n=WINDOW_EVENTS, label=""):
    """Where the device time goes: the first ``n`` events of each policy's
    step, kernel and plain, profiled, and the same window's wall time
    without the profiler, the kernel path's event loop under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync fails it).
    Returns ``{(name, path): {busy_ms, wall_ms, ops_per_event}}``."""
    import torch
    from repro_torch.sim import batched

    window = batched.EventStream(*[None if a is None else a[:n] for a in events])
    out = {}
    for policy, use_kernel in itertools.product(policies, (True, False)):
        name = policy if isinstance(policy, str) else policy.name

        def run():
            return batched._simulate(window, policy=policy, use_kernel=use_kernel, **common)

        times = device_times(run, 1)
        t0 = time.perf_counter()
        loop = batched._setup_run(window, policy=policy, use_kernel=use_kernel, **common)
        if use_kernel:  # sim/batched.py's claim: nothing in the loop waits for the device
            torch.cuda.set_sync_debug_mode("error")
        try:
            batched._event_loop(*loop)
        except RuntimeError as e:
            check(False, f"engine window {name}: a host sync inside the event loop: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(t for t, _ in times.values()) / 1e3
        launches = sum(c for _, c in times.values())
        path = "kernel" if use_kernel else "plain"
        out[(name, path)] = dict(busy_ms=busy_ms, wall_ms=wall_ms, ops_per_event=launches / n)
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:4]
        log(f"engine window {label}{name} {path} "
            f"({n} events, R={events.pid.shape[1]}): "
            f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
            f"({100 * busy_ms / wall_ms:.1f}% busy), {launches / n:.1f} device ops/event"
            + ("; no host sync in the loop (set_sync_debug_mode error)" if use_kernel else "")
            + "; top: "
            + "; ".join(f"{k[:48]} {t / c:.1f} us x{c}" for k, (t, c) in top))
    return out


def full_width_phase(device):
    import numpy as np
    import torch
    from repro_torch.core.policy import PolicySpec
    from repro_torch.kernels.fragscore import fragscore as K
    from repro_torch.sim import batched

    wrappers = {"fragscore": K.fragscore, "delta_from_base": K.delta_from_base,
                "select_from_base": K.select_from_base, "migrate_refine": K.migrate_refine}
    totals = dict.fromkeys(wrappers, 0)
    _, spec, events, common = paper_stream(device)
    e_max = events.pid.shape[0]
    delta_only = PolicySpec(**DELTA_ONLY)
    warm = batched.EventStream(*[None if a is None else a[:64] for a in events])
    head = batched.EventStream(*[None if a is None else a[:PLAIN_EVENTS] for a in events])
    side = batched.EventStream(*[None if a is None else a[:SIDE_EVENTS] for a in events])
    rates = {}
    for policy in ("mfi", "ff", "bf-bi", "wf-bi", "rr", delta_only, "mfi-defrag"):
        name = policy if isinstance(policy, str) else policy.name
        # mfi takes the whole stream, the other policies its first
        # SIDE_EVENTS events (Fig. 5 runs them over whole streams)
        run = events if name == "mfi" else side
        n = run.pid.shape[0]
        out = {}
        for use_kernel in (True, False):
            batched._simulate(warm, policy=policy, use_kernel=use_kernel, **common)
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            _, trace = batched._simulate(run if use_kernel else head, policy=policy,
                                         use_kernel=use_kernel, **common)
            trace = batched.trace_to_numpy(trace)
            seconds = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in wrappers.items()}
            out[use_kernel] = (trace, seconds, counts)
        (tk, sk, ck), (tp, sp, cp) = out[True], out[False]
        for field in batched.EventTrace._fields:
            a, b = getattr(tk, field), getattr(tp, field)
            check((a is None) == (b is None)
                  and (a is None or np.array_equal(a[:PLAIN_EVENTS], b)),
                  f"{name}: kernel and plain traces differ in {field}")
        check(sum(cp.values()) == 0, f"{name}: the plain path launched kernels {cp}")
        defrag = name == "mfi-defrag"
        # fragscore: the expire and commit rescores, plus the rescore of a
        # migrated victim's landing GPU for defrag
        want = {"fragscore": (3 if defrag else 2) * n,
                "select_from_base": n if name in ("mfi", "ff", "bf-bi", "wf-bi",
                                                  "mfi-defrag") else 0,
                "delta_from_base": n if name == "mfi-delta-only" else 0,
                "migrate_refine": n if defrag else 0}
        check(ck == want, f"{name}: launch counts {ck} != expected {want}")
        for k in totals:
            totals[k] += ck[k]
        rates[name] = (RUNS * n / sk, RUNS * PLAIN_EVENTS / sp)
        if defrag:
            log(f"full width mfi-defrag: {int(tk.mig.sum())} migrations over "
                f"{RUNS} replicas")
        summary = "no aggregates (a prefix of the stream)"
        if n == e_max:
            agg = batched.aggregate(run, tk, spec, RUNS)
            summary = (f"acceptance {agg['acceptance_rate']:.4f} allocated "
                       f"{agg['allocated_workloads']:.1f} utilization {agg['utilization']:.4f} "
                       f"active {agg['active_gpus']:.1f} frag {agg['frag_severity']:.2f}")
        log(f"full width {name}: kernel path over {n} of {e_max} events; traces equal "
            f"(kernel vs plain over the first {PLAIN_EVENTS} events); launches {ck}; "
            f"{summary}; replica-events/s kernel {rates[name][0]:.0f} "
            f"plain {rates[name][1]:.0f} ({sk:.2f} s / {sp:.2f} s)")
        if name == "mfi":
            row = (f"fig4,mfi,1.0,{agg['acceptance_rate']:.4f},{agg['allocated_workloads']:.1f},"
                   f"{agg['utilization']:.4f},{agg['active_gpus']:.1f},{agg['frag_severity']:.2f}")
            log(f"fig4 mfi row this run: {row}; recorded: {RECORDED_FIG4_MFI}; "
                f"{'same' if row == RECORDED_FIG4_MFI else 'differs'}")
    for k in totals:
        check(totals[k] > 0, f"{k} never launched on the main path")

    engine_windows(device, events, common, ("mfi", delta_only, "mfi-defrag"))
    return totals, rates


def fig5_phase(device, wrappers):
    """The paper's Fig. 5 through the kernels: its 20 points (five
    policies, the four Table-II mixes, M = 100 A100-80GB, load 0.85, seed
    0, R = ``RUNS``), each printed beside its row of the recorded run (not
    asserted) with its replica-events/s; launch counts reset just before
    each point and read just after."""
    import torch
    from repro_torch.sim import batched
    from repro_torch.sim.distributions import DISTRIBUTIONS
    from repro_torch.sim.simulator import SimConfig

    recorded = {tuple(line.split(",")[1:3]): line
                for line in (ROOT / FIG5_CSV).read_text().splitlines()
                if line.startswith("fig5,")}
    totals = dict.fromkeys(wrappers, 0)
    points = {}
    for dist in DISTRIBUTIONS:
        cfg = SimConfig(num_gpus=100, distribution=dist, offered_load=FIG5_LOAD, seed=0)
        spec = cfg.spec()
        events, _, ring_rows, ring_cols = batched.presample_arrivals(cfg, RUNS)
        e_max = events.pid.shape[0]
        common = dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=ring_rows,
                      ring_cols=ring_cols, kernel_spec=spec,
                      midx=torch.as_tensor(spec.model_index, device=device),
                      tables=batched.spec_tables(spec, device), device=device)
        for policy in FIG5_POLICIES:
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            _, trace = batched._simulate(events, policy=policy, use_kernel=True, **common)
            trace = batched.trace_to_numpy(trace)
            seconds = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in wrappers.items()}
            want = dict.fromkeys(wrappers, 0)
            want["fragscore"] = 2 * e_max
            want["select_from_base"] = 0 if policy == "rr" else e_max
            check(counts == want, f"fig5 {policy} {dist}: launch counts {counts} != {want}")
            for k in totals:
                totals[k] += counts[k]
            agg = batched.aggregate(events, trace, spec, RUNS)
            row = (f"fig5,{policy},{dist},{agg['acceptance_rate']:.4f},"
                   f"{agg['allocated_workloads']:.1f},{agg['utilization']:.4f},"
                   f"{agg['active_gpus']:.1f},{agg['frag_severity']:.2f}")
            rec = recorded.get((policy, dist))
            rate = RUNS * e_max / seconds
            points[f"{policy}/{dist}"] = dict(row=row, recorded=rec, same=row == rec,
                                              replica_events_per_s=rate, e_max=e_max)
            log(f"fig5 {policy} {dist}: this run {row}; recorded {rec}; "
                f"{'same' if row == rec else 'differs'}; replica-events/s {rate:.0f} "
                f"(E_max {e_max}, {seconds:.2f} s, kernels)")
    check(len(points) == 20, f"fig5: {len(points)} points")
    same = sum(p["same"] for p in points.values())
    log(f"fig5: {same} of {len(points)} points print the recorded row "
        f"({FIG5_CSV}); launches {totals}")
    return points, totals


# ---------------------------------------------------------------------------
# phase 10: the cumulative and queued protocols
# ---------------------------------------------------------------------------


def loop_run(name, events, policy, use_kernel, common, wrappers):
    """One engine run over ``events``, launch counts reset just before and
    read just after; the kernel path's event loop runs under
    ``torch.cuda.set_sync_debug_mode("error")``.  Returns ``(trace,
    seconds, counts, peak)``, the trace fetched to the host and ``peak``
    the device memory the run allocated at most over what it started
    with (bytes)."""
    import torch
    from repro_torch.sim import batched

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = batched._setup_run(events, policy=policy, use_kernel=use_kernel, **common)
    if use_kernel:
        torch.cuda.set_sync_debug_mode("error")
    try:
        batched._event_loop(*loop)
    except RuntimeError as e:
        check(False, f"{name}: a host sync inside the event loop: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    trace = batched.trace_to_numpy(loop[3])
    seconds = time.perf_counter() - t0
    return (trace, seconds, {k: fn.launches for k, fn in wrappers.items()},
            torch.cuda.max_memory_allocated() - base)


def paths_equal(name, events, policy, common, wrappers, want, plain_events=None):
    """The kernel path (warm, no host sync in its loop) over ``events`` and
    the plain path over the same events, or their first ``plain_events``:
    every trace field equal there, the kernel path's launch counts
    ``want`` and the plain path's none.  Returns ``(kernel trace, plain
    trace, (kernel, plain) replica-events/s, counts, the kernel run's
    (seconds, peak memory in bytes))``."""
    import numpy as np
    import torch
    from repro_torch.sim import batched

    warm = batched.EventStream(*[None if a is None else a[:32] for a in events])
    for use_kernel in (True, False):
        batched._simulate(warm, policy=policy, use_kernel=use_kernel, **common)
    torch.cuda.synchronize()
    e_max, runs = events.pid.shape
    n = min(e_max, plain_events or e_max)
    head = batched.EventStream(*[None if a is None else a[:n] for a in events])
    tk, sk, ck, peak = loop_run(name, events, policy, True, common, wrappers)
    tp, sp, cp, _ = loop_run(name, head, policy, False, common, wrappers)
    for field in batched.EventTrace._fields:
        a, b = getattr(tk, field), getattr(tp, field)
        check((a is None) == (b is None) and (a is None or np.array_equal(a[:n], b)),
              f"{name}: kernel and plain traces differ in {field}")
    check(sum(cp.values()) == 0, f"{name}: the plain path launched kernels {cp}")
    check(ck == want, f"{name}: launch counts {ck} != expected {want}")
    return tk, tp, (runs * e_max / sk, runs * n / sp), ck, (sk, peak)


def dicts_equal(a, b) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(
        dicts_equal(a[k], b[k]) if isinstance(a[k], dict) else np.array_equal(a[k], b[k])
        for k in a)


def host_anchors(spec, pid, gpu, aidx):
    """Anchor values of a trace's accepted decisions (``-1`` elsewhere)."""
    import numpy as np

    out = np.full(pid.shape, -1, np.int32)
    for e, r in zip(*np.nonzero(gpu >= 0)):
        out[e, r] = spec.model_of(int(gpu[e, r])).profiles[int(pid[e, r])].anchors[
            int(aidx[e, r])]
    return out


def cumulative_phase(device, wrappers, totals):
    """The cumulative protocol at the paper's fleet (M = 100 A100-80GB,
    uniform mix, seed 0, R = ``RUNS``) for mfi, ff and mfi-defrag: kernel
    path equal to the plain path (trace and aggregates), and at R =
    ``HOST_RUNS_CUMULATIVE`` the card's decisions equal to the host
    schedulers' and its aggregates to the host engine's ``run_many``."""
    import numpy as np
    import torch
    from repro_torch.sim import batched, replay
    from repro_torch.sim.simulator import SimConfig, run_many

    cfg = SimConfig(num_gpus=100, seed=0, protocol="cumulative")
    spec = cfg.spec()
    out = {}

    def common_of(rows, cols):
        return dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=rows,
                    ring_cols=cols, kernel_spec=spec, protocol="cumulative",
                    midx=torch.as_tensor(spec.model_index, device=device),
                    tables=batched.spec_tables(spec, device), device=device)

    events, _, rows, cols = batched.presample_cumulative(cfg, RUNS)
    common = common_of(rows, cols)
    small, small_meta, s_rows, s_cols = batched.presample_cumulative(cfg, HOST_RUNS_CUMULATIVE)
    e_max = events.pid.shape[0]
    for policy in ("mfi", "ff", "mfi-defrag"):
        defrag = policy == "mfi-defrag"
        want = dict.fromkeys(wrappers, 0)
        want.update(fragscore=(3 if defrag else 2) * e_max, select_from_base=e_max,
                    migrate_refine=e_max if defrag else 0)
        name = f"cumulative {policy}"
        tk, tp, rates, ck, _ = paths_equal(name, events, policy, common, wrappers, want)
        for k in totals:
            totals[k] += ck[k]
        agg = batched._aggregate_cumulative(events, tk, spec, RUNS, cfg)
        check(dicts_equal(agg, batched._aggregate_cumulative(events, tp, spec, RUNS, cfg)),
              f"{name}: kernel and plain aggregates differ")

        # R = 8: the card's decisions against the host schedulers, its
        # aggregates against the host engine
        _, t8 = batched._simulate(small, policy=policy, use_kernel=True,
                                  **common_of(s_rows, s_cols))
        t8 = batched.trace_to_numpy(t8)
        host = replay.host_decisions_full(
            small, small_meta, policy, cfg.num_gpus, metric=cfg.metric,
            **(dict(max_candidates=None) if defrag else {}))
        ok = t8.ok
        gpu = np.where(ok, t8.gpu, -1)
        check(np.array_equal(ok, host.ok) and np.array_equal(gpu, host.gpu)
              and np.array_equal(host_anchors(spec, small.pid, gpu, t8.aidx), host.anchor),
              f"{name}: card decisions differ from the host scheduler's")
        if defrag:
            check(all(np.array_equal(getattr(t8, f), getattr(host, f))
                      for f in ("mig", "mig_from_gpu", "mig_from_anchor", "mig_to_gpu",
                                "mig_to_anchor")),
                  f"{name}: card migrations differ from the host scheduler's")
        card = batched.run_batched(policy, cfg, runs=HOST_RUNS_CUMULATIVE, device=device)
        ref = run_many(policy, cfg, runs=HOST_RUNS_CUMULATIVE)
        exact = ("acceptance_rate", "allocated_workloads", "active_gpus",
                 "rejects_by_profile", "arrivals_by_profile", "demand_grid")
        check(all(np.array_equal(card[k], ref[k]) for k in exact)
              and all(np.array_equal(card["traces"][k], ref["traces"][k])
                      for k in exact[:3]),
              f"{name}: run_batched at R = {HOST_RUNS_CUMULATIVE} differs from run_many")
        # utilization and frag are float32 sums on the card, float64 on the host
        drift = {k: float(np.max(np.abs(np.asarray(card["traces"][k]) - ref["traces"][k])))
                 for k in ("utilization", "frag_severity")}
        out[policy] = dict(replica_events_per_s=dict(kernel=rates[0], plain=rates[1]),
                           launches=ck, e_max=e_max, acceptance=agg["acceptance_rate"],
                           migrations=int(tk.mig.sum()) if defrag else None,
                           host_float_drift=drift)
        log(f"{name} (M=100, R={RUNS}, E={e_max}): traces and aggregates equal (kernel vs "
            f"plain); launches {ck}; acceptance {agg['acceptance_rate']:.4f} utilization "
            f"{agg['utilization']:.4f} frag {agg['frag_severity']:.3f}"
            + (f", {int(tk.mig.sum())} migrations" if defrag else "")
            + f"; replica-events/s kernel {rates[0]:.0f} plain {rates[1]:.0f}; at R = "
            f"{HOST_RUNS_CUMULATIVE} decisions equal the host scheduler's and run_batched "
            f"equals run_many (utilization/frag traces within {drift['utilization']:.3g}/"
            f"{drift['frag_severity']:.3g}: float32 on the card, float64 on the host)")
    return out


def queued_phase(device, wrappers, totals):
    """The queued protocol: the reference's pinned queued hashes through
    the kernels; at M = 100, load ``QUEUED_LOAD``, R = ``RUNS`` for mfi
    and mfi-queued the kernel path equal to the plain path, with its rates,
    queue metrics and ``select_from_base`` launches per event (2: the
    arrival and the wait head); at R = ``HOST_RUNS_QUEUED`` the card's
    trace equal to ``replay.queued_host_decisions``; a profiled window."""
    import numpy as np
    import torch
    from repro_torch.core import mig
    from repro_torch.sim import batched, replay
    from repro_torch.sim.simulator import SimConfig

    def common_of(cfg, rows, cols):
        spec = cfg.spec()
        return dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=rows,
                    ring_cols=cols, kernel_spec=spec, protocol="steady-queued",
                    wait_slots=cfg.wait_capacity, wait_patience=cfg.wait_patience,
                    midx=torch.as_tensor(spec.model_index, device=device),
                    tables=batched.spec_tables(spec, device), device=device)

    mixed = mig.ClusterSpec(((mig.A100_80GB, 3), (mig.A100_40GB, 3)))
    for tag, policy, cfg in (
            ("homog", "mfi", SimConfig(num_gpus=5, offered_load=1.2, seed=7)),
            ("mixed", "mfi-queued", SimConfig(cluster_spec=mixed, offered_load=1.1, seed=9))):
        events, _, rows, cols = batched.presample_arrivals(cfg, 3, queued=True)
        _, trace = batched._simulate(events, policy=policy, use_kernel=True,
                                     **common_of(cfg, rows, cols))
        trace = batched.trace_to_numpy(trace)
        got = trace_hash(tuple(getattr(trace, f) for f in QUEUED_HASH_FIELDS))
        check(got == GOLDEN_QUEUED_TRACE_HASHES[tag], f"golden queued hash {tag}: {got}")
    log("queued: the 2 golden queued trace hashes reproduced with the kernels on")

    cfg = SimConfig(num_gpus=100, offered_load=QUEUED_LOAD, seed=0, protocol="steady-queued")
    spec = cfg.spec()
    events, meta, rows, cols = batched.presample_arrivals(cfg, RUNS, queued=True)
    common = common_of(cfg, rows, cols)
    # the host replay runs on the first replicas of this stream (replicas
    # never interact, so their rows of the R = RUNS trace are their runs)
    e_max = events.pid.shape[0]
    out = {}
    for policy in ("mfi", "mfi-queued"):
        # mfi takes the whole stream, mfi-queued its first SIDE_EVENTS events
        n = e_max if policy == "mfi" else min(e_max, SIDE_EVENTS)
        run = batched.EventStream(*[None if a is None else a[:n] for a in events])
        small = batched.EventStream(*[None if a is None else a[:n, :HOST_RUNS_QUEUED]
                                      for a in events])
        small_meta = batched.EventMeta(*[a[:n, :HOST_RUNS_QUEUED] for a in meta])
        want = dict.fromkeys(wrappers, 0)
        want.update(fragscore=3 * n, select_from_base=2 * n)
        name = f"queued {policy}"
        tk, tp, rates, ck, _ = paths_equal(name, run, policy, common, wrappers, want,
                                           plain_events=PLAIN_EVENTS)
        for k in totals:
            totals[k] += ck[k]
        t4 = batched.EventTrace(*[None if a is None else a[:, :HOST_RUNS_QUEUED] for a in tk])
        host = replay.queued_host_decisions(
            small, small_meta, policy, cfg.num_gpus, metric=cfg.metric,
            capacity=cfg.wait_capacity, patience=cfg.wait_patience)
        ok = t4.ok
        adm = host.wadm_eidx >= 0
        pid_w = np.where(adm, small.pid[np.maximum(host.wadm_eidx, 0),
                                        np.arange(ok.shape[1])[None, :]], 0)
        check(np.array_equal(ok, host.ok) and np.array_equal(t4.parked, host.parked)
              and np.array_equal(np.where(ok, t4.gpu, -1), host.gpu)
              and np.array_equal(t4.wadm_eidx, host.wadm_eidx)
              and np.array_equal(t4.wadm_gpu, host.wadm_gpu)
              and np.array_equal(host_anchors(spec, pid_w, t4.wadm_gpu, t4.wadm_aidx),
                                 host.wadm_anchor),
              f"{name}: card trace differs from queued_host_decisions at R = "
              f"{HOST_RUNS_QUEUED}")
        keys = ("acceptance_rate", "wait_p50", "wait_p99", "fairness", "queue_admits")
        # the aggregates of a whole stream only
        agg = (batched._aggregate_queued(run, tk, spec, RUNS) if n == e_max
               else dict.fromkeys(keys))
        out[policy] = dict(replica_events_per_s=dict(kernel=rates[0], plain=rates[1]),
                           launches=ck, e_max=e_max, events=n,
                           select_per_event=ck["select_from_base"] / n,
                           **{k: agg[k] for k in keys})
        summary = (" ".join(f"{k} {agg[k]:.4f}" for k in keys) if n == e_max
                   else "no aggregates (a prefix of the stream)")
        log(f"{name} (M=100, load {QUEUED_LOAD}, R={RUNS}, E_max={e_max}; kernel path over "
            f"{n} events): traces equal (kernel vs plain over the first {PLAIN_EVENTS} "
            f"events); launches {ck} (select_from_base {ck['select_from_base'] / n:.2f} per "
            f"event); " + summary
            + f"; {int(tk.parked.sum())} parks, {int((tk.wadm_eidx >= 0).sum())} wait-admits"
            f"; replica-events/s kernel {rates[0]:.0f} plain {rates[1]:.0f}; at R = "
            f"{HOST_RUNS_QUEUED} the card's trace equals queued_host_decisions "
            f"({int(adm.sum())} wait-admits)")
    window = engine_windows(device, events, common, ("mfi",), label="queued ")
    out["window"] = {f"{k[0]} {k[1]}": v for k, v in window.items()}
    return out


def protocols_phase(device, wrappers):
    totals = dict.fromkeys(wrappers, 0)
    out = dict(cumulative=cumulative_phase(device, wrappers, totals),
               queued=queued_phase(device, wrappers, totals))
    for k in ("fragscore", "select_from_base", "migrate_refine"):
        check(totals[k] > 0, f"{k} never launched on the protocols' paths")
    out["launches"] = totals
    return out


# ---------------------------------------------------------------------------
# phase 11: the faulted protocol and the chunked driver
# ---------------------------------------------------------------------------


def faulted_common(cfg, rows, cols, fm, device):
    """The engine's keywords of a faulted run of ``cfg`` under ``fm``."""
    import dataclasses

    import torch
    from repro_torch.sim import batched

    spec = cfg.spec()
    proto = dataclasses.replace(batched.resolve_protocol("steady-faulted"),
                                fault_retries=fm.max_retries, fault_backoff=fm.backoff_base)
    return dict(metric=cfg.metric, num_gpus=cfg.num_gpus, ring_rows=rows, ring_cols=cols,
                kernel_spec=spec, protocol=proto, wait_slots=cfg.wait_capacity,
                wait_patience=cfg.wait_patience,
                midx=torch.as_tensor(spec.model_index, device=device),
                tables=batched.spec_tables(spec, device), device=device)


def faulted_phase(device, wrappers, totals):
    """The faulted protocol: the reference's pinned faulted hashes through
    the kernels; at M = 100, load ``QUEUED_LOAD``, R = ``RUNS`` for mfi,
    mfi-queued and ff the kernel path (no host sync in its loop) equal to
    the plain path with exact launches per event, evictions, the fault
    keys; at R = ``HOST_RUNS_FAULTED`` the card's trace equal to
    ``replay.faulted_host_decisions``; a profiled window; the recorded
    fault sweep's mfi rows.  Returns ``(summary, the mfi kernel run)``."""
    import numpy as np
    from repro_torch.core import mig
    from repro_torch.sim import batched, replay
    from repro_torch.sim.simulator import SimConfig

    fm = mig.FaultModel(mtbf=FAULT_MTBF, mttr=FAULT_MTTR)
    mixed = mig.ClusterSpec(((mig.A100_80GB, 3), (mig.A100_40GB, 3)))
    for tag, policy, cfg in (
            ("homog", "mfi", SimConfig(num_gpus=5, offered_load=1.2, seed=7)),
            ("mixed", "mfi-queued", SimConfig(cluster_spec=mixed, offered_load=1.1, seed=9))):
        events, _, rows, cols = batched.presample_arrivals(cfg, 3, queued=True, fault_model=fm)
        _, trace = batched._simulate(events, policy=policy, use_kernel=True,
                                     **faulted_common(cfg, rows, cols, fm, device))
        trace = batched.trace_to_numpy(trace)
        got = trace_hash(tuple(getattr(trace, f) for f in FAULTED_HASH_FIELDS))
        check(got == GOLDEN_FAULTED_TRACE_HASHES[tag], f"golden faulted hash {tag}: {got}")
    log("faulted: the 2 golden faulted trace hashes reproduced with the kernels on")

    cfg = SimConfig(num_gpus=100, offered_load=QUEUED_LOAD, seed=0, protocol="steady-faulted",
                    fault_model=fm)
    spec = cfg.spec()
    t0 = time.perf_counter()
    events, meta, rows, cols = batched.presample_arrivals(cfg, RUNS, queued=True,
                                                          fault_model=fm)
    presample_s = time.perf_counter() - t0
    common = faulted_common(cfg, rows, cols, fm, device)
    e_max = events.pid.shape[0]
    log(f"faulted: presampled (E_max, R, M) = {events.fail.shape}, ring {rows} x {cols}, "
        f"{int(events.fail.sum())} failures, {presample_s:.2f} s")
    out = {}
    mono = None
    head = batched.EventStream(*[None if a is None else a[:PLAIN_EVENTS] for a in events])
    for policy in ("mfi", "mfi-queued", "ff"):
        # mfi runs the whole stream on the kernel path (its rates, the fault
        # keys, the host replay and the chunked runs' baseline come from it);
        # every plain path, and mfi-queued and ff, run the first PLAIN_EVENTS
        name = f"faulted {policy}"
        run = events if policy == "mfi" else head
        n = run.pid.shape[0]
        want = dict.fromkeys(wrappers, 0)
        want.update(fragscore=3 * n, delta_from_base=0 if policy == "ff" else 2 * n)
        tk, _, rates, ck, (sk, peak) = paths_equal(name, run, policy, common, wrappers,
                                                   want, plain_events=PLAIN_EVENTS)
        for k in totals:
            totals[k] += ck[k]
        check(int(tk.evicted.sum()) > 0, f"{name}: no evictions")
        out[policy] = dict(replica_events_per_s=dict(kernel=rates[0], plain=rates[1]),
                           launches=ck, events=n, peak_mb=peak / 2**20,
                           per_event={k: v / n for k, v in ck.items() if v},
                           evictions=int(tk.evicted.sum()), lost=int(tk.evict_lost.sum()))
        keys = agg = ()
        if policy == "mfi":  # run_batched's reduction of this run (host, ~10 s at R = 500)
            mono = dict(trace=tk, seconds=sk, peak=peak, events=events, common=common)
            t0 = time.perf_counter()
            agg = batched._aggregate_faulted(events, tk, spec, RUNS)
            keys = ("acceptance_rate", "goodput", "evictions", "evictions_lost",
                    "recovered_fraction", "ttr_p50", "ttr_p99", "wait_p99", "queue_admits")
            out[policy].update(aggregate_s=time.perf_counter() - t0,
                               **{k: agg[k] for k in keys})
        log(f"{name} (M=100, load {QUEUED_LOAD}, MTBF {FAULT_MTBF:g}, MTTR {FAULT_MTTR:g}, "
            f"R={RUNS}, E_max={e_max}; kernel path over {n} events, plain over "
            f"{min(n, PLAIN_EVENTS)}): traces equal (kernel vs plain); launches {ck} "
            f"(per event: " + ", ".join(f"{k} {v / n:.2f}" for k, v in ck.items() if v)
            + "; select_from_base 0); no host sync in the kernel loop; "
            + "".join(f"{k} {agg[k]:.4f}" + ("; " if k == keys[-1] else " ") for k in keys)
            + f"{int(tk.evicted.sum())} evictions ({int(tk.evict_lost.sum())} lost); "
            f"replica-events/s kernel {rates[0]:.0f} plain {rates[1]:.0f}; peak device "
            f"memory {peak / 2**20:.1f} MiB over the kernel run's start")

    # the host replay runs on the first replicas of the R = RUNS stream,
    # against their rows of the mfi kernel run (replicas never interact)
    small = batched.EventStream(*[None if a is None else a[:, :HOST_RUNS_FAULTED]
                                  for a in events])
    small_meta = batched.EventMeta(*[a[:, :HOST_RUNS_FAULTED] for a in meta])
    t4 = batched.EventTrace(*[None if a is None else a[:, :HOST_RUNS_FAULTED]
                              for a in mono["trace"]])
    host = replay.faulted_host_decisions(
        small, small_meta, "mfi", cfg.num_gpus, metric=cfg.metric, capacity=cfg.wait_capacity,
        patience=cfg.wait_patience, max_retries=fm.max_retries, backoff_base=fm.backoff_base)
    ok = t4.ok
    adm = host.wadm_eidx >= 0
    pid_w = np.where(adm, small.pid[np.maximum(host.wadm_eidx, 0),
                                    np.arange(ok.shape[1])[None, :]], 0)
    check(all(np.array_equal(getattr(t4, f), getattr(host, f))
              for f in ("ok", "parked", "wadm_eidx", "wadm_gpu", "evicted", "evict_lost",
                        "evict_esum"))
          and np.array_equal(np.where(ok, t4.gpu, -1), host.gpu)
          and np.array_equal(host_anchors(spec, small.pid, np.where(ok, t4.gpu, -1), t4.aidx),
                             host.anchor)
          and np.array_equal(host_anchors(spec, pid_w, t4.wadm_gpu, t4.wadm_aidx),
                             host.wadm_anchor),
          f"faulted mfi: card trace differs from faulted_host_decisions at R = "
          f"{HOST_RUNS_FAULTED}")
    log(f"faulted mfi, replicas 0-{HOST_RUNS_FAULTED - 1} of the R = {RUNS} kernel run: the "
        f"card's trace equals "
        f"faulted_host_decisions ({int(host.evicted.sum())} evictions, {int(adm.sum())} "
        f"wait-admits)")
    window = engine_windows(device, events, common, ("mfi",), label="faulted ")
    out["window"] = {f"{k[0]} {k[1]}": v for k, v in window.items()}
    out["sweep"] = fault_sweep(device, wrappers, totals)
    return out, mono


def fault_sweep(device, wrappers, totals):
    """The recorded fault sweep's mfi rows on the card, each beside its
    recorded row (printed, not asserted), and their queued anchor.

    The sweep's points share one arrival stream (the same configuration
    and seed; the fault draws come after every other draw) and differ
    only in their fail/recover lanes, and replicas never interact, so the
    five MTBF points run as five blocks of ``FAULT_SWEEP_RUNS`` replicas in
    one engine run, each block reduced on its own; ``run_batched`` at MTBF
    60 must return its block's dict.  The anchor is ``run_batched`` under
    ``steady-queued``, as in the benchmark (the faulted protocol re-arms a
    patience overrun that the queued one drops, so a fault-free faulted
    run is not the anchor)."""
    import dataclasses

    import numpy as np
    from repro_torch.core import mig
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig

    recorded = {line.split(",")[2]: line
                for line in (ROOT / FAULT_SWEEP_CSV).read_text().splitlines()
                if line.startswith("faults,mfi,")}
    base = SimConfig(num_gpus=100, distribution="uniform", offered_load=QUEUED_LOAD, seed=0,
                     protocol="steady-faulted", wait_capacity=8, wait_patience=16,
                     num_tenants=4)
    spec = base.spec()
    fms = [mig.FaultModel(mtbf=m, mttr=FAULT_MTTR, max_retries=2) for m in FAULT_SWEEP_MTBFS]
    streams = [batched.presample_arrivals(base, FAULT_SWEEP_RUNS, queued=True, fault_model=fm)
               for fm in fms]
    first, _, rows, cols = streams[0]
    check(all(s[2:] == (rows, cols) and np.array_equal(s[0].pid, first.pid) for s in streams),
          "fault sweep: the points' arrival streams differ")
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    anchor = batched.run_batched("mfi", dataclasses.replace(base, protocol="steady-queued"),
                                 runs=FAULT_SWEEP_RUNS, device=device)["acceptance_rate"]
    log(f"fault sweep anchor (run_batched, steady-queued mfi, R={FAULT_SWEEP_RUNS}): "
        f"acceptance {anchor:.4f} ({time.perf_counter() - t0:.2f} s)")
    for k, fn in wrappers.items():
        totals[k] += fn.launches
    blocks = [s[0] for s in streams]
    events = batched.EventStream(*[
        None if a is None else np.concatenate([getattr(b, name) for b in blocks], axis=1)
        for name, a in zip(batched.EventStream._fields, first)])
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    _, trace = batched._simulate(events, policy="mfi", use_kernel=True,
                                 **faulted_common(base, rows, cols, fms[0], device))
    trace = batched.trace_to_numpy(trace)
    seconds = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    e_max = events.pid.shape[0]
    want = dict.fromkeys(wrappers, 0)
    want.update(fragscore=3 * e_max, delta_from_base=2 * e_max)
    check(counts == want, f"fault sweep: launch counts {counts} != {want}")
    for k in totals:
        totals[k] += counts[k]

    def block(nt, b):
        lo, hi = b * FAULT_SWEEP_RUNS, (b + 1) * FAULT_SWEEP_RUNS
        return type(nt)(*[None if a is None else a[:, lo:hi] for a in nt])

    log(f"fault sweep: {len(blocks)} blocks of R={FAULT_SWEEP_RUNS} (MTBF "
        f"{', '.join(f'{m:g}' for m in FAULT_SWEEP_MTBFS)}) in one run of "
        f"R={events.pid.shape[1]}, E_max={e_max}: {seconds:.2f} s, launches {counts}")
    points = {}
    for b, mtbf in enumerate(FAULT_SWEEP_MTBFS):
        r = batched._aggregate_faulted(block(events, b), block(trace, b), spec, FAULT_SWEEP_RUNS)
        row = (f"faults,mfi,{mtbf:g},{r['acceptance_rate']:.4f},{anchor:.4f},"
               f"{r['goodput']:.4f},{r['evictions']:.2f},{r['recovered_fraction']:.4f},"
               f"{r['ttr_p50']:.2f},{r['ttr_p99']:.2f}")
        rec = recorded.get(f"{mtbf:g}")
        points[f"{mtbf:g}"] = dict(row=row, recorded=rec, same=row == rec, result=r)
        log(f"fault sweep mtbf {mtbf:g}: this run {row}; recorded {rec}; "
            f"{'same' if row == rec else 'differs'}")
    same = sum(p["same"] for p in points.values())
    log(f"fault sweep: {same} of {len(points)} mfi rows print the recorded row "
        f"({FAULT_SWEEP_CSV})")

    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = batched.run_batched("mfi", dataclasses.replace(base, fault_model=fms[1]),
                              runs=FAULT_SWEEP_RUNS, device=device, chunk_size=FAULTED_CHUNK)
    seconds = time.perf_counter() - t0
    for k, fn in wrappers.items():
        totals[k] += fn.launches
    want = points[f"{FAULT_SWEEP_MTBFS[1]:g}"].pop("result")
    check(dicts_equal(got, want), "fault sweep: run_batched differs from its block")
    for p in points.values():
        p.pop("result", None)
    keys = ("goodput", "evictions", "evictions_lost", "recovered_fraction", "ttr_p50",
            "ttr_p99")
    log(f"run_batched mfi at MTBF {FAULT_SWEEP_MTBFS[1]:g} (R={FAULT_SWEEP_RUNS}, chunk_size "
        f"{FAULTED_CHUNK}): equal to its block; " + " ".join(f"{k} {got[k]:.4f}" for k in keys) + f" ({seconds:.2f} s)")
    return dict(anchor_acceptance=anchor, points=points,
                run_batched={k: got[k] for k in keys})


def chunked_check(name, events, policy, common, chunk, want_trace, wrappers, want_counts,
                  tmp):
    """``simulate_chunked`` over ``events`` at ``chunk`` events a chunk
    (kernels on; launch counts reset just before), checkpointing after
    chunk 2: its trace equal to ``want_trace``; then the checkpoint
    restored into a fresh carry and resumed for one more chunk, equal too.
    Returns its numbers."""
    import numpy as np
    import torch
    from repro_torch.sim import batched

    e_max, runs = events.pid.shape
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    done = 2 * chunk
    path = tmp / f"{name.replace(' ', '_')}_{chunk}"
    save = batched.save_stream_checkpoint

    def save_once(p, state, events_done, metadata=None):  # keep only chunk 2's
        if events_done == done:
            save(p, state, events_done, metadata)

    batched.save_stream_checkpoint = save_once
    t0 = time.perf_counter()
    try:
        _, trace = batched.simulate_chunked(events, chunk_size=chunk, policy=policy,
                                            use_kernel=True, stats=stats,
                                            checkpoint_path=path, checkpoint_every=2, **common)
    finally:
        batched.save_stream_checkpoint = save
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = {k: fn.launches for k, fn in wrappers.items()}
    for field in batched.EventTrace._fields:
        a, b = getattr(trace, field), getattr(want_trace, field)
        check((a is None) == (b is None) and (a is None or np.array_equal(a, b)),
              f"{name} chunk {chunk}: trace differs from the monolithic run in {field}")
    check(counts == want_counts, f"{name} chunk {chunk}: launches {counts} != {want_counts}")

    statics = {k: v for k, v in common.items() if k not in ("ring_rows", "ring_cols")}
    template = batched.init_carry(runs, policy=policy, use_kernel=True,
                                  ring_rows=common["ring_rows"],
                                  ring_cols=common["ring_cols"], **statics)
    state, step = batched.load_stream_checkpoint(path, template)
    check(step == done, f"{name}: checkpoint step {step} != {done}")
    end = min(e_max, done + chunk)
    upto = batched.EventStream(*[None if a is None else a[:end] for a in events])
    _, tail = batched.simulate_chunked(upto, chunk_size=chunk, policy=policy,
                                       use_kernel=True, carry=state, start=done, **common)
    for field in batched.EventTrace._fields:
        a, b = getattr(tail, field), getattr(want_trace, field)
        check((a is None) == (b is None) and (a is None or np.array_equal(a, b[done:end])),
              f"{name} chunk {chunk}: resumed tail differs from the monolithic run in {field}")
    res = dict(seconds=seconds, replica_events_per_s=runs * e_max / seconds,
               peak_mb=peak / 2**20, chunks=stats["chunks"],
               h2d_overlap_frac=stats["h2d_overlap_frac"], h2d_seconds=stats["h2d_seconds"],
               h2d_mb=stats["h2d_bytes"] / 2**20, d2h_seconds=stats["d2h_seconds"],
               launches=counts)
    log(f"{name} chunked at {chunk}: trace equal to the monolithic run; resumed from the "
        f"checkpoint after chunk 2 (event {done}): events {done}-{end} equal; "
        f"{stats['chunks']} chunks, "
        f"h2d_overlap_frac {stats['h2d_overlap_frac']:.4f}, h2d {stats['h2d_bytes'] / 2**20:.1f} "
        f"MiB in {stats['h2d_seconds']:.3f} s of staging, d2h wait {stats['d2h_seconds']:.3f} s; "
        f"wall {seconds:.2f} s with the checkpoint ({runs * e_max / seconds:.0f} "
        f"replica-events/s); peak device "
        f"memory {peak / 2**20:.1f} MiB over the run's start")
    return res


def chunked_phase(device, wrappers, totals, faulted_mono):
    """``simulate_chunked`` against the monolithic runs: the Fig. 4 point
    (steady mfi, R = ``RUNS``) at ``STEADY_CHUNKS`` and the faulted point
    (mfi) at ``FAULTED_CHUNK``, with a resume each."""
    import tempfile

    import torch
    from repro_torch.sim import batched

    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        _, _, events, common = paper_stream(device)
        e_max = events.pid.shape[0]
        batched._simulate(batched.EventStream(*[None if a is None else a[:32] for a in events]),
                          policy="mfi", use_kernel=True, **common)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, mono = batched._simulate(events, policy="mfi", use_kernel=True, **common)
        mono = batched.trace_to_numpy(mono)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        out["steady mfi"] = dict(monolithic=dict(seconds=seconds, peak_mb=peak / 2**20,
                                                 replica_events_per_s=RUNS * e_max / seconds))
        log(f"steady mfi monolithic (R={RUNS}, E_max={e_max}): wall {seconds:.2f} s, peak "
            f"device memory {peak / 2**20:.1f} MiB over the run's start")
        want = dict.fromkeys(wrappers, 0)
        want.update(fragscore=2 * e_max, select_from_base=e_max)
        for chunk in STEADY_CHUNKS:
            res = chunked_check("steady mfi", events, "mfi", common, chunk, mono, wrappers,
                                want, tmp)
            out["steady mfi"][str(chunk)] = res
            for k in totals:
                totals[k] += res["launches"][k]

        events, common = faulted_mono["events"], faulted_mono["common"]
        e_max = events.pid.shape[0]
        out["faulted mfi"] = dict(monolithic=dict(
            seconds=faulted_mono["seconds"], peak_mb=faulted_mono["peak"] / 2**20,
            replica_events_per_s=RUNS * e_max / faulted_mono["seconds"]))
        lanes = 2 * events.fail.nbytes
        log(f"faulted mfi monolithic (R={RUNS}, E_max={e_max}): wall "
            f"{faulted_mono['seconds']:.2f} s, peak device memory "
            f"{faulted_mono['peak'] / 2**20:.1f} MiB (fail/recover lanes {lanes / 2**20:.1f} "
            f"MiB of it; two staged chunks of {FAULTED_CHUNK} hold "
            f"{2 * lanes * FAULTED_CHUNK / e_max / 2**20:.1f} MiB)")
        want = dict.fromkeys(wrappers, 0)
        want.update(fragscore=3 * e_max, delta_from_base=2 * e_max)
        res = chunked_check("faulted mfi", events, "mfi", common, FAULTED_CHUNK,
                            faulted_mono["trace"], wrappers, want, tmp)
        out["faulted mfi"][str(FAULTED_CHUNK)] = res
        for k in totals:
            totals[k] += res["launches"][k]
    return out


def faults_phase(device, wrappers):
    totals = dict.fromkeys(wrappers, 0)
    faulted, mono = faulted_phase(device, wrappers, totals)
    out = dict(faulted=faulted, chunked=chunked_phase(device, wrappers, totals, mono))
    for k in ("fragscore", "delta_from_base", "select_from_base"):
        check(totals[k] > 0, f"{k} never launched on the faulted and chunked paths")
    out["launches"] = totals
    return out


# ---------------------------------------------------------------------------
# phase 6: decode_attention against its plain version
# ---------------------------------------------------------------------------


def attention_inputs(b, s, kheads, group, d, dtype, lengths, gen, device):
    import torch

    q = torch.randn(b, kheads * group, d, generator=gen, device=device).to(dtype)
    k = torch.randn(b, s, kheads, d, generator=gen, device=device).to(dtype)
    v = torch.randn(b, s, kheads, d, generator=gen, device=device).to(dtype)
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device=device)


def attention_error(got, want, dtype):
    """``(max abs error, worst error / scale-aware limit)`` of the kernel's
    output against the plain version computed in float32; raises past the
    dtype's tolerance and, for bf16, past the scale-aware bound
    ``2^-7·|plain| + 2^-10·rms(plain row)`` (the ratio is None for f32)."""
    import torch

    want = want.float()
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        check(float(err.max()) <= F32_ATOL, f"decode_attention f32 error {float(err.max())}")
        return float(err.max()), None
    bad = err > BF16_ATOL + BF16_RTOL * want.abs()
    check(not bool(bad.any()), f"decode_attention bf16 error {float(err.max())}")
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = BF16_TIGHT_RTOL * want.abs() + BF16_TIGHT_ROW_ATOL * rms
    ratio = float(torch.where(limit > 0, err / limit, err * float("inf")).nan_to_num(0.0).max())
    check(ratio <= 1.0, f"decode_attention bf16 error {float(err.max())} is {ratio:.3g} times "
                        f"its scale-aware limit 2^-7·|plain| + 2^-10·rms(plain row)")
    return float(err.max()), ratio


def attention_bound(q, k, lengths, out, starts=None):
    """The least time for one call: the valid K and V rows (``[start,
    length)`` of each row), q, the lengths and starts and out read or
    written once, and 4·Σ(length - start)·H·D fp32 operations."""
    import torch

    b, h, d = q.shape
    kheads = k.shape[2]
    hi = lengths.clamp(0, k.shape[1])
    lo = torch.zeros_like(hi) if starts is None else torch.minimum(starts.clamp(min=0), hi)
    total = int((hi - lo).sum())
    nbytes_ = (2 * total * kheads * d * k.element_size() + nbytes(q, out)
               + 4 * b * (1 if starts is None else 2))
    return bound(nbytes_, 4 * total * h * d), nbytes_


def sdpa_call(q, k, v, lengths, starts=None):
    """``scaled_dot_product_attention`` on the same inputs (GQA, a mask of
    the keys ``[start, length)``), as one PyTorch call: the library
    yardstick, never used by the port.  Rows with no valid key give NaN
    there."""
    import torch
    import torch.nn.functional as F

    s = k.shape[1]
    t = torch.arange(s, device=q.device)[None, :]
    mask = t < lengths[:, None].long()
    if starts is not None:
        mask = mask & (t >= starts[:, None].long())
    mask = mask[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    return call


def decode_attention_phase(device):
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as D
    from repro_torch.kernels.decode_attention import split
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    pos = SERVE_MAX_LEN - 3  # the last decode step of a wave
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    # the split length the kernel plans for the edge cases (B = 6, K = 8,
    # S = 3000, not a multiple of it): lengths 0, 1 and one split - 1, + 0, + 1
    edge_len, edge_splits = split.plan_splits(6, 8, 3000, sms)
    check(3000 % edge_len != 0 and edge_splits > 2, f"edge plan {edge_len} x {edge_splits}")
    edges = [0, 1, edge_len - 1, edge_len, edge_len + 1, 3000]
    # per-row starts over the same plan: inside a split, at a split's first
    # key, one before it, equal to the length (the row gives 0), past it
    start_lengths = [3000, 3000, 3000, 2000, 2 * edge_len + 5, 100]
    starts = [edge_len + 37, edge_len, edge_len - 1, 2000, 1, 150]
    # the dense layer options' decode shapes at full width (phase 13):
    # gemma3's ring padded past its window of 1,024 (prompt 1,024, max_len
    # 2,081, the wave's last step: start = pos - 1,023) and its wrapped
    # ring of 1,024 slots; qwen3's G = 5, starcoder2's G = 12 at D = 128,
    # paligemma's K = 1, G = 8 at D = 256 behind its 256 patches
    ring_pos = DENSE_RING_PROMPT + DENSE_NEW - 2
    gemma_len = DENSE_LONG_PROMPT + DENSE_NEW + 1
    cases = {
        "serving": (SERVE_SLOTS, SERVE_MAX_LEN, 8, 4, 64, bf16, [pos + 1] * SERVE_SLOTS, None, None),
        "long": (8, 8192, 8, 4, 64, bf16, [1, 8192, 4000, 17, 8191, 5000, 2, 6000], None, None),
        "middle": (4, 2048, 8, 4, 64, bf16, [2048, 1500, 700, 2047], None, None),
        "b1-32k": (1, 32768, 8, 4, 64, bf16, [32768], None, None),
        "f32-scale": (4, 1000, 8, 4, 64, f32, [1, 1000, 0, 517], 0.1, None),
        "f32-wide": (3, 300, 2, 12, 128, f32, [300, 1, 150], 0.3, None),
        "split-edges-f32": (6, 3000, 8, 4, 64, f32, edges, None, None),
        "split-edges-bf16": (6, 3000, 8, 4, 64, bf16, edges, None, None),
        "g1": (4, 1000, 8, 1, 64, bf16, [1000, 1, 0, 333], None, None),
        "g8": (4, 1000, 8, 8, 64, bf16, [1000, 64, 65, 999], None, None),
        "bf16-d128": (4, 1000, 8, 4, 128, bf16, [1000, 128, 0, 771], None, None),
        "bf16-d256": (2, 600, 4, 4, 256, bf16, [600, 257], None, None),
        "start-splits-f32": (6, 3000, 8, 4, 64, f32, start_lengths, None, starts),
        "start-splits-bf16": (6, 3000, 8, 4, 64, bf16, start_lengths, None, starts),
        "start-d128-bf16": (4, 1000, 8, 4, 128, bf16, [1000, 700, 300, 1000], None,
                            [129, 0, 300, 999]),
        "start-d256-bf16": (2, 600, 4, 4, 256, bf16, [600, 500], None, [257, 499]),
        "gemma3-ring": (SERVE_SLOTS, gemma_len, 8, 2, 256, bf16, [ring_pos + 1] * SERVE_SLOTS,
                        None, [ring_pos - DENSE_WINDOW + 1] * SERVE_SLOTS),
        "gemma3-wrapped": (SERVE_SLOTS, DENSE_WINDOW, 8, 2, 256, bf16,
                           [DENSE_WINDOW] * SERVE_SLOTS, None, None),
        "qwen3-g5-d128": (SERVE_SLOTS, 2048, 8, 5, 128, bf16, [2048, 1500, 129, 2000], None, None),
        "starcoder2-g12-d128": (SERVE_SLOTS, DENSE_PROMPT + DENSE_SHORT_NEW + 1, 4, 12, 128, bf16,
                                [DENSE_PROMPT + DENSE_SHORT_NEW] * SERVE_SLOTS, None, None),
        "paligemma-k1-g8-d256": (SERVE_SLOTS, DENSE_PATCHES + DENSE_PROMPT + DENSE_SHORT_NEW, 1, 8,
                                 256, bf16,
                                 [DENSE_PATCHES + DENSE_PROMPT + DENSE_SHORT_NEW] * SERVE_SLOTS,
                                 None, None),
        # phase 14's decode shapes at the wave's last step: granite (K = 8,
        # G = 3, D = 64, bf16) and grok's SMOKE (K = 2, G = 2, float32)
        "granite-g3": (SERVE_SLOTS, MOE_PROMPT + MOE_NEW + 1, 8, 3, 64, bf16,
                       [MOE_PROMPT + MOE_NEW - 1] * SERVE_SLOTS, None, None),
        "grok-smoke": (SERVE_SLOTS, GROK_SMOKE_PROMPT + GROK_SMOKE_NEW + 1, 2, 2, 64, f32,
                       [GROK_SMOKE_PROMPT + GROK_SMOKE_NEW - 1] * SERVE_SLOTS, None, None),
        # phase 15's hymba-1.5b at the wave's last step: a local cache of
        # prompt + new + 1 slots padded past its window of 1,024 (K = 5,
        # G = 5, D = 64, bf16), keys [pos - 1,023, pos]
        "hymba-g5-d64": (SERVE_SLOTS, SSM_PROMPT + SSM_NEW + 1, 5, 5, 64, bf16,
                         [SSM_PROMPT + SSM_NEW - 1] * SERVE_SLOTS, None,
                         [SSM_PROMPT + SSM_NEW - 2 - 1023] * SERVE_SLOTS),
        # phase 16's whisper-large-v3 at the wave's last step (K = 20, G = 1,
        # D = 64, bf16): the self cache of prompt + new slots read whole,
        # and the cross cache of the encoder's 1,536 frames read whole
        "whisper-self-g1": (SERVE_SLOTS, ENCDEC_PROMPT + ENCDEC_NEW, 20, 1, 64, bf16,
                            [ENCDEC_PROMPT + ENCDEC_NEW] * SERVE_SLOTS, None, None),
        "whisper-cross-g1": (SERVE_SLOTS, ENCDEC_FRAMES, 20, 1, 64, bf16,
                             [ENCDEC_FRAMES] * SERVE_SLOTS, None, None),
        # phase 17's hymba-1.5b global layer at its assigned sizes (K = 5,
        # G = 5, D = 64, bf16), every key read: decode_32k's 128 x 32,768
        # and long_500k's 1 x 524,288
        "hymba-decode-32k": (128, 32768, 5, 5, 64, bf16, [32768] * 128, None, None),
        "hymba-long-500k": (1, 524288, 5, 5, 64, bf16, [524288], None, None),
    }
    timed_cases = ("serving", "long", "middle", "b1-32k", "gemma3-ring", "gemma3-wrapped",
                   "qwen3-g5-d128", "starcoder2-g12-d128", "paligemma-k1-g8-d256", "granite-g3",
                   "grok-smoke", "hymba-g5-d64", "whisper-self-g1", "whisper-cross-g1",
                   "hymba-decode-32k", "hymba-long-500k")
    errs, ratios = {}, {}
    row = {}
    for tag, (b, s, kh, g, d, dtype, lengths, scale, st) in cases.items():
        q, k, v, ln = attention_inputs(b, s, kh, g, d, dtype, lengths, gen, device)
        sv = None if st is None else torch.as_tensor(st, dtype=torch.int32, device=device)
        got = D.decode_attention(q, k, v, ln, scale=scale, start=sv)
        again = D.decode_attention(q, k, v, ln, scale=scale, start=sv)
        want = decode_attention_ref(q.float(), k.float(), v.float(), ln, scale=scale, start=sv)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"decode_attention [{tag}]: two calls differ")
        errs[tag], ratios[tag] = attention_error(got, want, dtype)
        if tag not in timed_cases:
            continue
        ms, call_ms, src = timed(lambda: D.decode_attention(q, k, v, ln, start=sv), 200, "decode_")
        # the plain version takes 20-30 ms at phase 17's assigned sizes: 5 calls there
        plain_iters = 50 if k.numel() < 2 ** 28 else 5
        plain_ms, plain_call_ms, _ = timed(lambda: decode_attention_ref(q, k, v, ln, start=sv),
                                           plain_iters)
        lib = sdpa_call(q, k, v, ln, sv)
        lib_ms, lib_call_ms, _ = timed(lib, 200)
        if all(hi > lo for hi, lo in zip(lengths, st or [0] * b)):
            lib_err = float((lib()[:, :, 0].float() - want).abs().max())
        else:
            lib_err = None
        (b_ms, b_by), nb = attention_bound(q, k, ln, got, sv)
        split_len, n_splits = split.plan_splits(b, kh, s, sms)
        shown = (f"[{lengths[0]}] x {b}" if b > 8 and len(set(lengths)) == 1 else str(lengths))
        shape = (f"q ({b}, {kh * g}, {d}), k/v ({b}, {s}, {kh}, {d}) {str(dtype)[6:]}, "
                 f"lengths {shown}, starts {st}, {n_splits} splits of {split_len}")
        log(f"kernel decode_attention [{tag}]: {shape}: max abs err {errs[tag]:.3e} "
            f"against the f32 plain version; device {ms:.5f} ms ({src}), per call "
            f"{call_ms:.4f} ms; plain device {plain_ms:.5f} ms, per call {plain_call_ms:.4f} ms; "
            f"sdpa device {lib_ms:.5f} ms, per call {lib_call_ms:.4f} ms (sdpa err {lib_err}); "
            f"bound {b_ms:.6f} ms ({b_by}, {nb} bytes)")
        row[tag] = dict(ms=ms, call_ms=call_ms, ms_source=src, plain_ms=plain_ms,
                        plain_call_ms=plain_call_ms, library_ms=lib_ms, library_call_ms=lib_call_ms,
                        bound_ms=b_ms, bound_by=b_by, shape=shape)
    check(row["long"]["ms"] < row["long"]["library_ms"],
          "decode_attention at the long shape is slower than SDPA")
    bf16_ratios = {tag: r for tag, r in ratios.items() if r is not None}
    log(f"kernel decode_attention: within tolerance and bit-identical across two calls "
        f"on every case (f32 <= {F32_ATOL}; bf16 <= {BF16_ATOL} + {BF16_RTOL}·|plain|): {errs}")
    log(f"kernel decode_attention: bf16 error / scale-aware limit (2^-7·|plain| + "
        f"2^-10·rms(plain row)), worst element per case: {bf16_ratios}")
    serving = row["serving"]
    return dict(serving, max_abs_err=max(errs.values()), errors=errs, bound_ratios=bf16_ratios,
                tolerance=f"f32 max abs <= {F32_ATOL}; bf16 |err| <= {BF16_ATOL} + "
                          f"{BF16_RTOL}*|plain| and <= 2^-7*|plain| + 2^-10*rms(plain row) "
                          f"against the f32 plain version",
                **{tag.replace("-", "_"): {k: row[tag][k] for k in (
                    "ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")}
                   for tag in timed_cases[1:]})


# ---------------------------------------------------------------------------
# phase 7: the serving path at full width
# ---------------------------------------------------------------------------


def serve_requests(cfg, seed=0):
    """The request stream of ``launch/serve.py``: profiles of the uniform
    mix, random prompts, all from one numpy generator."""
    import numpy as np
    from repro_torch.core import mig
    from repro_torch.serving import Request
    from repro_torch.sim import distributions

    rng = np.random.default_rng(seed)
    profiles = distributions.sample_profiles("uniform", SERVE_REQUESTS, rng)
    return [Request(request_id=i,
                    prompt=rng.integers(0, cfg.vocab, SERVE_PROMPT).astype(np.int32),
                    max_new_tokens=SERVE_NEW, profile=mig.PROFILE_NAMES[profiles[i]])
            for i in range(SERVE_REQUESTS)]


def serving_engine(cfg, params, device):
    from repro_torch.serving import ServingEngine

    return ServingEngine(cfg, params, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         num_gpus=SERVE_GPUS, policy="mfi", device=device)


def timed_calls(fn, seconds):
    """``fn`` with each call's wall time, synchronised, appended to
    ``seconds`` (the engine reads every token to the host after each step
    anyway, so the synchronisation costs it nothing)."""
    import torch

    def call(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    return call


def serving_phase(device, wrappers):
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.decode_attention import decode_attention as D
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import common, model

    cfg = ARCHS[SERVE_ARCH]
    t0 = time.perf_counter()
    params = model.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"serving: {SERVE_ARCH} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype}, "
        f"{n_params} parameters ({weight_bytes / 1e9:.3f} GB) drawn in "
        f"{time.perf_counter() - t0:.2f} s")

    # warm-up: one short wave (library load, cuBLAS handles, allocator)
    warm = serving_engine(cfg, params, device)
    warm_reqs = serve_requests(cfg, seed=1)[:SERVE_SLOTS]
    for r in warm_reqs:
        r.max_new_tokens = 3
    warm.run(warm_reqs)
    torch.cuda.synchronize()

    engine = serving_engine(cfg, params, device)
    prefill_s, decode_s = [], []
    engine._prefill = timed_calls(engine._prefill, prefill_s)
    engine._decode = timed_calls(engine._decode, decode_s)
    requests = serve_requests(cfg)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = engine.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    steps = len(decode_s)
    want = dict.fromkeys(wrappers, 0)
    want["decode_attention"] = cfg.n_layers * steps
    check(counts == want, f"serving: launch counts {counts} != expected {want}")
    check(steps > 0 and len(prefill_s) == stats["waves"], "serving: no decode step ran")
    for r in requests:
        check(r.finished and r.admitted and len(r.output) == SERVE_NEW
              and all(0 <= t < cfg.vocab for t in r.output),
              f"serving: request {r.request_id} ended {r.admitted, r.finished, r.output}")
    check(engine.admission.cluster.used_mem_slices == 0, "serving: slices left allocated")

    # the same request stream through admission alone (no model): equal stats
    alone = serving_engine(cfg, params, device)

    def release_only(wave):
        for r in wave:
            r.output, r.finished = [], True
            alone._release(r)

    alone._serve_wave = release_only
    alone_reqs = serve_requests(cfg)
    alone_stats = alone.run(alone_reqs)
    check(alone_stats == stats, f"serving: admission stats {stats} != admission alone {alone_stats}")
    check([(r.admitted, r.rejected) for r in alone_reqs]
          == [(r.admitted, r.rejected) for r in requests], "serving: admission decisions differ")

    # one real decode step's attention inputs, every layer: kernel vs plain
    wave = requests[:SERVE_SLOTS]
    prompts = torch.as_tensor(np.stack([r.prompt for r in wave]), device=device)
    logits, cache = model.prefill(params, {"tokens": prompts}, cfg)
    cache = model.pad_cache(cache, SERVE_PROMPT, SERVE_MAX_LEN)
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    captured = []
    direct = common.decode_gqa_attention

    def record(q, k, v, length, **kw):
        captured.append((q.clone(), k.clone(), v.clone(), length.clone()))
        return direct(q, k, v, length, **kw)

    common.decode_gqa_attention = record
    try:
        logits, cache = model.decode_step(params, cache, tokens, SERVE_PROMPT, cfg)
    finally:
        common.decode_gqa_attention = direct
    check(len(captured) == cfg.n_layers, "serving: capture missed layers")
    check(bool(torch.isfinite(logits).all()), "serving: non-finite logits")
    err = ratio = 0.0
    for q, k, v, length in captured:
        got = ops.gqa_decode_attention(q, k, v, length, use_kernel=True)
        want_f32 = ops.gqa_decode_attention(q.float(), k.float(), v.float(), length,
                                            use_kernel=False)
        e, r = attention_error(got, want_f32, torch.bfloat16)
        err, ratio = max(err, e), max(ratio, r)
    log(f"serving: one decode step's attention inputs ({cfg.n_layers} layers, q "
        f"{tuple(captured[0][0].shape)}, cache {tuple(captured[0][1].shape)}, length "
        f"{captured[0][3].tolist()}): kernel vs plain max abs err {err:.3e}, "
        f"{ratio:.3f} of the scale-aware limit")

    # a profiled window of 16 decode steps on that cache
    window = 16

    def steps16():
        t = tokens
        for i in range(window):
            lg, _ = model.decode_step(params, cache, t, SERVE_PROMPT + 1 + i, cfg)
            t = torch.argmax(lg, dim=-1).to(torch.int32)
        return t

    times = device_times(steps16, 1)
    t1 = time.perf_counter()
    steps16()
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t1) * 1e3
    busy_ms = sum(t for t, _ in times.values()) / 1e3
    ops_ = sum(c for _, c in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:5]
    decode_tokens = steps * SERVE_SLOTS
    out = dict(
        waves=stats["waves"], decode_steps=steps, launches=counts["decode_attention"],
        prefill_ms_per_wave=1e3 * sum(prefill_s) / len(prefill_s),
        decode_ms_per_step=1e3 * sum(decode_s) / steps,
        decode_tokens_per_s=decode_tokens / sum(decode_s),
        run_s=wall, tokens_per_s=sum(len(r.output) for r in requests) / wall,
        window_busy_ms=busy_ms, window_wall_ms=window_ms, busy_share=busy_ms / window_ms,
        device_ops_per_step=ops_ / window, weight_bytes=weight_bytes,
        weight_read_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        kernel_vs_plain_err=err, stats=stats)
    log(f"serving: {SERVE_REQUESTS} requests ({SERVE_PROMPT}-token prompts, {SERVE_NEW} new "
        f"tokens, {SERVE_SLOTS} slots, {SERVE_GPUS} A100-80GB, mfi) in {wall:.3f} s: "
        f"{out['waves']} waves, {steps} decode steps, decode_attention launches "
        f"{counts['decode_attention']} = {cfg.n_layers} x {steps}; prefill "
        f"{out['prefill_ms_per_wave']:.3f} ms/wave, decode {out['decode_ms_per_step']:.3f} ms/step, "
        f"{out['decode_tokens_per_s']:.1f} decode tokens/s, {out['tokens_per_s']:.1f} tokens/s "
        f"end to end; weights read once: {out['weight_read_ms']:.3f} ms")
    log(f"serving: admission stats {stats} equal the controller alone")
    log(f"serving window ({window} decode steps): device busy {busy_ms:.3f} ms of "
        f"{window_ms:.3f} ms wall ({100 * busy_ms / window_ms:.1f}% busy), "
        f"{ops_ / window:.1f} device ops/step; top: "
        + "; ".join(f"{k[:48]} {t / c:.1f} us x{c}" for k, (t, c) in top))

    t2 = time.perf_counter()
    serve.main([])
    torch.cuda.synchronize()
    log(f"serving: launch/serve.py main ran as it stands in {time.perf_counter() - t2:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: mfi_delta against its plain version
# ---------------------------------------------------------------------------


def mfi_delta_bound(occ, out, tables, a):
    """The least time for one mfi_delta call: occ and the tables read once,
    the (M, A) table written once; and the fp32 operations the function
    needs.  Per row: its window counts (2·N·S) and used slices (S) once,
    F(occ) from those counts (4·N: predicate, eligibility, select, sum) and
    one overlap test per anchor (the count of the anchor's own window, 1).
    Per feasible dry run: its counts, the row's plus the anchor's fixed
    mask·W row (N), its free slices (1), F after (4·N) and ΔF (1)."""
    m, s = occ.shape
    n = tables.placement_masks.shape[0]
    feasible = int((out < 1e29).sum())
    ops = m * (2 * n * s + s + 4 * n + a) + feasible * (5 * n + 2)
    nb = nbytes(occ, tables.placement_masks, tables.placement_mem) + 4 * a * (s + 1) + nbytes(out)
    return bound(nb, ops), nb, ops, feasible


def mfi_delta_cases(device, rng):
    """mfi_delta held to its plain version, and to itself on a second call,
    on every device model: every occupancy pattern (its bit path) and rows
    with entries outside {0, 1} (its count path), under the model's table,
    window sizes halved, sizes one below their slice count (the bit path
    counting each window's slices for "partial") and N > 32 by repeating the
    windows; anchor masks doubled as well on the A100-80GB; every demand
    class, both metrics.  Returns the number of cases."""
    import numpy as np
    import torch
    from repro_torch.core import cluster, mig
    from repro_torch.kernels.fragscore import fragscore as K
    from repro_torch.kernels.fragscore import ref

    n_cases = 0
    for name, model in sorted({m.name: m for m in mig.DEVICE_MODELS.values()}.items()):
        t = cluster.tables_for(model, device=device)
        s = model.num_mem_slices
        rows = {"all patterns": pattern_rows(s),
                "entries outside {0, 1}": rng.integers(-2, 4, (256, s)).astype(np.int32)}
        w, v = t.placement_masks, t.placement_mem
        tables = {"its table": (w, v), "sizes halved": (w, v / 2),
                  "sizes one below the slice count": (w, (v - 1).clamp(min=0)),
                  "N > 32": (torch.cat([w, w]).contiguous(), torch.cat([v, v]).contiguous())}
        for (rtag, rows_np), (ttag, (wt, vt)) in itertools.product(rows.items(), tables.items()):
            x = torch.as_tensor(rows_np, device=device)
            for pid in range(mig.NUM_PROFILES):
                pm = t.profile_masks[pid].to(torch.float32)
                pv = t.profile_valid[pid].to(torch.float32)
                masks = (pm, 2 * pm) if model is mig.A100_80GB else (pm,)
                for pmt, metric in itertools.product(masks, ("blocked", "partial")):
                    got = K.mfi_delta(x, wt, vt, pmt, pv, metric=metric)
                    what = f"mfi_delta/{name}/{rtag}/{ttag}/{mig.PROFILE_NAMES[pid]}/{metric}"
                    check(torch.equal(got, ref.mfi_delta_ref(x, wt, vt, pmt, pv, metric)),
                          f"{what} differs from its plain version")
                    check(torch.equal(got, K.mfi_delta(x, wt, vt, pmt, pv, metric=metric)),
                          f"{what}: two calls differ")
                    n_cases += 1
    return n_cases


def mfi_delta_phase(device):
    import numpy as np
    import torch
    from repro_torch.core import cluster, mig
    from repro_torch.kernels.fragscore import fragscore as K
    from repro_torch.kernels.fragscore import ref

    rng = np.random.default_rng(0)
    cases = [(mig.A100_80GB, m) for m in MFI_DELTA_GPUS]
    cases += [(mig.A100_40GB, 10_000), (mig.H200_141GB, 10_000)]
    timed_pid = mig.PROFILE_NAMES.index("1g.10gb")  # the most anchors
    err = 0.0
    by_m = {}
    for model, m in cases:
        t = cluster.tables_for(model, device=device)
        occ = torch.as_tensor(
            (rng.random((m, model.num_mem_slices)) < MFI_DELTA_FILL).astype(np.int32), device=device)
        occs = [occ]
        if m == 10_000:  # counts above 1: the dry run's clip is the reference's
            occs.append(occ * torch.as_tensor(
                rng.integers(0, 3, occ.shape).astype(np.int32), device=device))
        for x in occs:
            for pid in range(mig.NUM_PROFILES):
                pm = t.profile_masks[pid].to(torch.float32)
                pv = t.profile_valid[pid].to(torch.float32)
                for metric in ("blocked", "partial"):
                    got = K.mfi_delta(x, t.placement_masks, t.placement_mem, pm, pv, metric=metric)
                    want = ref.mfi_delta_ref(x, t.placement_masks, t.placement_mem, pm, pv, metric)
                    check(torch.equal(got, want),
                          f"mfi_delta/{model.name}/M={m}/{mig.PROFILE_NAMES[pid]}/{metric} "
                          "differs from its plain version")
                    err = max(err, float((got - want).abs().max()))
        pm = t.profile_masks[timed_pid].to(torch.float32)
        pv = t.profile_valid[timed_pid].to(torch.float32)
        args = (occ, t.placement_masks, t.placement_mem, pm, pv)
        ms, call_ms, src = timed(lambda: K.mfi_delta(*args), 200, "mfi_delta_kernel")
        plain_ms, plain_call_ms, _ = timed(lambda: ref.mfi_delta_ref(*args), 20)
        out = K.mfi_delta(*args)
        (b_ms, b_by), nb, ops, feasible = mfi_delta_bound(occ, out, t, pm.shape[0])
        tag = f"{model.name} M={m}"
        by_m[tag] = dict(ms=ms, call_ms=call_ms, ms_source=src, plain_ms=plain_ms,
                         plain_call_ms=plain_call_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nb, ops=ops, feasible=feasible)
        log(f"kernel mfi_delta [{tag}, 1g.10gb, A = {pm.shape[0]}, {feasible} feasible]: "
            f"device {ms:.5f} ms ({src}), per call {call_ms:.4f} ms; plain device "
            f"{plain_ms:.5f} ms, per call {plain_call_ms:.4f} ms; bound {b_ms:.6f} ms "
            f"({b_by}, {nb} bytes, {ops} ops)")
    log(f"kernel mfi_delta: equal to plain on {len(cases)} fleets x {mig.NUM_PROFILES} classes "
        f"x 2 metrics (+ non-binary occupancy at M = 10,000); max abs err {err}; library "
        f"call: none (no single torch call computes it)")
    n_cases = mfi_delta_cases(device, rng)
    log(f"kernel mfi_delta: equal to plain and the same bits on two calls on {n_cases} cases: "
        "every 2^S occupancy pattern and rows with entries outside {0, 1} of each device model, "
        "under its table, sizes halved, sizes one below the slice count and N > 32 (and "
        "doubled anchor masks on the A100-80GB), every class, both metrics")
    main = by_m[f"{mig.A100_80GB.name} M=100"]
    return dict(max_abs_err=err, library_ms=None, shape="occ (100, 8), A = 7 (1g.10gb)",
                by_m=by_m, **{k: main[k] for k in ("ms", "call_ms", "ms_source", "plain_ms",
                                                  "plain_call_ms", "bound_ms", "bound_by")})


# ---------------------------------------------------------------------------
# phase 9: the single-decision path
# ---------------------------------------------------------------------------


def card_scheduler(device):
    """A host-engine ``Scheduler`` whose every decision is made on the card
    by ``cluster.mfi_select(use_kernel=True)`` and held to the dense
    lowering on the card and to the host MFI scheduler on the same state."""
    import torch
    from repro_torch.core import cluster
    from repro_torch.core.schedulers import Scheduler, make_scheduler

    class CardMFI(Scheduler):
        name = "mfi-card"

        def __init__(self, metric="blocked"):
            super().__init__(metric)
            self.host = make_scheduler("mfi", metric)
            self.calls = 0

        def reset(self):
            self.host.reset()
            self.calls = 0

        def select(self, state, profile_id):
            occ = torch.as_tensor(state.occupancy_matrix(), device=device)
            d = cluster.mfi_select(occ, profile_id, self.metric, use_kernel=True)
            dense = cluster.mfi_select(occ, profile_id, self.metric, use_kernel=False)
            check(all(torch.equal(a, b) for a, b in zip(d, dense)),
                  f"decision {self.calls}: kernel {d} != dense {dense}")
            sel = (int(d.gpu), int(d.anchor)) if bool(d.accepted) else None
            want = self.host.select(state, profile_id)
            check(sel == want, f"decision {self.calls}: card {sel} != host {want}")
            self.calls += 1
            return sel

    return CardMFI()


def results_equal(a, b) -> bool:
    import dataclasses

    import numpy as np

    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def prefilled_fleet(m, rng):
    """A valid A100-80GB fleet of ``m`` GPUs in which every GPU holds work:
    each takes up to ``DECISION_PREFILL_TRIES`` requests of the uniform mix,
    each at a random feasible anchor.  Returns its placements
    ``[(gpu, profile, anchor)]`` in allocation order."""
    from repro_torch.core import mig
    from repro_torch.sim import distributions

    state = mig.ClusterState(m)
    tries = DECISION_PREFILL_TRIES
    pids = distributions.sample_profiles("uniform", m * tries, rng)
    placed = []
    for g, gs in enumerate(state.gpus):
        for pid in pids[g * tries:(g + 1) * tries].tolist():
            anchors = gs.feasible_anchors(pid)
            if anchors:
                a = anchors[int(rng.integers(len(anchors)))]
                state.allocate(len(placed), pid, g, a)
                placed.append((g, pid, a))
    return placed


def decision_loop(device, wrappers):
    """``DECISION_STEPS`` decisions over ``DECISION_GPUS`` GPUs on the card,
    from a prefilled fleet (so large requests are rejected): seeded releases
    of prefilled and decided requests, each guarded by its decision's
    ``accepted``, then ``mfi_select(use_kernel=True)`` and ``mfi_allocate``
    on the same occupancy; decisions logged on the card and read back once
    at the end, then replayed on a host ``ClusterState``."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.core import cluster, mig
    from repro_torch.sim import distributions

    m, steps = DECISION_GPUS, DECISION_STEPS
    rng = np.random.default_rng(0)
    placed = prefilled_fleet(m, rng)
    p0 = len(placed)  # request ids: the prefill 0 .. p0-1, arrival t is p0 + t
    arrivals = distributions.sample_profiles("uniform", steps, rng).astype(np.int32)
    releases = [[] for _ in range(steps)]
    # about a tenth of the prefill leaves during the loop, so the fleet stays full
    for j, at in enumerate(rng.integers(0, 10 * steps, p0).tolist()):
        if at < steps:
            releases[at].append(j)
    for t, life in enumerate(rng.integers(1, steps // 2 + 1, steps).tolist()):
        if t + life < steps:
            releases[t + life].append(p0 + t)
    host = mig.ClusterState(m)
    for j, (g, pid, a) in enumerate(placed):
        host.allocate(j, pid, g, a)
    pids_np = np.concatenate([np.array([p for _, p, _ in placed], np.int32), arrivals])
    pids = torch.as_tensor(pids_np, device=device)
    gpu = torch.as_tensor(np.array([g for g, _, _ in placed] + [0] * steps, np.int32),
                          device=device)
    anchor = torch.as_tensor(np.array([a for _, _, a in placed] + [0] * steps, np.int32),
                             device=device)
    ok = torch.as_tensor(np.arange(p0 + steps) < p0, device=device)
    occ = torch.as_tensor(host.occupancy_matrix(), device=device)
    start_slices = host.used_mem_slices
    cluster.mfi_allocate(occ, pids[p0])  # warm-up (tables, allocator)
    cluster.mfi_select(occ, pids[p0], use_kernel=True)
    agree = torch.ones((), dtype=torch.bool, device=device)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t in range(steps):
                for i in releases[t]:
                    freed = cluster.release(occ, gpu[i], pids[i], anchor[i])
                    occ = torch.where(ok[i], freed, occ)
                dk = cluster.mfi_select(occ, pids[p0 + t], use_kernel=True)
                occ, da = cluster.mfi_allocate(occ, pids[p0 + t])
                agree &= ((dk.gpu == da.gpu) & (dk.anchor == da.anchor)
                          & (dk.accepted == da.accepted) & (dk.delta_f == da.delta_f))
                gpu[p0 + t], anchor[p0 + t], ok[p0 + t] = dk.gpu, dk.anchor, dk.accepted
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    sync_msgs = sorted({str(w.message)[:120] for w in syncs
                        if "called a synchronizing CUDA operation" in str(w.message)})
    check(not sync_msgs, f"decision loop: host syncs inside the loop: {sync_msgs}")
    want = dict.fromkeys(wrappers, 0)
    want["mfi_delta"] = steps
    check(counts == want, f"decision loop: launch counts {counts} != expected {want}")
    check(bool(agree), "decision loop: a kernel decision differs from mfi_allocate's")
    g, a, k = gpu.cpu().numpy(), anchor.cpu().numpy(), ok.cpu().numpy()
    for t in range(steps):
        for i in releases[t]:
            if k[i]:
                host.release(i)
        if k[p0 + t]:
            host.allocate(p0 + t, int(pids_np[p0 + t]), int(g[p0 + t]), int(a[p0 + t]))
    check(np.array_equal(host.occupancy_matrix(), occ.cpu().numpy()),
          "decision loop: the card's occupancy differs from the host replay")
    accepted = int(k[p0:].sum())
    n_rel = sum(len(r) for r in releases)
    guarded = sum(1 for r in releases for i in r if not k[i])
    check(accepted < steps and guarded > 0,
          f"decision loop: {steps - accepted} rejections, {guarded} releases of rejected "
          "requests: the loop must exercise both")
    log(f"decision loop: {steps} decisions at M = {m} from a prefilled fleet ({p0} requests, "
        f"{start_slices} of {m * mig.NUM_MEM_SLICES} slices) ({accepted} accepted, "
        f"{steps - accepted} rejected, {n_rel} releases of which {guarded} guarded off, "
        f"{host.used_mem_slices} slices in use at the end) in {seconds:.2f} s, "
        f"{steps / seconds:.1f} steps/s; every kernel decision equals mfi_allocate's, no host "
        f"sync inside the loop, launches {counts}, end occupancy equals the host replay")
    return dict(steps=steps, gpus=m, prefill=p0, start_slices=start_slices,
                seconds=seconds, steps_per_s=steps / seconds, accepted=accepted,
                releases=n_rel, guarded_releases=guarded, end_slices=host.used_mem_slices,
                launches=counts["mfi_delta"])


def decision_rates(device):
    """``benchmarks/scheduler_scaling.py``'s decision latency on the card:
    its random 45 %-fill occupancy (same seed, same draws) at each of its
    fleet sizes and its profile 2 as a 0-d device tensor, both lowerings of
    ``mfi_select``, held to each other and to the host MFI scheduler."""
    import numpy as np
    import torch
    from repro_torch.core import cluster, mig
    from repro_torch.core.schedulers import make_scheduler

    rng = np.random.default_rng(0)
    pid = torch.tensor(SCALING_PID, dtype=torch.int32, device=device)
    host = make_scheduler("mfi")
    rates = {}
    for m in SCALING_GPUS:
        occ_np = (rng.random((m, mig.NUM_MEM_SLICES)) < MFI_DELTA_FILL).astype(np.int32)
        occ = torch.as_tensor(occ_np, device=device)
        dk = cluster.mfi_select(occ, pid, use_kernel=True)
        dd = cluster.mfi_select(occ, pid, use_kernel=False)
        check(all(torch.equal(x, y) for x, y in zip(dk, dd)),
              f"decision rate M = {m}: kernel {dk} != dense {dd}")
        state = mig.ClusterState(m)
        for g, gs in enumerate(state.gpus):
            gs.occupancy[:] = occ_np[g]
        want = host.select(state, SCALING_PID)
        got = (int(dk.gpu), int(dk.anchor)) if bool(dk.accepted) else None
        check(got == want, f"decision rate M = {m}: card {got} != host {want}")
        row = {}
        for name, use_kernel in (("kernel", True), ("dense", False)):
            def one():
                return cluster.mfi_select(occ, pid, use_kernel=use_kernel)
            call_ms = cuda_ms(one, 1000, warm=20)
            times = device_times(one, 50)
            row[name] = dict(decisions_per_s=1e3 / call_ms, call_ms=call_ms,
                             device_ms=sum(t for t, _ in times.values()) / 50 / 1e3,
                             device_ops=sum(c for _, c in times.values()) / 50)
        rates[m] = row
        log(f"decision rate at M = {m} (scheduler_scaling.py's state, profile "
            f"{SCALING_PID}, decision {got}): "
            + "; ".join(f"{k} lowering {r['decisions_per_s']:.1f}/s ({r['call_ms']:.4f} ms per "
                        f"decision, device {r['device_ms']:.4f} ms in {r['device_ops']:.1f} ops)"
                        for k, r in row.items()))
    return rates


def decision_phase(device, wrappers):
    import numpy as np
    from repro_torch import api
    from repro_torch.core.schedulers import make_scheduler
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig, run_simulation

    cfg = SimConfig(num_gpus=100, offered_load=1.0, seed=0)
    host = make_scheduler("mfi")
    arrivals = [0]
    host_select = host.select

    def counted(state, pid):
        arrivals[0] += 1
        return host_select(state, pid)

    host.select = counted
    t0 = time.perf_counter()
    want = run_simulation(host, cfg)
    host_s = time.perf_counter() - t0
    sched = card_scheduler(device)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = run_simulation(sched, cfg)
    card_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    check(results_equal(got, want), f"decision stream: {got} != host MFI {want}")
    expected = dict.fromkeys(wrappers, 0)
    expected["mfi_delta"] = arrivals[0]
    check(counts == expected and sched.calls == arrivals[0],
          f"decision stream: launch counts {counts} != expected {expected}")
    log(f"decision stream (M = 100, load 1.0, seed 0): {arrivals[0]} arrivals decided on the "
        f"card, mfi_delta launches {counts['mfi_delta']}; SimResult equal to the host MFI run "
        f"(acceptance {got.acceptance_rate:.4f}, allocated {got.allocated_workloads:.0f}, "
        f"frag {got.frag_severity:.3f}); every decision equal to the dense lowering and the "
        f"host scheduler; {card_s:.2f} s with three lowerings per arrival, host engine alone "
        f"{host_s:.2f} s")
    loop = decision_loop(device, wrappers)
    rates = decision_rates(device)

    for fn in wrappers.values():
        fn.launches = 0
    kw = dict(runs=64, num_gpus=100, offered_load=1.0, seed=0)
    via_api = api.simulate("mfi", engine="batched", **kw)
    api_counts = {k: fn.launches for k, fn in wrappers.items()}
    direct = batched.run_batched("mfi", SimConfig(num_gpus=100, offered_load=1.0, seed=0), runs=64)
    check(via_api.keys() == direct.keys()
          and all(np.array_equal(via_api[k], direct[k]) for k in direct),
          "api.simulate(engine='batched') differs from run_batched")
    check(api_counts["select_from_base"] > 0 and api_counts["fragscore"] > 0,
          f"api.simulate(engine='batched') did not run the kernels: {api_counts}")
    log(f"api.simulate('mfi', engine='batched', runs=64, M=100, load 1.0, seed 0) equals "
        f"run_batched; launches {api_counts}; acceptance {via_api['acceptance_rate']:.4f}")
    return dict(arrivals=arrivals[0], launches=counts["mfi_delta"], stream_s=card_s,
                host_s=host_s, loop=loop, rates=rates, api_launches=api_counts)


# ---------------------------------------------------------------------------
# phase 12: the LM training path
# ---------------------------------------------------------------------------


def plain_attention(q, k, v):
    """Untiled causal GQA attention in float32 from the same inputs, for
    plain autograd: the (B, H, S, S) probabilities are materialised."""
    import torch

    b, s, h, d = q.shape
    g = h // k.shape[2]
    kk = k.float().repeat_interleave(g, dim=2)
    vv = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), kk) * d ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, vv)


def flash_check(device, blk):
    """The flash Function's output and dq/dk/dv against plain autograd of
    the untiled attention at FLASH_SHAPE, float32 and bfloat16."""
    import torch
    from repro_torch.models import common

    b, s, h, kv, d = FLASH_SHAPE
    gen = torch.Generator(device).manual_seed(20)
    q, do = (torch.randn(b, s, h, d, generator=gen, device=device) for _ in range(2))
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=device) for _ in range(2))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ins = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        dod = do.to(dtype)

        def flash():
            o = common.blockwise_attention(*ins, blk_q=blk, blk_k=blk)
            return (o,) + torch.autograd.grad(o, ins, dod)

        ref_ins = [x.detach().float().requires_grad_() for x in ins]

        def plain():
            o = plain_attention(*ref_ins)
            return (o,) + torch.autograd.grad(o, ref_ins, dod.float())

        got, want = flash(), plain()
        errs = {}
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            check(g.dtype == dtype and g.shape == w.shape, f"train: flash {name} {g.dtype} {g.shape}")
            w = w.detach()
            err = (g.detach().float() - w).abs()
            scale = float(w.abs().max())
            if dtype == torch.float32:
                check(float(err.max()) <= TRAIN_F32_RTOL * max(1.0, scale),
                      f"train: flash f32 {name} error {float(err.max())} at scale {scale}")
            else:
                bad = err > BF16_ATOL + BF16_RTOL * w.abs()
                check(not bool(bad.any()), f"train: flash bf16 {name} error {float(err.max())}")
            errs[name] = (float(err.max()), scale)
        del got, want
        flash_ms, plain_ms = cuda_ms(flash, 3, warm=1), cuda_ms(plain, 3, warm=1)
        tag = str(dtype).removeprefix("torch.")
        out[tag] = dict(errors={n: e for n, (e, _) in errs.items()}, flash_fwd_bwd_ms=flash_ms,
                        plain_fwd_bwd_ms=plain_ms)
        log(f"train: flash attention {tag} (B {b}, S {s}, H {h}, KV {kv}, D {d}, tiles {blk}) "
            f"vs plain autograd of the untiled attention: max abs err "
            + ", ".join(f"{n} {e:.3e} (|plain| <= {sc:.3g})" for n, (e, sc) in errs.items())
            + f"; forward + backward {flash_ms:.3f} ms (plain {plain_ms:.3f} ms)")
    return out


def smoke_step_check(device):
    """One SMOKE train step on the card against the same step on the CPU
    (float32, TF32 off): the loss, every gradient leaf, and the parameters
    after ``adamw_update`` at lr SMOKE_STEP_LR, under the reference's
    initialiser and with the weight matrices scaled by 0.1."""
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw_init, adamw_update

    cfg = SMOKES[TRAIN_ARCH]
    cpu = torch.device("cpu")
    tree = model.params_to_tree(model.init_params(cfg, torch.Generator().manual_seed(0), cpu), cfg)
    batch = next(make_batch_iterator(cfg, 8, 128, seed=0))
    out = {}
    for scale, grad_tol in ((1.0, SMOKE_GRAD_TOL), (0.1, SMOKE_TAMED_GRAD_TOL)):
        runs = {}
        for dev in (cpu, device):
            params = model.params_from_numpy(scaled_tree(tree, scale), cfg, dev)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, grads = steps.loss_and_grads(params, b, cfg)
            adamw_update(params, grads, adamw_init(params), lr=SMOKE_STEP_LR)
            runs[dev.type] = (float(loss), grads, dict(params.named_parameters()))
        (hl, hg, hp), (cl, cg, cp) = runs["cpu"], runs[device.type]
        gworst = pworst = 0.0  # as shares of their limits
        for name in hg:
            w = hg[name].float()
            err = float((cg[name].cpu().float() - w).abs().max())
            gworst = max(gworst, err / (grad_tol * float(w.abs().max())))
            w = hp[name].detach().float()
            err = float((cp[name].detach().cpu().float() - w).abs().max())
            pworst = max(pworst, err / (1e-5 * float(w.abs().max()) + 2 * SMOKE_STEP_LR))
        log(f"train: SMOKE step, weights x{scale:g}, card vs CPU (f32, TF32 off): loss {cl:.7f} vs "
            f"{hl:.7f}; worst gradient leaf at {gworst:.3f} of its limit ({grad_tol:g} of the "
            f"leaf's largest magnitude); parameters after AdamW (lr {SMOKE_STEP_LR:g}) at "
            f"{pworst:.3f} of theirs (1e-5·|p| + 2·lr)")
        check(abs(cl - hl) <= 1e-5 * abs(hl), f"train: smoke loss card {cl} vs cpu {hl}")
        check(gworst <= 1.0 and pworst <= 1.0, f"train: smoke step x{scale:g} card vs CPU past its limits")
        key = "reference_init" if scale == 1.0 else "tamed"
        out[key] = dict(loss_card=cl, loss_cpu=hl, grad_share_of_limit=gworst,
                        param_share_of_limit=pworst)
    return out


def scaled_tree(t, scale):
    """A parameter tree with its weight matrices (not the norms) times
    ``scale``."""
    if isinstance(t, dict):
        return {k: scaled_tree(v, scale) for k, v in t.items()}
    return t * scale if t.dim() > 1 else t.clone()


def smoke_arch_steps(device, archs=SMOKE_ARCH_STEPS, tag="train"):
    """One SMOKE step of each of ``archs`` ({arch: (batch, sequence)}) on
    the card against the CPU, weights scaled by 0.1 (float32, TF32 off):
    by default gemma3 (post-norms, its window of 32 on
    blockwise_attention's local path at S = 1,024) and paligemma (128
    tokens behind 16 patches, the patch labels padded): the loss and every
    gradient leaf of ``loss_and_grads``, then ``steps.train_step`` on the
    card, whose loss must be that loss."""
    import math
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw_init

    cpu = torch.device("cpu")
    out = {}
    for arch, (batch_size, seq) in archs.items():
        cfg = SMOKES[arch]
        tree = model.params_to_tree(model.init_params(cfg, torch.Generator().manual_seed(0), cpu),
                                    cfg)
        tree = scaled_tree(tree, 0.1)
        batch = next(make_batch_iterator(cfg, batch_size, seq, seed=0))
        runs = {}
        for dev in (cpu, device):
            params = model.params_from_numpy(tree, cfg, dev)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, grads = steps.loss_and_grads(params, b, cfg)
            runs[dev.type] = (float(loss), grads, params, b)
        (hl, hg, _, _), (cl, cg, params, b) = runs["cpu"], runs[device.type]
        worst = max(float((cg[n].cpu().float() - hg[n].float()).abs().max())
                    / (SMOKE_TAMED_GRAD_TOL * float(hg[n].abs().max())) for n in hg)
        t0 = time.perf_counter()
        _, _, metrics = steps.train_step(params, adamw_init(params), b, cfg)
        step_loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
        log(f"{tag}: SMOKE {arch} (B {batch_size}, S {seq}{', window ' + str(cfg.window) if cfg.local_global else ''}"
            f"{', ' + str(cfg.num_patches) + ' patches' if cfg.frontend == 'vision' else ''}"
            f"{', ' + str(seq) + ' frames' if cfg.encdec else ''}), weights x0.1, "
            f"card vs CPU: loss {cl:.7f} vs {hl:.7f}; worst gradient leaf at {worst:.3f} of its "
            f"limit ({SMOKE_TAMED_GRAD_TOL:g} of the leaf's largest magnitude); train_step on the "
            f"card: loss {step_loss:.7f} in {step_s:.2f} s")
        check(abs(cl - hl) <= 1e-5 * abs(hl), f"{tag}: SMOKE {arch} loss card {cl} vs cpu {hl}")
        check(worst <= 1.0, f"{tag}: SMOKE {arch} gradients card vs CPU past their limit")
        check(math.isfinite(step_loss) and abs(step_loss - cl) <= 1e-5 * abs(cl),
              f"{tag}: SMOKE {arch} train_step loss {step_loss} vs {cl}")
        out[arch] = dict(loss_card=cl, loss_cpu=hl, grad_share_of_limit=worst,
                         train_step_loss=step_loss)
    return out


def launcher_run(argv):
    """``launch/train.py``'s ``main(argv)`` on the card, its lines echoed;
    returns (its return value, its lines, seconds)."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import train

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        learned = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {line}")
    return learned, lines, seconds


def annotated(fn, name):
    """``fn`` run inside a profiler range ``name``."""
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return run


def mark(name):
    """A zero-length profiler range: a timestamp on the calling thread."""
    from torch.profiler import record_function

    with record_function(name):
        pass


def backward_marked(fn, name):
    """``fn(x, ...)`` inside the profiler range ``train:<name>``, its
    backward delimited by hooks on its output (its first, for a tuple: the
    gradient arrives, the backward starts) and on ``x`` (the gradient
    leaves: it ends).  A rematerialised forward registers no hook where
    grad mode is off."""

    def run(x, *args, **kwargs):
        out = annotated(fn, f"train:{name}")(x, *args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        if first.requires_grad and x.requires_grad:
            first.register_hook(lambda g: mark(f"train:{name}-backward-start"))
            x.register_hook(lambda g: mark(f"train:{name}-backward-end"))
        return out

    return run


#: the attention whose flash tiles run now, pushed by the encoder-decoder's
#: layers under :func:`training_annotations`: the tiles' ranges take its name
ATTENTION_KIND: list = []


def attention_kind(fn, kind, nested=False):
    """``fn`` run with ``kind`` on top of ATTENTION_KIND (only inside
    another kind's span when ``nested``: the decoder-only stack's
    attention keeps the plain name)."""

    def run(*args, **kwargs):
        if nested and not ATTENTION_KIND:
            return fn(*args, **kwargs)
        ATTENTION_KIND.append(kind)
        try:
            return fn(*args, **kwargs)
        finally:
            ATTENTION_KIND.pop()

    return run


@contextlib.contextmanager
def training_annotations():
    """Profiler ranges around each layer's forward, the flash Function's
    forward and backward (named by the attention that runs it: the
    encoder's, the decoder's self- or cross-attention, or plain
    ``attention`` in a decoder-only stack), the cross-entropy, the MoE
    layer and its expert products, the SSD chunk scan (each backward
    delimited by hooks, :func:`backward_marked`) and the optimizer, for
    :func:`step_split`."""
    from torch.profiler import record_function
    from repro_torch.launch import steps
    from repro_torch.models import common, encdec, moe, ssm, transformer

    F = common._FlashQTile
    saved = (F.__dict__["forward"], F.__dict__["backward"], common.chunked_ce_loss,
             steps.adamw_update, moe.moe_layer, moe._expert_ffn_batched,
             transformer.layer_forward, ssm.ssd_scan, encdec._enc_layer, encdec._dec_layer,
             transformer.attention_block)

    def ce_loss(x, *args, **kwargs):
        return backward_marked(saved[2], "ce")(x, *args, **kwargs)

    def moe_layer(p, x, cfg):
        return backward_marked(lambda x: saved[4](p, x, cfg), "moe")(x)

    def experts(p, x, cfg):
        return backward_marked(lambda x: saved[5](p, x, cfg), "experts")(x)

    def tile_forward(ctx, *args):
        ctx.kind = ATTENTION_KIND[-1] if ATTENTION_KIND else "attention"
        with record_function(f"train:{ctx.kind}"):
            return saved[0].__func__(ctx, *args)

    def tile_backward(ctx, *args):
        with record_function(f"train:{ctx.kind}"):
            return saved[1].__func__(ctx, *args)

    F.forward = staticmethod(tile_forward)
    F.backward = staticmethod(tile_backward)
    common.chunked_ce_loss = ce_loss
    steps.adamw_update = annotated(saved[3], "train:optimizer")
    moe.moe_layer, moe._expert_ffn_batched = moe_layer, experts
    transformer.layer_forward = annotated(saved[6], "train:layer")
    ssm.ssd_scan = backward_marked(saved[7], "ssd")
    encdec._enc_layer = attention_kind(saved[8], "encoder-attention")
    encdec._dec_layer = attention_kind(saved[9], "cross-attention")
    transformer.attention_block = attention_kind(saved[10], "self-attention", nested=True)
    try:
        yield
    finally:
        (F.forward, F.backward, common.chunked_ce_loss, steps.adamw_update, moe.moe_layer,
         moe._expert_ffn_batched, transformer.layer_forward, ssm.ssd_scan, encdec._enc_layer,
         encdec._dec_layer, transformer.attention_block) = saved


MATMUL_KERNEL_WORDS = ("gemm", "nvjet", "xmma", "cutlass", "wgmma")


#: step_split's categories of ranges; "layer" (a transformer layer's
#: forward, recomputed inside the next part's backward) falls through to
#: the kernel-name split
SPLIT_CATEGORIES = ("attention", "encoder-attention", "self-attention", "cross-attention", "ce",
                    "optimizer", "experts", "moe", "ssd", "layer")


def step_split(prof, wall_s):
    """Device time of a profiled step by what launched each kernel:
    attention (the flash Function, forward and backward; the
    encoder-decoder's split into its encoder's, its decoder's self- and its
    cross-attention), CE (the loss and its backward), optimizer, the expert
    products and the rest of the MoE layer (routing, dispatch and the route
    back, forward and backward), the SSD chunk scan (``ssm.ssd_scan``,
    forward and backward), and the rest split into matmul kernels
    (projections and MLP) and other kernels.  Categories that hold no time
    are left out.  A kernel belongs to the innermost range (the
    latest-started) that holds the start of the CPU operator that launched it, on that
    operator's thread: an expert product inside the MoE layer's range, a
    layer recomputed inside a backward span (rematerialisation) to that
    layer.  The ranges' own device-side spans (GPU user annotations) are
    not kernels and are left out."""
    import bisect
    from torch.autograd import DeviceType

    ops, kernels, spans, marks = {}, [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("train:"):
                kernels.append((e.linked_correlation_id(), e.name(), e.duration_ns()))
            continue
        if e.linked_correlation_id() > 0:  # a runtime call, not an operator
            continue
        name, thread = e.name(), e.start_thread_id()
        ops[e.correlation_id()] = (thread, e.start_ns())
        if name.endswith(("-backward-start", "-backward-end")):
            marks.append((name[6:name.index("-backward")], thread, e.start_ns(),
                          name.endswith("start")))
        elif name.startswith("train:"):
            spans.setdefault((name[6:], thread), []).append((e.start_ns(), e.end_ns()))
    open_at = {}
    for cat, thread, ns, start in sorted(marks, key=lambda m: m[2]):
        if start:
            open_at.setdefault((cat, thread), ns)
        elif (cat, thread) in open_at:
            spans.setdefault((cat, thread), []).append((open_at.pop((cat, thread)), ns))
    merged = {}
    for key, ivs in spans.items():
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[key] = ([a for a, _ in out], [b for _, b in out])

    def opened(key, ns):
        """The start of ``key``'s range holding ``ns``, or None."""
        if key not in merged or ns is None:
            return None
        starts, ends = merged[key]
        i = bisect.bisect_right(starts, ns) - 1
        return starts[i] if i >= 0 and ns <= ends[i] else None

    totals, by_name = {}, {}
    for corr, name, dur in kernels:
        thread, ns = ops.get(corr, (None, None))
        held = [(at, c) for c in SPLIT_CATEGORIES
                if (at := opened((c, thread), ns)) is not None]
        cat = max(held)[1] if held else None
        if cat in (None, "layer"):
            cat = "matmul" if any(w in name.lower() for w in MATMUL_KERNEL_WORDS) else "other"
        totals[cat] = totals.get(cat, 0) + dur
        t, c = by_name.get(name, (0, 0))
        by_name[name] = (t + dur, c + 1)
    busy = sum(totals.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(
        busy_ms=busy / 1e6, wall_ms=wall_s * 1e3, busy_share=busy / 1e9 / wall_s,
        kernels=len(kernels),
        shares={c: totals.get(c, 0) / max(busy, 1)
                for c in SPLIT_CATEGORIES[:-1] + ("matmul", "other")
                if totals.get(c) or c in ("matmul", "other")},
        top=[dict(name=n[:80], ms=t / 1e6, count=c) for n, (t, c) in top])


def encdec_flops(cfg, batch_size):
    """``(6·N·tokens, attention)`` FLOPs of one encoder-decoder training
    step at TRAIN_SEQ = S_enc + S_dec (forward and backward, 6 a
    multiply-add, as :func:`mixer_flops`): the encoder's parameters over
    the frames and the decoder's (the rest of ``param_count``) over the
    tokens; the attention products over the keys each query sees: the
    encoder's full S_enc², the decoder's causal S_dec²/2 and the
    cross-attention's S_dec·S_enc, each layer's over H·hd."""
    half = TRAIN_SEQ // 2
    d, f, hd, h, kv = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    enc_layer = d * hd * (h + 2 * kv) + h * hd * d + d * f * 2 + 2 * d
    n_enc = cfg.n_enc_layers * enc_layer + d  # + enc_norm
    n_dec = cfg.param_count() - n_enc
    dense = 6 * batch_size * half * (n_enc + n_dec)
    pairs = half * half * (2 * cfg.n_enc_layers + cfg.n_layers + 2 * cfg.n_layers)
    return dense, 6 * batch_size * pairs * h * hd


def mixer_flops(cfg, tokens):
    """``(attention, ssd)`` FLOPs of one training step (forward and
    backward, 6 a multiply-add) beyond 6·N·tokens, at TRAIN_SEQ: each
    attention layer's logits and values over the keys its queries see (S
    for a global layer, the window for a local one), and each SSD block's
    chunk products (C·B over the chunk, the decayed scores against x, the
    chunk states and the states read back: Q·N + Q·H·P + 2·N·H·P a
    token)."""
    n_local, n_global = cfg.group_pattern
    keys = cfg.n_groups * (n_global * TRAIN_SEQ + n_local * min(cfg.window, TRAIN_SEQ))
    attn = 0 if cfg.family == "ssm" else 6 * tokens * keys * cfg.n_heads * cfg.head_dim
    ssd = 0
    if cfg.family in ("ssm", "hybrid"):
        q, n, hp = min(cfg.ssm_chunk, TRAIN_SEQ), cfg.ssm_state, cfg.ssm_dinner
        ssd = 6 * tokens * cfg.n_layers * (q * n + q * hp + 2 * n * hp)
    return attn, ssd


def train_run(device, wrappers, cfg, batch_size, accum, steps_n, cut_from, tag="train"):
    """``steps.train_step`` at train_4k's sequence length: ``steps_n``
    timed steps of a global batch of ``batch_size`` sequences as ``accum``
    micro-batches, then a step of one micro-batch, unprofiled and under the
    profiler.  Model FLOPs count the active parameters (all of them for a
    dense model), as the reference's ``launch/dryrun.py`` does."""
    import dataclasses
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(cfg, grad_accum=accum)
    t0 = time.perf_counter()
    # the encoder-decoder splits train_4k's S into S_enc frames + S_dec tokens
    seq = TRAIN_SEQ // 2 if cfg.encdec else TRAIN_SEQ
    data = make_batch_iterator(cfg, batch_size, seq, seed=0)
    batches = [next(data) for _ in range(steps_n + 1)]
    sample_s = time.perf_counter() - t0
    params = model.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    opt = adamw_init(params, cfg.opt_dtype)
    n_alloc = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    moment_bytes = sum(t.numel() * t.element_size() for m in ("m", "v") for t in opt[m].values())
    # params, their accumulated gradients, one micro-batch's gradients, moments
    reckoned = 3 * param_bytes + moment_bytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    step_s, losses = [], []
    for b in batches[:steps_n]:
        tb = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, metrics = steps.train_step(params, opt, tb, cfg)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        check(math.isfinite(loss), f"{tag}: train_4k loss {loss} at step {len(losses)}")
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    check(not any(counts.values()), f"{tag}: the training path launched kernels {counts}")

    # the profiled window: one step of one micro-batch (grad_accum 1), run
    # once unprofiled for its wall time; a whole step of llama3.2-1b holds
    # ~400k kernels, which the profiler takes ~40 s to collect and read
    micro = dataclasses.replace(cfg, grad_accum=1)
    tb = {k: torch.as_tensor(v[:batch_size // accum], device=device)
          for k, v in batches[-1].items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, opt, metrics = steps.train_step(params, opt, tb, micro)
    float(metrics["loss"])
    torch.cuda.synchronize()
    micro_wall = time.perf_counter() - t
    with training_annotations():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, metrics = steps.train_step(params, opt, tb, micro)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t
    check(math.isfinite(loss), f"{tag}: profiled train_4k loss {loss}")
    t = time.perf_counter()
    split = step_split(prof, prof_wall)
    split_s = time.perf_counter() - t
    split["unprofiled_wall_ms"] = micro_wall * 1e3
    split["busy_share_unprofiled"] = split["busy_ms"] / 1e3 / micro_wall

    tokens = batch_size * TRAIN_SEQ  # the encoder-decoder's frames and tokens
    n = cfg.active_param_count()
    if cfg.encdec:
        (dense_flops, attn_flops), ssd_flops = encdec_flops(cfg, batch_size), 0
    else:
        attn_flops, ssd_flops = mixer_flops(cfg, tokens)
        dense_flops = 6 * n * tokens
    flops = dense_flops + attn_flops + ssd_flops
    warm = step_s[1:] if len(step_s) > 1 else step_s
    ms = 1e3 * sum(warm) / len(warm)
    out = dict(
        arch=cfg.name, seq=TRAIN_SEQ, global_batch=batch_size, micro_batch=batch_size // accum,
        grad_accum=accum, cut_from_global_batch=cut_from, steps=steps_n,
        losses=losses, first_step_ms=1e3 * step_s[0], ms_per_step=ms,
        tokens_per_s=tokens / (ms / 1e3), sample_s=sample_s, params=n_alloc,
        param_count=cfg.param_count(), active_param_count=n,
        state_gb=(param_bytes + moment_bytes) / 1e9,
        reckoned_gb=reckoned / 1e9, base_gb=base / 1e9, peak_gb=peak / 1e9,
        model_flops=flops, attention_flops=attn_flops, ssd_flops=ssd_flops,
        bf16_peak_share=flops / (ms / 1e3) / BF16_DENSE_OPS_PER_S, profile=split,
        profiled_loss=loss, split_s=split_s)
    log(f"{tag}: train_4k length, {cfg.name} bf16 at its published widths ({n_alloc} parameters, "
        f"{cfg.opt_dtype} moments), global batch {batch_size} (cut from train_4k's {cut_from}) as "
        f"{accum} micro-batches of {batch_size // accum} x "
        f"{f'({seq} frames + {seq} tokens)' if cfg.encdec else f'{TRAIN_SEQ} tokens'}; "
        f"{len(batches)} batches sampled in {sample_s:.2f} s (not timed)")
    log(f"{tag}: {steps_n} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; first "
        f"step {out['first_step_ms']:.1f} ms, then {ms:.1f} ms/step, {out['tokens_per_s']:.1f} "
        f"tokens/s; model FLOPs {flops:.4e} a step ("
        + ("6·(N_enc·frames + N_dec·tokens)" if cfg.encdec else
           f"6·N·tokens with N = {n} active parameters")
        + f" {dense_flops:.4e}, plus attention {attn_flops:.4e} and the SSD's chunk products "
        f"{ssd_flops:.4e}) = "
        f"{100 * out['bf16_peak_share']:.2f}% of the bf16 dense peak (989 TFLOP/s)")
    log(f"{tag}: device memory: {base / 1e9:.3f} GB before the steps (parameters "
        f"{param_bytes / 1e9:.3f} + moments {moment_bytes / 1e9:.3f}), peak {peak / 1e9:.3f} GB "
        f"(reckoned: parameters, accumulated and micro-batch gradients, moments = "
        f"{reckoned / 1e9:.3f} GB, plus activations)")
    log(f"{tag}: profiled window, one step of one micro-batch ({batch_size // accum} x "
        f"{TRAIN_SEQ}, grad_accum 1): device busy {split['busy_ms']:.1f} ms of "
        f"{split['wall_ms']:.1f} ms profiled wall ({100 * split['busy_share']:.1f}%) and of "
        f"{split['unprofiled_wall_ms']:.1f} ms unprofiled ({100 * split['busy_share_unprofiled']:.1f}%), "
        f"{split['kernels']} kernels; by what launched them: "
        + ", ".join(f"{c} {100 * s:.1f}%" for c, s in split["shares"].items())
        + f"; split read in {split_s:.1f} s")
    log(f"{tag}: top device ops: " + "; ".join(
        f"{t['name'][:60]} {t['ms']:.1f} ms x{t['count']}" for t in split["top"]))
    return out


def training_phase(device, wrappers):
    """The LM training path: flash attention against plain autograd, one
    SMOKE step card vs CPU, the smoke launcher, then full width."""
    import gc
    import math
    import re
    import torch
    from repro_torch.configs import ARCHS

    cfg = ARCHS[TRAIN_ARCH]
    out = dict(flash=flash_check(device, cfg.attn_blk), smoke_step=smoke_step_check(device),
               smoke_archs=smoke_arch_steps(device))

    learned, lines, seconds = launcher_run(
        ["--arch", TRAIN_ARCH, "--smoke", "--steps", "50", "--batch", "8", "--seq", "128"])
    check(bool(learned) and lines[-1].endswith("(LEARNING)"), f"train: smoke launcher: {lines[-1]}")
    out["smoke_launcher"] = dict(seconds=seconds, last=lines[-1])
    log(f"train: launch/train.py --smoke --steps 50 --batch 8 --seq 128 in {seconds:.2f} s: LEARNING")

    learned, lines, seconds = launcher_run(
        ["--arch", TRAIN_ARCH, "--steps", "5", "--batch", "8", "--seq", "128"])
    numbers = [float(x) for line in lines for x in re.findall(r"loss (\S+)", line)]
    numbers += [float(x) for x in re.findall(r"-> (\S+)", lines[-1])]
    check(len(numbers) >= 4 and all(math.isfinite(x) for x in numbers),
          f"train: full-width launcher losses {numbers}")
    out["full_width_launcher"] = dict(seconds=seconds, last=lines[-1], losses=numbers)
    log(f"train: launch/train.py --arch {TRAIN_ARCH} --steps 5 --batch 8 --seq 128 (full width) "
        f"in {seconds:.2f} s, every loss finite")
    gc.collect()
    torch.cuda.empty_cache()

    out["train_4k"] = train_run(device, wrappers, cfg, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS,
                                TRAIN_CUT_FROM)
    return out


# ---------------------------------------------------------------------------
# phase 13: the dense layer options at full width
# ---------------------------------------------------------------------------


def draw_model(arch, device):
    """``arch`` at its published widths in bf16 from a Generator seeded 0:
    (config, module, weight bytes, seconds)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import model

    cfg = ARCHS[arch]
    t0 = time.perf_counter()
    params = model.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    return cfg, params, weight_bytes, time.perf_counter() - t0


def release():
    """Return the memory of a model the caller dropped before the next one
    is drawn."""
    import gc
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def dense_requests(cfg, prompts, new, seed):
    """SERVE_SLOTS requests for each prompt length in turn (a wave each),
    profiles of the uniform mix, random prompts, from one numpy generator."""
    import numpy as np
    from repro_torch.core import mig
    from repro_torch.serving import Request
    from repro_torch.sim import distributions

    rng = np.random.default_rng(seed)
    n = SERVE_SLOTS * len(prompts)
    profiles = distributions.sample_profiles("uniform", n, rng)
    return [Request(request_id=i,
                    prompt=rng.integers(0, cfg.vocab, prompts[i // SERVE_SLOTS]).astype(np.int32),
                    max_new_tokens=new, profile=mig.PROFILE_NAMES[profiles[i]])
            for i in range(n)]


def attention_layers(cfg) -> int:
    """Layers with attention: all but an ssm model's (its layers are SSD
    blocks only)."""
    return 0 if cfg.family == "ssm" else cfg.n_layers


def dense_serve(cfg, params, prompts, new, device, wrappers, seed=0):
    """One wave of SERVE_SLOTS requests per prompt length through
    ``ServingEngine.run`` behind MIG admission (SERVE_GPUS A100-80GB, mfi),
    launch counts reset just before and read just after; every request
    admitted and served, every logit finite, ``decode_attention`` launched
    once per layer with attention and decode step.  Returns the wave's
    timings."""
    import torch
    from repro_torch.serving import ServingEngine

    engine = ServingEngine(cfg, params, num_slots=SERVE_SLOTS, max_len=max(prompts) + new + 1,
                           num_gpus=SERVE_GPUS, policy="mfi", device=device)
    prefill_s, decode_s, waves_at, finite = [], [], [], []

    def watched(fn, seconds):
        timed_fn = timed_calls(fn, seconds)

        def call(*args):
            if seconds is prefill_s:
                waves_at.append(len(decode_s))
            out = timed_fn(*args)
            finite.append(bool(torch.isfinite(out[0]).all()))
            return out

        return call

    engine._prefill = watched(engine._prefill, prefill_s)
    engine._decode = watched(engine._decode, decode_s)
    requests = dense_requests(cfg, prompts, new, seed)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = engine.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    want = dict.fromkeys(wrappers, 0)
    want["decode_attention"] = attention_layers(cfg) * len(decode_s)
    check(counts == want, f"dense {cfg.name}: launch counts {counts} != expected {want}")
    check(stats["waves"] == len(prompts) == len(prefill_s) and all(finite),
          f"dense {cfg.name}: {stats['waves']} waves, finite logits {all(finite)}")
    for r in requests:
        check(r.finished and r.admitted and len(r.output) == new
              and all(0 <= t < cfg.vocab for t in r.output),
              f"dense {cfg.name}: request {r.request_id} ended {r.admitted, r.finished, r.output}")
    check(engine.admission.cluster.used_mem_slices == 0, f"dense {cfg.name}: slices left")
    bounds = waves_at + [len(decode_s)]
    waves = [dict(prompt=p, prefill_ms=1e3 * prefill_s[i],
                  decode_ms_per_step=1e3 * sum(decode_s[bounds[i]:bounds[i + 1]])
                  / max(1, bounds[i + 1] - bounds[i]), decode_steps=bounds[i + 1] - bounds[i])
             for i, p in enumerate(prompts)]
    return dict(waves=waves, launches=counts["decode_attention"], run_s=wall, stats=stats)


def decode_window(cfg, params, device, prompt, max_len, n_steps, extra=None):
    """A profiled window of ``n_steps`` decode steps of one wave of
    SERVE_SLOTS prompts of ``prompt`` tokens (and the batch entries of
    ``extra``, an encoder-decoder's frames), its caches padded to
    ``max_len`` (gemma3's local caches then past the window: every step
    reads keys from start = pos - window + 1), then the same steps
    unprofiled: device busy, wall, ops per step."""
    import torch
    from repro_torch.models import model

    gen = torch.Generator(device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (SERVE_SLOTS, prompt), generator=gen,
                           device=device, dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": tokens, **(extra or {})}, cfg)
    cache = model.pad_cache(cache, prompt, max_len)
    token = torch.argmax(logits, dim=-1).to(torch.int32)

    def steps():
        t = token
        for i in range(n_steps):
            lg, _ = model.decode_step(params, cache, t, prompt + i, cfg)
            t = torch.argmax(lg, dim=-1).to(torch.int32)
        return t

    times = device_times(steps, 1)
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(t for t, _ in times.values()) / 1e3
    ops = sum(c for _, c in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(window_busy_ms=busy_ms, window_wall_ms=wall_ms, busy_share=busy_ms / wall_ms,
                device_ops_per_step=ops / n_steps,
                top=[(k[:48], t / c, c) for k, (t, c) in top])


def dense_options_phase(device, wrappers):
    """The dense layer options at full width, one model at a time, each
    freed before the next: gemma3-12b served behind MIG admission on a wave
    at its window and one at twice it, qwen3-14b, starcoder2-15b and
    llama3.2-1b-sw on a short wave each (llama3.2-1b-sw also one prompt of
    8,192 tokens, the local path at its window of 4,096), paligemma-3b
    prefilled at 256 patches + 128 tokens and decoded through ``model``."""
    import torch
    from repro_torch.models import model

    out, launches = {}, 0

    cfg, params, wbytes, draw_s = draw_model("gemma3-12b", device)
    check(cfg.window == DENSE_WINDOW and DENSE_LONG_PROMPT > cfg.attn_blk + cfg.window,
          "dense: gemma3-12b's window or tiles moved")
    warm = dense_serve(cfg, params, [DENSE_RING_PROMPT], 3, device, wrappers, seed=1)
    served = dense_serve(cfg, params, [DENSE_RING_PROMPT, DENSE_LONG_PROMPT], DENSE_NEW, device,
                         wrappers)
    launches += served["launches"]
    check(served["launches"] == cfg.n_layers * sum(w["decode_steps"] for w in served["waves"]),
          "dense: gemma3-12b launches")
    window = decode_window(cfg, params, device, DENSE_RING_PROMPT,
                           DENSE_LONG_PROMPT + DENSE_NEW + 1, DENSE_WINDOW_STEPS)
    out["gemma3-12b"] = dict(weights_gb=wbytes / 1e9, draw_s=draw_s, warm_run_s=warm["run_s"],
                             **served, **window)
    for w in served["waves"]:
        log(f"dense: gemma3-12b wave of {SERVE_SLOTS} x {w['prompt']}-token prompts, "
            f"{DENSE_NEW} new tokens: prefill {w['prefill_ms']:.3f} ms, decode "
            f"{w['decode_ms_per_step']:.3f} ms/step over {w['decode_steps']} steps")
    log(f"dense: gemma3-12b ({cfg.n_layers} layers, {cfg.group_pattern} local/global, window "
        f"{cfg.window}, {wbytes / 1e9:.3f} GB of bf16 weights drawn in {draw_s:.2f} s) served "
        f"behind admission in {served['run_s']:.3f} s: decode_attention launches "
        f"{served['launches']} = {cfg.n_layers} x "
        f"{sum(w['decode_steps'] for w in served['waves'])}; stats {served['stats']}")
    log(f"dense: gemma3-12b window ({DENSE_WINDOW_STEPS} decode steps from position "
        f"{DENSE_RING_PROMPT}, start > 0): device busy {window['window_busy_ms']:.3f} ms of "
        f"{window['window_wall_ms']:.3f} ms wall ({100 * window['busy_share']:.1f}% busy), "
        f"{window['device_ops_per_step']:.1f} device ops/step; top: "
        + "; ".join(f"{k} {t:.1f} us x{c}" for k, t, c in window["top"]))
    del params
    release()

    for arch in ("qwen3-14b", "starcoder2-15b", "llama3.2-1b-sw"):
        cfg, params, wbytes, draw_s = draw_model(arch, device)
        served = dense_serve(cfg, params, [DENSE_PROMPT], DENSE_SHORT_NEW, device, wrappers)
        launches += served["launches"]
        row = dict(weights_gb=wbytes / 1e9, draw_s=draw_s, **served)
        w = served["waves"][0]
        log(f"dense: {arch} ({cfg.n_layers} layers, {wbytes / 1e9:.3f} GB drawn in {draw_s:.2f} s) "
            f"wave of {SERVE_SLOTS} x {DENSE_PROMPT}-token prompts, {DENSE_SHORT_NEW} new tokens "
            f"in {served['run_s']:.3f} s: prefill {w['prefill_ms']:.3f} ms, decode "
            f"{w['decode_ms_per_step']:.3f} ms/step, decode_attention launches "
            f"{served['launches']}, logits finite")
        if arch == "llama3.2-1b-sw":
            for fn in wrappers.values():
                fn.launches = 0
            gen = torch.Generator(device).manual_seed(4)
            tokens = torch.randint(0, cfg.vocab, (1, DENSE_SW_PROMPT), generator=gen,
                                   device=device, dtype=torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cfg)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            check(cache["local"]["k"].shape[2] == cfg.window, "dense: llama3.2-1b-sw ring slots")
            cache = model.pad_cache(cache, DENSE_SW_PROMPT, DENSE_SW_PROMPT + DENSE_SHORT_NEW)
            finite = [bool(torch.isfinite(logits).all())]
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            for i in range(DENSE_SHORT_NEW):
                logits, _ = model.decode_step(params, cache, token, DENSE_SW_PROMPT + i, cfg)
                finite.append(bool(torch.isfinite(logits).all()))
                token = torch.argmax(logits, dim=-1).to(torch.int32)
            n = wrappers["decode_attention"].launches
            check(all(finite) and n == cfg.n_layers * DENSE_SHORT_NEW,
                  f"dense: llama3.2-1b-sw at {DENSE_SW_PROMPT}: finite {all(finite)}, launches {n}")
            launches += n
            row["long_prompt"] = dict(prompt=DENSE_SW_PROMPT, prefill_ms=prefill_ms, launches=n)
            log(f"dense: llama3.2-1b-sw one {DENSE_SW_PROMPT}-token prompt (local path, ring of "
                f"{cfg.window} slots): prefill {prefill_ms:.3f} ms, {DENSE_SHORT_NEW} decode steps, "
                f"decode_attention launches {n}, logits finite")
            del cache, logits
        out[arch] = row
        del params
        release()

    cfg, params, wbytes, draw_s = draw_model("paligemma-3b", device)
    check(cfg.num_patches == DENSE_PATCHES, "dense: paligemma-3b's patches moved")
    gen = torch.Generator(device).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (SERVE_SLOTS, DENSE_PROMPT), generator=gen,
                                     device=device, dtype=torch.int32),
             "patches": torch.randn(SERVE_SLOTS, cfg.num_patches, cfg.d_model, generator=gen,
                                    device=device).to(cfg.torch_dtype)}
    seq = cfg.num_patches + DENSE_PROMPT
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache = model.pad_cache(cache, seq, seq + DENSE_SHORT_NEW)
    finite = [bool(torch.isfinite(logits).all())]
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(DENSE_SHORT_NEW):
        logits, _ = model.decode_step(params, cache, token, seq + i, cfg)
        finite.append(bool(torch.isfinite(logits).all()))
        token = torch.argmax(logits, dim=-1).to(torch.int32)
    decode_ms = (time.perf_counter() - t0) * 1e3 / DENSE_SHORT_NEW
    n = wrappers["decode_attention"].launches
    check(all(finite) and n == cfg.n_layers * DENSE_SHORT_NEW,
          f"dense: paligemma-3b finite {all(finite)}, launches {n}")
    launches += n
    out["paligemma-3b"] = dict(weights_gb=wbytes / 1e9, draw_s=draw_s, prefill_ms=prefill_ms,
                               decode_ms_per_step=decode_ms, launches=n)
    log(f"dense: paligemma-3b ({cfg.n_layers} layers, {wbytes / 1e9:.3f} GB drawn in "
        f"{draw_s:.2f} s) {SERVE_SLOTS} x ({cfg.num_patches} patches + {DENSE_PROMPT} tokens) "
        f"through model: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms/step over "
        f"{DENSE_SHORT_NEW} steps (positions from {seq}), decode_attention launches {n}, "
        f"logits finite")
    del params, cache, logits
    release()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 14: the mixture-of-experts family
# ---------------------------------------------------------------------------


def np_scan_searchsorted(a, q):
    """``jnp.searchsorted``'s default bisection (``method="scan"``, side
    ``"left"``) replayed in numpy for each row of ``a`` (B, n) and ``q`` (B,
    Q): ``ceil(log2(n + 1))`` levels from ``low = 0, high = n``, ``mid =
    (low + high) // 2``, ``high = mid`` where ``q <= a[mid]``, else ``low =
    mid``; returns ``high``."""
    import math
    import numpy as np

    n = a.shape[-1]
    low = np.zeros(q.shape, np.int64)
    high = np.full(q.shape, n, np.int64)
    for _ in range(math.ceil(math.log2(n + 1))):
        mid = (low + high) // 2
        left = q <= np.take_along_axis(a, mid, -1)
        low, high = np.where(left, low, mid), np.where(left, mid, high)
    return high


def unsorted_slot_rows(rng, rows, s, k, e, factor=1.25):
    """``slot`` rows as the reference's ``moe_layer`` builds them from
    random top-k choices, most tokens of every other row choosing expert 0
    first: kept entries ``expert·cap + position``, dropped ones ``E·cap``."""
    import numpy as np

    keys = rng.random((rows, s, e))
    skew = rng.random((rows, s)) < 0.6
    skew[::2] = False
    keys[skew, 0] = -1.0
    eid = np.argsort(keys, axis=-1)[..., :k].reshape(rows, s * k)
    eid_s = np.sort(eid, axis=-1, kind="stable")
    counts = np.stack([(eid == j).sum(-1) for j in range(e)], -1)
    start = np.cumsum(counts, -1) - counts
    pos = np.arange(s * k)[None] - np.take_along_axis(start, eid_s, -1)
    cap = max(k, -(-int(s * k / e * factor) // 4) * 4)
    return np.where(pos < cap, eid_s * cap + pos, e * cap), cap


def moe_smoke_layer(device):
    """(a) ``moe_layer`` at granite's SMOKE in float32 (TF32 off) on the
    card and on the CPU: an integer-valued router and inputs (exact logits,
    so both choose the same experts) that send every token to expert 0
    first, so that it overflows; the dispatch equal, the outputs within
    1e-5 of their largest magnitude; the bisection equal to a numpy replay
    of jnp's scan on these rows and on random unsorted rows."""
    import numpy as np
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.models import moe
    from repro_torch.models.transformer import Params

    cfg = SMOKES[MOE_ARCH]
    b, s = MOE_SMOKE_LAYER
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(14)
    x = rng.integers(-2, 3, (b, s, d)).astype(np.float32)
    router = rng.integers(-1, 2, (d, e)).astype(np.float32)
    x[..., 0] = 100.0
    router[0] = 0.0
    router[0, 0] = 5.0
    weights = {"router": router,
               "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / d ** 0.5,
               "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / d ** 0.5,
               "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / f ** 0.5}
    runs = {}
    for dev in (torch.device("cpu"), device):
        p = Params({k: torch.from_numpy(v).to(dev) for k, v in weights.items()})
        tx = torch.from_numpy(x).to(dev)
        runs[dev.type] = (moe.dispatch(p.router, tx, cfg), moe.moe_layer(p, tx, cfg))
    (hr, hout), (cr, cout) = runs["cpu"], runs[device.type]
    for name in ("idx", "keep", "slot", "entry_of_slot", "slot_hit", "tok_of_slot"):
        check(torch.equal(getattr(cr, name).cpu(), getattr(hr, name)),
              f"moe: SMOKE {name} differs between the card and the CPU")
    err = float((cout.cpu() - hout).abs().max())
    scale = float(hout.abs().max())
    check(err <= 1e-5 * scale, f"moe: SMOKE moe_layer card vs CPU error {err} at scale {scale}")
    over = int((~cr.keep).sum())
    missed = int(cr.keep.sum() - cr.slot_hit.sum())
    check(over > 0, "moe: the skewed SMOKE router overflowed no expert")

    slot = cr.slot.cpu().numpy()
    q = np.broadcast_to(np.arange(e * cr.cap), (b, e * cr.cap)).copy()
    rows = [(slot, q)]
    for shape in ((4, MOE_PROMPT, 8, 40), (64, 64, 2, 4), (64, 33, 3, 5)):
        srows, cap = unsorted_slot_rows(rng, *shape)
        rows.append((srows, np.broadcast_to(np.arange(shape[3] * cap),
                                            (shape[0], shape[3] * cap)).copy()))
    misses = 0
    for a, qq in rows:
        got = moe.scan_searchsorted(torch.as_tensor(a, device=device),
                                    torch.as_tensor(qq, device=device)).cpu().numpy()
        want = np_scan_searchsorted(a, qq)
        check(np.array_equal(got, want), f"moe: the bisection on the card differs from jnp's "
                                         f"scan replayed in numpy at {a.shape}")
        kept = (a < qq.shape[1]).sum(-1)
        hit = (np.take_along_axis(a, np.minimum(want, a.shape[1] - 1), -1) == qq).sum(-1)
        misses += int((kept > hit).sum())
    n_rows = sum(a.shape[0] for a, _ in rows)
    log(f"moe: (a) SMOKE moe_layer ({MOE_ARCH}: B {b}, S {s}, E {e}, k {cfg.topk}, cap {cr.cap}) "
        f"card vs CPU, f32, integer router and inputs skewed to expert 0: idx, keep, slot, "
        f"entry_of_slot, slot_hit equal; {over} entries over capacity, {missed} kept entries "
        f"the slot search misses; output max abs err {err:.3e} (|out| <= {scale:.4g}, limit "
        f"1e-5 of it); the bisection equals jnp's scan replayed in numpy on {n_rows} unsorted "
        f"rows ({misses} of them miss a kept slot)")
    return dict(over_capacity=over, missed=missed, max_abs_err=err, scale=scale,
                bisection_rows=n_rows, rows_missing_a_slot=misses)


def moe_drops(cfg, params, device):
    """The share of prefill entries dropped on one wave of SERVE_SLOTS
    prompts of MOE_PROMPT tokens, by cause: over an expert's capacity, and
    kept but missed by the slot search (their expert output zeroed)."""
    import torch
    from repro_torch.models import model, moe

    counts = []
    saved = moe.dispatch

    def counting(router, x, cfg_):
        r = saved(router, x, cfg_)
        counts.append(torch.stack([(~r.keep).sum(), r.keep.sum() - r.slot_hit.sum()]))
        return r

    gen = torch.Generator(device).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (SERVE_SLOTS, MOE_PROMPT), generator=gen,
                           device=device, dtype=torch.int32)
    moe.dispatch = counting
    try:
        model.prefill(params, {"tokens": tokens}, cfg)
    finally:
        moe.dispatch = saved
    per_layer = torch.stack(counts).cpu()
    entries = SERVE_SLOTS * MOE_PROMPT * cfg.topk
    over, missed = (int(v) for v in per_layer.sum(0))
    total = entries * len(counts)
    return dict(entries=total, over_capacity=over, missed=missed,
                over_share=over / total, missed_share=missed / total,
                worst_layer_over_share=float(per_layer[:, 0].max()) / entries,
                worst_layer_missed_share=float(per_layer[:, 1].max()) / entries)


def grok_layer(device):
    """One MoE block at grok-1-314b's published widths (E 8, k 2, d 6,144, f
    32,768; 9.7 GB of bf16 weights drawn at std 1/sqrt(fan-in), the router
    float32) on GROK_LAYER_TOKENS tokens, in bf16 and again with the
    weights and input upcast to float32: the dispatch equal, the bf16
    output within GROK_LAYER_RMS_TOL / GROK_LAYER_MAX_TOL of the float32
    one, both timed."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models.transformer import Params

    cfg = ARCHS[GROK_ARCH]
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device).manual_seed(0)

    def normal(shape, fan_in, dtype):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):  # one expert at a time: a bounded float32 transient
            out[i] = (torch.randn(shape[1:], generator=gen, device=device)
                      * fan_in ** -0.5).to(dtype)
        return out

    bf16 = torch.bfloat16
    weights = {"router": normal((d, e), d, torch.float32), "w_up": normal((e, d, f), d, bf16),
               "w_gate": normal((e, d, f), d, bf16), "w_down": normal((e, f, d), f, bf16)}
    b, s = GROK_LAYER_TOKENS
    x = torch.randn(b, s, d, generator=gen, device=device).to(bf16)

    def run(p, xx):
        ms = cuda_ms(lambda: moe.moe_layer(p, xx, cfg), 5, warm=1)
        return moe.dispatch(p.router, xx, cfg), moe.moe_layer(p, xx, cfg), ms

    r16, y16, ms16 = run(Params(weights), x)
    p32 = Params({k: v.float() for k, v in weights.items()})
    wbytes = sum(v.numel() * v.element_size() for v in p32.parameters())
    r32, y32, ms32 = run(p32, x.float())
    del p32
    for name in ("idx", "keep", "slot", "entry_of_slot", "slot_hit", "tok_of_slot"):
        check(torch.equal(getattr(r16, name), getattr(r32, name)),
              f"moe: grok layer {name} differs between bf16 and float32")
    err = y16.float() - y32
    rms_ratio = float(err.pow(2).mean().sqrt() / y32.pow(2).mean().sqrt())
    max_ratio = float(err.abs().max() / y32.abs().max())
    check(rms_ratio <= GROK_LAYER_RMS_TOL and max_ratio <= GROK_LAYER_MAX_TOL,
          f"moe: grok layer bf16 vs float32: rms {rms_ratio:.3e}, max {max_ratio:.3e}")
    bf16_bytes = sum(v.numel() * v.element_size() for v in weights.values())
    over = int((~r16.keep).sum())
    missed = int(r16.keep.sum() - r16.slot_hit.sum())
    log(f"moe: (d) grok-1-314b MoE block at its published widths (E {e}, k {cfg.topk}, d {d}, "
        f"f {f}, cap {r16.cap}; {bf16_bytes / 1e9:.3f} GB bf16 weights, {wbytes / 1e9:.3f} GB as "
        f"float32) on {b} x {s} tokens: dispatch equal in bf16 and float32 ({over} entries over "
        f"capacity, {missed} missed by the slot search); bf16 output vs float32: rms error "
        f"{rms_ratio:.3e} of the output's rms (limit {GROK_LAYER_RMS_TOL:g}), max error "
        f"{max_ratio:.3e} of its largest magnitude (limit {GROK_LAYER_MAX_TOL:g}); "
        f"{ms16:.3f} ms bf16, {ms32:.3f} ms float32 (TF32 off) per call")
    del weights, r16, r32, y16, y32, err
    return dict(weights_gb=bf16_bytes / 1e9, over_capacity=over,
                missed=missed, rms_err_share=rms_ratio, max_err_share=max_ratio,
                bf16_ms=ms16, f32_ms=ms32)


def moe_phase(device, wrappers):
    """The mixture-of-experts family: (a) ``moe_layer`` card vs CPU at
    granite's SMOKE; (b) granite-moe-3b-a800m served at full width behind
    MIG admission, a profiled decode window and the prefill's drops; (c)
    granite trained at full width; (d) grok-1-314b's SMOKE step card vs
    CPU and served, and one MoE block at its published widths."""
    import torch
    from repro_torch.configs import ARCHS, SMOKES
    from repro_torch.models import model, moe

    out, launches = {"smoke_layer": moe_smoke_layer(device)}, 0

    cfg, params, wbytes, draw_s = draw_model(MOE_ARCH, device)
    warm = dense_serve(cfg, params, [MOE_PROMPT], 3, device, wrappers, seed=1)
    served = dense_serve(cfg, params, [MOE_PROMPT], MOE_NEW, device, wrappers)
    steps = served["waves"][0]["decode_steps"]
    check(served["launches"] == cfg.n_layers * steps == cfg.n_layers * (MOE_NEW - 1),
          f"moe: granite decode_attention launches {served['launches']} over {steps} steps")
    launches += served["launches"]
    window = decode_window(cfg, params, device, MOE_PROMPT, MOE_PROMPT + MOE_NEW + 1,
                           MOE_WINDOW_STEPS)
    drops = moe_drops(cfg, params, device)
    w = served["waves"][0]
    out["granite_serving"] = dict(weights_gb=wbytes / 1e9, draw_s=draw_s, warm_run_s=warm["run_s"],
                                  drops=drops, **served, **window)
    log(f"moe: (b) {MOE_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, E {cfg.n_experts}, "
        f"k {cfg.topk}, {cfg.param_count() / 1e9:.3f}B parameters, {wbytes / 1e9:.3f} GB bf16 "
        f"drawn in {draw_s:.2f} s) behind admission, one wave of {SERVE_SLOTS} x {MOE_PROMPT}-token "
        f"prompts (cap {moe.capacity(cfg, MOE_PROMPT)} a row), {MOE_NEW} new "
        f"tokens, in {served['run_s']:.3f} s: prefill {w['prefill_ms']:.3f} ms, decode "
        f"{w['decode_ms_per_step']:.3f} ms/step over {steps} steps; decode_attention launches "
        f"{served['launches']} = {cfg.n_layers} x {steps}; logits finite; stats {served['stats']}")
    log(f"moe: (b) window ({MOE_WINDOW_STEPS} decode steps from position {MOE_PROMPT}): device "
        f"busy {window['window_busy_ms']:.3f} ms of {window['window_wall_ms']:.3f} ms wall "
        f"({100 * window['busy_share']:.1f}% busy), {window['device_ops_per_step']:.1f} device "
        f"ops/step; top: " + "; ".join(f"{k} {t:.1f} us x{c}" for k, t, c in window["top"]))
    log(f"moe: (b) prefill entries dropped ({drops['entries']} = {cfg.n_layers} layers x "
        f"{SERVE_SLOTS} x {MOE_PROMPT} x {cfg.topk}): over capacity {drops['over_capacity']} "
        f"({100 * drops['over_share']:.3f}%; worst layer {100 * drops['worst_layer_over_share']:.3f}%), "
        f"kept but missed by the slot search {drops['missed']} "
        f"({100 * drops['missed_share']:.3f}%; worst layer "
        f"{100 * drops['worst_layer_missed_share']:.3f}%)")
    del params
    release()

    cfg = ARCHS[MOE_ARCH]
    n = cfg.param_count()
    log(f"moe: (c) reckoned before the run: {n} parameters, bf16 parameters and accumulated and "
        f"micro-batch gradients {3 * 2 * n / 1e9:.3f} GB + float32 moments {8 * n / 1e9:.3f} GB = "
        f"{14 * n / 1e9:.3f} GB, plus activations; {MOE_TRAIN_STEPS} steps of "
        f"{MOE_TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    out["granite_train"] = train_run(device, wrappers, cfg, MOE_TRAIN_BATCH, MOE_TRAIN_ACCUM,
                                     MOE_TRAIN_STEPS, TRAIN_CUT_FROM, tag="moe")
    release()

    out["grok_smoke_step"] = smoke_arch_steps(device, {GROK_ARCH: GROK_SMOKE_STEP}, tag="moe")
    cfg = SMOKES[GROK_ARCH]
    params = model.init_params(cfg, torch.Generator(device).manual_seed(0), device=device)
    served = dense_serve(cfg, params, [GROK_SMOKE_PROMPT], GROK_SMOKE_NEW, device, wrappers)
    launches += served["launches"]
    w = served["waves"][0]
    out["grok_smoke_serving"] = served
    log(f"moe: (d) {GROK_ARCH} SMOKE served behind admission, {SERVE_SLOTS} x {GROK_SMOKE_PROMPT} "
        f"tokens, {GROK_SMOKE_NEW} new: prefill {w['prefill_ms']:.3f} ms, decode "
        f"{w['decode_ms_per_step']:.3f} ms/step, decode_attention launches {served['launches']}, "
        f"logits finite")
    del params
    release()
    out["grok_layer"] = grok_layer(device)
    release()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 15: the state-space and hybrid families
# ---------------------------------------------------------------------------


def ssm_smoke_serving(device):
    """Each SMOKE's prefill and teacher-forced decode steps on the card
    against the same on the CPU (float32, TF32 off), under the reference's
    initialiser and with the weight matrices scaled by 0.1: every logit
    within the tests' tolerance of its largest magnitude."""
    import numpy as np
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.models import model

    cpu = torch.device("cpu")
    b, prompt, steps = SSM_SMOKE_SERVE
    out = {}
    for arch in SSM_ARCHS:
        cfg = SMOKES[arch]
        tree = model.params_to_tree(model.init_params(cfg, torch.Generator().manual_seed(0), cpu),
                                    cfg)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (b, prompt)).astype(np.int32)
        forced = rng.integers(0, cfg.vocab, (steps, b)).astype(np.int32)
        for scale, tol in SSM_SMOKE_LOGIT_TOL.items():
            runs = {}
            for dev in (cpu, device):
                params = model.params_from_numpy(scaled_tree(tree, scale), cfg, dev)
                logits, cache = model.prefill(params, {"tokens": torch.as_tensor(tokens, device=dev)},
                                              cfg)
                cache = model.pad_cache(cache, prompt, prompt + steps)
                rows = [logits]
                for i in range(steps):
                    logits, cache = model.decode_step(
                        params, cache, torch.as_tensor(forced[i], device=dev), prompt + i, cfg)
                    rows.append(logits)
                runs[dev.type] = torch.stack(rows).float().cpu()
            want, got = runs["cpu"], runs[device.type]
            share = max(float((got[i] - want[i]).abs().max()) / (tol * float(want[i].abs().max()))
                        for i in range(steps + 1))
            log(f"ssm: SMOKE {arch} ({cfg.n_layers} layers, H {cfg.ssm_nheads}, N {cfg.ssm_state}"
                f"{', window ' + str(cfg.window) if cfg.local_global else ''}), weights x{scale:g}, "
                f"card vs CPU: prefill of {b} x {prompt} tokens and {steps} decode steps, worst "
                f"logits at {share:.3f} of their limit ({tol:g} of their largest magnitude)")
            check(share <= 1.0, f"ssm: SMOKE {arch} x{scale:g} logits card vs CPU past their limit")
            out[f"{arch}_x{scale:g}"] = dict(share_of_limit=share, tolerance=tol)
    return out


def ssm_phase(device, wrappers):
    """The state-space and hybrid families: the SMOKEs' serving and one
    SMOKE step card vs CPU; mamba2-2.7b and hymba-1.5b served at full width
    behind MIG admission with a profiled decode window, then trained at
    full width."""
    from repro_torch.configs import ARCHS

    out = {"smoke_serving": ssm_smoke_serving(device),
           "smoke_step": smoke_arch_steps(device, dict.fromkeys(SSM_ARCHS, SSM_SMOKE_STEP),
                                          tag="ssm")}
    launches = 0
    for arch in SSM_ARCHS:
        cfg, params, wbytes, draw_s = draw_model(arch, device)
        warm = dense_serve(cfg, params, [SSM_PROMPT], 3, device, wrappers, seed=1)
        served = dense_serve(cfg, params, [SSM_PROMPT], SSM_NEW, device, wrappers)
        steps = served["waves"][0]["decode_steps"]
        layers = attention_layers(cfg)
        check(steps == SSM_NEW - 1 and served["launches"] == layers * steps,
              f"ssm: {arch} decode_attention launches {served['launches']} over {steps} steps")
        launches += served["launches"]
        window = decode_window(cfg, params, device, SSM_PROMPT, SSM_PROMPT + SSM_NEW + 1,
                               SSM_WINDOW_STEPS)
        w = served["waves"][0]
        out[f"{arch}_serving"] = dict(weights_gb=wbytes / 1e9, draw_s=draw_s,
                                      warm_run_s=warm["run_s"], **served, **window)
        mixer = (f"SSD H {cfg.ssm_nheads}, N {cfg.ssm_state}, P {cfg.ssm_headdim}"
                 + (f"; attention {cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.group_pattern} "
                    f"local/global, window {cfg.window}" if layers else ""))
        log(f"ssm: {arch} ({cfg.n_layers} layers, d {cfg.d_model}, {mixer}; "
            f"{cfg.param_count() / 1e9:.3f}B parameters, {wbytes / 1e9:.3f} GB bf16 drawn in "
            f"{draw_s:.2f} s) behind admission, one wave of {SERVE_SLOTS} x {SSM_PROMPT}-token "
            f"prompts, {SSM_NEW} new tokens, in {served['run_s']:.3f} s: prefill "
            f"{w['prefill_ms']:.3f} ms, decode {w['decode_ms_per_step']:.3f} ms/step over {steps} "
            f"steps; decode_attention launches {served['launches']} = {layers} x {steps}; logits "
            f"finite; stats {served['stats']}")
        log(f"ssm: {arch} window ({SSM_WINDOW_STEPS} decode steps from position {SSM_PROMPT}): "
            f"device busy {window['window_busy_ms']:.3f} ms of {window['window_wall_ms']:.3f} ms "
            f"wall ({100 * window['busy_share']:.1f}% busy), {window['device_ops_per_step']:.1f} "
            f"device ops/step; top: "
            + "; ".join(f"{k} {t:.1f} us x{c}" for k, t, c in window["top"]))
        del params
        release()

    for arch in SSM_ARCHS:
        cfg = ARCHS[arch]
        n, batch = cfg.param_count(), SSM_TRAIN_BATCH[arch]
        log(f"ssm: {arch} reckoned before the run: {n} parameters, bf16 parameters and accumulated "
            f"and micro-batch gradients {3 * 2 * n / 1e9:.3f} GB + float32 moments "
            f"{8 * n / 1e9:.3f} GB = {14 * n / 1e9:.3f} GB, plus activations; "
            f"{SSM_TRAIN_STEPS} steps of {batch} x {TRAIN_SEQ} tokens as {cfg.grad_accum} "
            f"micro-batch(es)")
        out[f"{arch}_train"] = train_run(device, wrappers, cfg, batch, cfg.grad_accum,
                                         SSM_TRAIN_STEPS, TRAIN_CUT_FROM, tag="ssm")
        release()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 16: the encoder-decoder family
# ---------------------------------------------------------------------------


def encdec_smoke_serving(device):
    """whisper's SMOKE prefilled on frames = prompt (``pad_cache`` then
    grows the cross cache, as the reference's does) and decoded
    teacher-forced on the card against the same on the CPU (float32, TF32
    off), under the reference's initialiser and with the weight matrices
    scaled by 0.1: every logit and every cache leaf within
    ENCDEC_SMOKE_TOL of its largest magnitude."""
    import numpy as np
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.models import model

    cpu = torch.device("cpu")
    b, prompt, steps = ENCDEC_SMOKE_SERVE
    cfg = SMOKES[ENCDEC_ARCH]
    tree = model.params_to_tree(model.init_params(cfg, torch.Generator().manual_seed(0), cpu), cfg)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((b, prompt, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, prompt)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (steps, b)).astype(np.int32)
    out = {}
    for scale, (logit_tol, cache_tol) in ENCDEC_SMOKE_TOL.items():
        runs = {}
        for dev in (cpu, device):
            params = model.params_from_numpy(scaled_tree(tree, scale), cfg, dev)
            batch = {"frames": torch.as_tensor(frames, device=dev),
                     "tokens": torch.as_tensor(tokens, device=dev)}
            logits, cache = model.prefill(params, batch, cfg)
            leaves = {f"prefill {k}/{n}": t.float().cpu() for k, v in cache.items()
                      for n, t in v.items()}
            cache = model.pad_cache(cache, prompt, prompt + steps)
            rows = [logits]
            for i in range(steps):
                logits, cache = model.decode_step(
                    params, cache, torch.as_tensor(forced[i], device=dev), prompt + i, cfg)
                rows.append(logits)
            leaves.update({f"decode {k}/{n}": t.float().cpu() for k, v in cache.items()
                           for n, t in v.items()})
            runs[dev.type] = (torch.stack(rows).float().cpu(), leaves)
        (want, want_leaves), (got, got_leaves) = runs["cpu"], runs[device.type]
        check(got_leaves["decode cross/k"].shape[2] == prompt + steps,
              "encdec: SMOKE cross cache not grown by pad_cache")
        share = max(float((got[i] - want[i]).abs().max()) / (logit_tol * float(want[i].abs().max()))
                    for i in range(steps + 1))
        cache_share = max(float((got_leaves[k] - w).abs().max())
                          / (cache_tol * float(w.abs().max()))
                          for k, w in want_leaves.items())
        log(f"encdec: SMOKE {ENCDEC_ARCH} ({cfg.n_enc_layers} + {cfg.n_layers} layers, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads), weights x{scale:g}, card vs CPU: prefill of "
            f"{b} x ({prompt} frames + {prompt} tokens), {steps} decode steps over the cross "
            f"cache grown by pad_cache; worst logits at {share:.3f} of their limit ({logit_tol:g}"
            f" of their largest magnitude), worst cache leaf at {cache_share:.3f} of its "
            f"({cache_tol:g})")
        check(share <= 1.0 and cache_share <= 1.0,
              f"encdec: SMOKE x{scale:g} card vs CPU past its limits")
        out[f"x{scale:g}"] = dict(logit_share_of_limit=share, cache_share_of_limit=cache_share,
                                  tolerances=(logit_tol, cache_tol))
    return out


def encdec_phase(device, wrappers):
    """The encoder-decoder family: whisper's SMOKE served and one SMOKE step
    card vs CPU; whisper-large-v3 prefilled and decoded at full width
    through ``model`` with a profiled decode window, then trained at full
    width."""
    import math
    import torch
    from repro_torch.models import model

    out = {"smoke_serving": encdec_smoke_serving(device),
           "smoke_step": smoke_arch_steps(device, {ENCDEC_ARCH: ENCDEC_SMOKE_STEP}, tag="encdec")}
    cfg, params, wbytes, draw_s = draw_model(ENCDEC_ARCH, device)
    n_alloc = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device).manual_seed(6)
    frames = torch.randn(SERVE_SLOTS, ENCDEC_FRAMES, cfg.d_model, generator=gen,
                         device=device).to(cfg.torch_dtype)
    tokens = torch.randint(0, cfg.vocab, (SERVE_SLOTS, ENCDEC_PROMPT), generator=gen,
                           device=device, dtype=torch.int32)
    max_len = ENCDEC_PROMPT + ENCDEC_NEW
    per_step = 2 * cfg.n_layers  # self- and cross-attention in every decoder layer

    def serve():
        """Prefill, pad_cache and ENCDEC_NEW decode steps: (prefill ms,
        decode ms per step, launches, every logit finite, cache shapes)."""
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"frames": frames, "tokens": tokens}, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = model.pad_cache(cache, ENCDEC_PROMPT, max_len)
        finite = [bool(torch.isfinite(logits).all())]
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        for i in range(ENCDEC_NEW):
            logits, _ = model.decode_step(params, cache, token, ENCDEC_PROMPT + i, cfg)
            finite.append(bool(torch.isfinite(logits).all()))
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / ENCDEC_NEW
        counts = {k: fn.launches for k, fn in wrappers.items()}
        shapes = {k: tuple(v["k"].shape) for k, v in cache.items()}
        return prefill_ms, decode_ms, counts, all(finite), shapes

    warm = serve()
    prefill_ms, decode_ms, counts, finite, shapes = serve()
    want = dict.fromkeys(wrappers, 0)
    want["decode_attention"] = per_step * ENCDEC_NEW
    check(counts == want and finite,
          f"encdec: {ENCDEC_ARCH} launch counts {counts} != {want} or logits not finite")
    check(shapes == {"self": (cfg.n_layers, SERVE_SLOTS, max_len, cfg.n_kv_heads, cfg.head_dim),
                     "cross": (cfg.n_layers, SERVE_SLOTS, ENCDEC_FRAMES, cfg.n_kv_heads,
                               cfg.head_dim)},
          f"encdec: cache shapes {shapes}")
    window = decode_window(cfg, params, device, ENCDEC_PROMPT, max_len, ENCDEC_WINDOW_STEPS,
                           extra={"frames": frames})
    out["serving"] = dict(weights_gb=wbytes / 1e9, draw_s=draw_s, params=n_alloc,
                          frames=ENCDEC_FRAMES, prompt=ENCDEC_PROMPT, decode_steps=ENCDEC_NEW,
                          prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
                          warm_prefill_ms=warm[0], warm_decode_ms_per_step=warm[1],
                          launches=counts["decode_attention"], launches_per_step=per_step,
                          **window)
    log(f"encdec: {ENCDEC_ARCH} ({cfg.n_enc_layers} + {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads; {n_alloc} parameter elements, "
        f"{wbytes / 1e9:.3f} GB bf16 drawn in {draw_s:.2f} s) through model: prefill of "
        f"{SERVE_SLOTS} x ({ENCDEC_FRAMES} frames + {ENCDEC_PROMPT} tokens) {prefill_ms:.3f} ms "
        f"(warm-up {warm[0]:.3f}), decode {decode_ms:.3f} ms/step over {ENCDEC_NEW} steps "
        f"(warm-up {warm[1]:.3f}); decode_attention launches {counts['decode_attention']} = "
        f"{per_step} x {ENCDEC_NEW} (self and cross); logits finite; caches {shapes}")
    log(f"encdec: {ENCDEC_ARCH} window ({ENCDEC_WINDOW_STEPS} decode steps from position "
        f"{ENCDEC_PROMPT}): device busy {window['window_busy_ms']:.3f} ms of "
        f"{window['window_wall_ms']:.3f} ms wall ({100 * window['busy_share']:.1f}% busy), "
        f"{window['device_ops_per_step']:.1f} device ops/step; top: "
        + "; ".join(f"{k} {t:.1f} us x{c}" for k, t, c in window["top"]))
    del params, frames
    release()

    n = cfg.param_count()
    log(f"encdec: {ENCDEC_ARCH} reckoned before the run: {n_alloc} parameter elements "
        f"({n} by param_count), bf16 parameters and accumulated and micro-batch gradients "
        f"{3 * 2 * n_alloc / 1e9:.3f} GB + float32 moments {8 * n_alloc / 1e9:.3f} GB = "
        f"{14 * n_alloc / 1e9:.3f} GB, plus activations; {ENCDEC_TRAIN_STEPS} steps of "
        f"{ENCDEC_TRAIN_BATCH} x ({TRAIN_SEQ // 2} frames + {TRAIN_SEQ // 2} tokens) as "
        f"{ENCDEC_TRAIN_ACCUM} micro-batches")
    out["train"] = train_run(device, wrappers, cfg, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_ACCUM,
                             ENCDEC_TRAIN_STEPS, TRAIN_CUT_FROM, tag="encdec")
    check(all(math.isfinite(x) for x in out["train"]["losses"]), "encdec: train losses")
    release()
    out["launches"] = counts["decode_attention"]
    return out


# ---------------------------------------------------------------------------
# phase 17: the replica split and the launch tooling
# ---------------------------------------------------------------------------


def split_blocks(events, policy, common, ways):
    """The kernel path of ``policy`` over ``events`` split ``ways`` ways onto
    the card (``_visible_devices`` shows it ``ways`` times, the hook the CPU
    tests patch too): one event loop steps every block in turn, under
    ``set_sync_debug_mode("error")``.  Returns ``(joined host trace,
    seconds of the loop and the trace's fetch)``."""
    import torch
    from repro_torch.sim import batched

    card = torch.device("cuda", torch.cuda.current_device())
    placed = batched.shard_events(events, events.pid.shape[1], True, card)
    check(isinstance(placed, batched.ShardedStream) and len(placed.shards) == ways,
          f"split: {ways}-way split not made")
    check(batched.shard_events(placed, events.pid.shape[1], True) is placed,
          "split: a split stream was placed again")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = [batched._setup_run(ev, policy=policy, use_kernel=True,
                                 **batched._statics_on(common, d))
              for ev, d in zip(placed.shards, placed.devices)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched._split_event_loop(blocks)
    except RuntimeError as e:
        check(False, f"split {ways} ways: a host sync inside the event loop: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    trace = batched._join_traces([batched.trace_to_numpy(b[3]) for b in blocks], card)
    return trace, time.perf_counter() - t0


def unsplit_run(events, policy, common):
    """The unsplit kernel path over ``events``, the loop under
    ``set_sync_debug_mode("error")``: ``(host trace, seconds)``."""
    import torch
    from repro_torch.sim import batched

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = batched._setup_run(events, policy=policy, use_kernel=True, **common)
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched._event_loop(*loop)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    trace = batched.trace_to_numpy(loop[3])
    return trace, time.perf_counter() - t0


def traces_equal(a, b) -> bool:
    import numpy as np
    from repro_torch.sim import batched

    return all((getattr(a, f) is None) == (getattr(b, f) is None)
               and (getattr(a, f) is None or np.array_equal(getattr(a, f), getattr(b, f)))
               for f in batched.EventTrace._fields)


def replica_split(device, wrappers):
    """(a) The replica split on the one card: the Fig. 4 point's first
    SIDE_EVENTS events through the kernels unsplit and split 2 and 4 ways
    (traces byte-equal, aggregates equal, launches D times the unsplit
    run's); mfi-defrag and faulted mfi split 2 ways over an engine window;
    a chunked run split 2 ways, checkpointed at a chunk boundary and
    resumed unsplit; ``run_batched(shard=...)`` on a small fleet: True
    raises the reference's error with one card visible, None equals the
    unsplit run, and True over a 2-way split equals it too."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import mig
    from repro_torch.sim import batched
    from repro_torch.sim.simulator import SimConfig

    cfg, spec, events, common = paper_stream(device)
    side = batched.EventStream(*[None if a is None else a[:SIDE_EVENTS] for a in events])
    n = SIDE_EVENTS
    visible = batched._visible_devices
    card = torch.device("cuda", torch.cuda.current_device())
    totals = dict.fromkeys(wrappers, 0)
    out = {}

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        res = fn()
        counts = {k: w.launches for k, w in wrappers.items()}
        for k in totals:
            totals[k] += counts[k]
        return res, counts

    # the one-card rules: shard=True raises, shard=None is no split
    try:
        batched.shard_events(side, RUNS, True, device)
        check(False, "split: shard=True with one card visible did not raise")
    except ValueError as e:
        check(str(e) == "replica sharding requested but only one device is visible",
              f"split: shard=True raised {e!r}")
    check(batched.shard_events(side, RUNS, None, device) is side, "split: shard=None split")
    small = SimConfig(num_gpus=SPLIT_API_GPUS, offered_load=1.0, seed=0)
    try:
        batched.run_batched("mfi", small, runs=SPLIT_API_RUNS, shard=True)
        check(False, "split: run_batched(shard=True) with one card visible did not raise")
    except ValueError as e:
        check("only one device is visible" in str(e), f"split: run_batched raised {e!r}")
    want_api = batched.run_batched("mfi", small, runs=SPLIT_API_RUNS, shard=False)
    got_auto = batched.run_batched("mfi", small, runs=SPLIT_API_RUNS)
    check(dicts_equal(got_auto, want_api), "split: run_batched(shard=None) != unsplit")

    unsplit_run(batched.EventStream(*[None if a is None else a[:32] for a in side]), "mfi", common)
    (want, secs), want_counts = counted(lambda: unsplit_run(side, "mfi", common))
    want_agg = batched.aggregate(side, want, spec, RUNS)
    rates = {"unsplit": RUNS * n / secs}
    try:
        for ways in SPLIT_WAYS:
            batched._visible_devices = lambda dev, ways=ways: [card] * ways
            if ways == SPLIT_WAYS[0]:
                got = batched.run_batched("mfi", small, runs=SPLIT_API_RUNS, shard=True)
                check(dicts_equal(got, want_api), "split: run_batched(shard=True) 2 ways")
            (trace, secs), counts = counted(lambda: split_blocks(side, "mfi", common, ways))
            check(traces_equal(trace, want), f"split mfi {ways} ways: trace differs")
            check(trace_hash(tuple(getattr(trace, f) for f in STEADY_HASH_FIELDS))
                  == trace_hash(tuple(getattr(want, f) for f in STEADY_HASH_FIELDS)),
                  f"split mfi {ways} ways: hash differs")
            agg = batched.aggregate(side, trace, spec, RUNS)
            check(dicts_equal(agg, want_agg), f"split mfi {ways} ways: aggregates differ")
            placed = int((side.pid >= 0).sum())
            check(counts == {k: ways * v for k, v in want_counts.items()},
                  f"split mfi {ways} ways: launches {counts} != {ways} x {want_counts}")
            rates[f"{ways}-way"] = RUNS * n / secs
            log(f"split: mfi over the Fig. 4 point's first {n} events, R = {RUNS} as {ways} "
                f"blocks of {RUNS // ways} on {card}: trace byte-equal to the unsplit run "
                f"({int(trace.ok.sum())} of {placed} arrivals placed), aggregates equal (these "
                f"events precede the measured window), launches {counts} "
                f"({ways} x the unsplit run's), no host sync in the loop; "
                f"{RUNS * n / secs:.0f} replica-events/s ({secs:.2f} s) against unsplit "
                f"{rates['unsplit']:.0f}")

        batched._visible_devices = lambda dev: [card] * 2
        window = batched.EventStream(*[None if a is None else a[:WINDOW_EVENTS] for a in events])
        fm = mig.FaultModel(mtbf=FAULT_MTBF, mttr=FAULT_MTTR)
        fcfg = SimConfig(num_gpus=100, offered_load=QUEUED_LOAD, seed=0,
                         protocol="steady-faulted", fault_model=fm)
        fev, _, frows, fcols = batched.presample_arrivals(fcfg, RUNS, queued=True,
                                                          fault_model=fm)
        fwin = batched.EventStream(*[None if a is None else a[:WINDOW_EVENTS] for a in fev])
        for name, ev, policy, kw in (("mfi-defrag", window, "mfi-defrag", common),
                                     ("faulted mfi", fwin, "mfi",
                                      faulted_common(fcfg, frows, fcols, fm, device))):
            (w_trace, w_s), w_counts = counted(lambda: unsplit_run(ev, policy, kw))
            (s_trace, s_s), s_counts = counted(lambda: split_blocks(ev, policy, kw, 2))
            check(traces_equal(s_trace, w_trace), f"split {name}: window trace differs")
            check(s_counts == {k: 2 * v for k, v in w_counts.items()},
                  f"split {name}: launches {s_counts} != 2 x {w_counts}")
            out[name.replace(" ", "_") + "_window"] = dict(
                events=WINDOW_EVENTS, unsplit_s=w_s, split_s=s_s, launches=s_counts)
            log(f"split: {name} engine window ({WINDOW_EVENTS} events, R = {RUNS}) split 2 "
                f"ways: trace equal to the unsplit run, launches {s_counts} (2 x {w_counts}), "
                f"no host sync in the loop; {w_s:.2f} s unsplit, {s_s:.2f} s split")

        # simulate_chunked split 2 ways: each block its own feed and drain
        tmp = Path(tempfile.mkdtemp(prefix="split_ckpt_"))
        path = tmp / "carry"
        stats = {}
        done = SPLIT_CKPT_EVERY * SPLIT_CHUNK
        (c_state, c_trace), c_counts = counted(lambda: batched.simulate_chunked(
            side, chunk_size=SPLIT_CHUNK, policy="mfi", use_kernel=True, shard=True,
            checkpoint_path=path, checkpoint_every=SPLIT_CKPT_EVERY, stats=stats, **common))
        check(traces_equal(c_trace, want), "split chunked: trace differs from the unsplit run")
        statics = {k: v for k, v in common.items() if k not in ("ring_rows", "ring_cols")}
        template = batched.init_carry(RUNS, policy="mfi", use_kernel=True,
                                      ring_rows=common["ring_rows"],
                                      ring_cols=common["ring_cols"], **statics)
        state, step = batched.load_stream_checkpoint(path, template)
        check(step == done, f"split chunked: last checkpoint at {step}, not {done}")
        (_, tail), t_counts = counted(lambda: batched.simulate_chunked(
            side, chunk_size=SPLIT_CHUNK, policy="mfi", use_kernel=True, shard=False,
            carry=state, start=step, **common))
        check(all(getattr(tail, f) is None or np.array_equal(getattr(tail, f),
                                                             getattr(want, f)[step:])
                  for f in batched.EventTrace._fields),
              "split chunked: the unsplit resume differs from the unsplit run")
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()
        out["chunked"] = dict(chunk=SPLIT_CHUNK, chunks=stats["chunks"],
                              h2d_overlap_frac=stats["h2d_overlap_frac"],
                              resumed_from=step, launches=c_counts)
        log(f"split: mfi chunked at {SPLIT_CHUNK} over {n} events split 2 ways (a feed and a "
            f"drain per block, side streams), checkpointed every {SPLIT_CKPT_EVERY} chunks: trace "
            f"equal to the "
            f"unsplit run; the last checkpoint (event {step}, the gathered carry) resumed "
            f"unsplit, events {step}-{n} equal; {stats['chunks']} chunks, h2d_overlap_frac "
            f"{stats['h2d_overlap_frac']:.4f}, launches {c_counts} then {t_counts}")
    finally:
        batched._visible_devices = visible
    out.update(replica_events_per_s=rates, launches=totals, events=n, runs=RUNS)
    return out


def cache_scale(cfg, params, device):
    """The standard deviation of each cache leaf (k, v, the SSD state and
    conv history, by kind) after a short prefill of SCALE_PROMPT random
    tokens: the scale at which the assigned-size caches are drawn."""
    import torch
    from repro_torch.models import model

    b, s = SCALE_PROMPT
    gen = torch.Generator(device).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=device, dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": tokens}, cfg)
    return {kind: {name: float(t.float().std()) for name, t in leaves.items()}
            for kind, leaves in cache.items()}


def assigned_decode(device, wrappers, cfg, params, scale, shape_name):
    """``build_step``'s decode branch for ``cfg`` at its assigned
    ``shape_name``: real tensors of the example args' shapes and dtypes,
    the cache drawn at ``scale`` from a Generator seeded 0, full (the
    decode starts at pos = S - ASSIGNED_STEPS, so every key is read),
    ASSIGNED_STEPS steps through ``serve_step``: ms a step, a profiled
    window's busy share, peak memory, ``decode_attention`` launches a step,
    finite logits."""
    import torch
    from repro_torch.launch import shapes, steps

    shape = shapes.SHAPES[shape_name]
    fn, args, ins, outs = steps.build_step(cfg, shape, multi_pod=False)
    meta = args[1]
    reckoned = sum(t.numel() * t.element_size() for leaves in meta.values()
                   for t in leaves.values())
    gen = torch.Generator(device).manual_seed(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = {}
    for kind, leaves in meta.items():
        cache[kind] = {}
        for name, t in leaves.items():
            real = torch.empty(t.shape, dtype=t.dtype, device=device)
            real.normal_(0.0, scale[kind][name], generator=gen)
            cache[kind][name] = real
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    b, s = shape.global_batch, shape.seq_len
    token = torch.randint(0, cfg.vocab, (b,), generator=gen, device=device, dtype=torch.int32)
    check(tuple(token.shape) == tuple(args[2].shape) and token.dtype == args[2].dtype,
          f"launch: {shape_name} token spec")
    first = s - ASSIGNED_STEPS

    def run(n_steps, start):
        t = token
        lg = None
        for i in range(n_steps):
            lg, _ = fn(params, cache, t, start + i)
            t = torch.argmax(lg, dim=-1).to(torch.int32)
        return lg

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = run(ASSIGNED_STEPS, first)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ASSIGNED_STEPS
    counts = {k: w.launches for k, w in wrappers.items()}
    finite = bool(torch.isfinite(logits).all())
    peak = torch.cuda.max_memory_allocated() - base
    per_step = counts["decode_attention"] / ASSIGNED_STEPS
    want = dict.fromkeys(wrappers, 0)
    want["decode_attention"] = attention_layers(cfg) * ASSIGNED_STEPS
    check(counts == want and finite,
          f"launch: {shape_name} launches {counts} != {want} or logits not finite")
    check(tuple(logits.shape) == (b, cfg.padded_vocab), f"launch: logits {tuple(logits.shape)}")
    # the same steps again (the ring and linear slots rewritten), profiled
    times = device_times(lambda: run(ASSIGNED_STEPS, first), 1)
    busy_ms = sum(t for t, _ in times.values()) / 1e3
    t0 = time.perf_counter()
    run(ASSIGNED_STEPS, first)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    attn_us = sum(t for k, (t, _) in times.items() if "decode_" in k)
    ops = sum(c for _, c in times.values()) / ASSIGNED_STEPS
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:4]
    res = dict(shape=shape_name, batch=b, seq_len=s, cache_gb=held / 1e9,
               reckoned_cache_gb=reckoned / 1e9, draw_s=draw_s, ms_per_step=ms,
               launches_per_step=per_step, peak_gb=(peak + base) / 1e9,
               window_busy_ms=busy_ms, window_wall_ms=wall_ms,
               busy_share=busy_ms / wall_ms, device_ops_per_step=ops,
               decode_attention_ms_per_step=attn_us / 1e3 / ASSIGNED_STEPS,
               launches=counts["decode_attention"])
    log(f"launch: {cfg.name} {shape_name} through build_step's decode branch: B {b}, S {s}; "
        f"cache {held / 1e9:.3f} GB on the card (build_step's meta specs reckon "
        f"{reckoned / 1e9:.3f} GB) drawn in {draw_s:.2f} s; {ASSIGNED_STEPS} steps from pos "
        f"{first}: {ms:.3f} ms/step, decode_attention {per_step:.0f} launches/step "
        f"({attn_us / 1e3 / ASSIGNED_STEPS:.3f} ms of device time a step), logits finite; "
        f"profiled window {busy_ms:.3f} ms busy of {wall_ms:.3f} ms wall "
        f"({100 * busy_ms / wall_ms:.1f}% busy), {ops:.0f} device ops/step; peak memory "
        f"{(peak + base) / 1e9:.3f} GB; top: "
        + "; ".join(f"{k[:48]} {t / c:.1f} us x{c}" for k, (t, c) in top))
    del cache
    release()
    return res


def launch_train_smoke(device):
    """``build_step``'s train branch on the SMOKE config, card vs CPU
    (float32, TF32 off, weights scaled by 0.1), with and without the
    ``bf16_grad`` rule: the loss and both AdamW moments."""
    import torch
    from repro_torch.configs import SMOKES
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import shapes, steps
    from repro_torch.models import model
    from repro_torch.optim import adamw_init

    cfg = SMOKES[ASSIGNED_ARCH]
    cpu = torch.device("cpu")
    tree = scaled_tree(model.params_to_tree(
        model.init_params(cfg, torch.Generator().manual_seed(0), cpu), cfg), 0.1)
    batch = next(make_batch_iterator(cfg, *SSM_SMOKE_STEP, seed=0))
    out = {}
    for over in (None, {"bf16_grad": True}):
        fn = steps.build_step(cfg, shapes.SHAPES["train_4k"], multi_pod=False,
                              rule_overrides=over)[0]
        runs = {}
        for dev in (cpu, device):
            params = model.params_from_numpy(tree, cfg, dev)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            _, opt, metrics = fn(params, adamw_init(params), b)
            runs[dev.type] = (float(metrics["loss"]), opt)
        (hl, ho), (cl, co) = runs["cpu"], runs[device.type]
        worst = max(float((co[m][n].cpu() - ho[m][n]).abs().max())
                    / ((1 if m == "m" else 2) * SMOKE_TAMED_GRAD_TOL
                       * float(ho[m][n].abs().max()) + 1e-30)
                    for m in ("m", "v") for n in ho[m])
        tag = "bf16_grad" if over else "plain"
        log(f"launch: build_step train branch, SMOKE {ASSIGNED_ARCH} {tag}, weights x0.1, card "
            f"vs CPU: loss {cl:.7f} vs {hl:.7f}; worst moment leaf at {worst:.3f} of its limit "
            f"({SMOKE_TAMED_GRAD_TOL:g} of the leaf's largest magnitude for m, twice it for v)")
        check(abs(cl - hl) <= 1e-5 * abs(hl) and worst <= 1.0,
              f"launch: SMOKE train step {tag} card vs CPU past its limits")
        out[tag] = dict(loss_card=cl, loss_cpu=hl, moment_share_of_limit=worst)
    return out


def launch_tooling(device, wrappers):
    """(b) hymba-1.5b's decode at its assigned decode_32k and long_500k
    sizes through ``build_step``; (c) the prefill branch at prefill_32k's
    S with the batch cut to PREFILL_BATCH, and the train branch's SMOKE
    step card vs CPU with and without ``bf16_grad``."""
    import dataclasses
    import torch
    from repro_torch.launch import shapes, steps

    out = {"train_smoke": launch_train_smoke(device)}
    cfg, params, wbytes, draw_s = draw_model(ASSIGNED_ARCH, device)
    scale = cache_scale(cfg, params, device)
    log(f"launch: {ASSIGNED_ARCH} ({wbytes / 1e9:.3f} GB bf16 drawn in {draw_s:.2f} s); cache "
        f"leaves' std after a prefill of {SCALE_PROMPT[0]} x {SCALE_PROMPT[1]} tokens: {scale}")
    out["cache_std"] = scale
    launches = 0
    for name in ASSIGNED_DECODE:
        res = assigned_decode(device, wrappers, cfg, params, scale, name)
        out[name] = res
        launches += res["launches"]

    shape = dataclasses.replace(shapes.SHAPES["prefill_32k"], global_batch=PREFILL_BATCH)
    fn, args, _, _ = steps.build_step(cfg, shape, multi_pod=False)
    gen = torch.Generator(device).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, tuple(args[1]["tokens"].shape), generator=gen,
                           device=device, dtype=torch.int32)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    counts = {k: w.launches for k, w in wrappers.items()}
    check(sum(counts.values()) == 0 and bool(torch.isfinite(logits).all())
          and tuple(cache["global"]["k"].shape)[2] == shape.seq_len,
          f"launch: prefill_32k launches {counts}, logits finite {bool(torch.isfinite(logits).all())}")
    out["prefill_32k"] = dict(batch=PREFILL_BATCH, cut_from=shapes.SHAPES["prefill_32k"].global_batch,
                              seq_len=shape.seq_len, prefill_ms=prefill_ms,
                              tokens_per_s=PREFILL_BATCH * shape.seq_len / prefill_ms * 1e3,
                              peak_gb=(peak + base) / 1e9)
    log(f"launch: {ASSIGNED_ARCH} prefill_32k through build_step's prefill branch, batch "
        f"{PREFILL_BATCH} (cut from {shapes.SHAPES['prefill_32k'].global_batch}) x "
        f"{shape.seq_len} tokens: {prefill_ms:.1f} ms "
        f"({PREFILL_BATCH * shape.seq_len / prefill_ms * 1e3:.0f} tokens/s), logits finite, no "
        f"kernel launched (the reference prefills outside its Pallas kernels); peak memory "
        f"{(peak + base) / 1e9:.3f} GB")
    del params, cache, logits
    release()
    out["launches"] = launches
    return out


def split_launch_phase(device, wrappers):
    out = {"split": replica_split(device, wrappers), "launch": launch_tooling(device, wrappers)}
    return out


# ---------------------------------------------------------------------------
# phase 18: the mesh on the one card
# ---------------------------------------------------------------------------

MESH_ARCH = "llama3.2-1b"
MESH_BATCH = 16
MESH_PROMPT = 1024
MESH_STEPS = 4
MESH_SHAPES = {"p": (2, 1), "q": (1, 2)}  # ("data", "model")
#: the functional collectives each mesh's redistributions need between its
#: two ranks (DTensor calls them; (p) splits rows only)
MESH_NEEDS = {"p": ("all_reduce",),
              "q": ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")}
#: the limit of max |mesh logits - one-process logits| / max |logits|:
#: twice the one-process run's own spread in this run (its two halves of
#: 8 rows decoded alone against all 16 rows at once: the bf16 GEMMs take
#: other kernels and sum in another order, and random weights amplify it)
MESH_SPREAD_FACTOR = 2.0
#: (p)'s ranks against the one-process run of their own 8 rows: the same
#: kernels on the same rows, so equal bit for bit (measured 0 on an H100)
MESH_HALVES_TOL = 0.0
COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")


def collective_rank(rank, port, path):
    """One rank of phase 18's collective check (spawned): each collective
    on CUDA tensors under ``gloo``, through the blocking API and through
    the functional ops that DTensor calls; a line is written before and
    after each, so that a collective that ends the process is known."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    group = dist.group.WORLD
    x = torch.arange(4.0, device=device) + 10 * rank
    total = 2 * torch.arange(4.0) + 10
    want = {"all_reduce": total, "reduce_scatter_tensor": total[2 * rank:2 * rank + 2],
            "all_gather_into_tensor": torch.cat([torch.arange(4.0), torch.arange(4.0) + 10])}
    with open(f"{path}.{rank}", "w") as f:
        for api in ("blocking", "functional"):
            for name in COLLECTIVES:
                f.write(json.dumps([api, name, "started"]) + "\n")
                f.flush()
                try:
                    if api == "blocking":
                        if name == "all_reduce":
                            y = x.clone()
                            dist.all_reduce(y)
                        elif name == "reduce_scatter_tensor":
                            y = torch.empty(2, device=device)
                            dist.reduce_scatter_tensor(y, x)
                        else:
                            y = torch.empty(8, device=device)
                            dist.all_gather_into_tensor(y, x)
                    elif name == "all_reduce":
                        y = funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
                    elif name == "reduce_scatter_tensor":
                        y = funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, group))
                    else:
                        y = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, group))
                    err = None if torch.equal(y.cpu(), want[name]) else "wrong values"
                except Exception as e:  # the error text is the finding
                    err = f"{type(e).__name__}: {e}"
                f.write(json.dumps([api, name, err]) + "\n")
                f.flush()
    dist.destroy_process_group()


def gloo_on_cuda():
    """``{(api, collective): None}`` where it works on two ranks on
    ``cuda:0``, else its error; a collective during which a rank ended is
    reported with the ranks' exit codes."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        path = str(Path(d) / "collectives")
        ctx = mp.start_processes(collective_rank, args=(port, path), nprocs=2,
                                 start_method="spawn", join=False)
        codes = []
        for proc in ctx.processes:
            proc.join(300)
            if proc.is_alive():
                proc.kill()
                proc.join()
            codes.append(proc.exitcode)
        lines = [json.loads(ln) for r in range(2)
                 for ln in Path(f"{path}.{r}").read_text().splitlines()]
    started, results = [], {}
    for api, name, err in lines:
        if err == "started":
            started.append((api, name))
        else:
            results.setdefault((api, name), []).append(err)
    out = {}
    for key in dict.fromkeys(started):
        errs = results.get(key, [])
        out[key] = (f"a rank ended during it (exit codes {codes})" if len(errs) < 2
                    else next((e for e in errs if e), None))
    return out


def mesh_rank(rank, port, result_path, shapes_to_run):
    """One rank of phase 18 (spawned): writes its results as JSON."""
    import copy
    import datetime
    import faulthandler
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch import sharding
    from repro_torch.kernels.decode_attention import decode_attention as D
    from repro_torch.launch import mesh as meshlib, op_analysis, shapes, steps
    from repro_torch.models import common, model

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    res = {"rank": rank}
    try:
        cfg, params, weight_bytes, _ = draw_model(MESH_ARCH, device)
        total = MESH_PROMPT + MESH_STEPS + 1
        gen = torch.Generator(device).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_PROMPT), generator=gen,
                               device=device, dtype=torch.int32)
        forced = torch.randint(0, cfg.vocab, (MESH_STEPS, MESH_BATCH), generator=gen,
                               device=device, dtype=torch.int32)
        dshape = shapes.InputShape("d", total, MESH_BATCH, "decode")
        fn, args, _, _ = steps.build_step(cfg, dshape, multi_pod=False)
        # the one-process card runs: all 16 rows at once, and each half of
        # them alone (what a rank of (p) computes); the meshes scatter from rank 0
        want = torch.empty((MESH_STEPS, MESH_BATCH, cfg.padded_vocab), device=device)
        halves = torch.empty_like(want)
        if rank == 0:
            pfn = steps.build_step(cfg, shapes.InputShape("p", MESH_PROMPT, MESH_BATCH,
                                                          "prefill"), multi_pod=False)[0]
            _, cache = pfn(params, {"tokens": prompt})
            cache = model.pad_cache(cache, MESH_PROMPT, total)
            half = MESH_BATCH // 2
            for out, rows in ((want, [slice(0, MESH_BATCH)]),
                              (halves, [slice(0, half), slice(half, MESH_BATCH)])):
                for r in rows:
                    work = {k: {n: t[:, r].clone() for n, t in v.items()}
                            for k, v in cache.items()}
                    for i in range(MESH_STEPS):
                        logits, work = fn(params, work, forced[i, r], MESH_PROMPT + i)
                        out[i, r] = logits.float()
                    del work
        else:
            cache = {k: {n: torch.empty(t.shape, dtype=t.dtype, device=device)
                         for n, t in v.items()} for k, v in args[1].items()}
        dist.broadcast(want, 0)  # every rank holds the one-process logits
        dist.broadcast(halves, 0)
        res["spread"] = [float((halves[i] - want[i]).abs().max() / want[i].abs().max())
                         for i in range(MESH_STEPS)]
        torch.cuda.synchronize()
        for name in shapes_to_run:
            m = meshlib.make_mesh(MESH_SHAPES[name], ("data", "model"))
            fn, _, ins, _ = steps.build_step(cfg, dshape, multi_pod=False)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            placed = steps.place((copy.deepcopy(params), {k: {n: t.clone() for n, t in v.items()}
                                                          for k, v in cache.items()}),
                                 ins[:2], m)
            local_bytes = op_analysis.local_bytes(placed)
            errs, errs_halves, ms, launches, gathers, finite = [], [], [], [], [], True
            mode = op_analysis.OpAnalysis()
            c = placed[1]
            for i in range(MESH_STEPS):
                tok = steps.place(forced[i], ins[2], m)
                D.decode_attention.launches = 0
                common.cache_gathers.update(bytes=0, count=0)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with sharding.use_mesh(m), (mode if i == 0 else contextlib.nullcontext()):
                    logits, c = fn(placed[0], c, tok, MESH_PROMPT + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(D.decode_attention.launches)
                gathers.append(common.cache_gathers["bytes"])
                # this rank's rows and columns of the logits against the one-process run's
                shape_l, off = compute_local_shape_and_global_offset(
                    logits.shape, logits.device_mesh, logits.placements)
                part = (slice(off[0], off[0] + shape_l[0]), slice(off[1], off[1] + shape_l[1]))
                got = logits.to_local().float()
                errs.append(float((got - want[i][part]).abs().max() / want[i].abs().max()))
                errs_halves.append(float((got - halves[i][part]).abs().max()
                                         / want[i].abs().max()))
                finite &= bool(torch.isfinite(got).all())
            peak = torch.cuda.max_memory_allocated()
            a = mode.result
            res[name] = dict(
                mesh=dict(zip(("data", "model"), MESH_SHAPES[name])), errors=errs,
                errors_vs_halves=errs_halves, step_ms=ms,
                finite=finite, launches=launches, cache_gather_bytes=gathers,
                collectives_bytes=a.collective_breakdown, collective_ops=a.collective_count,
                logits_placements=[str(p) for p in logits.placements],
                placed_bytes=local_bytes, peak_gb=peak / 1e9, base_gb=base / 1e9)
            del placed, c, logits
            torch.cuda.empty_cache()
        res["weight_bytes"] = weight_bytes
    except Exception:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        with open(f"{result_path}.{rank}", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def mesh_phase(device, wrappers):
    """Phase 18: two ranks on the one card (see the module's docstring)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    works = gloo_on_cuda()
    for (api, name), err in sorted(works.items()):
        log(f"mesh: gloo {api} {name} on CUDA tensors, 2 ranks on cuda:0: {err or 'ok'} "
            f"(torch {torch.__version__})")
    check(all(works.get(("blocking", n)) is None for n in COLLECTIVES),
          "mesh: a blocking gloo collective failed on CUDA tensors")
    run = [n for n, needs in MESH_NEEDS.items()
           if all(works.get(("functional", c)) is None for c in needs)]
    out = {"arch": MESH_ARCH, "batch": MESH_BATCH, "prompt": MESH_PROMPT, "steps": MESH_STEPS,
           "torch": torch.__version__, "launches": 0,
           "collectives": {f"{a} {n}": e for (a, n), e in works.items()},
           "left_out": {n: [c for c in MESH_NEEDS[n] if works.get(("functional", c))]
                        for n in MESH_SHAPES if n not in run}}
    for name, missing in out["left_out"].items():
        log(f"mesh: ({name}) {dict(zip(('data', 'model'), MESH_SHAPES[name]))} left out: "
            f"DTensor's redistributions need the functional {', '.join(missing)}, which "
            f"fail on CUDA tensors under gloo here; it waits for a machine with several cards")
    check(bool(run), "mesh: no mesh can run")
    with tempfile.TemporaryDirectory() as d, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        path = str(Path(d) / "mesh")
        mp.start_processes(mesh_rank, args=(port, path, run), nprocs=2, start_method="spawn")
        ranks = [json.loads(Path(f"{path}.{r}").read_text()) for r in range(2)]
    for r in ranks:
        check("error" not in r, f"mesh: rank {r['rank']} failed:\n{r.get('error')}")
    out["weight_bytes"] = ranks[0]["weight_bytes"]
    layers = attention_layers_of(MESH_ARCH)
    spread = max(ranks[0]["spread"])
    limit = MESH_SPREAD_FACTOR * spread
    out["spread"] = ranks[0]["spread"]
    log(f"mesh: the one-process card run's spread, its halves of {MESH_BATCH // 2} rows alone "
        f"against all {MESH_BATCH} rows: max |diff| / max |logits| "
        + ", ".join(f"{e:.3e}" for e in ranks[0]["spread"]) + f" by step; limit {limit:.3e}")
    for name in run:
        r0, r1 = ranks[0][name], ranks[1][name]
        worst = max(max(r[name]["errors"]) for r in ranks)
        worst_halves = max(max(r[name]["errors_vs_halves"]) for r in ranks)
        per_step = [r[name]["launches"] for r in ranks]
        out["launches"] += sum(map(sum, per_step))
        ms = [sum(r["step_ms"][1:]) / (MESH_STEPS - 1) for r in (r0, r1)]
        log(f"mesh: ({name}) {r0['mesh']} on cuda:0 x 2 ranks: {MESH_STEPS} decode steps, "
            f"first {r0['step_ms'][0]:.1f} ms, then {ms[0]:.1f} / {ms[1]:.1f} ms a step "
            f"(rank 0 / 1); decode_attention launches a step {per_step[0]} / {per_step[1]}; "
            f"collectives of the first step (rank 0) {r0['collective_ops']} ops"
            + "".join(f", {k} {v / 1e6:.3f} MB" for k, v in sorted(
                r0["collectives_bytes"].items()))
            + f"; cache gathered a step {r0['cache_gather_bytes'][-1] / 1e6:.3f} MB a rank; "
            f"placed arguments {r0['placed_bytes'] / 1e9:.3f} / {r1['placed_bytes'] / 1e9:.3f}"
            f" GB; peak {r0['peak_gb']:.3f} / {r1['peak_gb']:.3f} GB a rank; logits "
            f"{r0['logits_placements']} vs the one-process card run, each rank its own part: "
            f"max |err| / max |logits| {worst:.3e} (limit {limit:.3e}); against the "
            f"one-process run of the same {MESH_BATCH // 2} rows {worst_halves:.3e}")
        check(all(n == layers for r in per_step for n in r),
              f"mesh ({name}): decode_attention launches a step {per_step}, not {layers}")
        check(r0["finite"] and r1["finite"] and worst <= limit,
              f"mesh ({name}): logits error {worst} over {limit}")
        check(name != "p" or worst_halves <= MESH_HALVES_TOL,
              f"mesh (p): logits {worst_halves} from the one-process run of the same rows")
        out[name] = dict(r0, ms_per_step=ms, worst_error=worst, worst_vs_halves=worst_halves,
                         rank1={k: r1[k] for k in ("step_ms", "launches", "peak_gb",
                                                    "placed_bytes", "collectives_bytes",
                                                    "errors", "errors_vs_halves")})
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh: phase seconds {out['seconds']:.1f}")
    return out


def attention_layers_of(arch) -> int:
    from repro_torch.configs import ARCHS

    return attention_layers(ARCHS[arch])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention as D
    from repro_torch.kernels.fragscore import fragscore as K

    # the plain versions' float32 products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        built = dict(zip(build.SOURCES, pool.map(build.build, build.SOURCES)))
    K._lib()
    D._lib()
    log(f"build: {len(built)} libraries in {time.perf_counter() - t0:.2f} s")
    for name, result in built.items():
        log(f"  {result.path.name}: nvcc {result.seconds:.2f} s")
        for line in result.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    wrappers = {"fragscore": K.fragscore, "delta_from_base": K.delta_from_base,
                "select_from_base": K.select_from_base, "migrate_refine": K.migrate_refine,
                "decode_attention": D.decode_attention, "mfi_delta": K.mfi_delta}
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        log(f"phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    rows = kernel_phase(device)
    lap(3)
    golden_phase(device)
    lap(4)
    steady, rates = full_width_phase(device)
    fig5, fig5_launches = fig5_phase(device, wrappers)
    lap(5)
    rows["decode_attention"] = decode_attention_phase(device)
    lap(6)
    serving = serving_phase(device, wrappers)
    lap(7)
    rows["mfi_delta"] = mfi_delta_phase(device)
    lap(8)
    decisions = decision_phase(device, wrappers)
    lap(9)
    protocols = protocols_phase(device, wrappers)
    lap(10)
    faults = faults_phase(device, wrappers)
    lap(11)
    training = training_phase(device, wrappers)
    lap(12)
    dense = dense_options_phase(device, wrappers)
    lap(13)
    experts = moe_phase(device, wrappers)
    lap(14)
    ssm_families = ssm_phase(device, wrappers)
    lap(15)
    encdec = encdec_phase(device, wrappers)
    lap(16)
    split_launch = split_launch_phase(device, wrappers)
    lap(17)
    meshes = mesh_phase(device, wrappers)
    lap(18)
    # each path's launches, counted from zero just before it ran
    by_path = {name: dict.fromkeys(wrappers, 0) for name in (
        "steady", "fig5", "serving", "decisions", "protocols", "faults", "dense_options", "moe",
        "ssm", "encdec", "split", "launch", "mesh")}
    by_path["steady"].update(steady)
    by_path["fig5"].update(fig5_launches)
    by_path["serving"]["decode_attention"] = serving["launches"]
    by_path["decisions"]["mfi_delta"] = decisions["launches"]
    by_path["protocols"].update(protocols["launches"])
    by_path["faults"].update(faults["launches"])
    by_path["dense_options"]["decode_attention"] = dense["launches"]
    by_path["moe"]["decode_attention"] = experts["launches"]
    by_path["ssm"]["decode_attention"] = ssm_families["launches"]
    by_path["encdec"]["decode_attention"] = encdec["launches"]
    by_path["split"].update(split_launch["split"]["launches"])
    by_path["launch"]["decode_attention"] = split_launch["launch"]["launches"]
    by_path["mesh"]["decode_attention"] = meshes["launches"]
    totals = {k: sum(p[k] for p in by_path.values()) for k in wrappers}

    kernels = []
    for name, row in rows.items():
        extra = {k: row[k] for k in ("tolerance", "errors", "bound_ratios", "long", "middle", "b1_32k",
                                     "gemma3_ring", "gemma3_wrapped", "qwen3_g5_d128",
                                     "starcoder2_g12_d128", "paligemma_k1_g8_d256",
                                     "granite_g3", "grok_smoke", "hymba_g5_d64",
                                     "whisper_self_g1", "whisper_cross_g1",
                                     "hymba_decode_32k", "hymba_long_500k",
                                     "library_call_ms", "by_m", "pass0_ms", "pass1_ms")
                 if k in row}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=totals[name],
            launches_by_path={p: c[name] for p, c in by_path.items() if c[name]},
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms"), call_ms=row["call_ms"],
            plain_call_ms=row["plain_call_ms"], ms_source=row["ms_source"],
            shape=row["shape"], **extra))
    log(json.dumps({"engine_replica_events_per_s": {
        k: {"kernel": v[0], "plain": v[1]} for k, v in rates.items()}}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"decisions": decisions}))
    log(json.dumps({"fig5": fig5}))
    log(json.dumps({"protocols": protocols}))
    log(json.dumps({"faults": faults}))
    log(json.dumps({"train": training}))
    log(json.dumps({"dense_options": dense}))
    log(json.dumps({"moe": experts}))
    log(json.dumps({"ssm": ssm_families}))
    log(json.dumps({"encdec": encdec}))
    log(json.dumps(split_launch))
    log(json.dumps({"mesh": meshes}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
