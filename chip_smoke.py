"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py [--compare-with DIR [DIR ...]]

Needs one NVIDIA GPU and nvcc.  In order:

1. prints the card, its power limit and the TF32 flags;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   prints ptxas's registers and spills of every kernel (the fused trust
   kernel must not spill);
3. builds the main path's federation (``paper-mlp-fleet1k``: 1,024
   devices in 16 clusters, the paper's 784-200-10 MLP, 65,536 synthetic
   samples, trust aggregation, Lyapunov control) and, at the shapes its
   rounds give the kernels and at ragged ones, holds every kernel against
   its plain PyTorch version and times kernel, plain version and a library
   call with CUDA events;
4. drives the main path through the user entry points, each path with the
   launch counts set to 0 just before it and read just after:
   ``run_scanned(30)``, then an event-heap ``run(max_rounds=20)`` with a
   fixed a=5, then one Eqn-6 aggregation of the cluster models through
   ``Federation.aggregator``; checks the counts, the state's device, finite
   losses and the final accuracy; between the last two, three more scanned
   rounds hold the fused kernel against its plain version on the round's
   own inputs;
4b. the paper's full scheme (``paper-adaptive-fleet1k``: the same
   federation under the DQN controller): pretrains the DQN on the card (3
   episodes of 20 steps, timed), holds its Q-values against the same
   parameters on the CPU (atol = rtol = 1e-5, greedy actions equal), then
   ``run_scanned(30)`` (30 fused launches) and an event-heap
   ``run(max_rounds=20)`` whose host ``select`` reads ``ctx.obs()`` (20
   launches, 20 observations read); checks the state's device, finite
   losses and the final accuracy against the JAX package's;
4c. the autoencoder-anomaly task (``anomaly-fleet1k``: 1,024 devices in
   16 clusters, the 32-64-8-64-32 autoencoder, N = 5,288, the same DQN
   controller, pretrained on the card through the registry):
   ``run_scanned(30)`` (30 launches), three more scanned rounds with the
   fused kernel held against its plain version on each round's own
   inputs (3 launches), the final AUC against the JAX package's, and the
   fused kernel timed cold and warm at this shape beside its bound, with
   its launch plan (threads, row split, tile, grid, cluster launch or
   not), as at the main path's shape;
4d. DP, the robust rules and the fault model on the same fleet (the
   two-step path: Eqn 6 through the rule or the masked kernel, Eqn 19
   through the unmasked one): ``dp-fleet1k`` ``run_scanned(30)`` (30
   masked and 30 unmasked launches, no fused one), ``faulty-fleet1k``
   ``run_scanned(30)`` then ``run(max_rounds=20)`` (30 + 20 fused),
   ``faulty-median-fleet1k`` ``run_scanned(30)`` (30 unmasked), and krum
   on ``paper-mlp-fleet1k``'s fleet, ``run(max_rounds=10)`` (10 unmasked,
   exact-shape clusters, its peak memory printed); after each, three more
   rounds hold every launched kernel against its plain version on the
   live inputs (1e-6, the fused kernel 1e-5); the state's device, finite
   losses and the final accuracies against the JAX package's (under
   faults over seeds 0-9: nine more ``run_scanned(30)`` of each faulty
   spec); then the
   unmasked kernel timed at Eqn 19's (16, 159,010), cold and warm, in
   turns with ``w @ x``, beside its bound;
4e. the service mode (``repro_torch.serve``) at full width, in temporary
   run dirs: ``run_service`` in 10-round segments on
   ``paper-mlp-fleet1k``, two segments then a resume for a third against
   three straight (trace.jsonl byte-equal, the manifests' f64 energy
   equal, 10 fused launches a segment, the service's status metrics), one
   more round restored from the checkpoint with the fused kernel held
   against its plain version (1e-5); then the chaos harness on
   ``paper-adaptive-fleet1k`` (three segments, one SIGKILL, ``python -m
   repro_torch.serve`` children on the card, each pretraining its DQN and
   reporting its kernel-library load as a compile event) against an
   in-process uninterrupted run, byte-equal; then ``service_status``, the
   ``metrics`` and ``status --watch --once`` subcommands on its run dir.
   78.1 s on one H100 (the chaos run 32.8 s of it; 17.6 s on a host
   twice as fast);
4f. populations (``repro_torch.pop``, ``repro_torch.serve.pool``): the
   population-batched kernels against their batched plain versions at
   the main population's shapes (P 8, C 99, B 16, N 159,010; P 8, C 111,
   N 5,288) and ragged ones, every slice bitwise against the single
   kernel, timed cold, warm and back to back beside their bounds, the
   library calls and P single launches; then the B = 8 population of
   ``paper-mlp-fleet1k`` (lr {0.05, 0.1} x 4 replicates) through
   ``PopulationEngine.from_population(pspec).run_scanned(30)`` (30 batched
   fused launches, no single one) and a steady ``run_scanned(10)``
   (member-rounds/s), two more rounds holding the batched kernel against
   its plain version on the live inputs; every member against a
   standalone ``run_scanned(30)`` run of its spec in this process
   (schedule equal, accuracy within 0.002); ``dp-fleet1k`` with
   ``privacy.noise``
   {0.25, 0.5} (10 batched masked and 10 batched unmasked launches, then
   live checks); and ``python -m repro_torch.serve pool start|resume|
   status`` on a 2-member population in 10-round segments against a
   straight pool (traces byte-equal), with a ragged frontier resumed to
   the common step;
4g. the paper's own entry point and evaluation (``repro_torch.core.
   AsyncFederation``, ``repro_torch.paper``): ``get_config("paper_mnist")``
   (16 devices in 4 clusters, the 784-200-10 MLP, N = 159,010) through the
   legacy shim under a DQN trained on the card by ``train_dqn_agent``
   (one fused launch a round), then ``run_sync_baseline`` on the same data
   (one cluster of 16, one fused launch a round), each followed by three
   rounds on live inputs; Figs 2-8 once at the protocol's seeds (every
   row, each figure's seconds and launches), each number held to the JAX
   package's five seeds (``JAX_FIGURES``) and every ordering those seeds
   all show; the fused kernel on live inputs at Figs 6/7's N = 21,410 with
   one cluster and with eight, timed there; the full robustness grid
   (each fault mode one B = 2 population, one batched fused launch a
   population round and no single one, beside its two sequential runs;
   every member within 1e-6 of its run), the sign of the trust recovery
   wherever the JAX package's exceeds 0.1, the batched kernel on two
   populations' live inputs (NaN in the same places where fedavg
   diverges); the secure-aggregation example's eight cells with their
   launches and live checks;
5. serving: recurrentgemma-2b at full width (26 layers, d_model 2560,
   f32 weights from seed 0) through ``repro_torch.launch.serve.generate``:
   first each language-model kernel against its plain version at the
   serving path's shapes, at the JAX tests' parametrisations and at ragged
   ones (every output-width template, odd head dims, grouped heads,
   windows shorter than a tile), timed beside the plain version and a
   library call, with attention's bound on the CUDA cores and on the
   tensor cores (3xTF32); then batch 4,
   4096-token Zipf prompts (longer than the 2048 window, so the window
   mask and the ring-buffer wrap both run), 32 greedy tokens (31 decode
   steps), with the launch counts set to 0 before the prefill and read
   after it (8 flash_attention, 18 rglru_scan) and after the decode loop
   (none); the kernels' outputs on the first LOCAL and first RG-LRU
   layer's own inputs held against their plain versions; and the decode
   step at position 4096 held against a prefill of all 4097 tokens.  The
   attention kernel is also checked at the shapes phase 7 gives it (MLA's
   (4, 4096, 128 heads, d 192, dv 128), a ragged d != dv, qwen1.5-32b's
   40 heads of 128 with Kv = 40, grok-1's 48/8 heads under a cap of 30)
   against its plain version (over slices of batch and heads where the
   whole scores would not fit), and timed at MLA's shape beside its bound
   and ``scaled_dot_product_attention`` (its memory-efficient backend);
6. serving: falcon-mamba-7b at full width (64 MAMBA layers, d_model 4096,
   d_inner 8192, N 16, 7.0e9 f32 parameters from seed 0), after
   recurrentgemma-2b is freed: first the selective-scan kernel against its
   plain version at the serving path's shape, at the JAX tests'
   parametrisations and at ragged ones, timed beside the plain version,
   with its bound from bytes, flops and exponentials; the forward that
   also writes the chunk states for training held bit for bit to
   serving's forward (y, h_last) and its states to the plain ones; then
   the same
   traffic (batch 4, 4096-token prompts, 32 greedy tokens) with the counts
   read after the prefill (64 selective_scan) and the decode loop (none),
   the kernel on the first MAMBA layer's own inputs held against its plain
   version, and the 4096 + 1 consistency check; then frees falcon-mamba-7b
   and the libraries' workspaces;
7. serving the JAX package's seven other architectures at full width,
   one after another, each freed before the next is built, with phase 5's
   traffic through ``generate``, cut in depth to keep the script inside
   its time limit: gemma-7b (14 of 28 layers), granite-3-8b (20 of
   40), musicgen-large (24 of 48, four codebooks: (4, 4, 4096) prompts,
   (4, 4, 32) tokens), qwen1.5-32b (8 of 64 layers, qkv bias),
   chameleon-34b (8 of 48, qk-norm), grok-1-314b (2 of 64 MoE layers, 8
   experts top-2, cap 30) and deepseek-v2-236b (3 of 60: the dense layer
   and two MoE layers,
   MLA, 160 experts top-6 and 2 shared): each prints its parameters, its
   prefill seconds, decode tokens/s and peak memory beside the card's
   name and power limit; the prefill must launch ``flash_attention`` once
   an attention layer and decode none; the first launch is held against
   the plain version on its own inputs; token ids in range and logits
   finite; the dense and audio models' decode at position 4096 within
   2e-2 of a 4097-token prefill.  The MoE models' capacity depends on the
   tokens of a call (grok: 5,120 slots an expert in the prefill, 1 at
   decode), so their prefill and decode drop different assignments: the
   same gap and the dropped assignments of the prefill, the decode and
   the 4097-token prefill are reported, not bounded (their routing is held
   against the JAX package on the CPU, tests/test_torch_lm_moe.py);
8. training: federated mode A (``fedavg_replica``) of recurrentgemma-2b
   at full width cut to one Griffin period (RG-LRU, RG-LRU, local
   attention; 912,320,000 f32 parameters from seed 0), NC 2 x C 2 clients,
   4096-token sequences, a fixed a = 2 local Adam steps of 2 microbatches
   a round (``RECURRENTGEMMA_2B_TRAIN``), after falcon-mamba-7b is freed:
   first the forward's lse output and both backward kernels
   (``flash_attention_bwd``, ``rglru_scan_bwd``) against their plain
   versions at the training shape and at ragged ones (S = 1, 31, 33, 4097
   and others not a multiple of any tile, H / Kv = 10, 5, 3, 2 and 1,
   softcap 30, d = 48 and 33, W not a multiple of the scan's channels a
   block), two calls of each backward bit for bit equal, the forward with
   a null lse pointer bit for bit the forward with one, each backward
   timed cold and warm beside its bound, the plain version and a library
   call
   (``torch.autograd.grad`` through ``scaled_dot_product_attention``;
   ``addcmul`` over the scan's bytes); then three rounds through
   ``Federation.from_spec(spec).run(max_rounds=3)`` with the launch counts
   set to 0 before and read after (each kernel exactly its schedule:
   clients x a x microbatches x layers of its kind, the forwards doubled
   by the per-layer checkpoint), finite losses, the last round's mean
   below the first's, the state on the card, the peak memory; one client's
   gradients on the last round's own microbatch through the kernels
   against the plain versions (forward and backward); mode B
   (``trust_fsdp``, NC 2) for one round, its counts
   checked the same way
   (its training CLI runs in phase 9b);
9. training falcon-mamba-7b: federated mode A at full width (d_model 4096,
   d_inner 8192, N 16, vocabulary 65,024) cut to two MAMBA layers
   (476,966,912 f32 parameters from seed 0) with phase 8's clients,
   sequences and schedule (``FALCON_MAMBA_7B_TRAIN``), after phase 8's
   memory is freed: first the selective-scan backward kernel
   (``selective_scan_bwd``) against its plain version at the training
   shape (1, 4096, 8192, 16) and at ragged ones (S = 1, 31, 33, 4097; Di
   not a multiple of its 64 channels a block; N = 4, 16, 17, 32, 64; B =
   2 and 3; d h_last absent, zero and random; a dt whose decays
   underflow), each gradient within 1e-4 of its largest entry, two calls
   bit for bit equal; timed cold and warm given the forward's chunk states
   (as training calls it) and with the forward writing them, beside its
   bound, its warps resident an SM, the plain version and ``addcmul``
   over its largest arrays; the forward at B = 1 with and without its
   states output in turns; then three rounds
   through ``Federation.from_spec(spec).run(max_rounds=3)`` (64
   ``selective_scan``, 32 of them writing chunk states (the checkpoint's
   recomputes), and 32 ``selective_scan_bwd`` a round, exactly),
   each round's seconds, the peak memory (< 80 GB), finite losses falling
   from the first round to the third, one client's gradients through the
   kernels against the plain versions (1e-3 of each parameter's largest
   entry, the loss 1e-5 relative) (its training CLI runs in phase 9b);
9b. training the MoE, MLA and audio models, after phase 9's memory is
   freed: first the forward's lse output and ``flash_attention_bwd``
   against their plain versions (over head slices) at ragged shapes with
   d != dv (d 24 / dv 16, 192 / 64, 72 / 40; S = 1, 33, 4097; H / Kv =
   1, 2, 4) and at the training shapes of deepseek-v2's MLA (1, 4096, 128
   heads, d 192, dv 128) and musicgen-large (1, 4096, 32 heads, d 64),
   each gradient within 1e-4 of its largest entry, two calls bit for bit
   equal, both kernels timed warm and cold at the training shapes beside
   their bounds (3xTF32 operations), the plain backward and
   ``torch.autograd.grad`` through ``scaled_dot_product_attention`` (the
   first fused backend that takes the head dims; the others' refusals
   printed); then three rounds each of ``DEEPSEEK_V2_236B_TRAIN``
   (mode B, NC 2; full width cut to the dense layer 0 and one MoE layer
   of 16 routed experts, 1,960,555,520 f32 parameters) and
   ``MUSICGEN_LARGE_TRAIN`` (mode A, NC 2 x C 2; full width cut to 4
   layers) through ``Federation.from_spec(spec).run(max_rounds=3)``, each
   freed before the next is built: the launches exactly their schedule
   (16 ``flash_attention_bwd`` and 32 forwards a deepseek round, 64 and
   128 a musicgen round), each round's seconds, the peak memory (< 80 GB),
   finite losses falling from the first round to the third, deepseek's
   dropped assignments a round; one client's gradients on the last
   round's microbatch through the kernels against the plain versions
   (1e-2 of each parameter's largest entry, the loss 1e-5 relative; the
   plain pass replays the kernel pass's MoE routing, and the assignments
   its own router would move are counted; two kernel passes bit for bit
   equal); and ``python -m repro_torch.launch.train [--arch A] --steps
   3`` for the default recurrentgemma-2b, falcon-mamba-7b, grok-1-314b,
   deepseek-v2-236b and musicgen-large side by side on the card (their
   smoke configs; grok's only training run on the card), each of which
   must exit 0;
10. the cluster-major federation over ``torch.distributed`` ranks
   (``repro_torch.api.cluster_engine``), its ranks started by
   ``repro_torch.launch.distributed.spawn_local`` on this script's hidden
   ``--dist-worker`` flag: ``paper-mlp-fleet1k`` at full width at mesh
   (1,) (NCCL, one rank) and at mesh (2,) (gloo, two ranks sharing
   cuda:0), each ``run_scanned(30)`` then ``run(max_rounds=10)``, and
   ``faulty-fleet1k`` and ``dp-fleet1k`` at mesh (2,), ``run_scanned(30)``,
   and ``paper-adaptive-fleet1k`` (its DQN pretrained on rank 0 alone and
   broadcast at build) at mesh (2,), ``run_scanned(30)`` then
   ``run(max_rounds=10)``: every rank's trace equal to the others', and
   the schedule (cluster, a, round, agg_count) equal to the unsharded port
   engine's of this process on the same seed (the DQN federation's: to
   rank 0's unsharded engine under the same net), t, losses and energy
   within 1e-5 relative; exactly 2
   all-reduces a scanned round and 3 an event round on every rank, one
   masked ``trust_aggregate`` a round over the ranks, one unmasked a round
   on each rank and no fused one; three more rounds with every trust
   kernel call held against its plain version (1e-6); B = 8 replicates of
   ``paper-mlp-fleet1k`` as a population over the two ranks against the
   unsharded population (schedule equal, values bit for bit or within
   1e-6); the steady rounds/s of each mesh beside the unsharded engine's
   of the same process (rank 0: three interleaved windows of 20 scanned
   rounds each, their median and spread), the
   all-reduce milliseconds a round (over 5 rounds, as the population's
   rounds), each rank's backend, device and
   peak memory, the kernel library each rank loaded; then the unmasked
   kernel timed at a rank's Eqn-19 shape (C_loc 8, N 159,010);
10b. the partitioner-inferred placement (``impl='gspmd'``:
   `DeviceScaleEngine` on DTensors over a ``DeviceMesh`` of ranks),
   started by ``spawn_local`` on the hidden ``--gspmd-worker`` flag: at
   meshes (1,) and (1, 1) (one NCCL rank: DTensor's all-gather of CUDA
   tensors over gloo, which ranks that share the card would need, ends the
   process with a segfault, so those meshes are all this card runs)
   ``paper-mlp-fleet1k`` ``run_scanned(10)`` then ``run(max_rounds=5)``,
   ``dp-fleet1k`` and ``paper-adaptive-fleet1k`` ``run_scanned(10)``,
   each bit for bit the unsharded engine of the same process (the DQN's
   under the same net); the trust kernels' launches a round equal to the
   unsharded engine's; DTensor's collectives a round by kind and bytes;
   the steady rounds/s of each mesh beside the unsharded engine's (three
   interleaved windows of 10 rounds); each rank's peak memory; then two
   gloo ranks sharing the card, whose mesh (2,) must refuse with the
   placement's `RuntimeError` naming the all-gather;
11. the sharded federated LM step (`repro_torch.core.sharding`, the JAX
   package's partition specs as DTensor placements), started by
   ``spawn_local`` on the hidden ``--train-sharded-worker`` flag as one
   NCCL rank at mesh (1, 1): recurrentgemma-2b at full width cut to 3
   layers, mode A, NC 1 x C 2, and deepseek-v2-236b at full width with 2
   layers of 16 routed experts, mode B, NC 1, each one round of the
   sharded step from seed 0 under Adafactor and one of the unsharded step
   from the same seed on the same card: the
   parameters after the round and its losses bit for bit, each kernel's launches a round equal
   (and every kernel of the path launched), seconds a round both ways,
   peak memory, and the collectives a round by kind and bytes (the step's
   own and DTensor's: none at one rank); then recurrentgemma-2b (C 1, one
   microbatch, one round) at mesh (1, 2) on two gloo ranks sharing the
   card, the heads, channels and vocab split: within 1e-5 of the
   unsharded step, every kernel of the path launched on each rank, as
   often as the unsharded step; ``scripts/train_cards.py``
   runs the same worker on four cards;
12. sharded serving, in phase 11's two jobs: the serving plans'
   (`launch.plans.prefill_plan` / ``decode_plan``) step_fn on placed f32
   weights, each rank's shards drawn on the card from seed 0 a layer at a
   time, batch 4 x 4096-token prompts: at mesh (1, 1) recurrentgemma-2b,
   falcon-mamba-7b and deepseek-v2-236b (3 of 60 layers), a prefill and
   16 greedy steps, every logit and cache bit for bit `LM.prefill` /
   ``decode_step`` on the same weights and the launches a prefill equal
   (8 ``flash_attention`` + 18 ``rglru_scan``; 64 ``selective_scan``; 3
   ``flash_attention``), none in decode; at mesh (1, 2), two gloo ranks
   sharing the card, deepseek-v2 (its latent cache split on its slots,
   64 heads a rank: the context-parallel decode) and recurrentgemma-2b
   (5 heads and 1280 RG-LRU channels a rank), the prefill and 8 steps fed
   the (1, 1) run's tokens, its MoE routing replayed: the prefill within
   1e-5 of the (1, 1) run's largest logit, each step (its attention's
   bfloat16 casts of weights and output left out on both sides) within
   1e-5 of the unsharded ``decode_step`` on the cache and new entries the
   sharded step read (`sharded_serve_run`), every kernel of the path
   launched on each rank;
   seconds, each rank's peak memory and a decode step's collectives by
   kind and bytes;
13. training at the plans' bfloat16, in phase 11's NCCL job:
   `launch.plans.train_plan`'s step (parameters bfloat16 but the float32
   leaves, Adafactor) of recurrentgemma-2b (3 layers) and falcon-mamba-7b
   (2 layers) at full width, mesh (1, 1), 4 sequences of 4096 tokens, the
   launch counts set to 0 before the step and read after (every kernel
   of the path, the bfloat16 instances of the attention's forward with
   lse and backward and of the selective scan's forward with chunk states
   and backward among them), the loss finite and the parameters still
   bfloat16; the dry run's estimate of the same step on meta arguments
   (`launch.dryrun`) against the step: its peak within 15 % of
   ``max_memory_allocated`` and its operations equal to the step's as
   counted (`launch.op_stats`); then, in this process, each bfloat16
   kernel against its plain version at that step's shapes (and the
   RG-LRU backward's bfloat16 instance, which no path launches: both
   packages scan float32 gates), timed beside the plain version, SDPA at
   bfloat16 for the attention, and its bound;
14. prints the federations line (4b, 4c and 4d), the serving line, the
   service line (4e: each segment's ``service_rounds_per_sec``, its
   checkpoint's seconds and bytes, the chaos children's start-up seconds,
   kills and restarts, beside the card's name and power limit), the
   population line (4f: member-rounds/s beside the standalone rounds/s,
   accuracies, peak memory, the pool's wall times), the paper line (4g:
   each figure's metrics, seconds and launches, the JAX bands, the grid's
   recovery and its population against sequential seconds, the
   secure-aggregation cells, beside the card's name and power limit), the
   training line (8, 9 and 9b: seconds a round, losses, launches,
   peak memory), the multi-device line (10, beside the card's name and power
   limit), the gspmd line (10b, likewise), the sharded-training line
   (11, likewise), the sharded-serving line (12, likewise), the bfloat16
   training line (13), the kernels line, then the result line.

The trust kernels are timed back to back through their wrappers (the
kernels line's ``ms`` and ``library_ms``) and by device time, warm (ten
calls from one CUDA graph) and cold (the L2 flushed before each call;
``warm_ms`` and ``cold_ms``), each in turns with its library call, with
every window's time and the SM clock printed.
``--compare-with DIR ...`` also times the ``trust_aggregate.cu``,
``flash_attention.cu``, ``rglru_scan.cu``, ``selective_scan.cu``,
``flash_attention_bwd.cu``, ``rglru_scan_bwd.cu`` and
``selective_scan_bwd.cu`` found in each DIR
(other versions of the kernels, with the same C interface) against this
checkout's, in turns (old, new, new, old) at the main path's, the serving
paths' and the training shapes (the fused trust kernel also at
``anomaly-fleet1k``'s; the backwards warm and cold), and adds those times
to the kernels line.  Each DIR's ``selective_scan_bwd.cu`` is timed
against this checkout's backward given the forward's chunk states; each
DIR's ``selective_scan.cu`` is also timed at B = 1 against this checkout's
forward with and without its states output.

Any failure exits non-zero before the result line.  Without a card, or
without the repository's ``src/`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM, TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12        # H100 SXM, bf16 tensor cores, dense
SOURCE = "src/repro_torch/kernels/csrc/trust_aggregate.cu"
PALLAS = "src/repro/kernels/trust_aggregate.py"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
SSM_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
FA_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu"
SSM_BWD_SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
HERE_CSRC = os.path.join(HERE, os.path.dirname(SOURCE))
SFU_EXP_PER_CLOCK_PER_SM = 16    # special-function units, compute cap. 9.0
L2_FLUSH_BYTES = 256 * 2 ** 20   # > 5 x the H100's 50 MB L2

# the serving paths: recurrentgemma-2b and falcon-mamba-7b at full width
ARCH = "recurrentgemma-2b"
MAMBA_ARCH = "falcon-mamba-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
RECURRENT_TRAIN_SEQ = 4096      # RECURRENTGEMMA_2B_TRAIN's sequence
CONSISTENCY_TOL = 2e-2          # tests/test_models.py's prefill/decode bound
# tests/test_kernels.py's tolerances: attention atol = rtol; the scan atol
# with rtol 0.05
FA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}

# training (phase 8): recurrentgemma-2b at full width cut to one Griffin
# period, `repro_torch.api.scenarios.RECURRENTGEMMA_2B_TRAIN`
TRAIN_ROUNDS_A, TRAIN_ROUNDS_B = 3, 1
# the backward kernels against their plain versions (the gradient formulas
# in cuBLAS products and a serial loop): every gradient within BWD_TOL of
# its largest entry.  The kernels sum over keys, queries and chunks in
# another order, on FMAs; the first run on the card showed at most
# 7.1e-6 at the training shape
BWD_TOL = 1e-4
# one client's gradients through the kernels against the plain versions
# (forward and backward), each parameter within LIVE_GRAD_TOL of its
# largest entry.  The two paths' forwards differ by the attention kernel's
# 3xTF32 rounding (~1e-6 relative), and the backward amplifies it where it
# subtracts nearly equal terms: dS = p (dP - D), D = sum_j p dP, cancels
# to a 1 - max p share of its terms on a peaked softmax, so the K and Q
# projections' gradients carry ~1e-6 / (1 - max p).  A first bound of
# 1e-3, set before any run, was exceeded by the K projection (1.01e-3 of
# its largest entry, the loss equal to 4e-7); the bound is ten times
# that, and the loss must agree to LIVE_LOSS_TOL
LIVE_GRAD_TOL = 1e-2
LIVE_LOSS_TOL = 1e-5
# training falcon-mamba-7b (phase 9): full width cut to two MAMBA layers,
# `repro_torch.api.scenarios.FALCON_MAMBA_7B_TRAIN`.  Its live gradients
# are held to LIVE_GRAD_TOL_MAMBA of each parameter's largest entry, a
# bound set before any run: a Mamba layer has none of the softmax
# cancellation that raised attention's to LIVE_GRAD_TOL
TRAIN_ROUNDS_MAMBA = 3
LIVE_GRAD_TOL_MAMBA = 1e-3

# the JAX package's final accuracy on this spec after 30 scanned rounds
# (on a CPU); the port draws its own random numbers, so it is held to that
# figure less a margin, 20 times the gap of the port's earlier runs on the
# card (0.99988)
JAX_ACC = 0.99997
ACC_MARGIN = 0.002
# the JAX package's final accuracy (paper-adaptive-fleet1k) and detection
# AUC (anomaly-fleet1k) after run_scanned(30), the least over seeds 0-2 on
# a CPU (scripts/jax_reference.py: 0.999969, 0.999985, 0.999969 and
# 0.90184, 0.92831, 0.91717); the AUC's margin is about twice the spread
# of the JAX package's own seeds (0.026)
JAX_ADAPTIVE_ACC = 0.999969
JAX_ANOMALY_AUC = 0.90184
AUC_MARGIN = 0.05
# the JAX package's final accuracy after run_scanned(30) on a CPU
# (scripts/jax_reference.py).  dp-fleet1k: the least over seeds 0-2
# (0.999969, 0.999969, 0.999985), with the main path's margin.  Under
# faults the final accuracy of one seed moves far with the seed (JAX:
# 0.078-0.489 under trust), so the port's seeds 0-9 are held to the JAX
# package's seeds 0-9: the means within three standard errors of the
# difference of two 10-seed means (3 sqrt(2) s / sqrt(10), s the JAX
# seeds' standard deviation, 0.124 and 0.0336), the least no lower than
# the JAX package's least less the same margin
JAX_DP_ACC = 0.999969
JAX_FAULTY = {"accs": [0.415359, 0.400986, 0.408966, 0.243011, 0.078491,
                       0.187836, 0.261993, 0.489395, 0.274734, 0.280746],
              "mean_margin": 0.166}
JAX_FAULTY_MEDIAN = {"accs": [0.981522, 0.981628, 0.912994, 0.956253,
                              0.867981, 0.931854, 0.930527, 0.957474,
                              0.946533, 0.939545],
                     "mean_margin": 0.045}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_side_stream = None


def graphed(fn, reps: int):
    """One CUDA graph of ``reps`` calls of ``fn``, warmed up on a side
    stream that every capture shares: cuBLAS keeps a 32 MiB workspace for
    each stream a library call has run on until `free_library_memory`."""
    global _side_stream
    if _side_stream is None:
        _side_stream = torch.cuda.Stream()
    side = _side_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g


def free_library_memory() -> None:
    """Frees the cuBLAS workspaces that the timed library calls left (one
    a stream) and the allocator's cache, so that the peak memory of the
    path driven next counts only what that path holds."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def window_times(fn, reps: int = 20, windows: int = 7, warmup: int = 5,
                 flush=None, graph: bool = False) -> list:
    """Milliseconds per call in each of ``windows`` CUDA-event windows of
    ``reps`` calls, after ``warmup`` calls.  Without ``flush`` the calls of
    a window run back to back (warm: a call may find its inputs in the L2
    where the one before left them); with ``graph`` they are replayed from
    one CUDA graph, so that the host's dispatch of a call (~10-20 us through
    ctypes) cannot hold back a kernel that takes less.  With ``flush``,
    ``flush()`` runs before every call outside the timed span (cold), and a
    window is the mean of its calls, each between its own events."""
    g = graphed(fn, reps) if graph and flush is None else None
    for _ in range(warmup):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
               for _ in range(reps if flush is not None else 1)]
        if flush is None:
            evs[0][0].record()
            if g is not None:
                g.replay()
            else:
                for _ in range(reps):
                    fn()
            evs[0][1].record()
        else:
            for start, end in evs:
                flush()
                start.record()
                fn()
                end.record()
        torch.cuda.synchronize()
        per_call.append(sum(s.elapsed_time(e) for s, e in evs) / reps)
    if g is not None:
        g.reset()                # frees the graph's private memory pool
    return per_call


def time_ms(fn, reps: int = 20, windows: int = 7, warmup: int = 5) -> float:
    """Milliseconds per call: the median of `window_times`' warm windows."""
    return statistics.median(window_times(fn, reps, windows, warmup))


class L2Flush:
    """Evicts the card's 50 MB L2 before a cold call: writes a 256 MB
    buffer, then reads it, so the L2 is left holding clean lines of the
    buffer (a write alone would leave dirty lines that the timed call then
    writes back)."""

    def __init__(self, dev):
        self.buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                               device=dev)

    def __call__(self):
        self.buf.fill_(1.0)
        self.buf.sum()


class ClockSampler:
    """The SM clock and power draw sampled by ``nvidia-smi`` every 50 ms
    while the block runs; ``summary()`` gives min, median and max."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))

    def summary(self) -> dict:
        if not self.samples:
            return {"sm_mhz": "not measured", "power_w": "not measured"}
        out = {}
        for i, key in enumerate(("sm_mhz", "power_w")):
            v = sorted(s[i] for s in self.samples)
            out[key] = {"min": v[0], "median": statistics.median(v),
                        "max": v[-1], "samples": len(v)}
        return out


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(fns: dict, flush=None, label=None, reps: int = 5,
             windows: int = 5, warmup: int = 2, graph: bool = False) -> dict:
    """ms per call of versions of one function, timed in turns: each in
    order, then each in reverse order (old, new, new, old for two).
    {name: [the median window of each turn]}; with ``label`` every
    window's time is printed.  ``flush``, ``graph``: see
    `window_times`."""
    t = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        w = window_times(fns[k], reps, windows, warmup, flush, graph)
        t[k].append(statistics.median(w))
        if label:
            print(f"{label} {k}: windows {w} ms", flush=True)
    return t


def other_libraries(source: str, dirs, module: str,
                    signatures: str = "_signatures") -> dict:
    """{dir: the library built from ``dir/source``} for each of ``dirs``
    that holds ``source``, with the C signatures (the dict named
    ``signatures``) of this checkout's wrapper
    ``repro_torch.kernels.<module>`` set on those of its functions that
    the library has (an older source may lack a newer function)."""
    from repro_torch.kernels import build
    libs = {}
    for d in dirs or ():
        if not os.path.isfile(os.path.join(d, source)):
            continue
        lib = ctypes.CDLL(str(build.build(source, d)))
        for fn, argtypes in getattr(importlib.import_module(
                f"repro_torch.kernels.{module}"), signatures).items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[d] = lib
    return libs


def sfu_exp_per_s() -> float:
    """Exponentials per second of the card's special-function units at its
    highest SM clock (``nvidia-smi`` clocks.max.sm)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6


def kernel_inputs(C, valid, B, N, dev, seed, pad_weight=False):
    """Padded rows hold 1e30 and must give 0; with ``pad_weight`` they
    also carry non-zero weights, which the mask must override."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((C, N), generator=g, device=dev)
    mask = (torch.arange(C, device=dev) < valid).to(torch.float32)
    x[valid:] = 1e30
    w = torch.rand((C,), generator=g, device=dev) * mask
    w = w / w.sum()
    if pad_weight:
        w = w + 0.5 * (1 - mask)
    stack = torch.randn((B, N), generator=g, device=dev)
    gw = torch.softmax(torch.randn((B,), generator=g, device=dev), 0)
    return x, w, mask, stack, gw


def close_enough(got, want, tol):
    """max |got - want|, and whether |got - want| <= tol * (1 + |want|)
    everywhere (the allclose criterion of tests/test_kernels.py)."""
    d = (got.float() - want.float()).abs()
    rel = (d / (1 + want.float().abs())).max().item()
    return d.max().item(), rel, rel <= tol


def within(got, want, atol, rtol):
    """(max |got - want|, whether |got - want| <= atol + rtol * |want|
    everywhere and got is finite): numpy's allclose."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (d <= atol + rtol * w.abs()).all())
    return d.max().item(), ok


def tolerance_used(got, want, atol, rtol) -> float:
    """max |got - want| / (atol + rtol |want|): the share of the allclose
    tolerance the worst element uses (<= 1 passes)."""
    w = want.float()
    return ((got.float() - w).abs() / (atol + rtol * w.abs())).max().item()


def kernel_phase(M: int, B: int, N: int, dev, compare_dirs=()) -> dict:
    """Every kernel against its plain version at the main path's shape
    (C = M members, the widest cluster, B clusters, N parameters) and at
    ragged shapes; times at the main path's shape, warm and cold, in turns
    with the library calls and the other sources' kernels."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.trust_aggregate import (trust_aggregate,
                                                     trust_aggregate_global)
    # max |kernel - plain| (reported) and the allclose criterion of
    # tests/test_kernels.py, |kernel - plain| <= tol * (1 + |plain|)
    err = {"global": 0.0, "f32": 0.0, "bf16": 0.0}
    rel = dict(err)
    tol = {"global": 1e-5, "f32": 1e-6, "bf16": 2e-2}

    def note(key, got, want):
        e, r, _ = close_enough(got, want, tol[key])
        err[key] = max(err[key], e)
        rel[key] = max(rel[key], r)

    # (C, valid rows, B, N, non-zero weights on the padded rows)
    shapes = [(M, M, B, N, False), (M, max(1, M // 3), B, N, False),
              (M, max(1, M // 3), B, N, True), (1, 1, 3, 1001, False),
              (7, 4, 5, 130, False), (7, 4, 5, 130, True),
              (300, 299, 2, 257, True), (5, 5, 4, 4099, False)]
    for i, (C, valid, Bs, Ns, pad_w) in enumerate(shapes):
        x, w, mask, stack, gw = kernel_inputs(C, valid, Bs, Ns, dev, i,
                                              pad_w)
        for c in (0, Bs - 1, Bs):      # Bs: out of range, no substitution
            ct = torch.tensor(c, dtype=torch.int32, device=dev)
            note("global", trust_aggregate_global(x, w, mask, stack, gw, ct),
                 ref.trust_aggregate_global_ref(x, w, mask, stack, gw, ct))
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            xd = x.to(dtype)
            for m in (mask, None):
                rows = xd if m is not None else xd[:valid].contiguous()
                wr = w if m is not None else w[:valid].contiguous()
                got = trust_aggregate(rows, wr, m)
                check(bool(torch.isfinite(got).all()),
                      f"trust_aggregate {key} gave non-finite values")
                note(key, got, ref.trust_aggregate_ref(rows, wr, m))
    torch.cuda.synchronize()
    for k in err:
        check(rel[k] <= tol[k], f"{k} kernel error {rel[k]} > {tol[k]}")
        print(f"kernel check {k}: max abs error {err[k]:.3g}, max error "
              f"relative to 1 + |plain| {rel[k]:.3g} (tolerance {tol[k]})",
              flush=True)

    # timing at the main path's shape: the widest cluster, no padding
    x, w, mask, stack, gw = kernel_inputs(M, M, B, N, dev, 99)
    c = torch.tensor(B // 2, dtype=torch.int32, device=dev)
    wm = w * mask
    gz = gw.clone()
    gz[B // 2] = 0.0
    xb = x.to(torch.bfloat16)
    wmb = wm.to(torch.bfloat16)
    wmc = wm * gw[B // 2]
    t = {
        "global": time_ms(lambda: trust_aggregate_global(x, w, mask, stack,
                                                         gw, c)),
        "global_plain": time_ms(lambda: ref.trust_aggregate_global_ref(
            x, w, mask, stack, gw, c)),
        # two library calls (no single one computes the fused function)
        "global_lib2": time_ms(lambda: torch.addmv(gz @ stack, x.T, wmc)),
        "f32": time_ms(lambda: trust_aggregate(x, w, mask)),
        "f32_plain": time_ms(lambda: ref.trust_aggregate_ref(x, w, mask)),
        "f32_lib": time_ms(lambda: wm @ x),
        "dense": time_ms(lambda: trust_aggregate(x, w)),
        "dense_plain": time_ms(lambda: ref.trust_aggregate_ref(x, w)),
        "dense_lib": time_ms(lambda: w @ x),
        "bf16": time_ms(lambda: trust_aggregate(xb, w, mask)),
        "bf16_plain": time_ms(lambda: ref.trust_aggregate_ref(xb, w, mask)),
        "bf16_lib": time_ms(lambda: wmb @ xb),
    }
    # yardsticks of the card's read rate on the same bytes (not the same
    # function): PyTorch's sum of every element of x, cold
    flush = L2Flush(dev)
    t["read_f32"] = statistics.median(window_times(
        lambda: x.sum(), 10, 7, 3, flush))
    t["read_bf16"] = statistics.median(window_times(
        lambda: xb.sum(), 10, 7, 3, flush))
    print(f"yardstick: x.sum() over the same bytes, cold: f32 "
          f"{t['read_f32']} ms, bf16 {t['read_bf16']} ms", flush=True)

    # device times, warm (back to back from a CUDA graph) and cold (the L2
    # flushed before each call), each kernel in turns with its library call
    # and with the kernels built from the other sources, every window
    # printed, the SM clock sampled throughout.  The times above, back to
    # back through the wrapper, can be the host's: its checks and ctypes
    # call take about as long as these kernels.
    # Every timed call writes into these outputs (the kernels through their
    # C functions, this checkout's like the others'), so that the CUDA
    # graphs of the warm timing allocate nothing that outlives them.
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out32 = torch.empty((N,), device=dev)
    outb = torch.empty((N,), dtype=torch.bfloat16, device=dev)
    tmp = torch.empty((N,), device=dev)

    def c_call(where, fn, *ptrs):
        def call():
            status = fn(*(p if isinstance(p, int) or p is None
                          else p.data_ptr() for p in ptrs), stream())
            check(status == 0, f"trust kernel of {where} failed: {status}")
        return call

    def kernels_of(where, lib):
        return {"f32": c_call(where, lib.ta_aggregate_f32, x, w, mask, out32,
                              M, N),
                "bf16": c_call(where, lib.ta_aggregate_bf16, xb, w, mask,
                               outb, M, N),
                "dense": c_call(where, lib.ta_aggregate_f32, x, w, None,
                                out32, M, N),
                "global": c_call(where, lib.ta_aggregate_global_f32, x, w,
                                 mask, stack, gw, c, out32, M, B, N)}

    src = os.path.basename(SOURCE)
    mine = kernels_of("this checkout", other_libraries(
        src, [HERE_CSRC], "trust_aggregate")[HERE_CSRC])
    groups = {
        "f32": {"kernel": mine["f32"],
                "library": lambda: torch.matmul(wm, x, out=out32)},
        "bf16": {"kernel": mine["bf16"],
                 "library": lambda: torch.matmul(wmb, xb, out=outb)},
        "dense": {"kernel": mine["dense"],
                  "library": lambda: torch.matmul(w, x, out=out32)},
        "global": {"kernel": mine["global"],
                   "library_two_calls": lambda: torch.addmv(
                       torch.mv(stack.T, gz, out=tmp), x.T, wmc,
                       out=out32)}}
    for where, old in other_libraries(src, compare_dirs,
                                      "trust_aggregate").items():
        for key, call in kernels_of(where, old).items():
            groups[key][where] = call
    turns = {}
    with ClockSampler() as clock:
        for key, fns in groups.items():
            for mode, fl in (("warm", None), ("cold", flush)):
                turns[f"{key}_{mode}"] = in_turns(
                    fns, fl, label=f"trust {key} {mode}", reps=10,
                    windows=7, warmup=3, graph=True)
    del flush
    # per kernel and mode: the median over its turns
    dev_ms = {k: {name: statistics.median(v) for name, v in tt.items()}
              for k, tt in turns.items()}
    print(f"trust kernels in turns (medians of each turn's windows, ms): "
          f"{json.dumps(turns)}", flush=True)
    print(f"SM clock and power while they ran: "
          f"{json.dumps(clock.summary())}", flush=True)
    # least time for this data: member rows with mask 1, the B - 1 stack
    # rows other than c, the small vectors, the output
    b_glob = (M * N + (B - 1) * N + N) * 4 + (2 * M + B + 1) * 4
    b_f32 = (M * N + N) * 4 + 2 * M * 4
    b_bf16 = (M * N + N) * 2 + 2 * M * 4
    return {"err": err, "tol": tol, "t": t, "turns": turns, "dev": dev_ms,
            "clock": clock.summary(),
            "bound": {"global": bound_ms(b_glob, 2 * (M + B - 1) * N),
                      "f32": bound_ms(b_f32, 2 * M * N),
                      "bf16": bound_ms(b_bf16, 2 * M * N)},
            "bytes": {"global": b_glob, "f32": b_f32, "bf16": b_bf16}}


def trust_times(kp: dict, key: str, lib: str) -> dict:
    """The kernels line's times of one trust kernel: ``ms`` and
    ``library_ms`` (or ``library_two_calls_ms``) back to back through the
    wrapper (host dispatch included); ``cold_ms``
    and ``warm_ms`` and the library's, device times with the L2 flushed
    before each call and from one CUDA graph; the turns against the other
    sources."""
    cold, warm, t = kp["dev"][f"{key}_cold"], kp["dev"][f"{key}_warm"], kp["t"]
    lib_key = {"library": f"{key}_lib", "library_two_calls": "global_lib2"}
    return {"ms": t[key], f"{lib}_ms": t[lib_key[lib]],
            "cold_ms": cold["kernel"], "warm_ms": warm["kernel"],
            f"{lib}_cold_ms": cold[lib], f"{lib}_warm_ms": warm[lib],
            "in_turns_ms": {m: kp["turns"][f"{key}_{m}"]
                            for m in ("warm", "cold")}}


def live_check(fed, rounds: int):
    """``rounds`` more scanned rounds of the main path, each fused-kernel
    call held against its plain version on the same live tensors (trust
    weights, member mask, cluster stack, staleness weights, c).  Returns
    ``close_enough``'s (max abs, max relative, ok) for each call."""
    from repro_torch.api import components
    from repro_torch.kernels import ref
    kernel = components.trust_aggregate_global
    seen = []

    def checked(x, w, mask, stack, gw, c):
        got = kernel(x, w, mask, stack, gw, c)
        seen.append(close_enough(
            got, ref.trust_aggregate_global_ref(x, w, mask, stack, gw, c),
            1e-5))
        return got

    components.trust_aggregate_global = checked
    try:
        fed.run_scanned(rounds, eval_final=False)
    finally:
        components.trust_aggregate_global = kernel
    return seen


# --------------------------------------------------------------------- #
# the paper's full scheme and the anomaly task: a DQN picks a_i
# --------------------------------------------------------------------- #
def timed(fn):
    """(fn(), seconds) on the host clock, the card synchronised after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fed_checks(fed, records, what: str) -> None:
    bad = [k for k, v in fed.engine.state.tensors().items()
           if v.device.type != "cuda"]
    check(not bad, f"{what}: state tensors off the card: {bad}")
    check(all(math.isfinite(r.loss) for r in records),
          f"{what}: non-finite loss")


def adaptive_phase(dev) -> dict:
    """4b. ``paper-adaptive-fleet1k``: the DQN pretrained on the card,
    its Q-values held against the same parameters on the CPU, then
    ``run_scanned(30)`` (30 fused launches) and an event-heap
    ``run(max_rounds=20)`` whose host ``select`` reads ``ctx.obs()`` (20
    launches, 20 observations)."""
    from repro_torch.api import DQNController, Federation, FederationSpec
    from repro_torch.api.scenarios import PAPER_ADAPTIVE_FLEET1K
    from repro_torch.core.dqn import q_values
    from repro_torch.kernels import launches, reset_launches
    spec = FederationSpec.from_dict(PAPER_ADAPTIVE_FLEET1K)
    torch.cuda.reset_peak_memory_stats()
    ctl, t_pre = timed(lambda: DQNController.pretrain(
        seed=spec.seed, device=dev, **spec.controller.params))
    aux = {k: v.tolist() for k, v in ctl.pretrain_aux.items()}
    print(f"adaptive: DQN pretrain on the card, "
          f"{spec.controller.params['episodes']} episodes x "
          f"{spec.controller.params['horizon']} steps: {t_pre:.3f} s, "
          f"{json.dumps(aux)}", flush=True)
    fed, t_build = timed(lambda: Federation.from_spec(spec, controller=ctl))
    eng = fed.engine
    # the agent on the card against the same parameters on the CPU, over
    # random observations and every cluster's live one
    g = torch.Generator().manual_seed(7)
    live_obs = [eng._ctx(c).obs().cpu()
                for c in range(spec.clustering.n_clusters)]
    obs = torch.cat([torch.randn((256, 48), generator=g),
                     torch.stack(live_obs)])
    q_dev = q_values(ctl.agent.eval_params, obs.to(dev)).cpu()
    q_cpu = q_values({k: v.cpu() for k, v in ctl.agent.eval_params.items()},
                     obs)
    q_err = (q_dev - q_cpu).abs().max().item()
    check(torch.allclose(q_dev, q_cpu, atol=1e-5, rtol=1e-5),
          f"q_values on the card differ from the CPU's by {q_err}")
    check(torch.equal(q_dev.argmax(-1), q_cpu.argmax(-1)),
          "the greedy actions on the card differ from the CPU's")
    print(f"adaptive: q_values on the card against the CPU over "
          f"{obs.shape[0]} observations: max abs error {q_err} (tolerance "
          f"atol = rtol = 1e-5), greedy actions equal", flush=True)

    counts = {}
    reset_launches()
    scanned, t_scan = timed(lambda: fed.run_scanned(30))
    counts["adaptive_run_scanned"] = dict(launches)
    check(launches["trust_aggregate_global"] == 30,
          f"adaptive run_scanned(30) launched the fused kernel "
          f"{launches['trust_aggregate_global']} times")
    acc = scanned.records[-1].acc
    actions = sorted({r.a for r in scanned.records[:-1]})
    print(f"adaptive run_scanned(30): {30 / t_scan:.3f} rounds/s "
          f"({t_scan:.2f} s incl. final eval), actions {actions}, final acc "
          f"{acc}", flush=True)

    seen = []
    scan_obs = eng._scan_obs

    def counted(*a):
        seen.append(1)
        return scan_obs(*a)

    eng._scan_obs = counted
    reset_launches()
    try:
        event, t_event = timed(lambda: fed.run(max_rounds=20))
    finally:
        del eng._scan_obs
    counts["adaptive_run"] = dict(launches)
    check(launches["trust_aggregate_global"] == 20,
          f"adaptive run(max_rounds=20) launched the fused kernel "
          f"{launches['trust_aggregate_global']} times")
    check(len(seen) == 20, f"the host select read {len(seen)} observations "
                           f"in 20 rounds")
    ev_actions = sorted({r.a for r in event.records})
    print(f"adaptive run(max_rounds=20), host select on ctx.obs(): "
          f"{20 / t_event:.3f} rounds/s ({t_event:.2f} s incl. "
          f"{len(event.records)} evals), actions {ev_actions}, final acc "
          f"{event.records[-1].acc}", flush=True)
    fed_checks(fed, scanned.records + event.records, "adaptive")
    check(acc is not None and acc >= JAX_ADAPTIVE_ACC - ACC_MARGIN,
          f"adaptive final accuracy {acc} < {JAX_ADAPTIVE_ACC} - "
          f"{ACC_MARGIN}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"adaptive: peak device memory {peak:.3f} GiB", flush=True)
    return {"spec": "paper-adaptive-fleet1k", "pretrain_s": t_pre,
            "pretrain": aux, "build_s": t_build,
            "q_values_max_abs_err": q_err,
            "run_scanned_rounds_per_s": 30 / t_scan,
            "run_rounds_per_s": 20 / t_event, "actions": actions,
            "event_actions": ev_actions, "final_acc": acc,
            "reference_acc": JAX_ADAPTIVE_ACC, "margin": ACC_MARGIN,
            "peak_gib": peak, "counts": counts}


def fused_times(M: int, B: int, N: int, dev, compare_dirs=()) -> dict:
    """The fused kernel at (C = M, B, N) on random inputs: its error
    against the plain version, its launch plan, its time back to back
    through the wrapper, warm (from a CUDA graph) and cold (L2 flushed)
    beside the two library calls and the other sources' kernels in turns,
    the plain version's, and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.trust_aggregate import (global_plan,
                                                     trust_aggregate_global)
    x, w, mask, stack, gw = kernel_inputs(M, M, B, N, dev, 123)
    c = torch.tensor(B // 3, dtype=torch.int32, device=dev)
    e, r, ok = close_enough(trust_aggregate_global(x, w, mask, stack, gw, c),
                            ref.trust_aggregate_global_ref(
                                x, w, mask, stack, gw, c), 1e-5)
    check(ok, f"fused kernel at N = {N}: error {r} > 1e-5")
    gz = gw.clone()
    gz[B // 3] = 0.0
    wmc = w * mask * gw[B // 3]
    out32, tmp = torch.empty((N,), device=dev), torch.empty((N,), device=dev)
    src = os.path.basename(SOURCE)

    def kernel_of(where, lib):
        def kernel():
            status = lib.ta_aggregate_global_f32(
                x.data_ptr(), w.data_ptr(), mask.data_ptr(),
                stack.data_ptr(), gw.data_ptr(), c.data_ptr(),
                out32.data_ptr(), M, B, N,
                torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"fused kernel of {where} failed: {status}")
        return kernel

    fns = {"kernel": kernel_of("this checkout", other_libraries(
               src, [HERE_CSRC], "trust_aggregate")[HERE_CSRC]),
           "library_two_calls": lambda: torch.addmv(
               torch.mv(stack.T, gz, out=tmp), x.T, wmc, out=out32)}
    for where, old in other_libraries(src, compare_dirs,
                                      "trust_aggregate").items():
        fns[where] = kernel_of(where, old)
    flush = L2Flush(dev)
    turns = {m: in_turns(fns, fl, label=f"fused N={N} {m}", reps=10,
                         windows=7, warmup=3, graph=True)
             for m, fl in (("warm", None), ("cold", flush))}
    del flush
    med = {m: {k: statistics.median(v) for k, v in tt.items()}
           for m, tt in turns.items()}
    n_bytes = (M * N + (B - 1) * N + N) * 4 + (2 * M + B + 1) * 4
    bound = bound_ms(n_bytes, 2 * (M + B - 1) * N)
    plan = global_plan(M, B, N)
    out = {"shape": {"C": M, "B": B, "N": N, "dtype": "float32"},
           "plan": plan, "max_abs_err": e,
           "ms": time_ms(lambda: trust_aggregate_global(x, w, mask, stack,
                                                        gw, c)),
           "plain_ms": time_ms(lambda: ref.trust_aggregate_global_ref(
               x, w, mask, stack, gw, c)),
           "cold_ms": med["cold"]["kernel"], "warm_ms": med["warm"]["kernel"],
           "library_two_calls_cold_ms": med["cold"]["library_two_calls"],
           "library_two_calls_warm_ms": med["warm"]["library_two_calls"],
           "in_turns_ms": turns, "bound_ms": bound[0], "bound_by": bound[1],
           "bytes": n_bytes}
    print(f"fused kernel at (C {M}, B {B}, N {N}): cold {out['cold_ms']} ms, "
          f"warm {out['warm_ms']} ms, back to back {out['ms']} ms, plain "
          f"{out['plain_ms']} ms, bound {bound[0]} ms ({bound[1]}, "
          f"{n_bytes} bytes); medians in turns, cold {med['cold']}, warm "
          f"{med['warm']}; plan {json.dumps(plan)}", flush=True)
    return out


def anomaly_phase(dev, compare_dirs=()) -> dict:
    """4c. ``anomaly-fleet1k``: built through the registry (the DQN
    pretrains on the card), ``run_scanned(30)`` (30 fused launches), three
    more scanned rounds with the fused kernel held against its plain
    version on each round's own inputs at N = 5,288, the final AUC against
    the JAX package's, and the fused kernel timed at this shape."""
    from repro_torch.api import Federation, FederationSpec
    from repro_torch.api.scenarios import ANOMALY_FLEET1K
    from repro_torch.kernels import launches, reset_launches
    spec = FederationSpec.from_dict(ANOMALY_FLEET1K)
    torch.cuda.reset_peak_memory_stats()
    fed, t_build = timed(lambda: Federation.from_spec(spec))
    eng = fed.engine
    M = eng._member_table.shape[1]
    B, N = eng.state.cluster_flat.shape
    check(N == 5288, f"anomaly model has N = {N}, not 5,288")
    aux = {k: v.tolist() for k, v in fed.controller.pretrain_aux.items()}
    print(f"anomaly federation built in {t_build:.2f} s (DQN pretrained on "
          f"the card: {json.dumps(aux)}): M={M}, B={B}, N={N}", flush=True)
    counts = {}
    reset_launches()
    scanned, t_scan = timed(lambda: fed.run_scanned(30))
    counts["anomaly_run_scanned"] = dict(launches)
    check(launches["trust_aggregate_global"] == 30,
          f"anomaly run_scanned(30) launched the fused kernel "
          f"{launches['trust_aggregate_global']} times")
    auc = scanned.records[-1].acc
    actions = sorted({r.a for r in scanned.records[:-1]})
    print(f"anomaly run_scanned(30): {30 / t_scan:.3f} rounds/s "
          f"({t_scan:.2f} s incl. final eval), actions {actions}, final AUC "
          f"{auc}, loss {scanned.records[-1].loss}", flush=True)
    reset_launches()
    live = live_check(fed, 3)
    counts["anomaly_live_check"] = dict(launches)
    check(launches["trust_aggregate_global"] == 3,
          f"live check launched the fused kernel "
          f"{launches['trust_aggregate_global']} times")
    check(len(live) == 3 and all(ok for _, _, ok in live),
          f"fused kernel on the anomaly path's live inputs: {live} "
          f"(tolerance 1e-5)")
    live_err = max(e for e, _, _ in live)
    print(f"fused kernel on the anomaly path's live inputs (N = {N}), 3 "
          f"rounds: max abs error {live_err:.3g}, max error relative to 1 + "
          f"|plain| {max(r for _, r, _ in live):.3g} (tolerance 1e-5)",
          flush=True)
    fed_checks(fed, scanned.records, "anomaly")
    check(auc is not None and auc >= JAX_ANOMALY_AUC - AUC_MARGIN,
          f"anomaly final AUC {auc} < {JAX_ANOMALY_AUC} - {AUC_MARGIN}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"anomaly: peak device memory {peak:.3f} GiB", flush=True)
    record = {"spec": "anomaly-fleet1k", "build_s": t_build, "pretrain": aux,
              "run_scanned_rounds_per_s": 30 / t_scan, "actions": actions,
              "final_auc": auc, "reference_auc": JAX_ANOMALY_AUC,
              "margin": AUC_MARGIN, "live_max_abs_err": live_err,
              "peak_gib": peak, "counts": counts}
    del fed, eng, scanned
    torch.cuda.empty_cache()
    record["fused"] = fused_times(M, B, N, dev, compare_dirs)
    free_library_memory()
    return record


# --------------------------------------------------------------------- #
# DP, the robust rules and the fault model: the two-step path
# --------------------------------------------------------------------- #
def two_step_check(fed, rounds: int, event: bool = False) -> dict:
    """``rounds`` more rounds (scanned, or on the event heap), each launch
    of the masked kernel (`dp_aggregate`'s Eqn 6), the unmasked one
    (`time_weighted_average`'s Eqn 19) and the fused one held against its
    plain version on the same live tensors.  {kernel: close_enough's
    (max abs, max relative, ok) of each call}."""
    from repro_torch.api import components
    from repro_torch.core import privacy, trust
    from repro_torch.kernels import ref
    seen = {"trust_aggregate": [], "trust_aggregate_dense": [],
            "trust_aggregate_global": []}
    masked, dense = privacy.trust_aggregate, trust.trust_aggregate
    fused = components.trust_aggregate_global

    def checked_masked(x, w, mask=None):
        got = masked(x, w, mask)
        seen["trust_aggregate"].append(close_enough(
            got, ref.trust_aggregate_ref(x, w, mask), 1e-6))
        return got

    def checked_dense(x, w, mask=None):
        got = dense(x, w, mask)
        seen["trust_aggregate_dense"].append(close_enough(
            got, ref.trust_aggregate_ref(x, w, mask), 1e-6))
        return got

    def checked_fused(x, w, mask, stack, gw, c):
        got = fused(x, w, mask, stack, gw, c)
        seen["trust_aggregate_global"].append(close_enough(
            got, ref.trust_aggregate_global_ref(x, w, mask, stack, gw, c),
            1e-5))
        return got

    privacy.trust_aggregate = checked_masked
    trust.trust_aggregate = checked_dense
    components.trust_aggregate_global = checked_fused
    try:
        if event:
            fed.run(max_rounds=rounds)
        else:
            fed.run_scanned(rounds, eval_final=False)
    finally:
        privacy.trust_aggregate = masked
        trust.trust_aggregate = dense
        components.trust_aggregate_global = fused
    return {k: v for k, v in seen.items() if v}


TRUST_KERNELS = ("trust_aggregate", "trust_aggregate_dense",
                 "trust_aggregate_global", "trust_aggregate_pop",
                 "trust_aggregate_dense_pop", "trust_aggregate_global_pop")


def robust_phase(dev) -> dict:
    """4d. DP, the robust rules and the fault model at full width, each
    path with the counts reset before it and read after it:
    ``dp-fleet1k`` ``run_scanned(30)`` (30 masked and 30 unmasked
    launches, no fused one); ``faulty-fleet1k`` ``run_scanned(30)`` then
    ``run(max_rounds=20)`` (30 + 20 fused); ``faulty-median-fleet1k``
    ``run_scanned(30)`` (30 unmasked); krum on ``paper-mlp-fleet1k``'s
    fleet, ``run(max_rounds=10)`` (10 unmasked), with its peak memory.
    After each, three more rounds hold every launched kernel against its
    plain version on the live inputs; the final accuracies are held to the
    JAX package's."""
    from repro_torch.api import Federation, FederationSpec
    from repro_torch.api.scenarios import (DP_FLEET1K, FAULTY_FLEET1K,
                                           FAULTY_MEDIAN_FLEET1K,
                                           PAPER_MLP_FLEET1K)
    from repro_torch.kernels import launches, reset_launches
    counts, live, out, shared = {}, {}, {}, {}

    def drive(path, fn, expect):
        reset_launches()
        res, t = timed(fn)
        counts[path] = dict(launches)
        got = {k: launches[k] for k in TRUST_KERNELS}
        want = {k: expect.get(k, 0) for k in TRUST_KERNELS}
        check(got == want, f"{path} launched {got}, expected {want}")
        return res, t

    def build(name, d):
        spec = FederationSpec.from_dict(d)
        torch.cuda.reset_peak_memory_stats()
        fed, t_build = timed(lambda: Federation.from_spec(spec, **shared))
        shared.update(data=fed.engine.data, parts=fed.engine.parts)
        print(f"{name}: built in {t_build:.2f} s (aggregator "
              f"{spec.aggregator.kind}, privacy clip {spec.privacy.clip}, "
              f"faults active {spec.faults.active})", flush=True)
        return fed

    def live_checked(name, fed, rounds=3, event=False):
        seen = two_step_check(fed, rounds, event)
        for k, v in seen.items():
            check(len(v) == rounds and all(ok for _, _, ok in v),
                  f"{name}: {k} on live inputs: {v}")
        live[name] = {k: max(e for e, _, _ in v) for k, v in seen.items()}
        print(f"{name}: kernels on {rounds} rounds' live inputs, max abs "
              f"error {json.dumps(live[name])} (tolerance 1e-6 relative "
              f"to 1 + |plain|, fused 1e-5)", flush=True)

    def scanned(name, fed, expect, ref_acc=None, margin=None):
        tr, t = drive(f"{name}_run_scanned",
                      lambda: fed.run_scanned(30), expect)
        acc = tr.records[-1].acc
        fed_checks(fed, tr.records, name)
        if ref_acc is not None:
            check(acc is not None and acc >= ref_acc - margin,
                  f"{name} final accuracy {acc} < {ref_acc} - {margin}")
        out[name] = {"run_scanned_rounds_per_s": 30 / t, "final_acc": acc,
                     "actions": sorted({r.a for r in tr.records[:-1]}),
                     "final_loss": tr.records[-1].loss}
        if ref_acc is not None:
            out[name].update(reference_acc=ref_acc, margin=margin)
        print(f"{name} run_scanned(30): {30 / t:.3f} rounds/s ({t:.2f} s "
              f"incl. final eval), final acc {acc}", flush=True)

    def over_seeds(name, d, ref):
        """The final accuracy after run_scanned(30) over seeds 0-9 (seed 0
        from the driven path) against the JAX package's over the same
        seeds: the means within ``ref["mean_margin"]``, the least no lower
        than the JAX package's least less the same margin."""
        accs = [out[name]["final_acc"]]
        for seed in range(1, len(ref["accs"])):
            fed = Federation.from_dict({**d, "seed": seed})
            accs.append(fed.run_scanned(30).records[-1].acc)
            del fed
        mean, jmean = statistics.mean(accs), statistics.mean(ref["accs"])
        m = ref["mean_margin"]
        out[name].update(seed_accs=accs, seed_mean=mean,
                         reference_seed_accs=ref["accs"],
                         reference_seed_mean=jmean, mean_margin=m)
        print(f"{name} over seeds 0-{len(accs) - 1}: final acc {accs}, "
              f"mean {mean} (JAX {jmean} +- {m}), least {min(accs)} (JAX "
              f"{min(ref['accs'])} - {m})", flush=True)
        check(abs(mean - jmean) <= m,
              f"{name}: mean final accuracy over seeds {mean} not within "
              f"{m} of the JAX package's {jmean}")
        check(min(accs) >= min(ref["accs"]) - m,
              f"{name}: least final accuracy over seeds {min(accs)} < "
              f"{min(ref['accs'])} - {m}")

    fed = build("dp-fleet1k", DP_FLEET1K)
    scanned("dp-fleet1k", fed,
            {"trust_aggregate": 30, "trust_aggregate_dense": 30},
            JAX_DP_ACC, ACC_MARGIN)
    live_checked("dp-fleet1k", fed)
    out["dp-fleet1k"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del fed

    fed = build("faulty-fleet1k", FAULTY_FLEET1K)
    scanned("faulty-fleet1k", fed, {"trust_aggregate_global": 30})
    tr, t = drive("faulty-fleet1k_run", lambda: fed.run(max_rounds=20),
                  {"trust_aggregate_global": 20})
    fed_checks(fed, tr.records, "faulty-fleet1k run")
    out["faulty-fleet1k"]["run_rounds_per_s"] = 20 / t
    print(f"faulty-fleet1k run(max_rounds=20): {20 / t:.3f} rounds/s "
          f"({t:.2f} s incl. {len(tr.records)} evals), final acc "
          f"{tr.records[-1].acc}", flush=True)
    live_checked("faulty-fleet1k", fed)
    out["faulty-fleet1k"]["peak_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2**30)
    del fed

    fed = build("faulty-median-fleet1k", FAULTY_MEDIAN_FLEET1K)
    scanned("faulty-median-fleet1k", fed, {"trust_aggregate_dense": 30})
    live_checked("faulty-median-fleet1k", fed)
    out["faulty-median-fleet1k"]["peak_gib"] = (
        torch.cuda.max_memory_allocated() / 2**30)
    del fed
    over_seeds("faulty-fleet1k", FAULTY_FLEET1K, JAX_FAULTY)
    over_seeds("faulty-median-fleet1k", FAULTY_MEDIAN_FLEET1K,
               JAX_FAULTY_MEDIAN)

    name = "krum-fleet1k"
    fed = build(name, {**PAPER_MLP_FLEET1K, "aggregator": {"kind": "krum"}})
    sizes = [len(m) for m in fed.engine._members]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr, t = drive(f"{name}_run", lambda: fed.run(max_rounds=10),
                  {"trust_aggregate_dense": 10})
    peak = torch.cuda.max_memory_allocated() / 2**30
    fed_checks(fed, tr.records, name)
    out[name] = {"run_rounds_per_s": 10 / t, "final_acc": tr.records[-1].acc,
                 "peak_gib": peak, "cluster_sizes": [min(sizes), max(sizes)]}
    print(f"{name} run(max_rounds=10), exact clusters of {min(sizes)}-"
          f"{max(sizes)} members: {10 / t:.3f} rounds/s ({t:.2f} s incl. "
          f"{len(tr.records)} evals), final acc {tr.records[-1].acc}, peak "
          f"device memory {peak:.3f} GiB", flush=True)
    live_checked(name, fed, event=True)
    del fed, shared["data"], shared["parts"]
    torch.cuda.empty_cache()
    return {"specs": out, "live_max_abs_err": live, "counts": counts}


def dense_times(B: int, N: int, dev) -> dict:
    """The unmasked kernel at Eqn 19's (B, N) on random inputs: its error
    against the plain version, its time back to back through the wrapper,
    warm (from a CUDA graph) and cold (L2 flushed) in turns with ``w @ x``,
    the plain version's, and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.trust_aggregate import trust_aggregate
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((B, N), generator=g, device=dev)
    w = torch.softmax(torch.randn((B,), generator=g, device=dev), 0)
    e, r, ok = close_enough(trust_aggregate(x, w),
                            ref.trust_aggregate_ref(x, w), 1e-6)
    check(ok, f"unmasked kernel at (B {B}, N {N}): error {r} > 1e-6")
    out32 = torch.empty((N,), device=dev)
    lib = other_libraries(os.path.basename(SOURCE), [HERE_CSRC],
                          "trust_aggregate")[HERE_CSRC]

    def kernel():
        status = lib.ta_aggregate_f32(
            x.data_ptr(), w.data_ptr(), None, out32.data_ptr(), B, N,
            torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"unmasked kernel failed: {status}")

    fns = {"kernel": kernel,
           "library": lambda: torch.matmul(w, x, out=out32)}
    flush = L2Flush(dev)
    turns = {m: in_turns(fns, fl, label=f"dense B={B} N={N} {m}", reps=10,
                         windows=7, warmup=3, graph=True)
             for m, fl in (("warm", None), ("cold", flush))}
    del flush
    med = {m: {k: statistics.median(v) for k, v in tt.items()}
           for m, tt in turns.items()}
    n_bytes = (B * N + N) * 4 + B * 4
    bound = bound_ms(n_bytes, 2 * B * N)
    res = {"shape": {"B": B, "N": N, "dtype": "float32", "mask": False},
           "max_abs_err": e,
           "ms": time_ms(lambda: trust_aggregate(x, w)),
           "plain_ms": time_ms(lambda: ref.trust_aggregate_ref(x, w)),
           "library_ms": time_ms(lambda: w @ x),
           "cold_ms": med["cold"]["kernel"], "warm_ms": med["warm"]["kernel"],
           "library_cold_ms": med["cold"]["library"],
           "library_warm_ms": med["warm"]["library"],
           "in_turns_ms": turns, "bound_ms": bound[0], "bound_by": bound[1],
           "bytes": n_bytes}
    print(f"unmasked kernel at (B {B}, N {N}): cold {res['cold_ms']} ms, "
          f"warm {res['warm_ms']} ms, back to back {res['ms']} ms, plain "
          f"{res['plain_ms']} ms, w @ x cold {res['library_cold_ms']} / warm "
          f"{res['library_warm_ms']} / back to back {res['library_ms']} ms, "
          f"bound {bound[0]} ms ({bound[1]}, {n_bytes} bytes)", flush=True)
    return res


# --------------------------------------------------------------------- #
# the service mode: checkpointed segments, resume and a SIGKILL
# --------------------------------------------------------------------- #
def segment_metrics(run_dir: str) -> list:
    """One entry a segment, in order, from the service's snapshots in the
    run dir's ``metrics.jsonl``: the ``service_rounds_per_sec``,
    ``fl_checkpoint_last_seconds`` and ``fl_checkpoint_bytes`` gauges.
    Each run's registry counts its segments (and a resumed run its resume)
    from 0, and its farewell snapshot repeats its last segment's."""
    from repro_torch.obs import MetricsRegistry
    out, last = [], None
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("schema") != "metrics/1" or \
                    rec.get("source") != "service":
                continue
            t = MetricsRegistry.from_snapshot(rec).totals()
            key = (t.get("service_segments_total", 0),
                   t.get("service_resumes_total", 0))
            if key[0] and key != last:
                out.append({"rounds_per_sec": t["service_rounds_per_sec"],
                            "checkpoint_s": t["fl_checkpoint_last_seconds"],
                            "checkpoint_bytes": t["fl_checkpoint_bytes"]})
            last = key
    return out


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def service_phase(dev) -> dict:
    """4e. the service mode at full width: ``run_service`` in 10-round
    segments on ``paper-mlp-fleet1k`` (two segments, then a resume for a
    third, against three straight in a second run dir: trace.jsonl
    byte-equal, the manifests' f64 energy equal, 10 fused launches a
    segment; after the resume one more round restored from the
    checkpoint holds the fused kernel against its plain version); then the
    chaos harness on ``paper-adaptive-fleet1k`` (three segments, one
    SIGKILL, ``python -m repro_torch.serve`` children on the card each
    pretraining its DQN) against an in-process uninterrupted run; then
    the chaos run dir read as a user would (``service_status``, the
    ``metrics`` and ``status --watch --once`` subcommands)."""
    import shutil
    import tempfile
    from repro_torch.api import Federation, FederationSpec
    from repro_torch.api.scenarios import (PAPER_ADAPTIVE_FLEET1K,
                                           PAPER_MLP_FLEET1K)
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve import (RunDir, latest_resumable,
                                   restore_resumable, run_service,
                                   run_supervised, service_status)
    from repro_torch.serve.service import child_env
    K = 10
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    counts, out = {}, {}
    quiet = lambda *a: None

    def run_dir(name, spec):
        rd = RunDir(os.path.join(root, name)).ensure()
        rd.write_spec(spec)
        return rd

    def serve(path, label, segments, **kw):
        reset_launches()
        t0 = time.perf_counter()
        state = run_service(path, segment_rounds=K, max_segments=segments,
                            keep=None, device="cuda", log=quiet, **kw)
        dt = time.perf_counter() - t0
        counts[label] = dict(launches)
        check(launches["trust_aggregate_global"] == K * segments,
              f"{label}: {segments} segments of {K} rounds launched the "
              f"fused kernel {launches['trust_aggregate_global']} times")
        check(state["status"] == "stopped", f"{label}: {state}")
        return dt

    def manifest(rd):
        found = latest_resumable(rd.ckpt_dir)
        check(found is not None, f"no verified checkpoint in {rd.root}")
        return found[1]

    try:
        # 1. segment parity in process
        spec = FederationSpec.from_dict(PAPER_MLP_FLEET1K)
        a, b = run_dir("resumed", spec), run_dir("straight", spec)
        wall = {"service_2_segments": serve(a.root, "service_2_segments", 2),
                "service_resume": serve(a.root, "service_resume", 1,
                                        resume=True),
                "service_3_segments": serve(b.root, "service_3_segments", 3)}
        check(read_bytes(a.trace_path) == read_bytes(b.trace_path),
              "service: the resumed trace.jsonl differs from the "
              "uninterrupted run's")
        ma, mb = manifest(a), manifest(b)
        check(ma["rounds"] == mb["rounds"] == 3 * K
              and ma["energy"] == mb["energy"],
              f"service: manifests differ: {ma} vs {mb}")
        st = service_status(b.root)
        m = st["metrics"]
        check(m["fl_rounds_total"] == 3 * K and
              m["fl_checkpoints_total"] == 3 and
              m["service_segments_total"] == 3,
              f"service: status metrics {m}")
        fed = Federation.from_spec(spec)
        restore_resumable(fed, a.ckpt_dir)
        live = live_check(fed, 1)
        check(len(live) == 1 and live[0][2],
              f"service: fused kernel after the restore: {live}")
        del fed
        torch.cuda.empty_cache()
        out["paper-mlp-fleet1k"] = {
            "segments": {"resumed": segment_metrics(a.root),
                         "straight": segment_metrics(b.root)},
            "wall_s": wall, "rounds": ma["rounds"], "energy": ma["energy"],
            "trace_bytes": os.path.getsize(a.trace_path),
            "live_max_abs_err": live[0][0]}
        print(f"service paper-mlp-fleet1k: 2 + 1 resumed segments == 3 "
              f"straight (trace.jsonl {os.path.getsize(a.trace_path)} B "
              f"byte-equal, energy {ma['energy']!r} J equal); fused kernel "
              f"after the restore: max abs error {live[0][0]:.3g}; "
              f"{json.dumps(out['paper-mlp-fleet1k']['segments'])}",
              flush=True)

        # 2. chaos: SIGKILL a child after a checkpoint lands
        aspec = FederationSpec.from_dict(PAPER_ADAPTIVE_FLEET1K)
        ref = run_dir("adaptive_ref", aspec)
        t_ref = serve(ref.root, "service_chaos_reference", 3)
        chaos = RunDir(os.path.join(root, "adaptive_chaos"))
        t0 = time.perf_counter()
        summary = run_supervised(
            chaos.root, total_segments=3, segment_rounds=K, kills=1,
            keep=0, spec_file=ref.spec_path, device="cuda",
            kill_timeout=300.0, log=lambda msg: print(msg, flush=True))
        t_chaos = time.perf_counter() - t0
        if read_bytes(chaos.trace_path) != read_bytes(ref.trace_path):
            with open(chaos.path("serve.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
            fail("chaos: the recovered trace.jsonl differs from the "
                 "uninterrupted run's")
        check(summary["segments"] == 3 and summary["kills"] == 1
              and summary["restarts"] >= 1, f"chaos: {summary}")
        check(manifest(chaos)["energy"] == manifest(ref)["energy"],
              "chaos: the manifests' energy differs")

        # 3. the chaos run dir, read as a user would
        st = service_status(chaos.root)
        check(not st["alive"] and st["state"]["status"] == "stopped"
              and st["state"]["rounds"] == 3 * K, f"chaos status: {st}")
        m = st["metrics"]
        check(m["chaos_sigkills_total"] == 1 and m["fl_compiles_total"] >= 1,
              f"chaos status metrics: {m}")
        with open(chaos.metrics_path) as f:
            events = [json.loads(line) for line in f
                      if '"event/1"' in line]
        check(events and all(e["fn"].startswith("trust_aggregate")
                             for e in events),
              f"chaos: compile events {events}")
        cli = {}
        for cmd in (["metrics"], ["status", "--watch", "--once"],
                    ["status"]):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.serve", *cmd,
                 "--run-dir", chaos.root], env=child_env(),
                capture_output=True, text=True, timeout=120)
            check(proc.returncode == 0,
                  f"serve {cmd}: exit {proc.returncode}: {proc.stderr}")
            cli[" ".join(cmd)] = proc.stdout
        check("chaos_sigkills_total 1" in cli["metrics"],
              "serve metrics: no chaos_sigkills_total 1")
        print(cli["status --watch --once"], flush=True)
        out["paper-adaptive-fleet1k"] = {
            "segments": {"reference": segment_metrics(ref.root),
                         "chaos": segment_metrics(chaos.root)},
            "child_startups": summary["startups"],
            "kills": summary["kills"], "restarts": summary["restarts"],
            "events": summary["events"],
            "compile_events": [{"fn": e["fn"], "seconds": e["seconds"]}
                               for e in events],
            "wall_s": {"reference": t_ref, "chaos": t_chaos}}
        print(f"service paper-adaptive-fleet1k: chaos run (1 SIGKILL, "
              f"{summary['restarts']} restarts, child start-ups "
              f"{json.dumps(summary['startups'])}) byte-equal to the "
              f"in-process run; {t_chaos:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return {"service": out, "counts": counts}


# --------------------------------------------------------------------- #
# populations: B federations as one batched round, and the pool
# --------------------------------------------------------------------- #
POP_B = 8               # the main population: lr {0.05, 0.1} x 4 replicates
POP_K, POP_STEADY_K = 30, 10


def pop_kernel_inputs(P, C, B, N, dev, seed, pad_weight=False):
    """P members' inputs of the batched kernels: ragged valid rows (member
    0 all valid, member 1 none when P > 2), padded rows of 1e30 (with
    ``pad_weight`` also non-zero weights on them), the rows c cycling over
    0, B - 1 and B (no member row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((P, C, N), generator=g, device=dev)
    valid = torch.randint(0, C + 1, (P,), generator=g, device=dev)
    valid[0] = C
    if P > 2:
        valid[1] = 0
    mask = (torch.arange(C, device=dev)[None, :] < valid[:, None]).to(
        torch.float32)
    x[mask == 0] = 1e30
    w = torch.rand((P, C), generator=g, device=dev) * mask
    w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-30)
    if pad_weight:
        w = w + 0.5 * (1 - mask)
    stack = torch.randn((P, B, N), generator=g, device=dev)
    gw = torch.softmax(torch.randn((P, B), generator=g, device=dev), 1)
    c = torch.tensor([(0, B - 1, B)[p % 3] for p in range(P)],
                     dtype=torch.int32, device=dev)
    return x, w, mask, stack, gw, c


def pop_kernel_phase(dev) -> dict:
    """4f, first: the population-batched kernels against their batched
    plain versions (fused 1e-5, f32 1e-6, bf16 2e-2) at the main
    population's shapes (P 8, C 99, B 16, N 159,010; P 8, C 111, N 5,288)
    and ragged ones (P 1, 3, 8; c = B; zero and non-zero weights on padded
    rows), every slice bitwise against the single kernel on that member's
    tensors; then the fused, masked and unmasked batched kernels timed at
    P 8, cold (L2 flushed), warm (ten calls from one CUDA graph) and back
    to back, in turns with the library calls and with P single launches,
    beside their bounds."""
    from repro_torch.kernels import ref
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    tol = {"global_pop": 1e-5, "pop_f32": 1e-6, "pop_bf16": 2e-2}
    err = {k: 0.0 for k in tol}
    rel = dict(err)
    slices = 0

    def note(key, got, want):
        e, r, _ = close_enough(got, want, tol[key])
        err[key], rel[key] = max(err[key], e), max(rel[key], r)

    shapes = [(8, 99, 16, 159010), (8, 111, 16, 5288), (1, 7, 5, 130),
              (3, 300, 2, 257), (8, 6, 4, 1027), (3, 99, 16, 4099)]
    for i, (P, C, B, N) in enumerate(shapes):
        for pad_w in (False, True):
            x, w, mask, stack, gw, c = pop_kernel_inputs(P, C, B, N, dev,
                                                         50 + i, pad_w)
            got = ta.trust_aggregate_global_pop(x, w, mask, stack, gw, c)
            note("global_pop", got, ref.trust_aggregate_global_pop_ref(
                x, w, mask, stack, gw, c))
            for p in range(P):
                check(torch.equal(got[p], ta.trust_aggregate_global(
                    x[p], w[p], mask[p], stack[p], gw[p], c[p])),
                      f"fused batched kernel, slice {p} of {(P, C, B, N)}:"
                      " not the single kernel's bits")
                slices += 1
            for key, dtype in (("pop_f32", torch.float32),
                               ("pop_bf16", torch.bfloat16)):
                xd = x.to(dtype)
                for m in (mask, None):
                    wm = w if m is not None else (w * mask).contiguous()
                    xs = xd if m is not None else torch.where(
                        mask[..., None] > 0, xd, 0).contiguous()
                    got = ta.trust_aggregate_pop(xs, wm, m)
                    note(key, got, ref.trust_aggregate_pop_ref(xs, wm, m))
                    for p in range(P):
                        check(torch.equal(got[p], ta.trust_aggregate(
                            xs[p], wm[p], None if m is None else m[p])),
                              f"batched {key} kernel (mask "
                              f"{m is not None}), slice {p} of "
                              f"{(P, C, N)}: not the single kernel's bits")
                        slices += 1
    torch.cuda.synchronize()
    for k in err:
        check(rel[k] <= tol[k], f"{k} kernel error {rel[k]} > {tol[k]}")
        print(f"kernel check {k}: max abs error {err[k]:.3g}, max error "
              f"relative to 1 + |plain| {rel[k]:.3g} (tolerance {tol[k]})",
              flush=True)
    print(f"batched kernels: {slices} slices bitwise equal to the single "
          f"kernel on their member's tensors", flush=True)

    # timing at the main population's shape, every member row valid
    P, C, B, N = POP_B, 99, 16, 159010
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((P, C, N), generator=g, device=dev)
    mask = torch.ones((P, C), device=dev)
    w = torch.softmax(torch.randn((P, C), generator=g, device=dev), 1)
    stack = torch.randn((P, B, N), generator=g, device=dev)
    gw = torch.softmax(torch.randn((P, B), generator=g, device=dev), 1)
    c = torch.full((P,), B // 2, dtype=torch.int32, device=dev)
    wm = w * mask
    rows = torch.arange(P, device=dev)
    gz = gw.clone()
    gz[rows, c.long()] = 0.0
    wmc = wm * gw[rows, c.long()][:, None]
    out = torch.empty((P, N), device=dev)
    tmp = torch.empty((P, 1, N), device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    lib = ta._lib()

    def c_call(fn, *args):
        def call():
            status = fn(*(a if isinstance(a, int) or a is None
                          else a.data_ptr() for a in args), stream())
            check(status == 0, f"batched trust kernel failed: {status}")
        return call

    def singles(fn, per_member):
        def call():
            for p in range(P):
                status = fn(*(a if isinstance(a, int) or a is None
                              else a.data_ptr() for a in per_member(p)),
                            stream())
                check(status == 0, f"single trust kernel failed: {status}")
        return call

    groups = {
        "global_pop": {
            "kernel": c_call(lib.ta_aggregate_global_pop_f32, x, w, mask,
                             stack, gw, c, out, P, C, B, N),
            # Eqn 6's bmm folded into Eqn 19's: gw with row c zeroed over
            # the stack, plus the member rows weighted by w gw[c]
            "library_two_calls": lambda: torch.bmm(
                gz[:, None], stack, out=tmp).baddbmm_(wmc[:, None], x),
            "single_launches": singles(
                lib.ta_aggregate_global_f32,
                lambda p: (x[p], w[p], mask[p], stack[p], gw[p], c[p],
                           out[p], C, B, N))},
        "pop_f32": {
            "kernel": c_call(lib.ta_aggregate_pop_f32, x, w, mask, out, P,
                             C, N),
            "library": lambda: torch.bmm(wm[:, None], x, out=tmp),
            "single_launches": singles(
                lib.ta_aggregate_f32,
                lambda p: (x[p], w[p], mask[p], out[p], C, N))},
        # Eqn 19 of the two-step path: the (B, N) stack
        "dense_pop": {
            "kernel": c_call(lib.ta_aggregate_pop_f32, stack, gw, None, out,
                             P, B, N),
            "library": lambda: torch.bmm(gw[:, None], stack, out=tmp),
            "single_launches": singles(
                lib.ta_aggregate_f32,
                lambda p: (stack[p], gw[p], None, out[p], B, N))}}
    t = {"global_pop": time_ms(lambda: ta.trust_aggregate_global_pop(
             x, w, mask, stack, gw, c)),
         "global_pop_plain": time_ms(
             lambda: ref.trust_aggregate_global_pop_ref(x, w, mask, stack,
                                                        gw, c), reps=5),
         "pop_f32": time_ms(lambda: ta.trust_aggregate_pop(x, w, mask)),
         "pop_f32_plain": time_ms(
             lambda: ref.trust_aggregate_pop_ref(x, w, mask), reps=5),
         "dense_pop": time_ms(lambda: ta.trust_aggregate_pop(stack, gw)),
         "dense_pop_plain": time_ms(
             lambda: ref.trust_aggregate_pop_ref(stack, gw), reps=5)}
    for key, fns in groups.items():
        for name in fns:
            if name != "kernel":
                t[f"{key}_{name}"] = time_ms(fns[name])
    flush = L2Flush(dev)
    turns = {}
    with ClockSampler() as clock:
        for key, fns in groups.items():
            for mode, fl in (("warm", None), ("cold", flush)):
                turns[f"{key}_{mode}"] = in_turns(
                    fns, fl, label=f"trust {key} {mode}", reps=10,
                    windows=5, warmup=2, graph=True)
    del flush
    dev_ms = {k: {name: statistics.median(v) for name, v in tt.items()}
              for k, tt in turns.items()}
    print(f"batched trust kernels in turns (medians of each turn's "
          f"windows, ms): {json.dumps(turns)}", flush=True)
    b_glob = P * ((C * N + (B - 1) * N + N) * 4 + (2 * C + B + 1) * 4)
    b_f32 = P * ((C * N + N) * 4 + 2 * C * 4)
    b_dense = P * ((B * N + N) * 4 + B * 4)
    return {"err": err, "tol": tol, "slices": slices, "t": t,
            "turns": turns, "dev": dev_ms, "clock": clock.summary(),
            "bound": {"global_pop": bound_ms(b_glob, 2 * P * (C + B - 1) * N),
                      "pop_f32": bound_ms(b_f32, 2 * P * C * N),
                      "dense_pop": bound_ms(b_dense, 2 * P * B * N)},
            "bytes": {"global_pop": b_glob, "pop_f32": b_f32,
                      "dense_pop": b_dense},
            "shape": {"global_pop": {"P": P, "C": C, "B": B, "N": N},
                      "pop_f32": {"P": P, "C": C, "N": N, "mask": True},
                      "dense_pop": {"P": P, "C": B, "N": N, "mask": False}}}


def pop_live_check(pop, rounds: int, names, equal_nan: bool = False
                   ) -> dict:
    """``rounds`` more population rounds with each batched wrapper in
    ``names`` held against its batched plain version on the round's own
    (P, ...) inputs, and each slice against the single kernel's bits
    (``equal_nan``: NaN in the same places counts as equal, for a member
    that diverged).  {name: [max abs error of each call]}."""
    from repro_torch.kernels import ref
    ta = importlib.import_module("repro_torch.kernels.trust_aggregate")
    plain = {"trust_aggregate_global_pop": (
                 ref.trust_aggregate_global_pop_ref,
                 ta.trust_aggregate_global, 1e-5),
             "trust_aggregate_pop": (ref.trust_aggregate_pop_ref,
                                     ta.trust_aggregate, 1e-6)}
    seen = {n: [] for n in names}
    real = {n: getattr(ta, n) for n in names}

    def checker(name):
        def checked(*args):
            got = real[name](*args)
            want_fn, single, tol = plain[name]
            e, r, ok = (close_nan if equal_nan else close_enough)(
                got, want_fn(*args), tol)
            check(ok, f"{name} on live inputs: max abs error {e}")
            for p in range(got.shape[0]):
                one = single(*(None if a is None else a[p] for a in args))
                same = (torch.equal(got[p].isnan(), one.isnan())
                        and torch.equal(got[p].nan_to_num(0.0),
                                        one.nan_to_num(0.0))
                        if equal_nan else torch.equal(got[p], one))
                check(same, f"{name} on live inputs: slice {p} is not the "
                      "single kernel's")
            seen[name].append(e)
            return got
        return checked

    for n in names:
        setattr(ta, n, checker(n))
    try:
        pop.run_scanned(rounds, eval_final=False)
    finally:
        for n in names:
            setattr(ta, n, real[n])
    return seen


def pop_kernel_entries(pk: dict, pop: dict, counts: dict, total: dict
                       ) -> list:
    """The kernels line's entries of the three population-batched launches
    (`pop_kernel_phase`'s checks and times, the launches of 4f's paths)."""
    pt, pbd = pk["t"], pk["bound"]

    def entry(name: str, key: str, err_key: str, pallas_line: int,
              lib: str) -> dict:
        cold, warm = pk["dev"][f"{key}_cold"], pk["dev"][f"{key}_warm"]
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": f"{PALLAS}:{pallas_line} (under jax.vmap)",
                "launches": total[name],
                "launches_by_path": {p: c[name] for p, c in counts.items()
                                     if c[name]},
                "max_abs_err": pk["err"][err_key],
                "tolerance": pk["tol"][err_key],
                "slices_bitwise_equal_to_single": pk["slices"],
                "ms": pt[key], f"{lib}_ms": pt[f"{key}_{lib}"],
                "cold_ms": cold["kernel"], "warm_ms": warm["kernel"],
                f"{lib}_cold_ms": cold[lib], f"{lib}_warm_ms": warm[lib],
                "single_launches_ms": pt[f"{key}_single_launches"],
                "single_launches_cold_ms": cold["single_launches"],
                "single_launches_warm_ms": warm["single_launches"],
                "plain_ms": pt[f"{key}_plain"], "bound_ms": pbd[key][0],
                "bound_by": pbd[key][1], "bytes": pk["bytes"][key],
                "shape": pk["shape"][key],
                "in_turns_ms": {m: pk["turns"][f"{key}_{m}"]
                                for m in ("warm", "cold")},
                **({} if lib == "library" else {"library_ms": None})}

    return [
        {**entry("trust_aggregate_global_pop", "global_pop", "global_pop",
                 51, "library_two_calls"),
         "live_max_abs_err": pop["paper-mlp-fleet1k"]["live_max_abs_err"],
         "sm_clock_while_timed": pk["clock"]},
        {**entry("trust_aggregate_pop", "pop_f32", "pop_f32", 44,
                 "library"),
         "bf16_max_abs_err": pk["err"]["pop_bf16"],
         "bf16_tolerance": pk["tol"]["pop_bf16"],
         "live_max_abs_err": pop["dp-fleet1k"]["live_max_abs_err"]},
        entry("trust_aggregate_dense_pop", "dense_pop", "pop_f32", 37,
              "library"),
    ]


def population_phase(dev) -> dict:
    """4f. populations: the batched kernels (`pop_kernel_phase`); then the
    B = 8 population of ``paper-mlp-fleet1k`` (lr {0.05, 0.1} x 4
    replicates, each member from its own `member_seed`) through
    ``PopulationEngine.from_population(pspec).run_scanned(30)`` (30
    batched fused launches, no single one) and a steady
    ``run_scanned(10)`` (member-rounds/s), two more rounds on live inputs;
    every member against a standalone
    ``Federation.from_spec(member_spec).run_scanned(30)`` run in this
    process (schedule equal, final accuracy within 0.002), the lr 0.1
    members' median against the main path's accuracy limit (the JAX
    package's figure at seed 0; the members' seeds are derived); then
    ``dp-fleet1k``
    with ``privacy.noise`` {0.25, 0.5} (B = 2) through
    ``run_scanned(10)`` (10 batched masked and 10 batched unmasked
    launches) and two more rounds on live inputs; then the pool CLI on a
    2-member ``paper-mlp-fleet1k`` population in 10-round segments: two
    segments and ``pool resume`` for a third, against three straight in
    this process (each member's trace.jsonl byte-equal, manifest energy
    equal), a ragged frontier resumed to the common step (in this
    process), ``pool status``."""
    import shutil
    import tempfile
    from repro_torch.api import Federation, FederationSpec
    from repro_torch.api.scenarios import DP_FLEET1K, PAPER_MLP_FLEET1K
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.pop import PopulationEngine, PopulationSpec
    from repro_torch.serve.pool import (common_checkpoint_step, member_dir,
                                        run_pool, write_pool_spec)
    from repro_torch.serve.runner import latest_resumable
    from repro_torch.serve.service import child_env
    t_phase = time.perf_counter()
    kp = pop_kernel_phase(dev)
    free_library_memory()
    counts, out = {}, {}

    def counted(label, expect):
        counts[label] = dict(launches)
        got = {k: launches[k] for k in TRUST_KERNELS}
        want = {k: expect.get(k, 0) for k in TRUST_KERNELS}
        check(got == want, f"{label} launched {got}, expected {want}")

    # the main population, B = 8
    base = FederationSpec.from_dict(PAPER_MLP_FLEET1K)
    pspec = PopulationSpec(base=base, grid={"lr": [0.05, 0.1]},
                           replicates=POP_B // 2)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    pop = PopulationEngine.from_population(pspec)
    t_build = time.perf_counter() - t0
    widths = {"members": [f.engine._member_table.shape[1]
                          for f in pop.federations],
              "population": pop._mp["member_table"].shape[2]}
    reset_launches()
    t0 = time.perf_counter()
    traces = pop.run_scanned(POP_K)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counted("population_run_scanned",
            {"trust_aggregate_global_pop": POP_K})
    reset_launches()
    t0 = time.perf_counter()
    pop.run_scanned(POP_STEADY_K, eval_final=False)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    counted("population_steady",
            {"trust_aggregate_global_pop": POP_STEADY_K})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    live = pop_live_check(pop, 2, ["trust_aggregate_global_pop"])
    # what the population itself holds at its peak, over what was
    # allocated before it was built
    peak_own = peak - before
    mrps = POP_B * POP_STEADY_K / t_steady
    bad = [k for k, v in pop.state.tensors().items()
           if v.device.type != dev.type]
    check(not bad, f"population state tensors off the card: {bad}")
    accs = [tr.records[-1].acc for tr in traces]
    losses = [r.loss for tr in traces for r in tr.records]
    check(all(math.isfinite(v) for v in losses), "population: non-finite loss")
    print(f"population B={POP_B} paper-mlp-fleet1k: built in {t_build:.2f} "
          f"s; run_scanned({POP_K}) {t_first:.2f} s; steady "
          f"run_scanned({POP_STEADY_K}) {mrps:.3f} member-rounds/s; "
          f"accuracies {accs}; peak {peak:.3f} GiB, {peak_own:.3f} GiB "
          f"over the {before:.3f} GiB allocated before", flush=True)
    specs = pop.specs
    del pop
    torch.cuda.empty_cache()

    # every member against a standalone run of its spec, in this process
    standalone = {}
    for b in range(POP_B):
        fed = Federation.from_spec(specs[b])
        tr = fed.run_scanned(POP_K)
        sched = lambda t_: [(r.round, r.cluster, r.a, r.agg_count)
                            for r in t_.records]
        check(sched(tr) == sched(traces[b]),
              f"population member {b}: schedule differs from its "
              "standalone run")
        acc_b = tr.records[-1].acc
        check(abs(acc_b - accs[b]) <= ACC_MARGIN,
              f"population member {b}: accuracy {accs[b]} against its "
              f"standalone run's {acc_b}")
        entry = {"lr": specs[b].lr, "seed": specs[b].seed,
                 "population_acc": accs[b], "standalone_acc": acc_b,
                 "schedule_equal": True,
                 "max_abs_loss_diff": max(abs(r.loss - s.loss) for r, s in
                                          zip(tr.records, traces[b].records))}
        if b == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fed.run_scanned(POP_STEADY_K, eval_final=False)
            torch.cuda.synchronize()
            entry["standalone_rounds_per_s"] = (
                POP_STEADY_K / (time.perf_counter() - t0))
        standalone[b] = entry
        del fed
        torch.cuda.empty_cache()
    # the main path's limit is the JAX package's accuracy at seed 0; the
    # members carry derived seeds, each held above to its own standalone
    # run, and the lr 0.1 members' median to that limit
    lr_top = [a for s_, a in zip(specs, accs) if s_.lr == 0.1]
    check(statistics.median(lr_top) >= JAX_ACC - ACC_MARGIN,
          f"population: the lr 0.1 members' accuracies {lr_top} have a "
          f"median below {JAX_ACC} - {ACC_MARGIN}")
    srps = standalone[0]["standalone_rounds_per_s"]
    print(f"population members against standalone runs: "
          f"{json.dumps(standalone)}; member-rounds/s {mrps:.3f} against "
          f"standalone rounds/s {srps:.3f} ({mrps / srps:.2f}x)", flush=True)
    out["paper-mlp-fleet1k"] = {
        "B": POP_B, "grid": {"lr": [0.05, 0.1]}, "build_s": t_build,
        "widest_cluster": widths,
        "first_run_s": t_first, "member_rounds_per_s": mrps,
        "standalone_rounds_per_s": srps, "accuracies": accs,
        "peak_gib": peak, "peak_over_baseline_gib": peak_own,
        "members_vs_standalone": standalone,
        "live_max_abs_err": max(live["trust_aggregate_global_pop"])}

    # DP: the two-step path, batched masked + unmasked kernels
    dpspec = PopulationSpec(base=FederationSpec.from_dict(DP_FLEET1K),
                            grid={"privacy.noise": [0.25, 0.5]})
    dpop = PopulationEngine.from_population(dpspec)
    reset_launches()
    t0 = time.perf_counter()
    dtr = dpop.run_scanned(10)
    torch.cuda.synchronize()
    t_dp = time.perf_counter() - t0
    counted("population_dp", {"trust_aggregate_pop": 10,
                              "trust_aggregate_dense_pop": 10})
    dlive = pop_live_check(dpop, 2, ["trust_aggregate_pop"])
    check(len(dlive["trust_aggregate_pop"]) == 4,
          f"dp population live check: {dlive}")
    check(all(math.isfinite(r.loss) for tr in dtr for r in tr.records),
          "dp population: non-finite loss")
    out["dp-fleet1k"] = {
        "B": 2, "grid": {"privacy.noise": [0.25, 0.5]},
        "member_rounds_per_s": 2 * 10 / t_dp,
        "accuracies": [tr.records[-1].acc for tr in dtr],
        "live_max_abs_err": max(dlive["trust_aggregate_pop"])}
    print(f"population dp-fleet1k B=2: {json.dumps(out['dp-fleet1k'])}",
          flush=True)
    del dpop
    torch.cuda.empty_cache()

    # the pool, through the CLI, against a straight pool in process
    root = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    try:
        ppspec = PopulationSpec(base=base, replicates=2)
        spec_file = os.path.join(root, "population.json")
        with open(spec_file, "w") as f:
            json.dump(ppspec.to_dict(), f)
        resumed, straight = (os.path.join(root, n)
                             for n in ("resumed", "straight"))

        def cli(*argv):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.serve", "pool", *argv,
                 "--run-dir", resumed], env=child_env(),
                capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0,
                  f"pool {argv}: exit {proc.returncode}: {proc.stderr}")
            return proc.stdout, time.perf_counter() - t0

        loop = ["--segment-rounds", "10", "--keep", "0", "--foreground",
                "--device", dev.type]
        wall = {}
        _, wall["start_2_segments"] = cli(
            "start", "--spec-file", spec_file, "--max-segments", "2", *loop)
        _, wall["resume_1_segment"] = cli("resume", "--max-segments", "1",
                                          *loop)
        os.makedirs(straight)
        write_pool_spec(straight, ppspec)
        reset_launches()
        t0 = time.perf_counter()
        run_pool(straight, segment_rounds=10, max_segments=3, keep=None,
                 device=dev.type, log=lambda *a: None)
        wall["straight_3_segments_in_process"] = time.perf_counter() - t0
        counted("pool_straight", {"trust_aggregate_global_pop": 30})

        def compare(what):
            for b in range(2):
                ra, rb = member_dir(resumed, b), member_dir(straight, b)
                check(read_bytes(os.path.join(ra, "trace.jsonl")) ==
                      read_bytes(os.path.join(rb, "trace.jsonl")),
                      f"pool ({what}): member {b}'s trace.jsonl differs "
                      "from the straight pool's")
                ma = latest_resumable(os.path.join(ra, "checkpoints"))[1]
                mb = latest_resumable(os.path.join(rb, "checkpoints"))[1]
                check(ma["rounds"] == mb["rounds"] == 30
                      and ma["energy"] == mb["energy"],
                      f"pool ({what}): member {b} manifests {ma} vs {mb}")
        compare("resumed")
        # a ragged frontier: member 1 loses its newest checkpoint
        ckpts = os.path.join(member_dir(resumed, 1), "checkpoints")
        for f in os.listdir(ckpts):
            if "00000030" in f:
                os.remove(os.path.join(ckpts, f))
        dirs = [member_dir(resumed, b) for b in range(2)]
        check(common_checkpoint_step(dirs) == 20,
              f"ragged frontier: common step {common_checkpoint_step(dirs)}")
        t0 = time.perf_counter()
        run_pool(resumed, segment_rounds=10, max_segments=1, keep=None,
                 resume=True, device=dev.type, log=lambda *a: None)
        wall["ragged_resume_in_process"] = time.perf_counter() - t0
        compare("ragged frontier resumed")
        status, wall["status"] = cli("status")
        st = json.loads(status)
        check(st["state"]["status"] == "stopped" and not st["alive"]
              and [m["checkpoint_step"] for m in st["members"]] == [30, 30],
              f"pool status: {st}")
        out["pool"] = {"B": 2, "segment_rounds": 10, "wall_s": wall,
                       "state": st["state"],
                       "trace_bytes": [os.path.getsize(os.path.join(
                           member_dir(resumed, b), "trace.jsonl"))
                           for b in range(2)]}
        print(f"pool: 2 + 1 resumed segments == 3 straight and a ragged "
              f"frontier resumed at round 20 == 3 straight (each member's "
              f"trace.jsonl byte-equal, manifest energy equal); "
              f"{json.dumps(out['pool'])}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return {"population": out, "kernels": kp, "counts": counts}


# --------------------------------------------------------------------- #
# the paper's own evaluation: the legacy shim, Figs 2-8, the grid
# --------------------------------------------------------------------- #
# the JAX package's figures on the CPU (scripts/jax_reference.py
# --figures: benchmarks/figures.py's protocol through its own building
# blocks, every protocol seed offset by 0, 1, 2, 3 and 4; JAX 0.9.0):
# metric -> its value at each offset
JAX_FIGURES = {
    "fig2,td_loss_early": [1.3137, 1.95151, 1.59428, 0.294369, 2.17672],
    "fig2,td_loss_late": [0.779572, 0.86267, 0.320002, 0.832786, 0.944539],
    "fig2,converged": [1, 1, 1, 0, 1],
    "fig3,acc_calibrated": [0.940918, 0.794434, 0.995605, 0.966797, 0.750977],
    "fig3,acc_with_deviation": [
        0.944824, 0.793945, 0.913574, 0.967285, 0.832031],
    "fig4,aggs_to_target_pgood_0.0": [64, 18, 36, 11, 9],
    "fig4,mean_a_pgood_0.0": [1, 2, 1.27778, 3.36364, 3.66667],
    "fig4,aggs_to_target_pgood_0.2": [64, 18, 38, 11, 9],
    "fig4,mean_a_pgood_0.2": [1, 2, 1.15789, 3.36364, 3.44444],
    "fig4,aggs_to_target_pgood_0.5": [64, 4, 32, 12, 10],
    "fig4,mean_a_pgood_0.5": [1, 7.5, 1.40625, 3.16667, 3.2],
    "fig4,aggs_to_target_pgood_0.8": [64, 4, 40, 12, 9],
    "fig4,mean_a_pgood_0.8": [1, 9, 1.125, 3.25, 3.44444],
    "fig4,aggs_to_target_pgood_1.0": [64, 4, 39, 12, 9],
    "fig4,mean_a_pgood_1.0": [1, 9, 1.15385, 3, 3.66667],
    "fig5,energy_good_early": [49.2702, 280.877, 44.3375, 58.7053, 65.9167],
    "fig5,energy_good_trained": [49.2702, 231.388, 62.5685, 58.7053, 100.717],
    "fig5,energy_medium_early": [46.4801, 262.795, 43.4361, 58.844, 66.0428],
    "fig5,energy_medium_trained": [
        49.3066, 190.411, 62.7191, 72.6108, 108.638],
    "fig5,energy_bad_early": [50.3213, 157.993, 50.2515, 58.9531, 62.904],
    "fig5,energy_bad_trained": [49.3791, 216.364, 64.7811, 58.9531, 87.9916],
    "fig6,final_acc_k1": [0.999023, 0.99707, 0.999674, 0.997396, 0.999674],
    "fig7,time_to_0.8_k1": [3.82038, 3.52909, 3.76105, 3.60264, 3.91217],
    "fig6,final_acc_k2": [0.988281, 0.997721, 0.998372, 0.996094, 0.992513],
    "fig7,time_to_0.8_k2": [3.76377, 3.47152, 3.72078, 3.3408, 3.68218],
    "fig6,final_acc_k4": [0.994792, 0.994141, 0.999023, 0.992188, 0.996419],
    "fig7,time_to_0.8_k4": [3.6389, 4.9176, 3.65317, 6.8616, 3.5395],
    "fig6,final_acc_k8": [0.97819, 0.99707, 0.995117, 0.977539, 0.994141],
    "fig7,time_to_0.8_k8": [3.06724, 3.28245, 3.5921, 6.77309, 3.16372],
    "fig8,acc_adaptive": [0.999349, 0.999674, 1, 1, 0.999674],
    "fig8,acc_fixed_1": [1, 1, 1, 1, 1],
    "fig8,acc_fixed_5": [1, 1, 1, 1, 1],
    "fig8,acc_fixed_10": [0.995443, 0.999674, 0.933594, 0.941732, 0.747721],
}
# Each figure's number is held to the JAX package's five seeds: within
# FIG_SIGMAS standard deviations of the difference between one draw and
# the mean of five (3 s sqrt(1 + 1/5), s the JAX seeds' sample standard
# deviation) of their mean, the margin of the faulty specs' limit (PERF.md
# section 2) for one port seed; an accuracy gets at least ACC_QUANTUM
# (three samples of 3,072: where the JAX seeds agree exactly)
FIG_SIGMAS = 3.0
ACC_QUANTUM = 0.001
# the JAX package's robustness grid on the CPU (benchmarks/attack_bench.py
# run by scripts/jax_reference.py --figures, its fixed seed 11):
# trust_recovery per (workload, fault).  BENCH_robustness.json's committed
# figures (+0.739, +0.451, +0.433, +0.419) do not reproduce there; the
# port is held to the sign of each recovery above RECOVERY_MIN
JAX_RECOVERY = {("mlp", "sign_flip"): 0.769, ("mlp", "gaussian"): 0.0,
                ("mlp", "poison"): 0.0005,
                ("autoencoder-anomaly", "sign_flip"): 0.0,
                ("autoencoder-anomaly", "gaussian"): -0.0023,
                ("autoencoder-anomaly", "poison"): 0.0023}
RECOVERY_MIN = 0.1
SECURE_EXAMPLE = "examples/torch_secure_aggregation.py"


def fig_group(metric: str):
    """The metrics a relation may compare: one figure's numbers of one
    kind (Fig 4's counts apart from its mean a); None for Fig 2's 0/1
    flag."""
    fig, name = metric.split(",")
    if fig == "fig2" and name == "converged":
        return None
    if fig == "fig4":
        return fig + ("_aggs" if name.startswith("aggs") else "_mean_a")
    return fig


def jax_relations() -> list:
    """Every ordering of two metrics of one group that the JAX package
    shows on all five seeds: (a, ">" or ">=", b)."""
    import itertools
    groups = {}
    for m in JAX_FIGURES:
        if fig_group(m):
            groups.setdefault(fig_group(m), []).append(m)
    rel = []
    for ms in groups.values():
        for a, b in itertools.permutations(ms, 2):
            va, vb = JAX_FIGURES[a], JAX_FIGURES[b]
            if all(x > y for x, y in zip(va, vb)):
                rel.append((a, ">", b))
            elif all(x >= y for x, y in zip(va, vb)) and va != vb:
                rel.append((a, ">=", b))
    return rel


def fig_band(metric: str):
    """(mean, margin) of the JAX seeds for ``metric``."""
    v = JAX_FIGURES[metric]
    s = statistics.stdev(v) if all(math.isfinite(x) for x in v) else 0.0
    margin = FIG_SIGMAS * s * math.sqrt(1 + 1 / len(v))
    if "acc" in metric:
        margin = max(margin, ACC_QUANTUM)
    return statistics.fmean(v), margin


def plain_json(x):
    """``x`` with every non-finite float as a string, for one strict JSON
    line (Fig 7's time to accuracy is inf where never reached)."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {str(k): plain_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain_json(v) for v in x]
    return x


def close_nan(got, want, tol):
    """`close_enough` where NaN (and inf) in the same places count as
    equal (a diverged member's aggregate): (max abs error over the other
    elements, max relative, ok)."""
    g, w = got.float(), want.float()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    ok_nan = bool(torch.equal(torch.isnan(g), torch.isnan(w)))
    d = torch.where(same, torch.zeros_like(g), (g - w).abs())
    rel = torch.where(same, torch.zeros_like(g),
                      d / (1 + w.abs())).max().item() if g.numel() else 0.0
    return (d.max().item() if g.numel() else 0.0), rel, \
        ok_nan and rel <= tol


def live_kernels(fed, rounds: int) -> dict:
    """``rounds`` more event-heap rounds of the federation ``fed``, each
    launch of the fused, masked and unmasked trust kernels held against
    its plain version on the same live tensors (fused 1e-5, the others
    1e-6, NaN in the same places).  {kernel: [(max abs, max relative,
    ok, input shape)]}."""
    from repro_torch.api import components
    from repro_torch.core import privacy, trust
    from repro_torch.kernels import ref
    seen = {"trust_aggregate": [], "trust_aggregate_dense": [],
            "trust_aggregate_global": []}
    masked, dense = privacy.trust_aggregate, trust.trust_aggregate
    fused = components.trust_aggregate_global

    def checked(name, real, plain, tol):
        def call(*args):
            got = real(*args)
            seen[name].append((*close_nan(got, plain(*args), tol),
                               tuple(args[0].shape)
                               + tuple(args[3].shape[:1] if len(args) > 3
                                       else ())))
            return got
        return call

    privacy.trust_aggregate = checked("trust_aggregate", masked,
                                      ref.trust_aggregate_ref, 1e-6)
    trust.trust_aggregate = checked("trust_aggregate_dense", dense,
                                    ref.trust_aggregate_ref, 1e-6)
    components.trust_aggregate_global = checked(
        "trust_aggregate_global", fused, ref.trust_aggregate_global_ref,
        1e-5)
    try:
        fed.run(max_rounds=rounds)
    finally:
        privacy.trust_aggregate = masked
        trust.trust_aggregate = dense
        components.trust_aggregate_global = fused
    return {k: v for k, v in seen.items() if v}


def checked_live(name: str, fed, rounds: int = 3) -> dict:
    """`live_kernels`, every call within its tolerance; {kernel: the
    largest error}."""
    seen = live_kernels(fed, rounds)
    for k, v in seen.items():
        check(len(v) == rounds and all(ok for _, _, ok, _ in v),
              f"{name}: {k} on live inputs: {v}")
    errs = {k: max(e for e, _, _, _ in v) for k, v in seen.items()}
    shapes = {k: sorted({s for _, _, _, s in v}) for k, v in seen.items()}
    print(f"{name}: kernels on {rounds} rounds' live inputs, max abs error "
          f"{json.dumps(errs)}, input shapes {json.dumps(shapes)} "
          f"(tolerance relative to 1 + |plain|: fused 1e-5, others 1e-6)",
          flush=True)
    return {"max_abs_err": errs, "shapes": shapes}


def paper_phase(dev) -> dict:
    """4g. the paper's own entry point and evaluation, each path with the
    launch counts reset before it and read after it: ``paper_mnist``
    (16 devices in 4 clusters, the 784-200-10 MLP, N = 159,010) through
    the legacy shim with a DQN trained on the card, then
    `run_sync_baseline` on the same data (one cluster of 16), each one
    fused launch a round, three more rounds of each on live inputs; Figs
    2-8 once at the protocol's seeds (each figure's rows, seconds and
    launches), held to every ordering the JAX package shows on all five of
    its seeds and to its seed band; the fused kernel on live inputs at Figs
    6/7's N = 21,410 with one cluster and with eight, and timed at both
    shapes; the full robustness grid (each fault mode one B = 2 population
    beside its sequential runs, every member within 1e-6 of its run), the
    sign of each trust recovery the JAX package shows above 0.1, the
    batched kernel on live inputs of two populations (one diverges to
    NaN); the secure-aggregation example's eight cells (the masked and
    unmasked kernels a round under DP, the unmasked under median and
    multi_krum, the fused under trust and fedavg), each on live inputs."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.configs import get_config
    from repro_torch.core import (AsyncFLConfig, AsyncFederation,
                                  run_sync_baseline)
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.paper import common, figures, robustness
    from repro_torch.pop import PopulationEngine
    t_phase = time.perf_counter()
    counts, out = {}, {}

    def trust_counts():
        return {k: launches[k] for k in TRUST_KERNELS if launches[k]}

    # 1. paper_mnist at full width through the legacy shim
    cfg = get_config("paper_mnist")
    data, parts = common.fed_setup(cfg.n_devices, 4096, 784, cfg.seed, dev)
    agent, t_dqn = timed(lambda: common.train_dqn_agent(seed=cfg.seed,
                                                        device=dev))
    shim = AsyncFederation(cfg, data, parts, agent=agent["agent"],
                           dqn_cfg=agent["dcfg"], device=dev)
    N = shim.state.global_flat.numel()
    check(N == 159010, f"paper_mnist has N = {N}, not 159,010")
    reset_launches()
    tr, t_shim = timed(lambda: shim.run())
    counts["paper_mnist_shim"] = dict(launches)
    rounds_shim = shim.agg_count
    check(trust_counts() == {"trust_aggregate_global": rounds_shim}
          and rounds_shim > 0,
          f"paper_mnist shim: {rounds_shim} rounds launched "
          f"{trust_counts()}")
    fed_checks(shim._fed, tr.records, "paper_mnist shim")
    actions = sorted({r.a for r in tr.records})
    live_shim = checked_live("paper_mnist shim", shim._fed)
    reset_launches()
    sync, t_sync = timed(lambda: run_sync_baseline(cfg, data, parts,
                                                   device=dev))
    counts["paper_mnist_sync"] = dict(launches)
    rounds_sync = launches["trust_aggregate_global"]
    check(trust_counts() == {"trust_aggregate_global": rounds_sync}
          and rounds_sync >= sync.agg_counts[-1] > 0,
          f"run_sync_baseline: {sync.agg_counts[-1]} rounds evaluated, "
          f"launched {trust_counts()}")
    check(all(math.isfinite(v) for v in sync.losses),
          "run_sync_baseline: non-finite loss")
    sync_fed = AsyncFederation(dataclasses.replace(
        cfg, n_clusters=1, fixed_frequency=5), data, parts, device=dev)
    live_sync = checked_live("run_sync_baseline (one cluster)",
                             sync_fed._fed)
    check(live_sync["shapes"]["trust_aggregate_global"][0][0]
          == cfg.n_devices, f"the sync round's padded width: {live_sync}")
    out["paper_mnist"] = {
        "config": dataclasses.asdict(cfg), "N": N,
        "dqn_train_s": t_dqn, "dqn_td_loss_last": agent["td_losses"][-1],
        "shim": {"rounds": rounds_shim, "records": len(tr.records),
                 "seconds": t_shim, "rounds_per_s": rounds_shim / t_shim,
                 "final_acc": tr.accs[-1], "final_loss": tr.losses[-1],
                 "energy": shim.energy_used, "actions": actions,
                 "live": live_shim},
        "sync_baseline": {"rounds": rounds_sync, "seconds": t_sync,
                          "rounds_per_s": rounds_sync / t_sync,
                          "final_acc": sync.accs[-1],
                          "final_loss": sync.losses[-1], "live": live_sync}}
    print(f"paper_mnist (16 devices, 4 clusters, N {N}): DQN trained on "
          f"the card in {t_dqn:.3f} s; shim {rounds_shim} rounds in "
          f"{t_shim:.3f} s, actions {actions}, final acc {tr.accs[-1]}; "
          f"sync baseline {rounds_sync} rounds in {t_sync:.3f} s, final acc "
          f"{sync.accs[-1]}", flush=True)
    del shim, sync_fed, agent
    torch.cuda.empty_cache()

    # 2. Figs 2-8 once, at the protocol's seeds
    figs, values = {}, {}
    for fn in figures.ALL:
        key = fn.__name__.split("_")[0]
        buf = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(buf):
            _, secs = timed(lambda: fn(device=dev))
        counts[f"paper_{key}"] = dict(launches)
        rows = [line.split(",") for line in buf.getvalue().splitlines()]
        print(buf.getvalue(), end="", flush=True)
        metrics = {f"{r[0]},{r[1]}": float(r[2]) for r in rows}
        values.update(metrics)
        figs[key] = {"metrics": {k.split(",")[1]: v
                                 for k, v in metrics.items()},
                     "seconds": secs, "launches": trust_counts()}
        print(f"{key},seconds,{secs:.3f}  (launches {trust_counts()})",
              flush=True)
    check(set(values) == set(JAX_FIGURES),
          f"the figures' metrics {sorted(set(values) ^ set(JAX_FIGURES))} "
          "differ from the JAX package's")
    for key in ("fig3", "fig6", "fig8"):
        check(figs[key]["launches"].get("trust_aggregate_global", 0) > 0,
              f"{key} launched no fused kernel: {figs[key]['launches']}")
    bands = {}
    for m, v in values.items():
        mean, margin = fig_band(m)
        bands[m] = {"port": v, "jax_mean": mean, "margin": margin,
                    "jax_min": min(JAX_FIGURES[m]),
                    "jax_max": max(JAX_FIGURES[m])}
        check(abs(v - mean) <= margin + 1e-9,
              f"{m} = {v}: outside the JAX seeds' {mean} +- {margin}")
    relations = jax_relations()
    for a, op, b in relations:
        ok = values[a] > values[b] if op == ">" else values[a] >= values[b]
        check(ok, f"{a} = {values[a]} {op} {b} = {values[b]} holds on all "
              "five JAX seeds, not here")
    print(f"figures: every number within its JAX seed band; "
          f"{len(relations)} orderings of the JAX seeds hold: "
          f"{json.dumps([' '.join(r) for r in relations])}", flush=True)
    # the fused kernel at Figs 6/7's width (dim 96, N = 21,410) with one
    # cluster (no Eqn-19 neighbour) and with eight, on live inputs, then
    # timed at B = 1 and 4
    data, parts = common.fed_setup(16, 3072, 96, 4, dev)
    live96, shapes96 = {}, {}
    for k in (1, 8):
        f96 = AsyncFederation(AsyncFLConfig(
            n_devices=16, n_clusters=k, local_batch=48, sim_seconds=12.0,
            seed=4), data, parts, device=dev)
        live96[k] = checked_live(f"fig6 k={k} (N 21,410)", f96._fed)
        shapes96[k] = (f96._member_table.shape[1], k,
                       f96.state.global_flat.numel())
        check(shapes96[k][2] == 21410, f"fig6 N: {shapes96[k]}")
    del f96
    fused96 = {f"B{k}": fused_times(shapes96[k][0], k, 21410, dev)
               for k in (1, 8)}
    free_library_memory()
    out["figures"] = {"figures": figs, "bands": bands,
                      "relations": [" ".join(r) for r in relations],
                      "live_n21410": live96, "fused_n21410": fused96}

    # 3. the full robustness grid
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        grid, t_grid = timed(lambda: robustness.run(device=dev))
    print(buf.getvalue(), end="", flush=True)
    specs = robustness._specs(False)
    for row in grid["timing"]:
        rounds = specs[row["workload"]].rounds
        want_pop = {"trust_aggregate_global_pop": rounds}
        want_seq = {"trust_aggregate_global": 2 * rounds}
        check(row["population_launches"] == want_pop
              and row["sequential_launches"] == want_seq,
              f"grid {row['workload']}/{row['fault']}: population "
              f"{row['population_launches']} (want {want_pop}), sequential "
              f"{row['sequential_launches']} (want {want_seq})")
        counts[f"grid_{row['workload']}_{row['fault']}"] = {
            k: row["population_launches"].get(k, 0)
            + row["sequential_launches"].get(k, 0) for k in launches}
    recovery = {(r["workload"], r["fault"]): r["trust_recovery"]
                for r in grid["recovery"]}
    for key, want in JAX_RECOVERY.items():
        if abs(want) > RECOVERY_MIN:
            check(recovery[key] * want > 0,
                  f"trust recovery {key}: {recovery[key]} against the JAX "
                  f"package's {want}")
    # the batched kernel on the live inputs of two populations, one of
    # which diverges to NaN (fedavg under the autoencoder's sign flips)
    pop_live = {}
    for wl in ("mlp", "autoencoder-anomaly"):
        members = robustness.cell_specs(specs[wl],
                                        robustness.FAULTS[wl]["sign_flip"])
        pop = PopulationEngine(members, device=dev)
        pop.run_scanned(specs[wl].rounds, eval_final=False)
        pop_live[wl] = pop_live_check(pop, 2, ["trust_aggregate_global_pop"],
                                      equal_nan=True)
        del pop
    out["grid"] = {"seconds": t_grid, "recovery": grid["recovery"],
                   "jax_recovery": {"/".join(k): v
                                    for k, v in JAX_RECOVERY.items()},
                   "timing": grid["timing"], "grid": grid["grid"],
                   "pop_live_max_abs_err": pop_live}
    pop_seq = {f"{r['workload']}/{r['fault']}": [r["population_s"],
                                                  r["sequential_s"]]
               for r in grid["timing"]}
    print(f"robustness grid: {t_grid:.3f} s, recovery "
          f"{json.dumps({'/'.join(k): v for k, v in recovery.items()})}; "
          f"population against sequential seconds {json.dumps(pop_seq)}",
          flush=True)

    # 4. the secure-aggregation example's grid, through the shim
    spec = importlib.util.spec_from_file_location(
        "torch_secure_aggregation", os.path.join(HERE, SECURE_EXAMPLE))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    data, parts = common.fed_setup(8, 3072, 784, 0, dev)
    secure = {}
    for agg in example.AGGREGATORS:
        for dp in example.DP_NOISE:
            reset_launches()
            (fed, tr), secs = timed(lambda: example.run_cell(
                agg, dp, data, parts, dev))
            counts[f"secure_{agg}_{dp}"] = dict(launches)
            r = fed.agg_count
            if dp:
                want = {"trust_aggregate": r, "trust_aggregate_dense": r}
            elif agg in ("trust", "fedavg"):
                want = {"trust_aggregate_global": r}
            else:
                want = {"trust_aggregate_dense": r}
            check(r > 0 and trust_counts() == want,
                  f"secure aggregation {agg} dp {dp}: {r} rounds launched "
                  f"{trust_counts()}, expected {want}")
            secure[f"{agg},{dp}"] = {
                "rounds": r, "seconds": secs, "final_acc": tr.accs[-1],
                "launches": want,
                "live": checked_live(f"secure {agg} dp {dp}", fed._fed)}
    out["secure_aggregation"] = secure
    accs = {k: v["final_acc"] for k, v in secure.items()}
    print(f"secure aggregation: final accuracies {json.dumps(accs)}",
          flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 4g: {out['phase_s']:.3f} s", flush=True)
    return {"paper": out, "counts": counts}


# --------------------------------------------------------------------- #
# the serving path: recurrentgemma-2b
# --------------------------------------------------------------------- #
def attn_inputs(B, S, H, Kv, d, dtype, dev, seed, dv=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, d), generator=g, device=dev) * 0.3
    k = torch.randn((B, S, Kv, d), generator=g, device=dev) * 0.3
    v = torch.randn((B, S, Kv, d if dv is None else dv), generator=g,
                    device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


PLAIN_SCORES = 2 ** 30    # floats of scores one plain-attention call holds


def plain_attention(q, k, v, *, window=0, softcap=0.0):
    """`ref.flash_attention_ref`, over `head_slices` of the batch and of the
    K/V heads (with their query heads) where the whole call's scores would
    pass ``PLAIN_SCORES`` floats (MLA's 128 heads at S = 4096 would need
    34 GB).  Rows and head groups are independent, so it is the same
    function."""
    from repro_torch.kernels import ref
    B, S, H, _ = q.shape
    Kv = k.shape[2]
    g = H // Kv
    slices = head_slices(B, S, H, Kv)
    if len(slices) == 1:
        return ref.flash_attention_ref(q, k, v, window=window,
                                       softcap=softcap)
    out = torch.empty(q.shape[:3] + (v.shape[3],), dtype=q.dtype,
                      device=q.device)
    for bs, k0, k1 in slices:
        out[bs, :, k0 * g:k1 * g] = ref.flash_attention_ref(
            q[bs, :, k0 * g:k1 * g], k[bs, :, k0:k1], v[bs, :, k0:k1],
            window=window, softcap=softcap)
    return out


def head_slices(B, S, H, Kv, budget: int = PLAIN_SCORES) -> list:
    """(batch slice, first K/V head, end K/V head) slices of an attention
    call whose scores stay within ``budget`` floats a slice: the whole call
    when they fit."""
    g = H // Kv
    if B * H * S * S <= budget:
        return [(slice(None), 0, Kv)]
    per = max(1, budget // (g * S * S))
    return [(slice(b, b + 1), k0, min(Kv, k0 + per)) for b in range(B)
            for k0 in range(0, Kv, per)]


def plain_lse(q, k, v, *, window=0, softcap=0.0):
    """`ref.flash_attention_lse_ref` over `head_slices`: the same function
    (rows and head groups are independent)."""
    from repro_torch.kernels import ref
    B, S, H, _ = q.shape
    Kv = k.shape[2]
    g = H // Kv
    out = torch.empty(q.shape[:3] + (v.shape[3],), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for bs, k0, k1 in head_slices(B, S, H, Kv):
        o_, l_ = ref.flash_attention_lse_ref(
            q[bs, :, k0 * g:k1 * g], k[bs, :, k0:k1], v[bs, :, k0:k1],
            window=window, softcap=softcap)
        out[bs, :, k0 * g:k1 * g] = o_
        lse[bs, k0 * g:k1 * g] = l_
    return out, lse


def plain_bwd(q, k, v, o, lse, do, *, window=0, softcap=0.0):
    """`ref.flash_attention_bwd_ref` over `head_slices` of a quarter of
    PLAIN_SCORES floats (the backward holds four score-sized tensors)."""
    from repro_torch.kernels import ref
    B, S, H, _ = q.shape
    Kv = k.shape[2]
    g = H // Kv
    slices = head_slices(B, S, H, Kv, PLAIN_SCORES // 4)
    if len(slices) == 1:
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           window=window, softcap=softcap)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for bs, k0, k1 in slices:
        hs = slice(k0 * g, k1 * g)
        dq[bs, :, hs], dk[bs, :, k0:k1], dv[bs, :, k0:k1] = \
            ref.flash_attention_bwd_ref(
                q[bs, :, hs], k[bs, :, k0:k1], v[bs, :, k0:k1], o[bs, :, hs],
                lse[bs, hs], do[bs, :, hs], window=window, softcap=softcap)
    return dq, dk, dv


def scan_inputs(B, S, W, dtype, dev, seed, a_range=None):
    """a = sigmoid(normal), or uniform on ``a_range`` (recurrentgemma's
    regime, a close to 1: long-range carries); bx normal at scale 0.3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=dev))
    if a_range is not None:
        lo, hi = a_range
        a = lo + (hi - lo) * torch.rand((B, S, W), generator=g, device=dev)
    bx = torch.randn((B, S, W), generator=g, device=dev) * 0.3
    return a.to(dtype), bx.to(dtype)


def reachable_pairs(B, S, H, window):
    """(query, key) pairs the causal (windowed) mask keeps."""
    w = window if window > 0 else S
    per_head = sum(min(i + 1, w) for i in range(S))
    return B * H * per_head


def lm_kernel_phase(cfg, dev, compare_dirs=()) -> dict:
    """Both language-model kernels against their plain versions at the
    serving path's shapes, at tests/test_kernels.py's parametrisations and
    at ragged ones; times at the serving path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, rglru_scan
    B, S, H, Kv, d = (SERVE_BATCH, SERVE_PROMPT, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    W, window = cfg.lru_width, cfg.window
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"fa": {"float32": 0.0, "bfloat16": 0.0},
           "scan": {"float32": 0.0, "bfloat16": 0.0}}
    # (B, S, H, Kv, d, window, softcap, dtype): the serving path's layer,
    # tests/test_kernels.py's sweep, then ragged S (not a multiple of 16,
    # 32 or 64), grouped heads, every output-width template (<= 32, 64,
    # 128, 256), d = 48 and d not a multiple of 16 bytes (plain loads in
    # place of cp.async), windows shorter than a key tile, softcap and bf16
    # at head_dim 256
    fa_cases = [(B, S, H, Kv, d, window, 0.0, f32),
                (1, 256, 2, 2, 64, 0, 0.0, f32), (2, 512, 4, 4, 64, 0, 0.0, f32),
                (1, 512, 2, 2, 128, 128, 0.0, f32),
                (1, 256, 2, 2, 64, 0, 30.0, f32),
                (1, 256, 2, 2, 64, 0, 0.0, bf16),
                (1, S + 1, H, Kv, d, window, 0.0, f32),
                (2, 100, 6, 2, 32, 16, 0.0, f32),
                (1, 100, H, Kv, d, 0, 0.0, bf16),
                (1, 1000, H, Kv, d, 300, 0.0, bf16),
                (1, 77, 6, 2, 48, 8, 0.0, f32),
                (2, 200, H, 2, 128, 0, 0.0, f32),
                (1, 130, H, 1, 16, 0, 0.0, f32),
                (1, 300, H, Kv, d, 5, 50.0, f32),
                (1, 50, 2, 1, 33, 0, 0.0, f32),
                (1, 333, 6, 2, 48, 20, 0.0, bf16),
                (1, 45, 3, 1, 20, 0, 0.0, bf16)]
    used = {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, s, h, kv, dd, win, cap, dt) in enumerate(fa_cases):
        q, k, v = attn_inputs(b, s, h, kv, dd, dt, dev, 100 + i)
        name = str(dt).split(".")[1]
        got = flash_attention(q, k, v, window=win, softcap=cap)
        want = ref.flash_attention_ref(q, k, v, window=win, softcap=cap)
        e, ok = within(got, want, FA_TOL[name], FA_TOL[name])
        check(ok, f"flash_attention {(b, s, h, kv, dd, win, cap, name)}: "
                  f"max abs error {e} beyond tolerance {FA_TOL[name]}")
        err["fa"][name] = max(err["fa"][name], e)
        used[name] = max(used[name], tolerance_used(got, want, FA_TOL[name],
                                                    FA_TOL[name]))
    # the shapes phase 7's architectures give the kernel (B, S, H, Kv, d,
    # dv, window, softcap), float32: MLA's prefill (deepseek-v2: d = qk_nope
    # + qk_rope = 192, dv = v_head_dim = 128, 128 heads), ragged d != dv,
    # qwen1.5-32b's multi-head 40/40 and grok-1's 48/8 under a cap of 30 at
    # a ragged S
    served_cases = [(B, S, 128, 128, 192, 128, 0, 0.0),
                    (2, 77, 4, 4, 192, 128, 0, 0.0),
                    (1, 45, 3, 1, 40, 24, 5, 0.0),
                    (1, S + 1, 40, 40, 128, 128, 0, 0.0),
                    (1, S + 1, 48, 8, 128, 128, 0, 30.0)]
    err["fa_served"] = {}
    for i, (b, s, h, kv, dd, dv, win, cap) in enumerate(served_cases):
        q, k, v = attn_inputs(b, s, h, kv, dd, f32, dev, 150 + i, dv=dv)
        got = flash_attention(q, k, v, window=win, softcap=cap)
        want = plain_attention(q, k, v, window=win, softcap=cap)
        e, ok = within(got, want, FA_TOL["float32"], FA_TOL["float32"])
        shape = (b, s, h, kv, dd, dv, win, cap)
        check(ok and got.shape == (b, s, h, dv),
              f"flash_attention {shape}: max abs error {e} beyond "
              f"tolerance {FA_TOL['float32']}")
        err["fa_served"][str(shape)] = e
        err["fa"]["float32"] = max(err["fa"]["float32"], e)
        used["float32"] = max(used["float32"], tolerance_used(
            got, want, FA_TOL["float32"], FA_TOL["float32"]))
    del q, k, v, got, want
    # (B, S, W, dtype, range of a): the serving path's layer, the JAX
    # sweep, ragged, and a in [0.9, 0.9999] over S = 4097 (recurrentgemma's
    # regime: a sub-chunk's product of a stays near 1)
    scan_cases = [(B, S, W, f32, None), (1, 32, 64, f32, None),
                  (2, 64, 256, f32, None), (1, 64, 128, bf16, None),
                  (3, 37, 100, f32, None), (2, S + 1, W + 1, f32, None),
                  (1, 100, 2561, bf16, None),
                  (2, S + 1, W, f32, (0.9, 0.9999))]
    for i, (b, s, w, dt, a_range) in enumerate(scan_cases):
        a, bx = scan_inputs(b, s, w, dt, dev, 200 + i, a_range)
        name = str(dt).split(".")[1]
        y, h = rglru_scan(a, bx)
        yr, hr = ref.rglru_scan_ref(a, bx)
        ey, oky = within(y, yr, SCAN_TOL[name], 0.05)
        eh, okh = within(h, hr, SCAN_TOL[name], 0.05)
        check(oky and okh, f"rglru_scan {(b, s, w, name)}: max abs error "
                           f"{max(ey, eh)} beyond {SCAN_TOL[name]}")
        err["scan"][name] = max(err["scan"][name], ey, eh)
    torch.cuda.synchronize()
    n_cases = {"fa": len(fa_cases) + len(served_cases),
               "scan": len(scan_cases)}
    for k_, tol in (("fa", FA_TOL), ("scan", SCAN_TOL)):
        print(f"kernel check {k_}: max abs error {err[k_]} (tolerance "
              f"{tol}), {n_cases[k_]} shapes", flush=True)
    print(f"kernel check fa: share of the tolerance used {used}", flush=True)

    # times at the serving path's shapes
    q, k, v = attn_inputs(B, S, H, Kv, d, f32, dev, 99)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous()
    vh = v.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous()
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = (lib().transpose(1, 2) - ref.flash_attention_ref(
        q, k, v, window=window)).abs().max().item()
    a, bx = scan_inputs(B, S, W, f32, dev, 98)
    ab, bxb = a.to(bf16), bx.to(bf16)
    qb, kb, vb = (x.to(bf16) for x in (q, k, v))
    qhb, khb, vhb = (x.to(bf16) for x in (qh, kh, vh))
    t = {"fa": time_ms(lambda: flash_attention(q, k, v, window=window),
                       reps=3, windows=5, warmup=2),
         "fa_plain": time_ms(lambda: ref.flash_attention_ref(
             q, k, v, window=window), reps=1, windows=3, warmup=1),
         "fa_lib": time_ms(lib, reps=3, windows=5, warmup=2),
         "fa_bf16": time_ms(lambda: flash_attention(qb, kb, vb,
                                                    window=window),
                            reps=3, windows=5, warmup=2),
         "fa_bf16_lib": time_ms(lambda: F.scaled_dot_product_attention(
             qhb, khb, vhb, attn_mask=mask), reps=3, windows=5, warmup=2),
         "scan": time_ms(lambda: rglru_scan(a, bx)),
         "scan_bf16": time_ms(lambda: rglru_scan(ab, bxb)),
         # yardstick of the card's rate on the scan's bytes (two read, one
         # written; not the same function)
         "scan_same_bytes": time_ms(lambda: torch.add(a, bx)),
         "scan_same_bytes_bf16": time_ms(lambda: torch.add(ab, bxb)),
         "scan_plain": time_ms(lambda: ref.rglru_scan_ref(a, bx), reps=1,
                               windows=3, warmup=1)}
    out = torch.empty_like(q)
    t["fa_turns"] = {}
    for where, old in other_libraries(os.path.basename(FA_SOURCE),
                                      compare_dirs, "flash_attention").items():
        def old_fa():
            status = old.fa_forward_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, Kv, d, d, d ** -0.5, window, 0.0,
                torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"flash_attention of {where} failed: {status}")
        t["fa_turns"][where] = in_turns(
            {"old": old_fa,
             "new": lambda: flash_attention(q, k, v, window=window)})
        print(f"flash_attention in turns against {where} (old, new, new, "
              f"old), ms: {t['fa_turns'][where]}", flush=True)
    # both sides call their C function on preallocated outputs, so that the
    # CUDA graphs of the warm timing allocate nothing
    hs_f, hs_b = torch.empty_like(a), torch.empty_like(ab)
    h_out = torch.empty((B, W), device=dev)

    def scan_call(where, fn, a_, bx_, hs_):
        def call():
            status = fn(a_.data_ptr(), bx_.data_ptr(), hs_.data_ptr(),
                        h_out.data_ptr(), B, S, W,
                        torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"rglru_scan of {where} failed: {status}")
        return call

    scan_src = os.path.basename(SCAN_SOURCE)
    t["scan_turns"] = {}
    mine = other_libraries(scan_src, [HERE_CSRC], "rglru_scan")[HERE_CSRC]
    for where, old in other_libraries(scan_src, compare_dirs,
                                      "rglru_scan").items():
        t["scan_turns"][where] = {
            dt: in_turns(
                {"old": scan_call(where, getattr(old, fn), a_, bx_, hs_),
                 "new": scan_call("this checkout", getattr(mine, fn), a_,
                                  bx_, hs_)}, reps=10, graph=True)
            for dt, fn, a_, bx_, hs_ in (
                ("float32", "rglru_scan_f32", a, bx, hs_f),
                ("bfloat16", "rglru_scan_bf16", ab, bxb, hs_b))}
        print(f"rglru_scan in turns against {where} (old, new, new, old), "
              f"ms: {t['scan_turns'][where]}", flush=True)
    pairs = reachable_pairs(B, S, H, window)
    flops = pairs * (2 * d + 2 * d)
    b_fa = (B * S * H * d * 2 + B * S * Kv * d * 2) * 4
    b_scan = (3 * B * S * W + B * W) * 4
    b_scan_bf16 = 3 * B * S * W * 2 + B * W * 4
    # f32 products run on the CUDA cores, or as three TF32 products on the
    # tensor cores (the kernel's route); the bound is the faster route's
    fa_routes = {"cuda cores": bound_ms(b_fa, flops),
                 "tensor cores, 3xTF32": bound_ms(b_fa, 3 * flops,
                                                  TF32_FLOPS_PER_S)}
    fa_route = min(fa_routes, key=lambda r: fa_routes[r][0])
    print(f"library attention (SDPA, boolean window mask, heads repeated) "
          f"max abs difference from the plain version: {lib_err}",
          flush=True)
    print(f"flash_attention at {(B, S, H, Kv, d)} window {window}: f32 "
          f"kernel {t['fa']} ms, SDPA {t['fa_lib']} ms, bf16 kernel "
          f"{t['fa_bf16']} ms, SDPA {t['fa_bf16_lib']} ms; f32 bound by "
          f"route {fa_routes} ms: {fa_route}", flush=True)
    del q, k, v, qh, kh, vh, qb, kb, vb, qhb, khb, vhb, mask, out
    mla = mla_attention_times(dev)
    return {"err": err, "t": t, "pairs": pairs, "lib_err": lib_err,
            "mla": mla,
            "bound": {"fa": fa_routes[fa_route],
                      "fa_bf16": bound_ms(b_fa / 2, flops, BF16_FLOPS_PER_S),
                      "scan": bound_ms(b_scan, 2 * B * S * W),
                      "scan_bf16": bound_ms(b_scan_bf16, 2 * B * S * W)},
            "fa_routes": fa_routes, "fa_route": fa_route,
            "bytes": {"fa": b_fa, "scan": b_scan, "scan_bf16": b_scan_bf16}}


def mla_attention_times(dev) -> dict:
    """The attention kernel at deepseek-v2's prefill (batch 4, 4096
    tokens, 128 heads, d = 192, dv = 128, causal), float32: its time, the
    plain version's (over slices), SDPA's through its memory-efficient
    backend (the math backend would hold 34 GB of scores), and the bound
    of its reachable pairs' operations and its bytes."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention
    B, S, H, d, dv = SERVE_BATCH, SERVE_PROMPT, 128, 192, 128
    q, k, v = attn_inputs(B, S, H, H, d, torch.float32, dev, 97, dv=dv)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def lib():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    want = plain_attention(q, k, v)
    e_fa, ok = within(flash_attention(q, k, v), want, FA_TOL["float32"],
                      FA_TOL["float32"])
    check(ok, f"flash_attention at MLA's shape: max abs error {e_fa}")
    t = {"ms": time_ms(lambda: flash_attention(q, k, v), reps=3, windows=5,
                       warmup=2),
         "plain_ms": time_ms(lambda: plain_attention(q, k, v), reps=1,
                             windows=3, warmup=1)}
    try:
        t["library_max_abs_err"] = (lib().transpose(1, 2) - want
                                    ).abs().max().item()
        t["library_ms"] = time_ms(lib, reps=3, windows=5, warmup=2)
    except RuntimeError as e:          # no memory-efficient kernel here
        t["library_ms"], t["library_error"] = None, str(e)[:300]
    pairs = reachable_pairs(B, S, H, 0)
    flops = pairs * (2 * d + 2 * dv)
    n_bytes = (2 * B * S * H * d + 2 * B * S * H * dv) * 4
    routes = {"cuda cores": bound_ms(n_bytes, flops),
              "tensor cores, 3xTF32": bound_ms(n_bytes, 3 * flops,
                                               TF32_FLOPS_PER_S)}
    route = min(routes, key=lambda r: routes[r][0])
    out = {**t, "max_abs_err": e_fa, "tolerance": FA_TOL["float32"],
           "bound_ms": routes[route][0], "bound_by": routes[route][1],
           "bound_route": route,
           "bound_ms_by_route": {r: b[0] for r, b in routes.items()},
           "reachable_pairs": pairs, "flops": flops, "bytes": n_bytes,
           "shape": {"B": B, "S": S, "H": H, "Kv": H, "d": d, "dv": dv,
                     "window": 0, "dtype": "float32"}}
    print(f"flash_attention at MLA's prefill {(B, S, H, H, d, dv)}: kernel "
          f"{out['ms']} ms, plain {out['plain_ms']} ms, SDPA "
          f"(memory-efficient) {out['library_ms']} ms, bound {routes} ms "
          f"({route}); max abs error {e_fa}", flush=True)
    return out


def serving_phase(cfg, dev, expect: dict, entries: dict) -> dict:
    """generate() at full width, with the launch counts set to 0 before the
    prefill and read after it and after the decode loop.  The prefill must
    launch ``expect[kernel]`` times each kernel (0 for the others) and the
    decode loop none.  ``entries`` maps a kernel to the `kernels.ops`
    function that launches it; the first call's inputs and outputs are
    kept (the first layer of that kind)."""
    from repro_torch.kernels import launches, ops, reset_launches
    from repro_torch.launch.serve import generate
    seen = {}
    counts, current = {}, [None]

    def on_phase(name):
        torch.cuda.synchronize()
        if current[0] is not None:
            counts[current[0]] = dict(launches)
        reset_launches()
        current[0] = name

    def keep(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen.setdefault(name, (args, kw, out))
            return out
        return wrapped

    originals = {k: getattr(ops, fn) for k, fn in entries.items()}
    for k, fn in entries.items():
        setattr(ops, fn, keep(k, originals[k]))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory allocated before {cfg.name} is built: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = generate(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                       temperature=0.0, seed=0, device=dev,
                       on_phase=on_phase)
    finally:
        for k, fn in entries.items():
            setattr(ops, fn, originals[k])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pre, dec = counts["prefill"], counts["decode"]
    n_params = sum(p.numel() for p in res.model.parameters())
    print(f"serving {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {n_params} parameters, f32): batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
          f"{SERVE_GEN} tokens: prefill {res.prefill_s:.4f} s, decode "
          f"{len(res.decode_logits)} steps in {res.decode_s:.4f} s = "
          f"{res.decode_tokens_per_s:.2f} tokens/s, {wall:.2f} s with "
          f"parameter init, peak device memory {peak:.3f} GiB", flush=True)
    print(f"launches: prefill {json.dumps(pre)}, decode {json.dumps(dec)}",
          flush=True)
    check(all(pre[k] == expect.get(k, 0) for k in pre),
          f"the prefill launched {pre}, expected {expect}")
    check(not any(dec.values()), f"the decode loop launched kernels: {dec}")
    # an audio model's K codebooks follow the batch dim; logits span the
    # padded vocabulary, its pad entries masked to -1e9
    books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    check(res.tokens.shape == (SERVE_BATCH,) + books + (SERVE_GEN,)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size, "bad token ids")
    for lg in [res.prefill_logits] + res.decode_logits:
        check(lg.shape == (SERVE_BATCH,) + books + (cfg.padded_vocab,)
              and bool(torch.isfinite(lg).all()), "bad logits")
    return {"res": res, "counts": counts, "seen": seen, "peak": peak,
            "parameters": n_params}


def live_lm_check(seen) -> dict:
    """The kernels' outputs on the first attention (LOCAL for
    recurrentgemma-2b) and the first RG-LRU layer of the prefill against
    their plain versions on the same inputs (attention alone for a model
    without RG-LRU layers)."""
    from repro_torch.kernels import ref
    (q, k, v), kw, out = seen["flash_attention"]
    want = plain_attention(q, k, v, **kw)
    e_fa, ok = within(out, want, FA_TOL["float32"], FA_TOL["float32"])
    used_fa = tolerance_used(out, want, FA_TOL["float32"], FA_TOL["float32"])
    check(ok, f"flash_attention on the prefill's inputs: {e_fa}")
    if "rglru_scan" not in seen:
        print(f"flash_attention on the prefill's own inputs (first "
              f"attention layer, q {tuple(q.shape)}, v {tuple(v.shape)}, "
              f"{kw}): max abs error {e_fa} (share of the tolerance used "
              f"{used_fa})", flush=True)
        return {"fa": e_fa, "fa_tolerance_used": used_fa}
    (a, bx), _, (y, h) = seen["rglru_scan"]
    yr, hr = ref.rglru_scan_ref(a, bx)
    ey, oky = within(y, yr, SCAN_TOL["float32"], 0.05)
    eh, okh = within(h, hr, SCAN_TOL["float32"], 0.05)
    check(oky and okh, f"rglru_scan on the prefill's inputs: {ey}, {eh}")
    print(f"kernels on the prefill's own inputs (first LOCAL layer, q "
          f"{tuple(q.shape)} window {kw.get('window')}, max |q| "
          f"{q.abs().max().item()}, max |k| {k.abs().max().item()}; first "
          f"RG-LRU layer, a {tuple(a.shape)}): max abs error "
          f"flash_attention {e_fa} (share of the tolerance used {used_fa}), "
          f"rglru_scan {max(ey, eh)}", flush=True)
    return {"fa": e_fa, "fa_tolerance_used": used_fa, "scan": max(ey, eh)}


def consistency_check(res, bounded: bool = True) -> float:
    """Decode of token 4096 after a 4096-token prefill against a prefill of
    all 4097 tokens (last position).  ``bounded=False`` (MoE: capacity
    depends on a call's tokens, so the two drop different assignments)
    reports the gap without holding it to the tolerance."""
    full = torch.cat([res.prompts, res.tokens[..., :1]], dim=-1)
    with torch.inference_mode():
        logits, _ = res.model.prefill(full, cache_len=full.shape[-1])
    want = res.decode_logits[0]
    e = (logits - want).abs().max().item()
    bound = (f"tolerance {CONSISTENCY_TOL}" if bounded
             else "reported, not bounded")
    print(f"consistency ({res.model.cfg.name}): decode at position "
          f"{SERVE_PROMPT} against a {full.shape[-1]}-token prefill: max "
          f"abs error {e} ({bound}), max |logit| "
          f"{want.abs().max().item()}", flush=True)
    check(not bounded or e < CONSISTENCY_TOL,
          f"prefill/decode disagree by {e}")
    return e


# --------------------------------------------------------------------- #
# the serving path: falcon-mamba-7b
# --------------------------------------------------------------------- #
def ssm_inputs(B, S, Di, N, dtype, dev, seed):
    """tests/test_kernels.py's draws: xc, softplus(normal) dt, B and C at
    scale 0.5, a random A = -exp(normal) (a learned A, not the seeded
    init's rows); A stays f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xc = torch.randn((B, S, Di), generator=g, device=dev) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, Di), generator=g, device=dev))
    Bc = torch.randn((B, S, N), generator=g, device=dev) * 0.5
    Cc = torch.randn((B, S, N), generator=g, device=dev) * 0.5
    A = -torch.exp(torch.randn((Di, N), generator=g, device=dev))
    return [t.to(dtype) for t in (xc, dt, Bc, Cc)] + [A]


def check_ssm(name, got, want, dtype_name) -> float:
    (y, h), (yr, hr) = got, want
    tol = SCAN_TOL[dtype_name]
    ey, oky = within(y, yr, tol, 0.05)
    eh, okh = within(h, hr, tol, 0.05)
    check(oky and okh, f"selective_scan {name}: max abs error y {ey}, "
                       f"h_last {eh}, beyond atol {tol} / rtol 0.05")
    return max(ey, eh)


def mamba_kernel_phase(cfg, dev, compare_dirs=()) -> dict:
    """The selective-scan kernel against its plain version at the serving
    path's shape, at tests/test_kernels.py's parametrisations and at
    ragged ones; times and the bound at the serving path's shape."""
    from repro_torch.kernels import ref, selective_scan
    B, S, Di, N = SERVE_BATCH, SERVE_PROMPT, cfg.d_inner, cfg.ssm_state
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"float32": 0.0, "bfloat16": 0.0}
    # (B, S, Di, N, dtype): the serving path's layer, the JAX sweep, then
    # ragged Di (not a multiple of 64 or of 16 bytes), S (1, not a
    # multiple of the 32-step chunk) and N (1, 5, 17: lanes partly empty;
    # 64: four lanes a channel), and bf16 at the serving width
    cases = [(B, S, Di, N, f32), (1, 32, 64, 8, f32), (2, 64, 128, 16, f32),
             (1, 48, 64, 8, bf16), (3, 37, 100, 16, f32),
             (2, S + 1, Di + 1, N, f32), (1, 5, 3, 5, f32),
             (2, 70, 100, 16, bf16), (1, 1000, Di, N, bf16),
             (1, 1, 64, 16, f32), (2, 45, 130, 1, f32), (1, 33, 96, 17, f32),
             (1, 40, 70, 64, f32), (1, 65, 64, 64, bf16),
             (1, 50, 128, 17, bf16)]
    for i, (b, s_, d, n, dt_) in enumerate(cases):
        args = ssm_inputs(b, s_, d, n, dt_, dev, 300 + i)
        name = str(dt_).split(".")[1]
        e = check_ssm((b, s_, d, n, name), selective_scan(*args),
                      ref.selective_scan_ref(*args), name)
        err[name] = max(err[name], e)
        del args
    torch.cuda.synchronize()
    print(f"kernel check selective_scan: max abs error {err} (tolerance "
          f"{SCAN_TOL} with rtol 0.05), {len(cases)} shapes", flush=True)

    args = ssm_inputs(B, S, Di, N, f32, dev, 97)
    # serving's forward (a null states pointer) against the forward that
    # also writes the chunk states for the backward: y and h_last bit for
    # bit, the states within the scan's tolerance of the plain ones
    from repro_torch.kernels.selective_scan import _forward
    (y0, h0), (y1, h1, states) = _forward(*args), _forward(*args,
                                                           states=True)
    check(torch.equal(y0, y1) and torch.equal(h0, h1),
          "selective_scan with its states output differs from serving's")
    e_states, ok = within(states, ref.selective_scan_chunk_states_ref(*args),
                          SCAN_TOL["float32"], 0.05)
    check(ok, f"selective_scan's chunk states: max abs error {e_states}")
    print(f"selective_scan at {(B, S, Di, N)}: y and h_last with the "
          f"states output bit for bit those without it; the states' max "
          f"abs error {e_states}", flush=True)
    del y0, h0, y1, h1, states
    t = {"ssm": time_ms(lambda: selective_scan(*args)),
         "ssm_plain": time_ms(lambda: ref.selective_scan_ref(*args), reps=1,
                              windows=3, warmup=1)}
    y = torch.empty_like(args[0])
    h = torch.empty((B, Di, N), dtype=torch.float32, device=dev)
    t["ssm_turns"] = {}
    # both sides through their C functions on the same outputs (the
    # wrapper's allocations are not the kernel's)
    others = other_libraries(os.path.basename(SSM_SOURCE), compare_dirs,
                             "selective_scan")
    mine = other_libraries(os.path.basename(SSM_SOURCE), [HERE_CSRC],
                           "selective_scan")[HERE_CSRC] if others else None
    for where, old in others.items():
        def c_ssm(lib, where):
            def fn():
                status = lib.selective_scan_f32(
                    *(x.data_ptr() for x in args), y.data_ptr(),
                    h.data_ptr(), B, S, Di, N,
                    torch.cuda.current_stream().cuda_stream)
                check(status == 0,
                      f"selective_scan of {where} failed: {status}")
            return fn
        t["ssm_turns"][where] = in_turns(
            {"old": c_ssm(old, where), "new": c_ssm(mine, "this checkout")})
        print(f"selective_scan in turns against {where} (old, new, new, "
              f"old), ms: {t['ssm_turns'][where]}", flush=True)
    # xc, dt read and y written; Bc, Cc and A read; h_last written
    n_bytes = (3 * B * S * Di + 2 * B * S * N + Di * N + B * Di * N) * 4
    # per (b, t, d, n): dt A, dA h, (dt x) B, the add, h C and its sum;
    # per (b, t, d): dt x
    n_flops = B * S * Di * (6 * N + 1)
    n_exp = B * S * Di * N
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "flops": n_flops / FP32_FLOPS_PER_S * 1e3,
             "exponentials": n_exp / sfu_exp_per_s() * 1e3}
    term = max(terms, key=terms.get)
    print(f"selective_scan at {(B, S, Di, N)} f32: kernel {t['ssm']} ms, "
          f"plain {t['ssm_plain']} ms; bound terms {terms} ms: bounded by "
          f"{term}", flush=True)
    return {"err": err, "t": t, "terms": terms, "term": term,
            "bound": (terms[term], "bytes" if term == "bytes"
                      else "operations"), "states_err": e_states,
            "bytes": n_bytes, "flops": n_flops, "exponentials": n_exp}


def live_mamba_check(seen) -> float:
    """The kernel's output on the first MAMBA layer of the prefill against
    its plain version on the same inputs."""
    from repro_torch.kernels import ref
    args, _, out = seen["selective_scan"]
    want = ref.selective_scan_ref(*args)
    e = check_ssm("on the prefill's inputs", out, want, "float32")
    used = max(tolerance_used(g, w, SCAN_TOL["float32"], 0.05)
               for g, w in zip(out, want))
    print(f"selective_scan on the prefill's own inputs (first MAMBA layer, "
          f"xc {tuple(args[0].shape)}): max abs error {e} (share of the "
          f"tolerance used {used})", flush=True)
    return e


def serving_record(cfg, sv, cons) -> dict:
    res = sv["res"]
    return {"arch": cfg.name, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
            "gen": SERVE_GEN, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "decode_steps": len(res.decode_logits),
            "decode_tokens_per_s": res.decode_tokens_per_s,
            "peak_gib": sv["peak"], "consistency_max_abs_err": cons,
            "launches": sv["counts"]}


# --------------------------------------------------------------------- #
# serving the JAX package's seven other architectures (phase 7)
# --------------------------------------------------------------------- #
# (architecture, layers run): full width, depth cut only where the f32
# weights do not fit the card (qwen1.5-32b's 64 layers would be ~141 GB,
# chameleon-34b's 48 ~137 GB, one grok-1 MoE layer is ~19.7 GB and one
# deepseek-v2 MoE layer ~15.9 GB)
# the first five at half the depths they were once served at (gemma-7b,
# granite-3-8b and musicgen-large whole, qwen1.5-32b and chameleon-34b at
# 16 layers), to keep the script inside its time limit (a quarter put
# chameleon-34b's 4097-token check at 0.020151, past its 2e-2); grok-1 and
# deepseek-v2 at the depths one card holds
SERVED_ARCHS = (("gemma-7b", 14), ("granite-3-8b", 20),
                ("musicgen-large", 24), ("qwen1.5-32b", 8),
                ("chameleon-34b", 8), ("grok-1-314b", 2),
                ("deepseek-v2-236b", 3))


def arch_serving_phase(dev, smi_line: str) -> dict:
    """7. each architecture of `SERVED_ARCHS` through `serving_phase`
    (flash_attention once an attention layer in the prefill, none in
    decode), its first launch against the plain version, and the 4096 + 1
    consistency check (bounded for the dense and audio models, reported
    for the MoE ones with the assignments each phase dropped).  Each model
    is freed before the next is built."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.models import moe
    t_phase = time.perf_counter()
    records, counts = [], {}
    for arch, layers in SERVED_ARCHS:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        n_moe = sum(1 for i in range(cfg.num_layers)
                    if cfg.num_experts and i >= cfg.first_dense_layers)
        drops = []           # (dropped, assignments, capacity) a call
        dispatch = moe.dispatch

        def counted(xt, e_flat, E, cap, dispatch=dispatch, drops=drops):
            buf, slot, keep = dispatch(xt, e_flat, E, cap)
            drops.append(((~keep).sum(), keep.numel(), cap))
            return buf, slot, keep

        moe.dispatch = counted
        try:
            sv = serving_phase(cfg, dev, {"flash_attention": cfg.num_layers},
                               {"flash_attention": "attention"})
            live = live_lm_check(sv["seen"])
            sv["seen"].clear()
            torch.cuda.empty_cache()
            cons = consistency_check(sv["res"], bounded=not n_moe)
        finally:
            moe.dispatch = dispatch
        rec = serving_record(cfg, sv, cons)
        rec.update({"layers_run": cfg.num_layers,
                    "layers_of": full.num_layers,
                    "parameters": sv["parameters"],
                    "live_fa_max_abs_err": live["fa"],
                    "live_fa_tolerance_used": live["fa_tolerance_used"],
                    "device": smi_line})
        if n_moe:
            # calls in order: the prefill's n_moe, the decode steps', the
            # 4097-token prefill's n_moe
            seen = [(int(d), n, c) for d, n, c in drops]
            parts = {"prefill": seen[:n_moe],
                     "decode": seen[n_moe:-n_moe],
                     "prefill_4097": seen[-n_moe:]}
            check(len(parts["decode"]) == n_moe * (SERVE_GEN - 1),
                  f"{arch}: {len(seen)} MoE dispatches")
            rec["moe"] = {
                "layers": n_moe, "consistency_bounded": False,
                **{f"{k}_capacity": v[0][2] for k, v in parts.items()},
                **{f"{k}_dropped": sum(d for d, _, _ in v)
                   for k, v in parts.items()},
                **{f"{k}_assignments": sum(n for _, n, _ in v)
                   for k, v in parts.items()}}
            print(f"{arch} MoE routing (reported, not bounded): "
                  f"{json.dumps(rec['moe'])}", flush=True)
        print(f"served {arch} ({cfg.num_layers} of {full.num_layers} "
              f"layers, {sv['parameters']} f32 parameters) on {smi_line}: "
              f"prefill {rec['prefill_s']:.4f} s, decode "
              f"{rec['decode_tokens_per_s']:.2f} tokens/s, peak "
              f"{rec['peak_gib']:.3f} GiB", flush=True)
        counts[f"serving_{arch}"] = {
            k: sv["counts"]["prefill"][k] + sv["counts"]["decode"][k]
            for k in launches}
        records.append(rec)
        del sv
        gc.collect()
        free_library_memory()
    wall = time.perf_counter() - t_phase
    print(f"phase 7 (seven architectures served): {wall:.2f} s", flush=True)
    return {"records": records, "counts": counts, "phase_s": wall}


def rel_to_max(got, want) -> float:
    """max |got - want| over the largest |want|."""
    w = want.float()
    return ((got.float() - w).abs().max() / w.abs().max().clamp_min(1e-30)
            ).item()


def bwd_rel(got, want) -> float:
    """The worst of the attention gradients' errors, each over its largest
    entry.  With one position (S = 1) the softmax over its one key has no
    gradient: dq and dk are zero in exact arithmetic and both sides hold
    rounding of dP - D, so they are held to dv's largest entry instead."""
    if got[0].shape[1] > 1:
        return max(rel_to_max(a_, b_) for a_, b_ in zip(got, want))
    top = want[2].float().abs().max().clamp_min(1e-30)
    return max([rel_to_max(got[2], want[2])] + [
        ((a_.float() - b_.float()).abs().max() / top).item()
        for a_, b_ in zip(got[:2], want[:2])])


def bwd_check(cfg, dev) -> dict:
    """The forward's lse and both backward kernels against their plain
    versions at the training shape and at shapes that cross the kernels'
    partitions; two calls of each backward on the same inputs bit for bit
    equal.  -> the worst errors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    S = RECURRENT_TRAIN_SEQ
    H, Kv, d, window, W = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.window, cfg.lru_width)
    f32 = torch.float32
    err = {"out": 0.0, "lse": 0.0, "fa_bwd": 0.0, "scan_bwd": 0.0,
           "fa_bwd_abs": 0.0, "scan_bwd_abs": 0.0}
    # (B, S, H, Kv, d, dv, window, softcap): the training shape, then S
    # not a multiple of any tile, 4 query heads over 2 with softcap 30,
    # dv != d, d not a multiple of 16 bytes, a window shorter than a tile;
    # H / Kv = 10, 5 and 1 across the per-head partials and their sum;
    # S = 1, 31, 33 and 4097 across the tiles of 32; d = 48
    cases = [(1, S, H, Kv, d, d, window, 0.0),
             (1, 1000, 4, 2, 64, 64, 0, 30.0), (1, 77, 6, 2, 48, 40, 8, 0.0),
             (2, 100, 2, 2, 33, 33, 0, 0.0), (1, 300, H, Kv, d, d, 5, 50.0),
             (1, 1, H, Kv, d, d, window, 0.0), (1, 31, 5, 1, 48, 48, 0, 0.0),
             (2, 33, 10, 2, 64, 64, 16, 0.0), (1, 33, 3, 3, 48, 32, 0, 0.0),
             (1, S + 1, H, Kv, d, d, window, 0.0)]
    for i, (b, s_, h, kv, dd, dv, win, cap) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        q = torch.randn((b, s_, h, dd), generator=g, device=dev) * 0.3
        k = torch.randn((b, s_, kv, dd), generator=g, device=dev) * 0.3
        v = torch.randn((b, s_, kv, dv), generator=g, device=dev)
        do = torch.randn((b, s_, h, dv), generator=g, device=dev)
        out, lse = _forward(q, k, v, win, cap, True)
        served, _ = _forward(q, k, v, win, cap, False)
        check(torch.equal(out, served), f"flash_attention {cases[i]}: the "
              "output with an lse pointer differs from serving's (null)")
        ro, rl = ref.flash_attention_lse_ref(q, k, v, window=win,
                                             softcap=cap)
        e_o, ok_o = within(out, ro, FA_TOL["float32"], FA_TOL["float32"])
        e_l, ok_l = within(lse, rl, FA_TOL["float32"], FA_TOL["float32"])
        check(ok_o and ok_l, f"flash_attention {cases[i]} with lse: max abs "
              f"error {e_o} (out), {e_l} (lse) beyond {FA_TOL['float32']}")
        got = flash_attention_bwd(q, k, v, out, lse, do, window=win,
                                  softcap=cap)
        if i == 0:
            again = flash_attention_bwd(q, k, v, out, lse, do, window=win,
                                        softcap=cap)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"flash_attention_bwd {cases[i]}: two calls differ")
            del again
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                           window=win, softcap=cap)
        r = bwd_rel(got, want)
        check(r <= BWD_TOL, f"flash_attention_bwd {cases[i]}: error {r} of "
              f"the largest entry, beyond {BWD_TOL}")
        err["out"], err["lse"] = max(err["out"], e_o), max(err["lse"], e_l)
        err["fa_bwd"] = max(err["fa_bwd"], r)
        err["fa_bwd_abs"] = max([err["fa_bwd_abs"]] + [
            (a_ - b_).abs().max().item() for a_, b_ in zip(got, want)])
        del q, k, v, do, out, lse, served, ro, rl, got, want
    # (B, S, W, range of a): the training shape, ragged, S = 1, S not a
    # multiple of the 128-step tile, W not a multiple of the channels a
    # block (and not of 4: plain loads)
    scan_cases = [(1, S, W, (0.9, 0.9999)), (2, 97, W + 1, None),
                  (1, 5, 3, None), (3, 33, 64, None), (2, 1, W, None),
                  (1, 129, W + 4, None), (1, S + 1, W + 8, (0.9, 0.9999))]
    for i, (b, s_, w, a_range) in enumerate(scan_cases):
        a, bx = scan_inputs(b, s_, w, f32, dev, 500 + i, a_range)
        g = torch.Generator(device=dev).manual_seed(600 + i)
        dhs = torch.randn((b, s_, w), generator=g, device=dev)
        dh = torch.randn((b, w), generator=g, device=dev)
        hs, _ = ref.rglru_scan_ref(a, bx)
        got = rglru_scan_bwd(a, hs, dhs, dh)
        if i == 0:
            again = rglru_scan_bwd(a, hs, dhs, dh)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"rglru_scan_bwd {scan_cases[i]}: two calls differ")
        want = ref.rglru_scan_bwd_ref(a, hs, dhs, dh)
        r = max(rel_to_max(a_, b_) for a_, b_ in zip(got, want))
        ok = all(within(a_, b_, SCAN_TOL["float32"], 0.05)[1]
                 for a_, b_ in zip(got, want))
        check(r <= BWD_TOL and ok, f"rglru_scan_bwd {scan_cases[i]}: error "
              f"{r} of the largest entry (bound {BWD_TOL}), within atol "
              f"{SCAN_TOL['float32']} rtol 0.05: {ok}")
        err["scan_bwd"] = max(err["scan_bwd"], r)
        err["scan_bwd_abs"] = max([err["scan_bwd_abs"]] + [
            (a_ - b_).abs().max().item() for a_, b_ in zip(got, want)])
    torch.cuda.synchronize()
    print(f"training kernels against their plain versions: {json.dumps(err)}"
          f" ({len(cases)} attention shapes, out and lse atol = rtol "
          f"{FA_TOL['float32']}, the backwards {BWD_TOL} of the largest "
          f"entry; {len(scan_cases)} scan shapes, also atol "
          f"{SCAN_TOL['float32']} rtol 0.05); the forward with an lse "
          "pointer bit for bit serving's; two calls of each backward bit "
          "for bit equal", flush=True)
    return err


def bwd_turns(cfg, dev, dirs) -> dict:
    """Each DIR's ``flash_attention_bwd.cu`` and ``rglru_scan_bwd.cu``
    (the same C interfaces) against this checkout's at the training shape,
    and the attention's bfloat16 instance at phase 13's microbatch of 2
    (``flash_attention_bwd.cu@bfloat16``), in turns (old, new, new, old),
    warm and cold (L2 flushed): {source: {dir: {"warm": {"old": [...],
    "new": [...]}, "cold": ..., "max_rel_diff": x, "bit_for_bit": b}}},
    ms.  Both sides call their C function on the same preallocated
    outputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     bwd_scratch_floats)
    sources = ((FA_BWD_SOURCE, "flash_attention"),
               (SCAN_BWD_SOURCE, "rglru_scan"))
    others = {os.path.basename(src): other_libraries(
        os.path.basename(src), dirs, module, "_bwd_signatures")
        for src, module in sources}
    if not any(others.values()):
        return {name: {} for name in others}
    S = RECURRENT_TRAIN_SEQ
    H, Kv, d, window, W = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.window, cfg.lru_width)
    flush = L2Flush(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(97)
    q = torch.randn((1, S, H, d), generator=g, device=dev) * 0.3
    k = torch.randn((1, S, Kv, d), generator=g, device=dev) * 0.3
    v = torch.randn((1, S, Kv, d), generator=g, device=dev)
    do = torch.randn((1, S, H, d), generator=g, device=dev)
    out, lse = _forward(q, k, v, window, 0.0, True)
    scratch = torch.empty((bwd_scratch_floats(1, S, H, Kv, d, d),),
                          device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    a, bx = scan_inputs(1, S, W, torch.float32, dev, 96, (0.9, 0.9999))
    hs, _ = ref.rglru_scan_ref(a, bx)
    dhs = torch.randn((1, S, W), generator=g, device=dev)
    dh = torch.randn((1, W), generator=g, device=dev)
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    # the bfloat16 instance at phase 13's microbatch of 2
    bf = (*attn_inputs(2, S, H, Kv, d, torch.bfloat16, dev, 131),
          torch.randn((2, S, H, d), generator=g, device=dev)
          .to(torch.bfloat16))
    bf = (*bf[:3], *_forward(*bf[:3], window, 0.0, True), bf[3],
          torch.empty((bwd_scratch_floats(2, S, H, Kv, d, d),), device=dev))
    dbf = tuple(torch.empty_like(x) for x in bf[:3])

    def fa_call(where, lib, bf16=False):
        qq, kk, vv, oo, ll, dd, sc = (bf if bf16 else
                                      (q, k, v, out, lse, do, scratch))
        grads = dbf if bf16 else (dq, dk, dv)
        fn = lib.fa_backward_bf16 if bf16 else lib.fa_backward_f32

        def call():
            status = fn(
                qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), oo.data_ptr(),
                dd.data_ptr(), ll.data_ptr(), sc.data_ptr(),
                *(x.data_ptr() for x in grads), qq.shape[0], S, H, Kv, d,
                d, d ** -0.5, window, 0.0, stream())
            check(status == 0, f"flash_attention_bwd of {where}: {status}")
        return call

    def scan_call(where, lib):
        def call():
            status = lib.rglru_scan_bwd_f32(
                a.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dh.data_ptr(),
                da.data_ptr(), dbx.data_ptr(), 1, S, W, stream())
            check(status == 0, f"rglru_scan_bwd of {where}: {status}")
        return call

    fa_bf16 = lambda where, lib: fa_call(where, lib, bf16=True)
    fa_kw = {"reps": 3, "windows": 3, "warmup": 1}
    out_t = {}
    for (src, module), key, make, outs, kw in zip(
            sources + sources[:1],
            ("flash_attention_bwd.cu", "rglru_scan_bwd.cu",
             "flash_attention_bwd.cu@bfloat16"),
            (fa_call, scan_call, fa_bf16),
            ((dq, dk, dv), (da, dbx), dbf), (fa_kw, {"reps": 10}, fa_kw)):
        name = os.path.basename(src)
        out_t[key] = {}
        if not others[name]:
            continue
        mine = other_libraries(name, [HERE_CSRC], module,
                               "_bwd_signatures")[HERE_CSRC]
        for where, old in others[name].items():
            fns = {"old": make(where, old), "new": make("this checkout", mine)}
            for x in outs:             # what the other version leaves
                x.fill_(float("nan"))  # unwritten shows as NaN
            fns["old"]()
            got_old = [x.clone() for x in outs]
            fns["new"]()
            # how far the other version's outputs are from this checkout's,
            # over each one's largest entry (a timing-only variant may
            # differ; NaN where it wrote nothing)
            diff = [rel_to_max(a_, b_) for a_, b_ in zip(got_old, outs)]
            same = all(torch.equal(a_, b_) for a_, b_ in zip(got_old, outs))
            out_t[key][where] = {
                "warm": in_turns(fns, graph=name.startswith("rglru"), **kw),
                "cold": in_turns(fns, flush=flush, **kw),
                "max_rel_diff": torch.tensor(diff).max().item(),
                "bit_for_bit": same}
            print(f"{key} in turns against {where} (old, new, new, old), "
                  f"ms: {json.dumps(out_t[key][where])}", flush=True)
    return out_t


def train_kernel_phase(cfg, dev, compare_dirs=()) -> dict:
    """The forward's lse and both backward kernels against their plain
    versions at the training shape and ragged ones; times at the training
    shape, and in turns with each of ``compare_dirs``' backward
    sources."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    S = RECURRENT_TRAIN_SEQ
    H, Kv, d, window, W = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.window, cfg.lru_width)
    f32 = torch.float32
    err = bwd_check(cfg, dev)
    turns = bwd_turns(cfg, dev, compare_dirs)

    # times at the training shape, cold (L2 flushed) and warm
    flush = L2Flush(dev)
    g = torch.Generator(device=dev).manual_seed(99)
    q = torch.randn((1, S, H, d), generator=g, device=dev) * 0.3
    k = torch.randn((1, S, Kv, d), generator=g, device=dev) * 0.3
    v = torch.randn((1, S, Kv, d), generator=g, device=dev)
    do = torch.randn((1, S, H, d), generator=g, device=dev)
    out, lse = _forward(q, k, v, window, 0.0, True)
    bwd = lambda: flash_attention_bwd(q, k, v, out, lse, do, window=window)
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    qh, kh, vh = (x.transpose(1, 2).repeat_interleave(H // x.shape[2], 1)
                  .contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib = lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                      retain_graph=True)
    t = {"fa_bwd": time_ms(bwd, reps=3, windows=5, warmup=1),
         "fa_bwd_cold": statistics.median(window_times(
             bwd, reps=3, windows=3, warmup=1, flush=flush)),
         "fa_bwd_plain": time_ms(lambda: ref.flash_attention_bwd_ref(
             q, k, v, out, lse, do, window=window), reps=1, windows=3,
             warmup=1),
         "fa_bwd_lib": time_ms(lib, reps=3, windows=5, warmup=1),
         "fa_lse": time_ms(lambda: _forward(q, k, v, window, 0.0, True),
                           reps=3, windows=5, warmup=1),
         "fa_null": time_ms(lambda: _forward(q, k, v, window, 0.0, False),
                            reps=3, windows=5, warmup=1)}
    del lib_out, qh, kh, vh, doh
    a, bx = scan_inputs(1, S, W, f32, dev, 98, (0.9, 0.9999))
    hs, _ = ref.rglru_scan_ref(a, bx)
    dhs = torch.randn((1, S, W), generator=g, device=dev)
    dh = torch.randn((1, W), generator=g, device=dev)
    sbwd = lambda: rglru_scan_bwd(a, hs, dhs, dh)
    t.update({
        "scan_bwd": time_ms(sbwd),
        "scan_bwd_cold": statistics.median(window_times(
            sbwd, reps=10, windows=5, warmup=2, flush=flush)),
        "scan_bwd_plain": time_ms(lambda: ref.rglru_scan_bwd_ref(
            a, hs, dhs, dh), reps=1, windows=3, warmup=1),
        # dhs + a * hs: three of the five arrays' bytes, not the function
        "scan_bwd_same_bytes": time_ms(lambda: torch.addcmul(dhs, a, hs))})
    pairs = reachable_pairs(1, S, H, window)
    flops = pairs * 2 * (3 * d + 2 * d)
    b_fa = (1 * S * H * d * 4 + 1 * S * Kv * d * 4 + 1 * H * S) * 4
    fa_routes = {"cuda cores": bound_ms(b_fa, flops),
                 "tensor cores, 3xTF32": bound_ms(b_fa, 3 * flops,
                                                  TF32_FLOPS_PER_S)}
    fa_route = min(fa_routes, key=lambda r_: fa_routes[r_][0])
    b_scan = 20 * S * W + 4 * W
    print(f"flash_attention_bwd at (1, {S}, {H}, {Kv}, {d}) window "
          f"{window}: warm {t['fa_bwd']} ms, cold {t['fa_bwd_cold']} ms, "
          f"plain {t['fa_bwd_plain']} ms, SDPA's backward {t['fa_bwd_lib']}"
          f" ms; bound by route {fa_routes} ms; forward with lse "
          f"{t['fa_lse']} ms, without {t['fa_null']} ms; rglru_scan_bwd at "
          f"(1, {S}, {W}): warm {t['scan_bwd']} ms, cold "
          f"{t['scan_bwd_cold']} ms, plain {t['scan_bwd_plain']} ms, "
          f"addcmul {t['scan_bwd_same_bytes']} ms, bound "
          f"{bound_ms(b_scan, 3 * S * W)}", flush=True)
    return {"err": err, "t": t, "turns": turns, "pairs": pairs,
            "flops": flops,
            "bound": {"fa_bwd": fa_routes[fa_route],
                      "scan_bwd": bound_ms(b_scan, 3 * S * W)},
            "fa_routes": fa_routes, "fa_route": fa_route,
            "bytes": {"fa_bwd": b_fa, "scan_bwd": b_scan}}


class _PlainAttention(torch.autograd.Function):
    """The plain attention forward and its plain backward, on the card."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap):
        out, lse = plain_lse(q, k, v, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*plain_bwd(*ctx.saved_tensors, dout, window=ctx.window,
                           softcap=ctx.softcap), None, None)


class _PlainScan(torch.autograd.Function):
    """The plain RG-LRU scan and its plain backward, on the card."""

    @staticmethod
    def forward(ctx, a, bx):
        from repro_torch.kernels import ref
        hs, h_last = ref.rglru_scan_ref(a, bx)
        ctx.save_for_backward(a, hs)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        from repro_torch.kernels import ref
        a, hs = ctx.saved_tensors
        return ref.rglru_scan_bwd_ref(a, hs, dhs, dh_last)


class _PlainSSM(torch.autograd.Function):
    """The plain selective scan and its plain backward, on the card."""

    @staticmethod
    def forward(ctx, xc, dt, Bc, Cc, A):
        from repro_torch.kernels import ref
        ctx.save_for_backward(xc, dt, Bc, Cc, A)
        return ref.selective_scan_ref(xc, dt, Bc, Cc, A)

    @staticmethod
    def backward(ctx, dy, dh_last):
        from repro_torch.kernels import ref
        return ref.selective_scan_bwd_ref(*ctx.saved_tensors, dy, dh_last)


def live_train_check(eng, batch, tol: float = LIVE_GRAD_TOL) -> dict:
    """Client (0, 0)'s (mode B: cluster 0's) gradients on the first
    microbatch of the last round's batch, through the kernels and then
    through the plain versions: `live_grads`."""
    from repro_torch.core import fl_step
    lead = (0,) * fl_step.lead_dims(eng.task.mode)
    params = {k: v[lead] for k, v in eng.state.params.items()}
    mb = {k: v[lead + (0,)] for k, v in batch.items()}
    return live_grads(eng.task.cfg, eng.task.mode, params, mb, tol)


def live_grads(cfg, mode: str, params, mb, tol: float = LIVE_GRAD_TOL
               ) -> dict:
    """The gradients of one client's loss (its mode's: the trust-weighted
    loss in mode B) on one microbatch, through the kernels and then through
    the plain versions (forward and backward), each parameter's within
    ``tol`` of its largest entry and the loss within LIVE_LOSS_TOL.  An
    MoE model's plain pass replays the kernel pass's routing through
    `moe_forward`'s ``routing`` keyword, so that both differentiate one
    dispatch; the assignments its own router would have routed otherwise
    are counted.  Its kernel pass runs twice, the gradients bit for bit
    equal (the MoE gather's backward adds only exact zeros onto the
    dropped assignments' slot)."""
    from repro_torch.core import fl_step
    from repro_torch.kernels import ops
    from repro_torch.models import LM, lm_loss, weighted_lm_loss, xent
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    model = LM(cfg, device="meta", seed=None)
    params = {k: v.detach().requires_grad_() for k, v in params.items()}

    def grads():
        if mode == fl_step.MODE_B:
            loss = weighted_lm_loss(model, mb, mb["weights"], params=params,
                                    remat=True)
        else:
            loss = lm_loss(model, mb, params=params, remat=True)
        return (float(loss.detach()),
                torch.autograd.grad(loss, list(params.values())))

    # the kernel pass records each MoE call's routing (the checkpoint's
    # recompute routes again: every layer twice, in the backward's order)
    routes, replay, moved = [], [], {"assignments": 0, "moved": 0}
    inner = tr.moe_forward

    def recording(p, cfg_, x, **kw):
        r = moe_mod.route(p, cfg_, x.reshape(-1, x.shape[-1]))[2]
        routes.append(r)
        return inner(p, cfg_, x, routing=r)

    def replaying(p, cfg_, x, **kw):
        given = replay.pop(0)
        own = moe_mod.route(p, cfg_, x.reshape(-1, x.shape[-1]))[2]
        hot = lambda r: torch.zeros((r.shape[0], cfg_.num_experts),
                                    device=r.device).scatter_(1, r, 1.0)
        moved["moved"] += int((hot(own) - hot(given)).clamp_min(0).sum())
        moved["assignments"] += given.numel()
        return inner(p, cfg_, x, routing=given)

    moe = bool(cfg.num_experts)
    tr.moe_forward = recording if moe else inner
    try:
        l_k, g_k = grads()
    finally:
        tr.moe_forward = inner
    same = None
    if moe:
        l_2, g_2 = grads()
        differ = [k for k, a_, b_ in zip(params, g_k, g_2)
                  if not torch.equal(a_, b_)]
        same = not differ and l_2 == l_k
        check(same, f"live: two kernel passes' gradients differ at "
              f"{differ[:5]} ({len(differ)} parameters), losses {l_k}, "
              f"{l_2}")
        del g_2
    # where a microbatch's time goes: the whole loss and gradient, against
    # the unembedding and cross-entropy alone on the same shapes
    tok = mb["tokens"]
    x = torch.randn(tok.shape[:1] + tok.shape[-1:] + (cfg.d_model,),
                    device=tok.device, requires_grad=True)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]

    def head_grads():
        return torch.autograd.grad(
            xent(model.unembed(x, params), mb["labels"]), (x, head))
    split = {"microbatch_ms": time_ms(grads, reps=1, windows=3, warmup=1),
             "unembed_xent_ms": time_ms(head_grads, reps=1, windows=3,
                                        warmup=1)}
    split["unembed_share"] = split["unembed_xent_ms"] / split["microbatch_ms"]
    del x
    print(f"a microbatch's loss and gradient (remat): {json.dumps(split)}",
          flush=True)
    saved = ops.attention, ops.lru_scan, ops.mamba_scan
    ops.attention = lambda q, k, v, *, window=0, softcap=0.0: \
        _PlainAttention.apply(q, k, v, window, softcap)
    ops.lru_scan = lambda a, bx: _PlainScan.apply(a, bx)
    ops.mamba_scan = lambda xc, dt, Bc, Cc, A: _PlainSSM.apply(
        xc, dt, Bc, Cc, A)
    replay[:] = routes
    tr.moe_forward = replaying if moe else inner
    try:
        l_p, g_p = grads()
    finally:
        ops.attention, ops.lru_scan, ops.mamba_scan = saved
        tr.moe_forward = inner
    check(not replay, f"live: {len(replay)} recorded routings not replayed")
    rel = {k: rel_to_max(a_, b_) for k, a_, b_ in zip(params, g_k, g_p)}
    worst = max(rel, key=rel.get)
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    print(f"live: client 0's gradients on the last round's microbatch "
          f"through the kernels against the plain versions: loss {l_k} "
          f"against {l_p}; the worst parameters, error over their largest "
          f"entry: {top} (tolerance {tol}), median "
          f"{statistics.median(rel.values())}"
          + (f"; the plain pass replayed the kernel pass's routing "
             f"({len(routes)} MoE calls), its own router would have moved "
             f"{moved['moved']} of {moved['assignments']} assignments; two "
             f"kernel passes bit for bit equal" if moe else ""), flush=True)
    check(abs(l_k - l_p) <= LIVE_LOSS_TOL * abs(l_p),
          f"live loss {l_k} against {l_p}")
    check(rel[worst] <= tol,
          f"live gradients: {worst} off by {rel[worst]} of its largest "
          f"entry")
    out = {"loss_kernels": l_k, "loss_plain": l_p,
           "max_rel_err": rel[worst], "worst": worst,
           "median_rel_err": statistics.median(rel.values()),
           "tolerance": tol, "time_split": split}
    if moe:
        out.update({"moe_calls": len(routes),
                    "routing_moved": moved["moved"],
                    "routing_assignments": moved["assignments"],
                    "two_passes_bit_equal": same})
    return out


def expected_train_launches(cfg, records, clients: int, n_micro: int
                            ) -> dict:
    """Each training kernel's launches over ``records``: clients x a x
    microbatches x layers of its kind, the forward twice (the per-layer
    checkpoint recomputes it in the backward)."""
    from repro_torch.models import LOCAL, MAMBA, RGLRU, ATTN
    kinds = cfg.layer_kinds()
    n_attn = sum(k in (ATTN, LOCAL) for k in kinds)
    n_lru = sum(k == RGLRU for k in kinds)
    n_ssm = sum(k == MAMBA for k in kinds)
    micro = sum(r.a for r in records) * clients * n_micro
    return {"flash_attention": 2 * micro * n_attn,
            "flash_attention_bwd": micro * n_attn,
            "rglru_scan": 2 * micro * n_lru,
            "rglru_scan_bwd": micro * n_lru,
            "selective_scan": 2 * micro * n_ssm,
            "selective_scan_bwd": micro * n_ssm}


def train_run(spec, rounds: int, what: str, keep_batch: bool = False,
              must_fall: bool = False) -> dict:
    """``Federation.from_spec(spec).run(max_rounds=rounds)`` with the
    launch counts set to 0 before the run and read after; with
    ``must_fall`` the last round's mean loss must be below the first's.
    The forwards that write the selective scan's chunk states must be as
    many as its backwards (under each layer's checkpoint only the
    recompute writes them).  A round's seconds run from its batch's draw
    to the next's (each round ends reading its loss on the host).  An MoE
    model's dropped assignments are counted a round (`moe_drops`)."""
    from repro_torch.api import Federation
    from repro_torch.core import fl_step
    from repro_torch.kernels import launches, reset_launches, state_launches
    from repro_torch.models import transformer as tr
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = Federation.from_spec(spec)
    eng = fed.engine
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    kept, marks = [], []
    make = eng.task.make_batch

    drops = []                  # each round's [dropped, assignments]

    def marking(*a, **kw):
        marks.append(time.perf_counter())
        drops.append([0, 0])
        batch = make(*a, **kw)
        if keep_batch:
            kept[:] = [batch]
        return batch
    eng.task.make_batch = marking
    inner = tr.moe_forward
    if eng.task.cfg.num_experts:
        tr.moe_forward = moe_drops(inner, drops)
    reset_launches()
    state_launches["selective_scan"] = 0
    t0 = time.perf_counter()
    try:
        trace = fed.run(max_rounds=rounds)
    finally:
        tr.moe_forward = inner
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    t_run = t_end - t0
    each = [b_ - a_ for a_, b_ in zip(marks, marks[1:] + [t_end])]
    counts = dict(launches)
    with_states = state_launches["selective_scan"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = trace.records
    mode_a = eng.task.mode == fl_step.MODE_A
    clients = eng.n_clusters * (eng.clients if mode_a else 1)
    expect = expected_train_launches(eng.task.cfg, recs, clients,
                                     eng.task.n_micro)
    losses = [r.loss for r in recs]
    n_params = sum(v[(0,) * fl_step.lead_dims(eng.task.mode)].numel()
                   for v in eng.state.params.values())
    print(f"training {what}: {n_params} parameters a client, "
          f"{eng.n_clusters} clusters x {clients // eng.n_clusters} "
          f"clients, seq {eng.task.seq}, {eng.task.n_micro} microbatches of "
          f"{eng.task.micro_batch}: init {t_init:.2f} s, {len(recs)} rounds "
          f"in {t_run:.2f} s ({t_run / max(len(recs), 1):.3f} s a round; "
          f"each {each}), "
          f"a {[r.a for r in recs]}, losses {losses}, peak device memory "
          f"{peak:.3f} GiB; launches {json.dumps(counts)}, "
          f"{with_states} selective_scan writing chunk states", flush=True)
    check(len(recs) == rounds, f"{what}: {len(recs)} records of {rounds}")
    check(all(counts[k] == expect.get(k, 0) for k in counts),
          f"{what}: launched {counts}, the schedule implies {expect}")
    check(with_states == expect["selective_scan_bwd"],
          f"{what}: {with_states} selective_scan launches wrote chunk "
          f"states, {expect['selective_scan_bwd']} backwards read them")
    check(all(math.isfinite(v) for v in losses), f"{what}: losses {losses}")
    check(not must_fall or losses[-1] < losses[0],
          f"{what}: the loss did not fall: {losses}")
    off = [k for k, v in eng.state.params.items() if v.device.type != "cuda"]
    off += [k for k, v in eng.state.opt["m"].items()
            if v.device.type != "cuda"]
    check(not off and eng.state.opt["t"].device.type == "cuda",
          f"{what}: state off the card: {off}")
    return {"fed": fed, "eng": eng, "batch": kept[0] if kept else None,
            "record": {"rounds": len(recs), "init_s": t_init,
                       "run_s": t_run, "round_s": t_run / len(recs),
                       "round_s_each": each,
                       "a": [r.a for r in recs], "losses": losses,
                       "peak_gib": peak, "launches": counts,
                       "state_launches": with_states,
                       "params_a_client": n_params,
                       **({"moe_dropped_a_round": [
                           [int(n) // 2, m // 2] for n, m in drops]}
                          if eng.task.cfg.num_experts else {})}}


def moe_drops(inner, drops: list):
    """`moe_forward` counting into ``drops[-1]`` the assignments past their
    expert's capacity and all assignments, of every call: the first passes
    and the checkpoint's recomputes, which route the same tokens alike, so
    each count is twice a round's (an expert keeps its first ``cap``
    assignments: it drops max(0, n_e - cap))."""
    from repro_torch.models import moe as moe_mod

    def counting(p, cfg, x, **kw):
        T = x.shape[0] * x.shape[1]
        idx = moe_mod.route(p, cfg, x.reshape(T, -1))[2]
        n_e = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        cap = moe_mod.capacity(T, cfg)
        drops[-1][0] += (n_e - cap).clamp_min(0).sum()   # no host sync
        drops[-1][1] += idx.numel()
        return inner(p, cfg, x, **kw)
    return counting


def train_phase(dev) -> dict:
    """Mode A (three rounds) and mode B (one round) of the federated LM
    step at recurrentgemma-2b's full width and the live gradient check
    (its training CLI runs in phase 9b)."""
    from repro_torch.api import FederationSpec
    from repro_torch.api.scenarios import RECURRENTGEMMA_2B_TRAIN
    spec = FederationSpec.from_dict(RECURRENTGEMMA_2B_TRAIN)
    t0 = time.perf_counter()
    a = train_run(spec, TRAIN_ROUNDS_A, "mode A (fedavg_replica)",
                  keep_batch=True, must_fall=True)
    live = live_train_check(a["eng"], a["batch"])
    rec_a = a["record"]
    del a
    spec_b = FederationSpec.from_dict({
        **RECURRENTGEMMA_2B_TRAIN, "rounds": TRAIN_ROUNDS_B,
        "task": {"kind": "lm", "params": {
            **RECURRENTGEMMA_2B_TRAIN["task"]["params"],
            "mode": "trust_fsdp"}}})
    b = train_run(spec_b, TRAIN_ROUNDS_B, "mode B (trust_fsdp)")
    rec_b = b["record"]
    del b
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"phase 8 (training) took {wall:.2f} s", flush=True)
    return {"mode_a": rec_a, "mode_b": rec_b, "live": live,
            "phase_s": wall}


# --------------------------------------------------------------------- #
# training: falcon-mamba-7b
# --------------------------------------------------------------------- #
def ssm_bwd_inputs(B, S, Di, N, dev, seed, dt_scale=1.0):
    """`ssm_inputs`' draws in float32 with dt scaled by ``dt_scale``, then
    dy (B, S, Di) and d h_last (B, Di, N)."""
    xc, dt, Bc, Cc, A = ssm_inputs(B, S, Di, N, torch.float32, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    dy = torch.randn((B, S, Di), generator=g, device=dev)
    dh = torch.randn((B, Di, N), generator=g, device=dev)
    return [xc, dt * dt_scale, Bc, Cc, A], dy, dh


SSM_GRADS = ("dxc", "ddt", "dBc", "dCc", "dA")


def ssm_bwd_turns(cfg, dev, dirs) -> dict:
    """Each DIR's ``selective_scan_bwd.cu`` against this checkout's at the
    training shape, in turns (old, new, ..., new, old), warm and cold:
    {dir: {"warm": {"old": [...], ...}, "cold": ..., "max_rel_diff": x}},
    ms.  Each side is the backward given the forward's chunk states, its C
    function called on the same preallocated outputs and scratch."""
    from repro_torch.kernels.selective_scan import (_forward,
                                                    bwd_scratch_floats)
    name = os.path.basename(SSM_BWD_SOURCE)
    others = other_libraries(name, dirs, "selective_scan", "_bwd_signatures")
    if not others:
        return {}
    mine = other_libraries(name, [HERE_CSRC], "selective_scan",
                           "_bwd_signatures")[HERE_CSRC]
    S, Di, N = RECURRENT_TRAIN_SEQ, cfg.d_inner, cfg.ssm_state
    args, dy, _ = ssm_bwd_inputs(1, S, Di, N, dev, 96)
    outs = [torch.empty_like(t) for t in args]
    scratch = torch.empty((2 * bwd_scratch_floats(1, S, Di, N),),
                          device=dev)
    states = _forward(*args, states=True)[2]
    flush = L2Flush(dev)
    ptrs = lambda ts: [t.data_ptr() for t in ts]

    def call(where, lib):
        def fn():
            status = lib.selective_scan_bwd_states_f32(
                *ptrs(args), dy.data_ptr(), None, states.data_ptr(),
                *ptrs(outs), scratch.data_ptr(), 1, S, Di, N,
                torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"selective_scan_bwd of {where}: {status}")
        return fn

    out_t = {}
    for where, old in others.items():
        fns = {"old": call(where, old), "new": call("this checkout", mine)}
        for x in outs:              # what the other version leaves unwritten
            x.fill_(float("nan"))   # shows as NaN
        fns["old"]()
        got_old = [x.clone() for x in outs]
        fns["new"]()
        diff = [rel_to_max(a_, b_) for a_, b_ in zip(got_old, outs)]
        out_t[where] = {"warm": in_turns(fns, reps=10),
                        "cold": in_turns(fns, flush=flush, reps=5),
                        "max_rel_diff": torch.tensor(diff).max().item()}
        print(f"{name} in turns against {where} (each in order, then in "
              f"reverse), ms: {json.dumps(out_t[where])}", flush=True)
    return out_t


def ssm_bwd_phase(cfg, dev, compare_dirs=()) -> dict:
    """The selective-scan backward kernel against its plain version at the
    training shape and at ragged ones (every gradient within BWD_TOL of
    its largest entry), two calls bit for bit equal; its times at the
    training shape, warm and cold, given the forward's chunk states and
    with the forward writing them, beside its bound, its warps resident an
    SM, the plain version and an ``addcmul``
    over its largest arrays; the forward at B = 1 with and without its
    states output in turns; and in turns with each of ``compare_dirs``'
    ``selective_scan_bwd.cu``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.launch import typed_library
    from repro_torch.kernels.selective_scan import (BWD_SOURCE, SOURCE,
                                                    _bwd_signatures,
                                                    _forward, _signatures,
                                                    bwd_channels,
                                                    selective_scan_bwd)
    S, Di, N = RECURRENT_TRAIN_SEQ, cfg.d_inner, cfg.ssm_state
    # (B, S, Di, N, dt scale, d h_last: None, "zero" or "random"): the
    # training shape as training calls it (no d h_last) and with one; S = 1,
    # 31, 33 and 4097 across the 32-step chunks; Di not a multiple of the
    # 64 channels a block (8193 and 100 also not of 16 bytes: plain
    # loads); N = 4, 16, 17, 32 and 64 (one, two and four lanes a
    # channel); B = 2 and 3; a dt large enough that exp(dt A) underflows
    cases = [(1, S, Di, N, 1.0, None), (1, S, Di, N, 1.0, "random"),
             (1, 1, Di, N, 1.0, "random"), (2, 31, 130, N, 1.0, "zero"),
             (3, 33, 100, 4, 1.0, "random"), (1, S + 1, 100, N, 1.0, "random"),
             (1, 300, Di + 1, N, 1.0, "random"), (2, 97, 72, 64, 1.0, None),
             (1, 65, 96, 32, 1.0, "random"), (2, 50, 200, N, 300.0, "random"),
             (1, 40, 64, 17, 1.0, "zero")]
    err = {k: 0.0 for k in SSM_GRADS}
    abs_err = 0.0
    for i, (b, s_, d, n, scale, dh_kind) in enumerate(cases):
        args, dy, dh = ssm_bwd_inputs(b, s_, d, n, dev, 700 + i, scale)
        dh = {None: None, "zero": torch.zeros_like(dh), "random": dh}[dh_kind]
        if scale > 1.0:
            check(float(torch.exp(args[1][..., None] * args[4]).min()) == 0,
                  f"selective_scan_bwd {cases[i]}: no decay underflows")
        got = selective_scan_bwd(*args, dy, dh)
        if i < 2:
            again = selective_scan_bwd(*args, dy, dh)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"selective_scan_bwd {cases[i]}: two calls differ")
            del again
        want = ref.selective_scan_bwd_ref(*args, dy, dh)
        rel = {k: rel_to_max(g_, w_) for k, g_, w_ in zip(SSM_GRADS, got,
                                                          want)}
        check(max(rel.values()) <= BWD_TOL, f"selective_scan_bwd "
              f"{cases[i]}: errors {rel} of the largest entries, beyond "
              f"{BWD_TOL}")
        err = {k: max(err[k], rel[k]) for k in err}
        abs_err = max([abs_err] + [(g_ - w_).abs().max().item()
                                   for g_, w_ in zip(got, want)])
        del args, dy, dh, got, want
    torch.cuda.synchronize()
    print(f"selective_scan_bwd against its plain version, {len(cases)} "
          f"shapes: worst error over each gradient's largest entry "
          f"{json.dumps(err)} (tolerance {BWD_TOL}), max abs {abs_err}; two "
          "calls bit for bit equal", flush=True)
    turns = ssm_bwd_turns(cfg, dev, compare_dirs)

    # the backward given the forward's chunk states (as training calls
    # it), without them (the forward writing them first), and the forward
    # at B = 1 with and without its states output, warm and cold
    flush = L2Flush(dev)
    args, dy, _ = ssm_bwd_inputs(1, S, Di, N, dev, 98)
    states = _forward(*args, states=True)[2]
    bwd = lambda: selective_scan_bwd(*args, dy, None, states)
    bwd_fwd = lambda: selective_scan_bwd(*args, dy)
    # the forward's C functions on preallocated outputs, without the
    # wrapper's allocations: serving's and the one that writes the states
    y_, h_ = torch.empty_like(args[0]), torch.empty((1, Di, N), device=dev)
    st_ = torch.empty_like(states)

    def c_fwd(lib, with_states, where):
        def fn():
            ptrs = [x.data_ptr() for x in args] + [y_.data_ptr(),
                                                    h_.data_ptr()]
            stream = torch.cuda.current_stream().cuda_stream
            status = (lib.selective_scan_states_f32(
                *ptrs, st_.data_ptr(), 1, S, Di, N, stream) if with_states
                else lib.selective_scan_f32(*ptrs, 1, S, Di, N, stream))
            check(status == 0, f"selective_scan of {where} failed: {status}")
        return fn
    fwd_lib = typed_library(SOURCE, _signatures)
    fwd_turns = {"without_states": c_fwd(fwd_lib, False, "this checkout"),
                 "with_states": c_fwd(fwd_lib, True, "this checkout")}
    cold = lambda fn: statistics.median(window_times(
        fn, reps=5, windows=5, warmup=1, flush=flush))
    xc, dt = args[0], args[1]
    t = {"ssm_bwd": time_ms(bwd, reps=10, windows=5, warmup=2),
         "ssm_bwd_cold": cold(bwd),
         "ssm_bwd_with_forward": time_ms(bwd_fwd, reps=10, windows=5,
                                         warmup=2),
         "ssm_bwd_with_forward_cold": cold(bwd_fwd),
         "ssm_bwd_plain": time_ms(lambda: ref.selective_scan_bwd_ref(
             *args, dy), reps=1, windows=2, warmup=1),
         # dy + xc * dt: four of the five (B, S, Di) arrays' bytes, not the
         # same function
         "ssm_bwd_same_bytes": time_ms(lambda: torch.addcmul(dy, xc, dt)),
         "ssm_fwd_b1_turns": {"warm": in_turns(fwd_turns, reps=10),
                              "cold": in_turns(fwd_turns, flush=flush,
                                               reps=5)}}
    for key, name in (("ssm_fwd_b1", "without_states"),
                      ("ssm_fwd_states_b1", "with_states")):
        t[key] = statistics.median(t["ssm_fwd_b1_turns"]["warm"][name])
        t[key + "_cold"] = statistics.median(
            t["ssm_fwd_b1_turns"]["cold"][name])
    # each compare DIR's selective_scan.cu (serving's C interface) against
    # this checkout's forward without and with its states output, at B = 1
    t["ssm_fwd_b1_vs"] = {}
    for where, old in other_libraries(os.path.basename(SSM_SOURCE),
                                      compare_dirs, "selective_scan").items():
        fns = {"old": c_fwd(old, False, where), **fwd_turns}
        t["ssm_fwd_b1_vs"][where] = {
            "warm": in_turns(fns, reps=10),
            "cold": in_turns(fns, flush=flush, reps=5)}
        print(f"selective_scan at (1, {S}, {Di}, {N}) in turns against "
              f"{where}, ms: {json.dumps(t['ssm_fwd_b1_vs'][where])}",
              flush=True)
    lib = typed_library(BWD_SOURCE, _bwd_signatures)
    warps = lib.selective_scan_bwd_warps_per_sm(N)
    check(warps > 0, f"selective_scan_bwd's occupancy is unknown ({warps})")
    blocks = -(-Di // bwd_channels(N))
    chunks = -(-S // 32)
    # xc, dt, dy read and dxc, ddt written; Bc, Cc read and dBc, dCc
    # written; A read and dA written; the forward's chunk states read
    n_bytes = 4 * (5 * S * Di + 4 * S * N + 2 * Di * N + chunks * Di * N)
    # per (t, d, n): the states' recurrence (dt A, (dt x) B, the update's
    # FMA), g's update (dy C, an FMA), the dBc and dCc terms and their sums
    # over d, sum_n g B, u = g dA h_{t-1}, its sum with A and its dA term
    n_flops = 19 * S * Di * N
    n_exp = S * Di * N
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "flops": n_flops / FP32_FLOPS_PER_S * 1e3,
             "exponentials": n_exp / sfu_exp_per_s() * 1e3}
    term = max(terms, key=terms.get)
    # the forward at B = 1: xc, dt read, y written, Bc, Cc, A read, h_last
    # written (the states output adds its 4 chunks Di N bytes), 6 flops and
    # one exponential a (t, d, n)
    fwd_bytes = 4 * (3 * S * Di + 2 * S * N + 2 * Di * N)
    fwd_terms = {"bytes": fwd_bytes / HBM_BYTES_PER_S * 1e3,
                 "bytes_with_states": (fwd_bytes + 4 * chunks * Di * N)
                 / HBM_BYTES_PER_S * 1e3,
                 "flops": 6 * S * Di * N / FP32_FLOPS_PER_S * 1e3,
                 "exponentials": terms["exponentials"]}
    print(f"selective_scan_bwd at (1, {S}, {Di}, {N}) given the chunk "
          f"states: warm {t['ssm_bwd']} ms, cold {t['ssm_bwd_cold']} ms; "
          f"with the forward writing them: warm "
          f"{t['ssm_bwd_with_forward']} ms, cold "
          f"{t['ssm_bwd_with_forward_cold']} ms; {blocks} blocks, {warps} "
          f"warps resident an SM; plain {t['ssm_bwd_plain']} ms, addcmul over "
          f"four of its five largest arrays {t['ssm_bwd_same_bytes']} ms; "
          f"bound terms {terms} ms: bounded by {term}.  The forward at B = "
          f"1 without / with its states output: warm {t['ssm_fwd_b1']} / "
          f"{t['ssm_fwd_states_b1']} ms, cold {t['ssm_fwd_b1_cold']} / "
          f"{t['ssm_fwd_states_b1_cold']} ms, in turns "
          f"{json.dumps(t['ssm_fwd_b1_turns'])}; its bound terms "
          f"{fwd_terms} ms", flush=True)
    return {"err": err, "abs_err": abs_err, "t": t, "turns": turns,
            "terms": terms, "term": term,
            "bound": (terms[term], "bytes" if term == "bytes"
                      else "operations"),
            "fwd_terms": fwd_terms, "warps_per_sm": warps, "blocks": blocks,
            "partial_bytes": 2 * 4 * blocks * S * 2 * N,
            "bytes": n_bytes, "flops": n_flops, "exponentials": n_exp,
            "cases": len(cases)}


def mamba_train_phase(dev) -> dict:
    """Mode A (three rounds) of the federated LM step at falcon-mamba-7b's
    full width cut to two MAMBA layers, its peak memory, the live gradient
    check (its training CLI runs in phase 9b)."""
    from repro_torch.api import FederationSpec
    from repro_torch.api.scenarios import FALCON_MAMBA_7B_TRAIN
    spec = FederationSpec.from_dict(FALCON_MAMBA_7B_TRAIN)
    t0 = time.perf_counter()
    a = train_run(spec, TRAIN_ROUNDS_MAMBA,
                  "falcon-mamba-7b mode A (fedavg_replica)", keep_batch=True,
                  must_fall=True)
    rec = a["record"]
    check(rec["peak_gib"] * 2 ** 30 < 80e9,
          f"falcon-mamba-7b training peaked at {rec['peak_gib']} GiB")
    live = live_train_check(a["eng"], a["batch"], LIVE_GRAD_TOL_MAMBA)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"phase 9 (falcon-mamba-7b training) took {wall:.2f} s",
          flush=True)
    return {"mode_a": rec, "live": live, "phase_s": wall}


# --------------------------------------------------------------------- #
# 9b. training the MoE, MLA and audio models
# --------------------------------------------------------------------- #
TRAIN_ROUNDS_9B = 3
# the attention at the training shapes these models give it, (B, S, H, Kv,
# d, dv): deepseek-v2's MLA (d = qk_nope + qk_rope) and musicgen-large's
ATTN_TRAIN_SHAPES = {"mla": (1, 4096, 128, 128, 192, 128),
                     "musicgen": (1, 4096, 32, 32, 64, 64)}
# ragged shapes with d != dv: S = 1, 33 and 4097 across the tiles of 32, d
# 72 not a multiple of 16 (plain loads), H / Kv = 1, 2 and 4
RAGGED_DV_SHAPES = [(1, 33, 4, 4, 24, 16), (2, 1, 4, 1, 24, 16),
                    (1, 4097, 4, 4, 24, 16), (1, 33, 8, 2, 192, 64),
                    (1, 1, 4, 4, 192, 64), (1, 4097, 4, 1, 192, 64),
                    (2, 33, 4, 1, 72, 40), (1, 1, 2, 2, 72, 40),
                    (1, 4097, 8, 2, 72, 40)]
# the training CLI on each trained architecture, side by side in phase 9b:
# None is the CLI's default
# (recurrentgemma-2b)
TRAIN_CLI_ARCHS = (None, "falcon-mamba-7b", "grok-1-314b",
                   "deepseek-v2-236b", "musicgen-large")


def sdpa_backward(q, k, v, do) -> dict:
    """``torch.autograd.grad`` through ``scaled_dot_product_attention``
    (causal), the backward alone, timed through the first of its fused
    backends that takes these head dims, with each backend's refusal."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    out = {"library_ms": None, "library_backend": None, "refused": {}}
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                o = F.scaled_dot_product_attention(qh, kh, vh,
                                                   is_causal=True)
                lib = lambda: torch.autograd.grad(o, (qh, kh, vh), doh,
                                                  retain_graph=True)
                lib()
                out["library_ms"] = time_ms(lib, reps=3, windows=5,
                                            warmup=1)
            out["library_backend"] = backend.name
            del o
            break
        except RuntimeError as e:     # this backend does not take them
            out["refused"][backend.name] = str(e).splitlines()[0][:200]
    return out


def attn_shape_check(name, shape, dev, flush) -> dict:
    """The forward's lse output and the backward kernel against their
    plain versions (over head slices) at one training shape, two backward
    calls bit for bit equal; both timed warm and cold beside their bounds,
    the plain backward, and SDPA's backward where a backend takes the
    shape."""
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    B, S, H, Kv, d, dv = shape
    q, k, v = attn_inputs(B, S, H, Kv, d, torch.float32, dev, 810, dv=dv)
    g = torch.Generator(device=dev).manual_seed(811)
    do = torch.randn((B, S, H, dv), generator=g, device=dev)
    out, lse = _forward(q, k, v, 0, 0.0, True)
    ro, rl = plain_lse(q, k, v)
    e_o, ok_o = within(out, ro, FA_TOL["float32"], FA_TOL["float32"])
    e_l, ok_l = within(lse, rl, FA_TOL["float32"], FA_TOL["float32"])
    check(ok_o and ok_l, f"flash_attention {name} {shape} with lse: max abs "
          f"error {e_o} (out), {e_l} (lse)")
    del ro, rl
    got = flash_attention_bwd(q, k, v, out, lse, do)
    again = flash_attention_bwd(q, k, v, out, lse, do)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash_attention_bwd {name} {shape}: two calls differ")
    del again
    want = plain_bwd(q, k, v, out, lse, do)
    err = bwd_rel(got, want)
    err_abs = max((a_ - b_).abs().max().item() for a_, b_ in zip(got, want))
    check(err <= BWD_TOL, f"flash_attention_bwd {name} {shape}: error "
          f"{err} of the largest entry, beyond {BWD_TOL}")
    del got, want
    bwd = lambda: flash_attention_bwd(q, k, v, out, lse, do)
    fwd = lambda: _forward(q, k, v, 0, 0.0, True)
    cold = lambda fn: statistics.median(window_times(
        fn, reps=3, windows=3, warmup=1, flush=flush))
    t = {"bwd_ms": time_ms(bwd, reps=3, windows=5, warmup=1),
         "bwd_cold_ms": cold(bwd),
         "fwd_lse_ms": time_ms(fwd, reps=3, windows=5, warmup=1),
         "fwd_lse_cold_ms": cold(fwd),
         "bwd_plain_ms": time_ms(lambda: plain_bwd(q, k, v, out, lse, do),
                                 reps=1, windows=2, warmup=1)}
    lib = sdpa_backward(q, k, v, do)
    pairs = reachable_pairs(B, S, H, 0)
    flops = {"bwd": pairs * 2 * (3 * d + 2 * dv),
             "fwd_lse": pairs * 2 * (d + dv)}
    # q, k, v, o, dO and lse read once, dq, dk, dv written once; the
    # forward reads q, k, v and writes o and lse
    n_bytes = {"bwd": 4 * (2 * B * S * H * (d + dv) + 2 * B * S * Kv
                           * (d + dv) + B * H * S),
               "fwd_lse": 4 * (B * S * H * d + B * S * Kv * (d + dv)
                               + B * S * H * dv + B * H * S)}
    bounds = {}
    for key in flops:
        routes = {"cuda cores": bound_ms(n_bytes[key], flops[key]),
                  "tensor cores, 3xTF32": bound_ms(
                      n_bytes[key], 3 * flops[key], TF32_FLOPS_PER_S)}
        route = min(routes, key=lambda r_: routes[r_][0])
        bounds[key] = {"bound_ms": routes[route][0],
                       "bound_by": routes[route][1], "bound_route": route,
                       "bound_ms_by_route": {r_: b_[0] for r_, b_ in
                                             routes.items()}}
    res = {"shape": dict(zip(("B", "S", "H", "Kv", "d", "dv"), shape)),
           "max_rel_err": err, "max_abs_err": err_abs,
           "out_max_abs_err": e_o, "lse_max_abs_err": e_l, **t, **lib,
           "bounds": bounds, "reachable_pairs": pairs, "flops": flops,
           "bytes": n_bytes}
    print(f"flash_attention_bwd at {name}'s training shape {shape}: warm "
          f"{t['bwd_ms']} ms, cold {t['bwd_cold_ms']} ms, bound "
          f"{bounds['bwd']['bound_ms']} ms; plain {t['bwd_plain_ms']} ms; "
          f"SDPA's backward {lib['library_ms']} ms ({lib['library_backend']}"
          f", refused by {lib['refused']}); the forward with lse warm "
          f"{t['fwd_lse_ms']} ms, cold {t['fwd_lse_cold_ms']} ms, bound "
          f"{bounds['fwd_lse']['bound_ms']} ms; error {err} of the largest "
          f"entry, two calls bit for bit equal", flush=True)
    return res


def attn_train_shapes_phase(dev) -> dict:
    """9b (a): the forward's lse and the backward kernel at the ragged
    d != dv shapes, then at MLA's and musicgen's training shapes."""
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)
    t0 = time.perf_counter()
    worst = {"out": 0.0, "lse": 0.0, "bwd": 0.0}
    for i, shape in enumerate(RAGGED_DV_SHAPES):
        B, S, H, Kv, d, dv = shape
        q, k, v = attn_inputs(B, S, H, Kv, d, torch.float32, dev, 820 + i,
                              dv=dv)
        g = torch.Generator(device=dev).manual_seed(840 + i)
        do = torch.randn((B, S, H, dv), generator=g, device=dev)
        out, lse = _forward(q, k, v, 0, 0.0, True)
        ro, rl = plain_lse(q, k, v)
        e_o, ok_o = within(out, ro, FA_TOL["float32"], FA_TOL["float32"])
        e_l, ok_l = within(lse, rl, FA_TOL["float32"], FA_TOL["float32"])
        check(ok_o and ok_l, f"flash_attention {shape} with lse: max abs "
              f"error {e_o} (out), {e_l} (lse)")
        got = flash_attention_bwd(q, k, v, out, lse, do)
        again = flash_attention_bwd(q, k, v, out, lse, do)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash_attention_bwd {shape}: two calls differ")
        r = bwd_rel(got, plain_bwd(q, k, v, out, lse, do))
        check(r <= BWD_TOL, f"flash_attention_bwd {shape}: error {r} of the "
              f"largest entry, beyond {BWD_TOL}")
        worst = {"out": max(worst["out"], e_o), "lse": max(worst["lse"], e_l),
                 "bwd": max(worst["bwd"], r)}
    print(f"flash_attention with lse and flash_attention_bwd at "
          f"{len(RAGGED_DV_SHAPES)} ragged shapes with d != dv: worst "
          f"{json.dumps(worst)} (out and lse atol = rtol {FA_TOL['float32']}"
          f", the backward {BWD_TOL} of the largest entry); two calls bit "
          "for bit equal", flush=True)
    flush = L2Flush(dev)
    res = {"ragged": {"shapes": RAGGED_DV_SHAPES, "worst": worst}}
    for name, shape in ATTN_TRAIN_SHAPES.items():
        res[name] = attn_shape_check(name, shape, dev, flush)
        free_library_memory()
    res["phase_s"] = time.perf_counter() - t0
    return res


def moe_audio_train_phase(dev, smi_line: str) -> dict:
    """9b (b), (c): three rounds of ``DEEPSEEK_V2_236B_TRAIN`` (mode B)
    and of ``MUSICGEN_LARGE_TRAIN`` (mode A), each freed before the next
    is built: launches exactly their schedule, each round's seconds, peak
    memory under 80 GB, losses falling, deepseek's dropped assignments a
    round, one client's live gradients (its engine freed first, the state
    but that client's parameters); then the training CLI on the five
    trained architectures (phases 8's and 9's too), side by side."""
    from repro_torch.api import FederationSpec
    from repro_torch.api.scenarios import (DEEPSEEK_V2_236B_TRAIN,
                                           MUSICGEN_LARGE_TRAIN)
    from repro_torch.core import fl_step
    t0 = time.perf_counter()
    runs, counts = {}, {}
    for key, spec_dict in (("deepseek_v2_236b", DEEPSEEK_V2_236B_TRAIN),
                           ("musicgen_large", MUSICGEN_LARGE_TRAIN)):
        spec = FederationSpec.from_dict(spec_dict)
        mode = spec.task.params.get("mode", fl_step.MODE_A)
        run = train_run(spec, TRAIN_ROUNDS_9B, f"{key} {mode}",
                        keep_batch=True, must_fall=True)
        rec, eng = run["record"], run["eng"]
        cfg = eng.task.cfg
        clients = eng.n_clusters * (eng.clients if mode == fl_step.MODE_A
                                    else 1)
        per_round = clients * 2 * eng.task.n_micro * cfg.num_layers
        check(all(a == 2 for a in rec["a"]), f"{key}: a {rec['a']}")
        check(rec["launches"]["flash_attention_bwd"]
              == per_round * TRAIN_ROUNDS_9B
              and rec["launches"]["flash_attention"]
              == 2 * per_round * TRAIN_ROUNDS_9B,
              f"{key}: launches {rec['launches']}, {per_round} backwards "
              f"and {2 * per_round} forwards a round expected")
        check(rec["peak_gib"] * 2 ** 30 < 80e9,
              f"{key} training peaked at {rec['peak_gib']} GiB")
        lead = (0,) * fl_step.lead_dims(mode)
        params = {k: v[lead].clone() for k, v in eng.state.params.items()}
        mb = {k: v[lead + (0,)].clone() for k, v in run["batch"].items()}
        del run, eng
        gc.collect()
        free_library_memory()
        live = live_grads(cfg, mode, params, mb, LIVE_GRAD_TOL)
        del params, mb
        gc.collect()
        free_library_memory()
        rec.update({"live": live, "per_round": {
            "flash_attention_bwd": per_round,
            "flash_attention": 2 * per_round}, "mode": mode,
            "device": smi_line})
        runs[key] = rec
        counts[key] = rec["launches"]
        print(f"{key}: {TRAIN_ROUNDS_9B} rounds of {rec['round_s_each']} s, "
              f"peak {rec['peak_gib']:.3f} GiB, losses {rec['losses']}, "
              f"launches {rec['launches']} ({per_round} backwards and "
              f"{2 * per_round} forwards a round), dropped assignments a "
              f"round {rec.get('moe_dropped_a_round')}; {smi_line}",
              flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), env.get("PYTHONPATH")) if p)
    t1 = time.perf_counter()
    procs = {arch or "default": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"]
        + (["--arch", arch] if arch else []) + ["--steps", "3"], cwd=HERE,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in TRAIN_CLI_ARCHS}
    cli = {}
    for arch, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p_ in procs.values():
                p_.kill()
            fail(f"the training CLI on {arch} did not end in 600 s")
        cli[arch] = {"exit": proc.returncode,
                     "s": time.perf_counter() - t1}
        print(f"python -m repro_torch.launch.train --arch {arch} --steps 3: "
              f"exit {proc.returncode} after {cli[arch]['s']:.2f} s (the "
              f"{len(procs)} side by side):\n{out[-1500:]}", flush=True)
        check(proc.returncode == 0, f"the training CLI failed on {arch}: "
              f"{err[-4000:]}")
    wall = time.perf_counter() - t0
    print(f"phase 9b (MoE, MLA and audio training) took {wall:.2f} s",
          flush=True)
    return {"runs": runs, "counts": counts, "cli": cli, "phase_s": wall}


# --------------------------------------------------------------------- #
# 10. the cluster-major federation over torch.distributed ranks
# --------------------------------------------------------------------- #
DIST_K = 30             # run_scanned(30) on every spec
DIST_E = 10             # then run(max_rounds=10) on paper-mlp-fleet1k
DIST_E_DQN = 10         # and run(max_rounds=10) on paper-adaptive-fleet1k
DIST_STEADY = 20        # the steady rounds/s: windows of run_scanned(20),
DIST_WINDOWS = 3        # ... three of each engine, interleaved
DIST_AR_ROUNDS = 5      # rounds with every all-reduce timed
DIST_LIVE = 3           # rounds with the kernels held against plain ones
DIST_POP_B = 8          # replicates of paper-mlp-fleet1k over the ranks
DIST_POP_K = 5
DIST_RTOL = 1e-5        # the cross-shard contract of repro.api.cluster_engine
DIST_TIMEOUT = 300      # seconds, a spawn_local job
DIST_SPECS = ("paper-mlp-fleet1k", "faulty-fleet1k", "dp-fleet1k")
# the DQN controller: rank 0 pretrains, one broadcast at build hands its net
# to every rank; held against the unsharded engine under that same net
DIST_DQN = "paper-adaptive-fleet1k"


def dist_spec_dicts() -> dict:
    from repro_torch.api.scenarios import (DP_FLEET1K, FAULTY_FLEET1K,
                                           PAPER_ADAPTIVE_FLEET1K,
                                           PAPER_MLP_FLEET1K)
    return {"paper-mlp-fleet1k": PAPER_MLP_FLEET1K,
            "faulty-fleet1k": FAULTY_FLEET1K, "dp-fleet1k": DP_FLEET1K,
            DIST_DQN: PAPER_ADAPTIVE_FLEET1K}


def spread(xs: list) -> dict:
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1],
            "windows": xs}


def steady_windows(eng, plain) -> dict:
    """``DIST_WINDOWS`` windows of ``DIST_STEADY`` scanned rounds of the
    sharded engine ``eng`` and of the unsharded ``plain`` of the same
    process (rank 0's; None on the other ranks), interleaved, in rounds/s:
    their median and spread.  The ranks start each sharded window
    together."""
    import torch.distributed as dist
    out = {"sharded": [], "unsharded": []}
    for _ in range(DIST_WINDOWS):
        dist.barrier()
        _, s = timed(lambda: eng.run_scanned(DIST_STEADY, eval_final=False))
        out["sharded"].append(DIST_STEADY / s)
        if plain is not None:
            _, s = timed(lambda: plain.run_scanned(DIST_STEADY,
                                                   eval_final=False))
            out["unsharded"].append(DIST_STEADY / s)
    return {k: spread(v) for k, v in out.items() if v}


def trace_rows(trace) -> list:
    return [[r.t, r.round, r.cluster, r.a, r.loss, r.energy, r.acc]
            for r in trace.records]


def rows_agree(got, want, rtol=DIST_RTOL) -> bool:
    """The schedule (round, cluster, a; agg_count is the round) equal; t,
    loss and energy within ``rtol``; accuracy within 1e-5."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g[1:4] != w[1:4] or (g[6] is None) != (w[6] is None):
            return False
        if any(abs(a - b) > rtol * abs(b) + 1e-12
               for a, b in ((g[0], w[0]), (g[4], w[4]), (g[5], w[5]))):
            return False
        if g[6] is not None and abs(g[6] - w[6]) > 1e-5:
            return False
    return True


def dist_live_check(eng, rounds: int) -> dict:
    """``rounds`` more scanned rounds on this rank, every trust-kernel call
    held against its plain version on the same live tensors (1e-6): the
    masked Eqn 6 on the owner (the aggregator's, or `dp_aggregate`'s) and
    each rank's unmasked Eqn-19 partial sum."""
    from repro_torch.api import cluster_engine, components
    from repro_torch.core import privacy
    from repro_torch.kernels import ref
    seen = {"trust_aggregate": [], "trust_aggregate_dense": []}
    saved = {m: m.trust_aggregate for m in (components, privacy,
                                             cluster_engine)}

    def checked(kernel, name):
        def fn(x, w, mask=None):
            got = kernel(x, w, mask)
            e, r, ok = close_enough(got, ref.trust_aggregate_ref(x, w, mask),
                                    1e-6)
            seen[name].append({"max_abs_err": e, "rel": r, "ok": ok,
                               "shape": list(x.shape)})
            return got
        return fn

    components.trust_aggregate = checked(saved[components], "trust_aggregate")
    privacy.trust_aggregate = checked(saved[privacy], "trust_aggregate")
    cluster_engine.trust_aggregate = checked(saved[cluster_engine],
                                             "trust_aggregate_dense")
    try:
        eng.run_scanned(rounds, eval_final=False)
    finally:
        for m, fn in saved.items():
            m.trust_aggregate = fn
    return seen


def dist_worker(cfg: dict) -> None:
    """One rank of a phase-10 job (``--dist-worker``, started by
    `spawn_local`): each spec at mesh (G,) on the card, its counts, live
    checks and figures, then the sharded population; one JSON line."""
    import torch.distributed as dist
    from repro_torch.launch.distributed import initialize_from_env
    rank = initialize_from_env()
    from repro_torch.api import Federation, FederationSpec, ShardingSpec
    from repro_torch.kernels import build, launches, reset_launches
    from repro_torch.pop import PopulationEngine, PopulationSpec
    G = dist.get_world_size()
    loads = []
    build.load_listeners.append(lambda name, s: loads.append([name, s]))
    calls = {"n": 0, "ms": None}
    all_reduce = dist.all_reduce

    def counted(t, *a, **k):
        calls["n"] += 1
        if calls["ms"] is None:
            return all_reduce(t, *a, **k)
        # the collective alone: the ranks meet first, so a rank's wait for
        # the owner's member round is not counted
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(t, *a, **k)
        torch.cuda.synchronize()
        calls["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    dist.all_reduce = counted
    out = {"rank": rank, "world": G, "backend": dist.get_backend(),
           "device": str(torch.device("cuda", torch.cuda.current_device())),
           "runs": {}}
    torch.cuda.reset_peak_memory_stats()
    specs = dist_spec_dicts()
    events = cfg.get("event", {})
    for name in cfg["specs"]:
        spec = FederationSpec.from_dict({**specs[name],
                                         "sharding": {"mesh": [G]}})
        t0 = time.perf_counter()
        fed = Federation.from_spec(spec)
        eng = fed.engine
        run = {"build_s": time.perf_counter() - t0,
               "engine": type(eng).__name__, "C_pad": eng._C_pad,
               "C_loc": eng._C_loc, "S": eng._S, "n_pad": eng._n_pad,
               "pretrained": getattr(fed.controller, "pretrain_aux",
                                     None) is not None}
        bad = [k for k, v in eng.state.tensors().items()
               if v.device.type != "cuda"]
        run["off_card"] = bad
        reset_launches()
        n0 = calls["n"]
        tr, run["scanned_s"] = timed(lambda: eng.run_scanned(DIST_K))
        run.update(scanned=trace_rows(tr), scanned_calls=calls["n"] - n0,
                   scanned_launches=dict(launches))
        if name in events:
            reset_launches()
            n0 = calls["n"]
            ev, run["event_s"] = timed(
                lambda: fed.run(max_rounds=events[name]))
            run.update(event=trace_rows(ev), event_calls=calls["n"] - n0,
                       event_launches=dict(launches))
        plain = pfed = None
        if rank == 0 and (name == DIST_DQN or (
                name == DIST_SPECS[0] and cfg.get("steady"))):
            # the unsharded engine in this process, on the same rounds
            # (a DQN federation's under the same net); the other ranks
            # wait for it in their next collective
            pfed = Federation.from_spec(
                spec.replace(sharding=ShardingSpec()),
                controller=fed.controller if name == DIST_DQN else None)
            plain = pfed.engine
            run["plain_scanned"] = trace_rows(plain.run_scanned(DIST_K))
            if name in events:
                run["plain_event"] = trace_rows(
                    pfed.run(max_rounds=events[name]))
        if name == DIST_SPECS[0] and cfg.get("steady"):
            run["steady_rounds_per_s"] = steady_windows(eng, plain)
            calls["ms"] = []
            eng.run_scanned(DIST_AR_ROUNDS, eval_final=False)
            run["all_reduce_ms"] = calls["ms"]
            calls["ms"] = None
        if cfg.get("live"):
            run["live"] = dist_live_check(eng, DIST_LIVE)
        out["runs"][name] = run
        del fed, eng, tr, plain, pfed
        torch.cuda.empty_cache()
    if cfg.get("pop"):
        pspec = PopulationSpec(
            base=FederationSpec.from_dict(specs[DIST_SPECS[0]]),
            replicates=DIST_POP_B, sharding=ShardingSpec(mesh=(G,)))
        n0 = calls["n"]
        pop = PopulationEngine.from_population(pspec)
        reset_launches()
        n1 = calls["n"]
        traces, s = timed(lambda: pop.run_scanned(DIST_POP_K))
        out["pop"] = {"members": [pop._lo, pop._hi],
                      "traces": [trace_rows(t) for t in traces],
                      "energy": [pop.member_energy(b) for b in range(pop.B)],
                      "rounds": [pop.member_rounds(b) for b in range(pop.B)],
                      "build_calls": n1 - n0, "run_calls": calls["n"] - n1,
                      "member_rounds_per_s_incl_eval":
                          (pop._hi - pop._lo) * DIST_POP_K / s,
                      "launches": dict(launches)}
        del pop
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["library_loads"] = loads
    out["libraries"] = sorted(name for name, _ in loads)
    print("DISTRESULT" + json.dumps(out), flush=True)
    dist.destroy_process_group()


def dist_job(G: int, cfg: dict) -> list:
    """``G`` ranks of this script on the card; their results, rank order."""
    from repro_torch.launch.distributed import spawn_local
    t0 = time.perf_counter()
    res = spawn_local([os.path.abspath(__file__), "--dist-worker",
                       json.dumps(cfg)], n_procs=G, timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    for r in res:
        check(r.returncode == 0, f"mesh ({G},) rank failed "
              f"({r.returncode}): {r.stderr[-4000:]}")
    out = [json.loads(r.stdout.split("DISTRESULT", 1)[1]) for r in res]
    check([o["rank"] for o in out] == list(range(G)),
          f"mesh ({G},): ranks {[o['rank'] for o in out]}")
    print(f"mesh ({G},): {G} ranks, backend {out[0]['backend']}, "
          f"{wall:.2f} s", flush=True)
    return out, wall


def multi_device_phase(dev, smi_line: str) -> dict:
    """10. The cluster-major engine over ``torch.distributed`` ranks on the
    card, against the unsharded port engine of this process on the same
    seed: ``paper-mlp-fleet1k`` at mesh (1,) (NCCL, one rank) and (2,)
    (gloo, two ranks sharing cuda:0), ``run_scanned(30)`` then
    ``run(max_rounds=DIST_E)``; ``faulty-fleet1k`` and ``dp-fleet1k`` at mesh
    (2,), ``run_scanned(30)``; ``paper-adaptive-fleet1k`` at mesh (2,)
    against rank 0's unsharded engine under the same DQN net; the
    collectives and trust-kernel launches a round; three more rounds with every kernel call held against its
    plain version; B = 8 replicates as a population over the two ranks
    against the unsharded population; rounds/s, all-reduce ms and peak
    memory."""
    from repro_torch.api import Federation, FederationSpec
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.pop import PopulationEngine, PopulationSpec
    t_phase = time.perf_counter()
    specs = dist_spec_dicts()
    ref_rows, ref_fig = {}, {}
    for name in DIST_SPECS:
        fed = Federation.from_spec(FederationSpec.from_dict(specs[name]))
        eng = fed.engine
        reset_launches()
        tr, s = timed(lambda: eng.run_scanned(DIST_K))
        ref_rows[name] = {"scanned": trace_rows(tr)}
        ref_fig[name] = {"scanned_s": s, "launches": dict(launches)}
        if name == DIST_SPECS[0]:
            ev, ref_fig[name]["event_s"] = timed(
                lambda: fed.run(max_rounds=DIST_E))
            ref_rows[name]["event"] = trace_rows(ev)
        del fed, eng, tr
        torch.cuda.empty_cache()
    pspec = PopulationSpec(base=FederationSpec.from_dict(specs[DIST_SPECS[0]]),
                           replicates=DIST_POP_B)
    pop = PopulationEngine.from_population(pspec)
    ref_pop = [trace_rows(t) for t in pop.run_scanned(DIST_POP_K)]
    ref_pop_energy = [pop.member_energy(b) for b in range(pop.B)]
    del pop
    torch.cuda.empty_cache()
    free_library_memory()

    one, wall1 = dist_job(1, {"specs": [DIST_SPECS[0]],
                              "event": {DIST_SPECS[0]: DIST_E},
                              "steady": True})
    two, wall2 = dist_job(2, {"specs": list(DIST_SPECS) + [DIST_DQN],
                              "event": {DIST_SPECS[0]: DIST_E,
                                        DIST_DQN: DIST_E_DQN},
                              "steady": True, "live": True, "pop": True})
    counts, runs = {}, {}
    for G, res in ((1, one), (2, two)):
        check(res[0]["backend"] == ("nccl" if G == 1 else "gloo"),
              f"mesh ({G},) ran on {res[0]['backend']}")
        libs = {json.dumps(r["libraries"], sort_keys=True) for r in res}
        check(len(libs) == 1, f"mesh ({G},): the ranks loaded other "
              f"libraries: {libs}")
        for name in res[0]["runs"]:
            rs = [r["runs"][name] for r in res]
            what = f"{name} at mesh ({G},)"
            check(all(not r["off_card"] for r in rs),
                  f"{what}: state off the card {rs[0]['off_card']}")
            check(all(r["engine"] == "ClusterMajorEngine" for r in rs),
                  f"{what}: engine {rs[0]['engine']}")
            if name == DIST_DQN:
                check([r["pretrained"] for r in rs]
                      == [True] + [False] * (G - 1),
                      f"{what}: pretrained on ranks "
                      f"{[r['pretrained'] for r in rs]}, not rank 0 alone")
            for key in ("scanned", "event"):
                if key not in rs[0]:
                    continue
                check(all(json.dumps(r[key]) == json.dumps(rs[0][key])
                          for r in rs), f"{what}: the ranks' {key} traces "
                      "differ")
                # the DQN federation against the unsharded engine of rank
                # 0 under the same net; the others against this process's
                want = (rs[0][f"plain_{key}"] if name == DIST_DQN
                        else ref_rows[name][key])
                check(rows_agree(rs[0][key], want),
                      f"{what}: {key} trace departs from the unsharded "
                      f"engine's: {rs[0][key][:3]} vs {want[:3]}")
                rounds = (DIST_K if key == "scanned" else
                          DIST_E_DQN if name == DIST_DQN else DIST_E)
                per = 2 if key == "scanned" else 3
                check(all(r[f"{key}_calls"] == per * rounds for r in rs),
                      f"{what}: {[r[key + '_calls'] for r in rs]} "
                      f"all-reduces in {rounds} {key} rounds, not {per} a "
                      "round")
                lk = [r[f"{key}_launches"] for r in rs]
                check(sum(x["trust_aggregate"] for x in lk) == rounds,
                      f"{what}: masked launches {lk}")
                check(all(x["trust_aggregate_dense"] == rounds
                          and x["trust_aggregate_global"] == 0 for x in lk),
                      f"{what}: unmasked / fused launches {lk}")
                counts[f"multi_device_{G}_{name}_{key}"] = {
                    k: sum(x[k] for x in lk) for k in launches}
            if name == DIST_SPECS[0]:
                acc = rs[0]["scanned"][-1][6]
                check(acc is not None and acc >= JAX_ACC - ACC_MARGIN,
                      f"{what}: final accuracy {acc}")
            if "live" in rs[0]:
                for k in ("trust_aggregate", "trust_aggregate_dense"):
                    seen = [c for r in rs for c in r["live"][k]]
                    want = DIST_LIVE * (1 if k == "trust_aggregate" else G)
                    check(len(seen) == want and all(c["ok"] for c in seen),
                          f"{what}: live {k}: {seen}")
            runs.setdefault(name, {})[f"mesh_{G}"] = {
                "rounds_per_s_incl_eval": DIST_K / rs[0]["scanned_s"],
                # rank 0's windows, the sharded engine's and the
                # unsharded one's in the same process
                "steady_rounds_per_s": rs[0].get("steady_rounds_per_s"),
                "all_reduce_ms_a_round": [
                    sum(r["all_reduce_ms"]) / DIST_AR_ROUNDS
                    if "all_reduce_ms" in r else None for r in rs],
                "all_reduce_ms_each": [r.get("all_reduce_ms") for r in rs],
                "build_s": [r["build_s"] for r in rs],
                "live_max_abs_err": {
                    k: max([c["max_abs_err"] for r in rs
                            for c in r["live"][k]], default=None)
                    for k in ("trust_aggregate", "trust_aggregate_dense")}
                if "live" in rs[0] else None,
                "final_acc": rs[0]["scanned"][-1][6],
                "C_pad": rs[0]["C_pad"], "C_loc": rs[0]["C_loc"],
                "S": rs[0]["S"], "launches_a_scanned_run": [
                    r["scanned_launches"] for r in rs]}
    for name, fig in ref_fig.items():
        runs[name]["unsharded"] = {
            "rounds_per_s_incl_eval": DIST_K / fig["scanned_s"],
            "final_acc": ref_rows[name]["scanned"][-1][6]}
    for G in (1, 2):
        st = runs[DIST_SPECS[0]][f"mesh_{G}"]["steady_rounds_per_s"]
        print(f"{DIST_SPECS[0]} mesh ({G},) steady rounds/s, rank 0, "
              f"{DIST_WINDOWS} windows of {DIST_STEADY} rounds, median "
              f"[min, max]: " + "; ".join(
                  f"{k} {v['median']} [{v['min']}, {v['max']}]"
                  for k, v in st.items()) + f" ({smi_line})", flush=True)

    # the sharded population against the unsharded one
    pops = [r["pop"] for r in two]
    check([p["members"] for p in pops] == [[0, 4], [4, 8]],
          f"population blocks {[p['members'] for p in pops]}")
    check(all(json.dumps(p["traces"]) == json.dumps(pops[0]["traces"])
              for p in pops), "the ranks' population traces differ")
    check(all(p["run_calls"] == 1 for p in pops),
          f"population all-reduces {[p['run_calls'] for p in pops]}: one "
          "gather a run_scanned, none in a round")
    bitwise = json.dumps(pops[0]["traces"]) == json.dumps(ref_pop)
    check(bitwise or all(rows_agree(g, w, 1e-6) for g, w in
                         zip(pops[0]["traces"], ref_pop)),
          "sharded population members depart from the unsharded ones")
    check(pops[0]["energy"] == ref_pop_energy or all(
        abs(a - b) <= 1e-6 * abs(b) for a, b in zip(pops[0]["energy"],
                                                    ref_pop_energy)),
          "sharded population energies")
    counts["multi_device_population"] = {
        k: sum(p["launches"][k] for p in pops) for k in launches}

    res = {"device": smi_line, "runs": runs,
           "backend": {"mesh_1": one[0]["backend"],
                       "mesh_2": two[0]["backend"]},
           "rank_devices": {"mesh_1": [r["device"] for r in one],
                            "mesh_2": [r["device"] for r in two]},
           "peak_gib": {"mesh_1": [r["peak_gib"] for r in one],
                        "mesh_2": [r["peak_gib"] for r in two]},
           "library_loads": {"mesh_1": [r["library_loads"] for r in one],
                             "mesh_2": [r["library_loads"] for r in two]},
           "population": {"B": DIST_POP_B, "rounds": DIST_POP_K,
                          "members_bit_for_bit": bitwise,
                          "member_rounds_per_s_incl_eval": [
                              p["member_rounds_per_s_incl_eval"]
                              for p in pops]},
           "job_wall_s": {"mesh_1": wall1, "mesh_2": wall2},
           "note": "mesh (2,) is two ranks sharing one card's SMs, not two "
                   "cards",
           "phase_s": time.perf_counter() - t_phase, "counts": counts}
    print(f"phase 10 (multi-device): {res['phase_s']:.2f} s, "
          f"{json.dumps({k: v for k, v in res.items() if k != 'counts'})}",
          flush=True)
    return res


GSPMD_MESHES = ((1,), (1, 1))   # what the card runs (the probe: no gloo
                                # all-gather of CUDA tensors through DTensor)
GSPMD_SPECS = ("paper-mlp-fleet1k", "dp-fleet1k", "paper-adaptive-fleet1k")
GSPMD_K = 10            # run_scanned(10) on every spec
GSPMD_E = 5             # then run(max_rounds=5) on paper-mlp-fleet1k
GSPMD_STEADY = 10       # steady rounds/s: windows of run_scanned(10),
GSPMD_WINDOWS = 3       # ... three of each engine, interleaved


# the functional collectives DTensor's redistributions lower to, by kind
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all_gather",
                    "all_reduce": "all_reduce",
                    "reduce_scatter_tensor": "reduce_scatter",
                    "all_to_all_single": "all_to_all"}


@contextlib.contextmanager
def count_collectives():
    """Count the collectives DTensor runs on this rank while inside, by
    kind: a dict ``{kind: {"calls": n, "bytes": b}}``, ``b`` the bytes of
    this rank's input to each call.  A dispatch mode (as torch's
    ``CommDebugMode``) that lets DTensor lower its ops first and sees the
    ``_c10d_functional`` operators they dispatch; the results are the
    same."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types:        # DTensor first: its collectives
                return NotImplemented   # come back through this mode
            kind = COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
            if kind is not None and func.namespace == "_c10d_functional":
                c = counts.setdefault(kind, {"calls": 0, "bytes": 0})
                c["calls"] += 1
                c["bytes"] += args[0].numel() * args[0].element_size()
            return func(*args, **(kwargs or {}))

    with Count():
        yield counts


def gspmd_worker(cfg: dict) -> None:
    """One rank of a phase-10b job (``--gspmd-worker``): each spec at each
    mesh of ``cfg`` on the card against the unsharded engine of this
    process, its launches, DTensor's collectives and figures; or, with
    ``refuse``, the placement's refusal of ranks that share the card.  One
    JSON line."""
    import torch.distributed as dist
    from repro_torch.api import Federation, FederationSpec, placement
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.distributed import initialize_from_env
    rank = initialize_from_env()
    if cfg.get("stacks"):       # should the job hang: where each rank is
        import faulthandler
        faulthandler.dump_traceback_later(cfg["stacks"]["after_s"], file=open(
            os.path.join(cfg["stacks"]["dir"], f"rank{rank}.txt"), "w"))
    G = dist.get_world_size()
    out = {"rank": rank, "world": G, "backend": dist.get_backend(),
           "device": str(torch.device("cuda", torch.cuda.current_device())),
           "runs": {}}
    specs = dist_spec_dicts()
    if cfg.get("refuse"):
        spec = FederationSpec.from_dict({
            **specs[GSPMD_SPECS[0]],
            "sharding": {"mesh": [G], "impl": "gspmd"}})
        try:
            Federation.from_spec(spec)
            out["refused"] = None
        except RuntimeError as e:       # the refusal this job checks
            out["refused"] = str(e)
        print("GSPMDRESULT" + json.dumps(out), flush=True)
        dist.destroy_process_group()
        return
    torch.cuda.reset_peak_memory_stats()
    for mesh in cfg["meshes"]:
        tag = "x".join(map(str, mesh))
        for name in cfg["specs"]:
            # where a rank is, should the job outlive its timeout
            print(f"rank {rank}: {name} at mesh {tag}", file=sys.stderr,
                  flush=True)
            spec = FederationSpec.from_dict({
                **specs[name], "sharding": {"mesh": list(mesh),
                                            "impl": "gspmd"}})
            t0 = time.perf_counter()
            fed = Federation.from_spec(spec)
            eng = fed.engine
            run = {"build_s": time.perf_counter() - t0,
                   "engine": type(eng).__name__,
                   "gspmd": eng.placement.is_gspmd,
                   "mesh": str(eng.placement.mesh),
                   "pretrained": getattr(fed.controller, "pretrain_aux",
                                         None) is not None,
                   "off_card": [k for k, v in eng.state.tensors().items()
                                if not placement.is_dtensor(v)
                                or v.to_local().device.type != "cuda"]}
            reset_launches()
            with count_collectives() as cs:
                tr, run["scanned_s"] = timed(
                    lambda: eng.run_scanned(GSPMD_K))
            run.update(scanned=trace_rows(tr), scanned_launches=dict(
                launches), scanned_collectives=cs)
            # the unsharded engine, the DQN federation's under the same net
            pfed = Federation.from_spec(
                spec.replace(sharding=type(spec.sharding)()),
                controller=fed.controller if name == DIST_DQN else None)
            plain = pfed.engine
            reset_launches()
            run["plain_scanned"] = trace_rows(plain.run_scanned(GSPMD_K))
            run["plain_scanned_launches"] = dict(launches)
            if name == GSPMD_SPECS[0]:
                reset_launches()
                with count_collectives() as ce:
                    ev, run["event_s"] = timed(
                        lambda: fed.run(max_rounds=GSPMD_E))
                run.update(event=trace_rows(ev), event_launches=dict(
                    launches), event_collectives=ce)
                reset_launches()
                run["plain_event"] = trace_rows(pfed.run(
                    max_rounds=GSPMD_E))
                run["plain_event_launches"] = dict(launches)
                win = {"gspmd": [], "unsharded": []}
                for _ in range(GSPMD_WINDOWS):
                    for key, e in (("gspmd", eng), ("unsharded", plain)):
                        _, sec = timed(lambda: e.run_scanned(
                            GSPMD_STEADY, eval_final=False))
                        win[key].append(GSPMD_STEADY / sec)
                run["steady_rounds_per_s"] = {k: spread(v)
                                              for k, v in win.items()}
            out["runs"][f"{name}@{tag}"] = run
            del fed, eng, pfed, plain, tr
            torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print("GSPMDRESULT" + json.dumps(out), flush=True)
    dist.destroy_process_group()


def gspmd_job(G: int, cfg: dict) -> list:
    """``G`` ranks of this script's phase-10b worker on the card; their
    results in rank order, and the job's wall seconds."""
    from repro_torch.launch.distributed import spawn_local
    t0 = time.perf_counter()
    res = spawn_local([os.path.abspath(__file__), "--gspmd-worker",
                       json.dumps(cfg)], n_procs=G, timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    for r in res:
        check(r.returncode == 0, f"gspmd job of {G} ranks: a rank failed "
              f"({r.returncode}): {r.stderr[-4000:]}")
    out = [json.loads(r.stdout.split("GSPMDRESULT", 1)[1]) for r in res]
    check([o["rank"] for o in out] == list(range(G)),
          f"gspmd job: ranks {[o['rank'] for o in out]}")
    return out, wall


def per_round(counts: dict, rounds: int) -> dict:
    return {k: {"calls": v["calls"] / rounds, "bytes": v["bytes"] / rounds}
            for k, v in counts.items()}


def gspmd_phase(dev, smi_line: str) -> dict:
    """10b. The partitioner-inferred placement on the card (module
    docstring): meshes (1,) and (1, 1) bit for bit against the unsharded
    engine, the kernels' launches, DTensor's collectives, rounds/s and
    peak memory; then the refusal of two ranks sharing the card."""
    t_phase = time.perf_counter()
    free_library_memory()
    one, wall = gspmd_job(1, {"meshes": [list(m) for m in GSPMD_MESHES],
                              "specs": list(GSPMD_SPECS)})
    r0 = one[0]
    check(r0["backend"] == "nccl", f"gspmd mesh ranks ran on "
          f"{r0['backend']}")
    counts, runs = {}, {}
    for key, run in r0["runs"].items():
        name, tag = key.split("@")
        what = f"gspmd {name} at mesh ({tag.replace('x', ', ')},)"
        check(run["engine"] == "DeviceScaleEngine" and run["gspmd"],
              f"{what}: engine {run['engine']}, gspmd {run['gspmd']}")
        check(not run["off_card"], f"{what}: off the card or not DTensors: "
              f"{run['off_card']}")
        if name == DIST_DQN:
            check(run["pretrained"], f"{what}: rank 0 did not pretrain")
        entry = {"build_s": run["build_s"],
                 "rounds_per_s_incl_eval": GSPMD_K / run["scanned_s"],
                 "final_acc": run["scanned"][-1][6]}
        for path in ("scanned", "event"):
            if path not in run:
                continue
            rounds = GSPMD_K if path == "scanned" else GSPMD_E
            # bit for bit: the same records as the unsharded engine's
            check(json.dumps(run[path]) == json.dumps(run[f"plain_{path}"]),
                  f"{what}: {path} records depart from the unsharded "
                  f"engine's: {run[path][:2]} vs {run['plain_' + path][:2]}")
            got, want = run[f"{path}_launches"], run[f"plain_{path}_launches"]
            trust = ("trust_aggregate", "trust_aggregate_dense",
                     "trust_aggregate_global")
            check(all(got[k] == want[k] for k in trust)
                  and sum(got[k] for k in trust) >= rounds,
                  f"{what}: {path} launches {got}, unsharded {want}")
            counts[f"gspmd_{tag}_{name}_{path}"] = got
            entry[f"{path}_launches_a_round"] = {
                k: got[k] / rounds for k in trust if got[k]}
            entry[f"{path}_collectives_a_round"] = per_round(
                run[f"{path}_collectives"], rounds)
        if "steady_rounds_per_s" in run:
            entry["steady_rounds_per_s"] = run["steady_rounds_per_s"]
            st = run["steady_rounds_per_s"]
            print(f"gspmd {name} mesh ({tag.replace('x', ', ')},) steady "
                  f"rounds/s, {GSPMD_WINDOWS} windows of {GSPMD_STEADY} "
                  "rounds, median [min, max]: " + "; ".join(
                      f"{k} {v['median']} [{v['min']}, {v['max']}]"
                      for k, v in st.items()) + f" ({smi_line})",
                  flush=True)
        if name != "dp-fleet1k":
            acc = run["scanned"][-1][6]
            check(acc is not None and acc == acc, f"{what}: accuracy {acc}")
        runs.setdefault(name, {})[f"mesh_{tag}"] = entry

    # two ranks sharing the card: the placement refuses, naming the
    # all-gather the probe found missing
    two, wall2 = gspmd_job(2, {"refuse": True})
    for r in two:
        check(r["backend"] == "gloo" and r["refused"] is not None
              and "all_gather_into_tensor" in r["refused"]
              and "segfault" in r["refused"],
              f"gspmd mesh (2,) on one card: {r['refused']}")
    res = {"device": smi_line, "meshes": [list(m) for m in GSPMD_MESHES],
           "runs": runs, "backend": r0["backend"],
           "rank_device": r0["device"], "peak_gib": [r0["peak_gib"]],
           "refused_mesh_2": two[0]["refused"],
           "job_wall_s": {"meshes": wall, "refusal": wall2},
           "phase_s": time.perf_counter() - t_phase, "counts": counts}
    print(f"phase 10b (gspmd): {res['phase_s']:.2f} s", flush=True)
    return res


# --------------------------------------------------------------------- #
# 11. the sharded federated LM training step
# --------------------------------------------------------------------- #
# phase 11 at mesh (1, 1): recurrentgemma-2b's three layers in mode A
# (NC 1 x C 2: half phase 8's state) and deepseek-v2-236b's two layers of
# 16 experts in mode B (NC 1), full width, one NCCL rank
SHARDED_RUNS = (
    {"tag": "recurrentgemma_2b_mode_a@1x1", "scenario":
     "RECURRENTGEMMA_2B_TRAIN", "mesh": [1, 1], "NC": 1, "C": 2},
    {"tag": "deepseek_v2_236b_mode_b@1x1", "scenario":
     "DEEPSEEK_V2_236B_TRAIN", "mesh": [1, 1], "NC": 1})
SHARDED_ROUNDS = 1      # compared
SHARDED_TOL = 1e-5      # across ranks: float32 reassociation
SHARDED_TIMEOUT = 600   # seconds, the phase's job
# then recurrentgemma-2b on two gloo ranks sharing the card, mesh (1, 2):
# the heads, channels and vocab split over `model`, one round of one client
# and one microbatch (gloo moves every collective through host memory:
# 16.9 s a round at C 1 with 2 microbatches)
SHARDED_TP_RUN = {"tag": "recurrentgemma_2b_mode_a@1x2", "scenario":
                  "RECURRENTGEMMA_2B_TRAIN", "mesh": [1, 2], "NC": 1, "C": 1,
                  "task": {"n_micro": 1}, "rounds": 1}
SHARDED_TP_TIMEOUT = 300


def _host(tree):
    """A sharded state's parameters, whole, on the host (a collective)."""
    from repro_torch.core import sharding as shd
    return {k: shd.full(v).detach().to("cpu", copy=True)
            for k, v in tree.items()}


def _compare(got: dict, want: dict) -> dict:
    """Leaf by leaf on the card (a leaf at a time; the difference of two
    float32 values this close is exact in float32): bit for bit, and the
    largest error relative to the leaf's largest entry; of the worst leaf,
    where they differ, its worst element (index, both values) and how
    many of its elements are off by more than SHARDED_TOL of that
    entry."""
    dev = torch.device("cuda") if torch.cuda.is_available() else None
    rel, equal = {}, True

    def diff(k):
        w = want[k].to(dev or want[k].device)
        g = got[k].to(w.device)
        return g, w, (g - w).abs(), max(float(w.abs().max()), 1e-30)
    for k in want:
        g, w, d, scale = diff(k)
        equal = equal and torch.equal(g, w)
        rel[k] = float(d.max()) / scale
        del g, w, d
    worst = max(rel, key=rel.get)
    out = {"bit_equal": equal, "max_rel": rel[worst], "worst": worst}
    if rel[worst] > 0:
        g, w, d, scale = diff(worst)
        at = tuple(int(i) for i in torch.unravel_index(d.argmax(), d.shape))
        out.update(worst_at=list(at), worst_got=float(g[at]),
                   worst_want=float(w[at]),
                   over_tol=int((d > SHARDED_TOL * scale).sum()),
                   elements=w.numel())
    return out


@contextlib.contextmanager
def moe_routing(record=None, replay=None, flips=None):
    """Inside, every routing of an MoE block (`moe.route`) appends its
    expert ids to ``record``, or takes routing i's ids from ``replay``
    (counting into ``flips`` the assignments its own router would have
    chosen otherwise): a sharded MoE step's router reads inputs
    reassociated by the collectives, so a near tie can pick another
    expert, which the unsharded step then replays."""
    from repro_torch.models import moe as moe_mod
    inner = moe_mod.route

    def wrapped(p, cfg, xt, routing=None):
        if record is not None:
            out = inner(p, cfg, xt, routing)
            record.append(out[2])
            return out
        ids = replay[flips["calls"]]
        own = inner(p, cfg, xt)[2]
        flips["calls"] += 1
        flips["flipped"] += int((own != ids).sum())
        flips["assignments"] += ids.numel()
        return inner(p, cfg, xt, ids)
    moe_mod.route = wrapped
    try:
        yield
    finally:
        moe_mod.route = inner


def sharded_round(step, state, batch, rep, stale, dev):
    """One step with the launch and collective counts set to 0 before it
    and read after: -> (state, metrics, record)."""
    from repro_torch.core import sharding as shd
    from repro_torch.kernels import launches, reset_launches
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    reset_launches()
    shd.reset_collectives()
    sync()
    t0 = time.perf_counter()
    with count_collectives() as dtensor:
        state, m = step(state, batch, rep, stale)
    sync()
    sec = time.perf_counter() - t0
    own = {k: dict(v) for k, v in shd.collectives.items()}
    return state, m, {"s": sec, "loss": m["loss"].tolist(),
                      "launches": {k: v for k, v in launches.items() if v},
                      "collectives": {"own": own, "dtensor": dtensor}}


def split_recorder(opt, rec: dict, keep: bool):
    """``opt``, recording in call order (with ``keep``, to the host) each
    whole gradient an update is given and each whole update it makes; or,
    where ``rec["replay"]`` holds such a list of gradients, updating with
    those instead.  An update of a sharded leaf runs on the whole gathered
    leaf (`sharding.sharded_update`), so these are whole on every rank.
    Mode B's one cluster makes the same calls in the same order sharded
    and unsharded."""
    from repro_torch import optim
    rec.update(grads=[], updates=[])
    host = lambda t: t.detach().to("cpu", copy=True) if keep else None

    def take(gs):
        if rec.get("replay") is not None:
            gs = {k: rec["replay"][len(rec["grads"]) + i][1].to(
                device=g.device, dtype=g.dtype)
                for i, (k, g) in enumerate(gs.items())}
        rec["grads"] += [(k, host(g)) for k, g in gs.items()]
        return gs

    def update(grads, state, params=None, groups=()):
        us, new = opt.update(take(grads), state, params, groups=groups)
        rec["updates"] += [(k, host(u)) for k, u in us.items()]
        return us, new

    def unclipped(grads, state):
        return opt.unclipped(take(grads), state)

    def clipped(u, ss, n):
        out = opt.clipped(u, ss, n)
        rec["updates"].append(("clipped", host(out)))
        return out
    return optim.Optimizer(opt.init, update,
                           unclipped if opt.unclipped else None,
                           clipped if opt.clipped else None)


def split_check(cfg, opt, mode, init, specs, mesh, batch, pbatch, rep,
                stale, dev, rank, scratch: str) -> dict:
    """F3's check, split in two (`scripts/train_cards.py --split`): the
    sharded step's whole gradients against the unsharded step's (within
    SHARDED_TOL of each leaf's largest entry), and the sharded step fed
    the unsharded step's gradients against the unsharded step, update for
    update, bit for bit.  The MoE routing of the first sharded step is
    replayed in both others.  Rank 0 compares; the unsharded gradients
    reach the other ranks through ``scratch`` (a shared directory)."""
    import torch.distributed as dist
    from repro_torch.core import fl_step as fl
    from repro_torch.core import sharding as shd
    routes = [] if cfg.num_experts else None
    flips = {"calls": 0, "flipped": 0, "assignments": 0}
    path = os.path.join(scratch, "unsharded_grads.pt")

    def sharded(rec, replay_routes):
        step = fl.build_train_step(cfg, split_recorder(opt, rec, rank == 0),
                                   mode=mode)
        placed = shd.distribute_state(init(0), specs, mesh)
        ctx = (moe_routing(record=routes) if routes is not None
               and not replay_routes else
               moe_routing(replay=list(routes), flips={
                   "calls": 0, "flipped": 0, "assignments": 0})
               if routes is not None else contextlib.nullcontext())
        with ctx:
            step(placed, pbatch, rep, stale)
        del placed
        gc.collect()
        torch.cuda.empty_cache()

    got = {}
    sharded(got, False)
    out = {}
    if rank == 0:
        want = {}
        plain = fl.build_train_step(cfg, split_recorder(opt, want, True),
                                    mode=mode)
        with (moe_routing(replay=list(routes), flips=flips)
              if routes is not None else contextlib.nullcontext()):
            plain(init(0), batch, rep, stale)
        gc.collect()
        torch.cuda.empty_cache()
        rel = {k: float((g.double() - w.double()).abs().max())
               / max(float(w.abs().max()), 1e-30)
               for (k, g), (_, w) in zip(got["grads"], want["grads"])}
        worst = max(rel, key=rel.get)
        out.update(grad_rel=rel[worst], grad_worst=worst,
                   grads=len(rel), routing_replayed=dict(flips))
        torch.save(want["grads"], path)
        del got
    dist.barrier()
    fed = {"replay": torch.load(path)}
    sharded(fed, True)
    if rank == 0:
        pairs = list(zip(fed["updates"], want["updates"]))
        equal = [torch.equal(a, b) for (_, a), (_, b) in pairs]
        diff = max(float((a.double() - b.double()).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for (_, a), (_, b) in pairs)
        out.update(updates=len(pairs), updates_bit_equal=all(equal),
                   updates_max_rel=diff,
                   updates_apart=[k for ((k, _), _), e in zip(pairs, equal)
                                  if not e],
                   same_calls=[k for k, _ in fed["grads"]]
                   == [k for k, _ in want["grads"]])
    del fed
    dist.barrier()
    return out


def sharded_train_run(run: dict, dev, rank: int, refs: dict,
                      snaps: dict) -> dict:
    """One model at one mesh: the sharded step from a seeded state, rounds
    timed; on rank 0, the unsharded step from the same seed (``refs``
    keeps its rounds a configuration) or, with ``compare_with``, an earlier
    run's parameters (``snaps``)."""
    import dataclasses as dc
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.api import scenarios
    from repro_torch.api.components import LMTask
    from repro_torch.core import fl_step as fl
    from repro_torch.core import sharding as shd
    from repro_torch.launch.mesh import axis_size, host_mesh_for
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = {**getattr(scenarios, run["scenario"])["task"]["params"],
              **run.get("task", {})}
    task = LMTask(**params)
    cfg = task.cfg
    if "cf" in run:
        cfg = dc.replace(cfg, capacity_factor=run["cf"])
    mode, NC, C = task.mode, run["NC"], run.get("C", 1)
    mesh = host_mesh_for(run["mesh"], device=dev.type)
    opt_name = run.get("opt", "adafactor")
    opt = optim.REGISTRY[opt_name](task.lr)
    init = fl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                            clients_per_cluster=C, device=dev)
    key = json.dumps([run["scenario"], run.get("task", {}), run.get("cf"),
                      NC, C, opt_name, run.get("rounds", SHARDED_ROUNDS)])
    t0 = time.perf_counter()
    state = init(0)
    pod_axis = "pod" if axis_size(mesh, "pod") > 1 else None
    specs = fl.train_state_specs(cfg, state, mode=mode, opt_name=opt_name,
                                 pod_axis=pod_axis,
                                 tp_size=axis_size(mesh, "model"))
    placed = shd.distribute_state(state, specs, mesh)
    del state                    # the replicated leaves live on in placed
    batch = task.make_batch(torch.Generator().manual_seed(0), NC, C,
                            device=dev)
    pbatch = shd.distribute_batch(batch, fl.batch_specs(
        cfg, batch, mode=mode, pod_axis=pod_axis), mesh)
    rep = torch.ones((NC, C), device=dev)
    stale = torch.arange(NC, dtype=torch.float32, device=dev)
    step = fl.build_train_step(cfg, opt, mode=mode, ep=run.get("ep", False))
    build_s = time.perf_counter() - t0
    n_rounds = run.get("rounds", SHARDED_ROUNDS)
    out = {"mesh": run["mesh"], "build_s": build_s, "rounds": []}
    snap = None
    # across ranks the unsharded round 1 replays the sharded MoE routing
    replay = ([] if cfg.num_experts and dist.get_world_size() > 1
              and not run.get("compare_with") and not run.get("ep")
              else None)
    for r in range(n_rounds):
        with moe_routing(record=replay) if (replay is not None and r == 0) \
                else contextlib.nullcontext():
            placed, m, rec = sharded_round(step, placed, pbatch, rep, stale,
                                           dev)
        out["rounds"].append(rec)
        if r == 0:
            snap = _host(placed.params)
    out["layout"] = all(
        tuple(v.placements) == shd.placements(specs.params[k], mesh)
        for k, v in placed.params.items())
    out["off_card"] = [k for k, v in placed.params.items()
                       if v.to_local().device.type != dev.type]
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del placed, pbatch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if run.get("split"):
        import tempfile
        scratch = run.get("scratch") or tempfile.gettempdir()
        pbatch = shd.distribute_batch(batch, fl.batch_specs(
            cfg, batch, mode=mode, pod_axis=pod_axis), mesh)
        out["split"] = split_check(cfg, opt, mode, init, specs, mesh, batch,
                                   pbatch, rep, stale, dev, rank, scratch)
        del pbatch
    snaps[run["tag"]] = (snap, [x["loss"] for x in out["rounds"]])
    if rank == 0:
        if run.get("compare_with"):
            other, losses = snaps[run["compare_with"]]
            out["against"] = run["compare_with"]
            out["compare"] = _compare(snap, other)
            out["loss_vs"] = losses[0]
        else:
            if replay is not None:
                key += f"@{run['tag']}"     # this run's routing replayed
            if key not in refs:
                state = init(0)
                plain = fl.build_train_step(cfg, opt, mode=mode)
                rounds, first = [], None
                flips = {"calls": 0, "flipped": 0, "assignments": 0}
                for r in range(n_rounds):
                    with moe_routing(replay=replay, flips=flips) if (
                            replay is not None and r == 0) \
                            else contextlib.nullcontext():
                        state, _, rec = sharded_round(plain, state, batch,
                                                      rep, stale, dev)
                    rounds.append(rec)
                    if r == 0:
                        first = {k: v.detach().to("cpu", copy=True)
                                 for k, v in state.params.items()}
                if replay is not None:
                    check(flips["calls"] == len(replay), f"{run['tag']}: "
                          f"{flips['calls']} MoE calls replayed "
                          f"{len(replay)} recorded")
                    rounds[0]["routing_replayed"] = flips
                refs[key] = (first, rounds)
                del state
            first, rounds = refs[key]
            out["against"] = "unsharded"
            out["plain_rounds"] = rounds
            out["compare"] = _compare(snap, first)
            out["loss_vs"] = rounds[0]["loss"]
    dist.barrier()
    return out


# --------------------------------------------------------------------- #
# 12. sharded serving: the serving plans' steps on placed arguments
# --------------------------------------------------------------------- #
# on phase 11's NCCL rank, mesh (1, 1): each model's prefill of batch 4 x
# 4096 tokens and 32 greedy decode steps through `prefill_plan` /
# `decode_plan`'s step_fn on placed f32 weights, bit for bit
# `LM.prefill` / `decode_step` on the same weights, launches equal; then on
# phase 11's two gloo ranks sharing the card, mesh (1, 2), the prefill and
# 8 decode steps fed the (1, 1) run's tokens (its MoE routing replayed)
SERVE_SHARDED_STEPS = 16  # the (1, 1) runs' greedy decode steps
SERVE_SHARDED_RUNS = (
    {"tag": "recurrentgemma_2b@1x1", "arch": "recurrentgemma-2b",
     "mesh": [1, 1], "steps": SERVE_SHARDED_STEPS,
     "expect": {"flash_attention": 8, "rglru_scan": 18}},
    {"tag": "falcon_mamba_7b@1x1", "arch": "falcon-mamba-7b",
     "mesh": [1, 1], "steps": SERVE_SHARDED_STEPS,
     "expect": {"selective_scan": 64}},
    {"tag": "deepseek_v2_236b@1x1", "arch": "deepseek-v2-236b",
     "layers": 3, "mesh": [1, 1], "steps": SERVE_SHARDED_STEPS,
     "expect": {"flash_attention": 3}})
SERVE_SHARDED_TP_RUNS = (
    {"tag": "deepseek_v2_236b@1x2", "arch": "deepseek-v2-236b", "layers": 3,
     "mesh": [1, 2], "steps": 8, "against": "deepseek_v2_236b@1x1",
     "expect": {"flash_attention": 3}},
    {"tag": "recurrentgemma_2b@1x2", "arch": "recurrentgemma-2b",
     "mesh": [1, 2], "steps": 8, "against": "recurrentgemma_2b@1x1",
     "expect": {"flash_attention": 8, "rglru_scan": 18}})
SERVE_SHARDED_KEEP = 8   # logits of the prefill and of this many steps kept
SERVE_SHARDED_TOL = 1e-5  # of the unsharded run's largest logit
# the (1, 2) steps as shipped, against the unsharded run's own logits:
# recurrentgemma-2b read 5.3e-5 to 6.2e-5 over 8 steps, deepseek-v2 3.9e-6
# (NVIDIA H100 80GB HBM3, 700.00 W), from the attention's bfloat16 casts
# (`f32_attention`); the controls must move them past this (a cache
# missing half its tokens' entries read 0.0452 and 0.501, missing the newest
# token's 4.0e-4 and 1.06e-3)
SERVE_SHARDED_TP_TOL = 1.5e-4


def serve_cfg(run: dict):
    """A serving run's config: the architecture's, cut in depth where the
    run says so."""
    from repro_torch.configs import get_config
    cfg = get_config(run["arch"])
    return dataclasses.replace(cfg, num_layers=run["layers"]) \
        if run.get("layers") else cfg


def placed_seeded(cfg, specs: dict, mesh, dev, rank: int):
    """This rank's shards of ``LM(cfg, seed=0)``'s weights at ``specs``,
    drawn on the card a layer at a time (`seeded_params`; ranks sharing a
    card one after another), as DTensors; and the local tensors."""
    import torch.distributed as dist
    from repro_torch.core import sharding as shd
    from repro_torch.models.transformer import seeded_params

    def keep(k, t):
        mine = shd.local_chunk(t, specs[k], mesh)
        return mine.clone() if mine.numel() < t.numel() else t
    local = None
    shared = dist.get_world_size() > torch.cuda.device_count()
    for r in range(dist.get_world_size() if shared else 1):
        if r == rank or not shared:
            local = seeded_params(cfg, 0, device=dev, keep=keep)
            torch.cuda.synchronize()
        dist.barrier()
    return ({k: shd.from_local(v, specs[k], mesh) for k, v in local.items()},
            local)


def serve_prompts(cfg, dev):
    """`launch.serve.generate`'s prompts: batch SERVE_BATCH x SERVE_PROMPT
    from seed 0."""
    from repro_torch.launch.serve import token_stream
    return token_stream(torch.Generator().manual_seed(0),
                        SERVE_BATCH * SERVE_PROMPT, cfg.vocab_size).reshape(
        SERVE_BATCH, SERVE_PROMPT).to(dev)


def serve_calls(prefill, decode, tokens, steps: int, fed=None,
                before_step=None):
    """A prefill, then ``steps`` decode steps fed ``fed`` (or the greedy
    tokens), each with the launch and collective counts set to 0 before
    and read after -> (logits of every call, tokens fed, the final cache,
    seconds of the prefill and of each step, launches of the prefill and
    summed over the steps, the first step's collectives).
    ``before_step(cache)`` sees the cache before each step."""
    from repro_torch.core import sharding as shd
    from repro_torch.kernels import launches, reset_launches
    reset_launches()
    shd.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(tokens)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre = {k: v for k, v in launches.items() if v}
    out, used, step_s, dec, coll = [logits], [], [], {}, {}
    for i in range(steps):
        tok = fed[i] if fed is not None else logits.argmax(-1)
        used.append(tok)
        if before_step is not None:
            before_step(cache)
        reset_launches()
        shd.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(cache, tok, SERVE_PROMPT + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        for k, v in launches.items():
            if v:
                dec[k] = dec.get(k, 0) + v
        if i == 0:
            coll = {k: dict(v) for k, v in shd.collectives.items()}
        out.append(logits)
    return out, used, cache, pre_s, step_s, pre, dec, coll


@contextlib.contextmanager
def replayed_writes():
    """Inside, a decode step writes only its slot's position: the cache it
    is given already holds, in that slot, the entries another run's step
    wrote (`written`)."""
    from repro_torch.models import attention as mod
    inner = mod._write_slot
    mod._write_slot = lambda cache, step, entries, block: inner(
        cache, step, {}, block)
    try:
        yield
    finally:
        mod._write_slot = inner


@contextlib.contextmanager
def f32_attention():
    """Inside, a decode step's attention keeps its weights and its output
    in float32 where `attention.sdpa` / ``sdpa_split`` (as the JAX
    package's ``_sdpa``) cast them to the cache's bfloat16: those casts are
    discrete, and a probability one rounding apart under another
    summation order moved recurrentgemma-2b's logits 2.7e-5 to 6.2e-5 of
    the largest (NVIDIA H100 80GB HBM3, 700.00 W; 2e-7 without them, on
    the CPU at 14 layers)."""
    from repro_torch.models import attention as mod
    inner, inner_split = mod.sdpa, mod.sdpa_split
    mod.sdpa = lambda q, k, v, *a: inner(q, k, v.float(), *a)
    mod.sdpa_split = lambda q, k, v, *a: inner_split(q, k, v.float(), *a)
    try:
        yield
    finally:
        mod.sdpa, mod.sdpa_split = inner, inner_split


def written(before: list, after: list) -> list:
    """A step's input cache with the slot entries that step wrote: the
    attention and MLA layers' (ring slots and positions) from ``after``,
    the recurrent states from ``before``."""
    return [dict(a) if "pos" in a else dict(b)
            for b, a in zip(before, after)]


def zeroed(cache: list, upto: int, count=None) -> list:
    """A copy of a gathered cache with the K/V (or latent) entries of the
    attention and MLA layers' newest ``count`` positions before ``upto``
    zeroed (None: half of the positions a layer's ring holds)."""
    out = []
    for layer in cache:
        layer = {k: v.clone() for k, v in layer.items()}
        for k in ("k", "v", "ckv", "krope"):
            if k in layer:
                W = layer[k].shape[1]
                n = count or min(upto, W) // 2
                layer[k][:, torch.arange(upto - n, upto,
                                         device=layer[k].device) % W] = 0
        out.append(layer)
    return out


def new_slot_entries(got: list, want: list, pos: int) -> dict:
    """The entries slot ``pos % Wc`` holds in two caches: how many differ,
    and the largest difference of a layer's entries over one bfloat16
    rounding of their largest (2^-8 of it; the CPU test's measure of a
    cache leaf)."""
    n = differ = 0
    worst = 0.0
    for g, w in zip(got, want):
        for k in ("k", "v", "ckv", "krope"):
            if k not in g:
                continue
            slot = pos % g[k].shape[1]
            a, b = g[k][:, slot].float(), w[k][:, slot].float()
            big = max(float(a.abs().max()), float(b.abs().max()), 1e-30)
            n += a.numel()
            differ += int((a != b).sum())
            worst = max(worst, float((a - b).abs().max()) / (big * 2 ** -8))
    return {"entries": n, "differ": differ, "max_roundings": worst}


def sharded_serve_run(run: dict, dev, rank: int, store: str) -> dict:
    """One model at one mesh through the serving plans' step_fn (phase
    12).  At (1, 1) the unsharded `LM.prefill` / `decode_step` on the
    same weights follows, fed the same tokens, and its logits (the
    prefill's and SERVE_SHARDED_KEEP steps'), tokens and MoE routing are
    saved under ``store`` for a larger mesh's run (``against``), which is
    fed those tokens and replays that routing.  Such a run's prefill and
    decode steps, as shipped, are held to those saved logits
    (``logit_rel``).  The same steps then run again from the same prefill
    with the attention's weights and output kept in float32
    (`f32_attention`: the bfloat16 casts are discrete, so two summation
    orders may round a probability apart), and each is held to the
    unsharded `decode_step` (the whole model, drawn on rank 0 once the
    shards are freed) run the same way on the same inputs: the sharded
    run's cache before the step (gathered), with the K/V (or latent)
    entries the sharded step wrote into its slot (`written`,
    `replayed_writes`; a step reads back the bfloat16 entries it has just
    written, which may round apart too) (``logit_rel_f32``).  The
    unsharded step's own entries of the slot are held to one bfloat16
    rounding of the largest of a layer's (`new_slot_entries`), and its
    logits on them are reported beside (``logit_rel_own_entries``).  The
    control (``control``): how far the unsharded step's logits move when
    the cache after the prefill has lost the entries of half the tokens it
    holds (the newest), or of the newest prompt token (`zeroed`).  The (1, 1) runs hold the
    bfloat16 casts' path bit for bit."""
    import torch.distributed as dist
    from repro_torch.core import sharding as shd
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch import plans
    from repro_torch.launch.mesh import host_mesh_for
    from repro_torch.models.transformer import seeded_params, structure
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    cfg = serve_cfg(run)
    mesh = host_mesh_for(run["mesh"], device=dev.type)
    f32 = torch.float32
    pplan = plans.prefill_plan(run["arch"], "prefill_32k", mesh,
                               param_dtype=f32, cfg=cfg)
    dplan = plans.decode_plan(run["arch"], "decode_32k", mesh,
                              param_dtype=f32, cfg=cfg)
    specs = pplan.in_specs[0]
    t0 = time.perf_counter()
    placed, local = placed_seeded(cfg, specs, mesh, dev, rank)
    build_s = time.perf_counter() - t0
    bax = pplan.options["layout"]["batch_axis"]
    put = lambda t: shd.distribute(t, (bax,) + (None,) * (t.dim() - 1),
                                   mesh)
    tokens = serve_prompts(cfg, dev)
    ref = None
    if run.get("against"):
        ref = torch.load(os.path.join(store, run["against"] + ".pt"))
    flips = {"calls": 0, "flipped": 0, "assignments": 0}
    ctx = (moe_routing(replay=[r.to(dev) for r in ref["routing"]],
                       flips=flips) if ref is not None and cfg.num_experts
           else contextlib.nullcontext())
    first, snap = [], []
    keep_first = lambda c: None if first else first.append(  # noqa: E731
        shd.map_tree(lambda t: t.clone(), c))
    whole_copy = lambda c: snap.append(shd.map_tree(      # noqa: E731
        lambda t: t.clone() if rank == 0 else None, shd.full_tree(c)))
    fed_ref = None if ref is None else [t.to(dev) for t in ref["fed"]]
    with ctx:
        out, fed, cache, pre_s, step_s, pre, dec, coll = serve_calls(
            lambda t: pplan.step_fn(placed, put(t)),
            lambda c, t, i: dplan.step_fn(placed, c, put(t), i), tokens,
            run["steps"], fed_ref, None if ref is None else keep_first)
    res = {"mesh": run["mesh"], "build_s": build_s, "prefill_s": pre_s,
           "step_s": step_s, "launches_prefill": pre,
           "launches_decode": dec, "collectives_a_step": coll,
           "cache_layout": pplan.options["layout"],
           "finite": all(bool(torch.isfinite(x).all()) for x in out),
           "off_card": [k for k, v in local.items()
                        if v.device.type != dev.type],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if ref is not None:
        rel = lambda a, b: float((a.cpu() - b).abs().max()  # noqa: E731
                                 / b.abs().max())
        # the shipped path, against the unsharded run's own logits
        res["logit_rel"] = [rel(a, b) for a, b in zip(out, ref["logits"])]
        # the diagnosis: the same steps from the same prefill, with the
        # attention in float32, each step's cache gathered before it
        n_moe = ref["prefill_routings"]     # one routing a MoE layer
        dflips = {"calls": 0, "flipped": 0, "assignments": 0}
        with (moe_routing(replay=[r.to(dev) for r in ref["routing"][n_moe:]],
                          flips=dflips) if n_moe
              else contextlib.nullcontext()), f32_attention():
            dout, _, dcache, *_ = serve_calls(
                lambda t: (out[0], first.pop()),
                lambda c, t, i: dplan.step_fn(placed, c, put(t), i), tokens,
                run["steps"], fed_ref, whole_copy)
        whole_copy(dcache)                      # after the last step
        dout = [x.cpu() for x in dout]
        del placed, local, cache, dcache, out
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        want, free, slots, control = [ref["logits"][0]], [], [], {}
        if rank == 0:
            whole = seeded_params(cfg, 0, device=dev)
            model = structure(cfg)
            decode_ids = [r.to(dev) for r in ref["routing"][n_moe:]]

            def routed(i):
                return moe_routing(
                    replay=decode_ids[i * n_moe:(i + 1) * n_moe],
                    flips={"calls": 0, "flipped": 0, "assignments": 0}) \
                    if n_moe else contextlib.nullcontext()
            with torch.no_grad(), routed(0):
                # the control: the shipped unsharded step after the
                # prefill, and the same step on a cache missing entries
                base, _ = model.decode_step(
                    shd.map_tree(lambda t: t.clone(), snap[0]), fed[0],
                    SERVE_PROMPT, params=whole)
            for what, count in (("half_the_tokens", None),
                                ("newest_token", 1)):
                with torch.no_grad(), routed(0):
                    lost, _ = model.decode_step(
                        zeroed(snap[0], SERVE_PROMPT, count), fed[0],
                        SERVE_PROMPT, params=whole)
                control[what] = rel(lost, base.cpu())
            for i, tok in enumerate(fed):
                pos = SERVE_PROMPT + i
                with torch.no_grad():
                    # the unsharded step on the cache before the sharded
                    # one: its own entries of slot pos, its logits
                    with routed(i), f32_attention():
                        own, oc = model.decode_step(
                            shd.map_tree(lambda t: t.clone(), snap[i]), tok,
                            pos, params=whole)
                    slots.append(new_slot_entries(oc, snap[i + 1], pos))
                    free.append(own.cpu())
                    # and on the entries the sharded step wrote there
                    with routed(i), replayed_writes(), f32_attention():
                        lg, _ = model.decode_step(
                            written(snap[i], snap[i + 1]), tok, pos,
                            params=whole)
                    want.append(lg.cpu())
                snap[i] = None
            del whole
        snap.clear()
        errs = [rel(a, b) for a, b in zip(dout, want)]
        res.update(logit_rel_f32=errs[:1] + (errs[1:] if rank == 0 else []),
                   logit_rel_own_entries=[rel(a, b) for a, b in
                                          zip(dout[1:], free)],
                   new_slot_entries=slots, control=control,
                   routing_replayed=flips, routing_replayed_f32=dflips)
        placed = local = cache = out = None
    else:
        model, rec = structure(cfg), ([] if cfg.num_experts else None)
        with moe_routing(record=rec) if rec is not None \
                else contextlib.nullcontext():
            pout, _, pcache, ppre_s, pstep_s, ppre, pdec, _ = serve_calls(
                lambda t: model.prefill(t, plans.SHAPES["prefill_32k"][
                    "seq"], params=local),
                lambda c, t, i: model.decode_step(c, t, i, params=local),
                tokens, run["steps"], fed)
        res.update(
            plain_prefill_s=ppre_s, plain_step_s=pstep_s,
            plain_launches_prefill=ppre, plain_launches_decode=pdec,
            logits_bit_equal=all(torch.equal(a, b)
                                 for a, b in zip(out, pout)),
            cache_bit_equal=all(
                torch.equal(shd.local(c[k]), p[k])
                for c, p in zip(cache, pcache) for k in p))
        keep = SERVE_SHARDED_KEEP
        if rank == 0:
            torch.save({"logits": [x.cpu() for x in pout[:keep + 1]],
                        "fed": [t.cpu() for t in fed[:keep]],
                        "routing": [r.cpu() for r in rec or []],
                        "prefill_routings": sum(
                            layer.is_moe for layer in model.layers)},
                       os.path.join(store, run["tag"] + ".pt"))
        del pout, pcache
    del placed, local, cache, out
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    res["run_s"] = time.perf_counter() - t_run
    return res


# --------------------------------------------------------------------- #
# 13. training at the plans' bfloat16, and the dry run against it
# --------------------------------------------------------------------- #
# in phase 11's NCCL rank, mesh (1, 1): `train_plan`'s step at the plan's
# bfloat16 (parameters bfloat16 but `F32_LEAVES`, Adafactor) at full
# width, cut in depth, BF16_BATCH sequences of 4096 tokens (one client,
# two microbatches of two); the launch counts set to 0 before the step and
# read after it; the dry run's estimate of the same step on meta arguments
# against the step's measured peak and operations
BF16_RUNS = (
    {"tag": "recurrentgemma_2b@bf16", "arch": "recurrentgemma-2b",
     "layers": 3,
     "expect": ("flash_attention", "flash_attention_bwd", "rglru_scan",
                "rglru_scan_bwd"),
     "bf16": ("flash_attention", "flash_attention_bwd")},
    {"tag": "falcon_mamba_7b@bf16", "arch": "falcon-mamba-7b", "layers": 2,
     "expect": ("selective_scan", "selective_scan_bwd"),
     "bf16": ("selective_scan", "selective_scan_bwd")})
BF16_BATCH = 4          # the plans' global batch of 256 cut to 4
BF16_PEAK_TOL = 0.15    # the estimate's peak against the measured one
# a bfloat16 kernel against its plain version (float32 from the upcast
# inputs, rounded once to bfloat16), of each output's largest entry: the
# kernel's float32 sums in another order, then its own rounding: two
# bfloat16 roundings apart at most
BF16_KERNEL_TOL = 2 ** -7
BF16_LSE_TOL = 2e-5     # the forward's lse: float32 from the same inputs


def bf16_train_run(run: dict, dev) -> dict:
    """One phase-13 run on this rank: the estimate, then the step."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.kernels import bf16_launches, launches, reset_launches
    from repro_torch.launch import dryrun, plans
    from repro_torch.launch.mesh import make_host_mesh
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    mesh = make_host_mesh(1, 1, device="cuda")
    cfg = dc.replace(get_config(run["arch"]), num_layers=run["layers"])
    plan = plans.train_plan(run["arch"], "train_4k", mesh, cfg=cfg,
                            global_batch=BF16_BATCH)
    t0 = time.perf_counter()
    est, n_arg = dryrun.estimate(plan, mesh)
    est_s = time.perf_counter() - t0
    real = plans.materialize(plan, dev, seed=0)
    args = dryrun.placed_args(real, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out, m = plan.step_fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    got = {k: v for k, v in launches.items() if v}
    got_bf16 = {k: v for k, v in bf16_launches.items() if v}
    loss = m["loss"].float().reshape(-1).tolist()
    dtypes = sorted({str(v.dtype) for v in out.params.values()})
    del out, m, args, real
    gc.collect()
    torch.cuda.empty_cache()
    real = plans.materialize(plan, dev, seed=0)
    counted = dryrun.trace(real, dryrun.placed_args(real, mesh))
    del real
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "step_s": step_s, "estimate_s": est_s,
            "launches": got, "bf16_launches": got_bf16,
            "param_dtypes": dtypes, "peak_bytes": peak,
            "estimate_peak_bytes": est.peak_bytes,
            "estimate_peak_by": est.summary()["peak"],
            "argument_bytes": n_arg, "flops": counted.flops,
            "estimate_flops": est.flops,
            "kernel_flops": dict(est.kernel_flops),
            "layers": cfg.num_layers,
            "microbatches": tuple(plan.args[1]["tokens"].shape[:4])}


def bf16_report(res: dict, smi_line: str) -> dict:
    """Phase 13's checks and line from the (1, 1) job's runs: the loss
    finite, every kernel of the path launched (the bfloat16 instances
    among them), the parameters still bfloat16, the estimate's peak
    within BF16_PEAK_TOL of the measured one and its operations equal."""
    from repro_torch.kernels import launches
    runs, counts, bf16_counts = {}, {}, {}
    for run in BF16_RUNS:
        r = res[run["tag"]]
        what = f"bf16 training {run['tag']}"
        check(all(math.isfinite(x) for x in r["loss"]),
              f"{what}: losses {r['loss']}")
        check(all(r["launches"].get(k, 0) > 0 for k in run["expect"]),
              f"{what}: a kernel of the path did not launch: "
              f"{r['launches']}")
        check(all(r["bf16_launches"].get(k, 0) > 0 for k in run["bf16"]),
              f"{what}: a bfloat16 kernel did not launch: "
              f"{r['bf16_launches']}")
        check("torch.bfloat16" in r["param_dtypes"],
              f"{what}: parameters {r['param_dtypes']}")
        ratio = r["estimate_peak_bytes"] / r["peak_bytes"]
        check(abs(ratio - 1.0) <= BF16_PEAK_TOL,
              f"{what}: the estimated peak {r['estimate_peak_bytes']} is "
              f"{ratio:.3f} of the measured {r['peak_bytes']}")
        check(r["flops"] == r["estimate_flops"],
              f"{what}: operations {r['flops']}, estimated "
              f"{r['estimate_flops']}")
        counts[f"bf16_{run['tag'].split('@')[0]}"] = {
            k: r["launches"].get(k, 0) for k in launches}
        bf16_counts[run["tag"]] = r["bf16_launches"]
        runs[run["tag"]] = {**r, "peak_ratio": ratio}
        print(f"{what}: {r['layers']} layers, microbatches "
              f"{r['microbatches']}, loss {r['loss']}, step "
              f"{r['step_s']:.3f} s, peak {r['peak_bytes'] / 2 ** 30:.3f} "
              f"GiB against the dry run's {r['estimate_peak_bytes'] / 2 ** 30:.3f}"
              f" ({ratio:.3f}; {r['estimate_peak_by']}), operations "
              f"{r['flops']:.6e} = estimate, launches {r['launches']}, "
              f"bfloat16 {r['bf16_launches']} ({smi_line})", flush=True)
    return {"device": smi_line, "runs": runs, "counts": counts,
            "bf16_counts": bf16_counts}


def bf16_kernel_phase(dev) -> dict:
    """The bfloat16 kernels of training at the plans' bfloat16 against
    their plain versions at phase 13's shapes (a microbatch of 2 x 4096:
    recurrentgemma-2b's attention and RG-LRU, falcon-mamba-7b's scan),
    timed beside the plain version, a library call where one computes the
    same function, and their bounds (`repro_torch.kernels`' cost
    functions at the bfloat16 tensor-core rate for the attention's
    products, the float32 rate for the scans' arithmetic)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    fam = importlib.import_module("repro_torch.kernels.flash_attention")
    rgm = importlib.import_module("repro_torch.kernels.rglru_scan")
    ssm = importlib.import_module("repro_torch.kernels.selective_scan")
    t_phase = time.perf_counter()
    bf = torch.bfloat16
    Bm, S = 2, RECURRENT_TRAIN_SEQ
    rg, fm = get_config(ARCH), get_config(MAMBA_ARCH)
    H, Kv, d, window, W = (rg.num_heads, rg.num_kv_heads, rg.head_dim,
                           rg.window, rg.lru_width)
    out = {}

    def timed_once(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # the attention: the forward with lse, then the backward
    q, k, v = attn_inputs(Bm, S, H, Kv, d, bf, dev, 131)
    g = torch.Generator(device=dev).manual_seed(132)
    do = torch.randn((Bm, S, H, d), generator=g, device=dev).to(bf)
    o, lse = fam._forward(q, k, v, window, 0.0, True)
    o_ref, lse_ref = ref.flash_attention_lse_ref(q, k, v, window=window)
    fwd_err = rel_to_max(o, o_ref)
    fwd_abs = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    grads = fam.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window)
    bwd_err = max(rel_to_max(a_, b_) for a_, b_ in zip(grads, want))
    bwd_abs = max((a_.float() - b_.float()).abs().max().item()
                  for a_, b_ in zip(grads, want))
    again = fam.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    same = all(torch.equal(a_, b_) for a_, b_ in zip(grads, again))
    del want, again, o_ref, lse_ref
    check(fwd_err <= FA_TOL["bfloat16"] and lse_err <= BF16_LSE_TOL,
          f"flash_attention bf16 with lse: output {fwd_err}, lse {lse_err}")
    check(bwd_err <= BF16_KERNEL_TOL and same,
          f"flash_attention_bwd bf16: {bwd_err} (bit for bit twice: "
          f"{same})")
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    qh, kh, vh = (x.transpose(1, 2).repeat_interleave(H // x.shape[2], 1)
                  .contiguous().requires_grad_() for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)
    lib_out = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                          retain_graph=True)
    fl_f, by_f = fam.forward_cost(Bm, S, H, Kv, d, d, window, 2, lse=True)
    fl_b, by_b = fam.backward_cost(Bm, S, H, Kv, d, d, window, 2)
    out["flash_attention_lse_bf16"] = {
        "max_abs_err": fwd_abs, "max_rel_err": fwd_err,
        "lse_max_abs_err": lse_err,
        "tolerance": FA_TOL["bfloat16"],
        "ms": time_ms(lambda: fam._forward(q, k, v, window, 0.0, True),
                      reps=3, windows=5, warmup=1),
        "plain_ms": timed_once(lambda: ref.flash_attention_lse_ref(
            q, k, v, window=window)),
        "library_ms": time_ms(lib_fwd, reps=3, windows=5, warmup=1),
        "library": "scaled_dot_product_attention, bfloat16, boolean window "
                   "mask, K/V heads repeated (no lse)",
        "bound": bound_ms(by_f, fl_f, BF16_FLOPS_PER_S), "flops": fl_f,
        "bytes": by_f, "shape": [Bm, S, H, Kv, d, d, window]}
    out["flash_attention_bwd_bf16"] = {
        "max_abs_err": bwd_abs, "max_rel_err": bwd_err,
        "tolerance": BF16_KERNEL_TOL,
        "bit_for_bit_twice": same,
        "ms": time_ms(lambda: fam.flash_attention_bwd(
            q, k, v, o, lse, do, window=window), reps=3, windows=5,
            warmup=1),
        "plain_ms": timed_once(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, window=window)),
        "library_ms": time_ms(lib_bwd, reps=3, windows=5, warmup=1),
        "library": "torch.autograd.grad through scaled_dot_product_"
                   "attention, bfloat16, boolean window mask, K/V heads "
                   "repeated, its backward alone",
        "bound": bound_ms(by_b, fl_b, BF16_FLOPS_PER_S), "flops": fl_b,
        "bytes": by_b, "shape": [Bm, S, H, Kv, d, d, window]}
    del q, k, v, do, o, lse, grads, qh, kh, vh, doh, lib_out, mask

    # the RG-LRU scan's backward at bfloat16 (not on phase 13's path:
    # both packages scan float32 gates at any parameter type)
    a, bx = scan_inputs(Bm, S, W, bf, dev, 133, (0.9, 0.9999))
    hs, _ = ref.rglru_scan_ref(a, bx)
    dhs = torch.randn((Bm, S, W), generator=g, device=dev).to(bf)
    dh = torch.randn((Bm, W), generator=g, device=dev)
    got = rgm.rglru_scan_bwd(a, hs, dhs, dh)
    want = ref.rglru_scan_bwd_ref(a, hs, dhs, dh)
    err = max(rel_to_max(x, y) for x, y in zip(got, want))
    abs_ = max((x.float() - y.float()).abs().max().item()
               for x, y in zip(got, want))
    check(err <= BF16_KERNEL_TOL and all(x.dtype == bf for x in got),
          f"rglru_scan_bwd bf16: {err}")
    fl_r, by_r = rgm.backward_cost(Bm, S, W, 2)
    out["rglru_scan_bwd_bf16"] = {
        "max_abs_err": abs_, "max_rel_err": err,
        "tolerance": BF16_KERNEL_TOL,
        "ms": time_ms(lambda: rgm.rglru_scan_bwd(a, hs, dhs, dh)),
        "plain_ms": timed_once(lambda: ref.rglru_scan_bwd_ref(
            a, hs, dhs, dh)),
        "library_ms": None, "bound": bound_ms(by_r, fl_r), "flops": fl_r,
        "bytes": by_r, "shape": [Bm, S, W]}
    del a, bx, hs, dhs, dh, got, want

    # the selective scan: the forward with chunk states, then the backward
    Di, N = fm.d_inner, fm.ssm_state
    xc, dt, Bc, Cc, A = ssm_inputs(Bm, S, Di, N, bf, dev, 134)
    dy = torch.randn((Bm, S, Di), generator=g, device=dev).to(bf)
    y, h_last, ch = ssm._forward(xc, dt, Bc, Cc, A, states=True)
    y_ref, h_ref = ref.selective_scan_ref(xc, dt, Bc, Cc, A)
    ch_ref = ref.selective_scan_chunk_states_ref(xc, dt, Bc, Cc, A)
    fwd_err = max(rel_to_max(y, y_ref), rel_to_max(h_last, h_ref),
                  rel_to_max(ch, ch_ref))
    fwd_abs = max((x.float() - y_.float()).abs().max().item() for x, y_ in
                  ((y, y_ref), (h_last, h_ref), (ch, ch_ref)))
    del y_ref, h_ref, ch_ref
    check(fwd_err <= SCAN_TOL["bfloat16"],
          f"selective_scan bf16 with chunk states: {fwd_err}")
    got = ssm.selective_scan_bwd(xc, dt, Bc, Cc, A, dy, None, ch)
    want = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy)
    err = {n_: rel_to_max(x, y_) for n_, x, y_ in zip(SSM_GRADS, got, want)}
    abs_ = max((x.float() - y_.float()).abs().max().item()
               for x, y_ in zip(got, want))
    check(max(err.values()) <= BF16_KERNEL_TOL,
          f"selective_scan_bwd bf16: {err}")
    del want
    fl_s, by_s = ssm.forward_cost(Bm, S, Di, N, 2, states=True)
    fl_sb, by_sb = ssm.backward_cost(Bm, S, Di, N, 2)
    out["selective_scan_states_bf16"] = {
        "max_abs_err": fwd_abs, "max_rel_err": fwd_err,
        "tolerance": SCAN_TOL["bfloat16"],
        "ms": time_ms(lambda: ssm._forward(xc, dt, Bc, Cc, A, states=True),
                      reps=3, windows=5, warmup=1),
        "plain_ms": timed_once(lambda: ref.selective_scan_chunk_states_ref(
            xc, dt, Bc, Cc, A)),
        "library_ms": None, "bound": bound_ms(by_s, fl_s), "flops": fl_s,
        "bytes": by_s, "shape": [Bm, S, Di, N]}
    out["selective_scan_bwd_bf16"] = {
        "max_abs_err": abs_, "max_rel_err": max(err.values()),
        "rel_err_by_gradient": err,
        "tolerance": BF16_KERNEL_TOL,
        "ms": time_ms(lambda: ssm.selective_scan_bwd(
            xc, dt, Bc, Cc, A, dy, None, ch), reps=3, windows=5, warmup=1),
        "plain_ms": timed_once(lambda: ref.selective_scan_bwd_ref(
            xc, dt, Bc, Cc, A, dy)),
        "library_ms": None, "bound": bound_ms(by_sb, fl_sb),
        "flops": fl_sb, "bytes": by_sb, "shape": [Bm, S, Di, N]}
    del xc, dt, Bc, Cc, A, dy, y, h_last, ch, got
    for name, r in out.items():
        print(f"{name} at {r['shape']}: {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.1f} ms, library {r['library_ms']}, bound "
              f"{r['bound']}, error {r['max_rel_err']} of the largest "
              f"entry ({r['max_abs_err']} absolute)", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    free_library_memory()
    return out


def sharded_train_worker(cfg: dict) -> None:
    """One rank of a sharded-training job (``--train-sharded-worker``):
    each run of ``cfg`` in order, one JSON line at the end."""
    import torch.distributed as dist
    from repro_torch.launch.distributed import initialize_from_env
    dev = torch.device(cfg.get("device", "cuda"))
    rank = initialize_from_env(dev)
    if cfg.get("stacks"):       # should the job hang: where each rank is
        import faulthandler
        faulthandler.dump_traceback_later(cfg["stacks"]["after_s"], file=open(
            os.path.join(cfg["stacks"]["dir"], f"rank{rank}.txt"), "w"))
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(dev), "runs": {}}
    refs, snaps = {}, {}
    for run in cfg["runs"]:
        print(f"rank {rank}: {run['tag']}", file=sys.stderr, flush=True)
        out["runs"][run["tag"]] = sharded_train_run(run, dev, rank, refs,
                                                    snaps)
    # phase 12 in the same job
    out["serve"] = {}
    t0 = time.perf_counter()
    for run in cfg.get("serve", ()):
        print(f"rank {rank}: {run['tag']}", file=sys.stderr, flush=True)
        out["serve"][run["tag"]] = sharded_serve_run(run, dev, rank,
                                                     cfg["store"])
    out["serve_s"] = time.perf_counter() - t0
    # phase 13 in the same job
    out["bf16"] = {}
    t0 = time.perf_counter()
    for run in cfg.get("bf16", ()):
        print(f"rank {rank}: {run['tag']}", file=sys.stderr, flush=True)
        out["bf16"][run["tag"]] = bf16_train_run(run, dev)
    out["bf16_s"] = time.perf_counter() - t0
    print("TRAINSHARDED" + json.dumps(out), flush=True)
    dist.destroy_process_group()


def sharded_train_job(G: int, cfg: dict, timeout: float) -> tuple:
    """``G`` ranks of this script's sharded-training worker; their results
    in rank order, and the job's wall seconds."""
    from repro_torch.launch.distributed import spawn_local
    t0 = time.perf_counter()
    res = spawn_local([os.path.abspath(__file__), "--train-sharded-worker",
                       json.dumps(cfg)], n_procs=G, timeout=timeout)
    wall = time.perf_counter() - t0
    for r in res:
        check(r.returncode == 0, f"sharded training job of {G} ranks: a "
              f"rank failed ({r.returncode}): {r.stderr[-4000:]}")
    out = [json.loads(r.stdout.split("TRAINSHARDED", 1)[1]) for r in res]
    return out, wall


def flat_losses(x) -> list:
    """Mode A's (NC, C) losses or mode B's (NC,) as one list."""
    return [v for row in x for v in (row if isinstance(row, list)
                                     else [row])]


def per_round_collectives(rec: dict) -> dict:
    """A round's collectives by kind: the step's own and DTensor's."""
    out = {}
    for src in rec["collectives"].values():
        for k, v in src.items():
            c = out.setdefault(k, {"calls": 0, "bytes": 0})
            c["calls"] += v["calls"]
            c["bytes"] += v["bytes"]
    return out


def train_sharded_phase(dev, smi_line: str) -> dict:
    """11. The sharded federated LM step (`repro_torch.core.sharding`) at
    mesh (1, 1) over one NCCL rank: recurrentgemma-2b mode A and
    deepseek-v2-236b mode B at full width, each against the unsharded step
    from the same seed on the same card, bit for bit, with the kernels'
    launches a round equal; then recurrentgemma-2b at mesh (1, 2) on two
    gloo ranks sharing the card, within SHARDED_TOL of the unsharded
    step, every kernel of the path launched on each rank's shards."""
    from repro_torch.kernels import launches
    import tempfile
    t_phase = time.perf_counter()
    free_library_memory()
    store = tempfile.mkdtemp(prefix="serve_sharded_")
    ranks, wall = sharded_train_job(1, {"runs": list(SHARDED_RUNS),
                                        "serve": list(SERVE_SHARDED_RUNS),
                                        "bf16": list(BF16_RUNS),
                                        "store": store}, SHARDED_TIMEOUT)
    r0 = ranks[0]
    check(r0["backend"] == "nccl", f"sharded training ran on "
          f"{r0['backend']}")
    runs, counts = {}, {}
    want = {"recurrentgemma": ("flash_attention", "flash_attention_bwd",
                               "rglru_scan", "rglru_scan_bwd"),
            "deepseek": ("flash_attention", "flash_attention_bwd")}
    for tag, run in r0["runs"].items():
        what = f"sharded training {tag}"
        check(run["layout"] and not run["off_card"],
              f"{what}: placements {run['layout']}, off the card "
              f"{run['off_card']}")
        check(run["compare"]["bit_equal"], f"{what}: departs from the "
              f"unsharded step: {run['compare']}")
        for r, p in zip(run["rounds"], run["plain_rounds"]):
            check(r["launches"] == p["launches"], f"{what}: launches "
                  f"{r['launches']}, unsharded {p['launches']}")
            check(r["loss"] == p["loss"] and all(
                math.isfinite(x) for x in flat_losses(r["loss"])),
                f"{what}: losses {r['loss']}, unsharded {p['loss']}")
        kernels = want[tag.split("_")[0]]
        got = run["rounds"][0]["launches"]
        check(all(got.get(k, 0) > 0 for k in kernels),
              f"{what}: a kernel of the path did not launch: {got}")
        counts[f"sharded_{tag.split('@')[0]}"] = {
            k: sum(r["launches"].get(k, 0) for r in run["rounds"])
            for k in launches}
        runs[tag] = {
            "round_s": [r["s"] for r in run["rounds"]],
            "plain_round_s": [r["s"] for r in run["plain_rounds"]],
            "launches_a_round": run["rounds"][0]["launches"],
            "losses": [r["loss"] for r in run["rounds"]],
            "bit_equal": run["compare"]["bit_equal"],
            "peak_gib": run["peak_gib"], "build_s": run["build_s"],
            "collectives_a_round": per_round_collectives(run["rounds"][-1])}
        print(f"{what}: round s sharded {runs[tag]['round_s']}, unsharded "
              f"{runs[tag]['plain_round_s']}, launches a round "
              f"{runs[tag]['launches_a_round']}, peak "
              f"{run['peak_gib']:.2f} GiB, collectives a round "
              f"{runs[tag]['collectives_a_round']}, bit for bit "
              f"({smi_line})", flush=True)
    # the sharding at work on the card: two gloo ranks, mesh (1, 2)
    tag = SHARDED_TP_RUN["tag"]
    what = f"sharded training {tag}"
    two, wall2 = sharded_train_job(2, {"runs": [SHARDED_TP_RUN],
                                       "serve": list(SERVE_SHARDED_TP_RUNS),
                                       "store": store}, SHARDED_TP_TIMEOUT)
    shutil.rmtree(store, ignore_errors=True)
    tr = [r["runs"][tag] for r in two]
    check(all(r["backend"] == "gloo" for r in two),
          f"{what}: backends {[r['backend'] for r in two]}")
    check(all(r["layout"] and not r["off_card"] for r in tr),
          f"{what}: placements {[r['layout'] for r in tr]}, off the card "
          f"{[r['off_card'] for r in tr]}")
    cmp_, plain = tr[0]["compare"], tr[0]["plain_rounds"]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
        flat_losses(tr[0]["rounds"][0]["loss"]),
        flat_losses(plain[0]["loss"])))
    check(cmp_["max_rel"] <= SHARDED_TOL and loss_rel <= SHARDED_TOL,
          f"{what}: departs from the unsharded step: {cmp_}, losses "
          f"{loss_rel}")
    for i, r in enumerate(tr):
        got = r["rounds"][0]["launches"]
        check(all(got.get(k, 0) > 0 for k in want["recurrentgemma"])
              and got == plain[0]["launches"],
              f"{what}: rank {i}: launches {got}, unsharded "
              f"{plain[0]['launches']}")
    counts["sharded_recurrentgemma_2b_mode_a_1x2"] = {
        k: sum(r["rounds"][0]["launches"].get(k, 0) for r in tr)
        for k in launches}
    runs[tag] = {
        "round_s": [r["rounds"][0]["s"] for r in tr],
        "plain_round_s": [x["s"] for x in plain],
        "launches_a_round": [r["rounds"][0]["launches"] for r in tr],
        "plain_launches_a_round": plain[0]["launches"],
        "losses": tr[0]["rounds"][0]["loss"], "loss_rel": loss_rel,
        "compare": cmp_, "peak_gib": [r["peak_gib"] for r in tr],
        "build_s": [r["build_s"] for r in tr],
        "collectives_a_round": [per_round_collectives(r["rounds"][0])
                                for r in tr]}
    print(f"{what}: within {cmp_['max_rel']:.3g} of the unsharded step "
          f"({cmp_['worst']}), losses {loss_rel:.3g}; round s "
          f"{runs[tag]['round_s']} against {runs[tag]['plain_round_s']}, "
          f"launches a round {runs[tag]['launches_a_round']} against "
          f"{plain[0]['launches']}, peak {runs[tag]['peak_gib']} GiB, "
          f"collectives a round {runs[tag]['collectives_a_round']} "
          f"({smi_line})", flush=True)
    serve = serve_sharded_report(r0, two, smi_line)
    bf16 = bf16_report(r0["bf16"], smi_line)
    bf16["phase_s"] = r0["bf16_s"]
    res = {"device": smi_line, "runs": runs, "backend": r0["backend"],
           "job_wall_s": {"mesh_1x1": wall, "mesh_1x2": wall2},
           "phase_s": time.perf_counter() - t_phase - serve["phase_s"]
           - bf16["phase_s"], "counts": counts, "serve": serve,
           "bf16": bf16}
    print(f"phase 11 (sharded training): {res['phase_s']:.2f} s",
          flush=True)
    return res


def serve_sharded_report(r0: dict, two: list, smi_line: str) -> dict:
    """Phase 12's checks and lines, from phase 11's two jobs: the (1, 1)
    runs bit for bit the unsharded calls with equal launches; the (1, 2)
    runs within SERVE_SHARDED_TP_TOL of the (1, 1) run's logits as
    shipped (both controls past it), within SERVE_SHARDED_TOL of the
    unsharded steps with the attention in float32, every kernel of the
    path launched on each rank, none in decode."""
    runs, counts = {}, {}
    for tag, run in r0["serve"].items():
        what = f"sharded serving {tag}"
        want = next(r["expect"] for r in SERVE_SHARDED_RUNS
                    if r["tag"] == tag)
        check(run["logits_bit_equal"] and run["cache_bit_equal"],
              f"{what}: departs from LM.prefill / decode_step: logits "
              f"{run['logits_bit_equal']}, caches {run['cache_bit_equal']}")
        check(run["launches_prefill"] == run["plain_launches_prefill"]
              and all(run["launches_prefill"].get(k, 0) == n
                      for k, n in want.items())
              and sum(run["launches_prefill"].values()) == sum(
                  want.values()),
              f"{what}: prefill launches {run['launches_prefill']}, "
              f"unsharded {run['plain_launches_prefill']}, expected {want}")
        check(not any(run["launches_decode"].values()) and not any(
            run["plain_launches_decode"].values()),
              f"{what}: decode launched {run['launches_decode']}")
        check(run["finite"] and not run["off_card"],
              f"{what}: finite {run['finite']}, off the card "
              f"{run['off_card']}")
        counts[f"serve_sharded_{tag}"] = run["launches_prefill"]
        runs[tag] = run
        print(f"{what}: bit for bit LM.prefill / decode_step, prefill "
              f"{run['prefill_s']:.3f} s (unsharded {run['plain_prefill_s']:.3f}"
              f"), decode {len(run['step_s'])} steps "
              f"{sum(run['step_s']):.3f} s (unsharded "
              f"{sum(run['plain_step_s']):.3f}), launches a prefill "
              f"{run['launches_prefill']}, peak {run['peak_gib']:.2f} GiB, "
              f"build {run['build_s']:.2f} s, run {run['run_s']:.2f} s "
              f"({smi_line})", flush=True)
    for tag in two[0]["serve"]:
        what = f"sharded serving {tag}"
        rs = [r["serve"][tag] for r in two]
        want = next(r["expect"] for r in SERVE_SHARDED_TP_RUNS
                    if r["tag"] == tag)
        worst = max(max(r["logit_rel"]) for r in rs)
        f32 = max(max(r["logit_rel_f32"]) for r in rs)
        slots, control = rs[0]["new_slot_entries"], rs[0]["control"]
        check(len(rs[0]["logit_rel"]) == len(rs[0]["step_s"]) + 1
              and len(rs[0]["logit_rel_f32"]) == len(rs[0]["step_s"]) + 1,
              f"{what}: {len(rs[0]['logit_rel'])} and "
              f"{len(rs[0]['logit_rel_f32'])} calls compared")
        check(worst <= SERVE_SHARDED_TP_TOL, f"{what}: logits "
              f"{[r['logit_rel'] for r in rs]} of the largest unsharded "
              f"logit (routing replayed: {rs[0]['routing_replayed']})")
        check(min(control.values()) > SERVE_SHARDED_TP_TOL,
              f"{what}: the control {control} is within "
              f"{SERVE_SHARDED_TP_TOL}")
        check(f32 <= SERVE_SHARDED_TOL, f"{what}: with the attention in "
              f"float32, logits {[r['logit_rel_f32'] for r in rs]} of the "
              f"largest unsharded logit (routing replayed: "
              f"{rs[0]['routing_replayed_f32']})")
        check(all(x["max_roundings"] <= 1.0 for x in slots), f"{what}: "
              f"the entries a step wrote, against the unsharded step's: "
              f"{slots}")
        for i, r in enumerate(rs):
            check(r["launches_prefill"] == want
                  and not any(r["launches_decode"].values()),
                  f"{what}: rank {i}: prefill launches "
                  f"{r['launches_prefill']}, decode {r['launches_decode']}"
                  f", expected {want} a rank")
            check(r["finite"] and not r["off_card"],
                  f"{what}: rank {i}: finite {r['finite']}, off the card "
                  f"{r['off_card']}")
        counts[f"serve_sharded_{tag}"] = {
            k: sum(r["launches_prefill"].get(k, 0) for r in rs)
            for k in set().union(*(r["launches_prefill"] for r in rs))}
        runs[tag] = {"ranks": rs, "logit_rel": worst, "logit_rel_f32": f32,
                     "control": control}
        print(f"{what}: within {worst:.3g} of the largest unsharded logit "
              f"over the prefill and {len(rs[0]['step_s'])} steps as "
              f"shipped (limit {SERVE_SHARDED_TP_TOL:g}; each "
              f"{rs[0]['logit_rel']}); the control, a cache missing the "
              f"entries of half its tokens or of the newest, moves "
              f"them {control['half_the_tokens']:.3g} or "
              f"{control['newest_token']:.3g}; with the attention's "
              f"weights and output in float32 both ways, on the entries the "
              f"sharded step wrote, within {f32:.3g} (limit "
              f"{SERVE_SHARDED_TOL:g}; each {rs[0]['logit_rel_f32']}); a "
              f"step's new cache entries against the unsharded step's: "
              f"{sum(x['differ'] for x in slots)} of "
              f"{sum(x['entries'] for x in slots)} differ, by at most "
              f"{max(x['max_roundings'] for x in slots):.3g} bfloat16 "
              f"rounding of a layer's largest, and on "
              f"its own entries the unsharded step's logits are "
              f"{rs[0]['logit_rel_own_entries']} apart "
              f"(MoE routing replayed: {rs[0]['routing_replayed']}), "
              f"prefill s {[r['prefill_s'] for r in rs]}, decode step s "
              f"{[statistics.median(r['step_s']) for r in rs]}, launches a "
              f"prefill a rank {[r['launches_prefill'] for r in rs]}, peak "
              f"{[round(r['peak_gib'], 2) for r in rs]} GiB, collectives a "
              f"decode step {[r['collectives_a_step'] for r in rs]} "
              f"({smi_line})", flush=True)
    phase_s = r0["serve_s"] + max(r["serve_s"] for r in two)
    print(f"phase 12 (sharded serving): {phase_s:.2f} s", flush=True)
    return {"runs": runs, "counts": counts, "phase_s": phase_s}


BF16_ENTRIES = (
    ("flash_attention_lse_bf16", "flash_attention", FA_SOURCE,
     "src/repro/kernels/flash_attention.py:96",
     "the forward kernel's bfloat16 instance with its lse output "
     "(fa_forward_lse_bf16), for the backward"),
    ("flash_attention_bwd_bf16", "flash_attention_bwd", FA_BWD_SOURCE,
     "src/repro/models/attention.py:72",
     "no Pallas counterpart: jax.grad of _sdpa at bfloat16 "
     "(fa_backward_bf16: bfloat16 tiles converted as staged, the "
     "float32 kernel's 3xTF32 products)"),
    ("selective_scan_states_bf16", "selective_scan", SSM_SOURCE,
     "src/repro/kernels/selective_scan.py:56",
     "the forward's bfloat16 instance that also writes the float32 chunk "
     "states (selective_scan_states_bf16), for the backward"),
    ("selective_scan_bwd_bf16", "selective_scan_bwd", SSM_BWD_SOURCE,
     "src/repro/kernels/ref.py:37",
     "no Pallas counterpart: jax.vjp of selective_scan_ref at bfloat16 "
     "(selective_scan_bwd_states_bf16)"))


def bf16_kernel_entries(bk: dict, bf16_counts: dict) -> list:
    """The kernels line's entries of phase 13's bfloat16 instances: the
    launches of phase 13's path (its two training steps), the checks and
    times of `bf16_kernel_phase`."""
    out = []
    for name, counter, source, replaces, note in BF16_ENTRIES:
        r = bk[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_note": note,
            "launches": sum(c.get(counter, 0) for c in bf16_counts.values()),
            "launches_by_path": {p: c.get(counter, 0)
                                 for p, c in bf16_counts.items()},
            **{k: v for k, v in r.items() if k != "bound"},
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare-with", metavar="DIR", nargs="+", default=[],
                    help="time each DIR's trust_aggregate.cu, "
                         "flash_attention.cu, rglru_scan.cu, "
                         "selective_scan.cu, flash_attention_bwd.cu, "
                         "rglru_scan_bwd.cu and selective_scan_bwd.cu "
                         "against this checkout's")
    ap.add_argument("--dist-worker", metavar="JSON",
                    help=argparse.SUPPRESS)
    ap.add_argument("--gspmd-worker", metavar="JSON",
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-sharded-worker", metavar="JSON",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    if args.dist_worker:
        dist_worker(json.loads(args.dist_worker))
        return
    if args.gspmd_worker:
        gspmd_worker(json.loads(args.gspmd_worker))
        return
    if args.train_sharded_worker:
        sharded_train_worker(json.loads(args.train_sharded_worker))
        return
    from repro_torch.api import ControllerSpec, Federation, FederationSpec
    from repro_torch.api.scenarios import PAPER_MLP_FLEET1K
    from repro_torch.kernels import build, launches, reset_launches
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        """The script's seconds so far, as each phase ends."""
        print(f"[{time.perf_counter() - t_start:.1f} s] after phase {phase}",
              flush=True)

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(f"device: {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)

    # 2. the kernels, from this checkout's sources
    t0 = time.perf_counter()
    sources = (SOURCE, FA_SOURCE, SCAN_SOURCE, SSM_SOURCE, FA_BWD_SOURCE,
               SCAN_BWD_SOURCE, SSM_BWD_SOURCE)
    build.build_all([os.path.basename(p) for p in sources])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({build.build_seconds})", flush=True)
    for p in sources:
        for row in build.ptxas_report(os.path.basename(p)):
            print(f"ptxas {os.path.basename(p)}: {json.dumps(row)}",
                  flush=True)
    # the fused kernel's instantiations, one a block size
    report = build.ptxas_report(os.path.basename(SOURCE))
    fused_ptxas = [r for r in report
                   if r["kernel"].startswith("trust_aggregate_global_kernel")]
    check(fused_ptxas or not report, "ptxas named no fused kernel")
    check(all(r.get("spill_stores", 0) == 0 and r.get("spill_loads", 0) == 0
              for r in fused_ptxas), f"the fused kernel spills: {fused_ptxas}")
    stamp("2")

    # 3. the main path's federation, and its kernels at its shapes
    spec = FederationSpec.from_dict(PAPER_MLP_FLEET1K)
    t0 = time.perf_counter()
    fed = Federation.from_spec(spec)
    eng = fed.engine
    print("tf32: matmul", torch.backends.cuda.matmul.allow_tf32, "cudnn",
          torch.backends.cudnn.allow_tf32, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    M = eng._member_table.shape[1]
    B, N = eng.state.cluster_flat.shape
    sizes = eng._member_mask.sum(1).tolist()
    print(f"federation built in {time.perf_counter() - t0:.2f} s: "
          f"M={M} members (cluster sizes {min(sizes)}-{max(sizes)}), "
          f"B={B} clusters, N={N} parameters", flush=True)
    kp = kernel_phase(M, B, N, dev, args.compare_with)
    free_library_memory()
    fused_plan = importlib.import_module(
        "repro_torch.kernels.trust_aggregate").global_plan(M, B, N)
    print(f"fused kernel's plan at (C {M}, B {B}, N {N}): "
          f"{json.dumps(fused_plan)}", flush=True)

    # 4. the main path, each entry point with the counts reset before it
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    scanned = fed.run_scanned(30)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    counts["run_scanned"] = dict(launches)
    check(launches["trust_aggregate_global"] == 30,
          f"run_scanned(30) launched the fused kernel "
          f"{launches['trust_aggregate_global']} times")
    acc = scanned.records[-1].acc
    actions = sorted({r.a for r in scanned.records[:-1]})
    print(f"run_scanned(30): {30 / t_scan:.3f} rounds/s ({t_scan:.2f} s incl."
          f" final eval), actions {actions}, final acc {acc}, loss "
          f"{scanned.records[-1].loss:.5f}", flush=True)

    fixed = Federation.from_spec(
        spec.replace(controller=ControllerSpec("fixed", {"a": 5})),
        data=eng.data, parts=eng.parts)
    reset_launches()
    t0 = time.perf_counter()
    event = fixed.run(max_rounds=20)
    torch.cuda.synchronize()
    t_event = time.perf_counter() - t0
    counts["run"] = dict(launches)
    check(launches["trust_aggregate_global"] == 20,
          f"run(max_rounds=20) launched the fused kernel "
          f"{launches['trust_aggregate_global']} times")
    print(f"run(max_rounds=20), fixed a=5: {20 / t_event:.3f} rounds/s "
          f"({t_event:.2f} s incl. {len(event.records)} evals), final acc "
          f"{event.records[-1].acc}", flush=True)

    # the fused kernel on the main path's own inputs, three more rounds
    live = live_check(fed, 3)
    check(len(live) == 3 and all(ok for _, _, ok in live),
          f"fused kernel on live inputs: {live} (tolerance 1e-5)")
    live_err = max(e for e, _, _ in live)
    print(f"fused kernel on the main path's live inputs, 3 rounds: max abs "
          f"error {live_err:.3g}, max error relative to 1 + |plain| "
          f"{max(r for _, r, _ in live):.3g} (tolerance 1e-5)", flush=True)

    # Eqn 6 over the cluster models through the aggregator entry point
    # (the engine's own rounds reach this kernel only with DP on)
    reset_launches()
    cw = torch.full((B,), 1.0 / B, device=dev)
    mean_model = fed.aggregator(eng.state.cluster_flat, cw,
                                torch.ones((B,), device=dev))
    mean_acc = eng.task.evaluate(mean_model, eng.data)["acc"]
    counts["aggregator"] = dict(launches)
    check(launches["trust_aggregate"] == 1, "aggregator did not launch")
    print(f"cluster-mean model through Federation.aggregator: acc "
          f"{mean_acc}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"peak device memory: {peak:.3f} GiB", flush=True)

    for f_ in (fed, fixed):
        bad = [k for k, v in f_.engine.state.tensors().items()
               if v.device.type != "cuda"]
        check(not bad, f"state tensors off the card: {bad}")
    losses = [r.loss for r in scanned.records + event.records]
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(acc is not None and acc >= JAX_ACC - ACC_MARGIN,
          f"final accuracy {acc} < {JAX_ACC} - {ACC_MARGIN}")
    check(len(actions) > 1, f"the controller never varied a: {actions}")
    del fed, fixed, eng, scanned, event, mean_model
    torch.cuda.empty_cache()
    stamp("4")

    # 4b. the paper's full scheme: a DQN pretrained on the card picks a_i
    adaptive = adaptive_phase(dev)
    counts.update(adaptive.pop("counts"))
    torch.cuda.empty_cache()
    stamp("4b")
    # 4c. the autoencoder-anomaly task under the same controller
    anomaly = anomaly_phase(dev, args.compare_with)
    counts.update(anomaly.pop("counts"))
    stamp("4c")
    # 4d. DP, the robust rules and the fault model at full width
    robust = robust_phase(dev)
    counts.update(robust.pop("counts"))
    dense_eqn19 = dense_times(B, N, dev)
    free_library_memory()
    stamp("4d")
    # 4e. the service mode: checkpointed segments, resume, a SIGKILL
    service = service_phase(dev)
    counts.update(service.pop("counts"))
    torch.cuda.empty_cache()
    stamp("4e")
    # 4f. populations: B federations as one batched round, and the pool
    population = population_phase(dev)
    counts.update(population.pop("counts"))
    pk = population.pop("kernels")
    free_library_memory()
    stamp("4f")
    # 4g. the paper's own entry point and evaluation
    paper = paper_phase(dev)
    counts.update(paper.pop("counts"))
    free_library_memory()
    stamp("4g")
    feds = [adaptive, {k: v for k, v in anomaly.items() if k != "fused"},
            robust]
    print(f"launch counts by path: {json.dumps(counts)}", flush=True)
    total = {k: sum(c[k] for c in counts.values()) for k in launches}

    # 5. serving: recurrentgemma-2b at full width
    cfg = get_config(ARCH)
    lk = lm_kernel_phase(cfg, dev, args.compare_with)
    free_library_memory()
    sv = serving_phase(cfg, dev, {"flash_attention": 8, "rglru_scan": 18},
                       {"flash_attention": "attention",
                        "rglru_scan": "lru_scan"})
    live_lm = live_lm_check(sv["seen"])
    sv["seen"].clear()
    torch.cuda.empty_cache()
    cons = consistency_check(sv["res"])
    serving = [serving_record(cfg, sv, cons)]
    serve_launches = {k: sv["counts"]["prefill"][k] + sv["counts"]["decode"][k]
                      for k in launches}
    del sv
    torch.cuda.empty_cache()
    stamp("5")

    # 6. serving: falcon-mamba-7b at full width
    mcfg = get_config(MAMBA_ARCH)
    mk = mamba_kernel_phase(mcfg, dev, args.compare_with)
    free_library_memory()
    msv = serving_phase(mcfg, dev, {"selective_scan": mcfg.num_layers},
                        {"selective_scan": "mamba_scan"})
    live_ssm = live_mamba_check(msv["seen"])
    msv["seen"].clear()
    torch.cuda.empty_cache()
    mcons = consistency_check(msv["res"])
    serving.append(serving_record(mcfg, msv, mcons))
    for k in launches:
        serve_launches[k] += (msv["counts"]["prefill"][k]
                              + msv["counts"]["decode"][k])
    del msv
    free_library_memory()
    stamp("6")

    # 7. serving: the JAX package's seven other architectures
    archs = arch_serving_phase(dev, smi_line)
    serving += archs["records"]
    for k in launches:
        serve_launches[k] += sum(c[k] for c in archs["counts"].values())
    stamp("7")

    # 8. training: recurrentgemma-2b at full width, one Griffin period
    tk = train_kernel_phase(cfg, dev, args.compare_with)
    free_library_memory()
    training = train_phase(dev)
    free_library_memory()
    stamp("8")

    # 9. training: falcon-mamba-7b at full width, two MAMBA layers
    sk = ssm_bwd_phase(mcfg, dev, args.compare_with)
    free_library_memory()
    mtraining = mamba_train_phase(dev)
    free_library_memory()
    stamp("9")

    # 9b. training the MoE, MLA and audio models at full width, cut
    ak = attn_train_shapes_phase(dev)
    free_library_memory()
    moe_training = moe_audio_train_phase(dev, smi_line)
    free_library_memory()
    stamp("9b")
    train_counts = {"mode_a": training["mode_a"]["launches"],
                    "mode_b": training["mode_b"]["launches"],
                    "falcon_mamba_mode_a": mtraining["mode_a"]["launches"],
                    "deepseek_v2_mode_b":
                        moe_training["counts"]["deepseek_v2_236b"],
                    "musicgen_mode_a":
                        moe_training["counts"]["musicgen_large"]}
    train_launches = {k: sum(c[k] for c in train_counts.values())
                      for k in launches}

    # 10. the cluster-major federation over torch.distributed ranks, and
    # the unmasked kernel at a rank's Eqn-19 shape (C_loc 8, N)
    multi = multi_device_phase(dev, smi_line)
    counts.update(multi.pop("counts"))
    total = {k: sum(c[k] for c in counts.values()) for k in launches}
    c_loc = multi["runs"]["paper-mlp-fleet1k"]["mesh_2"]["C_loc"]
    dense_cm = dense_times(c_loc, N, dev)
    free_library_memory()
    stamp("10")

    # 10b. the partitioner-inferred placement through DTensor
    gspmd = gspmd_phase(dev, smi_line)
    counts.update(gspmd.pop("counts"))
    total = {k: sum(c[k] for c in counts.values()) for k in launches}
    stamp("10b")

    # 11. the sharded federated LM step at mesh (1, 1)
    sharded = train_sharded_phase(dev, smi_line)
    train_counts.update(sharded.pop("counts"))
    # 12. sharded serving, in phase 11's jobs
    serve_sharded = sharded.pop("serve")
    ss = serve_sharded["counts"]
    ss_total = {k: sum(c.get(k, 0) for c in ss.values()) for k in launches}
    # 13. training at the plans' bfloat16, in phase 11's first job; then
    # its kernels against their plain versions here
    bf16_train = sharded.pop("bf16")
    train_counts.update(bf16_train.pop("counts"))
    bf16_counts = bf16_train.pop("bf16_counts")
    stamp("11, 12 and 13's runs")
    bk = bf16_kernel_phase(dev)
    stamp("13")
    train_launches = {k: sum(c[k] for c in train_counts.values())
                      for k in launches}

    # 14. the serving line, the kernels line, then the result line
    t, bd, err = kp["t"], kp["bound"], kp["err"]
    lt, lbd = lk["t"], lk["bound"]
    kernels = [
        {"name": "trust_aggregate_global", "route": "cuda",
         "source": SOURCE, "replaces": f"{PALLAS}:51",
         "launches": total["trust_aggregate_global"],
         "launches_by_path": {p: c["trust_aggregate_global"]
                              for p, c in counts.items()},
         "at_anomaly_shape": {**anomaly["fused"],
                              "live_max_abs_err": anomaly[
                                  "live_max_abs_err"]},
         "at_paper_n21410": paper["paper"]["figures"]["fused_n21410"],
         "max_abs_err": err["global"], "tolerance": kp["tol"]["global"],
         "live_max_abs_err": live_err,
         **trust_times(kp, "global", "library_two_calls"),
         "plain_ms": t["global_plain"], "bound_ms": bd["global"][0],
         "bound_by": bd["global"][1], "library_ms": None,
         "shape": {"C": M, "B": B, "N": N, "dtype": "float32"},
         "plan": fused_plan, "ptxas": fused_ptxas or "not built in this run",
         "bytes": kp["bytes"]["global"]},
        {"name": "trust_aggregate", "route": "cuda", "source": SOURCE,
         "replaces": f"{PALLAS}:44",
         "launches": total["trust_aggregate"],
         "launches_by_path": {p: c["trust_aggregate"]
                              for p, c in counts.items()},
         "max_abs_err": err["f32"], "tolerance": kp["tol"]["f32"],
         **trust_times(kp, "f32", "library"),
         "plain_ms": t["f32_plain"], "bound_ms": bd["f32"][0],
         "bound_by": bd["f32"][1],
         "shape": {"C": M, "N": N, "dtype": "float32", "mask": True},
         "bytes": kp["bytes"]["f32"],
         # the owner's Eqn 6 of a cluster-major round is this (S, N) call
         "at_cluster_major_shape": "the shape above: S = M member slots",
         # PyTorch's sum of all of x, cold: the same bytes read, not the
         # same function
         "same_bytes_sum_ms": t["read_f32"],
         "bf16": {"max_abs_err": err["bf16"],
                  "same_bytes_sum_ms": t["read_bf16"],
                  "tolerance": kp["tol"]["bf16"],
                  **trust_times(kp, "bf16", "library"),
                  "plain_ms": t["bf16_plain"], "bound_ms": bd["bf16"][0],
                  "bound_by": bd["bf16"][1], "bytes": kp["bytes"]["bf16"]},
         "sm_clock_while_timed": kp["clock"]},
        {"name": "trust_aggregate_dense", "route": "cuda", "source": SOURCE,
         "replaces": f"{PALLAS}:37",
         "launches": total["trust_aggregate_dense"],
         "launches_by_path": {p: c["trust_aggregate_dense"]
                              for p, c in counts.items()},
         "at_eqn19_shape": dense_eqn19,
         "at_cluster_major_shape": dense_cm,
         "max_abs_err": err["f32"], "tolerance": kp["tol"]["f32"],
         **trust_times(kp, "dense", "library"),
         "plain_ms": t["dense_plain"],
         "bound_ms": bd["f32"][0], "bound_by": bd["f32"][1],
         "shape": {"C": M, "N": N, "dtype": "float32", "mask": False},
         "bytes": kp["bytes"]["f32"]},
        {"name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
         "replaces": "src/repro/kernels/flash_attention.py:26",
         "launches": serve_launches["flash_attention"]
         + train_launches["flash_attention"] + ss_total["flash_attention"],
         "launches_by_path": {
             "serving": serve_launches["flash_attention"],
             **{p: c["flash_attention"]
                for p, c in archs["counts"].items()},
             **{p: c["flash_attention"] for p, c in train_counts.items()},
             **{p: c.get("flash_attention", 0) for p, c in ss.items()}},
         "at_mla_prefill_shape": lk["mla"],
         "lse_variant_at_training_shapes": {
             name: {"ms": ak[name]["fwd_lse_ms"],
                    "cold_ms": ak[name]["fwd_lse_cold_ms"],
                    "max_abs_err_out": ak[name]["out_max_abs_err"],
                    "max_abs_err_lse": ak[name]["lse_max_abs_err"],
                    **ak[name]["bounds"]["fwd_lse"],
                    "shape": ak[name]["shape"]}
             for name in ATTN_TRAIN_SHAPES},
         "served_shapes_max_abs_err": lk["err"]["fa_served"],
         "lse_variant": {"ms": tk["t"]["fa_lse"],
                         "null_lse_ms": tk["t"]["fa_null"],
                         "max_abs_err_out": tk["err"]["out"],
                         "max_abs_err_lse": tk["err"]["lse"],
                         "shape": {"B": 1, "S": RECURRENT_TRAIN_SEQ,
                                   "H": cfg.num_heads,
                                   "Kv": cfg.num_kv_heads,
                                   "d": cfg.head_dim, "window": cfg.window}},
         "max_abs_err": lk["err"]["fa"]["float32"],
         "tolerance": FA_TOL["float32"],
         "bf16_max_abs_err": lk["err"]["fa"]["bfloat16"],
         "live_max_abs_err": live_lm["fa"],
         "live_tolerance_used": live_lm["fa_tolerance_used"],
         "ms": lt["fa"], "plain_ms": lt["fa_plain"],
         "bound_ms": lbd["fa"][0], "bound_by": lbd["fa"][1],
         "bound_route": lk["fa_route"],
         "bound_ms_by_route": {r: b[0] for r, b in lk["fa_routes"].items()},
         "library_ms": lt["fa_lib"],
         "bf16": {"ms": lt["fa_bf16"], "library_ms": lt["fa_bf16_lib"],
                  "bound_ms": lbd["fa_bf16"][0],
                  "bound_by": lbd["fa_bf16"][1]},
         "in_turns_ms": lt["fa_turns"],
         "shape": {"B": SERVE_BATCH, "S": SERVE_PROMPT, "H": cfg.num_heads,
                   "Kv": cfg.num_kv_heads, "d": cfg.head_dim,
                   "window": cfg.window, "dtype": "float32"},
         "reachable_pairs": lk["pairs"], "bytes": lk["bytes"]["fa"]},
        {"name": "rglru_scan", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": "src/repro/kernels/rglru_scan.py:22",
         "launches": serve_launches["rglru_scan"]
         + train_launches["rglru_scan"] + ss_total["rglru_scan"],
         "launches_by_path": {"serving": serve_launches["rglru_scan"],
                              **{p: c["rglru_scan"]
                                 for p, c in train_counts.items()},
                              **{p: c.get("rglru_scan", 0)
                                 for p, c in ss.items()}},
         "max_abs_err": lk["err"]["scan"]["float32"],
         "tolerance": SCAN_TOL["float32"],
         "bf16_max_abs_err": lk["err"]["scan"]["bfloat16"],
         "live_max_abs_err": live_lm["scan"],
         "ms": lt["scan"], "plain_ms": lt["scan_plain"],
         "bound_ms": lbd["scan"][0], "bound_by": lbd["scan"][1],
         "library_ms": None,
         "bf16": {"ms": lt["scan_bf16"], "bound_ms": lbd["scan_bf16"][0],
                  "bound_by": lbd["scan_bf16"][1],
                  "bytes": lk["bytes"]["scan_bf16"],
                  "same_bytes_add_ms": lt["scan_same_bytes_bf16"]},
         # a + bx into a new tensor: the same bytes, not the same function
         "same_bytes_add_ms": lt["scan_same_bytes"],
         "in_turns_ms": lt["scan_turns"],
         "shape": {"B": SERVE_BATCH, "S": SERVE_PROMPT, "W": cfg.lru_width,
                   "dtype": "float32"},
         "bytes": lk["bytes"]["scan"]},
        {"name": "selective_scan", "route": "cuda", "source": SSM_SOURCE,
         "replaces": "src/repro/kernels/selective_scan.py:25",
         "launches": serve_launches["selective_scan"]
         + train_launches["selective_scan"] + ss_total["selective_scan"],
         "launches_by_path": {"serving": serve_launches["selective_scan"],
                              **{p: c["selective_scan"]
                                 for p, c in train_counts.items()},
                              **{p: c.get("selective_scan", 0)
                                 for p, c in ss.items()}},
         "with_states_launches_falcon_mamba_mode_a":
             mtraining["mode_a"]["state_launches"],
         "at_training_shape_ms": sk["t"]["ssm_fwd_b1"],
         "at_training_shape_cold_ms": sk["t"]["ssm_fwd_b1_cold"],
         "with_states_at_training_shape_ms": sk["t"]["ssm_fwd_states_b1"],
         "with_states_at_training_shape_cold_ms":
             sk["t"]["ssm_fwd_states_b1_cold"],
         "at_training_shape_in_turns_ms": sk["t"]["ssm_fwd_b1_turns"],
         "at_training_shape_bound_terms_ms": sk["fwd_terms"],
         "states_max_abs_err": mk["states_err"],
         "max_abs_err": mk["err"]["float32"],
         "tolerance": SCAN_TOL["float32"],
         "bf16_max_abs_err": mk["err"]["bfloat16"],
         "live_max_abs_err": live_ssm,
         "ms": mk["t"]["ssm"], "plain_ms": mk["t"]["ssm_plain"],
         "bound_ms": mk["bound"][0], "bound_by": mk["bound"][1],
         "bound_term": mk["term"], "bound_terms_ms": mk["terms"],
         "library_ms": None, "in_turns_ms": mk["t"]["ssm_turns"],
         "shape": {"B": SERVE_BATCH, "S": SERVE_PROMPT, "Di": mcfg.d_inner,
                   "N": mcfg.ssm_state, "dtype": "float32"},
         "bytes": mk["bytes"], "flops": mk["flops"],
         "exponentials": mk["exponentials"]},
    ]
    kernels += pop_kernel_entries(pk, population["population"], counts,
                                  total)
    tt, tb = tk["t"], tk["bound"]
    kernels += [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": FA_BWD_SOURCE,
         "replaces": "src/repro/models/attention.py:72",
         "replaces_note": "no Pallas counterpart: the reference is jax.grad "
                          "of _sdpa and causal_mask "
                          "(src/repro/models/attention.py:72-96)",
         "launches": train_launches["flash_attention_bwd"],
         "launches_by_path": {p: c["flash_attention_bwd"]
                              for p, c in train_counts.items()},
         "max_abs_err": tk["err"]["fa_bwd_abs"],
         "max_rel_err": tk["err"]["fa_bwd"],
         "tolerance": BWD_TOL,
         "live_max_rel_err": training["live"]["max_rel_err"],
         "ms": tt["fa_bwd"], "cold_ms": tt["fa_bwd_cold"],
         "plain_ms": tt["fa_bwd_plain"], "bound_ms": tb["fa_bwd"][0],
         "bound_by": tb["fa_bwd"][1], "bound_route": tk["fa_route"],
         "bound_ms_by_route": {r: b_[0] for r, b_ in
                               tk["fa_routes"].items()},
         "library_ms": tt["fa_bwd_lib"],
         "library": "torch.autograd.grad through "
                    "scaled_dot_product_attention (boolean window mask, "
                    "K/V heads repeated), its backward alone",
         "shape": {"B": 1, "S": RECURRENT_TRAIN_SEQ, "H": cfg.num_heads,
                   "Kv": cfg.num_kv_heads, "d": cfg.head_dim,
                   "window": cfg.window, "dtype": "float32"},
         "in_turns_ms": tk["turns"][os.path.basename(FA_BWD_SOURCE)],
         "ptxas": build.ptxas_report(os.path.basename(FA_BWD_SOURCE))
         or "not built in this run",
         "reachable_pairs": tk["pairs"], "flops": tk["flops"],
         "bytes": tk["bytes"]["fa_bwd"],
         "at_training_shapes_9b": {
             name: {k_: v_ for k_, v_ in ak[name].items()
                    if k_ not in ("out_max_abs_err", "lse_max_abs_err",
                                  "fwd_lse_ms", "fwd_lse_cold_ms")}
             for name in ATTN_TRAIN_SHAPES},
         "at_ragged_d_unlike_dv": ak["ragged"],
         "live_max_rel_err_9b": {
             k_: r_["live"]["max_rel_err"]
             for k_, r_ in moe_training["runs"].items()}},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": SCAN_BWD_SOURCE,
         "replaces": "src/repro/models/rglru.py:67",
         "replaces_note": "no Pallas counterpart: the reference is jax.grad "
                          "of rglru_forward's lax.scan "
                          "(src/repro/models/rglru.py:67)",
         "launches": train_launches["rglru_scan_bwd"],
         "launches_by_path": {p: c["rglru_scan_bwd"]
                              for p, c in train_counts.items()},
         "max_abs_err": tk["err"]["scan_bwd_abs"],
         "max_rel_err": tk["err"]["scan_bwd"],
         "tolerance": BWD_TOL,
         "live_max_rel_err": training["live"]["max_rel_err"],
         "ms": tt["scan_bwd"], "cold_ms": tt["scan_bwd_cold"],
         "plain_ms": tt["scan_bwd_plain"], "bound_ms": tb["scan_bwd"][0],
         "bound_by": tb["scan_bwd"][1], "library_ms": None,
         # dhs + a * hs: three of the five arrays, not the same function
         "same_bytes_addcmul_ms": tt["scan_bwd_same_bytes"],
         "in_turns_ms": tk["turns"][os.path.basename(SCAN_BWD_SOURCE)],
         "ptxas": build.ptxas_report(os.path.basename(SCAN_BWD_SOURCE))
         or "not built in this run",
         "shape": {"B": 1, "S": RECURRENT_TRAIN_SEQ, "W": cfg.lru_width,
                   "dtype": "float32"},
         "bytes": tk["bytes"]["scan_bwd"],
         # its bfloat16 instance (rglru_scan_bwd_bf16), held and timed in
         # phase 13; training at bfloat16 launches the float32 one, since
         # both packages scan float32 gates at any parameter type
         "bf16": {k_: v_ for k_, v_ in bk["rglru_scan_bwd_bf16"].items()
                  if k_ != "bound"},
         "bf16_bound_ms": bk["rglru_scan_bwd_bf16"]["bound"][0]},
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": SSM_BWD_SOURCE,
         "replaces": "src/repro/kernels/ref.py:37",
         "replaces_note": "no Pallas counterpart: the reference is jax.vjp "
                          "of selective_scan_ref (src/repro/kernels/ref.py:"
                          "37-55) and jax.grad of mamba_forward's lax.scan "
                          "(src/repro/models/mamba.py:68-83)",
         "launches": train_launches["selective_scan_bwd"],
         "launches_by_path": {p: c["selective_scan_bwd"]
                              for p, c in train_counts.items()},
         "max_abs_err": sk["abs_err"], "max_rel_err": max(sk["err"].values()),
         "rel_err_by_gradient": sk["err"], "tolerance": BWD_TOL,
         "live_max_rel_err": mtraining["live"]["max_rel_err"],
         "ms": sk["t"]["ssm_bwd"], "cold_ms": sk["t"]["ssm_bwd_cold"],
         "given": "the forward's chunk states, as training calls it",
         "with_forward_ms": sk["t"]["ssm_bwd_with_forward"],
         "with_forward_cold_ms": sk["t"]["ssm_bwd_with_forward_cold"],
         "warps_per_sm": sk["warps_per_sm"], "blocks": sk["blocks"],
         "partial_bytes": sk["partial_bytes"],
         "plain_ms": sk["t"]["ssm_bwd_plain"], "bound_ms": sk["bound"][0],
         "bound_by": sk["bound"][1], "bound_term": sk["term"],
         "bound_terms_ms": sk["terms"], "library_ms": None,
         # dy + xc * dt: four of its five largest arrays, not the function
         "same_bytes_addcmul_ms": sk["t"]["ssm_bwd_same_bytes"],
         "in_turns_ms": sk["turns"],
         "ptxas": build.ptxas_report(os.path.basename(SSM_BWD_SOURCE))
         or "not built in this run",
         "shape": {"B": 1, "S": RECURRENT_TRAIN_SEQ, "Di": mcfg.d_inner,
                   "N": mcfg.ssm_state, "dtype": "float32"},
         "bytes": sk["bytes"], "flops": sk["flops"],
         "exponentials": sk["exponentials"]},
    ]
    kernels += bf16_kernel_entries(bk, bf16_counts)
    print(json.dumps({"federations": feds}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"service": {"device": smi_line, **service["service"]}}),
          flush=True)
    print(json.dumps({"population": {"device": smi_line,
                                     **population["population"]}}),
          flush=True)
    print(json.dumps({"paper": {"device": smi_line,
                                **plain_json(paper["paper"])}}), flush=True)
    print(json.dumps({"training": {
        "device": smi_line, **training, "falcon_mamba_7b": mtraining,
        **moe_training["runs"], "cli_9b": moe_training["cli"],
        "phase_9b_s": moe_training["phase_s"] + ak["phase_s"]}}),
        flush=True)
    print(json.dumps({"multi_device": multi}), flush=True)
    print(json.dumps({"gspmd": gspmd}), flush=True)
    print(json.dumps({"train_sharded": sharded}), flush=True)
    print(json.dumps({"serve_sharded": {"device": smi_line,
                                        **serve_sharded}}), flush=True)
    print(json.dumps({"bf16_training": {**bf16_train, "kernels": bk}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
