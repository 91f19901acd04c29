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
   step at position 4096 held against a prefill of all 4097 tokens;
6. serving: falcon-mamba-7b at full width (64 MAMBA layers, d_model 4096,
   d_inner 8192, N 16, 7.0e9 f32 parameters from seed 0), after
   recurrentgemma-2b is freed: first the selective-scan kernel against its
   plain version at the serving path's shape, at the JAX tests'
   parametrisations and at ragged ones, timed beside the plain version,
   with its bound from bytes, flops and exponentials; then the same
   traffic (batch 4, 4096-token prompts, 32 greedy tokens) with the counts
   read after the prefill (64 selective_scan) and the decode loop (none),
   the kernel on the first MAMBA layer's own inputs held against its plain
   version, and the 4096 + 1 consistency check;
7. prints the federations line (4b, 4c and 4d), the serving line, the
   service line (4e: each segment's ``service_rounds_per_sec``, its
   checkpoint's seconds and bytes, the chaos children's start-up seconds,
   kills and restarts, beside the card's name and power limit), the
   population line (4f: member-rounds/s beside the standalone rounds/s,
   accuracies, peak memory, the pool's wall times), the paper line (4g:
   each figure's metrics, seconds and launches, the JAX bands, the grid's
   recovery and its population against sequential seconds, the
   secure-aggregation cells, beside the card's name and power limit), the
   kernels line, then the result line.

The trust kernels are timed back to back through their wrappers (the
kernels line's ``ms`` and ``library_ms``) and by device time, warm (ten
calls from one CUDA graph) and cold (the L2 flushed before each call;
``warm_ms`` and ``cold_ms``), each in turns with its library call, with
every window's time and the SM clock printed.
``--compare-with DIR ...`` also times the ``trust_aggregate.cu``,
``flash_attention.cu``, ``rglru_scan.cu`` and ``selective_scan.cu`` found
in each DIR (other versions of the kernels, with the same C interface)
against this checkout's, in turns (old, new, new, old) at the main path's
and the serving paths' shapes (the fused trust kernel also at
``anomaly-fleet1k``'s), and adds those times to the kernels line.

Any failure exits non-zero before the result line.  Without a card, or
without the repository's ``src/`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import importlib
import json
import math
import os
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
HERE_CSRC = os.path.join(HERE, os.path.dirname(SOURCE))
SFU_EXP_PER_CLOCK_PER_SM = 16    # special-function units, compute cap. 9.0
L2_FLUSH_BYTES = 256 * 2 ** 20   # > 5 x the H100's 50 MB L2

# the serving paths: recurrentgemma-2b and falcon-mamba-7b at full width
ARCH = "recurrentgemma-2b"
MAMBA_ARCH = "falcon-mamba-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
CONSISTENCY_TOL = 2e-2          # tests/test_models.py's prefill/decode bound
# tests/test_kernels.py's tolerances: attention atol = rtol; the scan atol
# with rtol 0.05
FA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}

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


def other_libraries(source: str, dirs, module: str) -> dict:
    """{dir: the library built from ``dir/source``} for each of ``dirs``
    that holds ``source``, with the C signatures of this checkout's wrapper
    ``repro_torch.kernels.<module>``."""
    from repro_torch.kernels import build
    libs = {}
    for d in dirs or ():
        if not os.path.isfile(os.path.join(d, source)):
            continue
        lib = ctypes.CDLL(str(build.build(source, d)))
        for fn, argtypes in importlib.import_module(
                f"repro_torch.kernels.{module}")._signatures.items():
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
def attn_inputs(B, S, H, Kv, d, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, d), generator=g, device=dev) * 0.3
    k = torch.randn((B, S, Kv, d), generator=g, device=dev) * 0.3
    v = torch.randn((B, S, Kv, d), generator=g, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


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
    for k_, tol in (("fa", FA_TOL), ("scan", SCAN_TOL)):
        print(f"kernel check {k_}: max abs error {err[k_]} (tolerance "
              f"{tol}), {len(fa_cases if k_ == 'fa' else scan_cases)} "
              f"shapes", flush=True)
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
    return {"err": err, "t": t, "pairs": pairs, "lib_err": lib_err,
            "bound": {"fa": fa_routes[fa_route],
                      "fa_bf16": bound_ms(b_fa / 2, flops, BF16_FLOPS_PER_S),
                      "scan": bound_ms(b_scan, 2 * B * S * W),
                      "scan_bf16": bound_ms(b_scan_bf16, 2 * B * S * W)},
            "fa_routes": fa_routes, "fa_route": fa_route,
            "bytes": {"fa": b_fa, "scan": b_scan, "scan_bf16": b_scan_bf16}}


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
    check(res.tokens.shape == (SERVE_BATCH, SERVE_GEN)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size, "bad token ids")
    for lg in [res.prefill_logits] + res.decode_logits:
        check(lg.shape == (SERVE_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()), "bad logits")
    return {"res": res, "counts": counts, "seen": seen, "peak": peak}


def live_lm_check(seen) -> dict:
    """The kernels' outputs on the first LOCAL and first RG-LRU layer of
    the prefill against their plain versions on the same inputs."""
    from repro_torch.kernels import ref
    (q, k, v), kw, out = seen["flash_attention"]
    want = ref.flash_attention_ref(q, k, v, **kw)
    e_fa, ok = within(out, want, FA_TOL["float32"], FA_TOL["float32"])
    used_fa = tolerance_used(out, want, FA_TOL["float32"], FA_TOL["float32"])
    check(ok, f"flash_attention on the prefill's inputs: {e_fa}")
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


def consistency_check(res) -> float:
    """Decode of token 4096 after a 4096-token prefill against a prefill of
    all 4097 tokens (last position)."""
    full = torch.cat([res.prompts, res.tokens[:, :1]], dim=1)
    with torch.inference_mode():
        logits, _ = res.model.prefill(full, cache_len=full.shape[1])
    want = res.decode_logits[0]
    e = (logits - want).abs().max().item()
    print(f"consistency ({res.model.cfg.name}): decode at position "
          f"{SERVE_PROMPT} against a "
          f"{full.shape[1]}-token prefill: max abs error {e} (tolerance "
          f"{CONSISTENCY_TOL}), max |logit| {want.abs().max().item()}",
          flush=True)
    check(e < CONSISTENCY_TOL, f"prefill/decode disagree by {e}")
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
    t = {"ssm": time_ms(lambda: selective_scan(*args)),
         "ssm_plain": time_ms(lambda: ref.selective_scan_ref(*args), reps=1,
                              windows=3, warmup=1)}
    y = torch.empty_like(args[0])
    h = torch.empty((B, Di, N), dtype=torch.float32, device=dev)
    t["ssm_turns"] = {}
    for where, old in other_libraries(os.path.basename(SSM_SOURCE),
                                      compare_dirs, "selective_scan").items():
        def old_ssm():
            status = old.selective_scan_f32(
                *(x.data_ptr() for x in args), y.data_ptr(), h.data_ptr(),
                B, S, Di, N, torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"selective_scan of {where} failed: {status}")
        t["ssm_turns"][where] = in_turns(
            {"old": old_ssm, "new": lambda: selective_scan(*args)})
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
                      else "operations"),
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare-with", metavar="DIR", nargs="+", default=[],
                    help="time each DIR's trust_aggregate.cu, "
                         "flash_attention.cu, rglru_scan.cu and "
                         "selective_scan.cu against this checkout's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    from repro_torch.api import ControllerSpec, Federation, FederationSpec
    from repro_torch.api.scenarios import PAPER_MLP_FLEET1K
    from repro_torch.kernels import build, launches, reset_launches
    from repro_torch.configs import get_config
    dev = torch.device("cuda")

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
    build.build_all([os.path.basename(p) for p in
                     (SOURCE, FA_SOURCE, SCAN_SOURCE, SSM_SOURCE)])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({build.build_seconds})", flush=True)
    for p in (SOURCE, FA_SOURCE, SCAN_SOURCE, SSM_SOURCE):
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

    # 4b. the paper's full scheme: a DQN pretrained on the card picks a_i
    adaptive = adaptive_phase(dev)
    counts.update(adaptive.pop("counts"))
    torch.cuda.empty_cache()
    # 4c. the autoencoder-anomaly task under the same controller
    anomaly = anomaly_phase(dev, args.compare_with)
    counts.update(anomaly.pop("counts"))
    # 4d. DP, the robust rules and the fault model at full width
    robust = robust_phase(dev)
    counts.update(robust.pop("counts"))
    dense_eqn19 = dense_times(B, N, dev)
    free_library_memory()
    # 4e. the service mode: checkpointed segments, resume, a SIGKILL
    service = service_phase(dev)
    counts.update(service.pop("counts"))
    torch.cuda.empty_cache()
    # 4f. populations: B federations as one batched round, and the pool
    population = population_phase(dev)
    counts.update(population.pop("counts"))
    pk = population.pop("kernels")
    free_library_memory()
    # 4g. the paper's own entry point and evaluation
    paper = paper_phase(dev)
    counts.update(paper.pop("counts"))
    free_library_memory()
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

    # 7. the serving line, the kernels line, then the result line
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
         "max_abs_err": err["f32"], "tolerance": kp["tol"]["f32"],
         **trust_times(kp, "dense", "library"),
         "plain_ms": t["dense_plain"],
         "bound_ms": bd["f32"][0], "bound_by": bd["f32"][1],
         "shape": {"C": M, "N": N, "dtype": "float32", "mask": False},
         "bytes": kp["bytes"]["f32"]},
        {"name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
         "replaces": "src/repro/kernels/flash_attention.py:26",
         "launches": serve_launches["flash_attention"],
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
         "launches": serve_launches["rglru_scan"],
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
         "launches": serve_launches["selective_scan"],
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
    print(json.dumps({"federations": feds}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"service": {"device": smi_line, **service["service"]}}),
          flush=True)
    print(json.dumps({"population": {"device": smi_line,
                                     **population["population"]}}),
          flush=True)
    print(json.dumps({"paper": {"device": smi_line,
                                **plain_json(paper["paper"])}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
