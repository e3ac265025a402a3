#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Device: the card's name and power limit from nvidia-smi, then a build of
   all seventeen CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together).
2. Kernels: each kernel against its plain PyTorch version on integer-valued
   float32 at the shapes the main path gives it (bitwise; ``cofactor_update``
   and ``matvec`` also with values of 12 significant bits, which a product
   in TF32 or bf16 would round; ``ring_mul`` and ``outer_accumulate`` also on
   normal data; ``segment_ring_sum`` and ``cofactor_update`` also bitwise
   from run to run on normal data and at one device event a call,
   ``cofactor_update`` also on two streams at once and at m = 300 and 1001,
   where it walks pairs of bands; ``matvec`` also bitwise from run to run
   on normal data and at one device event a call in both layouts, timed in
   turns with ``torch.mv``; ``scatter_add`` also at
   a kernel-phase batch of 65,536 rows, with the wrapper's host µs a call
   beside ``index_add_``'s; ``scatter_dedup`` timed in turns with
   ``scatter_add`` and ``index_add_``, and ``fused_chain``, each with its
   wrapper's host µs and at one device event a call; ``gather_mul_scatter``
   at d = 1 and 111, with its wrapper's host µs, at one device event a
   call and bitwise from run to run on normal data whose out ids repeat
   only within a tile; ``flash_attention`` in bf16 and float32 against its
   plain version in float64, by the kernel the dispatch takes:
   ``flash_attention_wgmma`` for bf16 and ``flash_attention_tf32`` for
   float32 at D = 64 and 128, ``flash_attention``'s mma kernel at D = 16
   and 32, each with the SIMT kernel of ``flash_attention`` checked and
   timed beside it), timed with
   CUDA events and the profiler beside its plain version, a one-call
   PyTorch yardstick (``library_ms``, never used by the port) and its
   bound (float32 flash rows also ``tc_bound_ms``, as three TF32 products
   on the tensor cores; rows at D <= 32 also ``exp_bound_ms``, the
   exponentials at the MUFU rate).  The hash kernels of sparse view storage,
   ``hash_probe`` and ``hash_insert``, bitwise against the reference's
   loops written in torch (their plain versions) at S3's table (8,192
   slots, 3,072 keys, 1,000 ids), at a table that fills up and at a rehash
   into 2^17 slots: the insert by the route the wrapper picks for the
   shape (cta up to 16,384 slots, else global) with its rounds; at S3's
   shape also ``hash_insert_targets`` (a raw
   batch with repeated ids; by ids and keyed) and the keyed probe, each
   beside the rank prepass or linearize-and-probe composition it replaces
   (device events and ms), and a sparse relation's claim and sibling
   gather at one device event each; bound: ids (key columns) and chain
   words at the measured mean chain length, results written.
3. Paths, each through ``IVMEngine.apply_update`` (fivm, ``auto`` storage,
   which keeps every retailer view dense; checked) at
   ``RETAILER_DOMS_BIG`` with batches of 1000 tuples, checked against a
   float64 re-evaluation, with every kernel's launch count reset before
   and read after it:
   - the retailer sum-aggregate and degree-m cofactor (m = 10) streams with
     plan fusion off (``scatter_add``, ``segment_ring_sum``,
     ``gather_mul_scatter``), 20 batches each;
   - the same two streams with fusion ``auto`` (on, on the card), where
     every fused chain is one ``fused_chain`` launch, 20 batches each;
   - a short sum stream under the ``scatter_dedup`` ⊎ backend;
   - beside the unfused and fused sum streams and the fused cofactor
     stream, an executor leg: the same stream through
     ``StreamExecutor`` (rounds mode, a period of 5, 4 rounds, each round
     one CUDA graph) on a fresh engine, a capture run and two replay-only
     runs (one under ``set_sync_debug_mode("error")``, one profiled),
     with capture seconds, host µs a replay, launches a batch (replays
     included), device busy against wall and peak bytes, held to the
     oracle after the stream three times.
   Then sparse view storage, the housing star at ``HOUSING_DOMS_BIG``
   (pc = 65,536) with ``auto`` storage (``HOUSING_LEGS``), each leg eager
   (growth included), profiled, and through the stream executor, against
   the float64 oracle, with view bytes sparse and dense, peak bytes,
   tuples/s, launches a batch (by hash entry and insert route too) and
   device events a batch; every sparse read must take the keyed probe:
   - S1, the reference's scenario: the sum ring, 512 active postcodes,
     10 batches of 64, fusion off and ``auto``; the plan must be the
     reference's (six tables of 2,048 slots, ``V7@pc`` dense) and every
     view bitwise equal to a dense-storage engine's;
   - S2, growth: 20 batches of 1000 from 4,096 postcodes; the eager tables
     grow through ``grow_if_loaded``, the executor's through capacity
     segments with a rehash between them, capacities reported before and
     after, views bitwise equal;
   - S3, full width: the degree-8 cofactor ring (d = 73), 3,072 active
     postcodes, 20 batches of 1000; the executor captures, then replays a
     second stream of the signature with 0 eager steps under
     ``set_sync_debug_mode("error")``.
   Then the cyclic and conjunctive queries (paper Secs. 6 and 7.3):
   - ``triangle`` (Fig. 11): R(A,B), S(B,C), T(C,A) at n = 4,096 a
     variable (density 3/n), the degree-3 cofactor ring, 20 batches of
     1000 distinct keys; ``fivm`` with indicator projections, ``fivm``
     without and ``dbt`` with, each with its launches held to its plans'
     (``plan_launches``), every view to the float64 oracle, its indicator
     counts and plane to a recount (bitwise), profiled; the roots against
     each other; then the ``fivm``-with-indicators stream through the
     executor (capture, a replay-only run of 999/1000-row batches under
     ``set_sync_debug_mode("error")``, a profiled replay), each run's
     state against the eager engine's;
   - ``conjunctive`` (Fig. 13): the factorized engine (premarg ``W:``
     views) at pc = 65,536, 20 batches of 1000 distinct-key ±1 updates,
     launches against its plans and every view bitwise to a float64
     numpy recount; at pc = 32 the enumeration of its ``W:`` payloads
     against the host listing engine (``PyIVM``) and a brute force.
   Then the stream executor's durability and integrity planes (snapshots
   under ``build/snapshots``, removed by each phase), every leg's launches
   held to the plans (``plan_launches``; ``segment_launches`` adds the
   rehashes between capacity segments; D2 to the same segments without
   snapshots), every compared state leaf bitwise (a leaf above 2²⁴ within
   1e-5):
   - ``durable``: D1, the retailer sum stream with fusion ``auto`` through
     the executor with ``StreamCheckpointer(keep=3, segment_updates=5)``
     and without (the same 4 segments), in turns, with the dispatch and
     writer seconds of each save, the snapshot bytes, the synchronising
     calls of a run with and without snapshots and of a non-final save
     (0), a restore, and a ``mid_segment`` fault then ``resume`` on a
     fresh engine; D2, S2's growing housing stream: faults at
     ``mid_admit``, ``post_rehash_pre_recompile``, ``mid_checkpoint_write``
     and ``mid_segment``, a bit flip in the newest snapshot (quarantined on
     resume) and a child process killed by ``SIGKILL`` mid-segment, each
     resumed on a fresh engine to the uninterrupted run's leaves,
     capacities and occupancy;
   - ``integrity``: I1, the reference's integrity leg (housing pc =
     65,536, 512 active, 12 × 512): ``off``, ``validate`` and ``audit``
     executors in turns, then a poisoned stream (NaN, +inf, pc = 65,536, a
     key of -1, a batch of float keys): under ``quarantine`` bitwise to the
     masked clean stream with exactly the planted dead letters and an
     admission that never synchronises, under ``strict`` stopped at update
     2 with nothing committed; I2, the degree-10 cofactor stream with two
     audits at the full state, then drift put into the root between
     segments, repaired in place at the next audit (the next segment
     replays) to within 1e-5 of float64; I3, ``StreamSupervisor`` over D1
     with a fault (one restart) and over I1's poisoned stream under
     ``strict`` (escalated to ``quarantine_batch``).
   Then the serving plane (``repro_torch.serve``) against running
   segmented streams, the reference's serving bench on the card:
   - ``serve`` R1, reads: S1's engine served from its widest ``pc``-keyed
     view as a hash table (``auto``) and dense, every read path of the
     sparse view bitwise to the dense view's, a sparse point read one
     keyed ``hash_probe`` launch, 0 synchronising calls a read path and a
     publish, lookups/s at batches of 64, 1024 and 8192 keys and p50 / p95
     / p99 ms of 200 reads of 256 keys;
   - R2, updates under read load: I1's housing stream and a 12 × 64
     degree-10 cofactor stream through ``ViewServer(segment_updates=4)``,
     with and without a reader thread on its own CUDA stream (256 keys
     every 10 ms), interleaved best of 5, launches held to the plans,
     loaded / unloaded tuples/s beside the reference's 0.9 gate (reported,
     not enforced), reads/s, publish seconds;
   - R3, consistency: every generation of both streams under ``pin(g)``
     equal to a fresh engine replayed to its offset, then D2's growing
     stream with a ``mid_segment`` fault and an in-process ``resume``
     while a reader thread reads every generation it sees, each equal to
     an offline recompute at its offset.
4. The kernel-ops layer's paths, counts reset before and read after each:
   - B, the ring product on engine state: ``ops.ring_mul`` of the largest
     view (1,179,648 keys, degree 10) of the two cofactor engines above,
     bitwise against ``DegreeMRing.mul`` and against a float64 product
     (``ring_mul``);
   - A, streaming statistics: ``RunningCofactor`` (m = 32) fed 20 batches
     of 65,536 rows, the last retracted, its derived statistics and a ridge
     solve against float64 (``cofactor_update``);
   - C, rank-1 matrix-chain deltas: 16 ``ops.rank1_chain_update`` calls on
     V = A1 A2 A3 at n = 8192 against float64 (``matvec``,
     ``outer_accumulate``);
   - chain_engine, the same chain through the engine: the same matrices
     in ``matrix_chain.build_chain_engine`` (A2 updatable), 16 rank-1
     updates and one row update through ``IVMEngine.apply_update``, each a
     factorized trigger whose joins launch ``matvec`` and whose ⊎ launches
     ``outer_accumulate`` as often as its plan says, against float64 A1 (A2
     + Σ u vᵀ) A3, with host ms an update beside path C's and peak bytes;
     then an integer-valued chain at n = 512 on the card and on the CPU
     (every view bitwise) and sparse storage against dense under integer
     row updates (bitwise).
5. Path D, LM serving: llama3.2-1b at full width and depth, weights drawn
   from a seeded ``torch.Generator`` on the card, 4 prompts of 1024 tokens
   (flash attention in every prefill layer).  (i) In float32
   (``flash_attention_tf32``), the prefill and two decode steps against a
   float64 forward written here, then the same for the reduced config, 2
   prompts of 64 tokens at head dim 16 (``flash_attention``'s mma kernel);
   (ii) in bf16 (``flash_attention_wgmma``),
   ``Server.generate`` of 32 tokens, timed, with the first decode step held
   to a bf16 prefill over the extended prompt and the decode loop
   profiled.
6. Path E, LM training (``launch/train.py``, ``optim/``, ``lm_loss``; the
   attention gradient is ``flash_attention_bwd``, hand kernels with no
   Pallas original: at head dim 64 or 128 ``flash_attention_bwd_wgmma``
   for bf16 and ``flash_attention_bwd_tf32`` for float32,
   ``flash_attention_bwd``'s SIMT kernels otherwise):
   - E1, ``flash_attention_bwd`` against its plain version in float64
     (``BWD_CASES``: llama3.2-1b's microbatch attention in float32 and
     bf16, causal and not; head dims 16 and 128, G 1 and 4, T 100 and 257;
     moonshot-v1-16b-a3b's (4, 16, 16, 1024, 128) in both dtypes), two
     calls bitwise equal, given the forward's L where ``lse_route`` holds
     and without it beside (``no_lse``), timed beside the plain version,
     SDPA's backward and its bounds (float32 rows also ``tc_bound_ms``,
     three TF32 terms; every row ``exp_bound_ms``, two exp2 passes); at
     ``BWD_MAIN`` and ``BWD_MAIN_F32`` the SIMT route timed by name beside
     the wgmma and the tf32 route; then path K's attention shapes in both
     dtypes (``cross_attention_rows``): the forward writing L at the
     encoder's (4 × 1024 frames, non-causal), the decoder's self-attention
     (4 × 128 tokens, causal) and the cross-attention's (``CROSS_SHAPE``:
     the 128 queries against 1024 frames, non-causal), and the backward
     given L at the cross shape, each against float64 beside SDPA;
   - E2, one ``make_train_step`` at llama3.2-1b's widths and 2 layers in
     float32 (TF32 forward, the TF32 backward) against the same port
     functions in float64 through the plain attention: loss, gradients,
     post-AdamW parameters; then the step's ms and one profiled step
     (device busy, idle share);
   - E3, llama3.2-1b at full width and depth, bf16, remat ``full``, 6 steps
     of ``run_training`` at 8 × 1024 (2 microbatches): step ms, tokens/s,
     peak bytes, flash launches a step (64 forward, 32 backward), one
     profiled step;
   - E4, the reduced config 10 steps straight against 5 + a resume
     (the last loss equal), then ``repro_torch.examples.train_lm --tiny``
     (``cofactor_update`` a batch, its loss falling).
7. Path F, moonshot-v1-16b-a3b (``models/moe.py``: the router, the
   sort-based capacity dispatch, routed and shared experts; no hand kernel
   of its own, the flash kernels at head dim 128):
   - its attention shape (4, 16, 16, 1024, 128) bf16: the wgmma forward and
     backward beside SDPA's;
   - F1, float32 at full width and 2 layers (the TF32 flash kernel) and the
     reduced config (the mma kernel): prefill and two decode steps against
     the same functions in float64 replaying the float32 run's routing (the
     logits and every cache leaf, as every ``float64_leg``);
     dropped slots and the float64 router's other choices counted; the
     reduced decode also against its own prefill;
   - F2, bf16 at full width and all 48 layers through ``Server.generate``
     (4 × 1024 tokens, 32 new): prefill and decode ms, tokens/s, peak bytes,
     idle share, device ms by part of the MoE MLP;
   - F3, bf16 at full width and 2 layers: 4 steps of ``run_training`` at
     8 × 1024 tokens, a profiled step, one step twice from one state,
     bitwise equal.
8. Path G, deepseek-v3-671b (``models/attention.py``'s MLA: q and k of 128
   + 64 columns, v of 128, a latent cache and the absorbed decode; the
   flash kernels at the head-dim pair (192, 128), the reduced config's
   (16, 8)), after path F's memory is released:
   - the G rows: ``flash_attention_wgmma`` at (4, 128, 128, 1024, 192→128)
     bf16, ``flash_attention_tf32`` at (1, 128, 128, 1024, 192→128) float32
     and the mma kernel at (2, 4, 4, 64, 16→8) in both dtypes, each against
     its plain version in float64 (the equal-dim rows' gates), timed beside
     SDPA with its bound; the G backward rows: ``flash_attention_bwd`` at
     the wgmma shape in bf16, the tf32 shape in float32 and (2, 4, 4, 64,
     16→8) in both dtypes (the SIMT route), as E1's rows (``--backward``
     runs them too);
   - G1, float32 against float64: the MLA module alone at full width (2 ×
     512 tokens through the TF32 kernel, then 2 absorbed decode steps), and
     the reduced model as F1 runs moonshot's (its own prefill too);
   - G2, bf16 at full width and 1 of 61 layers (49.95 GB of parameters;
     two layers would not fit) through ``Server.generate`` (4 × 1024
     tokens, 32 new), as F2: one wgmma launch a prefill, none a decode
     step, the tokens repeated;
   - after G2's memory is released, G3: the full-width MLA module's
     gradient, float32 at 2 × 512 against float64 (one tf32 forward and
     one tf32 backward call), then bf16 at 4 × 1024 (a wgmma forward and
     backward call a step: ms a step, peak bytes, the backward's device ms,
     two steps bitwise);
   - G4: the reduced deepseek (MLA (16, 8), MoE, MTP head) trains: E2's
     float32 step against float64 replaying the float32 run's routing,
     repeated bitwise (as every ``train_step_check``), then bf16
     ``run_training`` steps, one repeated bitwise.
9. Paths H and J, the SSM and hybrid models (``models/ssm.py``: Mamba's
   chunked selective scan, the chunkwise mLSTM, the sLSTM's loop over time;
   no hand kernel of their own, as the reference's scans are ``lax`` code
   outside Pallas), after path G's memory is released:
   - H1, xlstm-1.3b at full width and depth in float32, 2 × 256 tokens:
     prefill and two decode steps against the same functions in float64;
   - H2, xlstm-1.3b at full width and depth in bf16 through
     ``Server.generate`` (4 × 512 tokens, 32 new: the sLSTM's loop made
     F2's 1024 too slow), as F2, with the prefill's device ms by mixer
     (``mixer_profile``);
   - J1, jamba-v0.1-52b's Mamba block and its attention block (GQA at head
     dim 128: one ``flash_attention_tf32`` launch; the MoE MLP) at full
     width in float32, 1 × 512 tokens and two decode steps, and the reduced
     jamba whole (the mma kernel) with 12 decode steps across its 32-slot
     ring buffer's wrap, each against float64;
   - J2, jamba at full width in bf16 at 2 of its 4 periods (16 of 32
     layers) through ``Server.generate`` (4 × 1024 tokens, 32 new): one
     ``flash_attention_wgmma`` launch an attention layer in the prefill,
     none in a decode step, the prefill's device ms by mixer;
   - H3 and J3, the reduced xlstm and jamba: G4's float32 train step
     against float64 (``train_step_check``), repeated bitwise.
10. Path K, seamless-m4t-large-v2, the encoder-decoder (``models/encdec.py``:
    24 bidirectional encoder layers over 1024 stub audio frames, 24 causal
    decoder layers each with cross-attention over the frames, query length
    other than key length; the flash kernels non-causal there), after path
    J's memory is released (``--encdec`` runs it alone):
   - K1, float32 at full width and depth (2.04 B parameters), 2 × 256
     tokens over 1024 frames: prefill and two decode steps against the same
     functions in float64, the logits and every cache leaf; 72
     ``flash_attention_tf32`` launches a prefill, none a decode step;
   - K2, bf16 at full width and depth through ``Server.generate`` (4 × 128
     tokens over 1024 frames, 64 new, a cache of 192): 72
     ``flash_attention_wgmma`` launches a prefill, none a decode step;
     prefill and decode ms, tokens/s, peak bytes, idle share, the prefill's
     device ms by stack (encoder, decoder), a second run's tokens equal;
   - K3, the reduced config (head dim 16: the mma forward and the SIMT
     backward; cross shape Tq 24 against Tk 16): G4's float32 AdamW step
     against float64 (``train_step_check``), repeated bitwise, then a
     prefill of 24 tokens and 3 decode steps against float64.
11. Path L, paligemma-3b, the VLM (``models/lm.py``: 256 stub patch
    embeddings times ``vision_proj`` in front of the text, the prefix-LM
    mask, head dim 256, 8 query heads over 1 KV head), after path K's
    memory is released (``--vlm`` runs it alone, after E1's prefix rows):
   - L1, float32 at full width and depth (2.51 B parameters), 2 × (256
     patches + 64 tokens): prefill and two decode steps (at positions
     P + T, …) against the same functions in float64, the logits and every
     cache leaf; 18 ``flash_attention_tf32`` launches (256, 256) with the
     prefix a prefill, none a decode step;
   - L2, bf16 at full width and depth through ``Server.generate`` (4 ×
     (256 + 128), 32 new, a cache of 416): 18 ``flash_attention_wgmma``
     launches a prefill, none a decode step; prefill and decode ms,
     tokens/s, peak bytes, idle share, the prefill's device ms by part
     (``VLM_PARTS``), a second run's tokens equal;
   - L3, the reduced config (head dim 16, 16 patches: the mma forward and
     the SIMT backward with the prefix): G4's float32 AdamW step against
     float64 (``train_step_check``), repeated bitwise, then a prefill of 16
     patches + 24 tokens and 3 decode steps against float64.
   E1 holds the prefix-LM rows (``vlm_attention_rows``): the forward at
   VLM_FWD_CASES in both dtypes and the SIMT backward at L3's step shape,
   each against float64 beside SDPA with an explicit boolean mask.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel with its numbers.  Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
BATCH = 1000
N_BATCHES = 20
SEED = 0
REPS = 50
#: the f32 engine is held to the f64 oracle bitwise where every oracle
#: value of a view is below 2**24 (each sum is then exact in float32);
#: otherwise within RTOL of the view's largest magnitude, because float32
#: sums of that size round at ~6e-8 per add and the engine adds in another
#: order than the oracle (einsum blocking, atomics).  One lost or doubled
#: batch of 1000 tuples moves these views by >= 3e-4 of their magnitude.
EXACT_LIMIT = 2.0 ** 24
RTOL = 1e-5


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


class Laps:
    """Logs the host seconds each phase of the script takes, so that the
    time the script grows by shows where it went."""

    def __init__(self):
        self.last = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        log({"phase": phase, "seconds": now - self.last})
        self.last = now


def time_ms(fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call over ``reps`` calls, each
    between its own pair of CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_in_turns(fns: dict) -> dict:
    """``time_ms`` of each function in ``fns``, measured twice in turns
    (each in order, then each in reverse order), averaged: drift of the
    host or the card over the measurement falls on all of them alike."""
    times: dict = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(time_ms(fns[name]))
    return {name: statistics.mean(t) for name, t in times.items()}


#: the marker kernel that opens and closes each profiled window
#: (``torch.cuda._sleep``), and its length in cycles
MARKER, MARKER_CYCLES = "spin_kernel", 1000


def device_events(fn, calls: int):
    """Device-side events (kernels, copies) of ``calls`` calls of ``fn``
    under torch.profiler, and the host wall seconds of those calls.  A
    marker kernel, run and waited for, opens the window and another closes
    it, and both are dropped from the list: on the H100 the profiler was
    seen to leave out one kernel at the edge of a window (19 of 20 launches
    listed; with the markers every launch, and one of the two markers),
    and at times every kernel of a window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and MARKER not in e.name], wall


def _busy(events, wall) -> dict:
    """Device busy time against host wall time (the device's idle share),
    device events and the heaviest kernels of a profiled run."""
    return _busy_of([(e.name, e.time_range.elapsed_us() / 1e3) for e in events], wall)


def _busy_of(kernels, wall) -> dict:
    """``_busy`` of (name, device ms) pairs."""
    by_name: dict = {}
    for name, ms in kernels:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, n + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(wall_ms=1e3 * wall, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (1e3 * wall),
                device_events=sum(n for _, n in by_name.values()),
                top=[[name[:90], ms, n] for name, (ms, n) in top])


#: profiled windows a launch count or a kernel's device time may take: the
#: profiler at times lists no kernel, or not all, of a window (see
#: ``device_events``; in one run five windows in a row listed 0, 9, 0, 0
#: and 15 of 20 matvec launches), and then the window is profiled again.
#: A window that lists every launch must still list nothing else.
WINDOWS = 10


def listed_launches(fn, kernel: str, calls: int, label: str):
    """The device events of the first of up to WINDOWS profiled windows of
    ``calls`` calls of ``fn`` that lists ``calls`` kernels whose names hold
    ``kernel`` (else of the last window), and the windows it took; logs the
    counts when it took more than one."""
    counts = []
    for _ in range(WINDOWS):
        events, _ = device_events(fn, calls)
        counts.append(sum(kernel in e.name for e in events))
        if counts[-1] == calls:
            break
    if len(counts) > 1:
        log({"profiler_windows": label, "kernels_listed": counts, "calls": calls})
    return events, len(counts)


def check_one_launch(label: str, fn, kernel: str, wrapper, calls: int = 20) -> float:
    """Raise unless ``calls`` calls of ``fn`` launch the kernel object
    ``wrapper`` ``calls`` times in every window (its count) and a window
    lists nothing on the device but ``calls`` kernels whose names hold
    ``kernel``.  Returns the device events a call (1.0)."""
    before = wrapper.launches
    events, windows = listed_launches(fn, kernel, calls, label)
    launched = wrapper.launches - before
    if launched != calls * windows or len(events) != calls or \
            not all(kernel in e.name for e in events):
        names = sorted({e.name[:60] for e in events})
        raise AssertionError(f"{label}: {launched} launches in {windows} windows and "
                             f"{len(events)} device events {names} for {calls} calls a "
                             f"window, expected one {kernel} kernel a call")
    return len(events) / calls


def kernel_device_ms(fn, kernel: str, calls: int = 20):
    """Mean device time of the CUDA kernel named ``kernel`` per call of
    ``fn`` (the kernel alone, without launch gaps), from a window that
    lists it ``calls`` times (``listed_launches``); None when none did."""
    events, _ = listed_launches(fn, kernel, calls, f"device ms of {kernel}")
    mine = [e for e in events if kernel in e.name]
    if len(mine) != calls:
        return None
    return sum(e.time_range.elapsed_us() for e in mine) / 1e3 / calls


def trace_kernels(fn, kernel: str, calls: int = 20) -> list:
    """The kernel records of the profiler's exported trace (CUPTI's, with
    each launch's ``grid`` and ``block``) whose names hold ``kernel``, in a
    window of ``calls`` calls of ``fn`` opened and closed by marker kernels
    as in ``device_events``: the first of up to WINDOWS windows that lists
    some (else none).  The trace is written under the checkout's build/ and
    removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(__file__).resolve().parent / "build" / "profiler_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        records = [e for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "kernel" and kernel in e.get("name", "")]
        path.unlink()
        if records:
            return records
    return []


def all_device_ms(fn, calls: int = 20):
    """Mean device time of every kernel and copy ``fn`` runs, per call (a
    library call may take more than one kernel), from the first of up to
    WINDOWS windows that lists any device event (the profiler at times lists
    none; see ``device_events``); None when none did."""
    for _ in range(WINDOWS):
        events, _ = device_events(fn, calls)
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls
    return None


def bound_ms(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S
             ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ints(rng, shape, lo=-4, hi=5):
    import torch

    return torch.tensor(rng.integers(lo, hi, size=shape).astype(np.float32),
                        device="cuda")


def ids_tensor(arr):
    import torch

    return torch.tensor(np.asarray(arr).astype(np.int32), device="cuda")


def check_equal(name: str, got, want) -> float:
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(rng, laps: Laps) -> dict:
    import torch
    from repro_torch.kernels import ref, scatter_ops
    from repro_torch.kernels.ring_scatter import scatter_add
    from repro_torch.kernels.segment_ring_sum import SEGMENT_RING_SUM, segment_ring_sum

    rows = {"scatter_add": [], "segment_ring_sum": [], "gather_mul_scatter": [],
            "scatter_dedup": [], "fused_chain": []}
    B = BATCH

    for S in (256, 6144, 1_179_648):
        for d in (1, 111):
            view = ints(rng, (S, d))
            vals = ints(rng, (B, d))
            ids_np = rng.integers(0, S, size=B)
            # correctness: padding (-1) and out-of-range rows must drop
            pad_np = ids_np.copy()
            pad_np[:8], pad_np[8:16] = -1, S + 3
            err = check_equal(
                f"scatter_add S={S} d={d}",
                scatter_add(view.clone(), ids_tensor(pad_np), vals),
                ref.scatter_add_ref(view.clone(), ids_tensor(pad_np), vals))
            ids = ids_tensor(ids_np)
            row = scatter_add_row(S, d, B, ids_np, ids, vals, view, err)
            work = view.clone()
            # the two ⊎ paths the dispatch chooses between at this shape
            row.update(
                path_scatter_ms=time_ms(lambda: scatter_ops.scatter_add_flat(
                    work, ids, vals, backend="scatter")),
                path_compact_ms=time_ms(lambda: scatter_ops.scatter_add_flat(
                    work, ids, vals, backend="compact")))
            rows["scatter_add"].append(row)
            log({"kernel": "scatter_add", **row})
            del view, work

    # a kernel-phase batch, where the device time is no longer the launch
    # floor: B = 65,536 rows of d = 111 (29 MB of values) into the path view
    S, d, Bk = 1_179_648, 111, 65_536
    view, vals = ints(rng, (S, d)), ints(rng, (Bk, d))
    ids_np = rng.integers(0, S, size=Bk)
    pad_np = ids_np.copy()
    pad_np[:8], pad_np[8:16] = -1, S + 3
    err = check_equal(f"scatter_add S={S} d={d} B={Bk}",
                      scatter_add(view.clone(), ids_tensor(pad_np), vals),
                      ref.scatter_add_ref(view.clone(), ids_tensor(pad_np), vals))
    row = scatter_add_row(S, d, Bk, ids_np, ids_tensor(ids_np), vals, view, err)
    rows["scatter_add"].append(row)
    log({"kernel": "scatter_add", **row})
    del view, vals

    # the compact ⊎ path's shapes (S = B, local ranks of the batch's keys),
    # and B = S = 65,536, past where streaming all ids in every block pays
    for Bs, d in ((B, 1), (B, 111), (65_536, 111)):
        keys = rng.integers(0, max(6144, 4 * Bs), size=Bs)
        rank_np = np.unique(keys, return_inverse=True)[1]
        vals = ints(rng, (Bs, d))
        ids = ids_tensor(rank_np)
        pad = ids.clone()
        pad[:8] = -1
        pad[8:16] = Bs + 3
        err = check_equal(f"segment_ring_sum B={Bs} d={d}",
                          segment_ring_sum(vals, pad, Bs),
                          ref.segment_ring_sum_ref(vals, pad, Bs))
        # normal data: the same bits on every run (no atomics, row order)
        nvals = normal(rng, (Bs, d))
        first = segment_ring_sum(nvals, ids, Bs)
        for _ in range(3):
            if not torch.equal(segment_ring_sum(nvals, ids, Bs), first):
                raise AssertionError(f"segment_ring_sum B={Bs} d={d}: two runs "
                                     f"on the same normal data differ")
        events_a_call = check_one_launch(f"segment_ring_sum B={Bs} d={d}",
                                         lambda: segment_ring_sum(vals, ids, Bs),
                                         "segment_ring_sum", SEGMENT_RING_SUM)
        ids64 = ids.long()
        bms, by = bound_ms(Bs * 4 + Bs * d * 4 + Bs * d * 4, Bs * d)
        # kernel and library in turns: at B = 1000 both are host-bound
        turns = time_in_turns({
            "kernel": lambda: segment_ring_sum(vals, ids, Bs),
            "library": lambda: torch.zeros((Bs, d), device="cuda").index_add_(
                0, ids64, vals)})
        row = dict(
            shape=dict(S=Bs, d=d, B=Bs), max_abs_err=err,
            device_events_per_call=events_a_call,
            kernel_ms=turns["kernel"],
            device_ms=kernel_device_ms(lambda: segment_ring_sum(vals, ids, Bs),
                                       "segment_ring_sum_kernel"),
            plain_ms=time_ms(lambda: ref.segment_ring_sum_ref(vals, ids, Bs)),
            library_ms=turns["library"],
            bound_ms=bms, bound_by=by)
        rows["segment_ring_sum"].append(row)
        log({"kernel": "segment_ring_sum", **row})

    for S, Sg, d in GMS_SHAPES:
        rows["gather_mul_scatter"].append(gather_mul_scatter_row(rng, S, Sg, d))

    laps.lap("kernels: scatter_add, segment_ring_sum, gather_mul_scatter")
    scatter_dedup_rows(rng, rows["scatter_dedup"])
    fused_chain_rows(rng, rows["fused_chain"])
    laps.lap("kernels: scatter_dedup, fused_chain")
    rows.update(cofactor_update=[], ring_mul=[], matvec=[], outer_accumulate=[])
    ops_kernel_rows(rng, rows)
    laps.lap("kernels: cofactor_update, ring_mul, matvec, outer_accumulate")
    rows.update(flash_attention=[], flash_attention_wgmma=[], flash_attention_tf32=[])
    flash_attention_rows(rng, rows)
    laps.lap("kernels: flash attention")
    return rows


#: gather_mul_scatter shapes (S, Sg, d): the unfused sum stream's fused
#: gather-⊗-⊎ sites at RETAILER_DOMS_BIG (the summary shape is (96, 9216,
#: 1)), and the same gather at the degree-10 ring's width
GMS_SHAPES = ((96, 32, 1), (96, 9216, 1), (9216, 128, 1), (96, 9216, 111))


def tile_local_ids(rng, B: int, T: int):
    """(S, out ids) whose duplicates fall within one tile of T rows: tile t
    draws from ids 4t .. 4t + 3; 8 rows are padding (-1)."""
    ids = 4 * (np.arange(B) // T) + rng.integers(0, 4, size=B)
    ids[rng.permutation(B)[:8]] = -1
    return 4 * (-(-B // T)), ids


def gather_mul_scatter_row(rng, S: int, Sg: int, d: int) -> dict:
    """``gather_mul_scatter`` at one shape: bitwise against its plain
    version on integer data with padding rows (out id -1; gather id -1
    under scale 0, clamped); bitwise from run to run on normal data whose
    out ids repeat only within a tile (a fixed order in the tile, one add a
    tile's id into the view); one device event a call; events ms, device
    ms, the wrapper's host µs a call, the plain version and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_scatter import (GATHER_MUL_SCATTER,
                                                  gather_mul_scatter, tile_rows)

    B = BATCH
    view = ints(rng, (S, d))
    src = ints(rng, (Sg, d))
    out_np = rng.integers(0, S, size=B)
    in_np = rng.integers(0, Sg, size=B)
    scale = ints(rng, (B,), -1, 2)
    # padding: out_id -1 drops; in_id -1 clamps to row 0 under scale 0
    out_pad, in_pad, scale_pad = out_np.copy(), in_np.copy(), scale.clone()
    out_pad[:8] = -1
    in_pad[8:16] = -1
    scale_pad[8:16] = 0.0
    label = f"gather_mul_scatter S={S} Sg={Sg} d={d}"
    err = check_equal(
        label,
        gather_mul_scatter(view.clone(), ids_tensor(out_pad), src,
                           ids_tensor(in_pad), scale_pad),
        ref.gather_mul_scatter_ref(view.clone(), ids_tensor(out_pad), src,
                                   ids_tensor(in_pad), scale_pad))
    # normal data, out ids repeating only within a tile: the same bits on
    # every run
    St, tile_ids = tile_local_ids(rng, B, tile_rows(d))
    nview, nsrc, nscale = normal(rng, (St, d)), normal(rng, (Sg, d)), normal(rng, (B,))
    t_out, t_in = ids_tensor(tile_ids), ids_tensor(rng.integers(-2, Sg + 2, size=B))
    first = gather_mul_scatter(nview.clone(), t_out, nsrc, t_in, nscale)
    for _ in range(3):
        if not torch.equal(gather_mul_scatter(nview.clone(), t_out, nsrc, t_in, nscale),
                           first):
            raise AssertionError(f"{label}: two runs on the same normal data differ")
    del nview, nsrc, first
    out_ids, in_ids = ids_tensor(out_np), ids_tensor(in_np)
    work = view.clone()

    def run():
        gather_mul_scatter(work, out_ids, src, in_ids, scale)

    u_in, u_out = len(np.unique(in_np)), len(np.unique(out_np))
    bms, by = bound_ms(3 * B * 4 + u_in * d * 4 + 2 * u_out * d * 4, 2 * B * d)
    row = dict(
        shape=dict(S=S, Sg=Sg, d=d, B=B), max_abs_err=err,
        device_events_per_call=check_one_launch(label, run, "gather_mul_scatter_kernel",
                                                GATHER_MUL_SCATTER),
        kernel_ms=time_ms(run),
        device_ms=kernel_device_ms(run, "gather_mul_scatter_kernel"),
        host_us=host_us(run),
        plain_ms=time_ms(lambda: ref.gather_mul_scatter_ref(
            work, out_ids, src, in_ids, scale)),
        # no single PyTorch call gathers, scales and scatters
        library_ms=None,
        bound_ms=bms, bound_by=by)
    log({"kernel": "gather_mul_scatter", **row})
    return row


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one ``fn()`` call in µs: ``calls`` calls enqueued back
    to back, timed on the host clock before the closing synchronise (the
    wrapper's own cost, where the device keeps up)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def scatter_add_row(S, d, B, ids_np, ids, vals, view, err) -> dict:
    """``scatter_add``'s numbers at one shape: the kernel and ``index_add_``
    timed in turns (events ms) and under the profiler (device ms), the
    wrapper's host µs a call, the plain version and the bytes bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_scatter import scatter_add

    ids64 = ids.long()
    work = view.clone()
    u = len(np.unique(ids_np))
    bms, by = bound_ms(B * 4 + B * d * 4 + 2 * u * d * 4, B * d)
    turns = time_in_turns({
        "kernel": lambda: scatter_add(work, ids, vals),
        "library": lambda: work.index_add_(0, ids64, vals)})
    return dict(
        shape=dict(S=S, d=d, B=B), max_abs_err=err,
        kernel_ms=turns["kernel"],
        device_ms=kernel_device_ms(lambda: scatter_add(work, ids, vals),
                                   "scatter_add_kernel"),
        host_us=host_us(lambda: scatter_add(work, ids, vals)),
        plain_ms=time_ms(lambda: ref.scatter_add_ref(work, ids, vals)),
        library_ms=turns["library"],
        library_device_ms=all_device_ms(lambda: work.index_add_(0, ids64, vals)),
        library_host_us=host_us(lambda: work.index_add_(0, ids64, vals)),
        bound_ms=bms, bound_by=by)


def normal(rng, shape):
    import torch

    return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                        device="cuda")


def wide_values(rng, n: int):
    """n odd integers of 12 significant bits (±2049..±3001): exact in
    float32, rounded by TF32, bf16 or fp16."""
    import torch

    vals = rng.integers(1024, 1501, size=n) * 2 + 1
    return torch.tensor((vals * rng.choice([-1, 1], size=n)).astype(np.float32),
                        device="cuda")


def widen(rng, x, w) -> None:
    """Put one ``wide_values`` entry into each column of x [B, m] (row
    j·(B // m) of column j, weight 1), so that every s[j] and every row
    and column of Q takes a product that reduced precision would round.
    The sums stay exact in float32 for B <= 262,144 and |x| <= 4 elsewhere:
    Q[j, j] <= 3001² + 16·B < 2**24."""
    import torch

    B, m = x.shape
    cols = torch.arange(m, device="cuda")
    x[cols * (B // m), cols] = wide_values(rng, m)
    w[cols * (B // m)] = 1.0


def check_cofactor_repeats(rng, B: int, m: int) -> None:
    """``cofactor_update`` on normal data gives the same bits on every call
    (fixed summation order, no atomics on the data), and agrees with a
    float64 sum within float32 summation error."""
    import torch
    from repro_torch.kernels.cofactor_update import cofactor_update

    x, w = normal(rng, (B, m)), normal(rng, (B,))
    first = [t.clone() for t in cofactor_update(x, w)]
    for _ in range(3):
        again = cofactor_update(x, w)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"cofactor_update B={B} m={m}: two calls on the "
                                 f"same normal data differ")
    x64, w64 = x.double(), w.double()
    xw64 = x64 * w64[:, None]
    want = (w64.sum().reshape(1), xw64.sum(0), xw64.T @ x64)
    mags = (w64.abs().sum().reshape(1), xw64.abs().sum(0), xw64.abs().T @ x64.abs())
    for name, g, r, mag in zip("csQ", first, want, mags):
        # each of at most B + 2 adds rounds at 2⁻²⁴ of a partial sum
        if not bool(((g.double() - r).abs() <= (B + 2) * 2.0 ** -24 * mag).all()):
            raise AssertionError(f"cofactor_update B={B} m={m} normal {name}: "
                                 f"beyond float32 summation error")


def check_cofactor_two_streams(rng) -> None:
    """Calls on two streams at once, 20 rounds, each result equal to the
    same call alone: each stream's scratch (and ticket counters) is its
    own."""
    import torch
    from repro_torch.kernels import cofactor_update as tcof

    B, m = STATS_B, STATS_M
    xs = [normal(rng, (B, m)) for _ in range(2)]
    w = normal(rng, (B,))
    alone = [tcof.cofactor_update(x, w)[2].clone() for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for x, st in zip(xs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(tcof.cofactor_update(x, w)[2])
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        if not torch.equal(got, alone[k % 2]):
            raise AssertionError("cofactor_update on two streams at once differs "
                                 "from the same call alone")
    keys = {key for key in tcof._scratch if key[0] == torch.cuda.current_device()}
    if len(keys) < 3:  # the default stream and the two
        raise AssertionError(f"cofactor_update: streams share a scratch ({keys})")


def ops_kernel_rows(rng, rows: dict) -> None:
    """The kernel-ops layer's four kernels at the JAX package's benchmark
    shapes (``benchmarks/bench_kernels.py``), at the shapes paths A to C
    give them and at sizes where the card does real work: bitwise against
    the plain versions on integer-valued data, part of it with 12
    significant bits (``cofactor_update``, ``matvec``: a product in TF32 or
    bf16 fails), and for ``ring_mul`` and ``outer_accumulate`` on normal
    data too (both round every operation once, in the plain version's
    order)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cofactor_update import COFACTOR_UPDATE, cofactor_update
    from repro_torch.kernels.rank1_chain import MATVEC, matvec, outer_accumulate
    from repro_torch.kernels.ring_mul import ring_mul

    # cofactor_update: the benchmark's 4096 x 32, path A's batch and 262,144
    # rows at the widest m of the kernel tests (130)
    for B, m in ((4096, 32), (STATS_B, STATS_M), (262_144, 130)):
        err = 0.0
        for kind in ("ints", "wide"):
            x, w = ints(rng, (B, m)), ints(rng, (B,), -1, 2)
            if kind == "wide":
                widen(rng, x, w)
            c, s, Q = ref.cofactor_update_ref(x, w)
            got = cofactor_update(x, w)
            err = max([err] + [check_equal(f"cofactor_update B={B} m={m} {kind} {n}",
                                           g, r)
                               for n, g, r in zip("csQ", got, (c.reshape(1), s, Q))])
        check_cofactor_repeats(rng, B, m)
        events_a_call = check_one_launch(f"cofactor_update B={B} m={m}",
                                         lambda: cofactor_update(x, w), "cofactor_",
                                         COFACTOR_UPDATE)
        xw = x * w[:, None]
        # reads x and w once, writes (c, s, Q); Q is symmetric, so m(m+1)/2
        # dot products of B terms (B·m(m+1) flops), B·m multiplies for the
        # weighting and B·m + B adds for s and c
        bms, by = bound_ms(4 * (B * m + B + m * m + m + 1),
                           B * m * (m + 1) + 2 * B * m + B)
        # the Q product alone, on rows scaled beforehand
        turns = time_in_turns({"kernel": lambda: cofactor_update(x, w),
                               "library": lambda: torch.mm(xw.T, x)})
        row = dict(
            shape=dict(B=B, m=m), max_abs_err=err, device_events_per_call=events_a_call,
            kernel_ms=turns["kernel"],
            device_ms=kernel_device_ms(lambda: cofactor_update(x, w), "cofactor_"),
            plain_ms=time_ms(lambda: ref.cofactor_update_ref(x, w)),
            library_ms=turns["library"],
            library_device_ms=all_device_ms(lambda: torch.mm(xw.T, x)),
            bound_ms=bms, bound_by=by)
        rows["cofactor_update"].append(row)
        log({"kernel": "cofactor_update", **row})
        del x, w, xw
    # the banded kernel (m >= 192: passes over pairs of bands), bitwise on
    # both kinds of data and repeatable, with its device time beside
    # torch.mm's; checks, not rows of the kernels line, whose shapes are
    # the paths'
    for B, m in ((1001, 300), (2049, 1001), (65_536, 300)):
        for kind in ("ints", "wide"):
            x, w = ints(rng, (B, m)), ints(rng, (B,), -1, 2)
            if kind == "wide":
                widen(rng, x, w)
            c, s, Q = ref.cofactor_update_ref(x, w)
            got = cofactor_update(x, w)
            for n, g, r in zip("csQ", got, (c.reshape(1), s, Q)):
                check_equal(f"cofactor_update B={B} m={m} {kind} {n}", g, r)
        check_cofactor_repeats(rng, B, m)
        xw = x * w[:, None]
        bms, by = bound_ms(4 * (B * m + B + m * m + m + 1),
                           B * m * (m + 1) + 2 * B * m + B)
        log({"check": "cofactor_update banded", "B": B, "m": m, "ok": True,
             "device_ms": kernel_device_ms(lambda: cofactor_update(x, w), "cofactor_", 5),
             "library_device_ms": all_device_ms(lambda: torch.mm(xw.T, x), 5),
             "bound_ms": bms, "bound_by": by})
        del x, w, xw
    check_cofactor_two_streams(rng)

    # ring_mul: the benchmark's 256 keys at m = 32, and the retailer
    # cofactor engine's largest view at RETAILER_DOMS_BIG (1,179,648 keys,
    # m = 10)
    for K, m in ((256, 32), (1_179_648, 10)):
        err = 0.0
        for kind in ("ints", "normal"):
            mk = ints if kind == "ints" else normal
            args = [mk(rng, sh) for sh in ((K,), (K, m), (K, m, m))]
            args += [mk(rng, sh) for sh in ((K,), (K, m), (K, m, m))]
            got = ring_mul(*args)
            err = max([err] + [check_equal(f"ring_mul K={K} m={m} {kind} {n}", g, r)
                               for n, g, r in zip("csQ", got, ref.ring_mul_ref(*args))])
            del got
        d = 1 + m + m * m
        bms, by = bound_ms(3 * K * d * 4, K * (1 + 3 * m + 7 * m * m))
        row = dict(
            shape=dict(K=K, m=m), max_abs_err=err,
            kernel_ms=time_ms(lambda: ring_mul(*args)),
            device_ms=kernel_device_ms(lambda: ring_mul(*args), "ring_mul_kernel"),
            plain_ms=time_ms(lambda: ref.ring_mul_ref(*args)),
            # no single PyTorch call forms the degree-m product
            library_ms=None,
            bound_ms=bms, bound_by=by)
        rows["ring_mul"].append(row)
        log({"kernel": "ring_mul", **row})
        del args

    # matvec, both layouts (A x and vᵀ A3 read as A3.T), and
    # outer_accumulate: the benchmark's n = 1024 and n = 8192
    for n in (1024, 8192):
        A, x = ints(rng, (n, n)), ints(rng, (n,))
        x[::n // 64] = wide_values(rng, 64)
        An, xn = normal(rng, (n, n)), normal(rng, (n,))
        for variant, mat, matn in (("rows", A, An), ("cols", A.T, An.T)):
            err = check_equal(f"matvec n={n} {variant}", matvec(mat, x),
                              ref.matvec_ref(mat, x))
            # one launch, one device event, and the same bits every call
            events_a_call = check_one_launch(f"matvec n={n} {variant}",
                                             lambda: matvec(matn, xn), "matvec_", MATVEC)
            if not torch.equal(matvec(matn, xn), matvec(matn, xn)):
                raise AssertionError(f"matvec n={n} {variant}: bits differ between calls")
            bms, by = bound_ms(4 * (n * n + 2 * n), 2 * n * n)
            turns = time_in_turns({"kernel": lambda: matvec(matn, xn),
                                   "library": lambda: torch.mv(matn, xn)})
            row = dict(
                shape=dict(n=n, variant=variant), max_abs_err=err,
                device_events_per_call=events_a_call,
                kernel_ms=turns["kernel"],
                device_ms=kernel_device_ms(lambda: matvec(matn, xn), "matvec_"),
                plain_ms=time_ms(lambda: ref.matvec_ref(matn, xn)),
                library_ms=turns["library"],
                library_device_ms=all_device_ms(lambda: torch.mv(matn, xn)),
                bound_ms=bms, bound_by=by)
            rows["matvec"].append(row)
            log({"kernel": "matvec", **row})
        del An, xn
        err = 0.0
        for kind in ("ints", "normal"):
            mk = ints if kind == "ints" else normal
            V, u, v = mk(rng, (n, n)), mk(rng, (n,)), mk(rng, (n,))
            got = outer_accumulate(V, u, v)
            err = max(err, check_equal(f"outer_accumulate n={n} {kind}", got,
                                       ref.outer_accumulate_ref(V, u, v)))
        bms, by = bound_ms(4 * (2 * n * n + 2 * n), 2 * n * n)
        row = dict(
            shape=dict(n=n), max_abs_err=err,
            kernel_ms=time_ms(lambda: outer_accumulate(V, u, v)),
            device_ms=kernel_device_ms(lambda: outer_accumulate(V, u, v),
                                       "outer_acc"),
            plain_ms=time_ms(lambda: ref.outer_accumulate_ref(V, u, v)),
            library_ms=time_ms(lambda: torch.addr(V, u, v)),
            bound_ms=bms, bound_by=by)
        rows["outer_accumulate"].append(row)
        log({"kernel": "outer_accumulate", **row})
        del A, V, got


#: flash_attention checks (B, H, Hkv, T, D): the LM path's own prefill shape
#: (llama3.2-1b, 4 prompts of 1024 tokens), an unaligned T at the widest
#: head dim, the widest head dim under GQA at T = 257, path D's reduced leg
#: (head dim 16), and the path shape at head dim 32, where the small-head-dim
#: kernel fills the card
FLASH_SHAPES = ((4, 32, 8, 1024, 64), (1, 4, 1, 1000, 128), (1, 8, 2, 257, 128),
                (2, 4, 2, 64, 16), (4, 32, 8, 1024, 32))
#: float32 kernel against float64: within this share of the largest output
#: (the float32 scores, exp and sums of T terms round at ~6e-8 each; the
#: TF32 kernel's three-term products leave about 2⁻²¹ of each product)
FLASH_F32_RTOL = 1e-5
#: the CUDA kernel function of each flash variant, as the profiler names it
FLASH_KERNEL_NAMES = {"wgmma": "flash_attention_wgmma_kernel",
                      "tf32": "flash_attention_tf32_kernel",
                      "mma": "flash_attention_mma_kernel",
                      "simt": "flash_attention_kernel"}
#: H100 SXM dense TF32 tensor-core rate (data sheet): the float32 flash
#: rows' tc_bound_ms, three TF32 products a float32 one
TF32_OPS_PER_S = 495e12
#: exponentials (MUFU.EX2) an SM issues a clock on Hopper; times the SMs and
#: the card's maximum SM clock, the rate of the rows' exp_bound_ms
EXP_PER_CLOCK_SM = 16


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout
    return 1e6 * float(out.splitlines()[0])


def check_flash(label, got, want, dt):
    """(max abs err, its share of the largest output) of a flash output
    against the float64 plain version; raises beyond the gate: float32
    within FLASH_F32_RTOL of the largest output, bf16 every element within
    one bf16 rounding, 2⁻⁸·|ref| + 1e-6·max|ref|."""
    import torch

    err = (got.double() - want).abs()
    scale = float(want.abs().max())
    if dt == torch.float32:
        if not float(err.max()) <= FLASH_F32_RTOL * scale:
            raise AssertionError(f"{label}: max abs err {float(err.max())} "
                                 f"> {FLASH_F32_RTOL} x {scale}")
    elif not bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * scale).all()):
        raise AssertionError(f"{label}: beyond one bf16 rounding of the "
                             f"float64 result (max abs err {float(err.max())})")
    return float(err.max()), float(err.max()) / scale


def flash_attention_rows(rng, rows: dict) -> None:
    """``flash_attention`` (causal) at FLASH_SHAPES in bf16 and float32, each
    against the plain version in float64 on the same inputs, into
    ``rows[kernel name]`` by the variant the wrapper's dispatch takes.
    float32: within FLASH_F32_RTOL of the largest output.  bf16: the kernels
    compute in float32 (the wgmma kernel with P as three bf16 terms that
    sum to it exactly) from exact bf16 inputs and round once to bf16 (half
    an ulp, at most 2⁻⁹ of the value), so every element is within
    2⁻⁸·|ref| + 1e-6·max|ref| of the float64 result.  Where the wrapper takes a
    tensor-core kernel (wgmma for bf16, tf32 for float32, at D 64/128; mma at
    D 8/16/32), the SIMT kernel is checked and timed on the same inputs
    too, and the kernel, the SIMT kernel and SDPA are timed in turns; SDPA's
    device ms (``library_device_ms``, every kernel of the call) beside its
    events ms.  float32 rows also carry ``tc_bound_ms``: the flops as three TF32
    products at the tensor cores' rate (``bound_ms`` keeps the CUDA-core
    float32 rate).  Rows at D <= 32 carry ``exp_bound_ms``: the causal
    half's B·H·T(T + 1)/2 exponentials at EXP_PER_CLOCK_SM a clock on every
    SM at the maximum SM clock."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    exp_rate = EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count \
        * sm_clock_hz()
    for B, H, Hkv, T, D in FLASH_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q = normal(rng, (B, H, T, D)).to(dt)
            k, v = (normal(rng, (B, Hkv, T, D)).to(dt) for _ in range(2))
            kind = tflash.variant(dt, D)
            name = tflash.KERNELS[kind].name
            label = f"{name} {(B, H, Hkv, T, D)} {dt}"
            want = ref.flash_attention_ref(q.double(), k.double(), v.double())
            err, rel = check_flash(label, tflash.flash_attention(q, k, v), want, dt)
            simt_err, _ = check_flash(f"flash_attention (simt) {(B, H, Hkv, T, D)} {dt}",
                                tflash.launch("simt", q, k, v), want, dt)
            extra = {"simt_max_abs_err": simt_err}
            if D <= 32:
                extra["exp_bound_ms"] = 1e3 * B * H * T * (T + 1) / 2 / exp_rate
            del want
            # q, k, v read once and o written once; the causal half of QKᵀ
            # and PV, 2·B·H·T²·D flops, at the dtype's peak rate
            nbytes = q.element_size() * (2 * B * H * T * D + 2 * B * Hkv * T * D)
            bms, by = bound_ms(nbytes, 2 * B * H * T * T * D,
                               BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
            if dt == torch.float32:
                extra["tc_bound_ms"] = bound_ms(nbytes, 3 * 2 * B * H * T * T * D,
                                                TF32_OPS_PER_S)[0]

            def kernel():
                tflash.flash_attention(q, k, v)

            def library():
                F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

            def simt():
                tflash.launch("simt", q, k, v)

            def with_lse():
                tflash.flash_attention(q, k, v, return_lse=True)

            fns = {"kernel": kernel, "library": library, "simt": simt}
            if tflash.lse_route(dt, D):
                o, lse = tflash.flash_attention(q, k, v, return_lse=True)
                if not torch.equal(o, tflash.flash_attention(q, k, v)):
                    raise AssertionError(f"{label}: o differs with L asked for")
                want_lse = ref.flash_attention_lse_ref(q, k, v)
                extra["lse_max_abs_err"] = float((lse[..., :T] - want_lse).abs().max())
                if not extra["lse_max_abs_err"] <= 1e-6 * float(want_lse.abs().max()):
                    raise AssertionError(f"{label}: L {extra['lse_max_abs_err']} from the "
                                         "plain version's")
                del o, lse, want_lse
                fns["with_lse"] = with_lse
            times = time_in_turns(fns)
            row = dict(
                shape=dict(B=B, H=H, Hkv=Hkv, T=T, D=D, dtype=str(dt).split(".")[1]),
                variant=kind, max_abs_err=err, rel_err=rel,
                kernel_ms=times["kernel"],
                device_ms=kernel_device_ms(kernel, FLASH_KERNEL_NAMES[kind]),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=10),
                library_ms=times["library"], library_device_ms=all_device_ms(library),
                bound_ms=bms, bound_by=by, simt_ms=times["simt"],
                simt_device_ms=kernel_device_ms(simt, FLASH_KERNEL_NAMES["simt"]), **extra)
            if "with_lse" in fns:
                row.update(lse_kernel_ms=times["with_lse"],
                           lse_device_ms=kernel_device_ms(with_lse, FLASH_KERNEL_NAMES[kind]))
            rows[name].append(row)
            log({"kernel": name, **row})
            del q, k, v


def scatter_dedup_rows(rng, out: list) -> None:
    """``scatter_dedup`` at the view sizes of the retailer triggers, S = 1
    (a collapsed-to-scalar view: every row one id) up to 1,179,648: the
    kernel, ``scatter_add`` and ``index_add_`` timed in turns (events ms),
    the kernel's and ``index_add_``'s device ms, the wrappers' host µs a
    call, one device event a call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ring_scatter import (SCATTER_DEDUP, scatter_add,
                                                  scatter_dedup_ref)

    B = BATCH
    for S in (1, 96, 9216, 1_179_648):
        for d in (1, 111):
            view = ints(rng, (S, d))
            vals = ints(rng, (B, d))
            ids_np = rng.integers(0, S, size=B)
            pad_np = ids_np.copy()
            pad_np[:8], pad_np[8:16] = -1, S + 3
            pad = ids_tensor(pad_np)
            got = scatter_add(view.clone(), pad, vals, dedup=True)
            err = check_equal(f"scatter_dedup S={S} d={d}", got,
                              scatter_dedup_ref(view.clone(), pad, vals))
            check_equal(f"scatter_dedup S={S} d={d} vs scatter_add", got,
                        ref.scatter_add_ref(view.clone(), pad, vals))
            ids = ids_tensor(ids_np)
            ids64 = ids.long()
            work = view.clone()
            u = len(np.unique(ids_np))
            bms, by = bound_ms(B * 4 + B * d * 4 + 2 * u * d * 4, B * d)

            def run():
                scatter_add(work, ids, vals, dedup=True)

            def library():
                work.index_add_(0, ids64, vals)

            events = check_one_launch(f"scatter_dedup S={S} d={d}", run,
                                      "scatter_dedup", SCATTER_DEDUP)
            turns = time_in_turns({"kernel": run,
                                   "scatter_add": lambda: scatter_add(work, ids, vals),
                                   "library": library})
            row = dict(
                shape=dict(S=S, d=d, B=B), max_abs_err=err,
                device_events_per_call=events,
                kernel_ms=turns["kernel"],
                device_ms=kernel_device_ms(run, "scatter_dedup_kernel"),
                host_us=host_us(run),
                scatter_add_ms=turns["scatter_add"],
                plain_ms=time_ms(lambda: scatter_dedup_ref(work, ids, vals)),
                library_ms=turns["library"],
                library_device_ms=all_device_ms(library),
                library_host_us=host_us(library),
                bound_ms=bms, bound_by=by)
            out.append(row)
            log({"kernel": "scatter_dedup", **row})
            del view, work


#: fused chains of the retailer Inventory trigger at RETAILER_DOMS_BIG:
#: (target rows S, gathered sibling-view rows or None, lift rows).  The
#: sum ring's chains have one source each (a gather, else the units lift);
#: the cofactor ring's lift every marginalized variable, so its gathering
#: chains have two.
MAIN_CHAINS = ((1_179_648, None, 8), (9216, 128, 128), (96, 9216, 96),
               (1, 96, 96))


def fused_chain_rows(rng, out: list) -> None:
    """``fused_chain`` at the main path's chains, scalar and degree-10 rings:
    duplicate out ids, padding rows (out id -1 with a ring-zero value, gather
    ids out of range), the 9216-row source and a collapsed-to-scalar target
    (S = 1), each checked with and without the per-row product output."""
    import torch
    from repro_torch.kernels.ring_fused import (FUSED_CHAIN, fused_apply,
                                                fused_apply_ref, spec_width)

    B = BATCH
    for spec in (("scalar",), ("degree", 10)):
        d = spec_width(spec)
        m = 0 if spec[0] == "scalar" else spec[1]
        for S, gathered, lift in MAIN_CHAINS:
            if spec[0] == "scalar":
                src_rows = (gathered or lift,)
            else:
                src_rows = (lift,) if gathered is None else (gathered, lift)
            view = ints(rng, (S, d))
            vals = ints(rng, (B, d), -2, 3)
            out_np = rng.integers(0, S, size=B)
            sources, in_nps = [], []
            for Sg in src_rows:
                in_np = rng.integers(0, Sg, size=B)
                in_nps.append(in_np)
                sources.append((ints(rng, (Sg, d), -2, 3), ids_tensor(in_np)))
            # padding rows: out id -1, ring-zero value, gather ids -1 / >= Sg
            pad_out, pad_vals = out_np.copy(), vals.clone()
            pad_out[:8] = -1
            pad_vals[:8] = 0.0
            pad_sources = []
            for (plane, _), in_np in zip(sources, in_nps):
                pad_in = in_np.copy()
                pad_in[:4], pad_in[4:8] = -1, plane.shape[0] + 5
                pad_sources.append((plane, ids_tensor(pad_in)))
            prods = [torch.empty_like(vals) for _ in range(2)]
            label = f"fused_chain {spec} S={S} sources={src_rows}"
            got = fused_apply(view.clone(), ids_tensor(pad_out), pad_vals,
                              pad_sources, spec, product_out=prods[0])
            want = fused_apply_ref(view.clone(), ids_tensor(pad_out), pad_vals,
                                   pad_sources, spec, product_out=prods[1])
            err = check_equal(label, got, want)
            check_equal(label + " product", prods[0], prods[1])
            out_ids = ids_tensor(out_np)
            work = view.clone()
            # bound: values, out ids and every source's ids read once, each
            # distinct gathered row once, touched view rows read and written;
            # per source and row 1 + 3m + 7m² flops (d for the scalar ring)
            # and one add per element for the ⊎
            u_out = len(np.unique(out_np))
            u_src = sum(len(np.unique(x)) for x in in_nps)
            nbytes = (B * d * 4 + B * 4 * (1 + len(sources)) + u_src * d * 4
                      + 2 * u_out * d * 4)
            flops_row = d if m == 0 else 1 + 3 * m + 7 * m * m
            bms, by = bound_ms(nbytes, len(sources) * B * flops_row + B * d)

            def run():
                fused_apply(work, out_ids, vals, sources, spec)

            row = dict(
                shape=dict(S=S, Sg=list(src_rows), d=d, B=B), max_abs_err=err,
                device_events_per_call=check_one_launch(label, run, "fused_chain",
                                                        FUSED_CHAIN),
                kernel_ms=time_ms(run),
                device_ms=kernel_device_ms(run, "fused_chain_kernel"),
                host_us=host_us(run),
                plain_ms=time_ms(lambda: fused_apply_ref(
                    work, out_ids, vals, sources, spec)),
                # no single PyTorch call gathers, multiplies in the ring and
                # scatters
                library_ms=None,
                bound_ms=bms, bound_by=by)
            out.append(row)
            log({"kernel": "fused_chain", **row})
            del view, work


# ---------------------------------------------------------------------------
# Phase 3: the main path, checked against a float64 oracle
# ---------------------------------------------------------------------------
def compare_views(label: str, eng, store) -> dict:
    import torch
    from repro_torch.core.storage import as_dense

    worst = {"bitwise_views": 0, "tolerance_views": 0, "max_rel_err": 0.0}
    for name in sorted(eng.materialized_names):
        got_rel = as_dense(eng.views[name])
        want_rel = store[name].transpose(got_rel.schema)
        for comp in got_rel.ring.components:
            got = got_rel.payload[comp].double()
            want = want_rel.payload[comp]
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} {name}.{comp}: non-finite values")
            scale = float(want.abs().max()) if want.numel() else 0.0
            if scale < EXACT_LIMIT:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{label} {name}.{comp}: differs from the oracle "
                        f"(max abs err {float((got - want).abs().max())})")
                worst["bitwise_views"] += 1
            else:
                rel = float((got - want).abs().max()) / scale
                if rel > RTOL:
                    raise AssertionError(f"{label} {name}.{comp}: relative "
                                         f"error {rel} > {RTOL}")
                worst["tolerance_views"] += 1
                worst["max_rel_err"] = max(worst["max_rel_err"], rel)
    return worst


def stream_phase(label, query, query64, db, doms, rng, kernels, expected,
                 fusion="off", backend=None, n_batches=N_BATCHES,
                 device="cuda", batch=BATCH, keep=None, executor=False):
    """Build a fivm engine under the given plan-fusion mode and ⊎ backend,
    time the update stream through it, read the kernels' launch counts,
    and hold the result to a float64 oracle.  With ``keep`` (a list), the
    payload of the engine's largest view is appended to it as
    ``(name, {component: tensor with the keys flattened})``.  With
    ``executor``, the same stream then runs through the stream executor
    (:func:`executor_leg`).  Returns the legs' result lines."""
    from repro_torch.core import plan
    from repro_torch.kernels import scatter_ops

    with plan.use_fusion(fusion), scatter_ops.use_backend(backend):
        outs = _stream_phase(label, query, query64, db, doms, rng, kernels,
                             expected, n_batches, device, batch, keep, executor)
    for out in outs:
        log(out)
    return outs


def _chain_report(eng) -> dict:
    """Fused chains in the engine's plans, and those that gather a plane of
    more than 4096 rows (the reference's MAX_FUSED_PLANE, a TPU VMEM bound
    under which it keeps such a chain unfused)."""
    from repro_torch.core import plan

    chains = [op for p in eng.plans.plans.values() for op in p.ops
              if isinstance(op, plan.FusedChain)]
    big = sorted({f"{c.writes[0]}<-{v}" for c in chains for v in c.reads
                  if math.prod(eng.views[v].domains) > 4096})
    return dict(fused_chains=len(chains), beyond_tpu_plane_bound=big,
                smem_bytes=sorted({c.smem_bytes for c in chains}))


def _stream_phase(label, query, query64, db, doms, rng, kernels, expected,
                  n_batches, device, batch, keep, executor):
    import torch
    from repro_torch.core import IVMEngine, plan
    from repro_torch.data.synth import RETAILER_RELATIONS, retailer_vo, update_stream

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = IVMEngine.build(query, db, var_order=retailer_vo(), strategy="fivm",
                          device=device)
    eng.precompile(batch)
    sync()
    build_s = time.perf_counter() - t0
    if any(s.kind != "dense" for s in eng.storage_plan.values()):
        raise AssertionError(f"{label}: auto storage made a retailer view sparse: "
                             f"{eng.storage_plan}")
    stream = update_stream(RETAILER_RELATIONS, doms, query.ring, rng, batch,
                           n_batches, device=device)
    sync()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    for rel, upd in stream:
        eng.apply_update(rel, upd)
    sync()
    run_s = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() if on_card else None
    launches = {k.name: k.launches for k in kernels}
    missing = [n for n in expected if launches[n] == 0]
    if missing:
        raise AssertionError(f"{label}: the main path never launched {missing}")
    fusion = plan.fusion_mode(eng.device)
    chains = _chain_report(eng)
    if (fusion == "on") != (chains["fused_chains"] > 0):
        raise AssertionError(f"{label}: fusion {fusion} but "
                             f"{chains['fused_chains']} fused chains")

    check = compare_views(label, eng, oracle_store(eng, db, stream, query64, 1))
    memory_bytes, plan_stats = eng.memory_bytes(), eng.plans.stats()
    if keep is not None:
        # the engine's own storage (column slices of its [S, d] plane)
        name = max(eng.views, key=lambda v: math.prod(eng.views[v].domains))
        rel = eng.views[name]
        K = math.prod(rel.domains)
        keep.append((name, {c: t.reshape(K, *t.shape[len(rel.domains):])
                            for c, t in rel.payload.items()}))
    del eng
    profile = (profile_stream(query, db, stream, batch, device, counts=executor)
               if on_card else None)
    out = dict(
        stream=label, fusion=fusion, domains=doms, batch=batch,
        n_batches=n_batches, build_s=build_s, run_s=run_s,
        tuples_per_s=batch * n_batches / run_s,
        memory_bytes=memory_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated() if on_card else None,
        max_memory_allocated_run=run_peak, launches=launches,
        launches_per_batch={k: n / n_batches for k, n in launches.items()},
        plan_cache=plan_stats, chains=chains, oracle=check, profile=profile)
    outs = [out]
    if executor:
        outs.append(executor_leg(label + "_executor", query, query64, db, doms,
                                 stream, kernels, expected, out, device, batch))
    del stream
    if on_card:
        torch.cuda.empty_cache()
    return outs


def oracle_store(eng, db, stream, query64, times: int) -> dict:
    """Every view of ``eng``'s tree over a float64 copy of ``db`` into which
    ``stream`` was scattered ``times`` times with the plain scatter."""
    from repro_torch.core import DenseRelation, evaluate_view

    db64 = {r: DenseRelation(rel.schema, query64.ring,
                             {c: v.double() for c, v in rel.payload.items()})
            for r, rel in db.items()}
    for _ in range(times):
        for rel, upd in stream:
            db64[rel] = db64[rel].scatter_add(
                upd.keys, {c: v.double() for c, v in upd.payload.items()},
                backend="torch")
    store: dict = {}
    evaluate_view(eng.tree, db64, query64, store=store)
    return store


def executor_leg(label, query, query64, db, doms, stream, kernels, expected,
                 eager, device, batch) -> dict:
    """The stream of an eager leg through the stream executor
    (``core/stream.py``: rounds mode, each round one CUDA graph) on a fresh
    engine, three runs:

    1. the capture run on a copy of the engine's state: the first round
       eagerly, then its capture, then a replay a round (timed, with its
       launch counts, capture seconds and host µs a replay);
    2. a replay-only run on the same state, donated, under
       ``torch.cuda.set_sync_debug_mode("error")``, of a second stream of
       the same signature (other data, from ``SEED + 1``), which replays
       the first stream's graphs on its own inputs (timed, launch counts);
    3. the first stream again, replay-only, profiled: device busy against
       wall, device events.

    The views, after the first, the second and the first stream again, are
    held to the float64 oracle; the eager leg's numbers stand beside the executor's (its peak
    bytes as of the end of its run, before its oracle).  Peak bytes here
    are read before the oracle too, allocated and reserved (the graphs'
    pool included)."""
    import torch
    from repro_torch.core import IVMEngine, StreamExecutor, prepare_stream
    from repro_torch.data.synth import RETAILER_RELATIONS, retailer_vo, update_stream

    n_batches = len(stream)
    second = update_stream(RETAILER_RELATIONS, doms, query.ring,
                           np.random.default_rng(SEED + 1), batch, n_batches,
                           device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = IVMEngine.build(query, db, var_order=retailer_vo(), strategy="fivm",
                          device=device)
    eng.precompile(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepared = prepare_stream(eng, stream)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    prepared2 = prepare_stream(eng, second)
    if prepared2.signature != prepared.signature:
        raise AssertionError(f"{label}: the second stream's signature differs")
    ex = StreamExecutor(eng)
    runs = {}
    for run in ("capture", "replay"):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "capture":
            ex.run(prepared)
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                ex.run(prepared2, donate_input=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(ex.last_run_stats)
        launches = {k.name: k.launches for k in kernels}
        missing = [n for n in expected if launches[n] == 0]
        if missing or not stats["replays"] or (run == "replay" and stats["eager_steps"]):
            raise AssertionError(f"{label} {run} run: stats {stats}, never "
                                 f"launched {missing}")
        runs[run] = dict(run_s=wall, tuples_per_s=batch * n_batches / wall,
                         host_us_per_replay=1e6 * stats["replay_host_s"] / stats["replays"],
                         launches=launches,
                         launches_per_batch={k: n / n_batches for k, n in launches.items()},
                         **stats)
    reset(kernels)
    events, wall = device_events(lambda: ex.run(prepared, donate_input=True), 1)
    profile = _busy(events, wall)
    profile["device_events_per_batch"] = profile["device_events"] / n_batches
    # device events of this run beside the eager leg's, by name, where the
    # counts a batch differ
    mine, theirs = event_counts(events), eager["profile"].pop("event_counts")
    profile["events_per_batch_vs_eager"] = {
        name: [mine.get(name, 0) / n_batches, theirs.get(name, 0) / n_batches]
        for name in sorted(set(mine) | set(theirs))
        if mine.get(name, 0) != theirs.get(name, 0)}
    peak = dict(max_memory_allocated=torch.cuda.max_memory_allocated(),
                max_memory_reserved=torch.cuda.max_memory_reserved())
    check = compare_views(label, eng, oracle_store(eng, db, stream + second + stream,
                                                   query64, 1))
    ex.release()
    del second, prepared2
    del eng, ex
    torch.cuda.empty_cache()
    return dict(
        stream=label, mode=prepared.mode, pattern=len(prepared.pattern),
        rounds=prepared.n_steps, batch=batch, n_batches=n_batches,
        prepare_s=prepare_s, capture_s=runs["capture"]["capture_s"],
        capture_run=runs["capture"], replay_run=runs["replay"],
        replays=runs["capture"]["replays"] + runs["replay"]["replays"],
        launches={k.name: runs["capture"]["launches"][k.name]
                  + runs["replay"]["launches"][k.name] for k in kernels},
        profile=profile, **peak, oracle=check,
        eager=dict(tuples_per_s=eager["tuples_per_s"],
                   launches_per_batch=eager["launches_per_batch"],
                   max_memory_allocated_run=eager["max_memory_allocated_run"],
                   profile=eager["profile"]))


def event_counts(events) -> dict:
    """Device events by name (cut to 60 characters)."""
    out: dict = {}
    for e in events:
        out[e.name[:60]] = out.get(e.name[:60], 0) + 1
    return out


def profile_stream(query, db, stream, batch, device, counts=False) -> dict:
    """Where the stream's time goes: the same updates through a fresh engine
    under torch.profiler — device busy time against host wall time (the
    device's idle share) and the device time of the heaviest kernels; with
    ``counts``, also every device event's count by name."""
    from repro_torch.core import IVMEngine
    from repro_torch.data.synth import retailer_vo

    eng = IVMEngine.build(query, db, var_order=retailer_vo(), strategy="fivm",
                          device=device)
    eng.precompile(batch)
    updates = iter(stream)

    def step():
        eng.apply_update(*next(updates))

    events, wall = device_events(step, len(stream))
    out = _busy(events, wall)
    out["device_events_per_batch"] = out["device_events"] / len(stream)
    if counts:
        out["event_counts"] = event_counts(events)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the kernel-ops layer's paths
# ---------------------------------------------------------------------------
def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, in float64."""
    want = want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got.double() - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale else err


def reset(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_launches(label, kernels, expected: dict) -> dict:
    """The counts since the last reset; raises unless each kernel of
    ``expected`` launched exactly that many times."""
    launches = {k.name: k.launches for k in kernels}
    wrong = {n: launches[n] for n, want in expected.items() if launches[n] != want}
    if wrong:
        raise AssertionError(f"{label}: launches {wrong}, expected {expected}")
    return launches


def check_within(label: str, errors: dict, limits: dict) -> None:
    bad = {k: (errors[k], limits[k]) for k in errors if not errors[k] <= limits[k]}
    if bad:
        raise AssertionError(f"{label}: (error, limit) {bad}")


#: path A: 20 batches of 65,536 standard-normal rows over 32 features
STATS_M, STATS_B, STATS_BATCHES = 32, 65_536, 20


def stats_path(kernels) -> dict:
    """Path A, streaming statistics (paper §7.2): ``RunningCofactor`` on the
    card fed 20 batches, the last retracted (weights -1); mean, variance,
    correlation, drift against the state after 10 batches and a ridge
    solve, each against the same formulas over a float64 recomputation of
    (c, s, Q) from the rows kept.

    Tolerances: c is an exact count.  s, Q, the mean, variance,
    correlation and θ within RTOL of their largest magnitude: float32 sums
    of 1.2M terms in chunks, then 21 adds into the running state, each
    rounding at ~6e-8 of the state's magnitude.  The drift score is the
    Frobenius norm of a difference of two correlation matrices, so its
    error is at most the Frobenius norms of their two measured errors plus
    the norm's own rounding (m² adds at 2⁻²⁴)."""
    import torch
    from repro_torch.data.stats import RunningCofactor, solve_ridge

    m, B, n = STATS_M, STATS_B, STATS_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    X = torch.randn((n, B, m), generator=gen, device="cuda")
    minus = -torch.ones(B, device="cuda")
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    st = RunningCofactor.init(m)
    for i in range(n):
        st = st.update(X[i])
        if i == n // 2 - 1:
            base = st
    st = st.update(X[n - 1], weights=minus)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches("stats path", kernels, {"cofactor_update": n + 1})

    def oracle(rows):
        X64 = rows.reshape(-1, m).double()
        return RunningCofactor(torch.tensor(float(X64.shape[0]), device="cuda",
                                            dtype=torch.float64),
                               X64.sum(0), X64.T @ X64)

    want, want_base = oracle(X[:n - 1]), oracle(X[:n // 2])
    features = list(range(1, m))
    corr, corr64 = st.correlation(), want.correlation()
    dcorr = float(torch.linalg.norm(corr.double() - corr64))
    dbase = float(torch.linalg.norm(base.correlation().double()
                                    - want_base.correlation()))
    drift, drift64 = float(st.drift_score(base)), float(want.drift_score(want_base))
    errors = dict(
        c=abs(float(st.c) - float(want.c)), s=rel_err(st.s, want.s),
        Q=rel_err(st.Q, want.Q), mean=rel_err(st.mean(), want.mean()),
        variance=rel_err(st.variance(), want.variance()),
        correlation=rel_err(corr, corr64),
        drift=abs(drift - drift64),
        ridge=rel_err(solve_ridge(st, 0, features), solve_ridge(want, 0, features)))
    limits = dict(c=0.0, s=RTOL, Q=RTOL, mean=RTOL, variance=RTOL,
                  correlation=RTOL, ridge=RTOL,
                  drift=dcorr + dbase + m * m * 2.0 ** -24 * drift64)
    out = dict(path="stats", m=m, batch=B, batches=n, retracted_batches=1,
               run_s=run_s, rows_per_s=(n + 1) * B / run_s,
               launches=launches, drift_score=drift, drift_score_f64=drift64,
               errors=errors, limits=limits)
    log(out)
    check_within("stats path", errors, limits)
    del X
    return out


def ring_product_path(kept, kernels) -> dict:
    """Path B, the ring product on engine state: the degree-10 payloads of
    the largest view of the unfused and the fused retailer cofactor
    streams, multiplied by ``ops.ring_mul`` straight from the engines'
    [S, d] planes (the kernel reads the strided components; nothing is
    copied).  Equal bit for bit to ``DegreeMRing.mul`` of the same payloads,
    and within RTOL of a float64 product."""
    import torch
    from repro_torch.core.rings import DegreeMRing
    from repro_torch.kernels import ops

    (name_a, a), (name_b, b) = kept
    if name_a != name_b:
        raise AssertionError(f"largest views differ: {name_a} {name_b}")
    K, m = a["s"].shape
    args = (a["c"], a["s"], a["Q"], b["c"], b["s"], b["Q"])
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    got = ops.ring_mul(*args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches("ring product path", kernels, {"ring_mul": 1})
    ring = DegreeMRing(m)
    want = ring.mul(a, b)
    for comp, g in zip(("c", "s", "Q"), got):
        check_equal(f"ring product path {comp} vs DegreeMRing.mul", g, want[comp])
    del want
    ring64 = DegreeMRing(m, dtype=torch.float64)
    want64 = ring64.mul({c: t.double() for c, t in a.items()},
                        {c: t.double() for c, t in b.items()})
    errors = {comp: rel_err(g, want64[comp]) for comp, g in zip(("c", "s", "Q"), got)}
    del want64, got
    out = dict(path="ring_product", view=name_a, K=K, m=m,
               operands_strided=not a["s"].is_contiguous(), run_s=run_s,
               kernel_ms=time_ms(lambda: ops.ring_mul(*args), reps=10),
               launches=launches, errors=errors)
    log(out)
    check_within("ring product path", errors, dict.fromkeys(errors, RTOL))
    return out


#: path C: the matrix chain A1·A2·A3 at n = 8192 and 16 rank-1 updates
#: (the largest rank of benchmarks/bench_matrix_chain.py)
CHAIN_N, CHAIN_UPDATES = 8192, 16


def chain_path(kernels) -> dict:
    """Path C, rank-1 matrix-chain deltas (paper Example 7.1): V = A1 A2 A3
    in float32 (``torch.matmul``, outside any kernel, as the reference
    leaves it to XLA), then 16 updates δA2 = u vᵀ through
    ``ops.rank1_chain_update``.  V is held to float64 A1 (A2 + Σ u vᵀ) A3
    within RTOL of its largest magnitude, and the change V - V0 to the
    float64 Σ (A1 u)(vᵀ A3) within RTOL of its own.  Beside it, the float32
    dense recompute A1 (u vᵀ) A3 that a factorized update avoids."""
    import torch
    from repro_torch.kernels import ops

    n, r = CHAIN_N, CHAIN_UPDATES
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    A1, A2, A3 = (torch.randn((n, n), generator=gen, device="cuda") for _ in range(3))
    U = torch.randn((r, n), generator=gen, device="cuda")
    W = torch.randn((r, n), generator=gen, device="cuda")
    V0 = A1 @ A2 @ A3
    V = V0
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    for i in range(r):
        V = ops.rank1_chain_update(A1, U[i], W[i], A3, V)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches("chain path", kernels,
                             {"matvec": 2 * r, "outer_accumulate": r})
    update_ms = time_ms(lambda: ops.rank1_chain_update(A1, U[0], W[0], A3, V),
                        reps=20)
    dense_ms = time_ms(lambda: A1 @ torch.outer(U[0], W[0]) @ A3, reps=3, warmup=1)
    # float64 oracles, one product at a time to bound memory
    A1d, A3d = A1.double(), A3.double()
    delta64 = (A1d @ U.double().T) @ (W.double() @ A3d)
    delta_err = rel_err(V.double() - V0.double(), delta64)
    del delta64
    mid = A2.double() + U.double().T @ W.double()
    V64 = (A1d @ mid) @ A3d
    del mid, A1d, A3d
    errors = dict(V=rel_err(V, V64), delta=delta_err)
    del V64
    # bytes: A1 and A3 read once, V read and the new V written
    bms, by = bound_ms(4 * (4 * n * n + 4 * n), 2 * 2 * n * n + 2 * n * n)
    out = dict(path="matrix_chain", n=n, updates=r, run_s=run_s,
               us_per_update=1e6 * run_s / r, update_ms=update_ms,
               update_bound_ms=bms, update_bound_by=by,
               dense_recompute_ms=dense_ms, launches=launches, errors=errors)
    log(out)
    check_within("chain path", errors, dict.fromkeys(errors, RTOL))
    del A1, A2, A3, V, V0, U, W
    return out


#: the chain engine leg's small cases: integer-valued matrices of this
#: width, on the card and on the CPU (bitwise), and sparse storage against
#: dense; row updates of the sparse case
CHAIN_INT_N, CHAIN_SPARSE_UPDATES = 512, 3


def chain_kernel_ops(plan, views) -> tuple[int, int]:
    """(Join→Lift→Marg triples, ⊎ ops into a dense 2-D view) of a rank-1
    chain trigger plan: the ``matvec`` and ``outer_accumulate`` launches of
    one update (``plan.factorized_route`` sends each there)."""
    from repro_torch.core import plan as P

    ops = plan.ops
    joins = sum(isinstance(op, P.JoinContract) and isinstance(ops[i + 1], P.Lift)
                and isinstance(ops[i + 2], P.Marginalize)
                for i, op in enumerate(ops[:-2]))
    outers = sum(isinstance(op, P.ScatterAccum) and op.storage == "dense"
                 and len(views[op.view].schema) == 2 for op in ops)
    return joins, outers


def chain_engine_path(kernels, path_c: dict) -> dict:
    """The chain engine leg (paper Example 7.1 through ``IVMEngine``): path
    C's A1·A2·A3 at CHAIN_N (the same seed, so the same matrices) in
    ``matrix_chain.build_chain_engine`` with A2 updatable, as the
    reference's benchmark builds it; CHAIN_UPDATES rank-1 updates and one
    row update through ``apply_update``, each a factorized trigger whose
    joins take ``matvec`` and whose ⊎ takes ``outer_accumulate``, counted
    against the plan.  The result is held to float64 A1 (A2 + Σ u vᵀ) A3
    within RTOL.  Beside it: host ms an update against path C's bare
    kernels for the same work, a profiled update, peak bytes; then an
    integer-valued chain at CHAIN_INT_N on the card and on the CPU (every
    view bitwise), and sparse storage against dense under integer row
    updates (bitwise)."""
    import torch
    from repro_torch.core.apps import matrix_chain as mc

    n, r = CHAIN_N, CHAIN_UPDATES
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    A1, A2, A3 = (torch.randn((n, n), generator=gen, device="cuda") for _ in range(3))
    U = torch.randn((r, n), generator=gen, device="cuda")
    W = torch.randn((r, n), generator=gen, device="cuda")
    row, delta = 5, torch.randn(n, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = mc.build_chain_engine([A1, A2, A3], updatable=("A2",), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ring = eng.query.ring
    upds = [mc.rank1_update(2, U[i], W[i], ring) for i in range(r)]
    upds.append(mc.row_update(2, row, delta, n, ring))
    plan = eng.trigger_plan("A2", upds[0])
    log(plan.pretty())
    joins, outers = chain_kernel_ops(plan, eng.views)
    if (joins, outers) != (2, 1):
        raise AssertionError(f"chain engine: {joins} joins, {outers} ⊎s, expected 2, 1")
    expected = {k.name: 0 for k in kernels}
    expected.update(matvec=joins * len(upds), outer_accumulate=outers * len(upds))
    reset(kernels)
    t0 = time.perf_counter()
    for upd in upds:
        eng.apply_update("A2", upd)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches("chain engine", kernels, expected)
    peak = torch.cuda.max_memory_allocated()
    got = mc.result_matrix(eng)
    mid = A2.double() + U.double().T @ W.double()
    mid[row] += delta.double()
    V64 = (A1.double() @ mid) @ A3.double()
    del mid
    errors = dict(V=rel_err(got, V64))
    del V64, got
    # the engine's overhead over path C's bare kernels (events, median),
    # and where an update's device time goes; neither counts as the leg's
    # launches
    update_ms = time_ms(lambda: eng.apply_update("A2", upds[0]), reps=20)
    profile = _busy(*device_events(lambda: eng.apply_update("A2", upds[0]), 4))
    profile["device_events"] /= 4
    out = dict(path="chain_engine", n=n, updates=len(upds), build_s=build_s,
               run_s=run_s, host_ms_per_update=1e3 * run_s / len(upds),
               path_c_host_ms_per_update=path_c["us_per_update"] / 1e3,
               update_ms=update_ms, path_c_update_ms=path_c["update_ms"],
               plan_kernel_ops=dict(matvec=joins, outer_accumulate=outers),
               launches=launches, profile_per_update=profile,
               max_memory_allocated=peak, errors=errors)
    del eng, upds, A1, A2, A3, U, W, delta
    torch.cuda.empty_cache()
    log(out)
    check_within("chain engine", errors, dict.fromkeys(errors, RTOL))

    # integer-valued: the card's kernels ≡ the CPU's plain versions
    rng = np.random.default_rng(SEED)
    m = CHAIN_INT_N
    mats = [rng.integers(-1, 2, size=(m, m)).astype(np.float32) for _ in range(3)]
    pairs = [(rng.integers(-1, 2, size=m), rng.integers(-1, 2, size=m))
             for _ in range(r)]
    engines = {dev: mc.build_chain_engine(mats, updatable=("A2",), device=dev)
               for dev in ("cpu", "cuda")}
    reset(kernels)
    for u, v in pairs:
        for dev, e in engines.items():
            e.apply_update("A2", mc.rank1_update(
                2, torch.tensor(u, dtype=torch.float32, device=dev),
                torch.tensor(v, dtype=torch.float32, device=dev), e.query.ring))
    expected.update(matvec=joins * r, outer_accumulate=outers * r)
    out["launches_int"] = read_launches("chain engine, integers", kernels, expected)
    for name, view in engines["cpu"].views.items():
        check_equal(f"chain engine {name}, card vs CPU",
                    engines["cuda"].views[name].payload["v"].cpu(), view.payload["v"])
    del engines

    # sparse storage ≡ dense storage under integer row updates
    by_storage = {st: mc.build_chain_engine(mats, updatable=("A2",), storage=st,
                                            device="cuda")
                  for st in ("dense", "sparse")}
    sparse_views = sorted(name for name, s in by_storage["sparse"].storage_plan.items()
                          if s.kind == "sparse")
    if not sparse_views:
        raise AssertionError("chain engine: storage='sparse' kept no sparse view")
    reset(kernels)
    for _ in range(CHAIN_SPARSE_UPDATES):
        r_i = int(rng.integers(0, m))
        d = torch.tensor(rng.integers(-2, 3, size=m).astype(np.float32), device="cuda")
        for e in by_storage.values():
            e.apply_update("A2", mc.row_update(2, r_i, d, m, e.query.ring))
    torch.cuda.synchronize()
    out["launches_sparse"] = {k.name: k.launches for k in kernels}
    check_equal("chain engine, sparse vs dense",
                mc.result_matrix(by_storage["sparse"]).contiguous(),
                mc.result_matrix(by_storage["dense"]).contiguous())
    del by_storage
    torch.cuda.empty_cache()
    log(dict(path="chain_engine_small", n=m, int_updates=r,
             launches_int=out["launches_int"], sparse_views=sparse_views,
             sparse_row_updates=CHAIN_SPARSE_UPDATES,
             launches_sparse=out["launches_sparse"], bitwise=True))
    return out


# ---------------------------------------------------------------------------
# Phase 5: path D, LM serving
# ---------------------------------------------------------------------------
#: llama3.2-1b at full width and depth: 4 prompts of 1024 tokens, 32 new
#: tokens into a cache of 1056
LM_ARCH, LM_B, LM_T, LM_NEW = "llama3_2_1b", 4, 1024, 32
#: float32 logits against the float64 forward, of their largest magnitude:
#: float32 rounds at ~6e-8 per operation and the deepest sums are 8192
#: terms, so a correct forward stays near 1e-6; a wrong mask, RoPE pairing
#: or head grouping moves the logits by far more than 1e-4
LM_F32_RTOL = 1e-4
#: bf16 first decode step against a bf16 prefill over the extended prompt,
#: of the largest logit.  The two round in different places (decode rounds
#: the softmax probabilities to bf16, the flash kernel keeps them in float32;
#: GEMMs of 4 and 4100 rows), each activation to 2⁻⁹ of its value per
#: rounding, through 16 layers.  Measured 3.5e-3 on an H100; the limit is
#: 2⁻⁶ (1.6e-2), while a decode that reads a wrong slot or position moves
#: the logits by a large share of their magnitude
LM_BF16_RTOL = 2.0 ** -6


def lm_oracle_logits(cfg, params, tokens, n_last: int):
    """Float64 logits [B, n_last, Vp] at the last ``n_last`` positions of
    tokens [B, S]: a plain forward over the port's parameters (embedding,
    RMSNorm, interleaved RoPE with the model's float32 angles, masked
    softmax attention with the KV heads repeated, SwiGLU, tied logits), one
    prompt at a time so that a layer's scores stay [H, S, S]."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.lm import layer_params
    from torch.utils import _pytree as pytree

    if cfg.qkv_bias or not cfg.tie_embeddings:
        raise ValueError(f"the oracle covers untied-bias-free llama configs, not {cfg.name}")
    p64 = pytree.tree_map(lambda t: t.double(), params)
    S, hd, G = tokens.shape[1], cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    freqs = 1.0 / cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device="cuda") / hd)
    ang = (torch.arange(S, dtype=torch.float32, device="cuda")[:, None] * freqs).double()
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]            # [S, 1, hd/2]
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()

    def norm(x, g):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg.rms_eps) * g

    def rope(x):  # [S, heads, hd]: pairs (2i, 2i + 1) rotate
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).flatten(-2)

    out = []
    for b in range(tokens.shape[0]):
        x = p64["embed"][tokens[b]]                                 # [S, d]
        for w in layer_params(cfg, p64):
            at, mlp = w["attn"], w["mlp"]
            h = norm(x, w["ln1"])
            q = rope(torch.einsum("sd,dhk->shk", h, at["wq"]))
            k = rope(torch.einsum("sd,dhk->shk", h, at["wk"])).repeat_interleave(G, 1)
            v = torch.einsum("sd,dhk->shk", h, at["wv"]).repeat_interleave(G, 1)
            a = (torch.einsum("qhk,thk->hqt", q, k) / math.sqrt(hd)).masked_fill(
                ~mask, float("-inf")).softmax(-1)
            o = torch.einsum("hqt,thk->qhk", a, v)
            x = x + torch.einsum("qhk,hkd->qd", o, at["wo"])
            h = norm(x, w["ln2"])
            x = x + (F.silu(h @ mlp["w_gate"]) * (h @ mlp["w_up"])) @ mlp["w_down"]
        out.append(norm(x[-n_last:], p64["final_norm"]) @ p64["embed"].T)
    return torch.stack(out)


def lm_float32_leg(cfg, prompts, kernels, expected: dict, label: str):
    """Prefill and two decode steps of ``cfg`` in float32 (weights from
    ``torch.Generator`` seed 0 on the card), each fed the argmax token,
    against ``lm_oracle_logits`` over the extended sequence (causal, so
    position T - 1 + i of one forward is the i-th step's logits), within
    LM_F32_RTOL; the flash kernels must launch as ``expected``.  Returns
    (errors, launches)."""
    import torch
    from repro_torch.models import registry

    T = prompts.shape[1]
    api = registry.build(cfg)
    with torch.inference_mode():
        params = api.init(seed=SEED, device="cuda")
        torch.cuda.synchronize()
        reset(kernels)
        logits, cache = api.prefill(params, {"tokens": prompts}, cache_len=T + 2)
        steps, toks = [logits], [logits.argmax(-1)]
        for i in range(2):
            logits, cache = api.decode_step(params, toks[-1], T + i, cache)
            steps.append(logits)
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        launches = read_launches(label, kernels, expected)
        seq = torch.cat([torch.as_tensor(prompts, device="cuda").long(), toks[0][:, None],
                         toks[1][:, None]], dim=1)
        want = lm_oracle_logits(cfg, params, seq, n_last=3)
        errors = {name: rel_err(got, want[:, j]) for j, (name, got) in
                  enumerate(zip(("prefill", "decode_1", "decode_2"), steps))}
        del params, cache, want, steps
    torch.cuda.empty_cache()
    log({"path": label, "arch": cfg.name, "errors": errors, "limit": LM_F32_RTOL,
         "launches": launches})
    check_within(label, errors, dict.fromkeys(errors, LM_F32_RTOL))
    return errors, launches


#: path D's reduced float32 leg: the reduced llama3.2-1b (2 layers, head dim
#: 16, 4 heads over 2 KV heads), 2 prompts of 64 tokens, the shape of the
#: small-head-dim flash kernel (mma), which no full-width model takes
LM_REDUCED_B, LM_REDUCED_T = 2, 64


def lm_serve_path(kernels) -> dict:
    """Path D, LM serving on llama3.2-1b at full width and depth, weights
    from ``torch.Generator`` seed 0 on the card, prompts drawn with numpy
    seed 0.  (i) float32 (the same config with float32 parameters and
    activations): prefill and two decode steps against the float64 forward
    (``lm_float32_leg``), 16 ``flash_attention_tf32`` launches; then the
    reduced config in float32 the same way, where head dim 16 takes
    ``flash_attention``'s mma kernel (one launch a layer).  (ii) bf16:
    ``Server.generate`` of LM_NEW tokens after a
    short warm-up, timed; the flash kernel must launch once per layer; then
    the first decode step against a bf16 prefill over the extended prompt
    (finite, within LM_BF16_RTOL), and the device's share of busy time over
    16 decode steps and one prefill under the profiler."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.serve_lm import Server

    cfg = get_config(LM_ARCH)
    n_layers = cfg.n_layers
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_B, LM_T)).astype(np.int32)
    prompt_t = torch.as_tensor(prompts, device="cuda").long()

    # (i) float32 against the float64 forward: the full model (the TF32
    # tensor-core flash kernel), then the reduced one (the mma kernel)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    f32_errors, launches_f32 = lm_float32_leg(
        cfg32, prompts, kernels, {"flash_attention_tf32": n_layers, "flash_attention": 0,
                                  "flash_attention_wgmma": 0}, "lm_serve_float32")
    small = get_config(LM_ARCH).reduced()
    small_prompts = np.random.default_rng(SEED).integers(
        0, small.vocab_size, (LM_REDUCED_B, LM_REDUCED_T)).astype(np.int32)
    small_errors, launches_small = lm_float32_leg(
        small, small_prompts, kernels, {"flash_attention": small.n_layers,
                                        "flash_attention_tf32": 0, "flash_attention_wgmma": 0},
        "lm_serve_float32_reduced")

    # (ii) bf16 through Server.generate
    server = Server(cfg, cache_len=LM_T + LM_NEW, seed=SEED, device="cuda")
    server.generate({"tokens": prompts[:, :64]}, 2)  # warm-up: handles, loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    res = server.generate({"tokens": prompts}, LM_NEW)
    launches = read_launches("lm serve path", kernels,
                             {"flash_attention_wgmma": n_layers, "flash_attention": 0,
                              "flash_attention_tf32": 0})
    peak = torch.cuda.max_memory_allocated()
    api16, p16 = server.api, server.params
    with torch.inference_mode():
        logits0, cache = api16.prefill(p16, {"tokens": prompts}, cache_len=LM_T + LM_NEW)
        tok = logits0.argmax(-1)
        logits1, cache = api16.decode_step(p16, tok, LM_T, cache)
        ref1, _ = api16.prefill(p16, {"tokens": torch.cat([prompt_t, tok[:, None]], 1)},
                                cache_len=LM_T + LM_NEW)
        finite = all(bool(torch.isfinite(t).all()) for t in (logits0, logits1, ref1))
        bf16_err = rel_err(logits1, ref1)
        first_tokens_equal = bool(np.array_equal(tok.cpu().numpy(), res.tokens[:, 0]))
        state = {"tok": logits1.argmax(-1), "pos": LM_T + 1, "cache": cache}

        def decode_step():
            lg, state["cache"] = api16.decode_step(p16, state["tok"], state["pos"],
                                                   state["cache"])
            state["tok"] = lg.argmax(-1)
            state["pos"] += 1

        def prefill():
            api16.prefill(p16, {"tokens": prompts}, cache_len=LM_T + LM_NEW)

        profiles = {name: _busy(*device_events(fn, calls))
                    for name, fn, calls in (("decode", decode_step, 16),
                                            ("prefill", prefill, 1))}
        del cache, state
    out = dict(
        path="lm_serve", arch=cfg.name, n_params=server.api.n_params(), batch=LM_B,
        prompt_len=LM_T, new_tokens=LM_NEW, cache_len=LM_T + LM_NEW,
        prefill_ms=1e3 * res.prefill_s,
        decode_ms_per_step=1e3 * res.decode_s / (LM_NEW - 1),
        decode_tokens_per_s=LM_B * (LM_NEW - 1) / res.decode_s,
        generate_tokens_per_s=res.tokens_per_s,
        launches=launches, launches_float32=launches_f32,
        launches_float32_reduced=launches_small,
        max_memory_allocated=peak, float32_errors=f32_errors,
        float32_reduced_errors=small_errors,
        bf16_decode_vs_prefill=bf16_err, bf16_limit=LM_BF16_RTOL,
        logits_finite=finite, first_tokens_equal=first_tokens_equal,
        profile=profiles)
    log(out)
    check_within("lm bf16 path", {"decode_vs_prefill": bf16_err},
                 {"decode_vs_prefill": LM_BF16_RTOL})
    if not finite or not first_tokens_equal:
        raise AssertionError(f"lm bf16 path: finite {finite}, "
                             f"first tokens equal {first_tokens_equal}")
    del server
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 6: path E, LM training
# ---------------------------------------------------------------------------
#: E1's cases (B, H, Hkv, T, D, dtype, causal): llama3.2-1b's per-microbatch
#: attention (a global batch of 8 × 1024 in 2 microbatches) in float32 and
#: bf16, causal and not; head dim 16 at G = 1 and T = 100, not a multiple
#: of the kernels' 64-row tile (the reduced configs); head dim 128 at G = 4
#: and T = 257 (llama3.2-3b, qwen2-1.5b), in float32 and bf16.  bf16 at head
#: dim 64 and 128 takes the wgmma route, float32 there the tf32 route, head
#: dim 16 the SIMT route
BWD_CASES = ((4, 32, 8, 1024, 64, "float32", True), (4, 32, 8, 1024, 64, "float32", False),
             (4, 32, 8, 1024, 64, "bfloat16", True), (4, 32, 8, 1024, 64, "bfloat16", False),
             (2, 4, 4, 100, 16, "float32", True), (2, 4, 4, 100, 16, "float32", False),
             (1, 8, 2, 257, 128, "float32", True), (1, 8, 2, 257, 128, "bfloat16", True),
             (4, 16, 16, 1024, 128, "bfloat16", True), (4, 16, 16, 1024, 128, "float32", True))
#: the backward kernel against its plain version in float64 on the same
#: inputs, of each output's largest magnitude.  float32: every product and
#: sum in float32 (~6e-8 a rounding), over sums of up to T terms in another
#: order than the plain version's, and P recomputed through exp2 of scores
#: scaled once; the tf32 route's products as three TF32 terms (about 2⁻²¹
#: of each product; its CPU emulation ≤ 5.2e-7); measured below 4e-6 on an
#: H100.  bf16: the outputs are
#: rounded to bf16 (2⁻⁹ of each value), and o, the forward's bf16 output,
#: enters Δ as it is; measured about 3e-3
BWD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: the shape of the wgmma route's summary row: the main path's (E3)
#: backward; the tf32 route's row is the same shape in float32 (E2's
#: widths), the SIMT route's the head dim 16 case (E4's)
BWD_MAIN = (4, 32, 8, 1024, 64, "bfloat16", True)
BWD_MAIN_F32 = (4, 32, 8, 1024, 64, "float32", True)
BWD_SIMT = (2, 4, 4, 100, 16, "float32", True)
#: E2: llama3.2-1b's widths at 2 layers, batch 2 × 256 in 2 microbatches
#: (so the step's accumulators add and divide), float32
TRAIN_E2_LAYERS, TRAIN_E2_B, TRAIN_E2_T, TRAIN_E2_MICRO = 2, 2, 256, 2
#: E2's AdamW steps timed after the checked ones (the first not counted)
TRAIN_E2_TIMED = 4
#: E2's SGD step: p − lr·g with lr 2^20 (exact in float32) leaves the
#: step's own gradient in (p − p') / lr, to a rounding of p' over 2^20
TRAIN_E2_SGD_LR = 2.0 ** 20
#: E2's limits against the float64 oracle: the loss and the step's
#: ``grad_norm`` relative; each leaf of the step's gradient of its largest
#: magnitude (float32 products and sums in another order, back through the
#: network); the post-AdamW parameters against AdamW's first step in
#: float64 on the step's gradient, of each leaf's largest magnitude
TRAIN_E2_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "grads": 1e-4, "params": 1e-5}
#: E3: llama3.2-1b at full width and depth, bf16, global batch 8 × 1024
#: (2 microbatches), 6 steps
TRAIN_E3_B, TRAIN_E3_T, TRAIN_E3_STEPS = 8, 1024, 6
#: E3's step 0 loss: the logits are near uniform at init, so within this
#: of ln(vocab)
TRAIN_E3_LOSS0_SLACK = 1.5
#: E4: the reduced config, 10 steps straight against 5 + a resume to 10
TRAIN_E4_B, TRAIN_E4_T, TRAIN_E4_STEPS = 4, 64, 10
#: E4's resumed last loss against the straight run's when they are not
#: bitwise equal (reported): float32 sums of the same operations in another
#: order
TRAIN_E4_RTOL = 1e-6
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train"


def bwd_device_ms(fn, calls: int = 5, by_kernel: dict | None = None):
    """Device ms a call of ``fn`` (the backward wrapper: two kernels a
    call), from the first of up to WINDOWS profiled windows that lists
    2·``calls`` ``flash_bwd`` kernels (any route's: the names of every
    route's two kernels hold ``flash_bwd``); None when none did (the counts
    are logged when it took more than one window).  Five calls: late in the
    smoke, windows of 10 calls of the 3.8 ms backward listed 13 of the 20
    kernels, window after window, on an H100.  ``by_kernel``, when given,
    receives each kernel's device ms a call by its name (to 60 characters)."""
    counts = []
    for _ in range(WINDOWS):
        events, _ = device_events(fn, calls)
        mine = [e for e in events if "flash_bwd" in e.name]
        counts.append((len(mine), len(events)))
        if len(mine) == 2 * calls:
            break
    if len(counts) > 1:
        log({"profiler_windows": "flash_attention_bwd", "listed_and_all": counts,
             "calls": calls})
    if len(mine) != 2 * calls:
        return None
    if by_kernel is not None:
        for e in mine:
            key = e.name[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return sum(e.time_range.elapsed_us() for e in mine) / 1e3 / calls


def flash_bwd_rows(rng, cases=BWD_CASES, path: str = "E1") -> list:
    """E1: ``flash_attention_bwd`` at ``cases`` (BWD_CASES, or path G's
    MLA_BWD_CASES, whose v head dim Dv follows D, or CROSS_BWD_CASES, whose
    T is the pair (T, Tk); the route ``bwd_variant`` names) against ``ref.flash_attention_bwd_ref`` in float64 on the same
    inputs (o from the forward kernel), within BWD_RTOL of each output's
    largest magnitude, two calls bitwise equal; timed with CUDA events
    beside the route's plain version (device ms also by kernel,
    ``device_kernels``), SDPA's backward (``library_ms``: the forward outside
    the timed window, ``torch.autograd.grad`` timed; ``library_refused``
    with the reason where SDPA refuses) and its bound: the five T×T
    products of the backward (the causal half where causal), three over D
    (S, dQ, dK) and two over Dv (dP, dV), at the tensor-core peak of the
    dtype (bf16 989, TF32 495 TFLOP/s, one term; T·Tk pairs where Tk ≠ T),
    against q, k, v, o, dO read and dQ, dK, dV written once; float32 rows also ``tc_bound_ms``, the
    products as three TF32 terms; every row also ``exp_bound_ms``, the two
    exp2 passes of the causal half's (or every) score given the forward's L
    (P in the dq kernel, Pᵀ in the dkdv kernel) at EXP_PER_CLOCK_SM a clock
    on every SM at the maximum SM clock.  At BWD_MAIN and BWD_MAIN_F32 the
    SIMT route (``bwd_launch("simt", ...)``) is timed in turns beside them,
    events and device ms (``simt_ms``; ``simt_device_ms`` from windows of
    five calls, else of one: windows of five calls of the SIMT float32
    backward were seen to list 2 of their 10 kernels, window after window).
    Where ``lse_route`` holds (bf16 at every wgmma pair, float32 at (64, 64)
    and (128, 128)) the route runs as autograd runs it, given the forward's
    L (``flash_attention(..., return_lse=True)``), and the call without L
    (the dq kernel's own pass for it) is gated and timed beside it the same
    way (``no_lse``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    exp_rate = EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count \
        * sm_clock_hz()
    rows = []
    for case in cases:
        B, H, Hkv, T, D = case[:5]
        Dv, dtype, causal = case[5:] if len(case) == 8 else (D, *case[5:])
        T, Tk = T if isinstance(T, tuple) else (T, T)
        dt = getattr(torch, dtype)
        q = normal(rng, (B, H, T, D)).to(dt)
        k = normal(rng, (B, Hkv, Tk, D)).to(dt)
        v = normal(rng, (B, Hkv, Tk, Dv)).to(dt)
        do = normal(rng, (B, H, T, Dv)).to(dt)
        lse = None
        if tflash.lse_route(dt, D, Dv):
            o, lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
        else:
            o = tflash.flash_attention(q, k, v, causal)
        route = tflash.bwd_variant(dt, D, Dv)
        want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                           causal=causal)
        label = (f"{path} flash_attention_bwd {(B, H, Hkv, T, Tk, D, Dv)} {dtype} "
                 f"causal={causal} {route}")
        checked = {}
        for given in ((lse, None) if lse is not None else (None,)):
            got = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=given)
            again = tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=given)
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            errors = {name: rel_err(g, w) for name, g, w in zip(("dq", "dk", "dv"), got, want)}
            max_abs = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
            what = label + (" given L" if given is not None else "")
            check_within(what, errors, dict.fromkeys(errors, BWD_RTOL[dtype]))
            if not bitwise:
                raise AssertionError(f"{what}: two calls differ")
            checked[given is not None] = (errors, max_abs, bitwise)
            del got, again
        errors, max_abs, bitwise = checked[lse is not None]
        del want

        def kernel():
            tflash.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)

        def no_lse():
            tflash.flash_attention_bwd(q, k, v, o, do, causal)

        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        extra = {}
        try:  # the yardstick only: the port never calls SDPA
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                 enable_gqa=True)
            torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError as e:
            out = None
            extra["library_refused"] = str(e)[:300]

        def library():
            torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

        def simt():
            tflash.bwd_launch("simt", q, k, v, o, do, causal)

        main = case in (BWD_MAIN, BWD_MAIN_F32)
        times = time_in_turns({"kernel": kernel, **({"library": library} if out is not None
                                                     else {}),
                               **({"simt": simt} if main else {}),
                               **({"no_lse": no_lse} if lse is not None else {})})
        pairs = B * H * (T * (T + 1) // 2 if causal else T * Tk)
        nbytes = q.element_size() * 2 * (B * H * T + B * Hkv * Tk) * (D + Dv)
        flops = 2 * pairs * (3 * D + 2 * Dv)
        peak = BF16_OPS_PER_S if dt == torch.bfloat16 else TF32_OPS_PER_S
        bms, by = bound_ms(nbytes, flops, peak)
        if dt == torch.float32:
            extra["tc_bound_ms"] = bound_ms(nbytes, 3 * flops, peak)[0]
        extra["exp_bound_ms"] = 1e3 * 2 * pairs / exp_rate
        split = {}
        shape = dict(B=B, H=H, Hkv=Hkv, T=T, D=D, dtype=dtype)
        if Dv != D:
            shape = dict(B=B, H=H, Hkv=Hkv, T=T, D=D, Dv=Dv, dtype=dtype)
        if Tk != T:
            shape = dict(B=B, H=H, Hkv=Hkv, T=T, Tk=Tk, D=D, dtype=dtype)
        row = dict(shape=shape, causal=causal,
                   route=route, errors=errors, max_abs_err=max_abs, limit=BWD_RTOL[dtype],
                   bitwise_repeat=bitwise, kernel_ms=times["kernel"],
                   device_ms=bwd_device_ms(kernel, by_kernel=split), device_kernels=split,
                   plain_ms=time_ms(lambda: tflash.BWD_PLAIN[route](
                       q, k, v, o, do, causal=causal), reps=5, warmup=1),
                   library_ms=times.get("library"), bound_ms=bms, bound_by=by,
                   bound_peak="bf16 tensor cores" if dt == torch.bfloat16
                   else "TF32 tensor cores, one term", **extra)
        if lse is not None:
            split_no_lse = {}
            row["no_lse"] = dict(errors=checked[False][0], max_abs_err=checked[False][1],
                                 bitwise_repeat=checked[False][2], kernel_ms=times["no_lse"],
                                 device_ms=bwd_device_ms(no_lse, by_kernel=split_no_lse),
                                 device_kernels=split_no_lse)
        if main:
            simt_device = bwd_device_ms(simt)
            if simt_device is None:  # then from windows of one call
                simt_device = bwd_device_ms(simt, 1)
            row.update(simt_ms=times["simt"], simt_device_ms=simt_device)
        rows.append(row)
        log({"kernel": "flash_attention_bwd", "path": path, **row})
        del q, k, v, o, do, lse, qs, ks, vs, out
    torch.cuda.empty_cache()
    return rows


def plain_attention(q, k, v, *, causal=True, prefix_len=None, window=None):
    """``models.attention.flash_attention`` by the plain version on any
    device, in the inputs' dtype (float64 for the oracle), with the
    prefix-LM mask of ``prefix_len``; autograd differentiates it.  A window
    raises, as ``flash_attention``'s does."""
    from repro_torch.kernels import ref

    if window is not None:
        raise NotImplementedError("plain_attention takes no window")
    return ref.flash_attention_ref(q, k, v, causal=causal, prefix_len=prefix_len).to(q.dtype)


def oracle_loss_and_grads(api, params, batch):
    """(loss, gradient tree) of ``api.loss`` at ``params`` with
    ``plain_attention`` in place of ``models.attention.flash_attention``
    (by name, for the call)."""
    import torch
    from repro_torch.models import attention as tattn
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    kept, tattn.flash_attention = tattn.flash_attention, plain_attention
    try:
        loss, _ = api.loss(pytree.tree_unflatten(xs, spec), batch)
        grads = torch.autograd.grad(loss, xs)
    finally:
        tattn.flash_attention = kept
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def tree_errors(got, want) -> dict:
    """Each leaf's ``rel_err`` by its path."""
    from torch.utils import _pytree as pytree

    g, _ = pytree.tree_flatten_with_path(got)
    w = pytree.tree_leaves(want)
    return {pytree.keystr(path): rel_err(a, b) for (path, a), b in zip(g, w)}


def adamw_first_step64(params, grads, lr: float, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1, clip_norm=1.0):
    """AdamW's first step from zero moments in float64, written from its
    formulas (``optim.adamw`` takes every leaf to float32): the gradient
    clipped to global norm ``clip_norm``; m = (1 − b1)·g and v = (1 − b2)·g²,
    each divided by its bias correction; p − lr·(m̂ / (√v̂ + eps) +
    weight_decay·p).  The defaults are ``optim.adamw``'s."""
    import torch
    from torch.utils import _pytree as pytree

    ps, spec = pytree.tree_flatten(params)
    gs = [g.double() for g in pytree.tree_leaves(grads)]
    norm = torch.sqrt(sum(g.square().sum() for g in gs))
    scale = torch.clamp(clip_norm / (norm + 1e-9), max=1.0)
    out = []
    for p, g in zip(ps, gs):
        p, g = p.double(), g * scale
        m_hat = (1 - b1) * g / (1 - b1)
        v_hat = (1 - b2) * g * g / (1 - b2)
        out.append(p - lr * (m_hat / (v_hat.sqrt() + eps) + weight_decay * p))
    return pytree.tree_unflatten(out, spec)


def train_step_leg(kernels) -> dict:
    """E2: ``make_train_step`` of llama3.2-1b's widths at TRAIN_E2_LAYERS
    layers in float32 on the card, batch TRAIN_E2_B × TRAIN_E2_T from
    ``lm_data`` in TRAIN_E2_MICRO microbatches (the TF32 forward and the
    TF32 backward, remat ``full``), once with AdamW and once with SGD at
    TRAIN_E2_SGD_LR, whose update gives back the step's accumulated
    gradient.  The oracle is the same port functions in float64 through the
    plain attention (``oracle_loss_and_grads``) on the whole batch: the AdamW
    step's loss and ``grad_norm``, the SGD step's gradient leaf for leaf,
    and the AdamW step's parameters against ``adamw_first_step64`` of that
    gradient.  (AdamW's first step is nearly sign(g)·lr for every element,
    so a gradient within rounding of 0 flips an element by up to 2·lr
    whatever the kernels did: the update against the oracle's own gradient
    is reported, ``params_vs_oracle_grads``, not held.)"""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import make_train_plan, make_train_step
    from repro_torch.models import registry
    from repro_torch.optim import adamw, sgd
    from torch.utils import _pytree as pytree

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_E2_LAYERS,
                              act_dtype="float32", param_dtype="float32")
    shape = ShapeSpec("e2", TRAIN_E2_T, TRAIN_E2_B, "train")
    api = registry.build(cfg)
    params = api.init(seed=SEED, device="cuda")
    batch = lm_data._batch_for_step(cfg, shape, SEED, 0, "cuda")
    plan = dataclasses.replace(make_train_plan(cfg, shape, make_smoke_mesh()),
                               n_microbatches=TRAIN_E2_MICRO)
    lr = 3e-4
    opt, descent = adamw(lr), sgd(TRAIN_E2_SGD_LR)
    torch.cuda.synchronize()
    reset(kernels)
    adam_params, _, metrics = make_train_step(cfg, api, opt, plan)(
        params, opt.init(params), batch)
    sgd_params, _, sgd_metrics = make_train_step(cfg, api, descent, plan)(
        params, descent.init(params), batch)
    torch.cuda.synchronize()
    n = 2 * cfg.n_layers * plan.n_microbatches
    launches = read_launches("E2 train steps", kernels, {
        "flash_attention_tf32": 2 * n, "flash_attention_bwd_tf32": n,
        "flash_attention_bwd": 0, "flash_attention": 0, "flash_attention_wgmma": 0,
        "flash_attention_bwd_wgmma": 0})
    # the AdamW step's time (host wall ended by a synchronise, the median of
    # the steps after the first) and one profiled step: device busy, idle share
    step_fn, state = make_train_step(cfg, api, opt, plan), opt.init(params)
    times = []
    for _ in range(TRAIN_E2_TIMED):
        t0 = time.perf_counter()
        step_fn(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    events, wall = device_events(lambda: step_fn(params, state, batch), 1)
    timing = dict(step_ms=1e3 * statistics.median(times[1:]),
                  step_ms_each=[1e3 * t for t in times], profile=_busy(events, wall))
    del state, events
    step_grads = pytree.tree_map(lambda p, q: (p.double() - q.double()) / TRAIN_E2_SGD_LR,
                                 params, sgd_params)
    cfg64 = dataclasses.replace(cfg, act_dtype="float64", param_dtype="float64")
    params64 = pytree.tree_map(lambda t: t.double(), params)
    loss64, grads64 = oracle_loss_and_grads(registry.build(cfg64), params64, batch)
    norm64 = math.sqrt(sum(float(g.square().sum()) for g in pytree.tree_leaves(grads64)))
    errors = {"loss": abs(float(metrics["loss"]) - float(loss64)) / abs(float(loss64)),
              "grad_norm": abs(float(metrics["grad_norm"]) - norm64) / norm64,
              "grads": max(tree_errors(step_grads, grads64).values()),
              "params": max(tree_errors(adam_params, adamw_first_step64(
                  params, step_grads, lr)).values())}
    out = dict(path="train_step", arch=cfg.name, n_layers=cfg.n_layers,
               batch=TRAIN_E2_B, seq=TRAIN_E2_T, n_microbatches=plan.n_microbatches,
               loss=float(metrics["loss"]), loss_oracle=float(loss64),
               grad_norm=float(metrics["grad_norm"]), grad_norm_oracle=norm64,
               steps_equal_grad_norm=float(sgd_metrics["grad_norm"])
               == float(metrics["grad_norm"]),
               errors=errors, limits=TRAIN_E2_RTOL,
               grad_errors=tree_errors(step_grads, grads64),
               params_vs_oracle_grads=max(tree_errors(adam_params, adamw_first_step64(
                   params, grads64, lr)).values()),
               launches=launches, **timing)
    log(out)
    check_within("E2 train step", errors, TRAIN_E2_RTOL)
    del params, adam_params, sgd_params, step_grads, params64, grads64
    torch.cuda.empty_cache()
    return out


def train_full_leg(kernels) -> dict:
    """E3: llama3.2-1b at full width and depth, bf16 parameters, AdamW as
    configured, remat ``full``, through ``run_training`` (no checkpoint)
    for TRAIN_E3_STEPS steps of TRAIN_E3_B × TRAIN_E3_T (2 microbatches):
    step ms and tokens/s (host wall of a step, ended by reading its loss;
    the median of the steps after the first), peak bytes, the flash
    launches a step (each layer's forward twice a microbatch under remat,
    its backward once), then one more step profiled (device busy against
    wall, idle share, top kernels).  Gates: every loss finite, step 0's
    within TRAIN_E3_LOSS0_SLACK of ln(vocab_size)."""
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import make_train_plan, make_train_step, run_training
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer

    cfg = get_config(LM_ARCH)
    shape = ShapeSpec("e3", TRAIN_E3_T, TRAIN_E3_B, "train")
    plan = make_train_plan(cfg, shape, make_smoke_mesh())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    params, history = run_training(cfg, steps=TRAIN_E3_STEPS, batch_size=TRAIN_E3_B,
                                   seq_len=TRAIN_E3_T, seed=SEED, log_every=1,
                                   device="cuda")
    torch.cuda.synchronize()
    per_step = cfg.n_layers * plan.n_microbatches
    launches = read_launches("E3 llama3.2-1b training", kernels, {
        "flash_attention_wgmma": 2 * per_step * TRAIN_E3_STEPS,
        "flash_attention_bwd_wgmma": per_step * TRAIN_E3_STEPS, "flash_attention_bwd": 0,
        "flash_attention_bwd_tf32": 0, "flash_attention": 0, "flash_attention_tf32": 0})
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    step_s = statistics.median(h["time_s"] for h in history[1:])
    api = registry.build(cfg)
    opt = make_optimizer(cfg.optimizer, 3e-4)
    state = opt.init(params)
    batch = lm_data._batch_for_step(cfg, shape, SEED, TRAIN_E3_STEPS, "cuda")
    step_fn = make_train_step(cfg, api, opt, plan)
    events, wall = device_events(lambda: step_fn(params, state, batch), 1)
    profile = _busy(events, wall)
    # the backward's kernels by name: device ms and launches of the step
    backward = {}
    for e in events:
        if "flash_bwd" in e.name:
            ms, n = backward.get(e.name[:90], (0.0, 0))
            backward[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    profile.update(backward_kernels={k: list(v) for k, v in backward.items()},
                   backward_ms=sum(ms for ms, _ in backward.values()))
    del params, state
    torch.cuda.empty_cache()
    out = dict(path="train_full", arch=cfg.name, n_params=api.n_params(),
               steps=TRAIN_E3_STEPS, batch=TRAIN_E3_B, seq=TRAIN_E3_T,
               n_microbatches=plan.n_microbatches, losses=losses,
               step_ms=1e3 * step_s, step_ms_each=[1e3 * h["time_s"] for h in history],
               tokens_per_s=TRAIN_E3_B * TRAIN_E3_T / step_s, max_memory_allocated=peak,
               flash_launches_per_step={"forward": launches["flash_attention_wgmma"]
                                        / TRAIN_E3_STEPS,
                                        "backward": launches["flash_attention_bwd_wgmma"]
                                        / TRAIN_E3_STEPS},
               profile=profile, launches=launches)
    log(out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"E3: a loss is not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > TRAIN_E3_LOSS0_SLACK:
        raise AssertionError(f"E3: step 0 loss {losses[0]} is not within "
                             f"{TRAIN_E3_LOSS0_SLACK} of ln({cfg.vocab_size})")
    return out


def train_resume_leg(kernels) -> dict:
    """E4: the reduced llama3.2-1b (float32, head dim 16: the mma forward
    and the backward kernel) on the card, TRAIN_E4_STEPS steps straight
    against half of them, then a resume to all (``schedule_steps`` fixed),
    each run checkpointing into a fresh directory: the resumed run starts
    at the checkpoint's step and its last loss is the straight run's
    (bitwise, else reported and held within TRAIN_E4_RTOL).  Then the
    ``train_lm`` example (``--tiny``, a fresh checkpoint directory), whose
    data monitor launches ``cofactor_update`` once a batch: the mean loss
    of its last 10 steps must be below that of its first 10."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import run_training

    cfg = get_config(LM_ARCH).reduced()
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=TRAIN_DIR))
    kw = dict(batch_size=TRAIN_E4_B, seq_len=TRAIN_E4_T, checkpoint_every=TRAIN_E4_STEPS // 2,
              log_every=0, device="cuda")
    try:
        reset(kernels)
        _, straight = run_training(cfg, steps=TRAIN_E4_STEPS,
                                   checkpoint_dir=str(root / "straight"), **kw)
        run_training(cfg, steps=TRAIN_E4_STEPS // 2, checkpoint_dir=str(root / "resumed"),
                     schedule_steps=TRAIN_E4_STEPS, **kw)
        _, resumed = run_training(cfg, steps=TRAIN_E4_STEPS,
                                  checkpoint_dir=str(root / "resumed"),
                                  schedule_steps=TRAIN_E4_STEPS, **kw)
        torch.cuda.synchronize()
        steps_run = 2 * TRAIN_E4_STEPS
        launches = read_launches("E4 resume", kernels, {
            "flash_attention": 2 * cfg.n_layers * steps_run,
            "flash_attention_bwd": cfg.n_layers * steps_run,
            "flash_attention_tf32": 0, "flash_attention_wgmma": 0,
            "flash_attention_bwd_wgmma": 0, "flash_attention_bwd_tf32": 0})
        reset(kernels)
        t0 = time.perf_counter()
        example = train_lm.main(["--tiny", "--ckpt", str(root / "example")])
        example_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        tiny = train_lm.lm_tiny()
        n = len(example)
        example_launches = read_launches("E4 train_lm example", kernels, {
            "cofactor_update": n, "flash_attention": 2 * tiny.n_layers * n,
            "flash_attention_bwd": tiny.n_layers * n, "flash_attention_bwd_wgmma": 0,
            "flash_attention_bwd_tf32": 0})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    last, last_resumed = straight[-1]["loss"], resumed[-1]["loss"]
    first10 = statistics.mean(h["loss"] for h in example[:10])
    last10 = statistics.mean(h["loss"] for h in example[-10:])
    out = dict(path="train_resume", arch=cfg.name, steps=TRAIN_E4_STEPS,
               resumed_from=resumed[0]["step"], last_loss=last,
               last_loss_resumed=last_resumed, bitwise=last == last_resumed,
               rel_diff=abs(last - last_resumed) / abs(last), launches=launches,
               example=dict(steps=n, seconds=example_s, first10_mean=first10,
                            last10_mean=last10, launches=example_launches))
    log(out)
    if resumed[0]["step"] != TRAIN_E4_STEPS // 2:
        raise AssertionError(f"E4: the resumed run started at step {resumed[0]['step']}")
    check_within("E4 resume", {"last_loss": out["rel_diff"]}, {"last_loss": TRAIN_E4_RTOL})
    if not last10 < first10:
        raise AssertionError(f"E4 example: loss did not fall ({first10} -> {last10})")
    return out


def train_phase(kernels, laps: Laps) -> dict:
    """Path E, LM training: E1 the backward kernel against its plain
    version and both directions at the cross-attention shape
    (``cross_attention_rows``) and under the prefix-LM mask
    (``vlm_attention_rows``; comparison launches, not the path's), then with the counts
    reset before each leg E2 (one train step against float64), E3
    (llama3.2-1b at full size) and E4 (resume and the example)."""
    rows = flash_bwd_rows(np.random.default_rng(SEED))
    cross = cross_attention_rows(np.random.default_rng(SEED))
    vlm = vlm_attention_rows(np.random.default_rng(SEED))
    laps.lap("train E1 backward kernel, cross-attention and prefix-LM shapes")
    legs = [train_step_leg(kernels)]
    laps.lap("train E2 step")
    legs.append(train_full_leg(kernels))
    laps.lap("train E3 llama3.2-1b")
    legs.append(train_resume_leg(kernels))
    laps.lap("train E4 resume, example")
    return dict(rows=rows, cross=cross, vlm=vlm, legs=legs)


# ---------------------------------------------------------------------------
# Phase 7: path F, the MoE model
# ---------------------------------------------------------------------------
#: path F's model, moonshot-v1-16b-a3b: 48 layers, d 2048, 16 heads over 16
#: KV heads at head dim 128, 64 routed experts top-6 (d_expert_ff 1408), 2
#: shared, vocab 163,840, capacity factor 1.25
MOE_ARCH = "moonshot_v1_16b_a3b"
#: F1: full width at 2 layers in float32 (1.85 B parameters), 2 prompts of
#: 512 tokens (16 groups of 64 tokens, C = 8 against a mean load of 6, so
#: slots drop) and 2 decode steps; the reduced config (head dim 16: the mma
#: kernel; 4 experts top-2, capacity factor 4.0: nothing drops) on 2 prompts
#: of 64
MOE_F1_LAYERS, MOE_F1_B, MOE_F1_T = 2, 2, 512
#: F1's limit: float32 logits against the float64 forward of the same
#: functions on the float32 run's routing, of their largest magnitude.
#: float32 rounds at ~6e-8 an operation over sums of up to 2816 terms (the
#: shared experts' width), so a correct forward stays near path D's 1e-6; a
#: slot's output on the wrong token, a wrong weight or a lost expert moves
#: the logits by far more.  The reduced decode against its own float32
#: prefill over the extended prompt (nothing drops there, so both compute
#: one function, batched differently) is held to the same limit
MOE_F32_RTOL = 1e-4
#: F2: full width and depth, bf16, 4 prompts of 1024 tokens (16 groups of 256,
#: C = 32 against a mean load of 24), 32 new tokens
MOE_F2_B, MOE_F2_T, MOE_F2_NEW = 4, 1024, 32
#: F3: full width at 2 layers, bf16, AdamW as configured, remat "full",
#: 4 steps of 8 × 1024 tokens (2 microbatches of 4 × 1024)
MOE_F3_LAYERS, MOE_F3_B, MOE_F3_T, MOE_F3_STEPS = 2, 8, 1024, 4
#: moonshot's per-microbatch attention (B, H, Hkv, T, D), bf16 causal: the
#: forward and backward kernels beside SDPA's
MOE_ATTN_SHAPE = (4, 16, 16, 1024, 128)


class swapped:
    """``module.name`` replaced by ``value`` inside a ``with`` block (by
    name, as E2 swaps in ``plain_attention``)."""

    def __init__(self, module, name: str, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.kept = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.kept)


def plain_decode_attention(q, k_cache, v_cache, pos: int, *, window=None):
    """``models.attention.decode_attention`` in the inputs' dtype (the
    port's computes its scores in float32): the float64 oracle's.  With
    ``window`` the cache is a ring buffer: slots below min(pos + 1, S)."""
    import torch

    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k_cache) / math.sqrt(D)
    last = pos if window is None else min(pos, S - 1)
    s = s.masked_fill(torch.arange(S, device=q.device) > last, float("-inf"))
    return torch.einsum("bhgt,bhtd->bhgd", s.softmax(-1), v_cache).reshape(B, H, D)


def route_replay(routings: list, cfg):
    """A stand-in for ``moe.moe_route`` that hands ``routings`` back in
    order (popping each), with weights from its own router on its own x
    (the float64 oracle's), so that a near-tie in the float64 router cannot
    move an expert between two runs; and a one-item list counting the
    token-expert choices its router would have made otherwise."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.models import moe

    E, k = cfg.moe.n_experts, cfg.moe.top_k
    flips = [0]

    def replayed(cfg_, router, x):
        r = routings.pop(0)
        probs = moe.router_probs(router, x)
        own = moe.top_k(probs, k)[1]
        flips[0] += int((F.one_hot(own, E).sum(1) - F.one_hot(r.experts, E).sum(1))
                        .clamp(min=0).sum())
        return dataclasses.replace(r, weights=moe.route_weights(probs, r.experts))

    return replayed, flips


def float64_leg(cfg, prompts, kernels, expected: dict, label: str,
                own_prefill: bool, n_decode: int = 2, cache_len: int | None = None,
                inputs: dict | None = None) -> dict:
    """Prefill and ``n_decode`` decode steps of ``cfg`` in float32 (weights
    from ``torch.Generator`` seed 0 on the card) into a cache of
    ``cache_len`` (default P + T + n_decode), each step fed the argmax
    token; ``inputs`` (an encoder-decoder's ``frames``, a VLM's
    ``patches``) go to every prefill beside the prompt.  A VLM's P patches
    are positions of the sequence: its cache holds them and its decode
    steps start at P + T (P = 0 otherwise).  The flash kernels must launch as ``expected`` in the
    prefill and not at all in the decode steps.  The oracle is the same
    model functions in float64 (``plain_attention``,
    ``plain_decode_attention``) fed the same tokens: logits and every leaf
    of the cache after the last step within MOE_F32_RTOL.  With an MoE, every ``moe_route`` result is recorded and
    the oracle's ``moe_route`` replays them (experts, slots, keep) with
    weights from its own float64 router, so that a near-tie in the router
    cannot move an expert between the two runs; the token-expert choices
    the float64 router would have made otherwise and the prefill's dropped
    slots are counted.  With ``own_prefill`` each decode step is also held
    to the float32 prefill over the extended prompt."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.models import attention as tattn
    from repro_torch.models import moe, registry
    from torch.utils import _pytree as pytree

    inputs = inputs or {}
    T = prompts.shape[1]
    start = T + (inputs["patches"].shape[1] if cfg.frontend == "vision" else 0)
    cache_len = cache_len or start + n_decode
    api = registry.build(cfg)
    routings: list = []
    route = moe.moe_route

    def recorded(cfg_, router, x):
        routings.append(route(cfg_, router, x))
        return routings[-1]

    def routed(fn):
        return swapped(moe, "moe_route", fn) if cfg.moe else contextlib.nullcontext()

    with torch.inference_mode():
        params = api.init(seed=SEED, device="cuda")
        torch.cuda.synchronize()
        reset(kernels)
        with routed(recorded):
            logits, cache = api.prefill(params, {"tokens": prompts, **inputs},
                                        cache_len=cache_len)
            n_prefill = len(routings)
            prefill_launches = read_launches(f"{label} prefill", kernels, expected)
            steps, toks = [logits], [logits.argmax(-1)]
            for i in range(n_decode):
                logits, cache = api.decode_step(params, toks[-1], start + i, cache)
                steps.append(logits)
                toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        launches = read_launches(label, kernels, expected)
        got_cache = cache
        del cache
        own_errors = {}
        if own_prefill:
            seq = torch.as_tensor(prompts, device="cuda").long()
            for i in range(n_decode):
                seq = torch.cat([seq, toks[i][:, None]], dim=1)
                ref, _ = api.prefill(params, {"tokens": seq, **inputs})
                own_errors[f"decode_{i + 1}"] = rel_err(steps[i + 1], ref)
        dropped = sum(int((~r.kept).sum()) for r in routings[:n_prefill])
        dropped_tokens = sum(int((~r.kept).any(-1).sum()) for r in routings[:n_prefill])
        prefill_slots = sum(r.kept.numel() for r in routings[:n_prefill])

        cfg64 = dataclasses.replace(cfg, act_dtype="float64", param_dtype="float64")
        api64 = registry.build(cfg64)
        params64 = pytree.tree_map(lambda t: t.double(), params)
        del params
        queue = list(routings)
        replayed, flips = route_replay(queue, cfg) if cfg.moe else (None, [0])
        with swapped(tattn, "flash_attention", plain_attention), \
                swapped(tattn, "decode_attention", plain_decode_attention), \
                routed(replayed):
            want, cache = api64.prefill(params64, {"tokens": prompts, **inputs},
                                        cache_len=cache_len)
            wants = [want]
            for i in range(n_decode):
                want, cache = api64.decode_step(params64, toks[i], start + i, cache)
                wants.append(want)
        if queue:
            raise AssertionError(f"{label}: {len(queue)} routings not replayed")
        names = ["prefill"] + [f"decode_{i + 1}" for i in range(n_decode)]
        errors = {name: rel_err(got, want) for name, got, want in zip(names, steps, wants)}
        finite = all(bool(torch.isfinite(t).all()) for t in steps)
        errors.update({"cache/" + "/".join(str(key.key) for key in path): rel_err(t, w)
                       for (path, t), w in zip(pytree.tree_flatten_with_path(got_cache)[0],
                                               pytree.tree_leaves(cache))})
        del params64, cache, wants, steps, routings, got_cache
    torch.cuda.empty_cache()
    out = dict(path=label, arch=cfg.name, n_layers=cfg.n_layers, batch=prompts.shape[0],
               prompt_len=T, cache_len=cache_len, errors=errors, limit=MOE_F32_RTOL,
               decode_vs_own_prefill=own_errors, launches=launches,
               prefill_launches=prefill_launches, logits_finite=finite,
               **{f"{name}_shape": list(a.shape) for name, a in inputs.items()})
    if cfg.moe:
        out.update(prefill_slots=prefill_slots, prefill_dropped_slots=dropped,
                   prefill_tokens_with_a_drop=dropped_tokens,
                   float64_router_other_choices=flips[0])
    log(out)
    check_within(label, {**errors, **{f"own_prefill_{n}": e for n, e in own_errors.items()}},
                 dict.fromkeys([*errors, *(f"own_prefill_{n}" for n in own_errors)],
                               MOE_F32_RTOL))
    if not finite:
        raise AssertionError(f"{label}: logits not finite")
    if cfg.moe:
        # no slot can drop where C >= t (t·k/E·cf >= t): every token could
        # go to one expert and still fit
        E, k = cfg.moe.n_experts, cfg.moe.top_k
        can_drop = cfg.moe.capacity_factor * k < E
        if can_drop and not dropped:
            raise AssertionError(f"{label}: no slot dropped at capacity factor "
                                 f"{cfg.moe.capacity_factor}")
        if not can_drop and dropped:
            raise AssertionError(f"{label}: {dropped} slots dropped at capacity factor "
                                 f"{cfg.moe.capacity_factor}")
    return out


def moe_device_split(fn, calls: int) -> dict:
    """Device ms a call of ``fn`` by part, from one profiled window (opened
    and closed by the marker kernel) with ``moe_route``, ``moe_dispatch``
    and the shared experts' ``swiglu`` swapped by name for versions inside
    ``record_function`` ranges; each kernel goes to the range its launching
    op lies in: ``route`` (router, softmax, sorts, slot maps), ``experts``
    (the batched expert products, the ``aten::bmm`` ops of
    ``moe_dispatch``), ``dispatch`` (the rest of ``moe_dispatch``: the
    gathers into and out of the buffers, the SwiGLU's elementwise work, the
    weighting and the ordered combine), ``shared`` and ``other``
    (attention, projections, norms, logits).  ``dispatch_share`` is route +
    dispatch over the MoE MLP's device ms."""
    import torch
    from repro_torch.models import moe
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def g(*args, **kw):
            with record_function(name):
                return f(*args, **kw)
        return g

    parts = dict.fromkeys(("route", "experts", "dispatch", "shared", "other"), 0.0)
    with swapped(moe, "moe_route", ranged("moe_route", moe.moe_route)), \
            swapped(moe, "moe_dispatch", ranged("moe_dispatch", moe.moe_dispatch)), \
            swapped(moe, "swiglu", ranged("moe_shared", moe.swiglu)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
    kernels = 0
    for e in prof.events():
        mine = [kern for kern in e.kernels if MARKER not in kern.name]
        if not mine:
            continue
        chain, node = set(), e
        while node is not None:
            chain.add(node.name)
            node = node.cpu_parent
        if "moe_route" in chain:
            part = "route"
        elif "moe_dispatch" in chain:
            part = "experts" if "aten::bmm" in chain else "dispatch"
        else:
            part = "shared" if "moe_shared" in chain else "other"
        parts[part] += sum(kern.duration for kern in mine) / 1e3 / calls
        kernels += len(mine)
    moe_ms = sum(v for name, v in parts.items() if name != "other")
    return dict(ms_per_call=parts, kernels_listed=kernels, calls=calls,
                dispatch_share=(parts["route"] + parts["dispatch"]) / moe_ms
                if moe_ms else None)


def attention_layers(cfg) -> int:
    """The attention layers of ``cfg``: each launches one flash forward in a
    prefill (an encoder-decoder's: each encoder layer, and each decoder
    layer's self- and cross-attention)."""
    if cfg.enc_dec:
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_periods * cfg.layer_pattern.count("attn")


def serve_leg(kernels, cfg=None, path: str = "moe_serve",
              label: str = "F2 moonshot serving", extra: dict | None = None,
              mixers: tuple = (), prompt_len: int = MOE_F2_T, batch: int = MOE_F2_B,
              new: int = MOE_F2_NEW, inputs: dict | None = None,
              repeat: bool = False) -> dict:
    """F2: moonshot at full width and depth (or ``cfg``: G2's deepseek, H2's
    xlstm, J2's jamba, K2's seamless) in bf16 through ``Server`` (weights
    from ``torch.Generator`` seed 0 on the card; the peak of its init
    against the parameters' bytes), ``generate`` of ``new`` tokens for
    ``batch`` prompts of ``prompt_len`` (and ``inputs``, an
    encoder-decoder's ``frames``) after a short warm-up, timed, the flash
    kernel once an attention layer in the prefill and never in a decode
    step (also counted apart on a prefill and a decode step run again);
    peak bytes; that prefill and decode step, their tokens equal to the
    generated ones and their logits finite; with ``repeat`` a second
    ``generate``, every token equal (K2 only: F2's, H2's and J2's legs
    take 26–120 s each, and their repeats would crowd the smoke's time
    limit); device busy against wall over 16
    decode steps and one prefill; each one's device ms by part of the MoE
    MLP (``moe_device_split``), or with ``mixers`` (MIXERS, or K2's
    ENCDEC_PARTS) the prefill's busy share and device ms by range from one
    profiled prefill (``mixer_profile``).  The line carries ``extra`` (G2,
    J2: the cut of the depth)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.serve_lm import Server
    from torch.utils import _pytree as pytree

    cfg = cfg or get_config(MOE_ARCH)
    B, T, NEW = batch, prompt_len, new
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    inputs = inputs or {}
    # a VLM's patches are positions: its cache holds them, its decode starts
    # at P + T
    P = inputs["patches"].shape[1] if cfg.frontend == "vision" else 0
    flash = {"flash_attention_wgmma": attention_layers(cfg), "flash_attention": 0,
             "flash_attention_tf32": 0}
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = Server(cfg, cache_len=P + T + NEW, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(server.params))
    server.generate({"tokens": prompts[:, :64], **inputs}, 2)  # warm-up: handles, loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    res = server.generate({"tokens": prompts, **inputs}, NEW)
    launches = read_launches(label, kernels, flash)
    peak = torch.cuda.max_memory_allocated()
    repeated = {}
    if repeat:
        again = server.generate({"tokens": prompts, **inputs}, NEW)
        repeated = dict(repeat_tokens_equal=bool(np.array_equal(again.tokens, res.tokens)),
                        repeat_prefill_ms=1e3 * again.prefill_s,
                        repeat_decode_ms_per_step=1e3 * again.decode_s / (NEW - 1))
    api, params = server.api, server.params
    with torch.inference_mode():
        batch_in = {"tokens": prompts, **inputs}
        reset(kernels)
        logits0, cache = api.prefill(params, batch_in, cache_len=P + T + NEW)
        split_launches = {"prefill": read_launches(f"{label} prefill", kernels, flash)}
        reset(kernels)
        tok = logits0.argmax(-1)
        logits1, cache = api.decode_step(params, tok, P + T, cache)
        split_launches["decode_step"] = read_launches(
            f"{label} decode step", kernels, dict.fromkeys(flash, 0))
        finite = bool(torch.isfinite(logits0).all()) and bool(torch.isfinite(logits1).all())
        again = np.stack([tok.cpu().numpy(), logits1.argmax(-1).cpu().numpy()], axis=1)
        tokens_equal = bool(np.array_equal(again, res.tokens[:, :2]))
        state = {"tok": logits1.argmax(-1), "pos": P + T + 1, "cache": cache}

        def decode_step():
            lg, state["cache"] = api.decode_step(params, state["tok"], state["pos"],
                                                 state["cache"])
            state["tok"] = lg.argmax(-1)
            state["pos"] += 1

        def prefill():
            api.prefill(params, batch_in, cache_len=P + T + NEW)

        if mixers:
            profiles = {"decode": _busy(*device_events(decode_step, 16)),
                        "prefill": mixer_profile(prefill, mixers)}
            # the profiler slows a host-bound prefill: its busy time
            # against the timed, unprofiled prefill too
            profiles["prefill"]["idle_share_of_timed_prefill"] = (
                1.0 - profiles["prefill"]["device_busy_ms"] / (1e3 * res.prefill_s))
            split = {}
        else:
            profiles = {name: _busy(*device_events(fn, calls))
                        for name, fn, calls in (("decode", decode_step, 16),
                                                ("prefill", prefill, 1))}
            split = {"moe_split": {name: moe_device_split(fn, calls) for name, fn, calls in (
                ("decode", decode_step, 4), ("prefill", prefill, 1))}}
        del cache, state
    out = dict(
        path=path, arch=cfg.name, n_layers=cfg.n_layers, n_params=api.n_params(),
        n_active_params=api.n_active_params(), param_bytes=param_bytes,
        allocated_before_init=start, init_s=init_s, init_peak_bytes=init_peak, batch=B,
        prompt_len=T, new_tokens=NEW, cache_len=P + T + NEW, prefill_ms=1e3 * res.prefill_s,
        decode_ms_per_step=1e3 * res.decode_s / (NEW - 1),
        decode_tokens_per_s=B * (NEW - 1) / res.decode_s,
        generate_tokens_per_s=res.tokens_per_s, max_memory_allocated=peak,
        launches=launches, launches_apart=split_launches, logits_finite=finite,
        first_tokens_equal=tokens_equal, **repeated, profile=profiles, **split,
        **{f"{name}_shape": list(a.shape) for name, a in inputs.items()}, **(extra or {}))
    log(out)
    if not finite or not tokens_equal or not repeated.get("repeat_tokens_equal", True):
        raise AssertionError(f"{label}: finite {finite}, first tokens equal {tokens_equal}, "
                             f"repeat {repeated}")
    del server, api, params
    torch.cuda.empty_cache()
    return out


def moe_train_leg(kernels) -> dict:
    """F3: moonshot at full width and MOE_F3_LAYERS layers, bf16, AdamW as
    configured, remat ``full``, through ``run_training`` for MOE_F3_STEPS
    steps of MOE_F3_B × MOE_F3_T (2 microbatches): step ms and tokens/s (as
    E3), peak bytes, the flash launches a step; then one more step profiled
    (as E3), and one step twice from the same state: loss and every
    parameter bitwise equal (the dispatch has no float atomics).  Gates: every loss finite, step 0's
    within TRAIN_E3_LOSS0_SLACK of ln(vocab_size)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import make_train_plan, make_train_step, run_training
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer
    from torch.utils import _pytree as pytree

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_F3_LAYERS)
    shape = ShapeSpec("f3", MOE_F3_T, MOE_F3_B, "train")
    plan = make_train_plan(cfg, shape, make_smoke_mesh())
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    params, history = run_training(cfg, steps=MOE_F3_STEPS, batch_size=MOE_F3_B,
                                   seq_len=MOE_F3_T, seed=SEED, log_every=1, device="cuda")
    torch.cuda.synchronize()
    per_step = cfg.n_layers * plan.n_microbatches
    launches = read_launches("F3 moonshot training", kernels, {
        "flash_attention_wgmma": 2 * per_step * MOE_F3_STEPS,
        "flash_attention_bwd_wgmma": per_step * MOE_F3_STEPS, "flash_attention_bwd": 0,
        "flash_attention_bwd_tf32": 0, "flash_attention": 0, "flash_attention_tf32": 0})
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    step_s = statistics.median(h["time_s"] for h in history[1:])
    api = registry.build(cfg)
    opt = make_optimizer(cfg.optimizer, 3e-4)
    state = opt.init(params)
    batch = lm_data._batch_for_step(cfg, shape, SEED, MOE_F3_STEPS, "cuda")
    step_fn = make_train_step(cfg, api, opt, plan)
    # each step's parameters and loss kept on the host (its optimizer state
    # dropped), so that the second step has the first one's memory
    runs = []

    def step():
        new_params, _, metrics = step_fn(params, state, batch)
        runs.append(([t.cpu() for t in pytree.tree_leaves(new_params)],
                     metrics["loss"].cpu()))

    torch.cuda.empty_cache()
    events, wall = device_events(lambda: step_fn(params, state, batch), 1)
    for _ in range(2):
        torch.cuda.empty_cache()
        step()
    (p1, l1), (p2, l2) = runs
    bitwise = bool(torch.equal(l1, l2)) and all(torch.equal(a, b) for a, b in zip(p1, p2))
    profile = _busy(events, wall)
    del params, state, runs, p1, p2
    torch.cuda.empty_cache()
    out = dict(path="moe_train", arch=cfg.name, n_layers=cfg.n_layers, n_params=api.n_params(),
               steps=MOE_F3_STEPS, batch=MOE_F3_B, seq=MOE_F3_T,
               n_microbatches=plan.n_microbatches, losses=losses, step_ms=1e3 * step_s,
               step_ms_each=[1e3 * h["time_s"] for h in history],
               tokens_per_s=MOE_F3_B * MOE_F3_T / step_s, max_memory_allocated=peak,
               flash_launches_per_step={
                   "forward": launches["flash_attention_wgmma"] / MOE_F3_STEPS,
                   "backward": launches["flash_attention_bwd_wgmma"] / MOE_F3_STEPS},
               repeat_loss=float(l1), repeat_bitwise=bitwise, profile=profile,
               launches=launches)
    log(out)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"F3: a loss is not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > TRAIN_E3_LOSS0_SLACK:
        raise AssertionError(f"F3: step 0 loss {losses[0]} is not within "
                             f"{TRAIN_E3_LOSS0_SLACK} of ln({cfg.vocab_size})")
    if not bitwise:
        raise AssertionError("F3: two steps from one state differ")
    return out


def moe_attention_row(rng) -> dict:
    """The bf16 forward (``flash_attention_wgmma``) and backward
    (``flash_attention_bwd_wgmma``) at MOE_ATTN_SHAPE, causal: event ms in
    turns and device ms of each beside SDPA's forward and its backward
    (``torch.autograd.grad``, the forward outside the timed call), and the
    bounds of E1 and of ``flash_attention_rows``.  Comparison launches, not
    the path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash

    B, H, Hkv, T, D = MOE_ATTN_SHAPE
    q = normal(rng, (B, H, T, D)).bfloat16()
    k, v = (normal(rng, (B, Hkv, T, D)).bfloat16() for _ in range(2))
    do = normal(rng, (B, H, T, D)).bfloat16()
    o = tflash.flash_attention(q, k, v, True)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def forward():
        tflash.flash_attention(q, k, v, True)

    def backward():
        tflash.flash_attention_bwd(q, k, v, o, do, True)

    def sdpa_forward():
        F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def sdpa_backward():
        torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True)

    times = time_in_turns({"forward": forward, "backward": backward,
                           "sdpa_forward": sdpa_forward, "sdpa_backward": sdpa_backward})
    pairs = B * H * T * (T + 1) // 2
    row = dict(shape=dict(B=B, H=H, Hkv=Hkv, T=T, D=D, dtype="bfloat16"), causal=True,
               forward_ms=times["forward"],
               forward_device_ms=kernel_device_ms(forward, FLASH_KERNEL_NAMES["wgmma"]),
               backward_ms=times["backward"], backward_device_ms=bwd_device_ms(backward),
               sdpa_forward_ms=times["sdpa_forward"],
               sdpa_forward_device_ms=all_device_ms(sdpa_forward),
               sdpa_backward_ms=times["sdpa_backward"],
               sdpa_backward_device_ms=all_device_ms(sdpa_backward, calls=5),
               forward_bound_ms=bound_ms(2 * (2 * B * H * T * D + 2 * B * Hkv * T * D),
                                         2 * B * H * T * T * D, BF16_OPS_PER_S)[0],
               backward_bound_ms=bound_ms(2 * (4 * B * H * T * D + 4 * B * Hkv * T * D),
                                          5 * 2 * pairs * D, BF16_OPS_PER_S)[0])
    log({"kernel": "flash_attention at moonshot's attention", **row})
    del q, k, v, o, do, qs, ks, vs, lib_out
    torch.cuda.empty_cache()
    return row


def moe_phase(kernels, laps: Laps) -> dict:
    """Path F, moonshot-v1-16b-a3b (the MoE MLP: ``models/moe.py``), after
    path E's memory is released: the attention kernels at its shape, then
    with the counts reset before each leg F1 (float32 against float64, full
    width at 2 layers and the reduced config), F2 (serving at full width and
    depth) and F3 (training at full width, 2 layers)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config

    gc.collect()
    torch.cuda.empty_cache()
    log({"path": "moe", "memory_allocated_at_start": torch.cuda.memory_allocated()})
    rows = [moe_attention_row(np.random.default_rng(SEED))]
    laps.lap("F attention at moonshot's shape")
    full = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_F1_LAYERS,
                               act_dtype="float32", param_dtype="float32")
    prompts = np.random.default_rng(SEED).integers(
        0, full.vocab_size, (MOE_F1_B, MOE_F1_T)).astype(np.int32)
    legs = [float64_leg(full, prompts, kernels, {
        "flash_attention_tf32": full.n_layers, "flash_attention": 0,
        "flash_attention_wgmma": 0}, "moe_float32", own_prefill=False)]
    small = get_config(MOE_ARCH).reduced()
    small_prompts = np.random.default_rng(SEED).integers(
        0, small.vocab_size, (LM_REDUCED_B, LM_REDUCED_T)).astype(np.int32)
    legs.append(float64_leg(small, small_prompts, kernels, {
        "flash_attention": small.n_layers, "flash_attention_tf32": 0,
        "flash_attention_wgmma": 0}, "moe_float32_reduced", own_prefill=True))
    laps.lap("F1 float32 against float64")
    legs.append(serve_leg(kernels))
    laps.lap("F2 moonshot serving")
    legs.append(moe_train_leg(kernels))
    laps.lap("F3 moonshot training")
    return dict(rows=rows, legs=legs)


# ---------------------------------------------------------------------------
# Path G: deepseek-v3-671b, MLA attention
# ---------------------------------------------------------------------------
MLA_ARCH = "deepseek_v3_671b"
#: the G rows (B, H, Hkv, T, D, Dv, dtype), causal: each forward route at
#: MLA's head-dim pairs (q and k of 128 + 64 columns, v of 128; the reduced
#: config's 8 + 8 and 8): G2's prefill (4 prompts of 1024 tokens, 128
#: heads) in bf16 (wgmma), one of its prompts in float32 (tf32), the reduced
#: config's prefill in both dtypes (mma).  Comparison launches, not the path's
MLA_ATTN_SHAPES = ((4, 128, 128, 1024, 192, 128, "bfloat16"),
                   (1, 128, 128, 1024, 192, 128, "float32"),
                   (LM_REDUCED_B, 4, 4, LM_REDUCED_T, 16, 8, "float32"),
                   (LM_REDUCED_B, 4, 4, LM_REDUCED_T, 16, 8, "bfloat16"))
#: G1 (a): the MLA module alone at full width (187 M parameters, 0.75 GB in
#: float32), 2 prompts of 512 tokens, then 2 absorbed decode steps
MLA_G1_B, MLA_G1_T = 2, 512
#: G1's limit, of the largest magnitude against float64: as F1's
#: (MOE_F32_RTOL); the module sums over up to 7,168 terms (the model width)
MLA_F32_RTOL = 1e-4
#: G2's depth: 1 of deepseek's 61 layers.  At one layer the tree is
#: 24,974,374,912 parameters (49.95 GB in bf16; the MTP head, which the
#: model always builds, is 11.6 B of them); two layers would be 73 GB of
#: parameters before any activation, past the card's 80 GB with the cache
#: and the MoE buffers
MLA_G2_LAYERS = 1


#: G's backward rows (B, H, Hkv, T, D, Dv, dtype, causal): G2's attention in
#: bf16 (the wgmma route), G1's in float32 (the tf32 route) and the reduced
#: config's pair in both dtypes (the SIMT route)
MLA_BWD_CASES = ((4, 128, 128, 1024, 192, 128, "bfloat16", True),
                 (1, 128, 128, 1024, 192, 128, "float32", True),
                 (2, 4, 4, 64, 16, 8, "float32", True),
                 (2, 4, 4, 64, 16, 8, "bfloat16", True))
#: G3: the full-width MLA module's gradient, in float32 at G1's 2 × 512
#: against float64, and in bf16 at 4 × 1024 (G2's prefill) for
#: MLA_G3_STEPS forward and backward steps
MLA_G3_B, MLA_G3_T, MLA_G3_STEPS = 4, 1024, 4
#: G4: the reduced deepseek (MLA (16, 8), MoE, MTP head), E2's float32 step
#: at 4 × 64 in 2 microbatches, then MLA_G4_STEPS bf16 ``run_training``
#: steps of 8 × 64
MLA_G4_B, MLA_G4_T, MLA_G4_MICRO = 4, 64, 2
MLA_G4_TRAIN_B, MLA_G4_STEPS = 8, 4
#: the weight of the MTP head's loss in ``lm_loss``: at init both cross
#: entropies are near ln(vocab), so a step-0 loss near (1 + it)·ln(vocab)
MTP_WEIGHT = 0.3


def mla_attention_rows(rng, rows: dict) -> list:
    """``flash_attention`` at MLA_ATTN_SHAPES against the plain version in
    float64 on the same inputs (``check_flash``'s gate, the equal-dim rows'
    own), into ``rows[kernel name]`` by the route ``variant`` takes: event
    ms in turns beside SDPA (``library_ms``; null with the reason when SDPA
    refuses v of another head dim), the route's device ms, SDPA's device
    ms, the plain version's ms and the bound: q, k, v read once and o
    written once, or the causal half's B·H·T²·(D + Dv) flops at the dtype's
    rate (float32 rows also ``tc_bound_ms``, three TF32 products).  Where
    ``lse_route`` holds (bf16 at (192, 128)) the forward that also writes L
    (``return_lse``, as ``FlashAttentionFn`` runs it) is timed in turns
    beside the one without (``lse_kernel_ms``, ``lse_device_ms``), its o
    bitwise to the other's and its L against the plain version's
    (``lse_max_abs_err``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    out = []
    for B, H, Hkv, T, D, Dv, dtype in MLA_ATTN_SHAPES:
        dt = getattr(torch, dtype)
        q = normal(rng, (B, H, T, D)).to(dt)
        k = normal(rng, (B, Hkv, T, D)).to(dt)
        v = normal(rng, (B, Hkv, T, Dv)).to(dt)
        kind = tflash.variant(dt, D, Dv)
        name = tflash.KERNELS[kind].name
        want = ref.flash_attention_ref(q.double(), k.double(), v.double())
        err, rel = check_flash(f"G {name} {(B, H, Hkv, T, D, Dv)} {dtype}",
                               tflash.flash_attention(q, k, v), want, dt)
        del want
        nbytes = q.element_size() * (B * H * T * (D + Dv) + B * Hkv * T * (D + Dv))
        flops = B * H * T * T * (D + Dv)
        bms, by = bound_ms(nbytes, flops,
                           BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
        extra = {}
        if dt == torch.float32:
            extra["tc_bound_ms"] = bound_ms(nbytes, 3 * flops, TF32_OPS_PER_S)[0]

        def kernel():
            tflash.flash_attention(q, k, v)

        def with_lse():
            tflash.flash_attention(q, k, v, return_lse=True)

        def library():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        fns = {"kernel": kernel}
        if tflash.lse_route(dt, D, Dv):
            o, lse = tflash.flash_attention(q, k, v, return_lse=True)
            if not torch.equal(o, tflash.flash_attention(q, k, v)):
                raise AssertionError(f"G {name} {(D, Dv)}: o differs with L asked for")
            want_lse = ref.flash_attention_lse_ref(q, k, v)
            extra["lse_max_abs_err"] = float((lse[..., :T] - want_lse).abs().max())
            if not extra["lse_max_abs_err"] <= 1e-6 * float(want_lse.abs().max()):
                raise AssertionError(f"G {name} {(D, Dv)}: L {extra['lse_max_abs_err']} "
                                     "from the plain version's")
            del o, lse, want_lse
            fns["with_lse"] = with_lse
        try:  # the yardstick only: the port never calls SDPA
            library()
            torch.cuda.synchronize()
            fns["library"] = library
        except RuntimeError as e:
            extra["library_refused"] = str(e)[:300]
        times = time_in_turns(fns)
        row = dict(shape=dict(B=B, H=H, Hkv=Hkv, T=T, D=D, Dv=Dv, dtype=dtype),
                   variant=kind, max_abs_err=err, rel_err=rel, kernel_ms=times["kernel"],
                   device_ms=kernel_device_ms(kernel, FLASH_KERNEL_NAMES[kind]),
                   plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=5),
                   library_ms=times.get("library"),
                   library_device_ms=all_device_ms(library) if "library" in fns else None,
                   bound_ms=bms, bound_by=by, **extra)
        if "with_lse" in fns:
            row.update(lse_kernel_ms=times["with_lse"],
                       lse_device_ms=kernel_device_ms(with_lse, FLASH_KERNEL_NAMES[kind]))
        rows[name].append(row)
        out.append(row)
        log({"kernel": name, "path": "G", **row})
        del q, k, v
    torch.cuda.empty_cache()
    return out


def mla_module_leg(kernels) -> dict:
    """G1 (a): deepseek's MLA module alone at full width in float32
    (weights ``init_from_spec`` of ``mla_specs`` from ``torch.Generator``
    seed 0 on the card, inputs N(0, 1)): ``mla_forward`` over MLA_G1_B
    prompts of MLA_G1_T tokens (the TF32 kernel at (192, 128), one launch),
    its latent cache placed in a cache of MLA_G1_T + 2 slots, then two
    absorbed ``mla_decode`` steps; against the same functions in float64
    (``plain_attention`` swapped in by name): each output within
    MLA_F32_RTOL of its largest magnitude."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as tattn
    from repro_torch.models.layers import init_from_spec
    from torch.utils import _pytree as pytree

    cfg = get_config(MLA_ARCH)
    B, T = MLA_G1_B, MLA_G1_T

    def run(p, x):
        positions = torch.arange(T, device=x.device)[None, :]
        y, (c_kv, k_rope) = tattn.mla_forward(cfg, p, x[:, :T], positions, return_kv=True)
        cache = tattn.mla_init_cache(cfg, B, T + 2, x.dtype, x.device)
        cache["c_kv"][:, :T] = c_kv
        cache["k_rope"][:, :T] = k_rope
        outs = [y]
        for i in range(2):
            y, cache = tattn.mla_decode(cfg, p, x[:, T + i], cache, T + i)
            outs.append(y)
        return outs

    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = init_from_spec(tattn.mla_specs(cfg), gen, torch.float32)
        x = torch.randn((B, T + 2, cfg.d_model), generator=gen, device="cuda")
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        torch.cuda.synchronize()
        reset(kernels)
        got = run(params, x)
        torch.cuda.synchronize()
        launches = read_launches("G1 MLA module", kernels, {
            "flash_attention_tf32": 1, "flash_attention": 0, "flash_attention_wgmma": 0})
        params64 = pytree.tree_map(lambda t: t.double(), params)
        del params
        with swapped(tattn, "flash_attention", plain_attention):
            wants = run(params64, x.double())
        errors = {name: rel_err(g, w) for name, g, w in
                  zip(("prefill", "decode_1", "decode_2"), got, wants)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        del params64, got, wants, x
    torch.cuda.empty_cache()
    out = dict(path="mla_module_float32", arch=cfg.name, n_params=n_params, batch=B,
               prompt_len=T, errors=errors, limit=MLA_F32_RTOL, launches=launches,
               finite=finite)
    log(out)
    check_within("G1 MLA module", errors, dict.fromkeys(errors, MLA_F32_RTOL))
    if not finite:
        raise AssertionError("G1 MLA module: an output is not finite")
    return out


def mla_grad_leg(kernels) -> dict:
    """G3: the gradient of deepseek's MLA module at full width (weights
    ``init_from_spec`` of ``mla_specs`` from ``torch.Generator`` seed 0 on
    the card, x N(0, 1)) through ``mla_forward``, of the loss Σ y ∘ W for a
    fixed random W.  Float32 at MLA_G1_B × MLA_G1_T: d(x) and every
    parameter's gradient against the same functions in float64
    (``plain_attention`` swapped in by name), each within
    TRAIN_E2_RTOL["grads"] of its largest magnitude; one tf32 forward and
    one tf32 backward call.  Bf16 at MLA_G3_B × MLA_G3_T: MLA_G3_STEPS
    forward and backward steps (each one wgmma forward and one wgmma
    backward call), ms a step (host wall ended by a synchronise; the median
    after the first), peak bytes, a profiled step's busy share and the
    backward kernels' device ms; two steps' gradients bitwise equal.  Then
    the same steps with ``lse_route`` swapped off by name, so the forward
    writes no L and the backward computes it (``step_ms_without_lse``)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import attention as tattn
    from repro_torch.models.layers import init_from_spec
    from torch.utils import _pytree as pytree

    cfg = get_config(MLA_ARCH)

    def grads(p, x, w):
        leaves, spec = pytree.tree_flatten(p)
        xs = [t.detach().requires_grad_() for t in [x, *leaves]]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        y = tattn.mla_forward(cfg, pytree.tree_unflatten(xs[1:], spec), xs[0], positions)
        return torch.autograd.grad((y * w).sum(), xs)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_from_spec(tattn.mla_specs(cfg), gen, torch.float32)
    names = ["x"] + [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(params)[0]]
    x = torch.randn((MLA_G1_B, MLA_G1_T, cfg.d_model), generator=gen, device="cuda")
    w = torch.randn(x.shape, generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset(kernels)
    got = grads(params, x, w)
    torch.cuda.synchronize()
    launches = read_launches("G3 MLA gradient, float32", kernels, {
        "flash_attention_tf32": 1, "flash_attention_bwd_tf32": 1, "flash_attention": 0,
        "flash_attention_wgmma": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_wgmma": 0})
    params64 = pytree.tree_map(lambda t: t.double(), params)
    with swapped(tattn, "flash_attention", plain_attention):
        wants = grads(params64, x.double(), w.double())
    errors = {n: rel_err(g, v) for n, g, v in zip(names, got, wants)}
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del params, params64, got, wants, x, w
    torch.cuda.empty_cache()
    check_within("G3 MLA gradient, float32", errors,
                 dict.fromkeys(errors, TRAIN_E2_RTOL["grads"]))
    if not finite:
        raise AssertionError("G3 MLA gradient: a gradient is not finite")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_from_spec(tattn.mla_specs(cfg), gen, torch.bfloat16)
    x = torch.randn((MLA_G3_B, MLA_G3_T, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    w = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    step_s, kept = [], []
    for i in range(MLA_G3_STEPS):
        t0 = time.perf_counter()
        g = grads(params, x, w)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i < 2:
            kept.append(g)
        del g
    launches16 = read_launches("G3 MLA gradient, bf16", kernels, {
        "flash_attention_wgmma": MLA_G3_STEPS, "flash_attention_bwd_wgmma": MLA_G3_STEPS,
        "flash_attention": 0, "flash_attention_tf32": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_tf32": 0})
    peak = torch.cuda.max_memory_allocated()
    bitwise = all(torch.equal(a, b) for a, b in zip(*kept))
    finite16 = all(bool(torch.isfinite(g).all()) for g in kept[0])
    del kept
    events, wall = device_events(lambda: grads(params, x, w), 1)
    profile = _busy(events, wall)
    backward = {}
    for e in events:
        if "flash_bwd" in e.name:
            backward[e.name[:90]] = backward.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
    profile.update(backward_kernels=backward, backward_ms=sum(backward.values()))
    no_lse_s = []
    with swapped(tflash, "lse_route", lambda *args: False):
        for _ in range(MLA_G3_STEPS):
            t0 = time.perf_counter()
            g = grads(params, x, w)
            torch.cuda.synchronize()
            no_lse_s.append(time.perf_counter() - t0)
            del g
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    del params, x, w, events
    torch.cuda.empty_cache()
    out = dict(path="mla_grad", arch=cfg.name, n_params=n_params,
               float32=dict(batch=MLA_G1_B, seq=MLA_G1_T, errors=errors,
                            limit=TRAIN_E2_RTOL["grads"], launches=launches),
               bf16=dict(batch=MLA_G3_B, seq=MLA_G3_T, steps=MLA_G3_STEPS,
                         step_ms=1e3 * statistics.median(step_s[1:]),
                         step_ms_each=[1e3 * t for t in step_s], max_memory_allocated=peak,
                         step_ms_without_lse=1e3 * statistics.median(no_lse_s[1:]),
                         repeat_bitwise=bitwise, finite=finite16, profile=profile,
                         launches=launches16),
               launches={n: launches[n] + launches16[n] for n in launches})
    log(out)
    if not finite16 or not bitwise:
        raise AssertionError(f"G3 MLA gradient, bf16: finite {finite16}, repeat bitwise "
                             f"{bitwise}")
    return out


def train_step_check(kernels, cfg, label: str, expected_per_step: dict,
                     batch_size: int = MLA_G4_B, seq: int = MLA_G4_T) -> dict:
    """E2's float32 check of a reduced config on the card:
    ``make_train_step`` at ``batch_size`` × ``seq`` (MLA_G4_B × MLA_G4_T; a VLM's
    ``seq`` counts its patches) from ``lm_data`` in
    MLA_G4_MICRO microbatches with float32 accumulators (a config's plan
    may accumulate in bf16, as its Adafactor memory plan does), with AdamW
    and with SGD at TRAIN_E2_SGD_LR (its update gives back the step's
    gradient), against the same port functions in float64 run microbatch
    by microbatch as the step runs them (``plain_attention`` swapped in by
    name; with an MoE, ``moe_route`` replaying the float32 SGD step's
    recorded routings with weights from the float64 router, as F1): the
    loss, ``grad_norm``, every gradient leaf and the AdamW step
    (``adamw_first_step64``) within TRAIN_E2_RTOL.  Each of the two steps
    must launch the kernels as ``expected_per_step`` says.  The AdamW step
    then runs again from the same state: its loss and every parameter
    bitwise equal."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import make_train_plan, make_train_step
    from repro_torch.models import moe, registry
    from repro_torch.optim import adamw, sgd
    from torch.utils import _pytree as pytree

    shape = ShapeSpec("check", seq, batch_size, "train")
    api = registry.build(cfg)
    params = api.init(seed=SEED, device="cuda")
    batch = lm_data._batch_for_step(cfg, shape, SEED, 0, "cuda")
    plan = dataclasses.replace(make_train_plan(cfg, shape, make_smoke_mesh()),
                               n_microbatches=MLA_G4_MICRO, accum_dtype=torch.float32)
    lr = 3e-4
    opt, descent = adamw(lr), sgd(TRAIN_E2_SGD_LR)
    routings = []
    route = moe.moe_route

    def recorded(cfg_, router, x):
        routings.append(route(cfg_, router, x))
        return routings[-1]

    def routed(fn):
        return swapped(moe, "moe_route", fn) if cfg.moe else contextlib.nullcontext()

    torch.cuda.synchronize()
    reset(kernels)
    adam_params, _, metrics = make_train_step(cfg, api, opt, plan)(
        params, opt.init(params), batch)
    with routed(recorded):
        sgd_params, _, sgd_metrics = make_train_step(cfg, api, descent, plan)(
            params, descent.init(params), batch)
    torch.cuda.synchronize()
    launches = read_launches(label, kernels,
                             {k: 2 * n for k, n in expected_per_step.items()})
    again, _, again_metrics = make_train_step(cfg, api, opt, plan)(
        params, opt.init(params), batch)
    repeat_bitwise = bool(
        torch.equal(again_metrics["loss"], metrics["loss"])
        and all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(again),
                                                  pytree.tree_leaves(adam_params))))
    del again
    if not repeat_bitwise:
        raise AssertionError(f"{label}: the repeated AdamW step differs")
    step_grads = pytree.tree_map(lambda p, q: (p.double() - q.double()) / TRAIN_E2_SGD_LR,
                                 params, sgd_params)
    cfg64 = dataclasses.replace(cfg, act_dtype="float64", param_dtype="float64")
    api64 = registry.build(cfg64)
    params64 = pytree.tree_map(lambda t: t.double(), params)
    replayed, flips = route_replay(routings, cfg) if cfg.moe else (None, [0])
    n_micro = plan.n_microbatches
    losses64, grads64 = [], None
    with routed(replayed):
        for i in range(n_micro):
            part = {key: v.reshape(n_micro, -1, *v.shape[1:])[i] for key, v in batch.items()}
            loss_i, g_i = oracle_loss_and_grads(api64, params64, part)
            losses64.append(float(loss_i))
            grads64 = g_i if grads64 is None else pytree.tree_map(torch.add, grads64, g_i)
    if routings:
        raise AssertionError(f"{label}: {len(routings)} routings not replayed")
    grads64 = pytree.tree_map(lambda g: g / n_micro, grads64)
    loss64 = sum(losses64) / n_micro
    norm64 = math.sqrt(sum(float(g.square().sum()) for g in pytree.tree_leaves(grads64)))
    errors = {"loss": abs(float(metrics["loss"]) - loss64) / abs(loss64),
              "grad_norm": abs(float(metrics["grad_norm"]) - norm64) / norm64,
              "grads": max(tree_errors(step_grads, grads64).values()),
              "params": max(tree_errors(adam_params, adamw_first_step64(
                  params, step_grads, lr)).values())}
    step = dict(arch=cfg.name, batch=batch_size, seq=seq, n_microbatches=n_micro,
                loss=float(metrics["loss"]), loss_oracle=loss64,
                grad_norm=float(metrics["grad_norm"]), grad_norm_oracle=norm64,
                steps_equal_grad_norm=float(sgd_metrics["grad_norm"])
                == float(metrics["grad_norm"]), errors=errors, limits=TRAIN_E2_RTOL,
                float64_router_other_choices=flips[0], launches=launches,
                repeat_bitwise=repeat_bitwise)
    del params, adam_params, sgd_params, step_grads, params64, grads64
    torch.cuda.empty_cache()
    check_within(label, errors, TRAIN_E2_RTOL)
    return step


def mla_train_leg(kernels) -> dict:
    """G4: the reduced deepseek (MLA (16, 8): the mma forward and the SIMT
    backward; MoE; the MTP head) trains on the card.  First E2's float32
    check (``train_step_check``).  Then
    MLA_G4_STEPS bf16 steps of ``run_training`` (MLA_G4_TRAIN_B ×
    MLA_G4_T, the config's Adafactor): every loss finite, step 0 within
    TRAIN_E3_LOSS0_SLACK of (1 + MTP_WEIGHT)·ln(vocab), one more step twice
    from the same state bitwise equal.  Flash launches a step: forward
    (2·layers + 1)·microbatches (remat ``full`` runs each layer twice, the
    MTP block once), backward (layers + 1)·microbatches."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import make_train_plan, make_train_step, run_training
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer
    from torch.utils import _pytree as pytree

    cfg = get_config(MLA_ARCH).reduced()
    step = train_step_check(kernels, cfg, "G4 train steps, float32", {
        "flash_attention": (2 * cfg.n_layers + 1) * MLA_G4_MICRO,
        "flash_attention_bwd": (cfg.n_layers + 1) * MLA_G4_MICRO,
        "flash_attention_tf32": 0, "flash_attention_wgmma": 0,
        "flash_attention_bwd_tf32": 0, "flash_attention_bwd_wgmma": 0})
    launches = step["launches"]

    cfg16 = dataclasses.replace(cfg, act_dtype="bfloat16", param_dtype="bfloat16")
    shape16 = ShapeSpec("g4", MLA_G4_T, MLA_G4_TRAIN_B, "train")
    plan16 = make_train_plan(cfg16, shape16, make_smoke_mesh())
    torch.cuda.synchronize()
    reset(kernels)
    params, history = run_training(cfg16, steps=MLA_G4_STEPS, batch_size=MLA_G4_TRAIN_B,
                                   seq_len=MLA_G4_T, seed=SEED, log_every=0, device="cuda")
    torch.cuda.synchronize()
    per_step = plan16.n_microbatches * MLA_G4_STEPS
    launches16 = read_launches("G4 bf16 training", kernels, {
        "flash_attention": (2 * cfg.n_layers + 1) * per_step,
        "flash_attention_bwd": (cfg.n_layers + 1) * per_step,
        "flash_attention_tf32": 0, "flash_attention_wgmma": 0,
        "flash_attention_bwd_tf32": 0, "flash_attention_bwd_wgmma": 0})
    losses = [h["loss"] for h in history]
    api16 = registry.build(cfg16)
    opt16 = make_optimizer(cfg16.optimizer, 3e-4)
    state = opt16.init(params)
    batch16 = lm_data._batch_for_step(cfg16, shape16, SEED, MLA_G4_STEPS, "cuda")
    step_fn = make_train_step(cfg16, api16, opt16, plan16)
    runs = [step_fn(params, state, batch16) for _ in range(2)]
    (p1, _, m1), (p2, _, m2) = runs
    bitwise = bool(torch.equal(m1["loss"], m2["loss"])) and all(
        torch.equal(a, b) for a, b in zip(pytree.tree_leaves(p1), pytree.tree_leaves(p2)))
    del params, state, runs, p1, p2
    torch.cuda.empty_cache()
    center = (1 + MTP_WEIGHT) * math.log(cfg.vocab_size)
    out = dict(path="mla_train", arch=cfg.name, float32_step=step,
               bf16=dict(steps=MLA_G4_STEPS, batch=MLA_G4_TRAIN_B, seq=MLA_G4_T,
                         n_microbatches=plan16.n_microbatches, losses=losses,
                         step_ms_each=[1e3 * h["time_s"] for h in history],
                         loss0_center=center, repeat_loss=float(m1["loss"]),
                         repeat_bitwise=bitwise, launches=launches16),
               launches={n: launches[n] + launches16[n] for n in launches})
    log(out)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"G4: a loss is not finite: {losses}")
    if abs(losses[0] - center) > TRAIN_E3_LOSS0_SLACK:
        raise AssertionError(f"G4: step 0 loss {losses[0]} is not within "
                             f"{TRAIN_E3_LOSS0_SLACK} of {center}")
    if not bitwise:
        raise AssertionError("G4: two steps from one state differ")
    return out


def mla_phase(kernels, rows: dict, laps: Laps) -> dict:
    """Path G, deepseek-v3-671b (MLA attention), after path F's memory is
    released: the forward routes at MLA's head-dim pairs (``rows``) and the
    backward routes (MLA_BWD_CASES), then with the counts reset before each
    leg G1 (float32 against float64: the MLA module at full width, and the
    reduced model as F1 runs moonshot's), G2 (serving at full width and
    MLA_G2_LAYERS layer through ``Server``, as F2), and after G2's memory is
    released G3 (the full-width module's gradient) and G4 (the reduced
    model trains)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config

    gc.collect()
    torch.cuda.empty_cache()
    log({"path": "mla", "memory_allocated_at_start": torch.cuda.memory_allocated()})
    attn_rows = mla_attention_rows(np.random.default_rng(SEED), rows)
    laps.lap("G attention at MLA's head-dim pairs")
    bwd_rows = flash_bwd_rows(np.random.default_rng(SEED), MLA_BWD_CASES, "G")
    laps.lap("G attention backward at MLA's head-dim pairs")
    legs = [mla_module_leg(kernels)]
    small = get_config(MLA_ARCH).reduced()
    small_prompts = np.random.default_rng(SEED).integers(
        0, small.vocab_size, (LM_REDUCED_B, LM_REDUCED_T)).astype(np.int32)
    legs.append(float64_leg(small, small_prompts, kernels, {
        "flash_attention": small.n_layers, "flash_attention_tf32": 0,
        "flash_attention_wgmma": 0}, "mla_float32_reduced", own_prefill=True))
    laps.lap("G1 float32 against float64")
    full = get_config(MLA_ARCH)
    legs.append(serve_leg(
        kernels, dataclasses.replace(full, n_layers=MLA_G2_LAYERS), path="mla_serve",
        label="G2 deepseek serving",
        extra=dict(reduced=f"n_layers {full.n_layers} -> {MLA_G2_LAYERS}: two layers "
                           "are 73 GB of bf16 parameters (the MTP head included) "
                           "before activations")))
    laps.lap("G2 deepseek serving")
    gc.collect()
    torch.cuda.empty_cache()
    log({"path": "mla_training", "memory_allocated_at_start": torch.cuda.memory_allocated()})
    legs.append(mla_grad_leg(kernels))
    laps.lap("G3 MLA module gradient")
    legs.append(mla_train_leg(kernels))
    laps.lap("G4 reduced deepseek training")
    return dict(rows=attn_rows, bwd_rows=bwd_rows, legs=legs)


# ---------------------------------------------------------------------------
# Paths H and J: the SSM and hybrid models (xlstm-1.3b, jamba-v0.1-52b)
# ---------------------------------------------------------------------------
SSM_ARCH, HYBRID_ARCH = "xlstm_1_3b", "jamba_v0_1_52b"
#: H1: xlstm at full width and depth in float32 (2.63 B parameters), 2
#: prompts of 256 tokens and 2 decode steps against float64 (the limit is
#: MOE_F32_RTOL, 1e-4 of the largest magnitude: F1's and G1's)
SSM_H1_B, SSM_H1_T = 2, 256
#: J1: jamba's Mamba block (sub0: the dense MLP) and its attention block
#: (sub3: the MoE MLP) at full width in float32, 1 prompt of 512 tokens and
#: 2 decode steps, against float64 within MOE_F32_RTOL
HYBRID_J1_T = 512
#: J1's reduced jamba: 2 prompts of 24 tokens into a cache of 64 (its
#: attention layers: min(64, 32) = 32 slots), 12 decode steps at positions
#: 24…35, so the ring buffer wraps at 32
HYBRID_J1_REDUCED_T, HYBRID_J1_REDUCED_DECODE, HYBRID_J1_REDUCED_CACHE = 24, 12, 64
#: J2: jamba at full width in bf16 at 2 of its 4 periods (16 of 32 layers,
#: 2 of them attention): 25.8 B parameters, 51.6 GB; three periods would be
#: 77.4 GB of parameters before activations on the 80 GB card
HYBRID_J2_PERIODS = 2
#: H2's prompt: 512 tokens (4 prompts, 32 new), cut from F2's 1024 because
#: the sLSTM's loop over time made the leg 98 s at 1024 (4.9 s a prefill,
#: three prefills and a profiled one; NVIDIA H100 80GB HBM3, 700 W)
SSM_H2_T = 512
#: the ranges of ``mixer_profile``: (part, module, function swapped in by name)
MIXERS = (("mamba", "ssm", "mamba_forward"), ("mlstm", "ssm", "mlstm_forward"),
          ("slstm", "ssm", "slstm_forward"), ("attention", "attention", "gqa_forward"),
          ("moe", "moe", "moe_apply"))


def mixer_profile(fn, mixers=MIXERS) -> dict:
    """One call of ``fn`` under the profiler (a window opened and closed by
    the marker kernel), with each function of ``mixers`` (MIXERS, or K2's
    encoder and decoder stacks, ENCDEC_PARTS) swapped by name for a
    version inside a ``record_function`` range: the call's device busy
    against wall, device events and heaviest kernels (``_busy``'s keys),
    and ``mixer_ms``, each kernel's device ms by the range whose span
    on the device holds its start (one stream: a range's kernels run
    inside its span and no other kernel does; ``other``: with MIXERS the
    embedding, norms, dense MLPs and logits).  It reads the profiler's raw events,
    without building its event tree: the sLSTM's loop over time launches
    half a million kernels in one xlstm prefill."""
    import bisect
    import contextlib
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def g(*args, **kw):
            with record_function(name):
                return f(*args, **kw)
        return g

    ranges = {f"mixer:{part}": part for part, _, _ in mixers}
    with contextlib.ExitStack() as stack:
        for part, module, name in mixers:
            mod = importlib.import_module(f"repro_torch.models.{module}")
            stack.enter_context(swapped(mod, name, ranged(f"mixer:{part}", getattr(mod, name))))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
    spans, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name in ranges:
            spans.append((e.start_ns(), e.end_ns(), ranges[name]))
        elif not e.is_user_annotation() and MARKER not in name:
            kernels.append((e.start_ns(), e.duration_ns(), name))
    spans.sort()
    starts = [a for a, _, _ in spans]
    parts = dict.fromkeys([*ranges.values(), "other"], 0.0)
    for start, dur, _ in kernels:
        i = bisect.bisect_right(starts, start) - 1
        parts[spans[i][2] if i >= 0 and start <= spans[i][1] else "other"] += dur / 1e6
    return dict(_busy_of([(name, dur / 1e6) for _, dur, name in kernels], wall),
                mixer_ms=parts)


def hybrid_block_leg(kernels) -> dict:
    """J1 (a): jamba's Mamba block (sub0: ln1, the mixer at d_inner 8192 and
    d_state 16, ln2, the dense SwiGLU) and its attention block (sub3: 32
    heads over 8 KV heads at head dim 128, the MoE MLP of 16 experts top-2)
    at full width in float32 (weights ``init_from_spec`` of ``block_specs``
    from ``torch.Generator`` seed 0 on the card, x N(0, 1)):
    ``apply_block`` over 1 prompt of HYBRID_J1_T tokens (the attention
    block: one ``flash_attention_tf32`` launch), then 2 ``decode_block``
    steps from the block's state (the attention block from a cache of
    ``block_init_cache``, its hybrid ring buffer); against the same
    functions in float64 (``plain_attention``, ``plain_decode_attention``,
    ``moe_route`` replaying the float32 run's routings): each output and
    the Mamba block's final state within MOE_F32_RTOL of its largest
    magnitude."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as tattn
    from repro_torch.models import blocks, moe
    from repro_torch.models.layers import init_from_spec
    from torch.utils import _pytree as pytree

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), act_dtype="float32",
                              param_dtype="float32")
    T = HYBRID_J1_T
    route = moe.moe_route
    out = {}
    for kind, idx in (("mamba", 0), ("attn", 3)):
        def run(p, x):
            positions = torch.arange(T, device=x.device)[None, :]
            y, st = blocks.apply_block(cfg, kind, p, x[:, :T], positions, return_kv=True)
            window = None
            if kind == "attn":
                cache = blocks.block_init_cache(cfg, kind, 1, T + 2, x.dtype, x.device)
                for c in ("k", "v"):
                    cache[c][:, :, :T] = st[c]
                window = cfg.sliding_window
            else:
                cache = st
            outs = {"prefill": y}
            for i in range(2):
                y, cache = blocks.decode_block(cfg, kind, p, x[:, T + i], T + i,
                                               window=window, state=cache)
                outs[f"decode_{i + 1}"] = y
            if kind == "mamba":
                outs.update({f"state_{c}": t for c, t in cache.items()})
            return outs

        routings: list = []

        def recorded(cfg_, router, x):
            routings.append(route(cfg_, router, x))
            return routings[-1]

        with torch.inference_mode():
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            params = init_from_spec(blocks.block_specs(cfg, kind, idx), gen, torch.float32)
            x = torch.randn((1, T + 2, cfg.d_model), generator=gen, device="cuda")
            n_params = sum(t.numel() for t in pytree.tree_leaves(params))
            torch.cuda.synchronize()
            reset(kernels)
            with swapped(moe, "moe_route", recorded):
                got = run(params, x)
            torch.cuda.synchronize()
            launches = read_launches(f"J1 jamba {kind} block", kernels, {
                "flash_attention_tf32": int(kind == "attn"), "flash_attention": 0,
                "flash_attention_wgmma": 0})
            params64 = pytree.tree_map(lambda t: t.double(), params)
            del params
            replayed, flips = route_replay(routings, cfg)
            with swapped(tattn, "flash_attention", plain_attention), \
                    swapped(tattn, "decode_attention", plain_decode_attention), \
                    swapped(moe, "moe_route", replayed):
                wants = run(params64, x.double())
            if routings:
                raise AssertionError(f"J1 {kind} block: {len(routings)} routings not replayed")
            errors = {n: rel_err(got[n], wants[n]) for n in got}
            finite = all(bool(torch.isfinite(t).all()) for t in got.values())
            del params64, got, wants, x
        torch.cuda.empty_cache()
        out[kind] = dict(sub=f"sub{idx}", n_params=n_params, errors=errors,
                         launches=launches, finite=finite,
                         float64_router_other_choices=flips[0])
        check_within(f"J1 jamba {kind} block", errors, dict.fromkeys(errors, MOE_F32_RTOL))
        if not finite:
            raise AssertionError(f"J1 jamba {kind} block: an output is not finite")
    res = dict(path="hybrid_blocks_float32", arch=cfg.name, batch=1, prompt_len=T,
               limit=MOE_F32_RTOL, blocks=out,
               launches={n: sum(b["launches"][n] for b in out.values())
                         for n in out["attn"]["launches"]})
    log(res)
    return res


def ssm_phase(kernels, laps: Laps) -> dict:
    """Paths H (xlstm-1.3b: mLSTM and sLSTM blocks, no attention, so no
    hand kernel) and J (jamba-v0.1-52b: Mamba blocks, a GQA layer a period
    whose decode cache is a ring buffer, the MoE MLP; the flash kernels at
    head dim 128 and, reduced, 16), after path G's memory is released, with
    the counts reset before each leg: H1 (float32 against float64 at full
    width and depth), H2 (serving at full width and depth, bf16), J1 (the
    Mamba and attention blocks at full width, and the reduced model across
    its ring buffer's wrap, float32 against float64), J2 (serving at full
    width and HYBRID_J2_PERIODS of 4 periods, bf16), then the reduced
    configs' float32 train steps against float64 (``train_step_check``)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import registry

    gc.collect()
    torch.cuda.empty_cache()
    log({"path": "ssm", "memory_allocated_at_start": torch.cuda.memory_allocated()})
    no_flash = {"flash_attention": 0, "flash_attention_tf32": 0, "flash_attention_wgmma": 0}
    xlstm = get_config(SSM_ARCH)
    full32 = dataclasses.replace(xlstm, act_dtype="float32", param_dtype="float32")
    prompts = np.random.default_rng(SEED).integers(
        0, xlstm.vocab_size, (SSM_H1_B, SSM_H1_T)).astype(np.int32)
    legs = [float64_leg(full32, prompts, kernels, no_flash, "ssm_float32", own_prefill=False)]
    laps.lap("H1 xlstm float32 against float64")
    legs.append(serve_leg(kernels, xlstm, path="ssm_serve", label="H2 xlstm serving",
                          mixers=MIXERS, prompt_len=SSM_H2_T,
                          extra=dict(reduced=f"prompt {MOE_F2_T} -> {SSM_H2_T} tokens: the "
                                             "sLSTM's loop over time, 4.9 s a prefill at "
                                             "1024, made the leg 98 s")))
    laps.lap("H2 xlstm serving")
    legs.append(hybrid_block_leg(kernels))
    small = get_config(HYBRID_ARCH).reduced()
    small_prompts = np.random.default_rng(SEED).integers(
        0, small.vocab_size, (LM_REDUCED_B, HYBRID_J1_REDUCED_T)).astype(np.int32)
    legs.append(float64_leg(small, small_prompts, kernels,
                            {**no_flash, "flash_attention": attention_layers(small)},
                            "hybrid_float32_reduced", own_prefill=False,
                            n_decode=HYBRID_J1_REDUCED_DECODE,
                            cache_len=HYBRID_J1_REDUCED_CACHE))
    laps.lap("J1 jamba float32 against float64")
    jamba = get_config(HYBRID_ARCH)
    cut = dataclasses.replace(
        jamba, n_layers=HYBRID_J2_PERIODS * len(jamba.layer_pattern))
    legs.append(serve_leg(
        kernels, cut, path="hybrid_serve", label="J2 jamba serving", mixers=MIXERS,
        extra=dict(n_params_full=registry.build(jamba).n_params(),
                   reduced=f"n_layers {jamba.n_layers} -> {cut.n_layers} "
                           f"({HYBRID_J2_PERIODS} of {jamba.n_periods} periods): three "
                           "periods are 77.4 GB of bf16 parameters before activations")))
    laps.lap("J2 jamba serving")
    gc.collect()
    torch.cuda.empty_cache()
    for arch, label in ((SSM_ARCH, "H3 xlstm train step, float32"),
                        (HYBRID_ARCH, "J3 jamba train step, float32")):
        cfg = get_config(arch).reduced()
        n = attention_layers(cfg) * MLA_G4_MICRO
        step = train_step_check(kernels, cfg, label, {
            "flash_attention": 2 * n, "flash_attention_bwd": n,
            "flash_attention_tf32": 0, "flash_attention_wgmma": 0,
            "flash_attention_bwd_tf32": 0, "flash_attention_bwd_wgmma": 0})
        log({"path": "ssm_train_step", "label": label, **step})
        legs.append(step)
    laps.lap("H3, J3 reduced train steps")
    return dict(legs=legs)


# ---------------------------------------------------------------------------
# Path K: seamless-m4t-large-v2, the encoder-decoder
# ---------------------------------------------------------------------------
#: path K's model, seamless-m4t-large-v2: 24 encoder and 24 decoder layers,
#: d 1024, 16 heads over 16 KV heads at head dim 64, d_ff 8192, vocab
#: 256,206, 1024 stub audio frames a sequence
ENCDEC_ARCH = "seamless_m4t_large_v2"
#: K1: float32 at full width and depth (2.04 B parameters, 8.15 GB), 2
#: prompts of 256 tokens over 1024 frames and 2 decode steps, against
#: float64 within MOE_F32_RTOL (H1's and J1's limit), the cache leaves too
ENCDEC_K1_B, ENCDEC_K1_T = 2, 256
#: K2: bf16 through ``Server``, 4 prompts of 128 tokens over 1024 frames,
#: 64 new tokens into a cache of 192
ENCDEC_K2_B, ENCDEC_K2_T, ENCDEC_K2_NEW = 4, 128, 64
#: K3: the reduced config's prefill of 24 tokens over its 16 frames (the
#: cross shape Tq 24 against Tk 16) and 3 decode steps against float64
ENCDEC_K3_T, ENCDEC_K3_DECODE = 24, 3
#: the ranges of K2's profiled prefill (``mixer_profile``): the encoder
#: stack and the decoder stack
ENCDEC_PARTS = (("encoder", "encdec", "encode"), ("decoder", "encdec", "decode_stack"))
#: E1's cross-attention shape, non-causal: K2's decoder, 4 prompts of 128
#: tokens (16 heads of 64) against 1024 encoder frames, (B, H, Hkv, T, Tk, D)
CROSS_SHAPE = (4, 16, 16, 128, 1024, 64)
#: E1's forward rows at path K's three attention shapes, (part, (B, H, Hkv,
#: T, Tk, D), causal): K2's encoder (4 × 1024 frames, non-causal), its
#: decoder's self-attention (4 × 128 tokens, causal) and CROSS_SHAPE
ENCDEC_FWD_CASES = (("encoder", (4, 16, 16, 1024, 1024, 64), False),
                    ("decoder self", (4, 16, 16, 128, 128, 64), True),
                    ("cross", CROSS_SHAPE, False))
#: ``flash_bwd_rows`` cases at CROSS_SHAPE (T given as the pair (T, Tk))
CROSS_BWD_CASES = tuple((*CROSS_SHAPE[:3], CROSS_SHAPE[3:5], CROSS_SHAPE[5], dtype, False)
                        for dtype in ("bfloat16", "float32"))


def stub_frames(cfg, batch: int) -> np.ndarray:
    """Frame embeddings [batch, n_frontend_tokens, d_model], float32
    standard normal from seed SEED + 1: the stub audio front-end's output."""
    return np.random.default_rng(SEED + 1).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)


def cross_attention_rows(rng) -> dict:
    """E1 at path K's attention shapes (ENCDEC_FWD_CASES: the encoder's and
    the cross-attention's non-causal calls, the latter T ≠ Tk, and the
    decoder's causal self-attention) in bf16 (the wgmma routes) and float32
    (the tf32 routes).  Forward, as autograd runs it (writing L): o against
    the plain version in float64 (``check_flash``'s gate), L within 1e-6 of
    the plain version's largest magnitude, o bitwise the call without L;
    events ms in turns beside SDPA's forward of the same causality, device
    ms, the plain version's ms and the bound (q, k, v read and o written
    once; QKᵀ and PV over every pair, the causal half where causal, at the
    dtype's rate, float32 rows also ``tc_bound_ms``, three TF32 products).
    Backward: ``flash_bwd_rows`` at CROSS_BWD_CASES (given L and without).
    Comparison launches, not the path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    forward = []
    for part, (B, H, Hkv, T, Tk, D), causal in ENCDEC_FWD_CASES:
        for dt in (torch.bfloat16, torch.float32):
            q = normal(rng, (B, H, T, D)).to(dt)
            k, v = (normal(rng, (B, Hkv, Tk, D)).to(dt) for _ in range(2))
            kind = tflash.variant(dt, D)
            label = f"E1 {part} {tflash.KERNELS[kind].name} {(B, H, Hkv, T, Tk, D)} {dt}"
            o, lse = tflash.flash_attention(q, k, v, causal, return_lse=True)
            want = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
            err, rel = check_flash(label, o, want, dt)
            if not torch.equal(o, tflash.flash_attention(q, k, v, causal)):
                raise AssertionError(f"{label}: o differs with L asked for")
            want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
            lse_err = float((lse[..., :T] - want_lse).abs().max())
            if not lse_err <= 1e-6 * float(want_lse.abs().max()):
                raise AssertionError(f"{label}: L {lse_err} from the plain version's")
            del o, lse, want, want_lse

            def kernel():
                tflash.flash_attention(q, k, v, causal, return_lse=True)

            def library():
                F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

            times = time_in_turns({"kernel": kernel, "library": library})
            nbytes = q.element_size() * (2 * B * H * T * D + 2 * B * Hkv * Tk * D)
            flops = 4 * B * H * (T * (T + 1) // 2 if causal else T * Tk) * D
            bms, by = bound_ms(nbytes, flops,
                               BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
            extra = ({"tc_bound_ms": bound_ms(nbytes, 3 * flops, TF32_OPS_PER_S)[0]}
                     if dt == torch.float32 else {})
            row = dict(part=part,
                       shape=dict(B=B, H=H, Hkv=Hkv, T=T, Tk=Tk, D=D,
                                  dtype=str(dt).split(".")[1]),
                       causal=causal, variant=kind, with_lse=True, max_abs_err=err,
                       rel_err=rel, lse_max_abs_err=lse_err, kernel_ms=times["kernel"],
                       device_ms=kernel_device_ms(kernel, FLASH_KERNEL_NAMES[kind]),
                       plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                                        causal=causal),
                                        reps=5, warmup=1),
                       library_ms=times["library"],
                       library_device_ms=all_device_ms(library), bound_ms=bms, bound_by=by,
                       **extra)
            forward.append(row)
            log({"kernel": tflash.KERNELS[kind].name, "path": f"E1 {part}", **row})
            del q, k, v
    backward = flash_bwd_rows(rng, CROSS_BWD_CASES, "E1 cross")
    return dict(forward=forward, backward=backward)


def encdec_phase(kernels, laps: Laps) -> dict:
    """Path K, seamless-m4t-large-v2 (``models/encdec.py``: a bidirectional
    encoder over the stub frames, a causal decoder with cross-attention over
    them), after path J's memory is released, with the counts reset before
    each leg: K1 (float32 at full width and depth against float64, logits
    and every cache leaf; the TF32 forward once an attention layer a
    prefill: 24 encoder, 24 decoder self-, 24 cross-attention layers), K2
    (serving at full width and depth, bf16, the wgmma forward the same 72
    times a prefill; prefill device ms by stack, decode ms a step, two runs'
    tokens equal), K3 (the reduced config: an AdamW step against float64,
    repeated bitwise, the mma forward and the SIMT backward, then a prefill
    and decode steps against float64)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config

    gc.collect()
    torch.cuda.empty_cache()
    log({"path": "encdec", "memory_allocated_at_start": torch.cuda.memory_allocated()})
    none = {"flash_attention": 0, "flash_attention_tf32": 0, "flash_attention_wgmma": 0}
    cfg = get_config(ENCDEC_ARCH)
    full32 = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (ENCDEC_K1_B, ENCDEC_K1_T)).astype(np.int32)
    legs = [float64_leg(full32, prompts, kernels,
                        {**none, "flash_attention_tf32": attention_layers(cfg)},
                        "encdec_float32", own_prefill=False,
                        inputs={"frames": stub_frames(cfg, ENCDEC_K1_B)})]
    laps.lap("K1 seamless float32 against float64")
    legs.append(serve_leg(kernels, cfg, path="encdec_serve", label="K2 seamless serving",
                          mixers=ENCDEC_PARTS, prompt_len=ENCDEC_K2_T, batch=ENCDEC_K2_B,
                          new=ENCDEC_K2_NEW, inputs={"frames": stub_frames(cfg, ENCDEC_K2_B)},
                          repeat=True))
    laps.lap("K2 seamless serving")
    gc.collect()
    torch.cuda.empty_cache()
    small = cfg.reduced()
    n = attention_layers(small) * MLA_G4_MICRO
    step = train_step_check(kernels, small, "K3 seamless train step, float32",
                            {**none, "flash_attention": 2 * n, "flash_attention_bwd": n,
                             "flash_attention_bwd_tf32": 0, "flash_attention_bwd_wgmma": 0})
    log({"path": "encdec_train_step", **step})
    legs.append(step)
    small_prompts = np.random.default_rng(SEED).integers(
        0, small.vocab_size, (LM_REDUCED_B, ENCDEC_K3_T)).astype(np.int32)
    legs.append(float64_leg(small, small_prompts, kernels,
                            {**none, "flash_attention": attention_layers(small)},
                            "encdec_float32_reduced", own_prefill=True,
                            n_decode=ENCDEC_K3_DECODE,
                            inputs={"frames": stub_frames(small, LM_REDUCED_B)}))
    laps.lap("K3 reduced seamless train step and decode")
    return dict(legs=legs)


# ---------------------------------------------------------------------------
# Path L: paligemma-3b, the VLM (a prefix of stub patch embeddings)
# ---------------------------------------------------------------------------
VLM_ARCH = "paligemma_3b"
#: L1: float32 at full width and depth (2.51 B parameters, 10.05 GB; the
#: float64 oracle 20.1 GB), 2 × (256 patches + 64 text tokens), prefill and
#: 2 decode steps against float64 within MOE_F32_RTOL, the cache leaves too
VLM_L1_B, VLM_L1_T = 2, 64
#: L2: bf16 through ``Server``, 4 × (256 patches + 128 tokens), 32 new
#: tokens into a cache of 416
VLM_L2_B, VLM_L2_T, VLM_L2_NEW = 4, 128, 32
#: L3: the reduced config's prefill of 16 patches + 24 tokens and 3 decode
#: steps against float64
VLM_L3_T, VLM_L3_DECODE = 24, 3
#: the ranges of L2's profiled prefill (``mixer_profile``): the patches'
#: projection, the attention layers and the dense MLPs (``other``: the
#: embedding, norms and logits)
VLM_PARTS = (("vision", "lm", "_with_prefix"), ("attention", "attention", "gqa_forward"),
             ("mlp", "blocks", "apply_mlp_part"))
#: E1's prefix-LM forward rows: (B, H, Hkv, T, D, P), each in bf16 and
#: float32: L2's attention shape, a long one past the host's share, the mask
#: at D 64 (E3's shape) and on the mma route at the reduced paligemma's
#: head dim
VLM_FWD_CASES = ((4, 8, 1, 384, 256, 256), (1, 8, 1, 2048, 256, 256),
                 (4, 32, 8, 1024, 64, 256), (2, 4, 1, 80, 16, 16))
#: E1's SIMT backward with the prefix at L3's step shape (a microbatch of
#: 2 × (16 patches + 48 tokens)), (B, H, Hkv, T, D, P)
VLM_BWD_CASE = (2, 4, 1, 64, 16, 16)
#: E1's tensor-core backwards with the prefix, each in bf16 and float32:
#: L2's attention shape at (256, 256) (L4's bf16 microbatch) and the mask at
#: D 64 (E3's shape, row 9n's), (B, H, Hkv, T, D, P)
VLM_TC_BWD_CASES = ((4, 8, 1, 384, 256, 256), (4, 32, 8, 1024, 64, 256))
#: L4(a): full width at 2 layers in float32, L1's batch 2 × (256 patches +
#: 64 tokens) in 2 microbatches, against float64 (``train_step_check``)
VLM_L4A_LAYERS, VLM_L4A_B, VLM_L4A_T = 2, VLM_L1_B, VLM_L1_T
#: L4(b): full width, bf16, AdamW as configured, remat ``full``, through
#: ``run_training``: L2's batch 4 × (256 patches + 128 tokens), steps timed
#: after the first, then one profiled step and a step repeated bitwise
VLM_L4B_B, VLM_L4B_T, VLM_L4B_STEPS = VLM_L2_B, VLM_L2_T, 4
#: bytes a parameter of a bf16 AdamW step holds at its peak, from E3's peak
#: on an H100 (llama3.2-1b: 41,168,235,008 B over 1,236,338,688 parameters,
#: PERF.md): L4(b)'s depth reckoning
E3_PEAK_BYTES_PER_PARAM = 41_168_235_008 / 1_236_338_688
#: L4(b)'s step 0 loss (bf16, the kernels) against the same initial
#: parameters and batch in float32 through ``plain_attention``, relative: a
#: loss is a mean over the text positions of a forward rounded to bf16 at
#: every layer (2⁻⁸ a rounding)
VLM_L4B_LOSS0_RTOL = 1e-2


def stub_patches(cfg, batch: int) -> np.ndarray:
    """Patch embeddings [batch, n_frontend_tokens, d_model], float32
    standard normal from seed SEED + 2: the stub vision front-end's
    output."""
    return np.random.default_rng(SEED + 2).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)


def prefix_pairs(T: int, P: int) -> int:
    """The (query, key) pairs a head's prefix-LM mask keeps: row r sees
    max(r, P − 1) + 1 keys."""
    return sum(max(r, P - 1) + 1 for r in range(T))


def ptxas_instance(kernel, marker: str) -> dict:
    """Registers and spill bytes of the instance of ``kernel``'s library
    whose mangled name holds ``marker``, from the build's ``-Xptxas -v``
    log (empty where the log is missing)."""
    import re

    text = kernel.library_path().with_suffix(".log")
    if not text.exists():
        return {}
    out, lines = {}, text.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and marker in line:
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if m:
                    out.update(spill_store_bytes=int(m[1]), spill_load_bytes=int(m[2]))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m[1])
                    break
            break
    return out


def vlm_attention_rows(rng) -> dict:
    """E1 at path L's attention: the forward with the prefix-LM mask at
    VLM_FWD_CASES in bf16 and float32 (the route ``variant`` names: wgmma
    and tf32 at D 256 and 64, mma at D 16, the SIMT kernel by name beside
    the mma one) against the plain version in float64 (``check_flash``'s
    gate), two calls bitwise, L (bf16 at the wgmma pairs) within 1e-6 of
    the plain version's largest magnitude and o bitwise the call without;
    events ms in turns beside SDPA with the mask as an explicit boolean
    ``attn_mask`` (the yardstick; the port never calls it), device ms, the
    plain version's ms and the bound (q, k, v read and o written once; QKᵀ
    and PV over the pairs the mask keeps, ``prefix_pairs``, at the dtype's
    rate; float32 rows also ``tc_bound_ms``, three TF32 products), the
    instance's registers and spill bytes from ptxas, and on the wgmma route
    the launch's grid and block count and the launches that the profiler's
    trace lists of 20 calls (``trace_kernels``).  Then the SIMT
    backward with the prefix at VLM_BWD_CASE in both dtypes against
    ``ref.flash_attention_bwd_ref`` in float64 within BWD_RTOL, two calls
    bitwise, beside SDPA's backward with the mask.  Comparison launches,
    not the path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    exp_rate = EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count \
        * sm_clock_hz()
    forward = []
    for B, H, Hkv, T, D, P in VLM_FWD_CASES:
        mask = ref.attention_mask(T, T, True, P, "cuda")
        pairs = B * H * prefix_pairs(T, P)
        for dt in (torch.bfloat16, torch.float32):
            q = normal(rng, (B, H, T, D)).to(dt)
            k, v = (normal(rng, (B, Hkv, T, D)).to(dt) for _ in range(2))
            kind = tflash.variant(dt, D)
            name = tflash.KERNELS[kind].name
            label = f"E1 prefix {name} {(B, H, Hkv, T, D)} P {P} {dt}"
            got = tflash.flash_attention(q, k, v, prefix_len=P)
            want = ref.flash_attention_ref(q.double(), k.double(), v.double(), prefix_len=P)
            err, rel = check_flash(label, got, want, dt)
            if not torch.equal(got, tflash.flash_attention(q, k, v, prefix_len=P)):
                raise AssertionError(f"{label}: two calls differ")
            extra = {}
            if D in tflash.HEAD_DIMS:
                extra["simt_max_abs_err"] = check_flash(
                    f"{label} simt", tflash.launch("simt", q, k, v, prefix_len=P), want, dt)[0]
            if tflash.lse_route(dt, D):
                o, lse = tflash.flash_attention(q, k, v, return_lse=True, prefix_len=P)
                if not torch.equal(o, got):
                    raise AssertionError(f"{label}: o differs with L asked for")
                want_lse = ref.flash_attention_lse_ref(q, k, v, prefix_len=P)
                extra["lse_max_abs_err"] = float((lse[..., :T] - want_lse).abs().max())
                if not extra["lse_max_abs_err"] <= 1e-6 * float(want_lse.abs().max()):
                    raise AssertionError(f"{label}: L {extra['lse_max_abs_err']}")
                del o, lse, want_lse
            del got, want

            def kernel():
                tflash.flash_attention(q, k, v, prefix_len=P)

            def library():
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

            def simt():
                tflash.launch("simt", q, k, v, prefix_len=P)

            fns = {"kernel": kernel, "library": library}
            try:  # the yardstick only: the port never calls SDPA
                library()
                torch.cuda.synchronize()
            except RuntimeError as e:
                del fns["library"]
                extra["library_refused"] = str(e)[:300]
            if D in tflash.HEAD_DIMS:
                fns["simt"] = simt
            times = time_in_turns(fns)
            nbytes = q.element_size() * (2 * B * H * T * D + 2 * B * Hkv * T * D)
            flops = 4 * pairs * D
            bms, by = bound_ms(nbytes, flops,
                               BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
            if dt == torch.float32:
                extra["tc_bound_ms"] = bound_ms(nbytes, 3 * flops, TF32_OPS_PER_S)[0]
            if "simt" in times:
                extra.update(simt_ms=times["simt"],
                             simt_device_ms=kernel_device_ms(simt, FLASH_KERNEL_NAMES["simt"]))
            if kind == "wgmma":  # each launch's grid, as the profiler's trace records it
                records = trace_kernels(kernel, FLASH_KERNEL_NAMES[kind])
                grids = sorted({tuple(r.get("args", {}).get("grid", ())) for r in records})
                one = len(grids) == 1 and len(grids[0]) == 3
                extra.update(grid=list(grids[0]) if one else [list(g) for g in grids],
                             blocks=math.prod(grids[0]) if one else None,
                             trace_launches=len(records))
            marker = {"wgmma": f"ILi{D}ELi{D}ELb0E", "tf32": f"ILi{D}ELi{D}ELb0E",
                      "mma": f"I{'f' if dt == torch.float32 else '13__nv_bfloat16'}"
                             f"Li{D}ELi{D}E"}[kind]
            row = dict(shape=dict(B=B, H=H, Hkv=Hkv, T=T, D=D, dtype=str(dt).split(".")[1]),
                       prefix_len=P, pairs_per_head=prefix_pairs(T, P), variant=kind,
                       max_abs_err=err, rel_err=rel, kernel_ms=times["kernel"],
                       device_ms=kernel_device_ms(kernel, FLASH_KERNEL_NAMES[kind]),
                       plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, prefix_len=P),
                                        reps=5, warmup=1),
                       library_ms=times.get("library"),
                       library_device_ms=all_device_ms(library) if "library" in times else None,
                       bound_ms=bms, bound_by=by,
                       ptxas=ptxas_instance(tflash.KERNELS[kind],
                                            "flash_attention_mma_kernel" + marker
                                            if kind == "mma" else
                                            f"flash_attention_{kind}_kernel" + marker),
                       **extra)
            forward.append(row)
            log({"kernel": name, "path": "E1 prefix", **row})
            del q, k, v
        del mask
    backward = []
    B, H, Hkv, T, D, P = VLM_BWD_CASE
    mask = ref.attention_mask(T, T, True, P, "cuda")
    pairs = B * H * prefix_pairs(T, P)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, do = (normal(rng, s).to(dt) for s in ((B, H, T, D), (B, Hkv, T, D),
                                                       (B, Hkv, T, D), (B, H, T, D)))
        o = tflash.flash_attention(q, k, v, prefix_len=P)
        label = f"E1 prefix flash_attention_bwd {(B, H, Hkv, T, D)} P {P} {dtype}"
        got = tflash.flash_attention_bwd(q, k, v, o, do, prefix_len=P)
        again = tflash.flash_attention_bwd(q, k, v, o, do, prefix_len=P)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two calls differ")
        want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                           prefix_len=P)
        errors = {n: rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        check_within(label, errors, dict.fromkeys(errors, BWD_RTOL[dtype]))
        max_abs = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
        del got, again, want
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        extra = {}
        try:  # the yardstick only: the port never calls SDPA
            out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
            torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError as e:
            out = None
            extra["library_refused"] = str(e)[:300]

        def kernel():
            tflash.flash_attention_bwd(q, k, v, o, do, prefix_len=P)

        def library():
            torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

        times = time_in_turns({"kernel": kernel,
                               **({"library": library} if out is not None else {})})
        nbytes = q.element_size() * 2 * (B * H * T + B * Hkv * T) * 2 * D
        peak = BF16_OPS_PER_S if dt == torch.bfloat16 else TF32_OPS_PER_S
        bms, by = bound_ms(nbytes, 2 * pairs * 5 * D, peak)
        row = dict(shape=dict(B=B, H=H, Hkv=Hkv, T=T, D=D, dtype=dtype), causal=True,
                   prefix_len=P, route="simt", errors=errors, max_abs_err=max_abs,
                   limit=BWD_RTOL[dtype], bitwise_repeat=True, kernel_ms=times["kernel"],
                   device_ms=bwd_device_ms(kernel),
                   plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do,
                                                                        prefix_len=P),
                                    reps=5, warmup=1),
                   library_ms=times.get("library"), bound_ms=bms, bound_by=by,
                   bound_peak="bf16 tensor cores" if dt == torch.bfloat16
                   else "TF32 tensor cores, one term",
                   exp_bound_ms=1e3 * 2 * pairs / exp_rate, **extra)
        backward.append(row)
        log({"kernel": "flash_attention_bwd", "path": "E1 prefix", **row})
        del q, k, v, do, o, qs, ks, vs, out
    backward.extend(vlm_tc_bwd_rows(rng, exp_rate))
    torch.cuda.empty_cache()
    return dict(forward=forward, backward=backward)


#: the ptxas markers of each tensor-core backward route's instances at
#: (256, 256) (L given, the dkdv kernel by part)
D256_BWD_INSTANCES = {
    "wgmma": ("flash_bwd_dq_wgmma_kernelILi256ELi256ELb1E",
              "flash_bwd_dq_wgmma_kernelILi256ELi256ELb0E", "flash_bwd_dkdv_d256_kernel"),
    "tf32": ("flash_bwd_dq_tf32_d256_kernelILb1E", "flash_bwd_dq_tf32_d256_kernelILb0E",
             "flash_bwd_dkdv_tf32_d256_kernel")}


def vlm_tc_bwd_rows(rng, exp_rate: float) -> list:
    """E1's tensor-core backwards under the prefix-LM mask at
    VLM_TC_BWD_CASES in bf16 (wgmma) and float32 (tf32), the route
    ``bwd_variant`` names, given the forward's L as autograd runs it and
    without (``no_lse``): each against ``ref.flash_attention_bwd_ref`` in
    float64 within BWD_RTOL, two calls bitwise; events ms in turns beside
    SDPA's backward with the mask as an explicit boolean ``attn_mask``
    (the yardstick; the port never calls it), device ms by kernel, the
    plain version's ms and the bound (the backward's five products over the
    pairs the mask keeps, ``prefix_pairs``, at the dtype's tensor rate, one
    TF32 term for float32, ``tc_bound_ms`` three; q, k, v, o, dO read and
    dQ, dK, dV written once; ``exp_bound_ms`` the two exp2 passes given L);
    at (256, 256) each instance's ptxas registers and spill bytes and each
    kernel's grid from the profiler's trace.  Comparison launches, not the
    path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref

    rows = []
    for B, H, Hkv, T, D, P in VLM_TC_BWD_CASES:
        mask = ref.attention_mask(T, T, True, P, "cuda")
        pairs = B * H * prefix_pairs(T, P)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, do = (normal(rng, s).to(dt) for s in ((B, H, T, D), (B, Hkv, T, D),
                                                           (B, Hkv, T, D), (B, H, T, D)))
            o, lse = tflash.flash_attention(q, k, v, return_lse=True, prefix_len=P)
            route = tflash.bwd_variant(dt, D)
            label = f"E1 prefix flash_attention_bwd {(B, H, Hkv, T, D)} P {P} {dtype} {route}"
            want = ref.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, do)),
                                               prefix_len=P)
            checked = {}
            for given in (lse, None):
                got = tflash.flash_attention_bwd(q, k, v, o, do, lse=given, prefix_len=P)
                again = tflash.flash_attention_bwd(q, k, v, o, do, lse=given, prefix_len=P)
                what = label + (" given L" if given is not None else "")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what}: two calls differ")
                errors = {n: rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
                check_within(what, errors, dict.fromkeys(errors, BWD_RTOL[dtype]))
                checked[given is not None] = (
                    errors, max(float((g.double() - w).abs().max()) for g, w in zip(got, want)))
                del got, again
            del want
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            extra = {}
            try:  # the yardstick only: the port never calls SDPA
                out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                     enable_gqa=True)
                torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
                torch.cuda.synchronize()
            except RuntimeError as e:
                out = None
                extra["library_refused"] = str(e)[:300]

            def kernel():
                tflash.flash_attention_bwd(q, k, v, o, do, lse=lse, prefix_len=P)

            def no_lse():
                tflash.flash_attention_bwd(q, k, v, o, do, prefix_len=P)

            def library():
                torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

            times = time_in_turns({"kernel": kernel, "no_lse": no_lse,
                                   **({"library": library} if out is not None else {})})
            nbytes = q.element_size() * 2 * (B * H * T + B * Hkv * T) * 2 * D
            flops = 2 * pairs * 5 * D
            peak = BF16_OPS_PER_S if dt == torch.bfloat16 else TF32_OPS_PER_S
            bms, by = bound_ms(nbytes, flops, peak)
            if dt == torch.float32:
                extra["tc_bound_ms"] = bound_ms(nbytes, 3 * flops, peak)[0]
            if D == 256:
                lib = tflash.BWD_KERNELS[route]
                extra["ptxas"] = {m: ptxas_instance(lib, m) for m in D256_BWD_INSTANCES[route]}
                grids = {}
                for r in trace_kernels(kernel, "flash_bwd", calls=5):
                    grids.setdefault(r.get("name", "")[:60], set()).add(
                        tuple(r.get("args", {}).get("grid", ())))
                extra["grids"] = {n: [list(g) for g in sorted(gs)] for n, gs in grids.items()}
            split, split_no_lse = {}, {}
            row = dict(shape=dict(B=B, H=H, Hkv=Hkv, T=T, D=D, dtype=dtype), causal=True,
                       prefix_len=P, pairs_per_head=prefix_pairs(T, P), route=route,
                       errors=checked[True][0], max_abs_err=checked[True][1],
                       limit=BWD_RTOL[dtype], bitwise_repeat=True, kernel_ms=times["kernel"],
                       device_ms=bwd_device_ms(kernel, by_kernel=split), device_kernels=split,
                       plain_ms=time_ms(lambda: tflash.BWD_PLAIN[route](
                           q, k, v, o, do, prefix_len=P), reps=3, warmup=1),
                       library_ms=times.get("library"),
                       library_device_ms=all_device_ms(library, 5) if out is not None else None,
                       bound_ms=bms, bound_by=by,
                       bound_peak="bf16 tensor cores" if dt == torch.bfloat16
                       else "TF32 tensor cores, one term",
                       exp_bound_ms=1e3 * 2 * pairs / exp_rate,
                       no_lse=dict(errors=checked[False][0], max_abs_err=checked[False][1],
                                   bitwise_repeat=True, kernel_ms=times["no_lse"],
                                   device_ms=bwd_device_ms(no_lse, by_kernel=split_no_lse),
                                   device_kernels=split_no_lse),
                       **extra)
            rows.append(row)
            log({"kernel": tflash.BWD_KERNELS[route].name, "path": "E1 prefix", **row})
            del q, k, v, do, o, lse, qs, ks, vs, out
        del mask
        torch.cuda.empty_cache()
    return rows


def vlm_phase(kernels, laps: Laps) -> dict:
    """Path L, paligemma-3b (the VLM: 256 stub patch embeddings times
    ``vision_proj`` in front of the text, the prefix-LM mask, head dim 256),
    after path K's memory is released, with the counts reset before each
    leg: L1 (float32 at full width and depth against float64, logits and
    every cache leaf; the TF32 forward at (256, 256) with the prefix once a
    layer a prefill, 18, none a decode step), L2 (serving at full width and
    depth, bf16, the wgmma forward 18 times a prefill and none a decode
    step; the prefill's device ms by part, ``VLM_PARTS``; a second run's
    tokens equal), L3 (the reduced config, head dim 16 and 16 patches: an
    AdamW step against float64, repeated bitwise, the mma forward and the
    SIMT backward carrying the prefix, then a prefill and decode steps
    against float64), L4 (training at full width, after L2's memory is
    released: (a) a float32 step at VLM_L4A_LAYERS layers against float64,
    repeated bitwise, the tf32 forward twice and the tf32 backward once a
    layer a microbatch, both at (256, 256) with the prefix; (b) bf16
    ``run_training``, ``vlm_train_leg``)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config

    gc.collect()
    torch.cuda.empty_cache()
    log({"path": "vlm", "memory_allocated_at_start": torch.cuda.memory_allocated()})
    none = {"flash_attention": 0, "flash_attention_tf32": 0, "flash_attention_wgmma": 0}
    cfg = get_config(VLM_ARCH)
    full32 = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (VLM_L1_B, VLM_L1_T)).astype(np.int32)
    legs = [float64_leg(full32, prompts, kernels,
                        {**none, "flash_attention_tf32": attention_layers(cfg)},
                        "vlm_float32", own_prefill=False,
                        inputs={"patches": stub_patches(cfg, VLM_L1_B)})]
    laps.lap("L1 paligemma float32 against float64")
    legs.append(serve_leg(kernels, cfg, path="vlm_serve", label="L2 paligemma serving",
                          mixers=VLM_PARTS, prompt_len=VLM_L2_T, batch=VLM_L2_B,
                          new=VLM_L2_NEW, inputs={"patches": stub_patches(cfg, VLM_L2_B)},
                          repeat=True))
    laps.lap("L2 paligemma serving")
    gc.collect()
    torch.cuda.empty_cache()
    small = cfg.reduced()
    n = attention_layers(small) * MLA_G4_MICRO
    step = train_step_check(kernels, small, "L3 paligemma train step, float32",
                            {**none, "flash_attention": 2 * n, "flash_attention_bwd": n,
                             "flash_attention_bwd_tf32": 0, "flash_attention_bwd_wgmma": 0})
    log({"path": "vlm_train_step", **step})
    legs.append(step)
    small_prompts = np.random.default_rng(SEED).integers(
        0, small.vocab_size, (LM_REDUCED_B, VLM_L3_T)).astype(np.int32)
    legs.append(float64_leg(small, small_prompts, kernels,
                            {**none, "flash_attention": attention_layers(small)},
                            "vlm_float32_reduced", own_prefill=True,
                            n_decode=VLM_L3_DECODE,
                            inputs={"patches": stub_patches(small, LM_REDUCED_B)}))
    laps.lap("L3 reduced paligemma train step and decode")
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(full32, n_layers=VLM_L4A_LAYERS)
    n = attention_layers(cfg32) * MLA_G4_MICRO
    step = train_step_check(kernels, cfg32, "L4(a) paligemma train step at full width, float32",
                            {**none, "flash_attention_tf32": 2 * n,
                             "flash_attention_bwd_tf32": n, "flash_attention_bwd": 0,
                             "flash_attention_bwd_wgmma": 0},
                            batch_size=VLM_L4A_B, seq=cfg.n_frontend_tokens + VLM_L4A_T)
    step.update(path="vlm_train_check", layers=VLM_L4A_LAYERS)
    log(step)
    legs.append(step)
    laps.lap("L4(a) paligemma float32 train step at full width against float64")
    gc.collect()
    torch.cuda.empty_cache()
    legs.append(vlm_train_leg(kernels))
    laps.lap("L4(b) paligemma bf16 training at full width")
    return dict(legs=legs)


def leaf_checksums(tree) -> list:
    """Each leaf's bit pattern summed as 64-bit integers, in chunks (no
    copy of a whole leaf): equal checksums of two runs' trees stand for
    bitwise equal leaves without holding both trees."""
    import torch
    from torch.utils import _pytree as pytree

    out = []
    for leaf in pytree.tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        flat = leaf.detach().reshape(-1)
        bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
        out.append(sum(int(bits[i:i + (1 << 24)].to(torch.int64).sum())
                       for i in range(0, bits.numel(), 1 << 24)))
    return out


def vlm_train_leg(kernels) -> dict:
    """L4(b): paligemma-3b at full width, bf16 parameters, AdamW as
    configured, remat ``full``, through ``run_training`` for VLM_L4B_STEPS
    steps of VLM_L4B_B × (256 patches + VLM_L4B_T tokens) (the plan's
    microbatches): step ms and tokens/s (text and patch positions; host wall
    of a step ended by reading its loss, the median of the steps after the
    first), peak bytes, the flash launches a step (each layer's wgmma
    forward twice a microbatch under remat, its wgmma backward once, both
    at (256, 256) with the prefix), then one more step profiled (idle
    share, top kernels, the backward's kernels), and one more step run twice
    from one state: the loss, ``grad_norm`` and every leaf of the new
    parameters and optimizer state bitwise equal (``leaf_checksums``).
    Depth: full (18 layers) first; the reckoning from E3's peak bytes a
    parameter (E3_PEAK_BYTES_PER_PARAM) against the card's memory gives the
    most layers expected to fit, taken when the full depth runs out of
    memory.  Gates: every loss finite, the last below the first, and step
    0's within VLM_L4B_LOSS0_RTOL of the same initial parameters' loss on the
    same batch in float32 through ``plain_attention`` (``loss0_float32``:
    at init paligemma's loss is not near ln(vocab_size), as E3's is, so
    that is no gate here)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data import lm_data
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import make_train_plan, make_train_step, run_training
    from repro_torch.models import attention as tattn
    from repro_torch.models import registry
    from repro_torch.optim import make_optimizer
    from torch.utils import _pytree as pytree

    full = get_config(VLM_ARCH)
    seq = full.n_frontend_tokens + VLM_L4B_T
    shape = ShapeSpec("l4", seq, VLM_L4B_B, "train")
    total = torch.cuda.get_device_properties(0).total_memory

    def reckoned(layers: int) -> float:
        cfg_ = dataclasses.replace(full, n_layers=layers)
        return registry.build(cfg_).n_params() * E3_PEAK_BYTES_PER_PARAM

    fit = max((n for n in range(1, full.n_layers + 1) if reckoned(n) <= total), default=1)
    reckoning = dict(total_memory=total, bytes_per_param=E3_PEAK_BYTES_PER_PARAM,
                     full_depth_bytes=reckoned(full.n_layers), layers_expected_to_fit=fit)
    tried = []
    for layers in sorted({full.n_layers, fit, max(fit - 2, 1)}, reverse=True):
        cfg = dataclasses.replace(full, n_layers=layers)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        try:
            params, history = run_training(cfg, steps=VLM_L4B_STEPS, batch_size=VLM_L4B_B,
                                           seq_len=seq, seed=SEED, log_every=1, device="cuda")
        except torch.cuda.OutOfMemoryError as e:
            tried.append(dict(layers=layers, out_of_memory=str(e)[:200]))
            continue
        break
    else:
        raise AssertionError(f"L4(b): no depth fits: {tried}")
    torch.cuda.synchronize()
    plan = make_train_plan(cfg, shape, make_smoke_mesh())
    per_step = attention_layers(cfg) * plan.n_microbatches
    launches = read_launches("L4(b) paligemma bf16 training", kernels, {
        "flash_attention_wgmma": 2 * per_step * VLM_L4B_STEPS,
        "flash_attention_bwd_wgmma": per_step * VLM_L4B_STEPS, "flash_attention_bwd": 0,
        "flash_attention_bwd_tf32": 0, "flash_attention": 0, "flash_attention_tf32": 0})
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    step_s = statistics.median(h["time_s"] for h in history[1:])
    api = registry.build(cfg)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    with torch.no_grad(), swapped(tattn, "flash_attention", plain_attention):
        params32 = pytree.tree_map(lambda t: t.float(), api.init(seed=SEED, device="cuda"))
        loss32 = float(registry.build(cfg32).loss(
            params32, lm_data._batch_for_step(cfg, shape, SEED, 0, "cuda"))[0])
    del params32
    opt = make_optimizer(cfg.optimizer, 3e-4)
    state = opt.init(params)
    batch = lm_data._batch_for_step(cfg, shape, SEED, VLM_L4B_STEPS, "cuda")
    step_fn = make_train_step(cfg, api, opt, plan)
    events, wall = device_events(lambda: step_fn(params, state, batch), 1)
    profile = _busy(events, wall)
    backward = {}
    for e in events:
        if "flash_bwd" in e.name:
            ms, n = backward.get(e.name[:90], (0.0, 0))
            backward[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    profile.update(backward_kernels={k: list(v) for k, v in backward.items()},
                   backward_ms=sum(ms for ms, _ in backward.values()))
    del events
    sums = []
    for _ in range(2):  # one state, two steps: only the second's checksums are kept beside
        new, new_state, metrics = step_fn(params, state, batch)
        sums.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     leaf_checksums(new), leaf_checksums(new_state)))
        del new, new_state, metrics
    bitwise = sums[0] == sums[1]
    del params, state
    torch.cuda.empty_cache()
    out = dict(path="vlm_train", arch=full.name, layers=cfg.n_layers, n_params=api.n_params(),
               depth_reckoning=reckoning, depths_out_of_memory=tried, steps=VLM_L4B_STEPS,
               batch=VLM_L4B_B, seq=seq, patches=full.n_frontend_tokens,
               n_microbatches=plan.n_microbatches, losses=losses, loss0_float32=loss32,
               ln_vocab=math.log(full.vocab_size), step_ms=1e3 * step_s,
               step_ms_each=[1e3 * h["time_s"] for h in history],
               tokens_per_s=VLM_L4B_B * seq / step_s, max_memory_allocated=peak,
               flash_launches_per_step={
                   "forward": launches["flash_attention_wgmma"] / VLM_L4B_STEPS,
                   "backward": launches["flash_attention_bwd_wgmma"] / VLM_L4B_STEPS},
               profile=profile, repeat_loss=sums[0][0], repeat_bitwise=bitwise,
               launches=launches)
    log(out)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"L4(b): a loss is not finite, or the last is not below "
                             f"the first: {losses}")
    if not abs(losses[0] - loss32) <= VLM_L4B_LOSS0_RTOL * abs(loss32):
        raise AssertionError(f"L4(b): step 0 loss {losses[0]} is not within "
                             f"{VLM_L4B_LOSS0_RTOL} of float32's {loss32}")
    if not bitwise:
        raise AssertionError("L4(b): two steps from one state differ")
    return out


# ---------------------------------------------------------------------------
# Sparse view storage: the hash kernels and the housing legs
# ---------------------------------------------------------------------------
#: the housing legs: (label, ring, active postcodes, pool of postcodes,
#: batch, batches, fusion modes).  S1 is the reference's own sparse
#: scenario (bench_stream.py's housing leg); S2 draws from 4,096 postcodes,
#: so the tables must grow; S3 is the degree-8 cofactor ring at full width
#: (d = 73), 3,072 active postcodes (fill 4.7 %).
HOUSING_LEGS = (("S1_housing_sum", "sum", 512, 512, 64, 10, ("off", "auto")),
                ("S2_housing_sum_growth", "sum", 512, 4096, BATCH, N_BATCHES, ("auto",)),
                ("S3_housing_cofactor", "cofactor", 3072, 3072, BATCH, N_BATCHES, ("auto",)))
#: the hash kernels' shapes: a table of S3's planned capacity holding its
#: active keys, and a batch of distinct ids (S3's batches, in rank order)
HASH_C, HASH_KEYS, HASH_B = 8192, 3072, BATCH
#: a rehash of 2^16 ids into 2^17 slots, past one block's shared memory
#: (the global route)
HASH_REHASH_C, HASH_REHASH_B = 1 << 17, 1 << 16


def chain_lengths(slot, ids, C: int) -> float:
    """Mean table words a probe of ``ids`` read to reach ``slot`` (its
    distance from the id's hash slot, plus one)."""
    from repro_torch.kernels import hash_table

    valid = ids >= 0
    dist = (slot - hash_table.hash_ids(ids.clamp(min=0), C)) & (C - 1)
    return float((dist[valid].double() + 1).mean()) if bool(valid.any()) else 0.0


def hash_rows(rng, rows: dict) -> None:
    """The hash kernels of sparse view storage against their plain versions
    (the reference's loops in torch, run on the same card tensors),
    bitwise.  ``hash_insert`` by the route the wrapper picks, with its
    rounds: at the S3 shape (a table of 8,192
    slots holding 3,072 keys, 1,000 distinct ids, half of them present), a
    full table (rows that never place) and the rehash of 2^16 ids into 2^17
    slots.  ``hash_probe`` on the filled table.  At the S3 shape also
    ``hash_insert_targets`` on a raw batch (duplicated ids, sentinels; by
    ids and keyed) against its plain version and against the rank prepass
    composition it replaces, and the keyed probe against its plain
    version and the stack → linear_ids → probe → where it replaces; on a
    sparse relation, a claim (``fused_slot_targets``) and a sibling gather
    (``gather_rows``) must each be one device event.  Timed with CUDA
    events and the profiler; bound: ids (or key columns) and the chain
    words read at the measured mean chain length, the results written (and
    the table words an insert writes: its new ids, not its hits), at the
    card's memory rate."""
    import torch
    from repro_torch.kernels import hash_table

    def case(C, n_keys, B, present):
        keys = rng.choice(1 << 22, size=n_keys + B, replace=False).astype(np.int32)
        table = torch.full((C,), -1, dtype=torch.int32, device="cuda")
        hash_table.insert_ref(table, ids_tensor(keys[:n_keys]))
        ids = np.concatenate([rng.choice(keys[:n_keys], size=present, replace=False),
                              keys[n_keys:n_keys + B - present]]) if n_keys else keys[:B]
        return table, ids_tensor(rng.permutation(ids)), keys

    def check(label, pairs):
        for name, g, w in pairs:
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: {name} differs from the plain version")

    kernel_of = {"cta": "smem_insert_kernel", "global": "global_insert_kernel"}
    for C, n_keys, B, present in ((HASH_C, HASH_KEYS, HASH_B, HASH_B // 2),
                                  (64, 40, 40, 10), (HASH_REHASH_C, 0, HASH_REHASH_B, 0)):
        table, ids, _ = case(C, n_keys, B, present)
        shape = dict(C=C, keys=n_keys, B=B)
        want_t, want_rounds = table.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")
        want = hash_table.insert_ref(want_t, ids, rounds=want_rounds)
        n_placed = int(want[1].sum())
        # the table words the insert writes: placed rows whose id was not
        # there yet (a hit resolves without a write)
        n_written = int((want_t != table).sum())
        ins_len = chain_lengths(want[0].masked_fill(~want[1], 0),
                                ids.masked_fill(~want[1], -1), C)
        bms, by = bound_ms(B * 4 + B * ins_len * 4 + B * 5 + n_written * 4, 0)
        work = table.clone()
        route = hash_table.insert_route(C, B)
        got_t = table.clone()
        rounds = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = hash_table.hash_insert(got_t, ids, rounds=rounds)
        torch.cuda.synchronize()
        check(f"hash_insert {shape} route {route}",
              (("table", got_t, want_t), ("slot", got[0], want[0]),
               ("placed", got[1], want[1]), ("rounds", rounds, want_rounds)))

        def insert():  # on a fresh copy of the table each call
            work.copy_(table)
            return hash_table.hash_insert(work, ids)

        def insert_plain():
            work.copy_(table)
            return hash_table.insert_ref(work, ids)

        row = dict(shape=shape, insert_route=route, rounds=int(rounds),
                   max_abs_err=0.0, placed=n_placed, written=n_written,
                   mean_chain=ins_len, kernel_ms=time_ms(insert),
                   device_ms=kernel_device_ms(insert, kernel_of[route]),
                   plain_ms=time_ms(insert_plain, reps=5, warmup=1), library_ms=None,
                   bound_ms=bms, bound_by=by,
                   note="ms and plain_ms include a copy of the table a call")
        rows["hash_insert"].append(row)
        log({"kernel": "hash_insert", **row})
        # probe: the filled table, the batch and as many absent ids
        queries = torch.cat([ids, ids_tensor(rng.integers(0, 1 << 22, size=B))])
        pw = hash_table.probe_ref(want_t, queries)
        probe_len = chain_lengths(pw[0], queries, C)
        nq = queries.shape[0]
        bms, by = bound_ms(nq * 4 + nq * probe_len * 4 + nq * 5, 0)
        plain_ms = time_ms(lambda: hash_table.probe_ref(want_t, queries), reps=5, warmup=1)
        pg = hash_table.hash_probe(want_t, queries)
        check(f"hash_probe {shape}", (("slot", pg[0], pw[0]), ("found", pg[1], pw[1])))

        def probe():
            return hash_table.hash_probe(want_t, queries)

        row = dict(shape=dict(shape, B=nq), max_abs_err=0.0, mean_chain=probe_len,
                   found=int(pw[1].sum()), kernel_ms=time_ms(probe),
                   device_ms=kernel_device_ms(probe, "hash_probe_kernel"),
                   plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
        rows["hash_probe"].append(row)
        log({"kernel": "hash_probe", **row})
        del work
    hash_key_rows(rng, rows, case, check)


def hash_key_rows(rng, rows: dict, case, check) -> None:
    """``hash_insert_targets`` and the keyed probe at the S3 shape (see
    :func:`hash_rows`), and the one-event claim and gather of a sparse
    relation."""
    import torch
    from repro_torch.core import storage, sum_ring
    from repro_torch.kernels import hash_table

    C, n_keys, B = HASH_C, HASH_KEYS, HASH_B
    table, _, keys = case(C, n_keys, 0, 0)
    # a raw batch as S3's: ids drawn with repeats from the keys held and as
    # many new ones, a few sentinels; and the same ids as column 1 of a
    # [B, 3] key matrix (the delta's), linearized with stride 1
    pool = np.concatenate([keys[:n_keys], rng.choice(1 << 22, size=n_keys)])
    raw = rng.choice(pool, size=B).astype(np.int32)
    raw[rng.random(B) < 0.02] = -1
    ids = ids_tensor(raw)
    kmat = ids_tensor(np.stack([rng.integers(0, 9, size=B), raw.clip(0),
                                rng.integers(0, 9, size=B)], axis=1))
    want_t = table.clone()
    want = hash_table.insert_targets_ref(want_t, ids)
    # the composition it replaces: rank prepass, insert, gather back to rows
    comp_t = table.clone()
    rank, uniq = storage._rank_ids(ids)
    slot, placed = hash_table.hash_insert(comp_t, uniq)
    composed = torch.where(placed, slot, -1).index_select(0, rank.long())
    check("rank prepass composition", (("table", comp_t, want_t), ("target", composed, want)))
    n_written = int((want_t != table).sum())
    distinct = int(torch.unique(ids[ids >= 0]).numel())
    ins_len = chain_lengths(want.clamp(min=0), ids.masked_fill(want < 0, -1), C)
    # the key matrix holds a sentinel row as key 0
    want_kt = table.clone()
    want_k = hash_table.insert_targets_ref(want_kt, ids.clamp(min=0))
    work = table.clone()
    plain_ms = None
    for keyed in (False, True):
        got_t = table.clone()
        got = (hash_table.hash_insert_targets_keys(got_t, kmat, (1,), (1,)) if keyed
               else hash_table.hash_insert_targets(got_t, ids))
        torch.cuda.synchronize()
        check(f"hash_insert_targets keyed={keyed}",
              (("table", got_t, want_kt if keyed else want_t),
               ("target", got, want_k if keyed else want)))

        def claim(keyed=keyed):
            work.copy_(table)
            return (hash_table.hash_insert_targets_keys(work, kmat, (1,), (1,)) if keyed
                    else hash_table.hash_insert_targets(work, ids))

        def composition():
            work.copy_(table)
            rank, uniq = storage._rank_ids(ids)
            slot, placed = hash_table.hash_insert(work, uniq)
            return torch.where(placed, slot, -1).index_select(0, rank.long())

        if plain_ms is None:
            def claim_plain():
                work.copy_(table)
                return hash_table.insert_targets_ref(work, ids)

            plain_ms = time_ms(claim_plain, reps=5, warmup=1)
        bms, by = bound_ms(B * 4 + distinct * ins_len * 4 + B * 4 + n_written * 4, 0)
        row = dict(shape=dict(C=C, keys=n_keys, B=B, keyed=keyed),
                   insert_route=hash_table.insert_route(C, B),
                   distinct=distinct, written=n_written, mean_chain=ins_len,
                   max_abs_err=0.0, kernel_ms=time_ms(claim),
                   device_ms=kernel_device_ms(claim, "smem_insert_kernel"),
                   composition_ms=time_ms(composition),
                   composition_device_ms=all_device_ms(composition),
                   composition_events=len(device_events(composition, 1)[0]),
                   plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                   note="ms, composition_ms and plain_ms include a copy of the "
                        "table a call")
        rows["hash_insert_targets"].append(row)
        log({"kernel": "hash_insert_targets", **row})
    # keyed probe: the filled table, the batch's key matrix and as many rows
    # of absent ids
    qraw = np.concatenate([raw.clip(0), rng.integers(0, 1 << 22, size=B)]).astype(np.int32)
    qmat = ids_tensor(np.stack([rng.integers(0, 9, size=2 * B), qraw,
                                rng.integers(0, 9, size=2 * B)], axis=1))
    pw = hash_table.probe_keys_ref(want_t, qmat, (1,), (1,))
    probe_len = chain_lengths(pw[0], ids_tensor(qraw), C)
    nq = 2 * B
    bms, by = bound_ms(nq * 4 + nq * probe_len * 4 + nq * 9, 0)
    plain_ms = time_ms(lambda: hash_table.probe_keys_ref(want_t, qmat, (1,), (1,)),
                       reps=5, warmup=1)

    def composition():
        stacked = torch.stack([qmat[:, 1]], dim=1)
        slot, found = hash_table.hash_probe(want_t, storage.linear_ids(stacked, (1 << 22,)))
        return torch.where(found, slot, C)

    check("keyed probe composition", (("rows", composition(), pw[2]),))
    pg = hash_table.hash_probe_keys(want_t, qmat, (1,), (1,))
    check("hash_probe_keys",
          (("slot", pg[0], pw[0]), ("found", pg[1], pw[1]), ("rows", pg[2], pw[2])))

    def probe():
        return hash_table.hash_probe_keys(want_t, qmat, (1,), (1,))

    row = dict(shape=dict(C=C, keys=n_keys, B=nq, keyed=True), max_abs_err=0.0,
               mean_chain=probe_len, found=int(pw[1].sum()), kernel_ms=time_ms(probe),
               device_ms=kernel_device_ms(probe, "hash_probe_kernel"),
               composition_ms=time_ms(composition),
               composition_device_ms=all_device_ms(composition),
               composition_events=len(device_events(composition, 1)[0]),
               plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
    rows["hash_probe_keys"].append(row)
    log({"kernel": "hash_probe_keys", **row})
    # a sparse relation at S3's capacity: a claim and a sibling gather on a
    # delta's key matrix are one device event each
    rel = storage.SparseRelation.zeros(("pc",), sum_ring(), (1 << 22,), capacity=C,
                                       device="cuda")
    rel.scatter_add(ids_tensor(keys[:n_keys, None]),
                    {"v": torch.ones(n_keys, device="cuda")})
    events = dict(
        fused_slot_targets=check_one_launch(
            "sparse claim", lambda: rel.fused_slot_targets(kmat, (1,)),
            "smem_insert_kernel", hash_table.HASH_INSERT),
        gather_rows=check_one_launch(
            "sparse sibling gather", lambda: rel.gather_rows(kmat, (1,)),
            "hash_probe_kernel", hash_table.HASH_PROBE))
    log({"hash_one_launch": events})
    rows["hash_insert_targets"][-1]["device_events_per_call"] = events["fused_slot_targets"]
    rows["hash_probe_keys"][0]["device_events_per_call"] = events["gather_rows"]


def housing_query(ring: str, doms, dtype=None):
    import torch
    from repro_torch.core import Query, sum_ring
    from repro_torch.core.apps import regression
    from repro_torch.data.synth import HOUSING_RELATIONS

    dtype = dtype or torch.float32
    if ring == "sum":
        return Query(relations=HOUSING_RELATIONS, free_vars=(), ring=sum_ring(dtype),
                     domains=doms, lifts={"h2": ("value",)})
    return regression.cofactor_query(HOUSING_RELATIONS, doms, dtype=dtype)


def dense_bytes(eng) -> int:
    """The bytes the engine's views would hold stored densely."""
    import torch
    from repro_torch.core.storage import payload_width

    return sum(math.prod(v.domains) * payload_width(v.ring)
               * torch.empty((), dtype=v.ring.dtype).element_size()
               for v in eng.views.values())


def capacities(eng) -> dict:
    from repro_torch.core.storage import SparseRelation

    return {n: v.capacity for n, v in sorted(eng.views.items())
            if isinstance(v, SparseRelation)}


def housing_phase(kernels, laps) -> list:
    """The housing star at ``HOUSING_DOMS_BIG`` (pc = 65,536) with ``auto``
    storage, legs S1-S3 (``HOUSING_LEGS``), each with its kernels' launch
    counts reset before and read after each run."""
    import torch
    from repro_torch.core import plan
    from repro_torch.data.synth import HOUSING_DOMS_BIG, HOUSING_RELATIONS, synth_low_fill_db

    out = []
    for label, ring, n_active, pool_n, batch, n_batches, fusions in HOUSING_LEGS:
        q, q64 = housing_query(ring, HOUSING_DOMS_BIG), housing_query(
            ring, HOUSING_DOMS_BIG, torch.float64)
        db, active = synth_low_fill_db(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                                       np.random.default_rng(SEED), "pc", n_active,
                                       device="cuda")
        inactive = np.setdiff1d(np.arange(HOUSING_DOMS_BIG["pc"]), active)
        pool = np.sort(np.concatenate([
            active, np.random.default_rng(SEED + 2).choice(
                inactive, size=pool_n - n_active, replace=False)]))
        for fusion in fusions:
            with plan.use_fusion(fusion):
                leg = housing_leg(f"{label}_fusion_{fusion}", label[:2], q, q64, db,
                                  pool, n_active, batch, n_batches, kernels)
            log(leg)
            out.append(leg)
            laps.lap(f"housing {label} fusion {fusion}")
        del db
        torch.cuda.empty_cache()
    return out


def housing_stream(q, pool, batch, n_batches, seed):
    from repro_torch.data.synth import HOUSING_DOMS_BIG, HOUSING_RELATIONS, update_stream

    return update_stream(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                         np.random.default_rng(seed), batch, n_batches,
                         key_pools={"pc": pool}, device="cuda")


def housing_leg(label, leg, q, q64, db, pool, n_active, batch, n_batches,
                kernels) -> dict:
    """One housing leg: the eager engine (``apply_update``, growth
    included), its launches, its rate, its profile, then the stream
    executor on a fresh engine, each held to the float64 oracle."""
    import torch
    from repro_torch.core import IVMEngine, plan
    from repro_torch.core.storage import as_dense, next_pow2
    from repro_torch.data.synth import housing_vo

    stream = housing_stream(q, pool, batch, n_batches, SEED + 1)

    def build(**kw):
        eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                              device="cuda", **kw)
        eng.precompile(batch)
        return eng

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    storage_plan = {n: [s.kind, s.capacity] for n, s in sorted(eng.storage_plan.items())}
    n_sparse = sum(s.kind == "sparse" for s in eng.storage_plan.values())
    caps_before = capacities(eng)
    # the reference's plan: six tables of next_pow2(2 · active + 1) slots
    # (2,048 at S1's 512 postcodes, 8,192 at S3's 3,072), the root dense
    if (n_sparse != 6 or set(caps_before.values()) != {next_pow2(2 * n_active + 1)}
            or eng.storage_plan["V7@pc"].kind != "dense"):
        raise AssertionError(f"{label}: not the reference's plan: {storage_plan}")
    sparse_bytes, dense_b = eng.memory_bytes(), dense_bytes(eng)
    reset(kernels)
    t0 = time.perf_counter()
    for rel, upd in stream:
        eng.apply_update(rel, upd)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    missing = [n for n in ("hash_probe", "hash_insert") if launches[n] == 0]
    if missing:
        raise AssertionError(f"{label}: the sparse path never launched {missing}")
    # every sparse read is the keyed probe, every batch's claim one insert
    if not launches["hash_probe:keys"] or launches["hash_probe:ids"]:
        raise AssertionError(f"{label}: sparse reads not keyed: {launches}")
    eager_caps = capacities(eng)
    if leg == "S2" and not all(eager_caps[n] > caps_before[n] for n in caps_before):
        raise AssertionError(f"{label}: the eager tables did not grow: "
                             f"{caps_before} -> {eager_caps}")
    oracle = oracle_store(eng, db, stream, q64, 1)
    check = compare_views(label, eng, oracle)
    if leg != "S3":  # integer data: every view bitwise, and equal to dense storage
        dense = build(storage="dense")
        for rel, upd in stream:
            dense.apply_update(rel, upd)
        for name, v in dense.views.items():
            got = as_dense(eng.views[name])
            for c, t in v.payload.items():
                if not torch.equal(got.payload[c], t):
                    raise AssertionError(f"{label} {name}.{c}: sparse storage "
                                         f"differs from dense storage")
        del dense
    eager_views = {n: as_dense(v) for n, v in eng.views.items()}
    del eng
    torch.cuda.empty_cache()
    # where the eager stream's time goes
    prof_eng = build()
    updates = iter(stream)
    events, wall = device_events(lambda: prof_eng.apply_update(*next(updates)), len(stream))
    profile = _busy(events, wall)
    profile["device_events_per_batch"] = profile["device_events"] / n_batches
    del prof_eng
    torch.cuda.empty_cache()
    executor = housing_executor(label, leg, build, stream, q, q64, db, pool, batch,
                                n_batches, kernels, eager_views)
    return dict(
        stream=label, fusion=plan.fusion_mode("cuda"), batch=batch, n_batches=n_batches,
        n_active=n_active, pool=int(len(pool)),
        storage_plan=storage_plan, sparse_views=n_sparse,
        view_bytes_sparse=sparse_bytes, view_bytes_dense=dense_b,
        capacities_before=caps_before, capacities_after_eager=eager_caps,
        build_s=build_s, run_s=run_s, tuples_per_s=batch * n_batches / run_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches,
        launches_per_batch={k: n / n_batches for k, n in launches.items() if n},
        oracle=check, profile=profile, executor=executor)


def housing_executor(label, leg, build, stream, q, q64, db, pool, batch, n_batches,
                     kernels, eager_views) -> dict:
    """The leg's stream through the stream executor on a fresh engine.
    S1 and S3: a capture run of the prepared stream, then a replay-only
    run (``donate_input=True``) of a second stream of the same signature
    under ``set_sync_debug_mode("error")``, then the oracle over both.
    S2: the raw stream, split into capacity segments with a rehash between
    them; its tables must grow, and its views equal the eager engine's."""
    import torch
    from repro_torch.core import StreamExecutor, prepare_stream
    from repro_torch.core.storage import as_dense

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = build()
    caps_before = capacities(eng)
    ex = StreamExecutor(eng)
    out = dict(capacities_before=caps_before)
    if leg == "S2":
        reset(kernels)
        t0 = time.perf_counter()
        ex.run(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        segs = ex.last_segment_stats
        caps = capacities(eng)
        if len(segs) < 2 or not all(caps[n] > caps_before[n] for n in caps_before):
            raise AssertionError(f"{label} executor: no growth: {len(segs)} segments, "
                                 f"{caps_before} -> {caps}")
        for name, v in eager_views.items():
            got = as_dense(eng.views[name])
            for c, t in v.payload.items():
                if not torch.equal(got.payload[c], t):
                    raise AssertionError(f"{label} executor {name}.{c}: differs "
                                         f"from the eager engine")
        launches = {k.name: k.launches for k in kernels}
        out.update(segments=len(segs), capacities_after=caps, launches=launches,
                   grown_at=[[s["segment"], s["grow"]] for s in segs if s["grow"]],
                   replays=sum(s["run"].get("replays", 0) for s in segs),
                   eager_steps=sum(s["run"].get("eager_steps", 0) for s in segs),
                   admit_s=sum(s["admit_s"] for s in segs),
                   run_s=wall, tuples_per_s=batch * n_batches / wall,
                   launches_per_batch={k: n / n_batches for k, n in launches.items() if n},
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   oracle=compare_views(label + "_executor", eng,
                                        oracle_store(eng, db, stream, q64, 1)))
        ex.release()
        del eng, ex
        torch.cuda.empty_cache()
        return out
    second = housing_stream(q, pool, batch, n_batches, SEED + 3)
    t0 = time.perf_counter()
    prepared = prepare_stream(eng, stream)
    prepare_s = time.perf_counter() - t0
    prepared2 = prepare_stream(eng, second)
    if prepared2.signature != prepared.signature:
        raise AssertionError(f"{label}: the second stream's signature differs")
    runs = {}
    for run in ("capture", "replay"):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "capture":
            ex.run(prepared)
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                ex.run(prepared2, donate_input=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(ex.last_run_stats)
        launches = {k.name: k.launches for k in kernels}
        if (not stats["replays"] or (run == "replay" and stats["eager_steps"])
                or not launches["hash_insert"] or not launches["hash_probe"]):
            raise AssertionError(f"{label} executor {run} run: stats {stats}, "
                                 f"launches {launches}")
        runs[run] = dict(run_s=wall, tuples_per_s=batch * n_batches / wall,
                         launches=launches,
                         launches_per_batch={k: n / n_batches
                                             for k, n in launches.items() if n},
                         **stats)
    reset(kernels)
    events, wall = device_events(lambda: ex.run(prepared, donate_input=True), 1)
    profile = _busy(events, wall)
    profile["device_events_per_batch"] = profile["device_events"] / n_batches
    out.update(mode=prepared.mode, prepare_s=prepare_s, capture_run=runs["capture"],
               replay_run=runs["replay"], profile=profile,
               launches={k.name: runs["capture"]["launches"][k.name]
                         + runs["replay"]["launches"][k.name] for k in kernels},
               capacities_after=capacities(eng),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               max_memory_reserved=torch.cuda.max_memory_reserved(),
               oracle=compare_views(label + "_executor", eng, oracle_store(
                   eng, db, stream + second + stream, q64, 1)))
    ex.release()
    del eng, ex, prepared2, second
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Sec. 6 and Sec. 7.3: the triangle query with indicator projections, and
# the conjunctive query's factorized and listing representations
# ---------------------------------------------------------------------------
#: the triangle leg (paper Fig. 11, ``benchmarks/bench_triangle.py``): n a
#: variable, the bench's density 3/n, 20 batches of 1000 distinct keys
TRIANGLE_N, TRIANGLE_BATCHES = 4096, 20
#: label, IVMEngine.build keywords (every engine: fuse_chains=False, auto
#: storage, plan fusion auto)
TRIANGLE_ENGINES = (("fivm_indicators", dict(strategy="fivm", use_indicators=True)),
                    ("fivm", dict(strategy="fivm")),
                    ("dbt_indicators", dict(strategy="dbt", use_indicators=True)))


def plan_launches(plan, eng) -> dict:
    """The hand-kernel launches one replay of ``plan`` on ``eng`` makes, by
    kernel, from its ops and the backends they carry: a ⊎ under
    ``scatter`` is one ``scatter_add`` launch (one ``gather_mul_scatter``
    when a scalar-ring sibling gather fuses into it), under ``compact`` one
    ``segment_ring_sum`` and one ``scatter_add``; a ⊎ of a delta with only
    dense axes, and any ⊎ under ``torch``, launches nothing; a fused chain
    is one ``fused_chain`` launch.  An IndicatorBump ⊎s its δ∃ into the 0/1
    plane, a plan that writes its relation's stored base ⊎s the batch into
    it, and a densified leaf (a float32 ring's) ⊎s the batch into its dense
    delta relation, each under the backend the dispatch resolves for it.
    A sparse view's sibling read (a Gather, or a fully bound join) is one
    keyed ``hash_probe``; its ⊎ claims the batch's slots with one
    ``hash_insert`` (a fused chain's terminal too), then runs one
    gather-⊗-⊎ (a scalar ring's pending gather) or, for float32 rows, one
    ``segment_ring_sum`` of each key's rows and the flat ⊎ under its
    backend.  Growth (a rehash) is outside the plans."""
    import torch
    from repro_torch.core import plan as P
    from repro_torch.core.storage import payload_width
    from repro_torch.kernels import scatter_ops

    ring = eng.query.ring
    out: dict = {}

    def add(name, n=1):
        out[name] = out.get(name, 0) + n

    def scatter(backend, fused_scalar=False):
        add_launches(out, backend_launches(backend, fused_scalar))

    def resolved(domains):
        return scatter_ops.resolve_backend(math.prod(domains), plan.batch,
                                           payload_width(ring), device="cuda")

    scalar = set(ring.components) == {"v"}
    float_rows = ring.dtype == torch.float32

    def sparse_scatter(op):
        add("hash_insert")  # the batch's slots, claimed by key
        if op.fused and scalar:  # then one gather-⊗-⊎ over the plane
            if float_rows:
                scatter(op.backend, fused_scalar=True)
        elif float_rows:  # the rows of a key summed, then one flat ⊎
            add("segment_ring_sum")
            scatter(op.backend)

    for op in P.iter_flat_ops(plan.ops + plan.ind_ops):
        sparse = getattr(op, "storage", None) == "sparse"
        if sparse and (isinstance(op, P.Gather) or (
                isinstance(op, P.JoinContract) and op.gathers)):
            add("hash_probe")  # the delta's keys probed, a plane row each
    for op in plan.ops + plan.ind_ops:
        if isinstance(op, P.LeafDelta) and op.densify:
            # the densified leaf's delta is the batch ⊎ into a fresh dense
            # relation over the update schema (``plan.densified_delta``)
            if float_rows:
                scatter(resolved(tuple(eng.query.domains[v] for v in op.schema)))
        elif isinstance(op, P.FusedChain):
            add("fused_chain")
            if op.ops[-1].storage == "sparse":
                add("hash_insert")  # the terminal's slots (fused_slot_targets)
        elif isinstance(op, P.ScatterAccum):
            if op.storage == "sparse":
                sparse_scatter(op)
            else:
                scatter(op.backend, fused_scalar=op.fused and scalar)
        elif isinstance(op, P.IndicatorBump):
            scatter(resolved(eng.indicators[op.node].counts.shape))
    for rel in plan.write_base:
        scatter(resolved(eng.base[rel].domains))
    return out


def backend_launches(backend, fused_scalar: bool = False) -> dict:
    """The hand-kernel launches of one flat ⊎ under ``backend``: ``scatter``
    one ``scatter_add`` (one ``gather_mul_scatter`` when a scalar ring's
    sibling gather fuses into it), ``compact`` one ``segment_ring_sum`` and
    one ``scatter_add``, ``scatter_dedup`` one ``scatter_dedup``, ``torch``
    (or none) nothing."""
    if backend in (None, "torch"):
        return {}
    if backend == "compact":
        return {"segment_ring_sum": 1, "scatter_add": 1}
    if fused_scalar:
        return {"gather_mul_scatter": 1}
    return {"scatter_dedup" if backend == "scatter_dedup" else "scatter_add": 1}


def segment_launches(build, stream, segments) -> dict:
    """The launches of a segmented executor run from its plans: for each of
    its ``segments`` (the run's ``last_segment_stats``, in order) the rehash
    of each table the segment grew (one ``hash_insert`` of the old
    capacity's rows and, for float32 rows, one ``segment_ring_sum`` and the
    flat ⊎ into the new table), then :func:`stream_launches` of its updates
    on a fresh engine (``build()``) rehashed to the segment's capacities, as
    a plan's sparse ⊎ backend follows its table's capacity."""
    import torch
    from repro_torch.core import stream as stream_mod
    from repro_torch.core.storage import payload_width
    from repro_torch.kernels import scatter_ops

    eng = build()
    ring = eng.query.ring
    out: dict = {}
    off = 0
    for seg in segments:
        for name, cap in sorted(seg["grow"].items()):
            add_launches(out, {"hash_insert": 1})
            if ring.dtype == torch.float32:
                add_launches(out, {"segment_ring_sum": 1})
                add_launches(out, backend_launches(scatter_ops.resolve_backend(
                    cap, eng.views[name].capacity, payload_width(ring), device="cuda")))
        if seg["grow"]:
            stream_mod._rehash(eng, seg["grow"])
        add_launches(out, stream_launches(eng, stream[off:off + seg["updates"]]))
        off += seg["updates"]
    if off != len(stream):
        raise AssertionError(f"segments of {off} updates for a stream of {len(stream)}")
    del eng
    return out


def stream_launches(eng, stream) -> dict:
    """:func:`plan_launches` summed over the plans ``stream``'s updates
    take (the engine's cached plans)."""
    out: dict = {}
    for rel, upd in stream:
        p = eng.trigger_plan(rel, upd)
        for k, n in plan_launches(p, eng).items():
            out[k] = out.get(k, 0) + n
    return out


def check_launches(label, kernels, want: dict) -> dict:
    """The counts since the last reset, by kernel; raises unless they are
    ``want``'s (every kernel ``want`` does not name launched 0 times)."""
    launches = {k.name: k.launches for k in kernels}
    got = {k: n for k, n in launches.items() if n and ":" not in k}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the plans say {want}")
    return launches


def state_tensors(eng) -> dict:
    """Every state leaf of an engine, by a name of its own."""
    from repro_torch.core import plan as P

    out = {}
    for part, entries in zip(("views", "base", "indicators"), eng.state):
        for name in sorted(entries):
            for i, t in enumerate(P.relation_leaves(entries[name])):
                out[f"{part}/{name}/{i}"] = t
    return out


def compare_states(label, a, b) -> dict:
    """Raise unless two engines' states agree leaf by leaf: bitwise where
    a leaf's values are below 2**24 (integer sums, exact in any order),
    else within RTOL of its largest magnitude (``fused_chain`` and the ⊎
    kernels add a batch's rows into a key with atomics, in no fixed
    order).  Returns the leaves of each kind and the largest error."""
    import torch

    ta, tb = state_tensors(a), state_tensors(b)
    if set(ta) != set(tb):
        raise AssertionError(f"{label}: state entries differ")
    out = {"bitwise_leaves": 0, "tolerance_leaves": 0, "max_rel_err": 0.0}
    for k in ta:
        x, y = ta[k], tb[k]
        scale = float(x.abs().max()) if x.numel() else 0.0
        if scale < EXACT_LIMIT:
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: {k} differs from the eager engine")
            out["bitwise_leaves"] += 1
        else:
            err = float((x.double() - y.double()).abs().max()) / scale
            if err > RTOL:
                raise AssertionError(f"{label}: {k} differs from the eager engine "
                                     f"by {err} of its magnitude")
            out["tolerance_leaves"] += 1
            out["max_rel_err"] = max(out["max_rel_err"], err)
    return out


def check_indicators(label, eng, base_rel) -> dict:
    """Each indicator's counts and plane against a recount from the
    final base relation: bitwise."""
    import torch

    ring = eng.query.ring
    out = {}
    for name, ind in eng.indicators.items():
        nz = ~ring.is_zero(base_rel[ind.rel_name].payload)
        if ind.proj != base_rel[ind.rel_name].schema:
            raise AssertionError(f"{label}: ∃{name} projects {ind.proj}")
        if not torch.equal(ind.counts, nz.to(torch.int32)):
            raise AssertionError(f"{label}: ∃{name} counts differ from a recount")
        want = ring.ones(tuple(nz.shape), device="cuda")
        for c, t in ind.dense.payload.items():
            w = torch.where(nz.reshape(tuple(nz.shape) + (1,) * (t.dim() - 2)),
                            want[c], torch.zeros_like(want[c]))
            if not torch.equal(t, w):
                raise AssertionError(f"{label}: ∃{name}.{c} differs from a recount")
        out[name] = dict(keys=int(nz.sum()), rel=ind.rel_name, proj=list(ind.proj))
    return out


def triangle_phase(kernels, laps) -> list:
    """Paper Fig. 11 at real state: R(A,B), S(B,C), T(C,A) at n = 4,096 a
    variable (density 3/n, about 12,300 tuples a relation), the degree-3
    cofactor ring (d = 13), var order chain(A, B, C), ``fuse_chains=False``,
    ``auto`` storage, fusion ``auto``; 20 batches of 1000 distinct keys
    round-robin over R, S, T.  Three engines, the bench's rows: ``fivm``
    with indicators, ``fivm`` without, ``dbt`` with indicators, each built,
    run eagerly (launches against the plans'), held to the float64 oracle
    (every view), its indicators to a recount from the final base, and
    profiled; the three roots against each other.  Then the ``fivm``-with-
    indicators stream through the stream executor (:func:`triangle_executor`)."""
    import torch
    from repro_torch.core import IVMEngine
    from repro_torch.core.apps import regression
    from repro_torch.core.storage import as_dense
    from repro_torch.data import synth

    n = TRIANGLE_N
    doms = dict(A=n, B=n, C=n)
    rels = synth.TRIANGLE_RELATIONS
    q = regression.cofactor_query(rels, doms)
    q64 = regression.cofactor_query(rels, doms, dtype=torch.float64)
    db = synth.synth_db(rels, doms, q.ring, np.random.default_rng(SEED),
                        density=3.0 / n, device="cuda")
    stream = synth.distinct_key_stream(rels, doms, q.ring,
                                       np.random.default_rng(SEED + 1),
                                       [BATCH] * TRIANGLE_BATCHES, device="cuda")
    tuples = {r: int((rel.payload["c"] != 0).sum()) for r, rel in db.items()}

    def build(kw):
        eng = IVMEngine.build(q, db, var_order=synth.triangle_vo(),
                              fuse_chains=False, device="cuda", **kw)
        eng.precompile(BATCH)
        return eng

    out, roots, eager_twin = [], {}, None
    for label, kw in TRIANGLE_ENGINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = build(kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        storage_plan = {k: [s.kind, s.capacity] for k, s in sorted(eng.storage_plan.items())}
        view_bytes, dense_b = eng.memory_bytes(), dense_bytes(eng)
        want = stream_launches(eng, stream)
        reset(kernels)
        t0 = time.perf_counter()
        for rel, upd in stream:
            eng.apply_update(rel, upd)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_peak = torch.cuda.max_memory_allocated()
        launches = check_launches(f"triangle {label}", kernels, want)
        oracle = oracle_store(eng, db, stream, q64, 1)
        check = compare_views(f"triangle {label}", eng, oracle)
        del oracle
        inds = check_indicators(f"triangle {label}", eng, eng.base)
        roots[label] = {c: t.double().reshape(-1) for c, t in eng.result().payload.items()}
        plans = {rel: eng.plans.lookup_sig(eng, rel, ("coo", rels[rel], BATCH)).pretty()
                 for rel in rels}
        row = dict(
            stream=f"triangle_{label}", n=n, batch=BATCH, n_batches=TRIANGLE_BATCHES,
            tuples=tuples, build_kw={k: v for k, v in kw.items()},
            views=sorted(eng.materialized_names), indicators=inds,
            storage_plan=storage_plan, capacities=capacities(eng),
            view_bytes=view_bytes, view_bytes_dense=dense_b,
            build_s=build_s, build_peak_bytes=build_peak,
            run_s=run_s, tuples_per_s=BATCH * TRIANGLE_BATCHES / run_s,
            max_memory_allocated_run=run_peak,
            launches={k: v for k, v in launches.items() if v},
            launches_per_batch={k: v / TRIANGLE_BATCHES for k, v in launches.items() if v},
            plan_texts=plans, oracle=check)
        if label == "fivm_indicators":
            eager_twin = eng  # the executor leg continues it
        else:
            del eng
        torch.cuda.empty_cache()
        prof = build(kw)
        updates = iter(stream)
        events, wall = device_events(lambda: prof.apply_update(*next(updates)),
                                     len(stream))
        row["profile"] = _busy(events, wall)
        row["profile"]["device_events_per_batch"] = (row["profile"]["device_events"]
                                                     / TRIANGLE_BATCHES)
        del prof
        torch.cuda.empty_cache()
        log(row)
        out.append(row)
        laps.lap(f"triangle {label}")
    # the three engines compute one query: their roots agree (bitwise below
    # 2**24, else within RTOL of the largest magnitude)
    first = roots["fivm_indicators"]
    for label, r in roots.items():
        for c, t in r.items():
            scale = float(first[c].abs().max())
            err = float((t - first[c]).abs().max())
            if (scale < EXACT_LIMIT and err) or (scale >= EXACT_LIMIT
                                                 and err > RTOL * scale):
                raise AssertionError(f"triangle roots: {label}.{c} differs from "
                                     f"fivm_indicators by {err} (scale {scale})")
    out.append(triangle_executor(kernels, q, q64, db, stream, eager_twin,
                                 build, dict(TRIANGLE_ENGINES)["fivm_indicators"]))
    laps.lap("triangle executor")
    del eager_twin, db
    torch.cuda.empty_cache()
    return out


def triangle_executor(kernels, q, q64, db, stream, eager, build, kw) -> dict:
    """The ``fivm``-with-indicators stream through the stream executor on a
    fresh engine (rounds mode: a round is R, S, T, each round one CUDA
    graph, its IndicatorBump included): a capture run of the stream, a
    replay-only run (``donate_input=True``, 0 eager steps) under
    ``set_sync_debug_mode("error")`` of a second stream of the same
    signature whose batches have 999 or 1000 rows, so that padded rows
    pass through the indicator sections, then a profiled replay-only run
    of the first stream again.  After each run every state leaf (views,
    base, indicator counts and planes) equals the eager engine's after the
    same updates (:func:`compare_states`: bitwise below 2**24, the root's
    larger sums within RTOL; the eager engine takes the second stream
    padded as the executor buckets it, so that every sum has the same
    rows), and the launches equal the plans'.
    The padded rows are held to be no-ops by the indicators' recount from
    the final base (bitwise) and the views' float64 oracle over the
    unpadded streams."""
    import torch
    from repro_torch.core import StreamExecutor, prepare_stream
    from repro_torch.data import synth

    rels = synth.TRIANGLE_RELATIONS
    doms = {v: TRIANGLE_N for v in "ABC"}
    sizes = [BATCH - (i // 3) % 2 for i in range(TRIANGLE_BATCHES)]
    second = synth.distinct_key_stream(rels, doms, q.ring,
                                       np.random.default_rng(SEED + 3), sizes,
                                       device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = build(kw)
    ex = StreamExecutor(eng)
    prepared, prepared2 = prepare_stream(eng, stream), prepare_stream(eng, second)
    if prepared2.signature != prepared.signature or prepared.mode != "rounds":
        raise AssertionError("triangle executor: the second stream's signature differs")
    padded = sum(BATCH - s for s in sizes)
    plans = prepared.plans
    if not any(p.ind_ops for p in plans):
        raise AssertionError("triangle executor: no IndicatorBump in the round")
    want: dict = {}
    for p in plans:
        for k, v in plan_launches(p, eng).items():
            want[k] = want.get(k, 0) + v * prepared.n_steps
    for p in plans[:prepared.tail_len]:
        for k, v in plan_launches(p, eng).items():
            want[k] = want.get(k, 0) + v
    runs = {}
    # (run, prepared stream, the updates the eager engine takes after it:
    # none after the capture run, whose stream it ran in its own leg)
    for run, prep, extra in (("capture", prepared, []),
                             ("replay_padded", prepared2, second),
                             ("replay_profiled", prepared, stream)):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "capture":
            ex.run(prep)
        elif run == "replay_padded":
            torch.cuda.set_sync_debug_mode("error")
            try:
                ex.run(prep, donate_input=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            events, _ = device_events(lambda: ex.run(prep, donate_input=True), 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = dict(ex.last_run_stats)
        if not stats["replays"] or (run != "capture" and stats["eager_steps"]):
            raise AssertionError(f"triangle executor {run}: stats {stats}")
        launches = check_launches(f"triangle executor {run}", kernels, want)
        for rel, upd in extra:
            eager.apply_update(rel, upd.pad_to(q.ring, BATCH))
        torch.cuda.synchronize()
        leaves = compare_states(f"triangle executor {run}", eager, eng)
        runs[run] = dict(run_s=wall, tuples_per_s=sum(
                             int(u.batch) for _, u in (extra or stream)) / wall,
                         host_us_per_replay=1e6 * stats["replay_host_s"] / stats["replays"],
                         against_eager=leaves,
                         launches={k: v for k, v in launches.items() if v}, **stats)
        if run == "replay_profiled":
            runs[run]["profile"] = _busy(events, wall)
            runs[run]["profile"]["device_events_per_batch"] = (
                runs[run]["profile"]["device_events"] / TRIANGLE_BATCHES)
    peak = dict(max_memory_allocated=torch.cuda.max_memory_allocated(),
                max_memory_reserved=torch.cuda.max_memory_reserved())
    check = compare_views("triangle executor", eng,
                          oracle_store(eng, db, stream + second + stream, q64, 1))
    inds = check_indicators("triangle executor", eng, eng.base)
    ex.release()
    del eng, ex, prepared, prepared2, second
    torch.cuda.empty_cache()
    row = dict(stream="triangle_fivm_indicators_executor", mode="rounds",
               rounds=TRIANGLE_BATCHES // 3, tail=TRIANGLE_BATCHES % 3,
               padded_rows=padded, indicators=inds, oracle=check, **peak, **runs)
    log(row)
    return row


#: the conjunctive leg (paper Fig. 13, ``benchmarks/bench_factorized_payloads.py``):
#: House(pc,h1), Shop(pc,s1), Rest(pc,r1), 0/1 multiplicities at density
#: 0.5, attr 6; the factorized engine on the card at the housing star's
#: postcode count, the enumeration check at the bench's largest scale
CQ_RELATIONS = {"House": ("pc", "h1"), "Shop": ("pc", "s1"), "Rest": ("pc", "r1")}
CQ_ATTR, CQ_DENSITY = 6, 0.5
CQ_PC, CQ_PC_LISTING = 65_536, 32
CQ_FREE = ("pc", "h1", "s1", "r1")


def cq_vo():
    from repro_torch.core import chain

    return chain(["pc"], {"pc": [["h1"], ["s1"], ["r1"]]})


def cq_data(pc: int, rng) -> tuple[dict, dict]:
    doms = dict(pc=pc, h1=CQ_ATTR, s1=CQ_ATTR, r1=CQ_ATTR)
    return doms, {name: (rng.random(tuple(doms[v] for v in sch)) < CQ_DENSITY
                         ).astype(np.int64) for name, sch in CQ_RELATIONS.items()}


def cq_updates(data: dict, rng, batch: int, n_batches: int) -> list:
    """Round-robin batches of distinct keys, each +1 where the key is
    absent and -1 where it is present (multiplicities stay 0/1); ``data``
    follows them.  ``[(rel, keys [B, 2] int32, vals [B] float32), ...]``."""
    out = []
    for i in range(n_batches):
        rel = list(CQ_RELATIONS)[i % 3]
        shape = data[rel].shape
        flat = rng.choice(int(np.prod(shape)), size=batch, replace=False)
        keys = np.stack(np.unravel_index(flat, shape), axis=1).astype(np.int32)
        vals = np.where(data[rel][tuple(keys.T)] == 0, 1.0, -1.0).astype(np.float32)
        data[rel][tuple(keys.T)] += vals.astype(np.int64)
        out.append((rel, keys, vals))
    return out


def cq_recount(eng, data) -> dict:
    """Every view of the factorized engine over ``data`` in float64
    numpy, by name: W:V@x = the relation; V@x = its row sums; W:V@pc = the
    product of the three; the root = its sum."""
    tree = eng.tree
    want = {}
    sums = []
    for child in tree.children:
        rel = child.children[0].relation
        m = data[rel].astype(np.float64)
        want[f"W:{child.name}"] = m
        want[child.name] = m.sum(axis=1)
        want[rel] = m
        sums.append(m.sum(axis=1))
    want[f"W:{tree.name}"] = sums[0] * sums[1] * sums[2]
    want[tree.name] = np.asarray(want[f"W:{tree.name}"].sum())
    return want


def conjunctive_phase(kernels, laps) -> list:
    """Paper Fig. 13 on the card.  (1) ``conjunctive.make_factorized_engine``
    at pc = 65,536 (the housing star's postcode count), 20 batches of 1000
    distinct-key ±1 updates through ``apply_update``: launches against the
    plans', every ``W:`` view and the root against a float64 numpy recount
    (bitwise: integer counts far below 2**24).  (2) At pc = 32, the bench's
    largest scale: the same engine on the card and the host ``PyIVM``
    listing engine under the same 60 single-tuple updates; the enumeration
    of the card engine's ``W:`` payloads must equal the listing and a
    brute-force oracle after every 20."""
    import torch
    from repro_torch.core import COOUpdate, PyRelation
    from repro_torch.core.apps import conjunctive
    from repro_torch.core.rings import PyRelationalRing
    from repro_torch.core.storage import as_dense

    rng = np.random.default_rng(SEED)
    doms, data = cq_data(CQ_PC, rng)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, q = conjunctive.make_factorized_engine(CQ_RELATIONS, data, cq_vo(), doms,
                                                device="cuda")
    eng.precompile(BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    updates = cq_updates(data, rng, BATCH, N_BATCHES)
    stream = [(rel, COOUpdate(CQ_RELATIONS[rel], torch.as_tensor(k, device="cuda"),
                              {"v": torch.as_tensor(v, device="cuda")}))
              for rel, k, v in updates]
    want_launches = stream_launches(eng, stream)
    reset(kernels)
    t0 = time.perf_counter()
    for rel, upd in stream:
        eng.apply_update(rel, upd)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = check_launches("conjunctive", kernels, want_launches)
    want = cq_recount(eng, data)
    w_views = sorted(n for n in eng.views if n.startswith("W:"))
    if len(w_views) != 4 or not set(eng.views) <= set(want):
        raise AssertionError(f"conjunctive: views {sorted(eng.views)}")
    for name, v in eng.views.items():
        got = as_dense(v).payload["v"].double().cpu().numpy()
        if got.shape != np.shape(want[name]) or not np.array_equal(got, want[name]):
            raise AssertionError(f"conjunctive: {name} differs from the recount")
    row = dict(stream="conjunctive_factorized", pc=CQ_PC, attr=CQ_ATTR,
               batch=BATCH, n_batches=N_BATCHES, views=sorted(eng.views),
               w_views=w_views, view_bytes=eng.memory_bytes(),
               storage_plan={k: [s.kind, s.capacity]
                             for k, s in sorted(eng.storage_plan.items())},
               build_s=build_s, run_s=run_s,
               tuples_per_s=BATCH * N_BATCHES / run_s,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches={k: v for k, v in launches.items() if v},
               launches_per_batch={k: v / N_BATCHES for k, v in launches.items() if v},
               root=float(want[eng.tree.name]), recount="bitwise")
    del eng, stream
    torch.cuda.empty_cache()
    # profiled: a fresh engine over the same stream
    doms, data = cq_data(CQ_PC, np.random.default_rng(SEED))
    prof, _ = conjunctive.make_factorized_engine(CQ_RELATIONS, data, cq_vo(), doms,
                                                 device="cuda")
    prof.precompile(BATCH)
    stream = [(rel, COOUpdate(CQ_RELATIONS[rel], torch.as_tensor(k, device="cuda"),
                              {"v": torch.as_tensor(v, device="cuda")}))
              for rel, k, v in updates]
    it = iter(stream)
    events, wall = device_events(lambda: prof.apply_update(*next(it)), len(stream))
    row["profile"] = _busy(events, wall)
    row["profile"]["device_events_per_batch"] = row["profile"]["device_events"] / N_BATCHES
    del prof, stream
    torch.cuda.empty_cache()
    log(row)
    laps.lap("conjunctive factorized")

    # (2) enumeration against the listing and the oracle at the bench's scale
    rng = np.random.default_rng(SEED + 1)
    doms, data = cq_data(CQ_PC_LISTING, rng)
    eng, _ = conjunctive.make_factorized_engine(CQ_RELATIONS, data, cq_vo(), doms,
                                                device="cuda")
    ring = PyRelationalRing(tagged=True)
    db = {name: PyRelation(sch, ring, {tuple(int(x) for x in k): {(): 1}
                                       for k in np.argwhere(data[name] != 0)})
          for name, sch in CQ_RELATIONS.items()}
    t0 = time.perf_counter()
    listing, ltree = conjunctive.make_listing_engine(CQ_RELATIONS, CQ_FREE, db,
                                                     cq_vo(), doms)
    listing_build_s = time.perf_counter() - t0
    checks, fac_s, lst_s = [], 0.0, 0.0
    for block in range(3):
        for rel, keys, vals in cq_updates(data, rng, 1, 20):
            t0 = time.perf_counter()
            eng.apply_update(rel, COOUpdate(CQ_RELATIONS[rel],
                                            torch.as_tensor(keys, device="cuda"),
                                            {"v": torch.as_tensor(vals, device="cuda")}))
            torch.cuda.synchronize()
            fac_s += time.perf_counter() - t0
            d = PyRelation(CQ_RELATIONS[rel], ring)
            d.data[tuple(int(x) for x in keys[0])] = {(): int(vals[0])}
            t0 = time.perf_counter()
            listing.apply_update(rel, d)
            lst_s += time.perf_counter() - t0
        payloads = conjunctive.factorized_payloads_from_engine(eng)
        fac = conjunctive.enumerate_factorized(eng.tree, payloads, CQ_FREE)
        lst = conjunctive.listing_result(listing, CQ_FREE, ltree)
        oracle = {(p, h, s, r) for p in range(doms["pc"])
                  for h in np.flatnonzero(data["House"][p])
                  for s in np.flatnonzero(data["Shop"][p])
                  for r in np.flatnonzero(data["Rest"][p])}
        oracle = {tuple(int(x) for x in t) for t in oracle}
        if fac != oracle or set(lst) != oracle or any(m != 1 for m in lst.values()):
            raise AssertionError(f"conjunctive pc={CQ_PC_LISTING} after "
                                 f"{20 * (block + 1)} updates: factorized "
                                 f"{len(fac)}, listing {len(lst)}, oracle {len(oracle)}")
        checks.append(dict(updates=20 * (block + 1), tuples=len(oracle),
                           factorized_cells=conjunctive.factorized_cells(payloads),
                           listing_cells=conjunctive.listing_cells(lst, len(CQ_FREE))))
    row2 = dict(stream="conjunctive_enumeration", pc=CQ_PC_LISTING, attr=CQ_ATTR,
                updates=60, checks=checks, listing_build_s=listing_build_s,
                factorized_us_per_update=1e6 * fac_s / 60,
                listing_us_per_update=1e6 * lst_s / 60)
    del eng
    torch.cuda.empty_cache()
    log(row2)
    laps.lap("conjunctive enumeration")
    return [row, row2]


# ---------------------------------------------------------------------------
# The stream executor's durability and integrity planes
# ---------------------------------------------------------------------------
#: D1 and D2 cut a boundary every 5 updates (4 segments, 4 saves in D1)
DURABLE_SEGMENT_UPDATES = 5
#: the snapshots of the durable, integrity and supervisor phases (under the
#: gitignored build/; each phase removes its own)
SNAPSHOT_DIR = Path(__file__).resolve().parent / "build" / "snapshots"
#: D2's in-process faults: (point, crossing index); each fires once
D2_FAULTS = (("mid_admit", 2), ("post_rehash_pre_recompile", 1),
             ("mid_checkpoint_write", 2), ("mid_segment", 2))
#: I1, the reference's integrity leg (benchmarks/bench_stream.py:451-507):
#: housing pc = 65,536, 512 active postcodes, 12 batches of 512, boundaries
#: every 4 updates
I1_ACTIVE, I1_BATCH, I1_BATCHES, I1_SEGMENT = 512, 512, 12, 4
#: I1's poison, planted by the script: (batch, row, mutation)
I1_POISON = ((2, 5, "nan"), (2, 17, "nan"), (2, 301, "nan"), (5, 7, "inf"),
             (7, 11, "pc"), (7, 12, "negative_key"))
#: I1's batch with integer keys stored as float32: a whole-batch dtype error
I1_BAD_DTYPE = 9


def count_syncs(fn):
    """``(fn(), synchronising calls, their sites)`` under
    ``torch.cuda.set_sync_debug_mode("warn")``: a site is the innermost
    ``repro_torch`` frame of the call that synchronised (in whichever
    thread it ran)."""
    import traceback
    import warnings

    import torch

    sites: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # (set_sync_debug_mode's own notice also says "synchronizing")
        stack = traceback.extract_stack()
        site = next((f"{f.filename[f.filename.index('repro_torch'):]}:{f.lineno}"
                     for f in reversed(stack) if "repro_torch" in f.filename),
                    f"outside repro_torch: {stack[-2].filename}:{stack[-2].lineno}")
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(sites.values()), sites


def state_copy(eng) -> dict:
    """Every state leaf of an engine, cloned (:func:`state_tensors`)."""
    return {k: t.clone() for k, t in state_tensors(eng).items()}


def same_state(label, eng, want: dict) -> dict:
    """Raise unless every state leaf of ``eng`` (key tables, planes with
    their zombie slots, base relations) equals ``want``'s: bitwise for
    integer leaves and float leaves below 2**24 (integer sums, exact in any
    order), else within RTOL of the largest magnitude (the ⊎ kernels and
    ``fused_chain`` add a batch's rows with atomics, in no fixed order, as
    :func:`compare_states`).  Returns the leaves of each kind and the
    largest error."""
    import torch

    got = state_tensors(eng)
    if set(got) != set(want):
        raise AssertionError(f"{label}: state entries differ")
    out = {"bitwise_leaves": 0, "tolerance_leaves": 0, "max_rel_err": 0.0}
    for k, t in got.items():
        w = want[k]
        if t.shape != w.shape or t.dtype != w.dtype:
            raise AssertionError(f"{label}: {k} has another shape or dtype")
        scale = float(w.abs().max()) if w.numel() and w.is_floating_point() else 0.0
        if scale < EXACT_LIMIT:
            if not torch.equal(t, w):
                raise AssertionError(f"{label}: {k} differs from the uninterrupted run")
            out["bitwise_leaves"] += 1
        else:
            err = float((t.double() - w.double()).abs().max()) / scale
            if err > RTOL:
                raise AssertionError(f"{label}: {k} differs from the uninterrupted run "
                                     f"by {err} of its magnitude")
            out["tolerance_leaves"] += 1
            out["max_rel_err"] = max(out["max_rel_err"], err)
    return out


def add_launches(total: dict, launches: dict) -> None:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def timed_run(ex, stream, kernels) -> tuple[float, dict]:
    """(host seconds, launches) of ``ex.run(stream)``, ended by a
    synchronise, the counts reset before."""
    import torch

    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.run(stream)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {k.name: k.launches for k in kernels}


def eager_launches(build, stream, kernels) -> dict:
    """The launches, by kernel, of ``stream`` through a fresh engine's
    eager ``apply_update``: what the executor's runs must launch (each
    update's plan once, replays counted)."""
    import torch

    eng = build()
    reset(kernels)
    for rel, upd in stream:
        eng.apply_update(rel, upd)
    torch.cuda.synchronize()
    out = {k.name: k.launches for k in kernels if k.launches and ":" not in k.name}
    del eng
    return out


def run_until_fault(ex, stream, point: str, at: int, mode: str = "raise"):
    """Run ``stream`` with a fault armed at the ``at``-th crossing of
    ``point`` (``mode="bitflip"`` corrupts and runs on); raises unless it
    fired.  Returns where it fired."""
    from repro_torch.runtime import faults

    with faults.inject(point, at=at, mode=mode) as inj:
        try:
            ex.run(stream)
        except faults.InjectedFault:
            pass
    if not inj.fired:
        raise AssertionError(f"the fault at {point}[{at}] never fired")
    return [inj.fired[0][0], inj.fired[0][1]]


def retailer_case(ring: str):
    """The retailer snowflake at ``RETAILER_DOMS_BIG`` with the stream
    phase's database and 20 × 1000 stream (seed 0): (query, float64 query,
    db, stream, build)."""
    import torch
    from repro_torch.core import IVMEngine, Query, sum_ring
    from repro_torch.core.apps import regression
    from repro_torch.data import synth

    doms, rels = synth.RETAILER_DOMS_BIG, synth.RETAILER_RELATIONS
    if ring == "sum":
        q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
                  lifts={"units": ("value",)})
        q64 = Query(relations=rels, free_vars=(), ring=sum_ring(torch.float64),
                    domains=doms, lifts={"units": ("value",)})
    else:
        q = regression.cofactor_query(rels, doms)
        q64 = regression.cofactor_query(rels, doms, dtype=torch.float64)
    rng = np.random.default_rng(SEED)
    db = synth.synth_db(rels, doms, q.ring, rng, device="cuda")
    stream = synth.update_stream(rels, doms, q.ring, rng, BATCH, N_BATCHES, device="cuda")

    def build(**kw):
        eng = IVMEngine.build(q, db, var_order=synth.retailer_vo(), strategy="fivm",
                              device="cuda", **kw)
        eng.precompile(BATCH)
        if any(s.kind != "dense" for s in eng.storage_plan.values()):
            raise AssertionError("auto storage made a retailer view sparse")
        return eng

    return q, q64, db, stream, build


def housing_growth_case():
    """S2's configuration: the housing star at pc = 65,536, sum ring,
    ``auto`` storage, 512 active postcodes, 20 × 1000 from 4,096 postcodes
    (the tables grow through capacity segments): (query, float64 query,
    db, stream, build)."""
    import torch
    from repro_torch.core import IVMEngine
    from repro_torch.data.synth import (HOUSING_DOMS_BIG, HOUSING_RELATIONS, housing_vo,
                                        synth_low_fill_db)

    q = housing_query("sum", HOUSING_DOMS_BIG)
    q64 = housing_query("sum", HOUSING_DOMS_BIG, torch.float64)
    db, active = synth_low_fill_db(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                                   np.random.default_rng(SEED), "pc", 512, device="cuda")
    inactive = np.setdiff1d(np.arange(HOUSING_DOMS_BIG["pc"]), active)
    pool = np.sort(np.concatenate([active, np.random.default_rng(SEED + 2).choice(
        inactive, size=4096 - 512, replace=False)]))
    stream = housing_stream(q, pool, BATCH, N_BATCHES, SEED + 1)

    def build(**kw):
        eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                              device="cuda", **kw)
        eng.precompile(BATCH)
        return eng

    return q, q64, db, stream, build


def durable_retailer(kernels) -> dict:
    """D1: the retailer sum stream (fusion ``auto``, dense views) through
    the executor with a ``StreamCheckpointer(keep=3, segment_updates=5)``
    (4 segments, 4 saves) and without (an ``IntegrityConfig(policy=
    "permissive", segment_updates=5)``: the same 4 segments), after a
    warm-up run timed in turns off, on, on, off on fresh engines; each
    run's launches equal to the eager engine's, which equal its plans'
    (``stream_launches``).  Then the synchronising
    calls of a run with and without snapshots and of a non-final boundary
    save alone, a restore into a fresh engine, and a ``mid_segment`` fault
    at the third boundary followed by ``resume`` on a fresh engine and
    executor: every state leaf equal to the uninterrupted run's
    (:func:`same_state`), the views to the float64 oracle."""
    import shutil

    import torch
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor, plan
    from repro_torch.runtime.integrity import IntegrityConfig

    label = "D1_durable_retailer_sum"
    root = SNAPSHOT_DIR / "durable_retailer"
    shutil.rmtree(root, ignore_errors=True)
    q, q64, db, stream, build = retailer_case("sum")
    total: dict = {}

    def executor(mode, tag):
        eng = build()
        if mode == "on":
            ck = StreamCheckpointer(str(root / tag), keep=3,
                                    segment_updates=DURABLE_SEGMENT_UPDATES)
            return eng, StreamExecutor(eng, checkpoint=ck), ck
        cfg = IntegrityConfig(policy="permissive", segment_updates=DURABLE_SEGMENT_UPDATES)
        return eng, StreamExecutor(eng, integrity=cfg), None

    with plan.use_fusion("auto"):
        runs: dict = {"off": [], "on": []}
        final = None
        eager = eager_launches(build, stream, kernels)
        plans_want = stream_launches(build(), stream)
        if eager != plans_want:
            raise AssertionError(f"{label}: the eager engine launched {eager}, the "
                                 f"plans say {plans_want}")
        eng, ex, _ = executor("off", "warm")  # first captures, kernel loads
        ex.run(stream)
        ex.release()
        del eng, ex
        for i, mode in enumerate(("off", "on", "on", "off")):
            eng, ex, ck = executor(mode, f"run{i}")
            wall, launches = timed_run(ex, stream, kernels)
            check_launches(f"{label} {mode}", kernels, eager)
            plans = stream_launches(eng, stream)
            add_launches(total, launches)
            segs = ex.last_segment_stats
            entry = dict(run_s=wall, tuples_per_s=BATCH * N_BATCHES / wall,
                         segments=len(segs),
                         replays=sum(s["run"].get("replays", 0) for s in segs),
                         eager_steps=sum(s["run"].get("eager_steps", 0) for s in segs))
            if len(segs) != 4:
                raise AssertionError(f"{label} {mode}: {len(segs)} segments, not 4")
            if ck is not None:
                if ck.saves_committed != 4 or ck.ckpt.all_steps() != [10, 15, 20]:
                    raise AssertionError(f"{label}: saves {ck.saves_committed}, "
                                         f"steps {ck.ckpt.all_steps()}")
                entry.update(save_dispatch_s=[s["save_dispatch_s"] for s in segs],
                             save_s=[s["save_s"] for s in segs],
                             writer_s=[w["seconds"] for w in ck.ckpt.writes],
                             snapshot_bytes=ck.ckpt.writes[-1]["bytes"])
                final = (eng, ck)
            runs[mode].append(entry)
            ex.release()
        eng_u, ck_u = final
        want = state_copy(eng_u)
        oracle = compare_views(label, eng_u, oracle_store(eng_u, db, stream, q64, 1))
        # synchronising calls: a run with snapshots against one without, and
        # a non-final boundary save alone (after a warm-up save)
        syncs = {}
        for mode in ("off", "on"):
            eng, ex, ck = executor(mode, f"syncs_{mode}")
            _, n, sites = count_syncs(lambda: ex.run(stream))
            syncs[f"run_{mode}"] = dict(syncs=n, sites=sites)
            ex.release()
        probe = StreamCheckpointer(str(root / "probe"))
        probe.save_boundary(eng_u, offset=1, segment=0)
        probe.wait()
        _, syncs["boundary_save"], _ = count_syncs(
            lambda: probe.save_boundary(eng_u, offset=2, segment=1))
        probe.wait()
        in_checkpoint = [site for site in syncs["run_on"]["sites"]
                         if "repro_torch/checkpoint" in site]
        if syncs["boundary_save"] or in_checkpoint:
            raise AssertionError(f"{label}: a boundary save synchronised: {syncs}")
        # restore into a fresh engine
        eng_r = build()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = StreamCheckpointer(str(root / "run2"), keep=3).restore_into(eng_r)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if meta["offset"] != 20:
            raise AssertionError(f"{label}: restored offset {meta['offset']}")
        same_state(f"{label} restore", eng_r, want)
        del eng_r
        # a fault at the third boundary, then resume on a fresh engine
        eng_f, ex_f, ck_f = executor("on", "fault")
        reset(kernels)
        fired = run_until_fault(ex_f, stream, "mid_segment", 2)
        add_launches(total, {k.name: k.launches for k in kernels})
        ck_f.ckpt.discard_pending()  # a boundary save may still be in flight
        committed = ck_f.ckpt.all_steps()
        ex_f.release()
        del eng_f, ex_f, ck_f
        eng_2, ex_2, ck_2 = executor("on", "fault")
        reset(kernels)
        t0 = time.perf_counter()
        ex_2.resume(stream)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        replayed = sum(s["updates"] for s in ex_2.last_segment_stats)
        check_launches(f"{label} resume", kernels,
                       eager_launches(build, stream[-replayed:], kernels))
        add_launches(total, {k.name: k.launches for k in kernels})
        leaves = same_state(f"{label} resume", eng_2, want)
        resumed_oracle = compare_views(label + "_resumed", eng_2,
                                       oracle_store(eng_2, db, stream, q64, 1))
        ex_2.release()
    off = statistics.median(r["tuples_per_s"] for r in runs["off"])
    on = statistics.median(r["tuples_per_s"] for r in runs["on"])
    out = dict(
        leg=label, fusion="auto", batch=BATCH, n_batches=N_BATCHES,
        segment_updates=DURABLE_SEGMENT_UPDATES, runs=runs,
        tuples_per_s_off=off, tuples_per_s_on=on, on_over_off=on / off,
        save_dispatch_s=[r["save_dispatch_s"] for r in runs["on"]],
        writer_s_per_save=[r["writer_s"] for r in runs["on"]],
        snapshot_bytes=runs["on"][0]["snapshot_bytes"], restore_s=restore_s,
        syncs=syncs, oracle=oracle,
        fault=dict(fired=fired, committed=committed, replayed_updates=replayed,
                   resume_s=resume_s, leaves=leaves, oracle=resumed_oracle),
        launches_eager=eager, launches_plans=plans, launches=total)
    shutil.rmtree(root, ignore_errors=True)
    return out, want


def durable_child(directory: str) -> int:
    """D2's kill -9 leg, run as a child process of its own: the
    checkpointed housing stream, killed by ``SIGKILL`` at the fifth
    ``mid_segment`` crossing (no ``atexit``, no ``finally``)."""
    import torch
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor, plan
    from repro_torch.runtime import faults

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    with plan.use_fusion("auto"):
        _, _, _, stream, build = housing_growth_case()
        ex = StreamExecutor(build(), checkpoint=StreamCheckpointer(
            directory, segment_updates=DURABLE_SEGMENT_UPDATES))
        faults.install(faults.FaultPlan("mid_segment", at=4, mode="kill9"))
        ex.run(stream)
    print("chip_smoke: the kill -9 fault never fired")
    return 3


def durable_housing(kernels) -> dict:
    """D2: S2's growing housing stream with boundaries every 5 updates.
    The uninterrupted checkpointed run against the same segments without
    snapshots (launches equal, every leaf equal).  Then, each on a run
    of its own, the in-process faults of ``D2_FAULTS``, a bit flip in the
    newest snapshot (``snapshot_committed``) and a child process killed
    by ``SIGKILL`` mid-segment: after each, ``resume`` on a fresh engine,
    every leaf (key tables and zombie slots included) equal to the
    uninterrupted run's (:func:`same_state`), capacities and
    ``occupancy_report`` equal."""
    import os
    import shutil

    import torch
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor, plan
    from repro_torch.core.storage import occupancy_report
    from repro_torch.runtime.integrity import IntegrityConfig

    label = "D2_durable_housing_growth"
    root = SNAPSHOT_DIR / "durable_housing"
    shutil.rmtree(root, ignore_errors=True)
    q, q64, db, stream, build = housing_growth_case()
    total: dict = {}

    def checkpointed(tag):
        eng = build()
        ck = StreamCheckpointer(str(root / tag), segment_updates=DURABLE_SEGMENT_UPDATES)
        return eng, StreamExecutor(eng, checkpoint=ck), ck

    def resumed(tag, what):
        """Resume ``tag``'s directory on a fresh engine; compare."""
        eng, ex, ck = checkpointed(tag)
        reset(kernels)
        t0 = time.perf_counter()
        ex.resume(stream)
        torch.cuda.synchronize()
        out = dict(resume_s=time.perf_counter() - t0,
                   replayed_updates=sum(s["updates"] for s in ex.last_segment_stats),
                   quarantined=list(ck.ckpt.quarantined),
                   leaves=same_state(f"{label} {what}", eng, want))
        add_launches(total, {k.name: k.launches for k in kernels})
        if capacities(eng) != caps or occupancy_report(eng.views) != occupancy:
            raise AssertionError(f"{label} {what}: capacities or occupancy differ: "
                                 f"{capacities(eng)} {occupancy_report(eng.views)}")
        ex.release()
        return out

    with plan.use_fusion("auto"):
        eng = build()
        caps_before = capacities(eng)
        ex = StreamExecutor(eng, integrity=IntegrityConfig(
            policy="permissive", segment_updates=DURABLE_SEGMENT_UPDATES))
        off_s, off_launches = timed_run(ex, stream, kernels)
        off_state = state_copy(eng)
        ex.release()
        del eng, ex
        eng_u, ex_u, ck_u = checkpointed("uninterrupted")
        on_s, launches = timed_run(ex_u, stream, kernels)
        add_launches(total, off_launches)
        add_launches(total, launches)
        if launches != off_launches or not launches["hash_insert"] or not launches[
                "hash_probe"]:
            raise AssertionError(f"{label}: launches {launches} against "
                                 f"{off_launches} without snapshots")
        same_state(f"{label} checkpoint on vs off", eng_u, off_state)
        del off_state
        want = state_copy(eng_u)
        caps, occupancy = capacities(eng_u), occupancy_report(eng_u.views)
        if not all(caps[n] > caps_before[n] for n in caps_before):
            raise AssertionError(f"{label}: no growth: {caps_before} -> {caps}")
        segs = ex_u.last_segment_stats
        n_saves = ck_u.saves_committed
        oracle = compare_views(label, eng_u, oracle_store(eng_u, db, stream, q64, 1))
        ex_u.release()
        del eng_u, ex_u
        faults_out = {}
        for point, at in D2_FAULTS:
            eng, ex, ck = checkpointed(point)
            fired = run_until_fault(ex, stream, point, at)
            ck.ckpt.discard_pending()  # a boundary save may still be in flight
            ex.release()
            del eng, ex
            torn = sorted(n for n in os.listdir(root / point) if n.endswith(".tmp"))
            faults_out[point] = dict(at=at, fired=fired, committed=ck.ckpt.all_steps(),
                                     tmp_left=torn, **resumed(point, point))
        # a bit flip in the newest committed snapshot: resume falls back
        eng, ex, ck = checkpointed("bitflip")
        run_until_fault(ex, stream, "snapshot_committed", n_saves - 1, mode="bitflip")
        flipped = ck.ckpt.all_steps()[-1]
        ex.release()
        del eng, ex
        bitflip = dict(flipped_step=flipped, **resumed("bitflip", "bitflip"))
        if bitflip["quarantined"] != [flipped]:
            raise AssertionError(f"{label}: bit flip not quarantined: {bitflip}")
        # kill -9 of a child process mid-segment
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--durable-child", str(root / "kill9")],
                              capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if proc.returncode != -9:
            raise AssertionError(f"{label}: the child exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
        names = os.listdir(root / "kill9")
        committed = sorted(n for n in names if n.startswith("step_")
                           and not n.endswith(".tmp"))
        if not committed or not all((root / "kill9" / n / "manifest.json").exists()
                                    for n in committed):
            raise AssertionError(f"{label}: torn committed step after kill -9: {names}")
        kill9 = dict(returncode=proc.returncode, child_s=child_s,
                     committed=[int(n[5:]) for n in committed],
                     tmp_left=sorted(n for n in names if n.endswith(".tmp")),
                     **resumed("kill9", "kill -9"))
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        leg=label, batch=BATCH, n_batches=N_BATCHES,
        segment_updates=DURABLE_SEGMENT_UPDATES, segments=len(segs), saves=n_saves,
        grown_at=[[s["segment"], s["grow"]] for s in segs if s["grow"]],
        capacities_before=caps_before, capacities_after=caps,
        run_s_off=off_s, run_s_on=on_s,
        tuples_per_s_off=BATCH * N_BATCHES / off_s, tuples_per_s_on=BATCH * N_BATCHES / on_s,
        save_dispatch_s=[s["save_dispatch_s"] for s in segs],
        writer_s=[w["seconds"] for w in ck_u.ckpt.writes],
        snapshot_bytes=[w["bytes"] for w in ck_u.ckpt.writes],
        oracle=oracle, faults=faults_out, bitflip=bitflip, kill9=kill9,
        launches=total)


def poison(stream) -> tuple[list, list, list]:
    """I1's poisoned copy of ``stream`` (``I1_POISON`` and the dtype batch
    ``I1_BAD_DTYPE``), the clean stream with exactly those rows masked (key
    0, payload 0; the dtype batch all padding), and the dead letters they
    must give: (rel, stream index, row, key, reasons)."""
    import torch
    from repro_torch.core import COOUpdate

    bad, masked, letters = [], [], []
    for j, (rel, upd) in enumerate(stream):
        keys, vals = upd.keys.clone(), upd.payload["v"].clone()
        mkeys, mvals = upd.keys.clone(), upd.payload["v"].clone()
        pc = upd.schema.index("pc")
        for at, row, how in I1_POISON:
            if at != j:
                continue
            if how == "nan":
                vals[row] = float("nan")
            elif how == "inf":
                vals[row] = float("inf")
            elif how == "pc":
                keys[row, pc] = 65_536
            else:
                keys[row, 1 if pc == 0 else 0] = -1
            mkeys[row], mvals[row] = 0, 0
            reason = "nonfinite_payload" if how in ("nan", "inf") else "key_out_of_domain"
            letters.append((rel, j, row, tuple(keys[row].tolist()), (reason,)))
        if j == I1_BAD_DTYPE:
            bad.append((rel, COOUpdate(upd.schema, keys.to(torch.float32), {"v": vals})))
            masked.append((rel, COOUpdate(upd.schema, torch.zeros_like(keys),
                                          {"v": torch.zeros_like(vals)})))
            letters.append((rel, j, -1, (), ("dtype_mismatch",)))
            continue
        bad.append((rel, COOUpdate(upd.schema, keys, {"v": vals})))
        masked.append((rel, COOUpdate(upd.schema, mkeys, {"v": mvals})))
    return bad, masked, sorted(letters, key=lambda r: (r[1], r[2]))


def integrity_housing(kernels) -> dict:
    """I1: the reference's integrity leg on the card.  The ``off``
    (``permissive``), ``validate`` (``quarantine``) and ``audit``
    (``quarantine``, ``audit_interval=2``, ``store_base=True``) executors,
    every ``segment_updates=4``, each on a fresh engine, run once to warm
    and twice timed in turns (the faster kept), launches of ``validate``
    equal to ``off``'s and ``off``'s to the plans of its segments
    (``segment_launches``: the rehashes between segments included).  Then a poisoned copy of the stream (``poison``):
    under ``quarantine`` every leaf equal to the masked clean stream's and
    its launches too (the masked stream's held to its plans), the dead
    letters exactly the planted ones, its validated admission 0
    synchronising calls before the final flush; under ``strict`` with a
    checkpoint, ``StreamIntegrityError`` names update 2 and no step is
    committed past the segment before it."""
    import shutil

    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor, plan
    from repro_torch.data.synth import (HOUSING_DOMS_BIG, HOUSING_RELATIONS, housing_vo,
                                        synth_low_fill_db, update_stream)
    from repro_torch.core import IVMEngine
    from repro_torch.runtime import integrity as integ

    label = "I1_integrity_housing"
    root = SNAPSHOT_DIR / "integrity_housing"
    shutil.rmtree(root, ignore_errors=True)
    q = housing_query("sum", HOUSING_DOMS_BIG)
    db, active = synth_low_fill_db(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                                   np.random.default_rng(SEED), "pc", I1_ACTIVE,
                                   device="cuda")
    stream = update_stream(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                           np.random.default_rng(SEED + 1), I1_BATCH, I1_BATCHES,
                           key_pools={"pc": active}, device="cuda")
    n_tuples = I1_BATCH * I1_BATCHES
    total: dict = {}

    def build(**kw):
        eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                              device="cuda", **kw)
        eng.precompile(I1_BATCH)
        return eng

    cfgs = dict(off=dict(policy="permissive"), validate=dict(policy="quarantine"),
                audit=dict(policy="quarantine", audit_interval=2))
    with plan.use_fusion("auto"):
        best: dict = {}
        seg_stats: dict = {}
        for rep in range(3):
            for mode, kw in cfgs.items():
                cfg = integ.IntegrityConfig(segment_updates=I1_SEGMENT, **kw)
                eng = build(store_base=mode == "audit")
                ex = StreamExecutor(eng, integrity=cfg)
                wall, launches = timed_run(ex, stream, kernels)
                add_launches(total, launches)
                segs = ex.last_segment_stats
                seg_stats[mode] = segs
                audits = [s["audit_s"] for s in segs if s["audit_s"]]
                if rep and (mode not in best or wall < best[mode]["run_s"]):
                    best[mode] = dict(run_s=wall, tuples_per_s=n_tuples / wall,
                                      segments=len(segs),
                                      admit_s=sum(s["admit_s"] for s in segs),
                                      audit_s=audits, launches=launches,
                                      audit_log=[dict(e) for e in cfg.audit_log],
                                      dead_letters=len(cfg.dead_letters))
                ex.release()
                del eng, ex
        if best["validate"]["launches"] != best["off"]["launches"]:
            raise AssertionError(f"{label}: validation changed the launches")
        plans_want = segment_launches(build, stream, seg_stats["off"])
        got = {k: n for k, n in best["off"]["launches"].items() if n and ":" not in k}
        if got != plans_want:
            raise AssertionError(f"{label}: launches {got}, the plans say {plans_want}")
        # the audited run's launches: an unaudited run's on an engine that
        # also stores its base, and one from-base Reevaluate's (alone)
        eng = build(store_base=True)
        ex = StreamExecutor(eng, integrity=integ.IntegrityConfig(
            policy="permissive", segment_updates=I1_SEGMENT))
        want = timed_run(ex, stream, kernels)[1]
        add_launches(total, want)
        reset(kernels)
        integ.audit_engine(eng, integ.IntegrityConfig(audit_interval=1))
        for k in kernels:
            want[k.name] += k.launches
        ex.release()
        if best["audit"]["launches"] != want:
            raise AssertionError(f"{label}: audited launches {best['audit']['launches']}"
                                 f", unaudited and one audit {want}")
        del eng, ex
        if (len(best["audit"]["audit_s"]) != best["audit"]["segments"] // 2
                or best["validate"]["dead_letters"]):
            raise AssertionError(f"{label}: audits {best['audit']['audit_s']}, "
                                 f"dead letters {best['validate']['dead_letters']}")
        if any(e["repaired"] for e in best["audit"]["audit_log"]):
            raise AssertionError(f"{label}: a clean stream's audit repaired a view: "
                                 f"{best['audit']['audit_log']}")
        bad, masked, letters = poison(stream)
        eng_m = build()
        ex = StreamExecutor(eng_m, integrity=integ.IntegrityConfig(
            policy="permissive", segment_updates=I1_SEGMENT))
        masked_launches = timed_run(ex, masked, kernels)[1]
        add_launches(total, masked_launches)
        masked_plans = segment_launches(build, masked, ex.last_segment_stats)
        check = {k: n for k, n in masked_launches.items() if n and ":" not in k}
        if check != masked_plans:
            raise AssertionError(f"{label} masked: launches {check}, the plans say "
                                 f"{masked_plans}")
        want = state_copy(eng_m)
        ex.release()
        del eng_m, ex
        cfg = integ.IntegrityConfig(policy="quarantine", segment_updates=I1_SEGMENT)
        eng_q = build()
        ex = StreamExecutor(eng_q, integrity=cfg)
        quarantine_launches = timed_run(ex, bad, kernels)[1]
        add_launches(total, quarantine_launches)
        if quarantine_launches != masked_launches:
            raise AssertionError(f"{label} quarantine: launches {quarantine_launches}, "
                                 f"the masked stream's {masked_launches}")
        leaves = same_state(f"{label} quarantine", eng_q, want)
        got = sorted(((r.rel, r.stream_index, r.row, tuple(r.key), tuple(r.reasons))
                      for r in cfg.dead_letters), key=lambda r: (r[1], r[2]))
        if got != letters:
            raise AssertionError(f"{label}: dead letters {got}, planted {letters}")
        ex.release()
        del eng_q, ex
        # validated admission of the whole poisoned stream: no host read
        cfg_a = integ.IntegrityConfig(policy="quarantine")
        eng_a = build()
        _, admit_syncs, _ = count_syncs(lambda: integ.admit_stream(eng_a, bad, cfg_a))
        del eng_a
        if admit_syncs:
            raise AssertionError(f"{label}: quarantine admission synchronised "
                                 f"{admit_syncs} times")
        integ.flush_dead_letters(cfg_a)
        # strict, with a checkpoint: stops before the poisoned segment commits
        ck = StreamCheckpointer(str(root / "strict"), segment_updates=I1_SEGMENT)
        ex = StreamExecutor(build(), checkpoint=ck, integrity=integ.IntegrityConfig(
            policy="strict", segment_updates=I1_SEGMENT))
        try:
            ex.run(bad)
            raise AssertionError(f"{label}: strict admitted the poisoned stream")
        except integ.StreamIntegrityError as e:
            strict = dict(error=str(e), rows=[r.row for r in e.records])
        ck.ckpt.discard_pending()
        strict["committed"] = ck.ckpt.all_steps()
        first = min(at for at, _, _ in I1_POISON)
        if "update 2" not in strict["error"] or any(
                s > first - first % I1_SEGMENT for s in strict["committed"]):
            raise AssertionError(f"{label}: strict {strict}")
        ex.release()
        del ex
    shutil.rmtree(root, ignore_errors=True)
    off = best["off"]["tuples_per_s"]
    return dict(
        leg=label, batch=I1_BATCH, n_batches=I1_BATCHES, segment_updates=I1_SEGMENT,
        n_active=I1_ACTIVE, runs=best,
        validate_over_off=best["validate"]["tuples_per_s"] / off,
        audit_over_off=best["audit"]["tuples_per_s"] / off,
        quarantine=dict(leaves=leaves, dead_letters=len(got),
                        admission_syncs=admit_syncs),
        strict=strict, launches=total), bad, masked, want


def audit_hook(at_segment: int, fn):
    """Call ``fn()`` at the ``mid_segment`` crossing of segment
    ``at_segment`` (between that segment's run and its boundary): a
    context that wraps ``faults.crossing``."""
    import contextlib

    from repro_torch.runtime import faults

    @contextlib.contextmanager
    def ctx():
        crossing = faults.crossing

        def hooked(point, **kw):
            if point == "mid_segment" and kw.get("segment") == at_segment:
                fn()
            crossing(point, **kw)

        faults.crossing = hooked
        try:
            yield
        finally:
            faults.crossing = crossing

    return ctx()


def integrity_cofactor(kernels) -> dict:
    """I2: the retailer degree-10 cofactor stream (fusion ``auto``,
    ``store_base=True``) under ``IntegrityConfig(policy="quarantine",
    audit_interval=2, segment_updates=5)``: two audits at the full state,
    each record with its seconds (the from-base Reevaluate is the priced
    item); the eager engine's launches equal the plans'.  Then a second
    run whose root's Q[0, 0] drifts by 1 % after the
    second segment: the audit after it repairs the root in place, the next
    segment replays (no eager step), and the root lies within RTOL of the
    float64 oracle at the end."""
    import torch
    from repro_torch.core import StreamExecutor, plan
    from repro_torch.runtime.integrity import IntegrityConfig, audit_engine

    label = "I2_integrity_cofactor_audit"
    q, q64, db, stream, build = retailer_case("cofactor")
    total: dict = {}
    with plan.use_fusion("auto"):
        out = {}
        eager = eager_launches(lambda: build(store_base=True), stream, kernels)
        plans_want = stream_launches(build(store_base=True), stream)
        if eager != plans_want:
            raise AssertionError(f"{label}: the eager engine launched {eager}, the "
                                 f"plans say {plans_want}")
        for run in ("clean", "drift"):
            eng = build(store_base=True)
            cfg = IntegrityConfig(policy="quarantine", audit_interval=2,
                                  segment_updates=DURABLE_SEGMENT_UPDATES)
            ex = StreamExecutor(eng, integrity=cfg)
            root = eng.tree.name
            drift = {}

            def perturb():
                qq = eng.views[root].payload["Q"]
                idx = (0,) * qq.dim()
                drift["value"] = float(qq[idx])
                qq[idx] += 0.01 * (abs(drift["value"]) + 1.0)

            ctx = audit_hook(1, perturb) if run == "drift" else audit_hook(-1, None)
            with ctx:
                wall, launches = timed_run(ex, stream, kernels)
            add_launches(total, launches)
            segs = ex.last_segment_stats
            audits = [e for e in cfg.audit_log]
            # the plans' launches and, for each audit, one from-base
            # Reevaluate's (measured alone after the run)
            reset(kernels)
            audit_engine(eng, IntegrityConfig(audit_interval=1))
            per_audit = {k.name: k.launches for k in kernels if k.launches}
            want = dict(eager)
            for k, n in per_audit.items():
                want[k] = want.get(k, 0) + len(audits) * n
            got = {k: n for k, n in launches.items() if n and ":" not in k}
            if got != want:
                raise AssertionError(f"{label} {run}: launches {got}, the eager "
                                     f"engine's and the audits' {want}")
            check = compare_views(f"{label} {run}", eng,
                                  oracle_store(eng, db, stream, q64, 1))
            out[run] = dict(run_s=wall, tuples_per_s=BATCH * N_BATCHES / wall,
                            audits=audits, audit_s=[s["audit_s"] for s in segs if s["audit_s"]],
                            eager_steps=[s["run"].get("eager_steps", 0) for s in segs],
                            replays=[s["run"].get("replays", 0) for s in segs],
                            oracle=check)
            if len(audits) != 2:
                raise AssertionError(f"{label} {run}: audits {audits}")
            if run == "drift":
                fixed = [(a["segment"], a["route"]) for a in audits if a["repaired"]]
                if (1, "in_place") not in fixed or out[run]["eager_steps"][2] != 0:
                    raise AssertionError(f"{label}: drift not repaired in place and "
                                         f"replayed: {audits} {out[run]['eager_steps']}")
                out[run]["drift_from"] = drift["value"]
            ex.release()
            del eng, ex
            torch.cuda.empty_cache()
    return dict(leg=label, batch=BATCH, n_batches=N_BATCHES,
                segment_updates=DURABLE_SEGMENT_UPDATES, audit_interval=2,
                launches_eager=eager, launches_plans=plans_want,
                next_segment_after_repair=("replayed" if out["drift"]["eager_steps"][2] == 0
                                           else "captured"),
                **out, launches=total)


def supervisor_phase(kernels, d1_state: dict, i1_bad, i1_masked,
                     i1_want: dict) -> dict:
    """I3: ``StreamSupervisor`` over D1's configuration with an in-process
    ``mid_segment`` fault (one restart, the log's action ``restart``,
    every leaf equal to D1's uninterrupted run), and over I1's poisoned
    stream under ``strict`` (it escalates to ``quarantine_batch``, every
    leaf equal to I1's quarantine run); each part's launches held to the
    plans of the updates it ran (``stream_launches``,
    ``segment_launches``)."""
    import shutil

    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor, plan
    from repro_torch.data.synth import HOUSING_DOMS_BIG, HOUSING_RELATIONS, housing_vo
    from repro_torch.data.synth import synth_low_fill_db
    from repro_torch.core import IVMEngine
    from repro_torch.runtime import faults
    from repro_torch.runtime.fault_tolerance import StreamSupervisor
    from repro_torch.runtime.integrity import IntegrityConfig

    label = "I3_supervisor"
    root = SNAPSHOT_DIR / "supervisor"
    shutil.rmtree(root, ignore_errors=True)
    total: dict = {}
    with plan.use_fusion("auto"):
        _, _, _, stream, build = retailer_case("sum")
        eng = build()
        ex = StreamExecutor(eng, checkpoint=StreamCheckpointer(
            str(root / "d1"), keep=3, segment_updates=DURABLE_SEGMENT_UPDATES))
        reset(kernels)
        faults.install(faults.FaultPlan("mid_segment", at=2))
        try:
            _, restarts, log_d1 = StreamSupervisor(backoff_s=0.0).run(ex, stream)
        finally:
            faults.clear()
        launches = {k.name: k.launches for k in kernels}
        add_launches(total, launches)
        if restarts != 1 or log_d1[0].get("action") != "restart":
            raise AssertionError(f"{label}: {restarts} restarts, log {log_d1}")
        # the plans of the 15 updates before the fault and of those the
        # restart replayed from its snapshot
        replayed = sum(s["updates"] for s in ex.last_segment_stats)
        d1_plans = stream_launches(eng, stream[:3 * DURABLE_SEGMENT_UPDATES])
        add_launches(d1_plans, stream_launches(eng, stream[len(stream) - replayed:]))
        got = {k: n for k, n in launches.items() if n and ":" not in k}
        if got != d1_plans:
            raise AssertionError(f"{label} D1: launches {got}, the plans say {d1_plans}")
        d1_leaves = same_state(f"{label} D1", eng, d1_state)
        ex.release()
        del eng, ex
        q = housing_query("sum", HOUSING_DOMS_BIG)
        db, _ = synth_low_fill_db(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                                  np.random.default_rng(SEED), "pc", I1_ACTIVE,
                                  device="cuda")

        def build_i1():
            eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                                  device="cuda")
            eng.precompile(I1_BATCH)
            return eng

        eng = build_i1()
        cfg = IntegrityConfig(policy="strict", segment_updates=I1_SEGMENT)
        ex = StreamExecutor(eng, integrity=cfg, checkpoint=StreamCheckpointer(
            str(root / "i1"), segment_updates=I1_SEGMENT))
        reset(kernels)
        _, restarts_i1, log_i1 = StreamSupervisor(backoff_s=0.0).run(ex, i1_bad)
        launches = {k.name: k.launches for k in kernels}
        add_launches(total, launches)
        # strict stops at admission, before any launch; the quarantined
        # restart runs every update, the poisoned rows masked
        i1_plans = segment_launches(build_i1, i1_masked, ex.last_segment_stats)
        got = {k: n for k, n in launches.items() if n and ":" not in k}
        if got != i1_plans:
            raise AssertionError(f"{label} I1: launches {got}, the plans say {i1_plans}")
        actions = [e.get("action") for e in log_i1 if "action" in e]
        if actions != ["quarantine_batch"] or cfg.policy != "quarantine":
            raise AssertionError(f"{label}: I1 ladder {log_i1}")
        i1_leaves = same_state(f"{label} I1", eng, i1_want)
        ex.release()
        del eng, ex
    shutil.rmtree(root, ignore_errors=True)
    return dict(leg=label,
                d1=dict(restarts=restarts, log=log_d1, leaves=d1_leaves),
                i1=dict(restarts=restarts_i1, actions=actions,
                        dead_letters=len(cfg.dead_letters), leaves=i1_leaves),
                launches=total)


def durable_phase(kernels, laps) -> tuple[list, dict]:
    """The ``durable`` phase: D1 and D2 (see each), each logged.  Returns
    the legs and D1's uninterrupted state (for I3)."""
    import torch

    d1, d1_state = durable_retailer(kernels)
    log(d1)
    torch.cuda.empty_cache()
    laps.lap("durable D1")
    d2 = durable_housing(kernels)
    log(d2)
    torch.cuda.empty_cache()
    laps.lap("durable D2")
    return [d1, d2], d1_state


def integrity_phase(kernels, laps, d1_state: dict) -> list:
    """The ``integrity`` phase: I1, I2 and I3 (see each), each logged."""
    import torch

    i1, bad, masked, want = integrity_housing(kernels)
    log(i1)
    torch.cuda.empty_cache()
    laps.lap("integrity I1")
    i2 = integrity_cofactor(kernels)
    log(i2)
    torch.cuda.empty_cache()
    laps.lap("integrity I2")
    i3 = supervisor_phase(kernels, d1_state, bad, masked, want)
    log(i3)
    torch.cuda.empty_cache()
    laps.lap("integrity I3")
    return [i1, i2, i3]


#: the serve phase (R1-R3), the reference's serving bench
#: (benchmarks/bench_serve.py) on the card: R1's point batches and its
#: latency reads (batches of 256 keys, each ended by one synchronise)
SERVE_BATCHES = (64, 1024, 8192)
SERVE_LAT_BATCH, SERVE_LAT_READS = 256, 200
#: R2, updates under read load: the housing sparse stream (I1's: 12 × 512)
#: and the degree-10 cofactor stream at RETAILER_DOMS_BIG (12 × 64), each
#: through ViewServer(segment_updates=4), a reader of 256 keys every 10 ms
#: in the loaded passes, interleaved best of 5; the reference bench's gate
R2_COFACTOR_BATCH, R2_BATCHES, R2_SEGMENT = 64, 12, 4
R2_READ_BATCH, R2_THROTTLE_S, R2_PASSES, R2_GATE = 256, 0.01, 5, 0.9
#: R3's chaos case: the reader's keys a view, and the longest wait for it
#: to see the final generation
R3_KEYS, R3_DEADLINE_S = 256, 30.0


def widest_view(eng) -> str:
    """The served view with the largest key space, as the reference bench
    picks it; of equally wide views the first by name (the engine's view
    order varies from process to process)."""
    return max(sorted(n for n, v in eng.views.items() if v.schema),
               key=lambda n: math.prod(eng.views[n].domains))


def probe_batch(view, active, rng, b: int) -> np.ndarray:
    """The reference bench's read keys: half the rows from the active key
    pool, half uniform (mostly misses at sub-percent fill)."""
    cols = []
    for v in view.schema:
        col = rng.integers(0, int(view.domain_of(v)), size=b)
        if v == "pc":
            col = np.where(rng.random(b) < 0.5, rng.choice(active, size=b), col)
        cols.append(col)
    return np.stack(cols, axis=1).astype(np.int32)


def host_tree(tree):
    """A pytree of tensors as numpy arrays (one copy a leaf)."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda x: x.detach().cpu().numpy(), tree)


def host_leaves(views) -> list:
    """Every leaf of a view dict, views in name order, as numpy arrays (a
    sparse view's key table and payload columns)."""
    from torch.utils import _pytree as pytree

    return [x.detach().cpu().numpy()
            for n in sorted(views) for x in pytree.tree_leaves(views[n])]


def same_reads(label: str, got, want) -> dict:
    """Raise unless two host read trees are equal: bitwise where the
    largest magnitude is below 2**24, else within RTOL of it (float sums
    past 2**24 depend on the order of the atomics).  Returns the counts."""
    from torch.utils import _pytree as pytree

    a, sa = pytree.tree_flatten(got)
    b, sb = pytree.tree_flatten(want)
    if sa != sb:
        raise AssertionError(f"{label}: read structures differ")
    out = {"bitwise": 0, "tolerance": 0, "max_rel_err": 0.0}
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{label}: a read has another shape or dtype")
        scale = float(np.abs(y).max()) if y.size and y.dtype.kind == "f" else 0.0
        if scale < EXACT_LIMIT:
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: reads differ")
            out["bitwise"] += 1
        else:
            err = float(np.abs(x.astype(np.float64) - y).max()) / scale
            if err > RTOL:
                raise AssertionError(f"{label}: reads differ by {err} of their magnitude")
            out["tolerance"] += 1
            out["max_rel_err"] = max(out["max_rel_err"], err)
    return out


def view_reads(server, name: str, keys) -> dict:
    """Every read path over one served view of the newest generation: a
    point batch, two range sums, a range scan and a top-k, on the host."""
    S = math.prod(server.registry.latest().views[name].domains)
    return host_tree(dict(
        point=server.point(name, keys).data,
        range_all=server.range_sum(name, 0, S).data,
        range_part=server.range_sum(name, S // 7, S // 2).data,
        scan=server.range_scan(name, 0, S, 64).data,
        top=server.top_k(name, 16).data))


def serve_engine(q, db, storage: str, batch: int):
    from repro_torch.core import IVMEngine
    from repro_torch.data.synth import housing_vo

    eng = IVMEngine.build(q, db, var_order=housing_vo(), strategy="fivm",
                          storage=storage, device="cuda")
    eng.precompile(batch)
    return eng


def serve_reads_leg(kernels) -> dict:
    """R1: S1's engine (the housing star at pc = 65,536, 512 active, the
    sum ring, S1's 10 × 64 stream applied through a registry-attached
    executor) served from its widest ``pc``-keyed view, once with ``auto``
    storage (a hash table) and once ``dense``.  Every read path of the
    sparse view equals the dense view's bitwise; a sparse point read is one
    keyed ``hash_probe`` launch and nothing else of the hand kernels (its
    counts, and a profiled window listing one ``hash_probe_kernel`` a
    read); ``point`` (device keys and host keys), ``range_sum``,
    ``range_scan``, ``top_k`` and a publish make 0 synchronising calls.
    Then, for each storage, lookups/s of point batches of 64, 1024 and 8192
    keys (best of 3 × 20, each read ended by a synchronise, the keys drawn
    as the reference bench draws them) and the p50 / p95 / p99 host ms of
    200 reads of 256 keys, each ended by ``ReadResult.host()``."""
    import torch
    from repro_torch.core import StreamExecutor
    from repro_torch.core.storage import SparseRelation
    from repro_torch.data.synth import HOUSING_DOMS_BIG, HOUSING_RELATIONS, synth_low_fill_db
    from repro_torch.kernels.hash_table import HASH_PROBE, ROUTE_LAUNCHES
    from repro_torch.serve import ViewServer

    label = "R1_serve_reads"
    q = housing_query("sum", HOUSING_DOMS_BIG)
    db, active = synth_low_fill_db(HOUSING_RELATIONS, HOUSING_DOMS_BIG, q.ring,
                                   np.random.default_rng(SEED), "pc", 512, device="cuda")
    stream = housing_stream(q, active, 64, 10, SEED + 1)
    servers, total = {}, {}
    for storage in ("dense", "auto"):
        eng = serve_engine(q, db, storage, 64)
        ex = StreamExecutor(eng)
        servers[storage] = ViewServer(ex)
        reset(kernels)
        ex.run(stream)
        add_launches(total, {k.name: k.launches for k in kernels})
        ex.release()
    name = widest_view(servers["auto"].engine)
    if not isinstance(servers["auto"].engine.views[name], SparseRelation) or isinstance(
            servers["dense"].engine.views[name], SparseRelation):
        raise AssertionError(f"{label}: {name} is not a hash table under auto "
                             f"and dense under dense")
    sparse, dense = servers["auto"], servers["dense"]
    view = sparse.engine.views[name]
    rng = np.random.default_rng(SEED + 3)
    keys = probe_batch(view, active, rng, 1000)
    keys[-3:] = -1  # padding rows read ring zero
    got, want = view_reads(sparse, name, keys), view_reads(dense, name, keys)
    # top-k places equal values by position, a slot in the table and a key
    # in the dense view: its values are held bitwise, its keys by reading
    # them back from the dense view
    top_keys = got["top"].pop("keys")
    want["top"].pop("keys")
    equal = same_reads(f"{label} sparse vs dense", got, want)
    back = dense.point(name, top_keys).host()["v"]
    valid = got["top"]["valid"]
    if equal["tolerance"] or not np.array_equal(back[valid], got["top"]["values"][valid]):
        raise AssertionError(f"{label}: sparse reads not bitwise to dense: {equal}")
    dkeys = torch.from_numpy(probe_batch(view, active, rng, SERVE_LAT_BATCH)).to("cuda")
    # synchronising calls of each read path and of a publish (warmed first)
    S = math.prod(view.domains)
    paths = dict(point_device_keys=lambda: sparse.point(name, dkeys),
                 point_host_keys=lambda: sparse.point(name, keys),
                 range_sum=lambda: sparse.range_sum(name, 0, S),
                 range_scan=lambda: sparse.range_scan(name, 0, S, 64),
                 top_k=lambda: sparse.top_k(name, 16),
                 publish=lambda: sparse.registry.publish(sparse.engine.views))
    syncs = {}
    for path, fn in paths.items():
        fn()
        _, syncs[path], sites = count_syncs(fn)
        if syncs[path]:
            raise AssertionError(f"{label}: {path} synchronised at {sites}")
    # a sparse point read: one keyed probe, no other hand kernel
    sparse.point(name, dkeys)
    torch.cuda.synchronize()
    reset(kernels)
    sparse.point(name, dkeys)
    torch.cuda.synchronize()
    one = {k.name: k.launches for k in kernels if k.launches}
    if one != {"hash_probe": 1, "hash_probe:keys": 1}:
        raise AssertionError(f"{label}: a sparse point read launched {one}")
    before = (HASH_PROBE.launches, ROUTE_LAUNCHES["hash_probe:keys"].launches)
    events, windows = listed_launches(lambda: sparse.point(name, dkeys),
                                      "hash_probe_kernel", 20, f"{label} point")
    probes = sum("hash_probe_kernel" in e.name for e in events)
    after = (HASH_PROBE.launches, ROUTE_LAUNCHES["hash_probe:keys"].launches)
    if probes != 20 or any(a - b != 20 * windows for a, b in zip(after, before)):
        raise AssertionError(f"{label}: {probes} probe kernels listed, launches "
                             f"{before} -> {after} for 20 reads a window")
    out = dict(view=name, view_capacity=view.capacity, reads_equal=equal,
               point_launches=one, point_device_events=len(events) / 20,
               syncs=syncs, throughput={}, latency={})
    for storage, server in servers.items():
        backend = "sparse" if storage == "auto" else "dense"
        rates = {}
        for b in SERVE_BATCHES:
            bkeys = probe_batch(view, active, rng, b)
            server.point(name, bkeys)
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(20):
                    server.point(name, bkeys)
                    torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            rates[b] = b * 20 / best
        out["throughput"][backend] = {"lookups_per_s": rates}
        batches = [probe_batch(view, active, rng, SERVE_LAT_BATCH) for _ in range(8)]
        for k in batches:
            server.point(name, k).host()
        lat = []
        for i in range(SERVE_LAT_READS):
            t0 = time.perf_counter()
            server.point(name, batches[i % len(batches)]).host()
            lat.append(time.perf_counter() - t0)
        out["latency"][backend] = {f"p{p}_ms": 1e3 * float(np.percentile(lat, p))
                                   for p in (50, 95, 99)}
    return dict(leg=label, batch=64, n_batches=10, n_active=512, **out,
                launches=total)


def read_load_pass(ex, server, name, keys, stream, kernels, mode: str,
                   reader_stream=None) -> dict:
    """One R2 pass: ``stream`` through the registry-attached executor ``ex``
    (its state restored after).  ``mode`` ``"loaded"`` runs a reader
    thread on ``reader_stream`` reading ``keys`` from the newest generation
    every ``R2_THROTTLE_S``; ``"sleeper"`` a thread that wakes as often
    and reads nothing (the thread's own cost); ``"unloaded"`` no thread.
    Returns the wall, the reads, the publishes' seconds, the launches and
    the segments."""
    import threading

    import torch

    eng = ex.engine
    saved = (dict(eng.views), dict(eng.base), dict(eng.indicators))
    stop, errors, reads = threading.Event(), [], [0]

    def reader():
        try:
            with torch.cuda.stream(reader_stream):
                while not stop.is_set():
                    if mode == "loaded":
                        server.point(name, keys).host()
                        reads[0] += 1
                    time.sleep(R2_THROTTLE_S)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    thread = (threading.Thread(target=reader, daemon=True) if mode != "unloaded"
              else None)
    reset(kernels)
    torch.cuda.synchronize()
    if thread is not None:
        thread.start()
    t0 = time.perf_counter()
    try:
        ex.run(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
    if thread is not None and thread.is_alive():
        raise AssertionError("R2: the reader thread did not stop")
    if errors:
        raise errors[0]
    launches = {k.name: k.launches for k in kernels}
    segs = ex.last_segment_stats
    eng.set_state(saved)
    # where a pass's host seconds go: admission, the segments' runs (of
    # which capture, warm-up and replay dispatch), the publishes
    parts = {key: sum(s[key] for s in segs) for key in ("admit_s", "dispatch_s",
                                                         "publish_s")}
    parts.update({key: sum(s["run"].get(key, 0.0) for s in segs)
                  for key in ("capture_s", "replay_host_s")})
    return dict(wall=wall, reads=reads[0], launches=launches, segments=len(segs),
                stats=segs, publish_s=parts["publish_s"], parts=parts,
                generations=[s["generation"] for s in segs])


def serve_load_leg(kernels) -> dict:
    """R2: the reference bench's gated leg at the card's state.  The
    housing sparse stream (pc = 65,536, 512 active, I1's 12 × 512) and the
    degree-10 cofactor stream at ``RETAILER_DOMS_BIG`` (I2's database and
    engine, 12 × 64), each through ``ViewServer(segment_updates=4)`` on two
    engines: unloaded, loaded by a reader thread on a CUDA stream of its
    own reading 256 keys of the widest view from the newest generation
    every 10 ms, and a "sleeper" thread that wakes as often and reads
    nothing (what the thread alone costs).  A warm pass each, then best of
    5 in turns, the state restored between passes.  Each pass's launches are held to the plans
    (``stream_launches``): the unloaded exactly, the loaded for every
    kernel but ``hash_probe``, which the reads add to.  Reports loaded and
    unloaded tuples/s, their ratio beside the reference's 0.9 gate (a
    ratio below it is a finding, not a failure), reads/s and the publishes'
    seconds a pass."""
    import torch
    from repro_torch.core import IVMEngine, StreamExecutor, plan
    from repro_torch.core.apps import regression
    from repro_torch.data import synth
    from repro_torch.serve import ViewServer

    label = "R2_serve_load"
    hq = housing_query("sum", synth.HOUSING_DOMS_BIG)
    hdb, active = synth.synth_low_fill_db(
        synth.HOUSING_RELATIONS, synth.HOUSING_DOMS_BIG, hq.ring,
        np.random.default_rng(SEED), "pc", I1_ACTIVE, device="cuda")
    hstream = synth.update_stream(synth.HOUSING_RELATIONS, synth.HOUSING_DOMS_BIG, hq.ring,
                                  np.random.default_rng(SEED + 1), I1_BATCH, R2_BATCHES,
                                  key_pools={"pc": active}, device="cuda")
    doms, rels = synth.RETAILER_DOMS_BIG, synth.RETAILER_RELATIONS
    cq = regression.cofactor_query(rels, doms)
    cdb = synth.synth_db(rels, doms, cq.ring, np.random.default_rng(SEED), device="cuda")
    cstream = synth.update_stream(rels, doms, cq.ring, np.random.default_rng(SEED + 2),
                                  R2_COFACTOR_BATCH, R2_BATCHES, device="cuda")

    def housing():
        return serve_engine(hq, hdb, "auto", I1_BATCH)

    def cofactor():
        eng = IVMEngine.build(cq, cdb, var_order=synth.retailer_vo(), strategy="fivm",
                              device="cuda")
        eng.precompile(R2_COFACTOR_BATCH)
        return eng

    out, total = {}, {}
    with plan.use_fusion("auto"):
        for dataset, build, stream, pool in (
                ("housing_sparse_pc65536", housing, hstream, active),
                ("retailer_cofactor_m10", cofactor, cstream, np.arange(4))):
            execs, servers = {}, {}
            for mode in ("unloaded", "loaded", "sleeper"):
                execs[mode] = StreamExecutor(build())
                servers[mode] = ViewServer(execs[mode], segment_updates=R2_SEGMENT)
            eng = execs["loaded"].engine
            name = widest_view(eng)
            keys = probe_batch(eng.views[name], pool, np.random.default_rng(SEED + 3),
                               R2_READ_BATCH)
            # the reader's stream lives as long as the server, as a serving
            # process's would: its allocations are cached after the warm pass
            reader_stream = torch.cuda.Stream()
            for mode in execs:  # warm: captures, kernel loads, read paths
                warm = read_load_pass(execs[mode], servers[mode], name, keys, stream,
                                      kernels, mode, reader_stream)
            plans = segment_launches(build, stream, warm["stats"])
            best: dict = {}
            for _ in range(R2_PASSES):
                for mode in execs:
                    p = read_load_pass(execs[mode], servers[mode], name, keys, stream,
                                       kernels, mode, reader_stream)
                    add_launches(total, p["launches"])
                    got = {k: n for k, n in p["launches"].items() if n and ":" not in k}
                    if mode != "loaded":
                        ok = got == plans
                    else:
                        reads = got.pop("hash_probe", 0)
                        ok = ({k: n for k, n in got.items()}
                              == {k: n for k, n in plans.items() if k != "hash_probe"}
                              and reads >= plans.get("hash_probe", 0))
                    if not ok:
                        raise AssertionError(f"{label} {dataset} {mode}: launches "
                                             f"{p['launches']}, the plans say {plans}")
                    if p["segments"] < R2_BATCHES // R2_SEGMENT:
                        raise AssertionError(f"{label} {dataset}: {p['segments']} segments")
                    if mode not in best or p["wall"] < best[mode]["wall"]:
                        best[mode] = p
            for p in best.values():
                del p["stats"]
            n_tuples = sum(upd.batch for _, upd in stream)
            un, lo, sl = best["unloaded"], best["loaded"], best["sleeper"]
            out[dataset] = dict(
                batch=stream[0][1].batch, n_batches=len(stream), served_view=name,
                segments=lo["segments"], launches_plans=plans,
                tuples_per_s_unloaded=n_tuples / un["wall"],
                tuples_per_s_loaded=n_tuples / lo["wall"],
                loaded_over_unloaded=un["wall"] / lo["wall"], gate=R2_GATE,
                meets_gate=un["wall"] / lo["wall"] >= R2_GATE,
                sleeper_over_unloaded=un["wall"] / sl["wall"],
                reads_per_s=lo["reads"] / lo["wall"],
                read_lookups_per_s=lo["reads"] * R2_READ_BATCH / lo["wall"],
                reads=lo["reads"], publish_s_per_pass_loaded=lo["publish_s"],
                publish_s_per_pass_unloaded=un["publish_s"],
                pass_parts={m: best[m]["parts"] for m in best})
            for ex in execs.values():
                ex.release()
            del execs, servers, eng
            torch.cuda.empty_cache()
    return dict(leg=label, segment_updates=R2_SEGMENT, read_batch=R2_READ_BATCH,
                throttle_s=R2_THROTTLE_S, passes=R2_PASSES, **out, launches=total)


def serve_consistency_leg(kernels) -> dict:
    """R3: (a) the housing sparse stream and the cofactor stream of R2 through
    ``ViewServer(retain=32, segment_updates=4)``: every generation, read
    under ``pin(g)`` (every view: a point batch and a ``range_sum`` over its
    key space) and leaf by leaf, equals a fresh engine that replayed
    ``stream[:offset]`` (the sum ring bitwise, the cofactor ring bitwise
    below 2**24, else within RTOL); the housing runs' launches equal their
    plans.  (b) The chaos case: D2's growing housing stream (tables rehash
    between segments, so segments capture their graphs anew) under a
    checkpoint and a registry, every 5 updates, with a reader thread on a
    CUDA stream of its own reading every view of each generation it sees
    under a pin, while the run takes a ``mid_segment`` fault and an
    in-process ``resume``: every generation it saw equals a fresh engine
    replayed to that generation's offset."""
    import shutil
    import threading

    import torch
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import IVMEngine, StreamExecutor, plan
    from repro_torch.core.apps import regression
    from repro_torch.data import synth
    from repro_torch.runtime import faults
    from repro_torch.serve import ViewServer

    label = "R3_serve_consistency"
    root = SNAPSHOT_DIR / "serve_chaos"
    shutil.rmtree(root, ignore_errors=True)
    hq = housing_query("sum", synth.HOUSING_DOMS_BIG)
    hdb, active = synth.synth_low_fill_db(
        synth.HOUSING_RELATIONS, synth.HOUSING_DOMS_BIG, hq.ring,
        np.random.default_rng(SEED), "pc", I1_ACTIVE, device="cuda")
    hstream = synth.update_stream(synth.HOUSING_RELATIONS, synth.HOUSING_DOMS_BIG, hq.ring,
                                  np.random.default_rng(SEED + 1), I1_BATCH, R2_BATCHES,
                                  key_pools={"pc": active}, device="cuda")
    doms, rels = synth.RETAILER_DOMS_BIG, synth.RETAILER_RELATIONS
    cq = regression.cofactor_query(rels, doms)
    cdb = synth.synth_db(rels, doms, cq.ring, np.random.default_rng(SEED), device="cuda")
    cstream = synth.update_stream(rels, doms, cq.ring, np.random.default_rng(SEED + 2),
                                  R2_COFACTOR_BATCH, R2_BATCHES, device="cuda")

    def cofactor():
        eng = IVMEngine.build(cq, cdb, var_order=synth.retailer_vo(), strategy="fivm",
                              device="cuda")
        eng.precompile(R2_COFACTOR_BATCH)
        return eng

    def probe(eng, pool) -> dict:
        rng = np.random.default_rng(SEED + 4)
        return {n: (probe_batch(v, pool, rng, R3_KEYS) if v.schema
                    else np.zeros((R3_KEYS, 0), np.int32))
                for n, v in eng.views.items()}

    def reads(src, keys) -> dict:
        """Every view's point batch and whole-range sum, from a server's
        newest generation or a pinned one."""
        return {n: host_tree((src.point(n, k).data, src.range_sum(n, 0, 1 << 30).data))
                for n, k in sorted(keys.items())}

    def offline(build, stream, offset, keys) -> dict:
        eng = build()
        if offset:
            ex = StreamExecutor(eng)
            ex.run(stream[:offset])
            ex.release()
        return eng, reads(ViewServer(StreamExecutor(eng)), keys)

    out, total = {}, {}
    with plan.use_fusion("auto"):
        for dataset, build, stream, pool in (
                ("housing_sparse_pc65536", lambda: serve_engine(hq, hdb, "auto", I1_BATCH),
                 hstream, active),
                ("retailer_cofactor_m10", cofactor, cstream, np.arange(4))):
            eng = build()
            ex = StreamExecutor(eng)
            server = ViewServer(ex, retain=32, segment_updates=R2_SEGMENT)
            keys = probe(eng, pool)
            reset(kernels)
            ex.run(stream)
            launches = {k.name: k.launches for k in kernels}
            add_launches(total, launches)
            got_l = {k: n for k, n in launches.items() if n and ":" not in k}
            want_l = segment_launches(build, stream, ex.last_segment_stats)
            if got_l != want_l:
                raise AssertionError(f"{label} {dataset}: launches {got_l}, the plans "
                                     f"say {want_l}")
            reg = server.registry
            checked = {"bitwise": 0, "tolerance": 0, "max_rel_err": 0.0}
            gens = []
            for g in range(reg.generation + 1):
                with server.pin(g) as p:
                    snap = reg.get(g)
                    ref_eng, want = offline(build, stream, snap.offset, keys)
                    res = same_reads(f"{label} {dataset} generation {g}",
                                     reads(p, keys), want)
                    leaves = same_reads(
                        f"{label} {dataset} generation {g} leaves",
                        host_leaves(snap.views), host_leaves(ref_eng.views))
                    for r in (res, leaves):
                        checked["bitwise"] += r["bitwise"]
                        checked["tolerance"] += r["tolerance"]
                        checked["max_rel_err"] = max(checked["max_rel_err"],
                                                     r["max_rel_err"])
                    gens.append([g, p.offset, snap.segment])
                    del ref_eng
            if reg.latest().offset != len(stream) or len(gens) != 1 + len(
                    ex.last_segment_stats):
                raise AssertionError(f"{label} {dataset}: generations {gens}")
            out[dataset] = dict(generations=gens, compared=checked)
            ex.release()
            del eng, ex, server
            torch.cuda.empty_cache()
        # (b) the chaos case on D2's growing stream
        _, _, gdb, gstream, gbuild = housing_growth_case()
        eng = gbuild()
        ck = StreamCheckpointer(str(root), segment_updates=DURABLE_SEGMENT_UPDATES)
        ex = StreamExecutor(eng, checkpoint=ck)
        server = ViewServer(ex, segment_updates=DURABLE_SEGMENT_UPDATES)
        pool = np.unique(np.concatenate([upd.keys[:, upd.schema.index("pc")].cpu().numpy()
                                         for _, upd in gstream]))
        keys = probe(eng, pool)
        reads(server, keys)  # warm the read paths on the first layout
        seen, errors, stop = {}, [], threading.Event()

        def reader():
            try:
                with torch.cuda.stream(torch.cuda.Stream()):
                    while not stop.is_set():
                        with server.pin() as p:
                            if p.generation not in seen:
                                seen[p.generation] = (p.offset, reads(p, keys))
                        time.sleep(0.001)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        thread = threading.Thread(target=reader, daemon=True)
        reset(kernels)
        thread.start()
        try:
            with faults.inject("mid_segment", at=1) as inj:
                try:
                    ex.resume(gstream)
                except faults.InjectedFault:
                    pass
            first = [dict(s) for s in ex.last_segment_stats]
            ex.resume(gstream)
            torch.cuda.synchronize()
            deadline = time.time() + R3_DEADLINE_S
            while server.registry.generation not in seen and time.time() < deadline:
                time.sleep(0.005)
        finally:
            stop.set()
            thread.join(timeout=60)
        add_launches(total, {k.name: k.launches for k in kernels})
        if thread.is_alive() or errors:
            raise AssertionError(f"{label}: the reader failed: {errors}")
        if not inj.fired:
            raise AssertionError(f"{label}: the mid_segment fault never fired")
        resumed = ex.last_segment_stats
        grew = [s["segment"] for s in first + resumed if s["grow"]]
        # a later segment of either run that warmed and captured its graphs
        # (a rehash changed its signature) while the reader ran
        recaptured = [[run, s["segment"]] for run, segs in (("first", first),
                                                             ("resumed", resumed))
                      for s in segs[1:] if s["run"].get("eager_steps", 0)]
        offsets = sorted({off for off, _ in seen.values()})
        if len(seen) < 2 or offsets[-1] != len(gstream) or not grew or not recaptured:
            raise AssertionError(f"{label}: generations seen {sorted(seen)} at offsets "
                                 f"{offsets}, growth at {grew}, recaptures {recaptured}")
        ex.release()
        del eng, ex
        torch.cuda.empty_cache()
        checked = {"bitwise": 0, "tolerance": 0, "max_rel_err": 0.0}
        offline_reads = {}
        for g, (offset, got) in sorted(seen.items()):
            if offset not in offline_reads:
                ref_eng, offline_reads[offset] = offline(gbuild, gstream, offset, keys)
                del ref_eng
            r = same_reads(f"{label} chaos generation {g}", got, offline_reads[offset])
            checked["bitwise"] += r["bitwise"]
            checked["tolerance"] += r["tolerance"]
            checked["max_rel_err"] = max(checked["max_rel_err"], r["max_rel_err"])
        restored = [g for g, s in server.registry._snaps.items()
                    if s.meta.get("restored")]
        out["chaos_housing_growth"] = dict(
            fault=inj.fired[0][:2], generations_seen=len(seen), offsets_seen=offsets,
            grew_at_segments=grew, recaptured_segments=recaptured,
            restored_generations_retained=restored, compared=checked)
    shutil.rmtree(root, ignore_errors=True)
    return dict(leg=label, **out, launches=total)


def serve_phase(kernels, laps) -> list:
    """The ``serve`` phase: R1, R2 and R3 (see each), each logged."""
    import torch

    legs = []
    for fn, lap in ((serve_reads_leg, "serve R1"), (serve_load_leg, "serve R2"),
                    (serve_consistency_leg, "serve R3")):
        legs.append(fn(kernels))
        log(legs[-1])
        torch.cuda.empty_cache()
        laps.lap(lap)
    return legs


# ---------------------------------------------------------------------------
# Sharding: the reference's sharded sweep (benchmarks/bench_stream.py:106-175)
# over the ranks of one torch.distributed group on the one card
# ---------------------------------------------------------------------------
#: the child groups, in order: one rank (NCCL, the capturable path), four
#: ranks, then two (gloo: NCCL refuses two ranks on one device).  Each rank
#: is a process of its own on the one card (``--shard-child``).
SHARD_WORLDS = (1, 4, 2)
#: the groups' rendezvous files, outputs and SH3's snapshots (gitignored)
SHARD_DIR = Path(__file__).resolve().parent / "build" / "shard"
#: SH3: boundaries every 5 updates (D2's), the 4-rank run killed at the
#: second ``mid_segment`` crossing
SH3_KILL_AT = 2
#: SH2: the largest relative difference a ring component of a view may
#: show against the unsharded executor (the reference sweep's bound)
SH2_RTOL = 1e-6
#: SH4: read keys a view, and boundaries every 2 updates
SH4_KEYS, SH4_SEGMENT = 64, 2
#: updates of the warm-up run before each timed run (plan compiles, kernel
#: libraries and lazy initialisation; another signature, so a graphed timed
#: run still captures)
SHARD_WARMUP = 5
#: SH2 runs on 4 ranks of the one card only if four times the peak device
#: bytes of its 1-rank run stay under this (the card holds 80 GB)
SH2_MAX_GROUP_BYTES = 70e9


def shard_case(leg: str):
    """(query, float64 query, db, stream, build) of a sharded leg: SH1 the
    housing star at pc = 65,536 (sum ring, 512 active postcodes, 10 × 64,
    ``auto`` storage: six tables), SH2 the retailer degree-10 cofactor at
    ``RETAILER_DOMS_BIG`` (20 × 1000), SH3 D2's growing housing stream."""
    import torch
    from repro_torch.core import IVMEngine
    from repro_torch.core.apps import regression
    from repro_torch.data import synth

    if leg == "SH3":
        return housing_growth_case()
    if leg == "SH1":
        q = housing_query("sum", synth.HOUSING_DOMS_BIG)
        q64 = housing_query("sum", synth.HOUSING_DOMS_BIG, torch.float64)
        db, active = synth.synth_low_fill_db(
            synth.HOUSING_RELATIONS, synth.HOUSING_DOMS_BIG, q.ring,
            np.random.default_rng(SEED), "pc", 512, device="cuda")
        stream = housing_stream(q, np.sort(active), 64, 10, SEED + 1)
        vo, batch = synth.housing_vo(), 64
    else:
        doms, rels = synth.RETAILER_DOMS_BIG, synth.RETAILER_RELATIONS
        q = regression.cofactor_query(rels, doms)
        q64 = regression.cofactor_query(rels, doms, dtype=torch.float64)
        rng = np.random.default_rng(SEED)
        db = synth.synth_db(rels, doms, q.ring, rng, device="cuda")
        stream = synth.update_stream(rels, doms, q.ring, rng, BATCH, N_BATCHES,
                                     device="cuda")
        vo, batch = synth.retailer_vo(), BATCH

    def build(**kw):
        eng = IVMEngine.build(q, db, var_order=vo, strategy="fivm", device="cuda", **kw)
        eng.precompile(batch)
        return eng

    return q, q64, db, stream, build


def logical_views(eng) -> dict:
    """Every view whole (a collective for each sharded one: every rank)."""
    from repro_torch.core.storage import as_dense

    return {n: as_dense(eng.views[n]) for n in sorted(eng.views)}


def component_rel_err(got: dict, want: dict) -> float:
    """The largest, over views and ring components, of max |got - want|
    over the largest |want| of that component (the reference sweep's
    ``max_rel_diff``: planes differ in scale by orders of magnitude)."""
    worst = 0.0
    for n, w in want.items():
        for c, t in w.payload.items():
            scale = float(t.abs().max()) if t.numel() else 0.0
            err = float((got[n].payload[c].double() - t.double()).abs().max()) \
                if t.numel() else 0.0
            worst = max(worst, err / scale if scale else err)
    return worst


def replica_drift(eng, shard) -> dict:
    """The largest difference between the ranks' copies of a replicated
    float leaf (views the plan does not shard, base relations): each
    leaf against rank 0's, by broadcast, then the largest over ranks,
    absolute and over the leaf's largest magnitude."""
    import torch
    from repro_torch.core import collectives
    from repro_torch.core import plan as plan_mod

    import torch.distributed as dist

    grp = shard.mesh.grp
    if grp.size == 1:
        return dict(abs=0.0, rel=0.0)
    views, base, _ = eng.state
    leaves = [t for n in sorted(views) if n not in shard.sharded_views()
              for t in plan_mod.relation_leaves(views[n])]
    leaves += [t for n in sorted(base) for t in plan_mod.relation_leaves(base[n])]
    drift = [0.0, 0.0]
    for t in leaves:
        if t.is_floating_point() and t.numel():
            ref = collectives.broadcast(t.clone(), grp)
            err = float((t - ref).abs().max())
            scale = float(ref.abs().max())
            drift = [max(drift[0], err), max(drift[1], err / scale if scale else err)]
    worst = torch.tensor(drift, dtype=torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=grp.group)
    return dict(abs=float(worst[0]), rel=float(worst[1]))


def shard_report(shard_plan, views) -> dict:
    """Per sharded view: this rank's bytes of its split leaves (the payload
    rows) against the whole view's, and the bytes of its replicated leaves
    (a sparse view's key table)."""
    from repro_torch.core.relations import ShardedDense, is_sharded
    from repro_torch.core.storage import SparseRelation

    out = {}
    for name in shard_plan.sharded_views():
        v = views[name]
        rows = v.rows if isinstance(v, (ShardedDense, SparseRelation)) else None
        local = (rows.numel() * rows.element_size() if rows is not None
                 else v.nbytes())
        whole = (v.shard.total_rows * rows.shape[1] * rows.element_size()
                 if is_sharded(v) else local)
        table = (v.table.numel() * v.table.element_size()
                 if isinstance(v, SparseRelation) else 0)
        out[name] = dict(local_bytes=local, whole_bytes=whole,
                         replicated_bytes=table)
    return out


def shard_leg(leg: str, kernels) -> dict:
    """One sharded leg at this group's size, on every rank.  Rank 0 first
    runs the unsharded executor on an engine of its own (the baseline);
    then every rank builds the engine, plans and places it
    (``shard_executor``) and runs the stream, timed between barriers, its
    kernels' counts reset before and read after.  Each timed run follows
    a warm-up run of the stream's first ``SHARD_WARMUP`` updates that
    leaves the engine as it was.  Rank 0 holds the whole
    views to the baseline (SH1 bitwise; SH2 within ``SH2_RTOL`` a
    component, and to the float64 oracle); at one rank the sharded run
    must capture as many graphs and launch each kernel as often as the
    baseline.  Returns this rank's line."""
    import types

    import torch
    import torch.distributed as dist
    from repro_torch.core import StreamExecutor, collectives, plan, shard_executor

    world, rank = dist.get_world_size(), dist.get_rank()
    label = f"{leg}_ranks{world}"
    with plan.use_fusion("auto"):
        q, q64, db, stream, build = shard_case(leg)
        n_batches = len(stream)
        n_tuples = sum(u.batch for _, u in stream)
        base = None
        warm = stream[:SHARD_WARMUP]
        if rank == 0:
            eng = build()
            ex = StreamExecutor(eng)
            ex.run(warm, update_engine=False)  # plan compiles, lazy inits
            reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.run(stream)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            base = dict(views=logical_views(eng), stats=dict(ex.last_run_stats),
                        launches={k.name: k.launches for k in kernels},
                        tuples_per_s=n_tuples / wall)
            ex.release()
            del eng, ex
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = build()
        ex = shard_executor(eng)
        specs = ex.shard.pretty()
        view_bytes = shard_report(ex.shard, eng.views)
        ex.run(warm, update_engine=False)
        collectives.reset_stats()
        reset(kernels)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run(stream)
        torch.cuda.synchronize()
        dist.barrier()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        stats = dict(ex.last_run_stats)
        coll = {k: dict(calls_per_batch=v["calls"] / n_batches,
                        bytes_per_batch=v["bytes"] / n_batches, backend=v["backend"])
                for k, v in collectives.STATS.items()}
        drift = replica_drift(eng, ex.shard)
        views = logical_views(eng)
        peak = torch.cuda.max_memory_allocated()
    out = dict(leg=label, ranks=world, rank=rank, backend=ex.shard.backend,
               program=stats.get("program"), program_reason=stats.get("program_reason"),
               graphs=stats.get("graphs"), replays=stats.get("replays"),
               eager_steps=stats.get("eager_steps"), specs=specs.splitlines(),
               sharded_views=list(ex.shard.sharded_views()), view_bytes=view_bytes,
               tuples_per_s=n_tuples / wall, run_s=wall,
               collectives_per_batch=coll,
               launches={k: n for k, n in launches.items() if n},
               max_memory_allocated=peak, replica_drift=drift)
    for name, b in view_bytes.items():
        if b["local_bytes"] * world != b["whole_bytes"]:
            raise AssertionError(f"{label} {name}: {b['local_bytes']} bytes on a "
                                 f"rank, not 1/{world} of {b['whole_bytes']}")
    if rank == 0:
        missing = [n for n, c in base["launches"].items() if c and not launches[n]]
        if missing:
            raise AssertionError(f"{label}: the sharded run never launched {missing}")
        if leg == "SH1":
            for name, w in base["views"].items():
                for c, t in w.payload.items():
                    if not torch.equal(views[name].payload[c], t):
                        raise AssertionError(f"{label} {name}.{c}: differs from the "
                                             f"unsharded executor")
            out["bitwise_views"] = len(base["views"])
        else:
            err = component_rel_err(views, base["views"])
            if err > SH2_RTOL:
                raise AssertionError(f"{label}: relative difference {err} > {SH2_RTOL}")
            out["max_rel_diff"] = err
            store = oracle_store(eng, db, stream, q64, 1)
            out["oracle"] = compare_views(label, types.SimpleNamespace(
                views=views, materialized_names=eng.materialized_names), store)
        if world == 1:
            same = {k: (stats.get(k), base["stats"].get(k))
                    for k in ("program", "graphs", "replays", "eager_steps")}
            if (any(a != b for a, b in same.values())
                    or launches != base["launches"]):
                raise AssertionError(f"{label}: one rank is not the unsharded "
                                     f"program: {same}, launches {launches} vs "
                                     f"{base['launches']}")
        out["unsharded_tuples_per_s"] = base["tuples_per_s"]
    ex.release()
    del eng, ex, views, base
    torch.cuda.empty_cache()
    return out


def shard_serve_leg(kernels) -> dict:
    """SH4: SH1's engine on this group behind ``ViewServer(segment_updates=2)``
    while a reader thread on a CUDA stream of its own reads every
    generation it sees under a pin (the reader never issues a collective:
    a publish gathers the whole views on the stream thread).  Rank 0 then
    holds every generation (views and the reads seen) to a fresh unsharded
    engine replayed to its offset, bitwise."""
    import threading

    import torch
    import torch.distributed as dist
    from repro_torch.core import StreamExecutor, plan, shard_executor
    from repro_torch.serve import ViewServer

    world, rank = dist.get_world_size(), dist.get_rank()
    label = f"SH4_serve_ranks{world}"
    with plan.use_fusion("auto"):
        _, _, _, stream, build = shard_case("SH1")
        eng = build()
        ex = shard_executor(eng)
        server = ViewServer(ex, retain=64, segment_updates=SH4_SEGMENT)
        rng = np.random.default_rng(SEED + 4)
        pool = np.unique(np.concatenate([u.keys[:, u.schema.index("pc")].cpu().numpy()
                                         for _, u in stream]))
        keys = {n: probe_batch(v, pool, rng, SH4_KEYS)
                for n, v in sorted(server.registry.latest().views.items()) if v.schema}

        def reads(src) -> dict:
            return {n: host_tree(src.point(n, k).data) for n, k in keys.items()}

        seen, errors, stop = {}, [], threading.Event()

        def reader():
            try:
                with torch.cuda.stream(torch.cuda.Stream()):
                    while not stop.is_set():
                        with server.pin() as p:
                            if p.generation not in seen:
                                seen[p.generation] = (p.offset, reads(p))
                        time.sleep(0.001)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        thread = threading.Thread(target=reader)
        thread.start()
        try:
            ex.run(stream)
            final = server.registry.generation
            deadline = time.perf_counter() + R3_DEADLINE_S
            while final not in seen and not errors and time.perf_counter() < deadline:
                time.sleep(0.01)
        finally:
            stop.set()
            thread.join(timeout=R3_DEADLINE_S)
        if errors or thread.is_alive():
            raise AssertionError(f"{label}: the reader failed: {errors}")
        reg = server.registry
        out = dict(leg=label, ranks=world, rank=rank, generations=reg.generation + 1,
                   seen=sorted(seen), reads_per_generation=len(keys))
        if rank == 0:
            checked = {"bitwise": 0, "tolerance": 0, "max_rel_err": 0.0}
            for g in range(reg.generation + 1):
                snap = reg.get(g)
                ref = build()
                if snap.offset:
                    rex = StreamExecutor(ref)
                    rex.run(stream[:snap.offset])
                    rex.release()
                rsrv = ViewServer(StreamExecutor(ref))
                got = [same_reads(f"{label} generation {g} leaves",
                                  host_leaves(snap.views), host_leaves(ref.views))]
                if g in seen:
                    got.append(same_reads(f"{label} generation {g} reads", seen[g][1],
                                          reads(rsrv)))
                for r in got:
                    for k in ("bitwise", "tolerance"):
                        checked[k] += r[k]
                del ref, rsrv
            if reg.latest().offset != len(stream):
                raise AssertionError(f"{label}: the last generation is at "
                                     f"{reg.latest().offset}")
            out["compared"] = checked
    ex.release()
    del eng, ex, server
    torch.cuda.empty_cache()
    return out


def shard_chaos(kernels, directory: str, resume: bool) -> dict:
    """SH3 on this group: D2's growing housing stream with snapshots every
    5 updates.  ``resume=False``: the run, killed by ``SIGKILL`` at the
    second ``mid_segment`` crossing on every rank (never returns).
    ``resume=True``: ``resume`` from those snapshots, re-planned for this
    group; returns this rank's line with rank 0's whole views."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import plan, shard_executor
    from repro_torch.runtime import faults

    world, rank = dist.get_world_size(), dist.get_rank()
    with plan.use_fusion("auto"):
        _, _, _, stream, build = shard_case("SH3")
        ck = StreamCheckpointer(directory, segment_updates=DURABLE_SEGMENT_UPDATES)
        ex = shard_executor(build(), checkpoint=ck)
        if not resume:
            faults.install(faults.FaultPlan("mid_segment", at=SH3_KILL_AT, mode="kill9"))
            ex.run(stream)
            raise AssertionError("SH3: the kill -9 fault never fired")
        t0 = time.perf_counter()
        ex.resume(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        views = logical_views(ex.engine)
    out = dict(leg=f"SH3_resume_ranks{world}", ranks=world, rank=rank,
               resumed_from=ck.ckpt.all_steps(), resume_s=wall,
               sharded_views=list(ex.shard.sharded_views()),
               capacities=capacities(ex.engine),
               views={n: v.payload["v"].cpu().numpy() for n, v in views.items()}
               if rank == 0 else None)
    ex.release()
    return out


def shard_child(world: int, rank: int, out_dir: str, legs: list) -> int:
    """One rank of a child group of the ``shard`` phase: ``legs`` (SH1,
    SH2) at the group's size; at two ranks SH4 and SH3's resume; at four
    SH3's killed run.  Kernels come from the parent's build
    (``build/kernels``).  Each rank writes its lines to ``rank<r>.pkl`` in
    its group's directory."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(out_dir) / f"world{world}"
    dist.init_process_group("nccl" if world == 1 else "gloo",
                            init_method=f"file://{out / 'init'}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    kernels = shard_kernels()
    lines = [shard_leg(leg, kernels) for leg in legs]
    if world == 2:
        lines.append(shard_serve_leg(kernels))
        lines.append(shard_chaos(kernels, str(Path(out_dir) / "sh3_ranks2"), True))
    (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(lines))
    dist.barrier()
    if world == 4:
        shard_chaos(kernels, str(Path(out_dir) / "sh3"), False)
    dist.destroy_process_group()
    return 0


def shard_kernels() -> list:
    """The kernels the sharded legs count (the hash kernels by entry and
    route too), their libraries loaded from the parent's build."""
    from repro_torch.kernels.hash_table import HASH_INSERT, HASH_PROBE, ROUTE_LAUNCHES
    from repro_torch.kernels.ring_fused import FUSED_CHAIN
    from repro_torch.kernels.ring_scatter import GATHER_MUL_SCATTER, SCATTER_ADD
    from repro_torch.kernels.segment_ring_sum import SEGMENT_RING_SUM

    return [SCATTER_ADD, SEGMENT_RING_SUM, GATHER_MUL_SCATTER, FUSED_CHAIN,
            HASH_PROBE, HASH_INSERT] + list(ROUTE_LAUNCHES.values())


def shard_phase(laps) -> list:
    """The ``shard`` phase: child groups of 1 (NCCL), 4 and 2 ranks (gloo),
    every rank a process on the one card (:func:`shard_child`), run one
    after the other; a rank's failure fails the phase.  Then SH3: the
    4-rank group must have died by ``SIGKILL``; its snapshots were resumed
    on 2 ranks (in the 2-rank group, from a copy) and are resumed here on
    one, each against the uninterrupted unsharded run, bitwise."""
    import pickle
    import shutil

    import torch
    from repro_torch.checkpoint import StreamCheckpointer
    from repro_torch.core import StreamExecutor, plan, shard_executor

    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    lines: list = []
    legs = ["SH1", "SH2"]
    for world in SHARD_WORLDS:
        if world == 4:
            peak = next(line["max_memory_allocated_per_rank"][0] for line in lines
                        if line["leg"] == "SH2_ranks1")
            if 4 * peak >= SH2_MAX_GROUP_BYTES:
                lines.append(dict(leg="SH2_ranks4", ranks=4, skipped=True,
                                  reduced=f"4 x {peak} peak bytes of one rank >= "
                                          f"{SH2_MAX_GROUP_BYTES:.0f}"))
        run_legs = [leg for leg in legs
                    if not any(line.get("skipped") and line["leg"] == f"{leg}_ranks{world}"
                               for line in lines)]
        gdir = SHARD_DIR / f"world{world}"
        gdir.mkdir(parents=True)
        if world == 2:  # SH3's resume on 2 ranks reads a copy of the snapshots
            shutil.copytree(SHARD_DIR / "sh3", SHARD_DIR / "sh3_ranks2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--shard-child", str(world), str(r), str(SHARD_DIR),
                                   ",".join(run_legs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append((p.communicate(timeout=600)[0], p.returncode))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (text, code) in enumerate(outs):
            # the 4-rank group ends in SH3's kill: rank 0 by SIGKILL, a peer
            # by SIGKILL or by the collective that its killed peers broke
            ok = (code == 0 if world != 4 else code == -9 if r == 0 else code != 0)
            if not ok:
                raise AssertionError(f"shard: rank {r} of {world} exited {code}:\n"
                                     f"{text[-4000:]}")
        group = [pickle.loads((gdir / f"rank{r}.pkl").read_bytes()) for r in range(world)]
        for i, line in enumerate(group[0]):
            line = dict(line)
            line.pop("rank")
            if "launches" in line:
                line["launches_per_rank"] = [g[i]["launches"] for g in group]
                line.pop("launches")
            if "max_memory_allocated" in line:
                line["max_memory_allocated_per_rank"] = [
                    g[i]["max_memory_allocated"] for g in group]
                line.pop("max_memory_allocated")
            line["group_s"] = time.perf_counter() - t0
            lines.append(line)
        laps.lap(f"shard {world} ranks")
    # SH3: the uninterrupted run, unsharded, then the resume on one rank here
    # (no process group: a one-rank plan)
    sh3_ranks2 = next(line for line in lines if line["leg"] == "SH3_resume_ranks2")
    with plan.use_fusion("auto"):
        _, _, _, stream, build = shard_case("SH3")
        eng = build()
        StreamExecutor(eng).run(stream)
        want = {n: v.payload["v"].cpu().numpy() for n, v in logical_views(eng).items()}
        del eng
        ck = StreamCheckpointer(str(SHARD_DIR / "sh3"),
                                segment_updates=DURABLE_SEGMENT_UPDATES)
        steps = ck.ckpt.all_steps()
        if not steps:
            raise AssertionError("SH3: the killed group committed no snapshot")
        ex = shard_executor(build(), checkpoint=ck)
        t0 = time.perf_counter()
        ex.resume(stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got1 = {n: v.payload["v"].cpu().numpy() for n, v in logical_views(ex.engine).items()}
        ex.release()
    for label, got in (("SH3_resume_ranks2", sh3_ranks2.pop("views")),
                       ("SH3_resume_ranks1", got1)):
        for n, w in want.items():
            if not np.array_equal(got[n], w):
                raise AssertionError(f"{label} {n}: differs from the uninterrupted run")
    lines.append(dict(leg="SH3_resume_ranks1", ranks=1, killed_ranks=4,
                      killed_at_crossing=SH3_KILL_AT, committed_by_killed_group=steps,
                      resume_s=wall, bitwise_views=len(want)))
    sh3_ranks2["bitwise_views"] = len(want)
    for line in lines:
        log(line)
    torch.cuda.empty_cache()
    laps.lap("shard SH3 resume")
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import Query, sum_ring
    from repro_torch.core.apps import regression
    from repro_torch.core.rings import DegreeMRing
    from repro_torch.data import synth
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.cofactor_update import COFACTOR_UPDATE
    from repro_torch.kernels.hash_table import (HASH_INSERT, HASH_PROBE, ROUTE_LAUNCHES,
                                                ROUTES)
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels.flash_attention import (FLASH_ATTENTION,
                                                     FLASH_ATTENTION_BWD,
                                                     FLASH_ATTENTION_BWD_TF32,
                                                     FLASH_ATTENTION_BWD_WGMMA,
                                                     FLASH_ATTENTION_TF32,
                                                     FLASH_ATTENTION_WGMMA)
    from repro_torch.kernels.rank1_chain import MATVEC, OUTER_ACCUMULATE
    from repro_torch.kernels.ring_fused import FUSED_CHAIN
    from repro_torch.kernels.ring_mul import RING_MUL
    from repro_torch.kernels.ring_scatter import (GATHER_MUL_SCATTER, SCATTER_ADD,
                                                  SCATTER_DEDUP)
    from repro_torch.kernels.segment_ring_sum import SEGMENT_RING_SUM

    # float32 products in full precision (no TF32), as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.splitlines()[0])

    kernels = [SCATTER_ADD, SEGMENT_RING_SUM, GATHER_MUL_SCATTER, SCATTER_DEDUP,
               FUSED_CHAIN, COFACTOR_UPDATE, RING_MUL, MATVEC, OUTER_ACCUMULATE,
               FLASH_ATTENTION, FLASH_ATTENTION_WGMMA, FLASH_ATTENTION_TF32,
               HASH_PROBE, HASH_INSERT, FLASH_ATTENTION_BWD, FLASH_ATTENTION_BWD_WGMMA,
               FLASH_ATTENTION_BWD_TF32]
    laps = Laps()
    build_s = _cuda.build_all(kernels)
    log({"build_s": build_s, "libraries": [k.library_path().name for k in kernels]})
    for k in kernels:
        text = k.library_path().with_suffix(".log")
        if text.exists():
            for line in text.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"{k.name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    laps.lap("build")
    rows = kernel_phase(rng, laps)
    rows.update(hash_probe=[], hash_insert=[], hash_insert_targets=[], hash_probe_keys=[])
    hash_rows(rng, rows)
    laps.lap("kernels: hash_probe, hash_insert")
    # the paths count each kernel and, beside the hash kernels, each entry
    # and insert route (hash_table.ROUTE_LAUNCHES)
    built, kernels = kernels, kernels + list(ROUTE_LAUNCHES.values())

    doms = synth.RETAILER_DOMS_BIG
    rels = synth.RETAILER_RELATIONS
    streams = []
    # sum aggregates: SUM(units) over the join; the unfused path, the fused
    # path (auto: on, on the card) and a short stream under scatter_dedup
    q = Query(relations=rels, free_vars=(), ring=sum_ring(), domains=doms,
              lifts={"units": ("value",)})
    q64 = Query(relations=rels, free_vars=(), ring=sum_ring(torch.float64),
                domains=doms, lifts={"units": ("value",)})
    rng = np.random.default_rng(SEED)
    db = synth.synth_db(rels, doms, q.ring, rng, device="cuda")
    streams.extend(stream_phase("retailer_sum", q, q64, db, doms, rng, kernels,
                                ("scatter_add", "segment_ring_sum",
                                 "gather_mul_scatter"), executor=True))
    streams.extend(stream_phase("retailer_sum_fused", q, q64, db, doms,
                                np.random.default_rng(SEED + 1), kernels,
                                ("fused_chain",), fusion="auto", executor=True))
    streams.extend(stream_phase("retailer_sum_scatter_dedup", q, q64, db, doms,
                                np.random.default_rng(SEED + 2), kernels,
                                ("scatter_dedup",), backend="scatter_dedup",
                                n_batches=5))
    del db
    torch.cuda.empty_cache()

    # degree-m cofactor ring, m = 10 (d = 111): unfused, the scalar
    # gather-⊗-⊎ is not on this path (wider rings gather, multiply, then
    # scatter); fused, every Gather→Lift→⊎ chain is one fused_chain launch
    cq = regression.cofactor_query(rels, doms)
    cq64 = regression.cofactor_query(rels, doms, dtype=torch.float64)
    if cq.ring != DegreeMRing(10):
        raise AssertionError(f"unexpected cofactor ring {cq.ring.name}")
    rng = np.random.default_rng(SEED)
    db = synth.synth_db(rels, doms, cq.ring, rng, device="cuda")
    kept: list = []  # the largest view of each cofactor engine, for path B
    streams.extend(stream_phase("retailer_cofactor_m10", cq, cq64, db, doms,
                                rng, kernels,
                                ("scatter_add", "segment_ring_sum"), keep=kept))
    streams.extend(stream_phase("retailer_cofactor_m10_fused", cq, cq64, db,
                                doms, np.random.default_rng(SEED + 1), kernels,
                                ("fused_chain",), fusion="auto", keep=kept,
                                executor=True))
    del db
    torch.cuda.empty_cache()

    laps.lap("streams")
    # sparse view storage: the housing star at pc = 65,536, legs S1-S3
    housing = housing_phase(kernels, laps)
    # Sec. 6: the triangle query with indicator projections; Sec. 7.3: the
    # conjunctive query's factorized (card) and listing (host) results
    triangle = triangle_phase(kernels, laps)
    conjunctive = conjunctive_phase(kernels, laps)
    # the stream executor's durability and integrity planes: checkpointed
    # runs, faults and resume (D1, D2); validated admission, quarantine,
    # audits and the supervisor's ladder (I1-I3)
    durable, d1_state = durable_phase(kernels, laps)
    integrity = integrity_phase(kernels, laps, d1_state)
    del d1_state
    # the serving plane against running segmented streams: reads (R1),
    # updates under read load (R2), generation consistency and the chaos
    # case (R3)
    serve = serve_phase(kernels, laps)
    # sharding over a torch.distributed group on the one card: SH1-SH2 at
    # 1 (NCCL), 2 and 4 (gloo) ranks, SH3 the mesh-elastic resume, SH4 a
    # sharded executor behind the serving plane
    shard_phase(laps)
    # the kernel-ops layer: the ring product on engine state (B), streaming
    # statistics (A) and rank-1 matrix-chain deltas (C)
    paths = [ring_product_path(kept, kernels)]
    del kept
    torch.cuda.empty_cache()
    paths.append(stats_path(kernels))
    paths.append(chain_path(kernels))
    torch.cuda.empty_cache()
    laps.lap("paths A-C")
    # path C's rank-1 deltas through the engine: factorized updates
    paths.append(chain_engine_path(kernels, paths[-1]))
    laps.lap("chain_engine")
    # the LM scaffold's serving path: flash_attention in every prefill layer
    paths.append(lm_serve_path(kernels))
    laps.lap("path D")
    # path E, LM training: the backward kernel (E1), a train step against
    # float64 (E2), llama3.2-1b at full size (E3), resume and the example (E4)
    train = train_phase(kernels, laps)
    # path F, the MoE model (moonshot-v1-16b-a3b): float32 against float64
    # at 2 layers and reduced (F1), serving at full depth (F2), training (F3)
    moe = moe_phase(kernels, laps)
    # path G, MLA attention (deepseek-v3-671b): the forward and backward
    # routes at its head-dim pairs, float32 against float64 (G1), serving at
    # full width (G2), the module's gradient (G3), the reduced model trains
    # (G4)
    mla = mla_phase(kernels, rows, laps)
    # paths H and J, the SSM and hybrid models: xlstm-1.3b (H1 float32
    # against float64, H2 serving) and jamba-v0.1-52b (J1 its blocks and the
    # reduced model across the ring buffer's wrap, J2 serving at 2 of 4
    # periods), then the reduced configs' train steps against float64
    ssm = ssm_phase(kernels, laps)
    # path K, the encoder-decoder seamless-m4t-large-v2: K1 float32 against
    # float64, K2 serving at full width and depth, K3 the reduced config's
    # train step and decode
    encdec = encdec_phase(kernels, laps)
    # path L, the VLM paligemma-3b: L1 float32 against float64 at full width
    # and depth, L2 serving, L3 the reduced config's train step and decode
    vlm = vlm_phase(kernels, laps)
    # path D's float32 legs are the TF32 and mma flash kernels' paths
    # the housing legs' executor runs (capture and replay-only, or the
    # capacity segments) count beside their eager runs, and the chain
    # engine's integer and sparse cases beside its main run
    runs = [run["launches"] for run in streams + housing + paths
            + triangle[:-1] + conjunctive[:1]] + [
        run["executor"]["launches"] for run in housing] + [
        triangle[-1][key]["launches"] for key in ("capture", "replay_padded",
                                                  "replay_profiled")] + [
        run[key] for run in paths
        for key in ("launches_float32", "launches_float32_reduced", "launches_int",
                    "launches_sparse")
        if key in run] + [leg["launches"] for leg in durable + integrity + serve] + [
        leg["launches"] for leg in train["legs"] + moe["legs"] + mla["legs"]
        + ssm["legs"] + encdec["legs"] + vlm["legs"]] + [
        train["legs"][-1]["example"]["launches"]]
    launched = {k.name: sum(r.get(k.name, 0) for r in runs) for k in kernels}
    if not all(launched[k.name] for k in built):
        raise AssertionError(f"a kernel launched on no path: {launched}")
    # every sparse read and claim of the main path took the keyed forms
    if (not launched["hash_probe:keys"] or launched["hash_probe:ids"]
            or not sum(launched[f"hash_insert_targets:{r}"] for r in ROUTES)):
        raise AssertionError(f"sparse reads and claims not keyed: {launched}")

    sources = {
        "scatter_add": ("src/repro_torch/kernels/csrc/scatter_add.cu",
                        "src/repro/kernels/ring_scatter.py:108",
                        dict(S=1_179_648, d=111, B=BATCH)),
        "segment_ring_sum": ("src/repro_torch/kernels/csrc/segment_ring_sum.cu",
                             "src/repro/kernels/segment_ring_sum.py:38",
                             dict(S=BATCH, d=111, B=BATCH)),
        "gather_mul_scatter": ("src/repro_torch/kernels/csrc/gather_mul_scatter.cu",
                               "src/repro/kernels/ring_scatter.py:170",
                               dict(S=96, Sg=9216, d=1, B=BATCH)),
        "scatter_dedup": ("src/repro_torch/kernels/csrc/scatter_dedup.cu",
                          "src/repro/kernels/ring_scatter.py:91",
                          dict(S=1_179_648, d=111, B=BATCH)),
        "fused_chain": ("src/repro_torch/kernels/csrc/fused_chain.cu",
                        "src/repro/kernels/ring_fused.py:191",
                        dict(S=96, Sg=[9216, 96], d=111, B=BATCH)),
        "cofactor_update": ("src/repro_torch/kernels/csrc/cofactor_update.cu",
                            "src/repro/kernels/cofactor_update.py:59",
                            dict(B=STATS_B, m=STATS_M)),
        "ring_mul": ("src/repro_torch/kernels/csrc/ring_mul.cu",
                     "src/repro/kernels/ring_mul.py:52",
                     dict(K=1_179_648, m=10)),
        "matvec": ("src/repro_torch/kernels/csrc/matvec.cu",
                   "src/repro/kernels/rank1_chain.py:37",
                   dict(n=CHAIN_N, variant="rows")),
        "outer_accumulate": ("src/repro_torch/kernels/csrc/outer_accumulate.cu",
                             "src/repro/kernels/rank1_chain.py:66",
                             dict(n=CHAIN_N)),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:69",
                            dict(B=LM_REDUCED_B, H=4, Hkv=2, T=LM_REDUCED_T, D=16,
                                 dtype="float32")),
        "flash_attention_wgmma": ("src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                                  "src/repro/kernels/flash_attention.py:69",
                                  dict(B=LM_B, H=32, Hkv=8, T=LM_T, D=64,
                                       dtype="bfloat16")),
        "flash_attention_tf32": ("src/repro_torch/kernels/csrc/flash_attention_tf32.cu",
                                 "src/repro/kernels/flash_attention.py:69",
                                 dict(B=LM_B, H=32, Hkv=8, T=LM_T, D=64, dtype="float32")),
        "hash_probe": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                       "src/repro/core/storage.py:210",
                       dict(C=HASH_C, keys=HASH_KEYS, B=2 * HASH_B)),
        "hash_insert": ("src/repro_torch/kernels/csrc/hash_insert.cu",
                        "src/repro/core/storage.py:271",
                        dict(C=HASH_C, keys=HASH_KEYS, B=HASH_B)),
        "hash_insert_targets": ("src/repro_torch/kernels/csrc/hash_insert.cu",
                                "src/repro/core/storage.py:271 (with :313 _rank_ids)",
                                dict(C=HASH_C, keys=HASH_KEYS, B=HASH_B, keyed=True)),
        "hash_probe_keys": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                            "src/repro/core/storage.py:210 (with :79 linear_ids)",
                            dict(C=HASH_C, keys=HASH_KEYS, B=2 * HASH_B, keyed=True)),
    }
    # the hash kernels' rows are entries that share a kernel: each row
    # counts its own entry's launches (by route for the inserts), so the
    # rows of one kernel add up to its launches
    entries = {entry: [f"{entry}:{r}" for r in ROUTES]
               for entry in ("hash_insert", "hash_insert_targets")}
    entries.update(hash_probe=["hash_probe:ids"], hash_probe_keys=["hash_probe:keys"])
    summary = []
    for name, (source, replaces, shape) in sources.items():
        row = next(r for r in rows[name] if r["shape"] == shape)
        # path G's rows: the route at MLA's head-dim pairs
        mla_rows = [{k: r[k] for k in ("shape", "kernel_ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms", "lse_kernel_ms",
                                       "lse_device_ms") if k in r}
                    for r in rows[name] if "Dv" in r.get("shape", {})]
        # E1 at path K's encoder, decoder-self and cross-attention shapes, with L
        cross_rows = [r for r in train["cross"]["forward"]
                      if name == f"flash_attention_{r['variant']}"]
        # E1 under the prefix-LM mask (path L): D 256, 64 and the mma route
        vlm_rows = [r for r in train["vlm"]["forward"]
                    if name == tflash.KERNELS[r["variant"]].name]
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launched[n] for n in entries.get(name, [name])),
            max_abs_err=max(r["max_abs_err"] for r in rows[name] + cross_rows + vlm_rows),
            ms=row["kernel_ms"], device_ms=row["device_ms"],
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=shape,
            **{k: row[k] for k in ("variant", "tc_bound_ms", "exp_bound_ms", "host_us",
                                   "simt_device_ms", "lse_kernel_ms", "lse_device_ms",
                                   "insert_route", "rounds",
                                   "composition_ms", "composition_device_ms")
               if k in row},
            **({"launches_by_route": {n.split(":")[1]: launched[n] for n in entries[name]}}
               if name in ("hash_insert", "hash_insert_targets") else {}),
            **({"mla": mla_rows} if mla_rows else {}),
            **({"cross": cross_rows} if cross_rows else {}),
            **({"vlm": vlm_rows} if vlm_rows else {})))
    # the three backward routes: the wgmma route at BWD_MAIN and the tf32
    # route at BWD_MAIN_F32 (each with the SIMT route's time at its shape
    # beside it), the SIMT route at BWD_SIMT; each with path G's rows of
    # its route at MLA's head-dim pairs
    bwd_rows = (train["rows"] + mla["bwd_rows"] + train["cross"]["backward"]
                + train["vlm"]["backward"])
    for name, route, (B, H, Hkv, T, D, dtype, causal) in (
            ("flash_attention_bwd_wgmma", "wgmma", BWD_MAIN),
            ("flash_attention_bwd_tf32", "tf32", BWD_MAIN_F32),
            ("flash_attention_bwd", "simt", BWD_SIMT)):
        row = next(r for r in train["rows"] if r["causal"] == causal and r["shape"] == dict(
            B=B, H=H, Hkv=Hkv, T=T, D=D, dtype=dtype))
        keys = ("shape", "causal", "kernel_ms", "device_ms", "device_kernels", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_refused", "tc_bound_ms",
                "exp_bound_ms", "no_lse")
        mla_rows = [{k: r[k] for k in keys if k in r}
                    for r in mla["bwd_rows"] if r["route"] == route]
        # E1's other rows of the route (the D 128 cases among them)
        cases = [{k: r[k] for k in keys if k in r} for r in train["rows"]
                 if r["route"] == route and r is not row]
        summary.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces="no Pallas original: the gradient jax.grad takes of "
                     "src/repro/models/attention.py:76",
            launches=launched[name],
            max_abs_err=max(r["max_abs_err"] for r in bwd_rows if r["route"] == route),
            ms=row["kernel_ms"], device_ms=row["device_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape={**row["shape"], "causal": causal}, bound_peak=row["bound_peak"],
            **{k: row[k] for k in ("tc_bound_ms", "exp_bound_ms", "no_lse", "device_kernels",
                                   "simt_ms", "simt_device_ms") if k in row},
            cases=cases, mla=mla_rows,
            cross=[{k: r[k] for k in keys if k in r} for r in train["cross"]["backward"]
                   if r["route"] == route],
            vlm=[{k: r[k] for k in (*keys, "prefix_len", "library_device_ms", "ptxas", "grids")
                  if k in r}
                 for r in train["vlm"]["backward"] if r["route"] == route],
            **({"instances_d256": list(D256_BWD_INSTANCES[route])}
               if route in D256_BWD_INSTANCES else {})))
    log({"kernels": summary})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def flash_main(run) -> int:
    """Builds the six flash kernels and calls ``run(kernels)``: the
    ``--backward``, ``--ssm``, ``--encdec`` and ``--vlm`` runs of parts of the
    smoke; the whole smoke runs without arguments."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as tflash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[0])
    kernels = [tflash.FLASH_ATTENTION, tflash.FLASH_ATTENTION_WGMMA,
               tflash.FLASH_ATTENTION_TF32, tflash.FLASH_ATTENTION_BWD,
               tflash.FLASH_ATTENTION_BWD_WGMMA, tflash.FLASH_ATTENTION_BWD_TF32]
    log({"build_s": _cuda.build_all(kernels)})
    run(kernels)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def backward_main(kernels) -> None:
    """``python3 chip_smoke.py --backward``: path E's E1 (with the
    cross-attention shape, ``cross_attention_rows``) and path G's backward
    rows alone (``flash_bwd_rows`` at BWD_CASES and at MLA_BWD_CASES), for
    work on the backward kernels."""
    flash_bwd_rows(np.random.default_rng(SEED))
    cross_attention_rows(np.random.default_rng(SEED))
    flash_bwd_rows(np.random.default_rng(SEED), MLA_BWD_CASES, "G")


def ssm_main(kernels) -> None:
    """``python3 chip_smoke.py --ssm``: paths H and J alone (``ssm_phase``),
    for work on the SSM and hybrid models."""
    ssm_phase(kernels, Laps())


def encdec_main(kernels) -> None:
    """``python3 chip_smoke.py --encdec``: path K alone (``encdec_phase``),
    for work on the encoder-decoder."""
    encdec_phase(kernels, Laps())


def vlm_main(kernels) -> None:
    """``python3 chip_smoke.py --vlm``: path L alone (``vlm_phase``), after
    E1's prefix-LM rows (``vlm_attention_rows``), for work on the VLM."""
    vlm_attention_rows(np.random.default_rng(SEED))
    vlm_phase(kernels, Laps())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--backward"]:
        sys.exit(flash_main(backward_main))
    if sys.argv[1:2] == ["--ssm"]:
        sys.exit(flash_main(ssm_main))
    if sys.argv[1:2] == ["--encdec"]:
        sys.exit(flash_main(encdec_main))
    if sys.argv[1:2] == ["--vlm"]:
        sys.exit(flash_main(vlm_main))
    if sys.argv[1:2] == ["--durable-child"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        sys.exit(durable_child(sys.argv[2]))
    if sys.argv[1:2] == ["--shard-child"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        sys.exit(shard_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             sys.argv[5].split(",")))
    sys.exit(main())
