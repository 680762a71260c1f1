#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed on its own line; any failure raises and the exit
code is non-zero:

1. device  -- the card's name and power limit, as ``nvidia-smi`` prints them;
2. build   -- the seven CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at once),
   and beside them one more ``nvcc -Xptxas -v`` per source, whose report
   gives each kernel instantiation's registers, spill and static shared
   memory on a ``ptxas`` line;
3. kernels -- each kernel against its plain PyTorch version on the card at
   the serving shapes, in float32 (atol = rtol = 2e-5) and bfloat16
   (atol = rtol = 2e-2), then timed with CUDA events (median of 60
   launches, each queued behind a short device sleep so that the events
   time the device and not the host) beside the plain version and, where
   one exists, one PyTorch call as yardstick; a one-element ``zero_``
   timed the same way gives the method's floor.  Both attention kernels are
   checked and timed at head_dim 64 (smollm-135m) and 80 (zamba2-2.7b's
   shared block, decode lengths up to the ring buffer's wrap), and
   ``swa_prefill`` once more at zamba2's full window (B 1, S 4096), where
   the operations bound it; and both at gemma-2b's head_dim 256 with 8
   query heads over 1 KV head (prefill B 4, S 256, causal, and B 2, S 77
   under a window of 16; decode B 4, S 321, G 8, lengths 0/1/160/321),
   timed in bf16 under ``d256_*`` keys; at qwen2-vl-2b's 12 query heads
   of 128 over 2 KV heads (prefill B 4, S 320, causal; decode B 4, S 352,
   G 6, lengths 1/100/321/352) under ``d128_*`` keys, and
   ``decode_attention`` at whisper-large-v3's cross-attention (B 4, 1,500
   encoder rows, 20 heads of 64, every row valid) under ``cross_*``
   keys; at kimi-k2's 64 query heads of 128 over 8 KV heads (prefill
   B 4, S 256, causal; decode B 4, S 321, G 8, lengths 1/100/257/321)
   under ``k2_*`` keys.
   ``rwkv6_scan`` is checked at the prefill shape (B 4, T 256, H 32,
   D 64), at decode (T 1), at ragged T (77, 300) and at D 16 and 32, with
   bf16 r/k/v beside an f32 decay, for state continuation ([0:T]
   against [0:T/2] then [T/2:T], atol 1e-5 in f32), and bit for bit
   (``torch.equal``) at D 16/32/64 x T 1/2/17/300 in f32 and bf16.
   ``ssd_scan`` is checked at the prefill shape (B 4, T 256, H 80, P 64,
   N 64), at decode (T 1, y in f32), at ragged T (77, 300) and smaller P
   and N, over a bf16 sweep of T 15..300 x P 32/64 x N 16/64 around the
   chunked form's threshold, and for state continuation in f32 (1e-5)
   and bf16 (5e-2).  Its recurrence (f32, and bf16 with T below
   ``CHUNKED_MIN_T``) is held to ``ssd_scan_plain`` at the tolerances
   above; its chunked form (bf16, T >= ``CHUNKED_MIN_T``) to
   ``ssd_scan_chunked_plain`` (y 2e-2, h_final 2e-4) and to the
   recurrence at the reference's SSD bf16 tolerance, 5e-2.
   The decode step's three fused kernels (``add_rms_norm``,
   ``rope_kv_write``, ``glu_gate``; bf16 only) at h2o-danube-1.8b's,
   smollm-135m's and gemma-2b's widths (``FUSED_SHAPES``) and b 1, 8,
   16: each against its plain version at 1e-2 (the residual and the V
   row exactly), the K/V rows in their slot and no other before and
   after a 16-slot ring wraps and up to a full cache's last slot, an f32
   CUDA tensor refused; each timed beside its plain version and its
   byte bound (``<model>_b<B>_*`` keys, danube b 16 unprefixed).
   The Mamba2 decode step's two fused kernels (``mamba2_conv_step``,
   ``mamba2_gate_norm``; bf16 activations) at zamba2-7b's widths (G 2,
   conv biases) and zamba2-2.7b's (G 1, none) (``MAMBA2_FUSED``) and b
   1, 8, 16, the dt / A / D leaves in bf16 and f32: the conv step bit for
   bit with its windows shifted in place, the gated norm at 1e-2, an f32
   CUDA tensor refused; each timed beside its plain version and its byte
   bound (zamba2-7b b 1 unprefixed);
4. parity  -- full-width smollm-135m, rwkv6-1.6b, zamba2-2.7b,
   smollm-360m, gemma-2b and h2o-danube-1.8b, in float32: prefill (batch
   2, prompt 256) + 4 decode steps through the kernel routes match the
   plain routes (logits atol 1e-3, identical greedy ids).  Then
   smollm-135m, zamba2-2.7b, gemma-2b and h2o-danube-1.8b in bfloat16,
   the served type, with the f32 weights rounded and teacher-forced with the
   f32 plain route's greedy ids: the kernel route and the plain route
   are each held against the f32 plain route, and max |kernel - f32|
   must stay within 2 max |plain - f32| + 1e-2;
   window  -- full-width h2o-danube-1.8b (window 4096), batch 1, a prompt
   of 4160 tokens (longer than the window: ``swa_prefill`` skips the key
   tiles outside the band, the prefill wraps the 4096-slot ring buffer)
   and 16 greedy decode steps (``decode_attention`` over the wrapped
   ring): in float32 the kernel route's greedy ids equal the plain
   route's (logits atol 1e-3); in bfloat16 both routes, teacher-forced
   with the f32 ids, give the same greedy id at every step and the
   kernel route's logits keep the rule above;
   models -- qwen2-vl-2b (256 patch embeddings of a 16 x 16 grid before a
   64-token prompt, M-RoPE ids rising in sequence order with the grid's
   rows and columns) and whisper-large-v3 (1,500 encoder frames, a
   16-token prompt) at full width through the model API, inputs and
   weights from seeds.  f32, at the main path's batch (4) and cache
   length: prefill and 16 greedy decode steps, kernel route against
   plain route (logits atol 1e-3, identical ids),
   exactly one ``swa_prefill`` per layer per prefill and one
   ``decode_attention`` per layer per step (whisper two: self- and
   cross-attention); bf16 teacher-forced under the rule above.  Then the
   main path, bf16 on the kernel route, counts reset before and read
   after (they must be exactly those per prefill and step, and the
   fused kernels and ``decode_gemm`` ``fused_per_step`` times a step):
   the prefill
   wall at b 4 (whisper's encoder also alone) and a 64-step greedy
   generation at b 1, 2 and 4, eager and through one captured decode
   graph (ids equal), with host wall per step and tokens per wall
   second (prefill included);
   moe    -- kimi-k2-1t-a32b and deepseek-v3-671b at their published
   widths, each cut in depth to one dense and one MoE layer (the cuts on
   the phase's ``reduced`` field), weights from seeds.  f32 on an expert
   share: every MoE layer (deepseek's MTP block too) holds a quarter of
   the experts (96 / 64), routes over all of them and carries the shared
   expert, at the no-drop capacity factor E / k: prefill (batch 2,
   prompt 32) and 8 teacher-forced decode steps against the no-cache
   forward (within 1e-4 of the logits' scale: the experts sum in
   another order there), and kimi-k2's kernel route against its plain
   route (within 2e-5 of the scale, ids identical).  Then bf16 with
   every expert held, both kernel routes on, the served factor 1.25:
   eager against replayed steps as in the capture check below, the
   llm-chat serve as below (its counts reset before and read after:
   kimi-k2 launches both attention kernels, a multiple of its 2
   layers; deepseek-v3's MLA and the experts run in plain PyTorch, no
   kernel), the b = 4 entry's prefill wall, decode-step host wall eager
   and captured beside the floor of reading every expert once per step
   at the card's memory rate, the idle share (as in phase 7), peak
   memory, and deepseek-v3's ``mtp_logits`` once (finite, (B, S - 1,
   padded vocab));
   graph  -- one replay of h2o-danube-1.8b's served decode step
   (``DECODE_GRAPH``: bf16, the captured b 16 entry after a 512-token
   prompt): its device time (CUDA events, median of 50 replays), then
   one replay under ``torch.profiler``: kernels per replay and per
   layer, by family (cuBLAS, each hand-written kernel, PyTorch's own),
   and the top kernels;
5. capture -- per model, in bfloat16 at the serving shape (batch 4,
   prompt 256, 10 decode steps): the prefill and decode steps of one
   static gang run eagerly and as replayed CUDA graphs
   (``serving/capture.py``) on the same weights and prompts; the greedy
   ids must be identical, and the largest logit difference is printed.
   serve   -- ``run_token_scenario("llm-chat", arch=..., ...)`` in bfloat16
   on smollm-135m, rwkv6-1.6b, zamba2-2.7b, gemma-2b and h2o-danube-1.8b:
   the port's five main paths, served through step tables captured as
   CUDA graphs at warm-up, each with every kernel's launch count reset
   just before and read just after (a replay adds the launches its graph
   holds).  The capture check runs on the same five.  The dense paths
   (smollm, gemma, h2o-danube) must launch both attention kernels, each
   a multiple of their layers (30, 18, 24), and neither scan; the rwkv6 path
   must launch ``rwkv6_scan`` (a multiple of its 24 layers) and no other
   kernel; the zamba2 path must launch ``ssd_scan`` (a multiple of its 54
   layers) and both attention kernels (each a multiple of the shared
   block's 9 applications), and not ``rwkv6_scan``.  Every path, the
   MLA one too (which launches no attention kernel or scan), must launch
   the fused kernels exactly ``fused_per_step`` times a decode step
   (``add_rms_norm`` 2 L + 1, ``rope_kv_write`` and ``glu_gate`` once
   per standard-RoPE attention and SwiGLU / GeGLU MLP; zamba2's shared
   block two norms, one of each per application; whisper a third norm
   a layer; ``decode_gemm`` ``decode_gemm_per_step``: 7 L + 1 a dense
   SwiGLU stack, the dense layer's 3 and the head under MLA).  Every served step must be a graph replay.  Then ``llm-mixed-len`` (chat prompts beside
   long documents, per-request TTFT and TBT SLOs) on smollm-135m with
   ``b_set = c_set = (1, 2, 4, 8)``, under the same checks.

6. fixed   -- the paper's fixed-work Sponge loop (``make_live_server``,
   ``launch/serve.py``'s ``run_live`` settings) on full-width smollm-135m:
   one b = 4 table entry (prefill of 64 tokens + 8 greedy decode steps)
   gives identical ids through the kernel route (one captured graph) and
   the plain route (eager) in float32;
   both attention kernels in bfloat16 match their plain versions at the
   entry's shapes (prefill S 64 and decode over 72 cache rows at lengths
   65..72, for b 1/2/4/8); the bfloat16 table, captured, is calibrated
   (``l(b, c)`` printed) and each b entry timed (median of 10
   synchronised calls), and so is the same table run eagerly; 60 requests (10 rps for
   6 s, SLO 1 s, 200 KB over the 4G trace) served on the modelled clock
   give ``SimBackend``'s decisions and buckets on the same perf model;
   the same requests served on the measured clock each get a result,
   with ``swa_prefill`` launched 30 times (once per layer) and
   ``decode_attention`` 240 times (per layer per step) for every entry
   the serve ran, warm-up excluded, the fused kernels and
   ``decode_gemm`` ``fused_per_step`` times a step, and neither scan.  Its launches join
   the kernel rows;
   scenarios -- the dynamic-SLO scenarios on full-width smollm-135m, bf16:
   ``llm-heavy-tail`` and ``retrieve-then-generate`` (decode lengths from
   a declared distribution; the RAG prompts cut to the 256 bucket) served
   like ``llm-chat``, under the same checks; then the fixed phase's
   table (captured at warm-up, its fitted ``l(b, c)`` given) behind one
   fresh ``SpongeServer`` per run: ``slo-renegotiation`` and
   ``cancel-storm`` (120 requests each, seed 0) through
   ``server.session()``, each row submitted with a random prompt and the
   scenario's ``update_slo`` / ``cancel`` stream applied by
   ``drive_session_events``, with and without that stream, on the
   modelled clock (decisions, buckets, ``n``, violation rate,
   ``n_cancelled`` and the applied/no-op counts equal to
   ``run_scenario(name, engine="exact")`` on ``SimBackend`` over the same
   ``l(b, c)``, neither charging a resize penalty) and on the measured
   clock (violation rate, p50, p99, cancels, applied counts, decisions
   that differ between the two runs); ``network-replay`` (4G and 5G
   clients) served the same way on the measured clock.  Every live run
   must launch ``swa_prefill`` 30 times and ``decode_attention`` 240
   times per entry it ran, and neither scan.  All launches join the
   kernel rows;
   engines -- the struct-of-arrays engines over the cost models fitted
   on the card in this run (smollm-135m's ``llm-chat`` warm-up
   ``TokenCostModel`` and the fixed phase's refit ``l(b, c)``, ``c_set =
   b_set = (1, 2, 4, 8)``).  The decode-stream scan engine
   (``TokenFastSimRunner.scan_engine(chunk_steps=64)``), with static
   knobs and with ``make_sponge_decide``: ``backend="torch"`` on the card
   (each 64-step chunk one replay of the graph captured at the first
   chunk) and ``backend="numpy"``, the plain version, give bit for bit
   the same decisions, first-token and finish columns, TBT-violation
   counts, core-seconds, steps and served count on ``llm-chat`` at
   ``ENGINES["parity_s"]`` (120 s: the NumPy leg's wall); the torch
   route then serves ``llm-chat``'s default 600 s (about 15,000
   requests), every chunk after the first a replay, and a few chunks of
   it run under ``torch.profiler`` (device busy, idle share, kernels per
   chunk).  ``run_scenario(engine="fast", budget_quantum=0,
   lam_quantum=0)`` equals ``engine="exact"`` on ``steady``,
   ``mixed-slo``, ``slo-renegotiation`` and ``cancel-storm`` at 600 s
   (decisions, buckets, counts, session counts); the five plain
   scenarios run on the fast engine at their defaults, and ``llm-chat``
   at 100,000 requests on ``TokenFastSimRunner``.  Then, on the same
   refit ``l(b, c)``, the vector engine, the joint fleet and the model
   ladder (``scale_out_legs``): ``engine="vector"`` equals
   ``engine="fast"`` bit for bit on the five plain scenarios at 600 s
   and replays ``steady`` at 1,000,000 requests; the fleet's fast engine
   (quanta 0) equals its exact gang loop on ``replica-failure``,
   ``rolling-restart`` and ``fleet-flash-crowd`` at 90 s under each
   router, and ``fleet-flash-crowd`` runs at 120,000 requests on the
   reference's ``yolov5s_like`` surface and on the card fit, each beside
   the static fleet at the largest core count; the ladder's fast engine
   equals its exact one, model swaps included, on the three
   ``degrade-*`` scenarios at 60 s, and ``degrade-flash-overload`` runs
   at 300 s with the whole ladder and with fixed ``smollm-360m``.  Leg
   8, the multi-tenant pool (``tenant_legs``): the tenant fast engine
   (quanta 0) equals the exact pre-heaped oracle on ``mixed-zoo`` and
   ``mixed-zoo-rush`` under each pool policy at 60 s (pool stats,
   per-tenant reports), then ``mixed-zoo`` runs at 40,000 requests
   (the reference bench's 200,000, cut for the script's time) on the
   fast engine with the bench's policy, on the reference's tenant
   surfaces and with the chat tenant priced by the ``TokenCostModel``
   fitted on the card in this run, each printing its pool swaps and
   every tenant's violation rate and core-seconds.
   Their events per wall second are host figures.  No kernel launches
   here: the phase fails if any count is above 0.

   train  -- the training path (``repro_torch.train``), which launches
   none of the kernels (the reference's training forward reaches
   no Pallas call): every leg resets the counts before it and fails if
   any is above 0 after it.  Leg 1: f32, the reduced smollm-135m,
   rwkv6-1.6b (``rwkv_chunked``), zamba2-2.7b and deepseek-v3-671b
   (MoE, MLA, MTP): three ``make_train_step`` steps on the card and on
   the CPU from one ``init_state`` on the same ``make_batch`` batches
   (TF32 off): per-step loss, gradient norm and MTP loss within 1e-4
   relative, the final parameters within atol 1e-5 / rtol 1e-4.  Leg
   2: on the card, one gradient with ``remat`` on against off: the
   loss and every leaf within 1e-6 relative.  Leg 3, the main path:
   full-width smollm-135m (30 layers, bf16 weights, f32 moments, remat
   on), batch 8 x seq 2048, 20 steps at the launcher's ``OptConfig``
   (lr 3e-4, warmup 1) on ``synthetic_batches(seed=0)``: the first and
   last loss (the last must be lower), the median synchronised step
   wall over steps 4-20, tokens per second, the model FLOPs per step
   (the formula on its line) and their share of the bf16 dense peak,
   the peak memory; then one step profiled (device busy, idle share,
   kernels per step, the top kernels) beside CUDA-event times of the
   attention core's forward and backward at the leg's shape and of one
   AdamW update.  Leg 6: the whole state saved after step 10, restored
   into fresh tensors (every leaf ``torch.equal``, bf16 included), and
   steps 11-12 from it: losses within 1e-6 relative of the
   uninterrupted run's.  Leg 4: rwkv6-1.6b (``rwkv_chunked``) and
   zamba2-2.7b (``ssd_chunked``) at full width, bf16, remat on, batch
   2 x seq 1024, 4 steps: finite losses and norms, the median step wall,
   the peak memory.  Leg 5, f32 at full width: ``ssd_chunked`` against
   the ``ssd_scan`` kernel (B 2, T 1024, H 80, P 64, N 64, a carried
   state; 2e-4) and ``wkv6_chunked`` against the ``rwkv6_scan`` kernel
   (B 2, T 1024, H 32, D 64; 1e-4 of max |y|).

   dist  -- distribution on the card's one device: an NCCL process group
   of one rank and a 1 x 1 ``("data", "model")`` mesh.  Leg 1, a main
   path: full-width smollm-135m in bf16 with both kernel routes, its
   parameters and cache DTensors, a prefill (b 4, prompt 256) and 16
   eager greedy steps: the ids must equal the unsharded run's on the
   mesh's decode route (plain chains, cuBLAS's products), and the
   counts, reset before the sharded run and read after it, must be 30
   ``swa_prefill`` (one per layer) and 480 ``decode_attention`` (one per
   layer and step), and no fused kernel (a mesh keeps the decode step's
   plain chains): the sharded path reached the kernels through
   ``local_map``; they add to the kernels line.  Leg 2: phase ``train``
   leg 3's shape, 3 steps on the mesh against 3 unsharded from one
   ``init_state``: losses and gradient norms within 1e-6 relative, both
   step walls printed.  Leg 3: one more unsharded step counted by
   ``utils.op_cost.CostMode``: its FLOPs must equal the dry run's
   per-chip FLOPs of that shape on a 1 x 1 fake mesh; printed beside
   the H100 roofline's step time, the measured wall and device busy, and
   the mode's live-bytes peak beside ``max_memory_allocated``.  Leg 4:
   the records of two dry runs on the 16 x 16 fake mesh (smollm-135m
   train_4k, kimi-k2 decode_32k tuned).  The three dry runs are CPU
   processes started after the build, their logs under
   ``build/dryrun``.  Leg 5: ``decode_attention``'s log-sum-exp output
   (``return_lse=True``) at the six decode shapes of the kernels line,
   f32 and bf16, against the plain version's (out and lse, at ``TOL``),
   and each cache split into 2 and 4 row ranges whose calls, merged by
   their lse, give the whole-cache call; the lse variant timed beside
   the call without it (``<shape>_lse_ms`` on the kernels line).  Leg 6,
   a main path: phase ``window``'s f32 h2o-danube-1.8b run (prompt 4160
   past the 4096-token window, 16 steps over the wrapped ring) on the
   1 x 1 mesh with the cache from ``init_cache(..., seq_shard=True)``,
   so each decode runs the kernel per rank and merges by the lse: the
   ids must equal phase ``window``'s, with exactly 24 ``swa_prefill``
   and 384 ``decode_attention`` launches.  Leg 7: two examples run in
   this process on the card, ``examples/torch_serve_dynamic_slo.py``
   for 3 s (both attention kernels launched) and
   ``examples/torch_train_smollm.py`` for 3 steps (finite losses, its
   checkpoint under ``build/examples``, no kernel launched).  The phase
   prints legs 5-7's seconds.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Without a CUDA device, or outside a checkout, it prints no result
and exits non-zero.

    python3 chip_smoke.py --profile  # adds phase 7 before the last lines

7. profile -- for each of the five served models, one prefill and ten decode
   steps of the served b = 4 table entry in bf16 at the serving shape
   (prompt 256), each step's ids copied to the host as the backend does,
   run eagerly and replayed from CUDA graphs, under ``torch.profiler``:
   host wall per step, device busy time and idle share, device kernels,
   host launch calls (``cudaLaunchKernel*``, ``cudaGraphLaunch``) and
   the kernels that take the most device time, also written as
   ``profile-<arch>.json`` into the run's output directory.  For
   qwen2-vl-2b and whisper-large-v3 the phase ``models`` profiles, at b 4
   in bf16, the prefill and 10 replayed decode steps as two windows.
   Every idle share is ``1 - busy / wall``, the busy time the median of
   three profiled runs and the wall the median of three runs without
   the profiler; the raw share is printed beside their run-to-run
   spread (the two relative ranges added) and the profiled windows' own
   wall, and the share prints as 0 only where it is negative and within
   the spread.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), taken
# from src/repro_torch/utils/roofline.py by main() (``set_peaks``)
HBM_BYTES_PER_S = None
PEAK_FLOPS = None
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
N_TIMED = 60
SLEEP_CYCLES = 1_000_000                  # ~0.5 ms at the H100's clocks
RUN_CALLS = 20                            # run_ms: calls back to back

# smollm-135m's attention widths, timed at B 4, S 256 (full causal)
PREFILL = dict(B=4, S=256, H=9, KV=3, D=64,
               checks=((1, 256, 256), (4, 200, 64)))
DECODE = dict(B=4, S=321, KV=3, G=3, D=64, lengths=(0, 1, 160, 321))
# zamba2-2.7b's shared block: 32 heads of 80, window 4096 over a 321-slot
# ring buffer (lengths = min(index + 1, 321): 321 from the wrap on)
PREFILL80 = dict(B=4, S=256, H=32, KV=32, D=80, window=4096,
                 checks=((2, 77, 16),))
DECODE80 = dict(B=4, S=321, KV=32, G=1, D=80, lengths=(1, 160, 320, 321))
# one prompt of zamba2-2.7b's full window
LONG_PREFILL = dict(B=1, S=4096, H=32, KV=32, D=80, window=4096)
# gemma-2b: 8 query heads of 256 over 1 KV head (multi-query, G = 8)
PREFILL256 = dict(B=4, S=256, H=8, KV=1, D=256, checks=((2, 77, 16),))
DECODE256 = dict(B=4, S=321, KV=1, G=8, D=256, lengths=(0, 1, 160, 321))
# the decode step's fused kernels at each model's widths and the served
# gang sizes: h2o-danube-1.8b (a ring buffer), smollm-135m and gemma-2b
# (GeGLU; a full cache); timed at every B, the danube B 16 row unprefixed
FUSED_SHAPES = {
    "danube": dict(d=2560, H=32, KV=8, D=80, ff=6912, kind="swiglu",
                   window=16, S=16, index=(5, 21)),
    "smollm": dict(d=576, H=9, KV=3, D=64, ff=1536, kind="swiglu",
                   window=0, S=32, index=(5, 31)),
    "gemma": dict(d=2048, H=8, KV=1, D=256, ff=16384, kind="geglu",
                  window=0, S=32, index=(5, 31)),
}
FUSED_ROWS = (1, 8, 16)
FUSED_TOL = 1e-2
# the Mamba2 decode step's fused kernels at published Zamba2's widths (two
# groups of B and C, conv biases) and zamba2-2.7b's (one group, none), at
# FUSED_ROWS; timed at every B, the zamba2-7b B 1 row (the cell's gang)
# unprefixed
MAMBA2_FUSED = {"zamba2-7b": dict(di=7168, G=2, N=64, H=112, W=4, bias=True),
                "zamba2-2.7b": dict(di=5120, G=1, N=64, H=80, W=4,
                                    bias=False)}
# published Zamba2 (zamba2-7b) at its widths: the SSD with two groups of B
# and C (a decode step at B 16, a prefill of the chat bucket at B 4), the
# shared blocks' attention (32 heads of 224, the softmax scale (224/2)^-1/2)
# over the chat cell's full-length cache of 512 + 128 + 1 rows, their
# erf-GELU gate and the RoPE + K/V write at head_dim 224; then the model
# served through the token backend in bf16 (phase "zamba2", --only zamba2)
ZAMBA2 = dict(arch="zamba2-7b", ssd=((16, 1), (4, 512)), H=112, P=64, N=64,
              G=2, decode=dict(B=16, S=641, KV=32, G=1, D=224,
                               lengths=(1, 200, 512, 641)),
              prefill=dict(B=4, S=512, H=32, KV=32, D=224), ff=14336,
              rows=(1, 8, 16), serve=dict(requests=24, prompt_len=512,
                                          max_decode=32, seed=0),
              sets=(1, 4, 16))
# the decode steps' weight products (decode_gemm): zamba2-7b's (the merged
# in-projection, the Mamba2 out-projection, the shared block's products,
# its adapter pair and L_j, the tied head read as the (N, K) embedding) and
# h2o-danube-1.8b's, (K, (N, ...), transposed)
DECODE_GEMM = {
    "zamba2_in_proj": (3584, (14336, 256, 112), False),
    "zamba2_w_out": (7168, (3584,), False),
    "zamba2_qkv": (7168, (7168,), False),
    "zamba2_gate_up": (3584, (14336,), False),
    "zamba2_down": (14336, (3584,), False),
    "zamba2_hybrid_out": (3584, (3584,), False),
    "zamba2_adapter_a": (3584, (128,), False),
    "zamba2_adapter_b": (128, (28672,), False),
    "zamba2_head": (3584, (32000,), True),
    "danube_q_o": (2560, (2560,), False),
    "danube_kv": (2560, (640,), False),
    "danube_gate_up": (2560, (6912,), False),
    "danube_down": (6912, (2560,), False),
    "danube_head": (2560, (32000,), False),
}
# one replay of h2o-danube-1.8b's served decode step at b 16, profiled:
# its kernels per replay and per layer (chat's bucket of 512 tokens)
DECODE_GRAPH = dict(arch="h2o-danube-1.8b", b=16, prompt=512, max_decode=128,
                    replays=50)
# the same for zamba2-7b's b 1 entry, the gang of its benchmark cell
ZAMBA2_GRAPH = dict(arch="zamba2-7b", b=1, prompt=512, max_decode=128,
                    replays=50)
# h2o-danube-1.8b past its 4096-token window
WINDOW = dict(arch="h2o-danube-1.8b", prompt=4160, steps=16)
WKV = dict(B=4, T=256, H=32, D=64)        # rwkv6-1.6b prefill at the serve
SSD = dict(B=4, T=256, H=80, P=64, N=64)  # zamba2-2.7b prefill at the serve
SERVE = dict(requests=48, prompt_len=256, max_decode=64, seed=0)
# the fixed-work loop at run_live's settings (launch/serve.py)
FIXED = dict(arch="smollm-135m", c_set=(1, 2, 4, 8), b_set=(1, 2, 4, 8),
             prompt_len=64, gen_tokens=8, slo=1.0, size_kb=200.0, rps=10.0,
             duration=6.0, seed=42)
# the dynamic-SLO scenarios: the token scenarios with a declared
# decode-length distribution, served like llm-chat; the session scenarios
# and network-replay on the fixed-work server (FIXED's table and fit)
TOKEN_SCENARIOS = ("llm-heavy-tail", "retrieve-then-generate")
SESSION_SCENARIOS = ("slo-renegotiation", "cancel-storm")
SCENARIO_REQUESTS = 120
# the struct-of-arrays engines: the scan engine over llm-chat's default
# 600 s (its NumPy plain version at parity_s, the cut that keeps the
# script near half its time limit), the fast engines over the card-fit
# cost models
ENGINES = dict(arch="smollm-135m", scenario="llm-chat", seed=0,
               sets=(1, 2, 4, 8), chunk_steps=64, scan_s=600.0,
               parity_s=120.0, profile_horizon_s=3.0,
               pairs=("steady", "mixed-slo", "slo-renegotiation",
                      "cancel-storm"), token_requests=100_000)
PLAIN_SCENARIOS = ("steady", "diurnal", "flash-crowd", "network-replay",
                   "mixed-slo")
# the vector engine, the fleet and the degradation ladder (NumPy engines
# over the same card-fit l(b, c) and sets): vector == fast at vector_s,
# then steady at vector_requests (the reference's bench: 10,000,000);
# fleet fast (quanta 0) == exact at fleet_s over every router, then
# fleet-flash-crowd at fleet_requests (the reference's bench: >= 500,000)
# on the reference's yolov5s_like surface and on the card-fit one, each
# beside the static fleet at the largest core count; degrade fast ==
# exact at degrade_s, then degrade-flash-overload at degrade_compare_s
# with the whole ladder and with one fixed rung.  The request counts are
# cut so that the three legs add under a minute to the phase, and the
# whole script stays near half its time limit beside phase "train"
# (PERF.md).
SCALE_OUT = dict(vector_s=600.0, vector_requests=1_000_000,
                 fleet=("replica-failure", "rolling-restart",
                        "fleet-flash-crowd"),
                 routers=("least-loaded", "jsq", "edf-deadline"),
                 fleet_s=90.0, fleet_requests=120_000, fleet_seed=1,
                 degrade=("degrade-sustained-overload",
                          "degrade-flash-overload",
                          "degrade-fade-overload"),
                 degrade_s=60.0, degrade_compare_s=300.0,
                 fixed_rung="smollm-360m")
# the main paths: each model is checked for parity, captured and served
ARCHS = ("smollm-135m", "rwkv6-1.6b", "zamba2-2.7b", "gemma-2b",
         "h2o-danube-1.8b")
# checked for parity only (the same blocks as smollm-135m, wider)
PARITY_ONLY = ("smollm-360m",)
# the models whose bf16 path runs the attention kernels: phase 4 checks
# their bf16 routes too
BF16_PARITY = ("smollm-135m", "zamba2-2.7b", "gemma-2b", "h2o-danube-1.8b")
# the prefix and encoder models, run through the model API (the reference
# serves neither through its token backend): Qwen2-VL's 256 patch
# embeddings (a 16 x 16 grid) before a 64-token prompt, whisper's 1,500
# encoder frames beside a 16-token prompt; f32 parity over STEPS greedy
# steps, bf16 generation of GEN_STEPS steps at each b of GEN_SETS
VLM_AUDIO = {"qwen2-vl-2b": 64, "whisper-large-v3": 16}
STEPS = 16
GEN_STEPS = 64
GEN_SETS = (1, 2, 4)
# qwen2-vl-2b: 12 query heads of 128 over 2 KV heads (G 6); prefill over
# the 256 patches and the 64-token prompt, decode over its served cache
PREFILL128 = dict(B=4, S=320, H=12, KV=2, D=128)
DECODE128 = dict(B=4, S=352, KV=2, G=6, D=128, lengths=(1, 100, 321, 352))
# whisper-large-v3's decode cross-attention: 20 heads of 64 over every one
# of the 1,500 encoder rows
CROSS = dict(B=4, S=1500, KV=20, G=1, D=64, lengths=(1500,) * 4)
# the MoE family at published widths, cut in depth to one dense and one
# MoE layer (leading dense layers count once): f32 parity on an expert
# share (E / share experts per MoE layer, routed over all E, the shared
# expert counted once, the no-drop capacity factor E / k) over prefill
# of parity_prompt tokens and parity_steps teacher-forced decode steps at
# batch parity_batch; then bf16 with every expert held, captured and
# served like the other models; deepseek-v3's MTP head once over
# mtp_tokens tokens
MOE = dict(archs=("kimi-k2-1t-a32b", "deepseek-v3-671b"), share=4,
           parity_batch=2, parity_prompt=32, parity_steps=8, mtp_tokens=16)
# kimi-k2: 64 query heads of 128 over 8 KV heads (G 8); prefill over the
# 256-token prompt, decode over its served cache (256 + 64 + 1 rows)
K2_PREFILL = dict(B=4, S=256, H=64, KV=8, D=128)
K2_DECODE = dict(B=4, S=321, KV=8, G=8, D=128, lengths=(1, 100, 257, 321))
# phase "engines" leg 8: the multi-tenant pool, fast == exact on both
# zoo scenarios x the three pool policies at tenant_s, then mixed-zoo at
# tenant_requests on the fast engine (the reference bench's 200,000, cut
# for the script's time) with the bench's policy, on the reference's
# surfaces and with the chat tenant priced by the card-fit cost model
# phase "train": legs 1-2 on the reduced stacks in f32 (card against CPU,
# remat on against off), leg 3 full-width smollm-135m at 8 x 2048 for 20
# steps with the state saved after step 10 (leg 6), leg 4 rwkv6-1.6b and
# zamba2-2.7b at 2 x 1024 for 4 steps, leg 5 the chunked forms against
# the scan kernels at full width
TRAIN = dict(parity_archs=("smollm-135m-reduced", "rwkv6-1.6b-reduced",
                           "zamba2-2.7b-reduced", "deepseek-v3-671b-reduced"),
             parity_batch=2, parity_seq=32, parity_steps=3,
             main_arch="smollm-135m", main_batch=8, main_seq=2048,
             main_steps=20, ckpt_after=10,
             other_archs=("rwkv6-1.6b", "zamba2-2.7b"), other_batch=2,
             other_seq=1024, other_steps=4,
             ssd=dict(B=2, T=1024, H=80, P=64, N=64),
             wkv=dict(B=2, T=1024, H=32, D=64))
# phase "dist": distribution on the card's one device, a 1 x 1 ("data",
# "model") mesh over an NCCL group of one rank.  Leg 1: full-width
# smollm-135m in bf16 with both kernel routes, a prefill of batch x prompt
# and decode_steps eager steps under the mesh against the unsharded run;
# leg 2: TRAIN's main shape, train_steps sharded steps against as many
# unsharded; leg 3: one unsharded step of leg 2 counted by CostMode
# against the dry run of that shape on a 1 x 1 fake mesh; leg 4 the dry
# runs of ``dry`` on the 16 x 16 fake mesh.  The three dry runs are CPU
# processes, started after the build and read in the phase
DIST = dict(arch="smollm-135m", batch=4, prompt=256, decode_steps=16,
            train_steps=3, dry=(("smollm-135m", "train_4k", "baseline"),
                                ("kimi-k2-1t-a32b", "decode_32k", "tuned")),
            dry_timeout=900)
# phase "dist", legs 5-7: decode_attention's log-sum-exp output at the
# six decode shapes of the kernels line (each cache also split into
# ``lse_splits`` row ranges and merged); WINDOW's h2o-danube-1.8b run in
# f32 over a sequence-sharded cache on the 1 x 1 mesh; two examples on
# the card, the serve for ``example_serve_s`` seconds and the training
# for ``example_train_steps`` steps
DIST_LSE_SHAPES = (("", DECODE), ("d80", DECODE80), ("d256", DECODE256),
                   ("d128", DECODE128), ("cross", CROSS), ("k2", K2_DECODE))
DIST.update(lse_splits=(2, 4), example_serve_s=3.0, example_train_steps=3)
TENANT = dict(scenarios=("mixed-zoo", "mixed-zoo-rush"), tenant_s=60.0,
              seed=7, tenant_requests=40_000, bench_seed=1,
              bench_policy="greedy-marginal")


def ptxas_start():
    """One ``nvcc -Xptxas -v`` per kernel source, started at once (beside
    the build), its library thrown away; ``ptxas_report`` reads them."""
    from repro_torch.kernels import build

    out = ROOT / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    return {n: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / f"{n}.so"), str(build.CSRC / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in build.SOURCES}


def ptxas_report(procs) -> None:
    """A ``ptxas`` line per kernel instantiation: registers, spill stores
    and loads (bytes) and static shared memory (bytes), the names
    demangled with ``cu++filt -p`` (no parameter lists) where the toolkit
    has it."""
    import re
    import shutil

    entries = []
    for src, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {src}:\n{log}")
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                entries.append({"source": src, "kernel": name})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and name:
                entries[-1].update(spill_stores=int(m.group(1)),
                                   spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = re.search(r"(\d+) bytes smem", line)
                entries[-1].update(registers=int(m.group(1)),
                                   static_smem=int(smem.group(1)) if smem
                                   else 0)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if entries and Path(filt).exists():
        names = subprocess.run([filt, "-p"], input="\n".join(
            e["kernel"] for e in entries), capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()
        for e, n in zip(entries, names):
            e["kernel"] = re.sub(
                r"repro_torch::(<unnamed>|\(anonymous namespace\))::", "",
                n).replace("(int)", "")
    for e in entries:
        say("ptxas", **{k: json.dumps(v) if k == "kernel" else v
                        for k, v in e.items()})


def set_peaks() -> None:
    """The card's peaks from the port's roofline module: HBM bytes per
    second, and FLOP/s by dtype (bf16 on the tensor cores, f32 outside
    them)."""
    global HBM_BYTES_PER_S, PEAK_FLOPS
    from repro_torch.utils import roofline

    HBM_BYTES_PER_S = roofline.HBM_BW
    PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_FLOPS,
                  torch.float32: roofline.PEAK_FLOPS_F32}


def reset_launches() -> None:
    """Every count of ``utils/counters.py`` set to 0 (each kernel's
    launches among them)."""
    from repro_torch.utils import counters
    counters.reset()


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def median_ms(fn) -> float:
    """Median device time of one call, from CUDA events around each of
    ``N_TIMED`` calls, after at least 50 ms of warm-up calls (the card
    raises its clocks under load).  Each timed call is queued behind a
    device sleep of ``SLEEP_CYCLES`` (about half a millisecond), so the
    card does not wait for the host to enqueue it and the events time its
    device work, not the wrapper's host overhead; a call whose launches
    take the host longer than that to enqueue (the plain versions) is
    still timed as the host feeds it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(N_TIMED)]
    for start, end in ev:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def run_ms(fn, calls: int = None) -> float:
    """Device time a call of ``fn`` over ``calls`` (``RUN_CALLS``) calls
    back to back, as a decode step issues them: the run captured as one
    CUDA graph (so the host's enqueue is not timed), its replays timed
    by CUDA events, median of 10, each queued behind a device sleep as
    ``median_ms``'s calls."""
    calls = calls or RUN_CALLS
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end) / calls)
    return float(np.median(walls))


def check_within(name: str, out: torch.Tensor, ref: torch.Tensor,
                 tol: float) -> float:
    """Max |out - ref|; raises unless out is finite and |out - ref| <=
    tol + tol * |ref|."""
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (o - r).abs() > tol + tol * r.abs()
    err = float((o - r).abs().max())
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, "
                             f"max abs err {err} (tol {tol})")
    return err


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor,
                dtype) -> float:
    """``check_within`` at the repo's tolerance for ``dtype``."""
    return check_within(name, out, ref, TOL[dtype])


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def wkv_bound(b, t, h, d, dtype):
    """Least time for one WKV6 call: r/k/v read and y written in their
    type, w read in f32, u read and the (D, D) state read and written in
    f32, against the recurrence's 4 D^2 f32 operations per step and head
    (y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, S <- w S + k v^T)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    n = b * t * h * d
    nbytes = 4 * elt * n + 4 * n + 4 * h * d + 2 * 4 * b * h * d * d
    return nbytes, 4.0 * d * d * b * h * t


def ssd_bound(b, t, h, p, n, dtype, y_dtype):
    """Least time for one SSD call: x, B, C read in their type and y
    written in its own, dt read in f32, a_log read and the (P, N) state
    read and written in f32, against the cheaper of two ways to do the
    operations: the recurrence's 4 P N f32 operations per step and head
    (h <- a h + (dt x) B^T and y = h C) at the f32 peak, or the chunked
    form's four products per chunk of q <= 64 steps and head (C B^T,
    G' x, C h^T, x^T B': 2 q (q N + q P + 2 P N)) at the bf16
    tensor-core peak.  Returns bytes, operations and the type whose peak
    they run at."""
    elt = torch.tensor([], dtype=dtype).element_size()
    elt_y = torch.tensor([], dtype=y_dtype).element_size()
    n_x = b * t * h * p
    nbytes = ((elt + elt_y) * n_x + 4 * b * t * h + 4 * h
              + 2 * elt * b * t * n + 2 * 4 * b * h * p * n)
    recurrence = 4.0 * p * n * b * h * t
    chunked = sum(2.0 * q * (q * n + q * p + 2 * p * n) * b * h
                  for q in (min(64, t - t0) for t0 in range(0, t, 64)))
    if chunked / PEAK_FLOPS[torch.bfloat16] < recurrence / PEAK_FLOPS[torch.float32]:
        return nbytes, chunked, torch.bfloat16
    return nbytes, recurrence, torch.float32


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {name: {"name": name, "route": "cuda",
                   "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                   "replaces": replaces, "launches": None,
                   "max_abs_err": 0.0}
            for name, replaces in (
                ("swa_prefill",
                 "src/repro/kernels/swa_prefill/swa_prefill.py:75"),
                ("decode_attention",
                 "src/repro/kernels/decode_attention/decode_attention.py:68"))}
    # the least time this method reports for any launch (event and launch
    # latency), to read the small kernels' times against
    one = torch.zeros(1, device=dev)
    say("kernels", timing_floor_ms=median_ms(lambda: one.zero_()),
        timed="one-element zero_")
    attn_shape_phase(dev, gen, rows, "", prefill=PREFILL, decode=DECODE)
    attn_shape_phase(dev, gen, rows, "d80", prefill=PREFILL80,
                     decode=DECODE80)
    attn_shape_phase(dev, gen, rows, "long", prefill=LONG_PREFILL)
    attn_shape_phase(dev, gen, rows, "d256", prefill=PREFILL256,
                     decode=DECODE256)
    attn_shape_phase(dev, gen, rows, "d128", prefill=PREFILL128,
                     decode=DECODE128)
    attn_shape_phase(dev, gen, rows, "cross", decode=CROSS)
    attn_shape_phase(dev, gen, rows, "k2", prefill=K2_PREFILL,
                     decode=K2_DECODE)
    rows["rwkv6_scan"] = wkv_kernel_phase(dev, gen)
    rows["ssd_scan"] = ssd_kernel_phase(dev, gen)
    rows.update(fused_kernel_phase(dev, gen))
    rows.update(mamba2_kernel_phase(dev, gen))
    rows["decode_gemm"] = decode_gemm_phase(dev, gen)
    for r in rows.values():
        say("kernels", kernel=r["name"], ms=r["ms"], plain_ms=r["plain_ms"],
            library_ms=r["library_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"])
    return rows


# the keys ``attn_shape_phase`` times, after the shape's prefix
TIMED_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


def attn_shape_phase(dev, gen, rows, key, prefill=None, decode=None) -> None:
    """The attention kernels at one model's widths: ``prefill`` (B, S, H,
    KV, D; ``window``, S when absent: full causal; ``checks``, more
    (B, S, window) shapes checked but not timed) and ``decode`` (B, S,
    KV, G, D, lengths), each checked against its plain version in f32
    and bf16 and timed in bf16 at (B, S) beside the plain version, one
    SDPA call and the bound, under ``<key>_*`` keys of the kernels'
    rows (unprefixed for ``key`` "")."""
    from perfbench.counts import kernels as kc
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.swa_prefill import ops as pre
    import torch.nn.functional as F

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    pre_ = f"{key}_" if key else ""

    if prefill is not None:
        h, kv, d = (prefill[k] for k in ("H", "KV", "D"))
        r = rows["swa_prefill"]
        timed = (prefill["B"], prefill["S"],
                 prefill.get("window", prefill["S"]))
        for dtype in (torch.float32, torch.bfloat16):
            for b, s, w in prefill.get("checks", ()) + (timed,):
                q, k, v = (rand(b, s, n, d, dtype=dtype) for n in (h, kv, kv))
                err = check_close(
                    f"swa_prefill {key} B={b} S={s} W={w} {dtype}",
                    pre.swa_prefill_attention(q, k, v, window=w),
                    pre.swa_prefill_plain(q, k, v, window=w), dtype)
                r["max_abs_err"] = max(r["max_abs_err"], err)
                say("kernels", kernel="swa_prefill", dtype=str(dtype)[6:],
                    B=b, S=s, H=h, KV=kv, D=d, window=w, max_abs_err=err)
        b, s, w = timed                     # q, k, v: the last, bf16 draw
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bms, by = bound_ms(*kc.prefill_bound(b, s, h, kv, d, w,
                                             str(dtype)[6:])[:2], dtype)
        r.update({
            f"{pre_}ms": median_ms(
                lambda: pre.swa_prefill_attention(q, k, v, window=w)),
            f"{pre_}plain_ms": median_ms(
                lambda: pre.swa_prefill_plain(q, k, v, window=w)),
            f"{pre_}library_ms": median_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
            f"{pre_}bound_ms": bms, f"{pre_}bound_by": by,
            f"{pre_}timed": f"bf16 B={b} S={s} H={h} KV={kv} D={d} "
                            + ("full causal" if w >= s else f"window={w}")})
        say("kernels", kernel="swa_prefill",
            **{pre_ + k_: r[pre_ + k_] for k_ in TIMED_KEYS})
    if decode is not None:
        b, s, kv, g, d = (decode[k] for k in ("B", "S", "KV", "G", "D"))
        lengths = torch.tensor(decode["lengths"], dtype=torch.int32,
                               device=dev)
        r = rows["decode_attention"]
        for dtype in (torch.float32, torch.bfloat16):
            q = rand(b, kv, g, d, dtype=dtype)
            k, v = (rand(b, s, kv, d, dtype=dtype) for _ in range(2))
            err = check_close(f"decode_attention {key} {dtype}",
                              dec.decode_attention(q, k, v, lengths),
                              dec.decode_attention_plain(q, k, v, lengths),
                              dtype)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            say("kernels", kernel="decode_attention", dtype=str(dtype)[6:],
                B=b, S=s, KV=kv, G=g, D=d, lengths=list(decode["lengths"]),
                max_abs_err=err)
        qh = q.reshape(b, kv * g, 1, d)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        valid = torch.arange(s, device=dev)[None, :] < lengths[:, None].long()
        mask = torch.zeros(b, 1, 1, s, device=dev, dtype=dtype).masked_fill(
            ~valid[:, None, None, :], -1e30)
        bms, by = bound_ms(*kc.decode_bound(b, s, kv, g, d, decode["lengths"],
                                            str(dtype)[6:])[:2], dtype)
        r.update({
            f"{pre_}ms": median_ms(
                lambda: dec.decode_attention(q, k, v, lengths)),
            f"{pre_}plain_ms": median_ms(
                lambda: dec.decode_attention_plain(q, k, v, lengths)),
            f"{pre_}library_ms": median_ms(
                lambda: F.scaled_dot_product_attention(
                    qh, kt, vt, attn_mask=mask, enable_gqa=True)),
            f"{pre_}bound_ms": bms, f"{pre_}bound_by": by,
            f"{pre_}timed": f"bf16 B={b} S={s} KV={kv} G={g} D={d} "
                            f"lengths={list(decode['lengths'])}"})
        say("kernels", kernel="decode_attention",
            **{pre_ + k_: r[pre_ + k_] for k_ in TIMED_KEYS})


def fused_kernel_phase(dev, gen) -> dict:
    """The decode step's three fused kernels against their plain versions
    in bf16 (``FUSED_TOL`` relative and absolute; the residual and the V
    row exactly) at each of ``FUSED_SHAPES`` and ``FUSED_ROWS``, the K/V
    rows in their slot before and after the ring buffer wraps, a CUDA
    tensor in f32 refused; then each timed beside its plain version and
    its byte bound.  Returns their rows of the kernels line."""
    from repro_torch.kernels.add_rms_norm import ops as norm
    from repro_torch.kernels.glu_gate import ops as gate
    from repro_torch.kernels.rope_kv_write import ops as rope

    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    rows = {name: {"name": name, "route": "cuda",
                   "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                   "replaces": f"none: the reference leaves {what} to XLA",
                   "launches": None, "max_abs_err": 0.0, "library_ms": None}
            for name, what in (
                ("add_rms_norm", "the residual add and rms_norm "
                 "(src/repro/models/common.py)"),
                ("rope_kv_write", "apply_rope and the cache update "
                 "(src/repro/models/attention.py attention_decode)"),
                ("glu_gate", "the SwiGLU / GeGLU gate "
                 "(src/repro/models/mlp.py)"))}

    def check(name, out, ref):
        err = check_within(name, out, ref, FUSED_TOL)
        r = rows[name.split()[0]]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        return err

    for model, m in FUSED_SHAPES.items():
        d, h, kv, hd, ff, s = (m[k] for k in ("d", "H", "KV", "D", "ff", "S"))
        for b in FUSED_ROWS:
            tag = f"{model} B={b}"
            x, y = rand(b, 1, d), rand(b, 1, d)
            scale = rand(d, scale=0.1)
            for with_y in (True, False):
                yy = y if with_y else None
                x_new, hn = norm.add_rms_norm(x, yy, scale, 1e-5)
                rx, rh = norm.add_rms_norm_plain(x, yy, scale, 1e-5)
                if not torch.equal(x_new, rx):
                    raise AssertionError(f"add_rms_norm {tag}: residual "
                                         f"differs from x + y")
                check(f"add_rms_norm {tag} y={with_y}", hn, rh)
            g, u = rand(b, 1, ff, scale=2.0), rand(b, 1, ff)
            check(f"glu_gate {tag} {m['kind']}",
                  gate.glu_gate(g, u, m["kind"]),
                  gate.glu_gate_plain(g, u, m["kind"]))
            q, k, v = rand(b, 1, h, hd), rand(b, 1, kv, hd), rand(b, 1, kv, hd)
            ck0, cv0 = rand(b, s, kv, hd), rand(b, s, kv, hd)
            for index in m["index"]:
                idx = torch.tensor(index, dtype=torch.int32, device=dev)
                ck, cv, pk, pv = (t.clone() for t in (ck0, cv0, ck0, cv0))
                qo = rope.rope_kv_write(q, k, v, idx, ck, cv, 1e4,
                                        m["window"])
                qp = rope.rope_kv_write_plain(q, k, v, idx, pk, pv, 1e4,
                                              m["window"])
                slot = index % s if m["window"] else index
                rest = torch.arange(s, device=dev) != slot
                if not (torch.equal(cv, pv) and torch.equal(ck[:, rest],
                                                            ck0[:, rest])):
                    raise AssertionError(f"rope_kv_write {tag} index "
                                         f"{index}: V or another slot "
                                         f"differs")
                err = check(f"rope_kv_write {tag} index={index}", qo, qp)
                err = max(err, check(f"rope_kv_write {tag} K slot {slot}",
                                     ck[:, slot], pk[:, slot]))
                say("kernels", kernel="rope_kv_write", model=model, B=b,
                    S=s, window=m["window"], index=index, slot=slot,
                    max_abs_err=err)
            elt = 2
            times = {
                "add_rms_norm": (
                    lambda: norm.add_rms_norm(x, y, scale, 1e-5),
                    lambda: norm.add_rms_norm_plain(x, y, scale, 1e-5),
                    elt * (4 * b * d + d)),
                "rope_kv_write": (
                    lambda: rope.rope_kv_write(q, k, v, idx, ck, cv, 1e4,
                                               m["window"]),
                    lambda: rope.rope_kv_write_plain(q, k, v, idx, pk, pv,
                                                     1e4, m["window"]),
                    2 * elt * b * (h + 2 * kv) * hd + 4 * hd // 2 + 4),
                "glu_gate": (
                    lambda: gate.glu_gate(g, u, m["kind"]),
                    lambda: gate.glu_gate_plain(g, u, m["kind"]),
                    3 * elt * b * ff)}
            for name, (kern, plain, nbytes) in times.items():
                bms, by = bound_ms(nbytes, 0.0, bf)
                res = {"ms": median_ms(kern), "plain_ms": median_ms(plain),
                       "bound_ms": bms, "bound_by": by}
                key = f"{model}_b{b}_"
                rows[name].update({key + k_: v_ for k_, v_ in res.items()})
                if model == "danube" and b == FUSED_ROWS[-1]:
                    rows[name].update(res, timed=f"bf16 {tag}")
                say("kernels", kernel=name, model=model, B=b, **res)
    f32 = torch.zeros(2, 1, 64, device=dev)
    for name, call in (
            ("add_rms_norm", lambda: norm.add_rms_norm(
                f32, None, torch.zeros(64, device=dev), 1e-5)),
            ("glu_gate", lambda: gate.glu_gate(f32, f32, "swiglu"))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{name} took an f32 CUDA tensor")
    return rows


def mamba2_kernel_phase(dev, gen) -> dict:
    """The Mamba2 decode step's two fused kernels against their plain
    versions at each of ``MAMBA2_FUSED`` and ``FUSED_ROWS``, with the
    ``dt_bias`` / ``a_log`` / ``d_skip`` leaves in bf16 (as the benchmark
    draws them) and in f32 (the init's): ``mamba2_conv_step`` bit for bit,
    its windows shifted in place; ``mamba2_gate_norm`` within
    ``FUSED_TOL``; a CUDA tensor in f32 refused; then each timed beside
    its plain version and its byte bound.  Returns their rows of the
    kernels line."""
    from repro_torch.kernels.mamba2_conv_step import ops as conv
    from repro_torch.kernels.mamba2_gate_norm import ops as gnorm

    bf = torch.bfloat16

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    where = "(src/repro/models/mamba2.py mamba2_decode)"
    rows = {name: {"name": name, "route": "cuda",
                   "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                   "replaces": f"none: the reference leaves {what} {where} "
                               f"to XLA",
                   "launches": None, "max_abs_err": 0.0, "library_ms": None}
            for name, what in (
                ("mamba2_conv_step", "the depthwise convs, dt's softplus "
                 "and a_log's cast"),
                ("mamba2_gate_norm", "the D-skip, y * silu(z) and the "
                 "group norm"))}
    for model, m in MAMBA2_FUSED.items():
        di, g, n, h, w = (m[k] for k in ("di", "G", "N", "H", "W"))
        cbc = 2 * g * n
        for b in FUSED_ROWS:
            tag = f"{model} B={b}"
            for leaf in (bf, torch.float32):
                p = {"conv_x": rand(w, di, scale=0.5),
                     "conv_bc": rand(w, cbc, scale=0.5),
                     "dt_bias": rand(h, dtype=leaf),
                     "a_log": rand(h, scale=0.3, dtype=leaf),
                     "d_skip": rand(h, dtype=leaf),
                     "norm": rand(di, scale=0.1)}
                if m["bias"]:
                    p["conv_x_bias"] = rand(di, scale=0.1)
                    p["conv_bc_bias"] = rand(cbc, scale=0.1)
                zx, bcin = rand(b, 1, 2 * di, scale=2.0), rand(b, 1, cbc,
                                                              scale=2.0)
                dt_raw = rand(b, 1, h, scale=4.0)
                state = {"conv_x": rand(b, w - 1, di),
                         "conv_bc": rand(b, w - 1, cbc)}
                ref = {k: v.clone() for k, v in state.items()}
                got = conv.mamba2_conv_step(p, zx[..., di:], bcin, dt_raw,
                                            state, g, state)
                want = conv.mamba2_conv_step_plain(p, zx[..., di:], bcin,
                                                   dt_raw, ref, g, ref)
                if not all(torch.equal(u, v) for u, v in zip(got, want)) \
                        or not all(torch.equal(state[k], ref[k])
                                   for k in state):
                    raise AssertionError(f"mamba2_conv_step {tag} leaves "
                                         f"{leaf}: differs from its plain "
                                         f"version")
                y = rand(b, 1, h, di // h, dtype=torch.float32)
                xh = got[0].unflatten(-1, (h, -1))
                err = check_within(
                    f"mamba2_gate_norm {tag} leaves {leaf}",
                    gnorm.mamba2_gate_norm(y, xh, p["d_skip"], zx[..., :di],
                                           p["norm"], g, 1e-5),
                    gnorm.mamba2_gate_norm_plain(y, xh, p["d_skip"],
                                                 zx[..., :di], p["norm"], g,
                                                 1e-5), FUSED_TOL)
                r = rows["mamba2_gate_norm"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
            # the last draw (f32 leaves) timed: the bytes each reads and writes
            chans = di + cbc
            times = {
                "mamba2_conv_step": (
                    lambda: conv.mamba2_conv_step(p, zx[..., di:], bcin,
                                                  dt_raw, state, g, state),
                    lambda: conv.mamba2_conv_step_plain(
                        p, zx[..., di:], bcin, dt_raw, ref, g, ref),
                    2 * (2 * b * (w - 1) * chans + 2 * b * chans
                         + (w + m["bias"]) * chans + b * h)
                    + 4 * (b * h + 3 * h)),
                "mamba2_gate_norm": (
                    lambda: gnorm.mamba2_gate_norm(
                        y, xh, p["d_skip"], zx[..., :di], p["norm"], g, 1e-5),
                    lambda: gnorm.mamba2_gate_norm_plain(
                        y, xh, p["d_skip"], zx[..., :di], p["norm"], g, 1e-5),
                    4 * b * di + 2 * (3 * b * di + di) + 4 * h)}
            for name, (kern, plain, nbytes) in times.items():
                bms, by = bound_ms(nbytes, 0.0, bf)
                res = {"ms": median_ms(kern), "plain_ms": median_ms(plain),
                       "bound_ms": bms, "bound_by": by}
                rows[name].update({f"{model}_b{b}_{k_}": v_
                                   for k_, v_ in res.items()})
                if model == "zamba2-7b" and b == FUSED_ROWS[0]:
                    rows[name].update(res, timed=f"bf16 {tag}")
                say("kernels", kernel=name, model=model, B=b, G=g,
                    bias=m["bias"], **res)
    f32 = torch.zeros(1, 1, 64, device=dev)
    leaves = {"conv_x": torch.zeros(4, 32, device=dev),
              "conv_bc": torch.zeros(4, 32, device=dev),
              "dt_bias": torch.zeros(2, device=dev),
              "a_log": torch.zeros(2, device=dev)}
    win = {"conv_x": torch.zeros(1, 3, 32, device=dev),
           "conv_bc": torch.zeros(1, 3, 32, device=dev)}
    for name, call in (
            ("mamba2_conv_step", lambda: conv.mamba2_conv_step(
                leaves, f32[..., 32:], f32[..., :32], f32[..., :2], win, 1)),
            ("mamba2_gate_norm", lambda: gnorm.mamba2_gate_norm(
                f32.view(1, 1, 8, 8), f32.view(1, 1, 8, 8),
                torch.zeros(8, device=dev), f32, torch.zeros(64, device=dev),
                1, 1e-5))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{name} took an f32 CUDA tensor")
    return rows


def decode_gemm_phase(dev, gen) -> dict:
    """``decode_gemm`` against its plain version (cuBLAS's products) at
    every weight product of zamba2-7b's and h2o-danube-1.8b's decode
    steps (``DECODE_GEMM``) at ``FUSED_ROWS``, within bf16's tolerance;
    then each timed beside its byte bound, the plain version (one
    ``torch.matmul`` a weight) and, as ``library_ms``, one
    ``torch.matmul`` over the weights side by side (never called by the
    port); ``run_ms`` and ``library_run_ms`` are the kernel's and that
    call's time a call in a captured run of ``RUN_CALLS`` back to back,
    as a decode step's graph issues them (each kernel's first stages
    stream in while the one before finishes).  Every timed
    call reads weights that are not in the L2 cache: the calls rotate
    over enough copies to pass 150 MB.  Returns its row of the kernels
    line."""
    from repro_torch.kernels.decode_gemm import ops as dg

    bf = torch.bfloat16
    row = {"name": "decode_gemm", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_gemm.cu",
           "replaces": "none: the reference leaves its weight products to "
                       "XLA's dot (src/repro/models/common.py linear)",
           "launches": None, "max_abs_err": 0.0, "library_ms": None}
    for shape, (k, ns, transposed) in DECODE_GEMM.items():
        nbytes_w = 2 * k * sum(ns)
        copies = max(1, min(64, -(-150_000_000 // nbytes_w)))
        sets = [[(torch.randn(n, k, generator=gen, device=dev) * k ** -0.5)
                 .to(bf).T if transposed else
                 (torch.randn(k, n, generator=gen, device=dev) * k ** -0.5)
                 .to(bf) for n in ns] for _ in range(copies)]
        cats = [torch.cat(ws, dim=1) if len(ws) > 1 else ws[0]
                for ws in sets]
        for b in FUSED_ROWS:
            x = torch.randn(b, 1, k, generator=gen, device=dev).to(bf)
            err = 0.0
            for y, ref in zip(dg.decode_gemm(x, sets[0]),
                              dg.decode_gemm_plain(x, sets[0])):
                err = max(err, check_close(f"decode_gemm {shape} B={b}", y,
                                           ref, bf))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            turn = [0]

            def rotate(fn):
                def call():
                    turn[0] = (turn[0] + 1) % copies
                    return fn(turn[0])
                return call
            bms, by = bound_ms(nbytes_w + 2 * b * (k + sum(ns)),
                               2.0 * b * k * sum(ns), bf)
            res = {"ms": median_ms(rotate(lambda i: dg.decode_gemm(
                       x, sets[i]))),
                   "run_ms": run_ms(rotate(lambda i: dg.decode_gemm(
                       x, sets[i]))),
                   "plain_ms": median_ms(rotate(lambda i: dg.decode_gemm_plain(
                       x, sets[i]))),
                   "library_ms": median_ms(rotate(lambda i: torch.matmul(
                       x, cats[i]))),
                   "library_run_ms": run_ms(rotate(lambda i: torch.matmul(
                       x, cats[i]))),
                   "bound_ms": bms, "bound_by": by}
            res["of_bound"] = res["ms"] / bms
            res["run_of_bound"] = res["run_ms"] / bms
            row.update({f"{shape}_b{b}_{k_}": v_ for k_, v_ in res.items()})
            if shape == "zamba2_in_proj" and b == 1:
                row.update(res, timed=f"bf16 {shape} B=1")
            tile = dg.TILE_N[transposed]
            say("kernels", kernel="decode_gemm", shape=shape, K=k,
                N=json.dumps(list(ns)), transposed=transposed, B=b,
                split=dg.split_for(k, dg.tiles_of(ns, tile),
                                   dg._sms(dev.index or 0), tile),
                max_abs_err=err, **res)
        del sets, cats
    torch.cuda.empty_cache()
    return row


def wkv_inputs(gen, dev, b, t, h, d, dtype):
    """r, k, v in ``dtype``; the decay w in f32 within [0.8, 0.999), as
    the reference's kernel tests draw it; u and s0 in f32."""
    r, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).mul(0.5)
               .to(dtype) for _ in range(3))
    w = torch.rand(b, t, h, d, generator=gen, device=dev) * 0.199 + 0.8
    u = torch.randn(h, d, generator=gen, device=dev) * 0.5
    s0 = torch.randn(b, h, d, d, generator=gen, device=dev) * 0.1
    return r, k, v, w, u, s0


def wkv_kernel_phase(dev, gen):
    from repro_torch.kernels.rwkv6_scan import ops as wkv

    b, t, h, d = WKV["B"], WKV["T"], WKV["H"], WKV["D"]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for cb, ct, ch, cd in ((b, t, h, d), (b, 1, h, d), (2, 77, 3, 64),
                               (1, 300, 2, 64), (2, 77, 3, 32),
                               (1, 300, 2, 16)):
            r, k, v, w, u, s0 = wkv_inputs(gen, dev, cb, ct, ch, cd, dtype)
            y, s = wkv.rwkv6_scan(r, k, v, w, u, s0)
            y_ref, s_ref = wkv.rwkv6_scan_plain(r, k, v, w, u, s0)
            name = f"rwkv6_scan B={cb} T={ct} H={ch} D={cd} {dtype}"
            err = max(check_close(name + " y", y, y_ref, dtype),
                      check_close(name + " s_final", s, s_ref, dtype))
            worst = max(worst, err)
            say("kernels", kernel="rwkv6_scan", dtype=str(dtype)[6:], B=cb,
                T=ct, H=ch, D=cd, max_abs_err=err)
    # state continuation in f32, the second half updating its state in place
    r, k, v, w, u, s0 = wkv_inputs(gen, dev, b, t, h, d, torch.float32)
    y_full, s_full = wkv.rwkv6_scan(r, k, v, w, u, s0)
    m = t // 2
    y1, s1 = wkv.rwkv6_scan(r[:, :m].contiguous(), k[:, :m].contiguous(),
                            v[:, :m].contiguous(), w[:, :m].contiguous(),
                            u, s0)
    y2, s2 = wkv.rwkv6_scan(r[:, m:].contiguous(), k[:, m:].contiguous(),
                            v[:, m:].contiguous(), w[:, m:].contiguous(),
                            u, s1, s_out=s1)
    torch.cuda.synchronize()
    cont = max(float((torch.cat([y1, y2], 1) - y_full).abs().max()),
               float((s2 - s_full).abs().max()))
    if not (s2 is s1 and cont <= 1e-5):
        raise AssertionError(f"rwkv6_scan state continuation: max abs "
                             f"diff {cont} (atol 1e-5)")
    say("kernels", kernel="rwkv6_scan", check="state continuation f32",
        T=t, split=m, max_abs_err=cont)
    # four threads per state column keep the plain version's bits
    for dtype in (torch.float32, torch.bfloat16):
        for cd in (16, 32, 64):
            for ct in (1, 2, 17, 300):
                r, k, v, w, u, s0 = wkv_inputs(gen, dev, 2, ct, 3, cd, dtype)
                y, s = wkv.rwkv6_scan(r, k, v, w, u, s0)
                y_ref, s_ref = wkv.rwkv6_scan_plain(r, k, v, w, u, s0)
                if not (torch.equal(y, y_ref) and torch.equal(s, s_ref)):
                    raise AssertionError(f"rwkv6_scan D={cd} T={ct} {dtype}: "
                                         f"not bit for bit the plain version")
    say("kernels", kernel="rwkv6_scan", check="bit for bit, D 16/32/64 x "
        "T 1/2/17/300, f32 and bf16", equal=True)
    # timed at the serving shapes: bf16 r/k/v, f32 w; prefill T = 256 and
    # a decode step (T = 1) updating its state in place, as the model runs
    dtype = torch.bfloat16
    r, k, v, w, u, s0 = wkv_inputs(gen, dev, b, t, h, d, dtype)
    ms = median_ms(lambda: wkv.rwkv6_scan(r, k, v, w, u, s0))
    plain_ms = median_ms(lambda: wkv.rwkv6_scan_plain(r, k, v, w, u, s0))
    bms, by = bound_ms(*wkv_bound(b, t, h, d, dtype), torch.float32)
    one = [a[:, :1].contiguous() for a in (r, k, v, w)]
    state = s0.clone()
    dec_ms = median_ms(lambda: wkv.rwkv6_scan(*one, u, state, s_out=state))
    dec_bms, dec_by = bound_ms(*wkv_bound(b, 1, h, d, dtype), torch.float32)
    say("kernels", kernel="rwkv6_scan", decode_ms=dec_ms,
        decode_bound_ms=dec_bms, decode_bound_by=dec_by)
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:53",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes the WKV6 recurrence
            "library_ms": None,
            "timed": f"bf16 r/k/v, f32 w, B={b} T={t} H={h} D={d}",
            "decode_ms": dec_ms, "decode_bound_ms": dec_bms,
            "decode_bound_by": dec_by}


def ssd_inputs(gen, dev, b, t, h, p, n, dtype):
    """x, B, C in ``dtype``; dt after a softplus and a_log scaled 0.3, as
    the reference's kernel tests draw them; h0 in f32."""
    import torch.nn.functional as F

    x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn(b, t, h, generator=gen, device=dev))
    a_log = torch.randn(h, generator=gen, device=dev) * 0.3
    bm, cm = (torch.randn(b, t, n, generator=gen, device=dev).to(dtype)
              for _ in range(2))
    h0 = torch.randn(b, h, p, n, generator=gen, device=dev) * 0.1
    return x, dt, a_log, bm, cm, h0


def check_ssd(ssd, name, args, y_dtype) -> float:
    """One ``ssd_scan`` call against its plain versions.  The recurrence
    (f32, or bf16 below ``CHUNKED_MIN_T``) against ``ssd_scan_plain`` at
    the repo's tolerances; the chunked form against
    ``ssd_scan_chunked_plain`` (y 2e-2, h_final 2e-4) and against the
    recurrence at the reference's SSD bf16 tolerance (5e-2, the one
    ``tests/test_kernels.py`` holds the chunked TPU kernel to)."""
    y, hf = ssd.ssd_scan(*args, y_dtype=y_dtype)
    y_rec, h_rec = ssd.ssd_scan_plain(*args, y_dtype=y_dtype)
    if not ssd.takes_chunked_form(args[0]):
        return max(check_close(name + " y", y, y_rec, y_dtype),
                   check_close(name + " h_final", hf, h_rec, torch.float32))
    y_ch, h_ch = ssd.ssd_scan_chunked_plain(*args, y_dtype=y_dtype)
    err = max(check_within(name + " y vs chunked", y, y_ch, 2e-2),
              check_within(name + " h_final vs chunked", hf, h_ch, 2e-4))
    check_within(name + " y vs recurrence", y, y_rec, 5e-2)
    check_within(name + " h_final vs recurrence", hf, h_rec, 5e-2)
    return err


def ssd_kernel_phase(dev, gen):
    from repro_torch.kernels.ssd_scan import ops as ssd

    b, t, h, p, n = (SSD[k] for k in ("B", "T", "H", "P", "N"))
    worst = 0.0
    for dtype, y_dtype in ((torch.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16),
                           (torch.bfloat16, torch.float32)):
        for cb, ct, ch, cp, cn in ((b, t, h, p, n), (b, 1, h, p, n),
                                   (2, 77, 3, 64, 64), (1, 300, 2, 64, 64),
                                   (2, 77, 3, 32, 16), (1, 300, 2, 32, 64)):
            args = ssd_inputs(gen, dev, cb, ct, ch, cp, cn, dtype)
            name = (f"ssd_scan B={cb} T={ct} H={ch} P={cp} N={cn} {dtype} "
                    f"y {y_dtype}")
            err = check_ssd(ssd, name, args, y_dtype)
            worst = max(worst, err)
            say("kernels", kernel="ssd_scan", dtype=str(dtype)[6:],
                y_dtype=str(y_dtype)[6:], B=cb, T=ct, H=ch, P=cp, N=cn,
                route="chunked" if ssd.takes_chunked_form(args[0])
                else "recurrence", max_abs_err=err)
    # bf16 on both sides of the chunked form's threshold and its chunks
    sweep = 0.0
    for ct in (ssd.CHUNKED_MIN_T - 1, ssd.CHUNKED_MIN_T, 63, 64, 65, 77,
               256, 300):
        for cp, cn in ((32, 16), (32, 64), (64, 16), (64, 64)):
            for y_dtype in (torch.bfloat16, torch.float32):
                args = ssd_inputs(gen, dev, 2, ct, 3, cp, cn, torch.bfloat16)
                sweep = max(sweep, check_ssd(
                    ssd, f"ssd_scan bf16 T={ct} P={cp} N={cn} y {y_dtype}",
                    args, y_dtype))
    worst = max(worst, sweep)
    say("kernels", kernel="ssd_scan", check="bf16 sweep T 15..300, P 32/64, "
        "N 16/64, y bf16/f32", max_abs_err_vs_plain=sweep)
    # state continuation in f32: [0:T] against [0:T/2] then [T/2:T] with
    # the second half updating its state in place, and a decode step
    # (T = 1, y in f32) updating its state in place; then the same in
    # bf16 (chunked halves) at the reference's SSD bf16 tolerance
    for dtype, limit in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        x, dt, a_log, bm, cm, h0 = ssd_inputs(gen, dev, b, t, h, p, n, dtype)
        y_full, h_full = ssd.ssd_scan(x, dt, a_log, bm, cm, h0)
        m = t // 2
        y1, h1 = ssd.ssd_scan(*(a[:, :m].contiguous() for a in (x, dt)),
                              a_log, *(a[:, :m].contiguous() for a in (bm, cm)),
                              h0)
        y2, h2 = ssd.ssd_scan(*(a[:, m:].contiguous() for a in (x, dt)),
                              a_log, *(a[:, m:].contiguous() for a in (bm, cm)),
                              h1, h_out=h1)
        torch.cuda.synchronize()
        if h2 is not h1:
            raise AssertionError("ssd_scan state continuation: h_out ignored")
        cont = max(check_within(f"ssd_scan continuation {dtype} y",
                                torch.cat([y1, y2], 1), y_full, limit),
                   check_within(f"ssd_scan continuation {dtype} h_final",
                                h2, h_full, limit))
        say("kernels", kernel="ssd_scan", check=f"state continuation "
            f"{str(dtype)[6:]}", T=t, split=m, tol=limit, max_abs_err=cont)
    # timed at the serving shapes: bf16 x/B/C, f32 dt; prefill T = 256 (y
    # in bf16) and a decode step (T = 1, y in f32) updating its state in
    # place, as the model runs them
    dtype = torch.bfloat16
    x, dt, a_log, bm, cm, h0 = ssd_inputs(gen, dev, b, t, h, p, n, dtype)
    ms = median_ms(lambda: ssd.ssd_scan(x, dt, a_log, bm, cm, h0))
    plain_ms = median_ms(lambda: ssd.ssd_scan_plain(x, dt, a_log, bm, cm, h0))
    chunked_plain_ms = median_ms(lambda: ssd.ssd_scan_chunked_plain(
        x, dt, a_log, bm, cm, h0))
    nbytes, _, _ = ssd_bound(b, t, h, p, n, dtype, dtype)
    bms, by = bound_ms(*ssd_bound(b, t, h, p, n, dtype, dtype))
    # PR 14's bound: the recurrence's operations at the f32 peak
    rec_bms, _ = bound_ms(nbytes, 4.0 * p * n * b * h * t, torch.float32)
    one = [a[:, :1].contiguous() for a in (x, dt, bm, cm)]
    state = h0.clone()
    dec_ms = median_ms(lambda: ssd.ssd_scan(one[0], one[1], a_log, one[2],
                                            one[3], state, h_out=state,
                                            y_dtype=torch.float32))
    dec_bms, dec_by = bound_ms(*ssd_bound(b, 1, h, p, n, dtype,
                                          torch.float32))
    say("kernels", kernel="ssd_scan", decode_ms=dec_ms,
        decode_bound_ms=dec_bms, decode_bound_by=dec_by,
        chunked_plain_ms=chunked_plain_ms, recurrence_bound_ms=rec_bms)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:75",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes the SSD recurrence
            "library_ms": None,
            "timed": f"bf16 x/B/C/y, f32 dt, B={b} T={t} H={h} P={p} N={n} "
                     f"(chunked form)",
            "chunked_plain_ms": chunked_plain_ms,
            "recurrence_bound_ms": rec_bms,
            "decode_ms": dec_ms, "decode_bound_ms": dec_bms,
            "decode_bound_by": dec_by}


# ---------------------------------------------------------------------------
# model parity and serving
# ---------------------------------------------------------------------------

def zamba2_phase(dev) -> None:
    """Published Zamba2's kernel cases at zamba2-7b's shapes against their
    plain versions (``ZAMBA2``): ``ssd_scan`` with G 2 (the recurrence bit
    for bit, the chunked form as ``check_ssd``), and with G 1 as
    (B, T, 1, N) equal to the shared (B, T, N) call bit for bit;
    ``decode_attention`` and ``swa_prefill`` at D 224 with the scale (bf16
    tolerance), and at the default scale the same as passing D^-1/2 bit for
    bit; ``glu_gate``'s erf GeGLU and ``rope_kv_write`` at D 224 (bf16, as
    the fused kernels are checked); each timed beside its plain version and
    its bound.  Then zamba2-7b served through the token backend in bf16
    with a trace: every served step a replay, per decode step 81 ssd_scan
    recurrences, 13 decode_attention, 13 shared-block applications and the
    fused kernels' counts (81 ``mamba2_conv_step`` and 81
    ``mamba2_gate_norm``), per prefill 81 chunked ssd_scan and 13
    swa_prefill, and the gang caches' bytes by kind.  Last, one profiled
    replay of its b 1 decode step (``ZAMBA2_GRAPH``): its kernels per
    replay and by family, and no cuBLAS split-K reduction among them
    (every weight product a ``decode_gemm`` launch, 293 a step)."""
    from perfbench.counts import kernels as kc
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.glu_gate import ops as gate
    from repro_torch.kernels.rope_kv_write import ops as rope
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.swa_prefill import ops as pre
    from repro_torch.serving.capture import launch_counts, table_replays
    from repro_torch.serving.token_backend import (make_token_live_server,
                                                   scenario_arrivals)
    from repro_torch.serving.scenarios import build_scenario
    from repro_torch.serving.trace import ServeTrace

    gen = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16
    z = ZAMBA2
    h, p, n, g = z["H"], z["P"], z["N"], z["G"]
    for b, t in z["ssd"]:
        x, dt, a_log, _, _, h0 = ssd_inputs(gen, dev, b, t, h, p, n, bf)
        bm, cm = (torch.randn(b, t, g, n, generator=gen, device=dev).to(bf)
                  for _ in range(2))
        y_dtype = torch.float32 if t == 1 else bf
        args = (x, dt, a_log, bm, cm, h0)
        err = check_ssd(ssd, f"ssd_scan G={g} B={b} T={t}", args, y_dtype)
        one = ssd.ssd_scan(x, dt, a_log, bm[:, :, :1].contiguous(),
                           cm[:, :, :1].contiguous(), h0, y_dtype=y_dtype)
        shared = ssd.ssd_scan(x, dt, a_log, bm[:, :, 0].contiguous(),
                              cm[:, :, 0].contiguous(), h0, y_dtype=y_dtype)
        if not all(torch.equal(u, v) for u, v in zip(one, shared)):
            raise AssertionError("ssd_scan G=1 as (B, T, 1, N) differs from "
                                 "the shared (B, T, N) call")
        state = h0.clone()
        ms = median_ms(lambda: ssd.ssd_scan(x, dt, a_log, bm, cm, state,
                                            h_out=state, y_dtype=y_dtype))
        nbytes = (b * t * h * p * (2 + y_dtype.itemsize) + 4 * b * t * h
                  + 4 * h + 2 * 2 * b * t * g * n + 2 * 4 * b * h * p * n)
        bms, by = bound_ms(nbytes, 4.0 * b * t * h * p * n, bf)
        say("zamba2", kernel="ssd_scan", B=b, T=t, H=h, P=p, N=n, G=g,
            route="chunked" if ssd.takes_chunked_form(x) else "recurrence",
            max_abs_err=err, ms=ms, bound_ms=bms, bound_by=by,
            plain_ms=median_ms(lambda: ssd.ssd_scan_plain(
                x, dt, a_log, bm, cm, h0, y_dtype=y_dtype)))
    d224 = z["decode"]
    scale = 112 ** -0.5
    b, s_, kv, gq, d = (d224[k] for k in ("B", "S", "KV", "G", "D"))
    q = torch.randn(b, kv, gq, d, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(b, s_, kv, d, generator=gen, device=dev).to(bf)
            for _ in range(2))
    lengths = torch.tensor([d224["lengths"][i % 4] for i in range(b)],
                           dtype=torch.int32, device=dev)
    err = check_close("decode_attention D=224 scale",
                      dec.decode_attention(q, k, v, lengths, scale=scale),
                      dec.decode_attention_plain(q, k, v, lengths,
                                                 scale=scale), bf)
    if not torch.equal(dec.decode_attention(q, k, v, lengths),
                       dec.decode_attention(q, k, v, lengths,
                                            scale=224 ** -0.5)):
        raise AssertionError("decode_attention: the default scale differs "
                             "from D^-1/2 passed")
    nbytes, flops, _ = kc.decode_bound(b, s_, kv, gq, d, lengths.tolist(),
                                       "bfloat16")
    bms, by = bound_ms(nbytes, flops, bf)
    say("zamba2", kernel="decode_attention", B=b, S=s_, KV=kv, G=gq, D=d,
        max_abs_err=err, bound_ms=bms, bound_by=by,
        ms=median_ms(lambda: dec.decode_attention(q, k, v, lengths,
                                                  scale=scale)),
        plain_ms=median_ms(lambda: dec.decode_attention_plain(
            q, k, v, lengths, scale=scale)))
    pf = z["prefill"]
    b, s_, hq, kv, d = (pf[k] for k in ("B", "S", "H", "KV", "D"))
    q, k, v = (torch.randn(b, s_, heads, d, generator=gen, device=dev).to(bf)
               for heads in (hq, kv, kv))
    err = check_close("swa_prefill D=224 scale",
                      pre.swa_prefill_attention(q, k, v, s_, scale=scale),
                      pre.swa_prefill_plain(q, k, v, s_, scale=scale), bf)
    if not torch.equal(pre.swa_prefill_attention(q, k, v, s_),
                       pre.swa_prefill_attention(q, k, v, s_,
                                                 scale=224 ** -0.5)):
        raise AssertionError("swa_prefill: the default scale differs from "
                             "D^-1/2 passed")
    q32, k32, v32 = (t_[:1, :77].float().contiguous() for t_ in (q, k, v))
    err32 = check_close("swa_prefill D=224 f32",
                        pre.swa_prefill_attention(q32, k32, v32, 77,
                                                  scale=scale),
                        pre.swa_prefill_plain(q32, k32, v32, 77,
                                              scale=scale), torch.float32)
    bms, by = bound_ms(*kc.prefill_bound(b, s_, hq, kv, d, s_,
                                         "bfloat16")[:2], bf)
    say("zamba2", kernel="swa_prefill", B=b, S=s_, H=hq, KV=kv, D=d,
        max_abs_err=err, f32_max_abs_err=err32, bound_ms=bms, bound_by=by,
        ms=median_ms(lambda: pre.swa_prefill_attention(q, k, v, s_,
                                                       scale=scale)),
        plain_ms=median_ms(lambda: pre.swa_prefill_plain(q, k, v, s_,
                                                         scale=scale)))
    for b in z["rows"]:
        gg, u = (torch.randn(b, 1, z["ff"], generator=gen, device=dev)
                 .to(bf) for _ in range(2))
        out = gate.glu_gate(gg, u, "geglu_erf")
        if not torch.equal(out, gate.glu_gate_plain(gg, u, "geglu_erf")):
            raise AssertionError(f"glu_gate geglu_erf B={b} differs from "
                                 f"its plain version")
        qd = torch.randn(b, 1, 32, 224, generator=gen, device=dev).to(bf)
        kd, vd = (torch.randn(b, 1, 32, 224, generator=gen, device=dev)
                  .to(bf) for _ in range(2))
        ck, cv = (torch.zeros(b, 641, 32, 224, device=dev, dtype=bf)
                  for _ in range(2))
        pk, pv = ck.clone(), cv.clone()
        idx = torch.tensor(600, dtype=torch.int32, device=dev)
        err = check_within("rope_kv_write D=224",
                           rope.rope_kv_write(qd, kd, vd, idx, ck, cv, 1e4, 0),
                           rope.rope_kv_write_plain(qd, kd, vd, idx, pk, pv,
                                                    1e4, 0), FUSED_TOL)
        if not (torch.equal(cv, pv) and torch.equal(ck[:, :600], pk[:, :600])):
            raise AssertionError("rope_kv_write D=224: V or another slot "
                                 "differs")
        bms, by = bound_ms(3 * 2 * b * z["ff"], 0.0, bf)
        say("zamba2", kernel="glu_gate", kind="geglu_erf", B=b, ff=z["ff"],
            bound_ms=bms, ms=median_ms(lambda: gate.glu_gate(gg, u,
                                                             "geglu_erf")),
            plain_ms=median_ms(lambda: gate.glu_gate_plain(gg, u,
                                                           "geglu_erf")),
            rope_kv_write_max_abs_err=err)
    del q, k, v, ck, cv, pk, pv
    torch.cuda.empty_cache()

    cfg = get_config(z["arch"])
    sv, sets = z["serve"], z["sets"]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tr = ServeTrace()
    t0 = time.perf_counter()
    runner, backend, cfg, _ = make_token_live_server(
        cfg, c_set=sets, b_set=sets, prompt_len=sv["prompt_len"],
        max_decode=sv["max_decode"], clock="measured", tick=0.25,
        prior_rps=8.0, device=dev, trace=tr)
    setup_s = time.perf_counter() - t0
    batch, _ = build_scenario("llm-chat", requests=sv["requests"],
                              seed=sv["seed"], rps=8.0)
    arrivals = scenario_arrivals(batch, sv["requests"], sv["seed"],
                                 sv["prompt_len"], sv["max_decode"],
                                 cfg.vocab_size)
    counted = launch_counts()
    t0 = time.perf_counter()
    report = runner.run(arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k_: v_ - counted[k_] for k_, v_ in launch_counts().items()}
    n_pre, n_dec = len(backend.pre_table.calls), len(backend.dec_table.calls)
    apps, layers = len(cfg.hybrid_layer_ids), cfg.num_layers
    marks = tr.named("step_counts")
    per_dec = [m.attrs for m in marks
               if tr.records[m.parent].name == "sponge.decode"]
    per_pre = [m.attrs for m in marks
               if tr.records[m.parent].name == "sponge.prefill"]
    served = [rid for rid in backend.generated]
    checks = {
        "every request served": len(served) == len(arrivals),
        "every served step a graph replay":
            table_replays(backend.pre_table.fns, backend.dec_table.fns)
            >= n_pre + n_dec > 0,
        "per decode step 81 ssd_scan recurrences and 13 applications":
            len(per_dec) == n_dec and all(
                a == {"ssd_scan.recurrence": layers,
                      "shared_applications": apps} for a in per_dec),
        "per prefill 81 chunked ssd_scan and 13 applications":
            len(per_pre) == n_pre and all(
                a == {"ssd_scan.chunked": layers,
                      "shared_applications": apps} for a in per_pre),
        "ssd_scan launched 81 a step": launches["ssd_scan"]
            == layers * (n_pre + n_dec),
        "decode_attention 13 a decode step":
            launches["decode_attention"] == apps * n_dec,
        "swa_prefill 13 a prefill": launches["swa_prefill"] == apps * n_pre,
        "fused kernels a decode step": launches["add_rms_norm"]
            == (layers + 1 + 2 * apps) * n_dec
            and launches["rope_kv_write"] == apps * n_dec
            and launches["glu_gate"] == apps * n_dec,
        "mamba2_conv_step and mamba2_gate_norm 81 a decode step":
            launches["mamba2_conv_step"] == layers * n_dec
            and launches["mamba2_gate_norm"] == layers * n_dec,
        "decode_gemm 2 a Mamba2 layer, 10 an application and the head":
            launches["decode_gemm"] == decode_gemm_per_step(cfg) * n_dec,
    }
    failed = [k_ for k_, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"zamba2-7b serve checks failed: {failed} "
                             f"(launches {launches}, prefills {n_pre}, "
                             f"decode steps {n_dec})")
    for m in tr.named("setup.state_bytes"):
        say("zamba2", **{f"state_bytes_{k_}": v_ for k_, v_ in m.attrs.items()})
    dec_walls = sorted(c_[3] for c_ in backend.dec_table.calls)
    say("zamba2", arch=cfg.name, scenario="llm-chat", b_set=list(sets),
        dtype="bfloat16", **sv, setup_s=setup_s, run_wall_s=wall,
        n_requests=report.n_requests, tokens_served=report.tokens_served,
        prefills=n_pre, decode_steps=n_dec,
        decode_step_ms_median=1e3 * dec_walls[len(dec_walls) // 2],
        launches=json.dumps(launches),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del runner, backend
    gc_cuda()
    graph = decode_graph_phase(dev, ZAMBA2_GRAPH)
    if graph["split_k_reductions"]:
        raise AssertionError(f"zamba2-7b's b 1 replay ran "
                             f"{graph['split_k_reductions']} split-K "
                             f"reductions: a weight product left the "
                             f"decode_gemm route")


def parity_phase(dev, arch: str) -> None:
    from repro_torch.configs import get_config

    plain, kern = route_pair(get_config(arch), dev, "float32")
    cfg = plain.cfg
    params = kern.init(kern.generator(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, steps = 2, 256, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    vocab = cfg.vocab_size
    ref_logits, fed = [], []              # the f32 plain route's, for bf16
    with torch.inference_mode():
        lk, ck = kern.prefill(params, {"tokens": tokens}, cache_len=s + steps + 1)
        lp, cp = plain.prefill(params, {"tokens": tokens}, cache_len=s + steps + 1)
        worst = 0.0
        for step in range(steps + 1):
            ref_logits.append(lp[:, :vocab].float())
            err = float((lk - lp).abs().max())
            ids_k = lk[:, :vocab].argmax(-1)
            ids_p = lp[:, :vocab].argmax(-1)
            if not (torch.isfinite(lk).all() and err <= 1e-3
                    and torch.equal(ids_k, ids_p)):
                raise AssertionError(f"parity step {step}: max |logit diff| "
                                     f"{err}, ids {ids_k.tolist()} vs "
                                     f"{ids_p.tolist()}")
            worst = max(worst, err)
            if step == steps:
                break
            tok = ids_k.to(torch.int32)[:, None]
            fed.append(tok)
            lk, ck = kern.decode_step(params, ck, tok)
            lp, cp = plain.decode_step(params, cp, tok)
    say("parity", arch=cfg.name, dtype="float32", batch=b, prompt=s,
        decode_steps=steps, max_abs_logit_diff=worst, greedy_ids="identical",
        params=cfg.param_count(), bf16_weight_bytes=2 * cfg.param_count())
    del kern, plain, ck, cp
    if arch in BF16_PARITY:
        bf16_parity(dev, arch, params, tokens, fed, ref_logits)


def cast_like(tree, like):
    """``tree``'s tensors rounded to the dtype of the matching leaf of
    ``like`` (a tree of the same structure)."""
    if isinstance(tree, dict):
        return {key: cast_like(val, like[key]) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_like(a, b) for a, b in zip(tree, like))
    return tree.to(like.dtype)


def bf16_parity(dev, arch: str, params32, tokens, fed, ref_logits) -> None:
    """The served type at full width: the bf16 kernel route and the bf16
    plain route, each against the f32 plain route, teacher-forced with
    the f32 route's greedy ids (``fed``).  The bf16 weights are the f32
    ones rounded; a leaf that the bf16 configuration keeps in f32 stays
    f32.  Fails unless every logit is finite and max |kernel - f32| <=
    2 max |plain - f32| + 1e-2: the kernels may round differently from
    the plain versions, but not by more than bf16 itself does."""
    from repro_torch.configs import get_config

    plain, kern = route_pair(get_config(arch), dev, "bfloat16")
    cfg = plain.cfg
    params = cast_like(params32, kern.init(kern.generator(0)))
    b, s = tokens.shape
    steps, vocab = len(fed), cfg.vocab_size
    err_k = err_p = 0.0
    finite = True
    with torch.inference_mode():
        lk, ck = kern.prefill(params, {"tokens": tokens}, cache_len=s + steps + 1)
        lp, cp = plain.prefill(params, {"tokens": tokens}, cache_len=s + steps + 1)
        for step, ref in enumerate(ref_logits):
            finite = finite and bool(torch.isfinite(lk).all()
                                     and torch.isfinite(lp).all())
            err_k = max(err_k, float((lk[:, :vocab].float() - ref).abs().max()))
            err_p = max(err_p, float((lp[:, :vocab].float() - ref).abs().max()))
            if step == steps:
                break
            lk, ck = kern.decode_step(params, ck, fed[step])
            lp, cp = plain.decode_step(params, cp, fed[step])
    limit = 2 * err_p + 1e-2
    say("parity", arch=cfg.name, dtype="bfloat16", batch=b, prompt=s,
        decode_steps=steps, teacher_forced="f32 plain greedy ids",
        kernel_vs_f32=err_k, plain_vs_f32=err_p, limit=limit)
    if not (finite and err_k <= limit):
        raise AssertionError(f"bf16 parity {arch}: finite={finite}, max "
                             f"|kernel - f32| {err_k} > limit {limit} "
                             f"(max |plain - f32| {err_p})")


def route_pair(base, dev, dtype):
    """``base`` in ``dtype`` (weights too) on its plain route and on its
    kernel route: two models on ``dev``."""
    from repro_torch.models import build_model

    cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
    kcfg = dataclasses.replace(cfg, use_pallas_prefill=True,
                               use_pallas_decode=True)
    return build_model(cfg, device=dev), build_model(kcfg, device=dev)


def window_phase(dev) -> torch.Tensor:
    """Full-width h2o-danube-1.8b past its sliding window: batch 1, a
    prompt of ``WINDOW["prompt"]`` tokens (more than the 4096 of the
    window, so ``swa_prefill`` skips the key tiles outside the band and
    the prefill wraps the ring buffer of 4096 slots), then
    ``WINDOW["steps"]`` decode steps over the wrapped ring.  f32: the
    kernel route, greedy on its own ids, gives the plain route's ids and
    logits within 1e-3, with one ``swa_prefill`` per layer and one
    ``decode_attention`` per layer and step.  bf16 (the weights rounded):
    both routes, teacher-forced with the f32 plain route's ids, give the
    same greedy id at every step, and the kernel route's logits keep
    ``bf16_parity``'s rule against the f32 plain route.  Returns the f32
    greedy ids (on the host), which phase ``dist`` leg 6 reproduces over
    a sequence-sharded cache."""
    from repro_torch.configs import get_config
    from repro_torch.serving.capture import launch_counts

    arch, s, steps = WINDOW["arch"], WINDOW["prompt"], WINDOW["steps"]
    base = get_config(arch)
    window, layers = base.window_size, base.num_layers
    if not 0 < window < s:
        raise AssertionError(f"{arch}: window {window} not below prompt {s}")
    cache_len = s + steps + 1

    def run(model, params, tokens, feed=None):
        """``greedy_run`` on the batch of one: each step's logits, its
        greedy id and the ring's slots."""
        logits, ids, cache = greedy_run(model, params, {"tokens": tokens},
                                        steps, cache_len, feed)
        return logits[:, 0], ids[:, 0], cache["k"].shape[2]

    plain, kern = route_pair(base, dev, "float32")
    params = kern.init(kern.generator(0))
    gen = torch.Generator(device=dev).manual_seed(6)
    tokens = torch.randint(0, base.vocab_size, (1, s), generator=gen,
                           device=dev, dtype=torch.int32)
    ref, ids_ref, ring = run(plain, params, tokens)
    reset_launches()
    lk, ids_k, _ = run(kern, params, tokens)
    torch.cuda.synchronize()
    launches = launch_counts()
    err32 = float((lk - ref).abs().max())
    checks = {
        "ring of window slots": ring == window,
        "f32 logits finite": bool(torch.isfinite(lk).all()),
        "f32 greedy ids identical": torch.equal(ids_k, ids_ref),
        "f32 max |logit diff| <= 1e-3": err32 <= 1e-3,
        "swa_prefill once per layer":
            launches["swa_prefill"] == layers,
        "decode_attention once per layer per step":
            launches["decode_attention"] == layers * steps}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"window f32 checks failed: {failed} (max "
                             f"|logit diff| {err32}, launches {launches})")
    say("window", arch=arch, dtype="float32", batch=1, prompt=s,
        window=window, ring_slots=ring, decode_steps=steps,
        max_abs_logit_diff=err32, greedy_ids="identical",
        launches=json.dumps(launches))
    del plain, kern
    torch.cuda.empty_cache()

    plain, kern = route_pair(base, dev, "bfloat16")
    params = cast_like(params, kern.init(kern.generator(0)))
    torch.cuda.empty_cache()
    feed = ids_ref[:steps]
    lk, ids_k, _ = run(kern, params, tokens, feed)
    lp, ids_p, _ = run(plain, params, tokens, feed)
    err_k = float((lk - ref).abs().max())
    err_p = float((lp - ref).abs().max())
    limit = 2 * err_p + 1e-2
    top2 = lp.topk(2, dim=-1).values
    say("window", arch=arch, dtype="bfloat16", batch=1, prompt=s,
        window=window, ring_slots=ring, decode_steps=steps,
        teacher_forced="f32 plain greedy ids", kernel_vs_f32=err_k,
        plain_vs_f32=err_p, limit=limit,
        kernel_vs_plain=float((lk - lp).abs().max()),
        plain_min_top2_gap=float((top2[:, 0] - top2[:, 1]).min()),
        ids_kernel=ids_k.tolist(), ids_plain=ids_p.tolist(),
        ids_f32=ids_ref.tolist())
    if not (torch.isfinite(lk).all() and err_k <= limit
            and torch.equal(ids_k, ids_p)):
        raise AssertionError(f"window bf16: max |kernel - f32| {err_k} "
                             f"(limit {limit}), ids {ids_k.tolist()} vs "
                             f"{ids_p.tolist()}")
    return ids_ref.cpu()


def vlm_audio_batch(cfg, b, prompt, dev, seed):
    """One batch of the prefix and encoder models from a seed: ``prompt``
    tokens; for Qwen2-VL 256 patch embeddings (the reference's data
    pipeline's scale, 0.02) with M-RoPE ids t = sequence index, h and w
    the patch's row and column in the 16 x 16 grid, then the sequence
    index for the text (the temporal ids rise in sequence order, so the
    kernel route, causal in sequence order, and the plain route, masked
    by the temporal ids, compute the same function); for whisper (B,
    1500, 1280) frame embeddings."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    p = cfg.num_patch_tokens
    if p:
        batch["prefix_embeds"] = 0.02 * torch.randn(
            b, p, cfg.d_model, generator=gen, device=dev)
        side = math.isqrt(p)
        pos = torch.arange(p + prompt, device=dev).repeat(3, b, 1)
        pos[1, :, :p] = torch.arange(p, device=dev) // side
        pos[2, :, :p] = torch.arange(p, device=dev) % side
        batch["mrope_positions"] = pos.to(torch.int32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = 0.02 * torch.randn(
            b, cfg.encoder_seq_len, cfg.d_model, generator=gen, device=dev)
    return batch


def batch_rows(batch, b):
    """The first ``b`` rows of a batch (the M-RoPE ids' batch axis is 1)."""
    return {k: v[:, :b] if k == "mrope_positions" else v[:b]
            for k, v in batch.items()}


def next_mrope(batch, step):
    """(3, B, 1) M-RoPE ids of decode step ``step``: the text goes on
    from the largest id of the sequence; None without M-RoPE."""
    pos = batch.get("mrope_positions")
    if pos is None:
        return None
    b = pos.shape[1]
    first = pos.amax(dim=(0, 2)).view(1, b, 1) + 1
    return (first + step).expand(3, b, 1).to(torch.int32).contiguous()


def greedy_run(model, params, batch, steps, cache_len, feed=None):
    """Prefill and ``steps`` decode steps, greedy on the model's own ids
    or fed ``feed`` (one id per row, or a scalar for batch 1), each
    step's M-RoPE ids given (``next_mrope``): every step's logits (f32,
    real vocabulary), its greedy ids and the cache."""
    vocab = model.cfg.vocab_size
    logits = []
    with torch.inference_mode():
        lg, cache = model.prefill(params, batch, cache_len=cache_len)
        for step in range(steps + 1):
            logits.append(lg[:, :vocab].float())
            if step == steps:
                break
            tok = (logits[-1].argmax(-1) if feed is None
                   else feed[step]).to(torch.int32).view(-1, 1)
            lg, cache = model.decode_step(params, cache, tok,
                                          next_mrope(batch, step))
    logits = torch.stack(logits)
    return logits, logits.argmax(-1), cache


def vlm_audio_phase(dev, arch: str, profile: bool):
    """One prefix or encoder model at full width through the model API
    (``prefill``, ``decode_step(mrope_positions=...)``).  f32: the
    kernel route against the plain route over a prefill and ``STEPS``
    greedy steps (at the main path's batch, ``max(GEN_SETS)``, and cache
    length, so the kernels run at the main path's shapes; logits within
    1e-3, identical ids), with one
    ``swa_prefill`` per layer per prefill and one ``decode_attention``
    per layer per step (two for whisper: self- and cross-attention).
    bf16: both routes teacher-forced with the f32 plain route's ids,
    under ``bf16_parity``'s rule.  Then the main path, bf16 on the kernel
    route, counts reset before it and read after: the prefill wall at b
    = 4 (whisper's encoder also alone), and at each b of ``GEN_SETS`` a
    greedy generation of ``GEN_STEPS`` steps eager and through one
    captured decode graph (the ids and the M-RoPE ids in static tensors
    that the step advances on the device), whose ids must be equal; the
    b = 4 generation, prefill included, gives tokens per wall second.
    Returns the main path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.capture import CapturedStep, launch_counts

    base = get_config(arch)
    prompt = VLM_AUDIO[arch]
    layers = base.num_layers
    per_step = layers * (2 if base.is_encoder_decoder else 1)
    s_total = base.num_patch_tokens + prompt

    def expect(launches, prefills, steps, fused=False):
        """Exact counts; ``fused``: bf16 steps, with the fused kernels."""
        want = {"swa_prefill": prefills * layers,
                "decode_attention": steps * per_step,
                "rwkv6_scan": 0, "ssd_scan": 0,
                **{k: steps * n if fused else 0
                   for k, n in fused_per_step(base).items()}}
        if launches != want:
            raise AssertionError(f"{arch}: launches {launches}, expected "
                                 f"{want}")

    # -- f32 parity, kernel route against plain route
    plain, kern = route_pair(base, dev, "float32")
    params = kern.init(kern.generator(0))
    b_max = max(GEN_SETS)
    batch = vlm_audio_batch(base, b_max, prompt, dev, 1)
    cache_len = s_total + GEN_STEPS + 1
    reset_launches()
    lp, ids_p, _ = greedy_run(plain, params, batch, STEPS, cache_len)
    expect(launch_counts(), 0, 0)
    reset_launches()
    lk, ids_k, _ = greedy_run(kern, params, batch, STEPS, cache_len)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect(launches, 1, STEPS)
    err32 = float((lk - lp).abs().max())
    if not (torch.isfinite(lk).all() and err32 <= 1e-3
            and torch.equal(ids_k, ids_p)):
        raise AssertionError(f"{arch} f32: max |logit diff| {err32}, ids "
                             f"{ids_k.tolist()} vs {ids_p.tolist()}")
    say("models", arch=arch, dtype="float32", batch=b_max,
        cache_len=cache_len,
        prefix=base.num_patch_tokens, prompt=prompt,
        encoder_frames=base.encoder_seq_len, decode_steps=STEPS,
        max_abs_logit_diff=err32, greedy_ids="identical",
        launches=json.dumps(launches), params=base.param_count())
    del plain, kern
    torch.cuda.empty_cache()

    # -- bf16, both routes teacher-forced with the f32 plain route's ids
    plain, kern = route_pair(base, dev, "bfloat16")
    params = cast_like(params, kern.init(kern.generator(0)))
    torch.cuda.empty_cache()
    feed = ids_p[:STEPS]
    lk16, ids_k16, _ = greedy_run(kern, params, batch, STEPS, cache_len,
                                  feed)
    lp16, ids_p16, _ = greedy_run(plain, params, batch, STEPS, cache_len,
                                  feed)
    err_k = float((lk16 - lp).abs().max())
    err_p = float((lp16 - lp).abs().max())
    limit = 2 * err_p + 1e-2
    say("models", arch=arch, dtype="bfloat16", batch=b_max,
        teacher_forced="f32 plain greedy ids", kernel_vs_f32=err_k,
        plain_vs_f32=err_p, limit=limit,
        kernel_vs_plain=float((lk16 - lp16).abs().max()),
        ids_kernel_equal_plain=bool(torch.equal(ids_k16, ids_p16)))
    if not (torch.isfinite(lk16).all() and err_k <= limit):
        raise AssertionError(f"{arch} bf16: max |kernel - f32| {err_k} > "
                             f"limit {limit}")
    del plain, lk, lp, lk16, lp16
    torch.cuda.empty_cache()

    # -- the main path: bf16 generation on the kernel route
    model, vocab = kern, base.vocab_size
    cfg = model.cfg
    batch4 = vlm_audio_batch(cfg, max(GEN_SETS), prompt, dev, 2)
    reset_launches()
    prefills = steps = 0

    def walls(fn, n=5):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    res = {}
    with torch.inference_mode():
        pre = walls(lambda: model.prefill(params, batch4,
                                          cache_len=cache_len), 6)[1:]
        prefills += 6
        res["prefill_b4_ms"] = float(np.median(pre)) * 1e3
        if cfg.is_encoder_decoder:
            enc = batch4["enc_embeds"].to(torch.bfloat16)
            ew = walls(lambda: api._encoder_fwd(params, cfg, enc), 6)[1:]
            res["encoder_b4_ms"] = float(np.median(ew)) * 1e3
            res["encoder_share_of_prefill"] = (res["encoder_b4_ms"]
                                               / res["prefill_b4_ms"])
    for b in GEN_SETS:
        rows_b = batch_rows(batch4, b)
        with torch.inference_mode():
            cache = model.init_cache(b, cache_len)
            ids = torch.zeros(b, dtype=torch.int32, device=dev)
            first = next_mrope(rows_b, 0)
            mpos = None if first is None else first.clone()
            got = torch.zeros(GEN_STEPS + 1, b, dtype=torch.int32,
                              device=dev)

        def start():
            lg, _ = model.prefill(params, rows_b, cache=cache)
            ids.copy_(lg[:, :vocab].argmax(-1))
            if mpos is not None:
                mpos.copy_(first)

        def body():
            lg, _ = model.decode_step(params, cache, ids[:, None], mpos)
            ids.copy_(lg[:, :vocab].argmax(-1))
            if mpos is not None:
                mpos.add_(1)
            return lg

        static = (ids,) if mpos is None else (ids, mpos)
        runs = {}
        for capture in (False, True):
            step = CapturedStep(body, static, capture)
            with torch.inference_mode():
                if capture:                 # warm-up: eager run + capture
                    start()
                    step(*static)
                    prefills, steps = prefills + 1, steps + 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start()
                got[0].copy_(ids)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for i in range(GEN_STEPS):
                    step(*static)
                    got[i + 1].copy_(ids)
                host_ids = got.cpu()
                t2 = time.perf_counter()
            prefills, steps = prefills + 1, steps + GEN_STEPS
            if capture and step.replays != GEN_STEPS:
                raise AssertionError(f"{arch} b={b}: {step.replays} replays")
            runs[capture] = host_ids
            route = "captured" if capture else "eager"
            res[f"b{b}_{route}_step_ms"] = (t2 - t1) / GEN_STEPS * 1e3
            res[f"b{b}_{route}_tokens_per_s"] = b * GEN_STEPS / (t2 - t0)
        if not torch.equal(runs[False], runs[True]):
            raise AssertionError(f"{arch} b={b}: replayed ids "
                                 f"{runs[True].tolist()} differ from eager "
                                 f"ids {runs[False].tolist()}")
        if not ((runs[True] >= 0) & (runs[True] < vocab)).all():
            raise AssertionError(f"{arch} b={b}: ids out of the vocabulary")
    torch.cuda.synchronize()
    launches = launch_counts()
    expect(launches, prefills, steps, fused=True)
    say("models", arch=arch, dtype="bfloat16", route="kernel",
        gen_steps=GEN_STEPS, b_set=list(GEN_SETS), cache_len=cache_len,
        ids="replayed == eager", **res)
    say("models", arch=arch, prefills=prefills, decode_steps=steps,
        launches=json.dumps(launches))
    if profile:                             # the b = GEN_SETS[-1] gang
        windows = {"prefill": profiled(start),
                   "10 replayed decode steps": profiled(
                       lambda: [step(*static) for _ in range(10)],
                       setup=start)}
        for window, res in windows.items():
            say("profile", arch=arch, batch=b, window=window,
                **{k: v for k, v in res.items() if k != "top_kernels"})
            for r in res["top_kernels"]:
                say("profile", arch=arch, window=window, **r)
    return launches


def moe_cut(arch: str):
    """``arch`` at its published widths, cut in depth to one whole period
    of its layer pattern: its first (dense) block and its last (MoE)
    block, ``first_k_dense`` 1.  Returns the config and the cuts."""
    from repro_torch.configs import get_config

    base = get_config(arch)
    cfg = dataclasses.replace(
        base, name=f"{base.name}-2layer", num_layers=2,
        blocks=base.blocks[:1] + base.blocks[-1:],
        first_k_dense=min(base.first_k_dense, 1))
    reduced = {"num_layers": [base.num_layers, 2],
               "blocks": [f"{base.blocks[0]} x {base.first_k_dense} + "
                          f"{base.blocks[-1]} x "
                          f"{base.num_layers - base.first_k_dense}",
                          " + ".join(cfg.blocks)],
               "first_k_dense": [base.first_k_dense, 1]}
    return cfg, reduced


def expert_bytes(cfg) -> int:
    """Bytes of the routed experts' weights of the served MoE layers
    (the MTP head's block is not served), in the config's type."""
    elt = 2 if cfg.param_dtype == "bfloat16" else 4
    moe_layers = sum(b.endswith("+moe") for b in cfg.blocks)
    return moe_layers * cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff * elt


def moe_parity(dev, cfg, arch_reduced) -> None:
    """f32 on an expert share: every MoE layer (the MTP block's too)
    holds E / share experts, routes over all E and carries the shared
    expert; the capacity factor is the no-drop E / k.  Prefill then
    teacher-forced decode steps against the no-cache forward (the
    experts sum in another order there: held at the reference's MoE
    tolerance, 1e-4 of the logits' scale), and for an attention stack
    the kernel route against the plain route (the same expert products:
    held at 2e-5 of the scale, ids identical)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cfg32 = dataclasses.replace(cfg, moe_capacity_factor=e / k)
    plain, kern = route_pair(cfg32, dev, "float32")
    share = e // MOE["share"]
    torch.cuda.reset_peak_memory_stats()
    params = kern.init(kern.generator(0), experts=(0, share))
    b, s, steps = MOE["parity_batch"], MOE["parity_prompt"], MOE["parity_steps"]
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, s + steps), generator=gen,
                         device=dev, dtype=torch.int32)
    attention = "mla" not in cfg.mixer_kinds
    with torch.inference_mode():
        full, aux = plain.forward(params, {"tokens": toks})
        scale = float(full.abs().max())
        runs = {}
        for route, model in (("plain", plain), ("kernel", kern)):
            if route == "kernel" and not attention:
                break
            lg, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                      cache_len=s + steps + 1)
            out = [lg]
            for i in range(s, s + steps):
                lg, cache = model.decode_step(params, cache, toks[:, i:i + 1])
                out.append(lg)
            runs[route] = torch.stack(out, 1)       # positions s-1 .. s+steps-1
            del cache
        ref = full[:, s - 1:]
        err_fwd = float((runs["plain"] - ref).abs().max())
        checks = {"logits finite": bool(torch.isfinite(full).all()),
                  "aux finite and positive": math.isfinite(float(aux))
                  and float(aux) > 0,
                  "prefill + decode == forward (1e-4 of the scale)":
                      err_fwd <= 1e-4 * scale,
                  "greedy ids == forward's": torch.equal(
                      runs["plain"].argmax(-1), ref.argmax(-1))}
        err_route = None
        if attention:
            err_route = float((runs["kernel"] - runs["plain"]).abs().max())
            checks["kernel route == plain route (2e-5 of the scale)"] = \
                err_route <= 2e-5 * scale
            checks["kernel route ids identical"] = torch.equal(
                runs["kernel"].argmax(-1), runs["plain"].argmax(-1))
    failed = [c for c, ok in checks.items() if not ok]
    say("moe", arch=cfg.name, dtype="float32", experts_held=share,
        experts_routed=e, shared_expert="held", capacity_factor=e / k,
        batch=b, prompt=s, decode_steps=steps, logit_scale=scale,
        max_abs_diff_vs_forward=err_fwd,
        rel_diff_vs_forward=err_fwd / scale,
        max_abs_diff_kernel_vs_plain=err_route,
        rel_diff_kernel_vs_plain=None if err_route is None
        else err_route / scale, aux=float(aux),
        tolerance="forward 1e-4 of the scale (experts sum), kernel vs "
                  "plain 2e-5 of the scale",
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        reduced=json.dumps(arch_reduced))
    if failed:
        raise AssertionError(f"{cfg.name} f32 share parity failed: {failed}")


def moe_phase(dev, arch: str) -> dict:
    """Phase ``moe``: ``arch`` at published widths, cut to two layers
    (``moe_cut``).  f32 parity on an expert share (``moe_parity``); then
    bf16 with every expert held and both kernel routes on: eager against
    replayed steps (ids identical, ``capture_phase``), the llm-chat
    serve through the captured tables with its counts reset before and
    read after (``serve_phase``: the main path), the b = 4 entry's
    prefill wall, decode-step host wall eager and captured and idle
    share (``profile_phase``) beside the expert-bytes floor of a decode
    step, peak memory, and for deepseek-v3 one ``mtp_logits`` call.
    Returns the serve's launches."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg, cuts = moe_cut(arch)
    moe_parity(dev, cfg, cuts)
    gc_cuda()
    kcfg = dataclasses.replace(cfg, use_pallas_prefill=True,
                               use_pallas_decode=True)
    model = build_model(kcfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tensors_of(params))
    say("moe", arch=cfg.name, dtype="bfloat16", experts_held=cfg.num_experts,
        weight_gib=weights / 2**30, init_s=time.perf_counter() - t_init,
        init_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        capacity_factor=cfg.moe_capacity_factor)
    capture_phase(dev, cfg.name, model, params)
    gc_cuda()
    launches, _ = serve_phase(dev, kcfg, params=params)
    gc_cuda()
    prof = profile_phase(dev, cfg.name, model, params)
    gc_cuda()
    floor_ms = expert_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    if cfg.mtp_depth:
        gen = torch.Generator(device=dev).manual_seed(7)
        toks = torch.randint(0, cfg.vocab_size, (1, MOE["mtp_tokens"]),
                             generator=gen, device=dev, dtype=torch.int32)
        with torch.inference_mode():
            hidden, _ = model.forward_hidden(params, {"tokens": toks})
            logits, aux = model.mtp_logits(params, hidden, toks)
        want = (1, MOE["mtp_tokens"] - 1, cfg.padded_vocab)
        ok = tuple(logits.shape) == want and bool(torch.isfinite(logits).all())
        say("moe", arch=cfg.name, mtp_logits_shape=list(logits.shape),
            expected=list(want), finite=ok, mtp_aux=float(aux))
        if not ok:
            raise AssertionError(f"{cfg.name} mtp_logits: shape "
                                 f"{tuple(logits.shape)} (want {want}) or "
                                 "not finite")
    say("moe", arch=cfg.name, dtype="bfloat16", batch=4,
        prefill_wall_ms=prof["captured"]["prefill_wall_ms"],
        prefill_wall_eager_ms=prof["eager"]["prefill_wall_ms"],
        decode_step_wall_eager_ms=prof["eager"]["decode_step_wall_ms"],
        decode_step_wall_captured_ms=prof["captured"]["decode_step_wall_ms"],
        expert_bytes_floor_ms=floor_ms,
        expert_gib_per_step=expert_bytes(cfg) / 2**30,
        device_idle_share_captured=prof["captured"]["device_idle_share"],
        device_idle_share_eager=prof["eager"]["device_idle_share"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        seconds=time.perf_counter() - t0)
    del model, params
    gc_cuda()
    return launches


def tensors_of(tree):
    """Every tensor of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def gc_cuda() -> None:
    """Collect what went out of scope (graphs, tables, caches) and hand
    the cached blocks back, before the next large model is built."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def logit_steps(model, params, b, prompt_len, cache_len, capture):
    """The served prefill and decode steps of one static gang (as
    ``build_token_step_fns`` builds them), each also returning its
    logits: two ``CapturedStep`` entries and the gang's id buffer."""
    from repro_torch.serving.capture import CapturedStep

    vocab, dev = model.cfg.vocab_size, model.device
    with torch.inference_mode():
        cache = model.init_cache(b, cache_len)
        tokens = torch.zeros((b, prompt_len), dtype=torch.int32, device=dev)
        ids = torch.zeros((b,), dtype=torch.int32, device=dev)

    def prefill():
        lg, _ = model.prefill(params, {"tokens": tokens}, cache=cache)
        ids.copy_(lg[:, :vocab].argmax(-1))
        return lg

    def decode():
        lg, _ = model.decode_step(params, cache, ids[:, None])
        ids.copy_(lg[:, :vocab].argmax(-1))
        return lg

    return (CapturedStep(prefill, (tokens,), capture),
            CapturedStep(decode, (ids,), capture), ids)


def capture_phase(dev, arch: str, model=None, params=None) -> None:
    """Eager steps against replayed CUDA graphs on the served path: bf16,
    b 4, prompt 256, 10 decode steps, the served cache length, both
    routes warmed first as the tables are (which captures the graphs);
    ids must be identical, the largest logit difference is printed.
    ``model`` and ``params`` (both kernel routes on) are built from
    ``arch`` unless given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if model is None:
        cfg = dataclasses.replace(get_config(arch), use_pallas_prefill=True,
                                  use_pallas_decode=True)
        model = build_model(cfg, device=dev)
        params = model.init(model.generator(0))
    cfg = model.cfg
    b, pl, steps = 4, SERVE["prompt_len"], 10
    cache_len = pl + SERVE["max_decode"] + 1
    gen = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (b, pl), generator=gen,
                           device=dev, dtype=torch.int32)
    runs, replays = {}, 0
    for capture in (False, True):
        pre_step, dec_step, ids = logit_steps(model, params, b, pl,
                                              cache_len, capture)
        pre_step(torch.zeros_like(tokens))      # warm-up: the capture
        dec_step(ids)
        logits, got = [pre_step(tokens).float().clone()], [ids.clone()]
        for _ in range(steps):
            logits.append(dec_step(ids).float().clone())
            got.append(ids.clone())
        runs[capture] = (torch.stack(logits), torch.stack(got))
        replays += pre_step.replays + dec_step.replays
    (le, ie), (lc, ic) = runs[False], runs[True]
    diff = float((lc - le).abs().max())
    if not (torch.isfinite(lc).all() and torch.equal(ic, ie)
            and replays == steps + 1):
        raise AssertionError(f"{arch}: replayed ids {ic.tolist()} differ from "
                             f"eager ids {ie.tolist()} (max |logit diff| "
                             f"{diff}, {replays} replays)")
    say("capture", arch=cfg.name, dtype="bfloat16", batch=b, prompt=pl,
        decode_steps=steps, cache_len=cache_len, graphs=2, replays=replays,
        ids="identical", max_abs_logit_diff=diff)


FUSED = ("add_rms_norm", "rope_kv_write", "glu_gate", "mamba2_conv_step",
         "mamba2_gate_norm", "decode_gemm")


def decode_gemm_per_step(cfg) -> int:
    """``decode_gemm``'s launches in one bf16 decode step of ``cfg`` on
    the card's kernel route (``models.common.decode_linear``): q, k, v
    and o of each GQA attention, a Mamba2 mixer's in-projections (one
    launch) and ``w_out``, an MLP's gate, up and down (up and down of a
    GELU one), the products of each zamba2 shared-block application (10
    in published Zamba2: its attention, the adapter pair, the MLP and
    ``L_j``), and the head.  MLA, the MoE experts, RWKV-6's mixers and
    cross-attention keep cuBLAS."""
    mlp = 3 if cfg.mlp_kind in ("swiglu", "geglu", "geglu_erf") else 2
    n = 1
    for kind in cfg.blocks:
        mixer, ffn = kind.split("+")
        n += {"attn": 4, "swa": 4, "mamba2": 2}.get(mixer, 0)
        n += mlp if ffn == "mlp" else 0
    if cfg.published_hybrid:
        n += 10 * len(cfg.hybrid_layer_ids)
    elif cfg.shared_attn_every:
        n += (4 + mlp) * -(-cfg.num_layers // cfg.shared_attn_every)
    return n


def fused_per_step(cfg) -> dict:
    """The decode-route kernels' launches in one bf16 decode step of
    ``cfg`` on the card's kernel route (``transformer.fused_decode``): a
    norm before each mixer, cross-attention and feed-forward, and the
    final norm; the RoPE + KV write of each standard-RoPE attention; the
    gate of each SwiGLU / GeGLU MLP; the conv step and the gated norm of
    each Mamba2 mixer; zamba2's shared block adds two norms, its
    attention and its MLP per application; ``decode_gemm_per_step``
    weight products."""
    glu = cfg.mlp_kind in ("swiglu", "geglu")
    rope = cfg.rope_kind == "standard"
    n = {"add_rms_norm": 1, "rope_kv_write": 0, "glu_gate": 0,
         "mamba2_conv_step": 0, "mamba2_gate_norm": 0,
         "decode_gemm": decode_gemm_per_step(cfg)}
    for kind in cfg.blocks:
        mixer, ffn = kind.split("+")
        n["add_rms_norm"] += (1 + (ffn != "none")
                              + int(cfg.is_encoder_decoder))
        n["rope_kv_write"] += int(rope and mixer in ("attn", "swa"))
        n["glu_gate"] += int(glu and ffn == "mlp")
        n["mamba2_conv_step"] += int(mixer == "mamba2")
        n["mamba2_gate_norm"] += int(mixer == "mamba2")
    if cfg.shared_attn_every:
        apps = -(-cfg.num_layers // cfg.shared_attn_every)
        n["add_rms_norm"] += 2 * apps
        n["rope_kv_write"] += apps * rope
        n["glu_gate"] += apps * glu
    return n


def fused_checks(cfg, launches, steps=None) -> dict:
    """Checks that the bf16 decode steps since the counts' reset (``steps``
    of them; None: as many as ``add_rms_norm``'s count gives) launched
    exactly ``fused_per_step`` of each fused kernel a step."""
    per = fused_per_step(cfg)
    if steps is None:
        steps = launches["add_rms_norm"] // per["add_rms_norm"]
    return {f"{name} launched {n} times a decode step":
                steps > 0 and launches[name] == n * steps
            for name, n in per.items()}


def serve_phase(dev, arch, scenario: str = "llm-chat", sets=(1, 2, 4),
                params=None):
    """``run_token_scenario`` on ``arch`` (a registry id, or a
    ``ModelConfig`` such as an MoE model cut in depth) with random
    weights, or ``params``; the served checks; returns the launches and
    the warm-up cost model."""
    from repro_torch.configs import get_config
    from repro_torch.serving.capture import launch_counts
    from repro_torch.serving.token_backend import run_token_scenario

    cfg = get_config(arch) if isinstance(arch, str) else arch
    vocab = cfg.vocab_size
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report, stats = run_token_scenario(scenario, arch=arch, device=dev,
                                       c_set=sets, b_set=sets, params=params,
                                       **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if cfg.blocks[0] == "rwkv6+rwkv_cm":
        kernel_checks = {
            "rwkv6_scan launched, a multiple of the layers":
                launches["rwkv6_scan"] > 0
                and launches["rwkv6_scan"] % cfg.num_layers == 0,
            "no attention kernel launched":
                launches["swa_prefill"] == launches["decode_attention"] == 0,
            "ssd_scan not launched": launches["ssd_scan"] == 0}
    elif cfg.blocks[0] == "mamba2+none":
        apps = -(-cfg.num_layers // cfg.shared_attn_every)
        kernel_checks = {
            "ssd_scan launched, a multiple of the layers":
                launches["ssd_scan"] > 0
                and launches["ssd_scan"] % cfg.num_layers == 0,
            "swa_prefill launched, a multiple of the shared applications":
                launches["swa_prefill"] > 0
                and launches["swa_prefill"] % apps == 0,
            "decode_attention launched, a multiple of the shared "
            "applications": launches["decode_attention"] > 0
                and launches["decode_attention"] % apps == 0,
            "rwkv6_scan not launched": launches["rwkv6_scan"] == 0}
    elif "mla" in cfg.mixer_kinds:
        # MLA (two head dims) and the experts run in plain PyTorch, as in
        # the reference: no attention kernel or scan is on this path
        kernel_checks = {"no attention kernel or scan launched": not any(
            n for k, n in launches.items() if k not in FUSED)}
    else:
        layers = cfg.num_layers
        kernel_checks = {
            "swa_prefill launched, a multiple of the layers":
                launches["swa_prefill"] > 0
                and launches["swa_prefill"] % layers == 0,
            "decode_attention launched, a multiple of the layers":
                launches["decode_attention"] > 0
                and launches["decode_attention"] % layers == 0,
            "rwkv6_scan not launched": launches["rwkv6_scan"] == 0,
            "ssd_scan not launched": launches["ssd_scan"] == 0}
    gen = stats["generated"]
    ids = np.concatenate([np.asarray(v) for v in gen.values()])
    checks = {
        "n_requests > 0": report.n_requests > 0,
        "tokens_executed == tokens_served > 0":
            stats["tokens_executed"] == report.tokens_served > 0,
        "ttft_p99 finite": math.isfinite(report.ttft_p99),
        "every request served":
            len(gen) == report.n_requests == stats["requests"],
        "ids in vocab": bool(((ids >= 0) & (ids < vocab)).all()),
        "every served step a graph replay":
            stats["graph_replays"] >= stats["step_calls"] > 0,
        **kernel_checks,
        **fused_checks(cfg, launches),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{cfg.name} {scenario} serve checks failed: {failed} "
                             f"(launches {launches})")
    say("serve", arch=stats["arch"], scenario=scenario, b_set=list(sets),
        dtype="bfloat16", **SERVE,
        n_requests=report.n_requests, tokens_served=report.tokens_served,
        tokens_per_s=report.tokens_per_s,
        tokens_per_wall_s=report.tokens_served / stats["run_wall_s"],
        ttft_p50=report.ttft_p50,
        ttft_p99=report.ttft_p99, tbt_violation_rate=report.tbt_violation_rate,
        violation_rate=report.violation_rate, p99=report.p99,
        dispatches=len(report.buckets), step_calls=stats["step_calls"],
        graph_replays=stats["graph_replays"], run_wall_s=stats["run_wall_s"],
        total_wall_s=wall, cost_r2_prefill=stats["cost_r2"][0],
        cost_r2_decode=stats["cost_r2"][1],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    say("serve", launches=json.dumps(launches))
    return launches, stats["cost"]


def fixed_kernel_checks(dev, cfg, rows) -> None:
    """Both attention kernels in bf16 at the shapes the fixed-work entry
    gives them, against their plain versions: the prefill over the
    prompt (b in ``b_set``, S = prompt_len, full causal) and every decode
    step over the cache of prompt_len + gen_tokens rows (lengths
    prompt_len + 1 ... prompt_len + gen_tokens, one length per step for
    the whole batch).  The worst errors go into the kernels' rows."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.swa_prefill import ops as pre

    f, dtype = FIXED, torch.bfloat16
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pl, s_cache = f["prompt_len"], f["prompt_len"] + f["gen_tokens"]
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    worst_p = worst_d = 0.0
    for b in f["b_set"]:
        q, k, v = randn(b, pl, h, d), randn(b, pl, kv, d), randn(b, pl, kv, d)
        worst_p = max(worst_p, check_close(
            f"fixed swa_prefill B={b} S={pl}",
            pre.swa_prefill_attention(q, k, v, window=pl),
            pre.swa_prefill_plain(q, k, v, window=pl), dtype))
        q = randn(b, kv, h // kv, d)
        k, v = randn(b, s_cache, kv, d), randn(b, s_cache, kv, d)
        for n in range(pl + 1, s_cache + 1):
            lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
            worst_d = max(worst_d, check_close(
                f"fixed decode_attention B={b} S={s_cache} length={n}",
                dec.decode_attention(q, k, v, lengths),
                dec.decode_attention_plain(q, k, v, lengths), dtype))
    for name, err in (("swa_prefill", worst_p), ("decode_attention", worst_d)):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    say("fixed", check="bf16 kernels vs plain at the entry's shapes",
        b_set=list(f["b_set"]), prefill=f"S={pl} H={h} KV={kv} D={d}",
        decode=f"S={s_cache} lengths={pl + 1}..{s_cache}",
        swa_prefill_max_abs_err=worst_p, decode_attention_max_abs_err=worst_d)


def fixed_phase(dev, rows):
    """The paper's fixed-work Sponge loop on full-width smollm-135m with
    ``run_live``'s settings: f32 ids of the kernel and plain routes, both
    attention kernels in bf16 at the entry's shapes, the modelled clock
    against ``SimBackend``, then a measured serve.  Returns the serve's
    kernel launches and the fitted ``l(b, c)``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import live_arrivals
    from repro_torch.models import build_model
    from repro_torch.serving.capture import launch_counts, table_replays
    from repro_torch.serving.api import (build_llm_step_fns,
                                         calibrate_step_fns,
                                         make_live_server, make_sim_server)

    f = FIXED
    arch, pl, gen = f["arch"], f["prompt_len"], f["gen_tokens"]
    # 1. ids, f32: one b = 4 entry through the kernel and plain routes
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              param_dtype="float32")
    kcfg = dataclasses.replace(cfg, use_pallas_prefill=True,
                               use_pallas_decode=True)
    kern, plain = build_model(kcfg, device=dev), build_model(cfg, device=dev)
    params = kern.init(kern.generator(0))
    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, pl), generator=g,
                           device=dev, dtype=torch.int32)
    ids_k = build_llm_step_fns(kern, params, (1,), (4,), pl, gen)[(1, 4)](tokens)
    ids_p = build_llm_step_fns(plain, params, (1,), (4,), pl, gen,
                               capture=False)[(1, 4)](tokens)
    if not (ids_k.shape == (4, gen) and torch.equal(ids_k, ids_p)):
        raise AssertionError(f"fixed f32 ids: kernel {ids_k.tolist()} vs "
                             f"plain {ids_p.tolist()}")
    say("fixed", check="f32 ids, kernel route vs plain route", arch=arch,
        batch=4, prompt=pl, gen_tokens=gen, ids="identical")
    del kern, plain, params, ids_k, ids_p
    torch.cuda.empty_cache()
    fixed_kernel_checks(dev, cfg, rows)

    # 2. the modelled clock: the bf16 table calibrated, served against
    # SimBackend on the same perf model, both without resize penalty
    common = dict(c_set=f["c_set"], b_set=f["b_set"], prompt_len=pl,
                  gen_tokens=gen, adaptation_interval=0.5,
                  prior_rps=f["rps"], slo=f["slo"], expected_rps=f["rps"],
                  seed=0, device=dev)
    horizon = f["duration"] + 30

    def arrivals(vocab):
        return live_arrivals(f["rps"], f["duration"], f["slo"],
                             f["size_kb"], pl, vocab, f["seed"])

    def entry_walls(fns):
        walls = {}
        for b in f["b_set"]:
            fn = fns[(f["c_set"][0], b)]
            x = np.ones((b, pl), np.int32)
            times = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            walls[b] = float(np.median(times))
        return json.dumps({b: w * 1e3 for b, w in walls.items()})

    def say_fit(route, perf, walls):
        say("fixed", route=route,
            fit="l(b,c) = gamma b/c + eps/c + delta b + eta",
            gamma=perf.gamma, eps=perf.eps, delta=perf.delta, eta=perf.eta,
            r2=perf.r2, rmse=perf.rmse)
        say("fixed", route=route,
            entry="prefill + gen_tokens decode steps, bf16",
            median_wall_ms_by_b=walls)

    # the same table run eagerly (the comparison route), on the same
    # random weights make_live_server draws
    ecfg = dataclasses.replace(get_config(arch), use_pallas_prefill=True,
                               use_pallas_decode=True)
    emodel = build_model(ecfg, device=dev)
    eager = build_llm_step_fns(emodel, emodel.init(emodel.generator(0)),
                               f["c_set"], f["b_set"], pl, gen,
                               capture=False)
    say_fit("eager", calibrate_step_fns(
        eager, lambda c, b: np.ones((b, pl), np.int32)), entry_walls(eager))
    del emodel, eager
    server, cfg = make_live_server(arch, clock="modeled", **common)
    perf = server.backend.perf
    say_fit("captured", perf, entry_walls(server.backend.step_fns))
    live = server.run(arrivals(cfg.vocab_size), horizon=horizon)
    sim = make_sim_server(perf, "sponge", c_set=f["c_set"], b_set=f["b_set"],
                          c0=max(f["c_set"]), tick=0.5, prior_rps=f["rps"],
                          resize_penalty=0.0, adaptation_interval=0.5,
                          slo=f["slo"], expected_rps=f["rps"])
    simrep = sim.run([r for r, _ in arrivals(cfg.vocab_size)],
                     horizon=horizon)
    d_live = [(t, d.c, d.b, d.feasible) for t, d in live.decisions]
    d_sim = [(t, d.c, d.b, d.feasible) for t, d in simrep.decisions]
    n_req = int(f["rps"] * f["duration"])
    if not (d_live and d_live == d_sim and live.buckets == simrep.buckets
            and live.n_requests == simrep.n_requests == n_req):
        raise AssertionError(f"fixed modelled clock differs from SimBackend: "
                             f"{len(d_live)} vs {len(d_sim)} decisions, "
                             f"{len(live.buckets)} vs {len(simrep.buckets)} "
                             "buckets")
    say("fixed", check="modelled clock vs SimBackend", decisions=len(d_live),
        buckets=len(live.buckets), equal=True)
    del server, sim
    torch.cuda.empty_cache()

    # 3. the main path: a measured serve, launch counts around server.run
    # (make_live_server's warm-up calls are not counted)
    torch.cuda.reset_peak_memory_stats()
    t_total = time.perf_counter()
    server, cfg = make_live_server(arch, clock="measured", perf=perf,
                                   **common)
    arr = arrivals(cfg.vocab_size)
    reset_launches()
    replays0 = table_replays(server.backend.step_fns)
    t0 = time.perf_counter()
    report = server.run(arr, horizon=horizon)
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    total_wall = time.perf_counter() - t_total
    launches = launch_counts()
    replays = table_replays(server.backend.step_fns) - replays0
    results = server.backend.results
    ids = np.stack([it.result for it in results]) if results else np.zeros(0)
    layers, entries = cfg.num_layers, len(server.backend.measured)
    checks = {
        "every request got a result":
            len(results) == report.n_requests == len(arr)
            and all(it.result is not None for it in results),
        "ids int32 of shape (gen_tokens,)":
            ids.dtype == np.int32 and ids.shape == (len(arr), gen),
        "ids in vocab": bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
        "swa_prefill launched once per layer per entry":
            entries > 0 and launches["swa_prefill"] == layers * entries,
        "decode_attention launched once per layer per step per entry":
            launches["decode_attention"] == layers * gen * entries,
        "no scan launched":
            launches["rwkv6_scan"] == launches["ssd_scan"] == 0,
        **fused_checks(cfg, launches, gen * entries),
        "every entry a graph replay": replays == entries,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fixed serve checks failed: {failed} "
                             f"(launches {launches})")
    say("fixed", arch=cfg.name, dtype="bfloat16", clock="measured",
        rps=f["rps"], duration=f["duration"], slo=f["slo"],
        size_kb=f["size_kb"], prompt_len=pl, gen_tokens=gen,
        n=report.n_requests, violation_rate=report.violation_rate,
        p50=report.p50, p99=report.p99,
        decisions=len(report.decisions or ()), instances=len(server.pool),
        dispatches=len(report.buckets), entries=entries,
        graph_replays=replays, run_wall_s=run_wall,
        total_wall_s=total_wall,
        generated_tokens_per_wall_s=len(results) * gen / run_wall,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    say("fixed", launches=json.dumps(launches))
    return launches, perf


def scenarios_phase(dev, perf):
    """The dynamic-SLO scenarios on full-width smollm-135m: the two
    distribution-declaring token scenarios served like ``llm-chat``; the
    two session scenarios on the live fixed-work server (the fixed
    phase's table settings and fit) through ``server.session()`` and
    ``drive_session_events``, with and without their event stream, on
    the modelled clock (held equal to ``run_scenario(engine="exact")``)
    and on the measured clock; ``network-replay`` served live.  Returns
    the kernel launches of every serve, each counted from 0."""
    from repro_torch.serving.api import (SpongeServer, TorchBackend,
                                         make_live_server, make_policy,
                                         pad_tokens)
    from repro_torch.serving.capture import launch_counts
    from repro_torch.serving.scenarios import build_scenario, run_scenario
    from repro_torch.serving.session import drive_session_events

    total = dict.fromkeys(launch_counts(), 0)

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    # 1. the token scenarios, served live like llm-chat
    for name in TOKEN_SCENARIOS:
        add(serve_phase(dev, "smollm-135m", name)[0])
        torch.cuda.empty_cache()

    # 2. the fixed-work table once (captured at warm-up, the fixed
    # phase's fit given), then one server over it per run
    f = FIXED
    sets = dict(c_set=f["c_set"], b_set=f["b_set"])
    base, cfg = make_live_server(f["arch"], prompt_len=f["prompt_len"],
                                 gen_tokens=f["gen_tokens"], perf=perf,
                                 seed=0, device=dev, **sets)
    fns, layers = base.backend.step_fns, cfg.num_layers

    def serve(name, clock, mid_flight=True):
        """One live run of a scenario's first ``SCENARIO_REQUESTS``
        arrivals: a fresh server over the table, a session, the prompts
        as payloads, the event stream (session scenarios), the report."""
        batch, meta = build_scenario(name, requests=SCENARIO_REQUESTS,
                                     seed=0)
        tick = meta.get("tick", 1.0)
        policy = make_policy("sponge", perf, adaptation_interval=tick,
                             slo=meta["slo"],
                             expected_rps=meta["expected_rps"], **sets)
        server = SpongeServer(policy, TorchBackend(fns, pad_tokens, perf,
                                                   clock=clock),
                              tick=tick, prior_rps=meta["expected_rps"])
        rng = np.random.default_rng(0)
        sess = server.session()
        reset_launches()
        t0 = time.perf_counter()
        handles = [sess.submit(r, payload=rng.integers(
            0, cfg.vocab_size, f["prompt_len"]).astype(np.int32))
            for r in batch.to_requests()]
        events = meta.get("session_events", ()) if mid_flight else ()
        applied = drive_session_events(sess, handles, events)
        report = sess.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        add(launches)
        results = server.backend.results
        entries = len(server.backend.measured)
        ids = (np.stack([it.result for it in results]) if results
               else np.zeros((0, f["gen_tokens"]), np.int32))
        checks = {
            "every served request got its ids":
                len(results) == report.n_requests > 0
                and ids.shape == (report.n_requests, f["gen_tokens"]),
            "ids in vocab": bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
            "served or cancelled, each once":
                report.n_requests + report.n_cancelled == len(batch),
            "swa_prefill launched once per layer per entry":
                entries > 0 and launches["swa_prefill"] == layers * entries,
            "decode_attention launched once per layer per step per entry":
                launches["decode_attention"]
                == layers * f["gen_tokens"] * entries,
            "no scan launched":
                launches["rwkv6_scan"] == launches["ssd_scan"] == 0,
            **fused_checks(cfg, launches, f["gen_tokens"] * entries),
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{name} ({clock}) live checks failed: "
                                 f"{failed} (launches {launches})")
        return report, applied, entries, wall, launches

    def check_modeled(name, mid_flight, rep, applied):
        """The modelled clock: decision for decision the exact engine on
        ``SimBackend`` over the same l(b, c), neither side charging a
        resize penalty."""
        ref, stats = run_scenario(
            name, engine="exact", perf=perf, requests=SCENARIO_REQUESTS,
            seed=0, c0=max(f["c_set"]), mid_flight=mid_flight,
            resize_penalty=0.0, **sets)
        same = {"decisions":
                decision_stream(rep) == decision_stream(ref) != [],
                "buckets": rep.buckets == ref.buckets,
                "n": rep.n_requests == ref.n_requests,
                "violation_rate": rep.violation_rate == ref.violation_rate,
                "n_cancelled": rep.n_cancelled == ref.n_cancelled,
                "applied": applied == stats["session"]}
        if not all(same.values()):
            raise AssertionError(
                f"{name} modelled clock differs from run_scenario("
                f"engine='exact') (mid_flight={mid_flight}): "
                f"{[k for k, ok in same.items() if not ok]}")
        say("scenarios", scenario=name, clock="modeled",
            mid_flight=mid_flight,
            check="equal to run_scenario(engine='exact')",
            decisions=len(rep.decisions), buckets=len(rep.buckets))

    for name in SESSION_SCENARIOS:
        for clock in ("modeled", "measured"):
            runs = {mid_flight: serve(name, clock, mid_flight)
                    for mid_flight in (True, False)}
            torch.cuda.empty_cache()
            for mid_flight, (rep, applied, entries, wall, launches) \
                    in runs.items():
                say("scenarios", scenario=name, arch=cfg.name,
                    dtype="bfloat16", clock=clock, mid_flight=mid_flight,
                    requests=SCENARIO_REQUESTS, n=rep.n_requests,
                    violation_rate=rep.violation_rate, p50=rep.p50,
                    p99=rep.p99, n_cancelled=rep.n_cancelled,
                    applied=json.dumps(applied),
                    decisions=len(rep.decisions), buckets=len(rep.buckets),
                    entries=entries, run_wall_s=wall,
                    launches=json.dumps(launches))
                if clock == "modeled":
                    check_modeled(name, mid_flight, rep, applied)
            d_ev = decision_stream(runs[True][0])
            d_pl = decision_stream(runs[False][0])
            say("scenarios", scenario=name, clock=clock,
                decisions_events=len(d_ev), decisions_plain=len(d_pl),
                decisions_differing=sum(x != y for x, y in zip(d_ev, d_pl))
                + abs(len(d_ev) - len(d_pl)))

    # 3. network-replay: 4G and 5G clients, served on the measured clock
    rep, _, entries, wall, launches = serve("network-replay", "measured")
    say("scenarios", scenario="network-replay", arch=cfg.name,
        dtype="bfloat16", clock="measured", requests=SCENARIO_REQUESTS,
        n=rep.n_requests, violation_rate=rep.violation_rate, p50=rep.p50,
        p99=rep.p99, decisions=len(rep.decisions), entries=entries,
        run_wall_s=wall, launches=json.dumps(launches))
    say("scenarios", launches=json.dumps(total))
    return total


def scan_result_diff(a, b):
    """The fields in which two scan-engine results differ (the
    reference's ``_assert_parity``: bit for bit, NaN equal to NaN)."""
    bad = [k for k in ("decisions", "core_seconds", "steps", "n_served")
           if a[k] != b[k]]
    bad += [k for k in ("first_tok", "finish", "tbt_violations")
            if not np.array_equal(a[k], b[k], equal_nan=k != "tbt_violations")]
    return bad


def scan_profile(dev, eng, batch, horizon):
    """A few chunks of the torch route (the same engine and workload, so
    every chunk replays the captured graph), cut by ``horizon``, through
    ``profile_window``: unprofiled wall, device busy time, idle share
    (``idle_share``), the profiled windows' own wall, device kernels per
    chunk (of the last profile)."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(batch, horizon=horizon, backend="torch", device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    replays = eng.replays
    walls, busys, windows, kernels, _ = profile_window(run)
    replays = (eng.replays - replays) // (2 * len(walls))
    copies = sum(r[1] for r in kernels
                 if r[2].startswith(("Memcpy", "Memset")))
    share, raw, spread = idle_share(busys, walls)
    return {"profiled_chunks": eng.chunks, "replays_per_run": replays,
            "profiled_wall_ms": float(np.median(walls)) * 1e3,
            "spread": spread, "raw_idle_share": raw,
            "profiled_window_wall_ms": float(np.median(windows)) * 1e3,
            "device_busy_ms": float(np.median(busys)) * 1e3,
            "device_idle_share": share,
            "device_kernels_per_chunk":
                (sum(r[1] for r in kernels) - copies) / max(eng.chunks, 1),
            "device_copies_per_chunk": copies / max(eng.chunks, 1)}


def engines_phase(dev, perf, cost):
    """The struct-of-arrays engines and the decode-stream scan engine,
    over the cost models fitted on the card in this run: ``cost`` (the
    smollm-135m llm-chat serve's warm-up ``TokenCostModel``) and
    ``perf`` (the fixed phase's refit ``l(b, c)``).  Launches none of
    the four kernels: returns their counts over the phase (all 0)."""
    from repro_torch.core.scaler import SpongeScaler, TokenSpongeScaler
    from repro_torch.serving.capture import launch_counts
    from repro_torch.serving.fastpath import TokenFastSimRunner
    from repro_torch.serving.scanpath import make_sponge_decide
    from repro_torch.serving.scenarios import build_scenario, run_scenario

    e = ENGINES
    sets = e["sets"]
    t_phase = time.perf_counter()
    reset_launches()
    say("engines", cost=json.dumps(dataclasses.asdict(cost)),
        perf=json.dumps(dataclasses.asdict(perf)), sets=list(sets))

    # 1. the scan engine: TokenFastSimRunner.scan_engine over the
    # card-fit cost, torch route on the card against the NumPy plain
    # version, with static knobs and with make_sponge_decide
    def engine(knobs):
        runner = TokenFastSimRunner(
            TokenSpongeScaler(cost, c_set=sets, b_set=sets), cost, sets,
            sets, c0=max(sets))
        decide = (make_sponge_decide(SpongeScaler(cost), cost, sets, sets)
                  if knobs == "sponge-decide" else None)
        return runner.scan_engine(chunk_steps=e["chunk_steps"],
                                  decide=decide)

    def timed(eng, batch, backend):
        replays = eng.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run(batch, backend=backend,
                      device=dev if backend == "torch" else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, {"backend": backend, "wall_s": wall,
                     "chunks": eng.chunks,
                     "engine_steps_per_s": eng.chunks * e["chunk_steps"]
                     / wall,
                     "graph_replays": eng.replays - replays,
                     "steps": out["steps"], "n_served": out["n_served"],
                     "decisions": len(out["decisions"]),
                     "core_seconds": out["core_seconds"]}

    batch, _ = build_scenario(e["scenario"], duration=e["scan_s"],
                              seed=e["seed"])
    cut, _ = build_scenario(e["scenario"], duration=e["parity_s"],
                            seed=e["seed"])
    for knobs in ("static", "sponge-decide"):
        # parity at the cut duration (the NumPy leg's wall)
        got, t_torch = timed(engine(knobs), cut, "torch")
        ref, t_numpy = timed(engine(knobs), cut, "numpy")
        bad = scan_result_diff(got, ref)
        if bad or not got["n_served"]:
            raise AssertionError(f"scan engine ({knobs}): torch on the "
                                 f"card differs from numpy in {bad}")
        for t in (t_torch, t_numpy):
            say("engines", scan=knobs, duration_s=e["parity_s"],
                requests=len(cut), check="torch == numpy, bit for bit",
                **t)
        # the full duration on the card
        eng = engine(knobs)
        out, t_full = timed(eng, batch, "torch")
        served = np.isfinite(out["finish"])
        checks = {
            "served": 0 < out["n_served"] == int(served.sum()),
            "first token before finish": bool(np.all(
                out["first_tok"][served] <= out["finish"][served])),
            "first token after arrival": bool(np.all(
                out["first_tok"][served]
                >= np.asarray(batch.arrival)[served] - 1e-6)),
            "every chunk after the first a replay":
                t_full["graph_replays"] == t_full["chunks"] - 1 > 0,
            "decide moved the knobs": knobs == "static" or len(
                {d[1:] for d in out["decisions"]}) > 1}
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"scan engine ({knobs}, {e['scan_s']} s) "
                                 f"checks failed: {failed}")
        ttft = out["first_tok"] - np.asarray(batch.arrival)
        say("engines", scan=knobs, duration_s=e["scan_s"],
            requests=len(batch),
            ttft_from_arrival_p99_s=float(np.nanpercentile(ttft, 99)),
            tbt_violating_requests=int((out["tbt_violations"] > 0).sum()),
            **t_full)
        if knobs == "static":
            say("engines", scan=knobs, horizon_s=e["profile_horizon_s"],
                **scan_profile(dev, eng, batch, e["profile_horizon_s"]))

    # 2. fast == exact on the card-fit l(b, c) (quanta 0), plain and
    # session scenarios at 600 s
    kw = dict(perf=perf, seed=e["seed"], c0=max(sets), c_set=sets,
              b_set=sets)
    for name in e["pairs"]:
        fast, fs = run_scenario(name, engine="fast", duration=600.0,
                                budget_quantum=0.0, lam_quantum=0.0, **kw)
        exact, es = run_scenario(name, engine="exact", duration=600.0,
                                 **kw)
        same = {"decisions":
                decision_stream(fast) == decision_stream(exact) != [],
                "buckets": fast.buckets == exact.buckets,
                "n": fast.n_requests == exact.n_requests > 0,
                "violations": fast.n_violations == exact.n_violations,
                "n_cancelled": fast.n_cancelled == exact.n_cancelled,
                "session": fs.get("session") == es.get("session")}
        if not all(same.values()):
            raise AssertionError(f"{name}: fast differs from exact on the "
                                 "card-fit l(b, c) in "
                                 f"{[k for k, ok in same.items() if not ok]}")
        say("engines", scenario=name, duration_s=600.0,
            check="fast (quanta 0) == exact", n=fast.n_requests,
            violation_rate=fast.violation_rate,
            n_cancelled=fast.n_cancelled, decisions=len(fast.decisions),
            buckets=len(fast.buckets),
            session=json.dumps(fs.get("session")),
            host_fast_events_per_s=fs["events"] / fs["run_wall_s"],
            host_exact_events_per_s=es["events"] / es["run_wall_s"])

    # 3. the five plain scenarios on the fast engine at its defaults
    for name in PLAIN_SCENARIOS:
        rep, st = run_scenario(name, **kw)
        if not (rep.n_requests > 0 and math.isfinite(rep.p99)):
            raise AssertionError(f"{name} on the fast engine served nothing")
        say("engines", scenario=name, engine="fast", n=rep.n_requests,
            violation_rate=rep.violation_rate, p99=rep.p99,
            avg_cores=rep.avg_cores, events=st["events"],
            host_events_per_s=st["events"] / st["run_wall_s"],
            solver=json.dumps(st["solver"]))

    # 4. the token fast engine at the token bench's scale
    batch, meta = build_scenario(e["scenario"],
                                 requests=e["token_requests"],
                                 seed=e["seed"])
    scaler = TokenSpongeScaler(cost, c_set=sets, b_set=sets,
                               adaptation_interval=meta["tick"],
                               budget_quantum=0.01, lam_quantum=0.5,
                               token_quantum=16)
    runner = TokenFastSimRunner(scaler, cost, sets, sets, c0=max(sets),
                                tick=meta["tick"],
                                prior_rps=meta["expected_rps"])
    t0 = time.perf_counter()
    rep = runner.run(batch)
    wall = time.perf_counter() - t0
    if not (rep.n_requests > 0 and rep.tokens_served > 0
            and math.isfinite(rep.ttft_p99)):
        raise AssertionError("token fast engine served nothing")
    say("engines", scenario=e["scenario"], engine="token-fast",
        requests=len(batch), n=rep.n_requests, ttft_p99=rep.ttft_p99,
        tbt_violation_rate=rep.tbt_violation_rate,
        violation_rate=rep.violation_rate,
        tokens_served=rep.tokens_served, events=runner.events_processed,
        wall_s=wall, host_events_per_s=runner.events_processed / wall,
        solver=json.dumps(scaler.solver_stats()))

    # 5-7. the vector engine, the joint fleet and the degradation ladder
    t_legs = time.perf_counter()
    scale_out_legs(perf)
    t_leg8 = time.perf_counter()
    # 8. the multi-tenant pool
    tenant_legs(cost)
    now = time.perf_counter()
    launches = launch_counts()
    say("engines", launches=json.dumps(launches),
        legs_5_7_seconds=t_leg8 - t_legs, leg_8_seconds=now - t_leg8,
        seconds=now - t_phase)
    if any(launches.values()):
        raise AssertionError(f"the engines phase launched kernels: "
                             f"{launches}")
    return launches


def tenant_legs(cost) -> None:
    """Phase ``engines`` leg 8, NumPy (no kernel launches): the tenant
    pool's fast engine (quanta 0) equals its exact pre-heaped oracle on
    both zoo scenarios under every pool policy at ``TENANT["tenant_s"]``
    (pool stats, per-tenant reports, aggregate); then ``mixed-zoo`` at
    ``TENANT["tenant_requests"]`` on the fast engine at the bench's
    quanta and policy, once on the reference's tenant surfaces and once
    with the chat tenant (smollm-135m) priced by ``cost``, the
    ``TokenCostModel`` fitted on the card in this run.  Prints each
    run's pool swaps and every tenant's violation rate and
    core-seconds."""
    from repro_torch.serving.scenarios import build_scenario, run_scenario
    from repro_torch.serving.tenancy import POOL_POLICIES, TenantFastRunner

    x = TENANT

    def tenants_of(stats):
        return json.dumps({n: [t["violation_rate"], t["core_seconds"]]
                           for n, t in stats["tenants"].items()})

    for name in x["scenarios"]:
        for policy in POOL_POLICIES:
            kw = dict(duration=x["tenant_s"], seed=x["seed"],
                      tenant_policy=policy)
            t0 = time.perf_counter()
            fast, sf = run_scenario(name, engine="fast", budget_quantum=0.0,
                                    lam_quantum=0.0, **kw)
            t1 = time.perf_counter()
            exact, se = run_scenario(name, engine="exact", **kw)
            t2 = time.perf_counter()
            same = (decision_stream(fast) == decision_stream(exact)
                    and fast.buckets == exact.buckets
                    and report_floats(fast) == report_floats(exact)
                    and sf["pool"] == se["pool"]
                    and sf["tenants"] == se["tenants"]
                    and all(decision_stream(a) == decision_stream(b)
                            and a.buckets == b.buckets
                            and report_floats(a) == report_floats(b)
                            for a, b in zip(sf["tenant_reports"],
                                            se["tenant_reports"])))
            if not same:
                raise AssertionError(f"tenant fast != exact on {name} "
                                     f"({policy})")
            say("engines", leg=8, scenario=name, policy=policy,
                duration_s=x["tenant_s"], fast_equals_exact=True,
                n=fast.n_requests, swaps=sf["pool"]["swaps"],
                caps=list(sf["pool"]["caps"]),
                violation_rate=fast.violation_rate,
                core_seconds=fast.core_seconds,
                tenants_violation_rate_core_seconds=tenants_of(sf),
                fast_s=t1 - t0, exact_s=t2 - t1,
                host_events_per_s_fast=sf["events"] / (t1 - t0))
    batch, meta = build_scenario("mixed-zoo", requests=x["tenant_requests"],
                                 seed=x["bench_seed"])
    specs = list(meta["tenants"])
    horizon = max(float(s.batch.arrival[-1]) for s in specs) + 60.0
    card = [dataclasses.replace(s, cost=cost) if s.name == "smollm-135m"
            else s for s in specs]
    for surfaces, tenants in (("reference", specs), ("card-fit chat", card)):
        runner = TenantFastRunner(tenants, budget=int(meta["pool_cores"]),
                                  policy=x["bench_policy"], tick=meta["tick"],
                                  budget_quantum=0.01, lam_quantum=0.5)
        caps0 = list(runner.pool.caps)
        t0 = time.perf_counter()
        rep = runner.run(horizon)
        wall = time.perf_counter() - t0
        if rep.n_requests != len(batch):
            raise AssertionError(f"mixed-zoo ({surfaces}) served "
                                 f"{rep.n_requests} of {len(batch)}")
        say("engines", leg=8, scenario="mixed-zoo", surfaces=surfaces,
            policy=x["bench_policy"], requests=len(batch),
            n=rep.n_requests, swaps=len(runner.pool.swaps),
            caps=f"{caps0}->{list(runner.pool.caps)}",
            violation_rate=rep.violation_rate,
            core_seconds=rep.core_seconds,
            tenants_violation_rate_core_seconds=json.dumps({
                s.name: [r.violation_rate, r.core_seconds]
                for s, r in zip(tenants, runner.tenant_reports)}),
            events=runner.events_processed, wall_s=wall,
            host_events_per_s=runner.events_processed / wall)


def report_floats(rep) -> str:
    """The report's floats (and counts) as one string: each value as a
    Python float, so NaN compares equal and a NumPy scalar compares by
    value."""
    return repr(tuple(float(v) for v in (
        rep.n_requests, rep.n_violations, rep.violation_rate,
        rep.core_seconds, rep.avg_cores, rep.p50, rep.p99,
        rep.mean_latency, rep.accuracy_goodput, rep.mean_served_accuracy,
        rep.model_swaps)))


def decision_stream(rep) -> list:
    """Every field of every decision but the solver's own wall time."""
    return [(t, d.c, d.b, d.n, d.scale_up_delay, d.feasible, d.m)
            for t, d in (rep.decisions or [])]


def scale_out_legs(perf) -> None:
    """Phase ``engines`` legs 5-7, all NumPy (no kernel launches), over
    the card-fit ``perf`` and ``ENGINES["sets"]``, ``c0 = max(sets)``.

    5. the vector engine equals the fast engine on the five plain
       scenarios (decision streams, buckets, report floats, core-seconds;
       its event count is the fast run's arrivals + ticks + launches),
       then replays ``steady`` at ``vector_requests``;
    6. the joint fleet: ``FleetFastSimRunner`` at quanta 0 equals
       ``FleetExactRunner`` on the three fleet scenarios for every
       router (decisions, buckets, ``max_replicas``, core-seconds), then
       ``fleet-flash-crowd`` at ``fleet_requests`` on the reference's
       ``yolov5s_like`` surface and on the card-fit one, each beside the
       static fleet at the largest core count;
    7. the degradation ladder: fast equals exact with model swaps on the
       three ``degrade-*`` scenarios (the scenario's ladder, whose rungs
       are fitted from the reference's base surface), then
       ``degrade-flash-overload``'s accuracy-weighted goodput, sheds and
       rungs used with the whole ladder and with one fixed rung.
    """
    from repro_torch.core.degradation import ModelLadder, resolve_ladder
    from repro_torch.core.perf_model import yolov5s_like
    from repro_torch.serving.fleet import (DegradingFleetScaler,
                                           FleetExactRunner,
                                           FleetFastSimRunner,
                                           FleetSpongeScaler,
                                           StaticFleetPolicy)
    from repro_torch.serving.scenarios import build_scenario, run_scenario

    sets = ENGINES["sets"]
    seed = ENGINES["seed"]
    c0 = max(sets)
    x = SCALE_OUT

    def fail_if(name, same):
        bad = [k for k, ok in same.items() if not ok]
        if bad:
            raise AssertionError(f"{name}: differs in {bad}")

    # 5. the vector engine
    kw = dict(perf=perf, seed=seed, c0=c0, c_set=sets, b_set=sets)
    for name in PLAIN_SCENARIOS:
        n_arrivals = len(build_scenario(name, duration=x["vector_s"],
                                        seed=seed)[0])
        fast, fs = run_scenario(name, engine="fast", duration=x["vector_s"],
                                **kw)
        vec, vs = run_scenario(name, engine="vector",
                               duration=x["vector_s"], **kw)
        fail_if(f"{name}: vector against fast", {
            "decisions":
                decision_stream(vec) == decision_stream(fast) != [],
            "buckets": vec.buckets == fast.buckets,
            "report floats": report_floats(vec) == report_floats(fast),
            "core-seconds": vec.core_seconds == fast.core_seconds,
            "core timeline": vec.core_timeline == fast.core_timeline,
            "events": vs["events"] == n_arrivals
            + len(fast.core_timeline) + len(fast.buckets),
            "solver": vs["solver"] == fs["solver"]})
        say("engines", scenario=name, duration_s=x["vector_s"],
            check="vector == fast, bit for bit", n=vec.n_requests,
            violation_rate=vec.violation_rate, p99=vec.p99,
            core_seconds=vec.core_seconds, decisions=len(vec.decisions),
            events_vector=vs["events"], events_fast=fs["events"],
            host_vector_events_per_s=vs["events"] / vs["run_wall_s"],
            host_fast_events_per_s=fs["events"] / fs["run_wall_s"])
    rep, st = run_scenario("steady", engine="vector",
                           requests=x["vector_requests"], **kw)
    if not (rep.n_requests >= 0.9 * x["vector_requests"]
            and math.isfinite(rep.p99)):
        raise AssertionError("steady on the vector engine served "
                             f"{rep.n_requests} requests")
    say("engines", scenario="steady", engine="vector",
        requests=x["vector_requests"], n=rep.n_requests,
        violation_rate=rep.violation_rate, p99=rep.p99,
        avg_cores=rep.avg_cores, events=st["events"],
        wall_s=st["run_wall_s"],
        host_events_per_s=st["events"] / st["run_wall_s"],
        solver=json.dumps(st["solver"]))

    # 6. the joint fleet
    def fleet_runner(cls, pol, meta, surface, cs, router):
        return cls(pol, surface, cs, cs, n0=meta["n0"], c0=max(cs),
                   tick=meta["tick"], prior_rps=meta["expected_rps"],
                   router=router)

    for name in x["fleet"]:
        batch, meta = build_scenario(name, duration=x["fleet_s"], seed=seed)
        for router in x["routers"]:
            out = []
            for cls in (FleetFastSimRunner, FleetExactRunner):
                pol = FleetSpongeScaler(perf, c_set=sets, b_set=sets,
                                        adaptation_interval=meta["tick"])
                runner = fleet_runner(cls, pol, meta, perf, sets, router)
                t0 = time.perf_counter()
                r = runner.run(batch, events=meta["fleet_events"])
                out.append((r, runner, time.perf_counter() - t0))
            (f, fr, fw), (e, er, ew) = out
            fail_if(f"{name} ({router}): fleet fast against exact", {
                "decisions": decision_stream(f) == decision_stream(e) != [],
                "buckets": f.buckets == e.buckets,
                "max_replicas": fr.max_replicas == er.max_replicas,
                "core-seconds": f.core_seconds == e.core_seconds,
                "report floats": report_floats(f) == report_floats(e)})
            say("engines", scenario=name, router=router,
                duration_s=x["fleet_s"],
                check="fleet fast (quanta 0) == exact", n=f.n_requests,
                max_replicas=fr.max_replicas,
                violation_rate=f.violation_rate,
                core_seconds=f.core_seconds, decisions=len(f.decisions),
                host_fast_events_per_s=fr.events_processed / fw,
                host_exact_events_per_s=er.events_processed / ew)
    batch, meta = build_scenario("fleet-flash-crowd",
                                 requests=x["fleet_requests"],
                                 seed=x["fleet_seed"])
    for surface_name, surface, cs in (("yolov5s_like", yolov5s_like(),
                                       tuple(range(1, 17))),
                                      ("card-fit", perf, sets)):
        for kind in ("sponge", "static"):
            if kind == "sponge":
                pol = FleetSpongeScaler(surface, c_set=cs, b_set=cs,
                                        adaptation_interval=meta["tick"],
                                        budget_quantum=0.01,
                                        lam_quantum=0.5)
            else:
                pol = StaticFleetPolicy(surface, replicas=meta["n0"],
                                        cores=max(cs), b_set=cs,
                                        interval=meta["tick"],
                                        budget_quantum=0.01,
                                        lam_quantum=0.5)
            runner = fleet_runner(FleetFastSimRunner, pol, meta, surface,
                                  cs, meta["router"])
            t0 = time.perf_counter()
            r = runner.run(batch, events=meta["fleet_events"])
            wall = time.perf_counter() - t0
            if not (r.n_requests > 0 and math.isfinite(r.p99)):
                raise AssertionError(f"fleet-flash-crowd ({surface_name}, "
                                     f"{kind}) served nothing")
            say("engines", scenario="fleet-flash-crowd",
                surface=surface_name, policy=pol.name,
                requests=len(batch), n=r.n_requests,
                max_replicas=runner.max_replicas,
                violation_rate=r.violation_rate, p99=r.p99,
                core_seconds=r.core_seconds,
                solver_hit_rate=pol.solver_stats().get("hit_rate"),
                events=runner.events_processed, wall_s=wall,
                host_events_per_s=runner.events_processed / wall)

    # 7. the degradation ladder
    for name in x["degrade"]:
        batch, meta = build_scenario(name, duration=x["degrade_s"],
                                     seed=seed)
        ladder = resolve_ladder(meta["ladder"])
        out = []
        for cls in (FleetFastSimRunner, FleetExactRunner):
            pol = DegradingFleetScaler(perf, c_set=sets, b_set=sets,
                                       adaptation_interval=meta["tick"],
                                       ladder=ladder,
                                       accuracy_floor=meta["accuracy_floor"])
            runner = cls(pol, perf, sets, sets, n0=meta["n0"], c0=c0,
                         tick=meta["tick"], prior_rps=meta["expected_rps"],
                         router=meta["router"], ladder=ladder, m0=pol.model)
            out.append((runner.run(batch, events=meta["fleet_events"]),
                        runner))
        (f, fr), (e, er) = out
        fail_if(f"{name}: ladder fast against exact", {
            "decisions": decision_stream(f) == decision_stream(e) != [],
            "buckets": f.buckets == e.buckets,
            "max_replicas": fr.max_replicas == er.max_replicas,
            "core-seconds": f.core_seconds == e.core_seconds,
            "report floats": report_floats(f) == report_floats(e),
            "model timeline": f.model_timeline == e.model_timeline,
            "swaps": f.model_swaps > 0})
        say("engines", scenario=name, duration_s=x["degrade_s"],
            check="ladder fast (quanta 0) == exact, with swaps",
            n=f.n_requests, swaps=f.model_swaps,
            rungs=json.dumps(sorted({m for _, m, _ in f.model_timeline})),
            accuracy_goodput=f.accuracy_goodput,
            violation_rate=f.violation_rate, core_seconds=f.core_seconds)
    batch, meta = build_scenario("degrade-flash-overload",
                                 duration=x["degrade_compare_s"], seed=seed)
    ladder = resolve_ladder(meta["ladder"])
    for label, lad, floor in (
            ("whole ladder", ladder, meta["accuracy_floor"]),
            (f"fixed-{x['fixed_rung']}",
             ModelLadder([ladder.rung(x["fixed_rung"])]), 0.0)):
        pol = DegradingFleetScaler(perf, c_set=sets, b_set=sets,
                                   adaptation_interval=meta["tick"],
                                   budget_quantum=0.01, lam_quantum=0.5,
                                   ladder=lad, accuracy_floor=floor)
        runner = FleetFastSimRunner(pol, perf, sets, sets, n0=meta["n0"],
                                    c0=c0, tick=meta["tick"],
                                    prior_rps=meta["expected_rps"],
                                    router=meta["router"], ladder=lad,
                                    m0=pol.model)
        t0 = time.perf_counter()
        r = runner.run(batch, events=meta["fleet_events"])
        wall = time.perf_counter() - t0
        timeline = r.model_timeline
        sheds = sum(1 for (_, _, a0), (_, _, a1)
                    in zip(timeline, timeline[1:]) if a1 < a0)
        if not (r.n_requests > 0 and r.accuracy_goodput > 0.0):
            raise AssertionError(f"degrade-flash-overload ({label}) "
                                 "served nothing in time")
        say("engines", scenario="degrade-flash-overload",
            duration_s=x["degrade_compare_s"], ladder=json.dumps(label),
            n=r.n_requests, accuracy_goodput=r.accuracy_goodput,
            mean_served_accuracy=r.mean_served_accuracy,
            swaps=r.model_swaps, sheds=sheds,
            rungs=json.dumps(sorted({m for _, m, _ in timeline})),
            violation_rate=r.violation_rate, core_seconds=r.core_seconds,
            max_replicas=runner.max_replicas,
            host_events_per_s=runner.events_processed / wall)


# ---------------------------------------------------------------------------
# training (phase "train")
# ---------------------------------------------------------------------------

def train_launches(leg: str) -> None:
    """Every kernel's launch count since the last reset, printed; the
    training path runs no kernel (the reference's reaches no Pallas
    call), so each must be 0."""
    from repro_torch.serving.capture import launch_counts

    counts = launch_counts()
    say("train", leg=leg, launches=json.dumps(counts))
    if any(counts.values()):
        raise AssertionError(f"train leg {leg}: kernel launches {counts}")


def train_state_on(state, dev):
    """A copy of a train state on ``dev``."""
    from repro_torch.utils.tree import tree_map_with_path

    return tree_map_with_path(lambda _, t: t.detach().to(dev, copy=True),
                              state)


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_parity_legs(dev) -> None:
    """Legs 1 and 2, f32 on the reduced stacks: three ``make_train_step``
    steps on the card against the same steps on the CPU from one
    ``init_state`` (drawn on the CPU, copied to the card) on the same
    ``make_batch`` batches; then, on the card, one gradient with
    ``remat`` on against off."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_state, make_train_step, to_device
    from repro_torch.train.losses import train_loss
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.utils.tree import tree_leaves, tree_paths

    oc = OptConfig()
    for arch in TRAIN["parity_archs"]:
        base = get_config(arch)
        cfg = dataclasses.replace(base, rwkv_chunked=base.blocks[0].startswith(
            "rwkv6"))
        b, s = TRAIN["parity_batch"], TRAIN["parity_seq"]
        batches = [make_batch(cfg, b, s + cfg.num_patch_tokens, i)
                   for i in range(TRAIN["parity_steps"])]
        reset_launches()
        cpu = build_model(cfg, device="cpu")
        cpu_state = init_state(cpu, cpu.generator(0), oc).as_dict()
        card = build_model(cfg, device=dev)
        card_state = train_state_on(cpu_state, dev)
        worst = {}
        for name, model, st in (("cpu", cpu, cpu_state),
                                ("cuda", card, card_state)):
            step = make_train_step(model, oc)
            for i, batch in enumerate(batches):
                st, m = step(st, batch)
                worst.setdefault(i, {})[name] = {k: float(v)
                                                 for k, v in m.items()}
        keys = [k for k in ("loss", "grad_norm", "mtp_ce")
                if k in worst[0]["cpu"]]
        errs = {k: max(rel_err(w["cuda"][k], w["cpu"][k])
                       for w in worst.values()) for k in keys}
        p_err = 0.0
        for path, x, y in zip(tree_paths(cpu_state["params"]),
                              tree_leaves(card_state["params"]),
                              tree_leaves(cpu_state["params"])):
            x = x.float().cpu()
            bad = (x - y).abs() > 1e-5 + 1e-4 * y.abs()
            p_err = max(p_err, float((x - y).abs().max()))
            if bad.any():
                raise AssertionError(f"train parity {arch}: {path} off by "
                                     f"{float((x - y).abs().max())}")
        say("train", leg=1, arch=arch, dtype="float32",
            rwkv_chunked=cfg.rwkv_chunked, batch=b, seq=s,
            steps=TRAIN["parity_steps"],
            losses=json.dumps([w["cuda"]["loss"] for w in worst.values()]),
            **{f"max_rel_err_{k}": v for k, v in errs.items()},
            params_max_abs_err=p_err)
        if any(v > 1e-4 for v in errs.values()):
            raise AssertionError(f"train parity {arch}: {errs}")
        train_launches(f"1 {arch}")

        # leg 2: remat on and off on the card, one gradient each
        grads = {}
        for remat in (False, True):
            model = build_model(dataclasses.replace(cfg, remat=remat),
                                device=dev)
            params = train_state_on(card_state["params"], dev)
            leaves = [p.requires_grad_() for p in tree_leaves(params)]
            loss, _ = train_loss(model, params,
                                 to_device(batches[0], dev), model.cfg)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads[remat] = (float(loss.detach()), [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)])
        (l0, g0), (l1, g1) = grads[False], grads[True]
        g_err = max(float(((a - c).abs() / c.abs().clamp(min=1e-30)).max())
                    if bool((a != c).any()) else 0.0 for a, c in zip(g1, g0))
        say("train", leg=2, arch=arch, loss_rel_err=rel_err(l1, l0),
            grad_max_rel_err=g_err, leaves=len(g0))
        if rel_err(l1, l0) > 1e-6 or any(
                bool(((a - c).abs() > 1e-6 * c.abs()).any())
                for a, c in zip(g1, g0)):
            raise AssertionError(f"train remat {arch}: loss {l1} vs {l0}, "
                                 f"grad rel err {g_err}")
        train_launches(f"2 {arch}")
        del cpu_state, card_state, grads
        gc_cuda()


def model_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 P T for the weights (forward 2,
    backward 4; P counts the tied embedding once, as the head's
    matmul) plus 6 L H D S T for causal attention (QK^T and PV over S / 2
    keys on average, 2 x 2 H D each, times 3); recompute not counted."""
    attn = 6.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq * tokens
    return 6.0 * cfg.param_count() * tokens + attn


def profiled_once(fn):
    """``fn`` once without the profiler and once under it
    (``profile_window``, one run each way): its host wall (ms), its
    device busy time (ms) and the profile's ``device_events``."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls, busys, _, kernels, api = profile_window(run, runs=1)
    return walls[0] * 1e3, busys[0] * 1e3, kernels, api


GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "Gemm")


def train_step_breakdown(dev, cfg, holder, batch, step, walls) -> tuple:
    """The main leg's step once under ``torch.profiler``: its device busy
    time, the idle share against ``walls`` (the same step's synchronised
    walls without the profiler), kernels per step, the GEMMs by kernel
    name (bf16: the weights'; f32: the attention core's products, TF32
    being off) and the top kernels.  Beside it, each profiled once on
    its own: the attention core's forward and its forward and backward
    (``blocked_attention`` at the leg's shape: per step the forward runs
    twice a layer, once more in the recompute, the backward once), and
    one AdamW update on a copy of the state.  ``rest_ms`` is the step's
    busy time less the weights' GEMMs, the attention core and AdamW.
    ``holder["state"]`` trains on through the profiled steps."""
    from repro_torch.models.attention import blocked_attention
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.utils.tree import tree_map_with_path

    def one_step():
        holder["state"], _ = step(holder["state"], batch)

    _, busy, kernels, api = profiled_once(one_step)
    share, raw, spread = idle_share([busy / 1e3], walls)
    gemms = [(t, k) for t, _, k in kernels if any(g in k for g in GEMM_NAMES)]
    f32_gemm = sum(t for t, k in gemms if "f32f32" in k)
    weight_gemm = sum(t for t, _ in gemms) - f32_gemm
    b, s = TRAIN["main_batch"], TRAIN["main_seq"]
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, kv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, kv, d, generator=gen, device=dev).bfloat16()
    pos = torch.arange(s, device=dev).expand(b, s)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    gout = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()

    def attn():
        return blocked_attention(q, k, v, pos, pos, causal=True, window=0,
                                 scale=d ** -0.5)

    _, fwd, _, _ = profiled_once(attn)
    _, both, _, _ = profiled_once(
        lambda: torch.autograd.grad(attn(), (q, k, v), gout))
    copy = tree_map_with_path(lambda _, t: t.clone(), holder["state"])
    grads = tree_map_with_path(lambda _, t: torch.randn_like(t),
                               copy["params"])
    adamw_wall, adamw_busy, adamw_kernels, _ = profiled_once(
        lambda: adamw_update(copy["params"], grads, copy["opt"],
                             OptConfig(lr=1e-12)))
    del copy, grads
    layers = cfg.num_layers
    out = {"step_wall_ms": float(np.median(walls)) * 1e3,
           "device_busy_ms": busy, "device_idle_share": share,
           "raw_idle_share": raw, "spread": spread,
           "kernels_per_step": sum(r[1] for r in kernels),
           "host_kernel_launch_calls": sum(n for key, n in api.items()
                                           if "LaunchKernel" in key),
           "weight_gemm_ms": weight_gemm / 1e3,
           "f32_gemm_ms": f32_gemm / 1e3,
           "attention_fwd_ms": 2 * layers * fwd,
           "attention_bwd_ms": layers * (both - fwd),
           "adamw_wall_ms": adamw_wall, "adamw_device_busy_ms": adamw_busy,
           "adamw_kernels": sum(r[1] for r in adamw_kernels),
           "attention_core_one_layer_fwd_busy_ms": fwd,
           "attention_core_one_layer_fwd_bwd_busy_ms": both}
    out["rest_ms"] = busy - out["weight_gemm_ms"] - out["attention_fwd_ms"] \
        - out["attention_bwd_ms"] - adamw_busy
    top = [{"kernel": key[:120], "device_ms": t / 1e3, "count": n}
           for t, n, key in kernels[:12]]
    return out, top


def train_main_leg(dev) -> None:
    """Legs 3 and 6: full-width smollm-135m (bf16 weights, f32 moments,
    remat on) over ``synthetic_batches(seed=0)`` at the launcher's
    ``OptConfig``; the state saved after step 10, restored into fresh
    tensors and run for steps 11-12 against the uninterrupted run."""
    import tempfile

    from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.utils.tree import tree_leaves, tree_paths

    cfg = get_config(TRAIN["main_arch"])
    assert cfg.remat and cfg.param_dtype == "bfloat16"
    steps, b, s = TRAIN["main_steps"], TRAIN["main_batch"], TRAIN["main_seq"]
    oc = OptConfig(lr=3e-4, warmup_steps=max(steps // 20, 1),
                   total_steps=steps)
    model = build_model(cfg, device=dev)
    batches = list(synthetic_batches(cfg, b, s, steps, seed=0))
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = init_state(model, model.generator(0), oc).as_dict()
    step = make_train_step(model, oc)
    losses, walls, metrics = [], [], []
    restored = None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
        if i + 1 == TRAIN["ckpt_after"]:
            t1 = time.perf_counter()
            (ROOT / "build").mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                f = save_checkpoint(tmp, state, step=i + 1,
                                    metadata={"arch": cfg.name})
                nbytes = Path(f).stat().st_size
                fresh = init_state(model, model.generator(1), oc).as_dict()
                restored, meta = restore_checkpoint(f, fresh)
                del fresh
            same = all(torch.equal(x, y) and x.dtype == y.dtype
                       for x, y in zip(tree_leaves(restored),
                                       tree_leaves(state)))
            say("train", leg=6, saved_after_step=i + 1, file_bytes=nbytes,
                leaves=len(tree_paths(state)),
                bf16_keys=len(meta["bf16_keys"]),
                all_leaves_equal=same,
                save_restore_s=time.perf_counter() - t1)
            if not same or meta["step"] != i + 1:
                raise AssertionError("train checkpoint: restored state "
                                     "differs from the saved one")
    losses = [float(m["loss"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    train_launches("3 smollm-135m")
    tokens = b * s
    wall = float(np.median(walls[3:]))
    flops = model_flops(cfg, tokens, s)
    say("train", leg=3, arch=cfg.name, dtype="bfloat16", moments="float32",
        remat=cfg.remat, batch=b, seq=s, tokens_per_step=tokens, steps=steps,
        lr=oc.lr, warmup=oc.warmup_steps, loss_first=losses[0],
        loss_last=losses[-1],
        improved=losses[-1] < losses[0],
        grad_norm_first=float(metrics[0]["grad_norm"]),
        grad_norm_last=float(metrics[-1]["grad_norm"]),
        first_step_wall_s=walls[0], median_step_wall_s_steps_4_20=wall,
        tokens_per_s=tokens / wall, peak_mem_gib=peak)
    say("train", leg=3, model_flops_per_step=flops,
        formula=json.dumps("6 P T + 6 L H D S T (P params, T tokens, "
                           "causal attention; recompute not counted)"),
        params=cfg.param_count(),
        model_flops_share=flops / wall / PEAK_FLOPS[torch.bfloat16],
        peak_assumed=json.dumps("989e12 bf16 dense, H100 SXM data sheet"),
        card=json.dumps(torch.cuda.get_device_name(0)))
    say("train", leg=3, losses=json.dumps([round(x, 5) for x in losses]))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train main leg: loss {losses[0]} -> "
                             f"{losses[-1]} (NO IMPROVEMENT)")

    # leg 6, the second half: steps 11-12 from the restored state
    k = TRAIN["ckpt_after"]
    rstep = make_train_step(model, oc)
    resumed = []
    for batch in batches[k:k + 2]:
        restored, m = rstep(restored, batch)
        resumed.append(float(m["loss"]))
    err = max(rel_err(a, c) for a, c in zip(resumed, losses[k:k + 2]))
    say("train", leg=6, resumed_losses=json.dumps(resumed),
        uninterrupted=json.dumps(losses[k:k + 2]), max_rel_err=err)
    if err > 1e-6:
        raise AssertionError(f"train checkpoint: resumed losses {resumed} "
                             f"vs {losses[k:k + 2]}")
    del restored
    gc_cuda()

    # the step profiled (after the 20 steps: it trains on)
    reset_launches()
    holder = {"state": state}
    del state
    br, top = train_step_breakdown(dev, cfg, holder, batches[0], step,
                                   walls[3:])
    train_launches("3 profile")
    say("train", leg=3, profile="one step", **br)
    for r in top:
        say("train", leg=3, top_kernel=json.dumps(r["kernel"]),
            device_ms=r["device_ms"], count=r["count"])
    del holder
    gc_cuda()


def train_other_legs(dev) -> None:
    """Leg 4: rwkv6-1.6b (``rwkv_chunked``) and zamba2-2.7b at full width,
    bf16, remat on, a few steps: finite loss and gradient norm, the
    median step wall and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optimizer import OptConfig

    b, s = TRAIN["other_batch"], TRAIN["other_seq"]
    steps = TRAIN["other_steps"]
    for arch in TRAIN["other_archs"]:
        base = get_config(arch)
        cfg = dataclasses.replace(base, rwkv_chunked=arch.startswith("rwkv6"))
        assert cfg.remat and cfg.param_dtype == "bfloat16"
        oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
        model = build_model(cfg, device=dev)
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = init_state(model, model.generator(0), oc).as_dict()
        step = make_train_step(model, oc)
        walls, ms = [], []
        for batch in synthetic_batches(cfg, b, s, steps, seed=0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            ms.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_launches(f"4 {arch}")
        say("train", leg=4, arch=cfg.name, dtype="bfloat16", remat=cfg.remat,
            rwkv_chunked=cfg.rwkv_chunked, batch=b, seq=s, steps=steps,
            losses=json.dumps([m["loss"] for m in ms]),
            grad_norms=json.dumps([m["grad_norm"] for m in ms]),
            first_step_wall_s=walls[0],
            median_step_wall_s=float(np.median(walls[1:])),
            tokens_per_s=b * s / float(np.median(walls[1:])),
            params=cfg.param_count(), peak_mem_gib=peak)
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for m in ms):
            raise AssertionError(f"train {arch}: non-finite loss or norm {ms}")
        del state, step, model
        gc_cuda()


def train_forms_leg(dev) -> None:
    """Leg 5, f32 at full width: ``ssd_chunked`` against the ``ssd_scan``
    kernel (its recurrence body) with a carried state, inputs drawn as
    ``test_ssd_scan_sweep`` draws them, atol = rtol = 2e-4; and
    ``wkv6_chunked`` against the ``rwkv6_scan`` kernel, decays uniform
    in (0.7, 0.999) and r, k, v of std 0.5 as in
    ``test_wkv6_chunked_matches_scan``, within 1e-4 of max |y|.  These
    launches compare; they are not the training path's."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked
    from repro_torch.models.rwkv6 import wkv6_chunked

    c = TRAIN["ssd"]
    b, t, h, p, n = c["B"], c["T"], c["H"], c["P"], c["N"]
    rng = np.random.default_rng(5)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    x, bm, cm = arr(b, t, h, p), arr(b, t, n), arr(b, t, n)
    dt = torch.nn.functional.softplus(arr(b, t, h))
    alog, h0 = arr(h, scale=0.3), arr(b, h, p, n, scale=0.1)
    with torch.no_grad():
        y1, hf1 = ssd_chunked(x, dt, alog, bm, cm, h0=h0)
        y2, hf2 = ssd_scan(x, dt, alog, bm, cm, h0)
    e_y = check_within("train ssd_chunked y", y1, y2, 2e-4)
    e_h = check_within("train ssd_chunked h", hf1, hf2, 2e-4)
    say("train", leg=5, form="ssd_chunked", against="ssd_scan kernel",
        B=b, T=t, H=h, P=p, N=n, chunk=128, y_max_abs_err=e_y,
        h_max_abs_err=e_h, tol="atol=rtol=2e-4")

    c = TRAIN["wkv"]
    b, t, h, d = c["B"], c["T"], c["H"], c["D"]
    r, k, v = (arr(b, t, h, d, scale=0.5) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.7, 0.999, (b, t, h, d))
                         .astype(np.float32)).to(dev)
    u, s0 = arr(h, d, scale=0.5), arr(b, h, d, d, scale=0.1)
    with torch.no_grad():
        y1, s1 = wkv6_chunked(r, k, v, w, u, s0)
        y2, s2 = rwkv6_scan(r, k, v, w, u, s0)
    scale = float(y2.abs().max())
    e_y = float((y1 - y2).abs().max())
    e_s = float((s1 - s2).abs().max())
    s_scale = float(s2.abs().max())
    say("train", leg=5, form="wkv6_chunked", against="rwkv6_scan kernel",
        B=b, T=t, H=h, D=d, chunk=32, y_max_abs_err=e_y, y_scale=scale,
        state_max_abs_err=e_s, state_scale=s_scale,
        tol="1e-4 of max |y| (of max |state| for the state)")
    if not (e_y <= 1e-4 * scale and e_s <= 1e-4 * s_scale
            and torch.isfinite(y1).all()):
        raise AssertionError(f"train wkv6_chunked: y err {e_y} (scale "
                             f"{scale}), state err {e_s} ({s_scale})")


def train_phase(dev) -> None:
    """Phase ``train``: legs 1-6 (the module docstring)."""
    t0 = time.perf_counter()
    for legs, fn in (("1-2", train_parity_legs), ("3,6", train_main_leg),
                     ("4", train_other_legs), ("5", train_forms_leg)):
        t1 = time.perf_counter()
        fn(dev)
        say("train", legs=legs, seconds=time.perf_counter() - t1)
    reset_launches()
    say("train", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# distribution (phase "dist")
# ---------------------------------------------------------------------------

def dryrun_start() -> dict:
    """The dry runs of phase "dist", one CPU process each (no card),
    started at once: leg 3's smollm-135m train step at TRAIN's main
    shape on a 1 x 1 fake mesh, and leg 4's ``DIST["dry"]`` on the 16 x
    16 fake mesh.  Each prints its record as one JSON line into its log
    under ``build/dryrun``."""
    import os

    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    runs = {"leg3": ["--arch", DIST["arch"], "--shape", "train_4k",
                     "--mesh", "1x1", "--global-batch",
                     str(TRAIN["main_batch"]), "--seq-len",
                     str(TRAIN["main_seq"])]}
    for arch, shape, opt in DIST["dry"]:
        runs[f"{arch}|{shape}|{opt}"] = ["--arch", arch, "--shape", shape,
                                         "--opt", opt]
    procs = {}
    for key, args in runs.items():
        log = open(out / (key.replace("|", "_") + ".log"), "w")
        procs[key] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--json", "--out", str(out)], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT), log,
            time.perf_counter())
    return procs


def dryrun_read(procs, key: str) -> dict:
    """The record of one dry run of ``dryrun_start`` (waits for it);
    its wall from the start (``wall_s``) added."""
    proc, log, t0 = procs[key]
    proc.wait(timeout=DIST["dry_timeout"])
    log.close()
    text = Path(log.name).read_text()
    if proc.returncode != 0:
        raise RuntimeError(f"dry run {key} failed:\n{text[-3000:]}")
    rec = json.loads([ln for ln in text.splitlines()
                      if ln.startswith("{")][-1])
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def dryrun_stop(procs) -> None:
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dist_serve_leg(dev, mesh) -> dict:
    """Leg 1: full-width smollm-135m (bf16, both kernel routes), prefill
    and ``decode_steps`` eager greedy steps unsharded, then the same on
    the 1 x 1 mesh (parameters and cache DTensors), counted: the ids must
    be equal and every layer's attention must have run its kernel
    through ``local_map`` (one ``swa_prefill`` per layer and prefill, one
    ``decode_attention`` per layer and step).  The unsharded run takes
    the decode step's route a mesh takes (``transformer.fused_decode``
    off: the plain chains and cuBLAS's products), so the two differ only
    by the sharding: ``decode_gemm`` sums in another order than cuBLAS,
    and bf16 greedy ids may part on a near tie.  Returns the mesh run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.capture import launch_counts

    cfg = dataclasses.replace(get_config(DIST["arch"]),
                              use_pallas_prefill=True,
                              use_pallas_decode=True)
    b, prompt, steps = DIST["batch"], DIST["prompt"], DIST["decode_steps"]
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(5))
    ids, walls = {}, {}
    fused_decode = tfm.fused_decode
    for name, m in (("unsharded", None), ("mesh", mesh)):
        tfm.fused_decode = (fused_decode if m is not None
                            else lambda cfg, x, mesh=None: False)
        model = build_model(cfg, mesh=m, device=dev)
        params = model.init(model.generator(0))
        if m is not None:
            params = sh.distribute(params, sh.param_specs(params, m,
                                                          fsdp=False), m)
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        with torch.no_grad():
            lg, cache = model.prefill(params, {"tokens": tokens},
                                      cache_len=prompt + steps + 1)
            for _ in range(steps):
                nxt = sh.gather({"x": lg})["x"][:, :cfg.vocab_size].argmax(-1)
                out.append(nxt)
                lg, cache = model.decode_step(params, cache,
                                              nxt.to(torch.int32)[:, None])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        ids[name] = torch.stack(out, 1).cpu()
        if m is not None:
            launches = launch_counts()
            dtensor = sh.is_dtensor(cache["k"])
        del model, params, cache, lg
        gc_cuda()
    tfm.fused_decode = fused_decode
    layers = cfg.num_layers
    # under the mesh the decode step keeps its plain chains and its
    # products on cuBLAS
    want = {"swa_prefill": layers, "decode_attention": layers * steps,
            **dict.fromkeys(FUSED, 0)}
    same = torch.equal(ids["mesh"], ids["unsharded"])
    say("dist", leg=1, arch=cfg.name, dtype=cfg.dtype, batch=b,
        prompt=prompt, decode_steps=steps, ids_equal=same,
        cache_is_dtensor=dtensor, launches=json.dumps(launches),
        expected=json.dumps(want), unsharded_wall_s=walls["unsharded"],
        mesh_wall_s=walls["mesh"])
    if not (same and dtensor):
        raise AssertionError(f"dist leg 1: sharded ids differ or the cache "
                             f"is not a DTensor ({same}, {dtensor})")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"dist leg 1: {k} launched {launches[k]} "
                                 f"times under the mesh, not {n}")
    return launches


def dist_train_legs(dev, mesh, procs) -> None:
    """Legs 2 and 3 at TRAIN's main shape (smollm-135m, bf16 weights, f32
    moments, remat): ``train_steps`` steps on the 1 x 1 mesh against as
    many unsharded from the same ``init_state`` (one rank runs the same
    local ops: losses and gradient norms equal within 1e-6 relative);
    then one more unsharded step counted by ``CostMode``, its FLOPs equal
    to the dry run's per-chip FLOPs of this shape on a 1 x 1 fake mesh
    (``procs["leg3"]``), beside its roofline, its wall and device busy time,
    and the mode's live-bytes peak beside ``max_memory_allocated``."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.models import sharding as sh
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.utils import roofline as rf
    from repro_torch.utils.op_cost import CostMode

    cfg = get_config(DIST["arch"])
    b, s, n = TRAIN["main_batch"], TRAIN["main_seq"], DIST["train_steps"]
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=n)
    batches = list(synthetic_batches(cfg, b, s, n + 1, seed=0))
    res = {}
    for name, m in (("unsharded", None), ("mesh", mesh)):
        model = build_model(cfg, mesh=m, device=dev)
        state = init_state(model, model.generator(0), oc).as_dict()
        step = make_train_step(model, oc)
        losses, norms, walls = [], [], []
        for batch in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            full = sh.gather(met)
            losses.append(float(full["loss"]))
            norms.append(float(full["grad_norm"]))
        res[name] = (losses, norms, walls)
        if m is None:
            keep = (model, state, step)
        else:
            sharded = sum(1 for x in tensors_of(state) if sh.is_dtensor(x))
        del model, state, step
        gc_cuda()
    (l0, g0, w0), (l1, g1, w1) = res["unsharded"], res["mesh"]
    err = max(max(rel_err(a, c) for a, c in zip(l1, l0)),
              max(rel_err(a, c) for a, c in zip(g1, g0)))
    say("dist", leg=2, arch=cfg.name, batch=b, seq=s, steps=n,
        losses_unsharded=json.dumps(l0), losses_mesh=json.dumps(l1),
        grad_norms_unsharded=json.dumps(g0), grad_norms_mesh=json.dumps(g1),
        max_rel_err=err, dtensor_leaves=sharded,
        step_walls_unsharded_s=json.dumps(w0),
        step_walls_mesh_s=json.dumps(w1),
        mesh_over_unsharded=float(np.median(w1[1:]) / np.median(w0[1:])))
    if err > 1e-6:
        raise AssertionError(f"dist leg 2: sharded train differs by {err}")

    # leg 3: the step counted, then profiled
    model, state, step = keep
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with CostMode(keep_log=False) as mode:
        state, _ = step(state, batches[n])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    wc = mode.cost
    holder = {"state": state}
    del state

    def one_step():
        holder["state"], _ = step(holder["state"], batches[0])

    wall, busy, _, _ = profiled_once(one_step)
    roof = rf.analyze(cfg.name, f"train {b}x{s}", "1x1", 1, wc,
                      model_flops(cfg, b * s, s))
    dry1x1 = dryrun_read(procs, "leg3")
    dry = dry1x1["roofline"]
    say("dist", leg=3, counted_flops=wc.flops,
        dryrun_flops_per_chip=dry["flops_per_chip"],
        flops_equal=wc.flops == dry["flops_per_chip"],
        counted_bytes=wc.bytes_accessed,
        dryrun_bytes_per_chip=dry["bytes_per_chip"],
        roofline_step_ms=roof.step_time_s * 1e3, dominant=roof.dominant,
        compute_ms=roof.compute_s * 1e3, memory_ms=roof.memory_s * 1e3,
        measured_step_wall_ms=wall, device_busy_ms=busy,
        wall_over_roofline=wall / 1e3 / roof.step_time_s,
        live_bytes_peak=wc.peak_live_bytes, cuda_peak_bytes_above_state=peak,
        dryrun_peak_bytes=dry["memory_analysis"].get("temp_size_in_bytes"),
        dryrun_trace_s=dry1x1["trace_s"])
    if wc.flops != dry["flops_per_chip"]:
        raise AssertionError(f"dist leg 3: counted {wc.flops} FLOPs on the "
                             f"card, the dry run {dry['flops_per_chip']}")
    del holder, model, step
    gc_cuda()


def dist_lse_leg(dev, rows) -> None:
    """Leg 5: ``decode_attention(..., return_lse=True)`` at the six
    decode shapes of the kernels line (``DIST_LSE_SHAPES``), f32 and
    bf16: the output and the log-sum-exp against the plain version's
    (``TOL``; a length-0 row's lse is about -1e30 on both sides); each
    cache split into 2 and 4 row ranges, each range called with its
    local lengths ``clamp(len - start, 0, rows)`` and the calls merged
    by their lse (``merge_by_lse``), against the whole-cache call on
    the rows whose length is above 0 (a decode always has row 0).  In
    bf16 the kernel is timed with and without the lse output, one after
    the other: ``<shape>_lse_ms`` on the kernels line.  These launches
    compare and time the kernel: they count on no path."""
    from repro_torch.kernels.decode_attention import ops as dec

    gen = torch.Generator(device=dev).manual_seed(9)
    r = rows["decode_attention"]
    worst = {"lse": 0.0, "merge": 0.0}
    for key, shape in DIST_LSE_SHAPES:
        b, s, kv, g, d = (shape[k] for k in ("B", "S", "KV", "G", "D"))
        lengths = torch.tensor(shape["lengths"], dtype=torch.int32,
                               device=dev)
        some = lengths > 0
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, kv, g, d, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(b, s, kv, d, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            name = f"decode_attention lse {key or 'd64'} {str(dtype)[6:]}"
            out, lse = dec.decode_attention(q, k, v, lengths,
                                            return_lse=True)
            ref, ref_lse = dec.decode_attention_plain(q, k, v, lengths,
                                                      return_lse=True)
            err_out = check_close(name + " out", out, ref, dtype)
            empty = ref_lse <= -1e29
            if not torch.equal(lse <= -1e29, empty):
                raise AssertionError(f"{name}: the empty rows' lse differ")
            err_lse = check_close(name, lse[~empty], ref_lse[~empty], dtype)
            whole = dec.decode_attention(q, k, v, lengths)
            errs = {}
            for n in DIST["lse_splits"]:
                cuts = [round(i * s / n) for i in range(n + 1)]
                parts = [dec.decode_attention(
                    q, k[:, a:c].contiguous(), v[:, a:c].contiguous(),
                    torch.clamp(lengths - a, 0, c - a).to(torch.int32),
                    return_lse=True) for a, c in zip(cuts, cuts[1:])]
                errs[n] = check_close(f"{name} merged over {n}",
                                      dec.merge_by_lse(parts)[some],
                                      whole[some].float(), dtype)
            worst["lse"] = max(worst["lse"], err_lse)
            worst["merge"] = max(worst["merge"], *errs.values())
            say("dist", leg=5, kernel="decode_attention", dtype=str(dtype)[6:],
                B=b, S=s, KV=kv, G=g, D=d, lengths=list(shape["lengths"]),
                out_max_abs_err=err_out, lse_max_abs_err=err_lse,
                merged_max_abs_err=json.dumps(errs))
        pre_ = f"{key}_" if key else ""
        ms = median_ms(lambda: dec.decode_attention(q, k, v, lengths))
        r[f"{pre_}lse_ms"] = median_ms(
            lambda: dec.decode_attention(q, k, v, lengths, return_lse=True))
        say("dist", leg=5, kernel="decode_attention", timed=f"bf16 {key or 'd64'}",
            ms_without_lse=ms, **{f"{pre_}lse_ms": r[f"{pre_}lse_ms"]})
    r["lse_max_abs_err"] = worst["lse"]
    r["lse_merge_max_abs_err"] = worst["merge"]


def dist_window_leg(dev, mesh, window_ids) -> dict:
    """Leg 6: phase ``window``'s run (full-width h2o-danube-1.8b, f32,
    both kernel routes, batch 1, a ``WINDOW["prompt"]``-token prompt past
    the 4096-token window and ``WINDOW["steps"]`` greedy steps) on the
    1 x 1 mesh, its parameters DTensors and its cache from
    ``init_cache(..., seq_shard=True)``: the ring's sequence dim sharded
    over ``model``, so every decode takes the per-rank route with the
    kernel's lse merge.  The ids must equal phase ``window``'s and the
    counts, reset before the prefill and read after the last step, must
    be one ``swa_prefill`` per layer and one ``decode_attention`` per
    layer and step.  Returns them."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import init_cache
    from repro_torch.serving.capture import launch_counts

    arch, s, steps = WINDOW["arch"], WINDOW["prompt"], WINDOW["steps"]
    base = get_config(arch)
    cfg = dataclasses.replace(base, dtype="float32", param_dtype="float32",
                              use_pallas_prefill=True, use_pallas_decode=True)
    tokens = torch.randint(0, base.vocab_size, (1, s), device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(6))
    model = build_model(cfg, mesh=mesh, device=dev)
    params = model.init(model.generator(0))
    params = sh.distribute(params, sh.param_specs(params, mesh, fsdp=False),
                           mesh)
    cache = init_cache(cfg, 1, s + steps + 1, dev, mesh, seq_shard=True)
    seq_sharded = any(p.is_shard(2) for p in cache["k"].placements)
    ring = cache["k"].shape[2]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids = []
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": tokens}, cache=cache)
        for step in range(steps + 1):
            nxt = sh.gather({"x": lg})["x"][:, :cfg.vocab_size].argmax(-1)
            ids.append(nxt)
            if step == steps:
                break
            lg, cache = model.decode_step(params, cache,
                                          nxt.to(torch.int32)[:, None])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ids = torch.stack(ids).view(-1).cpu()
    want = {"swa_prefill": cfg.num_layers,
            "decode_attention": cfg.num_layers * steps}
    same = torch.equal(ids, window_ids.view(-1))
    say("dist", leg=6, arch=arch, dtype="float32", batch=1, prompt=s,
        decode_steps=steps, ring_slots=ring, cache_seq_sharded=seq_sharded,
        ids_equal_window_phase=same, launches=json.dumps(launches),
        expected=json.dumps(want), mesh_wall_s=wall)
    del model, params, cache, lg
    gc_cuda()
    if not (same and seq_sharded and ring == base.window_size):
        raise AssertionError(f"dist leg 6: ids {ids.tolist()} vs "
                             f"{window_ids.view(-1).tolist()}, seq-sharded "
                             f"{seq_sharded}, ring {ring}")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"dist leg 6: {k} launched {launches[k]} "
                                 f"times, not {n}")
    return launches


def dist_examples_leg() -> dict:
    """Leg 7: ``examples/torch_serve_dynamic_slo.py`` (live serving of the
    reduced smollm-135m on the card for ``example_serve_s`` seconds) and
    ``examples/torch_train_smollm.py`` (``example_train_steps`` steps,
    its checkpoint under ``build/examples``), each run in this process
    through its ``run`` function, its output kept and summed up.  The
    serve must launch both attention kernels (counts reset before it and
    read after it, returned), the training none; the training must print
    a finite loss for each step and write its checkpoint."""
    import contextlib
    import io
    import runpy

    from repro_torch.serving.capture import launch_counts

    out = {}
    for name, argv in (
            ("torch_serve_dynamic_slo.py",
             ["--device", "cuda", "--duration",
              str(DIST["example_serve_s"])]),
            ("torch_train_smollm.py",
             ["--device", "cuda", "--steps", str(DIST["example_train_steps"]),
              "--ckpt", str(ROOT / "build" / "examples" / "smollm_ckpt")])):
        run = runpy.run_path(str(ROOT / "examples" / name))["run"]
        text = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            res = run(argv)
        torch.cuda.synchronize()
        out[name] = (res, text.getvalue(), launch_counts(),
                     time.perf_counter() - t0)
    res, _, serve_launches, wall = out["torch_serve_dynamic_slo.py"]
    say("dist", leg=7, example="torch_serve_dynamic_slo.py",
        served=res["n"], violations=res["violations"],
        decisions=res["decisions"], launches=json.dumps(serve_launches),
        wall_s=wall)
    _, text, train_launches_, wall = out["torch_train_smollm.py"]
    losses = [float(ln.split()[3]) for ln in text.splitlines()
              if ln.startswith("step ")]
    ckpt = sorted((ROOT / "build" / "examples" / "smollm_ckpt").glob(
        f"ckpt_{DIST['example_train_steps']:08d}.*"))
    say("dist", leg=7, example="torch_train_smollm.py",
        losses=json.dumps(losses), checkpoint=len(ckpt) > 0,
        launches=json.dumps(train_launches_), wall_s=wall)
    if not (res["n"] > 0 and serve_launches["swa_prefill"] > 0
            and serve_launches["decode_attention"] > 0):
        raise AssertionError(f"dist leg 7: the serve example served "
                             f"{res['n']} requests with launches "
                             f"{serve_launches}")
    if not (len(losses) == DIST["example_train_steps"] and ckpt
            and all(math.isfinite(x) for x in losses)
            and not any(train_launches_.values())):
        raise AssertionError(f"dist leg 7: the training example printed "
                             f"losses {losses}, checkpoint {ckpt}, "
                             f"launches {train_launches_}")
    return serve_launches


def dist_phase(dev, procs, rows, window_ids) -> dict:
    """Phase "dist" (legs 1-7, see ``DIST``); returns the launches of
    legs 1, 6 and 7 (the sharded smollm serve, the sharded h2o-danube
    run, the serve example) added up."""
    import os
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_small_mesh

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("MASTER_ADDR", "localhost")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_small_mesh(1, 1, device_type="cuda")
        launches = dist_serve_leg(dev, mesh)
        dist_train_legs(dev, mesh, procs)
        t_new = time.perf_counter()
        dist_lse_leg(dev, rows)
        for leg in (dist_window_leg(dev, mesh, window_ids),
                    dist_examples_leg()):
            for name, n in leg.items():
                launches[name] += n
        gc_cuda()
        say("dist", legs_5_7_seconds=time.perf_counter() - t_new)
        for arch, shape, opt in DIST["dry"]:
            rec = dryrun_read(procs, f"{arch}|{shape}|{opt}")
            r = rec["roofline"]
            say("dist", leg=4, arch=arch, shape=shape, mesh=rec["mesh"],
                chips=rec["chips"], trace_s=rec["trace_s"],
                process_wall_s=rec["wall_s"], ops=rec["ops"],
                flops_per_chip=r["flops_per_chip"],
                bytes_per_chip=r["bytes_per_chip"],
                collective_bytes_per_chip=r["collective_bytes_per_chip"],
                compute_ms=r["compute_s"] * 1e3,
                memory_ms=r["memory_s"] * 1e3,
                collective_ms=r["collective_s"] * 1e3,
                step_time_ms=rec["step_time_s"] * 1e3,
                dominant=r["dominant"], useful=r["useful_ratio"],
                collectives=json.dumps(r["collectives"]),
                memory=json.dumps(r["memory_analysis"]))
    finally:
        dist.destroy_process_group()
    say("dist", seconds=time.perf_counter() - t0)
    return launches


def idle_share(busys, walls) -> tuple:
    """The device's idle share of a window, ``1 - busy / wall``: the
    busy time the median of ``busys`` (profiled runs), the wall the
    median of ``walls``, runs of the same work without the profiler
    (which slows the host).  The run-to-run spread is the range over
    the median of the walls plus that of the busy times.  A negative
    share within it (busy longer than the wall, which no run can be) is
    given as 0; a positive share is given as measured, however small,
    since a host-bound window's walls swing most.  Returns (share, raw
    share, spread)."""
    wall, busy = float(np.median(walls)), float(np.median(busys))
    spread = (max(walls) - min(walls)) / wall
    if busy > 0:
        spread += (max(busys) - min(busys)) / busy
    raw = 1.0 - busy / wall
    return (0.0 if -spread <= raw < 0 else raw), raw, spread


def device_events(prof):
    """Device kernels and copies of a profile, (device us, count, name),
    longest first, and the host's CUDA API calls by name."""
    from torch.autograd import DeviceType

    kernels, api = [], {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and t > 0:
            kernels.append((t, e.count, e.key))
        elif e.device_type == DeviceType.CPU and e.key.startswith("cu"):
            api[e.key] = api.get(e.key, 0) + e.count
    kernels.sort(reverse=True)
    return kernels, api


def profile_window(run, setup=lambda: None, runs: int = 3):
    """``run()`` (the work between two synchronises; it returns its own
    host seconds) ``runs`` times without the profiler, then ``runs``
    times under ``torch.profiler``, one profile each, ``setup()`` untimed
    before every run.  Returns the unprofiled walls, the profiled runs'
    device busy seconds and walls, and the last profile's
    ``device_events``."""
    from torch.profiler import ProfilerActivity, profile

    walls, busys, windows = [], [], []
    for _ in range(runs):
        setup()
        walls.append(run())
    for _ in range(runs):
        setup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            windows.append(run())
        kernels, api = device_events(prof)
        busys.append(sum(r[0] for r in kernels) / 1e6)
    return walls, busys, windows, kernels, api


def profiled(fn, setup=lambda: None) -> dict:
    """``fn`` through ``profile_window``: the wall and the spread, the
    device's busy time and idle share (``idle_share``), the profiled
    window's own wall and the busy share of it, and of the last profile
    the device kernels, host launch calls and the kernels that take the
    most device time."""
    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.inference_mode():
        walls, busys, windows, kernels, api = profile_window(timed, setup)
    share, raw, spread = idle_share(busys, walls)
    busy_s, window = float(np.median(busys)), float(np.median(windows))
    launch_calls = sum(n for k, n in api.items() if "LaunchKernel" in k)
    return {"wall_ms": float(np.median(walls)) * 1e3, "spread": spread,
            "device_busy_ms": busy_s * 1e3, "device_idle_share": share,
            "raw_idle_share": raw, "profiled_window_wall_ms": window * 1e3,
            "device_busy_share_of_profiled_window": busy_s / window,
            "device_kernels": sum(r[1] for r in kernels),
            "host_kernel_launch_calls": launch_calls,
            "host_graph_launch_calls": sum(n for k, n in api.items()
                                           if "GraphLaunch" in k),
            "top_kernels": [{"kernel": k[:120], "device_ms": t / 1e3,
                             "count": n} for t, n, k in kernels[:12]]}


def kernel_family(name: str) -> str:
    """The family of a device kernel by its profiler name: a hand-written
    kernel by its name, cuBLAS's GEMMs, or PyTorch's own kernels."""
    for k in ("decode_attention", "swa_prefill", "add_rms_norm",
              "rope_kv_write", "glu_gate", "rwkv6_scan", "ssd_scan",
              "mamba2_conv_step", "mamba2_gate_norm", "decode_gemm"):
        if k in name:
            return k
    if any(t in name for t in ("nvjet", "gemm", "Kernel2", "splitK")):
        return "gemm"
    return "pytorch"


def decode_graph_phase(dev, g=DECODE_GRAPH) -> dict:
    """One replay of ``g``'s served decode step (bf16, the kernel route,
    its captured graph at ``g["b"]`` after a prompt of the chat bucket;
    ``DECODE_GRAPH`` or ``ZAMBA2_GRAPH``): the device time of a replay
    (CUDA events, median of ``replays``), then one replay under
    ``torch.profiler``: its kernels per replay and per layer, by family,
    and its device busy time."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.token_backend import (build_token_step_fns,
                                                   warmup_token_fns)
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config(g["arch"]), use_pallas_prefill=True,
                              use_pallas_decode=True)
    model = build_model(cfg, device=dev)
    params = model.init(model.generator(0))
    b, pl = g["b"], g["prompt"]
    pre, dec = build_token_step_fns(model, params, (1,), (b,), pl,
                                    max_decode=g["max_decode"])
    warmup_token_fns(pre, dec, pl)
    prefill, decode = pre[(1, b)], dec[(1, b)]
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, pl)).astype(np.int32)
    tok, cache = prefill(tokens)
    for _ in range(5):
        tok, cache = decode(cache, tok)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(g["replays"])]
    for start, end in ev:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        tok, cache = decode(cache, tok)
        end.record()
    torch.cuda.synchronize()
    step_ms = float(np.median([a.elapsed_time(e) for a, e in ev]))
    tok, cache = prefill(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tok, cache = decode(cache, tok)
        torch.cuda.synchronize()
    kernels, _ = device_events(prof)
    families: dict = {}
    for t, n, name in kernels:
        f = families.setdefault(kernel_family(name), [0, 0.0])
        f[0] += n
        f[1] += t / 1e3
    count = sum(n for _, n, _ in kernels)
    out = {"arch": cfg.name, "batch": b, "prompt": pl,
           "decode_step_device_ms": step_ms,
           "kernels_per_replay": count,
           "split_k_reductions": sum(n for _, n, name in kernels
                                     if "splitKreduce" in name),
           "kernels_per_layer": count / cfg.num_layers,
           "busy_ms": sum(t for t, _, _ in kernels) / 1e3,
           "by_family": {k: {"kernels": n, "device_ms": ms}
                         for k, (n, ms) in sorted(families.items())},
           "top_kernels": [{"kernel": k[:120], "device_ms": t / 1e3,
                            "count": n} for t, n, k in kernels[:16]]}
    say("graph", **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
                    for k, v in out.items() if k != "top_kernels"})
    for r in out["top_kernels"]:
        say("graph", **r)
    del pre, dec, prefill, decode, model, params, cache
    gc_cuda()
    return out


def profile_phase(dev, arch: str, model=None, params=None) -> dict:
    """The served b = 4 table entry, eager and replayed from CUDA graphs:
    one prefill and ten decode steps, each step's ids copied to the host
    as ``TokenTorchBackend`` does, timed without the profiler and then
    traced with it.  ``model`` and ``params`` are built from ``arch``
    unless given.  Returns the two routes' figures."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.token_backend import (build_token_step_fns,
                                                   warmup_token_fns)

    if model is None:
        cfg = dataclasses.replace(get_config(arch), use_pallas_prefill=True,
                                  use_pallas_decode=True)
        model = build_model(cfg, device=dev)
        params = model.init(model.generator(0))
    cfg = model.cfg
    b, s, steps = 4, SERVE["prompt_len"], 10
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"window": f"1 prefill + {steps} decode steps, bf16 {arch}, "
                     f"batch {b}, prompt {s}, cache "
                     f"{s + SERVE['max_decode'] + 1}"}
    for route in ("eager", "captured"):
        pre, dec = build_token_step_fns(model, params, (1,), (b,), s,
                                        max_decode=SERVE["max_decode"],
                                        capture=route == "captured")
        warmup_token_fns(pre, dec, s)
        prefill, decode = pre[(1, b)], dec[(1, b)]

        splits = []

        def run():
            """Host seconds of the prefill and of the decode steps (also
            kept in ``splits``)."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = prefill(tokens)
            tok.to("cpu", copy=True)
            t1 = time.perf_counter()
            for _ in range(steps):
                tok, cache = decode(cache, tok)
                tok.to("cpu", copy=True)
            torch.cuda.synchronize()
            splits.append((t1 - t0, time.perf_counter() - t1))
            return splits[-1]

        run()                                   # warm
        splits.clear()
        walls, busys, windows, kernels, api = profile_window(
            lambda: sum(run()))
        prefill_wall = float(np.median([t[0] for t in splits[:3]]))
        decode_wall = float(np.median([t[1] for t in splits[:3]]))
        launch_calls = sum(n for k, n in api.items() if "LaunchKernel" in k)
        graph_launches = sum(n for k, n in api.items() if "GraphLaunch" in k)
        # the profiler slows the host, so the idle share is taken against
        # the same work's wall time without it (``idle_share``)
        share, raw, spread = idle_share(busys, walls)
        res = {"prefill_wall_ms": prefill_wall * 1e3,
               "decode_step_wall_ms": decode_wall / steps * 1e3,
               "device_busy_ms": float(np.median(busys)) * 1e3,
               "device_idle_share": share, "raw_idle_share": raw,
               "spread": spread,
               "profiled_window_wall_ms": float(np.median(windows)) * 1e3,
               "device_kernels": sum(r[1] for r in kernels),
               "host_kernel_launch_calls": launch_calls,
               "host_graph_launch_calls": graph_launches,
               "host_launch_calls_per_step":
                   (launch_calls + graph_launches) / (steps + 1),
               "host_cuda_api_calls": json.dumps(
                   dict(sorted(api.items(), key=lambda kv: -kv[1])[:8])),
               "top_kernels": [{"kernel": k[:120], "device_ms": t / 1e3,
                                "count": n} for t, n, k in kernels[:12]]}
        out[route] = res
        say("profile", arch=arch, route=route,
            **{k: v for k, v in res.items() if k != "top_kernels"})
        for r in res["top_kernels"]:
            say("profile", arch=arch, route=route, **r)
        del pre, dec, prefill, decode
        torch.cuda.empty_cache()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"profile-{cfg.name}.json").write_text(json.dumps(out, indent=1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving shape (phase 7)")
    ap.add_argument("--only", choices=("zamba2",),
                    help="run this phase alone after the build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on an NVIDIA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    set_peaks()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=json.dumps(torch.cuda.get_device_name(0)))

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    ptxas = ptxas_start()
    libs = build.build()
    say("build", seconds=time.perf_counter() - t0,
        libraries=json.dumps({k: str(v.relative_to(ROOT)) for k, v in libs.items()}))
    ptxas_report(ptxas)
    if args.only == "zamba2":
        gen = torch.Generator(device=dev).manual_seed(0)
        mamba2_kernel_phase(dev, gen)
        decode_gemm_phase(dev, gen)
        zamba2_phase(dev)
        say("done", seconds=time.perf_counter() - t_start)
        return 0
    dry = dryrun_start()
    try:
        return run_phases(dev, args, t_start, dry)
    finally:
        dryrun_stop(dry)


def run_phases(dev, args, t_start, dry) -> int:
    """Every phase after the build, in order; the kernels line and the
    last line."""
    rows = kernel_phase(dev)
    for row in rows.values():
        row["launches"] = 0
    for arch in ARCHS:
        parity_phase(dev, arch)
        torch.cuda.empty_cache()          # the f32 weights are freed here
        if arch == WINDOW["arch"]:
            window_ids = window_phase(dev)
            torch.cuda.empty_cache()
        capture_phase(dev, arch)
        torch.cuda.empty_cache()
        # each main path's counts are reset before it and read after it;
        # a kernel's row adds up the paths (the other path must give 0)
        launches, cost = serve_phase(dev, arch)
        for name, n in launches.items():
            rows[name]["launches"] += n
        if arch == ENGINES["arch"]:
            token_cost = cost     # the warm-up fit the engines phase runs on
        torch.cuda.empty_cache()
    for arch in PARITY_ONLY:
        parity_phase(dev, arch)
        torch.cuda.empty_cache()
    zamba2_phase(dev)
    decode_graph_phase(dev)
    for arch in VLM_AUDIO:
        for name, n in vlm_audio_phase(dev, arch, args.profile).items():
            rows[name]["launches"] += n
        torch.cuda.empty_cache()
    for arch in MOE["archs"]:
        for name, n in moe_phase(dev, arch).items():
            rows[name]["launches"] += n
        gc_cuda()
    for name, n in serve_phase(dev, "smollm-135m", "llm-mixed-len",
                               sets=(1, 2, 4, 8))[0].items():
        rows[name]["launches"] += n
    torch.cuda.empty_cache()
    launches, perf = fixed_phase(dev, rows)
    for name, n in launches.items():
        rows[name]["launches"] += n
    torch.cuda.empty_cache()
    for name, n in scenarios_phase(dev, perf).items():
        rows[name]["launches"] += n
    torch.cuda.empty_cache()
    for name, n in engines_phase(dev, perf, token_cost).items():
        rows[name]["launches"] += n
    torch.cuda.empty_cache()
    train_phase(dev)              # launches no kernel: each leg checks 0
    gc_cuda()
    for name, n in dist_phase(dev, dry, rows, window_ids).items():
        rows[name]["launches"] += n
    gc_cuda()
    if args.profile:
        for arch in ARCHS:
            profile_phase(dev, arch)
            torch.cuda.empty_cache()
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
