#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build, check and drive the KWS stream
hop, the kernel library, the chip twin, KWS training, LM serving and LM
training on one CUDA card.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --phase cards   # build, the 1-shard drive and
                                          # phase 9b only (a multi-card
                                          # machine's run)
    python3 chip_smoke.py --phase lm_cards  # phase 13b only
    python3 chip_smoke.py --phase moe_dispatch  # phase 13c only

Phases (each prints one line, any failure exits non-zero):

1. device   — a CUDA card must be present; its name and power limit.
2. build    — nvcc builds ``hop_megakernel.cu``, ``bnn_conv1d.cu``,
              ``twm_matmul.cu`` and ``mma_rate.cu`` from
              ``src/repro_torch/kernels/csrc`` into ``build/``, one
              compiler process each, started together.
3. kernels  — the CUDA hop kernel (B.1, emit and steady) and its finalize
              mode (B.2) are bit-equal to their plain PyTorch versions on
              the card: the full-width KWS plan (``build_kws_spec()``,
              hop_frames=8) at B=256 with masked slots, at B=1, 200 and
              257 (ragged slot blocks), with every slot masked, with a
              K=2 tenant pool by blocks of 8 and by slot (random per
              slot, so slot blocks mix models), with every slot block of
              ``SLOT_SWEEP`` forced once (and, on the smoke spec, the ones
              that do not fit at full width), on the smoke spec, on the
              smoke spec with an 8-bit input to conv stage 1, and on three
              random streamable geometries.  The per-stage kernels — B.3
              bit-serial step, B.4 conv step (raw, and ``sa`` with pool 1
              and 2) and B.5 classifier tail — are bit-equal to theirs at
              every launch shape of a KWS emit hop (hop and flush
              windows) at B=256 and B=200, with a K=2 pool (B.3, B.4 raw,
              B.5), and on a random geometry; B.3 also at
              ``BITSERIAL_CASES`` (ragged position blocks, ``cin > 1``,
              4-bit codes, a K=2 pool by slot), B.4 at ``STEP_CASES``
              (ragged cout, positions off the 16-row tile, stride 2, pools
              2-4, pools of tenants) and B.5 at ``TAIL_CASES`` (one slot,
              tenants by slot, three fc layers).  Then each kernel and its
              plain version are timed at the main path's shapes (device
              time: CUDA events around replays of a CUDA graph of 20
              calls; the time per call issued from Python is recorded
              beside it), B.3 and B.4 raw beside the one PyTorch call that
              computes the same raw conv (``torch.nn.functional.conv1d``,
              float32, TF32 off: exact, every partial sum is below 2^24),
              B.4's launches summed per emit hop and B.5 also at B=1; the
              hop kernel at every slot block of ``SLOT_SWEEP`` that fits
              (emit, steady, finalize), B.4 at every launch shape on each
              hop window and B.5 at every slot block and cluster size at
              ``TAIL_SWEEP_B`` slots (each shape bit-equal first), each
              beside the earlier design's time (``EARLIER_MS``); and the
              tensor cores' rate for the u8 and the 1-bit ``mma.sync``
              (``csrc/mma_rate.cu``).
4. launches — megakernel: one counted launch per hop (emit included) and
              per peek; per-stage on the KWS plan: 4 per steady hop, 9
              per emit hop, 5 per hop-boundary peek.
5. library  — the kernel library (B.6 fused conv -> SA -> pool, B.7
              popcount GEMM, B.8 int8 tensor-core GEMM): each bit-equal
              to its plain version at the launch shapes of a full-width
              utterance (B.3's too), at ``benchmarks/kernel_bench.py``'s
              GEMMs and (8192, 1024, 4096), at ``tests/test_kernels.py``'s
              unaligned GEMMs, at ``THRESHOLD_GEMMS`` (both sides of each
              GEMM tile threshold, ragged N and K, +-inf thresholds and
              flips), and B.6 at pool 1, 2 and 4 with k=7
              stride=2 pad=3 and an even k=2.  Then the library path,
              counted: one 1 s utterance through
              ``models.kws.offline_logits`` on the card
              (1 B.3, 3 B.6, 2 B.7 launches), its logits equal to the same
              composition on CPU tensors (the plain versions) and to the
              numpy ``StreamState``, and again through the model laid out
              once by ``models.kws.prepare_offline`` (counted apart, the
              same launches and logits); then the bench's two GEMMs through
              ``ops.twm_linear`` and ``ops.twm_linear_mxu`` (2 B.7, 2 B.8).
              The utterance issued from Python is timed with the raw model
              dicts and with the prepared model.
              Each kernel is timed at the path's shapes and at (8192,
              1024, 4096) beside its plain version, its bound and the one
              PyTorch call computing its contraction (``conv1d`` or a
              matmul in float32, TF32 off; for B.8 ``torch._int_mm``, or
              the float32 matmul where ``_int_mm`` refuses M <= 16), each
              B.7 and B.8 shape with its tile and its time over the
              library call's; both tiles of each GEMM kernel are timed at
              ``TILE_SWEEP``'s shapes (the thresholds' evidence), B.6 at
              every launch shape on the utterance's b1-b3 (each bit-equal
              first; the rule's pick and the fastest printed), and for
              each GEMM shape the path
              ``ops.pick_path`` picks is printed beside the faster kernel.
6. main     — ``StreamScheduler(build_kws_spec(), ..., capacity=256,
              hop_frames=8)``: 256 streams join, each gets 2 s of seeded
              audio in ragged chunks, the scheduler steps until starved,
              two peeks, 8 closes; run with ``backend="megakernel"`` (and
              again with ``emit_logits=False``, so the finalize kernel
              launches on a peek), with ``backend="per_stage"`` and with
              ``backend="torch"``.  Every hop's logits agree across the
              three backends; the closed streams' logits equal the numpy
              ``StreamState`` fed the same audio.  The launch counters are
              set to 0 just before the megakernel runs and the per-stage
              run and read just after each.
7. async    — the same audio and chunk plan, each round landed by
              ``push_audio_batch`` and run by ``drain()``, through
              ``StreamScheduler`` and ``AsyncStreamScheduler`` (megakernel,
              donated state, ingest pump) in turns sync, async, async,
              sync; the first async run's dispatch stage under
              ``torch.cuda.set_sync_debug_mode("error")``.  Every async
              run equals the first sync run hop for hop (sids, frames,
              logits), peek for peek and close for close, with one hop
              launch a hop; the drives' wall times, hops per second,
              ``overlap_summary()["hidden_frac"]`` and the phase p50s are
              printed.
8. tenants  — ``max_models=4, tenant_block=8``: K = 2 and K = 4 random
              models from the seed bound round-robin to the 256 streams in
              blocks of 8, on the megakernel and per-stage backends, sync
              and async (and emit off at K = 4).  Every stream's hops and
              close equal the single-model megakernel scheduler of its
              model on its streams, and the launches a hop do not depend
              on K (1 per megakernel hop; 9 per emit, 4 per steady
              per-stage hop).  The pooled hop kernel (K = 4, blocks of 8)
              is bit-equal to its plain version and timed at B = 256
              beside the unpooled one.  Each drive's counts are set to 0
              just before it and read just after.

9. sharded — the main path's 256 streams and chunk plan through
              ``make_stream_mesh(S, device="cuda:0")``, with leave churn
              skewed onto shard
              0 halfway (``churn_sids``): the megakernel at S = 1, 2 and
              8 sync and at S = 2 and 8 async, the per-stage backend at
              S = 2, K = 2 tenants (blocks of 8) at S = 1 and 2.  Every
              stream's hops, both peeks and every close equal the 1-shard
              megakernel run's (with the same tenants); the launches a
              hop are S times the per-shard figure; each sharded run
              fires a rebalance.  One sharded hop (S = 2, 8; and S = 2
              with K = 2 tenants) of the scheduler's sharded model
              (``_ShardedModel``: one launch a shard on its own rows) is
              bit-equal to ``hop_megakernel_plain`` on the whole batch.  Printed with the card: hop, dispatch
              and device p50 at S = 1, 2 and 8, rebalances and rows
              moved, the hop kernel at B / S slots, and ``_launch``'s
              cost a hop under cProfile with the launch shape memoized
              and recomputed.  Each drive's counts are set to 0 just
              before it and read just after.
9b. cards  — the same drive over every card ``torch.cuda.device_count()``
              reports (``make_stream_mesh(S)``): with n >= 2 cards (the
              largest power of two <= n) at S = n, one shard a card, and
              S = 2n, two a card; with one card at S = 2 and 8 shards of
              ``cuda:0``, which runs the same per-shard code, and a line
              saying that it spanned 1 card.  Each S on the megakernel and
              per-stage backends, sync and async (the async dispatch under
              sync debug mode ``"error"``): every stream's hops, peeks and
              closes equal the sharded phase's 1-shard run, the launches
              a hop are S times the per-shard figure, a rebalance fires,
              and after every resize and rebalance and at the end every
              shard's state, spare set and staged operands lie on its own
              card.  Then each card's B.1-B.5 launches at a shard's
              shapes (B = 256 / S) are held to their plain versions on
              that card, and with two cards a kernel given an operand on
              the other card is refused.  Printed with the card: hop,
              dispatch and device p50 per S and backend.  Each drive's
              counts are set to 0 just before it and read just after.
10. chip_twin — the chip twin (``core.compiler``, ``core.executor``):
              the full Fig. 7 spec and the same model, compiled with
              ``ROTATE_HINTS`` and ``ROWSPLIT_HINTS`` on the card and on
              the CPU (the same words and macro image); the executor on
              the card, one launch per MAC chunk (1 B.3, 6 B.6 raw, 6 B.7
              raw), equals the executor on the CPU (output, fmaps,
              layer_cycles, bank_active_cycles, ledger) fused and with
              the pool as a separate pass, and with every chunk of the
              smoke spec rotating (the full model rotating whole must
              overflow the weight SRAM); its logits equal
              ``models.kws.offline_logits`` on the card; each of the 13
              launches is bit-equal to its plain version.  Printed with
              the card: the executor's wall time a run (median of
              ``TWIN_RUNS``, synchronised), a cProfile of one run, and
              each launch's device time beside its plain version, bound
              and ``conv1d`` / float32 matmul.  Printed as the simulated
              chip's figures, never the card's: Table I from the ledger
              (cycles, MACs, latency, GOPS; energy and TOPS/W after
              ``energy.calibrate_e_mac``, each held to the bands of
              ``tests/test_system.py``), the PWB saving fused against
              separate pooling at ``PWB_WIDTHS``, the flexible against
              the fixed ping-pong fit, and the TWM and BWM flip rates at
              ``TWM_SIGMAS`` (B.7 on the card).  Each counted run's
              counts are set to 0 just before it and read just after.
11. train   — KWS training on the card: the full Fig. 7 model
              (``init_kws_params`` from a generator seeded ``--seed``),
              ``TRAIN_STEPS`` AdamW steps (lr 2e-3, clip 1.0, as in
              ``examples/kws_train.py``) through ``train.loop.Trainer``
              at batch ``TRAIN_BATCH`` on ``gscd.batch(seed=0, step=i)``
              batches made and staged on the card before the timed loop.
              Printed with the card: the step's ms (median, min, max;
              synchronised, data excluded), ``gscd.batch``'s ms a batch,
              the first and last loss and the eval accuracy on
              ``TRAIN_EVAL`` clips.  Held: the loss falls; the card's QAT
              logits equal the CPU's on ``TRAIN_CPU_CLIPS`` clips, every
              pre-activation an integer; after ``export_kws``,
              ``offline_logits`` on a ``prepare_offline`` model equals
              the QAT logits on ``TRAIN_OFFLINE_CLIPS`` clips and the
              program compiled with ``ROTATE_HINTS`` and
              ``ROWSPLIT_HINTS`` through the executor on
              ``TRAIN_TWIN_CLIPS`` (the deploy's counts set to 0 just
              before it and read just after; each of its B.3, B.6 and
              B.7 launches then bit-equal to its plain version); a
              checkpoint of the trained state restores on the card bit
              for bit.
12. lm_serve — LM serving: Qwen3-0.6B at its published width and depth
              (28 layers, d_model 1024, vocab 151,936; ``api.init_params``
              on the card from a generator seeded ``--seed``).  Held,
              within the reference's prefill/decode bound (``LM_RTOL``,
              ``LM_ATOL``): ``prefill_fn`` on ``LM_PROMPTS`` prompts of
              ``LM_PROMPT_LEN`` tokens on the card against the CPU copy
              of the params (and the argmax where the CPU's top-2 margin
              exceeds the tolerance), and ``LM_DECODE`` decode steps
              against ``forward``.  Then ``serve.engine.Engine`` serves
              ``LM_REQUESTS`` requests (``LM_PROMPT`` prompt and
              ``LM_NEW`` new tokens, ``max_seq`` ``LM_MAX_SEQ``), and
              these runs give identical tokens: sync and async at
              ``LM_SLOTS`` slots, an elastic pool (2 -> 8) and a fixed 8,
              and 2 shards (``make_stream_mesh(2)``) and one at 2 slots,
              whose shared clock passes ``max_seq`` (ROADMAP C.6).  The
              LM path reaches no reference kernel: the kernel counts stay
              0 over the drives.  Printed with the card: the parameter
              and KV-cache bytes, the peak allocation, the prefill p50 a
              request, the decode tick p50 (sync and async), tokens/s of
              each drive, and from a ``torch.profiler`` trace of
              ``LM_PROFILED`` sync ticks the device's busy ms and kernel
              count a tick and its idle share of the sync p50 tick.
13. lm_families — LM serving of the MoE, SSM, hybrid and encoder-decoder
              families.  DeepSeek-MoE-16B at its published width and
              depth (28 layers, 64 routed experts top-6 and 2 shared,
              16.38 B params, 32.8 GB bf16): ``param_count`` equals the
              params built; ``prefill_fn`` card vs CPU at a cut depth
              (``LMF_CUT_LAYERS``: the dense layer and 3 MoE layers, full
              width) on the served ``dropping`` dispatch, and
              ``LMF_DECODE`` decode steps against ``forward`` at full
              depth on the ``dense`` dispatch, both within the
              reference's bound, the card's routing held to the other
              run's (``RouterPin``: router probabilities within
              ``ROUTER_RTOL`` / ``ROUTER_ATOL``, an expert taken over only
              at such a near tie, counted); the engine sync and async at
              ``LMF_SLOTS`` slots, token-equal, with its tick and prefill
              p50, tokens/s and a profiler trace of sync ticks.
              xLSTM-350M and SeamlessM4T-medium whole: the same checks
              and engine drives, the encoder-decoder decoding against
              ``encode(frames)``; the random-weight xLSTM is chaotic at
              full depth, so its card-vs-CPU prefill and decode-vs-
              forward are held layer by layer (each layer on the other
              side's inputs), the free-running differences printed with
              the logits' response to noise-sized changes of the
              embeddings, and the chunked mLSTM against its sequential
              scan.  Jamba and Llama-4-Scout at smoke size: prefill,
              decode and the engine card vs CPU; one Mamba mixer at
              Jamba's width (d_model 8192), the prefill against
              token-by-token steps and the CPU.  No reference kernel is
              launched (the MoE layers' own dispatch kernels are, outside
              the runs whose routing ``RouterPin`` holds).
13c. moe_dispatch — the MoE dispatch's kernels
              (``kernels/moe_dispatch.py``) at both LM cells' decode
              layers (``MDP_SHAPES``: DeepSeek-MoE-16B at 32 tokens, 2
              shared experts; AI21-Jamba2-Mini at 64, 8 of 16 experts
              held) against ``route`` + ``dispatch_dropping`` on the same
              inputs: experts, positions, keep masks and counts equal,
              the output within 2 bf16 ulps of the layer's scale; timed
              beside the plain path, ``torch.bmm`` and the byte bound
              (the ``kernels`` line's ``moe_dispatch`` entry); its
              launches read from one decode tick of each cell's engine
              at full width and a cut depth (``MDP_ENGINES``), one a MoE
              layer.
13b. lm_cards — the LM engine over several devices
              (``serve.engine.Engine(mesh=make_stream_mesh(S))``):
              Qwen3-0.6B and DeepSeek-MoE-16B whole (``api.init_params``
              on ``cuda:0`` from a generator seeded ``--seed``; the
              engine copies the params once to each other card), with n
              >= 2 cards (the largest power of two <= n) at S = n, one
              shard a card, and for Qwen3 also S = 2n; with one card at
              S = 2 and 4 shards of ``cuda:0`` and a line saying that it
              spanned 1 card.  ``lc_slots(S)`` slots, ``LC_REQUESTS``
              requests (one a slot past that) of ``LC_PROMPT`` tokens,
              ``max_new`` alternating ``LC_NEW``, ``max_seq``
              ``LC_MAX_SEQ``, sync and async (the async dispatch and
              sampling under sync debug mode ``"error"``).  Each tick is
              held to one ``decode_step`` over every row concatenated in
              pool order on ``cuda:0`` (logits within ``LM_RTOL`` /
              ``LM_ATOL``, tokens equal but at a near tie, the routing
              held to the tick's own at near ties by ``RouterPin``);
              Qwen3's tokens, sync and async, also equal its unsharded
              sync engine's at the same slots request by request
              (``lc_same_requests``); a rebalance moves a live
              request (between cards at S = n over several); after every
              resize and rebalance and at the end each shard's cache
              parts and feedback token lie on its device in storage of
              their own, the clock has a copy a device and each device
              one params copy.  Printed with the card: the tick p50 and
              tokens/s of a drive of one request a slot, sync and async,
              the MoE gathers between devices a tick and the profiler's
              copies, the devices' busy ms, kernels and idle share of
              ``LC_PROFILED`` profiled sync ticks, each card's peak
              allocation.  The kernel counts stay 0 over the phase.
14. lm_train — LM training (``api.loss_fn``, ``train.loop.Trainer``,
              ``data.lm_data``).  Qwen3-0.6B at its published width and
              depth (``api.init_params`` on the card from a generator
              seeded ``--seed``): at one batch of ``LT_CHECK_BATCH`` x
              ``LT_CHECK_SEQ`` the loss and every gradient leaf on the
              card against the CPU copy of the params (``LT_LOSS_RTOL``,
              ``LT_GRAD_REL_L2``), remat ``block`` and ``dots`` against
              ``none`` and a global ``set_float32_matmul_precision(
              "high")`` against the default on the card (``LT_SAME_RTOL``,
              ``LT_SAME_REL_L2``); ``LT_STEPS`` AdamW steps at ``LT_BATCH``
              x ``LT_SEQ`` (remat ``block``) on ``lm_data`` batches staged
              on the card, the loss falling, the last ``LT_PROFILED`` under
              ``torch.profiler``; a checkpoint of the trained state (params
              and optimizer) restored on the card bit for bit; each remat
              mode's step and peak allocation; ``LT_TERNARY_STEPS`` steps
              in the ``ternary`` quant mode, the first batch's loss
              falling.
              DeepSeek-MoE-16B at full width cut to the dense layer and 1
              MoE layer (``LT_MOE_LAYERS``): card vs CPU on the CPU's
              routing (``RouterPin``), then ``LT_MOE_STEPS`` steps.  Every
              smoke config: one loss and gradient card vs CPU.
              xLSTM-350M (ROADMAP C.7) trained whole for ``LT_XLSTM_S``
              seconds, then the free-running card-vs-CPU prefill, decode
              vs forward and noise response of phase ``lm_families`` on
              the random and the trained weights (printed, not held).  The
              kernel counts stay 0 over the phase.  Printed with the card:
              step ms (median, min, max; synchronised, data excluded),
              tokens/s, the peak allocation, the device's busy ms, kernels
              a step and idle share, and the checkpoint's times.
15. dryrun  — the launch tools (``launch.dryrun``, ``launch.roofline``,
              ``benchmarks_torch``).  ``DR_CELLS`` run as dry runs over a
              fake 256-rank 16x16 world on fake ``cuda`` tensors (nothing
              allocated), each ``ok`` with its peak GB a device, roofline
              terms and dominant term printed and its JSON written to
              ``results/dryrun_torch/``.  The anchor: the dry run of
              ``LT_ARCH`` on a 1x1 mesh at phase ``lm_train``'s step
              (``LT_BATCH`` x ``LT_SEQ``, remat ``block``, AdamW) against
              that step run for real on the card: the predicted peak
              beside the step's ``max_memory_allocated`` above what was
              allocated before its params (``DR_ANCHOR_TOL``), the
              predicted FLOPs beside 6 N D and over the step's time
              between CUDA events as a share of the H100's peak.  Then
              ``benchmarks_torch.run kernel roofline`` (B.7 and B.8
              bit-equal to their plain versions, each time beside the
              card's name and power limit; their launches counted on a
              path of their own).

The model is made here from ``--seed`` with numpy: random ternary weights
and integer thresholds near the middle of each layer's accumulator range
with random flips (phase ``train`` trains its own, from a generator
seeded ``--seed``).  The script imports nothing of JAX or of the
reference package.  Before its last line it prints one JSON object with
each kernel's launches on the main paths (the stream backends', the
library's, the async, tenant and sharded drives', the chip twin's
counted runs, the trained model's deploy), error, time, plain time,
bound and library-call time (each summed over a kernel's launch shapes
on its paths: B.3's l0 of a hop (hop and flush window), of an utterance
and of the chip twin, the conv step's six of an emit hop (three hop and
three flush windows), B.6's three of an utterance and six of the chip
twin, B.7's and B.8's of the library path and B.7's six of the chip
twin; a library time only where every one of them has one; the trained
model's deploy runs at the utterance's and the chip twin's shapes, so
its launches are counted, not timed again), and the card's name and
power limit as ``nvidia-smi`` reports them; the last line is ``{"ok":
true, "device": {...}}``.  The same record, with every timed launch
shape, the ``pick_path`` finding, the B.4 tile, B.5 slot-block and B.6
shape sweeps, the MMA rates, the chip twin's record and the training
record, is written
to ``chip_smoke.json`` in the output directory beside the script.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import dataclasses
import gc
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
B_MAIN = 256
HOP_FRAMES = 8
#: slot blocks the hop kernel is timed at, against each other (the host
#: picks one by ``hop_megakernel.slot_block``)
SLOT_SWEEP = (1, 2, 4, 8)
#: B.3 shapes beyond the paths': (B, l_out, cin, k, stride, cout, bits,
#: K) -- l_out off the position block, cin > 1, 4-bit codes, a K=2 pool
BITSERIAL_CASES = ((5, 83, 1, 19, 8, 64, 8, 1), (7, 37, 4, 5, 2, 48, 8, 1),
                   (9, 30, 1, 7, 8, 8, 4, 1), (37, 64, 1, 19, 8, 64, 8, 2),
                   (3, 45, 16, 3, 1, 32, 4, 2))
#: B.4 shapes beyond the paths': (B, cin, cout, k, stride, l_out, mode,
#: pool, K) -- cout off the 8-column n-tile (and off 4), positions off the
#: 16-row m-tile, stride 2, pools 2-4, a K=2 and a K=3 pool by slot
STEP_CASES = ((37, 64, 20, 3, 1, 19, "raw", 1, 1),
              (5, 96, 13, 5, 2, 7, "sa", 2, 1),
              (9, 256, 44, 3, 1, 3, "raw", 1, 2),
              (200, 128, 250, 5, 1, 29, "sa", 3, 1),
              (3, 40, 6, 3, 1, 15, "sa", 4, 1),
              (11, 40, 6, 3, 2, 7, "raw", 1, 3))
#: B.5 beyond the paths': (B, widths, out_raw, K) -- one slot, a ragged
#: cluster with 3 tenants by slot, three fc layers
TAIL_CASES = ((1, (352, 512, 12), (False, True), 1),
              (17, (352, 512, 12), (False, True), 3),
              (40, (70, 33, 20, 12), (False, False, True), 3))
#: the batches B.5 is swept at (every slot block x cluster size)
TAIL_SWEEP_B = (256, 64, 1)
#: the earlier designs' device times at the main path's shapes, ms (this
#: script on an NVIDIA H100 80GB HBM3 at 700.00 W, when the hop kernel ran
#: one CTA per slot on scalar MACs, B.3 one thread per output, B.4 one
#: thread per output on popcounts, B.5 one CTA per slot and B.6 one thread
#: per output channel on popcounts): the hop kernel at B=256 emit /
#: steady / finalize, B.3 at the hop's and the utterance's l0, B.4 summed
#: over a hop's three hop windows, B.5 at B=256, B.6 at the utterance's
#: b1-b3 (by this script's launch labels)
EARLIER_MS = {"emit": 0.9997, "steady": 0.6934, "finalize": 0.3198,
              "hop l0": 0.0142, "l0 bit-serial": 0.0033,
              "b1-b3 hop windows": 0.0981, "classifier": 0.1708,
              "b1 sa": 0.0048, "b2 sa": 0.0089, "b3 sa": 0.0089}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_lines() -> list[str]:
    """Every card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


# ---------------------------------------------------------------------------
# Seeded model and inputs
# ---------------------------------------------------------------------------

def random_model(spec, seed: int):
    """Exported-model dicts: int8 ternary weights; float64 integer
    thresholds near the middle of the layer's accumulator range (a few
    channels at ±inf, as an exported a == 0 channel has), random flips."""
    from repro_torch.core.cnn_spec import Conv1DSpec, FCSpec

    rng = np.random.default_rng(seed)
    weights, thresholds = {}, {}
    for li, lay in enumerate(spec.layers):
        if isinstance(lay, Conv1DSpec):
            shape = (lay.k * lay.cin, lay.cout)
        elif isinstance(lay, FCSpec):
            shape = (lay.cin, lay.cout)
        else:
            continue
        w = rng.choice(np.array([-1, 0, 1], np.int8), size=shape)
        if isinstance(lay, Conv1DSpec) and lay.in_bits > 1:
            lo, hi = -lay.in_offset, (1 << lay.in_bits) - 1 - lay.in_offset
        elif isinstance(lay, FCSpec) and lay.in_bits > 1:
            lo, hi = 0, 255          # saturated GAP counts
        else:
            lo, hi = 0, 1            # binary activations
        mid = (lo + hi) / 2 * w.sum(0)
        spread = (hi - lo) / 4 * np.sqrt(np.abs(w).sum(0) + 1)
        thr = np.round(mid + rng.uniform(-0.5, 0.5, lay.cout) * spread)
        inf = rng.random(lay.cout) < 0.02
        thr[inf] = np.where(rng.random(inf.sum()) < 0.5, -np.inf, np.inf)
        flip = rng.random(lay.cout) < 0.25
        weights[li] = w
        thresholds[li] = (thr.astype(np.float64), flip)
    return weights, thresholds


def random_spec(seed: int):
    """A small random streamable spec (bit-serial first layer with random
    k/stride/pad, 1-2 conv blocks with random k/pad/pool, GAP, binary fc,
    raw fc) and a hop_frames that reaches a steady state."""
    from repro_torch.core.cnn_spec import CNN1DSpec, Conv1DSpec, FCSpec, GAPSpec
    from repro_torch.stream.state import plan_stream

    rng = np.random.default_rng(seed)
    while True:
        k0 = int(rng.integers(3, 13))
        bits0 = int(rng.choice([4, 8]))
        layers = [Conv1DSpec(1, int(rng.choice([4, 8, 32])), k=k0,
                             stride=int(rng.choice([2, 4, 8])),
                             pad=int(rng.integers(0, k0)), in_bits=bits0,
                             in_offset=1 << (bits0 - 1), name="l0")]
        cin = layers[0].cout
        for j in range(int(rng.integers(1, 4))):
            k = int(rng.choice([3, 5]))
            cout = int(rng.choice([4, 8, 48, 96]))
            layers.append(Conv1DSpec(cin, cout, k=k,
                                     pad=int(rng.integers(0, k // 2 + 1)),
                                     pool=int(rng.choice([1, 2, 2, 4])),
                                     name=f"b{j + 1}"))
            cin = cout
        layers += [GAPSpec(cin, name="gap"),
                   FCSpec(cin, 16, in_bits=8, name="fc1"),
                   FCSpec(16, 12, out_raw=True, name="fc2")]
        spec = CNN1DSpec(in_len=4000, in_channels=1, in_bits=bits0,
                         layers=tuple(layers), name=f"rand{seed}")
        for hf in (1, 2, 3, 4, 6, 8):
            try:
                plan_stream(spec, hop_frames=hf)
            except ValueError:
                continue
            return spec, hf


def model_tensors(plan, weights, thresholds, device, torch):
    """The kernel's operand layout of one model (int8 weights)."""
    def put(x, dt):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    st, fc = plan.convs, plan.fcs
    return dict(
        ws=[put(weights[s.layer_idx].reshape(s.k, s.cin, s.cout),
                torch.int8) for s in st],
        thrs=[put(thresholds[s.layer_idx][0], torch.float32) for s in st],
        flips=[put(thresholds[s.layer_idx][1], torch.int32) for s in st],
        fc_ws=[put(weights[f.layer_idx], torch.int8) for f in fc],
        fc_thrs=[put(thresholds[f.layer_idx][0], torch.float32) for f in fc],
        fc_flips=[put(thresholds[f.layer_idx][1], torch.int32) for f in fc],
    )


def hop_inputs(plan, b, seed, device, torch, mask_zeros=True):
    """Packed hop operands: audio codes, mask, state (non-zero-width)."""
    rng = np.random.default_rng(seed)
    st = plan.convs
    put = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    mask = (rng.random(b) < (0.8 if mask_zeros else 1.1)).astype(np.int32)
    return dict(
        audio=put(rng.integers(0, 256, (b, plan.hop_samples, st[0].cin),
                               dtype=np.int32)),
        mask=put(mask),
        tails=tuple(put(rng.integers(0, 256 if s.in_bits > 1 else 2,
                                     (b, s.tail, s.cin), dtype=np.int32))
                    for s in st if s.tail),
        pendings=tuple(put(rng.integers(0, 2, (b, s.phase, s.cout),
                                        dtype=np.int32))
                       for s in st if s.phase),
        gap=put(rng.integers(0, 256, (b, plan.gap_channels),
                             dtype=np.int32)),
    )


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_case(label, plan, params, inp, model_idx, torch, mk, dispatch,
               slots=None):
    """Kernel vs plain on one case: B.1 emit, B.1 steady, B.2.  Returns
    the max |kernel - plain| per kernel (int32, so 0 when bit-equal).
    ``slots`` forces the slot block (uncounted launches); by default the
    counted entry points pick it."""
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    p = (params["ws"], params["thrs"], params["flips"], params["fc_ws"],
         params["fc_thrs"], params["fc_flips"])
    err = {mk.HOP_KERNEL: 0, mk.FINALIZE_KERNEL: 0}
    for emit in (True, False):
        args = (inp["audio"], inp["mask"], inp["tails"], inp["pendings"],
                inp["gap"], *p, model_idx)
        with dispatch.counting() as launched:
            if slots is None:
                got = mk.hop_megakernel_packed(*args, geoms=geoms, emit=emit,
                                               fc_raw=fc_raw)
            else:
                got = mk._launch(*args, geoms=geoms, emit=emit,
                                 fc_raw=fc_raw, finalize_only=False,
                                 slots=slots)
        if launched() != ({} if slots else {mk.HOP_KERNEL: 1}):
            raise RuntimeError(f"{label}: hop wrapper launched {launched()}")
        want = mk.hop_megakernel_plain(*args, geoms=geoms, emit=emit,
                                       fc_raw=fc_raw)
        torch.cuda.synchronize()
        flat_got = [*got[0], *got[1], got[2]] + ([got[3]] if emit else [])
        flat_want = [*want[0], *want[1], want[2]] + ([want[3]] if emit
                                                     else [])
        for g, w in zip(flat_got, flat_want):
            if g.dtype != torch.int32 or g.shape != w.shape:
                raise RuntimeError(f"{label}: output {g.dtype} {g.shape} "
                                   f"vs {w.dtype} {w.shape}")
            e = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            err[mk.HOP_KERNEL] = max(err[mk.HOP_KERNEL], e)
    fargs = (inp["tails"], inp["pendings"], inp["gap"], *p, model_idx)
    if slots is None:
        got = mk.finalize_megakernel_packed(*fargs, geoms=geoms,
                                            fc_raw=fc_raw)
    else:
        got = mk._launch(None, None, *fargs, geoms=geoms, emit=True,
                         fc_raw=fc_raw, finalize_only=True, slots=slots)
    want = mk.finalize_megakernel_plain(*fargs, geoms=geoms, fc_raw=fc_raw)
    torch.cuda.synchronize()
    err[mk.FINALIZE_KERNEL] = int((got.long() - want.long()).abs().max())
    bad = {k: v for k, v in err.items() if v}
    if bad:
        raise RuntimeError(f"{label}: kernel disagrees with plain: {bad}")
    phase("kernels", f"{label}: B={inp['gap'].shape[0]} bit-equal "
          f"(hop emit+steady, finalize"
          f"{'' if slots is None else f'; slot block forced to {slots}'})")
    return err


def time_ms(fn, torch, iters=20, warmup=3, reps=5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's cost of
    issuing a call (Python, the wrapper's checks, ctypes) does not bound a
    kernel shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def call_ms(fn, torch, iters=20, warmup=3) -> float:
    """Time per call issued back to back from Python, between CUDA events:
    the larger of the device time and the host's cost of issuing it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(plan, params, inp, b, *, finalize: bool, emit: bool):
    """Least time for the same work on an H100: the larger of the bytes
    moved (each input read once, each output written once) over HBM rate
    and the int8 ops (2 per MAC) over the int8 tensor-core peak."""
    macs = 0
    for s in plan.convs:
        per = s.k * s.cin * s.cout
        if not finalize:
            macs += s.n_conv * per
        if finalize or emit:
            macs += s.flush_conv * per
    if finalize or emit:
        macs += sum(f.cin * f.cout for f in plan.fcs)
    macs *= b
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731,E501
    weights = nbytes(params["ws"] + params["thrs"] + params["flips"])
    fc = nbytes(params["fc_ws"] + params["fc_thrs"] + params["fc_flips"])
    state = nbytes(list(inp["tails"]) + list(inp["pendings"]) + [inp["gap"]])
    n_cls = plan.fcs[-1].cout
    if finalize:
        total = state + weights + fc + b * n_cls * 4
    else:
        total = (nbytes([inp["audio"], inp["mask"]]) + 2 * state + weights
                 + ((fc + b * n_cls * 4) if emit else 0))
    t_bytes = total / HBM_BYTES_PER_S
    t_ops = 2 * macs / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3, per-stage kernels (B.3-B.5)
# ---------------------------------------------------------------------------

def multibit_smoke_spec():
    """The smoke spec with conv stage 1 taking an 8-bit offset-binary input
    instead of binary maps (``ROADMAP.md`` C.1)."""
    from repro_torch.models import kws

    spec = kws.build_kws_smoke_spec()
    layers = list(spec.layers)
    layers[1] = dataclasses.replace(layers[1], in_bits=8, in_offset=128)
    return dataclasses.replace(spec, layers=tuple(layers),
                               name="smoke-multibit-b1")


def per_stage_launches(plan, models, b, seed, device, torch,
                       model_idx=None):
    """Every per-stage launch of one emit hop at the plan's shapes, on
    seeded windows and the given models' weights: per conv stage its hop
    window and, where ``flush_conv > 0``, its flush window (B.3 for a
    multi-bit input, else B.4 raw; unpooled, B.4 ``sa`` with pool 1 and 2
    on the hop window too), then the classifier (B.5).  ``models`` holds
    one ``model_tensors`` dict per tenant.  Each entry carries the
    kernel's prepared operands, its MAC count and whether the per-stage
    main path launches it at these shapes on every emit hop (``main``:
    the hop and flush windows' raw convs and the classifier)."""
    from repro_torch.kernels import conv_kernels as bk
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    pooled = model_idx is not None

    def stack(xs):
        return torch.stack(list(xs)) if pooled else xs[0]

    out = []
    for i, s in enumerate(plan.convs):
        cw = ops.conv_weights(stack([m["ws"][i] for m in models]))
        for what, rows, n_pos in (
                ("hop", s.tail + s.n_in, s.n_conv),
                ("flush", s.tail + s.flush_in + s.pad, s.flush_conv)):
            if n_pos <= 0:
                continue
            macs = b * n_pos * s.cout * s.k * s.cin
            kw = dict(stride=s.stride, l_out=n_pos)
            if s.in_bits > 1:
                x = torch.as_tensor(rng.integers(0, 256, (b, rows, s.cin),
                                                 dtype=np.int32),
                                    device=device)
                out.append(dict(label=f"{what} l{i}",
                                name=bk.BITSERIAL_KERNEL,
                                args=(x, cw.w, model_idx),
                                kw=dict(bits=s.in_bits, **kw), macs=macs,
                                cin=s.cin, main=True))
                continue
            xq = ops.pack_activations(torch.as_tensor(
                rng.integers(0, 2, (b, rows, s.cin), dtype=np.int32),
                device=device)).contiguous()
            out.append(dict(label=f"{what} b{i} raw",
                            name=bk.CONV_STEP_KERNEL,
                            args=(xq, cw.wp, cw.wn, None, None, model_idx),
                            kw=dict(k=s.k, mode="raw", **kw), macs=macs,
                            cin=s.cin, w=cw.w, main=True))
            if what == "hop" and not pooled:
                for pool in (1, 2):
                    out.append(dict(
                        label=f"hop b{i} sa pool{pool}",
                        name=bk.CONV_STEP_KERNEL,
                        args=(xq, cw.wp, cw.wn, models[0]["thrs"][i],
                              models[0]["flips"][i], None),
                        kw=dict(k=s.k, mode="sa", pool=pool, **kw),
                        macs=macs, cin=s.cin, main=False))
    gap = torch.as_tensor(rng.integers(0, 300, (b, plan.gap_channels),
                                       dtype=np.int32), device=device)
    fc = {key: [stack([m[key][j] for m in models])
                for j in range(len(plan.fcs))]
          for key in ("fc_ws", "fc_thrs", "fc_flips")}
    out.append(dict(label="classifier", name=bk.TAIL_KERNEL,
                    args=(gap, fc["fc_ws"], fc["fc_thrs"], fc["fc_flips"],
                          model_idx),
                    kw=dict(out_raw=tuple(f.out_raw for f in plan.fcs)),
                    macs=b * sum(f.cin * f.cout for f in plan.fcs),
                    main=True))
    return out


def bitserial_cases(seed, device, torch):
    """``BITSERIAL_CASES`` as per-stage launch entries (see
    :func:`per_stage_launches`): seeded codes wider than the mask, ternary
    weights, and with K=2 a per-slot random pool row."""
    from repro_torch.kernels import conv_kernels as bk

    rng = np.random.default_rng(seed)
    out = []
    for b, l_out, cin, k, stride, cout, bits, km in BITSERIAL_CASES:
        l_in = (l_out - 1) * stride + k + int(rng.integers(0, stride))
        x = torch.as_tensor(rng.integers(0, 1 << 12, (b, l_in, cin),
                                         dtype=np.int32), device=device)
        lead = (km,) if km > 1 else ()
        w = torch.as_tensor(rng.integers(-1, 2, lead + (k, cin, cout),
                                         dtype=np.int8), device=device)
        mi = (torch.as_tensor(rng.integers(0, km, b, dtype=np.int32),
                              device=device) if km > 1 else None)
        tile = bk.bitserial_tiles(b, l_out, cin, k, stride, cout)
        out.append(dict(
            label=f"B={b} l_out={l_out} cin={cin} k={k} stride={stride} "
                  f"cout={cout} bits={bits} K={km} (block {tile.pb})",
            name=bk.BITSERIAL_KERNEL, args=(x, w, mi),
            kw=dict(bits=bits, stride=stride, l_out=l_out),
            macs=b * l_out * cout * k * cin, cin=cin, main=False))
    return out


def step_cases(seed, device, torch):
    """``STEP_CASES`` as per-stage launch entries: seeded packed windows,
    ternary planes, +-inf thresholds and flips, and with K > 1 a per-slot
    random pool row."""
    from repro_torch.kernels import conv_kernels as bk
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    out = []
    for b, cin, cout, k, stride, l_out, mode, pool, km in STEP_CASES:
        l_in = (l_out - 1) * stride + k + int(rng.integers(0, 3))
        xq = ops.pack_activations(torch.as_tensor(rng.integers(
            0, 2, (b, l_in, cin), dtype=np.int32), device=device))
        lead = (km,) if km > 1 else ()
        w = torch.as_tensor(rng.integers(-1, 2, lead + (k, cin, cout),
                                         dtype=np.int32), device=device)
        wp, wn = ops.pack_weight_planes(w)
        thr = np.round(rng.normal(0, 3, cout)).astype(np.float32)
        thr[:2] = (np.inf, -np.inf)
        flip = (rng.random(cout) < 0.3).astype(np.int32)
        mi = (torch.as_tensor(rng.integers(0, km, b, dtype=np.int32),
                              device=device) if km > 1 else None)
        sa = mode == "sa"
        out.append(dict(
            label=f"B={b} cin={cin} cout={cout} k={k} stride={stride} "
                  f"l_out={l_out} {mode} pool={pool} K={km}",
            name=bk.CONV_STEP_KERNEL,
            args=(xq.contiguous(), wp.contiguous(), wn.contiguous(),
                  torch.as_tensor(thr, device=device) if sa else None,
                  torch.as_tensor(flip, device=device) if sa else None, mi),
            kw=dict(k=k, stride=stride, l_out=l_out, pool=pool, mode=mode),
            macs=b * l_out * cout * k * cin, main=False))
    return out


def tail_cases(seed, device, torch):
    """``TAIL_CASES`` as per-stage launch entries: GAP counts past 255,
    ternary fc weights, +-inf thresholds and flips per tenant."""
    from repro_torch.kernels import conv_kernels as bk

    rng = np.random.default_rng(seed)
    out = []
    for b, dims, out_raw, km in TAIL_CASES:
        lead = (km,) if km > 1 else ()
        put = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
        ws, thrs, flips = [], [], []
        for j in range(len(out_raw)):
            ws.append(put(rng.integers(-1, 2, lead + dims[j:j + 2],
                                       dtype=np.int8)))
            thr = np.round(rng.normal(0, 40 if j == 0 else 3,
                                      lead + (dims[j + 1],)))
            thr.flat[:2] = (np.inf, -np.inf)
            thrs.append(put(thr.astype(np.float32)))
            flips.append(put((rng.random(lead + (dims[j + 1],)) < 0.3)
                             .astype(np.int32)))
        mi = (put(rng.integers(0, km, b, dtype=np.int32)) if km > 1
              else None)
        out.append(dict(
            label=f"B={b} widths={dims} K={km}", name=bk.TAIL_KERNEL,
            args=(put(rng.integers(0, 400, (b, dims[0]), dtype=np.int32)),
                  ws, thrs, flips, mi),
            kw=dict(out_raw=out_raw),
            macs=b * sum(a * c for a, c in zip(dims, dims[1:])),
            main=False))
    return out


def step_sweep(launches, torch, bk, sms):
    """B.4 at every launch shape (slot block x n-tiles a CTA, with the
    rule's MMA item) that fits, on each hop window of the main path:
    every shape bit-equal to the rule's output, then device ms.  Uncounted
    launches."""
    rows = []
    for e in launches:
        if e["name"] != bk.CONV_STEP_KERNEL or not e["label"].startswith(
                "hop") or e["kw"].get("mode") != "raw":
            continue
        x, wp = e["args"][0], e["args"][1]
        b, _, cw = x.shape
        k, stride, l_out = e["kw"]["k"], e["kw"]["stride"], e["kw"]["l_out"]
        cout = wp.shape[-1]
        nt, rows_in = -(-cout // 8), bk.step_rows(l_out, 1, stride, k)
        pick = bk.conv_step_tiles(b, cw, k, stride, cout, l_out, 1, False,
                                  sms)
        want = bk.bnn_conv1d_step(*e["args"], **e["kw"])
        shapes = []
        for slots in bk.STEP_SLOTS:
            if slots > 1 and slots // 2 >= b:
                break
            for ntb in sorted({-(-nt // (1 << i))
                               for i in range(nt.bit_length() + 1)}):
                smem = bk.step_smem(min(slots, b), ntb, cw, k, rows_in)
                if smem > bk.MAX_SMEM:
                    continue
                ng, mc = bk.step_item(min(slots, b) * l_out, ntb)
                t = bk.StepTile(slots, ntb, ng, mc, smem)
                fn = lambda t=t: bk._conv_step_cuda(  # noqa: E731
                    *e["args"], pool=1, **e["kw"], tile=t)
                if not torch.equal(fn(), want):
                    raise RuntimeError(f"B.4 {e['label']} tile {t} differs")
                shapes.append(dict(
                    slots=slots, ntb=ntb, ng=ng, mc=mc, smem=smem,
                    ctas=-(-b // slots) * -(-nt // ntb),
                    picked=(slots, ntb) == (pick.slots, pick.ntb),
                    ms=time_ms(fn, torch)))
        shapes.sort(key=lambda r: r["ms"])
        rank = [r["picked"] for r in shapes].index(True)
        rows.append(dict(label=e["label"], shapes=shapes, picked_rank=rank))
        best, got = shapes[0], shapes[rank]
        phase("kernels", f"B.4 tile sweep {e['label']} ({len(shapes)} "
              f"shapes, each bit-equal): picked S={got['slots']} "
              f"n-tiles={got['ntb']} item {got['ng']}x{got['mc']} "
              f"{got['ms']:.4f} ms (rank {rank}); fastest S="
              f"{best['slots']} n-tiles={best['ntb']} item "
              f"{best['ng']}x{best['mc']} {best['ms']:.4f} ms")
    return rows


def tail_sweep(entry, torch, bk, sms):
    """B.5 at every slot block x cluster size, at ``TAIL_SWEEP_B`` slots
    of the main path's classifier operands: each bit-equal to the plain
    version, then device ms.  Uncounted launches."""
    gap, ws, thrs, flips, _ = entry["args"]
    out_raw = entry["kw"]["out_raw"]
    rows = []
    for b in TAIL_SWEEP_B:
        g = gap[:b].contiguous()
        want = bk.classifier_tail_plain(g, ws, thrs, flips, out_raw=out_raw)
        pick = bk.tail_block(b, -(-ws[0].shape[-1] // 8), sms)
        shapes = []
        for cluster in bk.TAIL_CLUSTERS:
            for slots in bk.TAIL_SLOTS:
                fn = lambda s=slots, c=cluster: bk._tail_cuda(  # noqa: E731
                    g, ws, thrs, flips, None, out_raw=out_raw, slots=s,
                    cluster=c)
                if not torch.equal(fn(), want):
                    raise RuntimeError(f"B.5 B={b} S={slots} C={cluster} "
                                       "differs from plain")
                shapes.append(dict(slots=slots, cluster=cluster,
                                   picked=(slots, cluster) == pick,
                                   ms=time_ms(fn, torch)))
        shapes.sort(key=lambda r: r["ms"])
        rank = [r["picked"] for r in shapes].index(True)
        rows.append(dict(b=b, shapes=shapes, picked_rank=rank))
        phase("kernels", f"B.5 slot sweep B={b} (each bit-equal): "
              + ", ".join(f"S={r['slots']} C={r['cluster']} {r['ms']:.4f}"
                          f"{' [picked]' if r['picked'] else ''}"
                          for r in shapes))
    return rows


def mma_rate(build, torch):
    """SM cycles per warp-wide MMA on the card (``csrc/mma_rate.cu``): the
    u8 m16n8k32 and the 1-bit m16n8k256 .and.popc, at issue rate (a block
    of 8 warps x 4 chains on every SM) and at latency (one warp, one
    chain)."""
    import ctypes

    lib = build.load("mma_rate")
    lib.mma_rate_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    lib.mma_rate_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, out = 4096, {}
    for kind, name in ((0, "u8 m16n8k32"), (1, "b1 m16n8k256 and.popc")):
        for chains, blocks, threads, what in ((4, sms, 256, "issue"),
                                              (1, 1, 32, "latency")):
            cyc = torch.zeros(blocks, dtype=torch.int64, device="cuda")
            sink = torch.zeros(1, dtype=torch.int32, device="cuda")
            for _ in range(2):   # the second run is the one read
                rc = lib.mma_rate_launch(
                    kind, chains, iters, blocks, threads, cyc.data_ptr(),
                    sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"mma rate launch: CUDA error {rc}")
            torch.cuda.synchronize()
            out[f"{name} {what}"] = cyc.double().mean().item() / (
                iters * chains * (threads // 32))
    phase("kernels", "mma rate, SM cycles per MMA (issue / latency): " +
          "; ".join(f"{n}: {out[n + ' issue']:.3f} / "
                    f"{out[n + ' latency']:.2f}"
                    for n in ("u8 m16n8k32", "b1 m16n8k256 and.popc")) +
          " (a b1 MMA does 8x the depth of a u8 one; a ternary product "
          "takes two)")
    return out


def slot_sweep(plan, params, inp, torch, mk):
    """The hop kernel at every slot block of ``SLOT_SWEEP`` that fits the
    plan, at B=256: emit hop, steady hop and finalize, device ms (weights
    laid out once, as the scheduler holds them).  Uncounted launches; a
    block that does not fit is recorded with the reason."""
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    fc_dims = [(f.cin, f.cout) for f in plan.fcs]
    hw = mk.prepare_hop_weights(params["ws"], params["fc_ws"])
    rest = (params["thrs"], params["flips"], params["fc_ws"],
            params["fc_thrs"], params["fc_flips"], None)
    state = (inp["tails"], inp["pendings"], inp["gap"], hw)
    picked = mk.slot_block(inp["gap"].shape[0], geoms, fc_dims,
                           plan.gap_channels, mk._sms(inp["gap"].device))
    rows = []
    for slots in SLOT_SWEEP:
        try:
            lay = mk.cta_layout(geoms, fc_dims, plan.gap_channels, slots)
        except ValueError as e:
            rows.append(dict(slots=slots, fits=False, reason=str(e)))
            phase("kernels", f"slot sweep S={slots}: does not fit ({e})")
            continue
        ms = {}
        for key, emit, fin in (("emit", True, False), ("steady", False,
                                                       False),
                               ("finalize", True, True)):
            a, m = (None, None) if fin else (inp["audio"], inp["mask"])
            ms[key] = time_ms(lambda: mk._launch(  # noqa: B023
                a, m, *state, *rest, geoms=geoms, emit=emit, fc_raw=fc_raw,
                finalize_only=fin, slots=slots), torch)
        rows.append(dict(slots=slots, fits=True, chunk_tiles=lay.chunk_tiles,
                         smem=lay.smem, picked=slots == picked.slots, **ms))
        phase("kernels", f"slot sweep S={slots} (chunks of "
              f"{lay.chunk_tiles} n-tiles, {lay.smem} B): emit "
              f"{ms['emit']:.4f} ms, steady {ms['steady']:.4f} ms, finalize "
              f"{ms['finalize']:.4f} ms{' [picked]' if slots == picked.slots else ''}"
              f"; earlier design (one CTA per slot): {EARLIER_MS['emit']} / "
              f"{EARLIER_MS['steady']} / {EARLIER_MS['finalize']} ms")
    return rows


def per_stage_fns(bk):
    """kernel name -> (kernel entry point, plain version)."""
    return {bk.BITSERIAL_KERNEL: (bk.bnn_bitserial_step,
                                  bk.bitserial_step_plain),
            bk.CONV_STEP_KERNEL: (bk.bnn_conv1d_step, bk.conv_step_plain),
            bk.TAIL_KERNEL: (bk.classifier_tail, bk.classifier_tail_plain)}


def check_per_stage(label, launches, torch, bk, dispatch):
    """Each per-stage kernel vs its plain version on the same operands on
    the card; returns the max |kernel - plain| per kernel name."""
    fns = per_stage_fns(bk)
    err = {}
    for e in launches:
        kernel, plain = fns[e["name"]]
        with dispatch.counting() as launched:
            got = kernel(*e["args"], **e["kw"])
        if launched() != {e["name"]: 1}:
            raise RuntimeError(f"{label} {e['label']}: launched "
                               f"{launched()}")
        want = plain(*e["args"], **e["kw"])
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"{label} {e['label']}: output {got.dtype} "
                               f"{tuple(got.shape)} vs {tuple(want.shape)}")
        d = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        err[e["name"]] = max(err.get(e["name"], 0), d)
        if d:
            raise RuntimeError(f"{label} {e['label']}: kernel disagrees "
                               f"with plain by {d}")
    phase("kernels", f"{label}: B={launches[-1]['args'][0].shape[0]} "
          f"bit-equal ({', '.join(e['label'] for e in launches)})")
    return err


def nbytes(xs) -> int:
    """Bytes of every tensor in a nest of tuples/lists (None skipped)."""
    if xs is None:
        return 0
    if isinstance(xs, (list, tuple)):
        return sum(nbytes(x) for x in xs)
    return xs.numel() * xs.element_size()


def launch_bound_ms(e, out) -> tuple[float, float, float]:
    """(bound ms, byte time, op time) of one per-stage launch: each input
    read once and the output written once over the HBM rate, against
    2 ops per MAC over the int8 tensor-core peak."""
    t_bytes = (nbytes(e["args"]) + nbytes(out)) / HBM_BYTES_PER_S
    t_ops = 2 * e["macs"] / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, t_bytes, t_ops


def aggregate(recs) -> dict:
    """kernel name -> its timed records summed over its launch shapes:
    ms, call_ms, plain_ms, bound_ms and the bound's byte and op times,
    and library_ms only where every one of those shapes has one."""
    out = {}
    for rec in recs:
        agg = out.setdefault(rec["name"], dict(
            ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_s=0.0,
            ops_s=0.0, library_ms=0.0))
        for key in ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_s",
                    "ops_s"):
            agg[key] += rec[key]
        agg["library_ms"] = (None if agg["library_ms"] is None
                             or rec["library_ms"] is None
                             else agg["library_ms"] + rec["library_ms"])
    return out


def library_call(e, torch):
    """The one PyTorch call computing a raw conv launch's function —
    ``conv1d`` in float32 (TF32 off) on the masked codes (B.3) or the
    unpacked bits (B.4) — as (callable, its output in the kernel's
    layout), operands made ahead of the timed call."""
    from repro_torch.core.quant import unpack_bits
    from repro_torch.kernels import conv_kernels as bk

    F = torch.nn.functional
    if e["name"] == bk.BITSERIAL_KERNEL:
        x, w, _ = e["args"]
        xf = (x & bk.code_mask(e["kw"]["bits"])).float()
    else:
        x, w = e["args"][0], e["w"]
        xf = unpack_bits(x)[..., :e["cin"]].float()
    xf = xf.permute(0, 2, 1).contiguous()            # (B, Cin, L)
    wf = w.float().permute(2, 1, 0).contiguous()      # (Cout, Cin, K)
    stride = e["kw"]["stride"]

    def call():
        return F.conv1d(xf, wf, stride=stride)
    return call, lambda y: y[..., :e["kw"]["l_out"]].permute(0, 2, 1)


# ---------------------------------------------------------------------------
# Phase 5: the kernel library (B.6-B.8, and B.3 through ops)
# ---------------------------------------------------------------------------

#: ``benchmarks/kernel_bench.py``'s two GEMMs, then one where the
#: reference's cost model picks the int8 path
GEMM_SHAPES = ((1, 1024, 512), (256, 1024, 512), (8192, 1024, 4096))
BENCH_GEMMS = GEMM_SHAPES[:2]
#: ``tests/test_kernels.py``'s unaligned GEMMs
UNALIGNED_GEMMS = ((7, 100, 12), (33, 513, 65))
#: shapes on both sides of the GEMM kernels' tile thresholds (M = 12 / 13:
#: B.8's GEMV / wgmma tiles; 16 / 17: B.7's one / several row blocks;
#: 64 / 65: one / two 64-row tiles; M = 384 / 385 at N = 4096: 48 / 64
#: tiles of 128 x 256, B.8's 64 x 64 K-split / 128 x 256 tiles; M = 2048 /
#: 2049 at N = 512: 256 / 264 tiles of 64 x 64, B.7's GEMV / 64 x 64
#: tiles), with ragged N and K
THRESHOLD_GEMMS = ((2, 32, 65), (8, 100, 130), (12, 1024, 512),
                   (13, 513, 4096), (16, 513, 512), (17, 1024, 12),
                   (64, 2100, 130), (65, 100, 4096), (256, 513, 65),
                   (384, 2100, 4096), (385, 100, 4096), (2048, 100, 512),
                   (2049, 513, 512), (8192, 32, 512))
#: (M, K, N) at which every tile of each GEMM kernel is timed, to place
#: the thresholds: B.8's GEMV / wgmma crossover (M = 8-17), B.7's GEMV /
#: 64 x 64 switch at 128 to 8,192 tiles of 64 x 64 (one and two waves on
#: 132 SMs: 128 at (1024, *, 512), 136 at (1088, *, 512), 256 at (2048,
#: *, 512)), and B.8's 64 x 64 K-split / 128 x 256 choice at 4 to 1,024
#: tiles of 128 x 256 (and at K = 32, one ring slice)
TILE_SWEEP = ((8, 1024, 512), (12, 1024, 512), (16, 1024, 512),
              (17, 1024, 512),
              (32, 1024, 512), (64, 1024, 512), (256, 1024, 512),
              (1024, 1024, 512), (1088, 1024, 512), (2048, 1024, 512),
              (8192, 1024, 512), (256, 1024, 4096), (512, 1024, 4096),
              (1024, 1024, 4096), (2048, 1024, 4096), (8192, 1024, 4096),
              (8192, 32, 512))


def library_entries(spec, weights, thresholds, seed, device, torch):
    """Every kernel-library launch the phase checks, as entries like
    ``per_stage_launches``': the kernel's prepared operands, its MACs, and
    whether the library path launches it at these shapes (``main``).

    B.3 at the utterance's bit-serial l0; B.6 at its three conv blocks
    (``sa`` pool 2, the path, and raw), and with k=7 stride=2 pad=3 and
    an even k=2 at pool 1, 2 and 4 and raw; B.7 raw and ``sa`` and B.8 at
    ``GEMM_SHAPES``, ``UNALIGNED_GEMMS`` and ``THRESHOLD_GEMMS``, and B.7
    raw and ``sa`` at the utterance's fc1 (8 bit-plane rows) and fc2."""
    from repro_torch.core import quant
    from repro_torch.core.cnn_spec import Conv1DSpec, FCSpec
    from repro_torch.kernels import conv_kernels as bk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import twm_matmul as tm

    rng = np.random.default_rng(seed)
    put = lambda x, dt: torch.as_tensor(np.asarray(x)).to(device, dt)  # noqa: E731,E501
    out = []

    def conv(label, l, w, thr, flip, stride, pad, pool, mode, main=False,
             timed=False):
        k, cin, cout = w.shape
        cw = ops.conv_weights(put(w, torch.int32))
        x = put(rng.integers(0, 2, (l, cin)), torch.int32)
        l_out = ref.conv1d_out_len(l, k, stride, pad)
        sa = mode == "sa"
        used = (l_out // pool) * pool if sa else l_out
        out.append(dict(
            label=label, name=bk.CONV_KERNEL,
            args=(ops.pack_activations(x).contiguous(), cw.wp, cw.wn,
                  put(thr, torch.float32) if sa else None,
                  put(flip, torch.int32) if sa else None),
            kw=dict(k=k, stride=stride, pad=pad, l_out=l_out,
                    pool=pool if sa else 1, mode=mode),
            macs=used * cout * k * cin, main=main, timed=timed,
            lib=dict(x=x, w=cw.w, stride=stride, pad=pad)))

    length = spec.in_len
    for li, lay in enumerate(spec.layers):
        if not isinstance(lay, Conv1DSpec):
            continue
        if lay.in_bits > 1:
            # B.3 as ``ops.bitserial_conv1d`` launches it: one stream, the
            # edges padded with the offset code
            w = weights[li].reshape(lay.k, lay.cin, lay.cout)
            edge = np.full((lay.pad, lay.cin), lay.in_offset)
            codes = rng.integers(0, 1 << lay.in_bits, (length, lay.cin))
            l_out = ref.conv1d_out_len(length, lay.k, lay.stride, lay.pad)
            out.append(dict(
                label=f"{lay.name} bit-serial", name=bk.BITSERIAL_KERNEL,
                args=(put(np.concatenate([edge, codes, edge])[None],
                          torch.int32),
                      ops.conv_weights(put(w, torch.int32)).w, None),
                kw=dict(bits=lay.in_bits, stride=lay.stride, l_out=l_out),
                macs=l_out * lay.cout * lay.k * lay.cin, main=True,
                timed=True))
        else:
            w = weights[li].reshape(lay.k, lay.cin, lay.cout)
            thr, flip = thresholds[li]
            for mode in ("sa", "raw"):
                conv(f"{lay.name} {mode}", length, w, thr, flip,
                     lay.stride, lay.pad, lay.pool, mode,
                     main=mode == "sa", timed=True)
        length = lay.out_len(length)
    for label, (l, cin, cout, k, stride, pad) in (
            ("k7 s2 p3", (2000, 64, 128, 7, 2, 3)),
            ("k2 s2 p0", (1001, 100, 65, 2, 2, 0))):
        w = rng.integers(-1, 2, (k, cin, cout))
        thr = np.round(rng.normal(0, 4, cout))
        thr[:2] = [np.inf, -np.inf]
        flip = rng.random(cout) < 0.3
        for pool in (1, 2, 4):
            conv(f"{label} sa pool{pool}", l, w, thr, flip, stride, pad,
                 pool, "sa")
        conv(f"{label} raw", l, w, thr, flip, stride, pad, 1, "raw")

    def gemm(label, x, w, thr, flip, main_mode=None, timed=False,
             mxu=True):
        m, kdim = x.shape
        n = w.shape[1]
        xt, wt = put(x, torch.int32), put(w, torch.int32)
        xq = ops.pack_activations(xt).contiguous()
        wp, wn = (p.contiguous() for p in ops.pack_weight_planes(wt))
        t32, f32 = put(thr, torch.float32), put(flip, torch.int32)
        xf, wf = xt.float(), wt.float()
        for mode in ("raw", "sa"):
            out.append(dict(
                label=f"{label} {mode}", name=tm.POPCOUNT_KERNEL,
                args=(xq, wp, wn) + ((t32, f32) if mode == "sa" else ()),
                kw=dict(mode=mode), macs=m * kdim * n,
                main=mode == main_mode, timed=timed, shape=(m, kdim, n),
                lib=dict(xf=xf, wf=wf)))
        if not mxu:
            return
        x8 = quant.pad_to_multiple(xt.to(torch.int8), tm.MXU_K,
                                   1).contiguous()
        wt8 = quant.pad_to_multiple(wt.to(torch.int8).t(), tm.MXU_K,
                                    1).contiguous()
        out.append(dict(
            label=f"{label} sa", name=tm.MXU_KERNEL,
            args=(x8, wt8, t32, f32), kw={}, macs=m * kdim * n,
            main=main_mode == "sa", timed=timed, shape=(m, kdim, n),
            lib=None))

    def dense(m, kdim, n):
        x = rng.integers(0, 2, (m, kdim))
        w = rng.integers(-1, 2, (kdim, n))
        thr = np.round(rng.normal(0, 3, n))
        thr[:2] = [np.inf, -np.inf]
        return x, w, thr, rng.random(n) < 0.4

    for shape in GEMM_SHAPES + UNALIGNED_GEMMS + THRESHOLD_GEMMS:
        gemm(str(shape), *dense(*shape),
             main_mode="sa" if shape in BENCH_GEMMS else None,
             timed=True)
    (l1, fc1), (l2, fc2) = [(li, lay) for li, lay in enumerate(spec.layers)
                            if isinstance(lay, FCSpec)]
    no_sa = lambda n: (np.zeros(n), np.zeros(n, bool))  # noqa: E731
    gemm("fc1 bit planes", rng.integers(0, 2, (fc1.in_bits, fc1.cin)),
         weights[l1], *no_sa(fc1.cout), main_mode="raw", timed=True,
         mxu=False)
    gemm("fc2", rng.integers(0, 2, (1, fc2.cin)), weights[l2],
         *no_sa(fc2.cout), main_mode="raw", timed=True, mxu=False)
    return out


def library_fns(bk, tm):
    """kernel name -> (kernel entry point, plain version)."""
    return {bk.BITSERIAL_KERNEL: (bk.bnn_bitserial_step,
                                  bk.bitserial_step_plain),
            bk.CONV_KERNEL: (bk.bnn_conv1d, bk.conv1d_plain),
            tm.POPCOUNT_KERNEL: (tm.twm_matmul, tm.twm_matmul_plain),
            tm.MXU_KERNEL: (tm.twm_matmul_mxu, tm.twm_matmul_mxu_plain)}


def check_library(entries, torch, fns, dispatch, tag="library"):
    """Each library kernel vs its plain version on the same operands on
    the card; returns the max |kernel - plain| per kernel name."""
    err = {}
    for e in entries:
        kernel, plain = fns[e["name"]]
        with dispatch.counting() as launched:
            got = kernel(*e["args"], **e["kw"])
        if launched() != {e["name"]: 1}:
            raise RuntimeError(f"library {e['label']}: launched {launched()}")
        want = plain(*e["args"], **e["kw"])
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"library {e['label']}: output {got.dtype} "
                               f"{tuple(got.shape)} vs {tuple(want.shape)}")
        d = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        err[e["name"]] = max(err.get(e["name"], 0), d)
        if d:
            raise RuntimeError(f"library {e['label']} ({e['name']}): kernel "
                               f"disagrees with plain by {d}")
    phase(tag, f"{len(entries)} launches bit-equal to their plain "
          f"versions: " + ", ".join(f"{e['name']} {e['label']}"
                                    for e in entries))
    return err


def library_yardstick(e, out, torch, tm):
    """The one PyTorch call computing a library launch's contraction --
    ``conv1d`` (B.3, B.6) or a matmul (B.7, and B.8 where ``torch._int_mm``
    refuses the shape), float32 with TF32 off, exact as every partial sum
    is below 2^24, or ``torch._int_mm`` (B.8) -- checked, with the SA and
    pool applied where the kernel applies them, against the kernel's
    output; returns (callable, its name)."""
    from repro_torch.kernels import conv_kernels as bk

    F = torch.nn.functional
    what = "float32 matmul"
    if e["name"] == bk.BITSERIAL_KERNEL:
        call, to_kernel_layout = library_call(e, torch)
        got = to_kernel_layout(call()).to(torch.int32)
        what = "conv1d"
    elif e["name"] == tm.MXU_KERNEL:
        x8, wt8, thr, flip = e["args"]
        m, kp = x8.shape
        if m > 16 and kp % 8 == 0 and wt8.shape[0] % 8 == 0:
            w8 = wt8.t()
            what = "_int_mm"

            def call():
                return torch._int_mm(x8, w8)
        else:   # ``_int_mm`` needs M > 16
            xf, wf = x8.float(), wt8.float().t().contiguous()

            def call():
                return xf @ wf
        got = ((call().float() >= thr) ^ (flip != 0)).to(torch.int32)
    elif e["name"] == tm.POPCOUNT_KERNEL:
        xf, wf = e["lib"]["xf"], e["lib"]["wf"]

        def call():
            return xf @ wf
        got = call().to(torch.int32)
        if e["kw"]["mode"] == "sa":
            thr, flip = e["args"][3:]
            got = ((got.float() >= thr) ^ (flip != 0)).to(torch.int32)
    else:
        lib = e["lib"]
        xf = lib["x"].float().t()[None].contiguous()           # (1, Cin, L)
        wf = lib["w"].float().permute(2, 1, 0).contiguous()    # (Cout, Cin, K)

        def call():
            return F.conv1d(xf, wf, stride=lib["stride"], padding=lib["pad"])
        got = call()[0].t().to(torch.int32)
        what = "conv1d"
        if e["kw"]["mode"] == "sa":
            thr, flip = e["args"][3:]
            pool = e["kw"]["pool"]
            y = ((got.float() >= thr) ^ (flip != 0)).to(torch.int32)
            n = y.shape[0] // pool
            got = y[:n * pool].reshape(n, pool, -1).amax(1)
    if not torch.equal(got, out):
        raise RuntimeError(f"the PyTorch yardstick disagrees with "
                           f"{e['name']} {e['label']}")
    return call, what


def gemm_tile(e, tm) -> str | None:
    """The tile a B.7 or B.8 launch takes (None for the conv kernels)."""
    if e["name"] == tm.POPCOUNT_KERNEL:
        x, wp = e["args"][:2]
        return tm._popcount_tile(x.shape[0], x.shape[1], wp.shape[1],
                                 tm._sms(x.device)).kind
    if e["name"] == tm.MXU_KERNEL:
        x, wt = e["args"][:2]
        return tm._mxu_tile(x.shape[0], wt.shape[0], x.shape[1],
                            tm._sms(x.device)).kind
    return None


def tile_sweep(entries, torch, tm, seed, dev):
    """Both tiles of B.7 (``sa``) and the three of B.8 (GEMV-shaped and
    both wgmma tiles) timed at ``TILE_SWEEP``'s shapes, each checked
    bit-equal to its plain version first: where one tile stops winning
    places each threshold.  These launches go straight to the tile and are
    not counted."""
    from repro_torch.kernels import ops
    from repro_torch.core import quant

    rng = np.random.default_rng(seed)
    sms = tm._sms(dev)
    rows = []
    for m, k, n in TILE_SWEEP:
        x = torch.as_tensor(rng.integers(0, 2, (m, k), dtype=np.int32),
                            device=dev)
        w = torch.as_tensor(rng.integers(-1, 2, (k, n), dtype=np.int32),
                            device=dev)
        thr = torch.as_tensor(np.round(rng.normal(0, 3, n)).astype(
            np.float32), device=dev)
        flip = torch.as_tensor((rng.random(n) < 0.4).astype(np.int32),
                               device=dev)
        xq = ops.pack_activations(x).contiguous()
        wp, wn = (p.contiguous() for p in ops.pack_weight_planes(w))
        x8 = quant.pad_to_multiple(x.to(torch.int8), tm.MXU_K,
                                   1).contiguous()
        wt8 = quant.pad_to_multiple(w.to(torch.int8).t(), tm.MXU_K,
                                    1).contiguous()
        kw, kp = xq.shape[1], x8.shape[1]
        r16 = tm._rows_per_cta(m)
        g7 = tm._popcount_tile(1, kw, n, sms)
        g8 = tm._mxu_tile(1, n, kp, sms)
        wgmma = [tm.Tile(f"wgmma{bm}x{bn}", code, bm, bn, split,
                         (min(-(-m // bm) * -(-n // bn), sms), 1))
                 for code, bm, bn, split in tm._WGMMA_TILES]
        cands = {
            tm.POPCOUNT_KERNEL: [
                g7._replace(rows=r16, grid=(g7.grid[0], -(-m // r16))),
                tm.Tile("tile64", 1, 64, 64, 1, (-(-n // 64),
                                                 -(-m // 64)))],
            tm.MXU_KERNEL: [
                g8._replace(rows=r16, grid=(g8.grid[0], -(-m // r16))),
                *wgmma]}
        picked = {tm.POPCOUNT_KERNEL: tm._popcount_tile(m, kw, n, sms).kind,
                  tm.MXU_KERNEL: tm._mxu_tile(m, n, kp, sms).kind}
        want = tm.twm_matmul_plain(xq, wp, wn, thr, flip, mode="sa")
        for name, tiles in cands.items():
            times = {}
            for tile in tiles:
                if name == tm.POPCOUNT_KERNEL:
                    fn = lambda t=tile: tm._twm_cuda(  # noqa: E731
                        xq, wp, wn, thr, flip, mode="sa", tile=t)
                else:
                    fn = lambda t=tile: tm._mxu_cuda(  # noqa: E731
                        x8, wt8, thr, flip, tile=t)
                if not torch.equal(fn(), want):
                    raise RuntimeError(f"tile sweep {(m, k, n)} {name} "
                                       f"{tile.kind} disagrees with plain")
                times[tile.kind] = time_ms(fn, torch)
            rows.append(dict(shape=[m, k, n], name=name, ms=times,
                             picked=picked[name],
                             fastest=min(times, key=times.get)))
            phase("library", f"tile sweep {(m, k, n)} {name}: " + ", ".join(
                f"{kd} {t:.4f} ms" for kd, t in times.items())
                + f"; picked {picked[name]}, fastest {rows[-1]['fastest']}")
    return rows


def block_sweep(entries, torch, bk, sms):
    """B.6 at every launch shape on the utterance's b1-b3 (``sa`` pool 2,
    as the library path launches them): every block of pooled positions x
    n-tiles that fits with the rule's MMA item, and every item at the
    rule's block, each bit-equal to the plain version first, then device
    ms.  Uncounted launches."""
    rows = []
    for e in entries:
        if e["name"] != bk.CONV_KERNEL or not e["main"]:
            continue
        x, wp, wn, thr, flip = e["args"]
        cw, cout = x.shape[1], wp.shape[-1]
        k, stride = e["kw"]["k"], e["kw"]["stride"]
        npool = e["kw"]["pool"]
        n_pos = e["kw"]["l_out"] // npool
        nt = -(-cout // 8)
        pick = bk.conv_block_tiles(cw, k, stride, cout, n_pos, npool, sms)
        want = bk.conv1d_plain(*e["args"], **e["kw"])
        wf = bk.prepare_step_weights(wp, wn)
        cands = []
        for pb in bk.CONV_BLOCKS:
            for ntb in sorted({-(-nt // (1 << i))
                               for i in range(nt.bit_length() + 1)}):
                smem = bk.block_smem(min(pb, n_pos), ntb, cw, k, stride,
                                     npool)
                if smem <= bk.MAX_SMEM:
                    item = bk.step_item(min(pb, n_pos), ntb)
                    cands.append(bk.BlockTile(pb, ntb, *item, smem))
        cands += [pick._replace(ng=ng, mc=mc) for ng, mc in bk.STEP_ITEMS
                  if (ng, mc) != (pick.ng, pick.mc)]
        shapes = []
        for t in cands:
            fn = lambda t=t: bk._conv1d_cuda(  # noqa: E731
                *e["args"], **e["kw"], wf=wf, tile=t)
            if not torch.equal(fn(), want):
                raise RuntimeError(f"B.6 {e['label']} shape {t} differs")
            shapes.append(dict(t._asdict(), picked=t == pick,
                               ctas=-(-n_pos // t.pb) * -(-nt // t.ntb),
                               ms=time_ms(fn, torch)))
        shapes.sort(key=lambda r: r["ms"])
        rank = [r["picked"] for r in shapes].index(True)
        rows.append(dict(label=e["label"], shapes=shapes, picked_rank=rank))
        best, got = shapes[0], shapes[rank]
        fmt = lambda r: (f"positions={r['pb']} n-tiles={r['ntb']} item "  # noqa: E731,E501
                         f"{r['ng']}x{r['mc']} ({r['ctas']} CTAs) "
                         f"{r['ms']:.4f} ms")
        phase("library", f"B.6 shape sweep {e['label']} ({len(shapes)} "
              f"shapes, each bit-equal): picked {fmt(got)} (rank {rank}); "
              f"fastest {fmt(best)}; slowest {fmt(shapes[-1])}")
    return rows


def run_library_path(spec, weights, thresholds, audio, seed, dev, torch,
                     kws, ops, dispatch):
    """The library path, counted: one utterance through
    ``kws.offline_logits`` on the card, then ``kernel_bench.py``'s two
    GEMMs through ``ops.twm_linear`` and ``ops.twm_linear_mxu`` (``sa``,
    as the bench runs them).  Returns (logits, GEMM outputs, launches of
    the utterance, launches of the GEMMs)."""
    rng = np.random.default_rng(seed)
    gemm_in = []
    for m, k, n in BENCH_GEMMS:
        gemm_in.append(tuple(torch.as_tensor(a, device=dev) for a in (
            rng.integers(0, 2, (m, k), dtype=np.int32),
            rng.integers(-1, 2, (k, n), dtype=np.int32),
            np.round(rng.normal(0, 3, n)).astype(np.float32),
            (rng.random(n) < 0.4).astype(np.int32))))
    audio_t = torch.as_tensor(audio, device=dev)
    torch.cuda.synchronize()
    dispatch.reset()   # the utterance's counts start here
    logits = kws.offline_logits(spec, weights, thresholds, audio_t)
    utt = dispatch.counts()
    dispatch.reset()   # the GEMMs' counts start here
    gemms = [(ops.twm_linear(*a, mode="sa"), ops.twm_linear_mxu(*a))
             for a in gemm_in]
    torch.cuda.synchronize()
    return logits, gemms, gemm_in, utt, dispatch.counts()


# ---------------------------------------------------------------------------
# Phase 6: the main path
# ---------------------------------------------------------------------------

def drive(sched, audio, chunk_plan, hop, torch):
    """256 streams join, get their audio in ragged chunks, the scheduler
    steps until starved; stream 0 is topped up to a hop boundary; two
    peeks; 8 closes.  Returns per-hop records, peeks, closes, hop times."""
    n = len(audio)
    for sid in range(n):
        sched.add_stream(sid)
    hops, hop_ms = [], []
    fed = [0] * n

    def step_all():
        while True:
            t0 = time.perf_counter()
            hb = sched.step_batch()  # ends in a device synchronize
            if hb is None:
                return
            hop_ms.append((time.perf_counter() - t0) * 1e3)
            hops.append((hb.sids.copy(), hb.frames.copy(),
                         None if hb.logits is None else hb.logits.copy()))

    for sizes in chunk_plan:
        sids = [s for s in range(n) if sizes[s]]
        chunks = [audio[s][fed[s]:fed[s] + sizes[s]] for s in sids]
        for s in sids:
            fed[s] += sizes[s]
        sched.push_audio_batch(sids, chunks)
        step_all()
    left = len(sched._streams[0].frontend)
    top = np.full(hop - left, 128, np.uint8)
    sched.push_audio(0, top)
    step_all()
    assert len(sched._streams[0].frontend) == 0
    peeks = {0: sched.peek(0), 1: sched.peek(1)}
    closes = {sid: sched.close_stream(sid) for sid in range(0, 256, 32)}
    return hops, peeks, closes, hop_ms, top


# ---------------------------------------------------------------------------
# Phases 7-8: the async plane and the tenant pool on the main path
# ---------------------------------------------------------------------------

#: the tenant phase: pool rows, its slot blocks, and the Ks it binds
TENANT_MODELS = 4
TENANT_BLOCK = 8
TENANT_KS = (2, 4)
#: streams closed at the end of an async or tenant drive: one per block
#: of 8 in 8 blocks, so every tenant of a K <= 8 pool closes some
CLOSE_SIDS = tuple(8 * j + 3 for j in range(8))
#: the burst drive's turns (sync, async, async, sync) are repeated so
#: that a median of each stands against the host's run-to-run spread
BURST_REPEATS = 3


def record_folds(sched):
    """Spy on the scheduler's fold stage: every hop it folds, whichever
    call retired it, as (sids, frames, logits) copies."""
    hops = []
    fold = sched._fold_hop

    def spy(*args, **kw):
        hb = fold(*args, **kw)
        hops.append((hb.sids.copy(), hb.frames.copy(),
                     None if hb.logits is None else hb.logits.copy()))
        return hb
    sched._fold_hop = spy
    return hops


def strict_dispatch(sched, torch):
    """Run the scheduler's dispatch stage under sync debug mode
    ``"error"``: a host sync in it (a pageable copy, ``.item()``,
    ``nonzero``) raises instead of silently serialising the pipeline."""
    inner = sched._dispatch_hop

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sched._dispatch_hop = strict


def drive_rounds(sched, sids, audio, chunk_plan, torch, dispatch,
                 models=None, peeks=(0, 1), closes=CLOSE_SIDS):
    """The streams ``sids`` join (bound to ``models[sid]`` when given);
    each round of ``chunk_plan`` lands their chunks through
    ``push_audio_batch`` and ``drain()`` runs every hop they complete (the
    async scheduler flushes its pump first and retires every hop in
    flight before it returns); then peeks and closes of the streams among
    ``sids``.  Returns the folded hops, the peeks, the closes' logits, the
    wall seconds of the rounds (split into ``push_audio_batch`` and
    ``drain`` seconds) and the launches counted over them."""
    hops = record_folds(sched)
    for sid in sids:
        sched.add_stream(sid, model=None if models is None else models[sid])
    fed = np.zeros(len(audio), np.int64)
    torch.cuda.synchronize()
    dispatch.reset()
    t0 = time.perf_counter()
    push_s = 0.0
    for sizes in chunk_plan:
        live = [s for s in sids if sizes[s]]
        t1 = time.perf_counter()
        sched.push_audio_batch(live, [audio[s][fed[s]:fed[s] + sizes[s]]
                                      for s in live])
        push_s += time.perf_counter() - t1
        for s in live:
            fed[s] += sizes[s]
        sched.drain()
    wall = dict(total=time.perf_counter() - t0, push=push_s)
    wall["drain"] = wall["total"] - push_s
    launched = dispatch.counts()
    mine = set(sids)
    pk = {sid: sched.peek(sid) for sid in peeks if sid in mine}
    cl = {sid: sched.close_stream(sid).logits for sid in closes
          if sid in mine}
    if hasattr(sched, "shutdown"):
        sched.shutdown(timeout=60.0)
    return hops, pk, cl, wall, launched


def drive_burst(sched, audio, hop, torch, dispatch, prof=None):
    """The hop loop alone: every stream joins and gets ``prime + hop``
    samples, one ``drain()`` primes them and runs a hop; then the rest of
    every clip lands at once and the timed ``drain()`` runs every hop of
    it, each over all the streams (under the profiler ``prof`` when
    given).  Returns the folded hops after the first drain, the timed
    drain's seconds and its launches."""
    n = len(audio)
    for sid in range(n):
        sched.add_stream(sid)
    head = sched.plan.prime_samples + hop
    sched.push_audio_batch(list(range(n)), [a[:head] for a in audio])
    sched.drain()
    hops = record_folds(sched)
    sched.push_audio_batch(list(range(n)), [a[head:] for a in audio])
    if hasattr(sched, "flush_ingest"):
        sched.flush_ingest(timeout=60.0)
    torch.cuda.synchronize()
    dispatch.reset()
    if prof is not None:
        prof.enable()
    t0 = time.perf_counter()
    sched.drain()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.disable()
    launched = dispatch.counts()
    if hasattr(sched, "shutdown"):
        sched.shutdown(timeout=60.0)
    return hops, wall, launched


def host_profile(prof, n_hops: int, top: int = 12) -> list:
    """The functions with the most own time in a profiled drive, as
    (where, own ms a hop, cumulative ms a hop, calls a hop)."""
    rows = []
    for (path, line, fn), (_, nc, tt, ct, _) in pstats.Stats(
            prof).stats.items():
        rows.append((f"{Path(path).name}:{line}({fn})", tt / n_hops * 1e3,
                     ct / n_hops * 1e3, nc / n_hops))
    return sorted(rows, key=lambda r: -r[1])[:top]


def same_hops(label, got, want):
    if len(got) != len(want):
        raise RuntimeError(f"{label}: {len(got)} hops, expected "
                           f"{len(want)}")
    for (s1, f1, l1), (s2, f2, l2) in zip(got, want):
        if not (np.array_equal(s1, s2) and np.array_equal(f1, f2)
                and (l1 is None) == (l2 is None)
                and (l1 is None or np.array_equal(l1, l2))):
            raise RuntimeError(f"{label}: a hop differs")


def same_results(label, got, want):
    for name, a, b in (("peek", got[1], want[1]), ("close", got[2],
                                                    want[2])):
        if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                           for k in a):
            raise RuntimeError(f"{label}: {name} differs")


def async_phase(spec, weights, thresholds, audio, chunk_plan, torch,
                dispatch, mk, sched_cls, async_cls):
    """The synchronous and the async scheduler (megakernel, 256 streams,
    hop_frames=8) on two drives, each in turns sync, async, async, sync:
    the main path's audio and chunk plan (``drive_rounds``; the first
    async run's dispatch stage under sync debug mode "error"), and the
    hop loop alone (``drive_burst``).  Every async run equals the first
    sync run of its drive hop for hop (sids, frames, logits; detections
    follow from them), and on the rounds drive peek for peek and close
    for close.  Returns the record and the launches of all the runs."""
    kw = dict(capacity=B_MAIN, hop_frames=HOP_FRAMES)
    sids = list(range(B_MAIN))
    turns = (("sync", False), ("async", True), ("async", False),
             ("sync", False))
    runs, launches = [], collections.Counter()
    for kind, strict in turns:
        sched = (sched_cls if kind == "sync" else async_cls)(
            spec, weights, thresholds, **kw)
        if strict:
            strict_dispatch(sched, torch)
        out = drive_rounds(sched, sids, audio, chunk_plan, torch, dispatch)
        hops, _, _, wall, launched = out
        if launched != {mk.HOP_KERNEL: len(hops)}:
            raise RuntimeError(f"async phase {kind}: launches {launched} "
                               f"for {len(hops)} hops")
        launches.update(launched)
        if runs:
            same_hops(f"async phase {kind}", hops, runs[0][1][0])
            same_results(f"async phase {kind}", out, runs[0][1])
        runs.append((kind, out, sched))
    burst = []
    hop = sched.plan.hop_samples
    for kind, _ in turns * BURST_REPEATS:
        sched = (sched_cls if kind == "sync" else async_cls)(
            spec, weights, thresholds, **kw)
        hops, wall, launched = drive_burst(sched, audio, hop, torch,
                                           dispatch)
        if launched != {mk.HOP_KERNEL: len(hops)}:
            raise RuntimeError(f"burst {kind}: launches {launched} for "
                               f"{len(hops)} hops")
        launches.update(launched)
        if burst:
            same_hops(f"burst {kind}", hops, burst[0][1])
        burst.append((kind, hops, wall, sched))
    n, nb = len(runs[0][1][0]), len(burst[0][1])
    # where the host's time goes in the synchronous hop loop (cProfile
    # slows Python calls, not the device: proportions, not times)
    prof = cProfile.Profile()
    drive_burst(sched_cls(spec, weights, thresholds, **kw), audio, hop,
                torch, dispatch, prof)
    launches.update(dispatch.counts())
    profile = host_profile(prof, nb)
    a_sched, s_sched = runs[2][2], runs[3][2]
    per_hop = lambda t, k: t / k * 1e3  # noqa: E731
    rec = dict(
        hops=n, streams=B_MAIN,
        rounds_wall_s=[dict(r[1][3], kind=r[0]) for r in runs],
        rounds_ms_per_hop={r[0] + str(i): per_hop(r[1][3]["total"], n)
                           for i, r in enumerate(runs)},
        rounds_drain_ms_per_hop={r[0] + str(i): per_hop(r[1][3]["drain"], n)
                                 for i, r in enumerate(runs)},
        rounds_hops_per_s={r[0] + str(i): n / r[1][3]["total"]
                           for i, r in enumerate(runs)},
        burst_hops=nb,
        burst_ms_per_hop={b[0] + str(i): per_hop(b[2], nb)
                          for i, b in enumerate(burst)},
        burst_hops_per_s={b[0] + str(i): nb / b[2]
                          for i, b in enumerate(burst)},
        burst_ms_per_hop_median={k: float(np.median(
            [per_hop(b[2], nb) for b in burst if b[0] == k]))
            for k in ("sync", "async")},
        sync_hop_loop_profile=profile,
        hidden_frac=a_sched.metrics.overlap_summary()["hidden_frac"],
        overlap=a_sched.metrics.overlap_summary(),
        burst_hidden_frac=float(np.median([
            b[3].metrics.overlap_summary()["hidden_frac"] for b in burst
            if b[0] == "async"])),
        async_phase_ms_p50={k: v["ms_p50"] for k, v in
                            a_sched.metrics.phase_summary().items()},
        sync_phase_ms_p50={k: v["ms_p50"] for k, v in
                           s_sched.metrics.phase_summary().items()},
    )
    fmt = lambda d: ", ".join(f"{k} {v:.4f}" for k, v in d.items())  # noqa: E731,E501
    phase("async", f"rounds drive: {n} hops over {B_MAIN} streams; burst "
          f"drive: {nb} hops; each async run == its drive's first sync run "
          f"hop for hop, peeks and closes equal; async dispatch clean "
          f"under sync debug mode 'error'; launches {dict(launches)}")
    phase("async", "rounds drive wall s (total / push / drain): " + "; ".join(
        f"{r[0]}{i} {r[1][3]['total']:.4f} / {r[1][3]['push']:.4f} / "
        f"{r[1][3]['drain']:.4f}" for i, r in enumerate(runs)))
    phase("async", f"rounds drive ms a hop: {fmt(rec['rounds_ms_per_hop'])}"
          f"; hops/s: {fmt(rec['rounds_hops_per_s'])}; hidden_frac "
          f"{rec['hidden_frac']:.4f}")
    phase("async", f"burst drive ms a hop (hop loop alone): "
          f"{fmt(rec['burst_ms_per_hop'])}; median sync "
          f"{rec['burst_ms_per_hop_median']['sync']:.4f}, async "
          f"{rec['burst_ms_per_hop_median']['async']:.4f}; hidden_frac "
          f"{rec['burst_hidden_frac']:.4f}")
    phase("async", "sync hop loop under cProfile, own / cumulative ms a "
          "hop: " + "; ".join(f"{w} {tt:.4f} / {ct:.4f}"
                              for w, tt, ct, _ in profile[:8]))
    phase("async", f"phase p50 ms async {rec['async_phase_ms_p50']}; "
          f"sync {rec['sync_phase_ms_p50']}")
    return rec, launches


def per_stream(hops):
    """{sid: [(frame, logits row), ...]} from folded hops."""
    out = collections.defaultdict(list)
    for sids, frames, logits in hops:
        for r, (sid, fr) in enumerate(zip(sids.tolist(), frames.tolist())):
            out[sid].append((fr, None if logits is None else logits[r]))
    return out


def same_seq(a, b) -> bool:
    """Two streams' hops, as ``per_stream`` lists them, are equal."""
    return len(a) == len(b) and all(
        f1 == f2 and (l1 is None) == (l2 is None)
        and (l1 is None or np.array_equal(l1, l2))
        for (f1, l1), (f2, l2) in zip(a, b))


def same_streams(label, got, want):
    """``got`` and ``want`` map (model, sid) to a stream's hops."""
    for key, seq in got.items():
        if not same_seq(seq, want[key]):
            raise RuntimeError(f"{label}: stream {key[1]} differs from the "
                               f"single-model scheduler of model {key[0]}")


def tenants_phase(spec, plan, seed, audio, chunk_plan, dev, torch, dispatch,
                  mk, bk, sched_cls, async_cls, main_inp, hop_p):
    """``max_models=4, tenant_block=8``: K = 2 and 4 random models from
    the seed bound round-robin to the 256 streams in blocks of 8, on the
    megakernel and per-stage backends, sync and async; every stream's
    hops and close equal the single-model megakernel scheduler of its
    model on its streams; launches per hop independent of K (1 per
    megakernel hop, 9 per emit and 4 per steady per-stage hop).  Then
    the pooled hop kernel (K = 4) bit-equal to its plain version and
    timed at B = 256 beside the unpooled one.  Returns the record and the
    launches of the pooled drives."""
    models = [random_model(spec, seed + 300 + j)
              for j in range(TENANT_MODELS)]
    names = ["default"] + [f"m{j}" for j in range(1, TENANT_MODELS)]
    bind = {K: {sid: (sid // TENANT_BLOCK) % K for sid in range(B_MAIN)}
            for K in TENANT_KS}
    kw = dict(capacity=B_MAIN, hop_frames=HOP_FRAMES)
    # the oracle: one single-model scheduler per model, on the streams
    # any K binds to it
    want, want_close = {}, {}
    for j, (w, t) in enumerate(models):
        sids = sorted({s for K in TENANT_KS for s in range(B_MAIN)
                       if bind[K][s] == j})
        hops, _, cl, _, _ = drive_rounds(sched_cls(spec, w, t, **kw), sids,
                                         audio, chunk_plan, torch, dispatch,
                                         peeks=())
        want.update({(j, sid): v for sid, v in per_stream(hops).items()})
        want_close.update({(j, sid): v for sid, v in cl.items()})
    launches = collections.Counter()
    rec = {"single_model_drives": len(models), "pooled": []}
    per_hop = {}
    for K in TENANT_KS:
        bound = {s: (None if bind[K][s] == 0 else names[bind[K][s]])
                 for s in range(B_MAIN)}
        for backend in ("megakernel", "per_stage"):
            for cls, emit in ((sched_cls, True), (async_cls, True),
                              (sched_cls, False)):
                if not emit and K != TENANT_KS[-1]:
                    continue
                sched = cls(spec, *models[0], backend=backend,
                            max_models=TENANT_MODELS,
                            tenant_block=TENANT_BLOCK, emit_logits=emit,
                            **kw)
                for j in range(1, K):
                    sched.register_model(names[j], *models[j])
                kind = "async" if cls is async_cls else "sync"
                label = (f"tenants K={K} {backend} {kind}"
                         f"{'' if emit else ' emit off'}")
                hops, _, cl, wall, launched = drive_rounds(
                    sched, list(range(B_MAIN)), audio, chunk_plan, torch,
                    dispatch, models=bound, peeks=())
                n = len(hops)
                if backend == "megakernel":
                    want_l = {mk.HOP_KERNEL: n}
                elif emit:
                    want_l = {bk.BITSERIAL_KERNEL: 2 * n,
                              bk.CONV_STEP_KERNEL: 6 * n,
                              bk.TAIL_KERNEL: n}
                else:
                    want_l = {bk.BITSERIAL_KERNEL: n,
                              bk.CONV_STEP_KERNEL: 3 * n}
                if launched != want_l:
                    raise RuntimeError(f"{label}: launches {launched}, "
                                       f"expected {want_l}")
                per_hop[(K, backend, emit)] = sum(launched.values()) / n
                launches.update(launched)
                got = {(bind[K][sid], sid): v
                       for sid, v in per_stream(hops).items()}
                if emit:
                    same_streams(label, got, want)
                else:
                    frames = {k: [f for f, _ in v] for k, v in got.items()}
                    if frames != {k: [f for f, _ in want[k]] for k in got}:
                        raise RuntimeError(f"{label}: frames differ")
                if sorted(cl) != list(CLOSE_SIDS) or not all(
                        np.array_equal(v, want_close[(bind[K][sid], sid)])
                        for sid, v in cl.items()):
                    raise RuntimeError(f"{label}: a close differs")
                rec["pooled"].append(dict(label=label, hops=n, wall_s=wall,
                                          launches=launched))
                wall = wall["total"]
                what = "hops" if emit else "frames"
                phase("tenants", f"{label}: {n} hops, {what} == the "
                      f"single-model schedulers' stream for stream, closes "
                      f"equal; {sum(launched.values()) / n:g} launches a "
                      f"hop; drive {wall:.4f} s")
    for backend, emit in (("megakernel", True), ("per_stage", True)):
        ks = {per_hop[(K, backend, emit)] for K in TENANT_KS}
        if len(ks) != 1:
            raise RuntimeError(f"{backend}: launches per hop depend on K: "
                               f"{per_hop}")
    # the pooled hop kernel, K = 4 by blocks of 8, beside the unpooled one
    tensors = [model_tensors(plan, w, t, dev, torch) for w, t in models]
    pooled = {k: [torch.stack(xs) for xs in zip(*(m[k] for m in tensors))]
              for k in tensors[0]}
    midx = torch.as_tensor((np.arange(B_MAIN) // TENANT_BLOCK
                            % TENANT_MODELS).astype(np.int32), device=dev)
    check_case(f"kws hf8 pooled K={TENANT_MODELS} by blocks of "
               f"{TENANT_BLOCK}", plan, pooled, main_inp, midx, torch, mk,
               dispatch)
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    pw = (mk.prepare_hop_weights(pooled["ws"], pooled["fc_ws"]),
          pooled["thrs"], pooled["flips"], pooled["fc_ws"],
          pooled["fc_thrs"], pooled["fc_flips"])
    state = (main_inp["audio"], main_inp["mask"], main_inp["tails"],
             main_inp["pendings"], main_inp["gap"])
    t_pool = time_ms(lambda: mk.hop_megakernel_packed(
        *state, *pw, midx, geoms=geoms, emit=True, fc_raw=fc_raw), torch)
    t_one = time_ms(lambda: mk.hop_megakernel_packed(
        *state, *hop_p, geoms=geoms, emit=True, fc_raw=fc_raw), torch)
    t_pool2 = time_ms(lambda: mk.hop_megakernel_packed(
        *state, *pw, midx, geoms=geoms, emit=True, fc_raw=fc_raw), torch)
    rec.update(pooled_hop_ms=[t_pool, t_pool2], unpooled_hop_ms=t_one,
               launches_per_hop={f"K={k[0]} {k[1]} emit={k[2]}": v
                                 for k, v in per_hop.items()})
    phase("tenants", f"hop kernel at B={B_MAIN} (emit, masked slots): "
          f"pooled K={TENANT_MODELS} {t_pool:.4f} / {t_pool2:.4f} ms, "
          f"unpooled {t_one:.4f} ms (turns: pooled, unpooled, pooled)")
    return rec, launches


# ---------------------------------------------------------------------------
# Phase 9: the slot pool over S shards of the card
# ---------------------------------------------------------------------------

#: shard counts of the sharded phase (S = 1 is the reference run)
SHARDS = (1, 2, 8)


def churn_sids(n: int, tenants: bool) -> tuple[int, ...]:
    """The streams that leave halfway through a sharded drive, all below
    ``n / 2``, chosen so that the survivors crowd shard 0 and the next
    hop barrier migrates rows off it.  Least-loaded placement puts sid j
    on shard j % S, so every sid but those with j % 8 == 0 leaves (shard
    0 at S = 2 and at S = 8).  A tenant pool placed at full capacity
    puts its k-th block of ``TENANT_BLOCK`` sids on shard k % 2, so the
    odd blocks leave."""
    if tenants:
        return tuple(j for j in range(n // 2) if j // TENANT_BLOCK % 2)
    return tuple(j for j in range(n // 2) if j % 8)


def drive_churn(sched, audio, chunk_plan, torch, dispatch, leave,
                models=None):
    """Every stream joins (bound to ``models[sid]`` when given); each round
    of ``chunk_plan`` lands through ``push_audio_batch`` and ``drain()``
    runs its hops; halfway, the streams ``leave`` (``close_stream``) and
    the rest stream on; then two peeks and ten closes of survivors.
    Returns the folded hops, the peeks, every close's logits, and the
    launches counted from just before the first round to just after the
    last."""
    n = len(audio)
    hops = record_folds(sched)
    for sid in range(n):
        sched.add_stream(sid, model=None if models is None else models[sid])
    fed = np.zeros(n, np.int64)
    live = list(range(n))
    closes = {}
    torch.cuda.synchronize()
    dispatch.reset()
    for r, sizes in enumerate(chunk_plan):
        if r == len(chunk_plan) // 2:
            for sid in leave:
                closes[sid] = sched.close_stream(sid).logits
            live = [s for s in live if s not in closes]
        ids = [s for s in live if sizes[s]]
        sched.push_audio_batch(ids, [audio[s][fed[s]:fed[s] + sizes[s]]
                                     for s in ids])
        for s in ids:
            fed[s] += sizes[s]
        sched.drain()
    torch.cuda.synchronize()
    launched = dispatch.counts()
    peeks = {sid: sched.peek(sid) for sid in (0, n // 2)}
    for sid in (0, 16, *range(n // 2, n, n // 16)):
        closes[sid] = sched.close_stream(sid).logits
    if hasattr(sched, "shutdown"):
        sched.shutdown(timeout=60.0)
    return hops, peeks, closes, launched


def full_state(plan, inp, torch):
    """Packed hop operands -> one tail and one pending per conv stage
    (zero-width ones empty), as the scheduler holds them."""
    ti, pi = iter(inp["tails"]), iter(inp["pendings"])
    b = inp["gap"].shape[0]
    z = lambda n, c: torch.zeros((b, n, c), dtype=torch.int32,  # noqa: E731
                                 device=inp["gap"].device)
    return ([next(ti) if s.tail else z(0, s.cin) for s in plan.convs],
            [next(pi) if s.phase else z(0, s.cout) for s in plan.convs])


def check_sharded_hop(label, plan, models, raw_p, inp, model_idx, S,
                      torch, mk, dispatch, make_mesh):
    """The scheduler's sharded model (``_ShardedModel``: one
    ``_BatchedModel`` per device, one hop launch a shard on its own rows,
    ``ShardRows`` in and out) over S shards is bit-equal to
    ``hop_megakernel_plain`` on the whole batch, emit and steady.
    ``models`` holds the exported (weights, thresholds) of each tenant
    (two with ``model_idx``, in blocks of ``TENANT_BLOCK``)."""
    from repro_torch.stream.scheduler import (
        _ShardedModel,
        prepared_model_params,
    )

    mesh = make_mesh(S)
    on = lambda w, t: lambda d: prepared_model_params(  # noqa: E731
        plan, w, t, d)
    model = _ShardedModel(
        plan, "megakernel", on(*models[0]), mesh,
        pool_size=None if model_idx is None else len(models),
        tenant_block=TENANT_BLOCK)
    for row, (w, t) in enumerate(models[1:], 1):
        model.set_model_row(row, on(w, t))
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    tails, pends = full_state(plan, inp, torch)
    split = lambda x: None if x is None else mesh.split(x)  # noqa: E731
    for emit in (True, False):
        with dispatch.counting() as launched:
            got = model.step(split(inp["audio"]), split(inp["mask"]),
                             [split(t) for t in tails],
                             [split(p) for p in pends], split(inp["gap"]),
                             split(model_idx), emit=emit)
        want = mk.hop_megakernel_plain(
            inp["audio"], inp["mask"], inp["tails"], inp["pendings"],
            inp["gap"], *raw_p, model_idx, geoms=geoms, emit=emit,
            fc_raw=fc_raw)
        torch.cuda.synchronize()
        if launched() != {mk.HOP_KERNEL: S}:
            raise RuntimeError(f"{label}: {launched()} for {S} shards")
        flat_got = ([t for t, s in zip(got[0], plan.convs) if s.tail]
                    + [p for p, s in zip(got[1], plan.convs) if s.phase]
                    + list(got[2:4]))
        flat_want = [*want[0], *want[1], *want[2:]]
        if len(flat_got) != len(flat_want) or not all(
                g.devices == mesh.devices
                and torch.equal(torch.cat(g.parts), w)
                for g, w in zip(flat_got, flat_want)):
            raise RuntimeError(f"{label}: the {S}-shard hop (emit={emit}) "
                               "differs from the plain hop on the batch")
    phase("sharded", f"{label}: {S} launches of {inp['gap'].shape[0] // S}"
          f" slots == hop_megakernel_plain on all {inp['gap'].shape[0]} "
          "(emit and steady, state and logits)")


def sharded_phase(spec, plan, seed, audio, chunk_plan, dev, torch, dispatch,
                  mk, bk, sched_cls, async_cls, make_mesh, full, hop_p,
                  raw_p, params, weights, thresholds, card):
    """The main path's 256 streams over ``make_mesh(S)``, S shards of one
    card, with leave
    churn skewed onto shard 0 halfway (``drive_churn``): the megakernel at
    S = 1, 2 and 8, sync, and at S = 2 and 8 async; the per-stage backend
    at S = 2; K = 2 tenants (blocks of 8) at S = 1 and 2.  Every stream's
    hops, peeks and closes equal the S = 1 megakernel run's (with the
    same tenants), the
    launches are S times the per-shard figure a hop, and a rebalance
    fires in every sharded run.  Then one sharded hop against the plain
    hop on the whole batch, and the hop kernel timed at B / S slots.
    Returns the record, the launches of the drives and the 1-shard
    megakernel run's streams, peeks and closes."""
    models = [(weights, thresholds), random_model(spec, seed + 400)]
    bound = {s: (None if (s // TENANT_BLOCK) % 2 == 0 else "m1")
             for s in range(B_MAIN)}
    per_hop = {"megakernel": {mk.HOP_KERNEL: 1},
               "per_stage": {bk.BITSERIAL_KERNEL: 2,
                             bk.CONV_STEP_KERNEL: 6, bk.TAIL_KERNEL: 1}}
    runs = [("megakernel", S, sched_cls, False) for S in SHARDS] + [
        ("megakernel", 2, async_cls, False),
        ("megakernel", 8, async_cls, False),
        ("per_stage", 2, sched_cls, False),
        ("megakernel", 1, sched_cls, True),
        ("megakernel", 2, sched_cls, True)]
    ref, launches, rec = {}, collections.Counter(), []
    for backend, S, cls, tenants in runs:
        kind = "async" if cls is async_cls else "sync"
        label = (f"{backend} S={S} {kind}"
                 f"{' K=2 tenants' if tenants else ''}")
        kw = dict(capacity=B_MAIN, hop_frames=HOP_FRAMES, backend=backend,
                  mesh=make_mesh(S))
        if tenants:
            kw.update(max_models=2, tenant_block=TENANT_BLOCK,
                      initial_capacity=B_MAIN)
        sched = cls(spec, weights, thresholds, **kw)
        if tenants:
            sched.register_model("m1", *models[1])
        leave = churn_sids(B_MAIN, tenants)
        hops, peeks, closes, launched = drive_churn(
            sched, audio, chunk_plan, torch, dispatch, leave,
            models=bound if tenants else None)
        n = len(hops)
        want = {k: S * v * n for k, v in per_hop[backend].items()}
        if launched != want:
            raise RuntimeError(f"{label}: launches {launched}, expected "
                               f"{want} ({n} hops x {S} shards)")
        launches.update(launched)
        m = sched.metrics
        if S > 1 and m.rebalances < 1:
            raise RuntimeError(f"{label}: the skewed churn fired no "
                               "rebalance")
        got = (per_stream(hops), peeks, closes)
        if tenants not in ref:
            ref[tenants] = got   # the 1-shard megakernel run
        else:
            want_hops = ref[tenants][0]
            if got[0].keys() != want_hops.keys() or not all(
                    same_seq(got[0][k], want_hops[k]) for k in got[0]):
                raise RuntimeError(f"{label}: a stream's hops differ from "
                                   "the 1-shard run")
            same_results(label, got, ref[tenants])
        ph = m.phase_summary()
        r = dict(label=label, backend=backend, shards=S, kind=kind,
                 tenants=tenants, hops=n, launches=dict(launched),
                 step_ms_p50=m.summary()["step_ms_p50"],
                 phase_ms_p50={k: v["ms_p50"] for k, v in ph.items()},
                 rebalances=m.rebalances, rows_migrated=m.rows_migrated,
                 capacity_last=m.summary()["capacity_last"],
                 shard_summary=m.shard_summary())
        rec.append(r)
        phase("sharded", f"{label}: {n} hops, {len(closes)} closes "
              f"({len(leave)} halfway), 2 peeks"
              f"{' == the 1-shard run stream for stream' if S > 1 else ''}"
              f"; launches {dict(launched)} ({S} x per-shard); rebalances "
              f"{m.rebalances}, rows moved {m.rows_migrated}; hop p50 "
              f"{r['step_ms_p50']:.3f} ms, dispatch p50 "
              f"{r['phase_ms_p50']['dispatch']:.3f}, device p50 "
              f"{r['phase_ms_p50']['device']:.3f}")
    # one sharded hop against the plain hop on the whole batch
    for S in SHARDS[1:]:
        check_sharded_hop(f"kws hf8 S={S}", plan, models[:1], raw_p, full,
                          None, S, torch, mk, dispatch, make_mesh)
    tensors = [params, model_tensors(plan, *models[1], dev, torch)]
    pooled = {k: [torch.stack(xs) for xs in zip(*(m[k] for m in tensors))]
              for k in params}
    pooled_raw = tuple(pooled[k] for k in ("ws", "thrs", "flips", "fc_ws",
                                           "fc_thrs", "fc_flips"))
    midx = torch.as_tensor((np.arange(B_MAIN) // TENANT_BLOCK % 2).astype(
        np.int32), device=dev)
    check_sharded_hop("kws hf8 S=2 pooled K=2", plan, models, pooled_raw,
                      full, midx, 2, torch, mk, dispatch, make_mesh)
    # the hop kernel at a shard's B / S slots beside the whole batch
    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    launch_ms = {}
    for S in SHARDS:
        b = B_MAIN // S
        rows = lambda x: x[:b]  # noqa: E731
        args = (rows(full["audio"]), rows(full["mask"]),
                tuple(map(rows, full["tails"])),
                tuple(map(rows, full["pendings"])), rows(full["gap"]))
        shard_inp = dict(zip(("audio", "mask", "tails", "pendings", "gap"),
                             args))
        launch_ms[S] = {emit: time_ms(lambda: mk.hop_megakernel_packed(
            *args, *hop_p, geoms=geoms, emit=emit, fc_raw=fc_raw), torch)
            for emit in (True, False)}
        launch_ms[S]["bound"] = {emit: bound_ms(
            plan, params, shard_inp, b, finalize=False, emit=emit)[0]
            for emit in (True, False)}
        lay = mk.slot_block(b, geoms, [(f.cin, f.cout) for f in plan.fcs],
                            plan.gap_channels, mk._sms(dev))
        launch_ms[S]["slots_per_cta"] = lay.slots
        launch_ms[S]["ctas"] = -(-b // lay.slots)
        phase("sharded", f"hop kernel at B/S = {b} slots (S={S}, "
              f"{lay.slots} a CTA, {-(-b // lay.slots)} CTAs): emit "
              f"{launch_ms[S][True]:.4f} ms, steady "
              f"{launch_ms[S][False]:.4f} ms (bound "
              f"{launch_ms[S]['bound'][True]:.6f} / "
              f"{launch_ms[S]['bound'][False]:.6f}); x{S} per hop = "
              f"{S * launch_ms[S][True]:.4f} / {S * launch_ms[S][False]:.4f}"
              f" ms")
    profile = launch_profile(spec, weights, thresholds, audio, torch,
                             dispatch, mk, sched_cls, make_mesh)
    sync = {r["shards"]: r for r in rec if r["kind"] == "sync"
            and r["backend"] == "megakernel" and not r["tenants"]}
    phase("sharded", "megakernel sync, hop p50 / dispatch p50 / device p50 "
          "ms: " + "; ".join(
              f"S={S} {sync[S]['step_ms_p50']:.3f} / "
              f"{sync[S]['phase_ms_p50']['dispatch']:.3f} / "
              f"{sync[S]['phase_ms_p50']['device']:.3f}" for S in SHARDS)
          + f"; {card}")
    return dict(runs=rec, launch_ms={str(k): {str(e): t for e, t in v.items()}
                                     for k, v in launch_ms.items()},
                launch_profile=profile), launches, ref[False]


def launch_profile(spec, weights, thresholds, audio, torch, dispatch, mk,
                   sched_cls, make_mesh):
    """The hop kernel wrapper's host cost: the sync hop loop
    (``drive_burst``) under cProfile at S = 1 and 8, with the launch
    shape memoized (``_launch_shape``, ``_sms``) and, as before the memo,
    recomputed on every call (their unwrapped functions).  Returns, per
    run, ``_launch``'s own and cumulative ms a hop and its calls a hop
    (cProfile slows Python calls: proportions, not times)."""
    rows = {}
    memo = (mk._launch_shape, mk._sms)
    for S in (1, 8):
        for label in ("memoized", "recomputed", "memoized again"):
            if label == "recomputed":
                mk._launch_shape, mk._sms = (f.__wrapped__ for f in memo)
            prof = cProfile.Profile()
            try:
                sched = sched_cls(spec, weights, thresholds, capacity=B_MAIN,
                                  hop_frames=HOP_FRAMES, mesh=make_mesh(S))
                hops, _, _ = drive_burst(sched, audio,
                                         sched.plan.hop_samples, torch,
                                         dispatch, prof)
            finally:
                mk._launch_shape, mk._sms = memo
            n = len(hops)
            own = cum = calls = 0.0
            for (path, _, fn), (_, nc, tt, ct, _) in pstats.Stats(
                    prof).stats.items():
                if fn == "_launch" and Path(path).name == "hop_megakernel.py":
                    own, cum, calls = tt, ct, nc
            rows[f"S={S} {label}"] = dict(
                hops=n, launch_own_ms=own / n * 1e3,
                launch_cum_ms=cum / n * 1e3, launch_calls=calls / n)
    phase("sharded", "_launch under cProfile, own / cumulative ms a hop "
          "(calls a hop): " + "; ".join(
              f"{k} {v['launch_own_ms']:.4f} / {v['launch_cum_ms']:.4f} "
              f"({v['launch_calls']:g})" for k, v in rows.items()))
    return rows



# ---------------------------------------------------------------------------
# Phase 9b: the slot pool over every card
# ---------------------------------------------------------------------------

def state_leaves(sched) -> list:
    """The scheduler's batched state, spare set and tenant rows."""
    out = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif x is not None:
            out.append(x)
    walk((sched.device_state(), sched._spare, sched._model_idx_dev))
    return out


def watch_placement(label, sched, ShardRows, seen):
    """Check, after every resize and rebalance (``set_device_state``) and
    on every staged operand, that each shard's part lies on its own
    device; ``seen`` counts the checks."""
    devices = sched.mesh.devices
    install, stage = sched.set_device_state, sched._staging.to_device

    def check(x, where):
        if not isinstance(x, ShardRows) or x.devices != devices:
            raise RuntimeError(f"{label}: {where} not on its shards' "
                               f"devices {[str(d) for d in devices]}: {x!r}")

    def set_device_state(state):
        install(state)
        for x in state_leaves(sched):
            check(x, "a state tensor after a remap")
        seen["remaps"] += 1

    def to_device(i, name, a):
        x = stage(i, name, a)
        check(x, f"staged {name}")
        seen["staged"] += 1
        return x

    sched.set_device_state = set_device_state
    sched._staging.to_device = to_device
    return check


def cards_phase(spec, plan, seed, audio, chunk_plan, torch, dispatch, mk,
                bk, sched_cls, async_cls, make_mesh, ShardRows, weights,
                thresholds, one_shard, merge, card):
    """The sharded phase's drive over a mesh of every card: with n >= 2
    cards (the largest power of two <= n, which 256 slots split over) at
    S = n and 2n, else at S = 2 and 8 shards of ``cuda:0``; the megakernel
    and per-stage backends, sync and async.  Each drive equals the 1-shard
    run (``one_shard``) stream for stream, makes S times the per-shard
    launches a hop, fires a rebalance and keeps every shard's tensors on
    its card.  Then each card's B.1-B.5 launches at a shard's shapes
    against their plain versions there (their errors go to ``merge``).
    Returns the record and the drives' launches."""
    n = torch.cuda.device_count()
    cards = 1 << (n.bit_length() - 1)
    counts = (cards, 2 * cards) if cards > 1 else (2, 8)
    per_hop = {"megakernel": {mk.HOP_KERNEL: 1},
               "per_stage": {bk.BITSERIAL_KERNEL: 2,
                             bk.CONV_STEP_KERNEL: 6, bk.TAIL_KERNEL: 1}}
    phase("cards", f"{n} card(s) visible ({'; '.join(card_lines())}); "
          f"the pool spans {cards} card(s) "
          f"at S = {counts[0]} and {counts[1]}"
          + ("" if cards > 1 else " shards of cuda:0 (one card: the "
             "per-shard code without the copies between cards)"))
    rec, launches = [], collections.Counter()
    for S in counts:
        mesh = (make_mesh(S, cards=cards) if cards > 1
                else make_mesh(S, device="cuda:0"))
        for backend in ("megakernel", "per_stage"):
            for cls in (sched_cls, async_cls):
                kind = "async" if cls is async_cls else "sync"
                label = f"{backend} S={S} {kind} over {cards} card(s)"
                sched = cls(spec, weights, thresholds, capacity=B_MAIN,
                            hop_frames=HOP_FRAMES, backend=backend,
                            mesh=mesh)
                seen = collections.Counter()
                check = watch_placement(label, sched, ShardRows, seen)
                if cls is async_cls:
                    strict_dispatch(sched, torch)
                hops, peeks, closes, launched = drive_churn(
                    sched, audio, chunk_plan, torch, dispatch,
                    churn_sids(B_MAIN, False))
                for x in state_leaves(sched):
                    check(x, "a state tensor after the drive")
                nh = len(hops)
                want = {k: S * v * nh for k, v in per_hop[backend].items()}
                if launched != want:
                    raise RuntimeError(f"{label}: launches {launched}, "
                                       f"expected {want}")
                launches.update(launched)
                m = sched.metrics
                if m.rebalances < 1 or seen["remaps"] < 2:
                    raise RuntimeError(f"{label}: {m.rebalances} rebalances"
                                       f", {seen['remaps']} remaps")
                got = (per_stream(hops), peeks, closes)
                if got[0].keys() != one_shard[0].keys() or not all(
                        same_seq(got[0][k], one_shard[0][k])
                        for k in got[0]):
                    raise RuntimeError(f"{label}: a stream's hops differ "
                                       "from the 1-shard run")
                same_results(label, got, one_shard)
                ph = m.phase_summary()
                r = dict(label=label, backend=backend, shards=S, kind=kind,
                         cards=cards, devices=[str(d) for d in mesh.devices],
                         hops=nh, launches=dict(launched),
                         step_ms_p50=m.summary()["step_ms_p50"],
                         phase_ms_p50={k: v["ms_p50"]
                                       for k, v in ph.items()},
                         rebalances=m.rebalances,
                         rows_migrated=m.rows_migrated,
                         placement_checks=dict(seen))
                rec.append(r)
                phase("cards", f"{label}: {nh} hops == the 1-shard run "
                      f"stream for stream; launches {dict(launched)}; "
                      f"rebalances {m.rebalances}, rows moved "
                      f"{m.rows_migrated}; every shard on its card at "
                      f"{seen['remaps']} remaps and {seen['staged']} staged "
                      f"operands; hop p50 {r['step_ms_p50']:.3f} ms, "
                      f"dispatch p50 {r['phase_ms_p50']['dispatch']:.3f}, "
                      f"device p50 {r['phase_ms_p50']['device']:.3f}; "
                      f"{card}")
    # each card's kernels at a shard's shapes, against their plain versions
    b = B_MAIN // counts[0]
    for i, d in enumerate(mesh.distinct):
        params = model_tensors(plan, weights, thresholds, d, torch)
        merge(check_case(f"{d} kws hf8 B={b}", plan, params,
                         hop_inputs(plan, b, seed + 40 + i, d, torch), None,
                         torch, mk, dispatch))
        merge(check_per_stage(f"{d} per-stage kws hf8", per_stage_launches(
            plan, [params], b, seed + 50 + i, d, torch), torch, bk,
            dispatch))
    if cards > 1:
        # a pointer into one card's memory never reaches the other's kernel
        d0, d1 = mesh.distinct[:2]
        inp = hop_inputs(plan, b, seed + 60, d1, torch)
        p0 = model_tensors(plan, weights, thresholds, d0, torch)
        try:
            mk.hop_megakernel_packed(
                inp["audio"], inp["mask"], inp["tails"], inp["pendings"],
                inp["gap"], *(p0[k] for k in ("ws", "thrs", "flips", "fc_ws",
                                              "fc_thrs", "fc_flips")),
                geoms=tuple(mk.stage_geom(s) for s in plan.convs), emit=True,
                fc_raw=tuple(f.out_raw for f in plan.fcs))
        except ValueError as e:
            phase("cards", f"weights on {d0}, state on {d1}: refused ({e})")
        else:
            raise RuntimeError("a hop with its weights on another card ran")
    sync = {(r["shards"], r["backend"]): r for r in rec
            if r["kind"] == "sync"}
    phase("cards", f"sync hop p50 / dispatch p50 / device p50 ms over "
          f"{cards} card(s): " + "; ".join(
              f"{be} S={S} {r['step_ms_p50']:.3f} / "
              f"{r['phase_ms_p50']['dispatch']:.3f} / "
              f"{r['phase_ms_p50']['device']:.3f}"
              for (S, be), r in sync.items()) + f"; {card}")
    return dict(runs=rec, cards=cards, visible=n, shards=list(counts)), \
        launches


# ---------------------------------------------------------------------------
# Phase 10: the chip twin (core.compiler / core.executor)
# ---------------------------------------------------------------------------

#: ``benchmarks/twm_vs_bwm.py``'s noise sigmas, (rows, K, N) and trials
TWM_SIGMAS = (0.5, 1.0, 2.0, 4.0)
TWM_SHAPE = (128, 768, 64)
TWM_TRIALS = 24
#: ``benchmarks/pwb_latency.py``'s pool-unit widths
PWB_WIDTHS = (32, 64, 128)
#: Table I (paper) and the relative bands ``tests/test_system.py`` holds
#: the simulated chip to: latency and throughput before calibration,
#: energy and efficiency after ``energy.calibrate_e_mac``
PAPER = dict(latency_us=(2320.0, 0.05), gops=(150.8, 0.05),
             energy_uj=(0.399, 0.02), tops_per_w=(885.86, 0.01))
#: executor runs timed on the card (the median is reported)
TWIN_RUNS = 9


class LaunchSpy:
    """Records, in order, the operands of every launch of B.3, B.6 and
    B.7 made inside a ``with`` block, by wrapping the three kernel entry
    points that ``kernels/ops.py`` calls; each launch, and its count, is
    still the entry point's own."""

    def __init__(self, bk, tm):
        self.targets = ((bk, bk.BITSERIAL_KERNEL), (bk, bk.CONV_KERNEL),
                        (tm, tm.POPCOUNT_KERNEL))
        self.calls = []

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (m, n), fn in zip(self.targets, self.saved):
            setattr(m, n, self._spy(n, fn))
        return self

    def _spy(self, name, fn):
        def call(*args, **kw):
            self.calls.append((name, args, dict(kw)))
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.targets, self.saved):
            setattr(m, n, fn)


def mac_launches(prog, bk, tm) -> dict:
    """Launches per kernel one executor run of ``prog`` must make: one per
    MAC chunk, B.3 for a bit-serial conv, B.6 for a binary conv, B.7 for
    an fc chunk."""
    from repro_torch.core.cnn_spec import FCSpec

    out = collections.Counter()
    for kind, payload in prog.instr_meta:
        if kind == "mac":
            lay = payload[0].spec
            out[tm.POPCOUNT_KERNEL if isinstance(lay, FCSpec)
                else bk.BITSERIAL_KERNEL if lay.in_bits > 1
                else bk.CONV_KERNEL] += 1
    return dict(out)


def twin_entries(calls, prog, torch, bk, tm):
    """The executor's recorded launches as ``library_entries``' entries,
    labelled by their MAC chunk: the operands, the MACs the chunk does,
    and what the one PyTorch call computing its contraction reads (the
    unpacked lanes; the zero lanes past a word's channels add nothing)."""
    from repro_torch.core.quant import unpack_bits

    macs = [payload[1] for kind, payload in prog.instr_meta if kind == "mac"]
    if len(macs) != len(calls):
        raise RuntimeError(f"chip twin: {len(calls)} launches for "
                           f"{len(macs)} MAC chunks")
    out = []
    for (name, args, kw), ch in zip(calls, macs):
        kw = {k: v for k, v in kw.items() if k != "wf"}
        n_ch = ch.ch1 - ch.ch0
        e = dict(label=ch.name, name=name, args=args, kw=kw, main=True,
                 timed=True)
        if name == bk.BITSERIAL_KERNEL:
            e["macs"] = kw["l_out"] * ch.rows * n_ch
        else:
            xq, wp, wn = args[:3]
            planes = lambda p: unpack_bits(p, axis=-2)  # noqa: E731
            if name == bk.CONV_KERNEL:
                e["macs"] = kw["l_out"] * ch.rows * n_ch
                e["lib"] = dict(x=unpack_bits(xq), w=planes(wp) - planes(wn),
                                stride=kw["stride"], pad=kw["pad"])
            else:
                e["macs"] = xq.shape[0] * ch.rows * n_ch
                e["shape"] = (xq.shape[0], ch.rows, n_ch)
                e["lib"] = dict(xf=unpack_bits(xq).float(),
                                wf=(planes(wp) - planes(wn)).float())
        out.append(e)
    return out


def same_report(label, got, want, torch):
    """Two ExecutionReports equal: output, fmaps, layer_cycles,
    bank_active_cycles and every ledger field."""
    if not torch.equal(got.output.cpu(), want.output.cpu()):
        raise RuntimeError(f"chip twin {label}: output {got.output} != "
                           f"{want.output}")
    if sorted(got.fmaps) != sorted(want.fmaps) or not all(
            torch.equal(got.fmaps[k].cpu(), want.fmaps[k].cpu())
            for k in want.fmaps):
        raise RuntimeError(f"chip twin {label}: feature maps differ")
    if got.layer_cycles != want.layer_cycles or not np.array_equal(
            got.bank_active_cycles, want.bank_active_cycles):
        raise RuntimeError(f"chip twin {label}: cycles differ")
    if dataclasses.asdict(got.ledger) != dataclasses.asdict(want.ledger):
        raise RuntimeError(f"chip twin {label}: ledgers differ")


def chip_twin_phase(weights, thresholds, seed, dev, torch, dispatch, bk, tm,
                    lib_fns, card):
    """Phase 10: the chip twin on the full Fig. 7 spec, the same model.
    Returns (record, counted launches, per-launch timing records, the
    kernels' max |kernel - plain|)."""
    from repro_torch.core import compiler, energy, executor, pingpong, pwb
    from repro_torch.core import twm
    from repro_torch.models import kws

    sim = "simulated PSCNN chip at 10 MHz, not the card"
    spec = kws.build_kws_spec()
    hints = dict(rotate_hints=kws.ROTATE_HINTS,
                 rowsplit_hints=kws.ROWSPLIT_HINTS)
    t0 = time.perf_counter()
    prog = compiler.compile_model(spec, weights, thresholds, device=dev,
                                  **hints)
    compile_s = time.perf_counter() - t0
    host = compiler.compile_model(spec, weights, thresholds, device="cpu",
                                  **hints)
    if prog.words != host.words or not (
            torch.equal(prog.cim.pos.cpu(), host.cim.pos)
            and torch.equal(prog.cim.neg.cpu(), host.cim.neg)):
        raise RuntimeError("chip twin: the card's program differs from the "
                           "CPU's")
    x = np.random.default_rng(seed + 21).integers(
        0, 256, (spec.in_len, 1)).astype(np.uint8)
    launches = collections.Counter()

    def counted(label, program, fuse, xin):
        """One executor run on the card, its launches counted from 0 and
        held to one per MAC chunk, against the same run on the CPU."""
        want = mac_launches(program, bk, tm)
        torch.cuda.synchronize()
        dispatch.reset()   # this run's counts start here
        rep = executor.Executor(program, fuse_pool=fuse).run(xin)
        torch.cuda.synchronize()
        got = dispatch.counts()
        if got != want:
            raise RuntimeError(f"chip twin {label}: launches {got} != {want}")
        launches.update(got)
        return rep, got

    with LaunchSpy(bk, tm) as spy:
        fused, fused_launches = counted("fused", prog, True, x)
    cpu_fused = executor.Executor(host).run(x)
    same_report("fused (card vs CPU)", fused, cpu_fused, torch)
    if fused_launches != {bk.BITSERIAL_KERNEL: 1, bk.CONV_KERNEL: 6,
                          tm.POPCOUNT_KERNEL: 6}:
        raise RuntimeError(f"chip twin: launches {fused_launches}, not 13")
    unfused, _ = counted("unfused", prog, False, x)
    same_report("unfused (card vs CPU)", unfused,
                executor.Executor(host, fuse_pool=False).run(x), torch)
    if not torch.equal(unfused.output, fused.output):
        raise RuntimeError("chip twin: unfused output differs from fused")
    # every chunk rotating: the smoke spec (the full model's weights
    # overflow the 512 Kb weight SRAM, as the compiler must say)
    smoke = kws.build_kws_smoke_spec()
    sw, st = random_model(smoke, seed + 22)
    names = tuple(c.name for li, lay in enumerate(smoke.layers)
                  for c in compiler.chunk_layer(lay, li, 0))
    rot = compiler.compile_model(smoke, sw, st, rotate_hints=names,
                                 device=dev)
    rot_host = compiler.compile_model(smoke, sw, st, rotate_hints=names,
                                      device="cpu")
    base = compiler.compile_model(smoke, sw, st, device=dev)
    if not all(c.rotating for b in rot.bindings for c in b.chunks):
        raise RuntimeError("chip twin: a chunk did not rotate")
    xs = np.random.default_rng(seed + 23).integers(
        0, 256, (smoke.in_len, 1)).astype(np.uint8)
    for fuse in (True, False):
        got, _ = counted(f"rotated fuse={fuse}", rot, fuse, xs)
        same_report(f"rotated fuse={fuse} (card vs CPU)", got,
                    executor.Executor(rot_host, fuse_pool=fuse).run(xs),
                    torch)
        if not torch.equal(got.output, executor.Executor(
                base, fuse_pool=fuse).run(xs).output):
            raise RuntimeError("chip twin: rotation changed the output")
    all_names = tuple(c.name for li, lay in enumerate(spec.layers)
                      for c in compiler.chunk_layer(lay, li, 0))
    try:
        compiler.compile_model(spec, weights, thresholds,
                               rotate_hints=all_names, device=dev)
        raise RuntimeError("chip twin: the full model rotated whole")
    except MemoryError as e:
        overflow = str(e)
    logits = kws.offline_logits(spec, weights, thresholds,
                                torch.as_tensor(x[:, 0], device=dev))
    if not torch.equal(fused.output.ravel(), logits.to(torch.int64)):
        raise RuntimeError(f"chip twin: executor logits {fused.output} != "
                           f"offline_logits {logits}")
    n_rot = sum(c.rotating for b in prog.bindings for c in b.chunks)
    phase("chip_twin", f"full Fig. 7 spec compiled on the card in "
          f"{compile_s:.3f} s: {len(prog.words)} words, "
          f"{len(spy.calls)} MAC chunks ({n_rot} rotating); executor on the card == executor on the CPU (output, "
          f"fmaps, layer_cycles, bank_active_cycles, ledger) fused and "
          f"unfused, launches {fused_launches} a run; every smoke chunk "
          f"rotating ({len(names)} WREPs) == CPU == unrotated; the full "
          f"model rotating whole refused ({overflow}); logits "
          f"{fused.output.ravel().tolist()} == models.kws.offline_logits")

    # each launch of the main run bit-equal to its plain version
    entries = twin_entries(spy.calls, prog, torch, bk, tm)
    err = check_library(entries, torch, lib_fns, dispatch, tag="chip_twin")

    # the card's own numbers: the executor's wall time, each launch
    walls = []
    for _ in range(TWIN_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = executor.Executor(prog).run(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    same_report("run again on one program", last, fused, torch)
    prof = cProfile.Profile()
    prof.enable()
    executor.Executor(prog).run(x)
    torch.cuda.synchronize()
    prof.disable()
    top = host_profile(prof, 1, top=10)
    wall = float(np.median(walls))
    recs = []
    for e in entries:
        kernel, plain = lib_fns[e["name"]]
        out = kernel(*e["args"], **e["kw"])
        bms, t_b, t_o = launch_bound_ms(e, out)
        yard, yard_name = library_yardstick(e, out, torch, tm)
        rec = dict(label=e["label"], name=e["name"], macs=e["macs"],
                   shape=[tuple(a.shape) for a in e["args"][:3]
                          if a is not None],
                   ms=time_ms(lambda: kernel(*e["args"], **e["kw"]), torch),
                   call_ms=call_ms(lambda: kernel(*e["args"], **e["kw"]),
                                   torch),
                   plain_ms=time_ms(lambda: plain(*e["args"], **e["kw"]),
                                    torch, iters=5),
                   bound_ms=bms, bytes_s=t_b, ops_s=t_o,
                   library_ms=time_ms(yard, torch), library_call=yard_name,
                   tile=gemm_tile(e, tm))
        recs.append(rec)
        phase("chip_twin", f"time {rec['label']} ({rec['name']}, operands "
              f"{rec['shape']}): kernel {rec['ms']:.4f} ms (issued from "
              f"Python {rec['call_ms']:.4f}), plain {rec['plain_ms']:.4f} "
              f"ms, bound {bms:.6f} ms ("
              f"{'bytes' if t_b >= t_o else 'operations'}), "
              f"{yard_name} {rec['library_ms']:.4f} ms; {card}")
    phase("chip_twin", f"executor run on the card (13 launches and the "
          f"host's bookkeeping), synchronised: median {wall:.3f} ms of "
          f"{TWIN_RUNS} (min {min(walls):.3f}, max {max(walls):.3f}); its "
          f"kernels' device time {sum(r['ms'] for r in recs):.4f} ms; "
          f"{card}")
    phase("chip_twin", "executor run under cProfile, own / cumulative ms: "
          + "; ".join(f"{w} {own:.3f} / {cum:.3f} ({n:.0f} calls)"
                      for w, own, cum, n in top[:6]))

    # the simulated chip's figures: Table I, PWB, ping-pong, TWM vs BWM
    led = fused.ledger
    params = energy.calibrate_e_mac(led, led.macs / 885.86e12)
    cal = executor.Executor(prog, params=params).run(x).ledger
    table = dict(cycles=led.cycles, macs=led.macs,
                 latency_us=led.latency_s * 1e6, gops=led.gops,
                 energy_uj=cal.energy_j * 1e6, tops_per_w=cal.tops_per_w,
                 uncalibrated_energy_uj=led.energy_j * 1e6,
                 uncalibrated_tops_per_w=led.tops_per_w,
                 e_mac_j=params.e_mac,
                 wrep_cycles=fused.layer_cycles.get("wrep", 0),
                 weight_sram_bits=prog.wsram.used_bits)
    for key, (paper, band) in PAPER.items():
        if abs(table[key] - paper) / paper >= band:
            raise RuntimeError(f"chip twin: simulated {key} {table[key]} "
                               f"outside {band:.0%} of the paper's {paper}")
    pwb_rows = {}
    default = pwb.POOL_UNIT_BITS
    try:
        for width in PWB_WIDTHS:
            pwb.POOL_UNIT_BITS = width
            f = executor.Executor(prog).run(x).ledger.cycles
            u = executor.Executor(prog, fuse_pool=False).run(x).ledger.cycles
            pwb_rows[width] = dict(fused=f, separate=u,
                                   reduction_pct=100.0 * (1 - f / u))
    finally:
        pwb.POOL_UNIT_BITS = default
    if not 25.0 < pwb_rows[default]["reduction_pct"] < 56.0:
        raise RuntimeError(f"chip twin: PWB saving {pwb_rows[default]}")
    fixed = pingpong.FixedPingPong()
    fits = dict(flexible=True, fixed=True)
    l, c = spec.in_len, spec.in_channels
    fmt = "u8" if spec.in_bits > 1 else "bits"
    for b, (ol, oc) in zip(prog.bindings, spec.trace_shapes()):
        out_fmt = ("u8" if getattr(b.spec, "out_raw", False)
                   or b.spec.name == "gap" else "bits")
        ifm = pingpong.FmapRef(b.ifm_addr, l, c, fmt)
        ofm = pingpong.FmapRef(b.ofm_addr, ol, oc, out_fmt)
        fits["fixed"] &= fixed.fits(ifm, ofm)
        try:
            pingpong.PingPongSRAM.check_layer(ifm, ofm)
        except MemoryError:
            fits["flexible"] = False
        l, c, fmt = ol, oc, out_fmt
    big = pingpong.FmapRef(0, 5000, 32, "bits")
    small = pingpong.FmapRef(6144, 2000, 32, "bits")
    pingpong.PingPongSRAM.check_layer(big, small)
    fits["large_fmap_fixed"] = fixed.fits(big, small)
    fits["bank_off_fraction"] = 1.0 - float(
        fused.bank_active_cycles.sum()) / (4.0 * led.cycles)
    if not fits["flexible"] or fits["large_fmap_fixed"]:
        raise RuntimeError(f"chip twin: ping-pong fits {fits}")
    rng = np.random.default_rng(seed + 24)
    rows, kdim, n = TWM_SHAPE
    xb = torch.as_tensor(rng.integers(0, 2, (rows, kdim), dtype=np.int32),
                         device=dev)
    wt = torch.as_tensor(rng.integers(-1, 2, (kdim, n), dtype=np.int32),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flips = {}
    for sigma in TWM_SIGMAS:
        ft, fb = (float(twm.flip_rate_under_noise(gen, xb, wt, sigma, m,
                                                  trials=TWM_TRIALS))
                  for m in ("twm", "bwm"))
        flips[sigma] = dict(twm=ft, bwm=fb)
        if not ft < fb:
            raise RuntimeError(f"chip twin: TWM flips {ft} >= BWM {fb} at "
                               f"sigma {sigma}")
    phase("chip_twin", f"{sim}: {led.cycles} cycles, {led.macs} MACs, "
          f"latency {table['latency_us']:.1f} us, {table['gops']:.2f} GOPS "
          f"(paper 2320 us, 150.8 GOPS); after calibrate_e_mac (e_mac "
          f"{params.e_mac:.4e} J): {table['energy_uj']:.4f} uJ and "
          f"{table['tops_per_w']:.2f} TOPS/W per inference (paper 0.399, "
          f"885.86); WREP {table['wrep_cycles']} cycles, weight SRAM "
          f"{table['weight_sram_bits']} bits")
    phase("chip_twin", f"{sim}: PWB fused vs separate pool, cycles and "
          "saving by pool-unit width: " + "; ".join(
              f"{w} bit {r['fused']} / {r['separate']} "
              f"({r['reduction_pct']:.1f} %)" for w, r in pwb_rows.items())
          + f" (default {default} bit; paper 35.9 %); ping-pong: the KWS "
          f"maps fit flexible {fits['flexible']} / fixed {fits['fixed']}, "
          f"a 5000-word IFM beside a 2000-word OFM fits fixed "
          f"{fits['large_fmap_fixed']} (flexible True), banks off "
          f"{fits['bank_off_fraction']:.2f} of the run")
    phase("chip_twin", f"{sim}: SA flip rate TWM / BWM, {rows} x {kdim} x "
          f"{n}, {TWM_TRIALS} trials (B.7 on the card): " + "; ".join(
              f"sigma {s_} {f['twm']:.4f} / {f['bwm']:.4f}"
              for s_, f in flips.items()))
    rec = dict(words=len(prog.words), compile_s=compile_s,
               launches_per_run=fused_launches, executor_ms=walls,
               executor_ms_median=wall, executor_profile=top,
               launch_shapes=recs, table1=table, pwb=pwb_rows,
               pingpong=fits, twm_flip_rates=flips,
               full_rotation_refused=overflow, card=card)
    return rec, dict(launches), recs, err


# ---------------------------------------------------------------------------
# Phase 11: KWS training on the card, then the deploy through the kernels
# ---------------------------------------------------------------------------

#: AdamW steps, batch, and the eval batch (``examples/kws_train.py``'s)
TRAIN_STEPS = 20
#: the last steps, run under ``torch.profiler`` for the device's time
TRAIN_PROFILED = 3
TRAIN_BATCH = 32
TRAIN_EVAL = 96
#: eval clips held card vs CPU (QAT), through ``offline_logits``, and
#: through the chip twin's executor
TRAIN_CPU_CLIPS = 8
TRAIN_OFFLINE_CLIPS = 16
TRAIN_TWIN_CLIPS = 4


def check_spied(calls, torch, fns, label):
    """Each recorded launch again, kernel against its plain version on the
    same operands (B.6's laid-out weights ``wf`` go to the kernel only);
    returns the max |kernel - plain| per kernel name."""
    err = collections.Counter()
    for i, (name, args, kw) in enumerate(calls):
        kernel, plain = fns[name]
        got = kernel(*args, **kw)
        want = plain(*args, **{k: v for k, v in kw.items() if k != "wf"})
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"{label} launch {i} ({name}): output "
                               f"{got.dtype} {tuple(got.shape)} vs "
                               f"{tuple(want.shape)}")
        d = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        err[name] = max(err[name], d)
        if d:
            raise RuntimeError(f"{label} launch {i} ({name}): kernel "
                               f"disagrees with plain by {d}")
    return dict(err)


def train_phase(seed, dev, torch, dispatch, bk, tm, lib_fns, card):
    """Phase 11: ``TRAIN_STEPS`` AdamW steps of the full Fig. 7 model on
    the card through ``train.loop.Trainer``, then its deploy: the exported
    model through ``offline_logits`` and the chip twin, bit for bit with
    the QAT forward.  Returns (record, the deploy's counted launches, the
    deploy kernels' max |kernel - plain|)."""
    import tempfile

    from repro_torch.core import compiler, executor
    from repro_torch.data import gscd
    from repro_torch.models import kws
    from repro_torch.train import checkpoint, loop, optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    spec = kws.build_kws_spec()
    t0 = time.perf_counter()
    batches = [gscd.batch(seed=0, step=i, batch_size=TRAIN_BATCH,
                          n=spec.in_len) for i in range(TRAIN_STEPS)]
    data_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    staged = [(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
              for x, y in batches]
    xe, ye = gscd.batch(seed=7, step=10_000, batch_size=TRAIN_EVAL,
                        n=spec.in_len)
    xe_d, ye_d = torch.as_tensor(xe, device=dev), torch.as_tensor(ye,
                                                                   device=dev)
    params = kws.init_kws_params(
        spec, generator=torch.Generator().manual_seed(seed), device=dev)
    # the reference's AdamW (lr 2e-3, clip 1.0); no warm-up, a cosine to
    # 0.1 x over the run
    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(lr=2e-3, clip_norm=1.0),
                            warmup_steps=0, total_steps=TRAIN_STEPS)
    trainer = loop.Trainer(spec, tcfg,
                           lambda p, b: kws.kws_loss(p, *b, spec), params,
                           iter(staged))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.run(TRAIN_STEPS - TRAIN_PROFILED)
    train_s = time.perf_counter() - t0
    # the last steps under the profiler: the device's time a step, by
    # kernel (the profiler slows the host, so their wall times stay out
    # of the step time)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        hist += trainer.run(TRAIN_PROFILED)
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3
                         / TRAIN_PROFILED, e.count / TRAIN_PROFILED)
                        for e in prof.key_averages()
                        if e.device_type == cuda),
                       key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in by_kernel)
    params = trainer.state["params"]
    losses = [h["loss"] for h in hist]
    step_ms = [h["step_time_s"] * 1e3 for h in hist[:-TRAIN_PROFILED]]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train: the loss did not fall: {losses}")
    with torch.no_grad():
        acc = float(kws.kws_accuracy(params, xe_d, ye_d, spec))
    phase("train", f"full Fig. 7 spec (width {spec.layers[0].cout}, in_len "
          f"{spec.in_len}), "
          f"batch {TRAIN_BATCH}, {TRAIN_STEPS} AdamW steps (lr 2e-3, clip "
          f"1.0) through Trainer in {train_s:.2f} s: step ms (synchronised, "
          f"data excluded) median {float(np.median(step_ms)):.3f}, min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f} (first "
          f"{step_ms[0]:.3f}; {len(step_ms)} steps unprofiled); device "
          f"time a step under the profiler {device_ms:.3f} ms "
          f"({len(by_kernel)} kernels and copies, "
          f"{sum(n for _, _, n in by_kernel):.0f} a step; "
          + (f"idle {1 - device_ms / float(np.median(step_ms)):.2f} of the "
             "median step" if device_ms else "not measured: no device "
             "time in the trace") + "; top: " + ", ".join(
              f"{k[:40]} {ms:.3f}" for k, ms, _ in by_kernel[:5])
          + f"); gscd.batch {data_ms:.1f} ms a batch on the "
          f"host; loss {losses[0]:.4f} -> {losses[-1]:.4f}; eval accuracy "
          f"{acc:.3f} on {TRAIN_EVAL} clips (synthetic GSCD, "
          f"{TRAIN_STEPS} steps); {card}")

    # the card's QAT forward against the CPU's, same params; every
    # pre-activation an integer
    pre_card, pre_cpu = [], []
    with torch.no_grad():
        qat = kws.kws_forward(params, xe_d[:TRAIN_OFFLINE_CLIPS], spec,
                              preacts=pre_card)
        cpu = kws.kws_forward(tree_map(lambda t: t.cpu(), params),
                              torch.as_tensor(xe[:TRAIN_CPU_CLIPS]), spec,
                              preacts=pre_cpu)
    if not torch.equal(qat[:TRAIN_CPU_CLIPS].cpu(), cpu):
        raise RuntimeError("train: the card's QAT logits differ from the "
                           "CPU's")
    for li, (a, b) in enumerate(zip(pre_card, pre_cpu)):
        if not (torch.equal(a, a.round()) and torch.equal(b, b.round())
                and torch.equal(a[:TRAIN_CPU_CLIPS].cpu(), b)):
            raise RuntimeError(f"train: pre-activation {li} not exact")

    # the deploy: export, the kernel library and the chip twin, counted
    weights, thresholds = kws.export_kws(params, spec)
    model = kws.prepare_offline(spec, weights, thresholds, device=dev)
    prog = compiler.compile_model(spec, weights, thresholds, device=dev,
                                  rotate_hints=kws.ROTATE_HINTS,
                                  rowsplit_hints=kws.ROWSPLIT_HINTS)
    want = qat.to(torch.int64)
    torch.cuda.synchronize()
    dispatch.reset()   # the deploy's counts start here
    with LaunchSpy(bk, tm) as spy:
        offline = [kws.offline_logits(model, xe_d[i])
                   for i in range(TRAIN_OFFLINE_CLIPS)]
        twin = [executor.Executor(prog).run(xe[i][:, None]).output.ravel()
                for i in range(TRAIN_TWIN_CLIPS)]
    torch.cuda.synchronize()
    launches = dispatch.counts()
    n_off = sum(not torch.equal(o.to(torch.int64), w)
                for o, w in zip(offline, want))
    n_twin = sum(not torch.equal(o.to(torch.int64), w)
                 for o, w in zip(twin, want))
    if n_off or n_twin:
        raise RuntimeError(f"train: the deployed model differs from the "
                           f"QAT forward on {n_off} of {TRAIN_OFFLINE_CLIPS}"
                           f" offline clips and {n_twin} of "
                           f"{TRAIN_TWIN_CLIPS} chip-twin clips")
    per_clip = {bk.BITSERIAL_KERNEL: 1, bk.CONV_KERNEL: 3,
                tm.POPCOUNT_KERNEL: 2}
    want_launches = collections.Counter()
    for name, n in per_clip.items():
        want_launches[name] += n * TRAIN_OFFLINE_CLIPS
    for name, n in mac_launches(prog, bk, tm).items():
        want_launches[name] += n * TRAIN_TWIN_CLIPS
    if launches != dict(want_launches) or len(spy.calls) != sum(
            launches.values()):
        raise RuntimeError(f"train: deploy launches {launches} != "
                           f"{dict(want_launches)}")
    err = check_spied(spy.calls, torch, lib_fns, "train deploy")

    # a checkpoint of the trained state, saved and restored on the card
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, trainer.step_idx, trainer.state)
        step, back, _ = checkpoint.restore(d, trainer.state)
    leaves, got = tree_leaves(trainer.state), tree_leaves(back)
    if step != TRAIN_STEPS or len(got) != len(leaves) or not all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(leaves, got)):
        raise RuntimeError("train: the checkpoint did not round-trip")
    phase("train", f"card QAT logits == CPU QAT logits on "
          f"{TRAIN_CPU_CLIPS} clips, every pre-activation an integer; "
          f"export_kws -> offline_logits == QAT on {TRAIN_OFFLINE_CLIPS} "
          f"clips; compile_model (ROTATE_HINTS, ROWSPLIT_HINTS) + Executor "
          f"== QAT on {TRAIN_TWIN_CLIPS} clips; deploy launches {launches},"
          f" each bit-equal to its plain version; checkpoint of "
          f"{len(leaves)} leaves restored on the card bit for bit; phase "
          f"took {time.perf_counter() - t_phase:.1f} s; {card}")
    rec = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, step_ms=step_ms,
               step_ms_median=float(np.median(step_ms)),
               data_ms_per_batch=data_ms, losses=losses,
               profiled_steps=TRAIN_PROFILED, device_ms_per_step=device_ms,
               device_by_kernel=by_kernel[:20],
               eval_accuracy=acc, eval_clips=TRAIN_EVAL,
               deploy_launches=launches,
               phase_s=time.perf_counter() - t_phase, card=card)
    return rec, launches, err


# ---------------------------------------------------------------------------
# Phase 12: LM serving, Qwen3-0.6B at its published width and depth
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
#: card vs CPU prefill: prompts x tokens, teacher-forced
LM_PROMPTS, LM_PROMPT_LEN = 2, 32
#: decode steps held against the parallel forward
LM_DECODE = 8
#: the engine drives: requests, prompt and new tokens, slots, cache rows
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 16, 16
LM_SLOTS, LM_MAX_SEQ = 4, 64
#: sync decode ticks traced by ``torch.profiler``
LM_PROFILED = 5
#: logits tolerance: the reference's own prefill/decode bound
#: (``tests/test_models.py``)
LM_RTOL, LM_ATOL = 0.06, 0.15


def lm_drive(engine, cfg, params, seed, torch, asyn=False, *,
             tag="lm_serve", requests=LM_REQUESTS, prompt=LM_PROMPT,
             new=LM_NEW, max_seq=LM_MAX_SEQ, **kw):
    """``requests`` requests of ``prompt`` seeded tokens through an
    ``Engine``, drained -> (tokens by rid, wall s, the engine)."""
    eng = engine.Engine(cfg, params, max_seq=max_seq, **kw)
    rng = np.random.default_rng(seed)
    for i in range(requests):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, prompt).astype(
                np.int32), max_new_tokens=new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = (eng.run_until_drained_async() if asyn
            else eng.run_until_drained())
    wall = time.perf_counter() - t0
    tokens = {r.rid: list(r.out_tokens) for r in done}
    if sorted(tokens) != list(range(requests)) or any(
            len(t) != new or not all(0 <= x < cfg.vocab for x in t)
            for t in tokens.values()):
        raise RuntimeError(f"{tag}: a request did not get its {new} "
                           f"tokens in [0, {cfg.vocab}): {tokens}")
    return tokens, wall, eng


def lm_tick_profile(engine, cfg, params, rng, torch, slots, max_seq,
                    ticks):
    """``ticks`` sync decode ticks at ``slots`` live slots (2-token
    prompts: only the decode ticks are traced) under ``torch.profiler``,
    the device's activity alone (thousands of kernels a tick, and the
    host ops' events would multiply the trace's processing time) ->
    (device busy ms a tick, kernels a tick, [(kernel, ms, count) a tick]
    by device time)."""
    eng = engine.Engine(cfg, params, batch_slots=slots, max_seq=max_seq)
    for i in range(slots):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 2).astype(np.int32),
            max_new_tokens=ticks + 3))
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(ticks):
                eng.step()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3 / ticks,
                         e.count / ticks)
                        for e in prof.key_averages()
                        if e.device_type == cuda), key=lambda r: -r[1])
    return (sum(ms for _, ms, _ in by_kernel),
            sum(n for _, _, n in by_kernel), by_kernel)


def lm_serve_phase(seed, dev, torch, dispatch, card):
    """Phase 12: Qwen3-0.6B (28 layers, d_model 1024, vocab 151,936) with
    seeded random weights on the card: prefill against the CPU, decode
    against forward, and the continuous-batching engine sync, async,
    elastic and over 2 shards, with its times and a profiler trace of
    sync ticks.  Returns the record."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_stream_mesh
    from repro_torch.models import api, stack
    from repro_torch.serve import engine
    from repro_torch.utils.tree import (
        tree_count_params,
        tree_map,
        tree_size_bytes,
    )

    t_phase = time.perf_counter()
    split = {}    # the phase's wall seconds by part

    def lap(part, t0):
        split[part] = time.perf_counter() - t0
        return time.perf_counter()

    cfg = get_arch(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    n_params, p_bytes = tree_count_params(params), tree_size_bytes(params)
    if n_params != api.param_count(cfg):
        raise RuntimeError("lm_serve: the params differ from param_count")
    rng = np.random.default_rng(seed + 40)
    t0 = lap("init", t_phase)

    # card against CPU, teacher-forced: the same params, the same prompts
    toks = rng.integers(0, cfg.vocab, (LM_PROMPTS, LM_PROMPT_LEN)).astype(
        np.int32)
    prefill = api.prefill_fn(cfg)
    with torch.no_grad():
        card_logits, card_caches = prefill(
            params, {"tokens": torch.as_tensor(toks, device=dev)})
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu_logits, _ = prefill(cpu_params, {"tokens": torch.as_tensor(toks)})
    del cpu_params
    got = card_logits.cpu()[..., :cfg.vocab]
    want = cpu_logits[..., :cfg.vocab]
    if not (torch.isfinite(got).all() and got.shape == (
            LM_PROMPTS, LM_PROMPT_LEN, cfg.vocab)):
        raise RuntimeError(f"lm_serve: bad prefill logits {got.shape}")
    prefill_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LM_RTOL, atol=LM_ATOL):
        raise RuntimeError(f"lm_serve: card prefill logits differ from the "
                           f"CPU's by up to {prefill_err}")
    top2 = torch.topk(want, 2, dim=-1).values
    checkable = (top2[..., 0] - top2[..., 1]) > LM_ATOL
    same = got.argmax(-1) == want.argmax(-1)
    if not bool(same[checkable].all()):
        raise RuntimeError("lm_serve: card and CPU argmax differ where the "
                           "CPU's top-2 margin exceeds the tolerance")
    n_unchecked = int((~checkable).sum())
    if card_caches[0][0].shape != (cfg.n_layers, LM_PROMPTS, LM_PROMPT_LEN,
                                   cfg.n_kv_heads, cfg.head_dim):
        raise RuntimeError(f"lm_serve: prefill cache {card_caches[0][0].shape}")
    del card_caches, card_logits, cpu_logits
    t0 = lap("prefill card vs CPU", t0)

    # decode against forward on the card
    dtoks = torch.as_tensor(toks[:1, :LM_DECODE], device=dev)
    with torch.no_grad():
        full, _ = stack.forward(cfg, params, dtoks, mode="train")
        state = api.init_decode_state(cfg, 1, 2 * LM_DECODE, device=dev)
        dec = api.decode_fn(cfg)
        for t in range(LM_DECODE):
            logits, state = dec(params, state, dtoks[:, t:t + 1])
    decode_err = float((logits[0, -1] - full[0, -1]).abs().max())
    if not torch.allclose(logits[0, -1], full[0, -1], rtol=LM_RTOL,
                          atol=LM_ATOL):
        raise RuntimeError(f"lm_serve: decode differs from forward by up to "
                           f"{decode_err}")
    del state, full
    t0 = lap("decode vs forward", t0)

    # the engine: every drive's tokens equal the fixed sync drive's
    dispatch.reset()
    drives = {}
    with torch.no_grad():
        for label, asyn, kw in (
                ("fixed", False, dict(batch_slots=LM_SLOTS)),
                ("async", True, dict(batch_slots=LM_SLOTS)),
                ("fixed 8", False, dict(batch_slots=2 * LM_SLOTS)),
                ("elastic 2-8", False, dict(batch_slots=2,
                                            max_slots=2 * LM_SLOTS,
                                            min_slots=2)),
                ("fixed 2", False, dict(batch_slots=2)),
                ("2 shards", False, dict(
                    batch_slots=2, mesh=make_stream_mesh(2, device=dev)))):
            drives[label] = lm_drive(engine, cfg, params, seed, torch, asyn,
                                     **kw)
    if dispatch.counts():
        raise RuntimeError(f"lm_serve: the LM path launched a reference "
                           f"kernel: {dispatch.counts()}")
    for label, want_label in (("async", "fixed"), ("elastic 2-8", "fixed 8"),
                              ("2 shards", "fixed 2")):
        if drives[label][0] != drives[want_label][0]:
            raise RuntimeError(f"lm_serve: {label} tokens differ from "
                               f"{want_label}'s")
    clocks = {k: int(v[2].state["cache_len"]) for k, v in drives.items()}
    if not clocks["fixed 2"] > LM_MAX_SEQ:
        raise RuntimeError(f"lm_serve: the shared clock stayed at "
                           f"{clocks['fixed 2']} <= {LM_MAX_SEQ}")
    resizes = [e for e in drives["elastic 2-8"][2].obs.events.tail()
               if e["event"] == "lm_resize"]
    if not resizes or max(e["new"] for e in resizes) != 2 * LM_SLOTS:
        raise RuntimeError(f"lm_serve: the elastic pool did not grow to "
                           f"{2 * LM_SLOTS}: {resizes}")
    kv_bytes = tree_size_bytes(drives["fixed"][2].state["layers"])
    t0 = lap("engine drives", t0)

    def p50_ms(eng, name):
        return eng.obs.registry.histogram(name).quantile(0.5) * 1e3

    fixed_eng, async_eng = drives["fixed"][2], drives["async"][2]
    prefill_ms = p50_ms(fixed_eng, "serve.prefill_s")
    tick_ms = p50_ms(fixed_eng, "serve.decode_tick_s")
    async_tick_ms = p50_ms(async_eng, "serve.decode_tick_s")
    tok_s = {k: LM_REQUESTS * LM_NEW / v[1] for k, v in drives.items()}

    # sync ticks under the profiler: the device's busy time a tick
    busy_ms, kernels_tick, by_kernel = lm_tick_profile(
        engine, cfg, params, rng, torch, LM_SLOTS, LM_MAX_SEQ, LM_PROFILED)
    idle = 1 - busy_ms / tick_ms if busy_ms else None
    peak = torch.cuda.max_memory_allocated()
    lap("profiled ticks", t0)
    phase_s = time.perf_counter() - t_phase

    phase("lm_serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (tied, "
          f"qk-norm); {n_params} params, {p_bytes / 1e9:.3f} GB bf16 (+ a "
          f"float32 copy of the tied head); KV cache {kv_bytes / 1e6:.1f} MB "
          f"at {LM_SLOTS} slots x {LM_MAX_SEQ} rows; peak allocated "
          f"{peak / 1e9:.3f} GB")
    phase("lm_serve", f"prefill {LM_PROMPTS} x {LM_PROMPT_LEN} tokens, card "
          f"vs CPU: max |dlogit| {prefill_err:.4f} (tolerance rtol {LM_RTOL}"
          f", atol {LM_ATOL}); argmax equal wherever the CPU's top-2 margin "
          f"> {LM_ATOL} ({n_unchecked} of {LM_PROMPTS * LM_PROMPT_LEN} "
          f"positions below it, unchecked); {LM_DECODE} decode steps vs "
          f"forward: max |dlogit| {decode_err:.4f}")
    phase("lm_serve", f"engine, {LM_REQUESTS} requests x {LM_PROMPT} prompt "
          f"+ {LM_NEW} new tokens, max_seq {LM_MAX_SEQ}: tokens equal for "
          f"sync == async (4 slots), elastic 2->8 == fixed 8, 2 shards == 1"
          f" (2 slots); final clocks {clocks}; no reference kernel "
          f"launched; tokens/s " + ", ".join(
              f"{k} {v:.1f}" for k, v in tok_s.items()) + f"; {card}")
    phase("lm_serve", f"prefill p50 {prefill_ms:.3f} ms a request "
          f"({LM_PROMPT} sequential decode steps at batch 1); decode tick "
          f"p50 {tick_ms:.3f} ms sync, {async_tick_ms:.3f} ms async "
          f"(dispatch to retire) at {LM_SLOTS} slots; profiler over "
          f"{LM_PROFILED} sync ticks: device busy {busy_ms:.3f} ms and "
          f"{kernels_tick:.0f} kernels a tick, "
          + (f"idle {idle:.3f} of the sync p50 tick" if idle is not None
             else "idle not measured: no device time in the trace")
          + "; top: " + ", ".join(f"{k[:40]} {ms:.3f}"
                                  for k, ms, _ in by_kernel[:4])
          + f"; phase took {phase_s:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in split.items()) + f"); {card}")
    return dict(arch=cfg.name, params=n_params, param_bytes=p_bytes,
                kv_cache_bytes=kv_bytes, peak_allocated_bytes=peak,
                prefill_card_vs_cpu_max_abs_err=prefill_err,
                prefill_unchecked_positions=n_unchecked,
                decode_vs_forward_max_abs_err=decode_err,
                clocks=clocks, tokens_per_s=tok_s,
                drive_wall_s={k: v[1] for k, v in drives.items()},
                prefill_ms_p50=prefill_ms, decode_tick_ms_p50=tick_ms,
                async_decode_tick_ms_p50=async_tick_ms,
                profiled_ticks=LM_PROFILED, device_busy_ms_per_tick=busy_ms,
                kernels_per_tick=kernels_tick, idle_share=idle,
                device_by_kernel=by_kernel[:20], phase_s=phase_s,
                phase_split_s=split, card=card)


# ---------------------------------------------------------------------------
# Phase 13: LM serving of the MoE, SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

LMF_MOE = "deepseek-moe-16b"
#: the card-vs-CPU prefill's cut of DeepSeek-MoE: the dense first layer
#: and 3 MoE layers, at full width
LMF_CUT_LAYERS = 4
#: card vs CPU prefill: prompts x tokens (and encoder frames), teacher-forced
LMF_PROMPTS, LMF_PROMPT_LEN = 2, 16
#: decode steps held against the parallel forward
LMF_DECODE = 8
#: the engine drives of the whole models: requests, prompt and new tokens,
#: slots, cache rows (requests of one length, a multiple of the slots: no
#: row is ever empty, so sync and async feed every row the same tokens)
LMF_REQUESTS, LMF_PROMPT, LMF_NEW = 8, 16, 16
LMF_SLOTS, LMF_MAX_SEQ = 4, 64
#: sync decode ticks traced by ``torch.profiler``
LMF_PROFILED = 3
#: smoke-size drives card vs CPU: requests x (prompt + new) through slots
LMF_SMOKE_REQUESTS, LMF_SMOKE_SLOTS = 4, 2
#: the whole models against the CPU: the reference's own prefill/decode
#: bound; the smoke sizes: the CPU parity tests' bound
#: (``tests/test_torch_lm_families.py``)
LMF_RTOL, LMF_ATOL = LM_RTOL, LM_ATOL
LMF_SMOKE_RTOL, LMF_SMOKE_ATOL = 0.02, 0.08
#: the router's probabilities of one run against another's (each from its
#: own hidden states, which differ by the bf16 noise of the layers below):
#: within the logits' relative tolerance, at every routed token, so an
#: expert can differ only where two experts' probabilities are that close
ROUTER_RTOL, ROUTER_ATOL = LM_RTOL, 1e-4
#: Jamba's Mamba mixer at its full width, over 2 x 64 tokens
JAMBA_MAMBA = dict(d_model=8192, d_state=16, expand=2)
JAMBA_TOKENS = (2, 64)
#: prefill vs token-by-token steps of that layer (bf16 outputs), and the
#: mLSTM chunked prefill vs its sequential scan at xLSTM's width
SSM_RTOL, SSM_ATOL = 0.02, 0.02


def lmf_check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"lm_families: {msg}")


def reference_launches(dispatch) -> dict:
    """The launches counted since the last reset of kernels that port a
    reference kernel: all but the MoE dispatch's (``kernels/moe_dispatch.py``,
    which ports none and which the LM path's MoE layers launch)."""
    from repro_torch.kernels import moe_dispatch

    return {k: v for k, v in dispatch.counts().items()
            if k != moe_dispatch.KERNEL}


class RouterPin:
    """Holds one run's MoE routing to another's.

    ``record()`` keeps every ``moe.route`` call's experts and router
    probabilities (on the host).  ``hold(want)`` then routes each call as
    usual and compares it with ``want(i)``, the record of the i-th call's
    rows: the probabilities must agree within ``ROUTER_RTOL`` /
    ``ROUTER_ATOL``, so an expert can differ only where two experts'
    probabilities are that close (a near tie); there the row takes the
    recorded experts,
    its gates re-normalised from this run's probabilities.  ``held``
    counts the rows taken over, ``worst`` the largest probability
    difference met.  While it records or holds, every MoE layer takes the
    plain dispatch (``moe_dispatch.engages`` off), whose ``moe.route``
    calls it sees; the CUDA kernels route inside themselves."""

    def __init__(self, moe, torch):
        self.moe, self.torch = moe, torch
        self.calls: list = []
        self.held = 0
        self.worst = 0.0

    @staticmethod
    def probs(torch, p, x):
        n = x.shape[0] * x.shape[1]
        return torch.softmax(x.reshape(n, -1).to(torch.float32)
                             @ p["router"], dim=-1)

    @contextlib.contextmanager
    def _routed_by(self, route):
        own, engages = self.moe.route, self.moe.moe_dispatch.engages
        self.moe.route = route(own)
        self.moe.moe_dispatch.engages = lambda *a, **k: False
        try:
            yield
        finally:
            self.moe.route = own
            self.moe.moe_dispatch.engages = engages

    def record(self, on_device: bool = False):
        """``on_device``: keep the record on the device (no host sync,
        as under sync debug mode ``"error"``)."""
        def keep(t):
            return t.detach().clone() if on_device else t.detach().cpu()

        def route(own):
            def recorded(p, x, top_k):
                out = own(p, x, top_k)
                self.calls.append((keep(out[1]),
                                   keep(self.probs(self.torch, p, x))))
                return out
            return recorded
        return self._routed_by(route)

    def hold(self, want):
        torch = self.torch
        count = [0]

        def route(own):
            def held(p, x, top_k):
                vals, idx, aux = own(p, x, top_k)
                rec, rec_probs = (t.to(idx.device) for t in want(count[0]))
                count[0] += 1
                probs = self.probs(torch, p, x)
                worst = float((probs.detach() - rec_probs).abs().max())
                self.worst = max(self.worst, worst)
                lmf_check(torch.allclose(probs, rec_probs, rtol=ROUTER_RTOL,
                                         atol=ROUTER_ATOL),
                          f"router probabilities differ by up to "
                          f"{worst:.3g} between the runs")
                if torch.equal(idx, rec):
                    return vals, idx, aux
                self.held += int((idx != rec).any(-1).sum())
                vals = probs.gather(1, rec)
                return vals / (vals.sum(-1, keepdim=True) + 1e-9), rec, aux
            return held
        return self._routed_by(route)


def lmf_close(label, got, want, rtol, atol, torch):
    """Logits ``got`` (card) against ``want`` (CPU) over the real vocab:
    within the tolerance, and the argmax equal wherever the CPU's top-2
    margin exceeds ``atol`` -> (max |dlogit|, positions below that
    margin, unchecked)."""
    got = got.float().cpu()
    want = want.float().cpu()
    lmf_check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"{label}: bad logits {tuple(got.shape)}")
    err = float((got - want).abs().max())
    lmf_check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"{label}: card logits differ from the CPU's by up to {err}")
    top2 = torch.topk(want, 2, dim=-1).values
    checkable = (top2[..., 0] - top2[..., 1]) > atol
    same = got.argmax(-1) == want.argmax(-1)
    lmf_check(bool(same[checkable].all()), f"{label}: argmax differs where "
              f"the CPU's top-2 margin exceeds {atol}")
    return err, int((~checkable).sum())


def lmf_ticks(engine, cfg, params, seed, torch, asyn, requests, slots,
              prompt, new, max_seq):
    """A drive of equal requests that records, per decode tick, the
    tokens fed to every row and every row's logits -> (tokens by rid,
    feeds, logits rows)."""
    eng = engine.Engine(cfg, params, batch_slots=slots, max_seq=max_seq)
    feeds, rows = [], []
    decode = eng._decode

    def traced(p, state, last):    # the ticks only: a prefill has its own
        logits, state = decode(p, state, last)
        feeds.append(last.cpu().ravel().tolist())
        rows.append(logits[:, -1].float().cpu())
        return logits, state

    eng._decode = traced
    rng = np.random.default_rng(seed)
    for i in range(requests):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, prompt).astype(
                np.int32), max_new_tokens=new))
    done = (eng.run_until_drained_async() if asyn
            else eng.run_until_drained())
    return {r.rid: list(r.out_tokens) for r in done}, feeds, rows


def lmf_same_ticks(label, got, want, vocab, atol):
    """Card drive against CPU drive: every row's fed token equal tick by
    tick up to the first tick where one differs, and there each differing
    token a near tie of the CPU's logits of its row one tick before
    (under the dropping MoE dispatch the rows share expert capacity, so
    nothing after is compared) -> the tick of the split, or None."""
    tokens, feeds, _ = got
    want_tokens, want_feeds, want_rows = want
    lmf_check(len(feeds) == len(want_feeds) and tokens.keys()
              == want_tokens.keys(), f"{label}: the drives differ in shape")
    split = next((i for i, (a, b) in enumerate(zip(want_feeds, feeds))
                  if a != b), None)
    if split is None:
        lmf_check(tokens == want_tokens, f"{label}: tokens differ")
        return None
    for row, (a, b) in enumerate(zip(want_feeds[split], feeds[split])):
        if a != b:
            logits = want_rows[split - 1][row, :vocab]
            margin = float(logits[a] - logits[b])
            lmf_check(int(logits.argmax()) == a and margin <= atol,
                      f"{label}: tick {split} row {row} token {b} != {a}, "
                      f"the CPU's margin {margin}")
    return split


def lmf_engine(label, engine, cfg, params, seed, torch, rng):
    """The whole model's engine at ``LMF_SLOTS`` slots, sync and async
    (equal tokens), its tick and prefill p50 and a profile of sync ticks
    -> record."""
    drives = {}
    with torch.no_grad():
        for mode, asyn in (("sync", False), ("async", True)):
            drives[mode] = lm_drive(
                engine, cfg, params, seed, torch, asyn, tag="lm_families",
                requests=LMF_REQUESTS, prompt=LMF_PROMPT, new=LMF_NEW,
                max_seq=LMF_MAX_SEQ, batch_slots=LMF_SLOTS)
    lmf_check(drives["sync"][0] == drives["async"][0],
              f"{label}: async tokens differ from sync's")
    eng = drives["sync"][2]

    def p50_ms(e, name):
        return e.obs.registry.histogram(name).quantile(0.5) * 1e3

    tick_ms = p50_ms(eng, "serve.decode_tick_s")
    busy_ms, kernels, by_kernel = lm_tick_profile(
        engine, cfg, params, rng, torch, LMF_SLOTS, LMF_MAX_SEQ,
        LMF_PROFILED)
    return dict(
        tick_ms_p50=tick_ms,
        async_tick_ms_p50=p50_ms(drives["async"][2], "serve.decode_tick_s"),
        prefill_ms_p50=p50_ms(eng, "serve.prefill_s"),
        tokens_per_s={m: LMF_REQUESTS * LMF_NEW / d[1]
                      for m, d in drives.items()},
        device_busy_ms_per_tick=busy_ms, kernels_per_tick=kernels,
        idle_share=1 - busy_ms / tick_ms if busy_ms else None,
        device_by_kernel=by_kernel[:12], clock=int(eng.state["cache_len"]))


def lmf_engine_line(rec) -> str:
    idle = rec["idle_share"]
    return (f"engine {LMF_REQUESTS} requests x {LMF_PROMPT} + {LMF_NEW} "
            f"tokens at {LMF_SLOTS} slots, sync == async: tick p50 "
            f"{rec['tick_ms_p50']:.3f} ms sync, {rec['async_tick_ms_p50']:.3f}"
            f" ms async; prefill p50 {rec['prefill_ms_p50']:.3f} ms a "
            f"request; tokens/s " + ", ".join(
                f"{k} {v:.1f}" for k, v in rec["tokens_per_s"].items())
            + f"; profiler over {LMF_PROFILED} sync ticks: device busy "
            f"{rec['device_busy_ms_per_tick']:.3f} ms and "
            f"{rec['kernels_per_tick']:.0f} kernels a tick, "
            + (f"idle {idle:.3f} of the sync p50 tick" if idle is not None
               else "idle not measured: no device time in the trace")
            + "; top: " + ", ".join(f"{k[:32]} {ms:.3f}"
                                    for k, ms, _ in
                                    rec["device_by_kernel"][:3]))


def lmf_deepseek(seed, dev, torch, card):
    """DeepSeek-MoE-16B whole on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api, moe, stack
    from repro_torch.serve import engine
    from repro_torch.utils.tree import (
        tree_count_params,
        tree_map,
        tree_size_bytes,
    )

    t0 = time.perf_counter()
    cfg = get_arch(LMF_MOE)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    n_params, p_bytes = tree_count_params(params), tree_size_bytes(params)
    lmf_check(n_params == api.param_count(cfg),
              f"{cfg.name}: the params differ from param_count")
    rng = np.random.default_rng(seed + 50)
    toks = rng.integers(0, cfg.vocab, (LMF_PROMPTS, LMF_PROMPT_LEN)).astype(
        np.int32)

    # card vs CPU at a cut depth, the card's routing held to the CPU's
    cut_cfg = dataclasses.replace(cfg, n_layers=LMF_CUT_LAYERS)
    reps = stack.n_repeats(cut_cfg)
    cut = dict(params, blocks=[tree_map(lambda t: t[:reps], b)
                               for b in params["blocks"]])
    prefill = api.prefill_fn(cut_cfg)
    pin = RouterPin(moe, torch)
    with torch.no_grad():
        cpu_cut = tree_map(lambda t: t.cpu(), cut)
        with pin.record():
            want, _ = prefill(cpu_cut, {"tokens": torch.as_tensor(toks)})
        del cpu_cut
        with pin.hold(lambda i: pin.calls[i]):
            got, _ = prefill(cut, {"tokens": torch.as_tensor(toks,
                                                             device=dev)})
    prefill_err, unchecked = lmf_close(
        f"{cfg.name} cut prefill", got[..., :cfg.vocab],
        want[..., :cfg.vocab], LMF_RTOL, LMF_ATOL, torch)
    prefill_held, prefill_worst = pin.held, pin.worst
    del cut, got, want

    # decode against forward at full depth, the dense dispatch (exact,
    # batch-independent), each step's routing held to the forward's
    n_moe = stack.n_repeats(cfg) * sum(
        1 for _, f in stack.block_structure(cfg) if f == "moe")
    dtoks = torch.as_tensor(toks[:1, :LMF_DECODE], device=dev)
    pin = RouterPin(moe, torch)
    moe.FORCE_IMPL = "dense"
    try:
        with torch.no_grad():
            with pin.record():
                full, _ = stack.forward(cfg, params, dtoks, mode="train")
            state = api.init_decode_state(cfg, 1, 2 * LMF_DECODE,
                                          device=dev)
            dec = api.decode_fn(cfg)
            with pin.hold(lambda i: tuple(
                    t[i // n_moe:i // n_moe + 1]
                    for t in pin.calls[i % n_moe])):
                for t in range(LMF_DECODE):
                    logits, state = dec(params, state, dtoks[:, t:t + 1])
    finally:
        moe.FORCE_IMPL = None
    decode_err = float((logits[0, -1] - full[0, -1]).abs().max())
    lmf_check(torch.allclose(logits[0, -1], full[0, -1], rtol=LMF_RTOL,
                             atol=LMF_ATOL),
              f"{cfg.name}: decode differs from forward by up to "
              f"{decode_err}")
    decode_held, decode_worst = pin.held, pin.worst
    del state, full, logits
    checks_s = time.perf_counter() - t0

    rec = lmf_engine(cfg.name, engine, cfg, params, seed, torch, rng)
    peak = torch.cuda.max_memory_allocated()
    phase("lm_families", f"{cfg.name}: {cfg.n_layers} layers (1 dense, "
          f"{n_moe} MoE of {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}"
          f", {cfg.moe.n_shared} shared), d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}; {n_params} params ({api.active_param_count(cfg)} "
          f"active), {p_bytes / 1e9:.3f} GB bf16; peak allocated "
          f"{peak / 1e9:.3f} GB; {card}")
    phase("lm_families", f"{cfg.name}: prefill {LMF_PROMPTS} x "
          f"{LMF_PROMPT_LEN} tokens at {LMF_CUT_LAYERS} layers (the dense "
          f"one and {reps} MoE, full width), card vs CPU, dropping dispatch:"
          f" max |dlogit| {prefill_err:.4f} (rtol {LMF_RTOL}, atol "
          f"{LMF_ATOL}), {unchecked} positions under the argmax margin, "
          f"router probabilities within {prefill_worst:.2e}, "
          f"{prefill_held} routing rows held at a near tie; {LMF_DECODE} "
          f"decode steps vs forward at full depth, dense dispatch: max "
          f"|dlogit| {decode_err:.4f}, router probabilities within "
          f"{decode_worst:.2e}, {decode_held} rows held; checks "
          f"{checks_s:.1f} s")
    phase("lm_families", f"{cfg.name}: " + lmf_engine_line(rec)
          + f"; {card}")
    rec.update(arch=cfg.name, params=n_params, param_bytes=p_bytes,
               peak_allocated_bytes=peak,
               cut_prefill_max_abs_err=prefill_err,
               cut_prefill_unchecked_positions=unchecked,
               cut_prefill_router_rows_held=prefill_held,
               cut_prefill_router_prob_max_abs_err=prefill_worst,
               decode_vs_forward_max_abs_err=decode_err,
               decode_router_rows_held=decode_held,
               decode_router_prob_max_abs_err=decode_worst)
    del params
    return rec


def lmf_layers(cfg, stack, params, cpu=None):
    """(card params, CPU params or None, mixer, ffn) of every layer of a
    stack, in order."""
    for i, p in enumerate(params["head_layers"]):
        yield p, cpu and cpu["head_layers"][i], "a", "dense"
    for r in range(stack.n_repeats(cfg)):
        for pos, (mixer, ffn) in enumerate(stack.block_structure(cfg)):
            yield (stack.index_tree(params["blocks"][pos], r),
                   cpu and stack.index_tree(cpu["blocks"][pos], r), mixer,
                   ffn)


def lmf_teacher_forced(name, cfg, params, cpu, toks, dev, torch):
    """The stack on the card against the CPU layer by layer: each layer
    on the card takes the CPU's input to it (bf16 noise is not carried
    from layer to layer); then the head on the CPU's last hidden state
    -> (max |dh| over the layers, max |dlogit|, unchecked positions)."""
    from repro_torch.models import layers, stack

    worst = 0.0
    with torch.no_grad(), layers.lm_precision():
        h = stack._embed_inputs(cfg, cpu, toks)
        for i, (p, p_cpu, mixer, ffn) in enumerate(
                lmf_layers(cfg, stack, params, cpu)):
            want, _, _ = stack.apply_layer(cfg, p_cpu, h, mixer, ffn,
                                           "train")
            got, _, _ = stack.apply_layer(cfg, p, h.to(dev), mixer, ffn,
                                          "train")
            got, want = got.float().cpu(), want.float()
            err = float((got - want).abs().max())
            lmf_check(torch.allclose(got, want, rtol=LMF_RTOL,
                                     atol=LMF_ATOL),
                      f"{name}: layer {i} ({mixer}) on the card differs "
                      f"from the CPU's by {err}")
            worst = max(worst, err)
            h = want.to(torch.bfloat16)
        logit_err, unchecked = lmf_close(
            f"{name} head", stack._logits(cfg, params, h.to(dev)),
            stack._logits(cfg, cpu, h), LMF_RTOL, LMF_ATOL, torch)
    return worst, logit_err, unchecked


def lmf_layer_steps(name, cfg, params, toks, dev, torch):
    """Decode against forward on the card, layer by layer: each layer's
    token-by-token decode from a zero state against its full-sequence
    forward on the same inputs (the forward's input to that layer) ->
    max |dh| over the layers."""
    from repro_torch.models import layers, stack

    n = toks.shape[1]
    worst = 0.0
    with torch.no_grad(), layers.lm_precision():
        h = stack._embed_inputs(cfg, params, toks)
        for i, (p, _, mixer, ffn) in enumerate(lmf_layers(cfg, stack,
                                                          params)):
            full, _, _ = stack.apply_layer(cfg, p, h, mixer, ffn, "train")
            state = stack._mixer_state(cfg, mixer, h.shape[0], 2 * n,
                                       cfg.n_kv_heads, dev)
            clock = torch.zeros((), dtype=torch.int32, device=dev)
            steps = []
            for t in range(n):
                out, new, _ = stack.apply_layer(
                    cfg, p, h[:, t:t + 1], mixer, ffn, "decode",
                    cache=state, cache_len=clock)
                state, clock = new, clock + 1
                steps.append(out)
            steps = torch.cat(steps, dim=1).float()
            err = float((steps - full.float()).abs().max())
            lmf_check(torch.allclose(steps, full.float(), rtol=LMF_RTOL,
                                     atol=LMF_ATOL),
                      f"{name}: layer {i} ({mixer}) decode differs from its "
                      f"forward by {err}")
            worst = max(worst, err)
            h = full
    return worst


def lmf_whole(name, seed, dev, torch, card):
    """xLSTM-350M or SeamlessM4T-medium whole on the card.  The random-
    weight xLSTM is chaotic at full depth (mLSTM divides by its
    normaliser, which bf16 noise moves), so its card-vs-CPU prefill and
    its decode-vs-forward are held layer by layer, each layer on the
    other side's inputs; the free-running differences and the logits'
    response to noise-sized changes of the embeddings are printed."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api, encdec, ssm, stack
    from repro_torch.serve import engine
    from repro_torch.utils.tree import tree_count_params, tree_map

    cfg = get_arch(name)
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    n_params = tree_count_params(params)
    lmf_check(n_params == api.param_count(cfg),
              f"{name}: the params differ from param_count")
    rng = np.random.default_rng(seed + 60)
    toks = rng.integers(0, cfg.vocab, (LMF_PROMPTS, LMF_PROMPT_LEN)).astype(
        np.int32)
    frames = torch.as_tensor(rng.standard_normal(
        (LMF_PROMPTS, LMF_PROMPT_LEN, cfg.d_model)).astype(np.float32)).to(
            torch.bfloat16)
    batch = {"tokens": torch.as_tensor(toks)}
    if cfg.family == "encdec":
        batch["frontend"] = frames
    prefill = api.prefill_fn(cfg)
    cpu = tree_map(lambda t: t.cpu(), params)
    chaotic = cfg.family == "ssm"
    extra = {}
    with torch.no_grad():
        want, _ = prefill(cpu, batch)
        got, _ = prefill(params, tree_map(lambda t: t.to(dev), batch))
    free_err = float((got.cpu() - want).abs().max())
    if chaotic:
        layer_err, prefill_err, unchecked = lmf_teacher_forced(
            name, cfg, params, cpu, torch.as_tensor(toks), dev, torch)
        # the logits' response to the embeddings times 1 + 0.01 N(0, 1)
        noisy = dict(params, embed=(params["embed"].float() * (
            1 + 0.01 * torch.randn(params["embed"].shape, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(seed)))).to(
            torch.bfloat16))
        with torch.no_grad():
            moved, _ = prefill(noisy, tree_map(lambda t: t.to(dev), batch))
        del noisy
        extra.update(prefill_layer_max_abs_err=layer_err,
                     prefill_free_running_max_abs_err=free_err,
                     noise_response_max_abs_dlogit=float(
                         (moved - got).abs().max()))
        del moved
    else:
        prefill_err, unchecked = lmf_close(
            f"{name} prefill", got[..., :cfg.vocab], want[..., :cfg.vocab],
            LMF_RTOL, LMF_ATOL, torch)
    del got, want, cpu

    dtoks = torch.as_tensor(toks[:1, :LMF_DECODE], device=dev)
    dec = api.decode_fn(cfg)
    with torch.no_grad():
        if cfg.family == "encdec":
            fr = frames[:1].to(dev)
            full, _ = encdec.forward(cfg, params, dtoks, fr)
            state = encdec.init_decode_state(cfg, 1, 2 * LMF_DECODE,
                                             fr.shape[1], device=dev)
            state["memory"] = encdec.encode(cfg, params, fr)
        else:
            full, _ = stack.forward(cfg, params, dtoks, mode="train")
            state = api.init_decode_state(cfg, 1, 2 * LMF_DECODE,
                                          device=dev)
        for t in range(LMF_DECODE):
            logits, state = dec(params, state, dtoks[:, t:t + 1])
        if chaotic:
            # the chunked mLSTM (chunks of 16) against its sequential scan
            # on the first mLSTM layer, 2 x 64 tokens at full width
            p = stack.index_tree(params["blocks"][0]["mlstm"], 0)
            x = torch.randn(2, 64, cfg.d_model, device=dev, generator=(
                torch.Generator(device=dev).manual_seed(seed))).to(
                    torch.bfloat16)
            kw = dict(n_heads=cfg.n_heads, expand=cfg.ssm_expand)
            chunked, st_c = ssm.mlstm_prefill(p, x, chunk=16, **kw)
            seq, st_s = ssm.mlstm_prefill_sequential(p, x, **kw)
            err = float((chunked.float() - seq.float()).abs().max())
            lmf_check(torch.allclose(chunked.float(), seq.float(),
                                     rtol=SSM_RTOL, atol=SSM_ATOL),
                      f"{name}: chunked mLSTM differs from the sequential "
                      f"scan by up to {err}")
            c_err = float((st_c[0] - st_s[0]).abs().max())
            lmf_check(torch.allclose(st_c[0], st_s[0], rtol=1e-3, atol=1e-4),
                      f"{name}: chunked mLSTM state differs by {c_err}")
            extra.update(mlstm_chunked_vs_sequential_max_abs_err=err,
                         mlstm_state_max_abs_err=c_err)
    decode_err = float((logits[0, -1] - full[0, -1]).abs().max())
    if chaotic:
        extra.update(decode_free_running_max_abs_err=decode_err)
        decode_err = lmf_layer_steps(name, cfg, params, dtoks, dev, torch)
    else:
        lmf_check(torch.allclose(logits[0, -1], full[0, -1], rtol=LMF_RTOL,
                                 atol=LMF_ATOL),
                  f"{name}: decode differs from forward by up to "
                  f"{decode_err}")
    del state, full, logits

    rec = lmf_engine(name, engine, cfg, params, seed, torch, rng)
    if chaotic:
        held = (f"prefill card vs CPU layer by layer: max |dh| "
                f"{extra['prefill_layer_max_abs_err']:.4f}, head max "
                f"|dlogit| {prefill_err:.4f} ({unchecked} positions under "
                f"the argmax margin); {LMF_DECODE} decode steps vs forward "
                f"layer by layer: max |dh| {decode_err:.4f}; not held, "
                f"free-running over all layers: card vs CPU max |dlogit| "
                f"{free_err:.4f}, decode vs forward "
                f"{extra['decode_free_running_max_abs_err']:.4f}, and the "
                f"embeddings x (1 + 0.01 N(0,1)) move the card's logits by "
                f"{extra['noise_response_max_abs_dlogit']:.4f}; chunked "
                f"mLSTM (chunk 16) vs sequential over 2 x 64 tokens: max "
                f"|dout| "
                f"{extra['mlstm_chunked_vs_sequential_max_abs_err']:.4f}, "
                f"|dC| {extra['mlstm_state_max_abs_err']:.2e}")
    else:
        held = (f"prefill {LMF_PROMPTS} x {LMF_PROMPT_LEN} card vs CPU: max "
                f"|dlogit| {prefill_err:.4f} ({unchecked} positions under "
                f"the argmax margin); {LMF_DECODE} decode steps vs forward "
                f"(memory = encode(frames)): max |dlogit| {decode_err:.4f}")
    phase("lm_families", f"{name}: {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
          + f", d_model {cfg.d_model}, vocab {cfg.vocab}; {n_params} params; "
          f"{held}; {card}")
    phase("lm_families", f"{name}: " + lmf_engine_line(rec) + f"; {card}")
    rec.update(arch=name, params=n_params,
               prefill_card_vs_cpu_max_abs_err=prefill_err,
               prefill_unchecked_positions=unchecked,
               decode_vs_forward_max_abs_err=decode_err, **extra)
    del params
    return rec


def lmf_smoke(name, seed, dev, torch, card):
    """A smoke config (Jamba, Llama-4-Scout): prefill, decode and the
    engine on the card against the CPU, the card's routing held to the
    CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api, moe
    from repro_torch.serve import engine
    from repro_torch.utils.tree import tree_map

    cfg = get_arch(name, smoke=True)
    cpu = api.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                          device="cpu")
    params = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(seed + 70)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    prefill = api.prefill_fn(cfg)
    pin = RouterPin(moe, torch)
    with torch.no_grad():
        with pin.record():
            want, _ = prefill(cpu, {"tokens": toks})
        with pin.hold(lambda i: pin.calls[i]):
            got, _ = prefill(params, {"tokens": toks.to(dev)})
    prefill_err, _ = lmf_close(f"{name} prefill", got, want, LMF_SMOKE_RTOL,
                               LMF_SMOKE_ATOL, torch)
    dec = api.decode_fn(cfg)
    decode_err, decode_held, decode_worst = 0.0, 0, 0.0
    with torch.no_grad():
        s_cpu = api.init_decode_state(cfg, 2, 8, device="cpu")
        s_card = api.init_decode_state(cfg, 2, 8, device=dev)
        for t in range(10):               # past max_seq: the clamped write
            step = RouterPin(moe, torch)
            with step.record():
                a, s_cpu = dec(cpu, s_cpu, toks[:, t:t + 1])
            with step.hold(lambda i: step.calls[i]):
                b, s_card = dec(params, s_card, toks[:, t:t + 1].to(dev))
            decode_held += step.held
            decode_worst = max(decode_worst, step.worst)
            decode_err = max(decode_err, lmf_close(
                f"{name} decode step {t}", b, a, LMF_SMOKE_RTOL,
                LMF_SMOKE_ATOL, torch)[0])
    splits = {}
    with torch.no_grad():
        for mode, asyn in (("sync", False), ("async", True)):
            args = (seed, torch, asyn, LMF_SMOKE_REQUESTS, LMF_SMOKE_SLOTS,
                    6, 8, 32)
            splits[mode] = lmf_same_ticks(
                f"{name} engine {mode}",
                lmf_ticks(engine, cfg, params, *args),
                lmf_ticks(engine, cfg, cpu, *args), cfg.vocab,
                LMF_SMOKE_ATOL)
    # the smoke model's own tick, untraced, and a profile of sync ticks
    with torch.no_grad():
        _, wall, eng = lm_drive(
            engine, cfg, params, seed, torch, tag="lm_families",
            requests=LMF_SMOKE_REQUESTS, prompt=6, new=8, max_seq=32,
            batch_slots=LMF_SMOKE_SLOTS)
    tick_ms = eng.obs.registry.histogram(
        "serve.decode_tick_s").quantile(0.5) * 1e3
    prefill_ms = eng.obs.registry.histogram(
        "serve.prefill_s").quantile(0.5) * 1e3
    busy_ms, kernels, _ = lm_tick_profile(
        engine, cfg, params, rng, torch, LMF_SMOKE_SLOTS, 32, LMF_PROFILED)
    idle = 1 - busy_ms / tick_ms if busy_ms else None
    phase("lm_families", f"{cfg.name} (smoke): tick p50 {tick_ms:.3f} ms "
          f"at {LMF_SMOKE_SLOTS} slots, prefill p50 {prefill_ms:.3f} ms (6 "
          f"tokens), device busy {busy_ms:.3f} ms and {kernels:.0f} kernels "
          f"a tick, " + (f"idle {idle:.3f}" if idle is not None
                         else "idle not measured") + f"; {card}")
    phase("lm_families", f"{cfg.name} (smoke): prefill 2 x 16 card vs CPU "
          f"max |dlogit| {prefill_err:.4f}, router probabilities within "
          f"{pin.worst:.2e}, {pin.held} routing rows held; 10 decode steps "
          f"max |dlogit| {decode_err:.4f}, within {decode_worst:.2e}, "
          f"{decode_held} rows held; engine {LMF_SMOKE_REQUESTS} requests at "
          f"{LMF_SMOKE_SLOTS} slots, card vs CPU sync / async: first "
          f"differing tick {splits['sync']} / {splits['async']} (None: "
          f"every token equal); {card}")
    return dict(arch=cfg.name, prefill_max_abs_err=prefill_err,
                prefill_router_rows_held=pin.held,
                decode_max_abs_err=decode_err,
                decode_router_rows_held=decode_held, engine_split=splits,
                tick_ms_p50=tick_ms, prefill_ms_p50=prefill_ms,
                device_busy_ms_per_tick=busy_ms, kernels_per_tick=kernels,
                idle_share=idle)


def lmf_mamba(seed, dev, torch, card):
    """One Mamba mixer at Jamba's full width: the chunked prefill over
    ``JAMBA_TOKENS`` against token-by-token steps on the card, and
    against the CPU's prefill."""
    from repro_torch.models import ssm
    from repro_torch.utils.tree import tree_map

    d, n = JAMBA_MAMBA["d_model"], JAMBA_MAMBA["d_state"]
    kw = dict(d_state=n, expand=JAMBA_MAMBA["expand"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = ssm.init_mamba(gen, d, device=dev, **kw)
    x = torch.randn(*JAMBA_TOKENS, d, device=dev, generator=gen).to(
        torch.bfloat16)
    with torch.no_grad():
        out, (st, tail) = ssm.mamba_prefill(p, x, **kw)
        state = ssm.mamba_init_state(JAMBA_TOKENS[0], d, n,
                                     expand=kw["expand"], device=dev)
        steps = []
        for t in range(JAMBA_TOKENS[1]):
            o, state = ssm.mamba_step(p, x[:, t:t + 1], state, **kw)
            steps.append(o)
        steps = torch.cat(steps, dim=1)
        cpu_out, (cpu_st, _) = ssm.mamba_prefill(
            tree_map(lambda t: t.cpu(), p), x.cpu(), **kw)
    step_err = float((steps.float() - out.float()).abs().max())
    lmf_check(torch.allclose(steps.float(), out.float(), rtol=SSM_RTOL,
                             atol=SSM_ATOL),
              f"jamba mamba: steps differ from the prefill by {step_err}")
    st_err = float((state[0] - st).abs().max())
    lmf_check(torch.allclose(state[0], st, rtol=1e-3, atol=1e-4)
              and torch.equal(state[1], tail),
              f"jamba mamba: the stepped state differs by {st_err}")
    # the card's and the CPU's bf16 input projections round apart, so the
    # float32 states are held at the outputs' tolerance
    cpu_err = float((out.float().cpu() - cpu_out.float()).abs().max())
    cpu_st_err = float((st.cpu() - cpu_st).abs().max())
    lmf_check(torch.allclose(out.float().cpu(), cpu_out.float(),
                             rtol=SSM_RTOL, atol=SSM_ATOL)
              and torch.allclose(st.cpu(), cpu_st, rtol=SSM_RTOL,
                                 atol=SSM_ATOL),
              f"jamba mamba: card prefill differs from the CPU's by "
              f"{cpu_err} (state {cpu_st_err})")
    phase("lm_families", f"jamba mamba mixer at d_model {d} (d_inner "
          f"{d * kw['expand']}, d_state {n}), {JAMBA_TOKENS[0]} x "
          f"{JAMBA_TOKENS[1]} tokens: prefill vs token-by-token steps max "
          f"|dout| {step_err:.4f}, ssm state {st_err:.2e}; card vs CPU "
          f"prefill max |dout| {cpu_err:.4f}, ssm state {cpu_st_err:.2e}; "
          f"{card}")
    return dict(d_model=d, steps_vs_prefill_max_abs_err=step_err,
                state_max_abs_err=st_err, card_vs_cpu_max_abs_err=cpu_err,
                card_vs_cpu_state_max_abs_err=cpu_st_err)


def lm_families_phase(seed, dev, torch, dispatch, card):
    """Phase 13: DeepSeek-MoE-16B whole, xLSTM-350M and SeamlessM4T-medium
    whole, Jamba and Llama-4-Scout at smoke size and one Mamba mixer at
    Jamba's width; no reference kernel launched.  Returns the record."""
    t0 = time.perf_counter()
    split = {}
    dispatch.reset()
    rec = {}
    for key, run in (
            ("deepseek", lambda: lmf_deepseek(seed, dev, torch, card)),
            ("xlstm", lambda: lmf_whole("xlstm-350m", seed, dev, torch,
                                        card)),
            ("seamless", lambda: lmf_whole("seamless-m4t-medium", seed, dev,
                                           torch, card)),
            ("jamba", lambda: lmf_smoke("jamba-1.5-large-398b", seed, dev,
                                        torch, card)),
            ("llama4", lambda: lmf_smoke("llama4-scout-17b-a16e", seed, dev,
                                         torch, card)),
            ("jamba_mamba", lambda: lmf_mamba(seed, dev, torch, card))):
        t = time.perf_counter()
        rec[key] = run()
        torch.cuda.empty_cache()
        split[key] = time.perf_counter() - t
    lmf_check(not reference_launches(dispatch), f"the LM path launched a "
              f"reference kernel: {reference_launches(dispatch)}")
    phase_s = time.perf_counter() - t0
    phase("lm_families", "no reference kernel launched; phase took "
          f"{phase_s:.1f} s (" + ", ".join(f"{k} {v:.1f}"
                                          for k, v in split.items())
          + f"); {card}")
    rec.update(phase_s=phase_s, phase_split_s=split, card=card)
    return rec


# ---------------------------------------------------------------------------
# Phase 13c: the MoE dispatch's kernels at the LM cells' shapes
# ---------------------------------------------------------------------------

#: the LM cells' decode layers: (tokens N, top-k, experts E, D, F, shared
#: experts, the held share, renorm) of DeepSeek-MoE-16B at 32 slots and
#: AI21-Jamba2-Mini at 64 (8 of its 16 experts held)
MDP_SHAPES = {
    "deepseek_b32": (32, 6, 64, 2048, 1408, 2, None, True),
    "jamba_b64": (64, 2, 16, 4096, 14336, 0, (0, 8), False),
}
#: the engines whose tick counts the launches: config, cut depth (whole
#: blocks at full width), slots (the cells')
MDP_ENGINES = (("deepseek-moe-16b", LMF_CUT_LAYERS, 32),
               ("jamba2_mini", 8, 64))


def mdp_check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"moe_dispatch: {msg}")


def mdp_layer(name, seed, dev, torch):
    """One MoE layer of ``MDP_SHAPES[name]`` on the card and its input."""
    from repro_torch.models import moe

    n, k, e, d, f, shared, held, renorm = MDP_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    p = moe.init_moe(g, d, f, e, shared, device=dev,
                     n_held=None if held is None else held[1] - held[0])
    x = torch.randn(n, 1, d, generator=g, device=dev)
    return p, x


def mdp_compare(name, p, x, torch, dispatch):
    """The wrapper and its kernels against ``route`` + ``dispatch_dropping``
    on the same inputs: experts, positions, keep masks and counts equal,
    the output within 2 bf16 ulps of the layer's scale (the GEMMs
    accumulate in another order than cuBLAS, so g, u, h and y may each
    round to the neighbouring bf16 value) -> the largest output
    difference."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import layers, moe

    n, k, e, d, f, shared, held, renorm = MDP_SHAPES[name]
    share = moe._share(p, held)
    cap = md.capacity(n, k, e, 1.25)
    lo, hi = share or (0, e)
    with torch.no_grad(), layers.lm_precision():
        gv, gi, aux = moe.route(p, x, k, renorm)
        with moe.expert_tally() as plain:
            want = moe.dispatch_dropping(p, x, gv, gi, held=held)
        pos, keep = moe._positions(gi, e, cap)
        pos = torch.stack(pos, -1)
        keep = torch.stack(keep, -1) & (gi >= lo) & (gi < hi)
        before = dispatch.count(md.KERNEL)
        with moe.expert_tally() as fused:
            got, got_aux = moe.apply_moe(p, x, top_k=k, held=held,
                                         renorm=renorm)
        mdp_check(dispatch.count(md.KERNEL) - before == 1 and fused.fused == 1,
                  f"{name}: the layer did not take the kernels once")
        v = md.views(md._launch(p, x, top_k=k, cap=cap, share=share,
                                renorm=renorm))
    for key, a, b in (("experts", v["idx"], gi), ("positions", v["pos"], pos),
                      ("keep masks", v["keep"], keep),
                      ("counts", v["counts"], plain[0][0]),
                      ("tally counts", fused[0][0], plain[0][0])):
        mdp_check(torch.equal(a, b), f"{name}: {key} differ from the plain "
                  "dispatch's")
    mdp_check(fused[0][1:] == plain[0][1:], f"{name}: tally entry "
              f"{fused[0][1:]} != {plain[0][1:]}")
    mdp_check(torch.allclose(got_aux, aux, rtol=1e-5, atol=1e-7),
              f"{name}: aux {float(got_aux)} != {float(aux)}")
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    mdp_check(bool(torch.isfinite(got).all()) and err <= 2 * 2 ** -8 * scale,
              f"{name}: output differs by {err} at scale {scale}")
    return err, scale


def mdp_times(name, p, x, torch):
    """The routed experts' dispatch (no shared experts): the kernels
    (``md._launch``), ``apply_moe`` with the kernels refused (the plain
    path, host-bound), ``torch.bmm`` of the same buckets (the library's
    time for the experts' products), each between CUDA events over calls
    issued back to back, and the byte bound -> record."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import layers, moe

    n, k, e, d, f, shared, held, renorm = MDP_SHAPES[name]
    p = {kk: v for kk, v in p.items() if kk != "shared"}
    share = moe._share(p, held)
    cap = md.capacity(n, k, e, 1.25)
    e_held = p["wi_gate"].shape[0]
    xe = torch.randn(e_held, cap, d, device=x.device).to(torch.bfloat16)

    def kernels():
        md._launch(p, x, top_k=k, cap=cap, share=share, renorm=renorm)

    def plain():
        engages, md.engages = md.engages, lambda *a, **kw: False
        try:
            moe.apply_moe(p, x, top_k=k, held=held, renorm=renorm)
        finally:
            md.engages = engages

    def library():
        g = torch.bmm(xe, p["wi_gate"])
        u = torch.bmm(xe, p["wi_up"])
        h = torch.nn.functional.silu(g.float()).to(torch.bfloat16) * u
        torch.bmm(h, p["wo"])

    # the experts' weights, the router, x read and the output written once
    nbytes = (3 * e_held * d * f * 2 + d * e * 4
              + x.numel() * x.element_size() * 2)
    with torch.no_grad(), layers.lm_precision():
        return dict(ms=call_ms(kernels, torch),
                    plain_ms=call_ms(plain, torch, iters=5),
                    library_ms=call_ms(library, torch),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def mdp_tick_launches(arch, layers_, slots, seed, dev, torch, dispatch):
    """One decode tick of the serving engine at full width and a cut
    depth, every slot live: the MoE dispatch's launches, and the tick's
    ``serve.moe_fused`` and ``serve.moe_layer_ticks``, each equal to the
    MoE layer count -> launches."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.jamba2_mini import CONFIG
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import api, stack
    from repro_torch.serve import engine

    cfg = CONFIG if arch == CONFIG.name else get_arch(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers_)
    n_moe = stack.n_repeats(cfg) * sum(
        1 for _, f in stack.block_structure(cfg) if f == "moe")
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    eng = engine.Engine(cfg, params, batch_slots=slots, max_seq=32)
    rng = np.random.default_rng(seed)
    for i in range(slots):
        eng.submit(engine.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, 2).astype(np.int32), max_new_tokens=8))
    with torch.no_grad():
        eng.step()       # fills every slot: the prefills and a first tick
        reg = eng.obs.registry
        was = {c: reg.counter(c).value
               for c in ("serve.moe_fused", "serve.moe_layer_ticks")}
        dispatch.reset()
        eng.step()
    launches = dispatch.count(md.KERNEL)
    got = {c: reg.counter(c).value - v for c, v in was.items()}
    mdp_check(launches == n_moe and set(got.values()) == {n_moe},
              f"{arch}: a tick of {n_moe} MoE layers launched {launches}, "
              f"counted {got}")
    del eng, params
    torch.cuda.empty_cache()
    return launches


def moe_dispatch_phase(seed, dev, torch, dispatch, card):
    """Phase 13c: the MoE dispatch's kernels (``kernels/moe_dispatch.py``)
    at both LM cells' decode layers against the plain dispatch, timed
    beside it, ``torch.bmm`` and the byte bound, and their launches in a
    decode tick of each cell's engine -> (record, the ``kernels`` line's
    entry)."""
    t0 = time.perf_counter()
    rec = {}
    for i, name in enumerate(MDP_SHAPES):
        p, x = mdp_layer(name, seed + 60 + i, dev, torch)
        err, scale = mdp_compare(name, p, x, torch, dispatch)
        rec[name] = dict(max_abs_err=err, out_scale=scale,
                         **mdp_times(name, p, x, torch))
        del p, x
        torch.cuda.empty_cache()
        r = rec[name]
        phase("moe_dispatch", f"{name} {MDP_SHAPES[name][:5]}: experts, "
              f"positions, keep masks and counts == route + "
              f"dispatch_dropping, output within {err:.3e} (scale "
              f"{scale:.3e}); kernels {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms (bytes); {card}")
    launches = {arch: mdp_tick_launches(arch, cut, slots, seed, dev, torch,
                                        dispatch)
                for arch, cut, slots in MDP_ENGINES}
    phase("moe_dispatch", "one decode tick, every slot live, one launch a "
          "MoE layer and serve.moe_fused == serve.moe_layer_ticks: "
          + ", ".join(f"{a} {n}" for a, n in launches.items())
          + f"; phase took {time.perf_counter() - t0:.1f} s")
    rec.update(tick_launches=launches, card=card)
    total = lambda key: sum(rec[n][key] for n in MDP_SHAPES)  # noqa: E731
    entry = {"name": "moe_dispatch", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
             "replaces": None, "launches": sum(launches.values()),
             "max_abs_err": max(rec[n]["max_abs_err"] for n in MDP_SHAPES),
             "ms": total("ms"), "plain_ms": total("plain_ms"),
             "bound_ms": total("bound_ms"), "bound_by": "bytes",
             "library_ms": total("library_ms")}
    return rec, entry


# ---------------------------------------------------------------------------
# Phase 13b: the LM engine over several devices
# ---------------------------------------------------------------------------

#: the checked drives: at least ``LC_REQUESTS`` requests (one a slot past
#: that) of ``LC_PROMPT`` tokens, ``max_new`` alternating ``LC_NEW`` (the
#: short requests leave their shards empty, so the pool rebalances)
LC_REQUESTS, LC_PROMPT, LC_NEW, LC_MAX_SEQ = 8, 16, (2, 8), 64
#: the timed drives: one request a slot, prompt and new tokens
LC_TIMED_PROMPT, LC_TIMED_NEW = 2, 12
#: sync ticks traced by ``torch.profiler`` a mesh
LC_PROFILED = 3


def lc_check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"lm_cards: {msg}")


def lc_slots(S: int) -> int:
    """Slots of an S-shard pool: 4, and 2 a shard past 2 shards (only a
    shard of 2 slots can be left 2 below another, which a rebalance
    needs)."""
    return max(4, 2 * S)


def lc_meshes(torch) -> tuple[int, dict]:
    """-> (cards spanned, the shard counts of each model): S = n and 2n
    over the n >= 2 cards (the largest power of two present; 2n for
    Qwen3 only), else 2 and 4 shards of ``cuda:0``."""
    n = torch.cuda.device_count()
    cards = 1 << (n.bit_length() - 1)
    if cards > 1:
        return cards, {LM_ARCH: (cards, 2 * cards), LMF_MOE: (cards,)}
    return 1, {LM_ARCH: (2, 4), LMF_MOE: (2, 4)}


@contextlib.contextmanager
def lc_strict(torch, on: bool):
    """Sync debug mode ``"error"`` for the block when ``on``: a host sync
    in it raises."""
    if on:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode("default")


def lc_placement(label, eng, ShardRows, Replicated, tree_map) -> None:
    """Each slot leaf of the cache and the feedback token a ``ShardRows``
    whose part ``s`` lies on ``mesh.devices[s]`` in storage of its own;
    the clock a copy on each distinct device; one params copy a distinct
    device, each shard stepping with its device's."""
    mesh = eng.mesh
    leaves = []
    tree_map(leaves.append, eng.device_state())
    seen = set()
    for leaf in leaves:
        if leaf is None or isinstance(leaf, Replicated):
            continue
        lc_check(isinstance(leaf, ShardRows) and leaf.devices == mesh.devices,
                 f"{label}: a state leaf off its shards' devices: {leaf!r}")
        for p in leaf.parts:
            ptr = p.untyped_storage().data_ptr()
            lc_check(ptr not in seen, f"{label}: two parts share storage")
            seen.add(ptr)
    clock = eng.state["cache_len"]
    lc_check(isinstance(clock, Replicated) and list(clock.copies)
             == list(mesh.distinct) and all(
                 t.device == d for d, t in clock.copies.items()),
             f"{label}: the clock is not one copy a device: {clock!r}")
    lc_check(list(eng._params_on) == list(mesh.distinct) and all(
        p["embed"].device == d for d, p in eng._params_on.items()) and all(
        p is eng._params_on[d] for p, d in zip(eng._tick_params,
                                                mesh.devices)),
        f"{label}: not one params copy a distinct device")


def lc_engine(engine, cfg, params, slots, mesh=None):
    """A new engine, the ones before it collected first: an engine holds
    reference cycles (its pool, its in-flight queue), so only the
    collector frees the params copies it made on the other cards."""
    gc.collect()
    return engine.Engine(cfg, params, batch_slots=slots, max_seq=LC_MAX_SEQ,
                         mesh=mesh)


def lc_requests(engine, eng, cfg, rng, n, prompt, new) -> None:
    for i in range(n):
        eng.submit(engine.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, prompt).astype(
                np.int32), max_new_tokens=new[i % len(new)]))


def lc_baseline(engine, cfg, params, seed, torch, slots):
    """The unsharded engine's checked drive, sync -> (tokens by rid,
    logits by rid: the prefill's, then each tick's row while the request
    is live, as ``tests/test_torch_serve.py`` records the
    reference's)."""
    eng = lc_engine(engine, cfg, params, slots)
    rows: dict = collections.defaultdict(list)
    prefills: list = []
    decode, prefill = eng._decode, eng._prefill_one

    def traced(p, state, toks):
        out, state = decode(p, state, toks)
        host = out[:, -1, :cfg.vocab].float().cpu()
        for slot, req in enumerate(eng.slot_req):
            if req is not None:
                rows[req.rid].append(host[slot])
        return out, state

    def traced_prefill(*args):
        st1, lg = prefill(*args)
        prefills.append(lg[:cfg.vocab].float().cpu())
        return st1, lg

    eng._decode, eng._prefill_one = traced, traced_prefill
    lc_requests(engine, eng, cfg, np.random.default_rng(seed),
                max(LC_REQUESTS, slots), LC_PROMPT, LC_NEW)
    with torch.no_grad():
        done = eng.run_until_drained()
    fills = [e["rid"] for e in eng.obs.events.tail()
             if e["event"] == "lm_slot_fill"]
    return ({r.rid: list(r.out_tokens) for r in done},
            {rid: [first] + rows[rid] for rid, first in zip(fills, prefills)})


def lc_same_requests(label, tokens, base) -> int:
    """Each request's tokens equal the unsharded drive's, or at the first
    that differs the unsharded logits' near tie (``LM_ATOL``); a dense
    model's rows never meet, so the requests are compared one by one ->
    the near ties met."""
    want, logits = base
    lc_check(tokens.keys() == want.keys(), f"{label}: other requests")
    ties = 0
    for rid, w in want.items():
        for j, (a, b) in enumerate(zip(w, tokens[rid])):
            if a != b:
                row = logits[rid][j]
                margin = float(row[a] - row[b])
                lc_check(int(row.argmax()) == a and margin <= LM_ATOL,
                         f"{label}: request {rid} token {j} is {b}, the "
                         f"unsharded engine's {a} by {margin}")
                ties += 1
                break
    return ties


def lc_checked(label, engine, cfg, params, mesh, seed, torch, asyn, mods):
    """The S-shard engine's checked drive: each tick (its dispatch, async,
    under sync debug mode ``"error"``) held to one ``decode_step`` over
    every row concatenated in pool order on ``cuda:0``, the routing held
    to the tick's own at near ties (``RouterPin``); the placement checked
    after every resize and rebalance and at the end; the rebalances'
    moves recorded -> record, (tokens, feeds, rows)."""
    api, moe, ShardRows, Replicated, tree_map = mods
    slots = lc_slots(len(mesh.devices))
    eng = lc_engine(engine, cfg, params, slots, mesh)
    dev0, k = mesh.devices[0], len(mesh.distinct)
    params0, oracle = eng._params_on[dev0], api.decode_fn(cfg)
    decode, sample = eng._decode, eng._sample
    feeds, rows, moves = [], [], []
    st = collections.Counter(worst=0.0, err=0.0)

    def checked(p, state, tokens):
        # the oracle's inputs, before the tick writes the state in place
        whole = engine._unflat(tree_map(
            lambda a, ax: a.on(dev0).clone() if ax < 0
            else torch.cat([x.to(dev0) for x in a.parts], ax),
            engine._flat(state), eng._cache_axes), state)
        toks0 = torch.cat([t.to(dev0) for t in tokens.parts])
        pin = RouterPin(moe, torch)
        with lc_strict(torch, asyn), pin.record(on_device=True):
            logits, state = decode(p, state, tokens)
        with pin.hold(lambda i: pin.calls[i * k]):
            want, _ = oracle(params0, whole, toks0)
        got = torch.cat([lg.to(dev0) for lg in logits.parts])
        got = got[:, -1, :cfg.vocab].float().cpu()
        want = want[:, -1, :cfg.vocab].float().cpu()
        err = float((got - want).abs().max())
        lc_check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=LM_RTOL, atol=LM_ATOL),
            f"{label}: tick {len(rows)} differs from one decode_step over "
            f"the rows by up to {err}")
        top2 = torch.topk(want, 2, dim=-1).values
        for row in torch.nonzero(got.argmax(-1) != want.argmax(-1))[:, 0]:
            margin = float(top2[row, 0] - top2[row, 1])
            lc_check(margin <= LM_ATOL, f"{label}: tick {len(rows)} row "
                     f"{int(row)} token differs, the margin {margin}")
            st["ties"] += 1
        st["held"] += pin.held
        st["worst"] = max(st["worst"], pin.worst)
        st["err"] = max(st["err"], err)
        feeds.append(toks0.cpu().ravel().tolist())
        rows.append(got)
        return logits, state

    def strict_sample(logits):
        with lc_strict(torch, asyn):
            return sample(logits)

    install = eng.set_device_state

    def set_device_state(state):
        install(state)
        lc_placement(f"{label} remap", eng, ShardRows, Replicated, tree_map)
        st["remaps"] += 1

    plan = eng._slots.placement.rebalance

    def rebalance():
        out = plan()
        sc = eng._slots.placement.shard_capacity
        moves.extend((src // sc, dst // sc) for dst, src in out[0])
        return out

    eng._decode, eng._sample = checked, strict_sample
    eng.set_device_state = set_device_state
    eng._slots.placement.rebalance = rebalance
    lc_requests(engine, eng, cfg, np.random.default_rng(seed),
                max(LC_REQUESTS, slots), LC_PROMPT, LC_NEW)
    with torch.no_grad():
        done = (eng.run_until_drained_async() if asyn
                else eng.run_until_drained())
    lc_placement(f"{label} end", eng, ShardRows, Replicated, tree_map)
    tokens = {r.rid: list(r.out_tokens) for r in done}
    lc_check(sorted(tokens) == list(range(max(LC_REQUESTS, slots))) and all(
        0 <= t < cfg.vocab for v in tokens.values() for t in v),
        f"{label}: a request went unserved or got a token outside the "
        "vocab")
    across = sum(mesh.devices[a] != mesh.devices[b] for a, b in moves)
    lc_check(moves, f"{label}: no rebalance moved a live request")
    return dict(label=label, ticks=len(rows), slots=slots,
                near_ties=st["ties"], router_rows_held=st["held"],
                router_prob_max_abs_err=st["worst"],
                oracle_max_abs_err=st["err"], remaps=st["remaps"],
                moves=moves, moves_across_cards=across,
                clock=int(eng.state["cache_len"])), (tokens, feeds, rows)


def lc_timed(engine, cfg, params, mesh, seed, torch, asyn):
    """One request a slot (``LC_TIMED_PROMPT`` + ``LC_TIMED_NEW`` tokens)
    -> (tick p50 ms, tokens/s)."""
    slots = lc_slots(len(mesh.devices))
    eng = lc_engine(engine, cfg, params, slots, mesh)
    lc_requests(engine, eng, cfg, np.random.default_rng(seed + 1), slots,
                LC_TIMED_PROMPT, (LC_TIMED_NEW,))
    with torch.no_grad():
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        (eng.run_until_drained_async() if asyn else eng.run_until_drained())
        wall = time.perf_counter() - t0
    tick = eng.obs.registry.histogram("serve.decode_tick_s").quantile(0.5)
    return tick * 1e3, slots * LC_TIMED_NEW / wall


def lc_profile(engine, cfg, params, mesh, seed, torch):
    """``LC_PROFILED`` sync ticks at every slot live under
    ``torch.profiler`` (the devices' activity) -> (busy ms a tick summed
    over the devices, kernels a tick, the copies a tick by kind)."""
    slots = lc_slots(len(mesh.devices))
    eng = lc_engine(engine, cfg, params, slots, mesh)
    lc_requests(engine, eng, cfg, np.random.default_rng(seed + 2), slots, 2,
                (LC_PROFILED + 3,))
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        eng.step()
        eng.step()
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(LC_PROFILED):
                eng.step()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in evs) / 1e3 / LC_PROFILED
    kernels = sum(e.count for e in evs) / LC_PROFILED
    copies = {e.key: e.count / LC_PROFILED for e in evs
              if "memcpy" in e.key.lower()}
    return busy, kernels, copies


def lm_cards_phase(seed, torch, dispatch, card):
    """Phase 13b: ``Engine(mesh=)`` over every card (``lc_meshes``), or
    over shards of ``cuda:0`` with one: Qwen3-0.6B and DeepSeek-MoE-16B
    whole, from generators seeded ``seed``.  Each S's checked drives
    (``lc_checked``), sync and async, held tick by tick to one
    ``decode_step`` over the rows on ``cuda:0``; Qwen3's also to its
    unsharded sync drive at the same slots (``lc_same_requests``).
    Printed with the card: the tick p50 sync and async, tokens/s, the
    copies between devices a tick, the devices' busy ms and idle share
    of profiled ticks and each card's peak allocation.  Returns the
    record."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Replicated, ShardRows, make_stream_mesh
    from repro_torch.models import api, moe, stack
    from repro_torch.runtime.pool import tree_map
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    cards, shards = lc_meshes(torch)
    phase("lm_cards", f"{n} card(s) visible ({'; '.join(card_lines())}); "
          f"the engine spans {cards} card(s): " + "; ".join(
              f"{a} at S = {', '.join(map(str, s))}"
              for a, s in shards.items())
          + ("" if cards > 1 else " shards of cuda:0 (one card: the "
             "per-shard code without the copies between cards)"))
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    dispatch.reset()
    dev = torch.device("cuda", 0)
    mods = (api, moe, ShardRows, Replicated, tree_map)
    rec = {"cards": cards, "visible": n, "runs": []}
    for arch, counts in shards.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        params = api.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        n_moe = stack.n_repeats(cfg) * sum(
            1 for _, f in stack.block_structure(cfg) if f == "moe")
        base = {}
        for S in counts:
            mesh = (make_stream_mesh(S, cards=cards) if cards > 1
                    else make_stream_mesh(S, device="cuda:0"))
            slots = lc_slots(S)
            r = dict(arch=arch, shards=S, cards=cards, slots=slots,
                     devices=[str(d) for d in mesh.devices])
            for mode, asyn in (("sync", False), ("async", True)):
                label = f"{arch} S={S} {mode} over {cards} card(s)"
                r[mode], got = lc_checked(label, engine, cfg, params, mesh,
                                          seed, torch, asyn, mods)
                if arch == LM_ARCH:
                    # a dense model's rows never meet: either mode's
                    # tokens are the unsharded sync drive's
                    if slots not in base:
                        base[slots] = lc_baseline(engine, cfg, params, seed,
                                                  torch, slots)
                    r[mode]["ties_vs_one_shard"] = lc_same_requests(
                        label, got[0], base[slots])
                if cards > 1 and S == cards:
                    lc_check(r[mode]["moves_across_cards"] > 0,
                             f"{label}: no rebalance moved rows between "
                             "cards")
                tick, tok_s = lc_timed(engine, cfg, params, mesh, seed,
                                       torch, asyn)
                r[mode].update(tick_ms_p50=tick, tokens_per_s=tok_s)
            busy, kernels, copies = lc_profile(engine, cfg, params, mesh,
                                               seed, torch)
            per_dev = collections.Counter(mesh.devices)
            r.update(device_busy_ms_per_tick=busy, kernels_per_tick=kernels,
                     idle_share=1 - busy / (r["sync"]["tick_ms_p50"]
                                            * len(mesh.distinct))
                     if busy else None,
                     profiled_copies_per_tick=copies,
                     gathers_per_tick=n_moe * sum(
                         S - per_dev[d] for d in mesh.distinct))
            rec["runs"].append(r)
            idle = r["idle_share"]
            phase("lm_cards", f"{arch} S={S} over {cards} card(s), {slots} "
                  f"slots: every tick == one decode_step over the rows on "
                  f"cuda:0 (max |dlogit| sync "
                  f"{r['sync']['oracle_max_abs_err']:.4f}, async "
                  f"{r['async']['oracle_max_abs_err']:.4f}; near ties "
                  f"{r['sync']['near_ties']} / {r['async']['near_ties']}; "
                  f"router rows held {r['sync']['router_rows_held']} / "
                  f"{r['async']['router_rows_held']})"
                  + (f"; tokens == the unsharded engine's ("
                     f"{r['sync'].get('ties_vs_one_shard')} / "
                     f"{r['async'].get('ties_vs_one_shard')} near ties)"
                     if arch == LM_ARCH else "")
                  + f"; rebalance moves {r['sync']['moves']} "
                  f"({r['sync']['moves_across_cards']} across cards), "
                  f"placement held at {r['sync']['remaps']} remaps; tick "
                  f"p50 {r['sync']['tick_ms_p50']:.3f} ms sync, "
                  f"{r['async']['tick_ms_p50']:.3f} ms async; tokens/s "
                  f"{r['sync']['tokens_per_s']:.1f} sync, "
                  f"{r['async']['tokens_per_s']:.1f} async; "
                  f"{r['gathers_per_tick']} copies between devices a tick "
                  f"(MoE gathers; profiler: {copies}); profiler over "
                  f"{LC_PROFILED} sync ticks: devices busy {busy:.3f} ms "
                  f"and {kernels:.0f} kernels a tick, "
                  + (f"idle {idle:.3f} of the sync p50 tick x "
                     f"{len(mesh.distinct)} device(s)" if idle is not None
                     else "idle not measured: no device time in the trace")
                  + f"; {card}")
        del params, base
        gc.collect()
        torch.cuda.empty_cache()
        rec[f"{arch}_s"] = time.perf_counter() - t_arch
    lc_check(not reference_launches(dispatch), f"the LM path launched a "
             f"reference kernel: {reference_launches(dispatch)}")
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
    rec.update(peak_allocated_bytes=peaks, card=card,
               phase_s=time.perf_counter() - t_phase)
    phase("lm_cards", "no reference kernel launched; peak allocated "
          + ", ".join(f"cuda:{i} {b / 1e9:.3f} GB" for i, b in
                      enumerate(peaks))
          + f"; phase took {rec['phase_s']:.1f} s; {card}")
    return rec


# ---------------------------------------------------------------------------
# Phase 14: LM training
# ---------------------------------------------------------------------------

LT_ARCH = LM_ARCH
#: the training drive: AdamW steps at batch x seq tokens (remat ``block``),
#: the last ``LT_PROFILED`` under ``torch.profiler``
LT_STEPS, LT_BATCH, LT_SEQ, LT_PROFILED = 20, 8, 256, 3
#: AdamW's learning rate in every drive of the phase
LT_LR = 1e-3
#: steps timed per remat mode, at the drive's shape
LT_REMAT_STEPS = 3
#: one batch for card vs CPU, the remat modes and the precision check
LT_CHECK_BATCH, LT_CHECK_SEQ = 2, 32
LT_TERNARY_STEPS = 5
#: DeepSeek-MoE-16B cut to the dense layer and 1 MoE layer (full width):
#: card vs CPU on pinned routing, then a few steps at batch x seq
LT_MOE_LAYERS, LT_MOE_STEPS, LT_MOE_BATCH, LT_MOE_SEQ = 2, 3, 4, 128
#: ROADMAP C.7: xLSTM-350M trained whole for this much card time
LT_XLSTM_S, LT_XLSTM_BATCH, LT_XLSTM_SEQ = 40.0, 8, 64
#: card vs CPU: the loss within ``LT_LOSS_RTOL``, every gradient leaf
#: within ``LT_GRAD_REL_L2`` in relative L2 error (the bf16 products
#: accumulate in another order on each side; the CPU tests hold the port
#: to the reference at 1e-4 / 2e-2 on the smoke configs)
LT_LOSS_RTOL, LT_GRAD_REL_L2 = 1e-3, 5e-2
#: the card against itself (remat modes, a global "high" precision):
#: bit-equal unless an atomic accumulation reorders a sum
LT_SAME_RTOL, LT_SAME_REL_L2 = 1e-6, 1e-4


def lt_check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"lm_train: {msg}")


def lt_fell(losses) -> bool:
    """Finite losses whose last quarter's mean is below the first
    quarter's (a batch's loss is noisy)."""
    k = max(1, len(losses) // 4)
    return bool(np.isfinite(losses).all()) and float(
        np.mean(losses[-k:])) < float(np.mean(losses[:k]))


def lt_compare(label, got, want, torch, loss_rtol, rel_l2):
    """(loss, grads) against (loss, grads), leaf by leaf on the host ->
    (relative loss error, worst leaf's relative L2 error, bit-equal)."""
    from repro_torch.utils.tree import tree_leaves

    (gl, gg), (wl, wg) = got, want
    gl, wl = float(gl), float(wl)
    loss_err = abs(gl - wl) / max(abs(wl), 1e-30)
    lt_check(np.isfinite(gl) and loss_err <= loss_rtol,
             f"{label}: loss {gl} vs {wl} (relative {loss_err:.3g})")
    worst, equal = 0.0, gl == wl
    ga, wa = tree_leaves(gg), tree_leaves(wg)
    lt_check(len(ga) == len(wa), f"{label}: leaf counts differ")
    for i, (a, b) in enumerate(zip(ga, wa)):
        a = a.detach().to("cpu", torch.float64)
        b = b.detach().to("cpu", torch.float64)
        lt_check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                 f"{label}: gradient leaf {i} {tuple(a.shape)}")
        err = float((a - b).norm() / b.norm().clamp(min=1e-30))
        lt_check(err <= rel_l2, f"{label}: gradient leaf {i} "
                 f"{tuple(a.shape)} relative L2 error {err:.3g}")
        worst = max(worst, err)
        equal = equal and torch.equal(a, b)
    return loss_err, worst, equal


def lt_pinned(cfg, params, batch, dev, torch):
    """The loss and gradients on the CPU (params copied there) and on the
    card, the card's MoE routing held to the CPU's (``RouterPin``) ->
    (card result, CPU result, rows held, router probability error)."""
    from repro_torch.data import lm_data
    from repro_torch.models import api, moe
    from repro_torch.train import loop
    from repro_torch.utils.tree import tree_map

    fn = api.loss_fn(cfg, "none")
    pin = RouterPin(moe, torch)
    cpu = tree_map(lambda t: t.detach().cpu(), params)
    with pin.record():
        want = loop.value_and_grad(fn, cpu, lm_data.to_device(batch, "cpu"))
    del cpu
    with pin.hold(lambda i: pin.calls[i]):
        got = loop.value_and_grad(fn, params, lm_data.to_device(batch, dev))
    return got, want, pin.held, pin.worst


def lt_steps(trainer, n, torch):
    """``n`` steps -> (history, median step ms, peak allocated bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.run(n)
    ms = [h["step_time_s"] * 1e3 for h in hist]
    return hist, float(np.median(ms)), torch.cuda.max_memory_allocated()


def lt_device(fn, n, torch):
    """``n`` calls of ``fn`` under ``torch.profiler`` (device activity
    alone) -> ([results], device busy ms a call, kernels a call, [(kernel,
    ms, count) a call] by device time)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = [fn() for _ in range(n)]
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3 / n,
                         e.count / n) for e in prof.key_averages()
                        if e.device_type == cuda), key=lambda r: -r[1])
    return (out, sum(ms for _, ms, _ in by_kernel),
            sum(c for _, _, c in by_kernel), by_kernel)


def lt_qwen(seed, dev, torch, card):
    """Qwen3-0.6B at its published width and depth: checks at one batch,
    the training drive, the remat modes' cost, a checkpoint round trip
    and a ternary run."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_data
    from repro_torch.models import api, layers
    from repro_torch.train import checkpoint, loop, optimizer
    from repro_torch.utils.tree import (
        tree_count_params,
        tree_leaves,
        tree_size_bytes,
    )

    t_start = time.perf_counter()
    split = {}

    def lap(part, t0):
        split[part] = time.perf_counter() - t0
        return time.perf_counter()

    cfg = get_arch(LT_ARCH)
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    n_params = tree_count_params(params)
    chk = lm_data.batch_at(lm_data.DataConfig(
        vocab=cfg.vocab, seq_len=LT_CHECK_SEQ, global_batch=LT_CHECK_BATCH,
        seed=seed), 0)
    chk_dev = lm_data.to_device(chk, dev)
    t0 = lap("init", t_start)

    # card against CPU, remat none
    got, want, _, _ = lt_pinned(cfg, params, chk, dev, torch)
    cpu_loss_err, cpu_grad_err, _ = lt_compare(
        "card vs CPU", got, want, torch, LT_LOSS_RTOL, LT_GRAD_REL_L2)
    del want
    t0 = lap("card vs CPU", t0)

    # the remat modes against each other, and a global "high" precision
    runs = {"none": got}
    for mode in ("block", "dots"):
        runs[mode] = loop.value_and_grad(api.loss_fn(cfg, mode), params,
                                         chk_dev)
    remat = {m: lt_compare(f"remat {m} vs none", runs[m], runs["none"],
                           torch, LT_SAME_RTOL, LT_SAME_REL_L2)
             for m in ("block", "dots")}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        high = loop.value_and_grad(api.loss_fn(cfg, "block"), params,
                                   chk_dev)
        # what TF32 does to the float32 head product outside the scope
        h = torch.randn(LT_CHECK_BATCH * LT_CHECK_SEQ, cfg.d_model,
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(seed))
        w = params["embed"].float().T
        tf32 = h @ w
        with layers.lm_precision():
            full = h @ w
        tf32_moves = float((tf32 - full).abs().max())
    finally:
        torch.set_float32_matmul_precision(prev)
    lt_check(torch.get_float32_matmul_precision() == prev,
             "the process's precision was not restored")
    high_cmp = lt_compare('global "high" vs "highest"', high, runs["block"],
                          torch, LT_SAME_RTOL, LT_SAME_REL_L2)
    del runs, high, got, h, w, tf32, full
    t0 = lap("remat and precision", t0)

    # the training drive on batches staged on the card
    dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=LT_SEQ,
                              global_batch=LT_BATCH, seed=seed)
    batches = [lm_data.to_device(lm_data.batch_at(dcfg, i), dev)
               for i in range(LT_STEPS)]
    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(lr=LT_LR), remat="block",
                            warmup_steps=2, total_steps=LT_STEPS)
    trainer = loop.Trainer(cfg, tcfg, api.loss_fn(cfg, tcfg.remat), params,
                           iter(batches))
    del params
    hist, _, peak = lt_steps(trainer, LT_STEPS - LT_PROFILED, torch)
    prof_hist, busy_ms, kernels, by_kernel = lt_device(
        lambda: trainer.run(1)[0], LT_PROFILED, torch)
    losses = [h["loss"] for h in hist + prof_hist]
    step_ms = [h["step_time_s"] * 1e3 for h in hist]
    med = float(np.median(step_ms[1:]))
    lt_check(lt_fell(losses), f"the loss did not fall: {losses}")
    idle = 1 - busy_ms / med if busy_ms else None
    # the step's device time by part: the loss and its gradients, and the
    # optimizer's update (its new state dropped)
    fn, st = api.loss_fn(cfg, tcfg.remat), trainer.state
    (vg,), vg_ms, vg_kernels, vg_top = lt_device(
        lambda: loop.value_and_grad(fn, st["params"], batches[0]), 1, torch)
    _, upd_ms, upd_kernels, _ = lt_device(
        lambda: optimizer.update(tcfg.opt, st["opt"], vg[1], 1.0)[1], 1,
        torch)
    del vg, st
    t0 = lap("train", t0)

    # a checkpoint of the trained state, on the card, bit for bit
    state_bytes = tree_size_bytes(trainer.state)
    with tempfile.TemporaryDirectory() as d:
        tc = time.perf_counter()
        checkpoint.save(d, trainer.step_idx, trainer.state)
        save_s = time.perf_counter() - tc
        step, back, _ = checkpoint.restore(d, trainer.state)
        restore_s = time.perf_counter() - tc - save_s
    leaves, got_leaves = tree_leaves(trainer.state), tree_leaves(back)
    lt_check(step == LT_STEPS and len(got_leaves) == len(leaves) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(leaves, got_leaves)),
        "the checkpoint did not round-trip")
    del back, got_leaves, leaves
    trained = trainer.state["params"]
    del trainer
    torch.cuda.empty_cache()
    t0 = lap("checkpoint", t0)

    # each remat mode's step and peak allocation at the drive's shape
    remat_cost = {}
    for mode in ("none", "block", "dots"):
        tr = loop.Trainer(cfg, dataclasses.replace(tcfg, remat=mode),
                          api.loss_fn(cfg, mode), trained, iter(batches))
        _, ms, pk = lt_steps(tr, LT_REMAT_STEPS, torch)
        remat_cost[mode] = dict(step_ms_median=ms, peak_allocated_bytes=pk)
        del tr
        torch.cuda.empty_cache()
    del trained
    t0 = lap("remat cost", t0)

    # the ternary quant mode from fresh weights
    tcfg_t = dataclasses.replace(get_arch(LT_ARCH), quant_mode="ternary")
    params = api.init_params(
        tcfg_t, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    t_fn = api.loss_fn(tcfg_t, "block")
    with torch.no_grad():
        t_before = float(t_fn(params, batches[0]))
    tr = loop.Trainer(tcfg_t, dataclasses.replace(
        tcfg, total_steps=LT_TERNARY_STEPS), t_fn, params, iter(batches))
    del params
    t_losses = [h["loss"] for h in tr.run(LT_TERNARY_STEPS)]
    with torch.no_grad():
        t_after = float(t_fn(tr.state["params"], batches[0]))
    # the first batch's loss before and after the steps (one batch's loss
    # against the next is noisier than 5 steps move it)
    lt_check(bool(np.isfinite(t_losses).all()) and t_after < t_before,
             f"the ternary loss did not fall: {t_before} -> {t_after} "
             f"(steps {t_losses})")
    del tr, batches
    torch.cuda.empty_cache()
    lap("ternary", t0)

    tokens = LT_BATCH * LT_SEQ
    phase("lm_train", f"{cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}; {n_params} params; batch "
          f"{LT_CHECK_BATCH} x {LT_CHECK_SEQ}, card vs CPU (remat none): "
          f"loss relative error {cpu_loss_err:.2e} (bound {LT_LOSS_RTOL}), "
          f"worst gradient leaf relative L2 {cpu_grad_err:.2e} (bound "
          f"{LT_GRAD_REL_L2}); remat block / dots vs none on the card: "
          + ", ".join(f"{m} loss {e[0]:.1e} gradients {e[1]:.1e}"
                      f"{' (bit-equal)' if e[2] else ''}"
                      for m, e in remat.items())
          + f'; under a global "high" precision: loss {high_cmp[0]:.1e} '
          f"gradients {high_cmp[1]:.1e}"
          f"{' (bit-equal)' if high_cmp[2] else ''} (bound "
          f"{LT_SAME_REL_L2}), where TF32 moves the float32 head product "
          f"outside the loss by up to {tf32_moves:.3g}; {card}")
    phase("lm_train", f"{cfg.name}: {LT_STEPS} AdamW steps (lr {LT_LR}, "
          f"remat block) at batch {LT_BATCH} x {LT_SEQ} through Trainer on "
          f"staged lm_data batches: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step ms (synchronised, data excluded) median "
          f"{med:.3f}, min {min(step_ms[1:]):.3f}, max "
          f"{max(step_ms[1:]):.3f} (first {step_ms[0]:.3f}), "
          f"{tokens / med * 1e3:.0f} tokens/s; peak allocated "
          f"{peak / 1e9:.3f} GB; profiler over {LT_PROFILED} steps: device "
          f"busy {busy_ms:.3f} ms and {kernels:.0f} kernels a step, "
          + (f"idle {idle:.3f} of the median step" if idle is not None
             else "idle not measured: no device time in the trace")
          + "; top: " + ", ".join(f"{k[:40]} {ms:.3f}"
                                  for k, ms, _ in by_kernel[:5])
          + f"; alone: the loss and its gradients {vg_ms:.3f} ms over "
          f"{vg_kernels:.0f} kernels, the AdamW update {upd_ms:.3f} ms over "
          f"{upd_kernels:.0f}; {card}")
    phase("lm_train", f"{cfg.name}: per remat mode at {LT_BATCH} x "
          f"{LT_SEQ}, median of {LT_REMAT_STEPS} steps and peak allocated: "
          + ", ".join(f"{m} {v['step_ms_median']:.3f} ms "
                      f"{v['peak_allocated_bytes'] / 1e9:.3f} GB"
                      for m, v in remat_cost.items())
          + f"; checkpoint of the trained state ({state_bytes / 1e9:.3f} GB"
          f", zlib level {checkpoint.ZLIB_LEVEL}) saved in {save_s:.1f} s, "
          f"restored on the card "
          f"bit for bit in {restore_s:.1f} s; ternary {LT_TERNARY_STEPS} "
          f"steps: loss {t_losses[0]:.4f} -> {t_losses[-1]:.4f}, on the "
          f"first batch {t_before:.4f} -> {t_after:.4f}; {card}")
    return dict(arch=cfg.name, params=n_params,
                card_vs_cpu_loss_rel_err=cpu_loss_err,
                card_vs_cpu_grad_rel_l2=cpu_grad_err,
                remat_vs_none={m: dict(loss_rel_err=e[0], grad_rel_l2=e[1],
                                       bit_equal=e[2])
                               for m, e in remat.items()},
                high_precision=dict(loss_rel_err=high_cmp[0],
                                    grad_rel_l2=high_cmp[1],
                                    bit_equal=high_cmp[2],
                                    tf32_head_max_abs_diff=tf32_moves),
                steps=LT_STEPS, batch=LT_BATCH, seq=LT_SEQ, losses=losses,
                step_ms=step_ms, step_ms_median=med,
                tokens_per_s=tokens / med * 1e3, peak_allocated_bytes=peak,
                profiled_steps=LT_PROFILED, device_busy_ms_per_step=busy_ms,
                kernels_per_step=kernels, idle_share=idle,
                device_by_kernel=by_kernel[:30],
                loss_grad_device_ms=vg_ms, loss_grad_kernels=vg_kernels,
                loss_grad_by_kernel=vg_top[:30], update_device_ms=upd_ms,
                update_kernels=upd_kernels, remat_cost=remat_cost,
                state_bytes=state_bytes, checkpoint_save_s=save_s,
                checkpoint_restore_s=restore_s, ternary_losses=t_losses,
                ternary_first_batch_loss=(t_before, t_after),
                split_s=split, total_s=time.perf_counter() - t_start)


def lt_moe(seed, dev, torch, card):
    """DeepSeek-MoE-16B at full width, cut to the dense layer and 1 MoE
    layer: card vs CPU on pinned routing, then a few steps."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_data
    from repro_torch.models import api
    from repro_torch.train import loop, optimizer
    from repro_torch.utils.tree import tree_count_params

    cfg = dataclasses.replace(get_arch(LMF_MOE), n_layers=LT_MOE_LAYERS)
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    n_params = tree_count_params(params)
    chk = lm_data.batch_at(lm_data.DataConfig(
        vocab=cfg.vocab, seq_len=LT_CHECK_SEQ, global_batch=LT_CHECK_BATCH,
        seed=seed), 0)
    got, want, held, worst = lt_pinned(cfg, params, chk, dev, torch)
    loss_err, grad_err, _ = lt_compare(f"{cfg.name} card vs CPU", got, want,
                                       torch, LT_LOSS_RTOL, LT_GRAD_REL_L2)
    del got, want
    dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=LT_MOE_SEQ,
                              global_batch=LT_MOE_BATCH, seed=seed)
    batches = [lm_data.to_device(lm_data.batch_at(dcfg, i), dev)
               for i in range(LT_MOE_STEPS)]
    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(lr=LT_LR), remat="block",
                            warmup_steps=1, total_steps=LT_MOE_STEPS)
    tr = loop.Trainer(cfg, tcfg, api.loss_fn(cfg, "block"), params,
                      iter(batches))
    del params
    hist, ms, peak = lt_steps(tr, LT_MOE_STEPS, torch)
    losses = [h["loss"] for h in hist]
    lt_check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    del tr, batches
    torch.cuda.empty_cache()
    phase("lm_train", f"{cfg.name} cut to {LT_MOE_LAYERS} layers (the dense"
          f" one and 1 MoE of {cfg.moe.n_experts} experts, full width; "
          f"{n_params} params): card vs CPU at {LT_CHECK_BATCH} x "
          f"{LT_CHECK_SEQ} on pinned routing ({held} rows held, router "
          f"probabilities within {worst:.2e}): loss {loss_err:.2e}, worst "
          f"gradient leaf {grad_err:.2e}; {LT_MOE_STEPS} AdamW steps at "
          f"{LT_MOE_BATCH} x {LT_MOE_SEQ} (remat block, dropping dispatch): "
          f"loss " + " -> ".join(f"{x:.4f}" for x in losses)
          + f", step median {ms:.3f} ms, peak {peak / 1e9:.3f} GB; {card}")
    return dict(arch=cfg.name, layers=LT_MOE_LAYERS, params=n_params,
                router_rows_held=held, router_prob_max_abs_err=worst,
                card_vs_cpu_loss_rel_err=loss_err,
                card_vs_cpu_grad_rel_l2=grad_err, losses=losses,
                step_ms_median=ms, peak_allocated_bytes=peak)


def lt_families(seed, dev, torch, card):
    """Every smoke config: one loss and gradient on the card against the
    CPU (the same params, MoE routing pinned)."""
    from repro_torch.configs import arch_names, get_arch
    from repro_torch.data import lm_data
    from repro_torch.models import api

    rec = {}
    for name in arch_names():
        cfg = get_arch(name, smoke=True)
        params = api.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        front = cfg.n_frontend_tokens or (
            LT_CHECK_SEQ if cfg.family == "encdec" else 0)
        batch = lm_data.batch_at(lm_data.DataConfig(
            vocab=cfg.vocab, seq_len=LT_CHECK_SEQ,
            global_batch=LT_CHECK_BATCH, seed=seed, frontend_tokens=front,
            frontend_dim=cfg.d_model), 0)
        got, want, held, _ = lt_pinned(cfg, params, batch, dev, torch)
        loss_err, grad_err, _ = lt_compare(f"{name} (smoke) card vs CPU",
                                           got, want, torch, LT_LOSS_RTOL,
                                           LT_GRAD_REL_L2)
        rec[name] = dict(family=cfg.family, loss_rel_err=loss_err,
                         grad_rel_l2=grad_err, router_rows_held=held)
    phase("lm_train", "smoke configs, loss and gradients card vs CPU at "
          f"{LT_CHECK_BATCH} x {LT_CHECK_SEQ} (loss relative / worst leaf "
          "relative L2): " + ", ".join(
              f"{n} ({r['family']}) {r['loss_rel_err']:.1e} / "
              f"{r['grad_rel_l2']:.1e}" for n, r in rec.items())
          + f"; {card}")
    return rec


def lt_free_running(cfg, params, toks, dev, torch, seed):
    """The xLSTM checks of phase ``lm_families`` on given weights, not
    held: card vs CPU prefill logits, decode steps vs forward on the
    card, and the card's logits under embeddings x (1 + 0.01 N(0,1)) ->
    their max |dlogit|."""
    from repro_torch.models import api, stack
    from repro_torch.utils.tree import tree_map

    prefill = api.prefill_fn(cfg)
    with torch.no_grad():
        want, _ = prefill(tree_map(lambda t: t.cpu(), params),
                          {"tokens": toks})
        got, _ = prefill(params, {"tokens": toks.to(dev)})
        noisy = dict(params, embed=(params["embed"].float() * (
            1 + 0.01 * torch.randn(params["embed"].shape, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(seed)))).to(
            torch.bfloat16))
        moved, _ = prefill(noisy, {"tokens": toks.to(dev)})
        dtoks = toks[:1, :LMF_DECODE].to(dev)
        full, _ = stack.forward(cfg, params, dtoks, mode="train")
        state = api.init_decode_state(cfg, 1, 2 * LMF_DECODE, device=dev)
        dec = api.decode_fn(cfg)
        for t in range(LMF_DECODE):
            logits, state = dec(params, state, dtoks[:, t:t + 1])
    return dict(
        prefill_card_vs_cpu=float((got.cpu() - want).abs().max()),
        decode_vs_forward=float((logits[0, -1] - full[0, -1]).abs().max()),
        noise_response=float((moved - got).abs().max()),
        logit_scale=float(want.abs().max()))


def lt_xlstm(seed, dev, torch, card, random_rec):
    """ROADMAP C.7: xLSTM-350M trained whole on ``lm_data`` for
    ``LT_XLSTM_S`` seconds of the card, then the free-running checks of
    phase ``lm_families`` on the trained weights, beside the random
    weights'."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_data
    from repro_torch.models import api
    from repro_torch.train import loop, optimizer

    cfg = get_arch("xlstm-350m")
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    rng = np.random.default_rng(seed + 60)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab, (LMF_PROMPTS, LMF_PROMPT_LEN)).astype(np.int32))
    before = lt_free_running(cfg, params, toks, dev, torch, seed)
    dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=LT_XLSTM_SEQ,
                              global_batch=LT_XLSTM_BATCH, seed=seed)
    data = (lm_data.to_device(b, dev) for b in lm_data.iterator(dcfg))
    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(lr=LT_LR), remat="block",
                            warmup_steps=2, total_steps=10_000)
    tr = loop.Trainer(cfg, tcfg, api.loss_fn(cfg, "block"), params, data)
    del params
    t0 = time.perf_counter()
    hist = []
    while time.perf_counter() - t0 < LT_XLSTM_S:
        hist += tr.run(1)
    train_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    lt_check(bool(np.isfinite(losses).all()), f"xlstm-350m: losses {losses}")
    fell = lt_fell(losses)
    after = lt_free_running(cfg, tr.state["params"], toks, dev, torch, seed)
    del tr
    torch.cuda.empty_cache()
    phase("lm_train", f"xlstm-350m (ROADMAP C.7): {len(hist)} AdamW steps "
          f"at {LT_XLSTM_BATCH} x {LT_XLSTM_SEQ} in {train_s:.1f} s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} ("
          + ("fell" if fell else "did not fall") + "); free-running max "
          f"|dlogit| "
          f"over {LMF_PROMPTS} x {LMF_PROMPT_LEN} tokens, random -> trained "
          f"weights (this phase's init): card vs CPU prefill "
          f"{before['prefill_card_vs_cpu']:.4f} -> "
          f"{after['prefill_card_vs_cpu']:.4f}, {LMF_DECODE} decode steps "
          f"vs forward {before['decode_vs_forward']:.4f} -> "
          f"{after['decode_vs_forward']:.4f}, the embeddings x (1 + 0.01 "
          f"N(0,1)) {before['noise_response']:.4f} -> "
          f"{after['noise_response']:.4f} (max |logit| "
          f"{before['logit_scale']:.2f} -> {after['logit_scale']:.2f}); "
          f"phase lm_families' random weights: "
          f"{random_rec.get('prefill_free_running_max_abs_err', 'n/a')} / "
          f"{random_rec.get('decode_free_running_max_abs_err', 'n/a')} / "
          f"{random_rec.get('noise_response_max_abs_dlogit', 'n/a')}; a "
          f"finding, not held; {card}")
    return dict(steps=len(hist), train_s=train_s, losses=losses,
                loss_fell=fell, random=before, trained=after)


def lm_train_phase(seed, dev, torch, dispatch, card, lmf_rec):
    """Phase 14: LM training on the card.  Returns the record."""
    t0 = time.perf_counter()
    split = {}
    dispatch.reset()
    rec = {}
    for key, run in (
            ("qwen3", lambda: lt_qwen(seed, dev, torch, card)),
            ("deepseek_moe_cut", lambda: lt_moe(seed, dev, torch, card)),
            ("smoke", lambda: lt_families(seed, dev, torch, card)),
            ("xlstm", lambda: lt_xlstm(seed, dev, torch, card,
                                       lmf_rec.get("xlstm", {})))):
        t = time.perf_counter()
        rec[key] = run()
        torch.cuda.empty_cache()
        split[key] = time.perf_counter() - t
    lt_check(not dispatch.counts(), f"LM training launched a reference "
             f"kernel: {dispatch.counts()}")
    phase_s = time.perf_counter() - t0
    phase("lm_train", "no reference kernel launched; phase took "
          f"{phase_s:.1f} s (" + ", ".join(f"{k} {v:.1f}"
                                          for k, v in split.items())
          + f"); {card}")
    rec.update(phase_s=phase_s, phase_split_s=split, card=card)
    return rec


# ---------------------------------------------------------------------------
# Phase 15: the launch tools
# ---------------------------------------------------------------------------

# the dry run's cells over the fake 16x16 world
DR_CELLS = (("qwen3-0.6b", "train_4k"), ("deepseek-moe-16b", "decode_32k"))
# the anchor's predicted peak against the real step's, relative
DR_ANCHOR_TOL = 0.25


def dr_check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {msg}")


def dr_anchor(seed, dev, torch, card):
    """The dry run of ``LT_ARCH`` on a 1x1 mesh at phase ``lm_train``'s
    step against that step on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import lm_data
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.models import api
    from repro_torch.train import loop, optimizer

    t0 = time.perf_counter()
    shape = ShapeConfig("anchor", "train", LT_SEQ, LT_BATCH)
    cell = dryrun.run_cell(LT_ARCH, "anchor", False, device="cuda",
                           mesh_name="1x1", shape=shape, remat="block",
                           optimizer="adamw", microbatches=1)
    dr_check(cell["status"] == "ok", f"anchor cell: {cell.get('error')}")
    dry_s = time.perf_counter() - t0

    cfg = get_arch(LT_ARCH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = api.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    tcfg = loop.TrainConfig(opt=optimizer.OptConfig(name="adamw"),
                            remat="block")
    step = loop.make_train_step(cfg, tcfg, api.loss_fn(cfg, tcfg.remat))
    state = loop.init_train_state(tcfg, params)
    del params
    batch = lm_data.to_device(lm_data.batch_at(lm_data.DataConfig(
        vocab=cfg.vocab, seq_len=LT_SEQ, global_batch=LT_BATCH, seed=seed),
        0), dev)
    state = step(state, batch)[0]          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    new, metrics = step(state, batch)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end)
    measured = torch.cuda.max_memory_allocated() - base
    dr_check(bool(np.isfinite(float(metrics["loss"]))), "the step's loss")
    del new, state, batch, metrics
    torch.cuda.empty_cache()

    predicted = cell["mem"]["peak_gb"] * 1e9
    rel = predicted / measured - 1
    flops = cell["roofline"]["flops_per_dev"]
    six_nd = rl.model_flops_train(api.active_param_count(cfg),
                                  LT_BATCH * LT_SEQ)
    share = flops / (step_ms / 1e3) / rl.PEAK_FLOPS
    phase("dryrun", f"anchor {LT_ARCH} at {LT_BATCH} x {LT_SEQ} (remat "
          f"block, AdamW), dry run on a 1x1 mesh ({dry_s:.1f} s): "
          f"predicted peak {predicted / 1e9:.3f} GB (args "
          f"{cell['mem']['args_gb']:.3f}, temp {cell['mem']['temp_gb']:.3f})"
          f", measured max_memory_allocated of the real step above its "
          f"baseline {measured / 1e9:.3f} GB: {rel:+.1%} (bound "
          f"{DR_ANCHOR_TOL:.0%}); predicted FLOPs {flops:.4g} beside 6 N D "
          f"{six_nd:.4g} ({flops / six_nd:.3f}x); the step {step_ms:.3f} ms "
          f"between CUDA events around it (its device idle gaps "
          f"included), {share:.3%} of the {rl.PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s peak at the predicted FLOPs; {card}")
    dr_check(abs(rel) <= DR_ANCHOR_TOL,
             f"the anchor's predicted peak {predicted:.4g} B is {rel:+.1%} "
             f"of the measured {measured:.4g} B")
    return dict(cell=cell, dry_run_s=dry_s, predicted_peak_bytes=predicted,
                measured_peak_bytes=measured, peak_rel_err=rel,
                predicted_flops=flops, model_flops_6nd=six_nd,
                step_ms=step_ms, peak_share=share)


def dryrun_phase(seed, dev, torch, dispatch, card):
    """Phase 15: the dry run's cells, the anchor and the benches.
    Returns (record, the benches' kernel launches)."""
    from benchmarks_torch import kernel_bench, roofline_table
    from repro_torch.launch import dryrun

    t_start = time.perf_counter()
    out = ROOT / "results" / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    cells = {}
    for arch, shape in DR_CELLS:
        t0 = time.perf_counter()
        cell = dryrun.run_cell(arch, shape, False, device="cuda")
        (out / f"{arch}__{shape}__16x16.json").write_text(
            json.dumps(cell, indent=2, default=str))
        dr_check(cell["status"] == "ok",
                 f"{arch}/{shape}/16x16: {cell.get('error')}")
        r, m = cell["roofline"], cell["mem"]
        phase("dryrun", f"{arch}/{shape}/16x16 over a fake 256-rank world "
              f"on fake cuda tensors ({time.perf_counter() - t0:.1f} s): "
              f"peak {m['peak_gb']:.3f} GB a device (args "
              f"{m['args_gb']:.3f}); compute {r['compute_s'] * 1e3:.3f} ms, "
              f"memory {r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}; "
              f"useful FLOPs {cell['useful_flops_frac']:.3f}; "
              f"collectives {r['collectives']}")
        cells[f"{arch}/{shape}"] = cell
    anchor = dr_anchor(seed, dev, torch, card)

    dispatch.reset()
    t0 = time.perf_counter()
    bench_rows = kernel_bench.run() + roofline_table.run()
    bench_launches = dispatch.counts()
    for row in bench_rows:
        phase("dryrun", f"bench {row}")
    dr_check(bench_launches, "the kernel bench launched no kernel")
    phase_s = time.perf_counter() - t_start
    phase("dryrun", f"benches in {time.perf_counter() - t0:.1f} s, "
          f"launches {bench_launches}; phase took {phase_s:.1f} s; {card}")
    return (dict(cells=cells, anchor=anchor, bench_rows=bench_rows,
                 bench_launches=bench_launches, phase_s=phase_s, card=card),
            bench_launches)


def main_path_audio(seed: int):
    """The main path's 256 streams of 32,000 samples and the rounds'
    chunk sizes (some streams skip a round)."""
    rng = np.random.default_rng(seed + 5)
    audio = [rng.integers(0, 256, 32000, dtype=np.uint8)
             for _ in range(B_MAIN)]
    chunk_plan, fed = [], np.zeros(B_MAIN, np.int64)
    while (fed < 32000).any():
        sizes = np.minimum(rng.integers(200, 2400, B_MAIN), 32000 - fed)
        sizes[rng.random(B_MAIN) < 0.15] = 0   # some streams skip a round
        fed += sizes
        chunk_plan.append(sizes.tolist())
    return audio, chunk_plan


def cards_only(seed: int, card: str, torch) -> int:
    """``--phase cards``: the 1-shard sync megakernel drive of the sharded
    phase on ``cuda:0``, then phase 9b against it; its record goes to
    ``chiprun_out/chip_smoke_cards.json``."""
    from repro_torch.kernels import conv_kernels as bk
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import hop_megakernel as mk
    from repro_torch.launch.mesh import ShardRows, make_stream_mesh
    from repro_torch.models import kws
    from repro_torch.stream import AsyncStreamScheduler, StreamScheduler
    from repro_torch.stream.state import plan_stream

    spec = kws.build_kws_spec()
    plan = plan_stream(spec, hop_frames=HOP_FRAMES)
    weights, thresholds = random_model(spec, seed)
    audio, chunk_plan = main_path_audio(seed)
    one = StreamScheduler(spec, weights, thresholds, capacity=B_MAIN,
                          hop_frames=HOP_FRAMES,
                          mesh=make_stream_mesh(1, device="cuda:0"))
    hops, peeks, closes, _ = drive_churn(one, audio, chunk_plan, torch,
                                         dispatch, churn_sids(B_MAIN, False))
    err = collections.Counter()

    def merge(e):
        for k, v in e.items():
            err[k] = max(err[k], v)

    rec, launches = cards_phase(
        spec, plan, seed, audio, chunk_plan, torch, dispatch, mk, bk,
        StreamScheduler, AsyncStreamScheduler, make_stream_mesh, ShardRows,
        weights, thresholds, (per_stream(hops), peeks, closes), merge, card)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_cards.json").write_text(json.dumps(
        dict(rec, card=card, launches=dict(launches), max_abs_err=err),
        indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=("all", "cards", "lm_cards",
                                        "moe_dispatch"),
                    default="all",
                    help="cards: the build, the 1-shard drive and phase "
                    "9b only; lm_cards: phase 13b only (it builds only "
                    "the MoE layers' dispatch kernels); moe_dispatch: "
                    "phase 13c only")
    args = ap.parse_args()

    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, dispatch
        from repro_torch.kernels import conv_kernels as bk
        from repro_torch.kernels import hop_megakernel as mk
        from repro_torch.kernels import ops
        from repro_torch.kernels import twm_matmul as tm
        from repro_torch.launch.mesh import ShardRows, make_stream_mesh
        from repro_torch.models import kws
        from repro_torch.stream import (
            AsyncStreamScheduler,
            StreamScheduler,
            StreamState,
        )
        from repro_torch.stream.state import plan_stream
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    card = card_line()
    dev = torch.device("cuda", 0)
    phase("device", f"{torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    if args.phase in ("lm_cards", "moe_dispatch"):
        if args.phase == "lm_cards":
            rec = lm_cards_phase(args.seed, torch, dispatch, card)
        else:
            rec, entry = moe_dispatch_phase(args.seed, dev, torch, dispatch,
                                            card)
            print(json.dumps({"kernels": [entry]}))
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / f"chip_smoke_{args.phase}.json").write_text(json.dumps(
            rec, indent=1))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build_all([mk.HOP_KERNEL, bk.SOURCE, tm.SOURCE,
                            "mma_rate"])
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in build.build_logs.get(name,
                                                            "").splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{lib.name}: " + " | ".join(ptxas))
    phase("build", f"{len(libs)} sources in {time.perf_counter() - t0:.2f} s")
    if args.phase == "cards":
        cards_only(args.seed, card, torch)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 3. kernels vs plain
    spec = kws.build_kws_spec()
    plan = plan_stream(spec, hop_frames=HOP_FRAMES)
    weights, thresholds = random_model(spec, args.seed)
    params = model_tensors(plan, weights, thresholds, dev, torch)
    err = {mk.HOP_KERNEL: 0, mk.FINALIZE_KERNEL: 0, bk.BITSERIAL_KERNEL: 0,
           bk.CONV_STEP_KERNEL: 0, bk.TAIL_KERNEL: 0, bk.CONV_KERNEL: 0,
           tm.POPCOUNT_KERNEL: 0, tm.MXU_KERNEL: 0}

    def merge(e):
        for k, v in e.items():
            err[k] = max(err[k], v)

    main_inp = hop_inputs(plan, B_MAIN, args.seed + 1, dev, torch)
    merge(check_case("kws hf8 masked", plan, params, main_inp, None, torch,
                     mk, dispatch))
    merge(check_case("kws hf8 B=200", plan, params,
                     hop_inputs(plan, 200, args.seed + 2, dev, torch),
                     None, torch, mk, dispatch))
    w2, t2 = random_model(spec, args.seed + 100)
    p2 = model_tensors(plan, w2, t2, dev, torch)
    pooled = {k: [torch.stack([a, b]) for a, b in zip(params[k], p2[k])]
              for k in params}
    blocks = np.random.default_rng(args.seed).integers(0, 2, B_MAIN // 8)
    model_idx = torch.as_tensor(np.repeat(blocks, 8).astype(np.int32),
                                device=dev)
    merge(check_case("kws hf8 pooled K=2", plan, pooled, main_inp,
                     model_idx, torch, mk, dispatch))
    # the slot blocks' edges: tenants mixed inside a block, ragged last
    # blocks, a batch with no live slot, and every slot block forced
    per_slot = torch.as_tensor(np.random.default_rng(args.seed + 20).integers(
        0, 2, B_MAIN, dtype=np.int32), device=dev)
    merge(check_case("kws hf8 pooled K=2 by slot", plan, pooled, main_inp,
                     per_slot, torch, mk, dispatch))
    for b in (1, 257):
        merge(check_case(f"kws hf8 B={b}", plan, params,
                         hop_inputs(plan, b, args.seed + 21 + b, dev, torch),
                         None, torch, mk, dispatch))
    masked = hop_inputs(plan, 64, args.seed + 22, dev, torch)
    masked["mask"] = torch.zeros_like(masked["mask"])
    merge(check_case("kws hf8 all masked", plan, params, masked, None, torch,
                     mk, dispatch))
    kws_geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    kws_fc = [(f.cin, f.cout) for f in plan.fcs]
    for slots in SLOT_SWEEP:
        try:
            mk.cta_layout(kws_geoms, kws_fc, plan.gap_channels, slots)
        except ValueError:
            continue   # the smoke spec below takes it
        merge(check_case(f"kws hf8 S={slots}", plan, params, main_inp, None,
                         torch, mk, dispatch, slots=slots))
    merge(check_case("kws hf8 pooled K=2 by slot, S=4", plan, pooled,
                     main_inp, per_slot, torch, mk, dispatch, slots=4))
    smoke = kws.build_kws_smoke_spec()
    splan = plan_stream(smoke, hop_frames=1)
    for label, sp in (("smoke hf1", smoke),
                      ("smoke hf1, 8-bit input to conv stage 1 (C.1)",
                       multibit_smoke_spec())):
        pl = plan_stream(sp, hop_frames=1)
        merge(check_case(label, pl, model_tensors(
            pl, *random_model(sp, args.seed), dev, torch),
            hop_inputs(pl, 64, args.seed + 3, dev, torch), None, torch, mk,
            dispatch))
    merge(check_case("smoke hf1 B=61 S=8", splan, model_tensors(
        splan, *random_model(smoke, args.seed), dev, torch),
        hop_inputs(splan, 61, args.seed + 23, dev, torch), None, torch, mk,
        dispatch, slots=8))
    rgeoms = []
    for j in range(3):
        rspec, hf = random_spec(args.seed * 10 + j)
        rplan = plan_stream(rspec, hop_frames=hf)
        rparams = model_tensors(rplan, *random_model(rspec, j), dev, torch)
        rgeoms.append((rplan, rparams))
        merge(check_case(
            f"random geometry {j} ({len(rplan.convs)} convs, hf {hf})",
            rplan, rparams, hop_inputs(rplan, 48, args.seed + 10 + j, dev,
                                       torch), None, torch, mk, dispatch))
    main_launches = per_stage_launches(plan, [params], B_MAIN, args.seed + 6,
                                       dev, torch)
    merge(check_per_stage("per-stage kws hf8", main_launches, torch, bk,
                          dispatch))
    merge(check_per_stage("per-stage kws hf8", per_stage_launches(
        plan, [params], 200, args.seed + 7, dev, torch), torch, bk,
        dispatch))
    merge(check_per_stage("per-stage kws hf8 pooled K=2", per_stage_launches(
        plan, [params, p2], B_MAIN, args.seed + 8, dev, torch, model_idx),
        torch, bk, dispatch))
    rplan, rparams = rgeoms[0]
    merge(check_per_stage("per-stage random geometry 0", per_stage_launches(
        rplan, [rparams], 48, args.seed + 9, dev, torch), torch, bk,
        dispatch))
    merge(check_per_stage("B.3 edge cases", bitserial_cases(
        args.seed + 24, dev, torch), torch, bk, dispatch))
    merge(check_per_stage("B.4 edge cases", step_cases(
        args.seed + 25, dev, torch), torch, bk, dispatch))
    merge(check_per_stage("B.5 edge cases", tail_cases(
        args.seed + 26, dev, torch), torch, bk, dispatch))

    geoms = tuple(mk.stage_geom(s) for s in plan.convs)
    fc_raw = tuple(f.out_raw for f in plan.fcs)
    # the weights laid out once, as the scheduler holds them
    p = (mk.prepare_hop_weights(params["ws"], params["fc_ws"]),
         params["thrs"], params["flips"], params["fc_ws"],
         params["fc_thrs"], params["fc_flips"])
    full = hop_inputs(plan, B_MAIN, args.seed + 4, dev, torch,
                      mask_zeros=False)  # every slot advances, as on a hop
    state = (full["tails"], full["pendings"], full["gap"])
    hop_args = (full["audio"], full["mask"], *state, *p)
    fin_args = (*state, *p)
    raw_p = (params["ws"], *p[1:])   # the plain versions' operands
    timing = {}
    for emit in (True, False):
        timing[("hop", emit)] = (
            time_ms(lambda: mk.hop_megakernel_packed(
                *hop_args, geoms=geoms, emit=emit, fc_raw=fc_raw), torch),
            time_ms(lambda: mk.hop_megakernel_plain(
                full["audio"], full["mask"], *state, *raw_p, geoms=geoms,
                emit=emit, fc_raw=fc_raw), torch, iters=5),
            *bound_ms(plan, params, full, B_MAIN, finalize=False, emit=emit))
    timing["fin"] = (
        time_ms(lambda: mk.finalize_megakernel_packed(
            *fin_args, geoms=geoms, fc_raw=fc_raw), torch),
        time_ms(lambda: mk.finalize_megakernel_plain(
            *state, *raw_p, geoms=geoms, fc_raw=fc_raw), torch, iters=5),
        *bound_ms(plan, params, full, B_MAIN, finalize=True, emit=True))
    hop_call_ms = call_ms(lambda: mk.hop_megakernel_packed(
        *hop_args, geoms=geoms, emit=True, fc_raw=fc_raw), torch)
    earlier = {("hop", True): "emit", ("hop", False): "steady",
               "fin": "finalize"}
    for key, (ms, pms, bms, by) in timing.items():
        phase("kernels", f"time {key}: kernel {ms:.4f} ms (earlier: "
              f"{EARLIER_MS[earlier[key]]}), plain {pms:.4f} ms, bound "
              f"{bms:.6f} ms ({by}) at B={B_MAIN} hf={HOP_FRAMES}")
    phase("kernels", f"time ('hop', True) issued from Python: "
          f"{hop_call_ms:.4f} ms per call")
    sweep_s = slot_sweep(plan, params, full, torch, mk)

    # per-stage kernels at the main path's launch shapes (a hop's)
    torch.backends.cudnn.allow_tf32 = False
    fns = per_stage_fns(bk)
    per_launch = []
    for e in main_launches:
        if not e["main"]:
            continue
        kernel, plain = fns[e["name"]]
        out = kernel(*e["args"], **e["kw"])
        bms, t_b, t_o = launch_bound_ms(e, out)
        rec = dict(label=e["label"], name=e["name"],
                   ms=time_ms(lambda: kernel(*e["args"], **e["kw"]), torch),
                   call_ms=call_ms(lambda: kernel(*e["args"], **e["kw"]),
                                   torch),
                   plain_ms=time_ms(lambda: plain(*e["args"], **e["kw"]),
                                    torch, iters=5),
                   bound_ms=bms, bytes_s=t_b, ops_s=t_o, library_ms=None)
        if e["name"] != bk.TAIL_KERNEL:
            call, to_kernel_layout = library_call(e, torch)
            lib_out = to_kernel_layout(call())
            if not torch.equal(lib_out, out.float()):
                raise RuntimeError(f"conv1d disagrees with {e['label']}")
            rec["library_ms"] = time_ms(call, torch)
        per_launch.append(rec)
        was = (f" (earlier: {EARLIER_MS[e['label']]})"
               if e["label"] in EARLIER_MS else "")
        phase("kernels", f"time {e['label']} ({e['name']}): kernel "
              f"{rec['ms']:.4f} ms{was} (issued from Python "
              f"{rec['call_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
              f"bound {bms:.6f} ms, conv1d {rec['library_ms']}")
    per_kernel = aggregate(per_launch)
    step_rows = [r for r in per_launch if r["name"] == bk.CONV_STEP_KERNEL]
    hop_sum = sum(r["ms"] for r in step_rows if r["label"].startswith("hop"))
    flush_sum = sum(r["ms"] for r in step_rows
                    if r["label"].startswith("flush"))
    phase("kernels", f"B.4 per emit hop: hop windows b1-b3 {hop_sum:.4f} ms "
          f"(earlier: {EARLIER_MS['b1-b3 hop windows']}), flush windows "
          f"{flush_sum:.4f} ms, {len(step_rows)} launches "
          f"{[round(r['ms'], 4) for r in step_rows]}")
    # B.5 for one stream (a hop-boundary peek of a single stream)
    tail_e = next(e for e in main_launches if e["name"] == bk.TAIL_KERNEL)
    one = dict(tail_e, args=(tail_e["args"][0][:1].contiguous(),
                             *tail_e["args"][1:]),
               macs=tail_e["macs"] // B_MAIN)
    out1 = bk.classifier_tail(*one["args"], **one["kw"])
    if not torch.equal(out1, bk.classifier_tail_plain(*one["args"],
                                                      **one["kw"])):
        raise RuntimeError("B.5 at B=1 differs from plain")
    tail_b1 = dict(
        label="classifier B=1", name=bk.TAIL_KERNEL,
        ms=time_ms(lambda: bk.classifier_tail(*one["args"], **one["kw"]),
                   torch),
        plain_ms=time_ms(lambda: bk.classifier_tail_plain(
            *one["args"], **one["kw"]), torch, iters=5),
        bound_ms=launch_bound_ms(one, out1)[0])
    phase("kernels", f"time classifier B=1 ({bk.TAIL_KERNEL}): kernel "
          f"{tail_b1['ms']:.4f} ms, plain {tail_b1['plain_ms']:.4f} ms, "
          f"bound {tail_b1['bound_ms']:.6f} ms")
    sms = mk._sms(dev)
    sweep_step_rows = step_sweep(main_launches, torch, bk, sms)
    sweep_tail_rows = tail_sweep(tail_e, torch, bk, sms)
    mma = mma_rate(build, torch)

    # 4. launch counts
    for emit in (True, False):
        s = StreamScheduler(smoke, *random_model(smoke, 7), capacity=4,
                            hop_frames=1, emit_logits=emit)
        a = s.add_stream()
        s.push_audio(a, np.random.default_rng(7).integers(
            0, 256, splan.prime_samples + 3 * splan.hop_samples,
            dtype=np.uint8))
        dispatch.reset()
        n_hops = s.drain()
        hops_counted = dispatch.counts()
        dispatch.reset()
        s.peek(a)
        peek_counted = dispatch.counts()
        want_peek = {} if emit else {mk.FINALIZE_KERNEL: 1}
        if (hops_counted != {mk.HOP_KERNEL: n_hops} or n_hops != 3
                or peek_counted != want_peek):
            raise RuntimeError(f"launch counts (emit={emit}): {n_hops} hops "
                               f"-> {hops_counted}, peek -> {peek_counted}")
        phase("launches", f"megakernel emit={emit}: {n_hops} hops -> "
              f"{hops_counted}, hop-boundary peek -> "
              f"{peek_counted or 'cached logits'}")
    for emit in (True, False):
        s = StreamScheduler(spec, weights, thresholds, capacity=2,
                            hop_frames=HOP_FRAMES, backend="per_stage",
                            emit_logits=emit)
        a = s.add_stream()
        s.push_audio(a, np.random.default_rng(8).integers(
            0, 256, plan.prime_samples + 3 * plan.hop_samples,
            dtype=np.uint8))
        per_hop = []
        while True:
            with dispatch.counting() as launched:
                hb = s.step_batch()
            if hb is None:
                break
            per_hop.append(launched())
        with dispatch.counting() as launched:
            s.peek(a)
        want_hop = {bk.BITSERIAL_KERNEL: 2, bk.CONV_STEP_KERNEL: 6,
                    bk.TAIL_KERNEL: 1} if emit else {
            bk.BITSERIAL_KERNEL: 1, bk.CONV_STEP_KERNEL: 3}
        want_peek = {} if emit else {bk.BITSERIAL_KERNEL: 1,
                                     bk.CONV_STEP_KERNEL: 3,
                                     bk.TAIL_KERNEL: 1}
        n_want = 9 if emit else 4
        if (len(per_hop) != 3 or any(h != want_hop for h in per_hop)
                or s._model.dispatches_per_hop(emit) != n_want
                or launched() != want_peek
                or s._model.dispatches_per_finalize() != 5):
            raise RuntimeError(f"per-stage launch counts (emit={emit}): "
                               f"hops {per_hop}, peek {launched()}")
        phase("launches", f"per_stage emit={emit}: {len(per_hop)} hops, "
              f"{n_want} launches each {per_hop[0]}; hop-boundary peek -> "
              f"{launched() or 'cached logits'}")

    # 5. the kernel library
    t_lib = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # exact float32 yardstick
    lib_entries = library_entries(spec, weights, thresholds, args.seed + 11,
                                  dev, torch)
    lib_fns = library_fns(bk, tm)
    merge(check_library(lib_entries, torch, lib_fns, dispatch))
    audio1 = np.random.default_rng(args.seed + 12).integers(
        0, 256, spec.in_len, dtype=np.uint8)
    logits, gemms, gemm_in, utt_launches, gemm_launches = run_library_path(
        spec, weights, thresholds, audio1, args.seed + 13, dev, torch, kws,
        ops, dispatch)
    want_utt = {bk.BITSERIAL_KERNEL: 1, bk.CONV_KERNEL: 3,
                tm.POPCOUNT_KERNEL: 2}
    if utt_launches != want_utt:
        raise RuntimeError(f"utterance launches {utt_launches} != "
                           f"{want_utt}")
    if gemm_launches != {tm.POPCOUNT_KERNEL: 2, tm.MXU_KERNEL: 2}:
        raise RuntimeError(f"GEMM launches {gemm_launches}")
    plain_logits = kws.offline_logits(spec, weights, thresholds,
                                      torch.as_tensor(audio1))
    oracle = StreamState(plan, weights, thresholds)
    oracle.advance(audio1, flush=True)
    if (logits.dtype != torch.int32 or tuple(logits.shape) != (12,)
            or not torch.equal(logits.cpu(), plain_logits)):
        raise RuntimeError(f"utterance logits {logits} differ from the "
                           f"plain composition {plain_logits}")
    if not np.array_equal(plain_logits.numpy(), oracle.logits()):
        raise RuntimeError("utterance logits differ from StreamState")
    i32 = lambda t: t.view(torch.int32).cpu()  # noqa: E731
    for (pop, mxu), a in zip(gemms, gemm_in):
        cpu = tuple(t.cpu() for t in a)
        if not (torch.equal(i32(pop), i32(ops.twm_linear(*cpu, mode="sa")))
                and torch.equal(i32(mxu), i32(ops.twm_linear_mxu(*cpu)))
                and torch.equal(i32(pop), i32(mxu))):
            raise RuntimeError(f"library GEMM {tuple(a[0].shape)} x "
                               f"{tuple(a[1].shape)} differs from plain")
    # the same utterance through the model laid out once
    model = kws.prepare_offline(spec, weights, thresholds, device=dev)
    audio_dev = torch.as_tensor(audio1, device=dev)
    torch.cuda.synchronize()
    dispatch.reset()   # the prepared utterance's counts start here
    prep_logits = kws.offline_logits(model, audio_dev)
    prep_launches = dispatch.counts()
    if prep_launches != want_utt or not torch.equal(prep_logits, logits):
        raise RuntimeError(f"prepared-model utterance: logits "
                           f"{prep_logits}, launches {prep_launches}")
    phase("library", f"utterance ({spec.in_len} samples, width 64): "
          f"logits {logits.tolist()} == plain composition == StreamState "
          f"== prepared model; launches {utt_launches} (prepared model: "
          f"{prep_launches}); kernel_bench GEMMs {BENCH_GEMMS} "
          f"through twm_linear and twm_linear_mxu: equal, launches "
          f"{gemm_launches}")
    lib_launches = dict(collections.Counter(utt_launches)
                        + collections.Counter(gemm_launches))
    # one utterance as a caller issues it, model already on the card
    on_card = lambda d: {li: (tuple(torch.as_tensor(v, device=dev)  # noqa: E731,E501
                                    for v in x) if isinstance(x, tuple)
                              else torch.as_tensor(x, device=dev))
                         for li, x in d.items()}
    w_dev, t_dev = on_card(weights), on_card(thresholds)
    utt_ms = call_ms(lambda: kws.offline_logits(spec, w_dev, t_dev,
                                                audio_dev), torch)
    prep_ms = call_ms(lambda: kws.offline_logits(model, audio_dev), torch)
    phase("library", f"utterance issued from Python (1 B.3, 3 B.6, 2 B.7 "
          f"launches and the host's glue): raw model dicts on the card "
          f"{utt_ms:.4f} ms per call, model laid out once "
          f"(prepare_offline) {prep_ms:.4f} ms per call; {card}")
    lib_times = []
    for e in lib_entries:
        if not e["timed"]:
            continue
        kernel, plain = lib_fns[e["name"]]
        out = kernel(*e["args"], **e["kw"])
        bms, t_b, t_o = launch_bound_ms(e, out)
        yard, yard_name = library_yardstick(e, out, torch, tm)
        rec = dict(label=e["label"], name=e["name"], main=e["main"],
                   shape=e.get("shape"), macs=e["macs"],
                   ms=time_ms(lambda: kernel(*e["args"], **e["kw"]), torch),
                   call_ms=call_ms(lambda: kernel(*e["args"], **e["kw"]),
                                   torch),
                   plain_ms=time_ms(lambda: plain(*e["args"], **e["kw"]),
                                    torch, iters=5),
                   bound_ms=bms, bytes_s=t_b, ops_s=t_o,
                   library_ms=time_ms(yard, torch), library_call=yard_name)
        rec["tile"] = gemm_tile(e, tm)
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
        lib_times.append(rec)
        was = (f" (earlier: {EARLIER_MS[e['label']]})"
               if e["label"] in EARLIER_MS else "")
        phase("library", f"time {e['label']} ({e['name']}"
              f"{', ' + rec['tile'] if rec['tile'] else ''}): kernel "
              f"{rec['ms']:.4f} ms{was} (issued from Python {rec['call_ms']:.4f}"
              f" ms), plain {rec['plain_ms']:.4f} ms, bound {bms:.6f} ms "
              f"({'bytes' if t_b >= t_o else 'operations'}), "
              f"{yard_name} {rec['library_ms']:.4f} ms, kernel / library "
              f"{rec['vs_library']:.2f}")
    sweep = tile_sweep(lib_entries, torch, tm, args.seed + 14, dev)
    b6_sweep = block_sweep(lib_entries, torch, bk, mk._sms(dev))
    by_label = {(r["name"], r["label"]): r for r in lib_times}
    pick = {}
    for shape in GEMM_SHAPES:
        pop = by_label[(tm.POPCOUNT_KERNEL, f"{shape} sa")]
        mxu = by_label[(tm.MXU_KERNEL, f"{shape} sa")]
        pick[str(shape)] = dict(
            pick_path=ops.pick_path(*shape),
            faster=("popcount" if pop["ms"] <= mxu["ms"] else "mxu"),
            popcount_ms=pop["ms"], mxu_ms=mxu["ms"],
            popcount_macs_per_s=pop["macs"] / (pop["ms"] * 1e-3))
        phase("library", f"pick_path{shape} = {pick[str(shape)]['pick_path']}"
              f"; on the card B.7 sa {pop['ms']:.4f} ms, B.8 "
              f"{mxu['ms']:.4f} ms: {pick[str(shape)]['faster']} faster; "
              f"B.7 at {pick[str(shape)]['popcount_macs_per_s']:.4e} MAC/s")
    lib_main = [rec for rec in lib_times if rec["main"]]
    lib_kernel = aggregate(lib_main)
    phase("library", f"phase took {time.perf_counter() - t_lib:.1f} s")

    # 6. the main path
    audio, chunk_plan = main_path_audio(args.seed)
    kw = dict(capacity=B_MAIN, hop_frames=HOP_FRAMES)
    dispatch.reset()   # the megakernel runs' counts start here
    mega = StreamScheduler(spec, weights, thresholds, backend="megakernel",
                           **kw)
    hops, peeks, closes, hop_ms, top = drive(mega, audio, chunk_plan,
                                             plan.hop_samples, torch)
    quiet = StreamScheduler(spec, weights, thresholds, backend="megakernel",
                            emit_logits=False, **kw)
    q_hops, q_peeks, q_closes, _, _ = drive(quiet, audio, chunk_plan,
                                            plan.hop_samples, torch)
    launches = dispatch.counts()
    dispatch.reset()   # the per-stage run's counts start here
    per_stage = StreamScheduler(spec, weights, thresholds,
                                backend="per_stage", **kw)
    ps_hops, ps_peeks, ps_closes, ps_hop_ms, _ = drive(
        per_stage, audio, chunk_plan, plan.hop_samples, torch)
    ps_launches = dispatch.counts()
    dense = StreamScheduler(spec, weights, thresholds, backend="torch", **kw)
    d_hops, d_peeks, d_closes, _, _ = drive(dense, audio, chunk_plan,
                                            plan.hop_samples, torch)
    if launches.get(mk.HOP_KERNEL) != len(hops) + len(q_hops):
        raise RuntimeError(f"hop launches {launches} != hops "
                           f"{len(hops)} + {len(q_hops)}")
    if launches.get(mk.FINALIZE_KERNEL) != 1:
        raise RuntimeError(f"finalize launches {launches}: the emit-off "
                           "hop-boundary peek must launch it once")
    want_ps = {bk.BITSERIAL_KERNEL: 2 * len(ps_hops),
               bk.CONV_STEP_KERNEL: 6 * len(ps_hops),
               bk.TAIL_KERNEL: len(ps_hops)}
    if ps_launches != want_ps:
        raise RuntimeError(f"per-stage launches {ps_launches} != {want_ps} "
                           f"({len(ps_hops)} emit hops x 9)")
    if not len(hops) == len(d_hops) == len(q_hops) == len(ps_hops):
        raise RuntimeError("hop counts differ between runs")
    for (s1, f1, l1), (s2, f2, l2), (s3, f3, _), (s4, f4, l4) in zip(
            hops, d_hops, q_hops, ps_hops):
        if not all(np.array_equal(s1, x) for x in (s2, s3, s4)) or not all(
                np.array_equal(f1, x) for x in (f2, f3, f4)):
            raise RuntimeError("hop streams or frames differ between runs")
        if not np.array_equal(l1, l2):
            raise RuntimeError("megakernel hop differs from dense backend")
        if not np.array_equal(l4, l1):
            raise RuntimeError("per-stage hop differs from megakernel")
    for sid in peeks:
        if not all(np.array_equal(peeks[sid], x[sid])
                   for x in (d_peeks, q_peeks, ps_peeks)):
            raise RuntimeError(f"peek({sid}) differs between runs")
    for sid, res in closes.items():
        oracle = StreamState(plan, weights, thresholds)
        clip = audio[sid] if sid else np.concatenate([audio[0], top])
        oracle.advance(clip, flush=True)
        want = oracle.logits()
        for other in (d_closes[sid], q_closes[sid], ps_closes[sid]):
            if not np.array_equal(res.logits, other.logits):
                raise RuntimeError(f"close({sid}) differs between runs")
        if not np.array_equal(res.logits, want):
            raise RuntimeError(f"close({sid}) differs from StreamState")
    all_logits = np.concatenate([h[2] for h in hops])
    if not np.isfinite(all_logits).all() or all_logits.shape[1] != 12:
        raise RuntimeError(f"bad logits {all_logits.shape}")
    if len(np.unique(all_logits, axis=0)) < 2:
        raise RuntimeError("every hop gave the same logits")
    p50 = float(np.percentile(hop_ms, 50))
    ps_p50 = float(np.percentile(ps_hop_ms, 50))
    phases = {k: v["ms_p50"] for k, v in mega.metrics.phase_summary().items()}
    ps_phases = {k: v["ms_p50"]
                 for k, v in per_stage.metrics.phase_summary().items()}
    phase("main", f"{len(hops)} hops over {B_MAIN} streams (+ emit-off run "
          f"{len(q_hops)} hops), 2 peeks, {len(closes)} closes; megakernel "
          f"hop p50 {p50:.3f} ms synchronised; hop kernel "
          f"{timing[('hop', True)][0]:.4f} ms, finalize kernel "
          f"{timing['fin'][0]:.4f} ms per launch; launches {launches}; "
          f"phase p50 ms {phases}; {card}")
    phase("main", f"per_stage: {len(ps_hops)} hops, hop p50 {ps_p50:.3f} ms "
          f"synchronised; launches {ps_launches}; phase p50 ms {ps_phases}; "
          f"logits == megakernel == torch backend == StreamState; {card}")

    # 7. the async plane on the main path
    async_rec, async_launches = async_phase(
        spec, weights, thresholds, audio, chunk_plan, torch, dispatch, mk,
        StreamScheduler, AsyncStreamScheduler)
    # 8. the tenant pool on the main path
    tenant_rec, tenant_launches = tenants_phase(
        spec, plan, args.seed, audio, chunk_plan, dev, torch, dispatch, mk,
        bk, StreamScheduler, AsyncStreamScheduler, main_inp, p)
    # 9. the slot pool over S shards on the main path
    one_card = lambda S: make_stream_mesh(S, device=dev)  # noqa: E731
    shard_rec, shard_launches, one_shard = sharded_phase(
        spec, plan, args.seed, audio, chunk_plan, dev, torch, dispatch, mk,
        bk, StreamScheduler, AsyncStreamScheduler, one_card, full, p, raw_p,
        params, weights, thresholds, card)
    # 9b. the slot pool over every card
    cards_rec, cards_launches = cards_phase(
        spec, plan, args.seed, audio, chunk_plan, torch, dispatch, mk, bk,
        StreamScheduler, AsyncStreamScheduler, make_stream_mesh, ShardRows,
        weights, thresholds, one_shard, merge, card)
    # 10. the chip twin: the compiled program through the executor
    twin_rec, twin_launches, twin_recs, twin_err = chip_twin_phase(
        weights, thresholds, args.seed, dev, torch, dispatch, bk, tm,
        lib_fns, card)
    merge(twin_err)
    # 11. KWS training on the card, and the trained model's deploy
    train_rec, train_launches, train_err = train_phase(
        args.seed, dev, torch, dispatch, bk, tm, lib_fns, card)
    merge(train_err)
    # 12. LM serving: Qwen3-0.6B through the continuous-batching engine
    lm_rec = lm_serve_phase(args.seed, dev, torch, dispatch, card)
    lmf_rec = lm_families_phase(args.seed, dev, torch, dispatch, card)
    # 13c. the MoE dispatch's kernels at the LM cells' shapes
    mdp_rec, mdp_entry = moe_dispatch_phase(args.seed, dev, torch, dispatch,
                                            card)
    # 13b. the LM engine over every card (or shards of one)
    lc_rec = lm_cards_phase(args.seed, torch, dispatch, card)
    # 14. LM training: Qwen3-0.6B whole, DeepSeek-MoE cut, every family
    lt_rec = lm_train_phase(args.seed, dev, torch, dispatch, card, lmf_rec)
    # 15. the launch tools: dry-run cells, the anchor, the benches
    dr_rec, dr_launches = dryrun_phase(args.seed, dev, torch, dispatch, card)
    path_kernel = aggregate(per_launch + lib_main + twin_recs)
    new_paths = (async_launches + tenant_launches + shard_launches
                 + cards_launches + collections.Counter(twin_launches)
                 + collections.Counter(train_launches)
                 + collections.Counter(dr_launches))

    ms, pms, bms, by = timing[("hop", True)]
    fms, fpms, fbms, fby = timing["fin"]
    entries = [
        {"name": mk.HOP_KERNEL, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hop_megakernel.cu",
         "replaces": "src/repro/kernels/hop_megakernel.py:438",
         "launches": launches.get(mk.HOP_KERNEL, 0)
         + new_paths.get(mk.HOP_KERNEL, 0),
         "max_abs_err": err[mk.HOP_KERNEL], "ms": ms, "plain_ms": pms,
         "bound_ms": bms, "bound_by": by, "library_ms": None},
        {"name": mk.FINALIZE_KERNEL, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hop_megakernel.cu",
         "replaces": "src/repro/kernels/hop_megakernel.py:534",
         "launches": launches.get(mk.FINALIZE_KERNEL, 0)
         + new_paths.get(mk.FINALIZE_KERNEL, 0),
         "max_abs_err": err[mk.FINALIZE_KERNEL], "ms": fms,
         "plain_ms": fpms, "bound_ms": fbms, "bound_by": fby,
         "library_ms": None},
    ]
    conv_cu = "src/repro_torch/kernels/csrc/bnn_conv1d.cu"
    twm_cu = "src/repro_torch/kernels/csrc/twm_matmul.cu"
    for name, source, replaces in (
            (bk.BITSERIAL_KERNEL, conv_cu,
             "src/repro/kernels/bnn_conv1d.py:425"),
            (bk.CONV_STEP_KERNEL, conv_cu,
             "src/repro/kernels/bnn_conv1d.py:189"),
            (bk.TAIL_KERNEL, conv_cu, "src/repro/kernels/bnn_conv1d.py:315"),
            (bk.CONV_KERNEL, conv_cu, "src/repro/kernels/bnn_conv1d.py:64"),
            (tm.POPCOUNT_KERNEL, twm_cu,
             "src/repro/kernels/twm_matmul.py:69"),
            (tm.MXU_KERNEL, twm_cu, "src/repro/kernels/twm_matmul.py:140")):
        agg = path_kernel[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": ps_launches.get(name, 0) + lib_launches.get(name, 0)
            + new_paths.get(name, 0),
            "max_abs_err": err[name], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": ("bytes" if agg["bytes_s"] >= agg["ops_s"]
                         else "operations"),
            "library_ms": agg["library_ms"]})
    entries.append(mdp_entry)
    kernels = {"kernels": entries}
    record = dict(kernels, card=card, hop_ms_p50=p50, hops=len(hops),
                  hop_kernel_call_ms=hop_call_ms,
                  per_stage_call_ms={k: v["call_ms"]
                                     for k, v in per_kernel.items()},
                  phase_ms_p50=phases, per_stage_hop_ms_p50=ps_p50,
                  per_stage_phase_ms_p50=ps_phases,
                  per_stage_launch_shapes=per_launch,
                  library_launches=dict(utterance=utt_launches,
                                        gemms=gemm_launches),
                  library_launch_shapes=lib_times, pick_path=pick,
                  gemm_tile_sweep=sweep,
                  utterance_call_ms=utt_ms,
                  utterance_prepared_call_ms=prep_ms,
                  conv1d_block_sweep=b6_sweep,
                  library_call_ms={k: v["call_ms"]
                                   for k, v in lib_kernel.items()},
                  slot_block_sweep=sweep_s, earlier_ms=EARLIER_MS,
                  conv_step_per_hop=dict(hop_windows_ms=hop_sum,
                                         flush_windows_ms=flush_sum),
                  classifier_b1=tail_b1, conv_step_tile_sweep=sweep_step_rows,
                  classifier_slot_sweep=sweep_tail_rows, mma_rate=mma,
                  steady_hop=dict(zip(("ms", "plain_ms", "bound_ms",
                                       "bound_by"),
                                      timing[("hop", False)])),
                  async_path=async_rec, tenants=tenant_rec,
                  sharded=shard_rec, cards=cards_rec, chip_twin=twin_rec,
                  train=train_rec,
                  lm_serve=lm_rec, lm_families=lmf_rec,
                  moe_dispatch=mdp_rec, lm_cards=lc_rec,
                  lm_train=lt_rec,
                  dryrun=dr_rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
