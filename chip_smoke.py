"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass or the script exits non-zero:

1. card: the name and power limit, as nvidia-smi reports them;
2. build: the CUDA kernels, compiled from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the queries below give it (the bucket probe B2 on both of
   its routes: a table in shared memory, and one searched through a
   sample; also at the TPC-H join's negative-padded pass blocks and the
   whole filtered lineitem; the selection B1 in int32 and, on lineorder's
   price in dollars with bounds that round to float32, in float32) and at
   a ragged length with keys at both ends of int32 (NaN rows for B1's
   float32 entry); integer outputs must be bit-identical.  Each is timed with
   CUDA events beside its bound (bytes read once and written once over
   the card's data-sheet memory rate) and, where one PyTorch call
   computes the same function, that call's time; the join probes B3 and
   B4, whose wrappers can cost more host time a call than their kernels
   take, by their device time under ``torch.profiler``, the median of
   three timings of 200 calls;
4. ssb: an SSB Q1.1-shaped query at scale factor 10 (lineorder, 59,986,214
   rows, against the 2,556-row date dimension) through the executor in
   batch, stream and eager modes; each must equal a numpy int64 oracle,
   and each mode must have launched the kernels of its path;
5. tpch: a duplicate-keyed join at TPC-H scale factor 1 (orders against a
   filtered lineitem, which the optimizer makes the build side) in eager
   and batch modes, and lineitem joined with orders (1,500,000 unique
   build keys, which the pipeline probes through B2's sampled route) in
   batch and stream modes, each against a numpy oracle;
6. glm: hyper-parameter search (8 logistic-regression jobs, 5 epochs,
   minibatch 16) over an MNIST-shaped training set (60,000 rows, 784
   float32 features in [0, 1], a binary label from a planted logistic
   model) through the executor in batch, stream and eager modes: the
   modes' weights must be bit-identical, every model's loss below ln 2,
   and the SGD kernel's weights (its ring route, and the ring at every
   cluster size, each timed in us a step) must equal its plain version's
   within rtol=1e-4, atol=1e-5; hyper-parameter searches over models too
   wide for the ring (TF-IDF-shaped rows of RCV1's 47,236 features, and
   of news20.binary's 1,355,191, whose model slices live in device
   memory) take the split route, within the same tolerance, and plain
   controls that drop one block's dot sums, or all of them, must fall
   outside it; then ``score_glm`` against numpy;
7. multi_join: ``hash_join_multi`` at TPC-H scale factor 1, built on
   lineitem's order keys and probed with orders' (chains of 1-7), built
   on lineitem's quantity and probed with its 50 values (chains of
   ~120,000, nearly all from the overflow pass), both through B3's
   sampled route, and built on a 50-row quantity dimension and probed
   with every lineitem row (B3's shared route); pair lists must equal a
   numpy sort-based oracle bit for bit, and B3 its plain version at each
   shape, its (start, count) B2's;
8. calibrate: the traffic-generator kernel (``o = x + 1``) against its
   plain version, bit for bit, at 1 GiB of int32, at a ragged length, on
   a misaligned slice, at 2**31 - 1 and in float32, timed in turns with
   ``torch.add(x, 1)``; then ``calibrate()`` into a temporary file, loaded
   back and applied to an executor over SSB SF 10 with ``recost`` (the
   epoch must move, and a second ``recost`` with the same file must
   change no price); then the Fig. 2 analogue (``stream_copy_distributed``
   over 1, 4 and 16 engines, partitioned and congested, in GB/s);
9. spill: SSB Q1.1 at SF 10 under a 256 MiB device budget (one lineorder
   column stays on the card, three go to host DRAM) in batch and stream
   mode, and with a 512 MiB host budget as well (one column goes to
   disk), each equal to the numpy oracle and the unspilled run; the
   promoted bytes over the measured time beside the calibrated
   ``h2d_gbps``.  The GLM search of phase 6 also trains under a 64 MiB
   device budget, and its weights must equal the resident run's bit for
   bit;
10. telemetry: the query telemetry (``Telemetry(enabled=True)``).  SSB
   Q1.1 at SF 10 traced in batch, stream and eager mode, each value equal
   to the oracle and to phase 4's untraced run, each mode's launches equal
   to that run's, one bandwidth-ledger row per costed operator (the fused
   and streamed rows attributed), with each operator's predicted and
   measured GB/s and drifts printed; an exact-estimate table of 2**26
   rows (``v`` cycling 0..127, ``w`` ones), whose eager rows must all read
   ``drift_bytes`` 1.0; the median of 11 warm SSB batch runs with
   telemetry disabled (which must call the fence helper no time) and
   enabled, beside phase 4's; the ledger's calibration overlay (a ``cuda``
   backend with 0 < stream_eff <= 1) through ``recost``, twice, the second
   changing no price, its GB/s beside B6's calibrated rate; the Chrome
   trace, valid JSON whose ``op.*`` spans lie inside their
   ``exec.execute``; SSB spilled under 256 MiB, whose host promotions
   (719,834,568 bytes a run) get ``promote`` rows and an ``h2d_gbps``
   printed beside phase 8's pinned rate; and the MNIST-shaped GLM search
   streamed, its weights equal to the untraced run's bit for bit, with
   one ``train_glm`` row and rows x 4 x 785 x epochs x jobs bytes;
11. cache: the semantic cache (2 GiB) over SSB at SF 10.  Q1.1 in batch
   cold, then warm: a result hit that launches no kernel, its median of
   11 beside phase 4's; eager sum(extendedprice) over quantity 1..15 (30%
   of the rows) admits a 72 MB bitmap that 5..12 refines with no B1
   launch, bit-identical to a fresh B1 selection, refine against B1's
   scan timed; 1..30 (60%) is 1..24's only superset and loses to the
   scan (3 x 60% > 100%); a batch aggregate over 5..12 is routed onto the
   cached bitmap.  The cache and the calibrated model are saved to the
   temporary directory and warm-started into a fresh executor's host
   tier, where Q1.1 is a hit; then ``lineorder.discount`` is updated:
   Q1.1 misses and equals the new oracle, no entry, placement, build or
   plan of the old version is left (device memory before and after
   printed), and the snapshot loads with stale entries.  A cache whose
   device budget holds one of two bitmaps demotes one to the host; the
   rerun hits it there, gets it on the card and, once there is room,
   promotes it.  Two executors share one cache: one's Q1.1 is a hit from
   the other's run, and a mutation noticed by one sweeps the other's
   entries.  TPC-H lineitem (two quantity filters) joined with orders in
   batch: the second query reuses the cached 1,500,000-key build.  The
   MNIST-shaped search trains once, and ``score_glm`` by the train plan
   and by raw fingerprint launch no SGD kernel, their scores bit-identical
   to a cache-less executor's.  Every value equals numpy, and the phase
   fails when the executor has no cache (``REPRO_CACHE=0``);
12. serve: the query server over SSB at SF 10.  One admission-batch
   server takes 64 submissions from 4 tenants (flight 1's Q1.1, Q1.2 and
   Q1.3 four times each, 24 quantity-range sums twice, 4 projections of
   a 5-day order-date window, about 0.2% of the rows): 33 deduplicated,
   the 24 sums micro-batched in one pass.  A streaming server
   (``morsel_rows`` 2**22, 15 morsels) admits 16 flight-1 variants in 4
   waves two pumps apart, 2 dedup riders and 2 Project-rooted members:
   one group holds up to 16 members, and B2 launches once per advance
   per live group and join, however many members.  A tenant whose SLO
   (1 us) is far below the achievable p95 forces backpressure on the
   other.  A traced server with ``AdaptivePolicy()`` folds the ledger's
   drift into the cost model while a wave is in flight (or, when the
   policy sees no breach in 7 pumps, recosts with the ledger's overlay),
   and the next wave forms a new group.  A 2 GiB cache is saved and a
   fresh server warm-starts from the file: Q1.1 then takes path
   ``cached`` and launches nothing.  Every value equals numpy; the
   sojourn p50 / p95, q/s and per-path counts are printed.  Phase 6's
   search is also served from a cached server: it trains once and two
   ``score_glm`` queries launch no SGD kernel;
13. shard: sharded execution (``Executor(shards=N)``, N contiguous slices
   of every streamed column on the one card).  SSB Q1.1 at SF 10 on 2
   shards (batch sharded) and on 4 (59,986,214 rows are not a multiple
   of 4, so the batch step is the unsharded one, as in the reference) in
   batch, stream and eager, each equal to the oracle, with ``explain``
   (``placement=sharded``), the warm median of 11 beside phase 4's
   unsharded one, device busy against wall, and B2 launched once per
   shard per morsel; TPC-H SF 1's lineitem joined with orders and the
   duplicate-keyed filtered join, eager on 4 shards, each planner
   strategy printed, and at the engine layer the shuffle join's pairs
   bit-identical to the broadcast join's at full size, both timed with
   their B2 / B4 launches; a streaming server on 2 shards whose values
   equal the unsharded server's and the oracle, its ``serve`` ledger
   rows carrying shard ids 0 and 1; and the eager filter on a float32
   column (lineorder's price in dollars) through B1's float32 entry,
   bit-identical to the CPU's;
14. lm: the LM serving path at full width.  The flash-attention
   kernel's two tensor-core routes against their plain version at the
   shapes the path runs them at: bf16 (wgmma) within 2e-2 at every
   served prefill, batch 4 (llama3-8b D 128 GQA 4, stablelm-3b D 80 MHA,
   granite-moe D 64 GQA 3, llama4-scout GQA 5, qwen2-vl GQA 7, jamba
   GQA 4), and f32 (three split-TF32 products) within 2e-5 at every
   model's f32 check, batch 1, each timed beside its bound and
   ``scaled_dot_product_attention`` in its type, and misaligned views of
   q, k and v through every row (equal to the aligned launch bit for
   bit); the SSD kernel's two routes against their plain version at the
   mamba2-780m prefill shape (the tensor-core route in bf16 at batch 4:
   y within 1.6e-2, the state within rtol=atol=1e-4; the CUDA-core route
   in f32 at the f32 check's batch 1, within rtol=atol=1e-4) and at
   jamba's (128 heads of 64, ds 16; the same two routes, batches and
   tolerances), two launches bit-identical, each timed with its three
   passes.  Then llama3-8b (32
   layers), stablelm-3b (32), mamba2-780m (48), granite-moe-3b-a800m (32)
   and qwen2-vl-7b (28), granite-8b (36) and internlm2-20b (48) through
   ``serve`` at full depth, and
   llama4-scout-17b-a16e and jamba-v0.1-52b through ``build_model`` and
   ``generate`` at 8 layers (``LM_DEPTH``: 214 GB and 104 GB of bf16
   weights against one 80 GB card; jamba's 8 are one period of its
   schedule), random weights from ``--seed``, 4 prompts of 2,000 tokens
   and 32 greedy tokens each: prefill and per-token decode time (first
   run, median of warm runs, one warm run for the four later models),
   tok/s, peak device memory, device busy against wall over a profiled
   run of a prefill and 7 decode steps (llama3-8b and granite-moe only,
   ``LM_PROFILE_ARCHS``), and one bf16 flash-attention
   launch per attention layer and one SSD tensor-core launch per Mamba
   layer of the prefill (the f32 check below launches the f32 route of
   each, once per such layer of each of its two prefills).  qwen2-vl
   also prefills with its 256 patch embeddings and Qwen2-VL's (t, h, w)
   positions.  Path
   checks: no NaN; a teacher-forced prefill of 1,999 tokens plus one
   decode step equals the 2,000-token prefill's last logits within
   ``TF_TOL`` of their largest magnitude in bf16 and within
   ``TF_TOL_F32`` on an f32 copy of the weights (llama4-scout's at 4
   layers and internlm2-20b's at 24, ``LM_F32_DEPTH``), at capacity
   factor E / k for the MoE
   models, where nothing drops; a 2-layer full-width model on the card
   equals the same weights on the CPU (the plain path) over a 512-token
   prompt within ``CARD_CPU_TOL`` of the largest logit: the MoE models on
   an f32 copy over 2 rows, their experts equal wherever the CPU's
   boundary gap exceeds ``LM_ROUTE_MARGIN`` and the rows that route alike
   compared (jamba's 2 layers pair attention with its FFN and Mamba with
   its MoE, as its schedule does); qwen2-vl with its patch embeddings and
   (t, h, w) positions.  qwen2-vl's patch prompts take Qwen2-VL's own
   layout (the 256 patches of a 16 x 16 grid share t, the text resumes
   at the grid's side), so their attention masks by position: one launch
   a layer, each so masked, in the served bf16 model and its f32 copy.
   whisper-large-v3 (32 encoder and 32 decoder layers, 1.55 B
   parameters) through ``serve`` at full width and depth: 4 x 1,500
   frames, 4 x 416-token prompts and 32 greedy tokens (448 decoder
   positions, its published context), B7 launched 96 times a prefill (32
   encoder layers non-causal, 32 causal decoder self-attentions, 32
   cross-attentions over the frames), the same path checks (the
   card-vs-CPU one at 2 encoder and 2 decoder layers over 416 tokens).
   B7 is also timed at whisper's three shapes and masked by position at
   qwen2-vl's, and B7 and B8 at the training step's shapes below; B7's
   backward kernel is held against ``plain_backward`` (two calls
   bit-identical) and timed beside SDPA's backward at stablelm-3b's,
   granite-moe's (GQA 3) and qwen2-vl's (by position) training shapes and
   whisper's encoder and cross-attention, in bf16 and in f32; B8's
   backward kernel is held against ``plain_backward`` (in f64 for f32
   inputs; each gradient within ``SSD_GRAD_TOL`` of its largest
   magnitude, two calls bit-identical) and timed, pass by pass, beside
   its bound and the plain version at mamba2-780m's training shape (bf16,
   4 x 4,096), at jamba's widths (bf16, 4 x 4,096: logged, not listed,
   as no card path trains jamba) and at the f32 check's shape (f32,
   1 x 256);
15. train: LM training.  stablelm-3b (32 layers, 2.80 B params, B7 bf16
   at D 80, batch 1) and mamba2-780m (48 layers, B8's tensor cores,
   batch 4) at full width and depth through ``launch.train.train`` at
   the reference's 4,096-token sequence (its global batch of 256 cut to
   what one card holds beside the AdamW state), 6 AdamW steps on one
   repeated batch: finite, falling loss, finite norms, exactly 2 B7 / B8
   launches a mixer layer a step (the forward and the checkpoint's
   recompute) and one call of B7's and of B8's backward kernel an
   attention or Mamba layer a step, the warm step median and the first,
   tokens/s, 6 N tokens over step time against 989 TFLOP/s, peak memory,
   and one more step profiled with the device time of B7's and B8's
   backward kernels (by name), no device time under B8's former plain
   backward's label, after which every parameter's gradient must be
   non-zero; one AdamW
   step of granite-moe-3b-a800m, qwen2-vl-7b and whisper-large-v3 at 2
   layers and full width (B7's backward once an attention layer), every
   gradient non-zero; the loss and every
   gradient of 2-layer f32 copies of stablelm-3b and mamba2-780m on the
   card (B7's and B8's f32 backward kernels once a layer) against the
   CPU's plain autograd (``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_TOL``); why jamba-v0.1-52b trains only on the CPU; and
   checkpoints: ``run_with_restarts`` with an injected failure and
   ``train(..., ckpt_dir=)`` run twice, each equal to an uninterrupted
   run bit for bit.  Phases 14 and 15 also time, in turns in one process,
   the launchers' one-rank path (the step under the rules of the host
   mesh, plain tensors) against the same step built without rules:
   llama3-8b's decode steps (alternating within two generations whose
   tokens must be ``generate``'s) and stablelm-3b's warm train step;
16. launch: the launchers' CLIs as children of this script under torchrun
   (``python -m torch.distributed.run --standalone --nproc_per_node 1``),
   each on one NCCL rank started from torchrun's environment on cuda:0
   (the mesh line they print says so): ``-m repro_torch.launch.train``
   on stablelm-3b at full size (1 x 4,096, 3 steps on the repeated first
   batch), its losses within ``LAUNCH_LOSS_REL`` of phase 15's first
   three and B7 launched twice a layer a step; ``-m
   repro_torch.launch.serve`` on llama3-8b (4 x 2,000 prompts, 32
   tokens), its tokens equal to phase 14's and B7 launched once a layer;
   and ``launch.train --ckpt-dir`` on mamba2-780m at smoke size saving
   at step 2 in a child, resumed on to step 4 in this process, its
   losses within ``LAUNCH_CKPT_REL`` of an uninterrupted run's; each
   child's wall time printed;
17. distributed: the distributed layer on a one-rank NCCL group that
   ``make_host_mesh()`` starts (and the phase destroys).  Context-parallel
   decode at the reference's long_500k (524,288 positions, batch 1) at
   jamba-v0.1-52b's widths (32 heads of 128, bf16), the first 500,000
   valid: ``cp_decode_attention`` against ``cp_decode_reference`` within
   ``CP_TOL``, then the local part over 4 and 8 slices (one or two with no
   valid key) combined over the slice dim against one slice within
   ``CP_F32_TOL``, each timed beside the bound of reading k and v once;
   ``pipeline_apply`` at one stage over a llama3-8b gated MLP block (4 x
   2,000 x 4,096 bf16, 4 microbatches), equal to the block microbatch by
   microbatch bit for bit and to the whole batch within ``PIPE_TOL``;
   ``compress_tree`` over 3 steps of error feedback on mamba2-780m's
   gradient-shaped f32 tree (3.1 GB), every residual within half its
   leaf's step, the first two layers' payloads and residuals equal to the
   CPU's bit for bit, ``compressed_psum`` equal to ``dequantize(quantize(g
   + r))``, GB/s printed; mamba2-780m's params saved and restored as
   DTensors on the card (``restore(shardings=)``), bit for bit, the same
   global norm, seconds and bytes printed; and every arch's tp-16 specs
   divisible on both production meshes;
18. dryrun: the dry run (``launch.dryrun``) in a child process with no
   card, within ``DRYRUN_TIMEOUT_S``: llama3-8b train_4k and decode_32k
   and jamba-v0.1-52b long_500k on the fake 256-rank pod16x16 mesh and
   llama3-8b decode_32k on the 512-rank pod2x16x16, each cell's
   per-device FLOPs, bytes, collective bytes by kind, memory and
   roofline (H100 data-sheet constants) printed, any ``error`` failing
   the run; then one-rank cells of the steps phases 14 and 15 time
   (stablelm-3b training 1 x 4,096, llama3-8b prefilling 4 x 2,000), each
   cell's roofline bound beside the measured warm median as a share.

The data is made from ``--seed`` with numpy, with the column domains of
the SSB and TPC-H specifications and MNIST's shape.  The second-to-last line is the kernels'
JSON summary; the last is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet (HBM3)
FP32_FLOPS_PER_S = 67e12         # H100 SXM data sheet, outside tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM data sheet, dense tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM data sheet, dense tensor cores
OPS_RATE = {"f32": FP32_FLOPS_PER_S, "bf16": BF16_FLOPS_PER_S,
            "tf32": TF32_FLOPS_PER_S}

# the dry run's cells (arch, shape, multi-pod) on the production meshes,
# and its one-rank cells (arch, (name, seq, batch, kind), the measured
# step they bound: phase lm's prefill or phase train's step)
DRYRUN_CELLS = (("llama3-8b", "train_4k", False),
                ("llama3-8b", "decode_32k", False),
                ("jamba-v0.1-52b", "long_500k", False),
                ("llama3-8b", "decode_32k", True))
DRYRUN_ONE_RANK = (
    ("stablelm-3b", ("train_1x4096", 4_096, 1, "train"),
     "stablelm-3b train step"),
    ("llama3-8b", ("prefill_4x2000", 2_000, 4, "prefill"),
     "llama3-8b prefill"))
DRYRUN_TIMEOUT_S = 90
# warm medians (s) that phases lm and train measure, for the dry run's
# one-rank cells
MEASURED: dict = {}
# phase lm's served tokens and phase train's losses, by arch, which phase
# launch's children must reproduce
RESULTS: dict = {}
# phase `launch`: the launchers' CLIs under torchrun, one NCCL rank each
LAUNCH_TRAIN_ARCH, LAUNCH_TRAIN_STEPS = "stablelm-3b", 3
LAUNCH_SERVE_ARCH = "llama3-8b"
LAUNCH_CKPT_ARCH = "mamba2-780m"
LAUNCH_LOSS_REL = 1e-3
LAUNCH_CKPT_REL = 1e-5
LAUNCH_CHILD_TIMEOUT_S = 240
LAUNCH_MESH = "on cuda:0: a 1-rank nccl group, started from env://"
# the launchers' one-rank decode step against the step without rules, in
# turns step by step over this many generations (a whole generation's
# decode moved 54-74 ms a token from run to run on the card)
TURNS_DECODE_ROUNDS = 2

SSB_LINEORDER_ROWS = 59_986_214  # SSB scale factor 10
SSB_DATE_ROWS = 2_556            # 1992-01-01 .. 1998-12-30
TPCH_LINEITEM_ROWS = 6_001_215   # TPC-H scale factor 1
TPCH_ORDERS_ROWS = 1_500_000
MNIST_ROWS, MNIST_FEATURES = 60_000, 784   # MNIST's training set
GLM_JOBS, GLM_EPOCHS, GLM_MINIBATCH = 8, 5, 16
# a model too wide for B5's ring: RCV1's 47,236 features (Lewis et al.,
# JMLR 2004) with 74 term draws a row, rcv1.binary's mean count of terms
# (LIBSVM binary collection; a term drawn twice counts once), each row a
# cosine-normalised TF-IDF vector as RCV1's are, stored dense and cut to
# 4,096 rows, 4 jobs, one epoch
WIDE_ROWS, WIDE_FEATURES, WIDE_TERMS, WIDE_JOBS = 4_096, 47_236, 74, 4
# and news20.binary's 1,355,191 features and 455 term draws (Keerthi &
# DeCoste, JMLR 2005; the LIBSVM binary collection), cut the same way to
# 1,024 rows: 5.55 GB
NEWS20_ROWS, NEWS20_FEATURES, NEWS20_TERMS = 1_024, 1_355_191, 455
# the wide searches' largest learning rate: z = <a, x> reaches O(1)
# within the epoch, so each step's d depends on every block's dot sums
WIDE_LR = 20.0
STREAM_ROWS = 1 << 28            # 1 GiB of int32: far past the 50 MB L2
MIB = 1 << 20
# the SGD kernel sums in another order than its plain version and nvcc
# contracts multiply-adds into FMAs: weights agree within this, not bitwise
SGD_TOL = dict(rtol=1e-4, atol=1e-5)
LM_ARCHS = ("llama3-8b", "stablelm-3b", "mamba2-780m",
            "granite-moe-3b-a800m", "qwen2-vl-7b", "llama4-scout-17b-a16e",
            "jamba-v0.1-52b", "whisper-large-v3", "granite-8b",
            "internlm2-20b")
LM_BATCH, LM_PROMPT_LEN, LM_GEN_LEN = 4, 2_000, 32
# whisper's decoder context is 448 positions (its published
# max_target_positions): a 416-token prompt and 32 greedy tokens fill it,
# against its 1,500 frames (30 s of audio)
LM_PROMPT_LEN_OF = {"whisper-large-v3": 416}
LM_WARM_RUNS = 3
# the profiled run generates 8 tokens (a prefill and 7 decode steps): the
# profiler's own bookkeeping of a 32-token run took 67-86 s a model; it
# runs for one dense and one MoE model only, since a profile took 5-29 s
# a model and the ten of them 185 s of a run that reached 960 s
LM_PROFILE_TOKENS = 8
LM_PROFILE_ARCHS = ("llama3-8b", "granite-moe-3b-a800m")
# the moe, hybrid and vlm families and the two dense models added after
# them take one warm run each, which keeps the script inside its time
LM_WARM_RUNS_OF = {"granite-moe-3b-a800m": 1, "qwen2-vl-7b": 1,
                   "llama4-scout-17b-a16e": 1, "jamba-v0.1-52b": 1,
                   "granite-8b": 1, "internlm2-20b": 1}
# depth cuts, and why: one 80 GB card, no model parallelism in the port
LM_DEPTH = {
    "llama4-scout-17b-a16e": (8, "48 layers of bf16 weights are 214 GB"),
    "jamba-v0.1-52b": (8, "32 layers of bf16 weights are 104 GB; 8 is "
                          "one period of its schedule"),
}
# the f32 copy of the teacher-forced check, where the served depth's does
# not fit: llama4-scout's 8 layers are 79 GB in f32, internlm2-20b's 48
# layers 79 GB too (24 of them and its embeddings take 42 GB)
LM_F32_DEPTH = {"llama4-scout-17b-a16e": 4, "internlm2-20b": 24}
LM_CHECK_LEN = 512               # the 2-layer card-vs-CPU prompt
# the MoE models' card-vs-CPU check: rows of LM_CHECK_LEN tokens in f32,
# compared where every routing decision agrees; the experts must agree
# wherever the CPU's boundary gap (k-th less (k+1)-th probability)
# exceeds LM_ROUTE_MARGIN, far above f32 noise on the same weights
LM_MOE_CHECK_ROWS = 2
LM_ROUTE_MARGIN = 1e-5
# the flash-attention kernel sums in another order than its dense plain
# version (cuBLAS): f32 within 2e-5; in bf16 within the reference's own
# bf16 tolerance (tests/test_kernels_attention_ssd.py)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# B7's backward kernel against plain_backward, of each gradient's largest
# magnitude: f32 sums in another order; in bf16 the kernel rounds P and dS
# for its products where the plain version rounds the unnormalised p
ATTN_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the SSD kernel against its plain version: f32 sums in another order;
# a bf16 y is one rounding of such an f32 value (2**-6 covers one ulp)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
# B8's backward kernel against plain_backward, of each gradient's largest
# magnitude: f32 sums in another order (the plain version in f64: under
# strong decays the f32 one's cumsum of the log-decays costs it 1e-5 to
# 2e-4 of a gradient); in bf16 the kernel splits its f32 operands in two
# and rounds dx, db and dc
SSD_GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bf16 models on two paths: every bf16 product rounds on its own path
# (cuBLAS picks other tilings for a 1-token decode than for a prefill, the
# CPU sums in another order), and a flipped rounding travels through 32-48
# random layers; every bound is a fraction of the largest |logit|.  In
# bf16 the teacher-forced identity is a gross-fault check (a wrong cache
# position or a skipped layer moves logits by their own size); its sharp
# form runs on an f32 copy of the weights, at the reference's own 1e-3
TF_TOL = 1e-1
TF_TOL_F32 = 1e-3
CARD_CPU_TOL = 2e-2
# phase `train`: the reference's train_4k sequence (SHAPES["train_4k"]);
# its global batch of 256 is cut to what one 80 GB card holds with the
# full AdamW state: stablelm-3b's 2.80 B params x (2 + 2 + 12) bytes of
# bf16 params and grads and f32 master, m and v are 45 GB before
# activations, so batch 1; mamba2-780m's 0.78 B take 12.5 GB, batch 4
TRAIN_SEQ = 4_096
TRAIN_FULL = {"stablelm-3b": 1, "mamba2-780m": 4}
TRAIN_STEPS = 6
# the other families take one AdamW step at 2 layers and full width (an
# encoder-decoder 2 encoder and 2 decoder layers, over its 448-position
# decoder context, as many frames as tokens as the reference's launcher
# draws them); batch 1
TRAIN_CUT = ("granite-moe-3b-a800m", "qwen2-vl-7b", "whisper-large-v3")
TRAIN_SEQ_OF = {"whisper-large-v3": 448}
# the 2-layer full-width f32 card-vs-CPU check of the loss and every
# gradient: the card's B7 (split TF32) and B8 forwards differ from the
# plain ones by f32 rounding (2e-5 and 1e-4 of their outputs), which
# the backward carries into every gradient
TRAIN_CHECK_LEN = 256
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
# phase `distributed`: context-parallel decode at the reference's
# long_500k decode (524,288 positions, its stated use) at
# jamba-v0.1-52b's widths (32 heads of 128), k and v expanded to the
# query heads, the first 500,000 positions valid, on one rank; then the
# local part over 4 and 8 slices, with positions 131,072-262,143 invalid
# so that a slice holds no valid key, combined over the slice dim
DIST_ARCH = "jamba-v0.1-52b"
CP_SEQ = 524_288
CP_VALID = 500_000
CP_GAP = (131_072, 262_144)
CP_SLICES = (4, 8)
CP_TOL = 1e-2           # bf16 outputs, of the largest magnitude
CP_F32_TOL = 1e-5       # f32 combines of slices, of the largest magnitude
# the pipeline's stage: one llama3-8b gated MLP block (d_ff 14,336) with
# its RMS norm and residual, over 4 x 2,000 x 4,096 bf16 in 4 microbatches
PIPE_ARCH = "llama3-8b"
PIPE_BATCH, PIPE_SEQ, PIPE_MICRO = 4, 2_000, 4
PIPE_TOL = 1e-2         # against the block over the whole batch, of the max
# compression and restore: mamba2-780m's parameters at full width
COMP_ARCH = "mamba2-780m"
COMP_STEPS = 3
COMP_CPU_LAYERS = ("layers.0.", "layers.1.")


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------- #
# data, from the specifications' column domains

def _retailprice(partkey):
    """TPC-H / SSB P_RETAILPRICE in cents, from the part key."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def make_ssb(rows: int, seed: int):
    """lineorder (orderdate, quantity, discount, extendedprice) and the date
    dimension.  Order dates are uniform over the first 2,556 - 151 days
    (TPC-H's O_ORDERDATE rule, which SSB keeps); the date table's key is
    named ``orderdate`` as well, because the join DSL joins on one name."""
    r = np.random.default_rng(seed)
    start = datetime.date(1992, 1, 1)
    days = [start + datetime.timedelta(d) for d in range(SSB_DATE_ROWS)]
    datekey = np.asarray([d.year * 10000 + d.month * 100 + d.day
                          for d in days], np.int32)
    order_day = r.integers(0, SSB_DATE_ROWS - 151, rows)
    quantity = r.integers(1, 51, rows, dtype=np.int32)
    discount = r.integers(0, 11, rows, dtype=np.int32)
    partkey = r.integers(1, 800_001, rows)              # 200,000 * (1 + log2 10)
    extendedprice = (quantity * _retailprice(partkey)).astype(np.int32)
    lineorder = {"orderdate": datekey[order_day], "quantity": quantity,
                 "discount": discount, "extendedprice": extendedprice}
    return {"lineorder": lineorder, "date": {"orderdate": datekey}}


def ssb_query(Q):
    return (Q.scan("lineorder").filter("orderdate", 19930101, 19931231)
            .filter("discount", 1, 3).filter("quantity", 1, 24)
            .join(Q.scan("date"), on="orderdate").sum("extendedprice"))


def ssb_oracle(tables) -> int:
    lo = tables["lineorder"]
    m = ((lo["orderdate"] >= 19930101) & (lo["orderdate"] <= 19931231)
         & (lo["discount"] >= 1) & (lo["discount"] <= 3)
         & (lo["quantity"] >= 1) & (lo["quantity"] <= 24)
         & np.isin(lo["orderdate"], tables["date"]["orderdate"]))
    return int(lo["extendedprice"][m].astype(np.int64).sum())


# a float filter on lineorder's price in dollars: both bounds round when
# cast to float32, as the TPU kernel casts them to the column's type
FLOAT_RANGE = (1000.05, 30000.3)


def ssb_price_dollars(tables) -> np.ndarray:
    """lineorder's extendedprice in dollars, as a float32 column."""
    return (tables["lineorder"]["extendedprice"] / 100).astype(np.float32)


def make_tpch(lineitem_rows: int, orders_rows: int, seed: int):
    """orders (orderkey, totalprice) and lineitem (orderkey, quantity).
    Order keys are sparse as in the specification (the first 8 of every 32
    keys); each order has 1 to 7 lines, cut or topped up to the exact row
    count."""
    r = np.random.default_rng(seed + 1)
    i = np.arange(orders_rows)
    orderkey = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    totalprice = r.integers(85_771, 55_528_517, orders_rows, dtype=np.int32)
    per_order = r.integers(1, 8, orders_rows)
    order_idx = np.repeat(i, per_order)
    if order_idx.size >= lineitem_rows:
        order_idx = order_idx[:lineitem_rows]
    else:
        extra = r.integers(0, orders_rows, lineitem_rows - order_idx.size)
        order_idx = np.concatenate([order_idx, np.sort(extra)])
    quantity = r.integers(1, 51, lineitem_rows, dtype=np.int32)
    tables = {"orders": {"orderkey": orderkey, "totalprice": totalprice},
              "lineitem": {"orderkey": orderkey[order_idx],
                           "quantity": quantity}}
    return tables, order_idx


def tpch_query(Q):
    return (Q.scan("orders").join(Q.scan("lineitem").filter("quantity", 1, 1),
                                  on="orderkey").sum("totalprice"))


def tpch_lines_query(Q):
    return (Q.scan("lineitem").join(Q.scan("orders"), on="orderkey")
            .sum("totalprice"))


def tpch_lines_oracle(tables, order_idx) -> int:
    lines = np.bincount(order_idx,
                        minlength=tables["orders"]["orderkey"].shape[0])
    return int((lines * tables["orders"]["totalprice"].astype(np.int64))
               .sum())


def tpch_oracle(tables, order_idx) -> int:
    keep = tables["lineitem"]["quantity"] == 1
    lines = np.bincount(order_idx[keep], minlength=order_idx.max() + 1)
    price = tables["orders"]["totalprice"].astype(np.int64)
    return int((lines[:price.size] * price).sum())


def make_mnist_like(rows: int, features: int, seed: int):
    """An MNIST-shaped training set: ``features`` float32 pixel columns in
    [0, 1], about 19% of them inked as in MNIST, and a binary label drawn
    from a planted logistic model over the pixels."""
    r = np.random.default_rng(seed + 2)
    ink = r.random((rows, features), dtype=np.float32) < 0.19
    a = np.where(ink, r.random((rows, features), dtype=np.float32),
                 np.float32(0))
    z = a @ r.normal(size=features)
    z *= 3.0 / z.std()
    label = (r.random(rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    cols = {f"px{j}": a[:, j] for j in range(features)}
    cols["label"] = label
    return {"mnist": cols}, a, label


def text_rows(rows: int, features: int, terms: int, gen, dev):
    """A text-shaped training set on ``dev``: each row draws ``terms``
    term ids from a Zipf law over the features (the ranks spread over
    the columns at random), holds each drawn term's IDF (a binary term
    frequency) and is scaled to unit L2 norm; the label says whether a
    planted linear score is above its median."""
    import torch
    p = 1.0 / torch.arange(1, features + 1, dtype=torch.float64, device=dev)
    p /= p.sum()
    rank = torch.multinomial(p, rows * terms, replacement=True, generator=gen)
    col = torch.randperm(features, generator=gen, device=dev)[rank]
    a = torch.zeros((rows, features), device=dev)
    # a term drawn twice in a row writes the same IDF twice
    a.scatter_(1, col.view(rows, terms),
               (-torch.log(p[rank])).float().view(rows, terms))
    a /= a.norm(dim=1, keepdim=True)
    score = a @ torch.randn(features, generator=gen, device=dev)
    return a, (score > score.median()).float()


def sgd_masked_plain(a, b, xs0, lrs, l2s, keep, minibatch):
    """One epoch of logistic SGD in plain PyTorch with z taken over the
    features where ``keep`` is 1 only: the controls that a kernel which
    dropped a block's dot sums, or all of them, would match."""
    import torch
    out = []
    for x, lr, l2 in zip(xs0, lrs.tolist(), l2s.tolist()):
        for i in range(0, a.shape[0], minibatch):
            ai, bi = a[i:i + minibatch], b[i:i + minibatch]
            d = (ai @ (x * keep)).sigmoid() - bi
            x = x - lr * (ai.T @ d / minibatch + 2.0 * l2 * x)
        out.append(x)
    return torch.stack(out)


def glm_query(Q, HyperParams):
    grid = [HyperParams(0.1 / (i + 1), 0.001 * i) for i in range(GLM_JOBS)]
    return Q.scan("mnist").train_glm(
        [f"px{j}" for j in range(MNIST_FEATURES)], "label", grid,
        kind="logreg", epochs=GLM_EPOCHS)


def multi_join_oracle(s: np.ndarray, l: np.ndarray):
    """The (l_idx, s_idx) pair list of ``s ⋈ l`` in (probe row, bucket
    position) order, from a stable sort of the build side: numpy's own
    sort and searches, independent of the port."""
    order = np.argsort(s, kind="stable")
    ss = s[order]
    lo = np.searchsorted(ss, l, side="left")
    cnt = np.searchsorted(ss, l, side="right") - lo
    total = int(cnt.sum())
    l_idx = np.repeat(np.arange(l.size), cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    s_idx = order[np.repeat(lo, cnt) + within]
    return l_idx.astype(np.int32), s_idx.astype(np.int32), total


# --------------------------------------------------------------------------- #
# timing

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``reps`` calls, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 200) -> float:
    """Mean milliseconds of device time a call of ``fn`` takes: the self
    times of its kernels and copies under ``torch.profiler`` over ``reps``
    calls, after a warm-up call.  The host's cost of a call (a wrapper's
    checks, allocations and launches) is left out; ``time_ms`` measures
    that instead wherever it exceeds the kernel's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the card's profiler has returned a session without device events
    # now and then; such a session is taken again, up to three times
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / reps
        log(f"  the profiler traced no device time (session {attempt + 1} "
            "of 3)")
    raise AssertionError("the profiler traced no device time")


def time3_ms(name: str, fn, reps: int = 200) -> float:
    """Three ``device_ms`` timings of ``reps`` launches each, their spread
    logged beside the time a call takes dispatched from the host one by
    one (``time_ms``); returns the median device time."""
    t = sorted(device_ms(fn, reps) for _ in range(3))
    host = time_ms(fn, reps=reps)
    log(f"  {name} spread: {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} ms device "
        f"time a call (min / median / max of 3 x {reps} launches); "
        f"{host:.4f} ms a call dispatched from the host")
    return t[1]


def max_abs_err(got, want) -> float:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return float(err)


# --------------------------------------------------------------------------- #
# phases

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()
    log(line)
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.function(next(s for s, (src, _) in _build.SIGNATURES.items()
                             if src == name))
    log(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in paths.values())})")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev, ssb_tables, tpch_tables):
    """Every kernel against its plain version at the main path's shapes
    (and a small ragged length), timed.  Returns the JSON rows."""
    import torch
    from repro_torch.core import join as join_core
    from repro_torch.kernels.join import join as jk
    from repro_torch.kernels.join import ref as join_ref
    from repro_torch.kernels.selection import selection as sk

    lo = ssb_tables["lineorder"]
    orderdate = torch.from_numpy(lo["orderdate"]).to(dev)
    datekeys = torch.from_numpy(ssb_tables["date"]["orderdate"]).to(dev)
    rows = []

    def check(name, kernel, plain):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        return err

    # B1 at the eager filter's shape: the whole orderdate column, block
    # 1024 (what engine.select_range passes); 59,986,214 is ragged
    n = orderdate.shape[0]
    r = np.random.default_rng(5)
    small = torch.from_numpy(r.integers(0, 100, 1_000_003,
                                        dtype=np.int32)).to(dev)
    check("select_range", lambda: sk.select(small, 10, 60, block=1024),
          lambda: sk.select_plain(small, 10, 60, block=1024))
    b1 = dict(kernel=lambda: sk.select(orderdate, 19930101, 19931231,
                                       block=1024),
              plain=lambda: sk.select_plain(orderdate, 19930101, 19931231,
                                            block=1024))
    err = check("select_range", b1["kernel"], b1["plain"])
    nb = -(-n // 1024)
    rows.append(dict(
        name="select_range", route="cuda",
        source="src/repro_torch/kernels/csrc/selection.cu",
        replaces="src/repro/kernels/selection/selection.py:37",
        max_abs_err=err, ms=time_ms(b1["kernel"]),
        plain_ms=time_ms(b1["plain"], reps=5),
        bytes=4 * n + 4 * n + 4 * nb, library_ms=None,
        shape=f"x=({n},) int32, block=1024"))

    # B1's float32 entry at the same length: lineorder's extendedprice in
    # dollars (phase shard's float filter), bounds that round to float32;
    # and a ragged column with NaN rows, which match nothing
    price = torch.from_numpy(ssb_price_dollars(ssb_tables)).to(dev)
    small_f = r.uniform(-1, 1, 1_000_003).astype(np.float32)
    small_f[::97] = np.nan
    small_f = torch.from_numpy(small_f).to(dev)
    check("select_f32", lambda: sk.select(small_f, 0.1, 0.3, block=1024),
          lambda: sk.select_plain(small_f, 0.1, 0.3, block=1024))
    f1 = dict(kernel=lambda: sk.select(price, *FLOAT_RANGE, block=1024),
              plain=lambda: sk.select_plain(price, *FLOAT_RANGE,
                                            block=1024))
    err = check("select_f32", f1["kernel"], f1["plain"])
    rows.append(dict(
        name="select_f32", route="cuda",
        source="src/repro_torch/kernels/csrc/selection.cu",
        replaces="src/repro/kernels/selection/selection.py:37",
        max_abs_err=err, ms=time_ms(f1["kernel"]),
        plain_ms=time_ms(f1["plain"], reps=5),
        bytes=4 * n + 4 * n + 4 * nb, library_ms=None,
        shape=f"x=({n},) float32, block=1024"))

    # B2 at the fused probe's shape: the sorted date keys against every
    # lineorder row (batch mode probes the whole column)
    s_sorted, _ = join_ref.bucket_build(datekeys)
    keys_small = r.integers(19920000, 19990000, 100_003, dtype=np.int32)
    keys_small[-3:] = (2 ** 31 - 1, -2 ** 31, -1)
    keys_small = torch.from_numpy(keys_small).to(dev)
    check("probe_counts", lambda: jk.probe_counts(s_sorted, keys_small),
          lambda: join_ref.bucket_probe(s_sorted, keys_small))
    b2_kernel = lambda: jk.probe_counts(s_sorted, orderdate)   # noqa: E731
    b2_plain = lambda: join_ref.bucket_probe(s_sorted,         # noqa: E731
                                             orderdate)
    err = check("probe_counts", b2_kernel, b2_plain)

    # B2 at the eager duplicate-keyed join's shape: the filtered lineitem
    # keys cut into HT_CAPACITY pass blocks with distinct negative pads, as
    # join_distributed_multi builds them, against every orders key
    cap = join_core.HT_CAPACITY
    keep = tpch_tables["lineitem"]["quantity"] == 1
    build = torch.from_numpy(tpch_tables["lineitem"]["orderkey"][keep]).to(dev)
    okeys = torch.from_numpy(tpch_tables["orders"]["orderkey"]).to(dev)
    n_passes = -(-build.shape[0] // cap)
    padded = join_core._pad_build(build, n_passes)
    blocks = [join_ref.bucket_build(padded[p * cap:(p + 1) * cap])[0]
              for p in range(n_passes)]
    tpch_kernel = lambda: [t for b in blocks                  # noqa: E731
                           for t in jk.probe_counts(b, okeys)]
    tpch_plain = lambda: [t for b in blocks                   # noqa: E731
                          for t in join_ref.bucket_probe(b, okeys)]
    err = max(err, check("probe_counts", tpch_kernel, tpch_plain))
    tpch_bound = n_passes * (4 * cap + 12 * okeys.shape[0]) \
        / HBM_BYTES_PER_S * 1e3

    def tpch_library():
        for b in blocks:
            torch.searchsorted(b, okeys, side="left")
            torch.searchsorted(b, okeys, side="right")

    log(f"  probe_counts  {n_passes} TPC-H pass blocks of ({cap},) with "
        f"{n_passes * cap - build.shape[0]} negative pads, keys="
        f"({okeys.shape[0]},): kernel {time_ms(tpch_kernel, reps=5):.4f} ms,"
        f" bound {tpch_bound:.4f} ms, plain "
        f"{time_ms(tpch_plain, reps=5):.4f} ms, library "
        f"{time_ms(tpch_library, reps=5):.4f} ms (two torch.searchsorted a "
        "block) for all passes, bit-identical")

    def library_b2():
        torch.searchsorted(s_sorted, orderdate, side="left")
        torch.searchsorted(s_sorted, orderdate, side="right")

    rows.append(dict(
        name="probe_counts", route="cuda",
        source="src/repro_torch/kernels/csrc/join.cu",
        replaces="src/repro/kernels/join/join.py:189",
        max_abs_err=err, ms=time_ms(b2_kernel), plain_ms=time_ms(b2_plain),
        bytes=4 * s_sorted.shape[0] + 4 * n + 8 * n,
        library_ms=time_ms(library_b2),
        shape=f"s_sorted=({s_sorted.shape[0]},), keys=({n},) int32, "
              f"{jk.probe_counts_route(s_sorted.shape[0])} route"))

    # B2's sampled route at the shape the fused pipeline gives it in phase
    # tpch (lineitem joined with orders: 1,500,000 sorted order keys, past
    # the shared-memory budget, against every lineitem row), and at the
    # eager duplicate-keyed join's whole filtered lineitem against orders
    lkeys = torch.from_numpy(tpch_tables["lineitem"]["orderkey"]).to(dev)
    ordered, _ = join_ref.bucket_build(okeys)
    filtered, _ = join_ref.bucket_build(build)
    for t in (ordered, filtered):
        if jk.probe_counts_route(t.shape[0]) != "sampled":
            raise AssertionError(f"a table of {t.shape[0]} keys should take "
                                 "B2's sampled route")
    big_kernel = lambda: jk.probe_counts(ordered, lkeys)      # noqa: E731
    big_plain = lambda: join_ref.bucket_probe(ordered, lkeys)  # noqa: E731
    err = check("probe_counts", big_kernel, big_plain)
    f_kernel = lambda: jk.probe_counts(filtered, okeys)       # noqa: E731
    err = max(err, check("probe_counts", f_kernel,
                         lambda: join_ref.bucket_probe(filtered, okeys)))

    def library_of(table, keys):
        def run():
            torch.searchsorted(table, keys, side="left")
            torch.searchsorted(table, keys, side="right")
        return run

    f_bound = (4 * filtered.shape[0] + 12 * okeys.shape[0]) \
        / HBM_BYTES_PER_S * 1e3
    log(f"  probe_counts  the filtered lineitem ({filtered.shape[0]},) "
        f"sorted, keys=({okeys.shape[0]},), sampled route: kernel "
        f"{time_ms(f_kernel):.4f} ms, bound {f_bound:.4f} ms, library "
        f"{time_ms(library_of(filtered, okeys)):.4f} ms (two "
        "torch.searchsorted), bit-identical")
    rows.append(dict(
        name="probe_counts_sampled", route="cuda",
        source="src/repro_torch/kernels/csrc/join.cu",
        replaces="src/repro/kernels/join/join.py:189",
        max_abs_err=err, ms=time_ms(big_kernel), plain_ms=time_ms(big_plain),
        bytes=4 * ordered.shape[0] + 12 * lkeys.shape[0],
        library_ms=time_ms(library_of(ordered, lkeys)),
        shape=f"s_sorted=({ordered.shape[0]},), keys=({lkeys.shape[0]},) "
              "int32, sampled route"))

    # B4 at the eager unique join's shape: the filtered lineorder keys
    # against the date table built the way join_distributed builds it
    m = ((lo["orderdate"] >= 19930101) & (lo["orderdate"] <= 19931231)
         & (lo["discount"] >= 1) & (lo["discount"] <= 3)
         & (lo["quantity"] >= 1) & (lo["quantity"] <= 24))
    probe_keys = torch.from_numpy(lo["orderdate"][m]).to(dev)
    padded = join_core._pad_build(datekeys, 1)
    ts = 4 * join_core.HT_CAPACITY
    ht_k, ht_v, _ = join_ref.build_table(padded, ts, 8)
    check("hash_probe",
          lambda: jk.probe(ht_k, ht_v, keys_small[:100_001], probe_depth=8),
          lambda: jk.probe_plain(ht_k, ht_v, keys_small[:100_001],
                                 probe_depth=8))
    b4_kernel = lambda: jk.probe(ht_k, ht_v, probe_keys,     # noqa: E731
                                 probe_depth=8)
    b4_plain = lambda: jk.probe_plain(ht_k, ht_v,             # noqa: E731
                                      probe_keys, probe_depth=8)
    err = check("hash_probe", b4_kernel, b4_plain)
    n4 = probe_keys.shape[0]
    rows.append(dict(
        name="hash_probe", route="cuda",
        source="src/repro_torch/kernels/csrc/join.cu",
        replaces="src/repro/kernels/join/join.py:48",
        max_abs_err=err, ms=time3_ms("hash_probe", b4_kernel),
        plain_ms=time_ms(b4_plain),
        bytes=8 * ts + 4 * n4 + 4 * n4 + 4 * -(-n4 // 4096),
        library_ms=None,
        shape=f"table=2x({ts},), keys=({n4},) int32, depth 8"))

    for row in rows:
        finish_row(row)
    return rows


def finish_row(row, agree: str = "bit-identical"):
    """Turn a kernel row's ``bytes`` (and ``ops``, operations of the type
    ``ops_type``, f32 unless given) into its bound — the larger of bytes
    over the memory rate and operations over the data sheet's rate for
    their type — and log the row."""
    t_bytes = row.pop("bytes") / HBM_BYTES_PER_S * 1e3
    rate = OPS_RATE[row.pop("ops_type", "f32")]
    t_ops = row.pop("ops", 0) / rate * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    lib = row["library_ms"]
    log(f"  {row['name']:13s} {row['shape']}: kernel {row['ms']:.4f} ms,"
        f" bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({row['bound_ms'] / row['ms']:.1%} of the rate), plain "
        f"{row['plain_ms']:.4f} ms"
        + (f", library {lib:.4f} ms" if lib is not None else "")
        + f", {agree}")


def equals(want):
    """A ``_run_modes`` check: the value must equal the oracle's."""
    def check(mode, value):
        if value != want:
            raise AssertionError(f"{mode}: {value} != oracle {want}")
        return f"value {value} (= oracle)"
    return check


def _run_modes(ex, q, modes, check, counts_by_mode, reps=11, **kw):
    """Run ``q`` once per mode with the launch counters zeroed just before
    and read just after, ``check(mode, value)`` the value (it raises, or
    returns what to log), then time ``reps`` warm runs (host clock around
    work that ends in a synchronize), checking each.  Returns mode ->
    (first-run seconds, sorted warm seconds, first run's value)."""
    import torch
    from repro_torch.kernels import _build
    times = {}
    for mode in modes:
        run = lambda: ex.execute(q, mode=mode,                  # noqa: E731
                                 **(kw if mode == "stream" else {}))
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts_by_mode[mode] = dict(_build.LAUNCHES)
        said = check(mode, res.value)
        warm = warm_runs(run, lambda v: check(f"{mode} (warm)", v), reps)
        times[mode] = (first, warm, res.value)
        log(f"  {mode:6s}: {said}; first run {first * 1e3:.3f} ms, "
            f"{spread(warm)}; launches {counts_by_mode[mode]}")
        log("    " + profile_once(run))
    return times


def warm_runs(run, check, reps=11):
    """Sorted seconds of ``reps`` runs of ``run`` (host clock around work
    that ends in a synchronize), each result's value checked."""
    import torch
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        value = run().value
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(value)
    return sorted(warm)


def spread(warm) -> str:
    return (f"warm median {warm[len(warm) // 2] * 1e3:.3f} ms [min "
            f"{warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f}] over "
            f"{len(warm)} runs")


def _kernel_name(key: str) -> str:
    """A kernel's function name from its profiler key, with its first
    template argument where that is true or false (the SSD's shared
    passes, which the backward runs for the entering states)."""
    head = key.replace("(anonymous namespace)", "").split("(")[0]
    name = head.split("<")[0].split("::")[-1].split()[-1]
    first = head.split("<", 1)[1].split(",")[0].strip(" >") \
        if "<" in head else ""
    return name + (f"<{first}>" if first in ("true", "false") else "")


def profile_once(run, top: int = 5, labels=(), kernels=(),
                 require=()) -> str:
    """One more warm run under ``torch.profiler``: the device's busy time
    (the sum of kernel and copy self times) against the run's wall time,
    and the kernels that took most of it; with ``labels`` (profiler
    ranges: the train step's plain backwards), the device time of the
    torch ops run under each; with ``kernels`` ((range, substring)
    pairs), the device self time of the kernels whose names hold the
    substring (a kernel launched through ctypes runs under no torch op, so
    its range's own count shows none of its time); ``require`` names those
    ranges of ``kernels`` whose kernels must show device time (it raises
    if one shows none).  A range also shows as
    a device-side span (its first kernel to its last, gaps included),
    which the busy time leaves out.  The profiler's own cost lengthens the wall
    time, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = set(labels) | {label for label, _ in kernels}
    dev = [e for e in events if e.device_type == cuda and e.key not in spans]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        return "profile: no device time traced (not measured)"
    dev.sort(key=lambda e: -e.self_device_time_total)
    heads = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
                      f" x{e.count}" for e in dev[:top])
    parts = ""
    for label in labels:
        mine = [e for e in events if e.key == label and e.device_type == cpu]
        us = sum(e.device_time_total for e in mine)
        parts += (f"{label} {us / 1e3:.1f} ms device over "
                  f"{sum(e.count for e in mine)} calls ({us / busy_us:.1%} of "
                  "busy); ")
    for label, sub in kernels:
        mine = [e for e in dev if sub in e.key]
        us = sum(e.self_device_time_total for e in mine)
        if label in require and us <= 0:
            raise AssertionError(f"profile: no device time in {label}'s "
                                 f"kernels ({sub})")
        parts += (f"{label} kernels {us / 1e3:.1f} ms device over "
                  f"{sum(e.count for e in mine)} launches ({us / busy_us:.1%} "
                  "of busy: " + ", ".join(
                      f"{_kernel_name(e.key)[:24]} "
                      f"{e.self_device_time_total / 1e3:.1f}" for e in mine)
                  + "); ")
    return (f"profile: device busy {busy_us / 1e3:.3f} ms of "
            f"{wall_us / 1e3:.3f} ms wall (idle <= "
            f"{1 - busy_us / wall_us:.0%}), {sum(e.count for e in dev)} "
            f"device ops; {parts}top: {heads}")


def phase_ssb(dev, tables):
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q
    t0 = time.perf_counter()
    want = ssb_oracle(tables)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    n = tables["lineorder"]["orderdate"].shape[0]
    log(f"ssb: lineorder {n} rows x 4 int32 columns on the card, catalog "
        f"in {time.perf_counter() - t0:.2f} s; oracle {want}")
    q = ssb_query(Q)
    plan = ex.explain(q)
    log("  plan:\n    " + plan.replace("\n", "\n    "))
    for line in plan.splitlines():
        op = line.strip().split(":")[0]
        if op in ("join", "filter") and "impl=cuda" not in line:
            raise AssertionError(f"{op} is not planned on the kernels: "
                                 f"{line.strip()}")
    if not any(l.strip().startswith("join:") for l in plan.splitlines()):
        raise AssertionError("the date join is not the unique-key join")
    counts = {}
    times = _run_modes(ex, q, ("batch", "stream", "eager"), equals(want),
                       counts, morsel_rows=1 << 22)
    need = {"batch": ("probe_counts",), "stream": ("probe_counts",),
            "eager": ("select", "probe")}
    for mode, kernels in need.items():
        for k in kernels:
            if counts[mode][k] <= 0:
                raise AssertionError(f"{mode} launched no {k} kernel")
    return counts, times


def phase_tpch(dev, tables, order_idx):
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q
    want = tpch_oracle(tables, order_idx)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    q = tpch_query(Q)
    plan = ex.explain(q)
    log(f"tpch: lineitem {tables['lineitem']['orderkey'].shape[0]} rows, "
        f"orders {tables['orders']['orderkey'].shape[0]} rows; oracle "
        f"{want}\n  plan:\n    " + plan.replace("\n", "\n    "))
    lines = [l.strip() for l in plan.splitlines()]
    join = next((i for i, l in enumerate(lines)
                 if l.startswith("join_multi:")), None)
    if join is None or "impl=cuda" not in lines[join]:
        raise AssertionError("the duplicate-keyed join is not join_multi "
                             "on the kernels")
    # the build side is the join's second child: the filtered lineitem
    opt, _ = ex.plan(q.node)
    j = opt.child
    if not (getattr(j.right, "child", None) is not None
            and j.right.child.table == "lineitem"):
        raise AssertionError(f"build side is not the filtered lineitem: "
                             f"{j.right}")
    counts = {}
    _run_modes(ex, q, ("eager", "batch"), equals(want), counts)
    if counts["eager"]["probe_counts"] <= 0:
        raise AssertionError("eager join_multi launched no probe_counts")

    # lineitem joined with orders (the join of TPC-H's order queries): a
    # unique-keyed build side of 1,500,000 keys, past B2's shared-memory
    # budget, which the fused and streamed pipelines probe through B2's
    # sampled route
    q = tpch_lines_query(Q)
    want = tpch_lines_oracle(tables, order_idx)
    log(f"tpch lines: lineitem joined with orders, sum(totalprice); oracle "
        f"{want}\n  plan:\n    " + ex.explain(q).replace("\n", "\n    "))
    lines_counts = {}
    _run_modes(ex, q, ("batch", "stream"), equals(want), lines_counts,
               morsel_rows=1 << 21)
    for mode, c in lines_counts.items():
        if c["probe_counts_sampled"] <= 0:
            raise AssertionError(f"lines {mode} probed 1,500,000 keys "
                                 "without B2's sampled route")
        counts[f"lines {mode}"] = c
    return counts


def timed_once_ms(fn):
    """(result, milliseconds) of one call, CUDA events around it: for the
    plain SGD version, whose one call takes seconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def phase_glm(dev, seed):
    """Hyper-parameter search over the MNIST-shaped set in every mode, the
    SGD kernel against its plain version at that shape, then scoring.
    Returns (launch counts by mode, the kernel's JSON row)."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.kernels.sgd import ref as sgd_ref
    from repro_torch.kernels.sgd import sgd as sgd_kernels
    from repro_torch.query import Executor, HyperParams, Q

    t0 = time.perf_counter()
    tables, a_np, label = make_mnist_like(MNIST_ROWS, MNIST_FEATURES, seed)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    log(f"glm: {MNIST_ROWS} rows x {MNIST_FEATURES} float32 features + "
        f"label ({a_np.nbytes / 1e6:.0f} MB) on the card in "
        f"{time.perf_counter() - t0:.2f} s; {GLM_JOBS} jobs, "
        f"{GLM_EPOCHS} epochs, minibatch {GLM_MINIBATCH}")
    q = glm_query(Q, HyperParams)
    plan = ex.explain(q)
    log("  plan:\n    " + plan.replace("\n", "\n    "))
    if not plan.startswith("train_glm: impl=cuda"):
        raise AssertionError(f"train_glm is not planned on the kernels: "
                             f"{plan.splitlines()[0]}")
    ln2 = float(np.log(2.0))

    def check(mode, value):
        xs, losses = value
        if xs.shape != (GLM_JOBS, MNIST_FEATURES) \
                or not bool(torch.isfinite(xs).all()):
            raise AssertionError(f"{mode}: weights {tuple(xs.shape)} not "
                                 "finite or of the wrong shape")
        if not bool((losses < ln2).all()):
            raise AssertionError(f"{mode}: a loss is not below ln 2: "
                                 f"{losses.tolist()}")
        return ("losses " + ", ".join(f"{v:.4f}" for v in losses.tolist())
                + " (all < ln 2)")

    counts = {}
    runs = _run_modes(ex, q, ("batch", "stream", "eager"), check, counts,
                      morsel_rows=16_384)
    weights = {mode: r[2][0] for mode, r in runs.items()}
    for mode in ("batch", "stream"):
        if not torch.equal(weights[mode], weights["eager"]):
            raise AssertionError(f"{mode} weights differ from eager's")
    log(f"  batch, stream ({-(-MNIST_ROWS // 16_384)} morsels) and eager "
        "weights are bit-identical")

    # the same search under a 64 MiB device budget: the columns that do
    # not fit go to host DRAM and every epoch streams them back
    from repro_torch.kernels import _build
    from repro_torch.query import TierBudgets
    spilled = Executor(catalog_from_arrays(tables, dev), dev,
                       tier_budgets=TierBudgets(device=64 * MIB))
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = spilled.execute(q).value
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts["spilled batch"] = dict(_build.LAUNCHES)
    check("spilled batch", value)
    if not torch.equal(value[0], weights["eager"]):
        raise AssertionError("spilled weights differ from the resident run's")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        spilled.execute(q)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    warm.sort()
    by_tier = {}
    for tier in spilled.last_spill.tiers.values():
        by_tier[tier] = by_tier.get(tier, 0) + 1
    log(f"  spilled (64 MiB device budget): columns by tier {by_tier}; "
        f"weights bit-identical to the resident run's; first run "
        f"{first * 1e3:.3f} ms, warm median {warm[1] * 1e3:.3f} ms [min "
        f"{warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f}] over 3 runs; "
        f"launches {counts['spilled batch']}")
    del spilled
    for mode, c in counts.items():
        if c["sgd"] <= 0:
            raise AssertionError(f"{mode} launched no sgd kernel")

    # B5 against its plain version at the main path's shape: eager mode's
    # one launch over the whole set (60,000 rows need no pad)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(label).to(dev)
    grid = q.node.grid
    lrs = torch.tensor([g.lr for g in grid], dtype=torch.float32, device=dev)
    l2s = torch.tensor([g.l2 for g in grid], dtype=torch.float32, device=dev)
    xs0 = torch.zeros((GLM_JOBS, MNIST_FEATURES), dtype=torch.float32,
                      device=dev)
    kw = dict(minibatch=GLM_MINIBATCH, epochs=GLM_EPOCHS, kind="logreg")
    kernel = lambda: sgd_kernels.sgd(a, b, xs0, lrs, l2s, **kw)  # noqa: E731
    xs_k = kernel()
    xs_p, plain_ms = timed_once_ms(
        lambda: sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw))
    torch.cuda.synchronize()
    if not torch.equal(xs_k, weights["eager"]):
        raise AssertionError("the kernel's weights differ from eager mode's")
    err = float((xs_k - xs_p).abs().max())
    rel = float(((xs_k - xs_p).abs() / xs_p.abs().clamp(min=1e-30)).max())
    if not torch.allclose(xs_k, xs_p, **SGD_TOL):
        raise AssertionError(f"sgd: kernel differs from its plain version "
                             f"beyond {SGD_TOL} (max abs err {err})")
    m, n = a.shape
    steps = GLM_EPOCHS * m // GLM_MINIBATCH
    plan = sgd_kernels.ring_plan(n, GLM_MINIBATCH)
    if sgd_kernels.route(n, GLM_MINIBATCH) != "ring":
        raise AssertionError(f"{n} features take the "
                             f"{sgd_kernels.route(n, GLM_MINIBATCH)} route")
    row = dict(
        name="sgd", route="cuda",
        source="src/repro_torch/kernels/csrc/sgd.cu",
        replaces="src/repro/kernels/sgd/sgd.py:55",
        max_abs_err=err, ms=time_ms(kernel, reps=5, warmup=1),
        plain_ms=plain_ms, library_ms=None,
        # every input read once, the weights written once; 2 FMAs a
        # feature a row a job an epoch (the dot and the gradient)
        bytes=4 * (m * n + m + 2 * GLM_JOBS * n + 2 * GLM_JOBS),
        ops=4 * GLM_JOBS * GLM_EPOCHS * m * n,
        shape=f"a=({m}, {n}) f32, {GLM_JOBS} jobs, {GLM_EPOCHS} epochs, "
              f"minibatch {GLM_MINIBATCH}, ring route, cluster "
              f"{plan.cluster}, {plan.threads} + 32 threads")
    streamed_bytes = 4 * GLM_JOBS * GLM_EPOCHS * m * (n + 1)
    log(f"  sgd: max abs err {err:.3e}, max rel err {rel:.3e} against the "
        f"plain version (tolerance {SGD_TOL}); the dataset streamed once "
        f"per job and epoch is {streamed_bytes / 1e9:.3f} GB, "
        f"{streamed_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory "
        f"rate; each job is a chain of {steps} dependent steps, "
        f"{row['ms'] * 1e3 / steps:.3f} us a step")
    finish_row(row, agree=f"within {SGD_TOL}")
    # every cluster size the ring takes, at this shape (each sums in its
    # own fixed order, so each is held to the plain version)
    sweep = []
    for c in sgd_kernels.CLUSTER_SIZES:
        p = sgd_kernels.ring_plan(n, GLM_MINIBATCH, cluster=c)
        run = lambda: sgd_kernels.sgd_ring(  # noqa: E731
            a, b, xs0, lrs, l2s, plan=p, **kw)
        xs_c = run()
        torch.cuda.synchronize()
        if not torch.allclose(xs_c, xs_p, **SGD_TOL):
            raise AssertionError(f"sgd ring, cluster {c}: differs from the "
                                 f"plain version beyond {SGD_TOL}")
        ms = time_ms(run, reps=3, warmup=1)
        sweep.append(f"C {c} ({p.threads} + 32 threads) "
                     f"{ms:.4f} ms = {ms * 1e3 / steps:.3f} us a step")
    log("  sgd ring by cluster size (all within "
        f"{SGD_TOL} of the plain version): " + "; ".join(sweep))
    del a, b

    # B5's split route: models too wide for the ring, trained through the
    # hyper-parameter search entry point with the counters zeroed, at
    # RCV1's width and at news20.binary's (the model slices in device
    # memory); held to the plain version, and shown to tell a kernel that
    # drops one block's dot sums, or all of them, from a right one
    from repro_torch.core import channels
    from repro_torch.core.sgd_glm import HyperParams as HP
    from repro_torch.core.sgd_glm import hyperparam_search
    wide_rows = []
    for tag, rows, feats, terms in (
            ("wide", WIDE_ROWS, WIDE_FEATURES, WIDE_TERMS),
            ("news20", NEWS20_ROWS, NEWS20_FEATURES, NEWS20_TERMS)):
        wa, wb = text_rows(rows, feats, terms, torch.Generator(
            device=dev).manual_seed(seed + 5), dev)
        wgrid = [HP(WIDE_LR / (i + 1), 0.001 * i) for i in range(WIDE_JOBS)]
        wkw = dict(minibatch=GLM_MINIBATCH, epochs=1, kind="logreg")
        wplan = sgd_kernels.split_plan(feats, GLM_MINIBATCH)
        if sgd_kernels.route(feats, GLM_MINIBATCH) != "split":
            raise AssertionError(f"{feats} features do not take the split "
                                 "route")
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wxs, wlosses = hyperparam_search(wa, wb, wgrid,
                                         channels.plan("partitioned", 1, dev),
                                         **wkw)
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
        counts[f"{tag} split"] = dict(_build.LAUNCHES)
        if counts[f"{tag} split"]["sgd_split"] <= 0:
            raise AssertionError(f"the {tag} search launched no split sgd "
                                 "kernel")
        w_lrs = torch.tensor([h.lr for h in wgrid], device=dev)
        w_l2s = torch.tensor([h.l2 for h in wgrid], device=dev)
        w_xs0 = torch.zeros((WIDE_JOBS, feats), device=dev)
        wkernel = lambda: sgd_kernels.sgd(  # noqa: E731
            wa, wb, w_xs0, w_lrs, w_l2s, **wkw)
        wplain = lambda: sgd_ref.sgd_ref(  # noqa: E731
            wa, wb, w_xs0, w_lrs, w_l2s, **wkw)
        want, wplain_ms = timed_once_ms(wplain)
        werr = float((wxs - want).abs().max())
        if not torch.allclose(wxs, want, **SGD_TOL) \
                or not bool(torch.isfinite(wlosses).all()):
            raise AssertionError(f"sgd split ({tag}): differs from its plain "
                                 f"version beyond {SGD_TOL} (max abs err "
                                 f"{werr})")
        # the controls, read through the same allclose: each must fail
        keep = torch.ones(feats, device=dev)
        keep[:wplan.width] = 0.0
        beyond = []
        for what, k in (("block 0's sums dropped", keep),
                        ("z forced to 0", torch.zeros_like(keep))):
            ctrl = sgd_masked_plain(wa, wb, w_xs0, w_lrs, w_l2s, k,
                                    GLM_MINIBATCH)
            if torch.allclose(wxs, ctrl, **SGD_TOL):
                raise AssertionError(f"sgd split ({tag}): the control with "
                                     f"{what} passes {SGD_TOL}")
            tol = SGD_TOL["atol"] + SGD_TOL["rtol"] * ctrl.abs()
            over = float(((wxs - ctrl).abs() / tol).max())
            beyond.append(f"{what} {over:.1f}x")
            del ctrl
        z_max = float((wa @ want.T).abs().max())
        moved = float(want.abs().max())
        wsteps = rows // GLM_MINIBATCH
        split_row = dict(
            name="sgd_split" if tag == "wide" else "sgd_split_news20",
            route="cuda", source="src/repro_torch/kernels/csrc/sgd.cu",
            replaces="src/repro/kernels/sgd/sgd.py:55", max_abs_err=werr,
            ms=time_ms(wkernel, reps=5, warmup=1), plain_ms=wplain_ms,
            library_ms=None,
            launches=counts[f"{tag} split"]["sgd_split"],
            bytes=4 * (rows * feats + rows + 2 * WIDE_JOBS * feats
                       + 2 * WIDE_JOBS),
            ops=4 * WIDE_JOBS * rows * feats,
            shape=f"a=({rows}, {feats}) f32, {WIDE_JOBS} jobs, 1 epoch, "
                  f"minibatch {GLM_MINIBATCH}, split route, {wplan}")
        log(f"  {tag} search ({feats} features, {terms} terms a row, split "
            f"route): {wide_s * 1e3:.3f} ms with its losses, launches "
            f"{counts[f'{tag} split']}; {wsteps} dependent steps a job, "
            f"{split_row['ms'] * 1e3 / wsteps:.3f} us a step; the weights "
            f"moved by up to {moved:.4f} (|z| at them up to {z_max:.3f}), "
            f"error {werr / moved:.3e} of that; controls beyond the "
            f"tolerance by: {', '.join(beyond)}")
        finish_row(split_row, agree=f"within {SGD_TOL}")
        wide_rows.append(split_row)
        del wa, wb, wxs, want
        torch.cuda.empty_cache()

    # score with the best model (trained fresh through execute, as the
    # port has no model cache) against numpy in float64
    sq = Q.scan("mnist").score_glm(q)
    t0 = time.perf_counter()
    scores = ex.execute(sq).value.column("score")
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    xs_b, losses_b = runs["batch"][2]
    x = xs_b[int(torch.argmin(losses_b))].double().cpu().numpy()
    want = 1.0 / (1.0 + np.exp(-(a_np.astype(np.float64) @ x)))
    got = scores.double().cpu().numpy()
    score_err = float(np.abs(got - want).max())
    if got.shape != (MNIST_ROWS,) or not np.allclose(got, want, rtol=1e-5,
                                                     atol=1e-5):
        raise AssertionError(f"score_glm differs from numpy (max abs err "
                             f"{score_err})")
    log(f"  score_glm: {MNIST_ROWS} scores of the argmin model equal "
        f"numpy's sigmoid(a @ x) within rtol=1e-5, atol=1e-5 (max abs err "
        f"{score_err:.3e}); {score_s * 1e3:.3f} ms with its fresh train")

    # a cached query server: the search trains once, and two scores (by
    # the train plan, and by the model's raw fingerprint) are served from
    # its model
    from repro_torch.query import QueryServer
    srv = QueryServer(Executor(catalog_from_arrays(tables, dev), dev,
                               cache_bytes=CACHE_BYTES))
    if srv.executor.cache is None:
        raise AssertionError("glm server: the executor has no semantic "
                             "cache (is REPRO_CACHE=0 set?)")
    served = {}
    by_fp = Q.scan("mnist").score(srv.executor.fingerprint_of(q.node),
                                  [f"px{j}" for j in range(MNIST_FEATURES)])
    for name, qs in (("serve glm train", [q]),
                     ("serve glm scores", [sq, by_fp])):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qids = [srv.submit(x) for x in qs]
        out = srv.drain()
        torch.cuda.synchronize()
        served[name] = time.perf_counter() - t0
        counts[name] = dict(_build.LAUNCHES)
    plan_s, fp_s = (out[i].column("score") for i in qids)
    b5 = counts["serve glm scores"]["sgd"] \
        + counts["serve glm scores"]["sgd_split"]
    st = srv.stats()
    if counts["serve glm train"]["sgd"] + \
            counts["serve glm train"]["sgd_split"] <= 0 or b5 \
            or st["n_model_hits"] < 1:
        raise AssertionError(f"glm server: launches {counts}, model hits "
                             f"{st['n_model_hits']}")
    if not torch.equal(plan_s, scores) or not torch.equal(fp_s, scores):
        raise AssertionError("glm server: the served scores differ from "
                             "the executor's")
    log(f"  served: the search trained once "
        f"({served['serve glm train'] * 1e3:.3f} ms, launches "
        f"{counts['serve glm train']}), then both scores came from its "
        f"model in {served['serve glm scores'] * 1e3:.3f} ms "
        f"with no B5 launch (n_model_hits {st['n_model_hits']}), both "
        f"equal to the executor's scores bit for bit")
    del srv
    return counts, [row, *wide_rows]


def phase_multi_join(dev, tables):
    """``hash_join_multi`` at TPC-H SF 1 against a numpy oracle, bit for
    bit, on three build sides; then B3 against its plain version on both
    routes at those joins' shapes, its (start, count) against B2's.
    Returns (launch counts by join, B3's rows)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.join import join as jk
    from repro_torch.kernels.join import ref as join_ref
    from repro_torch.kernels.join.ops import hash_join_multi

    li, od = tables["lineitem"], tables["orders"]
    # the order keys and the quantities take B3's sampled route (6,001,215
    # build rows); the 50-row quantity dimension, probed by every lineitem
    # row, its shared route
    cases = {
        "orderkey": (li["orderkey"], od["orderkey"]),
        "quantity": (li["quantity"], np.arange(1, 51, dtype=np.int32)),
        "quantity dimension": (np.arange(1, 51, dtype=np.int32),
                               li["quantity"]),
    }
    counts = {}
    for name, (s, l) in cases.items():
        l_want, s_want, total = multi_join_oracle(s, l)
        max_out = max(s.size, total)
        st, lt = torch.from_numpy(s).to(dev), torch.from_numpy(l).to(dev)
        run = lambda: hash_join_multi(st, lt, max_out=max_out)  # noqa: E731
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts[name] = dict(_build.LAUNCHES)
        route = ("probe_multi" if jk.probe_multi_route(s.size) == "shared"
                 else "probe_multi_sampled")
        if counts[name][route] <= 0:
            raise AssertionError(f"{name}: hash_join_multi launched no "
                                 f"{route} kernel")
        got_l, got_s = res.l_idx.cpu().numpy(), res.s_idx.cpu().numpy()
        if int(res.total) != total or bool(res.overflowed) \
                or total > max_out:
            raise AssertionError(f"{name}: total {int(res.total)} (oracle "
                                 f"{total}), overflowed "
                                 f"{bool(res.overflowed)}")
        if not (np.array_equal(got_l[:total], l_want)
                and np.array_equal(got_s[:total], s_want)
                and (got_l[total:] == -1).all()
                and (got_s[total:] == -1).all()):
            raise AssertionError(f"{name}: pair list differs from the "
                                 "oracle")
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        warm.sort()
        chains = np.bincount(np.searchsorted(np.sort(np.unique(s)), s))
        log(f"multi_join {name}: build {s.size} keys (chains "
            f"{chains.min()}-{chains.max()}), probe {l.size} keys -> "
            f"{total} pairs, bit-identical to the oracle; first run "
            f"{first * 1e3:.3f} ms, warm median {warm[2] * 1e3:.3f} ms "
            f"[min {warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f}] over 5 "
            f"runs; launches {counts[name]}")
        log("    " + profile_once(run))

    # B3 against its plain version at each join's shape, on both routes
    # (the order keys and the quantities sampled, the dimension shared),
    # its (start, count) against B2's on the same inputs; the order keys
    # and the dimension give the routes' rows
    rows = []
    for name, (s, l) in cases.items():
        s_sorted, order = join_ref.bucket_build(torch.from_numpy(s).to(dev))
        keys = torch.from_numpy(l).to(dev)
        kernel = lambda: jk.probe_multi(s_sorted, order, keys)  # noqa: E731
        plain = lambda: jk.probe_multi_plain(  # noqa: E731
            s_sorted, order, keys)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        b2_err = max_abs_err(got[1:], jk.probe_counts(s_sorted, keys))
        if err != 0 or b2_err != 0:
            raise AssertionError(f"probe_multi ({name}): kernel differs from "
                                 f"its plain version (max abs err {err}) or "
                                 f"its (start, count) from B2's ({b2_err})")
        n_s, n_l = s_sorted.shape[0], keys.shape[0]
        cap = got[0].shape[1]
        route = jk.probe_multi_route(n_s)
        log(f"  probe_multi ({name}, {route} route): bit-identical to its "
            "plain version, (start, count) to B2's")
        if name == "quantity":
            continue
        row = dict(
            name="probe_multi" if route == "shared"
            else "probe_multi_sampled", route="cuda",
            source="src/repro_torch/kernels/csrc/join.cu",
            replaces="src/repro/kernels/join/join.py:142",
            max_abs_err=err, plain_ms=time_ms(plain), library_ms=None,
            bytes=8 * n_s + 4 * n_l + (8 + 4 * cap) * n_l,
            shape=f"s_sorted, order=({n_s},), keys=({n_l},) int32, cap "
                  f"{cap}, {route} route")
        row["ms"] = time3_ms(row["name"], kernel)
        finish_row(row)
        rows.append(row)
    return counts, rows


def phase_calibrate(dev, ssb_tables, spill_dir):
    """B6 against its plain version, timed; the calibration written, read
    back and applied with ``recost``; the Fig. 2 analogue.  Returns (launch
    counts of the calibration run, the kernel's row, the calibration)."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.core import bandwidth, channels
    from repro_torch.kernels import _build
    from repro_torch.kernels.bandwidth import ref as bw_ref
    from repro_torch.kernels.bandwidth import stream
    from repro_torch.query import Executor, Q, load_calibration
    from repro_torch.query.calibrate import calibrate

    r = np.random.default_rng(8)
    x = torch.from_numpy(r.integers(-2 ** 31, 2 ** 31, STREAM_ROWS,
                                    dtype=np.int64).astype(np.int32)).to(dev)
    x[0] = 2 ** 31 - 1
    ragged = x[:(1 << 20) + 3]
    cases = {"1 GiB int32": x, "ragged (1 << 20) + 3": ragged,
             "misaligned x[1:]": ragged[1:],
             "2**31 - 1": torch.full((1027,), 2 ** 31 - 1, dtype=torch.int32,
                                     device=dev),
             "float32": torch.from_numpy(r.standard_normal((1 << 20) + 5)
                                         .astype(np.float32)).to(dev)[1:]}
    for name, t in cases.items():
        got, want = stream.stream_copy(t), bw_ref.stream_copy_ref(t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stream_copy ({name}): kernel differs "
                                 "from its plain version")
    if int(stream.stream_copy(cases["2**31 - 1"])[0]) != -2 ** 31:
        raise AssertionError("stream_copy: 2**31 - 1 did not wrap")
    log(f"calibrate: stream_copy bit-identical to its plain version on "
        f"{', '.join(cases)}")
    plan = stream.plan_stream_block(STREAM_ROWS, 4)
    # kernel, library, kernel, library: the means of the two turns
    turns = {"kernel": [], "library": []}
    for _ in range(2):
        turns["kernel"].append(time_ms(lambda: stream.stream_copy(x),
                                       reps=10))
        turns["library"].append(time_ms(lambda: torch.add(x, 1), reps=10))
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    row = dict(
        name="stream_copy", route="cuda",
        source="src/repro_torch/kernels/csrc/bandwidth.cu",
        replaces="src/repro/core/bandwidth.py:27", max_abs_err=0.0,
        ms=ms["kernel"],
        plain_ms=time_ms(lambda: bw_ref.stream_copy_ref(x), reps=10),
        library_ms=ms["library"],
        bytes=2 * 4 * STREAM_ROWS,
        shape=f"x=({STREAM_ROWS},) int32, grid {plan.grid}, tiles of "
              f"{plan.tile} vectors, {plan.unroll} loads in flight a "
              "thread")
    finish_row(row)
    log(f"  stream_copy turns (ms): kernel {turns['kernel']}, torch.add "
        f"{turns['library']}; kernel / torch.add "
        f"{ms['kernel'] / ms['library']:.4f}")

    # the calibration run: the slice's path through the kernel
    path = os.path.join(spill_dir, "BENCH_calibration_torch.json")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = calibrate(path)
    torch.cuda.synchronize()
    counts = {"calibrate": dict(_build.LAUNCHES)}
    if counts["calibrate"]["stream_copy"] <= 0:
        raise AssertionError("calibrate() launched no stream_copy kernel")
    cal = load_calibration(path)
    if cal != report or set(cal["backends"]) != {"torch", "cuda"} \
            or not cal["h2d_gbps"] > 0:
        raise AssertionError(f"the calibration file does not read back: "
                             f"{cal}")
    log(f"  calibrate() in {time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"{impl} {b['achieved_gbps']:.1f} GB/s "
                    f"(stream_eff {b['stream_eff']:.4f}, call overhead "
                    f"{b['call_overhead_s'] * 1e6:.2f} us)"
                    for impl, b in cal["backends"].items())
        + f"; h2d {cal['h2d_gbps']:.2f} GB/s from pinned memory; "
        f"launches {counts['calibrate']}")

    # recost an executor over SSB SF 10 with it
    ex = Executor(catalog_from_arrays(ssb_tables, dev), dev)
    q = ssb_query(Q)

    def morsel_rows():
        return ex.plan(q.node)[1].morsel_rows

    before = morsel_rows()
    epoch = ex.recost(cal)
    after, plan = morsel_rows(), ex.explain(q)
    if epoch != 1 or ex.cost_model.calibrated_from != "cuda":
        raise AssertionError(f"recost: epoch {epoch}, calibrated from "
                             f"{ex.cost_model.calibrated_from}")
    ex.recost(cal)
    if ex.cost_epoch != 2 or ex.explain(q) != plan:
        raise AssertionError("a second recost with the same calibration "
                             "changed a price")
    log(f"  recost: epoch 0 -> 1 -> 2, the second changes no price; SSB "
        f"stream plan morsel_rows {before} (placeholders) -> {after} "
        "(calibrated)")
    del ex

    # the Fig. 2 analogue: one generator per engine, partitioned vs
    # congested (each engine streams its own slice either way on one card)
    fig2 = []
    for n_eng in (1, 4, 16):
        for placement in ("partitioned", "congested"):
            plan_ = channels.plan(placement, n_eng, dev)
            gbps = bandwidth.measure_gbps(
                lambda t: bandwidth.stream_copy_distributed(t, plan_), x)
            fig2.append(f"{n_eng} {placement} {gbps:.1f}")
    log("  fig2 analogue (engines, placement, GB/s): " + "; ".join(fig2))
    return counts, row, cal


def phase_spill(dev, ssb_tables, cal, spill_dir):
    """SSB Q1.1 at SF 10 under device (and host) budgets: host spill in
    batch and stream, host and disk spill in batch, each against the
    oracle.  Returns launch counts by run."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q, TierBudgets

    want = ssb_oracle(ssb_tables)
    q = ssb_query(Q)
    counts = {}
    cases = (("host", TierBudgets(device=256 * MIB), ("batch", "stream")),
             ("host+disk", TierBudgets(device=256 * MIB, host=512 * MIB),
              ("batch",)))
    for name, budgets, modes in cases:
        ex = Executor(catalog_from_arrays(ssb_tables, dev), dev,
                      tier_budgets=budgets)
        ex._spill_dir = spill_dir
        ex.recost(cal)
        by_mode = {}
        times = _run_modes(ex, q, modes, equals(want), by_mode)
        spill = ex.last_spill
        tiers = {c: t for (_, c), t in spill.tiers.items()}
        lo = ex.catalog.tables["lineorder"]
        if any(lo.column_tier(c) != t for c, t in tiers.items()):
            raise AssertionError(f"{name}: catalog tiers differ from the "
                                 f"spill plan {tiers}")
        promoted = sum(n for t, n in spill.bytes_by_tier.items()
                       if t != "device")
        for mode, (first, warm, value) in times.items():
            med = warm[len(warm) // 2]
            log(f"spill {name} {mode}: tiers {tiers}; {promoted} bytes "
                f"promoted a run over {med * 1e3:.3f} ms (median of "
                f"{len(warm)}) = {promoted / med / 1e9:.2f} GB/s against "
                f"the calibrated h2d {ex.cost_model.h2d_gbps:.2f} GB/s; "
                f"priced promotion {spill.promote_s_per_exec * 1e3:.3f} ms")
            counts[f"{name} {mode}"] = by_mode[mode]
            if by_mode[mode]["probe_counts"] <= 0:
                raise AssertionError(f"spill {name} {mode} launched no "
                                     "probe_counts kernel")
        if name == "host":
            ex.overlap_transfers = False
            same = equals(want)
            warm = warm_runs(lambda: ex.execute(q),
                             lambda v: same("batch, one thread", v))
            log(f"spill host batch without the prefetch thread: "
                f"{spread(warm)}")
        expect = ["device", "host", "host", "host"] if name == "host" \
            else ["device", "disk", "host", "host"]
        if sorted(tiers.values()) != expect:
            raise AssertionError(f"{name}: tiers {tiers}, expected {expect}")
        del ex, lo
        torch.cuda.empty_cache()
    return counts


EXACT_ROWS = 1 << 26             # the exact-estimate table: 2 x 256 MiB
TRACE_MAX_EVENTS = 50_000


def _ledger_lines(rows) -> str:
    """Per op: predicted against measured GB/s and the two drifts."""
    return "; ".join(
        f"{r.op} pred {r.predicted_gbps:.1f} meas {r.achieved_gbps:.1f} "
        f"GB/s, drift bytes {r.drift_bytes:.4f} time {r.drift_time:.3f}"
        for r in rows)


def phase_telemetry(dev, ssb_tables, ssb_counts, ssb_times, cal, spill_dir,
                    seed):
    """The query telemetry on the card: SSB Q1.1 traced in every mode
    (values and launches equal to phase 4's untraced runs, one eager
    ledger row per costed operator), the exact-estimate table at 2**26
    rows (eager drift_bytes 1.0 on every operator), the enabled path's
    cost against the disabled one (which must never fence), SSB spilled
    with promotions in the ledger, the traced GLM search (weights equal
    to the untraced run's), the ledger's overlay through ``recost``, and
    the Chrome trace.  Returns launch counts by run."""
    from repro_torch.query import exec as qexec

    fences = [0]
    real_fence = qexec._fence

    def counted_fence(device):
        fences[0] += 1
        real_fence(device)

    qexec._fence = counted_fence
    t0 = time.perf_counter()
    try:
        counts = _telemetry_checks(dev, ssb_tables, ssb_counts, ssb_times,
                                   cal, spill_dir, seed, fences)
    finally:
        qexec._fence = real_fence
    log(f"telemetry: phase in {time.perf_counter() - t0:.1f} s")
    return counts


def _walk_phys(p):
    yield p
    for c in p.children:
        yield from _walk_phys(c)


def _telemetry_checks(dev, ssb_tables, ssb_counts, ssb_times, cal,
                      spill_dir, seed, fences):
    """``phase_telemetry``'s runs; ``fences[0]`` counts the executor's
    fence calls."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.kernels import _build
    from repro_torch.query import (
        Executor, HyperParams, Q, Telemetry, TierBudgets,
    )

    counts = {}

    def traced_run(ex, q, name, **kw):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.execute(q, **kw)
        torch.cuda.synchronize()
        counts[name] = dict(_build.LAUNCHES)
        return res, time.perf_counter() - t0

    # SSB Q1.1 traced in each mode, against phase 4's untraced runs
    want = ssb_oracle(ssb_tables)
    q = ssb_query(Q)
    cat = catalog_from_arrays(ssb_tables, dev)
    tel = Telemetry(enabled=True)
    tel.tracer.max_events = TRACE_MAX_EVENTS
    ex = Executor(cat, dev, telemetry=tel)
    phys_ops = sorted(p.op for p in _walk_phys(ex.plan(q.node)[1]))
    for mode in ("batch", "stream", "eager"):
        start = len(tel.ledger.rows)
        kw = {"morsel_rows": 1 << 22} if mode == "stream" else {}
        res, first = traced_run(ex, q, f"traced {mode}", mode=mode, **kw)
        untraced = ssb_times[mode][2]
        if res.value != want or res.value != untraced:
            raise AssertionError(f"traced {mode}: {res.value} against the "
                                 f"oracle {want} and untraced {untraced}")
        if counts[f"traced {mode}"] != ssb_counts[mode]:
            raise AssertionError(f"traced {mode} launched "
                                 f"{counts[f'traced {mode}']}, untraced "
                                 f"{ssb_counts[mode]}")
        rows = tel.ledger.rows[start:]
        if sorted(r.op for r in rows) != phys_ops:
            raise AssertionError(f"traced {mode}: ledger ops "
                                 f"{[r.op for r in rows]}, plan {phys_ops}")
        if mode == "eager":
            if any(r.attributed or r.mode != "eager" for r in rows):
                raise AssertionError("an eager row is attributed")
        elif not all(r.attributed and r.mode == ("fused" if mode == "batch"
                                                 else "stream")
                     for r in rows):
            raise AssertionError(f"a {mode} row is not attributed")
        log(f"telemetry ssb {mode}: value {res.value} (= oracle, = "
            f"untraced); launches equal the untraced run's; first run "
            f"{first * 1e3:.3f} ms; {len(rows)} ledger rows: "
            + _ledger_lines(rows))

    # the exact-estimate table at 2**26 rows: eager drift_bytes 1.0
    exact = {"t": {"v": (np.arange(EXACT_ROWS) % 128).astype(np.int32),
                   "w": np.ones(EXACT_ROWS, np.int32)}}
    etel = Telemetry(enabled=True)
    eex = Executor(catalog_from_arrays(exact, dev), dev, telemetry=etel)
    eq = Q.scan("t", ("v", "w")).filter("v", 10, 41).sum("w")
    res, _ = traced_run(eex, eq, "exact eager", mode="eager")
    if res.value != EXACT_ROWS // 128 * 32:
        raise AssertionError(f"exact table: {res.value}")
    erows = etel.ledger.rows
    eops = sorted(p.op for p in _walk_phys(eex.plan(eq.node)[1]))
    if sorted(r.op for r in erows) != eops:
        raise AssertionError(f"exact table: ledger ops {erows}")
    for r in erows:
        if abs(r.drift_bytes - 1.0) > 1e-6 or not r.measured_s > 0:
            raise AssertionError(f"exact table: {r}")
    log(f"telemetry exact table ({EXACT_ROWS} rows x 2 int32): eager "
        f"drift_bytes 1.0 on {eops}; " + _ledger_lines(erows))
    del eex, exact

    # the enabled path's cost against the disabled one's, which must
    # never fence
    off = Executor(cat, dev, telemetry=Telemetry(enabled=False))
    off.execute(q)
    fences[0] = 0
    same = equals(want)
    warm_off = warm_runs(lambda: off.execute(q),
                         lambda v: same("batch, telemetry off", v))
    if fences[0]:
        raise AssertionError(f"telemetry disabled: {fences[0]} fences")
    warm_on = warm_runs(lambda: ex.execute(q),
                        lambda v: same("batch, telemetry on", v))
    if not fences[0]:
        raise AssertionError("telemetry enabled: no fence")
    med_off, med_on = (w[len(w) // 2] for w in (warm_off, warm_on))
    phase4 = ssb_times["batch"][1]
    log(f"telemetry overhead, ssb batch: disabled {spread(warm_off)} (0 "
        f"fences); enabled {spread(warm_on)} ({fences[0]} fences); "
        f"enabled - disabled {(med_on - med_off) * 1e3:.3f} ms; phase 4 "
        f"median {phase4[len(phase4) // 2] * 1e3:.3f} ms")
    del off

    # the SSB ledger's overlay through recost
    overlay = tel.ledger.calibration_overlay(ex.cost_model)
    b = overlay["backends"].get("cuda")
    if b is None or not 0 < b["stream_eff"] <= 1:
        raise AssertionError(f"overlay: {overlay}")
    epoch = ex.cost_epoch
    if ex.recost(overlay) != epoch + 1:
        raise AssertionError("recost did not move the epoch")
    plan = ex.explain(q)
    ex.recost(overlay)
    if ex.explain(q) != plan:
        raise AssertionError("the same overlay twice changed a price")
    log(f"telemetry overlay: cuda achieved {b['achieved_gbps']:.2f} GB/s "
        f"(stream_eff {b['stream_eff']:.6f}) against B6's calibrated "
        f"{cal['backends']['cuda']['achieved_gbps']:.2f} GB/s; recost "
        f"epoch {epoch} -> {epoch + 2}, the second changes no price; "
        f"selectivity corrections {ex.cost_model.sel_corrections}")

    # the Chrome trace of the SSB runs
    path = tel.export_chrome(os.path.join(spill_dir, "trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e["name"] == "exec.execute"]
    ops = [e for e in events if e["name"].startswith("op.")]
    for e in ops:
        if not any(s["tid"] == e["tid"] and s["ts"] - 1 <= e["ts"]
                   and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 1
                   for s in spans):
            raise AssertionError(f"{e['name']} lies in no exec.execute")
    if not ops or len(events) > tel.tracer.max_events:
        raise AssertionError(f"trace: {len(ops)} op spans, {len(events)} "
                             "events")
    log(f"telemetry chrome trace: {len(events)} events (max "
        f"{tel.tracer.max_events}, {tel.tracer.dropped} dropped), "
        f"{len(ops)} op spans each inside its exec.execute; "
        f"{os.path.getsize(path)} bytes")
    del ex, cat
    torch.cuda.empty_cache()

    # SSB spilled under 256 MiB: the host promotions in the ledger
    stel = Telemetry(enabled=True)
    sex = Executor(catalog_from_arrays(ssb_tables, dev), dev,
                   tier_budgets=TierBudgets(device=256 * MIB),
                   telemetry=stel)
    sex._spill_dir = spill_dir
    sex.recost(cal)
    sex.execute(q)
    sex.reset_metrics()
    start = len(stel.ledger.rows)
    res, first = traced_run(sex, q, "traced spill")
    if res.value != want:
        raise AssertionError(f"traced spill: {res.value} != {want}")
    promoted = sum(n for t, n in sex.last_spill.bytes_by_tier.items()
                   if t == "host")
    got = sex.stats_dict()["promote_bytes_host"]
    if got != promoted or promoted != 3 * SSB_LINEORDER_ROWS * 4:
        raise AssertionError(f"promoted {got} host bytes, the spill plan "
                             f"{promoted}")
    prow = [r for r in stel.ledger.rows[start:] if r.op == "promote"]
    if [r.tier for r in prow] != ["host"]:
        raise AssertionError(f"promote rows {prow}")
    h2d = stel.ledger.calibration_overlay(sex.cost_model)["h2d_gbps"]
    log(f"telemetry spill: {got} bytes promoted from host a run (= the "
        f"plan's), in {prow[0].measured_s * 1e3:.3f} ms of fenced fetches; "
        f"ledger h2d {h2d:.2f} GB/s against the calibrated (pinned) "
        f"{cal['h2d_gbps']:.2f} GB/s; run {first * 1e3:.3f} ms")
    del sex
    torch.cuda.empty_cache()

    # the GLM search streamed, traced, against the untraced run
    tables, _, _ = make_mnist_like(MNIST_ROWS, MNIST_FEATURES, seed)
    gq = glm_query(Q, HyperParams)
    gcat = catalog_from_arrays(tables, dev)
    untraced = Executor(gcat, dev, telemetry=Telemetry(enabled=False))
    xs_off = untraced.execute(gq, mode="stream", morsel_rows=16_384).value[0]
    gtel = Telemetry(enabled=True)
    gex = Executor(gcat, dev, telemetry=gtel)
    res, first = traced_run(gex, gq, "traced glm", mode="stream",
                            morsel_rows=16_384)
    if not torch.equal(res.value[0], xs_off):
        raise AssertionError("traced GLM weights differ from untraced")
    trows = [r for r in gtel.ledger.rows if r.op == "train_glm"]
    span = [e for e in gtel.tracer.events if e["name"] == "exec.run_train"]
    moved = MNIST_ROWS * 4 * (MNIST_FEATURES + 1) * GLM_EPOCHS * GLM_JOBS
    if len(trows) != 1 or len(span) != 1 \
            or span[0]["args"]["measured_bytes"] != moved:
        raise AssertionError(f"train rows {trows}, spans {span}")
    log(f"telemetry glm stream: weights bit-identical to the untraced "
        f"run's; exec.run_train {span[0]['dur'] / 1e3:.3f} ms over "
        f"{moved} bytes; first run {first * 1e3:.3f} ms; "
        + _ledger_lines(gtel.ledger.rows))
    return counts


CACHE_BYTES = 2 << 30            # holds every entry of phase `cache`
HOST_CACHE_BYTES = 4 << 30       # the warm-started cache's host tier


def phase_cache(dev, ssb_tables, tpch_tables, order_idx, ssb_times, cal,
                spill_dir, seed):
    """The semantic cache on the card: result hits, predicate subsumption,
    warm-start persistence, a mutation, the host tier, a shared cache,
    join-build reuse and served models.  Fails, rather than skips, when
    an executor ends up without a cache.  Returns launch counts by run."""
    import torch
    from repro_torch.columnar import engine
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.kernels import _build
    from repro_torch.query import (
        Executor, HyperParams, Q, SemanticCache, persist,
    )
    from repro_torch.query import cache as cache_mod

    t_phase = time.perf_counter()
    counts = {}

    def run(ex, q, name, **kw):
        """One counted run: launch counters zeroed just before and read
        just after; returns (result, seconds to a synchronize)."""
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ex.execute(q, **kw)
        torch.cuda.synchronize()
        counts[name] = dict(_build.LAUNCHES)
        return res, time.perf_counter() - t

    def need_cache(ex, what):
        if ex.cache is None:
            raise AssertionError(f"{what}: the executor has no semantic "
                                 "cache (is REPRO_CACHE=0 set?)")

    def events_ms(fn, reps=10):
        """Median of ``reps`` CUDA-event timings of one call each."""
        out = []
        for _ in range(reps + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return sorted(out[1:])[reps // 2]

    lineorder = dict(ssb_tables["lineorder"])
    tables = {"lineorder": lineorder, "date": ssb_tables["date"]}
    cat = catalog_from_arrays(tables, dev)
    ex = Executor(cat, dev, cache_bytes=CACHE_BYTES)
    need_cache(ex, "cache")
    ex.recost(cal)
    q = ssb_query(Q)

    # 1. result hits: SSB Q1.1 in batch, cold then warm
    want = ssb_oracle(tables)
    cold, cold_s = run(ex, q, "cache ssb cold")
    warm, _ = run(ex, q, "cache ssb warm")
    if cold.value != want or warm.value != want:
        raise AssertionError(f"cache ssb: {cold.value}, {warm.value} "
                             f"against the oracle {want}")
    if cold.result_cache_hit or not warm.result_cache_hit:
        raise AssertionError("cache ssb: the warm run is no result hit")
    if any(counts["cache ssb warm"].values()):
        raise AssertionError(f"cache ssb: the hit launched "
                             f"{counts['cache ssb warm']}")
    same = equals(want)
    hit_warm = warm_runs(lambda: ex.execute(q),
                         lambda v: same("batch, cached", v))
    phase4 = ssb_times["batch"][1]
    log(f"cache ssb batch: cold {cold_s * 1e3:.3f} ms (launches "
        f"{counts['cache ssb cold']}), warm is a result hit launching "
        f"nothing, {spread(hit_warm)}; phase 4's miss median "
        f"{phase4[len(phase4) // 2] * 1e3:.3f} ms; both = oracle {want}")

    # 2. subsumption: [1, 15] admits a bitmap, [5, 12] refines it
    qty = lineorder["quantity"]
    price = lineorder["extendedprice"].astype(np.int64)

    def qsum(lo, hi):
        return Q.scan("lineorder").filter("quantity", lo, hi) \
            .sum("extendedprice")

    def qwant(lo, hi):
        return int(price[(qty >= lo) & (qty <= hi)].sum())

    wide, wide_s = run(ex, qsum(1, 15), "cache refine [1,15]", mode="eager")
    narrow, narrow_s = run(ex, qsum(5, 12), "cache refine [5,12]",
                           mode="eager")
    for lo, hi, r in ((1, 15, wide), (5, 12, narrow)):
        if r.value != qwant(lo, hi):
            raise AssertionError(f"cache [{lo}, {hi}]: {r.value} != "
                                 f"{qwant(lo, hi)}")
    if ex.subsumption_hits != 1 \
            or counts["cache refine [5,12]"]["select"] != 0:
        raise AssertionError(f"cache refine: subsumption hits "
                             f"{ex.subsumption_hits}, launches "
                             f"{counts['cache refine [5,12]']}")
    version = cat.tables["lineorder"].version
    sup = ex.cache.peek(("bitmap", "lineorder", version, "quantity", 1, 15))
    ref_idx = ex.cache.peek(("bitmap", "lineorder", version, "quantity", 5,
                             12)).value
    placed = cat.tables["lineorder"].place(ex.plans["partitioned"])
    fresh = engine.select_range(placed, "quantity", 5, 12).column("idx")
    if ref_idx.dtype != fresh.dtype or not torch.equal(ref_idx, fresh):
        raise AssertionError("the refined bitmap differs from B1's")
    col = placed.column("quantity")
    refine_ms = events_ms(lambda: ex._refine_bitmap(col, sup.value, 5, 12))
    scan_ms = events_ms(lambda: engine.select_range(placed, "quantity", 5,
                                                    12))
    log(f"cache refine: [1, 15] admitted a {sup.n_bytes}-byte bitmap "
        f"({sup.value.shape[0]} rows, {wide_s * 1e3:.3f} ms); [5, 12] "
        f"refined it in {narrow_s * 1e3:.3f} ms with no B1 launch, its "
        f"{ref_idx.shape[0]} rows bit-identical to a fresh B1 selection; "
        f"refine {refine_ms:.4f} ms against B1's scan and compaction "
        f"{scan_ms:.4f} ms (medians of 10, CUDA events)")
    del sup, ref_idx, fresh, placed, col
    wide2, _ = run(ex, qsum(1, 30), "cache refine [1,30]", mode="eager")
    mid, mid_s = run(ex, qsum(1, 24), "cache refine [1,24]", mode="eager")
    for lo, hi, r in ((1, 30, wide2), (1, 24, mid)):
        if r.value != qwant(lo, hi):
            raise AssertionError(f"cache [{lo}, {hi}]: {r.value}")
    big = ex.cache.peek(("bitmap", "lineorder", version, "quantity", 1, 30))
    if ex.cost_model.refine_wins(int(big.value.shape[0]),
                                 SSB_LINEORDER_ROWS) \
            or ex.subsumption_hits != 1 \
            or counts["cache refine [1,24]"]["select"] <= 0:
        raise AssertionError("cache refine: [1, 24] refined a 60% "
                             "superset instead of rescanning")
    big_rows = int(big.value.shape[0])
    del big
    routed_q = Q.scan("lineorder").filter("quantity", 5, 12).sum("discount")
    routed, _ = run(ex, routed_q, "cache routed [5,12]")
    disc = lineorder["discount"].astype(np.int64)
    if routed.value != int(disc[(qty >= 5) & (qty <= 12)].sum()) \
            or ex.refine_routed != 1:
        raise AssertionError(f"cache routed: {routed.value}, routed "
                             f"{ex.refine_routed}")
    log(f"cache refine: [1, 30] ({big_rows} rows, 3 x 60% > "
        f"100%) is [1, 24]'s only superset and loses to the scan (B1 "
        f"launched {counts['cache refine [1,24]']['select']}x, "
        f"{mid_s * 1e3:.3f} ms); batch sum(discount) over [5, 12] routed "
        f"onto the cached bitmap (refine_routed 1), = numpy")
    if ex.cache.rejected or ex.cache.evicted:
        raise AssertionError(f"cache: {ex.cache.stats_dict()}")

    # 8a. persistence: the warm cache and the calibrated model
    path = os.path.join(spill_dir, "cache.npz")
    t = time.perf_counter()
    saved = persist.save_state(path, ex.cache, cost_model=ex.cost_model,
                               table_versions=cat.versions())
    save_s = time.perf_counter() - t
    fresh_ex = Executor(cat, dev, semantic_cache=SemanticCache(
        CACHE_BYTES, host_budget_bytes=HOST_CACHE_BYTES))
    need_cache(fresh_ex, "cache warm start")
    t = time.perf_counter()
    got = persist.warm_start(path, fresh_ex.cache,
                             cost_model=fresh_ex.cost_model,
                             table_versions=cat.versions())
    load_s = time.perf_counter() - t
    tiers = {e.tier for e in fresh_ex.cache._entries.values()}
    if got["restored"] != saved["saved"] or got["stale"] \
            or not got["calibrated"] or tiers != {"host"} \
            or saved["saved"] != len(ex.cache):
        raise AssertionError(f"warm start: saved {saved}, loaded {got}, "
                             f"tiers {tiers}")
    if fresh_ex.cost_model.calibration_snapshot() \
            != ex.cost_model.calibration_snapshot():
        raise AssertionError("warm start: the calibration differs")
    res, hit_s = run(fresh_ex, q, "cache warm-started ssb")
    if not res.result_cache_hit or res.value != want:
        raise AssertionError(f"warm start: ssb {res.value}, hit "
                             f"{res.result_cache_hit}")
    log(f"cache persistence: {saved['saved']} entries "
        f"({ex.cache.used_bytes} bytes resident) in "
        f"{os.path.getsize(path)} file bytes, saved in {save_s:.3f} s, "
        f"warm-started into the host tier in {load_s:.3f} s (stale 0, "
        f"calibration applied); SSB Q1.1 then a result hit = oracle in "
        f"{hit_s * 1e3:.3f} ms")
    del fresh_ex

    # 5. a mutation: lineorder.discount takes new values
    old_keys = set(ex.cache._entries)
    mem_before = torch.cuda.memory_allocated()
    rng = np.random.default_rng(seed + 7)
    lineorder["discount"] = rng.integers(0, 11, SSB_LINEORDER_ROWS,
                                         dtype=np.int32)
    cat.update_column("lineorder", "discount", lineorder["discount"])
    want = ssb_oracle(tables)
    res, miss_s = run(ex, q, "cache ssb after mutation")
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    now = cat.tables["lineorder"].version
    if res.result_cache_hit or res.value != want \
            or ex.cache.invalidated <= 0:
        raise AssertionError(f"mutation: {res.value} against {want}, hit "
                             f"{res.result_cache_hit}, invalidated "
                             f"{ex.cache.invalidated}")
    stale = [k for k in old_keys if k in ex.cache._entries
             and "lineorder" in ex.cache._entries[k].tables]
    stale += [k for k in ex._placed if k[0] == "lineorder" and k[3] != now]
    stale += [k for k in ex._builds
              if k[1] != cat.tables[k[0].table].version]
    stale += [k for k in ex._planned if dict(k[1]) != cat.versions()]
    if stale:
        raise AssertionError(f"mutation: state of the old version: "
                             f"{stale}")
    log(f"cache mutation: discount updated (version {now}); SSB Q1.1 "
        f"missed and = the new oracle {want} in {miss_s * 1e3:.3f} ms; "
        f"{ex.cache.invalidated} entries invalidated, no entry, placement, "
        f"build or plan of the old version left; memory_allocated "
        f"{mem_before} -> {mem_after} bytes")
    stale_load = persist.load_state(path, cat.versions())
    if stale_load is None or stale_load["stale"] <= 0:
        raise AssertionError(f"the snapshot loaded after the mutation: "
                             f"{stale_load}")
    log(f"cache persistence after the mutation: {stale_load['stale']} "
        f"stale entries dropped, {len(stale_load['entries'])} kept")
    del stale_load
    os.unlink(path)

    # 6. the host tier: a device budget that holds one of two bitmaps
    kind = torch.device(dev).type        # where every served value must be
    hcache = SemanticCache(64 * MIB, host_budget_bytes=256 * MIB)
    hex_ = Executor(cat, dev, semantic_cache=hcache)
    need_cache(hex_, "cache host tier")
    served = []
    real_value = hcache.device_value

    def device_value(entry, device=None):
        tier = entry.tier
        value = real_value(entry, device)
        served.append((tier, value))
        return value

    hcache.device_value = device_value
    moved = {"_to_host": 0.0}
    real_to_host = cache_mod._to_host

    def to_host(value):
        t = time.perf_counter()
        out = real_to_host(value)
        moved["_to_host"] += time.perf_counter() - t
        return out

    cache_mod._to_host = to_host
    try:
        def proj(lo, hi):
            return Q.scan("lineorder").filter("quantity", lo, hi) \
                .project("extendedprice", "discount")

        def check_proj(lo, hi, value):
            m = (qty >= lo) & (qty <= hi)
            for c in ("extendedprice", "discount"):
                if not np.array_equal(value.column(c).cpu().numpy(),
                                      lineorder[c][m]):
                    raise AssertionError(f"host tier [{lo}, {hi}]: {c}")

        a, _ = run(hex_, proj(1, 10), "cache host [1,10]")
        check_proj(1, 10, a.value)
        del a
        b, b_s = run(hex_, proj(41, 48), "cache host [41,48]")
        check_proj(41, 48, b.value)
        del b
        akey = ("bitmap", "lineorder", now, "quantity", 1, 10)
        if hcache.demoted < 1 or hcache.peek(akey).tier != "host":
            raise AssertionError(f"host tier: {hcache.stats_dict()}")
        served.clear()
        a, host_s = run(hex_, proj(1, 10), "cache host rerun")
        check_proj(1, 10, a.value)
        del a
        host_hits = [v for tier, v in served if tier == "host"]
        if not host_hits or any(v.device.type != kind for v in host_hits):
            raise AssertionError(f"host tier: served {served}")
        if hcache.promoted:
            raise AssertionError("host tier: promoted past the budget")
        hcache.budget_bytes = 256 * MIB        # room for both bitmaps
        served.clear()
        a, promote_s = run(hex_, proj(1, 10), "cache host promoted")
        check_proj(1, 10, a.value)
        del a
        if hcache.promoted != 1 or hcache.peek(akey).tier != "device" \
                or any(v.device.type != kind for _, v in served):
            raise AssertionError(f"host tier: {hcache.stats_dict()}")
        hcache.check_invariants()
    finally:
        cache_mod._to_host = real_to_host
    abytes = hcache.peek(akey).n_bytes
    log(f"cache host tier: [41, 48]'s bitmap demoted [1, 10]'s "
        f"({abytes} bytes) to the host in {moved['_to_host'] * 1e3:.3f} ms "
        f"(run {b_s * 1e3:.3f} ms); the rerun hit it on the host, served "
        f"on the card ({host_s * 1e3:.3f} ms); with room it was promoted "
        f"({promote_s * 1e3:.3f} ms); values = numpy, invariants hold")
    del hex_, hcache, served
    del ex

    # 7. a shared cache: two executors over one catalog
    shared = SemanticCache(CACHE_BYTES)
    ea = Executor(cat, dev, semantic_cache=shared)
    eb = Executor(cat, dev, semantic_cache=shared)
    need_cache(ea, "cache shared")
    ra, _ = run(ea, q, "cache shared a")
    rb, rb_s = run(eb, q, "cache shared b")
    if ra.value != want or not rb.result_cache_hit or rb.value != want:
        raise AssertionError(f"shared: {ra.value}, {rb.value}")
    run(eb, qsum(1, 15), "cache shared b bitmap", mode="eager")
    bkey = ("bitmap", "lineorder", now, "quantity", 1, 15)
    if bkey not in shared:
        raise AssertionError("shared: B admitted no bitmap")
    lineorder["discount"] = rng.integers(0, 11, SSB_LINEORDER_ROWS,
                                         dtype=np.int32)
    cat.update_column("lineorder", "discount", lineorder["discount"])
    want = ssb_oracle(tables)
    swept = shared.invalidated
    ra, _ = run(ea, q, "cache shared a after mutation")
    rb, _ = run(eb, q, "cache shared b after mutation")
    if bkey in shared or shared.invalidated <= swept \
            or ra.value != want or rb.value != want \
            or ra.result_cache_hit or not rb.result_cache_hit:
        raise AssertionError(f"shared after the mutation: {ra.value}, "
                             f"{rb.value}, {shared.stats_dict()}")
    log(f"cache shared: B's SSB Q1.1 a result hit from A's run "
        f"({rb_s * 1e3:.3f} ms); A noticed a mutation and swept "
        f"{shared.invalidated - swept} entries, B's bitmap among them; both "
        f"= the new oracle {want}")
    del ea, eb, shared, cat
    torch.cuda.empty_cache()

    # 3. join-build reuse: TPC-H lineitem joined with orders, two filters
    tcat = catalog_from_arrays(tpch_tables, dev)
    tex = Executor(tcat, dev, cache_bytes=CACHE_BYTES)
    need_cache(tex, "cache builds")
    lq = tpch_tables["lineitem"]["quantity"]
    price = tpch_tables["orders"]["totalprice"].astype(np.int64)
    times = []
    for i, (lo, hi) in enumerate(((1, 25), (26, 50))):
        tq = (Q.scan("lineitem").filter("quantity", lo, hi)
              .join(Q.scan("orders"), on="orderkey").sum("totalprice"))
        res, s = run(tex, tq, f"cache tpch build {i}")
        keep = (lq >= lo) & (lq <= hi)
        lines = np.bincount(order_idx[keep], minlength=price.size)
        if res.value != int((lines * price).sum()):
            raise AssertionError(f"cache tpch [{lo}, {hi}]: {res.value}")
        times.append(s)
    if tex.build_hits < 1:
        raise AssertionError("cache tpch: the second query rebuilt")
    log(f"cache builds: lineitem (quantity 1-25, then 26-50) joined with "
        f"orders in batch, = numpy; the second reused the cached "
        f"1,500,000-key build (build_hits {tex.build_hits}): first "
        f"{times[0] * 1e3:.3f} ms, second {times[1] * 1e3:.3f} ms")
    del tex, tcat
    torch.cuda.empty_cache()

    # 4. served models: the MNIST-shaped search, then ScoreGLM
    gtables, _, _ = make_mnist_like(MNIST_ROWS, MNIST_FEATURES, seed)
    gcat = catalog_from_arrays(gtables, dev)
    del gtables
    gex = Executor(gcat, dev, cache_bytes=CACHE_BYTES)
    need_cache(gex, "cache models")
    gq = glm_query(Q, HyperParams)
    run(gex, gq, "cache glm train")
    feats = [f"px{j}" for j in range(MNIST_FEATURES)]
    by_plan, plan_s = run(gex, Q.scan("mnist").score_glm(gq),
                          "cache glm score")
    fp = gex.fingerprint_of(gq.node)
    by_fp, fp_s = run(gex, Q.scan("mnist").score(fp, feats),
                      "cache glm score by fingerprint")
    plain = Executor(gcat, dev)
    want_s, plain_s = run(plain, Q.scan("mnist").score_glm(gq),
                          "cache glm score, no cache")
    sgd_moved = [counts[n][k] for n in ("cache glm score",
                                        "cache glm score by fingerprint")
                 for k in ("sgd", "sgd_split")]
    if gex.model_hits < 2 or any(sgd_moved):
        raise AssertionError(f"cache glm: model hits {gex.model_hits}, "
                             f"B5 launches {sgd_moved}")
    for r in (by_plan, by_fp):
        if not torch.equal(r.value.column("score"),
                           want_s.value.column("score")):
            raise AssertionError("cache glm: scores differ from the "
                                 "cache-less executor's")
    log(f"cache models: the trained search served both scores "
        f"(model_hits {gex.model_hits}, no B5 launch): by plan "
        f"{plan_s * 1e3:.3f} ms, by fingerprint {fp_s * 1e3:.3f} ms, "
        f"against {plain_s * 1e3:.3f} ms for a cache-less executor that "
        f"trains first; {MNIST_ROWS} scores bit-identical")
    del gex, plain, gcat
    torch.cuda.empty_cache()
    log(f"cache: phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


SERVE_MORSEL_ROWS = 1 << 22      # 15 morsels over SF 10's lineorder
# SSB flight 1 (O'Neil et al., "Star Schema Benchmark"), its date
# predicates as ranges of lineorder's order date: Q1.1 the year 1993,
# Q1.2 January 1994, Q1.3 the sixth week of 1994
FLIGHT1 = {"Q1.1": ((19930101, 19931231), (1, 3), (1, 24)),
           "Q1.2": ((19940101, 19940131), (4, 6), (26, 35)),
           "Q1.3": ((19940205, 19940211), (5, 7), (26, 35))}


def flight1_query(Q, dates, disc, qty):
    return (Q.scan("lineorder").filter("orderdate", *dates)
            .filter("discount", *disc).filter("quantity", *qty)
            .join(Q.scan("date"), on="orderdate").sum("extendedprice"))


def flight1_variants(n: int):
    """``n`` flight-1 queries of one shape: a year, a month or a week of
    order dates (in turn), with shifted discount and quantity bands."""
    out = []
    for i in range(n):
        y = 1992 + i % 6
        if i % 3 == 0:
            dates = (y * 10000 + 101, y * 10000 + 1231)
        elif i % 3 == 1:
            m = 1 + (i * 5) % 12
            dates = (y * 10000 + m * 100 + 1, y * 10000 + m * 100 + 28)
        else:
            d = 1 + (i * 3) % 21
            dates = (y * 10000 + 300 + d, y * 10000 + 300 + d + 6)
        disc = (i % 9, i % 9 + 2)
        qty = (1 + i % 7, 24 + i % 11)
        out.append((dates, disc, qty))
    return out


class Flight1Oracle:
    """Exact answers to flight-1 queries: one int64-exact cube of
    extendedprice summed by (day, discount, quantity) over the lineorder
    rows that join the date dimension, from which each query sums a box
    (float64 sums of integers below 2**53 are exact)."""

    def __init__(self, tables):
        lo = tables["lineorder"]
        self.datekey = tables["date"]["orderdate"]
        base = int(self.datekey.min())
        lut = np.full(int(self.datekey.max()) - base + 1, -1, np.int64)
        lut[self.datekey - base] = np.arange(self.datekey.size)
        od = lo["orderdate"].astype(np.int64) - base
        inside = (od >= 0) & (od < lut.size)
        day = np.where(inside, lut[np.clip(od, 0, lut.size - 1)], -1)
        joins = day >= 0
        key = (day[joins] * 11 + lo["discount"][joins]) * 51 \
            + lo["quantity"][joins]
        self.cube = np.bincount(
            key, weights=lo["extendedprice"][joins].astype(np.float64),
            minlength=self.datekey.size * 11 * 51).reshape(-1, 11, 51)

    def __call__(self, dates, disc, qty) -> int:
        d0 = np.searchsorted(self.datekey, dates[0])
        d1 = np.searchsorted(self.datekey, dates[1], side="right")
        box = self.cube[d0:d1, max(disc[0], 0):disc[1] + 1,
                        max(qty[0], 0):qty[1] + 1]
        return int(round(float(box.sum())))


def phase_serve(dev, ssb_tables, cal, spill_dir):
    """The query server on the card over SSB at SF 10: admission batches,
    streaming morsel groups, QoS backpressure, adaptive recalibration and
    warm start.  Every value against a numpy oracle.  Returns launch
    counts by run."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.kernels import _build
    from repro_torch.query import (
        AdaptivePolicy, Executor, Q, QueryServer, SemanticCache, Telemetry,
        TenantSpec,
    )
    from repro_torch.query import serve as serve_mod

    t_phase = time.perf_counter()
    counts = {}
    lo = ssb_tables["lineorder"]
    cat = catalog_from_arrays(ssb_tables, dev)
    oracle = Flight1Oracle(ssb_tables)
    qty_price = np.bincount(lo["quantity"], weights=lo["extendedprice"]
                            .astype(np.float64), minlength=51)

    def qty_sum(a, b):
        return int(round(float(qty_price[a:b + 1].sum())))

    def counted(name, fn):
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = dict(_build.LAUNCHES)
        return out, time.perf_counter() - t

    def check(srv, want):
        by_qid = {r.qid: r for r in srv.history}
        for qid, w in want.items():
            got = by_qid[qid].result
            if callable(w):
                w(qid, got)
            elif got != w:
                raise AssertionError(f"serve qid {qid} ({by_qid[qid].path})"
                                     f": {got} != oracle {w}")

    def paths(srv):
        out = {}
        for r in srv.history:
            out[r.path] = out.get(r.path, 0) + 1
        return out

    def summary(srv, seconds):
        st = srv.stats()
        return (f"{st['n_queries']} queries in {seconds * 1e3:.3f} ms "
                f"({st['n_queries'] / seconds:.1f} q/s end to end, "
                f"{st['queries_per_s']:.1f} q/s in the server); sojourn "
                f"p50 {st['latency_p50_s'] * 1e3:.3f} ms, p95 "
                f"{st['latency_p95_s'] * 1e3:.3f} ms; paths {paths(srv)}")

    def project_check(dates):
        m = (lo["orderdate"] >= dates[0]) & (lo["orderdate"] <= dates[1])

        def chk(qid, table):
            for c in ("quantity", "extendedprice"):
                if not np.array_equal(table.column(c).cpu().numpy(),
                                      lo[c][m]):
                    raise AssertionError(f"serve project qid {qid}: {c}")
        return chk, int(m.sum())

    def proj_query(dates):
        return (Q.scan("lineorder").filter("orderdate", *dates)
                .project("quantity", "extendedprice"))

    # 1. admission batches: 64 submissions from 4 tenants
    tenants = [TenantSpec("dash", priority=10), TenantSpec("adhoc",
                                                           priority=5),
               TenantSpec("report"), TenantSpec("etl")]
    ex = Executor(cat, dev)
    ex.recost(cal)
    sub = []
    for name, spec in FLIGHT1.items():
        sub += [(flight1_query(Q, *spec), oracle(*spec))] * 4
    qranges = [(a, a + w) for a in range(1, 49, 4) for w in (1, 2)]
    sub += [(Q.scan("lineorder").filter("quantity", a, b)
             .sum("extendedprice"), qty_sum(a, b)) for a, b in qranges]
    weeks = [(19940301, 19940305), (19950610, 19950614),
             (19960120, 19960124), (19971103, 19971107)]
    # the projections' checks hold their numpy masks, made here, outside
    # every timed round
    proj_checks = {dates: project_check(dates) for dates in weeks}
    narrow = sum(rows for _, rows in proj_checks.values())
    sub += [(proj_query(dates), proj_checks[dates][0]) for dates in weeks]
    sub += [(Q.scan("lineorder").filter("quantity", a, b)
             .sum("extendedprice"), qty_sum(a, b)) for a, b in qranges]
    assert len(sub) == 64

    def batch_round():
        """A fresh server on ``ex`` takes the 64 submissions and drains:
        (server, qid -> oracle)."""
        srv = QueryServer(ex)
        for t in tenants:
            srv.register_tenant(t)
        want = {srv.submit(qq, tenant=tenants[i % 4].name): w
                for i, (qq, w) in enumerate(sub)}
        srv.drain()
        return srv, want

    def warm(run, name):
        """The same round again on the warm executor (placements, plans
        and join builds cached), timed, then once more profiled."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv, want = run()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        check(srv, want)
        log(f"  {name} warm: {summary(srv, warm_s)}")
        log("    " + profile_once(run))

    (srv, want), batch_s = counted("serve batches", batch_round)
    check(srv, want)
    st = srv.stats()
    expect = {"n_deduped": 9 + 24, "n_microbatched": 24,
              "n_microbatches": 1}
    if any(st[k] != v for k, v in expect.items()) \
            or counts["serve batches"]["probe_counts"] <= 0 \
            or counts["serve batches"]["select"] <= 0:
        raise AssertionError(f"serve batches: {st}, launches "
                             f"{counts['serve batches']}")
    log(f"serve batches: 64 submissions from 4 tenants (flight 1 x 4 each, "
        f"24 quantity sums twice, 4 projections of {narrow / len(weeks):.0f}"
        f" rows, {narrow / len(weeks) / SSB_LINEORDER_ROWS:.3%} of "
        f"lineorder), all = numpy; first round on a fresh executor: "
        f"{summary(srv, batch_s)}; deduped {st['n_deduped']}, micro-batched "
        f"{st['n_microbatched']} in {st['n_microbatches']} pass; launches "
        f"{counts['serve batches']}")
    del srv
    warm(batch_round, "serve batches")

    # 2. streaming: 16 flight-1 variants in 4 waves, 2 riders, 2 projects
    variants = flight1_variants(16)

    def stream_round():
        srv = QueryServer(ex, streaming=True, morsel_rows=SERVE_MORSEL_ROWS)
        want = {}
        for w in range(4):
            for dates, disc, qty in variants[4 * w:4 * w + 4]:
                want[srv.submit(flight1_query(Q, dates, disc, qty),
                                tenant=tenants[w].name)] = \
                    oracle(dates, disc, qty)
            if w == 1:                      # riders on wave 1's members
                for dates, disc, qty in variants[:2]:
                    want[srv.submit(flight1_query(Q, dates, disc, qty))] = \
                        oracle(dates, disc, qty)
            if w == 2:
                for dates in weeks[:2]:
                    want[srv.submit(proj_query(dates))] = \
                        proj_checks[dates][0]
            srv.pump()
            srv.pump()
        srv.drain()
        return srv, want

    advances = []
    real_advance = serve_mod._MorselStream.advance

    def advance(stream):
        live = [g for g in stream.groups.values() if g.members]
        advances.append((sum(len(g.cp.breakers) for g in live),
                         [len(g.members) for g in live],
                         len(stream.proj_members)))
        return real_advance(stream)

    serve_mod._MorselStream.advance = advance
    try:
        (srv, want), stream_s = counted("serve streaming", stream_round)
    finally:
        serve_mod._MorselStream.advance = real_advance
    check(srv, want)
    st = srv.stats()
    b2 = counts["serve streaming"]["probe_counts"] \
        + counts["serve streaming"]["probe_counts_sampled"]
    expect_b2 = sum(j for j, _, _ in advances)
    n_morsels = srv._streams["lineorder"].spec.n_morsels
    widest = max(max(m, default=0) for _, m, _ in advances)
    if st["n_streamed"] != 18 or st["n_deduped"] != 2 or b2 != expect_b2 \
            or any(len(m) > 1 for _, m, _ in advances) or widest < 8:
        raise AssertionError(f"serve streaming: {st}, B2 {b2} against "
                             f"{expect_b2}, advances {advances}")
    log(f"serve streaming: {n_morsels} morsels of {SERVE_MORSEL_ROWS} rows;"
        f" 16 flight-1 variants in 4 waves (2 pumps apart), 2 dedup riders "
        f"and 2 projections, all = numpy; first round: "
        f"{summary(srv, stream_s)}")
    log(f"  B2 launches {b2} over {len(advances)} advances = live groups x "
        f"joins; members per group by advance "
        f"{[m[0] if m else 0 for _, m, _ in advances]}, projections "
        f"{[p for _, _, p in advances]}; launches "
        f"{counts['serve streaming']}")
    del srv
    warm(stream_round, "serve streaming")

    # 3. QoS: an SLO far below the achievable p95 forces backpressure
    srv = QueryServer(Executor(cat, dev), streaming=True,
                      morsel_rows=SERVE_MORSEL_ROWS)
    srv.register_tenant(TenantSpec("dash", priority=10, slo_p95_s=1e-6))
    srv.register_tenant(TenantSpec("adhoc", priority=0))
    want = {srv.submit(flight1_query(Q, *FLIGHT1["Q1.1"]), tenant="dash"):
            oracle(*FLIGHT1["Q1.1"])}
    srv.drain()                          # seeds the recent sojourns

    def qos_run():
        for i, v in enumerate(variants[:8]):
            want[srv.submit(flight1_query(Q, *v),
                            tenant="dash" if i % 2 else "adhoc")] = oracle(*v)
        return srv.drain()

    _, qos_s = counted("serve qos", qos_run)
    check(srv, want)
    st = srv.stats()
    if st["n_backpressured"] <= 0 or any(
            r.n_deferred for r in srv.history if r.tenant == "dash"):
        raise AssertionError(f"serve qos: {st}")
    tn = st["tenants"]
    log(f"serve qos: dash's SLO 1 us against its p95 "
        f"{tn['dash']['latency_p95_s'] * 1e3:.3f} ms; {st['n_backpressured']}"
        f" admissions of adhoc deferred (adhoc p95 "
        f"{tn['adhoc']['latency_p95_s'] * 1e3:.3f} ms), none of dash's; all "
        f"= numpy; {summary(srv, qos_s)}")
    del srv

    # 4. adaptive: the ledger's drift folds back into the cost model
    aex = Executor(cat, dev, telemetry=Telemetry(enabled=True))
    srv = QueryServer(aex, streaming=True, morsel_rows=SERVE_MORSEL_ROWS,
                      policy=AdaptivePolicy())
    want = {}

    def adaptive_run():
        for v in variants[:4]:
            want[srv.submit(flight1_query(Q, *v))] = oracle(*v)
        for _ in range(7):
            srv.pump()
        forced = srv.n_recalibrations == 0
        if forced:
            # the policy saw no breach: recost with the ledger's overlay
            # itself, so a recost still lands mid-stream
            aex.recost(aex.tel.ledger.calibration_overlay(aex.cost_model))
        for v in variants[4:8]:
            want[srv.submit(flight1_query(Q, *v))] = oracle(*v)
        srv.drain()
        return forced

    epoch0 = aex.cost_epoch
    forced, adapt_s = counted("serve adaptive", adaptive_run)
    check(srv, want)
    st = srv.stats()
    groups = len(srv._streams["lineorder"].groups)
    if aex.cost_epoch <= epoch0 or groups < 2:
        raise AssertionError(f"serve adaptive: epoch {aex.cost_epoch}, "
                             f"groups {groups}")
    rows = [r for r in aex.tel.ledger.rows if r.mode == "serve"]
    log(f"serve adaptive: n_recalibrations {st['n_recalibrations']}, epoch "
        f"{epoch0} -> {aex.cost_epoch}"
        + (" (the policy saw no breach in 7 pumps; recost with the ledger's"
           " overlay mid-stream)" if forced else "")
        + f"; {len(rows)} serve ledger rows; {groups} pinned groups; all 8 "
        f"= numpy across the recost; {summary(srv, adapt_s)}")
    del srv, aex

    # 5. warm start: a 2 GiB cache saved, a fresh server restored from it
    path = os.path.join(spill_dir, "serve.npz")
    q11 = flight1_query(Q, *FLIGHT1["Q1.1"])
    want11 = oracle(*FLIGHT1["Q1.1"])
    srv = QueryServer(Executor(cat, dev, cache_bytes=CACHE_BYTES),
                      persist_path=path)
    if srv.executor.cache is None:
        raise AssertionError("serve warm start: the executor has no "
                             "semantic cache (is REPRO_CACHE=0 set?)")
    if srv.query(q11) != want11:
        raise AssertionError("serve warm start: Q1.1 differs")
    saved = srv.save_state()
    del srv
    srv = QueryServer(Executor(cat, dev), persist_path=path,
                      semantic_cache=SemanticCache(
                          CACHE_BYTES, host_budget_bytes=HOST_CACHE_BYTES))
    got, warm_s = counted("serve warm start", lambda: srv.query(q11))
    rec = srv.history[-1]
    if not srv.warm_started or srv.warm_started["restored"] < 1 \
            or got != want11 or rec.path != "cached" \
            or any(counts["serve warm start"].values()):
        raise AssertionError(f"serve warm start: {srv.warm_started}, "
                             f"{got}, {rec.path}, "
                             f"{counts['serve warm start']}")
    log(f"serve warm start: {saved['saved']} entries saved, "
        f"{srv.warm_started['restored']} restored into a fresh server; Q1.1 "
        f"took path cached in {warm_s * 1e3:.3f} ms launching nothing, "
        f"= oracle {want11}")
    del srv
    os.unlink(path)
    torch.cuda.empty_cache()
    log(f"serve: phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


# --------------------------------------------------------------------------- #
# sharded execution

SHARD_MORSEL_ROWS = 1 << 22      # 15 morsels over SF 10's lineorder
SHARD_SERVE_QUERIES = 8          # flight-1 variants on the sharded server


def _join_node(phys):
    return next(p for p in _walk_phys(phys) if p.op.startswith("join"))


def phase_shard(dev, ssb_tables, ssb_times, tpch_tables, order_idx):
    """Sharded execution (``Executor(shards=N)``: N contiguous slices of
    each sharded column on the one card).  SSB Q1.1 at SF 10 on 2 and 4
    shards against the oracle and the unsharded run; TPC-H SF 1's two
    joins eager on 4 shards, with both join strategies checked and timed;
    a streaming server on 2 shards against the unsharded one; and the
    eager float filter (B1's float32 entry) against the CPU.  Returns
    launch counts by run."""
    import torch
    from repro_torch.columnar import engine
    from repro_torch.columnar.table import Column, Table
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.core import join as join_core
    from repro_torch.distributed.sharding import ShardLayout
    from repro_torch.kernels import _build
    from repro_torch.query import Executor, Q, QueryServer, Telemetry
    from repro_torch.query import pipeline as qpl

    t_phase = time.perf_counter()
    counts = {}

    def counted(name, fn):
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = dict(_build.LAUNCHES)
        return out, time.perf_counter() - t

    def warm_ms(fn, reps=3):
        """Sorted milliseconds of ``reps`` warm calls (host clock around
        work that ends in a synchronize)."""
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)

    def b2(c):
        return c["probe_counts"] + c["probe_counts_sampled"]

    # 1. SSB Q1.1 at SF 10, resident, on 2 and 4 shards
    want = ssb_oracle(ssb_tables)
    cat = catalog_from_arrays(ssb_tables, dev)
    q = ssb_query(Q)
    n_lo = SSB_LINEORDER_ROWS
    log(f"shard: SSB Q1.1 at SF 10 ({n_lo} rows = 2 x {n_lo // 2}, not a "
        f"multiple of 4); oracle {want}; unsharded (phase ssb) warm medians "
        + ", ".join(f"{m} {ssb_times[m][1][len(ssb_times[m][1]) // 2] * 1e3:.3f}"
                    f" ms" for m in ("batch", "stream", "eager")))
    for n_sh, modes in ((2, ("batch", "stream", "eager")),
                        (4, ("batch", "stream", "eager"))):
        ex = Executor(cat, dev, shards=n_sh)
        plan = ex.explain(q)
        log(f"  {n_sh} shards, plan:\n    " + plan.replace("\n", "\n    "))
        if "placement=sharded" not in plan:
            raise AssertionError(f"{n_sh} shards: no sharded placement")
        node, phys = ex.plan(q.node)
        splan = qpl.analyze(node, ex.catalog.stats)
        sharded_batch = ex._pipeline(node, phys, splan,
                                     rows=None)[0].shard is not None
        if sharded_batch != (n_lo % n_sh == 0):
            raise AssertionError(f"{n_sh} shards: batch step sharded "
                                 f"{sharded_batch}")
        log(f"  {n_sh} shards: the batch step is "
            + ("sharded" if sharded_batch else
               f"the unsharded one ({n_lo} % {n_sh} = {n_lo % n_sh}, as in "
               "the reference)"))
        by_mode = {}
        times = _run_modes(ex, q, modes, equals(want), by_mode,
                           morsel_rows=SHARD_MORSEL_ROWS)
        spec = ex.morsel_spec("lineorder", SHARD_MORSEL_ROWS)
        want_b2 = {"batch": n_sh if sharded_batch else 1,
                   "stream": spec.n_morsels * n_sh}
        for mode, n in want_b2.items():
            if by_mode[mode]["probe_counts"] != n:
                raise AssertionError(f"{n_sh} shards {mode}: B2 launched "
                                     f"{by_mode[mode]['probe_counts']} "
                                     f"times, not {n}")
        eager = by_mode["eager"]
        if eager["select"] <= 0 or eager["probe"] + b2(eager) <= 0:
            raise AssertionError(f"{n_sh} shards eager: {eager}")
        log(f"  {n_sh} shards: B2 launches batch {want_b2['batch']}, "
            f"stream {want_b2['stream']} = {spec.n_morsels} morsels x "
            f"{n_sh} ({n_sh} a morsel); warm medians against unsharded: "
            + ", ".join(
                f"{m} {times[m][1][len(times[m][1]) // 2] * 1e3:.3f} / "
                f"{ssb_times[m][1][len(ssb_times[m][1]) // 2] * 1e3:.3f} ms"
                for m in modes))
        for mode, c in by_mode.items():
            counts[f"ssb {n_sh} shards {mode}"] = c
        del ex

    # 2. TPC-H SF 1, eager on 4 shards: lineitem joined with orders, and
    # the duplicate-keyed join of orders with the filtered lineitem
    tcat = catalog_from_arrays(tpch_tables, dev)
    ex = Executor(tcat, dev, shards=4)
    layout = ShardLayout(4)
    for name, qq, oracle in (
            ("lines", tpch_lines_query(Q),
             tpch_lines_oracle(tpch_tables, order_idx)),
            ("filtered", tpch_query(Q), tpch_oracle(tpch_tables, order_idx))):
        opt, phys = ex.plan(qq.node)
        j = _join_node(phys)
        log(f"  tpch {name} on 4 shards, plan:\n    "
            + ex.explain(qq).replace("\n", "\n    "))
        by_mode = {}
        _run_modes(ex, qq, ("eager",), equals(oracle), by_mode, reps=3)
        c = counts[f"tpch {name} 4 shards eager"] = by_mode["eager"]
        log(f"  tpch {name}: strategy {j.shard_strategy} (shuffle "
            f"{j.alternatives['shard/shuffle'] * 1e3:.3f} ms, broadcast "
            f"{j.alternatives['shard/broadcast'] * 1e3:.3f} ms priced), "
            f"planned passes {j.n_passes}; launches B2 {b2(c)}, B4 "
            f"{c['probe']}")
        if j.shard_strategy == "shuffle" and b2(c) <= 0:
            raise AssertionError(f"tpch {name}: the shuffle launched no B2")

    # both strategies at the engine layer, at full size: the shuffle's
    # pairs against the broadcast join's (probe-row order), each timed
    li = tpch_tables["lineitem"]
    odr = tpch_tables["orders"]
    sharded = ex.plans["sharded"]

    def table(name, col, plan=None):
        return Table(name, {"orderkey": Column(
            torch.from_numpy(col).to(dev), "orderkey")}, plan)

    keep = li["quantity"] == 1
    cases = (("lines", table("lineitem", li["orderkey"], sharded),
              table("orders", odr["orderkey"]), True),
             ("filtered", table("orders", odr["orderkey"], sharded),
              table("lineitem", li["orderkey"][keep]), False))
    for name, lt, rt, unique in cases:
        n_s = rt.num_rows
        s_cap = join_core._round_build_cap(join_core._bucket_cap(n_s, 4))
        passes = {"broadcast": -(-n_s // join_core.HT_CAPACITY),
                  "shuffle": -(-s_cap // join_core.HT_CAPACITY)}
        runs = {"broadcast": lambda: engine.join(lt, rt, "orderkey",
                                                 unique=unique),
                "shuffle": lambda: engine.join_shuffle(lt, rt, "orderkey",
                                                       layout)}
        pairs, said = {}, []
        for strat, run in runs.items():
            pairs[strat], first_s = counted(
                f"tpch {name} {strat} engine", run)
            c = counts[f"tpch {name} {strat} engine"]
            # a strategy that takes seconds (the broadcast over 184
            # passes) is timed warm once, to keep the phase short
            t = warm_ms(run, reps=3 if first_s < 1.0 else 1)
            said.append(f"{strat} {passes[strat]} passes a shard, x 4 "
                        f"shards: B2 {b2(c)}, B4 {c['probe']} launches, "
                        f"warm {t[len(t) // 2]:.3f} ms (min {t[0]:.3f}, "
                        f"max {t[-1]:.3f} over {len(t)}), first "
                        f"{first_s * 1e3:.3f} ms")
        want_b2 = 4 * passes["shuffle"]
        if b2(counts[f"tpch {name} shuffle engine"]) < want_b2:
            raise AssertionError(f"tpch {name}: the shuffle launched B2 "
                                 f"fewer than {want_b2} times")
        bl = pairs["broadcast"].column("l_idx")
        order = torch.argsort(bl, stable=True)
        for col, idx in (("l_idx", order), ("r_idx", order)):
            if not torch.equal(pairs["broadcast"].column(col)[idx],
                               pairs["shuffle"].column(col)):
                raise AssertionError(f"tpch {name}: shuffle {col} differs "
                                     "from the broadcast join's")
        in_order = torch.equal(order, torch.arange(bl.shape[0],
                                                   device=dev))
        log(f"  tpch {name} engine: {lt.num_rows} probe x {n_s} build rows,"
            f" {bl.shape[0]} pairs, the shuffle's bit-identical to the "
            f"broadcast join's "
            + ("as they come" if in_order else
               "in probe-row order (the broadcast join emits pass by pass)")
            + "; " + "; ".join(said))
    del ex, tcat

    # 3. a streaming server on a 2-shard executor against the unsharded
    variants = flight1_variants(SHARD_SERVE_QUERIES)
    oracle = Flight1Oracle(ssb_tables)
    served = {}
    for n_sh in (None, 2):
        tel = Telemetry(enabled=True)
        srv = QueryServer(Executor(cat, dev, shards=n_sh, telemetry=tel),
                          streaming=True, morsel_rows=SHARD_MORSEL_ROWS)
        qids = [srv.submit(flight1_query(Q, *v)) for v in variants]
        res, secs = counted(f"serve {n_sh or 1} shards", srv.drain)
        served[n_sh] = [res[qi] for qi in qids]
        ids = sorted({r.shard for r in tel.ledger.rows if r.mode == "serve"
                      and r.placement == "sharded"})
        log(f"  streaming server, {n_sh or 1} shard(s): "
            f"{len(qids)} flight-1 variants in {secs * 1e3:.3f} ms (traced),"
            f" B2 launches {counts[f'serve {n_sh or 1} shards']['probe_counts']}"
            f", serve ledger rows' shard ids {ids or [-1]}")
        if n_sh and ids != list(range(n_sh)):
            raise AssertionError(f"serve rows carry shard ids {ids}")
    want_served = [oracle(*v) for v in variants]
    if not served[None] == served[2] == want_served:
        raise AssertionError(f"sharded server {served[2]} != unsharded "
                             f"{served[None]} / oracle {want_served}")

    # 4. the eager float filter (B1's float32 entry) against the CPU
    ftab = {"prices": {"price": ssb_price_dollars(ssb_tables),
                       "quantity": ssb_tables["lineorder"]["quantity"]}}
    # the plan DSL keeps integer bounds (``Q.filter`` truncates, as the
    # reference's does), which a float32 column compares exactly
    bounds = tuple(int(b) for b in FLOAT_RANGE)
    fq = Q.scan("prices").filter("price", *bounds) \
        .project("price", "quantity")
    fex = Executor(catalog_from_arrays(ftab, dev), dev)
    got, secs = counted("float filter eager", lambda: fex.execute(
        fq, mode="eager").value)
    if counts["float filter eager"]["select_f32"] <= 0:
        raise AssertionError("the float filter launched no select_f32")
    cpu = Executor(catalog_from_arrays(ftab, "cpu"), "cpu")
    ref = cpu.execute(fq, mode="eager").value
    for col in ("price", "quantity"):
        if not torch.equal(got.column(col).cpu(), ref.column(col)):
            raise AssertionError(f"float filter: {col} differs from the CPU")
    p = ftab["prices"]["price"]
    n_keep = int(((p >= bounds[0]) & (p <= bounds[1])).sum())
    if got.num_rows != n_keep:
        raise AssertionError(f"float filter: {got.num_rows} rows, numpy "
                             f"{n_keep}")
    log(f"  float filter {bounds} on a float32 column of {p.size} "
        f"rows, eager: {got.num_rows} rows (= numpy and the CPU, bit for "
        f"bit) in {secs * 1e3:.3f} ms, launches "
        f"{counts['float filter eager']}")
    log(f"shard: phase took {time.perf_counter() - t_phase:.2f} s")
    return counts


def phase_lm_kernels(dev):
    """B7's two routes at the shapes the LM path runs them at (bf16 at
    every served prefill: llama3-8b's, stablelm-3b's, granite-moe's D 64
    with GQA 3, llama4-scout's GQA 5, qwen2-vl's GQA 7, jamba's GQA 4; f32
    at every model's f32 check, a batch of one; masked by position at
    qwen2-vl's patch prefills, its 256 patches at one t, in both types;
    whisper's encoder (non-causal over 1,500 frames), decoder
    self-attention (causal over 416 tokens) and cross-attention (416
    queries over the 1,500 frames) in bf16 at batch 4 and f32 at batch 1;
    stablelm-3b's training step, bf16, 1 x ``TRAIN_SEQ``) and B8's two
    at the mamba2-780m ones and at jamba's (ds 16, 128 heads): the served
    bf16 prefill and the f32 check's batch of one (and mamba2-780m's
    training step, bf16, 4 x ``TRAIN_SEQ``), against their plain
    versions, timed (B8 also pass by pass); then B7's backward kernel at
    the training shapes (``b7_bwd_row``) and B8's (``b8_bwd_row``: bf16
    at mamba2-780m's training step and, logged only, at jamba's widths;
    f32 at the f32 check's step and, logged only, at both models' widths,
    1 x ``TRAIN_SEQ``).  Returns the 38 JSON rows; a
    row's ``counted_in`` names the run of ``phase_lm`` or ``phase_train``
    whose launches it reports, and its ``counter`` the counter of the
    route its inputs take."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd import ssd as ssd_kernels

    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    s = LM_PROMPT_LEN
    rows = []

    def b7_mask(q, k, causal, q_pos, k_pos):
        """(the pairs this data keeps, the mask's name, SDPA's mask
        arguments: ``is_causal``, or the position mask as a boolean
        mask)."""
        b, sq, h, _ = q.shape
        sk = k.shape[1]
        sdpa_kw = dict(is_causal=causal and q_pos is None)
        if q_pos is not None:
            kept = torch.searchsorted(k_pos.sort(-1).values, q_pos,
                                      right=True)
            sdpa_kw["attn_mask"] = (q_pos[:, None, :, None]
                                    >= k_pos[:, None, None, :])
            return h * int(kept.sum()), "position mask", sdpa_kw
        if causal:                      # the causal half, i >= j
            return b * h * sq * (sq + 1) // 2, "causal", sdpa_kw
        return b * h * sq * sk, "non-causal", sdpa_kw

    def b7_row(name, arch, q, k, v, counted_in, causal=True, q_pos=None,
               k_pos=None, kind=None):
        """One B7 row: the kernel against its plain version, timed beside
        its bound and SDPA on the same inputs (``b7_mask``), misaligned
        views equal to the aligned launch.  A row with a ``kind`` reports
        the launches of that kind of attention (``AttentionKinds``) in its
        run, else the route's."""
        dtype = q.dtype
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        pairs, mask, sdpa_kw = b7_mask(q, k, causal, q_pos, k_pos)
        kw = dict(causal=causal, q_pos=q_pos, k_pos=k_pos)
        tname = str(dtype).split(".")[-1]
        rt = fa.route(dtype, d)
        want = fa_ref.attention_plain(q, k, v, **kw)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= ATTN_TOL[tname]:
            raise AssertionError(f"{name} ({tname}): kernel differs from its "
                                 f"plain version by {err} > "
                                 f"{ATTN_TOL[tname]}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=kvh != h, **sdpa_kw)
        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        del got, want
        size = q.element_size()
        kernel = lambda: fa.flash_attention(q, k, v, **kw)     # noqa: E731
        # q, k, v (and positions) read once and o written once; Q.K^T and
        # P.V over the kept pairs, 2 operations a multiply-add, at the
        # rate of the tensor cores' input type (bf16, or TF32 for the split
        # f32 route: the function's own count, not the split's three
        # products)
        ops = 4 * d * pairs
        pos_bytes = 0 if q_pos is None else 4 * (q_pos.numel()
                                                 + k_pos.numel())
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:71",
            max_abs_err=err, ms=time_ms(kernel, reps=10),
            plain_ms=time_ms(lambda: fa_ref.attention_plain(q, k, v, **kw),
                             reps=3, warmup=1),
            library_ms=time_ms(library, reps=10),
            bytes=size * (2 * q.numel() + k.numel() + v.numel()) + pos_bytes,
            ops=ops, ops_type="bf16" if size == 2 else "tf32",
            counted_in=counted_in, counter=fa.COUNTER[rt],
            **({} if kind is None else {"kind": kind}),
            shape=f"{arch}: q=({b}, {sq}, {h}, {d}), k, v=({b}, {sk}, {kvh}, "
                  f"{d}) {tname}, {mask}, {rt} route"))
        # each operand as a contiguous view one element past a 16-byte
        # mark, which TMA cannot read in place: the wrapper copies it, so
        # the output equals the aligned launch's bit for bit
        aligned = fa.flash_attention(q, k, v, **kw)
        for which in range(3):
            ops_ = [q, k, v]
            buf = torch.empty(ops_[which].numel() + 1, dtype=dtype,
                              device=dev)
            ops_[which] = buf[1:].view(ops_[which].shape)
            ops_[which].copy_((q, k, v)[which])
            if not torch.equal(fa.flash_attention(*ops_, **kw), aligned):
                raise AssertionError(f"{name}: a misaligned {'qkv'[which]} "
                                     "view changes the output")
            del ops_, buf
        del aligned
        extra = (f"; misaligned q, k and v views ({size} bytes off) equal "
                 "the aligned launch bit for bit")
        if dtype == torch.float32:
            extra += (f"; bound on the f32 CUDA cores "
                      f"{ops / FP32_FLOPS_PER_S * 1e3:.4f} ms")
        if q_pos is not None:
            extra += (f"; {pairs / (b * h * sq * sk):.1%} of the pairs kept, "
                      "every kv tile loaded")
        finish_row(rows[-1], agree=f"{tname} max abs err {err:.3e} <= "
                   f"{ATTN_TOL[tname]}; SDPA differs from the plain version "
                   f"by {lib_err:.3e}{extra}")
        del qt, kt, vt
        torch.cuda.empty_cache()

    # the served prefills run batch 4, the f32 checks batch 1
    for arch, dtype, b, name, counted_in in (
            ("llama3-8b", torch.bfloat16, LM_BATCH, "flash_attention_tc",
             "llama3-8b"),
            ("stablelm-3b", torch.bfloat16, LM_BATCH,
             "flash_attention_tc_d80", "stablelm-3b"),
            ("llama3-8b", torch.float32, 1, "flash_attention_f32",
             "llama3-8b f32 check"),
            ("stablelm-3b", torch.float32, 1, "flash_attention_f32_d80",
             "stablelm-3b f32 check"),
            ("granite-moe-3b-a800m", torch.bfloat16, LM_BATCH,
             "flash_attention_tc_granite_moe", "granite-moe-3b-a800m"),
            ("llama4-scout-17b-a16e", torch.bfloat16, LM_BATCH,
             "flash_attention_tc_llama4_scout", "llama4-scout-17b-a16e"),
            ("qwen2-vl-7b", torch.bfloat16, LM_BATCH,
             "flash_attention_tc_qwen2_vl", "qwen2-vl-7b"),
            ("jamba-v0.1-52b", torch.bfloat16, LM_BATCH,
             "flash_attention_tc_jamba", "jamba-v0.1-52b"),
            ("granite-moe-3b-a800m", torch.float32, 1,
             "flash_attention_f32_granite_moe",
             "granite-moe-3b-a800m f32 check"),
            ("llama4-scout-17b-a16e", torch.float32, 1,
             "flash_attention_f32_llama4_scout",
             "llama4-scout-17b-a16e f32 check"),
            ("qwen2-vl-7b", torch.float32, 1, "flash_attention_f32_qwen2_vl",
             "qwen2-vl-7b f32 check"),
            ("jamba-v0.1-52b", torch.float32, 1, "flash_attention_f32_jamba",
             "jamba-v0.1-52b f32 check")):
        cfg = get_arch(arch)
        h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b7_row(name, arch, randn(b, s, h, d, dtype=dtype),
               randn(b, s, kvh, d, dtype=dtype),
               randn(b, s, kvh, d, dtype=dtype), counted_in)

    # qwen2-vl's prefill with its patches sharing one t: the position mask
    # (the served patch prefill in bf16, batch 4; the f32 copy's, batch 1)
    cfg = get_arch("qwen2-vl-7b")
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dtype, b, name, counted_in in (
            (torch.bfloat16, LM_BATCH, "flash_attention_tc_qwen2_vl_pos",
             "qwen2-vl-7b patches"),
            (torch.float32, 1, "flash_attention_f32_qwen2_vl_pos",
             "qwen2-vl-7b f32 patches")):
        t = vlm_positions(cfg, b, s, dev)[..., 0].to(torch.int32)
        t = t.contiguous()
        b7_row(name, "qwen2-vl-7b", randn(b, s, h, d, dtype=dtype),
               randn(b, s, kvh, d, dtype=dtype),
               randn(b, s, kvh, d, dtype=dtype), counted_in, q_pos=t,
               k_pos=t, kind="position")

    # the training step's (phase `train`): stablelm-3b's batch of one at
    # TRAIN_SEQ, the forward and the checkpoint's recompute
    cfg = get_arch("stablelm-3b")
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b7_row("flash_attention_tc_d80_train", "stablelm-3b train",
           randn(1, TRAIN_SEQ, h, d), randn(1, TRAIN_SEQ, kvh, d),
           randn(1, TRAIN_SEQ, kvh, d), "stablelm-3b train")

    def b7_bwd_visits(q, k, causal, q_pos, k_pos):
        """The shares of (q tile, kv tile) pairs that the backward's dK / dV
        blocks and its dQ blocks visit, with the route's tiles
        (``fa.BACKWARD_BLOCKS`` and ``fa.backward_steps``: bf16 64-row q
        tiles past 128-row kv tiles for dK / dV, 64- or 128-row kv tiles
        past 128-row q tiles for dQ), under the position mask the tile
        lists (``fa_ref.kv_tile_visits``: the forward's list for dQ is the
        same rule with the roles of the tile sizes swapped); f32 64-row
        tiles past 64-row steps (32-row above D 64), the same lists under
        the position mask."""
        sq, sk = q.shape[1], k.shape[1]
        _, bk, cq = fa.BACKWARD_BLOCKS[fa.route(q.dtype, q.shape[3])]
        bq, ck = fa.backward_steps(q.dtype, q.shape[3])
        if q_pos is not None:
            return tuple(float(fa_ref.kv_tile_visits(
                q_pos, k_pos, q_tile=qt, kv_tile=kt).float().mean())
                for qt, kt in ((bq, bk), (cq, ck)))
        if not causal:
            return 1.0, 1.0
        # dK / dV: a kv tile from the q tile of its first row on; dQ: a q
        # tile up to the kv tile of its last row
        nq, nk = -(-sq // bq), -(-sk // bk)
        kv_share = sum(nq - n * bk // bq for n in range(nk)) / (nq * nk)
        nq, nk = -(-sq // cq), -(-sk // ck)
        q_share = sum(min(nk, (min((t + 1) * cq, sq) - 1) // ck + 1)
                      for t in range(nq)) / (nq * nk)
        return kv_share, q_share

    def b7_bwd_row(name, arch, q, k, v, counted_in, causal=True, q_pos=None,
                   k_pos=None):
        """One row of B7's backward kernel: its gradients from the forward
        kernel's o and lse against ``plain_backward`` on the same inputs
        within ``ATTN_BWD_TOL`` of each gradient's largest magnitude, two
        calls bit-identical, timed by CUDA events beside its bound (2.5
        times the forward's operations over the kept pairs: the scores
        again, dV, dP, dQ and dK) and SDPA's backward on the same inputs
        (``b7_mask``; timed only), with the shares of tile pairs its blocks
        visit (``b7_bwd_visits``)."""
        dtype = q.dtype
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        tname = str(dtype).split(".")[-1]
        pairs, mask, sdpa_kw = b7_mask(q, k, causal, q_pos, k_pos)
        kw = dict(causal=causal, q_pos=q_pos, k_pos=k_pos)
        rt = fa.route(dtype, d)
        go = randn(b, sq, h, d, dtype=dtype)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        o = fa._launch(q, k, v, causal, q_pos, k_pos, lse)
        got = fa._launch_backward(go, q, k, v, o, lse, **kw)
        again = fa._launch_backward(go, q, k, v, o, lse, **kw)
        want = fa.plain_backward(q, k, v, go, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two backward calls differ")
        err, worst = 0.0, 0.0
        for x, y, which in zip(got, want, ("dq", "dk", "dv")):
            e = float((x.float() - y.float()).abs().max())
            scale = float(y.float().abs().max())
            if not (bool(torch.isfinite(x).all())
                    and e <= ATTN_BWD_TOL[tname] * scale):
                raise AssertionError(
                    f"{name} ({tname}): {which} differs from plain_backward"
                    f" by {e} > {ATTN_BWD_TOL[tname]} x {scale}")
            err, worst = max(err, e), max(worst, e / scale)
        del got, again, want
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=kvh != h,
                                             **sdpa_kw)
        go_t = go.transpose(1, 2)
        library = lambda: torch.autograd.grad(              # noqa: E731
            out, (qt, kt, vt), go_t, retain_graph=True)
        size = q.element_size()
        pos_bytes = 0 if q_pos is None else 4 * (q_pos.numel()
                                                 + k_pos.numel())
        # the scores again, dV, dP, dQ and dK over the kept pairs, 2
        # operations a multiply-add; f32 as split TF32: three tensor-core
        # products for each
        ops = 10 * d * pairs
        steps = fa.backward_steps(dtype, d)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention"
                   + ("_bwd.cu" if size == 2 else ".cu"),
            replaces="src/repro/models/attention.py:63",
            max_abs_err=err,
            ms=time_ms(lambda: fa._launch_backward(go, q, k, v, o, lse,
                                                   **kw), reps=10),
            plain_ms=time_ms(lambda: fa.plain_backward(q, k, v, go, **kw),
                             reps=3, warmup=1),
            library_ms=time_ms(library, reps=10),
            # q, k, v, o, go and lse (and positions) read once; dq, dk, dv
            # written once
            bytes=size * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())
            + 4 * lse.numel() + pos_bytes,
            ops=ops if size == 2 else 3 * ops,
            ops_type="bf16" if size == 2 else "tf32",
            counted_in=counted_in, counter=fa.BACKWARD_COUNTER[rt],
            shape=f"{arch}: q=({b}, {sq}, {h}, {d}), k, v=({b}, {sk}, {kvh}, "
                  f"{d}) {tname}, {mask}, backward "
                  + ("on wgmma, a TMA ring, warp-specialised: dK / dV by "
                     "128-row kv tile, dQ by 128-row q tile"
                     + (", a block a q head" if fa._splits_group(
                         q.device, b, h, kvh, sk) else "")
                     if size == 2 else
                     "on split-TF32 mma.sync (three tensor-core products), "
                     f"64-row tiles, {steps[0]}-row steps, a block a q head"
                     + (", the group's shares summed in order"
                        if h != kvh else ""))))
        seen_kv, seen_q = b7_bwd_visits(q, k, causal, q_pos, k_pos)
        extra = (f"; tile pairs visited: dK / dV {seen_kv:.1%}, dQ "
                 f"{seen_q:.1%}")
        if size == 4:
            extra += ("; bound on the f32 CUDA cores "
                      f"{ops / FP32_FLOPS_PER_S * 1e3:.4f} ms")
        if q_pos is not None:
            extra += f"; {pairs / (b * h * sq * sk):.1%} of the pairs kept"
        finish_row(rows[-1], agree=f"{tname} max abs err {err:.3e}, worst "
                   f"{worst:.3e} of a gradient's largest magnitude <= "
                   f"{ATTN_BWD_TOL[tname]}; two calls bit-identical; "
                   f"SDPA's backward as the library{extra}")
        del qt, kt, vt, out, go, o, lse
        torch.cuda.empty_cache()

    # whisper-large-v3: the encoder over 1,500 frames (non-causal), the
    # decoder's causal self-attention over its prompt and its
    # cross-attention to the frames; bf16 at the served batch, f32 at the
    # f32 check's batch of one
    cfg = get_arch("whisper-large-v3")
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f, sd = cfg.n_audio_frames, LM_PROMPT_LEN_OF["whisper-large-v3"]
    for dtype, b, tag, counted_in in (
            (torch.bfloat16, LM_BATCH, "tc", "whisper-large-v3"),
            (torch.float32, 1, "f32", "whisper-large-v3 f32 check")):
        for part, kind, sq, sk in (("encoder", "square", f, f),
                                   ("self", "causal", sd, sd),
                                   ("cross", "cross", sd, f)):
            b7_row(f"flash_attention_{tag}_whisper_{part}",
                   "whisper-large-v3", randn(b, sq, h, d, dtype=dtype),
                   randn(b, sk, kvh, d, dtype=dtype),
                   randn(b, sk, kvh, d, dtype=dtype), counted_in,
                   causal=kind == "causal", kind=kind)

    # B7's backward at the training shapes: stablelm-3b's step (1 x
    # TRAIN_SEQ, causal), granite-moe's GQA 3, qwen2-vl's patches at one t
    # (the position mask), whisper's encoder (non-causal, square) and its
    # cross-attention (416 queries over 1,500 frames); bf16 as the steps
    # of phase `train` run them, and an f32 copy of each, whose launches
    # are those of stablelm-3b's f32 card-vs-CPU step
    for dtype, tag, f32_run in ((torch.bfloat16, "tc", None),
                                (torch.float32, "f32",
                                 "stablelm-3b f32 train check")):
        for arch, part, sq, sk, form in (
                ("stablelm-3b", "d80_train", TRAIN_SEQ, TRAIN_SEQ, "causal"),
                ("granite-moe-3b-a800m", "granite_moe", TRAIN_SEQ, TRAIN_SEQ,
                 "causal"),
                ("qwen2-vl-7b", "qwen2_vl_pos", TRAIN_SEQ, TRAIN_SEQ,
                 "position"),
                ("whisper-large-v3", "whisper_encoder", f, f, "square"),
                ("whisper-large-v3", "whisper_cross", sd, f, "cross")):
            cfg = get_arch(arch)
            h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            pos = {}
            if form == "position":
                t = vlm_positions(cfg, 1, sq, dev)[..., 0].to(torch.int32)
                pos = dict(q_pos=t.contiguous(), k_pos=t.contiguous())
            b7_bwd_row(f"flash_attention_bwd_{tag}_{part}", arch,
                       randn(1, sq, h, d, dtype=dtype),
                       randn(1, sk, kvh, d, dtype=dtype),
                       randn(1, sk, kvh, d, dtype=dtype),
                       f32_run or f"{arch} train",
                       causal=form in ("causal", "position"), **pos)

    def b8_bwd_row(name, arch, bsz, s_len, dtype, counted_in):
        """One row of B8's backward kernel (``_scan_backward``, its four
        passes) against ``plain_backward`` on the same inputs, in f64 for
        f32 inputs, each gradient within ``SSD_GRAD_TOL`` of its largest
        magnitude and finite, two calls bit-identical; timed by CUDA
        events, pass by pass too, beside its bound (x, gy, dt, b and c read
        once, dx, ddt, db and dc written once; ``ssd_flops(backward=True)``
        operations, in bf16 on the tensor-core route, three times over in
        TF32 on the CUDA-core route's split) and the plain version; the
        chunk pass's cluster of heads C and the clusters the card holds at
        once, and the whole backward at C, at C = 4 and at C = 1 (a share a
        head) in turns.  Mamba-2's init ranges, the final state's
        gradient absent (the model reads y only).  With ``counted_in``
        None (widths that no card path trains at) the row is checked,
        timed and logged, but not listed."""
        cfg = get_arch(arch)
        nh, hd, ng, ds = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.ssm_state
        args = (randn(bsz, s_len, nh, hd, dtype=dtype),
                uniform(0.001, 0.1, bsz, s_len, nh),
                torch.log(uniform(1.0, 16.0, nh)),
                randn(bsz, s_len, ng, ds, dtype=dtype),
                randn(bsz, s_len, ng, ds, dtype=dtype),
                randn(nh, dtype=torch.float32))
        gy = randn(bsz, s_len, nh, hd, dtype=dtype)
        tname = str(dtype).split(".")[-1]
        rt = ssd_kernels.route(dtype, hd, ds)
        got = ssd_kernels._scan_backward(*args, gy, None, 128)
        again = ssd_kernels._scan_backward(*args, gy, None, 128)
        exact = dtype == torch.float32
        want = ssd_kernels.plain_backward(
            *(t.double() if exact else t for t in args),
            gy.double() if exact else gy, None)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two backward calls differ")
        err, worst = 0.0, 0.0
        for g, w, which in zip(got, want, ("dx", "ddt", "da_log", "db",
                                           "dc", "dd_skip")):
            e = float((g.double() - w.double()).abs().max())
            scale = float(w.double().abs().max())
            if not (bool(torch.isfinite(g).all())
                    and e <= SSD_GRAD_TOL[tname] * scale):
                raise AssertionError(
                    f"{name} ({tname}): {which} differs from plain_backward"
                    f" by {e} > {SSD_GRAD_TOL[tname]} x {scale}")
            err, worst = max(err, e), max(worst, e / scale)
        del got, again, want
        bufs = ssd_kernels.backward_buffers(args[0], args[3], 128)
        pass_ms = {p: time_ms(lambda p=p: ssd_kernels.run_backward_passes(
            *args, gy, None, bufs=bufs, passes=(p,)))
            for p in ssd_kernels.BACKWARD_PASSES}
        del bufs
        x, dt, b = args[0], args[1], args[3]
        size = x.element_size()
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/ssd_bwd.cu",
            replaces="src/repro/models/mamba.py:70", max_abs_err=err,
            ms=time_ms(lambda: ssd_kernels._scan_backward(*args, gy, None,
                                                          128)),
            plain_ms=time_ms(lambda: ssd_kernels.plain_backward(*args, gy,
                                                                None),
                             reps=3, warmup=1),
            library_ms=None,
            # x, gy, b, c, dt (and a_log, d_skip) read once; dx, db, dc,
            # ddt (and da_log, dd_skip) written once
            bytes=size * (3 * x.numel() + 4 * b.numel())
            + 4 * (2 * dt.numel() + 4 * nh),
            ops=(1 if rt == "tc" else 3) * ssd_kernels.ssd_flops(
                tuple(x.shape), tuple(b.shape), 128, backward=True),
            ops_type="bf16" if rt == "tc" else "tf32",
            counted_in=counted_in,
            counter=ssd_kernels.BACKWARD_COUNTER[rt],
            shape=f"{arch}: x=({bsz}, {s_len}, {nh}, {hd}) {tname}, dt f32, "
                  f"b, c=({bsz}, {s_len}, {ng}, {ds}) {tname}, chunk 128, "
                  f"gh absent, backward on the {rt} route"
                  + (", chunk pass on wgmma" if rt == "tc" else
                     ", split TF32 on mma.sync"))
        blocks, smem = ssd_kernels.backward_occupancy(dtype, hd, ds,
                                                      128)["chunk"]
        cluster = ssd_kernels.backward_cluster(dtype, hd, ds, nh, ng)
        clusters = ssd_kernels.backward_clusters(dtype, hd, ds, 128, cluster)
        log(f"  {name} passes: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in pass_ms.items())
            + f" (sum {sum(pass_ms.values()):.4f}); chunk pass "
            f"{blocks} block(s) an SM, {smem} shared bytes a block, "
            f"clusters of {cluster} head(s), {clusters} at once")
        log(f"  {name} " + b8_cluster_turns(args, gy, cluster))
        finish_row(row, agree=f"{tname} max abs err {err:.3e}, worst "
                   f"{worst:.2e} of a gradient's largest magnitude (bound "
                   f"{SSD_GRAD_TOL[tname]}"
                   + (", against f64" if exact else "")
                   + "); two calls bit-identical")
        if counted_in is None:
            log(f"  {name}: no card path trains at this shape (jamba "
                "trains on the CPU only; the f32 check trains mamba2-780m at "
                f"{TRAIN_CHECK_LEN} tokens), so it has no launches to "
                "report: logged, not listed")
        else:
            rows.append(row)

    def b8_cluster_turns(args, gy, cluster):
        """The whole backward (``run_backward_passes``, every pass) with
        the chunk pass in clusters of ``cluster``, 4 and 1 heads (those of
        them that divide a group's), in turns: mean ms of each."""
        rep = args[0].shape[2] // args[3].shape[2]
        sizes = [c for c in dict.fromkeys((cluster, 4, 1)) if rep % c == 0]
        bufs = {c: ssd_kernels.backward_buffers(args[0], args[3], 128,
                                                cluster=c) for c in sizes}
        times = {c: [] for c in sizes}
        for turn in range(2):
            for c in sizes if turn == 0 else sizes[::-1]:
                times[c].append(time_ms(
                    lambda c=c: ssd_kernels.run_backward_passes(
                        *args, gy, None, bufs=bufs[c], cluster=c)))
        del bufs
        return "whole backward by cluster, in turns: " + "; ".join(
            f"C={c} " + " / ".join(f"{t:.4f}" for t in times[c]) + " ms"
            for c in sizes)

    # the served prefills (bf16, batch 4) take the tensor-core route; the
    # f32 teacher-forced check's prefill (batch 1) the CUDA-core route; the
    # training step (phase `train`) the tensor-core route at TRAIN_SEQ
    for name, arch, bsz, dtype, counted_in, s in (
            ("ssd_tc", "mamba2-780m", LM_BATCH, torch.bfloat16,
             "mamba2-780m", LM_PROMPT_LEN),
            ("ssd", "mamba2-780m", 1, torch.float32, "mamba2-780m f32 check",
             LM_PROMPT_LEN),
            ("ssd_tc_jamba", "jamba-v0.1-52b", LM_BATCH, torch.bfloat16,
             "jamba-v0.1-52b", LM_PROMPT_LEN),
            ("ssd_jamba", "jamba-v0.1-52b", 1, torch.float32,
             "jamba-v0.1-52b f32 check", LM_PROMPT_LEN),
            ("ssd_tc_train", "mamba2-780m", TRAIN_FULL["mamba2-780m"],
             torch.bfloat16, "mamba2-780m train", TRAIN_SEQ)):
        cfg = get_arch(arch)
        nh, hd, ng, ds = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.ssm_state
        # Mamba-2's own init ranges: dt in [0.001, 0.1], A in [1, 16]
        args = (randn(bsz, s, nh, hd, dtype=dtype),
                uniform(0.001, 0.1, bsz, s, nh),
                torch.log(uniform(1.0, 16.0, nh)),
                randn(bsz, s, ng, ds, dtype=dtype),
                randn(bsz, s, ng, ds, dtype=dtype),
                randn(nh, dtype=torch.float32))
        # per chunk of L tokens: C.B^T and the scores times x over the
        # causal half, C.H^T and the state update in full (the function's
        # own count, not the tensor-core route's split, which doubles three
        # of the four)
        chunks = [min(128, s - t) for t in range(0, s, 128)]
        per_head = sum(2 * (ds + hd) * L * (L + 1) // 2 + 4 * L * hd * ds
                       for L in chunks)
        xx, bb = args[0], args[3]
        tname = str(dtype).split(".")[-1]
        rt = ssd_kernels.route(dtype, hd, ds)
        counter = ssd_kernels.COUNTER[rt]
        if counter != name.replace("_jamba", "").replace("_train", ""):
            raise AssertionError(f"{tname} at hd {hd}, ds {ds} takes the "
                                 f"{rt} route, not {name}")
        y, hf = ssd_kernels.ssd_scan(*args)
        y2, h2 = ssd_kernels.ssd_scan(*args)
        y_p, h_p = ssd_ref.ssd_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(hf, h2)):
            raise AssertionError(f"{name}: two launches on one input differ")
        y_tol = SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL
        torch.testing.assert_close(y.float(), y_p.float(), **y_tol)
        torch.testing.assert_close(hf, h_p, **SSD_TOL)
        err = float((y.float() - y_p.float()).abs().max())
        h_err = float((hf - h_p).abs().max())
        del y2, h2, y_p, h_p
        # each pass alone on the scan's own buffers (state_pass rewrites
        # the scratch in place, which changes no pass's work)
        states, decay = ssd_kernels.scratch(xx, 128, ds)
        yb, hb = torch.empty_like(xx), torch.empty_like(hf)

        def passes(*which):
            ssd_kernels.run_passes(*args, states=states, decay=decay, y=yb,
                                   h=hb, passes=which)
        pass_ms = {p: time_ms(lambda p=p: passes(p)) for p in
                   ssd_kernels.PASSES}
        del states, decay, yb, hb
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/ssd.cu",
            replaces="src/repro/kernels/ssd/ssd.py:71", max_abs_err=err,
            ms=time_ms(lambda: ssd_kernels.ssd_scan(*args)),
            plain_ms=time_ms(lambda: ssd_ref.ssd_plain(*args), reps=3,
                             warmup=1),
            library_ms=None,
            # x, b, c, dt, a_log, d_skip read once; y (x's type) and the
            # final state (f32) written once
            bytes=xx.element_size() * (2 * xx.numel() + 2 * bb.numel())
            + 4 * (args[1].numel() + 2 * nh + hf.numel()),
            ops=bsz * nh * per_head,
            ops_type="bf16" if rt == "tc" else "f32",
            counted_in=counted_in, counter=counter,
            shape=f"{arch}: x=({bsz}, {s}, {nh}, {hd}) {tname}, dt f32, b, "
                  f"c=({bsz}, {s}, {ng}, {ds}) {tname}, chunk 128, {rt} "
                  "route"))
        log(f"  {name} passes: " + ", ".join(
            f"{p} {ms:.4f} ms" for p, ms in pass_ms.items())
            + f" (sum {sum(pass_ms.values()):.4f})")
        finish_row(rows[-1], agree=f"{tname} y max abs err {err:.3e} within "
                   f"{y_tol}, state {h_err:.3e} within {SSD_TOL}; two "
                   "launches bit-identical")
        del y, hf, args, xx, bb
        torch.cuda.empty_cache()

    # B8's backward: the tensor-core route at mamba2-780m's training step
    # and at jamba's widths, the CUDA-core route at the f32 check's step
    # and, logged, at both models' widths in f32 at a training length
    for name, arch, bsz, s_len, dtype, counted_in in (
            ("ssd_bwd_tc_train", "mamba2-780m", TRAIN_FULL["mamba2-780m"],
             TRAIN_SEQ, torch.bfloat16, "mamba2-780m train"),
            ("ssd_bwd_tc_jamba", "jamba-v0.1-52b", LM_BATCH, TRAIN_SEQ,
             torch.bfloat16, None),
            ("ssd_bwd", "mamba2-780m", 1, TRAIN_CHECK_LEN, torch.float32,
             "mamba2-780m f32 train check"),
            ("ssd_bwd_f32_train", "mamba2-780m", 1, TRAIN_SEQ, torch.float32,
             None),
            ("ssd_bwd_f32_jamba", "jamba-v0.1-52b", 1, TRAIN_SEQ,
             torch.float32, None)):
        b8_bwd_row(name, arch, bsz, s_len, dtype, counted_in)
        torch.cuda.empty_cache()
    return rows


def _teacher_forced(mb, model, prompts, **kw):
    """The S-token prefill's last logits, and those of a prefill of the
    first S - 1 tokens followed by one decode step of the last (``kw``:
    the prefills' MoE capacity factor, or an encoder-decoder's frames; a
    decode step never drops)."""
    import torch
    from repro_torch.models import registry
    b, s = prompts.shape

    def caches():
        return registry.make_cache(mb.cfg, b, s, prompts.device,
                                   model.embed.dtype)
    with torch.inference_mode():
        full, _ = mb.prefill_fn(model, prompts, caches(), **kw)
        _, c = mb.prefill_fn(model, prompts[:, :-1], caches(), **kw)
        step, _ = mb.decode_fn(model, prompts[:, -1:], s - 1, c)
    if not (bool(torch.isfinite(full).all())
            and bool(torch.isfinite(step).all())):
        raise AssertionError(f"{mb.cfg.name}: non-finite logits")
    return full, step


def _mixers(cfg):
    """(attention layers, Mamba layers) of a config: the prefill launches
    B7 once for each of the first and B8 once for each of the second; an
    encoder-decoder's attention layers are its encoder's and, twice, its
    decoder's (self- and cross-attention)."""
    if cfg.is_enc_dec:
        return cfg.n_encoder_layers + 2 * cfg.num_layers, 0
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.num_layers))
    return n_attn, cfg.num_layers - n_attn


def _expect_launches(label, counts, cfg, per_layer, b7, b8, b7_bwd=None,
                     steps=0, b8_bwd=None):
    """One ``b7`` launch per attention layer and one ``b8`` launch per
    Mamba layer, ``per_layer`` times (one a prefill); with ``b7_bwd`` and
    ``b8_bwd``, also one call of B7's and of B8's backward kernel per
    attention and per Mamba layer a training step, ``steps`` times."""
    n_attn, n_ssm = _mixers(cfg)
    got = {b7: counts[b7], b8: counts[b8]}
    want = {b7: per_layer * n_attn, b8: per_layer * n_ssm}
    if b7_bwd is not None:
        got[b7_bwd], want[b7_bwd] = counts[b7_bwd], steps * n_attn
    if b8_bwd is not None:
        got[b8_bwd], want[b8_bwd] = counts[b8_bwd], steps * n_ssm
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want} "
                             f"({n_attn} attention and {n_ssm} Mamba layers, "
                             f"{per_layer} prefill(s), {steps} step(s))")


class AttentionKinds:
    """Counts the model's calls of B7's entry (``models.attention.attend``)
    by the kind of attention asked for, while it is entered: ``causal``
    (masked by index), ``position`` (masked by positions), ``square``
    (non-causal, as many keys as queries: an encoder) and ``cross``
    (non-causal, other lengths).  The launch counters say that the kernel
    ran; this says which of its forms each launch took."""

    def __init__(self):
        self.kinds = {}

    def __enter__(self):
        from repro_torch.models import attention
        self._plain = plain = attention.attend

        def attend(q, k, v, *, causal=True, q_pos=None, k_pos=None):
            if causal:
                kind = "causal" if q_pos is None else "position"
            else:
                kind = "square" if q.shape[1] == k.shape[1] else "cross"
            self.kinds[kind] = self.kinds.get(kind, 0) + 1
            return plain(q, k, v, causal=causal, q_pos=q_pos, k_pos=k_pos)
        attention.attend = attend
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.attend = self._plain
        return False

    def expect(self, label, want):
        want = {k: n for k, n in want.items() if n}
        if self.kinds != want:
            raise AssertionError(f"{label}: attention calls by kind "
                                 f"{self.kinds}, want {want}")


def _prefill_kinds(cfg, prefills=1, position=False):
    """The attention kinds a prefill of ``cfg`` asks for, ``prefills``
    times: an encoder-decoder's square, causal and cross layers; a
    decoder's causal ones, masked by position where its positions do not
    rise."""
    if cfg.is_enc_dec:
        return {"square": prefills * cfg.n_encoder_layers,
                "causal": prefills * cfg.num_layers,
                "cross": prefills * cfg.num_layers}
    return {"position" if position else "causal": prefills * _mixers(cfg)[0]}


def vlm_positions(cfg, b, s, dev):
    """Qwen2-VL's M-RoPE (t, h, w) positions (b, s, 3) for its
    ``n_vision_patches`` patches of a square grid at the start of every
    row: the patches share t = 0 and take (h, w) on the grid, and the text
    after them resumes at the grid's side with t = h = w.  t does not rise
    along the row, so attention masks by position."""
    import torch
    n = cfg.n_vision_patches
    side = int(round(n ** 0.5))
    i = torch.arange(s, device=dev)
    text = side + i - n
    t = torch.where(i < n, 0, text)
    h = torch.where(i < n, i // side, text)
    w = torch.where(i < n, i % side, text)
    return torch.stack([t, h, w], -1).expand(b, s, 3)


def _vlm_inputs(cfg, b, s, dev, seed):
    """qwen2-vl's patch embeddings (b, n_vision_patches, d_model) over the
    first positions, and ``vlm_positions``: the patches of its 16 x 16
    grid at one t, as Qwen2-VL lays out an image."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    ve = 0.02 * torch.randn(b, cfg.n_vision_patches, cfg.d_model,
                            generator=g, device=dev)
    return ve.to(torch.bfloat16), vlm_positions(cfg, b, s, dev)


def _prompt_len(cfg):
    return LM_PROMPT_LEN_OF.get(cfg.name, LM_PROMPT_LEN)


def _card_vs_cpu(dev, arch, seed):
    """The card's path against the CPU's plain path on the same weights:
    2 layers at full width (an encoder-decoder: 2 encoder and 2 decoder
    layers, over its frames), a 512-token prompt (whisper: its 416), last
    logits within ``CARD_CPU_TOL``.  The MoE models run on an f32 copy,
    over ``LM_MOE_CHECK_ROWS`` rows, under the routing rule: experts equal
    wherever the CPU's boundary gap exceeds ``LM_ROUTE_MARGIN``, rows
    compared where every decision agrees.  jamba's 2 layers take its
    period-8 schedule's two pairings, attention + FFN (its layer 4) and
    Mamba + MoE (its odd layers).  qwen2-vl's prompt carries its 256
    patch embeddings and Qwen2-VL's positions, masked by position."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_model, draw_frames, draw_prompts
    from repro_torch.models import registry
    from repro_torch.models.moe import MoE

    cfg = dataclasses.replace(get_arch(arch), num_layers=2)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, attn_every=2, attn_offset=0,
                                  moe_every=2, moe_offset=1)
    if cfg.is_enc_dec:
        cfg = dataclasses.replace(cfg, n_encoder_layers=2)
    moe = bool(cfg.n_experts)
    rows = LM_MOE_CHECK_ROWS if moe else 1
    check_len = min(LM_CHECK_LEN, _prompt_len(cfg))
    mb, card = build_model(cfg, dev, seed=seed)
    _, cpu = build_model(cfg, torch.device("cpu"),
                         state_dict=card.state_dict())
    if moe:
        card.float(), cpu.float()
    prompt = draw_prompts(cfg, rows, check_len, seed, dev)
    extra = {}
    if cfg.family == "vlm":
        ve, pos = _vlm_inputs(cfg, rows, check_len, dev, seed + 2)
        extra = dict(vision_embeds=ve.to(card.embed.dtype), positions=pos)
    if cfg.is_enc_dec:
        extra = dict(frames=draw_frames(cfg, rows, seed, dev))
    out, routes = {}, {}
    t0 = time.perf_counter()
    for where, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        seen = []
        hooks = [m.register_forward_hook(
            lambda m, args, out_, seen=seen: seen.append((m, args[0])))
            for m in model.modules() if isinstance(m, MoE)]
        with torch.inference_mode(), AttentionKinds() as kinds:
            caches = registry.make_cache(cfg, rows, check_len, d,
                                         card.embed.dtype)
            out[where] = mb.prefill_fn(
                model, prompt.to(d), caches,
                **{k: v.to(d) for k, v in extra.items()})[0].cpu()
            routes[where] = [m.route(h) for m, h in seen]
        kinds.expect(f"{arch} (2 layers) on the {where}",
                     _prefill_kinds(cfg, position="positions" in extra))
        for hk in hooks:
            hk.remove()
    agree = torch.ones(rows, dtype=torch.bool)
    under = decisions = 0
    for (p_cpu, _, ids_cpu), (_, _, ids_card) in zip(routes["cpu"],
                                                     routes["card"]):
        k = ids_cpu.shape[-1]
        top = p_cpu.sort(-1, descending=True).values
        clear = (top[..., k - 1] - top[..., k]) > LM_ROUTE_MARGIN
        same = (ids_cpu.sort(-1).values
                == ids_card.cpu().sort(-1).values).all(-1)
        if not bool(same[clear].all()):
            raise AssertionError(f"{arch} (2 layers): the card routes a token "
                                 f"clear of the margin {LM_ROUTE_MARGIN} to "
                                 "other experts than the CPU")
        under += int((~clear).sum())
        decisions += clear.numel()
        agree &= same.all(-1)
    if not bool(agree.any()):
        raise AssertionError(f"{arch} (2 layers): no row routes alike")
    err = float((out["card"] - out["cpu"])[agree].abs().max())
    scale = float(out["cpu"][agree].abs().max())
    if not err <= CARD_CPU_TOL * scale:
        raise AssertionError(f"{arch} (2 layers): card logits differ from "
                             f"the CPU's by {err} > {CARD_CPU_TOL} x {scale}")
    what = (f"{rows} x {check_len} prompt"
            + (", f32 copy" if moe else "")
            + (f", {cfg.n_vision_patches} patch embeddings at one t (masked "
               "by position)" if "positions" in extra else "")
            + (f", {cfg.n_audio_frames} frames" if cfg.is_enc_dec else ""))
    route = (f"; routing: {under} of {decisions} decisions within "
             f"{LM_ROUTE_MARGIN} of the boundary, "
             f"{int(agree.sum())} of {rows} rows route alike and are "
             "compared" if moe else "")
    layers = ("2 encoder and 2 decoder layers" if cfg.is_enc_dec
              else "2 layers")
    log(f"lm {arch}, {layers} at full width"
        + (" (attention + FFN, Mamba + MoE)" if cfg.family == "hybrid"
           else "") + f", {what}: card vs CPU last logits max abs diff "
        f"{err:.4e} (max |logit| {scale:.4f}, bound {CARD_CPU_TOL} x){route}"
        f" in {time.perf_counter() - t0:.1f} s")
    del card, cpu
    torch.cuda.empty_cache()


def _patch_prefill(mb, model, cfg, b, dev, seed, label, counts, kinds_of,
                   counter):
    """qwen2-vl's prefill of ``b`` prompts with its patch embeddings and
    Qwen2-VL's positions, at the model's depth and type: finite logits,
    and one ``counter`` launch per attention layer, each masked by
    position."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import registry
    s = _prompt_len(cfg)
    prompts = draw_prompts(cfg, b, s, seed, dev)
    ve, pos = _vlm_inputs(cfg, b, s, dev, seed + 2)
    _build.reset_launches()
    with torch.inference_mode(), AttentionKinds() as kinds:
        lg, _ = mb.prefill_fn(model, prompts, registry.make_cache(
            cfg, b, s, dev, model.embed.dtype),
            vision_embeds=ve.to(model.embed.dtype), positions=pos)
        torch.cuda.synchronize()
    counts[label] = dict(_build.LAUNCHES)
    kinds_of[label] = kinds.kinds
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{label}: non-finite logits")
    _expect_launches(label, counts[label], cfg, 1, counter, "ssd")
    kinds.expect(label, _prefill_kinds(cfg, position=True))
    return (f"{b} x {s} prompt with {cfg.n_vision_patches} patch embeddings "
            f"at one t, {model.embed.dtype}: finite logits, "
            f"{counts[label][counter]} launches, all masked by position")


def _turns_line(what, times, unit) -> str:
    """Medians and spreads (the samples, or quartiles of eight or more)
    of the two sides' seconds, and the medians' ratio."""
    def q(v):
        if len(v) < 8:
            spread = f"samples {[round(t * 1e3, 3) for t in v]}"
        else:
            lo, _, hi = statistics.quantiles(v, n=4)
            spread = (f"quartiles {lo * 1e3:.3f}-{hi * 1e3:.3f}, {len(v)} "
                      "samples")
        return (f"median {statistics.median(v) * 1e3:.3f} ms{unit} "
                f"({spread})")
    p, r = (statistics.median(times[k]) for k in ("plain", "ruled"))
    return (f"{what} in turns (plain, rules, rules, plain, ...): without "
            f"rules {q(times['plain'])}, the launcher's (the host mesh's "
            f"rules, plain tensors) {q(times['ruled'])}: {r / p - 1:+.2%}")


def _decode_turns(dev, cfg, mb, model, prompts, plen) -> str:
    """The decode step as ``serve`` builds it at one rank (the rules of
    the one-rank host mesh passed, the parameters plain) against the step
    without rules, in turns within each of ``TURNS_DECODE_ROUNDS``
    generations (plain, rules, rules, plain, ...: the host's drift falls
    on both alike), each step timed to a synchronize; the tokens must
    be ``generate``'s."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.launch.serve import generate
    from repro_torch.models import registry
    from repro_torch.train.train_loop import (
        greedy, make_decode_step, make_prefill_step,
    )

    b, n = prompts.shape[0], LM_GEN_LEN - 1
    want = generate(mb, model, prompts, LM_GEN_LEN)
    times = {"plain": [], "ruled": []}
    with process_group(dev):
        rules = sharding.resolve(cfg, make_host_mesh(dev), ShapeConfig(
            "serve", plen + LM_GEN_LEN, b, "prefill"))
        steps = {"plain": make_decode_step(mb, model),
                 "ruled": make_decode_step(mb, model, rules)}
        with torch.inference_mode():
            for r in range(TURNS_DECODE_ROUNDS):
                caches = registry.make_cache(cfg, b, plen + LM_GEN_LEN, dev,
                                             model.embed.dtype)
                logits, caches = make_prefill_step(mb, model)(prompts,
                                                              caches)
                out = [greedy(cfg, logits)]
                for i in range(n):
                    # each generation starts on the other side
                    key = ("plain", "ruled", "ruled", "plain")[(i + 2 * r)
                                                               % 4]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tok, _, caches = steps[key](out[-1], plen + i, caches)
                    torch.cuda.synchronize()
                    times[key].append(time.perf_counter() - t0)
                    out.append(tok)
                if not torch.equal(torch.cat(out, 1), want):
                    raise AssertionError("decode in turns: tokens differ "
                                         "from generate's")
    return _turns_line(f"decode steps ({TURNS_DECODE_ROUNDS} generations "
                       f"of {n})", times, "/step")


def phase_lm(dev, seed):
    """Serve every model of ``LM_ARCHS`` at full width (and full depth but
    for the cuts of ``LM_DEPTH``), the teacher-forced and card-vs-CPU path
    checks; qwen2-vl also prefills with its patch embeddings at one t,
    masked by position, in bf16 and on its f32 copy.  Returns launch
    counts by run and the attention calls by kind (``AttentionKinds``) of
    the same runs."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import (
        build_model, draw_frames, draw_prompts, generate, serve,
    )
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    counts, kinds_of = {}, {}
    for arch in LM_ARCHS:
        cfg = get_arch(arch)
        depth, why = LM_DEPTH.get(arch, (None, ""))
        if depth is not None:
            log(f"lm {arch}: reduced to {depth} of {cfg.num_layers} layers "
                f"at full width ({why}; {cfg.param_count() / 1e9:.1f} B "
                f"params at full depth, one card of 80 GB)")
            cfg = dataclasses.replace(cfg, num_layers=depth)
        warm_runs = LM_WARM_RUNS_OF.get(arch, LM_WARM_RUNS)
        plen = _prompt_len(cfg)
        # the identity holds where nothing drops: capacity factor E / k
        kw = {"capacity_factor": cfg.n_experts / cfg.top_k} \
            if cfg.n_experts else {}
        # an encoder-decoder's frames, as serve draws them
        frames = draw_frames(cfg, LM_BATCH, seed, dev) if cfg.is_enc_dec \
            else None

        def inputs(rows):
            return kw if frames is None else {"frames": frames[:rows]}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with AttentionKinds() as kinds:
            if depth is None:
                toks = serve(arch, smoke=False, prompt_len=plen,
                             gen_len=LM_GEN_LEN, batch=LM_BATCH, seed=seed,
                             stats=stats)
            else:       # serve's own steps on the cut config
                mb, model = build_model(cfg, dev, seed=seed)
                toks = generate(mb, model, draw_prompts(
                    cfg, LM_BATCH, plen, seed, dev), LM_GEN_LEN,
                    stats=stats)
            torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts[arch] = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        RESULTS[f"{arch} tokens"] = toks.cpu()
        _expect_launches(arch, counts[arch], cfg, 1, "flash_attention_tc",
                         "ssd_tc")
        kinds.expect(arch, _prefill_kinds(cfg))
        kinds_of[arch] = kinds.kinds
        if toks.shape != (LM_BATCH, LM_GEN_LEN) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{arch}: tokens {tuple(toks.shape)} out of "
                                 f"shape or range")
        if depth is None:
            mb, model = build_model(cfg, dev, seed=seed)
        n_params = sum(p.numel() for p in model.parameters())
        prompts = draw_prompts(cfg, LM_BATCH, plen, seed, dev)
        warm, same = [], True
        for _ in range(warm_runs):
            st = {}
            same &= torch.equal(generate(mb, model, prompts, LM_GEN_LEN,
                                         frames=frames, stats=st), toks)
            warm.append(st)
        warm.sort(key=lambda st: st["prefill_s"] + st["decode_s"])
        med = warm[len(warm) // 2]
        MEASURED[f"{arch} prefill"] = med["prefill_s"]
        steps = LM_GEN_LEN - 1
        layers = (f"{cfg.n_encoder_layers} encoder and {cfg.num_layers} "
                  f"decoder layers" if cfg.is_enc_dec
                  else f"{cfg.num_layers} layers")
        audio = (f" and {LM_BATCH} x {cfg.n_audio_frames} frames"
                 if cfg.is_enc_dec else "")
        log(f"lm {arch}: {layers}, {n_params:,} params, "
            f"{LM_BATCH} x {plen} prompt{audio} -> {LM_BATCH} x "
            f"{LM_GEN_LEN} greedy tokens; first run ("
            f"{'serve' if depth is None else 'build_model + generate'}, "
            f"weights drawn on the card) {first * 1e3:.1f} ms: prefill "
            f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
            f"{stats['decode_s'] * 1e3 / steps:.3f} ms/token; warm median "
            f"of {warm_runs}: prefill {med['prefill_s'] * 1e3:.3f} ms, "
            f"decode {med['decode_s'] * 1e3 / steps:.3f} ms/token, "
            f"{LM_BATCH * LM_GEN_LEN / (med['prefill_s'] + med['decode_s']):.1f}"
            f" tok/s (prefill + decode), decode alone "
            f"{LM_BATCH * steps / med['decode_s']:.1f} tok/s; warm tokens "
            f"{'equal' if same else 'DIFFER from'} the first run's; peak "
            f"device memory {peak / 2 ** 30:.2f} GiB; launches {counts[arch]}"
            f"; attention calls {kinds.kinds}")
        if arch == LAUNCH_SERVE_ARCH:
            log("    " + _decode_turns(dev, cfg, mb, model, prompts, plen))
        t_warm = time.perf_counter()
        if arch in LM_PROFILE_ARCHS:
            log(f"    prefill + {LM_PROFILE_TOKENS - 1} decode steps "
                + profile_once(lambda: generate(mb, model, prompts,
                                                LM_PROFILE_TOKENS,
                                                frames=frames)))
        t_prof = time.perf_counter()
        if cfg.family == "vlm":
            # the served depth with its patch embeddings spliced in
            log("    prefill " + _patch_prefill(
                mb, model, cfg, LM_BATCH, dev, seed, f"{arch} patches",
                counts, kinds_of, "flash_attention_tc"))
        # the identity prefill(S) == prefill(S - 1) + decode(1), in the
        # served bf16 (beside the rounding noise of the same prompt served
        # alone rather than in the batch) and sharply on an f32 copy
        full, step = _teacher_forced(mb, model, prompts, **inputs(LM_BATCH))
        with torch.inference_mode():
            alone, _ = mb.prefill_fn(model, prompts[:1], registry.make_cache(
                cfg, 1, plen, dev), **inputs(1))
        noise = float((alone[0] - full[0]).abs().max())
        err, scale = float((full - step).abs().max()), float(full.abs().max())
        if not err <= TF_TOL * scale:
            raise AssertionError(f"{arch}: teacher-forced decode differs from "
                                 f"the prefill by {err} > {TF_TOL} x {scale}")
        f32_depth = LM_F32_DEPTH.get(arch)
        if f32_depth is not None:
            # the same seed draws the same first layers
            del model
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, num_layers=f32_depth)
            mb, model = build_model(cfg, dev, seed=seed)
        model.float()
        _build.reset_launches()
        with AttentionKinds() as kinds:
            full, step = _teacher_forced(mb, model, prompts[:1], **inputs(1))
        label = f"{arch} f32 check"
        counts[label] = dict(_build.LAUNCHES)
        kinds_of[label] = kinds.kinds
        _expect_launches(label, counts[label], cfg, 2, "flash_attention_f32",
                         "ssd")
        kinds.expect(label, _prefill_kinds(cfg, prefills=2))
        err32 = float((full - step).abs().max())
        scale32 = float(full.abs().max())
        if not err32 <= TF_TOL_F32 * scale32:
            raise AssertionError(f"{arch} (f32): teacher-forced decode differs "
                                 f"from the prefill by {err32} > {TF_TOL_F32}"
                                 f" x {scale32}")
        log(f"    teacher-forced {plen - 1} + 1 tokens vs the "
            f"{plen}-token prefill, last logits"
            + (f" (capacity factor {kw['capacity_factor']:g}: nothing drops)"
               if kw else "") + f": bf16 max abs diff "
            f"{err:.4e} (max |logit| {scale:.4f}, bound {TF_TOL} x; the first "
            f"prompt served alone vs in the batch of {LM_BATCH}: {noise:.4e})"
            f"; f32 copy"
            + (f" at {f32_depth} layers (the served depth's is too large)"
               if f32_depth else "")
            + f", 1 prompt: {err32:.4e} (max |logit| {scale32:.4f}, "
            f"bound {TF_TOL_F32} x); no NaN")
        if cfg.family == "vlm":
            log("    f32 copy: prefill " + _patch_prefill(
                mb, model, cfg, 1, dev, seed, f"{arch} f32 patches", counts,
                kinds_of, "flash_attention_f32"))
        del model, toks
        torch.cuda.empty_cache()
        t_end = time.perf_counter()
        log(f"    {arch} took {t_end - t0:.1f} s: first run and warm runs "
            f"{t_warm - t0:.1f}, profile {t_prof - t_warm:.1f}, checks "
            f"{t_end - t_prof:.1f}")

    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        _card_vs_cpu(dev, arch, seed)
        log(f"    {arch} card vs CPU took {time.perf_counter() - t0:.1f} s")
    log(f"lm: phase took {time.perf_counter() - t_phase:.2f} s")
    return counts, kinds_of


def _train_full(dev, arch, batch, seed):
    """``launch.train.train`` at full width and depth on the card:
    ``TRAIN_STEPS`` AdamW steps on one repeated batch of ``batch`` x
    ``TRAIN_SEQ`` tokens, finite and falling loss, finite norms, two
    launches a mixer layer a step (the forward and the checkpoint's
    recompute) and one call of B7's and of B8's backward kernel an
    attention or Mamba layer a step; then one more step profiled (the
    device time of each backward's kernels, summed by name; the step fails
    if any op runs under B8's former plain backward's label), after which
    every parameter's gradient must be non-zero.  Returns the
    launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd import ssd as ssd_kernels
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_loop import make_train_step

    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    stats = {}
    model, losses = train_mod.train(
        arch, smoke=False, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
        global_batch=batch, seed=seed, device=dev, log_every=1,
        overfit_batch=True, stats=stats)
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    label = f"{arch} train"
    _expect_launches(label, counts, cfg, 2 * TRAIN_STEPS,
                     "flash_attention_tc", "ssd_tc", "flash_attention_bwd_tc",
                     TRAIN_STEPS, "ssd_bwd_tc")
    steps = stats["steps"]
    if not all(np.isfinite([st["loss"], st["grad_norm"]]).all()
               for st in steps):
        raise AssertionError(f"{label}: non-finite loss or norm {steps}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall on one "
                             f"repeated batch: {losses}")
    warm = sorted(st["s"] for st in steps[1:])
    med = warm[len(warm) // 2]
    MEASURED[f"{arch} train step"] = med
    RESULTS[f"{arch} losses"] = losses
    tokens = batch * TRAIN_SEQ
    n = sum(p.numel() for p in model.parameters())
    log(f"train {arch}: {cfg.num_layers} layers, {n:,} params, {batch} x "
        f"{TRAIN_SEQ} tokens a step, AdamW, {TRAIN_STEPS} steps on one "
        f"repeated batch: loss {' -> '.join(f'{x:.4f}' for x in losses)}; "
        f"grad norm {steps[0]['grad_norm']:.3f} -> "
        f"{steps[-1]['grad_norm']:.3f}; first step {steps[0]['s'] * 1e3:.1f}"
        f" ms, warm median of {len(warm)} {med * 1e3:.1f} ms [min "
        f"{warm[0] * 1e3:.1f}, max {warm[-1] * 1e3:.1f}], "
        f"{tokens / med:,.0f} tokens/s, 6 N tokens / step time "
        f"{6 * n * tokens / med / 1e12:.1f} TFLOP/s = "
        f"{6 * n * tokens / med / BF16_FLOPS_PER_S:.1%} of "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} bf16; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; launches {counts}")
    mb = registry.bundle(cfg)
    opt = AdamW()
    step = make_train_step(mb, model, opt)
    state = opt.init(dict(model.named_parameters()))
    batch_ = {k: v.to(dev) for k, v in synthetic_batch(
        DataConfig(cfg.vocab_size, TRAIN_SEQ, batch, seed), 0).items()}
    if arch == LAUNCH_TRAIN_ARCH:
        log("    " + _step_turns(dev, cfg, mb, model, opt, state, batch_))
    log("    one more step " + profile_once(
        lambda: step(state, batch_), top=4,
        kernels=((fa.BACKWARD, "bwd::"),
                 (ssd_kernels.BACKWARD, ssd_kernels.BACKWARD_KERNELS)),
        require=tuple(rng for rng, counter in (
            (fa.BACKWARD, "flash_attention_bwd_tc"),
            (ssd_kernels.BACKWARD, "ssd_bwd_tc")) if counts.get(counter))))
    # that step's first moment m is 0.1 x the clipped gradient
    dead = [n for n, t in state["m"].items() if not bool(t.any())]
    if dead:
        raise AssertionError(f"{label}: no gradient reaches {dead}")
    log(f"    every one of its {len(state['m'])} parameters' gradients "
        "non-zero (read from AdamW's first moment)")
    del model, step, state, batch_
    torch.cuda.empty_cache()
    return counts


def _step_turns(dev, cfg, mb, model, opt, state, batch) -> str:
    """The train step as ``launch.train.train`` builds it at one rank (the
    rules of the one-rank host mesh, plain parameters) against
    ``make_train_step`` without rules, in turns on one model, state and
    batch: each step's seconds (a synchronize on both sides)."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.train.train_loop import make_train_step

    b, s = batch["tokens"].shape
    with process_group(dev):
        rules = sharding.resolve(cfg, make_host_mesh(dev), ShapeConfig(
            "train", s, b, "train"))
        steps = {"plain": make_train_step(mb, model, opt),
                 "ruled": make_train_step(mb, model, opt, rules)}
        times = {"plain": [], "ruled": []}
        for key in ("plain", "ruled", "ruled", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[key](state, batch)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
    return _turns_line("warm train steps", times, "")


def _train_cut(dev, arch, seed):
    """One AdamW step of ``arch`` at 2 layers (2 encoder and 2 decoder
    layers) and full width, batch 1: finite loss and norm, two launches a
    mixer layer and one backward call an attention layer, and every
    parameter's gradient non-zero (read from the
    first moment m, 0.1 x the clipped gradient after one step).  Returns
    the launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import build_model
    from repro_torch.train.data import DataConfig, Pipeline
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_loop import make_train_step

    cfg = dataclasses.replace(get_arch(arch), num_layers=2)
    if cfg.is_enc_dec:
        cfg = dataclasses.replace(cfg, n_encoder_layers=2)
    s = TRAIN_SEQ_OF.get(arch, TRAIN_SEQ)
    torch.cuda.empty_cache()
    mb, model = build_model(cfg, dev, seed=seed)
    opt = AdamW()
    step = make_train_step(mb, model, opt)
    state = opt.init(dict(model.named_parameters()))
    batch = Pipeline(DataConfig(cfg.vocab_size, s, 1, seed), dev,
                     extras_fn=train_mod._extras_fn(
                         cfg, model.embed.dtype)).next()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    label = f"{arch} train (2 layers)"
    _expect_launches(label, counts, cfg, 2, "flash_attention_tc", "ssd_tc",
                     "flash_attention_bwd_tc", 1, "ssd_bwd_tc")
    m = {k: float(v) for k, v in metrics.items()}
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        raise AssertionError(f"{label}: non-finite metrics {m}")
    dead = [n for n, t in state["m"].items() if not bool(t.any())]
    if dead:
        raise AssertionError(f"{label}: no gradient reaches {dead}")
    extra = (f"{s} frames and " if cfg.is_enc_dec else
             f"{cfg.n_vision_patches} patch embeddings, " if
             cfg.family == "vlm" else "")
    log(f"train {arch}, 2{' + 2' if cfg.is_enc_dec else ''} layers at full "
        f"width, {sum(p.numel() for p in model.parameters()):,} params, one "
        f"AdamW step over {extra}1 x {s} tokens: loss {m['loss']:.4f} (ce "
        f"{m['ce']:.4f}, aux {m['aux']:.4f}), grad norm "
        f"{m['grad_norm']:.3f}, {dt * 1e3:.1f} ms (the first step), every "
        f"parameter's gradient non-zero; launches {counts}")
    del model, step, state, batch
    torch.cuda.empty_cache()
    return counts


def _train_card_vs_cpu(dev, arch, seed):
    """The loss and every gradient of a 2-layer full-width f32 copy of
    ``arch`` on the card (the kernels' f32 routes and their autograd
    Functions, under the checkpointed layers) against the same weights on
    the CPU (plain autograd), over ``TRAIN_CHECK_LEN`` tokens: loss within
    ``TRAIN_LOSS_TOL``, each gradient within ``TRAIN_GRAD_TOL`` of its
    leaf's largest magnitude, each non-zero on the card; B7 / B8 launched
    twice a layer and B7's and B8's backward kernels once an attention or
    Mamba layer.  Returns the card's launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import build_model
    from repro_torch.train.data import DataConfig, synthetic_batch

    cfg = dataclasses.replace(get_arch(arch), num_layers=2)
    t0 = time.perf_counter()
    mb, card = build_model(cfg, dev, seed=seed)
    _, cpu = build_model(cfg, torch.device("cpu"), seed=seed)
    card.float(), cpu.float()
    cpu.load_state_dict(card.state_dict())
    batch = synthetic_batch(DataConfig(cfg.vocab_size, TRAIN_CHECK_LEN, 1,
                                       seed), 0)
    out = {}
    for where, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        _build.reset_launches()
        loss, _ = mb.loss_fn(model, {k: v.to(d) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
        out[where] = (float(loss.detach()), {n: g.cpu() for n, g in
                                    zip(params, grads)},
                      dict(_build.LAUNCHES))
    label = f"{arch} (2 layers, f32) train"
    _expect_launches(label + " on the card", out["card"][2], cfg, 2,
                     "flash_attention_f32", "ssd", "flash_attention_bwd_f32",
                     1, "ssd_bwd")
    loss_card, loss_cpu = out["card"][0], out["cpu"][0]
    if not abs(loss_card - loss_cpu) <= TRAIN_LOSS_TOL * abs(loss_cpu):
        raise AssertionError(f"{label}: loss {loss_card} on the card, "
                             f"{loss_cpu} on the CPU")
    worst, dead = (0.0, ""), []
    for n, g_cpu in out["cpu"][1].items():
        g_card = out["card"][1][n]
        if not bool(g_card.any()):
            dead.append(n)
        rel = float((g_card - g_cpu).abs().max()) / max(
            float(g_cpu.abs().max()), 1e-30)
        worst = max(worst, (rel, n))
    if dead:
        raise AssertionError(f"{label}: no gradient reaches {dead} on the "
                             "card")
    if not worst[0] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"{label}: gradient {worst[1]} differs by "
                             f"{worst[0]:.3e} of its largest magnitude > "
                             f"{TRAIN_GRAD_TOL}")
    log(f"train {arch}, 2 layers at full width, f32, 1 x {TRAIN_CHECK_LEN} "
        f"tokens: card vs CPU loss {loss_card:.6f} / {loss_cpu:.6f}; "
        f"{len(out['cpu'][1])} gradients, each non-zero on the card, the "
        f"worst {worst[1]} at {worst[0]:.3e} of its largest magnitude "
        f"(bound {TRAIN_GRAD_TOL}); launches {out['card'][2]} in "
        f"{time.perf_counter() - t0:.1f} s")
    del card, cpu
    torch.cuda.empty_cache()
    return out["card"][2]


def _train_restarts(dev, seed, tmp):
    """Checkpoints on the card, at smoke size (a cut depth and width):
    ``run_with_restarts`` over stablelm-3b's train step with a failure
    injected after a checkpoint, its losses and final weights equal to an
    uninterrupted run's bit for bit and its last checkpoint restoring the
    final state bit for bit; and ``launch.train.train`` with a checkpoint
    directory run twice on mamba2-780m (2 steps, then on to 4), its
    losses and step-4 checkpoint equal to one 4-step run's."""
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import build_model
    from repro_torch.train import checkpoint
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.fault_tolerance import run_with_restarts
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_loop import make_train_step

    t0 = time.perf_counter()
    cfg = smoke_config(get_arch("stablelm-3b"))
    dc = DataConfig(cfg.vocab_size, 128, 2, seed)

    def supervised(name, fail_at):
        mb, model = build_model(cfg, dev, seed=seed)
        opt = AdamW(lr=1e-3, warmup=2)
        train_step = make_train_step(mb, model, opt)
        losses = {}

        def step_fn(step, state):
            model.load_state_dict(state["params"])
            opt_state, m = train_step(state["opt"], {
                k: v.to(dev) for k, v in synthetic_batch(dc, step).items()})
            losses[step] = float(m["loss"])
            return {"step": state["step"] + 1, "params": model.state_dict(),
                    "opt": opt_state}
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "params": model.state_dict(),
                 "opt": opt.init(dict(model.named_parameters()))}
        state, stats = run_with_restarts(
            step_fn, state, n_steps=6, ckpt_dir=str(tmp / name),
            ckpt_every=2, fail_at=fail_at)
        return state, stats, [losses[i] for i in range(6)]

    state, stats, losses = supervised("restarts", [3])
    clean, _, clean_losses = supervised("clean", [])
    if not (losses == clean_losses and stats.restarts == 1
            and all(torch.equal(a, b) for (_, a), (_, b) in
                    zip(checkpoint.flatten(state),
                        checkpoint.flatten(clean)))):
        raise AssertionError(f"run_with_restarts on the card: losses "
                             f"{losses} against {clean_losses}, {stats}")
    back, man = checkpoint.restore(tmp / "restarts", state)
    if man["step"] != 6 or not all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(checkpoint.flatten(back), checkpoint.flatten(state))):
        raise AssertionError("the last checkpoint does not restore the final "
                             "state bit for bit")
    log(f"train checkpoints: run_with_restarts, stablelm-3b smoke on the "
        f"card, 6 steps, checkpoint every 2, a failure injected at step 3: "
        f"{stats}; losses equal the uninterrupted run's bit for bit "
        f"({', '.join(f'{x:.4f}' for x in losses)}), final state too; the "
        f"last checkpoint ({len(man['leaves'])} leaves) restores it bit for "
        "bit")
    kw = dict(smoke=True, seq_len=128, global_batch=2, ckpt_every=2,
              seed=seed, device=dev, log_every=100)
    _, whole = train_mod.train("mamba2-780m", steps=4,
                               ckpt_dir=str(tmp / "whole"), **kw)
    _, first = train_mod.train("mamba2-780m", steps=2,
                               ckpt_dir=str(tmp / "split"), **kw)
    model, rest = train_mod.train("mamba2-780m", steps=4,
                                  ckpt_dir=str(tmp / "split"), **kw)
    like = {"params": model.state_dict()}
    a, _ = checkpoint.restore(tmp / "whole", like, step=4)
    b, _ = checkpoint.restore(tmp / "split", like, step=4)
    if not (first + rest == whole and all(
            torch.equal(a["params"][k], b["params"][k]) for k in a["params"])):
        raise AssertionError(f"train() resumed: losses {first} + {rest} "
                             f"against {whole}")
    log(f"train checkpoints: launch.train.train, mamba2-780m smoke on the "
        f"card, 2 steps and then on to 4 from its checkpoint: losses "
        f"{', '.join(f'{x:.4f}' for x in first + rest)} equal one 4-step "
        f"run's bit for bit, and so does the step-4 checkpoint; "
        f"{time.perf_counter() - t0:.1f} s")


def phase_train(dev, seed):
    """LM training on the card: stablelm-3b and mamba2-780m at full width
    and depth through ``launch.train.train`` (``_train_full``); one step
    of each other trainable family at 2 layers (``_train_cut``); the f32
    card-vs-CPU gradients (``_train_card_vs_cpu``); why jamba trains on
    the CPU only; checkpoints and restarts (``_train_restarts``).  Returns
    the launch counts by run."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    counts = {}
    for arch, batch in TRAIN_FULL.items():
        t0 = time.perf_counter()
        counts[f"{arch} train"] = _train_full(dev, arch, batch, seed)
        log(f"    {arch} train took {time.perf_counter() - t0:.1f} s")
    for arch in TRAIN_CUT:
        counts[f"{arch} train"] = _train_cut(dev, arch, seed)
    for arch in TRAIN_FULL:
        counts[f"{arch} f32 train check"] = _train_card_vs_cpu(dev, arch,
                                                               seed)
    jamba = get_arch("jamba-v0.1-52b")
    whole = dataclasses.replace(jamba, num_layers=math.lcm(
        jamba.attn_every, jamba.moe_every))
    n = whole.param_count()
    log(f"train jamba-v0.1-52b: on the CPU only (tests/"
        f"test_torch_train_models.py): its smallest whole schedule is "
        f"{whole.num_layers} layers, {n / 1e9:.1f} B params, "
        f"{16 * n / 1e9:.0f} GB with bf16 params and grads and the f32 "
        f"AdamW master, m and v, against one card of 80 GB; its parts (B7, "
        f"B8, the MoE) train on the card in the models above")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        _train_restarts(dev, seed, Path(tmp))
    torch.cuda.empty_cache()
    log(f"train: phase took {time.perf_counter() - t_phase:.2f} s")
    return counts


def _torchrun(module: str, args: list, label: str):
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m module args`` from the checkout, in a process
    group of its own -> a handle for ``_finish``."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.path.join(HERE, "src")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", module, *args]
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return proc, cmd, label, time.perf_counter()


def _finish(handle):
    """A ``_torchrun`` child's standard output and seconds, once it exits;
    its process group killed whole after ``LAUNCH_CHILD_TIMEOUT_S``.  A
    child that fails fails the phase."""
    import signal
    proc, cmd, label, t0 = handle
    try:
        out, err = proc.communicate(timeout=LAUNCH_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"launch {label}: over {LAUNCH_CHILD_TIMEOUT_S}"
                             f" s: {' '.join(cmd)}")
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launch {label}: exited {proc.returncode}: "
                             f"{' '.join(cmd)}\n{out[-3000:]}\n{err[-3000:]}")
    return out, dt


def _printed(out: str, prefix: str, label: str):
    """The one line of ``out`` that starts with ``prefix``, the rest of it
    read as JSON where it is JSON, else as text."""
    lines = [x[len(prefix):] for x in out.splitlines()
             if x.startswith(prefix)]
    if len(lines) != 1:
        raise AssertionError(f"launch {label}: {len(lines)} lines start "
                             f"with {prefix!r}: {out[-3000:]}")
    try:
        return json.loads(lines[0])
    except json.JSONDecodeError:
        return lines[0]


def _child_checks(out: str, tag: str, label: str, cfg, per_layer: int):
    """A child's mesh line (one NCCL rank started from torchrun's
    environment on cuda:0) and its B7 / B8 launches, ``per_layer`` a mixer
    layer -> (the mesh line, the launches)."""
    from repro_torch.kernels import _build
    mesh = _printed(out, f"[{tag}] mesh ", label)
    if LAUNCH_MESH not in mesh:
        raise AssertionError(f"launch {label}: mesh {mesh}")
    counts = dict.fromkeys(_build.LAUNCHES, 0)
    counts.update(_printed(out, f"[{tag}] kernel launches ", label))
    _expect_launches(label, counts, cfg, per_layer, "flash_attention_tc",
                     "ssd_tc")
    return mesh, {k: n for k, n in counts.items() if n}


def phase_launch(dev, seed):
    """The launchers' CLIs under torchrun, as users start them, one NCCL
    rank each: training and serving at full size against phases train's
    and lm's in-process runs, and a save and a restore at smoke size."""
    import re

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    arch = LAUNCH_TRAIN_ARCH
    cfg = get_arch(arch)
    label = f"{arch} train child"
    out, dt = _finish(_torchrun("repro_torch.launch.train", [
        "--arch", arch, "--full", "--seq-len", str(TRAIN_SEQ),
        "--global-batch", str(TRAIN_FULL[arch]), "--steps",
        str(LAUNCH_TRAIN_STEPS), "--overfit-batch", "--seed", str(seed),
        "--log-every", "1"], label))
    mesh, counts = _child_checks(out, "train", label, cfg,
                                 2 * LAUNCH_TRAIN_STEPS)
    losses = _printed(out, "[train] losses ", label)
    want = RESULTS[f"{arch} losses"][:LAUNCH_TRAIN_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    if len(losses) != LAUNCH_TRAIN_STEPS or not rel <= LAUNCH_LOSS_REL:
        raise AssertionError(f"{label}: losses {losses}, phase train's "
                             f"{want}")
    step_ms = [float(x) for x in re.findall(r"dt=(\d+)ms", out)]
    log(f"launch {label}: {mesh}; losses {losses} against phase train's "
        f"{want} (largest relative difference {rel:.3e}, bound "
        f"{LAUNCH_LOSS_REL}); steps {step_ms} ms; launches {counts}; the "
        f"child took {dt:.1f} s")

    # the serve child beside the checkpoint child (a smoke model: both fit)
    ckpt_arch = LAUNCH_CKPT_ARCH
    kw = dict(seq_len=128, global_batch=2, seed=seed, ckpt_every=2,
              log_every=100)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        ckpt = _torchrun("repro_torch.launch.train", [
            "--arch", ckpt_arch, "--steps", "2", "--ckpt-dir", tmp,
            *(x for k, v in kw.items()
              for x in (f"--{k.replace('_', '-')}", str(v)))],
            f"{ckpt_arch} checkpoint child")
        arch = LAUNCH_SERVE_ARCH
        cfg = get_arch(arch)
        label = f"{arch} serve child"
        out, dt = _finish(_torchrun("repro_torch.launch.serve", [
            "--arch", arch, "--no-smoke", "--prompt-len", str(LM_PROMPT_LEN),
            "--gen-len", str(LM_GEN_LEN), "--batch", str(LM_BATCH),
            "--seed", str(seed)], label))
        mesh, counts = _child_checks(out, "serve", label, cfg, 1)
        toks = torch.tensor(_printed(out, "[serve] tokens ", label))
        want = RESULTS[f"{arch} tokens"]
        if not torch.equal(toks, want):
            raise AssertionError(f"{label}: tokens differ from phase lm's "
                                 f"in {int((toks != want).sum())} of "
                                 f"{want.numel()} places")
        timing = [x for x in out.splitlines()
                  if x.startswith(f"[serve] {arch}")]
        log(f"launch {label}: {mesh}; {LM_BATCH} x {LM_GEN_LEN} tokens "
            f"equal phase lm's; {timing}; launches {counts}; the child "
            f"took {dt:.1f} s")

        label = ckpt[2]
        out, dt = _finish(ckpt)
        saved = sorted(os.listdir(tmp))
        t0 = time.perf_counter()
        _, rest = train_mod.train(ckpt_arch, steps=4, ckpt_dir=tmp,
                                  device=dev, **kw)
        dt_rest = time.perf_counter() - t0
        kept = sorted(os.listdir(tmp))
    if saved != ["step_00000002"] or kept != ["step_00000002",
                                               "step_00000004"]:
        raise AssertionError(f"{label}: checkpoints {saved}, then {kept}")
    got = _printed(out, "[train] losses ", label) + rest
    _, whole = train_mod.train(ckpt_arch, steps=4, device=dev, **kw)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, whole))
    if len(got) != 4 or not rel <= LAUNCH_CKPT_REL:
        raise AssertionError(f"{label}: losses {got}, uninterrupted {whole}")
    log(f"launch {label}: smoke size, 2 steps saved at step 2 by the child "
        f"(beside the serve child, {dt:.1f} s), then resumed on to 4 in "
        f"this process ({dt_rest:.1f} s): losses {got} against an "
        f"uninterrupted in-process run's {whole} (largest relative "
        f"difference {rel:.3e}, bound {LAUNCH_CKPT_REL})")
    torch.cuda.empty_cache()
    log(f"launch: phase took {time.perf_counter() - t_phase:.2f} s")


def _cp_decode(dev, seed, mesh):
    """Context-parallel decode at long_500k on the one-rank mesh: the whole
    sequence against the oracle, then the local part over 4 and 8 slices
    combined over the slice dim against one slice, each timed."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.distributed import context_parallel as cp

    cfg = get_arch(DIST_ARCH)
    h, d = cfg.n_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
               for shape in ((1, h, 1, d), (1, CP_SEQ, h, d),
                             (1, CP_SEQ, h, d)))
    pos = torch.arange(CP_SEQ, device=dev)[None]
    valid = pos < CP_VALID
    kv_bytes = 2 * k.numel() * k.element_size()
    bound_ms = kv_bytes / HBM_BYTES_PER_S * 1e3
    torch.cuda.reset_peak_memory_stats()
    got = cp.cp_decode_attention(mesh, "model", q, k, v, valid)
    want = cp.cp_decode_reference(q, k, v, valid)
    peak = torch.cuda.max_memory_allocated()
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    if got.shape != q.shape or got.dtype != q.dtype or \
            not torch.isfinite(got).all() or err > CP_TOL * top:
        raise AssertionError(f"cp_decode_attention: {tuple(got.shape)} "
                             f"{got.dtype}, max error {err} of {top}")
    ms = time_ms(lambda: cp.cp_decode_attention(mesh, "model", q, k, v,
                                                valid), reps=5, warmup=1)
    ref_ms = time_ms(lambda: cp.cp_decode_reference(q, k, v, valid),
                     reps=5, warmup=1)
    log(f"distributed cp_decode_attention: {DIST_ARCH} widths at long_500k, "
        f"q 1 x {h} x 1 x {d}, k, v 1 x {CP_SEQ:,} x {h} x {d} bf16 "
        f"({kv_bytes / 1e9:.2f} GB), first {CP_VALID:,} valid, one "
        f"{dist.get_backend()} rank: max error {err:.3g} of {top:.3g} "
        f"against cp_decode_reference; {ms:.3f} ms ({kv_bytes / ms / 1e6:,.1f} GB/s"
        f" of k and v), the oracle {ref_ms:.3f} ms; bound {bound_ms:.3f} ms "
        f"(k and v read once), {bound_ms / ms:.1%} of it; peak "
        f"{peak / 2 ** 30:.2f} GiB")
    gap = valid & ~((pos >= CP_GAP[0]) & (pos < CP_GAP[1]))
    whole = cp.combine_stacked(*(t[None] for t in cp.cp_local(q, k, v, gap)))
    top = float(whole.abs().max())
    for n in CP_SLICES:
        bounds = [CP_SEQ * i // n for i in range(n + 1)]

        def sliced(n=n, bounds=bounds):
            parts = [cp.cp_local(q, k[:, a:b], v[:, a:b], gap[:, a:b])
                     for a, b in zip(bounds, bounds[1:])]
            return cp.combine_stacked(*(torch.stack(x) for x in zip(*parts)))
        empty = [i for i, (a, b) in enumerate(zip(bounds, bounds[1:]))
                 if not bool(gap[:, a:b].any())]
        out = sliced()
        err = float((out - whole).abs().max())
        if not empty or not torch.isfinite(out).all() or \
                err > CP_F32_TOL * top:
            raise AssertionError(f"cp over {n} slices (empty {empty}): "
                                 f"max error {err} of {top}")
        ms = time_ms(sliced, reps=3, warmup=1)
        log(f"    the local part over {n} slices ({', '.join(map(str, empty))}"
            f" with no valid key), combined over the slice dim: f32 within "
            f"{err:.3g} of one slice's ({top:.3g} the largest); {ms:.3f} ms "
            f"({kv_bytes / ms / 1e6:,.1f} GB/s)")
    del q, k, v, got, want, whole
    torch.cuda.empty_cache()


def _pipeline_block(dev, seed, mesh):
    """``pipeline_apply`` at one rank over a llama3-8b gated MLP block:
    equal to the block microbatch by microbatch, bit for bit, and to the
    block over the whole batch within ``PIPE_TOL``; both timed."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pipeline
    from repro_torch.models.common import MLP, init_params, rmsnorm

    cfg = get_arch(PIPE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mlp = MLP(cfg, cfg.d_ff, dev)
    init_params(mlp, gen)
    params = {"mlp": mlp, "norm": 0.02 * torch.randn(
        cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)}

    def block(p, x):
        return x + p["mlp"](rmsnorm(x, p["norm"]))

    x = torch.randn(PIPE_BATCH, PIPE_SEQ, cfg.d_model, generator=gen,
                    device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        got = pipeline.pipeline_apply(mesh, "model", block, params, x,
                                      PIPE_MICRO)
        mb = PIPE_BATCH // PIPE_MICRO
        by_micro = torch.cat([block(params, x[i:i + mb])
                              for i in range(0, PIPE_BATCH, mb)])
        whole = block(params, x)
        err = float((got.float() - whole.float()).abs().max())
        top = float(whole.float().abs().max())
        if not torch.equal(got, by_micro) or err > PIPE_TOL * top:
            raise AssertionError(
                f"pipeline_apply: equal to the block by microbatch "
                f"{torch.equal(got, by_micro)}, max error {err} of {top} "
                "against the whole batch")
        ms = time_ms(lambda: pipeline.pipeline_apply(
            mesh, "model", block, params, x, PIPE_MICRO), reps=5, warmup=1)
        whole_ms = time_ms(lambda: block(params, x), reps=5, warmup=1)
    log(f"distributed pipeline_apply: one stage ({PIPE_ARCH} gated MLP, d_ff "
        f"{cfg.d_ff:,}, RMS norm, residual) over {PIPE_BATCH} x {PIPE_SEQ:,} "
        f"x {cfg.d_model:,} bf16 in {PIPE_MICRO} microbatches: equal to the "
        f"block by microbatch bit for bit, within {err:.3g} of the whole "
        f"batch's ({top:.3g} the largest); {ms:.3f} ms against the block "
        f"over the whole batch {whole_ms:.3f} ms; bubble fraction at "
        f"{PIPE_MICRO} microbatches over 4 stages "
        f"{pipeline.bubble_fraction(PIPE_MICRO, 4):.3f}")
    del mlp, params, x, got, by_micro, whole
    torch.cuda.empty_cache()


def _gradient_tree(specs, gen, dev):
    import torch
    return {k: torch.randn(la.shape, generator=gen, device=dev)
            for k, la in specs.items()}


def _compression(dev, seed, mesh, specs):
    """``compress_tree`` over ``COMP_STEPS`` steps of error feedback on a
    mamba2-780m gradient-shaped f32 tree; the first two layers' payloads
    and residuals against the CPU's; ``compressed_psum`` on the one-rank
    group against ``dequantize(quantize(g + r))``."""
    import torch
    from repro_torch.distributed import compression as comp

    gen = torch.Generator(device=dev).manual_seed(seed)
    n = sum(math.prod(la.shape) for la in specs.values())
    res = None
    cpu_res = {k: torch.zeros(la.shape) for k, la in specs.items()
               if k.startswith(COMP_CPU_LAYERS)}
    g_sum = {k: torch.zeros(la.shape, device=dev) for k, la in specs.items()}
    d_sum = {k: torch.zeros(la.shape, device=dev) for k, la in specs.items()}
    ms = []
    for step in range(COMP_STEPS):
        g = _gradient_tree(specs, gen, dev)
        if res is None:
            res = comp.zero_residual(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_tree, new_res = comp.compress_tree(g, res)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        cpu_q, cpu_new = comp.compress_tree(
            {k: g[k].cpu() for k in cpu_res}, cpu_res)
        for k in cpu_res:
            (q, s), (cq, cs) = q_tree[k], cpu_q[k]
            if not (torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
                    and torch.equal(new_res[k].cpu(), cpu_new[k])):
                raise AssertionError(f"compress_tree step {step}: {k} on the "
                                     "card differs from the CPU")
        cpu_res = cpu_new
        deq = comp.decompress_tree(q_tree)
        for k in specs:
            g_sum[k] += g[k]
            d_sum[k] += deq[k]
            fed = g[k] + res[k]
            _, scale = q_tree[k]
            amax = float(fed.abs().max())
            bound = float(scale) * 0.5 + 2 * amax * 2 ** -23
            if float(new_res[k].abs().max()) > bound:
                raise AssertionError(f"step {step}: {k}'s residual exceeds "
                                     f"half its step {bound}")
            track = float((d_sum[k] - g_sum[k]).abs().max())
            if track > bound + 1e-5 * float(g_sum[k].abs().max()):
                raise AssertionError(f"step {step}: {k}'s summed signal is "
                                     f"{track} from the summed gradient")
        res = new_res
        del q_tree, deq
    fn = comp.compressed_psum(mesh, "model")
    g = _gradient_tree(specs, gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, psum_res = fn(g, res)
    torch.cuda.synchronize()
    psum_ms = (time.perf_counter() - t0) * 1e3
    q_tree, want_res = comp.compress_tree(g, res)
    want = comp.decompress_tree(q_tree)
    for k in specs:
        if not (torch.equal(mean[k], want[k])
                and torch.equal(psum_res[k], want_res[k])):
            raise AssertionError(f"compressed_psum: {k} is not "
                                 "dequantize(quantize(g + r))")
    moved = 13 * n                 # g, r read (f32); q (int8), r written
    log(f"distributed compression: {COMP_ARCH}'s {len(specs)} leaves, "
        f"{n:,} f32 values ({4 * n / 1e9:.2f} GB): compress_tree over "
        f"{COMP_STEPS} steps of error feedback, every residual within half "
        f"its leaf's step and the summed signal on the summed gradient; "
        f"the first two layers' payloads, scales and residuals equal the "
        f"CPU's bit for bit; compressed_psum on the one-rank group equals "
        f"dequantize(quantize(g + r)) exactly; compress_tree "
        f"{' / '.join(f'{t:.1f}' for t in ms)} ms a step "
        f"({moved / min(ms) / 1e6:,.1f} GB/s of {moved / 1e9:.2f} GB read "
        f"and written), compressed_psum {psum_ms:.1f} ms")
    del g, res, mean, psum_res, q_tree, want, want_res, g_sum, d_sum
    torch.cuda.empty_cache()


def _restore_onto_mesh(dev, seed, specs, rules, tmp):
    """mamba2-780m's full-width params saved, then restored as DTensors
    on the card's mesh: local tensors and global norm bit for bit."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import global_norm

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = {k: (0.02 * torch.randn(la.shape, generator=gen, device=dev))
              .to(la.dtype) for k, la in specs.items()}
    t0 = time.perf_counter()
    path = checkpoint.save(tmp, 1, params)
    save_s = time.perf_counter() - t0
    file_bytes = sum(f.stat().st_size for f in path.iterdir())
    shardings = sharding.tree_shardings(specs, rules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = checkpoint.restore(tmp, params, shardings=shardings)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for k, x in got.items():
        local = x.to_local() if isinstance(x, DTensor) else None
        if local is None or local.device.type != torch.device(dev).type or \
                x.placements != shardings[k][1] or \
                not torch.equal(local, params[k]):
            raise AssertionError(f"restore(shardings=): {k} is not the saved "
                                 "leaf as a DTensor on the card")
    n_saved = float(global_norm(params.values()))
    n_got = float(global_norm(x.to_local() for x in got.values()))
    if n_saved != n_got:
        raise AssertionError(f"global norm {n_got} against {n_saved}")
    log(f"distributed restore onto the mesh: {COMP_ARCH}'s {len(specs)} "
        f"params ({sum(t.numel() for t in params.values()):,} bf16) saved in "
        f"{save_s:.2f} s ({file_bytes / 1e9:.2f} GB on disk, bf16 stored as "
        f"f32), restored as DTensors on the card in {load_s:.2f} s "
        f"({file_bytes / load_s / 1e9:.2f} GB/s from a warm file), every "
        f"local tensor bit for bit, global norm {n_got:.6f} both")
    del params, got
    torch.cuda.empty_cache()


def phase_distributed(dev, seed):
    """The distributed layer on a one-rank NCCL group (``make_host_mesh``
    starts it): context-parallel decode at long_500k whole and over 4 and
    8 slices, the pipeline, compression, restore onto the mesh, and every
    arch's divisibility on both production meshes."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    mesh = make_host_mesh(dev)
    try:
        log(f"distributed: {mesh} over a one-rank {dist.get_backend()} "
            "group")
        _cp_decode(dev, seed, mesh)
        _pipeline_block(dev, seed, mesh)
        cfg = get_arch(COMP_ARCH)
        specs = registry.bundle(cfg).init_specs(1)
        _compression(dev, seed, mesh, specs)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
            _restore_onto_mesh(dev, seed, specs,
                               sharding.resolve(cfg, mesh), Path(tmp))
    finally:
        del mesh
        dist.destroy_process_group()
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for name, cfg in sorted(all_archs().items()):
            problems = sharding.validate_divisibility(
                registry.bundle(cfg).init_specs(16),
                sharding.resolve(cfg, mesh))
            if problems:
                raise AssertionError(f"{name} on {mesh.shape}: {problems}")
        log(f"distributed divisibility: every arch's tp-16 specs on the "
            f"{mesh.shape} mesh, no problem")
    torch.cuda.empty_cache()
    log(f"distributed: phase took {time.perf_counter() - t_phase:.2f} s")


_DRYRUN_CHILD = r'''
import json, sys, time
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh

spec = json.loads(sys.argv[1])
for arch, shape, multi in spec["cells"]:
    t0 = time.perf_counter()
    cell = dryrun.run_guarded(arch, shape, multi, save_hist=False)
    cell["wall_s"] = time.perf_counter() - t0
    print(json.dumps(cell), flush=True)
one = AbstractMesh((1, 1), ("data", "model"))
for arch, (name, seq, batch, kind), key in spec["one_rank"]:
    t0 = time.perf_counter()
    cell = dryrun.run_guarded(arch, name, False, mesh=one, save_hist=False,
                              shape=ShapeConfig(name, seq, batch, kind))
    cell["wall_s"] = time.perf_counter() - t0
    cell["measured"] = key
    print(json.dumps(cell), flush=True)
'''


def _gb(x) -> str:
    return f"{x / 1e9:.3f} GB"


def phase_dryrun(card: str):
    """The dry run in a child process (no card, its own fake process
    groups): the production cells and the one-rank cells, each ``ok``; the
    one-rank cells' bounds beside phases lm's and train's measured warm
    medians, as a share."""
    t_phase = time.perf_counter()
    spec = {"cells": DRYRUN_CELLS, "one_rank": DRYRUN_ONE_RANK}
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", _DRYRUN_CHILD,
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=DRYRUN_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f"dryrun: the child exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    cells = [json.loads(line) for line in res.stdout.splitlines()
             if line.startswith("{")]
    if len(cells) != len(DRYRUN_CELLS) + len(DRYRUN_ONE_RANK):
        raise AssertionError(f"dryrun: {len(cells)} cells came back: "
                             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    for c in cells:
        key = f"{c['arch']}|{c['shape']}|{c['mesh']}"
        if c.get("status") != "ok":
            raise AssertionError(f"dryrun {key}: {c.get('status')} "
                                 f"{c.get('error')} {c.get('trace', '')}")
        rl, mem = c["roofline"], c["memory"]
        by_kind = ", ".join(f"{k} {c['collectives'][k]} x "
                            f"{_gb(c['coll_operand_by_kind'][k])}"
                            for k in sorted(c["collectives"]))
        log(f"dryrun {key} ({c['chips']} ranks, {c['wall_s']:.1f} s): "
            f"{c['flops_per_dev']:.4g} FLOP, {_gb(c['bytes_per_dev'])} "
            f"moved a device; collectives {by_kind or 'none'} (operand "
            f"{_gb(c['coll_operand_bytes'])}, wire "
            f"{_gb(c['coll_wire_bytes'])}); memory arguments "
            f"{_gb(mem['argument_bytes'])}, temp {_gb(mem['temp_bytes'])}, "
            f"aliased {_gb(mem['alias_bytes'])}; roofline t_compute "
            f"{rl['t_compute'] * 1e3:.3f} ms, t_memory "
            f"{rl['t_memory'] * 1e3:.3f} ms, t_collective "
            f"{rl['t_collective'] * 1e3:.3f} ms ({rl['bottleneck']}), "
            f"useful / counted FLOPs {rl['useful_flops_ratio']:.3f}, MFU "
            f"bound {rl['mfu_bound']:.3f}")
        if "measured" in c:
            t_bound = max(rl["t_compute"], rl["t_memory"],
                          rl["t_collective"])
            took = MEASURED.get(c["measured"])
            if took is None:
                raise AssertionError(f"dryrun {key}: no measured "
                                     f"{c['measured']} in this run")
            log(f"    {c['measured']}: roofline bound "
                f"{t_bound * 1e3:.3f} ms against the measured warm median "
                f"{took * 1e3:.3f} ms on {card}: "
                f"{t_bound / took:.1%} of it")
    log(f"dryrun: phase took {time.perf_counter() - t_phase:.2f} s "
        f"(limit {DRYRUN_TIMEOUT_S} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # f32 matmuls (the plain versions, the logits) in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    card = phase_card()
    phase_build()

    t0 = time.perf_counter()
    ssb = make_ssb(SSB_LINEORDER_ROWS, args.seed)
    tpch, order_idx = make_tpch(TPCH_LINEITEM_ROWS, TPCH_ORDERS_ROWS,
                                args.seed)
    log(f"data: made in {time.perf_counter() - t0:.2f} s (seed {args.seed})")

    log("kernels against their plain versions:")
    rows = phase_kernels(dev, ssb, tpch)
    ssb_counts, ssb_times = phase_ssb(dev, ssb)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as spill_dir:
        cal_counts, copy_row, cal = phase_calibrate(dev, ssb, spill_dir)
        spill_counts = phase_spill(dev, ssb, cal, spill_dir)
        tel_counts = phase_telemetry(dev, ssb, ssb_counts, ssb_times, cal,
                                     spill_dir, args.seed)
        cache_counts = phase_cache(dev, ssb, tpch, order_idx, ssb_times, cal,
                                   spill_dir, args.seed)
        serve_counts = phase_serve(dev, ssb, cal, spill_dir)
    shard_counts = phase_shard(dev, ssb, ssb_times, tpch, order_idx)
    del ssb
    tpch_counts = phase_tpch(dev, tpch, order_idx)
    glm_counts, sgd_rows = phase_glm(dev, args.seed)
    multi_counts, multi_rows = phase_multi_join(dev, tpch)
    del tpch
    log("lm kernels against their plain versions at the serving shapes:")
    lm_rows = phase_lm_kernels(dev)
    lm_counts, lm_kinds = phase_lm(dev, args.seed)
    train_counts = phase_train(dev, args.seed)
    lm_counts.update(train_counts)
    phase_launch(dev, args.seed)
    phase_distributed(dev, args.seed)
    phase_dryrun(card)
    rows += [*multi_rows, *sgd_rows, copy_row] + lm_rows

    key = {"select_range": "select", "select_f32": "select_f32",
           "probe_counts": "probe_counts",
           "probe_counts_sampled": "probe_counts_sampled",
           "hash_probe": "probe", "probe_multi": "probe_multi",
           "probe_multi_sampled": "probe_multi_sampled",
           "sgd": "sgd", "sgd_split": "sgd_split",
           "sgd_split_news20": "sgd_split",
           "stream_copy": "stream_copy"}
    for row in rows:
        # a row that a phase counted itself keeps its own count; a B7 or
        # B8 row names its route's counter and reports the launches of the
        # LM run at its shape (a B7 row with a kind, those of its kind of
        # attention, each of which the run checked to have launched)
        counter = row.pop("counter", None) or key[row["name"]]
        if "counted_in" in row:
            run, kind = row.pop("counted_in"), row.pop("kind", None)
            row["launches"] = lm_kinds[run].get(kind, 0) if kind else \
                lm_counts[run][counter]
        row.setdefault("launches", sum(c[counter]
                                       for counts in (ssb_counts, tpch_counts,
                                                      glm_counts, multi_counts,
                                                      cal_counts, spill_counts,
                                                      tel_counts, cache_counts,
                                                      serve_counts, shard_counts,
                                                      lm_counts)
                                       for c in counts.values()))
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 "path")
        row.pop("shape")
    log(f"tpch launches: {tpch_counts}; glm launches: {glm_counts}; "
        f"calibrate launches: {cal_counts}; spill launches: {spill_counts}; "
        f"telemetry launches: {tel_counts}; cache launches: "
        f"{cache_counts}; serve launches: {serve_counts}; shard launches: "
        f"{shard_counts}; lm launches: {lm_counts}")
    by_name = {row["name"]: row for row in rows}
    copy, ring = by_name["stream_copy"], by_name["sgd"]
    steps = GLM_EPOCHS * MNIST_ROWS // GLM_MINIBATCH
    log(f"stream_copy {copy['ms']:.4f} ms against torch.add(x, 1) "
        f"{copy['library_ms']:.4f} ms ({copy['ms'] / copy['library_ms']:.4f}"
        f"x), {copy['bound_ms'] / copy['ms']:.1%} of the byte bound; sgd "
        f"ring {ring['ms']:.4f} ms a launch at the MNIST shape, "
        f"{ring['ms'] * 1e3 / steps:.3f} us a step")
    log(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
