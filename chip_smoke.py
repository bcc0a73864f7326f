#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

  1. env      torch / CUDA / nvcc versions and the card (nvidia-smi).
  2. build    compiles every kernel source under
              `src/repro_torch/kernels/*/csrc` (one nvcc each, all at once)
              and prints what ptxas reports (registers, static shared
              memory, stack and spills) for each kernel instance, failing
              on a spill in the simplex, SSD or CCKP kernels; then the
              pivot kernels' lanes per CTA at the fleet shape, each SSD
              kernel's, the CCKP instances' and the RG-LRU geometries'
              dynamic shared memory and CTAs per SM (the occupancy
              calculator).
  3. kernels  each kernel against its plain PyTorch version at the shapes
              its main path gives it: the simplex kernels at 16384 lanes,
              R = 14 rows, C0 = 38 columns (random, masked, degenerate and
              Bland lanes; integer outputs exact, floats to rtol/atol
              1e-12; timed with the launches queued behind a device sleep,
              so that the device's time is read, and again without it,
              where the host's launch rate may set the time), and
              reduced_pivot also at the LP of 16 jobs (R 18, C0 50, a
              compiled instance) and of 20 (R 22, C0 62, the generic
              one); the CCKP kernel on 16384 grids of 1201 x 13 cells,
              p and accuracies from the fleet's profiles: both models of
              an AMDP call in one `models_dp` launch from the start grid,
              and one model (`model_dp`'s m = 1) on the first model's
              output, then 4 grids of 4001 x 301 (the global-memory
              instance), each bitwise against its plain version, with
              its bound (bytes: 8 + 4 m a cell); the flash attention kernel
              at the LM path's shapes (paper_edge's ES model: 32 jobs x 64
              tokens, 8 heads on 4 KV heads, head_dim 64, causal;
              gemma3-1b: 2 x 2048 tokens, 4 heads on 1, head_dim 256,
              window 512 and causal) and a ragged unmasked one, each in
              bfloat16 and float32 (float32 to 1e-5, bfloat16 to 2^-7
              relative and absolute).  Kernel and plain times (CUDA
              events) beside each bound; for flash attention also the
              time of `scaled_dot_product_attention` on the same inputs
              (the library column, never on the port's path), and for
              flash attention and flash-decode each row's TFLOP/s and
              bound share (bound ms / ms); the first float32 case of the
              card tests 20 times, every repeat within 1e-5 of float64
              attention and of the plain version on the card and on the
              host (unless the host's own float32 result is more than
              1e-5 from float64: that is printed as the host's fault).
              The SSD scan kernels at mamba2-130m's shapes (8 x 2048
              tokens, 24 heads, P 64, N 128, chunk 256, decays past
              exp's float32 overflow) in bfloat16 and float32, held with
              their plain
              version to the float64 recurrence (errors beside their
              bars), the bound priced at the TF32 tensor rate, the
              kernels one call launches with each one's device time and
              CTAs per SM; the flash-decode kernel
              through the model's entry at gemma3-1b's decode shapes (4
              sequences, 4 q heads on 1, head_dim 256, rings of 512 and
              1032 slots; recurrentgemma-9b: 16 q heads on 1, a ring of
              2048 slots), in bfloat16 and float32, with SDPA timed beside
              it.  Flash attention also at recurrentgemma-9b's shape (2 x
              4096 tokens, 16 heads on 1 KV head, head_dim 256, window
              2048).  The RG-LRU recurrence kernel at recurrentgemma-9b's
              forward and prefill shapes (2 x 4096, 4 x 2100 and 1 x
              2100 tokens x 4096 channels, a and b from the model's
              gates) and a ragged one (1 x 2085 x 999, a in (0.9, 1);
              again at W 1000, where the tiles load in 16-byte copies)
              in the geometry
              `launch_geometry` picks (printed with its shared memory and
              CTAs per SM), with its plain log-step scan and its own order
              (`rglru_tiled_ref`), all held to the float64 recurrence;
              timed queued and unqueued with inputs past the L2, beside
              its bound share; then every compiled (C, L, stages)
              instance at each shape, timed and checked; its library
              column is null (no single PyTorch call computes a linear
              recurrence).
  4. rollout  the tensor engine's path: `EngineParams.from_fleet` ->
              `init_state` -> `rollout` of a 16384-device fleet for 8
              periods, once per LP method, with every kernel's launch
              counter set to 0 just before and read just after; the two
              methods must agree (integer metrics exact, float metrics to
              1e-9) with no unsolved lane.  Then one more rollout per
              method with the LP's pivot calls recorded (every 16th call
              and the last of each simplex phase), each replayed through
              its kernel (bitwise the rollout's own call; against its
              plain version; reduced_pivot also against its serial order
              recomputed in float64 on the CPU on every lane, the lanes
              its plain version decides otherwise counted, capped and
              each held within the rounding bound of a reordered sum)
              and timed beside its bound, and the
              rollout's estimated kernel time and loss (launches x mean
              ms, launches x mean (ms - bound)).
  5. front    `repro_torch.api.solve(fp, policy="auto")` on a 16384-device
              `FleetProblem`, half identical-job rows, half heterogeneous
              rows: per-solver device counts, seconds, launches per kernel;
              AMR^2 rows within 2T, AMDP rows within T, and the first 256
              rows equal to the same solve on the CPU.
  6. serve    the host `FleetEngine` (`policy="auto"`) on 16384 devices of
              one job class for 8 periods, counters set to 0 before and
              read after: per period the AMDP and AMR^2 device counts
              (both > 0), backpressured devices, AMDP's DP calls and
              seconds; launches per kernel and peak memory over the run,
              one CCKP launch per AMDP call (its two models in it).  The
              engine's solves are strict: an unsolved lane raises.  Then
              each recorded DP call (the plan over every AMDP lane, the
              replans over the bumped lanes) again from the start grid:
              the kernel bitwise against its plain version, and its time.
     rollout_dual  `rollout` of the same fleet and trace under
              ``policy="dual"`` (8 periods, counters at 0 before, no port
              kernel on the path: the bisection is PyTorch work): no
              unsolved lane, the warm basis -1, integer metrics exact and
              float metrics to 1e-9 against the same rollout on the CPU,
              the period-0 plan of every 64th lane equal to the NumPy
              `dual_schedule`; devices/s, launches per period and the
              device's busy share (profiled), and total accuracy beside
              the amr2 rollout's on the same arrivals.
     rollout_poisson  amr2 (revised LP) with ``arrivals="poisson"`` on
              the same fleet, 8 periods: reduced_pivot launched, jobs
              conserved (released + backlog = drawn), the mean count per
              device-period within 5 standard errors of the rate and the
              class frequencies within 5 of the class probabilities, from
              the card's generator; then a rate-0 run (no jobs, no
              backlog).
     serve_delegated  `FleetEngine.from_config` on the rollouts' fleet
              (`FleetConfig`, one shape group) under amr2 and dual, the
              delegation to the tensor engine's period core active: 8
              periods each, counters at 0 before (pivot kernels launched
              under amr2, none under dual), `run` equal bit for bit to
              `rollout` of `EngineParams.from_config` on the card; s/period
              and devices/s beside the host serve phase's.
     rollout_chaos  the chaos scenario on the rollouts' fleet, counters at
              0 before each counted run and read after: armed with the
              null model (revised), bit for bit the plain rollout; the
              reference bench's armed_hot model (link 0.2 x 0.6,
              stragglers 0.15 x 1.8, loss 0.05, fault seed 11, 2 retries)
              drawn on the card, both LP methods, and its harsh model
              (revised), each timed in turns with the plain rollout of
              its method (plain, chaos, chaos, plain): every period
              n_offload_samples = ok + fallback + dropped, every device's
              realized ES time within 2T + backoff_cap + its admitted
              demand x link factor (recorded through a stand-in for the
              engine's `realize_execution`), the ES audit fired, armed_hot
              keeping >= 0.90 of the fault-free accuracy; devices/s,
              launches per period, peak memory, busy share (profiled);
              then a trace drawn on the card replayed on the card and on
              the CPU at audit threshold 1.4 on a 4096-device fleet of the
              same recipe (integers exact, floats to 1e-9).
     rollout_mobility  the mobility scenario (revised LP): one cell of
              infinite radius, bit for bit the plain rollout; the bench's
              16 cells on a 4 x 4 grid of pitch 20 (radius 30, link_alpha
              0.2, 64 servers a cell, homes from `default_rng(0)`,
              positions home + normal(6)) under nearest and min_time
              routing, timed in turns with the plain rollout: handovers,
              each period's admitted set (recorded through a stand-in for
              the engine's `admit_mask_segmented`) equal to the
              sequential `admit_mask_cells_np`, two card runs bitwise, the
              4096-device fleet's rollout on the card against the CPU at
              1.4; pivots per period beside the plain rollout's; the walk's
              steps by distribution on the card's generator.
     rollout_hi  online hierarchical inference on the rollouts' recipe
              with a 64-period horizon (16384 devices): each rule (fixed
              at 0.5, threshold, ucb, exp3; 9 arms, seed 3) for 64
              periods, no port kernel launched, n_hi_offloaded +
              n_hi_local_final = n_jobs every period, the bandits' arm
              counts equal to each device's periods with jobs; wall, wall
              per period beside the plain revised rollout's, launches per
              period and busy share (profiled), final regret; the
              clairvoyant fixed rule (theta0 = clip(acc_es - beta, 0, 1))
              at regret exactly 0; the threshold learner below the fixed
              rule's regret, its second-half increment below its first,
              mean |theta - theta*| < 0.1; EXP3 replayed from
              `presample_stream` and the drawn arm uniforms bit for bit the
              drawn rollout; each rule at 4096 devices on the card against
              the CPU under one trace drawn on the card (audit at 1.4); a
              disarmed `with_hi(None)` rollout bit for bit the plain one.
     rollout_sharded  the sharded engine: (a) an NCCL world of one rank
              on this card, `fleet_mesh` -> `shard` -> `rollout_sharded` of
              the rollouts' fleet (16384 devices, 8 periods) per LP method,
              timed in turns with the unsharded rollout, bit for bit equal
              to it, with the collectives and bytes gathered and reduced a
              period and the pivot launches a period (counters at 0 before,
              read after); (b) `python -m
              repro_torch.scripts.smoke_shard_rollout` with 4 gloo ranks of
              4096 devices each, all on this card (legs tableau, revised
              and chaos), each rank held to the unsharded card rollout (a
              tableau warm basis that differs passes only as a certified
              tie: `smoke_shard_rollout.tied_basis_failures`); its wall
              printed as a correctness run's.
     rollout_grad  the differentiable rollout on the rollouts' fleet, 4
              periods, per LP method: the straight-through value against
              the hard rollout's summed accuracy (relative 1e-9); at a
              jittered p_es (`tests/test_grad.py`'s recipe) the soft
              relaxation's value-and-grad, timed in turns with the relaxed
              forward, its peak memory and the forward's pivot launches;
              central differences (eps 1e-5; where the one-sided slopes
              disagree, a kink inside +-eps, again at eps / 100) against
              two p_es coordinates, T and one acc (rtol 1e-4, atol 1e-6);
              the backward alone profiled, `kkt_vjp_ref`'s device time in
              it; value and gradients on the card against the CPU at 1024
              devices (rtol 1e-9).
  7. lm_forward  gemma3-1b at full width (26 layers, d 1152, GQA 4:1 at
              head_dim 256, vocabulary 262144): `init_params` on the card
              from a seed, 2 requests of 2048 `TokenPipeline` tokens,
              `forward` + `logits_from_h` in bfloat16 with the flash
              launch counter set to 0 just before and read just after (26
              per forward), tokens/s and peak memory; then the same
              forward with the plain dense attention (`attn_impl="dense"`)
              on the card, in bfloat16 and in float32, against the flash
              forward (tolerances at `LM_BF16_*` and `LM_F32_ATOL`).
     lm_forward (mamba2)  mamba2-130m at full width and depth (24 SSD
              layers, d 768, d_inner 1536, vocabulary 50280) from a seed, 8
              requests of 2048 `TokenPipeline` tokens, bfloat16: 24 SSD
              kernel launches per forward, tokens/s, peak memory and a
              profile; logits against the plain chunked path
              (`impl="jnp"`) in bfloat16 and float32 (`SSM_F32_ATOL`,
              `GEN_BF16_*`).
  8. lm_serve `repro_torch.launch.serve.main` on the paper_edge ladder: 6
              periods of 24 jobs, an ES outage in period 2, every counter
              set to 0 before and read after; per period the policy,
              accuracy, predicted and wall makespan, violation and the
              replanned flag; no dropped job, period 2 replanned, the flash
              kernel launched.
     lm_generate  for gemma3-1b and mamba2-130m at full width and depth:
              `init_cache`, `prefill` of 4 prompts of 1000 `TokenPipeline`
              tokens (max_seq 1032; gemma3's 512-slot local rings have
              wrapped, 1000 is no multiple of mamba2's chunk), then 32
              teacher-forced `decode_step` calls, in bfloat16 and float32
              (float32 KV cache): prefill and decode tokens/s, peak
              memory, launch counts (gemma3-1b: 26 flash per prefill, 26
              flash-decode per step; mamba2-130m: 24 SSD per prefill, none
              per step) and every logit against `forward` of all 1032
              tokens (`GEN_*`); a profile of one gemma3-1b decode step.
     recurrentgemma  recurrentgemma-9b at full width and depth (38 layers:
              26 RG-LRU, 12 local attention of window 2048; d 4096, 16 q
              heads on 1 KV head, vocabulary 256000; 38.5 GB of float32
              parameters from a seed).  lm_forward: 2 requests of 4096
              tokens in bfloat16, exactly 26 RG-LRU and 12 flash launches
              a forward, tokens/s, peak memory and a profile; hidden states
              and every logit (in slices of 1024 positions) against the
              plain path (`impl="jnp"`, `attn_impl="dense"`) in bfloat16
              and float32 (`LM_*`).  lm_generate as above with 4 prompts of
              2100 tokens (max_seq 2132; the 2048-slot rings wrap in
              prefill and decode): 26 RG-LRU and 12 flash launches per
              prefill, 12 flash-decode (group 16) and no RG-LRU launch per
              step; a profile of one decode step.
     lm_families  the other LM families at full width, float32
              parameters from a seed, bfloat16 compute (`FAMILIES`):
              granite-moe-1b-a400m and -3b-a800m (2 x 2048 tokens),
              h2o-danube-1.8b (1 x 8192, past its window of 4096),
              internlm2-20b and deepseek-coder-33b (2 x 2048; 8 of 48 and
              8 of 62 layers), whisper-base (8 x 448 decoder tokens, 1500
              frames) and internvl2-76b (2 x 2048 with 256 patch
              embeddings; 4 of 80 layers).  A depth cut is printed with
              its reason (the float32 parameters of every layer do not fit
              one 80 GB card).  Each: parameters, depth, tokens/s, peak
              memory, flash launches per forward counted from 0 (whisper:
              6 encoder + 6 self + 6 cross), the logits against
              `attn_impl="dense"` (`LM_BF16_*`).  Generation, 32 decode
              steps: granite-moe-1b from 4 x 1000 (capacity_factor 8: no
              drop in prefill or forward), h2o from 1 x 4200 (its rings
              wrap), whisper from 4 x 64 (cross K/V recomputed each step:
              6 flash-decode + 6 flash a step), internvl2 from 4 x 1000
              with its float8 cache and again with a bfloat16 one; launch
              counts, bfloat16-cache logits against `forward`, float8
              against bfloat16 (`FP8_KV_ATOL`).  The kernels phase adds
              the families' flash shapes (groups 3, 6, 7; D 80 padded
              under a window; whisper's unmasked Sq 448 and Sq 1 against
              1500 keys) and flash-decode shapes (internvl2's float8 cache
              at group 8, groups 6 and 7 in bfloat16), and holds the
              float8 KV cast on the card to the CPU's over every bfloat16
              bit pattern (`phase_fp8_cast`).
     lm_train  training (`repro_torch.launch.steps`): (a) one
              `make_train_step` (AdamW, lr 3e-3) at each of the 11 SMOKE
              configs in float32 compute on the card against the same step
              on the CPU: the loss, the gradients' global norm, every
              updated parameter and both moments (`TRAIN_*` bounds), no
              port kernel launched; (b) gemma3-1b (2 x 2048 tokens) and
              mamba2-130m (8 x 2048) at full width and depth, random
              weights from a seed, bfloat16 compute: 5 AdamW steps on one
              fixed batch (the loss must fall), step times, tokens/s,
              peak memory with ``remat="none"`` and ``"full"``, a
              profiled step (kernel launches, busy share), port kernel
              launches per train step (0) and per eval step (26 flash;
              24 SSD), and the eval loss on the kernels against the plain
              paths (`TRAIN_EVAL_BF16_ATOL`); recurrentgemma-9b is left
              out (its float32 parameters, gradients and two moments,
              16 bytes each, exceed the card's 80 GB: printed); (c) a
              checkpoint of a card state restored onto the CPU bit for
              bit, and `launch.train.main` on the card preempted by its
              sentinel and resumed against an uninterrupted run (bit for
              bit, or the leaf that differs and by how much, then again
              under `torch.use_deterministic_algorithms`).
     lm_sharded  the train step on DTensor (ROADMAP §1 item 13) on an
              NCCL world of one rank on the card, a (1, 1) ("data",
              "model") mesh and the base rules: gemma3-1b at `lm_train`'s
              width, depth and tokens (2 x 2048, bfloat16 compute, AdamW,
              ``remat="full"``), 3 steps unsharded and 3 sharded from the
              same weights (`scripts.smoke_sharded_train.run_steps`): the
              losses, gradient norms and final parameters bit for bit;
              then single steps timed in turns (unsharded, sharded,
              sharded, unsharded; medians), each kind profiled once
              (kernel launches a step) and the sharded step's collectives
              counted (`launch.op_cost`).  Then generation on DTensor
              parameters (`sharded_generation`): gemma3-1b, mamba2-130m
              and recurrentgemma-9b cut to one cycle (rglru, rglru,
              local), each prefill of `SHARDED_GEN_B` prompts of
              `SHARDED_GEN_P` tokens and `SHARDED_GEN_STEPS` decode steps,
              unsharded and sharded: every kernel of the path (flash,
              flash-decode, SSD, RG-LRU) launched on the sharded run as
              often as on the unsharded one (one a layer of its mixer a
              prefill, one flash-decode an attention layer a step), and
              the logits bit for bit.
     pipeline  `distributed.pipeline.pipeline_apply` of ``tanh(h @ W)``
              on the same world of one stage (`PIPE_*` shapes, 4
              microbatches) against the sequential loop; a multi-stage run
              needs a machine with several cards.
     dryrun   `launch.dryrun` of every (arch, shape) cell on the 16 x 16
              fake mesh (host only: a ``fake`` group of 256 ranks, meta
              shards), `DRYRUN_WORKERS` processes at once: one line per
              cell (status, per-chip argument and peak bytes, flops,
              collective bytes, dominant term, seconds), every supported
              cell ok, the 4 long_500k cells of full-attention archs
              skipped as in the reference; the records go to
              ``build/dryrun.jsonl``.
  9. parity   the card-marked tests (`pytest -m gpu tests/test_torch_cuda.py`,
              in a child process): each kernel against its plain version,
              a 32-device rollout, a 64-device `FleetEngine` run, the
              chaos, mobility and HI rollouts, segmented and one-pool
              admission, the gradient rollout and `kkt_vjp_ref`, a
              2-layer LM forward, recurrentgemma's 2-cycle SMOKE forward
              and the SMOKE models' generation on the card against the
              same runs on the CPU.
 10. timing   the 16384-device rollout again, in turns (tableau, revised,
              revised, tableau), for steady-state devices/s.
 11. profile  one rollout per LP method and one serve run under
              `torch.profiler`: device time by kernel name and the device's
              busy share of the wall time; one more serve run under
              cProfile: host seconds by pipeline stage.  (Phase 7 profiles
              one gemma3-1b forward the same way.)

Then the nvidia-smi line, the kernels line and, last, the result line.
Exits non-zero without a CUDA card, and when the repository's `src/` is
not beside this file.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (NVIDIA): HBM3 bandwidth, FP64 (non-tensor) peak, and
# the dense BF16 tensor rate used as the ES tier's FLOP/s in the fleet's
# roofline profiles
HBM_BYTES_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
L2_BYTES = 50 * 2 ** 20
TF32_FLOPS = 495e12
ES_PEAK_FLOPS = 989e12
D_FLEET, PERIODS, R, N_JOBS = 16384, 8, 14, 12
C0 = N_JOBS * 3 + 2
RTOL = ATOL = 1e-12
# AMDP's largest grid on the serve path: T = 1.2 s at 1 ms steps (T1 =
# 1200 + 1) and 12 local jobs (K1 = 12 + 1: a device in outage or in the
# ES-disabled replan offloads none)
T_BUDGET, DP_T1, DP_K1 = 1.2, 1201, 13
# a grid too large for a block's shared memory (the reference docstring's
# 4001 x 301), on a few lanes: the CCKP kernel's global-memory instance
DP_GLOBAL = (4, 4001, 301)
CCKP_SRC = "src/repro_torch/kernels/cckp_dp/csrc/cckp_dp.cu"
SIMPLEX_SRC = "src/repro_torch/kernels/simplex_pivot/csrc/simplex_pivot.cu"
SIMPLEX_TPU = "src/repro/kernels/simplex_pivot/simplex_pivot.py"
# the rollout's own pivot calls: every PIVOT_SAMPLE-th call of a method's
# rollout (and the last of each simplex phase) is replayed and timed
PIVOT_SAMPLE = 16
# device cycles of a sleep that the timed launches queue up behind, so that
# CUDA events time the device and not the host's launch rate (~5 ms)
AHEAD_CYCLES = 10_000_000
# reduced_pivot beside the fleet's shape: the LP of RequestQueue's default
# batch of 16 jobs (a compiled instance) and of 20 jobs (the generic one)
REDUCED_SHAPES = ((18, 50), (22, 62))
# at most this share of a rollout call's lanes may be decided otherwise by
# reduced_pivot's plain version (each within a rounding, `explain_flips`)
MAX_FLIP_SHARE = 1 / 16
# float64's unit roundoff
U64 = 2.0 ** -53
N_SERVERS = D_FLEET // 16
BF16_FLOPS = ES_PEAK_FLOPS
# flash attention at the LM path's shapes:
# (name, batch, Sq, Sk, heads, kv heads, head_dim, mask, window)
FLASH_SHAPES = (
    ("paper_edge_es", 32, 64, 64, 8, 4, 64, "causal", 0),
    ("gemma3_local", 2, 2048, 2048, 4, 1, 256, "window", 512),
    ("gemma3_global", 2, 2048, 2048, 4, 1, 256, "causal", 0),
    ("ragged_none", 3, 1000, 777, 4, 2, 128, "none", 0),
    ("recurrentgemma_local", 2, 4096, 4096, 16, 1, 256, "window", 2048),
)
FLASH_LINE = ("gemma3_local", "bfloat16")    # the kernels line's shape
FLASH_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu")
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:86"
# the gemma3-1b forward: 2 requests of 2048 tokens
LM_BATCH, LM_SEQ, LM_SEED = 2, 2048, 0
# the mamba2-130m forward: 8 requests of 2048 tokens; its SSD scan shape
# (B·H = 8 · 24 rows of S = 2048, P = 64, N = 128, chunk Q = 256)
SSM_BATCH, SSM_SEQ = 8, 2048
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/ssd_scan.py:73"
# generation: 4 prompts of 1000 tokens, then 32 teacher-forced decode
# steps, caches of max_seq = 1032 slots (gemma3-1b's local rings: 512)
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 1000, 32
GEN_MAX_SEQ = GEN_PROMPT + GEN_STEPS
DECODE_SRC = ("src/repro_torch/kernels/decode_attention/csrc/"
              "decode_attention.cu")
DECODE_TPU = ("src/repro/kernels/decode_attention/decode_attention.py:60")
DECODE_LINE = ("gemma3_local", "bfloat16")  # the kernels line's shape
# recurrentgemma-9b: a forward of 2 requests of 4096 tokens (past the local
# window of 2048, so the window masks) and generation from 4 prompts of
# 2100 tokens (the 2048-slot local rings wrap at prefill), 32 steps
RG_ARCH = "recurrentgemma_9b"
RG_BATCH, RG_SEQ, RG_PROMPT = 2, 4096, 2100
RGLRU_SRC = "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"
RGLRU_TPU = "src/repro/kernels/rglru_scan/rglru_scan.py:43"
# the RG-LRU recurrence at the path's shapes: (name, B, S, W, slow decay);
# the forward's and the prefill's (of 4 prompts and of 1) a and b as the
# model's gates make them, and a ragged shape with a in (0.9, 1), at an odd width (4-byte copies)
# and at the next multiple of 4 (16-byte copies)
RGLRU_SHAPES = (
    ("recurrentgemma_forward", RG_BATCH, RG_SEQ, 4096, False),
    ("recurrentgemma_prefill", GEN_BATCH, RG_PROMPT, 4096, False),
    ("recurrentgemma_prefill_1", 1, RG_PROMPT, 4096, False),
    ("ragged_slow", 1, 2085, 999, True),
    ("ragged_slow_w1000", 1, 2085, 1000, True),
)
RGLRU_LINE = "recurrentgemma_forward"       # the kernels line's shape
# flash-decode through the model's entry at the generation runs' shapes:
# (name, ring slots, window, q heads per KV head, decoded position)
DECODE_SHAPES = (
    ("gemma3_local", 512, 512, 4, GEN_PROMPT + GEN_STEPS // 2),
    ("gemma3_global", GEN_MAX_SEQ, 0, 4, GEN_PROMPT + GEN_STEPS // 2),
    ("recurrentgemma_local", 2048, 2048, 16, RG_PROMPT + GEN_STEPS // 2),
)


# the LM families' new flash shapes, run in bfloat16 (their compute type):
# granite-moe-3b's group 3, internlm2's 6 and deepseek-coder's 7 (2 x 2048,
# causal), h2o-danube's head_dim 80 (padded to 128) under its window of
# 4096 (1 x 8192), whisper's unmasked cross-attention of 8 x 448 decoder
# tokens and of one decode token (4 sequences) against 1500 frames
FAMILY_FLASH_SHAPES = (
    ("granite_moe_3b_group3", 2, 2048, 2048, 24, 8, 64, "causal", 0),
    ("internlm2_group6", 2, 2048, 2048, 48, 8, 128, "causal", 0),
    ("deepseek_coder_group7", 2, 2048, 2048, 56, 8, 128, "causal", 0),
    ("h2o_danube_d80_window", 1, 8192, 8192, 32, 8, 80, "window", 4096),
    ("whisper_cross_prefill", 8, 448, 1500, 8, 8, 64, "none", 0),
    ("whisper_cross_decode", 4, 1, 1500, 8, 8, 64, "none", 0),
)
# flash-decode at the families' decode shapes, 4 sequences: (name, ring
# slots, window, KV heads, q heads per KV head, head_dim, decoded
# position, q type, cache type): internvl2's float8_e4m3fn cache (group
# 8), internlm2's and deepseek-coder's groups 6 and 7, in bfloat16
FAMILY_DECODE_SHAPES = (
    ("internvl2_fp8", GEN_MAX_SEQ, 0, 8, 8, 128, GEN_PROMPT + GEN_STEPS // 2,
     "bfloat16", "float8_e4m3fn"),
    ("internlm2_group6", GEN_MAX_SEQ, 0, 8, 6, 128,
     GEN_PROMPT + GEN_STEPS // 2, "bfloat16", "bfloat16"),
    ("deepseek_coder_group7", GEN_MAX_SEQ, 0, 8, 7, 128,
     GEN_PROMPT + GEN_STEPS // 2, "bfloat16", "bfloat16"),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def ptxas_instances(log):
    """ptxas's report of each kernel instance in an ``nvcc -Xptxas -v``
    log: name (demangled where c++filt is found), registers, static shared
    memory, stack frame and spill bytes."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(kernel=m.group(1), registers=None, smem=0,
                       stack=0, spill_stores=0, spill_loads=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["smem"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            i["kernel"] for i in out), capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        if len(names) == len(out):
            for i, name in zip(out, names):
                name = name.replace("(anonymous namespace)::", "")
                i["kernel"] = re.sub(r"^void ", "", name.split("(")[0])
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def bound_of(nbytes, flops, peak=FP64_FLOPS):
    """(bound_ms, bound_by): the larger of the memory time and the
    operations' time at ``peak`` FLOP/s of one call."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def cuda_ms(fn, inputs, torch, warm_up=False, ahead=False) -> float:
    """Mean milliseconds of ``fn(*args)`` over ``inputs`` (one argument
    tuple per call, so in-place kernels never see their own output), after
    one untimed call with the first tuple where ``warm_up`` is set; with
    ``ahead`` the calls queue up behind a device sleep first, so that a
    kernel shorter than its host launch is timed on the device.  Python's
    garbage collector is off while the calls are queued: a collection
    there outlasts the sleep and drains the queue."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if warm_up:
        fn(*inputs[0])
    torch.cuda.synchronize()
    collecting = gc.isenabled()
    gc.disable()
    try:
        if ahead:
            torch.cuda._sleep(AHEAD_CYCLES)
        start.record()
        for args in inputs:
            fn(*args)
        stop.record()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(inputs)


# --------------------------------------------------------------------------
# phase 3 inputs
# --------------------------------------------------------------------------
def tableau_case(torch, dev, g):
    """Random (D, R+1, C0+1) tableaus, 80% of lanes active; masked lanes
    carry out-of-range pivot coordinates."""
    D = D_FLEET
    tabs = torch.randn((D, R + 1, C0 + 1), generator=g, dtype=torch.float64)
    r = torch.randint(0, R, (D,), generator=g, dtype=torch.int32)
    j = torch.randint(0, C0, (D,), generator=g, dtype=torch.int32)
    mask = torch.rand((D,), generator=g) < 0.8
    lanes = torch.arange(D)
    piv = tabs[lanes, r.long(), j.long()]
    tabs[lanes, r.long(), j.long()] = piv + torch.sign(piv) * 0.5
    r[~mask] = 99
    return [t.to(dev) for t in (tabs, r, j, mask)]


def reduced_case(torch, dev, g, R=R, C0=C0):
    """Random revised-simplex lanes of (R, C0) slabs: a quarter degenerate
    (zero basic levels), a third on Bland's rule, some masked or not
    allowed to pivot."""
    D = D_FLEET
    A = torch.randn((D, R, C0), generator=g, dtype=torch.float64)
    c = torch.randn((D, C0), generator=g, dtype=torch.float64)
    Binv = torch.eye(R, dtype=torch.float64) + 0.3 * torch.randn(
        (D, R, R), generator=g, dtype=torch.float64)
    xB = 2.0 * torch.rand((D, R), generator=g, dtype=torch.float64)
    lanes = torch.arange(D)
    xB[(lanes % 4 == 1)[:, None] & (torch.arange(R) % 2 == 0)[None, :]] = 0.0
    basis = torch.argsort(torch.rand((D, C0 + R), generator=g),
                          dim=1)[:, :R].to(torch.int32).contiguous()
    use_bland = lanes % 3 == 0
    may_pivot = torch.rand((D,), generator=g) < 0.8
    lane_ok = torch.rand((D,), generator=g) < 0.9
    return [t.to(dev) for t in (A, c, Binv, xB, basis, use_bland, may_pivot,
                                lane_ok)]


def phase_kernels(torch, ops, ref, dev):
    g = torch.Generator().manual_seed(7)
    reps = 10
    rows = {}

    # ---- simplex_pivot ---------------------------------------------------
    tabs, r, j, mask = tableau_case(torch, dev, g)
    want = ref.pivot_update_ref(tabs, r, j, mask)
    got = tabs.clone()
    ops.pivot_update(got, r, j, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
          f"simplex_pivot disagrees with its plain version (max {err})")
    ms, ms_unqueued = both_ms(
        torch, ops.pivot_update,
        lambda: [(tabs.clone(), r, j, mask) for _ in range(reps)])
    plain_ms = cuda_ms(ref.pivot_update_ref, [(tabs, r, j, mask)] * 3, torch)
    nbytes, flops = simplex_pivot_work(mask, R + 1, C0 + 1)
    rows["simplex_pivot"] = dict(max_abs_err=err, ms=ms,
                                 ms_unqueued=ms_unqueued, plain_ms=plain_ms,
                                 bytes=nbytes, flops=flops)

    # ---- reduced_pivot ---------------------------------------------------
    rows["reduced_pivot"] = reduced_row(torch, ops, ref, dev, g, R, C0, reps)
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound_of(row["bytes"],
                                                         row["flops"])
        emit("kernels", kernel=name, **row)
    for shape in REDUCED_SHAPES:
        row = reduced_row(torch, ops, ref, dev, g, *shape, reps)
        row["bound_ms"], row["bound_by"] = bound_of(row["bytes"],
                                                     row["flops"])
        emit("kernels", kernel="reduced_pivot", case=dict(R=shape[0],
             C0=shape[1], instance_jobs=ops.reduced_instance(*shape)),
             **row)
    rows["cckp_model_dp"] = phase_cckp_kernel(torch, dev)
    return rows


def both_ms(torch, fn, copies):
    """(ms, ms_unqueued) of ``fn`` over fresh ``copies()``: timed with the
    launches queued behind a device sleep (the device's time), then
    without it (the larger of the device's time and the host's launch
    rate)."""
    return (cuda_ms(fn, copies(), torch, ahead=True),
            cuda_ms(fn, copies(), torch))


def reduced_row(torch, ops, ref, dev, g, R, C0, reps):
    """`reduced_pivot` on `reduced_case` lanes of (R, C0) slabs against its
    plain version (flags and basis exact, factor to 1e-12), timed both
    ways (`both_ms`) beside the plain version, with its work counts."""
    case = reduced_case(torch, dev, g, R, C0)
    want = ref.reduced_pivot_ref(*case, art_cost=1.0, tol=1e-7)
    got = [t.clone() for t in case]
    flags = ops.reduced_pivot(*got, art_cost=1.0, tol=1e-7)
    torch.cuda.synchronize()
    err = max((got[2] - want[0]).abs().max().item(),
              (got[3] - want[1]).abs().max().item())
    check(torch.allclose(got[2], want[0], rtol=RTOL, atol=ATOL)
          and torch.allclose(got[3], want[1], rtol=RTOL, atol=ATOL),
          f"reduced_pivot factor disagrees with its plain version ({err})")
    check(torch.equal(got[4], want[2]), "reduced_pivot basis disagrees")
    for name, a, b in zip(("has_enter", "unbounded", "degenerate"), flags,
                          want[3:]):
        check(torch.equal(a, b), f"reduced_pivot flag {name} disagrees")
    has_enter, unbounded, degen = want[3:]
    check(bool(degen[has_enter].any()) and bool((~has_enter).any())
          and bool(case[5][has_enter].any()),
          "reduced_pivot inputs miss degenerate, Bland or no-entry lanes")
    ms, ms_unqueued = both_ms(
        torch, lambda *a: ops.reduced_pivot(*a, art_cost=1.0, tol=1e-7),
        lambda: [tuple(t.clone() if k in (2, 3, 4) else t
                       for k, t in enumerate(case)) for _ in range(reps)])
    plain_ms = cuda_ms(
        lambda *a: ref.reduced_pivot_ref(*a, art_cost=1.0, tol=1e-7),
        [tuple(case)] * 3, torch)
    nbytes, flops = reduced_pivot_work(torch, ref, case, want, 1.0, 1e-7)
    return dict(max_abs_err=err, ms=ms, ms_unqueued=ms_unqueued,
                plain_ms=plain_ms, bytes=nbytes, flops=flops)


def cckp_case(torch, dev):
    """AMDP's DP as the serve path meets it: per-lane p (D, 2) and
    accuracies (D, 2) of the fleet's class-512 profiles (p = ceil(p_ed / 1
    ms)), and the DP's start grid (0 in column 0, NEG elsewhere)."""
    import numpy as np

    from repro_torch.core.amdp import _integerize
    from repro_torch.serving.fleet import make_fleet
    specs = make_fleet(D_FLEET, classes=(512,), seed=11, horizon=1,
                       es_peak_flops=ES_PEAK_FLOPS, es_hbm_bw=HBM_BYTES_S)
    p_ed = np.stack([d.profile.p_ed[0] for d in specs])         # (D, 2)
    p_int, _ = _integerize(p_ed, np.full(D_FLEET, T_BUDGET), 1e-3)
    acc = np.stack([d.profile.acc[:2] for d in specs])
    p = torch.as_tensor(p_int.astype(np.int32), device=dev)
    a = torch.as_tensor(acc.astype(np.float32), device=dev)
    return start_grid(torch, dev, D_FLEET, DP_T1, DP_K1), p, a


def start_grid(torch, dev, B, T1, K1):
    """The DP's start grid, as `cckp_counts` builds it."""
    from repro_torch.kernels.cckp_dp.ref import NEG
    y = torch.full((B, T1, K1), NEG, dtype=torch.float32, device=dev)
    y[:, :, 0] = 0.0
    return y


def cckp_work(torch, p, T1, K1, n_steps):
    """Bytes and float32 operations of the CCKP kernel over the models of
    ``p`` (B, m) in one call: it reads each grid cell once and writes the
    final value and one count per model (4 + 4 + 4 m bytes a cell); cell
    (t, k) of lane b evaluates the q whose source cell lies inside the
    grid, min(k + 1, c) of them with c = min(t // p_b + 1, n_steps), one
    multiply, one add and one compare each.  Summed over k < K1 that is
    c (c + 1) / 2 + c (K1 - c) per (b, t)."""
    B, m = p.shape
    t = torch.arange(T1, device=p.device, dtype=torch.int64)
    n_q = 0
    for i in range(m):
        p64 = p[:, i].to(torch.int64)[:, None]
        c = torch.where(p64 > 0, t[None, :] // p64.clamp_min(1) + 1,
                        torch.full_like(p64, n_steps)).clamp_max(
                            min(n_steps, K1))                  # (B, T1)
        n_q += int((c * (c + 1) // 2 + c * (K1 - c)).sum())
    return (8 + 4 * m) * B * T1 * K1, 3 * n_q


def cckp_row(torch, dev, name, y, p, a, n_steps, reps, plain_reps):
    """`models_dp` on (y, p (B, m), a (B, m)) against its plain version on
    the card (values and every table bitwise), with its times and bound;
    emitted as a kernels line and returned."""
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.cckp_dp import ref as cckp_ref
    B, T1, K1 = y.shape
    got_y, got_q = cckp_ops.models_dp(y, p, a, n_steps)
    want_y, want_q = cckp_ref.cckp_models_dp_ref(y, p, a, n_steps)
    torch.cuda.synchronize()
    err = (got_y - want_y).abs().max().item()
    check(torch.equal(got_y, want_y) and torch.equal(got_q, want_q),
          f"cckp {name}: the kernel disagrees with its plain version "
          f"(max {err})")
    check(bool((got_q > 0).any()) and bool((got_y > cckp_ref.NEG).any()),
          f"cckp {name}: the inputs give no non-trivial cell")
    del got_y, got_q, want_y, want_q
    ms = cuda_ms(lambda: cckp_ops.models_dp(y, p, a, n_steps), [()] * reps,
                 torch, warm_up=True)
    plain_ms = cuda_ms(lambda: cckp_ref.cckp_models_dp_ref(y, p, a, n_steps),
                       [()] * plain_reps, torch)
    nbytes, flops = cckp_work(torch, p, T1, K1, n_steps)
    bound_ms, bound_by = bound_of(nbytes, flops, FP32_FLOPS)
    shared = cckp_ops.uses_shared(T1, K1, n_steps, dev)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               bytes=nbytes, flops=flops, bound_ms=bound_ms,
               bound_by=bound_by, shape=[B, T1, K1], models=p.shape[1],
               instance="shared" if shared else "global",
               ctas_per_sm=cckp_ops.occupancy(T1, K1, n_steps, shared))
    emit("kernels", kernel="cckp_model_dp", case=name, **row)
    return row


def phase_cckp_kernel(torch, dev):
    """The CCKP kernel at the serve path's largest grids (16384 lanes of
    1201 x 13): `models_dp` with both models of an AMDP call in one launch
    from the start grid, and `model_dp` (one model, m = 1) on the first
    model's output; then a grid that takes the global-memory instance.
    Returns the m = 2 row (the kernels line's)."""
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    y0, p, a = cckp_case(torch, dev)
    both = cckp_row(torch, dev, "models_dp m=2, serve shape", y0, p, a,
                    DP_K1, 5, 2)
    check(both["instance"] == "shared",
          "cckp: the serve shape did not take the shared instance")
    y1, _ = cckp_ops.models_dp(y0, p[:, :1].contiguous(),
                               a[:, :1].contiguous(), DP_K1)
    del y0
    cckp_row(torch, dev, "m=1 (model_dp), second model", y1,
             p[:, 1:].contiguous(), a[:, 1:].contiguous(), DP_K1, 5, 2)
    del y1
    B, T1, K1 = DP_GLOBAL
    g = torch.Generator(device=dev).manual_seed(19)
    y = torch.randn((B, T1, K1), generator=g, device=dev)
    pg = torch.tensor([[3, 7], [0, 40], [1, T1 + 99], [13, 2]],
                      dtype=torch.int32, device=dev)[:B].contiguous()
    ag = 0.3 + 0.69 * torch.rand((B, 2), generator=g, device=dev)
    row = cckp_row(torch, dev, "models_dp m=2, global instance", y, pg, ag,
                   K1, 2, 1)
    check(row["instance"] == "global",
          f"cckp: a {T1} x {K1} grid did not take the global instance")
    return both


def record_dp_calls(cckp_ops, calls):
    """A stand-in for the kernel module as AMDP sees it
    (`repro_torch.core.amdp.cckp_ops`): its `models_dp` records each
    call's lanes, grid, models and inputs (p, a, n_steps; AMDP always
    starts from the start grid) in ``calls`` and runs the real wrapper,
    which counts its launch as always."""
    import types

    def recording(y, p, a, n_steps):
        calls.append(dict(shape=list(y.shape), models=p.shape[1],
                          p=p.clone(), a=a.clone(), n_steps=n_steps))
        return cckp_ops.models_dp(y, p, a, n_steps)
    return types.SimpleNamespace(models_dp=recording)


def phase_cckp_serve_calls(torch, dev, calls):
    """Serve's own AMDP calls again (the plan over every AMDP lane, the
    replans over the bumped lanes), each from the start grid: the kernel
    against its plain version (bitwise) and its time."""
    rows = []
    for n, call in enumerate(calls):
        B, T1, K1 = call["shape"]
        y = start_grid(torch, dev, B, T1, K1)
        row = cckp_row(torch, dev, f"serve call {n}", y, call["p"],
                       call["a"], call["n_steps"], 3, 1)
        rows.append(dict(call=n, shape=call["shape"], ms=row["ms"],
                         bound_ms=row["bound_ms"], plain_ms=row["plain_ms"]))
        del y
    emit("cckp_serve_calls", calls=rows,
         kernel_ms_total=sum(r["ms"] for r in rows))
    return rows


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
def live_pairs(Sq, Sk, mask, window):
    """(query, key) pairs the index-derived mask leaves live."""
    import numpy as np
    i = np.arange(Sq)
    if mask == "none":
        return Sq * Sk
    hi = np.minimum(i, Sk - 1)
    lo = np.maximum(0, i - window + 1) if mask == "window" else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B, Sq, Sk, H, KH, D, mask, window, itemsize):
    """Bytes and operations one call needs: q, k and v read once and o
    written once; 4 D operations (q.k and p.v, a multiply and an add
    each) per live (query, key) pair of each of the B H q-heads."""
    nbytes = itemsize * D * (2 * B * H * Sq + 2 * B * KH * Sk)
    return nbytes, 4 * D * B * H * live_pairs(Sq, Sk, mask, window)


def phase_flash_kernel(torch, dev):
    """Flash attention against its plain version at every shape of
    `FLASH_SHAPES`, in bfloat16 and float32, and of `FAMILY_FLASH_SHAPES`
    in bfloat16, with kernel, plain and `scaled_dot_product_attention`
    times.  Returns the rows by (shape, dtype)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    both = (torch.bfloat16, torch.float32)
    for shape, dtypes in ([(sh, both) for sh in FLASH_SHAPES]
                          + [(sh, both[:1]) for sh in FAMILY_FLASH_SHAPES]):
        name, B, Sq, Sk, H, KH, D, mask, window = shape
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B * H, Sq, D), (B * KH, Sk, D),
                                     (B * KH, Sk, D)))
            kw = dict(mask_kind=mask, window=window, group=H // KH)
            got = fa_ops.flash_attention_fwd(q, k, v, **kw)
            want = fa_ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rtol, atol = ((0.0, 1e-5) if dtype == torch.float32
                          else (2.0 ** -7, 2.0 ** -7))
            check(torch.allclose(got.float(), want.float(), rtol=rtol,
                                 atol=atol),
                  f"flash_attention_fwd {name} {dname} disagrees with its "
                  f"plain version (max {err})")
            del got, want
            ms = cuda_ms(lambda: fa_ops.flash_attention_fwd(q, k, v, **kw),
                         [()] * 10, torch, warm_up=True)
            plain_ms = cuda_ms(lambda: fa_ref.attention_ref(q, k, v, **kw),
                               [()] * 3, torch)
            # the library's call on the same inputs: (B, H, S, D) views,
            # KV heads shared by enable_gqa, the mask as a boolean tensor
            qq, kk, vv = (t.view(B, t.shape[0] // B, t.shape[1], D)
                          for t in (q, k, v))
            live = (None if mask != "window"
                    else fa_ref.index_mask(mask, Sq, Sk, window, dev))

            def library():
                return sdpa(qq, kk, vv, attn_mask=live,
                            is_causal=mask == "causal", enable_gqa=True)

            lib_err = (library().reshape(q.shape).float()
                       - fa_ref.attention_ref(q, k, v, **kw).float()
                       ).abs().max().item()
            library_ms = cuda_ms(library, [()] * 10, torch, warm_up=True)
            nbytes, flops = flash_work(B, Sq, Sk, H, KH, D, mask, window,
                                       q.element_size())
            bound_ms, bound_by = bound_of(
                nbytes, flops,
                BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, library_max_abs_err=lib_err,
                       bytes=nbytes, flops=flops, bound_ms=bound_ms,
                       bound_by=bound_by, tflops=flops / ms * 1e-9,
                       bound_share=bound_ms / ms)
            emit("kernels", kernel="flash_attention_fwd", shape=name,
                 dtype=dname, dims=dict(B=B, Sq=Sq, Sk=Sk, H=H, KH=KH, D=D,
                                        mask=mask, window=window), **row)
            rows[(name, dname)] = row
            del q, k, v, qq, kk, vv
    return rows


# the first case of the card tests' flash cases (B*KH, G, Sq, Sk, D, mask,
# window) in float32, repeated: runs of those tests and of this phase failed
# it on some machines (4.9e-5 and 5.8e-5 against 1e-5, every repeat equal)
FLASH_REPEAT_CASE, FLASH_REPEATS = (4, 2, 100, 100, 64, "causal", 0), 20
FLASH_REPEAT_TOL = 1e-5


def host_cpu():
    """The host CPU's model name and model number (`/proc/cpuinfo`)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                key = key.strip()
                if key in ("model name", "model") and key not in info:
                    info[key] = val.strip()
    except OSError:
        pass
    return info


def phase_flash_repeat(torch, dev):
    """`FLASH_REPEAT_CASE` in float32 on the inputs the card test makes
    (a CPU generator seeded with Sq + D), the kernel called
    `FLASH_REPEATS` times.  Every repeat is held within the test's 1e-5
    to the same attention in float64 on the host, to the plain version
    on the card, and to the plain version on the host (the card test's
    reference).  The last holds unless the host's plain version is itself
    more than 1e-5 from float64: then the host's float32 arithmetic, not
    the kernel, is at fault, and the phase prints so with the host's CPU
    beside it.  The worst element of the first repeat is printed with
    every side's value."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    BKH, G, Sq, Sk, D, mask, window = FLASH_REPEAT_CASE
    tol = FLASH_REPEAT_TOL
    g = torch.Generator().manual_seed(Sq + D)
    q, k, v = (torch.randn(shape, generator=g)
               for shape in ((BKH * G, Sq, D), (BKH, Sk, D), (BKH, Sk, D)))
    kw = dict(mask_kind=mask, window=window, group=G)
    host = fa_ref.attention_ref(q, k, v, **kw)
    s = torch.einsum("bgqd,bkd->bgqk", q.double().reshape(BKH, G, Sq, D),
                     k.double()) * D ** -0.5
    s = s.masked_fill(~fa_ref.index_mask(mask, Sq, Sk, window, "cpu"),
                      float("-inf"))
    exact = torch.einsum("bgqk,bkd->bgqd", torch.softmax(s, dim=-1),
                         v.double()).reshape(BKH * G, Sq, D)
    qd, kd, vd = (t.to(dev) for t in (q, k, v))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    card = fa_ref.attention_ref(qd, kd, vd, **kw).cpu()
    torch.backends.cuda.matmul.allow_tf32 = tf32

    def dist(a, b):
        return (a.double() - b.double()).abs().max().item()

    gots = [fa_ops.flash_attention_fwd(qd, kd, vd, **kw).cpu()
            for _ in range(FLASH_REPEATS)]
    errs = [dist(got, host) for got in gots]
    errs64 = [dist(got, exact) for got in gots]
    errs_card = [dist(got, card) for got in gots]
    host64, card64 = dist(host, exact), dist(card, exact)
    host_at_fault = host64 > tol
    i = int((gots[0].double() - exact).abs().argmax())
    worst = dict(index=[int(x) for x in torch.unravel_index(
                     torch.tensor(i), gots[0].shape)],
                 kernel=gots[0].flatten()[i].item(),
                 host_plain=host.flatten()[i].item(),
                 card_plain=card.flatten()[i].item(),
                 float64=exact.flatten()[i].item())
    row = dict(max_abs_err=max(errs), kernel_vs_float64=max(errs64),
               kernel_vs_card_plain=max(errs_card), plain_vs_float64=host64,
               card_plain_vs_float64=card64,
               repeats_equal=all(torch.equal(got, gots[0]) for got in gots),
               host_plain_at_fault=host_at_fault, worst=worst,
               host_cpu=host_cpu(),
               card_uuid=(str(torch.cuda.get_device_properties(dev).uuid)
                          if dev.type == "cuda" else None),
               cpu_capability=torch.backends.cpu.get_cpu_capability(),
               cpu_threads=torch.get_num_threads())
    emit("kernels", kernel="flash_attention_fwd", case="repeat float32",
         dims=dict(BKH=BKH, G=G, Sq=Sq, Sk=Sk, D=D, mask=mask),
         repeats=FLASH_REPEATS, errors=errs, **row)
    check(max(errs64) <= tol and max(errs_card) <= tol,
          f"flash_attention_fwd float32 repeat: the kernel is off (bound "
          f"{tol}): {json.dumps(row)}")
    check(host_at_fault or max(errs) <= tol,
          f"flash_attention_fwd float32 repeat: the kernel and the host's "
          f"plain version disagree (bound {tol}): {json.dumps(row)}")


def simplex_pivot_work(mask, R1, C1):
    """Bytes and FP64 operations one `simplex_pivot` call on (B, R1, C1)
    tableaus needs: every lane reads its mask byte; an active lane also
    reads r, j and its tableau and writes the tableau back."""
    active = int(mask.sum())
    return (mask.shape[0] + active * (2 * R1 * C1 * 8 + 4 + 4),
            active * (R1 * C1 * 2 + C1))


def reduced_pivot_work(torch, ref, case, want, art_cost, tol):
    """Bytes and FP64 operations one `reduced_pivot` call needs on these
    inputs (its plain version's result ``want``), lane by lane:

    * every lane reads `lane_ok`, its factor `Binv`, `xB` and `basis`,
      and writes its three flags;
    * a lane with `lane_ok` False enters no column: its flags come from the
      ratio test on column 0 alone (R values of A, one FTRAN);
    * a lane with `lane_ok` True prices the columns that decide its
      entering index — all C0 under Dantzig or when none enters, columns
      0..j under Bland — reading them from A and c, plus c at its basic
      labels;
    * a lane that enters a column reads `use_bland`, and `may_pivot` too
      when its ratio test is bounded;
    * a lane that pivots writes `Binv`, `xB` and one basis label."""
    A, c, Binv, xB, basis, use_bland, may_pivot, lane_ok = case
    has_enter, unbounded = want[3], want[4]
    D, R, C0 = A.shape
    rc = ref.price_reduced_ref(A, c, Binv, basis, art_cost)
    enter = (rc < -tol) & lane_ok[:, None]
    j_bland = enter.to(torch.uint8).argmax(dim=1)
    cols = torch.where(use_bland & has_enter, j_bland + 1, C0)
    cols = torch.where(lane_ok, cols, 0)
    col_idx = torch.arange(C0, device=A.device)
    basic = (basis[:, :, None] == col_idx) & lane_ok[:, None, None]
    c_read = (col_idx[None, :] < cols[:, None]) | basic.any(dim=1)
    n_cols = int(cols.sum())
    n_ok = int(lane_ok.sum())
    pivoted = int((may_pivot & has_enter & ~unbounded).sum())
    nbytes = (D * (1 + R * R * 8 + R * 8 + R * 4 + 3)
              + (D - n_ok) * R * 8                      # column 0
              + n_cols * R * 8 + int(c_read.sum()) * 8  # priced columns
              + int(has_enter.sum())                    # use_bland
              + int((has_enter & ~unbounded).sum())     # may_pivot
              + pivoted * (R * R * 8 + R * 8 + 4))
    flops = (n_ok * 2 * R * R + n_cols * (2 * R + 1)    # BTRAN, pricing
             + D * (2 * R * R + R)                      # FTRAN, ratios
             + pivoted * 2 * R * (R + 1))               # eta update
    return nbytes, flops


# --------------------------------------------------------------------------
# phases 4 to 7: the engine
# --------------------------------------------------------------------------
def rollout_fleet():
    """The 16384-device fleet of the rollouts and its queue (the
    configuration `rollout_config` describes)."""
    cfg = rollout_config("amr2")
    return cfg.build_devices(), cfg.build_queue()


def rollout_config(policy):
    """The rollouts' fleet as a `FleetConfig`: `make_fleet(16384, seed=7,
    horizon=8)`, three job classes, rate 10, 12 jobs, 1024 servers."""
    from repro_torch.serving.fleet import FleetConfig
    return FleetConfig(n_devices=D_FLEET, T=T_BUDGET, n_servers=N_SERVERS,
                       policy=policy, rate=10.0, batch_max=N_JOBS,
                       horizon=PERIODS, seed=7, es_peak_flops=ES_PEAK_FLOPS,
                       es_hbm_bw=HBM_BYTES_S)


def build_params(dev, fleet):
    """The 16384-device fleet's params, one per LP method and one for the
    dual, from one fleet and one replayed arrival trace."""
    from repro_torch.api import engine as E
    devices, queue = fleet
    out = {m: E.EngineParams.from_fleet(
        devices, queue, T=T_BUDGET, n_servers=N_SERVERS, horizon=PERIODS,
        lp_method=m, device=dev) for m in ("tableau", "revised")}
    dual = E.EngineParams.from_fleet(
        devices, queue, T=T_BUDGET, n_servers=N_SERVERS, horizon=PERIODS,
        policy="dual", device=dev)
    return out, dual


def compare_metrics(E, torch, a, b, what):
    for f in E.METRIC_FIELDS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        check(tuple(x.shape) == (PERIODS,), f"{what}: {f} shape {x.shape}")
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"{what}: {f} not finite")
            d = (x - y).abs().max().item()
            check(d <= 1e-9, f"{what}: {f} differs by {d}")
        else:
            check(torch.equal(x, y), f"{what}: {f} {x.tolist()} vs "
                                     f"{y.tolist()}")


def phase_rollout(torch, ops, dev, params):
    from repro_torch.api import engine as E
    counters = {"tableau": ("simplex_pivot", ops.pivot_update),
                "revised": ("reduced_pivot", ops.reduced_pivot)}
    out, launches = {}, {}
    for method, (kname, counter) in counters.items():
        state = E.init_state(params[method], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        _final, metrics = E.rollout(state, params[method], PERIODS,
                                    device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[kname] = counter.launches
        check(counter.launches > 0, f"{kname} never launched on the "
                                    f"{method} path")
        n_unsolved = int(metrics.n_unsolved.sum())
        check(n_unsolved == 0, f"{method}: {n_unsolved} unsolved lanes")
        out[method] = metrics
        emit("rollout", lp_method=method, devices=D_FLEET, periods=PERIODS,
             seconds=seconds, devices_per_s=D_FLEET * PERIODS / seconds,
             peak_mem_bytes=torch.cuda.max_memory_allocated(),
             launches={kname: counter.launches},
             launches_per_period=counter.launches / PERIODS,
             n_jobs=int(metrics.n_jobs.sum()),
             n_backpressured=int(metrics.n_backpressured.sum()),
             mean_job_accuracy=float(metrics.mean_job_accuracy.mean()))
    compare_metrics(E, torch, out["revised"], out["tableau"],
                    "revised vs tableau")
    return launches, out


class PivotRecorder:
    """A stand-in for the pivot kernels' module as the LP sees it
    (`repro_torch.core.lp.pivot_ops`): each call runs the real wrapper,
    which counts its launch as always, with its inputs and its outputs
    cloned.  Every `PIVOT_SAMPLE`-th call of the run (call 0, 16, ...) is
    kept in ``calls``; `phase_done`, run after each simplex phase loop,
    keeps the phase's last call too, marked ``phase_end``."""

    def __init__(self, ops):
        self.ops, self.calls, self.n, self.latest = ops, [], 0, None

    def _run(self, kernel, fn, args, kwargs, outputs):
        self.latest = dict(kernel=kernel, call=self.n, phase_end=False,
                           args=[a.clone() for a in args], kwargs=kwargs)
        if self.n % PIVOT_SAMPLE == 0:
            self.calls.append(self.latest)
        self.n += 1
        out = fn(*args, **kwargs)
        self.latest["out"] = [a.clone() for a in outputs(args, out)]
        return out

    def pivot_update(self, *args):
        return self._run("simplex_pivot", self.ops.pivot_update, args, {},
                         lambda a, out: [out])

    def reduced_pivot(self, *args, **kwargs):
        return self._run("reduced_pivot", self.ops.reduced_pivot, args,
                         kwargs, lambda a, out: [*a[2:5], *out])

    def phase_done(self):
        if self.latest is not None:
            self.latest["phase_end"] = True
            if self.latest["call"] % PIVOT_SAMPLE:
                self.calls.append(self.latest)
            self.latest = None


def record_pivot_calls(torch, ops, dev, params, method):
    """One untimed rollout of ``method`` with its pivot calls recorded
    (`PivotRecorder`); returns (the recorder, the launch count)."""
    from repro_torch.api import engine as E
    from repro_torch.core import lp
    rec = PivotRecorder(ops)
    phases = {"_phase_batched": lp._phase_batched,
              "_revised_phase": lp._revised_phase}

    def hooked(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            rec.phase_done()
            return out
        return run
    lp.pivot_ops = rec
    for name, fn in phases.items():
        setattr(lp, name, hooked(fn))
    try:
        ops.reset_launches()
        E.rollout(E.init_state(params[method], device=dev), params[method],
                  PERIODS, device=dev)
        torch.cuda.synchronize()
    finally:
        lp.pivot_ops = ops
        for name, fn in phases.items():
            setattr(lp, name, fn)
    counter = ops.pivot_update if method == "tableau" else ops.reduced_pivot
    return rec, counter.launches


def same(torch, a, b):
    """Bitwise equal, NaN where both are NaN."""
    both_nan = torch.isnan(a) & torch.isnan(b) if a.is_floating_point() \
        else torch.zeros_like(a, dtype=torch.bool)
    return bool(((a == b) | both_nan).all())


def gamma(n):
    """The bound on the relative error of an n-term float64 dot product
    summed in any order (n u / (1 - n u), u the unit roundoff)."""
    return n * U64 / (1 - n * U64)


def reduced_decisions(torch, rc, d_of, xB, basis, use_bland, may_pivot,
                      lane_ok, C0, tol):
    """reduced_pivot's decisions, written from the reference's rules, from
    reduced costs ``rc`` (B, C0) and ``d_of(j)``, the FTRAN column (B, R)
    of the entering index j: the first column of the least reduced cost
    below -tol (Dantzig) or the first below -tol (Bland); ratios with the
    artificial drive-out, NaN propagating to rmin; the smallest label in
    the tie band, the first row on equal labels.  Returns (j, d, r, the
    pivoting lanes, the basis after the pivot, has_enter, unbounded,
    degenerate)."""
    B, R = xB.shape
    enter = (rc < -tol) & lane_ok[:, None]
    has = enter.any(dim=1)
    j_dantzig = torch.where(enter, rc, torch.inf).argmin(dim=1)
    j_bland = enter.to(torch.uint8).argmax(dim=1)
    j = torch.where(has, torch.where(use_bland, j_bland, j_dantzig), 0)
    d = d_of(j)
    pos = d > tol
    ratio = torch.where(pos, xB / torch.where(pos, d, 1.0), torch.inf)
    ratio = torch.where((basis >= C0) & (d.abs() > tol) & (xB <= tol), 0.0,
                        ratio)
    unbounded = ~(ratio < torch.inf).any(dim=1)
    rmin = ratio.amin(dim=1)
    band = rmin + torch.clamp_min(rmin.abs() * 1e-9, 1e-12)
    r = torch.where(ratio <= band[:, None], basis, 2 ** 31 - 1).argmin(dim=1)
    do = may_pivot & has & ~unbounded
    at_r = torch.arange(R)[None, :] == r[:, None]
    new_basis = torch.where(do[:, None] & at_r, j[:, None].to(basis.dtype),
                            basis)
    return j, d, r, do, new_basis, has, unbounded, rmin <= tol


def serial_reduced(torch, args, art_cost, tol):
    """reduced_pivot on the CPU in float64 in the kernel's order of
    roundings, a second source beside its plain version: every dot
    product a serial sum in index order, each product and each sum
    rounded apart (PyTorch's elementwise operations do not fuse them), as
    the kernel's `__dmul_rn` / `__dadd_rn`.  Returns (`reduced_decisions`,
    the factor and xB after the pivot, the reduced costs, their bound on
    how far a sum in any other order lies from them, and the FTRAN bound
    of the entering column)."""
    A, c, Binv, xB, basis, use_bland, may_pivot, lane_ok = args
    B, R, C0 = A.shape
    cB = torch.where(basis >= C0, art_cost,
                     c.gather(1, basis.long().clamp(0, C0 - 1)))
    y = torch.zeros((B, R), dtype=torch.float64)
    y_abs = torch.zeros_like(y)
    for i in range(R):                       # BTRAN, thread k: y_k
        term = cB[:, i, None] * Binv[:, i, :]
        y, y_abs = y + term, y_abs + term.abs()
    y_err = 2 * gamma(R) * y_abs
    s = torch.zeros((B, C0), dtype=torch.float64)
    s_abs, dy = torch.zeros_like(s), torch.zeros_like(s)
    for i in range(R):                       # pricing, thread k: column k
        term = y[:, i, None] * A[:, i, :]
        s, s_abs = s + term, s_abs + term.abs()
        dy = dy + A[:, i, :].abs() * y_err[:, i, None]
    rc = c - s
    rc_err = 2 * gamma(R + 1) * (c.abs() + s_abs + dy) + dy
    lanes = torch.arange(B)
    d_err = []

    def ftran(j):                            # thread i: row i
        Aj = A[lanes, :, j]
        d = torch.zeros((B, R), dtype=torch.float64)
        d_abs = torch.zeros_like(d)
        for k in range(R):
            term = Binv[:, :, k] * Aj[:, k, None]
            d, d_abs = d + term, d_abs + term.abs()
        d_err.append(2 * gamma(R) * d_abs)
        return d
    dec = reduced_decisions(torch, rc, ftran, xB, basis, use_bland,
                            may_pivot, lane_ok, C0, tol)
    j, d, r, do = dec[:4]
    F = torch.cat([Binv, xB[..., None]], dim=2)
    piv = torch.where(do, d[lanes, r], 1.0)
    prow = F[lanes, r] / piv[:, None]
    Fnew = torch.addcmul(F, d[:, :, None], prow[:, None, :], value=-1)
    at_r = (torch.arange(R)[None, :] == r[:, None])[:, :, None]
    F = torch.where(do[:, None, None],
                    torch.where(at_r, prow[:, None, :], Fnew), F)
    return dec, F[:, :, :R], F[:, :, R], rc, rc_err, d_err[0]


def within(torch, a, b, err):
    """|a - b| <= err elementwise, equal infinities and NaN where both
    are NaN counting as within."""
    return (a == b) | ((a - b).abs() <= err) | (torch.isnan(a)
                                                 & torch.isnan(b))


def explain_flips(torch, ref, args, kw, got, flags):
    """The kernel's result on a reduced_pivot call (``got``: its in-place
    outputs, ``flags``) against a second source and its plain version.

    The kernel must equal `serial_reduced` (its own order of roundings, on
    the CPU) on every lane: flags and basis exactly, factor and xB to
    1e-12.  The plain version (on the card) may decide a lane otherwise:
    its einsums sum the dot products in another order.  Each such lane is
    explained only if the plain version's own reduced costs and FTRAN
    column, put through the same rules (`reduced_decisions`), give its
    decisions, and every reduced cost and (for the same entering column)
    every d lies within the bound of a reordered sum of the serial ones:
    then rounding alone moved the decision, which was an exact tie or
    within a rounding of the tolerance.  At most `MAX_FLIP_SHARE` of the
    lanes may be decided otherwise.  Returns (lanes decided otherwise,
    the largest share of its bound that a reduced cost's or d's
    difference uses)."""
    B, R, C0 = args[0].shape
    cpu = [a.cpu() for a in args]
    art_cost, tol = kw["art_cost"], kw["tol"]
    want = [t.cpu() for t in ref.reduced_pivot_ref(*args, **kw)]
    got = [t.cpu() for t in (*got[2:5], *flags)]
    dec, Binv_s, xB_s, rc, rc_err, d_err = serial_reduced(torch, cpu,
                                                          art_cost, tol)
    serial = (Binv_s, xB_s, dec[4], *dec[5:])
    check(all(torch.equal(a, b) for a, b in zip(got[2:], serial[2:]))
          and all(torch.allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
                  for a, b in zip(got[:2], serial[:2])),
          "reduced_pivot differs from its serial float64 order on the CPU")
    otherwise = (got[2] != want[2]).any(dim=1)
    for a, b in zip(got[3:], want[3:]):
        otherwise |= a != b
    n = int(otherwise.sum())
    check(n <= MAX_FLIP_SHARE * B,
          f"reduced_pivot's plain version decides {n} of {B} lanes "
          f"otherwise (at most {MAX_FLIP_SHARE * B:.0f})")
    A_d, Binv_d, bas_d = args[0], args[2], args[4]
    rc_p = ref.price_reduced_ref(A_d, args[1], Binv_d, bas_d, art_cost)

    def ftran_plain(j):                      # as the plain version
        j = j.to(A_d.device)
        Aj = torch.gather(A_d, 2, j[:, None, None].expand(B, R, 1))[..., 0]
        return torch.einsum("brk,bk->br", Binv_d, Aj).cpu()
    plain = reduced_decisions(torch, rc_p.cpu(), ftran_plain, *cpu[3:],
                              C0, tol)
    check(all(torch.equal(a, b) for a, b in zip(plain[4:], want[2:])),
          "the reference's rules on the plain version's values do not give "
          "its decisions")
    rc_p = rc_p.cpu()
    same_j = plain[0] == dec[0]
    explained = (within(torch, rc_p, rc, rc_err).all(dim=1)
                 & (~same_j | within(torch, plain[1], dec[1],
                                     d_err).all(dim=1)))
    check(bool(explained[otherwise].all()),
          f"reduced_pivot: {int((~explained[otherwise]).sum())} lanes that "
          f"the plain version decides otherwise differ by more than a "
          f"rounding")
    shares = [((rc_p - rc).abs() / rc_err)[rc_err > 0],
              ((plain[1] - dec[1]).abs() / d_err)[same_j[:, None]
                                                   & (d_err > 0)]]
    share = max([float(t.nan_to_num(0.0).max()) for t in shares if t.numel()]
                or [0.0])
    return n, share


def replay_pivot_call(torch, ops, ref, call, reps=5):
    """One recorded pivot call again through its kernel: bitwise what the
    rollout's own call gave, against its plain version, timed with the
    launches queued behind a device sleep, and its bound from the kernels
    phase's work counts.  simplex_pivot is held to its plain version to
    1e-12; reduced_pivot to its serial order on the CPU and, lane by lane,
    to its plain version or within a rounding of it (`explain_flips`)."""
    args, kw, out = call["args"], call["kwargs"], call["out"]
    if call["kernel"] == "simplex_pivot":
        tabs, r, j, mask = args
        got = tabs.clone()
        ops.pivot_update(got, r, j, mask)
        want = ref.pivot_update_ref(*args)
        check(same(torch, got, out[0])
              and torch.allclose(got, want, rtol=RTOL, atol=ATOL,
                                 equal_nan=True),
              f"rollout call {call['call']}: simplex_pivot disagrees")
        ms = cuda_ms(ops.pivot_update,
                     [(tabs.clone(), r, j, mask) for _ in range(reps)],
                     torch, ahead=True)
        nbytes, flops = simplex_pivot_work(mask, *tabs.shape[1:])
        extra = dict(pivoting_lanes=int(mask.sum()))
    else:
        got = [a.clone() for a in args]
        flags = ops.reduced_pivot(*got, **kw)
        want = ref.reduced_pivot_ref(*args, **kw)
        check(all(same(torch, a, b)
                  for a, b in zip([*got[2:5], *flags], out)),
              f"rollout call {call['call']}: reduced_pivot differs from "
              f"the rollout's own call")
        otherwise = (got[4] != want[2]).any(dim=1)
        for a, b in zip(flags, want[3:]):
            otherwise |= a != b
        same_lanes = ~otherwise
        check(all(torch.allclose(a[same_lanes], b[same_lanes], rtol=RTOL,
                                 atol=ATOL, equal_nan=True)
                  for a, b in zip(got[2:4], want[:2])),
              f"rollout call {call['call']}: reduced_pivot's factor "
              f"disagrees with its plain version on lanes of the same "
              f"pivot")
        n_flips, bound_share = explain_flips(torch, ref, args, kw, got,
                                             flags)
        copies = [tuple(a.clone() if k in (2, 3, 4) else a
                        for k, a in enumerate(args)) for _ in range(reps)]
        ms = cuda_ms(lambda *a: ops.reduced_pivot(*a, **kw), copies, torch,
                     ahead=True)
        nbytes, flops = reduced_pivot_work(torch, ref, args, want,
                                           kw["art_cost"], kw["tol"])
        extra = dict(
            pivoting_lanes=int((args[6] & want[3] & ~want[4]).sum()),
            plain_decides_otherwise=n_flips,
            rounding_bound_share=bound_share)
    bound_ms, bound_by = bound_of(nbytes, flops)
    return dict(call=call["call"], phase_end=call["phase_end"], **extra,
                ms=ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_rollout_calls(torch, ops, ref, dev, params):
    """The rollout's own pivot calls, per LP method: recorded in one
    untimed rollout, replayed one by one (`replay_pivot_call`).  Prints
    each call's ms beside its bound and, from the every-16th sample, the
    rollout's estimated kernel time (launches x mean ms) and its loss
    (launches x mean (ms - bound))."""
    for method in ("tableau", "revised"):
        rec, launches = record_pivot_calls(torch, ops, dev, params, method)
        rows = []
        while rec.calls:
            rows.append(replay_pivot_call(torch, ops, ref, rec.calls.pop(0)))
        sample = [r for r in rows if r["call"] % PIVOT_SAMPLE == 0]
        mean_ms = sum(r["ms"] for r in sample) / len(sample)
        mean_bound = sum(r["bound_ms"] for r in sample) / len(sample)
        emit("rollout_calls", lp_method=method,
             kernel="simplex_pivot" if method == "tableau"
             else "reduced_pivot", launches=launches, calls=rows,
             est_kernel_ms=launches * mean_ms,
             est_bound_ms=launches * mean_bound,
             est_loss_ms=launches * (mean_ms - mean_bound))


def kernel_launches():
    """The launch counters of every kernel, by kernel name."""
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.simplex_pivot import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"simplex_pivot": ops.pivot_update.launches,
            "reduced_pivot": ops.reduced_pivot.launches,
            "cckp_model_dp": cckp_ops.models_dp.launches,
            "flash_attention_fwd": fa_ops.flash_attention_fwd.launches,
            "ssd_scan_fwd": ssd_ops.ssd_scan_fwd.launches,
            "decode_attention_fwd":
                da_ops.decode_attention_fwd.launches,
            "rglru_scan_fwd": rg_ops.rglru_scan_fwd.launches}


def reset_launches():
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.simplex_pivot import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    ops.reset_launches()
    cckp_ops.reset_launches()
    fa_ops.reset_launches()
    ssd_ops.reset_launches()
    da_ops.reset_launches()
    rg_ops.reset_launches()


def front_problem():
    """16384 devices of 12 jobs: even rows `identical_instance`s (m = 2,
    T = 1.2 s), odd rows heterogeneous jobs drawn from `make_fleet`
    profiles of the three paper classes."""
    import numpy as np

    from repro_torch.api import FleetProblem
    from repro_torch.core.instances import identical_instance
    from repro_torch.serving.fleet import make_fleet
    half = D_FLEET // 2
    specs = make_fleet(half, seed=13, horizon=1, es_peak_flops=ES_PEAK_FLOPS,
                       es_hbm_bw=HBM_BYTES_S)
    rng = np.random.default_rng(13)
    het = [s.profile.instance(rng.choice((128, 512, 1024), N_JOBS), T_BUDGET)
           for s in specs]
    ident = [identical_instance(N_JOBS, 2, T_BUDGET, seed=s)
             for s in range(half)]
    insts = [x for pair in zip(ident, het) for x in pair]
    return FleetProblem(p_ed=np.stack([i.p_ed for i in insts]),
                        p_es=np.stack([i.p_es for i in insts]),
                        acc=np.stack([i.acc for i in insts]),
                        T=np.full(D_FLEET, T_BUDGET),
                        real_mask=np.ones((D_FLEET, N_JOBS), bool))


def phase_front(torch, dev):
    import numpy as np

    from repro_torch import api
    fp = front_problem()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = api.solve(fp, policy="auto", device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    tags = np.asarray(sol.solver).astype(str)
    counts = {t: int((tags == t).sum()) for t in sorted(set(tags))}
    check(counts.get("amdp", 0) > 0 and counts.get("amr2", 0) > 0,
          f"front: policy='auto' did not split the fleet: {counts}")
    check(launches["cckp_model_dp"] > 0 and launches["simplex_pivot"] > 0,
          f"front: a kernel never launched: {launches}")
    check(sol.assignment.shape == (D_FLEET, N_JOBS)
          and bool(np.isfinite(sol.accuracy).all()), "front: bad output")
    ok = sol.status == 0
    amr2, amdp = ok & (tags == "amr2"), ok & (tags == "amdp")
    check(bool((sol.makespan[amr2] <= 2 * T_BUDGET + 1e-9).all()),
          "front: an AMR^2 plan exceeds 2T (Theorem 1)")
    check(bool((sol.violation[amdp] <= 1e-9).all()),
          "front: an AMDP plan exceeds T")
    # the first 256 rows again on the CPU (the kernels' plain versions):
    # statuses and tags exact, each device's accuracy and makespan to 1e-9
    cpu = api.solve(fp.take(np.arange(256)), policy="auto", device="cpu")
    check(np.array_equal(cpu.status, sol.status[:256])
          and np.array_equal(np.asarray(cpu.solver).astype(str), tags[:256])
          and np.allclose(cpu.accuracy, sol.accuracy[:256], rtol=0,
                          atol=1e-9)
          and np.allclose(cpu.makespan, sol.makespan[:256], rtol=0,
                          atol=1e-9),
          "front: the card's plan differs from the CPU's on 256 rows")
    emit("front", devices=D_FLEET, solver_counts=counts, seconds=seconds,
         launches=launches, statuses=np.bincount(sol.status).tolist(),
         mean_accuracy=float(sol.accuracy.mean()))


def serve_engine(dev):
    """The periodic-sensing fleet: every device sends one frame class
    (512), up to 12 a period, 1024 ES servers."""
    from repro_torch.serving.fleet import FleetEngine, make_fleet
    from repro_torch.serving.queue import RequestQueue
    devices = make_fleet(D_FLEET, classes=(512,), seed=7, horizon=PERIODS,
                         es_peak_flops=ES_PEAK_FLOPS, es_hbm_bw=HBM_BYTES_S)
    queue = RequestQueue(D_FLEET, (512,), rate=12.0, batch_max=N_JOBS,
                         seed=7)
    return FleetEngine(devices, queue, T=T_BUDGET, n_servers=N_SERVERS,
                       policy="auto", device=dev)


def phase_serve(torch, dev):
    """The serve run, with AMDP's DP calls recorded (`record_dp_calls`):
    returns (launches, seconds, the calls)."""
    from repro_torch.core import amdp
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    engine = serve_engine(dev)
    calls = []
    amdp.cckp_ops = record_dp_calls(cckp_ops, calls)
    try:
        seconds = serve_periods(torch, engine, calls)
    finally:
        amdp.cckp_ops = cckp_ops
    launches = kernel_launches()
    for name in ("cckp_model_dp", "simplex_pivot"):
        check(launches[name] > 0, f"serve: {name} never launched")
    # one DP launch per AMDP call, all of the call's models in it
    check(launches["cckp_model_dp"] == len(calls)
          and all(c["models"] == 2 for c in calls),
          f"serve: {launches['cckp_model_dp']} DP launches for "
          f"{len(calls)} AMDP calls of {[c['models'] for c in calls]} models")
    emit("serve", devices=D_FLEET, periods=PERIODS, seconds=seconds,
         devices_per_s=D_FLEET * PERIODS / seconds, launches=launches,
         launches_per_period={k: v / PERIODS for k, v in launches.items()},
         dp_calls=[dict(period=c["period"], lanes=c["shape"][0],
                        grid=c["shape"][1:], models=c["models"])
                   for c in calls],
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         summary=engine.summary())
    return launches, seconds, calls


def serve_periods(torch, engine, calls):
    """`PERIODS` periods of ``engine`` with every counter set to 0 first;
    each recorded DP call is tagged with its period.  Returns the run's
    seconds."""
    import math
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_all = time.perf_counter()
    for _ in range(PERIODS):
        t0 = time.perf_counter()
        n_calls = len(calls)
        stats = engine.run_period()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for c in calls[n_calls:]:
            c["period"] = stats.period
        log = engine.solver_log[-1]
        row = dict(period=stats.period, seconds=seconds,
                   amdp=log["plan"]["amdp"], amr2=log["plan"]["amr2"],
                   replan=dict(log["replan"]),
                   dp_calls=len(calls) - n_calls,
                   n_backpressured=stats.n_backpressured,
                   n_jobs=stats.n_jobs, n_straggler_updates=
                   stats.n_straggler_updates,
                   mean_job_accuracy=stats.mean_job_accuracy,
                   es_utilization=stats.es_utilization)
        check(row["amdp"] > 0 and row["amr2"] > 0,
              f"serve: period {stats.period} did not use both solvers: "
              f"{dict(log['plan'])}")
        check(stats.n_jobs > 0 and all(
            math.isfinite(getattr(stats, f)) for f in
            ("total_accuracy", "worst_violation", "es_utilization",
             "realized_makespan")), f"serve: bad stats {stats}")
        check(0.3 < stats.mean_job_accuracy < 0.8,
              f"serve: mean job accuracy {stats.mean_job_accuracy}")
        emit("serve", **row)
    return time.perf_counter() - t_all


# --------------------------------------------------------------------------
# phase 6b: the dual policy, Poisson arrivals and the delegated FleetEngine
# --------------------------------------------------------------------------
def first_plan(torch, E, params, dev):
    """The period-0 primary plan of ``params``: the `FleetProblem` the
    engine's first `_plan` call gets and the assignment it returns, from
    one untimed step with `_plan` wrapped."""
    calls = []
    plan = E._plan

    def recording(p, fp, warm_basis, lane_mask=None):
        out = plan(p, fp, warm_basis, lane_mask)
        calls.append((fp, out))
        return out

    E._plan = recording
    try:
        E.step(E.init_state(params, device=dev), params, device=dev)
    finally:
        E._plan = plan
    return calls[0]


# the dual rollout's card-vs-CPU check audits at 1.4: at the default 1.5 a
# 3x straggler's audit after one EMA update is an exact tie, decided by
# the rounding of sums the card and the CPU associate differently
# (ROADMAP §3 item 1)
DUAL_CHECK_THRESHOLD = 1.4


def phase_rollout_dual(torch, dev, params, amr2_metrics):
    """`rollout` of the 16384-device fleet under ``policy="dual"``: 8
    periods on the card with every counter set to 0 before and read after
    (the dual's bisection is PyTorch work: no kernel of the port runs);
    its period-0 plan on the card against the CPU's on every lane and,
    on every 64th lane, against the NumPy `dual_schedule`; the rollout at
    audit threshold `DUAL_CHECK_THRESHOLD` on the card against the CPU
    (integer metrics exact, floats to 1e-9); its accuracy beside the amr2
    rollout's on the same arrivals."""
    import dataclasses

    import numpy as np

    from repro_torch.api import engine as E
    from repro_torch.core.dual import dual_schedule
    from repro_torch.core.types import OffloadInstance
    state = E.init_state(params, device=dev)
    E.rollout(state, params, 1, device=dev)           # untimed first call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final, metrics = E.rollout(state, params, PERIODS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    check(not any(launches.values()),
          f"rollout_dual: a kernel launched on the dual path: {launches}")
    check(int(metrics.n_unsolved.sum()) == 0, "rollout_dual: unsolved")
    check(bool((final.warm_basis == -1).all()),
          "rollout_dual: the dual carried a basis")
    device_s, n_launch, top = profiled(
        torch, lambda: E.rollout(state, params, PERIODS, device=dev))
    cpu = params.to("cpu")
    # period 0: the plan on the card, on the CPU and by the NumPy oracle
    fp, (assign, _st, _basis, _x) = first_plan(torch, E, params, dev)
    _fp, (want0, _st, _basis, _x) = first_plan(torch, E, cpu, "cpu")
    got0 = assign.cpu()
    flips = torch.nonzero((got0 != want0).any(dim=1)).flatten().tolist()
    check(not flips, f"rollout_dual: period-0 lanes {flips[:8]} "
                     f"({len(flips)}) plan otherwise on the card than on "
                     f"the CPU")
    lanes = list(range(0, D_FLEET, 64))
    p_ed, p_es = fp.p_ed.cpu().numpy(), fp.p_es.cpu().numpy()
    acc, got = fp.acc.cpu().numpy(), got0.numpy()
    differ = [b for b in lanes if not np.array_equal(
        got[b], dual_schedule(OffloadInstance(
            p_ed=p_ed[b], p_es=p_es[b], acc=acc[b],
            T=T_BUDGET)).assignment)]
    check(not differ, f"rollout_dual: period-0 lanes {differ[:8]} differ "
                      f"from the NumPy dual_schedule")
    # the whole rollout, card against CPU, off the audit's tie
    checked = dataclasses.replace(params,
                                  straggler_threshold=DUAL_CHECK_THRESHOLD)
    checked_cpu = dataclasses.replace(
        cpu, straggler_threshold=DUAL_CHECK_THRESHOLD)
    _, have = E.rollout(state, checked, PERIODS, device=dev)
    t1 = time.perf_counter()
    _, want = E.rollout(E.init_state(checked_cpu, device="cpu"),
                        checked_cpu, PERIODS, device="cpu")
    cpu_seconds = time.perf_counter() - t1
    for f in E.METRIC_FIELDS:
        a, b = getattr(have, f).cpu(), getattr(want, f)
        if a.is_floating_point():
            check(bool(torch.isfinite(a).all()), f"rollout_dual: {f}")
            d = (a - b).abs().max().item()
            check(d <= 1e-9, f"rollout_dual: {f} differs from the CPU "
                             f"run by {d} (per period {(a - b).tolist()})")
        else:
            check(torch.equal(a, b), f"rollout_dual: {f} {a.tolist()} on "
                                     f"the card, {b.tolist()} on the CPU")
    acc_dual = float(metrics.total_accuracy.sum())
    acc_amr2 = float(amr2_metrics.total_accuracy.sum())
    emit("rollout_dual", devices=D_FLEET, periods=PERIODS, seconds=seconds,
         devices_per_s=D_FLEET * PERIODS / seconds, cpu_seconds=cpu_seconds,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         port_kernel_launches=launches,
         launches_per_period=n_launch / PERIODS,
         device_seconds=device_s,
         busy_share=device_s / seconds if device_s else None, top=top,
         lanes_vs_cpu=D_FLEET, lanes_vs_numpy_oracle=len(lanes),
         n_jobs=int(metrics.n_jobs.sum()),
         n_backpressured=int(metrics.n_backpressured.sum()),
         n_violations=int(metrics.n_violations.sum()),
         n_violations_amr2=int(amr2_metrics.n_violations.sum()),
         worst_violation=float(metrics.worst_violation.max()),
         total_accuracy=acc_dual, total_accuracy_amr2=acc_amr2,
         gap_vs_amr2=(acc_amr2 - acc_dual) / acc_amr2)


def phase_rollout_poisson(torch, ops, dev, fleet):
    """amr2 with ``arrivals="poisson"`` on the 16384-device fleet, 8
    periods on the card (revised LP, counters set to 0 before and read
    after), with the distribution checks on the card's generator: the
    mean count per device-period within 5 standard errors of the rate,
    the class frequencies within 5 of the class probabilities, jobs
    conserved (released + backlog = drawn); then a rate-0 run."""
    import dataclasses

    import numpy as np

    from repro_torch.api import engine as E
    devices, queue = fleet
    params = E.EngineParams.from_fleet(
        devices, queue, T=T_BUDGET, n_servers=N_SERVERS, horizon=1,
        arrivals="poisson", lp_method="revised", device=dev)
    seed = 5
    state = E.init_state(params, seed=seed, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, metrics = E.rollout(state, params, PERIODS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    check(launches["reduced_pivot"] > 0,
          f"rollout_poisson: reduced_pivot never launched: {launches}")
    check(int(metrics.n_unsolved.sum()) == 0, "rollout_poisson: unsolved")
    drawn = torch.stack([torch.poisson(params.rate, generator=E._generator(
        seed, t, 0, dev)) for t in range(PERIODS)]).double()
    released = int(metrics.n_jobs.sum())
    check(released + int(final.pending.sum()) == int(drawn.sum().item()),
          "rollout_poisson: released + backlog != drawn")
    rate = float(params.rate[0])
    mean = drawn.mean().item()
    se = np.sqrt(rate / drawn.numel())
    check(abs(mean - rate) <= 5 * se,
          f"rollout_poisson: mean count {mean} vs rate {rate}")
    ci = torch.cat([E._arrivals(state, params, t)[0].reshape(-1)
                    for t in range(PERIODS)])
    probs = params.class_probs.cpu().numpy()
    freq = (torch.bincount(ci.long(), minlength=len(probs)).double()
            / ci.numel()).cpu().numpy()
    se_c = np.sqrt(probs * (1 - probs) / ci.numel())
    check(bool((np.abs(freq - probs) <= 5 * se_c).all()),
          f"rollout_poisson: class frequencies {freq} vs {probs}")
    zero = dataclasses.replace(params, rate=torch.zeros_like(params.rate))
    _, mz = E.rollout(E.init_state(zero, seed=seed, device=dev), zero, 2,
                      device=dev)
    check(int(mz.n_jobs.sum()) == 0 and int(mz.backlog.sum()) == 0,
          "rollout_poisson: rate 0 released or queued jobs")
    emit("rollout_poisson", devices=D_FLEET, periods=PERIODS,
         seconds=seconds, devices_per_s=D_FLEET * PERIODS / seconds,
         launches={k: v for k, v in launches.items() if v},
         mean_count=mean, rate=rate, count_se=se,
         class_freq=freq.tolist(), class_probs=probs.tolist(),
         released=released, backlog=int(final.pending.sum()),
         n_backpressured=int(metrics.n_backpressured.sum()),
         mean_job_accuracy=float(metrics.mean_job_accuracy.mean()))


def phase_serve_delegated(torch, dev, serve_seconds):
    """`FleetEngine.from_config` on the rollouts' fleet under amr2 and
    dual, the delegation active: 8 periods each with every counter set to
    0 before and read after, then `rollout` of `EngineParams.from_config`
    on the card, which `run` must equal bit for bit."""
    import dataclasses

    from repro_torch.api import engine as E
    from repro_torch.serving.fleet import FleetEngine, FleetPeriodStats
    fields = [f.name for f in dataclasses.fields(FleetPeriodStats)
              if f.name in E.METRIC_FIELDS]
    for policy in ("amr2", "dual"):
        cfg = rollout_config(policy)
        engine = FleetEngine.from_config(cfg, device=dev)
        check(engine._v2_params is not None,
              f"serve_delegated: {policy} did not delegate")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = engine.run(PERIODS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel_launches()
        pivots = launches["simplex_pivot"] + launches["reduced_pivot"]
        check((pivots > 0) == (policy == "amr2"),
              f"serve_delegated: {policy} pivot launches {launches}")
        params = E.EngineParams.from_config(cfg, horizon=PERIODS,
                                            device=dev)
        state, metrics = E.rollout(E.init_state(params, device=dev),
                                   params, PERIODS, device=dev)
        for i, st in enumerate(stats):
            for f in fields:
                a, b = getattr(metrics, f)[i].item(), getattr(st, f)
                check(a == b, f"serve_delegated: {policy} period {i} {f}: "
                              f"run {b}, rollout {a}")
        g = engine._groups[0]
        if policy == "amr2":
            check(bool((state.warm_basis.cpu() == torch.as_tensor(
                g.warm_basis)).all()), "serve_delegated: warm bases differ")
        emit("serve_delegated", policy=policy, devices=D_FLEET,
             periods=PERIODS, seconds=seconds,
             s_per_period=seconds / PERIODS,
             devices_per_s=D_FLEET * PERIODS / seconds,
             host_serve_seconds=serve_seconds,
             host_serve_devices_per_s=D_FLEET * PERIODS / serve_seconds,
             launches={k: v for k, v in launches.items() if v},
             plan_seconds=sum(st.plan_seconds for st in stats),
             n_jobs=sum(st.n_jobs for st in stats),
             n_backpressured=sum(st.n_backpressured for st in stats),
             n_straggler_updates=sum(st.n_straggler_updates
                                     for st in stats),
             mean_job_accuracy=sum(st.total_accuracy for st in stats)
             / max(sum(st.n_jobs for st in stats), 1))


# --------------------------------------------------------------------------
# the chaos and mobility scenarios at the rollouts' fleet
# --------------------------------------------------------------------------
# the reference bench's fault models (benchmarks/fleet_bench.py): its
# "armed_hot" chaos cell and its "harsh" model
ARMED_HOT = dict(link_degrade_prob=0.2, link_degrade_mag=0.6,
                 straggler_prob=0.15, straggler_mult=1.8, loss_rate=0.05)
HARSH = dict(es_crash_prob=0.08, link_degrade_prob=0.25,
             link_degrade_mag=0.6, straggler_prob=0.2, straggler_mult=1.8,
             loss_rate=0.15)
FAULT_SEED, MAX_RETRIES = 11, 2
# card-against-CPU comparisons audit off the 1.5 tie (ROADMAP §3 item 1),
# on a 4096-device fleet: a CPU rollout of 16384 devices takes ~25 s
SCENARIO_CHECK_THRESHOLD = 1.4
D_CHECK = 4096
# the reference bench's mobility geometry: 16 cells on a 4 x 4 grid of
# pitch 20, radius 30, link_alpha 0.2, 64 servers a cell at 16384 devices
GRID, PITCH, RADIUS, LINK_ALPHA, SCATTER = 4, 20.0, 30.0, 0.2, 6.0
WALK_SIGMA = 2.0


def scenario_pair(E, dev, **scenario):
    """A `D_CHECK`-device rollout fleet (the rollouts' recipe, 1/16 of the
    servers) on the card and the same params copied to the CPU, audited
    at `SCENARIO_CHECK_THRESHOLD`, revised LP."""
    import dataclasses
    cfg = dataclasses.replace(rollout_config("amr2"), n_devices=D_CHECK,
                              n_servers=D_CHECK // 16,
                              straggler_threshold=SCENARIO_CHECK_THRESHOLD)
    params = E.EngineParams.from_config(cfg, lp_method="revised",
                                        device=dev)
    if "mobility" in scenario:
        params = params.with_mobility(scenario["mobility"],
                                      routing=scenario["routing"])
    if "faults" in scenario:
        params = params.with_faults(scenario["faults"],
                                    max_retries=MAX_RETRIES,
                                    fault_seed=FAULT_SEED,
                                    fault_trace=scenario["trace"])
    return params, params.to("cpu")


def compare_card_cpu(torch, E, what, card, cpu):
    """Rollouts of ``card`` (on the card) and ``cpu`` (on the CPU):
    integer metrics and state exact, floats to 1e-9."""
    dev = card.device
    sg, mg = E.rollout(E.init_state(card, device=dev), card, PERIODS,
                       device=dev)
    t0 = time.perf_counter()
    sc, mc = E.rollout(E.init_state(cpu, device="cpu"), cpu, PERIODS,
                       device="cpu")
    cpu_seconds = time.perf_counter() - t0
    for f in E.METRIC_FIELDS:
        a, b = getattr(mg, f).cpu(), getattr(mc, f)
        if a.is_floating_point():
            d = (a - b).abs().max().item()
            check(d <= 1e-9, f"{what}: {f} differs from the CPU by {d}")
        else:
            check(torch.equal(a, b), f"{what}: {f} {a.tolist()} on the "
                                     f"card, {b.tolist()} on the CPU")
    for f in E.STATE_FIELDS:
        if f == "warm_basis":        # another optimal basis of a tied LP
            continue
        a, b = getattr(sg, f).cpu(), getattr(sc, f)
        if a.is_floating_point():
            d = (a - b).abs().max().item()
            check(d <= 1e-9, f"{what}: state {f} differs by {d}")
        else:
            check(torch.equal(a, b), f"{what}: state {f} differs")
    return mc, cpu_seconds


def timed_rollout(torch, E, params, dev):
    """The rollout with every launch counter at 0 before and read after:
    (final state, metrics, seconds, launches, peak memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final, metrics = E.rollout(E.init_state(params, device=dev), params,
                               PERIODS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in kernel_launches().items() if v}
    return (final, metrics, seconds, launches,
            torch.cuda.max_memory_allocated())


def wall_seconds(torch, E, params, dev):
    """Seconds of one synchronised rollout (counters untouched)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    E.rollout(E.init_state(params, device=dev), params, PERIODS, device=dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_rollout(torch, E, what, a, b):
    """Two rollouts' metrics equal bit for bit."""
    for f in E.METRIC_FIELDS:
        check(torch.equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} {getattr(a, f).tolist()} vs "
              f"{getattr(b, f).tolist()}")


def es_bound_recorder(E, T, fm):
    """A stand-in for the engine's `realize_execution` that records, per
    call, the largest excess of a device's realized ES time over ``2T +
    backoff_cap + admitted demand x link factor`` (0-d tensors, read after
    the run)."""
    from repro_torch.core.problem import slot_sum
    real_fn, excess = E.realize_execution, []

    def recording(fm_, real, **kw):
        rx = real_fn(fm_, real, **kw)
        demand = slot_sum(kw["p_es_jobs"].where(kw["es_samp"], 0.0))
        bound = 2.0 * T + fm.backoff_cap + demand * real.link_factor
        excess.append((rx.es_wall - bound).amax())
        return rx

    return real_fn, recording, excess


def phase_rollout_chaos(torch, dev, params, plain):
    """The chaos scenario on the rollouts' fleet: (1) armed with the null
    model, bit for bit the plain rollout; (2) the bench's armed_hot model
    drawn on the card, both LP methods, each timed in turns with the plain
    rollout of its method (plain, chaos, chaos, plain); (3) its harsh
    model; (4) a trace drawn on the card replayed on the card and the
    CPU.  Every run checks the ladder identity; a second run of each
    model checks every device's realized ES time against its bound.
    Returns the pivot launches of the counted runs and the plain
    rollouts' seconds."""
    import dataclasses

    from repro_torch.api import engine as E
    from repro_torch.core.faults import FaultModel, sample_trace
    pivots = {"simplex_pivot": 0, "reduced_pivot": 0}
    T = float(params["revised"].T)
    # (1) armed null: the ladder runs and changes no bit
    null = dataclasses.replace(params["revised"], chaos=True)
    check(null.faults.is_null(), "rollout_chaos: the null model fires")
    _s, m_null, secs, launches, _mem = timed_rollout(torch, E, null, dev)
    same_rollout(torch, E, "rollout_chaos armed null vs plain", m_null,
                 plain["revised"])
    pivots["reduced_pivot"] += launches.get("reduced_pivot", 0)
    emit("rollout_chaos", run="armed_null", lp_method="revised",
         seconds=secs, devices_per_s=D_FLEET * PERIODS / secs,
         launches_per_period={k: v / PERIODS for k, v in launches.items()},
         bitwise_vs_plain=True)
    plain_secs = {}
    runs = [("armed_hot", ARMED_HOT, m) for m in ("tableau", "revised")]
    runs.append(("harsh", HARSH, "revised"))
    for name, model, method in runs:
        fm = FaultModel.make(**model)
        p = params[method].with_faults(fm, max_retries=MAX_RETRIES,
                                       fault_seed=FAULT_SEED)
        plain_walls = [wall_seconds(torch, E, params[method], dev)]
        _s, m, secs, launches, mem = timed_rollout(torch, E, p, dev)
        chaos_walls = [secs, wall_seconds(torch, E, p, dev)]
        plain_walls.append(wall_seconds(torch, E, params[method], dev))
        plain_secs[method] = min(plain_walls + [plain_secs.get(method,
                                                               1e9)])
        for k in pivots:
            pivots[k] += launches.get(k, 0)
        kname = "simplex_pivot" if method == "tableau" else "reduced_pivot"
        check(launches.get(kname, 0) > 0,
              f"rollout_chaos: {kname} never launched ({name})")
        check(int(m.n_unsolved.sum()) == 0, "rollout_chaos: unsolved")
        check(torch.equal(m.n_offload_samples, m.n_offload_ok
                          + m.n_fallback_local + m.n_dropped),
              f"rollout_chaos: {name} ladder identity broken")
        # the same run again, recorded: the ES time bound, and bit for bit
        real_fn, recording, excess = es_bound_recorder(E, T, fm)
        E.realize_execution = recording
        try:
            _s2, m2 = E.rollout(E.init_state(p, device=dev), p, PERIODS,
                                device=dev)
        finally:
            E.realize_execution = real_fn
        same_rollout(torch, E, f"rollout_chaos {name} rerun", m, m2)
        worst = max(x.item() for x in excess)
        check(len(excess) == PERIODS and worst <= 1e-9,
              f"rollout_chaos: {name} ES time over its bound by {worst}")
        acc = float(m.total_accuracy.sum())
        acc0 = float(plain[method].total_accuracy.sum())
        busy = {}
        if name == "armed_hot":
            check(int(m.n_es_audit_updates.sum()) > 0,
                  "rollout_chaos: the ES audit never fired")
            check(acc >= 0.90 * acc0, f"rollout_chaos: accuracy {acc} "
                                      f"below 0.90 of fault-free {acc0}")
            device_s, n_launch, top = profiled(torch, lambda: E.rollout(
                E.init_state(p, device=dev), p, PERIODS, device=dev))
            busy = dict(device_seconds=device_s, launches_profiled=n_launch,
                        busy_share=device_s / min(chaos_walls)
                        if device_s else None, top=top)
        emit("rollout_chaos", run=name, lp_method=method, devices=D_FLEET,
             periods=PERIODS, seconds=chaos_walls,
             devices_per_s=D_FLEET * PERIODS / min(chaos_walls),
             plain_seconds=plain_walls,
             wall_vs_plain=min(chaos_walls) / min(plain_walls),
             peak_mem_bytes=mem,
             launches_per_period={k: v / PERIODS
                                  for k, v in launches.items()},
             es_bound_excess=worst, **busy,
             **{f: int(getattr(m, f).sum()) for f in (
                 "n_offload_samples", "n_offload_ok", "n_retries",
                 "n_fallback_local", "n_dropped", "n_deadline_miss",
                 "n_es_audit_updates", "n_straggler_updates",
                 "n_backpressured")},
             total_accuracy=acc, total_accuracy_fault_free=acc0,
             accuracy_kept=acc / acc0)
    # (4) one trace drawn on the card, replayed on the card and the CPU
    fm = FaultModel.make(**ARMED_HOT)
    trace = sample_trace(FAULT_SEED, fm, D_CHECK, N_JOBS, MAX_RETRIES + 1,
                         PERIODS, device=dev)
    card, cpu = scenario_pair(E, dev, faults=fm, trace=trace)
    mc, cpu_seconds = compare_card_cpu(torch, E, "rollout_chaos replay",
                                       card, cpu)
    check(int(mc.n_es_audit_updates.sum()) > 0,
          "rollout_chaos: replay fired no ES audit")
    emit("rollout_chaos", run="card_vs_cpu_replay", devices=D_CHECK,
         periods=PERIODS, threshold=SCENARIO_CHECK_THRESHOLD,
         cpu_seconds=cpu_seconds, equal=True,
         n_retries=int(mc.n_retries.sum()),
         n_es_audit_updates=int(mc.n_es_audit_updates.sum()))
    return pivots, plain_secs


def grid_mobility(D, periods):
    """The bench geometry; each device's home cell from
    ``default_rng(0)``, its replayed positions home + normal(SCATTER)."""
    import numpy as np

    from repro_torch.core.mobility import MobilityModel
    cxy = np.array([[PITCH * i, PITCH * j] for i in range(GRID)
                    for j in range(GRID)], np.float64)
    rng = np.random.default_rng(0)
    home = rng.integers(0, GRID * GRID, D)
    trace = cxy[home][None] + rng.normal(scale=SCATTER,
                                         size=(periods, D, 2))
    return MobilityModel.make(cell_xy=cxy, trace=trace, radius=RADIUS,
                              link_alpha=LINK_ALPHA, walk_sigma=WALK_SIGMA)


def admission_recorder(E):
    """A stand-in for the engine's `admit_mask_segmented` that keeps each
    call's demands, cells and admitted set (tensors, read after)."""
    real_fn, calls = E.admit_mask_segmented, []

    def recording(demand, cell, T, n_cells, k):
        out = real_fn(demand, cell, T, n_cells, k)
        calls.append((demand, cell, float(T), n_cells, k, out[0]))
        return out

    return real_fn, recording, calls


def phase_rollout_mobility(torch, dev, params, plain, plain_launches):
    """The mobility scenario on the rollouts' fleet (revised LP): one cell
    of infinite radius bit for bit the plain rollout; the bench's 16-cell
    grid under both routings, timed in turns with the plain rollout
    (handovers, each period's admission against the sequential oracle,
    two card runs bitwise, the card against the CPU); the walk's steps by
    distribution.  Returns the pivot launches of the counted runs."""
    import numpy as np

    from repro_torch.api import engine as E
    from repro_torch.core.mobility import MobilityModel, admit_mask_cells_np
    base = params["revised"]
    launched = 0
    one = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                             trace=np.zeros((PERIODS, D_FLEET, 2)))
    _s, m1, secs, launches, _mem = timed_rollout(
        torch, E, base.with_mobility(one), dev)
    same_rollout(torch, E, "rollout_mobility one cell vs plain", m1,
                 plain["revised"])
    launched += launches.get("reduced_pivot", 0)
    emit("rollout_mobility", run="one_cell_infinite_radius", seconds=secs,
         devices_per_s=D_FLEET * PERIODS / secs, bitwise_vs_plain=True)
    grid = grid_mobility(D_FLEET, PERIODS)
    plain_pivots = plain_launches["reduced_pivot"] / PERIODS
    for routing in ("nearest", "min_time"):
        p = base.with_mobility(grid, routing=routing)
        check(p.n_cells == 16 and p.servers_per_cell == N_SERVERS // 16,
              f"rollout_mobility: {p.n_cells} cells")
        plain_walls = [wall_seconds(torch, E, base, dev)]
        s, m, secs, launches, mem = timed_rollout(torch, E, p, dev)
        walls = [secs, wall_seconds(torch, E, p, dev)]
        plain_walls.append(wall_seconds(torch, E, base, dev))
        launched += launches.get("reduced_pivot", 0)
        check(launches.get("reduced_pivot", 0) > 0,
              "rollout_mobility: reduced_pivot never launched")
        check(int(m.n_unsolved.sum()) == 0, "rollout_mobility: unsolved")
        check(int(m.n_handover.sum()) > 0 and int(m.n_handover[0]) == 0,
              f"rollout_mobility: handovers {m.n_handover.tolist()}")
        # again, admission recorded: bitwise the timed run, every
        # period's admitted set the sequential oracle's
        real_fn, recording, calls = admission_recorder(E)
        E.admit_mask_segmented = recording
        try:
            s2, m2 = E.rollout(E.init_state(p, device=dev), p, PERIODS,
                               device=dev)
        finally:
            E.admit_mask_segmented = real_fn
        same_rollout(torch, E, f"rollout_mobility {routing} rerun", m, m2)
        for f in ("cell", "pos", "p_es_belief", "warm_basis", "p_ed"):
            check(torch.equal(getattr(s, f), getattr(s2, f)),
                  f"rollout_mobility: {routing} rerun state {f} differs")
        check(len(calls) == PERIODS, f"rollout_mobility: {len(calls)} "
                                     f"admission calls")
        for t, (demand, cell, T, S, k, admitted) in enumerate(calls):
            want, _loads = admit_mask_cells_np(
                demand.cpu().numpy(), cell.cpu().numpy(), T, S, k)
            got = admitted.cpu().numpy()
            check(np.array_equal(got, want),
                  f"rollout_mobility: {routing} period {t}: "
                  f"{int((got != want).sum())} devices admitted otherwise "
                  f"than the sequential oracle")
        busy = {}
        if routing == "nearest":
            device_s, n_launch, top = profiled(torch, lambda: E.rollout(
                E.init_state(p, device=dev), p, PERIODS, device=dev))
            busy = dict(device_seconds=device_s, launches_profiled=n_launch,
                        busy_share=device_s / min(walls)
                        if device_s else None, top=top)
        card, cpu = scenario_pair(E, dev, mobility=grid_mobility(
            D_CHECK, PERIODS), routing=routing)
        mc, cpu_seconds = compare_card_cpu(
            torch, E, f"rollout_mobility {routing}", card, cpu)
        emit("rollout_mobility", run="grid16", routing=routing,
             devices=D_FLEET, periods=PERIODS, seconds=walls,
             devices_per_s=D_FLEET * PERIODS / min(walls),
             plain_seconds=plain_walls,
             wall_vs_plain=min(walls) / min(plain_walls),
             peak_mem_bytes=mem,
             launches_per_period={k: v / PERIODS
                                  for k, v in launches.items()},
             pivots_per_period=launches["reduced_pivot"] / PERIODS,
             plain_pivots_per_period=plain_pivots, **busy,
             n_handover=m.n_handover.tolist(),
             n_outage=int(m.n_outage.sum()),
             n_backpressured=int(m.n_backpressured.sum()),
             n_backpressured_plain=int(
                 plain["revised"].n_backpressured.sum()),
             total_accuracy=float(m.total_accuracy.sum()),
             total_accuracy_plain=float(
                 plain["revised"].total_accuracy.sum()),
             admission_periods_vs_oracle=len(calls),
             card_vs_cpu_devices=D_CHECK, cpu_seconds=cpu_seconds,
             n_handover_cpu=int(mc.n_handover.sum()))
    # the walk: steps by distribution on the card's generator
    walk = base.with_mobility(grid, mode="walk", mobility_seed=3)
    state = E.init_state(walk, device=dev)
    steps = E._positions(state, walk, 0) - state.pos
    n = steps.numel()
    mean, std = steps.mean().item(), steps.std().item()
    check(abs(mean) <= 5 * WALK_SIGMA / np.sqrt(n)
          and abs(std - WALK_SIGMA) <= 5 * WALK_SIGMA / np.sqrt(2 * n),
          f"rollout_mobility: walk steps mean {mean} std {std}")
    _s, mw = E.rollout(state, walk, 2, device=dev)
    check(int(mw.n_unsolved.sum()) == 0, "rollout_mobility: walk unsolved")
    emit("rollout_mobility", run="walk", step_mean=mean, step_std=std,
         walk_sigma=WALK_SIGMA, n_steps=n, n_handover=mw.n_handover.tolist())
    return {"reduced_pivot": launched}

# the HI phase: a 64-period horizon, the rules of `core.hi`, one seed
HI_PERIODS, HI_SEED, HI_ARMS = 64, 3, 9
HI_RULES = ("fixed", "threshold", "ucb", "exp3")


def hi_fleet(E, dev, D, threshold=1.5):
    """The rollouts' recipe at ``D`` devices (``D // 16`` servers) with a
    `HI_PERIODS`-period horizon."""
    import dataclasses
    cfg = dataclasses.replace(rollout_config("amr2"), n_devices=D,
                              n_servers=D // 16, horizon=HI_PERIODS,
                              straggler_threshold=threshold)
    return E.EngineParams.from_config(cfg, device=dev)


def periods_with_jobs(params):
    """(D,) periods in which each device released a job, from the
    replayed arrival trace and the backlog it leaves (host NumPy)."""
    import numpy as np
    counts = params.counts.cpu().numpy()[:HI_PERIODS]
    pending = np.zeros(counts.shape[1], np.int64)
    busy = np.zeros(counts.shape[1], np.int64)
    for c in counts:
        avail = pending + c
        take = np.minimum(avail, params.batch_max)
        busy += take > 0
        pending = avail - take
    return busy


def hi_rollout(torch, E, params, dev):
    """A synchronised `HI_PERIODS`-period rollout: (state, metrics,
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = E.rollout(E.init_state(params, device=dev), params,
                               HI_PERIODS, device=dev)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0


def same_hi_state(torch, what, a, b):
    from repro_torch.core.hi import HI_STATE_FIELDS
    for f in HI_STATE_FIELDS:
        check(torch.equal(getattr(a, f), getattr(b, f)),
              f"{what}: learner {f} differs")


def phase_rollout_hi(torch, dev, params, plain, plain_seconds):
    """Online hierarchical inference on a 16384-device fleet of the
    rollouts' recipe with a 64-period horizon: each rule for 64 periods
    (the accounting identity every period; bandits' arm counts; timed and
    profiled), the clairvoyant fixed rule at zero regret, the threshold
    learner against the fixed rule at 0.5 (final regret, sublinear
    increments, |theta - theta*|), replay == fold on the card, each rule
    on the card against the CPU at 4096 devices under one trace drawn on
    the card, and the disarmed round trip bit for bit the plain rollout."""
    import numpy as np

    from repro_torch.api import engine as E
    from repro_torch.core.hi import (HIModel, draw_arm_uniforms,
                                     presample_stream)
    t0 = time.perf_counter()
    base = hi_fleet(E, dev, D_FLEET)
    busy = periods_with_jobs(base)
    emit("rollout_hi", run="build", devices=D_FLEET, periods=HI_PERIODS,
         seconds=time.perf_counter() - t0,
         idle_device_periods=int(D_FLEET * HI_PERIODS - busy.sum()))
    plain_per_period = plain_seconds / PERIODS
    runs = {}
    for rule in HI_RULES:
        p = base.with_hi(HIModel.make(), rule=rule, n_arms=HI_ARMS,
                         hi_seed=HI_SEED)
        reset_launches()
        state, m, secs = hi_rollout(torch, E, p, dev)
        launched = {k: v for k, v in kernel_launches().items() if v}
        check(not launched, f"rollout_hi: {rule} launched {launched}")
        check(torch.equal(m.n_hi_offloaded + m.n_hi_local_final, m.n_jobs),
              f"rollout_hi: {rule} accounting identity broken")
        check(float(m.hi_regret.min()) >= 0.0
              and bool((m.hi_regret.diff() >= -1e-9).all()),
              f"rollout_hi: {rule} regret decreases")
        extra = {}
        if rule in ("ucb", "exp3"):
            cnt = state.hi.arms_cnt.sum(dim=1).cpu().numpy()
            check(np.array_equal(cnt, busy.astype(np.float64)),
                  f"rollout_hi: {rule} arm counts differ from the periods "
                  f"with jobs on {int((cnt != busy).sum())} devices")
            extra["arm_counts_equal_periods_with_jobs"] = True
        device_s, n_launch, top = profiled(torch, lambda: E.rollout(
            E.init_state(p, device=dev), p, HI_PERIODS, device=dev))
        runs[rule] = (state, m)
        emit("rollout_hi", run=rule, devices=D_FLEET, periods=HI_PERIODS,
             seconds=secs, seconds_per_period=secs / HI_PERIODS,
             plain_revised_seconds_per_period=plain_per_period,
             devices_per_s=D_FLEET * HI_PERIODS / secs,
             launches_per_period=n_launch / HI_PERIODS,
             device_seconds=device_s,
             busy_share=device_s / secs if device_s else None, top=top[:5],
             final_regret=float(m.hi_regret[-1]),
             n_hi_offloaded=int(m.n_hi_offloaded.sum()),
             n_hi_local_final=int(m.n_hi_local_final.sum()),
             n_backpressured=int(m.n_backpressured.sum()),
             total_accuracy=float(m.total_accuracy.sum()), **extra)
    # the clairvoyant and the learner against the miscalibrated fixed rule
    beta = HIModel.make().offload_cost
    theta_star = (base.acc[:, base.m] - beta).clamp(0.0, 1.0)
    clair = base.with_hi(HIModel.make(theta0=theta_star), rule="fixed",
                         hi_seed=HI_SEED)
    _s, mc, _secs = hi_rollout(torch, E, clair, dev)
    check(float(mc.hi_regret[-1]) == 0.0,
          f"rollout_hi: clairvoyant regret {float(mc.hi_regret[-1])}")
    s_thr, m_thr = runs["threshold"]
    reg, reg_fixed = m_thr.hi_regret, runs["fixed"][1].hi_regret
    half = HI_PERIODS // 2 - 1
    first, second = float(reg[half] - reg[0]), float(reg[-1] - reg[half])
    err = float((s_thr.hi.theta - theta_star).abs().mean())
    check(float(reg[-1]) < float(reg_fixed[-1]),
          f"rollout_hi: learner regret {float(reg[-1])} not below the "
          f"fixed rule's {float(reg_fixed[-1])}")
    check(second < first, f"rollout_hi: regret increments {first}, "
                          f"{second}: not sublinear")
    check(err < 0.1, f"rollout_hi: mean |theta - theta*| {err}")
    emit("rollout_hi", run="learning", clairvoyant_regret=0.0,
         threshold_regret=float(reg[-1]), fixed_regret=float(reg_fixed[-1]),
         first_half_increment=first, second_half_increment=second,
         mean_theta_error=err)
    # replay == fold on the card: both streams replayed for EXP3
    tr = presample_stream(HI_SEED, D_FLEET, N_JOBS, HI_PERIODS, device=dev)
    arms = torch.stack([draw_arm_uniforms(HI_SEED, t, D_FLEET, dev)
                        for t in range(HI_PERIODS)])
    rep = base.with_hi(HIModel.make(conf_trace=tr), rule="exp3",
                       n_arms=HI_ARMS, stream="replay", hi_seed=HI_SEED,
                       hi_arm_trace=arms)
    s_rep, m_rep, _secs = hi_rollout(torch, E, rep, dev)
    same_rollout(torch, E, "rollout_hi replay vs fold", m_rep,
                 runs["exp3"][1])
    same_hi_state(torch, "rollout_hi replay vs fold", s_rep.hi,
                  runs["exp3"][0].hi)
    del tr, arms, rep, runs
    # the card against the CPU at 4096 devices under one replayed trace
    small = hi_fleet(E, dev, D_CHECK, SCENARIO_CHECK_THRESHOLD)
    tr = presample_stream(HI_SEED, D_CHECK, N_JOBS, HI_PERIODS, device=dev)
    arms = torch.stack([draw_arm_uniforms(HI_SEED, t, D_CHECK, dev)
                        for t in range(HI_PERIODS)])
    cpu_seconds = {}
    for rule in HI_RULES:
        card = small.with_hi(HIModel.make(conf_trace=tr), rule=rule,
                             n_arms=HI_ARMS, stream="replay",
                             hi_seed=HI_SEED, hi_arm_trace=arms)
        cpu = card.to("cpu")
        sg, mg = E.rollout(E.init_state(card, device=dev), card, HI_PERIODS,
                           device=dev)
        t1 = time.perf_counter()
        sc, mcpu = E.rollout(E.init_state(cpu, device="cpu"), cpu,
                             HI_PERIODS, device="cpu")
        cpu_seconds[rule] = time.perf_counter() - t1
        compare_hi(torch, E, f"rollout_hi {rule} card vs CPU", mg, mcpu,
                   sg, sc)
    emit("rollout_hi", run="card_vs_cpu_replay", devices=D_CHECK,
         periods=HI_PERIODS, threshold=SCENARIO_CHECK_THRESHOLD,
         cpu_seconds=cpu_seconds, equal=True)
    # disarmed: bit for bit the plain rollout
    off = params["revised"].with_hi(HIModel.make(), rule="exp3").with_hi(None)
    _s, m_off, secs, _l, _mem = timed_rollout(torch, E, off, dev)
    same_rollout(torch, E, "rollout_hi disarmed vs plain", m_off,
                 plain["revised"])
    emit("rollout_hi", run="disarmed", seconds=secs, bitwise_vs_plain=True)


def compare_hi(torch, E, what, mg, mc, sg, sc):
    """Card against CPU: integer metrics and state exact, floats and the
    learner to 1e-9."""
    from repro_torch.core.hi import HI_STATE_FIELDS
    for f in E.METRIC_FIELDS:
        a, b = getattr(mg, f).cpu(), getattr(mc, f)
        if a.is_floating_point():
            d = (a - b).abs().max().item()
            check(d <= 1e-9, f"{what}: {f} differs by {d}")
        else:
            check(torch.equal(a, b), f"{what}: {f} differs")
    for f in ("p_ed", "pending", "head", "n_updates"):
        a, b = getattr(sg, f).cpu(), getattr(sc, f)
        check((a.double() - b.double()).abs().max().item() <= 1e-9
              if a.is_floating_point() else torch.equal(a, b),
              f"{what}: state {f} differs")
    for f in HI_STATE_FIELDS:
        a, b = getattr(sg.hi, f).cpu(), getattr(sc.hi, f)
        check((a - b).abs().max().item() <= 1e-9 if a.is_floating_point()
              else torch.equal(a, b), f"{what}: learner {f} differs")


# the gradient phase: the reference test's recipe at the fleet's size
GRAD_PERIODS, GRAD_EPS, GRAD_RTOL, GRAD_ATOL = 4, 1e-5, 1e-4, 1e-6
GRAD_CHECK_DEVICES = 1024
GRAD_WRT = ("p_es", "T", "acc", "base_p_ed")


def jittered(torch, params, seed=0):
    """``p_es`` nudged by +-U(1e-3, 3e-3) (`tests/test_grad.py`'s
    `_diff_params`): off the LP vertex boundaries the profiles put it on."""
    import dataclasses

    import numpy as np
    rng = np.random.default_rng(1000 + seed)
    shape = tuple(params.p_es.shape)
    nudge = (rng.uniform(1e-3, 3e-3, size=shape)
             * rng.choice([-1.0, 1.0], size=shape))
    return dataclasses.replace(params, p_es=params.p_es + torch.as_tensor(
        nudge, device=params.device))


def grad_value(torch, E, params, dev):
    """The relaxed forward's summed accuracy (no graph)."""
    _s, m = E.rollout(E.init_state(params, device=dev), params,
                      GRAD_PERIODS, device=dev)
    return m.total_accuracy.sum().item()


def fd_check(torch, E, params, dev, leaf, idx, analytic, what):
    """Central finite differences at ``GRAD_EPS`` against ``analytic``
    (rtol `GRAD_RTOL`, atol `GRAD_ATOL`).  Where the two one-sided slopes
    disagree by more than the tolerance, the probe spans a kink of the
    piecewise-smooth rollout (an LP basis or admission change within
    +-eps), where central differences average two slopes; the probe is
    then repeated at eps / 100.  Returns the row to print."""
    import dataclasses
    base = getattr(params, leaf)

    def at(e):
        x = base.clone().reshape(-1)
        x[idx] += e
        return grad_value(torch, E, dataclasses.replace(
            params, **{leaf: x.reshape(base.shape)}), dev)

    def close(a, b):
        return abs(a - b) <= GRAD_ATOL or abs(a - b) <= GRAD_RTOL * max(
            abs(a), abs(b))

    v0 = grad_value(torch, E, params, dev)
    row = dict(leaf=leaf, index=int(idx), analytic=analytic)
    for eps in (GRAD_EPS, GRAD_EPS / 100):
        vp, vm = at(eps), at(-eps)
        central, up, down = (vp - vm) / (2 * eps), (vp - v0) / eps, \
            (v0 - vm) / eps
        row.update(eps=eps, fd=central, one_sided=(down, up),
                   kink=not close(up, down))
        if close(central, analytic) or not row["kink"]:
            break
    check(close(row["fd"], analytic),
          f"{what}: {leaf}[{idx}] finite differences {row['fd']} vs "
          f"analytic {analytic} (eps {row['eps']})")
    return row


# --------------------------------------------------------------------------
# the sharded engine
# --------------------------------------------------------------------------
# the ported shard smoke's run on the card: gloo ranks sharing the card,
# each with a block of SHARD_DEVICES / SHARD_RANKS devices, on these legs
SHARD_RANKS, SHARD_DEVICES = 4, D_FLEET
SHARD_LEGS = "tableau,revised,chaos"


def phase_rollout_sharded(torch, dev, params):
    """(a) `rollout_sharded` of the rollouts' fleet on an NCCL world of one
    rank on the card, per LP method, timed in turns with the unsharded
    rollout (plain, sharded, sharded, plain, twice; medians), every launch
    counter and the mesh's collective counts at 0 before the first sharded
    run and read after it: its metrics and final state bit for bit the
    unsharded rollout's (one rank's collectives are copies), collectives,
    bytes gathered and reduced, pivot launches a period.  (b) the ported
    `smoke_shard_rollout` in a child process: `SHARD_RANKS` gloo ranks of
    `SHARD_DEVICES` / `SHARD_RANKS` devices each, all on this card, legs
    `SHARD_LEGS`, each rank against the unsharded card rollout; its wall is
    a correctness run's (the ranks share one card and move every
    collective through the host).  Returns (a)'s launches."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch import _mesh
    from repro_torch.api import engine as E
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = E.fleet_mesh(1)
            for method, kname in (("tableau", "simplex_pivot"),
                                  ("revised", "reduced_pivot")):
                p = params[method]
                s0 = E.init_state(p, device=dev)
                ss, sp = E.shard(s0, p, mesh)
                walls = {"rollout": [], "rollout_sharded": []}
                out = {}
                for which in ("rollout", "rollout_sharded",
                              "rollout_sharded", "rollout") * 2:
                    counted = which == "rollout_sharded" and which not in out
                    if counted:
                        reset_launches()
                        _mesh.reset_stats()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if which == "rollout":
                        res = E.rollout(s0, p, PERIODS, device=dev)
                    else:
                        res = E.rollout_sharded(ss, sp, PERIODS, mesh,
                                                device=dev)
                    torch.cuda.synchronize()
                    walls[which].append(time.perf_counter() - t0)
                    if counted:
                        n = {k: v for k, v in kernel_launches().items()
                             if v}
                        stats = dict(_mesh.STATS)
                    out.setdefault(which, res)
                check(n.get(kname, 0) > 0,
                      f"rollout_sharded: {kname} never launched ({n})")
                launches[kname] = launches.get(kname, 0) + n[kname]
                (uf, mu), (sf, ms) = out["rollout"], out["rollout_sharded"]
                for f in E.METRIC_FIELDS:
                    check(torch.equal(getattr(mu, f), getattr(ms, f)),
                          f"rollout_sharded ({method}): {f} "
                          f"{getattr(ms, f).tolist()} vs "
                          f"{getattr(mu, f).tolist()}")
                for f in E.STATE_FIELDS:
                    check(torch.equal(getattr(uf, f), getattr(sf, f)),
                          f"rollout_sharded ({method}): state {f} differs")
                sharded = float(np.median(walls["rollout_sharded"]))
                emit("rollout_sharded", run="nccl_world_of_one",
                     lp_method=method, devices=D_FLEET, periods=PERIODS,
                     seconds=walls["rollout_sharded"],
                     unsharded_seconds=walls["rollout"],
                     wall_ratio=sharded / float(np.median(walls["rollout"])),
                     devices_per_s=D_FLEET * PERIODS / sharded,
                     collectives_per_period=stats["collectives"] / PERIODS,
                     bytes_gathered_per_period=(stats["bytes_gathered"]
                                                / PERIODS),
                     bytes_reduced_per_period=(stats["bytes_reduced"]
                                               / PERIODS),
                     launches=n, pivot_launches_per_period=n[kname] / PERIODS,
                     equal_to_unsharded=True)
        finally:
            dist.destroy_process_group()
    # (b) four gloo ranks on this card, in a child process
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")))))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.smoke_shard_rollout",
         "--shards", str(SHARD_RANKS), "--devices", str(SHARD_DEVICES),
         "--periods", str(PERIODS), "--backend", "gloo", "--device", "cuda",
         "--legs", SHARD_LEGS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"rollout_sharded: the {SHARD_RANKS}-rank gloo smoke failed:\n"
          f"{proc.stdout[-3000:]}{proc.stderr[-4000:]}")
    report = [json.loads(line) for line in proc.stdout.splitlines()
              if line.startswith('{"smoke_shard_rollout"')]
    check(len(report) == 1, "rollout_sharded: no report from the smoke")
    emit("rollout_sharded", run="gloo_ranks_on_one_card",
         correctness_run=True, ranks=SHARD_RANKS, devices=SHARD_DEVICES,
         seconds=time.perf_counter() - t0,
         legs=report[0]["smoke_shard_rollout"]["legs"],
         verdict=proc.stdout.strip().splitlines()[-1])
    return launches


def phase_rollout_grad(torch, dev, params):
    """The differentiable rollout on the rollouts' 16384-device fleet, 4
    periods, once per LP method: the straight-through value against the
    hard rollout; at a jittered ``p_es`` the soft relaxation's gradients
    against central finite differences (two ``p_es`` coordinates, ``T``,
    one ``acc``, and the ``base_p_ed`` coordinate of largest gradient,
    which must be non-zero); value-and-grad wall against the forward's in turns,
    peak memory, the pivot kernels' launches in the forward, the
    backward's device time and `kkt_vjp_ref`'s share; the card against
    the CPU at 1024 devices.  Returns the pivot launches of the counted
    runs."""
    import dataclasses

    import numpy as np

    from repro_torch.api import engine as E
    from repro_torch.core import lp
    from repro_torch.kernels.simplex_pivot import ops
    pivots = {"simplex_pivot": 0, "reduced_pivot": 0}
    for method in ("tableau", "revised"):
        kname = "simplex_pivot" if method == "tableau" else "reduced_pivot"
        hard = params[method]
        # (1) straight-through: the value is the hard rollout's accuracy
        st = hard.with_differentiable(smooth_mode="st")
        _s, m_hard = E.rollout(E.init_state(hard, device=dev), hard,
                               GRAD_PERIODS, device=dev)
        want = m_hard.total_accuracy.sum().item()
        val_st, _g = E.rollout_value_and_grad(
            E.init_state(st, device=dev), st, GRAD_PERIODS, device=dev)
        diff = abs(val_st.item() - want)
        check(diff <= 1e-9 * abs(want), f"rollout_grad: {method} "
              f"straight-through value {val_st.item()} vs hard {want}")
        # (2) soft at the jittered base point, timed in turns.  Audited
        # off the 1.5 tie (ROADMAP §3 item 1): the devices whose ED row
        # binds are the audited stragglers, whose measured / predicted
        # ratio equals 1.5 to the last bit there, so a 1e-9 nudge of
        # their base_p_ed flips the audit and finite differences jump
        soft = jittered(torch, dataclasses.replace(
            hard, straggler_threshold=SCENARIO_CHECK_THRESHOLD
        ).with_differentiable(smooth_mode="soft"))
        walls = {"forward": [], "value_and_grad": []}
        for kind in ("forward", "value_and_grad", "value_and_grad",
                     "forward"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            if kind == "forward":
                E.rollout(E.init_state(soft, device=dev), soft,
                          GRAD_PERIODS, device=dev)
            else:
                value, grads = E.rollout_value_and_grad(
                    E.init_state(soft, device=dev), soft, GRAD_PERIODS,
                    wrt=GRAD_WRT, device=dev)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            if kind == "value_and_grad":
                mem = torch.cuda.max_memory_allocated()
                launched = kernel_launches()[kname]
        pivots[kname] += launched
        check(launched > 0, f"rollout_grad: {kname} never launched")
        rng = np.random.default_rng(55)
        g_es, g_acc = grads["p_es"].reshape(-1), grads["acc"].reshape(-1)
        probes = [("p_es", int(i), g_es[int(i)].item())
                  for i in rng.choice(g_es.numel(), size=2, replace=False)]
        probes.append(("T", 0, grads["T"].item()))
        i = int(rng.integers(g_acc.numel()))
        probes.append(("acc", i, g_acc[i].item()))
        g_ed = grads["base_p_ed"].reshape(-1)
        i = int(g_ed.abs().argmax())
        check(g_ed[i].item() != 0.0,
              f"rollout_grad: {method} base_p_ed gradient is all zero")
        probes.append(("base_p_ed", i, g_ed[i].item()))
        rows = [fd_check(torch, E, soft, dev, leaf, idx, an,
                         f"rollout_grad {method}")
                for leaf, idx, an in probes]
        # (3) the backward alone: device time, and kkt_vjp_ref's share
        backward = backward_profile(torch, E, lp, soft, dev)
        emit("rollout_grad", lp_method=method, devices=D_FLEET,
             periods=GRAD_PERIODS, st_value=val_st.item(), hard_value=want,
             st_abs_diff=diff, soft_value=value.item(),
             forward_seconds=walls["forward"],
             value_and_grad_seconds=walls["value_and_grad"],
             value_and_grad_vs_forward=min(walls["value_and_grad"])
             / min(walls["forward"]),
             peak_mem_bytes=mem,
             pivot_launches_forward={kname: launched},
             pivot_launches_per_period=launched / GRAD_PERIODS,
             fd=rows, **backward,
             grad_norms={k: v.norm().item() for k, v in grads.items()})
        del grads
        # (4) the card against the CPU at 1024 devices
        cfg = dataclasses.replace(
            rollout_config("amr2"), n_devices=GRAD_CHECK_DEVICES,
            n_servers=GRAD_CHECK_DEVICES // 16,
            straggler_threshold=SCENARIO_CHECK_THRESHOLD)
        small = jittered(torch, E.EngineParams.from_config(
            cfg, lp_method=method, device=dev).with_differentiable(
                smooth_mode="soft"))
        cpu = small.to("cpu")
        wrt = GRAD_WRT
        vg, gg = E.rollout_value_and_grad(E.init_state(small, device=dev),
                                          small, GRAD_PERIODS, wrt=wrt,
                                          device=dev)
        t0 = time.perf_counter()
        vc, gc = E.rollout_value_and_grad(E.init_state(cpu, device="cpu"),
                                          cpu, GRAD_PERIODS, wrt=wrt,
                                          device="cpu")
        cpu_s = time.perf_counter() - t0
        check(abs(vg.item() - vc.item()) <= 1e-9 * abs(vc.item()),
              f"rollout_grad: {method} value card {vg.item()} CPU "
              f"{vc.item()}")
        rel = {}
        for f in wrt:
            scale = max(gc[f].abs().max().item(), 1e-30)
            rel[f] = (gg[f].cpu() - gc[f]).abs().max().item() / scale
            check(rel[f] <= 1e-9, f"rollout_grad: {method} {f} card vs "
                                  f"CPU {rel[f]}")
        emit("rollout_grad", lp_method=method, run="card_vs_cpu",
             devices=small.n_devices, cpu_seconds=cpu_s,
             max_rel_diff=rel)
    return pivots


def backward_profile(torch, E, lp, params, dev):
    """The gradient's backward alone under `torch.profiler`: its device
    time and `kkt_vjp_ref`'s (a stand-in in `core.lp` wraps each call in a
    profiler range), and its wall."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    real = lp.kkt_vjp_ref

    def ranged(*a, **k):
        with record_function("kkt_vjp"):
            return real(*a, **k)

    leaves = {f: getattr(params, f).detach().clone().requires_grad_(True)
              for f in GRAD_WRT}
    with torch.enable_grad():
        p = dataclasses.replace(params, **leaves)
        s = dataclasses.replace(E.init_state(params, device=dev),
                                p_ed=p.base_p_ed, p_es_belief=p.p_es)
        total = []
        for _ in range(GRAD_PERIODS):
            s, m = E._step(s, p)
            total.append(m.total_accuracy)
        value = torch.stack(total).sum()
        torch.cuda.synchronize()
        lp.kkt_vjp_ref = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                torch.autograd.grad(value, list(leaves.values()))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            lp.kkt_vjp_ref = real
    device_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA)
    kkt_us, kkt_calls = 0.0, 0
    for ev in prof.key_averages():
        if ev.key == "kkt_vjp":
            kkt_calls = ev.count
            kkt_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return dict(backward_seconds=wall, backward_device_seconds=device_us
                / 1e6, kkt_vjp_device_seconds=kkt_us / 1e6,
                kkt_vjp_calls=kkt_calls,
                kkt_vjp_share=kkt_us / device_us if device_us else None)


# --------------------------------------------------------------------------
# phases 7 and 8: the LM forward and the serving runtime
# --------------------------------------------------------------------------
# the flash forward of gemma3-1b against the same forward with the plain
# dense attention, on the card.  float32: both run their products in full
# float32 (TF32 off), so they differ by summation order over 26 layers.
# bfloat16: the flash kernel rounds p to bfloat16 against a running max
# per 32-key block, the dense path the normalised p; those roundings feed
# 26 residual layers of an untrained model whose runner-up logits are
# close.  Bounds on logits of scale ~1-5:
LM_F32_ATOL = 1e-3
LM_BF16_ATOL, LM_BF16_MEAN, LM_BF16_TOP1 = 0.5, 0.05, 0.9


def phase_lm_forward(torch, dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import forward, init_params, logits_from_h
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma3_1b")
    params = init_params(cfg, LM_SEED, device=dev)
    tokens = torch.as_tensor(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_SEQ, global_batch=LM_BATCH,
        seed=LM_SEED)).batch_at(0)["tokens"], device=dev)

    @torch.inference_mode()
    def run(c):
        return logits_from_h(params, forward(params, {"tokens": tokens}, c),
                             c)

    run(cfg)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = run(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention_fwd"] == cfg.num_layers,
          f"lm_forward: {launches['flash_attention_fwd']} flash launches "
          f"for {cfg.num_layers} layers")
    V = cfg.vocab_size
    check(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :V]).all()),
          f"lm_forward: bad logits {tuple(logits.shape)}")
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(cfg)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)

    device_s, n_launch, top = profiled(torch, lambda: run(cfg))
    emit("profile", path="lm_forward", device_seconds=device_s,
         wall_seconds=min(steady), busy_share=device_s / min(steady),
         n_kernel_launches=n_launch, top=top)

    def compare(a, b):
        d = (a[..., :V] - b[..., :V]).abs()
        top1 = (a[..., :V].argmax(-1) == b[..., :V].argmax(-1))
        return (d.max().item(), d.mean().item(), top1.float().mean().item())

    plain = run(dataclasses.replace(cfg, attn_impl="dense"))
    bf16 = compare(logits, plain)
    scale = logits[..., :V].abs().max().item()
    del logits, plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    flash32 = run(cfg32)
    f32 = compare(flash32, run(dataclasses.replace(cfg32, attn_impl="dense")))
    del flash32
    emit("lm_forward", model=cfg.name, params=cfg.param_count(),
         batch=LM_BATCH, seq=LM_SEQ, seconds=seconds, steady_seconds=steady,
         tokens_per_s=LM_BATCH * LM_SEQ / min(steady),
         peak_mem_bytes=peak, launches=launches,
         launches_per_forward=launches["flash_attention_fwd"],
         logit_scale=scale,
         bf16_vs_dense=dict(max_abs=bf16[0], mean_abs=bf16[1],
                            top1_agree=bf16[2]),
         f32_vs_dense=dict(max_abs=f32[0], mean_abs=f32[1],
                           top1_agree=f32[2]))
    check(f32[0] <= LM_F32_ATOL,
          f"lm_forward: float32 flash vs dense logits differ by {f32[0]}")
    check(bf16[0] <= LM_BF16_ATOL and bf16[1] <= LM_BF16_MEAN
          and bf16[2] >= LM_BF16_TOP1,
          f"lm_forward: bfloat16 flash vs dense logits (max, mean, top-1) "
          f"{bf16}")
    del params
    torch.cuda.empty_cache()


def phase_lm_serve(torch, dev):
    """The port's launcher on the paper_edge ladder; returns the flash
    launches of the run."""
    from repro_torch.launch import serve
    periods, fail = 6, 2
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = serve.main(["--periods", str(periods), "--n", "24",
                          "--fail-period", str(fail), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    check(len(history) == periods, "lm_serve: missing periods")
    for period, s in enumerate(history):
        emit("lm_serve", period=period, policy=s.policy,
             total_accuracy=s.total_accuracy,
             predicted_makespan=s.predicted_makespan,
             wall_makespan=s.wall_makespan, violation=s.violation,
             replanned=s.replanned, profile_updated=s.profile_updated,
             n_dropped=s.n_dropped, plan_seconds=s.plan_seconds)
        check(s.n_dropped == 0, f"lm_serve: period {period} dropped "
                                f"{s.n_dropped} jobs")
    check(history[fail].replanned,
          f"lm_serve: the ES outage of period {fail} was not replanned")
    check(launches["flash_attention_fwd"] > 0,
          "lm_serve: the flash kernel never launched")
    emit("lm_serve", periods=periods, jobs_per_period=24, seconds=seconds,
         launches=launches,
         flash_launches_per_period=launches["flash_attention_fwd"] / periods)
    return launches["flash_attention_fwd"]


# --------------------------------------------------------------------------
# the SSD scan and flash-decode kernels
# --------------------------------------------------------------------------
def ssd_exact(torch, x, dt, A, Bm, Cm, heads):
    """The SSD recurrence in float64 on the card, kernel layout: (y, final
    state)."""
    BH, S, P = x.shape
    Bb, _, N = Bm.shape
    xd = x.double().view(Bb, heads, S, P)
    dtd = dt.double().view(Bb, heads, S)
    Ad = A.double().view(Bb, heads)
    Bd, Cd = Bm.double(), Cm.double()
    h = torch.zeros((Bb, heads, P, N), dtype=torch.float64, device=x.device)
    ys = torch.empty((Bb, heads, S, P), dtype=torch.float64, device=x.device)
    for t in range(S):
        d = dtd[:, :, t]
        h = h * torch.exp(d * Ad)[..., None, None] \
            + (d[..., None, None] * xd[:, :, t, :, None]) \
            * Bd[:, None, t, None, :]
        ys[:, :, t] = torch.einsum("bhpn,bn->bhp", h, Cd[:, t])
    return ys.view(BH, S, P), h.view(BH, P, N)


def ssd_work(BH, Bb, S, P, N, itemsize):
    """Bytes and operations one `ssd_scan_fwd` call needs: x, B and C in
    their type, dt and A in float32 read once, y and the state written
    once in float32; 4 P N operations per (token, head) — the
    recurrence's state update and readout, a multiply and an add each.
    The kernels run their products on the tensor cores in TF32, so the
    operations are priced at the TF32 rate (`TF32_FLOPS`)."""
    nbytes = (itemsize * (BH * S * P + 2 * Bb * S * N) + 4 * (BH * S + BH)
              + 4 * (BH * S * P + BH * P * N))
    return nbytes, 4 * P * N * S * BH


def phase_ssd_kernel(torch, dev):
    """The SSD scan kernel against its plain version at mamba2-130m's
    shapes (8 x 2048 tokens, 24 heads, P 64, N 128, chunk 256), with dt and
    A at the model's initial scale (dt ~ softplus(0.3 N(0, 1)) ~ 0.7, A ~
    -exp(0.2 N(0, 1)) ~ -1), so a chunk's cumulative decay reaches ~-180:
    exp of the unselected upper triangle would overflow.  Both are held
    to the float64 recurrence: the kernel within 1e-5 + twice the plain
    version's own error, and within 1e-5 + three times it of the plain
    version (the kernels sum the decays in float64 where the plain
    version sums them in float32, and take their products on the tensor
    cores in split TF32).  Each row also gives the
    kernels one call launches and each one's device time (profiler) and
    CTAs per SM."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    H, P, N, Q = 24, 64, 128, 256
    Bb, S = SSM_BATCH, SSM_SEQ
    BH = Bb * H
    g = torch.Generator(device=dev).manual_seed(17)
    x32 = torch.randn((BH, S, P), generator=g, device=dev)
    dt = F.softplus(0.3 * torch.randn((BH, S), generator=g, device=dev))
    A = (-torch.exp(0.2 * torch.randn((H,), generator=g, device=dev)))[
        None].expand(Bb, H).reshape(BH, 1).contiguous()
    B32, C32 = (torch.randn((Bb, S, N), generator=g, device=dev)
                for _ in range(2))
    cum = torch.cumsum((dt * A).view(BH, S // Q, Q), dim=-1)
    min_cum = cum.min().item()
    check(min_cum < -88.0, f"ssd inputs never pass exp's overflow "
                           f"({min_cum})")
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        x, Bm, Cm = (t.to(dtype) for t in (x32, B32, C32))
        got = ssd_ops.ssd_scan_fwd(x, dt, A, Bm, Cm, heads=H, chunk=Q)
        want = ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, Q)
        exact = ssd_exact(torch, x, dt, A, Bm, Cm, H)
        torch.cuda.synchronize()
        errs = []
        for name, gv, wv, ev in zip(("y", "state"), got, want, exact):
            check(bool(torch.isfinite(gv).all()),
                  f"ssd_scan_fwd {dname}: {name} not finite")
            own = (wv.double() - ev).abs().max().item()
            err = (gv - wv).abs().max().item()
            err_exact = (gv.double() - ev).abs().max().item()
            check(err_exact <= 1e-5 + 2 * own and err <= 1e-5 + 3 * own,
                  f"ssd_scan_fwd {dname} {name}: {err} from the plain "
                  f"version, {err_exact} from float64 (plain's own {own})")
            errs.append(dict(out=name, max_abs_err=err,
                             bar_vs_plain=1e-5 + 3 * own,
                             err_vs_float64=err_exact,
                             bar_vs_float64=1e-5 + 2 * own,
                             plain_err_vs_float64=own,
                             scale=ev.abs().max().item()))
        del got, want, exact
        ms = cuda_ms(lambda: ssd_ops.ssd_scan_fwd(x, dt, A, Bm, Cm, heads=H,
                                                  chunk=Q), [()] * 10, torch)
        plain_ms = cuda_ms(lambda: ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm,
                                                           Q),
                           [()] * 3, torch)
        nbytes, flops = ssd_work(BH, Bb, S, P, N, x.element_size())
        bound_ms, bound_by = bound_of(nbytes, flops, TF32_FLOPS)
        _s, _n, per_kernel = profiled(torch, lambda: ssd_ops.ssd_scan_fwd(
            x, dt, A, Bm, Cm, heads=H, chunk=Q))
        launched = sum(d["calls"] for d in per_kernel
                       if "ssd_" in d["name"])
        check(launched == ssd_ops.KERNELS_PER_CALL,
              f"ssd_scan_fwd {dname}: one call launched {launched} kernels")
        occupancy = ssd_ops.occupancy(dtype == torch.bfloat16)
        check(all(blocks >= 2 for _smem, blocks in occupancy.values()),
              f"ssd_scan_fwd {dname}: a kernel fits fewer than two CTAs "
              f"per SM: {occupancy}")
        row = dict(max_abs_err=errs[0]["max_abs_err"], ms=ms,
                   plain_ms=plain_ms, library_ms=None, bytes=nbytes,
                   flops=flops, bound_ms=bound_ms, bound_by=bound_by)
        emit("kernels", kernel="ssd_scan_fwd", dtype=dname,
             dims=dict(BH=BH, B=Bb, S=S, P=P, N=N, Q=Q),
             min_chunk_cum=min_cum, errors=errs,
             kernels_per_call=ssd_ops.KERNELS_PER_CALL,
             device_us_by_kernel={d["name"]: d["ms"] * 1e3 for d in
                                  per_kernel},
             smem_and_ctas_per_sm=occupancy, **row)
        rows[dname] = row
        del x, Bm, Cm
    return rows


def decode_work(rows, G, D, n_valid, itemsize, W, kv_itemsize=None):
    """Bytes and operations one flash-decode call needs: q read and o
    written once (``itemsize`` each), the K and V rows of the valid slots
    read once (``kv_itemsize``, by default q's), the validity mask (int32)
    read once; 4 D operations (q.k and p.v) per (q head, valid slot)."""
    kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
    nbytes = (itemsize * 2 * rows * G * D + kv_itemsize * 2 * n_valid * D
              + 4 * rows * W)
    return nbytes, 4 * D * G * n_valid


def phase_decode_kernel(torch, dev):
    """The flash-decode kernel through the model's entry
    (`decode_attention`, the caches read in place) against its plain
    version at the generation runs' decode shapes (`DECODE_SHAPES`): 4
    sequences, 1 KV head, head_dim 256; gemma3-1b's 4 q heads decoding
    position 1016 from a local ring of 512 slots (window 512, all slots
    live) and a global one of max_seq = 1032 slots (1017 live), and
    recurrentgemma-9b's 16 q heads decoding position 2116 from a local
    ring of 2048 slots (window 2048, all live); in bfloat16 and float32
    (float32 to 1e-5, bfloat16 to 2^-7 relative and absolute).  Then the
    LM families' shapes (`FAMILY_DECODE_SHAPES`: 8 KV heads of head_dim
    128, internvl2's float8_e4m3fn cache at group 8, groups 6 and 7 in
    bfloat16).  The library column is `scaled_dot_product_attention` of
    (B, H, 1, D) against the KV expanded to the H heads with the boolean
    validity mask; a float8 cache has no such call (SDPA takes no float8
    K/V): its row gives SDPA on the cache widened to bfloat16 beforehand
    as ``library_widened_ms`` and ``library_ms`` null."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B = GEN_BATCH
    g = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    cases = [(name, W, window, 1, G, 256, index, dt, dt)
             for name, W, window, G, index in DECODE_SHAPES
             for dt in ("bfloat16", "float32")] + list(FAMILY_DECODE_SHAPES)
    for name, W, window, KH, G, D, index, dname, kvname in cases:
        dtype, kvdt = getattr(torch, dname), getattr(torch, kvname)
        fp8 = kvdt == torch.float8_e4m3fn
        H = KH * G
        ok = da_ref.ring_validity(W, index, window, device=dev)
        valid = ok[None].expand(B * KH, W).contiguous()
        n_valid = int(valid.sum())
        q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dtype)
        ck, cv = (torch.randn((B, W, KH, D), generator=g,
                              device=dev).to(kvdt) for _ in range(2))
        got = da_ops.decode_attention(q, ck, cv, index, window=window)
        qg = da_ops.grouped_rows(q, KH)

        def flat(c):                    # (B, W, KH, D) -> (B·KH, W, D)
            b = c.view(torch.uint8) if fp8 else c
            return b.transpose(1, 2).reshape(B * KH, W, D).view(c.dtype)

        kf, vf = flat(ck), flat(cv)
        want = da_ref.decode_attention_ref(qg, kf, vf, valid)
        torch.cuda.synchronize()
        err = (got.reshape(want.shape).float()
               - want.float()).abs().max().item()
        rtol, atol = ((0.0, 1e-5) if dtype == torch.float32
                      else (2.0 ** -7, 2.0 ** -7))
        check(torch.allclose(got.reshape(want.shape).float(),
                             want.float(), rtol=rtol, atol=atol),
              f"decode_attention_fwd {name} {dname}/{kvname} disagrees "
              f"with its plain version (max {err})")
        ms = cuda_ms(lambda: da_ops.decode_attention(
            q, ck, cv, index, window=window), [()] * 50, torch,
            warm_up=True)
        plain_ms = cuda_ms(lambda: da_ref.decode_attention_ref(
            qg, kf, vf, valid), [()] * 10, torch)
        qq = q.transpose(1, 2)                              # (B, H, 1, D)
        kk, vv = ((c.to(dtype).transpose(1, 2).expand(B, H, W, D) if KH == 1
                   else c.to(dtype).transpose(1, 2).repeat_interleave(
                       G, dim=1)) for c in (ck, cv))
        mask = (ok != 0).view(1, 1, 1, W).expand(B, H, 1, W)

        def library():
            return sdpa(qq, kk, vv, attn_mask=mask)

        lib_err = (library().transpose(1, 2).float()
                   - got.float()).abs().max().item()
        library_ms = cuda_ms(library, [()] * 50, torch, warm_up=True)
        nbytes, flops = decode_work(B * KH, G, D, n_valid,
                                    q.element_size(), W, ck.element_size())
        bound_ms, bound_by = bound_of(
            nbytes, flops,
            BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None if fp8 else library_ms,
                   library_max_abs_err=lib_err,
                   bytes=nbytes, flops=flops, bound_ms=bound_ms,
                   bound_by=bound_by, tflops=flops / ms * 1e-9,
                   bound_share=bound_ms / ms)
        if fp8:
            row["library_widened_ms"] = library_ms
        emit("kernels", kernel="decode_attention_fwd", shape=name,
             dtype=dname, kv_dtype=kvname,
             dims=dict(B=B, W=W, KH=KH, G=G, D=D, index=index,
                       window=window, live=n_valid // (B * KH),
                       splits=list(da_ops.splits(B * KH, W,
                                                 da_ops.sm_count(dev)))),
             **row)
        rows[(name, dname)] = row
        del q, ck, cv, kk, vv, kf, vf, want, got
    phase_fp8_cast(torch, dev)
    return rows


def phase_fp8_cast(torch, dev):
    """The float8_e4m3fn KV cast (`layers.cast_kv`) on the card against
    the same on the CPU, byte for byte, over all 65,536 bfloat16 bit
    patterns (NaN past the range, where `Tensor.to` saturates) and a
    million float32 values spanning the format's range."""
    from repro_torch.models.layers import cast_kv
    fp8 = torch.float8_e4m3fn
    pats = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    g = torch.Generator().manual_seed(8)
    f32 = torch.randn(1 << 20, generator=g) * torch.exp2(
        torch.randint(-12, 10, (1 << 20,), generator=g).float())
    out = {}
    for what, x in (("bfloat16_patterns", pats), ("float32", f32)):
        host = cast_kv(x, fp8).view(torch.uint8)
        card = cast_kv(x.to(dev), fp8).view(torch.uint8).cpu()
        diff = int((host != card).sum())
        nan = int(torch.isnan(host.view(fp8).float()).sum())
        out[what] = dict(n=x.numel(), differ=diff, nan=nan)
        check(diff == 0, f"fp8_cast {what}: {diff} bytes differ between "
                         f"the card and the CPU")
    emit("kernels", check="fp8_cast", **out)


# --------------------------------------------------------------------------
# the RG-LRU recurrence kernel
# --------------------------------------------------------------------------
def rglru_inputs(torch, dev, g, B, S, W, slow):
    """(a, b) of the recurrence.  Unless ``slow``, as recurrentgemma-9b's
    RG-LRU layer makes them at its initial scale: its gates
    (`layers._rglru_gates`, block-diagonal over the config's 16 heads) on
    a standard normal conv output, the gate weights and ``a_param`` drawn
    as `init_params` draws those leaves stacked over the 12 cycles (N(0, 1)
    / sqrt(fan_in)), so a ~ exp(-2.8).  With ``slow``, a uniform in (0.9,
    1) and b standard normal, so a value is carried over tens of steps."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.models import layers
    if slow:
        a = 0.9 + 0.1 * torch.rand((B, S, W), generator=g, device=dev)
        return a, torch.randn((B, S, W), generator=g, device=dev)
    cfg = get_config(RG_ARCH)
    H, cycles = cfg.num_heads, cfg.cycles_and_tail[0]
    bw = W // H
    p = {name: torch.randn((H, bw, bw), generator=g, device=dev)
         / math.sqrt(cycles * H * bw) for name in ("gate_a", "gate_x")}
    p["a_param"] = torch.randn((W,), generator=g, device=dev) \
        / math.sqrt(cycles)
    u = torch.randn((B, S, W), generator=g, device=dev)
    return layers._rglru_gates(p, u)


def rglru_copies(torch, a, b, reps):
    """``reps`` argument tuples for timed calls of the recurrence, cycling
    over copies of (a, b) that together exceed twice the card's 50 MB L2,
    so that every call reads its inputs from device memory."""
    per_call = 3 * a.numel() * a.element_size()
    n = max(1, -(-2 * L2_BYTES // per_call))
    copies = [(a, b)] + [(a.clone(), b.clone()) for _ in range(n - 1)]
    return [copies[i % n] for i in range(reps)]


def phase_rglru_kernel(torch, dev):
    """The RG-LRU recurrence kernel at `RGLRU_SHAPES` in the geometry
    `ops.launch_geometry` picks, against its plain log-step scan, its own
    order recomputed (`ref.rglru_tiled_ref`, one rounding a step) and the
    recurrence in float64: every pair within 1e-5 max(1, max |h|) (the
    recurrence is contractive, 0 < a < 1), the kernel's distance from its
    own order also as a share of that.  Kernel times by CUDA events queued
    behind a device sleep (the device's time) and not (the host's launch
    rate may set it), inputs read from device memory (`rglru_copies`);
    the bound is 12 bytes per (token, channel).  Then every compiled
    instance (C, L, stages) at each shape, timed queued and held to the
    plain version: the measurements behind `ops.TILES`.  No single
    PyTorch call computes a linear recurrence, so the library column is
    null."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    g = torch.Generator(device=dev).manual_seed(29)
    rows = {}
    for name, B, S, W, slow in RGLRU_SHAPES:
        a, b = rglru_inputs(torch, dev, g, B, S, W, slow)
        a_range = [a.min().item(), a.max().item()]
        check(0.0 < a_range[0] and a_range[1] < 1.0,
              f"rglru {name}: a outside (0, 1): {a_range}")
        geo = rg_ops.launch_geometry(B, S, W)
        got = rg_ops.rglru_scan_fwd(a, b)
        want = rg_ref.rglru_scan_ref(a, b)
        tiled = rg_ref.rglru_tiled_ref(a, b, tile=geo.steps, split=geo.split)
        exact = rg_ref.rglru_sequential_ref(a, b)
        torch.cuda.synchronize()
        scale = exact.abs().max().item()
        tol = 1e-5 * max(1.0, scale)
        err = (got - want).abs().max().item()
        err_exact = (got.double() - exact).abs().max().item()
        own = (want.double() - exact).abs().max().item()
        err_tiled = (got - tiled).abs().max().item()
        tiled_exact = (tiled.double() - exact).abs().max().item()
        check(bool(torch.isfinite(got).all())
              and max(err, err_exact, own, err_tiled, tiled_exact) <= tol,
              f"rglru_scan_fwd {name}: {err} from the plain version, "
              f"{err_exact} from float64, {err_tiled} from its own order "
              f"(plain's own {own}, the order's {tiled_exact}; bound {tol})")
        del got, tiled, exact
        ms, ms_unqueued = both_ms(
            torch, lambda a, b: rg_ops.rglru_scan_fwd(a, b),
            lambda: rglru_copies(torch, a, b, 20))
        plain_ms = cuda_ms(lambda: rg_ref.rglru_scan_ref(a, b), [()] * 3,
                           torch)
        # a and b read once, h written once (float32); an FMA per element
        nbytes, flops = 12 * B * S * W, 2 * B * S * W
        bound_ms, bound_by = bound_of(nbytes, flops, FP32_FLOPS)
        row = dict(max_abs_err=err, err_vs_float64=err_exact,
                   plain_err_vs_float64=own, err_vs_own_order=err_tiled,
                   own_order_share_of_bound=err_tiled / tol, scale=scale,
                   ms=ms, ms_unqueued=ms_unqueued, plain_ms=plain_ms,
                   library_ms=None,
                   library_note="no single PyTorch call computes a linear "
                                "recurrence",
                   bytes=nbytes, flops=flops, bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / ms)
        emit("kernels", kernel="rglru_scan_fwd", shape=name,
             dims=dict(B=B, S=S, W=W), a_range=a_range,
             geometry=dict(geo._asdict(), **rg_ops.occupancy(geo)), **row)
        rows[name] = row
        emit("kernels", kernel="rglru_scan_fwd", shape=name,
             instances=rglru_instances(torch, rg_ops, a, b, want, tol,
                                       bound_ms))
        del a, b, want
    return rows


def rglru_instances(torch, rg_ops, a, b, want, tol, bound_ms):
    """Every compiled instance of the recurrence kernel on (a, b): its
    geometry, CTAs per SM, time queued behind a device sleep and bound
    share, each held to the plain version's ``want`` within ``tol``."""
    B, S, W = a.shape
    out = []
    for inst in rg_ops.INSTANCES:
        geo = rg_ops.geometry_of(B, W, *inst)
        got = rg_ops.rglru_scan_fwd(a, b, geometry=geo)
        err = (got - want).abs().max().item()
        check(err <= tol, f"rglru_scan_fwd instance {inst}: {err} from the "
                          f"plain version (bound {tol})")
        del got
        ms = cuda_ms(lambda a, b: rg_ops.rglru_scan_fwd(a, b, geometry=geo),
                     rglru_copies(torch, a, b, 20), torch, ahead=True)
        out.append(dict(C=geo.channels, L=geo.steps, stages=geo.stages,
                        ctas=geo.ctas, **rg_ops.occupancy(geo), ms=ms,
                        bound_share=bound_ms / ms, max_abs_err=err))
    return out


# --------------------------------------------------------------------------
# mamba2-130m's forward and the generation path
# --------------------------------------------------------------------------
# mamba2-130m's forward through the SSD kernel against the same forward on
# the plain chunked path (impl="jnp") on the card.  float32: both run the
# chunked form in float32 and differ by how each sums a chunk's decays
# (|cum| ~180 at Q = 256; the kernels in float64) over 24 layers.
# bfloat16: those differences flip roundings of the bfloat16 activations.
# Bounds on logits of scale ~1-5:
SSM_F32_ATOL = 2e-3
# generation: prefill + decode logits against `forward` of the whole
# sequence at the same positions.  float32 (with a float32 KV cache):
# other kernels (flash-decode, the SSD recurrence in decode_step) on the
# same arithmetic; bfloat16: other rounding points of the activations
GEN_F32_ATOL = 2e-3
GEN_BF16_ATOL, GEN_BF16_MEAN, GEN_BF16_TOP1 = 0.5, 0.05, 0.9


def compare_logits(a, b, V):
    """(max |a - b|, mean |a - b|, top-1 agreement) over the vocabulary."""
    d = (a[..., :V] - b[..., :V]).abs()
    top1 = (a[..., :V].argmax(-1) == b[..., :V].argmax(-1))
    return d.max().item(), d.mean().item(), top1.float().mean().item()


def check_bf16(what, cmp):
    check(cmp[0] <= GEN_BF16_ATOL and cmp[1] <= GEN_BF16_MEAN
          and cmp[2] >= GEN_BF16_TOP1,
          f"{what}: bfloat16 logits (max, mean, top-1) {cmp}")


def lm_tokens(torch, dev, cfg, batch, seq):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    return torch.as_tensor(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=LM_SEED)).batch_at(0)["tokens"], device=dev)


def phase_lm_forward_ssm(torch, dev):
    """mamba2-130m at full width and depth (24 SSD layers, d 768, d_inner
    1536, vocabulary 50280), random weights from a seed, 8 requests of
    2048 `TokenPipeline` tokens, bfloat16: 24 SSD kernel launches a
    forward, tokens/s and peak memory, then the logits against the plain
    chunked path (impl="jnp") in bfloat16 and float32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, logits_from_h
    cfg = get_config("mamba2_130m")
    params = init_params(cfg, LM_SEED, device=dev)
    tokens = lm_tokens(torch, dev, cfg, SSM_BATCH, SSM_SEQ)

    @torch.inference_mode()
    def run(c, impl="pallas"):
        h = forward(params, {"tokens": tokens}, c, impl=impl)
        return logits_from_h(params, h, c)

    run(cfg)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = run(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches["ssd_scan_fwd"] == cfg.num_layers,
          f"lm_forward mamba2: {launches['ssd_scan_fwd']} SSD launches for "
          f"{cfg.num_layers} layers")
    V = cfg.vocab_size
    check(tuple(logits.shape) == (SSM_BATCH, SSM_SEQ, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :V]).all()),
          f"lm_forward mamba2: bad logits {tuple(logits.shape)}")
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(cfg)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    device_s, n_launch, top = profiled(torch, lambda: run(cfg))
    emit("profile", path="lm_forward mamba2", device_seconds=device_s,
         wall_seconds=min(steady), busy_share=device_s / min(steady),
         n_kernel_launches=n_launch, top=top)
    bf16 = compare_logits(logits, run(cfg, "jnp"), V)
    scale = logits[..., :V].abs().max().item()
    del logits
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32 = compare_logits(run(cfg32), run(cfg32, "jnp"), V)
    emit("lm_forward", model=cfg.name, params=cfg.param_count(),
         batch=SSM_BATCH, seq=SSM_SEQ, seconds=seconds,
         steady_seconds=steady,
         tokens_per_s=SSM_BATCH * SSM_SEQ / min(steady),
         peak_mem_bytes=peak, launches=launches,
         launches_per_forward=launches["ssd_scan_fwd"], logit_scale=scale,
         bf16_vs_jnp=dict(max_abs=bf16[0], mean_abs=bf16[1],
                          top1_agree=bf16[2]),
         f32_vs_jnp=dict(max_abs=f32[0], mean_abs=f32[1],
                         top1_agree=f32[2]))
    check(f32[0] <= SSM_F32_ATOL,
          f"lm_forward mamba2: float32 kernel vs jnp logits differ by "
          f"{f32[0]}")
    check_bf16("lm_forward mamba2 vs jnp", bf16)
    del params
    torch.cuda.empty_cache()


# recurrentgemma-9b's forward through the RG-LRU and flash kernels against
# the plain path (the log-step scan, dense attention) on the card.
# float32: the same products in full float32 (TF32 off), the recurrence and
# attention summed in other orders over 38 layers; bfloat16: those
# differences flip roundings of the bfloat16 activations, as in gemma3-1b's
# forward.  Bounds on logits of scale ~1-5: `LM_F32_ATOL` and `LM_BF16_*`.


def expected_launches(cfg):
    """{kernel: launches} of one forward or prefill of ``cfg``: one per
    layer of each mixer that has a kernel."""
    mixers = [cfg.layer_kind(i)[0] for i in range(cfg.num_layers)]
    want = {"rglru_scan_fwd": mixers.count("rglru"),
            "ssd_scan_fwd": mixers.count("ssd")}
    want["flash_attention_fwd"] = (cfg.num_layers - want["rglru_scan_fwd"]
                                   - want["ssd_scan_fwd"])
    return {k: v for k, v in want.items() if v}


def compare_sliced(torch, params, cfg, ha, hb, rows=1024):
    """`compare_logits` of the logits of the hidden states ``ha`` and
    ``hb`` (B, S, D), ``rows`` positions at a time, so that no more than
    one slice of each float32 logit tensor lives at once; also the larger
    |logit| of ``ha``."""
    from repro_torch.models import logits_from_h
    V = cfg.vocab_size
    fa, fb = ha.reshape(-1, ha.shape[-1]), hb.reshape(-1, hb.shape[-1])
    dmax = dsum = scale = 0.0
    same = 0
    for i in range(0, fa.shape[0], rows):
        la = logits_from_h(params, fa[i:i + rows], cfg)[:, :V]
        lb = logits_from_h(params, fb[i:i + rows], cfg)[:, :V]
        d = (la - lb).abs()
        dmax = max(dmax, d.max().item())
        dsum += d.double().sum().item()
        same += int((la.argmax(-1) == lb.argmax(-1)).sum())
        scale = max(scale, la.abs().max().item())
        del la, lb, d
    n = fa.shape[0]
    return (dmax, dsum / (n * V), same / n), scale


def phase_lm_forward_rg(torch, dev, params):
    """recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU and
    12 local-attention layers of window 2048, d 4096, 16 q heads on 1 KV
    head of head_dim 256, vocabulary 256000), random weights from a seed,
    2 requests of 4096 `TokenPipeline` tokens, bfloat16: exactly 26
    RG-LRU and 12 flash launches a forward, tokens/s, peak memory and a
    profile; then the hidden states and every logit (in slices) against
    the plain path (``impl="jnp"``, ``attn_impl="dense"``) in bfloat16
    and float32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import forward, logits_from_h
    t_phase = time.perf_counter()
    cfg = get_config(RG_ARCH)
    tokens = lm_tokens(torch, dev, cfg, RG_BATCH, RG_SEQ)

    @torch.inference_mode()
    def run(c, impl="pallas"):
        return forward(params, {"tokens": tokens}, c, impl=impl)

    @torch.inference_mode()
    def run_logits():
        return logits_from_h(params, run(cfg), cfg)

    run_logits()                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = run_logits()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in kernel_launches().items() if v}
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg)
    check(launches == want == {"rglru_scan_fwd": 26,
                               "flash_attention_fwd": 12},
          f"lm_forward recurrentgemma: launches {launches}, expected "
          f"{want}")
    V = cfg.vocab_size
    check(tuple(logits.shape) == (RG_BATCH, RG_SEQ, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :V]).all()),
          f"lm_forward recurrentgemma: bad logits {tuple(logits.shape)}")
    del logits
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_logits()
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    device_s, n_launch, top = profiled(torch, run_logits,
                                       keep=("rglru_scan_kernel",))
    emit("profile", path="lm_forward recurrentgemma",
         device_seconds=device_s, wall_seconds=min(steady),
         busy_share=device_s / min(steady), n_kernel_launches=n_launch,
         top=top)
    out = {}
    for dname in ("bfloat16", "float32"):
        c = cfg if dname == "bfloat16" else dataclasses.replace(
            cfg, dtype="float32")
        hk = run(c)
        hp = run(dataclasses.replace(c, attn_impl="dense"), "jnp")
        h_err = (hk.float() - hp.float()).abs().max().item()
        with torch.inference_mode():
            cmp, scale = compare_sliced(torch, params, c, hk, hp)
        del hk, hp
        out[dname] = dict(max_abs=cmp[0], mean_abs=cmp[1], top1_agree=cmp[2],
                          hidden_max_abs=h_err, logit_scale=scale)
    emit("lm_forward", model=cfg.name, params=cfg.param_count(),
         batch=RG_BATCH, seq=RG_SEQ, seconds=seconds, steady_seconds=steady,
         tokens_per_s=RG_BATCH * RG_SEQ / min(steady),
         peak_mem_bytes=peak, launches=launches,
         bf16_vs_plain=out["bfloat16"], f32_vs_plain=out["float32"],
         phase_seconds=time.perf_counter() - t_phase)
    f32, bf16 = out["float32"], out["bfloat16"]
    check(f32["max_abs"] <= LM_F32_ATOL,
          f"lm_forward recurrentgemma: float32 kernel vs plain logits "
          f"differ by {f32['max_abs']}")
    check(bf16["max_abs"] <= LM_BF16_ATOL and bf16["mean_abs"] <= LM_BF16_MEAN
          and bf16["top1_agree"] >= LM_BF16_TOP1,
          f"lm_forward recurrentgemma: bfloat16 kernel vs plain logits "
          f"{bf16}")


def phase_recurrentgemma(torch, dev):
    """recurrentgemma-9b's parameters on the card from a seed (38.5 GB in
    float32), its forward (`phase_lm_forward_rg`) and its generation
    (`phase_lm_generate`: prompts of 2100 tokens, max_seq 2132); returns
    the generation's bfloat16 launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(get_config(RG_ARCH), LM_SEED, device=dev)
    torch.cuda.synchronize()
    emit("lm_init", model=RG_ARCH, seconds=time.perf_counter() - t0,
         param_bytes=torch.cuda.memory_allocated() - before)
    phase_lm_forward_rg(torch, dev, params)
    launches = phase_lm_generate(torch, dev, RG_ARCH, params=params,
                                 n_prompt=RG_PROMPT)
    del params
    torch.cuda.empty_cache()
    return launches


def cache_leaves(cache):
    """{path: (shape, dtype)} of a cache's tensors."""
    out = {}
    for part in ("blocks", "tail"):
        for i, d in enumerate(cache[part]):
            for name, t in d.items():
                out[f"{part}/{i}/{name}"] = (tuple(t.shape), t.dtype)
    return out


def phase_lm_generate(torch, dev, arch, params=None, n_prompt=GEN_PROMPT):
    """``arch`` at full width and depth, random weights from a seed (or
    ``params``): `init_cache`, then `prefill` of 4 prompts of ``n_prompt``
    `TokenPipeline` tokens (max_seq ``n_prompt`` + 32) and 32 `decode_step`
    calls fed the next 32 tokens of the same stream, in bfloat16 and in
    float32 (float32 KV cache).  Prints prefill and decode tokens/s and
    peak memory; checks the launch counts (in prefill one flash, SSD or
    RG-LRU launch per layer of that mixer; in decode one flash-decode
    launch per attention layer and step, nothing else) and every logit
    against `forward` of all ``n_prompt`` + 32 tokens at the same
    position.
    Returns the bfloat16 run's launches (prefill and decode together)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, logits_from_h, prefill)
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    own = params is None
    if own:
        params = init_params(cfg, LM_SEED, device=dev)
    max_seq = n_prompt + GEN_STEPS
    tokens = lm_tokens(torch, dev, cfg, GEN_BATCH, max_seq)
    prompt = {"tokens": tokens[:, :n_prompt]}
    want_pre = expected_launches(cfg)
    n_attn = want_pre.get("flash_attention_fwd", 0)
    want_dec = ({"decode_attention_fwd": n_attn * GEN_STEPS} if n_attn
                else {})
    V = cfg.vocab_size
    out = {}
    for dname in ("bfloat16", "float32"):
        c = cfg if dname == "bfloat16" else dataclasses.replace(
            cfg, dtype="float32", kv_cache_dtype="float32")
        with torch.inference_mode():
            warm, _ = prefill(params, prompt, c, max_seq)
            decode_step(params, tokens[:, n_prompt:n_prompt + 1], warm, c)
            del warm
            empty = init_cache(c, GEN_BATCH, max_seq, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            cache, lg = prefill(params, prompt, c, max_seq)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            pre = {k: v for k, v in kernel_launches().items() if v}
            reset_launches()
            got, walls = [lg], []
            t_all = time.perf_counter()
            for t in range(GEN_STEPS):
                t0 = time.perf_counter()
                lg, cache = decode_step(
                    params, tokens[:, n_prompt + t:n_prompt + t + 1], cache,
                    c)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                got.append(lg)
            t_decode = time.perf_counter() - t_all
            dec = {k: v for k, v in kernel_launches().items() if v}
            peak = torch.cuda.max_memory_allocated()
            check(cache_leaves(empty) == cache_leaves(cache),
                  f"lm_generate {arch}: init_cache and prefill disagree on "
                  f"the cache layout")
            check(cache["index"] == max_seq,
                  f"lm_generate {arch}: index {cache['index']}")
            check(pre == want_pre and dec == want_dec,
                  f"lm_generate {arch} {dname}: launches prefill {pre}, "
                  f"decode {dec}; expected {want_pre}, {want_dec}")
            h = forward(params, {"tokens": tokens}, c)
            ref = logits_from_h(params, h[:, n_prompt - 1:], c)
            del h
            got = torch.cat(got, dim=1)
            check(bool(torch.isfinite(got[..., :V]).all()),
                  f"lm_generate {arch} {dname}: logits not finite")
            cmp = compare_logits(got, ref, V)
            if arch in ("gemma3_1b", RG_ARCH) and dname == "bfloat16":
                device_s, n_launch, top = profiled(torch, lambda: (
                    decode_step(params, tokens[:, -1:], cache, c)))
                emit("profile", path=f"lm_generate {cfg.name} decode_step",
                     device_seconds=device_s, wall_seconds=min(walls),
                     busy_share=device_s / min(walls),
                     n_kernel_launches=n_launch, top=top)
            del cache, empty, got, ref
        emit("lm_generate", model=cfg.name, dtype=dname, batch=GEN_BATCH,
             prompt=n_prompt, steps=GEN_STEPS, max_seq=max_seq,
             prefill_seconds=t_prefill,
             prefill_tokens_per_s=GEN_BATCH * n_prompt / t_prefill,
             decode_seconds=t_decode,
             decode_tokens_per_s=GEN_BATCH * GEN_STEPS / t_decode,
             step_ms=dict(first=walls[0] * 1e3,
                          median=sorted(walls)[GEN_STEPS // 2] * 1e3,
                          min=min(walls) * 1e3),
             peak_mem_bytes=peak, launches_prefill=pre,
             launches_decode=dec,
             vs_forward=dict(max_abs=cmp[0], mean_abs=cmp[1],
                             top1_agree=cmp[2]))
        if dname == "float32":
            check(cmp[0] <= GEN_F32_ATOL,
                  f"lm_generate {arch}: float32 logits differ from the "
                  f"forward's by {cmp[0]}")
        else:
            check_bf16(f"lm_generate {arch} vs forward", cmp)
            out = {k: pre.get(k, 0) + dec.get(k, 0)
                   for k in set(pre) | set(dec)}
    emit("lm_generate", model=cfg.name,
         phase_seconds=time.perf_counter() - t_phase)
    if own:
        del params
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the other LM families at full width
# --------------------------------------------------------------------------
# (arch, layers kept (None: all), forward requests x tokens, generation
# requests x prompt tokens (None: no generation run)).  h2o-danube's 8192
# tokens cross its window of 4096 and its 4200-token prompt wraps the
# 4096-slot rings; whisper decodes 448 tokens (its context) against 1500
# encoder frames; internvl2's generation reads its float8 cache.
FAMILIES = (
    ("granite_moe_1b_a400m", None, (2, 2048), (4, 1000)),
    ("granite_moe_3b_a800m", None, (2, 2048), None),
    ("h2o_danube_1_8b", None, (1, 8192), (1, 4200)),
    ("internlm2_20b", 8, (2, 2048), None),
    ("deepseek_coder_33b", 8, (2, 2048), None),
    ("whisper_base", None, (8, 448), (4, 64)),
    ("internvl2_76b", 4, (2, 2048), (4, 1000)),
)
CARD_BYTES = 80e9
# internvl2's float8 cache against the same generation with a bfloat16
# cache: the reference's own bar for its float8 cache against a forward
# (`tests/test_archs.py`: 0.6, "fp8 KV quantisation noise")
FP8_KV_ATOL = 0.6


def family_flash(cfg):
    """Flash launches of one forward or prefill: one per decoder layer,
    and an encoder-decoder's encoder layers and cross-attentions."""
    cross = cfg.num_layers if cfg.is_encdec else 0
    return cfg.num_layers + cfg.encoder_layers + cross


def family_inputs(torch, dev, cfg, batch, seq, seed):
    """`TokenPipeline` tokens and, where the model takes them, random
    patch or frame embeddings (float32, from a seed, on the card)."""
    b = {"tokens": lm_tokens(torch, dev, cfg, batch, seq)}
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.num_patches:
        b["patch_embeds"] = torch.randn((batch, cfg.num_patches,
                                         cfg.d_model), generator=g,
                                        device=dev)
    if cfg.is_encdec:
        b["audio_feats"] = torch.randn((batch, cfg.encoder_seq,
                                        cfg.d_model), generator=g,
                                       device=dev)
    return b


def phase_lm_families(torch, dev):
    """The other LM families (`FAMILIES`) at full width from a seed,
    float32 parameters and bfloat16 compute; a depth is cut where the
    float32 parameters of every layer do not fit the card, and the cut is
    printed with that size.  Each: `init_params`, a forward (flash
    launches counted from 0: `family_flash` per forward, nothing else),
    tokens/s (the best of three), peak memory, its logits against the
    same forward with `attn_impl="dense"` (`LM_BF16_*`) and a profile
    of it; four of them also generate (`family_generate`).  Prints the
    phase's seconds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, logits_from_h
    t_phase = time.perf_counter()
    for arch, keep, (fb, fs), gen in FAMILIES:
        full = get_config(arch)
        cfg = full if keep is None else dataclasses.replace(full,
                                                            num_layers=keep)
        cut = None if keep is None else dict(
            layers=keep, of=full.num_layers,
            reason=f"{full.param_count() * 4 / 1e9:.1f} GB of float32 "
                   f"parameters at {full.num_layers} layers do not fit "
                   f"one {CARD_BYTES / 1e9:.0f} GB card")
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = init_params(cfg, LM_SEED, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_bytes = torch.cuda.memory_allocated() - before
        batch = family_inputs(torch, dev, cfg, fb, fs, LM_SEED)

        @torch.inference_mode()
        def run(c):
            return logits_from_h(params, forward(params, batch, c), c)

        run(cfg)                                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits = run(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernel_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_attention_fwd": family_flash(cfg)}
        check(launches == want, f"lm_families {arch}: launches {launches}, "
                                f"expected {want}")
        V = cfg.vocab_size
        check(tuple(logits.shape) == (fb, fs, cfg.padded_vocab)
              and bool(torch.isfinite(logits[..., :V]).all()),
              f"lm_families {arch}: bad logits {tuple(logits.shape)}")
        steady = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(cfg)
            torch.cuda.synchronize()
            steady.append(time.perf_counter() - t0)
        device_s, n_launch, top = profiled(torch, lambda: run(cfg),
                                           keep=("flash_tc_kernel",))
        emit("profile", path=f"lm_families {cfg.name} forward",
             device_seconds=device_s, wall_seconds=min(steady),
             busy_share=device_s / min(steady), n_kernel_launches=n_launch,
             top=top)
        plain = run(dataclasses.replace(cfg, attn_impl="dense"))
        cmp = compare_logits(logits, plain, V)
        scale = logits[..., :V].abs().max().item()
        del logits, plain
        row = dict(model=cfg.name, family=cfg.family,
                   params=cfg.param_count(),
                   active_params=cfg.active_param_count(),
                   layers=cfg.num_layers, depth_cut=cut,
                   param_bytes=param_bytes, init_seconds=init_s,
                   batch=fb, seq=fs, seconds=seconds, steady_seconds=steady,
                   tokens_per_s=fb * fs / min(steady), peak_mem_bytes=peak,
                   launches_per_forward=launches, logit_scale=scale,
                   bf16_vs_dense=dict(max_abs=cmp[0], mean_abs=cmp[1],
                                      top1_agree=cmp[2]))
        emit("lm_families", **row)
        check(cmp[0] <= LM_BF16_ATOL and cmp[1] <= LM_BF16_MEAN
              and cmp[2] >= LM_BF16_TOP1,
              f"lm_families {arch}: bfloat16 flash vs dense logits (max, "
              f"mean, top-1) {cmp}")
        if gen is not None:
            family_generate(torch, dev, cfg, params, *gen)
        del params, batch
        torch.cuda.empty_cache()
    emit("lm_families", phase_seconds=time.perf_counter() - t_phase)


def family_generate(torch, dev, cfg, params, n_seq, n_prompt):
    """`prefill` of ``n_seq`` prompts of ``n_prompt`` tokens (max_seq
    ``n_prompt`` + 32) and 32 teacher-forced `decode_step` calls, in the
    model's KV cache type and, for a float8 cache, again with a bfloat16
    one.  Launch counts from 0 (prefill: `family_flash`; a step: one
    flash-decode per layer, and an encoder-decoder's cross-attention
    flash per layer); the bfloat16-cache logits against `forward` of all
    tokens at the same positions (`GEN_BF16_*`), the float8-cache logits
    against the bfloat16-cache ones (`FP8_KV_ATOL`); a profile of one
    more step in the model's cache type.  A MoE model runs
    with ``capacity_factor=8``, as the reference's own prefill + decode
    test does: its prefill and forward then drop no token, while a decode
    step never drops one, so the three compute the same function."""
    import dataclasses

    from repro_torch.models import (decode_step, forward, init_cache,
                                    logits_from_h, prefill)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    max_seq = n_prompt + GEN_STEPS
    batch = family_inputs(torch, dev, cfg, n_seq, max_seq, LM_SEED + 1)
    tokens = batch["tokens"]
    prompt = dict(batch, tokens=tokens[:, :n_prompt])
    want_pre = {"flash_attention_fwd": family_flash(cfg)}
    want_dec = {"decode_attention_fwd": cfg.num_layers * GEN_STEPS}
    if cfg.is_encdec:
        want_dec["flash_attention_fwd"] = cfg.num_layers * GEN_STEPS
    V = cfg.vocab_size
    kinds = [cfg.kv_cache_dtype]
    if cfg.kv_cache_dtype != "bfloat16":
        kinds.append("bfloat16")
    logits = {}
    for kv in kinds:
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        with torch.inference_mode():
            warm, _ = prefill(params, prompt, c, max_seq)
            decode_step(params, tokens[:, n_prompt:n_prompt + 1], warm, c)
            del warm
            empty = init_cache(c, n_seq, max_seq, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            cache, lg = prefill(params, prompt, c, max_seq)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            pre = {k: v for k, v in kernel_launches().items() if v}
            reset_launches()
            got, walls = [lg], []
            t_all = time.perf_counter()
            for t in range(GEN_STEPS):
                t0 = time.perf_counter()
                lg, cache = decode_step(
                    params, tokens[:, n_prompt + t:n_prompt + t + 1], cache,
                    c)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                got.append(lg)
            t_decode = time.perf_counter() - t_all
            dec = {k: v for k, v in kernel_launches().items() if v}
            peak = torch.cuda.max_memory_allocated()
            if kv == kinds[0]:          # one more step, profiled
                device_s, n_launch, top = profiled(torch, lambda: (
                    decode_step(params, tokens[:, -1:], cache, c)),
                    keep=("decode_partial_kernel", "flash_tc_kernel"))
                emit("profile", path=f"lm_generate {cfg.name} decode_step",
                     kv_cache=kv, device_seconds=device_s,
                     wall_seconds=min(walls),
                     busy_share=device_s / min(walls),
                     n_kernel_launches=n_launch, top=top)
            check(cache_leaves(empty) == cache_leaves(cache)
                  and cache["index"] == max_seq,
                  f"lm_generate {cfg.name} {kv}: init_cache and prefill "
                  f"disagree on the cache")
            check(pre == want_pre and dec == want_dec,
                  f"lm_generate {cfg.name} {kv}: launches prefill {pre}, "
                  f"decode {dec}; expected {want_pre}, {want_dec}")
            got = torch.cat(got, dim=1)
            check(bool(torch.isfinite(got[..., :V]).all()),
                  f"lm_generate {cfg.name} {kv}: logits not finite")
            logits[kv] = got
            del cache, empty
        emit("lm_generate", model=cfg.name, kv_cache=kv, batch=n_seq,
             prompt=n_prompt, steps=GEN_STEPS, max_seq=max_seq,
             capacity_factor=cfg.capacity_factor if cfg.num_experts
             else None,
             prefill_seconds=t_prefill,
             prefill_tokens_per_s=n_seq * n_prompt / t_prefill,
             decode_seconds=t_decode,
             decode_tokens_per_s=n_seq * GEN_STEPS / t_decode,
             step_ms=dict(first=walls[0] * 1e3,
                          median=sorted(walls)[GEN_STEPS // 2] * 1e3,
                          min=min(walls) * 1e3),
             peak_mem_bytes=peak, launches_prefill=pre,
             launches_decode=dec)
    with torch.inference_mode():
        h = forward(params, batch, cfg)
        ref = logits_from_h(params, h[:, n_prompt - 1:], cfg)
    del h
    cmp = compare_logits(logits["bfloat16"], ref, V)
    out = dict(bf16_cache_vs_forward=dict(max_abs=cmp[0], mean_abs=cmp[1],
                                          top1_agree=cmp[2]))
    if len(kinds) > 1:
        f8 = compare_logits(logits[kinds[0]], logits["bfloat16"], V)
        f8f = compare_logits(logits[kinds[0]], ref, V)
        out[f"{kinds[0]}_vs_bf16_cache"] = dict(
            max_abs=f8[0], mean_abs=f8[1], top1_agree=f8[2])
        out[f"{kinds[0]}_vs_forward"] = dict(
            max_abs=f8f[0], mean_abs=f8f[1], top1_agree=f8f[2])
    emit("lm_generate", model=cfg.name, **out)
    check_bf16(f"lm_generate {cfg.name} vs forward", cmp)
    if len(kinds) > 1:
        check(f8[0] <= FP8_KV_ATOL,
              f"lm_generate {cfg.name}: {kinds[0]} cache logits differ "
              f"from the bfloat16 cache's by {f8[0]}")


# --------------------------------------------------------------------------
# lm_train: the train step on the card
# --------------------------------------------------------------------------
TRAIN_LR = 3e-3
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 32
# card against CPU after one float32 step: the loss to 1e-5 relative, the
# gradients' global norm to 1e-5 relative, each moment leaf to 1e-4 of its
# largest magnitude (the CPU parity tests' gradient bar); every parameter
# within 2.5 lr (an element whose gradient lies within rounding of zero
# may take the opposite Adam step, 2 lr away) and all but TRAIN_LOOSE of
# them within TRAIN_TIGHT
TRAIN_LOSS_RTOL, TRAIN_MOMENT_TOL = 1e-5, 1e-4
TRAIN_PARAM_ATOL, TRAIN_TIGHT, TRAIN_LOOSE = 2.5 * TRAIN_LR, 1e-5, 1e-4
# full width: (arch, batch, seq), 5 steps on one batch at the reference
# step factory's default lr
TRAIN_FULL = (("gemma3_1b", 2, 2048), ("mamba2_130m", 8, 2048))
TRAIN_STEPS, TRAIN_FULL_LR = 5, 3e-4
# bfloat16 eval loss on the kernels against the plain paths: the logit
# comparisons' mean bar (a mean of per-token losses, each moved by a few
# logits' differences)
TRAIN_EVAL_BF16_ATOL = 0.05
CARD_BYTES = 80e9


def tree_close(torch, card, cpu, tight=None, rel=False):
    """(max |card - cpu| over the leaves (relative to each leaf's largest
    magnitude when ``rel``), elements beyond ``tight``, elements)."""
    from repro_torch import _tree
    worst, loose, n = 0.0, 0, 0
    for a, w in zip(_tree.leaves(card), _tree.leaves(cpu)):
        d = (a.detach().cpu().float() - w.float()).abs()
        if rel:
            d = d / max(w.float().abs().max().item(), 1e-30)
        worst = max(worst, d.max().item() if d.numel() else 0.0)
        if tight is not None:
            loose += int((d > tight).sum())
        n += d.numel()
    return worst, loose, n


def train_once(torch, cfg, params, batch, lr):
    """One `make_train_step` from fresh AdamW state: (params, state, loss,
    the gradients' global norm)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init, global_norm
    seen = []

    def keep(g):
        seen.append(global_norm(g))
        return g
    p, o, loss = make_train_step(cfg, lr=lr, grad_tx=keep)(
        params, adamw_init(params), batch)
    return p, o, float(loss), float(seen[0])


def train_smoke_configs(torch, dev):
    """(a): each SMOKE config's float32 step, card against CPU; returns
    mamba2's card state for the checkpoint check."""
    import dataclasses

    from repro_torch import _tree, configs
    from repro_torch.models import init_params
    kept = None
    for arch in configs.ARCHS:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32")
        cpu_batch = {k: v.cpu() for k, v in family_inputs(
            torch, dev, cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ,
            LM_SEED).items()}
        cpu_params = init_params(cfg, LM_SEED, device="cpu")
        want = train_once(torch, cfg, cpu_params, cpu_batch, TRAIN_LR)
        params = _tree.tree_map(lambda t: t.to(dev), cpu_params)
        batch = {k: v.to(dev) for k, v in cpu_batch.items()}
        torch.cuda.synchronize()
        reset_launches()
        got = train_once(torch, cfg, params, batch, TRAIN_LR)
        launches = kernel_launches()
        p_err, p_loose, n = tree_close(torch, got[0], want[0], TRAIN_TIGHT)
        m_err = tree_close(torch, got[1].m, want[1].m, rel=True)[0]
        v_err = tree_close(torch, got[1].v, want[1].v, rel=True)[0]
        loss_err = abs(got[2] - want[2]) / abs(want[2])
        norm_err = abs(got[3] - want[3]) / abs(want[3])
        emit("lm_train", part="card_vs_cpu", model=cfg.name, loss=got[2],
             cpu_loss=want[2], loss_rel_err=loss_err, grad_norm=got[3],
             grad_norm_rel_err=norm_err, param_max_err=p_err,
             params_beyond_tight=p_loose, n_params=n, m_rel_err=m_err,
             v_rel_err=v_err, port_kernel_launches=sum(launches.values()))
        check(loss_err <= TRAIN_LOSS_RTOL and norm_err <= TRAIN_LOSS_RTOL,
              f"lm_train {cfg.name}: loss or gradient norm off the CPU's "
              f"({loss_err}, {norm_err})")
        check(p_err <= TRAIN_PARAM_ATOL and p_loose <= TRAIN_LOOSE * n,
              f"lm_train {cfg.name}: parameters off the CPU's by {p_err} "
              f"({p_loose} of {n} beyond {TRAIN_TIGHT})")
        check(m_err <= TRAIN_MOMENT_TOL and v_err <= TRAIN_MOMENT_TOL,
              f"lm_train {cfg.name}: moments off the CPU's ({m_err}, "
              f"{v_err})")
        check(not any(launches.values()),
              f"lm_train {cfg.name}: a train step launched {launches}")
        if arch == "mamba2_130m":
            kept = (got[0], got[1])
    return kept


def train_full_width(torch, dev, arch, B, S, smi):
    """(b): one model at full width, bfloat16 compute."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_eval_step, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    params = init_params(cfg, LM_SEED, device=dev)
    batch = {"tokens": lm_tokens(torch, dev, cfg, B, S)}
    n_params = sum(t.numel() for t in _tree.leaves(params))
    out = dict(model=cfg.name, batch=B, seq=S, params=n_params,
               nvidia_smi=smi,
               # float32 parameters, gradients and two moments; float32
               # logits of the S - 1 predicted positions
               state_bytes=16 * n_params,
               logit_bytes=4 * B * (S - 1) * cfg.padded_vocab)

    def steps(c, n, params, opt):
        step = make_train_step(c, lr=TRAIN_FULL_LR)
        losses, times = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for _ in range(n):
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, batch)
            losses.append(float(loss))              # waits for the step
            times.append(time.perf_counter() - t0)
        return (params, opt, losses, times,
                torch.cuda.max_memory_allocated(), kernel_launches())

    opt = adamw_init(params)
    params, opt, losses, times, peak, launches = steps(cfg, TRAIN_STEPS,
                                                       params, opt)
    med = sorted(times[1:])[len(times[1:]) // 2]
    out.update(losses=losses, step_seconds=times, median_step_seconds=med,
               tokens_per_s=B * S / med, peak_mem_bytes_remat_none=peak,
               port_kernel_launches_per_train_step=sum(launches.values()))
    check(losses[-1] < losses[0],
          f"lm_train {cfg.name}: the loss did not fall: {losses}")
    check(not any(launches.values()),
          f"lm_train {cfg.name}: train steps launched {launches}")
    full = dataclasses.replace(cfg, remat="full")
    params, opt, _l, times_full, peak_full, _ = steps(full, 2, params, opt)
    out.update(peak_mem_bytes_remat_full=peak_full,
               step_seconds_remat_full=times_full)
    step = make_train_step(cfg, lr=TRAIN_FULL_LR)
    holder = {}

    def one():
        holder["s"] = step(params, opt, batch)
    device_s, n_launch, top = profiled(torch, one)
    del holder
    out.update(profiled_step=dict(device_seconds=device_s,
                                  busy_share=device_s / med,
                                  kernel_launches=n_launch, top=top[:6]))
    reset_launches()
    ev = float(make_eval_step(cfg)(params, batch))
    eval_launches = kernel_launches()
    plain = float(make_eval_step(dataclasses.replace(cfg, attn_impl="dense"),
                                 impl="jnp")(params, batch))
    out.update(eval_loss=ev, eval_loss_plain=plain,
               eval_loss_abs_diff=abs(ev - plain),
               eval_bound=TRAIN_EVAL_BF16_ATOL,
               port_kernel_launches_per_eval_step={
                   k: v for k, v in eval_launches.items() if v})
    want = expected_launches(cfg)
    check({k: v for k, v in eval_launches.items() if v} == want,
          f"lm_train {cfg.name}: eval launches {eval_launches}, "
          f"expected {want}")
    check(abs(ev - plain) <= TRAIN_EVAL_BF16_ATOL,
          f"lm_train {cfg.name}: eval loss on the kernels {ev} against "
          f"the plain paths {plain}")
    emit("lm_train", part="full_width", **out)
    del params, opt, batch
    torch.cuda.empty_cache()


def checkpoint_card_to_cpu(torch, state):
    """(c), first half: the card state saved, then restored onto CPU
    tensors, bit for bit."""
    import tempfile

    from repro_torch import _tree
    from repro_torch.checkpoint import manager as ckpt
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, state, {"step": 1})
        like = _tree.tree_map(lambda t: torch.empty_like(t, device="cpu"),
                              state)
        back, meta = ckpt.restore(d, 1, like)
    same = all(torch.equal(a.cpu(), b) and b.device.type == "cpu"
               for a, b in zip(_tree.leaves(state), _tree.leaves(back)))
    emit("lm_train", part="checkpoint_card_to_cpu", leaves=len(
        _tree.leaves(state)), bit_for_bit=same)
    check(same and meta == {"step": 1},
          "lm_train: a card checkpoint restored onto the CPU differs")


def resume_runs(torch, dev, root):
    """An uninterrupted `launch.train.main` run on the card and one
    preempted by its sentinel and resumed: (losses, resumed losses, the
    two final checkpoints)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    argv = ["--arch", "mamba2-130m", "--smoke", "--steps", "6",
            "--global-batch", "4", "--seq", "64", "--ckpt-every", "2",
            "--log-every", "100", "--device", str(dev)]
    whole = train.main(argv + ["--ckpt-dir", os.path.join(root, "a")])
    sentinel = os.path.join(root, "PREEMPT")
    open(sentinel, "w").close()
    try:
        train.main(argv + ["--ckpt-dir", os.path.join(root, "b"),
                           "--preempt-file", sentinel])
        fail("lm_train: the preempted run did not exit")
    except SystemExit as e:
        check(e.code == 42, f"lm_train: preemption exit code {e.code}")
    os.remove(sentinel)
    rest = train.main(argv + ["--ckpt-dir", os.path.join(root, "b"),
                              "--resume"])
    p0 = init_params(get_smoke_config("mamba2-130m"), 0, device=dev)
    like = (p0, adamw_init(p0))
    return whole, rest, [ckpt.restore(os.path.join(root, n), 5, like)[0]
                         for n in ("a", "b")]


def resume_on_card(torch, dev):
    """(c), second half: resume against an uninterrupted run."""
    import tempfile

    from repro_torch import _tree
    results = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            with tempfile.TemporaryDirectory() as root:
                whole, rest, (a, b) = resume_runs(torch, dev, root)
        finally:
            torch.use_deterministic_algorithms(False)
        diffs = [(i, (x.float() - y.float()).abs().max().item())
                 for i, (x, y) in enumerate(zip(_tree.leaves(a),
                                                _tree.leaves(b)))
                 if not torch.equal(x, y)]
        results[mode] = dict(
            losses_equal=rest == whole[1:],
            max_loss_diff=max(abs(x - y) for x, y in zip(rest, whole[1:])),
            leaves_differing=len(diffs), first_diffs=diffs[:4],
            bit_for_bit=not diffs and rest == whole[1:])
        if results[mode]["bit_for_bit"]:
            break
    emit("lm_train", part="resume_on_card", **results)
    check(any(r["bit_for_bit"] for r in results.values()),
          f"lm_train: resume on the card is not bit for bit: {results}")
    # default mode, if it differed: the leaves named, each within a
    # float32 rounding of summation order
    for r in results.values():
        check(r["max_loss_diff"] <= 1e-4,
              f"lm_train: resumed losses off by {r['max_loss_diff']}")


def phase_lm_train(torch, dev):
    from repro_torch.configs import get_config
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    t0 = time.perf_counter()
    state = train_smoke_configs(torch, dev)
    checkpoint_card_to_cpu(torch, state)
    resume_on_card(torch, dev)
    del state
    # the full-width steps' float32 logits, score blocks and AdamW trees
    # (GB each, freed and reallocated at other sizes) fragment fixed
    # segments: gemma3-1b's first backward ran out of memory with 56 GB
    # allocated and 20.7 GB reserved but unallocated.  Segments that
    # grow in place are used for this phase only.
    allocator = getattr(torch._C, "_accelerator_setAllocatorSettings",
                        torch.cuda.memory._set_allocator_settings)
    torch.cuda.empty_cache()
    allocator("expandable_segments:True")
    try:
        for arch, B, S in TRAIN_FULL:
            train_full_width(torch, dev, arch, B, S, smi)
    finally:
        torch.cuda.empty_cache()
        allocator("expandable_segments:False")
    rg = get_config(RG_ARCH)
    emit("lm_train", part="reckoning",
         left_out=dict(model=rg.name, params=rg.param_count(),
                       state_bytes=16 * rg.param_count(),
                       card_bytes=CARD_BYTES,
                       reason="float32 parameters, gradients and two AdamW "
                              "moments exceed the card"),
         seconds=time.perf_counter() - t0)


# lm_sharded / pipeline: an NCCL world of one rank on the card
SHARDED_ARCH, SHARDED_B, SHARDED_S, SHARDED_STEPS = "gemma3_1b", 2, 2048, 3
SHARDED_GEN_ARCHS = ("gemma3_1b", "mamba2_130m", RG_ARCH)
SHARDED_GEN_B, SHARDED_GEN_P, SHARDED_GEN_STEPS = 2, 1000, 4
PIPE_B, PIPE_D, PIPE_M = 64, 4096, 4
PIPE_ATOL = 1e-5
# dryrun: host processes at once (the card's host has 8 cores)
DRYRUN_WORKERS = 8


def nccl_world_of_one():
    """A context in which this process is the one rank of an NCCL group
    (a ``file://`` store in a temporary directory)."""
    import contextlib
    import tempfile

    import torch.distributed as dist

    @contextlib.contextmanager
    def world():
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("nccl", init_method=f"file://{tmp}/s",
                                    rank=0, world_size=1)
            try:
                yield
            finally:
                dist.destroy_process_group()
    return world()


def phase_lm_sharded(torch, dev):
    import dataclasses

    import numpy as np

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_axes
    from repro_torch.optim import adamw_init
    from repro_torch.scripts.smoke_sharded_train import run_steps
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(SHARDED_ARCH), remat="full")
    batch = {"tokens": lm_tokens(torch, dev, cfg, SHARDED_B, SHARDED_S)}
    params = init_params(cfg, LM_SEED, device=dev)
    with nccl_world_of_one():
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = sh.base_rules()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        want = run_steps(cfg, params, batch, SHARDED_STEPS, TRAIN_FULL_LR)
        want_params = _tree.tree_map(lambda t: t.cpu(), want["params"])
        del want["params"], want["opt"]
        unsharded_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = run_steps(cfg, params, batch, SHARDED_STEPS, TRAIN_FULL_LR,
                        mesh=mesh, rules=rules)
        sharded_peak = torch.cuda.max_memory_allocated()
        launches = kernel_launches()
        same = all(torch.equal(a.full_tensor().cpu(), b) for a, b in zip(
            _tree.leaves(got["params"]), _tree.leaves(want_params)))
        del got["params"], got["opt"], want_params
        torch.cuda.empty_cache()
        check(got["losses"] == want["losses"]
              and got["grad_norms"] == want["grad_norms"] and same,
              f"lm_sharded: the sharded step differs from the unsharded: "
              f"losses {got['losses']} vs {want['losses']}, norms "
              f"{got['grad_norms']} vs {want['grad_norms']}, parameters "
              f"equal {same}")
        check(not any(launches.values()),
              f"lm_sharded: a train step launched {launches}")
        # single steps in turns from the same state; each kind profiled
        # once, the sharded step's collectives counted once
        step = make_train_step(cfg, lr=TRAIN_FULL_LR)
        opt = adamw_init(params)
        shard = sh.tree_shardings(param_axes(cfg), mesh, rules)
        dparams = sh.distribute_tree(params, shard)
        with sh.sharding_context(mesh, rules):
            dopt = adamw_init(dparams)
        holder = {}

        def run(which):
            if which == "sharded":
                with sh.sharding_context(mesh, rules):
                    holder["s"] = step(dparams, dopt, batch)
                    float(holder["s"][2].full_tensor())
            else:
                holder["s"] = step(params, opt, batch)
                float(holder["s"][2])
            holder.clear()
        walls = {"unsharded": [], "sharded": []}
        for which in ("unsharded", "sharded", "sharded", "unsharded"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(which)
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t1)
        prof = {w: profiled(torch, lambda w=w: run(w))
                for w in ("unsharded", "sharded")}
        with OpCost() as cost:
            run("sharded")
        coll = cost.result()
        del dparams, dopt, opt, holder
        torch.cuda.empty_cache()
        generation = {}
        for arch in SHARDED_GEN_ARCHS:
            generation[arch] = sharded_generation(
                torch, dev, mesh, rules, arch,
                params=params if arch == SHARDED_ARCH else None)
            torch.cuda.empty_cache()
    med = {w: float(np.median(v)) for w, v in walls.items()}
    emit("lm_sharded", model=cfg.name, batch=SHARDED_B, seq=SHARDED_S,
         mesh="1x1", backend="nccl", remat=cfg.remat,
         steps=SHARDED_STEPS, losses=got["losses"],
         grad_norms=got["grad_norms"], bit_for_bit=True,
         step_seconds=walls, median_seconds=med,
         wall_ratio=med["sharded"] / med["unsharded"],
         tokens_per_s={w: SHARDED_B * SHARDED_S / m for w, m in med.items()},
         peak_mem_bytes=dict(unsharded=unsharded_peak, sharded=sharded_peak),
         launches_per_step={w: p[1] for w, p in prof.items()},
         device_seconds_per_step={w: p[0] for w, p in prof.items()},
         collectives_per_step=coll["coll_counts"],
         collective_bytes_per_step=coll["coll_bytes"],
         port_kernel_launches=sum(launches.values()),
         generation=generation, seconds=time.perf_counter() - t0)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()


def sharded_generation(torch, dev, mesh, rules, arch, params=None):
    """Prefill and decode of ``arch`` (at full width; recurrentgemma cut
    to one cycle) unsharded and on DTensor parameters over ``mesh``: the
    kernel launches of each, the largest logit difference and the
    seconds.  Fails unless both launch every kernel of the path as
    `expected_launches` says and the logits are equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import (decode_step, init_params, param_axes,
                                    prefill)
    cfg = get_config(arch)
    if arch == RG_ARCH:
        cfg = dataclasses.replace(cfg, num_layers=len(cfg.pattern))
    if params is None:
        params = init_params(cfg, LM_SEED, device=dev)
    P, n = SHARDED_GEN_P, SHARDED_GEN_STEPS
    tokens = lm_tokens(torch, dev, cfg, SHARDED_GEN_B, P + n)
    dparams = sh.distribute_tree(
        params, sh.tree_shardings(param_axes(cfg), mesh, rules))

    def run(p):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            cache, lg = prefill(p, {"tokens": tokens[:, :P]}, cfg, P + n)
            out = [sh.whole(lg)]
            for t in range(n):
                lg, cache = decode_step(p, tokens[:, P + t:P + t + 1],
                                        cache, cfg)
                out.append(sh.whole(lg))
        torch.cuda.synchronize()
        return (torch.cat(out, dim=1), time.perf_counter() - t0,
                {k: v for k, v in kernel_launches().items() if v})
    want, plain_s, plain_l = run(params)
    with sh.sharding_context(mesh, rules):
        got, sharded_s, sharded_l = run(dparams)
    err = (got.float() - want.float()).abs().max().item()
    expect = expected_launches(cfg)
    n_attn = expect.get("flash_attention_fwd", 0)
    if n_attn:
        expect["decode_attention_fwd"] = n_attn * n
    check(plain_l == expect and sharded_l == expect,
          f"lm_sharded {arch}: launches unsharded {plain_l}, sharded "
          f"{sharded_l}; expected {expect}")
    check(err == 0.0 and bool(torch.isfinite(got).all()),
          f"lm_sharded {arch}: sharded logits off by {err}")
    return dict(model=cfg.name, layers=cfg.num_layers, batch=SHARDED_GEN_B,
                prompt=P, decode_steps=n, launches=sharded_l,
                max_abs_err=err, seconds=dict(unsharded=plain_s,
                                              sharded=sharded_s))


def phase_pipeline(torch, dev):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.scripts.smoke_pipeline import stage_fn
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(LM_SEED)
    W = torch.randn((1, PIPE_D, PIPE_D), generator=g, device=dev) \
        * PIPE_D ** -0.5
    x = torch.randn((PIPE_B, PIPE_D), generator=g, device=dev)
    with nccl_world_of_one():
        stats = {}
        y = pipeline_apply(stage_fn, W, x, mesh=make_mesh((1,), ("stage",)),
                           microbatches=PIPE_M, stats=stats)
        torch.cuda.synchronize()
    want = stage_fn(W[0], x)
    err = (y - want).abs().max().item()
    emit("pipeline", stages=1, backend="nccl", batch=PIPE_B, width=PIPE_D,
         microbatches=PIPE_M, ticks=stats["ticks"], max_abs_err=err,
         atol=PIPE_ATOL, seconds=time.perf_counter() - t0,
         multi_stage="needs a machine with several cards")
    check(err <= PIPE_ATOL and stats["ticks"] == PIPE_M,
          f"pipeline: {err} off the loop, {stats['ticks']} ticks")


def dryrun_cell(cell):
    """One (arch, shape) cell on the 16 x 16 fake mesh (a worker process
    of `phase_dryrun`): its record, with its seconds."""
    arch, shape = cell
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    ok, why = dryrun.cell_supported(arch, shape)
    if not ok:
        rec = dict(arch=arch, shape=shape, mesh="16x16", status="skipped",
                   reason=why)
    else:
        try:
            dryrun.fake_world(256)
            rec = dryrun.lower_cell(arch, shape, verbose=False)
        except Exception as e:  # noqa: BLE001 — reported, then failed
            import traceback
            where = [f"{f.filename.split('/')[-1]}:{f.lineno}"
                     for f in traceback.extract_tb(e.__traceback__)
                     if "repro_torch" in f.filename][-4:]
            rec = dict(arch=arch, shape=shape, mesh="16x16",
                       status="error",
                       error=f"{type(e).__name__}: {e} at {where}")
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def phase_dryrun():
    import multiprocessing as mp
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import all_archs
    from repro_torch.launch.specs import FULL_ATTENTION_ARCHS
    from repro_torch.launch.specs import SHAPES
    t0 = time.perf_counter()
    # the longest cells (train) first, for an even load
    cells = [(a, s) for s in SHAPES for a in all_archs()]
    with mp.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
        records = pool.map(dryrun_cell, cells, chunksize=1)
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "dryrun.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    for r in records:
        if r["status"] != "ok":
            emit("dryrun", arch=r["arch"], shape=r["shape"],
                 status=r["status"], why=r.get("reason", r.get("error")))
            continue
        emit("dryrun", arch=r["arch"], shape=r["shape"], status="ok",
             argument_bytes=r["memory"]["argument_bytes"],
             peak_bytes=r["memory"]["peak_bytes"],
             flops_per_chip=r["flops_per_chip"],
             collective_bytes_per_chip=r["collective_bytes_per_chip"],
             dominant=r["terms"]["dominant"],
             step_lower_bound_s=r["terms"]["step_lower_bound_s"],
             useful_flop_ratio=r["useful_flop_ratio"],
             traced_cycles=r["depth"]["traced_cycles"],
             wall_s=r["wall_s"])
    skipped = {(r["arch"], r["shape"]) for r in records
               if r["status"] == "skipped"}
    bad = [(r["arch"], r["shape"], r.get("error")) for r in records
           if r["status"] not in ("ok", "skipped")]
    want_skips = {(a, "long_500k") for a in all_archs()
                  if a in FULL_ATTENTION_ARCHS}
    emit("dryrun", cells=len(records), ok=len(records) - len(skipped)
         - len(bad), skipped=len(skipped), workers=DRYRUN_WORKERS,
         seconds=time.perf_counter() - t0)
    check(not bad, f"dryrun: cells failed: {bad}")
    check(skipped == want_skips, f"dryrun: skipped {sorted(skipped)}")


def phase_parity():
    """The card-marked tests, in a child process: the kernels against their
    plain versions, and a small rollout on the card against the CPU."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")))))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", os.path.join("tests", "test_torch_cuda.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    check(proc.returncode == 0 and "skipped" not in tail[0],
          f"card-marked tests failed:\n{proc.stdout[-4000:]}"
          f"{proc.stderr[-2000:]}")
    emit("parity", tests="tests/test_torch_cuda.py -m gpu", result=tail[0],
         seconds=time.perf_counter() - t0)


def phase_timing(torch, dev, params):
    from repro_torch.api import engine as E
    seconds = {"tableau": [], "revised": []}
    for method in ("tableau", "revised", "revised", "tableau"):
        state = E.init_state(params[method], device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E.rollout(state, params[method], PERIODS, device=dev)
        torch.cuda.synchronize()
        seconds[method].append(time.perf_counter() - t0)
    for method, ts in seconds.items():
        emit("timing", lp_method=method, seconds=ts,
             devices_per_s=[D_FLEET * PERIODS / t for t in ts])
    return seconds


def profiled(torch, run, keep=()):
    """``run()`` under `torch.profiler`: (device seconds, kernel launches,
    the ten largest device items by name, then any other item whose name
    holds one of ``keep``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            n, t = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (n + 1, t + us)
    device_s = sum(t for _n, t in by_name.values()) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:10] + [kv for kv in ranked[10:]
                         if any(k in kv[0] for k in keep)]
    return (device_s, sum(n for n, _t in by_name.values()),
            [dict(name=k[:80], calls=n, ms=t / 1e3) for k, (n, t) in top])


def phase_profile(torch, dev, params, seconds, serve_seconds):
    """Device time of one rollout per method and of one serve run, summed
    over the kernels the profiler saw, against the best unprofiled wall
    time of phases 8 and 6."""
    from repro_torch.api import engine as E
    for method, p in params.items():
        state = E.init_state(p, device=dev)
        device_s, n, top = profiled(
            torch, lambda: E.rollout(state, p, PERIODS, device=dev))
        wall = min(seconds[method])
        emit("profile", path="rollout", lp_method=method,
             device_seconds=device_s, wall_seconds=wall,
             busy_share=device_s / wall if device_s else None,
             n_kernel_launches=n, top=top)
    engine = serve_engine(dev)
    device_s, n, top = profiled(torch, lambda: engine.run(PERIODS))
    emit("profile", path="serve", device_seconds=device_s,
         wall_seconds=serve_seconds,
         busy_share=device_s / serve_seconds if device_s else None,
         n_kernel_launches=n, top=top)
    emit("profile", path="serve", host=serve_host_breakdown(torch, dev))


# the serve path's stages, by the function that runs each
SERVE_STAGES = {
    "queue.poll": ("queue.py", "poll"),
    "assemble": ("fleet.py", "_assemble"),
    "solve (plan + replan)": ("front.py", "solve"),
    "amdp_arrays": ("amdp.py", "amdp_arrays"),
    "cckp_counts (DP + backtrack)": ("amdp.py", "cckp_counts"),
    "amr2_batch_arrays": ("amr2.py", "amr2_batch_arrays"),
    "simplex_batch_core": ("lp.py", "simplex_batch_core"),
    "round_relaxation_batch": ("amr2.py", "round_relaxation_batch"),
    "admit_mask": ("fleet.py", "admit_mask"),
    "identical_mask": ("problem.py", "identical_mask"),
}


def serve_host_breakdown(torch, dev):
    """Host seconds of one serve run (fresh engine, 8 periods) by stage,
    under cProfile: each stage's cumulative time, and the whole run's."""
    import cProfile
    import pstats
    engine = serve_engine(dev)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    engine.run(PERIODS)
    torch.cuda.synchronize()
    prof.disable()
    out = {"total (profiled)": time.perf_counter() - t0}
    stats = pstats.Stats(prof).stats
    for stage, (fname, func) in SERVE_STAGES.items():
        out[stage] = sum(v[3] for (f, _line, name), v in stats.items()
                         if f.endswith(fname) and name == func)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.cckp_dp import ops as cckp_ops
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.simplex_pivot import ops, ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         nvcc=run([_build.nvcc(), "--version"]).splitlines()[-1])

    t0 = time.perf_counter()
    libs = [ops.LIBRARY, cckp_ops.LIBRARY, fa_ops.LIBRARY, ssd_ops.LIBRARY,
            da_ops.LIBRARY, rg_ops.LIBRARY]
    built = _build.build_many(libs)
    for lib in libs:
        lib.load()
    for lib, (path, log) in zip(libs, built):
        source = os.path.relpath(lib.src, ROOT)
        instances = ptxas_instances(log)
        emit("build", source=source, library=os.path.relpath(path, ROOT),
             instances=instances)
        if source in (SSD_SRC, CCKP_SRC, SIMPLEX_SRC):  # redesigned: no spill
            check(all(i["spill_stores"] == 0 and i["spill_loads"] == 0
                      for i in instances),
                  f"build: ptxas spills in {source}: {instances}")
    emit("build", seconds=time.perf_counter() - t0)
    emit("build", occupancy=dict(
        simplex_pivot=ops.occupancy("simplex_pivot", R + 1, C0 + 1),
        reduced_pivot=ops.occupancy("reduced_pivot", R, C0),
        ssd_scan_bf16=ssd_ops.occupancy(True),
        ssd_scan_f32=ssd_ops.occupancy(False),
        cckp_shared_serve_grid=dict(
            smem=cckp_ops.smem_bytes(DP_T1, DP_K1, DP_K1, True),
            ctas_per_sm=cckp_ops.occupancy(DP_T1, DP_K1, DP_K1, True)),
        cckp_global=dict(
            smem=cckp_ops.smem_bytes(*DP_GLOBAL[1:], DP_GLOBAL[2], False),
            ctas_per_sm=cckp_ops.occupancy(*DP_GLOBAL[1:], DP_GLOBAL[2],
                                           False)),
        rglru_scan={name: dict(geo._asdict(), **rg_ops.occupancy(geo))
                    for name, geo in ((name, rg_ops.launch_geometry(B, S, W))
                                      for name, B, S, W, _ in RGLRU_SHAPES)}))

    t_kernels = time.perf_counter()
    rows = phase_kernels(torch, ops, ref, dev)
    flash_rows = phase_flash_kernel(torch, dev)
    phase_flash_repeat(torch, dev)
    ssd_rows = phase_ssd_kernel(torch, dev)
    decode_rows = phase_decode_kernel(torch, dev)
    rglru_rows = phase_rglru_kernel(torch, dev)
    emit("kernels", phase_seconds=time.perf_counter() - t_kernels)
    fleet = rollout_fleet()
    params, dual_params = build_params(dev, fleet)
    launches, amr2_metrics = phase_rollout(torch, ops, dev, params)
    phase_rollout_calls(torch, ops, ref, dev, params)
    phase_front(torch, dev)
    serve_launches, serve_seconds, dp_calls = phase_serve(torch, dev)
    launches["cckp_model_dp"] = serve_launches["cckp_model_dp"]
    phase_cckp_serve_calls(torch, dev, dp_calls)
    del dp_calls
    phase_rollout_dual(torch, dev, dual_params, amr2_metrics["tableau"])
    phase_rollout_poisson(torch, ops, dev, fleet)
    phase_serve_delegated(torch, dev, serve_seconds)
    plain_launches = dict(launches)
    chaos_launches, _plain_seconds = phase_rollout_chaos(
        torch, dev, params, amr2_metrics)
    mobility_launches = phase_rollout_mobility(
        torch, dev, params, amr2_metrics, plain_launches)
    phase_rollout_hi(torch, dev, params, amr2_metrics,
                     _plain_seconds["revised"])
    sharded_launches = phase_rollout_sharded(torch, dev, params)
    grad_launches = phase_rollout_grad(torch, dev, params)
    for counted in (chaos_launches, mobility_launches, sharded_launches,
                    grad_launches):
        for name, n in counted.items():
            launches[name] += n
    del dual_params, amr2_metrics, fleet
    phase_lm_forward(torch, dev)
    phase_lm_forward_ssm(torch, dev)
    launches["flash_attention_fwd"] = phase_lm_serve(torch, dev)
    rows["flash_attention_fwd"] = flash_rows[FLASH_LINE]
    launches["decode_attention_fwd"] = phase_lm_generate(
        torch, dev, "gemma3_1b")["decode_attention_fwd"]
    launches["ssd_scan_fwd"] = phase_lm_generate(
        torch, dev, "mamba2_130m")["ssd_scan_fwd"]
    rows["ssd_scan_fwd"] = ssd_rows["bfloat16"]
    rows["decode_attention_fwd"] = decode_rows[DECODE_LINE]
    launches["rglru_scan_fwd"] = phase_recurrentgemma(
        torch, dev)["rglru_scan_fwd"]
    rows["rglru_scan_fwd"] = rglru_rows[RGLRU_LINE]
    phase_lm_families(torch, dev)
    phase_lm_train(torch, dev)
    phase_lm_sharded(torch, dev)
    phase_pipeline(torch, dev)
    phase_dryrun()
    phase_parity()
    seconds = phase_timing(torch, dev, params)
    phase_profile(torch, dev, params, seconds, serve_seconds)

    source = {"simplex_pivot": SIMPLEX_SRC, "reduced_pivot": SIMPLEX_SRC,
              "cckp_model_dp":
                  "src/repro_torch/kernels/cckp_dp/csrc/cckp_dp.cu",
              "flash_attention_fwd": FLASH_SRC, "ssd_scan_fwd": SSD_SRC,
              "decode_attention_fwd": DECODE_SRC,
              "rglru_scan_fwd": RGLRU_SRC}
    replaces = {"simplex_pivot": f"{SIMPLEX_TPU}:57",
                "reduced_pivot": f"{SIMPLEX_TPU}:146",
                "cckp_model_dp": "src/repro/kernels/cckp_dp/cckp_dp.py:57",
                "flash_attention_fwd": FLASH_TPU, "ssd_scan_fwd": SSD_TPU,
                "decode_attention_fwd": DECODE_TPU,
                "rglru_scan_fwd": RGLRU_TPU}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    library_ms=row.get("library_ms"))
               for name, row in rows.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
