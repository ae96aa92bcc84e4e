#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout on a machine with an H100, the CUDA toolkit and a CUDA
build of PyTorch. Phases, each fatal on failure:

1. the card (nvidia-smi name and power limit, torch and CUDA versions);
2. build: the hand-written GEMM compiled from ``src/repro_torch/csrc`` by
   nvcc, with the seconds it took, ptxas's register/spill/shared-memory
   report per kernel, and each tile's shared memory held against
   `BlockConfig.smem_bytes`;
3. the kernel against its plain version (`matmul_ref`) on the card: the
   shapes, layouts, alpha/beta, bf16-in/f32-out and K=4096 cases of the
   JAX package's kernel tests plus the fast paths' boundary cases (M around
   8, 64 and 128, ragged N and K, split K), wgmma's transposed layouts (nt,
   tn, tt: M, N and K around 64/65/128/129, split K, beta with C) and the
   split pair (an f32 operand, split into three bf16 terms, times a bf16
   one, on the four layouts; f32 out held to the f32 tolerance), on every
   path that takes each case, with each fast-path result bit-identical over
   two launches, the split kernel bit-equal to its plain version, and
   `stream` on a tied LM head's layout (B stored (N, K), ``transpose_b``;
   M = 1, 4, 8, 9 and 64, N = 65024 and a ragged N, K = 4096, bf16 and f32
   out); then fault C1's check: for every serving (N, K) of the eight
   configs and both output dtypes, the rows of an M = 4 call bit-equal to
   the same rows of M = 1, 8, 64, 65, 128 and 512 calls (a tied head on its
   (N, K) layout at M = 1, 8 and 64; seamless-m4t-medium's untied head on
   its padded rows, ldb 256208), and fault C2's: attention's row 0 the
   same bits in decode steps, short chunks and a long prefill; and the
   encoder's non-causal attention gives row 0 the same bits over 8-512
   keys (its admission bucket) and batch 1-8; and tensor parallelism's:
   for every serving (N, K) of qwen2-7b at tp = 2 and 4, each rank's
   column shard, whole and cut into 4 chunks, launched with
   ``segments_n`` = N, bit-equal to the same columns of the whole product
   at M = 1, 4, 8, 64, 65 and 128, and attention giving each head the same
   bits at 28, 14 and 7 query heads (4, 2 and 1 KV heads); the same for
   every column-sharded weight of falcon-mamba-7b, zamba2-2.7b and
   deepseek-v2-236b, each rank's shard cut by its parts (Mamba1's in_proj
   [x | z], Mamba2's [z | x | B C | dt]; MLA's w_uk and w_uv at the
   cache's 512 and 2048 rows too); and a rank's Mamba1 channels (conv and
   selective scan), SSD heads and MLA heads (attention over 512 cached
   positions, dense and paged) bit-equal to the whole call's, a 64-token
   prefill chunk and a decode step at batch 1 and 4;
4. serve: full-width, full-depth qwen2-7b with seeded random weights; the
   continuous-batching engine answers 10 requests (prompts of 16-300
   tokens, 8-32 new tokens); the kernel's launch counter must equal the
   GEMMs of one forward (197 for qwen2-7b) x the forwards dispatched, every
   one of them on the stream or wgmma path and none on the general path;
5. every distinct GEMM shape the serving run issued, held against the plain
   version and timed: the kernel on the path `plan` chose, the general path
   at the same shape ("v3_ms", the first version of the kernel), the plain
   version and torch.matmul (a yardstick only; the port never calls it),
   beside the H100's bound for that shape, and the sums per path;
6. where a step's time goes: one decode step and one chunk call timed with
   CUDA events, then traced with torch.profiler (device idle share, in-step
   GEMM time, the largest non-GEMM kernels), and one traced engine run for
   the idle share of serving as a whole; a device event belongs to the run
   whose range holds its launching call (by the profiler's correlation
   id), and each traced forward must count `_gemms_per_forward` GEMMs;
   then the dry-run of both steps (`core.opanalyze.analyze_step` on meta
   copies of the engine's params and states, the launches of the untimed
   warm-up call recorded per path): the kernel's launches and FLOPs per
   path equal the card's exactly, and the step's roofline bound on the
   h100 spec (`roofline_from_cost`) is at most 1.05 x its traced device
   busy time; the model-FLOPs utilisation, the ratio, the dominant term
   and the dry-run's peak-live bytes beside the card's peak are printed
   (the same check follows each training run of phases 15 and 16);
7. full-width logits of one chunk call, through the kernel and with every
   product through `matmul_ref`;
8. the paper's loop on the card: profile the compiled tiles over the H100
   sweep with CUDA events (`profiler.card_measure_fn`), fit the Random
   Forest predictor as the port fits it for the card
   (`autotuner.fit_card_predictor`: the paper's direct regression on log
   targets) on the paper's 2,076-row split and report its
   held-out runtime R2 and errors, hold the float64 torch scorer on the
   card against numpy `predict` bit for bit, tune the serving engine's
   GEMM fleet with the
   predictor (every candidate verified on the card), time every serving
   shape at its tuned tile, `plan`'s tile and the general path, and serve
   the same 10 requests with
   `ServingEngine(pretune=True)`: every launch on its tuned tile,
   full-width logits within phase 7's bounds;
9. the energy half of the loop: read the card through NVML (name, enforced
   power limit, idle power, the energy counter's period), measure a
   stratified sample of phase 8's rows for power (`card_measure_fn(
   power=True)`: whole counter periods of back-to-back launches), fit the
   Random Forest on 80% of them and hold its held-out power R2 (at least
   0.5) and median error beside the paper's, tune the serving fleet for
   energy (every candidate measured for power on the card) and give each
   serving shape's joules at its energy-tuned tile, `plan`'s tile and the
   general path, then serve the 10 requests with the energy-tuned and the
   runtime-tuned engine, each run metered by the energy counter: the
   engine's modelled J/token and model clock (the "h100" model) beside the
   measured J/token and mean power;
10. the rest of dense serving at `plan`'s tiles: full-width qwen2.5-14b,
   cut to DENSE_LAYERS of its 48 layers (the script's time: phase 16 came
   in after it), served five ways on the same 10 requests — (a) chunked on
   the dense KV cache, (b) on the paged KV cache without prefix reuse (a chunk
   call and decode steps through a paged and a dense state bit-identical
   first), (c) a shared-prefix workload (one 256-token system prompt ahead
   of each request) dense and paged with prefix reuse at half the default
   page pool (prefix hits, fewer chunk steps), (d) serial admission and (e)
   the wave loop — with launches checked per forward in every run, and
   the streams of (b), (c) and (d) identical to the dense or chunked run's
   (where they are not, a per-layer, per-op diff of one row at two batch
   sizes names the first op whose bits depend on the batch; a plain-torch
   op keeps that gate on first tokens, the GEMM fails it); its full-width
   logits (phase 7's check) and its serving shapes timed as in phase 5;
   then codeqwen1.5-7b (32 KV heads, d_ff 13440) and starcoder2-3b (GELU
   FFN, K/V projections of N = 256), each with the logits check and one
   chunked run;
11. MoE and MLA serving at `plan`'s tiles: full-width, full-depth
   olmoe-1b-7b (64 experts top-8) served chunked, then in the wave loop a
   64-token request alone and beside 3 others (per-row expert capacity
   binds at S = 64; the streams must be identical), then the shared-prefix
   workload dense and paged; and deepseek-v2-236b at full width cut to 4
   of its 60 layers (the whole model is six times the card; phase 17's
   two ranks build that depth in turn), served
   chunked on the dense latent cache and on the paged latent pool, and
   phase 17's four requests alone (a row's expert capacity follows its
   chunk call's bucket, which the other requests move); each
   with the logits check, launches per forward from the model's structure
   (81; 11 L + 1) and its serving shapes timed;
12. SSM and hybrid serving at `plan`'s tiles: full-width falcon-mamba-7b
   (32 of its 64 Mamba1 layers, the tied LM head on `stream`'s (N, K)
   layout) and zamba2-2.7b (30 of its 54 Mamba2 layers, 5 groups, each
   followed by one shared attention block; `SSM_LAYERS`, cut since phase
   18 (d) came), each with the logits check (torch.matmul's distance
   beside it), the 10 requests chunked, serially and in the wave loop
   (streams identical to the chunked run's), launches per forward from
   the model's structure, none on general, and its serving
   shapes timed; for falcon-mamba-7b also one 700-token prompt past
   max_len = 512, chunked and in the wave loop (identical streams). The
   phase prints its seconds and each model's peak device memory;
13. encoder-decoder and vision serving at `plan`'s tiles: full-width,
   full-depth seamless-m4t-medium (12 + 12 layers, the LM head of vocab
   256206 on padded rows) and qwen2-vl-2b (28 layers, M-RoPE), each
   request carrying its modality input (a source of 24-200 frames; a patch
   grid of up to 32 x 32, one request text-only), each with the logits
   check after admission (the admission's leaves, cross-KV or the patch
   prefix's KV, against the plain run too), the 10 requests chunked,
   serially, in the wave loop and on the paged KV layout (streams
   identical to the chunked run's), launches per forward from the model's
   structure (97 and 197) plus per admission call (96 and 196), none on
   general, the admission's time per request, and its serving shapes
   timed. The phase prints its seconds and each model's peak device
   memory.

14. the predictor-driven fleet scheduler and fault recovery at `plan`'s
   tiles, run between phases 9 and 10 on phase 4's qwen2-7b weights,
   which every member shares: the JAX package's fleet mix (4 batch prompts
   of 384 tokens ahead of 12 interactive prompts of 8-16, budgets 4, 8 or
   32) with an interactive TTFT bound on the fleet model clock; (a) a
   two-member fleet (one member priced on the h100, one on the RTX 4070)
   and each member alone: every request finished once, streams identical,
   launches 197 per forward summed over the members, none on general, the
   fleet ledger holding every request's joules, attainment and J/token
   against the best single engine printed; (b) three members under a fault
   plan on the model clock (artifact corruption: tuning degraded and no
   launch off `plan`'s tile; a stall the straggler detector flags, its rows
   migrating; a crash that loses device state, its requests replaying)
   against the fault-free fleet: nothing lost, migrated and replayed
   streams identical, replays append-only; (c) two paged members with half
   of each pool squeezed while their first requests run: streams identical
   to (a)'s and the pages returned. Its shapes are timed as in phase 5; it
   prints its seconds and peak device memory.

15. training, after every other phase and with their memory freed:
   (a) full-width, full-depth starcoder2-3b (3.18 B params, bf16 params,
   f32 master and moments: a 50.9 GB training state) trained through the
   port's launcher (`repro_torch.launch.train`) for 4 steps of 8 x 512
   seeded tokens with per-block rematerialisation, printing each step's
   ms, loss, grad norm and tokens/s and the peak device memory; gates:
   finite losses and grad norms, every f32 master leaf and every weight
   matrix moved from the seeded init, and per step the launches from the
   model's structure, 721 on wgmma (the forward, its recompute and both
   gradients of every bf16-out product: da on an (N, K) B, dW on a
   transposed A), 2 on split (the f32-out head's pair) with 1 split3, none
   on stream or general; (b) every distinct GEMM of that step, by layout,
   against the plain version (phase 5's bound) and timed as in phase 5
   (the general path once), summed per path per step, with the bf16
   backward's and the split pair's sums beside torch.matmul's (f32 for the
   pair), and the split kernel timed and held bit for bit against its
   plain version; (c) at full width cut to 2 layers, the loss
   and every gradient leaf through the kernel against every product
   through `matmul_ref` (relative L2 at most 5e-2); (d) at the same cut,
   4 steps through the port's loop against 2 steps, a checkpoint written
   to and restored from ``build/chip_smoke_train``, and 2 more: params,
   optimizer state, rng and losses bit for bit; (e) the dry-run of (a)'s
   step (phase 6's check, the measured time the step's after the first,
   the peak beside `train_memory_bytes` too).
16. the other families' training at full width, 3 steps each (the first
   cold), remat on: zamba2-2.7b (hybrid, 8 x 512 tokens), qwen2-vl-2b (vlm,
   2 x 2048: 1,024 patches on a 32 x 32 grid and 1,024 text tokens a row,
   the patches masked from the loss), seamless-m4t-medium (encdec, 8 x
   512 over 128 source frames), olmoe-1b-7b and falcon-mamba-7b (8 x 512,
   each cut to the deepest depth whose `train_memory_bytes` fits 0.9 of
   the card); the LM kinds through the launcher, encdec and vlm through
   `make_train_step`. Per family: (a) gates as phase 15 (a)'s, the
   launches per step from the structure (`_family_launches_per_step`: the
   tied head's forward on wgmma's (N, K) B, the MoE routers' pairs on
   split; none on general), the peak memory beside the estimate;
   (b) its GEMMs timed as phase 15 (b); (c) at 2 layers (zamba2-2.7b: one
   group of 6 Mamba2 blocks and the shared block) every gradient leaf
   through the kernel against the plain version (relative L2 at most
   5e-2); (d) the dry-run of (a)'s step at its depth and batch (phase 15
   (e)'s check).

17. tensor-parallel serving, run after phase 14 with phase 4's weights
   freed: full-width, full-depth qwen2-7b at tp = 2 in two rank processes
   on the one card, a gloo group between them (`launch.mesh.RankPool`;
   NCCL refuses two ranks on one device): each rank makes phase 4's seeded
   weights, cuts its shard (heads, FFN columns, vocabulary) and frees the
   rest, then serves 4 of phase 4's requests at phase 4's engine settings
   with 4 row-parallel chunks. Gates: every stream on both ranks equal to
   phase 4's, token for token; each rank's launches = 365 per forward
   (q, k, v, gate, up, 4 chunks each of o and down, per layer, and the
   head's shard) x its forwards, none on general; its collectives = 282
   per forward. It prints per rank the tokens, forwards and seconds, the
   collectives and their host time, the weights it holds and its peak
   device memory while serving, and the phase's seconds. Then each rank
   runs one decode step over the engine's slots and one 4 x 64 chunk call
   (`_tp_probe`), its collectives counted by op. After phase 12, the same
   for falcon-mamba-7b and zamba2-2.7b at full width and phase 12's depth
   (both ranks building at once) and deepseek-v2-236b at full width and
   phase 11's depth (the ranks building in turn), on one pool of two
   ranks, against phases 12's chunked streams and phase 11's streams of
   the same four requests: launches and collectives per forward from the
   structure (Mamba1's in_proj, x_proj whole, dt_proj and 4 out_proj
   chunks a layer; Mamba2's in_proj and 4 out_proj chunks, the hybrid's
   shared block as a dense layer; MLA's projections, 4 wo chunks, the
   router and the shared experts' gate, up and 4 down chunks; Mamba1's
   x_conv gather beside out_proj's, Mamba2's gated-norm input gather, the
   experts' output gather; 69 and 46 for deepseek-v2-236b). A process
   started after phase 4 makes phases 15 (e)'s and 16 (d)'s meta
   analyses ahead (`_analyse_ahead`), and the mesh dry counts: the probe
   forwards on a dry (1, 2) mesh in gather mode, and the dry-run rank's
   step of 18 (a), (d), (e) and (f) (`_mesh_checks`). After it is joined
   (here), each rank's probe collectives (calls and operand bytes by op)
   must equal the dry count (`phase_tp_mesh`).
18. training under tensor parallelism, last, once phases 15 and 16 have
   handed their device memory back: full-width, full-depth starcoder2-3b
   at tp = 2 in two rank processes on the one card (gloo), through the
   launcher's tp path (psum mode: row-parallel products all-reduced, the
   vocab-parallel loss), phase 15 (a)'s seed, batch and sequence, 2 of
   its 4 steps, checkpoints in a directory of its own. Gates: step 1's
   loss within 1e-2 and its grad norm within 5e-2 (relative) of phase 15
   (a)'s, every step finite and printed beside tp=1's, per rank each
   step's launches (721 wgmma, 2 split, 1 split3, none on stream or
   general) and collectives (157); then every distinct shard GEMM of the
   step against the plain version, timed (phase 15 (b)'s checks). (c) on
   the same two ranks, falcon-mamba-7b (4 of 64 layers), zamba2-2.7b (12
   of 54), seamless-m4t-medium (full) and qwen2-vl-2b (4 of 28) at full
   width, 2 steps each of `make_train_step` at tp = 2, each against one
   tp=1 step of the same cut, seed and batch in the main process: step
   1's loss and grad norm within the same limits, both ranks' losses
   equal, master leaves and weight matrices moved, launches per step from
   the structure (65, 153, 769 and 113 wgmma, 2 split, 1 split3), the
   collectives per step from the structure (27, 90, 175, 27), zamba2's B
   and C gradients bit-identical on both ranks (a hash of their first
   moment), and each distinct shard GEMM new to the phase against the
   plain version. Each (a) step's collectives by op must equal the dry
   count of the dry-run's rank on a dry (1, 2) mesh. (d) on the same two
   ranks, FSDP: full-width qwen2.5-14b (`FSDP_LAYERS` = 2 of 48 layers,
   its published ``fsdp=True``) at (data 2, model 1) with ZeRO-1, 2 steps
   of 4 x 512 tokens, against one step of one rank in the main process
   over the same rows in one backward: step 1's loss and grad norm
   within 1e-4 (relative), both ranks' losses equal, leaves moved,
   launches per step from the structure, each step's collectives (calls
   and operand bytes by op) the dry count on a dry (2, 1) mesh, and each
   distinct GEMM shape new to the phase against the plain version. (e)
   on the same two ranks, Megatron sequence parallelism: (a)'s model,
   seed and batch through the launcher's --sequence-parallel, 1 step:
   step 1's loss within 1e-4 and grad norm within 1e-3 (relative) of
   (a)'s, both ranks' losses equal, (a)'s launches, the collectives the
   dry count on a dry (1, 2) mesh. (f) on the same two ranks, experts
   over "data": full-width olmoe-1b-7b (`EP_LAYERS` = 2 of 16 layers) at
   (data 2, model 1) with ZeRO-1, 2 steps of 4 x 512 tokens, against one
   step of one rank in the main process (the dense dispatch): step 1's
   loss and grad norm within 1e-4, 32 of 64 experts a rank, no expert
   gradient all-reduced, launches from the structure, collectives the
   dry count on a dry (2, 1) mesh; (e)'s and (f)'s new GEMM shapes
   against the plain version. It
   prints per rank the step ms, tokens/s (a), peak device memory beside
   `train_memory_bytes` at tp = 2, the collectives and their host time,
   and the phase's seconds. Two ranks on one card give no multi-card
   speed figure.

After phase 10, ``build/serving_shapes.json`` holds qwen2-7b's and
qwen2.5-14b's serving launches by shape, for ``tools/gemm_sums.py``.

It prints a JSON line of per-kernel numbers (launches summed over phases
4, 12, 13, 14, 17 (both ranks, every model), 15 (a), 16 (a) and 18 (both
ranks), times over phases 5, 12, 13, 14, 15 (a), 16 (a) and 18: the runs
of the port's main
paths; the GEMM's stream, wgmma and split paths and the split kernel; no
launch of those runs takes the general path, the yardstick in each
entry's v3_ms) and, last, the device line.
Without a GPU, or without the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# kernel vs plain version: the tolerances of the JAX package's kernel tests;
# the absolute one is scaled by the output's largest magnitude, since the two
# sum in different orders and the error grows with the partial sums
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the split pair one term at a time at a training shape (`_term_errs`): the
# kernel and matmul_ref sum the same exact fp32 products in other orders,
# each about sqrt(K) roundings to f32 (2^-24 relative) on each side; the
# relative L2 distance may reach K_SUM_ULPS sqrt(K) 2^-24 (about 8x what
# two correct sums give: the tensor cores' own fp32 accumulation is not
# specified to the last bit), never less than the f32 tolerance. A
# dropped or misread term gives about 1.
K_SUM_ULPS = 8
# full-width logits, kernel vs every product through matmul_ref: the two
# differ only in summation order inside each GEMM, but each GEMM output is
# rounded to bf16, so an order difference flips some outputs by one bf16
# step (2^-8 relative) and 28 layers carry that on. A wrong kernel gives a
# relative error near 1 and chance top-1 agreement.
LOGITS_REL_L2_MAX = 5e-2
LOGITS_TOP1_MIN = 0.75
# phase 8: the paper's split needs 2,076 + 519 measured rows; a runtime R2
# below 0.8 on the held-out rows means the pipeline is broken (a broken one
# gives about 0). The paper's own figures (RTX 4070, its Table IV) are
# printed beside the card's, never in their place.
LOOP_MIN_ROWS = 2076 + 519
LOOP_MIN_R2 = 0.8
PAPER_RUNTIME_R2, PAPER_RUNTIME_MEAN_PCT = 0.98, 15.57
# phase 9: rows measured for power (fewer if the probed counter period would
# take the sweep past its budget; about 0.55 s a row, 1.15 s for one whose
# 4 periods read above the card's limit and run on to `nvml.CAPPED_PERIODS`;
# 500 rows since a run whose energy tuner took 282 s for 184 candidates,
# against about 100 s in others, brought the whole script to 1,194 s: 200
# rows fewer at that run's 0.556 s a row take 111 s off, 1,083 s, under the
# 1,100 s cap; phase 9 prints where the tuner's time goes; 450 since phase
# 17, tensor-parallel serving, added about 27 s: 50 rows take it back; 200
# since phase 18 (c) added 15-22 s and runs on slow hosts took 1,237.8 s
# (450 rows, phase 4 at 24.05 tokens/s) and 1,213.9 s (300 rows, held-out
# power R2 0.9107; the host's collectives twice a fast host's): at 0.55 s a
# row, 250 rows fewer take about 137 s off), and the held-out power R2
# below which the pipeline is broken (swapped columns or the simulator's
# power give about 0 or below). The paper's power figures on its RTX 4070
# are printed beside the card's.
POWER_ROWS = 200
POWER_SWEEP_BUDGET_S = 180.0
POWER_MIN_R2 = 0.5
# the largest compute- and memory-bound rows are measured again over this
# many counter periods, beside their sweep window
LONG_WINDOW_PERIODS = 20
PAPER_POWER_R2, PAPER_POWER_MEDIAN_PCT = 0.78, 5.42
# a decode step's host issue time with the tuned lookup may not exceed
# plan's rule's by more than this factor (one dictionary hit per GEMM
# costs microseconds; per-call tuning would cost far more)
HOST_ISSUE_MAX_RATIO = 1.5
# phase 10: the shared system prompt of the prefix workload, in tokens
PREFIX_TOKENS = 256
# the kernels of csrc/tiled_matmul*.cu: stream, wgmma, general (bf16, f32),
# and the split pair's split of its f32 operand
GEMM_KERNELS = ("gemm_stream_kernel", "gemm_wgmma_kernel", "gemm_bf16_kernel",
                "gemm_f32_kernel", "split3_kernel")


def _say(*parts) -> None:
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _close(got: torch.Tensor, want: torch.Tensor, in_dtype) -> tuple:
    """(max abs err, max rel err, ok) under the stated tolerance."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = TOL[in_dtype]
    scale = max(1.0, want.abs().max().item()) if want.numel() else 1.0
    ok = bool((diff <= tol * scale + tol * want.abs()).all())
    rel = (diff / want.abs().clamp_min(1e-6)).max().item() if diff.numel() else 0.0
    return (diff.max().item() if diff.numel() else 0.0), rel, ok


def _gemms_per_forward(cfg) -> int:
    """The hand-written GEMM's launches in one forward, from the model's
    structure (not from `gemm_shape_counts`, the reference's analytical
    estimate, which counts routed experts that are einsums and leaves the
    router and mamba1's x_proj and dt_proj out). Per layer: dense q, k, v,
    o, up, gate (a gated FFN only) and down; moe q, k, v, o and the router;
    mla_moe w_dq and w_uq (or w_uq alone), w_dkv, w_kpe, w_uk, w_uv, wo, the
    router and the shared experts' SwiGLU (gate, up, down); mamba1 in_proj,
    x_proj, dt_proj and out_proj; mamba2 in_proj and out_proj, and for
    hybrid each of the n_layers / attn_every applications of the shared
    block (q, k, v, o, gate, up, down); encdec's decoder self q, k, v, o,
    cross q and o and its FFN; vlm as dense. Then the LM head: 197 for
    qwen2-7b and qwen2-vl-2b, 81 for olmoe-1b-7b, 11 L + 1 for
    deepseek-v2-236b, 257 for falcon-mamba-7b, 172 for zamba2-2.7b, 97 for
    seamless-m4t-medium. An admission call is counted apart
    (`_gemms_per_admission`)."""
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.kind == "encdec":
        return cfg.n_layers * (6 + mlp) + 1
    if cfg.kind == "mamba1":
        return 4 * cfg.n_layers + 1
    if cfg.kind in ("mamba2", "hybrid"):
        shared = (cfg.n_layers // cfg.attn_every) * (
            4 + (3 if cfg.gated_mlp else 2)) if cfg.kind == "hybrid" else 0
        return 2 * cfg.n_layers + shared + 1
    if cfg.kind in ("dense", "vlm"):
        per_layer = 4 + mlp
    elif cfg.kind == "moe":
        per_layer = 5
    else:
        per_layer = ((2 if cfg.q_lora_rank else 1) + 6
                     + (3 if cfg.n_shared_experts else 0))
    return per_layer * cfg.n_layers + 1


def _gemms_per_admission(cfg) -> int:
    """The hand-written GEMM's launches in one prefill-once admission call:
    encdec's encoder (q, k, v, o and the FFN a layer) and each decoder
    layer's cross-KV (k and v), 96 for seamless-m4t-medium; vlm's patch
    prefix through the decoder without the head, 196 for qwen2-vl-2b; 0
    for the other families."""
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.kind == "encdec":
        return cfg.n_encoder_layers * (4 + mlp) + 2 * cfg.n_layers
    if cfg.kind == "vlm":
        return cfg.n_layers * (4 + mlp)
    return 0


def _is_router(cfg, key) -> bool:
    """Whether a recorded launch (M, N, K, in, out, tile) is a router's:
    N = the experts, K = d_model, f32 out."""
    return (bool(cfg.n_experts) and key[1] == cfg.n_experts
            and key[2] == cfg.d_model and key[4] == torch.float32)


SERVED_ARCHS = ("qwen2-7b", "qwen2.5-14b", "codeqwen1.5-7b", "starcoder2-3b",
                "olmoe-1b-7b", "deepseek-v2-236b", "falcon-mamba-7b",
                "zamba2-2.7b", "seamless-m4t-medium", "qwen2-vl-2b")
# each config's row capacity in the serving phases (512 unless listed):
# qwen2-vl-2b's rows hold a 1024-patch image ahead of the prompt
MAX_LEN = {"qwen2-vl-2b": 2048}


def _serving_nk() -> list:
    """(N, K, out dtype) of every projection the ten served configs
    launch: the engine's GEMM fleet (chunked and serial, max_batch 4,
    max_len 512 or `MAX_LEN`, the admit families' admission grid included)
    with bf16 out and the LM head with f32, plus what the MoE
    and Mamba1 families launch beyond that fleet: the router (f32 out),
    deepseek's shared experts' SwiGLU, mamba1's x_proj and dt_proj. (The
    fleet's routed-expert shapes are einsums, never launched; they are
    kept, as plain GEMM shapes.)"""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    out = set()
    for arch in SERVED_ARCHS:
        cfg = get_config(arch)
        ml = MAX_LEN.get(arch, 512)
        fleet = set(ops.serving_gemm_fleet(cfg, max_batch=4, max_len=ml,
                                           chunk_tokens=64, lane_width=8))
        fleet |= set(ops.serving_gemm_fleet(cfg, max_batch=4, max_len=ml))
        for _, n, k in fleet:
            out.add((n, k, torch.float32 if n == cfg.vocab
                     else torch.bfloat16))
        if cfg.n_experts:
            out.add((cfg.n_experts, cfg.d_model, torch.float32))
            f = cfg.d_ff_expert * cfg.n_shared_experts
            if f:
                out |= {(f, cfg.d_model, torch.bfloat16),
                        (cfg.d_model, f, torch.bfloat16)}
        if cfg.kind == "mamba1":
            r = cfg.d_model // 16
            out |= {(r + 2 * cfg.ssm_state, cfg.d_inner, torch.bfloat16),
                    (cfg.d_inner, r, torch.bfloat16)}
    return sorted(out, key=lambda x: (x[0], x[1]))


def _tied_heads() -> list:
    """(N, K) of the LM heads that read the embedding table, stored (N, K):
    the configs that tie their embeddings (falcon-mamba-7b)."""
    from repro_torch.configs import get_config

    return sorted({(cfg.vocab, cfg.d_model) for cfg in map(
        get_config, SERVED_ARCHS) if cfg.tie_embeddings})


def _weight(dev, g, k: int, n: int, dtype) -> torch.Tensor:
    """A random (K, N) weight scaled to O(1) outputs, stored as the port
    stores its weights: rows padded to a multiple of 8 columns
    (`transformer.head_params`; only seamless-m4t-medium's head, N =
    256206, is not a multiple already)."""
    store = torch.empty((k, -(-n // 8) * 8), dtype=dtype, device=dev)
    w = store[:, :n]
    w.copy_(torch.randn((k, n), generator=g, device=dev) / k ** 0.5)
    return w


def _gemm_inputs(dev, g, m: int, n: int, k: int, dtype) -> tuple:
    """Random (M, K) activations and a (K, N) `_weight`."""
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    return a, _weight(dev, g, k, n, dtype)


def phase_build() -> None:
    """Build the port's CUDA sources with nvcc (timed) and load them; print
    ptxas's registers, spills and static shared memory for every kernel,
    and check each compiled tile's shared memory against `BlockConfig`."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tiled_matmul import (_PATH_CODE, BlockConfig,
                                                  TILE_SHAPES)

    info = _build.build()
    lib = _build.load_library()
    _say(f"[build] {info.path.name}: {'built' if info.built else 'cached'} "
         f"in {info.seconds:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, report in _ptxas_report(info.log):
        _say(f"[build]   {name}: {report}")
    wrong = []
    for tile in TILE_SHAPES:
        cfg = BlockConfig(*tile)
        for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            if code == 0 and cfg.path != "general":
                continue
            have = lib.repro_tiled_matmul_smem(_PATH_CODE[cfg.path], code,
                                               *tile)
            want = cfg.smem_bytes(torch.tensor([], dtype=dt).element_size())
            _say(f"[build] {cfg.path} tile {tile} {str(dt).split('.')[-1]}: "
                 f"{have} bytes of shared memory per block (BlockConfig "
                 f"says {want})")
            if have != want:
                wrong.append((tile, dt))
    if wrong:
        raise SystemExit(f"BlockConfig.smem_bytes disagrees with the kernel "
                         f"for {wrong}")


def _ptxas_report(log: str) -> list:
    """(kernel, "registers ...; spills ...") per compiled kernel from the
    `-Xptxas -v` log, with each mangled name cut to the kernel and its
    template arguments (output type, the integers, the general path's
    vector-tile flag, the stream path's (N, K) layout flag or wgmma's
    layout, nn, nt, tn or tt); the split kernel by its name."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"gemm_\w+?_kernel|split3_kernel", mangled)
            ints = re.findall(r"Li(\d+)E", mangled)
            flags = re.findall(r"Lb([01])E", mangled)
            if "wgmma" in mangled:
                flag = "," + "".join("nt"[int(f)] for f in flags)
            elif "Lb1E" in mangled:
                flag = ",(N, K) B" if "stream" in mangled else ",vector tiles"
            else:
                flag = ""
            name = (f"{base.group(0) if base else mangled}<"
                    f"{'bf16' if 'bfloat16' in mangled else 'f32'} out"
                    f"{''.join(',' + i for i in ints)}{flag}>"
                    if "gemm_" in mangled else
                    (base.group(0) if base else mangled))
            spills = ""
        elif name and "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            out.append((name, line.split(":", 1)[-1].strip() + "; " + spills))
            name = None
    return out


def _run_path(fn, *args, **kw):
    """(path, result) of one tiled_matmul call: the path whose launch
    counter moved."""
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    before = dict(tiled_matmul.launches_by_path)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    moved = [p for p, n in tiled_matmul.launches_by_path.items()
             if n != before[p]]
    if len(moved) != 1:
        raise SystemExit(f"one call moved the path counters {moved}")
    return moved[0], out


def phase_kernel_cases(dev) -> None:
    """The JAX package's kernel-test cases and each path's boundary cases,
    kernel vs plain version, on every path and tile that takes the case:
    the path `plan` chooses, the general path forced, and every fast-path
    tile of `candidate_tiles` that takes the case forced where `plan` chose
    a fast path (wgmma's transposed layouts and the split pair included).
    Each fast-path result must also be bit-identical over two launches,
    and the split kernel bit-equal to its plain version."""
    from repro_torch.kernels.ref import matmul_ref, split3_ref
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG,
                                                  candidate_tiles, split3,
                                                  tiled_matmul)

    g = torch.Generator(dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = []   # (label, in dtype, kwargs for both functions, a, b, c)
    for dt in (torch.float32, bf16):
        for m, n, k in [(16, 128, 128), (32, 256, 256), (40, 200, 300),
                        (1, 128, 512), (128, 1, 64), (17, 129, 257)]:
            cases.append((f"shape {m}x{n}x{k} {dt}", dt, {},
                          rand((m, k), dt), rand((k, n), dt), None))
    for ta in (False, True):
        for tb in (False, True):
            m, n, k = 48, 160, 96
            cases.append((f"layout ta={ta} tb={tb}", torch.float32,
                          dict(transpose_a=ta, transpose_b=tb),
                          rand((k, m) if ta else (m, k), torch.float32),
                          rand((n, k) if tb else (k, n), torch.float32), None))
    for alpha, beta in [(2.0, 0.0), (0.5, 0.5), (1.0, 1.0)]:
        cases.append((f"alpha={alpha} beta={beta} with C", torch.float32,
                      dict(alpha=alpha, beta=beta),
                      rand((32, 64), torch.float32),
                      rand((64, 128), torch.float32),
                      rand((32, 128), torch.float32)))
    cases.append(("bf16 in, f32 out", bf16, dict(out_dtype=torch.float32),
                  rand((32, 64), bf16), rand((64, 128), bf16), None))
    cases.append(("bf16 in, bf16 out, f32 C, beta=0.3", bf16, dict(beta=0.3),
                  rand((16, 32), bf16), rand((32, 128), bf16),
                  rand((16, 128), torch.float32)))
    cases.append(("bf16 16-byte vector tiles 64x256x512", bf16, {},
                  rand((64, 512), bf16), rand((512, 256), bf16), None))
    cases.append(("bf16 views of 16-byte rows, ragged last vector", bf16, {},
                  rand((70, 296), bf16)[:, :293],
                  rand((293, 208), bf16)[:, :203], None))
    cases.append(("bf16 view off a 16-byte boundary", bf16, {},
                  rand((20, 136), bf16)[:, 1:129], rand((128, 72), bf16),
                  None))
    cases.append(("K=4096 f32", torch.float32, {},
                  rand((8, 4096), torch.float32),
                  rand((4096, 128), torch.float32), None))
    cases.append(("K=4096 bf16 0.01s, f32 out", bf16,
                  dict(out_dtype=torch.float32),
                  torch.full((8, 4096), 0.01, dtype=bf16, device=dev),
                  torch.full((4096, 128), 0.01, dtype=bf16, device=dev), None))
    # the fast paths' boundaries: M around the 8-row stream tiles, the
    # stream/wgmma threshold and the 128-row wgmma tile; N = 200 and 136
    # not a multiple of any tile; K = 296 (4.6 K tiles, split in 2) and
    # K = 40 (one short K tile); beta with C; f32 and bf16 out
    for m in (1, 4, 8, 63, 64, 65, 127, 128, 129):
        cases.append((f"edge M={m} N=200 K=296, alpha=0.5 beta=0.5 with f32 "
                      "C, f32 out", bf16,
                      dict(alpha=0.5, beta=0.5, out_dtype=torch.float32),
                      rand((m, 296), bf16), rand((296, 200), bf16),
                      rand((m, 200), torch.float32)))
    for m in (4, 65, 129):
        cases.append((f"edge M={m} N=136 K=40, bf16 out", bf16, {},
                      rand((m, 40), bf16), rand((40, 136), bf16), None))
    for m in (8, 128):
        cases.append((f"split-K M={m} N=520 K=3584, beta=1 with bf16 C", bf16,
                      dict(beta=1.0), rand((m, 3584), bf16),
                      rand((3584, 520), bf16), rand((m, 520), bf16)))

    def rows(r, c, dtype, scale=1.0):
        """An (r, c) view of rows padded to a multiple of 8 elements."""
        store = (torch.randn((r, -(-c // 8) * 8), generator=g, device=dev)
                 * scale).to(dtype)
        return store[:, :c]

    # wgmma's transposed layouts in bf16 (nt: B stored (N, K); tn: A
    # stored (K, M); tt: both): M, N and K around the 64-wide boxes and the
    # 128-row tile, split K (few output tiles over deep K: spread
    # segments), f32 out, and bf16 out with beta and a bf16 C; operands on
    # rows padded to a multiple of 8 elements, ragged views of them
    for ta, tb in ((False, True), (True, False), (True, True)):
        lay = ("t" if ta else "n") + ("t" if tb else "n")
        for i, (m, n, k) in enumerate(((64, 65, 129), (65, 128, 64),
                                       (128, 129, 65), (129, 64, 128),
                                       (8, 136, 3584), (130, 520, 3584))):
            out, beta = ((torch.float32, 0.0), (bf16, 0.5))[i % 2]
            cases.append((
                f"layout {lay} M={m} N={n} K={k}, {str(out)[6:]} out"
                + (", beta=0.5 with bf16 C" if beta else ""), bf16,
                dict(transpose_a=ta, transpose_b=tb, out_dtype=out,
                     beta=beta),
                rows(k, m, bf16) if ta else rows(m, k, bf16),
                rows(n, k, bf16, k ** -0.5) if tb
                else rows(k, n, bf16, k ** -0.5),
                rand((m, n), bf16) if beta else None))
    # the split pair: an f32 operand (its three bf16 terms) times a bf16
    # one, the f32 one A or B, on the four layouts; a ragged shape with f32
    # out, held to the f32 tolerance, and a split-K one with bf16 out, beta
    # and C
    for side in ("a", "b"):
        dta, dtb = ((torch.float32, bf16) if side == "a"
                    else (bf16, torch.float32))
        for ta in (False, True):
            for tb in (False, True):
                lay = ("t" if ta else "n") + ("t" if tb else "n")
                for m, n, k, out in ((65, 200, 296, torch.float32),
                                     (129, 520, 3584, bf16)):
                    beta = 0.5 if out == bf16 else 0.0
                    cases.append((
                        f"split pair ({side} f32) {lay} M={m} N={n} K={k}, "
                        f"{str(out)[6:]} out", out,
                        dict(transpose_a=ta, transpose_b=tb, out_dtype=out,
                             beta=beta),
                        rows(k, m, dta) if ta else rows(m, k, dta),
                        rows(n, k, dtb, k ** -0.5) if tb
                        else rows(k, n, dtb, k ** -0.5),
                        rand((m, n), bf16) if beta else None))
    failed, seen = [], collections.Counter()
    for label, dt, kw, a, b, c in cases:
        c_ref = c.to(kw.get("out_dtype") or a.dtype) if c is not None else c
        want = matmul_ref(a, b, c_ref, **kw)
        chosen, _ = _run_path(tiled_matmul, a, b, c, **kw)
        configs = [None, DEFAULT_CONFIG]
        if chosen != "general":
            # stream reads neither a transposed A nor a split operand
            stream = not kw.get("transpose_a") and a.dtype == b.dtype
            configs += [t for t in candidate_tiles(want.shape[0])
                        if stream or t.path == "wgmma"]
        for cfg in configs:
            path, got = _run_path(tiled_matmul, a, b, c, config=cfg, **kw)
            err, rel, ok = _close(got, want, dt)
            same = True
            if path != "general":
                same = torch.equal(got, _run_path(tiled_matmul, a, b, c,
                                                  config=cfg, **kw)[1])
            how = "chosen by plan" if cfg is None else f"forced {cfg.as_tuple()}"
            _say(f"[kernel {path}] {label} ({how}): max_abs {err:.3g} "
                 f"max_rel {rel:.3g} tol {TOL[dt]:g}"
                 f"{'' if path == 'general' else f', rerun bit-identical {same}'}"
                 f" {'ok' if ok and same else 'FAIL'}")
            seen[path] += 1
            if not (ok and same):
                failed.append((path, label))
    # a tied LM head's layout: B stored (N, K), K-contiguous, on stream at
    # M <= 64 (and on general, forced); N = 65024 (falcon-mamba-7b's vocab)
    # and a ragged N, K = 4096
    for n in (65024, 1000):
        table = (torch.randn((n, 4096), generator=g, device=dev)
                 / 64.0).to(bf16)
        for m in (1, 4, 8, 9, 64):
            a = rand((m, 4096), bf16)
            for out in (torch.float32, bf16):
                label = (f"transpose_b M={m} N={n} K=4096, "
                         f"{str(out).split('.')[-1]} out")
                want = matmul_ref(a, table, transpose_b=True, out_dtype=out)
                for cfg in (None, DEFAULT_CONFIG):
                    path, got = _run_path(tiled_matmul, a, table,
                                          transpose_b=True, config=cfg,
                                          out_dtype=out)
                    err, rel, ok = _close(got, want, bf16)
                    same = True
                    if cfg is None:
                        ok = ok and path == "stream"
                        same = torch.equal(got, _run_path(
                            tiled_matmul, a, table, transpose_b=True,
                            out_dtype=out)[1])
                    how = ("chosen by plan" if cfg is None
                           else f"forced {cfg.as_tuple()}")
                    _say(f"[kernel {path}] {label} ({how}): max_abs "
                         f"{err:.3g} max_rel {rel:.3g} tol {TOL[bf16]:g}"
                         f"{'' if cfg else f', rerun bit-identical {same}'}"
                         f" {'ok' if ok and same else 'FAIL'}")
                    seen[path] += 1
                    if not (ok and same):
                        failed.append((path, label))
        del table
    # an untied head whose vocab is not a multiple of 8 (seamless-m4t-medium,
    # N = 256206) on its padded rows (ldb 256208): stream at M <= 64 with
    # f32 out, the split-K epilogue's scalar tail (N % 4 = 2), and general
    # forced
    head = _weight(dev, g, 1024, 256206, bf16)
    for m in (1, 4, 8, 9, 64):
        a = rand((m, 1024), bf16)
        label = f"padded head M={m} N=256206 K=1024 ldb 256208, f32 out"
        want = matmul_ref(a, head, out_dtype=torch.float32)
        for cfg in (None, DEFAULT_CONFIG):
            path, got = _run_path(tiled_matmul, a, head, config=cfg,
                                  out_dtype=torch.float32)
            err, rel, ok = _close(got, want, bf16)
            same = True
            if cfg is None:
                ok = ok and path == "stream"
                same = torch.equal(got, _run_path(
                    tiled_matmul, a, head, out_dtype=torch.float32)[1])
            how = ("chosen by plan" if cfg is None
                   else f"forced {cfg.as_tuple()}")
            _say(f"[kernel {path}] {label} ({how}): max_abs {err:.3g} "
                 f"max_rel {rel:.3g} tol {TOL[bf16]:g}"
                 f"{'' if cfg else f', rerun bit-identical {same}'}"
                 f" {'ok' if ok and same else 'FAIL'}")
            seen[path] += 1
            if not (ok and same):
                failed.append((path, label))
    del head
    # the split pair's split kernel against its plain version, bit for bit:
    # a ragged matrix, a strided view and starcoder2-3b's head cotangent
    # (8 x 512 rows of its 49152-entry vocabulary)
    for r, cols, view in ((37, 203, False), (64, 520, True),
                          (4096, 49152, False)):
        x = torch.randn((r, cols + 24 if view else cols), generator=g,
                        device=dev) * 4.0
        x = x[:, :cols] if view else x
        got, want = split3(x).terms, split3_ref(x)
        same = torch.equal(got, want)
        recon = torch.equal(got.double().sum(0), x.double())
        _say(f"[kernel split3] {r}x{cols}{' view' if view else ''}: "
             f"bit-equal to the plain version {same}, hi + mid + lo == x "
             f"{recon} {'ok' if same and recon else 'FAIL'}")
        if not (same and recon):
            failed.append(("split3", f"{r}x{cols}"))
        del x, got, want
    _say(f"[kernel] cases run per path: {dict(seen)}")
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    if set(seen) != {"stream", "wgmma", "split", "general"}:
        raise SystemExit(f"a path ran no case: {dict(seen)}")
    _row_invariance(dev)


ROW_INVARIANCE_M = (1, 8, 64, 65, 128, 512)


def _norm_rows(dev, g) -> None:
    """rmsnorm (plain torch: its mean square is a CUDA reduction whose
    thread layout follows the row count) gives row 0 the same bits at 1,
    4, 16 and 512 rows, for the served widths: the exact stream gates of
    phases 10 and 11 rest on it as on the GEMM's row invariance."""
    from repro_torch.models.layers import rmsnorm

    for d in (1024, 1536, 2048, 3072, 3584, 4096, 5120):
        x = torch.randn((512, d), generator=g, device=dev).to(torch.bfloat16)
        p = {"scale": torch.ones(d, dtype=torch.bfloat16, device=dev)}
        rows = [rmsnorm(p, x[:m], 1e-6)[0] for m in (1, 4, 16, 512)]
        same = all(torch.equal(r, rows[0]) for r in rows)
        _say(f"[kernel rows] rmsnorm over d = {d}, row 0 at 1, 4, 16 and 512 "
             f"rows bit-equal: {same}")
        if not same:
            raise SystemExit(f"rmsnorm's row bits depend on the row count at "
                             f"d = {d}")


def _attention_rows(dev, g) -> None:
    """Fault C2: attention (`layers._sdpa`) gives row 0 the same bits at
    one position in a decode step (1 query), 8-, 16- and 64-query chunks
    and a 300-query prefill, at batch 1 to 8, for the head layouts of the
    served attention configs. Beside it, how often the two f32 products
    `_sdpa_block` hands to cuBLAS (weights . v and q . k, on random
    operands) give row 0 other bits than a 4 x 512 call's when called
    unpadded at (batch, queries) in {1, 2, 3, 4, 8} x {1, 8, 16, 32, 64,
    300, 512}: what the card's padding of short calls to `Q_MIN_CUDA`
    queries removes."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _sdpa

    layouts = sorted({(c.n_heads, c.kv_heads, c.hd) for c in map(
        get_config, SERVED_ARCHS) if c.kind not in ("mamba1", "mamba2")
        and not c.kv_lora_rank})
    bad = []
    for H, KV, hd in layouts:
        R = H // KV
        # the products alone, unpadded, on dense random operands
        v = torch.randn((8, 512, KV, hd), generator=g, device=dev)
        k = torch.randn((8, 512, KV, hd), generator=g, device=dev)
        w = torch.rand((8, KV, R, 512, 512), generator=g, device=dev)
        qf = torch.randn((8, 512, KV, R, hd), generator=g, device=dev)
        ref = (torch.einsum("bgrqk,bkgh->bqgrh", w[:4], v[:4])[0, :1],
               torch.einsum("bqgrh,bkgh->bgrqk", qf[:4], k[:4])[0, :, :, :1])
        raw = collections.Counter()
        for nb in (1, 2, 3, 4, 8):
            for sq in (1, 8, 16, 32, 64, 300, 512):
                pv = torch.einsum("bgrqk,bkgh->bqgrh", w[:nb, :, :, :sq],
                                  v[:nb])[0, :1]
                qk = torch.einsum("bqgrh,bkgh->bgrqk", qf[:nb, :sq],
                                  k[:nb])[0, :, :, :1]
                raw["cases"] += 1
                if not torch.equal(pv, ref[0]):
                    raw["w.v"] += 1
                    raw[f"w.v at {sq} queries"] += 1
                if not torch.equal(qk, ref[1]):
                    raw["q.k"] += 1
                    raw[f"q.k at {sq} queries"] += 1
        del v, k, w, qf
        # attention itself, as the port runs it
        q = torch.randn((8, 512, H, hd), generator=g, device=dev).to(
            torch.bfloat16)
        kb = torch.randn((8, 512, KV, hd), generator=g, device=dev).to(
            torch.bfloat16)
        vb = torch.randn((8, 512, KV, hd), generator=g, device=dev).to(
            torch.bfloat16)
        pos = 200
        want = _sdpa(q[:4, :300], kb[:4], vb[:4], causal=True, q_offset=0,
                     kv_len=300)[0, pos]
        for nb in (1, 2, 3, 4, 8):
            for sq in (1, 8, 16, 64):
                off = torch.full((nb,), pos, device=dev)
                got = _sdpa(q[:nb, pos:pos + sq], kb[:nb], vb[:nb],
                            causal=True, q_offset=off, kv_len=off + sq)[0, 0]
                if not torch.equal(got, want):
                    bad.append((H, KV, hd, nb, sq))
        del q, kb, vb
        _say(f"[kernel rows] attention heads {H}/{KV} of {hd}: unpadded f32 "
             f"products, row 0 off the 4 x 512 call's bits in "
             f"{dict(sorted(raw.items()))}; `_sdpa` at position {pos}, "
             f"decode and 8/16/64-query chunks at batch 1-8 against a "
             f"300-query prefill: bit-equal "
             f"{not any(b[:3] == (H, KV, hd) for b in bad)}")
    if bad:
        raise SystemExit(f"attention's row bits depend on the call: {bad}")


def _encoder_attention_rows(dev, g) -> None:
    """The encoder's attention is non-causal over keys masked per row
    (`kv_len`), and its key count is the admission's bucket, which depends
    on the requests admitted with it (8-512 keys at max_len 512). For the
    encdec configs' head layout, row 0 with 6, 24 and 200 valid keys, in
    calls of every bucket Sk that holds them (Sk queries, as the encoder
    runs) at batch 1-8 (the other rows of random lengths), must give the
    same bits as its first call: otherwise a request's encoding, and so
    its stream, would depend on who shares its admission."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _sdpa

    layouts = sorted({(c.n_heads, c.kv_heads, c.hd) for c in map(
        get_config, SERVED_ARCHS) if c.kind == "encdec"})
    bad = []
    for H, KV, hd in layouts:
        q = torch.randn((8, 512, H, hd), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((8, 512, KV, hd), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        cases = 0
        for n in (6, 24, 200):
            lens = torch.randint(1, 513, (8,), generator=g, device=dev)
            want = None
            for sk in (8, 16, 32, 64, 128, 256, 512):
                if sk < n:
                    continue
                for nb in (1, 2, 3, 4, 8):
                    kl = lens[:nb].clamp(max=sk)
                    kl[0] = n
                    got = _sdpa(q[:nb, :sk], k[:nb, :sk], v[:nb, :sk],
                                causal=False, kv_len=kl)[0, :n]
                    want = got if want is None else want
                    cases += 1
                    if not torch.equal(got, want):
                        bad.append((H, KV, hd, n, sk, nb))
        del q, k, v
        _say(f"[kernel rows] encoder attention heads {H}/{KV} of {hd}, row 0 "
             f"with 6/24/200 valid keys in {cases} calls over Sk 8-512 and "
             f"batch 1-8 bit-equal to its first call: "
             f"{not any(b[:3] == (H, KV, hd) for b in bad)}")
    if bad:
        raise SystemExit(f"encoder attention's row bits depend on the call: "
                         f"{bad[:10]}")


# tensor-parallel degrees and the row-parallel chunk count phase 3 holds a
# shard's columns and a rank's attention heads to the whole product's bits
TP_DEGREES = (2, 4)
TP_CHUNKS = 4
SHARD_M = (1, 4, 8, 64, 65, 128)


def _shard_columns(dev, g) -> None:
    """Tensor parallelism's bits: for every serving (N, K) of qwen2-7b
    (its fleet, `_serving_nk`'s rule) at tp = 2 and 4, each rank's
    contiguous column shard (`sharding.local_copy`), whole and cut into
    `TP_CHUNKS` column chunks as `tp.row_parallel_gather` cuts it (views of
    the shard), launched with ``segments_n`` = the whole N, must give
    bit for bit the same columns of the unsharded product, at M in
    `SHARD_M`: a tp=2 engine's streams rest on it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import local_copy
    from repro_torch.distributed.tp import _n_chunks
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    cfg = get_config("qwen2-7b")
    fleet = set(ops.serving_gemm_fleet(cfg, max_batch=4, max_len=512,
                                       chunk_tokens=64, lane_width=8))
    nks = sorted({(n, k) for _, n, k in fleet})
    t0 = time.perf_counter()
    bad, cases = [], 0
    for n, k in nks:
        out = torch.float32 if n == cfg.vocab else torch.bfloat16
        a = torch.randn((max(SHARD_M), k), generator=g, device=dev).to(
            torch.bfloat16)
        b = _weight(dev, g, k, n, torch.bfloat16)
        want = {m: tiled_matmul(a[:m], b, out_dtype=out) for m in SHARD_M}
        for tp in TP_DEGREES:
            for rank in range(tp):
                w = local_copy(b, 1, rank, tp)
                n_loc = w.shape[1]
                for chunks in (1, TP_CHUNKS):
                    c = _n_chunks(n_loc, chunks)
                    width = n_loc // c
                    for i in range(c):
                        lo = rank * n_loc + i * width
                        for m in SHARD_M:
                            got = tiled_matmul(
                                a[:m], w[:, i * width:(i + 1) * width],
                                out_dtype=out, segments_n=n)
                            cases += 1
                            if not torch.equal(got,
                                               want[m][:, lo:lo + width]):
                                bad.append((m, n, k, tp, rank, c, i))
                del w
        del a, b, want
    torch.cuda.synchronize()
    _say(f"[kernel rows] tensor-parallel columns: {len(nks)} serving (N, K) "
         f"of qwen2-7b at tp {TP_DEGREES}, each rank's shard whole and in "
         f"{TP_CHUNKS} chunks (segments_n = N), M in {SHARD_M}: {cases} "
         f"calls bit-equal to the unsharded product's columns {not bad} "
         f"({len(bad)} mismatches) in {time.perf_counter() - t0:.1f} s")
    if bad:
        raise SystemExit(f"a shard's columns differ from the whole "
                         f"product's: {bad[:10]}")


def _shard_heads(dev, g) -> None:
    """Attention (`layers._sdpa`) gives each head the same bits whether the
    call holds all of qwen2-7b's 28 query heads (4 KV heads) or one rank's
    14 (2) or 7 (1) at tp = 2 and 4: a decode step (1 query, at per-row
    positions), a 64-query chunk and a 300-query prefill, at batch 1, 4
    and 8, dense and with a page-validity mask."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _sdpa

    cfg = get_config("qwen2-7b")
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = torch.randn((8, 300, H, hd), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((8, 512, KV, hd), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    valid = torch.rand((8, 512), generator=g, device=dev) > 0.1
    bad, cases = [], 0
    for nb in (1, 4, 8):
        pos = torch.randint(300, 448, (nb,), generator=g, device=dev)
        for sq, kw in ((1, dict(q_offset=pos, kv_len=pos + 1)),
                       (64, dict(q_offset=pos, kv_len=pos + 64)),
                       (300, dict(q_offset=0, kv_len=300))):
            for mask in (None, valid[:nb]):
                want = _sdpa(q[:nb, :sq], k[:nb], v[:nb], causal=True,
                             kv_valid=mask, **kw)
                for tp in TP_DEGREES:
                    h, kvh = H // tp, KV // tp
                    for r in range(tp):
                        got = _sdpa(q[:nb, :sq, r * h:(r + 1) * h],
                                    k[:nb, :, r * kvh:(r + 1) * kvh],
                                    v[:nb, :, r * kvh:(r + 1) * kvh],
                                    causal=True, kv_valid=mask, **kw)
                        cases += 1
                        if not torch.equal(got,
                                           want[:, :, r * h:(r + 1) * h]):
                            bad.append((nb, sq, mask is not None, tp, r))
    del q, k, v
    _say(f"[kernel rows] attention heads {H}/{KV} of {hd} against one "
         f"rank's {H // 2}/{KV // 2} and {H // 4}/{KV // 4} (tp 2 and 4): "
         f"{cases} calls (decode, 64- and 300-query chunks, batch 1/4/8, "
         f"dense and paged masks) bit-equal {not bad}")
    if bad:
        raise SystemExit(f"attention's head bits depend on the heads in the "
                         f"call: {len(bad)} of {cases} calls, {bad[:20]}")


# the families phase 17 serves beside qwen2-7b, and the archs whose
# sharded projections and scans phase 3 holds to the whole's bits
TP_FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b", "deepseek-v2-236b")
# the row-parallel (gather-mode) projections: column-sharded, chunked
TP_ROW_LEAVES = ("wo", "w_down", "out_proj")
# the MLA decompressions run over the cache's rows: B x max_len
DECOMPRESS_M = (512, 2048)


def _shard_parts(dev, g) -> None:
    """Tensor parallelism's bits on the SSM, hybrid and MLA projections:
    for every column-sharded GEMM weight of one layer (and the untied LM
    head) of falcon-mamba-7b, zamba2-2.7b and deepseek-v2-236b at full
    width, each rank's shard at tp = 2 and 4, cut by its parts
    (`sharding.axis_parts`: Mamba1's in_proj [x | z], Mamba2's [z | x | B
    C | dt] with B and C whole), whole and, for a row-parallel projection,
    in `TP_CHUNKS` column chunks, launched with ``segments_n`` = the whole
    N, must give bit for bit the same columns of the unsharded product (the
    rank's parts of its columns), at M in `SHARD_M` (and `DECOMPRESS_M`
    for MLA's w_uk and w_uv). Mamba1's dt_proj reads its input as the
    strided view of x_proj's output that the block gives it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.tp import _n_chunks
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.models.registry import get_model

    t0 = time.perf_counter()
    bad, cases, weights = [], 0, 0
    for arch in TP_FAMILY_ARCHS:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=(
            cfg.attn_every if cfg.kind == "hybrid" else 1))
        meta = get_model(cfg).init(cfg, None, device="meta")
        for tp in TP_DEGREES:
            axes = sharding.param_axes(meta, tp, cfg=cfg)
            for name, p in meta.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if (p.dim() != 2 or axes[name] != 1
                        or name.startswith(("embed", "blocks.")) and not
                        name.startswith("blocks.0.")):
                    continue
                k, n = p.shape
                out = torch.float32 if n == cfg.vocab else torch.bfloat16
                ms = SHARD_M + (DECOMPRESS_M if leaf in ("w_uk", "w_uv")
                                else ())
                a = torch.randn((max(ms), k + 32), generator=g,
                                device=dev).to(torch.bfloat16)
                # dt_proj's input: the first r columns of x_proj's output
                a = a[:, :k] if leaf == "dt_proj" else a[:, :k].contiguous()
                b = _weight(dev, g, k, n, torch.bfloat16)
                parts = sharding.axis_parts(leaf, n, cfg)
                want = {m: tiled_matmul(a[:m], b, out_dtype=out) for m in ms}
                weights += tp == TP_DEGREES[0]
                for rank in range(tp):
                    w = sharding.local_copy(b, 1, rank, tp, parts)
                    n_loc = w.shape[1]
                    for chunks in ((1, TP_CHUNKS) if leaf in TP_ROW_LEAVES
                                   else (1,)):
                        c = _n_chunks(n_loc, chunks)
                        width = n_loc // c
                        for m in ms:
                            cols = sharding.local_copy(want[m], 1, rank, tp,
                                                       parts)
                            for i in range(c):
                                got = tiled_matmul(
                                    a[:m], w[:, i * width:(i + 1) * width],
                                    out_dtype=out, segments_n=n)
                                cases += 1
                                if not torch.equal(got, cols[
                                        :, i * width:(i + 1) * width]):
                                    bad.append((arch, name, m, tp, rank, c,
                                                i))
                    del w
                del a, b, want
    torch.cuda.synchronize()
    _say(f"[kernel rows] tensor-parallel parts: {weights} column-sharded "
         f"weights of {', '.join(TP_FAMILY_ARCHS)} (one layer and the head) "
         f"at tp {TP_DEGREES}, each rank's parts whole and row-parallel ones "
         f"in {TP_CHUNKS} chunks (segments_n = N), M in {SHARD_M} (and "
         f"{DECOMPRESS_M} for w_uk, w_uv): {cases} calls bit-equal to the "
         f"unsharded product's columns {not bad} ({len(bad)} mismatches) in "
         f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise SystemExit(f"a shard's columns differ from the whole "
                         f"product's: {bad[:10]}")


def _shard_scans(dev, g) -> None:
    """The SSM scans and MLA attention give a rank's channels or heads the
    whole call's bits, at tp = 2 and 4, batch 1 and 4, a 64-token prefill
    chunk (right-padded rows under `seq_lens`, carried state, the serve
    grain 8) and a single decode step: falcon-mamba-7b's Mamba1 channels
    (8192 of d_state 16) through the causal conv, silu and
    `ssm.selective_scan`; zamba2-2.7b's 80 SSD heads (headdim 64, d_state
    64) through `ssm.ssd_heads`; deepseek-v2-236b's 128 MLA heads (128 +
    64 RoPE) through `moe.mla_attention` over 512 cached positions, dense
    and under a page-validity mask."""
    import math

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import moe, ssm

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    bad: list = []
    cases = collections.Counter()

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    def check(tag, want, got):
        cases[tag] += 1
        if not all(torch.equal(w, x) for w, x in zip(want, got)):
            bad.append(tag)

    # Mamba1 channels
    cfg = get_config("falcon-mamba-7b")
    di, ds, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
    for nb in (1, 4):
        for S in (64, 1):
            x_ = rnd(nb, S, di, dtype=bf16)
            w, b = rnd(di, K, dtype=bf16, scale=0.5), rnd(di, dtype=bf16)
            hist = rnd(nb, K - 1, di)
            dt = rnd(nb, S, di)
            s = {"dt_bias": rnd(di, dtype=bf16), "D": rnd(di),
                 "A_log": torch.log(torch.arange(
                     1, ds + 1, dtype=torch.float32, device=dev)).expand(
                     di, ds).contiguous()}
            Bm, Cm = rnd(nb, S, ds, dtype=bf16), rnd(nb, S, ds, dtype=bf16)
            h0 = rnd(nb, di, ds)
            lens = torch.randint(1, S + 1, (nb,), generator=g, device=dev)
            kw = dict(single_step=S == 1, chunk=ssm.SERVE_CHUNK,
                      seq_mask=None if S == 1 else ssm._seq_mask(lens, S))

            def run(sl):
                xc = F.silu(ssm.causal_conv(x_[..., sl], w[sl], b[sl],
                                            hist[..., sl]).float()).to(bf16)
                return ssm.selective_scan(
                    xc, dt[..., sl], {k: v[sl] for k, v in s.items()},
                    Bm, Cm, h0[:, sl], **kw)

            want = run(slice(None))
            for tp in TP_DEGREES:
                n = di // tp
                for r in range(tp):
                    sl = slice(r * n, (r + 1) * n)
                    check(f"mamba1 B={nb} S={S}",
                          (want[0][..., sl], want[1][:, sl]), run(sl))
    # Mamba2 heads
    cfg = get_config("zamba2-2.7b")
    P, N = cfg.ssm_headdim, cfg.ssm_state
    H = cfg.d_inner // P
    for nb in (1, 4):
        for S in (64, 1):
            xs = rnd(nb, S, H, P, dtype=bf16)
            dt_raw = rnd(nb, S, H, dtype=bf16)
            s = {"dt_bias": rnd(H, dtype=bf16), "A_log": rnd(H, scale=0.5),
                 "D": rnd(H)}
            Bm, Cm = rnd(nb, S, N, dtype=bf16), rnd(nb, S, N, dtype=bf16)
            h0 = rnd(nb, H, N, P)
            lens = torch.randint(1, S + 1, (nb,), generator=g, device=dev)
            kw = dict(single_step=S == 1, chunk=ssm.SERVE_CHUNK,
                      seq_lens=None if S == 1 else lens)

            def run(sl):
                return ssm.ssd_heads(xs[:, :, sl], dt_raw[..., sl],
                                     {k: v[sl] for k, v in s.items()},
                                     Bm, Cm, h0[:, sl], **kw)

            want = run(slice(None))
            for tp in TP_DEGREES:
                n = H // tp
                for r in range(tp):
                    sl = slice(r * n, (r + 1) * n)
                    check(f"ssd B={nb} S={S}",
                          (want[0][:, :, sl], want[1][:, sl]), run(sl))
    # MLA heads
    cfg = get_config("deepseek-v2-236b")
    H, hd, pe, Sk = cfg.n_heads, cfg.hd, cfg.rope_head_dim, 512
    valid = torch.rand((4, Sk), generator=g, device=dev) > 0.1
    for nb in (1, 4):
        k_c, v = rnd(nb, Sk, H, hd, dtype=bf16), rnd(nb, Sk, H, hd, dtype=bf16)
        k_pe = rnd(nb, Sk, 1, pe, dtype=bf16)
        pos = torch.randint(200, 440, (nb,), generator=g, device=dev)
        for S in (1, 64):
            q_c, q_pe = rnd(nb, S, H, hd, dtype=bf16), rnd(nb, S, H, pe,
                                                          dtype=bf16)
            for mask in (None, valid[:nb]):
                kw = dict(q_offset=pos, kv_len=pos + S, kv_valid=mask,
                          scale=1.0 / math.sqrt(hd + pe))
                want = moe.mla_attention(q_c, q_pe, k_c, v, k_pe, **kw)
                for tp in TP_DEGREES:
                    n = H // tp
                    for r in range(tp):
                        sl = slice(r * n, (r + 1) * n)
                        got = moe.mla_attention(
                            q_c[:, :, sl], q_pe[:, :, sl], k_c[:, :, sl],
                            v[:, :, sl], k_pe, **kw)
                        check(f"mla B={nb} S={S}"
                              + (" paged" if mask is not None else ""),
                              (want[:, :, sl],), (got,))
    torch.cuda.synchronize()
    _say(f"[kernel rows] tensor-parallel scans and heads: a rank's Mamba1 "
         f"channels (conv, silu, selective scan), SSD heads and MLA heads "
         f"at tp {TP_DEGREES} against the whole call's: "
         f"{sum(cases.values())} calls ({dict(cases)}) bit-equal "
         f"{not bad} ({len(bad)} mismatches: {sorted(set(bad))}) in "
         f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise SystemExit(f"a rank's channels or heads differ from the whole "
                         f"call's: {sorted(set(bad))}")


def _row_invariance(dev) -> None:
    """Fault C1: for every serving (N, K) of the eight configs (`_serving_nk`)
    and both output dtypes, the rows of an M = 4 call are bit-equal to the
    same rows inside M = 1, 8, 64, 65, 128 and 512 calls: across stream
    tiles, the stream/wgmma boundary and wgmma's tiles, spread or walking
    (`plan`'s K segments depend on N and K only)."""
    from repro_torch.kernels.tiled_matmul import plan, tiled_matmul

    g = torch.Generator(dev).manual_seed(5)
    t0 = time.perf_counter()
    bad, plans = [], collections.Counter()
    shapes = _serving_nk()
    for n, k, _ in shapes:
        a = torch.randn((512, k), generator=g, device=dev).to(torch.bfloat16)
        b = _weight(dev, g, k, n, torch.bfloat16)
        for out in (torch.bfloat16, torch.float32):
            want = tiled_matmul(a[:4], b, out_dtype=out)
            for m in ROW_INVARIANCE_M:
                p = plan(m, n, k, a.stride(), b.stride(), 0, 0, a.dtype, out)
                plans[(p.path, "walk" if p.path == "wgmma" and p.splits == 1
                       and p.segments > 1 else "spread")] += 1
                got = tiled_matmul(a[:m], b, out_dtype=out)
                r = min(m, 4)
                if not torch.equal(got[:r], want[:r]):
                    bad.append((m, n, k, str(out).split(".")[-1]))
        del a, b, want, got
    # a tied head on its (N, K) layout: stream only (M <= 64)
    tied = _tied_heads()
    for n, k in tied:
        a = torch.randn((64, k), generator=g, device=dev).to(torch.bfloat16)
        table = (torch.randn((n, k), generator=g, device=dev) / k ** 0.5).to(
            torch.bfloat16)
        for out in (torch.bfloat16, torch.float32):
            want = tiled_matmul(a[:4], table, transpose_b=True, out_dtype=out)
            for m in (1, 8, 64):
                p = plan(m, n, k, a.stride(), table.stride()[::-1], 0, 0,
                         a.dtype, out)
                plans[(p.path, "(N, K)" if p.b_nk else "(K, N)")] += 1
                got = tiled_matmul(a[:m], table, transpose_b=True,
                                   out_dtype=out)
                r = min(m, 4)
                if not torch.equal(got[:r], want[:r]):
                    bad.append((m, n, k, str(out).split(".")[-1], "(N, K)"))
        del a, table, want, got
    torch.cuda.synchronize()
    _norm_rows(dev, g)
    _attention_rows(dev, g)
    _encoder_attention_rows(dev, g)
    _shard_columns(dev, g)
    _shard_heads(dev, g)
    _shard_parts(dev, g)
    _shard_scans(dev, g)
    _say(f"[kernel rows] {len(shapes)} serving (N, K) x 2 output dtypes x M "
         f"in {ROW_INVARIANCE_M}, and {len(tied)} tied head(s) on the (N, K) "
         f"layout at M in (1, 8, 64): rows 0-3 bit-equal to the M = 4 "
         f"call's {not bad} ({len(bad)} mismatches; plans {dict(plans)}) in "
         f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise SystemExit(f"a row's GEMM bits depend on M: {bad[:10]}")


def _init_model(dev, arch: str, tag: str, layers: int | None = None
                ) -> tuple:
    """(cfg, model API, params) of the published config `arch` at full
    width (and full depth unless `layers` cuts it), with random weights
    from a seeded CUDA generator."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # the init's f32 draws
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff_expert "
           f"{cfg.d_ff_expert}, {cfg.n_shared_experts} shared"
           if cfg.n_experts else
           f"d_ff {cfg.d_ff} ({'gated' if cfg.gated_mlp else 'GELU'} FFN)")
    _say(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
         f" heads {cfg.n_heads}/{cfg.kv_heads}, {ffn}, vocab {cfg.vocab}, "
         f"{cfg.param_dtype}; {n_params / 1e9:.3f} B params, "
         f"{n_bytes / 1e9:.2f} GB, random init in "
         f"{time.perf_counter() - t0:.1f} s")
    return cfg, api, params


def phase_serve(dev):
    """Serve 10 requests on full qwen2-7b; returns (engine, model API,
    params, cfg, the GEMM launches the run issued by (M, N, K, in dtype,
    out dtype, None), the launches per kernel path, the streams by
    uid)."""
    from repro_torch.serving.engine import ServingEngine

    cfg, api, params = _init_model(dev, "qwen2-7b", "serve")
    eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                        chunk_tokens=64, device=dev)
    shapes: collections.Counter = collections.Counter()
    by_path, results, _ = _serve_requests("serve", eng, cfg, shapes)
    _say(f"[serve] launches per path: stream {by_path['stream']}, wgmma "
         f"{by_path['wgmma']}, general {by_path['general']} (every bf16 "
         f"serving GEMM must take a fast path)")
    if (by_path["general"] != 0 or by_path["stream"] == 0
            or by_path["wgmma"] == 0):
        raise SystemExit(f"serving launches by path {by_path}: expected all "
                         "on stream and wgmma, none on general")
    streams = {r.uid: r.tokens.tolist() for r in results}
    return eng, api, params, cfg, shapes, by_path, streams


# phase 13's modality inputs, one per request of `_requests`: source
# frames (seamless-m4t-medium: 24-200, straddling the 32-256 buckets) and
# patch grids (qwen2-vl-2b: two full 32 x 32 images, smaller ones and one
# text-only request)
SOURCE_FRAMES = (24, 200, 40, 130, 64, 180, 33, 77, 150, 100)
PATCH_GRIDS = ((32, 32), (16, 16), None, (32, 32), (8, 12), (24, 24),
               (4, 4), (16, 32), (12, 12), (20, 16))


def _extras(cfg, i: int) -> dict | None:
    """Request `i`'s modality input for an admit family (None for the other
    families and a text-only request): random embeddings from a seeded
    generator, as the stubbed frontends would hand them over."""
    rng = np.random.default_rng(100 + i)
    if cfg.kind == "encdec":
        return {"src_embeds": rng.standard_normal(
            (SOURCE_FRAMES[i % 10], cfg.d_model)).astype(np.float32)}
    if cfg.kind == "vlm" and PATCH_GRIDS[i % 10] is not None:
        gh, gw = PATCH_GRIDS[i % 10]
        return {"patch_embeds": rng.standard_normal(
            (gh * gw, cfg.d_model)).astype(np.float32), "grid_hw": (gh, gw)}
    return None


def _requests(cfg) -> list:
    """The 10 requests every serving run answers: prompts of 16-300
    tokens, 8-32 new tokens each, from a seeded generator (with an admit
    family's modality input, `_extras`)."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    prompt_lens = [16, 300, 45, 130, 64, 250, 23, 77, 190, 31]
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
                np.int32), max_new_tokens=int(rng.integers(8, 33)),
                extras=_extras(cfg, i))
            for i, n in enumerate(prompt_lens)]


def _recording(log: collections.Counter):
    """A stand-in for `ops.tiled_matmul` that counts each launch under
    (M, N, K, in dtype, out dtype, the tile it was given) in `log`."""
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    def recording(a, b, c=None, **kw):
        k, n = b.shape[::-1] if kw.get("transpose_b") else b.shape
        cfg = kw.get("config")
        log[(a.shape[0], n, k, a.dtype, kw.get("out_dtype") or a.dtype,
             cfg.as_tuple() if cfg is not None else None)] += 1
        return tiled_matmul(a, b, c, **kw)

    return recording


def _prefix_requests(cfg) -> list:
    """10 requests whose prompts are one 256-token system prompt followed by
    16-64 tokens of their own, 8-32 new tokens each, from a seeded
    generator: how chat and coding assistants send a long system prompt
    ahead of each user turn."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab, PREFIX_TOKENS)
    return [Request(uid=100 + i, prompt=np.concatenate(
                [system, rng.integers(0, cfg.vocab, int(rng.integers(16, 65)))]
            ).astype(np.int32), max_new_tokens=int(rng.integers(8, 33)))
            for i in range(10)]


def _forwards(eng, run: dict) -> int:
    """The forwards one run of `eng` dispatched, from its report's counters
    over the run (`run`): chunk calls and decode steps, plus one
    single-shot prefill per request under serial admission, or one per
    wave of up to max_batch requests in the wave loop."""
    n = run["chunk_steps"] + run["decode_steps"]
    if eng.mode == "wave":
        n += -(-run["requests"] // eng.max_batch)
    elif eng.admission == "serial":
        n += run["requests"]
    return n


def _serve_requests(tag: str, eng, cfg, log: collections.Counter,
                    reqs: list | None = None) -> tuple:
    """Answer `reqs` (default: the 10 of `_requests`) on `eng`, recording
    every GEMM launch in `log` (see `_recording`); the launch counters are
    set to 0 just before the run and read just after. Checks every request
    finishes at its budget and the kernel launched one forward's GEMMs per
    forward dispatched and one admission's per admission call (and one LM
    head per forward); returns (the launches per path, the results, the
    report's numeric counters over this run)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    reqs = _requests(cfg) if reqs is None else reqs
    rep0 = eng.report()
    for r in reqs:
        eng.submit(r)
    shapes: collections.Counter = collections.Counter()
    ops.tiled_matmul = _recording(shapes)
    try:
        tiled_matmul.launches = 0
        tiled_matmul.launches_by_path.update(
            dict.fromkeys(tiled_matmul.launches_by_path, 0))
        results = eng.run_until_empty()
        torch.cuda.synchronize()
        launches = tiled_matmul.launches
        by_path = dict(tiled_matmul.launches_by_path)
    finally:
        ops.tiled_matmul = tiled_matmul
    log.update(shapes)
    rep1 = eng.report()
    rep = {k: v - rep0[k] for k, v in rep1.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)}
    rep["tokens_per_s"] = (rep["generated_tokens"] / rep["wall_s"]
                           if rep["wall_s"] > 0 else 0.0)
    rep["slot_occupancy"] = (rep["resident_slot_steps"] / rep["slot_steps"]
                             if rep["slot_steps"] else 0.0)
    per_forward = _gemms_per_forward(cfg)
    per_admit = _gemms_per_admission(cfg)
    forwards = _forwards(eng, rep)
    admits = rep["admit_calls"]
    want = per_forward * forwards + per_admit * admits
    heads = sum(c for key, c in shapes.items() if key[1] == cfg.vocab)
    routers = sum(c for key, c in shapes.items() if _is_router(cfg, key))
    _say(f"[{tag}] {rep['requests']} requests, {rep['generated_tokens']} "
         f"tokens, {rep['chunk_steps']} chunk steps, {rep['decode_steps']} "
         f"decode steps, wall {rep['wall_s']:.3f} s, "
         f"{rep['tokens_per_s']:.2f} tokens/s, mean TTFT "
         f"{statistics.mean(r.ttft_s for r in results):.3f} s, max TTFT "
         f"{max(r.ttft_s for r in results):.3f} s, slot occupancy "
         f"{rep['slot_occupancy']:.3f}, lane rebuilds {rep['lane_rebuilds']}")
    _say(f"[{tag}] kernel launches {launches} = {per_forward} x {forwards} "
         f"forwards" + (f" + {per_admit} x {admits} admission calls"
                        if per_admit else "")
         + f"? {launches == want}; LM heads "
         f"{heads}" + (f"; routers {routers} (= {cfg.n_layers} x "
                       f"{forwards}? {routers == cfg.n_layers * forwards})"
                       if cfg.n_experts else ""))
    if (launches != want or launches == 0
            or sum(by_path.values()) != launches or heads != forwards
            or (cfg.n_experts and routers != cfg.n_layers * forwards)):
        raise SystemExit("the serving path did not launch the kernel "
                         f"{per_forward} times per forward and {per_admit} "
                         "per admission")
    by_uid = {r.uid: r for r in results}
    if sorted(by_uid) != [r.uid for r in reqs]:
        raise SystemExit(f"requests unanswered: {sorted(by_uid)}")
    for r in reqs:
        res = by_uid[r.uid]
        budget = eng._budget(r)
        if (res.n_tokens != budget or len(res.tokens) != budget
                or not ((0 <= res.tokens) & (res.tokens < cfg.vocab)).all()):
            raise SystemExit(f"request {r.uid}: {res.n_tokens} tokens, "
                             f"budget {budget}")
    return by_path, results, rep


def phase_serving_shapes(dev, shapes, tag: str = "shapes",
                         tied: tuple = ()) -> dict:
    """Hold the kernel against its plain version at every serving shape, on
    the path `plan` chooses and on the general path (the first version of
    the kernel, "v3"), and time both beside the plain version and
    torch.matmul. Returns {path: per-kernel JSON entry}, times summed over
    the serving run's launches of the shapes that took that path (with the
    operations and bytes parts of the bound, "ops_ms" and "bytes_ms").
    `tag` heads the printed lines; the (N, K) in `tied` are LM heads that
    read the embedding table, so their B is stored (N, K) and every
    version is called with ``transpose_b`` (stream tiles only in the
    sweep)."""
    from repro_torch.core.opanalyze import gemm_bound_s
    from repro_torch.core.profiler import time_ms
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG,
                                                  candidate_tiles, plan,
                                                  tiled_matmul)

    g = torch.Generator(dev).manual_seed(1)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    tot: dict = collections.defaultdict(collections.Counter)
    worst: dict = collections.Counter()
    failed = []
    _say(f"[{tag}] M N K out count path tile splits/segments kernel_ms v3_ms "
         "plain_ms library_ms bound_ms bound_by bound/kernel library/kernel "
         "max_abs max_rel")
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        m, n, k, in_dt, out_dt, _ = key
        a, b = _gemm_inputs(dev, g, m, n, k, in_dt)
        nt = (n, k) in tied
        if nt:
            b = b.T.contiguous()                   # the table, (N, K)
        kw = dict(transpose_b=nt, out_dtype=out_dt)
        want = matmul_ref(a, b, **kw)
        path, got = _run_path(tiled_matmul, a, b, **kw)
        chosen = plan(m, n, k, a.stride(),
                      b.stride()[::-1] if nt else b.stride(), 0, 0, in_dt,
                      out_dt)
        err, rel, ok = _close(got, want, in_dt)
        v3_ok = _close(tiled_matmul(a, b, config=DEFAULT_CONFIG, **kw),
                       want, in_dt)[2]
        torch.cuda.synchronize()
        worst[path] = max(worst[path], err)
        if not (ok and v3_ok):
            failed.append((m, n, k, path if not ok else "general"))
        del got, want
        kernel_ms = time_ms(lambda: tiled_matmul(a, b, **kw), flush, 10)
        v3_ms = time_ms(lambda: tiled_matmul(a, b, config=DEFAULT_CONFIG,
                                              **kw), flush, 10)
        plain_ms = time_ms(lambda: matmul_ref(a, b, **kw), flush, 5)
        library_ms = time_ms(lambda: torch.matmul(a, b.T if nt else b),
                             flush, 10)
        ops_s, bytes_s = gemm_bound_s(m, n, k, a_dtype=in_dt,
                                      b_dtype=in_dt, out_dtype=out_dt)
        bound_ms = 1e3 * max(ops_s, bytes_s)
        _say(f"[{tag}] {m} {n} {k}{' (N, K) B' if nt else ''} "
             f"{str(out_dt).split('.')[-1]} {count} "
             f"{path} {chosen.tile.as_tuple()} {chosen.splits}/"
             f"{chosen.segments} {kernel_ms:.4f} {v3_ms:.4f} {plain_ms:.4f} "
             f"{library_ms:.4f} {bound_ms:.4f} "
             f"{'operations' if ops_s > bytes_s else 'bytes'} "
             f"{bound_ms / kernel_ms:.3f} {library_ms / kernel_ms:.3f} "
             f"{err:.3g} {rel:.3g}")
        # every compiled fast tile that can take the shape, forced: the
        # candidates an autotuner would choose among
        sweep = []
        for cfg in candidate_tiles(m):
            if nt and cfg.path != "stream":
                continue
            p = plan(m, n, k, a.stride(),
                     b.stride()[::-1] if nt else b.stride(), 0, 0, in_dt,
                     out_dt, config=cfg)
            ok = _close(tiled_matmul(a, b, config=cfg, **kw),
                        matmul_ref(a, b, **kw), in_dt)[2]
            if not ok:
                failed.append((m, n, k, cfg.as_tuple()))
            t_ms = time_ms(lambda: tiled_matmul(a, b, config=cfg, **kw),
                           flush, 10)
            sweep.append(f"{p.path} {cfg.as_tuple()} x{p.splits}/"
                         f"{p.segments} {t_ms:.4f}")
        _say(f"[{tag} sweep] {m} {n} {k}: " + "; ".join(sweep))
        for t in (tot[path], tot["all"]):
            t["ms"] += count * kernel_ms
            t["v3_ms"] += count * v3_ms
            t["plain_ms"] += count * plain_ms
            t["library_ms"] += count * library_ms
            t["bound_ms"] += count * bound_ms
            t["ops_ms"] += count * 1e3 * ops_s
            t["bytes_ms"] += count * 1e3 * bytes_s
    if failed:
        raise SystemExit(f"kernel disagrees at serving shapes {failed}")
    entries = {}
    for path, t in sorted(tot.items()):
        _say(f"[{tag}] summed over the serving run's launches ({path}): "
             f"kernel {t['ms']:.2f} ms, v3 (general path) {t['v3_ms']:.2f} "
             f"ms, plain {t['plain_ms']:.2f} ms, torch.matmul "
             f"{t['library_ms']:.2f} ms, bound {t['bound_ms']:.2f} ms "
             f"(operations {t['ops_ms']:.2f} ms, bytes {t['bytes_ms']:.2f} "
             "ms)")
        if path == "all":
            continue
        entries[path] = {
            "ms": t["ms"], "v3_ms": t["v3_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["ops_ms"] > t["bytes_ms"]
                         else "bytes"),
            "library_ms": t["library_ms"], "max_abs_err": worst[path],
            "ops_ms": t["ops_ms"], "bytes_ms": t["bytes_ms"]}
    _say(f"[{tag}] fast paths against the general path over the serving "
         f"launches: {tot['all']['ms']:.2f} ms against "
         f"{tot['all']['v3_ms']:.2f} ms (x{tot['all']['v3_ms'] / tot['all']['ms']:.2f})")
    return entries


def _is_gemm(name: str) -> bool:
    """Whether a traced kernel is one of the hand-written GEMM's kernels."""
    return any(k in name for k in GEMM_KERNELS)


def _busy_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return busy


def _trace(runs: list) -> dict:
    """Run each (label, fn) of `runs` in order under torch.profiler (host
    and device activity), each inside a `record_function` range and
    followed by a synchronisation. A device event belongs to the run whose
    range holds the runtime or driver call that launched it (the two share
    the profiler's correlation id), so no clock skew between the host's
    and the device's timestamps can move an event to another run. Returns
    {label: [one dict per run]}: window (range start to the run's last
    device event), host (the range's own length: the host's time to issue
    the run), busy (union of kernels, copies and sets), idle share, GEMM
    kernel time and count, kernel count, and device time per kernel name.
    An empty dict means the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tags = [f"{label}#{i}" for i, (label, _) in enumerate(runs)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for tag, (_, fn) in zip(tags, runs):
            with record_function(tag):
                fn()
            torch.cuda.synchronize()
    path = ROOT / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    ranges = sorted((float(e["ts"]), float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") in tags)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
               e["cat"], launched.get(e.get("args", {}).get("correlation")))
              for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device or len(ranges) != len(tags):
        return {}
    out: dict = collections.defaultdict(list)
    for ts, dur, tag in ranges:
        mine = [d for d in device
                if d[4] is not None and ts <= d[4] <= ts + dur]
        if not mine:
            return {}
        window = max(d[1] for d in mine) - ts
        busy = _busy_us([d[:2] for d in mine])
        per_name = collections.Counter()
        for s, e, name, cat, _ in mine:
            per_name[name if cat == "kernel" else cat] += e - s
        gemm = [d for d in mine if d[3] == "kernel" and _is_gemm(d[2])]
        out[tag.rsplit("#", 1)[0]].append(dict(
            window_ms=window / 1e3, host_ms=dur / 1e3, busy_ms=busy / 1e3,
            idle=1.0 - busy / window,
            gemm_ms=sum(e - s for s, e, *_ in gemm) / 1e3, n_gemm=len(gemm),
            n_kernels=sum(d[3] == "kernel" for d in mine),
            per_name=per_name))
    unmatched = sum(d[4] is None for d in device)
    if unmatched:
        _say(f"[trace] {unmatched} of {len(device)} device events have no "
             "launching call in the trace (left out of every run)")
    return out


def _short(name: str) -> str:
    """A kernel's demangled name cut to its template head."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][-60:]


def _forward_fns(dev, eng, params, cfg, W: int, C: int, rng) -> tuple:
    """(decode, chunk): one decode step over the engine's full slot table
    at position 256, and one W x C chunk call, on tokens drawn from
    `rng`."""
    B = eng.max_batch
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, B), device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (W, C)), device=dev)
    lens = torch.full((W,), C, device=dev)
    dstate = eng.model.init_state(cfg, B, eng.max_len, device=dev)
    dstate["index"].fill_(256)
    cstate = eng.model.init_state(cfg, W, eng.max_len, device=dev)

    def decode():
        eng.model.decode_step(params, tok, dict(dstate), cfg)

    def chunk():
        eng.model.prefill_chunk(params, toks, lens, dict(cstate), cfg)

    return decode, chunk


def _untraced_ms(fn, runs: int = 5) -> tuple:
    """(device span, host issue time) of `fn` in ms, medians of `runs`
    after one warm-up: CUDA events around the run, and the host clock
    around the call alone."""
    fn()
    torch.cuda.synchronize()
    spans, hosts = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        hosts.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return statistics.median(spans), statistics.median(hosts)


def phase_forwards(dev, eng, params, cfg) -> dict:
    """Where a step's time goes. One decode step over the full slot table
    and one 8x64 chunk call, each timed without a profiler (CUDA-event
    span, host issue time) and then traced with torch.profiler, 3 runs
    each: per run, the device's busy time and idle share within the run's
    window, the in-step GEMM kernel time and count (197 expected), and the
    non-GEMM kernels that take the most time. Then an engine run (4
    requests of 64 prompt tokens, 8 new tokens each), untraced and then
    traced, gives the idle share of serving as a whole, host sampling and
    copies included. The profiler slows the host's issue, so each idle
    share is also given against the untraced span."""
    from repro_torch.serving.engine import Request

    from repro_torch.kernels import ops

    B, W, C = eng.max_batch, 8, 64
    rng = np.random.default_rng(3)
    decode, chunk = _forward_fns(dev, eng, params, cfg, W, C, rng)
    tallies: dict = {}

    def tallied(key, fn):
        """`fn`, whose first call (the untimed warm-up) records its
        launches per path (`_path_tally`) for the dry-run check."""
        def run():
            if key in tallies:
                return fn()
            tallies[key] = {}
            torch.cuda.reset_peak_memory_stats(dev)
            real = ops.tiled_matmul
            ops.tiled_matmul = _path_tally(real, tallies[key])
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                ops.tiled_matmul = real
            tallies[key]["peak"] = torch.cuda.max_memory_allocated(dev)
        return run

    def serve(first_uid):
        for uid in range(first_uid, first_uid + 4):
            eng.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab, C).astype(np.int32), max_new_tokens=8))
        eng.run_until_empty()

    labels = {"decode": f"decode step, {B} slots at position 256",
              "chunk": f"chunk call {W}x{C}",
              "serve": "engine run, 4 requests x (64 prompt + 8 new) tokens"}
    untraced = {}
    for key, fn in (("decode", decode), ("chunk", chunk)):
        untraced[key] = _untraced_ms(tallied(key, fn))
        _say(f"[forward] {labels[key]}, no profiler: device span "
             f"{untraced[key][0]:.2f} ms, host issue {untraced[key][1]:.2f} "
             f"ms (medians of 5)")
    t0 = time.perf_counter()
    serve(1000)
    torch.cuda.synchronize()
    untraced["serve"] = (1e3 * (time.perf_counter() - t0), None)
    _say(f"[forward] {labels['serve']}, no profiler: wall "
         f"{untraced['serve'][0]:.2f} ms")
    traced = _trace([("decode", decode)] * 3 + [("chunk", chunk)] * 3
                    + [("serve", lambda: serve(2000))])
    if not traced:
        _say("[trace] the profiler recorded no device activity: idle share "
             "and in-step GEMM time not measured")
        _serve_dry_checks(eng, cfg, W, C, tallies,
                          {k: untraced[k][0] for k in ("decode", "chunk")},
                          "untraced device span")
        return untraced
    busy_ms = {}
    for key, runs in traced.items():
        for r in runs:
            _say(f"[trace] {labels[key]}: window {r['window_ms']:.2f} ms, "
                 f"host issue {r['host_ms']:.2f} ms, device busy "
                 f"{r['busy_ms']:.2f} ms, idle share {r['idle']:.4f}, GEMM "
                 f"kernels {r['gemm_ms']:.2f} ms over {r['n_gemm']} launches "
                 f"({100 * r['gemm_ms'] / r['window_ms']:.1f}% of the "
                 f"window), {r['n_kernels']} kernels in all")
        total = sum((r["per_name"] for r in runs), collections.Counter())
        top = [(n, t) for n, t in total.most_common() if not _is_gemm(n)]
        _say(f"[trace] {labels[key]}: top non-GEMM device time per run: "
             + "; ".join(f"{_short(n)} {t / 1e3 / len(runs):.2f} ms"
                         for n, t in top[:6]))
        # the profiler slows the host, not the card: the traced busy time
        # over the untraced span is the idle share without the profiler
        busy = busy_ms[key] = statistics.median(r["busy_ms"] for r in runs)
        _say(f"[trace] {labels[key]}: idle share without the profiler, 1 - "
             f"busy {busy:.2f} ms / untraced {untraced[key][0]:.2f} ms = "
             f"{1 - busy / untraced[key][0]:.4f}")
    per_forward = _gemms_per_forward(cfg)
    for key in ("decode", "chunk"):
        if any(r["n_gemm"] != per_forward for r in traced[key]):
            raise SystemExit(f"the traced {key} forward did not launch the "
                             f"kernel {per_forward} times")
    _serve_dry_checks(eng, cfg, W, C, tallies, busy_ms,
                      "traced device busy time")
    return untraced


def _serve_dry_checks(eng, cfg, W: int, C: int, tallies: dict,
                      measured_ms: dict, what: str) -> None:
    """The dry-run of phase 6's decode step and chunk call: the same
    calls on meta copies of the engine's params and states
    (`_dry_check`)."""
    api, B = eng.model, eng.max_batch
    params = api.init(cfg, None, device="meta")
    meta = lambda *shape: torch.empty(shape, dtype=torch.long,  # noqa: E731
                                      device="meta")
    dstate = api.init_state(cfg, B, eng.max_len, device="meta")
    cstate = api.init_state(cfg, W, eng.max_len, device="meta")
    active = cfg.n_active_params()
    for key, fn, args, tokens in (
            ("decode", api.decode_step, (params, meta(B), dstate, cfg), B),
            ("chunk", api.prefill_chunk,
             (params, meta(W, C), meta(W), cstate, cfg), W * C)):
        tally = dict(tallies[key])
        peak = tally.pop("peak")
        _dry_check(f"serve {key} {cfg.name}", fn, args,
                   {p: tuple(v) for p, v in tally.items()},
                   measured_ms[key] / 1e3, 2.0 * active * tokens,
                   what=what, peak=peak)


def _rel_top1(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(relative L2, top-1 agreement) of two logit tensors."""
    return (((got - want).norm() / want.norm()).item(),
            (got.argmax(-1) == want.argmax(-1)).float().mean().item())


def phase_logits(dev, eng, params, cfg, W: int = 16, tag: str = "logits",
                 log: collections.Counter | None = None) -> None:
    """One W x 64 chunk call at full width through the kernel, then with
    every product through `matmul_ref`; the kernel's launches are recorded
    in `log` (see `_recording`) when one is given.

    For the MoE families the plain run replays the kernel run's routing
    (each layer's expert ids, slots, kept tokens and gates), so the two
    differ only in the GEMMs' rounding, as for a dense model: routing is a
    discrete function of the router's logits, and under a binding
    capacity one token sent to another expert moves every later token of
    its row (first come, first served), so free routing turns a rounding
    difference into a different computation. The free-routing distance is
    printed beside it, with torch.matmul's (cuBLAS bf16 through every
    product, free routing) from the same plain run as a yardstick of that
    sensitivity. The SSM and hybrid families print torch.matmul's distance
    too: their recurrent state carries a rounding difference through every
    later layer and position. So for them every block is held to the bound
    on its own (`_block_errors`: its residual update through the kernel
    and through the plain version on the same input and state), and the
    whole forward to the larger of the bound and twice torch.matmul's
    distance. The admit families first admit the W rows' modality inputs
    (`_extras`) in one call, through the kernel or the plain version as the
    chunk, and the admission's leaves (encdec's cross-KV, vlm's patch
    prefix KV) are held to the same bound as the logits."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.models import moe

    C = 64
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (W, C)), device=dev)
    lens = torch.as_tensor(rng.integers(1, C + 1, W), device=dev)
    api = eng.model
    extras = ([_extras(cfg, i) for i in range(W)] if api.admit is not None
              else None)
    admitted: list = []

    def run():
        state = api.init_state(cfg, W, eng.max_len, device=dev)
        if extras is not None:
            bucket = eng._bucket(max(max(api.admit_dims(cfg, e))
                                     for e in extras) or 1)
            state = api.admit(params, api.pack_admit(
                cfg, extras, W, bucket, device=dev), state, cfg)
            admitted.append({k: state["kv"][k].clone() for k in (
                ("xk", "xv") if cfg.kind == "encdec" else ("k", "v"))})
        logits, _ = api.prefill_chunk(params, toks, lens, state, cfg)
        torch.cuda.synchronize()
        return logits

    def plain(a, b, c=None, *, config=None, **kw):
        return matmul_ref(a, b, c, **kw)

    def library(a, b, c=None, *, config=None, transpose_b=False,
                out_dtype=None, **kw):
        return torch.matmul(a, b.T if transpose_b else b).to(
            out_dtype or a.dtype)

    route, routes = moe.route, []

    def recorded(*a, **kw):
        routes.append(route(*a, **kw))
        return routes[-1]

    def replayed(*a, **kw):
        return routes.pop(0)

    if log is not None:
        ops.tiled_matmul = _recording(log)
    try:
        moe.route = recorded
        got = run()
        moe.route = route
        ops.tiled_matmul = plain
        want = run()
        if cfg.n_experts:
            moe.route = replayed
            frozen = run()
            moe.route = route
        if cfg.n_experts or cfg.sub_quadratic:
            ops.tiled_matmul = library
            lib = run()
    finally:
        ops.tiled_matmul = tiled_matmul
        moe.route = route
    rel, top1 = _rel_top1(got, want)
    finite = bool(torch.isfinite(got).all())
    bound = LOGITS_REL_L2_MAX
    if extras is not None:
        # the admission's leaves, kernel run against plain run (vlm: the KV
        # rows the patch prefix wrote; both runs' chunks had not run yet)
        leaf_rel = {k: ((admitted[0][k].float() - admitted[1][k].float())
                        .norm() / admitted[1][k].float().norm()).item()
                    for k in admitted[0]}
        _say(f"[{tag}] admission of {W} rows "
             f"({sum(e is not None for e in extras)} with a modality input):"
             f" its leaves against the plain run, relative L2 "
             + ", ".join(f"{k} {v:.3e}" for k, v in sorted(leaf_rel.items()))
             + f" (max {LOGITS_REL_L2_MAX:g})")
        if not all(v <= LOGITS_REL_L2_MAX for v in leaf_rel.values()):
            raise SystemExit(f"[{tag}] admission leaves disagree with the "
                             "plain version")
    if cfg.sub_quadratic:
        lib_rel, lib_top1 = _rel_top1(lib, want)
        _say(f"[{tag}] torch.matmul against the plain version: relative L2 "
             f"{lib_rel:.3e}, top-1 {lib_top1:.3f} (the model's sensitivity "
             f"to GEMM rounding over its {cfg.n_layers} recurrent layers)")
        errs = _block_errors(run, plain)
        worst = max(range(len(errs)), key=errs.__getitem__)
        _say(f"[{tag}] per block, on the same input and state: the block's "
             f"residual update through the kernel against the plain version,"
             f" relative L2 max {errs[worst]:.3e} (block {worst} of "
             f"{len(errs)}; max {LOGITS_REL_L2_MAX:g}), median "
             f"{statistics.median(errs):.3e}")
        if errs[worst] > LOGITS_REL_L2_MAX:
            raise SystemExit(f"[{tag}] block {worst}'s update disagrees with "
                             "the plain version")
        # the whole forward: the recurrence carries every rounding
        # difference on, so the kernel is held to twice torch.matmul's
        # distance where that is past phase 7's bound
        bound = max(LOGITS_REL_L2_MAX, 2 * lib_rel)
    if cfg.n_experts:
        rel_free, top1_free = rel, top1
        lib_rel, lib_top1 = _rel_top1(lib, want)
        rel, top1 = _rel_top1(got, frozen)
        _say(f"[{tag}] free routing: the kernel against the plain version "
             f"relative L2 {rel_free:.3e}, top-1 {top1_free:.3f}; "
             f"torch.matmul against the plain version {lib_rel:.3e}, top-1 "
             f"{lib_top1:.3f} (the model's sensitivity to GEMM rounding)")
    _say(f"[{tag}] chunk call {W}x{C}: logits {tuple(got.shape)} "
         f"{got.dtype}, finite {finite}, relative L2 {rel:.3e} (max "
         f"{bound:.3g}), top-1 agreement {top1:.3f} (min "
         f"{LOGITS_TOP1_MIN:g})"
         + (", the plain run on the kernel run's routing"
            if cfg.n_experts else ""))
    if (not finite or got.shape != (W, cfg.vocab) or rel > bound
            or top1 < LOGITS_TOP1_MIN):
        raise SystemExit("full-width logits disagree with the plain version")


def _block_errors(forward, plain) -> list:
    """Run `forward` through the kernel with every block (and each
    application of a hybrid's shared block) also run on the same input and
    a copy of its cache with every product through `plain`; returns, per
    block in call order, the relative L2 distance of the kernel's residual
    update from the plain one. The kernel's output goes on, so each block
    is compared on the kernel run's own input: a rounding difference
    earlier in the model does not enter the comparison."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.models import transformer as tfm

    errs: list = []

    def checked(fn):
        def run(blk, x, cfg, *, cache=None, **kw):
            copy = (None if cache is None
                    else {k: v.clone() for k, v in cache.items()})
            ops.tiled_matmul = plain
            try:
                want = fn(blk, x, cfg, cache=copy, **kw)[0]
            finally:
                ops.tiled_matmul = tiled_matmul
            out = fn(blk, x, cfg, cache=cache, **kw)
            d_got, d_want = (out[0] - x).float(), (want - x).float()
            errs.append(((d_got - d_want).norm() / d_want.norm()).item())
            return out
        return run

    block_apply, dense = tfm.block_apply, tfm.dense_block_apply
    tfm.block_apply = lambda cfg: checked(block_apply(cfg))
    tfm.dense_block_apply = checked(dense)
    try:
        forward()
    finally:
        tfm.block_apply, tfm.dense_block_apply = block_apply, dense
    return errs


def phase_loop(dev, api, params, cfg, shapes, untraced) -> tuple:
    """The paper's loop on the card: profile, fit, score, tune, serve.
    Returns (the profiled table, the tuner, its runtime winners, the
    serving fleet)."""
    from repro_torch.core.autotuner import (H100_VERIFY_TOP_K, GemmAutotuner,
                                            fit_card_predictor, set_tuner)
    from repro_torch.core.features import (features_matrix,
                                           graph_candidate_features)
    from repro_torch.core.hwsim import GemmConfig
    from repro_torch.core.profiler import (card_measure_fn,
                                           h100_sweep_configs, paper_split,
                                           profile_configs, tile_stages,
                                           time_ms)
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG, TILE_PATHS,
                                                  TILE_SHAPES, plan,
                                                  tiled_matmul)
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    # 1. profile the compiled tiles over the H100 sweep
    cfgs = h100_sweep_configs()
    t0 = time.perf_counter()
    table = profile_configs(cfgs, chip="h100",
                            measure_fn=card_measure_fn(device=dev))
    prof_s = time.perf_counter() - t0
    rows = len(table["runtime_ms"])
    per_path = collections.Counter(
        f"{TILE_PATHS[(int(a), int(b), int(c))]}/{d}" for a, b, c, d in zip(
            table["block_m"], table["block_n"], table["block_k"],
            table["dtype"]))
    rt = table["runtime_ms"]
    _say(f"[loop] profiled {len(cfgs)} configs of the H100 sweep in "
         f"{prof_s:.1f} s: {rows} valid rows ({len(cfgs) - rows} tiles "
         f"refused by plan); rows per path/dtype {dict(sorted(per_path.items()))};"
         f" runtime {rt.min():.4f}-{rt.max():.4f} ms, median "
         f"{np.median(rt):.4f}; power_source "
         f"{sorted(set(table['power_source']))}")
    if rows < LOOP_MIN_ROWS:
        raise SystemExit(f"{rows} valid rows, fewer than {LOOP_MIN_ROWS}")

    # 2. fit the card's predictor (the paper's Random Forest, 100 trees of
    # depth 6, direct regression on log targets) on the paper's split
    tr, te = paper_split(table)
    t0 = time.perf_counter()
    pred = fit_card_predictor(tr)
    fit_s = time.perf_counter() - t0
    rep = pred.evaluate(te)
    r2 = rep["runtime_ms"]["r2"]
    _say(f"[loop] Random Forest (100 trees, depth 6, residual="
         f"{pred.residual}) fitted "
         f"on {len(tr['runtime_ms'])} rows in {fit_s:.1f} s; held out "
         f"{len(te['runtime_ms'])} rows, runtime_ms: R2 {r2:.4f} (min "
         f"{LOOP_MIN_R2:g}), mean error "
         f"{rep['runtime_ms']['mean_pct_err']:.2f}%, median error "
         f"{rep['runtime_ms']['median_pct_err']:.2f}%; tflops R2 "
         f"{rep['tflops']['r2']:.4f} (the paper on the RTX 4070: R2 "
         f"{PAPER_RUNTIME_R2:g}, mean error {PAPER_RUNTIME_MEAN_PCT:g}%. "
         "Power and energy in this table are the simulator's; phase 9 "
         "measures power on the card)")
    if not r2 >= LOOP_MIN_R2:
        raise SystemExit(f"held-out runtime R2 {r2:.4f} < {LOOP_MIN_R2}")

    # 3. the float64 torch scorer on the card against numpy predict
    tuner = GemmAutotuner(pred, chip="h100", device=dev,
                          verify_top_k=H100_VERIFY_TOP_K)
    fleet = ops.serving_gemm_fleet(cfg, max_batch=4, max_len=512,
                                   chunk_tokens=64, lane_width=8)
    scorer = pred.torch_predictor(device=dev, x64=True)
    X_te = np.stack([te[k] for k in pred.feature_names], axis=1)
    same_te = np.array_equal(scorer(X_te).cpu().numpy(),
                             pred.predict_matrix(te))
    cands, X_c = tuner.candidate_table(512, 18944, 3584, "bf16")
    same_c = np.array_equal(
        scorer(X_c).cpu().numpy(), pred.predict_matrix(
            {k: X_c[:, i] for i, k in enumerate(pred.feature_names)}))
    stages = [tile_stages(t) for t in TILE_SHAPES]
    grid, _ = graph_candidate_features(fleet, TILE_SHAPES, "h100", "bf16",
                                       device=dev, stages=stages)
    want_grid = features_matrix(
        [GemmConfig(m=m, n=n, k=k, block_m=t[0], block_n=t[1],
                    block_k=t[2], stages=tile_stages(t))
         for m, n, k in fleet for t in TILE_SHAPES],
        chip="h100").reshape(grid.shape)
    same_grid = np.array_equal(grid.cpu().numpy(), want_grid)
    tuner.rank_in_graph(fleet)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tops, _ = tuner.rank_in_graph(fleet)
    rank_ms = 1e3 * (time.perf_counter() - t0)
    trace_tops = [[cands_[j] for j in
                   tuner.rank(cands_, features=X_)[:tuner.verify_top_k]]
                  for cands_, X_ in (tuner.candidate_table(m, n, k, "bf16")
                                     for m, n, k in fleet)]
    same_rank = tops == trace_tops
    _say(f"[loop] float64 torch scorer on the card vs numpy predict: "
         f"{len(X_te)} held-out rows bit-identical {same_te}; the "
         f"{len(cands)} candidates of (512, 18944, 3584) bit-identical "
         f"{same_c}; the feature grid of {len(fleet)} fleet shapes x "
         f"{len(TILE_SHAPES)} tiles bit-identical {same_grid}; "
         f"rank_in_graph over the fleet {rank_ms:.2f} ms, its top "
         f"{tuner.verify_top_k} equal to the trace-time ranking's "
         f"{same_rank}")
    if not (same_te and same_c and same_grid and same_rank):
        raise SystemExit("the torch scorer on the card disagrees with numpy")

    # 4. tune the serving fleet, timing every candidate on the card
    set_tuner(tuner)
    t0 = time.perf_counter()
    tuned = ops.warm_gemm_cache(fleet, strict=True)
    tune_s = time.perf_counter() - t0
    _say(f"[loop] tuned {len(tuned)} fleet shapes in {tune_s:.1f} s (top "
         f"{tuner.verify_top_k} of the ranking, every candidate, timed on "
         "the card per shape)")
    if sorted(tuned) != sorted(fleet):
        raise SystemExit("the tuner left fleet shapes untuned")
    g = torch.Generator(dev).manual_seed(4)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    sums = collections.Counter()
    _say("[tuned] M N K out launches plan_tile tuned_tile plan_ms tuned_ms "
         "general_ms")
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        m, n, k, in_dt, out_dt, _ = key
        a, b = _gemm_inputs(dev, g, m, n, k, in_dt)
        p = plan(m, n, k, a.stride(), b.stride(), a.data_ptr() % 16,
                 b.data_ptr() % 16, in_dt, out_dt)
        tiles = {"plan": None, "tuned": tuned[(m, n, k)],
                 "general": DEFAULT_CONFIG}
        ms = {}
        for name, conf in tiles.items():
            ms[name] = time_ms(lambda: tiled_matmul(
                a, b, config=conf, out_dtype=out_dt), flush, 10)
            sums[name] += count * ms[name]
        _say(f"[tuned] {m} {n} {k} {str(out_dt).split('.')[-1]} {count} "
             f"{p.path}{p.tile.as_tuple()} "
             f"{TILE_PATHS[tiles['tuned'].as_tuple()]}"
             f"{tiles['tuned'].as_tuple()} "
             + " ".join(f"{ms[t]:.4f}" for t in tiles))
    _say(f"[tuned] summed over the serving run's launches: tuned "
         f"{sums['tuned']:.2f} ms, plan's rule {sums['plan']:.2f} ms, the "
         f"general path {sums['general']:.2f} ms (general / tuned x"
         f"{sums['general'] / sums['tuned']:.2f}, plan / tuned x"
         f"{sums['plan'] / sums['tuned']:.3f})")

    # 5. serve the same requests with the tuned tiles
    eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                        chunk_tokens=64, pretune=True, device=dev)
    if any(eng.pretuned.get(s_) != tuned[s_] for s_ in fleet):
        raise SystemExit("the engine's pretuned tiles differ from the fleet's")
    log: collections.Counter = collections.Counter()
    by_path, _, _ = _serve_requests("tuned serve", eng, cfg, log)
    _say(f"[tuned serve] launches per path: {by_path}")
    phase_logits(dev, eng, params, cfg, W=8, tag="tuned logits", log=log)
    off = {key: c for key, c in log.items()
           if key[5] is None or key[5] != eng.pretuned.get(
               key[:3], DEFAULT_CONFIG).as_tuple()}
    _say(f"[tuned serve] {sum(log.values())} launches recorded over "
         f"{len(log)} (shape, tile) pairs; on a tile other than their "
         f"shape's tuned one: {sum(off.values())}")
    if off:
        raise SystemExit(f"launches off their tuned tile: {off}")
    decode, _ = _forward_fns(dev, eng, params, cfg, 8, 64,
                             np.random.default_rng(3))
    installed = dict(ops._TUNED)
    host = collections.defaultdict(list)
    for name in ("plan", "tuned", "tuned", "plan"):
        ops._TUNED.clear()
        if name == "tuned":
            ops._TUNED.update(installed)
        host[name].append(_untraced_ms(decode)[1])
    ops._TUNED.update(installed)
    ratio = statistics.median(host["tuned"]) / max(host["plan"])
    _say(f"[tuned serve] decode step untraced host issue (medians of 5, "
         f"in turns): tuned lookup {host['tuned'][0]:.2f}, "
         f"{host['tuned'][1]:.2f} ms; plan's rule {host['plan'][0]:.2f}, "
         f"{host['plan'][1]:.2f} ms; phase 6 {untraced['decode'][1]:.2f} ms;"
         f" tuned / slowest plan run {ratio:.3f} (max "
         f"{HOST_ISSUE_MAX_RATIO:g})")
    if ratio > HOST_ISSUE_MAX_RATIO:
        raise SystemExit("the tuned lookup slowed the decode step's issue")
    _say(f"[loop] phase 8 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")
    return table, tuner, tuned, fleet


def _next_step(card) -> int:
    """The energy counter's value at its next step (raises after 5 s
    without one)."""
    first, t0 = card.energy_mj(), time.perf_counter()
    while (now := card.energy_mj()) == first:
        if time.perf_counter() - t0 > 5.0:
            raise SystemExit("the energy counter stopped stepping")
    return now


def _metered(card, fn):
    """(fn's result, joules, seconds): `fn` run from one step of the energy
    counter, and the card metered to the first step after it finished (so
    up to one counter period of idle tail is counted with it)."""
    start = _next_step(card)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    end = _next_step(card)
    return out, (end - start) / 1e3, time.perf_counter() - t0


def _long_window(dev, card, period: float, m: int, n: int, k: int,
                 tile: tuple, dtype: str):
    """One power window of `LONG_WINDOW_PERIODS` counter periods of a
    row-major (m, n, k) GEMM in `dtype` ("bf16" or "f32") at `tile`:
    whether a sweep row's short window reads the power the card holds.
    Returns the window and the energy counter's steps, (seconds, mJ) from
    the first step after the GEMM starts, each timed by the read that sees
    it (the counter is read after every pump)."""
    from repro_torch.core import nvml
    from repro_torch.core.profiler import graph_pump, time_ms
    from repro_torch.kernels.tiled_matmul import BlockConfig, tiled_matmul

    a, b = _gemm_inputs(dev, torch.Generator(dev).manual_seed(5), m, n, k,
                        torch.float32 if dtype == "f32" else torch.bfloat16)

    def fn():
        return tiled_matmul(a, b, config=BlockConfig(*tile))

    ms = time_ms(fn, torch.empty(2 ** 28, dtype=torch.uint8, device=dev), 3)
    pump, _ = graph_pump(fn, ms)
    steps = []

    def read():
        e = card.energy_mj()
        if not steps or e != steps[-1][1]:
            steps.append((time.perf_counter(), e))
        return e

    def pump_and_read():
        # the window pumps without reading between its ends
        units = pump()
        read()
        return units

    win = nvml.measure_window(read, pump_and_read, period_s=period,
                              periods=LONG_WINDOW_PERIODS)
    torch.cuda.synchronize()
    # steps[0] is the first read, steps[1] the first step after it
    return win, [(t - steps[1][0], e - steps[1][1]) for t, e in steps[1:]]


def _cycle_line(bound: str, steps: list, limit: float) -> str:
    """The watts of each counter period of a `_long_window`'s GEMM, and of
    its first `WINDOW_PERIODS` and `CAPPED_PERIODS` periods: how the card's
    power control cycles under a heavy GEMM (fault C3)."""
    from repro_torch.core import nvml

    def over(k):
        t, e = steps[min(k, len(steps) - 1)]
        return e / 1e3 / t

    per = [(e1 - e0) / 1e3 / (t1 - t0)
           for (t0, e0), (t1, e1) in zip(steps, steps[1:])]
    return (f"[power] cycle of the largest {bound}-bound row, W per counter "
            f"period from the GEMM's first step: "
            + " ".join(f"{w:.0f}" for w in per)
            + f"; its first {nvml.WINDOW_PERIODS} periods "
            f"{over(nvml.WINDOW_PERIODS):.1f} W, first "
            f"{nvml.CAPPED_PERIODS} {over(nvml.CAPPED_PERIODS):.1f} W "
            f"(limit {limit:g} W)")


def phase_energy(dev, api, params, cfg, shapes, table, tuner, runtime_won,
                 fleet) -> None:
    """The energy half of the paper's loop on the card: NVML, a power
    sweep, the power target, the energy objective, and serving joules,
    modelled against measured."""
    from repro_torch.core import nvml
    from repro_torch.core.chips import get_chip
    from repro_torch.core.predictor import PerfPredictor
    from repro_torch.core.profiler import (card_measure_fn, paper_split,
                                           power_sample, probe_energy_period,
                                           profile_configs)
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG, TILE_PATHS,
                                                  plan)
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    # 1. the card through NVML
    card = nvml.open_card(dev)
    limit = card.power_limit_w()
    t0 = time.perf_counter()
    for _ in range(10):
        card.energy_mj()
    read_ms = 1e3 * (time.perf_counter() - t0) / 10
    _say(f"[nvml] {card.name()} (PCI {card.key}): enforced power limit "
         f"{limit:.2f} W; nvidia-smi says {_nvidia_smi()}; "
         f"temperature {card.temperature_c():.0f} C; one energy-counter "
         f"read {read_ms:.2f} ms")
    torch.cuda.synchronize()
    period = probe_energy_period(card, dev)
    idle = nvml.measure_window(card.energy_mj, lambda: 0, period_s=period)
    _say(f"[nvml] energy counter period {1e3 * period:.2f} ms (median "
         f"step while a GEMM runs back to back); idle power "
         f"{idle.watts:.2f} W over {idle.seconds:.3f} s with nothing "
         f"running (the card warm from phases 1-8; NVML's own power "
         f"reading then {card.power_w():.2f} W); a power window lasts "
         f"{nvml.window_seconds(period):.3f} s after a warm-up of about "
         "one period")

    # 2. the power sweep: a stratified sample of phase 8's rows
    spec = get_chip("h100")
    row_s = (nvml.WINDOW_PERIODS + 1) * period + 0.05
    n = min(POWER_ROWS, int(POWER_SWEEP_BUDGET_S / row_s))
    sample = power_sample(table, n, seed=0)
    t0 = time.perf_counter()
    ptable = profile_configs(sample, chip="h100", measure_fn=card_measure_fn(
        device=dev, power=True, period_s=period))
    sweep_s = time.perf_counter() - t0
    pw, tc = ptable["power_w"], ptable["temperature_c"]
    lb = ptable["launch_bound"]
    per_path = collections.Counter(
        TILE_PATHS[(int(a), int(b), int(c))] for a, b, c in zip(
            ptable["block_m"], ptable["block_n"], ptable["block_k"]))
    _say(f"[power] measured {len(pw)} of {len(table['runtime_ms'])} rows "
         f"for power (stratified by path and M; {n} asked at about "
         f"{row_s:.2f} s a row) in {sweep_s:.1f} s; rows per path "
         f"{dict(sorted(per_path.items()))}; power {pw.min():.1f}-"
         f"{pw.max():.1f} W, median {np.median(pw):.1f} W; temperature "
         f"{np.nanmin(tc):.0f}-{np.nanmax(tc):.0f} C; busy share "
         f"{ptable['busy_share'].min():.3f}-{ptable['busy_share'].max():.3f},"
         f" {int(lb.sum())} rows flagged launch_bound (below 0.9); "
         f"{int((pw > limit).sum())} rows above the enforced limit of "
         f"{limit:g} W, {int((pw > 1.1 * limit).sum())} above 1.1 x it; "
         f"power_source {sorted(set(ptable['power_source']))}")
    if set(ptable["power_source"]) != {"nvml"}:
        raise SystemExit("rows of the power table are not the card's")
    if len(pw) < 0.9 * n or not (np.isfinite(pw).all() and (pw > 0).all()):
        raise SystemExit("the power sweep lost rows or read no power")
    flops = ptable["m"] * ptable["n"] * ptable["k"]
    for bound, size, what in (("compute", flops, "2MNK"),
                              ("memory", ptable["bytes_accessed"], "bytes")):
        idx = np.flatnonzero(ptable["bound"] == bound)
        if not idx.size:
            _say(f"[power] no {bound}-bound row in the sample")
            continue
        i = idx[np.argmax(size[idx])]
        m, n, k = (int(ptable[d][i]) for d in "mnk")
        tile = tuple(int(ptable[f"block_{d}"][i]) for d in "mnk")
        long, steps = _long_window(dev, card, period, m, n, k, tile,
                                   str(ptable["dtype"][i]))
        _say(f"[power] largest {bound}-bound row (by {what}): {m}x{n}x{k} "
             f"{ptable['dtype'][i]} tile {tile} "
             f"{ptable['runtime_ms'][i]:.4f} ms at {pw[i]:.1f} W in the "
             f"sweep ({nvml.WINDOW_PERIODS} counter periods, "
             f"{nvml.CAPPED_PERIODS} if they read above the limit), "
             f"{long.watts:.1f} W over "
             f"{LONG_WINDOW_PERIODS} ({long.seconds:.2f} s) (the h100 spec's "
             f"estimates: idle {spec.idle_power_w:g} W, idle + mxu "
             f"{spec.idle_power_w + spec.mxu_power_w:g} W, idle + hbm "
             f"{spec.idle_power_w + spec.hbm_power_w:g} W)")
        _say(_cycle_line(bound, steps, limit))

    # 3. the power target: the Random Forest on 80% of the measured rows
    tr, te = paper_split(ptable)
    t0 = time.perf_counter()
    pred = PerfPredictor(model="rf", residual=True, chip="h100").fit(tr)
    fit_s = time.perf_counter() - t0
    rep = pred.evaluate(te)
    r2 = rep["power_w"]["r2"]
    _say(f"[power] Random Forest (100 trees, depth 6, residual=True) fitted "
         f"on {len(tr['power_w'])} rows in {fit_s:.1f} s; held out "
         f"{len(te['power_w'])} rows: power_w R2 {r2:.4f} (min "
         f"{POWER_MIN_R2:g}), median error "
         f"{rep['power_w']['median_pct_err']:.2f}%, mean error "
         f"{rep['power_w']['mean_pct_err']:.2f}%; energy_j R2 "
         f"{rep['energy_j']['r2']:.4f}, median error "
         f"{rep['energy_j']['median_pct_err']:.2f}%; runtime_ms R2 "
         f"{rep['runtime_ms']['r2']:.4f} (the paper on the RTX 4070: power "
         f"R2 {PAPER_POWER_R2:g}, median error {PAPER_POWER_MEDIAN_PCT:g}%)")
    if not POWER_MIN_R2 <= r2 < 0.99999:
        raise SystemExit(f"held-out power R2 {r2:.4f} outside "
                         f"[{POWER_MIN_R2}, 1)")

    # 4. the energy objective: tune the fleet, every candidate measured for
    # power on the card
    t0 = time.perf_counter()
    won = ops.warm_gemm_cache(fleet, objective="energy", strict=True)
    tune_s = time.perf_counter() - t0
    flat, tel = tuner.last_verification
    measured = {(c.m, c.n, c.k, c.block_m, c.block_n, c.block_k):
                (tel["runtime_ms"][i], tel["power_w"][i], tel["energy_j"][i])
                for i, c in enumerate(flat)}
    differ = [s_ for s_ in fleet if won[s_] != runtime_won[s_]]
    # where the tuner's time went: each candidate's power window (run on to
    # CAPPED_PERIODS where it read above the limit) and the rest (timing,
    # graph capture, ranking, warm-ups)
    win_s = np.asarray(tel["window_s"], dtype=np.float64)
    ran_on = win_s > 0.5 * (nvml.WINDOW_PERIODS + nvml.CAPPED_PERIODS) * period
    _say(f"[energy] the tuner's {tune_s:.1f} s: power windows "
         f"{win_s.sum():.1f} s over {len(win_s)} candidates, {ran_on.sum()} "
         f"of them run on to {nvml.CAPPED_PERIODS} periods ("
         f"{win_s[ran_on].sum():.1f} s); the rest {tune_s - win_s.sum():.1f}"
         f" s ({(tune_s - win_s.sum()) / max(len(win_s), 1):.3f} s a "
         f"candidate: timing, graph capture, warm-up, ranking)")
    _say(f"[energy] tuned {len(won)} fleet shapes for energy in "
         f"{tune_s:.1f} s ({len(flat)} candidates measured for power); "
         f"{len(differ)} shapes won by another tile than for runtime: "
         + "; ".join(f"{s_} {runtime_won[s_].as_tuple()}->"
                     f"{won[s_].as_tuple()}" for s_ in differ))
    if sorted(won) != sorted(fleet):
        raise SystemExit("the energy tuner left fleet shapes untuned")
    _say("[energy] M N K launches | tile ms W mJ/launch for: energy-tuned; "
         "plan's; general")
    sums = collections.Counter()
    for key, count in sorted(shapes.items(), key=lambda kv: kv[0][:3]):
        m, n, k, in_dt, out_dt, _ = key
        rule = plan(m, n, k, (k, 1), (n, 1), 0, 0, in_dt, in_dt).tile
        cols = []
        for name, tile in (("energy", won[(m, n, k)]), ("plan", rule),
                           ("general", DEFAULT_CONFIG)):
            got = measured.get((m, n, k, *tile.as_tuple()))
            if got is None:
                raise SystemExit(f"{(m, n, k)}: tile {tile.as_tuple()} was "
                                 "not measured for power")
            ms, watts, joules = got
            sums[name] += count * joules
            cols.append(f"{tile.as_tuple()} {ms:.4f} {watts:.1f} "
                        f"{1e3 * joules:.4f}")
        _say(f"[energy] {m} {n} {k} {count} | " + "; ".join(cols))
    _say(f"[energy] joules summed over the serving run's launches: "
         f"energy-tuned {sums['energy']:.3f} J, plan's tile "
         f"{sums['plan']:.3f} J, general path {sums['general']:.3f} J "
         f"(energy-tuned / plan {sums['energy'] / sums['plan']:.3f}, "
         f"general / energy-tuned {sums['general'] / sums['energy']:.2f})")

    # 5. serving joules, modelled against measured
    for objective, winners in (("energy", won), ("runtime", runtime_won)):
        tag = f"{objective} serve"
        eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                            chunk_tokens=64, pretune=True,
                            tune_objective=objective, device=dev)
        if any(eng.pretuned.get(s_) != winners[s_] for s_ in fleet):
            raise SystemExit(f"the {objective} engine's tiles differ from "
                             "the fleet's")
        log: collections.Counter = collections.Counter()
        (by_path, results, _), joules, secs = _metered(
            card, lambda: _serve_requests(tag, eng, cfg, log))
        srep = eng.report()
        toks = srep["generated_tokens"]
        off = {key: c for key, c in log.items()
               if key[5] is None or key[5] != eng.pretuned.get(
                   key[:3], DEFAULT_CONFIG).as_tuple()}
        attributed = sum(r.energy_j for r in results)
        _say(f"[{tag}] the h100 model: {srep['j_per_token']:.4f} J/token, "
             f"{srep['model_tokens_per_s']:.1f} tokens/s on the model clock,"
             f" mean TTFT {statistics.mean(r.ttft_model_s for r in results):.4f}"
             f" s on the model clock, {srep['energy_j']:.3f} J modelled "
             f"({srep['idle_energy_j']:.3f} J of it idle shares)")
        _say(f"[{tag}] the card (NVML): {joules:.3f} J over {secs:.3f} s "
             f"metered for {toks} tokens = {joules / toks:.4f} J/token, mean "
             f"power {joules / secs:.1f} W; measured / modelled J/token "
             f"{joules / toks / srep['j_per_token']:.2f}; launches per path "
             f"{by_path}, off their tuned tile {sum(off.values())}")
        if off:
            raise SystemExit(f"launches off their tuned tile: {off}")
        if not all(r.energy_j > 0 for r in results):
            raise SystemExit("a request was attributed no energy")
        if abs(srep["energy_j"] - attributed - srep["idle_energy_j"]) > \
                1e-9 * srep["energy_j"]:
            raise SystemExit("the report's joules are not the requests' "
                             "plus the idle shares")
    _say(f"[energy] phase 9 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")


def _first_token_share(got: list, want: list) -> tuple:
    """(share of requests whose first tokens agree, share whose whole
    streams agree) of two runs' results over the same uids."""
    want = {r.uid: r for r in want}
    first = [int(r.tokens[0] == want[r.uid].tokens[0]) for r in got]
    whole = [int(np.array_equal(r.tokens, want[r.uid].tokens)) for r in got]
    return statistics.mean(first), statistics.mean(whole)


class _Taps:
    """Record, in call order, row 0 of the output of each plain-torch op
    and GEMM a forward runs (rmsnorm, RoPE and M-RoPE, attention, the MoE
    FFN and its routing, SwiGLU, the SSM's causal conv, scans and Mamba1
    core, every `ops.matmul`, each block: encdec's encoder and decoder
    blocks too), each flattened
    position by position, so two forwards of the same row at different
    batch sizes can be compared op by op (`_first_diff`)."""

    def __init__(self, batch: int):
        self.batch, self.layer, self.log = batch, -1, []

    def _wrap(self, name: str, fn, pick=lambda out: out):
        def tapped(*args, **kw):
            out = fn(*args, **kw)
            t = pick(out)
            if torch.is_tensor(t) and t.dim() >= 2 and (
                    t.shape[0] % self.batch == 0):
                # row 0 as (positions, width): (B, S, ...) outputs by
                # position, (B * S, width) ones by token
                row = (t[0].reshape(t.shape[1], -1) if t.dim() >= 3 else
                       t.reshape(self.batch, -1, t.shape[-1])[0])
                self.log.append((f"layer {self.layer} {name}",
                                 row.detach().float().clone()))
            return out
        return tapped

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import encdec, moe, ssm
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as tfm

        self._saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (ops, "matmul"), (L, "rmsnorm"), (L, "apply_rope"),
            (L, "apply_mrope"), (L, "_sdpa"), (L, "swiglu_apply"),
            (moe, "moe_ffn"), (moe, "route"), (moe, "mla_apply"),
            (ssm, "causal_conv"), (ssm, "mamba1_scan"), (ssm, "ssd_scan"),
            (ssm, "_mamba1_core"), (tfm, "block_apply"),
            (encdec, "enc_block_apply"), (encdec, "dec_serve_block"))]
        first = lambda out: out[0]
        for mod, name, fn in self._saved:
            if name in ("enc_block_apply", "dec_serve_block"):
                def block(*a, _fn=fn, _name=name, **kw):
                    self.layer += 1
                    return self._wrap(
                        f"{_name.split('_')[0]} block output", _fn,
                        first if _name == "dec_serve_block"
                        else (lambda out: out))(*a, **kw)
                setattr(mod, name, block)
            elif name == "block_apply":
                def block_apply(cfg, _fn=fn):
                    inner = _fn(cfg)

                    def run(*a, **kw):
                        self.layer += 1
                        return self._wrap("block output", inner, first)(
                            *a, **kw)
                    return run
                setattr(mod, name, block_apply)
            elif name == "matmul":
                def matmul(a, b, _fn=fn, **kw):
                    n = b.shape[0] if kw.get("transpose_b") else b.shape[1]
                    return self._wrap(f"GEMM N={n} K={a.shape[-1]}", _fn)(
                        a, b, **kw)
                setattr(mod, name, matmul)
            elif name == "route":
                setattr(mod, name, self._wrap(
                    "MoE routing (expert ids)", fn,
                    lambda r: r["idx"].reshape(-1, 1)))
            else:
                pick = first if name in (
                    "moe_ffn", "mla_apply", "mamba1_scan", "ssd_scan",
                    "_mamba1_core") else (lambda out: out)
                setattr(mod, name, self._wrap(name, fn, pick))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _first_diff(tag: str, run_a, batch_a: int, run_b, batch_b: int,
                positions: int | None = None) -> str | None:
    """Run two forwards of the same row 0 at batch sizes `batch_a` and
    `batch_b` under `_Taps`; print the per-layer difference of row 0's
    hidden state and the first op whose row-0 output differs (over the
    positions both runs have, at most `positions`). Returns that op's
    name, or None when every op agrees bit for bit."""
    logs = []
    for run, batch in ((run_a, batch_a), (run_b, batch_b)):
        with _Taps(batch) as taps:
            run()
        torch.cuda.synchronize()
        logs.append(taps.log)
    layers, first = [], None
    for (name, a), (name_b, b) in zip(*logs):
        if name != name_b:
            raise SystemExit(f"[{tag}] the two forwards ran different ops: "
                             f"{name} against {name_b}")
        n = min(a.shape[0], b.shape[0], positions or a.shape[0])
        diff = (a[:n] - b[:n]).abs().max().item() if n else 0.0
        if first is None and not torch.equal(a[:n], b[:n]):
            first = (name, diff)
        if name.endswith("block output"):
            layers.append(f"{name.split()[1]}: {diff:.3g}")
    _say(f"[{tag}] per-layer max |diff| of row 0's hidden state, batch "
         f"{batch_a} against {batch_b}: " + ", ".join(layers))
    _say(f"[{tag}] first op whose row-0 output differs: "
         + (f"{first[0]} (max |diff| {first[1]:.3g})" if first else
            "none: every op bit-identical"))
    return first[0] if first else None


def _row_probe(dev, api, params, cfg, tag: str, widths=(1, 8), C: int = 64,
               decode_widths=(1, 4), serial: int | None = None,
               wave: tuple | None = None, max_len: int = 512) -> list:
    """Where a row's bits first depend on its batch: one row's prompt chunk
    in a chunk call `widths[0]` rows wide against one `widths[1]` rows wide
    (the other rows random), one decode step of that row at
    `decode_widths`, (with `serial`, a bucket) the row's single-shot
    prefill of the same C tokens padded to that bucket against its chunk,
    and (with `wave`, (rows, S)) the row's C tokens in a wave prefill of
    `rows` right-padded rows S long (the others S tokens) against its
    chunk. For an admit family each chunk call follows the admission of
    its rows' modality inputs (`_extras`; row 0's is request 0's, the
    others' larger, so the encoder runs at another bucket as well as
    another batch). Prints `_first_diff` for each; returns the first
    differing op of each pair (None: none)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(9)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (max(widths), C)),
                           device=dev)
    lens = torch.full((max(widths),), C, device=dev)

    def admitted(w):
        st = api.init_state(cfg, w, max_len, device=dev)
        if api.admit is None:
            return st
        extras = [_extras(cfg, i) for i in range(w)]
        need = max(max(api.admit_dims(cfg, e)) for e in extras) or 1
        bucket = min(b for b in ops.prefill_buckets(max_len) if b >= need)
        return api.admit(params, api.pack_admit(cfg, extras, w, bucket,
                                                device=dev), st, cfg)

    def chunk(w):
        def run():
            api.prefill_chunk(params, toks[:w], lens[:w], admitted(w), cfg)
        return run

    # the decode steps read a cache of random values (the same rows at
    # every width): over zeros every summation order gives the same bits
    from repro_torch.models import layers as L

    wmax = max(decode_widths)
    gen = torch.Generator(dev).manual_seed(9)
    filled = L.tree_map(
        lambda t: (torch.randn(t.shape, generator=gen, device=dev).mul_(
            0.1).to(t.dtype) if t.is_floating_point() else t),
        api.init_state(cfg, wmax, max_len, device=dev))
    axes = L.state_batch_axes(
        api.init_state(cfg, 1, max_len, device="meta"),
        api.init_state(cfg, 2, max_len, device="meta"))

    def decode(w):
        def run():
            st = L.tree_map(lambda t, ax: t.clone() if ax < 0 else
                            t.narrow(ax, 0, w).clone(), filled, axes)
            st["index"].fill_(C)
            if "src_len" in st:
                st["src_len"].fill_(C)
            api.decode_step(params, toks[:w, 0], st, cfg)
        return run

    out = [_first_diff(f"{tag} chunk {widths[0]}x{C} vs {widths[1]}x{C}",
                       chunk(widths[0]), widths[0], chunk(widths[1]),
                       widths[1]),
           _first_diff(f"{tag} decode {decode_widths[0]} vs "
                       f"{decode_widths[1]} rows", decode(decode_widths[0]),
                       decode_widths[0], decode(decode_widths[1]),
                       decode_widths[1])]
    if serial:
        # the row's C tokens right-padded to the serial bucket: the same
        # cache contents and last position as its chunk, at another M and
        # query length
        prompt = torch.zeros((1, serial), dtype=toks.dtype, device=dev)
        prompt[0, :C] = toks[0]

        def whole():
            api.prefill(params, {"tokens": prompt, "lengths": torch.full(
                (1,), C, device=dev)}, cfg, max_len=512)
        out.append(_first_diff(f"{tag} serial prefill 1x{serial} vs chunk "
                               f"{widths[1]}x{C}", whole, 1,
                               chunk(widths[1]), widths[1], positions=C))
    if wave:
        rows, S = wave
        batch = torch.as_tensor(rng.integers(0, cfg.vocab, (rows, S)),
                                device=dev)
        batch[0] = 0
        batch[0, :C] = toks[0]
        lengths = torch.full((rows,), S, device=dev)
        lengths[0] = C

        def waved():
            api.prefill(params, {"tokens": batch, "lengths": lengths}, cfg,
                        max_len=512)
        out.append(_first_diff(f"{tag} wave prefill {rows}x{S} vs chunk "
                               f"{widths[1]}x{C}", waved, rows,
                               chunk(widths[1]), widths[1], positions=C))
    return out


def _stream_gate(tag: str, got: list, want: list, probe) -> None:
    """Whole token streams of two runs must be identical. If they are not,
    `probe()` (a `_row_probe`) names the first op whose row bits depend on
    the batch: a plain-torch op keeps the gate on first tokens (phase 7's
    top-1 rule) and is printed as the cause; the hand-written GEMM, or no
    op at all, fails the phase."""
    first, whole = _first_token_share(got, want)
    _say(f"[{tag}] first tokens agree {first:.2f}, whole streams "
         f"{whole:.2f} (gate: identical)")
    if whole == 1.0:
        return
    causes = [c for c in probe() if c is not None]
    gemm = [c for c in causes if " GEMM " in c]
    _say(f"[{tag}] streams differ; ops whose row bits depend on the batch: "
         f"{causes or 'none found'}")
    if not causes or gemm:
        raise SystemExit(f"[{tag}] streams differ and the probe names "
                         f"{gemm or 'no op'}")
    if first < LOGITS_TOP1_MIN:
        raise SystemExit(f"[{tag}] first tokens disagree beyond the plain-"
                         f"torch op {causes[0]}")
    _say(f"[{tag}] gate kept on first tokens (min {LOGITS_TOP1_MIN:g}): the "
         f"first difference is the plain-torch op {causes[0]}")


def _free() -> None:
    """Collect what the caller dropped and hand its memory on the card back
    to the allocator."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _paged_forward_check(dev, api, params, cfg, W: int = 8, C: int = 64,
                         steps: int = 2) -> None:
    """The paged layout at full width, exactly: one W x C chunk call and
    `steps` decode steps through a dense state and through a paged state
    whose rows own shuffled pages of a larger pool. Both issue the same
    GEMMs at the same shapes, so logits and cached keys and values must be
    bit-identical. (Two engine runs issue chunk GEMMs of other M — the
    paged lane narrows to the rows still prefilling while the dense lane
    keeps its parked rows — and are compared by `_stream_gate`.)"""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import init_kv_page_pool

    T, max_len = 64, 512
    n_pg = max_len // T
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (W, C)), device=dev)
    lens = torch.as_tensor(rng.integers(1, C + 1, W), device=dev)
    pages = 1 + rng.permutation(2 * W * n_pg)[:W * n_pg]
    table = torch.as_tensor(pages.reshape(W, n_pg), device=dev)
    dense = api.init_state(cfg, W, max_len, device=dev)
    pool = init_kv_page_pool(cfg, 2 * W * n_pg + 1, T, device=dev)
    paged = {"kv": {**pool, "table": table[None].expand(cfg.n_layers, W,
                                                         n_pg)},
             "index": torch.zeros(W, dtype=torch.long, device=dev)}
    same = []
    got = [api.prefill_chunk(params, toks, lens, st, cfg)
           for st in (dense, paged)]
    for step in range(steps + 1):
        (ld, dense), (lp, paged) = got
        same.append(torch.equal(ld, lp))
        if step == steps:
            break
        tok = ld.argmax(-1)
        got = [api.decode_step(params, tok, st, cfg)
               for st in (dense, paged)]
    torch.cuda.synchronize()
    idx = dense["index"]
    valid = torch.arange(max_len, device=dev)[None, :] < idx[:, None]
    kv_same = all(
        torch.equal(dense["kv"][k][i][valid],
                    L.paged_gather(pool[f"{k}_pages"][i], table)[valid])
        for k in ("k", "v") for i in range(cfg.n_layers))
    _say(f"[dense] {cfg.name} paged state against dense state, the same "
         f"{W}x{C} chunk call and {steps} decode steps at full width: "
         f"logits bit-identical {same}, cached keys and values of all "
         f"{cfg.n_layers} layers bit-identical {kv_same}")
    if not (all(same) and kv_same):
        raise SystemExit("the paged layout changed a forward's output")


def _prefix_pair(tag: str, engine, cfg, run, log, probe) -> None:
    """The shared-prefix workload (`_prefix_requests`) served dense and
    paged with prefix reuse at half the default page pool: request 0 alone
    (its prompt's pages are registered when its prefill ends), then the
    other 9 together. Prefix reuse must hit and save chunk steps. The paged
    streams must equal the dense ones (`_stream_gate`), except for the MoE
    families under a binding capacity: there a row's expert capacity comes
    from its chunk's length, and a prefix hit changes the chunk buckets of
    the rest of the prompt (the JAX package's contract too: cross-chunk-
    grid parity is out of it, `tests/test_moe_capacity.py`), so their
    streams are held to phase 7's first-token rule."""
    full_pool = engine(kv_layout="paged")._allocator.num_pages
    prefix: dict = {}
    for layout, kw in (("dense", {}),
                       ("paged", dict(kv_layout="paged", prefix_cache=True,
                                      num_pages=full_pool // 2))):
        eng = engine(**kw)
        reqs = _prefix_requests(cfg)
        name = f"{tag} (c) prefix {layout}"
        run(f"{name}, request 0", eng, cfg, log, reqs[:1])
        res, rep = run(f"{name}, the other 9", eng, cfg, log, reqs[1:])
        prefix[layout] = (res, rep, eng.report().get("paging"))
        del eng
        _free()
    (res_d, rep_d, _), (res_p, rep_p, paging) = prefix["dense"], \
        prefix["paged"]
    if cfg.n_experts:
        first, whole = _first_token_share(res_p, res_d)
        _say(f"[{tag} (c) prefix reuse against dense] first tokens agree "
             f"{first:.2f} (min {LOGITS_TOP1_MIN:g}), whole streams "
             f"{whole:.2f} (per-row capacity follows the chunk buckets, "
             "which a prefix hit changes)")
        if first < LOGITS_TOP1_MIN:
            raise SystemExit("prefix reuse changed the first tokens")
    else:
        _stream_gate(f"{tag} (c) prefix reuse against dense", res_p, res_d,
                     probe)
    _say(f"[{tag}] (c) the 9 sharing a {PREFIX_TOKENS}-token prefix, "
         f"paged with prefix reuse ({full_pool // 2} of {full_pool} pages) "
         f"against dense: chunk steps {rep_p['chunk_steps']} against "
         f"{rep_d['chunk_steps']}; prefix hits {paging['prefix_hits']} "
         f"({paging['prefix_hit_tokens']} tokens), COW forks "
         f"{paging['cow_forks']}, peak pages in use {paging['peak_in_use']};"
         f" mean TTFT {statistics.mean(r.ttft_s for r in res_p):.3f} s "
         f"against {statistics.mean(r.ttft_s for r in res_d):.3f} s; the "
         f"h100 model's J/token "
         f"{rep_p['energy_j'] / rep_p['generated_tokens']:.4f} against "
         f"{rep_d['energy_j'] / rep_d['generated_tokens']:.4f}")
    if not (paging["prefix_hits"] > 0
            and rep_p["chunk_steps"] < rep_d["chunk_steps"]):
        raise SystemExit("prefix reuse missed or saved no chunk step")


# phase 10 serves qwen2.5-14b at full width but 16 of its 48 layers: every
# serving mode and gate runs as at full depth, and the cut keeps the whole
# script inside its 1,100 s with phase 16 and phase 9's capped power
# windows on the slowest host seen (1108.5 s at 48 layers before the
# windows, phase 10 about 1.5 s a layer there; the windows add 30-45 s, so
# 32 layers would take about 1,120 s and 16 about 1,100 s)
DENSE_LAYERS = 16


def phase_dense(dev) -> dict:
    """The rest of dense serving at `plan`'s tiles (no tuned winner is
    installed): qwen2.5-14b served chunked, paged, with prefix reuse,
    serially and in waves; then codeqwen1.5-7b and starcoder2-3b. Returns
    {"entries": qwen2.5-14b's per-path timing (phase 5's form), "launches":
    {model: launches per path}, "shapes": {"qwen2.5-14b": (a)'s launches by
    shape}}."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    ops._TUNED.clear()
    launches: dict = collections.defaultdict(collections.Counter)
    untuned: collections.Counter = collections.Counter()

    def run(tag, eng, cfg, log, reqs=None) -> tuple:
        """One checked serving run at plan's tiles, none on general."""
        rec: collections.Counter = collections.Counter()
        by_path, res, rep = _serve_requests(tag, eng, cfg, rec, reqs)
        log.update(rec)
        untuned.update({k: c for k, c in rec.items() if k[5] is not None})
        launches[cfg.name].update(by_path)
        if by_path["general"] or untuned:
            raise SystemExit(f"[{tag}] launches on general or off plan's "
                             f"tiles: {by_path}, {dict(untuned)}")
        return res, rep

    # qwen2.5-14b at full width, cut in depth
    cfg, api, params = _init_model(dev, "qwen2.5-14b", "dense",
                                   layers=DENSE_LAYERS)

    def engine(**kw):
        return ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                             chunk_tokens=64, device=dev, **kw)

    name = cfg.name
    shapes: collections.Counter = collections.Counter()
    other: collections.Counter = collections.Counter()
    eng_a = engine()
    res_a, rep_a = run(f"dense {name} (a) chunked", eng_a, cfg, shapes)
    _paged_forward_check(dev, api, params, cfg)
    eng_b = engine(kv_layout="paged", prefix_cache=False)
    res_b, _ = run(f"dense {name} (b) paged", eng_b, cfg, other)
    _say(f"[dense] {name} (b) pages {eng_b.report()['paging']}")
    probed: list = []

    def probe():
        """`_row_probe` of qwen2.5-14b, run once on the first failing gate:
        lane widths 1 and 8, decode 1 and 4 rows, a serial 512 bucket."""
        if not probed:
            probed.extend(_row_probe(dev, api, params, cfg,
                                     f"dense {name} probe", serial=512))
        return probed

    _stream_gate(f"dense {name} (b) paged without prefix reuse against (a)",
                 res_b, res_a, probe)
    del eng_b
    _free()

    # (c) a shared system prompt, dense and paged with prefix reuse
    _prefix_pair(f"dense {name}", engine, cfg, run, other, probe)

    # (d) serial admission, (e) the wave loop
    res_s, _ = run(f"dense {name} (d) serial", engine(admission="serial"),
                   cfg, other)
    _say(f"[dense] {name} (d) serial: mean TTFT "
         f"{statistics.mean(r.ttft_s for r in res_s):.3f} s against "
         f"{statistics.mean(r.ttft_s for r in res_a):.3f} s chunked")
    _stream_gate(f"dense {name} (d) serial against (a) chunked", res_s,
                 res_a, probe)
    run(f"dense {name} (e) wave", engine(mode="wave"), cfg, other,
        _requests(cfg)[:4])
    _free()

    phase_logits(dev, eng_a, params, cfg, tag=f"dense logits {name}")
    entries = phase_serving_shapes(dev, shapes, tag=f"dense shapes {name}")
    del eng_a, params
    _free()

    # codeqwen1.5-7b and starcoder2-3b
    for arch in ("codeqwen1.5-7b", "starcoder2-3b"):
        cfg, api, params = _init_model(dev, arch, "dense")
        eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                            chunk_tokens=64, device=dev)
        phase_logits(dev, eng, params, cfg, tag=f"dense logits {arch}")
        run(f"dense {arch} chunked", eng, cfg, other)
        del eng, params
        _free()

    for model, by_path in launches.items():
        _say(f"[dense] launches per path, {model}: stream "
             f"{by_path['stream']}, wgmma {by_path['wgmma']}, general "
             f"{by_path['general']}")
    total = sum(launches.values(), collections.Counter())
    if total["stream"] == 0 or total["wgmma"] == 0:
        raise SystemExit(f"phase 10 left a fast path unlaunched: {total}")
    _say(f"[dense] phase 10 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")
    return {"entries": entries, "launches": dict(launches),
            "shapes": {name: shapes}}


# phases 11 and 17: deepseek-v2-236b's depth on one card. The whole model
# is 239.4 B parameters (478.7 GB in bf16); a layer is 3.97 B (7.94 GB),
# the embedding and head 2.1 GB, and the init's largest f32 draw (one
# layer's 160 x 5120 x 1536 experts) 5.0 GB. 8 layers (65.7 GB) fit phase
# 11 but cannot be built twice; at 4 (33.9 GB) phase 17's second rank
# builds its whole copy beside the first rank's cut half (17.0 GB), and
# phase 11 serves the same depth for phase 17's tp=1 streams.
DEEPSEEK_LAYERS = 4
# phase 11 (b): the prompt length of the capacity check (olmoe's capacity
# factor 1.25 gives 10 slots per row and expert at S = 64 and top-8 of 64)
CAPACITY_PROMPT = 64


def phase_moe(dev) -> dict:
    """MoE and MLA serving at `plan`'s tiles: full-width, full-depth
    olmoe-1b-7b served (a) chunked on the dense KV cache (and on the paged
    cache without prefix reuse: identical streams), (b) in the wave loop, a
    64-token request alone and then beside 3 others of its length (per-row
    expert capacity binds; the streams must be identical; beside it one
    row's ops at batch 1 and 4, compared bit for bit), and (c) the
    shared-prefix workload dense and paged with prefix reuse;
    then deepseek-v2-236b at full width cut to `DEEPSEEK_LAYERS` layers
    (the depth both of phase 17's ranks can build in turn on the card),
    served chunked on the dense latent cache and on the paged latent pool
    (identical streams), and (c) phase 17's requests `TP_UIDS` alone.
    Each model: the logits check, launches per forward from the model's
    structure (81 for olmoe, 11 L + 1 for deepseek), none on general, the
    routers counted apart, and its serving shapes timed as in phase 5.
    Returns {"entries": {model: per-path timing}, "launches": {model:
    launches per path}, "streams": {"deepseek-v2-236b": (c)'s streams by
    uid}}, the last for phase 17."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving.engine import Request, ServingEngine

    t_phase = time.perf_counter()
    ops._TUNED.clear()
    launches: dict = collections.defaultdict(collections.Counter)
    entries: dict = {}

    def run(tag, eng, cfg, log, reqs=None) -> tuple:
        """One checked serving run at plan's tiles, none on general."""
        rec: collections.Counter = collections.Counter()
        by_path, res, rep = _serve_requests(tag, eng, cfg, rec, reqs)
        log.update(rec)
        launches[cfg.name].update(by_path)
        if by_path["general"] or any(k[5] is not None for k in rec):
            raise SystemExit(f"[{tag}] launches on general or off plan's "
                             f"tiles: {by_path}")
        return res, rep

    def engines(api, params, cfg):
        return lambda **kw: ServingEngine(api, params, cfg, max_batch=4,
                                          max_len=512, chunk_tokens=64,
                                          device=dev, **kw)

    # olmoe-1b-7b at full width and depth
    cfg, api, params = _init_model(dev, "olmoe-1b-7b", "moe")
    name, engine = cfg.name, engines(api, params, cfg)
    shapes: collections.Counter = collections.Counter()
    other: collections.Counter = collections.Counter()
    eng_a = engine()
    res_a, _ = run(f"moe {name} (a) chunked", eng_a, cfg, shapes)
    phase_logits(dev, eng_a, params, cfg, tag=f"moe logits {name}")
    # one row at two batch sizes, op by op: the evidence behind (b)
    probed = _row_probe(dev, api, params, cfg, f"moe {name} probe",
                        widths=(1, 4))
    res_p, _ = run(f"moe {name} paged, no prefix reuse",
                   engine(kv_layout="paged", prefix_cache=False), cfg, other)
    _stream_gate(f"moe {name} paged without prefix reuse against (a)", res_p,
                 res_a, lambda: probed)

    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab, (4, CAPACITY_PROMPT)).astype(
        np.int32)
    waves = {}
    for n in (1, 4):
        # sampled (seeded per request), so the stream does not collapse to
        # one token as a random model's greedy stream does
        res, _ = run(f"moe {name} (b) wave of {n}",
                     engine(mode="wave", greedy=False, seed=3), cfg, other,
                     [Request(uid=i, prompt=prompts[i].copy(),
                              max_new_tokens=16) for i in range(n)])
        waves[n] = [r for r in res if r.uid == 0]
    _say(f"[moe] {name} (b) capacity {moe.capacity(cfg, CAPACITY_PROMPT)} "
         f"slots per row and expert at S = {CAPACITY_PROMPT} (cf "
         f"{cfg.capacity_factor}, top-{cfg.top_k} of {cfg.n_experts}); "
         f"request 0 alone: {waves[1][0].tokens.tolist()}")
    _stream_gate(f"moe {name} (b) request 0 alone against beside 3 others",
                 waves[1], waves[4], lambda: probed)
    _prefix_pair(f"moe {name}", engine, cfg, run, other, lambda: probed)
    entries[name] = phase_serving_shapes(dev, shapes, tag=f"moe shapes {name}")
    del eng_a, params, engine
    _free()

    # deepseek-v2-236b at full width, cut in depth
    full = get_config("deepseek-v2-236b")
    cfg, api, params = _init_model(dev, "deepseek-v2-236b", "mla",
                                   layers=DEEPSEEK_LAYERS)
    name, engine = cfg.name, engines(api, params, cfg)
    cut = cfg.n_params() / full.n_params()
    _say(f"[mla] {name} cut in depth to {cfg.n_layers} of {full.n_layers} "
         f"layers ({cfg.n_params() / 1e9:.1f} of {full.n_params() / 1e9:.1f}"
         f" B params, {100 * cut:.1f}%), full width: d_model {cfg.d_model}, "
         f"{cfg.n_heads} heads of {cfg.hd}, kv_lora {cfg.kv_lora_rank}, "
         f"q_lora {cfg.q_lora_rank}, rope {cfg.rope_head_dim}, "
         f"{cfg.n_experts} routed experts top-{cfg.top_k}, "
         f"{cfg.n_shared_experts} shared, vocab {cfg.vocab}; memory "
         f"allocated {torch.cuda.memory_allocated() / 1e9:.1f} GB of "
         f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}")
    shapes = collections.Counter()
    eng_a = engine()
    phase_logits(dev, eng_a, params, cfg, W=8, tag=f"mla logits {name}")
    res_a, _ = run(f"mla {name} (a) chunked, dense latent cache", eng_a, cfg,
                   shapes)
    res_p, _ = run(f"mla {name} (b) paged latent pool",
                   engine(kv_layout="paged"), cfg, other)
    _stream_gate(f"mla {name} (b) paged against (a)", res_p, res_a,
                 lambda: _row_probe(dev, api, params, cfg,
                                    f"mla {name} probe"))
    # phase 17's requests alone: a row's expert capacity follows its chunk
    # call's bucket, which the other requests of a batch move, so (a)'s
    # streams are not these four's
    res_t, _ = run(f"mla {name} (c) phase 17's requests {TP_UIDS} alone",
                   engine(), cfg, other, [_requests(cfg)[u] for u in TP_UIDS])
    entries[name] = phase_serving_shapes(dev, shapes, tag=f"mla shapes {name}")
    streams = {full.name: {r.uid: r.tokens.tolist() for r in res_t}}
    del eng_a, params, engine
    _free()

    for model, by_path in launches.items():
        _say(f"[moe] launches per path, {model}: stream {by_path['stream']}, "
             f"wgmma {by_path['wgmma']}, general {by_path['general']}")
    _say(f"[moe] phase 11 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")
    return {"entries": entries, "launches": dict(launches),
            "streams": streams}


# phase 12: the prompt past max_len = 512 that falcon-mamba-7b (no KV
# cache, so no length bound) serves, and its budget
LONG_PROMPT, LONG_BUDGET = 700, 16


# phases 12 and 17's SSM and hybrid depths: cut (64 and 54 layers
# published) to win back the seconds of phase 18 (d)
SSM_LAYERS = {"falcon-mamba-7b": 32, "zamba2-2.7b": 30}


def phase_ssm(dev) -> dict:
    """SSM and hybrid serving at `plan`'s tiles: full-width
    falcon-mamba-7b (its tied LM head on `stream`'s (N, K) layout) and
    zamba2-2.7b at `SSM_LAYERS` layers, one model on the card at a
    time. Each: the logits check
    (with torch.matmul's distance beside it), the 10 requests chunked,
    serially and in the wave loop (streams identical to the chunked ones:
    `_stream_gate`, with `_row_probe` behind it), launches per forward from
    the model's structure (257 and 172) and none on general, its serving
    shapes timed as in phase 5, and its peak device memory; falcon-mamba-7b
    also serves a `LONG_PROMPT`-token prompt past max_len = 512, chunked and
    in the wave loop (identical streams). Returns {"entries": {model:
    per-path timing}, "launches": {model: launches per path}, "streams":
    {model: (a)'s streams by uid}}, the last for phase 17."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request, ServingEngine

    t_phase = time.perf_counter()
    ops._TUNED.clear()
    launches: dict = collections.defaultdict(collections.Counter)
    entries: dict = {}
    streams: dict = {}

    def run(tag, eng, cfg, log, reqs=None) -> tuple:
        """One checked serving run at plan's tiles, none on general."""
        rec: collections.Counter = collections.Counter()
        by_path, res, rep = _serve_requests(tag, eng, cfg, rec, reqs)
        log.update(rec)
        launches[cfg.name].update(by_path)
        if by_path["general"] or any(k[5] is not None for k in rec):
            raise SystemExit(f"[{tag}] launches on general or off plan's "
                             f"tiles: {by_path}")
        return res, rep

    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        t_model = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, api, params = _init_model(dev, arch, "ssm", SSM_LAYERS[arch])
        name = cfg.name

        def engine(**kw):
            return ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                                 chunk_tokens=64, device=dev, **kw)

        _say(f"[ssm] {name}: kind {cfg.kind}, d_inner {cfg.d_inner}, "
             f"d_state {cfg.ssm_state}, "
             + (f"{cfg.n_layers // cfg.attn_every} shared-attention "
                f"applications (heads {cfg.n_heads}, d_ff {cfg.d_ff}), "
                if cfg.kind == "hybrid" else "")
             + f"tied head {cfg.tie_embeddings}; {_gemms_per_forward(cfg)} "
             f"GEMMs per forward")
        probed: list = []

        def probe():
            """`_row_probe`, run once on the first failing gate."""
            if not probed:
                probed.extend(_row_probe(dev, api, params, cfg,
                                         f"ssm {name} probe", serial=512,
                                         wave=(4, 300)))
            return probed

        shapes: collections.Counter = collections.Counter()
        other: collections.Counter = collections.Counter()
        eng_a = engine()
        phase_logits(dev, eng_a, params, cfg, tag=f"ssm logits {name}")
        res_a, rep_a = run(f"ssm {name} (a) chunked", eng_a, cfg, shapes)
        streams[name] = {r.uid: r.tokens.tolist() for r in res_a}
        res_s, _ = run(f"ssm {name} (b) serial", engine(admission="serial"),
                       cfg, other)
        _stream_gate(f"ssm {name} (b) serial against (a) chunked", res_s,
                     res_a, probe)
        res_w, _ = run(f"ssm {name} (c) wave", engine(mode="wave"), cfg,
                       other)
        _stream_gate(f"ssm {name} (c) wave against (a) chunked", res_w,
                     res_a, probe)
        if cfg.attention_free:
            rng = np.random.default_rng(11)
            long = [Request(uid=500, prompt=rng.integers(
                0, cfg.vocab, LONG_PROMPT).astype(np.int32),
                max_new_tokens=LONG_BUDGET)]
            res_l, rep_l = run(f"ssm {name} (d) a {LONG_PROMPT}-token prompt "
                               f"past max_len 512, chunked", eng_a, cfg,
                               shapes, [dataclasses.replace(long[0])])
            res_lw, _ = run(f"ssm {name} (d) the same prompt, wave",
                            engine(mode="wave"), cfg, other,
                            [dataclasses.replace(long[0])])
            _say(f"[ssm] {name} (d) {LONG_PROMPT} prompt tokens in "
                 f"{rep_l['chunk_steps']} chunk steps, {res_l[0].n_tokens} "
                 f"tokens, TTFT {res_l[0].ttft_s:.3f} s")
            _stream_gate(f"ssm {name} (d) wave against chunked", res_lw,
                         res_l, probe)
        entries[name] = phase_serving_shapes(
            dev, shapes, tag=f"ssm shapes {name}",
            tied=((cfg.vocab, cfg.d_model),) if cfg.tie_embeddings else ())
        _say(f"[ssm] {name}: launches per path {dict(launches[name])}; "
             f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
             f" GB; {time.perf_counter() - t_model:.1f} s")
        del eng_a, params, engine
        _free()

    _say(f"[ssm] phase 12 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")
    return {"entries": entries, "launches": dict(launches),
            "streams": streams}


def _admit_ms(dev, eng, cfg, reqs: list) -> str:
    """The admission call's time per request, CUDA events around the call
    (median of 5 after a warm-up): request 0 alone, and `reqs`' first four
    in one packed call (as chunked admission packs a step's arrivals)."""
    from repro_torch.core.profiler import time_ms

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = []
    for group in (reqs[:1], reqs[:4]):
        w = len(group)
        need = max(max(eng._admit_dims(r)) for r in group) or 1
        bucket = eng._bucket(need)
        packed = eng.model.pack_admit(cfg, [r.extras for r in group], w,
                                      bucket, device=dev)
        state = eng._init_state(w)
        ms = time_ms(lambda: eng.model.admit(eng.params, packed, state, cfg),
                     flush, 5)
        out.append(f"{w} x {bucket} rows {ms:.3f} ms ({ms / w:.3f} ms a "
                   f"request)")
        del state
    return "; ".join(out)


def phase_admit(dev) -> dict:
    """Encoder-decoder and vision serving at `plan`'s tiles: full-width,
    full-depth seamless-m4t-medium (max_len 512; the LM head on padded rows)
    and qwen2-vl-2b (max_len 2048: a 32 x 32 image and a 300-token prompt
    in a row), one model on the card at a time. Each: the logits check after
    admission (`phase_logits`), the 10 requests with their modality inputs
    chunked, serially, in the wave loop and on the paged KV layout (streams
    identical to the chunked ones: `_stream_gate`, with `_row_probe` behind
    it, the encoder included), launches per forward and per admission call
    from the model's structure (97 + 96 and 197 + 196) and none on general,
    the admission's time per request, its serving shapes timed as in phase
    5, and its peak device memory. Returns {"entries": {model: per-path
    timing}, "launches": {model: launches per path}}."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    ops._TUNED.clear()
    launches: dict = collections.defaultdict(collections.Counter)
    entries: dict = {}

    def run(tag, eng, cfg, log) -> tuple:
        """One checked serving run at plan's tiles, none on general."""
        rec: collections.Counter = collections.Counter()
        by_path, res, rep = _serve_requests(tag, eng, cfg, rec)
        log.update(rec)
        launches[cfg.name].update(by_path)
        if by_path["general"] or any(k[5] is not None for k in rec):
            raise SystemExit(f"[{tag}] launches on general or off plan's "
                             f"tiles: {by_path}")
        return res, rep

    for arch in ("seamless-m4t-medium", "qwen2-vl-2b"):
        t_model = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, api, params = _init_model(dev, arch, "admit")
        name, ml = cfg.name, MAX_LEN.get(arch, 512)

        def engine(**kw):
            return ServingEngine(api, params, cfg, max_batch=4, max_len=ml,
                                 chunk_tokens=64, page_size=64, device=dev,
                                 **kw)

        reqs = _requests(cfg)
        _say(f"[admit] {name}: kind {cfg.kind}, max_len {ml}, "
             + (f"{cfg.n_encoder_layers} encoder layers, sources of "
                f"{min(SOURCE_FRAMES)}-{max(SOURCE_FRAMES)} frames, "
                if cfg.kind == "encdec" else
                f"M-RoPE sections {cfg.mrope_sections}, patch prefixes of "
                f"{sorted({a * b for a, b in filter(None, PATCH_GRIDS)})} "
                f"and one text-only request, ")
             + f"head stride {params.head['w'].stride()}; "
             f"{_gemms_per_forward(cfg)} GEMMs per forward, "
             f"{_gemms_per_admission(cfg)} per admission call")
        probed: list = []

        def probe():
            """`_row_probe`, run once on the first failing gate."""
            if not probed:
                probed.extend(_row_probe(dev, api, params, cfg,
                                         f"admit {name} probe", max_len=ml))
            return probed

        shapes: collections.Counter = collections.Counter()
        other: collections.Counter = collections.Counter()
        eng_a = engine()
        phase_logits(dev, eng_a, params, cfg, W=8, tag=f"admit logits {name}")
        res_a, _ = run(f"admit {name} (a) chunked", eng_a, cfg, shapes)
        for mode, kw in (("(b) serial", dict(admission="serial")),
                         ("(c) wave", dict(mode="wave")),
                         ("(d) paged", dict(kv_layout="paged"))):
            eng = engine(**kw)
            res, _ = run(f"admit {name} {mode}", eng, cfg, other)
            if mode == "(d) paged":
                pg = eng.report()["paging"]
                _say(f"[admit] {name} (d) paged: prefix hits "
                     f"{pg['prefix_hits']} (admit families never reuse), "
                     f"peak pages {pg['peak_in_use']}")
                if pg["prefix_hits"]:
                    raise SystemExit(f"[admit] {name}: a prefix hit")
            _stream_gate(f"admit {name} {mode} against (a) chunked", res,
                         res_a, probe)
            del eng
        _say(f"[admit] {name} admission call: "
             f"{_admit_ms(dev, eng_a, cfg, reqs)}")
        entries[name] = phase_serving_shapes(dev, shapes,
                                             tag=f"admit shapes {name}")
        _say(f"[admit] {name}: launches per path {dict(launches[name])}; "
             f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
             f" GB; {time.perf_counter() - t_model:.1f} s")
        del eng_a, params, engine
        _free()

    _say(f"[admit] phase 13 took {time.perf_counter() - t_phase:.1f} s on "
         f"{_nvidia_smi()}")
    return {"entries": entries, "launches": dict(launches)}


# phase 14: the fleet mix of the JAX package's serving bench
# (`benchmarks/bench_serving.py` `_fleet_workload`: long best-effort
# "batch" prompts queued ahead of a burst of short SLO-bound "interactive"
# ones) at the card's geometry, on fleets of qwen2-7b engines that share
# phase 4's weights
FLEET_LONG, FLEET_SHORT = 4, 12
FLEET_LONG_LEN = 384
FLEET_SHORT_LEN = (8, 16)
FLEET_BUDGETS = (4, 8, 32)
# (a)'s two members in the reference's two-member shape: one priced on the
# card, one on the paper's RTX 4070 (both run on the one H100); (b)'s three
FLEET_CHIPS = {"h100": "h100", "ada": "rtx4070"}
CHAOS_CHIPS = {"h100-a": "h100", "h100-b": "h100", "ada": "rtx4070"}
# the interactive TTFT bound on the fleet model clock: this many times the
# h100 model's TTFT of a 16-token prompt on an idle member (one 1 x 16
# chunk step), room for the chunk steps of the batch prompts ahead of it
FLEET_SLO_STEPS = 4.0
# the JAX package's fleet smoke gates (attainment, fleet J/token over the
# best single engine's), set for its tiny model: printed beside the card's
# run, not gated
REF_ATTAIN_MIN, REF_JTOK_RATIO_MAX = 0.95, 1.0
# (b)'s fault plan, in fractions of the fault-free run's makespan: predictor
# artifact corruption on h100-b, a stall of ada (step time x8; the
# straggler detector must flag it after `CHAOS_PATIENCE` slow steps and the
# scheduler evict it, its rows migrating), then a crash of h100-b that loses
# its device state (its requests replay)
CHAOS_CORRUPT_AT = 0.05
CHAOS_STALL_AT, CHAOS_STALL_FOR, CHAOS_STALL_FACTOR = 0.1, 0.5, 8.0
CHAOS_CRASH_AT = 0.45
CHAOS_PATIENCE = 2


def _fleet_requests(cfg) -> list:
    """(Request, SLA class) of the fleet mix, fresh objects from a seeded
    generator: `FLEET_LONG` batch prompts of `FLEET_LONG_LEN` tokens ahead
    of `FLEET_SHORT` interactive prompts of 8-16, budgets from
    `FLEET_BUDGETS`."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    out = []
    for uid in range(FLEET_LONG + FLEET_SHORT):
        batch = uid < FLEET_LONG
        n = (FLEET_LONG_LEN if batch else
             int(rng.integers(FLEET_SHORT_LEN[0], FLEET_SHORT_LEN[1] + 1)))
        prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
        out.append((Request(uid=uid, prompt=prompt, max_new_tokens=int(
            rng.choice(FLEET_BUDGETS))), "batch" if batch else "interactive"))
    return out


def _fleet_engine(api, params, cfg, dev, chip: str, **kw):
    """One fleet member: phase 4's geometry, priced on `chip`."""
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                         chunk_tokens=64, chip=chip, device=dev, **kw)


def _serve_fleet(tag: str, sched, cfg, log: collections.Counter) -> tuple:
    """Serve the fleet mix through `sched` with the launch counters set to
    0 just before and read just after, every GEMM launch recorded in `log`.
    Gates: every request has one terminal disposition and finishes once,
    launches = one forward's GEMMs x the forwards every member dispatched,
    each at `plan`'s tile and none on general, the fleet ledger sums from
    the members and holds every request's joules. Returns ({uid: Result},
    the report, the requests, the launches per path)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    reqs = _fleet_requests(cfg)
    for r, sla in reqs:
        sched.submit(r, sla=sla)
    shapes: collections.Counter = collections.Counter()
    ops.tiled_matmul = _recording(shapes)
    try:
        tiled_matmul.launches = 0
        tiled_matmul.launches_by_path.update(
            dict.fromkeys(tiled_matmul.launches_by_path, 0))
        t0 = time.perf_counter()
        results = sched.run_until_empty()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tiled_matmul.launches
        by_path = dict(tiled_matmul.launches_by_path)
    finally:
        ops.tiled_matmul = tiled_matmul
    log.update(shapes)
    rep = sched.report()
    engines = rep["engines"]
    forwards = sum(e["engine"]["chunk_steps"] + e["engine"]["decode_steps"]
                   for e in engines.values())
    per_forward = _gemms_per_forward(cfg)
    tuned = sum(c for key, c in shapes.items() if key[5] is not None)
    toks = rep["generated_tokens"]
    _say(f"[fleet {tag}] {len(results)} requests, {toks} tokens, wall "
         f"{wall:.3f} s, {toks / wall:.2f} tokens/s; routed "
         + ", ".join(f"{n} {e['routed']}" for n, e in engines.items())
         + f"; makespan {rep['makespan_model_s']:.4f} s, fleet "
         f"{rep['fleet_energy_j']:.2f} J, {rep['fleet_j_per_token']:.4f} "
         f"J/token (model clock, the energy model's members), attainment "
         f"{rep['attainment']:.3f}, parks {rep['parks']}, drains "
         f"{rep['drains']}")
    _say(f"[fleet {tag}] kernel launches {launches} = {per_forward} x "
         f"{forwards} forwards? {launches == per_forward * forwards}; by "
         f"path {by_path}; off plan's tile {tuned}")
    if (launches != per_forward * forwards or launches == 0
            or by_path["general"] != 0 or sum(by_path.values()) != launches
            or tuned):
        raise SystemExit(f"[fleet {tag}] the members did not launch the "
                         f"kernel {per_forward} times per forward at plan's "
                         "tiles")
    log_ = sched.request_log
    by_uid = {r.uid: r for r in results}
    uids = [r.uid for r, _ in reqs]
    if (sorted(log_) != uids or sorted(by_uid) != uids
            or len(results) != len(uids)
            or any(d["status"] != "ok" for d in log_.values())):
        raise SystemExit(f"[fleet {tag}] requests not finished exactly once: "
                         f"{sorted(by_uid)}, dispositions "
                         f"{ {u: d['status'] for u, d in log_.items()} }")
    ledger = sum(e["engine"]["energy_j"] + e["gap_idle_j"]
                 for e in engines.values())
    attributed = sum(r.energy_j for r in results)
    if (abs(ledger - rep["fleet_energy_j"]) > 1e-9 * rep["fleet_energy_j"]
            or attributed > rep["fleet_energy_j"] * (1 + 1e-9)):
        raise SystemExit(f"[fleet {tag}] ledger {rep['fleet_energy_j']} J "
                         f"against members {ledger} J, requests "
                         f"{attributed} J")
    rep["wall_s"] = wall
    return by_uid, rep, reqs, by_path


def _same_streams(tag: str, got: dict, want: dict, probe) -> None:
    """`_stream_gate` over two runs' results by uid."""
    _stream_gate(tag, [got[u] for u in sorted(got)],
                 [want[u] for u in sorted(want)], probe)


def phase_fleet(dev, api, params, cfg) -> dict:
    """The predictor-driven fleet scheduler and fault recovery on the card,
    on phase 4's qwen2-7b weights, shared by every member, at `plan`'s
    tiles: (a) routing: the fleet mix through a two-member fleet and
    through each member alone (`route_to`), streams identical; (b) chaos:
    a three-member fleet under artifact corruption, a stall the straggler
    detector must catch (rows migrate) and a crash that loses device state
    (requests replay), against the same fleet without faults; (c) page
    pressure: two paged members, half of each pool squeezed while its first
    requests are served. Returns {"entries": per-path timing of the
    phase's shapes, "launches": launches per path}."""
    from repro_torch.kernels import ops
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    from repro_torch.serving.scheduler import FleetScheduler, SLAClass
    from repro_torch.train.ft import StragglerConfig

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops._TUNED.clear()
    log: collections.Counter = collections.Counter()
    launched: collections.Counter = collections.Counter()
    probe = lambda: _row_probe(dev, api, params, cfg, "fleet probe")
    idle_s = _fleet_engine(api, params, cfg, dev, "h100").fused_step_estimate(
        1, 16).step_s
    slo = FLEET_SLO_STEPS * idle_s
    _say(f"[fleet] interactive TTFT SLO {slo * 1e3:.3f} ms on the fleet "
         f"model clock: {FLEET_SLO_STEPS:g} x the h100 model's TTFT of a "
         f"16-token prompt on an idle member ({idle_s * 1e3:.3f} ms)")

    def fleet(chips, policy: dict | None = None, **kw):
        engines = {name: _fleet_engine(api, params, cfg, dev, chip)
                   for name, chip in chips.items()}
        return FleetScheduler(engines, sla={
            "interactive": SLAClass("interactive", slo, **(policy or {})),
            "batch": SLAClass("batch", None)}, **kw)

    # (a) routing
    runs = {}
    for label, route_to in (("fleet", None), ("h100", "h100"),
                            ("ada", "ada")):
        by_uid, rep, _, by_path = _serve_fleet(
            f"(a) {label}", fleet(FLEET_CHIPS, route_to=route_to), cfg, log)
        runs[label] = (by_uid, rep)
        launched.update(by_path)
    ref = runs["fleet"][0]
    for label in ("h100", "ada"):
        _same_streams(f"fleet (a) {label} alone against the fleet",
                      runs[label][0], ref, probe)
    best = min(("h100", "ada"), key=lambda n: runs[n][1]["fleet_j_per_token"])
    ratio = (runs["fleet"][1]["fleet_j_per_token"]
             / runs[best][1]["fleet_j_per_token"])
    _say(f"[fleet (a)] attainment {runs['fleet'][1]['attainment']:.3f} (the "
         f"reference's smoke gate >= {REF_ATTAIN_MIN}), fleet J/token over "
         f"the best single engine ({best}) {ratio:.4f} (gate <= "
         f"{REF_JTOK_RATIO_MAX}): the h100 model's numbers, not gated here")

    # (b) chaos, against the same three-member fleet without faults
    defer = {"policy": "defer", "defer_s": 0.01, "max_defers": 2}
    base, base_rep, _, by_path = _serve_fleet(
        "(b) no faults", fleet(CHAOS_CHIPS, defer), cfg, log)
    launched.update(by_path)
    _same_streams("fleet (b) no faults against (a)", base, ref, probe)
    H = base_rep["makespan_model_s"]
    plan = FaultPlan([
        FaultEvent(CHAOS_CORRUPT_AT * H, "artifact_corruption", "h100-b"),
        FaultEvent(CHAOS_STALL_AT * H, "stall", "ada",
                   factor=CHAOS_STALL_FACTOR,
                   duration_s=CHAOS_STALL_FOR * H),
        FaultEvent(CHAOS_CRASH_AT * H, "crash", "h100-b", state_lost=True),
    ], seed=0)
    sched = fleet(CHAOS_CHIPS, defer, fault_plan=plan,
                  straggler_cfg=StragglerConfig(patience=CHAOS_PATIENCE))
    got, rep, reqs, by_path = _serve_fleet("(b) chaos", sched, cfg, log)
    launched.update(by_path)
    faults, engines, rlog = rep["faults"], rep["engines"], sched.request_log
    migrated = sorted(u for u, d in rlog.items() if d["migrations"])
    replayed = {r.uid: list(r.replay or []) for r, _ in reqs
                if rlog[r.uid]["retries"]}
    _say(f"[fleet (b)] plan {[(e['kind'], e['member'], round(e['t_model_s'], 5), e['fired']) for e in faults['plan']['events']]}; "
         f"evictions {faults['evictions']}, crashes {faults['crashes']}, "
         f"migrations {faults['migrations']} (uids {migrated}), replays "
         f"{faults['replays']} (emitted before the crash: "
         f"{ {u: len(t) for u, t in replayed.items()} }), lost "
         f"{faults['lost_energy_j']:.3f} J, degraded "
         f"{faults['degraded_members']} "
         f"({engines['h100-b']['engine']['tuning_degraded_reason']!r})")
    fired = all(e["fired"] for e in faults["plan"]["events"])
    if not (fired and faults["degraded_members"] == ["h100-b"]
            and engines["ada"]["evictions"] >= 1 and migrated
            and engines["h100-b"]["crashed"] and faults["crashes"] == 1
            and any(replayed.values()) and faults["lost_energy_j"] > 0.0
            and not ops._TUNED):
        raise SystemExit("[fleet (b)] the fault plan did not play out: "
                         f"{faults}")
    for uid, prefix in replayed.items():
        if got[uid].tokens.tolist()[:len(prefix)] != prefix:
            raise SystemExit(f"[fleet (b)] request {uid}'s replay rewrote "
                             "tokens it had streamed")
    _same_streams("fleet (b) chaos against no faults", got, base, probe)

    # (c) page pressure: each paged member serves half the mix (its batch
    # prompts and 3 interactive ones under pressure, then the rest), its
    # pool just large enough for the first part at once
    split = {"h100-a": [], "h100-b": []}
    for (r, _), name in zip(_fleet_requests(cfg), [
            "h100-a", "h100-a", "h100-b", "h100-b"] + ["h100-a", "h100-b"]
            * (FLEET_SHORT // 2)):
        split[name].append(r)
    paged = {}
    for name, reqs in split.items():
        first = [r for r in reqs if r.uid < FLEET_LONG] + [
            r for r in reqs if r.uid >= FLEET_LONG][:3]
        rest = [r for r in reqs if r not in first]
        pages = sum(-(-(len(r.prompt) + r.max_new_tokens) // 64)
                    for r in first)
        eng = _fleet_engine(api, params, cfg, dev, "h100", kv_layout="paged",
                            page_size=64, num_pages=pages + 1)
        taken = eng.inject_page_pressure(pages // 2)
        by_path, res, run = _serve_requests(f"fleet (c) {name} squeezed",
                                            eng, cfg, log, first)
        launched.update(by_path)
        returned = eng.release_page_pressure()
        by_path, res2, run2 = _serve_requests(f"fleet (c) {name} released",
                                              eng, cfg, log, rest)
        launched.update(by_path)
        pg = eng.report()["paging"]
        _say(f"[fleet (c)] {name}: pool {pages} pages, {taken} squeezed for "
             f"{len(first)} requests ({run['chunk_steps']} chunk steps, "
             f"{run['decode_steps']} decode steps), {returned} returned; "
             f"then {len(rest)} requests; peak in use {pg['peak_in_use']}, "
             f"registry sheds {pg['registry_sheds']}, evictions "
             f"{pg['evictions']}; at the end {pg['pages_in_use']} in use, "
             f"{pg['registry_entries']} registry entries, squeezed "
             f"{pg['squeezed']}")
        if (taken != pages // 2 or returned != taken or pg["squeezed"]
                or pg["pages_in_use"] != pg["registry_entries"]):
            raise SystemExit(f"[fleet (c)] {name}: pages not returned: {pg}")
        paged.update({r.uid: r for r in res + res2})
    _same_streams("fleet (c) paged under pressure against (a)", paged, ref,
                  probe)
    entries = phase_serving_shapes(dev, log, tag="fleet shapes")
    _say(f"[fleet] launches per path {dict(launched)}; peak device memory "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 14 took "
         f"{time.perf_counter() - t_phase:.1f} s on {_nvidia_smi()}")
    return {"entries": entries, "launches": launched}


# phase 15: training. starcoder2-3b (3.18 B params, 50.9 GB of training
# state) at full width and depth through the port's launcher, TRAIN_STEPS
# steps of TRAIN_BATCH x TRAIN_SEQ tokens with remat; the gradient check and
# the resume check at full width cut to TRAIN_CUT layers (a 7.9 GB state
# whose checkpoint is written and read back)
TRAIN_ARCH = "starcoder2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
TRAIN_CUT = 2
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"


# the GEMM paths a launch counter keeps, and the split pair's split kernel
GEMM_PATHS = ("stream", "wgmma", "split", "general")


# phase 17: tensor-parallel serving in TP_RANKS rank processes on the one
# card (gloo: NCCL refuses two ranks on one device): full qwen2-7b after
# phase 14, the SSM, hybrid and MLA families after phase 12; the requests
# of the ten of `_requests` it serves (prompts of 16, 45, 64 and 77
# tokens: chunk calls on both paths), and each rank's time limit
TP_RANKS = 2
TP_UIDS = (0, 2, 4, 7)
TP_TIMEOUT_S = 600


def _tp_gemms_per_forward(cfg, tp: int, chunks: int) -> int:
    """One rank's GEMM launches in one forward at `tp`, from the model's
    structure: every column-parallel projection once (this rank's
    columns), every row-parallel one (attention's wo, the FFN's down,
    out_proj) once per column chunk (`tp._n_chunks` of the rank's d_model
    / tp columns), and the head (its vocab shard). Per layer: dense q, k,
    v, gate (gated FFN only) and up, wo and down; mamba1 in_proj, x_proj
    (whole), dt_proj and out_proj; mamba2 in_proj and out_proj, and the
    hybrid's shared block a dense layer per application; mla_moe w_dq (with
    a q LoRA), w_uq, w_dkv, w_kpe, w_uk, w_uv, wo, the router and the
    shared experts' gate, up and down."""
    from repro_torch.distributed.tp import _n_chunks

    c = _n_chunks(cfg.d_model // tp, chunks) if cfg.d_model % tp == 0 else 1
    dense = 3 + (2 if cfg.gated_mlp else 1) + 2 * c
    if cfg.kind == "mamba1":
        per_layer = 3 + c
    elif cfg.kind in ("mamba2", "hybrid"):
        per_layer = 1 + c
    elif cfg.kind == "mla_moe":
        per_layer = ((2 if cfg.q_lora_rank else 1) + 4 + c + 1
                     + (2 + c if cfg.n_shared_experts else 0))
    else:
        per_layer = dense
    shared = (cfg.n_layers // cfg.attn_every * dense
              if cfg.kind == "hybrid" else 0)
    return cfg.n_layers * per_layer + shared + 1


def _tp_collectives_per_forward(cfg, tp: int, chunks: int) -> int:
    """One rank's collectives in one forward at `tp`: the vocab-sharded
    embedding's gather and the head's logits gather; each row-parallel
    projection's input gather and one gather per column chunk; Mamba1's
    x_conv gather before x_proj (its out_proj gathers its input as well);
    Mamba2's gated-norm input gather (its out_proj then needs none); the
    MoE experts' output gather (experts sharded on E)."""
    from repro_torch.distributed.tp import _n_chunks

    c = _n_chunks(cfg.d_model // tp, chunks)
    dense = 2 * (1 + c)
    if cfg.kind == "mamba1":
        per_layer = 2 + c
    elif cfg.kind in ("mamba2", "hybrid"):
        per_layer = 1 + c
    elif cfg.kind == "mla_moe":
        per_layer = ((1 + c) + (cfg.n_experts % tp == 0)
                     + (1 + c if cfg.n_shared_experts else 0))
    else:
        per_layer = dense
    shared = (cfg.n_layers // cfg.attn_every * dense
              if cfg.kind == "hybrid" else 0)
    return 1 + cfg.n_layers * per_layer + shared + 1


# phase 17's probe forwards on each rank after its run (`_tp_probe`): a
# decode step over the engine's slots and one W x C chunk call
TP_PROBE_W, TP_PROBE_C = 4, 64
# {arch: each rank's posted collectives in the probe forwards}
_TP_PROBES: dict = {}


def _by_op() -> dict:
    """A copy of the collectives this process posted, by op."""
    from repro_torch.distributed import tp as TP

    return {op: dict(t) for op, t in TP.collectives.by_op.items()}


def _tp_probe(dev, eng, params) -> dict:
    """{"decode", "chunk"}: the collectives (calls and operand bytes by
    op) one rank posts in `_forward_fns`' decode step over the engine's
    slots and its `TP_PROBE_W` x `TP_PROBE_C` chunk call, each counted
    alone; the engine's mesh installed, its gather-mode config."""
    from repro_torch.distributed import tp as TP

    eng._activate()
    fns = _forward_fns(dev, eng, params, eng.cfg, TP_PROBE_W, TP_PROBE_C,
                       np.random.default_rng(17))
    out = {}
    for name, fn in zip(("decode", "chunk"), fns):
        torch.cuda.synchronize()
        TP.reset_collectives()
        fn()
        torch.cuda.synchronize()
        out[name] = _by_op()
    return out


def _tp_rank(mesh, arch: str, layers: int | None, uids: tuple, chunks: int,
             in_turn: bool = False, probe: bool = False) -> dict:
    """One rank of phase 17, in its own process: the seeded weights of
    `arch` (cut to `layers` layers) on the card that phase 4, 11 or 12
    serves, this rank's shard cut (the rest freed), then the requests
    `uids` of `_requests` through a tp engine at those phases' settings,
    the launch and collective counters set to 0 just before the run and
    read just after. With `in_turn` the ranks build and cut one after the
    other (a barrier between), so that one whole model and the other
    rank's shard share the card. With `probe`, `_tp_probe`'s forwards
    after the run. Returns the streams and the counts, memory and
    times."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = get_model(cfg)
    for turn in range(mesh.tp if in_turn else 1):
        if not in_turn or turn == mesh.rank:
            params = api.init(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev)
            whole = sum(p.numel() * p.element_size()
                        for p in params.parameters())
            eng = ServingEngine(api, params, cfg, max_batch=4, max_len=512,
                                chunk_tokens=64, device=dev, tp=mesh.tp,
                                mesh=mesh, tp_overlap_chunks=chunks)
            _free()
        if in_turn:
            dist.barrier(group=mesh.group)
    held = sum(p.numel() * p.element_size() for p in params.parameters())
    t_ready = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reqs = [_requests(cfg)[u] for u in uids]
    for r in reqs:
        eng.submit(r)
    tiled_matmul.launches = 0
    tiled_matmul.launches_by_path.update(
        dict.fromkeys(tiled_matmul.launches_by_path, 0))
    TP.collectives.calls, TP.collectives.host_s = 0, 0.0
    t1 = time.perf_counter()
    results = eng.run_until_empty()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    rep = eng.report()
    out = {"streams": {r.uid: r.tokens.tolist() for r in results},
           "budgets": {r.uid: eng._budget(r) for r in reqs},
           "launches": tiled_matmul.launches,
           "by_path": dict(tiled_matmul.launches_by_path),
           "collectives": TP.collectives.calls,
           "collective_host_s": TP.collectives.host_s,
           "forwards": rep["chunk_steps"] + rep["decode_steps"],
           "tokens": rep["generated_tokens"],
           "whole_bytes": whole, "held_bytes": held,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "ready_s": t_ready, "serve_s": serve_s,
           "collective_wire_s": rep["collective_wire_s"],
           "model_s": rep["model_s"]}
    if probe:
        out["probe"] = _tp_probe(dev, eng, params)
    del eng, params, results
    _free()
    return out


def _tp_model(pool, arch: str, want: dict, layers: int | None = None,
              in_turn: bool = False, probe: bool = False
              ) -> collections.Counter:
    """Serve `TP_UIDS` of `arch` (cut to `layers`) at tp = `TP_RANKS` on
    `pool`'s ranks with `TP_CHUNKS` row-parallel chunks and check it.
    Gates: every stream on every rank equals the card's tp=1 stream
    `want[uid]`, token for token, and runs to its budget; each rank's
    launches equal `_tp_gemms_per_forward` x its forwards, none on
    general, and its collectives `_tp_collectives_per_forward` x its
    forwards. Returns the launches per path summed over the ranks."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ranks = pool.run(_tp_rank, arch, layers, TP_UIDS, TP_CHUNKS, in_turn,
                     probe)
    if probe:
        _TP_PROBES[arch] = [out["probe"] for out in ranks]
    per_fwd = _tp_gemms_per_forward(cfg, TP_RANKS, TP_CHUNKS)
    coll_fwd = _tp_collectives_per_forward(cfg, TP_RANKS, TP_CHUNKS)
    launched = collections.Counter()
    failed = []
    for r, out in enumerate(ranks):
        launched.update(out["by_path"])
        same = all(out["streams"].get(u) == list(want[u]) for u in TP_UIDS)
        full = all(len(out["streams"].get(u, ())) == out["budgets"][u]
                   for u in TP_UIDS)
        fw, coll = out["forwards"], out["collectives"]
        _say(f"[tp rank {r}] {cfg.name} ({cfg.n_layers} layers): "
             f"{len(out['streams'])} requests, "
             f"{out['tokens']} tokens in {fw} forwards, serve "
             f"{out['serve_s']:.3f} s ({out['tokens'] / out['serve_s']:.2f} "
             f"tokens/s), ready in {out['ready_s']:.1f} s; streams equal "
             f"tp=1's {same}; launches {out['launches']} = {per_fwd} x "
             f"{fw}? {out['launches'] == per_fwd * fw} (by path "
             f"{out['by_path']}); collectives {out['collectives']} = "
             f"{coll_fwd} x {fw}? {out['collectives'] == coll_fwd * fw}, "
             f"host time {out['collective_host_s']:.3f} s "
             f"({1e3 * out['collective_host_s'] / max(fw, 1):.2f} ms a "
             f"forward, {1e3 * out['collective_host_s'] / max(coll, 1):.3f}"
             f" ms a collective); weights held {out['held_bytes'] / 1e9:.2f} "
             f"GB of {out['whole_bytes'] / 1e9:.2f} GB, peak device memory "
             f"serving {out['peak_bytes'] / 1e9:.2f} GB; model clock "
             f"{out['model_s']:.3f} s, wire {out['collective_wire_s']:.6f} s")
        if not (same and full):
            failed.append(f"rank {r} streams differ from tp=1's: "
                          f"{out['streams']} against "
                          f"{ {u: want[u] for u in TP_UIDS} }")
        if (out["launches"] != per_fwd * fw or out["by_path"]["general"]
                or out["collectives"] != coll_fwd * fw):
            failed.append(f"rank {r} launched {out['by_path']} and "
                          f"{out['collectives']} collectives in {fw} "
                          "forwards")
    streams = [out["streams"] for out in ranks]
    if any(s != streams[0] for s in streams):
        failed.append("the ranks' streams differ")
    _say(f"[tp] {cfg.name} at tp={TP_RANKS} ({TP_CHUNKS} chunks) in "
         f"{TP_RANKS} processes on one card (gloo): requests {TP_UIDS} "
         f"identical to tp=1's on every rank {not failed}; "
         f"{time.perf_counter() - t0:.1f} s")
    if failed:
        raise SystemExit(f"[tp] {cfg.name}: " + "; ".join(failed))
    return launched


def _tp_pool(fn):
    """Run `fn(pool)` on a `RankPool` of `TP_RANKS` gloo ranks, closed
    after; a rank process that exits with another code than 0 fails the
    phase."""
    from repro_torch.launch.mesh import RankPool

    pool = RankPool(TP_RANKS, backend="gloo", timeout_s=TP_TIMEOUT_S)
    try:
        out = fn(pool)
    finally:
        codes = pool.close()
    if any(codes):
        raise SystemExit(f"[tp] rank processes exited with {codes}")
    return out


def phase_tp(want: dict) -> dict:
    """Phase 17, first part: full-width, full-depth qwen2-7b served
    tensor-parallel at tp = `TP_RANKS` in as many processes on the one
    card, a gloo group between them (`launch.mesh.RankPool`). Each rank
    makes phase 4's seeded weights, cuts its shard and serves `TP_UIDS` at
    phase 4's engine settings (`_tp_model`'s gates against phase 4's
    streams `want`). A rank that fails, outlives `TP_TIMEOUT_S` or exits
    with another code than 0 fails the phase. Returns the launches per
    path summed over the ranks."""
    t0 = time.perf_counter()
    launched = _tp_pool(lambda pool: _tp_model(pool, "qwen2-7b", want,
                                               probe=True))
    _say(f"[tp] phase 17 (qwen2-7b) took {time.perf_counter() - t0:.1f} s")
    return {"launches": launched}


def phase_tp_families(wants: dict) -> dict:
    """Phase 17, second part, after phases 11 and 12: the SSM, hybrid and
    MLA families at tp = `TP_RANKS` on one pool of rank processes,
    falcon-mamba-7b and zamba2-2.7b at full width, `SSM_LAYERS` deep (both
    ranks building at once), deepseek-v2-236b at full width cut to
    `DEEPSEEK_LAYERS` layers (the ranks building in turn), each against
    the card's tp=1 streams of phases 12 and 11, `wants[name]`, with
    `_tp_model`'s gates. Returns the launches per path summed over the
    models and ranks."""
    t0 = time.perf_counter()
    runs = (("falcon-mamba-7b", SSM_LAYERS["falcon-mamba-7b"], False),
            ("zamba2-2.7b", SSM_LAYERS["zamba2-2.7b"], False),
            ("deepseek-v2-236b", DEEPSEEK_LAYERS, True))
    launched = _tp_pool(lambda pool: sum(
        (_tp_model(pool, arch, wants[arch], layers, in_turn)
         for arch, layers, in_turn in runs), collections.Counter()))
    _say(f"[tp] phase 17 (falcon-mamba-7b, zamba2-2.7b at {SSM_LAYERS} "
         f"layers, deepseek-v2-236b at {DEEPSEEK_LAYERS}) took {time.perf_counter() - t0:.1f} s "
         f"on {_nvidia_smi()}")
    return {"launches": launched}


def phase_tp_mesh() -> None:
    """Phase 17's mesh check, after `_analyse_ahead`'s thread is joined:
    each rank's collectives in `_tp_probe`'s decode step and chunk call
    (calls and operand bytes by op) equal the dry count of the same
    forwards on a dry (1, `TP_RANKS`) mesh (`_dry_tp_forward`)."""
    failed = []
    for r, probe in enumerate(_TP_PROBES.get("qwen2-7b", [])):
        for name in ("decode", "chunk"):
            dry = _DRY_AHEAD.get("mesh tp forward")
            want = None if dry is None else dry[0][name]
            same = want == probe[name]
            _say(f"[mesh] qwen2-7b tp={TP_RANKS} rank {r} {name} forward: "
                 f"posted {probe[name]}, dry count {want}: equal {same}")
            if not same:
                failed.append(f"rank {r} {name}")
    if not _TP_PROBES.get("qwen2-7b") or failed:
        raise SystemExit(f"[mesh] phase 17's posted collectives differ from "
                         f"the dry count: {failed or 'no probe'}")


def _f32_outs(cfg) -> int:
    """The products of one forward with f32 out from bf16 operands, whose
    backward is the split pair: the LM head and, for the MoE kinds, each
    layer's router."""
    return 1 + (cfg.n_layers if cfg.n_experts else 0)


def _train_launches_per_step(cfg) -> dict:
    """One train step's launches per path, from the model's structure:
    the forward's GEMMs (`_gemms_per_forward`) on ``wgmma``, each block's
    again where remat recomputes it (not the head), two backward GEMMs per
    bf16-out forward GEMM on ``wgmma`` too (``da`` reads the weight as an
    (N, K) B, ``dW`` the activations as a transposed A), the f32-out
    products' pairs on ``split`` and one ``split3`` a pair (its cotangent
    split once), none on ``general`` or ``stream``: 721 ``wgmma``, 2
    ``split`` and 1 ``split3`` for starcoder2-3b."""
    fwd, f32 = _gemms_per_forward(cfg), _f32_outs(cfg)
    return {"stream": 0,
            "wgmma": fwd + (fwd - 1 if cfg.remat else 0) + 2 * (fwd - f32),
            "split": 2 * f32, "general": 0, "split3": f32}


def _launch_counts() -> dict:
    """The launch counters: per GEMM path, and the split kernel's."""
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul

    return {**tiled_matmul.launches_by_path, "split3": split3.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul

    tiled_matmul.launches = split3.launches = 0
    tiled_matmul.launches_by_path.update(
        dict.fromkeys(tiled_matmul.launches_by_path, 0))


# the dry-run's check of a step the card ran (phases 6, 15 and 16): its
# bound may exceed the measured time by this factor at most
DRY_BOUND_SLACK = 1.05


def _path_tally(fn, tally: dict):
    """A stand-in for `ops.tiled_matmul` that calls `fn` (the wrapper, or
    a recorder around it) and adds each launch to ``tally[path] =
    [launches, FLOPs]`` (2MNK), the path read off the launch counters."""
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    def tallied(a, b, c=None, **kw):
        before = dict(tiled_matmul.launches_by_path)
        out = fn(a, b, c, **kw)
        moved = [p for p, n in tiled_matmul.launches_by_path.items()
                 if n != before[p]]
        if moved:
            k = a.shape[0] if kw.get("transpose_a") else a.shape[1]
            t = tally.setdefault(moved[0], [0, 0.0])
            t[0] += 1
            t[1] += 2.0 * out.shape[0] * out.shape[1] * k
        return out

    return tallied


def _dry_check(tag: str, fn, args: tuple, card: dict, measured_s: float,
               model_flops: float, *, what: str, peak: int,
               estimate: int | None = None, ahead=None) -> None:
    """Count ``fn(*args)`` (a step the card just ran, rebuilt on meta
    tensors) with the dry-run's `analyze_step` and gate it against the
    card: (a) the hand-written kernels' launches and FLOPs per path equal
    `card` ({path: (launches, FLOPs)} of one step, as the card recorded
    them) exactly; (b) `roofline_from_cost`'s bound on the h100 spec is at
    most DRY_BOUND_SLACK x the measured time (a larger bound would mean
    the count holds work the card did not do). Prints the model-FLOPs
    utilisation at the bf16 peak, the ratio, the dominant term and the
    dry-run's peak-live bytes beside the card's peak (and the training
    estimate, `train_memory_bytes`). Launches nothing on the card. `ahead`
    is (the cost, its seconds) where `_analyse_ahead` made the analysis
    already."""
    from repro_torch.core.opanalyze import analyze_step
    from repro_torch.core.roofline import roofline_from_cost
    from repro_torch.kernels.tiled_matmul import PEAK_BF16_FLOPS

    t0 = time.perf_counter()
    cost, secs = ahead or (analyze_step(fn, *args), None)
    when = (f"analysed on meta in {time.perf_counter() - t0:.1f} s"
            if secs is None else
            f"analysed on meta ahead, in a process of its own, in {secs:.1f} s")
    dry = {p: (g.launches, g.flops) for p, g in cost.gemms.items()}
    rep = roofline_from_cost(tag, cost, model_flops=model_flops)
    ratio = rep.bound_s / measured_s
    mfu = model_flops / (measured_s * PEAK_BF16_FLOPS)
    gemm_bound = sum(g.bound_s for g in cost.gemms.values())
    _say(f"[dry-run {tag}] launches and FLOPs per path: dry-run "
         f"{sorted(dry.items())}, card {sorted(card.items())}; equal? "
         f"{dry == card} ({when})")
    _say(f"[dry-run {tag}] {cost.flops:.4e} dot FLOPs ({cost.gemm_flops:.4e} "
         f"on the kernel), {cost.hbm_bytes:.4e} bytes over {cost.n_ops} aten "
         f"ops: compute {1e3 * rep.compute_s:.3f} ms, memory "
         f"{1e3 * rep.memory_s:.3f} ms, bound {1e3 * rep.bound_s:.3f} ms "
         f"({rep.dominant}; the GEMMs' own bounds sum to "
         f"{1e3 * gemm_bound:.3f} ms) against {1e3 * measured_s:.3f} ms "
         f"measured ({what}): bound/measured {ratio:.4f} (gate <= "
         f"{DRY_BOUND_SLACK}); MFU {mfu:.4f} ({model_flops:.4e} model FLOPs "
         f"at 989 TFLOP/s)")
    _say(f"[dry-run {tag}] peak live {cost.peak_live_bytes / 1e9:.2f} GB "
         f"(arguments {cost.argument_bytes / 1e9:.2f} GB) beside the card's "
         f"peak {peak / 1e9:.2f} GB"
         + ("" if estimate is None else
            f" and `train_memory_bytes`' {estimate / 1e9:.2f} GB")
         + f"; {_nvidia_smi()}")
    if dry != card:
        raise SystemExit(f"the dry-run of {tag} counted other launches or "
                         "FLOPs than the card recorded")
    if ratio > DRY_BOUND_SLACK:
        raise SystemExit(f"the dry-run's bound of {tag} is "
                         f"{ratio:.3f} x the measured time")


def _train_recording(log: collections.Counter, splits: collections.Counter):
    """Stand-ins for `ops.tiled_matmul` and `ops.split3`. The first counts
    each product under (M, N, K, A's dtype, B's dtype, out dtype, layout)
    in `log`, an operand given as its bf16 terms (`Split3`) under the f32
    matrix it stands for; the layout is "nn" (a forward product), "nt" (B
    read transposed: ``da``; a tied head's forward) or "tn" (A read
    transposed: ``dW``; a tied head's table gradient). The second counts
    each split under the f32 matrix's (rows, cols) in `splits`."""
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul

    def recording(a, b, c=None, **kw):
        ta, tb = bool(kw.get("transpose_a")), bool(kw.get("transpose_b"))
        m = a.shape[1] if ta else a.shape[0]
        n, k = b.shape if tb else b.shape[::-1]
        log[(m, n, k, a.dtype, b.dtype, kw.get("out_dtype") or a.dtype,
             ("t" if ta else "n") + ("t" if tb else "n"))] += 1
        return tiled_matmul(a, b, c, **kw)

    def splitting(x):
        splits[tuple(x.shape)] += 1
        return split3(x)

    return recording, splitting


def _layout_call(dev, g, m, n, k, a_dt, b_dt, layout) -> tuple:
    """(a, b, keyword arguments) of one training GEMM in its storage
    layout: "nn" a (M, K) and b (K, N); "nt" b stored (N, K), read
    transposed; "tn" a stored (K, M), read transposed. Operands of O(1)
    outputs, on rows padded to a multiple of 8 elements as the port stores
    its weights (seamless-m4t-medium's head, N = 256206)."""
    def rows(r, c, dt, scale=1.0):     # rows padded as the port stores
        store = torch.randn((r, -(-c // 8) * 8), generator=g, device=dev)
        return (store * scale).to(dt)[:, :c]      # them (`_weight`)

    a = rows(k, m, a_dt) if layout == "tn" else rows(m, k, a_dt)
    b = (rows(n, k, b_dt, k ** -0.5) if layout == "nt"
         else rows(k, n, b_dt, k ** -0.5))
    return a, b, dict(transpose_a=layout == "tn", transpose_b=layout == "nt")


def _term_rel_l2(k: int) -> float:
    """The split pair's per-term limit at depth K (`K_SUM_ULPS`)."""
    return max(TOL[torch.float32], K_SUM_ULPS * k ** 0.5 * 2.0 ** -24)


def _term_errs(a, b, ka, kb, kw, k: int) -> list:
    """The split pair at one shape, one term at a time: for t = 0, 1, 2 the
    split operand's planes are zero but plane t, which holds term t scaled
    by 2^(8 t) (exact: a power of two), so that each plane is about hi's
    size; the kernel at f32 out is held to `matmul_ref` of that plane. Each
    plane's products are exact in fp32, so the two differ only in the order
    of K additions: a relative L2 distance of at most `_term_rel_l2(k)`,
    while a term the kernel drops or reads from the wrong plane misses by
    the whole result (distance about 1). Returns each term's (relative L2,
    ok)."""
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import Split3, tiled_matmul

    on_a = isinstance(ka, Split3)
    s = ka if on_a else kb
    r, c = s.shape
    kw32 = {**kw, "out_dtype": torch.float32}
    out = []
    for t in range(3):
        buf = torch.zeros((3, r, -(-c // 8) * 8), dtype=torch.bfloat16,
                          device=s.terms.device)
        buf[t, :, :c] = s.terms[t] * 2.0 ** (8 * t)
        one = Split3(buf[t, :, :c].float(), buf[:, :, :c])
        got = tiled_matmul(one, kb, **kw32) if on_a else tiled_matmul(
            ka, one, **kw32)
        want = (matmul_ref(one.x, b, **kw32) if on_a
                else matmul_ref(a, one.x, **kw32))
        rel = ((got - want).norm() / want.norm()).item()
        out.append((rel, rel <= _term_rel_l2(k)))
        del buf, one, got, want
    return out


def _check_train_shapes(dev, shapes, splits=(), tag: str = "train (b)"
                        ) -> tuple:
    """Hold the kernel against its plain version at every distinct training
    GEMM in `shapes` (keys (M, N, K, A's dtype, B's dtype, out dtype,
    layout), as `_train_recording` logs them): the product within the
    stated tolerance and, for a split pair (its f32 operand split first, as
    the backward splits it), each term apart at f32 out (`_term_errs`);
    and the split kernel at every f32 matrix shape in `splits` bit for bit
    against its plain version. A disagreement fails the phase. Returns
    ({key: (path, max abs error, relative L2, the terms' text)}, {split
    shape: bit-equal}, the worst error per path, per split term and of
    split3)."""
    from repro_torch.kernels.ref import matmul_ref, split3_ref
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul

    g = torch.Generator(dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    checks, split_checks, failed = {}, {}, []
    worst: collections.Counter = collections.Counter()
    for key in sorted(shapes, key=lambda key: (key[6], key[:3])):
        m, n, k, a_dt, b_dt, out_dt, layout = key
        a, b, kw = _layout_call(dev, g, m, n, k, a_dt, b_dt, layout)
        kw["out_dtype"] = out_dt
        mixed = a_dt != b_dt
        ka = split3(a) if mixed and a_dt == f32 else a
        kb = split3(b) if mixed and b_dt == f32 else b
        want = matmul_ref(a, b, **kw)
        path, got = _run_path(tiled_matmul, ka, kb, **kw)
        err, _, ok = _close(got, want, bf16 if bf16 in (a_dt, b_dt, out_dt)
                            else f32)
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        worst[path] = max(worst[path], err)
        if not ok:
            failed.append((m, n, k, layout, path))
        del got, want
        terms = ""
        if mixed:
            errs = _term_errs(a, b, ka, kb, kw, k)
            worst["split terms"] = max(worst["split terms"],
                                       *(e for e, _ in errs))
            failed += [(m, n, k, layout, f"split term {t}")
                       for t, (_, ok_t) in enumerate(errs) if not ok_t]
            terms = (" terms one at a time at f32 out, rel_l2 " + " ".join(
                f"{e:.3g}" for e, _ in errs)
                + f" (limit {_term_rel_l2(k):.3g})")
        checks[key] = (path, err, rel, terms)
        del a, b, ka, kb
    for r, c in sorted(splits):
        x = torch.randn((r, c), generator=g, device=dev)
        got, want = split3(x).terms, split3_ref(x)
        split_checks[(r, c)] = torch.equal(got, want)
        worst["split3"] = max(worst["split3"],
                              (got.float() - want.float()).abs().max().item())
        if not split_checks[(r, c)]:
            failed.append((r, c, "split3"))
        del x, got, want
    _say(f"[{tag}] {len(checks)} distinct GEMMs held to the plain version: "
         "worst abs error per path "
         + ", ".join(f"{p} {worst[p]:.3g}" for p in sorted(worst)
                     if p not in ("split terms", "split3"))
         + (f"; the split pairs one term at a time at f32 out: worst "
            f"relative L2 {worst['split terms']:.3g} (limit "
            f"max({TOL[f32]:g}, {K_SUM_ULPS} sqrt(K) 2^-24))"
            if "split terms" in worst else "")
         + (f"; split3 at {len(split_checks)} shapes bit-equal to the plain "
            f"version {all(split_checks.values())}" if split_checks else ""))
    if failed:
        raise SystemExit(f"[{tag}] kernel disagrees at training shapes "
                         f"{failed}")
    return checks, split_checks, worst


def _train_shapes(dev, shapes: collections.Counter, runs: int,
                  tag: str = "train (b)",
                  splits: collections.Counter | None = None) -> dict:
    """(b): `_check_train_shapes` at every distinct training GEMM of one
    step (forward, recompute, both backward layouts, the f32-out products'
    split pairs) and the split kernel's shapes (`splits`, by the f32
    matrix's shape), then time the kernel beside the general path (timed
    once: the first kernel, the yardstick), the plain version, torch.matmul
    on the same layout (for the split pair its f32 product, the bf16
    operand cast beforehand) and the bound; a split pair's GEMM is timed on
    its f32 operand split beforehand, as the backward splits it once for
    both gradients, and the split kernel apart. Sums per path per step, the
    bf16 backward's and the split pairs' ratios to torch.matmul, and
    per-kernel JSON entries over the `runs` steps of (a)."""
    from repro_torch.core.opanalyze import gemm_bound_s
    from repro_torch.core.profiler import time_ms
    from repro_torch.kernels.ref import matmul_ref, split3_ref
    from repro_torch.kernels.tiled_matmul import (DEFAULT_CONFIG,
                                                  HBM_BYTES_PER_S, split3,
                                                  tiled_matmul)

    splits = splits or collections.Counter()
    checks, split_checks, worst = _check_train_shapes(dev, shapes, splits,
                                                      tag)
    g = torch.Generator(dev).manual_seed(4)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    tot: dict = collections.defaultdict(collections.Counter)
    f32 = torch.float32
    _say(f"[{tag}] M N K a b out layout per-step path kernel_ms v3_ms "
         "plain_ms library_ms bound_ms bound_by bound/kernel "
         "library/kernel max_abs rel_l2")
    for key, count in sorted(shapes.items(), key=lambda kv: (
            kv[0][6], kv[0][:3])):
        m, n, k, a_dt, b_dt, out_dt, layout = key
        path, err, rel, terms = checks[key]
        per_step = count // runs
        a, b, kw = _layout_call(dev, g, m, n, k, a_dt, b_dt, layout)
        kw["out_dtype"] = out_dt
        mixed = a_dt != b_dt
        ka = split3(a) if mixed and a_dt == f32 else a
        kb = split3(b) if mixed and b_dt == f32 else b
        kernel_ms = time_ms(lambda: tiled_matmul(ka, kb, **kw), flush, 5)
        del ka, kb
        ga, gb = (a.float(), b.float()) if mixed else (a, b)
        v3_ms = time_ms(lambda: tiled_matmul(ga, gb, config=DEFAULT_CONFIG,
                                             **kw), flush, 1)
        plain_ms = time_ms(lambda: matmul_ref(a, b, **kw), flush, 3)
        ta, tb = kw["transpose_a"], kw["transpose_b"]
        library_ms = time_ms(lambda: torch.matmul(ga.T if ta else ga,
                                                  gb.T if tb else gb),
                             flush, 5)
        ops_s, bytes_s = gemm_bound_s(m, n, k, a_dtype=a_dt, b_dtype=b_dt,
                                      out_dtype=out_dt)
        bound_ms = 1e3 * max(ops_s, bytes_s)
        _say(f"[{tag}] {m} {n} {k} {str(a_dt)[6:]} {str(b_dt)[6:]} "
             f"{str(out_dt)[6:]} {layout} {per_step} {path} "
             f"{kernel_ms:.4f} {v3_ms:.4f} {plain_ms:.4f} {library_ms:.4f} "
             f"{bound_ms:.4f} {'operations' if ops_s > bytes_s else 'bytes'}"
             f" {bound_ms / kernel_ms:.3f} {library_ms / kernel_ms:.3f} "
             f"{err:.3g} {rel:.3g}{terms}")
        del a, b, ga, gb
        kind = ("split pair" if mixed else "bf16 forward" if layout == "nn"
                else "bf16 backward")
        # wgmma's launches on the transposed layouts, apart (a tied head's
        # forward reads an (N, K) B too)
        rows = [tot[path], tot["all"], tot[kind]]
        if path == "wgmma" and layout != "nn":
            rows.append(tot["wgmma transposed"])
            tot["wgmma transposed"]["launches"] += count
        for t in rows:
            t["ms"] += per_step * kernel_ms
            t["v3_ms"] += per_step * v3_ms
            t["plain_ms"] += per_step * plain_ms
            t["library_ms"] += per_step * library_ms
            t["bound_ms"] += per_step * bound_ms
            t["ops_ms"] += per_step * 1e3 * ops_s
            t["bytes_ms"] += per_step * 1e3 * bytes_s
    for (r, c), count in sorted(splits.items()):
        per_step = count // runs
        x = torch.randn((r, c), generator=g, device=dev)
        kernel_ms = time_ms(lambda: split3(x), flush, 5)
        plain_ms = time_ms(lambda: split3_ref(x), flush, 3)
        bytes_s = r * c * (4 + 3 * 2) / HBM_BYTES_PER_S   # read x, write 3
        _say(f"[{tag}] split3 {r} {c} per-step {per_step}: kernel "
             f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
             f"{1e3 * bytes_s:.4f} ms (bytes), bound/kernel "
             f"{1e3 * bytes_s / kernel_ms:.3f}, bit-equal to the plain "
             f"version {split_checks[(r, c)]}")
        del x
        for t in (tot["split3"],):
            t["ms"] += per_step * kernel_ms
            t["plain_ms"] += per_step * plain_ms
            t["bound_ms"] += per_step * 1e3 * bytes_s
            t["bytes_ms"] += per_step * 1e3 * bytes_s
    for kind in ("bf16 backward", "split pair"):
        t = tot.get(kind)
        if t:
            extra = (f" (+ split3 {tot['split3']['ms']:.2f} ms)"
                     if kind == "split pair" and "split3" in tot else "")
            _say(f"[{tag}] one step's {kind}: kernel {t['ms']:.2f} ms{extra}, "
                 f"torch.matmul {t['library_ms']:.2f} ms "
                 f"({'f32 x f32, ' if kind == 'split pair' else ''}"
                 f"{t['ms'] / t['library_ms']:.2f}x), general path "
                 f"{t['v3_ms']:.2f} ms, bound {t['bound_ms']:.2f} ms")
    entries = {}
    for path, t in sorted(tot.items()):
        if path in ("bf16 forward", "bf16 backward", "split pair"):
            continue
        if path not in ("split3", "wgmma transposed"):
            _say(f"[{tag}] one step's GEMMs ({path}): kernel {t['ms']:.2f} "
                 f"ms, general path {t['v3_ms']:.2f} ms, plain "
                 f"{t['plain_ms']:.2f} ms, torch.matmul "
                 f"{t['library_ms']:.2f} ms, bound {t['bound_ms']:.2f} ms "
                 f"(operations {t['ops_ms']:.2f} ms, bytes "
                 f"{t['bytes_ms']:.2f} ms)")
        if path == "all":
            continue
        entries[path] = {
            **{key: runs * t[key] for key in (
                "ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms")},
            # the split kernel has no general-path counterpart and no one
            # PyTorch call that computes it
            "v3_ms": None if path == "split3" else runs * t["v3_ms"],
            "library_ms": (None if path == "split3"
                           else runs * t["library_ms"]),
            "bound_by": ("operations" if t["ops_ms"] > t["bytes_ms"]
                         else "bytes"),
            "max_abs_err": worst[path if path in worst else "wgmma"]}
        if path == "wgmma transposed":
            entries[path]["launches"] = t["launches"]
    return entries


def _train_full(dev) -> tuple:
    """(a): the launcher trains full-width, full-depth starcoder2-3b; the
    counters are set to 0 just before and read just after. Returns (the
    launches by shape and layout, by path, the loop's summary)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul
    from repro_torch.launch import train as launch
    from repro_torch.models.registry import get_model

    cfg = get_config(TRAIN_ARCH)
    want = _train_launches_per_step(cfg)
    state_b, acts_b = launch.train_memory_bytes(cfg, TRAIN_BATCH, TRAIN_SEQ)
    cap = torch.cuda.get_device_properties(dev).total_memory
    _say(f"[train (a)] {cfg.name}: {cfg.n_layers} layers, d_model "
         f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.kv_heads}, d_ff "
         f"{cfg.d_ff} (GELU FFN), vocab {cfg.vocab}, remat {cfg.remat}; "
         f"{cfg.n_params() / 1e9:.3f} B params, training state "
         f"{state_b / 1e9:.2f} GB, activations about {acts_b / 1e9:.2f} GB "
         f"(`train_memory_bytes`) on a card of {cap / 1e9:.2f} GB; "
         f"launches per step from the structure: {want}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    shapes: collections.Counter = collections.Counter()
    splits: collections.Counter = collections.Counter()
    marks = []

    def on_log(line: str) -> None:
        _say(f"[train (a)] {line}")
        if line.startswith("step "):
            marks.append(_launch_counts())

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tally: dict = {}
    recording, splitting = _train_recording(shapes, splits)
    ops.tiled_matmul, ops.split3 = _path_tally(recording, tally), splitting
    try:
        _zero_counts()
        marks.append(_launch_counts())
        state, summary = launch.main(
            ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
             "--ckpt-every", str(10 * TRAIN_STEPS), "--ckpt-dir",
             str(TRAIN_DIR / "full")], log_fn=on_log)
        torch.cuda.synchronize()
        launches = tiled_matmul.launches
        by_path = _launch_counts()
    finally:
        ops.tiled_matmul, ops.split3 = tiled_matmul, split3
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    steps = [{p: b[p] - a[p] for p in a} for a, b in zip(marks, marks[1:])]
    times = summary["step_times_s"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    _say(f"[train (a)] {summary['final_step']} steps in {wall:.1f} s "
         f"(init and data included); step ms "
         + ", ".join(f"{1e3 * t:.1f}" for t in times)
         + f"; after the first: mean {1e3 * float(np.mean(times[1:])):.1f} "
         f"ms, {tokens / float(np.mean(times[1:])):.1f} training tokens/s; "
         f"peak device memory {peak / 1e9:.2f} GB")
    _say(f"[train (a)] launches per step by path: {steps} (expected "
         f"{want} each); {launches} in all")
    # the params moved: every master leaf (f32) and every weight matrix
    # differs from the launcher's seeded init (a bf16 norm scale of 1.0 may
    # not move by a bf16 step in 4 warmup steps)
    init = get_model(cfg).init(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    moved = {"master": 0, "matrices": 0}
    n_mat = 0
    trained = dict(state["params"].named_parameters())
    for name, p0 in init.named_parameters():
        p = trained[name]
        moved["master"] += not torch.equal(state["opt"]["master"][name],
                                           p0.float())
        if p.dim() == 2:
            n_mat += 1
            moved["matrices"] += not torch.equal(p, p0)
    n_leaves = sum(1 for _ in init.parameters())
    del init
    _say(f"[train (a)] params moved from the init: master {moved['master']} "
         f"of {n_leaves} leaves, weight matrices {moved['matrices']} of "
         f"{n_mat}; optimizer step {int(state['opt']['step'])}")
    finite = bool(np.isfinite(summary["loss_curve"]).all()
                  and np.isfinite(summary["grad_norms"]).all())
    if (summary["final_step"] != TRAIN_STEPS or not finite
            or len(steps) != TRAIN_STEPS or any(s != want for s in steps)
            or launches != TRAIN_STEPS * sum(want[p] for p in GEMM_PATHS)
            or moved["master"] != n_leaves or moved["matrices"] != n_mat):
        raise SystemExit("full-width training failed its gates (steps, "
                         "finite losses and grad norms, launches per step "
                         "and path, params moved)")
    del state
    return shapes, splits, by_path, summary, peak, _per_step(tally, steps)


def _per_step(tally: dict, steps: list) -> dict:
    """One step's {path: (launches, FLOPs)} from a run's `_path_tally` over
    its steps, and the split kernel's launches (every step launches the
    same: the runs gate it)."""
    n = len(steps)
    out = {p: (c // n, f / n) for p, (c, f) in tally.items()}
    if steps[0]["split3"]:
        out["split3"] = (steps[0]["split3"], 0.0)
    return out


def _train_cell(cfg, batch: dict) -> tuple:
    """(fn, args) of `make_train_step` with AdamW on `cfg` over meta
    tensors of the batch's shapes and dtypes (`batch`: {name: (shape,
    dtype)})."""
    from repro_torch.configs.common import Spec
    from repro_torch.launch import dryrun

    fn, args, _ = dryrun.build_cell(
        cfg.name, "train_4k", cfg=cfg,
        specs={k: Spec(*v) for k, v in batch.items()})
    return fn, args


def _train_dry_check(tag: str, cfg, batch: dict, card: dict,
                     measured_s: float, peak: int, rows: int,
                     seq: int) -> None:
    """The dry-run of a train step the card ran (`_train_cell` on `cfg`,
    its depth as the card ran it, and `batch`), analysed here or taken
    from `_analyse_ahead`'s work for `tag`."""
    from repro_torch.launch.train import train_memory_bytes

    fn, args = _train_cell(cfg, batch)
    _dry_check(tag, fn, args, card, measured_s,
               6.0 * cfg.n_active_params() * rows * seq,
               what="the step's time after the first", peak=peak,
               estimate=sum(train_memory_bytes(cfg, rows, seq)),
               ahead=_DRY_AHEAD.pop(tag, None))


# phases 15 (e)'s and 16 (d)'s meta analyses by tag, made ahead while
# phase 17's rank processes serve (the main process only waits on them
# then): (the `StepCost`, the seconds it took)
_DRY_AHEAD: dict = {}


def _train_checks(cap: int) -> list:
    """(tag, cfg, batch) of phases 15 (e)'s and 16 (d)'s dry-run checks:
    the configs at the depth those phases train (`_fit_depth` on the
    card's memory `cap`) and their batches' shapes."""
    from repro_torch.configs import get_config

    tokens = (TRAIN_BATCH, TRAIN_SEQ)
    out = [(f"train (e) {TRAIN_ARCH}", get_config(TRAIN_ARCH),
            {"tokens": (tokens, torch.int32),
             "labels": (tokens, torch.int32)})]
    for arch, rows, seq in FAMILY_TRAIN:
        cfg = _fit_depth(get_config(arch), rows, seq, cap)
        out.append((f"family (d) {arch}", cfg,
                    _family_specs(cfg, rows, seq)))
    return out


def _cost_by_op(cost) -> dict:
    """A `StepCost`'s dry collectives as {op: {"calls", "bytes"}}."""
    return {op: {"calls": n, "bytes": int(cost.collective_operand_bytes[op])}
            for op, n in cost.collective_calls.items()}


def _dry_tp_forward() -> dict:
    """The mesh dry count of `_tp_probe`'s forwards: qwen2-7b at full
    width on a dry (1, `TP_RANKS`) mesh in the engine's gather mode
    (`TP_CHUNKS` chunks), its shard cut on meta, the decode step over 4
    slots of 512 and the `TP_PROBE_W` x `TP_PROBE_C` chunk call."""
    from repro_torch.configs import get_config
    from repro_torch.configs.common import INDEX_DTYPE
    from repro_torch.core.opanalyze import analyze_step
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models.registry import get_model

    cfg = get_config("qwen2-7b")
    api = get_model(cfg)
    mesh = make_dry_mesh((1, TP_RANKS))
    params = api.init(cfg, None, device="meta")
    sharding.shard_params(params, mesh, whole=api.init(cfg, None,
                                                       device="meta"),
                          cfg=cfg)
    gcfg = dataclasses.replace(cfg, tp_collectives="explicit",
                               tp_reduce="gather",
                               tp_overlap_chunks=TP_CHUNKS)
    W, C = TP_PROBE_W, TP_PROBE_C
    sharding.set_mesh(mesh)
    try:
        dstate = api.init_state(cfg, 4, 512, device="meta")
        cstate = api.init_state(cfg, W, 512, device="meta")
        tok = torch.empty(4, dtype=INDEX_DTYPE, device="meta")
        toks = torch.empty((W, C), dtype=INDEX_DTYPE, device="meta")
        lens = torch.empty(W, dtype=INDEX_DTYPE, device="meta")
        return {"decode": _cost_by_op(analyze_step(
                    api.decode_step, params, tok, dstate, gcfg)),
                "chunk": _cost_by_op(analyze_step(
                    api.prefill_chunk, params, toks, lens, cstate, gcfg))}
    finally:
        sharding.set_mesh(None)


def _dry_train(arch: str, cfg, shape: tuple, rows: int, seq: int) -> dict:
    """The mesh dry count of one train step of `cfg` on a dry (data,
    model) = `shape` mesh (the dry-run's rank: psum mode, ZeRO-1) over a
    global batch of `rows` x `seq` tokens."""
    from repro_torch.configs.common import Spec
    from repro_torch.core.opanalyze import analyze_step
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dry_mesh

    tokens = Spec((rows, seq), torch.int32)
    fn, args, _ = dryrun.build_cell(
        arch, "train_4k", make_dry_mesh(shape), cfg=cfg,
        specs={"tokens": tokens, "labels": tokens})
    return _cost_by_op(analyze_step(fn, *args))


def _mesh_checks() -> list:
    """(tag, fn) of the mesh dry counts the card's ranks are held to:
    phase 17's probe forwards, one step of phase 18 (a), (d), (e) and
    (f)."""
    from repro_torch.configs import get_config

    return [("mesh tp forward", _dry_tp_forward),
            ("mesh train tp (a)", lambda: _dry_train(
                TRAIN_ARCH, get_config(TRAIN_ARCH), (1, TP_RANKS),
                TRAIN_BATCH, TRAIN_SEQ)),
            ("mesh fsdp (d)", lambda: _dry_train(
                FSDP_ARCH, _fsdp_cfg(), (TP_RANKS, 1), FSDP_ROWS,
                FSDP_SEQ)),
            ("mesh train sp (e)", lambda: _dry_train(
                TRAIN_ARCH, dataclasses.replace(get_config(TRAIN_ARCH),
                                                sequence_parallel=True),
                (1, TP_RANKS), TRAIN_BATCH, TRAIN_SEQ)),
            ("mesh ep (f)", lambda: _dry_train(
                EP_ARCH, _ep_cfg(), (TP_RANKS, 1), EP_ROWS, EP_SEQ))]


def _mesh_gate(tag: str, posted: dict) -> bool:
    """Print the mesh dry count `tag` (from `_DRY_AHEAD`) beside what a
    rank posted; whether they are equal, op for op."""
    dry = _DRY_AHEAD.get(tag)
    want = None if dry is None else dry[0]
    same = want == posted
    _say(f"[mesh] {tag}: dry count {want} (made in "
         f"{dry[1] if dry else float('nan'):.1f} s); posted {posted}"
         f": equal {same}")
    return same


def _ahead_work(cap: int) -> dict:
    """`_analyse_ahead`'s analyses, in a process of its own (host work on
    meta tensors, no card): {tag: (the cost, its seconds), or tag + "
    failed": the error}. `cap` is the card's memory, which sets the
    families' depths (`_fit_depth`)."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.core.opanalyze import analyze_step

    out = {}
    for tag, fn in _mesh_checks():
        t0 = time.perf_counter()
        try:
            out[tag] = (fn(), time.perf_counter() - t0)
        except Exception as e:
            out[tag + " failed"] = repr(e)
    for tag, cfg, batch in _train_checks(cap):
        t0 = time.perf_counter()
        try:
            fn, args = _train_cell(cfg, batch)
            cost = analyze_step(fn, *args)
        except Exception as e:                        # made again later
            out[tag + " failed"] = repr(e)
            continue
        out[tag] = (cost, time.perf_counter() - t0)
    return out


class _Ahead:
    """`_ahead_work` running in a spawned process; `join` waits for it,
    puts its results into `_DRY_AHEAD` and stops the process."""

    def __init__(self, cap: int):
        import multiprocessing as mp

        self.pool = mp.get_context("spawn").Pool(1)
        self.result = self.pool.apply_async(_ahead_work, (cap,))

    def join(self) -> None:
        try:
            _DRY_AHEAD.update(self.result.get(timeout=AHEAD_TIMEOUT_S))
        except Exception as e:                        # made again later
            _DRY_AHEAD["ahead failed"] = repr(e)
        finally:
            self.pool.terminate()
            self.pool.join()


# how long `_Ahead.join` waits for the analyses
AHEAD_TIMEOUT_S = 600


def _analyse_ahead(dev) -> _Ahead:
    """Start the process that makes `_train_checks`' meta analyses and the
    mesh dry counts of `_mesh_checks` into `_DRY_AHEAD` (host work,
    nothing on the card: in a process of its own, so it takes no time
    from this one's host-bound phases); the caller joins it. A check
    whose analysis failed there analyses again in its phase (a mesh
    count is missing: its gate fails)."""
    return _Ahead(torch.cuda.get_device_properties(dev).total_memory)


def _cut_state(dev, cfg, seed: int = 0) -> dict:
    from repro_torch.models.registry import get_model
    from repro_torch.train.step import init_train_state

    return init_train_state(torch.Generator(dev).manual_seed(seed),
                            get_model(cfg), cfg, device=dev)


def _train_grads(dev, cfg, batch: dict | None = None,
                 tag: str = "train (c)") -> None:
    """(c): loss and every gradient leaf at full width cut to TRAIN_CUT
    layers, through the kernel against every product through
    `matmul_ref`; relative L2 at most LOGITS_REL_L2_MAX. `batch` defaults
    to one TRAIN_BATCH x TRAIN_SEQ batch of the synthetic pipeline."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul
    from repro_torch.models.registry import get_model

    state = _cut_state(dev, cfg)
    params = state["params"]
    if batch is None:
        batch = SyntheticLMDataset(DataConfig(
            seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, vocab=cfg.vocab)
        ).batch_at(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    api = get_model(cfg)

    def grads():
        loss, _ = api.loss(params, batch, cfg)
        gs = torch.autograd.grad(loss, list(params.parameters()))
        return loss.detach(), dict(zip(
            [n for n, _ in params.named_parameters()], gs))

    def plain(a, b, c=None, *, config=None, **kw):
        return matmul_ref(a, b, c, **kw)

    got = grads()
    # the plain version of the split pair multiplies the f32 cotangent
    # itself: nothing is split
    ops.tiled_matmul, ops.split3 = plain, lambda x: x
    try:
        want = grads()
    finally:
        ops.tiled_matmul, ops.split3 = tiled_matmul, split3

    def rel(x, y):
        return ((x.float() - y.float()).norm()
                / y.float().norm().clamp_min(1e-30)).item()

    rels = {n: rel(got[1][n], want[1][n]) for n in want[1]}
    worst = max(rels, key=rels.get)
    loss_rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    rows = tuple(batch["labels"].shape)
    _say(f"[{tag}] {cfg.n_layers} layers at full width, one "
         f"{rows[0]} x {rows[1]} batch: loss {got[0].item():.6f} "
         f"through the kernel, {want[0].item():.6f} through the plain "
         f"version (relative {loss_rel:.3e}); gradients of {len(rels)} "
         f"leaves, relative L2 max {rels[worst]:.3e} ({worst}), median "
         f"{statistics.median(rels.values()):.3e} (max "
         f"{LOGITS_REL_L2_MAX:g})")
    if (loss_rel > LOGITS_REL_L2_MAX or rels[worst] > LOGITS_REL_L2_MAX
            or not all(torch.isfinite(g).all() for g in got[1].values())):
        raise SystemExit("gradients through the kernel disagree with the "
                         "plain version")


def _train_resume(dev, cfg) -> None:
    """(d): at the TRAIN_CUT-layer cut, TRAIN_STEPS uninterrupted steps
    against half of them, a checkpoint, a restore into a fresh state (other
    seed) and the rest, through the port's loop: params, optimizer state,
    rng and losses bit for bit."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import (DataConfig, DataLoader,
                                           SyntheticLMDataset)
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import (LoopConfig, resume_or_init,
                                        run_train_loop)
    from repro_torch.train.step import make_train_step

    ds = SyntheticLMDataset(DataConfig(seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH,
                                       vocab=cfg.vocab))
    step = make_train_step(get_model(cfg), cfg, AdamWConfig(
        warmup_steps=1, decay_steps=TRAIN_STEPS))
    half = TRAIN_STEPS // 2

    def run(d, steps, seed=0, every=10 * TRAIN_STEPS):
        """(state, summary, start step, seconds to build or restore the
        state, seconds of the loop: its steps and the wait for the
        checkpoint's writer)."""
        ckpt = CheckpointManager(str(TRAIN_DIR / d))
        loader = DataLoader(ds)
        t0 = time.perf_counter()
        state, start = resume_or_init(
            ckpt=ckpt, loader=loader,
            init_fn=lambda: _cut_state(dev, cfg, seed))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, summary = run_train_loop(
            train_step=step, state=state, loader=loader, ckpt=ckpt,
            loop_cfg=LoopConfig(total_steps=start + steps, ckpt_every=every,
                                log_every=10 * TRAIN_STEPS),
            start_step=start, log_fn=_say, install_signal_handlers=False)
        return state, summary, start, t1 - t0, time.perf_counter() - t1

    whole, s_whole, *_ = run("whole", TRAIN_STEPS)
    first, s1, _, _, t_save = run("resumed", half, every=half)
    del first
    resumed, s2, start, t_rest, _ = run("resumed", TRAIN_STEPS - half,
                                        seed=1)
    ckpt_bytes = sum(f.stat().st_size
                     for f in (TRAIN_DIR / "resumed").rglob("*.npz"))
    same = {"params": all(torch.equal(p, q) for p, q in zip(
        whole["params"].parameters(), resumed["params"].parameters())),
        "opt": torch.equal(whole["opt"]["step"], resumed["opt"]["step"])
        and all(torch.equal(whole["opt"][k][n], resumed["opt"][k][n])
                for k in ("master", "m", "v") for n in whole["opt"][k]),
        "rng": torch.equal(whole["rng"], resumed["rng"]),
        "losses": (list(s1["loss_curve"]) + list(s2["loss_curve"])
                   == list(s_whole["loss_curve"]))}
    _say(f"[train (d)] {TRAIN_STEPS} steps against {half} + checkpoint "
         f"({ckpt_bytes / 1e9:.2f} GB at step {start}; the first {half} "
         f"steps and the save {t_save:.1f} s, a fresh state and the restore "
         f"into it {t_rest:.1f} s) + "
         f"{TRAIN_STEPS - half}: losses "
         + ", ".join(f"{x:.6f}" for x in s_whole["loss_curve"])
         + f"; bit for bit: {same}")
    del whole, resumed
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if not all(same.values()):
        raise SystemExit(f"a resumed run differs from an uninterrupted one: "
                         f"{same}")


def phase_train(dev) -> dict:
    """Phase 15, training on the card: (a) full-width, full-depth
    starcoder2-3b through the launcher; (b) its GEMMs against the plain
    version, timed; (c) gradients through the kernel against the plain
    version and (d) resume, at full width cut to TRAIN_CUT layers. Returns
    {"launches": per path, "entries": per-path JSON entries over (a)'s
    steps}."""
    from repro_torch.configs import get_config

    _free()
    t0 = time.perf_counter()
    shapes, splits, by_path, summary, peak, card = _train_full(dev)
    _free()
    tokens = (TRAIN_BATCH, TRAIN_SEQ)
    _train_dry_check(f"train (e) {TRAIN_ARCH}", get_config(TRAIN_ARCH),
                     {"tokens": (tokens, torch.int32),
                      "labels": (tokens, torch.int32)}, card,
                     float(np.mean(summary["step_times_s"][1:])), peak,
                     *tokens)
    entries = _train_shapes(dev, shapes, TRAIN_STEPS, splits=splits)
    _free()
    cut = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT)
    torch.cuda.reset_peak_memory_stats(dev)
    _train_grads(dev, cut)
    _free()
    _train_resume(dev, cut)
    _free()
    _say(f"[train] phase 15 in {time.perf_counter() - t0:.1f} s; peak "
         f"device memory of (a) {peak / 1e9:.2f} GB, of (c)-(d) "
         f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return {"launches": collections.Counter(by_path), "entries": entries,
            "summary": summary}


# Phase 16: the other families' training at full width, (arch, batch rows,
# tokens a row: vlm's count its N_PATCHES patches and as many text tokens),
# FAMILY_STEPS steps each (the first cold), remat on. A config whose
# training does not fit FIT_SHARE of the card at full depth is cut to the
# deepest depth that does (`_fit_depth`). The LM kinds train through the
# launcher's `main`, encdec and vlm through `make_train_step` on batches
# that carry their source frames or patches.
FAMILY_TRAIN = (("zamba2-2.7b", 8, 512), ("qwen2-vl-2b", 2, 2048),
                ("seamless-m4t-medium", 8, 512), ("olmoe-1b-7b", 8, 512),
                ("falcon-mamba-7b", 8, 512))
FAMILY_STEPS = 3
FIT_SHARE = 0.9
FAMILY_DIR = ROOT / "build" / "chip_smoke_family_train"


def _fit_depth(cfg, batch: int, seq: int, capacity: int):
    """`cfg` at full depth where `train_memory_bytes` puts its training at
    most FIT_SHARE of `capacity`, else at the deepest depth that is (for
    hybrid a multiple of attn_every)."""
    from repro_torch.launch.train import train_memory_bytes

    step = cfg.attn_every if cfg.kind == "hybrid" else 1
    for n in range(cfg.n_layers, 0, -step):
        cut = dataclasses.replace(cfg, n_layers=n)
        if sum(train_memory_bytes(cut, batch, seq)) <= FIT_SHARE * capacity:
            return cut
    raise SystemExit(f"{cfg.name} does not train on the card at any depth")


def _family_launches_per_step(cfg) -> dict:
    """One train step's launches per path, from the model's structure: the
    forward's GEMMs (`_gemms_per_forward`, and encdec's encoder and
    cross-KV, `_gemms_per_admission`) on ``wgmma``, a tied head's too (it
    reads the table as an (N, K) B); each unit's GEMMs again where remat
    recomputes it (every GEMM but the head's: the blocks, hybrid's groups
    with their shared block, encdec's encoder and decoder layers with
    their cross-KV); two backward GEMMs per bf16-out forward GEMM on
    ``wgmma``, and the f32-out products' (the head, the MoE routers) on
    ``split``, each with one ``split3``; none on ``general``. 721, 2 and 1
    for starcoder2-3b (`_train_launches_per_step`)."""
    fwd = _gemms_per_forward(cfg) + (_gemms_per_admission(cfg)
                                     if cfg.kind == "encdec" else 0)
    f32 = _f32_outs(cfg)
    return {"stream": 0,
            "wgmma": fwd + (fwd - 1 if cfg.remat else 0) + 2 * (fwd - f32),
            "split": 2 * f32, "general": 0, "split3": f32}


def _family_batch(dev, cfg, rows: int, seq: int, step: int) -> dict:
    """Step `step`'s seeded synthetic batch of `cfg`'s kind: tokens and
    labels of the JAX package's pipeline; encdec adds `src_len(seq)`
    source frames, vlm an N_PATCHES patch prefix on its GRID (seq counts
    it) with M-RoPE positions and a loss mask of 0 on the patches. The
    frames and patches are N(0, 1), drawn on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

    g = torch.Generator(dev).manual_seed(1000 + step)
    if cfg.kind == "vlm":
        from repro_torch.configs.qwen2_vl_2b import GRID, N_PATCHES
        from repro_torch.models.vlm import build_mrope_positions

        text = seq - N_PATCHES
        b = SyntheticLMDataset(DataConfig(seq_len=text, global_batch=rows,
                                          vocab=cfg.vocab)).batch_at(step)
        labels = np.concatenate([np.zeros((rows, N_PATCHES), np.int32),
                                 b["labels"]], axis=1)
        mask = np.ones((rows, seq), np.float32)
        mask[:, :N_PATCHES] = 0.0
        pos = np.broadcast_to(build_mrope_positions(N_PATCHES, GRID, text),
                              (rows, seq, 3))
        out = {"tokens": b["tokens"], "labels": labels, "loss_mask": mask,
               "positions_3d": pos.astype(np.int32)}
        out = {k: torch.as_tensor(v, device=dev) for k, v in out.items()}
        out["patch_embeds"] = torch.randn((rows, N_PATCHES, cfg.d_model),
                                          generator=g, device=dev)
        return out
    b = SyntheticLMDataset(DataConfig(seq_len=seq, global_batch=rows,
                                      vocab=cfg.vocab)).batch_at(step)
    out = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    if cfg.kind == "encdec":
        from repro_torch.configs.seamless_m4t_medium import src_len

        out["src_embeds"] = torch.randn((rows, src_len(seq), cfg.d_model),
                                        generator=g, device=dev)
    return out


def _family_steps(dev, cfg, rows: int, seq: int, log) -> tuple:
    """encdec and vlm: FAMILY_STEPS steps of `make_train_step` (the
    launcher's AdamW) on `_family_batch`es, each timed to its loss on the
    host, as the launcher's loop times them. Returns (state, the loop's
    summary keys)."""
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    api = get_model(cfg)
    state = init_train_state(torch.Generator(dev).manual_seed(0), api, cfg,
                             device=dev)
    step = make_train_step(api, cfg, AdamWConfig(
        lr=3e-4, warmup_steps=10, decay_steps=FAMILY_STEPS))
    losses, norms, times = [], [], []
    for i in range(FAMILY_STEPS):
        batch = _family_batch(dev, cfg, rows, seq, i)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        log(f"step {i + 1} loss {losses[-1]:.4f} grad_norm {norms[-1]:.4f} "
            f"({1e3 * times[-1]:.0f} ms/step)")
    return state, {"final_step": FAMILY_STEPS, "loss_curve": losses,
                   "grad_norms": norms, "step_times_s": times}


def _train_family(dev, arch: str, rows: int, seq: int) -> dict:
    """(a) for one family: train it FAMILY_STEPS steps at full width (cut in
    depth by `_fit_depth`), the counters set to 0 just before and read just
    after; gates: finite losses and grad norms, every master leaf and
    weight matrix moved from the seeded init, launches per step and path
    from the structure. Returns its launches by shape and layout and by
    path, the cut config, the peak and the steps' times."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul
    from repro_torch.launch import train as launch
    from repro_torch.models.registry import get_model

    cap = torch.cuda.get_device_properties(dev).total_memory
    full = get_config(arch)
    cfg = _fit_depth(full, rows, seq, cap)
    state_b, acts_b = launch.train_memory_bytes(cfg, rows, seq)
    want = _family_launches_per_step(cfg)
    tag = f"family (a) {arch}"
    _say(f"[{tag}] {cfg.kind}: {cfg.n_layers} of {full.n_layers} layers"
         + ("" if cfg.n_layers == full.n_layers else
            f" (cut: {full.n_layers} would need "
            f"{sum(launch.train_memory_bytes(full, rows, seq)) / 1e9:.1f} "
            f"GB)")
         + f", d_model {cfg.d_model}, vocab {cfg.vocab}, remat "
         f"{cfg.remat}; {rows} x {seq} tokens a step; "
         f"{cfg.n_params() / 1e9:.3f} B params, training state "
         f"{state_b / 1e9:.2f} GB, activations about {acts_b / 1e9:.2f} GB "
         f"(`train_memory_bytes`) on a card of {cap / 1e9:.2f} GB; launches "
         f"per step from the structure: {want}")
    shapes: collections.Counter = collections.Counter()
    splits: collections.Counter = collections.Counter()
    marks = []

    def on_log(line: str) -> None:
        _say(f"[{tag}] {line}")
        if line.startswith("step "):
            marks.append(_launch_counts())

    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tally: dict = {}
    recording, splitting = _train_recording(shapes, splits)
    ops.tiled_matmul, ops.split3 = _path_tally(recording, tally), splitting
    real_config = launch.get_config
    launch.get_config = lambda name, smoke=False: cfg
    try:
        _zero_counts()
        marks.append(_launch_counts())
        if cfg.kind in ("encdec", "vlm"):
            state, summary = _family_steps(dev, cfg, rows, seq, on_log)
        else:
            state, summary = launch.main(
                ["--arch", arch, "--steps", str(FAMILY_STEPS), "--batch",
                 str(rows), "--seq", str(seq), "--log-every", "1",
                 "--ckpt-every", str(10 * FAMILY_STEPS), "--ckpt-dir",
                 str(FAMILY_DIR)], log_fn=on_log)
        torch.cuda.synchronize()
        launches = tiled_matmul.launches
        by_path = _launch_counts()
    finally:
        ops.tiled_matmul, ops.split3 = tiled_matmul, split3
        launch.get_config = real_config
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(FAMILY_DIR, ignore_errors=True)
    steps = [{p: b[p] - a[p] for p in a} for a, b in zip(marks, marks[1:])]
    times = list(summary["step_times_s"])
    warm = float(np.mean(times[1:]))
    _say(f"[{tag}] {summary['final_step']} steps in {wall:.1f} s (init "
         f"and data included); step ms "
         + ", ".join(f"{1e3 * t:.1f}" for t in times)
         + f"; after the first: mean {1e3 * warm:.1f} ms, "
         f"{rows * seq / warm:.1f} training tokens/s; peak device memory "
         f"{peak / 1e9:.2f} GB against {(state_b + acts_b) / 1e9:.2f} GB "
         f"estimated")
    _say(f"[{tag}] launches per step by path: {steps} (expected {want} "
         f"each); {launches} in all")
    init = get_model(cfg).init(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    moved = {"master": 0, "matrices": 0}
    n_mat = 0
    trained = dict(state["params"].named_parameters())
    for name, p0 in init.named_parameters():
        p = trained[name]
        moved["master"] += not torch.equal(state["opt"]["master"][name],
                                           p0.float())
        if p.dim() >= 2:
            n_mat += 1
            moved["matrices"] += not torch.equal(p, p0)
    n_leaves = sum(1 for _ in init.parameters())
    del init
    _say(f"[{tag}] params moved from the init: master {moved['master']} of "
         f"{n_leaves} leaves, weight matrices {moved['matrices']} of "
         f"{n_mat}; optimizer step {int(state['opt']['step'])}")
    finite = bool(np.isfinite(summary["loss_curve"]).all()
                  and np.isfinite(summary["grad_norms"]).all())
    if (summary["final_step"] != FAMILY_STEPS or not finite
            or len(steps) != FAMILY_STEPS or any(s != want for s in steps)
            or launches != FAMILY_STEPS * sum(want[p] for p in GEMM_PATHS)
            or moved["master"] != n_leaves or moved["matrices"] != n_mat):
        raise SystemExit(f"{arch}'s training failed its gates (steps, "
                         "finite losses and grad norms, launches per step "
                         "and path, params moved)")
    del state
    return {"cfg": cfg, "shapes": shapes, "splits": splits,
            "by_path": by_path, "peak": peak, "warm_s": warm, "wall": wall,
            "card": _per_step(tally, steps)}


def _family_specs(cfg, rows: int, seq: int) -> dict:
    """{name: (shape, dtype)} of `_family_batch`'s leaves: int32 token
    ids from the numpy pipeline, f32 frames, patches and loss mask."""
    i32, f32 = torch.int32, torch.float32
    if cfg.kind == "vlm":
        from repro_torch.configs.qwen2_vl_2b import N_PATCHES

        return {"tokens": ((rows, seq - N_PATCHES), i32),
                "labels": ((rows, seq), i32),
                "loss_mask": ((rows, seq), f32),
                "positions_3d": ((rows, seq, 3), i32),
                "patch_embeds": ((rows, N_PATCHES, cfg.d_model), f32)}
    out = {"tokens": ((rows, seq), i32), "labels": ((rows, seq), i32)}
    if cfg.kind == "encdec":
        from repro_torch.configs.seamless_m4t_medium import src_len

        out["src_embeds"] = ((rows, src_len(seq), cfg.d_model), f32)
    return out


def _family_cut(cfg):
    """(c)'s cut: TRAIN_CUT layers (hybrid: one group of attn_every Mamba2
    blocks and its shared block; encdec: TRAIN_CUT encoder and decoder
    layers)."""
    if cfg.kind == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every)
    if cfg.kind == "encdec":
        return dataclasses.replace(cfg, n_layers=TRAIN_CUT,
                                   n_encoder_layers=TRAIN_CUT)
    return dataclasses.replace(cfg, n_layers=TRAIN_CUT)


def phase_families(dev) -> dict:
    """Phase 16, the other families' training on the card: for each of
    FAMILY_TRAIN, (a) its training at full width through the launcher (the
    LM kinds) or the train step (encdec, vlm), (b) its GEMMs against the
    plain version, timed, (c) gradients through the kernel against the
    plain version at `_family_cut`. Returns {"launches": per path summed
    over the families' (a), "entries": each family's per-path JSON entries
    over its (a)}."""
    t0 = time.perf_counter()
    launched: collections.Counter = collections.Counter()
    groups = []
    for arch, rows, seq in FAMILY_TRAIN:
        _free()
        t1 = time.perf_counter()
        run = _train_family(dev, arch, rows, seq)
        _free()
        _train_dry_check(f"family (d) {arch}", run["cfg"],
                         _family_specs(run["cfg"], rows, seq), run["card"],
                         run["warm_s"], run["peak"], rows, seq)
        launched.update(run["by_path"])
        groups.append(_train_shapes(dev, run["shapes"], FAMILY_STEPS,
                                    tag=f"family (b) {arch}",
                                    splits=run["splits"]))
        _free()
        cut = _family_cut(run["cfg"])
        _train_grads(dev, cut, _family_batch(dev, cut, rows, seq, 0),
                     tag=f"family (c) {arch}")
        _free()
        _say(f"[family] {arch} in {time.perf_counter() - t1:.1f} s")
    _say(f"[family] phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"launches": launched, "entries": groups}


# Phase 18: training under tensor parallelism. (a) full-width, full-depth
# starcoder2-3b at tp = TP_RANKS through the launcher's tp path, in as many
# rank processes on the one card (gloo), at phase 15 (a)'s seed, batch and
# sequence for TRAIN_TP_STEPS steps (fewer than TRAIN_STEPS: step 1 is the
# gate; run for four, steps 2-4 lay within 3.9e-3 of tp=1's loss),
# checkpoints in a directory of its own (phase 15's would be resumed). Gates
# against phase 15 (a)'s tp=1 run: step 1's loss within TRAIN_TP_LOSS_REL and
# its grad norm within TRAIN_TP_NORM_REL (the psum re-associates sums of bf16
# partials, so the bits need not match). (c) the SSM, hybrid, encoder-decoder
# and vision families at tp = TP_RANKS on the same rank pool,
# `TP_FAMILY_TRAIN`: (arch, layers or None for full depth, rows, sequence),
# full width, remat on, TP_FAMILY_STEPS steps of `make_train_step` each,
# against one tp=1 step of the same cut, seed and batch in this process
TRAIN_TP_DIR = ROOT / "build" / "chip_smoke_train_tp"
TRAIN_TP_LOSS_REL = 1e-2
TRAIN_TP_NORM_REL = 5e-2
TRAIN_TP_STEPS = 2
TP_FAMILY_TRAIN = (("falcon-mamba-7b", 4, 2, 512), ("zamba2-2.7b", 12, 2, 512),
                   ("seamless-m4t-medium", None, 2, 512),
                   ("qwen2-vl-2b", 4, 1, 2048))
TP_FAMILY_STEPS = 2


# phase 18 (d): FSDP training of full-width qwen2.5-14b cut to FSDP_LAYERS
# layers at (data 2, model 1) in the pool's two gloo ranks on the card, step
# 1 against one rank's step of the same model
FSDP_ARCH = "qwen2.5-14b"
FSDP_LAYERS = 2
FSDP_ROWS, FSDP_SEQ = 4, 512
FSDP_STEPS = 2
FSDP_REL = 1e-4

# phase 18 (e): Megatron sequence parallelism on (a)'s ranks, model, seed
# and batch (starcoder2-3b at tp=2, full width and depth) through the
# launcher's --sequence-parallel, SP_STEPS steps, step 1 against (a)'s
SP_DIR = ROOT / "build" / "chip_smoke_train_sp"
SP_STEPS = 1
SP_LOSS_REL, SP_NORM_REL = 1e-4, 1e-3

# phase 18 (f): experts over "data": full-width olmoe-1b-7b cut to
# EP_LAYERS of its 16 layers at (data 2, model 1) on the pool, step 1
# against one rank's whole-batch step of the same model
EP_ARCH = "olmoe-1b-7b"
EP_LAYERS = 2
EP_ROWS, EP_SEQ = 4, 512
EP_STEPS = 2
EP_REL = 1e-4


def _fsdp_cfg():
    """(d)'s config: `FSDP_ARCH` at full width, `FSDP_LAYERS` deep, with
    its published ``fsdp=True``."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(FSDP_ARCH), n_layers=FSDP_LAYERS)
    assert cfg.fsdp
    return cfg


def _fsdp_rank(mesh) -> dict:
    """One rank of phase 18 (d), in its own process: `_tp_family_steps`
    of `_fsdp_cfg` on the (data `TP_RANKS`, model 1) mesh over the pool's
    ranks, with ZeRO-1 (as the dry-run's rank trains)."""
    from repro_torch.kernels._build import load_library
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    fsdp = make_host_mesh(1, mesh.tp * mesh.data)
    out = _tp_family_steps(dev, _fsdp_cfg(), FSDP_ROWS, FSDP_SEQ,
                           FSDP_STEPS, fsdp, zero1=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def _fsdp_run(dev, pool) -> tuple:
    """(d)'s runs: one whole-batch step of `_fsdp_cfg` at one rank in this
    process (its memory freed before the ranks build), then `FSDP_STEPS`
    steps on every rank of `pool` under FSDP. Returns (the one-rank step,
    the ranks' runs)."""
    t0 = time.perf_counter()
    one = _tp_family_steps(dev, _fsdp_cfg(), FSDP_ROWS, FSDP_SEQ, 1)
    one["seconds"] = time.perf_counter() - t0
    return one, pool.run(_fsdp_rank)


def _fsdp_gates(dev, one: dict, ranks: list, checked: set,
                checked_splits: set) -> collections.Counter:
    """(d)'s lines and gates: per rank step 1's loss and grad norm within
    `FSDP_REL` (relative) of the one-rank step's (`_fsdp_run`), every loss
    and norm finite, every master leaf and weight matrix moved, the
    launches per step from the structure (`_family_launches_per_step`,
    the one-rank step's too; none on general), each step's collectives
    (calls and operand bytes by op) the dry count of the dry-run's rank
    on a dry (`TP_RANKS`, 1) mesh, both ranks' losses equal; then each
    distinct GEMM shape not in `checked` (and split kernel shape not in
    `checked_splits`) held to the plain version (`_check_train_shapes`).
    Returns the launches per path summed over the ranks and steps."""
    from repro_torch.launch.train import train_memory_bytes

    cfg = _fsdp_cfg()
    want = _family_launches_per_step(cfg)
    launched: collections.Counter = collections.Counter()
    failed = []
    if one["steps"][0] != want:
        failed.append(f"one rank: launches {one['steps'][0]}")
    new: set = set()
    new_splits: set = set()
    state_1, acts_1 = train_memory_bytes(cfg, FSDP_ROWS, FSDP_SEQ)
    _say(f"[train fsdp (d)] {cfg.name} at {cfg.n_layers} of 48 layers, "
         f"full width, {FSDP_ROWS} x {FSDP_SEQ} tokens, one rank in this "
         f"process (one backward): step 1 loss "
         f"{one['loss_curve'][0]:.6f}, grad norm "
         f"{one['grad_norms'][0]:.6f}, {1e3 * one['step_times_s'][0]:.1f} "
         f"ms, peak {one['peak_bytes'] / 1e9:.2f} GB beside "
         f"`train_memory_bytes` {(state_1 + acts_1) / 1e9:.2f} GB, "
         f"{one['seconds']:.1f} s with init; launches {one['steps'][0]}")
    for r, out in enumerate(ranks):
        for step in out["steps"]:
            launched.update({p: step[p] for p in (*GEMM_PATHS, "split3")})
        new |= {tuple(key) for key in out["shapes"]} - checked
        new_splits |= {tuple(key) for key in out["splits"]} - checked_splits
        _say(f"[train fsdp (d)] rank {r} (data {TP_RANKS}, model 1, FSDP "
             f"and ZeRO-1): step ms "
             + ", ".join(f"{1e3 * t:.1f}" for t in out["step_times_s"])
             + f"; collectives per step {out['collectives']}, host time "
             + ", ".join(f"{t:.3f}" for t in out["collective_host_s"])
             + f" s; peak {out['peak_bytes'] / 1e9:.2f} GB; launches per "
             f"step {out['steps']}; in {out['seconds']:.1f} s")
        for i, (l2, n2) in enumerate(zip(out["loss_curve"],
                                         out["grad_norms"])):
            ref = (f" (one rank {one['loss_curve'][0]:.6f}, diff "
                   f"{l2 - one['loss_curve'][0]:+.3e}; grad norm one rank "
                   f"{one['grad_norms'][0]:.6f}, diff "
                   f"{n2 - one['grad_norms'][0]:+.3e})" if i == 0 else "")
            _say(f"[train fsdp (d)] rank {r} step {i + 1}: loss {l2:.6f}, "
                 f"grad norm {n2:.6f}{ref}")
        finite = bool(np.isfinite(out["loss_curve"]).all()
                      and np.isfinite(out["grad_norms"]).all())
        rel_l = (abs(out["loss_curve"][0] - one["loss_curve"][0])
                 / abs(one["loss_curve"][0]))
        rel_n = (abs(out["grad_norms"][0] - one["grad_norms"][0])
                 / abs(one["grad_norms"][0]))
        if (not finite or rel_l > FSDP_REL or rel_n > FSDP_REL
                or out["unmoved"]):
            failed.append(f"rank {r}: finite {finite}, step 1's loss "
                          f"{rel_l:.3e} and grad norm {rel_n:.3e} relative "
                          f"to one rank's, unmoved {out['unmoved'][:4]}")
        if any(st != want for st in out["steps"]):
            failed.append(f"rank {r}: launches {out['steps']} (expected "
                          f"{want})")
        for i, posted in enumerate(out["by_op"]):
            if not _mesh_gate("mesh fsdp (d)", posted):
                failed.append(f"rank {r} step {i + 1}: collectives "
                              f"{posted}")
    if any(out["loss_curve"] != ranks[0]["loss_curve"] for out in ranks):
        failed.append("the ranks' losses differ")
    if failed:
        raise SystemExit("[train fsdp (d)] " + "; ".join(failed))
    _check_train_shapes(dev, new, new_splits, "train fsdp (d)")
    return launched


def _sp_gates(ranks: list, tp_ranks: list, checked: set,
              checked_splits: set) -> tuple:
    """(e)'s lines and gates: per rank step 1's loss within `SP_LOSS_REL`
    and grad norm within `SP_NORM_REL` (relative) of (a)'s tp=2 step 1
    (`tp_ranks`), every step finite, the launches per step (a)'s from the
    structure (`_train_launches_per_step`: SP gathers the sequence before
    every product, so the GEMMs are (a)'s), each step's collectives by op
    the dry count of the dry-run's rank on a dry (1, `TP_RANKS`) mesh,
    both ranks' losses equal. Returns (the launches per path summed over
    the ranks and steps, the GEMM shapes not in `checked`, the split
    shapes not in `checked_splits`)."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    want = _train_launches_per_step(cfg)
    loss1 = tp_ranks[0]["summary"]["loss_curve"][0]
    norm1 = tp_ranks[0]["summary"]["grad_norms"][0]
    launched: collections.Counter = collections.Counter()
    new, new_splits, failed = set(), set(), []
    for r, out in enumerate(ranks):
        s = out["summary"]
        for step in out["steps"]:
            launched.update({p: step[p] for p in (*GEMM_PATHS, "split3")})
        new |= {tuple(key) for key in out["shapes"]} - checked
        new_splits |= {tuple(key) for key in out["splits"]} - checked_splits
        _say(f"[train sp (e)] rank {r} of {TP_RANKS} on one card (gloo), "
             f"{cfg.name} at tp={TP_RANKS} with sequence parallelism: step "
             "ms " + ", ".join(f"{1e3 * t:.1f}" for t in s["step_times_s"])
             + f"; peak {out['peak_bytes'] / 1e9:.2f} GB; collectives per "
             f"step {out['collectives']}, host time "
             + ", ".join(f"{t:.3f}" for t in out["collective_host_s"])
             + f" s; launches per step {out['steps']} (expected {want}); in "
             f"{out['seconds']:.1f} s")
        l1, n1 = s["loss_curve"][0], s["grad_norms"][0]
        rel_l, rel_n = abs(l1 - loss1) / abs(loss1), abs(n1 - norm1) / norm1
        _say(f"[train sp (e)] rank {r} step 1: loss {l1:.6f} ((a) "
             f"{loss1:.6f}, relative {rel_l:.3e}), grad norm {n1:.6f} ((a) "
             f"{norm1:.6f}, relative {rel_n:.3e})")
        finite = bool(np.isfinite(s["loss_curve"]).all()
                      and np.isfinite(s["grad_norms"]).all())
        if (out["final_step"] != SP_STEPS or not finite
                or rel_l > SP_LOSS_REL or rel_n > SP_NORM_REL):
            failed.append(f"rank {r}: {SP_STEPS} finite steps, step 1's "
                          f"loss {rel_l:.3e} and grad norm {rel_n:.3e} "
                          "relative to (a)'s")
        if any(st != want for st in out["steps"]):
            failed.append(f"rank {r}: launches {out['steps']}")
        for i, posted in enumerate(out["by_op"]):
            if not _mesh_gate("mesh train sp (e)", posted):
                failed.append(f"rank {r} step {i + 1}: collectives by op "
                              f"{posted} differ from the dry count")
    if any(out["summary"]["loss_curve"] != ranks[0]["summary"]["loss_curve"]
           for out in ranks):
        failed.append("the ranks' losses differ")
    if failed:
        raise SystemExit("[train sp (e)] " + "; ".join(failed))
    return launched, new, new_splits


def _ep_cfg():
    """(f)'s config: `EP_ARCH` at full width, `EP_LAYERS` deep, its
    experts over "data"."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(EP_ARCH), n_layers=EP_LAYERS,
                               moe_expert_axis="data")


def _ep_rank(mesh) -> dict:
    """One rank of phase 18 (f), in its own process: `_tp_family_steps`
    of `_ep_cfg` on the (data `TP_RANKS`, model 1) mesh over the pool's
    ranks, with ZeRO-1 (as the dry-run's rank trains)."""
    from repro_torch.kernels._build import load_library
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    ep = make_host_mesh(1, mesh.tp * mesh.data)
    out = _tp_family_steps(dev, _ep_cfg(), EP_ROWS, EP_SEQ, EP_STEPS, ep,
                           zero1=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def _ep_run(dev, pool) -> tuple:
    """(f)'s runs: one whole-batch step of `_ep_cfg` at one rank in this
    process (the dense dispatch: no mesh; its memory freed before the
    ranks build), then `EP_STEPS` steps on every rank of `pool` with the
    experts over "data". Returns (the one-rank step, the ranks' runs)."""
    t0 = time.perf_counter()
    one = _tp_family_steps(dev, _ep_cfg(), EP_ROWS, EP_SEQ, 1)
    one["seconds"] = time.perf_counter() - t0
    return one, pool.run(_ep_rank)


def _ep_gates(one: dict, ranks: list, checked: set,
              checked_splits: set) -> tuple:
    """(f)'s lines and gates: per rank step 1's loss and grad norm within
    `EP_REL` (relative) of the one-rank step's (`_ep_run`), every loss and
    norm finite, every master leaf and weight matrix moved, the rank
    holding E/`TP_RANKS` experts of each expert leaf, its all-reduces
    carrying every gradient but the experts' (whose gradient is whole
    after the all-to-all's backward: the operand bytes a step less the
    non-expert gradients' are under 1 MB, the loss's and norm's sums),
    the launches per step the one-rank step's from the structure
    (`_family_launches_per_step`), each step's collectives by op the dry
    count on a dry (`TP_RANKS`, 1) mesh, both ranks' losses equal.
    Returns (the launches per path summed over the ranks and steps, the
    GEMM shapes not in `checked`, the split shapes not in
    `checked_splits`)."""
    cfg = _ep_cfg()
    E = cfg.n_experts
    want = _family_launches_per_step(cfg)
    launched: collections.Counter = collections.Counter()
    new, new_splits, failed = set(), set(), []
    if one["steps"][0] != want:
        failed.append(f"one rank: launches {one['steps'][0]}")
    _say(f"[train ep (f)] {cfg.name} at {cfg.n_layers} of 16 layers, full "
         f"width, {EP_ROWS} x {EP_SEQ} tokens, one rank in this process "
         f"(the dense dispatch): step 1 loss {one['loss_curve'][0]:.6f}, "
         f"grad norm {one['grad_norms'][0]:.6f}, "
         f"{1e3 * one['step_times_s'][0]:.1f} ms, peak "
         f"{one['peak_bytes'] / 1e9:.2f} GB, {one['seconds']:.1f} s with "
         f"init; launches {one['steps'][0]}")
    for r, out in enumerate(ranks):
        for step in out["steps"]:
            launched.update({p: step[p] for p in (*GEMM_PATHS, "split3")})
        new |= {tuple(key) for key in out["shapes"]} - checked
        new_splits |= {tuple(key) for key in out["splits"]} - checked_splits
        held = {out["experts"][n][0] for n in out["experts"]}
        rest = out["grad_bytes"] - out["expert_bytes"]
        extra = [st.get("all-reduce", {}).get("bytes", 0) - rest
                 for st in out["by_op"]]
        _say(f"[train ep (f)] rank {r} of {TP_RANKS} on one card (gloo), "
             f"(data {TP_RANKS}, model 1), experts over data, ZeRO-1: step "
             "ms " + ", ".join(f"{1e3 * t:.1f}" for t in out["step_times_s"])
             + f"; collectives per step {out['by_op']}, host time "
             + ", ".join(f"{t:.3f}" for t in out["collective_host_s"])
             + f" s; peak {out['peak_bytes'] / 1e9:.2f} GB; experts held "
             f"{sorted(held)} of {E}; all-reduce bytes a step less the "
             f"non-expert gradients' {rest} B: {extra}; launches per step "
             f"{out['steps']}; in {out['seconds']:.1f} s")
        for i, (l2, n2) in enumerate(zip(out["loss_curve"],
                                         out["grad_norms"])):
            ref = (f" (one rank {one['loss_curve'][0]:.6f}, diff "
                   f"{l2 - one['loss_curve'][0]:+.3e}; grad norm one rank "
                   f"{one['grad_norms'][0]:.6f}, diff "
                   f"{n2 - one['grad_norms'][0]:+.3e})" if i == 0 else "")
            _say(f"[train ep (f)] rank {r} step {i + 1}: loss {l2:.6f}, "
                 f"grad norm {n2:.6f}{ref}")
        finite = bool(np.isfinite(out["loss_curve"]).all()
                      and np.isfinite(out["grad_norms"]).all())
        rel_l = (abs(out["loss_curve"][0] - one["loss_curve"][0])
                 / abs(one["loss_curve"][0]))
        rel_n = (abs(out["grad_norms"][0] - one["grad_norms"][0])
                 / abs(one["grad_norms"][0]))
        if (not finite or rel_l > EP_REL or rel_n > EP_REL
                or out["unmoved"]):
            failed.append(f"rank {r}: finite {finite}, step 1's loss "
                          f"{rel_l:.3e} and grad norm {rel_n:.3e} relative "
                          f"to one rank's, unmoved {out['unmoved'][:4]}")
        if held != {E // TP_RANKS} or not all(0 <= x < 1 << 20
                                              for x in extra):
            failed.append(f"rank {r}: experts held {held}, all-reduce bytes "
                          f"past the non-expert gradients {extra}")
        if any(st != want for st in out["steps"]):
            failed.append(f"rank {r}: launches {out['steps']} (expected "
                          f"{want})")
        for i, posted in enumerate(out["by_op"]):
            if not _mesh_gate("mesh ep (f)", posted):
                failed.append(f"rank {r} step {i + 1}: collectives "
                              f"{posted}")
    if any(out["loss_curve"] != ranks[0]["loss_curve"] for out in ranks):
        failed.append("the ranks' losses differ")
    if failed:
        raise SystemExit("[train ep (f)] " + "; ".join(failed))
    return launched, new, new_splits


def _tp_train_collectives_per_step(cfg, tp: int) -> int:
    """One rank's collectives in one train step at tp in psum mode, one
    row chunk (`distributed.tp`), from the model's structure, for the
    dense, vlm, SSM, hybrid and encoder-decoder kinds. Each unit remat
    recomputes (a block; the hybrid's group of Mamba2 blocks and its
    shared block; an encoder layer; a decoder layer with its cross KV)
    makes its forward's all-reduces again up to its last saved tensor
    (checkpointing's early stop: the unit's last row-parallel all-reduce
    lies past it). Per block, forward / backward: attention with its FFN
    2 (wo, w_down) / 2 (each entry), two more in the backward for k and v
    where tp does not divide the KV heads; Mamba1 2 (x_proj's partial
    product, out_proj) / 2 (its entry, x_proj's sum again); Mamba2 2 (the
    gated norm's sum of squares, out_proj) / 2 (its entry, the sum again);
    a decoder layer 3 (self-attention's wo, cross-attention's wo, w_down)
    / 4 (the self-attention, query, cross KV and FFN entries). Per step:
    the vocab-sharded embedding's gather (where tp divides the vocab),
    the head's entry in the backward and the vocab-parallel loss's max,
    argmax, sum of exponentials and target logit (the same), the B and C
    gradients' sum over "model" (Mamba2, hybrid) and the global norm's.
    157 for starcoder2-3b; 27 for falcon-mamba-7b at 4 layers, 90 for
    zamba2-2.7b at 12, 175 for seamless-m4t-medium, 27 for qwen2-vl-2b at
    4."""
    rc = 1 if cfg.remat else 0
    kv = 2 if cfg.kv_heads % tp else 0
    attn = 2 + rc + 2 + kv                 # a block ending its unit
    ssm = 2 + rc + 2
    kind = cfg.kind
    if kind in ("mamba1", "mamba2"):
        units = cfg.n_layers * ssm
    elif kind == "hybrid":
        E = cfg.attn_every
        units = cfg.n_layers // E * (E * (2 + 2 * rc + 2) + attn)
    elif kind == "encdec":
        units = cfg.n_encoder_layers * attn + cfg.n_layers * (3 + 2 * rc + 4)
    elif kind in ("dense", "vlm"):
        units = cfg.n_layers * attn
    else:
        raise ValueError(f"no collective count for kind {kind!r}")
    vocab = 1 + 1 + 4 if cfg.vocab % tp == 0 else 0
    parts = 1 if kind in ("mamba2", "hybrid") else 0
    return units + vocab + parts + 1


def _tp_train_rank(mesh, argv: list) -> dict:
    """One rank of phase 18 (a), in its own process: the launcher's rank
    entry (`launch.train.train_rank`) on `argv`, every GEMM recorded by
    shape and layout (`_train_recording`), the launch and collective
    counters set to 0 just before and read after each step. Returns its
    summary, launches per step, shapes, collectives, memory and times."""
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul
    from repro_torch.launch import train as launch

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    shapes: collections.Counter = collections.Counter()
    splits: collections.Counter = collections.Counter()
    marks, colls, by_op = [], [], []

    def on_log(line: str) -> None:
        if line.startswith("step "):
            marks.append(_launch_counts())
            colls.append((TP.collectives.calls, TP.collectives.host_s))
            by_op.append(_by_op())

    torch.cuda.reset_peak_memory_stats(dev)
    recording, splitting = _train_recording(shapes, splits)
    ops.tiled_matmul, ops.split3 = recording, splitting
    try:
        _zero_counts()
        TP.reset_collectives()
        marks.append(_launch_counts())
        colls.append((0, 0.0))
        by_op.append({})
        state, summary = launch.train_rank(mesh, argv, log_fn=on_log,
                                           every_rank=True)
        torch.cuda.synchronize()
    finally:
        ops.tiled_matmul, ops.split3 = tiled_matmul, split3
    held = sum(p.numel() * p.element_size()
               for p in state["params"].parameters())
    opt = sum(t.numel() * t.element_size() for k in ("master", "m", "v")
              for t in state["opt"][k].values())
    out = {"summary": {k: summary[k].tolist() for k in (
               "loss_curve", "grad_norms", "step_times_s")},
           "final_step": summary["final_step"],
           "steps": [{p: b[p] - a[p] for p in a}
                     for a, b in zip(marks, marks[1:])],
           "collectives": [b[0] - a[0] for a, b in zip(colls, colls[1:])],
           "collective_host_s": [b[1] - a[1]
                                 for a, b in zip(colls, colls[1:])],
           "by_op": [_op_delta(a, b) for a, b in zip(by_op, by_op[1:])],
           "shapes": dict(shapes), "splits": dict(splits),
           "params_bytes": held, "opt_bytes": opt,
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "seconds": time.perf_counter() - t0}
    del state
    _free()
    return out


def _op_delta(a: dict, b: dict) -> dict:
    """The collectives by op posted between two `_by_op` copies."""
    return {op: {k: t[k] - a.get(op, {}).get(k, 0) for k in t}
            for op, t in b.items()
            if t["calls"] != a.get(op, {}).get("calls", 0)}


def _tp_family_cfg(arch: str, layers: int | None):
    """(c)'s config of `arch`: full width, `layers` deep (None: full)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _tp_family_steps(dev, cfg, rows: int, seq: int, steps: int,
                     mesh=None, zero1: bool = False) -> dict:
    """`steps` steps of `make_train_step` (on `mesh`, or at tp=1; ZeRO-1
    where `zero1`) from the seeded init on `_family_batch`es, every GEMM
    recorded by shape and layout, the launch and collective counters set
    to 0 just before and read just after each step. Returns the losses,
    grad norms, step times, launches and collectives per step (also by
    op), the shapes, the peak memory, the
    master leaves and weight matrices that did not move, and the hash of the B and C
    gradients' first moment after step 1 ((1 - b1) times the clipped
    gradient, elementwise: equal bits on every rank iff the gradients'
    are)."""
    import hashlib

    from repro_torch.distributed import sharding
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import split3, tiled_matmul
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        train_config)

    api = get_model(cfg)
    state = init_train_state(torch.Generator(dev).manual_seed(0), api, cfg,
                             device=dev, mesh=mesh, zero1=zero1)
    torch.cuda.reset_peak_memory_stats(dev)
    step = make_train_step(api, cfg, AdamWConfig(
        lr=3e-4, warmup_steps=10, decay_steps=steps),
        mesh=mesh, zero1=zero1)
    def sums() -> dict:
        """{(name, "master" or "param"): the leaf's float64 sum}: every
        master leaf and weight matrix (the ones a step must move)."""
        out = {(n, "master"): t.double().sum().item()
               for n, t in state["opt"]["master"].items()}
        out.update({(n, "param"): p.double().sum().item()
                    for n, p in state["params"].named_parameters()
                    if p.dim() == 2})
        return out

    before = sums()
    named = dict(state["params"].named_parameters())
    experts = {n: tuple(p.shape) for n, p in named.items()
               if ".experts." in n}
    nbytes = {n: p.numel() * p.element_size() for n, p in named.items()}
    parts = {}
    if mesh is not None:
        tcfg = train_config(cfg, mesh)
        parts = sharding.train_layout(api.init(tcfg, None, device="meta"),
                                      mesh, tcfg).whole_parts()
    shapes: collections.Counter = collections.Counter()
    splits: collections.Counter = collections.Counter()
    out = {"loss_curve": [], "grad_norms": [], "step_times_s": [],
           "steps": [], "collectives": [], "collective_host_s": [],
           "by_op": [], "experts": experts,
           "grad_bytes": sum(nbytes.values()),
           "expert_bytes": sum(nbytes[n] for n in experts)}
    recording, splitting = _train_recording(shapes, splits)
    ops.tiled_matmul, ops.split3 = recording, splitting
    try:
        for i in range(steps):
            batch = _family_batch(dev, cfg, rows, seq, i)
            torch.cuda.synchronize()
            _zero_counts()
            TP.reset_collectives()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            out["loss_curve"].append(float(m["loss"]))
            out["step_times_s"].append(time.perf_counter() - t0)
            out["grad_norms"].append(float(m["grad_norm"]))
            out["steps"].append(_launch_counts())
            out["collectives"].append(TP.collectives.calls)
            out["collective_host_s"].append(TP.collectives.host_s)
            out["by_op"].append(_by_op())
            if i == 0 and parts:
                h = hashlib.sha256()
                for name, (axis, local) in sorted(parts.items()):
                    for lo, size in sharding.whole_spans(local):
                        h.update(state["opt"]["m"][name].narrow(
                            axis, lo, size).float().cpu().numpy().tobytes())
                out["bc_hash"] = h.hexdigest()
        torch.cuda.synchronize()
    finally:
        ops.tiled_matmul, ops.split3 = tiled_matmul, split3
    after = sums()
    out["unmoved"] = [key for key, v in before.items() if after[key] == v]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["shapes"], out["splits"] = dict(shapes), dict(splits)
    del state, step
    _free()
    return out


def _tp_family_rank(mesh, arch: str, layers, rows: int, seq: int) -> dict:
    """One rank of phase 18 (c), in its own process: `_tp_family_steps` of
    `arch`'s cut on the pool's mesh."""
    from repro_torch.kernels._build import load_library

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    load_library()
    out = _tp_family_steps(dev, _tp_family_cfg(arch, layers), rows, seq,
                           TP_FAMILY_STEPS, mesh)
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_families(dev, pool) -> list:
    """(c)'s runs: for each of `TP_FAMILY_TRAIN`, one tp=1 step of the cut
    in this process (its memory freed before the ranks build), then its
    TP_FAMILY_STEPS steps on every rank of `pool`. Returns [(arch, cut
    config, rows, seq, the tp=1 step, the ranks' runs)]."""
    out = []
    for arch, layers, rows, seq in TP_FAMILY_TRAIN:
        cfg = _tp_family_cfg(arch, layers)
        t0 = time.perf_counter()
        one = _tp_family_steps(dev, cfg, rows, seq, 1)
        one["seconds"] = time.perf_counter() - t0
        ranks = pool.run(_tp_family_rank, arch, layers, rows, seq)
        out.append((arch, cfg, rows, seq, one, ranks))
    return out


def _tp_family_gates(dev, runs: list, checked: set,
                     checked_splits: set) -> collections.Counter:
    """(c)'s lines and gates, per model and rank: step 1's loss and grad
    norm near the tp=1 step's (`TRAIN_TP_LOSS_REL`, `TRAIN_TP_NORM_REL`),
    every loss and norm finite, every master leaf and weight matrix moved
    from the seeded init, the launches per step and path from the
    structure (`_family_launches_per_step`: all on wgmma and the split
    pair), the collectives per step `_tp_train_collectives_per_step`,
    both ranks' losses equal and the B and C gradients' hashes equal;
    then each distinct shard GEMM not in `checked`, and split kernel shape
    not in `checked_splits`, held to the plain version as (b)'s are
    (`_check_train_shapes`). Returns the launches per path summed over the models, ranks
    and steps."""
    from repro_torch.launch.train import train_memory_bytes

    launched: collections.Counter = collections.Counter()
    failed = []
    new: set = set()
    new_splits: set = set()
    for arch, cfg, rows, seq, one, ranks in runs:
        want = _family_launches_per_step(cfg)
        coll = _tp_train_collectives_per_step(cfg, TP_RANKS)
        state_b, acts_b = train_memory_bytes(cfg, rows, seq, tp=TP_RANKS)
        state_1, acts_1 = train_memory_bytes(cfg, rows, seq)
        depth = (f"{cfg.n_encoder_layers} + {cfg.n_layers}"
                 if cfg.kind == "encdec" else f"{cfg.n_layers}")
        _say(f"[train tp (c)] {arch} ({cfg.kind}, {depth} layers, {rows} x "
             f"{seq}) at tp=1 in this process: step 1 loss "
             f"{one['loss_curve'][0]:.4f}, grad norm "
             f"{one['grad_norms'][0]:.4f}, "
             f"{1e3 * one['step_times_s'][0]:.1f} ms, peak "
             f"{one['peak_bytes'] / 1e9:.2f} GB beside `train_memory_bytes` "
             f"{(state_1 + acts_1) / 1e9:.2f} GB, {one['seconds']:.1f} s "
             f"with init; launches {one['steps'][0]} (expected {want})")
        if one["steps"][0] != want:
            failed.append(f"{arch} tp=1: launches {one['steps'][0]}")
        for r, out in enumerate(ranks):
            for step in out["steps"]:
                launched.update({p: step[p] for p in (*GEMM_PATHS,
                                                      "split3")})
            new |= {tuple(key) for key in out["shapes"]} - checked
            new_splits |= ({tuple(key) for key in out["splits"]}
                           - checked_splits)
            _say(f"[train tp (c)] {arch} rank {r}: step ms "
                 + ", ".join(f"{1e3 * t:.1f}" for t in out["step_times_s"])
                 + f"; collectives per step {out['collectives']} (expected "
                 f"{coll}), host time "
                 + ", ".join(f"{t:.3f}" for t in out["collective_host_s"])
                 + f" s; peak {out['peak_bytes'] / 1e9:.2f} GB beside "
                 f"`train_memory_bytes(tp={TP_RANKS})` "
                 f"{(state_b + acts_b) / 1e9:.2f} GB; launches per step "
                 f"{out['steps']}; in {out['seconds']:.1f} s")
            for i, (l2, n2) in enumerate(zip(out["loss_curve"],
                                             out["grad_norms"])):
                ref = (f" (tp=1 {one['loss_curve'][0]:.4f}, diff "
                       f"{l2 - one['loss_curve'][0]:+.3e}; grad norm tp=1 "
                       f"{one['grad_norms'][0]:.4f}, diff "
                       f"{n2 - one['grad_norms'][0]:+.3e})" if i == 0 else "")
                _say(f"[train tp (c)] {arch} rank {r} step {i + 1}: loss "
                     f"{l2:.4f}, grad norm {n2:.4f}{ref}")
            finite = bool(np.isfinite(out["loss_curve"]).all()
                          and np.isfinite(out["grad_norms"]).all())
            rel_l = (abs(out["loss_curve"][0] - one["loss_curve"][0])
                     / abs(one["loss_curve"][0]))
            rel_n = (abs(out["grad_norms"][0] - one["grad_norms"][0])
                     / abs(one["grad_norms"][0]))
            if (not finite or rel_l > TRAIN_TP_LOSS_REL
                    or rel_n > TRAIN_TP_NORM_REL or out["unmoved"]):
                failed.append(f"{arch} rank {r}: finite {finite}, step 1's "
                              f"loss {rel_l:.3e} and grad norm {rel_n:.3e} "
                              f"relative to tp=1's, unmoved "
                              f"{out['unmoved'][:4]}")
            if (any(st != want for st in out["steps"])
                    or any(c != coll for c in out["collectives"])):
                failed.append(f"{arch} rank {r}: launches {out['steps']}, "
                              f"collectives {out['collectives']}")
        if any(out["loss_curve"] != ranks[0]["loss_curve"] for out in ranks):
            failed.append(f"{arch}: the ranks' losses differ")
        hashes = {out.get("bc_hash") for out in ranks}
        if cfg.kind in ("mamba2", "hybrid"):
            _say(f"[train tp (c)] {arch}: the B and C gradients' first "
                 f"moment after step 1, sha256 per rank "
                 f"{[out['bc_hash'][:16] for out in ranks]}: equal "
                 f"{len(hashes) == 1}")
            if len(hashes) != 1 or None in hashes:
                failed.append(f"{arch}: the B and C gradients differ "
                              "between the ranks")
    if failed:
        raise SystemExit("[train tp (c)] " + "; ".join(failed))
    _check_train_shapes(dev, new, new_splits, "train tp (c)")
    return launched


def phase_train_tp(dev, tp1: dict) -> dict:
    """Phase 18: training under tensor parallelism on the card, after
    phases 15 and 16 have handed their memory back, on one gloo
    `RankPool` of `TP_RANKS` ranks on the one card. (a) full-width,
    full-depth starcoder2-3b at tp = `TP_RANKS` through the launcher's tp
    path (`_tp_train_rank` in each rank process), TRAIN_TP_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens from phase 15 (a)'s seed; `tp1` is
    phase 15 (a)'s summary. Gates: step 1's loss and grad norm near tp=1's
    (`TRAIN_TP_LOSS_REL`, `TRAIN_TP_NORM_REL`), every step finite, per
    rank each step's launches `_train_launches_per_step` (all on wgmma,
    the split pair and split3) and collectives
    `_tp_train_collectives_per_step`. (c) the SSM, hybrid,
    encoder-decoder and vision families on the same pool
    (`_tp_families`, `_tp_family_gates`), and (d) FSDP training of
    qwen2.5-14b at (data 2, model 1) on the same pool (`_fsdp_run`,
    `_fsdp_gates`), (e) Megatron sequence parallelism on (a)'s ranks,
    model, seed and batch through the launcher's --sequence-parallel
    (`_sp_gates`: step 1 against (a)'s), and (f) full-width olmoe-1b-7b at
    `EP_LAYERS` layers with its experts over "data" at (data 2, model 1)
    on the same pool (`_ep_run`, `_ep_gates`: step 1 against one rank's).
    (a)'s, (d)'s, (e)'s and (f)'s steps post the collectives the mesh dry
    counts give (`_mesh_gate`). Then (b) every distinct shard GEMM of
    (a)'s step against the plain version (`_train_shapes`), and (c)'s,
    (d)'s, (e)'s and (f)'s new ones. Returns {"launches": per path summed over the ranks,
    "entries": (b)'s per-path JSON entries}."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_memory_bytes

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    want = _train_launches_per_step(cfg)
    coll_want = _tp_train_collectives_per_step(cfg, TP_RANKS)
    state_b, acts_b = train_memory_bytes(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                         tp=TP_RANKS)
    _say(f"[train tp (a)] {cfg.name} at tp={TP_RANKS} in {TP_RANKS} "
         f"processes on one card (gloo), psum mode: a rank's training "
         f"state {state_b / 1e9:.2f} GB, activations about "
         f"{acts_b / 1e9:.2f} GB (`train_memory_bytes` at tp={TP_RANKS}); "
         f"launches per step from the structure {want}, collectives "
         f"{coll_want}")
    shutil.rmtree(TRAIN_TP_DIR, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_TP_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
            "--ckpt-every", str(10 * TRAIN_TP_STEPS), "--ckpt-dir",
            str(TRAIN_TP_DIR), "--tp", str(TP_RANKS)]
    argv_sp = ["--arch", TRAIN_ARCH, "--steps", str(SP_STEPS), "--batch",
               str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every",
               "1", "--ckpt-every", str(10 * SP_STEPS), "--ckpt-dir",
               str(SP_DIR), "--tp", str(TP_RANKS), "--sequence-parallel"]
    times = {}

    def lap(key: str) -> None:
        times[key] = time.perf_counter() - t0 - sum(times.values())

    def run(pool):
        try:
            ranks = pool.run(_tp_train_rank, argv)
        finally:
            shutil.rmtree(TRAIN_TP_DIR, ignore_errors=True)
        lap("a")
        shutil.rmtree(SP_DIR, ignore_errors=True)
        try:
            sp = pool.run(_tp_train_rank, argv_sp)
        finally:
            shutil.rmtree(SP_DIR, ignore_errors=True)
        lap("e")
        families = _tp_families(dev, pool)
        lap("c")
        fsdp = _fsdp_run(dev, pool)
        lap("d")
        ep = _ep_run(dev, pool)
        lap("f")
        return ranks, sp, families, fsdp, ep

    ranks, sp, families, fsdp, ep = _tp_pool(run)
    losses1, norms1 = tp1["loss_curve"], tp1["grad_norms"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    failed = []
    launched: collections.Counter = collections.Counter()
    for r, out in enumerate(ranks):
        s = out["summary"]
        times_s = s["step_times_s"]
        for step in out["steps"]:
            launched.update({p: step[p] for p in (*GEMM_PATHS, "split3")})
        _say(f"[train tp (a)] rank {r}: step ms "
             + ", ".join(f"{1e3 * t:.1f}" for t in times_s)
             + f"; after the first: mean "
             f"{1e3 * float(np.mean(times_s[1:])):.1f} ms, "
             f"{tokens / float(np.mean(times_s[1:])):.1f} training tokens/s "
             f"(the mesh's, {TP_RANKS} ranks sharing one card); peak "
             f"device memory {out['peak_bytes'] / 1e9:.2f} GB beside "
             f"`train_memory_bytes` {(state_b + acts_b) / 1e9:.2f} GB "
             f"(params {out['params_bytes'] / 1e9:.2f} GB, master/m/v "
             f"{out['opt_bytes'] / 1e9:.2f} GB); in {out['seconds']:.1f} s")
        _say(f"[train tp (a)] rank {r}: launches per step {out['steps']} "
             f"(expected {want} each); collectives per step "
             f"{out['collectives']} (expected {coll_want}), host time "
             + ", ".join(f"{t:.3f}" for t in out["collective_host_s"])
             + f" s ({1e3 * sum(out['collective_host_s']) / max(1, sum(out['collectives'])):.3f}"
             " ms a collective)")
        for i, (l2, n2) in enumerate(zip(s["loss_curve"], s["grad_norms"])):
            _say(f"[train tp (a)] rank {r} step {i + 1}: loss {l2:.4f} "
                 f"(tp=1 {losses1[i]:.4f}, diff {l2 - losses1[i]:+.3e}), "
                 f"grad norm {n2:.4f} (tp=1 {norms1[i]:.4f}, diff "
                 f"{n2 - norms1[i]:+.3e})")
        finite = bool(np.isfinite(s["loss_curve"]).all()
                      and np.isfinite(s["grad_norms"]).all())
        rel_l = abs(s["loss_curve"][0] - losses1[0]) / abs(losses1[0])
        rel_n = abs(s["grad_norms"][0] - norms1[0]) / abs(norms1[0])
        if (out["final_step"] != TRAIN_TP_STEPS or not finite
                or rel_l > TRAIN_TP_LOSS_REL or rel_n > TRAIN_TP_NORM_REL):
            failed.append(f"rank {r}: {TRAIN_TP_STEPS} finite steps, step "
                          f"1's loss {rel_l:.3e} and grad norm {rel_n:.3e} "
                          "relative to tp=1's")
        if (len(out["steps"]) != TRAIN_TP_STEPS
                or any(st != want for st in out["steps"])
                or any(c != coll_want for c in out["collectives"])):
            failed.append(f"rank {r}: launches {out['steps']}, "
                          f"collectives {out['collectives']}")
        for i, posted in enumerate(out["by_op"]):
            if not _mesh_gate("mesh train tp (a)", posted):
                failed.append(f"rank {r} step {i + 1}: collectives by op "
                              f"{posted} differ from the dry count")
    if any(out["summary"]["loss_curve"] != ranks[0]["summary"]["loss_curve"]
           for out in ranks):
        failed.append("the ranks' losses differ")
    if failed:
        raise SystemExit("[train tp] " + "; ".join(failed))
    _free()
    shapes = collections.Counter(ranks[0]["shapes"])
    entries = _train_shapes(dev, shapes, TRAIN_TP_STEPS, tag="train tp (b)",
                            splits=collections.Counter(ranks[0]["splits"]))
    t_c = time.perf_counter()
    checked = {tuple(key) for key in shapes}
    checked_splits = {tuple(key) for key in ranks[0]["splits"]}
    launched += _tp_family_gates(dev, families, checked, checked_splits)
    t_d = time.perf_counter()
    for _, _, _, _, _, fam in families:
        for out in fam:
            checked |= {tuple(key) for key in out["shapes"]}
            checked_splits |= {tuple(key) for key in out["splits"]}
    launched += _fsdp_gates(dev, *fsdp, checked, checked_splits)
    for out in fsdp[1]:
        checked |= {tuple(key) for key in out["shapes"]}
        checked_splits |= {tuple(key) for key in out["splits"]}
    t_e = time.perf_counter()
    # (e) and (f): each shape new to the phase held to the plain version
    more, new, new_splits = _sp_gates(sp, ranks, checked, checked_splits)
    launched += more
    more, new_f, splits_f = _ep_gates(*ep, checked | new,
                                      checked_splits | new_splits)
    launched += more
    _check_train_shapes(dev, new | new_f, new_splits | splits_f,
                        "train sp (e), ep (f)")
    _say(f"[train tp] phase 18 in {time.perf_counter() - t0:.1f} s (ranks "
         f"and pool start (a) {times['a']:.1f} s, (e) SP {times['e']:.1f} "
         f"s, (c)'s four families {times['c'] + t_d - t_c:.1f} s with "
         f"their shard GEMM checks, (d) FSDP {times['d'] + t_e - t_d:.1f} s "
         f"with its GEMM checks, (f) experts over data {times['f']:.1f} s; "
         f"(e) and (f)'s {len(new | new_f)} new GEMM shapes checked in "
         f"{time.perf_counter() - t_e:.1f} s) on {_nvidia_smi()}; two ranks "
         f"on one card (tp={TP_RANKS} or data={TP_RANKS}) give no "
         "multi-card speed figure")
    return {"launches": launched, "entries": entries}


def _merge_entries(groups: list) -> dict:
    """Per-path JSON entries summed over `groups` (each phase 5's form):
    times and bounds added, the bound's kind from the summed operations and
    bytes parts, the largest error."""
    out: dict = {}
    for group in groups:
        for path, e in group.items():
            t = out.setdefault(path, {})
            for key in ("ms", "v3_ms", "plain_ms", "bound_ms", "library_ms",
                        "ops_ms", "bytes_ms"):
                # None (no yardstick for this kernel) stays None
                t[key] = (None if e[key] is None or (
                    key in t and t[key] is None) else t.get(key, 0.0) + e[key])
            t["max_abs_err"] = max(t.get("max_abs_err", 0.0),
                                   e["max_abs_err"])
            t["launches"] = t.get("launches", 0) + e.get("launches", 0)
    return {path: {"ms": t["ms"], "v3_ms": t["v3_ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": ("operations" if t["ops_ms"] > t["bytes_ms"]
                                else "bytes"),
                   "library_ms": t["library_ms"],
                   "max_abs_err": t["max_abs_err"],
                   **({"launches": t["launches"]} if t["launches"] else {})}
            for path, t in out.items()}


SHAPES_FILE = ROOT / "build" / "serving_shapes.json"


def _write_shapes(by_model: dict) -> None:
    """Write each model's serving launches by shape ((M, N, K, in dtype, out
    dtype) and count) to `SHAPES_FILE`, for `tools/gemm_sums.py` to time
    the same launches with another checkout's kernel."""
    out = {model: [[m, n, k, str(i).split(".")[-1], str(o).split(".")[-1], c]
                   for (m, n, k, i, o, _), c in sorted(
                       shapes.items(), key=lambda kv: kv[0][:3])]
           for model, shapes in by_model.items()}
    SHAPES_FILE.parent.mkdir(parents=True, exist_ok=True)
    SHAPES_FILE.write_text(json.dumps(out))


def main() -> int:
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _nvidia_smi()
    _say(f"[card] {smi}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
         f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    phase_kernel_cases(dev)
    eng, api, params, cfg, shapes, by_path, streams = phase_serve(dev)
    # after phase 4, whose tokens/s is the host's yardstick
    ahead = _analyse_ahead(dev)
    entries = phase_serving_shapes(dev, shapes)
    untraced = phase_forwards(dev, eng, params, cfg)
    phase_logits(dev, eng, params, cfg)
    loop = phase_loop(dev, api, params, cfg, shapes, untraced)
    phase_energy(dev, api, params, cfg, shapes, *loop)
    fleet = phase_fleet(dev, api, params, cfg)
    del eng, params, loop
    _free()
    tp = phase_tp(streams)
    dense = phase_dense(dev)
    _write_shapes({"qwen2-7b": shapes, **dense["shapes"]})
    moe = phase_moe(dev)
    ssm = phase_ssm(dev)
    tp_families = phase_tp_families({**moe["streams"], **ssm["streams"]})
    t_join = time.perf_counter()
    ahead.join()
    _say(f"[dry-run] phases 15 (e) and 16 (d)'s analyses and the mesh dry "
         f"counts made in a process of their own from phase 5 on: "
         f"{sorted(k for k in _DRY_AHEAD if ' failed' not in k)}, "
         f"waited {time.perf_counter() - t_join:.1f} s after it; failed "
         f"{ {k: v for k, v in _DRY_AHEAD.items() if ' failed' in k} }")
    phase_tp_mesh()
    admit = phase_admit(dev)
    train = phase_train(dev)
    families = phase_families(dev)
    _free()
    train_tp = phase_train_tp(dev, train["summary"])
    _say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    _say(_nvidia_smi())
    # one entry per kernel of the main paths' runs: qwen2-7b (phases 4-5),
    # the SSM and hybrid models (phase 12), the encoder-decoder and vision
    # models (phase 13), the fleets (phase 14), tensor-parallel serving's
    # ranks (phase 17) and training (phases 15 (a), 16 (a) and 18): the GEMM's
    # stream, wgmma and split-pair paths and the
    # split pair's split kernel. No launch of those runs takes the general
    # path (every phase checks 0 there): it is the first version of the
    # kernel, and each GEMM entry's v3_ms times it at the same shapes
    launched = sum([*ssm["launches"].values(), *admit["launches"].values(),
                    fleet["launches"], tp["launches"],
                    tp_families["launches"], train["launches"],
                    families["launches"], train_tp["launches"]],
                   collections.Counter(by_path))
    merged = _merge_entries([entries, *ssm["entries"].values(),
                             *admit["entries"].values(), fleet["entries"],
                             train["entries"], *families["entries"],
                             train_tp["entries"]])
    if launched["general"]:
        raise SystemExit(f"{launched['general']} main-path launches took "
                         "the general path")
    kernels = [("tiled_matmul[stream]", "stream", "tiled_matmul.cu"),
               ("tiled_matmul[wgmma]", "wgmma", "tiled_matmul.cuh"),
               ("tiled_matmul[split]", "split", "tiled_matmul.cuh"),
               ("split3", "split3", "tiled_matmul.cu")]
    tr = merged.get("wgmma transposed")
    if tr:
        # wgmma's launches on the transposed layouts (training's backward, a
        # tied head's forward), inside the wgmma entry below
        _say(f"[kernels] wgmma on the transposed layouts: {tr['launches']} "
             f"of the {launched['wgmma']} launches, kernel {tr['ms']:.2f} "
             f"ms, bound {tr['bound_ms']:.2f} ms, plain {tr['plain_ms']:.2f} "
             f"ms, torch.matmul {tr['library_ms']:.2f} ms, general path "
             f"{tr['v3_ms']:.2f} ms; on nn the rest, kernel "
             f"{merged['wgmma']['ms'] - tr['ms']:.2f} ms, bound "
             f"{merged['wgmma']['bound_ms'] - tr['bound_ms']:.2f} ms, plain "
             f"{merged['wgmma']['plain_ms'] - tr['plain_ms']:.2f} ms, "
             f"torch.matmul "
             f"{merged['wgmma']['library_ms'] - tr['library_ms']:.2f} ms")
    _say(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{source}",
        "replaces": "src/repro/kernels/tiled_matmul.py:57",
        "launches": launched[key], **merged[key]}
        for name, key, source in kernels]}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
