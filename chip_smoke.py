#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each timed, any failure exits non-zero:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. hold each FC kernel against its plain PyTorch version on the card, at
     both PointNet++(c) block shapes, batched (B=8) and at B=1, masked and
     unmasked, and hub_reuse also at the other families' widest blocks
     (``REUSE_WIDE``) and past one launch's 128 cache rows
     (``REUSE_C256``, timed: two 128-row resident launches, whose grid
     fills the card): ``max|Δ| <= 1e-4 · max(1, max|plain|)``,
     the -BIG identity exactly;
  3. time each FC kernel and its plain version in turns at the main path's
     shapes;
  4. serve: ``repro_torch.serve.PCNServer`` over
     ``PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")`` in (8, 512)
     and (8, 1024) buckets replays a 48-request ``synthetic_trace``
     (Poisson arrivals at 30 req/s, log-normal sizes, median 768, clipped
     to 512–1024) three times: async (4 batches in flight), sync, and under
     the chaos plan ``fail@1,nan@3`` with the "reference" fallback.  Each
     run checks every request answered exactly once, the launch counts of
     the run (2 per dispatch that reached the kernels, 0 for the entry
     kernels), no degraded dispatch when healthy and exactly 2 under chaos,
     every response against ``apply_single`` on its own cloud and key (the
     degraded ones against the "reference" backend's); then the CLI,
     ``python -m repro_torch.launch.serve --arch pointnet2_c --trace 16``,
     in a subprocess; and one (8, 1024) batch against the "reference"
     backend;
  5. one batch in ``mode="traditional"``; one lpcn batch at
     ``cache_capacity_x = 4`` (``CACHE_X4``: 256 cache rows at block 2,
     the launches each call's plan makes) against the "reference" backend, and
     pointnext_s and pointvector_l (``CACHE_X4_FAMILIES``) likewise at the
     families phase's batch (every hub_reuse launch in the one-layer
     form; pointvector_l's block 4: C = 128 rows of D = 387 too wide for a
     resident block, layered; one launch a call); then the
     same batch under each data structuring of ``DS_VARIANTS`` (the
     paper's DS baselines HgPCN, EdgePC and Crescent beside PointACC's,
     the ball query, the random and Morton samplers, FPS hubs): one
     gather_mlp and one hub_reuse launch a block, logits against the
     "reference" backend, stage 1 and the workload reports
     (``apply_with_reports``) equal on the card and on the CPU, the stages
     timed and the reports' fetch and compute savings printed; then the
     plans phase (``plans_phase``): pointnet2_c's FC cells at B = 8 and
     B = 2 (``autotune.model_cells``), equal to the calls of the counted
     forwards, each tuned into a store of the smoke's own
     (``build/tile_plans_smoke.json``; every candidate timed, tiling.py's
     shared memory equal to the library's, every output within 1e-4 of
     the heuristic plan's), the forward under that store and under each
     forced knob (``PLAN_FORCED``) against the heuristic's logits with
     the launches the plans say, ``fc_backend="cuda_per_cloud"`` against
     ``"cuda"`` (one launch a cloud), Mesorasi's delayed aggregation on
     block 1's structure card vs CPU (1e-5) beside PointACC's counters,
     and the serving CLI under ``--kernel-kw`` (``PLAN_CLI``); every
     other phase runs with an empty tile-plan store;
  6. families: each other model of ``repro_torch.models.MODEL_ZOO`` at
     full width (``FAMILIES``: pointnet2_ps 4 × 2048, pointnet2_s 2 ×
     4096, dgcnn_c 8 × 1024, dgcnn_s 1 × 8192, pointnext_s and
     pointvector_l 2 × 4096), one ragged lpcn batch each through
     ``fc_backend="cuda"`` with the launch counts reset (one gather_mlp
     and one hub_reuse launch a block; gather_mlp's launches by route
     equal to the routes of the engine's lowering: ``linear`` at every
     block of the one-layer families dgcnn_c, dgcnn_s, pointnext_s and
     pointvector_l, ``narrow`` at PointNet++'s, ``wide`` at none;
     hub_reuse's by form likewise: one layer at every block of those
     four, two at PointNet++'s), every
     logit against the "reference" backend, seg padding rows exactly 0,
     the stages timed; dgcnn_c's stage 1 on the card against the CPU at
     its families batch (the ``all`` sampler and DGCNN's islands, every
     integer field equal); dgcnn_c once in traditional mode (4
     ``linear`` launches); hub_reuse's one-layer form at
     ``REUSE_LINEAR`` (the families' calls at their batches and
     pointvector_l's block 4 under ``CACHE_X4``, layered) against its plain
     version, timed beside it and beside the same block in the split-sign
     two-layer form, its route, chunk, scratch and shared memory equal in
     wrapper and library, the rule that sends a resident call to the
     3xTF32 ``wgmma`` kernel (2^28 multiply-adds and more) and that
     kernel's plan (rows and islands a tile, N, items, stages, x by TMA
     or cp.async) equal in tiling.py and library, its W split into TF32
     halves bit-equal to ``split_weights_ref`` and timed, its W splits in
     the families phase one a wgmma call, its kernels'
     (``hub_reuse_linear_sass``) ptxas spills (0), TF32 HGMMA (nonzero)
     and TF32 HMMA (0), and the mma.sync one-layer kernels'
     (``linear_sass``) spills (0) and TF32 HMMA (nonzero); gather_mlp's
     linear route
     (3xTF32 ``wgmma``) against its plain
     version and timed at ``DENSE_LINEAR`` (the six blocks the wide
     route took before it, one narrow one-layer block and D = 700), its
     row tile, shared memory and plan (ring stages, columns a block, x
     by TMA or cp.async, scratch) equal in wrapper and library, and its
     first kernel, W's split into TF32 halves, bit-equal to
     ``split_weights_ref`` and timed; the
     two-layer wide route, which no published spec takes since, driven
     once with the launch counts reset and held and timed alike at
     ``DENSE_WIDE`` and ``WIDE_D`` (the split-sign two-layer form), its
     plan (grid, layer-1 recompute) equal in wrapper and library;
     the CLI on a seg model (``SEG_CLI``: pointnext_s, 8 requests);
  7. entry kernels: drive ``knn`` (stage 1 of the first batch, both
     blocks, every cloud; block 1 again at k = 96 and 300; dgcnn_s's kNN,
     one 8192-point cloud against itself, k = 20), ``flash_attention`` (a
     Qwen2-72B layer, bf16 on the ``wgmma`` route; the same bf16 at an
     address off 16 bytes and f32 on the ``mma`` one) and ``ssd_chunk``
     (Mamba2-2.7B at chunks of 64 and 128) once at full width with the
     launch counts reset (exactly one launch a call), then hold each
     output and the parity cases (knn on integer grids, where the order
     of ties must equal the plain version's; flash at head_dim 256;
     ssd_chunk with ragged P, S and head tiles) against the plain
     versions (flash: max |Δ| and ‖Δ‖/‖plain‖) and time all three: knn
     also by its kernel time (``device_ms``, torch.profiler), flash also
     at a gemma_7b layer (head_dim 256) in f32 and bf16;
  8. LM (``lm_phase``): the port's LM serving side at full width from
     seeded weights.  olmo-1b and mamba2-2.7b prefill B = 2 × 2048 through
     ``steps.make_prefill_step`` with the launch counts reset (exactly
     16 ``flash_attention`` / 64 ``ssd_chunk`` launches, nothing else), in
     float32 and in bfloat16, against the same prefill with the kernels'
     plain versions routed in (``LM_MAIN``'s limits); a 32-token prompt
     through ``make_cache`` / ``make_decode_step`` (olmo-1b's logits
     against the forward's) and 16 greedy tokens, timed; the kernels at
     the inputs those prefills gave them, held and timed.  Every other
     config once (``LM_ONCE``; qwen2-72b, llama4-maverick and grok-1 at 2
     layers): a counted prefill, decode steps (no launch), finite logits.
     Then ``python -m repro_torch.launch.serve --arch olmo-1b ...`` in a
     subprocess;
  9. train (``train_phase``): ``flash_attention``'s backward kernel
     (``csrc/flash_attention_bwd.cu``, built with the others; two
     launches a call, the dQ pass and the dK/dV pass, both counted, per
     route too: ``wgmma`` for aligned bf16 at D <= 128, else ``mma``)
     given the forward's log-sum-exp, held against ``attention_bwd_ref``
     and timed beside the plain version and SDPA's backward (which reuses
     its own saved log-sum-exp) (``BWD_LAYERS``: olmo-1b's layer in bf16
     and f32, Qwen2-72B's, Whisper-large-v3's encoder, gemma-7b's in f32;
     ``BWD_TOL``; two calls bit-equal, and bit-equal to the call that
     leaves the log-sum-exp to the wrapper); ``ssd_chunk``'s backward kernel
     (``csrc/ssd_chunk_bwd.cu``; two launches a call, the heads pass and
     the chunk pass) held against ``ssd_chunk_bwd_ref`` and autograd of
     ``ssd_chunk_ref`` and timed beside the plain version
     (``SSD_BWD_LAYERS``: Mamba2-2.7B's layer at chunks of 64 and 128 and
     at the trainer's microbatch; ``SSD_BWD_TOL``; two calls bit-equal;
     the ``SSD_PARITY`` shapes and a steep decay held too); olmo-1b and
     mamba2-2.7b at full width cut to 2 layers in f32, every leaf's
     gradient through the kernels against the plain route's, each held to
     its own size (``WIRING_TOL``), and a planted detached attention /
     SSD that must fail that check (``WIRING_PLANTED``).  Then, in a
     subprocess that carries ``TRAIN_ENV`` (``--trainer-runs``):
     ``repro_torch.launch.train.main`` on olmo-1b and on mamba2-2.7b as
     published, 4 × 2048 tokens in 2 microbatches, 8 steps
     (``TRAIN_MAIN``), each with the launch counts reset (the forward and
     backward kernels' launches must equal ``model_zoo.train_launches``
     a step; olmo-1b's backward all on ``wgmma``), every loss finite,
     step time and tokens/s over the window after the first two steps,
     the bound (the forward and backward;
     remat's recompute beside it) and peak memory; the resume check of
     each at 2 layers (``TRAIN_RESUME``: 6 steps straight against 3 + 3
     with a restart from the checkpoint, losses within ``RESUME_TOL``);
     every other config at its reduced config for 2 steps
     (``TRAIN_OTHERS``).  In a world of one these runs have no mesh.
 10. the mesh (``repro_torch.launch.mesh``, ``repro_torch.dist``) under a
     world of one on the card: the main (8, 1024) batch through
     ``PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda",
     mesh=data_mesh(1))`` bit-equal to the mesh-free forward with the
     same launches, both timed in turns; the serving CLI with
     ``--mesh-data 1`` answering every request; in the ``--trainer-runs``
     subprocess, after phase 9's runs, olmo-1b as published (``MESH_TRAIN``:
     4 × 2048 tokens in 2 microbatches, 4 steps) under ``local_mesh()``
     (handed to ``launch.train.main``: the CLI runs a world of one
     without a mesh),
     its losses and grad norms bit-equal to phase 9's mesh-free run, its
     flash launches ``train_launches`` a step, its step time beside the
     mesh-free run's, and mamba2-2.7b at 2 layers (``MESH_SSM``) under
     the mesh and without, losses and grad norms bit-equal, the same
     launches; ``--production-mesh`` exiting non-zero with the world
     size it needs.  A ``mesh`` line (and a ``mesh_train`` line from the
     subprocess) beside the card's name and power limit.
 11. LM serving under a mesh and the planning tools: ``launch.serve.serve_lm``
     (``SERVE_MESH``: batch 4, a prompt of 16 teacher-forced through
     decode, 32 greedy tokens, a cache of 2048) on olmo-1b and mamba2-2.7b
     as published, and recurrentgemma-2b, whisper-large-v3 and
     llama4-maverick cut to 2 layers, each without a mesh and under a
     ``local_mesh()`` handed in (params laid out by ``param_shardings``,
     caches by ``cache_shardings`` as DTensors), the same seeded params:
     the tokens bit-equal, the last step's logits equal, the same launches
     (none; Whisper's encoder's flash_attention in ``make_cache``), decode
     ms a token under the mesh beside mesh-free (a ``serve_mesh`` line
     each); then ``python -m repro_torch.launch.memreport`` and ``python -m
     repro_torch.launch.dryrun --arch olmo-1b --shape train_4k`` on the
     fake 256-rank world, each in a subprocess, their lines logged, the
     dry run's per-device flops × 256 over the mesh-free count of the same
     step, and ``memmodel`` of phase 9's olmo-1b step on a one-device mesh
     beside phase 9's measured peak (a ``planning`` line).
 12. the static analysis (``repro_torch.analysis``): ``python -m
     repro_torch.analysis --strict --device cuda`` in a subprocess, which
     runs the matrix (four families x two modes x the ``reference`` and
     ``cuda`` FC backends at N = 96, the serving partial batch, the
     one-rank sharded engine, the three entry kernels) on the CPU and on
     the card and lints the kernel launches (K001–K005), the graphs
     (M001), the operands (R001–R003), the plan caches (R004, both
     devices) and the source (A001–A005); the run fails on an unsuppressed
     error, on a card site that differs from its CPU-derived twin, on a
     site whose shared memory by ``tiling.py`` or the analysis's copies
     of the entry kernels' formulas differs from the built library's, and
     on a family, an lpcn ``cuda`` target's FC kernel or
     an entry kernel without sites, and on hub_reuse's ``layered``,
     ssd_chunk's ``tiled`` or flash's ``split`` route without sites.  An
     ``analysis`` line (targets, sites by kernel and family, findings,
     wall time) beside the card's name and power limit.
 13. PCN training and the paper's Fig. 20 accuracy run
     (``repro_torch.examples.accuracy``): (a) ``run_accuracy()`` at full
     size (160 train / 64 test clouds of 256 points, 10 epochs of SGD at
     batch 16 through the "reference" FC backend under autograd, at both
     activation placements; each evaluation under ``no_grad`` through
     the "cuda" backend) with the launch counts reset: no launch in
     training, ``PCN_EVAL_LAUNCHES`` a forward (gather_mlp 2, and
     hub_reuse 2 in lpcn); (b) the quick run on the card against the
     same run on the CPU, each step's loss within ``PCN_LOSS_RTOL``
     relative and the same prediction on every test cloud whose CPU
     top-two margin is >= ``PCN_MARGIN``; (c) the trained weights'
     logits through "cuda" against "reference" on the card (1e-4 ·
     max(1, max|ref|)) in every mode, each forward's launches counted;
     (d) gather_mlp, hub_reuse and knn under autograd on the card raise
     ``NoBackwardError`` naming how PCN training gets its gradient, and
     launch nothing; (e) the four examples (``PCN_EXAMPLES``:
     quickstart, islandization_demo, lm_decode, train_pointnet2 at 50
     steps) in subprocesses side by side, each exiting 0.  Rehearsed on
     the CPU: stub ``torch.cuda.synchronize`` and ``chip_smoke.check``
     (collect), set ``PCN_FULL_QUICK = True`` and ``EXAMPLE_ARGS =
     ("--device", "cpu")``, then ``pcn_train_phase(torch.device("cpu"),
     "cpu")`` (~40 s; only the launch and refusal checks fail).
 14. the kernels' domain routes, past the limits the earlier routes had
     (``domain_phase``): each driven once with the launch counts reset
     (``domain_drive``: by wrapper and by route), then held against its
     plain version and timed beside it: hub_reuse at ``REUSE_DOMAIN``
     (two layers: pointvector_l's block 4 under ``CACHE_X4`` in the
     split-sign form, which no published spec's block reaches since the
     one-layer form, and D = 700, both on the layered route; route, H
     splits, scratch and shared memory equal to the library's), ssd_chunk and its backward on the tiled route at
     ``SSD_TILED`` (Mamba2-2.7B's widths at chunk 256, bs 1 and 2;
     ``ssd_held``, ``ssd_bwd_held``; the plans equal to the analysis's
     formula, each row with the TF32 HMMA count of the tiled kernels,
     which must be nonzero, and the backward's device time by pass),
     flash_attention and its backward on
     the split route at ``FLASH_SPLIT`` (8 heads, S = 2048, causal, D =
     512 in f32 and bf16, D = 257 in bf16; ``FLASH_TOL``, ``BWD_TOL``,
     SDPA timed beside each; each row with the library's cluster and
     slice, its share of bound and the HMMA count of flash_split.cuh's
     kernels, which must be nonzero), past 8 blocks of 128 columns in the
     dK/dV pass at ``FLASH_SPLIT_WIDE`` (the same layer at D = 1040, f32
     and bf16) and past 8 slices of 256 at ``FLASH_SPLIT_STREAM`` (D =
     2056 at ``FLASH_STREAM_LAYER``, 512 tokens: the streamed kernels, in
     sweeps), held and timed alike; then mamba2-2.7b at full width with
     ``ssd_chunk`` = 256: a counted f32 prefill of 2 × 2048 (64 tiled
     launches) against the plain route (``LM_F32_TOL``), and the 2-layer
     gradient wiring (``grad_wiring``, its planted fault included).
     Rehearsed on the CPU as phase 9, with ``REUSE_DOMAIN``,
     ``SSD_TILED``, ``FLASH_SPLIT*``, ``LM_PREFILL`` and ``TRAIN_WIRING``
     shrunk, the libraries' plan queries stubbed by the formulas and the
     reduced configs (~5 s; only the launch checks fail).

Output lines: the card's name and power limit (nvidia-smi), phase times,
ptxas's registers and spills per kernel (gather_mlp, hub_reuse,
ssd_chunk, ssd_chunk_bwd and flash_attention_bwd must not spill), the
counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in the built
flash_attention and flash_attention_bwd libraries and of TF32 HMMA
instructions in the gather_mlp, hub_reuse, ssd_chunk, ssd_chunk_bwd and
flash_attention_bwd ones, ``gather_mlp_linear_sass`` (each of gather_mlp's
linear kernels: registers, spills (0), TF32 HGMMA (nonzero) and TF32
HMMA (0)),
``parity``,
``per_cloud`` and ``entry_parity``
JSON lines, the serving reports (``serve_async``, ``serve_sync``,
``serve_chaos``, each beside the card's name and power limit) and the
CLI's lines, the lpcn forward's stage times (``--profile`` adds a
torch.profiler trace of one forward), stage 1 on the card against the
CPU, a ``ds_variant`` line per data structuring (beside the card's name
and power limit), ``plan_cells``, a ``plan_cell`` line per tuned cell
(each candidate's ms, its difference from the heuristic plan's output and
bit-equality, shared memory by tiling.py and by the library; the
heuristic's, the per-cloud and the winner's ms; beside the card's name
and power limit), ``plan_forward`` lines and ``mesorasi``, a ``family``
line per model, ``family_structure_card_vs_cpu``, ``wide_parity`` and
``linear_parity``, ``reuse_linear_parity``, ``hub_reuse_linear_sass``,
an ``lm`` line
per LM config (its routes, launches, prefill and decode times, beside the
card's name and power limit), ``lm_parity``, a ``bwd_kernel`` line per
backward layer (flash_attention's and ssd_chunk's), a ``train_wiring``
line per config, a ``train`` line per full-width run (beside the card's
name and power limit), a ``train_resume`` line per config, a
``train_other`` line per config, the
trainer's own lines (``train: step N: ...``), ``train_parity``, the
``mesh``, ``mesh_train``, ``serve_mesh``, ``planning`` and ``analysis``
lines, ``pcn_train`` (beside the card's name and power limit: steps,
mean step ms from step 3, first and last loss, the 2 × 4 accuracy table,
launches, seconds), ``pcn_card_vs_cpu``, ``pcn_kernels_vs_plain``,
``pcn_grad_refusal``, the examples' lines (``example <name>: ...``) and
``pcn_examples_s``, a ``kernels`` JSON
line (every TPU kernel's counterpart: the FC kernels batched and per
cloud, gather_mlp's wide and linear routes, hub_reuse's one-layer form,
the entry kernels, and
flash_attention and ssd_chunk at the LM prefills' inputs; ``launches``
counted per wrapper, in the async serving run for the FC kernels, over
the families phase's counted forwards for the linear route, in the wide
route's own drive for its rows (``families_launches`` beside: 0, no
published spec takes it), over the families phase's counted forwards
for the linear route's W split (``split_weights``, one a linear
launch), in the entry phase for the
entry kernels' rows (``lm_launches`` beside them: the LM phase's counted
prefills), in the LM phase for its rows, in the full-width training
runs for ``flash_attention_bwd``'s and ``ssd_chunk_bwd``'s, and in phase
14's drive for the domain routes' rows (``route_launches`` beside: the
route's own count), over the families phase's counted forwards for
hub_reuse's one-layer rows (their route's one-layer count; phase 5's
pointvector_l forward for its block 4 under ``CACHE_X4``; the wgmma
kernel's own count, ``hub_reuse_linear_wgmma``, on its rows) and over
the families phase's counted forwards for their W splits
(``hub_reuse_split_weights``, one a wgmma call);
``pcn_train_launches`` beside the FC rows: phase 13's full-size run),
and last
``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import HW  # noqa: E402

TOL = 1e-4
BIG = 3.4e38
# H100 SXM published peaks (NVIDIA data sheet, repro_torch.HW): fp32
# outside the tensor cores, dense bf16 and TF32 on the tensor cores, and
# HBM3 bandwidth
PEAK_FP32 = HW["peak_fp32_flops"]
PEAK_BF16 = HW["peak_bf16_flops"]
PEAK_TF32 = HW["peak_tf32_flops"]
PEAK_BYTES = HW["hbm_bw"]
B, N_PAD = 8, 1024

# (name, shape) of each kernel call on the pointnet2_c main path, masked as
# the path calls it: block 1 sees the batch's n_valid, block 2 FPS centers
DENSE = {"blk1": dict(s=512, k=32, d=65, dc=1, h=64, f=128, masked=True),
         "blk2": dict(s=128, k=64, d=129, dc=1, h=128, f=256, masked=False)}
REUSE = {"blk1": dict(hn=16, c=64, m=64, k=32, d=64, h=64, f=128),
         "blk2": dict(hn=4, c=128, m=64, k=64, d=128, h=128, f=256)}
# hub_reuse past one launch's 128 cache rows: pointnet2_c block 2 at the
# paper's Fig. 22 cache size, cache_capacity_x = 4 (C = 4k = 256), at B =
# 8 (two 128-row resident launches: their grid fills the card)
REUSE_C256 = {"blk2_c256": dict(hn=4, c=256, m=64, k=64, d=128, h=128,
                                f=256)}
# the lpcn forward at that cache size, against the "reference" backend
CACHE_X4 = {"cache_capacity_x": 4.0}
# the ds_variants phase: pointnet2_c's forward under each data structuring
# the paper measures the Islandization Unit on (Fig. 16: PointACC, the
# main path's, then HgPCN, EdgePC, Crescent), PointNet++'s own ball query
# (its blocks' radii 0.2 / 0.4), the random sampler of the approximate
# baselines, the FractalCloud setting of the JAX package's benchmarks
# (Morton sampler + EdgePC) and hub selection by FPS:
# name -> (sampler, neighbor, isl_kw)
DS_VARIANTS = {"pointacc": ("fps", "pointacc", {}),
               "hgpcn": ("fps", "hgpcn", {}),
               "edgepc": ("fps", "edgepc", {}),
               "crescent": ("fps", "crescent", {}),
               "ball": ("fps", "ball", {}),
               "random": ("random", "pointacc", {}),
               "fractal": ("morton", "edgepc", {}),
               "fps_hubs": ("fps", "pointacc", {"hub_select": "fps"})}
# parity only, at B = 2: hub_reuse's two-layer form at the other
# families' widest blocks in the split-sign form (two_layer_form: Hd =
# 2F), which the engine lowered them to before the one-layer form; no
# published spec's block reaches these widths now (REUSE_LINEAR below
# holds the calls the engine makes there)
REUSE_WIDE = {
    "pointnext_s_blk4": dict(hn=4, c=64, m=16, k=32, d=259, h=1024, f=512),
    "pointvector_l_blk3": dict(hn=4, c=64, m=16, k=32, d=195, h=768, f=384),
    "pointvector_l_blk4": dict(hn=4, c=64, m=16, k=32, d=387, h=1536,
                               f=768),
    "dgcnn_c_blk4": dict(hn=4, c=40, m=16, k=32, d=256, h=512, f=256)}
# the families phase: every other model of the zoo at full width (the
# spec as published), one ragged padded lpcn batch each, (B, N points a
# cloud): ShapeNet part clouds of 2048 points, S3DIS blocks of 4096
# (dgcnn_s: its own 8192), ModelNet40 objects of 1024 as the main path
FAMILIES = {"pointnet2_ps": (4, 2048), "pointnet2_s": (2, 4096),
            "dgcnn_c": (8, 1024), "dgcnn_s": (1, 8192),
            "pointnext_s": (2, 4096), "pointvector_l": (2, 4096)}
SCENES = ("pointnet2_s", "dgcnn_s", "pointnext_s", "pointvector_l")
# gather_mlp's wide route (h in chunks) at the six blocks that take it, at
# the families phase's batches, masked as the path calls them (DGCNN's
# every block sees n_valid, the SA stacks' deeper blocks FPS centers)
DENSE_WIDE = {
    "dgcnn_c_blk4": dict(b=8, s=1024, k=20, d=256, dc=256, h=512, f=256,
                         masked=True),
    "pointnext_s_blk3": dict(b=2, s=128, k=32, d=131, dc=3, h=512, f=256,
                             masked=False),
    "pointnext_s_blk4": dict(b=2, s=32, k=32, d=259, dc=3, h=1024, f=512,
                             masked=False),
    "pointvector_l_blk2": dict(b=2, s=512, k=32, d=99, dc=3, h=384, f=192,
                               masked=False),
    "pointvector_l_blk3": dict(b=2, s=128, k=32, d=195, dc=3, h=768, f=384,
                               masked=False),
    "pointvector_l_blk4": dict(b=2, s=32, k=32, d=387, dc=3, h=1536, f=768,
                               masked=False)}
# the wide route at a D past the PR 18 route's limit (x of a 64-row tile
# alone over 227 KB at D above ~600): x streams through the ring in slices
WIDE_D = {"d700": dict(b=2, s=128, k=32, d=700, dc=3, h=1024, f=512,
                       masked=False)}
# hub_reuse's one-layer form (h = 0: y = x·W + b, the engine's lowering
# of every one-layer point-MLP) at the calls the families phase makes,
# with its batches (dgcnn_s: 8192 points, 256 islands; its blocks 2 and 3
# share a shape), and pointvector_l's block 4 under CACHE_X4 (C = 128
# rows of D = 387 pass a resident block: layered)
REUSE_LINEAR = {
    "dgcnn_c_blk1": dict(b=8, hn=32, c=40, m=64, k=20, d=6, f=64),
    "dgcnn_c_blk2": dict(b=8, hn=32, c=40, m=64, k=20, d=128, f=64),
    "dgcnn_c_blk3": dict(b=8, hn=32, c=40, m=64, k=20, d=128, f=128),
    "dgcnn_c_blk4": dict(b=8, hn=32, c=40, m=64, k=20, d=256, f=256),
    "dgcnn_s_blk1": dict(b=1, hn=256, c=40, m=64, k=20, d=12, f=64),
    "dgcnn_s_blk2": dict(b=1, hn=256, c=40, m=64, k=20, d=128, f=64),
    "pointnext_s_blk1": dict(b=2, hn=64, c=64, m=64, k=32, d=35, f=64),
    "pointnext_s_blk2": dict(b=2, hn=16, c=64, m=64, k=32, d=67, f=128),
    "pointnext_s_blk3": dict(b=2, hn=4, c=64, m=64, k=32, d=131, f=256),
    "pointnext_s_blk4": dict(b=2, hn=1, c=64, m=64, k=32, d=259, f=512),
    "pointvector_l_blk1": dict(b=2, hn=64, c=64, m=64, k=32, d=67, f=96),
    "pointvector_l_blk2": dict(b=2, hn=16, c=64, m=64, k=32, d=99, f=192),
    "pointvector_l_blk3": dict(b=2, hn=4, c=64, m=64, k=32, d=195, f=384),
    "pointvector_l_blk4": dict(b=2, hn=1, c=64, m=64, k=32, d=387, f=768),
    "pointvector_l_blk4_c128": dict(b=2, hn=1, c=128, m=64, k=32, d=387,
                                    f=768)}
# gather_mlp's linear route (h = 0: one layer, the engine's lowering of
# every one-layer point-MLP): the six DENSE_WIDE blocks as the engine
# launches them since the route exists, one narrow one-layer block
# (dgcnn_c block 2: 1024 subsets of 20 a cloud, D = 128, F = 64) and
# WIDE_D's widths; the two-layer DENSE_WIDE and WIDE_D above keep the
# wide route's rows at the split-sign form those blocks had before
DENSE_LINEAR = {
    **{blk: dict(shp, h=0) for blk, shp in DENSE_WIDE.items()},
    "dgcnn_c_blk2": dict(b=8, s=1024, k=20, d=128, dc=128, h=0, f=64,
                         masked=True),
    "d700": dict(WIDE_D["d700"], h=0)}
# the CLI on a seg model: 8 S3DIS-sized requests in buckets up to 4096
SEG_CLI = ("--arch", "pointnext_s", "--trace", "8", "--buckets",
           "2048,4096", "--points", "3500", "--size-sigma", "0.1",
           "--batch", "2", "--timeout-ms", "50")
# the plans phase: pointnet2_c's FC cells at the serving buckets' batch
# sizes (the main batch's 8, and 2), tuned into a store of the smoke's own
# under build/; the knobs forced engine-wide, one value at a time; and the
# serving CLI under --kernel-kw (pointnet2_c's blocks take the narrow
# route, so rows and chunk are the knobs that act on them)
PLAN_BATCHES = (B, 2)
PLAN_FORCED = ({"rows": 64}, {"rows": 128}, {"chunk": 64}, {"chunk": 128})
PLAN_CLI_KW = {"rows": 64, "chunk": 64}
PLAN_CLI = ("--arch", "pointnet2_c", "--trace", "8", "--kernel-kw",
            json.dumps(PLAN_CLI_KW))
# a Qwen2-72B attention layer (src/repro/configs/qwen2_72b.py: 64 query
# heads, 8 kv heads, head_dim 128) over a 2048-token prefill
QWEN2_72B = dict(b=1, hq=64, hkv=8, s=2048, d=128)
# a gemma_7b attention layer (src/repro/configs/gemma_7b.py: 16 query and
# 16 kv heads, head_dim 256) over a 2048-token prefill
GEMMA_7B = dict(b=1, hq=16, hkv=16, s=2048, d=256)
# parity only: (B, Hq, Hkv, Sq, Skv, D, causal, dtype) — non-causal with a
# ragged Skv, causal with Sq != Skv (top-left mask), a D below 128, bf16
# widths with D % 8 != 0 (the mma route), and head_dim 256 (mma): a
# gemma_7b layer (Hq = Hkv = 16, causal, Sq = Skv off the tile) in f32 and
# bf16, and paligemma_3b's group (Hq = 8, Hkv = 1, non-causal, a ragged
# Skv) in bf16
FLASH_PARITY = ((1, 64, 8, 320, 1000, 128, False, "float32"),
                (1, 64, 8, 320, 1000, 128, False, "bfloat16"),
                (1, 16, 4, 320, 1000, 128, True, "float32"),
                (2, 8, 2, 333, 333, 80, True, "bfloat16"),
                (1, 64, 8, 320, 1000, 100, False, "bfloat16"),
                (2, 8, 2, 333, 333, 36, True, "bfloat16"),
                (1, 16, 16, 1000, 1000, 256, True, "float32"),
                (1, 16, 16, 1000, 1000, 256, True, "bfloat16"),
                (1, 8, 1, 320, 1000, 256, False, "bfloat16"))
# flash_attention's limits per dtype: max |Δ| and ‖Δ‖ / ‖plain‖.  With
# randn inputs most causal rows average hundreds of keys and are ~0.03,
# so the max |Δ| limit alone passes a fault confined to those rows.  f32
# is held to the kernel tolerance of the ground rules, 1e-4 (3xTF32 reads
# ~6e-6 at the Qwen2-72B layer; one TF32 pass ~1.4e-3)
FLASH_TOL = {"bfloat16": (3e-2, 1e-2), "float32": (1e-4, 1e-4)}
# the serving phase: a ragged trace of ModelNet-sized objects, Poisson
# arrivals at 30 req/s, about 65 % of the 46.5 clouds/s that full
# (8, 1024) batches sustained on the H100 before the server (PERF.md §4)
SERVE_TRACE = dict(n_requests=48, rate_hz=30.0, n_median=768, sigma=0.35,
                   n_min=512, n_max=N_PAD)
SERVE_BUCKETS = (512, N_PAD)
SERVE_TIMEOUT_S = 0.1
SERVE_CHAOS = "fail@1,nan@3"
CLI_TRACE = 16
# Mamba2-2.7B's SSD (src/repro/configs/mamba2_2p7b.py: d_inner 5120 = 80
# heads of 64, state 128, chunk 64) over a 2048-token sequence: 32 chunks;
# and the same layer at src/repro/nn/ssm.py's default chunk, 128: 16 chunks
SSD_LAYERS = {"mamba2_2p7b": dict(bs=1, nc=32, q=64, h=80, p=64, s=128),
              "mamba2_2p7b_q128": dict(bs=1, nc=16, q=128, h=80, p=64,
                                       s=128)}
# parity only: ssd_chunk where its tiles run ragged, (bs, nc, q, H, P, S):
# two P and two S tiles at chunk 128, H not a multiple of any head group,
# and q, P, S off every tile
SSD_PARITY = ((1, 2, 128, 6, 128, 256), (1, 3, 50, 7, 36, 100),
              (2, 2, 100, 5, 130, 131))
# knn beyond the main path's two blocks: k = 96 and 300 on block 1's
# clouds (8 calls each), and dgcnn_s's EdgeConv kNN with the "all"
# sampler: one S3DIS-like cloud of 8192 points, every point a center
KNN_WIDE_K = (96, 300)
DGCNN_S_KNN = dict(n=8192, k=20)
# parity only, (S, N, k): knn on integer grid points (coordinates in 0..7),
# where the distances are exact and most of them tie, so the order among
# ties is decided by the index and must equal the plain version's
# everywhere: 4 warps a center (k = 32; k = 300 in memory lists), 2
# centers a warp (dgcnn_s's shape), every point (k = N, 2 warps a center),
# and lists past shared memory (k = 1600, in device memory)
KNN_TIES = ((512, 900, 32), (512, 900, 300), (8192, 8192, 20),
            (64, 100, 100), (2560, 4096, 1600))
# the LM phase: the port's LM serving side (repro_torch.lm, configs from
# src/repro/configs/) at full width, seeded random weights.  olmo-1b and
# mamba2-2.7b prefill B = 2 × 2048 tokens through their kernels (one
# flash_attention / ssd_chunk launch a layer) in float32 and in bfloat16,
# each held against the same prefill with the kernels' plain versions
# routed in: float32 max |Δ| <= 1e-3 · max(1, max|plain|) (3xTF32 products
# through 16 / 64 layers); bfloat16 ‖Δ‖ / ‖plain‖ <= 2e-2
# (tests/test_lm_smoke.py's tolerance) or, where larger, bf16's own error,
# the plain route's bf16 logits against the f32 model's (the same weights
# rounded): 64 bf16 layers amplify rounding, so two bf16 runs whose f32
# SSD outputs differ at rounding level differ by several % (mamba2-2.7b's
# line reports it as ssd_rounding_noise_rel: y_in × (1 + 1e-7·N(0, 1)) in
# the plain route).  Then a 32-token
# prompt teacher-forced through decode (olmo-1b: each position's logits
# against the forward's, float32 within rtol = atol = 2e-2 as
# test_lm_smoke.py's test_decode_matches_forward_olmo; bfloat16, where
# decode's plain attention rounds its probabilities to bf16 and the
# forward's kernel does not round alike, ‖Δ‖ / ‖ref‖ by the bf16 rule) and
# 16 greedy tokens
LM_MAIN = ("olmo-1b", "mamba2-2.7b")
LM_PREFILL = dict(b=2, s=2048)
LM_PROMPT, LM_GEN = 32, 16
LM_F32_TOL, LM_BF16_REL, LM_DECODE_TOL = 1e-3, 2e-2, 2e-2
# every other config once, in its own bfloat16: B = 1, S = 512 (Whisper's
# encoder its 1500 frames), then 4 decode steps; n_layers cut to 2 where
# one card's 80 GB does not hold the whole model (qwen2-72b ~145 GB,
# llama4-maverick ~800 GB, grok-1 ~630 GB of bf16 weights)
LM_ONCE = ("gemma-7b", "phi3-medium-14b", "recurrentgemma-2b",
           "paligemma-3b", "whisper-large-v3", "qwen2-72b",
           "llama4-maverick-400b-a17b", "grok-1-314b")
LM_CUT = {"qwen2-72b": 2, "llama4-maverick-400b-a17b": 2, "grok-1-314b": 2}
LM_ONCE_RUN = dict(b=1, s=512, steps=4, cache_len=64)
LM_CLI = ("--arch", "olmo-1b", "--batch", "4", "--prompt-len", "32",
          "--gen", "16", "--cache-len", "64")

# phase 9, the trainer.  flash_attention's backward kernel at the layers
# that train through it, (name, layer, dtype): olmo-1b's (one of its
# microbatches, B = 2 × 2048) in bf16 and f32, a Qwen2-72B layer (GQA 64 /
# 8), Whisper-large-v3's encoder (non-causal, 1500 frames, 20 heads of
# 64) and a gemma-7b layer (D = 256) in f32; held against
# attention_bwd_ref on the same inputs: f32 max|Δ| <= 1e-4 · max(1,
# max|ref|) per output (3xTF32, sums in another order), bf16 ‖Δ‖/‖ref‖ <=
# 2e-2 (P and dS rounded to bf16 before their products)
BWD_LAYERS = (
    ("olmo_1b", dict(b=2, hq=16, hkv=16, s=2048, d=128, causal=True),
     "bfloat16"),
    ("olmo_1b", dict(b=2, hq=16, hkv=16, s=2048, d=128, causal=True),
     "float32"),
    ("qwen2_72b", dict(b=1, hq=64, hkv=8, s=2048, d=128, causal=True),
     "bfloat16"),
    ("whisper_large_v3_encoder", dict(b=2, hq=20, hkv=20, s=1500, d=64,
                                      causal=False), "bfloat16"),
    ("gemma_7b", dict(b=1, hq=16, hkv=16, s=2048, d=256, causal=True),
     "float32"))
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the gradient wiring: olmo-1b at full width cut to 2 layers, f32, every
# leaf's grad through the kernels against the plain route's, max|Δ| <=
# 1e-3 · max|plain| per leaf (a detached attention leaves the q/k/v
# projections' grads zero, max|Δ| = max|plain|; the smoke plants one)
TRAIN_WIRING = dict(layers=2, b=2, s=512)
WIRING_TOL = 1e-3
# ssd_chunk's backward kernel at the SSD_LAYERS and at the trainer's
# microbatch (mamba2-2.7b, B = 2 × 2048 in chunks of 64), held against
# ssd_chunk_bwd_ref and against autograd of ssd_chunk_ref on the same
# inputs: f32 max|Δ| <= 1e-4 · max(1, max|ref|) per output (3xTF32, sums
# in another order); then the SSD_PARITY shapes and a steep decay (cum
# falling by 10 a step: exp overflows above the diagonal), whose outputs
# must be finite and within the same limit
SSD_BWD_LAYERS = {**SSD_LAYERS,
                  "mamba2_2p7b_train": dict(bs=2, nc=32, q=64, h=80, p=64,
                                            s=128)}
SSD_BWD_STEEP = dict(bs=1, nc=4, q=64, h=80, p=64, s=128)
SSD_BWD_TOL = 1e-4
# the trainer at full width: olmo-1b as published (16 layers, d 2048,
# vocab 50304) and mamba2-2.7b as published (64 layers, d 2560, vocab
# 50280, SSD chunks of 64), bf16 params, f32 AdamW state, remat, 4 × 2048
# tokens a step in 2 microbatches, 8 steps; then the resume check on each
# at full width cut to 2 layers (6 steps straight against 3 + 3 with a
# restart, losses within 1e-6 as tests/test_train_ckpt.py asks of JAX)
# and every config but olmo-1b at its reduced config, 2 steps
TRAIN_MAIN = (dict(arch="olmo-1b", b=4, s=2048, microbatches=2, steps=8),
              dict(arch="mamba2-2.7b", b=4, s=2048, microbatches=2,
                   steps=8))
TRAIN_RESUME = tuple(dict(arch=arch, layers=2, b=2, s=512, steps=6,
                          ckpt_every=3)
                     for arch in ("olmo-1b", "mamba2-2.7b"))
RESUME_TOL = 1e-6
TRAIN_OTHERS = dict(b=2, s=64, steps=2)
# the trainer's deterministic cuBLAS takes a fixed workspace only if this
# is set before cuBLAS's first call in the process: the trainer runs in a
# process of its own that carries it (the earlier phases run without it)
TRAIN_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# phase 10, the mesh on one card: the serving CLI over a data mesh of one
# rank; olmo-1b as in TRAIN_MAIN for its first 4 steps under local_mesh()
# (held bit-equal to phase 9's mesh-free run); mamba2-2.7b at 2 layers
# with and without the mesh
MESH_CLI = ("--arch", "pointnet2_c", "--trace", str(CLI_TRACE),
            "--mesh-data", "1")
MESH_TRAIN = dict(arch="olmo-1b", b=4, s=2048, microbatches=2, steps=4)
MESH_SSM = dict(arch="mamba2-2.7b", layers=2, b=2, s=512, steps=3)
# phase 11, LM serving under a mesh: launch.serve.serve_lm on the configs
# as published (olmo-1b, mamba2-2.7b) and cut to 2 layers (the RG-LRU
# state and conv caches, Whisper's cross caches from its encoder, MoE),
# each without a mesh and under local_mesh() handed in, the same params;
# then the planning tools: memreport and the dry run of one cell on the
# fake 256-rank world, each in a subprocess, the dry run's mesh-free count
# of the same step, and memmodel of phase 9's olmo-1b step on a one-device
# mesh (4 × 2048 tokens in 2 microbatches, bf16 params, f32 grads and
# AdamW state) beside the peak phase 9 measured
SERVE_MESH = dict(batch=4, prompt_len=16, gen=32, cache_len=2048)
SERVE_MESH_MAIN = ("olmo-1b", "mamba2-2.7b")
SERVE_MESH_CUT = ("recurrentgemma-2b", "whisper-large-v3",
                  "llama4-maverick-400b-a17b")
# phase 5: the families whose block 4 passes a block's shared memory at
# the paper's Fig. 22 cache size (C = 128 there: the layered route), at
# the families phase's batch
CACHE_X4_FAMILIES = ("pointnext_s", "pointvector_l")
# phase 14, the kernels' domain routes (each against its plain version):
# hub_reuse's layered route in two layers at pointvector_l's block 4
# under CACHE_X4 in the split-sign form (Hd = 2F, which no published
# spec's block reaches since the one-layer form: REUSE_LINEAR's
# pointvector_l_blk4_c128 is the engine's call there) and at D = 700, at
# B = 2
REUSE_DOMAIN = {
    "pointvector_l_blk4_c128": dict(hn=1, c=128, m=64, k=32, d=387, h=1536,
                                    f=768),
    "stream_d700": dict(hn=4, c=128, m=64, k=32, d=700, h=1024, f=512)}
# ssd_chunk's tiled route at Mamba-2's published chunk (256) and
# Mamba2-2.7B's widths over 2048 tokens
SSD_TILED = {"mamba2_2p7b_c256": dict(bs=1, nc=8, q=256, h=80, p=64, s=128),
             "mamba2_2p7b_c256_bs2": dict(bs=2, nc=8, q=256, h=80, p=64,
                                          s=128)}
# flash_attention's split route: a causal layer of 8 heads over 2048
# tokens at head widths past 256, (layer, D, dtype)
FLASH_SPLIT_LAYER = dict(b=1, hq=8, hkv=8, s=2048, causal=True)
FLASH_SPLIT = (("split_d512", 512, "float32"), ("split_d512", 512, "bfloat16"),
               ("split_d257", 257, "bfloat16"))
# and past 8 blocks of 128 columns in the dK/dV pass (D > 1024; the same
# layer), and past 8 slices of 256 (D > 2048, the streamed kernels, a
# layer of 512 tokens)
FLASH_SPLIT_WIDE = (("split_d1040", 1040, "float32"),
                    ("split_d1040", 1040, "bfloat16"))
FLASH_STREAM_LAYER = dict(b=1, hq=8, hkv=8, s=512, causal=True)
FLASH_SPLIT_STREAM = (("split_d2056", 2056, "float32"),
                      ("split_d2056", 2056, "bfloat16"))
# mamba2-2.7b at chunk 256: a B x S prefill (f32) against the plain route,
# and the 2-layer gradient wiring (TRAIN_WIRING)
SSD_CHUNK_LONG = 256
PLAN_DRYRUN = ("--arch", "olmo-1b", "--shape", "train_4k")
PLAN_STEP = dict(arch="olmo-1b", b=4, s=2048, microbatches=2)

def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(out, ref) -> tuple[float, float]:
    """(max |out − ref|, tolerance) with the -BIG merge identity compared
    exactly and left out of the scale."""
    import torch
    sentinel = ref <= -BIG / 2
    check(bool(torch.equal(out[sentinel], ref[sentinel])),
          "kernel and plain version disagree on the -BIG identity")
    rest = ~sentinel
    if not bool(rest.any()):
        return 0.0, TOL
    err = (out[rest] - ref[rest]).abs().max().item()
    return err, TOL * max(1.0, ref[rest].abs().max().item())


def dense_inputs(gen, dev, b, s, k, d, dc, h, f, masked):
    """gather_mlp's operands (raw, ctr, w1, b1, w2, b2, mask); h = 0: one
    layer, w1 (d, f), b1 (f,), w2 = b2 = None."""
    import torch
    r = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen)
                                   * scale).to(dev)
    mask = None
    if masked:
        mask = torch.rand((b, s, k), generator=gen) < 0.8
        mask[:, ::7] = False                  # whole subsets dead
        mask = mask.to(dev)
    if h == 0:
        return (r(b, s, k, d), r(b, s, dc), r(d, f, scale=(2 / d) ** .5),
                r(f, scale=.1), None, None, mask)
    return (r(b, s, k, d), r(b, s, dc), r(d, h, scale=(2 / d) ** .5),
            r(h, scale=.1), r(h, f, scale=(2 / h) ** .5), r(f, scale=.1),
            mask)


def reuse_inputs(gen, dev, b, hn, c, m, k, d, h, f):
    """hub_reuse's operands (pool, slot, comp, w1, b1, w2, b2, live); h =
    0: one layer, w1 (d, f), b1 (f,), w2 = b2 = None."""
    import torch
    r = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen)
                                   * scale).to(dev)
    slot = torch.randint(-1, c, (b, hn, m, k), generator=gen,
                         dtype=torch.int32)
    slot[:, :, ::9] = -1                      # subsets with no cached slot
    live = (torch.rand((b, hn, m, k), generator=gen) < 0.9)
    if h == 0:
        return (r(b, hn, c, d), slot.to(dev), r(b, hn, m, f),
                r(d, f, scale=(2 / d) ** .5), r(f, scale=.1), None, None,
                live.to(dev))
    return (r(b, hn, c, d), slot.to(dev), r(b, hn, m, f), r(d, h,
            scale=(2 / d) ** .5), r(h, scale=.1), r(h, f,
            scale=(2 / h) ** .5), r(f, scale=.1), live.to(dev))


def time_turns(fns: dict, iters=20) -> dict:
    """ms per call of each named function, timed with CUDA events after a
    warm-up, in turns that run the names forward then backward (plain,
    kernel, kernel, plain); each name's best turn."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fns[name]()
        t1.record()
        torch.cuda.synchronize()
        times[name].append(t0.elapsed_time(t1) / iters)
    return {name: min(t) for name, t in times.items()}


def time_pair(fn_kernel, fn_plain, iters=20):
    """ms per call of kernel and plain version, timed in turns."""
    t = time_turns({"plain": fn_plain, "kernel": fn_kernel}, iters)
    return t["kernel"], t["plain"]


def sass_count(name: str, *words: str, within: str = "") -> int:
    """Instructions of the built ``name`` library whose SASS line holds
    every one of ``words`` (``cuobjdump -sass``); with ``within``, only
    those of the kernels whose mangled name starts with it (``_ZN5split``:
    flash_split.cuh's)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lib = _build.library_path(name)
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    n, inside = 0, True
    for line in sass.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip().startswith(within)
        elif inside and all(w in line for w in words):
            n += 1
    return n


def ptxas_kernels(log: str) -> list:
    """Per kernel of an nvcc log (``-Xptxas -v``): its mangled name, its
    registers and its spill stores and loads in bytes."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append(dict(kernel=m.group(1), registers=None, spill=0))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m.group(1))
        elif rows and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[-1]["spill"] = int(m.group(1)) + int(m.group(2))
    return rows


def spilled_bytes(log: str) -> int:
    """Spill stores plus spill loads over every kernel in an nvcc log."""
    return sum(row["spill"] for row in ptxas_kernels(log))


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def kernel_phase(dev, seed):
    """Hold every kernel variant against its plain version and time the
    main-path shapes, batched (the serving path) and at B = 1 (the
    per-cloud entry).  -> (parity rows, batched rows without launches,
    per-cloud rows)."""
    import torch
    from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    from repro_torch.kernels.hub_reuse import ops as hub_ops
    gen = torch.Generator().manual_seed(seed)
    parity, rows, per_cloud = [], [], []
    for blk, shp in DENSE.items():
        for bb in (B, 1):
            for masked in (True, False):
                raw, ctr, w1, b1, w2, b2, mask = dense_inputs(
                    gen, dev, bb, **{**shp, "masked": masked})
                args = (raw, ctr, w1, b1, w2, b2)
                if bb == 1:              # the per-cloud entry: (S, K, D)
                    args = (raw[0], ctr[0], w1, b1, w2, b2)
                    mask = None if mask is None else mask[0]
                out = gather_mlp(*args, mask=mask)
                ref = gather_mlp_ref(*args, mask=mask)
                torch.cuda.synchronize()
                err, tol = max_err(out, ref)
                parity.append(dict(name="gather_mlp", block=blk, b=bb,
                                   masked=masked, max_abs_err=err, tol=tol))
                check(err <= tol, f"gather_mlp {blk} B={bb} masked={masked}"
                      f": max|err| {err} > {tol}")
                if masked == shp["masked"]:
                    ms, plain_ms = time_pair(
                        lambda: gather_mlp(*args, mask=mask),
                        lambda: gather_mlp_ref(*args, mask=mask))
                    flops = 2 * bb * shp["s"] * shp["k"] * (
                        shp["d"] * shp["h"] + shp["h"] * shp["f"])
                    # 3xTF32: three TF32 products for each fp32 one
                    moved = nbytes(*args, mask, out)
                    bms, by = bound(3 * flops, moved, PEAK_TF32)
                    (rows if bb == B else per_cloud).append(dict(
                        name="gather_mlp", block=blk, route="cuda",
                        variant="mma_tf32x3", tflops=flops / ms / 1e9,
                        bound_fp32_ms=bound(flops, moved)[0],
                        source="src/repro_torch/csrc/gather_mlp.cu",
                        replaces="src/repro/kernels/gather_mlp/"
                                 f"gather_mlp.py:{239 if bb == B else 91}",
                        shape=f"B={bb} S={shp['s']} K={shp['k']} "
                              f"D={shp['d']} Dc={shp['dc']} H={shp['h']} "
                              f"F={shp['f']} masked={masked}",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None))
    for blk, shp in REUSE.items():
        for bb in (B, 1):
            for with_live in (True, False):
                pool, slot, comp, w1, b1, w2, b2, live = reuse_inputs(
                    gen, dev, bb, **shp)
                live = live if with_live else None
                args = (pool, slot, comp, w1, b1, w2, b2)
                if bb == 1:
                    args = (pool[0], slot[0], comp[0], w1, b1, w2, b2)
                    live = None if live is None else live[0]
                out = hub_reuse(*args, live=live)
                ref = hub_reuse_ref(*args, live=live)
                torch.cuda.synchronize()
                err, tol = max_err(out, ref)
                parity.append(dict(name="hub_reuse", block=blk, b=bb,
                                   masked=with_live, max_abs_err=err,
                                   tol=tol))
                check(err <= tol, f"hub_reuse {blk} B={bb} live="
                      f"{with_live}: max|err| {err} > {tol}")
                if with_live:
                    ms, plain_ms = time_pair(
                        lambda: hub_reuse(*args, live=live),
                        lambda: hub_reuse_ref(*args, live=live))
                    flops = 2 * bb * shp["hn"] * shp["c"] * (
                        shp["d"] * shp["h"] + shp["h"] * shp["f"])
                    moved = nbytes(*args, live, out)
                    bms, by = bound(3 * flops, moved, PEAK_TF32)
                    (rows if bb == B else per_cloud).append(dict(
                        name="hub_reuse", block=blk, route="cuda",
                        variant="mma_tf32x3", tflops=flops / ms / 1e9,
                        bound_fp32_ms=bound(flops, moved)[0],
                        source="src/repro_torch/csrc/hub_reuse.cu",
                        replaces="src/repro/kernels/hub_reuse/"
                                 f"hub_reuse.py:{307 if bb == B else 117}",
                        shape=f"B={bb} H={shp['hn']} C={shp['c']} "
                              f"M={shp['m']} K={shp['k']} D={shp['d']} "
                              f"Hd={shp['h']} F={shp['f']} live=True",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None))
    for blk, shp in REUSE_C256.items():   # two resident launches a call
        pool, slot, comp, w1, b1, w2, b2, live = reuse_inputs(
            gen, dev, B, **shp)
        args = (pool, slot, comp, w1, b1, w2, b2)
        out = hub_reuse(*args, live=live)
        ref = hub_reuse_ref(*args, live=live)
        torch.cuda.synchronize()
        err, tol = max_err(out, ref)
        parity.append(dict(name="hub_reuse", block=blk, b=B, masked=True,
                           max_abs_err=err, tol=tol))
        check(err <= tol, f"hub_reuse {blk}: max|err| {err} > {tol}")
        ms, plain_ms = time_pair(lambda: hub_reuse(*args, live=live),
                                 lambda: hub_reuse_ref(*args, live=live))
        flops = 2 * B * shp["hn"] * shp["c"] * (
            shp["d"] * shp["h"] + shp["h"] * shp["f"])
        moved = nbytes(*args, live, out)
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        rows.append(dict(
            name="hub_reuse", block=blk, route="cuda",
            variant="mma_tf32x3_" + hub_ops.plan(
                B, *(shp[n] for n in ("hn", "c", "m", "k", "d", "h", "f")),
                dev)["route"],
            tflops=flops / ms / 1e9,
            bound_fp32_ms=bound(flops, moved)[0],
            source="src/repro_torch/csrc/hub_reuse.cu",
            replaces="src/repro/kernels/hub_reuse/hub_reuse.py:307",
            shape=f"B={B} H={shp['hn']} C={shp['c']} M={shp['m']} "
                  f"K={shp['k']} D={shp['d']} Hd={shp['h']} F={shp['f']} "
                  f"live=True",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None, path="cache_x4"))
    for name, shp in REUSE_WIDE.items():
        pool, slot, comp, w1, b1, w2, b2, live = reuse_inputs(
            gen, dev, 2, **shp)
        args = (pool, slot, comp, w1, b1, w2, b2)
        out = hub_reuse(*args, live=live)
        err, tol = max_err(out, hub_reuse_ref(*args, live=live))
        parity.append(dict(name="hub_reuse", block=name, b=2, masked=True,
                           max_abs_err=err, tol=tol))
        check(err <= tol, f"hub_reuse {name}: max|err| {err} > {tol}")
    return parity, rows, per_cloud


def make_requests(rng, n):
    """Seeded synthetic clouds of 512–1024 points: noisy ellipsoid shells
    and boxes, the shapes ModelNet-style classifiers see."""
    import numpy as np
    clouds = []
    for i in range(n):
        m = int(rng.integers(512, N_PAD + 1))
        if i % 2:
            p = rng.standard_normal((m, 3))
            p /= np.linalg.norm(p, axis=1, keepdims=True)
        else:
            p = rng.uniform(-1, 1, (m, 3))
        p = p * rng.uniform(0.4, 1.0, 3) + 0.01 * rng.standard_normal((m, 3))
        clouds.append(p.astype(np.float32))
    return clouds


def close(a, b) -> tuple[float, float]:
    err = (a - b).abs().max().item()
    return err, TOL * max(1.0, b.abs().max().item())


def breakdown(params, spec, batch, repeats=3, isl_kw=None) -> dict:
    """Host-clock ms of the forward's stages on one batch (each ended by
    a device sync; the best of ``repeats``): stage 1 builds the structures,
    stage 2 runs the FC dataflows (with a family's stem and residuals), the
    tail is the global pool and head (cls) or the FP decoder and per-point
    head (seg)."""
    import torch
    from repro_torch.engine import archs
    arch = archs.get_arch(spec)
    ctx = archs.EngineCtx.make("lpcn", "cuda", isl_kw)
    best = {}
    for _ in range(repeats):
        t0 = time.perf_counter()
        structs, nv = arch.structure(spec, ctx, batch.xyz, batch.keys,
                                     batch.n_valid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = arch.features(params, spec, ctx, batch.xyz, batch.feats,
                              structs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        arch.tail(params, spec, state, nv, batch.n_valid)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in (("structure_ms", t1 - t0), ("fc_ms", t2 - t1),
                     ("tail_ms", t3 - t2)):
            best[k] = min(best.get(k, float("inf")), v * 1e3)
    return best


def seed_biases(params, gen):
    """init leaves biases at zero; seeded nonzero biases keep the kernel
    vs reference comparison from passing on exact zeros alone."""
    import torch
    for mlp in (*params.blocks, params.global_mlp, params.head, params.stem,
                *params.extras):
        if mlp is None:
            continue
        for layer in mlp.layers:
            layer.b.copy_(0.1 * torch.randn(layer.b.shape, generator=gen))
    return params


def trace_requests(seed, trace=SERVE_TRACE):
    """The serving trace's events, one synthetic cloud per event, and the
    default key the server gives each rid (``fold_in(PRNGKey(seed),
    rid)``)."""
    import numpy as np
    import torch
    from repro_torch import random
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.serve import synthetic_trace
    events = synthetic_trace(**trace, seed=seed)
    rng = np.random.default_rng(seed)
    clouds = [make_cloud(rng, e.n_points) for e in events]
    keys = random.fold_in(random.PRNGKey(seed), torch.arange(len(events)))
    return events, clouds, keys


def serve_run(engine, params, buckets, events, clouds, seed, **kw) -> dict:
    """Replay the trace once through a fresh ``PCNServer`` (its buckets
    warmed at construction) with the launch counts set to 0 just before
    the replay and read just after; take every response, exactly once.
    -> dict(server, report, responses by rid, launches, warm_s, replay_s)."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import PCNServer, UnknownRequestError, replay
    t0 = time.perf_counter()
    server = PCNServer(engine, params, buckets, timeout_s=SERVE_TIMEOUT_S,
                       seed=seed, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = replay(server, events, lambda n, i: (clouds[i], None))
    server.close()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(rids == list(range(len(events))),
          f"requests refused at admission: {rids}")
    responses = {}
    for rid in rids:
        responses[rid] = server.take(rid)    # a failed one raises here
        try:
            server.take(rid)
        except UnknownRequestError:
            pass
        else:
            check(False, f"rid {rid} answered twice")
    check(server.pending() == 0, "requests left pending after drain")
    return dict(server=server, report=server.report(), responses=responses,
                launches=launches, warm_s=warm_s, replay_s=replay_s)


def check_responses(name, responses, refs) -> float:
    """Every response within TOL·max(1, max|ref|) of its reference;
    -> the largest max |Δ|."""
    import torch
    worst = 0.0
    for rid, got in responses.items():
        check(got.shape == tuple(refs[rid].shape),
              f"{name}: rid {rid} has shape {got.shape}")
        err, tol = close(torch.from_numpy(got), refs[rid])
        check(err <= tol, f"{name}: rid {rid} max|err| {err} > {tol}")
        worst = max(worst, err)
    return worst


def serve_line(name, run, smi, rate_hz, max_abs_err) -> str:
    rep = run["report"]
    lat = rep["latency_ms"]
    return json.dumps({name: {
        "device": smi, "requests": rep["requests"],
        "rate_hz": rate_hz, "timeout_ms": rep["timeout_ms"],
        "dispatch_mode": rep["dispatch_mode"],
        "max_in_flight": rep["max_in_flight"],
        "e2e_ms": {q: lat["e2e"][q] for q in ("p50", "p95", "p99")},
        "queue_wait_ms": {q: lat["queue_wait"][q] for q in ("p50", "p99")},
        "service_ms": {q: lat["service"][q] for q in ("p50", "p99")},
        "throughput_rps": rep["throughput_rps"],
        "padding_waste_pct": rep["padding_waste_pct"],
        "dispatches": rep["dispatches"],
        "partial_batches": rep["partial_batches"],
        "per_bucket": rep["per_bucket"], "overlap": rep["overlap"],
        "faults": rep["faults"], "launches": run["launches"],
        "warm_s": run["warm_s"], "replay_s": run["replay_s"],
        "max_abs_err": max_abs_err}})


def serve_phase(spec, engine, reference, params, seed, smi,
                trace=SERVE_TRACE, bucket_sizes=SERVE_BUCKETS,
                batch=B) -> dict:
    """The main path: the trace through ``PCNServer`` async, sync and
    under chaos, each run checked (answers, launches, faults, values).
    -> dict(launches of the async run, phase times)."""
    import torch
    from repro_torch.serve import BucketSet, FaultPlan
    buckets = BucketSet.make(bucket_sizes, batch=batch)
    events, clouds, keys = trace_requests(seed, trace)
    n_blocks = len(spec.blocks)
    off_path = ("knn", "flash_attention", "flash_attention_bwd", "ssd_chunk",
                "ssd_chunk_bwd")
    times = {}

    def check_launches(name, launches, primary_runs):
        want = n_blocks * primary_runs
        check(launches["gather_mlp"] == launches["hub_reuse"] == want
              and not any(launches[k] for k in off_path),
              f"{name}: launches {launches}, expected gather_mlp == "
              f"hub_reuse == {want} and no entry kernel")

    runs = {}
    for name, kw in (("serve_async", dict(max_in_flight=4)),
                     ("serve_sync", dict(sync=True))):
        run = runs[name] = serve_run(engine, params, buckets, events, clouds,
                                     seed, **kw)
        rep = run["report"]
        check(not any(rep["faults"].values()),
              f"{name}: a healthy run degraded or failed: {rep['faults']}")
        check_launches(name, run["launches"], rep["dispatches"])
        times[f"{name}_s"] = run["replay_s"]
    # references after the counted runs: apply_single launches at B = 1
    t0 = time.perf_counter()
    refs = {rid: engine.apply_single(params, clouds[rid], key=keys[rid])
            .cpu() for rid in range(len(events))}
    times["apply_single_refs_s"] = time.perf_counter() - t0
    for name, run in runs.items():
        err = check_responses(name, run["responses"], refs)
        log(serve_line(name, run, smi, trace["rate_hz"], err))

    plan = FaultPlan.parse(SERVE_CHAOS)
    run = serve_run(engine, params, buckets, events, clouds, seed,
                    faults=plan, fallback="reference")
    rep, server = run["report"], run["server"]
    times["serve_chaos_s"] = run["replay_s"]
    check(plan.injected == [(1, "fail"), (3, "nan")],
          f"serve_chaos: injected {plan.injected}")
    check(rep["faults"]["degraded_dispatches"] == 2
          and rep["faults"]["failed_requests"] == 0
          and rep["faults"]["breaker_opened"] == 0,
          f"serve_chaos: faults {rep['faults']}, expected 2 degraded")
    # every dispatch tried the kernels but the failed one; the nan one
    # launched them before its output was poisoned
    check_launches("serve_chaos", run["launches"], rep["dispatches"] - 1)
    # a degraded batch's requests share its (bucket, start, done) stamps
    degraded = {(d.bucket, d.t_start, d.t_done)
                for d in server.metrics.dispatches if d.degraded}
    deg_rids = [r.rid for r in server.metrics.requests
                if (r.bucket, r.t_dispatch, r.t_done) in degraded]
    check(len(deg_rids) == sum(d.n_requests for d in server.metrics
                               .dispatches if d.degraded),
          "serve_chaos: degraded requests not matched to their batches")
    ref_refs = {rid: reference.apply_single(params, clouds[rid],
                                            key=keys[rid]).cpu()
                for rid in deg_rids}
    err = max(check_responses("serve_chaos degraded",
                              {r: run["responses"][r] for r in deg_rids},
                              ref_refs),
              check_responses("serve_chaos", {
                  r: v for r, v in run["responses"].items()
                  if r not in ref_refs}, refs))
    log(serve_line("serve_chaos", run, smi, trace["rate_hz"], err))
    log(f"serve_chaos: degraded rids {deg_rids} held against the "
        f"reference backend")
    return dict(launches=runs["serve_async"]["launches"], times=times)


def cli_phase(smi, cli_args=("--arch", "pointnet2_c", "--trace",
                              str(CLI_TRACE))) -> float:
    """``python -m repro_torch.launch.serve <cli_args>`` (by default
    ``--arch pointnet2_c --trace 16``) in a subprocess: exit 0, every
    request answered, no fault; -> s."""
    out = ROOT / "build" / "serve_cli.json"
    out.unlink(missing_ok=True)
    # the CLI plans every call by the heuristic (or its --kernel-kw): no
    # tile-plan store, whatever results/ holds
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])),
        "REPRO_TORCH_TILE_PLANS": str(ROOT / "build" / "no_tile_plans")}
    n = int(cli_args[cli_args.index("--trace") + 1])
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *cli_args,
         "--serve-json", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"cli: {line}")
    check(res.returncode == 0, f"the serving CLI exited {res.returncode}:\n"
          f"{res.stderr[-3000:]}")
    rep = json.loads(out.read_text())
    check(rep["answered"] == n and not any(rep["faults"].values()),
          f"the serving CLI answered {rep['answered']}/{n}, faults "
          f"{rep['faults']}")
    check(smi.startswith(rep["device"]),
          f"the CLI ran on {rep['device']}, not on {smi}")
    return dt


def structure_card_vs_cpu(spec, batch, isl_kw=None) -> dict:
    """Stage 1 of one batch on the card against the same code on the CPU,
    where the tests hold it bit-equal to the JAX package: mismatching
    entries per structure field (a near-tie rounded differently on the
    card shows here)."""
    from repro_torch.engine import archs
    ctx = archs.EngineCtx.make("lpcn", "cuda", isl_kw)
    card, _ = archs._structure_stack_b(spec, ctx, batch.xyz, batch.keys,
                                       batch.n_valid)
    host_b = batch.to("cpu")
    host, _ = archs._structure_stack_b(spec, ctx, host_b.xyz, host_b.keys,
                                       host_b.n_valid)
    diff = {}
    for i, (c, h) in enumerate(zip(card, host), 1):
        for name, x, y in (
                ("center_idx", c.center_idx, h.center_idx),
                ("nbr", c.nbr, h.nbr),
                ("members", c.islands.members, h.islands.members),
                ("reuse_slot", c.schedule.reuse_slot, h.schedule.reuse_slot)):
            diff[f"blk{i}.{name}"] = int((x.cpu() != y).sum())
    return diff


def family_batch(spec, b, n, seed, dev):
    """One ragged batch of ``b`` synthetic clouds padded to ``n`` points:
    the first full (when b > 1), the rest 3/4·n to n points; scenes for
    the S3DIS models, with 3 colour channels where the spec takes 6
    features.  -> (Batch, sizes)."""
    import numpy as np
    import torch
    from repro_torch import random
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.engine import Batch
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(n * 3 // 4, n)) for _ in range(b)]
    if b > 1:
        sizes[0] = n
    clouds = [make_cloud(rng, m, scene_like=spec.name in SCENES)
              for m in sizes]
    feats = None
    if spec.in_feats > 3:
        feats = [np.concatenate([c, rng.uniform(0, 1, (len(c),
                 spec.in_feats - 3)).astype(np.float32)], -1)
                 for c in clouds]
    keys = random.fold_in(random.PRNGKey(seed, dev),
                          torch.arange(b, device=dev))
    return Batch.from_clouds(clouds, feats=feats, key=keys, n_pad=n,
                             device=dev), sizes


# the families whose every block is one linear map (the linear route)
ONE_LAYER_FAMILIES = ("dgcnn_c", "dgcnn_s", "pointnext_s", "pointvector_l")
GATHER_ROUTES = ("narrow", "wide", "linear")


def route_blocks(spec, params) -> dict:
    """Block numbers (from 1) of each gather_mlp route, from the wrapper's
    route at the engine's lowering."""
    from repro_torch.engine.fc import dense_shape
    from repro_torch.kernels.gather_mlp.ops import route
    out = {way: [] for way in GATHER_ROUTES}
    for i, (b, mlp) in enumerate(zip(spec.blocks, params.blocks), 1):
        out[route(*dense_shape(b.kind, b.k, mlp))].append(i)
    return out


def route_launches() -> dict:
    """gather_mlp's launch counts by route since the counts were reset."""
    from repro_torch import kernels
    return {way: kernels.LAUNCHES[f"gather_mlp_{way}"]
            for way in GATHER_ROUTES}


# hub_reuse's launch counts by route (both forms) and by route and form
# (one layer)
REUSE_COUNTS = ("resident", "layered", "resident_linear", "layered_linear")


def reuse_form_launches() -> dict:
    """hub_reuse's launch counts by route and form since the counts were
    reset (``REUSE_COUNTS``), and ``linear``: its one-layer launches."""
    from repro_torch import kernels
    out = {k: kernels.LAUNCHES[f"hub_reuse_{k}"] for k in REUSE_COUNTS}
    out["linear"] = out["resident_linear"] + out["layered_linear"]
    return out


def families_phase(dev, seed, smi) -> dict:
    """Every other model of the zoo at full width: one ragged lpcn batch
    through ``PCNEngine(spec, fc_backend="cuda")`` with the launch counts
    set to 0 just before and read just after (one gather_mlp and one
    hub_reuse launch a block, gather_mlp's launches by route equal to the
    lowering's routes: ``linear`` at every block of ``ONE_LAYER_FAMILIES``,
    ``wide`` at none; hub_reuse's by form likewise: one layer at every
    block of ``ONE_LAYER_FAMILIES``, two at PointNet++'s; no entry
    kernel), every logit against the "reference" backend on the card, seg
    padding rows exactly 0, and the forward's stages timed; dgcnn_c's
    stage 1 on the card against the CPU (every integer field equal); then
    dgcnn_c once in traditional mode.  -> gather_mlp's launches by route,
    the linear route's W splits (``split_weights``, one a linear launch),
    hub_reuse's one-layer launches by route (``hub_reuse_<route>_linear``),
    the wgmma kernel's among them (``hub_reuse_linear_wgmma``) and its W
    splits (``hub_reuse_split_weights``, one a wgmma call) over the
    counted forwards."""
    import torch
    from repro_torch import kernels
    from repro_torch.engine import PCNEngine
    from repro_torch.models import MODEL_ZOO
    off_path = ("knn", "flash_attention", "flash_attention_bwd", "ssd_chunk",
                "ssd_chunk_bwd")
    totals = dict.fromkeys(GATHER_ROUTES, 0)
    totals.update(hub_reuse_resident_linear=0, hub_reuse_layered_linear=0,
                  split_weights=0, hub_reuse_linear_wgmma=0,
                  hub_reuse_split_weights=0)
    for name, (b, n) in FAMILIES.items():
        spec = MODEL_ZOO[name][1]
        engine = PCNEngine(spec, mode="lpcn", fc_backend="cuda")
        reference = PCNEngine(spec, mode="lpcn", fc_backend="reference")
        params = seed_biases(engine.init(seed=seed),
                             torch.Generator().manual_seed(seed + 1))
        batch, sizes = family_batch(spec, b, n, seed, dev)
        blocks = route_blocks(spec, params)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.apply(params, batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        by_route = route_launches()
        split = kernels.LAUNCHES["gather_mlp_split_weights"]
        forms = reuse_form_launches()
        nb = len(spec.blocks)
        check(split == by_route["linear"],
              f"{name}: {split} W splits for {by_route['linear']} linear "
              f"launches, expected one each")
        totals["split_weights"] += split
        check(launches["gather_mlp"] == launches["hub_reuse"] == nb
              and not any(launches[k] for k in off_path),
              f"{name}: launches {launches}, expected gather_mlp == "
              f"hub_reuse == {nb} and no entry kernel")
        check(by_route == {way: len(bl) for way, bl in blocks.items()},
              f"{name}: gather_mlp launches by route {by_route}, expected "
              f"one at each block of {blocks}")
        check(not blocks["wide"] and (blocks["linear"] == list(
            range(1, nb + 1))) == (name in ONE_LAYER_FAMILIES),
              f"{name}: routes {blocks}: the wide route at a published "
              f"block, or the linear route not at every block of exactly "
              f"the one-layer families")
        one_layer = nb if name in ONE_LAYER_FAMILIES else 0
        check(forms["linear"] == one_layer,
              f"{name}: hub_reuse launches by route and form {forms}, "
              f"expected {one_layer} of one layer and {nb - one_layer} of "
              f"two")
        for way in GATHER_ROUTES:
            totals[way] += by_route[way]
        for way in ("resident_linear", "layered_linear"):
            totals[f"hub_reuse_{way}"] += forms[way]
        reuse_split = kernels.LAUNCHES["hub_reuse_split_weights"]
        wgmma = kernels.LAUNCHES["hub_reuse_linear_wgmma"]
        check(reuse_split == wgmma <= forms["resident_linear"],
              f"{name}: {reuse_split} hub_reuse W splits for {wgmma} wgmma "
              f"launches of {forms['resident_linear']} one-layer resident "
              f"ones, expected one a wgmma call (C <= 128: one launch)")
        totals["hub_reuse_split_weights"] += reuse_split
        totals["hub_reuse_linear_wgmma"] += wgmma
        seg = spec.task == "seg"
        check(tuple(out.shape) == ((b, n, spec.n_classes) if seg
                                   else (b, spec.n_classes)),
              f"{name}: logits of shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite logits")
        if seg:
            check(all(bool((out[i, m:] == 0).all())
                      for i, m in enumerate(sizes)),
                  f"{name}: a padding row is not 0")
        err, tol = close(out, reference.apply(params, batch))
        check(err <= tol, f"{name}: cuda vs reference max|err| {err} > "
              f"{tol}")
        stages = breakdown(params, spec, batch, repeats=2)
        log(json.dumps({"family": {
            "spec": name, "device": smi, "b": b, "n": n, "sizes": sizes,
            "forward_ms": sum(stages.values()), **stages,
            "first_forward_ms": first_ms,
            "stage1_share": stages["structure_ms"] / sum(stages.values()),
            "launches": {k: v for k, v in launches.items() if v},
            "route_blocks": blocks, "route_launches": by_route,
            "hub_reuse_forms": forms, "max_abs_err": err, "tol": tol}}))
        if name == "dgcnn_c":
            mismatch = structure_card_vs_cpu(spec, batch)
            log(json.dumps({"family_structure_card_vs_cpu": {
                "spec": name, "b": b, "n": n, "mismatches": mismatch}}))
            check(not any(mismatch.values()),
                  f"dgcnn_c: stage 1 on the card differs from the CPU: "
                  f"{mismatch}")

    # ---- traditional mode, once: dgcnn_c --------------------------------
    spec = MODEL_ZOO["dgcnn_c"][1]
    b, n = FAMILIES["dgcnn_c"]
    trad = PCNEngine(spec, mode="traditional", fc_backend="cuda")
    trad_ref = PCNEngine(spec, mode="traditional", fc_backend="reference")
    params = seed_biases(trad.init(seed=seed),
                         torch.Generator().manual_seed(seed + 1))
    batch, _ = family_batch(spec, b, n, seed, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = trad.apply(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    check(launches == {**dict.fromkeys(launches, 0),
                       "gather_mlp": len(spec.blocks)},
          f"dgcnn_c traditional launches {launches}")
    by_route = route_launches()
    split = kernels.LAUNCHES["gather_mlp_split_weights"]
    check(by_route == {**dict.fromkeys(GATHER_ROUTES, 0),
                       "linear": len(spec.blocks)}
          and split == len(spec.blocks),
          f"dgcnn_c traditional: gather_mlp launches by route {by_route}, "
          f"{split} W splits, expected every block on the linear route")
    totals["linear"] += by_route["linear"]
    totals["split_weights"] += split
    check(bool(torch.isfinite(out).all()), "dgcnn_c traditional: non-finite")
    err, tol = close(out, trad_ref.apply(params, batch))
    check(err <= tol, f"dgcnn_c traditional: max|err| {err} > {tol}")
    log(json.dumps({"family_traditional": {
        "spec": "dgcnn_c", "device": smi, "b": b, "n": n, "forward_ms": ms,
        "launches": {k: v for k, v in launches.items() if v},
        "route_launches": by_route, "max_abs_err": err, "tol": tol}}))
    return totals


def wide_kernel_rows(dev, seed, families_launches) -> tuple[list, list]:
    """gather_mlp's wide route at ``DENSE_WIDE`` and ``WIDE_D`` (two
    layers, the split-sign form): each call launched once with the launch
    counts set to 0 just before and read just after (no published spec
    takes the route since the linear route exists), the wrapper's route
    and plan equal to the library's, the kernel against its plain
    version, both timed in turns.  -> (parity rows, kernel rows with the
    drive's ``launches``, the families phase's beside, and the plan:
    grid, layer-1 recompute factor)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
    from repro_torch.kernels.gather_mlp.ops import (library_plan,
                                                    library_route, route,
                                                    wide_plan)
    gen = torch.Generator().manual_seed(seed + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {**DENSE_WIDE, **WIDE_D}
    inputs = {blk: dense_inputs(gen, dev, **shp)
              for blk, shp in shapes.items()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for raw, ctr, w1, b1, w2, b2, mask in inputs.values():
        gather_mlp(raw, ctr, w1, b1, w2, b2, mask=mask)
    torch.cuda.synchronize()
    drive = route_launches()
    check(drive == {**dict.fromkeys(GATHER_ROUTES, 0), "wide": len(shapes)}
          and kernels.LAUNCHES["gather_mlp"] == len(shapes),
          f"the wide route's drive: launches by route {drive}")
    parity, rows = [], []
    for blk, shp in shapes.items():
        kshape = (shp["k"], shp["d"], shp["dc"], shp["h"], shp["f"])
        check(route(*kshape) == library_route(*kshape) == "wide",
              f"gather_mlp {blk}: routes {route(*kshape)} (wrapper) and "
              f"{library_route(*kshape)} (library), expected wide")
        plan = library_plan(shp["b"], shp["s"], *kshape)
        check(plan == wide_plan(shp["b"], shp["s"], *kshape, sms=sms),
              f"gather_mlp {blk}: the library's plan {plan} differs from "
              f"the wrapper's")
        raw, ctr, w1, b1, w2, b2, mask = inputs[blk]
        args = (raw, ctr, w1, b1, w2, b2)
        out = gather_mlp(*args, mask=mask)
        ref = gather_mlp_ref(*args, mask=mask)
        torch.cuda.synchronize()
        err, tol = max_err(out, ref)
        parity.append(dict(name="gather_mlp", block=blk, b=shp["b"],
                           masked=shp["masked"], route="wide",
                           max_abs_err=err, tol=tol))
        check(err <= tol, f"gather_mlp {blk}: max|err| {err} > {tol}")
        ms, plain_ms = time_pair(lambda: gather_mlp(*args, mask=mask),
                                 lambda: gather_mlp_ref(*args, mask=mask),
                                 iters=10)
        flops = 2 * shp["b"] * shp["s"] * shp["k"] * (
            shp["d"] * shp["h"] + shp["h"] * shp["f"])
        moved = nbytes(*args, mask, out)
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        rows.append(dict(
            name="gather_mlp", block=blk, route="cuda",
            variant="mma_tf32x3_wide", tflops=flops / ms / 1e9,
            bound_fp32_ms=bound(flops, moved)[0],
            source="src/repro_torch/csrc/gather_mlp.cu",
            replaces="src/repro/kernels/gather_mlp/gather_mlp.py:239",
            shape=f"B={shp['b']} S={shp['s']} K={shp['k']} D={shp['d']} "
                  f"Dc={shp['dc']} H={shp['h']} F={shp['f']} "
                  f"masked={shp['masked']}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None, launches=drive["wide"],
            families_launches=families_launches,
            plan=dict(plan, grid=[plan["groups"], plan["nft"],
                                  plan["nsplit"]],
                      layer1_recompute=plan["nft"])))
    return parity, rows


def linear_kernel_rows(dev, seed, launches,
                       split_launches) -> tuple[list, list]:
    """gather_mlp's linear route at ``DENSE_LINEAR``: the wrapper's route,
    row tile and shared memory and the library's plan (rows, F tiles,
    columns a block, ring stages, x by TMA or cp.async, shared memory,
    scratch; the heuristic's and each forced row tile's) equal to
    tiling.py's, the kernel against its plain version
    (1e-4 · max(1, max|plain|)) and twice bit-equal, both timed in turns;
    the bound by the one layer's flops; the route's first kernel, W's
    split into TF32 halves, bit-equal to ``split_weights_ref`` and timed
    beside it, its bound by bytes.  -> (parity rows, kernel rows with
    ``launches``: the families phase's count of the route, and of its W
    splits (``split_launches``), and the plan)."""
    import torch
    from repro_torch.kernels import tiling
    from repro_torch.kernels.gather_mlp import gather_mlp, gather_mlp_ref
    from repro_torch.kernels.gather_mlp import ops
    from repro_torch.kernels.gather_mlp.ref import split_weights_ref
    gen = torch.Generator().manual_seed(seed + 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parity, rows = [], []
    for blk, shp in DENSE_LINEAR.items():
        b, s, k, d, dc, f = (shp[n] for n in ("b", "s", "k", "d", "dc", "f"))
        lp = tiling.linear_plan(b, s, k, f, sms)
        ours = dict(lp, x_tma=int(tiling.linear_x_tma(d)),
                    scratch=tiling.linear_scratch(d, f))
        lib = ops.library_linear_plan(b, s, k, d, dc, f)
        got = dict(route=ops.library_route(k, d, dc, 0, f),
                   rows=ops.plan(b, s, k, d, dc, 0, f, dev)["rows"],
                   smem=ops.library_smem(b, s, k, d, dc, 0, f),
                   scratch=ops.library_scratch(b, s, k, d, dc, 0, f))
        check(got == dict(route="linear", rows=lp["rows"], smem=lp["smem"],
                          scratch=ours["scratch"])
              and lib == ours and ops.route(k, d, dc, 0, f) == "linear",
              f"gather_mlp {blk}: the library's {got} and plan {lib}, "
              f"tiling.py's {ours}")
        for tile in tiling.ROWS:                  # either row tile, forced
            forced = dict(tiling.linear_plan(b, s, k, f, sms, tile),
                          x_tma=ours["x_tma"], scratch=ours["scratch"])
            got = ops.library_linear_plan(b, s, k, d, dc, f, tile)
            check(got == forced and ops.library_smem(
                b, s, k, d, dc, 0, f, tile) == forced["smem"],
                  f"gather_mlp {blk} at {tile} rows: the library's plan "
                  f"{got}, tiling.py's {forced}")
        raw, ctr, w, bias, _, _, mask = dense_inputs(gen, dev, **shp)
        args = (raw, ctr, w, bias)
        out = gather_mlp(*args, mask=mask)
        ref = gather_mlp_ref(*args, mask=mask)
        halves = ops.split_weights(w)
        torch.cuda.synchronize()
        err, tol = max_err(out, ref)
        same = bool(torch.equal(out, gather_mlp(*args, mask=mask)))
        split_same = bool(torch.equal(halves, split_weights_ref(w)))
        parity.append(dict(name="gather_mlp", block=blk, b=b,
                           masked=shp["masked"], route="linear",
                           max_abs_err=err, tol=tol, bit_equal=same,
                           split_weights_bit_equal=split_same))
        check(err <= tol, f"gather_mlp {blk}: max|err| {err} > {tol}")
        check(same, f"gather_mlp {blk}: two calls differ")
        check(split_same, f"gather_mlp {blk}: W's split differs from "
              f"split_weights_ref")
        ms, plain_ms = time_pair(lambda: gather_mlp(*args, mask=mask),
                                 lambda: gather_mlp_ref(*args, mask=mask),
                                 iters=10)
        flops = 2 * b * s * k * d * f
        moved = nbytes(*args, mask, out)
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        shape = (f"B={b} S={s} K={k} D={d} Dc={dc} F={f} one layer "
                 f"masked={shp['masked']}")
        rows.append(dict(
            name="gather_mlp", block=blk, route="cuda",
            variant="wgmma_tf32x3_linear", tflops=flops / ms / 1e9,
            bound_fp32_ms=bound(flops, moved)[0],
            source="src/repro_torch/csrc/gather_mlp.cu",
            replaces="src/repro/kernels/gather_mlp/gather_mlp.py:239",
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None, launches=launches,
            plan=dict(ours, grid=[lp["groups"] * lp["nft"]],
                      x_by="tma" if ours["x_tma"] else "cp.async")))
        split_ms, split_plain_ms = time_pair(
            lambda: ops.split_weights(w), lambda: split_weights_ref(w),
            iters=10)
        sbms, sby = bound(0, nbytes(w, halves))
        rows.append(dict(
            name="gather_mlp", block=blk, route="cuda",
            variant="split_weights", part="the linear route's first "
            "kernel: W into its TF32 halves in scratch",
            source="src/repro_torch/csrc/gather_mlp.cu",
            replaces="src/repro/kernels/gather_mlp/gather_mlp.py:239",
            shape=f"D={d} F={f} -> {tuple(halves.shape)}", max_abs_err=0.0,
            bit_equal=split_same, ms=split_ms, plain_ms=split_plain_ms,
            bound_ms=sbms, bound_by=sby, library_ms=None,
            launches=split_launches))
    return parity, rows


def reuse_linear_rows(dev, seed, totals, x4_launches) -> tuple[list, list]:
    """hub_reuse's one-layer form at ``REUSE_LINEAR``: the wrapper's route,
    chunk, shared memory, scratch (and on the layered route its D splits)
    equal to the library's; the kernel rule (``reuse_linear_wgmma``: the
    wgmma kernel where a resident call's products reach 2^28
    multiply-adds, else the mma.sync one) and the wgmma kernel's plan
    (rows, islands a tile, groups, F tiles, N, items, stages, x by TMA or
    cp.async, shared memory, scratch) equal in tiling.py and library; the
    kernel against its plain version (1e-4 · max(1, max|plain|), the -BIG
    identity exactly) and twice bit-equal, timed in turns beside the
    plain version and beside the same block in the split-sign two-layer
    form (relu(x·[W, −W] + [b, −b])·[I; −I], Hd = 2F, the same function)
    through the same wrapper; the bound by the one layer's flops; on the
    wgmma kernel its W split into TF32 halves bit-equal to
    ``split_weights_ref`` and timed beside it.  -> (parity rows, kernel
    rows with ``launches``: the families phase's count of the row's
    kernel (``hub_reuse_linear_wgmma``) or route in one layer
    (``totals``), or at pointvector_l_blk4_c128 phase 5's pointvector_l
    forward's (``x4_launches``), and the plan; the split's rows with the
    families phase's ``hub_reuse_split_weights``)."""
    import torch
    from repro_torch.engine.fc import _split_sign
    from repro_torch.kernels import tiling
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    from repro_torch.kernels.hub_reuse import ops as hub_ops
    from repro_torch.kernels.tf32_split import split_weights_ref
    gen = torch.Generator().manual_seed(seed + 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parity, rows = [], []
    for blk, shp in REUSE_LINEAR.items():
        b, hn, c, m, k, d, f = (shp[n] for n in ("b", "hn", "c", "m", "k",
                                                 "d", "f"))
        pl = hub_ops.plan(b, hn, c, m, k, d, 0, f, dev)
        lib = hub_ops.library_plan(b, hn, c, m, k, d, 0, f)
        ours = dict(route=tiling.hub_reuse_route(b, hn, c, m, k, d, f, sms,
                                                 h=0), nsplit=0, scratch=0,
                    smem=tiling.LAYERED_SMEM)
        wgmma = ours["route"] == "resident" and tiling.reuse_linear_wgmma(
            b, hn, c, d, f)
        lp = tiling.reuse_linear_plan(b, hn, c, d, f, sms) if wgmma else None
        got = hub_ops.library_linear_plan(b, hn, c, m, k, d, f)
        check(got == lp, f"hub_reuse {blk}: the library's wgmma plan {got}, "
              f"tiling.py's {lp} (None: the mma.sync kernel or layered)")
        if ours["route"] == "layered":
            lay = tiling.hub_reuse_layered_plan(b, hn, c, 0, f, sms, d)
            ours.update(nsplit=lay["nsplit"], scratch=lay["scratch"])
        else:
            ours["smem"] = tiling.hub_reuse_smem(c, m, k, d, h=0, b=b, hn=hn,
                                                 f=f, sms=sms)
            if wgmma:
                ours["scratch"] = lp["scratch"] // 4
            check(hub_ops.library_smem(b, hn, c, m, k, d, 0, f)
                  == ours["smem"]
                  and pl["chunk"] == tiling.hub_reuse_chunk(c, m, k, d, 0),
                  f"hub_reuse {blk}: chunk {pl['chunk']} and the library's "
                  f"shared memory differ from tiling.py's {ours}")
        check(lib == ours and pl["route"] == ours["route"],
              f"hub_reuse {blk}: plan {ours} by tiling.py, {lib} by the "
              f"library, route {pl['route']} by the wrapper")
        pool, slot, comp, w, bias, _, _, live = reuse_inputs(
            gen, dev, b, hn, c, m, k, d, 0, f)
        args = (pool, slot, comp, w, bias)
        two = (pool, slot, comp, *_split_sign(w, bias))
        out = hub_reuse(*args, live=live)
        err, tol = max_err(out, hub_reuse_ref(*args, live=live))
        same = bool(torch.equal(out, hub_reuse(*args, live=live)))
        prow = dict(name="hub_reuse", block=blk, b=b, masked=True,
                    form="linear", route=pl["route"], wgmma=wgmma,
                    max_abs_err=err, tol=tol, bit_equal=same)
        check(err <= tol, f"hub_reuse {blk}: max|err| {err} > {tol}")
        check(same, f"hub_reuse {blk}: two calls differ")
        t = time_turns({"plain": lambda: hub_reuse_ref(*args, live=live),
                        "kernel": lambda: hub_reuse(*args, live=live),
                        "split_sign": lambda: hub_reuse(*two, live=live)},
                       iters=10)
        flops = 2 * b * hn * c * d * f
        moved = nbytes(*args, live, out)
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        count = ("hub_reuse_linear_wgmma" if wgmma
                 else f"hub_reuse_{pl['route']}_linear")
        launches = (x4_launches[count] if blk.endswith("_c128")
                    else totals[count])
        plan = dict(ours, chunk=pl["chunk"])
        if wgmma:                        # the wgmma kernel's tiling
            plan["linear"] = dict(
                lp, x_by="tma" if lp["x_tma"] else "cp.async",
                grid=min(lp["items"], sms * tiling.reuse_linear_blocks_per_sm(
                    lp["rows"], lp["n"])))
        rows.append(dict(
            name="hub_reuse", block=blk, route="cuda",
            variant=(f"{'wgmma' if wgmma else 'mma'}_tf32x3_linear_"
                     f"{pl['route']}"),
            tflops=flops / t["kernel"] / 1e9,
            bound_fp32_ms=bound(flops, moved)[0],
            source="src/repro_torch/csrc/hub_reuse.cu",
            replaces="src/repro/kernels/hub_reuse/hub_reuse.py:307",
            shape=f"B={b} H={hn} C={c} M={m} K={k} D={d} F={f} one layer "
                  f"live=True",
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
            bound_ms=bms, bound_by=by, library_ms=None, launches=launches,
            split_sign_ms=t["split_sign"],
            split_sign_over_ms=t["split_sign"] / t["kernel"], plan=plan))
        if wgmma:                        # its W split, once a call
            f_pad = tiling.round_up(f, tiling.REUSE_LINEAR_MAX_COLS)
            halves = hub_ops.split_weights(w)
            split_same = bool(torch.equal(halves,
                                          split_weights_ref(w, f_pad)))
            prow["split_weights_bit_equal"] = split_same
            check(split_same, f"hub_reuse {blk}: W's split differs from "
                  f"split_weights_ref")
            split_ms, split_plain_ms = time_pair(
                lambda: hub_ops.split_weights(w),
                lambda: split_weights_ref(w, f_pad), iters=10)
            sbms, sby = bound(0, nbytes(w, halves))
            rows.append(dict(
                name="hub_reuse", block=blk, route="cuda",
                variant="split_weights", part="the wgmma kernel's W into "
                "its TF32 halves in scratch, once a call",
                source="src/repro_torch/csrc/tf32_split.cuh",
                replaces="src/repro/kernels/hub_reuse/hub_reuse.py:307",
                shape=f"D={d} F={f} -> {tuple(halves.shape)}",
                max_abs_err=0.0, bit_equal=split_same, ms=split_ms,
                plain_ms=split_plain_ms, bound_ms=sbms, bound_by=sby,
                library_ms=None,
                launches=totals["hub_reuse_split_weights"]))
        parity.append(prow)
    check(sum(r["variant"].startswith("wgmma") for r in rows) == 1,
          "hub_reuse: expected the wgmma kernel at dgcnn_c's block 4 alone "
          "of REUSE_LINEAR")
    return parity, rows


def sass_by_function(name: str, *words: str) -> dict:
    """Instructions of the built ``name`` library whose SASS line holds
    every one of ``words``, by kernel (mangled name; ``cuobjdump -sass``
    once)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path(name))], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out.setdefault(fn, 0)
        elif fn and all(w in line for w in words):
            out[fn] += 1
    return out


def gather_linear_sass() -> dict:
    """The linear route's product kernels of the built gather_mlp library
    (``gather_mlp_linear_kernel<NC, N>``: both row tiles, four widths):
    each one's registers and spills (ptxas), and its TF32 HGMMA (wgmma)
    and TF32 HMMA (mma.sync) counts (SASS)."""
    from repro_torch import kernels
    hgmma = sass_by_function("gather_mlp", "HGMMA", "TF32")
    hmma = sass_by_function("gather_mlp", "HMMA", "TF32")
    return {row["kernel"]: dict(registers=row["registers"],
                                spill=row["spill"],
                                hgmma_tf32=hgmma.get(row["kernel"], 0),
                                hmma_tf32=hmma.get(row["kernel"], 0))
            for row in ptxas_kernels(kernels.BUILD_LOG["gather_mlp"])
            if "gather_mlp_linear_kernel" in row["kernel"]}


def linear_sass() -> dict:
    """The mma.sync one-layer resident kernels of the built hub_reuse
    library (``hub_reuse_kernel<L, true>``): each one's registers and
    spills (ptxas) and its TF32 HMMA count (SASS)."""
    from repro_torch import kernels
    out = {}
    for row in ptxas_kernels(kernels.BUILD_LOG["hub_reuse"]):
        if "hub_reuse_kernel" in row["kernel"] and "Lb1E" in row["kernel"]:
            out[row["kernel"]] = dict(
                registers=row["registers"], spill=row["spill"],
                hmma_tf32=sass_count("hub_reuse", "HMMA", "TF32",
                                     within=row["kernel"]))
    return out


def hub_reuse_linear_sass() -> dict:
    """The wgmma one-layer kernels of the built hub_reuse library
    (``hub_reuse_linear_kernel<NC, N>``: both row tiles, both widths):
    each one's registers and spills (ptxas), and its TF32 HGMMA (wgmma)
    and TF32 HMMA (mma.sync) counts (SASS)."""
    from repro_torch import kernels
    hgmma = sass_by_function("hub_reuse", "HGMMA", "TF32")
    hmma = sass_by_function("hub_reuse", "HMMA", "TF32")
    return {row["kernel"]: dict(registers=row["registers"],
                                spill=row["spill"],
                                hgmma_tf32=hgmma.get(row["kernel"], 0),
                                hmma_tf32=hmma.get(row["kernel"], 0))
            for row in ptxas_kernels(kernels.BUILD_LOG["hub_reuse"])
            if "hub_reuse_linear_kernel" in row["kernel"]}


def cache_x4_phase(params, batch, seed, dev) -> dict:
    """One pointnet2_c lpcn forward at the paper's Fig. 22 cache size
    (``CACHE_X4``: C = 4k, 256 rows at block 2) with the launch counts set
    to 0 just before and read just after: one gather_mlp launch a block
    and the hub_reuse launches each call's plan makes
    (``expected_launches``), no entry kernel; logits
    within 1e-4 of the "reference" backend at the same cache size.  Then
    ``CACHE_X4_FAMILIES`` likewise at the families phase's batch
    (``x4_family``).  -> (pointnet2_c's launch counts, each family's)."""
    import torch
    from repro_torch.engine import PCNEngine
    from repro_torch.models.pointnet2 import POINTNET2_C
    eng = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda",
                    isl_kw=CACHE_X4)
    ref = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="reference",
                    isl_kw=CACHE_X4)
    out, launches, cap = counted_forward(eng, params, batch)
    want = expected_launches(cap)
    check(launches == {**dict.fromkeys(launches, 0), **want},
          f"cache_x4 launches {launches}, expected {want}")
    check(bool(torch.isfinite(out).all()), "cache_x4: non-finite logits")
    err, tol = close(out, ref.apply(params, batch))
    log(json.dumps({"cache_x4": {"isl_kw": CACHE_X4, "launches": {
        k: v for k, v in launches.items() if v}, "max_abs_err": err,
        "tol": tol}}))
    check(err <= tol, f"cache_x4: cuda vs reference max|err| {err} > {tol}")
    return launches, {name: x4_family(name, seed, dev)
                      for name in CACHE_X4_FAMILIES}


def x4_family(name, seed, dev) -> dict:
    """``name`` at full width, published, in lpcn mode at ``CACHE_X4``:
    one ragged batch of the families phase's size through
    ``fc_backend="cuda"``, counted (``counted_forward``: the hub_reuse
    launches each call's plan makes, the layered route where 128 rows
    pass a block's shared memory, every one in the one-layer form), the
    logits within 1e-4 · max(1, max|ref|) of the "reference" backend.  ->
    the launch counts, hub_reuse's by route and form among them
    (``hub_reuse_<route>[_linear]``)."""
    import torch
    from repro_torch.engine import PCNEngine
    from repro_torch.models import MODEL_ZOO
    spec = MODEL_ZOO[name][1]
    b, n = FAMILIES[name]
    eng = PCNEngine(spec, mode="lpcn", fc_backend="cuda", isl_kw=CACHE_X4)
    ref = PCNEngine(spec, mode="lpcn", fc_backend="reference",
                    isl_kw=CACHE_X4)
    params = seed_biases(eng.init(seed=seed),
                         torch.Generator().manual_seed(seed + 1))
    fam, _ = family_batch(spec, b, n, seed, dev)
    out, launches, cap = counted_forward(eng, params, fam)
    forms = reuse_form_launches()
    check(forms["linear"] == launches["hub_reuse"],
          f"cache_x4 {name}: hub_reuse launches by route and form {forms}, "
          f"expected every one of one layer")
    launches = {**launches, **{f"hub_reuse_{k}": v
                               for k, v in forms.items()}}
    plans = [dict(c=r["dims"]["c"], d=r["dims"]["d"], h=r["dims"]["h"],
                  route=r["plan"]["route"], chunk=r["plan"]["chunk"])
             for r in cap if r["kernel"] == "hub_reuse"]
    err, tol = close(out, ref.apply(params, fam))
    log(json.dumps({"cache_x4": {"spec": name, "b": b, "n": n,
                                 "isl_kw": CACHE_X4, "hub_reuse": plans,
                                 "launches": {k: v for k, v in
                                              launches.items() if v},
                                 "max_abs_err": err, "tol": tol}}))
    check(err <= tol, f"cache_x4 {name}: cuda vs reference max|err| {err} "
          f"> {tol}")
    del eng, ref, params, fam, out
    free_card()
    return launches


def params_to(params, device):
    """A copy of ``params`` with every weight on ``device``."""
    from dataclasses import replace

    def mv(m):
        return None if m is None else replace(m, layers=[
            replace(d, w=d.w.to(device), b=d.b.to(device))
            for d in m.layers])
    return replace(params, blocks=tuple(mv(m) for m in params.blocks),
                   head=mv(params.head), global_mlp=mv(params.global_mlp),
                   stem=mv(params.stem),
                   extras=tuple(mv(m) for m in params.extras))


def ds_variants_phase(params, batch, smi) -> None:
    """pointnet2_c's lpcn forward under every ``DS_VARIANTS`` entry, on the
    main batch with the main path's weights: the launch counts set to 0
    just before the forward and read just after (one gather_mlp and one
    hub_reuse launch a block, no entry kernel), the logits within 1e-4 of
    the "reference" backend on the card, the stages timed; then, once
    every variant is timed (the CPU's worker threads would otherwise
    share the cores with the timed launches), stage 1 equal on the card
    and on the CPU field by field and the ``apply_with_reports`` counters
    equal on the card and on the CPU.  Prints one ``ds_variant`` line
    each."""
    from dataclasses import replace
    import torch
    from repro_torch import kernels
    from repro_torch.core.workload import COUNTERS, WorkloadReport
    from repro_torch.engine import PCNEngine, apply_with_reports
    from repro_torch.models.pointnet2 import POINTNET2_C
    off_path = ("knn", "flash_attention", "flash_attention_bwd", "ssd_chunk",
                "ssd_chunk_bwd")
    rows = {}
    for name, (sampler, neighbor, kw) in DS_VARIANTS.items():
        spec = replace(POINTNET2_C, blocks=tuple(
            replace(b, sampler=sampler, neighbor=neighbor)
            for b in POINTNET2_C.blocks))
        engine = PCNEngine(spec, mode="lpcn", fc_backend="cuda", isl_kw=kw)
        reference = PCNEngine(spec, mode="lpcn", fc_backend="reference",
                              isl_kw=kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        logits = engine.apply(params, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        nb = len(spec.blocks)
        check(launches["gather_mlp"] == launches["hub_reuse"] == nb
              and not any(launches[k] for k in off_path),
              f"ds {name}: launches {launches}, expected gather_mlp == "
              f"hub_reuse == {nb} and no entry kernel")
        check(bool(torch.isfinite(logits).all()),
              f"ds {name}: non-finite logits")
        err, tol = close(logits, reference.apply(params, batch))
        check(err <= tol, f"ds {name}: cuda vs reference max|err| {err} > "
              f"{tol}")
        stages = breakdown(params, spec, batch, isl_kw=kw)
        fwd = sum(stages.values())
        rows[name] = (spec, kw, dict(
            name=name, sampler=sampler, neighbor=neighbor, isl_kw=kw,
            device=smi, forward_ms=fwd, **stages,
            stage1_share=stages["structure_ms"] / fwd,
            launches={k: v for k, v in launches.items() if v},
            max_abs_err=err, tol=tol))
    host_params, host_batch = params_to(params, "cpu"), batch.to("cpu")
    for name, (spec, kw, row) in rows.items():
        mismatch = structure_card_vs_cpu(spec, batch, kw)
        check(not any(mismatch.values()),
              f"ds {name}: stage 1 on the card differs from the CPU: "
              f"{mismatch}")
        _, card = apply_with_reports(params, batch, spec=spec,
                                     fc_backend="cuda", isl_kw=kw)
        _, host = apply_with_reports(host_params, host_batch, spec=spec,
                                     isl_kw=kw, device="cpu")
        counters = {f: getattr(card, f).cpu() for f in COUNTERS}
        check(all(torch.equal(v, getattr(host, f))
                  for f, v in counters.items()),
              f"ds {name}: reports differ card vs CPU")
        total = WorkloadReport(*(int(v.sum()) for v in counters.values()),
                               card.k)
        log(json.dumps({"ds_variant": {
            **row, "structure_mismatches": sum(mismatch.values()),
            "fetch_saving": float(total.fetch_saving),
            "compute_saving": float(total.compute_saving),
            "counters": {f: int(v.sum()) for f, v in counters.items()},
            "reports_card_vs_cpu": "equal"}}))


def expected_launches(captured) -> dict:
    """Kernel launches the captured plans make: one a call, or one a cloud
    on a per_cloud plan; hub_reuse's resident route once per chunk of
    cache rows."""
    out = {"gather_mlp": 0, "hub_reuse": 0}
    for rec in captured:
        pl, dims = rec["plan"], rec["dims"]
        n = dims["b"] if pl["variant"] == "per_cloud" else 1
        if rec["kernel"] == "hub_reuse" and pl["chunk"]:
            n *= -(-dims["c"] // pl["chunk"])
        out[rec["kernel"]] += n
    return out


def counted_forward(engine, params, batch):
    """One forward with the launch counts set to 0 just before and read
    just after, under plans.capture(): -> (logits, counts, captured)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import plans
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with plans.capture() as cap:
        out = engine.apply(params, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(not any(counts[k] for k in ("knn", "flash_attention",
                                      "flash_attention_bwd", "ssd_chunk",
                                      "ssd_chunk_bwd")),
          f"an entry kernel launched in an FC forward: {counts}")
    check({k: counts[k] for k in ("gather_mlp", "hub_reuse")}
          == expected_launches(cap),
          f"launches {counts} against the plans' {expected_launches(cap)}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")
    return out, counts, cap


def plans_phase(params, batch, smi, seed) -> dict:
    """Tile plans, the autotuner and the per-cloud dispatch on the main
    path's FC stage (``repro_torch.kernels.plans``,
    ``repro_torch.launch.autotune``): pointnet2_c's cells at B = 8 and 2
    (``model_cells``), equal to the calls the counted forwards make; each
    cell tuned into a store of the smoke's own (every candidate timed,
    tiling.py's shared memory equal to the library's, every output within
    1e-4 of the heuristic plan's; one ``plan_cell`` line each); the
    forward under that store, and under each ``PLAN_FORCED`` knob, against
    the heuristic's logits, launches as the plans say; the
    ``"cuda_per_cloud"`` backend against ``"cuda"`` (one launch a cloud a
    dataflow a block); Mesorasi's delayed aggregation on block 1's
    structure, card vs CPU, its counters beside PointACC's islands'; the
    serving CLI under ``--kernel-kw``.  The store is emptied after, so
    the later phases run on the heuristic as the earlier ones did.  ->
    the launch counts of the phase's forwards."""
    import torch
    from repro_torch.core.workload import WorkloadReport, analyze
    from repro_torch.engine import PCNEngine, archs
    from repro_torch.engine.params import Batch
    from repro_torch.kernels import plans
    from repro_torch.launch import autotune
    from repro_torch.models import mesorasi_fc, mesorasi_workload
    from repro_torch.models.pointnet2 import POINTNET2_C
    spec = POINTNET2_C
    path = ROOT / "build" / "tile_plans_smoke.json"
    path.unlink(missing_ok=True)
    plans.configure(str(path))
    log(f"plans: store {path}")
    engine = PCNEngine(spec, mode="lpcn", fc_backend="cuda")
    batches = {B: batch, 2: Batch(*(t[:2] for t in (
        batch.xyz, batch.feats, batch.keys, batch.n_valid)))}
    launches = {}

    # 1. the cells, and the heuristic's forwards they come from
    cells, base = {}, {}
    for b in PLAN_BATCHES:
        cells[b] = autotune.model_cells(spec, b, N_PAD, seed=seed)
        log(json.dumps({"plan_cells": {"b": b, "keys": [
            plans.plan_key(k, d) for k, d in cells[b]]}}))
        base[b], counts, cap = counted_forward(engine, params, batches[b])
        check([(r["kernel"], r["dims"]) for r in cap] == cells[b],
              f"plans: the cells at B={b} differ from the forward's calls")
        check(all(r["plan"]["provenance"] == "heuristic" for r in cap),
              "plans: the empty store resolved a plan")
        launches[f"heuristic_b{b}"] = counts

    # 2. tune every cell into the store
    store = plans.active_store()
    for b in PLAN_BATCHES:
        for kernel, dims in cells[b]:
            entry = autotune.autotune_cell(kernel, dims, store=store,
                                           seed=seed)
            cands = autotune.candidate_plans(kernel, dims)
            rows = entry["candidates"]
            check(len(rows) == len(cands),
                  f"plans: {len(rows)} of {len(cands)} candidates timed")
            for row in rows:
                check(row["smem"] == row["smem_library"],
                      f"plans: {kernel} {row['knobs']}: tiling.py's smem "
                      f"{row['smem']} != the library's "
                      f"{row['smem_library']}")
                check(row["rejected"] is None,
                      f"plans: {kernel} {row['knobs']}: {row['rejected']}")
            log(json.dumps({"plan_cell": {
                "key": plans.plan_key(kernel, dims), "device": smi,
                "winner": entry.get("variant") or plans.knobs(kernel,
                                                              entry),
                "measured_ms": entry["measured_ms"],
                "heuristic": entry["heuristic"],
                "heuristic_ms": entry["heuristic_ms"],
                "per_cloud_ms": entry["per_cloud_ms"],
                "batched_ms": entry["batched_ms"],
                "candidates": [{k: row[k] for k in (
                    "knobs", "ms", "max_diff", "bit_equal", "smem",
                    "smem_library")} for row in rows]}}))
    store.save()

    # 3. the forward under the store, then under each forced knob
    for b in PLAN_BATCHES:
        out, counts, cap = counted_forward(engine, params, batches[b])
        check(all(r["plan"]["provenance"] == "autotuned" for r in cap),
              "plans: a tuned cell did not resolve from the store")
        err, tol = close(out, base[b])
        log(json.dumps({"plan_forward": {
            "b": b, "store": "autotuned", "launches": counts,
            "plans": [dict(kernel=r["kernel"], **r["plan"]) for r in cap],
            "max_abs_err": err, "tol": tol}}))
        check(err <= tol, f"plans: tuned forward B={b} {err} > {tol}")
        launches[f"autotuned_b{b}"] = counts
    with plans.bypass():
        for kw in PLAN_FORCED:
            eng = PCNEngine(spec, mode="lpcn", fc_backend="cuda",
                            kernel_kw=kw)
            out, counts, cap = counted_forward(eng, params, batch)
            knob, v = next(iter(kw.items()))
            check(all(r["plan"]["provenance"] == "override"
                      and r["plan"][knob] == v for r in cap
                      if knob in r["plan"]),
                  f"plans: kernel_kw {kw} did not reach every launch")
            err, tol = close(out, base[B])
            log(json.dumps({"plan_forward": {
                "b": B, "kernel_kw": kw, "launches": counts,
                "max_abs_err": err, "bit_equal": bool(torch.equal(
                    out, base[B])), "tol": tol}}))
            check(err <= tol, f"plans: kernel_kw {kw}: {err} > {tol}")
            launches[f"forced_{knob}{v}"] = counts

        # 4. one launch per cloud against the batched launch
        per_cloud = PCNEngine(spec, mode="lpcn", fc_backend="cuda_per_cloud")
        out, counts, cap = counted_forward(per_cloud, params, batch)
        nb = len(spec.blocks)
        check(counts["gather_mlp"] == counts["hub_reuse"] == B * nb,
              f"plans: cuda_per_cloud launches {counts}, expected {B} a "
              f"dataflow a block")
        err, tol = close(out, base[B])
        log(json.dumps({"plan_forward": {
            "b": B, "fc_backend": "cuda_per_cloud", "launches": counts,
            "max_abs_err": err, "bit_equal": bool(torch.equal(out, base[B])),
            "tol": tol}}))
        check(err <= tol, f"plans: cuda_per_cloud vs cuda {err} > {tol}")
        launches["cuda_per_cloud"] = counts

    # 5. Mesorasi's delayed aggregation on block 1's structure
    ctx = archs.EngineCtx.make("lpcn", "cuda")
    structs, _ = archs._structure_stack_b(spec, ctx, batch.xyz, batch.keys,
                                          batch.n_valid)
    st, blk = structs[0], spec.blocks[0]
    card = mesorasi_fc(params.blocks[0], batch.xyz, batch.feats, st.nbr,
                       st.center_xyz)
    host_mlp = params_to(params, "cpu").blocks[0]
    host = mesorasi_fc(host_mlp, *(t.cpu() for t in (
        batch.xyz, batch.feats, st.nbr, st.center_xyz)))
    err = (card.cpu() - host).abs().max().item()
    lim = 1e-5 * max(1.0, host.abs().max().item())
    check(card.shape == (B, blk.n_centers, blk.mlp_dims[-1])
          and bool(torch.isfinite(card).all()), "mesorasi: shape or NaN")
    # both counted over the batch: Mesorasi's PFT over each cloud's valid
    # points, the islands' counters of analyze
    fields = ("baseline_fetches", "lpcn_fetches", "baseline_mlp_evals",
              "lpcn_mlp_evals", "n_subsets", "n_islands_used")
    per = [mesorasi_workload(int(n), blk.n_centers, blk.k)
           for n in batch.n_valid.tolist()]
    meso = WorkloadReport(*(sum(getattr(r, f) for r in per)
                            for f in fields), blk.k)
    rep = analyze(st.islands, st.schedule, blk.k)
    lpcn = WorkloadReport(*(int(getattr(rep, f).sum()) for f in fields),
                          blk.k)
    log(json.dumps({"mesorasi": {
        "block": 1, "max_abs_err_card_vs_cpu": err, "tol": lim,
        **{name: {**{f: getattr(r, f) for f in fields},
                  "compute_saving": float(r.compute_saving),
                  "fetch_saving": float(r.fetch_saving)}
           for name, r in (("mesorasi", meso), ("pointacc", lpcn))}}}))
    check(err <= lim, f"mesorasi: card vs CPU {err} > {lim}")

    # 6. the serving CLI under --kernel-kw
    launches["cli_s"] = cli_phase(smi, PLAN_CLI)
    engine_repr = json.loads((ROOT / "build" / "serve_cli.json")
                             .read_text())["engine"]
    check(f"kernel_kw={PLAN_CLI_KW}" in engine_repr,
          f"plans: the CLI's engine {engine_repr} took no --kernel-kw")
    plans.configure(None)
    return launches


def device_profile(serve, batch) -> dict:
    """torch.profiler over one forward: the summed time of the kernels
    that ran on the device, the profiled host wall time, and the kernels
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kern)
    by_name: dict = {}
    for e in kern:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"profiled_wall_ms": wall_us / 1e3, "kernel_launches": len(kern),
            "device_busy_ms": busy_us / 1e3,
            "top": [{"name": k[:70], "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def knn_mismatch(d, i, d_ref, i_ref, d_next) -> tuple[float, float, int,
                                                     int]:
    """(max|Δd|, tolerance, index mismatches, index mismatches where the
    order is decided: the sorted distance differs from both neighbours in
    its row by more than the tolerance).  ``d_next`` (S, 1) is the
    (k+1)-th distance, +inf when k = N, which the k-th must clear."""
    import torch
    tol = 1e-5 * max(1.0, d_ref.abs().max().item())
    ext = torch.cat([d_ref, d_next], 1)
    gap = (ext[:, 1:] - ext[:, :-1]).abs() > tol
    decided = torch.cat([torch.ones_like(gap[:, :1]), gap[:, :-1]], 1) & gap
    wrong = i != i_ref
    return ((d - d_ref).abs().max().item(), tol, int(wrong.sum()),
            int((wrong & decided).sum()))


def flash_flops(b, hq, sq, skv, d, causal) -> float:
    """2·D flops per (query, visible key) pair for each of q·kᵀ and p·v."""
    if causal:                         # top-left: row i sees min(i+1, Skv)
        m = min(sq, skv)
        pairs = m * (m + 1) // 2 + (sq - m) * skv
    else:
        pairs = sq * skv
    return 4.0 * b * hq * pairs * d


def flash_err(out, ref) -> dict:
    """max |out − ref|, |ref| where it sits, and ‖out − ref‖ / ‖ref‖."""
    diff = (out.float() - ref.float()).flatten()
    i = diff.abs().argmax()
    return dict(max_abs_err=diff[i].abs().item(),
                ref_at_max=ref.flatten()[i].abs().item(),
                rel_err=(diff.norm() / ref.float().norm()).item())


def at_offset(t, off):
    """``t`` copied into a flat buffer at an offset of ``off`` elements: a
    contiguous operand whose address is not 16-byte aligned."""
    flat = t.new_empty(t.numel() + off)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


def entry_inputs(gen, dev):
    """Full-width inputs of flash_attention (bf16, the same bf16 at an
    address off 16 bytes, f32) and ssd_chunk, drawn on the card from
    ``gen``; ssd as tests/test_kernels.py draws them (dt in [0.1, 1], cum
    a negative cumulative sum over the chunk)."""
    import torch
    f = QWEN2_72B
    qkv = {}
    for dt in (torch.bfloat16, torch.float32):
        qkv[str(dt).replace("torch.", "")] = tuple(
            torch.randn((f["b"], h, f["s"], f["d"]), generator=gen,
                        device=dev).to(dt)
            for h in (f["hq"], f["hkv"], f["hkv"]))
    qkv["bfloat16_unaligned"] = tuple(at_offset(t, 1)
                                      for t in qkv["bfloat16"])
    ssd = {name: ssd_inputs(gen, dev, **m) for name, m in SSD_LAYERS.items()}
    return qkv, ssd


def ssd_inputs(gen, dev, bs, nc, q, h, p, s):
    """ssd_chunk's inputs as tests/test_kernels.py draws them: dt in
    [0.1, 1], cum a negative cumulative sum over the chunk."""
    import torch
    lead = (bs, nc, q)
    u = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    return (torch.randn((*lead, h, p), generator=gen, device=dev),
            torch.randn((*lead, s), generator=gen, device=dev),
            torch.randn((*lead, s), generator=gen, device=dev),
            u(0.1, 1.0, (*lead, h)),
            -torch.cumsum(u(0.01, 0.2, (*lead, h)), dim=2))


def main_batch(seed, dev):
    """The main path's (8, 1024) batch of seeded ModelNet-sized clouds."""
    import numpy as np
    import torch
    from repro_torch import random
    from repro_torch.engine import Batch
    rng = np.random.default_rng(seed)
    return Batch.from_clouds(
        make_requests(rng, B), key=random.fold_in(
            random.PRNGKey(seed, dev), torch.arange(B, device=dev)),
        n_pad=N_PAD, device=dev)


def knn_call_sets(spec, batch, seed, dev) -> dict:
    """knn's calls, named: stage 1 of ``batch`` (block 1: each cloud's
    centers against its points; block 2: its block-2 centers against its
    block-1 centers; one call a cloud), block 1's calls again at k = 96
    and 300, and dgcnn_s's kNN (one seeded S3DIS-like cloud of 8192
    points against itself, k = 20)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import make_cloud
    from repro_torch.engine import archs
    ctx = archs.EngineCtx.make("lpcn", "cuda")
    structs, _ = archs._structure_stack_b(spec, ctx, batch.xyz, batch.keys,
                                          batch.n_valid)
    nv = batch.n_valid.tolist()
    sets = {
        "blk1": [(structs[0].center_xyz[i].contiguous(),
                  batch.xyz[i, :nv[i]].contiguous(), spec.blocks[0].k)
                 for i in range(len(nv))],
        "blk2": [(structs[1].center_xyz[i].contiguous(),
                  structs[0].center_xyz[i].contiguous(), spec.blocks[1].k)
                 for i in range(len(nv))]}
    for k in KNN_WIDE_K:
        sets[f"blk1_k{k}"] = [(c, p, k) for c, p, _ in sets["blk1"]]
    cloud = torch.from_numpy(make_cloud(np.random.default_rng(seed),
                                        DGCNN_S_KNN["n"], scene_like=True))
    cloud = cloud.to(dev)
    sets["dgcnn_s"] = [(cloud, cloud, DGCNN_S_KNN["k"])]
    return sets, structs


def device_ms(fn, name: str, iters: int = 10,
              per_call: int | None = None) -> float | None:
    """Device time of the kernels whose name holds ``name``, per call of
    ``fn`` (torch.profiler's CUDA kernel time over ``iters`` calls after
    a warm-up); None where the profiler recorded no such kernel.  With
    ``per_call`` (the matching launches a call makes), the mean of the
    events recorded times ``per_call``, so that events the profiler drops
    (a session can lose some or all of its kernel records) bias
    nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    if not us:
        return None
    if per_call:
        return sum(us) / len(us) * per_call / 1e3
    return sum(us) / iters / 1e3


def pass_ms(fn, name: str, tries: int = 3) -> float | None:
    """``device_ms`` of a kernel ``fn`` launches once a call, profiled
    again (up to ``tries`` sessions) where a session records none."""
    for _ in range(tries):
        ms = device_ms(fn, name, per_call=1)
        if ms is not None:
            return ms
    return None


def flash_row(layer: str, f: dict, name: str, q, k, v, out):
    """flash_attention at an attention layer ``f`` (causal, Sq = Skv): the
    kernel's output ``out`` on q, k, v held against the plain version by
    ``FLASH_TOL``, then kernel, plain version and SDPA timed in turns
    (``library_ms`` None, with SDPA's reason, where no SDPA backend takes
    the call).  -> (parity row, ``kernels`` row without launches).  f32
    rows are bound by 3xTF32 (three TF32 products at the TF32 peak), with
    the fp32 CUDA-core bound beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import _variant
    dt = q.dtype
    variant = _variant(dt, f["d"], [t.data_ptr() for t in (q, k, v)])
    tol, rel_tol = FLASH_TOL[str(dt).replace("torch.", "")]
    e = flash_err(out, attention_ref(q, k, v, causal=True))
    check(bool(torch.isfinite(out).all()),
          f"flash_attention {layer} {name}: non-finite")
    check(e["max_abs_err"] <= tol and e["rel_err"] <= rel_tol,
          f"flash_attention {layer} {name}: {e}, limits {tol}, {rel_tol}")
    parity = dict(name="flash_attention", shape=layer, dtype=name,
                  variant=variant, causal=True, **e, tol=tol,
                  rel_tol=rel_tol)
    fns = {"plain": lambda: attention_ref(q, k, v, causal=True),
           "kernel": lambda: flash_attention(q, k, v, causal=True),
           "library": lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)}
    refused = None
    try:
        fns["library"]()
    except RuntimeError as err:        # no SDPA backend takes the call
        refused = str(err).splitlines()[0]
        del fns["library"]
    t = time_turns(fns, iters=10)
    flops = flash_flops(f["b"], f["hq"], f["s"], f["s"], f["d"], True)
    moved = nbytes(q, k, v, out)
    extra = {}
    if dt == torch.bfloat16:
        bms, by = bound(flops, moved, PEAK_BF16)
    else:
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        extra["bound_fp32_ms"] = bound(flops, moved)[0]
    if refused:
        extra["library_refused"] = refused
    row = dict(
        name="flash_attention", block=f"{layer}_{name}", route="cuda",
        variant=variant, tflops=flops / t["kernel"] / 1e9,
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:77",
        shape=f"B={f['b']} Hq={f['hq']} Hkv={f['hkv']} Sq=Skv={f['s']} "
              f"D={f['d']} causal {name}",
        max_abs_err=e["max_abs_err"], rel_err=e["rel_err"], ms=t["kernel"],
        plain_ms=t["plain"], bound_ms=bms, bound_by=by,
        library_ms=t.get("library"), **extra)
    return parity, row


def knn_rows(knn_sets, knn_out, structs):
    """knn's parity and timed rows: each named set of calls held against
    the plain version (distances within 1e-5 · max(1, max|d|), indices
    equal wherever the distance order is decided; the main path's blocks
    also against stage 1's neighbours), then timed: wall (``ms``, CUDA
    events around the calls, host gaps included) and the kernel's own
    time (``device_ms``, torch.profiler); then the integer-grid cases of
    ``KNN_TIES``, where every index must equal the plain version's."""
    import torch
    from repro_torch.kernels.knn import knn, knn_ref
    from repro_torch.kernels.knn.ops import plan
    parity, rows = [], []
    for name, calls in knn_sets.items():
        err, tol, wrong, decided_wrong, vs_stage1 = 0.0, 0.0, 0, 0, 0
        for cloud, ((c, p, k), (d, i)) in enumerate(zip(calls,
                                                        knn_out[name])):
            d_ext, i_ext = knn_ref(c, p, min(k + 1, p.shape[0]))
            d_next = (d_ext[:, k:] if k < p.shape[0]
                      else torch.full_like(d_ext[:, :1], float("inf")))
            e, t, w, dw = knn_mismatch(d, i, d_ext[:, :k], i_ext[:, :k],
                                       d_next)
            check(e <= t, f"knn {name} call {cloud}: max|err| {e} > {t}")
            err, tol = max(err, e), max(tol, t)
            wrong, decided_wrong = wrong + w, decided_wrong + dw
            if name in ("blk1", "blk2"):
                nbr = structs[int(name[-1]) - 1].nbr[cloud]
                vs_stage1 += int((nbr != i.long()).any(-1).sum())
        row = dict(name="knn", block=name, max_abs_err=err, tol=tol,
                   idx_mismatch=wrong, idx_mismatch_decided=decided_wrong)
        if name in ("blk1", "blk2"):
            row["rows_differing_from_stage1_nbr"] = vs_stage1
        parity.append(row)
        check(decided_wrong == 0, f"knn {name}: {decided_wrong} indices "
              f"differ where the distance order is decided")
        ms, plain_ms = time_pair(lambda: [knn(*a) for a in calls],
                                 lambda: [knn_ref(*a) for a in calls])
        dev_ms = device_ms(lambda: [knn(*a) for a in calls], "knn_kernel")
        n_pts = [a[1].shape[0] for a in calls]
        s, k = calls[0][0].shape[0], calls[0][2]
        # 9 flops a (center, point) pair: c·p and the expanded form
        flops = sum(9.0 * s * n for n in n_pts)
        nbytes_ = sum(4 * (3 * s + 3 * n + 2 * s * k) for n in n_pts)
        bms, by = bound(flops, nbytes_)
        rows.append(dict(
            name="knn", block=name, route="cuda",
            source="src/repro_torch/csrc/knn.cu",
            replaces="src/repro/kernels/knn/knn.py:86",
            shape=f"{len(calls)} call(s), one per cloud: S={s} "
                  f"N={min(n_pts)}..{max(n_pts)} k={k}",
            plan=plan(s, max(n_pts), k), max_abs_err=err, ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None))
    gen = torch.Generator(device=knn_out["blk1"][0][0].device)
    gen.manual_seed(1)
    for s, n, k in KNN_TIES:
        c, p = (torch.randint(0, 8, (m, 3), generator=gen,
                              device=gen.device).float() for m in (s, n))
        d, i = knn(c, p, k)
        d0, i0 = knn_ref(c, p, k)
        wrong = int((i != i0).sum())
        parity.append(dict(name="knn", block=f"ties S={s} N={n} k={k}",
                           plan=plan(s, n, k), idx_mismatch=wrong,
                           dists_equal=bool(torch.equal(d, d0))))
        check(wrong == 0 and bool(torch.equal(d, d0)), f"knn ties S={s} "
              f"N={n} k={k}: {wrong} indices differ from the plain version")
    return parity, rows


def ssd_held(shape, args, out, parity) -> float:
    """ssd_chunk's ``out`` on ``args`` against the plain version: y_in and
    the states within 2e-4 · max(1, max|plain|), the JAX package's own
    tolerance; a parity row each appended to ``parity``.  -> the larger
    max |Δ|."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref
    worst = 0.0
    for part, o, r in zip(("y_in", "states"), out, ssd_chunk_ref(*args)):
        e = (o - r).abs().max().item()
        t = 2e-4 * max(1.0, r.abs().max().item())
        parity.append(dict(name="ssd_chunk", shape=shape, part=part,
                           max_abs_err=e, tol=t))
        check(e <= t, f"ssd_chunk {shape} {part}: max|err| {e} > {t}")
        worst = max(worst, e)
    return worst


def ssd_row(block, args, out, parity) -> dict:
    """ssd_chunk held (``ssd_held``) and timed against its plain version
    on ``args``, with its bound: a ``kernels`` row without launches."""
    from repro_torch.kernels import BUILD_LOG
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
    bs, nc, q, h, p = args[0].shape
    s = args[1].shape[-1]
    shape = f"bs={bs} nc={nc} q={q} H={h} P={p} S={s}"
    err = ssd_held(block, args, out, parity)
    ms, plain_ms = time_pair(lambda: ssd_chunk(*args),
                             lambda: ssd_chunk_ref(*args))
    # C·Bᵀ once a chunk; M·x over the q(q+1)/2 pairs i >= j and the
    # state product per head; 3xTF32: three TF32 products for each
    flops = 2.0 * bs * nc * (q * q * s + h * p * (q * (q + 1) // 2 + s * q))
    moved = nbytes(*args, *out)
    bms, by = bound(3 * flops, moved, PEAK_TF32)
    return dict(
        name="ssd_chunk", block=block, route="cuda",
        source="src/repro_torch/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk/ssd_chunk.py:64", shape=shape,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        bound_fp32_ms=bound(flops, moved)[0], library_ms=None,
        sass_count=sass_count("ssd_chunk", "HMMA", "TF32"),
        spill_bytes=spilled_bytes(BUILD_LOG["ssd_chunk"]))


def ssd_rows(ssd_args, ssd_out, gen, dev):
    """ssd_chunk's parity and timed rows at each layer of ``SSD_LAYERS``,
    the TF32 HMMA count and ptxas's spills of its library beside each, and
    the ragged ``SSD_PARITY`` shapes."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    parity = []
    rows = [ssd_row(name, ssd_args[name], ssd_out[name], parity)
            for name in SSD_LAYERS]
    for shp in SSD_PARITY:
        args = ssd_inputs(gen, dev, *shp)
        ssd_held("bs={} nc={} q={} H={} P={} S={}".format(*shp), args,
                 ssd_chunk(*args), parity)
    return parity, rows


def entry_phase(dev, seed, spec, batch):
    """The three entry-point kernels.  Drive each once at full width with
    the launch counts reset (knn on ``knn_call_sets``: stage 1 of
    ``batch``, every cloud, both blocks, block 1 at k = 96 and 300, and
    dgcnn_s's cloud; flash_attention at a Qwen2-72B layer in bf16,
    unaligned bf16 and f32; ssd_chunk at Mamba2-2.7B with chunks of 64 and
    128), read the counts (each wrapper exactly once a call), then hold
    each output against its plain version, run the parity cases and time
    every shape.  -> (launch counts, parity rows, kernel rows without
    launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import _variant
    from repro_torch.kernels.knn import knn
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    knn_sets, structs = knn_call_sets(spec, batch, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv, ssd_args = entry_inputs(gen, dev)
    torch.cuda.synchronize()

    # ---- the entry points, once each, counted ---------------------------
    kernels.reset_launch_counts()
    knn_out = {name: [knn(*a) for a in calls]
               for name, calls in knn_sets.items()}
    flash_out = {key: flash_attention(*a, causal=True)
                 for key, a in qkv.items()}
    ssd_out = {name: ssd_chunk(*a) for name, a in ssd_args.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {"gather_mlp": 0, "hub_reuse": 0,
            "knn": sum(len(calls) for calls in knn_sets.values()),
            "flash_attention": len(qkv), "flash_attention_bwd": 0,
            "ssd_chunk": len(ssd_args), "ssd_chunk_bwd": 0}
    check(launches == want, f"entry phase launches {launches}, expected "
          f"one a call: {want}")
    routes = {v: kernels.LAUNCHES[f"flash_attention_{v}"]
              for v in ("wgmma", "mma")}
    log(json.dumps({"flash_attention_routes": routes}))
    check(routes == {"wgmma": 1, "mma": 2}, f"flash_attention routes "
          f"{routes}: bf16 should take wgmma, unaligned bf16 and f32 mma")

    # ---- knn --------------------------------------------------------------
    parity, rows = knn_rows(knn_sets, knn_out, structs)
    # ---- flash_attention ---------------------------------------------------
    for name, (q, k, v) in qkv.items():
        p_row, k_row = flash_row("qwen2_72b", QWEN2_72B, name, q, k, v,
                                 flash_out[name])
        parity.append(p_row)
        rows.append(k_row)
    # a gemma_7b layer (head_dim 256, the mma route), outside the counted
    # run: the routes above stay those of the Qwen2-72B layer
    g = GEMMA_7B
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((g["b"], h, g["s"], g["d"]), generator=gen,
                               device=dev).to(dt)
                   for h in (g["hq"], g["hkv"], g["hkv"]))
        p_row, k_row = flash_row("gemma_7b", g, str(dt)[6:], q, k, v,
                                 flash_attention(q, k, v, causal=True))
        parity.append(p_row)
        rows.append(k_row)
    for b, hq, hkv, sq, skv, d, causal, name in FLASH_PARITY:
        dt = getattr(torch, name)
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dt)
        variant = _variant(dt, d, [t.data_ptr() for t in (q, k, v)])
        before = kernels.LAUNCHES[f"flash_attention_{variant}"]
        out = flash_attention(q, k, v, causal=causal)
        check(kernels.LAUNCHES[f"flash_attention_{variant}"] == before + 1,
              f"flash_attention parity D={d} {name}: not on route {variant}")
        ref = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "flash_attention: non-finite")
        e = flash_err(out, ref)
        tol, rel_tol = FLASH_TOL[name]
        parity.append(dict(name="flash_attention",
                           shape=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} "
                                 f"Skv={skv} D={d}",
                           dtype=name, variant=variant, causal=causal, **e,
                           tol=tol, rel_tol=rel_tol))
        check(e["max_abs_err"] <= tol and e["rel_err"] <= rel_tol,
              f"flash_attention parity {parity[-1]['shape']} {name} "
              f"causal={causal}: {e}, limits {tol}, {rel_tol}")
    # ---- ssd_chunk ---------------------------------------------------------
    p_rows, k_rows = ssd_rows(ssd_args, ssd_out, gen, dev)
    return launches, parity + p_rows, rows + k_rows


def lm_batch(cfg, b, s, gen, dev) -> dict:
    """Random tokens (b, s + 1) and, for the VLM and audio families, the
    stubbed patch / frame embeddings in the model dtype."""
    import torch
    from repro_torch.lm.transformer import dtype_of
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                                     device=dev)}
    extra = {"vlm": ("patches", cfg.prefix_tokens),
             "audio": ("frames", cfg.enc_seq)}.get(cfg.family)
    if extra:
        batch[extra[0]] = (0.02 * torch.randn(
            (b, extra[1], cfg.d_model), generator=gen, device=dev)
        ).to(dtype_of(cfg))
    return batch


@contextlib.contextmanager
def lm_kernels(flash, ssd):
    """The LM modules' kernel calls (``nn.attention.flash_attention``,
    ``nn.ssm.ssd_chunk``) replaced for the block's duration."""
    from repro_torch.nn import attention, ssm
    saved = attention.flash_attention, ssm.ssd_chunk
    attention.flash_attention, ssm.ssd_chunk = flash, ssd
    try:
        yield
    finally:
        attention.flash_attention, ssm.ssd_chunk = saved


def plain_route():
    """Each LM kernel's plain version routed in where the kernel runs."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref
    return lm_kernels(attention_ref, ssd_chunk_ref)


def ssd_rounding_noise(cfg, params, batch, plain, dev, seed) -> float:
    """‖Δ‖ / ‖plain‖ of the plain route's prefill logits when ssd_chunk's
    f32 y_in is multiplied by (1 + 1e-7·N(0, 1)): how far a kernel whose
    f32 output differs at the level of its rounding moves the model's
    logits by itself."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref
    from repro_torch.lm import steps
    noise = torch.Generator(device=dev).manual_seed(seed + 1)

    def perturbed(*args):
        y, states = ssd_chunk_ref(*args)
        eps = torch.randn(y.shape, generator=noise, device=dev)
        return y * (1 + 1e-7 * eps), states
    with lm_kernels(attention_ref, perturbed):
        moved = steps.make_prefill_step(cfg)(params, batch)
    return rel_err(moved, plain)


def first_inputs(store: dict):
    """The kernels run as they do, the arguments of each one's first call
    kept in ``store`` (name -> (args, kwargs))."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    def kept(name, fn):
        def call(*args, **kw):
            store.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call
    return lm_kernels(kept("flash_attention", flash_attention),
                      kept("ssd_chunk", ssd_chunk))


def lm_routes(cfg) -> dict:
    """Where each attention / mixer kind of ``cfg`` runs its core."""
    from repro_torch.nn.attention import attention_route
    if cfg.family == "audio":
        return {"encoder": attention_route("bidir", cfg.hd),
                "decoder": attention_route("causal", cfg.hd),
                "cross": "plain", "decode": "plain"}
    prefix = cfg.prefix_tokens if cfg.family == "vlm" else 0
    routes = {}
    for kind in dict.fromkeys(cfg.mixer_of(i) for i in range(cfg.n_layers)):
        routes[kind] = {
            "attn": attention_route("causal", cfg.hd, prefix,
                                    cfg.logits_softcap),
            "local": "plain", "rglru": "plain",
            "ssd": "ssd_chunk"}[kind]
    routes["decode"] = "plain"
    return routes


def rel_err(got, ref) -> float:
    """‖got − ref‖ / ‖ref‖ in float32."""
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def lm_bounds(cfg, params, b, s) -> dict:
    """The least time one prefill of (b, s) tokens and one decode step at
    batch b could take: products (2 flops a weight a token through it; the
    MoE's top-k experts a token; the head at the last position only; q·kᵀ
    and p·v over the visible pairs; the SSD chunks' quadratic form) at the
    bf16 peak, against the weights read once at the HBM rate (a prefill:
    all of them, every expert taking tokens at these sizes; a decode step:
    the routed experts' share, not Whisper's encoder)."""
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    attn_w = d * hd * (h + 2 * cfg.n_kv) + h * hd * d
    head = 2 * b * d * cfg.vocab
    causal = lambda n, w=None: (n * (n + 1) / 2 if w is None or w >= n
                                else w * (w + 1) / 2 + (n - w) * w)
    if cfg.family == "audio":
        t = cfg.enc_seq
        enc_w = attn_w + 2 * d * cfg.d_ff
        kv_w = 2 * d * hd * cfg.n_kv           # cross K/V, over the frames
        dec_w = 2 * attn_w + 2 * d * cfg.d_ff - kv_w
        flops = (2 * b * (cfg.enc_layers * enc_w * t
                          + cfg.n_layers * (dec_w * s + kv_w * t))
                 + 4 * b * h * hd * (cfg.enc_layers * t * t
                                     + cfg.n_layers * (causal(s) + s * t))
                 + head)
        step_bytes = tree_bytes(params) - tree_bytes(params["enc_layers"])
    else:
        n = s + (cfg.prefix_tokens if cfg.family == "vlm" else 0)
        emb = cfg.vocab * d * (1 if cfg.tie_embed else 2)
        flops = 2 * b * n * (cfg.param_counts()["active"] - emb) + head
        for i in range(cfg.n_layers):
            kind = cfg.mixer_of(i)
            if kind in ("attn", "local"):
                w = cfg.local_window if kind == "local" else None
                flops += 4 * b * h * hd * causal(n, w)
            elif kind == "ssd":
                q = min(cfg.ssd_chunk, n)
                hp, st = cfg.d_inner, cfg.ssm_state
                flops += 2 * b * (n // q) * (q * q * st + hp * (
                    q * (q + 1) // 2 + 2 * st * q))
        step_bytes = tree_bytes(params)
        for lp in params["layers"]:
            ffn = lp.get("ffn", {})
            if "router" in ffn:                # the unrouted experts
                experts = sum(tree_bytes(ffn[k]) for k in
                              ("w_in", "w_out", "w_gate") if k in ffn)
                step_bytes -= experts * (1 - cfg.moe_top_k
                                         / cfg.moe_experts)
    ms, by = bound(flops, tree_bytes(params),
                   PEAK_BF16 if cfg.dtype == "bfloat16" else PEAK_FP32)
    return dict(prefill_flops=flops, prefill_bound_ms=ms,
                prefill_bound_by=by,
                decode_bound_ms=step_bytes / PEAK_BYTES * 1e3)


def free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_prefill(cfg, params, batch, label, repeats=2):
    """One prefill (``steps.make_prefill_step``) with the launch counts
    reset, checked against the launches its routes name and for finite
    logits, then timed (best of ``repeats``, host clock to a sync).  ->
    (last-position logits, launches, ms)."""
    import torch
    from repro_torch import kernels
    from repro_torch.lm import model_zoo, steps
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = prefill(params, batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {**dict.fromkeys(launches, 0), **model_zoo.prefill_launches(cfg)}
    check(launches == want, f"lm {label}: prefill launches {launches}, its "
          f"routes name {want}")
    check(bool(torch.isfinite(out.float()).all()),
          f"lm {label}: non-finite prefill logits")
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return out, launches, best


def lm_decode(cfg, params, tokens, cache, start, label):
    """Decode ``tokens`` (B, T) teacher-forced from position ``start``,
    then ``LM_GEN`` greedy tokens, with the launch counts reset (a decode
    step launches no kernel).  -> (the teacher-forced steps' logits
    (B, T, V), generated tokens, ms a teacher-forced step, ms a generated
    token)."""
    import torch
    from repro_torch import kernels
    from repro_torch.lm import steps
    step = steps.make_decode_step(cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    forced = []
    for i in range(tokens.shape[1]):
        nxt, logits, cache = step(params, tokens[:, i], cache, start + i)
        forced.append(logits)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for g in range(LM_GEN):
        nxt, logits, cache = step(params, nxt, cache,
                                  start + tokens.shape[1] + g)
        out.append(nxt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    check(not any(launches.values()), f"lm {label}: decode launched "
          f"{launches}")
    check(bool(torch.isfinite(logits.float()).all()),
          f"lm {label}: non-finite decode logits")
    return (torch.stack(forced, 1), torch.stack(out, 1),
            1e3 * (t1 - t0) / tokens.shape[1], 1e3 * (t2 - t1) / LM_GEN)


def lm_main(arch, dev, seed, smi, inputs) -> tuple[dict, dict]:
    """olmo-1b or mamba2-2.7b at full width (``LM_PREFILL``): in float32
    and in bfloat16, a counted prefill held against the plain route; the
    prompt through decode against the prefill forward (bfloat16's
    decode times are the served numbers).  The first kernel call's
    arguments go into ``inputs[dtype]``.  -> (the ``lm`` line, launches
    of the counted prefills)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.lm import model_zoo as zoo
    from repro_torch.lm import steps
    from repro_torch.lm import transformer as tfm
    line = dict(lm=arch, n_layers=get_config(arch).n_layers, reduced=[],
                routes=lm_routes(get_config(arch)), batch=LM_PREFILL["b"],
                seq=LM_PREFILL["s"], card=smi)
    total, f32 = {}, {}
    for dtype in ("float32", "bfloat16"):
        # one seed: the bf16 weights are the f32 ones rounded, the tokens
        # the same
        cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = zoo.init(gen, cfg, dev)
        batch = lm_batch(cfg, LM_PREFILL["b"], LM_PREFILL["s"], gen, dev)
        with first_inputs(inputs.setdefault(dtype, {})):
            out, launches, ms = lm_prefill(cfg, params, batch,
                                           f"{arch} {dtype}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        with plain_route():
            plain = steps.make_prefill_step(cfg)(params, batch)
        err = (out.float() - plain.float()).abs().max().item()
        scale = max(1.0, plain.float().abs().max().item())
        rel = rel_err(out, plain)
        # the prompt through decode against the forward there
        prompt = batch["tokens"][:, :LM_PROMPT]
        with torch.no_grad():
            full, _ = tfm.forward(cfg, params, tokens=prompt)
        cache = zoo.make_cache(cfg, params, LM_PREFILL["b"],
                               LM_PROMPT + LM_GEN, device=dev)
        forced, gen_toks, forced_ms, gen_ms = lm_decode(
            cfg, params, prompt, cache, 0, f"{arch} {dtype}")
        worst = ((forced.float() - full.float()).abs()
                 - LM_DECODE_TOL * full.float().abs()).max().item()
        d_rel = rel_err(forced, full)
        row = dict(
            prefill_launches={k: v for k, v in launches.items() if v},
            prefill_ms=ms,
            prefill_tokens_per_s=LM_PREFILL["b"] * LM_PREFILL["s"] / ms * 1e3,
            vs_plain_max_abs_err=err, plain_scale=scale,
            vs_plain_rel_err=rel,
            decode_vs_forward_excess=worst, decode_vs_forward_rel=d_rel,
            prompt_ms_per_step=forced_ms, decode_ms_per_token=gen_ms,
            generated=gen_toks[0, :8].tolist(),
            **lm_bounds(cfg, params, LM_PREFILL["b"], LM_PREFILL["s"]))
        if dtype == "float32":
            f32 = dict(plain=plain.float(), full=full.float())
            check(err <= LM_F32_TOL * scale, f"lm {arch} f32 prefill: "
                  f"max|Δ| {err} > {LM_F32_TOL} · {scale}")
            if arch == "olmo-1b":
                check(worst <= LM_DECODE_TOL, f"lm {arch} f32: decode "
                      f"logits off the forward's by {worst} past rtol·|ref|")
        else:
            # bf16's own error: the plain route against the f32 model
            row["plain_vs_f32_rel"] = cost = rel_err(plain, f32["plain"])
            row["forward_vs_f32_rel"] = fcost = rel_err(full, f32["full"])
            if launches["ssd_chunk"]:
                row["ssd_rounding_noise_rel"] = ssd_rounding_noise(
                    cfg, params, batch, plain, dev, seed)
            check(rel <= max(LM_BF16_REL, cost), f"lm {arch} bf16 prefill: "
                  f"‖Δ‖/‖plain‖ {rel} > {LM_BF16_REL} and > bf16's own "
                  f"{cost}")
            if arch == "olmo-1b":
                check(d_rel <= max(LM_BF16_REL, fcost), f"lm {arch} bf16: "
                      f"decode off the forward by ‖Δ‖/‖ref‖ {d_rel} > "
                      f"{LM_BF16_REL} and > bf16's own {fcost}")
        line[dtype] = row
        del params, batch, out, plain, full, cache, forced
        free_card()
    return line, total


def lm_once(arch, dev, seed, smi) -> tuple[dict, dict]:
    """One config in its own bfloat16 at full width (``LM_CUT``'s configs
    cut to fewer layers): a counted prefill (``LM_ONCE_RUN``) and decode
    steps.  -> (the ``lm`` line, launches of the prefill)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.lm import model_zoo as zoo
    cfg = get_config(arch)
    reduced = []
    if arch in LM_CUT:
        reduced.append(f"n_layers {cfg.n_layers} -> {LM_CUT[arch]}")
        cfg = dataclasses.replace(cfg, n_layers=LM_CUT[arch])
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = zoo.init(gen, cfg, dev)
    r = LM_ONCE_RUN
    batch = lm_batch(cfg, r["b"], r["s"], gen, dev)
    out, launches, ms = lm_prefill(cfg, params, batch, arch)
    with torch.no_grad():
        cache = zoo.make_cache(cfg, params, r["b"], r["cache_len"],
                               frames=batch.get("frames"), device=dev)
    _, _, step_ms, gen_ms = lm_decode(cfg, params,
                                      batch["tokens"][:, :r["steps"]], cache,
                                      0, arch)
    line = dict(lm=arch, n_layers=cfg.n_layers, reduced=reduced,
                routes=lm_routes(cfg), batch=r["b"], seq=r["s"],
                prefill_launches={k: v for k, v in launches.items() if v},
                prefill_ms=ms,
                prefill_tokens_per_s=r["b"] * r["s"] / ms * 1e3,
                decode_ms_per_token=gen_ms, prompt_ms_per_step=step_ms,
                params_gb=tree_bytes(params) / 1e9,
                **lm_bounds(cfg, params, r["b"], r["s"]), card=smi)
    del params, batch, out, cache
    free_card()
    return line, launches


def lm_cli(smi) -> float:
    """``python -m repro_torch.launch.serve <LM_CLI>`` in a subprocess at
    full width: exit 0, the generated (4, 16) tokens, every timed line
    beginning with the card's name.  -> s."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *LM_CLI], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    dt = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"cli: {line}")
    check(res.returncode == 0, f"the LM serving CLI exited "
          f"{res.returncode}:\n{res.stderr[-3000:]}")
    first = res.stdout.splitlines()[0]
    check(smi.startswith(first.split(":")[0]) and "(4, 16) tokens" in first,
          f"the LM serving CLI's report: {first}")
    return dt


def lm_phase(dev, seed, smi) -> tuple[dict, list, list]:
    """Phase 8, the LM serving side: ``lm_main`` on ``LM_MAIN``,
    ``lm_once`` on ``LM_ONCE``, an ``lm`` line each; the kernels at the
    inputs the olmo-1b / mamba2-2.7b prefills gave them, held and timed
    (``flash_row``, ``ssd_row``); the CLI.  -> (flash_attention and
    ssd_chunk launches over the phase's counted prefills, parity rows,
    ``kernels`` rows without launches)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.configs import get_config
    total, parity, rows = {}, [], []
    for arch in LM_MAIN:
        inputs = {}
        line, launches = lm_main(arch, dev, seed, smi, inputs)
        log(json.dumps(line))
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        cfg = get_config(arch)
        block = arch.replace("-", "_").replace(".", "p") + "_prefill"
        for dtype, got in inputs.items():
            if "flash_attention" in got:
                (q, k, v), kw = got["flash_attention"]
                f = dict(b=q.shape[0], hq=q.shape[1], hkv=k.shape[1],
                         s=q.shape[2], d=q.shape[3])
                p_row, k_row = flash_row(block, f, dtype, q, k, v,
                                         flash_attention(q, k, v, **kw))
                parity.append(p_row)
                rows.append(k_row)
            if "ssd_chunk" in got and dtype == "bfloat16":
                args, _ = got["ssd_chunk"]
                rows.append(ssd_row(block, args, ssd_chunk(*args), parity))
        del inputs
        free_card()
    for arch in LM_ONCE:
        line, launches = lm_once(arch, dev, seed, smi)
        log(json.dumps(line))
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    lm_cli(smi)
    return total, parity, rows


def bwd_flops(b, hq, sq, skv, d, causal) -> float:
    """The gradient's five products (S, dP, dV, dK, dQ): 2.5× the
    forward's two, over the visible pairs."""
    return 2.5 * flash_flops(b, hq, sq, skv, d, causal)


def bwd_row(name: str, f: dict, dtype, dev, seed: int):
    """flash_attention_backward at an attention layer ``f`` (b, hq, hkv,
    s, d, causal): q, k, v and dO drawn from ``seed``, o and the
    log-sum-exp from the forward kernel; dq, dk, dv held against
    ``attention_bwd_ref`` on the same inputs (``BWD_TOL``), on the route
    ``_variant`` names (counted per pass), two calls bit-equal and equal
    to the call that leaves the log-sum-exp to the wrapper; then kernel
    (given the forward's log-sum-exp, as SDPA's backward reuses its own),
    plain version and SDPA's backward (the library, timed only: autograd
    of one SDPA call, its graph kept) timed in turns.  -> (parity row,
    ``kernels`` row without launches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import BUILD_LOG, LAUNCHES
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, flash_attention_backward)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    gen = torch.Generator(device=dev).manual_seed(seed)
    causal = f["causal"]
    q, k, v = (torch.randn((f["b"], h, f["s"], f["d"]), generator=gen,
                           device=dev).to(dtype)
               for h in (f["hq"], f["hkv"], f["hkv"]))
    o, lse = flash_ops._forward(q, k, v, causal, lse=True)
    do = torch.randn(o.shape, generator=gen, device=dev).to(dtype)
    route = flash_ops._variant(dtype, f["d"],
                               [t.data_ptr() for t in (q, k, v, o, do)])
    counts = [f"flash_attention_bwd_{p}_{route}"
              for p in flash_ops.BWD_PASSES]
    before = [LAUNCHES[c] for c in counts]
    got = flash_attention_backward(q, k, v, o, do, causal, lse=lse)
    label = str(dtype).replace("torch.", "")
    check([LAUNCHES[c] for c in counts] == [n + 1 for n in before],
          f"flash_attention_bwd {name} {label}: not on the {route} route")
    want = attention_bwd_ref(q, k, v, o, do, causal)
    again = flash_attention_backward(q, k, v, o, do, causal, lse=lse)
    rebuilt = flash_attention_backward(q, k, v, o, do, causal)
    torch.cuda.synchronize()
    errs = {}
    for part, x, y, z, r in zip(("dq", "dk", "dv"), got, want, again,
                                rebuilt):
        check(bool(torch.isfinite(x).all()),
              f"flash_attention_bwd {name} {label} {part}: non-finite")
        check(torch.equal(x, z), f"flash_attention_bwd {name} {label} "
              f"{part}: two calls differ (the kernel has no atomics)")
        check(torch.equal(x, r), f"flash_attention_bwd {name} {label} "
              f"{part}: the forward's log-sum-exp and the wrapper's give "
              f"other bits")
        e = flash_err(x, y)
        e["scale"] = max(1.0, y.float().abs().max().item())
        errs[part] = e
        if dtype == torch.float32:
            check(e["max_abs_err"] <= BWD_TOL[label] * e["scale"],
                  f"flash_attention_bwd {name} f32 {part}: {e}, limit "
                  f"{BWD_TOL[label]} · max(1, max|ref|)")
        else:
            check(e["rel_err"] <= BWD_TOL[label],
                  f"flash_attention_bwd {name} bf16 {part}: {e}, limit "
                  f"‖Δ‖/‖ref‖ {BWD_TOL[label]}")
    del want, again, rebuilt
    free_card()
    fns = {"plain": lambda: attention_bwd_ref(q, k, v, o, do, causal),
           "kernel": lambda: flash_attention_backward(q, k, v, o, do,
                                                      causal, lse=lse)}
    refused = None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    try:
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
        fns["library"] = lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True)
        fns["library"]()
    except RuntimeError as err:        # no SDPA backend takes the call
        refused = str(err).splitlines()[0]
        fns.pop("library", None)
    t = time_turns(fns, iters=5)
    flops = bwd_flops(f["b"], f["hq"], f["s"], f["s"], f["d"], causal)
    moved = nbytes(q, k, v, o, do, lse, *got)
    extra = {}
    if dtype == torch.bfloat16:
        bms, by = bound(flops, moved, PEAK_BF16)
    else:
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        extra["bound_fp32_ms"] = bound(flops, moved)[0]
    if refused:
        extra["library_refused"] = refused
    else:
        extra["vs_library"] = t["kernel"] / t["library"]
    shape = (f"B={f['b']} Hq={f['hq']} Hkv={f['hkv']} Sq=Skv={f['s']} "
             f"D={f['d']} {'causal' if causal else 'non-causal'} {label}")
    parity = dict(name="flash_attention_bwd", shape=shape, variant=route,
                  tol=BWD_TOL[label], **errs)
    row = dict(
        name="flash_attention_bwd", block=f"{name}_{label}", route="cuda",
        variant=route, source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:77",
        shape=shape, tflops=flops / t["kernel"] / 1e9,
        max_abs_err=max(e["max_abs_err"] for e in errs.values()),
        rel_err=max(e["rel_err"] for e in errs.values()), ms=t["kernel"],
        plain_ms=t["plain"], bound_ms=bms, bound_by=by,
        share=bms / t["kernel"], library_ms=t.get("library"),
        spill_bytes=spilled_bytes(BUILD_LOG["flash_attention_bwd"]),
        **extra)
    del q, k, v, o, do, lse, got, leaves, fns
    free_card()
    return parity, row


def ssd_bwd_macs(q, h, p, s) -> int:
    """Multiply-adds one chunk of ssd_chunk's gradient needs: C·Bᵀ, dC =
    dCB·B and dCBᵀ·C over the q(q+1)/2 pairs i >= j; per head dM = dy·xᵀ
    and Mᵀ·dy over those pairs, E = B·dstᵀ and the state term (x ⊙
    w)·dst."""
    tri = q * (q + 1) // 2
    return 3 * tri * s + h * (2 * tri * p + 2 * q * p * s)


def ssd_bwd_inputs(gen, dev, bs, nc, q, h, p, s, steep=False):
    """ssd_chunk's inputs (``ssd_inputs``) and its outputs' gradients dy
    and dst; ``steep``: cum falls by 10 a step, so exp(cum_i − cum_j)
    overflows above the diagonal."""
    import torch
    x, B, C, dt, cum = ssd_inputs(gen, dev, bs, nc, q, h, p, s)
    if steep:
        step = torch.arange(1, q + 1, device=dev, dtype=torch.float32)
        cum = (-10.0 * step)[None, None, :, None].expand(
            bs, nc, q, h).contiguous()
    return (x, B, C, dt, cum, torch.randn(x.shape, generator=gen, device=dev),
            torch.randn((bs, nc, h, p, s), generator=gen, device=dev))


def ssd_bwd_held(label, args, parity):
    """ssd_chunk_backward on ``args`` against ssd_chunk_bwd_ref and against
    autograd of ssd_chunk_ref: every output finite and within
    ``SSD_BWD_TOL`` · max(1, max|ref|), two calls bit-equal; a parity row
    per reference appended to ``parity``.  -> (the outputs, the largest
    max|Δ|)."""
    import torch
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_backward,
                                               ssd_chunk_bwd_ref,
                                               ssd_chunk_ref)
    got = ssd_chunk_backward(*args)
    again = ssd_chunk_backward(*args)
    leaves = [t.detach().requires_grad_() for t in args[:5]]
    refs = {"closed_form": ssd_chunk_bwd_ref(*args),
            "autograd": torch.autograd.grad(ssd_chunk_ref(*leaves), leaves,
                                            args[5:])}
    torch.cuda.synchronize()
    parts = ("dx", "dB", "dC", "ddt", "dcum")
    for part, g, a in zip(parts, got, again):
        check(bool(torch.isfinite(g).all()),
              f"ssd_chunk_bwd {label} {part}: non-finite")
        check(torch.equal(g, a), f"ssd_chunk_bwd {label} {part}: two calls "
              f"differ (the kernel has no atomics)")
    worst = 0.0
    for against, want in refs.items():
        row = dict(name="ssd_chunk_bwd", shape=label, against=against,
                   tol=SSD_BWD_TOL)
        for part, g, w in zip(parts, got, want):
            e = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            row[part] = dict(max_abs_err=e, scale=scale)
            check(e <= SSD_BWD_TOL * scale, f"ssd_chunk_bwd {label} {part} "
                  f"vs {against}: max|Δ| {e} > {SSD_BWD_TOL} · {scale}")
            worst = max(worst, e)
        parity.append(row)
    del refs, leaves, again
    return got, worst


def ssd_bwd_rows(dev, seed, layers=None) -> tuple[list, list]:
    """ssd_chunk's backward kernel held (``ssd_bwd_held``) and timed
    beside its plain version at each ``SSD_BWD_LAYERS`` layer, with its
    bound, each pass's device time (torch.profiler) and the heads pass's
    plan (heads a group, groups, warps, blocks an SM, shared memory, B and
    the state term on chip, the tiled route); then held at the
    ``SSD_PARITY`` shapes and ``SSD_BWD_STEEP``.  Given ``layers``, at
    those layers only.  -> (parity rows, ``kernels`` rows without
    launches)."""
    import torch
    from repro_torch.kernels import BUILD_LOG
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_backward,
                                               ssd_chunk_bwd_ref)
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    gen = torch.Generator(device=dev).manual_seed(seed)
    fmt = "bs={} nc={} q={} H={} P={} S={}"
    parity, rows = [], []
    for name, f in (layers or SSD_BWD_LAYERS).items():
        args = ssd_bwd_inputs(gen, dev, **f)
        shape = fmt.format(*f.values())
        got, err = ssd_bwd_held(shape, args, parity)
        free_card()
        t = time_turns({"plain": lambda: ssd_chunk_bwd_ref(*args),
                        "kernel": lambda: ssd_chunk_backward(*args)},
                       iters=5)
        flops = 2.0 * f["bs"] * f["nc"] * ssd_bwd_macs(
            f["q"], f["h"], f["p"], f["s"])
        moved = nbytes(*args, *got)
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        row = dict(
            name="ssd_chunk_bwd", block=name, route="cuda",
            source="src/repro_torch/csrc/ssd_chunk_bwd.cu",
            replaces="src/repro/kernels/ssd_chunk/ssd_chunk.py:64",
            shape=shape, tflops=flops / t["kernel"] / 1e9,
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
            bound_ms=bms, bound_by=by, bound_fp32_ms=bound(flops, moved)[0],
            share=bms / t["kernel"], library_ms=None,
            sass_count=sass_count("ssd_chunk_bwd", "HMMA", "TF32"),
            spill_bytes=spilled_bytes(BUILD_LOG["ssd_chunk_bwd"]),
            device_ms={p: pass_ms(lambda: ssd_chunk_backward(*args),
                                  f"ssd_bwd_{p}")
                       for p in ssd_ops.SSD_BWD_PASSES},
            plan=ssd_ops.backward_plan(*f.values()))
        rows.append(row)
        log(json.dumps({"bwd_kernel": row}))
        del args, got
        free_card()
    if layers:
        return parity, rows
    for shp in SSD_PARITY:
        ssd_bwd_held(fmt.format(*shp), ssd_bwd_inputs(gen, dev, *shp),
                     parity)
    ssd_bwd_held(fmt.format(*SSD_BWD_STEEP.values()) + " steep",
                 ssd_bwd_inputs(gen, dev, **SSD_BWD_STEEP, steep=True),
                 parity)
    free_card()
    return parity, rows


def wiring_ratios(params, got, want) -> dict:
    """Leaf path -> (max|plain|, max|Δ| / (``WIRING_TOL`` · max|plain|)):
    each leaf's gradient held to its own size (a ratio above 1 fails)."""
    from repro_torch import tree
    out = {}
    for path, g, p in zip(tree.paths(params), got, want):
        scale = p.abs().max().item()
        err = (g - p).abs().max().item()
        out[path] = (scale, err / (WIRING_TOL * scale) if scale
                     else (0.0 if err == 0 else float("inf")))
    return out


# the planted fault of each wiring check: the kernel whose output is
# detached from its inputs, and the leaves whose gradients it must break
WIRING_PLANTED = {"olmo-1b": ("flash_attention", ("wq", "wk", "wv")),
                  "mamba2-2.7b": ("ssd_chunk",
                                  ("in_proj", "A_log", "dt_bias"))}


def grad_wiring(dev, seed, arch, chunk=None) -> dict:
    """``arch`` at full width cut to ``TRAIN_WIRING``'s layers, float32:
    every leaf's gradient through the kernel route (forward and backward
    kernels, counted) against the plain route's, max|Δ| <=
    ``WIRING_TOL`` · max|plain| per leaf.  Then a planted fault: the
    forward kernel's output detached from its inputs (what the wrappers
    returned before their autograd Functions) must break that limit on
    every leaf ``WIRING_PLANTED`` names.  ``chunk``: an SSD chunk in
    place of the config's own."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.lm import model_zoo as zoo
    from repro_torch.lm.steps import loss_and_grads
    w = TRAIN_WIRING
    cfg = dataclasses.replace(get_config(arch), n_layers=w["layers"],
                              dtype="float32")
    if chunk:
        cfg = dataclasses.replace(cfg, ssd_chunk=chunk)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = zoo.init(gen, cfg, dev)
    batch = lm_batch(cfg, w["b"], w["s"], gen, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = loss_and_grads(cfg, params, batch)[2]
    routes = {k: v for k, v in kernels.LAUNCHES.items()
              if k.startswith("ssd_chunk_") and v}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want_l = {**dict.fromkeys(launches, 0), **zoo.train_launches(cfg, 1)}
    check(launches == want_l, f"train wiring {arch}: launches {launches}, "
          f"train_launches {want_l}")
    with plain_route():
        want = loss_and_grads(cfg, params, batch)[2]
    ratios = wiring_ratios(params, got, want)
    for path, (scale, ratio) in ratios.items():
        check(ratio <= 1.0, f"train wiring {arch}: {path} grads off the "
              f"plain route's by {ratio} of the limit {WIRING_TOL} · "
              f"max|plain| (max|plain| {scale})")
    kernel, names = WIRING_PLANTED[arch]
    detached = {"flash_attention": (
        lambda q, k, v, causal=True: flash_ops._forward(q, k, v, causal),
        ssd_chunk), "ssd_chunk": (flash_attention, ssd_ops._forward)}
    with lm_kernels(*detached[kernel]):
        planted = loss_and_grads(cfg, params, batch)[2]
    planted = wiring_ratios(params, planted, want)
    hit = [path for path in ratios if path.rsplit("/", 1)[-1] in names]
    check(hit and all(planted[path][1] > 1.0 for path in hit),
          f"train wiring {arch}: a detached {kernel} passes the check: "
          f"{ {path: planted[path] for path in hit} }")
    worst = max(ratios, key=lambda path: ratios[path][1])
    line = dict(train_wiring=arch, n_layers=cfg.n_layers,
                batch=w["b"], seq=w["s"], dtype="float32", leaves=len(got),
                ssd_chunk=cfg.ssd_chunk, ssd_routes=routes,
                launches={k: v for k, v in launches.items() if v},
                tol=WIRING_TOL, worst_share_of_limit=ratios[worst][1],
                worst_leaf=worst,
                max_plain_and_share={p: list(r) for p, r in ratios.items()},
                planted=f"{kernel} detached",
                planted_failing=sum(r > 1.0 for _, r in planted.values()),
                planted_least_share=min(planted[p][1] for p in hit))
    del params, batch, got, want
    free_card()
    return line


@contextlib.contextmanager
def cut_layers(n_layers):
    """``launch.train``'s configs cut to ``n_layers`` (None: as
    published) for the block's duration."""
    import dataclasses

    from repro_torch.launch import train as train_mod
    saved = train_mod.get_config
    if n_layers is not None:
        train_mod.get_config = lambda arch, reduced=False: dataclasses.replace(
            saved(arch, reduced=reduced), n_layers=n_layers)
    try:
        yield
    finally:
        train_mod.get_config = saved


def run_train(argv, n_layers=None, history=None,
              mesh=None) -> tuple[list, list, dict]:
    """``launch.train.main(argv)`` in this process (under ``mesh`` if
    given) with the launch counts set to 0 just before and read just
    after, its lines logged; each step's loss and grad norm appended to
    ``history`` if given.  -> (the losses, each step's seconds (its
    ``dt=``), launches)."""
    import io

    import torch
    from repro_torch import kernels
    from repro_torch.launch import train as train_mod
    out = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with cut_layers(n_layers), contextlib.redirect_stdout(out):
        losses = train_mod.main(list(argv), history, mesh)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    dts = []
    for line in out.getvalue().splitlines():
        log(f"train: {line}")
        m = re.search(r"dt=([0-9.]+)s", line)
        if m:
            dts.append(float(m.group(1)))
    return losses, dts, launches


def train_bound(cfg, b, s) -> dict:
    """The least time one train step could take: its products (the
    forward and the backward's twice that; 2 flops a weight a token, the
    tied head over every position; an attention layer's q·kᵀ and p·v over
    the causal pairs, an SSD layer's intra-chunk block: ``ssd_chunk``'s
    products forward and ``ssd_bwd_macs`` backward) at the bf16 peak,
    against its inputs read once and its outputs written once at the HBM
    rate (params in bf16, m and v in f32, each read and written).  Remat's
    second forward of the layers is work the step chooses, not work it
    must do: it is reported beside the bound (``remat_flops``), not in
    it."""
    n = cfg.param_counts()["total"]
    head = cfg.vocab * cfg.d_model
    kinds = [cfg.mixer_of(i) for i in range(cfg.n_layers)]
    n_ssd = kinds.count("ssd")
    attn = (4 * b * cfg.n_heads * cfg.hd * (cfg.n_layers - n_ssd)
            * s * (s + 1) / 2)
    ssd_fwd = ssd_bwd = 0.0
    if n_ssd:
        q = min(cfg.ssd_chunk, s)
        h, p, st = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        tri = q * (q + 1) // 2
        chunks = n_ssd * b * (s // q)
        ssd_fwd = 2.0 * chunks * (tri * st + h * (tri * p + q * p * st))
        ssd_bwd = 2.0 * chunks * ssd_bwd_macs(q, h, p, st)
    flops = 3 * (2 * b * s * n + attn) + ssd_fwd + ssd_bwd
    moved = 2 * (2 + 4 + 4) * n
    ms, by = bound(flops, moved, PEAK_BF16)
    remat = 2 * b * s * (n - head) + attn + ssd_fwd if cfg.remat else 0
    return dict(step_flops=flops, step_bytes=moved, bound_ms=ms,
                bound_by=by, remat_flops=remat)


def train_full(seed, smi, r) -> tuple[dict, dict]:
    """The trainer at full width (a ``TRAIN_MAIN`` run ``r``): every loss
    finite, the counted launches equal to ``train_launches`` a step; over
    the steps after the first two, the step time and tokens/s from the
    window's summed ``dt`` (each step from its batch's copy to its loss on
    the host); the bound and its share, peak memory.  -> (the ``train``
    line, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.lm import model_zoo as zoo
    cfg = get_config(r["arch"])
    argv = ("--arch", r["arch"], "--steps", str(r["steps"]), "--batch",
            str(r["b"]), "--seq", str(r["s"]), "--microbatches",
            str(r["microbatches"]), "--seed", str(seed))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = []
    losses, dts, launches = run_train(argv, history=history)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == r["steps"] and all(
        x == x and abs(x) != float("inf") for x in losses),
        f"train {r['arch']}: losses {losses}")
    per_step = zoo.train_launches(cfg, r["microbatches"])
    want = {**dict.fromkeys(launches, 0),
            **{k: r["steps"] * v for k, v in per_step.items()}}
    check(launches == want, f"train {r['arch']}: launches {launches}, "
          f"train_launches × steps {want}")
    # the backward's launches by pass and route (counted since run_train
    # reset them): bf16 at olmo-1b's head width runs on wgmma alone
    from repro_torch import kernels
    routes = {k: v for k, v in kernels.LAUNCHES.items()
              if k.startswith("flash_attention_bwd_") and v}
    check(sum(routes.values()) == launches["flash_attention_bwd"],
          f"train {r['arch']}: backward launches by route {routes}")
    if launches["flash_attention_bwd"] and cfg.dtype == "bfloat16":
        check(all(k.endswith("_wgmma") for k in routes),
              f"train {r['arch']}: the bf16 backward off wgmma: {routes}")
    window = dts[2:]
    step_s = sum(window) / len(window)
    bnd = train_bound(cfg, r["b"], r["s"])
    line = dict(train=r["arch"], n_layers=cfg.n_layers, reduced=[],
                batch=r["b"], seq=r["s"], microbatches=r["microbatches"],
                steps=r["steps"], losses=losses,
                grad_norms=[h["grad_norm"] for h in history], step_s=dts,
                window_steps=len(window), step_ms=step_s * 1e3,
                tokens_per_s=len(window) * r["b"] * r["s"] / sum(window),
                **bnd, share=bnd["bound_ms"] / (step_s * 1e3),
                peak_memory_gb=peak / 1e9, wall_s=wall,
                launches={k: v for k, v in launches.items() if v},
                bwd_routes=routes,
                launches_per_step={k: v for k, v in per_step.items() if v},
                card=smi)
    return line, launches


def train_resume(seed, r) -> dict:
    """A ``TRAIN_RESUME`` run ``r`` straight and cut in two with a restart
    from the checkpoint: the same losses (|Δ| <= ``RESUME_TOL``)."""
    import tempfile
    base = ("--arch", r["arch"], "--batch", str(r["b"]), "--seq",
            str(r["s"]), "--ckpt-every", str(r["ckpt_every"]), "--seed",
            str(seed))
    half = r["steps"] // 2
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ref, _, _ = run_train(base + ("--steps", str(r["steps"]), "--ckpt",
                                      os.path.join(d, "ref")), r["layers"])
        part1, _, _ = run_train(base + ("--steps", str(half), "--ckpt",
                                        os.path.join(d, "run")), r["layers"])
        part2, _, _ = run_train(base + ("--steps", str(r["steps"]),
                                        "--ckpt", os.path.join(d, "run")),
                                r["layers"])
        wall = time.perf_counter() - t0
    worst = max(abs(a - b) for a, b in zip(ref, part1 + part2))
    line = dict(train_resume=r["arch"], n_layers=r["layers"], batch=r["b"],
                seq=r["s"], straight=ref, resumed=part1 + part2,
                max_abs_diff=worst, tol=RESUME_TOL, wall_s=wall)
    check(len(part1) == half and len(part2) == r["steps"] - half,
          f"train resume {r['arch']}: {len(part1)} + {len(part2)} steps")
    check(worst <= RESUME_TOL, f"train resume {r['arch']}: losses off the "
          f"uninterrupted run's by {worst}: {line}")
    return line


def train_others() -> list:
    """Every config but the first full-width one at its reduced config in
    bf16 (``TRAIN_OTHERS``): losses finite and the launches
    ``train_launches`` names."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.lm import model_zoo as zoo
    r = TRAIN_OTHERS
    lines = []
    for arch in ARCH_IDS:
        if arch == TRAIN_MAIN[0]["arch"]:
            continue
        argv = ("--arch", arch, "--reduced", "--steps", str(r["steps"]),
                "--batch", str(r["b"]), "--seq", str(r["s"]))
        cfg = get_config(arch, reduced=True)
        t0 = time.perf_counter()
        losses, dts, launches = run_train(argv)
        want = {**dict.fromkeys(launches, 0), **{
            k: r["steps"] * v for k, v in zoo.train_launches(cfg).items()}}
        check(all(x == x and abs(x) != float("inf") for x in losses),
              f"train {arch}: losses {losses}")
        check(launches == want, f"train {arch}: launches {launches}, "
              f"train_launches × steps {want}")
        lines.append(dict(train_other=arch, dtype=cfg.dtype,
                          losses=losses, step_s=dts,
                          launches={k: v for k, v in launches.items() if v},
                          wall_s=time.perf_counter() - t0))
    return lines


def trainer_runs(seed, smi) -> dict:
    """The runs of ``launch.train.main`` in this process, which carries
    ``TRAIN_ENV``: the full-width runs, the resume checks and the other
    configs, their lines logged.  -> launches over the full-width runs
    (each checked against its own config's ``train_launches``: olmo-1b's
    run launches no SSD kernel, mamba2-2.7b's no attention kernel)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = {}
    lines = {}
    for r in TRAIN_MAIN:
        line, launches = train_full(seed, smi, r)
        log(json.dumps(line))
        lines[r["arch"]] = line
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        free_card()
    for r in TRAIN_RESUME:
        log(json.dumps(train_resume(seed, r)))
    for other in train_others():
        log(json.dumps(other))
    log(json.dumps(mesh_train(seed, smi, lines[MESH_TRAIN["arch"]])))
    return total


def mesh_train(seed, smi, free_line) -> dict:
    """Phase 10's trainer runs under ``local_mesh()`` (a world of one,
    made here and handed to the trainer, which runs a world of one
    without a mesh of its own): ``MESH_TRAIN`` against phase 9's
    mesh-free run ``free_line`` of the same seed (losses and grad norms
    bit-equal, the launches ``train_launches`` a step), and ``MESH_SSM``
    with and without the mesh (bit-equal, the same launches).  -> the
    ``mesh_train`` line."""
    from repro_torch.launch.mesh import local_mesh, release_world
    try:
        return _mesh_train(seed, smi, free_line, local_mesh())
    finally:
        release_world()


def _mesh_train(seed, smi, free_line, mesh) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.lm import model_zoo as zoo
    r = MESH_TRAIN
    argv = ("--arch", r["arch"], "--steps", str(r["steps"]), "--batch",
            str(r["b"]), "--seq", str(r["s"]), "--microbatches",
            str(r["microbatches"]), "--seed", str(seed))
    free_card()
    history = []
    t0 = time.perf_counter()
    losses, dts, launches = run_train(argv, history=history, mesh=mesh)
    wall = time.perf_counter() - t0
    n = r["steps"]
    norms = [h["grad_norm"] for h in history]
    check(losses == free_line["losses"][:n]
          and norms == free_line["grad_norms"][:n],
          f"mesh train {r['arch']}: losses {losses} / grad norms {norms} "
          f"under local_mesh(), {free_line['losses'][:n]} / "
          f"{free_line['grad_norms'][:n]} without")
    per_step = zoo.train_launches(get_config(r["arch"]), r["microbatches"])
    want = {**dict.fromkeys(launches, 0),
            **{k: n * v for k, v in per_step.items()}}
    check(launches == want, f"mesh train {r['arch']}: launches {launches}, "
          f"train_launches × steps {want}")
    window = slice(2, n)
    line = {"mesh_train": r["arch"], "mesh": {"data": 1, "model": 1},
            "batch": r["b"], "seq": r["s"],
            "microbatches": r["microbatches"], "steps": n, "losses": losses,
            "grad_norms": norms, "bit_equal_to_no_mesh": True,
            "step_s": dts, "no_mesh_step_s": free_line["step_s"][:n],
            "step_ms": 1e3 * sum(dts[window]) / len(dts[window]),
            "no_mesh_step_ms": 1e3 * sum(free_line["step_s"][window])
            / len(free_line["step_s"][window]),
            "launches": {k: v for k, v in launches.items() if v},
            "wall_s": wall, "card": smi}
    free_card()
    s = MESH_SSM
    base = ("--arch", s["arch"], "--steps", str(s["steps"]), "--batch",
            str(s["b"]), "--seq", str(s["s"]), "--seed", str(seed))
    runs = {}
    for tag, on in (("no_mesh", None), ("mesh", mesh)):
        hist = []
        got, sdts, sl = run_train(base, s["layers"], hist, on)
        runs[tag] = (got, [h["grad_norm"] for h in hist], sl, sdts)
        free_card()
    check(runs["mesh"][:3] == runs["no_mesh"][:3] and bool(
        runs["mesh"][2].get("ssd_chunk")),
          f"mesh train {s['arch']} at {s['layers']} layers: (losses, grad "
          f"norms, launches) {runs['mesh'][:3]} under the mesh, "
          f"{runs['no_mesh'][:3]} without")
    line["ssm"] = {"arch": s["arch"], "n_layers": s["layers"],
                   "batch": s["b"], "seq": s["s"],
                   "losses": runs["mesh"][0], "grad_norms": runs["mesh"][1],
                   "bit_equal_to_no_mesh": True,
                   "launches": {k: v for k, v in runs["mesh"][2].items()
                                if v},
                   "step_s": runs["mesh"][3],
                   "no_mesh_step_s": runs["no_mesh"][3]}
    torch.cuda.synchronize()
    return line


def train_phase(dev, seed, smi) -> tuple[dict, list, list]:
    """Phase 9, the trainer: the backward kernels held and timed at the
    ``BWD_LAYERS`` and the ``SSD_BWD_LAYERS``; the gradient wiring of
    olmo-1b and mamba2-2.7b; then ``trainer_runs`` in a subprocess that
    carries ``TRAIN_ENV`` (the earlier phases run without it): the trainer
    at full width (counted: the phase's launches), the resume checks, the
    other configs.  -> (launches of the full-width runs, parity rows,
    ``kernels`` rows without launches, each full-width run's peak memory
    in GB)."""
    import torch
    parity, rows = [], []
    for name, f, dtype in BWD_LAYERS:
        p_row, k_row = bwd_row(name, f, getattr(torch, dtype), dev, seed)
        parity.append(p_row)
        rows.append(k_row)
        log(json.dumps({"bwd_kernel": k_row}))
    ssd_parity, ssd_rows_ = ssd_bwd_rows(dev, seed)
    parity += ssd_parity
    rows += ssd_rows_
    for arch in WIRING_PLANTED:
        log(json.dumps(grad_wiring(dev, seed, arch)))
    free_card()
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--trainer-runs",
         "--seed", str(seed)], cwd=ROOT, env={**os.environ, **TRAIN_ENV},
        capture_output=True, text=True, timeout=900)
    out = res.stdout.splitlines()
    peaks = {}
    for line in out[:-1]:
        log(line)
        if line.startswith('{"train": '):
            run = json.loads(line)
            peaks[run["train"]] = run["peak_memory_gb"]
    check(res.returncode == 0 and bool(out), f"the trainer runs exited "
          f"{res.returncode}:\n{res.stderr[-3000:]}")
    return json.loads(out[-1])["train_launches"], parity, rows, peaks


def mesh_phase(params, batch, smi) -> dict:
    """Phase 10 in this process: the main batch through the engine under
    ``data_mesh(1)`` and without, in turns (mesh-free, mesh, mesh,
    mesh-free), each forward with the launch counts set to 0 just before
    and read just after: the logits bit-equal, the launches the same;
    then the serving CLI under ``--mesh-data 1`` and ``--production-mesh``
    refused.  -> the ``mesh`` line."""
    import torch
    from repro_torch import kernels
    from repro_torch.engine import PCNEngine
    from repro_torch.launch.mesh import data_mesh, release_world
    from repro_torch.models.pointnet2 import POINTNET2_C
    free = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")
    runs = {"no_mesh": [], "mesh": []}
    try:
        meshed = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda",
                           mesh=data_mesh(1))
        for tag in ("no_mesh", "mesh", "mesh", "no_mesh"):
            eng = meshed if tag == "mesh" else free
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            logits = eng.apply(params, batch)
            torch.cuda.synchronize()
            runs[tag].append((1e3 * (time.perf_counter() - t0),
                              kernels.launch_counts(), logits))
    finally:
        release_world()
    ref = runs["no_mesh"][0]
    for tag in runs:
        for ms, launches, logits in runs[tag]:
            check(torch.equal(logits, ref[2]), f"mesh: the {tag} logits are "
                  f"not bit-equal to the mesh-free forward's")
            check(launches == ref[1] and ref[1]["gather_mlp"] > 0
                  and ref[1]["hub_reuse"] > 0, f"mesh: {tag} launches "
                  f"{launches}, mesh-free {ref[1]}")
    cli_s = cli_phase(smi, MESH_CLI)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--production-mesh"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(
            ROOT / "src")})
    refusal = (res.stderr.strip().splitlines() or [""])[-1]
    check(res.returncode != 0 and "needs 256 ranks" in refusal,
          f"--production-mesh on one card exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    return {"mesh": {"mesh": {"data": 1, "model": 1},
                     "batch": list(batch.xyz.shape), "bit_equal": True,
                     "launches": {k: v for k, v in ref[1].items() if v},
                     "forward_ms": [r[0] for r in runs["mesh"]],
                     "no_mesh_forward_ms": [r[0] for r in runs["no_mesh"]],
                     "cli": list(MESH_CLI), "cli_s": cli_s,
                     "production_mesh": {"exit": res.returncode,
                                         "message": refusal},
                     "card": smi}}


@contextlib.contextmanager
def serve_config(n_layers):
    """``launch.serve``'s configs cut to ``n_layers`` (None: as
    published) for the block's duration."""
    import dataclasses

    from repro_torch.launch import serve as serve_mod
    saved = serve_mod.get_config
    if n_layers is not None:
        serve_mod.get_config = lambda arch, reduced=False: dataclasses.replace(
            saved(arch, reduced=reduced), n_layers=n_layers)
    try:
        yield serve_mod.get_config
    finally:
        serve_mod.get_config = saved


def lm_serve_run(arch, params, mesh, n_layers) -> dict:
    """``serve_lm`` on ``arch`` (``SERVE_MESH``) under ``mesh`` (or none)
    with ``params``, the launch counts set to 0 just before and read just
    after.  -> its tokens, last step's logits, ms a generated token (the
    CLI's own host-clock figure), launches and wall seconds."""
    import argparse
    import io

    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve as serve_mod
    args = argparse.Namespace(arch=arch, reduced=False, device=None,
                              **SERVE_MESH)
    logits, out = [], io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with serve_config(n_layers), contextlib.redirect_stdout(out):
        gen = serve_mod.serve_lm(args, params, mesh, logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first = out.getvalue().splitlines()[0]
    log(f"serve_lm: {first}")
    return {"tokens": gen, "logits": logits[-1],
            "ms": float(re.search(r"([0-9.]+) ms a step", first).group(1)),
            "launches": {k: v for k, v in kernels.launch_counts().items()
                         if v}, "wall_s": wall}


def serve_mesh_pair(arch, dev, seed, smi, mesh, n_layers=None) -> dict:
    """``arch`` served without a mesh and under ``mesh`` from the same
    seeded params: the tokens bit-equal, the last step's logits equal,
    the same launches (none but the audio encoder's flash_attention).
    -> the ``serve_mesh`` line."""
    import torch
    from repro_torch.lm import model_zoo as zoo
    with serve_config(n_layers) as get_config:
        cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = zoo.init(gen, cfg, dev)
    runs = {tag: lm_serve_run(arch, params, on, n_layers)
            for tag, on in (("no_mesh", None), ("mesh", mesh))}
    free, meshed = runs["no_mesh"], runs["mesh"]
    check(bool((free["tokens"] == meshed["tokens"]).all()),
          f"serve_mesh {arch}: tokens under the mesh differ from the "
          f"mesh-free ones")
    diff = (free["logits"].float() - meshed["logits"].float()).abs()
    check(torch.equal(free["logits"], meshed["logits"]),
          f"serve_mesh {arch}: the last step's logits under the mesh "
          f"differ by {float(diff.max()):.3g}")
    check(bool(torch.isfinite(free["logits"].float()).all()),
          f"serve_mesh {arch}: non-finite logits")
    enc = cfg.enc_layers if cfg.family == "audio" else 0
    want = {"flash_attention": enc} if enc else {}
    check(free["launches"] == meshed["launches"] == want,
          f"serve_mesh {arch}: launches {free['launches']} without the "
          f"mesh, {meshed['launches']} under it, {want} expected")
    line = {"serve_mesh": arch, "n_layers": cfg.n_layers,
            "reduced": ([] if n_layers is None else
                        [f"n_layers -> {n_layers}"]),
            "mesh": dict(mesh.shape), **SERVE_MESH, "dtype": cfg.dtype,
            "tokens_bit_equal": True, "last_logits_equal": True,
            "decode_ms_per_token": meshed["ms"],
            "no_mesh_decode_ms_per_token": free["ms"],
            "launches": meshed["launches"],
            "wall_s": meshed["wall_s"], "no_mesh_wall_s": free["wall_s"],
            "card": smi}
    del params, runs, free, meshed
    free_card()
    return line


def tool(argv, timeout=900) -> tuple[list, float]:
    """``python -m <argv>`` in a subprocess from the checkout: exit 0.
    -> (its stdout lines, wall seconds)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"{' '.join(argv)} exited {res.returncode}:"
          f"\n{res.stderr[-3000:]}")
    return res.stdout.splitlines(), wall


def planning_tools(smi, phase9_peak_gb) -> dict:
    """The planning tools on this machine: memreport and the dry run of
    ``PLAN_DRYRUN`` on the fake 256-rank world, each in a subprocess
    (their lines logged, their per-device numbers and wall time kept);
    the dry run's per-device flops × 256 against the mesh-free count of
    the same step; memmodel of phase 9's olmo-1b step (``PLAN_STEP``) on
    a one-device mesh beside the peak phase 9 measured.  -> the
    ``planning`` line."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun, memmodel
    from repro_torch.launch.mesh import local_mesh, release_world
    out = ROOT / "build" / "phase11"
    out.mkdir(parents=True, exist_ok=True)
    mem_lines, mem_s = tool(("repro_torch.launch.memreport", "--out",
                             str(out / "memmodel.json")))
    for line in mem_lines:
        log(f"memreport: {line}")
    with open(out / "memmodel.json") as fh:
        cells = json.load(fh)
    check(len(cells) == 32, f"memreport: {len(cells)} cells, 32 expected")
    dry_json = out / "dryrun.json"
    if dry_json.exists():
        dry_json.unlink()
    dry_lines, dry_s = tool(("repro_torch.launch.dryrun", *PLAN_DRYRUN,
                             "--out", str(dry_json)))
    for line in dry_lines:
        log(f"dryrun: {line}")
    with open(dry_json) as fh:
        rec = json.load(fh)[0]
    check(rec["status"] == "ok", f"dryrun {PLAN_DRYRUN}: {rec.get('error')}"
          f"\n{rec.get('trace', '')}")
    arch, shape = PLAN_DRYRUN[1], PLAN_DRYRUN[3]
    t0 = time.perf_counter()
    free = dryrun.trace_step(get_config(arch), shape, None)
    free_s = time.perf_counter() - t0
    r = PLAN_STEP
    step = ShapeSpec("phase9_step", r["s"], r["b"], "train")
    try:
        model = memmodel.train_footprint(get_config(r["arch"]), step,
                                         local_mesh(), r["microbatches"],
                                         accum_bytes=4, opt_state_bytes=4)
    finally:
        release_world()
    return {"planning": {
        "memreport": {"cells": len(cells), "wall_s": mem_s,
                      "not_fitting": [f"{c['arch']} {c['shape']}"
                                      for c in cells if not c["fits_hbm"]],
                      "olmo-1b": {c["shape"]: c["total_bytes"]
                                  for c in cells if c["arch"] == "olmo-1b"}},
        "dryrun": {"cell": f"{arch} {shape}", "wall_s": dry_s,
                   **{k: rec[k] for k in (
                       "chips", "microbatches", "lower_s", "compile_s",
                       "hlo_flops_per_chip", "hlo_bytes_per_chip",
                       "collective_bytes_per_chip", "memory", "compute_s",
                       "memory_s", "collective_s", "dominant")},
                   "mesh_free_flops": free["flops"],
                   "mesh_free_trace_s": free_s,
                   "flops_x_chips_over_mesh_free":
                       rec["hlo_flops_per_chip"] * rec["chips"]
                       / free["flops"]},
        "memmodel_phase9_step": {**r, "opt_state_bytes": 4,
                                 "accum_bytes": 4, **model,
                                 "total_gb": model["total_bytes"] / 1e9,
                                 "phase9_peak_gb": phase9_peak_gb},
        "card": smi}}


def serve_mesh_phase(dev, seed, smi) -> list:
    """Phase 11's serving part: ``serve_mesh_pair`` on
    ``SERVE_MESH_MAIN`` as published and ``SERVE_MESH_CUT`` at 2 layers
    under one ``local_mesh()`` of this world of one.  -> the lines."""
    from repro_torch.launch.mesh import local_mesh, release_world
    lines = []
    try:
        mesh = local_mesh()
        for arch in SERVE_MESH_MAIN + SERVE_MESH_CUT:
            line = serve_mesh_pair(arch, dev, seed, smi, mesh,
                                   None if arch in SERVE_MESH_MAIN else 2)
            log(json.dumps(line))
            lines.append(line)
    finally:
        release_world()
    return lines


ANALYSIS_CLI = ("repro_torch.analysis", "--strict", "--device", "cuda")
ANALYSIS_FAMILIES = ("pointnet2", "dgcnn", "pointnext", "pointvector")
ANALYSIS_KERNELS = ("gather_mlp", "hub_reuse", "knn", "flash_attention",
                    "ssd_chunk")


def analysis_phase(smi) -> dict:
    """Phase 12: the static analysis on the card, in a subprocess
    (``ANALYSIS_CLI``); its report held to the phase's checks (see the
    module docstring).  -> the ``analysis`` line."""
    out = ROOT / "build" / "phase12" / "analysis.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    lines, wall = tool((*ANALYSIS_CLI, "--json", str(out)))
    for line in lines:
        if "[suppressed]" not in line:
            log(f"analysis: {line}")
    with open(out) as fh:
        rep = json.load(fh)
    s = rep["summary"]
    check(s["strict_ok"] and s["errors"] == 0,
          f"analysis: {s['errors']} unsuppressed errors")
    m = re.search(r"(\d+) targets, (\d+) kernel sites", lines[-1])
    check(m is not None, f"analysis: no summary line in {lines[-1:]}")
    rows = rep["kernel_sites"]
    check(bool(rows) and all(r["device"] == "cuda" for r in rows),
          "analysis: the sites were not captured on the card")
    check(all(r["matches_cpu"] for r in rows),
          f"analysis: card sites differ from their CPU-derived twins: "
          f"{[r['site'] for r in rows if not r['matches_cpu']]}")
    check(all(r["smem_library"] == r["footprint_bytes"] for r in rows),
          f"analysis: the formulas' shared memory differs from the "
          f"library's at "
          f"{[r['site'] for r in rows if r['smem_library'] != r['footprint_bytes']]}")
    by_kernel = {k: sum(r["kernel"] == k for r in rows)
                 for k in ANALYSIS_KERNELS}
    by_family = {f: sum(r["family"] == f for r in rows)
                 for f in ANALYSIS_FAMILIES}
    check(all(by_kernel.values()) and all(by_family.values()),
          f"analysis: a kernel or family without sites: {by_kernel} "
          f"{by_family}")
    routes = {(r["kernel"], r["launch"].get("route")) for r in rows}
    check({("hub_reuse", "layered"), ("ssd_chunk", "tiled"),
           ("flash_attention", "split")} <= routes,
          f"analysis: a route past the old limits without sites: {routes}")
    for t in {r["target"] for r in rows if r["target"].endswith(
            "lpcn/cuda")}:
        kinds = {r["kernel"] for r in rows if r["target"] == t}
        check(kinds == {"gather_mlp", "hub_reuse"},
              f"analysis: {t} launched {kinds}")
    return {"analysis": {
        "targets": int(m.group(1)), "sites": int(m.group(2)),
        "sites_by_kernel": by_kernel, "sites_by_family": by_family,
        "findings": s["findings"], "errors": s["errors"],
        "warnings": s["warnings"], "suppressed": s["suppressed"],
        "wall_s": wall, "card": smi}}


# phase 13: PCN training and the paper's Fig. 20 accuracy run
PCN_FULL_QUICK = False        # (a) at full size: 160 / 64 clouds, 10 epochs
# FC kernel launches of one evaluation forward (two blocks, one launch a
# dataflow a block; Mesorasi is plain torch)
PCN_EVAL_LAUNCHES = {"traditional": {"gather_mlp": 2, "hub_reuse": 0},
                     "lpcn": {"gather_mlp": 2, "hub_reuse": 2},
                     "mesorasi": {"gather_mlp": 0, "hub_reuse": 0}}
PCN_LOSS_RTOL = 1e-3          # (b): each SGD step's loss, card vs CPU
PCN_MARGIN = 1e-3             # (b): CPU top-two logit margin of a held cloud
PCN_EXAMPLES = (("quickstart",), ("islandization_demo",), ("lm_decode",),
                ("train_pointnet2", "--steps", "50"))
EXAMPLE_ARGS = ()             # the examples' extra flags (none: the card)


def pcn_expected(evals, n_runs: int = 1) -> dict:
    """FC launches of ``n_runs`` × the evaluation forwards ``evals``."""
    return {k: n_runs * sum(PCN_EVAL_LAUNCHES[m][k] for m, _ in evals)
            for k in ("gather_mlp", "hub_reuse")}


def pcn_full(dev, smi):
    """(a) ``run_accuracy()`` at full size with the launch counts reset:
    training launches no kernel ("reference" under autograd), each
    evaluation forward its ``PCN_EVAL_LAUNCHES``.  -> (run, launches,
    the ``pcn_train`` line)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.examples import accuracy
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    run = accuracy.run_accuracy(PCN_FULL_QUICK, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    want = pcn_expected(accuracy.EVALS, len(accuracy.ACTIVATIONS))
    check(counts == {**dict.fromkeys(counts, 0), **want},
          f"pcn_train: launches {counts}, expected {want}")
    for act, losses in run.losses.items():
        check(all(np.isfinite(losses)), f"pcn_train {act}: a loss is not "
              f"finite")
    n_train, n_test, n_points, epochs = accuracy.sizes(PCN_FULL_QUICK)
    line = {"pcn_train": {
        "card": smi, "clouds": [n_train, n_test], "points": n_points,
        "epochs": epochs,
        "steps": {a: len(v) for a, v in run.losses.items()},
        "step_ms_from_3": {a: 1e3 * float(np.mean(v[2:]))
                           for a, v in run.step_s.items()},
        "loss_first": {a: v[0] for a, v in run.losses.items()},
        "loss_last": {a: v[-1] for a, v in run.losses.items()},
        "accuracy": run.table,
        "launches_per_eval_forward": PCN_EVAL_LAUNCHES,
        "launches": {k: counts[k] for k in want}, "seconds": wall}}
    return run, {k: counts[k] for k in want}, line


def pcn_card_vs_cpu(dev) -> dict:
    """(b) the quick run on the card against the same run on the CPU:
    each step's loss within ``PCN_LOSS_RTOL``, the same prediction on
    every test cloud whose CPU top-two margin is >= ``PCN_MARGIN``."""
    from repro_torch.examples import accuracy
    t = time.perf_counter()
    card = accuracy.run_accuracy(True, dev)
    cpu = accuracy.run_accuracy(True, "cpu")
    out = {"loss_rel_max": {}, "held": 0, "excepted": [], "seconds": 0.0}
    for act in accuracy.ACTIVATIONS:
        rel = max(abs(a - b) / abs(b) for a, b in zip(card.losses[act],
                                                      cpu.losses[act]))
        out["loss_rel_max"][act] = rel
        check(len(card.losses[act]) == len(cpu.losses[act]) and
              rel <= PCN_LOSS_RTOL,
              f"pcn card vs cpu {act}: losses differ by {rel:.3g} "
              f"relative (tol {PCN_LOSS_RTOL})")
        for name, ref in cpu.logits[act].items():
            top2 = ref.topk(2, dim=-1).values
            held = (top2[:, 0] - top2[:, 1]) >= PCN_MARGIN
            got = card.logits[act][name].argmax(-1).cpu()
            bad = int((held & (got != ref.argmax(-1))).sum())
            check(bad == 0, f"pcn card vs cpu {act} {name}: {bad} held "
                  f"clouds predicted differently")
            out["held"] += int(held.sum())
            out["excepted"] += [f"{act}/{name}/{int(i)}"
                                for i in (~held).nonzero().flatten()]
    out["seconds"] = time.perf_counter() - t
    return out


def pcn_kernels_vs_plain(run, dev) -> dict:
    """(c) the trained weights' evaluation logits through "cuda" against
    "reference" on the card (``TOL`` · max(1, max|ref|)), each "cuda"
    forward with its launches counted."""
    import torch
    from repro_torch import kernels, random
    from repro_torch.examples import accuracy
    xte, _ = accuracy.gen_task(accuracy.sizes(PCN_FULL_QUICK)[1], 256, 2,
                               dev)
    key = random.PRNGKey(0, dev)
    out = {}
    for act in accuracy.ACTIVATIONS:
        for mode, comp in accuracy.EVALS:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = accuracy.predict(run.params[act], xte, mode, comp, key)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            want = pcn_expected(((mode, comp),))
            check(counts == {**dict.fromkeys(counts, 0), **want},
                  f"pcn eval {act} {mode}/{comp}: launches {counts}, "
                  f"expected {want}")
            ref = accuracy.predict(run.params[act], xte, mode, comp, key,
                                   "reference")
            err, tol = close(got, ref)
            check(err <= tol, f"pcn eval {act} {mode}/{comp}: cuda vs "
                  f"reference max|err| {err:.3g} > {tol:.3g}")
            out[f"{act}/{accuracy.tag(mode, comp)}"] = {
                "max_abs_err": err, "tol": tol,
                "launches": {k: counts[k] for k in want}}
    return out


def pcn_grad_refusal(run, dev) -> dict:
    """(d) under autograd on the card, gather_mlp (a training step through
    "cuda"), hub_reuse (an lpcn forward) and knn raise NoBackwardError
    with their message, and launch nothing."""
    import torch
    from repro_torch import kernels, random
    from repro_torch.examples import accuracy
    from repro_torch.kernels import NoBackwardError
    from repro_torch.kernels.knn import knn
    xs, ys = accuracy.gen_task(16, 256, 1, dev)
    key = random.PRNGKey(0, dev)
    params = run.params["block_end"]
    flat = [p.detach().requires_grad_() for p in accuracy.leaves(params)]

    def lpcn_forward():
        with torch.enable_grad():
            accuracy.forward(accuracy.with_leaves(params, flat), xs, "lpcn",
                             key, backend="cuda")

    pts = xs[0].detach().clone().requires_grad_()
    calls = {"gather_mlp": lambda: accuracy.grads(params, xs, ys, key,
                                                  backend="cuda"),
             "hub_reuse": lpcn_forward,
             "knn": lambda: knn(pts, pts, 16)}
    out = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except NoBackwardError as e:
            msg = str(e)
        else:
            msg = ""
        check(msg.startswith(f"{name}: no {name} backward kernel") and
              "PCN training" in msg,
              f"pcn grad refusal: {name} under autograd on the card gave "
              f"{msg!r}")
        out[name] = msg
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"pcn grad refusal: a refused call launched {counts}")
    return out


def pcn_examples() -> float:
    """(e) the four examples in subprocesses side by side (``EXAMPLE_ARGS``
    added), each exiting 0; their lines echoed.  -> wall seconds."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])),
        "REPRO_TORCH_TILE_PLANS": str(ROOT / "build" / "no_tile_plans")}
    t0 = time.perf_counter()
    procs = {ex[0]: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{ex[0]}", *ex[1:],
         *EXAMPLE_ARGS], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for ex in PCN_EXAMPLES}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            for line in stdout.splitlines():
                log(f"example {name}: {line}")
            check(proc.returncode == 0, f"example {name} exited "
                  f"{proc.returncode}:\n{stderr[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def pcn_train_phase(dev, smi) -> dict:
    """Phase 13 (see the module docstring).  -> the FC launches of the
    full-size run."""
    t = time.perf_counter()
    run, launches, line = pcn_full(dev, smi)
    log(json.dumps(line))
    log(json.dumps({"pcn_card_vs_cpu": pcn_card_vs_cpu(dev), "card": smi}))
    log(json.dumps({"pcn_kernels_vs_plain": pcn_kernels_vs_plain(run, dev),
                    "card": smi}))
    log(json.dumps({"pcn_grad_refusal": pcn_grad_refusal(run, dev)}))
    log(json.dumps({"pcn_examples_s": pcn_examples(),
                    "phase_s": time.perf_counter() - t}))
    return launches


def flash_calls() -> list:
    """Phase 14's flash calls: (layer, name, D, dtype) of ``FLASH_SPLIT``
    and ``FLASH_SPLIT_WIDE`` at ``FLASH_SPLIT_LAYER`` and of
    ``FLASH_SPLIT_STREAM`` at ``FLASH_STREAM_LAYER``."""
    return ([(FLASH_SPLIT_LAYER, *c) for c in FLASH_SPLIT + FLASH_SPLIT_WIDE]
            + [(FLASH_STREAM_LAYER, *c) for c in FLASH_SPLIT_STREAM])


def domain_drive(dev, seed) -> tuple[dict, dict]:
    """The domain routes' calls, each launched once with the launch counts
    set to 0 just before and read just after: hub_reuse at
    ``REUSE_DOMAIN`` (layered), ssd_chunk and its backward at
    ``SSD_TILED`` (tiled), flash_attention and its backward at
    ``FLASH_SPLIT``, ``FLASH_SPLIT_WIDE`` and ``FLASH_SPLIT_STREAM``
    (split), each route's count as its plan says.  -> (launches by
    wrapper and by route, the calls' inputs)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import tiling
    from repro_torch.kernels.flash_attention import flash_attention_backward
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.hub_reuse import hub_reuse
    from repro_torch.kernels.ssd_chunk import ssd_chunk_backward
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    hub = {name: reuse_inputs(torch.Generator().manual_seed(seed + 7), dev,
                              2, **shp)
           for name, shp in REUSE_DOMAIN.items()}
    ssd = {name: ssd_bwd_inputs(gen, dev, **f) for name, f in
           SSD_TILED.items()}
    flash = {(layer, dt): tuple(
        torch.randn((f["b"], h, f["s"], d), generator=gen,
                    device=dev).to(getattr(torch, dt))
        for h in (f["hq"], f["hkv"], f["hkv"], f["hq"]))
        for f, layer, d, dt in flash_calls()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for a in hub.values():
        hub_reuse(*a[:7], live=a[7])
    for a in ssd.values():
        ssd_ops._forward(*a[:5])
        ssd_chunk_backward(*a)
    for q, k, v, do in flash.values():
        o, lse = flash_ops._forward(q, k, v, True, lse=True)
        flash_attention_backward(q, k, v, o, do, True, lse=lse)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    routes = [tiling.hub_reuse_route(2, *(shp[n] for n in (
        "hn", "c", "m", "k", "d", "f")), sms) for shp in REUSE_DOMAIN.values()]
    n_hub, n_ssd, n_fl = len(REUSE_DOMAIN), len(SSD_TILED), len(flash)
    want = {"hub_reuse": n_hub, "hub_reuse_layered": n_hub,
            "ssd_chunk": n_ssd, "ssd_chunk_tiled": n_ssd,
            "ssd_chunk_bwd": 2 * n_ssd, "ssd_chunk_bwd_tiled": 2 * n_ssd,
            "flash_attention": n_fl, "flash_attention_split": n_fl,
            "flash_attention_bwd": 2 * n_fl,
            "flash_attention_bwd_dq_split": n_fl,
            "flash_attention_bwd_dkdv_split": n_fl}
    check(launches == want, f"domain launches {launches}, expected {want}")
    check(routes == ["layered"] * n_hub,
          f"domain: hub_reuse routes {routes}, expected layered")
    return {**dict.fromkeys(want, 0), **launches}, dict(hub=hub, ssd=ssd,
                                                       flash=flash)


def domain_hub_rows(hub, launches) -> tuple[list, list]:
    """hub_reuse at ``REUSE_DOMAIN``: the plan's route, H splits, scratch
    and shared memory equal to the library's, the kernel against its
    plain version (1e-4 · max(1, max|plain|), the -BIG identity exactly)
    and twice bit-equal, both timed in turns.  -> (parity rows,
    ``kernels`` rows)."""
    import torch
    from repro_torch.kernels import tiling
    from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
    from repro_torch.kernels.hub_reuse import ops as hub_ops
    parity, rows = [], []
    for name, shp in REUSE_DOMAIN.items():
        pool, slot, comp, w1, b1, w2, b2, live = hub[name]
        args = (pool, slot, comp, w1, b1, w2, b2)
        dims = (shp["c"], shp["m"], shp["k"], shp["d"])
        pl = hub_ops.plan(2, shp["hn"], *dims, shp["h"], shp["f"],
                          pool.device)
        sms = torch.cuda.get_device_properties(
            pool.device).multi_processor_count
        lp = tiling.hub_reuse_layered_plan(2, shp["hn"], shp["c"], shp["h"],
                                           shp["f"], sms)
        ours = dict(route=pl["route"], nsplit=lp["nsplit"],
                    scratch=lp["scratch"], smem=tiling.LAYERED_SMEM)
        lib = hub_ops.library_plan(2, shp["hn"], *dims, shp["h"], shp["f"])
        check(lib == ours, f"hub_reuse {name}: plan {ours} by tiling.py, "
              f"{lib} by the library")
        out = hub_reuse(*args, live=live)
        err, tol = max_err(out, hub_reuse_ref(*args, live=live))
        same = bool(torch.equal(out, hub_reuse(*args, live=live)))
        parity.append(dict(name="hub_reuse", block=name, b=2, masked=True,
                           route=pl["route"], nsplit=lp["nsplit"],
                           max_abs_err=err, tol=tol, bit_equal=same))
        check(err <= tol, f"hub_reuse {name}: max|err| {err} > {tol}")
        check(same, f"hub_reuse {name}: two calls differ")
        ms, plain_ms = time_pair(lambda: hub_reuse(*args, live=live),
                                 lambda: hub_reuse_ref(*args, live=live),
                                 iters=10)
        flops = 2 * 2 * shp["hn"] * shp["c"] * (
            shp["d"] * shp["h"] + shp["h"] * shp["f"])
        moved = nbytes(*args, live, out)
        bms, by = bound(3 * flops, moved, PEAK_TF32)
        rows.append(dict(
            name="hub_reuse", block=name, route="cuda",
            variant=f"mma_tf32x3_{pl['route']}_nsplit{lp['nsplit']}",
            tflops=flops / ms / 1e9, bound_fp32_ms=bound(flops, moved)[0],
            source="src/repro_torch/csrc/hub_reuse.cu",
            replaces="src/repro/kernels/hub_reuse/hub_reuse.py:307",
            shape=f"B=2 H={shp['hn']} C={shp['c']} M={shp['m']} "
                  f"K={shp['k']} D={shp['d']} Hd={shp['h']} F={shp['f']} "
                  f"live=True",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None, smem=ours["smem"],
            launches=launches["hub_reuse"],
            route_launches=launches[f"hub_reuse_{pl['route']}"]))
    return parity, rows


def domain_phase(dev, seed, smi) -> tuple[list, list]:
    """Phase 14, the kernels' domain routes: ``domain_drive`` (counted),
    then each route held against its plain version and timed beside it
    (``domain_hub_rows``; ``ssd_row`` and ``ssd_bwd_rows`` at
    ``SSD_TILED``; ``flash_row`` and ``bwd_row`` at ``FLASH_SPLIT``,
    ``FLASH_SPLIT_WIDE`` and ``FLASH_SPLIT_STREAM``, SDPA beside them),
    each row with its wrapper's and its route's launches in
    the drive; then mamba2-2.7b at chunk ``SSD_CHUNK_LONG``: a counted
    f32 prefill of ``LM_PREFILL`` against the plain route (max|Δ| <=
    ``LM_F32_TOL`` · max(1, max|plain|)) and the gradient wiring
    (``grad_wiring``) at 2 layers.  -> (parity rows, ``kernels`` rows)."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.analysis.kernels import ssd_plan
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.lm import model_zoo as zoo
    from repro_torch.lm import steps
    launches, inputs = domain_drive(dev, seed)
    log(json.dumps({"domain_launches": launches}))
    parity, rows = domain_hub_rows(inputs["hub"], launches)
    # TF32 HMMA of the tiled route's kernels (tl::, tlb::), by library
    tiled_hmma = {lib: sass_count(lib, "HMMA", "TF32", within=within)
                  for lib, within in (("ssd_chunk", "_ZN2tl"),
                                      ("ssd_chunk_bwd", "_ZN3tlb"))}
    log(json.dumps({"ssd_tiled_sass_hmma": tiled_hmma}))
    for lib, n in tiled_hmma.items():
        check(n > 0, f"{lib}'s tiled kernels have no tensor-core HMMA")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ssd_parity = []
    for name, a in inputs["ssd"].items():
        row = ssd_row(name, a[:5], ssd_ops._forward(*a[:5]), ssd_parity)
        dims = (a[0].shape[0] * a[0].shape[1], a[0].shape[3], a[0].shape[2],
                a[0].shape[4], a[1].shape[-1])
        plan, want = ssd_ops.library_plan(*dims), ssd_plan(*dims, sms)
        check((plan["qp"], plan["hg"], (plan["grid_x"], plan["grid_y"]),
               plan["smem"]) == (want["qp"], want["hg"], want["grid"],
                                 want["smem"]),
              f"ssd_chunk {name}: plan {plan} from the library, {want} "
              f"derived")
        row.update(variant="tf32x3_tiled", plan=plan,
                   launches=launches["ssd_chunk"],
                   route_launches=launches["ssd_chunk_tiled"],
                   tiled_sass_count=tiled_hmma["ssd_chunk"])
        rows.append(row)
    del inputs["ssd"]
    free_card()
    bwd_parity, bwd = ssd_bwd_rows(dev, seed + 7, SSD_TILED)
    for row in bwd:
        row.update(variant="tf32x3_tiled", launches=launches["ssd_chunk_bwd"],
                   route_launches=launches["ssd_chunk_bwd_tiled"],
                   tiled_sass_count=tiled_hmma["ssd_chunk_bwd"])
    parity += ssd_parity + bwd_parity
    rows += bwd
    layers = {(layer, dt): f for f, layer, _, dt in flash_calls()}
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as flash_ops
    # tensor-core instructions of flash_split.cuh's kernels, by library
    # and type (bf16: HMMA ... BF16; f32 in 3xTF32: HMMA ... TF32)
    hmma = {(lib, dt): sass_count(lib, "HMMA", word, within="_ZN5split")
            for lib in ("flash_attention", "flash_attention_bwd")
            for dt, word in (("float32", "TF32"), ("bfloat16", "BF16"))}
    log(json.dumps({"split_sass_hmma": {f"{a}_{b}": n for (a, b), n in
                                        hmma.items()}}))
    for key, n in hmma.items():
        check(n > 0, f"flash_split.cuh's {key[1]} kernels in {key[0]} have "
              f"no tensor-core HMMA")
    for (layer, dt), (q, k, v, _) in inputs["flash"].items():
        d, f = q.shape[-1], layers[layer, dt]
        route = flash_ops._variant(q.dtype, d)
        check(route == "split", f"flash {layer} {dt}: route {route}")
        src = "src/repro_torch/csrc/flash_split.cuh"
        lay = flash_ops.library_layout(route, dt, d)
        sass = {"sass_count": hmma[("flash_attention", dt)]}
        with torch.no_grad():
            out = flash_attention(q, k, v, causal=True)
        p_row, k_row = flash_row(layer, {**f, "d": d}, dt, q, k, v, out)
        k_row.update(source=src, launches=launches["flash_attention"],
                     route_launches=launches[f"flash_attention_{route}"],
                     cluster=lay["cluster"], slice=lay["slice"],
                     sweeps=lay["sweeps"],
                     share=k_row["bound_ms"] / k_row["ms"], **sass)
        if k_row["library_ms"]:
            k_row["vs_library"] = k_row["ms"] / k_row["library_ms"]
        parity.append(p_row)
        rows.append(k_row)
        log(json.dumps({"split_kernel": k_row}))
        p_row, k_row = bwd_row(layer, {**f, "d": d}, getattr(torch, dt), dev,
                               seed + 7)
        sass = {"sass_count": hmma[("flash_attention_bwd", dt)]}
        check(k_row["variant"] == route, f"flash_attention_bwd {layer} {dt}: "
              f"route {k_row['variant']}, expected {route}")
        k_row.update(source=src, launches=launches["flash_attention_bwd"],
                     route_launches={
                         p: launches[f"flash_attention_bwd_{p}_{route}"]
                         for p in ("dq", "dkdv")},
                     cluster={"dq": lay["dq_cluster"],
                              "dkdv": lay["dkv_cluster"]},
                     slice={"dq": lay["dq_slice"], "dkdv": lay["dkv_slice"]},
                     sweeps={"dq": lay["dq_sweeps"],
                             "dkdv": lay["dkv_sweeps"]},
                     **sass)
        parity.append(p_row)
        rows.append(k_row)
        log(json.dumps({"bwd_kernel": k_row}))
    del inputs
    free_card()

    # ---- mamba2-2.7b at chunk 256: the prefill and the gradient wiring --
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), dtype="float32",
                              ssd_chunk=SSD_CHUNK_LONG)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = zoo.init(gen, cfg, dev)
    batch = lm_batch(cfg, LM_PREFILL["b"], LM_PREFILL["s"], gen, dev)
    # the counted prefill and lm_prefill's two timed ones
    out, pre, ms = lm_prefill(cfg, params, batch, "mamba2-2.7b chunk 256",
                              repeats=2)
    tiled = kernels.LAUNCHES["ssd_chunk_tiled"]
    check(pre["ssd_chunk"] == cfg.n_layers and tiled == 3 * cfg.n_layers,
          f"mamba2-2.7b chunk 256: {pre['ssd_chunk']} ssd_chunk launches a "
          f"prefill and {tiled} tiled over three, expected {cfg.n_layers} "
          f"and all tiled")
    with plain_route():
        t0 = time.perf_counter()
        plain = steps.make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
    err = (out.float() - plain.float()).abs().max().item()
    scale = max(1.0, plain.float().abs().max().item())
    line = dict(domain_lm="mamba2-2.7b", ssd_chunk=cfg.ssd_chunk,
                n_layers=cfg.n_layers, batch=LM_PREFILL["b"],
                seq=LM_PREFILL["s"], dtype="float32", card=smi,
                prefill_launches={k: v for k, v in pre.items() if v},
                tiled_launches_over_3_prefills=tiled, prefill_ms=ms,
                plain_prefill_ms=plain_ms,
                vs_plain_max_abs_err=err, plain_scale=scale,
                vs_plain_rel_err=rel_err(out, plain), tol=LM_F32_TOL)
    log(json.dumps(line))
    check(err <= LM_F32_TOL * scale, f"mamba2-2.7b chunk 256 prefill: "
          f"max|Δ| {err} > {LM_F32_TOL} · {scale}")
    del params, batch, out, plain
    free_card()
    wiring = grad_wiring(dev, seed, "mamba2-2.7b", SSD_CHUNK_LONG)
    check(wiring["ssd_routes"].get("ssd_chunk_tiled", 0) > 0
          and wiring["ssd_routes"].get("ssd_chunk_bwd_tiled", 0) > 0,
          f"mamba2-2.7b chunk 256 wiring: routes {wiring['ssd_routes']}")
    log(json.dumps(wiring))
    return parity, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one lpcn forward with torch.profiler")
    ap.add_argument("--trainer-runs", action="store_true",
                    help="phase 9's trainer runs alone (the smoke runs "
                         "them in a subprocess that carries TRAIN_ENV)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.device import resolve_device
    from repro_torch.engine import PCNEngine
    from repro_torch.models.pointnet2 import POINTNET2_C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    if args.trainer_runs:
        launches = trainer_runs(args.seed, smi.splitlines()[0])
        log(json.dumps({"train_launches": launches}))
        return 0
    log(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    phases = {}
    # every phase but the plans phase plans by the heuristic: an empty
    # tile-plan store, whatever results/ holds
    from repro_torch.kernels import plans
    plans.configure(None)

    t = time.perf_counter()
    kernels.build_all()
    phases["build_s"] = time.perf_counter() - t
    log(f"build_s {phases['build_s']:.2f}")
    for name, text in kernels.BUILD_LOG.items():
        for row in ptxas_kernels(text):
            log(f"ptxas {name}: {row['kernel']}: {row['registers']} "
                f"registers, {row['spill']} bytes spilled")
    for name in ("flash_attention", "flash_attention_bwd"):
        hgmma = sass_count(name, "HGMMA")
        hmma = sass_count(name, "HMMA")
        log(f"sass {name}: {hgmma} HGMMA instructions, {hmma} HMMA "
            f"instructions")
        check(hgmma > 0, f"the {name} library has no HGMMA (wgmma)")
        check(hmma > 0, f"the {name} library has no HMMA (mma.sync)")
    for name in ("gather_mlp", "hub_reuse", "ssd_chunk", "ssd_chunk_bwd",
                 "flash_attention_bwd"):
        check(spilled_bytes(kernels.BUILD_LOG[name]) == 0,
              f"ptxas reports spills in {name}")
        hmma = sass_count(name, "HMMA", "TF32")
        log(f"sass {name}: {hmma} HMMA TF32 instructions")
        check(hmma > 0, f"the {name} library has no TF32 HMMA (mma.sync)")
    dense_linear = gather_linear_sass()
    log(json.dumps({"gather_mlp_linear_sass": dense_linear}))
    check(len(dense_linear) == 8 and all(
        r["spill"] == 0 and r["hgmma_tf32"] > 0 and r["hmma_tf32"] == 0
        for r in dense_linear.values()),
          f"gather_mlp's linear kernels (two row tiles, four widths): "
          f"{dense_linear}, expected no spill, TF32 HGMMA and no TF32 HMMA "
          f"in each")
    one_layer = linear_sass()
    log(json.dumps({"linear_sass": one_layer}))
    check(len(one_layer) == 2 and all(
        r["spill"] == 0 and r["hmma_tf32"] > 0 for r in one_layer.values()),
          f"hub_reuse's mma.sync one-layer resident kernels (both row "
          f"tiles): {one_layer}, expected no spill and TF32 HMMA in each")
    wgmma = hub_reuse_linear_sass()
    log(json.dumps({"hub_reuse_linear_sass": wgmma}))
    check(len(wgmma) == 4 and all(
        r["spill"] == 0 and r["hgmma_tf32"] > 0 and r["hmma_tf32"] == 0
        for r in wgmma.values()),
          f"hub_reuse's wgmma one-layer kernels (two row tiles, two "
          f"widths): {wgmma}, expected no spill, TF32 HGMMA and no TF32 "
          f"HMMA in each")

    t = time.perf_counter()
    parity, rows, per_cloud = kernel_phase(dev, args.seed)
    phases["kernels_s"] = time.perf_counter() - t
    log(f"kernels_s {phases['kernels_s']:.2f}")
    log(json.dumps({"parity": parity}))
    log(json.dumps({"per_cloud": per_cloud}))

    # ---- the main path: the ported server on the card ------------------
    engine = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="cuda")
    params = seed_biases(engine.init(seed=args.seed),
                         torch.Generator().manual_seed(args.seed + 1))
    reference = PCNEngine(POINTNET2_C, mode="lpcn", fc_backend="reference")
    t = time.perf_counter()
    served = serve_phase(POINTNET2_C, engine, reference, params, args.seed,
                         smi.splitlines()[0])
    phases["serve_s"] = time.perf_counter() - t
    phases.update(served["times"])
    launches = served["launches"]
    log(f"serve_s {phases['serve_s']:.2f}; async run launches {launches}")
    phases["serve_cli_s"] = cli_phase(smi.splitlines()[0])

    # one (8, 1024) batch of the earlier slices' requests (the same clouds
    # and keys), input of the stage times and the phases below
    batch = main_batch(args.seed, dev)
    err, tol = close(engine.apply(params, batch),
                     reference.apply(params, batch))
    log(f"lpcn cuda vs reference: max|err| {err:.3g} (tol {tol:.3g})")
    check(err <= tol, "lpcn logits disagree with the reference backend")
    stages = breakdown(params, POINTNET2_C, batch)
    log(json.dumps({"lpcn_stages_ms": stages}))
    mismatch = structure_card_vs_cpu(POINTNET2_C, batch)
    log(json.dumps({"structure_card_vs_cpu_mismatches": mismatch}))
    check(not any(mismatch.values()),
          f"stage 1 on the card differs from the CPU, which the tests hold "
          f"bit-equal to JAX: {mismatch} (near-tie order, ROADMAP queue 3)")
    if args.profile:
        log(json.dumps({"lpcn_profile": device_profile(
            lambda b: engine.apply(params, b), batch)}))

    # ---- traditional mode: one batch ------------------------------------
    trad = PCNEngine(POINTNET2_C, mode="traditional", fc_backend="cuda")
    trad_ref = PCNEngine(POINTNET2_C, mode="traditional",
                         fc_backend="reference")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    lg = trad.apply(params, batch)
    torch.cuda.synchronize()
    phases["traditional_s"] = time.perf_counter() - t
    trad_launches = kernels.launch_counts()
    log(f"traditional_s {phases['traditional_s']:.3f}; launches "
        f"{trad_launches}")
    check(trad_launches == {**dict.fromkeys(trad_launches, 0),
                            "gather_mlp": len(POINTNET2_C.blocks)},
          "traditional launch counts")
    check(bool(torch.isfinite(lg).all()), "non-finite traditional logits")
    err, tol = close(lg, trad_ref.apply(params, batch))
    log(f"traditional cuda vs reference: max|err| {err:.3g} "
        f"(tol {tol:.3g})")
    check(err <= tol, "traditional logits disagree with the reference")

    # ---- lpcn at cache_capacity_x = 4: hub_reuse past 128 cache rows ----
    t = time.perf_counter()
    x4_launches, x4_families = cache_x4_phase(params, batch, args.seed, dev)
    phases["cache_x4_s"] = time.perf_counter() - t

    # ---- the paper's other samplers and neighbor searches ---------------
    t = time.perf_counter()
    ds_variants_phase(params, batch, smi.splitlines()[0])
    phases["ds_variants_s"] = time.perf_counter() - t
    log(f"ds_variants_s {phases['ds_variants_s']:.2f}")

    # ---- tile plans, the autotuner, the per-cloud dispatch --------------
    t = time.perf_counter()
    plan_launches = plans_phase(params, batch, smi.splitlines()[0],
                                args.seed)
    phases["plans_s"] = time.perf_counter() - t
    log(f"plans_s {phases['plans_s']:.2f}; launches "
        f"{json.dumps(plan_launches)}")

    # ---- the families: every other model of the zoo at full width -------
    t = time.perf_counter()
    family_routes = families_phase(dev, args.seed, smi.splitlines()[0])
    phases["families_s"] = time.perf_counter() - t
    t = time.perf_counter()
    wide_parity, wide_rows = wide_kernel_rows(dev, args.seed,
                                              family_routes["wide"])
    linear_parity, linear_rows = linear_kernel_rows(
        dev, args.seed, family_routes["linear"],
        family_routes["split_weights"])
    reuse_parity, reuse_rows = reuse_linear_rows(
        dev, args.seed, family_routes, x4_families["pointvector_l"])
    phases["route_kernels_s"] = time.perf_counter() - t
    log(f"families_s {phases['families_s']:.2f}; gather_mlp launches by "
        f"route and hub_reuse's one-layer ones {family_routes}; "
        f"route_kernels_s {phases['route_kernels_s']:.2f}")
    log(json.dumps({"wide_parity": wide_parity}))
    log(json.dumps({"linear_parity": linear_parity}))
    log(json.dumps({"reuse_linear_parity": reuse_parity}))
    phases["seg_cli_s"] = cli_phase(smi.splitlines()[0], SEG_CLI)

    # ---- entry kernels: knn, flash_attention, ssd_chunk -----------------
    t = time.perf_counter()
    entry_launches, entry_parity, entry_rows = entry_phase(
        dev, args.seed, POINTNET2_C, batch)
    phases["entry_s"] = time.perf_counter() - t
    log(f"entry_s {phases['entry_s']:.2f}; launches {entry_launches}")
    log(json.dumps({"entry_parity": entry_parity}))

    # ---- the LM serving side: the ten configs, prefill and decode -------
    t = time.perf_counter()
    lm_launches, lm_parity, lm_rows = lm_phase(dev, args.seed,
                                               smi.splitlines()[0])
    phases["lm_s"] = time.perf_counter() - t
    log(f"lm_s {phases['lm_s']:.2f}; launches over the counted prefills "
        f"{lm_launches}")
    log(json.dumps({"lm_parity": lm_parity}))

    # ---- the LM trainer: flash_attention's backward, olmo-1b ------------
    t = time.perf_counter()
    train_launches, train_parity, train_rows, train_peaks = train_phase(
        dev, args.seed, smi.splitlines()[0])
    phases["train_s"] = time.perf_counter() - t
    log(f"train_s {phases['train_s']:.2f}; launches of the full-width run "
        f"{train_launches}")
    log(json.dumps({"train_parity": train_parity}))

    # ---- the mesh: a world of one on the card ---------------------------
    t = time.perf_counter()
    log(json.dumps(mesh_phase(params, batch, smi.splitlines()[0])))
    phases["mesh_s"] = time.perf_counter() - t
    log(f"mesh_s {phases['mesh_s']:.2f}")

    # ---- LM serving under a mesh; the planning tools --------------------
    t = time.perf_counter()
    serve_mesh_phase(dev, args.seed, smi.splitlines()[0])
    phases["serve_mesh_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log(json.dumps(planning_tools(smi.splitlines()[0],
                                  train_peaks.get(PLAN_STEP["arch"]))))
    phases["planning_s"] = time.perf_counter() - t
    log(f"serve_mesh_s {phases['serve_mesh_s']:.2f}; planning_s "
        f"{phases['planning_s']:.2f}")

    # ---- the static analysis: the matrix's launches on the card ---------
    t = time.perf_counter()
    log(json.dumps(analysis_phase(smi.splitlines()[0])))
    phases["analysis_s"] = time.perf_counter() - t
    log(f"analysis_s {phases['analysis_s']:.2f}")

    # ---- PCN training, the Fig. 20 accuracy run, the examples -----------
    t = time.perf_counter()
    pcn_launches = pcn_train_phase(dev, smi.splitlines()[0])
    phases["pcn_train_s"] = time.perf_counter() - t
    log(f"pcn_train_s {phases['pcn_train_s']:.2f}; FC launches of the "
        f"full-size run {pcn_launches}")

    # ---- the kernels' domain routes: past the old routes' limits ---------
    t = time.perf_counter()
    domain_parity, domain_rows = domain_phase(dev, args.seed,
                                              smi.splitlines()[0])
    phases["domain_s"] = time.perf_counter() - t
    log(f"domain_s {phases['domain_s']:.2f}")
    log(json.dumps({"domain_parity": domain_parity}))

    # the per-cloud entries (B = 1) are the same kernels: each wrapper
    # counts its kernel's launches whatever the shape
    rows += per_cloud
    for row in rows:
        row["launches"] = (x4_launches if row.pop("path", None) == "cache_x4"
                           else launches)[row["name"]]
    for row in entry_rows:
        row["launches"] = entry_launches[row["name"]]
        row["lm_launches"] = lm_launches[row["name"]]
    for row in lm_rows:
        row["launches"] = lm_launches[row["name"]]
    for row in train_rows:
        row["launches"] = train_launches[row["name"]]
    rows += (wide_rows + linear_rows + reuse_rows + entry_rows + lm_rows
             + train_rows + domain_rows)
    for row in rows:
        if row["name"] in pcn_launches:
            row["pcn_train_launches"] = pcn_launches[row["name"]]
    log(json.dumps({"phases_s": phases}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
