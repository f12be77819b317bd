#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GreedyML (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--n 100000] [--seed 13]

Phases, each printing one JSON line; a failed phase raises and the
script exits non-zero:

  build      compile the six CUDA sources (one nvcc per source, in
             parallel) and report their register/shared-memory use
  data       draw the Tiny-ImageNet-shaped k-medoid data on the card
             (n × 12,288 f32, the gen_images mixture recipe)
  parity     every kernel against its plain PyTorch version on the card,
             at the runs' own shapes, for every feature rule: pairwise
             and the loops at the first leaf's pool and a level's 16
             node pools (there pairwise == the resident kernel's build
             bit for bit, and pairwise[bf16] by the float64 rule); the
             streaming loop at the leaf level (32 × 3,284²) bit for bit
             against k fused_step launches over the same cache
             (`loop_vs_fused_step`), the resident loop against the
             streaming loop over its own matrix (`resident_vs_loop`);
             then (line `parity_steps`) fused_step at the
             knapsack run's leaf (32 × 3,125²) and node (32 × 400²)
             shapes, gains at the stochastic run's leaf shape (32 ×
             3,125 ground rows × 72 sampled candidates), with a TF32
             build rejected; each also bit for bit against the design
             it replaced (fused_step's row blocks, gains' 64×64 tile:
             `vs_earlier_design`, `vs_64x64_build`, differing = 0)
  reference  small trees through the kernels against the same trees
             through the plain CPU path: run_tree_dense on small-integer
             facility data; then (line `reference_dispatch`)
             LevelDispatcher trees with a knapsack (costs in quarters)
             and with stochastic leaves — equal ids, values and spent
  run        run_tree_dense('kmedoid', …) with k = 200, m = 32, b = 2
             (L = 5), per-level wall time and launches, root value and
             its global re-scoring
  knapsack   LevelDispatcher over 32 lanes of 3,125 permuted images, a
             KnapsackSpec of uniform(0.5, 2) costs and budget 100: every
             stage on the fused engine (pairwise + 200 fused_step
             launches), spent ≤ budget at the root and every lane
  stochastic the same lanes without a constraint, sample_leaf = 72 (the
             paper's ε = 0.01 subset): leaves on the step engine (200
             gains launches, 1 gains_norms: the ground's norms once),
             nodes on the resident loop
  timing     each kernel at its path's shape beside its bound, its
             plain version and a one-call PyTorch yardstick (the
             streaming loop also beside k fused_step launches over its
             cache, `fused_step_x_k_ms`; the resident loop at every
             level's node count, its build and steps split; line
             `timing_steps` for fused_step and gains, with fused_step
             at the node shape, gains' once-a-greedy norms pass and the
             step engine's row update)

The memory-capped cache tiers (bf16 and int8 cached matrices, the
planner's storage ladder), between the phases above:

  parity_quant  (after parity_steps) the seven variants at the runs'
                shapes — leaf level 32 × 3,284², node level 16 × 400²,
                knapsack leaf 32 × 3,125² and node 32 × 400² — for
                kmedoid and facility, bit for bit against what runs the
                same arithmetic: pairwise[bf16] against the f32 kernel
                rounded, the chunked int8 cache against quantize_rows on
                the CPU, fused_step and the streaming loop against the
                f32 kernel on the dequantized cache, the resident
                scratch against round_resident of its f32 build; the
                loops against k fused_step launches and against the
                streaming loop over the resident matrix, as in parity;
                and against their plain versions (kernels/parity.py)
  run_bf16      (after run) run_tree_dense('kmedoid', …) with the bf16
  run_int8      / int8 rung forced (every level in that storage) and
                with REPRO_TORCH_FUSED_CACHE_MB = 1,024 / 512 (the
                planner's pick for the leaves; nodes f32): per level the
                engine, dtype and each variant's launches, the leaf
                stage's allocation beyond the pools held to the planned
                cache bytes (≤ 1.05× + one int8 chunk's f32), the root
                beside the f32 run's
  knapsack_bf16 (after knapsack) the knapsack lanes with the rung
  knapsack_int8 forced: every stage fused, k fused_step[bf16|int8]
                launches a stage, spent ≤ budget everywhere
  timing_quant  (after timing_steps) each variant at its path's shape
                beside its bound (the storage's own bytes), its plain
                version and, for pairwise[bf16], torch.cdist to bf16;
                the loops as in timing

Then the coverage problems, after the k-medoid tensors are freed:

  data_kcover       the KOSARAK k-cover bitmaps (990,002 sets over 41,270
                    items, gen_kcover + pack_bitmaps on the host, 5.1 GB
                    of 32-bit words placed on the card)
  parity_coverage   the four bitmap kernels against their plain versions
                    at the kcover runs' shapes, equal bit for bit: gains
                    (32 × 2,227 × 1,290), fused_step (leaf 32 × 30,938 ×
                    1,290, node 32 × 128 × 1,290), the streaming loop
                    (the first leaf level), the resident loop (every
                    level's 16, 8, 4, 2, 1 nodes and the stochastic
                    run's 32 lanes, on the tier its plan picks and on
                    the device-memory tier, forced)
  kcover_run        run_tree_dense('kcover', …) at KOSARAK, T(32, 2):
                    1 streaming-loop launch at the leaves, 1 resident
                    launch per level, 0 pairwise; the leaf cache bytes
  kcover_knapsack   LevelDispatcher over 32 lanes, KnapsackSpec of
                    uniform(0.5, 2) costs, budget 40: 64 fused_step
                    launches a stage, spent ≤ budget everywhere
  kcover_stochastic the same lanes, sample_leaf 2,227: 64 gains launches
                    at the leaves, resident nodes
  kdom_run          run_tree_dense('kdom', …) at the reference's kdom
                    configuration (65,536 road-graph neighbourhoods),
                    after the streaming loop at its first leaf level
                    (8 × 8,355 × 2,048, k = 128) and the resident loop
                    at its levels' 4, 2, 1 nodes (× 256 × 2,048, both
                    tiers) are held bit for bit against their plain
                    versions (line `parity_kdom`), and the resident loop
                    is timed at those levels (line `timing_kdom`)
  timing_coverage   each bitmap kernel at its path's shape beside its
                    bytes bound and its plain version; the resident
                    loop at every level's nodes and the 32 lanes (µs a
                    step, tier, cluster, the forced device-memory tier)

Streaming (sieve streaming: one stream-filter launch a batch for all
levels of all stacked sieves), beside the k-medoid phases:

  parity_stream        (after parity_quant) the stream filter at the
                       k-medoid stream's shape (72 levels × 16,384
                       evaluation rows × 256 arrivals × 12,288), three
                       chained batches fed the plain version's state,
                       kmedoid and facility, with and without costs:
                       the slab by the float64 pairwise rule, the
                       decisions by parity.compare_stream (ties
                       counted); the int8-ground variant bit for bit
                       against the f32 kernel on the dequantized
                       ground; the int8-ground gains at the stochastic
                       leaf shape, bit for bit and by the float64 rule
  parity_stream_global the stream filter beyond one block's shared
                       memory: kmedoid against all 100,000 images (72 ×
                       100,000 × 256 × 12,288, a level's row over a
                       cluster of 8 blocks), three chained batches by
                       the float64 slab rule and parity.compare_stream,
                       and the device-memory tier (forced) bit for bit
                       equal to it; bitmaps at 8,192 words (262,144
                       items), three batches bit for bit on both tiers
  reference_stream     (after reference_dispatch) small-integer facility
                       streams, kernel path == CPU path: stream_select,
                       a SlidingSieve, 4 continuous lanes
  stochastic_int8      (after stochastic) the stochastic lanes under the
                       int8 rung: 200 gains[int8] launches at the leaves
  stream_kmedoid       stream_select('kmedoid') over all 100,000 images
                       against all 100,000 (a cluster of 8 a level), k =
                       200, B = 256: 391 batches, one stream_filter and
                       one scatter_slots launch each; the summary's
                       digest (value, a hash of the sorted ids); then
                       (line `stream_idle`) the device's busy share and
                       the host's gap a batch over 20 traced batches
  stream_kmedoid_int8  the same stream, int8 ground, against 16,384 of
                       the images (the shared-memory tier); each value
                       on its evaluation set ≥ (½ − ε) of the `run`
                       root's there
  timing_stream        (after timing_quant) the stream filter per batch
                       (f32, int8 at 16,384 rows; f32 at 100,000 rows;
                       bitmaps at 8,192 words) and the int8-ground gains
                       beside their bounds and plain versions; each
                       filter row with its slab / decision split
                       (torch.profiler), CUDA launches a batch, admitted
                       count, and the feature rows' time on the
                       device-memory tier (forced)

and after timing_coverage, on the kosarak bitmaps:

  parity_stream_coverage  the bitmap stream filter bit for bit (one
                          sieve, knapsack, the window's 5 checkpoints,
                          4 continuous lanes) and the slot update
  stream_kcover           stream_select over all 990,002 sets, k = 64,
                          B = 256: 3,868 launches; ≥ (½ − ε) of
                          kcover_run's root; then its `stream_idle`
  stream_kcover_knapsack  costs uniform(0.5, 2), budget 40: spent ≤ 40
                          at every level
  window_kcover           window 262,144, stride 65,536: no expired id
  continuous_kcover       4 lanes, b = 2, a merge every 256 batches on
                          the resident bitmap loop; merges never drop;
                          then the same stream traced: its device time
                          and busy share
  timing_stream_coverage  the bitmap stream filter per batch (split,
                          launches, admitted, both tiers)

and distributed GreedyML over torch.distributed (one rank a tree
machine; the card is one H100, and NCCL takes no two ranks on one
device, so the multi-rank groups run over gloo with every rank on the
card and its collectives staging the k-row solutions through the host):

  distributed_stream_kcover  (after timing_stream_coverage) 4 spawned
                          ranks, stream_select_distributed over the
                          continuous_kcover stream (b = 2, a merge every
                          256 batches): merges and digest equal
                          continuous_kcover's; per rank one
                          stream_filter[coverage] launch a batch
  distributed_kdom        (after kdom_run) 8 spawned ranks, one
                          lane_pools block each: greedyml_distributed
                          over (2, 2, 2) and randgreedi_distributed over
                          8, each root on every rank bit for bit equal to
                          LevelDispatcher(mesh=None) over the same pools;
                          per rank its stages' wall and launches (1
                          greedy_loop[coverage] at the leaves, 1
                          greedy_loop_resident[coverage] a level) and
                          each level's gathered bytes and seconds
  distributed_nccl        world size 1 over NCCL in this process:
                          greedyml_distributed on all the kdom bitmaps
                          equal to LevelDispatcher(mesh=None, (1,))
  coreset                 select_coreset('greedyml:facility') on
                          gen_embeddings(65,536, 256), k = 128, through
                          the 8-rank group, every rank's ids equal to the
                          stacked dispatcher's over the same blocks

and the sharded leaf tier, the lazy Minoux engine and the tree planner:

  sharded_kmedoid         (after stochastic_int8) the first 4 of the
                          stochastic lanes' pools (3,125 images each),
                          each padded and split over 4 stacked shard
                          lanes, LevelDispatcher((2, 2), shard=4): 200 ·
                          n_s / tile_c gains launches for all 16 lanes +
                          1 gains_norms; each machine's leaf equal to
                          greedy_batch(engine='step') on its pool (or a
                          float64-proven tie), the levels bit for bit to
                          an unsharded LevelDispatcher((2, 2)) run from
                          the same leaves; one tile's gains launch held
                          against its plain version (float64 ratio
                          rule) and timed beside its bound, its bytes
  lazy_kmedoid            run_tree_lazy (DenseMedoid on the card) over
                          the first 25,000 images, T(32, 2), k = 200,
                          beside run_tree_dense on them; on small
                          integers the card's selections and evals equal
                          the CPU's
  lazy_kcover             (after kcover_run) run_tree_lazy over the
                          kosarak sets on the host: the dense root's
                          value, levels and comm, fewer evals; the lazy
                          Greedy over all sets against run_greedy_dense
                          on the card
  sharded_distributed     (after coreset) 4 spawned gloo ranks as one
                          machine's shard lanes, shard_greedy_distributed
                          on gen_embeddings(8,192, 256), k = 64: every
                          rank bit for bit equal to shard_greedy_sim,
                          the stacked launches a rank, the gathers'
                          bytes and seconds
  plan_tree               plans.plan_tree at paper_kmedoid, paper_kcover
                          (words=) and paper_kdom over 32 lanes, at the
                          default budget and one just below the smallest
                          leaf cache

and fault tolerance and serving (checkpoints under a temporary
directory the phase removes; every save's and restore's bytes and
seconds printed):

  supervised_kmedoid      (after run) SelectionSupervisor over run's
                          pools with a transient failure at level 3: the
                          root bit for bit the unsupervised dispatcher's
                          over the same pools and run's root ids and
                          value; 315 MB saves
  serve_kmedoid           QueryEngine: 32 queries over 400-image pools, k
                          ∈ {50, 100, 200}, plus a knapsack and a sampled
                          query (solo): one greedy_loop_resident launch
                          an admitted batch, every query equal to its
                          solo greedy() run bit for bit; p50/p99
  supervised_kcover       (after kcover_run) clean == kcover_run's root,
                          a transient failure replayed to the clean bits,
                          lane 7 dead → tree (16, 2, 4) at ≥ 0.95×, a run
                          stopped after level 2 resumed to the clean root
  serve_kcover            64 queries of 128 kosarak sets (k = 64) plus a
                          knapsack and a sampled query, as serve_kmedoid
  supervised_stream       (after continuous_kcover) a transient merge
                          failure: merges and digest equal
                          continuous_kcover's; a lost lane (lane_reset);
                          stream_select checkpointed, stopped at half and
                          resumed equal to stream_kcover bit for bit
  tenant_session          a TenantSession over the same stream equal to
                          continuous_kcover
  supervised_distributed  (after distributed_kdom) 8 gloo ranks: clean
                          == distributed_kdom's root, replay == clean,
                          lane 7 dead → a 4-rank subset mesh equal to the
                          stacked supervised run with that failure
  faultrun_smoke          `python -m repro_torch.launch.faultrun
                          --smoke` on the card exits 0
  slice13_total           the seconds these phases added

and the selection launchers and the measured-plan cache, after them
(each CLI a subprocess on the card, `--device cuda`, the kernels already
built):

  summarize               `launch.summarize --compare` at the registry's
                          paper-kcover, paper-kdom and paper-kmedoid
                          (dense engine) and paper-kcover --engine lazy:
                          the GreedyML / RandGreedi / Greedy lines, the
                          quality ratios, each run's seconds; dense
                          kcover's and kdom's trees equal to the same
                          trees run here through run_tree_dense
  stream_cli              `launch.stream --smoke` exits 0; facility at
                          the CLI's defaults (n 2,048, d 64, k 32, B 128)
                          one sieve, --continuous and --distributed (4
                          gloo ranks on the card): value and arrivals/s,
                          the distributed run equal to the continuous one,
                          its merged values bit for bit
  qserve                  `launch.qserve --smoke` (one resident launch an
                          admitted batch); `run` at 8 tenants, n 256,
                          d 32, k 16, --qps 50 and 200 for 5 s each: p50,
                          p99, served queries/s, mean batch; the same
                          `run` again in this (warm) process
  autotune                autotune.tune_one at the k-medoid leaf (3,125²
                          × 12,288, k = 200), node (400²) and the kosarak
                          leaf (30,938 sets × 1,290 words, k = 64): every
                          candidate's tier, storage, chunk, ms,
                          dispatches and identity verdict, the winner;
                          then `run`'s tree (data drawn again) with
                          REPRO_TORCH_AUTOTUNE_CACHE on those entries:
                          each stage's engine and storage, the root's ids
                          equal to `run`'s
  autotune_smoke          `launch.autotune --smoke` writes its cache; a
                          following select_engine returns the entry
  slice14_total           the seconds these phases added

and the model zoo's serving path (models/, launch/{steps,serve}.py:
plain PyTorch, no kernel of the port; the kernels line is unchanged),
last:

  model_parity            the ten architectures at smoke_config (f32):
                          forward, prefill and 8 greedy decode steps on
                          the card against the same parameters on the
                          CPU (logits within 1e-4 max abs, the same
                          greedy tokens); prefill(S) + decode(token
                          S) against the forward within 1e-3; h2o-danube's
                          SWA ring past its window of 16
  serve_qwen2p5_3b        `launch.serve.main` in process at qwen2.5-3b's
                          full width and depth: batch 4, prompt 512, 32
                          greedy tokens after a warm-up round; prefill ms,
                          decode ms a step beside its bytes bound (the
                          f32 parameters once a step at 3.35 TB/s),
                          tokens/s, peak memory, parameters against the
                          published 3.09 B, a profiled decode step (the
                          device's busy share, its largest kernels); a
                          teacher-forced forward over prompt + generation
                          picks every decoded token but where its top-2
                          logits lie within 0.05, on this bf16 run and on
                          a float32 run of the same model
  serve_mamba2            the same at mamba2-1.3b (48 SSD layers, chunk
                          256, d_state 128); the check held on the
                          float32 run (the bf16 chunk scan rounds its
                          mixing matrix, decode does not), reported for
                          the bf16 run
  serve_moe               the same at qwen3-moe-30b-a3b's full width,
                          depth cut 48 → 4 (128 experts, top-8, d_expert
                          768, groups of 512 at capacity 40), with the
                          MoE drop fractions; the check reported for
                          that run and a bf16 run at capacity factor 16
                          (no drop; router near-ties still flip); a
                          bf16 run with top-k = all 128 experts (no
                          selection) held to a largest logit difference
                          of 0.3, and the check held on a float32 run at
                          no drop (the same weights and prompt)
  serve_cli               `python -m repro_torch.launch.serve --arch
                          smollm-135m --smoke --prompt-len 32 --gen 8
                          --batch 2` exits 0 and prints prefill and tok/s
  slice15_total           the seconds these phases added

and the training path (optim/, data/pipeline.py, the models with
gradients and remat, launch/{steps,train}.py), fed by the GreedyML
coreset (its selection's launches join the kernels line):

  train_parity            the ten architectures at smoke_config, 2
                          AdamW train steps (lr 3e-3 past a 2-step
                          warm-up) on the card against the CPU, each
                          from the CPU's state (optim/parity.py): every
                          moment within 1e-4 of its leaf's largest
                          entry, every parameter within 1e-4 of the
                          update its own moments imply, the losses
                          within 1e-4; a planted TF32 step and a
                          skipped update must fail those rules
  train_qwen2p5_3b        qwen2.5-3b at full width and depth (3.09 B
                          parameters, AdamW with f32 moments, remat
                          'block'), batch 4 × seq 512 from TokenDataset
                          over gen_tokens(512, 513, 151,936) with the
                          coreset chosen on the card by
                          greedyml:facility (k 256): 1 warm-up and 3
                          timed steps (CUDA events) beside the step's
                          bound, tokens/s, peak memory, the losses
                          (finite, the first near ln 151,936), and one
                          more step profiled (busy share, top kernels)
  train_cli               `python -m repro_torch.launch.train` at
                          smollm-135m's full width (seq 256, batch 8:
                          cut from 4,096 and 256), 30 steps, checkpoints
                          every 10, greedyml:facility: a run with
                          --fail-at 15 and one without, side by side;
                          their step-30 checkpoints equal bit for bit
  slice16_total           the seconds these phases added

and the sharded trainer over ranks (launch/steps.py over a DeviceMesh,
sharding/axes.py's constrain and named_sharding, the DTensor models and
optimizers):

  gloo_probe              2 gloo ranks on the card: which of
                          all_gather_into_tensor, reduce_scatter_tensor,
                          all_reduce and all_to_all_single gloo runs on
                          CUDA tensors in this torch
  train_sharded           qwen2.5-3b at full width, depth cut 36 → 4
                          (four ranks' state beside each other), AdamW
                          f32, remat 'block', batch 4 × seq 512: the
                          one-device step (two microbatches of 2 rows)
                          for 3 steps, then 4 gloo ranks on the card, a
                          (2, 2) ("data", "model") mesh, the same draw
                          and batches; each rank's shards held by
                          optim/parity.py (moments within 1e-4 of their
                          leaf's scale in the one-device run, parameters
                          within one f32 spacing plus 1e-4 of the update
                          their own moments imply), the losses equal on
                          every rank and within 1e-4 of the one-device
                          run's; per-rank peak memory and state bytes
                          beside a quarter of the one-device state, step
                          ms
  slice17_total           the seconds these phases added

and the compile-and-cost launchers (launch/dryrun.py, hillclimb.py: the
steps traced on the meta device over a fake world of 256 / 512 ranks,
counted a device by dryrun.CostMode, the kernels' declared costs):

  dryrun                  (a) both technique cells at full size on the
                          card in the single mesh's fake world: every
                          kernel call declared its cost; at n cut to
                          65,536 (k cut to 32) the same cells give
                          equal calls and declared costs on the card and
                          on the CPU; (b) qwen2.5-3b:train_4k on both
                          meshes; (c) train_qwen2p5_3b's own step (world
                          1, no mesh, f32, AdamW, remat 'block', 4 × 512,
                          36 layers) against what that phase measured:
                          dot flops against `_train_step_flops` (the
                          masked half of attention's products named),
                          total bytes against its peak memory, the
                          compute term at 67e12 FLOP/s against its step;
                          (d) hillclimb's smollm_dp_only and its terms
  slice18_total           the seconds these phases added

and, between the k-medoid phases and the coverage problems, the paper's
sequential Greedy on fused_step's global tier (the per-step fused kernel
past a thread-block cluster's shared memory: its chunk partials in
device memory, a span's last block summing them):

  sequential_kmedoid      (after timing_stream, the other k-medoid
                          tensors freed; the card holds the images, the
                          40 GB f32 cache and its 1.25 GB of partials,
                          ~46 GB) simulate.run_greedy_dense('kmedoid',
                          …) over all 100,000 images, k = 200, engine
                          auto: 1 pairwise and 200 fused_step launches;
                          wall, steps' and build's device ms, the
                          Greedy's global value beside `run`'s GreedyML
                          one and their ratio; the same cache again, 8
                          steps on the global tier and the earlier
                          design bit for bit, the Greedy's first 8 ids;
                          the global tier against its plain version at
                          100,000 rows × 2,048 candidates, each storage
  timing_fused_global     (the images freed) f32, bf16 and int8 at 1 ×
                          100,000² on the global tier and on the earlier
                          design (bit for bit) beside each bound; the
                          earlier design's row blocks and last-block sum
                          on the card's clock; the plain version; both
                          tiers at the gate's shapes in each storage
  slice20_total           the seconds these phases added

(`reference_dispatch` also runs small coverage trees, kernel path
against CPU path; every stream phase prints its summary's digest.) Then the card's name and power limit (nvidia-smi),
the {"kernels": …} line (twenty kernels), and as the last line
{"ok": true, "device": {…}}. The script
needs the repository's src/ beside it and a CUDA device; without either
it exits non-zero before printing any result. Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
# tensor cores — the kernels avoid TF32 — and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

REPLACES = {
    "pairwise": "src/repro/kernels/pairwise.py:53",
    "greedy_loop": "src/repro/kernels/greedy_loop.py:131",
    "greedy_loop_resident": "src/repro/kernels/greedy_loop.py:246",
    "fused_step": "src/repro/kernels/fused_step.py:88",
    "gains": "src/repro/kernels/pairwise.py:109",
    "gains[coverage]": "src/repro/kernels/pairwise.py:109 (_gains_kernel "
                       ":81, bitmap branch, grid :130-140)",
    "fused_step[coverage]": "src/repro/kernels/fused_step.py:88 "
                            "(_step_body :42, uint32 row)",
    "greedy_loop[coverage]": "src/repro/kernels/greedy_loop.py:131 "
                             "(_stream_body :54, uint32 words)",
    "greedy_loop_resident[coverage]": "src/repro/kernels/greedy_loop.py:246 "
                                      "(_resident_kernel :187, bits branch)",
    "pairwise[bf16]": "src/repro/kernels/pairwise.py:53 (_kernel :45, "
                      "out_dtype bfloat16)",
    "fused_step[bf16]": "src/repro/kernels/fused_step.py:88 (_kernel :71, "
                        "bf16 storage)",
    "fused_step[int8]": "src/repro/kernels/fused_step.py:88 "
                        "(_kernel_quant :77)",
    "greedy_loop[bf16]": "src/repro/kernels/greedy_loop.py:131 "
                         "(_stream_kernel :107, bf16 storage)",
    "greedy_loop[int8]": "src/repro/kernels/greedy_loop.py:131 "
                         "(_stream_kernel_quant :116)",
    "greedy_loop_resident[bf16]": "src/repro/kernels/greedy_loop.py:246 "
                                  "(_resident_kernel :187, bf16 rounding "
                                  ":207-208)",
    "greedy_loop_resident[int8]": "src/repro/kernels/greedy_loop.py:246 "
                                  "(_resident_kernel :187, int8 rounding "
                                  ":196-206)",
    "stream_filter": "src/repro/kernels/stream_filter.py:138 (_kernel "
                     ":118, _body :53)",
    "stream_filter[int8]": "src/repro/kernels/stream_filter.py:138 "
                           "(_kernel :118, int8 ground :120-125)",
    "stream_filter[coverage]": "src/repro/kernels/stream_filter.py:138 "
                               "(_body :53, bits rule)",
    "gains[int8]": "src/repro/kernels/pairwise.py:109 "
                   "(_gains_kernel_quant :93)",
}
SOURCES = {
    "pairwise": "src/repro_torch/csrc/pairwise.cu",
    "greedy_loop": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident": "src/repro_torch/csrc/greedy_loop_resident.cu",
    "fused_step": "src/repro_torch/csrc/fused_step.cu",
    "gains": "src/repro_torch/csrc/gains.cu",
    "gains[coverage]": "src/repro_torch/csrc/gains.cu",
    "fused_step[coverage]": "src/repro_torch/csrc/fused_step.cu",
    "greedy_loop[coverage]": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident[coverage]":
        "src/repro_torch/csrc/greedy_loop_resident.cu",
    "pairwise[bf16]": "src/repro_torch/csrc/pairwise.cu",
    "fused_step[bf16]": "src/repro_torch/csrc/fused_step.cu",
    "fused_step[int8]": "src/repro_torch/csrc/fused_step.cu",
    "greedy_loop[bf16]": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop[int8]": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident[bf16]":
        "src/repro_torch/csrc/greedy_loop_resident.cu",
    "greedy_loop_resident[int8]":
        "src/repro_torch/csrc/greedy_loop_resident.cu",
    "stream_filter": "src/repro_torch/csrc/stream_filter.cu",
    "stream_filter[int8]": "src/repro_torch/csrc/stream_filter.cu",
    "stream_filter[coverage]": "src/repro_torch/csrc/stream_filter.cu",
    "gains[int8]": "src/repro_torch/csrc/gains.cu",
}
# the knapsack run's budget (costs uniform(0.5, 2): ~80 of k = 200 fit)
BUDGET = 100.0
# the kcover knapsack run's budget (~32 of k = 64 fit)
BUDGET_KCOVER = 40.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at fp32 peak
    and the compulsory bytes at HBM peak."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))


def on_chip_bytes(torch) -> float:
    """L2 plus every SM's shared memory of device 0 (H100 SXM: 50 MB +
    132 × 228 KB where torch does not report them)."""
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", 50 * 2 ** 20)
    smem = getattr(props, "shared_memory_per_multiprocessor", 228 * 2 ** 10)
    return float(l2 + props.multi_processor_count * smem)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi_under_load(torch, fn, calls: int) -> str:
    """The card's SM clock and power draw (nvidia-smi) read while `calls`
    enqueued calls of fn run."""
    for _ in range(calls):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000,
                   help="images (Tiny-ImageNet: 100,000)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions per kernel")
    return p.parse_args(argv)


def sample_size(pool: int, k: int, eps: float = 0.01) -> int:
    """Stochastic greedy's subset size ⌈(n/k)·ln(1/ε)⌉ (Mirzasoleiman et
    al. 2015) for a pool of n elements."""
    return math.ceil(pool / k * math.log(1.0 / eps))


def lane_pools(torch, x, lanes: int, seed: int):
    """The dispatcher runs' lanes: the elements permuted with the seed and
    cut into `lanes` contiguous pools (shard_lanes) → ids, payloads,
    valid on the card. Where `lanes` does not divide n, the permutation
    is padded at its end with invalid slots (id −1, zero payload)."""
    from repro_torch.core.greedyml import shard_lanes
    n = x.shape[0]
    n_pad = -(-n // lanes) * lanes
    perm = np.full(n_pad, -1, np.int64)
    perm[:n] = np.random.default_rng(seed).permutation(n)
    perm = torch.as_tensor(perm, device=x.device)
    pay = x[perm.clamp(min=0)]
    pay[perm < 0] = 0
    return shard_lanes(perm, pay, perm >= 0, lanes)


def knapsack_costs(n: int, seed: int) -> np.ndarray:
    """Per-image costs by global id: the recipe of the reference's
    constraint tests (uniform(0.5, 2.0) from the seed), f32."""
    return np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(
        np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.load(name)
    report = {}
    for name in build.SOURCES:
        lines = [ln.strip() for ln in build.ptxas_report(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        report[name] = lines
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_in_this_run": build.BUILD_SECONDS is not None,
          "ptxas": report})


def leaf_pools(torch, x, m: int, seed: int):
    """The run's padded leaf pools, as run_tree_dense builds them."""
    from repro_torch.core.simulate import _pools, partition
    ids, valid = _pools(partition(x.shape[0], m, seed), m)
    ids_t = torch.as_tensor(ids, device=x.device)
    pay = x[ids_t.clamp(min=0)]
    pay[ids_t < 0] = 0
    return ids_t, pay, torch.as_tensor(valid, device=x.device)


def node_pools(torch, x, nodes: int, size: int, seed: int):
    """`nodes` pools of `size` distinct random images: a level's node
    shape (ground = pool = b·k)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    idx = torch.stack([torch.randperm(x.shape[0], generator=gen,
                                      device=x.device)[:size]
                       for _ in range(nodes)])
    return x[idx].contiguous()


def _pairwise_parity(torch, P, parity, g, c, discriminate: bool):
    """The pairwise kernel in both modes against its plain version, under
    kernels/parity.py's float64 rule. With `discriminate`, also show that
    the rule rejects the plain version with TF32 products and the plain
    version with 16 features dropped."""
    out = {}
    for mode in ("dot", "dist"):
        got = P.pairwise(g, c, mode)
        plain = P.pairwise_plain(g, c, mode)
        exact = parity.exact_matrix(g, c, mode)
        stats = parity.pairwise_stats(got, plain, exact, mode)
        assert parity.pairwise_holds(stats), (
            f"pairwise {mode} {tuple(g.shape)}: {stats}")
        stats["max_abs_diff"] = float((got - plain).abs().max())
        del got
        if discriminate:
            keep = torch.ones(g.shape[-1], dtype=torch.bool, device=g.device)
            keep[g.shape[-1] // 2:g.shape[-1] // 2 + 16] = False
            bad = {"drop16": P.pairwise_plain(g[..., keep].contiguous(),
                                              c[..., keep].contiguous(),
                                              mode)}
            if g.is_cuda:               # TF32 exists only on the card
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    bad["tf32"] = P.pairwise_plain(g, c, mode)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            for name, build in bad.items():
                bs = parity.pairwise_stats(build, plain, exact, mode)
                assert not parity.pairwise_holds(bs), (
                    f"the pairwise rule passes the {name} build: {bs}")
                stats[f"{name}_rms_ratio"] = bs["rms_ratio"]
                stats[f"{name}_max_ratio"] = bs["max_ratio"]
            del bad
        out[mode] = stats
        del plain, exact
    return out


def _fused_step_parity(torch, F, parity, R, rules, mat_of, b, n, seed):
    """fused_step against its plain version over the plain matrices of
    `b` greedies of `n` elements (mat_of(rule) builds them), a random
    feasible mask (80% of the candidates) and a random previous winner,
    for every rule; then a second step from the first step's outputs."""
    out = {}
    for name, rule in rules.items():
        mat, row = mat_of(rule)
        gen = torch.Generator(device=mat.device).manual_seed(seed)
        mask = (torch.rand(b, n, generator=gen, device=mat.device)
                > 0.2).float()
        prev = torch.randint(0, n, (b,), generator=gen, device=mat.device)
        kern = F.fused_step(mat, row, mask, prev, rule)
        plain = F.fused_step_plain(mat, row, mask, prev, rule)
        res = parity.compare_steps(kern, plain, mat, mask, rule,
                                   what=f"fused_step {name}")
        yard = parity.compare_exact(kern, F.fused_step(
            mat, row, mask, prev, rule, reference=True),
            f"fused_step {name} vs the earlier design")
        mask2 = mask.scatter(1, plain[1][:, None], 0.0)
        kern2 = F.fused_step(mat, plain[0], mask2, plain[1], rule)
        plain2 = F.fused_step_plain(mat, plain[0], mask2, plain[1], rule)
        res2 = parity.compare_steps(kern2, plain2, mat, mask2, rule,
                                    what=f"fused_step {name}, step 2")
        yard2 = parity.compare_exact(kern2, F.fused_step(
            mat, plain[0], mask2, plain[1], rule, reference=True),
            f"fused_step {name} vs the earlier design, step 2")
        res["max_gain_err"] = max(res["max_gain_err"], res2["max_gain_err"])
        res["ties"] += res2["ties"]
        res["vs_earlier_design"] = {
            "entries": yard["entries"] + yard2["entries"],
            "differing": yard["differing"] + yard2["differing"]}
        out[name] = res
        del mat, row
    return out


def _gains_parity(torch, P, parity, R, rules, ground, cands):
    """gains against its plain version under the float64 ratio rule, on a
    live state row (five pool elements folded in), every rule; for the
    path's rule also the plain version with TF32 products, which the
    rule must reject."""
    out = {}
    b, c = cands.shape[:2]
    valid = torch.ones(ground.shape[:2], dtype=torch.bool,
                       device=ground.device)
    cand_valid = torch.ones(b, c, dtype=torch.bool, device=ground.device)
    cand_valid[:, -1] = False
    for name, rule in rules.items():
        row = R.empty_row(ground, valid, rule)
        for j in range(5):
            row = R.update_row(ground, row,
                               ground[:, 97 * j % ground.shape[1]], rule)
        row = row.contiguous()
        gnorm = (P.ground_norms(ground) if rule.pairwise == "dist"
                 else None)
        got = P.gains(ground, row, cands, cand_valid, rule, gnorm=gnorm)
        plain = P.gains_plain(ground, row, cands, cand_valid, rule)
        exact = parity.exact_gains(ground, row, cands, rule)
        stats = parity.gains_stats(got, plain, exact)
        assert parity.pairwise_holds(stats), f"gains {name}: {stats}"
        fin = torch.isfinite(plain)
        stats["max_abs_diff"] = float((got[fin] - plain[fin]).abs().max())
        parity.compare_exact(got, P.gains(ground, row, cands, cand_valid,
                                          rule),
                             f"gains {name}: norms passed vs computed")
        yard = parity.compare_exact(got, P.gains(
            ground, row, cands, cand_valid, rule, reference=True),
            f"gains {name} vs the 64x64 build")
        stats["vs_64x64_build"] = {"entries": yard["entries"],
                                   "differing": yard["differing"]}
        if rule.fold == "min" and ground.is_cuda:   # TF32 only on the card
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = P.gains_plain(ground, row, cands, cand_valid, rule)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            bad = parity.gains_stats(tf32, plain, exact)
            assert not parity.pairwise_holds(bad), (
                f"the gains rule passes a TF32 build: {bad}")
            stats["tf32_rms_ratio"] = bad["rms_ratio"]
            stats["tf32_max_ratio"] = bad["max_ratio"]
        out[name] = stats
    return out


def phase_parity_steps(torch, x, cfg, pools):
    """The per-step kernels against their plain versions on the card
    (kernels/parity.py states the rules and their reasons):
      fused_step at the knapsack run's leaf shape (its 32 lanes of
                 3,125) and node shape (32 lanes of b·k = 400): the
                 folded rows equal bit for bit, the chosen gain within
                 4·√N·eps·|g|, the chosen column equal unless the plain
                 gains of both choices lie within that bound;
      gains      at the stochastic run's leaf shape (32 lanes of 3,125
                 ground rows, 72 sampled candidates each): error from a
                 float64 build ≤ 1.5× (RMS) / 2× (max) the plain f32
                 version's; a TF32 build must fail that rule."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rules = {"kmedoid": R.DIST_MIN, "facility": R.DOT_MAX,
             "satcover": R.sat_sum(2.0), "graphcut": R.graph_cut(0.5),
             "mmr": R.mmr(0.5, 2.0)}
    seed = cfg.seed
    _, pay, valid = pools
    b, n, d = pay.shape
    lanes = b

    def leaf_mat(rule):
        return (P.pairwise_plain(pay, pay, rule.pairwise).contiguous(),
                R.empty_row(pay, valid, rule).contiguous())

    out = {"fused_step": {"leaf": _fused_step_parity(
        torch, F, parity, R, rules, leaf_mat, b, n, seed)}}
    sample = sample_size(n, cfg.k)
    idx = LaneSampler(seed)(0, lanes, 1, n, sample)[:, 0].to(x.device)
    cands = torch.gather(pay, 1, idx[..., None].expand(b, sample, d))
    out["gains"] = _gains_parity(torch, P, parity, R,
                                 {"kmedoid": R.DIST_MIN,
                                  "facility": R.DOT_MAX},
                                 pay, cands.contiguous())
    del cands
    bk = cfg.branching * cfg.k
    nodes = node_pools(torch, x, lanes, bk, seed + 2)
    nvalid = torch.ones(lanes, bk, dtype=torch.bool, device=x.device)

    def node_mat(rule):
        return (P.pairwise_plain(nodes, nodes, rule.pairwise).contiguous(),
                R.empty_row(nodes, nvalid, rule).contiguous())

    out["fused_step"]["node"] = _fused_step_parity(
        torch, F, parity, R, rules, node_mat, lanes, bk, seed)
    emit({"phase": "parity_steps", "fused_step_leaf_shape": [b, n, n],
          "fused_step_node_shape": [lanes, bk, bk],
          "gains_shape": [b, n, sample, d], **out})
    return {"fused_step": out["fused_step"]["leaf"]["kmedoid"]
            ["max_gain_err"],
            "gains": out["gains"]["kmedoid"]["max_abs_diff"]}


def _loop_vs_fused_step(L, parity, mat, row, mask, k, rule, scale=None,
                        what="greedy_loop"):
    """The streaming loop against k fused_step launches over the same
    cache (the winner passed on, the mask threaded), bit for bit; with
    the loop's plan (blocks, span groups and ranks a greedy)."""
    res = parity.compare_exact(
        L.greedy_loop(mat, row, mask, k, rule, scale=scale),
        L.fused_steps(mat, row, mask, k, rule, scale=scale),
        f"{what} vs {k} fused_step launches")
    return dict(res, plan=L.loop_plan(mat))


def _resident_vs_loop(torch, L, parity, cd, row, mask, ctl, k, rule, dt,
                      built, what="greedy_loop_resident"):
    """The resident loop against the streaming loop over the matrix it
    ran over (its f32 values, read back into `built`), bit for bit; with
    where its steps kept the matrix ('chip' or 'device')."""
    got = L.greedy_loop_resident(cd, cd, row, mask, ctl, k, rule,
                                 cache_dtype=dt, scratch=built)
    res = parity.compare_exact(got, L.greedy_loop(built, row, mask, k, rule),
                               f"{what} vs greedy_loop over its matrix")
    return got, dict(res, tier=L.resident_tier(*built.shape[1:], dt))


def phase_parity(torch, x, cfg, seed):
    """Each kernel against its plain version on the card
    (kernels/parity.py states the rules and their reasons):
      pairwise   at the first leaf's shape and at a level's node shape,
                 'dot' and 'dist' ('dist' in squared form: the square
                 root amplifies rounding near zero); the kernel's error
                 from a float64 build may be at most 1.5× (RMS) and 2×
                 (largest entry) the plain f32 version's. At the leaf
                 shape the phase also shows that this rule rejects
                 torch.matmul with TF32 and a build missing 16 features.
      loops      equal selections step for step, except at a genuine
                 tie; gains within the reordering bound 4·√N·eps·|g|,
                 rows within 4·eps·|r|. The streaming loop is fed the
                 plain matrix. The resident loop builds its own, which
                 the phase reads back: it must equal the pairwise
                 kernel's bit for bit (the pairwise kernel's 128×128
                 tile computes each entry as the resident build's
                 64×64 tile does), and its entry differences ΔM from
                 the plain matrix widen each compared gain by its
                 column's Σ_i ΔM[i, c] plus the summed row error.
      pairwise[bf16] at the node shape by the float64 rule (the leaf
                 shape's check is parity_quant's)."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rules = {"kmedoid": R.DIST_MIN, "facility": R.DOT_MAX,
             "satcover": R.sat_sum(2.0), "graphcut": R.graph_cut(0.5),
             "mmr": R.mmr(0.5, 2.0)}
    out = {"pairwise": {}, "greedy_loop": {}, "greedy_loop_resident": {}}
    _, pay, valid = leaf_pools(torch, x, cfg.num_machines, seed)
    # the leaf level's loop (32 × 3,284²) against k fused_step launches
    rule = rules["kmedoid"]
    mat = P.pairwise(pay, pay, rule.pairwise)
    out["loop_vs_fused_step"] = _loop_vs_fused_step(
        L, parity, mat, R.empty_row(pay, valid, rule).contiguous(),
        valid.float().contiguous(), cfg.k, rule)
    del mat
    g = pay[:1].contiguous()                       # the first leaf
    v = valid[:1]
    del pay, valid
    n_leaf = g.shape[1]
    out["pairwise"]["leaf"] = _pairwise_parity(torch, P, parity, g, g,
                                               discriminate=True)
    for name, rule in rules.items():
        mat = P.pairwise_plain(g, g, rule.pairwise).contiguous()
        row = R.empty_row(g, v, rule).contiguous()
        mask = v.float().contiguous()
        kern = L.greedy_loop(mat, row, mask, cfg.k, rule)
        plain = L.greedy_loop_plain(mat, row, mask, cfg.k, rule)
        res = parity.compare_loops(kern, plain, rule,
                                   what=f"greedy_loop {name}")
        res["accepted"] = int((plain[1] >= 0).sum())
        out["greedy_loop"][name] = res
        del mat
    del g
    nodes = cfg.num_machines // cfg.branching
    bk = cfg.branching * cfg.k
    cd = node_pools(torch, x, nodes, bk, seed)
    out["pairwise"]["node"] = _pairwise_parity(torch, P, parity, cd, cd,
                                               discriminate=False)
    out["pairwise[bf16]"] = {"node": {
        mode: _bf16_pairwise_rule(torch, cd, mode)
        for mode in ("dot", "dist")}}
    equal_builds = 0
    out["resident_vs_loop"] = {}
    for name, rule in rules.items():
        vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
        row = R.empty_row(cd, vv, rule).contiguous()
        mask = vv.float().contiguous()
        ctl = torch.tensor([[cfg.k, bk, bk]] * nodes, dtype=torch.int32,
                           device=x.device)
        built = torch.empty(nodes, bk, bk, device=x.device)
        kern, out["resident_vs_loop"][name] = _resident_vs_loop(
            torch, L, parity, cd, row, mask, ctl, cfg.k, rule, "float32",
            built, f"greedy_loop_resident {name}")
        assert torch.equal(built, P.pairwise(cd, cd, rule.pairwise)), \
            f"resident {name}: its build is not the pairwise kernel's"
        equal_builds += 1
        plain = L.greedy_loop_resident_plain(cd, cd, row, mask, ctl, cfg.k,
                                             rule)
        diff = (built - L.resident_matrix(cd, cd, rule)).abs()
        res = parity.compare_loops(kern, plain, rule, entry_diff=diff,
                                   what=f"greedy_loop_resident {name}")
        res["max_entry_diff"] = float(diff.max())
        out["greedy_loop_resident"][name] = res
        del built, diff
    emit({"phase": "parity", "leaf_shape": [1, n_leaf, n_leaf, x.shape[1]],
          "node_shape": [nodes, bk, bk, x.shape[1]],
          "pairwise_equals_resident_build": {"rules": equal_builds,
                                             "bit_for_bit": True},
          **out})
    return {"pairwise": out["pairwise"]["leaf"]["dist"]["max_abs_diff"],
            "greedy_loop": out["greedy_loop"]["kmedoid"]["max_gain_err"],
            "greedy_loop_resident":
                out["greedy_loop_resident"]["kmedoid"]["max_gain_err"]}


def phase_reference(torch):
    """A small tree through the kernels against the same tree through
    the plain CPU path. On small-integer features the facility run is
    exact arithmetic on both paths (integer dot products, integer gain
    parts), so ids, values and counts must be EQUAL; leaves are forced
    onto the streaming tier (a 1 MB L2 share) so both loop kernels and
    the pairwise kernel run. The kmedoid run on real-valued data must
    match counts, and reports whether rounding split a tie."""
    from repro_torch.core.simulate import run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.data.synthetic import gen_images
    from repro_torch.kernels import counters
    from repro_torch.runtime import flags
    rng = np.random.default_rng(5)
    xi = rng.integers(-3, 4, (4096, 64)).astype(np.float32)
    old = os.environ.get(flags.RESIDENT_L2_MB_ENV)
    os.environ[flags.RESIDENT_L2_MB_ENV] = "1"
    try:
        counters.reset()
        gpu = run_tree_dense("facility", xi, 8, AccumulationTree(8, 2),
                             seed=3, device="cuda")
        launched = {n: c["launches"] for n, c in
                    counters.snapshot().items() if c["launches"]}
        cpu = run_tree_dense("facility", xi, 8, AccumulationTree(8, 2),
                             seed=3, device="cpu")
    finally:
        if old is None:
            del os.environ[flags.RESIDENT_L2_MB_ENV]
        else:
            os.environ[flags.RESIDENT_L2_MB_ENV] = old
    assert all(launched.get(n, 0) > 0 for n in
               ("pairwise", "greedy_loop", "greedy_loop_resident")), launched
    assert np.array_equal(gpu.ids, cpu.ids), (gpu.ids, cpu.ids)
    assert gpu.value == cpu.value and gpu.root_value == cpu.root_value
    assert gpu.per_node_evals == cpu.per_node_evals
    assert gpu.comm_elements == cpu.comm_elements
    xr = gen_images(2048, 64, classes=16, seed=7)
    gk = run_tree_dense("kmedoid", xr, 8, AccumulationTree(8, 2), seed=1,
                        device="cuda")
    ck = run_tree_dense("kmedoid", xr, 8, AccumulationTree(8, 2), seed=1,
                        device="cpu")
    assert gk.per_node_evals == ck.per_node_evals
    assert gk.comm_elements == ck.comm_elements
    assert np.isfinite(gk.value) and len(gk.ids) <= 8
    emit({"phase": "reference", "facility_integer": {
        "ids_equal": True, "value": gpu.value, "launches": launched},
        "kmedoid_small": {"ids_equal": bool(np.array_equal(gk.ids, ck.ids)),
                          "value_gpu": gk.value, "value_cpu": ck.value}})


def _dispatch_tree(torch, name, data, k, radices, device, universe=0, **kw):
    """A LevelDispatcher tree over contiguous lanes of `data` on
    `device` → the stacked lane state after the last level."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import LevelDispatcher, shard_lanes
    from repro_torch.kernels.rules import to_words
    obj = make_objective(name, universe=universe, device=device)
    disp = LevelDispatcher(obj, k, radices, **kw)
    n = data.shape[0]
    pay = to_words(data) if obj.rule.is_bitmap else torch.as_tensor(data)
    ids, pay, val = shard_lanes(
        torch.arange(n, device=obj.device), pay.to(obj.device),
        torch.ones(n, dtype=torch.bool, device=obj.device), disp.lanes)
    sols = disp.leaves(ids, pay, val)
    for lvl in range(disp.num_levels):
        sols = disp.level(sols, lvl)
    return sols


def phase_reference_dispatch(torch, devices=("cuda", "cpu")):
    """LevelDispatcher trees through the kernels against the same trees
    through the plain CPU path, on small-integer facility data (integer
    dot products and gain parts: exact on both paths, so ties break
    alike): a knapsack tree whose costs are quarters (exact f32 sums) —
    fused engine, pairwise + fused_step kernels — and a stochastic tree
    whose draws come from CPU generators on both paths — step engine at
    the leaves (gains kernel), resident loop at the nodes. Ids, values
    and every lane's spent must be EQUAL. Then the same two trees on
    k-cover bitmaps (integer gains: exact everywhere), and
    run_tree_dense('kcover', …) with the leaves on the resident tier
    and, with a 10 KB L2 share, on the streaming tier — all four bitmap
    kernels against the CPU path."""
    from repro_torch.core.constraints import KnapsackSpec
    from repro_torch.core.simulate import run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.data.synthetic import gen_kcover, pack_bitmaps
    from repro_torch.kernels import counters
    from repro_torch.runtime import flags
    rng = np.random.default_rng(6)
    xi = rng.integers(-3, 4, (4096, 64)).astype(np.float32)
    costs = rng.integers(2, 9, 4096).astype(np.float32) / 4.0
    bits = pack_bitmaps(gen_kcover(4096, 2000, seed=8), 2000)
    out = {}
    cases = {"knapsack": ("facility", xi, dict(budget=6.0)),
             "stochastic": ("facility", xi, dict(sample_leaf=64, seed=4)),
             "kcover_knapsack": ("kcover", bits, dict(budget=6.0)),
             "kcover_stochastic": ("kcover", bits,
                                   dict(sample_leaf=64, seed=4))}
    wants = {"knapsack": ["fused_step"], "stochastic": ["gains"],
             "kcover_knapsack": ["fused_step[coverage]"],
             "kcover_stochastic": ["gains[coverage]",
                                   "greedy_loop_resident[coverage]"]}
    for case, (name, data, kw) in cases.items():
        runs = {}
        for dev in devices:
            spec = (KnapsackSpec(torch.as_tensor(costs, device=dev),
                                 kw["budget"]) if "budget" in kw else None)
            extra = {k: v for k, v in kw.items() if k != "budget"}
            counters.reset()
            sols = _dispatch_tree(torch, name, data, 8, (2, 2, 2), dev,
                                  universe=2000, constraint=spec, **extra)
            launched = {n: c["launches"] for n, c in
                        counters.snapshot().items() if c["launches"]}
            spent = (spec.spent(sols.ids, sols.valid).cpu().numpy()
                     if spec is not None else None)
            runs[dev] = (sols.map(lambda t: t.cpu()), spent, launched)
        (g, g_spent, launched), (c, c_spent, _) = (runs[d] for d in devices)
        assert torch.equal(g.ids, c.ids), (case, g.ids, c.ids)
        assert torch.equal(g.value, c.value), (case, g.value, c.value)
        assert torch.equal(g.evals, c.evals), case
        assert all(launched.get(w, 0) > 0 for w in wants[case]), (
            case, launched)
        assert launched.get("pairwise", 0) == 0 or name != "kcover"
        if g_spent is not None:
            assert np.array_equal(g_spent, c_spent), (g_spent, c_spent)
            assert (g_spent <= kw["budget"]).all(), g_spent
        out[case] = {"ids_equal": True, "root_ids": g.ids[0].tolist(),
                     "root_value": float(g.value[0]), "launches": launched,
                     "spent": None if g_spent is None else g_spent.tolist()}
    # run_tree_dense on bitmaps: resident leaves, then streaming leaves
    old = os.environ.get(flags.RESIDENT_L2_MB_ENV)
    for tier, l2 in (("resident", None), ("streaming", "0.01")):
        runs = {}
        try:
            if l2 is not None:
                os.environ[flags.RESIDENT_L2_MB_ENV] = l2
            for dev in devices:
                counters.reset()
                res = run_tree_dense("kcover", bits, 8, AccumulationTree(8, 2),
                                     seed=3, universe=2000, device=dev)
                runs[dev] = (res, {n: c["launches"] for n, c in
                                   counters.snapshot().items()
                                   if c["launches"]})
        finally:
            if old is None:
                os.environ.pop(flags.RESIDENT_L2_MB_ENV, None)
            else:
                os.environ[flags.RESIDENT_L2_MB_ENV] = old
        (g, launched), (c, _) = (runs[d] for d in devices)
        want = ["greedy_loop_resident[coverage]"] + (
            ["greedy_loop[coverage]"] if tier == "streaming" else [])
        assert all(launched.get(w, 0) > 0 for w in want), (tier, launched)
        assert "pairwise" not in launched, launched
        assert np.array_equal(g.ids, c.ids), (tier, g.ids, c.ids)
        assert g.value == c.value and g.root_value == c.root_value
        assert g.per_node_evals == c.per_node_evals
        out[f"kcover_tree_{tier}"] = {"ids_equal": True, "value": g.value,
                                      "launches": launched}
    emit({"phase": "reference_dispatch", **out})


def _level_hook(torch, levels):
    """on_level callback for run_tree_dense: per-level wall time and
    launches (counters reset after each level)."""
    from repro_torch.kernels import counters
    torch.cuda.synchronize()
    t_last = [time.perf_counter()]

    def on_level(lvl):
        torch.cuda.synchronize()
        now = time.perf_counter()
        levels.append({"level": lvl, "seconds": now - t_last[0],
                       "launches": {n: c["launches"] for n, c in
                                    counters.snapshot().items()
                                    if c["launches"]}})
        counters.reset()
        t_last[0] = time.perf_counter()
    return on_level


def phase_run(torch, x, cfg):
    from repro_torch.core.simulate import (global_value, partition,
                                           run_tree_dense)
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import select_engine
    from repro_torch.kernels.rules import DIST_MIN
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    levels = []
    counters.reset()
    on_level = _level_hook(torch, levels)
    t0 = time.perf_counter()
    res = run_tree_dense("kmedoid", x, cfg.k, tree, seed=cfg.seed,
                         device=x.device, on_level=on_level)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = {}
    for lv in levels:
        for name, c in lv["launches"].items():
            totals[name] = totals.get(name, 0) + c
    # launches per level follow the tier the planner picks there: 2 for
    # a streaming stage (pairwise + loop), 1 for a resident one, plus one
    # replay pairwise per accumulation level (at full size: leaves
    # streaming, every node level resident)
    n_leaf = int(np.bincount(partition(x.shape[0], cfg.num_machines,
                                       cfg.seed)).max())
    for lv in levels:
        lvl = lv["level"]
        n_stage = n_leaf if lvl == 0 else cfg.branching * cfg.k
        reps_ = (cfg.num_machines if lvl == 0
                 else len(tree.nodes_at_level(lvl)))
        engine = select_engine(DIST_MIN, n_stage, n_stage, x.shape[1],
                               replicas=reps_).engine
        lv["engine"] = engine
        want = {"pairwise": int(lvl > 0), "greedy_loop": 0,
                "greedy_loop_resident": 0}
        if engine == "mega_stream":
            want["pairwise"] += 1
            want["greedy_loop"] = 1
        else:
            assert engine == "mega_resident", engine
            want["greedy_loop_resident"] = 1
        want = {n: v for n, v in want.items() if v}
        assert lv["launches"] == want, (lvl, lv["launches"], want)
    assert len(levels) == tree.num_levels + 1
    ids = np.asarray(res.ids)
    assert 0 < len(ids) <= cfg.k and len(set(ids.tolist())) == len(ids)
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    assert np.isfinite(res.value) and np.isfinite(res.root_value)
    # the root ids re-scored on all n images, apart from the run
    t1 = time.perf_counter()
    rescored = global_value("kmedoid", x, ids)
    torch.cuda.synchronize()
    rescore_s = time.perf_counter() - t1
    assert rescored == res.value, (rescored, res.value)
    emit({"phase": "run", "n": x.shape[0], "d": x.shape[1], "k": cfg.k,
          "m": cfg.num_machines, "b": cfg.branching,
          "levels": levels, "wall_seconds": wall,
          "root_value": res.root_value, "global_value": res.value,
          "global_value_recomputed": rescored,
          "global_value_seconds": rescore_s,
          "root_ids": len(ids), "evals_total": res.evals_total,
          "evals_critical": res.evals_critical,
          "comm_elements": res.comm_elements})
    return totals, (ids, res.value, res.root_value)


def _run_dispatcher(torch, x, cfg, pools, expect, objective="kmedoid",
                    **kw):
    """One LevelDispatcher tree over the run's lanes, stage by stage:
    per-stage wall time (host clock around synchronized work), the
    engine the planner picks there and the launches per kernel, each
    held to `expect(stage, engine)`, and the caching allocator's
    device allocations, frees and retries. Returns (stage reports,
    launch totals, the final lane state)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import LevelDispatcher
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import select_engine
    obj = make_objective(objective, universe=cfg.universe, device=x.device)
    radices = (cfg.branching,) * round(math.log(cfg.num_machines,
                                                cfg.branching))
    disp = LevelDispatcher(obj, cfg.k, radices, **kw)
    ids, pay, valid = pools
    stages, totals = [], {}
    sols = None
    def allocator():
        # cudaMalloc/cudaFree calls (each a host sync) and retries after
        # freeing the cache: what the caching allocator made a stage wait
        st = torch.cuda.memory_stats()
        return [st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")]

    for stage in range(disp.num_levels + 1):
        torch.cuda.synchronize()
        counters.reset()
        mem0 = allocator()
        t0 = time.perf_counter()
        if stage == 0:
            sols = disp.leaves(ids, pay, valid)
            n, sample = pay.shape[1], disp.sample_leaf
        else:
            sols = disp.level(sols, stage - 1)
            n, sample = cfg.branching * cfg.k, disp.sample_level
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: c["launches"] for k, c in
                    counters.snapshot().items() if c["launches"]}
        dims = ((obj.words, n, None) if obj.rule.is_bitmap
                else (n, n, x.shape[1]))
        engine = select_engine(obj.rule, *dims,
                               sampling=0 < sample < n,
                               constrained=kw.get("constraint") is not None,
                               replicas=disp.lanes).engine
        assert launches == expect(stage, engine), (stage, engine, launches)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        stages.append({"stage": stage, "engine": engine, "seconds": secs,
                       "launches": launches,
                       "device_allocs_frees_retries": [
                           b - a for a, b in zip(mem0, allocator())]})
    return stages, totals, sols


def _report_root(torch, x, sols, k, objective="kmedoid", data=None,
                 universe=0):
    """Root ids checked and re-scored on all n elements (`data`: what
    global_value scores, default x)."""
    from repro_torch.core.simulate import global_value
    root = sols.map(lambda t: t[0])
    ids = root.ids[root.valid].cpu().numpy()
    assert 0 < len(ids) <= k and len(set(ids.tolist())) == len(ids)
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    assert np.isfinite(float(root.value))
    t0 = time.perf_counter()
    gv = global_value(objective, x if data is None else data, ids,
                      universe=universe)
    torch.cuda.synchronize()
    return ids, {"accepted": len(ids), "root_value": float(root.value),
                 "global_value": gv,
                 "global_value_seconds": time.perf_counter() - t0,
                 "evals_root": int(root.evals)}


def phase_knapsack(torch, x, cfg, pools):
    """The constrained path: LevelDispatcher with a KnapsackSpec over the
    32 lanes. The constraint demotes every stage to the fused engine:
    one pairwise launch (the cache) + k fused_step launches per stage,
    plus the replay pairwise at each level."""
    from repro_torch.core.constraints import KnapsackSpec
    spec = KnapsackSpec(torch.as_tensor(knapsack_costs(x.shape[0], cfg.seed),
                                        device=x.device), BUDGET)

    def expect(stage, engine):
        assert engine == "fused", (stage, engine)
        return {"pairwise": 1 + (stage > 0), "fused_step": cfg.k}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(torch, x, cfg, pools, expect,
                                           constraint=spec)
    wall = time.perf_counter() - t0
    spent = spec.spent(sols.ids, sols.valid).cpu().numpy()
    assert (spent <= BUDGET).all(), spent
    ids, root = _report_root(torch, x, sols, cfg.k)
    assert len(ids) < cfg.k, "the budget did not bind"
    assert totals["fused_step"] == (len(stages)) * cfg.k
    emit({"phase": "knapsack", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k, "budget": BUDGET,
          "stages": stages, "wall_seconds": wall, **root,
          "spent_root": float(spent[0]), "spent_lanes": spent.tolist()})
    return totals


def phase_stochastic(torch, x, cfg, pools):
    """The stochastic path: sample_leaf = ⌈(n_l/k)·ln 100⌉ at the leaves
    (the per-step engine: one gains launch per step), nodes unsampled on
    the resident loop (+ the replay pairwise)."""
    sample = sample_size(pools[1].shape[1], cfg.k)

    def expect(stage, engine):
        if stage == 0:
            assert engine == "step", engine
            return {"gains": cfg.k, "gains_norms": 1}
        assert engine == "mega_resident", (stage, engine)
        return {"greedy_loop_resident": 1, "pairwise": 1}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(torch, x, cfg, pools, expect,
                                           sample_leaf=sample, seed=cfg.seed)
    wall = time.perf_counter() - t0
    _, root = _report_root(torch, x, sols, cfg.k)
    emit({"phase": "stochastic", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "sample_leaf": sample, "stages": stages, "wall_seconds": wall,
          **root})
    return totals


def phase_timing(torch, x, cfg, seed, reps):
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    out = {}
    _, pay, valid = leaf_pools(torch, x, cfg.num_machines, seed)
    b, n, d = pay.shape
    flops = 2.0 * b * n * n * d + 4.0 * b * n * d + 4.0 * b * n * n
    nbytes = 4.0 * b * (2 * n * d + n * n)
    bms, by = bound(flops, nbytes)
    out["pairwise"] = {
        "shape": [b, n, n, d],
        "ms": cuda_ms(torch, lambda: P.pairwise(pay, pay, "dist"), reps),
        "plain_ms": cuda_ms(torch, lambda: P.pairwise_plain(pay, pay, "dist"),
                            reps),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(
            pay, pay, compute_mode="use_mm_for_euclid_dist"), reps),
        "bound_ms": bms, "bound_by": by,
        # whether the fp32 pipes run at the clock of the 67 TFLOP/s peak
        "clock_and_power_under_load": smi_under_load(
            torch, lambda: P.pairwise(pay, pay, "dist"), 5)}
    # the 'dot' mode of the similarity rules at the same shape, beside
    # one batched torch.matmul (reported, not in the kernels line: the
    # main path's mode is 'dist')
    out["pairwise_dot"] = {
        "shape": [b, n, n, d],
        "ms": cuda_ms(torch, lambda: P.pairwise(pay, pay, "dot"), reps),
        "library_ms": cuda_ms(torch, lambda: torch.matmul(
            pay, pay.transpose(1, 2)), reps),
        "bound_ms": bound(2.0 * b * n * n * d, nbytes)[0]}
    mat = P.pairwise(pay, pay, "dist")
    row = R.empty_row(pay, valid, rule).contiguous()
    mask = valid.float().contiguous()
    del pay
    k = cfg.k
    flops = 3.0 * k * b * n * n
    # every step re-reads the caches; only what the chip holds (L2 plus
    # every SM's shared memory) could be kept from one step to the next
    cache = 4.0 * b * n * n
    nbytes = (k * cache - (k - 1) * min(cache, on_chip_bytes(torch))
              + 4.0 * 3 * b * n + 8.0 * b * k)
    bms, by = bound(flops, nbytes)
    out["greedy_loop"] = {
        "shape": [b, n, n, k],
        "ms": cuda_ms(torch, lambda: L.greedy_loop(mat, row, mask, k, rule),
                      reps),
        "fused_step_x_k_ms": _loop_vs_fused_steps(torch, mat, row, mask, k,
                                                  rule, None, reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_plain(
            mat, row, mask, k, rule), 1, warmup=0),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del mat, row, mask
    nodes = cfg.num_machines // cfg.branching
    bk = cfg.branching * cfg.k
    cd = node_pools(torch, x, nodes, bk, seed + 1)
    vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
    row = R.empty_row(cd, vv, rule).contiguous()
    mask = vv.float().contiguous()
    ctl = torch.tensor([[k, bk, bk]] * nodes, dtype=torch.int32,
                       device=x.device)
    flops = (2.0 * nodes * bk * bk * d + 4.0 * nodes * bk * d
             + 3.0 * k * nodes * bk * bk)
    nbytes = 4.0 * nodes * (2 * bk * d + 3 * bk) + 12.0 * nodes * k
    bms, by = bound(flops, nbytes)
    out["greedy_loop_resident"] = {
        "shape": [nodes, bk, bk, d, k],
        "ms": cuda_ms(torch, lambda: L.greedy_loop_resident(
            cd, cd, row, mask, ctl, k, rule), reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_resident_plain(
            cd, cd, row, mask, ctl, k, rule), reps),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        **_resident_levels(torch, x, cfg, "float32", reps, seed + 1)}
    emit({"phase": "timing", "peaks": {"fp32_flops": PEAK_FP32_FLOPS,
                                       "hbm_bytes": PEAK_HBM_BYTES},
          **out})
    return out


def _vs_global(torch, step, reps) -> dict:
    """fused_step at one shape beside the earlier design (reference=True,
    row blocks summed by one last block; the global tier's kernel before
    its redesign): that design's CUDA-event ms a call (`global_ms`), and
    each design's device ms a launch by torch.profiler (at the node
    shapes the host sets the event time, so only device time compares
    the kernels)."""
    def device_ms(fn):
        split = _kernel_split(torch, fn, 20)["kernel_split"]
        if not isinstance(split, dict):
            return split
        return {k: v["ms_per_launch"] for k, v in split.items()
                if "fused_step" in k}
    return {"global_ms": cuda_ms(torch, lambda: step(reference=True),
                                 20 * reps),
            "device_ms": device_ms(step),
            "global_device_ms": device_ms(lambda: step(reference=True))}


def _loop_vs_fused_steps(torch, mat, row, mask, k, rule, scale, reps):
    """The streaming loop's yardstick: k fused_step launches over the
    same cache, each step's winner passed on as the next one's prev (the
    mask fixed), CUDA-event ms for all k together."""
    from repro_torch.kernels import fused_step as F
    prev0 = torch.full((mat.shape[0],), -1, dtype=torch.int64,
                       device=mat.device)

    def steps():
        r, pv = row, prev0
        for _ in range(k):
            r, pv, _ = F.fused_step(mat, r, mask, pv, rule, scale=scale)
    return cuda_ms(torch, steps, reps)


def _resident_levels(torch, x, cfg, dt, reps, seed):
    """The resident loop at every level's node count of the run's tree
    (16, 8, 4, 2, 1 nodes × b·k² × D, k steps; ground = candidates, as a
    node of run_tree_dense): each level's ms, the same call at k = 0 (the
    build and rounding alone: `build_ms`) and their difference
    (`steps_ms`), CUDA events; each CUDA kernel's device ms a call
    (`kernel_split`, torch.profiler: the build and the steps are two
    launches); the bound of each level's build and steps."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    k = cfg.k
    bk = cfg.branching * k
    d = x.shape[1]
    rnd = {"float32": 0.0, "bfloat16": 1.0, "int8": 4.0}[dt]
    levels = []
    for nodes in _level_nodes(cfg):
        cd = node_pools(torch, x, nodes, bk, seed + nodes)
        vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
        row = R.empty_row(cd, vv, rule).contiguous()
        mask = vv.float().contiguous()

        def ctl(kq):
            return torch.tensor([[kq, bk, bk]] * nodes, dtype=torch.int32,
                                device=x.device)
        full, zero = ctl(k), ctl(0)
        ms = cuda_ms(torch, lambda: L.greedy_loop_resident(
            cd, cd, row, mask, full, k, rule, cache_dtype=dt), reps)
        build_ms = cuda_ms(torch, lambda: L.greedy_loop_resident(
            cd, cd, row, mask, zero, 0, rule, cache_dtype=dt), reps)
        flops = (2.0 * nodes * bk * bk * d + 4.0 * nodes * bk * d
                 + rnd * nodes * bk * bk + 3.0 * k * nodes * bk * bk)
        nbytes = 4.0 * nodes * (2 * bk * d + 3 * bk) + 12.0 * nodes * k
        split = _kernel_split(torch, lambda: L.greedy_loop_resident(
            cd, cd, row, mask, full, k, rule, cache_dtype=dt), 3)
        levels.append({"nodes": nodes, "ms": ms, "build_ms": build_ms,
                       "steps_ms": ms - build_ms,
                       "kernel_split": split["kernel_split"],
                       "bound_ms": bound(flops, nbytes)[0]})
        del cd, row, mask
    return {"levels": levels, "levels_ms": sum(v["ms"] for v in levels),
            "levels_build_ms": sum(v["build_ms"] for v in levels)}


def phase_timing_steps(torch, x, cfg, pools, reps):
    """The per-step kernels at their paths' shapes: fused_step over the
    knapsack leaves' caches (32 × 3,125²), gains over the stochastic
    leaves (32 × 3,125 ground rows × 72 candidates × 12,288), each beside
    its bound, its plain version and — for gains — torch.cdist over the
    same pairs. No single PyTorch call folds a column, sums masked gain
    parts and takes an argmax, so fused_step has no library time."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    _, pay, valid = pools
    b, n, d = pay.shape
    out = {}
    mat = P.pairwise(pay, pay, rule.pairwise)
    row = R.empty_row(pay, valid, rule).contiguous()
    mask = valid.float().contiguous()
    prev = torch.zeros(b, dtype=torch.int64, device=x.device)
    flops = 3.0 * b * n * n
    nbytes = 4.0 * b * n * n + 4.0 * 2 * b * n + 4.0 * b * n + 16.0 * b
    bms, by = bound(flops, nbytes)
    out["fused_step"] = {
        "shape": [b, n, n],
        "ms": cuda_ms(torch, lambda: F.fused_step(mat, row, mask, prev, rule),
                      20 * reps),
        **_vs_global(torch, lambda **kw: F.fused_step(
            mat, row, mask, prev, rule, **kw), reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            mat, row, mask, prev, rule), reps),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del mat
    # the knapsack node shape (reported, not in the kernels line): a
    # step's caches sit in L2, so launch and host costs dominate
    bk = cfg.branching * cfg.k
    nodes = node_pools(torch, x, b, bk, cfg.seed + 3)
    nmat = P.pairwise(nodes, nodes, rule.pairwise)
    nrow = R.empty_row(nodes, torch.ones(b, bk, dtype=torch.bool,
                                         device=x.device), rule).contiguous()
    nmask = torch.ones(b, bk, device=x.device)
    out["fused_step_node"] = {
        "shape": [b, bk, bk],
        "ms": cuda_ms(torch, lambda: F.fused_step(nmat, nrow, nmask, prev,
                                                  rule), 20 * reps),
        **_vs_global(torch, lambda **kw: F.fused_step(
            nmat, nrow, nmask, prev, rule, **kw), reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            nmat, nrow, nmask, prev, rule), 20 * reps),
        "bound_ms": bound(3.0 * b * bk * bk,
                          4.0 * b * (bk * bk + 3 * bk) + 16.0 * b)[0]}
    del nodes, nmat
    c = sample_size(n, cfg.k)
    idx = LaneSampler(cfg.seed)(0, b, 1, n, c)[:, 0].to(x.device)
    cands = torch.gather(pay, 1, idx[..., None].expand(b, c, d)).contiguous()
    cv = torch.ones(b, c, dtype=torch.bool, device=x.device)
    # a step's work: the products, the candidates' norms and the gain
    # parts; the ground's norms are the greedy's, taken once (norms_ms)
    gnorm = P.ground_norms(pay)
    flops = 2.0 * b * n * c * d + 2.0 * b * c * d + 4.0 * b * n * c
    nbytes = 4.0 * (b * n * d + b * c * d + 2 * b * n + b * c)
    bms, by = bound(flops, nbytes)
    out["gains"] = {
        "shape": [b, n, c, d],
        "ms": cuda_ms(torch, lambda: P.gains(pay, row, cands, cv, rule,
                                             gnorm=gnorm), reps),
        "norms_ms": cuda_ms(torch, lambda: P.ground_norms(pay), reps),
        "plain_ms": cuda_ms(torch, lambda: P.gains_plain(pay, row, cands, cv,
                                                         rule), reps),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(
            pay, cands, compute_mode="use_mm_for_euclid_dist"), reps),
        "bound_ms": bms, "bound_by": by}
    # the step engine's other per-step cost (reported): the winner's
    # direct-difference column folded into the rows, in plain torch
    out["update_row"] = {
        "shape": [b, n, d],
        "ms": cuda_ms(torch, lambda: R.update_row(pay, row, cands[:, 0],
                                                  rule), reps),
        "bound_ms": bound(3.0 * b * n * d, 4.0 * (b * n * d + 2 * b * n))[0]}
    emit({"phase": "timing_steps", **out})
    return out


# the sequential Greedy's steps replayed on both fused_step designs, and
# the candidates of its parity check against the plain version
SEQ_REPLAY = 8
SLICE20_SECONDS = {}
SEQ_PARITY_C = 2_048


@contextlib.contextmanager
def _device_ms(torch, module, name: str, log: list):
    """Record CUDA events around every call of module.<name> for the
    duration; `log` gets the (start, end) pairs."""
    fn = getattr(module, name)

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*a, **kw)
        ev[1].record()
        log.append(ev)
        return out
    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_sequential_kmedoid(torch, x, cfg, f32_run):
    """The paper's sequential Greedy baseline over all n images on the
    card: simulate.run_greedy_dense('kmedoid', x, k), engine 'auto' — the
    fused engine on fused_step's global tier (the f32 (n, n) cache, 40 GB
    at n = 100,000): 1 pairwise and k fused_step launches. The wall time,
    the steps' and the cache build's device time (CUDA events around each
    dispatch), the Greedy's global value beside phase `run`'s GreedyML
    one and their ratio (the paper's quality comparison). Then the same
    cache once more: its first SEQ_REPLAY steps on the global tier and on
    the earlier design, bit for bit, their winners the Greedy's first
    ids; and the global tier against its plain version
    (parity.compare_steps) over all n ground rows and SEQ_PARITY_C
    candidates, in each storage. Returns (launches, the largest gain
    error against the plain version)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.simulate import run_greedy_dense
    from repro_torch.kernels import counters, ops, parity, plans
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import rules as R
    t_phase = time.perf_counter()
    n, k = x.shape[0], cfg.k
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    steps, builds = [], []
    counters.reset()
    t0 = time.perf_counter()
    with _device_ms(torch, ops, "fused_step", steps), \
            _device_ms(torch, ops, "pairwise_matrix", builds):
        res = run_greedy_dense("kmedoid", x, k, device=x.device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c["launches"] for name, c in counters.snapshot().items()
                if c["launches"]}
    assert launches == {"pairwise": 1, "fused_step": k}, launches
    step_ms = [a.elapsed_time(b) for a, b in steps]
    ids = np.asarray(res.ids)
    assert len(ids) == k and len(set(ids.tolist())) == k
    assert np.isfinite(res.value) and res.value > 0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the replay: the same cache, built as the greedy builds it
    obj = make_objective("kmedoid", device=x.device)
    pay = x[None]
    valid = torch.ones(1, n, dtype=torch.bool, device=x.device)
    state = obj.init_state(pay, valid)
    mat, plan = obj.prepare(state, pay, valid)
    assert plans.fused_tier(plan.dtype, n, plan.block_n) == "global"
    rule = obj.rule
    row, mask = state.row.contiguous(), valid.float()
    prev = torch.full((1,), -1, dtype=torch.int64, device=x.device)
    entries = differing = 0
    replayed = []
    for _ in range(SEQ_REPLAY):
        got = F.fused_step(mat, row, mask, prev, rule, block_n=plan.block_n)
        yard = parity.compare_exact(got, F.fused_step(
            mat, row, mask, prev, rule, block_n=plan.block_n,
            reference=True), "sequential Greedy replay vs the earlier "
            "design")
        entries += yard["entries"]
        differing += yard["differing"]
        row, prev = got[0], got[1]
        replayed.append(int(prev[0]))
        mask[0, prev[0]] = 0.0
    assert replayed == ids[:SEQ_REPLAY].tolist(), (replayed, ids[:8])
    del mat, row, mask, state
    torch.cuda.empty_cache()
    # the global tier against its plain version at all n ground rows
    cands = x[:SEQ_PARITY_C][None]
    grow = R.empty_row(pay, valid, rule).contiguous()
    gen = torch.Generator(device=x.device).manual_seed(cfg.seed)
    gmask = (torch.rand(1, SEQ_PARITY_C, generator=gen, device=x.device)
             > 0.2).float()
    gprev = torch.tensor([7], device=x.device)
    checks = {}
    for dtype in ("float32",) + QUANT:
        built = ops.pairwise_matrix(pay, cands, rule, dtype)
        mat, scale = ((built.q, built.scale) if dtype == "int8"
                      else (built, None))
        got = F.fused_step(mat, grow, gmask, gprev, rule, scale=scale)
        plain = F.fused_step_plain(mat, grow, gmask, gprev, rule,
                                   scale=scale)
        checks[dtype] = parity.compare_steps(
            got, plain, R.logical(mat, scale), gmask, rule,
            what=f"fused_step[{dtype}] global tier at {n} rows")
        parity.compare_exact(got, F.fused_step(
            mat, grow, gmask, gprev, rule, scale=scale, reference=True),
            f"fused_step[{dtype}] global tier vs the earlier design")
        del built, mat, scale
    del cands
    torch.cuda.empty_cache()
    greedyml = f32_run[1]
    seconds = time.perf_counter() - t_phase
    SLICE20_SECONDS["sequential_kmedoid"] = seconds
    emit({"phase": "sequential_kmedoid", "n": n, "d": x.shape[1], "k": k,
          "engine": plan.engine, "dtype": plan.dtype,
          "tier": plans.fused_tier(plan.dtype, n, plan.block_n),
          "launches": launches, "wall_seconds": wall,
          "pairwise_ms": sum(a.elapsed_time(b) for a, b in builds),
          "steps_ms": sum(step_ms), "step_ms_mean": sum(step_ms) / k,
          "step_ms_max": max(step_ms),
          "held_gb_before": held_gb, "peak_gb": peak_gb,
          "greedy_global_value": res.value,
          "greedy_root_value": res.root_value,
          "greedyml_global_value": greedyml,
          "greedyml_over_greedy": greedyml / res.value,
          "ids_sha1": _digest(ids, res.value)["ids_sha1"],
          "replay": {"steps": SEQ_REPLAY, "ids": replayed,
                     "entries": entries, "differing": differing},
          "vs_plain": {dt: {"max_gain_err": v["max_gain_err"],
                            "ties": v["ties"]}
                       for dt, v in checks.items()},
          "seconds": seconds})
    return launches, max(v["max_gain_err"] for v in checks.values())


# (B, N, C) caches where both fused_step tiers run (a cluster's shared
# memory holds a span's partials up to 92,416 f32 rows): the gate's
# comparison, from the knapsack node and leaf to 90,000 rows, each a view
# of the first entries of the 100,000² cache
GATE_SHAPES = ((32, 400, 400), (32, 3_125, 3_125), (8, 12_500, 12_500),
               (1, 25_000, 100_000), (1, 50_000, 100_000),
               (1, 90_000, 100_000))


def _fused_global_storage(torch, parity, step, mat, scale, reps):
    """One storage at the global tier's shape: the global tier beside the
    earlier design (bit for bit, CUDA-event ms each) and the bound of the
    step's bytes (the cache and int8 scales read once, the row read and
    written, the mask read)."""
    b, n, c = mat.shape
    got = step(mat, scale)
    yard = parity.compare_exact(got, step(mat, scale, reference=True),
                                f"fused_step[{mat.dtype}] global tier vs "
                                "the earlier design")
    assert 0 <= int(got[1][0]) < c and bool(torch.isfinite(got[2]).all())
    nbytes = (mat.numel() * mat.element_size()
              + (0 if scale is None else 4.0 * b * n)
              + 4.0 * b * (2 * n + c) + 16.0 * b)
    bms, by = bound(3.0 * b * n * c, nbytes)
    return {"ms": cuda_ms(torch, lambda: step(mat, scale), reps),
            "earlier_ms": cuda_ms(torch, lambda: step(
                mat, scale, reference=True), reps),
            "bound_ms": bms, "bound_by": by,
            "vs_earlier_design": {"entries": yard["entries"],
                                  "differing": yard["differing"]}}


@contextlib.contextmanager
def _fused_tier(tier: str):
    """fused_step's tier forced through the planner's chunk limit in
    plans for the duration: 'global' everywhere, or 'cluster' wherever
    the cluster design fits."""
    from repro_torch.kernels import plans
    old = plans.FUSED_CLUSTER_CHUNKS
    plans.FUSED_CLUSTER_CHUNKS = 0 if tier == "global" else 1 << 30
    try:
        yield
    finally:
        plans.FUSED_CLUSTER_CHUNKS = old


def _gate_table(torch, F, parity, plans, rule, mat, scale, block_n, reps):
    """fused_step's two tiers at GATE_SHAPES, each a view of the first
    entries of `mat` (and of its int8 scales), in its storage: the
    cluster design where it fits (forced where the planner sends the
    shape to the global tier) and the global tier (forced below the
    gate), bit for bit (against the earlier design where no cluster
    fits); CUDA-event ms a call and device ms a launch (torch.profiler:
    at the node shape the host sets the event time); the tier the
    planner picks."""
    dtype = str(mat.dtype).removeprefix("torch.")
    rows = []
    for b, g, c in GATE_SHAPES:
        sub = mat.view(-1)[:b * g * c].view(b, g, c)
        ssub = (None if scale is None
                else scale.view(-1)[:b * g].view(b, 1, g))
        grow = torch.full((b, g), 2.0, device=mat.device)
        gmask = torch.ones(b, c, device=mat.device)
        gprev = torch.zeros(b, dtype=torch.int64, device=mat.device)

        def gstep():
            return F.fused_step(sub, grow, gmask, gprev, rule,
                                block_n=block_n, scale=ssub)

        def device_ms():
            split = _kernel_split(torch, gstep, 10)["kernel_split"]
            if not isinstance(split, dict):
                return split
            return sum(v["ms_per_launch"] for k, v in split.items()
                       if "fused_step" in k)
        row_ = {"shape": [b, g, c],
                "planner": plans.fused_tier(dtype, g, block_n)}
        if plans.fused_cluster_fits(dtype, g, block_n):
            with _fused_tier("cluster"):
                assert plans.fused_tier(dtype, g, block_n) == "cluster"
                want, what = gstep(), "cluster design"
                row_["cluster_ms"] = cuda_ms(torch, gstep, 5 * reps)
                row_["cluster_device_ms"] = device_ms()
        else:   # int8 past 77,056 rows: the earlier design is the yardstick
            row_["cluster_ms"] = "fits no cluster"
            want = F.fused_step(sub, grow, gmask, gprev, rule,
                                block_n=block_n, scale=ssub, reference=True)
            what = "the earlier design"
        with _fused_tier("global"):
            assert plans.fused_tier(dtype, g, block_n) == "global"
            yard = parity.compare_exact(gstep(), want,
                                        f"fused_step[{dtype}] global tier "
                                        f"vs {what}")
            row_["global_ms"] = cuda_ms(torch, gstep, 5 * reps)
            row_["global_device_ms"] = device_ms()
        nbytes = (b * g * c * mat.element_size()
                  + (0 if scale is None else 4.0 * b * g)
                  + 4.0 * b * (2 * g + c) + 16.0 * b)
        row_["bound_ms"] = bound(3.0 * b * g * c, nbytes)[0]
        row_["vs_yardstick"] = {"entries": yard["entries"],
                                "differing": yard["differing"]}
        rows.append(row_)
        del sub, ssub, want
    return rows


def phase_timing_fused_global(torch, cfg, reps):
    """fused_step's global tier where the planner sends a step to it: the
    sequential Greedy over all n images (simulate.run_greedy_dense), one
    greedy whose f32 (n, n) cache (40,000 MB at n = 100,000) fits the
    budget but whose span partials fit no cluster's shared memory. Each
    storage (f32, bf16, int8) at 1 × n² on the global tier and on the
    earlier design, bit for bit, beside its bound; the earlier design's
    two phases on the card's clock (`earlier_split`: its row blocks, then
    its last block's sum); the plain version over four column slices
    (whole, it would hold two (n, n) f32 temporaries); both tiers at
    GATE_SHAPES (`gate`, views of the same cache). The caches are random
    (the time does not depend on their values). Reported, not in the
    kernels line."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import parity, plans
    from repro_torch.kernels import rules as R
    t_phase = time.perf_counter()
    n = cfg.n
    plan = plans.select_engine(R.DIST_MIN, n, n, cfg.feature_dim)
    assert plan.engine == "fused", plan
    assert plans.fused_tier(plan.dtype, n, plan.block_n) == "global"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    row = torch.full((1, n), 2.0, device=dev)
    mask = torch.ones(1, n, device=dev)
    prev = torch.zeros(1, dtype=torch.int64, device=dev)
    rule = R.DIST_MIN

    def step(mat, scale=None, **kw):
        return F.fused_step(mat, row, mask, prev, rule, block_n=plan.block_n,
                            scale=scale, **kw)

    def gate(mat, scale=None):
        return _gate_table(torch, F, parity, plans, rule, mat, scale,
                           plan.block_n, reps)
    mat = torch.rand((1, n, n), generator=gen, device=dev)
    out = {"float32": _fused_global_storage(torch, parity, step, mat,
                                            None, reps)}
    out["float32"]["earlier_split"] = F.earlier_design_split(
        mat, row, mask, prev, rule, plan.block_n)
    quarter = -(-n // 4)
    out["float32"]["plain_ms"] = sum(
        cuda_ms(torch, lambda c0=c0: F.fused_step_plain(
            mat[..., c0:c0 + quarter], row, mask[:, c0:c0 + quarter], prev,
            rule), reps) for c0 in range(0, n, quarter))
    out["float32"]["gate"] = gate(mat)
    del mat
    torch.cuda.empty_cache()
    mat = torch.rand((1, n, n), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    out["bfloat16"] = _fused_global_storage(torch, parity, step, mat,
                                            None, reps)
    out["bfloat16"]["gate"] = gate(mat)
    del mat
    torch.cuda.empty_cache()
    mat = torch.randint(-127, 127, (1, n, n), generator=gen, device=dev,
                        dtype=torch.int8)
    scale = torch.rand((1, 1, n), generator=gen, device=dev) / 127
    out["int8"] = _fused_global_storage(torch, parity, step, mat, scale,
                                        reps)
    out["int8"]["gate"] = gate(mat, scale)
    del mat, scale
    torch.cuda.empty_cache()
    # the step engine's work a step at the same size: the products alone
    step_bms = bound(2.0 * n * n * cfg.feature_dim, 4.0 * n * cfg.feature_dim)
    SLICE20_SECONDS["timing_fused_global"] = time.perf_counter() - t_phase
    emit({"phase": "timing_fused_global", "shape": [1, n, n],
          "block_n": plan.block_n,
          "chunks_a_block": {dt: plans.fused_global_chunks(dt, plan.block_n)
                             for dt in ("float32", "bfloat16", "int8")},
          **out, "step_engine_bound_ms": step_bms[0],
          "seconds": SLICE20_SECONDS["timing_fused_global"]})
    return out


# ---------------------------------------------------------------------------
# the memory-capped cache tiers: bf16 and int8 cached matrices
# ---------------------------------------------------------------------------

QUANT = ("bfloat16", "int8")
TAG = {"float32": "", "bfloat16": "[bf16]", "int8": "[int8]"}
RUNG = {"bfloat16": "bf16", "int8": "int8"}
# REPRO_TORCH_FUSED_CACHE_MB under which the planner takes each rung for
# the Tiny-ImageNet leaves (32 × 3,284²: f32 1.38 GB, bf16 0.69 GB,
# int8 0.345 GB)
BUDGET_MB = {"bfloat16": 1024, "int8": 512}


@contextlib.contextmanager
def _env(**kv):
    """The environment variables `kv` set for the duration."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rung_env(dtype: str) -> dict:
    return {"REPRO_TORCH_FUSED_CACHE_DTYPE": RUNG[dtype]}


def _quant_caches(torch, pay, rule):
    """The f32 kernel's (B, N, N) cache of `pay` and the bf16 and int8
    caches ops.pairwise_matrix builds on the card, each held bit for bit
    (kernels/parity.py): pairwise[bf16] against the f32 output rounded to
    bf16, the chunked int8 cache against quantize_rows of the whole f32
    output on the CPU. Returns (f32, {dtype: (matrix, scale)}, checks)."""
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    m32 = P.pairwise(pay, pay, rule.pairwise)
    bf = ops.pairwise_matrix(pay, pay, rule, "bfloat16")
    checks = {"pairwise[bf16]_vs_f32_rounded": parity.compare_exact(
        bf, m32.to(torch.bfloat16), "pairwise[bf16] vs the f32 kernel")}
    q = ops.pairwise_matrix(pay, pay, rule, "int8")
    checks["int8_cache_vs_cpu_quantize_rows"] = parity.compare_exact(
        (q.q.cpu(), q.scale.cpu()), R.quantize_rows(m32.cpu()),
        "the chunked int8 cache vs quantize_rows on the CPU")
    return m32, {"bfloat16": (bf, None), "int8": (q.q, q.scale)}, checks


def _bf16_pairwise_rule(torch, g, mode):
    """pairwise[bf16] against its plain version (the plain f32 build
    rounded to bf16) under the float64 ratio rule; returns the stats and
    the largest |kernel − plain|."""
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    got = P.pairwise(g, g, mode, out_dtype=torch.bfloat16).float()
    plain = P.pairwise_plain(g, g, mode).to(torch.bfloat16).float()
    stats = parity.pairwise_stats(got, plain,
                                  parity.exact_matrix(g, g, mode), mode)
    assert parity.pairwise_holds(stats), f"pairwise[bf16] {mode}: {stats}"
    stats["max_abs_diff"] = float((got - plain).abs().max())
    return stats


def phase_parity_quant(torch, x, cfg, pools):
    """The bf16/int8 variants on the card at the runs' own shapes, for
    kmedoid ('dist') and facility ('dot'), held bit for bit to what runs
    the same arithmetic and to their plain versions by the rules of
    kernels/parity.py:
      leaf level      (32 × 3,284², run_tree_dense's first level)
                      pairwise[bf16] == the f32 kernel rounded; the
                      chunked int8 cache == quantize_rows on the CPU;
                      greedy_loop[bf16|int8] == the f32 kernel over the
                      dequantized cache; vs plain: pairwise[bf16] by the
                      float64 rule (first leaf), loops by compare_loops
      node level      (16 × 400²) the resident loop under each rung: its
                      scratch == round_resident of the pairwise kernel's
                      f32 build; vs plain: compare_loops with the
                      measured entry differences
      knapsack leaf   (32 × 3,125²) and node (32 × 400²): the caches as
                      above, fused_step[bf16|int8] == the f32 kernel over
                      the dequantized cache, two steps; vs plain:
                      compare_steps
    Returns each variant's largest measured |kernel − plain|."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rules = {"kmedoid": R.DIST_MIN, "facility": R.DOT_MAX}
    errs = {}

    def err(name, value):
        errs[name] = max(errs.get(name, 0.0), float(value))

    out = {"leaf": {}, "node": {}, "knapsack_leaf": {}, "knapsack_node": {}}
    _, lpay, lvalid = leaf_pools(torch, x, cfg.num_machines, cfg.seed)
    b, n, _ = lpay.shape
    for name, rule in rules.items():
        res = {"pairwise[bf16]_plain": _bf16_pairwise_rule(
            torch, lpay[:1].contiguous(), rule.pairwise)}
        err("pairwise[bf16]", res["pairwise[bf16]_plain"]["max_abs_diff"])
        m32, caches, checks = _quant_caches(torch, lpay, rule)
        del m32
        res.update(checks)
        row = R.empty_row(lpay, lvalid, rule).contiguous()
        mask = lvalid.float().contiguous()
        for dt, (mat, scale) in caches.items():
            what = f"greedy_loop{TAG[dt]} {name}"
            res[f"greedy_loop{TAG[dt]}_loop_vs_fused_step"] = \
                _loop_vs_fused_step(L, parity, mat, row, mask, cfg.k, rule,
                                    scale, what)
            got = L.greedy_loop(mat, row, mask, cfg.k, rule, scale=scale)
            f32 = L.greedy_loop(R.logical(mat, scale).contiguous(), row, mask,
                                cfg.k, rule)
            res[f"greedy_loop{TAG[dt]}_vs_f32_kernel"] = parity.compare_exact(
                got, f32, what + " vs the f32 kernel")
            del f32
            cmp = parity.compare_loops(got, L.greedy_loop_plain(
                mat, row, mask, cfg.k, rule, scale=scale), rule, what=what)
            cmp["accepted"] = int((got[1] >= 0).sum())
            res[f"greedy_loop{TAG[dt]}_plain"] = cmp
            err(f"greedy_loop{TAG[dt]}", cmp["max_gain_err"])
        out["leaf"][name] = res
        del caches
    del lpay, lvalid
    nodes = cfg.num_machines // cfg.branching
    bk = cfg.branching * cfg.k
    cd = node_pools(torch, x, nodes, bk, cfg.seed + 4)
    vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
    ctl = torch.tensor([[cfg.k, bk, bk]] * nodes, dtype=torch.int32,
                       device=x.device)
    for name, rule in rules.items():
        row = R.empty_row(cd, vv, rule).contiguous()
        mask = vv.float().contiguous()
        built32 = P.pairwise(cd, cd, rule.pairwise)
        res = {}
        for dt in QUANT:
            what = f"greedy_loop_resident{TAG[dt]} {name}"
            built = torch.empty(nodes, bk, bk, device=x.device)
            got, res[f"resident{TAG[dt]}_resident_vs_loop"] = \
                _resident_vs_loop(torch, L, parity, cd, row, mask, ctl,
                                  cfg.k, rule, dt, built, what)
            res[f"resident{TAG[dt]}_scratch_vs_rounding"] = \
                parity.compare_exact(built, L.round_resident(built32, dt, ctl),
                                     what + ": scratch vs round_resident")
            diff = (built - L.resident_matrix(cd, cd, rule, ctl, dt)).abs()
            cmp = parity.compare_loops(got, L.greedy_loop_resident_plain(
                cd, cd, row, mask, ctl, cfg.k, rule, cache_dtype=dt), rule,
                entry_diff=diff, what=what)
            cmp["max_entry_diff"] = float(diff.max())
            res[f"resident{TAG[dt]}_plain"] = cmp
            err(f"greedy_loop_resident{TAG[dt]}", cmp["max_gain_err"])
            del built, diff
        out["node"][name] = res
    del cd
    _, kpay, kvalid = pools
    kn = node_pools(torch, x, kpay.shape[0], bk, cfg.seed + 5)
    for where, pay, valid in (
            ("knapsack_leaf", kpay, kvalid),
            ("knapsack_node", kn, torch.ones(kn.shape[:2], dtype=torch.bool,
                                             device=x.device))):
        bb, nn = pay.shape[:2]
        for name, rule in rules.items():
            m32, caches, res = _quant_caches(torch, pay, rule)
            del m32
            row = R.empty_row(pay, valid, rule).contiguous()
            gen = torch.Generator(device=x.device).manual_seed(cfg.seed)
            mask = (torch.rand(bb, nn, generator=gen, device=x.device)
                    > 0.2).float()
            prev = torch.randint(0, nn, (bb,), generator=gen,
                                 device=x.device)
            for dt, (mat, scale) in caches.items():
                what = f"fused_step{TAG[dt]} {name} {where}"
                logical = R.logical(mat, scale).contiguous()
                r, mk, pv, cmps, sames, yards = row, mask, prev, [], [], []
                for _ in range(2):
                    got = F.fused_step(mat, r, mk, pv, rule, scale=scale)
                    sames.append(parity.compare_exact(
                        got, F.fused_step(logical, r, mk, pv, rule),
                        what + " vs the f32 kernel"))
                    yards.append(parity.compare_exact(
                        got, F.fused_step(mat, r, mk, pv, rule, scale=scale,
                                          reference=True),
                        what + " vs the earlier design"))
                    plain = F.fused_step_plain(mat, r, mk, pv, rule,
                                               scale=scale)
                    cmps.append(parity.compare_steps(got, plain, logical, mk,
                                                     rule, what=what))
                    r, pv = plain[0], plain[1]
                    mk = mk.scatter(1, pv[:, None], 0.0)
                res[f"fused_step{TAG[dt]}_vs_f32_kernel"] = {
                    "entries": sum(s["entries"] for s in sames),
                    "differing": sum(s["differing"] for s in sames)}
                res[f"fused_step{TAG[dt]}_vs_earlier_design"] = {
                    "entries": sum(s["entries"] for s in yards),
                    "differing": sum(s["differing"] for s in yards)}
                res[f"fused_step{TAG[dt]}_plain"] = {
                    "max_gain_err": max(c["max_gain_err"] for c in cmps),
                    "ties": sum(c["ties"] for c in cmps)}
                err(f"fused_step{TAG[dt]}",
                    res[f"fused_step{TAG[dt]}_plain"]["max_gain_err"])
                del logical
            out[where][name] = res
            del caches
    del kn
    emit({"phase": "parity_quant", "leaf_shape": [b, n, n],
          "node_shape": [nodes, bk, bk],
          "knapsack_leaf_shape": list(kpay.shape[:2]) + [kpay.shape[1]],
          "knapsack_node_shape": [kpay.shape[0], bk, bk], **out})
    return errs


def _variant_launches(totals) -> dict:
    """The launches of the bf16/int8 variants among a run's totals."""
    return {k: v for k, v in totals.items() if "[bf16]" in k or "[int8]" in k}


def _add(into: dict, more: dict) -> None:
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


def _quant_tree(torch, x, cfg, env: dict, f32_run):
    """run_tree_dense('kmedoid', …) under `env` (a forced rung or a
    cache budget): per level the engine and storage the planner picks
    there, the launches each variant's counter shows (asserted), the wall
    time; the leaf stage's device allocation beyond the pools held to
    the planned bytes, the cache and the streaming loop's chunk partials
    (≤ 1.05× plus one int8 chunk's f32: no f32 copy of a cache
    anywhere); the root beside the f32 run's."""
    from repro_torch.core.simulate import partition, run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import (cache_bytes, loop_scratch_bytes,
                                           quant_chunk, select_engine)
    from repro_torch.kernels.rules import DIST_MIN
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    m, d = cfg.num_machines, x.shape[1]
    n_leaf = int(np.bincount(partition(x.shape[0], m, cfg.seed)).max())
    levels = []
    with _env(**env):
        plans = []
        for lvl in range(tree.num_levels + 1):
            n = n_leaf if lvl == 0 else cfg.branching * cfg.k
            reps = m if lvl == 0 else len(tree.nodes_at_level(lvl))
            plans.append((n, reps, select_engine(DIST_MIN, n, n, d,
                                                 replicas=reps)))
        leaf = plans[0][2]
        # the cache and, beside it while the loop runs, its chunk partials
        planned = (cache_bytes(n_leaf, n_leaf, leaf.dtype, m)
                   + loop_scratch_bytes(n_leaf, n_leaf, leaf.dtype, m,
                                        leaf.block_n))
        chunk = (quant_chunk(n_leaf, n_leaf) * n_leaf * n_leaf * 4
                 if leaf.dtype == "int8" else 0)
        pool_bytes = m * n_leaf * d * 4
        counters.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hook = _level_hook(torch, levels)
        peak = []

        def on_level(lvl):
            hook(lvl)
            if lvl == 0:
                peak.append(torch.cuda.max_memory_allocated() - base)

        t0 = time.perf_counter()
        res = run_tree_dense("kmedoid", x, cfg.k, tree, seed=cfg.seed,
                             device=x.device, on_level=on_level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    totals = {}
    for lv, (n, reps, plan) in zip(levels, plans):
        tag = TAG[plan.dtype]
        want = {"pairwise": 1} if lv["level"] > 0 else {}
        if plan.engine == "mega_stream":
            build = ("pairwise" if plan.dtype == "int8"
                     else "pairwise" + tag)
            want[build] = want.get(build, 0) + (
                -(-reps // quant_chunk(n, n)) if plan.dtype == "int8" else 1)
            want["greedy_loop" + tag] = 1
        else:
            assert plan.engine == "mega_resident", plan.engine
            want["greedy_loop_resident" + tag] = 1
        assert lv["launches"] == want, (lv["level"], lv["launches"], want)
        lv["engine"], lv["dtype"] = plan.engine, plan.dtype
        _add(totals, lv["launches"])
    extra = peak[0] - pool_bytes
    assert planned <= extra <= 1.05 * planned + chunk, (
        extra, planned, chunk)
    ids = np.asarray(res.ids)
    assert 0 < len(ids) <= cfg.k and len(set(ids.tolist())) == len(ids)
    assert np.isfinite(res.value) and np.isfinite(res.root_value)
    f32_ids, f32_value, f32_root = f32_run
    return {"env": env, "levels": levels, "wall_seconds": wall,
            "leaf_cache_bytes_planned": planned,
            "leaf_chunk_f32_bytes": chunk,
            "leaf_stage_bytes_beyond_pools": int(extra),
            "root_value": res.root_value, "global_value": res.value,
            "f32_root_value": f32_root, "f32_global_value": f32_value,
            "global_value_rel_diff": abs(res.value - f32_value)
            / abs(f32_value),
            "root_ids": len(ids),
            "root_ids_shared_with_f32": len(set(ids.tolist())
                                            & set(f32_ids.tolist()))}, totals


def phase_run_quant(torch, x, cfg, dtype: str, f32_run):
    """run_tree_dense('kmedoid', …) at the full configuration with the
    caches stored as `dtype`, the two ways a user reaches that rung: the
    rung forced (REPRO_TORCH_FUSED_CACHE_DTYPE: leaves streaming and
    nodes resident, all in `dtype`), and the memory a job has
    (REPRO_TORCH_FUSED_CACHE_MB = BUDGET_MB[dtype]: the planner picks
    `dtype` for the leaves and keeps the nodes f32). Returns the
    variants' launches."""
    from repro_torch.kernels.plans import select_engine
    from repro_torch.kernels.rules import DIST_MIN
    from repro_torch.core.simulate import partition
    n_leaf = int(np.bincount(partition(x.shape[0], cfg.num_machines,
                                       cfg.seed)).max())
    budget = {"REPRO_TORCH_FUSED_CACHE_MB": BUDGET_MB[dtype]}
    with _env(**budget):
        leaf = select_engine(DIST_MIN, n_leaf, n_leaf, x.shape[1],
                             replicas=cfg.num_machines)
    assert (leaf.engine, leaf.dtype) == ("mega_stream", dtype), leaf
    forced, totals = _quant_tree(torch, x, cfg, _rung_env(dtype), f32_run)
    assert all(v["dtype"] == dtype for v in forced["levels"])
    by_budget, more = _quant_tree(torch, x, cfg, budget, f32_run)
    assert [v["dtype"] for v in by_budget["levels"]] == (
        [dtype] + ["float32"] * (len(by_budget["levels"]) - 1))
    _add(totals, more)
    emit({"phase": f"run_{RUNG[dtype]}", "n": x.shape[0], "d": x.shape[1],
          "k": cfg.k, "m": cfg.num_machines, "b": cfg.branching,
          "forced": forced, "budget": by_budget})
    return _variant_launches(totals)


def phase_knapsack_quant(torch, x, cfg, pools, dtype: str):
    """The knapsack lanes (budget 100) with the rung forced: every stage
    fused over a `dtype` cache — its build (one pairwise[bf16] launch, or
    the int8 chunks' f32 pairwise launches) + k fused_step[`dtype`]
    launches, plus the replay pairwise at each level — spent ≤ budget at
    the root and every lane, the constraint binding."""
    from repro_torch.core.constraints import KnapsackSpec
    from repro_torch.kernels.plans import quant_chunk
    spec = KnapsackSpec(torch.as_tensor(knapsack_costs(x.shape[0], cfg.seed),
                                        device=x.device), BUDGET)
    tag = TAG[dtype]
    lanes, n_leaf = pools[1].shape[:2]

    def expect(stage, engine):
        assert engine == "fused", (stage, engine)
        n = n_leaf if stage == 0 else cfg.branching * cfg.k
        want = {"fused_step" + tag: cfg.k}
        if dtype == "int8":
            want["pairwise"] = -(-lanes // quant_chunk(n, n)) + (stage > 0)
        else:
            want["pairwise" + tag] = 1
            if stage > 0:
                want["pairwise"] = 1
        return want

    t0 = time.perf_counter()
    with _env(**_rung_env(dtype)):
        stages, totals, sols = _run_dispatcher(torch, x, cfg, pools, expect,
                                               constraint=spec)
    wall = time.perf_counter() - t0
    spent = spec.spent(sols.ids, sols.valid).cpu().numpy()
    assert (spent <= BUDGET).all(), spent
    ids, root = _report_root(torch, x, sols, cfg.k)
    assert len(ids) < cfg.k, "the budget did not bind"
    assert totals["fused_step" + tag] == len(stages) * cfg.k
    emit({"phase": f"knapsack_{RUNG[dtype]}", "lanes": int(lanes),
          "pool": int(n_leaf), "k": cfg.k, "budget": BUDGET,
          "stages": stages, "wall_seconds": wall, **root,
          "spent_root": float(spent[0]), "spent_lanes": spent.tolist()})
    return _variant_launches(totals)


def phase_timing_quant(torch, x, cfg, pools, reps):
    """Each bf16/int8 variant at its path's shape beside its plain
    version and its bound, the storage's own bytes: pairwise[bf16] and
    the streaming loops at the leaf level (32 × 3,284²; the loop re-reads
    its caches every step less what L2 and shared memory hold),
    fused_step at the knapsack leaf (32 × 3,125²) and node (32 × 400²),
    the resident loops at a level-1 node batch (16 × 400²).
    pairwise[bf16] beside
    torch.cdist(…).to(torch.bfloat16); no single PyTorch call computes
    the others."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    k = cfg.k
    out = {}
    _, pay, valid = leaf_pools(torch, x, cfg.num_machines, cfg.seed)
    b, n, d = pay.shape
    bf16 = torch.bfloat16
    bms, by = bound(2.0 * b * n * n * d + 4.0 * b * n * d + 4.0 * b * n * n,
                    4.0 * b * 2 * n * d + 2.0 * b * n * n)
    out["pairwise[bf16]"] = {
        "shape": [b, n, n, d],
        "ms": cuda_ms(torch, lambda: P.pairwise(pay, pay, "dist",
                                                out_dtype=bf16), reps),
        "plain_ms": cuda_ms(torch, lambda: P.pairwise_plain(
            pay, pay, "dist").to(bf16), reps),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(
            pay, pay, compute_mode="use_mm_for_euclid_dist").to(bf16), reps),
        "bound_ms": bms, "bound_by": by}
    row = R.empty_row(pay, valid, rule).contiguous()
    mask = valid.float().contiguous()
    for dt in QUANT:
        mat = ops.pairwise_matrix(pay, pay, rule, dt)
        mat, scale = (mat.q, mat.scale) if dt == "int8" else (mat, None)
        # an int8 entry costs one more operation: its rescale
        ops_entry = 4.0 if dt == "int8" else 3.0
        cache = (mat.element_size() * b * n * n
                 + (4.0 * b * n if dt == "int8" else 0.0))
        nbytes = (k * cache - (k - 1) * min(cache, on_chip_bytes(torch))
                  + 4.0 * 3 * b * n + 8.0 * b * k)
        bms, by = bound(ops_entry * k * b * n * n, nbytes)
        out[f"greedy_loop{TAG[dt]}"] = {
            "shape": [b, n, n, k], "cache_bytes": cache,
            "ms": cuda_ms(torch, lambda: L.greedy_loop(
                mat, row, mask, k, rule, scale=scale), reps),
            "fused_step_x_k_ms": _loop_vs_fused_steps(
                torch, mat, row, mask, k, rule, scale, reps),
            "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_plain(
                mat, row, mask, k, rule, scale=scale), 1, warmup=0),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
        del mat, scale
    del pay, valid, row, mask
    _, kpay, kvalid = pools
    b, n, _ = kpay.shape
    row = R.empty_row(kpay, kvalid, rule).contiguous()
    mask = kvalid.float().contiguous()
    prev = torch.zeros(b, dtype=torch.int64, device=x.device)
    for dt in QUANT:
        mat = ops.pairwise_matrix(kpay, kpay, rule, dt)
        mat, scale = (mat.q, mat.scale) if dt == "int8" else (mat, None)
        ops_entry = 4.0 if dt == "int8" else 3.0
        nbytes = (mat.element_size() * b * n * n
                  + (4.0 * b * n if dt == "int8" else 0.0)
                  + 4.0 * 2 * b * n + 4.0 * b * n + 16.0 * b)
        bms, by = bound(ops_entry * b * n * n, nbytes)
        out[f"fused_step{TAG[dt]}"] = {
            "shape": [b, n, n],
            "ms": cuda_ms(torch, lambda: F.fused_step(
                mat, row, mask, prev, rule, scale=scale), 20 * reps),
            **_vs_global(torch, lambda **kw: F.fused_step(
                mat, row, mask, prev, rule, scale=scale, **kw), reps),
            "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
                mat, row, mask, prev, rule, scale=scale), reps),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
        del mat, scale
    # the knapsack node shape (timing_steps' nodes): caches in L2
    bk = cfg.branching * k
    kn = node_pools(torch, x, b, bk, cfg.seed + 3)
    nrow = R.empty_row(kn, torch.ones(b, bk, dtype=torch.bool,
                                      device=x.device), rule).contiguous()
    nmask = torch.ones(b, bk, device=x.device)
    for dt in QUANT:
        mat = ops.pairwise_matrix(kn, kn, rule, dt)
        mat, scale = (mat.q, mat.scale) if dt == "int8" else (mat, None)
        ops_entry = 4.0 if dt == "int8" else 3.0
        nbytes = (mat.element_size() * b * bk * bk
                  + (4.0 * b * bk if dt == "int8" else 0.0)
                  + 4.0 * 3 * b * bk + 16.0 * b)
        out[f"fused_step{TAG[dt]}_node"] = {
            "shape": [b, bk, bk],
            "ms": cuda_ms(torch, lambda: F.fused_step(
                mat, nrow, nmask, prev, rule, scale=scale), 20 * reps),
            **_vs_global(torch, lambda **kw: F.fused_step(
                mat, nrow, nmask, prev, rule, scale=scale, **kw), reps),
            "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
                mat, nrow, nmask, prev, rule, scale=scale), 20 * reps),
            "bound_ms": bound(ops_entry * b * bk * bk, nbytes)[0]}
        del mat, scale
    del kn
    nodes = cfg.num_machines // cfg.branching
    d = x.shape[1]
    cd = node_pools(torch, x, nodes, bk, cfg.seed + 1)
    vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
    nrow = R.empty_row(cd, vv, rule).contiguous()
    nmask = vv.float().contiguous()
    ctl = torch.tensor([[k, bk, bk]] * nodes, dtype=torch.int32,
                       device=x.device)
    nbytes = 4.0 * nodes * (2 * bk * d + 3 * bk) + 12.0 * nodes * k
    for dt in QUANT:
        # the rounding: bf16 one operation an entry; int8 the absmax, the
        # division, the rounding and the rescale
        rnd = 1.0 if dt == "bfloat16" else 4.0
        flops = (2.0 * nodes * bk * bk * d + 4.0 * nodes * bk * d
                 + rnd * nodes * bk * bk + 3.0 * k * nodes * bk * bk)
        bms, by = bound(flops, nbytes)
        out[f"greedy_loop_resident{TAG[dt]}"] = {
            "shape": [nodes, bk, bk, d, k],
            "ms": cuda_ms(torch, lambda: L.greedy_loop_resident(
                cd, cd, nrow, nmask, ctl, k, rule, cache_dtype=dt), reps),
            "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_resident_plain(
                cd, cd, nrow, nmask, ctl, k, rule, cache_dtype=dt), reps),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            **_resident_levels(torch, x, cfg, dt, reps, cfg.seed + 1)}
    emit({"phase": "timing_quant", **out})
    return out


# ---------------------------------------------------------------------------
# the coverage problems (the bitmap rule)
# ---------------------------------------------------------------------------


def random_words(torch, shape, seed: int, device):
    """Sparse random 32-bit words (each bit set with probability 1/8),
    every 5th word with bit 31 set, as the port's int32 words."""
    from repro_torch.kernels.rules import to_words
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    for _ in range(2):
        a &= rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    a.reshape(-1)[::5] |= np.uint32(2 ** 31)
    return to_words(a).to(device)


def phase_data_kcover(torch, cfg, avg_size: float, dev):
    """The KOSARAK bitmaps: gen_kcover + pack_bitmaps on the host (the
    reference's recipe, from the seed), then the words placed on the
    card once as int32 (rules.to_words reinterprets, no host copy);
    → (bits, words, the sets' adjacency lists for the lazy engine)."""
    from repro_torch.data.synthetic import gen_kcover, pack_bitmaps
    from repro_torch.kernels.rules import to_words
    t0 = time.perf_counter()
    sets = gen_kcover(cfg.n, cfg.universe, seed=cfg.seed, avg_size=avg_size)
    t_gen = time.perf_counter() - t0
    sizes = np.fromiter((len(x) for x in sets), np.int64, len(sets))
    bits = pack_bitmaps(sets, cfg.universe)
    t_pack = time.perf_counter() - t0 - t_gen
    words = to_words(bits).to(dev)
    torch.cuda.synchronize()
    # the largest item is 41,269: bit 31 of its word holds items ≡ 31 mod 32
    top = int((words < 0).sum())
    emit({"phase": "data_kcover", "n": cfg.n, "universe": cfg.universe,
          "words": int(bits.shape[1]), "avg_size": avg_size,
          "mean_items": float(sizes.mean()), "max_items": int(sizes.max()),
          "gigabytes": bits.nbytes / 1e9, "words_with_bit31": top,
          "gen_seconds": t_gen, "pack_seconds": t_pack,
          "seconds": time.perf_counter() - t0})
    return bits, words, sets


def phase_parity_coverage(torch, words, cfg, pools):
    """The four bitmap kernels against their plain versions on the card,
    at the kcover runs' shapes, by kernels/parity.py's exact rule (rows,
    bests and raw gains equal bit for bit; gains are integers):
      gains        32 lanes × 2,227 sampled candidates × W words, a
                   random live row
      fused_step   the knapsack leaves (32 lanes × 30,938 × W) and a
                   node shape (32 × 128 × W), random rows, 80% masks, a
                   random previous winner, two steps
      greedy_loop  the first leaf level of run_tree_dense (32 padded
                   pools), k steps from a random row
      resident     every level's nodes (16, 8, 4, 2, 1) and the
                   stochastic run's 32 lanes, of b·k sets each
    Random rows and node sets hold words with bit 31 set. Returns each
    kernel's largest measured |kernel − plain| over its checks."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rule = R.BITS_OR
    dev = words.device
    w = words.shape[1]
    k = cfg.k
    out = {}
    _, lpay, lvalid = pools
    b, n, _ = lpay.shape
    sample = sample_size(n, k)
    idx = LaneSampler(cfg.seed)(0, b, 1, n, sample)[:, 0].to(dev)
    cands = torch.gather(lpay, 1, idx[..., None].expand(b, sample, w))
    row = random_words(torch, (b, w), cfg.seed, dev)
    cv = torch.gather(lvalid, 1, idx)
    got = P.gains(None, row, cands, cv, rule)
    out["gains"] = parity.compare_exact(got, P.gains_plain(
        None, row, cands, cv, rule), "gains[coverage]")
    out["gains"]["shape"] = [b, sample, w]
    del cands, got

    def steps(mat, row, what):
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        c = mat.shape[-1]
        mask = (torch.rand(b, c, generator=gen, device=dev) > 0.2).float()
        prev = torch.randint(0, c, (b,), generator=gen, device=dev)
        plain = F.fused_step_plain(mat, row, mask, prev, rule)
        res = parity.compare_exact(F.fused_step_bits(mat, row, mask, prev,
                                                     rule), plain, what)
        mask2 = mask.scatter(1, plain[1][:, None], 0.0)
        plain2 = F.fused_step_plain(mat, plain[0], mask2, plain[1], rule)
        res2 = parity.compare_exact(F.fused_step_bits(
            mat, plain[0], mask2, plain[1], rule), plain2, what + ", step 2")
        return {"entries": res["entries"] + res2["entries"],
                "differing": res["differing"] + res2["differing"],
                "max_abs_err": max(res["max_abs_err"], res2["max_abs_err"]),
                "shape": [b, w, c]}

    out["fused_step"] = {"leaf": steps(lpay.transpose(1, 2), row,
                                       "fused_step[coverage] leaf")}
    bk = cfg.branching * k
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    pick = torch.randint(0, words.shape[0], (b, bk), generator=gen,
                         device=dev)
    nodes = words[pick]
    nodes[:, ::7] |= random_words(torch, (b, (bk + 6) // 7, w), 3, dev)
    out["fused_step"]["node"] = steps(nodes.transpose(1, 2), row,
                                      "fused_step[coverage] node")
    del nodes
    out["greedy_loop"] = _leaf_loop_parity(torch, words, cfg)
    del pick
    # the resident loop over every level's nodes, and the 32 lanes the
    # stochastic run's node stages batch
    out["greedy_loop_resident"] = {
        str(nn): _resident_coverage_parity(torch, words, nn, bk, k,
                                           cfg.seed + 10 + nn)
        for nn in sorted(set(_level_nodes(cfg)) | {b}, reverse=True)}
    emit({"phase": "parity_coverage", "rule": "exact (bit for bit)", **out})
    return _max_errs(out)


def _level_nodes(cfg) -> list:
    """The node count of each level above the leaves of cfg's tree."""
    from repro_torch.core.tree import AccumulationTree
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    return [len(tree.nodes_at_level(lvl))
            for lvl in range(1, tree.num_levels + 1)]


def _max_errs(results) -> dict:
    """{kernel[coverage]: the largest max_abs_err} over nested results
    of parity.compare_exact."""
    def worst(r):
        if "max_abs_err" in r:
            return r["max_abs_err"]
        return max(worst(v) for v in r.values() if isinstance(v, dict))
    return {f"{name}[coverage]": worst(r) for name, r in results.items()}


def _leaf_loop_parity(torch, words, cfg):
    """The bitmap streaming loop against its plain version over the first
    leaf level of run_tree_dense (its padded pools, read in place), k
    steps from a random row with bit-31 words."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    ids, pay, valid = leaf_pools(torch, words, cfg.num_machines, cfg.seed)
    b, n, w = pay.shape
    mat = pay.transpose(1, 2)
    row = random_words(torch, (b, w), cfg.seed + 2, words.device)
    mask = valid.float()
    res = parity.compare_exact(
        L.greedy_loop_bits(mat, row, mask, cfg.k, R.BITS_OR),
        L.greedy_loop_plain(mat, row, mask, cfg.k, R.BITS_OR),
        "greedy_loop[coverage]")
    res["shape"] = [b, w, n, cfg.k]
    return res


def _bits_nodes(torch, words, nodes: int, bk: int, seed: int):
    """`nodes` nodes of bk sets drawn from the data, every 7th OR'ed with
    random words holding bit 31: (nodes, bk, W) words."""
    dev = words.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cd = words[torch.randint(0, words.shape[0], (nodes, bk), generator=gen,
                             device=dev)]
    cd[:, ::7] |= random_words(torch, (nodes, (bk + 6) // 7, words.shape[1]),
                               seed, dev)
    return cd


def _resident_coverage_parity(torch, words, nodes: int, bk: int, k: int,
                              seed: int):
    """The bitmap resident loop against its plain version over `nodes`
    nodes of `_bits_nodes`, k steps from an empty row; odd nodes freeze
    at kq = k/2 (ctl), the others run all k steps: on the tier
    greedy_loop.resident_bits_plan picks and on the device-memory tier
    (forced), each bit for bit."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    dev = words.device
    w = words.shape[1]
    cd = _bits_nodes(torch, words, nodes, bk, seed)
    row = torch.zeros(nodes, w, dtype=R.WORD_DTYPE, device=dev)
    mask = torch.ones(nodes, bk, device=dev)
    ctl = torch.tensor([[k if i % 2 == 0 else k // 2, w, bk]
                        for i in range(nodes)], dtype=torch.int32,
                       device=dev)
    plain = L.greedy_loop_resident_plain(None, cd, row, mask, ctl, k,
                                         R.BITS_OR)
    what = f"greedy_loop_resident[coverage], {nodes} nodes"
    out = {"shape": [nodes, bk, w, k],
           "plan": list(L.resident_bits_plan(w, bk))}
    out["plan_tier"] = parity.compare_exact(L.greedy_loop_resident(
        None, cd, row, mask, ctl, k, R.BITS_OR), plain, what)
    with _device_memory_tier("RESIDENT_BITS_SMEM_BYTES"):
        out["device_tier"] = parity.compare_exact(L.greedy_loop_resident(
            None, cd, row, mask, ctl, k, R.BITS_OR), plain,
            what + ", device-memory tier")
    return out


def _coverage_tree(torch, name, bits, words, cfg, phase: str):
    """run_tree_dense on bitmaps at a full configuration (→ launch totals,
    its SimResult): the leaves on
    the streaming loop (1 launch), every level on the resident loop (1
    launch), no pairwise launch anywhere (a bitmap matrix is a view);
    the leaf stage's device allocation held to the planner's cache bytes
    (the pools the cache views, nothing copied)."""
    from repro_torch.core.simulate import global_value, partition, \
        run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import cache_bytes, select_engine
    from repro_torch.kernels.rules import BITS_OR
    from repro_torch.core.simulate import _pools
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    w = words.shape[1]
    # the host's share of the leaf stage: the random tape and the pools
    # (a stable argsort of n ids), as run_tree_dense builds them
    t0 = time.perf_counter()
    pool_ids, _ = _pools(partition(cfg.n, cfg.num_machines, cfg.seed),
                         cfg.num_machines)
    host_pools_s = time.perf_counter() - t0
    n_leaf = pool_ids.shape[1]
    leaf_bytes = cache_bytes(w, n_leaf, "uint32", cfg.num_machines)
    levels = []
    counters.reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hook = _level_hook(torch, levels)
    peak = []

    def on_level(lvl):
        hook(lvl)
        if lvl == 0:
            peak.append(torch.cuda.max_memory_allocated() - base)

    t0 = time.perf_counter()
    res = run_tree_dense(name, words, cfg.k, tree, seed=cfg.seed,
                         universe=cfg.universe, device=words.device,
                         on_level=on_level)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = {}
    for lv in levels:
        lvl = lv["level"]
        n_stage = n_leaf if lvl == 0 else cfg.branching * cfg.k
        reps = (cfg.num_machines if lvl == 0
                else len(tree.nodes_at_level(lvl)))
        engine = select_engine(BITS_OR, w, n_stage, replicas=reps).engine
        lv["engine"] = engine
        want = ({"greedy_loop[coverage]": 1} if lvl == 0
                else {"greedy_loop_resident[coverage]": 1})
        assert engine == ("mega_stream" if lvl == 0 else "mega_resident"), (
            lvl, engine)
        assert lv["launches"] == want, (lvl, lv["launches"], want)
        for k, v in lv["launches"].items():
            totals[k] = totals.get(k, 0) + v
    assert len(levels) == tree.num_levels + 1
    ids = np.asarray(res.ids)
    assert 0 < len(ids) <= cfg.k and len(set(ids.tolist())) == len(ids)
    assert ids.min() >= 0 and ids.max() < cfg.n
    # coverage's value does not depend on the ground set: the root's
    # value IS the coverage of its ids over the whole universe
    t1 = time.perf_counter()
    rescored = global_value(name, bits, ids)
    rescore_s = time.perf_counter() - t1
    assert rescored == res.value == res.root_value, (
        rescored, res.value, res.root_value)
    # the leaf stage allocated the pools (the cache) and small outputs:
    # no copy of the cache
    assert leaf_bytes <= peak[0] < 1.05 * leaf_bytes, (peak, leaf_bytes)
    emit({"phase": phase, "n": cfg.n, "universe": cfg.universe, "words": w,
          "k": cfg.k, "m": cfg.num_machines, "b": cfg.branching,
          "leaf_pool": n_leaf, "leaf_cache_bytes_planned": leaf_bytes,
          "leaf_stage_bytes_allocated": int(peak[0]),
          "host_pools_seconds": host_pools_s,
          "levels": levels, "wall_seconds": wall,
          "root_value": res.root_value, "global_value": res.value,
          "global_value_recomputed": rescored,
          "global_value_seconds": rescore_s, "root_ids": len(ids),
          "evals_total": res.evals_total,
          "comm_elements": res.comm_elements})
    return totals, res


def phase_kcover_knapsack(torch, words, cfg, pools):
    """The constrained coverage path: LevelDispatcher with a KnapsackSpec
    of uniform(0.5, 2) costs by global id over the 32 lanes, budget 40.
    Every stage runs the fused engine: k fused_step launches over the
    candidates' words read in place, no pairwise launch."""
    from repro_torch.core.constraints import KnapsackSpec
    spec = KnapsackSpec(torch.as_tensor(knapsack_costs(cfg.n, cfg.seed),
                                        device=words.device), BUDGET_KCOVER)

    def expect(stage, engine):
        assert engine == "fused", (stage, engine)
        return {"fused_step[coverage]": cfg.k}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(
        torch, words, cfg, pools, expect, objective="kcover",
        constraint=spec)
    wall = time.perf_counter() - t0
    spent = spec.spent(sols.ids, sols.valid).cpu().numpy()
    assert (spent <= BUDGET_KCOVER).all(), spent
    ids, root = _report_root(torch, words, sols, cfg.k, "kcover")
    assert len(ids) < cfg.k, "the budget did not bind"
    assert totals["fused_step[coverage]"] == len(stages) * cfg.k
    emit({"phase": "kcover_knapsack", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "budget": BUDGET_KCOVER, "stages": stages, "wall_seconds": wall,
          **root, "spent_root": float(spent[0]),
          "spent_lanes": spent.tolist()})
    return totals


def phase_kcover_stochastic(torch, words, cfg, pools):
    """The stochastic coverage path: sample_leaf = ⌈(n_l/k)·ln 100⌉ over
    the padded lane pools (2,227 at KOSARAK): the leaves on the per-step
    engine (k gains launches), the nodes unsampled on the resident loop."""
    from repro_torch.core.greedyml import LaneSampler
    sample = sample_size(pools[1].shape[1], cfg.k)
    # the host's share of the leaf stage: the default sampler's draws
    # (CPU generators, one per lane), apart from the run
    t0 = time.perf_counter()
    LaneSampler(cfg.seed)(0, pools[0].shape[0], cfg.k, pools[1].shape[1],
                          sample)
    draws_s = time.perf_counter() - t0

    def expect(stage, engine):
        if stage == 0:
            assert engine == "step", engine
            return {"gains[coverage]": cfg.k}
        assert engine == "mega_resident", (stage, engine)
        return {"greedy_loop_resident[coverage]": 1}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(
        torch, words, cfg, pools, expect, objective="kcover",
        sample_leaf=sample, seed=cfg.seed)
    wall = time.perf_counter() - t0
    _, root = _report_root(torch, words, sols, cfg.k, "kcover")
    emit({"phase": "kcover_stochastic", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "sample_leaf": sample, "stages": stages, "wall_seconds": wall,
          "leaf_draws_seconds": draws_s, **root})
    return totals


def phase_data_kdom(torch, cfg, dev):
    """kdom's bitmaps: closed neighbourhoods of the road-like graph,
    packed over its vertices (W ≫ k: 2,048 words against k = 128), on
    the card as int32 words."""
    from repro_torch.data.synthetic import gen_graph_road, pack_bitmaps
    from repro_torch.kernels.rules import to_words
    t0 = time.perf_counter()
    bits = pack_bitmaps(gen_graph_road(cfg.n, seed=cfg.seed), cfg.universe)
    words = to_words(bits).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "data_kdom", "n": cfg.n, "words": int(bits.shape[1]),
          "gigabytes": bits.nbytes / 1e9,
          "seconds": time.perf_counter() - t0})
    return bits, words


def phase_kdom_run(torch, cfg, dev, reps):
    """run_tree_dense('kdom', …) at the reference's kdom configuration,
    after its loops' parity and (line `timing_kdom`) the resident loop
    at every level's nodes; → (launches, errors, the bitmaps' words on
    the card)."""
    bits, words = phase_data_kdom(torch, cfg, dev)
    out = {"greedy_loop": _leaf_loop_parity(torch, words, cfg)}
    bk = cfg.branching * cfg.k
    out["greedy_loop_resident"] = {
        str(nn): _resident_coverage_parity(torch, words, nn, bk, cfg.k,
                                           cfg.seed + 10 + nn)
        for nn in _level_nodes(cfg)}
    emit({"phase": "parity_kdom", "rule": "exact (bit for bit)", **out})
    emit({"phase": "timing_kdom", "greedy_loop_resident[coverage]_levels":
          _resident_bits_levels(torch, words, cfg, reps, variants=True)})
    launches, _ = _coverage_tree(torch, "kdom", bits, words, cfg,
                                 "kdom_run")
    return launches, _max_errs(out), words


def phase_timing_coverage(torch, words, cfg, pools, reps):
    """Each bitmap kernel at its path's shape beside its plain version
    and its bound: bytes over the HBM rate (a popcount pass does a few
    integer operations per word read, far below the card's integer
    rate). The streaming loop re-reads its caches every step, less what
    L2 and shared memory could hold; the resident loop reads its nodes'
    words once from device memory, and is timed at every level's nodes
    and the stochastic run's lanes (`_resident_bits_levels`: µs a step,
    its tier and cluster, the forced device-memory tier). No single
    PyTorch call computes a popcount gain, so there is no library
    time."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.BITS_OR
    dev = words.device
    w = words.shape[1]
    k = cfg.k
    _, lpay, lvalid = pools
    b, n, _ = lpay.shape
    out = {}
    row = random_words(torch, (b, w), cfg.seed, dev)
    s = sample_size(n, k)
    idx = LaneSampler(cfg.seed)(0, b, 1, n, s)[:, 0].to(dev)
    cands = torch.gather(lpay, 1, idx[..., None].expand(b, s, w))
    cv = torch.ones(b, s, dtype=torch.bool, device=dev)
    nbytes = 4.0 * (b * s * w + b * w + b * s) + b * s
    out["gains[coverage]"] = {
        "shape": [b, s, w],
        "ms": cuda_ms(torch, lambda: P.gains(None, row, cands, cv, rule),
                      20 * reps),
        "plain_ms": cuda_ms(torch, lambda: P.gains_plain(None, row, cands,
                                                         cv, rule), reps),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes"}
    del cands
    mat = lpay.transpose(1, 2)
    mask = lvalid.float()
    prev = torch.zeros(b, dtype=torch.int64, device=dev)
    nbytes = 4.0 * (b * n * w + 3 * b * w + b * n) + 16.0 * b
    out["fused_step[coverage]"] = {
        "shape": [b, w, n],
        "ms": cuda_ms(torch, lambda: F.fused_step_bits(mat, row, mask, prev,
                                                       rule), 10 * reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            mat, row, mask, prev, rule), reps),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes"}
    del mat, mask
    # the knapsack node shape (reported, not in the kernels line): 32
    # lanes of b·k = 128 sets, whose words sit in L2
    bk = cfg.branching * k
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 5)
    pick = torch.randint(0, words.shape[0], (b, bk), generator=gen,
                         device=dev)
    nmat = words[pick].transpose(1, 2)
    nmask = torch.ones(b, bk, device=dev)
    out["fused_step[coverage]_node"] = {
        "shape": [b, w, bk],
        "ms": cuda_ms(torch, lambda: F.fused_step_bits(nmat, row, nmask, prev,
                                                       rule), 20 * reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            nmat, row, nmask, prev, rule), 20 * reps),
        "bound_ms": 4.0 * (b * bk * w + 3 * b * w + b * bk) / PEAK_HBM_BYTES
        * 1e3}
    del nmat
    out["greedy_loop[coverage]"] = _leaf_loop_bits_timing(torch, words, cfg,
                                                          reps)
    levels = _resident_bits_levels(torch, words, cfg, reps, lanes=(b,),
                                   variants=True)
    nn = cfg.num_machines // cfg.branching
    args = _level_args(torch, words, cfg, nn)
    out["greedy_loop_resident[coverage]"] = {
        **{key: levels[str(nn)][key]
           for key in ("shape", "ms", "bound_ms", "bound_by")},
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_resident_plain(
            None, *args, k, rule), reps),
        "library_ms": None}
    out["greedy_loop_resident[coverage]_levels"] = levels
    emit({"phase": "timing_coverage", **out})
    return out


def _bits_digest(outs) -> str:
    """sha1 of a loop's outputs (rows, bests, gains) as bytes: two trees
    whose digests agree gave the same bits."""
    import hashlib
    h = hashlib.sha1()
    for t in outs:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _leaf_loop_bits_timing(torch, words, cfg, reps) -> dict:
    """The bitmap streaming loop (4c) over the first leaf level of
    run_tree_dense (its padded pools, read in place), k steps from an
    empty row, beside its plain version and its bound: the caches
    re-read every step, less what L2 and shared memory could hold; the
    `digest` of its outputs."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import rules as R
    rule = R.BITS_OR
    k = cfg.k
    w = words.shape[1]
    ids, pay, valid = leaf_pools(torch, words, cfg.num_machines, cfg.seed)
    mat = pay.transpose(1, 2)
    bl, nl = pay.shape[:2]
    row = torch.zeros(bl, w, dtype=R.WORD_DTYPE, device=words.device)
    mask = valid.float()
    cache = 4.0 * bl * nl * w
    nbytes = (k * cache - (k - 1) * min(cache, on_chip_bytes(torch))
              + 4.0 * (2 * bl * w + bl * nl) + 8.0 * bl * k)
    return {
        "shape": [bl, w, nl, k],
        "ms": cuda_ms(torch, lambda: L.greedy_loop_bits(mat, row, mask, k,
                                                        rule), reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_plain(
            mat, row, mask, k, rule), 1, warmup=0),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes",
        "digest": _bits_digest(L.greedy_loop_bits(mat, row, mask, k, rule))}


def _level_args(torch, words, cfg, nodes: int):
    """The bitmap resident loop's inputs at a level of `nodes` nodes:
    `_bits_nodes` of b·k sets, an empty row, every candidate live, all k
    steps (ctl)."""
    from repro_torch.kernels import rules as R
    dev = words.device
    w = words.shape[1]
    bk = cfg.branching * cfg.k
    return (_bits_nodes(torch, words, nodes, bk, cfg.seed + 20 + nodes),
            torch.zeros(nodes, w, dtype=R.WORD_DTYPE, device=dev),
            torch.ones(nodes, bk, device=dev),
            torch.tensor([[cfg.k, w, bk]] * nodes, dtype=torch.int32,
                         device=dev))


def _resident_bits_levels(torch, words, cfg, reps, lanes=(),
                          variants=False) -> dict:
    """The bitmap resident loop (5c) at the node count of every level of
    cfg's tree and at `lanes` (`_level_args`), timed through
    greedy_loop_resident (a call every tree of the port has), in µs a
    step beside the bytes bound (the words read once, the rows, masks
    and ctl in, the rows and k outputs out), with the `digest` of its
    outputs. `variants`: also the tier and cluster the plan picks and
    the forced device-memory tier's time."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import rules as R
    rule = R.BITS_OR
    k = cfg.k
    w = words.shape[1]
    bk = cfg.branching * k
    out = {}
    for nn in sorted(set(_level_nodes(cfg)) | set(lanes), reverse=True):
        args = _level_args(torch, words, cfg, nn)
        ms = cuda_ms(torch, lambda: L.greedy_loop_resident(
            None, *args, k, rule), 10 * reps)
        nbytes = (4.0 * (nn * bk * w + 2 * nn * w + nn * bk + 3 * nn)
                  + 8.0 * nn * k)
        row = {"shape": [nn, bk, w, k], "ms": ms, "us_per_step": ms * 1e3 / k,
               "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes",
               "digest": _bits_digest(L.greedy_loop_resident(
                   None, *args, k, rule))}
        if variants:
            tier, cluster = L.resident_bits_plan(w, bk)
            row.update(tier=tier, cluster=cluster)
            with _device_memory_tier("RESIDENT_BITS_SMEM_BYTES"):
                row["device_tier_ms"] = cuda_ms(
                    torch, lambda: L.greedy_loop_resident(
                        None, *args, k, rule), 10 * reps)
        out[str(nn)] = row
    return out


# ---------------------------------------------------------------------------
# streaming: the sieve filter (B6) and the int8-ground gains (B2q)
# ---------------------------------------------------------------------------

# the evaluation set of the int8 k-medoid stream and of the stream
# filter's parity and timing at 16,384 rows: drawn from the stream with
# the seed (the f32 stream evaluates against all n images), a second row
# length for the decisions (2,048 entries a block against 12,500)
STREAM_EVAL = 16_384
# the wider bitmap parity shape: 8,192 words (262,144 items), held on
# both tiers (the device-memory tier forced)
GLOBAL_WORDS = 8_192
STREAM_EPS = 0.1
# arrivals a batch: at the k-medoid stream's 16,384 evaluation rows the
# batch's (N, B) f32 slab is 16.8 MB, within the half of the 50 MB L2
# that every level block re-reads it from
STREAM_BATCH = 256
# the kcover window: the last 262,144 arrivals, a checkpoint every 65,536
WINDOW, STRIDE = 262_144, 65_536
CONTINUOUS_LANES, MERGE_EVERY = 4, 256


def _stream_state(torch, rule, levels, row0, cost: bool, lanes: int = 1):
    """Empty canonical stream-filter state (rows, row0, values, counts,
    expos, m[, spent]) of `lanes` stacked sieves."""
    dev = row0.device
    st = (row0.expand(lanes, levels, row0.shape[0]).contiguous(), row0,
          torch.zeros(lanes, levels, device=dev),
          torch.zeros(lanes, levels, dtype=torch.int32, device=dev),
          torch.arange(levels, dtype=torch.int32, device=dev).expand(
              lanes, levels).contiguous(),
          torch.zeros(lanes, device=dev))
    return st + (torch.zeros(lanes, levels, device=dev),) if cost else st


def _next_state(out, row0, cost: bool):
    """The canonical state after a batch, from a filter's outputs."""
    return (out[0], row0, out[1], out[2], out[4], out[5]) + (
        (out[7],) if cost else ())


@contextlib.contextmanager
def _device_memory_tier(gate: str = "STREAM_SMEM_BYTES"):
    """A kernel's device-memory tier, forced by squeezing its shared
    memory gate in plans for the duration, as the CUDA tests do: the
    stream filter's rows (STREAM_SMEM_BYTES), or the bitmap resident
    loop's words (RESIDENT_BITS_SMEM_BYTES)."""
    from repro_torch.kernels import plans
    old = getattr(plans, gate)
    setattr(plans, gate, 64)
    try:
        yield
    finally:
        setattr(plans, gate, old)


def _cuda_events(torch, prof):
    """(kernel name, launches recorded, device µs) of each CUDA entry of a
    torch.profiler trace's key_averages."""
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        yield e.key.split("(")[0], e.count, us


def _kernel_split(torch, fn, calls: int = 10) -> dict:
    """Device time by CUDA kernel over `calls` calls of fn, from
    torch.profiler's key_averages: each kernel's mean ms a launch and the
    launches the trace recorded (it may miss a launch of the first call),
    and the CUDA launches of a call (all recorded launches over `calls`);
    "not measured" when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for name, count, us in _cuda_events(torch, prof):
        for short in ("rt_row_norms", "rt_stream_slab", "rt_stream_singles",
                      "rt_stream_decide", "rt_stream_bits_prep",
                      "rt_stream_bits_level", "rt_resident_build",
                      "rt_resident_steps"):
            if short in name:
                name = short
        k = kernels.setdefault(name, {"launches_recorded": 0, "us": 0.0})
        k["launches_recorded"] += count
        k["us"] += us
    if not kernels or sum(k["us"] for k in kernels.values()) <= 0:
        return {"kernel_split": "not measured", "cuda_launches_per_call":
                "not measured"}
    launches = sum(k["launches_recorded"] for k in kernels.values())
    for k in kernels.values():
        k["ms_per_launch"] = k.pop("us") / 1e3 / max(k["launches_recorded"],
                                                     1)
    return {"kernel_split": kernels, "calls": calls,
            "cuda_launches_per_call": launches / calls}


def _digest(ids, value) -> dict:
    """A stream summary's value and a hash of its sorted ids: two trees
    run in one call give equal digests when their streams agree."""
    import hashlib
    srt = np.sort(np.asarray(ids, np.int64).reshape(-1))
    return {"value": float(value), "ids": int(srt.size),
            "ids_sha1": hashlib.sha1(srt.tobytes()).hexdigest()[:16]}


def _stream_eval_set(torch, x, seed: int):
    """STREAM_EVAL images of the stream drawn without replacement with
    the seed: the fixed evaluation set of the k-medoid stream."""
    ids = np.sort(np.random.default_rng(seed).choice(
        x.shape[0], STREAM_EVAL, replace=False))
    return x[torch.as_tensor(ids, device=x.device)].contiguous()


def _stream_batches(torch, data, n_batches: int, b: int, seed: int,
                    costs=None):
    """The first `n_batches` arrival batches of data shuffled with the
    seed: (ids, payloads, valid, costs or None)."""
    order = torch.as_tensor(np.random.default_rng(seed).permutation(
        data.shape[0])[:n_batches * b], device=data.device)
    out = []
    for i in range(n_batches):
        ids = order[i * b:(i + 1) * b]
        out.append((ids, data[ids].contiguous(),
                    torch.ones(b, dtype=torch.bool, device=data.device),
                    None if costs is None else costs[ids].contiguous()))
    return out


def phase_parity_stream(torch, x, cfg, pools):
    """B6 on feature rules at the k-medoid stream's shape (N = 16,384
    evaluation rows, B = 256 arrivals, L = 72 levels, D = 12,288), three
    chained batches fed the plain version's state on both sides, for
    kmedoid and facility, with and without knapsack costs (budget 100):
    the kernel's slab by the float64 pairwise rule, its decisions by
    parity.compare_stream (ties counted); the int8-ground variant bit
    for bit against the f32 kernel on the dequantized ground, and by
    compare_stream against the plain version there. Then B2q at the
    stochastic leaf shape (32 × 3,125 ground rows × 72 sampled
    candidates × 12,288): bit for bit against the f32 gains kernel on
    the dequantized ground, and the float64 ratio rule against its plain
    version. The slot update (scatter_slots) at the k-medoid stream's
    shape, (1, 72, 200, 12,288) f32 payload slots, over the same three
    batches: bit for bit against the reference's one-hot formula, and
    every filled slot's payload equal to its id's image. Returns each
    kernel's largest measured |kernel − plain|, and the filter state and
    the slots after the three batches for the timing phase."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    levels = num_levels(k, STREAM_EPS)
    eps_log = math.log1p(STREAM_EPS)
    ground = _stream_eval_set(torch, x, cfg.seed)
    n, d = ground.shape
    q, scale = ops.quantize_ground(ground)
    deq = R.dequant(q, scale).contiguous()
    gscale = scale.reshape(-1).contiguous()
    costs = torch.as_tensor(knapsack_costs(x.shape[0], cfg.seed),
                            device=x.device)
    batches = _stream_batches(torch, x, 4, b, cfg.seed + 1, costs)
    spare, batches = batches[3], batches[:3]    # the timing phase's batch
    errs = {"stream_filter": 0.0, "stream_filter[int8]": 0.0}
    out, timing_state = {}, None
    for name, rule in (("kmedoid", R.DIST_MIN), ("facility", R.DOT_MAX)):
        for cost in (False, True):
            res = {"f32": [], "int8": []}
            for tag, g_in in (("f32", ground), ("int8", deq)):
                row0 = R.empty_row(ground[None], torch.ones(
                    1, n, dtype=torch.bool, device=x.device), rule)[0]
                st = _stream_state(torch, rule, levels, row0.contiguous(),
                                   cost)
                first = (name, cost, tag) == ("kmedoid", False, "f32")
                if first:
                    slots = (torch.full((1, levels, k), -1,
                                        dtype=torch.int64, device=x.device),
                             torch.zeros(1, levels, k, d, device=x.device))
                    scatter = {"shape": [1, levels, k, d], "admitted": 0,
                               "entries": 0, "differing": 0}
                for bids, pay, valid, c in batches:
                    arr, bv = pay[None], valid[None]
                    kw = (dict(costs=c[None], spent=st[6], budget=BUDGET)
                          if cost else {})
                    mat_k = torch.empty(1, b, n, device=x.device)
                    if tag == "f32":
                        got = TS.stream_filter(ground, arr, *st[:6], bv, k,
                                               eps_log, rule, scratch=mat_k,
                                               **kw)
                    else:
                        got = TS.stream_filter(q, arr, *st[:6], bv, k,
                                               eps_log, rule, gscale=gscale,
                                               scratch=mat_k, **kw)
                        mat_f = torch.empty_like(mat_k)
                        f32 = TS.stream_filter(deq, arr, *st[:6], bv, k,
                                               eps_log, rule, scratch=mat_f,
                                               **kw)
                        same = parity.compare_exact(
                            got + (mat_k,), f32 + (mat_f,),
                            f"stream_filter[int8] {name}")
                        del f32, mat_f
                    plain = TS.stream_filter_plain(g_in, arr, *st[:6], bv, k,
                                                   eps_log, rule, **kw)
                    mat_p = TRef.pairwise(g_in, arr, rule)
                    mstats = parity.compare_pairwise(
                        mat_k.transpose(1, 2), mat_p, g_in[None], arr,
                        rule.pairwise, what=f"stream_filter slab {name}")
                    cmp = parity.compare_stream(
                        got, plain, mat_k, mat_p,
                        st[:6] + ((st[6],) if cost else (None,)), bv, k,
                        eps_log, rule, costs=c[None] if cost else None,
                        budget=BUDGET if cost else None,
                        what=f"stream_filter {name} {tag}")
                    cmp["slab_rms_ratio"] = mstats["rms_ratio"]
                    if tag == "int8":
                        cmp["vs_f32_kernel_differing"] = same["differing"]
                    res[tag].append(cmp)
                    key = "stream_filter" + ("[int8]" if tag == "int8"
                                             else "")
                    errs[key] = max(errs[key], cmp["max_value_err"],
                                    cmp["max_row_err"], cmp["max_m_err"])
                    if first:
                        sargs = (st[3], plain[6], plain[3], bids[None], arr,
                                 k)
                        want = TS.scatter_slots_plain(*slots, *sargs)
                        slots = TS.scatter_slots(*slots, *sargs)
                        r = parity.compare_exact(slots, want,
                                                 "scatter_slots kmedoid")
                        scatter["admitted"] += int(plain[3].sum())
                        scatter["entries"] += r["entries"]
                        scatter["differing"] += r["differing"]
                        scatter["max_abs_err"] = max(
                            scatter.get("max_abs_err", 0.0),
                            r["max_abs_err"])
                        del want
                    st = _next_state(plain, st[1], cost)
                    del got, plain, mat_k, mat_p
                if first:
                    timing_state = st
                    filled = slots[0] >= 0
                    assert bool(filled.any())
                    assert torch.equal(slots[1][filled],
                                       x[slots[0][filled]]), \
                        "scatter_slots: a slot's payload is not its image"
                    scatter["filled_slots"] = int(filled.sum())
            out[f"{name}{'_knapsack' if cost else ''}"] = res
    del q, scale, deq, gscale
    # B2q at the stochastic leaf shape
    _, pay, valid = pools
    lanes, nl, _ = pay.shape
    gq, gs = ops.quantize_ground(pay)
    gdeq = R.dequant(gq, gs).contiguous()
    sample = sample_size(nl, k)
    idx = LaneSampler(cfg.seed)(0, lanes, 1, nl, sample)[:, 0].to(x.device)
    cands = torch.gather(pay, 1, idx[..., None].expand(lanes, sample, d))
    cands = cands.contiguous()
    cv = torch.ones(lanes, sample, dtype=torch.bool, device=x.device)
    cv[:, -1] = False
    b2q = {}
    for name, rule in (("kmedoid", R.DIST_MIN), ("facility", R.DOT_MAX)):
        row = R.empty_row(gdeq, valid, rule)
        for j in range(5):
            row = R.update_row(gdeq, row, gdeq[:, 97 * j % nl], rule)
        row = row.contiguous()
        gnorm = P.ground_norms(gq, gs) if rule.pairwise == "dist" else None
        got = P.gains(gq, row, cands, cv, rule, gscale=gs, gnorm=gnorm)
        same = parity.compare_exact(got, P.gains(gdeq, row, cands, cv, rule),
                                    f"gains[int8] {name} vs the f32 kernel")
        yard = parity.compare_exact(got, P.gains(
            gq, row, cands, cv, rule, gscale=gs, reference=True),
            f"gains[int8] {name} vs the 64x64 build")
        plain = P.gains_plain(gq, row, cands, cv, rule, gs)
        stats = parity.compare_gains(got, plain, gdeq, row, cands, rule,
                                     what=f"gains[int8] {name}")
        fin = torch.isfinite(plain)
        stats["max_abs_diff"] = float((got[fin] - plain[fin]).abs().max())
        stats["vs_f32_kernel_differing"] = same["differing"]
        stats["vs_64x64_build_differing"] = yard["differing"]
        b2q[name] = stats
    errs["gains[int8]"] = b2q["kmedoid"]["max_abs_diff"]
    del gq, gs, gdeq, cands
    emit({"phase": "parity_stream", "shape": [1, levels, n, b, d],
          "k": k, "batches": len(batches), "budget": BUDGET,
          **{c: {t: {"ties": sum(r["ties"] + r["window_ties"] for r in v),
                     "decisions": sum(r["decisions"] for r in v),
                     "admitted": sum(r["admitted"] for r in v),
                     "max_value_err": max(r["max_value_err"] for r in v),
                     "max_row_err": max(r["max_row_err"] for r in v),
                     "max_m_err": max(r["max_m_err"] for r in v),
                     "slab_rms_ratio": max(r["slab_rms_ratio"] for r in v)}
                 for t, v in res.items()} for c, res in out.items()},
          "scatter_slots": scatter,
          "gains[int8]": {"shape": [lanes, nl, sample, d], **b2q}})
    return errs, (ground, timing_state, spare, slots)


def phase_parity_stream_global(torch, x, cfg, k_bits: int):
    """B6 at the shapes beyond one block's shared memory. Feature rules:
    the f32 k-medoid stream against all n images (72 levels × 100,000
    evaluation rows × 256 arrivals × 12,288: a level's 400 KB row over a
    cluster of 8 blocks), three chained batches fed the plain version's
    state, the slab by the float64 pairwise rule and the decisions by
    parity.compare_stream; the device-memory tier (forced) equal to it
    bit for bit. Bitmaps: GLOBAL_WORDS = 8,192 words (262,144 items,
    random sparse sets), k = `k_bits`, three chained batches, every
    output bit for bit against the plain version on the shared-memory
    tier and on the device-memory tier (forced). Returns each variant's
    largest measured |kernel − plain| and, for timing_stream, both
    states three batches in with a fourth batch each."""
    from repro_torch.kernels import counters, parity, plans
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    eps_log = math.log1p(STREAM_EPS)
    rule = R.DIST_MIN
    levels = num_levels(k, STREAM_EPS)
    n, d = x.shape
    dev = x.device
    assert plans.stream_tier(n, b, rule) == "kernel"
    row0 = R.empty_row(x[None], torch.ones(1, n, dtype=torch.bool,
                                           device=dev), rule)[0].contiguous()
    gnorm = TS.ground_norms(x)
    st = _stream_state(torch, rule, levels, row0, False)
    batches = _stream_batches(torch, x, 4, b, cfg.seed + 1)
    res, errs = [], {"stream_filter": 0.0, "stream_filter[coverage]": 0.0}
    tiers = {"entries": 0, "differing": 0}
    counters.reset()
    for _, pay, valid, _ in batches[:3]:
        arr, bv = pay[None], valid[None]
        mat_k = torch.empty(1, b, n, device=dev)
        got = TS.stream_filter(x, arr, *st[:6], bv, k, eps_log, rule,
                               scratch=mat_k, gnorm=gnorm)
        with _device_memory_tier():
            glob = TS.stream_filter(x, arr, *st[:6], bv, k, eps_log, rule,
                                    gnorm=gnorm)
        r = parity.compare_exact(glob, got, "stream_filter, device-memory "
                                 "tier vs a cluster of 8")
        tiers["entries"] += r["entries"]
        tiers["differing"] += r["differing"]
        del glob
        plain = TS.stream_filter_plain(x, arr, *st[:6], bv, k, eps_log,
                                       rule)
        mat_p = TRef.pairwise(x, arr, rule)
        mstats = parity.compare_pairwise(
            mat_k.transpose(1, 2), mat_p, x[None], arr, rule.pairwise,
            what="stream_filter slab, 100,000 rows")
        cmp = parity.compare_stream(got, plain, mat_k, mat_p,
                                    st[:6] + (None,), bv, k, eps_log, rule,
                                    what="stream_filter, 100,000 rows")
        cmp["slab_rms_ratio"] = mstats["rms_ratio"]
        res.append(cmp)
        errs["stream_filter"] = max(errs["stream_filter"],
                                    cmp["max_value_err"], cmp["max_row_err"],
                                    cmp["max_m_err"])
        st = _next_state(plain, row0, False)
        del got, plain, mat_k, mat_p
    assert counters.snapshot()["stream_filter"]["launches"] == 6
    # bitmaps at 8,192 words, on both tiers
    w, brule = GLOBAL_WORDS, R.BITS_OR
    blevels = num_levels(k_bits, STREAM_EPS)
    assert plans.stream_tier(w, b, brule) == "kernel"
    words = random_words(torch, (4 * b, w), cfg.seed + 5, dev)
    brow0 = torch.zeros(w, dtype=R.WORD_DTYPE, device=dev)
    bst = _stream_state(torch, brule, blevels, brow0, False)
    ball = torch.ones(1, b, dtype=torch.bool, device=dev)
    bits = {"entries": 0, "differing": 0, "admitted": 0}
    counters.reset()
    for i in range(3):
        arr = words[i * b:(i + 1) * b][None]
        plain = TS.stream_filter_plain(None, arr, *bst, ball, k_bits,
                                       eps_log, brule)
        for tier in ("kernel", "global"):
            with (_device_memory_tier() if tier == "global"
                  else contextlib.nullcontext()):
                assert plans.stream_tier(w, b, brule) == tier
                got = TS.stream_filter(None, arr, *bst, ball, k_bits,
                                       eps_log, brule)
            r = parity.compare_exact(got, plain, "stream_filter[coverage], "
                                     f"8,192 words, tier {tier}")
            bits["entries"] += r["entries"]
            bits["differing"] += r["differing"]
            errs["stream_filter[coverage]"] = max(
                errs["stream_filter[coverage]"], r["max_abs_err"])
        bits["admitted"] += int(plain[3].sum())
        bst = _next_state(plain, brow0, False)
    assert counters.snapshot()["stream_filter[coverage]"]["launches"] == 6
    assert bits["admitted"] > 0
    emit({"phase": "parity_stream_global",
          "kmedoid": {"shape": [1, levels, n, b, d], "k": k,
                      "tier": "kernel",
                      "batches": len(res),
                      "ties": sum(r["ties"] + r["window_ties"] for r in res),
                      "decisions": sum(r["decisions"] for r in res),
                      "admitted": sum(r["admitted"] for r in res),
                      "max_value_err": max(r["max_value_err"] for r in res),
                      "max_row_err": max(r["max_row_err"] for r in res),
                      "max_m_err": max(r["max_m_err"] for r in res),
                      "slab_rms_ratio": max(r["slab_rms_ratio"]
                                            for r in res),
                      "device_memory_tier_vs_cluster": {
                          **tiers, "rule": "exact (bit for bit)"}},
          "coverage": {"shape": [1, blevels, w, b], "k": k_bits,
                       "batches": 3, "tiers": ["kernel", "global"],
                       "rule": "exact (bit for bit)", **bits}})
    return errs, ((st, batches[3], gnorm),
                  (bst, words[3 * b:][None], k_bits))


def phase_reference_stream(torch, devices=("cuda", "cpu")):
    """Small-integer facility streams through the kernels against the
    same streams through the plain CPU path: every matrix entry and gain
    is an exact integer on both, so `stream_select` (4,096 arrivals
    against 1,024 evaluation rows, k = 16), a `SlidingSieve` (window
    1,024, stride 256) and a 4-lane `ContinuousSelector` (b = 2, a merge
    every 4 batches; its merge nodes on the resident loop) must give
    equal ids and values."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.kernels import counters
    from repro_torch.streaming import (SieveStreamer, SlidingSieve,
                                       stream_select,
                                       stream_select_continuous)
    rng = np.random.default_rng(9)
    xi = rng.integers(-3, 4, (4096, 64)).astype(np.float32)
    order = rng.permutation(4096)
    evals = xi[np.sort(rng.choice(4096, 1024, replace=False))]
    runs = {}
    for dev in devices:
        obj = make_objective("facility", device=dev)
        data = torch.as_tensor(xi, device=dev)
        ground = torch.as_tensor(evals, device=dev)
        st = Stream(data, order, 256)
        counters.reset()
        one = stream_select(obj, st, 16, ground=ground)
        win = SlidingSieve(SieveStreamer(obj, 16, ground=ground), 1024, 256)
        ws = win.init()
        for ids, pay, valid in st:
            ws = win.process_batch(ws, ids, pay, valid)
        wsol = win.query(ws)
        cont, info = stream_select_continuous(obj, st, 16, lanes=4,
                                              branching=2, merge_every=4,
                                              ground=ground)
        launched = {n: c["launches"] for n, c in
                    counters.snapshot().items() if c["launches"]}
        runs[dev] = ([s.map(lambda t: t.cpu()) for s in (one, wsol, cont)],
                     info["merges"], launched)
    (g, g_merges, launched), (c, c_merges, _) = (runs[d] for d in devices)
    for what, a, b in zip(("stream_select", "window", "continuous"), g, c):
        assert torch.equal(a.ids, b.ids), (what, a.ids, b.ids)
        assert torch.equal(a.value, b.value), (what, a.value, b.value)
    assert g_merges == c_merges, (g_merges, c_merges)
    assert launched.get("stream_filter", 0) == 3 * 16, launched
    assert launched.get("greedy_loop_resident", 0) > 0, launched
    emit({"phase": "reference_stream", "ids_equal": True,
          "values": [float(s.value) for s in g], "merges": g_merges,
          "launches": launched})


def _stream_run(torch, name, data, cfg, k, ground=None, env=None,
                tier="kernel"):
    """stream_select(`name`) over all of `data` shuffled with the seed,
    B = 256: wall, arrivals/s, the plan (asserted on `tier`), the
    launches per variant (asserted: one
    stream filter and one slot update a batch), the summary's digest;
    every selected slot's payload is its arrival's row of `data`."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.kernels import counters
    from repro_torch.streaming import SieveStreamer, stream_select
    b = STREAM_BATCH
    obj = make_objective(name, universe=cfg.universe, device=data.device)
    order = np.random.default_rng(cfg.seed).permutation(data.shape[0])
    n_batches = -(-data.shape[0] // b)
    with _env(**(env or {})):
        plan = SieveStreamer(obj, k, STREAM_EPS, ground=ground).plan(b)
        assert plan["tier"] == tier, plan
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = stream_select(obj, Stream(data, order, b), k,
                            eps=STREAM_EPS, ground=ground)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    tag = {"uint32": "[coverage]", "int8": "[int8]"}.get(plan["dtype"], "")
    assert launches.get("stream_filter" + tag) == n_batches, (
        launches, n_batches)
    assert launches.get("scatter_slots") == n_batches, launches
    ids = sol.ids[sol.valid].cpu().numpy()
    assert 0 < len(ids) <= k and len(set(ids.tolist())) == len(ids)
    assert torch.equal(sol.payloads[sol.valid], data[sol.ids[sol.valid]]), \
        "a selected slot's payload is not its arrival's"
    return sol, ids, {"n": int(data.shape[0]), "batch": b,
                      "batches": n_batches, "k": k, "eps": STREAM_EPS,
                      "plan": plan, "wall_seconds": wall,
                      "arrivals_per_second": data.shape[0] / wall,
                      "launches": launches, "accepted": len(ids),
                      "best_level_value": float(sol.value),
                      "digest": _digest(ids, sol.value)}


def phase_stream_kmedoid(torch, x, cfg, ground, root_ids, dtype="float32",
                         f32_ratio=None):
    """stream_select('kmedoid') over all 100,000 images, shuffled with the
    seed: k = 200, ε = 0.1 (L = 72), B = 256 (391 batches, one
    stream_filter and one scatter_slots launch each). f32 evaluates
    against the whole stream (`ground` is x itself, the reference
    launcher's choice): a level's 400 KB row over a cluster of 8 blocks'
    shared memory. With dtype 'int8' the rung is forced against the
    16,384-image evaluation set (`ground`), 8 blocks a level:
    stream_filter[int8] launches. The stream's ids and the `run` tree
    root's ids scored on the evaluation set (replay_value: the
    objective's own value on that set); the stream must reach (½ − ε)
    of the root's value, which is at most OPT there. The int8 run
    reports its ratio to the root beside `f32_ratio`, the f32 stream's
    on its own set."""
    int8 = dtype == "int8"
    _, ids, rep = _stream_run(torch, "kmedoid", x, cfg, cfg.k,
                              ground=ground,
                              env=_rung_env(dtype) if int8 else None)
    t0 = time.perf_counter()
    gv = _value_on(torch, ground, x, ids)
    root_gv = _value_on(torch, ground, x, root_ids)
    assert gv >= (0.5 - STREAM_EPS) * root_gv, (gv, root_gv)
    emit({"phase": "stream_kmedoid" + ("_int8" if int8 else ""),
          "eval_set": int(ground.shape[0]),
          "eval_set_is_the_stream": ground is x,
          "d": int(x.shape[1]), **rep, "global_value_eval": gv,
          "root_global_value_eval": root_gv,
          "ratio_to_root": gv / root_gv,
          **({} if f32_ratio is None else {
              "f32_ratio_to_root_whole_stream": f32_ratio}),
          "global_value_seconds": time.perf_counter() - t0})
    return rep["launches"], gv / root_gv


def _value_on(torch, ground, x, ids) -> float:
    """The k-medoid value of the exemplars x[ids] scored on the
    evaluation set `ground` (the objective's f32 value, replay_value:
    every exemplar folded into the empty solution's rows in one pass)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import replay_value
    obj = make_objective("kmedoid", device=ground.device)
    ex = x[torch.as_tensor(np.asarray(ids), device=x.device)][None]
    val = replay_value(obj, ex, torch.ones(ex.shape[:2], dtype=torch.bool,
                                           device=x.device),
                       ground[None], torch.ones(1, ground.shape[0],
                                                dtype=torch.bool,
                                                device=x.device))
    return float(val[0])


def phase_stochastic_int8(torch, x, cfg, pools):
    """The stochastic lanes (sample_leaf 72) under the forced int8 rung:
    the leaves on the step engine read their ground int8, quantized once
    per greedy (k gains[int8] launches, no f32 gains), the nodes on the
    resident loop's int8 rounding (+ the replay pairwise)."""
    sample = sample_size(pools[1].shape[1], cfg.k)

    def expect(stage, engine):
        if stage == 0:
            assert engine == "step", engine
            return {"gains[int8]": cfg.k, "gains_norms": 1}
        assert engine == "mega_resident", (stage, engine)
        return {"greedy_loop_resident[int8]": 1, "pairwise": 1}

    t0 = time.perf_counter()
    with _env(**_rung_env("int8")):
        stages, totals, sols = _run_dispatcher(
            torch, x, cfg, pools, expect, sample_leaf=sample, seed=cfg.seed)
    wall = time.perf_counter() - t0
    _, root = _report_root(torch, x, sols, cfg.k)
    emit({"phase": "stochastic_int8", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "sample_leaf": sample, "stages": stages, "wall_seconds": wall,
          **root})
    return _variant_launches(totals)


def _b6_bound(n, b, d, levels, decisions, admitted, itemsize=4.0):
    """(bound_ms, bound_by) of one feature stream-filter batch: the slab's
    2·N·B·D products (+ the norms) and this batch's live decisions'
    gain parts and folds (3 and 1 operations an entry); the ground
    (itemsize bytes an entry), the arrivals, the rows in and out."""
    flops = (2.0 * n * b * d + 4.0 * (n + b) * d + 3.0 * n * b
             + 3.0 * decisions * n + admitted * n)
    nbytes = itemsize * n * d + 4.0 * (b * d + 2 * levels * n + b)
    return bound(flops, nbytes)


def _feature_split(torch, run, slab, reps) -> dict:
    """A feature stream-filter batch's time split: the slab launch timed
    alone (CUDA events; with the arrivals' norm pass) and the device time
    of each of the batch's kernels (torch.profiler), with the CUDA
    launches a batch."""
    return {"slab_ms": cuda_ms(torch, slab, reps), **_kernel_split(torch, run)}


def phase_timing_stream(torch, x, cfg, pools, stream_inputs, reps,
                        global_inputs):
    """B6 f32 and int8 per batch at the 16,384-row evaluation set (a
    fourth batch against the state three batches in, so the window and
    the levels are live), the slot update that follows it (scatter_slots
    into the (1, 72, 200, 12,288) slots three batches in), and B2q at the
    stochastic leaf shape; then B6 f32 at the whole-stream shape (100,000
    evaluation rows) and on bitmaps at 8,192 words, from
    parity_stream_global's states. Each beside its bound (the work this
    batch's data needs: its live decisions, its admitted rows, counted
    along the plain version's path), its plain version and nothing a
    single library call computes; the feature rows with their slab /
    decision split, launches a batch and the device-memory tier's time.
    The ground's norms are computed once, as the streamer does."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    ground, st, (sids, pay, valid, _), slots = stream_inputs
    rule = R.DIST_MIN
    k, eps_log = cfg.k, math.log1p(STREAM_EPS)
    n, d = ground.shape
    levels, b = st[0].shape[1], pay.shape[0]
    arr, bv = pay[None], valid[None]
    plain = TS.stream_filter_plain(ground, arr, *st[:6], bv, k, eps_log,
                                   rule)
    mat_k = torch.empty(1, b, n, device=x.device)
    got = TS.stream_filter(ground, arr, *st[:6], bv, k, eps_log, rule,
                           scratch=mat_k)
    cmp = parity.compare_stream(got, plain, mat_k,
                                TRef.pairwise(ground, arr, rule),
                                st[:6] + (None,), bv, k, eps_log, rule)
    q, scale = ops.quantize_ground(ground)
    gscale = scale.reshape(-1).contiguous()
    out = {}
    f32_gnorm = TS.ground_norms(ground)
    for tag, g, kw, item in (
            ("", ground, {"gnorm": f32_gnorm}, 4.0),
            ("[int8]", q, {"gscale": gscale,
                           "gnorm": TS.ground_norms(q, gscale)}, 1.0)):
        bms, by = _b6_bound(n, b, d, levels, cmp["decisions"],
                            cmp["admitted"], item)

        def run(g=g, kw=kw):
            return TS.stream_filter(g, arr, *st[:6], bv, k, eps_log, rule,
                                    **kw)

        def slab(g=g, kw=kw):
            return TS.stream_slab(g, arr, st[1], rule, **kw)

        out["stream_filter" + tag] = {
            "shape": [1, levels, n, b, d], "decisions": cmp["decisions"],
            "admitted": cmp["admitted"],
            "ms": cuda_ms(torch, run, reps),
            "plain_ms": cuda_ms(
                torch, lambda g=g, kw=kw: TS.stream_filter_plain(
                    g, arr, *st[:6], bv, k, eps_log, rule,
                    gscale=kw.get("gscale")), 1),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            **_feature_split(torch, run, slab, reps)}
    f32 = out["stream_filter"]
    # the slab, the singletons and the window alone: the same call with
    # every arrival invalid, so no level makes a decision
    none = torch.zeros_like(bv)
    f32["no_live_decision_ms"] = cuda_ms(
        torch, lambda: TS.stream_filter(ground, arr, *st[:6], none, k,
                                        eps_log, rule, gnorm=f32_gnorm),
        reps)
    with _device_memory_tier():
        f32["device_memory_tier_ms"] = cuda_ms(
            torch, lambda: TS.stream_filter(ground, arr, *st[:6], bv, k,
                                            eps_log, rule, gnorm=f32_gnorm),
            reps)
    del q, scale, gscale
    # the slot update after this batch (repeated in place: the same rows
    # land in the same slots): the admitted rows read once an arrival
    # and written once a slot, expired levels' slots cleared
    sargs = (st[3], plain[6], plain[3], sids[None], arr, k)
    admitted = int(plain[3].sum())
    arrivals = int(plain[3].any(1).sum())
    expired = int(plain[6].sum())
    row_bytes = 4.0 * d + 8.0
    bms, by = bound(0.0, row_bytes * (arrivals + admitted + expired * k)
                    + levels * (b + 5.0))
    out["scatter_slots"] = {
        "shape": [1, levels, k, d], "admitted": admitted,
        "expired_levels": expired,
        "ms": cuda_ms(torch, lambda: TS.scatter_slots(*slots, *sargs), reps),
        "plain_ms": cuda_ms(torch, lambda: TS.scatter_slots_plain(
            *slots, *sargs), 3),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del slots
    _, lpay, lvalid = pools
    lanes, nl, _ = lpay.shape
    gq, gs = ops.quantize_ground(lpay)
    row = R.empty_row(lpay, lvalid, rule).contiguous()
    c = sample_size(nl, k)
    idx = LaneSampler(cfg.seed)(0, lanes, 1, nl, c)[:, 0].to(x.device)
    cands = torch.gather(lpay, 1, idx[..., None].expand(lanes, c, d))
    cands = cands.contiguous()
    cv = torch.ones(lanes, c, dtype=torch.bool, device=x.device)
    gnorm, f32_gnorm = P.ground_norms(gq, gs), P.ground_norms(lpay)
    # as the f32 row: the ground's norms are the greedy's (norms_ms)
    flops = (2.0 * lanes * nl * c * d + 2.0 * lanes * c * d
             + 5.0 * lanes * nl * c)
    nbytes = (lanes * nl * d + 4.0 * (lanes * nl + lanes * c * d
                                      + 2 * lanes * nl + lanes * c))
    bms, by = bound(flops, nbytes)
    out["gains[int8]"] = {
        "shape": [lanes, nl, c, d],
        "ms": cuda_ms(torch, lambda: P.gains(gq, row, cands, cv, rule,
                                             gscale=gs, gnorm=gnorm), reps),
        "norms_ms": cuda_ms(torch, lambda: P.ground_norms(gq, gs), reps),
        "f32_kernel_ms": cuda_ms(torch, lambda: P.gains(
            lpay, row, cands, cv, rule, gnorm=f32_gnorm), reps),
        "plain_ms": cuda_ms(torch, lambda: P.gains_plain(
            gq, row, cands, cv, rule, gs), reps),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del gq, gs, gnorm, f32_gnorm, row, cands
    out.update(_timing_stream_global(torch, x, cfg, global_inputs, reps))
    emit({"phase": "timing_stream", **out})
    return out


def _bits_row(torch, arr, st, bv, k, eps_log, levels, w, b, admitted, reps):
    """A bitmap stream-filter batch's timing row: ms on the planned tier
    and on the device-memory tier (forced), the singleton pass and the
    window alone (every arrival invalid), the kernels' split and
    launches a batch, beside the bytes bound and the plain version."""
    from repro_torch.kernels import plans
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS

    def run(valid=bv):
        return TS.stream_filter(None, arr, *st, valid, k, eps_log, R.BITS_OR)

    nbytes = 4.0 * (b * w + 2 * levels * w + 2 * levels) + levels * b + b
    row = {"tier": plans.stream_tier(w, b, R.BITS_OR),
           "shape": [1, levels, w, b], "admitted": admitted,
           "ms": cuda_ms(torch, run, 20 * reps),
           "plain_ms": cuda_ms(torch, lambda: TS.stream_filter_plain(
               None, arr, *st, bv, k, eps_log, R.BITS_OR), 1),
           "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
           "bound_by": "bytes",
           "no_live_decision_ms": cuda_ms(
               torch, lambda: run(torch.zeros_like(bv)), 20 * reps)}
    with _device_memory_tier():
        row["device_memory_tier_ms"] = cuda_ms(torch, run, 20 * reps)
    row.update(_kernel_split(torch, run))
    return row


def _timing_stream_global(torch, x, cfg, global_inputs, reps):
    """timing_stream's rows beyond one block's shared memory: B6 f32 per
    batch against all n evaluation rows (a level's row over a cluster of
    8; and with every arrival invalid: the slab, singletons and window
    alone), and on bitmaps at 8,192 words."""
    from repro_torch.kernels import parity, plans
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    (st, (_, pay, valid, _), gnorm), (bst, barr, k_bits) = global_inputs
    rule, k, eps_log = R.DIST_MIN, cfg.k, math.log1p(STREAM_EPS)
    n, d = x.shape
    levels, b = st[0].shape[1], pay.shape[0]
    arr, bv = pay[None], valid[None]
    plain = TS.stream_filter_plain(x, arr, *st[:6], bv, k, eps_log, rule)
    mat_k = torch.empty(1, b, n, device=x.device)
    got = TS.stream_filter(x, arr, *st[:6], bv, k, eps_log, rule,
                           scratch=mat_k, gnorm=gnorm)
    cmp = parity.compare_stream(got, plain, mat_k,
                                TRef.pairwise(x, arr, rule),
                                st[:6] + (None,), bv, k, eps_log, rule,
                                what="stream_filter, 100,000 rows")
    del got, plain, mat_k
    bms, by = _b6_bound(n, b, d, levels, cmp["decisions"], cmp["admitted"])

    def run(valid=bv):
        return TS.stream_filter(x, arr, *st[:6], valid, k, eps_log, rule,
                                gnorm=gnorm)

    out = {"stream_filter_100000": {
        "tier": plans.stream_tier(n, b, rule),
        "shape": [1, levels, n, b, d],
        "decisions": cmp["decisions"], "admitted": cmp["admitted"],
        "ms": cuda_ms(torch, run, reps),
        "no_live_decision_ms": cuda_ms(
            torch, lambda: run(torch.zeros_like(bv)), reps),
        "plain_ms": cuda_ms(torch, lambda: TS.stream_filter_plain(
            x, arr, *st[:6], bv, k, eps_log, rule), 1),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        **_feature_split(torch, run, lambda: TS.stream_slab(
            x, arr, st[1], rule, gnorm=gnorm), reps)}}
    with _device_memory_tier():
        out["stream_filter_100000"]["device_memory_tier_ms"] = cuda_ms(
            torch, run, reps)
    blevels, w = bst[0].shape[1], barr.shape[2]
    ball = torch.ones(1, b, dtype=torch.bool, device=x.device)
    bplain = TS.stream_filter_plain(None, barr, *bst, ball, k_bits, eps_log,
                                    R.BITS_OR)
    out["stream_filter[coverage]_8192"] = _bits_row(
        torch, barr, bst, ball, k_bits, eps_log, blevels, w, b,
        int(bplain[3].sum()), reps)
    return out


def phase_parity_stream_coverage(torch, words, cfg):
    """B6 on bitmaps at the kcover stream's shape (L = 56 levels, W =
    1,290 words, B = 256), three chained batches of shuffled sets, with
    and without knapsack costs (budget 40), then the window's 5 stacked
    checkpoints (one batch for all) and the continuous mode's 4 lanes
    (64 arrivals each): every output equal bit for bit to the plain
    version, and the slot update (scatter_slots) equal to the
    reference's one-hot formula. Returns the largest |kernel − plain|
    (0 when every bit agrees)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    levels = num_levels(k, STREAM_EPS)
    eps_log = math.log1p(STREAM_EPS)
    w = words.shape[1]
    row0 = torch.zeros(w, dtype=R.WORD_DTYPE, device=words.device)
    costs = torch.as_tensor(knapsack_costs(cfg.n, cfg.seed),
                            device=words.device)
    batches = _stream_batches(torch, words, 3, b, cfg.seed + 1, costs)
    out, err = {}, 0.0
    for case, lanes, split in (("single", 1, 1), ("knapsack", 1, 1),
                               ("window", 1 + WINDOW // STRIDE, 1),
                               ("continuous", CONTINUOUS_LANES,
                                CONTINUOUS_LANES)):
        cost = case == "knapsack"
        st = _stream_state(torch, R.BITS_OR, levels, row0, cost, lanes)
        ids0 = torch.full((lanes, levels, k), -1, dtype=torch.int64,
                          device=words.device)
        pay0 = torch.zeros(lanes, levels, k, w, dtype=R.WORD_DTYPE,
                           device=words.device)
        res = {"entries": 0, "differing": 0, "admitted": 0}
        for ids, pay, valid, c in batches:
            arr = pay.reshape(split, b // split, w)
            bv = valid.reshape(split, -1)
            kw = (dict(costs=c[None], spent=st[6], budget=BUDGET_KCOVER)
                  if cost else {})
            got = TS.stream_filter(None, arr, *st[:6], bv, k, eps_log,
                                   R.BITS_OR, **kw)
            plain = TS.stream_filter_plain(None, arr, *st[:6], bv, k,
                                           eps_log, R.BITS_OR, **kw)
            r = parity.compare_exact(got, plain,
                                     f"stream_filter[coverage] {case}")
            bids = ids.reshape(split, -1)
            want = TS.scatter_slots_plain(ids0, pay0, st[3], plain[6],
                                          plain[3], bids, arr, k)
            ids0, pay0 = TS.scatter_slots(ids0, pay0, st[3], plain[6],
                                          plain[3], bids, arr, k)
            parity.compare_exact((ids0, pay0), want, f"scatter_slots {case}")
            res["entries"] += r["entries"]
            res["differing"] += r["differing"]
            res["admitted"] += int(plain[3].sum())
            err = max(err, r["max_abs_err"])
            st = _next_state(plain, row0, cost)
        res["shape"] = [lanes, levels, w, b // split]
        out[case] = res
    emit({"phase": "parity_stream_coverage", "rule": "exact (bit for bit)",
          **out})
    return {"stream_filter[coverage]": err}


def phase_stream_kcover(torch, words, cfg, root_value):
    """stream_select('kcover') over all 990,002 sets shuffled with the
    config seed: k = 64, ε = 0.1 (L = 56), B = 256 (3,868 batches, one
    stream_filter[coverage] launch each); the value must reach (½ − ε)
    of kcover_run's root value (for coverage the root value is the
    global value)."""
    from repro_torch.core.simulate import global_value
    sol, ids, rep = _stream_run(torch, "kcover", words, cfg, cfg.k)
    gv = global_value("kcover", words, ids)
    assert gv == float(sol.value), (gv, float(sol.value))
    assert gv >= (0.5 - STREAM_EPS) * root_value, (gv, root_value)
    emit({"phase": "stream_kcover", "universe": cfg.universe,
          "words": int(words.shape[1]), **rep, "global_value": gv,
          "root_value": root_value, "ratio_to_root": gv / root_value})
    return rep["launches"], sol


def _kcover_stream(torch, words, cfg):
    from repro_torch.data.synthetic import Stream
    order = np.random.default_rng(cfg.seed).permutation(words.shape[0])
    return Stream(words, order, STREAM_BATCH), order


def phase_stream_kcover_knapsack(torch, words, cfg):
    """Knapsack streaming over the same stream: a SieveStreamer with
    budget 40 and the kcover_knapsack costs (uniform(0.5, 2) by global
    id) per arrival, one stream_filter[coverage] launch a batch in cost
    mode; spent ≤ 40 at every level."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.streaming import SieveStreamer
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    costs = torch.as_tensor(knapsack_costs(cfg.n, cfg.seed),
                            device=words.device)
    stream, _ = _kcover_stream(torch, words, cfg)
    streamer = SieveStreamer(obj, cfg.k, STREAM_EPS, budget=BUDGET_KCOVER)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = streamer.init()
    batches = 0
    for ids, pay, valid in stream:
        state = streamer.process_batch(state, ids, pay, valid,
                                       costs=costs[ids])
        batches += 1
    sol = streamer.solution(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert launches.get("stream_filter[coverage]") == batches, launches
    spent = state.spent.cpu().numpy()
    assert (spent <= BUDGET_KCOVER).all(), spent
    ids = sol.ids[sol.valid].cpu().numpy()
    sel_cost = float(costs[torch.as_tensor(ids, device=words.device)].sum())
    assert sel_cost <= BUDGET_KCOVER + 1e-4, sel_cost
    emit({"phase": "stream_kcover_knapsack", "budget": BUDGET_KCOVER,
          "batches": batches, "cost_mode_launches": batches,
          "wall_seconds": wall,
          "arrivals_per_second": cfg.n / wall, "launches": launches,
          "accepted": len(ids), "value": float(sol.value),
          "spent_best_level": sel_cost, "spent_max": float(spent.max()),
          "digest": _digest(ids, sol.value)})
    return launches


def phase_window_kcover(torch, words, cfg):
    """SlidingSieve over the kcover stream: window 262,144, stride 65,536
    (5 checkpoints, one stream_filter[coverage] launch a batch for all);
    at every stride boundary the query's ids all arrived within the last
    262,144 arrivals."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.streaming import SieveStreamer, SlidingSieve
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    stream, order = _kcover_stream(torch, words, cfg)
    pos = np.empty(cfg.n, np.int64)
    pos[order] = np.arange(cfg.n)
    win = SlidingSieve(SieveStreamer(obj, cfg.k, STREAM_EPS), WINDOW, STRIDE)
    last = None
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws = win.init()
    batches, queries, values = 0, 0, []
    for ids, pay, valid in stream:
        ws = win.process_batch(ws, ids, pay, valid)
        batches += 1
        if ws.seen % STRIDE == 0 or ws.seen >= cfg.n:
            sol = win.query(ws)
            got = sol.ids[sol.valid].cpu().numpy()
            assert (pos[got] >= min(ws.seen, cfg.n) - WINDOW).all(), (
                ws.seen, pos[got].min())
            queries += 1
            values.append(float(sol.value))
            last = _digest(got, sol.value)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert launches.get("stream_filter[coverage]") == batches, launches
    emit({"phase": "window_kcover", "window": WINDOW, "stride": STRIDE,
          "checkpoints": win.n_ckpt, "batches": batches,
          "queries_checked": queries, "wall_seconds": wall,
          "arrivals_per_second": cfg.n / wall, "launches": launches,
          "query_values": values, "digest": last})
    return launches


def phase_continuous_kcover(torch, words, cfg):
    """stream_select_continuous over the kcover stream: 4 lanes, b = 2, a
    merge every 256 batches (15 merges + the tail's), one
    stream_filter[coverage] launch a batch for all lanes, the merge
    nodes on the resident bitmap loop; the merged values never
    decrease. Then the same stream again under torch.profiler: its
    device time, and that over the untraced wall (the busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.streaming import stream_select_continuous
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    stream, _ = _kcover_stream(torch, words, cfg)

    def run():
        return stream_select_continuous(
            obj, stream, cfg.k, lanes=CONTINUOUS_LANES, branching=2,
            merge_every=MERGE_EVERY, eps=STREAM_EPS)

    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, info = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert launches.get("stream_filter[coverage]") == info["batches"]
    assert launches.get("greedy_loop_resident[coverage]", 0) >= len(
        info["merges"]), launches
    merges = info["merges"]
    assert all(b >= a for a, b in zip(merges, merges[1:])), merges
    assert info["tier"] == "kernel", info
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_ms = sum(us for _, _, us in _cuda_events(torch, prof)) / 1e3
    seen = device_ms > 0
    digest = _digest(sol.ids[sol.valid].cpu().numpy(), sol.value)
    emit({"phase": "continuous_kcover", "lanes": CONTINUOUS_LANES,
          "branching": 2, "merge_every": MERGE_EVERY, **info,
          "wall_seconds": wall, "arrivals_per_second": cfg.n / wall,
          "device_ms": device_ms if seen else "not measured",
          "busy_share": device_ms / (wall * 1e3) if seen else
          "not measured",
          "launches": launches, "value": float(sol.value),
          "digest": digest})
    return launches, {"merges": merges, "batches": info["batches"],
                      "digest": digest}


def phase_timing_stream_coverage(torch, words, cfg, reps):
    """B6 on bitmaps per batch at the kcover stream's shape, from the
    state three batches in, beside its bound — the bytes it must move
    (the arrivals' words, the rows in and out) and its integer
    operations (a popcount pass a live arrival and admission), far below
    the card's integer rate — and its plain version; its admitted count,
    its kernels' split, and the device-memory tier's time (forced)."""
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    levels = num_levels(k, STREAM_EPS)
    eps_log = math.log1p(STREAM_EPS)
    w = words.shape[1]
    row0 = torch.zeros(w, dtype=R.WORD_DTYPE, device=words.device)
    batches = _stream_batches(torch, words, 4, b, cfg.seed + 2)
    st = _stream_state(torch, R.BITS_OR, levels, row0, False)
    for _, pay, valid, _ in batches[:3]:
        st = _next_state(TS.stream_filter(None, pay[None], *st, valid[None],
                                          k, eps_log, R.BITS_OR), row0,
                         False)
    _, pay, valid, _ = batches[3]
    arr, bv = pay[None], valid[None]
    plain = TS.stream_filter_plain(None, arr, *st, bv, k, eps_log, R.BITS_OR)
    out = {"stream_filter[coverage]": _bits_row(
        torch, arr, st, bv, k, eps_log, levels, w, b, int(plain[3].sum()),
        reps)}
    emit({"phase": "timing_stream_coverage", **out})
    return out


def phase_stream_idle(torch, name, data, cfg, k, ground=None,
                      warm: int = 5, batches: int = 20):
    """The device's busy share in stream_select's loop: after `warm`
    batches, `batches` batches traced with torch.profiler (the device
    time of every kernel), then the next `batches` untraced on the host
    clock (ending in a synchronize; the trace's own host cost left out):
    the busy share is the traced device time a batch over the untraced
    wall a batch, the rest the host's gap."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.streaming import SieveStreamer
    obj = make_objective(name, universe=cfg.universe, device=data.device)
    order = np.random.default_rng(cfg.seed).permutation(data.shape[0])
    it = iter(Stream(data, order, STREAM_BATCH))
    streamer = SieveStreamer(obj, k, STREAM_EPS, ground=ground)
    state = None
    for _ in range(warm):
        ids, pay, valid = next(it)
        if state is None:
            state = streamer.init(pay)
        state = streamer.process_batch(state, ids, pay, valid)
    traced = [next(it) for _ in range(batches)]
    timed = [next(it) for _ in range(batches)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ids, pay, valid in traced:
            state = streamer.process_batch(state, ids, pay, valid)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, pay, valid in timed:
        state = streamer.process_batch(state, ids, pay, valid)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / batches
    busy, kernels = 0.0, {}
    for kernel, count, us in _cuda_events(torch, prof):
        busy += us / 1e3 / batches
        kernels[kernel[:48]] = {"launches_per_batch": count / batches,
                                "ms_per_batch": us / 1e3 / batches}
    seen = bool(kernels) and busy > 0
    emit({"phase": "stream_idle", "stream": name, "batches": batches,
          "wall_ms_per_batch": wall,
          "device_busy_ms_per_batch": busy if seen else "not measured",
          "busy_share": busy / wall if seen else "not measured",
          "host_gap_ms_per_batch": wall - busy if seen else "not measured",
          "kernel_split": kernels})


# ---------------------------------------------------------------------------
# distributed GreedyML: one rank a tree machine (torch.distributed)
# ---------------------------------------------------------------------------
#
# The card is one H100 and NCCL takes no two ranks on one device, so the
# multi-rank trees run over gloo with every rank on the same card: each
# rank runs its lane's kernels on the card and its collectives stage the
# k-row solutions through the host. NCCL runs at world size 1, in this
# process. The ranks are spawned processes (launch/spawn.py): the
# kernels' libraries are loaded here first, so they find them built; the
# bitmaps and embeddings reach them through CUDA IPC (no copy). A rank
# that fails, or is still running at its deadline, fails the phase.

DIST_DEADLINE = 420.0
DIST_STREAM_LANES = 4


def _rank_device(torch, dev: str):
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    return torch.device(dev)


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def lane_block(torch, x, lanes: int, seed: int, lane: int):
    """Lane `lane`'s (ids, payloads, valid) of lane_pools(x, lanes, seed),
    gathering only its own rows."""
    n = x.shape[0]
    n_pad = -(-n // lanes) * lanes
    perm = np.full(n_pad, -1, np.int64)
    perm[:n] = np.random.default_rng(seed).permutation(n)
    per = n_pad // lanes
    mine = torch.as_tensor(perm[lane * per:(lane + 1) * per],
                           device=x.device)
    pay = x[mine.clamp(min=0)]
    pay[mine < 0] = 0
    return mine, pay, mine >= 0


def _stage_hook(torch, dev, stages):
    """on_level callback of the distributed drivers: a stage's wall (the
    rank's device synchronised) and its launches."""
    from repro_torch.kernels import counters
    _sync(torch, dev)
    t_last = [time.perf_counter()]

    def on_level(stage):
        _sync(torch, dev)
        now = time.perf_counter()
        stages.append({"stage": stage, "seconds": now - t_last[0],
                       "launches": {n: c["launches"] for n, c in
                                    counters.snapshot().items()
                                    if c["launches"]}})
        counters.reset()
        t_last[0] = time.perf_counter()
    return on_level


def _dist_tree_rank(rank, x, name, k, universe, seed, radices, dev):
    """One rank of distributed_kdom: its lane of lane_pools(x, m, seed)
    through greedyml_distributed over `radices`, then
    randgreedi_distributed; per stage its wall and launches, per level
    the gathers' bytes and seconds."""
    import torch
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import (greedyml_distributed,
                                           randgreedi_distributed)
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_tree_mesh
    dev = _rank_device(torch, dev)
    mesh = make_tree_mesh(radices, device=dev)
    obj = make_objective(name, universe=universe, device=dev)
    ids, pay, val = lane_block(torch, x, mesh.lanes, seed, rank)
    out = {}
    for algo, fn in (("greedyml", greedyml_distributed),
                     ("randgreedi", randgreedi_distributed)):
        stages = []
        mesh.log = []
        counters.reset()
        hook = _stage_hook(torch, dev, stages)
        t0 = time.perf_counter()
        sol = fn(obj, ids, pay, val, k, mesh, on_level=hook)
        _sync(torch, dev)
        out[algo] = {"ids": sol.ids.cpu(), "valid": sol.valid.cpu(),
                     "value": float(sol.value),
                     "wall_seconds": time.perf_counter() - t0,
                     "stages": stages, "collectives": mesh.log}
        mesh.log = None
    return out


def _stacked_root(torch, name, pools, k, universe, radices):
    """The same lanes stacked on one device, LevelDispatcher(mesh=None)
    over `pools` (ids, payloads, valid) → (root, wall seconds)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import LevelDispatcher, root_solution
    dev = pools[1].device
    obj = make_objective(name, universe=universe, device=dev)
    disp = LevelDispatcher(obj, k, radices)
    _sync(torch, dev)
    t0 = time.perf_counter()
    sols = disp.leaves(*pools)
    for lvl in range(disp.num_levels):
        sols = disp.level(sols, lvl)
    root = root_solution(sols)
    _sync(torch, dev)
    return root, time.perf_counter() - t0


def _levels_of(collectives) -> list:
    """Per level: the gathers' bytes and seconds (three a level: ids,
    payloads, valid); the root's broadcasts last."""
    by = {}
    for c in collectives:
        key = "broadcast" if c["level"] is None else c["level"]
        d = by.setdefault(key, {"level": key, "bytes": 0, "seconds": 0.0,
                                "calls": 0})
        d["bytes"] += c["bytes"]
        d["seconds"] += c["seconds"]
        d["calls"] += 1
    return list(by.values())


def _rank_summary(results, algo) -> dict:
    """Per rank: wall, each stage's wall and launches, each level's
    collectives."""
    return {str(r): {"wall_seconds": res[algo]["wall_seconds"],
                     "stages": res[algo]["stages"],
                     "collectives": _levels_of(res[algo]["collectives"])}
            for r, res in enumerate(results)}


def _same_root(results, algo, root) -> None:
    want = root.ids.cpu()
    for r, res in enumerate(results):
        got = res[algo]
        assert got["ids"].equal(want), (algo, r, got["ids"], want)
        assert got["valid"].equal(root.valid.cpu()), (algo, r)
        assert got["value"] == float(root.value), (algo, r, got["value"],
                                                   float(root.value))


def phase_distributed_kdom(torch, words, cfg, dev: str = "cuda:0",
                           deadline: float = DIST_DEADLINE):
    """The kdom tree over 8 spawned gloo ranks on the one card, one lane
    a rank (its lane_pools block): greedyml_distributed over (2, 2, 2)
    and randgreedi_distributed over all 8, each root on every rank equal
    bit for bit (ids, valid, value) to LevelDispatcher(mesh=None) over
    the same pools stacked, radices (2, 2, 2) and (8,); per rank per
    stage 1 greedy_loop[coverage] at the leaves and 1
    greedy_loop_resident[coverage] a level."""
    from repro_torch.launch.spawn import run_ranks
    m, b = cfg.num_machines, cfg.branching
    radices = (b,) * int(round(math.log(m, b)))
    _sync(torch, words.device)
    t0 = time.perf_counter()
    results = run_ranks(_dist_tree_rank, m, args=(
        words, cfg.objective, cfg.k, cfg.universe, cfg.seed, radices, dev),
        timeout=deadline)
    spawn_wall = time.perf_counter() - t0
    pools = lane_pools(torch, words, m, cfg.seed)
    want, want_wall = _stacked_root(torch, cfg.objective, pools, cfg.k,
                                    cfg.universe, radices)
    _same_root(results, "greedyml", want)
    want_rg, rg_wall = _stacked_root(torch, cfg.objective, pools, cfg.k,
                                     cfg.universe, (m,))
    _same_root(results, "randgreedi", want_rg)
    del pools
    # one loop launch a stage: the planner's engine for one lane
    from repro_torch.kernels.plans import select_engine
    from repro_torch.kernels.rules import BITS_OR
    w = int(words.shape[1])
    engines = [select_engine(BITS_OR, w, cfg.n // m, replicas=1).engine] + [
        select_engine(BITS_OR, w, r * cfg.k, replicas=1).engine
        for r in radices]
    kernel = {"mega_stream": "greedy_loop[coverage]",
              "mega_resident": "greedy_loop_resident[coverage]"}
    launches = {}
    for res in results:
        st = res["greedyml"]["stages"]
        for s, e in zip(st, engines):
            assert s["launches"] == {kernel[e]: 1}, (s, e)
        for algo in ("greedyml", "randgreedi"):
            for s in res[algo]["stages"]:
                _add(launches, s["launches"])
    emit({"phase": "distributed_kdom", "backend": "gloo",
          "ranks": m, "device": "every rank on the one card; collectives "
          "stage the k-row solutions through the host",
          "radices": list(radices), "n": cfg.n, "k": cfg.k,
          "words": w, "stage_engines": engines,
          "root_equal_to_stacked": True, "value": float(want.value),
          "randgreedi_value": float(want_rg.value),
          "digest": _digest(want.ids[want.valid].cpu().numpy(), want.value),
          "spawn_wall_seconds": spawn_wall,
          "stacked_wall_seconds": {"greedyml": want_wall,
                                   "randgreedi": rg_wall},
          "ranks_greedyml": _rank_summary(results, "greedyml"),
          "ranks_randgreedi": _rank_summary(results, "randgreedi"),
          "launches": launches})
    return launches


def phase_distributed_nccl(torch, words, cfg):
    """World size 1 over NCCL in this process (a HashStore rendezvous):
    greedyml_distributed over radices (1,) on all the kdom bitmaps, its
    root equal bit for bit to LevelDispatcher(mesh=None, radices=(1,))."""
    import torch.distributed as dist
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import greedyml_distributed
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_tree_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = make_tree_mesh((1,))
        assert mesh.backend == "nccl" and not mesh.stage_on_host
        obj = make_objective(cfg.objective, universe=cfg.universe,
                             device=mesh.device)
        n = words.shape[0]
        ids = torch.arange(n, device=words.device)
        valid = torch.ones(n, dtype=torch.bool, device=words.device)
        stages = []
        mesh.log = []
        counters.reset()
        hook = _stage_hook(torch, words.device, stages)
        t0 = time.perf_counter()
        sol = greedyml_distributed(obj, ids, words, valid, cfg.k, mesh,
                                   on_level=hook)
        _sync(torch, words.device)
        wall = time.perf_counter() - t0
        collectives = _levels_of(mesh.log)
    finally:
        dist.destroy_process_group()
    want, want_wall = _stacked_root(
        torch, cfg.objective, (ids[None], words[None], valid[None]), cfg.k,
        cfg.universe, (1,))
    assert torch.equal(sol.ids, want.ids) and torch.equal(sol.valid,
                                                          want.valid)
    assert float(sol.value) == float(want.value), (float(sol.value),
                                                   float(want.value))
    launches = {}
    for s in stages:
        _add(launches, s["launches"])
    emit({"phase": "distributed_nccl", "backend": "nccl", "ranks": 1,
          "radices": [1], "n": int(n), "k": cfg.k,
          "root_equal_to_stacked": True, "value": float(sol.value),
          "wall_seconds": wall, "stacked_wall_seconds": want_wall,
          "stages": stages, "collectives": collectives,
          "launches": launches})
    return launches


def _dist_stream_rank(rank, words, universe, k, seed, batch, merge_every,
                      eps, dev):
    """One rank of distributed_stream_kcover: its share of every batch of
    the kosarak stream (the continuous phase's order), merged over the
    ranks every `merge_every` batches."""
    import torch
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_tree_mesh
    from repro_torch.streaming import stream_select_distributed
    dev = _rank_device(torch, dev)
    mesh = make_tree_mesh((2,) * int(round(math.log2(
        torch.distributed.get_world_size()))), device=dev)
    obj = make_objective("kcover", universe=universe, device=dev)
    order = np.random.default_rng(seed).permutation(words.shape[0])
    stream = Stream(words, order, batch)
    mesh.log = []
    counters.reset()
    _sync(torch, dev)
    t0 = time.perf_counter()
    sol, info = stream_select_distributed(obj, stream, k, mesh,
                                          merge_every=merge_every, eps=eps)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    return {"info": info, "wall_seconds": wall,
            "digest": _digest(sol.ids[sol.valid].cpu().numpy(), sol.value),
            "launches": {n: c["launches"] for n, c in
                         counters.snapshot().items() if c["launches"]},
            "collectives": _levels_of(mesh.log)}


def phase_distributed_stream_kcover(torch, words, cfg, continuous,
                                    dev: str = "cuda:0",
                                    deadline: float = DIST_DEADLINE):
    """stream_select_distributed over 4 spawned gloo ranks on the one
    card (b = 2, two levels), the kosarak stream of continuous_kcover (B =
    256, ε = 0.1, a merge every 256 batches): its merges and its digest
    equal continuous_kcover's; each rank launches
    stream_filter[coverage] once a batch."""
    from repro_torch.launch.spawn import run_ranks
    lanes = DIST_STREAM_LANES
    t0 = time.perf_counter()
    results = run_ranks(_dist_stream_rank, lanes, args=(
        words, cfg.universe, cfg.k, cfg.seed, STREAM_BATCH, MERGE_EVERY,
        STREAM_EPS, dev), timeout=deadline)
    spawn_wall = time.perf_counter() - t0
    launches = {}
    for r, res in enumerate(results):
        assert res["info"]["merges"] == continuous["merges"], (
            r, res["info"]["merges"], continuous["merges"])
        assert res["info"]["batches"] == continuous["batches"]
        assert res["digest"] == continuous["digest"], (r, res["digest"])
        assert res["launches"].get("stream_filter[coverage]") == \
            res["info"]["batches"], (r, res["launches"])
        _add(launches, res["launches"])
    emit({"phase": "distributed_stream_kcover", "backend": "gloo",
          "ranks": lanes, "device": "every rank on the one card; merges "
          "stage the k-row summaries through the host",
          "branching": 2, "merge_every": MERGE_EVERY, "batch": STREAM_BATCH,
          "batches": results[0]["info"]["batches"],
          "merges": results[0]["info"]["merges"],
          "digest": results[0]["digest"],
          "equal_to_continuous": True, "spawn_wall_seconds": spawn_wall,
          "ranks_detail": {str(r): {"wall_seconds": res["wall_seconds"],
                                    "launches": res["launches"],
                                    "collectives": res["collectives"]}
                           for r, res in enumerate(results)},
          "launches": launches})
    return launches


CORESET_N, CORESET_D, CORESET_K = 65_536, 256, 128


def _coreset_rank(rank, emb, k, radices, dev):
    """One rank of the coreset phase: select_coreset over its block."""
    import torch
    from repro_torch.data.selection import select_coreset
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import local_block, make_tree_mesh
    dev = _rank_device(torch, dev)
    mesh = make_tree_mesh(radices, device=dev)
    counters.reset()
    _sync(torch, dev)
    t0 = time.perf_counter()
    ids = select_coreset(local_block(emb, mesh), k, "greedyml:facility",
                         mesh=mesh)
    _sync(torch, dev)
    return {"ids": ids, "wall_seconds": time.perf_counter() - t0,
            "launches": {n: c["launches"] for n, c in
                         counters.snapshot().items() if c["launches"]}}


def phase_coreset(torch, cfg, dev: str = "cuda:0", n: int = CORESET_N,
                  d: int = CORESET_D, k: int = CORESET_K,
                  deadline: float = DIST_DEADLINE):
    """select_coreset('greedyml:facility') on gen_embeddings(65,536, 256)
    with k = 128 through the 8-rank gloo group (each rank passes its
    contiguous block), every rank's ids equal to the stacked
    LevelDispatcher(mesh=None) over the same blocks."""
    from repro_torch.data.synthetic import gen_embeddings
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.core.greedyml import shard_lanes
    m, b = cfg.num_machines, cfg.branching
    radices = (b,) * int(round(math.log(m, b)))
    t0 = time.perf_counter()
    emb = torch.as_tensor(gen_embeddings(n, d, seed=cfg.seed)).to(dev)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = run_ranks(_coreset_rank, m, args=(emb, k, radices, dev),
                        timeout=deadline)
    spawn_wall = time.perf_counter() - t0
    pools = shard_lanes(torch.arange(n, device=emb.device), emb,
                        torch.ones(n, dtype=torch.bool, device=emb.device),
                        m)
    want, want_wall = _stacked_root(torch, "facility", pools, k, 0, radices)
    want_ids = want.ids[want.valid].cpu().numpy()
    launches = {}
    for r, res in enumerate(results):
        assert np.array_equal(res["ids"], want_ids), (r, res["ids"],
                                                      want_ids)
        _add(launches, res["launches"])
    emit({"phase": "coreset", "spec": "greedyml:facility", "n": n, "d": d,
          "k": k, "ranks": m, "radices": list(radices), "backend": "gloo",
          "ids_equal_to_stacked": True, "selected": int(len(want_ids)),
          "value": float(want.value),
          "digest": _digest(want_ids, want.value),
          "data_seconds": data_s, "spawn_wall_seconds": spawn_wall,
          "stacked_wall_seconds": want_wall,
          "rank_wall_seconds": [res["wall_seconds"] for res in results],
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# the sharded leaf tier, the lazy engine and the tree planner
# ---------------------------------------------------------------------------

SHARD_MACHINES, SHARD_LANES = 4, 4
SHARD_DIST_N, SHARD_DIST_D, SHARD_DIST_K = 8_192, 256, 64
LAZY_KMEDOID_N = 25_000


def _shard_machine_lanes(torch, pools, shard: int, tile: int):
    """Stacked (machines·shard, n_s, …) lanes of machine pools (M, n, …):
    each pool padded by shard_gains.pad_pool and cut into `shard` lanes,
    machine-major (lane = machine·shard + shard digit)."""
    from repro_torch.kernels.shard_gains import pad_pool
    out = ([], [], [])
    for m in range(pools[0].shape[0]):
        for dst, t in zip(out, pad_pool(*(p[m] for p in pools), shard,
                                        tile)):
            dst.append(t.reshape((shard, -1) + tuple(t.shape[1:])))
    return tuple(torch.cat(x) for x in out)


def _hold_leaf(torch, parity, rule, pool, valid, pool_ids, want, got,
               what: str) -> int:
    """One greedy against another over the same pool: ids and valid equal
    (then evals equal, values within the reference's 1e-5), or the first
    difference a tie float64 proves (parity.selection_tie, ROADMAP §C
    P1). Returns 1 at a tie."""
    if torch.equal(want.ids, got.ids):
        assert torch.equal(want.valid, got.valid), what
        assert int(want.evals) == int(got.evals), (what, int(want.evals),
                                                   int(got.evals))
        w, g = float(want.value), float(got.value)
        assert abs(g - w) <= 1e-5 + 1e-5 * abs(w), (what, w, g)
        return 0
    assert parity.selection_tie(pool, valid, pool_ids, want.ids, got.ids,
                                rule), (what, want.ids.tolist(),
                                        got.ids.tolist())
    return 1


def phase_sharded_kmedoid(torch, x, cfg, pools, reps: int,
                          machines: int = SHARD_MACHINES,
                          shard: int = SHARD_LANES):
    """The sharded leaf tier at the full width: the first `machines` of the
    stochastic run's lane pools (3,125 images each), each split over
    `shard` stacked lanes, through LevelDispatcher((2, 2), shard=4) with
    the tile of shard_plan at the default budget: leaves k · n_s / tile_c
    gains launches for all 16 lanes + one gains_norms; each machine's
    leaf against greedy_batch(engine='step') on its pool, up to a tie
    that float64 proves; the levels above against an unsharded
    LevelDispatcher((2, 2)) run from the same leaves (one lane a
    machine; both on the resident loop, bit for bit); one tile's gains
    launch at this shape held against its plain version under the
    float64 ratio rule and timed beside its bound. Returns the launches
    and the tile's largest |kernel − plain| gain."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import greedy_batch
    from repro_torch.core.greedyml import LevelDispatcher
    from repro_torch.kernels import counters, ops, pairwise as P, parity
    from repro_torch.kernels import plans
    from repro_torch.kernels import rules as R
    from repro_torch.kernels.shard_gains import resolve_tile_c
    ids, pay, valid = (t[:machines] for t in pools)
    obj = make_objective("kmedoid", device=x.device)
    k, n, d = cfg.k, ids.shape[1], pay.shape[-1]
    plan = plans.shard_plan(obj.rule, n, d, shard)
    tile = resolve_tile_c(obj.rule, n, d, shard)
    assert tile == plan["tile_c"], (tile, plan)
    lanes = _shard_machine_lanes(torch, (ids, pay, valid), shard, tile)
    n_s = lanes[0].shape[1]
    radices = (cfg.branching,) * round(math.log(machines, cfg.branching))
    disp = LevelDispatcher(obj, k, radices, shard=shard)
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    leaves = disp.leaves(*lanes)
    torch.cuda.synchronize()
    leaf_s = time.perf_counter() - t0
    launches = {nm: c["launches"] for nm, c in counters.snapshot().items()
                if c["launches"]}
    want = {"gains": k * n_s // tile, "gains_norms": 1}
    assert launches == want, (launches, want)
    sols, level_s = leaves, []
    for lvl in range(len(radices)):
        counters.reset()
        t0 = time.perf_counter()
        sols = disp.level(sols, lvl)
        torch.cuda.synchronize()
        level_s.append(time.perf_counter() - t0)
        got = {nm: c["launches"] for nm, c in counters.snapshot().items()
               if c["launches"]}
        assert got == {"greedy_loop_resident": 1, "pairwise": 1}, got
    for i in range(machines * shard):       # a machine's lanes alike
        assert torch.equal(leaves.ids[i], leaves.ids[i - i % shard])
        assert torch.equal(sols.ids[i], sols.ids[i - i % shard])
    # each machine's leaf against the step engine on its whole pool
    t0 = time.perf_counter()
    step = greedy_batch(obj, ids, pay, valid, k, engine="step")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    pick = lambda sol, i: sol.map(lambda t: t[i])
    ties = sum(_hold_leaf(torch, parity, obj.rule, pay[m], valid[m], ids[m],
                          pick(step, m), pick(leaves, m * shard),
                          f"machine {m} vs step")
               for m in range(machines))
    # the levels against the unsharded dispatcher (levels on the resident
    # loop) from the same leaves, one lane a machine: bit for bit, whether
    # or not a leaf split from the step engine's at a tie
    plain = LevelDispatcher(obj, k, radices, engine="step",
                            node_engine="auto")
    same_leaves = all(torch.equal(step.ids[m], leaves.ids[m * shard])
                      for m in range(machines))
    p_sols = leaves.map(lambda t: t[::shard].contiguous())
    for lvl in range(len(radices)):
        p_sols = plain.level(p_sols, lvl)
    assert torch.equal(p_sols.ids[0], sols.ids[0]), (
        p_sols.ids[0].tolist(), sols.ids[0].tolist())
    assert torch.equal(p_sols.valid[0], sols.valid[0])
    assert float(p_sols.value[0]) == float(sols.value[0])
    root = pick(sols, 0)
    root_ids = root.ids[root.valid].cpu().numpy()
    # one tile's gains launch at the sharded shape: every lane's ground,
    # on a live row (five of its rows folded in), against its machine's
    # gathered (shard·tile, d) tile, the last candidate masked
    g = lanes[1]
    row = R.empty_row(g, lanes[2], obj.rule)
    for j in range(5):
        row = R.update_row(g, row, g[:, 97 * j % n_s], obj.rule)
    row = row.contiguous()
    b, c = g.shape[0], shard * tile
    tile_pay = g[:, :tile].reshape(machines, c, d)
    cands = tile_pay.repeat_interleave(shard, dim=0)
    cv = torch.ones(b, c, dtype=torch.bool, device=x.device)
    cv[:, -1] = False
    gnorm = ops.gains_norms(g)
    got = P.gains(g, row, cands, cv, obj.rule, gnorm=gnorm)
    plain_g = P.gains_plain(g, row, cands, cv, obj.rule)
    tile_stats = parity.compare_gains(got, plain_g, g, row, cands, obj.rule,
                                      "gains at the sharded shape")
    fin = torch.isfinite(plain_g)
    tile_err = float((got[fin] - plain_g[fin]).abs().max())
    tile_stats["max_abs_err"] = tile_err
    del got, plain_g, fin
    flops = 2.0 * b * n_s * c * d + 2.0 * b * c * d + 4.0 * b * n_s * c
    nbytes = 4.0 * (b * n_s * d + b * c * d + 2 * b * n_s + b * c)
    bms, by = bound(flops, nbytes)
    gains_ms = cuda_ms(torch, lambda: P.gains(g, row, cands, cv, obj.rule,
                                              gnorm=gnorm), reps)
    plain_ms = cuda_ms(torch, lambda: P.gains_plain(g, row, cands, cv,
                                                    obj.rule), 1)
    lib_ms = cuda_ms(torch, lambda: torch.cdist(
        g, cands, compute_mode="use_mm_for_euclid_dist"), reps)
    del cands, tile_pay
    emit({"phase": "sharded_kmedoid", "machines": machines, "shard": shard,
          "lanes": machines * shard, "radices": list(radices), "k": k,
          "pool": n, "n_s": n_s, "tile_c": tile,
          "shard_plan_bytes": plan["bytes"],
          "leaf_stage_seconds": leaf_s, "level_seconds": level_s,
          "step_engine_seconds": step_s, "leaf_launches": launches,
          "vs_step_ties": ties, "leaves_equal_to_step": same_leaves,
          "levels_equal_to_unsharded": True,
          "root_value": float(root.value), "accepted": int(len(root_ids)),
          "digest": _digest(root_ids, root.value),
          "gathered_tile_bytes": 4 * machines * c * d,
          "lane_copy_bytes_a_tile": 4 * b * c * d,
          "gains_tile": {"shape": [b, n_s, c, d], "ms": gains_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by,
                         "tflops": flops / gains_ms / 1e9,
                         "max_abs_err": tile_err, "parity": tile_stats}})
    return launches, tile_err


def _shard_dist_rank(rank, emb, k, dev):
    """One rank of sharded_distributed: shard_greedy_distributed over the
    one machine's 4 shard ranks; its Solution, launches, wall and the
    shard gathers' bytes and seconds."""
    import torch
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.kernels.shard_gains import shard_greedy_distributed
    from repro_torch.launch.mesh import make_tree_mesh
    dev = _rank_device(torch, dev)
    mesh = make_tree_mesh((), shard=SHARD_LANES, device=dev)
    obj = make_objective("facility", device=dev)
    n = emb.shape[0]
    ids = torch.arange(n, device=dev)
    val = torch.ones(n, dtype=torch.bool, device=dev)
    mesh.log = []
    counters.reset()
    _sync(torch, dev)
    t0 = time.perf_counter()
    sol = shard_greedy_distributed(obj, ids, emb, val, k, mesh)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    log, mesh.log = mesh.log, None
    return {"sol": {f: getattr(sol, f).cpu() for f in
                    ("ids", "payloads", "valid", "value", "evals")},
            "wall_seconds": wall,
            "launches": {nm: c["launches"] for nm, c in
                         counters.snapshot().items() if c["launches"]},
            "gathers": len(log),
            "gather_bytes": sum(r["bytes"] for r in log),
            "gather_seconds": sum(r["seconds"] for r in log)}


def phase_sharded_distributed(torch, cfg, dev: str = "cuda:0",
                              n: int = SHARD_DIST_N, d: int = SHARD_DIST_D,
                              k: int = SHARD_DIST_K,
                              deadline: float = DIST_DEADLINE):
    """shard_greedy_distributed over 4 spawned gloo ranks on the card
    (make_tree_mesh((), shard=4)) on gen_embeddings(8,192, 256), facility,
    k = 64: every rank's Solution equal to shard_greedy_sim over the same
    pool bit for bit, its launches the stacked count."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import gen_embeddings
    from repro_torch.kernels import counters
    from repro_torch.kernels.shard_gains import shard_greedy_sim
    from repro_torch.launch.spawn import run_ranks
    emb = torch.as_tensor(gen_embeddings(n, d, seed=cfg.seed)).to(dev)
    t0 = time.perf_counter()
    results = run_ranks(_shard_dist_rank, SHARD_LANES, args=(emb, k, dev),
                        timeout=deadline)
    spawn_wall = time.perf_counter() - t0
    obj = make_objective("facility", device=emb.device)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = shard_greedy_sim(obj, torch.arange(n, device=emb.device), emb,
                            torch.ones(n, dtype=torch.bool,
                                       device=emb.device), k,
                            lanes=SHARD_LANES)
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    stacked = {nm: c["launches"] for nm, c in counters.snapshot().items()
               if c["launches"]}
    for r, res in enumerate(results):
        for f, v in res["sol"].items():
            assert torch.equal(v, getattr(want, f).cpu()), (r, f)
        assert res["launches"] == stacked, (r, res["launches"], stacked)
    ids = want.ids[want.valid].cpu().numpy()
    emit({"phase": "sharded_distributed", "n": n, "d": d, "k": k,
          "ranks": SHARD_LANES, "backend": "gloo",
          "bit_for_bit_with_stacked": True, "launches_per_rank": stacked,
          "value": float(want.value), "digest": _digest(ids, want.value),
          "spawn_wall_seconds": spawn_wall,
          "stacked_wall_seconds": stacked_s,
          "rank_wall_seconds": [res["wall_seconds"] for res in results],
          "rank_gathers": [res["gathers"] for res in results],
          "rank_gather_bytes": [res["gather_bytes"] for res in results],
          "rank_gather_seconds": [res["gather_seconds"]
                                  for res in results]})
    return {nm: v * SHARD_LANES for nm, v in stacked.items()}


def phase_lazy_kcover(torch, sets, words, cfg, dense):
    """run_tree_lazy over the kosarak-shaped sets (host, adjacency lists)
    against kcover_run's dense tree `dense` (its SimResult): the same
    global value, levels and comm elements, fewer evals; then
    run_greedy_lazy over all the sets against run_greedy_dense on the
    card: the same value, no more evals (tests/test_simulate.py's
    assertions at full scale)."""
    from repro_torch.core.simulate import (run_greedy_dense,
                                           run_greedy_lazy, run_tree_lazy)
    from repro_torch.core.tree import AccumulationTree
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    t0 = time.perf_counter()
    lazy = run_tree_lazy("kcover", sets, cfg.k, tree, seed=cfg.seed,
                         universe=cfg.universe)
    tree_s = time.perf_counter() - t0
    assert lazy.value == dense.value, (lazy.value, dense.value)
    assert (lazy.levels, lazy.comm_elements) == (dense.levels,
                                                 dense.comm_elements)
    assert lazy.evals_total < dense.evals_total
    t0 = time.perf_counter()
    g_lazy = run_greedy_lazy("kcover", sets, cfg.k, universe=cfg.universe)
    greedy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_dense = run_greedy_dense("kcover", words, cfg.k,
                               universe=cfg.universe, device=words.device)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    assert g_lazy.value == g_dense.value, (g_lazy.value, g_dense.value)
    assert g_lazy.evals_total <= g_dense.evals_total
    emit({"phase": "lazy_kcover", "n": cfg.n, "k": cfg.k,
          "m": cfg.num_machines, "b": cfg.branching,
          "global_value": lazy.value, "dense_global_value": dense.value,
          "levels": lazy.levels, "comm_elements": lazy.comm_elements,
          "evals_total": lazy.evals_total,
          "evals_critical": lazy.evals_critical,
          "dense_evals_total": dense.evals_total,
          "tree_host_seconds": tree_s,
          "greedy_value": g_lazy.value, "greedy_evals": g_lazy.evals_total,
          "greedy_dense_evals": g_dense.evals_total,
          "greedy_host_seconds": greedy_s,
          "greedy_dense_seconds": dense_s})


def phase_lazy_kmedoid(torch, x, cfg, n: int = LAZY_KMEDOID_N,
                       card: str = "cuda"):
    """DenseMedoid on the card: run_tree_lazy over the first `n` images
    (a cut of the 100,000) at the full width, m = 32, b = 2, k = 200,
    beside run_tree_dense on the same images; and on small-integer data
    (the reference phases' kind) the card's lazy selections and evals
    equal to the CPU's."""
    from repro_torch.core.simulate import run_tree_dense, run_tree_lazy
    from repro_torch.core.tree import AccumulationTree
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    sub = x[:n]
    t0 = time.perf_counter()
    lazy = run_tree_lazy("kmedoid", sub, cfg.k, tree, seed=cfg.seed)
    torch.cuda.synchronize()
    lazy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = run_tree_dense("kmedoid", sub, cfg.k, tree, seed=cfg.seed,
                           device=sub.device)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    assert lazy.levels == dense.levels
    small = np.random.default_rng(cfg.seed).integers(-3, 4, (2_048, 64))
    small = small.astype(np.float32)
    st = AccumulationTree(8, 2)
    card = run_tree_lazy("kmedoid", small, 16, st, seed=cfg.seed,
                         device=card)
    cpu = run_tree_lazy("kmedoid", small, 16, st, seed=cfg.seed,
                        device="cpu")
    assert list(card.ids) == list(cpu.ids), (card.ids, cpu.ids)
    assert card.per_node_evals == cpu.per_node_evals
    assert abs(card.value - cpu.value) <= 1e-5 * max(1.0, abs(cpu.value))
    emit({"phase": "lazy_kmedoid", "n": n, "d": x.shape[1], "k": cfg.k,
          "m": cfg.num_machines, "b": cfg.branching,
          "lazy_global_value": lazy.value, "dense_global_value": dense.value,
          "lazy_evals_total": lazy.evals_total,
          "lazy_evals_critical": lazy.evals_critical,
          "dense_evals_total": dense.evals_total,
          "lazy_comm_elements": lazy.comm_elements,
          "dense_comm_elements": dense.comm_elements,
          "lazy_seconds": lazy_s, "dense_seconds": dense_s,
          "small_integer_card_equals_cpu": True,
          "small_integer_evals": card.evals_total})


def _tree_plan_json(tp) -> dict:
    if tp is None:
        return None
    return {"radices": list(tp.radices), "shard": tp.shard,
            "machines": tp.machines, "leaf_n": tp.leaf_n,
            "leaf_engine": tp.leaf_plan.engine,
            "leaf_dtype": tp.leaf_plan.dtype,
            "leaf_tile_c": tp.leaf_plan.tile_c,
            "node_engine": tp.node_plan.engine,
            "peak_bytes": tp.peak_bytes, "cost": tp.cost}


def phase_plan_tree(torch, configs, lanes: int = 32):
    """plans.plan_tree at each configuration over `lanes` lanes, under the
    default budget and under one that refuses every cached leaf tier
    (just below the smallest leaf cache the ladder could store)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import plans
    from repro_torch.runtime import flags
    out = {}
    for name, cfg, d, words in configs:
        rule = make_objective(name, universe=cfg.universe, device="cpu").rule
        leaf_n = -(-cfg.n // lanes)
        rows = words if rule.is_bitmap else leaf_n
        cheapest = "uint32" if rule.is_bitmap else "int8"
        refuse = (plans.cache_bytes(rows, leaf_n, cheapest) - 1) / 2 ** 20
        row = {}
        for tag, mb in (("default", flags.fused_cache_mb()),
                        ("refusing_cached_leaves", refuse)):
            with _env(**{flags.FUSED_CACHE_MB_ENV: mb}):
                t0 = time.perf_counter()
                tp = plans.plan_tree(rule, cfg.n, d, cfg.k, lanes,
                                     words=words)
                row[tag] = {"budget_mb": mb, "seconds":
                            time.perf_counter() - t0,
                            "plan": _tree_plan_json(tp)}
        out[name] = row
    emit({"phase": "plan_tree", "lanes": lanes, **out})


# ---------------------------------------------------------------------------
# fault tolerance and serving (slice 13)
# ---------------------------------------------------------------------------

# seconds each slice-13 phase took, printed once at the end
SLICE13_SECONDS = {}
SERVE_POOL, SERVE_KS = 400, (50, 100, 200)
SERVE_KCOVER_POOL = 128


@contextlib.contextmanager
def _ckpt_probe(log: list):
    """checkpoint/manager.py's save and restore timed for the duration:
    each call's step, arrays.npz bytes and seconds appended to `log`."""
    from repro_torch.checkpoint import manager
    save0, restore0 = manager.save, manager.restore

    def npz(path):
        return os.path.getsize(os.path.join(path, "arrays.npz"))

    def save(ckpt_dir, step, tree, extra=None, keep=3):
        t0 = time.perf_counter()
        path = save0(ckpt_dir, step, tree, extra=extra, keep=keep)
        log.append({"op": "save", "step": step, "bytes": npz(path),
                    "seconds": time.perf_counter() - t0})
        return path

    def restore(ckpt_dir, example_tree, step=None, shardings=None):
        t0 = time.perf_counter()
        out = restore0(ckpt_dir, example_tree, step=step,
                       shardings=shardings)
        path = os.path.join(ckpt_dir, f"step_{out[1]['step']:08d}")
        log.append({"op": "restore", "step": out[1]["step"],
                    "bytes": npz(path),
                    "seconds": time.perf_counter() - t0})
        return out

    manager.save, manager.restore = save, restore
    try:
        yield log
    finally:
        manager.save, manager.restore = save0, restore0


def _run_pools(torch, data, cfg):
    """run_tree_dense's leaf pools (its seeded partition, −1 padded, on
    the card) as global (m·P, …) arrays: shard_lanes gives lane i pool i,
    so a dispatcher over them runs run_tree_dense's leaves."""
    from repro_torch.core.simulate import _pools, partition
    pool_ids, pool_valid = _pools(partition(data.shape[0],
                                            cfg.num_machines, cfg.seed),
                                  cfg.num_machines)
    ids = torch.as_tensor(pool_ids, device=data.device)
    pay = data[ids.clamp(min=0)]
    pay[ids < 0] = 0
    return (ids.reshape(-1), pay.reshape((-1,) + tuple(data.shape[1:])),
            torch.as_tensor(pool_valid, device=data.device).reshape(-1))


def _supervised_run(torch, obj, data, k, lanes, b, ckpt_dir, injector=None,
                    max_restarts=3, resume=False, **kw):
    """One SelectionSupervisor.select over stacked lanes on the card →
    (root, info, report: wall, each dispatch's level/epoch/wall, the
    event kinds, launches by kernel)."""
    from repro_torch.kernels import counters
    from repro_torch.runtime.supervisor import SelectionSupervisor
    sup = SelectionSupervisor(ckpt_dir=ckpt_dir, injector=injector,
                              max_restarts=max_restarts)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, info = sup.select(obj, *data, k, lanes=lanes, branching=b,
                           resume=resume, **kw)
    torch.cuda.synchronize()
    return sol, info, _sup_report(info, time.perf_counter() - t0)


def _sup_report(info, wall) -> dict:
    from repro_torch.kernels import counters
    return {"wall_seconds": wall,
            "levels": [{"level": e["level"], "epoch": e["epoch"],
                        "wall_s": e["wall_s"]} for e in info["events"]
                       if e["kind"] == "dispatch"],
            "events": [[e["kind"], e.get("level")] for e in info["events"]],
            "final_tree": list(info["final_tree"]),
            "workers": info["workers"],
            "launches": {n: c["launches"] for n, c in
                         counters.snapshot().items() if c["launches"]}}


def _same_solution(a, b, what: str) -> None:
    for f in ("ids", "payloads", "valid", "value", "evals"):
        assert torch_equal(getattr(a, f), getattr(b, f)), (what, f)


def torch_equal(a, b) -> bool:
    return bool(a.shape == b.shape and (a == b).all())


def _kinds(report) -> list:
    return [k for k, _ in report["events"]]


class _StopAt:
    """An injector that raises an anonymous WorkerFailure at one level:
    with max_restarts=0 the run stops there, its checkpoints kept."""

    def __init__(self, level: int):
        self.level = level

    def check(self, level, alive=None):
        from repro_torch.runtime.fault import WorkerFailure
        if level == self.level:
            raise WorkerFailure(f"stopped at level {level}")


def _launch_totals(*reports) -> dict:
    out = {}
    for rep in reports:
        _add(out, rep["launches"])
    return out


def phase_supervised_kcover(torch, words, cfg, kcover_res):
    """SelectionSupervisor over kcover_run's pools (KOSARAK uncut, k = 64,
    m = 32, b = 2): a clean run equal to kcover_run's root bit for bit; a
    transient failure at (level 2, lane 5) replayed from the level-1
    checkpoint to the clean bits; lane 7 dead from level 1 → the tree
    re-planned to (16, 2, 4) over the survivors' solutions, value ≥ 0.95×
    clean; a run stopped after level 2 and resumed by a fresh supervisor
    reaching the clean root. Every save and restore's bytes and seconds,
    every dispatch's wall, the launches."""
    import tempfile
    from repro_torch.core.functions import make_objective
    from repro_torch.runtime.elastic import plan_degraded_tree
    from repro_torch.runtime.fault import WorkerFailure
    from repro_torch.runtime.supervisor import (LaneFailureInjector,
                                                SelectionSupervisor)
    t_phase = time.perf_counter()
    m, b = cfg.num_machines, cfg.branching
    obj = make_objective("kcover", universe=cfg.universe, device=words.device)
    data = _run_pools(torch, words, cfg)
    logs, reps = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, **kw):
            logs[name] = []
            with _ckpt_probe(logs[name]):
                sol, info, rep = _supervised_run(
                    torch, obj, data, cfg.k, m, b,
                    os.path.join(tmp, name), **kw)
            reps[name] = rep
            return sol, info
        clean, _ = run("clean")
        root_ids = clean.ids[clean.valid].cpu().numpy()
        assert np.array_equal(root_ids, np.asarray(kcover_res.ids)), (
            root_ids, kcover_res.ids)
        assert float(clean.value) == kcover_res.root_value, (
            float(clean.value), kcover_res.root_value)
        rep, _ = run("replay", injector=LaneFailureInjector(
            fail_at=((2, 5),)))
        _same_solution(rep, clean, "replay")
        assert {"failure", "restore"} <= set(_kinds(reps["replay"]))
        deg, dinfo = run("degraded", injector=LaneFailureInjector(
            dead={7: 1}), max_restarts=1)
        lanes2, levels2 = plan_degraded_tree(m - 1, b)     # (16, 4)
        assert dinfo["degraded"] and dinfo["final_tree"] == (
            lanes2, b, levels2), dinfo["final_tree"]
        assert 7 not in dinfo["workers"]
        ratio = float(deg.value) / float(clean.value)
        assert ratio >= 0.95, ratio
        logs["stopped"] = []
        with _ckpt_probe(logs["stopped"]):
            sup = SelectionSupervisor(ckpt_dir=os.path.join(tmp, "resume"),
                                      injector=_StopAt(3), max_restarts=0)
            try:
                sup.select(obj, *data, cfg.k, lanes=m, branching=b)
                raise AssertionError("the stopped run did not stop")
            except WorkerFailure:
                pass
        res, rinfo = run("resume", resume=True)
        _same_solution(res, clean, "resume")
        assert _kinds(reps["resume"])[0] == "resume"
        assert reps["resume"]["events"][0][1] == 2
    SLICE13_SECONDS["supervised_kcover"] = time.perf_counter() - t_phase
    emit({"phase": "supervised_kcover", "n": cfg.n, "k": cfg.k, "m": m,
          "b": b, "root_equal_to_kcover_run": True,
          "replay_equal_to_clean": True, "resume_equal_to_clean": True,
          "root_value": float(clean.value),
          "degraded_value": float(deg.value), "degraded_ratio": ratio,
          "degraded_final_tree": list(dinfo["final_tree"]),
          "runs": reps, "checkpoints": logs,
          "seconds": SLICE13_SECONDS["supervised_kcover"]})
    return _launch_totals(*reps.values())


def phase_supervised_kmedoid(torch, x, cfg, f32_run):
    """SelectionSupervisor over run's pools (Tiny-ImageNet, k = 200, m =
    32, b = 2) with a transient failure at (level 3, lane 5): the root
    equal bit for bit to the unsupervised LevelDispatcher over the same
    pools, and run's root ids and value; every lane's 200 × 12,288 f32
    payloads checkpointed (315 MB a save): saves' and the restore's
    bytes and seconds."""
    import tempfile
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import (LevelDispatcher, root_solution,
                                           shard_lanes)
    from repro_torch.runtime.supervisor import LaneFailureInjector
    t_phase = time.perf_counter()
    m, b = cfg.num_machines, cfg.branching
    obj = make_objective("kmedoid", device=x.device)
    data = _run_pools(torch, x, cfg)
    disp = LevelDispatcher(obj, cfg.k, (b,) * round(math.log(m, b)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = disp.leaves(*shard_lanes(*data, m))
    for lvl in range(disp.num_levels):
        sols = disp.level(sols, lvl)
    want = root_solution(sols)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    del sols
    log = []
    with tempfile.TemporaryDirectory() as tmp, _ckpt_probe(log):
        sol, info, rep = _supervised_run(
            torch, obj, data, cfg.k, m, b, tmp,
            injector=LaneFailureInjector(fail_at=((3, 5),)))
    del data
    _same_solution(sol, want, "supervised vs dispatcher")
    assert {"failure", "restore"} <= set(_kinds(rep))
    run_ids, _, run_root = f32_run
    ids = sol.ids[sol.valid].cpu().numpy()
    assert np.array_equal(ids, np.asarray(run_ids)), (ids, run_ids)
    assert float(sol.value) == run_root, (float(sol.value), run_root)
    SLICE13_SECONDS["supervised_kmedoid"] = time.perf_counter() - t_phase
    emit({"phase": "supervised_kmedoid", "n": x.shape[0], "k": cfg.k,
          "m": m, "b": b, "root_equal_to_dispatcher": True,
          "root_equal_to_run": True,
          "root_value": float(sol.value), "run_root_value": run_root,
          "dispatcher_wall_seconds": plain_wall, "run": rep,
          "checkpoints": log,
          "seconds": SLICE13_SECONDS["supervised_kmedoid"]})
    return rep["launches"]


def _sup_dist_rank(rank, flat, name, k, universe, radices, root, dev):
    """One rank of supervised_distributed: clean, replay and dead-lane
    supervised trees over the mesh, each rank's root and report."""
    import torch
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_tree_mesh
    from repro_torch.runtime.supervisor import (LaneFailureInjector,
                                                SelectionSupervisor)
    dev = _rank_device(torch, dev)
    mesh = make_tree_mesh(radices, device=dev)
    obj = make_objective(name, universe=universe, device=dev)
    runs = {"clean": (None, 3),
            "replay": (LaneFailureInjector(fail_at=((2, 5),)), 3),
            "degraded": (LaneFailureInjector(dead={7: 1}), 1)}
    out = {}
    for run, (inj, mr) in runs.items():
        sup = SelectionSupervisor(ckpt_dir=os.path.join(root, run),
                                  injector=inj, max_restarts=mr)
        counters.reset()
        _sync(torch, dev)
        t0 = time.perf_counter()
        sol, info = sup.select(obj, *flat, k, lanes=mesh.lanes, mesh=mesh)
        _sync(torch, dev)
        out[run] = {"sol": sol.map(lambda x: x.cpu()),
                    "report": _sup_report(info, time.perf_counter() - t0)}
    return out


def phase_supervised_distributed(torch, words, cfg, dev: str = "cuda:0",
                                 deadline: float = DIST_DEADLINE):
    """SelectionSupervisor over 8 spawned gloo ranks on the card, one
    lane a rank (distributed_kdom's pools, paper_kdom uncut): the clean
    root equal to distributed_kdom's on every rank; a transient failure
    at (2, 5) replayed to the clean bits; lane 7 dead from level 1 →
    the tree re-planned onto a 4-rank subset mesh, its root on every rank
    equal bit for bit to the stacked supervised run with that failure."""
    import tempfile
    from repro_torch.core.functions import make_objective
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.runtime.elastic import plan_degraded_tree
    from repro_torch.runtime.supervisor import LaneFailureInjector
    t_phase = time.perf_counter()
    m, b = cfg.num_machines, cfg.branching
    lanes2, levels2 = plan_degraded_tree(m - 1, b)         # (4, 2)
    radices = (b,) * int(round(math.log(m, b)))
    pools = lane_pools(torch, words, m, cfg.seed)
    want, _ = _stacked_root(torch, cfg.objective, pools, cfg.k,
                            cfg.universe, radices)
    flat = (pools[0].reshape(-1), pools[1].reshape(-1, words.shape[1]),
            pools[2].reshape(-1))
    obj = make_objective(cfg.objective, universe=cfg.universe,
                         device=words.device)
    with tempfile.TemporaryDirectory() as tmp:
        stacked, sinfo, srep = _supervised_run(
            torch, obj, flat, cfg.k, m, b, os.path.join(tmp, "stacked"),
            injector=LaneFailureInjector(dead={7: 1}), max_restarts=1)
        t0 = time.perf_counter()
        results = run_ranks(_sup_dist_rank, m, args=(
            flat, cfg.objective, cfg.k, cfg.universe, radices,
            os.path.join(tmp, "ranks"), dev), timeout=deadline)
        spawn_wall = time.perf_counter() - t0
    del pools, flat
    launches = {}
    for r, res in enumerate(results):
        clean = res["clean"]["sol"]
        _same_solution(clean, want.map(lambda t: t.cpu()), f"clean {r}")
        _same_solution(res["replay"]["sol"], clean, f"replay {r}")
        _same_solution(res["degraded"]["sol"],
                       stacked.map(lambda t: t.cpu()), f"degraded {r}")
        drep = res["degraded"]["report"]
        assert drep["final_tree"] == [lanes2, b, levels2], drep[
            "final_tree"]
        assert drep["workers"] == list(range(lanes2)), drep["workers"]
        assert {"failure", "restore"} <= set(_kinds(res["replay"]["report"]))
        for run in res.values():
            _add(launches, run["report"]["launches"])
    SLICE13_SECONDS["supervised_distributed"] = time.perf_counter() - t_phase
    emit({"phase": "supervised_distributed", "backend": "gloo", "ranks": m,
          "radices": list(radices), "root_equal_to_distributed_kdom": True,
          "replay_equal_to_clean": True,
          "degraded_equal_to_stacked": True,
          "degraded_final_tree": [lanes2, b, levels2],
          "subset_ranks": list(range(lanes2)),
          "value": float(want.value),
          "degraded_value": float(stacked.value),
          "stacked_degraded": srep, "spawn_wall_seconds": spawn_wall,
          "rank0": {run: res["report"] for run, res in results[0].items()},
          "launches": launches,
          "seconds": SLICE13_SECONDS["supervised_distributed"]})
    _add(launches, srep["launches"])
    return launches


def phase_supervised_stream(torch, words, cfg, continuous, stream_sol):
    """The streaming drivers under supervision, on continuous_kcover's and
    stream_kcover's streams (all 990,002 sets, B = 256): a transient
    failure at merge 1 on lane 2 replayed — the merges and the answer
    equal continuous_kcover's; lane 1 lost from merge 3 (lane_reset, a
    cold sieve); stream_select checkpointed every 512 batches, stopped at
    half the stream and resumed — ids and value equal stream_kcover's bit
    for bit."""
    import itertools
    import tempfile
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.runtime.supervisor import (LaneFailureInjector,
                                                SelectionSupervisor)
    from repro_torch.streaming import stream_select, stream_select_continuous
    t_phase = time.perf_counter()
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    stream, _ = _kcover_stream(torch, words, cfg)
    n_batches = -(-words.shape[0] // STREAM_BATCH)
    logs, out, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, inj, mr in (
                ("replay", LaneFailureInjector(fail_at=((1, 2),)), 3),
                ("lane_lost", LaneFailureInjector(dead={1: 3}), 1)):
            logs[name] = []
            sup = SelectionSupervisor(ckpt_dir=os.path.join(tmp, name),
                                      injector=inj, max_restarts=mr)
            counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _ckpt_probe(logs[name]):
                sol, info = stream_select_continuous(
                    obj, stream, cfg.k, lanes=CONTINUOUS_LANES, branching=2,
                    merge_every=MERGE_EVERY, eps=STREAM_EPS, supervisor=sup)
            torch.cuda.synchronize()
            kinds = [e["kind"] for e in info["events"]]
            out[name] = {"wall_seconds": time.perf_counter() - t0,
                         "merges": info["merges"], "kinds": kinds,
                         "merge_walls": [e["wall_s"] for e in info["events"]
                                         if e["kind"] == "merge"],
                         "digest": _digest(sol.ids[sol.valid].cpu().numpy(),
                                           sol.value)}
            _add(launches, {n: c["launches"] for n, c in
                            counters.snapshot().items() if c["launches"]})
        rep = out["replay"]
        assert rep["merges"] == continuous["merges"], (rep["merges"],
                                                       continuous["merges"])
        assert rep["digest"] == continuous["digest"]
        assert {"failure", "restart"} <= set(rep["kinds"])
        assert "lane_reset" in out["lane_lost"]["kinds"]
        d = os.path.join(tmp, "stream")
        logs["stream_select"] = []
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ckpt_probe(logs["stream_select"]):
            stream_select(obj, itertools.islice(iter(stream), n_batches // 2),
                          cfg.k, eps=STREAM_EPS, ckpt_dir=d, ckpt_every=512)
            resumed = stream_select(obj, stream, cfg.k, eps=STREAM_EPS,
                                    ckpt_dir=d, resume=True)
        torch.cuda.synchronize()
        stop_resume_wall = time.perf_counter() - t0
        _add(launches, {n: c["launches"] for n, c in
                        counters.snapshot().items() if c["launches"]})
    _same_solution(resumed, stream_sol, "stream_select resumed")
    SLICE13_SECONDS["supervised_stream"] = time.perf_counter() - t_phase
    emit({"phase": "supervised_stream", "lanes": CONTINUOUS_LANES,
          "merge_every": MERGE_EVERY, "batches": n_batches,
          "replay_merges_equal_to_continuous_kcover": True,
          "resume_equal_to_stream_kcover": True,
          "stopped_after_batches": n_batches // 2,
          "stop_resume_wall_seconds": stop_resume_wall, "runs": out,
          "checkpoints": logs, "launches": launches,
          "seconds": SLICE13_SECONDS["supervised_stream"]})
    return launches


def phase_tenant_session(torch, words, cfg, continuous):
    """A TenantSession over continuous_kcover's stream (the same lanes,
    branching, merge cadence and ε): its merges and answer equal the
    direct ContinuousSelector's (continuous_kcover)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.serving import SessionManager
    t_phase = time.perf_counter()
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    stream, _ = _kcover_stream(torch, words, cfg)
    mgr = SessionManager()
    sess = mgr.open("tenant0", obj, cfg.k, lanes=CONTINUOUS_LANES,
                    branching=2, merge_every=MERGE_EVERY, eps=STREAM_EPS)
    counters.reset()
    for ids, pay, valid in stream:
        sess.push(ids, pay, valid)
    sol = mgr.close("tenant0")
    torch.cuda.synchronize()
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    info = sess.info()
    digest = _digest(sol.ids[sol.valid].cpu().numpy(), sol.value)
    assert info["merges"] == continuous["merges"], info["merges"]
    assert digest == continuous["digest"], (digest, continuous["digest"])
    SLICE13_SECONDS["tenant_session"] = time.perf_counter() - t_phase
    emit({"phase": "tenant_session", "equal_to_continuous_kcover": True,
          "pushes": mgr.metrics.tenant_stats("tenant0")["stream_pushes"],
          "merges": len(info["merges"]), "digest": digest,
          "launches": launches,
          "seconds": SLICE13_SECONDS["tenant_session"]})
    return launches


def _serve(torch, name, queries, solo_kw, resident: str):
    """Drain `queries` through one QueryEngine on the card: every
    admitted batch ONE resident dispatch, each batched query equal bit
    for bit to its solo greedy(engine="mega"), each solo one to greedy()
    with its own arguments → (report, launches)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import greedy
    from repro_torch.kernels import counters
    from repro_torch.serving import QueryEngine
    dev = queries[0].payloads.device
    eng = QueryEngine(device=dev)
    qids = [eng.submit(q) for q in queries]
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    batches = eng.metrics.batches
    assert batches and all(bt["dispatches"] == 1 for bt in batches), batches
    assert launches.get(resident) == len(batches), (launches, batches)
    n_batched = sum(bt["size"] for bt in batches)
    assert n_batched == sum(r.batched for r in res.values())
    obj = make_objective(name, universe=queries[0].universe, device=dev)
    for qid, q in zip(qids, queries):
        r = res[qid]
        kw = solo_kw.get(qid, {"engine": "mega"})
        assert r.batched == (qid not in solo_kw), qid
        want = greedy(obj, q.ids, q.payloads, q.valid, q.k, **kw)
        _same_solution(r.solution, want, f"query {qid}")
    snap = eng.metrics.snapshot()
    return {"queries": len(queries), "batched": n_batched,
            "solo": len(queries) - n_batched,
            "batch_sizes": [bt["size"] for bt in batches],
            "batch_walls_s": [bt["wall_s"] for bt in batches],
            "resident_dispatches": len(batches),
            "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
            "queries_per_s": snap["queries_per_s"], "drain_seconds": wall,
            "each_equal_to_solo": True}, launches


def phase_serve_kmedoid(torch, x, cfg):
    """QueryEngine on the card: 32 k-medoid queries over 400-image pools
    of the Tiny-ImageNet images (the node shape, 12,288 features), k ∈
    {50, 100, 200}, beside a knapsack query (uniform(0.5, 2) costs,
    budget 50) and a sampled query (sample 10, seed 3), which go solo."""
    from repro_torch.core.constraints import Knapsack
    from repro_torch.serving import Query
    t_phase = time.perf_counter()
    rng = np.random.default_rng(cfg.seed + 7)
    dev = x.device

    def pool():
        idx = torch.as_tensor(np.sort(rng.choice(x.shape[0], SERVE_POOL,
                                                 replace=False)), device=dev)
        return idx, x[idx], torch.ones(SERVE_POOL, dtype=torch.bool,
                                       device=dev)

    queries = [Query("kmedoid", SERVE_KS[i % 3], *pool())
               for i in range(32)]
    costs = torch.as_tensor(knapsack_costs(SERVE_POOL, cfg.seed), device=dev)
    con = Knapsack(costs, 50.0)
    sample = sample_size(SERVE_POOL, cfg.k)
    queries.insert(5, Query("kmedoid", cfg.k, *pool(), constraint=con))
    queries.insert(20, Query("kmedoid", cfg.k, *pool(), sample=sample,
                             seed=3))
    solo = {5: {"constraint": con},
            20: {"sample": sample,
                 "key": torch.Generator().manual_seed(3)}}
    rep, launches = _serve(torch, "kmedoid", queries, solo,
                           "greedy_loop_resident")
    SLICE13_SECONDS["serve_kmedoid"] = time.perf_counter() - t_phase
    emit({"phase": "serve_kmedoid", "pool": SERVE_POOL,
          "d": x.shape[1], "ks": list(SERVE_KS), **rep,
          "launches": launches,
          "seconds": SLICE13_SECONDS["serve_kmedoid"]})
    return launches


def phase_serve_kcover(torch, words, cfg):
    """QueryEngine on the card: 64 kcover queries of 128 kosarak sets (the
    resident bitmap loop's node shape, 1,290 words), k = 64, beside a
    knapsack query (budget 40) and a sampled query, which go solo."""
    from repro_torch.core.constraints import Knapsack
    from repro_torch.serving import Query
    t_phase = time.perf_counter()
    rng = np.random.default_rng(cfg.seed + 7)
    dev = words.device
    c = SERVE_KCOVER_POOL

    def pool():
        idx = torch.as_tensor(np.sort(rng.choice(words.shape[0], c,
                                                 replace=False)), device=dev)
        return idx, words[idx], torch.ones(c, dtype=torch.bool, device=dev)

    queries = [Query("kcover", cfg.k, *pool(), universe=cfg.universe)
               for _ in range(64)]
    con = Knapsack(torch.as_tensor(knapsack_costs(c, cfg.seed),
                                   device=dev), BUDGET_KCOVER)
    sample = sample_size(c, cfg.k)
    queries.insert(9, Query("kcover", cfg.k, *pool(), universe=cfg.universe,
                            constraint=con))
    queries.insert(40, Query("kcover", cfg.k, *pool(), universe=cfg.universe,
                             sample=sample, seed=5))
    solo = {9: {"constraint": con},
            40: {"sample": sample, "key": torch.Generator().manual_seed(5)}}
    rep, launches = _serve(torch, "kcover", queries, solo,
                           "greedy_loop_resident[coverage]")
    SLICE13_SECONDS["serve_kcover"] = time.perf_counter() - t_phase
    emit({"phase": "serve_kcover", "pool": c,
          "words": int(words.shape[1]), "k": cfg.k, **rep,
          "launches": launches, "seconds": SLICE13_SECONDS["serve_kcover"]})
    return launches


def phase_faultrun_smoke():
    """`python -m repro_torch.launch.faultrun --smoke` as a subprocess on
    the card (the kernels already built): it must exit 0."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.faultrun",
                          "--smoke"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "fault smoke OK" in out.stdout, (
        out.returncode, out.stdout[-2000:], out.stderr[-2000:])
    SLICE13_SECONDS["faultrun_smoke"] = time.perf_counter() - t0
    emit({"phase": "faultrun_smoke", "exit": out.returncode,
          "stdout": out.stdout.strip().splitlines(),
          "seconds": SLICE13_SECONDS["faultrun_smoke"]})


# ---------------------------------------------------------------------------
# the selection launchers and the measured-plan cache (slice 14)
# ---------------------------------------------------------------------------

# seconds each slice-14 phase took, printed once at the end
SLICE14_SECONDS = {}
CLI_TIMEOUT = 300
# the device the slice-14 phases run on (every CLI gets --device)
CLI_DEVICE = "cuda"
_F = r"f=([0-9.]+)"


def _cli(module: str, *argv: str, timeout: float = CLI_TIMEOUT):
    """`python -m repro_torch.launch.<module> argv…` on the card (the
    kernels already built) → (exit code, stdout lines, seconds); a
    non-zero exit raises with its output."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          f"repro_torch.launch.{module}", *argv,
                          "--device", CLI_DEVICE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    assert out.returncode == 0, (module, argv, out.returncode,
                                 out.stdout[-3000:], out.stderr[-3000:])
    return out.stdout.strip().splitlines(), wall


def _field(pattern: str, line: str) -> str:
    m = re.search(pattern, line)
    assert m, (pattern, line)
    return m.group(1)


def phase_summarize(torch):
    """`launch.summarize --compare` at the registry's full paper-kcover,
    paper-kdom and paper-kmedoid configurations (dense engine), and
    paper-kcover on the lazy engine: the GreedyML, RandGreedi and Greedy
    lines, the quality ratios, each run's seconds. Dense kcover's and
    kdom's trees are run again in this process through run_tree_dense on
    the same instance: their values equal the CLI's (coverage values are
    exact integers). Returns the in-process runs' launches."""
    import dataclasses as dc
    from repro_torch.configs import registry
    from repro_torch.core.simulate import run_tree_dense
    from repro_torch.core.tree import AccumulationTree, randgreedi_tree
    from repro_torch.kernels import counters
    from repro_torch.launch.summarize import build_instance
    t_phase = time.perf_counter()
    runs, launches = {}, {}
    for problem, engine in [("paper-kcover", "dense"),
                            ("paper-kdom", "dense"),
                            ("paper-kmedoid", "dense"),
                            ("paper-kcover", "lazy")]:
        lines, wall = _cli("summarize", "--problem", problem, "--engine",
                           engine, "--compare")
        assert len(lines) == 4 and lines[0].startswith("GreedyML"), lines
        row = {"lines": lines, "process_seconds": wall,
               "greedyml_seconds": float(_field(r"\[([0-9.]+)s\]",
                                                lines[0])),
               "f": [float(_field(_F, ln)) for ln in lines[:3]]}
        q = re.findall(r"= ([0-9.]+)", lines[3])
        row["quality"] = {"greedyml_over_greedy": float(q[0]),
                          "randgreedi_over_greedy": float(q[1])}
        runs[f"{problem}/{engine}"] = row
        if engine != "dense" or problem == "paper-kmedoid":
            continue
        pcfg = registry.PROBLEMS[problem]
        _, dense = build_instance(pcfg)
        counters.reset()
        kw = dict(seed=pcfg.seed, universe=pcfg.universe,
                  augment=pcfg.augment, device=CLI_DEVICE)
        ml = run_tree_dense(pcfg.objective, dense, pcfg.k, AccumulationTree(
            pcfg.num_machines, pcfg.branching), **kw)
        rg = run_tree_dense(pcfg.objective, dense, pcfg.k,
                            randgreedi_tree(pcfg.num_machines), **kw)
        _add(launches, {n: c["launches"] for n, c in
                        counters.snapshot().items() if c["launches"]})
        cli_f = [_field(_F, ln) for ln in lines[:2]]
        assert cli_f == [f"{ml.value:.2f}", f"{rg.value:.2f}"], (
            problem, cli_f, ml.value, rg.value)
        assert ml.value == int(ml.value) and rg.value == int(rg.value)
        row["in_process_equal"] = True
        row["config"] = dc.asdict(pcfg)
    SLICE14_SECONDS["summarize"] = time.perf_counter() - t_phase
    emit({"phase": "summarize", "runs": runs, "launches": launches,
          "seconds": SLICE14_SECONDS["summarize"]})
    return launches


def phase_stream_cli(torch):
    """`launch.stream`: --smoke exits 0; then facility at the CLI's
    defaults (n 2,048, d 64, k 32, batch 128) one sieve, --continuous and
    --distributed over 4 gloo ranks on the card, each printing its value
    and arrivals/s; the distributed run's value and |S| equal the
    continuous run's (4 lanes, a merge every 4 batches), and its merged
    values equal them bit for bit (each lane's value is summed at the
    (1, N) shape a rank sums its one lane at: objective.lane_sums)."""
    t_phase = time.perf_counter()
    smoke, smoke_wall = _cli("stream", "--smoke")
    assert smoke[-1] == "stream smoke OK", smoke
    rows = {}
    strip = re.compile(r" arrivals/s=\d+ \[[0-9.]+s\]")
    for mode in ("single", "continuous", "distributed"):
        extra = [] if mode == "single" else [f"--{mode}"]
        lines, wall = _cli("stream", *extra)
        ln = lines[0]
        rows[mode] = {"line": ln, "process_seconds": wall,
                      "f": float(_field(_F, ln)),
                      "arrivals_per_s": float(_field(r"arrivals/s=(\d+)",
                                                     ln)),
                      "seconds": float(_field(r"\[([0-9.]+)s\]", ln))}
    # "… f=… |S|=…" and the merged values of the two continuous modes
    dist, cont = (strip.sub("", rows[m]["line"]).split("] ", 1)[1]
                  for m in ("distributed", "continuous"))
    (dist_head, dist_merges), (cont_head, cont_merges) = (
        (h, json.loads("[" + t)) for h, t in (ln.split(" [", 1)
                                               for ln in (dist, cont)))
    same = dist_head == cont_head
    assert same and len(dist_merges) == len(cont_merges), (dist, cont)
    merge_diff = max(abs(a - b) / abs(b)
                     for a, b in zip(dist_merges, cont_merges))
    assert dist_merges == cont_merges, (dist_merges, cont_merges)
    SLICE14_SECONDS["stream_cli"] = time.perf_counter() - t_phase
    emit({"phase": "stream_cli", "smoke": smoke,
          "smoke_seconds": smoke_wall, "runs": rows,
          "distributed_equal_to_continuous": same,
          "merges_max_rel_diff": merge_diff,
          "note": "distributed: the slowest rank's stream, spawn left out",
          "seconds": SLICE14_SECONDS["stream_cli"]})


def _qserve_row(head: str) -> dict:
    """The numbers of qserve's summary line; every submitted query
    served."""
    sub = int(_field(r"submitted=(\d+)", head))
    served = int(_field(r"served=(\d+)", head))
    assert sub == served > 0, head
    return {"line": head, "submitted": sub, "served": served,
            "batches": int(_field(r"batches=(\d+)", head)),
            "mean_batch": float(_field(r"mean_B=([0-9.]+)", head)),
            "p50_ms": float(_field(r"p50=([0-9.]+)ms", head)),
            "p99_ms": float(_field(r"p99=([0-9.]+)ms", head)),
            "served_qps": float(_field(r"served_qps=([0-9.]+)", head))}


def phase_qserve(torch):
    """`launch.qserve`: --smoke exits 0 with one resident launch per
    admitted batch; then `run` at the CLI's defaults (8 tenants, n 256,
    d 32, k 16) at --qps 50 and --qps 200 for 5 s each: p50, p99, served
    queries/s and the mean admitted batch, every submitted query
    served. The CLI's percentiles include its fresh process's first
    drain (the kernels' libraries and the first CUDA launches); the same
    `run`, called in this warm process at both rates, gives the steady
    ones. Returns the warm runs' launches."""
    import contextlib as cl
    import io
    from repro_torch.kernels import counters
    from repro_torch.launch import qserve
    t_phase = time.perf_counter()
    smoke, smoke_wall = _cli("qserve", "--smoke")
    assert smoke[-1] == "qserve smoke OK", smoke
    disp = json.loads(_field(r"dispatches/batch=(\[[0-9, ]*\])",
                             smoke[-2]))
    assert disp and set(disp) == {1}, smoke
    assert int(_field(r"resident dispatches=(\d+)", smoke[-2])) == len(disp)
    rates, warm, launches = {}, {}, {}
    for qps in (50, 200):
        lines, wall = _cli("qserve", "--qps", str(qps), "--duration", "5")
        rates[str(qps)] = dict(_qserve_row(lines[0]), tenants=lines[1:],
                               process_seconds=wall)
    for qps in (50, 200):
        out = io.StringIO()
        counters.reset()
        with cl.redirect_stdout(out):
            rc = qserve.main(["--qps", str(qps), "--duration", "5",
                              "--device", CLI_DEVICE])
        assert rc == 0, out.getvalue()
        lines = out.getvalue().strip().splitlines()
        warm[str(qps)] = dict(_qserve_row(lines[0]), tenants=lines[1:])
        _add(launches, {n: c["launches"] for n, c in
                        counters.snapshot().items() if c["launches"]})
    SLICE14_SECONDS["qserve"] = time.perf_counter() - t_phase
    emit({"phase": "qserve", "smoke": smoke, "smoke_seconds": smoke_wall,
          "dispatches_per_batch": disp, "rates": rates,
          "rates_warm_process": warm, "launches": launches,
          "seconds": SLICE14_SECONDS["qserve"]})
    return launches


AUTOTUNE_REPS = 2


def phase_autotune(torch, cfg, kc, n: int, seed: int, f32_run):
    """autotune.tune_one on the card, on a temporary cache file, at the
    k-medoid leaf (3,125² × 12,288, k = 200; TINY_IMAGENET's leaf), the
    k-medoid node (400² × 12,288) and the kosarak leaf (coverage, 30,938
    sets over 41,270 items = 1,290 words, k = 64): the static plan, every
    candidate's tier, storage, chunk, ms, dispatches and identity
    verdict, the winner and its speedup. Then run_tree_dense at `run`'s
    configuration on its data (drawn again from the seed) with
    REPRO_TORCH_AUTOTUNE_CACHE on that file: each stage's engine and
    storage (the live gates keep the 32 stacked leaves off a tier only
    one greedy fits), the root ids equal to `run`'s, the root value
    bit-equal where every stage kept `run`'s storage. The root's ids
    are compared as a set (a narrower node storage may pick the same
    elements in another order), their order reported."""
    import tempfile
    from repro_torch.core.simulate import partition, run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.data.synthetic import gen_images_on
    from repro_torch.kernels import counters, plans
    from repro_torch.kernels.rules import DIST_MIN
    from repro_torch.launch import autotune
    t_phase = time.perf_counter()
    n_leaf = -(-n // cfg.num_machines)          # 3,125 at TINY_IMAGENET
    shapes = [("kmedoid_leaf", "kmedoid", n_leaf, cfg.feature_dim, cfg.k, 0),
              ("kmedoid_node", "kmedoid", cfg.branching * cfg.k,
               cfg.feature_dim, cfg.k, 0),
              ("kosarak_leaf", "coverage", -(-kc.n // kc.num_machines), 0,
               kc.k, kc.universe)]
    launches, tuned, entries = {}, {}, {}
    for tag, name, nn, d, k, universe in shapes:
        log = []
        counters.reset()
        t0 = time.perf_counter()
        key, entry = autotune.tune_one(name, nn, d, k, universe=universe,
                                       device=CLI_DEVICE, reps=AUTOTUNE_REPS,
                                       verbose=False, log=log)
        _add(launches, {n_: c["launches"] for n_, c in
                        counters.snapshot().items() if c["launches"]})
        entries[key] = entry
        tuned[tag] = {"key": key, "seconds": time.perf_counter() - t0,
                      "static": log[0], "candidates": log[1:],
                      "winner": {f: entry[f] for f in (
                          "tier", "dtype", "block_n", "loop_block_n",
                          "dispatches")},
                      "winner_ms": entry["wall_s"] * 1e3,
                      "static_ms": entry["static_wall_s"] * 1e3,
                      "speedup": entry["speedup"]}
        assert all(row["dispatches"] > 0 for row in log), log
    t_tree = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = plans.save_autotune_cache(entries,
                                         path=os.path.join(tmp, "p.json"))
        x = gen_images_on(n, cfg.feature_dim, classes=20, seed=seed,
                          device=CLI_DEVICE)
        tree = AccumulationTree(cfg.num_machines, cfg.branching)
        leaf_n = int(np.bincount(partition(n, cfg.num_machines,
                                           cfg.seed)).max())
        levels = []
        with _env(REPRO_TORCH_AUTOTUNE_CACHE=path):
            stages = []
            for lvl in range(tree.num_levels + 1):
                ns = leaf_n if lvl == 0 else cfg.branching * cfg.k
                reps = (cfg.num_machines if lvl == 0
                        else len(tree.nodes_at_level(lvl)))
                p = plans.select_engine(DIST_MIN, ns, ns, cfg.feature_dim,
                                        replicas=reps, device=CLI_DEVICE)
                static = plans.fused_plan(ns, ns, d=cfg.feature_dim,
                                          rule=DIST_MIN, replicas=reps)
                tuned_fp = plans._tuned_plan(DIST_MIN, ns, ns,
                                             cfg.feature_dim, CLI_DEVICE,
                                             reps)
                stages.append({"level": lvl, "n": ns, "replicas": reps,
                               "engine": p.engine, "dtype": p.dtype,
                               "block_n": p.block_n,
                               "static": [static["tier"], static["dtype"]],
                               "cache_entry_taken": tuned_fp is not None})
            counters.reset()
            hook = _level_hook(torch, levels)
            t0 = time.perf_counter()
            res = run_tree_dense("kmedoid", x, cfg.k, tree, seed=cfg.seed,
                                 device=x.device, on_level=hook)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del x
        gc.collect()
        torch.cuda.empty_cache()
    for st, lv in zip(stages, levels):
        st["launches"] = lv["launches"]
        st["seconds"] = lv["seconds"]
        _add(launches, lv["launches"])
    f32_ids, f32_value, f32_root = f32_run
    ids = np.asarray(res.ids)
    same_ids = bool(np.array_equal(np.sort(ids), np.sort(f32_ids)))
    same_storage = all(st["dtype"] == "float32" for st in stages)
    row = {"stages": stages, "wall_seconds": wall,
           "root_ids_equal_to_run": same_ids,
           "root_ids_in_run_order": bool(np.array_equal(ids, f32_ids)),
           "every_stage_float32": same_storage,
           "root_value": res.root_value, "run_root_value": f32_root,
           "global_value": res.value, "run_global_value": f32_value,
           "seconds": time.perf_counter() - t_tree}
    SLICE14_SECONDS["autotune"] = time.perf_counter() - t_phase
    emit({"phase": "autotune", "reps": AUTOTUNE_REPS, "shapes": tuned,
          "tree": row, "launches": launches,
          "seconds": SLICE14_SECONDS["autotune"]})
    assert stages[0]["engine"] == "mega_stream", stages[0]
    assert same_ids, (ids.tolist(), f32_ids.tolist())
    if same_storage:
        assert np.array_equal(ids, f32_ids), (ids.tolist(), f32_ids.tolist())
        assert (res.root_value, res.value) == (f32_root, f32_value), row
    return launches


def phase_autotune_smoke(torch):
    """`launch.autotune --smoke` on the card writes its cache file; a
    following select_engine at its shape returns the tuned entry."""
    import tempfile
    from repro_torch.kernels import plans
    from repro_torch.kernels.rules import DOT_MAX
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        lines, wall = _cli("autotune", "--smoke", "--out", path)
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        key = plans.autotune_key(DOT_MAX, 192, 192, 32, CLI_DEVICE)
        entry = blob["entries"][key]
        with _env(REPRO_TORCH_AUTOTUNE_CACHE=path):
            p = plans.select_engine(DOT_MAX, 192, 192, 32,
                                    device=CLI_DEVICE)
    got = [p.tier or "step", p.dtype]
    assert got == [entry["tier"], entry["dtype"]], (got, entry)
    assert entry["budgets"] == plans.budget_snapshot(), entry
    SLICE14_SECONDS["autotune_smoke"] = time.perf_counter() - t_phase
    emit({"phase": "autotune_smoke", "lines": lines,
          "process_seconds": wall, "key": key, "entry": entry,
          "select_engine": {"engine": p.engine, "tier": p.tier,
                            "dtype": p.dtype, "block_n": p.block_n},
          "seconds": SLICE14_SECONDS["autotune_smoke"]})


# ---------------------------------------------------------------------------
# The model zoo's serving path (models/, launch/{steps,serve}.py)
# ---------------------------------------------------------------------------

SLICE15_SECONDS = {}
# the full-width serving runs: batch 4, prompt 512 (one attention chunk),
# 32 generated tokens, greedy
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
# qwen3-moe-30b-a3b's depth cut 48 → 4 layers (≈61 GB of f32 parameters
# at 48 layers; the width, the 128 experts and the routing are whole)
SERVE_MOE_LAYERS = 4
SERVE_CHECK_GEN = 8         # tokens of the float32 check run
MODEL_TOL = 1e-4            # card vs CPU logits, max abs
CONSISTENCY_TOL = 1e-3      # prefill + decode vs forward (the reference's)


def _model_run(torch, params, batch, cfg, n_decode: int, max_len: int):
    """forward logits, prefill logits and n_decode greedy decode steps'
    logits of one model on its device."""
    from repro_torch.models import transformer as T
    with torch.inference_mode():
        fwd, _ = T.forward(params, batch, cfg)
        pre, cache = T.prefill(params, batch, cfg, max_len=max_len)
        tok, steps = pre.argmax(-1)[:, None], []
        for _ in range(n_decode):
            lg, cache = T.decode_step(params, cache, tok, cfg)
            steps.append(lg)
            tok = lg.argmax(-1)[:, None]
    return fwd, pre, torch.stack(steps, 1)


def phase_model_parity(torch, dev: str = "cuda"):
    """Each of the ten architectures at its smoke_config (f32): forward,
    prefill and 8 greedy decode steps on the card against the same
    parameters on the CPU (logits within MODEL_TOL max abs; the card's
    greedy path followed on the CPU); then the reference's own
    check on the card (prefill(S) + decode(token S) against the forward
    over S + 1 tokens, within 1e-3); and h2o-danube's SWA ring (window
    16) decoded past the window against the windowed forward."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device(dev)
    rows = {}
    b, s, n_dec = 2, 32, 8
    for arch in sorted(registry.ARCHS):
        cfg = registry.smoke_config(arch)
        params, _ = T.init_params(torch.Generator().manual_seed(0), cfg)
        batch = api.synth_batch(torch.Generator().manual_seed(1), cfg,
                                ShapeConfig("p", "prefill", s, b))
        cpu = _model_run(torch, params, batch, cfg, n_dec, s + n_dec + 1)
        gpu_params = params.to(dev)
        gb = {k: v.to(dev) for k, v in batch.items()}
        gpu = _model_run(torch, gpu_params, gb, cfg, n_dec, s + n_dec + 1)
        row = {}
        for name, g, c in zip(("forward", "prefill", "decode"), gpu, cpu):
            err = float((g.cpu() - c).abs().max())
            assert err <= MODEL_TOL, (arch, name, err)
            row[name] = {"max_abs_err": err}
        # the card's greedy tokens are the CPU's (its own decode path)
        same = bool(torch.equal(gpu[2].argmax(-1).cpu(), cpu[2].argmax(-1)))
        assert same, arch
        extra = torch.randint(0, cfg.vocab_size, (b, 1),
                              generator=torch.Generator().manual_seed(7))
        full = dict(gb, tokens=torch.cat([gb["tokens"], extra.to(dev)], 1))
        with torch.inference_mode():
            lf, _ = T.forward(gpu_params, full, cfg)
            lp, cache = T.prefill(gpu_params, gb, cfg, max_len=s + 4)
            ld, _ = T.decode_step(gpu_params, cache, extra.to(dev), cfg)
        cons = [float((lp - lf[:, s - 1]).abs().max()),
                float((ld - lf[:, s]).abs().max())]
        assert max(cons) < CONSISTENCY_TOL, (arch, cons)
        row["prefill_decode_vs_forward"] = cons
        rows[arch] = row
    cfg = registry.smoke_config("h2o-danube-3-4b")
    assert cfg.sliding_window == 16
    params, _ = T.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    sw, gen = 24, 6
    toks = torch.randint(0, cfg.vocab_size, (1, sw + gen), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        full, _ = T.forward(params, {"tokens": toks}, cfg)
        _, cache = T.prefill(params, {"tokens": toks[:, :sw]}, cfg,
                             max_len=sw + gen)
        ring = []
        for t in range(sw, sw + gen):
            lg, cache = T.decode_step(params, cache, toks[:, t:t + 1], cfg)
            ring.append(float((lg - full[:, t]).abs().max()))
    assert max(ring) < CONSISTENCY_TOL, ring
    SLICE15_SECONDS["model_parity"] = time.perf_counter() - t_phase
    emit({"phase": "model_parity", "archs": rows,
          "swa_ring": {"window": 16, "prompt": sw, "decoded": gen,
                       "max_abs_err": ring},
          "seconds": SLICE15_SECONDS["model_parity"]})


def _decode_idle(torch, run, steps: int = 3) -> dict:
    """Where a decode step's time goes: after a fresh prefill and one
    untraced step, `steps` steps traced by torch.profiler (each CUDA
    kernel's device time and launches) and the next `steps` untraced on
    CUDA events: the device's busy share of a step and its largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    params, cfg = run["params"], run["cfg"]
    tok = run["tokens"][:, :1]
    with torch.inference_mode():
        _, cache = T.prefill(params, run["batch"], cfg,
                             max_len=SERVE_PROMPT + SERVE_GEN)
        _, cache = T.decode_step(params, cache, tok, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                _, cache = T.decode_step(params, cache, tok, cfg)
            torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(steps):
            _, cache = T.decode_step(params, cache, tok, cfg)
        t1.record()
        t1.synchronize()
    wall = t0.elapsed_time(t1) / steps
    busy, launches, kernels = 0.0, 0, []
    for kernel, count, us in _cuda_events(torch, prof):
        busy += us / 1e3 / steps
        launches += count
        kernels.append((us / 1e3 / steps, kernel[:60], count / steps))
    if busy <= 0:
        return {"device_busy_ms_per_step": "not measured"}
    kernels.sort(reverse=True)
    return {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "busy_share": busy / wall, "cuda_launches_per_step":
            launches / steps,
            "top_kernels": [{"kernel": k, "ms_per_step": ms,
                             "launches_per_step": n}
                            for ms, k, n in kernels[:5]]}


def _check_run(torch, arch: str, layers: int, dtype: str, n_gen: int,
               moe=None) -> dict:
    """`launch.serve.main`'s greedy run of the arch (its seeds, so its
    weights and prompt batch) with the compute dtype, and the MoE fields
    in `moe` where given, replaced in the config; through the model's
    prefill and decode_step: the run `serve.teacher_forced` takes."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    dev = torch.device(CLI_DEVICE)
    cfg = registry.get_arch(arch).replace(dtype=dtype)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    shape = ShapeConfig("serve", "prefill", SERVE_PROMPT, SERVE_BATCH)
    with torch.inference_mode():
        params, _ = T.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg)
        batch = api.synth_batch(torch.Generator(device=dev).manual_seed(1),
                                cfg, shape)
        logits, cache = T.prefill(params, batch, cfg,
                                  max_len=SERVE_PROMPT + n_gen)
        toks, steps = [logits.argmax(-1)[:, None]], [logits]
        for _ in range(n_gen - 1):
            logits, cache = T.decode_step(params, cache, toks[-1], cfg)
            toks.append(logits.argmax(-1)[:, None])
            steps.append(logits)
    return {"cfg": cfg, "params": params, "batch": batch,
            "tokens": torch.cat(toks, 1), "logits": torch.stack(steps, 1)}


# the teacher-forced check runs of a dense or SSM model: (label, dtype,
# tokens, MoE fields replaced, what is asserted: "margin" (a mismatch
# only where the top-2 logits lie within 0.05), a bound on the largest
# logit difference, or None: reported)
CHECK_RUNS = (("float32", "float32", SERVE_CHECK_GEN, None, "margin"),)
# the MoE's bf16 paths without expert selection: the largest logit
# difference allowed (predicted before its first measurement)
MOE_UNSELECTED_MAX_DIFF = 0.3


def _serve_full(torch, phase: str, arch: str, layers: int = 0,
                reduced=None, check_bf16: bool = False,
                checks=CHECK_RUNS) -> dict:
    """`launch.serve.main` in this process at the arch's full width:
    batch SERVE_BATCH, prompt SERVE_PROMPT, SERVE_GEN greedy tokens, one
    warm-up round, the config's bf16; its prefill and decode times (CUDA
    events), tokens/s, peak memory (above what earlier phases hold) and
    parameter count, the decode step
    beside its bytes bound (every f32 parameter read once a step) and
    its profile (`_decode_idle`). The teacher-forced check (a forward
    over prompt + generation picks the decoded token at every position
    but where its top-2 logits lie within 0.05) is reported for that run
    (asserted with `check_bf16`), and for each of `checks` on a run of
    the same weights and prompt with the dtype and MoE fields replaced
    (`_check_run`; asserted where the entry says so)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    argv = ["--arch", arch, "--prompt-len", str(SERVE_PROMPT), "--gen",
            str(SERVE_GEN), "--batch", str(SERVE_BATCH), "--warmup", "1",
            "--device", CLI_DEVICE]
    if layers:
        argv += ["--layers", str(layers)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # earlier phases' live tensors
    run = serve.main(argv)
    peak = torch.cuda.max_memory_allocated() - held
    cfg = run["cfg"]
    n_params = sum(p.numel() for p in run["params"].parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in run["params"].parameters())
    check = serve.teacher_forced(run)
    assert bool(torch.isfinite(run["logits"]).all()), phase
    if check_bf16:
        assert check["mismatches"] == check["within_margin"], (phase, check)
    prompt_aux = {}
    if cfg.moe is not None:
        # the prompt alone routes prefill's groups: prefill's drop share
        with torch.inference_mode():
            _, aux = T.forward(run["params"], run["batch"], cfg)
        prompt_aux = {"moe_drop_fraction_prefill":
                      float(aux["moe_drop_fraction"]) / cfg.num_layers,
                      "moe_drop_fraction_teacher_forced":
                      check["aux"]["moe_drop_fraction"] / cfg.num_layers}
    step_ms = run["decode_ms"] / run["decode_steps"]
    row = {"phase": phase, "arch": arch, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": cfg.dtype, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "gen": SERVE_GEN, "prefill_ms": run["prefill_ms"],
           "decode_ms": run["decode_ms"],
           "decode_ms_per_step": step_ms,
           "decode_bound_ms_per_step": param_bytes / PEAK_HBM_BYTES * 1e3,
           "decode_bound_by": "bytes (f32 parameters once a step)",
           "tok_per_s": run["tok_per_s"], "peak_memory_gb": peak / 1e9,
           "held_before_gb": held / 1e9,
           "params": n_params, "param_count": cfg.param_count(),
           "param_gb": param_bytes / 1e9, "teacher_forced": check,
           **prompt_aux, "decode_profile": _decode_idle(torch, run),
           "reduced": reduced or {},
           "tokens_row0": run["tokens"][0].tolist()}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    for label, dtype, n_gen, moe, held in checks:
        check_run = _check_run(torch, arch, layers, dtype, n_gen, moe)
        got = serve.teacher_forced(check_run)
        del check_run
        gc.collect()
        torch.cuda.empty_cache()
        if moe:
            assert got["aux"]["moe_drop_fraction"] == 0, (phase, label, got)
        if held == "margin":
            assert got["mismatches"] == got["within_margin"], (phase, label,
                                                               got)
        elif held is not None:
            assert got["max_logit_diff"] <= held, (phase, label, got)
        row["teacher_forced_" + label] = dict(got, dtype=dtype, gen=n_gen,
                                              moe=moe, asserted=held)
    SLICE15_SECONDS[phase] = time.perf_counter() - t_phase
    row["seconds"] = SLICE15_SECONDS[phase]
    return row


def phase_serve_qwen2p5_3b(torch):
    """qwen2.5-3b at full width and depth (36 layers, d_model 2,048, 16
    heads / 2 KV heads, d_ff 11,008, vocab 151,936, QKV bias, tied
    embeddings): 3.09 B parameters published. The teacher-forced check
    holds on its bf16 run too."""
    row = _serve_full(torch, "serve_qwen2p5_3b", "qwen2.5-3b",
                      check_bf16=True)
    assert row["layers"] == 36 and row["d_model"] == 2048
    assert 0.95 < row["param_count"] / 3.09e9 < 1.05, row["param_count"]
    emit(row)


def phase_serve_mamba2(torch):
    """mamba2-1.3b at full width and depth (48 SSD layers, d_state 128,
    chunk 256: the prompt is two chunks). Its bf16 forward rounds the
    chunk's mixing matrix to bf16 (the reference's m.astype(dt)) where
    decode's recurrence stays f32, so its teacher-forced check is held
    on the float32 run."""
    row = _serve_full(torch, "serve_mamba2", "mamba2-1.3b")
    assert row["layers"] == 48
    emit(row)


def phase_serve_moe(torch):
    """qwen3-moe-30b-a3b at full width, depth cut 48 → 4: 128 experts,
    top-8, d_expert 768, groups of 512 tokens at capacity 40, with
    prefill's drop fraction (a forward over the prompt alone routes the
    same groups). Capacity drops depend on a group's other tokens, so a
    forward over prompt + generation drops other tokens than prefill and
    decode (a group of 4 never drops); and bf16 rounding differs between
    the paths, so a router near-tie can pick another of the 128 experts.
    The check is reported for the configured run and for a bf16 run at
    capacity factor 128 / 8 (no drop); on a bf16 run with the selection
    taken away (top-k = all experts at capacity factor 1: no drop, no
    choice to flip) the largest logit difference is held to
    MOE_UNSELECTED_MAX_DIFF (the dense model's bf16 size); on a float32
    run at no drop the check is held."""
    from repro_torch.configs import registry
    from repro_torch.models import moe as X
    cfg = registry.get_arch("qwen3-moe-30b-a3b")
    assert X._capacity(512, cfg.moe) == 40
    experts = cfg.moe.num_experts
    no_drop = {"capacity_factor": experts / cfg.moe.top_k}
    row = _serve_full(
        torch, "serve_moe", "qwen3-moe-30b-a3b", layers=SERVE_MOE_LAYERS,
        reduced={"num_layers": [cfg.num_layers, SERVE_MOE_LAYERS]},
        checks=(("no_drop", cfg.dtype, SERVE_GEN, no_drop, None),
                ("all_experts", cfg.dtype, SERVE_GEN,
                 {"top_k": experts, "capacity_factor": 1.0},
                 MOE_UNSELECTED_MAX_DIFF),
                ("float32", "float32", SERVE_CHECK_GEN, no_drop, "margin")))
    emit(row)


def phase_serve_cli():
    """`python -m repro_torch.launch.serve --arch smollm-135m --smoke
    --prompt-len 32 --gen 8 --batch 2` on the card: exits 0 and prints
    the reference's prefill and tok/s line."""
    t_phase = time.perf_counter()
    lines, wall = _cli("serve", "--arch", "smollm-135m", "--smoke",
                       "--prompt-len", "32", "--gen", "8", "--batch", "2")
    assert lines[0].startswith("prefill 2×32") and "tok/s" in lines[0], lines
    SLICE15_SECONDS["serve_cli"] = time.perf_counter() - t_phase
    emit({"phase": "serve_cli", "lines": lines, "process_seconds": wall,
          "seconds": SLICE15_SECONDS["serve_cli"]})


# ---------------------------------------------------------------------------
# The training path (optim/, data/pipeline.py, launch/{steps,train}.py)
# ---------------------------------------------------------------------------

SLICE16_SECONDS = {}
TRAIN_TOL = 1e-4            # card vs CPU state after 2 steps, of scale
# train_parity's AdamW: past its warm-up by step 2, as the CPU tests
TRAIN_PARITY_OPTIM = {"lr": 3e-3, "warmup_steps": 2, "total_steps": 10}
# the full-width train step: the same tokens a step as the serving cells
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_DOCS, TRAIN_K = 512, 256
# the CLI's cuts of smollm-135m's train shape (seq 4,096, batch 256)
TRAIN_CLI_SEQ, TRAIN_CLI_BATCH, TRAIN_CLI_STEPS = 256, 8, 30
TRAIN_CLI_EXTRA = ()        # more CLI flags (a rehearsal's --smoke)


def _old_rule_err(got: dict, want: dict) -> float:
    """The rule this phase used before it held the moments to their own
    scale: largest |got − want| over max(1, max |want|), every leaf."""
    return max(float(np.abs(got[k] - w).max()) / max(
        1.0, float(np.abs(w).max())) for k, w in want.items() if w.size)


def phase_train_parity(torch, dev: str = "cuda"):
    """Each of the ten architectures at its smoke_config: one state on
    the CPU and its copy on the card, 2 AdamW train steps (batch 2 × 32,
    TRAIN_PARITY_OPTIM: lr 3e-3 past a 2-step warm-up, as the CPU tests
    take their steps) on the same batches. After each step
    (`optim/parity.py`): every moment leaf of the card within TRAIN_TOL
    of that leaf's largest entry on the CPU; every parameter within one
    f32 spacing plus TRAIN_TOL of its leaf's largest change of the
    update the card's own moments imply; the loss within TRAIN_TOL.
    Then two planted faults at smollm-135m must fail those rules: a
    card step with TF32 products (the moments), and step 1's state with
    its parameters left as they were (the update)."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import parity
    t_phase = time.perf_counter()
    ocfg = OptimConfig(**TRAIN_PARITY_OPTIM)
    shape = ShapeConfig("t", "train", 32, 2)
    rows, planted = {}, {}
    for arch in sorted(registry.ARCHS):
        cfg = registry.smoke_config(arch)
        cpu, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                      ocfg, device="cpu")
        fn = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, None)
        row = {"moments": [], "update": [], "loss": []}
        for s in range(2):
            batch = api.synth_batch(torch.Generator().manual_seed(1 + s),
                                    cfg, shape)
            # both sides start the step from one state (the CPU's)
            start = convert.train_state_to_numpy(cpu, cfg, ocfg)
            card = convert.train_state_to_torch(start, cfg, ocfg, dev)
            before = parity.flatten(start)
            cpu, mc = fn(cpu, batch)
            card, mg = fn(card, {k: v.to(dev) for k, v in batch.items()})
            got = parity.flatten(convert.train_state_to_numpy(card, cfg,
                                                              ocfg))
            want = parity.flatten(convert.train_state_to_numpy(cpu, cfg,
                                                               ocfg))
            mom, mom_leaf = parity.moments_error(got, want)
            upd, upd_leaf = parity.update_error(before, got, ocfg,
                                                float(mc["lr"]))
            assert mom <= TRAIN_TOL, (arch, s, mom_leaf, mom)
            assert upd <= TRAIN_TOL, (arch, s, upd_leaf, upd)
            lc, lg = float(mc["loss"]), float(mg["loss"])
            assert math.isfinite(lg) and abs(lg - lc) <= TRAIN_TOL * max(
                1.0, abs(lc)), (arch, s, lg, lc)
            row["moments"].append({"max_rel": mom, "leaf": mom_leaf})
            row["update"].append({"max_rel": upd, "leaf": upd_leaf})
            row["loss"].append({"card": lg, "cpu": lc})
            if arch == "smollm-135m" and s == 0:
                planted = _train_parity_planted(
                    torch, parity, convert, fn, arch, cfg, ocfg, start,
                    batch, before, got, want, float(mc["lr"]), dev)
            del card
        rows[arch] = row
    SLICE16_SECONDS["train_parity"] = time.perf_counter() - t_phase
    emit({"phase": "train_parity", "archs": rows, "steps": 2,
          "batch": [2, 32], "lr": ocfg.lr, "warmup_steps": ocfg.warmup_steps,
          "tol": TRAIN_TOL, "planted": planted,
          "seconds": SLICE16_SECONDS["train_parity"]})


def _train_parity_planted(torch, parity, convert, fn, arch, cfg, ocfg,
                          state0, batch, before, got, want, lr, dev) -> dict:
    """train_parity's planted faults at one arch's step 1 (`got` the
    card's state after it, `want` the CPU's): both must fail the rules."""
    tf32 = convert.train_state_to_torch(state0, cfg, ocfg, dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, _ = fn(tf32, {k: v.to(dev) for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32 = parity.flatten(convert.train_state_to_numpy(tf32, cfg, ocfg))
    mom, leaf = parity.moments_error(tf32, want)
    assert mom > TRAIN_TOL, ("the moments rule passes a TF32 step", mom)
    skipped = dict(got, **{k: v for k, v in before.items()
                           if k.startswith("params/")})
    upd, _ = parity.update_error(before, skipped, ocfg, lr)
    assert upd > TRAIN_TOL, ("the update rule passes a skipped update", upd)
    return {"arch": arch, "tf32_moments_max_rel": mom,
            "tf32_leaf": leaf, "tf32_old_rule_err": _old_rule_err(tf32, want),
            "f32_old_rule_err": _old_rule_err(got, want),
            "skipped_update_max_rel": upd}


def _train_profile(torch, fn, state, batch, step_ms: float) -> tuple:
    """One train step traced by torch.profiler: (state, the device's
    busy time and its largest kernels). The busy share is taken of an
    untraced step's time `step_ms` (the tracer slows the host 3×)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the device's activity only: the host's ~50,000 autograd ops would
    # cost more to trace and to sum than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = fn(state, batch)
        float(metrics["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    busy, launches, kernels = 0.0, 0, []
    for kernel, count, us in _cuda_events(torch, prof):
        busy += us / 1e3
        launches += count
        kernels.append((us / 1e3, kernel[:60], count))
    if busy <= 0:
        return state, {"device_busy_ms": "not measured"}
    kernels.sort(reverse=True)
    return state, {"traced_wall_ms": wall, "device_busy_ms": busy,
                   "busy_share": busy / step_ms, "cuda_launches": launches,
                   "top_kernels": [{"kernel": k, "ms": ms, "launches": n}
                                   for ms, k, n in kernels[:6]]}


def _train_step_flops(cfg, n_params: int, batch: int, seq: int,
                      remat: str) -> dict:
    """The products one train step needs, by pass. A forward pass: 2·N·T
    over the projections (N the parameters less an untied input
    embedding, which is a lookup; T the tokens) and 2·B·L·H·hd·S² over
    the causal half of attention's two products (scores, and the
    probabilities times the values). The backward pass: twice the
    forward. The recompute: remat 'block' saves the projections' outputs
    and recomputes the attention products, 'full' recomputes the whole
    forward, 'none' nothing."""
    lookup = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    proj = 2 * (n_params - lookup) * batch * seq
    attn = (2 * batch * cfg.num_layers * cfg.num_heads
            * cfg.resolved_head_dim * seq * seq)
    recompute = {"none": 0, "block": attn, "full": proj + attn}[remat]
    return {"forward": proj + attn, "backward": 2 * (proj + attn),
            "recompute": recompute}


def phase_train_qwen2p5_3b(torch, dev: str = "cuda"):
    """qwen2.5-3b at full width and depth (36 layers, d_model 2,048, vocab
    151,936, tied embeddings): AdamW with f32 moments, remat 'block',
    no mesh; batch TRAIN_BATCH × TRAIN_SEQ from a TokenDataset over
    gen_tokens(TRAIN_DOCS, TRAIN_SEQ + 1, vocab) restricted to the
    greedyml:facility coreset (k TRAIN_K) chosen on the card — its
    launches are returned for the kernels line. 1 warm-up step, 3 timed
    (CUDA events, each ended by the loss's read), then 1 profiled. The
    bound: `_train_step_flops` at the fp32 peak against the state's
    bytes (parameters, gradients, m, v: 7 passes of N f32) at the HBM
    peak."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
    from repro_torch.data import pipeline, selection, synthetic
    from repro_torch.kernels import counters
    from repro_torch.launch import steps
    from repro_torch.optim.tree import leaves
    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cfg = registry.get_arch("qwen2.5-3b")
    toks = synthetic.gen_tokens(TRAIN_DOCS, TRAIN_SEQ + 1, cfg.vocab_size,
                                seed=0)
    emb = selection.embed_documents(toks[:, :TRAIN_SEQ], seed=0)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = selection.select_coreset(emb, TRAIN_K, spec="greedyml:facility",
                                   seed=0, device=dev)
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert len(sel) == TRAIN_K and launches, (len(sel), launches)
    ds = pipeline.TokenDataset(toks, seed=0, selected=sel)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ocfg = OptimConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    tcfg = TrainConfig(remat="block")
    shape = ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    state, _ = steps.concrete_state(torch.Generator(device=dev).manual_seed(0),
                                    cfg, ocfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(state["params"]))
    state_gb = torch.cuda.memory_allocated() / 1e9 - held / 1e9
    fn = steps.make_train_step(cfg, ocfg, tcfg, shape, None)
    losses, ms = [], []
    for step in range(4):
        batch = pipeline.place(ds.batch(step, TRAIN_BATCH), None, dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, metrics = fn(state, batch)
        t1.record()
        losses.append(float(metrics["loss"]))
        t1.synchronize()
        ms.append(t0.elapsed_time(t1))
    peak = torch.cuda.max_memory_allocated() - held
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.vocab_size)) < 1.0, losses
    timed = ms[1:]
    step_ms = sum(timed) / len(timed)
    state, profile = _train_profile(
        torch, fn, state, pipeline.place(ds.batch(4, TRAIN_BATCH), None, dev),
        step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_step_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ,
                              tcfg.remat)
    ops_ms = sum(flops.values()) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = 7 * n_params * 4 / PEAK_HBM_BYTES * 1e3
    del state, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()
    SLICE16_SECONDS["train_qwen2p5_3b"] = time.perf_counter() - t_phase
    emit({"phase": "train_qwen2p5_3b", "arch": "qwen2.5-3b",
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": n_params,
          "param_count": cfg.param_count(), "optimizer": "adamw",
          "moment_dtype": ocfg.moment_dtype, "remat": tcfg.remat,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "coreset": {"spec": "greedyml:facility", "docs": TRAIN_DOCS,
                      "k": TRAIN_K, "kept": int(len(sel)),
                      "seconds": sel_s, "launches": launches},
          "init_seconds": init_s, "state_gb": state_gb,
          "step_ms": ms, "warmup_ms": ms[0], "step_ms_mean": step_ms,
          "bound_ms": max(ops_ms, bytes_ms),
          "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
          "bound_operations_ms": ops_ms, "bound_bytes_ms": bytes_ms,
          "bound_flops": flops, "step_over_bound": step_ms / max(
              ops_ms, bytes_ms),
          "tok_per_s": tokens / (step_ms / 1e3),
          "peak_memory_gb": peak / 1e9, "held_before_gb": held / 1e9,
          "losses": losses, "ln_vocab": math.log(cfg.vocab_size),
          "profile": profile,
          "seconds": SLICE16_SECONDS["train_qwen2p5_3b"]})
    figures = {"train_step_flops": flops, "n_params": n_params,
               "peak_memory_gb": peak / 1e9, "step_ms_mean": step_ms,
               "cfg": cfg, "ocfg": ocfg, "tcfg": tcfg, "shape": shape}
    return launches, figures


def _ckpt_arrays(path: str) -> dict:
    with np.load(os.path.join(path, f"step_{TRAIN_CLI_STEPS:08d}",
                              "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def phase_train_cli():
    """`python -m repro_torch.launch.train --arch smollm-135m` at its full
    width (seq and batch cut to TRAIN_CLI_SEQ / TRAIN_CLI_BATCH from
    4,096 / 256), TRAIN_CLI_STEPS steps, a checkpoint every 10, the
    greedyml:facility coreset (256 of 512 documents) chosen on the card:
    one run with --fail-at 15 (recovered from step 10) and one without,
    two processes side by side (CUBLAS_WORKSPACE_CONFIG=:4096:8); both
    exit 0 with the reference's lines, and their step-30 checkpoints
    (parameters, moments, step) are equal bit for bit."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    argv = ["--arch", "smollm-135m", "--seq", str(TRAIN_CLI_SEQ),
            "--global-batch", str(TRAIN_CLI_BATCH), "--steps",
            str(TRAIN_CLI_STEPS), "--ckpt-every", "10", "--data-selection",
            "greedyml:facility", "--device", CLI_DEVICE, *TRAIN_CLI_EXTRA]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {"failed": ["--fail-at", "15"], "clean": []}
        procs = {}
        try:
            for name, extra in runs.items():
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.train", *argv,
                     *extra, "--ckpt-dir", os.path.join(tmp, name)],
                    env=env, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            outs = {name: p.communicate(timeout=CLI_TIMEOUT)
                    for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t_phase
        lines = {}
        for name, (out, err) in outs.items():
            assert procs[name].returncode == 0, (name, out[-3000:],
                                                 err[-3000:])
            lines[name] = out.strip().splitlines()
            assert "kept 256 of 512 documents" in out, (name, out)
            assert f"done at step {TRAIN_CLI_STEPS}" in out, (name, out)
        assert "'failure', 'restart'" in lines["failed"][-1], lines
        assert "'failure'" not in lines["clean"][-1], lines
        failed = _ckpt_arrays(os.path.join(tmp, "failed"))
        clean = _ckpt_arrays(os.path.join(tmp, "clean"))
    assert sorted(failed) == sorted(clean)
    differing = [k for k in clean
                 if failed[k].tobytes() != clean[k].tobytes()]
    assert not differing, differing[:5]
    SLICE16_SECONDS["train_cli"] = time.perf_counter() - t_phase
    emit({"phase": "train_cli", "arch": "smollm-135m",
          "reduced": {"seq": [4096, TRAIN_CLI_SEQ],
                      "global_batch": [256, TRAIN_CLI_BATCH]},
          "steps": TRAIN_CLI_STEPS, "lines": lines,
          "checkpoint_leaves": len(clean),
          "checkpoint_bytes": sum(a.nbytes for a in clean.values()),
          "differing_leaves": len(differing), "process_wall_seconds": wall,
          "seconds": SLICE16_SECONDS["train_cli"]})


# ---------------------------------------------------------------------------
# the sharded trainer over ranks (launch/steps.py on a DeviceMesh)
# ---------------------------------------------------------------------------

SLICE17_SECONDS = {}
GLOO_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
            "all_to_all_single")
# qwen2.5-3b at full width, depth cut 36 → 4: four ranks' state and
# activations at 36 layers do not fit beside each other on one card
TRAIN_SHARDED_LAYERS = 4
TRAIN_SHARDED_MOE = "qwen3-moe-30b-a3b"
TRAIN_SHARDED_MOE_LAYERS = 48        # its depth, cut to TRAIN_SHARDED_LAYERS
TRAIN_SHARDED_MESH = (2, 2)
TRAIN_SHARDED_STEPS = 3
TRAIN_SHARDED_DEADLINE = 600


def _gloo_probe_rank(rank, dev):
    """Each collective DTensor issues, run through the c10d API by gloo
    on CUDA tensors of `dev`: 'ok', 'wrong' or the error it raised."""
    import torch
    import torch.distributed as dist
    dev = _rank_device(torch, dev)
    w = dist.get_world_size()
    x = torch.arange(8, dtype=torch.float32, device=dev) + 8 * rank
    out = {}
    for op in GLOO_OPS:
        try:
            if op == "all_gather_into_tensor":
                y = torch.empty(8 * w, device=dev)
                dist.all_gather_into_tensor(y, x)
            elif op == "reduce_scatter_tensor":
                y = torch.empty(8 // w, device=dev)
                dist.reduce_scatter_tensor(y, x)
            elif op == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
            else:
                y = torch.empty(8, device=dev)
                dist.all_to_all_single(y, x)
            _sync(torch, dev)
            out[op] = ("ok" if torch.equal(y.cpu(), _probe_want(op, rank, w))
                       else "wrong")
        except Exception as e:          # a refusal is the probe's answer
            out[op] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def _probe_want(op, rank, w):
    import torch
    xs = [torch.arange(8.) + 8 * r for r in range(w)]
    per = 8 // w
    if op == "all_gather_into_tensor":
        return torch.cat(xs)
    if op == "reduce_scatter_tensor":
        return sum(xs)[rank * per:(rank + 1) * per]
    if op == "all_reduce":
        return sum(xs)
    return torch.cat([x[rank * per:(rank + 1) * per] for x in xs])


def _gloo_functional_rank(rank, dev, marker):
    """The same collectives through the functional API DTensor calls
    (`torch.distributed._functional_collectives` over a DeviceMesh of the
    world), the op about to run written to `marker` first: a rank that
    dies of a signal leaves its last op there."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    dev = _rank_device(torch, dev)
    w = dist.get_world_size()
    mesh = init_device_mesh(dev.type, (w,), mesh_dim_names=("ranks",))
    x = torch.arange(8, dtype=torch.float32, device=dev) + 8 * rank
    out = {}
    for op in GLOO_OPS:
        with open(f"{marker}.{rank}", "w") as f:
            f.write(op)
        if op == "all_gather_into_tensor":
            y = funcol.all_gather_tensor(x, 0, mesh)
        elif op == "reduce_scatter_tensor":
            y = funcol.reduce_scatter_tensor(x, "sum", 0, mesh)
        elif op == "all_reduce":
            y = funcol.all_reduce(x, "sum", mesh)
        else:
            y = funcol.all_to_all_single(x, None, None, mesh)
        y = funcol.wait_tensor(y)
        _sync(torch, dev)
        out[op] = ("ok" if torch.equal(y.cpu(), _probe_want(op, rank, w))
                   else "wrong")
    return out


def phase_gloo_probe(torch, dev: str = "cuda:0") -> dict:
    """2 gloo ranks on `dev`: which of DTensor's collectives gloo runs on
    CUDA tensors in this torch — through the c10d API, and through the
    functional API DTensor itself calls (a rank killed by a signal is
    reported with the op it was running; the ops after it are not
    reached)."""
    from torch.multiprocessing.spawn import ProcessExitedException
    from repro_torch.launch.spawn import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(_gloo_probe_rank, 2, args=(dev,), backend="gloo",
                    timeout=120)
    c10d = {op: res[0][op] if all(r[op] == res[0][op] for r in res)
            else [r[op] for r in res] for op in GLOO_OPS}
    with tempfile.TemporaryDirectory() as tmp:
        marker = os.path.join(tmp, "op")
        try:
            res = run_ranks(_gloo_functional_rank, 2, args=(dev, marker),
                            backend="gloo", timeout=120)
            functional = {op: res[0][op] if all(r[op] == res[0][op]
                                                for r in res)
                          else [r[op] for r in res] for op in GLOO_OPS}
        except ProcessExitedException as e:
            last = [open(f"{marker}.{r}").read()
                    for r in range(2) if os.path.exists(f"{marker}.{r}")]
            dead = max(last, key=GLOO_OPS.index) if last else GLOO_OPS[0]
            functional = {op: ("ran" if GLOO_OPS.index(op) <
                               GLOO_OPS.index(dead) else
                               f"rank died: {e}" if op == dead
                               else "not reached") for op in GLOO_OPS}
    out = {"c10d": c10d, "functional": functional}
    emit({"phase": "gloo_probe", "torch": torch.__version__,
          "cuda": torch.version.cuda, "ranks": 2, "device": dev,
          "ops": out, "dtensor_ok": all(v == "ok"
                                        for v in functional.values()),
          "seconds": time.perf_counter() - t0})
    return out


def _sharded_setup(arch: str = "qwen2.5-3b"):
    """(cut config, AdamW config, TrainConfig, shape, the batches (numpy))
    of train_sharded's ranks: `arch` at full width, depth cut to
    TRAIN_SHARDED_LAYERS."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
    from repro_torch.data import pipeline, synthetic
    cfg = registry.get_arch(arch).replace(num_layers=TRAIN_SHARDED_LAYERS)
    ocfg = OptimConfig(lr=3e-4, warmup_steps=2, total_steps=8)
    tcfg = TrainConfig(remat="block")
    shape = ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    toks = synthetic.gen_tokens(TRAIN_DOCS, TRAIN_SEQ + 1, cfg.vocab_size,
                                seed=0)
    ds = pipeline.TokenDataset(toks, seed=0)
    batches = [ds.batch(s, TRAIN_BATCH) for s in range(TRAIN_SHARDED_STEPS)]
    return cfg, ocfg, tcfg, shape, batches


def _flat_state(state) -> dict:
    """{"params/…", "opt/m/…", "opt/v/…", "opt/step"}: the state's
    tensors by their port paths (a DTensor as it is)."""
    from repro_torch.checkpoint import manager
    return manager._flatten(state)


def _train_sharded_rank(rank, want, dev, setup):
    """One rank of train_sharded's (2, 2) run (`_train_sharded_ranks`) on
    `dev` (on card `rank` where `dev` is "cuda:rank"): the cut qwen2.5-3b
    drawn on the card from seed 0 (the one-device run's draw), placed on
    the mesh, TRAIN_SHARDED_STEPS steps; after each, its shards of the
    moments measured against the same blocks of the float64 one-device
    moments (`want`, shared by CUDA IPC; `yardstick_parts` on the card)
    and its parameters against the update its own moments imply
    (`optim/parity.py`, per-leaf maxima)."""
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import parity
    from repro_torch.sharding.axes import is_dtensor
    if dev == "cuda:rank":
        dev = f"cuda:{rank}"
    dev = _rank_device(torch, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ocfg, tcfg, shape, batches = setup
    mesh = make_local_mesh(*TRAIN_SHARDED_MESH, device=dev)
    state, axes = steps.concrete_state(
        torch.Generator(device=dev).manual_seed(0), cfg, ocfg)
    state = steps.place_state(state, steps.state_shardings(axes, state,
                                                           mesh))
    gc.collect()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    flat = _flat_state(state)
    state_bytes = sum((t.to_local() if is_dtensor(t) else t).nbytes
                      for t in flat.values())

    def host(t):
        return (t.to_local() if is_dtensor(t) else t).detach().to(
            torch.float64).cpu().numpy()

    def blocks(key, t):
        """This rank's block of the float64 yardstick's leaf `key`."""
        w = want[key]
        if is_dtensor(t):
            shp, off = compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, t.placements)
            w = w[tuple(slice(o, o + n) for o, n in zip(off, shp))]
        return w.to(dev)

    fn = steps.make_train_step(cfg, ocfg, tcfg, shape, mesh)
    ms, losses, moments, updates = [], [], [], []
    for s in range(TRAIN_SHARDED_STEPS):
        before = {k: host(t) for k, t in _flat_state(state).items()
                  if k.startswith("params/")}
        batch = pipeline.place(batches[s], mesh)
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        flat = _flat_state(state)
        after = {k: host(t) for k, t in flat.items()}
        mine = {k: (t.to_local() if is_dtensor(t) else t).to(
            torch.float64) for k, t in flat.items()
            if k.startswith("opt/") and k != "opt/step"}
        moments.append(parity.yardstick_parts(
            mine, {k: blocks(f"{s}/{k}", flat[k]) for k in mine}))
        updates.append(parity.update_parts(before, after, ocfg,
                                           float(metrics["lr"])))
        del before, after, mine
    return {"step_ms": ms, "losses": losses, "moments": moments,
            "updates": updates, "state_bytes": state_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else 0,
            "coordinate": list(mesh.get_coordinate())}


class _float64_port:
    """Every F32 of the port's model, step and optimizer modules set to
    float64 inside the block: the float64 yardstick step."""

    def __enter__(self):
        import torch
        from repro_torch.launch import steps
        from repro_torch.models import layers, mamba, moe, transformer
        from repro_torch.optim import adafactor, adamw, compress, schedule
        self.mods = (layers, moe, mamba, transformer, steps, adamw,
                     adafactor, compress, schedule)
        self.saved = [m.F32 for m in self.mods]
        for m in self.mods:
            m.F32 = torch.float64

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.F32 = f


def _widen(tree):
    """The state's floating tensors in float64 (a `Params` tree in place)."""
    import torch
    if isinstance(tree, torch.nn.Module):
        return tree.double()
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree.double() if tree.is_floating_point() else tree


def _bits(t):
    """A digest of a leaf's bits: two int64 sums of its words, plain and
    weighted by position (1, 2, …, n; the sums wrap modulo 2^64, which
    no order of summation changes). Equal leaves give equal digests; a
    digest stands in for a leaf that the card cannot hold twice."""
    import torch
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    b = t.detach().contiguous().view(words[t.element_size()]).flatten().to(
        torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64)
    return torch.stack([b.sum(), (b * w).sum()])


def _one_device_steps(torch, dev, setup, keep, f64: bool = False,
                      yard=None, digest: bool = False):
    """The one-device train steps of `setup` on `dev` (a one-device mesh,
    the sharded run's microbatches: two of 2 rows), in float64 where
    `f64` (the f32 draw widened, every module's F32 float64): each
    step's ms and loss; the state's tensors after each step that
    `keep(key)` selects, cloned on the card ({"step/key": tensor}); with
    `yard` (a float64 run's kept moments) each step's moments measured
    against them (`optim/parity.py::yardstick_parts`); the state's
    parameter count and bytes, a step's peak memory (the kept copies left
    out). With `digest` a kept leaf is its `_bits`. The model is freed."""
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import parity
    cfg, ocfg, tcfg, shape, batches = setup
    one_tcfg = dataclasses.replace(
        tcfg, microbatch_per_device=TRAIN_SHARDED_MESH[0])
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    state, _ = steps.concrete_state(
        torch.Generator(device=dev).manual_seed(0), cfg, ocfg)
    if f64:
        cfg, state = cfg.replace(dtype="float64"), _widen(state)
    flat = _flat_state(state)
    out = {"params": sum(t.numel() for k, t in flat.items()
                         if k.startswith("params/")),
           "state_bytes": sum(t.nbytes for t in flat.values()),
           "ms": [], "losses": [], "kept": {}, "peak_bytes": 0,
           "ref_parts": []}
    kept = 0
    with (_float64_port() if f64 else contextlib.nullcontext()):
        fn = steps.make_train_step(cfg, ocfg, one_tcfg, shape,
                                   make_local_mesh(device=dev))
        for s in range(TRAIN_SHARDED_STEPS):
            batch = pipeline.place(batches[s], None, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["peak_bytes"] = max(out["peak_bytes"],
                                    torch.cuda.max_memory_allocated()
                                    - held - kept)
            out["losses"].append(float(metrics["loss"]))
            flat = _flat_state(state)
            if yard is not None:
                mom = {k: t.double() for k, t in flat.items()
                       if k.startswith("opt/") and k != "opt/step"}
                out["ref_parts"].append(parity.yardstick_parts(
                    mom, {k: yard[f"{s}/{k}"] for k in mom}))
                del mom
            for k, t in flat.items():
                if keep(k):
                    c = _bits(t) if digest else t.detach().clone()
                    out["kept"][f"{s}/{k}"] = c
                    kept += c.nbytes
    del state, metrics, batch, flat, fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_sharded_ranks(torch, backend: str, dev: str, setup):
    """The (2, 2) run over 4 ranks of `backend` (gloo: all on `dev`;
    NCCL: `dev` "cuda:rank", a card a rank), held shard by shard by
    `optim/parity.py`: the moments against a float64 one-device step
    from the same state (within TRAIN_TOL of the leaf's scale, else an
    RMS error within 2.5× the float32 one-device step's own:
    `yardstick_error`), the parameters against the update the rank's own
    moments imply, the losses like the moments."""
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.optim import parity
    card = "cuda:0" if dev == "cuda:rank" else dev
    y64 = _one_device_steps(
        torch, card, setup, lambda k: k.startswith("opt/") and
        k != "opt/step", f64=True)
    one = _one_device_steps(torch, card, setup, lambda k: False,
                            yard=y64["kept"])
    t0 = time.perf_counter()
    res = run_ranks(_train_sharded_rank, math.prod(TRAIN_SHARDED_MESH),
                    args=(y64.pop("kept"), dev, setup), backend=backend,
                    timeout=TRAIN_SHARDED_DEADLINE)
    ranks_wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    steps_out = []
    for s in range(TRAIN_SHARDED_STEPS):
        got = parity.combine([r["moments"][s] for r in res])
        ref = one["ref_parts"][s]
        ratio, r_leaf = parity.yardstick_error(got, ref, TRAIN_TOL)
        rel = parity.worst({k: v[:2] for k, v in got.items()})
        one_rel = parity.worst({k: v[:2] for k, v in ref.items()})
        u_err, u_leaf = parity.worst([r["updates"][s] for r in res])
        loss = [r["losses"][s] for r in res]
        l64, l32 = y64["losses"][s], one["losses"][s]
        assert len(set(loss)) == 1, loss
        assert ratio <= 1.0, (s, ratio, r_leaf, rel, one_rel)
        assert u_err <= TRAIN_TOL, (s, u_err, u_leaf)
        assert abs(loss[0] - l64) <= max(TRAIN_TOL * abs(l64),
                                         2.5 * abs(l32 - l64)), (
            s, loss[0], l32, l64)
        steps_out.append({"moments_rule": ratio, "moments_rule_leaf": r_leaf,
                          "moments_vs_f64": rel,
                          "one_device_moments_vs_f64": one_rel,
                          "update_err": u_err, "update_leaf": u_leaf,
                          "loss": loss[0], "one_device_loss": l32,
                          "float64_loss": l64,
                          "ms": [r["step_ms"][s] for r in res],
                          "one_device_ms": one["ms"][s],
                          "float64_ms": y64["ms"][s]})
    return {"route": f"{backend}, mesh (2, 2)", "backend": backend,
            "ranks": len(res), "device": dev,
            "mesh": {"data": TRAIN_SHARDED_MESH[0],
                     "model": TRAIN_SHARDED_MESH[1]},
            "params": one["params"],
            "one_device_state_bytes": one["state_bytes"],
            "quarter_state_bytes": one["state_bytes"] / 4,
            "rank_state_bytes": [r["state_bytes"] for r in res],
            "rank_peak_bytes": [r["peak_bytes"] for r in res],
            "one_device_peak_bytes": one["peak_bytes"],
            "coordinates": [r["coordinate"] for r in res],
            "rule_tol": TRAIN_TOL, "rule_factor": 2.5, "steps": steps_out,
            "rank_wall_seconds": ranks_wall}


def _world1_rank(rank, want, dev, setup, digest: bool = False):
    """The NCCL world-1 run: a real DeviceMesh (1, 1) on `dev`, the state
    DTensors (Replicate), the step's DTensor path; every leaf after each
    step against the plain step's (`want`, by CUDA IPC) bit for bit; with
    `digest` its digest (`_bits`) against the plain leaf's."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.sharding.axes import is_dtensor
    dev = _rank_device(torch, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ocfg, tcfg, shape, batches = setup
    tcfg = dataclasses.replace(
        tcfg, microbatch_per_device=TRAIN_SHARDED_MESH[0])
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    state, axes = steps.concrete_state(
        torch.Generator(device=dev).manual_seed(0), cfg, ocfg)
    state = steps.place_state(state, steps.state_shardings(axes, state,
                                                           mesh))
    gc.collect()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    flat = _flat_state(state)
    n_dtensor = sum(is_dtensor(t) for t in flat.values())
    state_bytes = sum((t.to_local() if is_dtensor(t) else t).nbytes
                      for t in flat.values())
    fn = steps.make_train_step(cfg, ocfg, tcfg, shape, mesh)
    leaf = _bits if digest else (lambda t: t)
    ms, losses, differing = [], [], []
    for s in range(TRAIN_SHARDED_STEPS):
        batch = pipeline.place(batches[s], None, dev)
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        differing.append([k for k, t in _flat_state(state).items()
                          if not torch.equal(
                              leaf(t.to_local() if is_dtensor(t) else t),
                              want[f"{s}/{k}"])])
    # release the plain step's leaves (CUDA IPC) so that the parent's
    # `ipc_collect` frees their blocks
    want.clear()
    gc.collect()
    return {"step_ms": ms, "losses": losses, "differing": differing,
            "n_leaves": len(flat), "n_dtensor": n_dtensor,
            "state_bytes": state_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else 0}


def _train_sharded_world1(torch, dev: str, setup, digest: bool = False):
    """The fallback where gloo's collectives under DTensor fail on CUDA
    tensors: the same cut model and steps through a real DeviceMesh (1,
    1) under NCCL at world size 1, held bit for bit against the plain
    step (with `digest`, each leaf's digest, `_bits`, equal to the plain
    step's: a model whose two states do not fit the card together)."""
    from repro_torch.launch.spawn import run_ranks
    one = _one_device_steps(torch, dev, setup, lambda k: True,
                            digest=digest)
    t0 = time.perf_counter()
    res = run_ranks(_world1_rank, 1, args=(one.pop("kept"), dev, setup,
                                           digest),
                    backend="nccl", timeout=TRAIN_SHARDED_DEADLINE)[0]
    ranks_wall = time.perf_counter() - t0
    gc.collect()
    # the kept leaves went to the rank by CUDA IPC: their blocks stay
    # allocated here until collected
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    assert res["n_dtensor"] == res["n_leaves"], res["n_dtensor"]
    assert all(not d for d in res["differing"]), res["differing"]
    assert res["losses"] == one["losses"], (res["losses"], one["losses"])
    return {"route": "nccl world 1, mesh (1, 1)", "backend": "nccl",
            "ranks": 1, "device": dev, "mesh": {"data": 1, "model": 1},
            "params": one["params"],
            "one_device_state_bytes": one["state_bytes"],
            "rank_state_bytes": [res["state_bytes"]],
            "rank_peak_bytes": [res["peak_bytes"]],
            "one_device_peak_bytes": one["peak_bytes"],
            "leaves": res["n_leaves"], "dtensor_leaves": res["n_dtensor"],
            "differing_leaves": [len(d) for d in res["differing"]],
            "steps": [{"loss": res["losses"][s],
                       "one_device_loss": one["losses"][s],
                       "ms": [res["step_ms"][s]],
                       "one_device_ms": one["ms"][s]}
                      for s in range(TRAIN_SHARDED_STEPS)],
            "rank_wall_seconds": ranks_wall}


def phase_train_sharded(torch, dev: str = "cuda:0"):
    """The sharded trainer (launch/steps.py over a DeviceMesh: the state
    DTensors placed by the reference's axis rules, the batch by its act
    rules, `constrain` at its sites) on qwen2.5-3b at full width, depth
    cut 36 → TRAIN_SHARDED_LAYERS (AdamW f32, remat 'block', batch 4 ×
    512). First the gloo probe. Where gloo runs DTensor's functional
    collectives on CUDA tensors: the one-device step on the card (a
    one-device mesh, the same microbatches: two of 2 rows), its moments
    after each step kept on the card and the model freed; then 4 gloo
    ranks on `dev`, a (2, 2) ("data", "model") mesh, the same draw,
    batches and steps, each rank's shards held by `optim/parity.py` —
    the moments within TRAIN_TOL of their leaf's largest entry in the
    one-device run, the parameters within one f32 spacing plus
    TRAIN_TOL of the update the rank's own moments imply — with each
    rank's peak memory and state bytes beside a quarter of the one-device
    state, and step ms. Where it does not (a rank dies in them): the
    same model and steps through a real DeviceMesh (1, 1) under NCCL at
    world size 1, the state DTensors, every leaf equal to the plain
    step's bit for bit. Then qwen3-moe-30b-a3b at full width, depth cut
    48 → TRAIN_SHARDED_LAYERS, through the world-1 route alike (each
    leaf's digest, `_bits`, equal to the plain step's)."""
    t_phase = time.perf_counter()
    probe = phase_gloo_probe(torch, dev)
    setup = _sharded_setup()
    cfg, ocfg, tcfg, shape, batches = setup
    if all(v == "ok" for v in probe["functional"].values()):
        out = _train_sharded_ranks(torch, "gloo", dev, setup)
    else:
        out = _train_sharded_world1(torch, dev, setup)
    # qwen3-moe at full width, depth cut 48 → TRAIN_SHARDED_LAYERS: the
    # MoE's routing, dispatch and combine through the DTensor path at
    # world 1, each leaf's digest equal to the plain step's (two states
    # do not fit the card together)
    t_moe = time.perf_counter()
    moe_setup = _sharded_setup(TRAIN_SHARDED_MOE)
    out["qwen3_moe_world1"] = dict(
        _train_sharded_world1(torch, dev, moe_setup, digest=True),
        arch=TRAIN_SHARDED_MOE,
        reduced={"layers": [TRAIN_SHARDED_MOE_LAYERS,
                            TRAIN_SHARDED_LAYERS]},
        experts=moe_setup[0].moe.num_experts, top_k=moe_setup[0].moe.top_k,
        seconds=time.perf_counter() - t_moe)
    SLICE17_SECONDS["train_sharded"] = time.perf_counter() - t_phase
    emit({"phase": "train_sharded", "arch": "qwen2.5-3b",
          "reduced": {"layers": [36, TRAIN_SHARDED_LAYERS]},
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "optimizer": "adamw", "remat": tcfg.remat,
          "batch": shape.global_batch, "seq": shape.seq_len,
          "microbatches": shape.global_batch // TRAIN_SHARDED_MESH[0],
          "gloo_probe": probe, **out,
          "seconds": SLICE17_SECONDS["train_sharded"]})


SLICE18_SECONDS = {}
# the card-vs-CPU comparison of the technique cells' declared costs: n
# cut 2^20 / 2^19 → 65,536, k 256 → 32 (the CPU's plain path in time)
DRYRUN_CMP_N, DRYRUN_CMP_K = 65536, 32
DRYRUN_FLOPS_TOL = 0.05      # (c): dot flops beside _train_step_flops
# (b): cells whose paths need DTensor rules that torch 2.11 lacked before
# the models ran each rank's own rows, heads and groups locally
DRYRUN_GUARD_CELLS = ("mamba2-1.3b:decode_32k", "h2o-danube-3-4b:prefill_32k",
                      "qwen3-moe-30b-a3b:prefill_32k")
DRYRUN_BYTES_TOL = 0.10      # (c): total bytes beside the measured peak


def _declared(counters) -> dict:
    """{kernel: (calls, declared costs, launches, flops, bytes)} of the
    counters that ran."""
    snap, costs = counters.snapshot(), counters.costs()
    return {n: (snap[n]["calls"], costs[n]["cost"], snap[n]["launches"],
                costs[n]["flops"], costs[n]["bytes"])
            for n in snap if snap[n]["calls"]}


def _dryrun_technique(torch, DR, counters, device, **kw) -> dict:
    """Both technique cells, rank 0 of the single mesh's fake world on
    `device`: {cell: (record, declared)}."""
    out = {}
    with DR.fake_world(DR.MESH_DEVICES["single"]):
        for name in DR.TECHNIQUE_CELLS:
            spec = dict(DR.TECHNIQUE_CELLS[name], **kw.get(name, {}))
            counters.reset()
            res = DR.run_technique(name, "single", device, spec=spec)
            out[name] = (res, _declared(counters))
    counters.reset()
    return out


def _start_dryrun_traces() -> dict:
    """Phase dryrun's (b): qwen2.5-3b:train_4k on both meshes and
    DRYRUN_GUARD_CELLS on the single mesh (this machine's torch guards
    the DTensor rules their paths need), CPU-only traces, a process
    each, started before `train_sharded` so that they run beside it and
    beside (a), (c) and (d)."""
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    traces = {"tmp": tmp, "log": open(os.path.join(tmp.name, "log"), "w+"),
              "t0": time.perf_counter()}
    traces["sweep"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--only",
         "qwen2.5-3b:train_4k", "--mesh", "both", "--out", tmp.name],
        env=env, stdout=traces["log"], stderr=subprocess.STDOUT)
    traces["guard_logs"] = {c: open(os.path.join(
        tmp.name, c.replace(":", "__") + ".log"), "w+")
        for c in DRYRUN_GUARD_CELLS}
    traces["guards"] = {c: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--only", c,
         "--mesh", "single", "--out", tmp.name], env=env,
        stdout=traces["guard_logs"][c], stderr=subprocess.STDOUT)
        for c in DRYRUN_GUARD_CELLS}
    return traces


def _stop_dryrun_traces(traces: dict) -> None:
    """Every process `_start_dryrun_traces` started stopped, its files
    removed."""
    for proc in [traces["sweep"], *traces["guards"].values()]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for f in [traces["log"], *traces["guard_logs"].values()]:
        f.close()
    traces["tmp"].cleanup()


def phase_dryrun(torch, train_figures, dev: str = "cuda", traces=None):
    """The dry run (launch/dryrun.py) on this machine: (a) the technique
    cells on the card, every kernel call with its declared cost, and the
    same cells at n DRYRUN_CMP_N on the card and the CPU; (b) qwen2.5-3b:
    train_4k over both production meshes and DRYRUN_GUARD_CELLS over the
    single one (each one's memory a device printed; `traces`: these
    traces as `_start_dryrun_traces` started them); (c)
    `phase_train_qwen2p5_3b`'s step traced at world 1 against that
    phase's measured figures; (d) hillclimb's smollm_dp_only."""
    from repro_torch.kernels import counters
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hillclimb as HC
    t_phase = time.perf_counter()
    out = {}
    if traces is None:
        traces = _start_dryrun_traces()
    tmp, log, t_b = traces["tmp"], traces["log"], traces["t0"]
    sweep, guards = traces["sweep"], traces["guards"]
    try:
        # (a) full size on the card
        cells = {}
        for name, (res, decl) in _dryrun_technique(
                torch, DR, counters, dev).items():
            assert decl and all(c == n and l <= n for n, c, l, _, _ in
                                decl.values()), (name, decl)
            assert dev == "cpu" or any(l for _, _, l, _, _ in
                                       decl.values()), (name, decl)
            rec = {"devices": 256, "per_device": DR._per_device(res),
                   "estimated": DR.technique_estimate(res)}
            cells[name] = {"seconds": res["seconds"], "k": res["k"],
                           "flops": res["flops"],
                           "kernel_flops": res["kernel_flops"],
                           "bytes_accessed": res["bytes_accessed"],
                           "collective_moved_bytes":
                               res["collectives"]["moved_bytes"],
                           "memory": res["memory"], "terms": HC.terms(rec),
                           "declared": {n: list(v) for n, v in
                                        decl.items()}}
        out["technique"] = cells
        # (a) the card against the CPU at n cut
        cut = {name: {"n": DRYRUN_CMP_N, "k": DRYRUN_CMP_K}
               for name in DR.TECHNIQUE_CELLS}
        card = _dryrun_technique(torch, DR, counters, dev, **cut)
        cpu = _dryrun_technique(torch, DR, counters, "cpu", **cut)
        cmp = {}
        for name in DR.TECHNIQUE_CELLS:
            a, b = card[name][1], cpu[name][1]
            same = ({n: v[:2] + v[3:] for n, v in a.items()}
                    == {n: v[:2] + v[3:] for n, v in b.items()})
            cmp[name] = {"card": {n: list(v) for n, v in a.items()},
                         "cpu": {n: list(v) for n, v in b.items()},
                         "equal": same}
            assert same, (name, a, b)
        out["card_vs_cpu"] = {"n": DRYRUN_CMP_N, "k": DRYRUN_CMP_K, **cmp}
        out.update(_dryrun_card_check(torch, DR, train_figures))
        # (d) hillclimb's smollm_dp_only
        t0 = time.perf_counter()
        hc = HC.run_experiment("smollm_dp_only")
        out["smollm_dp_only"] = {k: HC.terms(v) for k, v in hc.items()}
        out["smollm_dp_only_seconds"] = time.perf_counter() - t0
        # (b)'s records
        sweep.wait(timeout=300)
        log.seek(0)
        assert sweep.returncode == 0, log.read()[-3000:]
        recs = []
        for mesh_kind in ("single", "multi"):
            with open(os.path.join(tmp.name, f"qwen2.5-3b__train_4k__"
                                   f"{mesh_kind}.json")) as fh:
                recs.append(json.load(fh))
        guard = {}
        for c, proc in guards.items():
            proc.wait(timeout=300)
            glog = traces["guard_logs"][c]
            glog.seek(0)
            assert proc.returncode == 0, (c, glog.read()[-3000:])
            with open(os.path.join(tmp.name, c.replace(":", "__")
                                   + "__single.json")) as fh:
                r = json.load(fh)
            assert r["ok"], (c, r)
            guard[c] = {"memory": r["per_device"]["memory"],
                        "memory_gb": r["per_device"]["memory"][
                            "total_bytes"] / 1e9,
                        "flops": r["estimated"]["flops"],
                        "collective_moved_bytes": r["estimated"][
                            "collective_moved_bytes"],
                        "seconds": r["seconds"]}
            print(f"dryrun {c} single: "
                  f"{guard[c]['memory_gb']:.2f} GB a device")
        out["guard_cells"] = guard
    finally:
        _stop_dryrun_traces(traces)
    assert all(r["ok"] for r in recs), recs
    out["qwen2p5_3b_train_4k"] = {
        r["mesh"]: {"memory": r["per_device"]["memory"],
                    "flops_full_pass": r["per_device"]["flops_hlo_static"],
                    "estimated": {k: v for k, v in r.get(
                        "estimated", {}).items() if k != "points"},
                    "seconds": r["seconds"]} for r in recs}
    out["qwen2p5_3b_train_4k_seconds"] = time.perf_counter() - t_b
    SLICE18_SECONDS["dryrun"] = time.perf_counter() - t_phase
    emit({"phase": "dryrun", **out, "seconds": SLICE18_SECONDS["dryrun"]})


def _dryrun_card_check(torch, DR, train_figures) -> dict:
    """(c): `phase_train_qwen2p5_3b`'s step traced at world 1 (no mesh)
    against what that phase measured."""
    f = train_figures
    t0 = time.perf_counter()
    res = DR.trace_cell(f["cfg"], f["ocfg"], f["shape"], None,
                        f["tcfg"].remat)
    want = sum(f["train_step_flops"].values())
    cfg = f["cfg"]
    # eager attention computes the masked half of its two products too:
    # forward, backward (twice) and remat 'block''s recompute
    attn = (2.0 * f["shape"].global_batch * cfg.num_layers * cfg.num_heads
            * cfg.resolved_head_dim * f["shape"].seq_len ** 2)
    masked = attn * (3 + (f["tcfg"].remat != "none"))
    resid = (res["dot_flops"] - masked - want) / want
    total_gb = res["memory"]["total_bytes"] / 1e9
    compute_ms = res["flops"] / PEAK_FP32_FLOPS * 1e3
    check = {"dot_flops": res["dot_flops"], "flops": res["flops"],
             "train_step_flops": want, "attention_masked_half": masked,
             "dot_over_train_step_flops": res["dot_flops"] / want,
             "residual_after_masked_half": resid,
             "memory": res["memory"], "total_gb": total_gb,
             "peak_memory_gb": f["peak_memory_gb"],
             "total_over_peak": total_gb / f["peak_memory_gb"],
             "compute_ms_at_67e12": compute_ms,
             "step_ms_mean": f["step_ms_mean"],
             "top_ops": sorted(res["by_op"].items(),
                               key=lambda kv: -kv[1])[:8],
             "seconds": time.perf_counter() - t0}
    assert abs(res["dot_flops"] / want - 1) <= DRYRUN_FLOPS_TOL, check
    assert abs(resid) <= DRYRUN_FLOPS_TOL, check
    assert abs(total_gb / f["peak_memory_gb"] - 1) <= DRYRUN_BYTES_TOL, check
    assert compute_ms <= f["step_ms_mean"], check
    return {"card_check": check}


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.paper_kcover import KOSARAK, KOSARAK_AVG_SIZE
    from repro_torch.configs.paper_kdom import CONFIG as KDOM
    from repro_torch.configs.paper_kmedoid import TINY_IMAGENET
    from repro_torch.data.synthetic import gen_images_on
    from repro_torch.kernels import counters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TINY_IMAGENET
    dev = torch.device("cuda")
    phase_build()
    t0 = time.perf_counter()
    x = gen_images_on(args.n, cfg.feature_dim, classes=20, seed=args.seed,
                      device=dev)
    torch.cuda.synchronize()
    emit({"phase": "data", "n": args.n, "d": cfg.feature_dim,
          "gigabytes": x.numel() * 4 / 1e9,
          "seconds": time.perf_counter() - t0})
    pools = lane_pools(torch, x, cfg.num_machines, cfg.seed)
    errs = phase_parity(torch, x, cfg, cfg.seed)
    errs.update(phase_parity_steps(torch, x, cfg, pools))
    errs.update(phase_parity_quant(torch, x, cfg, pools))
    stream_errs, stream_inputs = phase_parity_stream(torch, x, cfg, pools)
    errs.update(stream_errs)
    global_errs, global_inputs = phase_parity_stream_global(torch, x, cfg,
                                                            KOSARAK.k)
    phase_reference(torch)
    phase_reference_dispatch(torch)
    phase_reference_stream(torch)
    launches, f32_run = phase_run(torch, x, cfg)
    _add(launches, phase_supervised_kmedoid(torch, x, cfg, f32_run))
    _add(launches, phase_serve_kmedoid(torch, x, cfg))
    for dtype in QUANT:
        _add(launches, phase_run_quant(torch, x, cfg, dtype, f32_run))
    _add(launches, {"fused_step": phase_knapsack(torch, x, cfg, pools)[
        "fused_step"]})
    for dtype in QUANT:
        _add(launches, phase_knapsack_quant(torch, x, cfg, pools, dtype))
    _add(launches, {"gains": phase_stochastic(torch, x, cfg, pools)[
        "gains"]})
    _add(launches, phase_stochastic_int8(torch, x, cfg, pools))
    shard_launches, shard_err = phase_sharded_kmedoid(torch, x, cfg, pools,
                                                      args.reps)
    _add(launches, shard_launches)
    errs["gains"] = max(errs["gains"], shard_err)
    phase_lazy_kmedoid(torch, x, cfg)
    stream_launches, stream_ratio = phase_stream_kmedoid(
        torch, x, cfg, x, f32_run[0])
    _add(launches, stream_launches)
    phase_stream_idle(torch, "kmedoid", x, cfg, cfg.k, ground=x)
    _add(launches, phase_stream_kmedoid(torch, x, cfg, stream_inputs[0],
                                        f32_run[0], "int8", stream_ratio)[0])
    times = phase_timing(torch, x, cfg, cfg.seed, args.reps)
    times.update(phase_timing_steps(torch, x, cfg, pools, args.reps))
    times.update(phase_timing_quant(torch, x, cfg, pools, args.reps))
    times.update(phase_timing_stream(torch, x, cfg, pools, stream_inputs,
                                     args.reps, global_inputs))
    # the sequential Greedy over all images, then the coverage problems:
    # the k-medoid tensors go first
    del pools, stream_inputs, global_inputs
    gc.collect()
    torch.cuda.empty_cache()
    seq_launches, seq_err = phase_sequential_kmedoid(torch, x, cfg, f32_run)
    _add(launches, seq_launches)
    errs["fused_step"] = max(errs["fused_step"], seq_err)
    del x
    gc.collect()
    torch.cuda.empty_cache()
    phase_timing_fused_global(torch, cfg, args.reps)
    emit({"phase": "slice20_total", "phases": SLICE20_SECONDS,
          "seconds": sum(SLICE20_SECONDS.values())})
    kc = KOSARAK
    bits, words, sets = phase_data_kcover(torch, kc, KOSARAK_AVG_SIZE, dev)
    kpools = lane_pools(torch, words, kc.num_machines, kc.seed)
    errs.update(phase_parity_coverage(torch, words, kc, kpools))
    tree_launches, kcover_res = _coverage_tree(torch, "kcover", bits, words,
                                               kc, "kcover_run")
    kcover_root = kcover_res.root_value
    launches.update(tree_launches)
    _add(launches, phase_supervised_kcover(torch, words, kc, kcover_res))
    _add(launches, phase_serve_kcover(torch, words, kc))
    phase_lazy_kcover(torch, sets, words, kc, kcover_res)
    del sets
    _add(launches, {"fused_step[coverage]": phase_kcover_knapsack(
        torch, words, kc, kpools)["fused_step[coverage]"]})
    _add(launches, {"gains[coverage]": phase_kcover_stochastic(
        torch, words, kc, kpools)["gains[coverage]"]})
    times.update(phase_timing_coverage(torch, words, kc, kpools, args.reps))
    del kpools
    errs.update(phase_parity_stream_coverage(torch, words, kc))
    stream_launches, stream_sol = phase_stream_kcover(torch, words, kc,
                                                      kcover_root)
    _add(launches, stream_launches)
    phase_stream_idle(torch, "kcover", words, kc, kc.k)
    _add(launches, phase_stream_kcover_knapsack(torch, words, kc))
    _add(launches, phase_window_kcover(torch, words, kc))
    cont_launches, continuous = phase_continuous_kcover(torch, words, kc)
    _add(launches, cont_launches)
    _add(launches, phase_supervised_stream(torch, words, kc, continuous,
                                           stream_sol))
    del stream_sol
    _add(launches, phase_tenant_session(torch, words, kc, continuous))
    times.update(phase_timing_stream_coverage(torch, words, kc, args.reps))
    _add(launches, phase_distributed_stream_kcover(torch, words, kc,
                                                   continuous))
    del bits, words
    gc.collect()
    torch.cuda.empty_cache()
    _, kdom_errs, kwords = phase_kdom_run(torch, KDOM, dev, args.reps)
    _add(launches, phase_distributed_kdom(torch, kwords, KDOM))
    _add(launches, phase_supervised_distributed(torch, kwords, KDOM))
    _add(launches, phase_distributed_nccl(torch, kwords, KDOM))
    del kwords
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, phase_coreset(torch, KDOM))
    _add(launches, phase_sharded_distributed(torch, KDOM))
    phase_plan_tree(torch, [("kmedoid", cfg, cfg.feature_dim, None),
                            ("kcover", kc, None, -(-kc.universe // 32)),
                            ("kdom", KDOM, None, -(-KDOM.universe // 32))])
    for name, err in [*kdom_errs.items(), *global_errs.items()]:
        errs[name] = max(errs[name], err)
    phase_faultrun_smoke()
    emit({"phase": "slice13_total", "phases": SLICE13_SECONDS,
          "seconds": sum(SLICE13_SECONDS.values())})
    _add(launches, phase_summarize(torch))
    phase_stream_cli(torch)
    _add(launches, phase_qserve(torch))
    _add(launches, phase_autotune(torch, cfg, kc, args.n, args.seed,
                                  f32_run))
    phase_autotune_smoke(torch)
    emit({"phase": "slice14_total", "phases": SLICE14_SECONDS,
          "seconds": sum(SLICE14_SECONDS.values())})
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_parity(torch)
    phase_serve_qwen2p5_3b(torch)
    phase_serve_mamba2(torch)
    phase_serve_moe(torch)
    phase_serve_cli()
    emit({"phase": "slice15_total", "phases": SLICE15_SECONDS,
          "seconds": sum(SLICE15_SECONDS.values())})
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_parity(torch)
    train_launches, train_figures = phase_train_qwen2p5_3b(torch)
    _add(launches, train_launches)
    phase_train_cli()
    emit({"phase": "slice16_total", "phases": SLICE16_SECONDS,
          "seconds": sum(SLICE16_SECONDS.values())})
    gc.collect()
    torch.cuda.empty_cache()
    traces = _start_dryrun_traces()
    try:
        phase_train_sharded(torch)
    except BaseException:
        _stop_dryrun_traces(traces)
        raise
    emit({"phase": "slice17_total", "phases": SLICE17_SECONDS,
          "seconds": sum(SLICE17_SECONDS.values())})
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(torch, train_figures, traces=traces)
    emit({"phase": "slice18_total", "phases": SLICE18_SECONDS,
          "seconds": sum(SLICE18_SECONDS.values())})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kernels = []
    for name in SOURCES:
        assert launches.get(name, 0) > 0, (name, launches)
        t = times[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    counters.reset()
    print(smi.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
